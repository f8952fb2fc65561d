"""The port's debug renders (``utils/debug_vis.py``) and the training CLI's
debug output, on the CPU.

- ``turntable_curve_mesh`` and ``save_debug`` against the JAX package's on
  one state (``test_torch_train._build_pair`` with curves, a 6-frame 48 px
  synthetic-tube scene): at most 0.5% of the pixels of each image may
  differ. The JAX package's mesh raster on the CPU takes its XLA path,
  which divides by the face area after the edge tests, where K1 (and its
  plain version) folds 1/area into the edge coefficients
  (``ROADMAP.md`` queue 3), so a pixel on a face edge can fall on the
  other side; the JAX PNGs are written by OpenCV, read here by the port's
  PNG reader.
- Batching: the 8 turntable views in one ``rasterize_mesh`` give each view
  the bits of a call of its own (per-frame depth quantization).
- The CLI writes ``debug/`` with ``--save-debug`` and a
  ``logs/<step>_<garment>_turntable.png`` after a remesh past step 1
  without it.
"""

import os

import numpy as np
import pytest
import torch

import jax

from recmv_tpu_torch import bridge
from test_torch_train import RATIO, _build_pair, _np_tree

ROOT = os.path.join(os.path.dirname(__file__), "..")
CONF = os.path.join(ROOT, "configs", "synthetic", "smoke.conf")
FIDS = [1, 4]
MAX_DIFF = 0.005


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    """One intra-op thread: the tests run beside other pytest workers."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def pair(tmp_path_factory):
    """Both networks on one 6-frame 48 px synthetic-tube scene from one
    state, with the JAX package's curves in both."""
    from recmv_tpu_torch.data.synthetic import generate_scene
    from test_torch_curves import _scene_curves

    root = tmp_path_factory.mktemp("torch_debug_vis")
    scene = generate_scene(str(root / "scene"), n_frames=6, image_size=48,
                           skinner_res=(17, 25, 9), device="cpu")
    net_j, net_t, ds_j = _build_pair(root, scene)
    net_j.align_fl(*_scene_curves())
    net_t.align_fl(*_scene_curves())
    bridge.load_curves(net_t, _np_tree(net_j.params["curves"]), net_j.curve_statics)
    return net_j, net_t, ds_j.get_batch(FIDS), root, scene


def _differ(a, b) -> float:
    """Share of pixels whose colours differ."""
    assert a.shape == b.shape
    return float(np.any(a != b, axis=-1).mean())


def test_turntable_matches_jax(pair):
    from recmv_tpu.utils.debug_vis import turntable_curve_mesh as jturn
    from recmv_tpu_torch.data.image import imread
    from recmv_tpu_torch.utils.debug_vis import turntable_curve_mesh

    net_j, net_t, _, root, _ = pair
    strips_j = jturn(net_j, RATIO, str(root / "turn_jax"), step=3)
    strips_t = turntable_curve_mesh(net_t, RATIO, str(root / "turn_port"), step=3)
    assert len(strips_t) == len(strips_j) == 1
    for a, b in zip(strips_t, strips_j):
        assert a.shape == (256, 8 * 256, 3) and a.dtype == np.uint8
        assert (a.sum(-1) > 0).mean() > 0.02
        assert _differ(a, np.asarray(b)) <= MAX_DIFF
    png_t = imread(str(root / "turn_port" / "000003_tube_turntable.png"))[:, :, ::-1]
    np.testing.assert_array_equal(png_t, strips_t[0])
    png_j = imread(str(root / "turn_jax" / "000003_tube_turntable.png"))[:, :, ::-1]
    assert _differ(png_t, png_j) <= MAX_DIFF
    assert os.path.isfile(root / "turn_port" / "000003_tube.obj")


def test_turntable_views_batch_to_their_own_bits(pair):
    """The turntable's 8 views in one ``rasterize_mesh`` against 8 calls of
    one view each (the plain K1 on the CPU; at 128², tile 32, cap 256)."""
    from recmv_tpu_torch.ops.rasterizer import rasterize_mesh, screen_with_cam_z
    from recmv_tpu_torch.utils.debug_vis import turntable_cameras

    net_t = pair[1]
    n = net_t.mesh.garment_n[0]
    v = net_t.mesh.garment_vs[0][:n].detach()
    f = net_t.mesh.garment_fs[0][:net_t.mesh.garment_fn[0]]
    cams = turntable_cameras(8, 128, torch.device("cpu"))
    scr = torch.stack([screen_with_cam_z(c, v - v.mean(0)) for c in cams])
    with torch.no_grad():
        batched = rasterize_mesh(scr, f, (128, 128), tile=32, cap=256)
        assert (batched.pix_to_face >= 0).float().mean() > 0.02
        for k in range(8):
            one = rasterize_mesh(scr[k:k + 1], f, (128, 128), tile=32, cap=256)
            for a, b in zip(batched, one):
                assert torch.equal(a[k:k + 1], b)


def test_save_debug_matches_jax(pair):
    from recmv_tpu.utils.debug_vis import save_debug as jsave
    from recmv_tpu_torch.data.image import imread
    from recmv_tpu_torch.utils.debug_vis import save_debug

    net_j, net_t, batch, root, _ = pair
    jsave(net_j, batch, FIDS, RATIO, str(root / "dbg_jax"), step=2)
    save_debug(net_t, batch, FIDS, RATIO, str(root / "dbg_port"), step=2)
    names = sorted(os.listdir(root / "dbg_jax"))
    assert names == sorted(os.listdir(root / "dbg_port"))
    assert names == [f"000002_{f:04d}_{k}.png" for f in FIDS for k in ("curves", "tube_mask")]
    for name in names:
        a = imread(str(root / "dbg_port" / name))
        b = imread(str(root / "dbg_jax" / name))
        assert _differ(a, b) <= MAX_DIFF, name
        if name.endswith("_mask.png"):
            sil = a[..., 1] > 0
            assert sil.mean() > 0.01 and (a[..., 2] > 0).mean() > 0.01


def test_cli_writes_debug_renders(pair, capsys):
    """The CLI on the pair's scene, resumed from the port network's
    checkpoint: run 1 with ``--save-debug`` writes the overlays, the mask
    comparisons, the turntable and its obj into ``debug/`` after the first
    step's remesh; run 2 (a remesh every step) writes no ``debug/`` but
    logs the turntable of step 2's remesh into ``logs/``, as an image file
    and through the visualizer."""
    from recmv_tpu_torch import train
    from recmv_tpu_torch.config import ConfigFactory, dump_config

    net_t, root, scene = pair[1], pair[3], pair[4]
    ckpt = str(root / "pair.ckpt")
    net_t.save_checkpoint(ckpt, 0)
    common = ["--data-root", scene, "--save-folder", "cli", "--device", "cpu", "--quality",
              "tiny", "--resume", ckpt]
    train.main(common + ["--conf", CONF, "--max-steps", "1", "--save-debug"])
    save = os.path.join(scene, "cli")
    dbg = sorted(os.listdir(os.path.join(save, "debug")))
    fids = [int(n.split("_")[1]) for n in dbg if n.endswith("_curves.png")]
    assert len(fids) == 2 and dbg == sorted(
        [f"000001_{f:04d}_{k}.png" for f in fids for k in ("curves", "tube_mask")]
        + ["000001_tube.obj", "000001_tube_turntable.png"])
    assert not [f for f in os.listdir(os.path.join(save, "logs")) if f.endswith(".png")]

    conf = ConfigFactory.parse_file(CONF)
    conf["train"]["coarse"]["point_render"]["remesh_intersect"] = 1
    conf_path = str(root / "remesh_each_step.conf")
    with open(conf_path, "w") as f:
        f.write(dump_config(conf))
    for f in os.listdir(os.path.join(save, "debug")):
        os.remove(os.path.join(save, "debug", f))
    net = train.main(common + ["--conf", conf_path, "--max-steps", "2"])
    assert "resumed from" in capsys.readouterr().out
    assert net.info["remeshed"] == 1.0 and net.opt_times == 2.0
    assert os.listdir(os.path.join(save, "debug")) == []
    logs = sorted(f for f in os.listdir(os.path.join(save, "logs")) if f.endswith(".png"))
    assert logs == ["000002_tube_turntable.png"]
    assert "debug_turntable_tube_000002.png" in os.listdir(os.path.join(save, "logs", "imgs"))
