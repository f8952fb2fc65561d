"""The port's checkpoints and training CLI, on the CPU.

(a) ``save_checkpoint`` → ``load_checkpoint`` round trip in the port: the
    nets, the skinner, the scene, the curves and their statics, the
    templates, the clip boxes and ``opt_times`` come back exactly, the
    optimizers start afresh, and an older checkpoint without clip boxes
    gets them from its templates;
(b) a checkpoint written by the JAX package's ``save_checkpoint`` loads
    into the port in a subprocess in which ``import jax`` and ``import
    recmv_tpu`` fail, and gives the JAX state exactly; in such a
    subprocess the benches (``recmv_tpu_torch.bench`` and every
    ``recmv_tpu_torch.tools`` module) import too;
(c) ``python -m recmv_tpu_torch.train`` with ``--device cpu`` on a
    2-frame 48 px synthetic-tube scene: the initialization (4 IGR epochs,
    2 curve iterations), 1 step, ``latest.ckpt``, then a run resumed from
    it for 2 steps, across a promotion to the medium stage;
    ``--save-debug`` and ``--wandb`` are refused with their reason, and
    without ``--device`` the CLI needs the card.

Everything is compared exactly: the checkpoints hold float32 arrays and
nothing is recomputed.
"""

import os
import pickle
import shutil
import subprocess
import sys

import numpy as np
import pytest
import torch

from recmv_tpu_torch import bridge

ROOT = os.path.join(os.path.dirname(__file__), "..")
CONF = os.path.join(ROOT, "configs", "synthetic", "smoke.conf")
IMG = 48


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    """One intra-op thread (the tests run beside other pytest workers)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def scene(tmp_path_factory):
    from recmv_tpu_torch.data.synthetic import generate_scene

    root = tmp_path_factory.mktemp("ckpt")
    return generate_scene(str(root / "scene"), n_frames=4, image_size=IMG,
                          skinner_res=(17, 25, 9), device="cpu")


def _port_net(scene, save_root):
    from recmv_tpu_torch.config import ConfigFactory
    from recmv_tpu_torch.core.builder import build_opt_net
    from recmv_tpu_torch.data.dataset import get_dataset_and_loader

    ds, _ = get_dataset_and_loader(scene, {"deformer": 256, "render": 256}, 2, shuffle=False,
                                   garment_type="synthetic-tube", data_type="synthe")
    return build_opt_net(ConfigFactory.parse_file(CONF), ds, str(save_root),
                         resolutions=((7, 9, 5), (13, 17, 9)), skinner_res=(17, 25, 9),
                         device="cpu")


def _scene_curves():
    """``align_fl``'s arguments: the tube scene's rings, moved by a seeded
    rigid (t, s)."""
    from recmv_tpu_torch.data.synthetic import SCENE_CURVES, boundary_ring
    from recmv_tpu_torch.geometry.polygons import uniform_sample_3d

    rng = np.random.RandomState(7)
    aligned, template, rigid = {}, {}, {}
    for name, y, off in SCENE_CURVES["synthetic-tube"]:
        ring = uniform_sample_3d(boundary_ring(y, offset=off), 200).astype(np.float32)
        t, s = rng.uniform(-0.02, 0.02, 3).astype(np.float32), np.float32(1.05)
        c = ring.mean(0, keepdims=True)
        aligned[name], template[name], rigid[name] = (ring - c) * s + c + t, ring, (t, s)
    return aligned, template, rigid


def _dress(net, templates_of):
    """Give a network what an initialization leaves: curves, templates,
    clip boxes, a step count, and optimizer state."""
    from recmv_tpu_torch.core.network import _template_box

    net.align_fl(*_scene_curves())
    net.garment_templates = templates_of(net)
    net.garment_extract_bboxes = [_template_box(t.verts) for t in net.garment_templates]
    net.opt_times = 7.0
    with torch.no_grad():
        net.params["curves"]["nx_scale"] += 0.01
    for opt, leaves in ((net.global_opt, net.global_leaves().values()),
                        (net.curve_opt, net.curve_leaves())):
        for p in leaves:
            p.grad = torch.ones_like(p)
        opt.step()
        opt.zero_grad(set_to_none=True)


def _port_templates(net):
    from recmv_tpu_torch.models.garment import garment_templates_from_body

    return [t.dense_boundary(1) for t in garment_templates_from_body(
        net.statics.garment_names, net.tmp_body_vs.numpy(), net.tmp_body_fs.numpy(),
        net.params["skinner"].Js.numpy())]


def _state(net) -> dict:
    """Everything a checkpoint restores, as numpy."""
    params = bridge.export_params(net.params)
    params["curves"] = {k: v.detach().numpy().copy() for k, v in net.params["curves"].items()}
    return dict(params=params, scene=bridge.scene_to_numpy(net.scene),
                statics={k: getattr(net.curve_statics, k).numpy()
                         for k in bridge.CURVE_FIELDS},
                fl_names=net.curve_statics.fl_names, opt_times=net.opt_times,
                boxes=net.garment_extract_bboxes,
                templates=[(t.name, t.verts, t.faces, t.boundary_labels)
                           for t in net.garment_templates])


def _assert_same(got, want):
    if isinstance(want, dict):
        assert sorted(got) == sorted(want)
        for k in want:
            _assert_same(got[k], want[k])
    elif isinstance(want, (list, tuple)):
        assert len(got) == len(want)
        for a, b in zip(got, want):
            _assert_same(a, b)
    elif isinstance(want, (str, float, int)):
        assert got == want
    else:
        np.testing.assert_array_equal(np.asarray(got), np.asarray(want))
        assert np.asarray(got).dtype == np.asarray(want).dtype


# ---------------------------------------------------------------------------
# (a) the port's round trip
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("with_boxes", [True, False], ids=["boxes", "older-no-boxes"])
def test_save_load_round_trip(scene, tmp_path, with_boxes):
    src = _port_net(scene, tmp_path / "a")
    _dress(src, _port_templates)
    want = _state(src)
    if not with_boxes:
        src.garment_extract_bboxes = None
    path = str(tmp_path / "x" / "state.ckpt")
    src.save_checkpoint(path, epoch=3)
    with open(path, "rb") as f:
        raw = pickle.load(f)
    assert set(raw) == {"epoch", "params", "skinner", "scene", "opt_times",
                        "garment_extract_bboxes", "curve_statics", "curve_fl_names",
                        "garment_templates"}
    assert isinstance(raw["skinner"], dict) and raw["epoch"] == 3

    dst = _port_net(scene, tmp_path / "a")
    _dress(dst, lambda net: [])
    assert len(dst.global_opt.state) > 0 and len(dst.curve_opt.state) > 0
    assert dst.load_checkpoint(path) == 3
    _assert_same(_state(dst), want)
    assert len(dst.global_opt.state) == 0 and len(dst.curve_opt.state) == 0
    held = [p for g in dst.curve_opt.param_groups for p in g["params"]]
    assert all(a is b for a, b in zip(held, dst.curve_leaves()))
    assert all(p.requires_grad for p in dst.curve_leaves())
    _assert_same(bridge.skinner_to_numpy(dst.params["skinner"]),
                 bridge.skinner_to_numpy(src.params["skinner"]))
    np.testing.assert_array_equal(dst.dataset.params.poses, want["scene"]["poses"])


# ---------------------------------------------------------------------------
# (b) a JAX package checkpoint, read without JAX
# ---------------------------------------------------------------------------

_READER = r"""
import pickle, sys
sys.modules["jax"] = None
sys.modules["recmv_tpu"] = None
import numpy as np
from recmv_tpu_torch import bridge
from recmv_tpu_torch.config import ConfigFactory
from recmv_tpu_torch.core.builder import build_opt_net
from recmv_tpu_torch.data.dataset import get_dataset_and_loader
from recmv_tpu_torch.utils.checkpoint import PackageRecord, read_checkpoint

conf, scene, save_root, ckpt, out = sys.argv[1:]
state = read_checkpoint(ckpt)
assert isinstance(state["skinner"], PackageRecord), type(state["skinner"])
assert state["skinner"].source == "recmv_tpu.models.skinner.SkinnerParams"
ds, _ = get_dataset_and_loader(scene, {"deformer": 256, "render": 256}, 2, shuffle=False,
                               garment_type="synthetic-tube", data_type="synthe")
net = build_opt_net(ConfigFactory.parse_file(conf), ds, save_root,
                    resolutions=((7, 9, 5), (13, 17, 9)), skinner_res=(17, 25, 9),
                    device="cpu")
epoch = net.load_checkpoint(ckpt)
params = bridge.export_params(net.params)
params["curves"] = {k: v.detach().numpy() for k, v in net.params["curves"].items()}
res = dict(epoch=epoch, params=params, scene=bridge.scene_to_numpy(net.scene),
           statics={k: getattr(net.curve_statics, k).numpy() for k in bridge.CURVE_FIELDS},
           fl_names=net.curve_statics.fl_names, opt_times=net.opt_times,
           boxes=net.garment_extract_bboxes,
           templates=[(t.name, t.verts, t.faces, t.boundary_labels)
                      for t in net.garment_templates],
           modules=sorted(m for m in sys.modules
                          if m.split(".")[0] in ("jax", "jaxlib", "recmv_tpu")
                          and sys.modules[m] is not None))
with open(out, "wb") as f:
    pickle.dump(res, f)
"""


def test_reads_a_jax_checkpoint_without_jax(scene, tmp_path):
    """The JAX network on the same scene, dressed as an initialization
    leaves it (curves, templates, boxes, a step count), saved by the JAX
    ``save_checkpoint``; read in a subprocess where JAX and the JAX package
    cannot be imported."""
    import jax

    from recmv_tpu.config import ConfigFactory as JConf
    from recmv_tpu.core.builder import build_opt_net as jbuild
    from recmv_tpu.core.network import TrainConfig as JCfg
    from recmv_tpu.data.dataset import get_dataset_and_loader as jdata
    from recmv_tpu.models.garment import garment_templates_from_body as jtemplates

    ds, _ = jdata(scene, {"deformer": 256, "render": 256}, 2, shuffle=False,
                  garment_type="synthetic-tube", data_type="synthe")
    net_j = jbuild(JConf.parse_file(CONF), ds, str(tmp_path / "jax"),
                   resolutions=((7, 9, 5), (13, 17, 9)), skinner_res=(17, 25, 9),
                   train_cfg=JCfg(batch_size=2, image_size=(IMG, IMG)))
    net_j.align_fl(*_scene_curves())
    net_j.params["curves"] = {k: v + 0.01 for k, v in net_j.params["curves"].items()}
    net_j.garment_templates = [t.dense_boundary(1) for t in jtemplates(
        net_j.statics.garment_names, np.asarray(net_j.tmp_body_vs),
        np.asarray(net_j.tmp_body_fs), np.asarray(net_j.params["skinner"].Js))]
    net_j.garment_extract_bboxes = [(np.full(3, -0.4, np.float32), np.full(3, 0.4, np.float32))]
    net_j.opt_times = 5.0
    ckpt = str(tmp_path / "jax" / "jax.ckpt")
    net_j.save_checkpoint(ckpt, epoch=2)
    os.makedirs(tmp_path / "port")
    shutil.copy(tmp_path / "jax" / "initial_skinner_0.npz", tmp_path / "port")

    out = str(tmp_path / "out.pkl")
    env = dict(os.environ, PYTHONPATH=os.path.abspath(ROOT))
    proc = subprocess.run([sys.executable, "-c", _READER, CONF, scene, str(tmp_path / "port"),
                           ckpt, out], capture_output=True, text=True, env=env, timeout=300)
    assert proc.returncode == 0, proc.stderr[-3000:]
    with open(out, "rb") as f:
        got = pickle.load(f)
    assert got["modules"] == [] and got["epoch"] == 2 and got["opt_times"] == 5.0
    tree = jax.tree_util.tree_map(np.asarray, {k: net_j.params[k] for k in (
        "sdf", "garment_sdfs", "translator", "render", "curves")})
    tree["skinner"] = bridge.skinner_to_numpy(bridge.skinner_from_jax(
        jax.tree_util.tree_map(np.asarray, net_j.params["skinner"]), device="cpu"))
    for k in tree:
        _assert_same(got["params"][k], tree[k])
    _assert_same(got["scene"], jax.tree_util.tree_map(np.asarray, net_j.scene_tree()))
    cs = net_j.curve_statics
    _assert_same(got["statics"], {k: np.asarray(getattr(cs, k)) for k in bridge.CURVE_FIELDS})
    assert got["fl_names"] == cs.fl_names
    _assert_same(got["boxes"], net_j.garment_extract_bboxes)
    _assert_same(got["templates"], [(t.name, t.verts, t.faces, t.boundary_labels)
                                    for t in net_j.garment_templates])


_BENCHES = r"""
import importlib, pkgutil, sys
sys.modules["jax"] = None
sys.modules["recmv_tpu"] = None
import recmv_tpu_torch.bench
import recmv_tpu_torch.tools as tools
names = [m.name for m in pkgutil.iter_modules(tools.__path__, "recmv_tpu_torch.tools.")]
for n in names:
    importlib.import_module(n)
bad = [m for m in sys.modules if m.split(".")[0] in ("jax", "jaxlib", "recmv_tpu")
       and sys.modules[m] is not None]
assert not bad, bad
print(" ".join(sorted(names)))
"""


def test_benches_import_without_jax():
    """``recmv_tpu_torch.bench`` and every ``recmv_tpu_torch.tools`` module
    import in a subprocess in which ``import jax`` and ``import recmv_tpu``
    fail."""
    env = dict(os.environ, PYTHONPATH=os.path.abspath(ROOT))
    proc = subprocess.run([sys.executable, "-c", _BENCHES], capture_output=True, text=True,
                          env=env, timeout=300)
    assert proc.returncode == 0, proc.stderr[-3000:]
    names = {n.rsplit(".", 1)[1] for n in proc.stdout.split()}
    assert {"bench_quality", "bench_fullstep", "bench_largepose", "bench_animation",
            "eval_chamfer", "compute_CSI", "fitting_garment_meshes",
            "quality_vs_records"} <= names, names


# ---------------------------------------------------------------------------
# (c) the training CLI
# ---------------------------------------------------------------------------

def _cli(scene, *extra):
    """The CLI at the tiny pyramid; a later ``--conf`` overrides
    ``smoke.conf``."""
    from recmv_tpu_torch.train import main

    return main(["--conf", CONF, "--data-root", scene, "--quality", "tiny", *extra])


def test_cli_initializes_trains_and_resumes(capsys, tmp_path):
    """On a 2-frame scene (one batch an epoch), with ``smoke.conf``'s
    medium stage moved to epoch 1: run 1 initializes (the npz cache,
    ``initial_sdf.ckpt``), trains 1 step (all of epoch 0) and writes
    ``latest.ckpt``; run 2 resumes from it at its epoch and step count
    with the saved parameters, trains epoch 0 again (1 step), promotes to
    the medium stage at epoch 1 (``medium_promote.ckpt``, the medium loss
    block, radius and remesh interval, a fresh remesh) and trains 1 step
    there."""
    from recmv_tpu_torch.config import ConfigFactory, dump_config
    from recmv_tpu_torch.core.network import GarmentOptimNetwork
    from recmv_tpu_torch.data.synthetic import generate_scene
    from recmv_tpu_torch.utils.checkpoint import read_checkpoint

    scene = generate_scene(str(tmp_path / "scene"), n_frames=2, image_size=IMG,
                           skinner_res=(17, 25, 9), device="cpu")
    conf = ConfigFactory.parse_file(CONF)
    conf["train"]["medium"]["start_epoch"] = 1
    conf_path = str(tmp_path / "medium_at_1.conf")
    with open(conf_path, "w") as f:
        f.write(dump_config(conf))
    save = os.path.join(scene, "result")
    net = _cli(scene, "--conf", conf_path, "--device", "cpu", "--init-epochs", "4",
               "--fl-iters", "2", "--max-steps", "1")
    for f in ("config.conf", "initial_sdf.ckpt", "latest.ckpt",
              os.path.join("fl_init", "init_trans_matrix.npz"),
              os.path.join("logs", "scalars.jsonl")):
        assert os.path.isfile(os.path.join(save, f)), f
    out = capsys.readouterr().out
    assert "one-time initialization (4 IGR epochs)" in out and out.count("] ep0 step") == 1
    assert net.curve_statics is not None and net.opt_times == 1.0
    assert list(net.init_times)[-1] == "igr tube" and net.garment_extract_bboxes
    assert all(np.isfinite(v) for v in net.info.values())
    saved = read_checkpoint(os.path.join(save, "latest.ckpt"))
    assert saved["epoch"] == 0 and saved["opt_times"] == 1.0
    loaded = {}
    load = GarmentOptimNetwork.load_checkpoint

    def spy(self, path):
        epoch = load(self, path)
        loaded.update(epoch=epoch, params=bridge.export_params(self.params),
                      curves={k: v.detach().numpy().copy()
                              for k, v in self.params["curves"].items()})
        return epoch

    GarmentOptimNetwork.load_checkpoint = spy
    try:
        net2 = _cli(scene, "--conf", conf_path, "--device", "cpu", "--resume",
                    os.path.join(save, "latest.ckpt"), "--max-steps", "2")
    finally:
        GarmentOptimNetwork.load_checkpoint = load
    out = capsys.readouterr().out
    assert "resumed from" in out and "at epoch 0" in out and "one-time" not in out
    assert out.count("] ep0 step") == 1 and out.count("] ep1 step") == 1
    assert loaded["epoch"] == 0 and net2.opt_times == 3.0
    for k in ("sdf", "garment_sdfs", "translator", "render", "curves"):
        _assert_same(loaded["curves"] if k == "curves" else loaded["params"][k],
                     saved["params"][k])
    assert "enabled medium hierarchy" in out
    assert read_checkpoint(os.path.join(save, "medium_promote.ckpt"))["epoch"] == 1
    assert read_checkpoint(os.path.join(save, "latest.ckpt"))["epoch"] == 1
    assert net2.conf.get_float("color_weight") == 1.0       # loss_medium (coarse: 0.5)
    assert (net2.cfg.point_radius, net2.cfg.remesh_intersect) == (0.012, 24)
    assert net2._remeshed_at == 2.0 and not net2.isfine


@pytest.mark.parametrize("flag", ["--save-debug", "--wandb"])
def test_cli_refuses_unported_options(scene, flag):
    """``--wandb`` is refused before any work (it needs a network);
    ``--save-debug``, ported since, passes that check and reaches the
    device check, which fails here without a card."""
    if flag == "--save-debug":
        if torch.cuda.is_available():
            pytest.skip("a CUDA device is present")
        with pytest.raises(RuntimeError, match="no CUDA device"):
            _cli(scene, flag)
        return
    with pytest.raises(SystemExit) as e:
        _cli(scene, "--device", "cpu", flag)
    assert "needs a network" in str(e.value.code) and flag in str(e.value.code)


def test_cli_needs_the_card_unless_told(scene):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        _cli(scene)
