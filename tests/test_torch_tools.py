"""The port's scene-preparation and visualization tools
(``recmv_tpu_torch/tools/{generate_normals, parsing_mask_to_fl,
mask2parsing_mask, visualize, visualize_curve, comparison_results}.py``)
against the JAX package's scripts, on the CPU, and the accounting of the
port: every JAX module and script has a counterpart, stands in the
do-not-port map with its reason, or imports neither JAX nor ``recmv_tpu``.

One 2-frame 64 px synthetic-tube scene is made per module, with its body
and camera moved 2.6 further along z (the same views, as
``tests/test_torch_infer.py`` does), and a checkpoint of a JAX network
on it with the scene's rings as curves (the port's ``load_net`` reads
either package's checkpoints, the JAX one only its own). Each tool runs on a copy
of the scene beside its JAX script on another copy. On the CPU the JAX
mesh z-buffer takes its XLA path and the port the plain version of K1.

Tolerances and why:
- the ``mask2fl`` JSONs, parsing masks, overlays and comparison strips:
  equal (the same numpy code on the same pixels; the z-buffers agree
  while every face spans at most two tiles);
- the normal maps: the same covered pixels, and each byte within 1 on at
  most 1e-3 of the pixels: a face normal is a float32 cross product and
  norm in each package, a last bit apart, and ``(n + 1)/2·255`` truncates
  to a byte (measured: 1 byte of one pixel of 8,192 off by 1);
- the comparison strips outside the label band: the JAX script writes
  each method's name into the top rows of its tile with ``cv2.putText``,
  the port lists the names in ``methods.txt``;
- the curve tubes: the canonical ones within 1e-6 (the same numpy sweep
  of curves computed in float32 by each package); the deformed ones
  within 1e-6 of their largest coordinate: the deformer (the bf16
  translator, the skinning) sums in another order, which moves a vertex
  at |z| ≈ 2.6 by a few float32 ulps (measured 1.4e-6).
"""

import ast
import glob
import importlib.util
import json
import os
import shutil

import numpy as np
import pytest
import torch

ROOT = os.path.join(os.path.dirname(__file__), "..")
IMG = 64
N_FRAMES = 2
LABEL_ROWS = 32        # the rows of a tile the JAX label can touch (cv2.putText at y = 24)
MESH_RES = 17          # the rendered garment's grid: faces of a few pixels, never sub-pixel


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    """One intra-op thread (the tests run beside other pytest workers)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _jax_script(rel: str):
    """A JAX package script (``tools/…``, ``preprocess/…``) as a module."""
    path = os.path.join(ROOT, rel)
    spec = importlib.util.spec_from_file_location("jax_" + rel.replace("/", "_")[:-3], path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _shift(path: str, key: str, dz: float) -> None:
    with np.load(path) as z:
        arrays = {k: z[k] for k in z.files}
    arrays[key] = (arrays[key] + np.asarray([0.0, 0.0, dz], np.float32)).astype(np.float32)
    np.savez(path, **arrays)


@pytest.fixture(scope="module")
def scene(tmp_path_factory):
    """The scene (body and camera moved back); a coarse garment
    (``MESH_RES``³ grid) turned by 0.4 rad a frame, as per-frame OBJs under
    ``meshs/`` and mirrored under ``flipped/``; and
    ``result/{config.conf,latest.ckpt}`` of a JAX network with the scene's
    rings as curves."""
    from recmv_tpu.config import ConfigFactory as JConf
    from recmv_tpu.config import dump_config
    from recmv_tpu.core.builder import build_opt_net as jbuild
    from recmv_tpu.data.dataset import get_dataset_and_loader as jdata
    from recmv_tpu_torch.data.synthetic import garment_mesh, generate_scene
    from recmv_tpu_torch.utils.io import save_obj
    from test_torch_checkpoint import _scene_curves

    root = tmp_path_factory.mktemp("tools")
    scene = generate_scene(str(root / "scene"), n_frames=N_FRAMES, image_size=IMG,
                           skinner_res=(17, 25, 9), device="cpu")
    _shift(os.path.join(scene, "smpl_rec.npz"), "trans", 2.6)
    _shift(os.path.join(scene, "camera.npz"), "T", 2.6)
    gv, gf = garment_mesh(res=MESH_RES)
    for fid in range(N_FRAMES):
        c, s = np.cos(0.4 * fid), np.sin(0.4 * fid)
        v = gv @ np.asarray([[c, 0, -s], [0, 1, 0], [s, 0, c]], np.float32).T
        v = (v + np.asarray([0.0, 0.0, 2.6], np.float32)).astype(np.float32)
        save_obj(os.path.join(scene, "meshs", f"{fid:04d}_tube.obj"), v, gf)
        save_obj(os.path.join(scene, "flipped", f"{fid:04d}_tube.obj"),
                 v * np.asarray([-1.0, 1.0, 1.0], np.float32), gf[:, ::-1])

    conf_path = os.path.join(ROOT, "configs", "synthetic", "smoke.conf")
    ds, _ = jdata(scene, {"deformer": 256, "render": 256}, 1, shuffle=False,
                  garment_type="synthetic-tube", data_type="synthe")
    save = os.path.join(scene, "result")
    conf = JConf.parse_file(conf_path)
    net = jbuild(conf, ds, save, resolutions=((7, 9, 5), (13, 17, 9)), skinner_res=(17, 25, 9))
    net.align_fl(*_scene_curves())
    net.save_checkpoint(os.path.join(save, "latest.ckpt"), epoch=1)
    with open(os.path.join(save, "config.conf"), "w") as f:
        f.write(dump_config(conf))
    return scene


def _copy(scene, dst) -> str:
    shutil.copytree(scene, dst)
    return str(dst)


def _pngs(d) -> dict:
    from recmv_tpu_torch.data.image import imread

    return {os.path.basename(p): imread(p) for p in sorted(glob.glob(os.path.join(d, "*.png")))}


def _same_pngs(got_dir, want_dir, n) -> None:
    got, want = _pngs(got_dir), _pngs(want_dir)
    assert sorted(got) == sorted(want) and len(got) == n
    for k in want:
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)


def test_generate_normals_matches_jax(scene, tmp_path):
    """The normal maps of the posed body: the same covered pixels, and the
    bytes within 1 on at most 1e-3 of the pixels, equal elsewhere."""
    from recmv_tpu_torch.tools import generate_normals

    a, b = _copy(scene, tmp_path / "jax"), _copy(scene, tmp_path / "port")
    for d in (a, b):
        shutil.rmtree(os.path.join(d, "normals"))
    _jax_script("tools/generate_normals.py").main(["--data-root", a, "--platform", "cpu"])
    generate_normals.main(["--data-root", b, "--device", "cpu"])
    got, want = _pngs(os.path.join(b, "normals")), _pngs(os.path.join(a, "normals"))
    assert sorted(got) == sorted(want) and len(got) == N_FRAMES
    for k in want:
        hit = (want[k] != 127).any(-1)
        assert 200 < hit.sum() < IMG * IMG / 2
        np.testing.assert_array_equal((got[k] != 127).any(-1), hit, err_msg=k)
        diff = np.abs(got[k].astype(int) - want[k].astype(int))
        assert diff.max() <= 1 and (diff > 0).any(-1).mean() <= 1e-3, (k, diff.max())


def test_parsing_mask_to_fl_matches_jax(scene, tmp_path):
    """The contour arcs of each frame's "upper" region between the
    projected shoulders and hips: the same JSONs, and a neck and a hem arc
    on every frame."""
    from recmv_tpu_torch.tools import parsing_mask_to_fl

    a, b = _copy(scene, tmp_path / "jax"), _copy(scene, tmp_path / "port")
    _jax_script("tools/parsing_mask_to_fl.py").main(["--data-root", a, "--platform", "cpu"])
    assert parsing_mask_to_fl.main(["--data-root", b, "--device", "cpu"]) == N_FRAMES
    for fid in range(N_FRAMES):
        with open(os.path.join(a, "mask2fl", f"{fid}.json")) as f:
            want = json.load(f)
        with open(os.path.join(b, "mask2fl", f"{fid}.json")) as f:
            got = json.load(f)
        assert got == want
        assert [s["label"] for s in got["shapes"]] == ["neck", "bottom_curve"]


def test_find_external_contours_matches_cv2():
    """The contour finder against ``cv2.findContours(RETR_EXTERNAL,
    CHAIN_APPROX_NONE)`` on seeded masks: blobs, speckle, single pixels,
    rings with islands inside and touching the border; the same contours
    in the same order, point for point."""
    import cv2
    from scipy import ndimage

    from recmv_tpu_torch.tools.parsing_mask_to_fl import find_external_contours

    rng = np.random.default_rng(0)
    for it in range(200):
        h, w = rng.integers(1, 60, 2)
        if it % 3 == 0:
            m = rng.random((h, w)) < rng.random()
        else:
            m = ndimage.gaussian_filter(rng.random((h, w)), rng.uniform(0.5, 3)) > 0.5
        if it % 4 == 0:
            yy, xx = np.mgrid[:h, :w]
            r = np.hypot(yy - h / 2, xx - w / 2)
            m |= ((r > 6) & (r < 9)) | (r < 2)
        m = m.astype(np.uint8)
        want, _ = cv2.findContours(m.copy(), cv2.RETR_EXTERNAL, cv2.CHAIN_APPROX_NONE)
        got = find_external_contours(m)
        assert len(got) == len(want), it
        for g, c in zip(got, want):
            np.testing.assert_array_equal(g, c[:, 0, :], err_msg=str(it))


def test_mask2parsing_mask_matches_jax(scene, tmp_path):
    """The KNN-propagated labels of each frame's mask: the same arrays."""
    from recmv_tpu_torch.tools import mask2parsing_mask

    a, b = _copy(scene, tmp_path / "jax"), _copy(scene, tmp_path / "port")
    for d in (a, b):
        for p in glob.glob(os.path.join(d, "parsing_SCH_ATR", "mask_parsing_*.npy")):
            os.remove(p)
    args = ["--garment-type", "synthetic-tube"]
    _jax_script("preprocess/mask2parsing_mask.py").main(["--data-root", a] + args)
    paths = mask2parsing_mask.main(["--data-root", b] + args)
    assert len(paths) == N_FRAMES
    for p in paths:
        want = np.load(os.path.join(a, os.path.relpath(p, b)))
        got = np.load(p)
        np.testing.assert_array_equal(got, want)
        assert (got == 4).sum() > 100


def test_visualize_matches_jax(scene, tmp_path):
    """The overlays of the per-frame meshes on the frames: the same PNGs."""
    from recmv_tpu_torch.tools import visualize

    args = ["--data-root", scene, "--mesh-dir", os.path.join(scene, "meshs")]
    _jax_script("tools/visualize.py").main(args + ["--out", str(tmp_path / "jax"),
                                                   "--platform", "cpu"])
    assert visualize.main(args + ["--out", str(tmp_path / "port"), "--device", "cpu"]) == 2
    _same_pngs(tmp_path / "port", tmp_path / "jax", N_FRAMES)


def test_visualize_curve_matches_jax(scene, tmp_path, monkeypatch):
    """The canonical curve tubes and those deformed to frames 0 and 1 from
    the checkpoint: the same files, the faces equal, the vertices within
    1e-6 (of the largest coordinate for the deformed ones)."""
    from recmv_tpu.core import builder as jbuilder
    from recmv_tpu_torch.core import builder
    from recmv_tpu_torch.tools import visualize_curve
    from recmv_tpu_torch.utils.io import load_obj

    # the checkpoint's pyramid at every --quality, in both packages
    for mod in (jbuilder, builder):
        pyramid = mod.resolution_pyramids("tiny")
        monkeypatch.setattr(mod, "resolution_pyramids", lambda level, p=pyramid: p)
    monkeypatch.syspath_prepend(ROOT)
    args = ["--data-root", scene, "--frames", "0", "1"]
    _jax_script("tools/visualize_curve.py").main(args + ["--out", str(tmp_path / "jax"),
                                                         "--platform", "cpu"])
    wrote = visualize_curve.main(args + ["--out", str(tmp_path / "port"), "--device", "cpu"])
    names = sorted(os.path.basename(p) for p in wrote)
    assert names == sorted(os.listdir(tmp_path / "jax")) and len(names) == 6
    for n in names:
        v, f = load_obj(str(tmp_path / "port" / n))
        vj, fj = load_obj(str(tmp_path / "jax" / n))
        np.testing.assert_array_equal(f, fj)
        scale = 1.0 if n.startswith("cano_") else np.abs(vj).max()
        np.testing.assert_allclose(v, vj, atol=1e-6 * scale, rtol=0, err_msg=n)


def test_comparison_results_matches_jax(scene, tmp_path):
    """The turntable strips of two methods: the same pixels outside the
    JAX script's label band, the names in ``methods.txt`` in strip order."""
    from recmv_tpu_torch.data.image import imread
    from recmv_tpu_torch.tools import comparison_results

    methods = [f"ours={os.path.join(scene, 'meshs')}", f"mirror={os.path.join(scene, 'flipped')}"]
    _jax_script("tools/comparison_results.py").main(
        ["--out", str(tmp_path / "jax"), "--image", "96"] + methods)
    assert comparison_results.main(["--out", str(tmp_path / "port"), "--image", "96",
                                    "--device", "cpu"] + methods) == N_FRAMES
    assert (tmp_path / "port" / "methods.txt").read_text() == "ours\nmirror\n"
    for i in range(N_FRAMES):
        got = imread(str(tmp_path / "port" / f"{i:04d}.png"))
        want = imread(str(tmp_path / "jax" / f"{i:04d}.png"))
        assert got.shape == want.shape == (96, 192, 3)
        np.testing.assert_array_equal(got[LABEL_ROWS:], want[LABEL_ROWS:])
        assert (got[LABEL_ROWS:] != 255).any(-1).sum() > 500


# ---------------------------------------------------------------------------
# the accounting
# ---------------------------------------------------------------------------

# JAX modules whose counterpart has another name
COUNTERPARTS = {
    "recmv_tpu/native/__init__.py": "recmv_tpu_torch/native.py",
    "recmv_tpu/ops/pallas_raster.py": "recmv_tpu_torch/ops/mesh_raster.py",
    "recmv_tpu/ops/pallas_composite.py": "recmv_tpu_torch/ops/composite.py",
    "preprocess/mask2parsing_mask.py": "recmv_tpu_torch/tools/mask2parsing_mask.py",
}
# JAX modules and scripts left out of the port, with the reason (ROADMAP.md)
DO_NOT_PORT = {
    "recmv_tpu/parallel/__init__.py": "GSPMD over the TPU's ICI; the target is one H100",
    "recmv_tpu/parallel/mesh.py": "GSPMD over the TPU's ICI; the target is one H100",
    "recmv_tpu/utils/exec_cache.py": "a cache of serialized XLA executables; the port "
                                     "compiles only its kernels",
    "tools/trace_report.py": "reads XLA TPU profiles; the port's counterparts are "
                             "chip_profile.py and utils/profiling.py",
}
# scripts that import neither JAX nor recmv_tpu, and so run beside the port as they are
NEEDS_NO_PORT = {
    "tools/animation_visualize.py", "tools/foreground.py", "tools/generate_boxs.py",
    "tools/make_subject_configs.py", "tools/resize_video_imgs.py", "tools/sym_frame.py",
    "tools/people_aposefemale_process.py", "preprocess/people_snapshot_process.py",
}


def _imports(path: str) -> set:
    """The top-level names of every module ``path`` imports (by AST); a
    relative import counts as the package the file lies in."""
    package = os.path.relpath(path, ROOT).split(os.sep)[0]
    with open(path) as f:
        tree = ast.parse(f.read(), path)
    out = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            out |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom):
            out.add(package if node.level else (node.module or "").split(".")[0])
    return out


def _rel_files(*dirs) -> list:
    out = []
    for d in dirs:
        for base, _, files in os.walk(os.path.join(ROOT, d)):
            out += [os.path.relpath(os.path.join(base, f), ROOT) for f in files
                    if f.endswith(".py")]
    return sorted(out)


def test_every_jax_module_is_accounted_for():
    """Each module of ``recmv_tpu/`` (importing any imports JAX) and each
    script of ``tools/`` and ``preprocess/`` that imports JAX or
    ``recmv_tpu`` has a counterpart under ``recmv_tpu_torch/`` (the same
    path, ``tools/<name>.py`` for a script, or ``COUNTERPARTS``) or a
    reason in ``DO_NOT_PORT``; the other scripts are ``NEEDS_NO_PORT``.
    No file of the port and not ``chip_smoke.py`` imports ``jax`` or
    ``recmv_tpu``."""
    missing, no_port = [], set()
    for rel in _rel_files("recmv_tpu", "tools", "preprocess"):
        in_package = rel.startswith("recmv_tpu/")
        if not in_package and not _imports(os.path.join(ROOT, rel)) & {"jax", "recmv_tpu"}:
            no_port.add(rel)
            continue
        if rel in DO_NOT_PORT:
            continue
        port = COUNTERPARTS.get(rel) or (
            "recmv_tpu_torch/" + rel[len("recmv_tpu/"):] if in_package
            else "recmv_tpu_torch/tools/" + os.path.basename(rel))
        if not os.path.isfile(os.path.join(ROOT, port)):
            missing.append((rel, port))
    assert not missing, missing
    assert no_port - set(DO_NOT_PORT) == NEEDS_NO_PORT
    for rel in list(COUNTERPARTS) + list(DO_NOT_PORT):
        assert os.path.isfile(os.path.join(ROOT, rel)), rel

    bad = [(rel, sorted(_imports(os.path.join(ROOT, rel)) & {"jax", "jaxlib", "recmv_tpu"}))
           for rel in _rel_files("recmv_tpu_torch") + ["chip_smoke.py"]]
    assert not [b for b in bad if b[1]], bad
