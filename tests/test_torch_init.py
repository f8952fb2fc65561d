"""Parity of the port's scene initialization with the JAX package, on the
CPU.

Both networks are built on one 4-frame 48 px synthetic scene (skinner
(17, 25, 9), 2-level pyramid; the port reads the skinner and body mesh
the JAX ``build_opt_net`` cached), and the port takes the JAX parameters and scene
through ``recmv_tpu_torch.bridge``. The JAX mesh z-buffer takes its XLA
path on the CPU, the port the plain version of K1.

(a) the copied ``mesh_utils``/``matching``/``garment`` functions on the
    synthetic body and on a template asset written under ``tmp_path``,
    and ``extract_curve_from_patch``; (b) ``laplacian_deform``, dense and
    CG, with and without ``smooth`` and ``displacement``; (c)
    ``igr_init_loss`` and its gradients; (d) ``igr_fit_sdf`` (3 epochs of
    two minibatches, on a narrow SDF) with the JAX draws replayed; (e)
    ``initialize_fl``: with the JAX frozen gate injected, on the tube and
    the skirt (rescue) scenes, then end to end through the port's own
    z-buffer gate, and the even-count median; (f) ``initialize_tmp_sdf(
    nepochs=4, fl_iters=2)`` reading the JAX curve fit's
    ``init_trans_matrix.npz``: templates, curve statics, clip boxes, the
    checkpoint; (g) ``discretize_sdf`` with and without the clip boxes;
    (h) the same whole initialization with nothing stubbed, the JAX IGR
    fits run and their draws replayed into the port: each fit's points,
    bias shift and SDF leaves (the garment's also from the JAX points),
    and the first ``marching_cube_update``;
    (i) on the JAX package's initialized state (its ``initial_sdf.ckpt``,
    read by the port's ``load_checkpoint``): the ray seeding and surface
    solve ray by ray, and one training step, whose converged ray counts
    and info are equal.

Tolerances (float32) and why:
- (a): exact: the same numpy code on the same inputs;
- (b): 2e-5 absolute (measured 2.5e-6 dense, 1.1e-6 CG; LAPACK's and
  XLA's LU, and the edge sums, round in other orders);
- (c): 1e-6 relative on the loss terms, 1e-5 on the gradients;
- (d): loss within 1e-4 relative; each parameter within 2e-2 of lr on
  the entries whose JAX update is at least lr/2 (Adam's first steps are
  about ±lr·sign(g), and entries whose gradient is near 0 flip sign on a
  last-bit difference), and within 1e-5 of its norm over the whole leaf;
- (e) with the injected gate: T and s within 1e-5 (measured 1.6e-6:
  the same fit, summed in another order); end to end 2e-3 on T and s:
  the two z-buffers differ on sub-pixel body faces (up to 1e-3 of a
  depth, ``test_torch_curves``), which can flip a point whose gate value
  lies that close to 0.01, and the fit follows it (here no point flipped:
  end to end measured the same 1.6e-6);
- (f): the registered templates and the clip boxes 2e-4, the Laplacian
  tolerance of ``tests/test_geometry.py`` between its two solves
  (measured 7.5e-5 on the 3,648-vertex tube template: AᵀA + 1e-8·I is
  ill-conditioned, and LAPACK's and XLA's LU round differently); the
  curve statics 1e-5 (both read the same curve fit);
- (g): the same counts and vertices within 1e-5 of each other's
  (``test_torch_slice``);
- (h) the body fit (the same 1,600 points): the bias shift 1e-6
  (measured 3.7e-9); the entries whose JAX update is at least lr/2 and
  each leaf's norm within 1e-4 (measured 2.7e-5 and 1.7e-5: 4 Adam
  steps of an 8×512 SDF, whose 512-term sums round in another order;
  entries with a near-zero gradient may flip sign, (d)). The garment fit
  on the JAX points, from the JAX starting state with the JAX draws:
  each leaf within 1e-4 of its norm (measured 1.7e-5); of the 1,355,278
  moved entries all but at most 10 within 2e-5 (measured: one beyond,
  9.2e-5; the next 1.0e-5, the 99.99th percentile 4.7e-7), each within
  2·lr a step (4e-3): an entry whose gradient is at rounding level takes
  Adam's normalised step m/√v on that noise, and which entries do moves
  with the XLA CPU thread count. A fit that skipped its steps would miss
  every moved entry by lr/2 or more. The garment fit on each package's
  own points: the two registered templates differ by the Laplacian's
  rounding, which moves the area sampler's face CDF, so 11.8% of the
  8,258 samples land on another face of the same surface (up to 0.106
  away); at least 80% within 2e-4. So the bias shift is 1e-6 on the same
  points and 2e-4 on each package's own (measured 5.9e-5), and the
  fitted leaves differ by what those samples pull: within 0.1 of a
  leaf's norm (measured 0.048; no fit at all reads 1.0, on the biases
  the geometric init zeroes), and the weight leaves within a tenth of
  what the fit moves them (measured 6.0e-4 against 0.0197).
  The first remesh: counts equal (measured: body 345, garment 126
  vertices and 248 faces in both); on the JAX garment SDF the port's
  vertices in order within ``FIT_MC_ATOL`` = 1e-4 (measured 3.0e-5: the
  fitted SDF is flatter across its zero than the geometric init's, so
  the last-bit differences of (g) move a vertex further along its edge);
  on the port's own SDF each vertex within ``FIT_MC_NN`` = 0.05 of the
  other mesh (measured 0.0236, mean 0.0012);
- (i) the seeds exact (pixels, frames, live rays), their canonical points
  1e-5 (measured 1.5e-7); rays converged in both end within 1e-4 of each
  other (measured 8.0e-6: each Newton step t = −loss/‖∇‖² amplifies the
  SDF's last-bit differences). On this 4-epoch SDF most rays wander the
  whole 20-step budget, and the two walks of such a ray part on
  rounding: in five of the six frame pairs of the scene 1–2 of 38–47
  live rays converge in one package only, both ways (30 converged in
  each package over the six; ``tests/ray_convergence_report.py
  --parted``, two cores). Which rays part moves with the XLA CPU thread
  count, which moves the JAX initialization's last bits (frames 0 and 1:
  none on two cores, one on eight; frames 0 and 2: one on two cores,
  three on eight). So the solve tests hold each parted ray's end point
  to be converged for the port's SDF too (|sdf| < 5e-5 + 1e-6, the two
  SDFs' difference there; measured 4.67e-5), and at most 15% of the live
  rays parted. The step test holds its own solve so, inside the port's
  step, and then gives each parted ray the JAX step's end point and
  flag: the rest of the step then runs on the JAX step's solve on any
  machine, and its converged counts are equal and every info scalar is
  held as ``test_torch_train`` holds it. The JAX step runs its phases
  one by one there (``_fused_ok`` off, the package's own fallback), so
  that its solve can be read between them.
"""

import os
import shutil

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from recmv_tpu_torch import bridge
from test_torch_train import RATIO, _np_tree, _t, _train_cfg

IMG = 48
N_FRAMES = 4
MC_ATOL = 1e-5
CONFS = {"synthetic-tube": "smoke.conf", "synthetic-two": "smoke_two.conf"}
ROOT = os.path.join(os.path.dirname(__file__), "..")


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    """One intra-op thread for the port's tiny tensors (the tests run beside
    other pytest workers)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _build_init_pair(root, garment_type):
    """Both networks on a fresh 4-frame 48 px scene of ``garment_type``; the
    port reads the skinner cache the JAX ``build_opt_net`` wrote and takes the JAX
    parameters and scene."""
    from recmv_tpu.config import ConfigFactory as JConf
    from recmv_tpu.core.builder import build_opt_net as jbuild
    from recmv_tpu.core.network import TrainConfig as JCfg
    from recmv_tpu.data.dataset import get_dataset_and_loader as jdata
    from recmv_tpu_torch.config import ConfigFactory
    from recmv_tpu_torch.config.constants import TEMPLATE_GARMENT
    from recmv_tpu_torch.core.builder import build_opt_net
    from recmv_tpu_torch.core.network import TrainConfig
    from recmv_tpu_torch.data.dataset import get_dataset_and_loader
    from recmv_tpu_torch.data.synthetic import generate_scene

    scene = generate_scene(str(root / "scene"), n_frames=N_FRAMES, image_size=IMG,
                           skinner_res=(17, 25, 9), garment_type=garment_type, device="cpu")
    conf_path = os.path.join(ROOT, "configs", "synthetic", CONFS[garment_type])
    G = len(TEMPLATE_GARMENT[garment_type])
    args = ({"deformer": 128 * (1 + G), "render": 256}, 2)
    kw = dict(shuffle=False, garment_type=garment_type, data_type="synthe")
    pyr = ((7, 9, 5), (13, 17, 9))
    ds_j, _ = jdata(scene, *args, **kw)
    net_j = jbuild(JConf.parse_file(conf_path), ds_j, str(root / "jax"), resolutions=pyr,
                   skinner_res=(17, 25, 9),
                   train_cfg=_train_cfg(JCfg, batch_size=2, image_size=(IMG, IMG),
                                        points_per_pixel=4))
    os.makedirs(root / "port")
    shutil.copy(root / "jax" / "initial_skinner_0.npz", root / "port")
    ds_t, _ = get_dataset_and_loader(scene, *args, **kw)
    net_t = build_opt_net(ConfigFactory.parse_file(conf_path), ds_t, str(root / "port"),
                          resolutions=pyr, skinner_res=(17, 25, 9),
                          train_cfg=_train_cfg(TrainConfig), device="cpu")
    np.testing.assert_array_equal(net_t.tmp_body_vs.numpy(), np.asarray(net_j.tmp_body_vs))
    bridge.load_jax_params(net_t.params, _np_tree(
        {k: net_j.params[k] for k in ("sdf", "garment_sdfs", "translator", "render",
                                      "skinner")}))
    bridge.load_scene(net_t.scene, _np_tree(net_j.scene_tree()))
    return net_j, net_t


@pytest.fixture(scope="module")
def tube(tmp_path_factory):
    return _build_init_pair(tmp_path_factory.mktemp("init_tube"), "synthetic-tube")


@pytest.fixture(scope="module")
def two(tmp_path_factory):
    return _build_init_pair(tmp_path_factory.mktemp("init_two"), "synthetic-two")


def _templates(net_j, template_dir=None):
    """Each package's ``garment_templates_from_body`` on the JAX network's
    canonical body."""
    from recmv_tpu.models.garment import garment_templates_from_body as jtemplates
    from recmv_tpu_torch.models.garment import garment_templates_from_body

    args = (net_j.statics.garment_names, np.asarray(net_j.tmp_body_vs),
            np.asarray(net_j.tmp_body_fs), np.asarray(net_j.params["skinner"].Js), template_dir)
    return jtemplates(*args), garment_templates_from_body(*args)


def _same_template(a, b):
    assert a.name == b.name
    np.testing.assert_array_equal(a.verts, b.verts)
    np.testing.assert_array_equal(a.faces, b.faces)
    assert list(a.boundary_labels) == list(b.boundary_labels)
    for k in a.boundary_labels:
        np.testing.assert_array_equal(a.boundary_labels[k], b.boundary_labels[k])


# ---------------------------------------------------------------------------
# (a) the copied numpy modules
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("scene", ["tube", "two"])
def test_templates_match_jax(request, scene):
    """The body templates and everything the initialization takes from them:
    ``dense_boundary(2)``, the feature lines, the closed mesh, the surface
    samples, the boundary matching to moved curves and the longest loop."""
    from recmv_tpu.geometry.matching import match_template_boundaries as jmatch
    from recmv_tpu.geometry.mesh_utils import sample_mesh_surface as jsample
    from recmv_tpu.models.curves import extract_curve_from_patch as jextract
    from recmv_tpu_torch.geometry.matching import match_template_boundaries
    from recmv_tpu_torch.geometry.mesh_utils import sample_mesh_surface
    from recmv_tpu_torch.models.curves import extract_curve_from_patch

    net_j, _ = request.getfixturevalue(scene)
    rng = np.random.RandomState(1)
    for tj, tt in zip(*_templates(net_j)):
        _same_template(tj, tt)
        tj, tt = tj.dense_boundary(2), tt.dense_boundary(2)
        _same_template(tj, tt)
        fj, ft = tj.extract_featurelines(), tt.extract_featurelines()
        assert list(fj) == list(ft) and len(fj) >= 2
        for k in fj:
            np.testing.assert_array_equal(fj[k], ft[k])
        for a, b in zip(tj.close_hole(), tt.close_hole()):
            np.testing.assert_array_equal(a, b)
        cv, cf, _ = tt.close_hole()
        for a, b in zip(jsample(cv, cf, 8192, seed=1), sample_mesh_surface(cv, cf, 8192, seed=1)):
            np.testing.assert_array_equal(a, b)
        moved = {k: v * 1.1 + rng.uniform(-0.02, 0.02, 3).astype(np.float32)
                 for k, v in ft.items()}
        for a, b in zip(jmatch(tj.verts, tj.boundary_labels, moved),
                        match_template_boundaries(tt.verts, tt.boundary_labels, moved)):
            assert len(a) > 0
            np.testing.assert_array_equal(a, b)
        np.testing.assert_array_equal(jextract(tj.verts, tj.faces, 50),
                                      extract_curve_from_patch(tt.verts, tt.faces, 50))


def test_template_assets_match_jax(tube, tmp_path):
    """A colour-coded asset directory (``tests/test_templates.py``'s layout)
    read by both packages, and the templates built from it."""
    from recmv_tpu.config.constants import GARMENT_COLOR_MAP
    from recmv_tpu.models.garment import load_template_assets as jload
    from recmv_tpu_torch.models.garment import load_template_assets
    from test_templates import _write_colored_obj

    net_j, _ = tube
    tj, _ = _templates(net_j)
    _write_colored_obj(str(tmp_path / "tube.obj"), tj[0], GARMENT_COLOR_MAP["tube"])
    a, b = jload(str(tmp_path), "tube"), load_template_assets(str(tmp_path), "tube")
    _same_template(a, b)
    assert set(b.boundary_labels) == {"neck", "bottom_curve"}
    assert load_template_assets(str(tmp_path / "none"), "tube") is None
    for x, y in zip(*_templates(net_j, str(tmp_path))):
        _same_template(x, y)
        _same_template(x, a)


# ---------------------------------------------------------------------------
# (b) Laplacian editing, (c) the IGR loss
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("cg", [False, True], ids=["dense", "cg"])
@pytest.mark.parametrize("smooth", [False, True])
@pytest.mark.parametrize("displacement", [False, True])
def test_laplacian_deform_matches_jax(monkeypatch, cg, smooth, displacement):
    """On ``tests/test_geometry.py``'s open cylinder, the top ring pulled
    out and the bottom held; CG through a monkeypatched
    ``DENSE_SOLVE_MAX_N`` in both packages."""
    from recmv_tpu.geometry import laplacian as J
    from recmv_tpu_torch.geometry import laplacian as T
    from test_geometry import open_cylinder

    v, f = open_cylinder(24, 12)
    top, bottom = np.arange(len(v) - 24, len(v)), np.arange(24)
    cid = np.concatenate([top, bottom])
    ct = np.concatenate([v[top] * [1.3, 1.0, 1.3], v[bottom]])
    if cg:
        monkeypatch.setattr(J, "DENSE_SOLVE_MAX_N", 1)
        monkeypatch.setattr(T, "DENSE_SOLVE_MAX_N", 1)
    kw = dict(constrain_weight=5.0, smooth=smooth, displacement=displacement)
    want = np.asarray(J.laplacian_deform(v, f, cid, ct, **kw))
    got = T.laplacian_deform(v, f, cid, ct, device="cpu", **kw)
    assert got.dtype == torch.float32 and got.shape == want.shape
    np.testing.assert_allclose(got.numpy(), want, atol=2e-5, rtol=0)
    if not smooth:
        np.testing.assert_allclose(got.numpy()[cid], ct, atol=5e-2)


@pytest.mark.parametrize("with_normals", [False, True])
def test_igr_init_loss_matches_jax(with_normals):
    from recmv_tpu.core.losses import igr_init_loss as jloss
    from recmv_tpu_torch.core.losses import igr_init_loss

    rng = np.random.RandomState(2)
    vals, gs, go = rng.randn(50), rng.randn(50, 3), rng.randn(70, 3)
    nrm = rng.randn(50, 3) if with_normals else None
    args_j = [jnp.asarray(a, jnp.float32) for a in (vals, gs, go)]
    nrm_j = None if nrm is None else jnp.asarray(nrm, jnp.float32)
    (loss_j, aux_j), g_j = jax.value_and_grad(lambda *a: jloss(*a, nrm_j), argnums=(0, 1, 2),
                                              has_aux=True)(*args_j)
    args_t = [_t(a, True) for a in (vals, gs, go)]
    loss_t, aux_t = igr_init_loss(*args_t, None if nrm is None else _t(nrm))
    keys = {"manifold", "eikonal", "normals"} if with_normals else {"manifold", "eikonal"}
    assert set(aux_t) == set(aux_j) == keys
    for k in aux_j:
        np.testing.assert_allclose(float(aux_t[k].detach()), float(aux_j[k]), rtol=1e-6)
    np.testing.assert_allclose(float(loss_t.detach()), float(loss_j), rtol=1e-6)
    for a, b, x in zip(torch.autograd.grad(loss_t, args_t, allow_unused=True), g_j, args_t):
        a = torch.zeros_like(x) if a is None else a          # unused without normals
        np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=1e-5, rtol=1e-5)


# ---------------------------------------------------------------------------
# (d) the IGR fit
# ---------------------------------------------------------------------------

def _igr_draws(seed, V, bs, nb, epochs):
    """Replay ``igr_fit_sdf``'s key splits: per epoch the permutation, per
    minibatch the local normals and the global uniforms."""
    key = jax.random.PRNGKey(seed)
    draws = []
    for _ in range(epochs):
        key, ks = jax.random.split(key)
        d = dict(perm=torch.tensor(np.asarray(jax.random.permutation(ks, V))).long(),
                 local=[], glob=[])
        for _ in range(nb):
            key, ku = jax.random.split(key)
            k1, k2 = jax.random.split(ku)
            d["local"].append(_t(jax.random.normal(k1, (bs, 3))))
            d["glob"].append(_t(jax.random.uniform(k2, (bs // 6, 3), minval=-1.8, maxval=1.8)))
        draws.append(d)
    return draws


def test_igr_fit_sdf_matches_jax(tube, monkeypatch):
    """Three epochs of two minibatches on a narrow SDF (6×64, skip at 4, 8
    features; geometric init) fitted to 500 surface samples of the closed
    tube template with normals (the last 100 points fall outside the two
    full minibatches): the last loss, every parameter and the bias shift."""
    import dataclasses

    from recmv_tpu.models.sdf import init_sdf_net as jinit
    from recmv_tpu_torch.geometry.mesh_utils import sample_mesh_surface
    from recmv_tpu_torch.models.sdf import init_sdf_net

    net_j, net_t = tube
    dims = (64,) * 6
    p_j, static = jinit(jax.random.PRNGKey(4), dims=dims, feature_vector_size=8)
    sdf_t = init_sdf_net(torch.Generator().manual_seed(0), dims=dims, feature_vector_size=8)
    bridge.load_mlp(sdf_t, _np_tree(p_j))
    monkeypatch.setitem(net_j.params, "sdf", p_j)
    monkeypatch.setattr(net_j, "statics", dataclasses.replace(net_j.statics, sdf=static))
    monkeypatch.setitem(net_t.params, "sdf", sdf_t)
    tj, _ = _templates(net_j)
    cv, cf, _ = tj[0].dense_boundary(2).close_hole()
    pts, nrm = sample_mesh_surface(cv, cf, 500, seed=3)
    kw = dict(nepochs=3, batch_size=200, lr=5e-3)
    loss_j = net_j.igr_fit_sdf("sdf", pts, nrm, **kw)
    draws = _igr_draws(0, 500, 200, 2, 3)
    loss_t = net_t.igr_fit_sdf("sdf", pts, nrm, draws=draws, **kw)
    np.testing.assert_allclose(loss_t, loss_j, rtol=1e-4)
    lr = 5e-4                                     # the derated rate below 32 epochs
    before = _np_tree(p_j)
    got = bridge.export_mlp(net_t.params["sdf"])
    moved, worst = 0, 0.0
    for layer, leaves in _np_tree(net_j.params["sdf"]).items():
        for name, want in leaves.items():
            a = got[layer][name]
            big = np.abs(want - before[layer][name]) >= lr / 2
            np.testing.assert_allclose(a[big], want[big], atol=2e-2 * lr, rtol=0,
                                       err_msg=f"{layer}.{name}")
            rel = np.linalg.norm(a - want) / np.linalg.norm(want)
            assert rel <= 1e-5, (layer, name, rel)
            moved, worst = moved + int(big.sum()), max(worst, rel)
    print(f"IGR fit: {moved} entries moved by lr/2 or more; worst leaf error {worst:.2e} of "
          f"its norm; loss {loss_t:.6f} vs {loss_j:.6f}")
    assert moved > 10000
    # the bias shift alone moved the SDF output's bias by more than a step
    last = f"lin{len(before) - 1}"
    assert abs(got[last]["b"][0] - before[last]["b"][0]) > 10 * lr


# ---------------------------------------------------------------------------
# (e) the curve fit
# ---------------------------------------------------------------------------

def _template_curves(net_j):
    """The merged feature lines of the densified body templates."""
    tj, _ = _templates(net_j)
    curves = {}
    for t in tj:
        for name, c in t.dense_boundary(2).extract_featurelines().items():
            curves.setdefault(name, c)
    return curves


def _jax_gate(net_j, curves, fl_names):
    """The JAX package's frozen visibility gate, as its ``initialize_fl``
    builds it, as a function of the port's (T, s)."""
    from recmv_tpu.models.skinner import skinner_apply as jskin
    from recmv_tpu.ops.rasterizer import screen_with_cam_z as jscreen

    ds = net_j.dataset
    sup = [i for i, x in enumerate(ds.fl_supervised) if x]
    sup = sup[:: max(len(sup) // 16, 1)][:16] or [0]
    fids = jnp.asarray(sup, jnp.int32)
    scene = net_j.scene_tree()
    cam = net_j._camera(scene)
    zbuf, _ = net_j._body_zbuf_image(net_j._global_params(), scene, fids, cam)
    c0 = jnp.asarray(np.stack([curves[n] for n in fl_names]))
    centers = c0.mean(1, keepdims=True)
    C, S, _ = c0.shape
    N = len(sup)

    def gate(T, s):
        T, s = jnp.asarray(T.numpy()), jnp.asarray(s.numpy())
        flat = ((c0 - centers) * s[:, None, None] + centers + T[:, None, :]).reshape(1, -1, 3)
        posed = jskin(net_j.params["skinner"], jnp.broadcast_to(flat, (N, C * S, 3)),
                      scene["poses"][fids], scene["trans"][fids])
        scr = jscreen(cam, posed)
        return torch.tensor(np.asarray((scr[..., 2] - net_j._sample_zbuf(zbuf, scr)) < 0.01))

    return gate


def _rescue_curves(net_j):
    """The two-garment scene's template curves with the skirt hem shrunk
    to half its radius about its centre: its silhouette is then half the
    gt arc's width, and the extent rescue fires on it alone."""
    curves = dict(_template_curves(net_j))
    c = curves["bottom_curve"]
    centre = c.mean(0, keepdims=True)
    curves["bottom_curve"] = ((c - centre) * np.float32([0.5, 1.0, 0.5]) + centre).astype(
        np.float32)
    return curves


@pytest.fixture(scope="module")
def fl_fits(tube, two):
    """The JAX ``initialize_fl`` (6 joint iterations) once per case: the
    tube scene's template curves, and the two-garment scene's with the
    shrunk skirt hem (``_rescue_curves``)."""
    cases = {"tube": (tube, _template_curves(tube[0])), "rescue": (two, _rescue_curves(two[0]))}
    return {k: (pair, curves, pair[0].initialize_fl(curves, n_iters=6))
            for k, (pair, curves) in cases.items()}


@pytest.mark.parametrize("case, gated", [("tube", True), ("rescue", True), ("tube", False),
                                         ("rescue", False)],
                         ids=["tube-jax-gate", "rescue-jax-gate", "tube-port-gate",
                              "rescue-port-gate"])
def test_initialize_fl_matches_jax(fl_fits, case, gated, tmp_path):
    """The fitted T and s of each curve, the aligned curves and the names
    after 6 joint iterations (so 10 scale-only ones, and 10 of the rescued
    curves' T-only warm-up); in the rescue case only the skirt hem is
    rescued, and its scale leaves the prior upward. With the JAX gate
    injected the fits agree tightly; end to end the port's gate is its own
    z-buffer (module docstring). The npz cache the port writes holds its
    T and s, and a second call reads it back."""
    from recmv_tpu_torch.config.constants import INI_FL_SCALE

    (net_j, net_t), curves, (rigid_j, aligned_j, names_j) = fl_fits[case]
    gate = _jax_gate(net_j, curves, names_j) if gated else None
    cache = str(tmp_path / "fl_init" / "init_trans_matrix.npz")
    rigid_t, aligned_t, names_t = net_t.initialize_fl(curves, n_iters=6, cache_path=cache,
                                                      gate=gate)
    assert names_t == names_j
    assert net_t.fl_rescued == (["bottom_curve"] if case == "rescue" else [])
    tol = 1e-5 if gated else 2e-3
    for n in names_j:
        np.testing.assert_allclose(rigid_t[n][0], np.asarray(rigid_j[n][0]), atol=tol, err_msg=n)
        np.testing.assert_allclose(rigid_t[n][1], np.asarray(rigid_j[n][1]), atol=tol, err_msg=n)
        np.testing.assert_allclose(aligned_t[n], aligned_j[n], atol=4 * tol, err_msg=n)
    if case == "rescue":
        assert float(rigid_j["bottom_curve"][1]) > 1.3 * INI_FL_SCALE["bottom_curve"]
    data = np.load(cache)
    np.testing.assert_array_equal(data["s"], np.stack([rigid_t[n][1] for n in names_t]))
    again = net_t.initialize_fl(curves, n_iters=6, cache_path=cache, gate=gate)
    for n in names_t:
        np.testing.assert_array_equal(again[1][n], aligned_t[n])


def test_nanmedian_averages_the_middle_pair():
    """``jnp.nanmedian`` of an even count is the mean of the two middle
    values; ``torch.nanmedian`` would give the lower one."""
    from recmv_tpu_torch.core.network import _nanmedian

    x = np.asarray([[1.0, 4.0, np.nan, 2.0, 8.0],           # even count
                    [3.0, np.nan, 1.0, 2.0, np.nan],         # odd count
                    [np.nan] * 5], np.float32)                # none
    got = _nanmedian(torch.as_tensor(x), dim=1).numpy()
    want = np.asarray(jnp.nanmedian(jnp.asarray(x), axis=1, keepdims=True))
    np.testing.assert_array_equal(got, want)
    assert got[0, 0] == 3.0 and float(torch.nanmedian(torch.as_tensor(x[0]))) == 2.0


# ---------------------------------------------------------------------------
# (f) the whole initialization, (g) the clip boxes
# ---------------------------------------------------------------------------

WHOLE_EPOCHS = 4
FIT_MC_ATOL = 1e-4
FIT_MC_NN = 0.05


def _fit_points(templates, body_vs, sample):
    """The point set of each IGR fit of ``initialize_tmp_sdf``: the body's
    vertices, then each garment's surface samples of its registered,
    closed template (``sample`` is a package's ``sample_mesh_surface``)
    → (points, the garments' sample normals)."""
    pts, nrm = [np.asarray(body_vs)], []
    for gi, t in enumerate(templates):
        cv, cf, _ = t.close_hole()
        p, n = sample(cv, cf, max(len(cv), 8192), seed=gi)
        pts.append(np.asarray(p))
        nrm.append(np.asarray(n))
    return pts, nrm


@pytest.fixture(scope="module")
def whole(fl_fits, tmp_path_factory):
    """The tube scene's whole initialization in each package,
    ``initialize_tmp_sdf(nepochs=4, fl_iters=2)`` with nothing stubbed, both
    reading the JAX curve fit of ``fl_fits`` from an
    ``init_trans_matrix.npz`` written as the JAX package writes it (the
    fit itself is held end to end by (e)); the port replays the JAX IGR
    draws (``igr_draws``). Kept: the SDFs before and after, each
    package's fit points, the port's garment fit rerun on the JAX
    garment points from the JAX starting state, the first
    ``marching_cube_update`` of each, and the port's on the JAX garment
    SDF. The JAX SDFs and both meshes are then put back (the later tests
    start from the geometric init)."""
    import copy

    from recmv_tpu.geometry.mesh_utils import sample_mesh_surface as jsample
    from recmv_tpu_torch.geometry.mesh_utils import sample_mesh_surface

    (net_j, net_t), _, (rigid, _, names) = fl_fits["tube"]
    root = tmp_path_factory.mktemp("initialized")
    for pkg in ("jax", "port"):
        os.makedirs(root / pkg / "fl_init")
        np.savez(str(root / pkg / "fl_init" / "init_trans_matrix.npz"),
                 T=np.stack([np.asarray(rigid[n][0]) for n in names]),
                 s=np.stack([np.asarray(rigid[n][1]) for n in names]))
    kept = ((net_j.params["sdf"], net_j.params["garment_sdfs"]), net_j.mesh, net_t.mesh)
    out = dict(net_j=net_j, net_t=net_t, root=root,
               before_j=[net_j.params["sdf"], *net_j.params["garment_sdfs"]],
               before_t=copy.deepcopy([net_t.params["sdf"], *net_t.params["garment_sdfs"]]))
    net_j.initialize_tmp_sdf(nepochs=WHOLE_EPOCHS, save_dir=str(root / "jax"), fl_iters=2)
    out["pts_j"], nrm_j = _fit_points(net_j.garment_templates, net_j.tmp_body_vs, jsample)
    draws = [_igr_draws(0, len(p), min(5000, len(p)), max(len(p) // 5000, 1), WHOLE_EPOCHS)
             for p in out["pts_j"]]
    net_t.initialize_tmp_sdf(nepochs=WHOLE_EPOCHS, save_dir=str(root / "port"), fl_iters=2,
                             igr_draws=draws)
    out["pts_t"] = _fit_points(net_t.garment_templates, net_t.tmp_body_vs.numpy(),
                               sample_mesh_surface)[0]
    out["after_j"] = [net_j.params["sdf"], *net_j.params["garment_sdfs"]]
    out["after_t"] = copy.deepcopy([net_t.params["sdf"], *net_t.params["garment_sdfs"]])
    own = bridge.export_params(net_t.params)["garment_sdfs"]
    bridge.load_mlp(net_t.params["garment_sdfs"][0], _np_tree(out["before_j"][1]))
    net_t.igr_fit_sdf(("garment", 0), out["pts_j"][1], nrm_j[0], WHOLE_EPOCHS, draws=draws[1])
    out["garment_on_jax_pts"] = copy.deepcopy(net_t.params["garment_sdfs"][0])
    bridge.load_mlp(net_t.params["garment_sdfs"][0], own[0])
    for net in (net_j, net_t):
        net.mesh = None
        net.marching_cube_update(RATIO)
    out["mesh_j"], out["mesh_t"] = net_j.mesh, net_t.mesh
    own = bridge.export_params(net_t.params)["garment_sdfs"]
    for mod, tree in zip(net_t.params["garment_sdfs"], _np_tree(net_j.params["garment_sdfs"])):
        bridge.load_mlp(mod, tree)
    net_t.mesh = None
    net_t.marching_cube_update(RATIO)
    out["mesh_t_on_jax"] = net_t.mesh
    for mod, tree in zip(net_t.params["garment_sdfs"], own):
        bridge.load_mlp(mod, tree)
    net_j.params["sdf"], net_j.params["garment_sdfs"] = kept[0]
    net_j.mesh, net_t.mesh = kept[1:]
    return out


@pytest.fixture(scope="module")
def initialized(whole):
    """(f) ``whole``'s networks and root."""
    return whole["net_j"], whole["net_t"], whole["root"]


def test_initialize_tmp_sdf_matches_jax(initialized):
    net_j, net_t, root = initialized
    assert [t.name for t in net_t.garment_templates] == ["tube"]
    for a, b in zip(net_j.garment_templates, net_t.garment_templates):
        assert b.verts.dtype == np.float32
        np.testing.assert_allclose(b.verts, a.verts, atol=2e-4)
        np.testing.assert_array_equal(b.faces, a.faces)
        for k in a.boundary_labels:
            np.testing.assert_array_equal(b.boundary_labels[k], a.boundary_labels[k])
    cs_j, cs_t = net_j.curve_statics, net_t.curve_statics
    assert cs_t.fl_names == cs_j.fl_names == ("neck", "bottom_curve")
    for k in bridge.CURVE_FIELDS:
        np.testing.assert_allclose(getattr(cs_t, k).numpy(), np.asarray(getattr(cs_j, k)),
                                   atol=1e-5, err_msg=k)
    for k in ("scale", "nx_scale"):
        np.testing.assert_array_equal(net_t.params["curves"][k].detach().numpy(),
                                      np.asarray(net_j.params["curves"][k]))
    assert len(net_t.garment_extract_bboxes) == 1
    for a, b in zip(net_j.garment_extract_bboxes, net_t.garment_extract_bboxes):
        for x, y in zip(a, b):
            assert y.dtype == np.float32
            np.testing.assert_allclose(y, x, atol=2e-4)
    assert (root / "port" / "initial_sdf.ckpt").is_file()
    times = net_t.init_times
    assert list(times) == ["templates", "initialize_fl", "laplacian", "igr body", "igr tube"]
    assert times["igr tube"]["epochs"] == 4 and times["igr tube"]["points"] >= 8192
    assert all(np.isfinite(times[k]["loss"]) for k in ("igr body", "igr tube"))


def test_initialized_surface_lies_in_its_clip_box(initialized):
    """After the port's own 4-epoch IGR fits the body and the garment have
    a surface, and the garment's lies inside its clip box."""
    _, net_t, _ = initialized
    meshes = net_t.discretize_sdf(RATIO)
    assert len(meshes[0][0]) > 50 and len(meshes[1][0]) > 20
    bmin, bmax = net_t.garment_extract_bboxes[0]
    v = meshes[1][0].numpy()
    assert (v >= bmin - 1e-5).all() and (v <= bmax + 1e-5).all()


def test_discretize_sdf_clip_box_matches_jax(tube):
    """The seg3d pyramid + marching cubes of each package on the JAX
    parameters, with no boxes and with a box that cuts the garment's
    geometric-init sphere: the same vertex counts and vertices; the box
    removes surface and keeps the rest inside it."""
    from scipy.spatial import cKDTree

    net_j, net_t = tube
    bridge.load_jax_params(net_t.params, _np_tree(
        {k: net_j.params[k] for k in ("sdf", "garment_sdfs", "translator", "render",
                                      "skinner")}))
    lo, hi = np.asarray([-0.3, -0.2, -0.25], np.float32), np.asarray([0.3, 0.35, 0.25],
                                                                     np.float32)
    counts = []
    for box in (None, [(lo, hi)]):
        net_j.garment_extract_bboxes = net_t.garment_extract_bboxes = box
        got = [(v.numpy(), f.numpy()) for v, f in net_t.discretize_sdf(RATIO)]
        want = net_j.discretize_sdf(RATIO)
        for (v, f), (vj, fj, nv, nf) in zip(got, want):
            assert len(v) == nv > 20 and len(f) == nf
            vj = np.asarray(vj)
            vj = (vj if vj.shape[-1] == 3 else vj.T)[:nv]
            assert cKDTree(vj).query(v)[0].max() <= 1e-5
            assert cKDTree(v).query(vj)[0].max() <= 1e-5
        counts.append(len(got[1][0]))
    v = got[1][0]
    assert (v >= lo - 1e-5).all() and (v <= hi + 1e-5).all()
    assert counts[1] < counts[0], counts


@pytest.mark.parametrize("higher", [False, True])
@pytest.mark.parametrize("scene", ["tube", "two"])
def test_marching_cube_update_matches_jax_in_order(request, scene, higher):
    """(g) The remesh of each package on the JAX parameters, with no clip
    boxes: the port's ``marching_cube_update`` (seg3d and marching cubes on
    the device) gives the JAX ``marching_cube_update``'s body count, its
    garment vertices in order and its faces exactly; with ``higher`` (the
    host marching cubes) it does the same against the JAX
    ``marching_cube_update_host``. Vertices within ``MC_ATOL``, the
    existing clip-box test's 1e-5: the two seg3d volumes differ in the
    last bits of the SDF's evaluation, which moves an interpolated vertex
    along its edge (measured 3.8e-6 on the tube at the device path)."""
    net_j, net_t = request.getfixturevalue(scene)
    saved = [(n, n.mesh, getattr(n, "garment_extract_bboxes", None)) for n in (net_j, net_t)]
    try:
        for net in (net_j, net_t):
            net.mesh, net.garment_extract_bboxes = None, None
        (net_j.marching_cube_update_host if higher else net_j.marching_cube_update)(RATIO)
        net_t.marching_cube_update(RATIO, higher=higher)
        mj, mt = net_j.mesh, net_t.mesh
        assert mt.body_n == mj.body_n > 50
        assert mt.garment_n == mj.garment_n and mt.garment_fn == mj.garment_fn
        assert min(mt.garment_n) > 20
        for v, f, vj, fj, n, nf in zip(mt.garment_vs, mt.garment_fs, mj.garment_vs,
                                       mj.garment_fs, mj.garment_n, mj.garment_fn):
            np.testing.assert_array_equal(f[:nf].numpy(), np.asarray(fj)[:nf])
            np.testing.assert_allclose(v[:n].detach().numpy(), np.asarray(vj)[:n],
                                       atol=MC_ATOL, rtol=0)
    finally:
        for net, mesh, boxes in saved:
            net.mesh, net.garment_extract_bboxes = mesh, boxes


# ---------------------------------------------------------------------------
# (h) the whole initialization, IGR fits included
# ---------------------------------------------------------------------------

def _shift(sdf_of, pts):
    """``igr_fit_sdf``'s shift of the SDF output bias: minus the mean SDF
    over the first 4,096 points."""
    return -float(np.mean(sdf_of(np.asarray(pts[:4096], np.float32))))


def _shifts(whole, i, pts):
    """Fit ``i``'s bias shift on ``pts`` from each package's SDF before the
    fit → (JAX, port)."""
    from recmv_tpu.models.sdf import sdf_value as jsdf
    from recmv_tpu_torch.models.sdf import sdf_value

    net_j = whole["net_j"]
    static = net_j.statics.sdf if i == 0 else net_j.statics.garment_sdf
    with torch.no_grad():
        return (_shift(lambda p: jsdf(whole["before_j"][i], static, jnp.asarray(p), -1.0), pts),
                _shift(lambda p: sdf_value(whole["before_t"][i], torch.tensor(p), -1.0).numpy(),
                       pts))


def _leaf_errors(whole, i, fitted=None):
    """Fit ``i``'s SDF in the port (``fitted``, default the port's fit in
    its own initialization) against the JAX fit → (|difference| on the
    entries whose JAX update is at least lr/2, the largest of a leaf's
    ‖difference‖ / ‖leaf‖)."""
    lr = 5e-4                                     # the derated rate below 32 epochs
    before, want = _np_tree(whole["before_j"][i]), _np_tree(whole["after_j"][i])
    got = bridge.export_mlp(whole["after_t"][i] if fitted is None else fitted)
    moved, worst = [], 0.0
    for layer, leaves in want.items():
        for name, w in leaves.items():
            a = got[layer][name]
            big = np.abs(w - before[layer][name]) >= lr / 2
            moved.append(np.abs(a[big] - w[big]))
            worst = max(worst, float(np.linalg.norm(a - w) / np.linalg.norm(w)))
    return np.concatenate(moved), worst


def test_whole_initialization_body_fit_matches_jax(whole):
    """(h) The body's IGR fit within the whole initialization: the same
    points, the same bias shift, and every SDF leaf as the JAX fit's."""
    pj, pt = whole["pts_j"][0], whole["pts_t"][0]
    np.testing.assert_array_equal(pt, pj)
    shift_j, shift_t = _shifts(whole, 0, pj)
    np.testing.assert_allclose(shift_t, shift_j, atol=1e-6)
    assert abs(shift_j) > 1e-2
    moved, worst = _leaf_errors(whole, 0)
    print(f"body fit: moved entries within {moved.max():.2e}, worst leaf {worst:.2e} of its "
          "norm")
    assert moved.size > 10 ** 6
    assert moved.max() <= 1e-4 and worst <= 1e-4, (moved.max(), worst)


def test_whole_initialization_garment_fit_matches_jax(whole):
    """(h) The garment's IGR fit within the whole initialization. Its
    points are area-weighted samples of the registered template, and the
    two templates differ by the Laplacian solve's rounding (≤ 2e-4, (f)):
    that moves the sampler's face CDF, so some samples land on another
    face. The port's sampler on the JAX template gives the JAX points
    exactly, and the port's fit on those points, from the JAX starting
    state with the JAX draws, is the JAX fit (every leaf and the moved
    entries, module docstring). On its own points, most points agree and
    the rest lie on the same surface; the bias shift on the same points
    agrees, on each package's own it differs by the flipped samples'
    share; the fitted SDF then differs by what the flipped samples pull,
    far less than the fit moves it (module docstring)."""
    from recmv_tpu_torch.geometry.mesh_utils import sample_mesh_surface

    net_j = whole["net_j"]
    pj, pt = whole["pts_j"][1], whole["pts_t"][1]
    cv, cf, _ = net_j.garment_templates[0].close_hole()
    np.testing.assert_array_equal(sample_mesh_surface(cv, cf, len(pj), seed=0)[0], pj)
    moved, worst = _leaf_errors(whole, 1, whole["garment_on_jax_pts"])
    print(f"garment fit on the JAX points: {(moved > 2e-5).sum()} of {moved.size} moved entries "
          f"beyond 2e-5, the most {moved.max():.2e}; worst leaf {worst:.2e} of its norm")
    assert moved.size > 10 ** 6 and worst <= 1e-4, worst
    assert (moved > 2e-5).sum() <= 10 and moved.max() <= 2 * 5e-4 * WHOLE_EPOCHS, moved.max()
    same = np.abs(pt - pj).max(1) <= 2e-4
    assert same.mean() >= 0.8, same.mean()
    shift_j, shift_t = _shifts(whole, 1, pj)
    np.testing.assert_allclose(shift_t, shift_j, atol=1e-6)
    own_j, own_t = shift_j, _shifts(whole, 1, pt)[1]
    np.testing.assert_allclose(own_t, own_j, atol=2e-4)
    moved, worst = _leaf_errors(whole, 1)
    before, after = _np_tree(whole["before_j"][1]), _np_tree(whole["after_j"][1])
    got = bridge.export_mlp(whole["after_t"][1])

    def worst_of(tree, names):
        return max(float(np.linalg.norm(tree[layer][n] - w) / np.linalg.norm(w))
                   for layer, leaves in after.items() for n, w in leaves.items() if n in names)

    own_w, noop_w, noop = worst_of(got, "gv"), worst_of(before, "gv"), worst_of(before, "bgv")
    print(f"garment fit on its own points: worst leaf {worst:.4f} of its norm (no fit: "
          f"{noop:.4f}), worst weight leaf {own_w:.5f} (no fit: {noop_w:.5f})")
    assert moved.size > 10 ** 6
    assert worst <= 0.1, worst
    assert own_w <= noop_w / 10, (own_w, noop_w)


def test_whole_initialization_first_remesh_matches_jax(whole):
    """(h) The first ``marching_cube_update`` after the whole
    initialization: the body's vertex count and the garment's vertex and
    face counts of the port equal the JAX package's. On the JAX garment
    SDF the port's garment mesh is the JAX mesh, vertices in order within
    ``FIT_MC_ATOL``; on its own SDF the vertices lie within ``FIT_MC_NN``
    of the JAX mesh's (module docstring)."""
    from scipy.spatial import cKDTree

    mj, mt, mo = whole["mesh_j"], whole["mesh_t"], whole["mesh_t_on_jax"]
    assert mt.body_n == mo.body_n == mj.body_n > 50
    assert mt.garment_n == mo.garment_n == mj.garment_n and min(mj.garment_n) > 20
    assert mt.garment_fn == mo.garment_fn == mj.garment_fn
    for gi, (n, nf) in enumerate(zip(mj.garment_n, mj.garment_fn)):
        vj, fj = np.asarray(mj.garment_vs[gi])[:n], np.asarray(mj.garment_fs[gi])[:nf]
        np.testing.assert_array_equal(mo.garment_fs[gi][:nf].numpy(), fj)
        np.testing.assert_allclose(mo.garment_vs[gi][:n].detach().numpy(), vj,
                                   atol=FIT_MC_ATOL, rtol=0)
        vt = mt.garment_vs[gi][:n].detach().numpy()
        assert cKDTree(vj).query(vt)[0].max() <= FIT_MC_NN
        assert cKDTree(vt).query(vj)[0].max() <= FIT_MC_NN


# ---------------------------------------------------------------------------
# (i) a step on the JAX package's initialized state
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def on_jax_init(whole):
    """Both networks on the JAX ``initial_sdf.ckpt`` of ``whole``, read by
    each package's ``load_checkpoint``, remeshed, the port then on the JAX
    mesh. The later tests leave them there: run last."""
    net_j, net_t, root = whole["net_j"], whole["net_t"], whole["root"]
    ckpt = str(root / "jax" / "initial_sdf.ckpt")
    net_j.load_checkpoint(ckpt)
    net_t.load_checkpoint(ckpt)
    for net in (net_j, net_t):
        net.mesh = None
        net.marching_cube_update(RATIO)
    assert net_t.mesh.garment_n == net_j.mesh.garment_n
    bridge.load_mesh(net_t, net_j.mesh.garment_vs, net_j.mesh.garment_fs,
                     net_j.mesh.garment_n, net_j.mesh.garment_fn)
    return net_j, net_t


def _solves(net_j, net_t, fids):
    """Each package's ray seeding and surface solve on ``fids`` with the key
    KEY (the JAX ``rays`` phase, the port's with its uniforms replayed) →
    (JAX solved, port solved) of the first garment, numpy."""
    from recmv_tpu.models.camera import ang_threshold
    from test_torch_train import KEY, _seed_uniforms

    batch = net_j.dataset.get_batch(fids)
    vs_j, fs_j = tuple(net_j.mesh.garment_vs), tuple(net_j.mesh.garment_fs)
    fns = net_j._get_jitted(len(fids), tuple(v.shape[0] for v in vs_j)
                            + tuple(f.shape[0] for f in fs_j))
    net_j.ang_thred = ang_threshold(net_j._camera(net_j.scene_tree()))
    solved_j, _ = fns["rays"](net_j._global_params(), jnp.asarray(fids, jnp.int32),
                              net_j.garment_masks_from_batch(batch),
                              net_j._ratio_dict(RATIO), jax.random.PRNGKey(KEY), vs_j, fs_j)
    fids_t = torch.tensor(fids)
    dev = net_t.device_batch(batch)
    uniforms, _ = _seed_uniforms(jax.random.PRNGKey(KEY), 1,
                                 len(fids) * (IMG // net_t.cfg.seed_downscale) ** 2)
    with torch.no_grad():
        rays = net_t.find_and_sample_rays(fids_t, [dev[k] for k in net_t._garment_mask_keys()],
                                          RATIO, net_t.mesh.garment_vs, net_t.mesh.garment_fs,
                                          uniforms=uniforms)
        solved_t = net_t.solve_surface_points(rays, fids_t, RATIO)
    return ({k: np.asarray(v) for k, v in solved_j[0].items()},
            {k: v.numpy() for k, v in solved_t[0].items()})


@pytest.mark.parametrize("fids", [[0, 1], [0, 2]], ids=["frames01", "frames02"])
def test_surface_solve_on_a_jax_initialized_checkpoint(on_jax_init, fids):
    """(i) The ray seeding and surface solve of each package on the JAX
    initialization, the JAX draws replayed (module docstring): the same
    seeds; rays converged in both end at the same point; a ray that
    converges in one package only ended there at a point that the other
    package's SDF also calls converged, i.e. the two Newton walks parted on
    rounding, not on the SDF or the test; such rays are few."""
    from recmv_tpu_torch.core.surface_ps import DTHRESHOLD
    from recmv_tpu_torch.models.sdf import sdf_value

    net_j, net_t = on_jax_init
    sj, st = _solves(net_j, net_t, fids)
    for k in ("batch_inds", "rows", "cols", "valid"):
        np.testing.assert_array_equal(st[k], sj[k], err_msg=k)
    np.testing.assert_allclose(st["init_pts"], sj["init_pts"], atol=1e-5)
    cj, ct, live = sj["conv"], st["conv"], int(sj["valid"].sum())
    both = cj & ct
    assert both.sum() >= 5
    np.testing.assert_allclose(st["pts"][both], sj["pts"][both], atol=1e-4)
    parted = np.nonzero(cj != ct)[0]
    print(f"frames {fids}: converged JAX {int(cj.sum())}, port {int(ct.sum())} of {live} "
          f"live rays; parted {parted.tolist()}")
    assert len(parted) <= 0.15 * live
    with torch.no_grad():
        for i in parted:
            p = torch.tensor((sj["pts"] if cj[i] else st["pts"])[i][None])
            sdf = abs(float(sdf_value(net_t.params["garment_sdfs"][0], p, 1.0)))
            assert sdf < DTHRESHOLD + 1e-6, (i, sdf)


def test_step_on_a_jax_initialized_checkpoint_converges_as_jax(on_jax_init, monkeypatch):
    """(i) One training step in each package on the JAX initialization,
    frames (0, 1): the JAX step with key KEY, run phase by phase
    (``_fused_ok`` off: the package's own fallback to the fused step) so
    that its ``rays`` phase's solve can be read, and the port's step with
    its draws replayed. Inside the port's step its own solve is held
    against the JAX step's ray by ray as the solve tests hold it (the same
    seeds; the rays converged in both at the same point; a ray that parts
    ended at a point the port's SDF calls converged; at most 15% part);
    then each parted ray takes the JAX end point and flag, so that the
    rest of the step runs on the JAX step's solve on any machine. So each
    ``{g}_rayConv`` equals the JAX step's, and every info scalar is held
    as ``test_torch_train`` holds it. The pc-sdf weight is 0 as in
    ``test_torch_train`` (the bf16 term, 60× in ``m_loss_total``, is held
    on its own there); its bf16 value, ~7.4e-3 here where the helper's
    5e-6 is set for ~2e-3, is held to the same relative 2.5e-3 (measured
    7.1e-4)."""
    from recmv_tpu_torch.core.surface_ps import DTHRESHOLD
    from recmv_tpu_torch.models.sdf import sdf_value
    from test_torch_train import (KEY, _assert_info_close, _main_draws, _NoPcSdfConf,
                                  _seed_uniforms)

    net_j, net_t = on_jax_init
    fids = [0, 1]
    for net in (net_j, net_t):
        monkeypatch.setattr(net, "conf", _NoPcSdfConf(net.conf))
    solved_j, held = {}, []
    solve_t = net_t.solve_surface_points
    monkeypatch.setattr(net_j, "_fused_ok", False)        # the step's phases one by one
    fns = net_j._get_jitted(len(fids), tuple(v.shape[0] for v in net_j.mesh.garment_vs)
                            + tuple(f.shape[0] for f in net_j.mesh.garment_fs))
    rays_j = fns["rays"]

    def jax_rays(*args):
        out = rays_j(*args)
        solved_j["solved"] = jax.tree_util.tree_map(np.asarray, out[0])
        return out

    def port_solve(ray_data, frame_ids, ratio):
        out = solve_t(ray_data, frame_ids, ratio)
        for gi, (st, sj) in enumerate(zip(out, solved_j["solved"])):
            for k in ("batch_inds", "rows", "cols", "valid"):
                np.testing.assert_array_equal(st[k].numpy(), sj[k], err_msg=k)
            np.testing.assert_allclose(st["init_pts"].numpy(), sj["init_pts"], atol=1e-5)
            cj, ct = torch.tensor(sj["conv"]), st["conv"]
            both = (cj & ct).numpy()
            np.testing.assert_allclose(st["pts"].numpy()[both], sj["pts"][both], atol=1e-4)
            parted = cj != ct
            ends = torch.where(cj[:, None], torch.tensor(sj["pts"]), st["pts"])[parted]
            sdf = sdf_value(net_t.params["garment_sdfs"][gi], ends, ratio["sdfRatio"])
            held.append((int(cj.sum()), int(ct.sum()), int(sj["valid"].sum()),
                         int(parted.sum()), float(sdf.abs().max()) if len(ends) else 0.0))
            st["conv"] = torch.where(parted, cj, ct)
            st["pts"] = torch.where(parted[:, None], torch.tensor(sj["pts"]), st["pts"])
        return out

    monkeypatch.setitem(fns, "rays", jax_rays)
    monkeypatch.setattr(net_t, "solve_surface_points", port_solve)
    batch = net_j.dataset.get_batch(fids)
    G = len(net_j.statics.garment_names)
    key = jax.random.PRNGKey(KEY)
    uniforms, key_m = _seed_uniforms(key, G, len(fids) * (IMG // net_t.cfg.seed_downscale) ** 2)
    budget = max(net_t.cfg.sample_pix // G, 1) * len(fids)
    draws = {"uniforms": uniforms, "main": _main_draws(net_j, key_m, budget)}
    assert net_t._curve_aware_target() is None
    _, info_j = net_j.train_step(batch, fids, RATIO, key)
    _, info_t = net_t.train_step(batch, fids, RATIO, draws=draws)
    assert len(held) == G
    for g, (conv_j, conv_t, live, parted, sdf) in zip(net_j.statics.garment_names, held):
        print(f"{g}: converged JAX {conv_j}, port {conv_t} of {live} live rays; parted "
              f"{parted}, their ends' |sdf| ≤ {sdf:.3g}")
        assert conv_j >= 5 and parted <= 0.15 * live and sdf < DTHRESHOLD + 1e-6
        assert int(info_t[f"{g}_rayConv"]) == int(info_j[f"{g}_rayConv"]) == conv_j
    bf16 = {k for k in info_j if k.startswith("pc_") and k.endswith("_loss_sdf")}
    assert bf16
    for k in bf16:
        np.testing.assert_allclose(info_t[k], info_j[k], rtol=2.5e-3, atol=0, err_msg=k)
    _assert_info_close(info_t, {k: v for k, v in info_j.items() if k not in bf16})
