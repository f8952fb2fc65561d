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
    checkpoint; (g) ``discretize_sdf`` with and without the clip boxes.

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
  (``test_torch_slice``).
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

@pytest.fixture(scope="module")
def initialized(fl_fits, tmp_path_factory):
    """The tube scene's whole initialization in each package, both reading
    the JAX curve fit of ``fl_fits`` from an ``init_trans_matrix.npz``
    written as the JAX package writes it: the JAX ``initialize_tmp_sdf``
    with its IGR fits stubbed out (nothing compared depends on them), the
    port's whole ``initialize_tmp_sdf(nepochs=4, fl_iters=2)``."""
    (net_j, net_t), _, (rigid, _, names) = fl_fits["tube"]
    root = tmp_path_factory.mktemp("initialized")
    for pkg in ("jax", "port"):
        os.makedirs(root / pkg / "fl_init")
        np.savez(str(root / pkg / "fl_init" / "init_trans_matrix.npz"),
                 T=np.stack([np.asarray(rigid[n][0]) for n in names]),
                 s=np.stack([np.asarray(rigid[n][1]) for n in names]))
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(net_j, "igr_fit_sdf", lambda *a, **k: None)
        net_j.initialize_tmp_sdf(nepochs=4, save_dir=str(root / "jax"), fl_iters=2)
    net_t.initialize_tmp_sdf(nepochs=4, save_dir=str(root / "port"), fl_iters=2,
                             generator=torch.Generator().manual_seed(0))
    return net_j, net_t, root


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
