"""Parity of the port's ① curve branch with the JAX package, on the CPU.

Inputs are made with numpy from a seed. The curves of the synthetic tube
scene are its canonical boundary rings (``data/synthetic.boundary_ring``
at the ``SCENE_CURVES`` heights, resampled to 200 points), moved by a
seeded rigid (t, s) per curve and given to ``align_fl`` in both packages;
the later tests start both packages from the JAX package's curve state
(``bridge.load_curves``). The JAX mesh z-buffer runs its XLA backend on
the CPU, the port the plain version of K1 (the Pallas semantics; no bin
overflows at the tests' cap).

(a) ``grid_sample_2d``, the visibility functions (the z-buffer at
    downscale 1 and 4 with its background fill, the probe, the gates, the
    normal warp, the dispatch and its errors), the curve parameterization
    and ``InverseFlBody`` against their JAX counterparts; (b)
    ``align_fl``, and ``build_opt_net``'s body mesh on a skinner cache hit; (c)
    ``fl_branch_loss`` in each ``fl_visible_method`` on a 48 px
    synthetic-tube pair (the networks of ``test_torch_train``);
    (d) the curves' AdamW against ``optax.adamw``; (e) one whole
    ``train_step`` with ① and the curve-aware term (fired as the JAX code
    decides: a ``CURVE_AWARE`` garment type in the fine stage, target
    ``bottom_curve``) against the JAX fused step, with the JAX draws
    replayed; (f) ①'s gradient reaches the curve leaves alone.

Tolerances (float32) and why:
- (a): values 1e-5 absolute (1e-6 where the arithmetic is the same),
  gradients 1e-4. The two z-buffers differ in coverage only on pixels
  whose centre lies on a face edge (≤ 1e-3 of the covered pixels). The
  body's faces are sub-pixel at 48 px (median 0.08 px²), where the edge
  functions cancel: the port's K1, like the JAX Pallas kernel, folds
  1/area into the edge coefficients, the JAX XLA path divides after, and
  a sliver's depth moves by up to 1e-3 of itself (measured 1.04e-3 on
  one of 4,608 pixels, 158 beyond 1e-5; the Pallas kernel in interpret
  mode is as far from the XLA path). So depths within 3e-3 relative, and
  within 1e-4 on all but 1e-3 of the pixels;
- (c): loss and info within 1e-4 relative (measured 1.1e-6). Masks
  equal, except points whose gate value (z − surf_z against the
  threshold, or the posed normal's z against 0) lies within 1e-5 of its
  limit, which the test lists (none, in all five modes). Each curve
  leaf's gradient within 1e-2 of its norm: the chamfer's gradient passes
  the bf16 translator, where one flipped rounding moves the next layer
  by a whole bf16 step (``test_torch_train``'s docstring); measured
  4.7e-7 of the norm here, both packages rounding the same operands;
- (d): 5e-7 absolute: two float32 ulps at the leaves' magnitude (≤ 3),
  the same arithmetic in another order (measured 2.4e-7);
- (e): as ``test_torch_train``'s docstring (info 1e-4 relative, gradient
  norms 1e-3, the bf16 pc-sdf and curve-aware values 5e-6 absolute, Adam
  updates on stable-sign entries 2e-2 of lr, vertices 1e-3 of the update's
  norm; here the entries are chosen by the port's own gradient); the
  curves after AdamW likewise: entries whose JAX step is at least lr/2
  within 2e-2 of lr;
- (f): exact (the same operations on the same inputs);
- (g) with the port's own remesh: faces exact and vertices in order
  within ``MC_ATOL`` = 1e-5, as ``test_torch_init`` holds the remesh: the
  two seg3d volumes differ in the last bits of the SDF's evaluation,
  which moves a vertex along its edge (measured 3.8e-6).
"""

import copy
import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
import optax

from recmv_tpu_torch import bridge
from test_torch_train import (RATIO, _assert_info_close, _build_pair, _jax_leaf, _main_draws,
                              _np_tree, _seed_uniforms, _t)

FIDS = [1, 4]
MC_ATOL = 1e-5
KEY = 3
N_FRAMES = 6
IMG = 48


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    """One intra-op thread for the port's tiny tensors: the tests run beside
    other pytest workers, where each worker's default thread pool would
    oversubscribe the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _close(port, ref, atol, rtol=0.0, err_msg=""):
    got = port.detach().cpu().numpy() if torch.is_tensor(port) else np.asarray(port)
    np.testing.assert_allclose(got, np.asarray(ref), atol=atol, rtol=rtol, err_msg=err_msg)


# ---------------------------------------------------------------------------
# (a) sampling, visibility functions, curve parameterization
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("align_corners", [False, True])
def test_grid_sample_2d_matches_jax(align_corners):
    """Values and gradients (image and points) at probes inside, on the
    border of and outside the image (zero padding)."""
    from recmv_tpu.ops.grid_sample import grid_sample_2d as jgs
    from recmv_tpu_torch.ops.grid_sample import grid_sample_2d

    rng = np.random.RandomState(int(align_corners))
    img = rng.randn(3, 7, 9).astype(np.float32)
    pts = rng.uniform(-1.6, 1.6, (400, 2)).astype(np.float32)
    pts[:4] = [[-1, -1], [1, 1], [-1, 1], [1.0, -1.0]]
    w = rng.randn(400, 3).astype(np.float32)
    out_j, vjp = jax.vjp(lambda i, p: jgs(i, p, align_corners), jnp.asarray(img),
                         jnp.asarray(pts))
    gi_j, gp_j = vjp(jnp.asarray(w))
    i_t, p_t = _t(img, True), _t(pts, True)
    out = grid_sample_2d(i_t, p_t, align_corners)
    gi, gp = torch.autograd.grad((out * _t(w)).sum(), (i_t, p_t))
    outside = (np.abs(pts) > 1.0 + 2.0 / 6).any(1)           # every corner outside
    assert outside.sum() > 20 and not np.asarray(out_j)[outside].any()
    _close(out, out_j, 1e-6)
    _close(gi, gi_j, 1e-5)
    _close(gp, gp_j, 1e-4)


def _zbuf_inputs(pair):
    """The JAX body mesh of the fixture posed to the batch's frames, the
    camera of each package."""
    from recmv_tpu.models.skinner import skinner_apply as jskin

    net_j, net_t = pair["net_j"], pair["net_t"]
    scene = net_j.scene_tree()
    fids = jnp.asarray(FIDS)
    body = jnp.broadcast_to(net_j.tmp_body_vs, (len(FIDS),) + net_j.tmp_body_vs.shape)
    posed = np.asarray(jskin(net_j.params["skinner"], body, scene["poses"][fids],
                             scene["trans"][fids]))
    return posed, np.asarray(net_j.tmp_body_fs), net_j._camera(scene), net_t._camera()


@pytest.mark.parametrize("downscale", [1, 4])
def test_mesh_zbuf_image_matches_jax(pair, downscale):
    """The posed body's z-buffer, all frames in one call, with empty
    pixels filled by each frame's largest vertex depth."""
    from recmv_tpu.core.visibility import mesh_zbuf_image as jzb
    from recmv_tpu_torch.core.visibility import mesh_zbuf_image

    posed, faces, cam_j, cam_t = _zbuf_inputs(pair)
    net_j, net_t = pair["net_j"], pair["net_t"]        # the builders keep the body mesh
    np.testing.assert_array_equal(net_t.tmp_body_fs.numpy(), np.asarray(net_j.tmp_body_fs))
    _close(net_t.tmp_body_vs, net_j.tmp_body_vs, 1e-5)
    want = np.asarray(jzb(cam_j, jnp.asarray(posed), jnp.asarray(faces), (IMG, IMG), tile=16,
                          cap=4096, downscale=downscale))
    got = mesh_zbuf_image(cam_t, _t(posed), torch.as_tensor(faces), (IMG, IMG), tile=16,
                          cap=4096, downscale=downscale).numpy()
    hs = -(-IMG // downscale)
    assert got.shape == want.shape == (len(FIDS), hs, hs)
    for b in range(len(FIDS)):
        fill = want[b].max()
        assert fill == pytest.approx(got[b].max(), abs=1e-6)
        covered_j, covered_t = want[b] < fill, got[b] < fill
        assert covered_j.sum() > 0.1 * hs * hs and (~covered_j).sum() > 0.1 * hs * hs
        same = covered_j == covered_t
        assert (~same).sum() <= max(1, int(1e-3 * covered_j.sum()))
        err = np.abs(got[b] - want[b])[same]
        assert (err > 1e-4).sum() <= max(1, int(1e-3 * same.sum())), np.sort(err)[-5:]
        np.testing.assert_allclose(got[b][same], want[b][same], rtol=3e-3)


def test_visibility_functions_match_jax(pair):
    """``sample_zbuf`` on the body z-buffer at probes in and outside the
    image (outside reads 0), the depth and normal gates, the outward
    normals, the normal warp through a nonlinear map, and the dispatch
    with its two errors."""
    import recmv_tpu.core.visibility as JV
    import recmv_tpu_torch.core.visibility as TV

    posed, faces, cam_j, _ = _zbuf_inputs(pair)
    zb = np.asarray(JV.mesh_zbuf_image(cam_j, jnp.asarray(posed), jnp.asarray(faces),
                                       (IMG, IMG), tile=16, cap=4096, downscale=4))
    rng = np.random.RandomState(2)
    scr = np.concatenate([rng.uniform(-8, IMG + 8, (2, 300, 2)),
                          rng.uniform(2, 3, (2, 300, 1))], -1).astype(np.float32)
    surf_j = np.asarray(JV.sample_zbuf(jnp.asarray(zb), jnp.asarray(scr), (IMG, IMG)))
    surf_t = TV.sample_zbuf(_t(zb), _t(scr), (IMG, IMG))
    _close(surf_t, surf_j, 1e-6)
    out = (scr[..., :2] < -IMG / (IMG / 4 - 1)) | (scr[..., :2] > IMG + IMG / (IMG / 4 - 1))
    assert out.any(-1).sum() > 50 and not surf_j[out.any(-1)].any()
    vis_j = np.asarray(JV.zbuf_visible(jnp.asarray(scr[..., 2]), surf_j, 0.04))
    vis_t = TV.zbuf_visible(_t(scr[..., 2]), surf_t, 0.04)
    assert 0 < vis_j.sum() < vis_j.size
    np.testing.assert_array_equal(vis_t.numpy(), vis_j)

    ring = rng.randn(50, 3).astype(np.float32) * [0.3, 0.02, 0.2] + [0.1, 0.4, -0.05]
    _close(TV.outward_curve_normals(_t(ring)), JV.outward_curve_normals(jnp.asarray(ring)),
           1e-6)
    A = rng.randn(3, 3).astype(np.float32) * 0.3 + np.eye(3, dtype=np.float32)
    nrm = rng.randn(50, 3).astype(np.float32)
    posed_j = JV.warp_normals_to_posed(lambda p: p @ jnp.asarray(A).T + 0.2 * p ** 2,
                                       jnp.asarray(ring), jnp.asarray(nrm))
    posed_t = TV.warp_normals_to_posed(lambda p: p @ _t(A).T + 0.2 * p ** 2, _t(ring), _t(nrm))
    _close(posed_t, posed_j, 1e-5)
    assert not posed_t.requires_grad
    np.testing.assert_array_equal(TV.normal_visible(posed_t).numpy(),
                                  np.asarray(JV.normal_visible(posed_j)))

    b, g, n = (torch.as_tensor(rng.rand(2, 5) > 0.5) for _ in range(3))
    for m in TV.VISIBLE_METHODS:
        want = JV.combine_visibility(m, *(jnp.asarray(x.numpy()) for x in (b, g, n)))
        np.testing.assert_array_equal(TV.combine_visibility(m, b, g, n).numpy(),
                                      np.asarray(want))
    np.testing.assert_array_equal(TV.combine_visibility("zbuff_and", b, None, n).numpy(),
                                  b.numpy())
    for args in (("garment_zbuff", b, None, n), ("nope", b, g, n)):
        with pytest.raises(ValueError) as e_t:
            TV.combine_visibility(*args)
        with pytest.raises(ValueError) as e_j:
            JV.combine_visibility(*args)
        assert str(e_t.value) == str(e_j.value)


def test_curves_match_jax():
    """``init_curves`` statics, ``curves_forward`` and
    ``curves_regularization`` values and gradients at perturbed leaves
    (some scales below 0, where relu cuts), and ``InverseFlBody``."""
    from recmv_tpu.models import curves as JC
    from recmv_tpu.models.deformer import InverseFlBody as JInv
    from recmv_tpu_torch.models import curves as TC
    from recmv_tpu_torch.models.deformer import InverseFlBody

    rng = np.random.RandomState(4)
    ang = np.linspace(0, 2 * np.pi, 40, endpoint=False)
    rings = [np.stack([r * np.cos(ang), y + 0.01 * np.sin(3 * ang), r * np.sin(ang)], 1)
             .astype(np.float32) for r, y in ((0.2, 0.3), (0.35, -0.2))]
    t = [rng.randn(3).astype(np.float32) * 0.05 for _ in rings]
    s = [np.float32(1.1), np.float32(0.9)]
    inv_j, inv_t = JInv(["a", "b"], rings, t, s), InverseFlBody(["a", "b"], rings, t, s,
                                                                 device="cpu")
    moved = [(r - r.mean(0)) * si + r.mean(0) + ti for r, ti, si in zip(rings, t, s)]
    for a, b, r in zip(inv_t([_t(m) for m in moved], ["a", "b"]),
                       inv_j([jnp.asarray(m) for m in moved], ["a", "b"]), rings):
        _close(a, b, 1e-6)
        _close(a, r, 1e-5)

    p_j, s_j = JC.init_curves(moved, rings, ["a", "b"])
    p_t, s_t = TC.init_curves(moved, rings, ["a", "b"], device="cpu")
    for k in ("center", "v_dirs", "init_scale", "nx", "cano_smpl_verts"):
        _close(getattr(s_t, k), getattr(s_j, k), 1e-6, err_msg=k)
    assert s_t.fl_names == s_j.fl_names
    assert p_t["scale"].requires_grad and p_t["nx_scale"].requires_grad
    leaves = {"scale": 1.0 + 0.6 * rng.randn(2, 40, 1), "nx_scale": 0.02 * rng.randn(2, 40, 1)}
    leaves = {k: v.astype(np.float32) for k, v in leaves.items()}
    assert (leaves["scale"] < 0).any()
    w = rng.randn(2, 40, 3).astype(np.float32)
    masks = np.asarray([[True, False]])

    def jloss(prm):
        reg = JC.curves_regularization(prm, s_j, jnp.asarray(masks))
        v = JC.curves_forward(prm, s_j)
        return jnp.sum(v * w) + reg["diff_a_loss"] + reg["center_offset"], (v, reg)

    (_, (v_j, reg_j)), g_j = jax.value_and_grad(jloss, has_aux=True)(
        {k: jnp.asarray(v) for k, v in leaves.items()})
    prm = {k: _t(v, True) for k, v in leaves.items()}
    v_t = TC.curves_forward(prm, s_t)
    reg_t = TC.curves_regularization(prm, s_t, torch.as_tensor(masks))
    _close(v_t, v_j, 1e-6)
    _close(reg_t["diff_a_loss"], reg_j["diff_a_loss"], 1e-4, rtol=1e-5)
    assert float(reg_t["center_offset"]) == float(reg_j["center_offset"]) == 0.0
    loss = (v_t * _t(w)).sum() + reg_t["diff_a_loss"] + reg_t["center_offset"]
    for k, g in zip(prm, torch.autograd.grad(loss, list(prm.values()))):
        _close(g, g_j[k], 1e-4, rtol=1e-4, err_msg=k)


# ---------------------------------------------------------------------------
# the 48 px synthetic-tube pair with curves
# ---------------------------------------------------------------------------

def _scene_curves():
    """align_fl's inputs for the tube scene: each curve its canonical
    boundary ring resampled to 200 points (the template), moved by a seeded
    rigid (t, s) (the aligned curve)."""
    from recmv_tpu_torch.data.synthetic import SCENE_CURVES, boundary_ring
    from recmv_tpu_torch.geometry.polygons import uniform_sample_3d

    rng = np.random.RandomState(5)
    aligned, template, rigid = {}, {}, {}
    for name, y, off in SCENE_CURVES["synthetic-tube"]:
        ring = uniform_sample_3d(boundary_ring(y, offset=off), 200).astype(np.float32)
        t = rng.uniform(-0.02, 0.02, 3).astype(np.float32)
        s = np.float32(1.0 + rng.uniform(-0.1, 0.1))
        c = ring.mean(0, keepdims=True)
        aligned[name] = (ring - c) * s + c + t
        template[name] = ring
        rigid[name] = (t, s)
    return aligned, template, rigid


@pytest.fixture(scope="module")
def pair(tmp_path_factory):
    """Both networks on one 6-frame 48 px synthetic-tube scene from one
    state (``test_torch_train._build_pair``), with curves from
    ``align_fl`` in each package; the port then takes the JAX curve state.
    The port's own ``align_fl`` result is kept for (b)."""
    from recmv_tpu_torch.data.synthetic import generate_scene

    root = tmp_path_factory.mktemp("torch_curves")
    scene = generate_scene(str(root / "scene"), n_frames=N_FRAMES, image_size=IMG,
                           skinner_res=(17, 25, 9), device="cpu")
    net_j, net_t, ds_j = _build_pair(root, scene)
    curves_in = _scene_curves()
    net_j.align_fl(*curves_in)
    net_t.align_fl(*curves_in)
    own = bridge.export_curves(net_t)
    bridge.load_curves(net_t, _np_tree(net_j.params["curves"]), net_j.curve_statics)
    return dict(net_j=net_j, net_t=net_t, batch=ds_j.get_batch(FIDS), own=own,
                curves_in=curves_in, root=root, scene=scene, ds=ds_j)


def test_builder_keeps_the_body_mesh_on_a_cache_hit(pair):
    """A second build of the scene loads the skinner from the first one's
    ``.npz`` and keeps the same canonical body mesh for the ① body
    z-buffer."""
    from recmv_tpu_torch.config import ConfigFactory
    from recmv_tpu_torch.core.builder import build_opt_net
    from recmv_tpu_torch.core.network import TrainConfig
    from recmv_tpu_torch.data.dataset import get_dataset_and_loader
    from test_torch_train import ROOT, _train_cfg

    net_t = pair["net_t"]
    ds, _ = get_dataset_and_loader(pair["scene"], {"deformer": 256, "render": 256}, 2,
                                   shuffle=False, garment_type="synthetic-tube",
                                   data_type="synthe")
    again = build_opt_net(ConfigFactory.parse_file(os.path.join(ROOT, "configs", "synthetic",
                                                                "smoke.conf")),
                          ds, str(pair["root"] / "port"), resolutions=((7, 9, 5), (13, 17, 9)),
                          skinner_res=(17, 25, 9), train_cfg=_train_cfg(TrainConfig),
                          device="cpu")
    assert (pair["root"] / "port" / "initial_skinner_0.npz").is_file()
    assert again.tmp_body_vs.shape[0] > 100 and again.curve_statics is None
    assert torch.equal(again.tmp_body_vs, net_t.tmp_body_vs)
    assert torch.equal(again.tmp_body_fs, net_t.tmp_body_fs)


def test_align_fl_matches_jax(pair):
    """(b) The curve names in the dataset's order, the statics (the
    canonical-SMPL curves are the templates again) and the initial leaves;
    the inverse map of each package; the bridge round trip."""
    net_j, net_t = pair["net_j"], pair["net_t"]
    aligned, template, _ = pair["curves_in"]
    params, statics = pair["own"]
    cs = net_j.curve_statics
    assert statics["fl_names"] == cs.fl_names == ("neck", "bottom_curve")
    for k in ("center", "v_dirs", "init_scale", "nx", "cano_smpl_verts"):
        _close(statics[k], getattr(cs, k), 1e-6, err_msg=k)
    for i, n in enumerate(cs.fl_names):
        _close(statics["cano_smpl_verts"][i], template[n], 1e-5)
        got = net_t.inverse_fl_body([torch.as_tensor(aligned[n])], [n])[0]
        _close(got, net_j.inverse_fl_body([jnp.asarray(aligned[n])], [n])[0], 1e-6)
    for k in ("scale", "nx_scale"):
        np.testing.assert_array_equal(params[k], np.asarray(net_j.params["curves"][k]))
    assert isinstance(net_t.curve_opt, torch.optim.AdamW)
    back = bridge.export_curves(net_t)
    np.testing.assert_array_equal(back[1]["v_dirs"], np.asarray(cs.v_dirs))
    np.testing.assert_array_equal(back[0]["scale"], np.asarray(net_j.params["curves"]["scale"]))


class _MethodConf:
    """A config view with ``fl_visible_method`` set."""

    def __init__(self, inner, method):
        self._inner, self._method = inner, method

    def __getattr__(self, k):
        return getattr(self._inner, k)

    def get_string(self, path, default=None):
        if path == "fl_visible_method":
            return self._method
        return self._inner.get_string(path, default)


class _Recorder:
    """Wraps a visibility module's gates: keeps each final mask and, per
    gate, how far its value lies from its limit (the nearest of the gates
    that decided the mask). ``stack_min`` is the package's minimum over a
    list of (N, S) arrays; inside a JAX trace the records are traced
    values."""

    def __init__(self, mod, monkeypatch, stack_min):
        self.masks, margins = [], []
        zv, nv, cv = mod.zbuf_visible, mod.normal_visible, mod.combine_visibility

        def zbuf_visible(z, surf_z, thr):
            margins.append(abs((z - surf_z) - thr))
            return zv(z, surf_z, thr)

        def normal_visible(n):
            margins.append(abs(n[..., 2]))
            return nv(n)

        def combine_visibility(method, *args):
            out = cv(method, *args)
            self.masks.append((out, stack_min(margins)))
            margins.clear()
            return out

        monkeypatch.setattr(mod, "zbuf_visible", zbuf_visible)
        monkeypatch.setattr(mod, "normal_visible", normal_visible)
        monkeypatch.setattr(mod, "combine_visibility", combine_visibility)


def _fl_inputs(pair):
    net_j, net_t, batch = pair["net_j"], pair["net_t"], pair["batch"]
    fids_j = jnp.asarray(np.asarray(FIDS), jnp.int32)
    dev_j = net_j._device_batch(batch, fids_j)
    dev_t = net_t.device_batch(batch)
    return (net_j._global_params(), fids_j, dev_j, tuple(net_j.mesh.garment_vs),
            tuple(net_j.mesh.garment_fs), torch.as_tensor(FIDS), dev_t)


@pytest.mark.parametrize("method", ["zbuff", "garment_zbuff", "zbuff_and", "surface", "sdf"])
def test_fl_branch_loss_matches_jax(pair, monkeypatch, method):
    """(c) ``fl_branch_loss`` in each visibility mode: loss, every info
    scalar, the visibility masks and the curve leaves' gradients against
    ``jax.value_and_grad`` of the JAX function (masks recorded at its
    ``combine_visibility``), and no gradient on any global leaf."""
    import recmv_tpu.core.visibility as JV
    import recmv_tpu_torch.core.visibility as TV

    net_j, net_t = pair["net_j"], pair["net_t"]
    gp, fids_j, dev_j, vs_j, fs_j, fids_t, dev_t = _fl_inputs(pair)
    cp = net_j.params["curves"]
    r = net_j._ratio_dict(RATIO)
    monkeypatch.setattr(net_j, "conf", _MethodConf(net_j.conf, method))
    monkeypatch.setattr(net_t, "conf", _MethodConf(net_t.conf, method))

    def jfl(c):
        with pytest.MonkeyPatch.context() as mp:
            rec = _Recorder(JV, mp, lambda xs: jnp.min(jnp.stack(xs), 0))
            loss, info = net_j.fl_branch_loss(gp, c, fids_j, dev_j["fl_pts"], dev_j["fl_masks"],
                                              r, vs_j, fs_j)
        return loss, (info, rec.masks)

    (loss_j, (info_j, masks_j)), g_j = jax.jit(jax.value_and_grad(jfl, has_aux=True))(cp)
    with pytest.MonkeyPatch.context() as mp:
        rec_t = _Recorder(TV, mp, lambda xs: torch.stack(xs).amin(0))
        loss_t, info_t = net_t.fl_branch_loss(net_t.params["curves"], fids_t, dev_t["fl_pts"],
                                              dev_t["fl_masks"], RATIO, net_t.mesh.garment_vs,
                                              net_t.mesh.garment_fs)

    assert set(info_t) == set(info_j) == {"tube_project_loss", "fl_pc_tube_loss_sdf",
                                          "fl_center_loss", "fl_diff_loss"}
    for k, v in info_j.items():
        np.testing.assert_allclose(float(info_t[k]), float(v), rtol=1e-4, atol=1e-7, err_msg=k)
    np.testing.assert_allclose(float(loss_t), float(loss_j), rtol=1e-4)
    assert float(info_j["tube_project_loss"]) > 0

    assert len(rec_t.masks) == len(masks_j) == 2
    listed, n_vis = [], 0
    for (m_t, _), (m_j, margin) in zip(rec_t.masks, masks_j):
        m_t, m_j, near = m_t.numpy(), np.asarray(m_j), np.asarray(margin) < 1e-5
        listed.append(np.argwhere(near & (m_t != m_j)).tolist())
        np.testing.assert_array_equal(m_t[~near], m_j[~near])
        n_vis += int(m_j.sum())
    print(f"[{method}] points whose masks differ, all within 1e-5 of the limit: {listed}")
    assert 0 < n_vis < sum(m.size for m, _ in masks_j)

    leaves = net_t.curve_leaves()
    for p in net_t.global_leaves().values():
        p.grad = None
    g_t = torch.autograd.grad(loss_t, leaves)
    for name, g in zip(("scale", "nx_scale"), g_t):
        ref = np.asarray(g_j[name])
        assert np.linalg.norm(ref) > 0
        err = np.linalg.norm(g.numpy() - ref)
        assert err <= 1e-2 * np.linalg.norm(ref), (name, err / np.linalg.norm(ref))
    assert all(p.grad is None for p in net_t.global_leaves().values())


def test_curve_adamw_matches_optax():
    """(d) Three AdamW steps of the port's curve optimizer against
    ``optax.adamw(1e-4)`` (weight decay 1e-4) on seeded leaves and
    gradients."""
    from types import SimpleNamespace

    from recmv_tpu_torch.core.network import GarmentOptimNetwork, TrainConfig

    rng = np.random.RandomState(6)
    leaves = {k: rng.randn(2, 30, 1).astype(np.float32) for k in ("scale", "nx_scale")}
    grads = [{k: rng.randn(2, 30, 1).astype(np.float32) for k in leaves} for _ in range(3)]
    opt = optax.adamw(1e-4)
    p_j = {k: jnp.asarray(v) for k, v in leaves.items()}
    st = opt.init(p_j)
    net = SimpleNamespace(params={"curves": {k: _t(v, True) for k, v in leaves.items()}},
                          cfg=TrainConfig())
    net.curve_leaves = lambda: GarmentOptimNetwork.curve_leaves(net)
    GarmentOptimNetwork.reset_curve_optimizer(net)
    for g in grads:
        up, st = opt.update({k: jnp.asarray(v) for k, v in g.items()}, st, p_j)
        p_j = optax.apply_updates(p_j, up)
        for p, k in zip(net.curve_leaves(), ("scale", "nx_scale")):
            p.grad = _t(g[k])
        net.curve_opt.step()
    for k, p in net.params["curves"].items():
        _close(p, p_j[k], 5e-7)
        assert np.abs(np.asarray(p_j[k]) - leaves[k]).max() > 2e-4


# ---------------------------------------------------------------------------
# (e), (f): one whole training step
# ---------------------------------------------------------------------------

def _curve_draws(key, n_seg):
    """Replay the curve-aware term's two key splits → (draws, key)."""
    key, sub = jax.random.split(key)
    tri_i = jax.random.randint(sub, (50000,), 0, n_seg)
    key, sub = jax.random.split(key)
    uv = jax.random.uniform(sub, (50000, 2))
    return dict(tri_i=torch.tensor(np.asarray(tri_i)).long(), uv=_t(uv)), key


@pytest.fixture(scope="module")
def stepped(pair):
    """One whole step in each package from one state, the curve-aware term
    fired in both (garment type ``female_outfit3``, fine stage, target
    ``bottom_curve``): the JAX fused step with key KEY, the port's
    ``train_step`` with that key's draws replayed (seeding, the two
    curve-aware splits, then ``main_loss``'s per-garment draws)."""
    net_j, net_t, batch = pair["net_j"], pair["net_t"], pair["batch"]
    for net in (net_j, net_t):
        net.dataset.garment_type = "female_outfit3"
        net.isfine = True
    before = dict(glob_j=_np_tree(net_j._global_params()),
                  glob_t={k: v.detach().clone() for k, v in net_t.global_leaves().items()},
                  curves=_np_tree(net_j.params["curves"]),
                  vs=[np.asarray(v) for v in net_j.mesh.garment_vs])
    s = net_t.cfg.seed_downscale
    key = jax.random.PRNGKey(KEY)
    uniforms, key_m = _seed_uniforms(key, 1, len(FIDS) * (IMG // s) ** 2)
    curve_draws, key_m = _curve_draws(key_m, net_t.curve_statics.v_dirs.shape[1])
    budget = max(net_t.cfg.sample_pix, 1) * len(FIDS)
    draws = {"uniforms": uniforms, "curve_aware": curve_draws,
             "main": _main_draws(net_j, key_m, budget)}
    assert net_j._fused_ok and not net_j.cfg.profile_phases
    total_j, info_j = net_j.train_step(batch, FIDS, RATIO, key)
    grads = {}                       # the port's gradients as its optimizers see them

    def keep(opt):
        step = opt.step

        def call():
            grads.update({id(p): p.grad.clone() for g in opt.param_groups for p in g["params"]})
            return step()
        return call

    with pytest.MonkeyPatch.context() as mp:
        for opt in (net_t.curve_opt, net_t.global_opt):
            mp.setattr(opt, "step", keep(opt))
        total_t, info_t = net_t.train_step(batch, FIDS, RATIO, draws=draws)
    return dict(before=before, info_j=info_j, info_t=info_t, total_j=total_j, total_t=total_t,
                grads=grads)


def test_curve_aware_term_matches_jax(stepped):
    """(e) The curve-aware term fired in both steps on the updated curves
    with the replayed draws: its bf16 value within 5e-6."""
    info_j, info_t = stepped["info_j"], stepped["info_t"]
    assert "curve_aware_loss" in info_j and "curve_aware_loss" in info_t
    assert info_j["curve_aware_loss"] > 1e-3
    np.testing.assert_allclose(info_t["curve_aware_loss"], info_j["curve_aware_loss"],
                               atol=5e-6, rtol=0)


@pytest.mark.parametrize("garment_type, isfine, fires", [
    ("synthetic-two", False, True),       # upper_bottom among the scene's curves
    ("female_outfit3", True, True),       # a CURVE_AWARE type in the fine stage
    ("synthetic-tube", False, False)])
def test_curve_aware_term_needs_the_curves(pair, monkeypatch, garment_type, isfine, fires):
    """Before ``align_fl`` the port refuses the step where the curve-aware
    term would fire (the JAX ``main_loss`` cannot read the curve names
    then either), and leaves the term out where it would not."""
    from recmv_tpu_torch.config.constants import FL_INFOS

    net_t = pair["net_t"]
    assert float(net_t.conf.get_float("pc_weight.curve_aware_weight")) > 0
    monkeypatch.setattr(net_t, "curve_statics", None)
    monkeypatch.setattr(net_t, "isfine", isfine)
    monkeypatch.setattr(net_t.dataset, "garment_type", garment_type)
    monkeypatch.setattr(net_t.dataset, "fl_names", FL_INFOS[garment_type])
    if fires:
        with pytest.raises(ValueError, match="align_fl"):
            net_t._curve_aware_target()
    else:
        assert net_t._curve_aware_target() is None


def test_train_step_with_curves_matches_jax(pair, stepped):
    """(e) Every info scalar (① included), the curves after AdamW, the
    SGD-updated vertices and the Adam-updated global leaves (module
    docstring), frozen leaves unchanged in both."""
    net_j, net_t = pair["net_j"], pair["net_t"]
    info_j, info_t = stepped["info_j"], stepped["info_t"]
    before = stepped["before"]
    info_cmp = {k: v for k, v in info_j.items() if k != "curve_aware_loss"}
    _assert_info_close(info_t, info_cmp)
    for k in ("fl_loss_total", "gnorm_fl", "tube_project_loss", "gnorm_pc", "gnorm_main"):
        assert info_t[k] > 0, k
    np.testing.assert_allclose(stepped["total_t"], stepped["total_j"], rtol=1e-4)

    lr_c = float(net_t.curve_opt.param_groups[0]["lr"])
    for k in ("scale", "nx_scale"):
        dj = np.asarray(net_j.params["curves"][k]) - before["curves"][k]
        dt = net_t.params["curves"][k].detach().numpy() - before["curves"][k]
        g = stepped["grads"][id(net_t.params["curves"][k])].abs().numpy()
        big = (g > 1e-3 * g.max()) & (np.abs(dj) > 0.5 * lr_c)
        assert big.sum() > 100, k
        np.testing.assert_allclose(dt[big], dj[big], atol=2e-2 * lr_c, rtol=0, err_msg=k)

    vs_t, _ = bridge.mesh_to_numpy(net_t)
    for v0, vj, vt in zip(before["vs"], net_j.mesh.garment_vs, vs_t):
        dj, dt = np.asarray(vj) - v0, vt - v0
        assert np.linalg.norm(dj) > 0
        assert np.linalg.norm(dt - dj) <= 1e-3 * np.linalg.norm(dj)

    after_j = _np_tree(net_j._global_params())
    after_t = net_t.global_leaves()
    lr = float(net_t.global_opt.param_groups[0]["lr"])
    moved = 0
    for name in after_t:
        dj = _jax_leaf(after_j, name) - _jax_leaf(before["glob_j"], name)
        dt = (after_t[name].detach() - before["glob_t"][name]).numpy()
        if not net_t._trainable[name]:
            assert not dj.any() and not dt.any(), name
            continue
        # entries whose gradient (the port's) is above 1e-3 of the leaf's
        # largest, where its sign is stable, and whose JAX update is at
        # least lr/2
        g = stepped["grads"][id(after_t[name])].abs().numpy()
        big = (g > 1e-3 * g.max()) & (np.abs(dj) > 0.5 * lr)
        np.testing.assert_allclose(dt[big], dj[big], atol=2e-2 * lr, rtol=0, err_msg=name)
        moved += int(big.sum())
    assert moved > 1000


def test_curve_branch_reaches_only_the_curves(pair):
    """(f) On the tube scene outside the fine stage, where the curve-aware
    term does not fire, a training step on one frame from one state with ①
    on and with ① off (no curves) gives the same global leaves and
    vertices, bit for bit; with ① on the curves moved."""
    net_t, fids = pair["net_t"], FIDS[:1]
    batch = pair["ds"].get_batch(fids)
    s = net_t.cfg.seed_downscale
    uniforms, _ = _seed_uniforms(jax.random.PRNGKey(KEY + 1), 1, len(fids) * (IMG // s) ** 2)
    # the configs are shared, not copied (their views delegate attributes)
    base = copy.deepcopy(net_t, {id(net_t.conf): net_t.conf,
                                 id(net_t.full_conf): net_t.full_conf})
    base.dataset.garment_type, base.isfine = "synthetic-tube", False
    runs = []
    for with_curves in (True, False):
        net = copy.deepcopy(base, {id(base.conf): base.conf, id(base.full_conf): base.full_conf})
        c0 = {k: v.detach().clone() for k, v in net.params["curves"].items()}
        if not with_curves:
            del net.params["curves"]
            net.curve_statics = None
        assert net._curve_aware_target() is None
        budget = net.cfg.sample_pix * len(fids)
        main = net.main_draws([{"pts": torch.zeros(budget, 3)}], net.mesh.garment_vs,
                              torch.Generator().manual_seed(0))
        _, info = net.train_step(batch, fids, RATIO, draws={"uniforms": uniforms, "main": main})
        assert ("fl_loss_total" in info) == with_curves
        if with_curves:
            assert all((net.params["curves"][k] != v).any() for k, v in c0.items())
        runs.append(net)
    on, off = runs
    for name, p in on.global_leaves().items():
        assert torch.equal(p, off.global_leaves()[name]), name
    for a, b in zip(on.mesh.garment_vs, off.mesh.garment_vs):
        assert torch.equal(a, b)


# ---------------------------------------------------------------------------
# (g) the curve AdamW restarts at every remesh
# ---------------------------------------------------------------------------

def test_remesh_resets_the_curve_optimizer(pair):
    """(g) ``marching_cube_update`` on a network with curves leaves the
    curves' AdamW with no state, over the current curve leaves, as the JAX
    ``marching_cube_update`` re-inits ``curve_opt_state``."""
    net = copy.deepcopy(pair["net_t"], {id(pair["net_t"].conf): pair["net_t"].conf,
                                        id(pair["net_t"].full_conf): pair["net_t"].full_conf})
    for p in net.curve_leaves():
        p.grad = torch.ones_like(p)
    net.curve_opt.step()
    assert len(net.curve_opt.state) == 2
    net.marching_cube_update(RATIO)
    assert len(net.curve_opt.state) == 0
    held = [p for g in net.curve_opt.param_groups for p in g["params"]]
    assert all(a is b for a, b in zip(held, net.curve_leaves())) and len(held) == 2


@pytest.mark.parametrize("remesh", ["jax_mesh", "own_mesh"])
def test_step_remesh_step_matches_jax(pair, remesh):
    """(g) From one state (the JAX package's parameters, scene, curves and
    mesh, fresh optimizers) on the tube scene outside the fine stage: a
    training step, a forced remesh (the port then takes the JAX values of
    the parameters, scene and curves in place, so that both step from the
    same point) and a second step, with the JAX draws replayed, against the
    JAX package's three calls. With ``jax_mesh`` the port takes the JAX
    mesh after its remesh; with ``own_mesh`` it steps on its own: its mesh
    must have the JAX mesh's vertices in order (the draws of ③ pick
    vertices by index) and its faces exactly. The curves after each step as
    ``test_train_step_with_curves_matches_jax`` holds them: entries whose
    JAX step is at least lr/2 (and whose gradient is above 1e-3 of the
    leaf's largest) within 2e-2 of lr. With the curve AdamW's moments
    carried over the remesh, the second step's update of an entry whose
    gradient changed differs by more than that."""
    net_j = pair["net_j"]
    kept = (dict(net_j.params), net_j._scene_dev, net_j.mesh, net_j.opt_times,
            net_j._remeshed_at)
    try:
        _step_remesh_step(pair, remesh)
    finally:
        # the next case starts from the same JAX state (its arrays are immutable)
        net_j.params.clear()
        net_j.params.update(kept[0])
        net_j._scene_dev, net_j.mesh, net_j.opt_times, net_j._remeshed_at = kept[1:]


def _step_remesh_step(pair, remesh):
    net_j, net_t, batch = pair["net_j"], pair["net_t"], pair["batch"]
    for net in (net_j, net_t):
        net.dataset.garment_type, net.isfine = "synthetic-tube", False
    bridge.load_jax_params(net_t.params, _np_tree(
        {k: net_j.params[k] for k in ("sdf", "garment_sdfs", "translator", "render",
                                      "skinner")}))
    bridge.load_scene(net_t.scene, _np_tree(net_j.scene_tree()))
    bridge.load_curves(net_t, _np_tree(net_j.params["curves"]), net_j.curve_statics)
    bridge.load_mesh(net_t, net_j.mesh.garment_vs, net_j.mesh.garment_fs,
                     net_j.mesh.garment_n, net_j.mesh.garment_fn)
    net_j._init_global_opt()
    net_j.vert_opt_state = net_j.vert_opt.init(tuple(net_j.mesh.garment_vs))
    net_t._init_global_opt(net_t._lr)
    net_t.opt_times, net_t._remeshed_at = net_j.opt_times, net_j._remeshed_at
    assert net_t._curve_aware_target() is None
    lr_c = float(net_t.curve_opt.param_groups[0]["lr"])
    s = net_t.cfg.seed_downscale
    budget = max(net_t.cfg.sample_pix, 1) * len(FIDS)
    grads = {}

    def keep(opt):
        step = opt.step

        def call():
            grads.update({id(p): p.grad.clone() for g in opt.param_groups for p in g["params"]})
            return step()
        return call

    for step in range(2):
        if step == 1:
            # both packages step again from the JAX values (in place: the
            # optimizers keep their state), on a fresh remesh
            bridge.load_jax_params(net_t.params, _np_tree(
                {k: net_j.params[k] for k in ("sdf", "garment_sdfs", "translator", "render",
                                              "skinner")}))
            bridge.load_scene(net_t.scene, _np_tree(net_j.scene_tree()))
            with torch.no_grad():
                for k, p in net_t.params["curves"].items():
                    p.copy_(torch.as_tensor(np.asarray(net_j.params["curves"][k])))
            assert len(net_t.curve_opt.state) == 2
            net_j.marching_cube_update(RATIO)
            net_t.marching_cube_update(RATIO)
            assert len(net_t.curve_opt.state) == 0
            if remesh == "jax_mesh":
                bridge.load_mesh(net_t, net_j.mesh.garment_vs, net_j.mesh.garment_fs,
                                 net_j.mesh.garment_n, net_j.mesh.garment_fn)
            else:
                assert net_t.mesh.garment_n == net_j.mesh.garment_n
                assert min(net_j.mesh.garment_n) > 20
                assert net_t.mesh.garment_fn == net_j.mesh.garment_fn
                for v, f, vj, fj, n, nf in zip(net_t.mesh.garment_vs, net_t.mesh.garment_fs,
                                               net_j.mesh.garment_vs, net_j.mesh.garment_fs,
                                               net_j.mesh.garment_n, net_j.mesh.garment_fn):
                    assert v.shape == np.asarray(vj).shape and f.shape == np.asarray(fj).shape
                    np.testing.assert_array_equal(f[:nf].numpy(), np.asarray(fj)[:nf])
                    np.testing.assert_allclose(v[:n].detach().numpy(), np.asarray(vj)[:n],
                                               atol=MC_ATOL, rtol=0)
        c0 = {k: np.asarray(net_j.params["curves"][k]) for k in ("scale", "nx_scale")}
        key = jax.random.PRNGKey(KEY + 2 + step)
        uniforms, key_m = _seed_uniforms(key, 1, len(FIDS) * (IMG // s) ** 2)
        draws = {"uniforms": uniforms, "main": _main_draws(net_j, key_m, budget)}
        net_j.train_step(batch, FIDS, RATIO, key)
        with pytest.MonkeyPatch.context() as mp:
            mp.setattr(net_t.curve_opt, "step", keep(net_t.curve_opt))
            net_t.train_step(batch, FIDS, RATIO, draws=draws)
        for k in ("scale", "nx_scale"):
            p = net_t.params["curves"][k]
            dj = np.asarray(net_j.params["curves"][k]) - c0[k]
            dt = p.detach().numpy() - c0[k]
            g = grads[id(p)].abs().numpy()
            big = (g > 1e-3 * g.max()) & (np.abs(dj) > 0.5 * lr_c)
            assert big.sum() > 100, (step, k)
            np.testing.assert_allclose(dt[big], dj[big], atol=2e-2 * lr_c, rtol=0,
                                       err_msg=f"step {step} {k}")
