"""Parity of the PyTorch port's model math with the JAX package.

Inputs are made with numpy from a seed; weights cross from the JAX
initializers into the port through ``recmv_tpu_torch.bridge``.

Tolerances (float32 on the CPU):
- values: atol 1e-5, rtol 1e-4; gradients: atol/rtol 1e-4 (the two
  frameworks sum in different orders).
- The translator runs all five layers with bf16 operands and f32
  accumulation in both packages (``recmv_tpu/models/translator.py``).
  Its bf16 offsets are held to the JAX function at 2e-6 absolute (largest
  difference measured 4.1e-7 against offsets of ~1e-3: the two sum in
  another order, and a last-bit difference can flip a bf16 rounding of an
  activation), and each weight gradient to 1e-3 of its norm (measured up
  to 2.0e-4). Its f32 case, the port's layers without ``compute_dtype``,
  is held to a JAX f32 re-evaluation of the same layers at the f32
  tolerances.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from recmv_tpu_torch import bridge

ATOL, RTOL = 1e-5, 1e-4
GTOL = 1e-4


def _t(a):
    return torch.tensor(np.asarray(a, np.float32))


def _close(port, ref, atol=ATOL, rtol=RTOL):
    np.testing.assert_allclose(port.detach().cpu().numpy(), np.asarray(ref),
                               atol=atol, rtol=rtol)


def _np_tree(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


@pytest.mark.parametrize("ratio", [None, -1.0, 0.3, 1.0])
def test_embedder_annealed(ratio):
    from recmv_tpu.models.sdf import _embed_with_ratio
    from recmv_tpu.ops.embedder import Embedder as JEmb
    from recmv_tpu_torch.ops.embedder import Embedder, embed_with_ratio

    x = np.random.RandomState(0).randn(40, 3).astype(np.float32)
    ref = _embed_with_ratio(JEmb(6), jnp.asarray(x), ratio)
    _close(embed_with_ratio(Embedder(6), _t(x), ratio), ref)


def _sdf_pair(seed=0):
    from recmv_tpu.models.sdf import init_sdf_net as jinit
    from recmv_tpu_torch.models.sdf import init_sdf_net

    jp, js = jinit(jax.random.PRNGKey(seed), multires=6, bias=0.6,
                   feature_vector_size=16, dims=(64, 64, 64, 64), skip_in=(2,))
    net = init_sdf_net(torch.Generator().manual_seed(0), multires=6, bias=0.6,
                       feature_vector_size=16, dims=(64, 64, 64, 64), skip_in=(2,))
    bridge.load_mlp(net, _np_tree(jp))
    return jp, js, net


def test_sdf_value_features_and_gradient():
    from recmv_tpu.models.sdf import sdf_apply as japply, sdf_gradient as jgrad
    from recmv_tpu_torch.models.sdf import sdf_apply, sdf_gradient

    jp, js, net = _sdf_pair()
    pts = np.random.RandomState(1).randn(128, 3).astype(np.float32) * 0.5
    s_ref, f_ref = japply(jp, js, jnp.asarray(pts), 0.7)
    s, f = sdf_apply(net, _t(pts), 0.7)
    _close(s, s_ref)
    _close(f, f_ref)
    _close(sdf_gradient(net, _t(pts), 0.7), jgrad(jp, js, jnp.asarray(pts), 0.7),
           atol=GTOL, rtol=GTOL)


def test_bridge_round_trip(skinners):
    """JAX pytrees → port → JAX layout gives the same arrays back, for the
    model params and for the scene tree."""
    from recmv_tpu.models.render_net import init_render_net as jrender
    from recmv_tpu.models.translator import init_translator as jtrans
    from recmv_tpu_torch.models.render_net import init_render_net
    from recmv_tpu_torch.models.translator import init_translator

    jp, _, net = _sdf_pair()
    gen = torch.Generator().manual_seed(0)
    jparams = _np_tree({
        "sdf": jp, "garment_sdfs": (jp,),
        "translator": jtrans(jax.random.PRNGKey(1), condlen=32)[0],
        "render": jrender(jax.random.PRNGKey(2), condlen=16, multires_v=4)[0],
        "skinner": bridge.skinner_to_numpy(bridge.skinner_from_jax(skinners[0], device="cpu"))})
    params = {"sdf": net, "garment_sdfs": torch.nn.ModuleList([_sdf_pair(1)[2]]),
              "translator": init_translator(gen, condlen=32),
              "render": init_render_net(gen, condlen=16, multires_v=4),
              "skinner": skinners[1]}
    bridge.load_jax_params(params, jparams)
    back = bridge.export_params(params)
    flat_ref = jax.tree_util.tree_leaves_with_path(jparams)
    flat = dict(jax.tree_util.tree_leaves_with_path(back))
    assert len(flat_ref) == len(flat)
    for path, leaf in flat_ref:
        np.testing.assert_array_equal(flat[path], leaf, err_msg=str(path))

    rng = np.random.RandomState(0)
    scene = {"poses": rng.randn(4, 24, 3).astype(np.float32),
             "trans": rng.randn(4, 3).astype(np.float32),
             "shape": rng.randn(10).astype(np.float32),
             "conds": {"deformer": rng.randn(4, 8).astype(np.float32)},
             "camera": {"focal_length": np.ones(2, np.float32)}}
    got = bridge.scene_to_numpy(bridge.scene_from_jax(scene, device="cpu"))
    assert jax.tree_util.tree_structure(got) == jax.tree_util.tree_structure(scene)
    for a, b in zip(jax.tree_util.tree_leaves(got), jax.tree_util.tree_leaves(scene)):
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_translator(dtype):
    from recmv_tpu.models.mlp import linear_apply
    from recmv_tpu.models.translator import init_translator as jinit, translator_offset as joff
    from recmv_tpu.ops.embedder import annealing_weights
    from recmv_tpu_torch.models.translator import init_translator, translator_offset
    from recmv_tpu_torch.ops.embedder import embed_with_ratio

    jp, js = jinit(jax.random.PRNGKey(3), condlen=32, multires=6)
    net = init_translator(torch.Generator().manual_seed(0), condlen=32, multires=6)
    bridge.load_mlp(net, _np_tree(jp))
    rng = np.random.RandomState(2)
    ps = rng.randn(64, 3).astype(np.float32) * 0.4
    cond = rng.randn(64, 32).astype(np.float32) * 0.1
    g = rng.randn(64, 3).astype(np.float32)

    def jf32(prm):
        # the same layers evaluated by JAX in f32
        x = jnp.concatenate([js.embedder(jnp.asarray(ps), annealing_weights(6, 0.5)),
                             jnp.asarray(cond)], -1)
        for l in range(5):
            x = linear_apply(prm[f"lin{l}"], x)
            if l < 4:
                x = jax.nn.relu(x)
        return x

    if dtype == "f32":
        # the port's layers in f32: Linear without compute_dtype
        ref, vjp = jax.vjp(jf32, jp)
        off = torch.cat([embed_with_ratio(net.embedder, _t(ps), 0.5), _t(cond)], -1)
        for l, lin in enumerate(net.lins):
            off = lin(off) if l == 4 else torch.relu(lin(off))
        v_atol, v_rtol, g_tol = ATOL, RTOL, GTOL
    else:
        ref, vjp = jax.vjp(lambda prm: joff(prm, js, jnp.asarray(ps), jnp.asarray(cond), 0.5), jp)
        off = translator_offset(net, _t(ps), _t(cond), 0.5)
        v_atol, v_rtol, g_tol = 2e-6, 0.0, 1e-3
    _close(off, ref, atol=v_atol, rtol=v_rtol)
    g_ref = _np_tree(vjp(jnp.asarray(g))[0])
    grads = torch.autograd.grad((off * _t(g)).sum(), list(net.parameters()))
    for (name, _), got in zip(net.named_parameters(), grads):
        _, l, p = name.split(".")
        want = g_ref[f"lin{l}"][p]
        got = got.numpy().T if got.ndim == 2 else got.numpy()
        assert np.linalg.norm(want) > 0, name
        assert np.linalg.norm(got - want) <= g_tol * np.linalg.norm(want), name


def test_render_net():
    from recmv_tpu.models.render_net import init_render_net as jinit, render_net_apply as japply
    from recmv_tpu_torch.models.render_net import init_render_net, render_net_apply

    jp, js = jinit(jax.random.PRNGKey(4), condlen=32, multires_v=4)
    net = init_render_net(torch.Generator().manual_seed(0), condlen=32, multires_v=4)
    bridge.load_mlp(net, _np_tree(jp))
    rng = np.random.RandomState(3)
    a = [rng.randn(50, 3).astype(np.float32) for _ in range(3)]
    feat = rng.randn(50, 32).astype(np.float32)
    ref = japply(jp, js, *map(jnp.asarray, a), jnp.asarray(feat), ratio=0.8)
    _close(render_net_apply(net, *map(_t, a), _t(feat), ratio=0.8), ref)


def test_fast_3x3_inv_value_mask_and_grad():
    from recmv_tpu.ops.math3d import fast_3x3_inv as jinv
    from recmv_tpu_torch.ops.math3d import fast_3x3_inv

    rng = np.random.RandomState(5)
    m = rng.randn(32, 3, 3).astype(np.float32)
    m[3] = [[1, 2, 3], [2, 4, 6], [0, 1, 0]]          # singular → masked
    g = rng.randn(32, 3, 3).astype(np.float32)
    inv_ref, ok_ref = jinv(jnp.asarray(m))
    grad_ref = jax.grad(lambda a: jnp.sum(jinv(a)[0] * g))(jnp.asarray(m))
    mt = _t(m).requires_grad_(True)
    inv, ok = fast_3x3_inv(mt)
    (grad,) = torch.autograd.grad((inv * _t(g)).sum(), mt)
    assert not bool(ok[3])
    np.testing.assert_array_equal(ok.numpy(), np.asarray(ok_ref))
    _close(inv, inv_ref, atol=1e-4)
    _close(grad, grad_ref, atol=GTOL, rtol=GTOL)


def test_synthetic_body_fk():
    from recmv_tpu.models.smpl import smpl_forward as jfwd, synthetic_body_model as jbody
    from recmv_tpu_torch.models.smpl import smpl_forward, synthetic_body_model

    body_j, body = jbody(n_subdiv=16), synthetic_body_model(n_subdiv=16)
    np.testing.assert_array_equal(body.v_template, body_j.v_template)
    rng = np.random.RandomState(6)
    pose = (rng.randn(2, 24, 3) * 0.3).astype(np.float32)
    betas = (rng.randn(10) * 0.5).astype(np.float32)
    v_ref, j_ref, a_ref = jfwd(body_j, jnp.asarray(betas), jnp.asarray(pose))
    v, j, a = smpl_forward(body, _t(betas), _t(pose))
    _close(v, v_ref)
    _close(j, j_ref)
    _close(a, a_ref)


def test_grid_sample():
    """Trilinear sampling, align_corners=False as on the main path; some
    points fall outside the volume (zero padding)."""
    from recmv_tpu.ops.grid_sample import grid_sample_3d as jgs
    from recmv_tpu_torch.ops.grid_sample import grid_sample_3d

    rng = np.random.RandomState(7)
    vol = rng.rand(5, 6, 7, 8).astype(np.float32)
    pts = rng.uniform(-1.2, 1.2, (300, 3)).astype(np.float32)
    ref = jgs(jnp.asarray(vol), jnp.asarray(pts), align_corners=False)
    _close(grid_sample_3d(_t(vol), _t(pts)), ref)


@pytest.fixture(scope="module")
def skinners():
    """The JAX skinner and the port's, both built from the synthetic body
    at a small weight-field resolution."""
    from recmv_tpu.models.skinner import initial_lbs_skinner as jinit
    from recmv_tpu.models.smpl import synthetic_body_model as jbody
    from recmv_tpu_torch.models.skinner import initial_lbs_skinner
    from recmv_tpu_torch.models.smpl import synthetic_body_model

    apose = np.zeros((24, 3), np.float32)
    apose[1, 2], apose[2, 2], apose[16, 2], apose[17, 2] = 0.17, -0.17, -0.79, 0.79
    sk_j, _, _ = jinit(jbody(n_subdiv=16), jnp.zeros(10), apose, resolution=(9, 13, 7))
    sk_t, _, _ = initial_lbs_skinner(synthetic_body_model(n_subdiv=16), torch.zeros(10),
                                     apose, resolution=(9, 13, 7))
    return sk_j, sk_t


def test_skinner_construction(skinners):
    sk_j, sk_t = skinners
    ref = bridge.skinner_to_numpy(bridge.skinner_from_jax(sk_j, device="cpu"))
    for k, v in bridge.skinner_to_numpy(sk_t).items():
        np.testing.assert_allclose(v, ref[k], atol=ATOL, rtol=RTOL, err_msg=k)


def test_skinner_apply(skinners):
    from recmv_tpu.models.skinner import skinner_apply as japply
    from recmv_tpu_torch.models.skinner import skinner_apply

    sk_j, _ = skinners
    sk = bridge.skinner_from_jax(sk_j, device="cpu")
    rng = np.random.RandomState(8)
    ps = (rng.randn(2, 50, 3) * 0.3).astype(np.float32)
    also = (rng.randn(2, 50, 3) * 0.3).astype(np.float32)
    poses = (rng.randn(2, 24, 3) * 0.2).astype(np.float32)
    trans = rng.randn(2, 3).astype(np.float32)
    a_ref, b_ref = japply(sk_j, jnp.asarray(ps), jnp.asarray(poses), jnp.asarray(trans),
                          also_apply=jnp.asarray(also))
    a, b = skinner_apply(sk, _t(ps), _t(poses), _t(trans), also_apply=_t(also))
    _close(a, a_ref)
    _close(b, b_ref)
    inds = np.repeat(np.arange(2), 50)
    flat_ref = japply(sk_j, jnp.asarray(ps.reshape(-1, 3)), jnp.asarray(poses),
                      jnp.asarray(trans), batch_inds=jnp.asarray(inds))
    flat = skinner_apply(sk, _t(ps.reshape(-1, 3)), _t(poses), _t(trans),
                         batch_inds=torch.as_tensor(inds))
    _close(flat, flat_ref)


def test_posed_skeleton_and_bbox(skinners):
    from recmv_tpu.models.skinner import bbox_size as jbbox, posed_skeleton as jskel
    from recmv_tpu_torch.models.skinner import bbox_size, posed_skeleton

    sk_j, _ = skinners
    sk = bridge.skinner_from_jax(sk_j, device="cpu")
    poses = (np.random.RandomState(11).randn(3, 24, 3) * 0.3).astype(np.float32)
    _close(posed_skeleton(sk, _t(poses)), jskel(sk_j, jnp.asarray(poses)))
    for got, want in zip(bbox_size(sk), jbbox(sk_j)):
        _close(got, want)


def _camera_pair():
    from recmv_tpu.models.camera import make_camera as jmake
    from recmv_tpu_torch.models.camera import make_camera

    params = {"focal_length": np.asarray([80.0, 76.0], np.float32),
              "princeple_points": np.asarray([30.0, 33.0], np.float32),
              "cam2world_coord_quat": np.asarray([0.1, 0.2, 0.95, 0.05], np.float32),
              "world2cam_coord_trans": np.asarray([0.1, 0.2, 2.6], np.float32)}
    return jmake(params, (64, 60)), make_camera(params, (64, 60), device="cpu")


def test_camera_rays_and_projection():
    from recmv_tpu.models import camera as jc
    from recmv_tpu.ops.rasterizer import screen_with_cam_z as jscr
    from recmv_tpu_torch.models import camera as tc
    from recmv_tpu_torch.ops.rasterizer import screen_with_cam_z

    cj, ct = _camera_pair()
    rng = np.random.RandomState(9)
    pix = np.concatenate([rng.rand(40, 2) * 60, np.ones((40, 1))], 1).astype(np.float32)
    pts = (rng.randn(40, 3) * 0.3).astype(np.float32)
    _close(tc.view_rays(ct, _t(pix)), jc.view_rays(cj, jnp.asarray(pix)))
    _close(screen_with_cam_z(ct, _t(pts)), jscr(cj, jnp.asarray(pts)))
    _close(tc.cam_pos(ct), jc.cam_pos(cj))
    assert tc.ang_threshold(ct) == pytest.approx(jc.ang_threshold(cj), rel=1e-6)


def test_deformer_jacobian_and_cardinal_rays(skinners):
    from recmv_tpu.models.deformer import cardinal_rays_from_jac as jcr, deformer_jacobian as jjac
    from recmv_tpu.models.skinner import skinner_apply as japply
    from recmv_tpu_torch.models.deformer import cardinal_rays_from_jac, deformer_jacobian
    from recmv_tpu_torch.models.skinner import skinner_apply

    sk_j, _ = skinners
    sk = bridge.skinner_from_jax(sk_j, device="cpu")
    rng = np.random.RandomState(10)
    ps = (rng.randn(60, 3) * 0.3).astype(np.float32)
    poses = (rng.randn(2, 24, 3) * 0.2).astype(np.float32)
    trans = rng.randn(2, 3).astype(np.float32)
    inds = rng.randint(0, 2, 60)
    rays = rng.randn(60, 3).astype(np.float32)
    rays /= np.linalg.norm(rays, axis=1, keepdims=True)

    def jdeform(p):
        return japply(sk_j, p ** 2 * 0.5 + p, jnp.asarray(poses), jnp.asarray(trans),
                      batch_inds=jnp.asarray(inds))

    def deform(p):
        return skinner_apply(sk, p ** 2 * 0.5 + p, _t(poses), _t(trans),
                             batch_inds=torch.as_tensor(inds))

    jac_ref = jjac(jdeform, jnp.asarray(ps))
    jac = deformer_jacobian(deform, _t(ps))
    _close(jac, jac_ref, atol=GTOL, rtol=GTOL)
    r_ref, ok_ref = jcr(jac_ref, jnp.asarray(rays))
    r, ok = cardinal_rays_from_jac(_t(jac_ref), _t(rays))
    np.testing.assert_array_equal(ok.numpy(), np.asarray(ok_ref))
    _close(r, r_ref, atol=GTOL, rtol=GTOL)


def test_graft_entry_forward():
    """The port of ``__graft_entry__.entry()``'s forward (garment SDF value,
    features and normal, the composite deformer and the IDR render) on the
    same weights, the translator in bf16 in both (module docstring)."""
    from __graft_entry__ import entry
    from recmv_tpu_torch.models.render_net import init_render_net, render_net_apply
    from recmv_tpu_torch.models.sdf import init_sdf_net, sdf_apply, sdf_gradient
    from recmv_tpu_torch.models.skinner import skinner_apply
    from recmv_tpu_torch.models.translator import init_translator, translator_apply

    fwd, args = entry()
    jparams, pts, rays, cond, poses, trans = args
    ref = np.asarray(fwd(jparams, *map(jnp.asarray, (pts, rays, cond, poses, trans))))

    gen = torch.Generator().manual_seed(0)
    sdf = init_sdf_net(gen)
    tr = init_translator(gen)
    rn = init_render_net(gen, condlen=256, multires_v=4)
    for mod, key in ((sdf, "sdf"), (tr, "translator"), (rn, "render")):
        bridge.load_mlp(mod, _np_tree(jparams[key]))
    sk = bridge.skinner_from_jax(jparams["skinner"], device="cpu")

    p = _t(pts)
    s, feat = sdf_apply(sdf, p, 1.0)
    nx = sdf_gradient(sdf, p, 1.0)
    nx = nx / torch.clamp(torch.linalg.norm(nx, dim=-1, keepdim=True), min=1e-9)
    off_pts, _ = translator_apply(tr, p, _t(cond), 1.0)
    posed = skinner_apply(sk, off_pts[None], _t(poses), _t(trans))[0]
    rgb = render_net_apply(rn, p, nx, _t(rays), feat, 1.0)
    _close(s, ref[:, 0])
    _close(rgb, ref[:, 1:4], atol=GTOL, rtol=GTOL)
    _close(posed, ref[:, 4:7])
