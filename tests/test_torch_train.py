"""Parity of the port's training step with the JAX package, on the CPU.

Inputs are made with numpy from a seed; weights, the scene tree and the
mesh buffers cross from the JAX package into the port through
``recmv_tpu_torch.bridge``; the JAX package's random draws are replayed
into the port (``draws``).

(a) the plain backward of the point composite against ``jax.vjp`` of the
    JAX ``composite_points`` with the Pallas backend in interpret mode
    (the real ``_bwd_kernel``); (b) the same plain backward against
    autograd of the plain forward; (c) the differentiable point gradient,
    Jacobian and sampler, the implicit adjoint and each new loss term
    against their JAX counterparts; (d) on a 32-frame 48 px
    synthetic-tube scene (pc-sdf weighed 0) the ② and ③ losses and their
    per-leaf gradients against ``jax.value_and_grad`` of the JAX methods,
    and the pc-sdf term alone; (e) one whole ``train_step`` in each
    package from one state; (f) the DCT windows on that scene.

Both packages run the translator and the pc-sdf values with bf16
operands and f32 accumulation. Two bf16 evaluations still differ: they
round f32 partial sums that were added in another order, and one flipped
bf16 rounding moves the next layer's sums by a whole bf16 step, which
flips more (measured on the 8×512 SDF: 7e-6 of the layer-1 inputs differ,
16% of the layer-8 inputs; per-point SDF values by up to 1e-3).

Tolerances (float32) and why:
- composite gradients: 1e-5 of the largest entry (sums over pixels and
  candidates in another order);
- model-level gradients (c): 1e-4 absolute and relative, as
  ``tests/test_torch_models.py``;
- (d)/(e): info scalars within 1e-4 relative, gradient norms 1e-3; leaf
  gradients within 1e-4 of each leaf's norm, 1e-2 for those that pass the
  bf16 translator (its weights and the deformer latents; measured up to
  3.7e-3). The pc-sdf term is weighed 0 in the branch comparisons: at its
  weight of 60 the bf16 differences above reach the garment SDF's
  gradients (9% of a leaf's norm measured). Its info value is held to
  5e-6 absolute (measured 1.3e-6 of ~2e-3; the port in f32 was 1.3e-4
  off) and the term is tested apart (``test_pc_sdf_term_matches_jax_bf16``):
  value 5e-6, each gradient 0.2 of its norm (measured up to 0.12: the
  gradient of |sdf + shrink| flips sign on the vertices whose two bf16
  values straddle −shrink), and 5e-3 with the JAX signs (measured up to
  1.8e-3); its f32 case 1e-6 and 1e-4. On the CPU
  the JAX package composites the masks with its XLA subtile backend, the
  port with the Pallas semantics (same function, sums in another order).
  Adam's first step is lr·g/(|g| + 1e-8), nearly −lr·sign(g), so updated
  parameters are compared on the entries whose gradient is above 1e-3 of
  the leaf's largest, where the sign is stable, and whose JAX update is at
  least lr/2, to 2e-2 of the learning rate. (The step seeds and solves its
  own rays, so its gradient is not the one of (d); where it is within a
  few eps of 0 the update moves by a share of lr for a difference of
  1e-9, which the bf16 translator's differences reach through the
  deformer: 2 of 256,825 entries of a garment SDF layer measured.) SGD-
  updated vertices to 1e-3 of the update's norm.
"""

import os
from types import SimpleNamespace

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from recmv_tpu_torch import bridge
from recmv_tpu_torch.data.synthetic import GARMENT_SDF_BIAS

ROOT = os.path.join(os.path.dirname(__file__), "..")
RATIO = {"sdfRatio": 1.0, "deformerRatio": 0.5, "renderRatio": 1.0}
FIDS = [3, 17]
GTOL = 1e-4


def _t(a, grad=False):
    return torch.tensor(np.asarray(a, np.float32), requires_grad=grad)


def _close(port, ref, atol=GTOL, rtol=GTOL, err_msg=""):
    np.testing.assert_allclose(port.detach().cpu().numpy(), np.asarray(ref), atol=atol,
                               rtol=rtol, err_msg=err_msg)


def _np_tree(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _module_grads(module, grads):
    """Port grads of an MLP's parameters in the JAX layout {lin{l}: {..}}."""
    out = {}
    for (name, _), g in zip(module.named_parameters(), grads):
        _, l, p = name.split(".")
        a = g.detach().numpy()
        out.setdefault(f"lin{l}", {})[p] = a.T if a.ndim == 2 else a
    return out


def _assert_tree_close(got, want, atol=GTOL, rtol=GTOL):
    for path, leaf in jax.tree_util.tree_leaves_with_path(want):
        sub = got
        for k in path:
            sub = sub[k.key if hasattr(k, "key") else k.idx]
        np.testing.assert_allclose(sub, np.asarray(leaf), atol=atol, rtol=rtol,
                                   err_msg=str(path))


# ---------------------------------------------------------------------------
# (a), (b): the point composite's backward
# ---------------------------------------------------------------------------

def _points(seed, P=150, size=64):
    rng = np.random.RandomState(seed)
    pts = np.stack([rng.rand(P) * size, rng.rand(P) * size, 1.0 + rng.rand(P)], 1)
    pts[:7, 2] = -1.0                                      # behind the camera: skipped
    return pts.astype(np.float32)


@pytest.mark.parametrize("C,features_const,cap", [(1, True, 128), (2, False, 128),
                                                  (2, False, 24), (1, True, 24)],
                         ids=["C1-const", "C2-dfeat", "C2-dfeat-overflow",
                              "C1-const-overflow"])
def test_composite_backward_matches_pallas_interpret(C, features_const, cap):
    """The port's ``composite_points`` backward (the plain K3 on the CPU)
    against the JAX ``_bwd_kernel`` in interpret mode, through the same
    binning prologue."""
    from recmv_tpu.ops.rasterizer import composite_points as jcomp
    from recmv_tpu_torch.ops import composite
    from recmv_tpu_torch.ops.rasterizer import composite_points

    rng = np.random.RandomState(C + cap)
    pts = _points(C + cap)
    feats = rng.rand(pts.shape[0], C).astype(np.float32)
    cot = rng.randn(64, 64, C).astype(np.float32)
    out_j, vjp = jax.vjp(lambda p, f: jcomp(p, 0.1, f, (64, 64), tile=32, cap=cap,
                                            backend="pallas_interpret",
                                            features_const=features_const),
                         jnp.asarray(pts), jnp.asarray(feats))
    gp_j, gf_j = vjp(jnp.asarray(cot))

    p = _t(pts, grad=True)
    f = _t(feats, grad=not features_const)
    calls = []
    bwd = composite._composite_tiles_bwd_torch

    def spy(*args):
        calls.append(args[-1])
        return bwd(*args)

    composite._composite_tiles_bwd_torch = spy
    try:
        out = composite_points(p[None], 0.1, f, (64, 64), tile=32, cap=cap)[0]
        out.backward(_t(cot))
    finally:
        composite._composite_tiles_bwd_torch = bwd
    assert calls == [not features_const]                  # dfeat sums only when asked
    _close(out, out_j, atol=1e-5, rtol=0)
    scale = float(np.abs(np.asarray(gp_j)).max())
    assert scale > 0.1
    _close(p.grad, gp_j, atol=1e-5 * scale, rtol=0)
    if not features_const:
        _close(f.grad, gf_j, atol=1e-5 * float(np.abs(np.asarray(gf_j)).max()), rtol=0)


@pytest.mark.parametrize("C,need_dfeat", [(1, False), (3, True)])
def test_plain_composite_backward_matches_autograd(C, need_dfeat):
    from recmv_tpu_torch.ops.composite import _composite_tiles_bwd_torch, _composite_tiles_torch

    rng = np.random.RandomState(C)
    B, T, cap, tile, Wt = 2, 4, 90, 8, 2
    cx = _t(rng.rand(B, T, cap) * 16, grad=True)
    cy = _t(rng.rand(B, T, cap) * 16, grad=True)
    cnt = torch.as_tensor(rng.randint(0, cap + 1, (B, T)), dtype=torch.int32)
    val = (torch.arange(cap) < cnt[..., None]).to(torch.float32)
    feat = _t(rng.rand(B, T, C, cap), grad=True)
    g = _t(rng.randn(B, T, C, tile * tile))
    out = _composite_tiles_torch(cx, cy, val, feat, 1 / 9.0, cnt, Wt, tile)
    want = torch.autograd.grad(out, (cx, cy, feat), g)
    got = _composite_tiles_bwd_torch(cx.detach(), cy.detach(), val, feat.detach(), 1 / 9.0,
                                     cnt, Wt, tile, g, need_dfeat)
    for a, b in zip(got, want):
        if a is None:
            assert not need_dfeat
            continue
        _close(a, b.numpy(), atol=1e-5 * float(b.abs().max()), rtol=0)
        live = torch.arange(cap)[None, None] < cnt[..., None]
        assert float(a.movedim(-1, 2)[~live].abs().max()) == 0.0      # zero past the count


def test_composite_tiles_is_differentiable_function():
    """``composite_tiles`` is an autograd.Function whose backward is K3's
    wrapper (on the CPU its plain version)."""
    from recmv_tpu_torch.ops.composite import composite_tiles

    rng = np.random.RandomState(0)
    cx = _t(rng.rand(1, 1, 10) * 8, grad=True)
    val = torch.ones(1, 1, 10)
    out = composite_tiles(cx, cx.detach(), val, torch.ones(1, 1, 1, 10), 0.1,
                          torch.full((1, 1), 10, dtype=torch.int32), 1, 8)
    assert type(out.grad_fn).__name__ == "_CompositeTilesBackward"
    (g,) = torch.autograd.grad(out.sum(), cx)
    assert float(g.abs().max()) > 0


# ---------------------------------------------------------------------------
# (c): differentiable point gradients, Jacobians, the adjoint, the losses
# ---------------------------------------------------------------------------

def _sdf_pair(seed=0):
    from recmv_tpu.models.sdf import init_sdf_net as jinit
    from recmv_tpu_torch.models.sdf import init_sdf_net

    jp, js = jinit(jax.random.PRNGKey(seed), multires=6, bias=0.6,
                   feature_vector_size=16, dims=(64, 64, 64, 64), skip_in=(2,))
    net = init_sdf_net(torch.Generator().manual_seed(0), multires=6, bias=0.6,
                       feature_vector_size=16, dims=(64, 64, 64, 64), skip_in=(2,))
    bridge.load_mlp(net, _np_tree(jp))
    return jp, js, net


def test_sdf_value_and_gradient_differentiable():
    """Values, point gradients, and the gradients of a loss on both with
    respect to the network's parameters; ``sdf_gradient`` with
    ``create_graph`` carries the same graph."""
    from recmv_tpu.models.sdf import sdf_value_and_gradient as jvg
    from recmv_tpu_torch.models.sdf import sdf_gradient, sdf_value_and_gradient

    jp, js, net = _sdf_pair()
    rng = np.random.RandomState(1)
    pts = rng.randn(96, 3).astype(np.float32) * 0.5
    wv, wg = rng.randn(96).astype(np.float32), rng.randn(96, 3).astype(np.float32)

    def jloss(prm):
        v, g = jvg(prm, js, jnp.asarray(pts), 0.7)
        return jnp.sum(v * wv) + jnp.sum(g * wg), (v, g)

    (_, (v_ref, g_ref)), grads_ref = jax.jit(jax.value_and_grad(jloss, has_aux=True))(jp)
    v, g = sdf_value_and_gradient(net, _t(pts), 0.7)
    _close(v, v_ref, atol=1e-5, rtol=1e-4)
    _close(g, g_ref)
    prms = list(net.parameters())
    grads = torch.autograd.grad((v * _t(wv)).sum() + (g * _t(wg)).sum(), prms)
    _assert_tree_close(_module_grads(net, grads), _np_tree(grads_ref))
    g2 = sdf_gradient(net, _t(pts), 0.7, create_graph=True)
    grads2 = torch.autograd.grad((g2 * _t(wg)).sum(), prms, allow_unused=True)
    assert all(x is not None for x in grads2[:-1])
    assert not sdf_gradient(net, _t(pts), 0.7).requires_grad


def _skin_pair():
    from recmv_tpu.models.skinner import initial_lbs_skinner as jinit
    from recmv_tpu.models.smpl import synthetic_body_model as jbody

    apose = np.zeros((24, 3), np.float32)
    apose[1, 2], apose[2, 2], apose[16, 2], apose[17, 2] = 0.17, -0.17, -0.79, 0.79
    sk_j, _, _ = jinit(jbody(n_subdiv=16), jnp.zeros(10), apose, resolution=(9, 13, 7))
    return sk_j, bridge.skinner_from_jax(sk_j, device="cpu")


def test_deformer_jacobian_differentiable():
    """The Jacobian of p ↦ LBS(p + a·p²) and the gradients of a loss on it
    with respect to a, the poses and the translation; the a-gradient runs
    the second derivative of the trilinear weight lookup."""
    from recmv_tpu.models.deformer import deformer_jacobian as jjac
    from recmv_tpu.models.skinner import skinner_apply as japply
    from recmv_tpu_torch.models.deformer import deformer_jacobian
    from recmv_tpu_torch.models.skinner import skinner_apply

    sk_j, sk = _skin_pair()
    rng = np.random.RandomState(10)
    ps = (rng.randn(60, 3) * 0.3).astype(np.float32)
    poses = (rng.randn(2, 24, 3) * 0.2).astype(np.float32)
    trans = rng.randn(2, 3).astype(np.float32)
    inds = rng.randint(0, 2, 60)
    W = rng.randn(60, 3, 3).astype(np.float32)

    def jloss(a, po, tr):
        def deform(p):
            return japply(sk_j, p + a * p ** 2, po, tr, batch_inds=jnp.asarray(inds))
        J = jjac(deform, jnp.asarray(ps))
        return jnp.sum(J * W), J

    (_, J_ref), g_ref = jax.jit(jax.value_and_grad(jloss, argnums=(0, 1, 2), has_aux=True))(
        jnp.asarray(0.5), jnp.asarray(poses), jnp.asarray(trans))
    a, po, tr = _t(0.5, True), _t(poses, True), _t(trans, True)

    def deform(p):
        return skinner_apply(sk, p + a * p ** 2, po, tr, batch_inds=torch.as_tensor(inds))

    J = deformer_jacobian(deform, _t(ps), create_graph=True)
    _close(J, J_ref)
    grads = torch.autograd.grad((J * _t(W)).sum(), (a, po, tr), allow_unused=True)
    assert grads[2] is None and float(np.abs(np.asarray(g_ref[2])).max()) == 0.0
    _close(grads[0], g_ref[0], atol=1e-3, rtol=1e-4)
    _close(grads[1], g_ref[1])
    assert not deformer_jacobian(deform, _t(ps)).requires_grad


def test_grid_sample_second_derivative():
    """The trilinear sampler's second derivative with respect to the
    sample points (the skinner's lookup inside a differentiated Jacobian)."""
    from recmv_tpu.ops.grid_sample import grid_sample_3d as jgs
    from recmv_tpu_torch.ops.grid_sample import grid_sample_3d

    rng = np.random.RandomState(7)
    vol = rng.rand(5, 6, 7, 8).astype(np.float32)
    pts = rng.uniform(-1.2, 1.2, (300, 3)).astype(np.float32)
    w, u = rng.randn(300, 5).astype(np.float32), rng.randn(300, 3).astype(np.float32)

    def jfirst(p):
        return jax.grad(lambda q: jnp.sum(jgs(jnp.asarray(vol), q) * w))(p)

    h_ref = jax.grad(lambda p: jnp.sum(jfirst(p) * u))(jnp.asarray(pts))
    p = _t(pts, True)
    (g,) = torch.autograd.grad((grid_sample_3d(_t(vol), p) * _t(w)).sum(), p,
                               create_graph=True)
    (h,) = torch.autograd.grad((g * _t(u)).sum(), p)
    _close(g, jfirst(jnp.asarray(pts)))
    _close(h, h_ref)


def test_implicit_surface_adjoint():
    """∂L/∂θ through the reattached points against the JAX custom VJP:
    θ = (garment SDF, the deformer's a, the camera centre)."""
    from recmv_tpu.core.surface_ps import make_implicit_surface_adjoint, ray_constraint as jrc
    from recmv_tpu.models.sdf import sdf_value as jsv
    from recmv_tpu.models.skinner import skinner_apply as japply
    from recmv_tpu_torch.core.surface_ps import attach_implicit_surface, ray_constraint
    from recmv_tpu_torch.models.sdf import sdf_value
    from recmv_tpu_torch.models.skinner import skinner_apply

    jp, js, net = _sdf_pair()
    sk_j, sk = _skin_pair()
    rng = np.random.RandomState(12)
    M = 40
    pts = (rng.randn(M, 3) * 0.3).astype(np.float32)
    poses = (rng.randn(2, 24, 3) * 0.2).astype(np.float32)
    trans = rng.randn(2, 3).astype(np.float32)
    inds = rng.randint(0, 2, M)
    origin = np.asarray([0.1, -0.2, 2.5], np.float32)
    rays = pts - origin + rng.randn(M, 3).astype(np.float32) * 0.01
    rays /= np.linalg.norm(rays, axis=1, keepdims=True)
    wts = rng.randn(M, 3).astype(np.float32)

    def jdeform(a, p):
        return japply(sk_j, p + a * p ** 2, jnp.asarray(poses), jnp.asarray(trans),
                      batch_inds=jnp.asarray(inds))

    attach = make_implicit_surface_adjoint(
        lambda prm, p: jsv(prm["sdf"], js, p, 1.0),
        lambda prm, p: jrc(jdeform(prm["a"], p), prm["origin"], jnp.asarray(rays)))
    prm_j = {"sdf": jp, "a": jnp.asarray(0.5), "origin": jnp.asarray(origin)}
    g_ref = jax.jit(jax.grad(lambda prm: jnp.sum(attach(prm, jnp.asarray(pts)) * wts)))(prm_j)

    a, o = _t(0.5, True), _t(origin, True)
    tmp = attach_implicit_surface(
        _t(pts), lambda p: sdf_value(net, p, 1.0),
        lambda p: ray_constraint(skinner_apply(sk, p + a * p ** 2, _t(poses), _t(trans),
                                               batch_inds=torch.as_tensor(inds)), o, _t(rays)))
    np.testing.assert_array_equal(tmp.detach().numpy(), pts)
    prms = list(net.parameters())
    grads = torch.autograd.grad((tmp * _t(wts)).sum(), prms + [a, o])
    assert float(np.abs(np.asarray(g_ref["a"]))) > 1e-3
    _close(grads[-2], g_ref["a"], atol=1e-4, rtol=1e-3)
    _close(grads[-1], g_ref["origin"], atol=1e-4, rtol=1e-3)
    _assert_tree_close(_module_grads(net, grads[:-2]), _np_tree(g_ref["sdf"]),
                       atol=1e-4, rtol=1e-3)


def _loss_cases():
    from recmv_tpu.core import losses as JL
    from recmv_tpu_torch.core import losses as TL

    rng = np.random.RandomState(13)
    M, N = 50, 3
    J = (np.eye(3) + 0.2 * rng.randn(M, 3, 3)).astype(np.float32)
    A = rng.randn(M, 3, 3).astype(np.float32)
    S = (A @ A.transpose(0, 2, 1)).astype(np.float32)
    nx = rng.randn(M, 3).astype(np.float32)
    rays = rng.randn(M, 3).astype(np.float32)
    rays /= np.linalg.norm(rays, axis=1, keepdims=True)
    gtn = rng.randn(M, 3).astype(np.float32)
    gtn[:5] = 0.0                                          # no gt normal there
    R = np.linalg.qr(rng.randn(3, 3))[0].astype(np.float32)
    inds = rng.randint(0, N, M)
    valid = rng.rand(M) > 0.2
    sdfv = rng.randn(M).astype(np.float32) * 0.1
    win = rng.randn(N, 30, 24, 3).astype(np.float32)
    null = np.asarray(__import__("recmv_tpu.ops.math3d", fromlist=["x"]).dct_null_space(10, 30))
    dn = rng.randn(M, 3).astype(np.float32)
    return {
        "sym3x3_eigvalsh": (JL.sym3x3_eigvalsh, TL.sym3x3_eigvalsh, (S,), ()),
        "def_regularization": (lambda j: JL.def_regularization_loss(j, 0.5),
                               lambda j: TL.def_regularization_loss(j, 0.5), (J,), ()),
        "eikonal": (JL.eikonal_loss, TL.eikonal_loss, (nx,), ()),
        "sdf_shrink": (lambda s, v: JL.sdf_shrink_loss(s, 0.01, v),
                       lambda s, v: TL.sdf_shrink_loss(s, 0.01, v), (sdfv,), (valid,)),
        "normal_pullback": (
            lambda j, n: JL.normal_pullback_loss(gtn, j, n, rays, R, inds, valid, N,
                                                 deformed_normals=dn),
            lambda j, n: TL.normal_pullback_loss(_t(gtn), j, n, _t(rays), _t(R),
                                                 torch.as_tensor(inds), torch.as_tensor(valid),
                                                 N, deformed_normals=_t(dn)),
            (J, nx), ()),
        "dct_pose": (lambda w: JL.dct_pose_loss(jnp.asarray(null), w),
                     lambda w: TL.dct_pose_loss(_t(null), w), (win,), ()),
    }


@pytest.mark.parametrize("name", ["sym3x3_eigvalsh", "def_regularization", "eikonal",
                                  "sdf_shrink", "normal_pullback", "dct_pose"])
def test_loss_terms_match_jax(name):
    """Each new ③ term: value, and gradient with respect to its float
    inputs."""
    jfn, tfn, diff, rest = _loss_cases()[name]
    w = None
    ref = jfn(*map(jnp.asarray, diff), *map(jnp.asarray, rest))
    if np.ndim(ref):
        w = np.random.RandomState(1).randn(*np.shape(ref)).astype(np.float32)
    jgrads = jax.grad(lambda *a: jnp.sum(jfn(*a, *map(jnp.asarray, rest)) * (1.0 if w is None else w)),
                      argnums=tuple(range(len(diff))))(*map(jnp.asarray, diff))
    xs = [_t(a, True) for a in diff]
    rest_t = [torch.as_tensor(a) for a in rest]
    out = tfn(*xs, *rest_t)
    _close(out, ref, atol=1e-5, rtol=1e-4)
    grads = torch.autograd.grad((out * (1.0 if w is None else _t(w))).sum(), xs)
    for g, gr in zip(grads, jgrads):
        _close(g, gr, atol=GTOL, rtol=1e-3)


# ---------------------------------------------------------------------------
# (d), (e): the ② and ③ losses and one training step on the slice fixture
# ---------------------------------------------------------------------------

def _train_cfg(cls, **extra):
    return cls(sample_pix=64, point_radius=0.025, remesh_intersect=8,
               mc_capacity_v=1 << 12, mc_capacity_f=1 << 13,
               raster_tile=16, raster_cap_mesh=4096, raster_cap_points=4096,
               solver_times=20, surface_sample=64, **extra)


class _NoPcSdfConf:
    """A config view with the pc-sdf weight ``pc_weight.weight`` at 0."""

    def __init__(self, inner):
        self._inner = inner

    def __getattr__(self, k):
        return getattr(self._inner, k)

    def get_float(self, path, default=None):
        return 0.0 if path == "pc_weight.weight" else self._inner.get_float(path, default)


def _build_pair(root, jdir):
    from recmv_tpu.config import ConfigFactory as JConf
    from recmv_tpu.core.builder import build_opt_net as jbuild
    from recmv_tpu.core.network import TrainConfig as JCfg
    from recmv_tpu.data.dataset import get_dataset_and_loader as jdata
    from recmv_tpu_torch.config import ConfigFactory
    from recmv_tpu_torch.core.builder import build_opt_net
    from recmv_tpu_torch.core.network import TrainConfig
    from recmv_tpu_torch.data.dataset import get_dataset_and_loader

    conf_path = os.path.join(ROOT, "configs", "synthetic", "smoke.conf")
    args = ({"deformer": 256, "render": 256}, 2)
    kw = dict(shuffle=False, garment_type="synthetic-tube", data_type="synthe")
    pyr = ((7, 9, 5), (13, 17, 9))
    ds_j, _ = jdata(jdir, *args, **kw)
    net_j = jbuild(JConf.parse_file(conf_path), ds_j, str(root / "jax"), resolutions=pyr,
                   skinner_res=(17, 25, 9),
                   train_cfg=_train_cfg(JCfg, batch_size=2, image_size=(48, 48),
                                        points_per_pixel=4))
    # main_loss reads the curve names; the builder leaves no curves
    net_j.curve_statics = SimpleNamespace(fl_names=tuple(ds_j.fl_names))
    net_j.conf = _NoPcSdfConf(net_j.conf)
    ds_t, _ = get_dataset_and_loader(jdir, *args, **kw)
    net_t = build_opt_net(ConfigFactory.parse_file(conf_path), ds_t, str(root / "port"),
                          resolutions=pyr, skinner_res=(17, 25, 9),
                          train_cfg=_train_cfg(TrainConfig), device="cpu")
    net_t.conf = _NoPcSdfConf(net_t.conf)
    gsdf = net_j.params["garment_sdfs"][0]
    last = f"lin{len(gsdf) - 1}"
    gsdf[last] = dict(gsdf[last], b=gsdf[last]["b"].at[0].set(GARMENT_SDF_BIAS))
    net_j._init_global_opt()
    # seeded noise on the poses and translations: the scene's motion is
    # smooth, so the DCT prior's high-frequency coefficients of static
    # joints are 0 up to rounding, where |·|'s gradient sign is noise
    rng = np.random.RandomState(0)
    tree = _np_tree(net_j.scene_tree())
    tree["poses"] = tree["poses"] + 0.02 * rng.randn(*tree["poses"].shape).astype(np.float32)
    tree["trans"] = tree["trans"] + 0.01 * rng.randn(*tree["trans"].shape).astype(np.float32)
    net_j._scene_dev = jax.tree_util.tree_map(jnp.asarray, tree)
    bridge.load_jax_params(net_t.params, _np_tree(
        {k: net_j.params[k] for k in ("sdf", "garment_sdfs", "translator", "render",
                                      "skinner")}))
    bridge.load_scene(net_t.scene, tree)
    net_j.marching_cube_update(RATIO)
    net_t.marching_cube_update(RATIO)
    bridge.load_mesh(net_t, net_j.mesh.garment_vs, net_j.mesh.garment_fs,
                     net_j.mesh.garment_n, net_j.mesh.garment_fn)
    return net_j, net_t, ds_j


@pytest.fixture(scope="module")
def nets(tmp_path_factory):
    """Both networks on one 32-frame 48 px synthetic-tube scene (the port's
    generator; more than the DCT window of 30 frames, so the DCT prior
    runs), from one state, and a batch of two frames."""
    from recmv_tpu_torch.data.synthetic import generate_scene

    root = tmp_path_factory.mktemp("torch_train")
    scene = generate_scene(str(root / "scene"), n_frames=32, image_size=48,
                           skinner_res=(17, 25, 9), device="cpu")
    net_j, net_t, ds_j = _build_pair(root, scene)
    return net_j, net_t, ds_j.get_batch(FIDS)


def _jax_leaf(tree, name):
    """The JAX gradient/parameter leaf of a port ``global_leaves`` name,
    in the port's layout."""
    parts = name.split(".")
    if parts[0] == "scene":
        sub = tree["scene"]
        for k in parts[1:]:
            sub = sub[k]
        return np.asarray(sub)
    sub = tree[parts[0]]
    if parts[0] == "garment_sdfs":
        sub = sub[int(parts[1])]
        parts = parts[1:]
    a = np.asarray(sub[f"lin{parts[2]}"][parts[3]])
    return a.T if a.ndim == 2 else a


def _assert_grads_close(names, grads, tree):
    """Per leaf: ‖g_port − g_jax‖ ≤ tol·‖g_jax‖ + 1e-6, tol 1e-2 for the
    leaves whose gradient passes the bf16 translator (its weights and the
    deformer latents), else 1e-4."""
    for name, g in zip(names, grads):
        ref = _jax_leaf(tree, name)
        tol = 1e-2 if name.startswith(("translator", "scene.conds.deformer")) else 1e-4
        err = np.linalg.norm(g.detach().numpy() - ref)
        assert err <= tol * np.linalg.norm(ref) + 1e-6, (name, err, np.linalg.norm(ref))


def _seed_uniforms(key, G, n_pix):
    """Replay find_and_sample_rays' key splits → (uniforms, key)."""
    uniforms = []
    for _ in range(G):
        key, sub = jax.random.split(key)
        uniforms.append(torch.tensor(np.asarray(jax.random.uniform(sub, (n_pix,)))))
    return uniforms, key


def _main_draws(net_j, key, budget):
    """Replay main_loss's per-garment key splits (no curve-aware term)."""
    draws = []
    dr_w = float(net_j.conf.get_float("def_regu.weight", 0.0))
    for gi in range(len(net_j.statics.garment_names)):
        cap = net_j.mesh.garment_vs[gi].shape[0]
        rows = budget + net_j.cfg.surface_sample
        key, _ = jax.random.split(key)
        key, s2 = jax.random.split(key)
        vsel = jax.random.randint(s2, (net_j.cfg.surface_sample,), 0, cap)
        key, s3 = jax.random.split(key)
        local = jax.random.normal(s3, (rows, 3))
        key, s4 = jax.random.split(key)
        glob = jax.random.uniform(s4, (rows // 6, 3), minval=-1.8, maxval=1.8)
        d = dict(vsel=torch.tensor(np.asarray(vsel)).long(), local=_t(local), glob=_t(glob))
        if dr_w > 0:
            key, s5 = jax.random.split(key)
            d["reg"] = _t(jax.random.normal(s5, (rows, 3)))
        draws.append(d)
    return draws


KEY = 3


def _solved_to_torch(solved_j):
    out = []
    for sd in solved_j:
        d = {k: torch.tensor(np.asarray(v)) for k, v in sd.items()}
        for k in ("batch_inds", "rows", "cols"):
            d[k] = d[k].long()
        out.append(d)
    return out


@pytest.fixture(scope="module")
def branch_grads(nets):
    """② and ③ in both packages from one state, with the JAX package's own
    jitted phase functions (``value_and_grad`` of ``pc_branch_loss`` and
    ``main_loss``) and the port's autograd; ③ on the JAX package's solved
    rays and draws. The key is the one ``test_train_step_matches_jax``
    gives the fused step, so these are that step's gradients."""
    net_j, net_t, batch = nets
    local = np.asarray(FIDS)
    fids_j = jnp.asarray(local, jnp.int32)
    fids_t = torch.tensor(local)
    gp = net_j._global_params()
    gt_j = net_j.garment_masks_from_batch(batch)
    vs_j, fs_j = tuple(net_j.mesh.garment_vs), tuple(net_j.mesh.garment_fs)
    counts_j = jnp.asarray(net_j.mesh.garment_n, jnp.int32)
    fns = net_j._get_jitted(len(FIDS), tuple(v.shape[0] for v in vs_j)
                            + tuple(f.shape[0] for f in fs_j))
    r = net_j._ratio_dict(RATIO)
    (pc_j, (info_pc_j, def_j)), (gv_j, gpc_j) = fns["pc"](vs_j, gp, fids_j, gt_j, r, counts_j,
                                                          None)
    from recmv_tpu.models.camera import ang_threshold
    net_j.ang_thred = ang_threshold(net_j._camera(net_j.scene_tree()))
    solved_j, key_m = fns["rays"](gp, fids_j, gt_j, r, jax.random.PRNGKey(KEY), vs_j, fs_j,
                                  def_j)
    win_j = jnp.asarray(net_j._window_ids(local, 30))
    (m_j, info_m_j), gm_j = fns["main"](gp, {}, solved_j, fids_j, jnp.asarray(batch["img"]),
                                        jnp.asarray(batch["normal"]), vs_j, counts_j, win_j, r,
                                        key_m)

    dev = net_t.device_batch(batch)
    gt_t = [dev[k] for k in net_t._garment_mask_keys()]
    counts_t = torch.as_tensor(net_t.mesh.garment_n)
    leaves = net_t.global_leaves()
    names, prms = list(leaves), list(leaves.values())
    vs_t = [v.detach().requires_grad_(True) for v in net_t.mesh.garment_vs]
    pc_t, (info_pc_t, _, _) = net_t.pc_branch_loss(vs_t, fids_t, gt_t, RATIO, counts_t)
    g_pc_t = net_t._grads(pc_t, vs_t + prms)
    solved_t = _solved_to_torch(solved_j)
    win_t = torch.as_tensor(net_t._window_ids(local, 30))
    draws = _main_draws(net_j, key_m, solved_t[0]["pts"].shape[0])
    m_t, info_m_t = net_t.main_loss(solved_t, fids_t, dev, net_t.mesh.garment_vs, counts_t,
                                    win_t, RATIO, draws)
    g_main_t = net_t._grads(m_t, prms)
    return dict(names=names, pc=(pc_j, info_pc_j, gv_j, gpc_j, pc_t, info_pc_t, g_pc_t),
                main=(m_j, info_m_j, gm_j, m_t, info_m_t, g_main_t), win=(win_j, win_t),
                conv=int(np.asarray(solved_j[0]["conv"]).sum()))


def _assert_info_close(info_t, info_j):
    """Every JAX info scalar in the port's, within the module's tolerances:
    the pc-sdf terms (bf16 in both packages, values ~2e-3) within 5e-6
    absolute, the gradient norms within 1e-3 relative, the rest within
    1e-4 relative."""
    for k, v in info_j.items():
        if k.startswith("t_"):
            continue
        bf16 = k.startswith("pc_") and k.endswith("_loss_sdf")
        rtol = 0.0 if bf16 else 1e-3 if k.startswith("gnorm") else 1e-4
        got = info_t[k].detach() if torch.is_tensor(info_t[k]) else info_t[k]
        np.testing.assert_allclose(float(got), float(v), rtol=rtol,
                                   atol=5e-6 if bf16 else 1e-6, err_msg=k)


def test_pc_branch_loss_and_gradients(branch_grads):
    names = branch_grads["names"]
    pc_j, info_j, gv_j, gpc_j, pc_t, info_t, g_t = branch_grads["pc"]
    np.testing.assert_allclose(float(pc_t.detach()), float(pc_j), rtol=1e-4)
    _assert_info_close(info_t, info_j)
    G = len(gv_j)
    for g, ref in zip(g_t[:G], gv_j):
        ref = np.asarray(ref)
        assert np.linalg.norm(ref) > 0
        assert np.linalg.norm(g.numpy() - ref) <= 1e-3 * np.linalg.norm(ref)
    _assert_grads_close(names, g_t[G:], _np_tree(gpc_j))


def test_main_loss_and_gradients(branch_grads):
    names = branch_grads["names"]
    m_j, info_j, gm_j, m_t, info_t, g_t = branch_grads["main"]
    assert branch_grads["conv"] > 10
    assert set(info_t) == set(info_j)
    assert "dct_loss" in info_j
    _assert_info_close(info_t, info_j)
    np.testing.assert_allclose(float(m_t.detach()), float(m_j), rtol=1e-4)
    reached = [n for n, g in zip(names, g_t) if float(g.abs().max()) > 0]
    assert any(n.startswith("garment_sdfs") for n in reached)
    assert any(n.startswith("render") for n in reached)
    assert {"scene.poses", "scene.trans", "scene.camera.world2cam_coord_trans"} <= set(reached)
    _assert_grads_close(names, g_t, _np_tree(gm_j))


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_pc_sdf_term_matches_jax_bf16(nets, dtype):
    """The pc-sdf term |sdf(v) + shrink| over the live mesh vertices, which
    ``main_loss`` evaluates with the garment SDF in bf16 in both packages
    (bf16 operands, f32 accumulation, bf16 hidden activations); its f32
    case is the same term with every layer in f32. Value and each garment
    SDF leaf's gradient against the JAX term of the same type, and in bf16
    also the gradient taken with the JAX signs of sdf + shrink (tolerances
    in the module docstring)."""
    import copy

    from recmv_tpu.core import losses as JL
    from recmv_tpu.models.sdf import sdf_value as jsv
    from recmv_tpu_torch.core import losses as TL
    from recmv_tpu_torch.models.sdf import sdf_value

    net_j, net_t, _ = nets
    prm_j = net_j.params["garment_sdfs"][0]
    gsdf = copy.deepcopy(net_t.params["garment_sdfs"][0])
    bridge.load_mlp(gsdf, _np_tree(prm_j))
    vs = np.asarray(net_j.mesh.garment_vs[0])
    valid = np.arange(vs.shape[0]) < net_j.mesh.garment_n[0]
    j_dtype, t_dtype = {"f32": (None, None), "bf16": (jnp.bfloat16, torch.bfloat16)}[dtype]

    def jloss(prm):
        sdfv = jsv(prm, net_j.statics.garment_sdf, jnp.asarray(vs), 1.0, compute_dtype=j_dtype)
        return JL.sdf_shrink_loss(sdfv, net_j.sdf_shrink, jnp.asarray(valid))

    loss = TL.sdf_shrink_loss(sdf_value(gsdf, _t(vs), 1.0, compute_dtype=t_dtype),
                              net_t.sdf_shrink, torch.as_tensor(valid))
    grads = _module_grads(gsdf, torch.autograd.grad(loss, list(gsdf.parameters())))
    v_j, g_j = jax.value_and_grad(jloss)(prm_j)
    v_tol, g_tol = {"f32": (1e-6, GTOL), "bf16": (5e-6, 0.2)}[dtype]
    np.testing.assert_allclose(float(loss.detach()), float(v_j), atol=v_tol, rtol=0)
    refs = jax.tree_util.tree_leaves_with_path(_np_tree(g_j))
    for path, ref in refs:
        got = grads[path[0].key][path[1].key]
        assert np.linalg.norm(ref) > 0
        assert np.linalg.norm(got - ref) <= g_tol * np.linalg.norm(ref), (dtype, path)
    if dtype == "bf16":
        # the same gradient with the JAX signs of sdf + shrink: the port's
        # bf16 backward alone
        sdf_j = np.asarray(jsv(prm_j, net_j.statics.garment_sdf, jnp.asarray(vs), 1.0,
                               compute_dtype=j_dtype))
        sign = np.where(valid, np.sign(sdf_j + net_j.sdf_shrink), 0.0) / valid.sum()
        lin = (sdf_value(gsdf, _t(vs), 1.0, compute_dtype=t_dtype) * _t(sign)).sum()
        lin_grads = _module_grads(gsdf, torch.autograd.grad(lin, list(gsdf.parameters())))
        for path, ref in refs:
            got = lin_grads[path[0].key][path[1].key]
            assert np.linalg.norm(got - ref) <= 5e-3 * np.linalg.norm(ref), path


def test_dct_window_ids(branch_grads):
    """(f) The DCT windows on the 32-frame scene: the same global frame
    indices in both packages, windows of 30 that the batch's frames sit in."""
    win_j, win_t = branch_grads["win"]
    np.testing.assert_array_equal(win_t.numpy(), np.asarray(win_j))
    assert win_t.shape == (len(FIDS), 30)
    for f, w in zip(FIDS, win_t.numpy()):
        assert w[0] <= f <= w[-1] and np.all(np.diff(w) == 1)


def test_train_step_matches_jax(nets, branch_grads):
    """(e) One whole step in each package from one state: the JAX fused
    step (no curves) with key KEY, the port's ``train_step`` with that
    key's draws replayed. Every info scalar, the SGD-updated vertices and
    the Adam-updated parameters (module docstring); frozen leaves
    unchanged in both."""
    net_j, net_t, batch = nets
    names = branch_grads["names"]
    _, _, _, gpc_j, _, _, _ = branch_grads["pc"]
    _, _, gm_j, _, _, _ = branch_grads["main"]
    before_j = _np_tree(net_j._global_params())
    before_t = {k: v.detach().clone() for k, v in net_t.global_leaves().items()}
    vs_before = [np.asarray(v) for v in net_j.mesh.garment_vs]
    s = net_t.cfg.seed_downscale
    G = len(net_j.statics.garment_names)
    key = jax.random.PRNGKey(KEY)
    uniforms, key_m = _seed_uniforms(key, G, len(FIDS) * (48 // s) ** 2)
    budget = max(net_t.cfg.sample_pix // G, 1) * len(FIDS)
    draws = {"uniforms": uniforms, "main": _main_draws(net_j, key_m, budget)}

    assert net_j._fused_ok and not net_j.cfg.profile_phases
    total_j, info_j = net_j.train_step(batch, FIDS, RATIO, key)
    total_t, info_t = net_t.train_step(batch, FIDS, RATIO, draws=draws)
    _assert_info_close(info_t, info_j)
    for k in ("gnorm_pc", "gnorm_main", "dct_loss"):
        assert info_t[k] > 0
    np.testing.assert_allclose(total_t, total_j, rtol=1e-4)

    vs_t, fs_t = bridge.mesh_to_numpy(net_t)
    for f_j, f_t in zip(net_j.mesh.garment_fs, fs_t):
        np.testing.assert_array_equal(f_t, np.asarray(f_j))
    for v0, vj, vt in zip(vs_before, net_j.mesh.garment_vs, vs_t):
        dj, dt = np.asarray(vj) - v0, vt - v0
        assert np.linalg.norm(dj) > 0
        assert np.linalg.norm(dt - dj) <= 1e-3 * np.linalg.norm(dj)

    after_j = _np_tree(net_j._global_params())
    after_t = net_t.global_leaves()
    lr = float(net_t.global_opt.param_groups[0]["lr"])
    tree_pc, tree_m = _np_tree(gpc_j), _np_tree(gm_j)
    moved = 0
    for name in names:
        dj = _jax_leaf(after_j, name) - _jax_leaf(before_j, name)
        dt = (after_t[name].detach() - before_t[name]).numpy()
        if not net_t._trainable[name]:
            assert not dj.any() and not dt.any(), name
            continue
        g = np.abs(_jax_leaf(tree_pc, name) + _jax_leaf(tree_m, name))
        big = g > 1e-3 * g.max() if g.max() > 0 else np.zeros_like(g, bool)
        # and whose JAX update is at least lr/2, i.e. whose gradient in the
        # step itself is well above Adam's eps
        big &= np.abs(dj) > 0.5 * lr
        np.testing.assert_allclose(dt[big], dj[big], atol=2e-2 * lr, rtol=0, err_msg=name)
        moved += int(big.sum())
    assert moved > 1000
    assert not net_t._trainable["scene.shape"]
    assert not net_t._trainable["scene.camera.cam2world_coord_quat"]
