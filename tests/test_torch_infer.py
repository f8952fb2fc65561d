"""Parity of the port's inference with the JAX package, on the CPU.

Inputs are made with numpy from a seed; the networks, their scene and
their mesh cross from the JAX package into the port through
``recmv_tpu_torch.bridge``. On the CPU the JAX mesh z-buffer takes its
XLA path and the port the plain version of K1.

(a) ``knn`` and ``chamfer_distance`` on well-separated points,
    ``compute_vnorms`` and ``mesh_vertex_normals``;
(b) NRICP: the affine maps, the stiffness and Laplacian terms, and
    ``nricp_fit`` (target mask, static ids, normal gate, distance gate)
    over a few epochs; ``umeyama`` and ``icp``;
(c) ``curve_to_tube_mesh`` and ``refit_curve_scale``;
(d) ``isotropic_remesh`` and ``remesh_registered`` on one input,
    ``sew_upper_bottom`` on the two-garment templates, and the waist
    sewing of ``ensure_registration`` on cached two-garment
    registrations;
(e) ``phong_render`` and ``visible_vertex_mask``;
(f) on a 4-frame 48 px synthetic-tube scene with curves and the JAX
    network's mesh: ``register_garment(remesh=False)`` stage by stage,
    ``offset_filter``,
    ``infer_garment`` with images and colours, ``smooth_scene_poses`` and
    the scene's exchange with ``dataset.params``;
(g) the CLIs ``python -m recmv_tpu_torch.infer`` (with and without
    ``--curves-only``: the tubes against the JAX ``infer_garment_fl``) and
    ``python -m recmv_tpu_torch.infer_animation`` (against the JAX
    ``infer_garment_animation``) with ``--device cpu`` on that scene's
    checkpoint, and the ``--quality higher`` extraction against the JAX
    ``discretize_sdf_host``. The CLIs take the scene's pyramid at every
    ``--quality``.

The registration's production schedules (200 + 100 NRICP epochs) are
shortened here to a few epochs, and its visibility scan runs at 64² in
place of 512² (the plain K1 walks every (pixel, candidate) pair; at 512²
the scan takes ~40 s on one CPU thread). Both are parameters of the same
code path.

Tolerances (float32) and why:
- (a) indices exact (the points are well separated); squared distances
  2e-6 absolute (the expansion cancels: its rounding is relative to
  ‖q‖² ≈ 1, not to the distance); normals 1e-6 (sums in another
  order);
- (b) the terms 1e-5 relative; ``nricp_fit`` 5e-5 absolute after 3
  epochs (measured 1.9e-6): AdamW's first steps are about lr·sign(g),
  and entries whose gradient is near 0 can flip sign on a last-bit
  difference; ``umeyama`` 1e-5, ``icp`` 1e-4 (SVDs of other libraries;
  measured 2.4e-7 and 1.6e-6);
- (c) the tube bit for bit (the same numpy code); the refit 1e-4 after
  5 AdamW steps of lr 1e-3 (measured 1.9e-5: the steps are about
  lr·sign(g), and the smoothness term's near-0 gradients flip sign);
- (d) the remesh gives the same arrays (the same C++ source, built with
  the same flags); the sewing 1e-3 (measured 4.3e-4), and each package
  within 1e-3 of a float64 solve of the same system (measured 5.0e-4
  and 4.7e-4: AᵀA + 1e-8·I has condition number 6e4 on the skirt);
- (e) the same hit masks and visible vertices; colours 1e-5 (the JAX
  XLA raster divides by the area after the edge functions, K1 folds
  1/area into them: barycentrics differ in the last bits);
- (f) the registration's Laplacian alignment within 5e-4 of a float64
  solve (measured 1.4e-4; condition number 6e4), then each NRICP stage,
  fed the JAX package's output of the stage before, 5e-5 (measured
  3.9e-5 coarse, 1.5e-6 refine; fed their own inputs the packages end
  4.4e-4 apart: each refine starts a fresh AdamW, whose first steps are
  about lr·sign(g)); the posed meshes 2e-5 (the bf16 translator rounds partial
  sums that were added in another order; measured 3e-7 to 2.9e-6), the
  posed bodies 1e-5 (measured 2.4e-7); the renders'
  hit masks on all but 0.5% of the pixels and the colours of pixels that
  both hit within 2 of 255 (the posed vertices differ); the RenderNet
  colours: the same face on at least 99% of the hit pixels and the same
  convergence on 99% of those (measured: every pixel), at least half
  converging (measured 74% on the 13×17×9-grid MC garment), and there
  colours within 3 of 255 (measured 0); ``offset_filter``'s lists and
  the smoothing exact;
- (g) the tubes and animated meshes 2e-5 (measured 2.8e-6), the
  ``higher`` extraction's vertices 1e-5 (measured 1.8e-6).
"""

import functools
import os

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from recmv_tpu_torch import bridge
from test_torch_train import _np_tree

ROOT = os.path.join(os.path.dirname(__file__), "..")
IMG = 48
RATIO = {"sdfRatio": 1.0, "deformerRatio": 1.0, "renderRatio": 1.0}
SCAN = 64                  # the visibility scan's image side in (e), (f) and (g)


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    """One intra-op thread (the tests run beside other pytest workers)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _close(got, want, tol, rel=False):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape
    err = np.abs(got - want).max() if got.size else 0.0
    scale = np.abs(want).max() if rel and want.size else 1.0
    assert err <= tol * scale, (err, tol * scale)


def _sphere(res=13, radius=0.5, noise=0.0, seed=0):
    """A closed MC sphere (numpy), optionally with seeded vertex noise."""
    from recmv_tpu_torch.native import marching_cubes_host

    lin = np.linspace(-0.7, 0.7, res, dtype=np.float32)
    z, y, x = np.meshgrid(lin, lin, lin, indexing="ij")
    v, f = marching_cubes_host(np.sqrt(x * x + y * y + z * z) - radius, 0.0,
                               (-0.7, -0.7, -0.7), (lin[1] - lin[0],) * 3)
    if noise:
        v = v + noise * np.random.RandomState(seed).randn(*v.shape).astype(np.float32)
    return v.astype(np.float32), f


# ---------------------------------------------------------------------------
# (a) KNN, normals
# ---------------------------------------------------------------------------

def test_knn_and_chamfer_match_jax():
    from recmv_tpu.ops.knn import chamfer_distance as jcham
    from recmv_tpu.ops.knn import knn as jknn
    from recmv_tpu_torch.ops.knn import chamfer_distance, knn, nn_gather

    rng = np.random.RandomState(0)
    # points on a jittered lattice: every nearest neighbour is unique
    grid = np.stack(np.meshgrid(*[np.arange(12)] * 3, indexing="ij"), -1).reshape(-1, 3)
    ref = (grid + 0.1 * rng.rand(*grid.shape)).astype(np.float32) * 0.1
    q = (ref[rng.choice(len(ref), 700, replace=False)]
         + 0.02 * (rng.rand(700, 3) - 0.5)).astype(np.float32)
    for k, chunk in ((1, 256), (3, 4096)):
        d_j, i_j = jknn(jnp.asarray(q), jnp.asarray(ref), k, chunk)
        d_t, i_t = knn(torch.as_tensor(q), torch.as_tensor(ref), k, chunk)
        np.testing.assert_array_equal(i_t.numpy(), np.asarray(i_j))
        _close(d_t.numpy(), np.asarray(d_j), 2e-6)
    feats = torch.as_tensor(rng.rand(len(ref), 4).astype(np.float32))
    assert nn_gather(feats, i_t).shape == (700, 3, 4)
    _close(chamfer_distance(torch.as_tensor(q), torch.as_tensor(ref), 300).item(),
           float(jcham(jnp.asarray(q), jnp.asarray(ref), 300)), 1e-6, rel=True)


def test_normals_match_jax():
    from recmv_tpu.ops.math3d import compute_vnorms as jvn
    from recmv_tpu.ops.rasterizer import mesh_vertex_normals as jmvn
    from recmv_tpu_torch.ops.math3d import compute_vnorms
    from recmv_tpu_torch.ops.rasterizer import mesh_vertex_normals

    v, f = _sphere(noise=0.01)
    vb = np.stack([v, 1.3 * v])
    _close(compute_vnorms(torch.as_tensor(vb), torch.as_tensor(f)).numpy(),
           np.asarray(jvn(jnp.asarray(vb), jnp.asarray(f, jnp.int32))), 1e-6)
    _close(mesh_vertex_normals(torch.as_tensor(v), torch.as_tensor(f)).numpy(),
           np.asarray(jmvn(jnp.asarray(v), jnp.asarray(f, jnp.int32))), 1e-6)


# ---------------------------------------------------------------------------
# (b) NRICP, ICP
# ---------------------------------------------------------------------------

def _nricp_case():
    """A noisy sphere registered onto a stretched, shifted sphere with a
    target mask (one side hidden), static ids and normals."""
    from recmv_tpu_torch.geometry.mesh_utils import vertex_normals

    sv, sf = _sphere(noise=0.004, seed=1)
    tv, tf = _sphere(res=17, radius=0.5)
    tv = tv * np.asarray([1.15, 0.95, 1.05], np.float32) + np.asarray([0.02, -0.01, 0.0],
                                                                     np.float32)
    tn = vertex_normals(tv, tf).astype(np.float32)
    mask = tv[:, 0] > -0.3
    static = np.arange(0, len(sv), 37)
    return sv, sf, tv, tn, mask, static


def test_nricp_terms_match_jax():
    from recmv_tpu.geometry import nricp as jn
    from recmv_tpu_torch.geometry import nricp as tn_
    from recmv_tpu_torch.geometry.mesh_utils import compute_edges_unique

    rng = np.random.RandomState(3)
    sv, sf, *_ = _nricp_case()
    N = len(sv)
    A = (np.eye(3) + 0.1 * rng.randn(N, 3, 3)).astype(np.float32)
    A[:5] = 0.0                                                 # singular maps
    b = (0.05 * rng.randn(N, 3)).astype(np.float32)
    nrm = rng.randn(N, 3).astype(np.float32)
    edges = compute_edges_unique(sf)
    pj = {"A": jnp.asarray(A), "b": jnp.asarray(b)}
    pt = {"A": torch.as_tensor(A), "b": torch.as_tensor(b)}
    _close(tn_.local_affine_apply(pt, torch.as_tensor(sv)).numpy(),
           np.asarray(jn.local_affine_apply(pj, jnp.asarray(sv))), 1e-6)
    n_t, ok_t = tn_.local_affine_normals(pt, torch.as_tensor(nrm))
    n_j, ok_j = jn.local_affine_normals(pj, jnp.asarray(nrm))
    np.testing.assert_array_equal(ok_t.numpy(), np.asarray(ok_j))
    assert not ok_t[:5].any()
    _close(n_t.numpy(), np.asarray(n_j), 1e-5, rel=True)
    _close(tn_._stiffness(pt, torch.as_tensor(edges), 0.7).item(),
           float(jn._stiffness(pj, jnp.asarray(edges, jnp.int32), 0.7)), 1e-5, rel=True)
    _close(tn_._uniform_laplacian_loss(torch.as_tensor(sv), torch.as_tensor(edges), N).item(),
           float(jn._uniform_laplacian_loss(jnp.asarray(sv), jnp.asarray(edges, jnp.int32), N)),
           1e-5, rel=True)


@pytest.mark.parametrize("max_dist", [None, 0.04])
def test_nricp_fit_matches_jax(max_dist):
    from recmv_tpu.geometry.nricp import NricpConfig as JCfg
    from recmv_tpu.geometry.nricp import nricp_fit as jfit
    from recmv_tpu_torch.geometry.nricp import NricpConfig, nricp_fit

    sv, sf, tv, tn, mask, static = _nricp_case()
    kw = dict(epochs=3, inner_iter=4, first_inner_iter=6, stiffness_weight=(5.0, 1.0),
              milestones=(2,), laplacian_weight=(250.0, 100.0), threshold=0.3, lr=1e-3,
              max_dist=max_dist)
    want = jfit(sv, sf, tv, tn, target_mask=mask, static_ids=static, cfg=JCfg(**kw))
    got = nricp_fit(sv, sf, tv, tn, target_mask=mask, static_ids=static,
                    cfg=NricpConfig(**kw), device="cpu")
    assert got.dtype == np.float32 and got.shape == sv.shape
    assert np.abs(want - sv).max() > 5e-3                     # the fit moved the mesh
    _close(got, want, 5e-5)


def test_umeyama_and_icp_match_jax():
    from scipy.spatial.transform import Rotation

    from recmv_tpu.geometry.icp import icp as jicp
    from recmv_tpu.geometry.icp import snap_points_to_surface as jsnap
    from recmv_tpu.geometry.icp import umeyama as jume
    from recmv_tpu_torch.geometry.icp import icp, snap_points_to_surface, umeyama

    rng = np.random.RandomState(2)
    src = rng.rand(300, 3).astype(np.float32)
    R = Rotation.from_euler("xyz", [0.1, 0.15, -0.1]).as_matrix().astype(np.float32)
    dst = (1.2 * src @ R.T + np.array([0.05, -0.03, 0.08], np.float32)).astype(np.float32)
    for got, want in zip(umeyama(src, dst, device="cpu"), jume(jnp.asarray(src),
                                                               jnp.asarray(dst))):
        _close(got.numpy(), np.asarray(want), 1e-5)
    dst = (src @ R.T + np.array([0.05, -0.03, 0.08], np.float32)).astype(np.float32)
    for got, want in zip(icp(src, dst, iters=15, device="cpu"), jicp(src, dst, iters=15)):
        _close(got.numpy(), np.asarray(want), 1e-4)
    v, f = _sphere()
    pts = 0.45 * src[:20] / np.linalg.norm(src[:20], axis=1, keepdims=True)
    _close(snap_points_to_surface(pts, pts, v, f, device="cpu").numpy(),
           np.asarray(jsnap(pts, pts, v, f)), 1e-6)


# ---------------------------------------------------------------------------
# (c) curve tubes and the scale refit
# ---------------------------------------------------------------------------

def _rings():
    from recmv_tpu_torch.data.synthetic import SCENE_CURVES, boundary_ring
    from recmv_tpu_torch.geometry.polygons import uniform_sample_3d

    return [uniform_sample_3d(boundary_ring(y, offset=off), 200).astype(np.float32)
            for _, y, off in SCENE_CURVES["synthetic-tube"]]


def test_curve_tubes_and_refit_match_jax():
    from recmv_tpu.models.curves import curve_to_tube_mesh as jtube
    from recmv_tpu.models.curves import init_curves as jinit
    from recmv_tpu.models.curves import refit_curve_scale as jrefit
    from recmv_tpu_torch.models.curves import curve_to_tube_mesh, init_curves, refit_curve_scale

    rings = _rings()
    for ring, n in zip(rings, ([0.0, 1.0, 0.0], [0.1, 0.9, 0.2])):
        for got, want in zip(curve_to_tube_mesh(ring, n, 0.003, 6), jtube(ring, n, 0.003, 6)):
            assert got.dtype == want.dtype
            np.testing.assert_array_equal(got, want)
    names = ("neck", "bottom_curve")
    pj, sj = jinit(rings, rings, names)
    pt, st = init_curves(rings, rings, names, device="cpu")
    rng = np.random.RandomState(4)
    targets = {1: rings[1] * 1.05 + 0.01 * rng.randn(*rings[1].shape).astype(np.float32)}
    want = jrefit(pj, sj, targets, steps=5, lr=1e-3)
    got = refit_curve_scale(pt, st, targets, steps=5, lr=1e-3)
    for k in ("scale", "nx_scale"):
        assert np.abs(np.asarray(want[k]) - np.asarray(pj[k])).max() > 1e-3
        _close(got[k].detach().numpy(), np.asarray(want[k]), 1e-4)


# ---------------------------------------------------------------------------
# (d) remesh, waist sewing
# ---------------------------------------------------------------------------

def _open_sphere():
    """The MC sphere with its top cap cut off: an open mesh with one
    labelled boundary loop, a second one below."""
    from recmv_tpu_torch.geometry.mesh_utils import boundary_loops, slice_mesh_by_vertex_ids

    v, f = _sphere(res=17, noise=0.002, seed=5)
    keep = np.nonzero(np.abs(v[:, 1]) < 0.35)[0]
    v, f = slice_mesh_by_vertex_ids(v, f, keep)[:2]
    loops = sorted(boundary_loops(f), key=lambda l: v[l][:, 1].mean())
    return v.astype(np.float32), f, {"bottom_curve": loops[0], "neck": loops[-1]}


def test_remesh_matches_jax():
    from recmv_tpu.core.inference import remesh_registered as jremesh
    from recmv_tpu.native import isotropic_remesh as jiso
    from recmv_tpu_torch.core.inference import remesh_registered
    from recmv_tpu_torch.native import isotropic_remesh

    v, f, labels = _open_sphere()
    for got, want in zip(isotropic_remesh(v, f, 0.03, 3), jiso(v, f, 0.03, 3)):
        np.testing.assert_array_equal(got, want)
    gv, gf, gl = remesh_registered(v, f, labels)
    wv, wf, wl = jremesh(v, f, labels)
    assert len(gv) > len(v)
    np.testing.assert_array_equal(gv, wv)
    np.testing.assert_array_equal(gf, wf)
    assert list(gl) == list(wl) == ["bottom_curve", "neck"]
    for k in wl:
        np.testing.assert_array_equal(gl[k], wl[k])


@pytest.fixture(scope="module")
def body():
    """The synthetic body in the A-pose (port skinner at (17, 25, 9)):
    (verts, faces, joints) numpy."""
    from recmv_tpu_torch.core.builder import apose_from_type
    from recmv_tpu_torch.models.skinner import initial_lbs_skinner
    from recmv_tpu_torch.models.smpl import synthetic_body_model

    sk, vs, fs = initial_lbs_skinner(synthetic_body_model(), torch.zeros(10), apose_from_type(0),
                                     (17, 25, 9))
    return vs.numpy(), np.asarray(fs), sk.Js.numpy()


def _laplacian_f64(verts, faces, cids, targets):
    """The dense Laplacian editing solve of ``laplacian_deform`` (with
    ``smooth``) in float64 with numpy: the system both packages solve in
    float32."""
    from recmv_tpu_torch.geometry.laplacian import uniform_laplacian

    n = len(verts)
    L = uniform_laplacian(np.asarray(faces), n).astype(np.float64)
    C = np.zeros((len(cids), n))
    C[np.arange(len(cids)), cids] = 1.0
    A = np.concatenate([L, C])
    rhs = np.concatenate([L @ np.asarray(verts, np.float64), targets])
    sol = np.linalg.solve(A.T @ A + 1e-8 * np.eye(n), A.T @ rhs)
    np.fill_diagonal(L, 0.0)
    return L @ sol


def test_sew_upper_bottom_matches_jax(body):
    """The skirt's waist sewn onto the upper garment's hem: the packages
    within 1e-3 of each other (measured 4.3e-4) and each within 1e-3 of a
    float64 solve of the same system (measured 5.0e-4 and 4.7e-4); the
    sewing moves the skirt by 0.108."""
    from recmv_tpu.geometry.laplacian import sew_upper_bottom as jsew
    from recmv_tpu_torch.geometry.laplacian import sew_upper_bottom
    from recmv_tpu_torch.geometry.matching import boundary_curve_best_match
    from recmv_tpu_torch.models.garment import garment_templates_from_body

    up, skirt = garment_templates_from_body(("upper_tube", "skirt"), *body)
    lab = skirt.boundary_labels
    static = np.concatenate([lab[k] for k in lab if k != "upper_bottom"])
    args = (up.verts, up.boundary_labels["upper_bottom"], skirt.verts, skirt.faces,
            lab["upper_bottom"])
    want = jsew(*args, static_ids=static)
    got = sew_upper_bottom(*args, static_ids=static, device="cpu")
    assert got.dtype == np.float32
    assert np.abs(want - skirt.verts).max() > 1e-2
    _close(got, want, 1e-3)
    waist = np.asarray(lab["upper_bottom"])
    sel, matched = boundary_curve_best_match(skirt.verts[waist].astype(np.float32),
                                             up.verts[up.boundary_labels["upper_bottom"]])
    ref = _laplacian_f64(skirt.verts, skirt.faces, np.concatenate([waist[sel], static]),
                         np.concatenate([matched, skirt.verts[static]]))
    _close(want, ref, 1e-3)
    _close(got, ref, 1e-3)


# ---------------------------------------------------------------------------
# (e) the Phong render and the visibility scan (kernel K1's plain version)
# ---------------------------------------------------------------------------

def _cams(image, quat=(0.0, 0.0, 1.0, 0.0), trans=(0.02, -0.03, 2.2)):
    from recmv_tpu.models.camera import Camera as JCam
    from recmv_tpu_torch.models.camera import Camera

    f, c = np.float32(1.4 * image), np.float32(image / 2 + 0.3)
    arrs = dict(focal=np.asarray([f, f]), principal=np.asarray([c, c - 0.6]),
                quat=np.asarray(quat, np.float32), trans=np.asarray(trans, np.float32))
    return (JCam(**{k: jnp.asarray(v) for k, v in arrs.items()}, image_size=(image, image)),
            Camera(**{k: torch.as_tensor(v) for k, v in arrs.items()},
                   image_size=(image, image)))


def test_phong_render_matches_jax():
    from recmv_tpu.ops.rasterizer import phong_render as jphong
    from recmv_tpu_torch.ops.rasterizer import (phong_render, rasterize_mesh,
                                                screen_with_cam_z, silhouette_from_fragments)

    v, f = _sphere(res=11, noise=0.01, seed=6)
    col = (0.5 + 0.5 * np.sin(3 * v)).astype(np.float32)
    cam_j, cam_t = _cams(64)
    light = np.asarray([0.3, 1.0, 2.0], np.float32)
    cp = np.asarray([0.0, 0.1, 2.5], np.float32)
    want_rgb, want_hit = jphong(cam_j, jnp.asarray(v), jnp.asarray(f, jnp.int32),
                                jnp.asarray(col), (64, 64), jnp.asarray(light), jnp.asarray(cp),
                                tile=16, cap=512)
    rgb, hit = phong_render(cam_t, torch.as_tensor(v), torch.as_tensor(f),
                            torch.as_tensor(col), (64, 64), torch.as_tensor(light),
                            torch.as_tensor(cp), tile=16, cap=512)
    assert 0.1 < float(hit.float().mean()) < 0.9
    np.testing.assert_array_equal(hit.numpy(), np.asarray(want_hit))
    _close(rgb.numpy(), np.asarray(want_rgb), 1e-5)
    frag = rasterize_mesh(screen_with_cam_z(cam_t, torch.as_tensor(v))[None],
                          torch.as_tensor(f), (64, 64), tile=16)
    np.testing.assert_array_equal(silhouette_from_fragments(frag)[0].numpy() > 0, hit.numpy())


def test_visible_vertex_mask_matches_jax():
    """A noisy sphere with a smaller one inside it: the inner sphere is
    never seen, most of the outer one is."""
    from recmv_tpu.core.inference import visible_vertex_mask as jvis
    from recmv_tpu_torch.core.inference import visible_vertex_mask

    vo, fo = _sphere(res=15, noise=0.005, seed=7)
    vi, fi = _sphere(res=9, radius=0.3)
    v, f = np.concatenate([vo, vi]), np.concatenate([fo, fi + len(vo)])
    got = visible_vertex_mask(v, f, image=SCAN, device="cpu")
    want = np.asarray(jvis(v, f, image=SCAN))
    assert got.dtype == bool and not got[len(vo):].any() and got[:len(vo)].mean() > 0.9
    np.testing.assert_array_equal(got, want)


# ---------------------------------------------------------------------------
# (f) registration and exports on a scene
# ---------------------------------------------------------------------------

def _quick_configs(cls):
    """A few epochs of each NRICP pass, with the production gates."""
    return (cls(epochs=4, inner_iter=3, first_inner_iter=3,
                stiffness_weight=(50.0, 5.0, 0.8), milestones=(1, 2),
                laplacian_weight=(250.0,) * 3, threshold=0.3, lr=1e-3, max_dist=0.04),
            cls(epochs=3, inner_iter=3, first_inner_iter=3, stiffness_weight=(2.0, 0.5),
                milestones=(1,), laplacian_weight=(250.0,) * 2, threshold=0.5, lr=5e-4,
                max_dist=0.04))


@pytest.fixture(scope="module")
def scene_nets(tmp_path_factory):
    """Both networks on one 4-frame 48 px synthetic-tube scene from one
    state: the JAX parameters with the garment sphere moved inside the
    seg3d box, seeded deformer latents and poses, the scene's rings as
    curves, the JAX network's mesh and the body templates."""
    import jax

    from recmv_tpu.models.garment import garment_templates_from_body as jtemplates
    from recmv_tpu_torch.data.synthetic import GARMENT_SDF_BIAS
    from recmv_tpu_torch.models.garment import garment_templates_from_body
    from test_torch_checkpoint import _scene_curves
    from test_torch_init import _build_init_pair

    root = tmp_path_factory.mktemp("infer")
    net_j, net_t = _build_init_pair(root, "synthetic-tube")
    gsdf = net_j.params["garment_sdfs"][0]
    last = f"lin{len(gsdf) - 1}"
    gsdf[last] = dict(gsdf[last], b=gsdf[last]["b"].at[0].set(GARMENT_SDF_BIAS))
    bridge.load_jax_params(net_t.params, _np_tree(
        {k: net_j.params[k] for k in ("sdf", "garment_sdfs", "translator", "render",
                                      "skinner")}))
    rng = np.random.RandomState(0)
    tree = _np_tree(net_j.scene_tree())
    tree["conds"]["deformer"] = (tree["conds"]["deformer"] + 0.3 * rng.randn(
        *tree["conds"]["deformer"].shape)).astype(np.float32)
    tree["poses"] = tree["poses"] + 0.05 * rng.randn(*tree["poses"].shape).astype(np.float32)
    # the body 2.6 further along world z and the camera with it: the same
    # views, but the def1 camera (placed at the mean translation) now sees
    # the garment from 2.6 away instead of from inside it
    tree["trans"] = tree["trans"] + np.asarray([0.0, 0.0, 2.6], np.float32)
    tree["camera"]["world2cam_coord_trans"] = (tree["camera"]["world2cam_coord_trans"]
                                               + np.asarray([0.0, 0.0, 2.6], np.float32))
    net_j._scene_dev = jax.tree_util.tree_map(jnp.asarray, tree)
    bridge.load_scene(net_t.scene, tree)
    for net in (net_j, net_t):
        net.align_fl(*_scene_curves())
    net_j.marching_cube_update(RATIO)
    net_t.marching_cube_update(RATIO)
    bridge.load_mesh(net_t, net_j.mesh.garment_vs, net_j.mesh.garment_fs,
                     net_j.mesh.garment_n, net_j.mesh.garment_fn)
    args = (net_j.statics.garment_names, np.asarray(net_j.tmp_body_vs),
            np.asarray(net_j.tmp_body_fs), np.asarray(net_j.params["skinner"].Js))
    net_j.garment_templates = jtemplates(*args)
    net_t.garment_templates = garment_templates_from_body(*args)
    return net_j, net_t, root


def _mc_garment(net_j):
    from recmv_tpu_torch.geometry.mesh_utils import largest_component

    n, nf = net_j.mesh.garment_n[0], net_j.mesh.garment_fn[0]
    return largest_component(np.asarray(net_j.mesh.garment_vs[0])[:n],
                             np.asarray(net_j.mesh.garment_fs[0])[:nf])


def test_register_garment_matches_jax(scene_nets, monkeypatch):
    """``register_garment(remesh=False)`` from the template and the curves
    to the MC garment, with short NRICP schedules and the scan at SCAN²,
    stage by stage: the same Laplacian system (the curve matching is the
    same numpy) solved by each package within 5e-4 of a float64 solve
    (measured 1.4e-4 and 1.2e-4: AᵀA's condition number is 6e4); the same
    visible vertices; then, each stage fed the JAX package's output of
    the stage before, NRICP coarse and refine within 5e-5, the tolerance
    of ``nricp_fit`` above (measured 3.9e-5 and 1.9e-6), each having moved
    the mesh by more than 5e-4."""
    from recmv_tpu.core import inference as jinf
    from recmv_tpu.geometry.nricp import NricpConfig as JCfg
    from recmv_tpu.models.curves import curves_forward as jcurves
    from recmv_tpu_torch.core import inference as tinf
    from recmv_tpu_torch.geometry.nricp import NricpConfig

    net_j, net_t, _ = scene_nets
    mc_v, mc_f = _mc_garment(net_j)
    curves = np.asarray(jcurves(net_j.params["curves"], net_j.curve_statics))
    cbn = {n: curves[i] for i, n in enumerate(net_j.curve_statics.fl_names)}
    lap, fits = {}, {"jax": [], "port": []}
    j_lap, t_lap, j_fit, t_fit = (jinf.laplacian_deform, tinf.laplacian_deform, jinf.nricp_fit,
                                  tinf.nricp_fit)

    def lap_jax(*a, **kw):
        lap["args"], lap["jax"] = a, np.asarray(j_lap(*a, **kw))
        return lap["jax"]

    def lap_port(*a, **kw):
        lap["port_args"], lap["port"] = a, t_lap(*a, **kw).numpy()
        return torch.as_tensor(lap["jax"])

    def fit_jax(src, *a, **kw):
        fits["jax"].append((np.asarray(src), j_fit(src, *a, **kw), kw["target_mask"]))
        return fits["jax"][-1][1]

    def fit_port(src, *a, **kw):
        src = fits["jax"][len(fits["port"])][0]
        fits["port"].append((src, t_fit(src, *a, **kw), kw["target_mask"]))
        return fits["port"][-1][1]

    for mod, lap_fn, fit_fn in ((jinf, lap_jax, fit_jax), (tinf, lap_port, fit_port)):
        monkeypatch.setattr(mod, "visible_vertex_mask",
                            functools.partial(mod.visible_vertex_mask, image=SCAN))
        monkeypatch.setattr(mod, "laplacian_deform", lap_fn)
        monkeypatch.setattr(mod, "nricp_fit", fit_fn)
    jc, jr = _quick_configs(JCfg)
    tc, tr = _quick_configs(NricpConfig)
    wv, wf, wl = jinf.register_garment(net_j.garment_templates[0], mc_v, mc_f, cbn,
                                       nricp_cfg=jc, refine_cfg=jr, remesh=False)
    times = {}
    gv, gf, gl = tinf.register_garment(net_t.garment_templates[0], mc_v, mc_f, cbn,
                                       nricp_cfg=tc, refine_cfg=tr, remesh=False,
                                       device="cpu", times=times)
    assert list(times) == ["laplacian", "visibility", "nricp_coarse", "remesh",
                           "nricp_refine"]
    for a, b in zip(lap["port_args"], lap["args"]):
        np.testing.assert_array_equal(a, b)
    ref = _laplacian_f64(*lap["args"])
    assert np.abs(lap["jax"] - lap["args"][0]).max() > 5e-3
    _close(lap["jax"], ref, 5e-4)
    _close(lap["port"], ref, 5e-4)
    assert len(fits["jax"]) == len(fits["port"]) == 2
    for (src, want, vis_j), (_, got, vis_t) in zip(fits["jax"], fits["port"]):
        np.testing.assert_array_equal(vis_t, np.asarray(vis_j))
        assert np.abs(want - src).max() > 5e-4
        _close(got, want, 5e-5)
    assert gv.dtype == np.float32
    np.testing.assert_array_equal(gv, fits["port"][-1][1])
    np.testing.assert_array_equal(gf, wf)
    assert list(gl) == list(wl) and all(np.array_equal(gl[k], wl[k]) for k in wl)


def _objs(d):
    from recmv_tpu_torch.utils.io import load_obj

    return {f: load_obj(os.path.join(d, f)) for f in sorted(os.listdir(d)) if f.endswith(".obj")}


def _same_objs(got_dir, want_dir, tol):
    got, want = _objs(got_dir), _objs(want_dir)
    assert list(got) == list(want) and want
    for k in want:
        np.testing.assert_array_equal(got[k][1], want[k][1])
        _close(got[k][0], want[k][0], tol)


def _pngs(d):
    from recmv_tpu_torch.data.png import imread

    return {f: imread(os.path.join(d, f)) for f in sorted(os.listdir(d)) if f.endswith(".png")}


def _same_renders(got_dir, want_dir):
    """The same files; hit masks (non-white) on all but 0.5% of the pixels,
    colours of pixels that both hit within 2 of 255."""
    got, want = _pngs(got_dir), _pngs(want_dir)
    assert list(got) == list(want) and want
    for k in want:
        hg, hw = (got[k] != 255).any(-1), (want[k] != 255).any(-1)
        assert hw.mean() > 0.02, k
        assert (hg != hw).mean() <= 5e-3, k
        both = hg & hw
        assert np.abs(got[k][both].astype(int) - want[k][both].astype(int)).max() <= 2, k


@pytest.fixture(scope="module")
def exports(scene_nets, tmp_path_factory):
    """``infer_garment`` of both packages on frames 0 and 2, with images and
    colours (chunks of 256 pixels), on the MC garment injected as the
    registered mesh (it lies on the SDF's zero level, so the colour pass
    converges). Each colour image's hit mask, face ids and per-pixel
    convergence are recorded."""
    from recmv_tpu.core import inference as jinf
    from recmv_tpu_torch.core import inference as tinf

    net_j, net_t, _ = scene_nets
    root = tmp_path_factory.mktemp("exports")
    reg = _mc_garment(net_j)
    rec = {"jax": {"face": [], "conv": []}, "port": {"face": [], "conv": []}}
    inf_j, inf_t = jinf.GarmentInference(net_j), tinf.GarmentInference(net_t)
    for inf in (inf_j, inf_t):
        inf.registered = {"tube": reg}
    fn = inf_j._color_chunk_fn(256)

    def chunk_j(*args):
        cols, conv = fn(*args)
        rec["jax"]["conv"].append(np.asarray(conv)[np.asarray(args[10])])
        return cols, conv

    inf_j._fn_cache[("color_chunk", 256)] = chunk_j
    port_chunk = inf_t._color_chunk

    def chunk_t(*args):
        cols, conv = port_chunk(*args)
        rec["port"]["conv"].append(conv.numpy())
        return cols, conv

    inf_t._color_chunk = chunk_t

    def recording(fsp, key):
        def call(frag, *a):
            hit, pts, fid = fsp(frag, *a)
            rec[key]["face"].append(np.where(np.asarray(hit), np.asarray(fid), -1).reshape(
                np.asarray(hit).shape[-2:]))
            return hit, pts, fid
        return call

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jinf, "find_surface_points", recording(jinf.find_surface_points, "jax"))
        mp.setattr(tinf, "find_surface_points", recording(tinf.find_surface_points, "port"))
        _, err_j = inf_j.infer_garment([0, 2], RATIO, str(root / "jax"), color_chunk=256)
        _, err_t = inf_t.infer_garment([0, 2], RATIO, str(root / "port"), color_chunk=256)
    return dict(root=root, err=(err_j, err_t), stats=inf_t.stats, rec=rec, inf=(inf_j, inf_t))


def test_infer_garment_meshes_match_jax(exports):
    root = exports["root"]
    _same_objs(root / "port" / "meshs", root / "jax" / "meshs", 2e-5)
    _same_objs(root / "port" / "smpl_meshs", root / "jax" / "smpl_meshs", 1e-5)
    err_j, err_t = exports["err"]
    assert (err_t["maskE"] >= 0).all() and (err_t["maskE"] <= 1).all()
    _close(err_t["maskE"], err_j["maskE"], 5e-3)
    assert set(exports["stats"]["seconds"]) == {"deform", "meshs_obj", "meshs_png_def1",
                                                "colors", "render", "smpl_meshs"}


@pytest.mark.parametrize("family", ["meshs", "def1meshs", "render"])
def test_infer_garment_renders_match_jax(exports, family):
    root = exports["root"]
    _same_renders(root / "port" / family, root / "jax" / family)


def _per_pixel(rec):
    """Per colour image: (face id or −1, converged) per pixel."""
    conv = np.concatenate(rec["conv"])
    out, start = [], 0
    for face in rec["face"]:
        hit = face >= 0
        c = np.zeros(face.shape, bool)
        c[hit] = conv[start:start + hit.sum()]
        start += hit.sum()
        out.append((face, c))
    assert start == len(conv)
    return out


def test_infer_garment_colors_match_jax(exports):
    """RenderNet colours: both packages hit the same face on at least 99%
    of the hit pixels and agree on which of those converged on at least
    99% of them; at least half converge, and there the colours agree
    within 3 of 255."""
    root = exports["root"]
    got, want = _pngs(root / "port" / "colors"), _pngs(root / "jax" / "colors")
    assert list(got) == list(want) == ["0000_tube.png", "0002_tube.png"]
    pj, pt = _per_pixel(exports["rec"]["jax"]), _per_pixel(exports["rec"]["port"])
    assert [c["hit"] for c in exports["stats"]["colors"]] == [int((f >= 0).sum()) for f, _ in pt]
    assert [c["converged"] for c in exports["stats"]["colors"]] == [int(c.sum()) for _, c in pt]
    for k, (fj, cj), (ft, ct) in zip(want, pj, pt):
        hit = fj >= 0
        same = hit & (fj == ft)
        assert hit.sum() > 50 and same.sum() >= 0.99 * hit.sum()
        assert (same & (cj == ct)).sum() >= 0.99 * same.sum()
        agree = same & cj & ct
        assert agree.sum() >= 0.5 * same.sum()
        assert (want[k][~hit] == 255).all() and (got[k][ft < 0] == 255).all()
        assert np.abs(got[k][agree].astype(int) - want[k][agree].astype(int)).max() <= 3


@pytest.mark.parametrize("sigma,count", [(3.0, 500), (0.5, 0), (1.0, 5)])
def test_offset_filter_matches_jax(exports, sigma, count):
    """The same lists on the injected registration, at the default gates
    and at two that flag frames."""
    inf_j, inf_t = exports["inf"]
    want = inf_j.offset_filter(RATIO, chunk=3, sigma=sigma, outlier_count=count)
    got = inf_t.offset_filter(RATIO, chunk=3, sigma=sigma, outlier_count=count)
    assert got == want and len(want["tube"]) == 4
    if count < 500:
        assert want["tube"] != [0, 1, 2, 3]


@pytest.mark.parametrize("ranges", [None, [(1, 3)]])
def test_smooth_scene_poses_matches_jax(ranges):
    from types import SimpleNamespace

    from recmv_tpu.core.inference import smooth_scene_poses as jsmooth
    from recmv_tpu_torch.core.inference import smooth_scene_poses

    rng = np.random.RandomState(8)
    poses = rng.randn(6, 24, 3).astype(np.float32)
    trans = rng.randn(6, 3).astype(np.float32)
    out = []
    for fn in (jsmooth, smooth_scene_poses):
        ds = SimpleNamespace(params=SimpleNamespace(poses=poses.copy(), trans=trans.copy()))
        fn(ds, ranges=ranges)
        out.append(ds.params)
    want, got = out
    np.testing.assert_array_equal(got.poses, want.poses)
    np.testing.assert_array_equal(got.trans, want.trans)
    assert not np.array_equal(got.poses[1:3], poses[1:3])
    if ranges:
        np.testing.assert_array_equal(got.poses[3:], poses[3:])


def test_scene_sync_round_trip(scene_nets):
    """``sync_scene_to_dataset`` copies the scene leaves into
    ``dataset.params``; ``invalidate_scene`` copies them back in place."""
    _, net_t, _ = scene_nets
    leaf = net_t.scene["poses"]
    before = leaf.detach().clone()
    net_t.sync_scene_to_dataset()
    sp = net_t.dataset.params
    np.testing.assert_array_equal(sp.poses, before.numpy())
    sp.poses = sp.poses + 1.0
    sp.poses[0] += 1.0
    assert torch.equal(leaf, before)
    net_t.invalidate_scene()
    assert net_t.scene["poses"] is leaf
    np.testing.assert_array_equal(leaf.detach().numpy(), sp.poses)
    with torch.no_grad():
        leaf.copy_(before)
    net_t.sync_scene_to_dataset()


# ---------------------------------------------------------------------------
# (g) the CLIs
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def fitted(scene_nets):
    """The port network's state saved as a fitted scene: ``latest.ckpt``
    and ``config.conf`` beside the skinner cache."""
    from recmv_tpu_torch.config import ConfigFactory, dump_config

    _, net_t, root = scene_nets
    save = root / "port"
    net_t.save_checkpoint(str(save / "latest.ckpt"), epoch=1)
    conf = ConfigFactory.parse_file(os.path.join(ROOT, "configs", "synthetic", "smoke.conf"))
    (save / "config.conf").write_text(dump_config(conf))
    return str(root / "scene"), str(save)


def _quick_cli(monkeypatch):
    """The CLIs at test size: the scene's pyramid (7, 9, 5) → (13, 17, 9)
    at every ``--quality``, and for ``register_garment`` short NRICP
    schedules and the scan at SCAN²."""
    from recmv_tpu_torch.core import builder
    from recmv_tpu_torch.core import inference as tinf
    from recmv_tpu_torch.geometry.nricp import NricpConfig

    pyramid = builder.resolution_pyramids("tiny")
    monkeypatch.setattr(builder, "resolution_pyramids", lambda level: pyramid)
    coarse, refine = _quick_configs(NricpConfig)
    orig = tinf.register_garment

    def quick(*a, **kw):
        return orig(*a, **dict(kw, nricp_cfg=coarse, refine_cfg=refine))

    monkeypatch.setattr(tinf, "register_garment", quick)
    monkeypatch.setattr(tinf, "visible_vertex_mask",
                        functools.partial(tinf.visible_vertex_mask, image=SCAN))


@pytest.fixture(scope="module")
def cli_infer(fitted, tmp_path_factory):
    """``python -m recmv_tpu_torch.infer --device cpu`` with smoothing, the
    offset filter, images and colours on frames 0 and 3 → (the
    ``GarmentInference`` it returns, its output directory)."""
    from recmv_tpu_torch import infer

    scene, save = fitted
    out = str(tmp_path_factory.mktemp("cli") / "infer")
    with pytest.MonkeyPatch.context() as mp:
        _quick_cli(mp)
        inf = infer.main(["--data-root", scene, "--save-folder", save, "--device", "cpu",
                          "--frames", "0", "3", "--out", out, "--smooth", "--offset-filter"])
    return inf, out


def test_infer_cli_on_the_cpu(scene_nets, fitted, cli_infer, tmp_path, monkeypatch):
    """Every export family of the CLI run, the registration's cache,
    ``maskE``; the templates rebuilt as the JAX ``load_net`` does.
    ``--curves-only`` gives the JAX package's tubes of the same
    checkpoint; with ``--quality higher`` the body and garments are
    extracted afresh into the host path's buffers and are the JAX
    ``discretize_sdf_host`` meshes (the same counts and faces, vertices
    within 1e-5). Without ``--device`` the CLI needs the card."""
    from recmv_tpu.core.inference import GarmentInference as JInf
    from recmv_tpu.models.garment import garment_templates_from_body as jtemplates
    from recmv_tpu_torch import infer

    net_j = scene_nets[0]
    scene, save = fitted
    inf, out = cli_infer
    want = jtemplates(net_j.statics.garment_names, np.asarray(net_j.tmp_body_vs),
                      np.asarray(net_j.tmp_body_fs), np.asarray(net_j.params["skinner"].Js))
    got = inf.net.garment_templates
    assert [t.name for t in got] == [t.name for t in want] == ["tube"]
    np.testing.assert_array_equal(got[0].verts, want[0].verts)
    assert list(inf.filter_list) == ["tube"] and len(inf.filter_list["tube"]) == 4
    assert set(os.listdir(out)) == {"meshs", "smpl_meshs", "render", "def1meshs", "colors",
                                    "registry_tube.obj", "registry_tube_labels.npz",
                                    "maskE.npy"}
    for sub, n in (("meshs", 4), ("smpl_meshs", 2), ("render", 2), ("def1meshs", 2),
                   ("colors", 2)):
        assert len(os.listdir(os.path.join(out, sub))) == n, sub
    mask_e = np.load(os.path.join(out, "maskE.npy"))
    assert mask_e.shape == (2,) and ((mask_e >= 0) & (mask_e <= 1)).all()
    rv, _ = inf.registered["tube"]
    assert len(rv) > len(want[0].verts)                      # the remesh ran
    assert set(np.load(os.path.join(out, "registry_tube_labels.npz")).files) == {
        "neck", "bottom_curve"}

    _quick_cli(monkeypatch)
    base = ["--data-root", scene, "--save-folder", save]
    fl = str(tmp_path / "fl")
    net = infer.main(base + ["--device", "cpu", "--quality", "higher", "--frames", "1", "2",
                             "--out", fl, "--curves-only"]).net
    JInf(net_j).infer_garment_fl(np.asarray([1, 2]), RATIO, str(tmp_path / "jax_fl"))
    _same_objs(os.path.join(fl, "fl_meshs"), tmp_path / "jax_fl", 2e-5)
    # the clip boxes the checkpoint load recovered from the templates
    monkeypatch.setattr(net_j, "garment_extract_bboxes", net.garment_extract_bboxes,
                        raising=False)
    body_mc, *garments_mc = net_j.discretize_sdf_host(RATIO, -net_j.sdf_shrink)
    mesh = net.mesh
    assert mesh.body_n == len(body_mc[0]) > 0
    for gi, (wv, wf) in enumerate(garments_mc):
        n, nf = mesh.garment_n[gi], mesh.garment_fn[gi]
        assert (n, nf) == (len(wv), len(wf)) and n > 50
        np.testing.assert_array_equal(mesh.garment_fs[gi][:nf].numpy(), wf)
        _close(mesh.garment_vs[gi][:n].numpy(), wv, 1e-5)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        infer.main(base + ["--curves-only"])


def test_infer_animation_cli_on_the_cpu(scene_nets, fitted, cli_infer, tmp_path, monkeypatch):
    """``python -m recmv_tpu_torch.infer_animation --device cpu`` on a
    three-pose motion, in an output directory that holds the CLI run's
    registration (a cache hit): its meshes are the JAX package's animation
    of that registration."""
    import shutil

    from recmv_tpu.core.inference import GarmentInference as JInf
    from recmv_tpu_torch import infer_animation
    from recmv_tpu_torch.data.synthetic import apose
    from recmv_tpu_torch.utils.io import load_obj

    net_j = scene_nets[0]
    scene, save = fitted
    out = str(tmp_path / "anim")
    os.makedirs(out)
    for f in ("registry_tube.obj", "registry_tube_labels.npz"):
        shutil.copy(os.path.join(cli_infer[1], f), out)
    poses = np.stack([apose()] * 3)
    poses[:, 0, 1] = [0.0, 0.7, 1.4]
    motion_trans = np.asarray([[0.0, 0.0, 0.0], [0.03, 0.0, 0.0], [0.06, 0.01, 0.0]],
                              np.float32)
    motion = str(tmp_path / "motion.npz")
    np.savez(motion, pose=poses.reshape(3, 72), trans=motion_trans)
    _quick_cli(monkeypatch)
    inf = infer_animation.main(["--data-root", scene, "--save-folder", save, "--motion", motion,
                                "--device", "cpu", "--out", out])
    assert not inf.registration_times                     # the cache served
    inf_j = JInf(net_j)
    inf_j.registered = {"tube": load_obj(os.path.join(out, "registry_tube.obj"))}
    trans = motion_trans + np.asarray(net_j.scene_tree()["trans"]).mean(0, keepdims=True)
    inf_j.infer_garment_animation(poses.reshape(3, 72), trans, RATIO, str(tmp_path / "jax"))
    got = sorted(f for f in os.listdir(out) if f.endswith(".obj") and "registry" not in f)
    assert got == ["0000_tube.obj", "0001_tube.obj", "0002_tube.obj"]
    want = _objs(tmp_path / "jax")
    for f in got:
        gv, gf = load_obj(os.path.join(out, f))
        np.testing.assert_array_equal(gf, want[f][1])
        _close(gv, want[f][0], 2e-5)


def test_ensure_registration_sews_two_garments_like_jax(body, tmp_path):
    """``ensure_registration`` of a two-garment subject whose registrations
    are cached (the body templates stand for them): both packages load
    the meshes and labels, sew the skirt's waist onto the upper garment's
    (1e-3, the sewing's tolerance above), rewrite the skirt's cache and
    leave the marker; a second call finds the marker and sews no more."""
    from types import SimpleNamespace

    from recmv_tpu.core.inference import GarmentInference as JInf
    from recmv_tpu.models.curves import init_curves as jinit
    from recmv_tpu_torch.core.inference import GarmentInference
    from recmv_tpu_torch.models.curves import init_curves
    from recmv_tpu_torch.models.garment import garment_templates_from_body
    from recmv_tpu_torch.utils.io import load_obj, save_obj

    names = ("upper_tube", "skirt")
    tmpls = garment_templates_from_body(names, *body)
    rings, fl = _rings(), ("neck", "bottom_curve")
    outs = {}
    for pkg in ("jax", "port"):
        out = str(tmp_path / pkg)
        for t in tmpls:
            save_obj(os.path.join(out, f"registry_{t.name}.obj"), t.verts, t.faces)
            np.savez(os.path.join(out, f"registry_{t.name}_labels.npz"),
                     **{k: np.asarray(v, np.int64) for k, v in t.boundary_labels.items()})
        params, statics = (jinit(rings, rings, fl) if pkg == "jax"
                           else init_curves(rings, rings, fl, device="cpu"))
        net = SimpleNamespace(mesh=object(), garment_templates=tmpls, params={"curves": params},
                              curve_statics=statics, statics=SimpleNamespace(garment_names=names),
                              device=torch.device("cpu"))
        inf = (JInf if pkg == "jax" else GarmentInference)(net)
        reg = inf.ensure_registration(RATIO, out)
        assert os.path.isfile(os.path.join(out, "registry_sewn.marker"))
        np.testing.assert_array_equal(load_obj(os.path.join(out, "registry_skirt.obj"))[0],
                                      np.asarray(reg["skirt"][0], np.float32))
        again = (JInf if pkg == "jax" else GarmentInference)(net)
        np.testing.assert_array_equal(again.ensure_registration(RATIO, out)["skirt"][0],
                                      np.asarray(reg["skirt"][0], np.float32))
        outs[pkg] = reg
    skirt = tmpls[1]
    assert np.abs(outs["jax"]["skirt"][0] - skirt.verts).max() > 1e-2
    np.testing.assert_array_equal(outs["port"]["upper_tube"][0], outs["jax"]["upper_tube"][0])
    _close(outs["port"]["skirt"][0], outs["jax"]["skirt"][0], 1e-3)
