"""The port's marching cubes and seg3d against the JAX package's, on the
CPU (``recmv_tpu_torch/ops/marching_cubes.py``, ``ops/seg3d.py``).

Volumes are made with numpy from fixed seeds. Tolerances (float32) and
why:
- ``marching_cubes`` against the JAX ``marching_cubes``: vertex order and
  faces exact; vertex positions within two float32 ulps of the largest
  coordinate (``_pos_atol``): the same formula on the same values, but a
  compiler may contract ``(x0 + dx·t)·spacing + origin`` into fused
  multiply-adds (measured one ulp: 1.19e-7 on the noise fields, 0 on the
  sphere);
- against the host ``marching_cubes_host`` (another vertex numbering): the
  same vertices and, through the vertex map, the same faces in the same
  order (both sweep the cells in raster order). The host walks an edge
  from either end and interpolates in grid units before scaling, so a
  coordinate rounds at the grid index's ulp times the spacing and again
  at its own: within ``_grid_atol`` = 2·(max spacing·ulp(max(D, H, W)) +
  ulp(largest coordinate)) (measured 1.9e-6 at coordinates up to 28 and
  spacing 1). ``chip_smoke.py`` phase 19 holds the card's mesh to the
  same bound;
- ``seg3d_dense`` against the JAX one: 1e-6 absolute (the same SDF in
  float32, summed in another order); ``seg3d_forward`` against
  ``seg3d_dense``: equal signs everywhere and, on the voxels next to a
  sign change, the queried values within 1e-6, as ``tests/test_seg3d.py``
  holds the JAX package;
- ``data/synthetic.garment_mesh`` against the JAX one: as the first item.
"""

import numpy as np
import pytest
import torch
from scipy.spatial import cKDTree

import jax.numpy as jnp

from recmv_tpu_torch.ops.marching_cubes import marching_cubes, marching_cubes_np



def _pos_atol(v):
    """Two float32 ulps at the largest coordinate of ``v``."""
    return 2 * float(np.spacing(np.float32(np.abs(v).max(initial=1.0))))


def _grid_atol(shape, spacing, v):
    """Two roundings at the grid index's scale and at the coordinate's."""
    return 2 * (max(spacing) * float(np.spacing(np.float32(max(shape))))
                + float(np.spacing(np.float32(np.abs(v).max(initial=1.0)))))


def _grid(shape, lo=-1.0, hi=1.0):
    axes = [np.linspace(lo, hi, n, dtype=np.float32) for n in shape]
    z, y, x = np.meshgrid(*axes, indexing="ij")
    return x, y, z


def _sphere():
    x, y, z = _grid((33, 33, 33))
    return np.sqrt(x * x + y * y + z * z) - 0.6, 0.0, (-1.0, -1.0, -1.0), (2 / 32,) * 3


def _anisotropic():
    x, y, z = _grid((17, 25, 33))
    vol = np.sqrt((x / 0.8) ** 2 + (y / 0.5) ** 2 + (z / 0.9) ** 2) - 0.5
    return vol.astype(np.float32), 0.13, (0.1, -0.2, 0.3), (0.05, 0.07, 0.03)


def _two_components():
    x, y, z = _grid((29, 21, 25))
    a = np.sqrt((x - 0.45) ** 2 + y * y + z * z) - 0.35
    b = np.sqrt((x + 0.5) ** 2 + (y - 0.2) ** 2 + z * z) - 0.3
    return np.minimum(a, b).astype(np.float32), 0.0, (0.0, 0.0, 0.0), (1.0, 1.0, 1.0)


def _empty():
    return np.ones((9, 11, 13), np.float32), 0.0, (0.0, 0.0, 0.0), (1.0, 1.0, 1.0)


def _noise(seed):
    def make():
        vol = np.random.default_rng(seed).standard_normal((19, 23, 27)).astype(np.float32)
        return vol, 0.1 * seed, (0.5, -0.25, 0.0), (0.02, 0.03, 0.04)
    return make


VOLUMES = {"sphere": _sphere, "anisotropic": _anisotropic, "two_components": _two_components,
           "empty": _empty, "noise0": _noise(0), "noise1": _noise(1)}


@pytest.mark.parametrize("name", list(VOLUMES))
def test_marching_cubes_matches_jax(name):
    """Vertex order and faces exact, positions within ``_pos_atol``."""
    from recmv_tpu.ops.marching_cubes import marching_cubes_np as jax_mc

    vol, level, origin, spacing = VOLUMES[name]()
    vj, fj = jax_mc(vol, level, origin, spacing)
    v, f = marching_cubes_np(vol, level, origin, spacing)
    assert v.dtype == np.float32 and f.dtype == np.int64
    assert v.shape == vj.shape and f.shape == fj.shape
    assert (len(v) == 0) == (name == "empty")
    np.testing.assert_array_equal(f, fj)
    np.testing.assert_allclose(v, vj, atol=_pos_atol(vj), rtol=0)


@pytest.mark.parametrize("name", ["sphere", "anisotropic", "two_components", "noise1"])
def test_marching_cubes_matches_host_up_to_order(name):
    """The host marching cubes numbers vertices by first encounter: the
    same vertices, and the same faces through the vertex map."""
    from recmv_tpu_torch.native import marching_cubes_host

    vol, level, origin, spacing = VOLUMES[name]()
    v, f = marching_cubes_np(vol, level, origin, spacing)
    vh, fh = marching_cubes_host(vol, level, origin, spacing)
    assert v.shape == vh.shape and f.shape == fh.shape
    _, to_port = cKDTree(v).query(vh)
    assert np.array_equal(np.sort(to_port), np.arange(len(v)))
    np.testing.assert_array_equal(to_port[fh], f)
    np.testing.assert_allclose(v[to_port], vh, atol=_grid_atol(vol.shape, spacing, vh), rtol=0)


def test_marching_cubes_overflow_raises():
    vol, level, origin, spacing = _sphere()
    v, f = marching_cubes_np(vol, level, origin, spacing)
    with pytest.raises(ValueError, match="nv="):
        marching_cubes_np(vol, level, origin, spacing, max_verts=len(v) - 1)
    with pytest.raises(ValueError, match="nf="):
        marching_cubes_np(vol, level, origin, spacing, max_faces=len(f) - 1)
    v2, f2 = marching_cubes(torch.as_tensor(vol), level, origin, spacing,
                            max_verts=len(v), max_faces=len(f))
    assert torch.equal(f2, torch.as_tensor(f)) and torch.equal(v2, torch.as_tensor(v))


def _cfg(cls, res0=(9, 9, 9), levels=3):
    resolutions = [tuple(res0)]
    for _ in range(levels - 1):
        resolutions.append(tuple(2 * r - 1 for r in resolutions[-1]))
    return cls(b_min=(-1, -1, -1), b_max=(1, 1, 1), resolutions=tuple(resolutions))


def _blob(lib):
    """A non-convex union of two spheres in ``lib`` (jnp or torch)."""
    def q(pts):
        c = lib.asarray([0.25, 0.0, 0.0])
        d1 = lib.sqrt(((pts - c) ** 2).sum(-1)) - 0.3
        d2 = lib.sqrt(((pts + c) ** 2).sum(-1)) - 0.35
        return lib.minimum(d1, d2)
    return q


def _sign_relevant(dense):
    """Voxels with a neighbour along x, y or z on the other side of 0."""
    inside = dense < 0
    near = np.zeros_like(inside)
    for ax in range(3):
        a = [slice(None)] * 3
        b = [slice(None)] * 3
        a[ax], b[ax] = slice(None, -1), slice(1, None)
        edge = inside[tuple(a)] != inside[tuple(b)]
        near[tuple(a)] |= edge
        near[tuple(b)] |= edge
    return near


def test_seg3d_dense_and_forward_match_jax():
    """``seg3d_dense`` against the JAX one; ``seg3d_forward`` against
    ``seg3d_dense``: the same signs, and the same values next to a sign
    change (the lossless property), then the same mesh."""
    from recmv_tpu.ops.seg3d import Seg3dConfig as JCfg
    from recmv_tpu.ops.seg3d import seg3d_dense as jax_dense
    from recmv_tpu_torch.ops.seg3d import Seg3dConfig, seg3d_dense, seg3d_forward

    dense_j = np.asarray(jax_dense(_blob(jnp), _cfg(JCfg), chunk=4096))
    cfg = _cfg(Seg3dConfig)
    dense = seg3d_dense(_blob(torch), cfg, device="cpu", chunk=4096).numpy()
    assert dense.shape == dense_j.shape == (33, 33, 33)
    np.testing.assert_allclose(dense, dense_j, atol=1e-6, rtol=0)
    lossless = seg3d_forward(_blob(torch), cfg, device="cpu").numpy()
    np.testing.assert_array_equal(lossless > 0, dense > 0)
    near = _sign_relevant(dense)
    assert near.sum() > 1000
    np.testing.assert_allclose(lossless[near], dense[near], atol=1e-6, rtol=0)
    v, f = marching_cubes_np(lossless)
    vd, fd = marching_cubes_np(dense)
    np.testing.assert_array_equal(f, fd)
    np.testing.assert_allclose(v, vd, atol=1e-5, rtol=0)


@pytest.mark.parametrize("piece", [0, 1])
def test_garment_mesh_matches_jax_in_order(piece):
    """The synthetic scene's GT garment meshes come out in the JAX
    package's vertex order (the tube, and the two-garment scene's skirt)."""
    from recmv_tpu.data import synthetic as jsyn
    from recmv_tpu_torch.data import synthetic

    _, off, band, _ = synthetic.SCENE_GARMENTS["synthetic-two"][piece]
    v, f = synthetic.garment_mesh(res=49, offset=off, band=band)
    vj, fj = jsyn.garment_mesh(res=49, offset=off, band=band)
    assert len(v) > 500
    np.testing.assert_array_equal(f, fj)
    np.testing.assert_allclose(v, vj, atol=_pos_atol(vj), rtol=0)
