"""Parity of the port's rasterizer and its two kernels' plain versions with
the JAX package's Pallas backend (run in interpret mode on the CPU, as
``tests/test_rasterizer.py`` runs it).

Tolerances: bin indices and counts exactly equal; mesh face ids equal
except at ties on shared edges (≤ 0.1% of covered pixels), zbuf and
barycentrics within 1e-5 where the ids agree; composited values within
1e-5 absolute; canonical points interpolated from O(1) vertices within
1e-5 absolute plus 1e-5 relative (float32, sums in another order).

The CUDA kernels are held to these plain versions in
``tests/test_torch_kernels.py``, which runs on the card.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from recmv_tpu.ops import rasterizer as jr
from recmv_tpu_torch.ops import rasterizer as tr


def _bin_inputs(seed, P=300, n_frames=1):
    rng = np.random.RandomState(seed)
    x = rng.rand(n_frames, P) * 128
    y = rng.rand(n_frames, P) * 128
    r = rng.rand(n_frames, P) * 20
    z = np.round(rng.rand(n_frames, P) * 4, 1)          # repeated depths: ties in zq
    valid = rng.rand(n_frames, P) > 0.1
    f = lambda a: np.floor(a / 32).astype(np.int32)
    return f(x - r), f(x + r), f(y - r), f(y + r), z.astype(np.float32), valid


@pytest.mark.parametrize("cap", [16, 300], ids=["overflow", "fits"])
def test_bin_sorted_matches_jax(cap):
    tx0, tx1, ty0, ty1, z, valid = _bin_inputs(0, n_frames=2)
    out = tr._bin_sorted(*(torch.as_tensor(a).long() for a in (tx0, tx1, ty0, ty1)),
                         torch.as_tensor(z), torch.as_tensor(valid), 4, 4, cap)
    for b in range(2):
        ref = jr._bin_sorted(*(jnp.asarray(a[b]) for a in (tx0, tx1, ty0, ty1, z, valid)),
                             4, 4, cap)
        for got, want in zip(out, ref):
            np.testing.assert_array_equal(got[b].numpy(), np.asarray(want))
    if cap == 16:
        assert int(out[2].max()) == 16


def _random_tris(seed, V=90, F=60, size=64):
    rng = np.random.RandomState(seed)
    verts = np.stack([rng.rand(V) * size, rng.rand(V) * size, 1.0 + rng.rand(V)], 1)
    return verts.astype(np.float32), rng.randint(0, V, (F, 3)).astype(np.int32)


@pytest.mark.parametrize("cap", [8, 64], ids=["overflow", "fits"])
def test_rasterize_mesh_matches_pallas(cap):
    verts, faces = _random_tris(0)
    ref = jr.rasterize_mesh(jnp.asarray(verts), jnp.asarray(faces), (64, 64), tile=32,
                            cap=cap, backend="pallas_interpret")
    fr = tr.rasterize_mesh(torch.as_tensor(verts)[None], torch.as_tensor(faces), (64, 64),
                           tile=32, cap=cap)
    f_ref = np.asarray(ref.pix_to_face)
    f = fr.pix_to_face[0].numpy()
    covered = f_ref >= 0
    assert covered.sum() > 500
    same = f == f_ref
    assert (~same).sum() <= max(1, int(1e-3 * covered.sum()))
    np.testing.assert_allclose(fr.zbuf[0].numpy()[same], np.asarray(ref.zbuf)[same], atol=1e-5)
    np.testing.assert_allclose(fr.bary_coords[0].numpy()[same],
                               np.asarray(ref.bary_coords)[same], atol=1e-5)


def test_rasterize_mesh_batch_equals_frames():
    (v0, faces), (v1, _) = _random_tris(1), _random_tris(2)
    both = tr.rasterize_mesh(torch.as_tensor(np.stack([v0, v1])), torch.as_tensor(faces),
                             (48, 40), tile=16, cap=32)
    for b, v in enumerate((v0, v1)):
        one = tr.rasterize_mesh(torch.as_tensor(v)[None], torch.as_tensor(faces), (48, 40),
                                tile=16, cap=32)
        for got, want in zip(both, one):
            np.testing.assert_array_equal(got[b].numpy(), want[0].numpy())


def _cloud(n, seed):
    rng = np.random.RandomState(seed)
    return np.stack([rng.rand(n) * 64, rng.rand(n) * 64, 1.0 + rng.rand(n)], 1).astype(np.float32)


@pytest.mark.parametrize("cap,n", [(128, 300), (512, 300)], ids=["overflow", "fits"])
def test_composite_points_matches_pallas(cap, n):
    pts = _cloud(n, 4)
    pts[::17, 2] = -1.0                                  # behind the camera: skipped
    feats = np.random.RandomState(5).rand(n, 2).astype(np.float32)
    ref = jr.composite_points(jnp.asarray(pts), 0.07, jnp.asarray(feats), (64, 64), tile=32,
                              cap=cap, backend="pallas_interpret")
    img = tr.composite_points(torch.as_tensor(pts)[None], 0.07, torch.as_tensor(feats),
                              (64, 64), tile=32, cap=cap)
    np.testing.assert_allclose(img[0].numpy(), np.asarray(ref), atol=1e-5)
    assert float(img.max()) > 0.5


def test_find_surface_points_interpolates_canonical_verts():
    verts, faces = _random_tris(3)
    cano = np.random.RandomState(3).randn(*verts.shape).astype(np.float32)
    frag_j = jr.rasterize_mesh(jnp.asarray(verts), jnp.asarray(faces), (64, 64), tile=32,
                               cap=64, backend="pallas_interpret")
    hit_j, pts_j, fid_j = jr.find_surface_points(frag_j, jnp.asarray(cano), jnp.asarray(faces))
    frag = tr.rasterize_mesh(torch.as_tensor(verts)[None], torch.as_tensor(faces), (64, 64),
                             tile=32, cap=64)
    hit, pts, fid = tr.find_surface_points(frag, torch.as_tensor(cano), torch.as_tensor(faces))
    same = (fid[0].numpy() == np.asarray(fid_j)) & hit[0].numpy()
    assert same.sum() >= 0.999 * np.asarray(hit_j).sum()
    np.testing.assert_allclose(pts[0].numpy()[same], np.asarray(pts_j)[same], atol=1e-5,
                               rtol=1e-5)
