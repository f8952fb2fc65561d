"""Copy of ``recmv_tpu/geometry/polygons.py``, kept byte-for-byte apart from this note and
its imports: the port runs where JAX is absent, and importing any
``recmv_tpu`` module imports JAX.

Polygon resampling — parity with ``engineer/utils/polygons.py``:
arc-length uniform resampling of closed 2D/3D polylines and farthest
point sampling. Host-side numpy (feeds one-time curve initialization)."""

from __future__ import annotations

import numpy as np


def uniform_sample(polygon: np.ndarray, n_new: int) -> np.ndarray:
    """Closed polygon (P, C) → (n_new, C), points distributed along edges
    proportionally to edge length (polygons.py:49-131 semantics: the
    duplicated closing point is dropped; when downsampling, shortest
    edges' points are removed)."""
    pg = np.asarray(polygon, np.float64)
    pnum = pg.shape[0]
    nxt = (np.arange(pnum) + 1) % pnum
    nxt = nxt[:-1]
    pg_next = pg[nxt]
    pg = pg[:-1]
    pnum = pg.shape[0]
    elen = np.linalg.norm(pg_next - pg, axis=1)

    if pnum > n_new:
        elen2 = elen.copy()
        elen2[0] = 0.0
        elen2[-1] = 0.0
        keep = np.sort(np.argsort(elen2)[pnum - n_new:])
        return pg[keep]

    edgenum = np.round(elen * n_new / elen.sum()).astype(np.int64)
    edgenum = np.maximum(edgenum, 1)
    diff = edgenum.sum() - n_new
    order = np.argsort(elen)
    if diff > 0:
        # drop surplus samples from the longest edges first
        for e in order[::-1]:
            if diff <= 0:
                break
            take = min(diff, edgenum[e] - 1)
            edgenum[e] -= take
            diff -= take
    elif diff < 0:
        edgenum[order[-1]] += -diff
    assert edgenum.sum() == n_new

    out = []
    for i in range(pnum):
        w = np.arange(edgenum[i], dtype=np.float64)[:, None] / edgenum[i]
        out.append(pg[i] * (1 - w) + pg_next[i] * w)
    return np.concatenate(out, axis=0)


def uniform_sample_3d(polygon: np.ndarray, n_new: int) -> np.ndarray:
    pg = np.asarray(polygon)
    assert pg.shape[1] == 3
    return uniform_sample(pg, n_new)


def farthest_point_sample(xyz: np.ndarray, npoint: int) -> np.ndarray:
    """(N, 3) → (npoint,) indices; first pick = farthest from barycenter
    (polygons.py:12-47)."""
    xyz = np.asarray(xyz, np.float64)
    N = xyz.shape[0]
    out = np.zeros(npoint, np.int64)
    dist = np.full(N, 1e18)
    bary = xyz.mean(0, keepdims=True)
    farthest = int(np.argmax(((xyz - bary) ** 2).sum(-1)))
    for i in range(npoint):
        out[i] = farthest
        d = ((xyz - xyz[farthest]) ** 2).sum(-1)
        dist = np.minimum(dist, d)
        farthest = int(np.argmax(dist))
    return out


def resample_loop_arclength(points: np.ndarray, n: int) -> np.ndarray:
    """Exact arc-length uniform resampling of a closed loop (used where
    exact uniformity matters more than keeping original points)."""
    p = np.asarray(points, np.float64)
    seg = np.linalg.norm(np.roll(p, -1, 0) - p, axis=1)
    cum = np.concatenate([[0.0], np.cumsum(seg)])
    total = cum[-1]
    t = np.linspace(0, total, n, endpoint=False)
    idx = np.searchsorted(cum, t, side="right") - 1
    idx = np.clip(idx, 0, len(p) - 1)
    local = (t - cum[idx]) / np.clip(seg[idx], 1e-12, None)
    nxt = (idx + 1) % len(p)
    return p[idx] * (1 - local[:, None]) + p[nxt] * local[:, None]
