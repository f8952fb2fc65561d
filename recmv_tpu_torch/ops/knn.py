"""Nearest-neighbour search (counterpart of ``recmv_tpu/ops/knn.py``):
brute force over chunks of queries, each chunk one (chunk × R) matrix of
squared distances ‖q‖² − 2q·r + ‖r‖² (a float32 GEMM, TF32 off, as the
JAX code's ``Precision.HIGHEST``), then the k smallest per row; the
distances clamp at 0. Ties go to the lowest reference index, as
``jax.lax.top_k``'s do (``torch.min`` for k = 1, a stable sort above)."""

from __future__ import annotations

import torch


def knn(query: torch.Tensor, ref: torch.Tensor, k: int = 1, chunk: int = 4096):
    """query (Q, 3), ref (R, 3) → (dists2 (Q, k), idx (Q, k) int64), nearest
    first."""
    ref_sq = torch.sum(ref * ref, dim=-1)
    ds, ids = [], []
    for s in range(0, query.shape[0], chunk):
        qc = query[s:s + chunk]
        d2 = torch.sum(qc * qc, dim=-1)[:, None] - 2.0 * (qc @ ref.T) + ref_sq[None]
        if k == 1:
            d, i = torch.min(d2, dim=1, keepdim=True)
        else:
            d, i = torch.sort(d2, dim=1, stable=True)
            d, i = d[:, :k], i[:, :k]
        ds.append(d)
        ids.append(i)
    if not ds:
        return (query.new_zeros((0, k)),
                torch.zeros((0, k), dtype=torch.int64, device=query.device))
    return torch.clamp(torch.cat(ds), min=0.0), torch.cat(ids)


def nn_gather(ref_feats: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """ref_feats (R, C), idx (Q, k) → (Q, k, C)."""
    return ref_feats[idx]


def chamfer_distance(a: torch.Tensor, b: torch.Tensor, chunk: int = 4096) -> torch.Tensor:
    """Symmetric mean squared chamfer between point sets (pytorch3d
    ``chamfer_distance`` semantics: the mean over points of the squared
    nearest distance, summed both ways)."""
    d_ab, _ = knn(a, b, 1, chunk)
    d_ba, _ = knn(b, a, 1, chunk)
    return torch.mean(d_ab) + torch.mean(d_ba)
