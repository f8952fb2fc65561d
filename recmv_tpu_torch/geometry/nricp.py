"""Non-rigid ICP with per-vertex local affines (counterpart of
``recmv_tpu/geometry/nricp.py``; the reference's
``engineer/optimizer/nricp_optimizer.py:35-450``, Amberg et al. CVPR'07
with normal gating): per source vertex a learnable affine (A_i, b_i), loss

    Σ gated ‖A_i v_i + b_i − nn(v_i)‖²  (normal-cosine gate > threshold,
                                          boundary + singular-A excluded)
  + stiffness_weight · Σ_edges ‖(W_i − W_j) G‖²   (G = diag(1, 1, 1, γ))
  + static Σ ‖moved static pts − original‖²
  + laplacian_weight · uniform mesh Laplacian magnitude,
  total = sqrt(vert + stiff + static + 1e-12) + laplacian,

optimized by AdamW (weight decay 1e-4, optax's ``adamw`` default; torch's
is 1e-2); correspondences refreshed each outer epoch by the chunked KNN;
stiffness and Laplacian weights stepped down at milestones.

The gate is computed without a graph (the JAX ``stop_gradient``), so the
analytic backward of ``fast_3x3_inv`` never reaches the loss. The inner
loop reads nothing back from the device.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from .. import resolve_device
from ..ops.knn import knn
from ..ops.math3d import compute_vnorms, fast_3x3_inv
from .mesh_utils import compute_edges_unique, mesh_boundary_mask


def local_affine_apply(params, verts):
    """(A (N, 3, 3), b (N, 3)) applied pointwise."""
    return torch.einsum("nij,nj->ni", params["A"], verts) + params["b"]


def local_affine_normals(params, normals):
    """Warp normals by A⁻ᵀ with the singularity mask
    (nricp_optimizer.py:98-113) → (normals, ok)."""
    inv, ok = fast_3x3_inv(params["A"])
    return torch.einsum("nji,nj->ni", inv, normals), ok


def _stiffness(params, edges, gamma):
    W = torch.cat([params["A"], params["b"][..., None]], dim=-1)      # (N, 3, 4)
    diff = W[edges[:, 0]] - W[edges[:, 1]]
    g = torch.tensor([1.0, 1.0, 1.0, gamma], device=W.device)
    return torch.sum((diff * g) ** 2)


def _uniform_laplacian_loss(verts, edges, num_verts):
    """Mean uniform-Laplacian magnitude (pytorch3d
    mesh_laplacian_smoothing, 'uniform'); the sums are ``index_add_``."""
    e0, e1 = edges[:, 0], edges[:, 1]
    ones = torch.ones(edges.shape[0], dtype=verts.dtype, device=verts.device)
    deg = torch.zeros(num_verts, dtype=verts.dtype, device=verts.device)
    deg = deg.index_add(0, e0, ones).index_add(0, e1, ones)
    nbr = torch.zeros(num_verts, 3, dtype=verts.dtype, device=verts.device)
    nbr = nbr.index_add(0, e0, verts[e1]).index_add(0, e1, verts[e0])
    lap = nbr / torch.clamp(deg[:, None], min=1.0) - verts
    return torch.mean(torch.linalg.norm(lap, dim=1))


@dataclass
class NricpConfig:
    epochs: int = 200
    inner_iter: int = 10
    first_inner_iter: int = 100
    stiffness_weight: tuple = (50.0, 20.0, 5.0, 2.0, 0.8, 0.5, 0.35, 0.2)
    milestones: tuple = (50, 80, 100, 110, 120, 130, 140)
    laplacian_weight: tuple = (250.0, 250.0, 250.0, 250.0, 250.0, 250.0, 250.0, 250.0)
    gamma: float = 1.0
    threshold: float = 0.5
    lr: float = 1e-4
    # correspondence distance gate (world units): matches farther than
    # this are rejected; None disables it (the reference's shipped behaviour)
    max_dist: float | None = None


def _numpy(a, dtype):
    return np.asarray(a.detach().cpu() if torch.is_tensor(a) else a, dtype)


def nricp_fit(source_verts, source_faces, target_verts, target_normals=None,
              target_mask=None, static_ids=None, cfg: NricpConfig = None, device=None):
    """Register a source mesh onto a target point set → deformed source
    vertices (N, 3) numpy float32.

    ``target_mask`` (T,) filters noisy target points (the reference's
    nricp_masks); ``static_ids`` pins source vertices to their start
    positions. Runs on ``device``: that of ``source_verts`` when it is a
    tensor, else the CUDA card when none is given."""
    cfg = cfg or NricpConfig()
    if device is None and torch.is_tensor(source_verts):
        device = source_verts.device
    device = resolve_device(device)
    sv = torch.as_tensor(_numpy(source_verts, np.float32), device=device)
    sf = _numpy(source_faces, np.int64)
    tv = _numpy(target_verts, np.float32)
    use_normal = target_normals is not None
    tn = _numpy(target_normals, np.float32) if use_normal else np.zeros_like(tv)
    if target_mask is not None:
        keep = _numpy(target_mask, np.float32) > 0
        tv, tn = tv[keep], tn[keep]
    tv = torch.as_tensor(tv, device=device)
    tn = torch.as_tensor(tn, device=device)

    N = sv.shape[0]
    edges = torch.as_tensor(compute_edges_unique(sf), dtype=torch.int64, device=device)
    inner_mask = torch.as_tensor(~mesh_boundary_mask(sf, N), device=device)
    source_normals = compute_vnorms(sv, torch.as_tensor(sf, device=device))
    if static_ids is not None and len(static_ids):
        static_ids = torch.as_tensor(_numpy(static_ids, np.int64), device=device)
        static_targets = sv[static_ids]
    else:
        static_ids = None

    params = {"A": torch.eye(3, device=device).expand(N, 3, 3).clone().requires_grad_(),
              "b": torch.zeros(N, 3, device=device, requires_grad=True)}
    opt = torch.optim.AdamW([params["A"], params["b"]], lr=cfg.lr, betas=(0.9, 0.999),
                            eps=1e-8, weight_decay=1e-4)

    def loss_fn(close_pts, close_nrm, sw, lw):
        new_v = local_affine_apply(params, sv)
        with torch.no_grad():
            new_n, ok = local_affine_normals(params, source_normals)
            gate = inner_mask & ok
            if use_normal:
                cos = torch.sum(close_nrm * new_n, -1) / (
                    torch.linalg.norm(close_nrm, dim=-1) * torch.linalg.norm(new_n, dim=-1)
                    + 1e-9)
                gate = gate & (cos > cfg.threshold)
            if cfg.max_dist is not None:
                gate = gate & (torch.sum((new_v - close_pts) ** 2, -1) < cfg.max_dist ** 2)
        vert = torch.sum(torch.where(gate[:, None], (new_v - close_pts) ** 2, 0.0))
        stiff = _stiffness(params, edges, cfg.gamma) * sw
        static = (torch.sum((new_v[static_ids] - static_targets) ** 2)
                  if static_ids is not None else 0.0)
        lap = _uniform_laplacian_loss(new_v, edges, N) * lw
        return torch.sqrt(vert + stiff + static + 1e-12) + lap

    mile_idx = 0
    for epoch in range(cfg.epochs):
        with torch.no_grad():
            _, idx = knn(local_affine_apply(params, sv), tv, 1)
            close_pts, close_nrm = tv[idx[:, 0]], tn[idx[:, 0]]
        sw = cfg.stiffness_weight[mile_idx]
        lw = cfg.laplacian_weight[min(mile_idx, len(cfg.laplacian_weight) - 1)]
        with torch.enable_grad():          # callers may run under no_grad
            for _ in range(cfg.first_inner_iter if epoch == 0 else cfg.inner_iter):
                opt.zero_grad(set_to_none=True)
                loss_fn(close_pts, close_nrm, sw, lw).backward()
                opt.step()
        if (epoch + 1) in cfg.milestones:
            mile_idx = min(mile_idx + 1, len(cfg.stiffness_weight) - 1)

    with torch.no_grad():
        return local_affine_apply(params, sv).cpu().numpy()
