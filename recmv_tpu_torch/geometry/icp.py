"""Rigid and similarity alignment (counterpart of
``recmv_tpu/geometry/icp.py``; the reference's
``engineer/optimizer/icp_optimzier.py`` (classic ICP),
``engineer/utils/matrix_transform.py:27`` (Umeyama similarity alignment)
and ``engineer/optimizer/surface_intesection.py:31`` (curve-to-surface
snapping)). Arrays that are not tensors go to ``device``, the CUDA card
when none is given; tensors stay where they are."""

from __future__ import annotations

import numpy as np
import torch

from .. import resolve_device
from ..ops.knn import knn


def _tensor(a, device):
    if torch.is_tensor(a):
        return a.to(torch.float32)
    return torch.as_tensor(np.asarray(a, np.float32), device=resolve_device(device))


def umeyama(src, dst, with_scale: bool = True, device=None):
    """Closed-form similarity transform argmin ‖s R src + t − dst‖²
    (Umeyama 1991) → (s, R (3, 3), t (3,)), applied as s·x@Rᵀ + t."""
    src = _tensor(src, device)
    dst = _tensor(dst, src.device if device is None else device)
    mu_s, mu_d = src.mean(0), dst.mean(0)
    xs, xd = src - mu_s, dst - mu_d
    cov = (xd.T @ xs) / src.shape[0]
    U, S, Vt = torch.linalg.svd(cov)
    d = torch.sign(torch.linalg.det(U) * torch.linalg.det(Vt))
    signs = torch.stack([torch.ones_like(d), torch.ones_like(d), d])
    R = U @ torch.diag(signs) @ Vt
    if with_scale:
        var_s = torch.mean(torch.sum(xs * xs, -1))
        s = torch.sum(S * signs) / torch.clamp(var_s, min=1e-12)
    else:
        s = torch.ones((), device=src.device)
    t = mu_d - s * (R @ mu_s)
    return s, R, t


def icp(src, dst, iters: int = 20, with_scale: bool = False, device=None):
    """Classic point-to-point ICP: correspondences by nearest neighbour,
    closed-form update → (s, R, t) mapping src → dst."""
    cur = _tensor(src, device)
    dst = _tensor(dst, cur.device if device is None else device)
    s_tot = torch.ones((), device=cur.device)
    R_tot = torch.eye(3, device=cur.device)
    t_tot = torch.zeros(3, device=cur.device)
    for _ in range(iters):
        _, idx = knn(cur, dst, 1)
        s, R, t = umeyama(cur, dst[idx[:, 0]], with_scale)
        cur = s * cur @ R.T + t
        R_tot = R @ R_tot
        s_tot = s * s_tot
        t_tot = s * (R @ t_tot) + t
    return s_tot, R_tot, t_tot


def snap_points_to_surface(points, directions, verts, faces=None, max_dist: float = 0.1,
                           steps: int = 64, device=None):
    """Curve-to-surface snapping (surface_intesection.py semantics): each
    point moves along ±direction to the sample of the segment nearest the
    mesh's vertices (``faces`` is unused, as in the JAX function).

    The JAX function divides the (P, 3) directions by
    ``jnp.linalg.norm(directions, -1, keepdims=True)``, whose second
    argument is the order: the matrix norm of order −1 (the smallest
    column sum of |d|), one scalar for all rows. The port copies that on
    purpose (``ROADMAP.md`` queue 3), so the segments are as long."""
    points = _tensor(points, device)
    dev = points.device
    directions = _tensor(directions, dev)
    scale = torch.linalg.matrix_norm(directions, ord=-1, keepdim=True)
    directions = directions / torch.clamp(scale, min=1e-9)
    ts = torch.linspace(-max_dist, max_dist, steps, device=dev)
    cand = points[:, None, :] + ts[None, :, None] * directions[:, None, :]
    d2, _ = knn(cand.reshape(-1, 3), _tensor(verts, dev), 1)
    best = torch.argmin(d2.reshape(points.shape[0], steps), dim=1)
    return cand[torch.arange(points.shape[0], device=dev), best]
