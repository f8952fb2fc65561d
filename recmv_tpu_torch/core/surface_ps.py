"""Surface-point root finding (counterpart of
``recmv_tpu/core/surface_ps.py``, forward part): per-ray projected
Newton steps on canonical points p minimizing
w1·|sdf(p)| + w2·sin∠(ray, D(p) − cam), with an "unfinished" mask in
place of the reference's shrinking tensors.

The implicit adjoint that turns ∂L/∂p* into parameter gradients
(``make_implicit_surface_adjoint``) is the identity in the forward pass;
its ``torch.autograd.Function`` arrives with training.
"""

from __future__ import annotations

import math

import torch

MAX_STEP = 0.05      # canonical units per Newton step (trust region)
DTHRESHOLD = 5e-5    # |sdf| bound of a converged point
W1, W2 = 3.05, 1.0   # loss weights of |sdf| and sin∠


def optimize_surface_points(sdf_fn, deform_fn, cam_origin, rays, init_pts, valid,
                            athreshold_deg: float = 0.02, times: int = 20):
    """Refine canonical surface points along fixed rays.

    sdf_fn (M, 3) → (M,); deform_fn (M, 3) → (M, 3), both closed over
    parameters and per-point frames; cam_origin (3,), rays (M, 3) world
    unit rays, init_pts (M, 3) seeds, valid (M,) live rays.
    Returns (pts, converged ⊆ valid); pts carry no graph.

    A point converges when |sdf| < DTHRESHOLD and its angle to the ray is
    below athreshold_deg, checked before each step; at most times + 1
    evaluations run, stopping early once no point is left unfinished."""

    def eval_at(pts):
        with torch.enable_grad():
            p = pts.detach().requires_grad_(True)
            l1 = torch.abs(sdf_fn(p))
            direct = deform_fn(p) - cam_origin
            up = torch.cross(direct, rays, dim=-1)
            s = torch.linalg.norm(up, dim=-1) / torch.clamp(
                torch.linalg.norm(direct, dim=-1), min=1e-12)
            losses = W1 * l1 + W2 * torch.abs(s)
            (grads,) = torch.autograd.grad(losses.sum(), p)
        ang = torch.arcsin(torch.clamp(s.detach(), 0.0, 1.0)) * 180.0 / math.pi
        conv = (l1.detach() < DTHRESHOLD) & (ang < athreshold_deg)
        return losses.detach(), grads, conv

    pts = init_pts.detach()
    unfinished = valid.clone()
    it = 0
    while it <= times and bool(unfinished.any()):
        losses, grads, conv = eval_at(pts)
        unfinished = unfinished & ~conv
        gg = torch.sum(grads * grads, -1)
        ok = gg > 1e-12
        t = torch.where(ok, -losses / torch.where(ok, gg, 1.0), 0.0)
        step = t[:, None] * grads
        slen = torch.linalg.norm(step, dim=-1, keepdim=True)
        step = step * torch.clamp(MAX_STEP / torch.clamp(slen, min=1e-12), max=1.0)
        new_pts = pts + step
        finite = torch.isfinite(new_pts).all(-1)
        pts = torch.where((unfinished & finite)[:, None], new_pts, pts)
        unfinished = unfinished & finite
        it += 1
    pts = torch.where(torch.isfinite(pts), pts, 0.0)
    return pts, valid & ~unfinished
