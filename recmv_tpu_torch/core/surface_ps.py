"""Surface-point root finding and its implicit adjoint (counterpart of
``recmv_tpu/core/surface_ps.py``).

- ``optimize_surface_points``: per-ray projected Newton steps on canonical
  points p minimizing w1·|sdf(p)| + w2·sin∠(ray, D(p) − cam), with an
  "unfinished" mask in place of the reference's shrinking tensors.
- ``attach_implicit_surface``: the solved points come from a solver that
  is not differentiated, so ∂L/∂p* reaches the parameters θ through the
  constraints F(p; θ) = [sdf(p); ray × (D(p) − cam)] = 0: with B = ∂F/∂p
  (4×3), dL/dθ = −g (BᵀB)⁻¹Bᵀ ∂F/∂θ (the JAX
  ``make_implicit_surface_adjoint``, a ``jax.custom_vjp``).
"""

from __future__ import annotations

import math

import torch

from ..ops.math3d import fast_3x3_inv
from ..utils.profiling import count, span

MAX_STEP = 0.05      # canonical units per Newton step (trust region)
DTHRESHOLD = 5e-5    # |sdf| bound of a converged point
W1, W2 = 3.05, 1.0   # loss weights of |sdf| and sin∠


def optimize_surface_points(sdf_fn, deform_fn, cam_origin, rays, init_pts, valid,
                            athreshold_deg: float = 0.02, times: int = 20,
                            dthreshold: float = DTHRESHOLD):
    """Refine canonical surface points along fixed rays.

    sdf_fn (M, 3) → (M,); deform_fn (M, 3) → (M, 3), both closed over
    parameters and per-point frames; cam_origin (3,), rays (M, 3) world
    unit rays, init_pts (M, 3) seeds, valid (M,) live rays.
    Returns (pts, converged ⊆ valid); pts carry no graph.

    A point converges when |sdf| < dthreshold and its angle to the ray is
    below athreshold_deg, checked before each step; at most times + 1
    evaluations run, stopping early once no point is left unfinished.

    Traced (``utils.profiling``): spans ``solve/setup``, ``solve/check``
    (the host's read of the stop test), ``solve/eval`` (the SDF and the
    deformation and their gradient), ``solve/step`` (the projected
    update) and ``solve/finish``; counters ``solve.calls``,
    ``solve.evals``, ``solve.rows`` (rows evaluated) and ``solve.live``
    (rows valid and unfinished as each evaluation starts)."""

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
        conv = (l1.detach() < dthreshold) & (ang < athreshold_deg)
        return losses.detach(), grads, conv

    with span("solve/setup"):
        pts = init_pts.detach()
        unfinished = valid.clone()
    it = 0
    while it <= times:
        with span("solve/check"):
            if not bool(unfinished.any()):
                break
        count("solve.live", unfinished)
        with span("solve/eval"):
            losses, grads, conv = eval_at(pts)
        with span("solve/step"):
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
    count("solve.calls")
    count("solve.evals", it)
    count("solve.rows", it * valid.shape[0])
    with span("solve/finish"):
        pts = torch.where(torch.isfinite(pts), pts, 0.0)
        return pts, valid & ~unfinished


def ray_constraint(deformed_pts, cam_origin, rays):
    """c = ray × (D(p) − cam): zero iff the deformed point lies on its ray."""
    return torch.cross(rays, deformed_pts - cam_origin, dim=-1)


def attach_implicit_surface(pts, sdf_fn, constraint_fn):
    """Reattach solved points (M, 3) to the parameters.

    sdf_fn (M, 3) → (M,) and constraint_fn (M, 3) → (M, 3) are closed over
    the parameters (garment SDF; translator, latents, poses, translation,
    camera) with their graphs. Returns TmpPs = p + M·(F − F.detach()) with
    M = −(BᵀB)⁻¹Bᵀ computed without a graph and zeroed where BᵀB is
    singular (|det| < 1e-4): its value is exactly p, its gradient with
    respect to θ is −g (BᵀB)⁻¹Bᵀ ∂F/∂θ, and p itself gets none."""
    with torch.enable_grad():
        q = pts.detach().requires_grad_(True)
        F = torch.cat([sdf_fn(q)[:, None], constraint_fn(q)], dim=-1)        # (M, 4)
        rows = [torch.autograd.grad(F[:, i].sum(), q, retain_graph=True)[0] for i in range(4)]
    B = torch.stack(rows, dim=1)                                               # (M, 4, 3)
    inv, ok = fast_3x3_inv(B.transpose(1, 2) @ B)
    Mt = torch.where(ok[:, None, None], -(inv @ B.transpose(1, 2)), 0.0)       # (M, 3, 4)
    return q.detach() + torch.einsum("mik,mk->mi", Mt, F - F.detach())
