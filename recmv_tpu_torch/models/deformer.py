"""Jacobian-based warps of the composite deformation field (counterpart of
``recmv_tpu/models/deformer.py``): the per-point Jacobian ∂D/∂p and the
view ray pulled back to canonical space."""

from __future__ import annotations

import torch

from ..ops.math3d import fast_3x3_inv


def deformer_jacobian(deform_fn, ps_flat: torch.Tensor) -> torch.Tensor:
    """Per-point Jacobian of a pointwise batched 3→3 map: (M, 3) → (M, 3, 3)
    with J[m, i, j] = ∂D_i/∂p_j. The map is pointwise, so the backward of
    Σ_m D_i(p_m) is row i of every point's Jacobian: three backward passes
    of one forward. Works under no_grad; the result carries no graph."""
    with torch.enable_grad():
        p = ps_flat.detach().requires_grad_(True)
        out = deform_fn(p)
        rows = [torch.autograd.grad(out[:, i].sum(), p, retain_graph=i < 2)[0]
                for i in range(3)]
    return torch.stack(rows, dim=1)


def cardinal_rays_from_jac(jac: torch.Tensor, rays: torch.Tensor):
    """Canonical rays r_c = normalize(J⁻¹ r), falling back to r where the
    Jacobian is singular → (rays_c, inv_ok)."""
    inv, ok = fast_3x3_inv(jac)
    r = torch.einsum("mij,mj->mi", inv, rays)
    r = torch.where(ok[:, None], r, rays)
    r = r / torch.clamp(torch.linalg.norm(r, dim=-1, keepdim=True), min=1e-12)
    return r, ok
