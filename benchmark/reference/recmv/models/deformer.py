"""Jacobian-based warps of the composite deformation field (counterpart of
``recmv_tpu/models/deformer.py``): the per-point Jacobian ∂D/∂p, the view
ray pulled back to canonical space, the SDF normal pushed forward, and
the inverse of the feature curves' rigid alignment."""

from __future__ import annotations

import torch

from ..ops.math3d import fast_3x3_inv
from .sdf import _point_input


def deformer_jacobian(deform_fn, ps_flat: torch.Tensor,
                      create_graph: bool = False) -> torch.Tensor:
    """Per-point Jacobian of a pointwise batched 3→3 map: (M, 3) → (M, 3, 3)
    with J[m, i, j] = ∂D_i/∂p_j. The map is pointwise, so the backward of
    Σ_m D_i(p_m) is row i of every point's Jacobian: three backward passes
    of one forward. With ``create_graph`` the result carries the graph to
    the map's parameters and to ``ps_flat`` (differentiating it again runs
    the double backward of every op of the map, the skinner's trilinear
    ``F.grid_sample`` included), as the JAX jvps do; without it, it
    carries none. Works under no_grad."""
    with torch.enable_grad():
        p = _point_input(ps_flat, create_graph)
        out = deform_fn(p)
        rows = [torch.autograd.grad(out[:, i].sum(), p, retain_graph=create_graph or i < 2,
                                    create_graph=create_graph)[0]
                for i in range(3)]
    return torch.stack(rows, dim=1)


def deformed_normals_from_grads(jac: torch.Tensor, sdf_grads: torch.Tensor):
    """n = normalize(J⁻ᵀ ∇sdf), falling back to J ∇sdf where |det J| <
    1e-4 → (normals, inv_ok)."""
    inv, ok = fast_3x3_inv(jac)
    n = torch.einsum("mji,mj->mi", inv, sdf_grads)
    fallback = torch.einsum("mij,mj->mi", jac, sdf_grads)
    n = torch.where(ok[:, None], n, fallback)
    n = n / torch.clamp(torch.linalg.norm(n, dim=-1, keepdim=True), min=1e-12)
    return n, ok


def cardinal_rays_from_jac(jac: torch.Tensor, rays: torch.Tensor):
    """Canonical rays r_c = normalize(J⁻¹ r), falling back to r where the
    Jacobian is singular → (rays_c, inv_ok)."""
    inv, ok = fast_3x3_inv(jac)
    r = torch.einsum("mij,mj->mi", inv, rays)
    r = torch.where(ok[:, None], r, rays)
    r = r / torch.clamp(torch.linalg.norm(r, dim=-1, keepdim=True), min=1e-12)
    return r, ok


class InverseFlBody:
    """Undo the per-curve rigid alignment (scale s, translation t) that
    ``align_fl`` applied in canonical body space: p_body = (p_aligned − t −
    c)/s + c, with c the centre of the pre-alignment curve. Keyed by curve
    name."""

    def __init__(self, fl_names, cano_fl_verts_list, rigid_t_list, rigid_scale_list,
                 device=None):
        self.fl_names = list(fl_names)
        self.center, self.verts, self.rigid_t, self.rigid_scale = {}, {}, {}, {}
        for name, v, t, s in zip(self.fl_names, cano_fl_verts_list, rigid_t_list,
                                 rigid_scale_list):
            v = torch.as_tensor(v, dtype=torch.float32, device=device)
            self.center[name] = v.mean(0, keepdim=True)
            self.verts[name] = v
            self.rigid_t[name] = torch.as_tensor(t, dtype=torch.float32,
                                                 device=device).reshape(1, 3)
            self.rigid_scale[name] = torch.as_tensor(s, dtype=torch.float32, device=device)

    def __call__(self, rigid_cano_fl_verts_list, fl_names):
        return [((v - self.rigid_t[n]) - self.center[n]) / self.rigid_scale[n] + self.center[n]
                for v, n in zip(rigid_cano_fl_verts_list, fl_names)]
