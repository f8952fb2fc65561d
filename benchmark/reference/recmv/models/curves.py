"""Explicit 3D feature curves (counterpart of
``recmv_tpu/models/curves.py``): each curve is parameterized
intersection-free as

    verts = center + dirs · init_scale · relu(scale) + nx_scale · nx

with a fixed center, unit radial directions ``dirs``, initial radial
extents ``init_scale`` and the mean plane normal ``nx``; the trained
leaves are the per-point radial multiplier ``scale`` (init 1) and the
out-of-plane offset ``nx_scale`` (init 0), each (C, S, 1). All curves are
one stacked (C, S, ·) tensor.

``curve_to_tube_mesh`` (numpy, a copy) sweeps the exported feature-line
tubes; ``refit_curve_scale`` refits the radial scales to target polylines
with AdamW (weight decay 1e-4, optax's ``adamw`` default).
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from .. import resolve_device
from ..geometry.mesh_utils import longest_boundary_loop
from ..geometry.polygons import uniform_sample_3d


@dataclass
class CurveStatics:
    """Fixed curve geometry."""

    center: torch.Tensor           # (C, 1, 3)
    v_dirs: torch.Tensor           # (C, S, 3)
    init_scale: torch.Tensor       # (C, S, 1)
    nx: torch.Tensor               # (C, 1, 3) mean plane normal
    cano_smpl_verts: torch.Tensor  # (C, S, 3) pre-alignment body-space curves
    fl_names: tuple


def extract_curve_from_patch(verts: np.ndarray, faces: np.ndarray,
                             sample_num: int = 200) -> np.ndarray:
    """Template patch → uniform closed curve: the longest boundary loop,
    resampled to ``sample_num`` points (numpy, as the JAX function)."""
    loop = longest_boundary_loop(faces, verts)
    return uniform_sample_3d(verts[loop], sample_num).astype(np.float32)


def _stack(curves, device) -> torch.Tensor:
    return torch.stack([torch.as_tensor(c, dtype=torch.float32, device=device).detach()
                        for c in curves])


def init_curves(curve_verts_list, cano_smpl_verts_list, fl_names, device=None):
    """(params, statics) from the aligned canonical curves (C of (S, 3))
    and their pre-alignment body-space versions, on ``device`` (the CUDA
    card when none is given). The leaves require grad."""
    device = resolve_device(device)
    cv = _stack(curve_verts_list, device)
    center = cv.mean(1, keepdim=True)
    rel = cv - center
    v_dirs = rel / (torch.linalg.norm(rel, dim=-1, keepdim=True) + 1e-6)
    nx = torch.linalg.cross(v_dirs[:, :-1, :], v_dirs[:, 1:, :], dim=-1)
    nx = nx / torch.linalg.norm(nx, dim=-1, keepdim=True)
    nx = nx.mean(1, keepdim=True)
    init_scale = torch.clamp((rel * v_dirs).sum(-1, keepdim=True), min=0.0)
    statics = CurveStatics(center=center, v_dirs=v_dirs, init_scale=init_scale, nx=nx,
                           cano_smpl_verts=_stack(cano_smpl_verts_list, device),
                           fl_names=tuple(fl_names))
    params = {"scale": torch.ones_like(init_scale).requires_grad_(),
              "nx_scale": torch.zeros_like(init_scale).requires_grad_()}
    return params, statics


def curves_forward(params: dict, statics: CurveStatics) -> torch.Tensor:
    """(C, S, 3) current canonical curve vertices."""
    radial = statics.v_dirs * statics.init_scale * torch.relu(params["scale"])
    return statics.center + radial + params["nx_scale"] * statics.nx


def curves_regularization(params: dict, statics: CurveStatics, fl_masks) -> dict:
    """The center-drift term (weighed 0, as in the JAX package) and the
    neighbour-direction cosine smoothness over each closed loop."""
    verts = curves_forward(params, statics)
    used = (fl_masks.sum() > 0).to(torch.float32)
    center_loss = used * (verts.mean(1, keepdim=True) - statics.center).abs().sum()
    diff_a = verts[:, :-1, :] - verts[:, 1:, :]
    diff_b = verts[:, -1:, :] - verts[:, 0:1, :]
    diff_c = verts[:, 0:1, :] - verts[:, 1:2, :]
    d = torch.cat([diff_a, diff_b, diff_c], dim=1)
    d = d / (torch.linalg.norm(d, dim=-1, keepdim=True) + 1e-6)
    cos = (d[:, :-1, :] * d[:, 1:, :]).sum(-1)
    return {"center_offset": 0.0 * center_loss, "diff_a_loss": (1.0 - cos).sum()}


def curve_to_tube_mesh(curve: np.ndarray, normal: np.ndarray,
                       curve_radius: float = 0.002, num_joints: int = 6):
    """Sweep a radius-``curve_radius`` tube with ``num_joints`` ring
    vertices along a closed curve (garment_structure.py:183-270): the
    exported feature-line meshes of infer_fl_curve → (verts (S·J, 3) f32,
    faces int64). Host numpy, as the JAX function."""
    c = np.asarray(curve, np.float64)
    S = c.shape[0]
    tang = np.roll(c, -1, 0) - c
    tang /= np.clip(np.linalg.norm(tang, axis=1, keepdims=True), 1e-12, None)
    n0 = np.broadcast_to(np.asarray(normal, np.float64).reshape(1, 3), (S, 3))
    cross_n = np.cross(tang, n0)
    dot_n = tang * (tang * n0)
    rings = []
    for ang in range(0, 360, 360 // num_joints):
        r = np.radians(ang)
        rings.append(n0 * np.cos(r) + cross_n * np.sin(r) + dot_n * (1 - np.cos(r)))
    rings = np.stack(rings, axis=1)                        # (S, J, 3)
    verts = (c[:, None, :] + curve_radius * rings).reshape(-1, 3)
    faces = []
    J = num_joints
    for s in range(S):
        s2 = (s + 1) % S
        for j in range(J):
            j2 = (j + 1) % J
            a, b, cx, dx = s * J + j, s2 * J + j, s2 * J + j2, s * J + j2
            faces.append([a, b, cx])
            faces.append([a, cx, dx])
    return verts.astype(np.float32), np.asarray(faces, np.int64)


def refit_curve_scale(params: dict, statics: CurveStatics, target_verts_by_idx: dict,
                      steps: int = 2000, lr: float = 1e-4) -> dict:
    """Chamfer-refit selected curves' radial scales to target polylines
    (the optional refit inside curve_to_mesh, garment_structure.py:183-215):
    AdamW over (scale, nx_scale) on the curves' device → new leaves."""
    idxs = tuple(sorted(target_verts_by_idx))
    dev = statics.center.device
    targets = torch.as_tensor(np.stack([np.asarray(target_verts_by_idx[i], np.float32)
                                        for i in idxs]), device=dev)
    sel = torch.as_tensor(idxs, dtype=torch.int64, device=dev)
    p = {k: params[k].detach().clone().requires_grad_() for k in ("scale", "nx_scale")}
    opt = torch.optim.AdamW([p["scale"], p["nx_scale"]], lr=lr, betas=(0.9, 0.999), eps=1e-8,
                            weight_decay=1e-4)
    with torch.enable_grad():             # callers may run under no_grad
        for _ in range(steps):
            verts = curves_forward(p, statics)[sel]                    # (K, S, 3)
            d2 = torch.sum((verts[:, :, None, :] - targets[:, None, :, :]) ** 2, -1)
            cham = torch.mean(d2.amin(2)) + torch.mean(d2.amin(1))
            d = verts[:, 1:, :] - verts[:, :-1, :]
            d = torch.cat([d, verts[:, :1] - verts[:, -1:]], dim=1)
            d = d / (torch.linalg.norm(d, dim=-1, keepdim=True) + 1e-6)
            smooth = torch.sum(1 - torch.sum(d[:, :-1] * d[:, 1:], -1))
            opt.zero_grad(set_to_none=True)
            (1000.0 * cham + 0.1 * smooth).backward()
            opt.step()
    return p
