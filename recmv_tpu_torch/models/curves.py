"""Explicit 3D feature curves (counterpart of
``recmv_tpu/models/curves.py``): each curve is parameterized
intersection-free as

    verts = center + dirs · init_scale · relu(scale) + nx_scale · nx

with a fixed center, unit radial directions ``dirs``, initial radial
extents ``init_scale`` and the mean plane normal ``nx``; the trained
leaves are the per-point radial multiplier ``scale`` (init 1) and the
out-of-plane offset ``nx_scale`` (init 0), each (C, S, 1). All curves are
one stacked (C, S, ·) tensor.

The tube meshes and the scale refit wait for the inference code that
uses them.
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
