"""Batched small-matrix and rotation math (counterpart of
``recmv_tpu/ops/math3d.py``): ``fast_3x3_inv`` with its singularity mask
and analytic backward, quaternion and axis-angle rotations, face normals,
the Geman-McClure robustifier and the DCT basis."""

from __future__ import annotations

import numpy as np
import torch

_SINGULAR_EPS = 1e-4


def _adjugate_inv(a: torch.Tensor):
    """(..., 3, 3) → (inv, det) by cofactor expansion."""
    c00 = a[..., 1, 1] * a[..., 2, 2] - a[..., 1, 2] * a[..., 2, 1]
    c01 = -a[..., 1, 0] * a[..., 2, 2] + a[..., 1, 2] * a[..., 2, 0]
    c02 = a[..., 1, 0] * a[..., 2, 1] - a[..., 1, 1] * a[..., 2, 0]
    c10 = -a[..., 0, 1] * a[..., 2, 2] + a[..., 0, 2] * a[..., 2, 1]
    c11 = a[..., 0, 0] * a[..., 2, 2] - a[..., 0, 2] * a[..., 2, 0]
    c12 = -a[..., 0, 0] * a[..., 2, 1] + a[..., 0, 1] * a[..., 2, 0]
    c20 = a[..., 0, 1] * a[..., 1, 2] - a[..., 0, 2] * a[..., 1, 1]
    c21 = -a[..., 0, 0] * a[..., 1, 2] + a[..., 0, 2] * a[..., 1, 0]
    c22 = a[..., 0, 0] * a[..., 1, 1] - a[..., 0, 1] * a[..., 1, 0]
    det = a[..., 0, 0] * c00 + a[..., 0, 1] * c01 + a[..., 0, 2] * c02
    adjT = torch.stack([torch.stack([c00, c10, c20], -1),
                        torch.stack([c01, c11, c21], -1),
                        torch.stack([c02, c12, c22], -1)], -2)
    safe_det = torch.where(det.abs() < _SINGULAR_EPS, torch.ones_like(det), det)
    return adjT / safe_det[..., None, None], det


class _Fast3x3Inv(torch.autograd.Function):
    @staticmethod
    def forward(ctx, m):
        inv, det = _adjugate_inv(m)
        check = det.abs() >= _SINGULAR_EPS
        inv = torch.where(check[..., None, None], inv, torch.zeros_like(inv))
        ctx.save_for_backward(inv)
        ctx.mark_non_differentiable(check)
        return inv, check

    @staticmethod
    def backward(ctx, g, _):
        (inv,) = ctx.saved_tensors
        invT = inv.transpose(-1, -2)
        return -(invT @ g @ invT)


def fast_3x3_inv(m: torch.Tensor):
    """Batched 3x3 inverse → (inv, check): inv is zero and check False
    where |det| < 1e-4. Backward dA = −invᵀ G invᵀ with the masked inverse,
    as the reference's FastMinv extension."""
    return _Fast3x3Inv.apply(m)


def quat2mat(quat: torch.Tensor) -> torch.Tensor:
    """(..., 4) quaternion (w, x, y, z) → (..., 3, 3) rotation."""
    q = quat / torch.linalg.norm(quat, dim=-1, keepdim=True)
    w, x, y, z = q[..., 0], q[..., 1], q[..., 2], q[..., 3]
    w2, x2, y2, z2 = w * w, x * x, y * y, z * z
    wx, wy, wz = w * x, w * y, w * z
    xy, xz, yz = x * y, x * z, y * z
    rot = torch.stack([
        w2 + x2 - y2 - z2, 2 * xy - 2 * wz, 2 * wy + 2 * xz,
        2 * wz + 2 * xy, w2 - x2 + y2 - z2, 2 * yz - 2 * wx,
        2 * xz - 2 * wy, 2 * wx + 2 * yz, w2 - x2 - y2 + z2,
    ], dim=-1)
    return rot.reshape(quat.shape[:-1] + (3, 3))


def batch_rodrigues(axisang: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    """(..., 3) axis-angle → (..., 3, 3), through the quaternion form that
    is smooth at θ = 0."""
    sq = torch.sum(axisang * axisang, dim=-1, keepdim=True)
    angle = torch.sqrt(torch.clamp(sq, min=eps * eps))
    half = angle * 0.5
    sinc_half = torch.where(sq > eps * eps, torch.sin(half) / angle, 0.5 - sq / 48.0)
    w = torch.cos(half)
    return quat2mat(torch.cat([w, axisang * sinc_half], dim=-1))


def gm_robust_error(x2: torch.Tensor, c: float) -> torch.Tensor:
    """Geman-McClure robust error of squared residuals x2 (the JAX
    ``gm_robust_error(x, c, square=True)``)."""
    return 2.0 * x2 / (c * c) / (x2 / (c * c) + 4.0)


def compute_fnorms(verts: torch.Tensor, faces: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    """verts (..., V, 3), faces (F, 3) → unit face normals (..., F, 3)."""
    v0 = verts[..., faces[:, 0], :]
    v1 = verts[..., faces[:, 1], :]
    v2 = verts[..., faces[:, 2], :]
    n = torch.cross(v1 - v0, v2 - v0, dim=-1)
    return n / torch.clamp(torch.linalg.norm(n, dim=-1, keepdim=True), min=eps)


def dct_basis(k: int, n: int) -> np.ndarray:
    """Orthonormal DCT-II row k over a window of n frames."""
    assert k < n
    grid = np.pi * (np.arange(n, dtype=np.float64) + 0.5) * k / float(n)
    scale = 1.0 / np.sqrt(float(n)) if k == 0 else np.sqrt(2.0 / float(n))
    return (np.cos(grid) * scale).astype(np.float32)


def dct_space(k: int, n: int) -> np.ndarray:
    """Rows 0..k-1 of the DCT basis."""
    return np.stack([dct_basis(i, n) for i in range(0, k)])


def dct_null_space(k: int, n: int) -> np.ndarray:
    """Rows k..n-1 of the DCT basis: the high-frequency null space of the
    temporal pose prior."""
    return np.stack([dct_basis(i, n) for i in range(k, n)])
