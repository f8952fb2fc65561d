"""Trilinear volume sampling and the volume helpers of the seg3d pyramid
(counterpart of ``recmv_tpu/ops/grid_sample.py``).

``grid_sample_3d`` keeps the JAX semantics — locations in [-1, 1] ordered
(x, y, z) over the (W, H, D) axes, zero padding, align_corners=False —
and its arithmetic: eight corner gathers and a trilinear lerp in plain
tensor ops, on every device. The skinner samples its weight field inside
the deformer, whose Jacobian the training step differentiates again, and
``F.grid_sample`` has no double backward with respect to the grid
(torch 2.11+cu128: "derivative for aten::grid_sampler_3d_backward is not
implemented"); the lerp form has every order of derivative.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F


def grid_sample_3d(vol: torch.Tensor, pts: torch.Tensor) -> torch.Tensor:
    """vol (C, D, H, W), pts (N, 3) in [-1, 1] → (N, C)."""
    C, D, H, W = vol.shape
    x = ((pts[:, 0] + 1.0) * W - 1.0) / 2.0
    y = ((pts[:, 1] + 1.0) * H - 1.0) / 2.0
    z = ((pts[:, 2] + 1.0) * D - 1.0) / 2.0
    x0, y0, z0 = (torch.floor(c).detach() for c in (x, y, z))
    wx1, wy1, wz1 = x - x0, y - y0, z - z0
    wx0, wy0, wz0 = 1.0 - wx1, 1.0 - wy1, 1.0 - wz1
    xi, yi, zi = (c.to(torch.int64) for c in (x0, y0, z0))
    flat = vol.reshape(C, -1)
    out = None
    for dz, wz in ((0, wz0), (1, wz1)):
        for dy, wy in ((0, wy0), (1, wy1)):
            for dx, wx in ((0, wx0), (1, wx1)):
                xc, yc, zc = xi + dx, yi + dy, zi + dz
                valid = (xc >= 0) & (xc < W) & (yc >= 0) & (yc < H) & (zc >= 0) & (zc < D)
                idx = ((zc.clamp(0, D - 1) * H + yc.clamp(0, H - 1)) * W
                       + xc.clamp(0, W - 1))
                vals = torch.where(valid[None, :], flat[:, idx], 0.0)
                term = vals * (wz * wy * wx)[None]
                out = term if out is None else out + term
    return out.transpose(0, 1)


def upsample2x(vol: torch.Tensor) -> torch.Tensor:
    """(D, H, W) → (2D-1, 2H-1, 2W-1) trilinear upsample with
    align_corners=True. On that lattice the weights are 0 or 1/2, so it
    is separable midpoint lerps, taken over z, y, x in turn with the JAX
    ``resize_trilinear`` arithmetic (a0·½ + a1·½)."""
    for dim in range(vol.ndim - 3, vol.ndim):
        n = vol.shape[dim]
        lo = vol.narrow(dim, 0, n - 1)
        hi = vol.narrow(dim, 1, n - 1)
        mid = lo * 0.5 + hi * 0.5
        shape = list(vol.shape)
        shape[dim] = 2 * n - 1
        out = vol.new_empty(shape)
        idx_even = [slice(None)] * vol.ndim
        idx_even[dim] = slice(0, None, 2)
        idx_odd = [slice(None)] * vol.ndim
        idx_odd[dim] = slice(1, None, 2)
        out[tuple(idx_even)] = vol
        out[tuple(idx_odd)] = mid
        vol = out
    return vol


def max_pool_3d_same(mask: torch.Tensor, kernel: int) -> torch.Tensor:
    """Boolean 3D dilation with a cubic kernel, SAME padding."""
    pad = kernel // 2
    out = F.max_pool3d(mask[None, None].to(torch.float32), kernel, stride=1, padding=pad)
    return out[0, 0] > 0
