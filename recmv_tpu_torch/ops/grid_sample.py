"""Trilinear volume sampling and the volume helpers of the seg3d pyramid
(counterpart of ``recmv_tpu/ops/grid_sample.py``).

``grid_sample_3d`` keeps the JAX semantics on the main path — locations
in [-1, 1] ordered (x, y, z) over the (W, H, D) axes, zero padding,
align_corners=False — which are exactly those of ``F.grid_sample`` with
``padding_mode="zeros"``, so that operator serves (first-order gradients
are all the ported slice takes through it).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F


def grid_sample_3d(vol: torch.Tensor, pts: torch.Tensor) -> torch.Tensor:
    """vol (C, D, H, W), pts (N, 3) in [-1, 1] → (N, C)."""
    N = pts.shape[0]
    out = F.grid_sample(vol[None], pts.reshape(1, N, 1, 1, 3), mode="bilinear",
                        padding_mode="zeros", align_corners=False)
    return out.reshape(vol.shape[0], N).transpose(0, 1)


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
