"""Loss terms of the ported slice (counterpart of
``recmv_tpu/core/losses.py``): the mask IoU with its pooled gt targets,
and the per-frame colour loss."""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F


def masked_mean(x, mask, eps: float = 1e-9):
    mask = mask.to(x.dtype)
    return torch.sum(x * mask) / torch.clamp(torch.sum(mask), min=eps)


def iou_mask_loss(pred_masks, gt_masks, keep=None):
    """1 − IoU between soft predicted and pooled gt masks, per frame, then
    the mean. ``keep`` (1 = score, 0 = don't care) gates pixels."""
    N = gt_masks.shape[0]
    p = pred_masks.reshape(N, -1)
    g = gt_masks.reshape(N, -1)
    if keep is not None:
        k = keep.reshape(N, -1)
        p = p * k
        g = g * k
    inter = torch.sum(p * g, -1)
    union = torch.sum(torch.abs(p + g - p * g), -1)
    return torch.mean(1.0 - inter / torch.clamp(union, min=1e-9))


def max_pool_mask(mask, radius_px: int):
    """Dilate masks (..., H, W) by the point-render radius (max pool with
    kernel 2r + 1, SAME padding)."""
    if radius_px <= 0:
        return mask
    lead = mask.shape[:-2]
    m = mask.reshape((-1, 1) + mask.shape[-2:])
    out = F.max_pool2d(m, 2 * radius_px + 1, stride=1, padding=radius_px)
    return out.reshape(lead + out.shape[-2:])


def point_render_radius_px(radius_ndc: float, H: int, W: int) -> int:
    """Pixel dilation radius from the NDC point radius: round(r/2 · min(H, W)/1.2)."""
    return int(np.round(radius_ndc / 2.0 * float(min(H, W)) / 1.2))


def per_frame_scatter_mean(values, batch_inds, valid, N):
    """Mean per frame (scatter), then the mean over frames that have any."""
    w = valid.to(values.dtype)
    sums = torch.zeros(N, dtype=values.dtype, device=values.device).index_add(
        0, batch_inds, values * w)
    cnts = torch.zeros(N, dtype=values.dtype, device=values.device).index_add(
        0, batch_inds, w)
    present = cnts > 0
    frame_means = torch.where(present, sums / torch.clamp(cnts, min=1e-9), 0.0)
    return torch.sum(frame_means) / torch.clamp(torch.sum(present), min=1.0)


def color_loss(pred_rgb, gt_rgb, batch_inds, valid, N):
    """L1 colour loss summed over channels, per-frame mean."""
    vals = torch.sum(torch.abs(gt_rgb - pred_rgb), -1)
    return per_frame_scatter_mean(vals, batch_inds, valid, N)
