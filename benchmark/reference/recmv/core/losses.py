"""Loss terms of the ported slice (counterpart of
``recmv_tpu/core/losses.py``): the mask IoU with its pooled gt targets,
and the terms of ③ ``main_loss``: colour, normal pull-back, SDF shrink,
eikonal, deformation rigidity and the DCT pose prior; and the IGR fit
loss of the SDF initialization."""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from ..ops.math3d import gm_robust_error


def masked_mean(x, mask, dim=None, eps: float = 1e-9):
    """Mean of ``x`` over ``mask``, over all entries or along ``dim``."""
    mask = mask.to(x.dtype)
    if dim is None:
        return torch.sum(x * mask) / torch.clamp(torch.sum(mask), min=eps)
    return torch.sum(x * mask, dim) / torch.clamp(torch.sum(mask, dim), min=eps)


def iou_mask_loss(pred_masks, gt_masks, keep=None):
    """1 − IoU between soft predicted and pooled gt masks, per frame, then
    their mean. ``keep`` (1 = score, 0 = don't care) gates pixels."""
    N = gt_masks.shape[0]
    p = pred_masks.reshape(N, -1)
    g = gt_masks.reshape(N, -1)
    if keep is not None:
        k = keep.reshape(N, -1)
        p = p * k
        g = g * k
    inter = torch.sum(p * g, -1)
    union = torch.sum(torch.abs(p + g - p * g), -1)
    per_frame = 1.0 - inter / torch.clamp(union, min=1e-9)
    return torch.sum(per_frame) / N


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
    """Mean per frame (scatter) over the detached counts per frame, then the
    mean over frames that have any."""
    w = valid.to(values.dtype)
    sums = torch.zeros(N, dtype=values.dtype, device=values.device).index_add(
        0, batch_inds, values * w)
    cnts = torch.zeros(N, dtype=values.dtype, device=values.device).index_add(
        0, batch_inds, w)
    cnts = cnts.detach()
    present = cnts > 0
    frame_means = torch.where(present, sums / torch.clamp(cnts, min=1e-9), 0.0)
    return torch.sum(frame_means) / torch.clamp(torch.sum(present), min=1.0)


def color_loss(pred_rgb, gt_rgb, batch_inds, valid, N):
    """L1 colour loss summed over channels, per-frame mean."""
    vals = torch.sum(torch.abs(gt_rgb - pred_rgb), -1)
    return per_frame_scatter_mean(vals, batch_inds, valid, N)


def _mean(vals, valid, total):
    """Σ vals over ``valid`` / ``total``: by default the count of the
    entries given (``masked_mean``'s)."""
    if valid is not None:
        w = valid.to(vals.dtype)
        vals = vals * w
        total = torch.clamp(torch.sum(w), min=1e-9) if total is None else total
    return torch.sum(vals) / (vals.numel() if total is None else total)


def sdf_shrink_loss(sdf_vals, shrink: float, valid=None):
    """|sdf(x) + shrink|, mean over ``valid``: ties the implicit surface to
    the explicit points the mask branch moved."""
    vals = torch.abs(sdf_vals + shrink)
    return torch.mean(vals) if valid is None else masked_mean(vals, valid)


def eikonal_loss(grads, valid=None, total=None):
    """(‖∇sdf‖ − 1)², mean over ``valid`` (``_mean``, ``total``)."""
    return _mean((torch.linalg.norm(grads, dim=-1) - 1.0) ** 2, valid, total)


def igr_init_loss(sdf_vals_surface, grads_surface, grads_offsurface, normals=None):
    """IGR fit of an SDF to a surface point set: |sdf| + 0.1·eikonal on the
    off-surface samples + 1.0·‖∇sdf − n‖ where normals are given. Returns
    (loss, {manifold, eikonal[, normals]})."""
    mnfld = torch.mean(torch.abs(sdf_vals_surface))
    eik = torch.mean((torch.linalg.norm(grads_offsurface, dim=-1) - 1.0) ** 2)
    loss = mnfld + 0.1 * eik
    aux = {"manifold": mnfld, "eikonal": eik}
    if normals is not None:
        nloss = torch.mean(torch.linalg.norm(grads_surface - normals, dim=-1))
        loss = loss + 1.0 * nloss
        aux["normals"] = nloss
    return loss, aux


def sym3x3_eigvalsh(A):
    """Closed-form (trigonometric) eigenvalues of symmetric 3×3 matrices
    (..., 3, 3), ascending. The gradient needs distinct eigenvalues
    (callers jitter the diagonal)."""
    a00, a01, a02 = A[..., 0, 0], A[..., 0, 1], A[..., 0, 2]
    a11, a12, a22 = A[..., 1, 1], A[..., 1, 2], A[..., 2, 2]
    q = (a00 + a11 + a22) / 3.0
    p1 = a01 * a01 + a02 * a02 + a12 * a12
    b00, b11, b22 = a00 - q, a11 - q, a22 - q
    p2 = b00 * b00 + b11 * b11 + b22 * b22 + 2.0 * p1
    p = torch.sqrt(torch.clamp(p2 / 6.0, min=1e-30))
    detb = (b00 * (b11 * b22 - a12 * a12)
            - a01 * (a01 * b22 - a12 * a02)
            + a02 * (a01 * a12 - b11 * a02))
    r = torch.clamp(detb / (2.0 * p * p * p), -1.0 + 1e-7, 1.0 - 1e-7)
    phi = torch.arccos(r) / 3.0
    e_hi = q + 2.0 * p * torch.cos(phi)
    e_lo = q + 2.0 * p * torch.cos(phi + 2.0 * np.pi / 3.0)
    e_mid = 3.0 * q - e_hi - e_lo
    return torch.stack([e_lo, e_mid, e_hi], dim=-1)


def def_regularization_loss(jacobians, c: float, valid=None, total=None):
    """Rigidity prior on the offset field: Geman-McClure of Σ log²σᵢ over
    each Jacobian's singular values, σᵢ² the eigenvalues of JᵀJ. A
    diagonal jitter of (1, 2, 3)·1e-6 times the mean eigenvalue keeps them
    distinct (JᵀJ ≈ I at the near-identity init). The mean over ``valid``
    (``_mean``, ``total``)."""
    JtJ = torch.einsum("mji,mjk->mik", jacobians, jacobians)
    scale = torch.diagonal(JtJ, dim1=-2, dim2=-1).sum(-1)[..., None, None] / 3.0 + 1e-12
    jitter = torch.diag(torch.tensor([1.0, 2.0, 3.0], device=JtJ.device)) * 1e-6
    eig = sym3x3_eigvalsh(JtJ + jitter * scale)
    logs = 0.5 * torch.log(torch.clamp(eig, min=1e-12))
    return _mean(gm_robust_error(torch.sum(logs * logs, -1), c), valid, total)


def normal_pullback_loss(gt_normals_img, jacobians, sdf_normals, rays, cam_R, batch_inds,
                         valid, N, weighted: bool = True, deformed_normals=None):
    """Normal supervision: the gt screen-space normal → world through
    R·diag(−1, 1, −1) → canonical through Jᵀ, against the canonical SDF
    normal; weighted by (−ray·n̂_deformed)² when ``weighted``. Per-frame
    mean over valid rays that have a gt normal."""
    flip = torch.diag(torch.tensor([-1.0, 1.0, -1.0], device=rays.device))
    gtn = torch.einsum("ij,mj->mi", cam_R @ flip, gt_normals_img)
    norms = torch.linalg.norm(gtn, dim=-1, keepdim=True)
    has_gt = norms[..., 0] > 1e-4
    gtn = torch.where(has_gt[:, None], gtn / torch.clamp(norms, min=1e-9), gtn)
    gtn_cano = torch.einsum("mji,mj->mi", jacobians, gtn)
    if weighted and deformed_normals is not None:
        w = torch.clamp(torch.sum(-rays * deformed_normals.detach(), -1), 0.0, 1.0) ** 2
    else:
        w = torch.ones_like(gtn[:, 0])
    vals = torch.linalg.norm(gtn_cano - sdf_normals, dim=-1) * w
    return per_frame_scatter_mean(vals, batch_inds, valid & has_gt, N)


def dct_pose_loss(dct_null, posed_joints_windows):
    """Temporal prior: mean |high-frequency DCT coefficients| of posed-joint
    windows. dct_null (K, Nlen), windows (N, Nlen, 24, 3)."""
    N, Nlen = posed_joints_windows.shape[:2]
    coef = torch.einsum("kn,bnj->bkj", dct_null, posed_joints_windows.reshape(N, Nlen, 72))
    return torch.mean(torch.abs(coef))
