"""SMPL shape (beta) pre-fit from 2D joints (counterpart of
``recmv_tpu/core/beta_optimizer.py``; reference
``engineer/core/beta_optimizer.py:132-245``): before the skinner is built,
fit the SMPL betas and an extra global translation so the projected SMPL
joints match the TCMR 2D keypoints (confidence-weighted L1, COCO order),
150 Adam steps at lr 5e-3 on up to 8 frames. Runs once per scene, eagerly
on the dataset's scene camera; the loop reads nothing back from the
device."""

from __future__ import annotations

import numpy as np
import torch

from .. import resolve_device
from ..models import camera as cam_mod
from ..models.smpl import SMPLModel, smpl_forward

# cocoplus (SMPL joint_regressor output order) → COCO-17
COCOPLUS2COCO = [14, 15, 16, 17, 18, 9, 8, 10, 7, 11, 6, 3, 2, 4, 1, 5, 0]


def batch_kp_2d_l1_loss(real_2d_kp, predict_2d_kp):
    """Confidence-weighted L1 (beta_optimizer.py:69-80). real (.., K, 3)
    with [x, y, conf]; predict (.., K, 2)."""
    gt = real_2d_kp.reshape(-1, 3)
    pred = predict_2d_kp.reshape(-1, 2)
    vis = gt[:, 2]
    k = torch.sum(vis) * 2.0 + 1e-8
    dif = torch.sum(torch.abs(gt[:, :2] - pred), dim=1)
    return torch.dot(dif, vis) / k


def fit_frames(dataset, batch: int = 8, device=None):
    """The frames the pre-fit uses: up to ``batch`` of the TCMR frames,
    evenly strided → (gt joints (N, K, 3), poses (N, 24, 3), trans (N, 3),
    camera). As in the JAX package, a TCMR frame id less ``start_idx``
    (clamped to the range) indexes the scene's poses and translations."""
    device = resolve_device(device)
    j2d = dataset.gt_joints2d
    fids = sorted(j2d.keys())[:: max(len(j2d) // batch, 1)][:batch]
    local = [min(max(f - dataset.start_idx, 0), dataset.frame_num - 1) for f in fids]

    def t(a):
        return torch.as_tensor(np.asarray(a, np.float32), device=device)

    gt = t(np.stack([j2d[f] for f in fids]))
    cam = cam_mod.make_camera(dataset.params.camera, (dataset.W, dataset.H), device=device)
    return gt, t(dataset.params.poses[local]), t(dataset.params.trans[local]), cam


def projected_joints(model: SMPLModel, betas, extra_trans, poses, trans, cam,
                     joint_regressor=None):
    """Screen positions (N, K, 2) of the SMPL joints of ``betas`` under
    ``poses`` and ``trans + extra_trans``: the cocoplus joints in COCO
    order through ``joint_regressor`` (V, 19), else the 24 skeleton joints."""
    verts, joints, _ = smpl_forward(model, betas, poses)
    shift = (trans + extra_trans)[:, None, :]
    if joint_regressor is not None:
        jr = torch.as_tensor(np.asarray(joint_regressor, np.float32), device=verts.device)
        j = torch.einsum("vj,bvc->bjc", jr, verts + shift)[:, COCOPLUS2COCO, :]
    else:
        j = joints + shift
    return cam_mod.transform_points_screen(cam, j)[..., :2]


def reprojection_loss(model, betas, extra_trans, frames, joint_regressor=None):
    """The pre-fit's objective on ``fit_frames``' output."""
    gt, poses, trans, cam = frames
    pred = projected_joints(model, betas, extra_trans, poses, trans, cam, joint_regressor)
    K = min(pred.shape[1], gt.shape[1])
    return batch_kp_2d_l1_loss(gt[:, :K], pred[:, :K])


def smpl_beta_optimizer(model: SMPLModel, init_pose, dataset, n_iters: int = 150,
                        lr: float = 5e-3, batch: int = 8,
                        joint_regressor: np.ndarray | None = None, device=None):
    """Fit (betas (10,), extra_trans (1, 3)) to ``dataset.gt_joints2d`` →
    numpy arrays; the scene's betas and zeros when it has no joints.

    ``joint_regressor``: optional cocoplus regressor (V, 19); without it
    the model's 24 skeleton joints stand in (the synthetic body has no
    cocoplus asset). ``torch.optim.Adam(lr)`` is ``optax.adam(lr)``:
    betas (0.9, 0.999), m̂/(√v̂ + 1e-8). Runs on ``device`` (the CUDA card
    when none is given)."""
    if dataset.gt_joints2d is None:
        return np.asarray(dataset.params.shape), np.zeros((1, 3), np.float32)
    device = resolve_device(device)
    frames = fit_frames(dataset, batch, device)
    betas = torch.tensor(np.asarray(dataset.params.shape, np.float32), device=device,
                         requires_grad=True)
    extra = torch.zeros(1, 3, device=device, requires_grad=True)
    opt = torch.optim.Adam([betas, extra], lr=lr, betas=(0.9, 0.999), eps=1e-8)
    for _ in range(n_iters):
        opt.zero_grad(set_to_none=True)
        reprojection_loss(model, betas, extra, frames, joint_regressor).backward()
        opt.step()
    return betas.detach().cpu().numpy(), extra.detach().cpu().numpy()
