"""LBS voxel skinner (counterpart of ``recmv_tpu/models/skinner.py``):
SMPL linear blend skinning driven by a 24-channel voxel skinning-weight
field sampled trilinearly; the stored inverse A-pose chain makes the
deformation A-pose canonical → T-rest → posed. The weight field is built
on the sampling cube (the JAX module's documented deviation from the
reference)."""

from __future__ import annotations

from dataclasses import dataclass, fields

import numpy as np
import torch

from ..ops.grid_sample import grid_sample_3d
from ..ops.math3d import batch_rodrigues
from .smpl import SMPL_PARENTS, SMPLModel, forward_kinematics, smpl_forward, smpl_skeleton


@dataclass
class SkinnerParams:
    ws: torch.Tensor             # (24, D, H, W) weight field
    Js: torch.Tensor             # (24, 3) rest joints
    init_pose_inv: torch.Tensor  # (24, 4, 4) inverse A-pose chain
    extra_trans: torch.Tensor    # (1, 3)
    bbox_center: torch.Tensor    # (3,)
    bbox_extend: torch.Tensor    # () cube side
    b_min: torch.Tensor          # (3,) data bbox
    b_max: torch.Tensor          # (3,)

    def to(self, device) -> "SkinnerParams":
        return SkinnerParams(**{f.name: getattr(self, f.name).to(device) for f in fields(self)})


def bbox_size(sk: SkinnerParams):
    """Margin-padded bbox of the SDF evaluation domain."""
    margin = torch.tensor([0.15, 0.15, 0.20], dtype=torch.float32, device=sk.b_min.device)
    return sk.b_min - margin, sk.b_max + margin


def init_pose_inverse(init_pose_rotmats: torch.Tensor, Js: torch.Tensor, parents) -> torch.Tensor:
    """Inverse of the A-pose chain: (24, 4, 4) with [Rᵀ, −Rᵀ T]."""
    parents = np.asarray(parents)
    Rs = [init_pose_rotmats[0]]
    Ts = [Js[0]]
    for i in range(1, parents.shape[0]):
        j_rel = Js[i] - Js[parents[i]]
        Rs.append(Rs[parents[i]] @ init_pose_rotmats[i])
        Ts.append(Rs[parents[i]] @ j_rel + Ts[parents[i]])
    invs = []
    for R, T in zip(Rs, Ts):
        inv = torch.zeros(4, 4, dtype=R.dtype, device=R.device)
        inv[:3, :3] = R.T
        inv[:3, 3] = -(R.T @ T)
        inv[3, 3] = 1.0
        invs.append(inv)
    return torch.stack(invs)


def skinning_transforms(sk: SkinnerParams, poses: torch.Tensor, parents=SMPL_PARENTS):
    """poses (B, 24, 3) → per-joint skinning transforms (B, 24, 4, 4)."""
    B = poses.shape[0]
    rotmats = batch_rodrigues(poses.reshape(-1, 3)).reshape(B, 24, 3, 3)
    return forward_kinematics(rotmats, sk.Js, parents) @ sk.init_pose_inv[None]


def inv_transform_v(sk: SkinnerParams, v: torch.Tensor) -> torch.Tensor:
    """World → normalized sampling coordinates."""
    return (v - sk.bbox_center) / sk.bbox_extend * 2.0


def sample_skin_weights(sk: SkinnerParams, tps: torch.Tensor) -> torch.Tensor:
    """tps (..., 3) → (N, 24) LBS weights."""
    return grid_sample_3d(sk.ws, inv_transform_v(sk, tps.reshape(-1, 3)))


def skinner_apply(sk: SkinnerParams, ps, poses, trans, batch_inds=None, also_apply=None):
    """Pose canonical points with LBS.

    ps (B, N, 3) with poses (B, 24, 3), trans (B, 3); or flat (M, 3) with
    ``batch_inds`` (M,) naming each point's frame. ``also_apply``: a second
    point set posed with the same blended transforms (weights sampled at
    ``ps``) — returns (posed_ps, posed_also)."""
    A = skinning_transforms(sk, poses)
    trans = trans + sk.extra_trans
    if batch_inds is not None:
        return skin_rows(sk, ps, A[batch_inds], trans[batch_inds], also_apply)
    ws = sample_skin_weights(sk, ps)
    B, N, _ = ps.shape
    T = torch.einsum("bnj,bjxy->bnxy", ws.reshape(B, N, 24), A)

    def pose_pts(q):
        qh = torch.cat([q, torch.ones_like(q[..., :1])], dim=-1)
        return torch.einsum("bnxy,bny->bnx", T, qh)[..., :3] + trans[:, None, :]

    if also_apply is not None:
        return pose_pts(ps), pose_pts(also_apply.expand_as(ps))
    return pose_pts(ps)


def skin_rows(sk: SkinnerParams, ps, A_rows, trans_rows, also_apply=None):
    """``skinner_apply``'s flat form with each row's frame already gathered:
    ps (M, 3), A_rows (M, 24, 4, 4) skinning transforms, trans_rows (M, 3)
    translations with the extra one added."""
    ws = sample_skin_weights(sk, ps)
    T = torch.einsum("mj,mjxy->mxy", ws, A_rows)

    def pose_flat(q):
        qh = torch.cat([q, torch.ones_like(q[:, :1])], dim=-1)
        return torch.einsum("mxy,my->mx", T, qh)[..., :3] + trans_rows

    if also_apply is not None:
        return pose_flat(ps.reshape(-1, 3)), pose_flat(also_apply.reshape(-1, 3))
    return pose_flat(ps.reshape(-1, 3))


def posed_skeleton(sk: SkinnerParams, poses: torch.Tensor, parents=SMPL_PARENTS):
    """FK joint positions per frame (B, 24, 3)."""
    B = poses.shape[0]
    rotmats = batch_rodrigues(poses.reshape(-1, 3)).reshape(B, 24, 3, 3)
    return forward_kinematics(rotmats, sk.Js, parents)[:, :, :3, 3]


def smooth_weights(w: torch.Tensor, times: int = 3) -> torch.Tensor:
    """Six-neighbour partial smoothing + renormalization, w (C, D, H, W)."""
    for _ in range(times):
        interior_mean = (
            w[:, 2:, 1:-1, 1:-1] + w[:, :-2, 1:-1, 1:-1]
            + w[:, 1:-1, 2:, 1:-1] + w[:, 1:-1, :-2, 1:-1]
            + w[:, 1:-1, 1:-1, 2:] + w[:, 1:-1, 1:-1, :-2]
        ) / 6.0
        blended = (w[:, 1:-1, 1:-1, 1:-1] - interior_mean) * 0.7 + interior_mean
        w = w.clone()
        w[:, 1:-1, 1:-1, 1:-1] = blended
        w = w / w.sum(0, keepdim=True)
    return w


def compute_lbsw_field(center, extend, resolution, smpl_verts, smpl_ws,
                       chunk: int = 65536) -> torch.Tensor:
    """Diffuse per-vertex SMPL weights into a (24, D, H, W) voxel field on
    the cube [center ± extend/2], resolution = (W, H, D): inverse-distance
    blend of the 30 nearest vertices, then 30 smoothing rounds; distances
    in chunks of ``chunk`` voxels."""
    W, H, D = (int(r) for r in resolution)
    dev = smpl_verts.device
    b_min = center - extend / 2.0
    step = extend / torch.tensor([W, H, D], dtype=torch.float32, device=dev)
    zz, yy, xx = torch.meshgrid(torch.arange(D, device=dev), torch.arange(H, device=dev),
                                torch.arange(W, device=dev), indexing="ij")
    coords = torch.stack([xx, yy, zz], -1).reshape(-1, 3).to(torch.float32)
    world = coords * step + b_min + step / 2.0
    v_sq = torch.sum(smpl_verts ** 2, dim=-1)
    out = []
    for s in range(0, world.shape[0], chunk):
        pts = world[s:s + chunk]
        d2 = torch.sum(pts ** 2, -1)[:, None] - 2.0 * pts @ smpl_verts.T + v_sq[None]
        d = torch.sqrt(torch.clamp(d2, min=0.0))
        dist, idx = torch.topk(d, 30, dim=-1, largest=False)
        wk = 1.0 / torch.clamp(dist, 1e-4, 1.0)
        wk = wk / wk.sum(-1, keepdim=True)
        out.append(torch.einsum("nk,nkj->nj", wk, smpl_ws[idx]))
    fws = torch.cat(out).T.reshape(smpl_ws.shape[-1], D, H, W)
    return smooth_weights(fws, 30)


def initial_lbs_skinner(model: SMPLModel, shape: torch.Tensor, init_pose, resolution=(129, 225, 65),
                        extra_trans=None):
    """Skinner of a shaped body in the A-pose → (SkinnerParams, A-pose body
    verts (V, 3), faces (F, 3) numpy). Runs on ``shape``'s device."""
    dev = shape.device
    init_pose = torch.as_tensor(np.asarray(init_pose), dtype=torch.float32, device=dev)
    Js = smpl_skeleton(model, shape)
    verts = smpl_forward(model, shape, init_pose.reshape(1, 24, 3))[0][0]
    bmin = verts.min(0).values
    bmax = verts.max(0).values
    extend = (bmax - bmin).max() * 1.1
    center = (bmin + bmax) / 2.0
    ws = compute_lbsw_field(center, extend, resolution, verts,
                            torch.as_tensor(model.weights, device=dev))
    rotmats = batch_rodrigues(init_pose.reshape(24, 3))
    inv = init_pose_inverse(rotmats, Js, model.parents)
    if extra_trans is None:
        extra_trans = torch.zeros(1, 3, device=dev)
    sk = SkinnerParams(ws=ws, Js=Js, init_pose_inv=inv,
                       extra_trans=torch.as_tensor(extra_trans, device=dev).reshape(1, 3),
                       bbox_center=center, bbox_extend=extend, b_min=bmin, b_max=bmax)
    return sk, verts, model.faces
