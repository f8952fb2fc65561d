"""Rectified perspective camera (counterpart of
``recmv_tpu/models/camera.py``): pytorch3d conventions, with the screen
mapping rectified to the rasterizer's pixel grid.

- world → camera: x_cam = x_world @ R + T.
- NDC: ndc_x = fx_n·x/z + px_n with fx_n = fx/(W/2), px_n = 1 − 1/W − px/(W/2).
- screen: sx = (W − 1)/2 − W·ndc_x/2.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from ..ops.math3d import quat2mat


@dataclass
class Camera:
    focal: torch.Tensor      # (2,) fx, fy in pixels
    principal: torch.Tensor  # (2,) px, py in pixels
    quat: torch.Tensor       # (4,) cam2world rotation (w, x, y, z)
    trans: torch.Tensor      # (3,) world2cam translation
    image_size: tuple        # (W, H)

    @property
    def R(self) -> torch.Tensor:
        return quat2mat(self.quat[None])[0]


def make_camera(camera_params: dict, image_size, device=None) -> Camera:
    """From the dataset's camera parameter dict."""
    def t(k, n):
        return torch.as_tensor(np.asarray(camera_params[k], np.float32),
                               device=device).reshape(n)

    return Camera(focal=t("focal_length", 2), principal=t("princeple_points", 2),
                  quat=t("cam2world_coord_quat", 4), trans=t("world2cam_coord_trans", 3),
                  image_size=(int(image_size[0]), int(image_size[1])))


def world_to_cam(cam: Camera, pts: torch.Tensor) -> torch.Tensor:
    return pts @ cam.R + cam.trans


def transform_points_ndc(cam: Camera, pts: torch.Tensor, eps: float = 1e-8) -> torch.Tensor:
    """World → rectified NDC (x, y, 1/z)."""
    W, H = cam.image_size
    pc = world_to_cam(cam, pts)
    z = pc[..., 2]
    zs = torch.where(z.abs() < eps, torch.where(z >= 0, eps, -eps), z)
    fxn = cam.focal[0] / (W / 2.0)
    fyn = cam.focal[1] / (H / 2.0)
    pxn = 1.0 - 1.0 / W - cam.principal[0] / (W / 2.0)
    pyn = 1.0 - 1.0 / H - cam.principal[1] / (H / 2.0)
    x = fxn * pc[..., 0] / zs + pxn
    y = fyn * pc[..., 1] / zs + pyn
    return torch.stack([x, y, 1.0 / zs], dim=-1)


def transform_points_screen(cam: Camera, pts: torch.Tensor) -> torch.Tensor:
    """World → screen pixels (x, y, ndc_z)."""
    W, H = cam.image_size
    ndc = transform_points_ndc(cam, pts)
    sx = (W - 1.0) / 2.0 - W * ndc[..., 0] / 2.0
    sy = (H - 1.0) / 2.0 - H * ndc[..., 1] / 2.0
    return torch.stack([sx, sy, ndc[..., 2]], dim=-1)


def view_rays(cam: Camera, pix: torch.Tensor) -> torch.Tensor:
    """pix (..., 3) pixel coords with homogeneous 1 last → world unit rays."""
    rx = -pix[..., 0] / cam.focal[0] + pix[..., 2] * cam.principal[0] / cam.focal[0]
    ry = -pix[..., 1] / cam.focal[1] + pix[..., 2] * cam.principal[1] / cam.focal[1]
    rays = torch.stack([rx, ry, pix[..., 2]], dim=-1)
    rays = rays / torch.linalg.norm(rays, dim=-1, keepdim=True)
    return rays @ cam.R.T


def cam_pos(cam: Camera) -> torch.Tensor:
    """Camera centre in world coordinates: −R @ T."""
    return -(cam.R @ cam.trans)


def ang_threshold(cam: Camera, pixoffset: float = 0.4) -> float:
    """Sub-pixel angle bound (degrees), the surface solver's convergence
    criterion: the smallest angle a ``pixoffset`` shift subtends at any
    image border."""
    W, H = cam.image_size
    fx, fy = (float(v) for v in cam.focal)
    cx, cy = (float(v) for v in cam.principal)

    def ang(r1, r2):
        r1 = np.asarray(r1)
        r2 = np.asarray(r2)
        s = np.linalg.norm(np.cross(r1, r2)) / (np.linalg.norm(r1) * np.linalg.norm(r2))
        return float(np.arcsin(np.clip(s, -1, 1)) / np.pi * 180.0)

    thred = ang([(W - cx) / fx, 0, 1], [(W + pixoffset - cx) / fx, 0, 1])
    thred = min(thred, ang([-cx / fx, 0, 1], [(pixoffset - cx) / fx, 0, 1]))
    thred = min(thred, ang([0, (H - cy) / fy, 1], [0, (H + pixoffset - cy) / fy, 1]))
    thred = min(thred, ang([0, -cy / fy, 1], [0, (pixoffset - cy) / fy, 1]))
    return thred
