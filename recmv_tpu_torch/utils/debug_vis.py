"""Visual debug dumps (counterpart of ``recmv_tpu/utils/debug_vis.py``).

Parity with the reference's ``save_debug``
(``OptimGarmentNetwork.py:1971-2158``: projected feature curves drawn
over the gt frame + predicted garment silhouettes vs gt masks) and
``visualize_curve_mesh`` (``:3320-3484``: turntable renders of the
canonical MC garment meshes with the optimized curves overlaid). Host
numpy around the mesh rasterizer (``ops/rasterizer.rasterize_mesh``, K1
on the card), at remesh cadence, never in the hot loop; everything runs
under ``torch.no_grad()``. PNGs are written with ``data/png.imwrite``
(BGR, as OpenCV's ``imwrite``, which the JAX module calls).

Where the JAX module rasterizes one view or frame per call, this one
puts a garment's frames (``save_debug``) or its turntable views (one
batched call of 8 views) through one ``rasterize_mesh``: the binning
quantizes depth over each frame's own range, so each view gets the bits
a call of its own would give.
"""

from __future__ import annotations

import os
import os.path as osp

import numpy as np
import torch

from ..config.constants import FL_EXTRACT
from ..core.network import _ratio_dict
from ..data.png import imwrite
from ..models import camera as cam_mod
from ..models.curves import curves_forward
from ..models.garment_model import make_deform_fn, split_deform_conds
from ..ops.math3d import compute_fnorms
from ..ops.rasterizer import rasterize_mesh, screen_with_cam_z
from .io import save_obj

CURVE_COLORS = [(255, 64, 64), (64, 255, 64), (64, 64, 255), (255, 255, 64),
                (255, 64, 255), (64, 255, 255)]

# per-joint debug colors for LBS weight visualization
# (weights2colors parity, engineer/utils/skinning_weights.py: joints of
# one kinematic group share a hue; 'pink' → white)
_JOINT_GROUP = ["pink", "blue", "green", "red", "pink", "pink", "pink",
                "green", "blue", "red", "pink", "pink", "pink", "blue",
                "green", "red", "cyan", "darkgreen", "pink", "pink",
                "blue", "green", "pink", "pink"]
_GROUP_RGB = {"pink": (1.0, 1.0, 1.0), "blue": (0.12, 0.47, 0.71),
              "green": (0.70, 0.87, 0.54), "red": (0.89, 0.10, 0.11),
              "cyan": (0.70, 0.87, 0.54), "darkgreen": (0.12, 0.47, 0.71)}


def lbs_weights_to_colors(weights: np.ndarray) -> np.ndarray:
    """(V, 24) skinning weights → (V, 3) debug vertex colors
    (weights2colors, engineer/utils/skinning_weights.py:5-50)."""
    palette = np.asarray([_GROUP_RGB[g] for g in _JOINT_GROUP])  # (24, 3)
    return np.asarray(weights) @ palette


def _splat(img, pts_xy, color, radius=1):
    H, W = img.shape[:2]
    for x, y in np.asarray(pts_xy):
        xi, yi = int(round(x)), int(round(y))
        if 0 <= xi < W and 0 <= yi < H:
            img[max(yi - radius, 0): yi + radius + 1,
                max(xi - radius, 0): xi + radius + 1] = color
    return img


@torch.no_grad()
def save_debug(net, batch, frame_ids, ratio, out_dir, step: int = 0,
               visualizer=None):
    """Write per-frame debug overlays: gt image with the projected
    (posed) feature curves splatted per curve color, and the deformed
    garment mesh silhouette vs the gt garment mask (one ``rasterize_mesh``
    of the batch's frames per garment)."""
    os.makedirs(out_dir, exist_ok=True)
    r = _ratio_dict(ratio)
    dev = net.device
    # frame_ids are local dataset indices; scene arrays are global
    fids = torch.as_tensor(np.asarray(frame_ids) + net.dataset.start_idx, device=dev)
    cam = net._camera()
    N = int(fids.shape[0])
    W, H = net.statics.image_size
    imgs = np.asarray(batch["img"])  # (N, H, W, 3) in [-1, 1] or [0,1]
    if imgs.min() < -0.01:
        imgs = (imgs + 1.0) / 2.0

    curves = curves_forward(net.params["curves"], net.curve_statics)
    scene = net.scene
    conds = split_deform_conds(scene["conds"]["deformer"][fids], net.statics.garment_size)
    poses = scene["poses"][fids]
    trans = scene["trans"][fids]

    overlays = (imgs * 255).astype(np.uint8).copy()
    name_to_idx = {n: i for i, n in enumerate(net.curve_statics.fl_names)}
    def_vs = (net._deform_garment_verts(net.mesh.garment_vs, fids, ratio)
              if net.mesh is not None else None)
    for gi, gname in enumerate(net.statics.garment_names):
        mp = {"translator": net.params["translator"], "skinner": net.params["skinner"]}
        deform = make_deform_fn(mp, conds[gi + 1], poses, trans, r["deformerRatio"])
        for k, cname in enumerate(FL_EXTRACT[gname]):
            if cname not in name_to_idx:
                continue
            cv = curves[name_to_idx[cname]]
            S = cv.shape[0]
            def_fl = deform(cv.expand(N, S, 3))
            scr = cam_mod.transform_points_screen(cam, def_fl).cpu().numpy()
            for b in range(N):
                _splat(overlays[b], scr[b, :, :2], CURVE_COLORS[k % len(CURVE_COLORS)])

        # silhouette of the deformed MC garment mesh vs gt mask
        if def_vs is not None:
            fs = net.mesh.garment_fs[gi]
            frag = rasterize_mesh(screen_with_cam_z(cam, def_vs[gi]), fs, (H, W),
                                  tile=net.cfg.raster_tile, cap=net.cfg.raster_cap_mesh)
            sils = (frag.pix_to_face[..., 0] >= 0).cpu().numpy()
            gt_key = ("upper_bottom" if net.statics.garment_size == 1
                      and "upper_bottom" in batch else
                      ("bottom" if gname in ("long_pants", "short_pants", "skirt")
                       else "upper"))
            gts = np.asarray(batch.get(gt_key, np.zeros((N, H, W)))) > 0
            for b in range(N):
                vis = np.zeros((H, W, 3), np.uint8)
                vis[..., 1] = sils[b] * 160                  # pred = green
                vis[..., 2] = gts[b] * 160                   # gt = red (BGR)
                fid = int(np.asarray(frame_ids)[b])
                imwrite(osp.join(out_dir, f"{step:06d}_{fid:04d}_{gname}_mask.png"), vis)

    for b in range(N):
        fid = int(np.asarray(frame_ids)[b])
        imwrite(osp.join(out_dir, f"{step:06d}_{fid:04d}_curves.png"),
                np.ascontiguousarray(overlays[b][:, :, ::-1]))
        if visualizer is not None:
            visualizer.add_image(f"debug/curves_{fid}", overlays[b], step)
    return out_dir


def turntable_cameras(n_views: int, image: int, device) -> list:
    """The turntable's cameras: on a circle of radius 2.5 in the xz plane,
    looking at the origin, focal 1.2·image."""
    def t(a):
        return torch.as_tensor(np.asarray(a, np.float32), device=device)

    cams = []
    for k in range(n_views):
        ang = 2 * np.pi * k / n_views
        quat = np.asarray([np.cos((ang + np.pi) / 2), 0.0,
                           np.sin((ang + np.pi) / 2), 0.0], np.float32)
        cams.append(cam_mod.Camera(focal=t([image * 1.2, image * 1.2]),
                                   principal=t([image / 2.0, image / 2.0]), quat=t(quat),
                                   trans=t([0.0, 0.0, 2.5]), image_size=(image, image)))
    return cams


@torch.no_grad()
def turntable_curve_mesh(net, ratio, out_dir, n_views: int = 8,
                         image: int = 256, step: int = 0, visualizer=None,
                         save_meshes: bool = True):
    """Turntable renders of the canonical garment MC meshes with curve
    points overlaid (visualize_curve_mesh, OptimGarmentNetwork.py:3320):
    the ``n_views`` views of a garment in one ``rasterize_mesh`` (tile 32,
    cap 256). Writes one image strip per garment + optional obj dumps;
    returns the strips (RGB uint8). A garment the remesh left empty gets
    blank views with its curves about the origin (the JAX function fails
    on it: the mean of no vertices is NaN)."""
    os.makedirs(out_dir, exist_ok=True)
    if net.mesh is None:
        net.marching_cube_update(_ratio_dict(ratio))
    dev = net.device
    curves = curves_forward(net.params["curves"], net.curve_statics).cpu().numpy()
    cams = turntable_cameras(n_views, image, dev)

    strips = []
    for gi, gname in enumerate(net.statics.garment_names):
        nv = net.mesh.garment_n[gi]
        nf = net.mesh.garment_fn[gi]
        verts = net.mesh.garment_vs[gi][:nv].cpu().numpy()
        faces = net.mesh.garment_fs[gi][:nf].cpu().numpy()
        if save_meshes:
            save_obj(osp.join(out_dir, f"{step:06d}_{gname}.obj"), verts, faces)
        # a garment that vanished in the remesh renders blank views
        center = verts.mean(0) if nv else np.zeros(3, np.float32)
        sh = torch.as_tensor(verts - center, device=dev)
        faces_t = torch.as_tensor(faces, dtype=torch.int64, device=dev)
        fid_imgs = np.full((n_views, image, image), -1)
        fn = np.zeros((0, 3), np.float32)
        if nf:
            scr = torch.stack([screen_with_cam_z(cam, sh) for cam in cams])
            fid_imgs = rasterize_mesh(scr, faces_t, (image, image), tile=32,
                                      cap=256).pix_to_face[..., 0].cpu().numpy()
            fn = compute_fnorms(sh, faces_t).cpu().numpy()
        views = []
        for cam, fid_img in zip(cams, fid_imgs):
            shade = np.zeros((image, image, 3), np.uint8)
            hit = fid_img >= 0
            lam = np.abs((fn @ cam.R.cpu().numpy()[:, 2]))[fid_img[hit]]
            shade[hit] = (np.asarray([[180, 180, 200]]) *
                          (0.25 + 0.75 * lam[:, None])).astype(np.uint8)
            for ci in range(len(net.curve_statics.fl_names)):
                pix = cam_mod.transform_points_screen(
                    cam, torch.as_tensor(curves[ci] - center, device=dev)).cpu().numpy()
                _splat(shade, pix[:, :2], CURVE_COLORS[ci % len(CURVE_COLORS)])
            views.append(shade)
        strip = np.concatenate(views, axis=1)
        strips.append(strip)
        imwrite(osp.join(out_dir, f"{step:06d}_{gname}_turntable.png"),
                np.ascontiguousarray(strip[:, :, ::-1]))
        if visualizer is not None:
            visualizer.add_image(f"debug/turntable_{gname}", strip, step)
    return strips
