"""The frames of a scene whose garments and rings a scene module gives:
the frozen generator's body, A-pose, turn, camera, shading and file
layout (``reference/recmv/data/synthetic.generate_scene``), with the
garment meshes and the curves' rings as arguments in place of its
built-in tables. Given the built-in tables' meshes and rings it writes
the frozen generator's files (``benchmark/tests``)."""

from __future__ import annotations

import json
import os
import os.path as osp

import numpy as np
import torch

from ..reference.recmv import resolve_device
from ..reference.recmv.data.png import imwrite
from ..reference.recmv.data.synthetic import (_longest_circular_run, _scene_meta, apose,
                                              make_camera_params)
from ..reference.recmv.models import camera as cam_mod
from ..reference.recmv.models.skinner import SkinnerParams, initial_lbs_skinner, skinner_apply
from ..reference.recmv.models.smpl import synthetic_body_model
from ..reference.recmv.ops.math3d import compute_fnorms
from ..reference.recmv.ops.rasterizer import rasterize_mesh, screen_with_cam_z

TINTS = ([0.25, 0.35, 0.8], [0.7, 0.3, 0.35], [0.3, 0.7, 0.4])
YAW_RANGE = 2 * np.pi


def render_scene(out_dir: str, n_frames: int, image_size: int, skinner_res, raster_cap: int,
                 device, *, garment_type: str, version: int, pieces: list, rings: list,
                 diffused: bool = False) -> str:
    """Write a scene of ``n_frames`` at ``image_size``² into ``out_dir`` on
    ``device``. ``pieces``: [(piece name, (verts, faces) in canonical
    space, ATR parsing label)]; ``rings``: [(curve name, (n, 3) canonical
    ring)]; ``diffused``: pose with a diffusion-smoothed skinning field and
    ship it (``diffused_skinning_weights.npy``), as loose garments need.
    The body turns once over the frames, as in the frozen generator;
    ``scene_meta.json`` records ``garment_type`` and ``version``. Returns
    ``out_dir``."""
    device = resolve_device(device)
    os.makedirs(out_dir, exist_ok=True)
    for sub in ("imgs", "masks", "parsing_SCH_ATR", "featurelines", "normals", "gt_meshes"):
        os.makedirs(osp.join(out_dir, sub), exist_ok=True)

    body = synthetic_body_model()
    pose0 = apose()
    sk, body_verts, body_faces = initial_lbs_skinner(
        body, torch.zeros(10, device=device), pose0, resolution=skinner_res)
    if diffused:
        import scipy.ndimage as ndi

        w = sk.ws.cpu().numpy()
        w = ndi.gaussian_filter(w, sigma=(0.0, 2.0, 2.0, 2.0), mode="nearest")
        w /= np.clip(w.sum(0, keepdims=True), 1e-8, None)
        np.save(osp.join(out_dir, "diffused_skinning_weights.npy"), w)
        sk = SkinnerParams(ws=torch.as_tensor(w, device=device), Js=sk.Js,
                           init_pose_inv=sk.init_pose_inv, extra_trans=sk.extra_trans,
                           bbox_center=sk.bbox_center, bbox_extend=sk.bbox_extend,
                           b_min=sk.b_min, b_max=sk.b_max)
    gmeshes = [mesh for _, mesh, _ in pieces]

    campar = make_camera_params(image_size)
    cam = cam_mod.make_camera(
        {"focal_length": np.asarray([campar["fx"], campar["fy"]]),
         "princeple_points": np.asarray([campar["cx"], campar["cy"]]),
         "cam2world_coord_quat": campar["quat"],
         "world2cam_coord_trans": campar["T"]},
        (image_size, image_size), device=device)

    H = W = image_size
    body_verts = body_verts.cpu().numpy()
    n_body = len(body_verts)
    all_v, all_f = body_verts, np.asarray(body_faces)
    face_lo = [len(all_f)]
    for gv, gf in gmeshes:
        all_f = np.concatenate([all_f, gf + len(all_v)], 0)
        all_v = np.concatenate([all_v, gv], 0)
        face_lo.append(len(all_f))
    gt_faces = np.concatenate(
        [gf + sum(len(g[0]) for g in gmeshes[:i]) for i, (_, gf) in enumerate(gmeshes)], 0)
    all_v_t = torch.as_tensor(all_v, dtype=torch.float32, device=device)
    all_f_t = torch.as_tensor(all_f, device=device)
    R = cam.R.cpu().numpy()
    zero_t = torch.zeros(1, 3, device=device)

    poses, trans = [], []
    for fid in range(n_frames):
        pose = pose0.copy()
        pose[0, 1] = YAW_RANGE * fid / max(n_frames, 1)
        poses.append(pose)
        trans.append(np.zeros(3, np.float32))
        pose_t = torch.as_tensor(pose, device=device)[None]

        posed_t = skinner_apply(sk, all_v_t[None], pose_t, zero_t)[0]
        posed = posed_t.cpu().numpy()
        pg = posed[n_body:]
        frag = rasterize_mesh(screen_with_cam_z(cam, posed_t)[None], all_f_t, (H, W),
                              tile=32, cap=raster_cap)
        pix2face = frag.pix_to_face[0, ..., 0].cpu().numpy()
        mask = pix2face >= 0
        gar_hit = pix2face >= face_lo[0]

        fn = compute_fnorms(posed_t, all_f_t).cpu().numpy()
        fn_cam = fn @ R
        nimg = np.zeros((H, W, 3), np.float32)
        nimg[mask] = fn_cam[pix2face[mask]]
        nimg[..., 2] *= -1

        img = np.zeros((H, W, 3), np.float32)
        shade = np.clip(nimg[..., 2], 0, 1)[..., None]
        img[mask & ~gar_hit] = (np.asarray([0.75, 0.6, 0.5]) * shade[mask & ~gar_hit])
        parsing = np.zeros((H, W), np.uint8)
        parsing[mask] = 9   # skin → a label outside ATR garment groups
        for i, (_, _, atr_label) in enumerate(pieces):
            sel = (pix2face >= face_lo[i]) & (pix2face < face_lo[i + 1])
            img[sel] = np.asarray(TINTS[i % len(TINTS)]) * shade[sel]
            parsing[sel] = atr_label

        imwrite(osp.join(out_dir, f"imgs/{fid}.png"), (img[:, :, ::-1] * 255).astype(np.uint8))
        imwrite(osp.join(out_dir, f"masks/{fid}.png"), (mask * 255).astype(np.uint8))
        imwrite(osp.join(out_dir, f"normals/{fid}.png"),
                ((nimg[:, :, ::-1] + 1) / 2 * 255).astype(np.uint8))
        np.save(osp.join(out_dir, f"parsing_SCH_ATR/{fid}.npy"), parsing)
        np.save(osp.join(out_dir, f"parsing_SCH_ATR/mask_parsing_{fid}.npy"), parsing)

        # feature lines: the longest visible arc of each posed ring, as an
        # annotator would trace it
        zbuf0 = frag.zbuf[0, ..., 0].cpu().numpy()
        shapes = []
        for name, ring in rings:
            ring_t = torch.as_tensor(ring, dtype=torch.float32, device=device)
            posed_ring = skinner_apply(sk, ring_t[None], pose_t, zero_t)
            scr_ring = screen_with_cam_z(cam, posed_ring)[0].cpu().numpy()
            xi = np.clip(np.round(scr_ring[:, 0]).astype(int), 0, W - 1)
            yi = np.clip(np.round(scr_ring[:, 1]).astype(int), 0, H - 1)
            zb = zbuf0[yi, xi]
            vis = (zb < 0) | (scr_ring[:, 2] <= zb + 0.03)
            idx = _longest_circular_run(vis)
            if len(idx) < max(3, int(0.3 * len(vis))):
                continue
            shapes.append({"label": name, "shape_type": "linestrip",
                           "points": scr_ring[idx, :2].tolist()})
        with open(osp.join(out_dir, f"featurelines/{fid}.json"), "w") as f:
            json.dump({"shapes": shapes}, f)

        np.savez(osp.join(out_dir, f"gt_meshes/{fid}.npz"), verts=pg, faces=gt_faces,
                 piece_names=np.asarray([p[0] for p in pieces]),
                 piece_sizes=np.asarray([len(g[0]) for g in gmeshes]))

    np.savez(osp.join(out_dir, "smpl_rec.npz"), poses=np.stack(poses), trans=np.stack(trans),
             shape=np.zeros(10, np.float32), gender="synthetic")
    np.savez(osp.join(out_dir, "camera.npz"), **make_camera_params(image_size))
    with open(osp.join(out_dir, "scene_meta.json"), "w") as f:
        json.dump(dict(_scene_meta(n_frames, image_size, YAW_RANGE, skinner_res, raster_cap,
                                   garment_type), version=int(version)), f)
    return out_dir
