"""Synthetic scene generator (counterpart of ``recmv_tpu/data/synthetic.py``):
the procedural humanoid wearing a garment, self-rotating in front of a
fixed camera, written in the reference's on-disk scene layout (imgs/,
masks/, parsing_SCH_ATR/, featurelines/, normals/, gt_meshes/,
smpl_rec.npz, camera.npz).

The geometry (garment SDFs, boundary rings, camera) is copied from the
JAX module. The frames are rendered through the port: skinning in torch,
the mesh rasterizer (kernel K1 on a CUDA device), and the GT meshes
through the port's ``marching_cubes_np``, in the JAX package's vertex
order. PNGs are written with ``data/png.py``.
"""

from __future__ import annotations

import json
import os
import os.path as osp
import shutil

import numpy as np
import torch

from .. import resolve_device
from ..models import camera as cam_mod
from ..models.skinner import SkinnerParams, initial_lbs_skinner, skinner_apply
from ..models.smpl import synthetic_body_model, synthetic_body_sdf
from ..ops.marching_cubes import marching_cubes_np
from ..ops.math3d import compute_fnorms
from ..ops.rasterizer import rasterize_mesh, screen_with_cam_z
from .png import imwrite

GARMENT_OFFSET = 0.025
# gt band ALIGNED with the procedural template cuts (models/garment.py
# slices hip_y≈-0.33 → armpit_y≈0.23 for strapless tubes): the
# reference's template library matches its subjects' garments, so the
# synthetic gt must be producible by the template machinery — a
# mismatched band makes every quality number measure the template prior
# instead of optimizer convergence (7.8k registered verts
# above the old gt top at ~10 cm, and a narrow anatomical-neck template
# ring stretched 0.33 to reach a low wide gt ring; the y<neck_y slice's
# top boundary merged neck+armholes — non-planar — so the top band now
# stops below the armpits, where a real tube top ends).
TORSO_Y = (-0.32, 0.23)

# Bump whenever the gt geometry above changes: ensure_scene() regenerates
# stale cached scenes (and their result/ init caches) automatically.
SCENE_VERSION = 7

# Two-piece scene ("synthetic-two", TEMPLATE_GARMENT upper_tube+skirt):
# the skirt (small offset) tucks UNDER the flared upper (large offset) in
# the overlap band, so the skirt's waist curve is occluded by the upper —
# the exact inter-garment case zbuff_and / garment_zbuff exist for.
UPPER2_OFFSET = 0.045
UPPER2_Y = (-0.32, 0.23)
SKIRT_OFFSET = 0.025
# A-line flare for the two-piece scene's skirt: without it the "skirt"
# was a body-offset at shin height = TWO leg tubes, and the hem
# boundary-ring sphere trace diverges between the legs (measured r up to
# 8266 in the gt annotation — a garbage hem featureline that poisoned
# the bottom_curve fit). 0.2/m merges the legs into one hem ring
# (r 0.15-0.28) and makes the lower piece an actual skirt.
SKIRT_FLARE = 0.2
SKIRT_Y = (-0.68, -0.26)

# Loose A-line skirt scene ("synthetic-skirt" — BASELINE config #3's
# CUHKszCap-A loose skirt with fite diffused skinning): the hem flares
# away from the legs, where per-voxel body-KNN weights flip between the
# two legs mid-air and would tear a hem that crosses the midline. The
# scene poses its gt with a DIFFUSION-SMOOTHED weight field and ships
# that field as diffused_skinning_weights.npy — the same file the
# builder's fite path consumes (core/builder.py:99, reference
# lib/fite diffused-skinning assets).
LOOSE_SKIRT_OFFSET = 0.03
LOOSE_SKIRT_FLARE = 0.22      # extra offset per meter below the waist
LOOSE_SKIRT_Y = (-0.68, -0.26)


def _flare_offset(offset, y, band_top):
    """Effective offset at height y: scalar, or (base, flare) A-line."""
    if isinstance(offset, tuple):
        base, flare = offset
        return base + flare * np.maximum(band_top - y, 0.0)
    return offset


# scene type → [(garment piece name, offset, y band, ATR parsing label)];
# offset is a scalar or (base, flare-per-meter-below-band-top)
SCENE_GARMENTS = {
    "synthetic-tube": [("tube", GARMENT_OFFSET, TORSO_Y, 4)],
    "synthetic-two": [("upper_tube", UPPER2_OFFSET, UPPER2_Y, 4),
                      ("skirt", (SKIRT_OFFSET, SKIRT_FLARE), SKIRT_Y, 5)],
    "synthetic-skirt": [("skirt", (LOOSE_SKIRT_OFFSET, LOOSE_SKIRT_FLARE),
                         LOOSE_SKIRT_Y, 5)],
}
# scene type → [(curve name, ring height, ring offset)]
SCENE_CURVES = {
    "synthetic-tube": [("neck", TORSO_Y[1] - 0.01, GARMENT_OFFSET),
                       ("bottom_curve", TORSO_Y[0] + 0.01, GARMENT_OFFSET)],
    "synthetic-two": [("neck", UPPER2_Y[1] - 0.01, UPPER2_OFFSET),
                      ("upper_bottom", UPPER2_Y[0] + 0.01, UPPER2_OFFSET),
                      ("bottom_curve", SKIRT_Y[0] + 0.01,
                       _flare_offset((SKIRT_OFFSET, SKIRT_FLARE),
                                     SKIRT_Y[0] + 0.01, SKIRT_Y[1]))],
    "synthetic-skirt": [
        ("upper_bottom", LOOSE_SKIRT_Y[1] - 0.01,
         _flare_offset((LOOSE_SKIRT_OFFSET, LOOSE_SKIRT_FLARE),
                       LOOSE_SKIRT_Y[1] - 0.01, LOOSE_SKIRT_Y[1])),
        ("bottom_curve", LOOSE_SKIRT_Y[0] + 0.01,
         _flare_offset((LOOSE_SKIRT_OFFSET, LOOSE_SKIRT_FLARE),
                       LOOSE_SKIRT_Y[0] + 0.01, LOOSE_SKIRT_Y[1])),
    ],
}


def apose(init_pose_type: int = 0) -> np.ndarray:
    """The reference's template A-pose (utils/utils.py:68-99, type 0)."""
    pose = np.zeros((24, 3), np.float32)
    pose[1] = [0, 0, 10.0 / 180.0 * np.pi]
    pose[2] = [0, 0, -10.0 / 180.0 * np.pi]
    pose[16] = [0, 0, -45.0 / 180.0 * np.pi]
    pose[17] = [0, 0, 45.0 / 180.0 * np.pi]
    return pose


# lateral clamp ≈ the template slice's |x| < |shoulder_x|·1.15 cut —
# keeps the torso-band garments armless like their templates
X_CLAMP = 0.192


def garment_sdf(pts: np.ndarray, offset: float = GARMENT_OFFSET,
                band=TORSO_Y, x_clamp: float | None = X_CLAMP) -> np.ndarray:
    """Tube garment: body offset surface ∩ height slab (∩ |x| slab for
    torso garments — arms excluded, like the procedural templates);
    closed via CSG. ``offset`` may be (base, flare) for an A-line skirt
    whose offset grows below the band top (see _flare_offset)."""
    body = synthetic_body_sdf(pts) - _flare_offset(offset, pts[:, 1], band[1])
    slab = np.maximum(band[0] - pts[:, 1], pts[:, 1] - band[1])
    sd = np.maximum(body, slab)
    if x_clamp is not None and band[1] > -0.2:   # torso-band garments only
        sd = np.maximum(sd, np.abs(pts[:, 0]) - x_clamp)
    return sd


def garment_mesh(res: int = 97, offset: float = GARMENT_OFFSET, band=TORSO_Y):
    lin = np.linspace(-0.9, 0.9, res, dtype=np.float32)
    z, y, x = np.meshgrid(lin, lin, lin, indexing="ij")
    pts = np.stack([x, y, z], -1).reshape(-1, 3)
    vol = garment_sdf(pts, offset, band).reshape(res, res, res)
    step = lin[1] - lin[0]
    return marching_cubes_np(vol, 0.0, (-0.9, -0.9, -0.9), (step,) * 3)


def boundary_ring(y_level: float, n: int = 100,
                  offset: float = GARMENT_OFFSET):
    """Ring on the garment surface at a fixed height: radial sphere trace
    in the xz-plane from outside (x clipped to the garment's lateral
    clamp for torso rings)."""
    ang = np.linspace(0, 2 * np.pi, n, endpoint=False)
    dirs = np.stack([np.cos(ang), np.zeros(n), np.sin(ang)], 1).astype(np.float32)
    pts = dirs * 1.2
    pts[:, 1] = y_level
    for _ in range(48):
        sd = synthetic_body_sdf(pts) - offset
        pts = pts - dirs * sd[:, None] * 0.9
        pts[:, 1] = y_level
    if y_level > -0.2:
        pts[:, 0] = np.clip(pts[:, 0], -X_CLAMP, X_CLAMP)
    # drop near-duplicate consecutive points (the clip and concave trace
    # regions collapse neighbors; zero-length segments NaN the arc-length
    # resampling downstream)
    d = np.linalg.norm(np.diff(np.vstack([pts, pts[:1]]), axis=0), axis=1)
    keep = np.ones(len(pts), bool)
    keep[1:] = d[:-1] > 1e-3
    return pts[keep]


def _longest_circular_run(vis: np.ndarray) -> np.ndarray:
    """Indices of the longest contiguous True run on a circular array —
    the single arc a labelme annotator would trace. Returns them in ring
    order so the linestrip is a connected polyline."""
    n = len(vis)
    if vis.all():
        return np.arange(n)
    if not vis.any():
        return np.zeros(0, int)
    v2 = np.concatenate([vis, vis])
    best_len = best_start = cur = 0
    for i in range(2 * n):
        cur = cur + 1 if v2[i] else 0
        start = i - cur + 1
        if cur > best_len and start < n:
            best_len, best_start = cur, start
    return (best_start + np.arange(min(best_len, n))) % n


def make_camera_params(image_size: int):
    return {
        "fx": np.float32(image_size * 1.6),
        "fy": np.float32(image_size * 1.6),
        "cx": np.float32(image_size / 2.0),
        "cy": np.float32(image_size / 2.0),
        "quat": np.asarray([0.0, 0.0, 1.0, 0.0], np.float32),
        "T": np.asarray([0.0, 0.2, 2.6], np.float32),
    }


def generate_scene(out_dir: str, n_frames: int = 10, image_size: int = 256,
                   yaw_range: float = 2 * np.pi, skinner_res=(49, 81, 25),
                   raster_cap: int = 1024, garment_type: str = "synthetic-tube",
                   device=None):
    """Create a full scene on ``device``, the CUDA card when none is given
    (skinning and rasterization run there). Returns the scene directory."""
    device = resolve_device(device)
    os.makedirs(out_dir, exist_ok=True)
    for sub in ("imgs", "masks", "parsing_SCH_ATR", "featurelines", "normals", "gt_meshes"):
        os.makedirs(osp.join(out_dir, sub), exist_ok=True)

    body = synthetic_body_model()
    pose0 = apose()
    sk, body_verts, body_faces = initial_lbs_skinner(
        body, torch.zeros(10, device=device), pose0, resolution=skinner_res)
    if garment_type in ("synthetic-skirt", "synthetic-two"):
        # fite-style diffused skinning, shipped for the builder (see the
        # JAX generator)
        import scipy.ndimage as ndi

        w = sk.ws.cpu().numpy()
        w = ndi.gaussian_filter(w, sigma=(0.0, 2.0, 2.0, 2.0), mode="nearest")
        w /= np.clip(w.sum(0, keepdims=True), 1e-8, None)
        np.save(osp.join(out_dir, "diffused_skinning_weights.npy"), w)
        sk = SkinnerParams(ws=torch.as_tensor(w, device=device), Js=sk.Js,
                           init_pose_inv=sk.init_pose_inv, extra_trans=sk.extra_trans,
                           bbox_center=sk.bbox_center, bbox_extend=sk.bbox_extend,
                           b_min=sk.b_min, b_max=sk.b_max)
    pieces = SCENE_GARMENTS[garment_type]
    gmeshes = [garment_mesh(offset=off, band=band) for _, off, band, _ in pieces]
    rings = [(name, boundary_ring(ylv, offset=off))
             for name, ylv, off in SCENE_CURVES[garment_type]]

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
        pose[0, 1] = yaw_range * fid / max(n_frames, 1)
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
        tints = ([0.25, 0.35, 0.8], [0.7, 0.3, 0.35], [0.3, 0.7, 0.4])
        parsing = np.zeros((H, W), np.uint8)
        parsing[mask] = 9   # skin → a label outside ATR garment groups
        for i, (_, _, _, atr_label) in enumerate(pieces):
            sel = (pix2face >= face_lo[i]) & (pix2face < face_lo[i + 1])
            img[sel] = np.asarray(tints[i % len(tints)]) * shade[sel]
            parsing[sel] = atr_label

        imwrite(osp.join(out_dir, f"imgs/{fid}.png"), (img[:, :, ::-1] * 255).astype(np.uint8))
        imwrite(osp.join(out_dir, f"masks/{fid}.png"), (mask * 255).astype(np.uint8))
        imwrite(osp.join(out_dir, f"normals/{fid}.png"),
                ((nimg[:, :, ::-1] + 1) / 2 * 255).astype(np.uint8))
        np.save(osp.join(out_dir, f"parsing_SCH_ATR/{fid}.npy"), parsing)
        np.save(osp.join(out_dir, f"parsing_SCH_ATR/mask_parsing_{fid}.npy"), parsing)

        # feature lines: the visible arc of each posed ring (see the JAX
        # generator for the annotation model)
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
        json.dump(_scene_meta(n_frames, image_size, yaw_range, skinner_res, raster_cap,
                              garment_type), f)
    return out_dir


def _scene_meta(n_frames, image_size, yaw_range, skinner_res, raster_cap, garment_type) -> dict:
    """``scene_meta.json``: the JAX generator's keys (version, garment type,
    frames, image size) and the other arguments the frames depend on."""
    return {"version": SCENE_VERSION, "garment_type": garment_type, "n_frames": int(n_frames),
            "image_size": int(image_size), "yaw_range": float(yaw_range),
            "skinner_res": [int(r) for r in skinner_res], "raster_cap": int(raster_cap)}


def ensure_scene(out_dir: str, n_frames: int = 10, image_size: int = 256,
                 yaw_range: float = 2 * np.pi, skinner_res=(49, 81, 25), raster_cap: int = 1024,
                 garment_type: str = "synthetic-tube", device=None) -> str:
    """A cached ``generate_scene`` scene (counterpart of the JAX
    ``ensure_scene``): reuse ``out_dir`` when its ``scene_meta.json``
    records this generator's ``SCENE_VERSION`` and these arguments;
    otherwise delete it, with the ``result/`` caches computed from it
    (initialization checkpoints, skinner caches), and generate it anew.
    Returns the scene directory."""
    want = _scene_meta(n_frames, image_size, yaw_range, skinner_res, raster_cap, garment_type)
    meta_path = osp.join(out_dir, "scene_meta.json")
    if osp.isfile(meta_path):
        with open(meta_path) as f:
            if json.load(f) == want:
                return out_dir
    if osp.isdir(out_dir):
        shutil.rmtree(out_dir)
    return generate_scene(out_dir, n_frames=n_frames, image_size=image_size,
                          yaw_range=yaw_range, skinner_res=skinner_res, raster_cap=raster_cap,
                          garment_type=garment_type, device=device)


# The garment SDF's geometric init has its zero level near radius 0.5, so
# the seg3d box (z extent ±0.34 on the synthetic body) cuts the sphere open
# and leaves a band outside the torso's gt mask, where no ray is seeded.
# An output bias of −0.48 in place of −0.6 moves the zero level to radius
# ≈0.3, inside the box and over the torso.
GARMENT_SDF_BIAS = -0.48


def shrink_garment_init(params) -> None:
    """Set each garment SDF's output bias in the port's ``params`` to
    ``GARMENT_SDF_BIAS``, so the sphere init fits this scene's seg3d box."""
    with torch.no_grad():
        for gsdf in params["garment_sdfs"]:
            gsdf.lins[-1].b[0] = GARMENT_SDF_BIAS


def tcmr_record(scene: str, target_betas, pose_step: float = 0.002, device=None) -> dict:
    """A TCMR output for a ``generate_scene`` scene, as the dataset reads
    ``<garment>_tcmr_output.pkl``: ``{1: {frame_ids, gt_joints2d, pose,
    betas}}`` with the frame ids, the scene's poses plus
    ``pose_step``·frame, zero betas, and COCO-style ``gt_joints2d`` (x, y,
    1): the synthetic body's 24 joints at ``target_betas`` under the
    scene's poses and translation, projected through the scene camera."""
    from ..models.smpl import smpl_forward

    device = resolve_device(device)
    with open(osp.join(scene, "scene_meta.json")) as f:
        meta = json.load(f)
    n, image = meta["n_frames"], meta["image_size"]
    rec = np.load(osp.join(scene, "smpl_rec.npz"), allow_pickle=True)
    poses = rec["poses"].reshape(n, 24, 3).astype(np.float32)
    trans = rec["trans"].reshape(n, 3).astype(np.float32)
    cam_npz = np.load(osp.join(scene, "camera.npz"))
    cam = cam_mod.make_camera({
        "focal_length": np.asarray([cam_npz["fx"], cam_npz["fy"]]),
        "princeple_points": np.asarray([cam_npz["cx"], cam_npz["cy"]]),
        "cam2world_coord_quat": cam_npz["quat"], "world2cam_coord_trans": cam_npz["T"]},
        (image, image), device=device)
    _, joints, _ = smpl_forward(synthetic_body_model(),
                                torch.as_tensor(np.asarray(target_betas, np.float32),
                                                device=device),
                                torch.as_tensor(poses, device=device))
    scr = cam_mod.transform_points_screen(
        cam, joints + torch.as_tensor(trans, device=device)[:, None])[..., :2].cpu().numpy()
    gt_j = np.concatenate([scr, np.ones(scr.shape[:-1] + (1,), np.float32)], -1)
    tc_pose = poses.reshape(n, 72) + pose_step * np.arange(n, dtype=np.float32)[:, None]
    return {1: {"frame_ids": np.arange(n), "gt_joints2d": gt_j.astype(np.float32),
                "pose": tc_pose.astype(np.float32), "betas": np.zeros((n, 10), np.float32)}}


def make_large_pose_scene(scene: str, annotated: int, target_betas, depth_drift: float = 0.3,
                          pose_step: float = 0.002, device=None) -> str:
    """Turn a ``generate_scene`` scene into a large-pose one, the layout of
    ``tools/bench_largepose.py``'s scene: feature-line JSONs only for
    frames < ``annotated`` (the A-pose range), a depth drift after that
    range (``trans[:, 2]`` ramping to ``depth_drift`` over the later
    frames), and a TCMR output ``<garment>_tcmr_output.pkl`` written as a
    plain pickle (the port reads it as it reads joblib's):
    ``tcmr_record(scene, target_betas, pose_step)`` of the undrifted
    scene. Returns ``scene``."""
    import pickle

    with open(osp.join(scene, "scene_meta.json")) as f:
        meta = json.load(f)
    n = meta["n_frames"]
    for fid in range(annotated, n):
        path = osp.join(scene, "featurelines", f"{fid}.json")
        if osp.isfile(path):
            os.remove(path)
    record = tcmr_record(scene, target_betas, pose_step, device)
    with open(osp.join(scene, f"{meta['garment_type']}_tcmr_output.pkl"), "wb") as f:
        pickle.dump(record, f)
    rec = dict(np.load(osp.join(scene, "smpl_rec.npz"), allow_pickle=True))
    trans = rec["trans"].reshape(n, 3).astype(np.float32)
    drift = trans.copy()
    drift[annotated:, 2] += np.linspace(depth_drift / max(n - annotated, 1), depth_drift,
                                        n - annotated, dtype=np.float32)
    rec["trans"] = drift
    np.savez(osp.join(scene, "smpl_rec.npz"), **rec)
    return scene
