"""2D feature lines from garment parsing masks (counterpart of
``tools/parsing_mask_to_fl.py``): per frame, the outer boundary contours
of the ATR "upper" garment region of ``parsing_SCH_ATR/<fid>.npy``; on the
longest, the shorter arc between the contour points nearest to a pair of
landmarks per curve type (the shoulders for ``neck``, the hips for the
hems), written as labelme-style ``mask2fl/<fid>.json`` annotations. The
landmarks are the SMPL joints of ``smpl_rec.npz`` projected by
``camera.npz``.

    python -m recmv_tpu_torch.tools.parsing_mask_to_fl --data-root <scene>
        [--curves neck bottom_curve] [--device cuda]

The card's machine has no OpenCV: ``find_external_contours`` gives
``cv2.findContours(mask, RETR_EXTERNAL, CHAIN_APPROX_NONE)``'s contours,
points and order (Suzuki and Abe's border following as OpenCV runs it).
``--device`` (default ``cuda``; ``cpu`` for the tests) replaces the JAX
tool's ``--platform``.
"""

from __future__ import annotations

import argparse
import glob
import json
import os
import os.path as osp

import numpy as np
import torch

# chain code s → (dx, dy): 0 = +x, then counter-clockwise on the screen
_CODE = ((1, 0), (1, -1), (0, -1), (-1, -1), (-1, 0), (-1, 1), (0, 1), (1, 1))
_RIGHT_BOUND, _TRACED = -126, 2   # OpenCV's marks: (nbd | -128) and nbd, nbd = 2


def _follow_border(buf: list, i0: int, x: int, y: int, deltas: list) -> list:
    """Trace the outer border that starts at flat index ``i0`` (pixel (x, y)
    of the unpadded mask) in the padded flat image ``buf``, marking its
    pixels as OpenCV does → the border's points."""
    s = s_end = 4
    while True:
        s = (s - 1) & 7
        i1 = i0 + deltas[s]
        if buf[i1] != 0 or s == s_end:
            break
    if s == s_end:                     # a single pixel
        buf[i0] = _RIGHT_BOUND
        return [(x, y)]
    pts = []
    i3 = i0
    while True:
        s_end = s
        while s < 15:
            s += 1
            i4 = i3 + deltas[s]
            if buf[i4] != 0:
                break
        s &= 7
        if 0 < s <= s_end:             # OpenCV's "right bound" test
            buf[i3] = _RIGHT_BOUND
        elif buf[i3] == 1:
            buf[i3] = _TRACED
        pts.append((x, y))
        x += _CODE[s][0]
        y += _CODE[s][1]
        if i4 == i0 and i3 == i1:
            break
        i3 = i4
        s = (s + 4) & 7
    return pts


def find_external_contours(mask: np.ndarray) -> list:
    """The outer border of every foreground component not inside a hole of
    another, as ``cv2.findContours(mask, cv2.RETR_EXTERNAL,
    cv2.CHAIN_APPROX_NONE)`` returns them (the last found first) → a list
    of (P, 2) int32 (x, y) arrays. Foreground is ``mask != 0``."""
    h, w = mask.shape
    W = w + 2
    img = np.zeros((h + 2, W), np.int8)
    img[1:-1, 1:-1] = mask != 0
    buf = img.reshape(-1).tolist()
    d = [1, -W + 1, -W, -W - 1, -1, W - 1, W, W + 1]
    deltas = d + d
    found = []
    for y in np.flatnonzero(img.any(1)).tolist():
        row = y * W
        lnbd = row             # the last marked pixel met in this row
        prev = 0
        for x in range(1, w + 1):
            p = buf[row + x]
            if p == prev:
                continue
            if prev == 0 and p == 1 and buf[lnbd] <= 0:
                found.append(_follow_border(buf, row + x, x - 1, y - 1, deltas))
                prev = buf[row + x]
                continue
            prev = p
            if prev & -2:
                lnbd = row + x
    return [np.asarray(c, np.int32).reshape(-1, 2) for c in found[::-1]]


def garment_boundary_polygons(parsing: np.ndarray, labels) -> list:
    """Outer boundary contours of the union of the given parsing labels
    with at least 16 points, (P, 2) xy each."""
    mask = np.isin(parsing, list(labels)).astype(np.uint8)
    return [c for c in find_external_contours(mask) if len(c) >= 16]


def shortest_contour_path(contour: np.ndarray, p0, p1) -> np.ndarray:
    """The shorter of the two arcs between the contour points nearest to
    the landmarks p0, p1 (the reference's curve cut)."""
    d0 = np.linalg.norm(contour - np.asarray(p0)[None], axis=1)
    d1 = np.linalg.norm(contour - np.asarray(p1)[None], axis=1)
    i0, i1 = int(d0.argmin()), int(d1.argmin())
    if i0 > i1:
        i0, i1 = i1, i0
    arc_a = contour[i0:i1 + 1]
    arc_b = np.concatenate([contour[i1:], contour[:i0 + 1]], 0)
    return arc_a if len(arc_a) <= len(arc_b) else arc_b


def extract_frame(parsing: np.ndarray, joints2d: np.ndarray, curves) -> list:
    """The labelme shapes of one frame: per curve in ``curves``, its arc on
    the longest "upper" contour (none without one)."""
    from ..config.constants import ATR_PARSING

    shapes = []
    upper = garment_boundary_polygons(parsing, ATR_PARSING["upper"])
    if not upper:
        return shapes
    contour = max(upper, key=len)
    for name in curves:
        if name == "neck":
            p0, p1 = joints2d[16], joints2d[17]          # shoulders
        elif name in ("bottom_curve", "upper_bottom"):
            p0, p1 = joints2d[1], joints2d[2]            # hips
        else:
            continue
        arc = shortest_contour_path(contour, p0, p1)
        if len(arc) >= 8:
            shapes.append({"label": name, "shape_type": "linestrip",
                           "points": arc.astype(float).tolist()})
    return shapes


def main(argv=None) -> int:
    """Run the tool; returns the number of annotations written."""
    from .. import resolve_device
    from ..data.png import imread
    from ..models import camera as cam_mod
    from ..models.smpl import get_smpl, smpl_forward

    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--data-root", required=True)
    ap.add_argument("--curves", nargs="*", default=["neck", "bottom_curve"])
    ap.add_argument("--device", default="cuda", help="torch device (cuda or cpu)")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)

    root = args.data_root
    out_dir = osp.join(root, "mask2fl")
    os.makedirs(out_dir, exist_ok=True)
    rec = np.load(osp.join(root, "smpl_rec.npz"))
    cam_npz = np.load(osp.join(root, "camera.npz"))
    h, w = imread(glob.glob(osp.join(root, "masks", "*.png"))[0]).shape[:2]
    camera = cam_mod.make_camera(
        {"focal_length": np.asarray([cam_npz["fx"], cam_npz["fy"]]),
         "princeple_points": np.asarray([cam_npz["cx"], cam_npz["cy"]]),
         "cam2world_coord_quat": cam_npz["quat"],
         "world2cam_coord_trans": cam_npz["T"]}, (w, h), device=device)
    model = get_smpl(str(rec["gender"]) if "gender" in rec else "neutral")
    poses = np.asarray(rec["poses"], np.float32).reshape(-1, 24, 3)
    trans = np.asarray(rec["trans"], np.float32).reshape(-1, 3)

    parsing_paths = sorted(glob.glob(osp.join(root, "parsing_SCH_ATR", "[0-9]*.npy")),
                           key=lambda p: int(osp.basename(p).split(".")[0]))
    n = 0
    for p in parsing_paths:
        fid = int(osp.basename(p).split(".")[0])
        with torch.no_grad():
            _, joints, _ = smpl_forward(model, torch.zeros(10, device=device),
                                        torch.as_tensor(poses[fid], device=device)[None])
            j3 = joints[0].cpu().numpy() + trans[fid]
            j2 = cam_mod.project(camera, torch.as_tensor(j3, device=device)).cpu().numpy()
        shapes = extract_frame(np.load(p), j2, args.curves)
        if shapes:
            with open(osp.join(out_dir, f"{fid}.json"), "w") as f:
                json.dump({"shapes": shapes}, f)
            n += 1
    print(f"[parsing_mask_to_fl] wrote {n} annotations to {out_dir}")
    return n


if __name__ == "__main__":
    main()
