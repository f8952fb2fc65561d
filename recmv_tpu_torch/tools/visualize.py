"""Overlay exported per-frame meshes on the scene's frames (counterpart of
``tools/visualize.py``): each ``<mesh-dir>/NNNN_*.obj`` rendered with the
scene camera through the mesh z-buffer (K1 on the card; tile 32, cap 512),
shaded by |n·view| and alpha-blended over the frame, one ``NNNN.png`` per
frame under ``--out``.

    python -m recmv_tpu_torch.tools.visualize --data-root <scene> \\
        --mesh-dir <scene>/result/infer/meshs --out vis/ [--device cuda]

``--device`` (default ``cuda``; ``cpu`` for the tests) replaces the JAX
tool's ``--platform``.
"""

from __future__ import annotations

import argparse
import glob
import os
import os.path as osp

import numpy as np
import torch


def main(argv=None) -> int:
    """Run the tool; returns the number of overlays written."""
    from .. import resolve_device
    from ..data.image import imread
    from ..data.png import imwrite
    from ..models import camera as cam_mod
    from ..ops.math3d import compute_fnorms
    from ..ops.rasterizer import rasterize_mesh, screen_with_cam_z
    from ..utils.io import load_obj

    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--data-root", required=True)
    ap.add_argument("--mesh-dir", required=True)
    ap.add_argument("--out", required=True)
    ap.add_argument("--alpha", type=float, default=0.6)
    ap.add_argument("--device", default="cuda", help="torch device (cuda or cpu)")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)

    campar = dict(np.load(osp.join(args.data_root, "camera.npz")))
    imgs = sorted(glob.glob(osp.join(args.data_root, "imgs", "*")))
    H, W = imread(imgs[0]).shape[:2]
    cam = cam_mod.make_camera(
        {"focal_length": np.asarray([campar["fx"], campar["fy"]]),
         "princeple_points": np.asarray([campar["cx"], campar["cy"]]),
         "cam2world_coord_quat": campar["quat"],
         "world2cam_coord_trans": campar["T"]}, (W, H), device=device)
    view_z = cam.R.cpu().numpy()[:, 2]

    os.makedirs(args.out, exist_ok=True)
    by_frame = {}
    for p in sorted(glob.glob(osp.join(args.mesh_dir, "*.obj"))):
        by_frame.setdefault(int(osp.basename(p).split("_")[0]), []).append(p)

    for fid, paths in sorted(by_frame.items()):
        frame_img = None
        for ip in imgs:
            if int("".join(c for c in osp.splitext(osp.basename(ip))[0]
                           if c.isdigit()) or -1) == fid:
                frame_img = imread(ip)
                break
        if frame_img is None:
            frame_img = np.full((H, W, 3), 255, np.uint8)
        over = frame_img.astype(np.float64)            # BGR, as the JAX tool's
        for p in paths:
            v, f = load_obj(p)
            vt = torch.as_tensor(v, dtype=torch.float32, device=device)
            ft = torch.as_tensor(f, dtype=torch.int64, device=device)
            with torch.no_grad():
                frag = rasterize_mesh(screen_with_cam_z(cam, vt)[None], ft, (H, W), tile=32,
                                      cap=512)
                p2f = frag.pix_to_face[0, ..., 0].cpu().numpy()
                fn = compute_fnorms(vt, ft).cpu().numpy()
            hit = p2f >= 0
            lam = np.abs(fn @ view_z)
            shade = np.asarray([120, 170, 230]) * (0.3 + 0.7 * lam[p2f[hit], None])
            over[hit] = args.alpha * shade[:, ::-1] + (1 - args.alpha) * over[hit]
        imwrite(osp.join(args.out, f"{fid:04d}.png"), over.astype(np.uint8))
    print(f"[visualize] wrote {len(by_frame)} overlays to {args.out}")
    return len(by_frame)


if __name__ == "__main__":
    main()
