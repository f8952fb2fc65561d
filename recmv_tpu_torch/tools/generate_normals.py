"""Per-frame normal maps for a scene's ``normals/`` folder (counterpart of
``tools/generate_normals.py``): the normals of the LBS-posed SMPL body of
``smpl_rec.npz``, seen by ``camera.npz`` at the frames' size, rasterized
through the mesh z-buffer (K1 on the card; tile 32, cap 1024) and written
as (n + 1)/2 PNGs under the frames' names. A geometric stand-in for the
reference's PIFuHD normals, with the same layout and encoding: the
dataset reader accepts either.

    python -m recmv_tpu_torch.tools.generate_normals --data-root <scene>
        [--smpl-dir DIR] [--device cuda]

``--device`` (default ``cuda``; ``cpu`` for the tests) replaces the JAX
tool's ``--platform``.
"""

from __future__ import annotations

import argparse
import os
import os.path as osp

import numpy as np
import torch


def main(argv=None):
    from .. import resolve_device
    from ..core.builder import apose_from_type
    from ..data.png import imread, imwrite
    from ..models import camera as cam_mod
    from ..models.skinner import initial_lbs_skinner, skinner_apply
    from ..models.smpl import get_smpl
    from ..ops.math3d import compute_fnorms
    from ..ops.rasterizer import rasterize_mesh, screen_with_cam_z

    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--data-root", required=True)
    ap.add_argument("--smpl-dir", default=None)
    ap.add_argument("--device", default="cuda", help="torch device (cuda or cpu)")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)

    rec = np.load(osp.join(args.data_root, "smpl_rec.npz"))
    campar = dict(np.load(osp.join(args.data_root, "camera.npz")))
    model = get_smpl(str(rec.get("gender", "neutral")), args.smpl_dir)
    shape = torch.as_tensor(np.asarray(rec["shape"], np.float32).reshape(-1)[:10], device=device)
    sk, body_vs, body_fs = initial_lbs_skinner(model, shape, apose_from_type(0), (49, 81, 25))

    # the image size from an existing frame
    imgs = sorted(os.listdir(osp.join(args.data_root, "imgs")))
    H, W = imread(osp.join(args.data_root, "imgs", imgs[0])).shape[:2]
    cam = cam_mod.make_camera(
        {"focal_length": np.asarray([campar["fx"], campar["fy"]]),
         "princeple_points": np.asarray([campar["cx"], campar["cy"]]),
         "cam2world_coord_quat": campar["quat"],
         "world2cam_coord_trans": campar["T"]}, (W, H), device=device)
    R = cam.R.cpu().numpy()

    out_dir = osp.join(args.data_root, "normals")
    os.makedirs(out_dir, exist_ok=True)
    poses = np.asarray(rec["poses"], np.float32).reshape(-1, 24, 3)
    trans = np.asarray(rec["trans"], np.float32).reshape(-1, 3)
    fs = torch.as_tensor(np.asarray(body_fs), dtype=torch.int64, device=device)
    for fid in range(len(poses)):
        with torch.no_grad():
            posed = skinner_apply(sk, body_vs[None],
                                  torch.as_tensor(poses[fid], device=device)[None],
                                  torch.as_tensor(trans[fid], device=device)[None])[0]
            frag = rasterize_mesh(screen_with_cam_z(cam, posed)[None], fs, (H, W), tile=32,
                                  cap=1024)
            p2f = frag.pix_to_face[0, ..., 0].cpu().numpy()
            fn = compute_fnorms(posed, fs).cpu().numpy()
        fn_cam = fn @ R
        nimg = np.zeros((H, W, 3), np.float32)
        hit = p2f >= 0
        nimg[hit] = fn_cam[p2f[hit]]
        nimg[..., 2] *= -1
        stem = osp.splitext(imgs[fid])[0] if fid < len(imgs) else str(fid)
        imwrite(osp.join(out_dir, f"{stem}.png"),
                ((nimg[:, :, ::-1] + 1) / 2 * 255).astype(np.uint8))
        if fid % 25 == 0:
            print(f"[normals] {fid}/{len(poses)}", flush=True)
    print(f"[normals] wrote {len(poses)} maps to {out_dir}")


if __name__ == "__main__":
    main()
