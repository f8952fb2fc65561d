"""Side-by-side turntable renders of the mesh sequences of N methods
(counterpart of ``tools/comparison_results.py``): ``name=dir`` pairs of
per-frame obj folders; per frame, each method's mesh centred and shaded by
|n·view| at ``--image``² through the mesh z-buffer (K1 on the card; tile
32, cap 256), the tiles side by side in one ``NNNN.png`` strip under
``--out``.

    python -m recmv_tpu_torch.tools.comparison_results --out cmp/ \\
        ours=scene/result/infer/meshs ref=/path/to/ref_meshes [--device cuda]

The JAX tool writes each method's name into its tile with
``cv2.putText``, which has no counterpart where the port runs (no
OpenCV): here the tiles carry no label, and ``<out>/methods.txt`` lists
the names in strip order, one per line, left to right.
"""

from __future__ import annotations

import argparse
import glob
import os
import os.path as osp

import numpy as np
import torch


def render_mesh(verts: np.ndarray, faces: np.ndarray, image: int = 512, yaw: float = 0.0,
                device=None) -> np.ndarray:
    """One mesh centred at the origin, seen from 2.5 away under ``yaw`` →
    (image, image, 3) uint8 RGB on white."""
    from ..models.camera import Camera
    from ..ops.math3d import compute_fnorms
    from ..ops.rasterizer import rasterize_mesh, screen_with_cam_z

    f32 = dict(dtype=torch.float32, device=device)
    quat = np.asarray([np.cos((yaw + np.pi) / 2), 0.0, np.sin((yaw + np.pi) / 2), 0.0],
                      np.float32)
    cam = Camera(focal=torch.tensor([image * 1.2, image * 1.2], **f32),
                 principal=torch.tensor([image / 2.0, image / 2.0], **f32),
                 quat=torch.as_tensor(quat, device=device),
                 trans=torch.tensor([0.0, 0.0, 2.5], **f32), image_size=(image, image))
    sh = torch.as_tensor(verts - verts.mean(0), **f32)
    ft = torch.as_tensor(faces, dtype=torch.int64, device=device)
    with torch.no_grad():
        frag = rasterize_mesh(screen_with_cam_z(cam, sh)[None], ft, (image, image), tile=32,
                              cap=256)
        p2f = frag.pix_to_face[0, ..., 0].cpu().numpy()
        fn = compute_fnorms(sh, ft).cpu().numpy()
    lam = np.abs(fn @ cam.R.cpu().numpy()[:, 2])
    img = np.full((image, image, 3), 255, np.uint8)
    hit = p2f >= 0
    img[hit] = (np.asarray([[200, 190, 170]]) * (0.3 + 0.7 * lam[p2f[hit], None])).astype(np.uint8)
    return img


def main(argv=None) -> int:
    """Run the tool; returns the number of strips written."""
    from .. import resolve_device
    from ..data.png import imwrite
    from ..utils.io import load_obj

    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--out", required=True)
    ap.add_argument("--image", type=int, default=512)
    ap.add_argument("--yaw", type=float, default=0.0)
    ap.add_argument("--device", default="cuda", help="torch device (cuda or cpu)")
    ap.add_argument("methods", nargs="+", help="name=mesh_dir pairs")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)

    os.makedirs(args.out, exist_ok=True)
    methods = [m.split("=", 1) for m in args.methods]
    seqs = {n: sorted(glob.glob(osp.join(d, "*.obj"))) for n, d in methods}
    with open(osp.join(args.out, "methods.txt"), "w") as f:
        f.write("".join(f"{name}\n" for name in seqs))
    n_frames = min(len(v) for v in seqs.values())
    for i in range(n_frames):
        tiles = []
        for files in seqs.values():
            v, fc = load_obj(files[i])
            tiles.append(render_mesh(v, fc, args.image, args.yaw, device))
        imwrite(osp.join(args.out, f"{i:04d}.png"), np.concatenate(tiles, axis=1)[:, :, ::-1])
    print(f"[cmp] wrote {n_frames} strips x {len(methods)} methods to {args.out}")
    return n_frames


if __name__ == "__main__":
    main()
