"""Chamfer evaluation of exported garment meshes against ground truth
(counterpart of the repo's ``tools/eval_chamfer.py``): for a synthetic
scene, each frame's exported meshes (``meshs/NNNN_<garment>.obj``, all
garments of the frame together) against the generator's
``gt_meshes/NNNN.npz`` vertices, by the symmetric mean squared chamfer.

    python -m recmv_tpu_torch.tools.eval_chamfer --data-root <scene> \\
        --mesh-dir <scene>/result/infer/meshs [--device cuda]

``--device`` (default ``cuda``; ``cpu`` for the tests) replaces the JAX
tool's ``--platform``. Returns the mean over the frames with meshes.
"""

from __future__ import annotations

import argparse
import glob
import os.path as osp

import numpy as np
import torch


def frame_chamfers(data_root: str, mesh_dir: str, device) -> dict:
    """{frame id: chamfer} over the frames with both a GT mesh and exports."""
    from ..ops.knn import chamfer_distance
    from ..utils.io import load_obj

    gt_paths = sorted(glob.glob(osp.join(data_root, "gt_meshes", "*.npz")))
    if not gt_paths:
        raise FileNotFoundError(f"no gt_meshes under {data_root}: Chamfer needs a synthetic scene")
    out = {}
    for gp in gt_paths:
        fid = int(osp.basename(gp).split(".")[0])
        cands = sorted(glob.glob(osp.join(mesh_dir, f"{fid:04d}_*.obj")))
        if not cands:
            continue
        gt = torch.as_tensor(np.load(gp)["verts"], dtype=torch.float32, device=device)
        pred = torch.as_tensor(np.concatenate([load_obj(c)[0] for c in cands], 0),
                               dtype=torch.float32, device=device)
        out[fid] = float(chamfer_distance(pred, gt))
    return out


def main(argv=None) -> float:
    from .. import resolve_device

    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--data-root", required=True)
    ap.add_argument("--mesh-dir", required=True, help="the exported meshs/ directory")
    ap.add_argument("--device", default="cuda", help="torch device (cuda or cpu)")
    args = ap.parse_args(argv)
    dists = frame_chamfers(args.data_root, args.mesh_dir, resolve_device(args.device))
    if not dists:
        raise FileNotFoundError(f"no exported meshes under {args.mesh_dir} match a GT frame")
    for fid, d in dists.items():
        print(f"frame {fid}: chamfer-L2 {d:.6f}")
    mean = float(np.mean(list(dists.values())))
    print(f"mean chamfer-L2 over {len(dists)} frames: {mean:.6f}")
    return mean


if __name__ == "__main__":
    main()
