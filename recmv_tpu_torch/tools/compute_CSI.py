"""Temporal curve stability index (counterpart of the repo's
``tools/compute_CSI.py``, itself the reference's): over a sequence of
per-frame meshes (``*.obj`` in name order), the mean over frame triples of
the per-vertex second temporal difference ‖(v_t − v_{t−1}) − (v_{t+1} −
v_t)‖ averaged over the vertices; triples whose vertex counts differ are
skipped. numpy only.

    python -m recmv_tpu_torch.tools.compute_CSI <mesh_dir>
"""

from __future__ import annotations

import argparse
import glob
import os.path as osp

import numpy as np


def compute_csi(mesh_dir: str) -> float:
    from ..utils.io import load_obj

    paths = sorted(glob.glob(osp.join(mesh_dir, "*.obj")))
    if len(paths) < 3:
        raise ValueError(f"need at least 3 meshes under {mesh_dir}, found {len(paths)}")
    dis, valid = 0.0, 0
    prev2, prev1 = load_obj(paths[0])[0], load_obj(paths[1])[0]
    for p in paths[2:]:
        cur = load_obj(p)[0]
        if prev2.shape == prev1.shape == cur.shape:
            ba, cb = prev1 - prev2, cur - prev1
            dis += np.sqrt(((ba - cb) ** 2).sum(-1)).sum() / ba.shape[0]
            valid += 1
        prev2, prev1 = prev1, cur
    return dis / max(valid, 1)


def main(argv=None) -> float:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("mesh_dir", help="directory of per-frame .obj meshes")
    args = ap.parse_args(argv)
    csi = compute_csi(args.mesh_dir)
    print(f"CSI({args.mesh_dir}) = {csi:.6f}")
    return csi


if __name__ == "__main__":
    main()
