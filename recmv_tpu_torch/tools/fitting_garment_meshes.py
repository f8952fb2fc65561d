"""Fit a garment template to the ground-truth garment mesh (counterpart
of the repo's ``tools/fitting_garment_meshes.py``), so that a Chamfer
score compares meshes of one topology with open boundaries: the synthetic
body's procedural tube template → Laplacian match onto the GT boundary
rings → NRICP coarse (the visible target vertices from K1's 12-view scan)
→ isotropic remesh → NRICP refine, through the port's
``core.inference.register_garment``; then the fit's chamfer against the
GT vertices, written to ``<out>/fit_report.json``.

For the synthetic scenes the GT mesh is ``gt_meshes/0.npz`` (frame 0's
pose is the canonical A-pose, so the fit runs in canonical space) and the
GT curves are the generator's boundary rings.

    python -m recmv_tpu_torch.tools.fitting_garment_meshes --data-root <scene> \\
        [--quick] [--device cuda]

``--device`` (default ``cuda``; ``cpu`` for the tests) replaces the JAX
tool's ``--platform``.
"""

from __future__ import annotations

import argparse
import json
import os
import os.path as osp

import numpy as np
import torch


def fit_schedules(quick: bool):
    """(coarse, refine) NRICP schedules: short ones, or the reference's
    fitting schedule (250 epochs, stiffness 50 → 0.1) with
    ``register_garment``'s production refine."""
    from ..geometry.nricp import NricpConfig

    if quick:
        return (NricpConfig(epochs=25, inner_iter=10, first_inner_iter=30,
                            stiffness_weight=(50.0, 5.0, 0.8), milestones=(8, 16),
                            laplacian_weight=(250.0,) * 3, threshold=0.3, lr=1e-3),
                NricpConfig(epochs=10, inner_iter=10, first_inner_iter=10,
                            stiffness_weight=(0.8, 0.2), milestones=(5,),
                            laplacian_weight=(250.0,) * 2, threshold=0.5, lr=5e-4))
    return (NricpConfig(epochs=250, inner_iter=10, first_inner_iter=60,
                        stiffness_weight=(50.0, 20.0, 5.0, 2.0, 0.8, 0.5, 0.35, 0.2, 0.1),
                        milestones=(50, 80, 100, 110, 120, 130, 140, 200),
                        laplacian_weight=(250.0,) * 9, threshold=0.3, lr=1e-3),
            None)


def main(argv=None) -> dict:
    from .. import resolve_device
    from ..core.inference import register_garment
    from ..data.synthetic import TORSO_Y, apose, boundary_ring
    from ..models.garment import procedural_template
    from ..models.skinner import initial_lbs_skinner
    from ..models.smpl import synthetic_body_model
    from ..ops.knn import chamfer_distance

    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--data-root", required=True)
    ap.add_argument("--out", default=None, help="output directory (<data-root>/gt_fits)")
    ap.add_argument("--quick", action="store_true", help="short NRICP schedules")
    ap.add_argument("--device", default="cuda", help="torch device (cuda or cpu)")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)

    out_dir = args.out or osp.join(args.data_root, "gt_fits")
    os.makedirs(out_dir, exist_ok=True)
    gt_path = osp.join(args.data_root, "gt_meshes", "0.npz")
    if not osp.isfile(gt_path):
        gt_path = osp.join(args.data_root, "gt_meshes", "0000.npz")
    gt = np.load(gt_path)
    gt_v, gt_f = gt["verts"].astype(np.float32), gt["faces"].astype(np.int64)

    # the canonical body and template of the synthetic scenes' generator
    sk, body_vs, body_fs = initial_lbs_skinner(
        synthetic_body_model(), torch.zeros(10, device=device), apose(),
        resolution=(17, 25, 9))
    template = procedural_template("tube", body_vs.cpu().numpy(), np.asarray(body_fs),
                                   sk.Js.cpu().numpy())
    curves = {"neck": boundary_ring(TORSO_Y[1] - 0.01),
              "bottom_curve": boundary_ring(TORSO_Y[0] + 0.01)}
    cfg, rcfg = fit_schedules(args.quick)
    rv, _, labels = register_garment(template, gt_v, gt_f, curves,
                                     save_path=osp.join(out_dir, "registry_gt_tube.obj"),
                                     nricp_cfg=cfg, refine_cfg=rcfg, remesh=True, device=device)
    d = float(chamfer_distance(torch.as_tensor(rv, device=device),
                               torch.as_tensor(gt_v, device=device)))
    result = {"garment": "tube", "fit_chamfer_l2": d, "n_verts": int(len(rv)),
              "n_gt_verts": int(len(gt_v)), "labels": sorted(labels)}
    with open(osp.join(out_dir, "fit_report.json"), "w") as f:
        json.dump(result, f, indent=1)
    print(json.dumps(result))
    return result


if __name__ == "__main__":
    main()
