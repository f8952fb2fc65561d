"""Export a fitted scene's canonical feature curves as tube meshes
(counterpart of ``tools/visualize_curve.py``): one ``cano_<curve>.obj``
per feature line and, with ``--frames``, the tubes of the curves deformed
to each frame (``NNNN_<curve>.obj``, what ``infer --curves-only`` exports
per frame), under ``<save>/curve_vis`` unless ``--out`` is given. The
network comes from ``recmv_tpu_torch.infer.load_net``.

    python -m recmv_tpu_torch.tools.visualize_curve --data-root <scene>
        [--save-folder result] [--frames 0 1] [--device cuda]

``--device`` (default ``cuda``; ``cpu`` for the tests) replaces the JAX
tool's ``--platform``.
"""

from __future__ import annotations

import argparse
import os
import os.path as osp

import torch


def main(argv=None) -> list:
    """Run the tool; returns the paths written."""
    from ..infer import load_net
    from ..models.curves import curve_to_tube_mesh, curves_forward
    from ..utils.io import save_obj

    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--data-root", required=True)
    ap.add_argument("--save-folder", default="result")
    ap.add_argument("--ckpt", default=None)
    ap.add_argument("--out", default=None, help="default <save>/curve_vis")
    ap.add_argument("--radius", type=float, default=0.002)
    ap.add_argument("--joints", type=int, default=6)
    ap.add_argument("--frames", type=int, nargs="*", default=None,
                    help="also export tubes deformed to these frames")
    ap.add_argument("--device", default="cuda", help="torch device (cuda or cpu)")
    args = ap.parse_args(argv)

    net, _, save_root = load_net(argparse.Namespace(
        data_root=args.data_root, save_folder=args.save_folder, ckpt=args.ckpt, conf=None,
        quality="small", device=args.device))
    out = args.out or osp.join(save_root, "curve_vis")
    os.makedirs(out, exist_ok=True)
    with torch.no_grad():
        curves = curves_forward(net.params["curves"], net.curve_statics)
    curves_np = curves.cpu().numpy()
    nx = net.curve_statics.nx[:, 0].cpu().numpy()
    names = net.curve_statics.fl_names
    wrote = []

    def export(prefix, pts):
        for ci, cname in enumerate(names):
            tv, tf = curve_to_tube_mesh(pts[ci], nx[ci], args.radius, args.joints)
            path = osp.join(out, f"{prefix}_{cname}.obj")
            save_obj(path, tv, tf)
            wrote.append(path)

    export("cano", curves_np)
    ratio = {"sdfRatio": 1.0, "deformerRatio": 1.0, "renderRatio": 1.0}
    for fid in args.frames or []:
        with torch.no_grad():
            posed = net._deform_garment_verts([curves.reshape(-1, 3)],
                                              torch.as_tensor([fid], device=net.device),
                                              ratio)[0][0]
        export(f"{fid:04d}", posed.cpu().numpy().reshape(curves_np.shape))
    print(f"[visualize_curve] wrote {len(wrote)} tube meshes under {out}")
    return wrote


if __name__ == "__main__":
    main()
