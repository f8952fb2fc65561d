"""Garment extraction and per-frame export from a fitted scene, the
inference CLI of the port (counterpart of the repo's ``infer_fl.py`` and,
with ``--curves-only``, ``infer_fl_curve.py``): load the saved config and
checkpoint, extract the marching-cube meshes, register the open garment
templates (Laplacian curve alignment, the visibility scan, NRICP, remesh)
and export the per-frame posed garments, bodies and renders.

    python -m recmv_tpu_torch.infer --data-root /path/to/scene [--frames 0 1]
        [--device cuda] [--curves-only] [--no-images] [--no-color]

It runs on the CUDA card (``--device cuda``, the default) and raises
without one; ``--device cpu`` runs it on the CPU. ``--device`` takes the
place of the JAX CLI's ``--platform``; every other flag is the same.
"""

from __future__ import annotations

import argparse
import os.path as osp

import numpy as np


def parse_args(argv=None):
    p = argparse.ArgumentParser(description="REC-MV garment inference (PyTorch port)")
    p.add_argument("--data-root", required=True)
    p.add_argument("--save-folder", default="result")
    p.add_argument("--conf", default=None, help="defaults to <save>/config.conf")
    p.add_argument("--ckpt", default=None, help="defaults to <save>/latest.ckpt")
    p.add_argument("--out", default=None, help="defaults to <save>/infer")
    p.add_argument("--quality", default="coarse",
                   choices=["small", "coarse", "medium", "fine", "higher"])
    p.add_argument("--frames", type=int, nargs="*", default=None)
    p.add_argument("--device", default="cuda", help="torch device (cuda or cpu)")
    p.add_argument("--curves-only", action="store_true",
                   help="export feature-curve tube meshes (infer_fl_curve)")
    p.add_argument("--no-images", action="store_true",
                   help="skip png renders (reference --nI)")
    p.add_argument("--no-color", action="store_true",
                   help="skip per-pixel RenderNet colors (reference --nColor)")
    p.add_argument("--smooth", dest="smooth", action="store_true", default=None,
                   help="force OneEuro pose/trans smoothing on")
    p.add_argument("--no-smooth", dest="smooth", action="store_false",
                   help="force smoothing off (default: on for subjects with "
                        "SMOOTH_TRANS ranges, like the reference's smooth_trans "
                        "gate, OptimGarmentNetwork.py:2984-2989)")
    p.add_argument("--offset-filter", action="store_true",
                   help="replace outlier frames' deformer latents with the "
                        "last stable frame's (offset_filter, "
                        "OptimGarmentNetwork.py:2519-2560)")
    return p.parse_args(argv)


def load_net(args):
    """The network of a fitted scene on ``args.device``: the saved config,
    the dataset, the latest checkpoint (``initial_sdf.ckpt`` when there is
    none), and the garment templates rebuilt from the body, as the JAX
    ``load_net`` does → (net, dataset, save_root)."""
    from . import resolve_device
    from .config import ConfigFactory
    from .config.constants import TEMPLATE_GARMENT
    from .core.builder import build_opt_net, resolution_pyramids
    from .data.dataset import get_dataset_and_loader
    from .models.garment import garment_templates_from_body

    device = resolve_device(args.device)
    save_root = osp.join(args.data_root, args.save_folder)
    conf = ConfigFactory.parse_file(args.conf or osp.join(save_root, "config.conf"))
    garment_type = conf.get_string("train.garment_type")
    n_g = len(TEMPLATE_GARMENT[garment_type])
    conds_lens = {"deformer": conf.get_int("mlp_deformer.condlen") * (1 + n_g),
                  "render": conf.get_int("render_net.condlen")}
    dataset, _ = get_dataset_and_loader(
        args.data_root, conds_lens, 1, shuffle=False, garment_type=garment_type,
        data_type=conf.get_string("train.data_type", "people_snap"))
    net = build_opt_net(conf, dataset, save_root, resolutions=resolution_pyramids(args.quality),
                        device=device)
    ckpt = args.ckpt or osp.join(save_root, "latest.ckpt")
    if not osp.isfile(ckpt):
        ckpt = osp.join(save_root, "initial_sdf.ckpt")
    net.load_checkpoint(ckpt)
    # the registration needs the templates: rebuild them from the body
    net.garment_templates = garment_templates_from_body(
        net.statics.garment_names, net.tmp_body_vs.cpu().numpy(),
        net.tmp_body_fs.cpu().numpy(), net.params["skinner"].Js.cpu().numpy())
    return net, dataset, save_root


def main(argv=None):
    """Run the CLI; returns the ``GarmentInference`` (its ``stats`` hold
    the export's seconds and colour-pass counts)."""
    from .config.constants import SMOOTH_TRANS
    from .core.inference import GarmentInference, smooth_scene_poses

    args = parse_args(argv)
    net, dataset, save_root = load_net(args)
    out = args.out or osp.join(save_root, "infer")
    inf = GarmentInference(net)
    frames = args.frames if args.frames else list(range(dataset.frame_num))
    ratio = {"sdfRatio": 1.0, "deformerRatio": 1.0, "renderRatio": 1.0}

    # pose smoothing per the SMOOTH_TRANS subject table (smooth_trans,
    # OptimGarmentNetwork.py:2567-2728, 2984-2989): on by default for
    # subjects with jitter ranges, forceable either way
    subject = osp.basename(args.data_root.rstrip("/"))
    ranges = [r for r in SMOOTH_TRANS.get(subject, []) if len(r) == 2]
    if args.smooth if args.smooth is not None else bool(ranges):
        net.sync_scene_to_dataset()
        smooth_scene_poses(dataset, ranges=ranges or None)
        net.invalidate_scene()
        print(f"[infer] smoothed poses/trans "
              f"({'ranges ' + str(ranges) if ranges else 'all frames'})")

    if args.quality == "higher":
        # the 513³ inference grids (reference train.py:47-79 `higher`): a
        # fresh body and garments in the host path's larger buffers
        print("[infer] extracting at 513³ via the host marching cubes ...")
        net.marching_cube_update(ratio, higher=True)

    if args.curves_only:
        inf.infer_garment_fl(np.asarray(frames), ratio, osp.join(out, "fl_meshs"))
    else:
        if args.offset_filter:
            inf.ensure_registration(ratio, out)
            inf.offset_filter(ratio)
        _, errors = inf.infer_garment(np.asarray(frames), ratio, out,
                                      images=not args.no_images, colors=not args.no_color)
        np.save(osp.join(out, "maskE.npy"), errors["maskE"])
    print(f"[infer] wrote outputs under {out}")
    return inf


if __name__ == "__main__":
    main()
