"""Per-scene training CLI of the port (counterpart of the repo's
``train.py``): parse the HOCON config, build the dataset and the network,
initialize the scene once (or resume), then the epoch loop with the
medium/fine promotions, the MultiStepLR scale, checkpoints at each
epoch's end and the per-step log.

    python -m recmv_tpu_torch.train --conf configs/synthetic/smoke.conf \\
        --data-root /path/to/scene [--device cuda] [--max-steps N]

It runs on the CUDA card (``--device cuda``, the default) and raises
without one; ``--device cpu`` runs it on the CPU. The JAX-only options
(``--platform``, ``--cache-dir``, ``--exec-cache``) and the compile
warm-up have no counterpart. ``--wandb`` is refused: a wandb backend needs
a network. After each step that remeshed (``info["remeshed"]``, which the
port's step reports in place of the JAX wall time ``t_remesh > 0.5``),
``--save-debug`` writes ``utils/debug_vis``'s curve overlays, mask
comparisons and garment turntables into ``<save>/debug``; without it, and
with the visualizer on, a remesh past step 1 logs the turntables into
``<save>/logs``, as ``train.py`` does.
"""

from __future__ import annotations

import argparse
import os
import os.path as osp
import time

import numpy as np
import torch

_NO_WANDB = "--wandb needs a network; the local JSONL/PNG visualizer logs instead"


def parse_args(argv=None):
    p = argparse.ArgumentParser(description="REC-MV per-scene optimization (PyTorch port)")
    p.add_argument("--conf", required=True)
    p.add_argument("--data-root", required=True)
    p.add_argument("--save-folder", default="result")
    p.add_argument("--resume", default=None, help="checkpoint to resume from")
    p.add_argument("--a-pose", action="store_true", default=True)
    p.add_argument("--no-a-pose", dest="a_pose", action="store_false")
    p.add_argument("--quality", default="coarse",
                   choices=["tiny", "small", "coarse", "medium", "fine", "higher"],
                   help="marching-cube pyramid size")
    p.add_argument("--init-epochs", type=int, default=None,
                   help="SDF init epochs (default |train.initial_iters|)")
    p.add_argument("--fl-iters", type=int, default=150,
                   help="iterations of the curve fit in the initialization")
    p.add_argument("--max-steps", type=int, default=None,
                   help="cap optimization steps (smoke runs)")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--device", default="cuda", help="torch device (cuda or cpu)")
    p.add_argument("--save-debug", action="store_true",
                   help="write debug overlays (projected curves, mask comparisons, mesh "
                        "turntables) into <save>/debug after each remesh")
    p.add_argument("--wandb", action="store_true", help="refused: " + _NO_WANDB)
    p.add_argument("--no-vis", action="store_true",
                   help="disable the per-step scalar log (<save>/logs/scalars.jsonl) and "
                        "the turntables logged at each remesh")
    return p.parse_args(argv)


def main(argv=None):
    """Run the CLI; returns the network."""
    args = parse_args(argv)
    if args.wandb:
        raise SystemExit(f"train: {_NO_WANDB}")

    from . import resolve_device
    from .config import ConfigFactory, dump_config
    from .config.constants import TEMPLATE_GARMENT
    from .core.builder import build_opt_net, resolution_pyramids
    from .data.dataset import get_dataset_and_loader
    from .utils.debug_vis import save_debug, turntable_curve_mesh
    from .utils.visualizer import get_visualizer

    device = resolve_device(args.device)
    conf = ConfigFactory.parse_file(args.conf)
    garment_type = conf.get_string("train.garment_type")
    data_type = conf.get_string("train.data_type", "people_snap")
    save_root = osp.join(args.data_root, args.save_folder)
    os.makedirs(save_root, exist_ok=True)
    with open(osp.join(save_root, "config.conf"), "w") as f:
        f.write(dump_config(conf))

    n_garments = len(TEMPLATE_GARMENT[garment_type])
    conds_lens = {"deformer": conf.get_int("mlp_deformer.condlen") * (1 + n_garments),
                  "render": conf.get_int("render_net.condlen")}
    batch_size = conf.get_int("train.coarse.point_render.batch_size")
    dataset, sampler = get_dataset_and_loader(
        args.data_root, conds_lens, batch_size, shuffle=conf.get_bool("train.shuffle", True),
        garment_type=garment_type, data_type=data_type, a_pose=args.a_pose, seed=args.seed)
    print(f"[train] scene {args.data_root}: {dataset.frame_num} frames "
          f"{dataset.W}x{dataset.H}, garments {TEMPLATE_GARMENT[garment_type]}, device {device}")

    skinner_res = {"tiny": (17, 25, 9), "small": (65, 113, 33)}.get(args.quality,
                                                                   (129, 225, 65))
    net = build_opt_net(conf, dataset, save_root, resolutions=resolution_pyramids(args.quality),
                        skinner_res=skinner_res, seed=args.seed, device=device)
    gen = torch.Generator(device=device).manual_seed(args.seed)

    start_epoch = 0
    ckpt_latest = osp.join(save_root, "latest.ckpt")
    init_ckpt = osp.join(save_root, "initial_sdf.ckpt")
    if args.resume and osp.isfile(args.resume):
        start_epoch = net.load_checkpoint(args.resume)
        print(f"[train] resumed from {args.resume} at epoch {start_epoch}")
    elif osp.isfile(init_ckpt):
        net.load_checkpoint(init_ckpt)
        print("[train] loaded cached SDF initialization")
    else:
        init_iters = args.init_epochs
        if init_iters is None:
            init_iters = abs(conf.get_int("train.initial_iters", -1200))
        print(f"[train] one-time initialization ({init_iters} IGR epochs)...")
        t0 = time.time()
        # DeepFashion3D-registered template assets (smpl_clothes_template
        # layout) when the scene ships them; body-slice templates otherwise
        template_dir = conf.get_string("train.template_dir", "")
        if not template_dir:
            cand = osp.join(args.data_root, "smpl_clothes_template")
            template_dir = cand if osp.isdir(cand) else None
        net.initialize_tmp_sdf(nepochs=init_iters, save_dir=save_root,
                               template_dir=template_dir, fl_iters=args.fl_iters, generator=gen)
        print(f"[train] initialization done in {time.time() - t0:.1f}s")

    if net.curve_statics is None:
        # resumed checkpoints carry curves; the initialization builds them
        net.initialize_tmp_sdf(nepochs=1, save_dir=save_root, fl_iters=20, generator=gen)

    nepochs = conf.get_int("train.nepoch")
    milestones = conf.get_list("train.scheduler.milestones", [])
    factor = conf.get_float("train.scheduler.factor", 0.333)
    visualizer = None
    if not args.no_vis:
        visualizer = get_visualizer(
            osp.join(save_root, "logs"), project="recmv_tpu",
            name=f"{garment_type}_{osp.basename(osp.normpath(args.data_root))}")

    ratio = {"sdfRatio": 1.0, "deformerRatio": 0.5, "renderRatio": 1.0}
    steps = 0
    t_start = time.time()
    try:
        for epoch in range(start_epoch, nepochs):
            for phase in ("medium", "fine"):           # hierarchy promotions
                se = conf.get_int(f"train.{phase}.start_epoch", -1)
                if se >= 0 and epoch == se:
                    net.conf.set_loss_block(conf.get_config(f"loss_{phase}"))
                    net.cfg.point_radius = conf.get_float(f"train.{phase}.point_render.radius")
                    net.cfg.remesh_intersect = conf.get_int(
                        f"train.{phase}.point_render.remesh_intersect")
                    sampler.bs = conf.get_int(f"train.{phase}.point_render.batch_size")
                    net.isfine = phase == "fine"
                    net.on_phase_change()
                    net.mesh = None  # force a remesh at the new resolution
                    net.save_checkpoint(osp.join(save_root, f"{phase}_promote.ckpt"), epoch)
                    print(f"[train] enabled {phase} hierarchy")

            lr_scale = factor ** sum(1 for m in milestones if epoch >= int(m))
            net.set_lr_scale(lr_scale)

            for fids in sampler:
                batch = dataset.get_batch(fids)
                ratio["deformerRatio"] = net.opt_times / 2500.0 + 0.5
                t0 = time.time()
                loss, info = net.train_step(batch, fids, ratio, generator=gen)
                steps += 1
                if visualizer is not None:
                    visualizer.add_scalars({**info, "loss": float(loss), "lr_scale": lr_scale},
                                           steps)
                remeshed = info["remeshed"] > 0.5
                if args.save_debug and remeshed:
                    dbg = osp.join(save_root, "debug")
                    save_debug(net, batch, fids, ratio, dbg, step=steps, visualizer=visualizer)
                    turntable_curve_mesh(net, ratio, dbg, step=steps, visualizer=visualizer)
                elif visualizer is not None and remeshed and steps > 1:
                    turntable_curve_mesh(net, ratio, osp.join(save_root, "logs"), step=steps,
                                         visualizer=visualizer, save_meshes=False)
                msg = " ".join(f"{k}={v:.4f}" for k, v in sorted(info.items()))
                print(f"[{garment_type}] ep{epoch} step{steps} loss={loss:.5f} "
                      f"({time.time() - t0:.1f}s) {msg}")
                nans = [k for k, v in info.items() if not np.isfinite(v)]
                if nans:
                    print(f"[train] WARNING non-finite terms: {nans}")
                if args.max_steps and steps >= args.max_steps:
                    net.save_checkpoint(ckpt_latest, epoch)
                    print(f"[train] reached max steps; total {time.time() - t_start:.1f}s")
                    return net
            net.save_checkpoint(ckpt_latest, epoch)
        print(f"[train] done in {time.time() - t_start:.1f}s")
        return net
    finally:
        if visualizer is not None:
            visualizer.close()


if __name__ == "__main__":
    main()
