"""Large-pose training stage of the port (counterpart of the repo's
``train_large_pose.py``; reference ``train_large_pose.py``): resume from the
self-rotation (A-pose) fit, freeze every SDF parameter and switch the
curve branch off, and optimize only the deformation field, the render net
and the scene leaves over the large-motion range.

    python -m recmv_tpu_torch.train_large_pose --conf <conf> --data-root <scene> \\
        [--resume <ckpt>] [--start-epoch 60] [--max-steps N] [--device cuda]

It reads ``<scene>/<save-folder>/latest.ckpt`` (or ``--resume``), which
``python -m recmv_tpu_torch.train`` writes, and raises without it; it
writes ``large_pose.ckpt`` beside it. The dataset is the conf's
``train.data_type`` (default ``large_pose``) with ``a_pose=False``. The
epochs run from ``--start-epoch`` (the reference forces 60) to the conf's
``train.nepoch``: on a conf with fewer epochs, such as
``configs/synthetic/smoke.conf`` (2), pass ``--start-epoch 0`` or nothing
runs. It runs on the CUDA card (``--device cuda``, the default) and
raises without one; ``--device cpu`` runs it on the CPU.
"""

from __future__ import annotations

import argparse
import os.path as osp
import time

import torch


def parse_args(argv=None):
    p = argparse.ArgumentParser(description="REC-MV large-pose stage (PyTorch port)")
    p.add_argument("--conf", required=True)
    p.add_argument("--data-root", required=True)
    p.add_argument("--save-folder", default="result")
    p.add_argument("--resume", default=None,
                   help="defaults to <save>/latest.ckpt (the a-pose fit)")
    p.add_argument("--quality", default="coarse",
                   choices=["tiny", "small", "coarse", "medium", "fine", "higher"])
    p.add_argument("--max-steps", type=int, default=None)
    p.add_argument("--start-epoch", type=int, default=60)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--device", default="cuda", help="torch device (cuda or cpu)")
    return p.parse_args(argv)


def main(argv=None):
    """Run the stage; returns the network."""
    args = parse_args(argv)

    from . import resolve_device
    from .config import ConfigFactory
    from .config.constants import TEMPLATE_GARMENT
    from .core.builder import build_opt_net, resolution_pyramids
    from .data.dataset import get_dataset_and_loader

    device = resolve_device(args.device)
    conf = ConfigFactory.parse_file(args.conf)
    garment_type = conf.get_string("train.garment_type")
    save_root = osp.join(args.data_root, args.save_folder)
    ckpt = args.resume or osp.join(save_root, "latest.ckpt")
    if not osp.isfile(ckpt):
        raise FileNotFoundError(f"large-pose stage requires the a-pose fit: {ckpt}")
    n_g = len(TEMPLATE_GARMENT[garment_type])
    conds_lens = {"deformer": conf.get_int("mlp_deformer.condlen") * (1 + n_g),
                  "render": conf.get_int("render_net.condlen")}
    dataset, sampler = get_dataset_and_loader(
        args.data_root, conds_lens, conf.get_int("train.coarse.point_render.batch_size"),
        garment_type=garment_type, data_type=conf.get_string("train.data_type", "large_pose"),
        a_pose=False, seed=args.seed)

    skinner_res = {"tiny": (17, 25, 9), "small": (65, 113, 33)}.get(args.quality,
                                                                   (129, 225, 65))
    net = build_opt_net(conf, dataset, save_root, resolutions=resolution_pyramids(args.quality),
                        skinner_res=skinner_res, seed=args.seed, device=device)
    net.large_pose = True
    net.load_checkpoint(ckpt)      # restarts the global Adam with the SDFs frozen
    gen = torch.Generator(device=device).manual_seed(args.seed)
    print(f"[large-pose] {dataset.frame_num} frames from {dataset.start_idx}, resumed from "
          f"{ckpt}, device {device}")

    ratio = {"sdfRatio": 1.0, "deformerRatio": 1.0, "renderRatio": 1.0}
    out = osp.join(save_root, "large_pose.ckpt")
    steps = 0
    t_start = time.time()
    for epoch in range(args.start_epoch, conf.get_int("train.nepoch")):
        for fids in sampler:
            batch = dataset.get_batch(fids)
            t0 = time.time()
            loss, info = net.train_step(batch, fids, ratio, generator=gen)
            steps += 1
            print(f"[large-pose] ep{epoch} step{steps} loss={loss:.5f} "
                  f"({time.time() - t0:.1f}s)")
            if args.max_steps and steps >= args.max_steps:
                net.save_checkpoint(out, epoch)
                return net
        net.save_checkpoint(out, epoch)
    print(f"[large-pose] done in {time.time() - t_start:.1f}s")
    return net


if __name__ == "__main__":
    main()
