"""The large-pose stage's step (counterpart of the repo's
``tools/bench_largepose.py``): the large-pose ``train_step`` (SDFs frozen,
no ① curve branch) at 1080², 2,048 rays, batch 1 and the fine pyramid, on
a synthetic-tube scene made a large-pose one by
``data.synthetic.make_large_pose_scene`` (feature lines on the first
``--annotated`` frames only, a TCMR pickle written without joblib with the
scene's poses and the synthetic body's 2D joints at zero betas, no depth
drift: the JAX tool's scene). The stage-1 stand-in is the cached IGR
initialization (``result/bench_init.ckpt``); the timed region is the
large-pose stage on the frames after the A-pose range
(``LargePoseDataset(a_pose=False)``).

    python -m recmv_tpu_torch.tools.bench_largepose [--steps 6]

Records ``first_step_s``, ``per_step_s``, ``sec_per_step``, ``all_finite``
and ``sdf_max_abs_delta``, the largest change of any body or garment SDF
parameter over the steps, which must be exactly 0.

``--device`` (default ``cuda``; ``cpu`` for the tests) replaces the JAX
tool's ``--platform``; ``--cache-dir``, ``--exec-cache`` and the
``warm_start`` compile (``warm_start_s``) have no counterpart.
"""

from __future__ import annotations

import argparse
import os.path as osp

import numpy as np
import torch

from . import bench_path, device_record, timed_step, write_record
from .bench_fullstep import build_bench_net


def parse_args(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default="cuda", help="torch device (cuda or cpu)")
    ap.add_argument("--image", type=int, default=1080)
    ap.add_argument("--frames", type=int, default=8)
    ap.add_argument("--annotated", type=int, default=4, help="frames with feature lines")
    ap.add_argument("--quality", default="fine", help="seg3d pyramid")
    ap.add_argument("--sample-pix", type=int, default=2048)
    ap.add_argument("--batch", type=int, default=1)
    ap.add_argument("--steps", type=int, default=6)
    ap.add_argument("--init-epochs", type=int, default=40)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--scene", default=bench_path("scenes", "largepose"),
                    help="scene path prefix (+ _<image>_<frames>)")
    ap.add_argument("--out", default=bench_path("bench_largepose.json"))
    return ap.parse_args(argv)


def large_pose_dataset(scene: str, annotated: int, device):
    """Make ``scene`` a large-pose scene once (no TCMR pickle yet) and
    return its large-motion ``LargePoseDataset``."""
    from ..data.dataset import LargePoseDataset
    from ..data.synthetic import make_large_pose_scene

    if not osp.isfile(osp.join(scene, "synthetic-tube_tcmr_output.pkl")):
        make_large_pose_scene(scene, annotated, np.zeros(10, np.float32), depth_drift=0.0,
                              pose_step=0.0, device=device)
    ds = LargePoseDataset(scene, {"deformer": 256, "render": 256},
                          garment_type="synthetic-tube", a_pose=False)
    if ds.start_idx != annotated:
        raise ValueError(f"the large-motion range starts at {ds.start_idx}, not {annotated}")
    return ds


def sdf_leaves(net) -> dict:
    """The body and garment SDFs' parameters by name, detached copies."""
    return {f"{k}.{n}": p.detach().clone() for k in ("sdf", "garment_sdfs")
            for n, p in net.params[k].named_parameters()}


def main(argv=None) -> dict:
    from .. import resolve_device

    args = parse_args(argv)
    dev = resolve_device(args.device)
    dataset, net, t_build, t_init = build_bench_net(
        args, dev, dataset_fn=lambda scene: large_pose_dataset(scene, args.annotated, dev))
    print(f"[bench-lp] build {t_build:.1f}s init {t_init:.1f}s", flush=True)

    net.large_pose = True            # frozen SDFs, no ① curve branch
    net._init_global_opt()
    ratio = {"sdfRatio": 1.0, "deformerRatio": 1.0, "renderRatio": 1.0}
    gen = torch.Generator(device=dev).manual_seed(args.seed)
    fids = list(range(args.batch))
    loss, _, first_step, _ = timed_step(net, dataset.get_batch(fids), fids, ratio, gen)
    print(f"[bench-lp] first step {first_step:.2f}s loss={loss:.4f}", flush=True)

    sdf0 = sdf_leaves(net)
    per_step, finite = [], True
    for s in range(args.steps):
        fl = [(s + k) % dataset.frame_num for k in range(args.batch)]
        loss, _, dt, ms = timed_step(net, dataset.get_batch(fl), fl, ratio, gen)
        per_step.append(round(dt, 4))
        finite &= bool(np.isfinite(loss))
        print(f"[bench-lp] step {s}: {dt:.3f}s phases_ms "
              f"{ {k: round(v, 2) for k, v in ms.items()} } loss={loss:.4f}", flush=True)
    sdf1 = sdf_leaves(net)
    moved = max(float((sdf1[k] - v).abs().max()) for k, v in sdf0.items())

    out = {
        "config": {"image": args.image, "frames": args.frames, "annotated": args.annotated,
                   "batch": args.batch, "pyramid": list(net.seg3d_cfg.resolutions[-1]),
                   "quality": args.quality, "steps": args.steps},
        **device_record(dev),
        "large_motion_frames": dataset.frame_num,
        "start_idx": dataset.start_idx,
        "first_step_s": round(first_step, 4),
        "sec_per_step": round(float(np.mean(per_step)), 4),
        "per_step_s": per_step,
        "all_finite": finite,
        "sdf_max_abs_delta": moved,
        "t_build_s": round(t_build, 2), "t_init_s": round(t_init, 2),
    }
    return write_record(args.out, out)


if __name__ == "__main__":
    main()
