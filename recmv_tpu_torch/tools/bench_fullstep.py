"""The production training step at full size (counterpart of the repo's
``tools/bench_fullstep.py``): the whole ``train_step`` (① curves, ② mask,
ray seeding, the surface solve, ③ main, the updates) at 1080², 2,048 rays,
batch 1, the fine seg3d pyramid (321, 417, 225), skinner (129, 225, 65) and
the marching cubes' buffers sized for the finest grid (2^21 vertices, 2^22
faces), on a generated synthetic-tube scene initialized once (cached as
``result/bench_init.ckpt``).

    python -m recmv_tpu_torch.tools.bench_fullstep [--steps 4] [--sustain 20] [--profile]

Records: ``first_step_s`` (the cold step: cuBLAS set-up and the first
remesh), ``sec_per_step`` (mean of the warm steps, host clock ending in a
synchronize), ``remesh_first_s`` and ``remesh_warm_s`` (one
``marching_cube_update``), ``sec_per_step_amortized`` (a warm remesh every
``remesh_intersect`` = 120 steps), per-phase means by CUDA events
(``phase_means_ms``; ``phase_means_s`` in seconds), the peak device
memory, ``step_cost`` (the step's FLOPs by
``GarmentOptimNetwork.step_cost_analysis`` over ``sec_per_step``, and the
MFU against the H100's 67 TFLOP/s float32 peak: TF32 is off) and, with
``--sustain N``, N more steps at remesh cadence 8 with their times and
finiteness. ``--profile [DIR]`` writes a ``torch.profiler`` trace of the
warm steps, the step's spans in it, into ``DIR/trace.json`` and their
counters into ``DIR/counters.json`` (``utils.profiling.trace``).

``--device`` (default ``cuda``; ``cpu`` for the tests) replaces the JAX
tool's ``--platform``; ``--cache-dir``, ``--exec-cache`` and the
``warm_start`` compile (``warm_start_s``, ``warm_start_runs_s``) are JAX
compile workarounds with no counterpart.
"""

from __future__ import annotations

import argparse
import contextlib
import os.path as osp
import time

import numpy as np
import torch

from . import REPO, bench_path, device_record, sync, timed_step, write_record

SKINNER_RES = (129, 225, 65)     # the skinning field of the benches' networks


def parse_args(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default="cuda", help="torch device (cuda or cpu)")
    ap.add_argument("--image", type=int, default=1080)
    ap.add_argument("--frames", type=int, default=4)
    ap.add_argument("--quality", default="fine", help="seg3d pyramid")
    ap.add_argument("--sample-pix", type=int, default=2048)
    ap.add_argument("--batch", type=int, default=1, help="frames per step")
    ap.add_argument("--steps", type=int, default=4, help="timed warm steps")
    ap.add_argument("--sustain", type=int, default=0,
                    help="then N steps at remesh cadence 8 (per-step walls, finiteness)")
    ap.add_argument("--profile", nargs="?", const=bench_path("fullstep_trace"), default=None,
                    metavar="DIR", help="write a torch.profiler trace of the warm steps into "
                    "DIR/trace.json and their counters into DIR/counters.json (default DIR: "
                    "recmv_tpu_torch/_bench/fullstep_trace)")
    ap.add_argument("--init-epochs", type=int, default=40)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--scene", default=bench_path("scenes", "bench"),
                    help="scene path prefix (+ _<image>_<frames>)")
    ap.add_argument("--out", default=bench_path("bench_fullstep.json"))
    return ap.parse_args(argv)


def build_bench_net(args, dev, dataset_fn=None):
    """The bench scene (made or reused), its dataset and the initialized
    network at ``args``' sizes → (dataset, net, build seconds, init
    seconds). ``dataset_fn(scene)`` makes the dataset (default: the
    synthetic-tube scene's, batch ``args.batch``)."""
    from ..config import ConfigFactory
    from ..core.builder import build_opt_net, resolution_pyramids, scene_caps
    from ..core.network import TrainConfig
    from ..data.dataset import get_dataset_and_loader
    from ..data.synthetic import ensure_scene

    scene = f"{args.scene}_{args.image}_{args.frames}"
    ensure_scene(scene, n_frames=args.frames, image_size=args.image, skinner_res=(49, 81, 25),
                 raster_cap=2048, device=dev)
    conf = ConfigFactory.parse_file(osp.join(REPO, "configs", "synthetic", "smoke.conf"))
    if dataset_fn is None:
        dataset, _ = get_dataset_and_loader(scene, {"deformer": 256, "render": 256}, args.batch,
                                            shuffle=False, garment_type="synthetic-tube",
                                            data_type="synthe")
    else:
        dataset = dataset_fn(scene)
    pyr = resolution_pyramids(args.quality)
    # the reference's fine phase (radius, cadence); the marching cubes'
    # buffers for the finest grid and the half-resolution mask render
    cfg = TrainConfig(sample_pix=args.sample_pix, point_radius=0.0041, remesh_intersect=120,
                      **scene_caps((args.image, args.image), pyr))
    t0 = time.time()
    net = build_opt_net(conf, dataset, osp.join(scene, "result"), resolutions=pyr,
                        skinner_res=SKINNER_RES, train_cfg=cfg, device=dev)
    sync(dev)
    t_build = time.time() - t0
    t0 = time.time()
    init_ckpt = osp.join(scene, "result", "bench_init.ckpt")
    if osp.isfile(init_ckpt):
        net.load_checkpoint(init_ckpt)
    else:
        net.initialize_tmp_sdf(nepochs=args.init_epochs, save_dir=None, fl_iters=10,
                               generator=torch.Generator(device=dev).manual_seed(args.seed))
        net.save_checkpoint(init_ckpt, 0)
    sync(dev)
    return dataset, net, t_build, time.time() - t0


def step_cost(net, step, sec_per_step: float) -> dict:
    """FLOPs of one training step (``step_cost_analysis`` of ``step``) over
    ``sec_per_step``, against the 67 TFLOP/s float32 peak."""
    from ..utils.profiling import FP32_FLOP_PER_S

    costs = net.step_cost_analysis(step)
    tflops = costs["flops"] / sec_per_step / 1e12
    return {"step_gflops": round(costs["flops"] / 1e9, 3),
            "gemm_gflops": round(costs["gemm_flops"] / 1e9, 3),
            "kernel_gflops": {k: round(v / 1e9, 6) for k, v in costs["kernel_flops"].items()},
            "achieved_tflops_per_s": round(tflops, 4),
            "mfu_pct_vs_f32_peak": round(100.0 * tflops * 1e12 / FP32_FLOP_PER_S, 4),
            "bytes_accessed": costs["bytes accessed"]}


def main(argv=None) -> dict:
    from .. import resolve_device
    from ..utils.profiling import trace

    args = parse_args(argv)
    dev = resolve_device(args.device)
    dataset, net, t_build, t_init = build_bench_net(args, dev)
    print(f"[bench] build {t_build:.1f}s init {t_init:.1f}s", flush=True)

    ratio = {"sdfRatio": 1.0, "deformerRatio": 0.5, "renderRatio": 1.0}
    gen = torch.Generator(device=dev).manual_seed(args.seed)
    fids = list(range(args.batch))
    batch = dataset.get_batch(fids)
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)

    loss, info, first_step, first_ms = timed_step(net, batch, fids, ratio, gen)
    print(f"[bench] first step {first_step:.2f}s (remesh {first_ms['remesh'] / 1e3:.2f}s) "
          f"loss={loss:.4f}", flush=True)

    warm, phases = [], []
    with trace(args.profile) if args.profile else contextlib.nullcontext():
        for s in range(args.steps):
            loss, info, dt, ms = timed_step(net, batch, fids, ratio, gen)
            warm.append(dt)
            phases.append(ms)
            print(f"[bench] warm step {s}: {dt:.3f}s phases_ms "
                  f"{ {k: round(v, 2) for k, v in ms.items()} } loss={loss:.4f}", flush=True)
    sec_per_step = float(np.mean(warm))
    phase_ms = {k: float(np.mean([p[k] for p in phases])) for k in phases[0]}

    t0 = time.time()
    net.marching_cube_update(ratio)
    sync(dev)
    remesh_warm_s = time.time() - t0
    print(f"[bench] warm remesh {remesh_warm_s:.2f}s, garment verts {net.mesh.garment_n} in "
          f"buffers of {[v.shape[0] for v in net.mesh.garment_vs]}", flush=True)
    cost = step_cost(net, lambda: net.train_step(batch, fids, ratio, generator=gen),
                     sec_per_step)
    peak = torch.cuda.max_memory_allocated(dev) / 2 ** 30 if dev.type == "cuda" else None

    sustained = None
    if args.sustain:
        net.cfg.remesh_intersect = 8
        net.opt_times, net._remeshed_at, net.mesh = 0.0, -1.0, None    # remesh at 0, 8, 16, ...
        times, losses, remeshed = [], [], []
        for s in range(args.sustain):
            loss, info, dt, _ = timed_step(net, batch, fids, ratio, gen)
            times.append(round(dt, 4))
            losses.append(loss)
            remeshed.append(bool(info["remeshed"]))
            print(f"[bench] sustain {s}: {dt:.3f}s remeshed {remeshed[-1]} loss={loss:.4f}",
                  flush=True)
        net.cfg.remesh_intersect = 120
        plain = [t for t, r in zip(times, remeshed) if not r]
        sustained = {"steps": args.sustain, "remeshes": sum(remeshed), "per_step_s": times,
                     "all_finite": bool(np.isfinite(losses).all()),
                     "mean_nonremesh_s": round(float(np.mean(plain)), 4) if plain else None}

    out = {
        "config": {"image": args.image, "sample_pix": args.sample_pix, "batch": args.batch,
                   "pyramid": list(net.seg3d_cfg.resolutions[-1]), "quality": args.quality,
                   "steps": args.steps},
        **device_record(dev),
        "first_step_s": round(first_step, 4),
        "sec_per_step": round(sec_per_step, 4),
        "sec_per_step_amortized": round(sec_per_step + remesh_warm_s / net.cfg.remesh_intersect,
                                        4),
        "remesh_first_s": round(first_ms["remesh"] / 1e3, 4),
        "remesh_warm_s": round(remesh_warm_s, 4),
        "phase_means_ms": {k: round(v, 3) for k, v in phase_ms.items()},
        "phase_means_s": {k: round(v / 1e3, 6) for k, v in phase_ms.items()},
        "rays_per_step": args.sample_pix,
        "rays_converged_last_step": int(sum(info[f"{g}_rayConv"]
                                            for g in net.statics.garment_names)),
        "garment_verts": list(net.mesh.garment_n) if net.mesh is not None else None,
        "peak_memory_gib": None if peak is None else round(peak, 3),
        "step_cost": cost,
        "sustained": sustained,
        "t_build_s": round(t_build, 2), "t_init_s": round(t_init, 2),
    }
    return write_record(args.out, out)


if __name__ == "__main__":
    main()
