#!/usr/bin/env python3
"""The readings that the limits of ``check.py`` are set from, for one cell
on the card, in one process (one scene, several seeds):

    python3 benchmark/calibrate.py --workload <cell> --seeds 1,2,3 [--control-seeds 1,2,3]

For each of ``--seeds``: the port's first steps as a run makes them
against the reference's (the lower readings). For each of
``--control-seeds``: the reference computed with TF32 matmuls in the
port's place (the control, nearest precision below float32 with TF32
off), and the reference with half its batch left out
(``half_batch_step``), each against the reference. A state
left unchanged reads 1 on ``change_gap`` and needs no run. Each reading
is one JSON line on standard output; not run by the benchmark's runs.
"""

from __future__ import annotations

import argparse
import gc
import json
import os.path as osp
import sys
import time

HERE = osp.dirname(osp.abspath(__file__))
ROOT = osp.dirname(HERE)


def half_batch_step(net, batch, fids, ratio, generator, timer):
    """A step that leaves out half of the batch: it keeps the first ⌈N/2⌉ of
    N frames, or with one frame half of the rays; the losses are means
    over what is left."""
    if len(fids) > 1:
        keep = (len(fids) + 1) // 2
        fids = fids[:keep]
        batch = {k: v[:keep] for k, v in batch.items()}
        return net.train_step(batch, fids, ratio, generator=generator, timer=timer)
    full = net.cfg.sample_pix
    net.cfg.sample_pix = full // 2
    try:
        return net.train_step(batch, fids, ratio, generator=generator, timer=timer)
    finally:
        net.cfg.sample_pix = full


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", default="")
    ap.add_argument("--control-seeds", default="")
    args = ap.parse_args(argv)
    sys.path.insert(0, ROOT)
    import torch

    from benchmark import check, scene, spec
    from benchmark.run import (cache_dirs, default_step, forbidden_modules, pin_threads,
                               reference_record, setup_program)

    cache_dirs()
    pin_threads()
    if not torch.cuda.is_available():
        sys.stderr.write("[calibrate] no CUDA device\n")
        return 3
    cell = spec.load_cell(args.workload)
    device = torch.device("cuda:0")
    seeds = [int(s) for s in args.seeds.split(",") if s]
    controls = [int(s) for s in args.control_seeds.split(",") if s]
    scene_dir = scene.cached(cell["config"], cell["traffic"], device)

    def emit(kind, seed, values, **extra):
        print(json.dumps({"workload": args.workload, "kind": kind, "seed": seed,
                          "readings": values, **extra}), flush=True)

    for seed in sorted(set(seeds) | set(controls)):
        rec = {}
        t = time.perf_counter()
        ds, net, order, batches, gen, prog = setup_program(cell, seed, device,
                                                           scene_dir, default_step, rec)
        del ds, net, gen
        gc.collect()
        torch.cuda.empty_cache()
        ref = reference_record(cell, seed, device, scene_dir, batches)
        if seed in seeds:
            emit("program", seed, check.readings(prog, ref), mesh=prog["mesh"],
                 detail=check.detail(prog, ref), seconds=time.perf_counter() - t)
        if seed in controls:
            tf32 = reference_record(cell, seed, device, scene_dir, batches, tf32=True)
            emit("control_tf32", seed, check.readings(tf32, ref),
                 detail=check.detail(tf32, ref))
            half = reference_record(cell, seed, device, scene_dir, batches,
                                    step_fn=half_batch_step)
            emit("fault_half_batch", seed, check.readings(half, ref),
                 detail=check.detail(half, ref))
    found = forbidden_modules()
    if found:
        sys.stderr.write(f"[calibrate] modules of JAX or the JAX package were loaded: {found}\n")
        return 2
    return 0


if __name__ == "__main__":
    sys.exit(main())
