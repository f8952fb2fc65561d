#!/usr/bin/env python3
"""Run one cell of the port's benchmark once on the CUDA card.

    python3 benchmark/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

From the root of a checkout. Set-up: a check that the port's tables
give the configuration's garment set (``drive.check_garment_set``), the
cell's scene (the frozen generator or the configuration's scene module,
``scene.py``; made under ``TMPDIR`` by the first run there),
the port's network (``build_opt_net``) with the weights drawn from the
seed (``weights.py``), and the first ``check_steps`` training steps,
which warm every shape and are read for the comparison. Then the window: for
``--seconds``, the loop users run (``recmv_tpu_torch/train.py``): the next
frames of a shuffled order drawn from the seed, ``dataset.get_batch``,
``train_step``. ``step_s`` is the window over the steps completed in it;
``setup_s`` the process's age at the window's start. ``--trace 1`` times
each step's phases by CUDA events, then profiles a few more steps
(``trace.py``) and reports the per-layer metrics (``metrics/``) in place
of the end-to-end ones. After the window, with the port's state freed,
the reference (``reference/recmv``, the frozen plain copy) runs the first
steps again from the same inputs, weights and draws, and ``check.py``
decides ``correct``. The last line of standard output is the result.
The host computes on one thread (``THREADS``).

Exits 3 without a CUDA card (or with fewer than the cell asks for), and
2 when a module of JAX or of the JAX package was loaded.
"""

from __future__ import annotations

import argparse
import gc
import importlib
import json
import math
import os
import os.path as osp
import sys
import time
import traceback

HERE = osp.dirname(osp.abspath(__file__))
ROOT = osp.dirname(HERE)
PORT = "recmv_tpu_torch"
FORBIDDEN = ("jax", "jaxlib", "flax", "recmv_tpu")
# the host's compute threads: one, so that no pool spins beside the thread that launches
THREADS = 1
THREAD_ENV = ("OMP_NUM_THREADS", "MKL_NUM_THREADS", "OPENBLAS_NUM_THREADS")


def process_age() -> float:
    """Seconds since this process started (``/proc/self/stat``)."""
    with open("/proc/self/stat") as f:
        start_ticks = int(f.read().rsplit(")", 1)[1].split()[19])
    with open("/proc/uptime") as f:
        uptime = float(f.read().split()[0])
    return uptime - start_ticks / os.sysconf("SC_CLK_TCK")


def forbidden_modules() -> list:
    """Loaded modules whose top-level name, compared whole, is JAX's or the
    JAX package's."""
    return sorted({m.split(".")[0] for m in list(sys.modules)} & set(FORBIDDEN))


def cache_dirs() -> None:
    """The program's build and kernel caches at fixed paths in the checkout
    (its own ``recmv_tpu_torch/_build/`` already is)."""
    cache = osp.join(HERE, "_cache")
    os.environ["TORCH_EXTENSIONS_DIR"] = osp.join(cache, "torch_extensions")
    os.environ["TRITON_CACHE_DIR"] = osp.join(cache, "triton")
    os.environ["USE_FLAX"] = "0"


def pin_threads() -> None:
    """Fix the host's compute threads at ``THREADS``: in the environment,
    for the libraries that read it when they load, and in torch."""
    for k in THREAD_ENV:
        os.environ[k] = str(THREADS)
    import torch

    torch.set_num_threads(THREADS)


class PhaseClock:
    """Per-phase ms of one step from ``train_step``'s timer hook: a CUDA
    event at each mark on the card, the host clock elsewhere."""

    def __init__(self, device):
        import torch

        self.cuda = device.type == "cuda"
        self._torch = torch
        self.marks = [("start", self._now())]

    def _now(self):
        if self.cuda:
            e = self._torch.cuda.Event(enable_timing=True)
            e.record()
            return e
        return time.perf_counter()

    def mark(self, name: str) -> None:
        self.marks.append((name, self._now()))

    def read(self) -> dict:
        out = {}
        for (_, a), (name, b) in zip(self.marks, self.marks[1:]):
            out[name] = out.get(name, 0.0) + (a.elapsed_time(b) if self.cuda
                                              else (b - a) * 1e3)
        return out


def default_step(net, batch, fids, ratio, generator, timer):
    return net.train_step(batch, fids, ratio, generator=generator, timer=timer)


def run_cell(spec: dict, seed: int, seconds: float, trace: bool, device,
             step_fn=None) -> dict:
    """One run of a cell (``spec.load_cell``) on ``device``. ``step_fn(net,
    batch, fids, ratio, generator, timer)`` runs one of the port's steps
    (default ``train_step``; the tests plant faults here). Returns the
    result line's object and, under "_record" and "_readings", the run's
    record and the compared readings."""
    import torch

    from . import check, drive, flops, scene

    drive.check_garment_set(PORT, spec["config"])      # before the scene: fails in seconds
    cuda = device.type == "cuda"
    step_fn = step_fn or default_step
    seed = int(seed) % (1 << 63)
    rec = {}
    t = time.perf_counter()
    scene_dir = scene.cached(spec["config"], spec["traffic"], device)
    _sync(device)
    rec["scene_s"] = time.perf_counter() - t
    ds, net, order, check_batches, gen, prog = setup_program(spec, seed, device, scene_dir,
                                                             step_fn, rec)
    ratio = dict(spec["traffic"]["ratio"])
    peak_setup = torch.cuda.max_memory_allocated(device) if cuda else 0
    if cuda:
        torch.cuda.reset_peak_memory_stats(device)
    setup_s = process_age()

    attempted = failed = 0
    phase_ms, batch_ms, remeshed, errors, walls = [], [], [], [], []
    t0 = time.perf_counter()
    while True:
        ts = time.perf_counter()
        fids = next(order)
        tb = time.perf_counter()
        batch = ds.get_batch(fids)
        batch_ms.append((time.perf_counter() - tb) * 1e3)
        clock = PhaseClock(device) if trace else None
        attempted += 1
        try:
            loss, info = step_fn(net, batch, fids, ratio, gen, clock.mark if clock else None)
            if not math.isfinite(float(loss)):
                failed += 1
            remeshed.append(bool(info.get("remeshed", 0.0)))
            if clock:
                phase_ms.append(clock.read())
        except Exception:                      # a step that raises counts as failed
            failed += 1
            errors.append(traceback.format_exc())
        walls.append(time.perf_counter() - ts)
        if time.perf_counter() - t0 >= seconds:
            break
    _sync(device)
    window_s = time.perf_counter() - t0
    rec.update(steps=attempted, window_s=window_s, phase_ms=phase_ms, batch_ms=batch_ms,
               remeshed=remeshed, step_walls=walls)
    rec["peak_window_bytes"] = torch.cuda.max_memory_allocated(device) if cuda else 0
    for e in errors[:1]:
        sys.stderr.write(f"[bench] a step raised ({len(errors)} in all):\n{e}")

    out = {}
    if trace:
        rec["flops_per_step"] = flops.step_flops(spec["config"], spec["traffic"],
                                                 prog["mesh"]["verts"])
        rec["profile"] = profile_tail(net, ds, order, ratio, gen, step_fn,
                                      spec["traffic"]["profiled_steps"]) if cuda else None
    peak = max(peak_setup, rec["peak_window_bytes"])
    found = forbidden_modules()
    if found:
        sys.stderr.write(f"[bench] modules of JAX or the JAX package were loaded: {found}\n")
        raise SystemExit(2)

    del net, ds, gen
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()
    t = time.perf_counter()
    ref = reference_record(spec, seed, device, scene_dir, check_batches)
    rec["reference_s"] = time.perf_counter() - t
    values = check.readings(prog, ref)
    rec["not_compared"] = {k: v for k, v in values.items() if k not in check.load_limits(
        spec["cell"]["name"])}
    correct, rows = check.verdict(values, check.load_limits(spec["cell"]["name"]))
    out["correct"] = bool(correct and failed == 0)
    out["attempted"] = attempted
    out["failed"] = failed
    if trace:
        out["metrics"] = per_layer(spec, rec)
    else:
        out["metrics"] = {"step_s": {"value": window_s / attempted, "unit": "s/step"},
                          "setup_s": {"value": setup_s, "unit": "s"}}
    out["device"] = device_record(device, peak, rec.get("profile"))
    if trace and rec.get("profile"):
        out["breakdown"] = {k: rec["profile"][k] for k in ("device_ops", "idle_gaps")}
    out["check"] = {r["name"]: {"value": r["value"], "limit": r["limit"]} for r in rows}
    out["_record"] = rec
    out["_readings"] = {"program": prog, "reference": ref}
    return out


def setup_program(spec: dict, seed: int, device, scene_dir: str, step_fn, rec: dict) -> tuple:
    """The port's network for the cell with the seed's weights, the order of
    frames, and its first ``check_steps`` steps (which warm every shape)
    read for the comparison → (dataset, network, order, the checked
    batches, the generator of the draws, the readings)."""
    import torch

    from . import drive
    from .weights import make_weights

    config, traffic = spec["config"], spec["traffic"]
    weights = make_weights(config, seed, device)
    ds, net = drive.build(PORT, config, traffic, scene_dir, osp.join(scene_dir, "port_result"),
                          weights, device, rec)
    del weights
    order = drive.frame_batches(seed, traffic["frames"], traffic["batch"])
    check_batches = [next(order) for _ in range(traffic["check_steps"])]
    gen = torch.Generator(device=device).manual_seed(seed)
    t = time.perf_counter()
    prog = drive.check_steps(net, ds, check_batches, dict(traffic["ratio"]), gen, step_fn)
    _sync(device)
    rec["check_steps_s"] = time.perf_counter() - t
    return ds, net, order, check_batches, gen, prog


def reference_record(spec: dict, seed: int, device, scene_dir: str, check_batches: list,
                     step_fn=None, tf32: bool = False) -> dict:
    """The reference's readings of the same first steps: the frozen copy's
    network from the same scene, weights, frames and draws, its kernels'
    plain versions. ``tf32`` computes it with TF32 matmuls (the control)."""
    import torch

    from . import drive
    from .weights import make_weights

    config, traffic = spec["config"], spec["traffic"]
    weights = make_weights(config, seed, device)
    ds, net = drive.build(drive.REF, config, traffic, scene_dir,
                          osp.join(scene_dir, "reference_result"), weights, device)
    del weights
    torch.backends.cuda.matmul.allow_tf32 = tf32
    torch.backends.cudnn.allow_tf32 = tf32
    try:
        out = drive.check_steps(net, ds, check_batches, dict(traffic["ratio"]),
                                torch.Generator(device=device).manual_seed(seed), step_fn)
    finally:
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
    _sync(device)
    del net, ds
    gc.collect()
    return out


def _sync(device) -> None:
    import torch

    if device.type == "cuda":
        torch.cuda.synchronize(device)


def profile_tail(net, ds, order, ratio, gen, step_fn, n_steps: int) -> dict:
    """A few more steps under the profiler (``trace.py``), with the problem of
    every K1–K3 launch recorded (``kernel_work.LaunchLog``). Raises where the
    launches that the profiler saw and the problems recorded differ in
    number, so that ``kernel_roofline_pct`` never drops out unseen."""
    from . import drive, trace
    from .kernel_work import LaunchLog

    rast = importlib.import_module(f"{PORT}.ops.rasterizer")

    def step(ranges):
        fids = next(order)
        ranges.start()
        batch = ds.get_batch(fids)
        ranges.mark("batch")
        step_fn(net, batch, fids, ratio, gen, ranges.mark)

    with LaunchLog(rast) as log:
        prof = trace.profile_steps(step, n_steps, drive.PHASES)
    prof["kernel_bound"] = log.bound_s()
    seen = {k: prof["kernel_counts"][k] for k in prof["kernel_bound"]}
    logged = {k: n for k, (n, _) in prof["kernel_bound"].items()}
    if seen != logged:
        raise RuntimeError(
            f"kernel_roofline_pct: the profiler saw K1-K3 launches {seen}, the wrapped binning "
            f"prologues of {PORT}.ops.rasterizer recorded {logged}; the kernels' problems can "
            "no longer be read where kernel_work.LaunchLog reads them")
    return prof


def per_layer(spec: dict, rec: dict) -> dict:
    """The cell's per-layer metrics that their readers find."""
    out = {}
    for m in spec["per_layer"]:
        value = importlib.import_module(f"benchmark.metrics.{m['name']}").read(rec)
        if value is not None:
            out[m["name"]] = {"value": value, "unit": m["unit"]}
    return out


def device_record(device, peak: int, profile) -> dict:
    import torch

    if device.type != "cuda":
        return {"platform": "cpu", "kind": "cpu", "count": 1, "memory_peak_bytes": peak}
    out = {"platform": "gpu", "kind": torch.cuda.get_device_name(device), "count": 1,
           "memory_peak_bytes": peak}
    if profile:
        out["busy_s"] = profile["busy_s"]
        out["window_s"] = profile["wall_s"]
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    cache_dirs()
    pin_threads()
    sys.path.insert(0, ROOT)
    from benchmark import spec as spec_mod

    cell = spec_mod.load_cell(args.workload)
    import torch

    chips = cell["cell"]["chips"]
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        sys.stderr.write(f"[bench] the cell needs {chips} CUDA device(s); "
                         f"{torch.cuda.device_count() if torch.cuda.is_available() else 0} "
                         "available\n")
        return 3
    from benchmark.run import run_cell as run

    out = run(cell, args.seed, args.seconds, bool(args.trace), torch.device("cuda:0"))
    rec = out.pop("_record")
    out.pop("_readings")
    found = forbidden_modules()
    if found:
        sys.stderr.write(f"[bench] modules of JAX or the JAX package were loaded: {found}\n")
        return 2
    sys.stderr.write("[bench] set-up: " + json.dumps(
        {k: rec[k] for k in ("scene_s", "dataset_s", "build_s", "check_steps_s")})
        + f", reference "
        f"{rec['reference_s']:.3f} s, steps {rec['steps']} in {rec['window_s']:.3f} s\n")
    sys.stderr.write("[bench] step walls (s): " + " ".join(f"{w:.3f}" for w in rec["step_walls"])
                     + "\n")
    if rec.get("profile"):
        sys.stderr.write("[bench] profile: " + json.dumps(
            {k: v for k, v in rec["profile"].items() if k not in ("device_ops", "idle_gaps")})
            + "\n")
    for name, v in rec["not_compared"].items():
        sys.stderr.write(f"reading {name} {v!r} (not compared in this cell)\n")
    for name, c in out["check"].items():
        sys.stderr.write(f"check {name} {c['value']!r} limit {c['limit']!r}\n")
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
