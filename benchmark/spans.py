#!/usr/bin/env python3
"""The port's own spans and counters (``recmv_tpu_torch/utils/profiling.py``)
read in the profiler's timeline: where inside each phase of the step the
launches, the syncs, the device's work and its idle gaps fall.

- ``span_pass``: more steps under the profiler with the port's tracing on
  and the phases' ranges (``trace.PhaseRanges``) as the step's timer.
  ``read_spans`` puts each kernel launch, each sync (``trace.SYNC``) and
  each interval of device work down to the innermost program span open
  at its launch, the phase where no program span is open, and each idle
  gap of the device down to the span that launched the work that ends
  the gap: by correlation id, with no clock offset. The port's counters
  are read over the same steps.
- ``sync_pass``: one step with the port's sync recorder on
  (``enable(syncs=True)``): the host's synchronizations by the innermost
  program span and the innermost line of the port.

Both leave the port's tracing off when they return, and both give None
for a port without spans. ``passes`` runs both and returns them under
"spans" and "syncs_by_line", the record that ``metrics/solve_*.py`` read.

    python3 benchmark/spans.py --workload <cell> --seed <n>

from the root of a checkout, on the card: the cell's set-up as
``run.py`` makes it, the benchmark's ``run_seconds`` of steps (so that
the passes read the state that a traced run's profiled tail reads), then
both passes. Prints ``[bench] spans:`` and ``[bench] syncs by line:`` on
standard error and, last on standard output, the four ``solve_*``
metrics' values and the card's name.
"""

from __future__ import annotations

import argparse
import importlib
import json
import os.path as osp
import re
import sys
import time
from collections import defaultdict

HERE = osp.dirname(osp.abspath(__file__))
ROOT = osp.dirname(HERE)
SPAN = re.compile(r"^[a-z]+/[a-z_]+$")      # the port's span names: "<phase>/<part>"
OUTSIDE = "between steps"
UNMATCHED = "no launch seen"
METRICS = ("solve_evals", "solve_live_pct", "solve_launches_per_eval", "solve_syncs_per_eval")


def _tracing(pkg: str):
    """The package's ``utils.profiling``, or None where it has no spans."""
    try:
        mod = importlib.import_module(f"{pkg}.utils.profiling")
    except ModuleNotFoundError:
        return None
    return mod if hasattr(mod, "span") and hasattr(mod, "counters") else None


def _innermost(intervals: list, times: list) -> tuple:
    """(the label of the innermost interval open at each of ``times``, or
    None; {label: ns during which it was the innermost open}) of
    ``intervals`` [(start, end, label)], which nest."""
    ivs = sorted(intervals, key=lambda iv: (iv[0], -iv[1]))     # the outer first
    marks = [(a, 0, i) for i, (a, _, _) in enumerate(ivs)]
    marks += [(b, 2, i) for i, (_, b, _) in enumerate(ivs)]
    marks += [(t, 1, j) for j, t in enumerate(times)]
    marks.sort()
    stack, labels, own, last = [], [None] * len(times), defaultdict(int), None
    for t, kind, i in marks:
        if stack:
            own[ivs[stack[-1]][2]] += t - last
        last = t
        if kind == 0:
            stack.append(i)
        elif kind == 2:
            stack.remove(i)
        elif stack:
            labels[i] = ivs[stack[-1]][2]
    return labels, own


def read_spans(events, n_steps: int) -> dict:
    """Per label (a program span, a phase where none is open, or "between
    steps"), each per step: host ms during which it was the innermost open
    (``host_ms``), the kernels it launched (``launches``), the host's
    syncs in it (``syncs``), the device's busy ms of the work it launched
    (``busy_ms``) and the device's idle ms before that work
    (``idle_ms``); ``total``: the same summed, the device work whose
    launch the profiler did not see (``unmatched``, put down to "no
    launch seen") and the device timeline's copies of the spans that
    ``trace.read_events`` takes for kernels where the profiler gives no
    activity type (``span_copies``). Launches, syncs and busy time are
    otherwise counted as ``trace.read_events`` counts them."""
    import torch

    from .trace import SYNC, _device_kind

    intervals, launched, sync_t, work, copies = [], {}, [], [], 0
    for e in events:
        name = e.name()
        if e.device_type() == torch.autograd.DeviceType.CUDA:
            kind = _device_kind(e)
            if SPAN.match(name):                # the device timeline's copy of a span
                copies += kind == "kernel"
            elif kind is not None:
                work.append((e.start_ns(), e.start_ns() + e.duration_ns(), kind == "kernel",
                             e.correlation_id()))
        elif name.startswith("phase:"):
            intervals.append((e.start_ns(), e.start_ns() + e.duration_ns(), name[len("phase:"):]))
        elif SPAN.match(name):
            intervals.append((e.start_ns(), e.start_ns() + e.duration_ns(), name))
        else:
            if name.startswith("cu") and e.correlation_id():
                launched[e.correlation_id()] = e.start_ns()
            if name in SYNC:
                sync_t.append(e.start_ns())
    work.sort()
    corrs = list(launched)
    at_launch, own = _innermost(intervals, [launched[c] for c in corrs])
    label_of = {c: lab or OUTSIDE for c, lab in zip(corrs, at_launch)}
    rows = defaultdict(lambda: dict.fromkeys(("host_ms", "launches", "syncs", "busy_ms",
                                              "idle_ms"), 0.0))
    for lab, ns in own.items():
        rows[lab]["host_ms"] += ns / 1e6
    for lab in _innermost(intervals, sync_t)[0]:
        rows[lab or OUTSIDE]["syncs"] += 1
    end, unmatched = None, 0
    for t0, t1, is_kernel, corr in work:
        lab = label_of.get(corr)
        if lab is None:
            lab, unmatched = UNMATCHED, unmatched + 1
        r = rows[lab]
        if end is not None and t0 > end:
            r["idle_ms"] += (t0 - end) / 1e6
        r["busy_ms"] += max(0, t1 - max(t0, end if end is not None else t0)) / 1e6
        end = t1 if end is None else max(end, t1)
        r["launches"] += is_kernel
    total = {k: sum(r[k] for r in rows.values()) / n_steps
             for k in ("launches", "syncs", "busy_ms", "idle_ms")}
    total["unmatched"] = unmatched / n_steps
    total["span_copies"] = copies / n_steps
    by_span = {lab: {k: v / n_steps for k, v in r.items()}
               for lab, r in sorted(rows.items(),
                                    key=lambda kv: -(kv[1]["busy_ms"] + kv[1]["idle_ms"]
                                                     + kv[1]["host_ms"]))}
    return {"steps": n_steps, "by_span": by_span, "total": total}


def _step(net, ds, order, ratio, gen, step_fn, timer=None):
    """One step of the window's loop; ``timer`` (``trace.PhaseRanges``)
    opens a range over the input and over each phase of the step."""
    fids = next(order)
    if timer:
        timer.start()
    batch = ds.get_batch(fids)
    if timer:
        timer.mark("batch")
    step_fn(net, batch, fids, ratio, gen, timer.mark if timer else None)
    if timer:
        timer.close()


def _sync(device) -> None:
    import torch

    if device.type == "cuda":
        torch.cuda.synchronize(device)


def span_pass(net, ds, order, ratio, gen, step_fn, n_steps: int, device,
              pkg: str = "recmv_tpu_torch"):
    """``n_steps`` steps under the profiler with the port's tracing on →
    ``read_spans``' record, the port's counters over the same steps
    (``counters``) and the profiler's wall time (``wall_s``); None for a
    port without spans. Raises where the launches (with the spans'
    copies) or syncs put down to labels differ from
    ``trace.read_events``' totals of the same events."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from . import drive, trace

    tracing = _tracing(pkg)
    if tracing is None:
        return None
    acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if device.type == "cuda" else [])
    ranges = trace.PhaseRanges(("batch",) + drive.PHASES)
    tracing.enable()
    try:
        with profile(activities=acts) as prof:
            _sync(device)
            t0 = time.perf_counter()
            for _ in range(n_steps):
                _step(net, ds, order, ratio, gen, step_fn, ranges)
            _sync(device)
            wall = time.perf_counter() - t0
    finally:
        tracing.disable()
    counters = tracing.counters()
    events = prof.profiler.kineto_results.events()
    out = read_spans(events, n_steps)
    whole = trace.read_events(events, n_steps, wall)
    t = {k: round(v * n_steps) for k, v in out["total"].items()}
    if (t["launches"] + t["span_copies"], t["syncs"]) != (whole["launches"], whole["syncs"]):
        raise RuntimeError(f"the span pass put {t['launches']} launches (and {t['span_copies']} "
                           f"copies of spans) and {t['syncs']} syncs down to labels, the "
                           f"profiler saw {whole['launches']} and {whole['syncs']}")
    out.update(counters=counters, wall_s=wall)
    return out


def sync_pass(net, ds, order, ratio, gen, step_fn, device, top: int = 20,
              pkg: str = "recmv_tpu_torch"):
    """One step with the port's sync recorder on → [[span:file:line, syncs]]
    of its ``top`` most ("-" for no open span); None for a port without
    spans."""
    tracing = _tracing(pkg)
    if tracing is None:
        return None
    tracing.enable(syncs=True)
    try:
        _step(net, ds, order, ratio, gen, step_fn)
        _sync(device)
    finally:
        tracing.disable()
    syncs = [(k[len("sync:"):], v) for k, v in tracing.counters().items()
             if k.startswith("sync:")]
    return [[k, v] for k, v in sorted(syncs, key=lambda kv: (-kv[1], kv[0]))[:top]]


def passes(net, ds, order, ratio, gen, step_fn, n_steps: int, device) -> dict:
    """Both passes: {"spans": ``span_pass``, "syncs_by_line": ``sync_pass``}."""
    return {"spans": span_pass(net, ds, order, ratio, gen, step_fn, n_steps, device),
            "syncs_by_line": sync_pass(net, ds, order, ratio, gen, step_fn, device)}


def metrics(record: dict) -> dict:
    """The ``solve_*`` metrics' values over a record of ``passes``."""
    return {m: importlib.import_module(f"benchmark.metrics.{m}").read(record) for m in METRICS}


def measure(args) -> int:
    """``main``'s run (see the module)."""
    import torch

    from . import run, scene, spec

    run.cache_dirs()
    run.pin_threads()
    cell = spec.load_cell(args.workload)
    if not torch.cuda.is_available():
        sys.stderr.write("[bench] the span pass needs a CUDA device\n")
        return 3
    device = torch.device("cuda:0")
    seed = int(args.seed) % (1 << 63)
    scene_dir = scene.cached(cell["config"], cell["traffic"], device)
    ds, net, order, _, gen, _ = run.setup_program(cell, seed, device, scene_dir,
                                                  run.default_step, {})
    ratio = dict(cell["traffic"]["ratio"])
    t0, warm_steps = time.perf_counter(), 0
    while time.perf_counter() - t0 < cell["run_seconds"]:
        _step(net, ds, order, ratio, gen, run.default_step)
        warm_steps += 1
    _sync(device)
    out = passes(net, ds, order, ratio, gen, run.default_step,
                 cell["traffic"]["profiled_steps"], device)
    found = run.forbidden_modules()
    if found:
        sys.stderr.write(f"[bench] modules of JAX or the JAX package were loaded: {found}\n")
        return 2
    sys.stderr.write(f"[bench] warm steps: {warm_steps}\n")
    sys.stderr.write("[bench] spans: " + json.dumps(out["spans"]) + "\n")
    sys.stderr.write("[bench] syncs by line: " + json.dumps(out["syncs_by_line"]) + "\n")
    print(json.dumps({"workload": args.workload, "seed": args.seed, **metrics(out),
                      "device": torch.cuda.get_device_name(device)}), flush=True)
    return 0


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    args = ap.parse_args(argv)
    sys.path.insert(0, ROOT)
    from benchmark.spans import measure as run

    return run(args)


if __name__ == "__main__":
    sys.exit(main())
