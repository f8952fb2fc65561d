"""Device trace of the port's training step by phase, on one CUDA device.

    python3 chip_profile.py [STEPS]

Builds the tube scene of ``chip_smoke.py`` (its phases 3-5 and 4b: 32
frames at 1080², flagship widths, the scene's curves), runs two training
steps to warm up, then STEPS (default 3) training steps under
torch.profiler, one profiler range per phase of ``train_step``. Prints,
per phase and step: the device time of the kernels, copies and sets
that the phase issued (the trace's device events, each counted once,
matched to the issuing runtime call by correlation id), the kernel
launches and the host-device synchronizations (stream, device and event
synchronizations) under the phase's host range, and the host time of
that range; the device's busy time (the union of its device intervals)
against the steps' wall time; the ten kernels with the most device time
in the ① phase; then the card's name and power limit. It exits non-zero
without a card.
"""

from __future__ import annotations

import json
import os.path as osp
import sys
import tempfile
import time

import chip_smoke

PHASES = ("remesh", "upload", "fl", "pc", "verts", "rays", "solve", "main", "update")
LAUNCH = ("cudaLaunchKernel", "cuLaunchKernel", "cudaLaunchKernelExC", "cuLaunchKernelEx")
SYNC = ("cudaStreamSynchronize", "cudaDeviceSynchronize", "cudaEventSynchronize")


def walk(e):
    """``e`` and every host event under it."""
    yield e
    for c in e.cpu_children:
        yield from walk(c)


def device_by_phase(trace: list, table: dict) -> tuple:
    """Add each device event of a chrome trace (kernels, copies, sets) to
    ``table[phase]["device_ms"]`` of the phase whose host range holds the
    runtime call that issued it (matched by correlation id) → (busy ms,
    the union of the device intervals; {kernel name: ms} of the ① phase;
    device events; device events outside the phases)."""
    spans = [(e["ts"], e["ts"] + e["dur"], e["name"][len("phase:"):]) for e in trace
             if e.get("cat") == "user_annotation" and e.get("name", "").startswith("phase:")]
    issued = {e["args"]["correlation"]: e["ts"] for e in trace
              if e.get("cat") in ("cuda_runtime", "cuda_driver")
              and "correlation" in e.get("args", {})}
    work = sorted((e["ts"], e["ts"] + e.get("dur", 0), e.get("name", ""),
                   e.get("args", {}).get("correlation")) for e in trace
                  if e.get("cat") in ("kernel", "gpu_memcpy", "gpu_memset"))
    fl_kernels, unmatched = {}, 0
    busy, end = 0.0, float("-inf")
    for t0, t1, name, corr in work:
        busy += max(0.0, t1 - max(t0, end))
        end = max(end, t1)
        t = issued.get(corr)
        phase = next((p for a, b, p in spans if t is not None and a <= t < b), None)
        if phase is None:
            unmatched += 1
            continue
        table[phase]["device_ms"] += (t1 - t0) / 1e3
        if phase == "fl":
            fl_kernels[name[:60]] = fl_kernels.get(name[:60], 0.0) + (t1 - t0) / 1e3
    return busy / 1e3, fl_kernels, len(work), unmatched


def main() -> int:
    import torch
    from torch.profiler import ProfilerActivity, profile, record_function

    if not torch.cuda.is_available():
        print("chip_profile: no CUDA device", file=sys.stderr)
        return 2
    steps = int(sys.argv[1]) if len(sys.argv) > 1 else 3
    dev = torch.device("cuda:0")
    card = chip_smoke.card_line()
    ds, sampler, net = chip_smoke.build_smoke_net(dev, tempfile.mkdtemp(prefix="recmv_prof_"))
    batches = []
    while len(batches) < 2 + steps:
        batches.extend(list(sampler))
    gen = torch.Generator(device=dev).manual_seed(0)
    for fids in batches[:2]:
        net.train_step(ds.get_batch(fids), fids, chip_smoke.RATIO, generator=gen)
    torch.cuda.synchronize()

    walls = []
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for fids in batches[2:2 + steps]:
            batch = ds.get_batch(fids)
            ranges = iter(PHASES)
            current = [record_function(f"phase:{next(ranges)}")]
            current[0].__enter__()

            def mark(name):
                current[0].__exit__(None, None, None)
                nxt = next(ranges, None)
                if nxt is not None:
                    current[0] = record_function(f"phase:{nxt}")
                    current[0].__enter__()

            t0 = time.time()
            net.train_step(batch, fids, chip_smoke.RATIO, generator=gen, timer=mark)
            torch.cuda.synchronize()
            walls.append(time.time() - t0)

    table = {p: dict(device_ms=0.0, launches=0, syncs=0, host_ms=0.0) for p in PHASES}
    for e in prof.events():
        if not e.name.startswith("phase:"):
            continue
        row = table[e.name[len("phase:"):]]
        row["host_ms"] += (e.time_range.end - e.time_range.start) / 1e3
        for c in walk(e):
            row["launches"] += c.name in LAUNCH
            row["syncs"] += c.name in SYNC
    # device time from the trace's own device events (kernels, copies,
    # sets), each counted once, in the phase whose host range holds the
    # runtime call that issued it (matched by correlation id)
    path = osp.join(tempfile.mkdtemp(prefix="recmv_prof_trace_"), "trace.json")
    prof.export_chrome_trace(path)
    with open(path) as f:
        trace = json.load(f)["traceEvents"]
    busy, fl_kernels, n_events, unmatched = device_by_phase(trace, table)
    wall_ms = 1e3 * sum(walls)
    for p in PHASES:
        r = table[p]
        chip_smoke.log(f"[profile] {p}: " + json.dumps(
            {k: round(v / steps, 3) for k, v in r.items()}))
    chip_smoke.log(f"[profile] {steps} steps: wall per step {wall_ms / steps:.1f} ms, device busy "
                   f"{busy / steps:.1f} ms ({busy / wall_ms:.3f} of the wall), launches per step "
                   f"{sum(r['launches'] for r in table.values()) / steps:.0f}, host syncs per "
                   f"step {sum(r['syncs'] for r in table.values()) / steps:.0f}; device events "
                   f"{n_events}, outside the phases {unmatched}")
    top = sorted(fl_kernels.items(), key=lambda kv: -kv[1])[:10]
    chip_smoke.log("[profile] ① phase, kernels by device time per step (ms): " + json.dumps(
        {k: round(v / steps, 3) for k, v in top}))
    print(card)
    return 0


if __name__ == "__main__":
    sys.exit(main())
