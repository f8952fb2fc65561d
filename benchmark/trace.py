"""The profiled tail of a traced run: a few training steps under
``torch.profiler`` (host and device activities), one profiler range per
phase opened and closed from ``train_step``'s ``timer`` hook. Read from
the profiler's own events, with no Chrome trace written: the device's
busy time (the union of the intervals of its kernels, copies and sets),
its kernels by name, the kernel launches (device kernels) and the host's
synchronizations (stream, device and event synchronizations and blocking
copies), the idle gaps of the device by the phase the host was in at
their middle (the device's clock set against the host's by the least
delay from a launch to its work), and the device time of K1, K2 and
K3."""

from __future__ import annotations

import time

import torch

SYNC = ("cudaStreamSynchronize", "cudaDeviceSynchronize", "cudaEventSynchronize", "cudaMemcpy",
        "cuStreamSynchronize", "cuCtxSynchronize", "cuEventSynchronize", "cuMemcpyDtoH_v2")
KERNELS = {"K1": "mesh_tiles_kernel", "K2": "composite_fwd_kernel",
           "K3": "composite_bwd_kernel"}


class PhaseRanges:
    """A ``timer`` hook that keeps one profiler range open per phase: the
    range named ``phase:<p>`` covers phase p, from the previous phase's
    mark to p's."""

    def __init__(self, phases):
        self.phases = tuple(phases)
        self.cur = None

    def start(self):
        """Open the first phase's range."""
        self._open(self.phases[0])

    def _open(self, name):
        self.cur = torch.autograd.profiler.record_function(f"phase:{name}")
        self.cur.__enter__()

    def mark(self, name: str):
        """Close phase ``name``'s range and open the next phase's."""
        self.close()
        i = self.phases.index(name) + 1
        if i < len(self.phases):
            self._open(self.phases[i])

    def close(self):
        if self.cur is not None:
            self.cur.__exit__(None, None, None)
            self.cur = None


def _device_kind(e) -> str | None:
    """"kernel", "copy" or None (not device work) for a device event: by
    its activity type where the profiler gives one, else by its name
    (copies and sets are named "Memcpy ..." and "Memset ...", and the
    device's copies of the host's ranges "phase:...")."""
    kind = getattr(e, "activity_type", None)
    try:
        kind = kind() if callable(kind) else kind
    except RuntimeError:
        kind = None
    kind = str(kind or "").lower().rsplit(".", 1)[-1]
    name = e.name()
    if kind:
        return ("kernel" if kind == "kernel" else "copy" if kind in ("gpu_memcpy", "gpu_memset")
                else None)
    if name.startswith("phase:") or name.startswith("ProfilerStep"):
        return None
    return "copy" if name.startswith(("Memcpy", "Memset")) else "kernel"


def profile_steps(step, n_steps: int, phases) -> dict:
    """Run ``step(ranges)`` ``n_steps`` times under the profiler; ``step``
    opens the range "batch" of its input (``ranges.start()``), marks it,
    and passes ``ranges.mark`` as the step's timer. Returns the tail's
    readings (see the module)."""
    from torch.profiler import ProfilerActivity, profile

    ranges = PhaseRanges(("batch",) + tuple(phases))
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(n_steps):
            step(ranges)
            ranges.close()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    return read_events(prof.profiler.kineto_results.events(), n_steps, wall)


def read_events(events, n_steps: int, wall_s: float) -> dict:
    work, spans, launched, syncs = [], [], {}, 0
    for e in events:
        name = e.name()
        if e.device_type() == torch.autograd.DeviceType.CUDA:
            kind = _device_kind(e)
            if kind is not None:
                work.append((e.start_ns(), e.start_ns() + e.duration_ns(), name,
                             kind == "kernel", e.correlation_id()))
        elif name.startswith("phase:"):
            spans.append((e.start_ns(), e.start_ns() + e.duration_ns(), name[len("phase:"):]))
        else:
            if name.startswith("cu") and e.correlation_id():
                launched[e.correlation_id()] = e.start_ns()
            syncs += name in SYNC
    work.sort()
    spans.sort()
    # the device's clock against the host's: no work starts before its
    # launch, so the least (start − launch) is the offset plus the
    # shortest launch latency
    lags = [t0 - launched[c] for t0, _, _, _, c in work if c in launched]
    offset = min(lags) if lags else 0

    def phase_at(t_host):
        return next((p for a, b, p in spans if a <= t_host < b), "between steps")

    busy, end, gaps = 0, None, {}
    by_name, kernel_ns, kernel_n = {}, {k: 0 for k in KERNELS}, {k: 0 for k in KERNELS}
    launches = 0
    for t0, t1, name, is_kernel, _ in work:
        if end is not None and t0 > end:       # an idle gap, by the host's phase at its middle
            label = phase_at((end + t0) // 2 - offset)
            gaps[label] = gaps.get(label, 0) + (t0 - end)
        busy += max(0, t1 - max(t0, end if end is not None else t0))
        end = t1 if end is None else max(end, t1)
        by_name[name] = by_name.get(name, 0) + (t1 - t0)
        if is_kernel:
            launches += 1
            for k, kname in KERNELS.items():
                if kname in name:
                    kernel_ns[k] += t1 - t0
                    kernel_n[k] += 1
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:10]
    return {"steps": n_steps, "wall_s": wall_s, "busy_s": busy / 1e9, "launches": launches,
            "syncs": syncs, "kernel_s": {k: v / 1e9 for k, v in kernel_ns.items()},
            "kernel_counts": kernel_n, "clock_offset_ns": offset, "matched": len(lags),
            "device_ops": [[n[:120], ns / 1e9] for n, ns in top],
            "idle_gaps": [[p, ns / 1e9] for p, ns in
                          sorted(gaps.items(), key=lambda kv: -kv[1])[:10]]}
