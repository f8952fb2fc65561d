"""Tracing, phase timers and work counts (counterpart of
``recmv_tpu/utils/profiling.py``): a ``torch.profiler`` trace exported for
Chrome/Perfetto, wall-time phase timers aggregated per name, and named
regions in the trace, with the JAX module's names and ``summary()`` /
``dump()`` layout.

Beside them, the work the three CUDA kernels do on given arguments (the
bytes each must move and the operations its covered or live pairs need),
the least time the card could take for it (``bound``, against the H100's
published peaks), and ``count_flops``, which counts a callable's GEMMs
with ``FlopCounterMode`` and adds the kernels' operations. ``chip_smoke.py``
and the benches (``recmv_tpu_torch/tools/``, ``recmv_tpu_torch/bench.py``)
count the same way through these."""

from __future__ import annotations

import contextlib
import json
import os
import os.path as osp
import time
from collections import defaultdict

import torch

HBM_BYTES_PER_S = 3.35e12      # H100 SXM device memory, published peak
FP32_FLOP_PER_S = 67e12        # H100 SXM float32 outside the tensor cores, published peak


@contextlib.contextmanager
def trace(log_dir: str):
    """Capture a ``torch.profiler`` trace of the block (host activity, and
    the card's where there is one) into ``<log_dir>/trace.json``."""
    os.makedirs(log_dir, exist_ok=True)
    acts = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    with torch.profiler.profile(activities=acts) as prof:
        yield prof
    prof.export_chrome_trace(osp.join(log_dir, "trace.json"))


class PhaseTimers:
    """Accumulates wall time per named phase. With ``sync=True`` a phase
    given a ``result`` ends with ``torch.cuda.synchronize()`` once the
    process has used the card, so the time covers the device's work; on
    the CPU there is nothing to wait for."""

    def __init__(self, sync: bool = False):
        self.sync = sync
        self.totals = defaultdict(float)
        self.counts = defaultdict(int)

    @contextlib.contextmanager
    def phase(self, name: str, result=None):
        t0 = time.perf_counter()
        yield
        if self.sync and result is not None and torch.cuda.is_initialized():
            torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        self.totals[name] += dt
        self.counts[name] += 1

    def summary(self) -> dict:
        return {k: {"total_s": round(v, 4), "count": self.counts[k],
                    "mean_s": round(v / max(self.counts[k], 1), 4)}
                for k, v in sorted(self.totals.items())}

    def dump(self, path: str):
        with open(path, "w") as f:
            json.dump(self.summary(), f, indent=2)


@contextlib.contextmanager
def annotate(name: str):
    """Named region in profiler traces."""
    with torch.profiler.record_function(name):
        yield


# ---------------------------------------------------------------------------
# the kernels' work and bounds
# ---------------------------------------------------------------------------

def bound(nbytes: float, flops: float) -> dict:
    """The least time the card could take: bytes over the memory rate or
    operations over the float32 rate, whichever is larger."""
    tb, to = nbytes / HBM_BYTES_PER_S * 1e3, flops / FP32_FLOP_PER_S * 1e3
    return dict(bound_ms=max(tb, to), bound_by="bytes" if tb >= to else "operations")


def composite_work(args) -> tuple:
    """(Σcnt, live pairs) of composite_tiles' arguments: the candidates the
    kernels read and the (pixel, candidate) pairs with w > 0."""
    from ..ops.composite import _chunks, _weights
    from ..ops.mesh_raster import tile_pixels

    cx, cy, val, _, inv_r2, cnt, Wt, tile = args[:8]
    B, T, cap = cx.shape
    px, py = tile_pixels(T, Wt, tile, cx.device)
    live = 0
    with torch.no_grad():
        for t0, t1 in _chunks(B, T, cap, tile * tile):
            live += int((_weights(cx, cy, val, inv_r2, cnt, px, py, t0, t1)[1] > 0).sum())
    return int(cnt.sum()), live


def mesh_work(args) -> tuple:
    """(Σcnt, covered pairs) of mesh_tiles' arguments: the candidate faces
    the kernel reads and the (pixel, face) pairs inside the face."""
    from ..ops.composite import _chunks
    from ..ops.mesh_raster import tile_pixels

    prm, _, cnt, Wt, tile = args
    B, T, _, cap = prm.shape
    px, py = tile_pixels(T, Wt, tile, prm.device)
    k = torch.arange(cap, device=prm.device)
    covered = 0
    with torch.no_grad():
        for t0, t1 in _chunks(B, T, cap, tile * tile):
            P = prm[:, t0:t1, :, :, None]
            x, y = px[None, t0:t1, None, :], py[None, t0:t1, None, :]
            inside = (k < cnt[:, t0:t1, None])[..., None]
            for e in range(3):
                inside = inside & (P[:, :, 3 * e] * y + P[:, :, 3 * e + 1] * x
                                   + P[:, :, 3 * e + 2] > 0.0)
            covered += int(inside.sum())
    return int(cnt.sum()), covered


def mesh_tiles_cost(args) -> dict:
    """K1 (``mesh_tiles``) on ``args``: bytes, the listed faces' 12
    coefficients and id, the counts, and zbuf, face and 3 barycentrics per
    pixel; operations, 22 per covered pair (3 edge functions, inverse
    depths, reciprocal, barycentrics, compare)."""
    sum_cnt, pairs = mesh_work(args)
    B, T = args[2].shape
    return dict(bytes=4.0 * (13 * sum_cnt + B * T + 5 * B * T * args[4] ** 2),
                flops=22.0 * pairs, sum_cnt=sum_cnt, pairs=pairs)


def composite_tiles_cost(args) -> dict:
    """K2 (``composite_tiles``) on ``args``: bytes, the listed candidates
    (cx, cy, val, feat[C]), the counts and the output; operations,
    15 + 2C per live pair (weight, chain, sums)."""
    sum_cnt, live = composite_work(args)
    (B, T, _), C = args[0].shape, args[3].shape[2]
    return dict(bytes=4.0 * ((3 + C) * sum_cnt + B * T + B * T * C * args[7] ** 2),
                flops=(15.0 + 2 * C) * live, sum_cnt=sum_cnt, pairs=live)


def composite_tiles_bwd_cost(args) -> dict:
    """K3 (``composite_tiles_bwd``) on ``args``: bytes, the listed
    candidates, the counts, the upstream gradient and the outputs (dcx,
    dcy and dfeat over the whole cap); operations per live pair, the
    forward chain (13), then 24 + 7C (+ 2C for dfeat) for the reverse step
    and the sums."""
    sum_cnt, live = composite_work(args)
    (B, T, cap), C, need = args[0].shape, args[3].shape[2], bool(args[9])
    nv = 2 + (C if need else 0)
    return dict(bytes=4.0 * ((3 + C) * sum_cnt + B * T + B * T * C * args[7] ** 2
                             + B * T * cap * nv),
                flops=(37.0 + 7 * C + (2 * C if need else 0)) * live, sum_cnt=sum_cnt,
                pairs=live)


KERNEL_COST = {"mesh_tiles": mesh_tiles_cost, "composite_tiles": composite_tiles_cost,
               "composite_tiles_bwd": composite_tiles_bwd_cost}


@contextlib.contextmanager
def recorded_kernel_calls(calls: list):
    """Append (kernel name, arguments) of every launch of the three kernels
    in the block to ``calls``, in launch order: ``mesh_tiles`` and
    ``composite_tiles`` as the rasterizer calls them, and
    ``composite_tiles_bwd`` (K3) when the gradient reaches a composite's
    output, with the arguments its backward gives K3 (the upstream
    gradient, and whether the features need one)."""
    from ..ops import rasterizer

    saved = rasterizer.mesh_tiles, rasterizer.composite_tiles

    def mesh(*args):
        calls.append(("mesh_tiles", args))
        return saved[0](*args)

    def comp(*args):
        calls.append(("composite_tiles", args))
        out = saved[1](*args)
        if out.requires_grad:
            out.register_hook(lambda g: calls.append(
                ("composite_tiles_bwd", args + (g, args[3].requires_grad))))
        return out

    rasterizer.mesh_tiles, rasterizer.composite_tiles = mesh, comp
    try:
        yield calls
    finally:
        rasterizer.mesh_tiles, rasterizer.composite_tiles = saved


def count_flops(fn) -> dict:
    """Floating-point operations of ``fn()``: the aten GEMMs it dispatches
    (forward, backward and double backward alike) as
    ``torch.utils.flop_counter.FlopCounterMode`` counts them (2·m·k·n per
    product), plus the three kernels' operations on the arguments they were
    given (``KERNEL_COST``), which the counter cannot see (ctypes
    launches). Returns {"flops", "bytes accessed", "gemm_flops",
    "kernel_flops": {name: operations}, "kernel_launches": {name: calls}};
    "bytes accessed" is None: no counter of device memory traffic covers
    the eager step."""
    from torch.utils.flop_counter import FlopCounterMode

    calls = []
    with recorded_kernel_calls(calls), FlopCounterMode(display=False) as counter:
        fn()
    gemm = float(counter.get_total_flops())
    kernel_flops, launches = {}, {}
    for name, args in calls:
        kernel_flops[name] = kernel_flops.get(name, 0.0) + KERNEL_COST[name](args)["flops"]
        launches[name] = launches.get(name, 0) + 1
    return {"flops": gemm + sum(kernel_flops.values()), "bytes accessed": None,
            "gemm_flops": gemm, "kernel_flops": kernel_flops, "kernel_launches": launches}
