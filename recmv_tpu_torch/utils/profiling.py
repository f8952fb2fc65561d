"""Tracing and work counts (counterpart of ``recmv_tpu/utils/profiling.py``).

The port's one span and counter system, off unless switched on:

- ``span(name)``: a named region. Off, it is one shared null context;
  on, a ``torch.profiler.record_function``, so the region lands in the
  profiler's timeline beside the device work it launched.
- ``count(name, value)``: adds to a named counter while tracing is on. A
  value that needs device work is passed as a callable, called only
  while tracing is on; a tensor adds the sum of its elements, taken on
  the device when ``counters()`` reads every counter, once.
- ``enable(syncs=False)``, ``disable()``, ``enabled()``. With
  ``syncs=True`` every host synchronization that torch's sync debug mode
  reports adds 1 to ``sync:<innermost open span>:<file>:<line>``, the
  line being the innermost frame of this package.
- ``trace(log_dir)``: the block under ``torch.profiler`` with spans and
  counters on; writes ``trace.json`` (Chrome/Perfetto) and
  ``counters.json``.

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
import sys
import warnings
from collections import defaultdict

import torch

HBM_BYTES_PER_S = 3.35e12      # H100 SXM device memory, published peak
FP32_FLOP_PER_S = 67e12        # H100 SXM float32 outside the tensor cores, published peak

_PACKAGE = osp.dirname(osp.dirname(osp.abspath(__file__)))
_ROOT = osp.dirname(_PACKAGE)
_SYNC_WARNING = "synchronizing CUDA operation"     # torch's sync debug mode, "warn"
_NULL = contextlib.nullcontext()
_host = defaultdict(float)        # counter → the sum of its host numbers
_device = defaultdict(list)       # counter → tensors whose element sums it adds
_tracing = None                   # the open session while tracing is on


class _Session:
    """Tracing while on: the names of the open spans, innermost last, and
    with ``syncs`` the warning filters and sync debug mode to restore."""

    def __init__(self, syncs: bool):
        self.open = []
        self.syncs = syncs
        if syncs:
            self.filters = warnings.catch_warnings()
            self.filters.__enter__()
            warnings.simplefilter("always")         # every occurrence, not one per line
            self.shown = warnings.showwarning
            warnings.showwarning = self.on_warning
            if torch.cuda.is_available():
                torch.cuda.set_sync_debug_mode("warn")

    def close(self):
        if self.syncs:
            if torch.cuda.is_available():
                torch.cuda.set_sync_debug_mode(0)
            self.filters.__exit__(None, None, None)

    def on_warning(self, message, category, filename, lineno, file=None, line=None):
        if _SYNC_WARNING not in str(message):
            self.shown(message, category, filename, lineno, file, line)
            return
        frame = sys._getframe(1)
        while frame is not None and not frame.f_code.co_filename.startswith(_PACKAGE + os.sep):
            frame = frame.f_back
        if frame is not None:
            filename, lineno = frame.f_code.co_filename, frame.f_lineno
        if filename.startswith(_ROOT + os.sep):
            filename = osp.relpath(filename, _ROOT)
        where = self.open[-1] if self.open else "-"
        _host[f"sync:{where}:{filename}:{lineno}"] += 1.0


def enable(syncs: bool = False) -> None:
    """Switch spans and counters on, the counters from zero; with
    ``syncs``, count the host's synchronizations by span and line too."""
    disable()
    _host.clear()
    _device.clear()
    global _tracing
    _tracing = _Session(syncs)


def disable() -> None:
    """Switch tracing off; the counters stay for ``counters()``."""
    global _tracing
    if _tracing is not None:
        _tracing.close()
        _tracing = None


def enabled() -> bool:
    return _tracing is not None


def span(name: str):
    """A context manager over a named region of the program (see the
    module)."""
    if _tracing is None:
        return _NULL
    return _open_span(_tracing, name)


@contextlib.contextmanager
def _open_span(session: _Session, name: str):
    session.open.append(name)
    try:
        with torch.profiler.record_function(name):
            yield
    finally:
        session.open.pop()


def count(name: str, value=1) -> None:
    """Add ``value`` to counter ``name`` while tracing is on (see the
    module)."""
    if _tracing is None:
        return
    if callable(value):
        value = value()
    if torch.is_tensor(value):
        _device[name].append(value.detach())
    else:
        _host[name] += float(value)


def counters() -> dict:
    """{counter: float}, the device sums read in one transfer; resets every
    counter."""
    out = dict(_host)
    names = list(_device)
    if names:
        sums = torch.stack([torch.cat([t.reshape(-1) for t in _device[k]]).sum(
            dtype=torch.float64) for k in names])
        for k, v in zip(names, sums.tolist()):
            out[k] = out.get(k, 0.0) + v
    _host.clear()
    _device.clear()
    return out


@contextlib.contextmanager
def trace(log_dir: str):
    """Capture a ``torch.profiler`` trace of the block (host activity, and
    the card's where there is one), spans and counters on, into
    ``<log_dir>/trace.json`` and ``<log_dir>/counters.json``."""
    os.makedirs(log_dir, exist_ok=True)
    acts = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    enable()
    try:
        with torch.profiler.profile(activities=acts) as prof:
            yield prof
    finally:
        disable()
    prof.export_chrome_trace(osp.join(log_dir, "trace.json"))
    with open(osp.join(log_dir, "counters.json"), "w") as f:
        json.dump(counters(), f, indent=1, sort_keys=True)


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
