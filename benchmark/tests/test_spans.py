"""CPU tests of the span pass (``benchmark/spans.py``): ``read_spans`` on
stand-ins for the profiler's events, both passes on a tiny cell, and
nothing read from a package without spans.

    python -m pytest benchmark/tests/test_spans.py -q
"""

from __future__ import annotations

import os.path as osp
import sys

import pytest
import torch

ROOT = osp.dirname(osp.dirname(osp.dirname(osp.abspath(__file__))))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

from benchmark import drive, run, spans, trace  # noqa: E402
from test_benchmark_harness import WORKLOADS, _Event, tiny  # noqa: E402


@pytest.mark.parametrize("offset", [0, 250_000, -40_000, 10 ** 12])
def test_read_spans_puts_work_down_to_the_innermost_span_by_correlation(offset):
    """Launches, syncs, busy time and the idle gap before each piece of work
    fall to the innermost program span open at the launch, the phase where
    none is, whatever the device's clock; the totals are ``read_events``'."""
    cpu, gpu = torch.autograd.DeviceType.CPU, torch.autograd.DeviceType.CUDA
    d = offset + 2_000
    ev = [_Event("phase:batch", cpu, 0, 1_000_000),
          _Event("phase:solve", cpu, 1_000_000, 900_000),
          _Event("solve/check", cpu, 1_000_000, 50_000),
          _Event("solve/eval", cpu, 1_050_000, 450_000),
          _Event("solve/step", cpu, 1_200_000, 100_000),
          _Event("Optimizer.step#Adam.step", cpu, 1_210_000, 10_000),
          _Event("cudaStreamSynchronize", cpu, 1_040_000, 5),
          _Event("cudaLaunchKernel", cpu, 1_060_000, 5, 7),
          _Event("cuLaunchKernel", cpu, 1_250_000, 5, 9),
          _Event("cudaLaunchKernel", cpu, 1_600_000, 5, 10),
          _Event("cudaStreamSynchronize", cpu, 1_800_000, 5),
          _Event("void gemm<1>(...)", gpu, 1_060_000 + d, 100_000, 7, "kernel"),
          _Event("solve/eval", gpu, 1_050_000 + d, 450_000, 0, "gpu_user_annotation"),
          _Event("solve/step", gpu, 1_200_000 + d, 100_000, 0),    # no activity type
          _Event("mesh_tiles_kernel(float const*)", gpu, 1_250_000 + d, 50_000, 9, "kernel"),
          _Event("Memcpy HtoD (Pageable -> Device)", gpu, 1_600_000 + d, 20_000, 10,
                 "gpu_memcpy"),
          _Event("void reduce<2>(...)", gpu, 1_700_000 + d, 10_000, 11, "kernel")]
    r = spans.read_spans(ev, 2)
    s = r["by_span"]
    assert s["solve/eval"]["launches"] == 0.5 and s["solve/eval"]["idle_ms"] == 0
    assert s["solve/step"]["launches"] == 0.5
    assert s["solve/step"]["idle_ms"] == pytest.approx(0.09 / 2)
    assert s["solve/step"]["busy_ms"] == pytest.approx(0.05 / 2)
    assert s["solve"]["launches"] == 0 and s["solve"]["idle_ms"] == pytest.approx(0.3 / 2)
    assert s["solve/check"]["syncs"] == s["solve"]["syncs"] == 0.5
    assert s[spans.UNMATCHED]["launches"] == 0.5 and r["total"]["unmatched"] == 0.5
    assert s[spans.UNMATCHED]["idle_ms"] == pytest.approx(0.08 / 2)
    assert "Optimizer.step#Adam.step" not in s
    own = {k: s[k]["host_ms"] * 2 for k in ("batch", "solve", "solve/check", "solve/eval",
                                             "solve/step")}
    assert own == pytest.approx({"batch": 1.0, "solve": 0.4, "solve/check": 0.05,
                                 "solve/eval": 0.35, "solve/step": 0.1})
    whole = trace.read_events(ev, 2, 1.0)       # it takes the span's copy for a kernel
    assert r["total"]["launches"] * 2 == whole["launches"] - 1 == 3
    assert r["total"]["span_copies"] * 2 == 1
    assert r["total"]["syncs"] * 2 == whole["syncs"] == 2


def test_a_package_without_spans_gives_nothing():
    assert spans._tracing("benchmark.reference.recmv") is None
    assert spans.span_pass(None, None, None, {}, None, None, 1, torch.device("cpu"),
                           pkg="benchmark.reference.recmv") is None
    assert spans.sync_pass(None, None, None, {}, None, None, torch.device("cpu"),
                           pkg="benchmark.reference.recmv") is None
    assert spans.metrics({"spans": None, "syncs_by_line": None}) == dict.fromkeys(spans.METRICS)
    assert spans.metrics({}) == dict.fromkeys(spans.METRICS)


@pytest.fixture(autouse=True)
def _threads():
    n = torch.get_num_threads()
    torch.set_num_threads(min(4, n))
    yield
    torch.set_num_threads(n)


def test_passes_on_a_tiny_cell():
    """Both passes on the CPU (no device work: the counters and the host's
    spans): the solve's counters hold together and every phase of the
    step is a span of its own or holds one."""
    from benchmark import scene

    cell, dev = tiny(WORKLOADS[0]), torch.device("cpu")
    scene_dir = scene.cached(cell["config"], cell["traffic"], dev)
    ds, net, order, _, gen, _ = run.setup_program(cell, 2 ** 31 + 7, dev, scene_dir,
                                                  run.default_step, {})
    out = spans.passes(net, ds, order, dict(cell["traffic"]["ratio"]), gen, run.default_step,
                       2, dev)
    c = out["spans"]["counters"]
    times = cell["traffic"]["caps"]["solver_times"]
    assert c["solve.calls"] == 2 and 2 <= c["solve.evals"] <= 2 * (times + 1)
    assert c["solve.live"] <= c["solve.rows"]
    labels = set(out["spans"]["by_span"])
    assert {"solve/eval", "solve/check", "main/backward", "update/info"} <= labels
    assert all(p in labels or any(lab.startswith(p + "/") for lab in labels)
               for p in drive.PHASES if p not in ("remesh", "verts"))
    assert out["syncs_by_line"] == []                 # the CPU has no sync to report
    m = spans.metrics(out)
    assert 1 <= m["solve_evals"] <= times + 1 and 0 < m["solve_live_pct"] <= 100
    assert m["solve_launches_per_eval"] == m["solve_syncs_per_eval"] == 0
