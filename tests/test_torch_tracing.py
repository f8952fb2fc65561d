"""The port's spans and counters (``recmv_tpu_torch/utils/profiling.py``) on
the CPU.

- Off, ``span`` is one shared null context and ``count`` calls nothing.
- A training step of a tiny one-garment scene gives the same bits with
  tracing on and off, and its surface solve's counters hold together.
- The surface solve alone, on a sphere: the counters against the solve's
  own loop.
- A sync warning falls to the innermost open span and to the innermost
  line of the package (the warning's own line outside it).
- ``trace()`` writes the timeline with the spans and the counters.
"""

import json
import os
import warnings

import pytest
import torch

from recmv_tpu_torch.core.surface_ps import optimize_surface_points
from recmv_tpu_torch.utils import profiling

RATIO = {"sdfRatio": 1.0, "deformerRatio": 0.5, "renderRatio": 1.0}
SYNC = "called a synchronizing CUDA operation"
HERE = os.path.join("tests", os.path.basename(__file__))


@pytest.fixture(autouse=True)
def _off():
    """Every test starts and ends with tracing off and no counters."""
    profiling.disable()
    profiling.counters()
    yield
    profiling.disable()
    profiling.counters()


@pytest.fixture(scope="module")
def scene(tmp_path_factory):
    from recmv_tpu_torch.data.synthetic import generate_scene

    root = tmp_path_factory.mktemp("tracing")
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        yield root, generate_scene(str(root / "scene"), n_frames=2, image_size=32,
                                   skinner_res=(17, 25, 9), device="cpu")
    finally:
        torch.set_num_threads(n)


def _step(root, scene, traced: bool):
    """One training step of a fresh network on frame 0 → (info, leaves,
    counters, the solve's rows); ``traced`` runs it with tracing on."""
    from recmv_tpu_torch.config import ConfigFactory
    from recmv_tpu_torch.core.builder import build_opt_net
    from recmv_tpu_torch.core.network import TrainConfig
    from recmv_tpu_torch.data.dataset import get_dataset_and_loader
    from recmv_tpu_torch.data.synthetic import shrink_garment_init

    torch.manual_seed(0)
    ds, _ = get_dataset_and_loader(scene, {"deformer": 256, "render": 256}, 1, shuffle=False,
                                   garment_type="synthetic-tube", data_type="synthe")
    cfg = TrainConfig(sample_pix=32, point_radius=0.025, remesh_intersect=8,
                      mc_capacity_v=1 << 12, mc_capacity_f=1 << 13, raster_tile=16,
                      raster_cap_mesh=4096, raster_cap_points=4096, solver_times=20,
                      surface_sample=32)
    conf = ConfigFactory.parse_file(os.path.join(os.path.dirname(__file__), "..", "configs",
                                                 "synthetic", "smoke.conf"))
    net = build_opt_net(conf, ds, str(root / "port"), resolutions=((7, 9, 5), (13, 17, 9)),
                        skinner_res=(17, 25, 9), train_cfg=cfg, device="cpu")
    shrink_garment_init(net.params)              # a garment surface over the gt mask
    rows = []
    solve = net.solve_surface_points

    def solve_and_keep_rows(ray_data, *a):
        rows.extend(rd["valid"].shape[0] for rd in ray_data)
        return solve(ray_data, *a)

    net.solve_surface_points = solve_and_keep_rows
    if traced:
        profiling.enable()
    _, info = net.train_step(ds.get_batch([0]), [0], RATIO,
                             generator=torch.Generator().manual_seed(0))
    profiling.disable()
    leaves = {k: v.detach().clone() for k, v in net.global_leaves().items()}
    return info, leaves, profiling.counters(), rows, net.cfg.solver_times


@pytest.fixture(scope="module")
def steps(scene):
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        return _step(*scene, traced=False), _step(*scene, traced=True)
    finally:
        torch.set_num_threads(n)


def test_off_span_is_one_null_context_and_count_calls_nothing():
    def never():
        raise AssertionError("a counter's callable ran with tracing off")

    assert not profiling.enabled()
    assert profiling.span("solve/eval") is profiling.span("main/backward")
    with profiling.span("solve/eval"):
        profiling.count("solve.live", never)
    assert profiling.counters() == {}


def test_counters_add_host_and_device_values_and_reset():
    profiling.enable()
    assert profiling.enabled()
    profiling.count("a", torch.tensor([1, 2]))
    profiling.count("a", 3)
    profiling.count("b", lambda: torch.ones(2, 2, dtype=torch.bool))
    profiling.count("c")
    profiling.disable()
    assert profiling.counters() == {"a": 6.0, "b": 4.0, "c": 1.0}
    assert profiling.counters() == {}


def test_step_gives_the_same_bits_with_tracing_on_and_off(steps):
    (info_off, leaves_off, c_off, _, _), (info_on, leaves_on, c_on, _, _) = steps
    assert c_off == {} and c_on
    assert info_on == info_off
    assert list(leaves_on) == list(leaves_off)
    for k in leaves_off:
        assert torch.equal(leaves_on[k], leaves_off[k]), k


def test_step_solve_counters_hold_together(steps):
    _, (_, _, c, rows, times) = steps
    assert c["solve.calls"] == len(rows) == 1
    assert 1 <= c["solve.evals"] <= (times + 1) * c["solve.calls"]
    assert c["solve.rows"] == c["solve.evals"] * rows[0]
    assert 0 < c["solve.live"] <= c["solve.rows"]


@pytest.mark.parametrize("offset", [0.0, 0.01])
def test_solve_counters_on_a_sphere(offset):
    """A unit sphere seen from z = 3, seeds on their rays ``offset`` in front
    of it, 4 of 64 rows invalid. Seeds on the surface converge at the first
    evaluation and the solve stops there; 0.01 off, few converge in 21."""
    torch.manual_seed(0)
    M, times = 64, 20
    target = torch.nn.functional.normalize(torch.randn(M, 3), dim=-1)
    target[:, 2] = target[:, 2].abs()                       # the side facing the camera
    target = torch.nn.functional.normalize(target, dim=-1)
    cam = torch.tensor([0.0, 0.0, 3.0])
    rays = torch.nn.functional.normalize(target - cam, dim=-1)
    init = cam + rays * ((target - cam).norm(dim=-1, keepdim=True) - offset)
    valid = torch.arange(M) >= 4
    args = (lambda p: p.norm(dim=-1) - 1.0, lambda p: p, cam, rays, init, valid)
    want = optimize_surface_points(*args, times=times)
    profiling.enable()
    got = optimize_surface_points(*args, times=times)
    profiling.disable()
    assert all(torch.equal(a, b) for a, b in zip(got, want))
    c = profiling.counters()
    n_valid, n_conv = int(valid.sum()), int(want[1].sum())
    assert c["solve.calls"] == 1
    assert c["solve.rows"] == c["solve.evals"] * M
    if offset == 0:
        assert n_conv == n_valid
        assert (c["solve.evals"], c["solve.live"]) == (1, n_valid)
    else:
        assert n_conv < n_valid // 4
        assert c["solve.evals"] == times + 1
        # the rows that never converged were live at every evaluation,
        # the invalid rows at none
        evals = c["solve.evals"]
        assert evals * (n_valid - n_conv) <= c["solve.live"] <= evals * n_valid


def _sync_here():
    warnings.warn(SYNC)


def test_sync_warnings_fall_to_the_open_span_and_the_line():
    line = _sync_here.__code__.co_firstlineno + 1
    profiling.enable(syncs=True)
    with profiling.span("solve/eval"), profiling.span("solve/check"):
        for _ in range(2):                                   # each occurrence counts
            _sync_here()
    with profiling.span("main/backward"):
        profiling.count("n", lambda: warnings.warn(SYNC) or 1)
    with pytest.warns(UserWarning, match="not a sync"):      # other warnings pass on
        warnings.warn("not a sync")
    profiling.disable()
    c = profiling.counters()
    count_line = profiling.count.__code__.co_firstlineno
    inner = [k for k in c if k.startswith("sync:main/backward:recmv_tpu_torch/utils/profiling.py:")]
    assert c[f"sync:solve/check:{HERE}:{line}"] == 2.0
    assert len(inner) == 1 and int(inner[0].rsplit(":", 1)[1]) > count_line
    assert c["n"] == 1.0 and len(c) == 3


def test_trace_writes_the_timeline_and_the_counters(tmp_path):
    with profiling.trace(str(tmp_path)):
        assert profiling.enabled()
        with profiling.span("solve/eval"):
            torch.ones(8).sum()
        profiling.count("solve.live", torch.ones(3, dtype=torch.bool))
        profiling.count("solve.evals", 2)
    assert not profiling.enabled()
    with open(tmp_path / "trace.json") as f:
        assert "solve/eval" in f.read()
    with open(tmp_path / "counters.json") as f:
        assert json.load(f) == {"solve.evals": 2.0, "solve.live": 3.0}
