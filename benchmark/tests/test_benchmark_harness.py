"""CPU tests of the benchmark harness (``benchmark/``): the files found by
name, the frozen work and FLOP counts, the reference against the port's
step at a tiny size, the faults that must make ``correct`` false, and the
import checks. The test marked ``gpu`` runs a cell on the card and skips
without one.

    python -m pytest benchmark/tests -q
"""

from __future__ import annotations

import copy
import importlib
import json
import math
import os
import os.path as osp
import re
import subprocess
import sys

import pytest
import torch

ROOT = osp.dirname(osp.dirname(osp.dirname(osp.abspath(__file__))))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

from benchmark import check, drive, flops, kernel_work, spec, weights  # noqa: E402
from benchmark import run as bench_run  # noqa: E402

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


def _bench() -> dict:
    with open(osp.join(ROOT, "BENCHMARK.json")) as f:
        return json.load(f)


WORKLOADS = [w["name"] for w in _bench()["workloads"]]


def tiny(cell: str) -> dict:
    """The cell at a size the CPU runs in seconds: 64² frames, 4 of them,
    64 rays, the tiny pyramid and small caps; the widths as published."""
    c = copy.deepcopy(spec.load_cell(cell))
    c["config"]["skinner_res"] = [17, 25, 9]
    c["traffic"].update(image=64, frames=4, sample_pix=64, pyramid="tiny",
                        caps=dict(raster_tile=16, raster_cap_mesh=128, raster_cap_points=128,
                                  solver_times=4, surface_sample=64, mc_capacity_v=4096,
                                  mc_capacity_f=8192))
    return c


def crop_top_cell() -> dict:
    """A cell of a configuration that exists only here, at the tiny size:
    ``tube.fine_b1`` with the garment type ``bench-crop-top``, which
    neither the frozen copy nor the port lists, its scene from
    ``benchmark/scenes/crop_top.py`` and the curve-aware term on
    ``bottom_curve``."""
    c = tiny("tube.fine_b1")
    cfg = c["config"]
    cfg.update(name="bench_crop_top", garment_type="bench-crop-top", curve_aware="bottom_curve",
               scene={"module": "crop_top", "skinner_res": cfg["scene"]["skinner_res"],
                      "raster_cap": cfg["scene"]["raster_cap"]})
    cfg["conf"]["train"]["garment_type"] = "bench-crop-top"
    c["cell"] = dict(c["cell"], name="crop_top.fine_b1", config="bench_crop_top")
    return c


@pytest.fixture(autouse=True)
def _threads():
    n = torch.get_num_threads()
    torch.set_num_threads(min(4, n))
    yield
    torch.set_num_threads(n)


# --------------------------------------------------------------------------
# the files, found by name
# --------------------------------------------------------------------------

def test_benchmark_json_keeps_to_its_contract():
    b = _bench()
    assert set(b) == {"command", "paths", "run_seconds", "configs", "workloads", "end_to_end",
                      "per_layer"}
    assert b["paths"] == ["benchmark"] and b["command"][1].startswith("benchmark/")
    assert 1 <= b["run_seconds"] <= 51 and isinstance(b["run_seconds"], int)
    assert 2 + 14 * 24 * (b["run_seconds"] + 60) + 24 * 180 + 1200 <= 43200
    names = [x["name"] for k in ("configs", "workloads", "end_to_end", "per_layer")
             for x in b[k]]
    assert len(names) == len(set(names)) and all(NAME.match(n) for n in names)
    e2e = {m["name"]: m for m in b["end_to_end"]}
    assert "setup_s" in e2e and all(0.01 <= m["bound"] <= 0.25 for m in e2e.values())
    for m in b["end_to_end"] + b["per_layer"]:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
    for m in b["per_layer"]:
        assert m["moves"] in e2e and 1 <= len(m["layer"]) <= 200
        assert set(m) <= {"name", "unit", "better", "source", "layer", "moves", "workloads"}
    for c in b["configs"]:
        assert c["file"].startswith("benchmark/") and osp.isfile(osp.join(ROOT, c["file"]))
        assert all(NAME.match(k) for k in c["reduced"])
    for w in b["workloads"]:
        assert w["chips"] == 1 and len(w["why"]) <= 200
        assert osp.isfile(osp.join(ROOT, "benchmark", "traffic", w["traffic"] + ".json"))


@pytest.mark.parametrize("cell", WORKLOADS)
def test_cell_files_found_by_name(cell):
    c = spec.load_cell(cell)
    assert c["config"]["name"] == c["cell"]["config"]
    assert c["traffic"]["name"] == c["cell"]["traffic"]
    assert {m["name"] for m in c["end_to_end"]} >= {"step_s", "setup_s"}
    assert c["per_layer"]
    for m in c["per_layer"]:
        mod = importlib.import_module(f"benchmark.metrics.{m['name']}")
        assert mod.read({}) is None                 # a reader with nothing to read
    assert ("remesh_ms" in {m["name"] for m in c["per_layer"]}) == (cell == "two_piece.coarse_b3")


def test_hocon_text_reads_back_in_the_port():
    from recmv_tpu_torch.config import ConfigFactory

    conf = spec.load_cell("two_piece.coarse_b3")["config"]["conf"]
    tree = ConfigFactory.parse_string(spec.hocon_text(conf))
    assert tree.get_string("train.garment_type") == "synthetic-two"
    assert tree.get_float("loss_fine.pc_weight.curve_aware_weight") == 30.0
    assert tree.get_bool("train.opt_camera.quat") is False
    assert tree.get_string("loss_coarse.fl_visible_method") == "zbuff"


@pytest.mark.parametrize("cell", WORKLOADS)
def test_weights_have_the_ports_layout(cell):
    from recmv_tpu_torch.models.render_net import init_render_net
    from recmv_tpu_torch.models.sdf import init_sdf_net
    from recmv_tpu_torch.models.translator import init_translator

    cfg = spec.load_cell(cell)["config"]
    w = weights.make_weights(cfg, 2 ** 31 + 11, "cpu")
    assert sum(t.numel() for t in w.values()) == cfg["parameters"]
    g = torch.Generator().manual_seed(0)
    port = {f"sdf.{k}": p for k, p in init_sdf_net(g, 6, 0.6, 256).named_parameters()}
    for i in range(len(cfg["garments"])):
        port.update({f"garment_sdfs.{i}.{k}": p
                     for k, p in init_sdf_net(g, 6, 0.6, 256).named_parameters()})
    port.update({f"translator.{k}": p for k, p in init_translator(g, 128, 6).named_parameters()})
    port.update({f"render.{k}": p for k, p in init_render_net(g, 256, 4, 0).named_parameters()})
    assert {k: tuple(v.shape) for k, v in port.items()} == {k: tuple(v.shape)
                                                            for k, v in w.items()}
    assert torch.equal(w["garment_sdfs.0.lins.8.b"], torch.full((257,), -0.48))
    assert torch.equal(w["sdf.lins.0.v"][:, 3:], torch.zeros(512, 36))
    w2 = weights.make_weights(cfg, 2 ** 31 + 11, "cpu")
    assert all(torch.equal(w[k], w2[k]) for k in w)          # the same seed, the same weights


def test_frame_order_is_drawn_from_the_seed():
    a = drive.frame_batches(2 ** 31 + 5, 12, 3)
    b = drive.frame_batches(2 ** 31 + 5, 12, 3)
    first = [next(a) for _ in range(8)]
    assert first == [next(b) for _ in range(8)]
    assert sorted(sum(first[:4], [])) == list(range(12))    # an epoch covers every frame once
    c = drive.frame_batches(2 ** 31 + 6, 12, 3)
    assert [next(c) for _ in range(8)] != first


# --------------------------------------------------------------------------
# a configuration's own scene, garment set and SDF seed
# --------------------------------------------------------------------------

def _same_files(a: str, b: str) -> None:
    """Every file under ``a`` and ``b`` alike: the same names, the same bytes,
    the arrays of each ``.npz`` alike (a zip member carries its time)."""
    import numpy as np

    def names(d):
        return sorted(osp.relpath(osp.join(r, f), d) for r, _, fs in os.walk(d) for f in fs)

    assert names(a) == names(b)
    for n in names(a):
        pa, pb = osp.join(a, n), osp.join(b, n)
        if n.endswith(".npz"):
            za, zb = np.load(pa), np.load(pb)
            assert sorted(za.files) == sorted(zb.files), n
            assert all(np.array_equal(za[k], zb[k]) for k in za.files), n
        else:
            with open(pa, "rb") as fa, open(pb, "rb") as fb:
                assert fa.read() == fb.read(), n


@pytest.mark.parametrize("cell", ["tube.fine_b1", "two_piece.coarse_b3"])
def test_existing_configurations_read_what_the_frozen_generator_gives(cell, tmp_path,
                                                                       monkeypatch):
    """For the configurations that name the frozen generator, the scene
    cache's directory keeps its name and holds the frozen generator's
    files, the curves are its rings, and the weights are those of
    ``SDF_SEED`` 90. ``scenes/render.py``, given the generator's own meshes
    and rings, writes the same files."""
    import hashlib
    import tempfile

    import numpy as np

    from benchmark import scene
    from benchmark.reference.recmv.data import synthetic
    from benchmark.reference.recmv.geometry.polygons import uniform_sample_3d
    from benchmark.scenes.render import render_scene

    c = tiny(cell)
    cfg, tr, gen = c["config"], c["traffic"], c["config"]["scene"]["generator"]
    monkeypatch.setattr(tempfile, "tempdir", str(tmp_path))
    key = {"scene": cfg["scene"], "image": 64, "frames": 4, "version": synthetic.SCENE_VERSION}
    tag = hashlib.sha1(json.dumps(key, sort_keys=True).encode()).hexdigest()[:12]
    dev = torch.device("cpu")
    got = scene.cached(cfg, tr, dev)
    assert got == osp.join(str(tmp_path), "recmv_bench_scenes", f"{gen}_64_4_{tag}")
    args = dict(n_frames=4, image_size=64, skinner_res=tuple(cfg["scene"]["skinner_res"]),
                raster_cap=cfg["scene"]["raster_cap"], device=dev)
    want = synthetic.generate_scene(str(tmp_path / "frozen"), garment_type=gen, **args)
    _same_files(got, want)
    rings = [(n, synthetic.boundary_ring(y, offset=off))
             for n, y, off in synthetic.SCENE_CURVES[gen]]
    pieces = [(n, synthetic.garment_mesh(offset=off, band=band), label)
              for n, off, band, label in synthetic.SCENE_GARMENTS[gen]]
    rendered = render_scene(str(tmp_path / "render"), **args, garment_type=gen,
                            version=synthetic.SCENE_VERSION, pieces=pieces, rings=rings,
                            diffused=gen == "synthetic-two")
    _same_files(rendered, want)

    aligned, template, rigid = scene.curves(cfg)
    assert list(aligned) == cfg["curves"] and template is aligned
    for n, ring in rings:
        assert np.array_equal(aligned[n], uniform_sample_3d(ring, 200).astype(np.float32))
        assert rigid[n][1] == 1.0 and not rigid[n][0].any()

    w = weights.make_weights(cfg, 2 ** 31 + 17, dev)
    specs = {}
    for s in weights.layers(cfg):
        specs.setdefault(s[0].rsplit(".lins.", 1)[0], []).append(s)
    sdf_nets = ["sdf"] + [f"garment_sdfs.{i}" for i in range(len(cfg["garments"]))]
    for i, net in enumerate(sdf_nets):
        direct = weights._draw(specs[net], torch.Generator().manual_seed(90 + i), dev)
        assert direct.keys() <= w.keys()
        assert all(torch.equal(w[k], v) for k, v in direct.items()), net
    assert "sdf_seed" not in cfg


def test_sdf_seed_from_the_configuration():
    """``sdf_seed`` moves every SDF's seed (the drawn weights; the output
    biases are constants); the other nets keep the run's."""
    cfg = spec.load_cell("two_piece.coarse_b3")["config"]
    base = weights.make_weights(cfg, 2 ** 31 + 19, "cpu")
    moved = weights.make_weights(dict(cfg, sdf_seed=weights.SDF_SEED + 1), 2 ** 31 + 19, "cpu")
    for k, v in moved.items():
        if k.endswith(".b") and "sdf" in k:
            continue
        if k.startswith("sdf."):
            assert torch.equal(v, base["garment_sdfs.0." + k[4:]]), k
        elif k.startswith("garment_sdfs.0."):
            assert torch.equal(v, base["garment_sdfs.1." + k[15:]]), k
        elif not k.startswith("garment_sdfs."):
            assert torch.equal(v, base[k]), k


TABLES = ("TEMPLATE_GARMENT", "FL_INFOS", "CURVE_AWARE", "FL_EXTRACT")


@pytest.fixture
def copy_tables():
    """The frozen copy's tables, restored after the test (the harness adds
    a configuration's entries to them in place)."""
    from benchmark.reference.recmv.config import constants

    saved = {t: dict(getattr(constants, t)) for t in TABLES}
    yield constants
    for t, d in saved.items():
        getattr(constants, t).clear()
        getattr(constants, t).update(d)


def test_a_configuration_of_new_files_runs_through_both_packages(copy_tables, monkeypatch):
    """A configuration that only new files make (a scene module, a garment
    type neither package lists): the harness adds its garment set to the
    frozen copy's tables, the port is given its entries here, and a run
    reads every compared number 0."""
    from recmv_tpu_torch.config import constants as port

    c = crop_top_cell()
    gt = c["config"]["garment_type"]
    assert all(gt not in getattr(copy_tables, t) for t in TABLES[:3])
    assert all(gt not in getattr(port, t) for t in TABLES[:3])
    monkeypatch.setitem(port.TEMPLATE_GARMENT, gt, ["tube"])
    monkeypatch.setitem(port.FL_INFOS, gt, ["neck", "bottom_curve"])
    monkeypatch.setitem(port.CURVE_AWARE, gt, "bottom_curve")
    monkeypatch.setattr(check, "load_limits", lambda cell: dict.fromkeys(check.NUMBERS, 0.0))
    out = bench_run.run_cell(c, 2 ** 31 + 103, 0.5, False, torch.device("cpu"))
    values = check.readings(out["_readings"]["program"], out["_readings"]["reference"])
    assert values == dict.fromkeys(check.NUMBERS, 0.0)
    assert out["correct"] is True and out["failed"] == 0
    assert copy_tables.TEMPLATE_GARMENT[gt] == ["tube"]
    assert copy_tables.CURVE_AWARE[gt] == "bottom_curve"
    assert out["_readings"]["program"]["mesh"]["verts"][0] > 0


@pytest.mark.parametrize("port_entry", [["upper_tube", "skirt"], None])
def test_a_garment_set_the_port_does_not_give_fails_at_set_up(port_entry, copy_tables,
                                                              monkeypatch):
    """Where the port's entry for the garment type differs from the
    configuration's, or is missing, a run stops before its scene and its
    first step, and names both lists."""
    from benchmark import scene
    from recmv_tpu_torch.config import constants as port

    c = crop_top_cell()
    gt = c["config"]["garment_type"]
    if port_entry is not None:
        monkeypatch.setitem(port.TEMPLATE_GARMENT, gt, port_entry)
    monkeypatch.setitem(port.FL_INFOS, gt, ["neck", "bottom_curve"])
    monkeypatch.setitem(port.CURVE_AWARE, gt, "bottom_curve")

    def never(*a, **k):
        raise AssertionError("the run went on past the check")

    monkeypatch.setattr(scene, "cached", never)
    with pytest.raises(ValueError) as err:
        bench_run.run_cell(c, 5, 0.5, False, torch.device("cpu"), step_fn=never)
    msg = str(err.value)
    assert f"TEMPLATE_GARMENT[{gt!r}]" in msg and repr(port_entry) in msg and "['tube']" in msg
    assert "FL_INFOS" not in msg and gt not in copy_tables.TEMPLATE_GARMENT


def test_the_frozen_copy_refuses_a_garment_set_it_holds_otherwise(copy_tables):
    """An entry is added to the frozen copy only where its key is absent."""
    cfg = dict(spec.load_cell("tube.fine_b1")["config"], garments=["upper_tube"])
    with pytest.raises(ValueError, match=r"TEMPLATE_GARMENT\['synthetic-tube'\] is \['tube'\]"):
        drive.register_garment_set(cfg)
    assert copy_tables.TEMPLATE_GARMENT["synthetic-tube"] == ["tube"]


# --------------------------------------------------------------------------
# the frozen counts
# --------------------------------------------------------------------------

def test_kernel_work_counts_on_a_small_input():
    from recmv_tpu_torch.ops import rasterizer

    assert kernel_work.k1_bytes(2, 10, 8, 16) == 2 * 10 * 36 + 2 * 8 * 16 * 20
    assert kernel_work.k2_bytes(1, 5, 2, 4, 4) == 5 * 12 + 5 * 2 * 4 + 16 * 2 * 4
    assert kernel_work.k3_bytes(1, 5, 2, 4, 4, True) == (kernel_work.k2_bytes(1, 5, 2, 4, 4)
                                                          + 5 * 8 + 5 * 2 * 4)
    assert kernel_work.bound_s(3_350_000) == pytest.approx(1e-6)
    g = torch.Generator().manual_seed(1)
    verts = torch.rand(2, 30, 3, generator=g) * torch.tensor([32.0, 32.0, 1.0]) + \
        torch.tensor([0.0, 0.0, 1.0])
    faces = torch.randint(0, 30, (20, 3), generator=g)
    pts = (verts[:, :12] + 0).requires_grad_(True)
    feats = torch.rand(12, 2, generator=g)
    with kernel_work.LaunchLog(rasterizer) as log:
        rasterizer.rasterize_mesh(verts, faces, (32, 48), tile=16, cap=64)
        rasterizer.composite_points(pts, 0.05, feats, (32, 32), tile=16, cap=16).sum().backward()
    assert rasterizer.mesh_tile_inputs is log._orig[0]      # restored
    b = log.bound_s()
    assert b["K1"] == (1, kernel_work.bound_s(kernel_work.k1_bytes(2, 20, 32, 48)))
    assert b["K2"][0] == 1 and b["K3"] == (1, kernel_work.bound_s(
        kernel_work.k3_bytes(2, 12, 2, 32, 32, False)))


class _Event:
    """A stand-in for the profiler's kineto event."""

    def __init__(self, name, device, t0, dur, corr=0, kind=None):
        self._v = (name, device, t0, dur, corr, kind)

    def name(self):
        return self._v[0]

    def device_type(self):
        return self._v[1]

    def start_ns(self):
        return self._v[2]

    def duration_ns(self):
        return self._v[3]

    def correlation_id(self):
        return self._v[4]

    def activity_type(self):
        return self._v[5]


@pytest.mark.parametrize("offset", [0, 250_000, -40_000])
def test_trace_reads_busy_time_launches_syncs_and_gaps(offset):
    """Busy time is the union of the device's intervals; launches count its
    kernels (copies not); the idle gaps fall to the host's phase at their
    middle whatever the offset between the device's and the host's clocks."""
    from benchmark import trace

    cpu, gpu = torch.autograd.DeviceType.CPU, torch.autograd.DeviceType.CUDA
    d = offset + 2_000                                # the device's clock, 2 µs of launch latency
    ev = [_Event("phase:batch", cpu, 0, 1_000_000), _Event("phase:solve", cpu, 1_000_000, 900_000),
          _Event("cudaLaunchKernel", cpu, 1_000_000, 5, 7),
          _Event("cudaMemcpyAsync", cpu, 1_100_000, 5, 8),
          _Event("cudaLaunchKernel", cpu, 1_600_000, 5, 9),
          _Event("cudaStreamSynchronize", cpu, 1_800_000, 5),
          _Event("mesh_tiles_kernel(float const*)", gpu, 1_000_000 + d, 100_000, 7, "kernel"),
          _Event("Memcpy HtoD (Pageable -> Device)", gpu, 1_100_000 + d, 50_000, 8, "gpu_memcpy"),
          _Event("phase:solve", gpu, 1_000_000 + d, 900_000, 0, "gpu_user_annotation"),
          _Event("void gemm<1>(...)", gpu, 1_600_000 + d, 100_000, 9, "kernel")]
    r = trace.read_events(ev, 1, 1.0)
    assert r["busy_s"] == pytest.approx(250e-6)
    assert (r["launches"], r["syncs"], r["clock_offset_ns"]) == (2, 1, d)
    assert r["kernel_counts"] == {"K1": 1, "K2": 0, "K3": 0}
    assert r["kernel_s"]["K1"] == pytest.approx(100e-6)
    assert r["idle_gaps"] == [["solve", pytest.approx(450e-6)]]


def test_phase_ranges_name_each_phase_by_its_own_mark():
    """The range named p covers phase p: opened after the previous mark,
    closed at p's mark."""
    from benchmark import drive, trace

    ranges = trace.PhaseRanges(("batch",) + drive.PHASES)
    opened = []
    ranges._open = opened.append
    ranges.start()
    for phase in ("batch",) + drive.PHASES:
        assert opened[-1] == phase
        ranges.mark(phase)
    assert opened == ["batch", *drive.PHASES]


@pytest.mark.parametrize("usage,factor,tol", [("forward", 1.0, 0.0), ("input_grad", 2.0, 0.0),
                                              ("all_grads", 3.0, 0.0), ("eikonal", 6.0, 0.04),
                                              ("jacobian", 12.0, 0.002)])
def test_flops_pass_factors_against_flop_counter(usage, factor, tol):
    """The passes of ``flops.py`` against ``FlopCounterMode`` on the port's
    networks at the published widths. The eikonal pass counts 5.8 F
    there: its first layer's input is the positional encoding of the
    points, whose second-order GEMM terms autograd does not need."""
    from torch.utils.flop_counter import FlopCounterMode

    from recmv_tpu_torch.models.deformer import deformer_jacobian
    from recmv_tpu_torch.models.sdf import init_sdf_net, sdf_value, sdf_value_and_gradient
    from recmv_tpu_torch.models.translator import init_translator, translator_apply

    F = flops.forward_flops(spec.load_cell("tube.fine_b1")["config"])
    g = torch.Generator().manual_seed(0)
    sdf, tr = init_sdf_net(g, 6, 0.6, 256), init_translator(g, 128, 6)
    M = 32
    p, cond = torch.randn(M, 3, generator=g), torch.randn(M, 128, generator=g)

    def run():
        q = p.clone().requires_grad_(True)
        if usage == "forward":
            sdf_value(sdf, p, 1.0)
        elif usage == "input_grad":
            torch.autograd.grad(sdf_value(sdf, q, 1.0).sum(), q)
        elif usage == "all_grads":
            sdf_value(sdf, q, 1.0).sum().backward()
        elif usage == "eikonal":
            _, gr = sdf_value_and_gradient(sdf, p, 1.0)
            ((gr.norm(dim=-1) - 1) ** 2).sum().backward()
        else:
            J = deformer_jacobian(lambda x: translator_apply(tr, x, cond, 1.0)[0], p,
                                  create_graph=True)
            J.square().sum().backward()

    with FlopCounterMode(display=False) as fc:
        run()
    per = F["translator"] if usage == "jacobian" else F["sdf"]
    got = fc.get_total_flops() / (M * per)
    assert abs(got - factor) <= tol * factor + 1e-9, got


@pytest.mark.parametrize("cell", WORKLOADS)
def test_step_flops_against_flop_counter_on_a_tiny_step(cell):
    """The whole step's count against ``FlopCounterMode`` over one of the
    port's steps (no remesh) at the tiny size. ``flops.py`` counts the
    live vertices; the port computes ② and the pc-sdf term over its whole
    vertex buffer (at least 2,048 rows), so with the buffer's rows in
    place of the live ones the two agree within 3% (the rest: the
    eikonal pass's 5.8 F against 6, and the GEMMs outside the MLPs, such
    as the skinner's)."""
    from torch.utils.flop_counter import FlopCounterMode

    from benchmark import scene

    c = tiny(cell)
    dev = torch.device("cpu")
    sd = scene.cached(c["config"], c["traffic"], dev)
    ds, net, order, _, gen, prog = bench_run.setup_program(c, 5, dev, sd,
                                                           bench_run.default_step, {})
    fids = next(order)
    batch = ds.get_batch(fids)
    with FlopCounterMode(display=False) as fc:
        _, info = net.train_step(batch, fids, c["traffic"]["ratio"], generator=gen)
    assert info["remeshed"] == 0.0
    rows = [v.shape[0] for v in net.mesh.garment_vs]
    got = fc.get_total_flops()
    assert flops.step_flops(c["config"], c["traffic"], rows) == pytest.approx(got, rel=0.03)
    live = flops.step_flops(c["config"], c["traffic"], prog["mesh"]["verts"])
    assert live < got


# --------------------------------------------------------------------------
# the reference against the port, and the faults
# --------------------------------------------------------------------------

def _run(cell, step_fn=None, seconds=0.5, trace=False):
    return bench_run.run_cell(tiny(cell), 2 ** 31 + 101, seconds, trace, torch.device("cpu"),
                              step_fn=step_fn)


@pytest.mark.parametrize("cell", WORKLOADS)
def test_reference_agrees_with_the_ports_step(cell):
    """On the CPU both sides run the same arithmetic (the kernels' plain
    versions): every number compared reads 0."""
    out = _run(cell)
    assert out["correct"] is True and out["failed"] == 0 and out["attempted"] >= 1
    assert all(c["value"] == 0.0 for c in out["check"].values()), out["check"]
    assert list(out)[:5] == ["correct", "attempted", "failed", "metrics", "device"]
    assert list(out)[-3] == "check"
    rd = out["_readings"]["program"]
    assert len(rd["steps"]) == 3 and rd["mesh"]["verts"][0] > 0
    assert set(rd["grad1"]) == set(rd["change"])
    assert out["metrics"]["step_s"]["value"] > 0


def _unchanged_step(net, batch, fids, ratio, generator, timer):
    keep = {k: v.detach().clone() for k, v in drive.state_leaves(net).items()}
    out = net.train_step(batch, fids, ratio, generator=generator, timer=timer)
    with torch.no_grad():
        for k, v in drive.state_leaves(net).items():
            if k in keep:
                v.copy_(keep[k])
    return out


def _altered_step(net, batch, fids, ratio, generator, timer):
    out = net.train_step(batch, fids, ratio, generator=generator, timer=timer)
    with torch.no_grad():
        p = net.params["translator"].lins[0].W
        p.add_(1e-3 * torch.ones_like(p))
    return out


@pytest.mark.parametrize("cell", WORKLOADS)
@pytest.mark.parametrize("fault", ["state_unchanged", "half_batch", "update_altered"])
def test_faults_make_correct_false(fault, cell):
    """Each fault that a one-chip training cell can have, planted under the
    timed path, makes ``correct`` false in every cell: a step that returns
    its state unchanged, half of the batch left out (the mean over the
    rest: half the frames, or half the rays of one frame), and an update
    altered where it is produced. (The exchange between chips does not
    exist on one chip.)"""
    from benchmark.calibrate import half_batch_step

    step = {"state_unchanged": _unchanged_step, "half_batch": half_batch_step,
            "update_altered": _altered_step}[fault]
    out = _run(cell, step_fn=step)
    assert out["correct"] is False
    failing = [k for k, c in out["check"].items() if c["value"] > c["limit"]]
    assert failing, out["check"]
    if fault == "state_unchanged":
        assert out["check"]["change_gap"]["value"] == pytest.approx(1.0)
    else:
        assert out["check"]["first_loss_gap"]["value"] > 0 or fault == "update_altered"


@pytest.mark.parametrize("cell", WORKLOADS)
def test_limits_lie_between_their_readings(cell):
    """Each limit is above the port's largest sound reading and below the
    smallest reading of the control or of a fault that counts (the mesh
    counts are exact: limit 0); a number left out has its readings and
    its reason."""
    with open(osp.join(ROOT, "benchmark", "limits", cell + ".json")) as f:
        d = json.load(f)
    lim = check.load_limits(cell)
    for k in lim:
        lo, up = d["readings"]["lower"][k], d["readings"]["upper"][k]
        assert lo <= lim[k] < up, (k, lo, lim[k], up)
        assert up >= 3 * lo
    for k, v in d.get("not_compared", {}).items():
        assert k not in d["readings"]["upper"] and v["readings"]["lower"] > 0 and v["why"]
    ok, rows = check.verdict(dict.fromkeys(check.NUMBERS, 0.0), lim)
    assert ok and [r["name"] for r in rows] == list(lim)
    bad = dict.fromkeys(check.NUMBERS, 0.0)
    bad["grad_gap"] = math.inf
    assert check.verdict(bad, lim)[0] is False


def test_readings_of_the_later_steps_and_the_rays():
    """The later steps' losses and the converged rays over the budget are
    read step by step; a record of another layout reads inf."""
    def rec(conv, loss):
        steps = [{"m_loss_total": l, "tube_rayConv": c, "tube_rayBudget": 100.0}
                 for c, l in zip(conv, loss)]
        return {"steps": steps, "grad1": {"a": 1.0, "b": 2.0}, "change": {"a": 1.0, "b": 1.0},
                "mesh": {"verts": [10], "faces": [20]}}

    v = check.readings(rec([90, 80, 70], [1.0, 2.0, 4.0]), rec([90, 85, 70], [1.0, 2.0, 5.0]))
    assert v["first_loss_gap"] == 0.0 and v["later_loss_gap"] == pytest.approx(0.2)
    assert v["ray_gap"] == pytest.approx(0.05) and v["mesh_gap"] == 0.0
    short = rec([90, 80], [1.0, 2.0])
    assert set(check.readings(short, rec([90, 80, 70], [1.0, 2.0, 4.0])).values()) == {math.inf}


def test_profiled_tail_stops_where_the_kernel_problems_go_unrecorded(monkeypatch):
    """Where the profiler sees K1–K3 launches that the wrapped prologues did
    not record, the traced run stops, so ``kernel_roofline_pct`` never
    drops out unseen; where neither sees any, the metric is left out."""
    from benchmark import trace
    from benchmark.metrics import kernel_roofline_pct

    def fake(counts):
        return lambda step, n, phases: {"kernel_counts": counts,
                                        "kernel_s": dict.fromkeys(counts, 0.0)}

    monkeypatch.setattr(trace, "profile_steps", fake({"K1": 3, "K2": 1, "K3": 1}))
    with pytest.raises(RuntimeError, match="kernel_roofline_pct"):
        bench_run.profile_tail(None, None, None, {}, None, None, 2)
    monkeypatch.setattr(trace, "profile_steps", fake({"K1": 0, "K2": 0, "K3": 0}))
    prof = bench_run.profile_tail(None, None, None, {}, None, None, 2)
    assert kernel_roofline_pct.read({"profile": prof}) is None


# --------------------------------------------------------------------------
# the import checks, by whole top-level name
# --------------------------------------------------------------------------

def test_forbidden_modules_compare_whole_top_level_names(monkeypatch):
    monkeypatch.setitem(sys.modules, "recmv_tpu_torch_fake", object())
    assert "recmv_tpu" not in bench_run.forbidden_modules()
    monkeypatch.setitem(sys.modules, "recmv_tpu.fake", object())
    assert bench_run.forbidden_modules() == ["recmv_tpu"]


BLOCK = """
import sys
class Block:
    def find_spec(self, name, path=None, target=None):
        if name.split(".")[0] in {blocked!r}:
            raise ImportError("blocked: " + name)
sys.meta_path.insert(0, Block())
sys.path.insert(0, {root!r})
"""


def _blocked(code: str, blocked, tmp_path) -> subprocess.CompletedProcess:
    src = BLOCK.format(blocked=sorted(blocked), root=ROOT) + code
    env = dict(os.environ, OMP_NUM_THREADS="4")
    return subprocess.run([sys.executable, "-c", src], cwd=str(tmp_path), env=env,
                          capture_output=True, text=True, timeout=600)


def test_reference_imports_nothing_of_the_port(tmp_path):
    """The reference builds and steps, and every scene module of
    ``benchmark/scenes/`` loads and writes its scene, with
    ``recmv_tpu_torch`` and JAX unimportable, and loads neither."""
    code = f"""
import importlib, pkgutil, torch, json
import benchmark.scenes
from benchmark.tests.test_benchmark_harness import crop_top_cell, tiny
from benchmark import scene
from benchmark.run import reference_record
from benchmark import drive
mods = [m.name for m in pkgutil.iter_modules(benchmark.scenes.__path__)]
for m in mods:
    importlib.import_module("benchmark.scenes." + m)
c = tiny("tube.fine_b1")
dev = torch.device("cpu")
sd = scene.generate({str(tmp_path)!r} + "/scene", c["config"], c["traffic"], dev)
rec = reference_record(c, 7, dev, sd, [[0], [1], [2]])
ct = crop_top_cell()
ct["traffic"].update(image=32, frames=2)
scene.generate({str(tmp_path)!r} + "/crop_top", ct["config"], ct["traffic"], dev)
rings = scene.curves(ct["config"])[0]
top = {{m.split(".")[0] for m in sys.modules}}
bad = sorted(top & {{"recmv_tpu_torch", "recmv_tpu", "jax", "jaxlib", "flax"}})
print(json.dumps({{"bad": bad, "steps": len(rec["steps"]), "scenes": sorted(mods),
                  "rings": sorted(rings)}}))
"""
    r = _blocked(code, {"recmv_tpu_torch", "recmv_tpu", "jax", "jaxlib", "flax"}, tmp_path)
    assert r.returncode == 0, r.stderr[-3000:]
    assert json.loads(r.stdout.strip().splitlines()[-1]) == {
        "bad": [], "steps": 3, "scenes": ["crop_top", "render"],
        "rings": ["bottom_curve", "neck"]}
    assert osp.isfile(osp.join(str(tmp_path), "crop_top", "scene_meta.json"))


def test_a_run_loads_no_jax(tmp_path):
    """A whole run (port and reference) with JAX and the JAX package
    unimportable, and none of them loaded at its end."""
    code = f"""
import torch, json
from benchmark.tests.test_benchmark_harness import tiny
from benchmark.run import run_cell, forbidden_modules
out = run_cell(tiny("tube.fine_b1"), 9, 0.2, False, torch.device("cpu"))
print(json.dumps({{"bad": forbidden_modules(), "correct": out["correct"]}}))
"""
    r = _blocked(code, {"recmv_tpu", "jax", "jaxlib", "flax"}, tmp_path)
    assert r.returncode == 0, r.stderr[-3000:]
    assert json.loads(r.stdout.strip().splitlines()[-1]) == {"bad": [], "correct": True}


def test_run_refuses_without_a_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for k in bench_run.THREAD_ENV:            # restored after the test
        monkeypatch.setenv(k, "4")
    assert bench_run.main(["--workload", "tube.fine_b1", "--seed", "1", "--seconds", "1",
                           "--trace", "0"]) == 3


@pytest.mark.gpu
def test_cell_runs_on_the_card():
    """One short run of the first cell on the card: the result line keeps
    to the contract and ``correct`` holds."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    r = subprocess.run([sys.executable, "benchmark/run.py", "--workload", WORKLOADS[0],
                        "--seed", str(2 ** 31 + 3), "--seconds", "3", "--trace", "0"],
                       cwd=ROOT, capture_output=True, text=True, timeout=1200)
    assert r.returncode == 0, r.stderr[-3000:]
    out = json.loads(r.stdout.strip().splitlines()[-1])
    assert out["correct"] is True and out["device"]["platform"] == "gpu"
    assert set(out["metrics"]) == {"step_s", "setup_s"}
