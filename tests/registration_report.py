"""One mesh registered by both packages, stage by stage, on the CPU.

    python tests/registration_report.py [--configs two skirt] [--scene-dir DIR]
        [--init-epochs 40] [--ckpt PATH] [--threads 4] [--reuse] [--dump DIR]
        [--no-score] [--out report.json]

For each configuration (``quality_vs_records``' two-garment and skirt
scenes: 8 frames at 256², the pyramid → (65, 97, 49), the JAX tool's
network) the JAX package builds the scene and its network as
``tools/bench_quality.py`` does and initializes it with a short
``initialize_tmp_sdf`` (``--init-epochs`` IGR epochs, the tool's 150
curve-fit iterations; cached in the scene as
``result/report_init_e<N>.ckpt``), or loads ``--ckpt`` (a state of either
package, e.g. ``jax_reference --export``'s ``jax_final.ckpt``). The port
reads that checkpoint (the same parameters, curves and registered
templates) and takes the JAX network's marching-cubes mesh
(``bridge.load_mesh``). Then ``ensure_registration`` runs with the quick
NRICP schedules (``bench_quality.quick_schedules``), the waist sewing on,
six ways:

(a) the JAX package as its CPU records ran it: its visibility scan takes
    the XLA mesh z-buffer, whose tile binning keeps the nearest 512 faces
    by bf16 depth (ties to the lower face index, no span limit);
(b) the JAX package with the port's scan mask injected (its
    ``visible_vertex_mask`` replaced by the port's result on the same
    mesh; no JAX file touched);
(c) the port on the CPU (its scan bins as the TPU's Pallas path does);
(d) (b) again with its Laplacian alignment's result moved by 1e-6
    (``NUDGE``): the spread of the JAX registration itself, whose NRICP
    passes turn last-bit differences into millimetres;
(e) the port fed the JAX package's (b) outputs stage by stage: its
    Laplacian alignment replaced by the JAX one, its remesh given the JAX
    coarse fit, so each of its NRICP passes starts from the JAX input;
(f) (b) with the port's Laplacian alignment in place of its own: what
    the two float32 solves' difference alone does downstream.

Per garment and stage it reports the scan's tiles at the cap (the port's
binning) and its visible vertices, (a) against (c); each package's
Laplacian alignment against a float64 solve of the same system; NRICP
coarse and refine, each package chaining its own outputs, as the largest
vertex difference (b)−(c), (a)−(c) and (d)−(b) where the two meshes share their
faces, else the mean and largest distance from one to the other; the
registered mesh's mean distance to the marching-cubes target and back;
(e)'s NRICP passes against (b)'s on the same inputs; and the scores of
(a)–(f) after one and the same export and scoring:
the port's ``infer_garment(images=False, colors=False)`` and
``bench_quality.frame_scores`` (``chamfer_l2_sym_mean``, each garment's
one-sided distance), so only the registration differs. (b) against (c)
shows whether the port registers as the JAX package does, beside (d)
against (b), how far the JAX package parts from itself, and (f) against
(c), whether the Laplacian's rounding carries the difference; (a)
against (b) shows what the yardstick's XLA scan changes. ``--reuse`` scores the
registrations an earlier run kept; ``--dump`` writes one mesh's inputs
and the JAX stage outputs for ``tests/registration_card.py``, which holds
the port's registration on the card against them.

Needs both packages (JAX on the CPU); not a test. Pin it with ``taskset``
beside other work: XLA sizes its pool to the cores it may use.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import os
import os.path as osp
import shutil
import sys
import time

HERE = osp.dirname(osp.abspath(__file__))
sys.path[:0] = [HERE, osp.dirname(HERE)]

import conftest  # noqa: E402,F401  (JAX on the CPU)
import numpy as np  # noqa: E402
import torch  # noqa: E402

from jax_reference import scene_of  # noqa: E402
from recmv_tpu_torch.tools import bench_quality as bq  # noqa: E402

CONFIGS = ("two", "skirt")
CPU = torch.device("cpu")
NUDGE = 1e-6               # (d): the JAX Laplacian's result moved by this much
KINDS = "abcdef"           # the registrations (module docstring)


def build_jax(name: str, scene_dir: str, init_epochs: int, ckpt: str | None):
    """The JAX tool's scene and network for configuration ``name``
    (``tools/bench_quality.py``'s construction), initialized or loaded →
    (scene, net, checkpoint path the port reads)."""
    from recmv_tpu.config import ConfigFactory
    from recmv_tpu.core.builder import build_opt_net
    from recmv_tpu.core.network import TrainConfig
    from recmv_tpu.data.dataset import get_dataset_and_loader
    from recmv_tpu.data.synthetic import ensure_scene
    from recmv_tpu_torch.tools import REPO
    from recmv_tpu_torch.tools.bench_quality import RES, SKINNER_RES

    leaf, image, frames, garment_type = scene_of(name)
    scene = osp.join(scene_dir, leaf)
    ensure_scene(scene, n_frames=frames, image_size=image, skinner_res=SKINNER_RES,
                 garment_type=garment_type)
    conf_name = {"synthetic-two": "smoke_two.conf", "synthetic-skirt": "smoke_skirt.conf"}
    conf = ConfigFactory.parse_file(osp.join(REPO, "configs", "synthetic",
                                             conf_name[garment_type]))
    n_g = 2 if garment_type == "synthetic-two" else 1
    dataset, _ = get_dataset_and_loader(
        scene, {"deformer": 256 * (1 + n_g) // 2, "render": 256}, 2, shuffle=True,
        garment_type=garment_type, data_type="synthe")
    cfg = TrainConfig(
        sample_pix=1024, point_radius=conf.get_float("train.coarse.point_render.radius", 0.02),
        remesh_intersect=conf.get_int("train.coarse.point_render.remesh_intersect", 16),
        batch_size=2, image_size=(image, image), mc_capacity_v=1 << 14, mc_capacity_f=1 << 15,
        raster_tile=32, raster_cap_mesh=256, raster_cap_points=256, points_per_pixel=8,
        solver_times=10, surface_sample=512, curve_lr=1e-4)
    net = build_opt_net(conf, dataset, osp.join(scene, "result"), resolutions=RES,
                        skinner_res=SKINNER_RES, train_cfg=cfg)
    if ckpt is None:
        ckpt = osp.join(scene, "result", f"report_init_e{init_epochs}.ckpt")
        if not osp.isfile(ckpt):
            net.initialize_tmp_sdf(nepochs=init_epochs, save_dir=None, fl_iters=150)
            net.save_checkpoint(ckpt, 0)
    net.load_checkpoint(ckpt)
    return scene, net, ckpt


def build_port(name: str, scene: str, ckpt: str, net_j):
    """The port's network on the same scene, from the same checkpoint, on
    the JAX network's marching-cubes mesh."""
    from recmv_tpu_torch import bridge
    from recmv_tpu_torch.core.network import _ratio_dict

    leaf, image, frames, garment_type = scene_of(name)
    args = bq.parse_args(["--garment-type", garment_type, "--image", str(image),
                          "--frames", str(frames), "--device", "cpu",
                          "--scene", scene[: -len(leaf)] + name])
    # the port's build reads the JAX scene as it stands: its own
    # scene_meta.json beside the JAX one keeps ensure_scene from regenerating it
    from recmv_tpu_torch.data.synthetic import _scene_meta

    with open(osp.join(scene, "scene_meta.json"), "w") as f:
        json.dump(_scene_meta(frames, image, 2 * np.pi, bq.SKINNER_RES, 1024, garment_type), f)
    port_scene, _, dataset, _, net_t = bq.build(args, CPU)
    assert port_scene == scene, (port_scene, scene)
    net_t.load_checkpoint(ckpt)
    net_t.marching_cube_update(_ratio_dict(bq.final_ratio(net_t)))
    bridge.load_mesh(net_t, net_j.mesh.garment_vs, net_j.mesh.garment_fs,
                     net_j.mesh.garment_n, net_j.mesh.garment_fn)
    return net_t, dataset


@contextlib.contextmanager
def instrumented(mod, rec: dict, names, scan=None, schedules=None, nudge=0.0, feed=None):
    """Record, per garment (in registration order), the stages that
    ``mod.register_garment`` runs: the Laplacian's arguments and result,
    the scan mask, each NRICP pass's input and output, the remesh; with
    ``scan`` the scan returns ``scan[garment]`` in place of its own; with
    ``schedules`` (coarse, refine) ``register_garment`` takes them, as the
    JAX tool's monkeypatch gives them; ``nudge`` is added to every
    coordinate of the Laplacian's result; ``feed[garment]`` replaces the
    Laplacian's result (``"laplacian"``) and the remesh's input
    (``"coarse"``) by another registration's."""
    feed = feed or {}
    orig = {k: getattr(mod, k) for k in ("laplacian_deform", "visible_vertex_mask",
                                        "nricp_fit", "remesh_registered", "register_garment")}
    order = iter(names)
    cur = {}

    def register(*a, **kw):
        cur["g"] = next(order)
        rec[cur["g"]] = {"nricp": []}
        if schedules is not None:
            kw.setdefault("nricp_cfg", schedules[0])
            kw.setdefault("refine_cfg", schedules[1])
        return orig["register_garment"](*a, **kw)

    def lap(*a, **kw):
        out = orig["laplacian_deform"](*a, **kw)
        if "laplacian" in feed.get(cur["g"], {}):
            out = torch.as_tensor(feed[cur["g"]]["laplacian"])
        elif nudge:
            out = torch.as_tensor(np.asarray(out) + np.float32(nudge))
        rec[cur["g"]]["laplacian"] = (a, np.asarray(out))
        return out

    def vis(v, f, **kw):
        t0 = time.time()
        m = scan[cur["g"]] if scan is not None else np.asarray(
            orig["visible_vertex_mask"](v, f, **kw))
        rec[cur["g"]]["scan"] = (np.asarray(m, bool), time.time() - t0)
        return m

    def fit(src, *a, **kw):
        out = orig["nricp_fit"](src, *a, **kw)
        rec[cur["g"]]["nricp"].append((np.asarray(src), np.asarray(out)))
        return out

    def remesh(*a, **kw):
        if "coarse" in feed.get(cur["g"], {}):
            a = (feed[cur["g"]]["coarse"],) + a[1:]
        out = orig["remesh_registered"](*a, **kw)
        rec[cur["g"]]["remesh"] = (np.asarray(out[0]), np.asarray(out[1]))
        return out

    for k, fn in (("laplacian_deform", lap), ("visible_vertex_mask", vis),
                  ("nricp_fit", fit), ("remesh_registered", remesh),
                  ("register_garment", register)):
        setattr(mod, k, fn)
    try:
        yield rec
    finally:
        for k, fn in orig.items():
            setattr(mod, k, fn)


@contextlib.contextmanager
def scan_tiles(calls: list):
    """Note the tiles at the cap of every K1 call of the port (its plain
    version on the CPU) while the context is open."""
    from recmv_tpu_torch.ops import rasterizer

    orig = rasterizer.mesh_tiles

    def call(prm, fid, cnt, Wt, tile):
        B, T, _, cap = prm.shape
        calls.append({"views": B, "tiles": B * T, "cap": cap,
                      "at_cap": int((cnt >= cap).sum())})
        return orig(prm, fid, cnt, Wt, tile)

    rasterizer.mesh_tiles = call
    try:
        yield calls
    finally:
        rasterizer.mesh_tiles = orig


def register_jax(net_j, out_dir: str, rec: dict, scan=None, nudge=0.0, feed=None) -> dict:
    """(a) or, with ``scan``, (b) and, with ``nudge`` or ``feed`` too, (d)
    or (f): the JAX ``ensure_registration`` with the quick schedules →
    {garment: (v, f)}."""
    import dataclasses

    from recmv_tpu.core import inference as jinf
    from recmv_tpu.geometry.nricp import NricpConfig
    from recmv_tpu_torch.tools.bench_quality import quick_schedules

    schedules = tuple(NricpConfig(**dataclasses.asdict(c)) for c in quick_schedules())
    shutil.rmtree(out_dir, ignore_errors=True)
    inf = jinf.GarmentInference(net_j)
    with instrumented(jinf, rec, list(net_j.statics.garment_names), scan, schedules, nudge,
                      feed):
        inf.ensure_registration(bq.final_ratio(net_j), out_dir)
    return {g: (np.asarray(v, np.float32), np.asarray(f)) for g, (v, f) in inf.registered.items()}


def register_port(net_t, out_dir: str, rec: dict, tiles: list, scan=None,
                  feed=None) -> dict:
    """(c) or, with ``scan`` and ``feed``, (e): the port's
    ``ensure_registration`` with the quick schedules."""
    from recmv_tpu_torch.core import inference as tinf
    from recmv_tpu_torch.tools.bench_quality import quick_schedules

    shutil.rmtree(out_dir, ignore_errors=True)
    inf = tinf.GarmentInference(net_t)
    coarse, refine = quick_schedules()
    with instrumented(tinf, rec, list(net_t.statics.garment_names), scan, feed=feed), \
            scan_tiles(tiles):
        inf.ensure_registration(bq.final_ratio(net_t), out_dir, nricp_cfg=coarse, refine_cfg=refine)
    return {g: (np.asarray(v, np.float32), np.asarray(f)) for g, (v, f) in inf.registered.items()}


def mean_max_dist(a, b) -> tuple:
    """Mean and largest distance from each point of ``a`` to its nearest in
    ``b``."""
    from recmv_tpu_torch.tools.bench_quality import _knn

    d = np.sqrt(np.maximum(np.asarray(_knn(np.asarray(a, np.float32),
                                            np.asarray(b, np.float32), CPU)[0]), 0.0))
    return float(d.mean()), float(d.max())


def mesh_gap(a, b) -> dict:
    """Two registrations of one stage, (vertices, faces or None when both
    have the template's): the largest vertex difference where they share
    their faces (``same_faces``), and both ways the mean and
    largest distance from one's vertices to the other's."""
    (va, fa), (vb, fb) = a, b
    out = {"same_faces": bool(va.shape == vb.shape and (fa is None or np.array_equal(fa, fb)))}
    if out["same_faces"]:
        out["max_vertex_diff"] = float(np.abs(va - vb).max())
    out["mean_max_to"] = mean_max_dist(va, vb)
    out["mean_max_back"] = mean_max_dist(vb, va)
    return out


def stage_report(recs: dict, regs: dict, mc: dict, tiles: list) -> dict:
    """Per garment: the stages of (a), (b), (c) side by side (module
    docstring)."""
    from test_torch_registration import _laplacian_f64

    out = {}
    for gi, g in enumerate(mc):
        ra, rb, rc, rd = (recs[k][g] for k in "abcd")
        ma, mc_ = ra["scan"][0], rc["scan"][0]
        lap_args = rc["laplacian"][0]
        ref = _laplacian_f64(*lap_args[:4])
        rep = {
            "mc_vertices": int(len(mc[g][0])), "mc_faces": int(len(mc[g][1])),
            "scan": {"tiles": tiles[gi]["tiles"], "cap": tiles[gi]["cap"],
                     "tiles_at_cap": tiles[gi]["at_cap"],
                     "visible_a_xla": int(ma.sum()), "visible_c_port": int(mc_.sum()),
                     "a_not_c": int((ma & ~mc_).sum()), "c_not_a": int((mc_ & ~ma).sum()),
                     "seconds_a": round(ra["scan"][1], 1), "seconds_c": round(rc["scan"][1], 1)},
            "laplacian_vs_f64": {k: float(np.abs(r["laplacian"][1] - ref).max())
                                 for k, r in (("a", ra), ("b", rb), ("c", rc))},
            "laplacian_a_vs_c": float(np.abs(ra["laplacian"][1] - rc["laplacian"][1]).max()),
            "template_vertices": int(len(lap_args[0])),
            "laplacian_same_system": all(
                np.array_equal(np.asarray(x), np.asarray(y))
                for x, y in zip(ra["laplacian"][0][:4], lap_args[:4])),
        }
        # coarse: the template's faces in all three; refine: each one's remesh
        faces = {k: r["remesh"][1] for k, r in (("a", ra), ("b", rb), ("c", rc), ("d", rd))}
        for stage, idx in (("nricp_coarse", 0), ("nricp_refine", 1)):
            rep[stage] = {}
            for pair, x, y in (("b_vs_c", rb, rc), ("a_vs_c", ra, rc), ("d_vs_b", rd, rb)):
                fx, fy = (faces[pair[0]], faces[pair[-1]]) if idx else (None, None)
                rep[stage][pair] = mesh_gap((x["nricp"][idx][1], fx), (y["nricp"][idx][1], fy))
            rep[stage]["moved"] = {k: float(np.abs(r["nricp"][idx][1]
                                                   - r["nricp"][idx][0]).max())
                                   for k, r in (("a", ra), ("b", rb), ("c", rc))}
        re_ = recs["e"][g]
        rep["fed_jax_stage_outputs"] = {
            "nricp_coarse_max_diff": float(np.abs(re_["nricp"][0][1] - rb["nricp"][0][1]).max()),
            "remesh_same": bool(np.array_equal(re_["remesh"][1], rb["remesh"][1])
                                and np.array_equal(re_["remesh"][0], rb["remesh"][0])),
            "nricp_refine_max_diff": (
                float(np.abs(re_["nricp"][1][1] - rb["nricp"][1][1]).max())
                if re_["nricp"][1][1].shape == rb["nricp"][1][1].shape else None)}
        rep["remesh_same_faces_b_c"] = bool(np.array_equal(rb["remesh"][1], rc["remesh"][1]))
        rep["registered"] = {}
        for k in ("a", "b", "c"):
            v = regs[k][g][0]
            to_mc, back = mean_max_dist(v, mc[g][0]), mean_max_dist(mc[g][0], v)
            rep["registered"][k] = {"vertices": int(len(v)), "to_mc_mean": to_mc[0],
                                    "mc_to_it_mean": back[0]}
        out[g] = rep
    return out


def dump_for_card(path: str, mc: dict, recs: dict, regs: dict) -> None:
    """The inputs and the JAX (b) stage outputs of each garment's
    registration, and the final (b) and (c) meshes, for
    ``tests/registration_card.py`` (the port's registration on the card,
    held against them)."""
    out = {}
    for g, r in recs["b"].items():
        lap_args = r["laplacian"][0]
        out.update({f"{g}/mc_v": mc[g][0], f"{g}/mc_f": mc[g][1],
                    f"{g}/lap_verts": lap_args[0], f"{g}/lap_faces": lap_args[1],
                    f"{g}/lap_cids": lap_args[2], f"{g}/lap_targets": lap_args[3],
                    f"{g}/mask": recs["c"][g]["scan"][0],
                    f"{g}/b_lap": r["laplacian"][1], f"{g}/b_coarse": r["nricp"][0][1],
                    f"{g}/b_remesh_v": r["remesh"][0], f"{g}/b_remesh_f": r["remesh"][1],
                    f"{g}/b_refine": r["nricp"][1][1]})
        for k in "bc":
            out[f"{g}/{k}_v"], out[f"{g}/{k}_f"] = regs[k][g]
    os.makedirs(osp.dirname(osp.abspath(path)), exist_ok=True)
    np.savez_compressed(path, **out)
    print(f"[registration] dumped {path}", flush=True)


def run_config(name: str, args) -> dict:
    from recmv_tpu_torch.geometry.mesh_utils import largest_component

    t0 = time.time()
    scene, net_j, ckpt = build_jax(name, args.scene_dir, args.init_epochs, args.ckpt)
    net_j.mesh = None
    net_j.marching_cube_update(net_j._ratio_dict(bq.final_ratio(net_j)))
    net_t, dataset = build_port(name, scene, ckpt, net_j)
    names = list(net_j.statics.garment_names)
    mc = {}
    for gi, g in enumerate(names):
        n, nf = net_j.mesh.garment_n[gi], net_j.mesh.garment_fn[gi]
        mc[g] = largest_component(np.asarray(net_j.mesh.garment_vs[gi])[:n],
                                  np.asarray(net_j.mesh.garment_fs[gi])[:nf])
    secs = {"setup": round(time.time() - t0, 1)}
    work = osp.join(scene, "result",
                    "registration_report_" + osp.splitext(osp.basename(ckpt))[0])
    cached = osp.join(work, "registrations.npz")
    if args.reuse and osp.isfile(cached):
        with open(osp.join(work, "stages.json")) as f:
            report = json.load(f)
        with np.load(cached) as z:
            regs = {k: {g: (z[f"{k}_{g}_v"], z[f"{k}_{g}_f"]) for g in names}
                    for k in KINDS}
    else:
        recs, regs, tiles = {k: {} for k in KINDS}, {}, []
        scan = {}
        for k, fn in (
                ("c", lambda: register_port(net_t, osp.join(work, "c"), recs["c"], tiles)),
                ("a", lambda: register_jax(net_j, osp.join(work, "a"), recs["a"])),
                ("b", lambda: register_jax(net_j, osp.join(work, "b"), recs["b"], scan)),
                ("d", lambda: register_jax(net_j, osp.join(work, "d"), recs["d"], scan,
                                           NUDGE)),
                ("e", lambda: register_port(net_t, osp.join(work, "e"), recs["e"], [], scan, {
                    g: {"laplacian": r["laplacian"][1], "coarse": r["nricp"][0][1]}
                    for g, r in recs["b"].items()})),
                ("f", lambda: register_jax(net_j, osp.join(work, "f"), recs["f"], scan, feed={
                    g: {"laplacian": r["laplacian"][1]} for g, r in recs["c"].items()}))):
            t0 = time.time()
            regs[k] = fn()
            scan.update({g: r["scan"][0] for g, r in recs["c"].items()})
            secs[f"register_{k}"] = round(time.time() - t0, 1)
            print(f"[registration] {name} ({k}) registered in {secs[f'register_{k}']} s",
                  flush=True)
        scan_calls = [c for c in tiles if c["views"] == 12]
        report = {"config": name, "scene": osp.basename(scene), "ckpt": osp.basename(ckpt),
                  "init_epochs": None if args.ckpt else args.init_epochs,
                  "stages": stage_report(recs, regs, mc, scan_calls), "scores": {}}
        np.savez(cached, **{f"{k}_{g}_{x}": a for k in KINDS for g in names
                            for x, a in zip("vf", regs[k][g])})
        with open(osp.join(work, "stages.json"), "w") as f:
            json.dump(report, f, indent=1)
        print(f"[registration] {name} stages: {json.dumps(report['stages'])}", flush=True)
        if args.dump:
            dump_for_card(osp.join(args.dump, f"{name}.npz"), mc, recs, regs)
    if args.no_score:
        return report
    for k in KINDS:
        t0 = time.time()
        out_dir = osp.join(work, f"export_{k}")
        shutil.rmtree(out_dir, ignore_errors=True)
        report["scores"][k] = bq.score_registered(net_t, bq.final_ratio(net_t), scene, dataset,
                                                  regs[k], out_dir, CPU)
        secs[f"score_{k}"] = round(time.time() - t0, 1)
        print(f"[registration] {name} ({k}) {json.dumps(report['scores'][k])}", flush=True)

    def ratio(x, y):
        sx, sy = report["scores"][x], report["scores"][y]
        return {"chamfer_l2_sym_mean": sx["chamfer_l2_sym_mean"] / sy["chamfer_l2_sym_mean"],
                **{g: sx["per_garment_pred_to_gt"][g] / sy["per_garment_pred_to_gt"][g]
                   for g in names}}

    report["ratios"] = {"b_over_c": ratio("b", "c"), "a_over_b": ratio("a", "b"),
                        "d_over_b": ratio("d", "b"), "e_over_b": ratio("e", "b"),
                        "f_over_b": ratio("f", "b"), "f_over_c": ratio("f", "c")}
    report["seconds"] = secs
    return report


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--configs", nargs="+", default=list(CONFIGS), choices=list(CONFIGS))
    ap.add_argument("--scene-dir", default=osp.join(HERE, "..", "recmv_tpu_torch", "_bench",
                                                    "registration_report"))
    ap.add_argument("--init-epochs", type=int, default=40)
    ap.add_argument("--ckpt", default=None, help="a checkpoint to register in place of the "
                                                 "short initialization (one configuration)")
    ap.add_argument("--threads", type=int, default=4, help="torch's intra-op threads")
    ap.add_argument("--reuse", action="store_true",
                    help="score the registrations that an earlier run kept for this scene "
                         "and checkpoint (result/registration_report_<ckpt>/)")
    ap.add_argument("--dump", default=None, metavar="DIR",
                    help="write DIR/<config>.npz for tests/registration_card.py")
    ap.add_argument("--no-score", action="store_true", help="register only")
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    if args.ckpt and len(args.configs) != 1:
        ap.error("--ckpt takes one configuration")
    torch.set_num_threads(args.threads)
    out = {}
    for name in args.configs:
        out[name] = run_config(name, args)
        print(f"[registration] {name}: {json.dumps(out[name])}", flush=True)
        if args.out:
            with open(args.out, "w") as f:
                json.dump(out, f, indent=1)
    return out


if __name__ == "__main__":
    main()
