"""Chamfer quality of the whole loop on a synthetic scene (counterpart of
the repo's ``tools/bench_quality.py``).

Generates (or reuses) a synthetic scene whose GT garment meshes are known
per frame, then runs the port's pipeline: the initialization (curve fit,
Laplacian registration, IGR fits) → training steps with the
coarse → medium → fine switches at 40% and 75% of the run (from 100 steps
on) → the template registration (Laplacian + NRICP + remesh) → per-frame
posed garment exports, and scores the exports against ``gt_meshes/``:
the symmetric chamfer against the GT's lateral surface (``chamfer_l2_sym``),
against the closed solid, the one-sided mean distance, per garment, and the
two-garment waist seam gap. During training it probes the posed MC mesh
and a fresh extraction against the GT (``mc_pred_to_gt_trend``,
``mc_fresh_to_gt_trend``) every 10% of the steps and around the switches,
with the canonical-space diagnostics.

    python -m recmv_tpu_torch.tools.bench_quality --image 512 --frames 8 \\
        --steps 500 --init-epochs 400 --occlusion-gate --production-nricp \\
        --curve-lr 1e-3 --seed 0 --out recmv_tpu_torch/_bench/q_tube_s0.json

Same flags and output keys as the JAX tool, with these changes:
``--device`` (default ``cuda``; ``cpu`` for the tests) replaces
``--platform``; ``--seed`` seeds the model's initialization, the sampler and
the ``torch.Generator`` of the initialization and of ``train_step``; the
quick NRICP schedules go to ``GarmentInference.ensure_registration`` (the
JAX tool monkeypatches ``register_garment``); ``--freeze-pose`` freezes the
poses, translations and every camera leaf (the JAX tool's flag raises a
``TypeError`` in ``trainable_mask``). Scenes and records go under
``recmv_tpu_torch/_bench/``; the initialization is cached per scene and
seed (``result/quality_init_s<seed>.ckpt``). The record adds the final
canonical diagnostics (``canonical_diag_final``) and the curve fit of a
fresh initialization (``init_curve_fit``).

The scorers and probes are module functions (``gt_surface``,
``gt_piece_surface``, ``pose_to_gt``, ``mc_pred_to_gt``, ``mc_fresh_to_gt``,
``canonical_diag``, ``scene_drift``, ``frame_scores``, ``seam_gap``) and
return unrounded values; the record rounds them as the JAX tool does.
"""

from __future__ import annotations

import argparse
import glob
import os.path as osp
import time

import numpy as np
import torch

from . import REPO, bench_path, device_record, sync, write_record

# queries per KNN chunk: (chunk × 100k GT samples) f32 distances, 1.6 GB on
# the card; small on the CPU, where the tests run it (same results)
KNN_CHUNK = {"cuda": 4096, "cpu": 256}
GT_SAMPLES = 100_000       # GT surface samples a frame is scored against
CANO_SAMPLES = 50_000      # canonical GT samples of a garment piece
RES = ((9, 13, 7), (17, 25, 13), (33, 49, 25), (65, 97, 49))     # the bench's pyramid
SKINNER_RES = (33, 57, 17)


def _f32(a, device) -> torch.Tensor:
    return torch.as_tensor(a, dtype=torch.float32, device=device)


def _knn(query, ref, device):
    """The nearest point of ``ref`` to each of ``query`` → (squared
    distances (Q, 1), indices (Q, 1)). The distances are recomputed from
    the coordinate differences: ``knn``'s expansion rounds relative to
    ‖q‖², which on mm-scale distances moved a mean distance by 1e-5
    relative."""
    from ..ops.knn import knn

    q, r = _f32(query, device), _f32(ref, device)
    _, idx = knn(q, r, 1, chunk=KNN_CHUNK[torch.device(device).type])
    return ((q - r[idx[:, 0]]) ** 2).sum(-1, keepdim=True), idx


def _rms(query, ref, device) -> float:
    """√(mean squared nearest distance) from ``query`` to ``ref``."""
    d2, _ = _knn(query, ref, device)
    return float(torch.sqrt(d2.mean()))


def _mean_dist(query, ref, device) -> float:
    """Mean nearest distance from ``query`` to ``ref``."""
    d2, _ = _knn(query, ref, device)
    return float(torch.sqrt(d2).mean())


def _chamfer(a, b, device) -> float:
    from ..ops.knn import chamfer_distance

    return float(chamfer_distance(_f32(a, device), _f32(b, device),
                                  chunk=KNN_CHUNK[torch.device(device).type]))


# ---------------------------------------------------------------------------
# the GT surfaces
# ---------------------------------------------------------------------------

def gt_surface(scene: str, fid: int, n: int = 100_000, lateral_only: bool = False) -> np.ndarray:
    """Dense area-weighted sample (seed ``fid``) of frame ``fid``'s GT
    surface: the raw GT mesh is coarse (~1 cm spacing), so distances to its
    vertices carry a discretization floor. ``lateral_only`` drops the CSG
    solid's flat end caps (|n_y| ≥ 0.95): a garment is an open surface."""
    from ..geometry.mesh_utils import sample_mesh_surface

    z = np.load(osp.join(scene, "gt_meshes", f"{fid}.npz"))
    verts, faces = z["verts"], z["faces"]
    if lateral_only:
        fn = np.cross(verts[faces[:, 1]] - verts[faces[:, 0]],
                      verts[faces[:, 2]] - verts[faces[:, 0]])
        fn /= np.maximum(np.linalg.norm(fn, axis=1, keepdims=True), 1e-12)
        faces = faces[np.abs(fn[:, 1]) < 0.95]
    return sample_mesh_surface(verts, faces, n, seed=fid)[0]


def gt_piece_surface(scene: str, fid: int, gname: str, n: int = 100_000) -> np.ndarray:
    """Area-weighted surface sample (seed ``fid``) of one garment piece of
    frame ``fid``'s GT."""
    from ..geometry.mesh_utils import sample_mesh_surface

    z = np.load(osp.join(scene, "gt_meshes", f"{fid}.npz"))
    names = [str(s) for s in z["piece_names"]]
    sizes = list(z["piece_sizes"])
    lo = sum(sizes[:names.index(gname)])
    hi = lo + sizes[names.index(gname)]
    vmask = np.zeros(len(z["verts"]), bool)
    vmask[lo:hi] = True
    keep = z["faces"][vmask[z["faces"]].all(1)] - lo
    return sample_mesh_surface(z["verts"][lo:hi], keep, n, seed=fid)[0]


# ---------------------------------------------------------------------------
# probes during training
# ---------------------------------------------------------------------------

def pose_to_gt(net, vs, fid: int, ratio, gt) -> float:
    """RMS distance from canonical garment vertices ``vs`` (n, 3), posed at
    frame ``fid`` by the garment's deformer, to the GT sample ``gt``."""
    with torch.no_grad():
        posed = net._deform_garment_verts([_f32(vs, net.device)], torch.as_tensor([fid], device=net.device),
                                          ratio)[0][0]
        return _rms(posed, gt, net.device)


def mc_pred_to_gt(net, ratio, gt, fid: int = 0) -> float:
    """Convergence probe: the live vertex-SGD mesh of garment 0 posed at
    ``fid`` against the GT sample (no registration)."""
    if net.mesh is None:
        net.marching_cube_update(ratio)
    return pose_to_gt(net, net.mesh.garment_vs[0][:net.mesh.garment_n[0]], fid, ratio, gt)


def fresh_meshes(net, ratio) -> list:
    """Fresh marching-cubes extractions of the garment SDFs (the state is
    untouched): per garment (verts (n, 3), faces) numpy."""
    return [(v.cpu().numpy(), f.cpu().numpy())
            for v, f in net.discretize_sdf(ratio, -net.sdf_shrink, include_body=False)]


def mc_fresh_to_gt(net, ratio, gt, fid: int = 0, meshes=None) -> float:
    """The probe on a fresh extraction of garment 0 (``meshes`` from
    ``fresh_meshes``, made when not given): separates SDF drift from the
    vertex-SGD drag."""
    meshes = fresh_meshes(net, ratio) if meshes is None else meshes
    return pose_to_gt(net, meshes[0][0], fid, ratio, gt)


def canonical_gt(garment_type: str) -> tuple:
    """(pieces, canonical GT samples per piece, GT boundary rings per curve)
    of a synthetic garment type."""
    from ..data.synthetic import SCENE_CURVES, SCENE_GARMENTS, boundary_ring, garment_mesh
    from ..geometry.mesh_utils import sample_mesh_surface

    pieces = SCENE_GARMENTS[garment_type]
    gt_cano = {}
    for gname, off, band, _ in pieces:
        gv, gf = garment_mesh(res=129, offset=off, band=band)
        gt_cano[gname] = np.asarray(sample_mesh_surface(gv, gf, CANO_SAMPLES, seed=0)[0],
                                    np.float32)
    rings = {name: np.asarray(boundary_ring(ylv, offset=off), np.float32)
             for name, ylv, off in SCENE_CURVES[garment_type]}
    return pieces, gt_cano, rings


def canonical_diag(net, ratio, pieces, gt_cano, gt_rings, step, meshes=None) -> dict:
    """Canonical-space diagnostics (no pose, no registration): per garment
    the RMS of the fresh extraction to its canonical GT and the mean radial
    error in 4 height bands of the garment's band (positive = inside the
    GT, collapsed; negative = outside, inflated); per curve its RMS to the
    GT ring and the mean radius and height of both. Printed and returned."""
    from ..models.curves import curves_forward

    meshes = fresh_meshes(net, ratio) if meshes is None else meshes
    out = {}
    for gi, (gname, _, band, _) in enumerate(pieces):
        vs = np.asarray(meshes[gi][0], np.float32)
        gt = gt_cano[gname]
        d2, idx = _knn(vs, gt, net.device)
        d2, idx = d2[:, 0].cpu().numpy(), idx[:, 0].cpu().numpy()
        rad = vs.copy()
        rad[:, 1] = 0.0
        rad /= np.maximum(np.linalg.norm(rad, axis=1, keepdims=True), 1e-9)
        rc = ((gt[idx] - vs) * rad).sum(1)
        q = np.linspace(band[0], band[1], 5)
        prof = []
        for a, b in zip(q[:-1], q[1:]):
            m = (vs[:, 1] >= a) & (vs[:, 1] < b)
            prof.append(float(rc[m].mean()) if m.any() else None)
        out[gname] = {"cano_rms": float(np.sqrt(d2.mean())), "radial": prof}
        print(f"[diag] step {step} {gname}: cano rms {out[gname]['cano_rms']:.4f} radial(in+) "
              f"lo→hi {[None if p is None else round(p, 4) for p in prof]}", flush=True)
    if not net.params.get("curves"):
        return out
    with torch.no_grad():
        cv = curves_forward(net.params["curves"], net.curve_statics).cpu().numpy()
    for ci, cn in enumerate(net.curve_statics.fl_names):
        if cn not in gt_rings:
            continue
        ring = gt_rings[cn]
        rec = {"rms": _rms(cv[ci], ring, net.device),
               "r_pred": float(np.linalg.norm(cv[ci][:, [0, 2]], axis=1).mean()),
               "r_gt": float(np.linalg.norm(ring[:, [0, 2]], axis=1).mean()),
               "y_pred": float(cv[ci][:, 1].mean()), "y_gt": float(ring[:, 1].mean())}
        out[f"curve {cn}"] = rec
        print(f"[diag] step {step} curve {cn}: rms {rec['rms']:.4f} mean-r pred "
              f"{rec['r_pred']:.4f} gt {rec['r_gt']:.4f} y pred {rec['y_pred']:+.4f} gt "
              f"{rec['y_gt']:+.4f}", flush=True)
    return out


def scene_drift(net, gt_scene: dict, step) -> dict:
    """Largest movement of the poses, translations and camera leaves from
    their GT values (the synthetic scenes start at the exact ones)."""
    sc = net.scene
    dp = float(np.abs(sc["poses"].detach().cpu().numpy() - gt_scene["poses"]).max())
    dt = float(np.abs(sc["trans"].detach().cpu().numpy() - gt_scene["trans"]).max())
    dc = max((float(np.abs(v.detach().cpu().numpy() - gt_scene["camera"][k]).max())
              for k, v in sc["camera"].items()), default=0.0)
    print(f"[diag] step {step} scene drift: pose {dp:.5f} trans {dt:.5f} cam {dc:.5f}",
          flush=True)
    return {"pose": dp, "trans": dt, "cam": dc}


def probe_steps(steps: int) -> list:
    """Every 10% of the run, and just before and 50 steps after the switches
    at 40% and 75%."""
    return sorted(({steps * k // 10 for k in range(1, 10)}
                   | {int(steps * 0.4) - 1, int(steps * 0.4) + 50,
                      int(steps * 0.75) - 1, int(steps * 0.75) + 50}) - {0})


def phase_steps(steps: int, no_phases: bool = False) -> dict:
    """{step: phase} of the coarse → medium → fine switches (at 40% and
    75%; none below 100 steps or with ``no_phases``)."""
    if steps < 100 or no_phases:
        return {}
    return {int(steps * 0.4): "medium", int(steps * 0.75): "fine"}


def radius_floor(seg3d_cfg) -> float:
    """0.8 × the mean final grid spacing: below it the splats of the MC
    vertices leave holes in the rendered mask."""
    from ..ops.seg3d import final_grid_spacing

    spacing, _ = final_grid_spacing(seg3d_cfg)
    return 0.8 * float(np.mean(np.asarray(spacing)))


# ---------------------------------------------------------------------------
# scores of the exports
# ---------------------------------------------------------------------------

def frame_scores(scene: str, out_dir: str, garment_names, frame_num: int, device) -> dict:
    """Per frame with a GT mesh and exports (``<out_dir>/meshs/NNNN_*.obj``):
    the symmetric chamfer of all garments against the GT's lateral surface
    and against the closed solid, the one-sided mean distance to the GT,
    and per garment the one-sided mean distance to its own GT piece."""
    from ..utils.io import load_obj

    res = {"chamfer": [], "chamfer_closed": [], "one_sided": [],
           "per_garment": {g: [] for g in garment_names}}
    for fid in range(frame_num):
        cands = sorted(glob.glob(osp.join(out_dir, "meshs", f"{fid:04d}_*.obj")))
        if not osp.isfile(osp.join(scene, "gt_meshes", f"{fid}.npz")) or not cands:
            continue
        gt = gt_surface(scene, fid, GT_SAMPLES)
        pred = np.concatenate([load_obj(c)[0] for c in cands], 0)
        lateral = gt_surface(scene, fid, GT_SAMPLES, lateral_only=True)
        res["chamfer"].append(_chamfer(pred, lateral, device))
        res["chamfer_closed"].append(_chamfer(pred, gt, device))
        res["one_sided"].append(_mean_dist(pred, gt, device))
        for gname in garment_names:
            cg = [c for c in cands if c.endswith(f"_{gname}.obj")]
            if cg:
                pg = np.concatenate([load_obj(c)[0] for c in cg], 0)
                res["per_garment"][gname].append(
                    _mean_dist(pg, gt_piece_surface(scene, fid, gname, GT_SAMPLES), device))
    return res


def seam_gap(registered: dict, out_dir: str, names, device):
    """Two garments: the mean distance from the bottom's sewn waist loop to
    the upper's (the ``upper_bottom`` labels of
    ``registry_<g>_labels.npz``); None otherwise."""
    names = list(names)
    if len(names) != 2:
        return None
    labs = {}
    for g in names:
        path = osp.join(out_dir, f"registry_{g}_labels.npz")
        if osp.isfile(path):
            with np.load(path) as z:
                labs[g] = {k: z[k] for k in z.files}
    if not all("upper_bottom" in labs.get(g, {}) for g in names):
        return None
    up = registered[names[0]][0][labs[names[0]]["upper_bottom"]]
    bp = registered[names[1]][0][labs[names[1]]["upper_bottom"]]
    return _mean_dist(bp, up, device)


def quick_schedules():
    """The quick NRICP schedules (coarse 30 epochs, refine 15)."""
    from ..geometry.nricp import NricpConfig

    return (NricpConfig(epochs=30, inner_iter=10, first_inner_iter=40,
                        stiffness_weight=(50.0, 5.0, 0.8, 0.2), milestones=(8, 16, 24),
                        laplacian_weight=(250.0,) * 4, threshold=0.3, max_dist=0.04),
            NricpConfig(epochs=15, inner_iter=10, first_inner_iter=10,
                        stiffness_weight=(0.8, 0.2), milestones=(8,),
                        laplacian_weight=(250.0,) * 2, threshold=0.5, lr=5e-4, max_dist=0.04))


def init_curve_fit(net) -> dict:
    """The last initialization's curve fit per curve: the fitted scale
    ``s`` beside its prior ``INI_FL_SCALE``, the translation ``T``, and
    whether the extent rescue fired. The record's ``init_curve_fit`` (None
    when the initialization came from its cached checkpoint)."""
    from ..config.constants import INI_FL_SCALE

    return {n: {"s": round(float(s), 6), "ini_fl_scale": INI_FL_SCALE.get(n, 1.5),
                "T": [round(float(x), 6) for x in T], "rescued": n in net.fl_rescued}
            for n, (T, s) in net.fl_fit.items()}


def freeze_pose(conf) -> None:
    """Turn off the optimization of the poses, translations and every
    camera leaf in ``conf``."""
    conf.put("train.opt_pose", False)
    conf.put("train.opt_trans", False)
    if "train.opt_camera" in conf:
        for k in list(conf.get_config("train.opt_camera")):
            conf.put(f"train.opt_camera.{k}", False)


def parse_args(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default="cuda", help="torch device (cuda or cpu)")
    ap.add_argument("--image", type=int, default=256)
    ap.add_argument("--frames", type=int, default=8)
    ap.add_argument("--steps", type=int, default=24)
    ap.add_argument("--init-epochs", type=int, default=120)
    ap.add_argument("--production-nricp", action="store_true",
                    help="register with the production 200+100 NRICP schedules, not the quick "
                         "30+15 ones")
    ap.add_argument("--quick", action="store_true", help="tiny scale (64 px, 4 frames, 6 steps)")
    ap.add_argument("--garment-type", default="synthetic-tube",
                    choices=["synthetic-tube", "synthetic-two", "synthetic-skirt"])
    ap.add_argument("--occlusion-gate", action="store_true",
                    help="pc_weight.occlusion_gate = 1 in every loss block (body-occluded "
                         "garment pixels are IoU don't-cares)")
    ap.add_argument("--curve-lr", type=float, default=1e-4, help="the curves' AdamW lr")
    ap.add_argument("--no-phases", action="store_true",
                    help="stay on the coarse hierarchy for the whole run")
    ap.add_argument("--freeze-pose", action="store_true",
                    help="do not optimize the poses, translations and camera")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--scene", default=bench_path("scenes", "quality"),
                    help="scene path prefix (+ _<image>_<frames>[_two|_skirt])")
    ap.add_argument("--out", default=bench_path("bench_quality.json"))
    args = ap.parse_args(argv)
    if args.quick:
        args.image, args.frames, args.steps, args.init_epochs = 64, 4, 6, 60
    return args


def build(args, dev) -> tuple:
    """The configuration's scene (generated or reused) and network, as the
    JAX tool builds them → (scene directory, conf, dataset, sampler, net)."""
    from ..config import ConfigFactory
    from ..core.builder import build_opt_net
    from ..core.network import TrainConfig
    from ..data.dataset import get_dataset_and_loader
    from ..data.synthetic import ensure_scene

    two = args.garment_type == "synthetic-two"
    suffix = {"synthetic-two": "_two", "synthetic-skirt": "_skirt"}.get(args.garment_type, "")
    scene = f"{args.scene}_{args.image}_{args.frames}{suffix}"
    ensure_scene(scene, n_frames=args.frames, image_size=args.image, skinner_res=SKINNER_RES,
                 garment_type=args.garment_type, device=dev)

    conf_name = {"synthetic-two": "smoke_two.conf",
                 "synthetic-skirt": "smoke_skirt.conf"}.get(args.garment_type, "smoke.conf")
    conf = ConfigFactory.parse_file(osp.join(REPO, "configs", "synthetic", conf_name))
    if args.occlusion_gate:
        for ph in ("coarse", "medium", "fine"):
            if f"loss_{ph}" in conf:
                conf.put(f"loss_{ph}.pc_weight.occlusion_gate", 1.0)
    if args.freeze_pose:
        freeze_pose(conf)
    n_g = 2 if two else 1
    dataset, sampler = get_dataset_and_loader(
        scene, {"deformer": 256 * (1 + n_g) // 2, "render": 256}, 2, shuffle=True,
        garment_type=args.garment_type, data_type="synthe", seed=args.seed)
    small = args.image <= 128
    cfg = TrainConfig(
        sample_pix=256 if small else 1024,
        point_radius=conf.get_float("train.coarse.point_render.radius", 0.02),
        remesh_intersect=conf.get_int("train.coarse.point_render.remesh_intersect", 16),
        mc_capacity_v=1 << 14, mc_capacity_f=1 << 15,
        raster_tile=16 if small else 32, raster_cap_mesh=256, raster_cap_points=256,
        solver_times=10, surface_sample=512, curve_lr=args.curve_lr)
    net = build_opt_net(conf, dataset, osp.join(scene, "result"), resolutions=RES,
                        skinner_res=SKINNER_RES, train_cfg=cfg, seed=args.seed, device=dev)
    return scene, conf, dataset, sampler, net


def score(net, ratio, scene, dataset, args, dev, out_dir) -> dict:
    """The record's scores of the network's state: the registration (the
    quick or, with ``--production-nricp``, the production NRICP schedules)
    and the per-frame mesh exports into ``out_dir`` (the reference's
    ``--nI --nColor`` mode), scored against the scene's GT meshes."""
    from ..core.inference import GarmentInference

    inf = GarmentInference(net)
    nricp, refine = (None, None) if args.production_nricp else quick_schedules()
    t0 = time.time()
    inf.ensure_registration(ratio, out_dir, nricp_cfg=nricp, refine_cfg=refine)
    sync(dev)
    t_reg = time.time() - t0
    inf.infer_garment(np.arange(dataset.frame_num), ratio, out_dir, images=False, colors=False)
    names = list(net.statics.garment_names)
    sc = frame_scores(scene, out_dir, names, dataset.frame_num, dev)
    gap = seam_gap(inf.registered, out_dir, names, dev)
    return {
        "pred_to_gt_dist_per_frame": [round(d, 6) for d in sc["one_sided"]],
        "pred_to_gt_dist_mean": round(float(np.mean(sc["one_sided"])), 6),
        "chamfer_l2_sym_per_frame": [round(d, 6) for d in sc["chamfer"]],
        "chamfer_l2_sym_mean": round(float(np.mean(sc["chamfer"])), 6),
        "chamfer_l2_sym_vs_closed_mean": round(float(np.mean(sc["chamfer_closed"])), 6),
        "per_garment_pred_to_gt": {g: round(float(np.mean(v)), 6)
                                   for g, v in sc["per_garment"].items() if v},
        "waist_seam_gap": None if gap is None else round(gap, 6),
        "nricp_schedule": "production-200+100" if args.production_nricp else "quick-30+15",
        "t_registration_s": round(t_reg, 1),
    }


def main(argv=None) -> dict:
    from .. import resolve_device
    from ..utils.visualizer import LocalVisualizer

    args = parse_args(argv)
    dev = resolve_device(args.device)
    scene, conf, dataset, sampler, net = build(args, dev)
    gen = torch.Generator(device=dev).manual_seed(args.seed)
    t0 = time.time()
    init_ckpt = osp.join(scene, "result", f"quality_init_s{args.seed}.ckpt")
    curve_fit = None
    if osp.isfile(init_ckpt):
        net.load_checkpoint(init_ckpt)
    else:
        net.initialize_tmp_sdf(nepochs=args.init_epochs, save_dir=None, fl_iters=150,
                               generator=gen)
        net.save_checkpoint(init_ckpt, 0)
        curve_fit = init_curve_fit(net)
    sync(dev)
    t_init = time.time() - t0

    ratio = {"sdfRatio": 1.0, "deformerRatio": 0.5, "renderRatio": 1.0}
    gt0 = gt_surface(scene, 0, GT_SAMPLES)
    pieces, gt_cano, gt_rings = canonical_gt(args.garment_type)
    p0 = dataset.params
    gt_scene = {"poses": np.array(p0.poses), "trans": np.array(p0.trans),
                "camera": {k: np.array(v) for k, v in p0.camera.items()}}
    trend, trend_fresh, diags = {}, {}, {}

    def probe(step):
        trend[step] = mc_pred_to_gt(net, ratio, gt0)
        meshes = fresh_meshes(net, ratio)
        trend_fresh[step] = mc_fresh_to_gt(net, ratio, gt0, meshes=meshes)
        diags[step] = {"drift": scene_drift(net, gt_scene, step),
                       **canonical_diag(net, ratio, pieces, gt_cano, gt_rings, step, meshes)}

    probe(0)
    probe_at = probe_steps(args.steps)
    phase_at = phase_steps(args.steps, args.no_phases)
    floor = radius_floor(net.seg3d_cfg)
    print(f"[quality] splat radius floor {floor:.4f}", flush=True)
    vis = LocalVisualizer(osp.join(scene, "result", "logs"))
    steps = 0
    t0 = time.time()
    while steps < args.steps:
        for fids in sampler:
            phase = phase_at.get(steps)
            if phase is not None and f"loss_{phase}" in conf:
                net.conf.set_loss_block(conf.get_config(f"loss_{phase}"))
                net.cfg.point_radius = max(
                    conf.get_float(f"train.{phase}.point_render.radius"), floor)
                net.cfg.remesh_intersect = conf.get_int(
                    f"train.{phase}.point_render.remesh_intersect")
                net.isfine = phase == "fine"
                net.on_phase_change()
                print(f"[quality] step {steps}: enabled {phase} hierarchy", flush=True)
            ratio["deformerRatio"] = net.opt_times / 2500.0 + 0.5
            _, info = net.train_step(dataset.get_batch(fids), fids, ratio, generator=gen)
            vis.add_scalars({k: v for k, v in info.items() if isinstance(v, (int, float))},
                            steps)
            steps += 1
            if steps in probe_at:
                probe(steps)
            if steps >= args.steps:
                break
    sync(dev)
    t_train = time.time() - t0
    probe(steps)
    net.save_checkpoint(osp.join(scene, "result", f"quality_final_s{args.seed}.ckpt"), steps)
    print(f"[quality] sgd-mesh pred->gt trend: {trend}", flush=True)
    print(f"[quality] fresh-mc pred->gt trend: {trend_fresh}", flush=True)

    out = {
        "config": {"image": args.image, "frames": args.frames, "steps": args.steps,
                   "init_epochs": args.init_epochs, "pyramid": list(RES[-1]),
                   "occlusion_gate": bool(args.occlusion_gate),
                   "freeze_pose": bool(args.freeze_pose), "curve_lr": args.curve_lr,
                   "seed": args.seed},
        **device_record(dev),
        **score(net, ratio, scene, dataset, args, dev,
                osp.join(scene, "result", f"infer_s{args.seed}")),
        "garment_type": args.garment_type,
        "mc_pred_to_gt_trend": {str(k): round(v, 6) for k, v in trend.items()},
        "mc_fresh_to_gt_trend": {str(k): round(v, 6) for k, v in trend_fresh.items()},
        "canonical_diag_final": diags[steps],
        "init_curve_fit": curve_fit,
        "t_init_s": round(t_init, 1), "t_train_s": round(t_train, 1),
    }
    return write_record(args.out, out)


if __name__ == "__main__":
    main()
