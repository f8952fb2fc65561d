"""The port's garment registration on the card, stage by stage, against the
JAX package's on the CPU on one mesh.

    python3 tests/registration_card.py --dump DIR/<config>.npz \\
        --ckpt <scene>/result/jax_final.ckpt --garment-type synthetic-skirt \\
        --scene <scene prefix> [--device cuda] [--repeat N] [--out record.json]

``tests/registration_report.py --dump DIR`` writes, per garment of a
configuration, the marching-cubes target, the Laplacian alignment's
system, the port's scan mask and the JAX package's stage outputs of its
registration (b) (the JAX package with the port's scan mask), and the
final meshes of (b) and of the port on the CPU (c). This script needs no
JAX. It builds the port's network on the same scene from the same
checkpoint on ``--device`` (``bench_quality.build``, as
``rescore_quality`` does); then:

- first, before anything else runs in the process, ``rescore_quality``'s
  path (``bench_quality.score``: a fresh extraction registered and
  scored), its stage outputs kept for ``--meshes``;
- per garment, the extraction there against the dumped target, and each
  stage of ``register_garment`` there on the JAX stage's input: the
  Laplacian alignment (its deviation from the JAX result and from a
  float64 solve on the host), the scan (vertices that differ from the CPU
  mask), NRICP coarse from the JAX Laplacian result, the remesh of the
  JAX coarse fit, NRICP refine from the JAX remesh (largest and mean
  vertex differences from the JAX outputs);
- ``ensure_registration`` there on the dumped targets and on its own
  extraction (each stage on its own outputs, the waist sewing on);
- through one export and scoring there (``bench_quality.score_registered``)
  the dumped (b) and (c) and both of this device's registrations. (b)
  scored here against its CPU score (``registration_report``) holds the
  export and scoring; this device's registrations against (b) and (c)
  hold the registration;
- with ``--repeat N``, N registrations of the dumped targets with
  PyTorch's default algorithms and N with its deterministic ones: per
  stage the largest difference from the first run's output, each run's
  scores, and NRICP's loss terms evaluated N times on one input (which of
  them gives other bits from one call to the next);
- last, since it replaces the loaded state, ``initialize_tmp_sdf`` (one
  IGR epoch: the templates' Laplacian alignment, which solves in float32
  as the JAX package does, comes before the fits) with each template's
  alignment against a float64 solve on the host.

cuBLAS is made deterministic (``CUBLAS_WORKSPACE_CONFIG``) for the whole
run, so the repeats part only where another operation does.
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
import warnings

import numpy as np
import torch

HERE = osp.dirname(osp.abspath(__file__))
sys.path[:0] = [HERE, osp.dirname(HERE)]

from recmv_tpu_torch.tools import bench_quality as bq  # noqa: E402
from test_torch_registration import _laplacian_f64  # noqa: E402


def _gap(a, b) -> dict:
    d = np.abs(np.asarray(a, np.float64) - np.asarray(b, np.float64))
    return {"max": float(d.max()), "mean": float(d.mean())}


def stages(net, g: str, gi: int, z, dev) -> dict:
    """The stages of garment ``g`` on ``dev``, each from the JAX stage's
    input."""
    from recmv_tpu_torch.core.inference import remesh_registered, visible_vertex_mask
    from recmv_tpu_torch.geometry.laplacian import laplacian_deform
    from recmv_tpu_torch.geometry.mesh_utils import vertex_normals
    from recmv_tpu_torch.geometry.nricp import nricp_fit

    def a(k):
        return z[f"{g}/{k}"]

    mc_v, mc_f = a("mc_v"), a("mc_f")
    out = {}
    system = (a("lap_verts"), a("lap_faces"), a("lap_cids"), a("lap_targets"))
    ref = _laplacian_f64(*system)
    lap = laplacian_deform(*system, constrain_weight=1.0, smooth=True, device=dev).cpu().numpy()
    out["laplacian"] = {"vs_jax": _gap(lap, a("b_lap")), "vs_f64": _gap(lap, ref),
                        "jax_vs_f64": _gap(a("b_lap"), ref)}
    mask = visible_vertex_mask(mc_v, mc_f, device=dev)
    out["scan_differs_from_cpu"] = int((mask != a("mask")).sum())
    tmpl = net.garment_templates[gi]
    labels = dict(tmpl.boundary_labels)
    static = np.concatenate([np.asarray(x) for x in labels.values()])
    normals = vertex_normals(mc_v, mc_f)
    coarse_cfg, refine_cfg = bq.quick_schedules()
    coarse = nricp_fit(a("b_lap"), a("lap_faces"), mc_v, normals, target_mask=a("mask"),
                       static_ids=static, cfg=coarse_cfg, device=dev)
    out["nricp_coarse"] = _gap(coarse, a("b_coarse"))
    rv, rf, rlabels = remesh_registered(a("b_coarse"), a("lap_faces"), labels)
    out["remesh_same"] = bool(np.array_equal(rf, a("b_remesh_f"))
                              and np.array_equal(rv, a("b_remesh_v")))
    refine = nricp_fit(a("b_remesh_v"), a("b_remesh_f"), mc_v, normals, target_mask=a("mask"),
                       static_ids=np.concatenate([np.asarray(x) for x in rlabels.values()]),
                       cfg=refine_cfg, device=dev)
    out["nricp_refine"] = _gap(refine, a("b_refine"))
    return out


def register_dumped(net, names, z, out_dir: str, dev) -> dict:
    """``ensure_registration`` on this device with the dumped targets in
    place of its own extraction → {garment: (v, f)}."""
    from recmv_tpu_torch.core import inference as tinf

    targets = {g: (z[f"{g}/mc_v"], z[f"{g}/mc_f"]) for g in names}
    order = iter(names)
    orig = tinf.register_garment

    def register(template, mc_v, mc_f, *a, **kw):
        return orig(template, *targets[next(order)], *a, **kw)

    tinf.register_garment = register
    try:
        coarse, refine = bq.quick_schedules()
        inf = tinf.GarmentInference(net)
        inf.ensure_registration(bq.final_ratio(net), out_dir, nricp_cfg=coarse,
                                refine_cfg=refine)
    finally:
        tinf.register_garment = orig
    return dict(inf.registered)


@contextlib.contextmanager
def recording(rec: dict, tag: str):
    """Keep, under ``rec[f"{tag}/<stage>{i}"]``, the output of each call of
    the port's registration stages while the context is open."""
    from recmv_tpu_torch.core import inference as tinf

    stages_ = ("laplacian_deform", "visible_vertex_mask", "nricp_fit", "remesh_registered")
    orig = {k: getattr(tinf, k) for k in stages_}
    count = {}

    def wrap(k):
        def call(*a, **kw):
            out = orig[k](*a, **kw)
            i = count[k] = count.get(k, -1) + 1
            parts = out if isinstance(out, tuple) else (out,)
            for j, x in enumerate(parts[:2]):
                x = x.cpu().numpy() if torch.is_tensor(x) else x
                rec[f"{tag}/{k}{i}_{j}"] = np.asarray(x)
            return out
        return call

    for k in stages_:
        setattr(tinf, k, wrap(k))
    try:
        yield rec
    finally:
        for k, fn in orig.items():
            setattr(tinf, k, fn)


def repeats(net, names, z, n: int, scene, dataset, work: str, dev) -> dict:
    """``n`` registrations of the dumped targets (``register_dumped``), with
    PyTorch's default algorithms and then its deterministic ones: per stage
    call the largest difference from the first run's output (None where
    the shapes differ), each run's per-garment scores, and the operations
    that PyTorch names as having no deterministic implementation; and, with
    the default algorithms, ``nricp_terms`` on the first garment."""
    out = {"nricp_terms": nricp_terms(z, names[0], n, dev)}
    for mode in ("default", "deterministic"):
        torch.use_deterministic_algorithms(mode == "deterministic", warn_only=True)
        runs, scores = [], []
        try:
            with warnings.catch_warnings(record=True) as caught:
                warnings.simplefilter("always")
                for r in range(n):
                    rec = {}
                    with recording(rec, "run"):
                        reg = register_dumped(net, names, z, osp.join(work, f"{mode}{r}"), dev)
                    runs.append(rec)
                    scores.append(bq.score_registered(
                        net, bq.final_ratio(net), scene, dataset, reg,
                        osp.join(work, f"{mode}{r}_export"), dev)["per_garment_pred_to_gt"])
        finally:
            torch.use_deterministic_algorithms(False)
        out[mode] = {
            "max_diff_from_first_run": {
                k: [float(np.abs(r[k].astype(np.float64) - x).max())
                    if r[k].shape == x.shape else None for r in runs[1:]]
                for k, x in runs[0].items()},
            "scores": scores,
            "nondeterministic_ops": sorted({str(w.message).split(" does not have")[0]
                                            for w in caught
                                            if "deterministic" in str(w.message)})}
        print(f"[registration_card] repeats ({mode}): {json.dumps(out[mode])}", flush=True)
    return out


def nricp_terms(z, g: str, n: int, dev) -> dict:
    """NRICP's Laplacian and stiffness terms, each evaluated ``n`` times
    with its gradient on one input (garment ``g``'s JAX coarse fit, affine
    parameters drawn from a seed): how many values differ from the first
    call's bits, and the largest gradient difference."""
    from recmv_tpu_torch.geometry import nricp
    from recmv_tpu_torch.geometry.mesh_utils import compute_edges_unique

    v = torch.as_tensor(z[f"{g}/b_coarse"], device=dev)
    edges = torch.as_tensor(compute_edges_unique(z[f"{g}/lap_faces"]), dtype=torch.int64,
                            device=dev)
    gen = torch.Generator(device=dev).manual_seed(0)
    params = {"A": torch.eye(3, device=dev) + 1e-2 * torch.randn(len(v), 3, 3, generator=gen,
                                                                 device=dev),
              "b": 1e-2 * torch.randn(len(v), 3, generator=gen, device=dev)}
    terms = {"laplacian": lambda p: nricp._uniform_laplacian_loss(
                 nricp.local_affine_apply(p, v), edges, len(v)),
             "stiffness": lambda p: nricp._stiffness(p, edges, 1.0)}
    out = {}
    for name, term in terms.items():
        vals, grads = [], []
        for _ in range(n):
            p = {k: x.clone().requires_grad_() for k, x in params.items()}
            y = term(p)
            y.backward()
            vals.append(y.item())
            grads.append(torch.cat([p["A"].grad.flatten(), p["b"].grad.flatten()]))
        out[name] = {"values_differing": sum(x != vals[0] for x in vals[1:]),
                     "grad_max_diff": max(float((x - grads[0]).abs().max()) for x in grads[1:])}
    return out


def init_alignment(net) -> list:
    """``initialize_tmp_sdf`` with one IGR epoch, each template's Laplacian
    alignment kept and set against a float64 solve of its system on the
    host."""
    from recmv_tpu_torch.geometry import laplacian

    orig, calls = laplacian.laplacian_deform, []

    def keep(*a, **kw):
        out = orig(*a, **kw)
        calls.append((a[:4], out.cpu().numpy()))
        return out

    laplacian.laplacian_deform = keep
    try:
        net.initialize_tmp_sdf(nepochs=1, fl_iters=150)
    finally:
        laplacian.laplacian_deform = orig
    return [{"vertices": int(len(a[0])), "vs_f64": _gap(out, _laplacian_f64(*a))}
            for a, out in calls]


def main(argv=None) -> dict:
    from recmv_tpu_torch import resolve_device
    from recmv_tpu_torch.core.network import _ratio_dict
    from recmv_tpu_torch.geometry.mesh_utils import largest_component
    from recmv_tpu_torch.tools import device_record, write_record

    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--dump", required=True)
    ap.add_argument("--ckpt", required=True)
    ap.add_argument("--out", default=None)
    ap.add_argument("--repeat", type=int, default=0,
                    help="register the dumped targets this many times with each of PyTorch's "
                         "default and deterministic algorithms")
    ap.add_argument("--meshes", default=None,
                    help="an .npz for the stage outputs of rescore_quality's path and of "
                         "this device's own registration")
    own, rest = ap.parse_known_args(argv)
    args = bq.parse_args(rest)
    os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")   # before the first GEMM
    dev = resolve_device(args.device)
    scene, _, dataset, _, net = bq.build(args, dev)
    net.load_checkpoint(own.ckpt)
    names = list(net.statics.garment_names)
    z = dict(np.load(own.dump))
    rec = {"ckpt": osp.basename(own.ckpt), **device_record(dev), "garments": {}}
    meshes = {}
    work = osp.join(scene, "result", "registration_card")
    shutil.rmtree(work, ignore_errors=True)
    ratio = bq.final_ratio(net)
    # first, before anything else runs in this process: rescore_quality's path
    with recording(meshes, "rescore"):
        rec["rescore"] = bq.score(net, ratio, scene, dataset, args, dev,
                                  osp.join(work, "rescore"))
    print(f"[registration_card] rescore: {json.dumps(rec['rescore'])}", flush=True)
    net.marching_cube_update(_ratio_dict(ratio))
    own_mc = {}
    for gi, g in enumerate(names):
        n, nf = net.mesh.garment_n[gi], net.mesh.garment_fn[gi]
        v, f = largest_component(net.mesh.garment_vs[gi][:n].detach().cpu().numpy(),
                                 net.mesh.garment_fs[gi][:nf].cpu().numpy())
        own_mc[g] = (v, f)
        same = v.shape == z[f"{g}/mc_v"].shape and np.array_equal(f, z[f"{g}/mc_f"])
        t0 = time.time()
        rec["garments"][g] = {
            "mc_vertices": [int(len(v)), int(len(z[f"{g}/mc_v"]))],
            "mc_same_faces": bool(same),
            "mc_max_vertex_diff": float(np.abs(v - z[f"{g}/mc_v"]).max()) if same else None,
            **stages(net, g, gi, z, dev)}
        rec["garments"][g]["seconds"] = round(time.time() - t0, 1)
        print(f"[registration_card] {g}: {json.dumps(rec['garments'][g])}", flush=True)
    regs = {k: {g: (z[f"{g}/{k}_v"], z[f"{g}/{k}_f"]) for g in names} for k in "bc"}
    regs["here"] = register_dumped(net, names, z, osp.join(work, "here"), dev)
    from recmv_tpu_torch.core.inference import GarmentInference

    inf = GarmentInference(net)
    coarse, refine = bq.quick_schedules()
    with recording(meshes, "own"):
        inf.ensure_registration(ratio, osp.join(work, "own"), nricp_cfg=coarse,
                                refine_cfg=refine)
    regs["own_extraction"] = dict(inf.registered)
    rec["scores"] = {k: bq.score_registered(net, ratio, scene, dataset, r,
                                            osp.join(work, f"export_{k}"), dev)
                     for k, r in regs.items()}
    print(f"[registration_card] scores: {json.dumps(rec['scores'])}", flush=True)
    if own.repeat:
        rec["repeats"] = repeats(net, names, z, own.repeat, scene, dataset, work, dev)
    rec["init_alignment"] = init_alignment(net)
    print(f"[registration_card] init alignment: {json.dumps(rec['init_alignment'])}",
          flush=True)
    if own.meshes:
        np.savez_compressed(own.meshes, **meshes)
    return write_record(own.out or bq.bench_path("registration_card.json"), rec)


if __name__ == "__main__":
    main()
