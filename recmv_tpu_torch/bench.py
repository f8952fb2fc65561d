"""The per-ray hot step and the headline summary (counterpart of the
repo's ``bench.py``).

    python -m recmv_tpu_torch.bench [--rays 8192] [--iters 10] [--device cuda]

The hot step, at the flagship widths (SDF 8×512 with multires 6 and 256
features, translator 4×512 with 128-d latents, render net 4×512 with 256
features, skinner (17, 25, 9) of the synthetic body; the widths of
``__graft_entry__._build_tiny_model``, built here from a seed because that
module imports JAX): R rays over 2 frames, the 20-step surface root-find
(``optimize_surface_points``: SDF and the whole deformer per iteration),
then the loss (IDR colour through the SDF gradient, the deformer Jacobian
and the render net, + 0.1 eikonal + 3 |sdf|) and its gradient to every
network and skinner leaf (a double backward). Printed: ``hot_step_ms``
(warm, host clock ending in a synchronize), ``rays_per_sec_per_chip``,
``hot_step_gflops`` (``utils.profiling.count_flops``: the step's GEMMs)
and ``mfu_pct_vs_f32_peak`` against the H100's 67 TFLOP/s float32 (TF32 is
off).

Then ONE JSON line as the repo's ``bench.py`` prints it: the headline is
the amortized seconds per production step from
``recmv_tpu_torch/_bench/bench_fullstep.json`` (``tools/bench_fullstep``)
against the ~1.5 s/step GTX-3090 estimate (``vs_baseline`` > 1 is faster),
or the hot step's rays/s without that record, with the other records found
under ``recmv_tpu_torch/_bench/`` embedded and the full-sequence
projection. Only the port's own records count: the repo root's
``bench_*.json`` are the JAX package's TPU records. ``--device`` (default
``cuda``; ``cpu`` for the tests) is new; ``compile_s`` has no counterpart
(nothing is compiled ahead of the first call, ``first_call_s``).
"""

from __future__ import annotations

import argparse
import json
import os.path as osp
import time

import numpy as np
import torch

BASELINE_RAYS_PER_SEC = 1365.0  # estimate: see BASELINE_PROVENANCE
BASELINE_PROVENANCE = (
    "ESTIMATE from reference config (2048 rays/step at ~1.5 s/step "
    "GTX-3090, SelfRecon/IDR family); reference publishes no numbers "
    "and no CUDA GPU is available here")
RECORDS = ("bench_fullstep.json", "bench_quality.json", "bench_quality_512.json",
           "bench_quality_512_gateon.json", "bench_quality_two.json",
           "bench_quality_skirt.json", "bench_largepose.json", "bench_animation.json")


def build_hot_model(seed: int = 0, sdf_dims=(512,) * 8, features: int = 256,
                    condlen: int = 128, device=None) -> dict:
    """{"sdf", "translator", "render", "skinner"} at the given widths (the
    defaults are the flagship's), made from ``seed``; every network and
    skinner leaf requires grad."""
    from . import resolve_device
    from .models.render_net import init_render_net
    from .models.sdf import init_sdf_net
    from .models.skinner import initial_lbs_skinner
    from .models.smpl import synthetic_body_model
    from .models.translator import init_translator

    device = resolve_device(device)
    gen = torch.Generator().manual_seed(seed)
    skip = (len(sdf_dims) // 2,)
    params = {"sdf": init_sdf_net(gen, multires=6, bias=0.6, feature_vector_size=features,
                                  dims=tuple(sdf_dims), skip_in=skip),
              "translator": init_translator(gen, condlen=condlen, multires=6),
              "render": init_render_net(gen, condlen=features, multires_v=4)}
    for k in ("sdf", "translator", "render"):
        params[k] = params[k].to(device)
    apose = np.zeros((24, 3), np.float32)
    apose[1, 2], apose[2, 2], apose[16, 2], apose[17, 2] = 0.17, -0.17, -0.79, 0.79
    sk, _, _ = initial_lbs_skinner(synthetic_body_model(n_subdiv=24),
                                   torch.zeros(10, device=device), apose, resolution=(17, 25, 9))
    for f in sk.__dataclass_fields__:
        getattr(sk, f).requires_grad_(True)
    params["skinner"] = sk
    return params


def hot_inputs(R: int = 8192, n_frames: int = 2, condlen: int = 128, device=None) -> dict:
    """The hot step's inputs, made with numpy from seed 0 in the JAX
    bench's order: R rays from a camera at (0, 0.2, 2.6) to Gaussian
    targets (σ 0.2), seeds at radius 0.6 along each target with 2 mm noise,
    per-frame latents, zero poses and translations, each ray's frame, and
    target colours in [−1, 1]."""
    from . import resolve_device

    device = resolve_device(device)
    rng = np.random.RandomState(0)
    cam = np.asarray([0.0, 0.2, 2.6], np.float32)
    targets = rng.randn(R, 3).astype(np.float32) * 0.2
    rays = targets - cam
    rays /= np.linalg.norm(rays, axis=1, keepdims=True)
    seeds = targets / np.linalg.norm(targets, axis=1, keepdims=True) * 0.6
    seeds += rng.randn(R, 3).astype(np.float32) * 2e-3
    cond = rng.randn(n_frames, condlen).astype(np.float32) * 0.01
    batch_inds = rng.randint(0, n_frames, R).astype(np.int64)
    gt_rgb = rng.rand(R, 3).astype(np.float32) * 2 - 1

    def t(a):
        return torch.as_tensor(a, device=device)

    return {"cam": t(cam), "rays": t(rays), "seeds": t(seeds), "cond": t(cond),
            "poses": torch.zeros(n_frames, 24, 3, device=device),
            "trans": torch.zeros(n_frames, 3, device=device), "batch_inds": t(batch_inds),
            "gt_rgb": t(gt_rgb)}


def hot_leaves(params) -> dict:
    """The leaves the hot step differentiates, by name (the networks'
    parameters as ``<net>.<parameter>``, the skinner's fields as
    ``skinner.<field>``)."""
    out = {f"{k}.{n}": p for k in ("sdf", "translator", "render")
           for n, p in params[k].named_parameters()}
    out.update({f"skinner.{f}": getattr(params["skinner"], f)
                for f in params["skinner"].__dataclass_fields__})
    return out


def _hot_deform(params, x):
    from .models.skinner import skinner_apply
    from .models.translator import translator_apply

    cond = x["cond"][x["batch_inds"]]

    def deform(pts):
        off, _ = translator_apply(params["translator"], pts, cond, 1.0)
        return skinner_apply(params["skinner"], off, x["poses"], x["trans"],
                             batch_inds=x["batch_inds"])

    return deform


def hot_solve(params, x, times: int = 20) -> tuple:
    """The surface root-find over ``x``'s rays → (points (R, 3), converged
    (R,)), no graph."""
    from .core.surface_ps import optimize_surface_points
    from .models.sdf import sdf_value

    R = x["rays"].shape[0]
    with torch.no_grad():
        return optimize_surface_points(
            lambda p: sdf_value(params["sdf"], p, 1.0), _hot_deform(params, x), x["cam"],
            x["rays"], x["seeds"], torch.ones(R, dtype=torch.bool, device=x["rays"].device),
            times=times)


def hot_loss(params, x, pts) -> tuple:
    """The loss at the solved points and its gradient → (loss, {leaf name:
    Σ|gradient|})."""
    from .models.deformer import cardinal_rays_from_jac, deformer_jacobian
    from .models.render_net import render_net_apply
    from .models.sdf import sdf_apply, sdf_value_and_gradient

    sdf, feat = sdf_apply(params["sdf"], pts, 1.0)
    _, nx = sdf_value_and_gradient(params["sdf"], pts, 1.0)
    nxn = nx / torch.clamp(torch.linalg.norm(nx, dim=-1, keepdim=True), min=1e-9)
    jac = deformer_jacobian(_hot_deform(params, x), pts, create_graph=True)
    crays, _ = cardinal_rays_from_jac(jac, x["rays"])
    rgb = render_net_apply(params["render"], pts, nxn, crays, feat, 1.0)
    color = torch.mean(torch.abs(rgb - x["gt_rgb"]))
    eik = torch.mean((torch.linalg.norm(nx, dim=-1) - 1.0) ** 2)
    loss = color + 0.1 * eik + 3.0 * torch.mean(torch.abs(sdf))
    leaves = hot_leaves(params)
    grads = torch.autograd.grad(loss, list(leaves.values()), allow_unused=True)
    sums = {k: (torch.zeros((), device=loss.device) if g is None else g.abs().sum())
            for k, g in zip(leaves, grads)}
    return loss.detach(), sums


def hot_step(params, x, times: int = 20) -> tuple:
    """The hot step: ``hot_solve`` then ``hot_loss`` → (loss, {leaf name:
    Σ|gradient|}, converged rays)."""
    pts, conv = hot_solve(params, x, times)
    loss, sums = hot_loss(params, x, pts)
    return loss, sums, conv


def bench_records(bench_dir: str) -> dict:
    """The port's records under ``bench_dir``, by name less ``bench_`` and
    ``.json``."""
    out = {}
    for name in RECORDS:
        path = osp.join(bench_dir, name)
        if osp.isfile(path):
            with open(path) as f:
                out[name.replace("bench_", "").replace(".json", "")] = json.load(f)
    return out


def summary(extra: dict, rays_per_sec: float) -> dict:
    """The one-line summary: the amortized production step against the 1.5
    s/step estimate where the port's fullstep record exists (with the
    full-sequence projection), else the hot step's rays/s."""
    fs = extra.get("fullstep")
    extra["rays_per_sec_per_chip"] = round(rays_per_sec, 1)
    extra["rays_vs_baseline_estimate"] = round(rays_per_sec / BASELINE_RAYS_PER_SEC, 3)
    if fs and "sec_per_step_amortized" in fs:
        spp = fs["sec_per_step_amortized"]
        # BASELINE.md's sec/frame: the female-3-casual schedule (200 epochs:
        # coarse 0-8 at batch 3, medium 8-12 at batch 2, fine 12-200 at
        # batch 1) on a 440-frame PeopleSnapshot sequence
        frames = 440
        steps = 8 * frames / 3 + 4 * frames / 2 + 188 * frames / 1
        extra["projected_full_sequence"] = {
            "frames": frames, "total_steps": int(steps),
            "sec_per_frame": round(spp * steps / frames, 1),
            "wall_clock_h": round(spp * steps / 3600.0, 1),
            "provenance": "projection: measured amortized sec/step x reference "
                          "female-3-casual schedule"}
        return {"metric": "sec_per_step_amortized_1080p_fine", "value": spp, "unit": "s/step",
                "vs_baseline": round(1.5 / spp, 3), "extra": extra}
    return {"metric": "rays_per_sec_per_chip", "value": round(rays_per_sec, 1), "unit": "rays/s",
            "vs_baseline": round(rays_per_sec / BASELINE_RAYS_PER_SEC, 3), "extra": extra}


def main(argv=None) -> dict:
    from . import resolve_device
    from .tools import BENCH_DIR, device_record, sync
    from .utils.profiling import FP32_FLOP_PER_S, count_flops

    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default="cuda", help="torch device (cuda or cpu)")
    ap.add_argument("--rays", type=int, default=8192)
    ap.add_argument("--frames", type=int, default=2)
    ap.add_argument("--iters", type=int, default=10, help="timed hot steps")
    ap.add_argument("--bench-dir", default=BENCH_DIR, help="where the port's records are")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    params = build_hot_model(device=dev)
    x = hot_inputs(args.rays, args.frames, device=dev)

    t0 = time.perf_counter()
    _, _, conv = hot_step(params, x)
    sync(dev)
    first_call_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    for _ in range(args.iters):
        out = hot_step(params, x)
    sync(dev)
    dt = (time.perf_counter() - t0) / args.iters
    flops = count_flops(lambda: hot_step(params, x))["flops"]
    extra = {
        "hot_step_ms": round(dt * 1e3, 3),
        "first_call_s": round(first_call_s, 3),
        "hot_step_gflops": round(flops / 1e9, 3),
        "mfu_pct_vs_f32_peak": round(100.0 * flops / dt / FP32_FLOP_PER_S, 4),
        "rays": args.rays, "rays_converged": int(conv.sum()),
        "loss": float(out[0]),
        **device_record(dev),
        "baseline_provenance": BASELINE_PROVENANCE,
    }
    extra.update(bench_records(args.bench_dir))
    line = summary(extra, args.rays / dt)
    print(json.dumps(line), flush=True)
    return line


if __name__ == "__main__":
    main()
