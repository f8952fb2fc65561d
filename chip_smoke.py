"""Smoke run of the PyTorch port (``recmv_tpu_torch``) on one CUDA device.

    python3 chip_smoke.py

Phases, one printed line each (or more):
1. build the CUDA kernels (nvcc, sm_90a) and the host marching cubes (g++)
   from the sources in the checkout;
2. each kernel against its plain PyTorch version on the card, at the
   main path's shapes (1080², tile 32, cap 512 for the mesh z-buffer,
   cap 768 and one channel for the point composite), with both times;
3. generate a synthetic-tube scene on the card: 32 frames at 1080² (more
   than the DCT prior's window of 30), skinning field (129, 225, 65);
4. build the network on it at the flagship widths (SDF 8×512 + 256
   features, translator 4×512 with 128-d latents, render 4×512), the
   coarse seg3d pyramid and the production caps;
5. remesh (seg3d + host marching cubes);
6. three forward steps over batches of 3 frames (mask branch, ray
   seeding, surface solve, IDR colour), with per-phase CUDA-event times
   and the kernels' launch counts, which must rise;
7. the mask branch and the ray seeding of the last batch once more with
   the plain versions in place of the kernels: same masks, same seeds;
8. each kernel against its plain version on the very arguments the main
   path gave it in phase 7 (3 frames at 540², tile 32; cap 512 for the
   seeding z-buffer, cap 1536 for the mask composite), with both times;
9. the composite's backward (K3) against its plain version on the 1080²
   sphere of phase 2 with a seeded upstream gradient, cap 768, one and
   two channels, with and without the feature gradient;
10. six training steps (``train_step``) over batches of 3 frames, the
    first one remeshing, with per-phase CUDA-event times (remesh, ② pc
    forward + backward, vertex update, rays, solve, ③ main forward +
    backward, global update), the first step reported apart; every info
    scalar, gradient norm and parameter finite, rays converged, the
    trained leaves moved and the frozen ones (shape, camera quat) not,
    the launch counts of all three kernels, peak device memory;
11. the ② branch of a training batch, forward and backward, once with
    the kernels and once with the plain versions: same loss, vertex and
    translator gradients;
12. K3 against its plain version on the arguments the training step gave
    it (3 frames at 540², cap 1536, one channel, no feature gradient),
    with both times.

Then a JSON line with each kernel's record (launches from the training
run of phase 10, error and times from phases 8 and 12), the card's name
and power limit, and last ``{"ok": true, "device": {...}}``. Any failure
raises and the exit code is not 0. Without CUDA it exits with 2 before
any work.
"""

from __future__ import annotations

import contextlib
import json
import math
import os.path as osp
import subprocess
import sys
import tempfile
import time

ROOT = osp.dirname(osp.abspath(__file__))
RATIO = {"sdfRatio": 1.0, "deformerRatio": 0.5, "renderRatio": 1.0}
IMAGE = 1080
FRAMES = 32
TRAIN_STEPS = 6
SKINNER_RES = (129, 225, 65)


def log(msg: str) -> None:
    print(msg, flush=True)


def card_line() -> str:
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def cuda_ms(fn, iters: int, warmup: int = 2) -> float:
    """Mean milliseconds of ``fn()`` over ``iters`` runs, by CUDA events."""
    import torch

    for _ in range(warmup):
        fn()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def sphere_screen_mesh(dev):
    """A dense closed mesh (MC sphere, radius 0.5, ~150k faces) in screen
    space at 1080² — main-path-sized inputs for the kernel checks."""
    import numpy as np
    import torch

    from recmv_tpu_torch.models.camera import make_camera
    from recmv_tpu_torch.native import marching_cubes_host
    from recmv_tpu_torch.ops.rasterizer import screen_with_cam_z

    lin = np.linspace(-0.6, 0.6, 161, dtype=np.float32)
    z, y, x = np.meshgrid(lin, lin, lin, indexing="ij")
    v, f = marching_cubes_host(np.sqrt(x * x + y * y + z * z) - 0.5, 0.0,
                               (-0.6, -0.6, -0.6), (lin[1] - lin[0],) * 3)
    cam = make_camera({"focal_length": np.array([1.6 * IMAGE] * 2, np.float32),
                       "princeple_points": np.array([IMAGE / 2.0] * 2, np.float32),
                       "cam2world_coord_quat": np.array([0, 0, 1, 0], np.float32),
                       "world2cam_coord_trans": np.array([0, 0, 2.6], np.float32)},
                      (IMAGE, IMAGE), device=dev)
    scr = screen_with_cam_z(cam, torch.as_tensor(v, device=dev))[None]
    return scr, torch.as_tensor(f, device=dev)


def compare_mesh_tiles(tag: str, args, min_cover: float) -> dict:
    """K1 against its plain version on ``args`` (mesh_tiles' arguments):
    face ids equal except at ≤ 1e-4 of pixels (ties on shared edges), zbuf
    and barycentrics within 1e-5 where the ids agree; both times."""
    import torch

    from recmv_tpu_torch.ops.mesh_raster import _mesh_tiles_torch, mesh_tiles

    got, want = mesh_tiles(*args), _mesh_tiles_torch(*args)
    torch.cuda.synchronize()
    same = got[1] == want[1]
    mismatch = (~same).float().mean().item()
    z_err = (got[0] - want[0])[same].abs().max().item()
    b_err = (got[2] - want[2]).movedim(2, -1)[same].abs().max().item()
    covered = (want[1] >= 0).float().mean().item()
    ms, plain_ms = cuda_ms(lambda: mesh_tiles(*args), 20), cuda_ms(lambda: _mesh_tiles_torch(*args), 3)
    log(f"[{tag}] mesh_tiles: frames {args[0].shape[0]} tiles {args[0].shape[1]} cap "
        f"{args[0].shape[3]} max count {int(args[2].max())} covered {covered:.4f} face-id "
        f"mismatch {mismatch:.2e} zbuf err {z_err:.3e} bary err {b_err:.3e} kernel {ms:.3f} ms "
        f"plain {plain_ms:.3f} ms")
    if mismatch > 1e-4 or z_err > 1e-5 or b_err > 1e-5 or covered < min_cover:
        raise AssertionError("mesh_tiles kernel disagrees with its plain version")
    return dict(max_abs_err=max(z_err, b_err), ms=ms, plain_ms=plain_ms)


def compare_composite_tiles(tag: str, args) -> dict:
    """K2 against its plain version on ``args`` (composite_tiles'
    arguments): within 1e-5 absolute; both times."""
    import torch

    from recmv_tpu_torch.ops.composite import _composite_tiles_torch, composite_tiles

    got, want = composite_tiles(*args), _composite_tiles_torch(*args)
    torch.cuda.synchronize()
    err = (got - want).abs().max().item()
    ms, plain_ms = cuda_ms(lambda: composite_tiles(*args), 20), cuda_ms(
        lambda: _composite_tiles_torch(*args), 3)
    log(f"[{tag}] composite_tiles: frames {args[0].shape[0]} tiles {args[0].shape[1]} cap "
        f"{args[0].shape[2]} channels {args[3].shape[2]} max count {int(args[5].max())} "
        f"coverage {want.mean().item():.4f} max abs err {err:.3e} kernel {ms:.3f} ms "
        f"plain {plain_ms:.3f} ms")
    if err > 1e-5 or want.max().item() < 0.5:
        raise AssertionError("composite_tiles kernel disagrees with its plain version")
    return dict(max_abs_err=err, ms=ms, plain_ms=plain_ms)


def check_kernels(dev) -> None:
    """Phase 2: each kernel against its plain version on a dense sphere at
    1080², tile 32, cap 512 (K1) and 768 with one channel (K2)."""
    import torch

    from recmv_tpu_torch.ops.rasterizer import composite_tile_inputs, mesh_tile_inputs

    scr, faces = sphere_screen_mesh(dev)
    args = mesh_tile_inputs(scr, faces, (IMAGE, IMAGE), tile=32, cap=512) + (32,)
    compare_mesh_tiles("2", args, min_cover=0.1)
    ones = torch.ones(scr.shape[1], 1, device=dev)
    args = composite_tile_inputs(scr, 0.006, ones, (IMAGE, IMAGE), tile=32, cap=768) + (32,)
    compare_composite_tiles("2", args)


def compare_composite_bwd(tag: str, args) -> dict:
    """K3 against its plain version on ``args`` (composite_tiles_bwd's
    arguments): within 1e-5 of the largest plain entry, and the same bits
    on a second launch; both times."""
    import torch

    from recmv_tpu_torch.ops.composite import _composite_tiles_bwd_torch, composite_tiles_bwd

    with torch.no_grad():      # the recorded arguments may carry a graph
        got, want = composite_tiles_bwd(*args), _composite_tiles_bwd_torch(*args)
        again = composite_tiles_bwd(*args)
        torch.cuda.synchronize()
        pairs = [(a, b, c) for a, b, c in zip(got, want, again) if b is not None]
        err = max((a - b).abs().max().item() for a, b, _ in pairs)
        scale = max(b.abs().max().item() for _, b, _ in pairs)
        same = all(torch.equal(a, c) for a, _, c in pairs)
        ms, plain_ms = cuda_ms(lambda: composite_tiles_bwd(*args), 20), cuda_ms(
            lambda: _composite_tiles_bwd_torch(*args), 3)
    log(f"[{tag}] composite_tiles_bwd: frames {args[0].shape[0]} tiles {args[0].shape[1]} cap "
        f"{args[0].shape[2]} channels {args[3].shape[2]} dfeat {bool(args[9])} max count "
        f"{int(args[5].max())} max |plain| {scale:.4e} max abs err {err:.3e} deterministic "
        f"{same} kernel {ms:.3f} ms plain {plain_ms:.3f} ms")
    if err > 1e-5 * scale or not same or scale <= 0.0:
        raise AssertionError("composite_tiles_bwd kernel disagrees with its plain version")
    return dict(max_abs_err=err, ms=ms, plain_ms=plain_ms)


def check_backward_kernel(dev) -> None:
    """Phase 9: K3 on the dense 1080² sphere of phase 2, cap 768, with a
    seeded upstream gradient; one channel (ones) and two (ones, a ramp),
    with and without the feature gradient."""
    import torch

    from recmv_tpu_torch.ops.rasterizer import composite_tile_inputs

    scr, _ = sphere_screen_mesh(dev)
    P = scr.shape[1]
    gen = torch.Generator(device=dev).manual_seed(1)
    for C in (1, 2):
        feats = torch.stack([torch.ones(P, device=dev),
                             torch.linspace(0.0, 1.0, P, device=dev)], 1)[:, :C]
        args = composite_tile_inputs(scr, 0.006, feats, (IMAGE, IMAGE), tile=32, cap=768)
        B, T = args[0].shape[:2]
        g = torch.randn(B, T, C, 32 * 32, generator=gen, device=dev)
        for need in (False, True):
            compare_composite_bwd("9", args + (32, g, need))


@contextlib.contextmanager
def rasterizer_kernels(composite, mesh):
    """Route the rasterizer's kernel calls through ``composite`` and
    ``mesh`` (phase 7)."""
    from recmv_tpu_torch.ops import rasterizer

    saved = rasterizer.composite_tiles, rasterizer.mesh_tiles
    rasterizer.composite_tiles, rasterizer.mesh_tiles = composite, mesh
    try:
        yield
    finally:
        rasterizer.composite_tiles, rasterizer.mesh_tiles = saved


def recording(fn, store: dict, name: str):
    """``fn`` that also keeps its last arguments in ``store[name]`` and,
    when its result requires grad, the gradient that reaches it in
    ``store[name + ".grad"]`` (the upstream gradient of its backward)."""

    def call(*args):
        store[name] = args
        out = fn(*args)
        if getattr(out, "requires_grad", False):
            out.register_hook(lambda g: store.__setitem__(name + ".grad", g))
        return out

    return call


def build_smoke_net(dev, work: str):
    """Phases 3-5: generate the scene, build the network, remesh.
    Returns (dataset, sampler, net)."""
    import numpy as np
    import torch

    from recmv_tpu_torch.config import ConfigFactory
    from recmv_tpu_torch.core.builder import build_opt_net, resolution_pyramids
    from recmv_tpu_torch.core.network import TrainConfig
    from recmv_tpu_torch.data.dataset import get_dataset_and_loader
    from recmv_tpu_torch.data.synthetic import generate_scene, shrink_garment_init

    scene = osp.join(work, "scene")
    t0 = time.time()
    generate_scene(scene, n_frames=FRAMES, image_size=IMAGE, skinner_res=SKINNER_RES,
                   device=dev)
    log(f"[3] generated {FRAMES} frames at {IMAGE}² in {time.time() - t0:.1f} s")

    t0 = time.time()
    conf = ConfigFactory.parse_file(osp.join(ROOT, "configs", "synthetic", "smoke.conf"))
    ds, sampler = get_dataset_and_loader(scene, {"deformer": 256, "render": 256}, 3,
                                         shuffle=True, garment_type="synthetic-tube",
                                         data_type="synthe")
    pyr = resolution_pyramids("coarse")
    Wg, Hg, Dg = pyr[-1]
    cap_v = 1 << int(np.ceil(np.log2(8 * max(Wg * Hg, Wg * Dg, Hg * Dg))))
    cfg = TrainConfig(mc_capacity_v=cap_v, mc_capacity_f=2 * cap_v,
                      mask_render_downscale=2, seed_downscale=2)
    net = build_opt_net(conf, ds, osp.join(work, "result"), resolutions=pyr,
                        skinner_res=SKINNER_RES, train_cfg=cfg, device=dev)
    shrink_garment_init(net.params)
    n_par = sum(p.numel() for k in ("sdf", "garment_sdfs", "translator", "render")
                for p in net.params[k].parameters())
    log(f"[4] built the network in {time.time() - t0:.1f} s: {n_par} parameters, "
        f"pyramid {pyr[0]} -> {pyr[-1]}, caps mesh {cfg.raster_cap_mesh} points "
        f"{cfg.raster_cap_points} tile {cfg.raster_tile}, sample_pix {cfg.sample_pix}, "
        f"solver {cfg.solver_times} steps, downscale mask {cfg.mask_render_downscale} "
        f"seed {cfg.seed_downscale}")

    t0 = time.time()
    net.marching_cube_update(RATIO)
    torch.cuda.synchronize()
    log(f"[5] remesh in {time.time() - t0:.1f} s: garment verts {net.mesh.garment_n} "
        f"faces {net.mesh.garment_fn} (buffers {[v.shape[0] for v in net.mesh.garment_vs]}), "
        f"body verts {net.mesh.body_n}")
    return ds, sampler, net


def timed_step(net, ds, fids, gen):
    """One forward step with a CUDA event after each phase → (info,
    solved, wall seconds, {phase: ms})."""
    import torch

    batch = ds.get_batch(fids)
    events = [("start", torch.cuda.Event(enable_timing=True))]
    events[0][1].record()

    def mark(name):
        e = torch.cuda.Event(enable_timing=True)
        e.record()
        events.append((name, e))

    t0 = time.time()
    info, solved = net.forward_step(batch, fids, RATIO, generator=gen, timer=mark)
    torch.cuda.synchronize()
    wall = time.time() - t0
    phase_ms = {n: events[i][1].elapsed_time(e) for i, (n, e) in enumerate(events[1:])}
    return info, solved, wall, phase_ms


def timed_train_step(net, ds, fids, gen):
    """One training step with a CUDA event after each phase → (loss,
    info, wall seconds, {phase: ms})."""
    import torch

    batch = ds.get_batch(fids)
    events = [("start", torch.cuda.Event(enable_timing=True))]
    events[0][1].record()

    def mark(name):
        e = torch.cuda.Event(enable_timing=True)
        e.record()
        events.append((name, e))

    t0 = time.time()
    loss, info = net.train_step(batch, fids, RATIO, generator=gen, timer=mark)
    torch.cuda.synchronize()
    wall = time.time() - t0
    phase_ms = {n: events[i][1].elapsed_time(e) for i, (n, e) in enumerate(events[1:])}
    return loss, info, wall, phase_ms


def train(net, ds, batches, gen, store) -> dict:
    """Phase 10: TRAIN_STEPS training steps from a fresh remesh, with the
    kernels' launch counts reset just before and read just after; the
    point composite's arguments and upstream gradient are recorded for
    phase 12. Returns the launch counts."""
    import numpy as np
    import torch

    from recmv_tpu_torch.ops import rasterizer
    from recmv_tpu_torch.ops.composite import composite_tiles, composite_tiles_bwd
    from recmv_tpu_torch.ops.mesh_raster import mesh_tiles

    before = {k: v.detach().clone() for k, v in net.global_leaves().items()}
    net.opt_times, net._remeshed_at = 0.0, -1.0          # a run starts with a remesh
    torch.cuda.reset_peak_memory_stats()
    steady = []
    mesh_tiles.launches = composite_tiles.launches = composite_tiles_bwd.launches = 0
    with rasterizer_kernels(recording(composite_tiles, store, "composite_tiles"),
                            rasterizer.mesh_tiles):
        for step, fids in enumerate(batches[:TRAIN_STEPS]):
            bwd0 = composite_tiles_bwd.launches
            loss, info, wall, phase_ms = timed_train_step(net, ds, fids, gen)
            bad = {k: v for k, v in info.items() if not math.isfinite(v)}
            if bad:
                raise AssertionError(f"non-finite training outputs: {bad}")
            if composite_tiles_bwd.launches <= bwd0:
                raise AssertionError("the training step did not launch composite_tiles_bwd")
            if info["tube_rayConv"] < 1:
                raise AssertionError("no ray converged")
            log(f"[10] {'start-up ' if step == 0 else ''}train step {step} frames "
                f"{list(map(int, fids))} wall {wall:.3f} s phases_ms "
                f"{json.dumps({k: round(v, 3) for k, v in phase_ms.items()})} loss {loss:.6f} "
                f"info {json.dumps({k: round(v, 6) for k, v in info.items()})}")
            if step > 0:
                steady.append((wall, phase_ms))
    torch.cuda.synchronize()
    launches = {"mesh_tiles": mesh_tiles.launches, "composite_tiles": composite_tiles.launches,
                "composite_tiles_bwd": composite_tiles_bwd.launches}
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    mean = {k: float(np.mean([p[k] for _, p in steady])) for k in steady[0][1]}
    log(f"[10] steady state over steps 1-{len(steady)}: wall mean "
        f"{np.mean([w for w, _ in steady]):.4f} s (min {min(w for w, _ in steady):.4f}, max "
        f"{max(w for w, _ in steady):.4f}) phases_ms mean "
        f"{json.dumps({k: round(v, 3) for k, v in mean.items()})} peak device memory "
        f"{peak:.3f} GiB launches {json.dumps(launches)}")
    if min(launches.values()) < 1:
        raise AssertionError(f"a kernel of the training path never launched: {launches}")
    after = net.global_leaves()
    if not all(bool(torch.isfinite(v).all()) for v in after.values()):
        raise AssertionError("non-finite parameters after training")
    moved = {k: (after[k].detach() - before[k]).abs().max().item() for k in before}
    must_move = ("garment_sdfs.", "translator.", "render.", "scene.poses", "scene.trans",
                 "scene.conds.deformer", "scene.camera.focal_length",
                 "scene.camera.princeple_points", "scene.camera.world2cam_coord_trans")
    still = [k for k in moved if k.startswith(must_move) and moved[k] == 0.0]
    frozen = {k: moved[k] for k in ("scene.shape", "scene.camera.cam2world_coord_quat")}
    groups = {g: max(v for k, v in moved.items() if k.startswith(g)) for g in must_move}
    log(f"[10] largest change per group {json.dumps({k: float(f'{v:.3e}') for k, v in groups.items()})} "
        f"frozen {json.dumps(frozen)}")
    if any(groups[g] == 0.0 for g in must_move) or any(frozen.values()):
        raise AssertionError(f"trained leaves unchanged or frozen leaves moved: "
                             f"{[g for g in must_move if groups[g] == 0.0]} {frozen}")
    if still:
        log(f"[10] leaves with no change (no gradient reached them): {still}")
    return launches


def branch_backward(net, ds, fids, dev) -> None:
    """Phase 11: the ② mask branch of a training batch, forward and
    backward, with the kernels and with the plain versions: the same loss,
    and vertex and translator gradients within 1e-4 of the largest entry
    (K2/K3 against their plain versions, and the gradient scatters'
    atomics, sum in other orders)."""
    import numpy as np
    import torch

    from recmv_tpu_torch.ops.composite import composite_tiles, composite_tiles_plain
    from recmv_tpu_torch.ops.mesh_raster import _mesh_tiles_torch, mesh_tiles

    fids_t = torch.as_tensor(np.asarray(fids) + ds.start_idx, device=dev)
    dev_b = net.device_batch(ds.get_batch(fids))
    gt = [dev_b[k] for k in net._garment_mask_keys()]
    counts = torch.as_tensor(net.mesh.garment_n, device=dev)
    tr = list(net.params["translator"].parameters())
    runs = []
    for comp, mesh in ((composite_tiles, mesh_tiles), (composite_tiles_plain, _mesh_tiles_torch)):
        vs = [v.detach().requires_grad_(True) for v in net.mesh.garment_vs]
        with rasterizer_kernels(comp, mesh):
            loss = net.pc_branch_loss(vs, fids_t, gt, RATIO, counts,
                                      body_mask=dev_b.get("body"))[0]
            grads = torch.autograd.grad(loss, vs + tr)
        runs.append((loss.item(), grads))
    torch.cuda.synchronize()
    (l_k, g_k), (l_p, g_p) = runs
    errs = [((a - b).abs().max().item(), b.abs().max().item()) for a, b in zip(g_k, g_p)]
    worst = max(e / max(m, 1e-30) for e, m in errs)
    log(f"[11] mask branch forward + backward with plain versions: loss {l_k:.6f} vs {l_p:.6f}, "
        f"vertex grad max abs err {errs[0][0]:.3e} (max {errs[0][1]:.3e}), translator grads worst "
        f"relative err {worst:.3e}")
    if abs(l_k - l_p) > 1e-5 or worst > 1e-4 or errs[0][1] <= 0.0:
        raise AssertionError("the mask branch's gradients differ between kernels and plain versions")


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs the port on the card",
              file=sys.stderr)
        return 2
    import numpy as np

    from recmv_tpu_torch import _build
    from recmv_tpu_torch.ops.composite import _composite_tiles_torch, composite_tiles
    from recmv_tpu_torch.ops.mesh_raster import _mesh_tiles_torch, mesh_tiles

    dev = torch.device("cuda:0")
    card = card_line()
    log(f"[0] torch {torch.__version__} cuda {torch.version.cuda} device "
        f"{torch.cuda.get_device_name(0)} ({card})")

    t0 = time.time()
    _build.build_all()
    log(f"[1] built kernels and host marching cubes in {time.time() - t0:.1f} s")

    check_kernels(dev)
    check_backward_kernel(dev)
    ds, sampler, net = build_smoke_net(dev, tempfile.mkdtemp(prefix="recmv_chip_smoke_"))

    batches = []
    while len(batches) < 3 + TRAIN_STEPS:
        batches.extend(list(sampler))
    gen = torch.Generator(device=dev).manual_seed(0)
    mesh_tiles.launches = 0
    composite_tiles.launches = 0
    for step, fids in enumerate(batches[:3]):
        info, solved, wall, phase_ms = timed_step(net, ds, fids, gen)
        bad = {k: v for k, v in info.items() if not math.isfinite(v)}
        if bad:
            raise AssertionError(f"non-finite outputs: {bad}")
        for sd in solved:
            if not bool(torch.isfinite(sd["pts"]).all()):
                raise AssertionError("non-finite solved points")
        log(f"[6] step {step} frames {list(map(int, fids))} wall {wall:.3f} s "
            f"phases_ms {json.dumps({k: round(v, 3) for k, v in phase_ms.items()})} "
            f"info {json.dumps({k: round(v, 6) for k, v in info.items()})} "
            f"launches mesh_tiles {mesh_tiles.launches} composite_tiles "
            f"{composite_tiles.launches}")
    launches = {"mesh_tiles": mesh_tiles.launches, "composite_tiles": composite_tiles.launches}
    if min(launches.values()) < 1:
        raise AssertionError(f"a kernel of the main path never launched: {launches}")
    if info["tube_rayConv"] < 1:
        raise AssertionError("no ray converged")

    # phase 7: the same mask branch and seeding with the plain versions;
    # the kernel run keeps each kernel's arguments for phase 8
    fids_t = torch.as_tensor(np.asarray(fids) + ds.start_idx, device=dev)
    main_args = {}
    with torch.no_grad():
        dev_b = net.device_batch(ds.get_batch(fids))
        gt = [dev_b[k] for k in net._garment_mask_keys()]
        counts = torch.as_tensor(net.mesh.garment_n, device=dev)
        s = net.cfg.seed_downscale
        uni = [torch.rand(len(fids) * (IMAGE // s) ** 2, generator=gen, device=dev)]
        runs = []
        for ctx in (rasterizer_kernels(recording(composite_tiles, main_args, "composite_tiles"),
                                       recording(mesh_tiles, main_args, "mesh_tiles")),
                    rasterizer_kernels(_composite_tiles_torch, _mesh_tiles_torch)):
            with ctx:
                loss, (_, masks, def_vs) = net.pc_branch_loss(
                    net.mesh.garment_vs, fids_t, gt, RATIO, counts, body_mask=dev_b.get("body"))
                rays = net.find_and_sample_rays(fids_t, gt, RATIO, net.mesh.garment_vs,
                                                net.mesh.garment_fs, def_vs=def_vs,
                                                uniforms=uni)
            runs.append((float(loss), masks, rays[0]))
    (l_k, m_k, r_k), (l_p, m_p, r_p) = runs
    m_err = (m_k - m_p).abs().max().item()
    seeds_same = torch.stack([r_k[k] == r_p[k] for k in ("valid", "batch_inds", "rows", "cols")]
                             ).all(0).float().mean().item()
    log(f"[7] main path with plain versions: mask loss {l_k:.6f} vs {l_p:.6f}, mask max abs "
        f"err {m_err:.3e}, seeds equal {seeds_same:.5f}, valid seeds "
        f"{int(r_k['valid'].sum())}")
    if m_err > 1e-5 or abs(l_k - l_p) > 1e-5 or seeds_same < 0.999:
        raise AssertionError("the main path differs between kernels and plain versions")

    # phase 8: each kernel against its plain version on the arguments the
    # main path gave it in phase 7, with both times
    kres = {"mesh_tiles": compare_mesh_tiles("8", main_args["mesh_tiles"], min_cover=0.01),
            "composite_tiles": compare_composite_tiles("8", main_args["composite_tiles"])}

    # phases 10-12: training
    train_args = {}
    launches = train(net, ds, batches[3:], gen, train_args)
    branch_backward(net, ds, batches[-1], dev)
    fwd = train_args["composite_tiles"]
    kres["composite_tiles_bwd"] = compare_composite_bwd(
        "12", fwd + (train_args["composite_tiles.grad"].contiguous(), fwd[3].requires_grad))

    sources = {"mesh_tiles": ("recmv_tpu_torch/csrc/mesh_raster.cu",
                              "recmv_tpu/ops/pallas_raster.py:31"),
               "composite_tiles": ("recmv_tpu_torch/csrc/composite_fwd.cu",
                                   "recmv_tpu/ops/pallas_composite.py:49"),
               "composite_tiles_bwd": ("recmv_tpu_torch/csrc/composite_bwd.cu",
                                       "recmv_tpu/ops/pallas_composite.py:88")}
    kernels = [dict(name=n, route="cuda", source=sources[n][0], replaces=sources[n][1],
                    launches=launches[n], **kres[n]) for n in sources]
    print(json.dumps({"kernels": kernels}))
    print(card)
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
