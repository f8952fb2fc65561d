"""Smoke run of the PyTorch port (``recmv_tpu_torch``) on one CUDA device.

    python3 chip_smoke.py

Phases, one printed line each (or more):
1. build the CUDA kernels (nvcc, sm_90a), the host marching cubes and the
   host image decoder (g++) from the sources in the checkout, and print
   ptxas's registers, shared memory and spills for each kernel;
2. each kernel against its plain PyTorch version on the card, at the
   main path's shapes (1080², tile 32, cap 512 for the mesh z-buffer,
   which must give the same bits; cap 768 and one channel for the point
   composite), with both times, the work behind the kernel's bound (Σcnt,
   and the covered or live (pixel, candidate) pairs), the bound and, for
   the mesh z-buffer, the faces a warp lists per 8×4 sub-tile (mean, max);
3. generate a synthetic-tube scene on the card: 32 frames at 1080² (more
   than the DCT prior's window of 30), skinning field (129, 225, 65);
4. build the network on it at the flagship widths (SDF 8×512 + 256
   features, translator 4×512 with 128-d latents, render 4×512), the
   coarse seg3d pyramid and the production caps; (4b) give it the scene's
   feature curves: each curve its canonical boundary ring resampled to
   200 points, through ``align_fl`` with t = 0, s = 1 (an exact fit, as
   the initialization would hand it over);
5. remesh (seg3d + the device marching cubes);
6. three forward steps over batches of 3 frames (mask branch, ray
   seeding, surface solve, IDR colour), with per-phase CUDA-event times
   and the kernels' launch counts, which must rise;
7. the mask branch and the ray seeding of the last batch once more with
   the plain versions in place of the kernels: same masks, same seeds;
8. each kernel against its plain version on the very arguments the main
   path gave it in phase 7 (3 frames at 540², tile 32; cap 512 for the
   seeding z-buffer, cap 1536 for the mask composite), with both times,
   the work and the bound as in phase 2;
9. the composite's backward (K3) against its plain version on the 1080²
   sphere of phase 2 with a seeded upstream gradient, cap 768, one and
   two channels, with and without the feature gradient, with the work
   and the bound;
10. six training steps (``train_step``, the whole fused step: ① curves,
    ② mask, ③ main) over batches of 3 frames, the first one remeshing,
    with per-phase CUDA-event times (remesh, batch upload, ① fl forward +
    backward + AdamW, ② pc forward + backward, vertex update, rays,
    solve, ③ main forward + backward, global update), the first step
    reported apart; every info scalar, gradient norm and parameter
    finite, ①'s gradient norm above 0, three mesh z-buffer launches a step
    (① body and garment z-buffers, seeding), rays converged, the trained
    leaves and the curves moved and the frozen ones (shape, camera quat)
    not; after ① of the first step no global leaf, gradient or vertex has
    changed; the launch counts of all three kernels, peak device memory;
    (8b) the mesh z-buffer against its plain version on the arguments of
    the last step's ① body and garment z-buffers (3 frames at 270² of
    1080², tile 32, cap 512), as in phase 8;
11. the ② branch of a training batch, forward and backward, once with
    the kernels and once with the plain versions: same loss, vertex and
    translator gradients;
12. K3 against its plain version on the arguments the training step gave
    it (3 frames at 540², cap 1536, one channel, no feature gradient),
    with both times, the work and the bound;
13. ① of a training batch, forward and backward to the curves, once with
    the kernels and once with the plain versions: the same visibility
    masks, the same loss, the same curve gradients;
14. the synthetic-two scene (upper tube and skirt, ``smoke_two.conf``,
    ``zbuff_and``) at the flagship widths, 8 frames at 540², with its
    three feature curves: three training steps, each with a finite
    curve-aware term, five mesh z-buffer launches (① body, two ①
    garment, two seeding) and the point composite over two channels; then
    each kernel against its plain version on the arguments of the last
    step: the mesh z-buffer on all five z-buffers (135² and 270², tile 32,
    cap 512), the composite forward and backward on the two-channel mask
    render, as in phases 8 and 12;
15. the training CLI, ``recmv_tpu_torch.train.main``, in process on a
    synthetic-tube scene of 16 frames at 1080² with ``smoke.conf`` less
    its ``train.caps`` block (the scene-derived production caps, the
    flagship widths, the coarse pyramid): the one-time initialization
    (60 IGR epochs, the conf's ``initial_iters``; 150 curve iterations),
    4 training steps and ``latest.ckpt``, then a second run resumed from
    it for 2 steps, with the kernels' launch counts set to 0 before the
    first run and read after the second. It prints each part of the
    initialization (the IGR fits with ms per epoch and last loss), the
    fitted T and s of each curve beside the scene's ring, the garment
    mesh of the first remesh against its clip box, each step's time and
    converged rays beside phase 10's, K1's launches in the
    initialization; then each kernel against its plain version on the
    arguments this phase gave it: K1 on ``initialize_fl``'s gate (16
    frames at 270²) and on the last step's three z-buffers (① body and
    garment at 270², seeding at 540², of the initialized garment), K2 and
    K3 on the last step's mask composite, as in phases 8b and 12. It
    raises on a non-finite output, missing curves or checkpoints, a
    garment surface outside its clip box (by more than a grid cell), a
    reload that differs from the saved parameters by a bit, a resume at
    another epoch or step count, a step with no converged ray or other
    than three K1 launches, or a kernel of the path that never launched;
16. inference on phase 15's fitted scene through the inference CLIs, in
    process, with the kernels' launch counts set to 0 before and read
    after: ``recmv_tpu_torch.infer.main`` on frames 0 and 1 (registration
    at the production NRICP schedules, 200 + 100 epochs; images and
    colours), ``--curves-only`` on the same frames, and
    ``recmv_tpu_torch.infer_animation.main`` on an 8-pose motion (the
    A-pose under a yaw sweep) in a directory holding the registration.
    It prints the registration's seconds by stage (Laplacian alignment,
    visibility scan, NRICP coarse, remesh, NRICP refine), its vertex and
    face counts and surviving boundary labels, the one-sided mean
    distance from the registered vertices to the MC vertices, maskE per
    frame, the colour pass's hit and converged pixels and seconds,
    seconds per exported and per animated frame, K1's launches and the
    tiles at the cap by kind (the 12-view 512² scan, the 1080² frames),
    with the card's name and power limit; then K1 against its plain
    version on the scan's arguments and on the first 1080² Phong
    z-buffer, as in phase 8, and the whole visibility scan with the
    kernels and with the plain versions, which must mark the same
    vertices; then the scan and frame 0's Phong render again at a mesh
    cap of 4,096, with the vertices and pixels that change; last,
    ``infer.main`` with ``--quality higher --curves-only``: the 513³
    extraction of a fresh body and garments into the host path's
    buffers, with its counts and seconds. It raises on a missing export,
    a non-finite or empty result, a registration farther than 0.05 from
    the MC surface on average, a ``higher`` garment with no more vertices
    than the coarse one, or a kernel of the path that never launched;
17. the body priors, the debug renders and the large-pose stage, with
    the kernels' launch counts set to 0 before and read after: a
    synthetic-tube scene of 16 frames at 1080² made a large-pose scene
    (feature lines on frames 0-7 only, a depth drift after them, a TCMR
    pickle written gzip-compressed without joblib with the synthetic body's
    2D joints at betas (1.0, −0.5)); stage 1, ``train.main`` in process with
    ``smoke.conf`` less its caps and ``data_type = large_pose`` and
    ``--save-debug``: the beta pre-fit on the cold skinner cache (its
    seconds, betas and mean reprojection error before and after), the
    60-epoch initialization, 4 steps and the debug renders after the
    first step's remesh (``save_debug``'s overlays and silhouettes, one
    K1 launch for the batch's frames; the 8-view 256² turntable, one K1
    launch at cap 256), with their seconds; stage 2,
    ``train_large_pose.main --start-epoch 0 --max-steps 4`` on frames
    8-15: each step's time by phase, converged rays and launches. Then
    K1 against its plain version on the turntable's arguments and on the
    silhouette's, K2 and K3 on the last large-pose step's mask composite,
    as in phases 8 and 12. It raises unless the pre-fit lowers the error,
    the debug PNGs and turntable exist, each large-pose step runs no ①
    and launches K1 (ray seeding), K2 and K3 once each, and
    ``large_pose.ckpt`` holds ``latest.ckpt``'s SDF leaves bit for bit
    with a moved translator;
18. the port's benches, with the kernels' launch counts set to 0 before
    and read after: ``tools.bench_fullstep.main`` at full width (a
    4-frame synthetic-tube scene at 1080², the fine pyramid (321, 417,
    225) with the marching cubes' buffers for it, 2,048 rays, batch 1, 40
    IGR epochs, the first step, 2 timed steps, a warm remesh and the
    counted step of ``step_cost_analysis``), printing its seconds per
    step, remesh seconds, ``step_gflops`` and ``mfu_pct_vs_f32_peak``;
    then K1 against its plain version on the last step's three z-buffers
    (① body and garment, seeding), K2 and K3 on its mask composite, as in
    phases 8 and 12, each with its time, bound, share, Σcnt and pairs;
    ``tools.bench_quality.main`` at a reduced size (128 px, 4 frames, 12
    steps, 40 IGR epochs, the quick NRICP schedules), whose scores must be
    finite and whose keys must hold those of the root
    ``bench_quality.json``; the hot step (``recmv_tpu_torch.bench.main``,
    8,192 rays, 3 timed iterations) and its summary line. It raises on a
    non-finite result, a missing key or a kernel of the benches' path that
    never launched;
19. the remesh's parts and the last tools, with the kernels' launch
    counts set to 0 before the tools and read after: on phase 18's
    fine-pyramid net, 3 times, seg3d, the device marching cubes and the
    path it replaced (the volume to the host and ``marching_cubes_host``)
    by CUDA events; the device mesh equal to the host mesh up to a vertex
    permutation (faces equal through the map, vertices within the CPU
    tests' tolerance) and to the same function on the volume's CPU copy in
    order; two
    warm ``marching_cube_update``; on phase 15's scene at the ``higher``
    pyramid (513³), seg3d and the device marching cubes with the peak
    device memory of each (for the record: ``higher`` keeps the host
    path) beside the host path's time; then the six ported tools
    (``generate_normals``, ``parsing_mask_to_fl``, ``mask2parsing_mask``,
    ``visualize``, ``visualize_curve``, ``comparison_results``) on phase
    15's scene and phase 16's exports, each with its seconds and K1
    launches, and K1 against its plain version on the first normal map's
    arguments (1080², tile 32, cap 1024). It raises on a disagreeing mesh,
    a missing output or a kernel of the tools' path that never launched;
20. the scene inputs that OpenCV and joblib read for the JAX package, with
    the kernels' launch counts set to 0 before the training and read
    after: every committed fixture of ``tests/torch_fixtures`` (JPEGs in
    each mode, PNGs in each colour type, depth, interlace and filter, EXIF
    orientations, five compressed joblib dumps) read by the port and held
    against the ``cv2.imread`` arrays and dump contents stored beside
    them; ms per read, by host clock over 10 reads, of the 1080² JPEG
    fixture, its PIL-written PNG twin and the same pixels written by
    ``png.imwrite``, with the host CPU and the card line; a copy of phase
    15's scene with that JPEG (frame 0 of the scene, rendered on the CPU,
    quality 95, 4:2:0) in place of ``imgs/0.png`` and a gzip-compressed
    TCMR dump, loaded by ``SceneDataset`` (frame 0 from the ``.jpg`` path,
    its mean absolute difference from the PNG frame) and trained by
    ``train.main`` for 2 steps resumed from phase 15's ``latest.ckpt``.
    It raises on a fixture that differs, a frame more than 2 levels from
    the PNG on average, or a step that is not finite or does not launch
    K1 three times and K2 and K3 once each.

A kernel's bound is the larger of the bytes it must move (each input
read once: the listed candidates, the counts, the upstream gradient;
each output written once) over 3.35 TB/s and the operations the live
pairs need over 67 TFLOP/s (H100 SXM float32, published peaks). Then a
JSON line with each kernel's record (launches from the training run of
phase 10, K1's with phases 16's and 19's added, all three with phases
17's, 18's and 20's added;
error, times and bound from phases 8 and 12; no PyTorch call
computes these functions, so ``library_ms`` is null), the card's name and
power limit, and last ``{"ok": true, "device": {...}}``. Any failure
raises and the exit code is not 0. Without CUDA it exits with 2 before
any work.
"""
from __future__ import annotations

import contextlib
import gzip
import json
import math
import os
import os.path as osp
import pickle
import sys
import tempfile
import time

from recmv_tpu_torch.tools import card_line  # the card's name and power limit (nvidia-smi)

ROOT = osp.dirname(osp.abspath(__file__))
RATIO = {"sdfRatio": 1.0, "deformerRatio": 0.5, "renderRatio": 1.0}
IMAGE = 1080
FRAMES = 32
TRAIN_STEPS = 6
TWO_IMAGE, TWO_FRAMES = 540, 8  # the two-garment phase's scene
CLI_FRAMES, CLI_INIT_EPOCHS = 16, 60   # the CLI phase: smoke.conf's initial_iters
CLI_STEPS, CLI_RESUME_STEPS = 4, 2
CLI_QUALITY = "coarse"                 # the CLI's default pyramid
INFER_FRAMES = (0, 1)                  # the inference phase's exported frames
ANIM_POSES = 8                         # the animation's motion
REG_DIST_BOUND = 0.05                  # mean registered -> MC distance the phase accepts
CAP_PROBE = 4096                       # the larger mesh cap phase 16 compares with
LP_ANNOTATED, LP_STEPS = 8, 4          # phase 17: the A-pose range, large-pose steps
LP_TARGET_BETAS = (1.0, -0.5)          # the betas of the scene's TCMR joints
FS_STEPS = 2                           # phase 18: bench_fullstep's timed steps
QUALITY_ARGS = ["--image", "128", "--frames", "4", "--steps", "12", "--init-epochs", "40"]
HOT_ITERS = 3                          # phase 18: the hot step's timed iterations
DECODE_REPS, INPUT_STEPS = 10, 2       # phase 20: timed reads per file, steps on the copy
FIXTURES = osp.join(ROOT, "tests", "torch_fixtures")
SKINNER_RES = (129, 225, 65)


def log(msg: str) -> None:
    print(msg, flush=True)


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


def ptxas_summary(log: str) -> list:
    """One line per kernel from ptxas's verbose output: registers, stack,
    spills and shared memory of each compiled entry function."""
    import re

    lines, name, frame = [], None, ""
    for ln in log.splitlines():
        if "Compiling entry function" in ln:
            name = ln.split("'")[1] if "'" in ln else ln.split()[-1]
            m = re.search(r"\d+([a-z_]+_kernel)(I\w*?EE)?", name)
            if m:
                args = re.findall(r"L[a-z](\d+)E", m.group(2) or "")
                name = m.group(1) + (f"<{','.join(args)}>" if args else "")
        elif "spill stores" in ln:
            frame = ln.strip()
        elif "Used" in ln and "registers" in ln and name:
            lines.append(f"{name}: {ln.split(':', 1)[1].strip()}; {frame}")
            name, frame = None, ""
    return lines


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


def warp_lists(args) -> tuple:
    """(mean, max) of the faces a warp of K1 lists for one 8×4 sub-tile on
    ``args`` (mesh_tiles' arguments), from the cull's plain model
    ``subtile_keep_faces``; the mean over the sub-tiles of tiles with
    candidates."""
    import torch

    from recmv_tpu_torch.ops.mesh_raster import subtile_keep_faces

    prm, _, cnt, Wt, tile = args
    with torch.no_grad():
        live = torch.arange(prm.shape[3], device=prm.device) < cnt[..., None]
        listed = (subtile_keep_faces(prm, Wt, tile) & live[:, :, None, :]).sum(-1)
        busy = (cnt > 0)[..., None].expand_as(listed)
        return listed[busy].float().mean().item(), int(listed.max())


def compare_mesh_tiles(tag: str, args, min_cover: float) -> dict:
    """K1 against its plain version on ``args`` (mesh_tiles' arguments):
    the same bits in zbuf, face ids and barycentrics; both times, the
    per-warp list lengths and the bound."""
    import torch

    from recmv_tpu_torch.ops.mesh_raster import _mesh_tiles_torch, mesh_tiles
    from recmv_tpu_torch.utils.profiling import bound, mesh_tiles_cost

    with torch.no_grad():
        got, want = mesh_tiles(*args), _mesh_tiles_torch(*args)
        torch.cuda.synchronize()
        same = all(torch.equal(a, b) for a, b in zip(got, want))
        mismatch = (got[1] != want[1]).float().mean().item()
        z_err = (got[0] - want[0]).abs().max().item()
        b_err = (got[2] - want[2]).abs().max().item()
        covered = (want[1] >= 0).float().mean().item()
        ms = cuda_ms(lambda: mesh_tiles(*args), 20)
        plain_ms = cuda_ms(lambda: _mesh_tiles_torch(*args), 3)
        list_mean, list_max = warp_lists(args)
    cost = mesh_tiles_cost(args)
    sum_cnt, pairs = cost["sum_cnt"], cost["pairs"]
    B, T = args[2].shape
    b = bound(cost["bytes"], cost["flops"])
    log(f"[{tag}] mesh_tiles: frames {B} tiles {T} cap {args[0].shape[3]} max count "
        f"{int(args[2].max())} sum count {sum_cnt} covered pairs {pairs} covered {covered:.4f} "
        f"faces listed per warp mean {list_mean:.2f} max {list_max} same bits {same} face-id "
        f"mismatch {mismatch:.2e} zbuf err {z_err:.3e} bary err {b_err:.3e} kernel {ms:.4f} ms "
        f"plain {plain_ms:.3f} ms bound {b['bound_ms']:.5f} ms ({b['bound_by']}, share "
        f"{b['bound_ms'] / ms:.4f})")
    if not same or covered < min_cover:
        raise AssertionError("mesh_tiles kernel disagrees with its plain version")
    return dict(max_abs_err=max(z_err, b_err), ms=ms, plain_ms=plain_ms, **b, library_ms=None)


def compare_composite_tiles(tag: str, args) -> dict:
    """K2 against its plain version on ``args`` (composite_tiles'
    arguments): within 1e-5 absolute; both times."""
    import torch

    from recmv_tpu_torch.ops.composite import _composite_tiles_torch, composite_tiles
    from recmv_tpu_torch.utils.profiling import bound, composite_tiles_cost

    with torch.no_grad():      # the recorded arguments may carry a graph
        got, want = composite_tiles(*args), _composite_tiles_torch(*args)
        torch.cuda.synchronize()
        err = (got - want).abs().max().item()
        ms, plain_ms = cuda_ms(lambda: composite_tiles(*args), 20), cuda_ms(
            lambda: _composite_tiles_torch(*args), 3)
    cost = composite_tiles_cost(args)
    sum_cnt, live = cost["sum_cnt"], cost["pairs"]
    (B, T, cap), C = args[0].shape, args[3].shape[2]
    b = bound(cost["bytes"], cost["flops"])
    log(f"[{tag}] composite_tiles: frames {B} tiles {T} cap {cap} channels {C} max count "
        f"{int(args[5].max())} sum count {sum_cnt} live pairs {live} coverage "
        f"{want.mean().item():.4f} max abs err {err:.3e} kernel {ms:.4f} ms plain "
        f"{plain_ms:.3f} ms bound {b['bound_ms']:.5f} ms ({b['bound_by']}, share "
        f"{b['bound_ms'] / ms:.4f})")
    if err > 1e-5 or want.max().item() < 0.5:
        raise AssertionError("composite_tiles kernel disagrees with its plain version")
    return dict(max_abs_err=err, ms=ms, plain_ms=plain_ms, **b, library_ms=None)


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
    from recmv_tpu_torch.utils.profiling import bound, composite_tiles_bwd_cost

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
    cost = composite_tiles_bwd_cost(args)
    sum_cnt, live = cost["sum_cnt"], cost["pairs"]
    (B, T, cap), C, need = args[0].shape, args[3].shape[2], bool(args[9])
    b = bound(cost["bytes"], cost["flops"])
    log(f"[{tag}] composite_tiles_bwd: frames {B} tiles {T} cap {cap} channels {C} dfeat "
        f"{need} max count {int(args[5].max())} sum count {sum_cnt} live pairs {live} max "
        f"|plain| {scale:.4e} max abs err {err:.3e} deterministic {same} kernel {ms:.4f} ms "
        f"plain {plain_ms:.3f} ms bound {b['bound_ms']:.5f} ms ({b['bound_by']}, share "
        f"{b['bound_ms'] / ms:.4f})")
    if err > 1e-5 * scale or not same or scale <= 0.0:
        raise AssertionError("composite_tiles_bwd kernel disagrees with its plain version")
    return dict(max_abs_err=err, ms=ms, plain_ms=plain_ms, **b, library_ms=None)


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


def recording_calls(fn, calls: list):
    """``fn`` that also appends the arguments of each call to ``calls``."""

    def call(*args):
        calls.append(args)
        return fn(*args)

    return call


def recording_results(fn, results: list):
    """``fn`` that also appends (first argument after ``self``, result) of
    each call of the method ``fn`` to ``results``."""

    def call(self, *args):
        out = fn(self, *args)
        results.append((args[0] if args else None, out))
        return out

    return call


@contextlib.contextmanager
def recording_masks(masks: list):
    """Append every visibility mask ``fl_branch_loss`` takes to ``masks``."""
    from recmv_tpu_torch.core import visibility

    combine = visibility.combine_visibility

    def call(*args):
        out = combine(*args)
        masks.append(out.clone())
        return out

    visibility.combine_visibility = call
    try:
        yield
    finally:
        visibility.combine_visibility = combine


def scene_curves(garment_type: str) -> tuple:
    """``align_fl``'s arguments for a synthetic scene as an exact fit gives
    them: each curve of ``SCENE_CURVES`` its canonical boundary ring
    resampled to 200 points, aligned = template, t = 0, s = 1."""
    import numpy as np

    from recmv_tpu_torch.data.synthetic import SCENE_CURVES, boundary_ring
    from recmv_tpu_torch.geometry.polygons import uniform_sample_3d

    rings = {name: uniform_sample_3d(boundary_ring(y, offset=off), 200).astype(np.float32)
             for name, y, off in SCENE_CURVES[garment_type]}
    rigid = {name: (np.zeros(3, np.float32), np.float32(1.0)) for name in rings}
    return rings, rings, rigid


def build_smoke_net(dev, work: str, garment_type: str = "synthetic-tube", frames=None,
                    image=None, phase: str | None = None):
    """Phases 3-5: generate the scene (``FRAMES`` frames at ``IMAGE``²
    unless given), build the network and give it the scene's curves (4b),
    remesh; the lines are labelled ``phase`` where given. Returns
    (dataset, sampler, net)."""
    import torch

    from recmv_tpu_torch.config import ConfigFactory
    from recmv_tpu_torch.config.constants import TEMPLATE_GARMENT
    from recmv_tpu_torch.core.builder import build_opt_net, resolution_pyramids, scene_caps
    from recmv_tpu_torch.core.network import TrainConfig
    from recmv_tpu_torch.data.dataset import get_dataset_and_loader
    from recmv_tpu_torch.data.synthetic import generate_scene, shrink_garment_init

    frames, image = frames or FRAMES, image or IMAGE
    p3, p4, p5 = (phase,) * 3 if phase else ("3", "4", "5")
    scene = osp.join(work, "scene")
    t0 = time.time()
    generate_scene(scene, n_frames=frames, image_size=image, skinner_res=SKINNER_RES,
                   garment_type=garment_type, device=dev)
    log(f"[{p3}] generated {garment_type}: {frames} frames at {image}² in "
        f"{time.time() - t0:.1f} s")

    t0 = time.time()
    conf_name = {"synthetic-tube": "smoke.conf", "synthetic-two": "smoke_two.conf"}[garment_type]
    conf = ConfigFactory.parse_file(osp.join(ROOT, "configs", "synthetic", conf_name))
    G = len(TEMPLATE_GARMENT[garment_type])
    ds, sampler = get_dataset_and_loader(scene, {"deformer": 128 * (1 + G), "render": 256}, 3,
                                         shuffle=True, garment_type=garment_type,
                                         data_type="synthe")
    pyr = resolution_pyramids("coarse")
    cfg = TrainConfig(**scene_caps((image, image), pyr))      # production caps, not the conf's
    net = build_opt_net(conf, ds, osp.join(work, "result"), resolutions=pyr,
                        skinner_res=SKINNER_RES, train_cfg=cfg, device=dev)
    shrink_garment_init(net.params)
    n_par = sum(p.numel() for k in ("sdf", "garment_sdfs", "translator", "render")
                for p in net.params[k].parameters())
    log(f"[{p4}] built the network in {time.time() - t0:.1f} s: {n_par} parameters, "
        f"garments {list(net.statics.garment_names)}, pyramid {pyr[0]} -> {pyr[-1]}, caps "
        f"mesh {cfg.raster_cap_mesh} points {cfg.raster_cap_points} tile {cfg.raster_tile}, "
        f"sample_pix {cfg.sample_pix}, solver {cfg.solver_times} steps, downscale mask "
        f"{cfg.mask_render_downscale} seed {cfg.seed_downscale} z-buffer {cfg.zbuf_downscale}, "
        f"fl_visible_method {net.conf.get_string('fl_visible_method')}")
    _, statics = net.align_fl(*scene_curves(garment_type))
    log(f"[{p4}b] curves {list(statics.fl_names)}, {statics.v_dirs.shape[1]} points each, "
        f"radii {[round(float(r), 4) for r in statics.init_scale.mean((1, 2))]}; body mesh "
        f"{net.tmp_body_vs.shape[0]} verts {net.tmp_body_fs.shape[0]} faces")

    t0 = time.time()
    net.marching_cube_update(RATIO)
    torch.cuda.synchronize()
    log(f"[{p5}] remesh in {time.time() - t0:.1f} s: garment verts {net.mesh.garment_n} "
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


def timed_train_step(net, ds, fids, gen, on_phase=None):
    """One training step with a CUDA event after each phase → (loss,
    info, wall seconds, {phase: ms}); ``on_phase``, if given, is called
    with each phase name after its event."""
    import torch

    batch = ds.get_batch(fids)
    events = [("start", torch.cuda.Event(enable_timing=True))]
    events[0][1].record()

    def mark(name):
        e = torch.cuda.Event(enable_timing=True)
        e.record()
        events.append((name, e))
        if on_phase is not None:
            on_phase(name)

    t0 = time.time()
    loss, info = net.train_step(batch, fids, RATIO, generator=gen, timer=mark)
    torch.cuda.synchronize()
    wall = time.time() - t0
    phase_ms = {n: events[i][1].elapsed_time(e) for i, (n, e) in enumerate(events[1:])}
    return loss, info, wall, phase_ms


def fl_isolation_check(net, tag: str):
    """A phase hook for one training step: after the remesh it keeps the
    global leaves and the mesh vertices; after ① it requires them
    unchanged and no gradient on any global leaf (① updates the curves
    alone)."""
    import torch

    kept = {}

    def hook(name):
        if name == "remesh":
            kept["leaves"] = {k: v.detach().clone() for k, v in net.global_leaves().items()}
            kept["verts"] = [v.detach().clone() for v in net.mesh.garment_vs]
        elif name == "fl":
            leaves = net.global_leaves()
            moved = [k for k, v in kept["leaves"].items() if not torch.equal(leaves[k], v)]
            graded = [k for k, v in leaves.items() if v.grad is not None]
            verts = [i for i, (a, b) in enumerate(zip(net.mesh.garment_vs, kept["verts"]))
                     if not torch.equal(a, b)]
            if moved or graded or verts:
                raise AssertionError(f"① changed global state: leaves {moved}, gradients "
                                     f"{graded}, vertex buffers {verts}")
            log(f"[{tag}] after ① of step 0: no global leaf, gradient or vertex changed")

    return hook


def train(net, ds, batches, gen, store, steps: int = TRAIN_STEPS, k1_per_step: int = 3,
          tag: str = "10", required=("fl_loss_total", "gnorm_fl")) -> dict:
    """Phase 10 (and 14): ``steps`` training steps from a fresh remesh,
    with the kernels' launch counts reset just before and read just after;
    the point composite's arguments and upstream gradient and the last
    step's mesh z-buffer arguments (``store["mesh_tiles_calls"]``, in
    launch order) are recorded for phases 8b and 12; every step's info
    must hold the ``required`` keys. Returns the launch counts."""
    import numpy as np
    import torch

    from recmv_tpu_torch.ops import rasterizer
    from recmv_tpu_torch.ops.composite import composite_tiles, composite_tiles_bwd
    from recmv_tpu_torch.ops.mesh_raster import mesh_tiles

    before = {k: v.detach().clone() for k, v in net.global_leaves().items()}
    curves0 = [v.detach().clone() for v in net.curve_leaves()]
    net.opt_times, net._remeshed_at = 0.0, -1.0          # a run starts with a remesh
    torch.cuda.reset_peak_memory_stats()
    steady = []
    k1_calls = []
    mesh_tiles.launches = composite_tiles.launches = composite_tiles_bwd.launches = 0
    with rasterizer_kernels(recording(composite_tiles, store, "composite_tiles"),
                            recording_calls(rasterizer.mesh_tiles, k1_calls)):
        for step, fids in enumerate(batches[:steps]):
            bwd0, k1_0 = composite_tiles_bwd.launches, mesh_tiles.launches
            k1_calls.clear()
            loss, info, wall, phase_ms = timed_train_step(
                net, ds, fids, gen, on_phase=fl_isolation_check(net, tag) if step == 0 else None)
            bad = {k: v for k, v in info.items() if not math.isfinite(v)}
            if bad or not set(required) <= set(info):
                raise AssertionError(f"non-finite or missing training outputs: {bad} "
                                     f"{set(required) - set(info)}")
            if composite_tiles_bwd.launches <= bwd0:
                raise AssertionError("the training step did not launch composite_tiles_bwd")
            if mesh_tiles.launches - k1_0 != k1_per_step:
                raise AssertionError(f"mesh_tiles launched {mesh_tiles.launches - k1_0} times in "
                                     f"a step, not {k1_per_step}")
            if not info["gnorm_fl"] > 0.0:
                raise AssertionError("① gave the curves no gradient")
            conv = sum(info[f"{g}_rayConv"] for g in net.statics.garment_names)
            if conv < 1:
                raise AssertionError("no ray converged")
            store.setdefault("ray_conv", []).append(int(conv))
            log(f"[{tag}] {'start-up ' if step == 0 else ''}train step {step} frames "
                f"{list(map(int, fids))} wall {wall:.3f} s phases_ms "
                f"{json.dumps({k: round(v, 3) for k, v in phase_ms.items()})} loss {loss:.6f} "
                f"info {json.dumps({k: round(v, 6) for k, v in info.items()})}")
            if step > 0:
                steady.append((wall, phase_ms))
    torch.cuda.synchronize()
    store["mesh_tiles_calls"] = list(k1_calls)
    launches = {"mesh_tiles": mesh_tiles.launches, "composite_tiles": composite_tiles.launches,
                "composite_tiles_bwd": composite_tiles_bwd.launches}
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    mean = {k: float(np.mean([p[k] for _, p in steady])) for k in steady[0][1]}
    log(f"[{tag}] steady state over steps 1-{len(steady)}: wall mean "
        f"{np.mean([w for w, _ in steady]):.4f} s (min {min(w for w, _ in steady):.4f}, max "
        f"{max(w for w, _ in steady):.4f}) phases_ms mean "
        f"{json.dumps({k: round(v, 3) for k, v in mean.items()})} peak device memory "
        f"{peak:.3f} GiB launches {json.dumps(launches)}")
    if min(launches.values()) < 1:
        raise AssertionError(f"a kernel of the training path never launched: {launches}")
    after = net.global_leaves()
    if not all(bool(torch.isfinite(v).all()) for v in list(after.values()) + net.curve_leaves()):
        raise AssertionError("non-finite parameters after training")
    moved = {k: (after[k].detach() - before[k]).abs().max().item() for k in before}
    curves_moved = [(a.detach() - b).abs().max().item() for a, b in zip(net.curve_leaves(),
                                                                        curves0)]
    must_move = ("garment_sdfs.", "translator.", "render.", "scene.poses", "scene.trans",
                 "scene.conds.deformer", "scene.camera.focal_length",
                 "scene.camera.princeple_points", "scene.camera.world2cam_coord_trans")
    still = [k for k in moved if k.startswith(must_move) and moved[k] == 0.0]
    frozen = {k: moved[k] for k in ("scene.shape", "scene.camera.cam2world_coord_quat")}
    groups = {g: max(v for k, v in moved.items() if k.startswith(g)) for g in must_move}
    log(f"[{tag}] largest change per group {json.dumps({k: float(f'{v:.3e}') for k, v in groups.items()})} "
        f"curves (scale, nx_scale) {[float(f'{v:.3e}') for v in curves_moved]} "
        f"frozen {json.dumps(frozen)}")
    if (any(groups[g] == 0.0 for g in must_move) or any(frozen.values())
            or min(curves_moved) == 0.0):
        raise AssertionError(f"trained leaves or curves unchanged or frozen leaves moved: "
                             f"{[g for g in must_move if groups[g] == 0.0]} {curves_moved} "
                             f"{frozen}")
    if still:
        log(f"[{tag}] leaves with no change (no gradient reached them): {still}")
    return launches


def compare_zbuffers(net, calls, tag: str, seeding: bool = False) -> None:
    """Phase 8b (and 14): K1 against its plain version on the ① body and
    garment z-buffer arguments recorded from a training step (the launches
    before the seeding's, at 1/zbuf_downscale resolution) and, with
    ``seeding``, on the seeding z-buffers' too."""
    zb_w = -(-net.statics.image_size[0] // net.cfg.zbuf_downscale)
    zb_wt = -(-zb_w // net.cfg.raster_tile)
    G = net.statics.garment_size
    names = (["body"] + [f"garment {g}" for g in net.statics.garment_names]
             + [f"seeding {g}" for g in net.statics.garment_names] * seeding)
    if len(calls) != 1 + 2 * G or any(c[3] != zb_wt for c in calls[:1 + G]):
        raise AssertionError(f"unexpected mesh z-buffer launches in a step: "
                             f"{[(c[0].shape, c[3]) for c in calls]}")
    for name, args in zip(names, calls):
        compare_mesh_tiles(f"{tag} {name} z-buffer", args, min_cover=0.002)


def curve_branch_plain(net, ds, fids, dev) -> None:
    """Phase 13: ① of a training batch, forward and backward to the
    curves, with the kernels and with the plain versions: the same
    visibility masks (K1 gives the plain version's bits), the same loss
    within 1e-6 of it, curve gradients within 1e-4 of each leaf's largest
    entry (the gradient scatters' atomics sum in other orders)."""
    import numpy as np
    import torch

    from recmv_tpu_torch.ops.composite import composite_tiles
    from recmv_tpu_torch.ops.mesh_raster import _mesh_tiles_torch, mesh_tiles

    fids_t = torch.as_tensor(np.asarray(fids) + ds.start_idx, device=dev)
    dev_b = net.device_batch(ds.get_batch(fids))
    leaves = net.curve_leaves()
    runs = []
    for mesh in (mesh_tiles, _mesh_tiles_torch):
        masks = []
        with rasterizer_kernels(composite_tiles, mesh), recording_masks(masks):
            loss, info = net.fl_branch_loss(net.params["curves"], fids_t, dev_b["fl_pts"],
                                            dev_b["fl_masks"], RATIO, net.mesh.garment_vs,
                                            net.mesh.garment_fs)
            grads = torch.autograd.grad(loss, leaves)
        runs.append((loss.item(), masks, grads))
    torch.cuda.synchronize()
    (l_k, m_k, g_k), (l_p, m_p, g_p) = runs
    same = len(m_k) == len(m_p) and all(torch.equal(a, b) for a, b in zip(m_k, m_p))
    rel = [((a - b).abs().max() / b.abs().max().clamp(min=1e-30)).item()
           for a, b in zip(g_k, g_p)]
    g_max = min(b.abs().max().item() for b in g_p)
    log(f"[13] ① forward + backward with plain versions: loss {l_k:.8f} vs {l_p:.8f}, masks "
        f"equal {same} (visible {[int(m.sum()) for m in m_k]} of {m_k[0].numel()} per curve), "
        f"curve grads worst relative err {max(rel):.3e} (smallest max {g_max:.3e})")
    if not same or abs(l_k - l_p) > 1e-6 * abs(l_p) or max(rel) > 1e-4 or g_max <= 0.0:
        raise AssertionError("① differs between kernels and plain versions")


def two_garment_run(dev, work: str) -> None:
    """Phase 14: the synthetic-two scene, three training steps with the
    curve-aware term; five mesh z-buffer launches a step; the point
    composite over the two garments' channels. Then each kernel against
    its plain version on the arguments the last step gave it: K1 on all
    five z-buffers, K2 and K3 on the two-channel mask composite."""
    import torch

    ds, sampler, net = build_smoke_net(dev, work, "synthetic-two", frames=TWO_FRAMES,
                                       image=TWO_IMAGE, phase="14")
    batches = list(sampler)
    while len(batches) < 3:
        batches.extend(list(sampler))
    store = {}
    gen = torch.Generator(device=dev).manual_seed(2)
    launches = train(net, ds, batches, gen, store, steps=3,
                     k1_per_step=1 + 2 * net.statics.garment_size, tag="14",
                     required=("fl_loss_total", "gnorm_fl", "curve_aware_loss"))
    C = store["composite_tiles"][3].shape[2]
    log(f"[14] two garments: composite channels {C}, curve_aware_loss "
        f"{net.info['curve_aware_loss']:.6f}, launches {json.dumps(launches)}")
    if C != 2:
        raise AssertionError(f"the two-garment mask composite has {C} channels, not 2")
    compare_zbuffers(net, store["mesh_tiles_calls"], "14", seeding=True)
    fwd = store["composite_tiles"]
    compare_composite_tiles("14", fwd)
    compare_composite_bwd("14", fwd + (store["composite_tiles.grad"].contiguous(),
                                       fwd[3].requires_grad))


def smoke_conf_without_caps(path: str, data_type: str | None = None) -> str:
    """``configs/synthetic/smoke.conf`` without its ``train.caps`` block,
    and with ``train.data_type`` set to ``data_type`` when one is given,
    written to ``path``: the scene-derived production caps apply."""
    from recmv_tpu_torch.config import ConfigFactory, dump_config

    conf = ConfigFactory.parse_file(osp.join(ROOT, "configs", "synthetic", "smoke.conf"))
    del conf["train"]["caps"]
    if data_type:
        conf["train"]["data_type"] = data_type
    with open(path, "w") as f:
        f.write(dump_config(conf))
    return path


def cli_run(dev, work: str, uninit_conv: list) -> str:
    """Phase 15: the training CLI (``recmv_tpu_torch.train.main``) on a
    synthetic-tube scene of ``CLI_FRAMES`` frames at ``IMAGE``², with
    ``smoke.conf`` less its caps (production caps, flagship widths): the
    one-time initialization with ``CLI_INIT_EPOCHS`` IGR epochs and 150
    curve iterations, ``CLI_STEPS`` steps and ``latest.ckpt``; then a
    second run resumed from it for ``CLI_RESUME_STEPS`` steps. The
    kernels' arguments are recorded as in phase 10: K1's before the first
    step (``initialize_fl``'s gate) and in each step, K2's and K3's of the
    last step. Prints the initialization's parts, the fitted curves beside
    the scene's rings, the first remesh, each step's time, K1 launches
    and converged rays (beside phase 10's, from the uninitialized scene),
    then holds K1 against its plain version on the gate's arguments and on
    the last step's three z-buffers, K2 and K3 on its mask composite.
    Raises on a non-finite output, missing curves or checkpoints, a
    garment surface outside its clip box, a reload that differs from the
    saved parameters, a resume at another epoch or step, a step with no
    converged ray, or a kernel of the path that never launched."""
    import numpy as np
    import torch

    from recmv_tpu_torch import bridge
    from recmv_tpu_torch import train as cli
    from recmv_tpu_torch.core.network import GarmentOptimNetwork
    from recmv_tpu_torch.data.synthetic import SCENE_CURVES, boundary_ring, generate_scene
    from recmv_tpu_torch.models.curves import curves_forward
    from recmv_tpu_torch.ops import rasterizer
    from recmv_tpu_torch.ops.composite import composite_tiles, composite_tiles_bwd
    from recmv_tpu_torch.ops.mesh_raster import mesh_tiles
    from recmv_tpu_torch.ops.seg3d import final_grid_spacing
    from recmv_tpu_torch.utils.checkpoint import read_checkpoint

    scene = osp.join(work, "scene")
    t0 = time.time()
    generate_scene(scene, n_frames=CLI_FRAMES, image_size=IMAGE, skinner_res=SKINNER_RES,
                   device=dev)
    log(f"[15] generated synthetic-tube: {CLI_FRAMES} frames at {IMAGE}² in "
        f"{time.time() - t0:.1f} s")
    conf = smoke_conf_without_caps(osp.join(work, "smoke_nocaps.conf"))
    save = osp.join(scene, "result")
    latest = osp.join(save, "latest.ckpt")
    store, k1_calls, gate_calls, steps, first_mesh, loads = {}, [], [], [], [], []
    train_step = GarmentOptimNetwork.train_step
    load_checkpoint = GarmentOptimNetwork.load_checkpoint

    def step(self, *args, **kwargs):
        """``train_step`` timed, with its K1 calls (those before the first
        step are the gate's) and the mesh of the first remesh kept."""
        if not steps:
            gate_calls.extend(k1_calls)
        k1_calls.clear()
        at = self.opt_times

        def on_phase(name):
            if name == "remesh" and self._remeshed_at == at and not first_mesh:
                m = self.mesh
                first_mesh.append((list(m.garment_n), list(m.garment_fn),
                                   [v[:n].detach().clone() for v, n in
                                    zip(m.garment_vs, m.garment_n)],
                                   list(self.garment_extract_bboxes)))

        torch.cuda.synchronize()
        t = time.time()
        loss, info = train_step(self, *args, timer=on_phase, **kwargs)
        torch.cuda.synchronize()
        steps.append(dict(wall=time.time() - t, info=info, at=at, k1=len(k1_calls),
                          remeshed=self._remeshed_at == at))
        return loss, info

    def net_params(n):
        return bridge.export_params(n.params), {k: v.detach().cpu().numpy()
                                                for k, v in n.params["curves"].items()}

    def saved_leaves(params, curves):
        """Every saved leaf but the skinner's, as bytes (bit equality)."""
        nets = sorted(k for k in params if k not in ("curves", "skinner"))
        return [np.ascontiguousarray(x).tobytes() for x in
                _leaves({k: params[k] for k in nets}) + [curves[k] for k in sorted(curves)]]

    common = ["--conf", conf, "--data-root", scene, "--device", str(dev), "--quality",
              CLI_QUALITY]
    mesh_tiles.launches = composite_tiles.launches = composite_tiles_bwd.launches = 0
    with rasterizer_kernels(recording(composite_tiles, store, "composite_tiles"),
                            recording_calls(rasterizer.mesh_tiles, k1_calls)):
        GarmentOptimNetwork.train_step = step
        GarmentOptimNetwork.load_checkpoint = recording_results(load_checkpoint, loads)
        try:
            t0 = time.time()
            net = cli.main(common + ["--init-epochs", str(CLI_INIT_EPOCHS), "--max-steps",
                                     str(CLI_STEPS), "--seed", "0"])
            wall1 = time.time() - t0
            for f in ("initial_sdf.ckpt", "latest.ckpt"):
                if not osp.isfile(osp.join(save, f)):
                    raise AssertionError(f"the CLI wrote no {f}")
            # run 1's save, its final parameters and a reload of the save
            # into run 1's network must agree bit for bit
            saved = read_checkpoint(latest)
            want = saved_leaves(saved["params"], saved["params"]["curves"])
            same = want == saved_leaves(*net_params(net))
            epoch = load_checkpoint(net, latest)
            same_load = want == saved_leaves(*net_params(net))
            t0 = time.time()
            net2 = cli.main(common + ["--resume", latest, "--max-steps", str(CLI_RESUME_STEPS),
                                      "--seed", "1"])
            wall2 = time.time() - t0
        finally:
            GarmentOptimNetwork.train_step = train_step
            GarmentOptimNetwork.load_checkpoint = load_checkpoint
    torch.cuda.synchronize()
    launches = {"mesh_tiles": mesh_tiles.launches, "composite_tiles": composite_tiles.launches,
                "composite_tiles_bwd": composite_tiles_bwd.launches}

    times = net.init_times
    parts = {k: round(v["seconds"], 3) for k, v in times.items()}
    igr = {k: dict(ms_per_epoch=round(1e3 * v["seconds"] / v["epochs"], 3),
                   points=v["points"], last_loss=round(v["loss"], 6))
           for k, v in times.items() if k.startswith("igr")}
    log(f"[15] run 1: {wall1:.1f} s; initialization parts_s {json.dumps(parts)} IGR "
        f"{json.dumps(igr)} Laplacian template verts {times['laplacian']['verts']}")
    if net.curve_statics is None or not all(math.isfinite(t["last_loss"]) for t in igr.values()):
        raise AssertionError("the initialization left no curves or a non-finite IGR loss")
    fit = np.load(osp.join(save, "fl_init", "init_trans_matrix.npz"))
    cs = net.curve_statics
    aligned = curves_forward({"scale": torch.ones_like(cs.init_scale),
                              "nx_scale": torch.zeros_like(cs.init_scale)}, cs).cpu().numpy()
    rings = {n: (y, off) for n, y, off in SCENE_CURVES["synthetic-tube"]}
    for i, n in enumerate(cs.fl_names):
        ring = boundary_ring(rings[n][0], offset=rings[n][1])
        r_gt = float(np.linalg.norm((ring - ring.mean(0))[:, [0, 2]], axis=1).mean())
        al = aligned[i]
        r_fit = float(np.linalg.norm((al - al.mean(0))[:, [0, 2]], axis=1).mean())
        log(f"[15] curve {n}: T {np.round(fit['T'][i], 5).tolist()} s {float(fit['s'][i]):.5f} "
            f"fitted radius {r_fit:.5f} scene ring radius {r_gt:.5f} centre y "
            f"{float(al[:, 1].mean()):.5f} ring y {rings[n][0]:.5f}")
    log(f"[15] extent rescue fired on {net.fl_rescued}")

    gn, gfn, gvs, boxes = first_mesh[0]
    spacing = float(max(final_grid_spacing(net.seg3d_cfg)[0]))
    for gi, v in enumerate(gvs):
        lo, hi = (torch.as_tensor(b, device=v.device) for b in boxes[gi])
        out = ((v < lo - spacing) | (v > hi + spacing)).any(1).sum().item()
        log(f"[15] first remesh, garment {gi}: {gn[gi]} verts {gfn[gi]} faces, extent "
            f"{v.amin(0).tolist()} .. {v.amax(0).tolist()}, clip box "
            f"{np.round(boxes[gi][0], 4).tolist()} .. {np.round(boxes[gi][1], 4).tolist()}, "
            f"verts outside it {out}")
        if gn[gi] < 1 or out:
            raise AssertionError("the initialized garment surface is empty or leaves its box")

    k1_per_step = 1 + 2 * net.statics.garment_size
    convs = []
    for i, s in enumerate(steps):
        run, j = (1, i) if i < CLI_STEPS else (2, i - CLI_STEPS)
        info = s["info"]
        convs.append(int(sum(info[f"{g}_rayConv"] for g in net.statics.garment_names)))
        log(f"[15] run {run} step {j} wall {s['wall']:.3f} s"
            f"{' (remesh)' if s['remeshed'] else ''} mesh_tiles launches {s['k1']} rays "
            f"converged {convs[-1]} of {int(info['tube_rayBudget'])} loss "
            f"{info['m_loss_total']:.6f}")
        bad = {k: v for k, v in info.items() if not math.isfinite(v)}
        if bad or convs[-1] < 1 or s["k1"] != k1_per_step:
            raise AssertionError(f"a CLI step had non-finite outputs {bad}, no converged ray or "
                                 f"{s['k1']} mesh z-buffer launches, not {k1_per_step}")
    log(f"[15] converged rays per step: initialized {convs} vs phase 10 (uninitialized, "
        f"shrunk sphere) {uninit_conv}")
    for n in (net, net2):
        leaves = list(n.global_leaves().values()) + n.curve_leaves()
        if not all(bool(torch.isfinite(p).all()) for p in leaves):
            raise AssertionError("non-finite parameters after the CLI")

    path, resumed_at = loads[-1]
    log(f"[15] run 2 resumed from {osp.basename(path)} at epoch {resumed_at} step "
        f"{steps[CLI_STEPS]['at']} (saved: epoch {saved['epoch']}, opt_times "
        f"{saved['opt_times']}), {wall2:.1f} s; saved equals run 1's final parameters "
        f"{same}; a reload gives them bit for bit {same_load} (epoch {epoch}, opt_times "
        f"{net.opt_times})")
    if (not same or not same_load or not want or epoch != saved["epoch"]
            or resumed_at != saved["epoch"]
            or net.opt_times != saved["opt_times"] or steps[CLI_STEPS]["at"] != saved["opt_times"]
            or len(steps) != CLI_STEPS + CLI_RESUME_STEPS):
        raise AssertionError("the resumed run does not start from the saved state")

    log(f"[15] launches over both runs {json.dumps(launches)}; mesh_tiles in "
        f"initialize_fl {len(gate_calls)}")
    if min(launches.values()) < 1 or not gate_calls:
        raise AssertionError(f"a kernel of the CLI path never launched: {launches} "
                             f"{len(gate_calls)}")
    for i, args in enumerate(gate_calls):
        compare_mesh_tiles(f"15 initialize_fl z-buffer {i}", args, min_cover=0.002)
    compare_zbuffers(net2, k1_calls, "15", seeding=True)
    fwd = store["composite_tiles"]
    compare_composite_tiles("15", fwd)
    compare_composite_bwd("15", fwd + (store["composite_tiles.grad"].contiguous(),
                                       fwd[3].requires_grad))
    return scene


def animation_motion(path: str) -> str:
    """An ``ANIM_POSES``-pose motion for ``infer_animation``: the synthetic
    A-pose turned by a yaw sweep over one revolution, no translation,
    written to ``path`` as the ``.npz`` the CLI reads."""
    import numpy as np

    from recmv_tpu_torch.data.synthetic import apose

    poses = np.stack([apose()] * ANIM_POSES)
    poses[:, 0, 1] = np.linspace(0.0, 2 * np.pi, ANIM_POSES, endpoint=False)
    np.savez(path, pose=poses.reshape(ANIM_POSES, 72),
             trans=np.zeros((ANIM_POSES, 3), np.float32))
    return path


def k1_recorder(calls: list, kept: dict):
    """``mesh_tiles`` that also notes, per call, its frames, tiles, cap
    and tiles at the cap, and keeps the arguments of the first call of
    each kind in ``kept``: the visibility scan (12 frames) and the first
    one-frame z-buffer at the scene's size (the Phong render of the
    registered garment)."""
    from recmv_tpu_torch.ops.mesh_raster import mesh_tiles

    def call(*args):
        prm, _, cnt, Wt, _ = args
        B, T, _, cap = prm.shape
        kind = "scan" if B == 12 else "frame" if B == 1 else f"{B} frames"
        calls.append(dict(kind=kind, tiles=B * T, cap=cap, at_cap=int((cnt >= cap).sum())))
        if kind not in kept:
            kept[kind] = args
        return mesh_tiles(*args)

    return call


def infer_run(dev, scene: str) -> int:
    """Phase 16: inference on phase 15's fitted scene (``result/latest.ckpt``)
    through the CLIs, in process: ``infer.main`` on frames 0 and 1 with
    images and colours at the production NRICP schedules (200 + 100
    epochs), ``--curves-only`` on the same frames, then
    ``infer_animation.main`` on an ``ANIM_POSES``-pose motion, in a
    directory that holds the first run's registration (a cache hit). The
    kernels' launch counts are set to 0 before the first run and read
    after the last. Prints the registration's seconds by stage, its
    vertex and face counts and surviving boundary labels, the one-sided
    mean distance from the registered vertices to the MC vertices, maskE
    per frame, the colour pass's hit and converged pixels and seconds,
    seconds per exported and per animated frame, K1's launches and the
    tiles at the cap, each with the card's name and power limit. Then K1
    against its plain version on the scan (12 views at 512²) and on the
    first 1080² Phong z-buffer, and the whole scan with the kernels and
    with the plain versions: the same visible vertices. Then the scan and
    frame 0's Phong render at cap ``CAP_PROBE``: the vertices and pixels
    the cap of 512 changes (``PERF.md`` §7). Last, ``--quality higher``
    with ``--curves-only`` on frame 0: the 513³ extraction of a fresh body
    and garments into the host path's buffers (2^22 vertices, 2^23
    faces). Raises on a missing export, a non-finite or empty result, a
    registration farther than ``REG_DIST_BOUND`` from the surface on
    average, a ``higher`` garment with no more vertices than the coarse
    one, or a kernel of the path that never launched. Returns K1's
    launches on the inference path."""
    import shutil

    import numpy as np
    import torch

    from recmv_tpu_torch import infer, infer_animation
    from recmv_tpu_torch.core.inference import visible_vertex_mask
    from recmv_tpu_torch.geometry.mesh_utils import largest_component
    from recmv_tpu_torch.ops.composite import composite_tiles, composite_tiles_bwd
    from recmv_tpu_torch.ops.knn import knn
    from recmv_tpu_torch.ops.mesh_raster import _mesh_tiles_torch, mesh_tiles

    card = card_line()
    out = osp.join(scene, "result", "infer")
    anim = osp.join(scene, "result", "animation")
    common = ["--data-root", scene, "--device", str(dev), "--quality", CLI_QUALITY,
              "--frames"] + [str(f) for f in INFER_FRAMES]
    calls, kept = [], {}
    mesh_tiles.launches = composite_tiles.launches = composite_tiles_bwd.launches = 0
    with rasterizer_kernels(composite_tiles, k1_recorder(calls, kept)):
        torch.cuda.synchronize()
        t0 = time.time()
        inf = infer.main(common + ["--out", out])
        torch.cuda.synchronize()
        wall = time.time() - t0
        n_infer = len(calls)
        t0 = time.time()
        infer.main(common + ["--out", out, "--curves-only"])
        wall_fl = time.time() - t0
        os.makedirs(anim, exist_ok=True)
        for g in inf.net.statics.garment_names:
            for f in (f"registry_{g}.obj", f"registry_{g}_labels.npz"):
                shutil.copy(osp.join(out, f), anim)
        t0 = time.time()
        anim_inf = infer_animation.main(["--data-root", scene, "--device", str(dev),
                                         "--quality", CLI_QUALITY, "--out", anim, "--motion",
                                         animation_motion(osp.join(scene, "motion.npz"))])
        torch.cuda.synchronize()
        wall_anim = time.time() - t0
    launches = {"mesh_tiles": mesh_tiles.launches, "composite_tiles": composite_tiles.launches,
                "composite_tiles_bwd": composite_tiles_bwd.launches}

    net = inf.net
    names = list(net.statics.garment_names)
    for gi, g in enumerate(names):
        secs = {k: round(v, 3) for k, v in inf.registration_times[g].items()}
        rv, rf = inf.registered[g]
        with np.load(osp.join(out, f"registry_{g}_labels.npz")) as z:
            labels = {k: len(z[k]) for k in z.files}
        n, nf = net.mesh.garment_n[gi], net.mesh.garment_fn[gi]
        mc_v, mc_f = largest_component(net.mesh.garment_vs[gi][:n].detach().cpu().numpy(),
                                       net.mesh.garment_fs[gi][:nf].cpu().numpy())
        with torch.no_grad():
            d2, _ = knn(torch.as_tensor(rv, device=dev), torch.as_tensor(mc_v, device=dev))
            dist = torch.sqrt(d2).mean().item()
        tmpl = net.garment_templates[gi]
        log(f"[16] registration {g} ({card}): seconds by stage {json.dumps(secs)} total "
            f"{sum(secs.values()):.3f}; template {len(tmpl.verts)} verts {len(tmpl.faces)} "
            f"faces -> registered {len(rv)} verts {len(rf)} faces, boundary labels "
            f"{json.dumps(labels)} (template {sorted(tmpl.boundary_labels)}); MC target "
            f"{len(mc_v)} verts {len(mc_f)} faces; one-sided mean distance registered -> MC "
            f"{dist:.6f}")
        if (not np.isfinite(rv).all() or len(rv) <= len(tmpl.verts) or not labels
                or not dist < REG_DIST_BOUND):
            raise AssertionError(f"the registration of {g} failed: {len(rv)} verts, labels "
                                 f"{labels}, distance {dist}")

    frames = len(INFER_FRAMES)
    stats = inf.stats
    mask_e = np.load(osp.join(out, "maskE.npy"))
    secs = {k: round(v, 3) for k, v in stats["seconds"].items()}
    log(f"[16] export ({card}): {frames} frames in {wall:.1f} s with the registration; "
        f"seconds by family {json.dumps(secs)}, {sum(secs.values()) / frames:.3f} s per "
        f"exported frame; maskE {np.round(mask_e, 5).tolist()}")
    for c in stats["colors"]:
        log(f"[16] colour pass ({card}): frame {c['frame']} {c['garment']}: hit pixels "
            f"{c['hit']} converged {c['converged']} ({c['converged'] / max(c['hit'], 1):.4f})")
    log(f"[16] colour pass seconds {secs['colors']:.3f} ({secs['colors'] / frames:.3f} per "
        f"frame); curves-only run {wall_fl:.1f} s; animation {ANIM_POSES} poses in "
        f"{wall_anim:.1f} s with the network's load ({card})")
    want = {"meshs": 2 * frames * len(names), "smpl_meshs": frames, "render": frames,
            "def1meshs": frames * len(names), "colors": frames * len(names),
            "fl_meshs": frames * len(net.curve_statics.fl_names)}
    got = {k: len(os.listdir(osp.join(out, k))) for k in want}
    n_anim = len([f for f in os.listdir(anim) if f.endswith(".obj") and "registry" not in f])
    log(f"[16] files {json.dumps(got)}; animation meshes {n_anim}; registration cache hit in "
        f"the animation {not anim_inf.registration_times}")
    if (got != want or n_anim != ANIM_POSES * len(names) or anim_inf.registration_times
            or not ((mask_e >= 0) & (mask_e <= 1)).all()
            or min(c["hit"] for c in stats["colors"]) < 1):
        raise AssertionError(f"inference exports missing or wrong: {got} vs {want}, "
                             f"{n_anim} animation meshes, maskE {mask_e}")

    by_kind = {}
    for c in calls:
        k = by_kind.setdefault(c["kind"], dict(launches=0, tiles=0, at_cap=[], cap=c["cap"]))
        k["launches"] += 1
        k["tiles"] += c["tiles"]
        k["at_cap"].append(c["at_cap"])
    log(f"[16] K1 on the inference path ({card}): launches {launches['mesh_tiles']} ({n_infer} "
        f"in the export run, {len(calls) - n_infer} in the curves-only and animation runs); "
        f"by kind {json.dumps(by_kind)}; composite launches "
        f"{launches['composite_tiles']}/{launches['composite_tiles_bwd']}")
    if launches["mesh_tiles"] < 1 or "scan" not in kept or "frame" not in kept:
        raise AssertionError(f"K1 never launched on the inference path: {launches} "
                             f"{sorted(kept)}")

    compare_mesh_tiles("16 visibility scan", kept["scan"], min_cover=0.01)
    compare_mesh_tiles(f"16 Phong z-buffer {IMAGE}", kept["frame"], min_cover=0.005)
    n, nf = net.mesh.garment_n[0], net.mesh.garment_fn[0]
    mc_v, mc_f = largest_component(net.mesh.garment_vs[0][:n].detach().cpu().numpy(),
                                   net.mesh.garment_fs[0][:nf].cpu().numpy())
    vis_k = visible_vertex_mask(mc_v, mc_f, device=dev)
    with rasterizer_kernels(composite_tiles, _mesh_tiles_torch):
        vis_p = visible_vertex_mask(mc_v, mc_f, device=dev)
    log(f"[16] visible_vertex_mask with kernels vs plain versions: {int(vis_k.sum())} vs "
        f"{int(vis_p.sum())} of {len(vis_k)} vertices, same mask "
        f"{bool(np.array_equal(vis_k, vis_p))}")
    if not np.array_equal(vis_k, vis_p):
        raise AssertionError("the visibility scan differs between K1 and its plain version")

    # the cap at inference (PERF.md §7): the scan and frame 0's Phong render
    # again with the cap raised to CAP_PROBE
    from recmv_tpu_torch.core import inference

    raster = inference.rasterize_mesh
    inference.rasterize_mesh = lambda *a, **k: raster(*a, **dict(k, cap=CAP_PROBE))
    try:
        vis_w = visible_vertex_mask(mc_v, mc_f, device=dev)
    finally:
        inference.rasterize_mesh = raster
    rv, rf = inf.registered[names[0]]
    color = inf._garment_color(0)
    cap = net.cfg.raster_cap_mesh
    with torch.no_grad():
        posed = inf._deform(rv, 0, [INFER_FRAMES[0]], {"sdfRatio": 1.0, "deformerRatio": 1.0,
                                                        "renderRatio": 1.0})[0]
        img, hit = inf._phong_u8(net._camera(), posed, rf, color)
        net.cfg.raster_cap_mesh = CAP_PROBE
        try:
            img_w, hit_w = inf._phong_u8(net._camera(), posed, rf, color)
        finally:
            net.cfg.raster_cap_mesh = cap
    log(f"[16] cap {CAP_PROBE} in place of {cap} ({card}): the scan marks "
        f"{int((vis_w != vis_k).sum())} of {len(vis_k)} vertices otherwise ({int(vis_w.sum())} "
        f"vs {int(vis_k.sum())} seen); frame {INFER_FRAMES[0]}'s Phong render of {names[0]} "
        f"changes {int((img_w != img).any(-1).sum())} of {img.shape[0] * img.shape[1]} pixels "
        f"({int((hit_w != hit).sum())} in coverage)")

    t0 = time.time()
    hi = infer.main(["--data-root", scene, "--device", str(dev), "--quality", "higher",
                     "--frames", str(INFER_FRAMES[0]), "--curves-only", "--out",
                     osp.join(scene, "result", "infer_higher")]).net
    torch.cuda.synchronize()
    wall_hi = time.time() - t0
    coarse = list(zip(net.mesh.garment_n, net.mesh.garment_fn))
    fine = list(zip(hi.mesh.garment_n, hi.mesh.garment_fn))
    log(f"[16] --quality higher ({card}): grid {hi.seg3d_cfg.resolutions[-1]}, body "
        f"{hi.mesh.body_n} verts, garments (verts, faces) {fine} against {coarse} at "
        f"{CLI_QUALITY}, buffers {[v.shape[0] for v in hi.mesh.garment_vs]}; {wall_hi:.1f} s "
        f"with the network's load and the curve tubes")
    if (hi.mesh.body_n < 1 or any(h <= c for (h, _), (c, _) in zip(fine, coarse))
            or not all(torch.isfinite(v[:n]).all().item()
                       for v, n in zip(hi.mesh.garment_vs, hi.mesh.garment_n))):
        raise AssertionError(f"the --quality higher extraction failed: body {hi.mesh.body_n}, "
                             f"garments {fine} against {coarse}")
    del hi
    return launches["mesh_tiles"]


def large_pose_run(dev, work: str) -> tuple:
    """Phase 17: the body priors, the debug renders and the large-pose
    stage. A synthetic-tube scene of ``CLI_FRAMES`` frames at ``IMAGE``²
    made a large-pose scene (``make_large_pose_scene``: feature lines on
    frames < ``LP_ANNOTATED`` only, a depth drift after them, a TCMR
    pickle written gzip-compressed without joblib with 2D joints of the
    synthetic body at ``LP_TARGET_BETAS``). Stage 1: ``train.main`` with ``smoke.conf`` less
    its caps and ``data_type = large_pose``, and ``--save-debug`` (the
    A-pose range; the beta pre-fit on the cold skinner cache, the
    initialization, ``CLI_STEPS`` steps, the debug renders after the
    first step's remesh). Stage 2:
    ``train_large_pose.main --start-epoch 0 --max-steps LP_STEPS`` (the
    large-motion range, SDFs frozen, ① off). The kernels' launch counts
    are set to 0 before stage 1 and read after stage 2. Prints the
    pre-fit's seconds, betas and mean reprojection error before and
    after, the debug files and the seconds of each render, each stage-2
    step's time by phase, converged rays and launches; then K1 against
    its plain version on the turntable's arguments (8 views at 256², cap
    256) and on a ``save_debug`` silhouette (the batch's frames at
    1080²), K2 and K3 on the last large-pose step's mask composite.
    Raises unless the error falls, the debug PNGs and turntable exist,
    every stage-2 step launches K1 once (ray seeding) and K2 and K3 once
    each, every SDF leaf of ``large_pose.ckpt`` equals ``latest.ckpt``'s
    to the bit and the translator moved. Returns (the launch counts, K1's
    records on the turntable and the silhouette)."""
    import numpy as np
    import torch

    from recmv_tpu_torch import train as cli
    from recmv_tpu_torch import train_large_pose
    from recmv_tpu_torch.core import beta_optimizer, builder
    from recmv_tpu_torch.core.network import GarmentOptimNetwork
    from recmv_tpu_torch.data.synthetic import generate_scene, make_large_pose_scene
    from recmv_tpu_torch.ops import rasterizer
    from recmv_tpu_torch.ops.composite import composite_tiles, composite_tiles_bwd
    from recmv_tpu_torch.ops.mesh_raster import mesh_tiles
    from recmv_tpu_torch.utils import debug_vis
    from recmv_tpu_torch.utils.checkpoint import read_checkpoint

    card = card_line()
    scene = osp.join(work, "scene")
    t0 = time.time()
    generate_scene(scene, n_frames=CLI_FRAMES, image_size=IMAGE, skinner_res=SKINNER_RES,
                   device=dev)
    target = np.zeros(10, np.float32)
    target[:2] = LP_TARGET_BETAS
    make_large_pose_scene(scene, LP_ANNOTATED, target, device=dev)
    tcmr = osp.join(scene, "synthetic-tube_tcmr_output.pkl")
    with open(tcmr, "rb") as f:
        record = pickle.load(f)
    with gzip.open(tcmr, "wb") as f:  # a compressed dump, as joblib.load reads it
        pickle.dump(record, f)
    log(f"[17] generated the large-pose tube: {CLI_FRAMES} frames at {IMAGE}², feature lines "
        f"on frames 0-{LP_ANNOTATED - 1}, TCMR joints at betas {target[:2].tolist()} "
        f"(gzip-compressed), in {time.time() - t0:.1f} s")
    conf = smoke_conf_without_caps(osp.join(work, "large_pose.conf"), "large_pose")
    save = osp.join(scene, "result")
    fits, renders, k1_calls, steps, store = [], [], [], [], {}
    fit = builder.smpl_beta_optimizer
    save_debug, turntable = debug_vis.save_debug, debug_vis.turntable_curve_mesh
    train_step = GarmentOptimNetwork.train_step

    def timed_fit(model, init_pose, dataset, **kw):
        frames = beta_optimizer.fit_frames(dataset, device=kw.get("device"))
        b0 = torch.as_tensor(np.asarray(dataset.params.shape, np.float32), device=dev)
        e0 = float(beta_optimizer.reprojection_loss(model, b0, torch.zeros(1, 3, device=dev),
                                                    frames))
        torch.cuda.synchronize()
        t = time.time()
        betas, extra = fit(model, init_pose, dataset, **kw)
        torch.cuda.synchronize()
        sec = time.time() - t
        e1 = float(beta_optimizer.reprojection_loss(model, torch.as_tensor(betas, device=dev),
                                                    torch.as_tensor(extra, device=dev), frames))
        fits.append(dict(seconds=sec, betas=betas, extra=extra, before=e0, after=e1,
                         frames=int(frames[0].shape[0])))
        return betas, extra

    def timed(fn, name):
        def call(*args, **kwargs):
            torch.cuda.synchronize()
            n0, t = len(k1_calls), time.time()
            out = fn(*args, **kwargs)
            torch.cuda.synchronize()
            renders.append(dict(name=name, seconds=time.time() - t, k1=k1_calls[n0:]))
            return out
        return call

    def step(self, *args, **kwargs):
        """``train_step`` with a CUDA event after each phase, its K1 calls
        and the launches of K2 and K3."""
        k1_0, c0, b0 = len(k1_calls), composite_tiles.launches, composite_tiles_bwd.launches
        events = [("start", torch.cuda.Event(enable_timing=True))]
        events[0][1].record()

        def mark(name):
            e = torch.cuda.Event(enable_timing=True)
            e.record()
            events.append((name, e))

        torch.cuda.synchronize()
        t = time.time()
        loss, info = train_step(self, *args, timer=mark, **kwargs)
        torch.cuda.synchronize()
        steps.append(dict(stage=2 if self.large_pose else 1, wall=time.time() - t, info=info,
                          k1=len(k1_calls) - k1_0, k2=composite_tiles.launches - c0,
                          k3=composite_tiles_bwd.launches - b0,
                          phases={n: events[i][1].elapsed_time(e)
                                  for i, (n, e) in enumerate(events[1:])}))
        return loss, info

    common = ["--conf", conf, "--data-root", scene, "--device", str(dev), "--quality",
              CLI_QUALITY]
    mesh_tiles.launches = composite_tiles.launches = composite_tiles_bwd.launches = 0
    with rasterizer_kernels(recording(composite_tiles, store, "composite_tiles"),
                            recording_calls(rasterizer.mesh_tiles, k1_calls)):
        builder.smpl_beta_optimizer = timed_fit
        debug_vis.save_debug = timed(save_debug, "save_debug")
        debug_vis.turntable_curve_mesh = timed(turntable, "turntable")
        GarmentOptimNetwork.train_step = step
        try:
            t0 = time.time()
            net1 = cli.main(common + ["--init-epochs", str(CLI_INIT_EPOCHS), "--max-steps",
                                      str(CLI_STEPS), "--seed", "0", "--save-debug"])
            wall1 = time.time() - t0
            launches1 = {"mesh_tiles": mesh_tiles.launches,
                         "composite_tiles": composite_tiles.launches,
                         "composite_tiles_bwd": composite_tiles_bwd.launches}
            t0 = time.time()
            net2 = train_large_pose.main(common + ["--start-epoch", "0", "--max-steps",
                                                   str(LP_STEPS)])
            wall2 = time.time() - t0
        finally:
            builder.smpl_beta_optimizer = fit
            debug_vis.save_debug, debug_vis.turntable_curve_mesh = save_debug, turntable
            GarmentOptimNetwork.train_step = train_step
    torch.cuda.synchronize()
    launches = {"mesh_tiles": mesh_tiles.launches, "composite_tiles": composite_tiles.launches,
                "composite_tiles_bwd": composite_tiles_bwd.launches}

    if len(fits) != 1:
        raise AssertionError(f"the beta pre-fit ran {len(fits)} times, not once")
    f = fits[0]
    log(f"[17] beta pre-fit ({card}): {f['seconds']:.3f} s, 150 Adam steps on {f['frames']} "
        f"frames; betas {np.round(f['betas'][:2], 5).tolist()} (target "
        f"{target[:2].tolist()}), extra translation {np.round(f['extra'][0], 5).tolist()}; "
        f"mean reprojection error (confidence-weighted L1 per coordinate, px) "
        f"{f['before']:.4f} -> {f['after']:.4f}")
    if not f["after"] < f["before"] or not np.isfinite(f["betas"]).all():
        raise AssertionError("the beta pre-fit did not lower the reprojection error")
    cached = np.load(osp.join(save, "initial_skinner_0.npz"))
    if not np.array_equal(cached["extra_trans"].reshape(1, 3), f["extra"].reshape(1, 3)):
        raise AssertionError("the skinner cache does not hold the pre-fit's translation")

    files = sorted(os.listdir(osp.join(save, "debug")))
    pngs = [n for n in files if n.endswith(".png")]
    tables = [n for n in pngs if n.endswith("_turntable.png")]
    for r in renders:
        log(f"[17] {r['name']} ({card}): {r['seconds']:.3f} s, K1 launches {len(r['k1'])} "
            f"({', '.join(f'{c[0].shape[0]} frames, {c[3]} tiles wide, cap {c[0].shape[3]}' for c in r['k1'])})")
    log(f"[17] stage 1 (train.main --save-debug): {wall1:.1f} s; debug files {len(files)}: "
        f"{len(pngs)} PNGs, {len(tables)} turntables; launches {json.dumps(launches1)}")
    by_name = {r["name"]: r for r in renders}
    if (len(tables) < 1 or len(pngs) <= len(tables) or set(by_name) != {"save_debug", "turntable"}
            or len(by_name["turntable"]["k1"]) != 1 or len(by_name["save_debug"]["k1"]) != 1):
        raise AssertionError(f"stage 1 wrote no debug renders, or not through one K1 launch "
                             f"each: {files} {[(r['name'], len(r['k1'])) for r in renders]}")

    stage2 = [s for s in steps if s["stage"] == 2]
    for i, s in enumerate(steps):
        info = s["info"]
        conv = int(sum(info[f"{g}_rayConv"] for g in net2.statics.garment_names))
        log(f"[17] stage {s['stage']} step {i} wall {s['wall']:.3f} s"
            f"{' (remesh)' if info['remeshed'] else ''} phases_ms "
            f"{json.dumps({k: round(v, 3) for k, v in s['phases'].items()})} rays converged "
            f"{conv} of {int(info['tube_rayBudget'])} launches K1 {s['k1']} K2 {s['k2']} K3 "
            f"{s['k3']} loss {info['m_loss_total']:.6f}")
        bad = {k: v for k, v in info.items() if not math.isfinite(v)}
        if bad:
            raise AssertionError(f"a step had non-finite outputs {bad}")
    if (len(stage2) != LP_STEPS or any((s["k1"], s["k2"], s["k3"]) != (1, 1, 1) for s in stage2)
            or any(k.startswith("fl_") for s in stage2 for k in s["info"])):
        raise AssertionError("a large-pose step ran ① or launched K1, K2 or K3 other than once")
    steady = stage2[1:]
    mean = {k: float(np.mean([s["phases"][k] for s in steady])) for k in steady[0]["phases"]}
    log(f"[17] stage 2 (train_large_pose.main, {net2.dataset.frame_num} frames from "
        f"{net2.dataset.start_idx}): {wall2:.1f} s; steps 1-{len(steady)} ({card}) wall mean "
        f"{np.mean([s['wall'] for s in steady]):.4f} s phases_ms mean "
        f"{json.dumps({k: round(v, 3) for k, v in mean.items()})}")

    a, b = (read_checkpoint(osp.join(save, n)) for n in ("latest.ckpt", "large_pose.ckpt"))
    same = all(np.array_equal(x, y) for k in ("sdf", "garment_sdfs")
               for x, y in zip(_leaves(a["params"][k]), _leaves(b["params"][k])))
    moved = max(float(np.abs(x - y).max()) for x, y in
                zip(_leaves(a["params"]["translator"]), _leaves(b["params"]["translator"])))
    log(f"[17] large_pose.ckpt: SDF leaves equal latest.ckpt's bit for bit {same}; translator "
        f"moved by up to {moved:.3e}; launches over both stages {json.dumps(launches)}")
    if not same or not moved > 0.0 or not net2.large_pose:
        raise AssertionError("the large-pose stage moved an SDF leaf or left the translator")
    if min(launches.values()) < 1:
        raise AssertionError(f"a kernel of phase 17 never launched: {launches}")

    kres = {"turntable": compare_mesh_tiles("17 turntable", by_name["turntable"]["k1"][0],
                                            min_cover=0.001),
            "save_debug": compare_mesh_tiles("17 save_debug silhouette",
                                             by_name["save_debug"]["k1"][0], min_cover=0.005)}
    fwd = store["composite_tiles"]
    compare_composite_tiles("17", fwd)
    compare_composite_bwd("17", fwd + (store["composite_tiles.grad"].contiguous(),
                                       fwd[3].requires_grad))
    turntable_cap_probe(net1)
    del net1, net2
    return launches, kres


def bench_run(dev, work: str) -> dict:
    """Phase 18: the port's benches (``bench_fullstep`` at full width,
    ``bench_quality`` at a reduced size, the hot step), with the kernels'
    launch counts set to 0 before them and read after; then K1, K2 and K3
    against their plain versions on the fullstep's last step. Returns the
    launch counts."""
    import numpy as np

    from recmv_tpu_torch import bench
    from recmv_tpu_torch.ops import rasterizer
    from recmv_tpu_torch.ops.composite import composite_tiles, composite_tiles_bwd
    from recmv_tpu_torch.ops.mesh_raster import mesh_tiles
    from recmv_tpu_torch.tools import bench_fullstep, bench_quality

    store, k1_calls = {}, []
    mesh_tiles.launches = composite_tiles.launches = composite_tiles_bwd.launches = 0
    t_phase = t0 = time.time()
    with rasterizer_kernels(recording(composite_tiles, store, "composite_tiles"),
                            recording_calls(rasterizer.mesh_tiles, k1_calls)):
        fs = bench_fullstep.main(["--steps", str(FS_STEPS), "--scene", osp.join(work, "bench"),
                                  "--out", osp.join(work, "bench_fullstep.json")])
    cost = fs["step_cost"]
    log(f"[18] bench_fullstep at {fs['config']['image']}², pyramid {fs['config']['pyramid']}, "
        f"{fs['rays_per_step']} rays, in {time.time() - t0:.1f} s: first step "
        f"{fs['first_step_s']} s, {fs['sec_per_step']} s/step, amortized "
        f"{fs['sec_per_step_amortized']} s/step, remesh first {fs['remesh_first_s']} s warm "
        f"{fs['remesh_warm_s']} s, garment verts {fs['garment_verts']}, phases_ms "
        f"{json.dumps(fs['phase_means_ms'])}, rays converged {fs['rays_converged_last_step']}, "
        f"peak {fs['peak_memory_gib']} GiB; step_gflops {cost['step_gflops']} (GEMMs "
        f"{cost['gemm_gflops']}, kernels {json.dumps(cost['kernel_gflops'])}), "
        f"{cost['achieved_tflops_per_s']} TFLOP/s, mfu_pct_vs_f32_peak "
        f"{cost['mfu_pct_vs_f32_peak']} ({fs['device']})")
    if not all(np.isfinite([fs["sec_per_step"], fs["remesh_warm_s"], cost["step_gflops"]])):
        raise AssertionError("non-finite fullstep results")

    t0 = time.time()
    q = bench_quality.main(QUALITY_ARGS + ["--scene", osp.join(work, "quality"),
                                           "--out", osp.join(work, "bench_quality.json")])
    with open(osp.join(ROOT, "bench_quality.json")) as f:
        missing = set(json.load(f)) - set(q)
    scores = [q["chamfer_l2_sym_mean"], q["pred_to_gt_dist_mean"],
              q["chamfer_l2_sym_vs_closed_mean"], *q["mc_pred_to_gt_trend"].values(),
              *q["mc_fresh_to_gt_trend"].values()]
    log(f"[18] bench_quality {json.dumps(q['config'])} in {time.time() - t0:.1f} s: "
        f"chamfer_l2_sym_mean {q['chamfer_l2_sym_mean']} pred_to_gt_dist_mean "
        f"{q['pred_to_gt_dist_mean']} mc_pred_to_gt_trend {json.dumps(q['mc_pred_to_gt_trend'])}"
        f" mc_fresh_to_gt_trend {json.dumps(q['mc_fresh_to_gt_trend'])}, init "
        f"{q['t_init_s']} s train {q['t_train_s']} s registration {q['t_registration_s']} s")
    if missing or not np.isfinite(scores).all():
        raise AssertionError(f"bench_quality: missing keys {missing} or non-finite scores")

    line = bench.main(["--iters", str(HOT_ITERS), "--bench-dir", work])
    extra = line["extra"]
    log(f"[18] hot step: {extra['rays']} rays, {extra['hot_step_ms']} ms, "
        f"{extra['rays_per_sec_per_chip']} rays/s, {extra['hot_step_gflops']} GFLOP, "
        f"mfu_pct_vs_f32_peak {extra['mfu_pct_vs_f32_peak']}, converged "
        f"{extra['rays_converged']}; summary {line['metric']} = {line['value']} "
        f"{line['unit']}, vs_baseline {line['vs_baseline']}")
    if not np.isfinite([extra["hot_step_ms"], extra["loss"], line["value"]]).all():
        raise AssertionError("non-finite hot step results")
    launches = {"mesh_tiles": mesh_tiles.launches, "composite_tiles": composite_tiles.launches,
                "composite_tiles_bwd": composite_tiles_bwd.launches}
    log(f"[18] launches {json.dumps(launches)}")
    if min(launches.values()) < 1:
        raise AssertionError(f"a kernel of the benches never launched: {launches}")

    # the fullstep's last step (step_cost_analysis'): K1 on its ① body, ①
    # garment and seeding z-buffers, K2 and K3 on its mask composite
    for name, args in zip(("① body", "① garment", "seeding"), k1_calls[-3:]):
        compare_mesh_tiles(f"18 {name} z-buffer", args, min_cover=0.002)
    fwd = store["composite_tiles"]
    compare_composite_tiles("18", fwd)
    compare_composite_bwd("18", fwd + (store["composite_tiles.grad"].contiguous(),
                                       fwd[3].requires_grad))
    log(f"[18] phase 18 ran {time.time() - t_phase:.1f} s")
    return launches


def mc_tolerance(shape, spacing, v) -> float:
    """The vertex tolerance of ``tests/test_torch_marching_cubes.py``: two
    float32 roundings at the grid index's scale (times the spacing) and at
    the largest coordinate's."""
    import numpy as np

    return 2 * (max(spacing) * float(np.spacing(np.float32(max(shape))))
                + float(np.spacing(np.float32(np.abs(v).max()))))


def mc_agree(v, f, vh, fh) -> tuple:
    """The device mesh (v, f) against the host ``marching_cubes_host`` mesh
    (vh, fh) of the same volume, each host vertex mapped to its nearest
    device vertex: (the map is one to one, the mapped host faces equal the
    device faces in order, the largest coordinate difference)."""
    import numpy as np
    from scipy.spatial import cKDTree

    _, to_dev = cKDTree(v).query(vh)
    onto = len(vh) == len(v) and np.array_equal(np.sort(to_dev), np.arange(len(v)))
    return onto, onto and np.array_equal(to_dev[fh], f), float(np.abs(v[to_dev] - vh).max())


def remesh_split_run(dev, bench_work: str, scene: str) -> None:
    """Phase 19 (a) and (b): the remesh's parts by CUDA events. (a) On the
    fine pyramid of phase 18's net (the same scene and initialization):
    for the garment, 3 times, seg3d, the device marching cubes, and the
    path it replaced (the volume to the host and ``marching_cubes_host``);
    the device mesh equals the host mesh up to a vertex permutation and the
    same function run on the volume's CPU copy in order; then two warm
    ``marching_cube_update`` by host clock. (b) On phase 15's scene at the
    ``higher`` pyramid (513³): seg3d and the device marching cubes with
    the peak device memory of each, for the record (``higher`` keeps the
    host path), beside the host path's time."""
    import argparse

    import numpy as np
    import torch

    from recmv_tpu_torch import infer
    from recmv_tpu_torch.native import marching_cubes_host
    from recmv_tpu_torch.ops.marching_cubes import marching_cubes
    from recmv_tpu_torch.ops.seg3d import final_grid_spacing, seg3d_forward
    from recmv_tpu_torch.tools import bench_fullstep, sync

    card = card_line()
    t_phase = time.time()
    _, net, _, _ = bench_fullstep.build_bench_net(
        bench_fullstep.parse_args(["--scene", osp.join(bench_work, "bench")]), dev)
    cfg = net.seg3d_cfg
    spacing, origin = final_grid_spacing(cfg)
    level = -net.sdf_shrink
    caps = dict(max_verts=net.cfg.mc_capacity_v, max_faces=net.cfg.mc_capacity_f)
    query = net._extract_query(net.params["garment_sdfs"][0], 1.0, 0)
    rows = []
    with torch.no_grad():
        for _ in range(3):
            ev = [torch.cuda.Event(enable_timing=True) for _ in range(4)]
            ev[0].record()
            vol = seg3d_forward(query, cfg, device=dev)
            ev[1].record()
            v, f = marching_cubes(vol, level, origin, spacing, **caps)
            ev[2].record()
            vh, fh = marching_cubes_host(vol.cpu().numpy(), level, origin=np.asarray(origin),
                                         spacing=np.asarray(spacing), **caps)
            ev[3].record()
            torch.cuda.synchronize()
            rows.append([ev[i].elapsed_time(ev[i + 1]) for i in range(3)])
        vc, fc = marching_cubes(vol.cpu(), level, origin, spacing, **caps)
    v, f = v.cpu().numpy(), f.cpu().numpy()
    tol = mc_tolerance(vol.shape, spacing, v)
    onto, faces_same, dist = mc_agree(v, f, vh, fh)
    cpu_order = bool(np.array_equal(fc.numpy(), f))
    cpu_err = float(np.abs(vc.numpy() - v).max())
    log(f"[19] fine-pyramid remesh split ({card}): grid {tuple(vol.shape)} "
        f"({vol.numel()} cells), garment {len(v)} verts {len(f)} faces; ms per run "
        f"[seg3d, device marching cubes, volume to host + marching_cubes_host]: "
        f"{json.dumps([[round(x, 3) for x in r] for r in rows])}")
    log(f"[19] device mesh vs host mesh: vertex map one to one {onto}, largest vertex "
        f"difference {dist:.3e} (tolerance {tol:.3e}), faces equal through the map "
        f"{faces_same}; vs the "
        f"CPU run on the volume's copy: faces and order equal {cpu_order}, largest vertex "
        f"difference {cpu_err:.3e}")
    if not (onto and faces_same and dist <= tol and cpu_order and cpu_err <= tol
            and len(v) > 100):
        raise AssertionError("the device marching cubes disagrees with the host path or the CPU")
    del vol, vc, fc
    walls = []
    for _ in range(2):
        t0 = time.time()
        net.marching_cube_update({"sdfRatio": 1.0, "deformerRatio": 0.5, "renderRatio": 1.0})
        sync(dev)
        walls.append(time.time() - t0)
    log(f"[19] warm marching_cube_update at the fine pyramid (seg3d + device marching cubes + "
        f"trim), s: {[round(w, 4) for w in walls]}, garment verts {net.mesh.garment_n} ({card})")
    del net
    torch.cuda.empty_cache()

    hi, _, _ = infer.load_net(argparse.Namespace(
        data_root=scene, save_folder="result", conf=None, ckpt=None, quality="higher",
        device=str(dev)))
    cfg = hi.seg3d_cfg
    spacing, origin = final_grid_spacing(cfg)
    ev = [torch.cuda.Event(enable_timing=True) for _ in range(4)]
    with torch.no_grad():
        torch.cuda.reset_peak_memory_stats(dev)
        base = torch.cuda.memory_allocated(dev)
        ev[0].record()
        vol = seg3d_forward(hi._extract_query(hi.params["garment_sdfs"][0], 1.0, 0), cfg,
                            device=dev)
        ev[1].record()
        torch.cuda.synchronize()
        seg_peak = torch.cuda.max_memory_allocated(dev) - base
        torch.cuda.reset_peak_memory_stats(dev)
        held = torch.cuda.memory_allocated(dev)
        ev[2].record()
        v, f = marching_cubes(vol, -hi.sdf_shrink, origin, spacing, max_verts=1 << 22,
                              max_faces=1 << 23)
        ev[3].record()
        torch.cuda.synchronize()
        mc_peak = torch.cuda.max_memory_allocated(dev) - held
        t0 = time.time()
        vh, fh = marching_cubes_host(vol.cpu().numpy(), -hi.sdf_shrink,
                                     origin=np.asarray(origin), spacing=np.asarray(spacing),
                                     max_verts=1 << 22, max_faces=1 << 23)
        host_s = time.time() - t0
    log(f"[19] higher pyramid {tuple(vol.shape)} ({vol.numel()} cells, garment "
        f"{hi.statics.garment_names[0]}; {card}): seg3d {ev[0].elapsed_time(ev[1]):.3f} ms "
        f"peak {seg_peak / 2 ** 30:.3f} GiB above {base / 2 ** 30:.3f} GiB held; device "
        f"marching cubes {ev[2].elapsed_time(ev[3]):.3f} ms peak {mc_peak / 2 ** 30:.3f} GiB "
        f"above {held / 2 ** 30:.3f} GiB held (the volume "
        f"{vol.numel() * 4 / 2 ** 30:.3f} GiB); volume to host + marching_cubes_host "
        f"{host_s * 1e3:.1f} ms; {len(v)} verts {len(f)} faces (host {len(vh)}, {len(fh)})")
    if len(v) != len(vh) or len(f) != len(fh) or not len(v):
        raise AssertionError("the 513³ device and host marching cubes differ in their counts "
                             "or found no surface")
    log(f"[19] remesh split ran {time.time() - t_phase:.1f} s")


def tools_run(dev, scene: str) -> int:
    """Phase 19 (c): the six ported tools on phase 15's scene and phase 16's
    exports, each timed, with the kernels' launch counts set to 0 before
    and read after: ``generate_normals`` (16 frames at 1080², tile 32,
    cap 1024), ``parsing_mask_to_fl``, ``mask2parsing_mask``,
    ``visualize`` (the exported meshes of frames 0 and 1), ``visualize_curve``
    (the canonical tubes and those of frames 0 and 1) and
    ``comparison_results`` (the exported garments beside the exported
    bodies at 512², cap 256); then K1 against its plain version on the
    first normal map's arguments. Raises on a missing output or when K1
    never launched. Returns K1's launches."""
    import glob

    import numpy as np
    import torch

    from recmv_tpu_torch.ops.composite import composite_tiles, composite_tiles_bwd
    from recmv_tpu_torch.ops.mesh_raster import mesh_tiles
    from recmv_tpu_torch.tools import (comparison_results, generate_normals, mask2parsing_mask,
                                       parsing_mask_to_fl, sync, visualize, visualize_curve)

    card = card_line()
    t_phase = time.time()
    dev_arg = ["--device", str(dev)]
    exports = osp.join(scene, "result", "infer")
    runs = [
        ("generate_normals", lambda: generate_normals.main(["--data-root", scene] + dev_arg)),
        ("parsing_mask_to_fl", lambda: parsing_mask_to_fl.main(["--data-root", scene] + dev_arg)),
        ("mask2parsing_mask", lambda: mask2parsing_mask.main(
            ["--data-root", scene, "--garment-type", "synthetic-tube"])),
        ("visualize", lambda: visualize.main(
            ["--data-root", scene, "--mesh-dir", osp.join(exports, "meshs"), "--out",
             osp.join(scene, "vis")] + dev_arg)),
        ("visualize_curve", lambda: visualize_curve.main(
            ["--data-root", scene, "--frames"] + [str(f) for f in INFER_FRAMES] + dev_arg)),
        ("comparison_results", lambda: comparison_results.main(
            ["--out", osp.join(scene, "cmp"), f"ours={osp.join(exports, 'meshs')}",
             f"body={osp.join(exports, 'smpl_meshs')}"] + dev_arg)),
    ]
    calls, results, secs = [], {}, {}
    mesh_tiles.launches = composite_tiles.launches = composite_tiles_bwd.launches = 0
    with rasterizer_kernels(composite_tiles, recording_calls(mesh_tiles, calls)):
        for name, run in runs:
            n0, t0 = mesh_tiles.launches, time.time()
            results[name] = run()
            sync(dev)
            secs[name] = (round(time.time() - t0, 3), mesh_tiles.launches - n0)
    log(f"[19] tools ({card}): seconds and K1 launches {json.dumps(secs)}")
    normals = sorted(glob.glob(osp.join(scene, "normals", "*.png")))
    fl = results["parsing_mask_to_fl"]
    parsing = results["mask2parsing_mask"]
    tubes = results["visualize_curve"]
    strips = results["comparison_results"]
    with open(osp.join(scene, "cmp", "methods.txt")) as f:
        methods = f.read().split()
    log(f"[19] outputs: {len(normals)} normal maps, {fl} mask2fl annotations, {len(parsing)} "
        f"parsing masks, {results['visualize']} overlays, {len(tubes)} curve tubes, {strips} "
        f"comparison strips of {methods}")
    n_frames = len(np.load(osp.join(scene, "smpl_rec.npz"))["poses"])
    if (len(normals) != n_frames or fl < 1 or len(parsing) != n_frames
            or results["visualize"] != len(INFER_FRAMES) or len(tubes) < 3 or strips < 1
            or methods != ["ours", "body"]):
        raise AssertionError(f"a tool's output is missing: {secs}")
    launches = mesh_tiles.launches
    if launches < 1 or composite_tiles.launches or composite_tiles_bwd.launches:
        raise AssertionError(f"the tools' launches are wrong: K1 {launches}, composite "
                             f"{composite_tiles.launches}/{composite_tiles_bwd.launches}")
    compare_mesh_tiles("19 generate_normals 1080² tile 32 cap 1024", calls[0], min_cover=0.01)
    del calls
    torch.cuda.empty_cache()
    log(f"[19] tools ran {time.time() - t_phase:.1f} s")
    return launches


def host_cpu() -> str:
    """The host CPU's model name (``/proc/cpuinfo``, where it gives one),
    architecture and core count."""
    import platform

    name = "CPU"
    with contextlib.suppress(OSError):
        with open("/proc/cpuinfo") as f:
            name = next((ln.split(":", 1)[1].strip() for ln in f
                         if ln.startswith("model name")), name)
    return f"{name} ({platform.machine()}), {os.cpu_count()} cores"


def fixtures_check() -> None:
    """Phase 20 (a): every committed fixture of ``tests/torch_fixtures``
    read by the port, held against what ``cv2.imread`` and ``joblib.load``
    gave where they were written (``expected.npz``: the arrays, or the
    SHA-256 of the 1080² ones). Raises on any difference."""
    import hashlib

    import numpy as np

    from recmv_tpu_torch.data.image import imread
    from recmv_tpu_torch.utils.pickle_compat import load_joblib

    names = sorted(os.listdir(FIXTURES))
    images = [n for n in names if n.endswith((".jpg", ".png"))]
    dumps = [n for n in names if n.startswith("tcmr_")]
    with np.load(osp.join(FIXTURES, "expected.npz"), allow_pickle=True) as npz:
        want = {k: npz[k] for k in npz.files}
    bad = []
    for n in images:
        got = imread(osp.join(FIXTURES, n))
        if f"img/{n}" in want:
            same = np.array_equal(got, want[f"img/{n}"])
        else:
            same = (tuple(want[f"shape/{n}"]) == got.shape and hashlib.sha256(
                got.tobytes()).digest() == want[f"sha256/{n}"].tobytes())
        if not same:
            bad.append(n)
    for n in dumps:
        got = load_joblib(osp.join(FIXTURES, n))
        same = all(np.array_equal(v, want[f"tcmr/1/{k}"]) and v.dtype == want[f"tcmr/1/{k}"].dtype
                   for k, v in got[1].items())
        same &= all(np.array_equal(got[k], want[f"tcmr/{k}"]) for k in ("f_order", "big_endian"))
        same &= got["objects"].tolist() == want["tcmr/objects"].tolist()
        if not same:
            bad.append(n)
    log(f"[20] fixtures: {len(images)} images and {len(dumps)} joblib dumps read, "
        f"{len(images) + len(dumps) - len(bad)} equal to cv2.imread's and joblib.load's; "
        f"differing: {bad}")
    if bad or len(images) < 40 or len(dumps) != 5:
        raise AssertionError(f"fixtures differ from OpenCV's or joblib's reading: {bad}")


def decode_times(work: str) -> dict:
    """Phase 20 (b): ms per read (host clock, ``DECODE_REPS`` reads after
    one untimed) of the 1080² JPEG fixture, its PIL-written PNG twin (130
    Paeth rows among Up, Sub and unfiltered ones) and the same pixels
    written by ``png.imwrite`` (filter 0)."""
    from recmv_tpu_torch.data import png
    from recmv_tpu_torch.data.image import imread

    plain = osp.join(work, "frame_1080_imwrite.png")
    png.imwrite(plain, imread(osp.join(FIXTURES, "frame_1080.png")))
    out = {}
    for path in (osp.join(FIXTURES, "frame_1080.jpg"), osp.join(FIXTURES, "frame_1080.png"),
                 plain):
        imread(path)
        t0 = time.perf_counter()
        for _ in range(DECODE_REPS):
            imread(path)
        out[osp.basename(path)] = round(1e3 * (time.perf_counter() - t0) / DECODE_REPS, 3)
    log(f"[20] decode ms per frame ({host_cpu()}; {card_line()}): {json.dumps(out)}")
    return out


def scene_inputs_run(dev, scene: str, work: str) -> dict:
    """Phase 20: the scene inputs that OpenCV and joblib read for the JAX
    package. (a) ``fixtures_check``; (b) ``decode_times``; (c) a copy of
    phase 15's scene (frames, masks, normals, parsing, feature lines, SMPL
    and camera files, the skinner cache) with the committed 1080² JPEG,
    frame 0 of the same scene rendered on the CPU and encoded at quality 95,
    4:2:0, in place of ``imgs/0.png``, and a gzip-compressed TCMR dump (a
    plain pickle, written with the standard library) of the synthetic
    body's joints; (d) the copy through ``SceneDataset``: frame 0 from the
    ``.jpg`` path, its mean absolute difference from phase 15's PNG frame,
    the dump's joints in the batch; (e) ``train.main`` on the copy for
    ``INPUT_STEPS`` steps resumed from phase 15's ``latest.ckpt``, the
    kernels' launch counts set to 0 before and read after, each step's
    time and launches. Raises on a mismatch, a frame farther than 2 levels
    from the PNG on average, a step that is not finite or does not launch
    K1 three times and K2 and K3 once each. Returns the launch counts."""
    import glob
    import shutil

    import numpy as np
    import torch

    from recmv_tpu_torch import train as cli
    from recmv_tpu_torch.core.network import GarmentOptimNetwork
    from recmv_tpu_torch.data.dataset import SceneDataset
    from recmv_tpu_torch.data.image import imread
    from recmv_tpu_torch.data.synthetic import tcmr_record
    from recmv_tpu_torch.ops.composite import composite_tiles, composite_tiles_bwd
    from recmv_tpu_torch.ops.mesh_raster import mesh_tiles

    card = card_line()
    t_phase = time.time()
    fixtures_check()
    decode_times(work)

    copy = osp.join(work, "scene")
    os.makedirs(osp.join(copy, "result"))
    for n in os.listdir(scene):
        src = osp.join(scene, n)
        if osp.isfile(src):
            shutil.copy(src, copy)
        elif n in ("imgs", "masks", "normals", "parsing_SCH_ATR", "featurelines"):
            shutil.copytree(src, osp.join(copy, n))
    for src in glob.glob(osp.join(scene, "result", "initial_skinner_*.npz")):
        shutil.copy(src, osp.join(copy, "result"))
    os.remove(osp.join(copy, "imgs", "0.png"))
    shutil.copy(osp.join(FIXTURES, "frame_1080.jpg"), osp.join(copy, "imgs", "0.jpg"))
    tcmr = osp.join(copy, "synthetic-tube_tcmr_output.pkl")
    with gzip.open(tcmr, "wb") as f:
        pickle.dump(tcmr_record(copy, np.zeros(10, np.float32), device=dev), f)

    ds = SceneDataset(copy, garment_type="synthetic-tube")
    batch = ds.get_batch([0])
    jpeg = imread(ds.img_ns[0])
    mad = float(np.abs(jpeg.astype(np.float64) - imread(osp.join(scene, "imgs", "0.png"))).mean())
    log(f"[20] SceneDataset on the copy: frame 0 from {osp.basename(ds.img_ns[0])}, mean "
        f"absolute difference from phase 15's PNG frame {mad:.4f} levels; TCMR joints of "
        f"{len(ds.gt_joints2d or {})} frames from the gzip dump; batch keys {sorted(batch)}")
    if (not ds.img_ns[0].endswith("/imgs/0.jpg") or mad > 2.0 or "gt_joints2d" not in batch
            or not np.array_equal(batch["img"][0], (jpeg.astype(np.float32) / 255.0 - 0.5) * 2.0)):
        raise AssertionError("the JPEG-framed scene did not load as the JAX dataset loads it")

    conf = smoke_conf_without_caps(osp.join(work, "smoke_nocaps.conf"))
    steps = []
    train_step = GarmentOptimNetwork.train_step

    def step(self, *args, **kwargs):
        """``train_step`` timed, with the launches of K1, K2 and K3."""
        n0 = (mesh_tiles.launches, composite_tiles.launches, composite_tiles_bwd.launches)
        torch.cuda.synchronize()
        t = time.time()
        loss, info = train_step(self, *args, **kwargs)
        torch.cuda.synchronize()
        n1 = (mesh_tiles.launches, composite_tiles.launches, composite_tiles_bwd.launches)
        steps.append(dict(wall=time.time() - t, info=info, jpeg=self.dataset.img_ns[0],
                          launches=tuple(b - a for a, b in zip(n0, n1))))
        return loss, info

    mesh_tiles.launches = composite_tiles.launches = composite_tiles_bwd.launches = 0
    GarmentOptimNetwork.train_step = step
    try:
        t0 = time.time()
        net = cli.main(["--conf", conf, "--data-root", copy, "--device", str(dev), "--quality",
                        CLI_QUALITY, "--resume", osp.join(scene, "result", "latest.ckpt"),
                        "--max-steps", str(INPUT_STEPS), "--seed", "2"])
        wall = time.time() - t0
    finally:
        GarmentOptimNetwork.train_step = train_step
    torch.cuda.synchronize()
    launches = {"mesh_tiles": mesh_tiles.launches, "composite_tiles": composite_tiles.launches,
                "composite_tiles_bwd": composite_tiles_bwd.launches}
    for i, s in enumerate(steps):
        info = s["info"]
        conv = int(sum(info[f"{g}_rayConv"] for g in net.statics.garment_names))
        log(f"[20] step {i} ({card}) wall {s['wall']:.3f} s launches K1/K2/K3 {s['launches']} "
            f"rays converged {conv} loss {info['m_loss_total']:.6f}")
        bad = {k: v for k, v in info.items() if not math.isfinite(v)}
        if bad or s["launches"] != (3, 1, 1) or not s["jpeg"].endswith(".jpg"):
            raise AssertionError(f"a step on the JPEG-framed scene had non-finite outputs {bad} "
                                 f"or launches {s['launches']}, not (3, 1, 1)")
    log(f"[20] train.main on the JPEG-framed scene: {len(steps)} steps resumed from phase 15's "
        f"latest.ckpt in {wall:.1f} s; launches {json.dumps(launches)}; phase 20 ran "
        f"{time.time() - t_phase:.1f} s")
    if len(steps) != INPUT_STEPS:
        raise AssertionError(f"train.main ran {len(steps)} steps, not {INPUT_STEPS}")
    del net
    return launches


def turntable_cap_probe(net) -> None:
    """The turntable's 8 views of the garment of ``net`` (its current MC
    mesh) at the turntable's cap of 256 and at ``CAP_PROBE``: the share
    of pixels each covers (the nearest 256 faces of a tile, by quantized
    depth, can leave holes where a tile holds more front faces)."""
    import torch

    from recmv_tpu_torch.ops.rasterizer import rasterize_mesh, screen_with_cam_z
    from recmv_tpu_torch.utils.debug_vis import turntable_cameras

    n, nf = net.mesh.garment_n[0], net.mesh.garment_fn[0]
    v = net.mesh.garment_vs[0][:n].detach()
    f = net.mesh.garment_fs[0][:nf]
    with torch.no_grad():
        scr = torch.stack([screen_with_cam_z(c, v - v.mean(0))
                           for c in turntable_cameras(8, 256, v.device)])
        cover = {cap: (rasterize_mesh(scr, f, (256, 256), tile=32, cap=cap).pix_to_face >= 0
                       ).float().mean().item() for cap in (256, CAP_PROBE)}
    log(f"[17] turntable of the {n}-vertex, {nf}-face garment: pixels covered at cap 256 "
        f"{cover[256]:.4f}, at cap {CAP_PROBE} {cover[CAP_PROBE]:.4f}")


def _leaves(tree) -> list:
    """The numpy leaves of a nested dict/tuple tree, in key order."""
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in _leaves(tree[k])]
    if isinstance(tree, (list, tuple)):
        return [x for v in tree for x in _leaves(v)]
    return [tree]


def branch_backward(net, ds, fids, dev) -> None:
    """Phase 11: the ② mask branch of a training batch, forward and
    backward, with the kernels and with the plain versions: the same loss,
    vertex gradients within 1e-4 of the largest entry (K2/K3 against their
    plain versions, and the gradient scatters' atomics, sum in other
    orders) and translator gradients within 2e-2 of each leaf's largest
    entry: the translator's backward rounds its gradients to bf16 at each
    cast, as the JAX package's does, so a last-bit difference upstream can
    move an entry by a few bf16 steps (2^-8 to 2^-7 of it each; 2.4e-3 to
    4.6e-3 measured; 3.8e-6 when the translator ran in f32)."""
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
    rel = [((a - b).abs().max() / b.abs().max().clamp(min=1e-30)).item()
           for a, b in zip(g_k, g_p)]
    G = len(net.mesh.garment_vs)
    v_max = min(b.abs().max().item() for b in g_p[:G])
    log(f"[11] mask branch forward + backward with plain versions: loss {l_k:.6f} vs {l_p:.6f}, "
        f"vertex grads worst relative err {max(rel[:G]):.3e} (smallest max {v_max:.3e}), "
        f"translator grads worst relative err {max(rel[G:]):.3e}")
    if abs(l_k - l_p) > 1e-5 or max(rel[:G]) > 1e-4 or max(rel[G:]) > 2e-2 or v_max <= 0.0:
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

    t_start = time.time()
    dev = torch.device("cuda:0")
    card = card_line()
    log(f"[0] torch {torch.__version__} cuda {torch.version.cuda} device "
        f"{torch.cuda.get_device_name(0)} ({card})")

    t0 = time.time()
    _build.build_all()
    log(f"[1] built kernels, host marching cubes and image decoder in {time.time() - t0:.1f} s")
    for line in ptxas_summary(_build.kernels_build_log()):
        log(f"[1] ptxas {line}")

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

    # phases 10-13: training with ① (8b: K1 on its recorded ① arguments)
    train_args = {}
    launches = train(net, ds, batches[3:], gen, train_args)
    uninit_conv = train_args["ray_conv"]
    compare_zbuffers(net, train_args["mesh_tiles_calls"], "8b")
    branch_backward(net, ds, batches[-1], dev)
    fwd = train_args["composite_tiles"]
    kres["composite_tiles_bwd"] = compare_composite_bwd(
        "12", fwd + (train_args["composite_tiles.grad"].contiguous(), fwd[3].requires_grad))
    curve_branch_plain(net, ds, batches[-1], dev)
    del net, train_args, fwd
    torch.cuda.empty_cache()

    # phase 14: the two-garment scene
    two_garment_run(dev, tempfile.mkdtemp(prefix="recmv_chip_smoke_two_"))
    torch.cuda.empty_cache()

    # phase 15: the training CLI, initialization included
    scene = cli_run(dev, tempfile.mkdtemp(prefix="recmv_chip_smoke_cli_"), uninit_conv)
    torch.cuda.empty_cache()

    # phase 16: inference on the fitted scene; K1's launches there count
    launches["mesh_tiles"] += infer_run(dev, scene)
    torch.cuda.empty_cache()

    # phase 17: the body priors, the debug renders and the large-pose
    # stage; its launches count
    lp_launches, _ = large_pose_run(dev, tempfile.mkdtemp(prefix="recmv_chip_smoke_lp_"))
    for n, c in lp_launches.items():
        launches[n] += c
    torch.cuda.empty_cache()

    # phase 18: the benches; their launches count
    bench_work = tempfile.mkdtemp(prefix="recmv_chip_smoke_bench_")
    for n, c in bench_run(dev, bench_work).items():
        launches[n] += c
    torch.cuda.empty_cache()

    # phase 19: the remesh's parts, the device marching cubes against the
    # host path, the 513³ volume; the tools, whose K1 launches count
    remesh_split_run(dev, bench_work, scene)
    launches["mesh_tiles"] += tools_run(dev, scene)
    torch.cuda.empty_cache()

    # phase 20: the scene inputs OpenCV and joblib read for the JAX
    # package; its launches count
    for n, c in scene_inputs_run(dev, scene,
                                 tempfile.mkdtemp(prefix="recmv_chip_smoke_inputs_")).items():
        launches[n] += c

    sources = {"mesh_tiles": ("recmv_tpu_torch/csrc/mesh_raster.cu",
                              "recmv_tpu/ops/pallas_raster.py:31"),
               "composite_tiles": ("recmv_tpu_torch/csrc/composite_fwd.cu",
                                   "recmv_tpu/ops/pallas_composite.py:49"),
               "composite_tiles_bwd": ("recmv_tpu_torch/csrc/composite_bwd.cu",
                                       "recmv_tpu/ops/pallas_composite.py:88")}
    kernels = [dict(name=n, route="cuda", source=sources[n][0], replaces=sources[n][1],
                    launches=launches[n], **kres[n]) for n in sources]
    log(f"[end] chip_smoke ran {time.time() - t_start:.1f} s, the build included")
    print(json.dumps({"kernels": kernels}))
    print(card)
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
