"""Smoke run of the PyTorch port (``recmv_tpu_torch``) on one CUDA device.

    python3 chip_smoke.py

Phases, one printed line each (or more):
1. build the CUDA kernels (nvcc, sm_90a) and the host marching cubes (g++)
   from the sources in the checkout;
2. each kernel against its plain PyTorch version on the card, at the
   main path's shapes (1080², tile 32, cap 512 for the mesh z-buffer,
   cap 768 and one channel for the point composite), with both times;
3. generate a synthetic-tube scene on the card: 6 frames at 1080²,
   skinning field (129, 225, 65);
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
   seeding z-buffer, cap 1536 for the mask composite), with both times.

Then a JSON line with each kernel's record (launches from phase 6, error
and times from phase 8), the card's name and power limit, and last
``{"ok": true, "device": {...}}``. Any failure raises and the exit code
is not 0. Without CUDA it exits with 2 before any work.
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
FRAMES = 6
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
    """``fn`` that also keeps its last arguments in ``store[name]``."""

    def call(*args):
        store[name] = args
        return fn(*args)

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
    ds, sampler, net = build_smoke_net(dev, tempfile.mkdtemp(prefix="recmv_chip_smoke_"))

    batches = []
    while len(batches) < 3:
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

    sources = {"mesh_tiles": ("recmv_tpu_torch/csrc/mesh_raster.cu",
                              "recmv_tpu/ops/pallas_raster.py:31"),
               "composite_tiles": ("recmv_tpu_torch/csrc/composite_fwd.cu",
                                   "recmv_tpu/ops/pallas_composite.py:49")}
    kernels = [dict(name=n, route="cuda", source=sources[n][0], replaces=sources[n][1],
                    launches=launches[n], **kres[n]) for n in ("mesh_tiles", "composite_tiles")]
    print(json.dumps({"kernels": kernels}))
    print(card)
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
