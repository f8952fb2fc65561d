"""A/B of two builds of the port's kernels on one CUDA device, on the
arguments the main path gives them: the mesh z-buffer K1 and the
point-composite kernels K2 (forward) and K3 (backward).

    python3 chip_ab.py OTHER_CHECKOUT [OTHER_CHECKOUT ...]

Each OTHER_CHECKOUT is another checkout of this repository (for example an
earlier commit unpacked with ``git archive`` into a directory that
``.gitignore`` lists). Its ``recmv_tpu_torch/csrc/{mesh_raster,
composite_fwd,composite_bwd}.cu`` are built beside this checkout's
kernels; both builds then run, in turns (other, this, this, other), on:

- K1: the seeding z-buffer of a batch on the smoke scene of
  ``chip_smoke.py`` (its phase 8 arguments: 3 frames at 540², cap 512),
  the dense 1080² sphere of its phase 2 (cap 512) and the ① body z-buffer
  of the same batch (``_body_zbuf_image``: 3 frames at 270², cap 512);
- K2 and K3: the ② mask composite of a training batch (``pc_branch_loss``
  forward and backward on the smoke scene: 3 frames at 540², cap 1536,
  one channel, no feature gradient) and the dense 1080² sphere of
  ``chip_smoke.py`` phases 2 and 9 (cap 768, one channel).

It prints, per kernel and input, both builds' mean milliseconds (CUDA
events, 20 launches after warm-up, each turn; and the kernels' own
device time per call from a torch.profiler trace), whether K1's and K2's
two outputs are the same bits (K1 also against the plain version), the
largest difference between the two K3 outputs and each build's error
against the plain PyTorch version; then the card's name and power limit.
It exits non-zero without a card, or when the builds disagree.
"""

from __future__ import annotations

import ctypes
import json
import os.path as osp
import sys
import tempfile

import chip_smoke


def other_kernels(root: str):
    """The other checkout's K1, K2 and K3 as (mesh, fwd, bwd) callables
    with the signatures of ``mesh_tiles`` and of ``composite_tiles``'
    forward and backward. The backward takes a device scratch buffer when
    that build asks for one (``composite_bwd_scratch``)."""
    import torch

    from recmv_tpu_torch import _build

    csrc = osp.join(root, "recmv_tpu_torch", "csrc")
    path = _build._compile("other_kernels", _build._nvcc(), _build.NVCC_FLAGS,
                           [osp.join(csrc, f) for f in _build.KERNEL_SOURCES])
    lib = ctypes.CDLL(path)
    p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    lib.mesh_tiles_launch.restype = i
    lib.mesh_tiles_launch.argtypes = [p, p, p, p, p, p, i, i, i, i, i, p]
    lib.composite_fwd_launch.restype = i
    lib.composite_fwd_launch.argtypes = [p, p, p, p, p, p, f, i, i, i, i, i, i, p]
    scratch = hasattr(lib, "composite_bwd_scratch")
    lib.composite_bwd_launch.restype = i
    lib.composite_bwd_launch.argtypes = ([p] * (10 if scratch else 9) + [f] + [i] * 7 + [p])
    if scratch:
        lib.composite_bwd_scratch.restype = ctypes.c_long
        lib.composite_bwd_scratch.argtypes = [i] * 6

    def mesh(prm, fid, cnt, Wt, tile):
        B, T, _, cap = prm.shape
        zbuf = torch.empty(B, T, tile * tile, device=prm.device)
        face = torch.empty(B, T, tile * tile, dtype=torch.int32, device=prm.device)
        bary = torch.empty(B, T, 3, tile * tile, device=prm.device)
        err = lib.mesh_tiles_launch(prm.data_ptr(), fid.data_ptr(), cnt.data_ptr(),
                                    zbuf.data_ptr(), face.data_ptr(), bary.data_ptr(), B, T, cap,
                                    Wt, tile, torch.cuda.current_stream().cuda_stream)
        if err:
            raise RuntimeError(f"other K1 failed with CUDA error {err}")
        return zbuf, face, bary

    def fwd(cx, cy, val, feat, inv_r2, cnt, Wt, tile):
        B, T, cap = cx.shape
        C = feat.shape[2]
        out = torch.empty(B, T, C, tile * tile, device=cx.device)
        err = lib.composite_fwd_launch(cx.data_ptr(), cy.data_ptr(), val.data_ptr(),
                                       feat.data_ptr(), cnt.data_ptr(), out.data_ptr(),
                                       float(inv_r2), B, T, cap, C, Wt, tile,
                                       torch.cuda.current_stream().cuda_stream)
        if err:
            raise RuntimeError(f"other K2 failed with CUDA error {err}")
        return out

    def bwd(cx, cy, val, feat, inv_r2, cnt, Wt, tile, g, need_dfeat):
        B, T, cap = cx.shape
        C = feat.shape[2]
        dcx, dcy = torch.empty_like(cx), torch.empty_like(cy)
        dfeat = torch.empty_like(feat) if need_dfeat else None
        extra = []
        if scratch:
            n = lib.composite_bwd_scratch(B, T, cap, C, tile, int(need_dfeat)) // 4
            buf = torch.empty(n, device=cx.device)
            extra = [buf.data_ptr()]
        err = lib.composite_bwd_launch(cx.data_ptr(), cy.data_ptr(), val.data_ptr(),
                                       feat.data_ptr(), cnt.data_ptr(), g.data_ptr(),
                                       dcx.data_ptr(), dcy.data_ptr(),
                                       dfeat.data_ptr() if need_dfeat else None, *extra,
                                       float(inv_r2), B, T, cap, C, Wt, tile, int(need_dfeat),
                                       torch.cuda.current_stream().cuda_stream)
        if err:
            raise RuntimeError(f"other K3 failed with CUDA error {err}")
        return dcx, dcy, dfeat

    return mesh, fwd, bwd


def device_ms(fn, key: str, iters: int = 20) -> float:
    """Mean device milliseconds per call of the kernels ``fn`` launches
    whose name holds ``key``, from a torch.profiler trace."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    total = sum(getattr(e, "self_device_time_total", 0.0) for e in prof.key_averages()
                if key in e.key)
    return total / 1e3 / iters


def compare_mesh(tag: str, args, other) -> dict:
    """Both builds of K1 on one input, timed in turns; both against the
    plain version, bit for bit."""
    import torch

    from recmv_tpu_torch.ops.mesh_raster import _mesh_tiles_torch, mesh_tiles

    o_mesh = other[0]
    res = {"input": tag}
    with torch.no_grad():
        a, b, plain = o_mesh(*args), mesh_tiles(*args), _mesh_tiles_torch(*args)
        torch.cuda.synchronize()
        res["k1_same_bits"] = all(torch.equal(x, y) for x, y in zip(a, b))
        res["k1_plain_bits_other"] = all(torch.equal(x, z) for x, z in zip(a, plain))
        res["k1_plain_bits_this"] = all(torch.equal(y, z) for y, z in zip(b, plain))
        turns = [chip_smoke.cuda_ms(lambda: fn(*args), 20)
                 for fn in (o_mesh, mesh_tiles, mesh_tiles, o_mesh)]
        res["k1_ms_other"] = [turns[0], turns[3]]
        res["k1_ms_this"] = [turns[1], turns[2]]
        res["k1_device_ms_other"] = device_ms(lambda: o_mesh(*args), "mesh_tiles")
        res["k1_device_ms_this"] = device_ms(lambda: mesh_tiles(*args), "mesh_tiles")
    chip_smoke.log(f"[ab] {json.dumps(res)}")
    if not (res["k1_same_bits"] and res["k1_plain_bits_this"]):
        raise AssertionError(f"{tag}: the K1 builds disagree")
    return res


def compare(tag: str, fwd_args, g, need_dfeat: bool, other) -> dict:
    """Both builds of K2 and K3 on one input, timed in turns."""
    import torch

    from recmv_tpu_torch.ops.composite import (_composite_fwd, _composite_tiles_bwd_torch,
                                               _composite_tiles_torch, composite_tiles_bwd)

    _, o_fwd, o_bwd = other
    bargs = fwd_args + (g, need_dfeat)
    res = {"input": tag}
    with torch.no_grad():
        a, b, plain = o_fwd(*fwd_args), _composite_fwd(*fwd_args), _composite_tiles_torch(*fwd_args)
        torch.cuda.synchronize()
        res["k2_same_bits"] = bool(torch.equal(a, b))
        res["k2_err_other"] = (a - plain).abs().max().item()
        res["k2_err_this"] = (b - plain).abs().max().item()
        ga, gb = o_bwd(*bargs), composite_tiles_bwd(*bargs)
        gp = _composite_tiles_bwd_torch(*bargs)
        torch.cuda.synchronize()
        trip = [(x, y, z) for x, y, z in zip(ga, gb, gp) if z is not None]
        res["k3_max_plain"] = max(z.abs().max().item() for _, _, z in trip)
        res["k3_diff"] = max((x - y).abs().max().item() for x, y, _ in trip)
        res["k3_err_other"] = max((x - z).abs().max().item() for x, _, z in trip)
        res["k3_err_this"] = max((y - z).abs().max().item() for _, y, z in trip)
        for name, fo, ft, args in (("k2", o_fwd, _composite_fwd, fwd_args),
                                   ("k3", o_bwd, composite_tiles_bwd, bargs)):
            turns = [chip_smoke.cuda_ms(lambda: fn(*args), 20)
                     for fn in (fo, ft, ft, fo)]
            res[f"{name}_ms_other"] = [turns[0], turns[3]]
            res[f"{name}_ms_this"] = [turns[1], turns[2]]
            res[f"{name}_device_ms_other"] = device_ms(lambda: fo(*args), "composite")
            res[f"{name}_device_ms_this"] = device_ms(lambda: ft(*args), "composite")
    chip_smoke.log(f"[ab] {json.dumps(res)}")
    if not res["k2_same_bits"] or res["k3_err_this"] > 1e-5 * res["k3_max_plain"]:
        raise AssertionError(f"{tag}: the builds disagree")
    return res


def main() -> int:
    import torch

    if not torch.cuda.is_available() or len(sys.argv) < 2:
        print("usage: python3 chip_ab.py OTHER_CHECKOUT [...] (on a CUDA device)",
              file=sys.stderr)
        return 2
    import numpy as np

    from recmv_tpu_torch.ops import rasterizer
    from recmv_tpu_torch.ops.composite import composite_tiles
    from recmv_tpu_torch.ops.mesh_raster import mesh_tiles
    from recmv_tpu_torch.ops.rasterizer import composite_tile_inputs, mesh_tile_inputs

    dev = torch.device("cuda:0")
    card = chip_smoke.card_line()
    others = {root: other_kernels(osp.abspath(root)) for root in sys.argv[1:]}

    # the dense sphere of chip_smoke phases 2 and 9
    scr, faces = chip_smoke.sphere_screen_mesh(dev)
    ones = torch.ones(scr.shape[1], 1, device=dev)
    sphere = composite_tile_inputs(scr, 0.006, ones, (chip_smoke.IMAGE,) * 2, tile=32,
                                   cap=768) + (32,)
    sphere_mesh = mesh_tile_inputs(scr, faces, (chip_smoke.IMAGE,) * 2, tile=32, cap=512) + (32,)
    gen = torch.Generator(device=dev).manual_seed(1)
    g_sphere = torch.randn(*sphere[0].shape[:2], 1, 32 * 32, generator=gen, device=dev)

    # the mask composite of a training batch, forward and backward, and
    # the seeding z-buffer of the same batch
    ds, sampler, net = chip_smoke.build_smoke_net(dev, tempfile.mkdtemp(prefix="recmv_ab_"))
    fids = next(iter(sampler))
    store = {}
    fids_t = torch.as_tensor(np.asarray(fids) + ds.start_idx, device=dev)
    dev_b = net.device_batch(ds.get_batch(fids))
    gt = [dev_b[k] for k in net._garment_mask_keys()]
    counts = torch.as_tensor(net.mesh.garment_n, device=dev)
    vs = [v.detach().requires_grad_(True) for v in net.mesh.garment_vs]
    with chip_smoke.rasterizer_kernels(
            chip_smoke.recording(composite_tiles, store, "composite_tiles"),
            chip_smoke.recording(mesh_tiles, store, "mesh_tiles")):
        loss, (_, _, def_vs) = net.pc_branch_loss(vs, fids_t, gt, chip_smoke.RATIO, counts,
                                                  body_mask=dev_b.get("body"))
        torch.autograd.grad(loss, vs)
        with torch.no_grad():
            net.find_and_sample_rays(fids_t, gt, chip_smoke.RATIO, net.mesh.garment_vs,
                                     net.mesh.garment_fs, def_vs=[d.detach() for d in def_vs],
                                     generator=gen)
    mask = tuple(a.detach() if torch.is_tensor(a) else a for a in store["composite_tiles"])
    g_mask = store["composite_tiles.grad"].contiguous()
    seed_mesh = store["mesh_tiles"]
    with chip_smoke.rasterizer_kernels(composite_tiles,
                                       chip_smoke.recording(mesh_tiles, store, "mesh_tiles")):
        net._body_zbuf_image(fids_t, net._camera())
    body = store["mesh_tiles"]

    for root, other in others.items():
        compare_mesh(f"{root}: seeding z-buffer of a batch, 540², cap 512", seed_mesh, other)
        compare_mesh(f"{root}: sphere 1080², cap 512", sphere_mesh, other)
        compare_mesh(f"{root}: body z-buffer, 270², cap 512", body, other)
        compare(f"{root}: sphere 1080², cap 768", sphere, g_sphere, False, other)
        compare(f"{root}: mask composite of a training batch, 540², cap 1536", mask, g_mask,
                False, other)
    print(card)
    return 0


if __name__ == "__main__":
    sys.exit(main())
