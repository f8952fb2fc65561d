"""Kernel K1, the per-tile mesh z-buffer (counterpart of
``recmv_tpu/ops/pallas_raster.py::mesh_tiles``).

``mesh_tiles`` launches the CUDA kernel ``csrc/mesh_raster.cu`` on CUDA
tensors and takes the plain PyTorch version ``_mesh_tiles_torch`` on CPU
tensors; it counts its kernel launches in ``mesh_tiles.launches``.
"""

from __future__ import annotations

import torch

from .. import _build

BIG = 3.0e38
_CHUNK_ELEMS = 1 << 24   # bound on (frames × tiles × cap × pixels) per step of the plain version


def tile_pixels(T: int, Wt: int, tile: int, device=None):
    """Pixel-centre coordinates (px, py), each (T, tile²): tile t covers
    rows (t // Wt)·tile + p // tile and columns (t % Wt)·tile + p % tile."""
    t = torch.arange(T, device=device)[:, None]
    p = torch.arange(tile * tile, device=device)[None]
    px = ((t % Wt) * tile + p % tile).to(torch.float32)
    py = ((t // Wt) * tile + p // tile).to(torch.float32)
    return px, py


def _check(prm, fid, cnt, tile):
    B, T, twelve, cap = prm.shape
    if twelve != 12 or fid.shape != (B, T, cap) or cnt.shape != (B, T):
        raise ValueError(f"mesh_tiles shapes: prm {tuple(prm.shape)}, fid "
                         f"{tuple(fid.shape)}, cnt {tuple(cnt.shape)}")
    if prm.dtype != torch.float32 or fid.dtype != torch.int32 or cnt.dtype != torch.int32:
        raise TypeError("mesh_tiles takes prm float32, fid and cnt int32")
    if tile not in (8, 16, 32):
        raise ValueError(f"tile must be 8, 16 or 32, got {tile}")
    if not (prm.device == fid.device == cnt.device):
        raise ValueError("mesh_tiles inputs must share one device")


def _mesh_tiles_torch(prm, fid, cnt, Wt: int, tile: int):
    """Plain version of K1: for every (pixel, candidate) pair at once, the
    strict-first argmin over z (``torch.min`` returns the first minimum,
    which is the running strict '<' of the kernel). Tiles are processed in
    chunks to bound memory."""
    B, T, _, cap = prm.shape
    npix = tile * tile
    px_all, py_all = tile_pixels(T, Wt, tile, prm.device)
    zbuf = torch.empty(B, T, npix, dtype=torch.float32, device=prm.device)
    face = torch.empty(B, T, npix, dtype=torch.int32, device=prm.device)
    bary = torch.empty(B, T, 3, npix, dtype=torch.float32, device=prm.device)
    k = torch.arange(cap, device=prm.device)
    step = max(1, _CHUNK_ELEMS // max(B * cap * npix, 1))
    for t0 in range(0, T, step):
        t1 = min(T, t0 + step)
        P = prm[:, t0:t1, :, :, None]                        # (B, Tc, 12, cap, 1)
        px = px_all[None, t0:t1, None, :]                    # (1, Tc, 1, npix)
        py = py_all[None, t0:t1, None, :]
        w = [P[:, :, 3 * i] * py + P[:, :, 3 * i + 1] * px + P[:, :, 3 * i + 2]
             for i in range(3)]
        inside = (w[0] > 0.0) & (w[1] > 0.0) & (w[2] > 0.0)
        inside &= (k[None, None, :] < cnt[:, t0:t1, None])[..., None]
        iz = [w[i] * P[:, :, 9 + i] for i in range(3)]
        zp = 1.0 / torch.clamp(iz[0] + iz[1] + iz[2], min=1e-12)
        zsel = torch.where(inside, zp, torch.full_like(zp, BIG))
        zbest, kbest = torch.min(zsel, dim=2)                # (B, Tc, npix)
        got = zbest < BIG
        take = kbest[:, :, None, :]
        zbuf[:, t0:t1] = torch.where(got, zbest, -1.0)
        fsel = torch.gather(fid[:, t0:t1, :, None].expand(-1, -1, -1, npix), 2, take)[:, :, 0]
        face[:, t0:t1] = torch.where(got, fsel, -1)
        for i in range(3):
            bi = torch.gather(iz[i] * zp, 2, take)[:, :, 0]
            bary[:, t0:t1, i] = torch.where(got, bi, -1.0)
    return zbuf, face, bary


def mesh_tiles(prm, fid, cnt, Wt: int, tile: int):
    """prm (B, T, 12, cap) f32 premultiplied face coefficients, fid
    (B, T, cap) i32 face ids, cnt (B, T) i32 per-tile candidate counts →
    zbuf (B, T, tile²) f32, face (B, T, tile²) i32, bary (B, T, 3, tile²)
    f32; empty pixels hold −1."""
    _check(prm, fid, cnt, tile)
    if prm.device.type == "cpu":
        return _mesh_tiles_torch(prm, fid, cnt, Wt, tile)
    if prm.device.type != "cuda":
        raise ValueError(f"mesh_tiles runs on cpu or cuda, not {prm.device}")
    prm, fid, cnt = prm.contiguous(), fid.contiguous(), cnt.contiguous()
    B, T, _, cap = prm.shape
    npix = tile * tile
    zbuf = torch.empty(B, T, npix, dtype=torch.float32, device=prm.device)
    face = torch.empty(B, T, npix, dtype=torch.int32, device=prm.device)
    bary = torch.empty(B, T, 3, npix, dtype=torch.float32, device=prm.device)
    if B * T == 0:
        return zbuf, face, bary
    with torch.cuda.device(prm.device):
        err = _build.kernels().mesh_tiles_launch(
            prm.data_ptr(), fid.data_ptr(), cnt.data_ptr(), zbuf.data_ptr(),
            face.data_ptr(), bary.data_ptr(), B, T, cap, Wt, tile,
            torch.cuda.current_stream().cuda_stream)
    if err != 0:
        raise RuntimeError(f"mesh_tiles kernel launch failed with CUDA error {err}")
    mesh_tiles.launches += 1
    return zbuf, face, bary


mesh_tiles.launches = 0
