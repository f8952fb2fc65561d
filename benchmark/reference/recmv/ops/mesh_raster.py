"""Kernel K1, the per-tile mesh z-buffer (counterpart of
``recmv_tpu/ops/pallas_raster.py::mesh_tiles``).

``mesh_tiles`` launches the CUDA kernel ``csrc/mesh_raster.cu`` on CUDA
tensors and takes the plain PyTorch version ``_mesh_tiles_torch`` on CPU
tensors; it counts its kernel launches in ``mesh_tiles.launches``.

The kernel walks, per warp of an 8×4 pixel sub-tile, only the candidates
an exact cull keeps (``csrc/mesh_raster.cu``); ``subtile_keep_faces`` is
the cull's plain model, which the tests hold to it. ``_mesh_tiles_torch``
stays the dense walk of every (pixel, candidate) pair.
"""

from __future__ import annotations

import torch


BIG = 3.0e38
SUB_W, SUB_H = 8, 4         # a warp's sub-tile of pixels in K1, K2 and K3
MAX_CAP = 65535             # the largest cap K1 takes
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
    if prm.device.type == "cuda" and cap > MAX_CAP:
        raise ValueError(f"the mesh kernel takes caps up to {MAX_CAP}, got {cap}")
    if not (prm.device == fid.device == cnt.device):
        raise ValueError("mesh_tiles inputs must share one device")


def subtile_keep_faces(prm, Wt: int, tile: int):
    """Plain model of K1's cull (``may_cover`` in ``csrc/mesh_raster.cu``),
    for the tests. Warp w of a tile owns the 8×4 pixel sub-tile at
    ((w mod tile/8)·8, ⌊w / (tile/8)⌋·4) and keeps a candidate unless, for
    some edge, the edge value at the box corner its signs pick (x0 + 7 when
    b ≥ 0 else x0, y0 + 3 when a ≥ 0 else y0) is ≤ 0, in the kernel's
    float32 operations and order. prm (B, T, 12, cap) → (B, T, tile²/32,
    cap) bool, True where warp w lists the candidate."""
    T = prm.shape[1]
    per_row = tile // SUB_W
    w = torch.arange(tile * tile // 32, device=prm.device)
    t = torch.arange(T, device=prm.device)[:, None]
    x0 = ((t % Wt) * tile + (w % per_row) * SUB_W).to(torch.float32)[None, :, :, None]
    y0 = ((t // Wt) * tile + (w // per_row) * SUB_H).to(torch.float32)[None, :, :, None]
    x1, y1 = x0 + (SUB_W - 1), y0 + (SUB_H - 1)
    keep = None
    for e in range(3):
        a, b, c = (prm[:, :, 3 * e + i, None, :] for i in range(3))     # (B, T, 1, cap)
        w_c = a * torch.where(a >= 0.0, y1, y0) + b * torch.where(b >= 0.0, x1, x0) + c
        keep = ~(w_c <= 0.0) if keep is None else keep & ~(w_c <= 0.0)
    return keep


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
    mesh_tiles.launches += 1
    return _mesh_tiles_torch(prm, fid, cnt, Wt, tile)


mesh_tiles.launches = 0
