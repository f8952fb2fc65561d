"""Kernel K2, the per-tile point alpha compositing forward (counterpart of
``recmv_tpu/ops/pallas_composite.py::composite_tiles``, forward).

``composite_tiles`` launches the CUDA kernel ``csrc/composite_fwd.cu`` on
CUDA tensors and takes the plain PyTorch version
``_composite_tiles_torch`` on CPU tensors; it counts its kernel launches
in ``composite_tiles.launches``. It has no backward yet: the mask
branch's gradient (the TPU ``_bwd_kernel``) arrives with training.
"""

from __future__ import annotations

import torch

from .. import _build
from .mesh_raster import tile_pixels

EPS = 1e-10
MAX_C = 8
_CHUNK_ELEMS = 1 << 24


def _check(cx, cy, val, feat, cnt, tile):
    B, T, cap = cx.shape
    C = feat.shape[2] if feat.ndim == 4 else -1
    if (cy.shape != cx.shape or val.shape != cx.shape or feat.ndim != 4
            or feat.shape != (B, T, C, cap) or cnt.shape != (B, T)):
        raise ValueError(f"composite_tiles shapes: cx {tuple(cx.shape)}, feat "
                         f"{tuple(feat.shape)}, cnt {tuple(cnt.shape)}")
    if any(a.dtype != torch.float32 for a in (cx, cy, val, feat)) or cnt.dtype != torch.int32:
        raise TypeError("composite_tiles takes float32 candidates and int32 counts")
    if not 1 <= C <= MAX_C:
        raise ValueError(f"composite_tiles takes 1..{MAX_C} channels, got {C}")
    if tile not in (8, 16, 32):
        raise ValueError(f"tile must be 8, 16 or 32, got {tile}")
    if len({a.device for a in (cx, cy, val, feat, cnt)}) != 1:
        raise ValueError("composite_tiles inputs must share one device")


def _composite_tiles_torch(cx, cy, val, feat, inv_r2: float, cnt, Wt: int, tile: int):
    """Plain version of K2, vectorized over pixels and candidates: weights
    for every (pixel, candidate) pair, the exclusive cumulative product of
    (1 − w + ε) for the transmittance, and one contraction over
    candidates. Tiles are processed in chunks to bound memory."""
    B, T, cap = cx.shape
    C = feat.shape[2]
    npix = tile * tile
    px_all, py_all = tile_pixels(T, Wt, tile, cx.device)
    inv = torch.tensor(inv_r2, dtype=torch.float32, device=cx.device)
    out = torch.empty(B, T, C, npix, dtype=torch.float32, device=cx.device)
    k = torch.arange(cap, device=cx.device)
    step = max(1, _CHUNK_ELEMS // max(B * cap * npix, 1))
    for t0 in range(0, T, step):
        t1 = min(T, t0 + step)
        px = px_all[None, t0:t1, None, :]                     # (1, Tc, 1, npix)
        py = py_all[None, t0:t1, None, :]
        d2 = (px - cx[:, t0:t1, :, None]) ** 2 + (py - cy[:, t0:t1, :, None]) ** 2
        live = (k[None, None, :] < cnt[:, t0:t1, None]).to(torch.float32)
        w = torch.clamp(1.0 - d2 * inv, 0.0, 1.0) * (val[:, t0:t1] * live)[..., None]
        trans = torch.cumprod(1.0 - w + EPS, dim=2)
        trans = torch.cat([torch.ones_like(trans[:, :, :1]), trans[:, :, :-1]], dim=2)
        out[:, t0:t1] = torch.einsum("btkp,btck->btcp", w * trans, feat[:, t0:t1])
    return out


def composite_tiles(cx, cy, val, feat, inv_r2: float, cnt, Wt: int, tile: int):
    """cx, cy, val (B, T, cap) f32 z-sorted candidates in pixel units (val
    = 1 for live candidates, 0 for padding), feat (B, T, C, cap) f32,
    inv_r2 = 1/r² in pixel units, cnt (B, T) i32 → (B, T, C, tile²) f32."""
    _check(cx, cy, val, feat, cnt, tile)
    if cx.device.type == "cpu":
        return _composite_tiles_torch(cx, cy, val, feat, inv_r2, cnt, Wt, tile)
    if cx.device.type != "cuda":
        raise ValueError(f"composite_tiles runs on cpu or cuda, not {cx.device}")
    cx, cy, val, feat, cnt = (a.contiguous() for a in (cx, cy, val, feat, cnt))
    B, T, cap = cx.shape
    C = feat.shape[2]
    out = torch.empty(B, T, C, tile * tile, dtype=torch.float32, device=cx.device)
    if B * T == 0:
        return out
    with torch.cuda.device(cx.device):
        err = _build.kernels().composite_fwd_launch(
            cx.data_ptr(), cy.data_ptr(), val.data_ptr(), feat.data_ptr(), cnt.data_ptr(),
            out.data_ptr(), float(inv_r2), B, T, cap, C, Wt, tile,
            torch.cuda.current_stream().cuda_stream)
    if err != 0:
        raise RuntimeError(f"composite_tiles kernel launch failed with CUDA error {err}")
    composite_tiles.launches += 1
    return out


composite_tiles.launches = 0
