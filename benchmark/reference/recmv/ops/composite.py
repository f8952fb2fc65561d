"""Kernels K2 and K3, the per-tile point alpha compositing and its
backward (counterpart of ``recmv_tpu/ops/pallas_composite.py``:
``composite_tiles``, a ``jax.custom_vjp`` over ``_fwd_kernel`` and
``_bwd_kernel``).

``composite_tiles`` is a ``torch.autograd.Function``: its forward launches
``csrc/composite_fwd.cu`` on CUDA tensors and takes the plain PyTorch
version ``_composite_tiles_torch`` on CPU tensors; its backward,
``composite_tiles_bwd``, launches ``csrc/composite_bwd.cu`` on CUDA
tensors and takes ``_composite_tiles_bwd_torch`` on CPU tensors. Each
wrapper counts its kernel launches (``composite_tiles.launches``,
``composite_tiles_bwd.launches``). Gradients flow to the candidate
coordinates cx, cy and, only when autograd asks for it, to the features;
val, cnt and inv_r2 are gates and get none. ``composite_tiles_plain`` is
the same function built from the two plain versions on any device.

Both kernels walk, per warp of an 8×4 pixel sub-tile, only the
candidates a conservative cull keeps (``csrc/composite_fwd.cu``);
``subtile_keep`` is the cull's plain model, which the tests hold to it.
"""

from __future__ import annotations

import torch
from torch.autograd.function import once_differentiable

from .mesh_raster import SUB_H, SUB_W, tile_pixels

EPS = 1e-10
MAX_C = 8
CULL_LIMIT = 1.0 + 1.0 / 1024.0     # the kernels' cull threshold on d²_min / r²
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
    if cx.device.type == "cuda" and cap >= 1 << 16:
        raise ValueError(f"the composite kernels take caps below 65536, got {cap}")
    if len({a.device for a in (cx, cy, val, feat, cnt)}) != 1:
        raise ValueError("composite_tiles inputs must share one device")


def _chunks(B, T, cap, npix):
    step = max(1, _CHUNK_ELEMS // max(B * cap * npix, 1))
    return [(t0, min(T, t0 + step)) for t0 in range(0, T, step)]


def _weights(cx, cy, val, inv_r2, cnt, px, py, t0, t1):
    """Per (frame, tile, candidate, pixel) of tiles t0:t1: (raw = 1 − d²/r²,
    w, the live mask as val·[k < cnt], px − cx, py − cy)."""
    cap = cx.shape[2]
    k = torch.arange(cap, device=cx.device)
    dx = px[None, t0:t1, None, :] - cx[:, t0:t1, :, None]
    dy = py[None, t0:t1, None, :] - cy[:, t0:t1, :, None]
    raw = 1.0 - (dx * dx + dy * dy) * inv_r2
    va = val[:, t0:t1] * (k[None, None, :] < cnt[:, t0:t1, None]).to(torch.float32)
    w = torch.clamp(raw, 0.0, 1.0) * va[..., None]
    return raw, w, va, dx, dy


def _transmittance(w):
    """Exclusive cumulative product of (1 − w + ε) over candidates (dim 2)."""
    trans = torch.cumprod(1.0 - w + EPS, dim=2)
    return torch.cat([torch.ones_like(trans[:, :, :1]), trans[:, :, :-1]], dim=2)


def subtile_keep(cx, cy, inv_r2: float, Wt: int, tile: int):
    """Plain model of the cull in K2 and K3 (``may_touch`` in
    ``csrc/composite_fwd.cu``), for the tests. Warp w of a tile owns the
    8×4 pixel sub-tile at ((w mod tile/8)·8, ⌊w / (tile/8)⌋·4) and keeps a
    candidate unless (ex² + ey²)·inv_r2 ≥ ``CULL_LIMIT``, with e the distance
    from the centre to the sub-tile's pixel box along each axis, in the
    kernels' float32 operations. cx, cy (B, T, cap) → (B, T, tile²/32, cap)
    bool, True where warp w lists the candidate."""
    T = cx.shape[1]
    per_row = tile // SUB_W
    w = torch.arange(tile * tile // 32, device=cx.device)
    t = torch.arange(T, device=cx.device)[:, None]
    bx0 = ((t % Wt) * tile + (w % per_row) * SUB_W).to(torch.float32)[None, :, :, None]
    by0 = ((t // Wt) * tile + (w // per_row) * SUB_H).to(torch.float32)[None, :, :, None]
    x, y = cx[:, :, None, :], cy[:, :, None, :]
    zero = torch.zeros((), dtype=torch.float32, device=cx.device)
    ex = torch.fmax(torch.fmax(bx0 - x, x - (bx0 + (SUB_W - 1))), zero)
    ey = torch.fmax(torch.fmax(by0 - y, y - (by0 + (SUB_H - 1))), zero)
    inv = torch.tensor(inv_r2, dtype=torch.float32, device=cx.device)
    return ~((ex * ex + ey * ey) * inv >= CULL_LIMIT)


def _composite_tiles_torch(cx, cy, val, feat, inv_r2: float, cnt, Wt: int, tile: int):
    """Plain version of K2, vectorized over pixels and candidates: weights
    for every (pixel, candidate) pair, the exclusive cumulative product of
    (1 − w + ε) for the transmittance, and one contraction over
    candidates. Tiles are processed in chunks to bound memory."""
    B, T, cap = cx.shape
    C = feat.shape[2]
    npix = tile * tile
    px, py = tile_pixels(T, Wt, tile, cx.device)
    out = torch.empty(B, T, C, npix, dtype=torch.float32, device=cx.device)
    for t0, t1 in _chunks(B, T, cap, npix):
        _, w, _, _, _ = _weights(cx, cy, val, inv_r2, cnt, px, py, t0, t1)
        out[:, t0:t1] = torch.einsum("btkp,btck->btcp", w * _transmittance(w), feat[:, t0:t1])
    return out


def _composite_tiles_bwd_torch(cx, cy, val, feat, inv_r2: float, cnt, Wt: int, tile: int,
                               g, need_dfeat: bool = True):
    """Plain version of K3 (the TPU ``_bwd_kernel``): with A_k = Σ_c g_c f_kc
    per pixel, Σ_c g_c S_c = Σ_{m>k} w_m T_m A_m is a reversed exclusive
    cumulative sum, and ∂L/∂w_k = T_k A_k − Σ_c g_c S_c / (1 − w_k + ε).
    Then dcx_k = Σ_p ∂L/∂w_k (−1/r²)·active·(−2)(px − cx_k) with active =
    0 < 1 − d²/r² < 1 (strict) times val, dcy_k alike, and dfeat_kc =
    Σ_p g_c w_k T_k. Tiles are processed in chunks to bound memory.
    Returns (dcx, dcy, dfeat or None)."""
    B, T, cap = cx.shape
    C = feat.shape[2]
    npix = tile * tile
    px, py = tile_pixels(T, Wt, tile, cx.device)
    dcx = torch.empty_like(cx)
    dcy = torch.empty_like(cy)
    dfeat = torch.empty_like(feat) if need_dfeat else None
    for t0, t1 in _chunks(B, T, cap, npix):
        raw, w, va, dx, dy = _weights(cx, cy, val, inv_r2, cnt, px, py, t0, t1)
        gt = g[:, t0:t1]
        trans = _transmittance(w)
        wT = w * trans
        A = torch.einsum("btck,btcp->btkp", feat[:, t0:t1], gt)
        suffix = torch.flip(torch.cumsum(torch.flip(wT * A, [2]), dim=2), [2])
        S = torch.cat([suffix[:, :, 1:], torch.zeros_like(suffix[:, :, :1])], dim=2)
        dLdw = trans * A - S / (1.0 - w + EPS)
        active = ((raw > 0.0) & (raw < 1.0)).to(torch.float32) * va[..., None]
        dd2 = dLdw * (-inv_r2) * active * (-2.0)
        dcx[:, t0:t1] = torch.sum(dd2 * dx, -1)
        dcy[:, t0:t1] = torch.sum(dd2 * dy, -1)
        if need_dfeat:
            dfeat[:, t0:t1] = torch.einsum("btkp,btcp->btck", wT, gt)
    return dcx, dcy, dfeat


def _composite_fwd(cx, cy, val, feat, inv_r2: float, cnt, Wt: int, tile: int):
    """K2's plain version on every device."""
    _check(cx, cy, val, feat, cnt, tile)
    composite_tiles.launches += 1
    return _composite_tiles_torch(cx, cy, val, feat, inv_r2, cnt, Wt, tile)


def composite_tiles_bwd(cx, cy, val, feat, inv_r2: float, cnt, Wt: int, tile: int, g,
                        need_dfeat: bool = True):
    """K3's plain version on every device: g (B, T, C, tile²) upstream
    gradient → (dcx, dcy (B, T, cap), dfeat (B, T, C, cap) or None)."""
    _check(cx, cy, val, feat, cnt, tile)
    B, T, cap = cx.shape
    C = feat.shape[2]
    if g.shape != (B, T, C, tile * tile) or g.dtype != torch.float32 or g.device != cx.device:
        raise ValueError(f"composite_tiles_bwd: g {tuple(g.shape)} {g.dtype} {g.device}")
    composite_tiles_bwd.launches += 1
    return _composite_tiles_bwd_torch(cx, cy, val, feat, inv_r2, cnt, Wt, tile, g, need_dfeat)


class _CompositeTiles(torch.autograd.Function):
    @staticmethod
    def forward(ctx, cx, cy, val, feat, inv_r2, cnt, Wt, tile, fwd, bwd):
        ctx.save_for_backward(cx, cy, val, feat, cnt)
        ctx.args = (inv_r2, Wt, tile, bwd)
        return fwd(cx, cy, val, feat, inv_r2, cnt, Wt, tile)

    @staticmethod
    @once_differentiable
    def backward(ctx, g):
        cx, cy, val, feat, cnt = ctx.saved_tensors
        inv_r2, Wt, tile, bwd = ctx.args
        dcx, dcy, dfeat = bwd(cx, cy, val, feat, inv_r2, cnt, Wt, tile, g.contiguous(),
                              ctx.needs_input_grad[3])
        return dcx, dcy, None, dfeat, None, None, None, None, None, None


def composite_tiles(cx, cy, val, feat, inv_r2: float, cnt, Wt: int, tile: int):
    """cx, cy, val (B, T, cap) f32 z-sorted candidates in pixel units (val
    = 1 for live candidates, 0 for padding), feat (B, T, C, cap) f32,
    inv_r2 = 1/r² in pixel units, cnt (B, T) i32 → (B, T, C, tile²) f32.
    Differentiable in cx, cy and feat: K2 forward, K3 backward."""
    return _CompositeTiles.apply(cx, cy, val, feat, inv_r2, cnt, Wt, tile, _composite_fwd,
                                 composite_tiles_bwd)


def composite_tiles_plain(cx, cy, val, feat, inv_r2: float, cnt, Wt: int, tile: int):
    """``composite_tiles`` from the plain versions of K2 and K3, on any
    device (the reference the kernels are held to)."""
    return _CompositeTiles.apply(cx, cy, val, feat, inv_r2, cnt, Wt, tile,
                                 _composite_tiles_torch, _composite_tiles_bwd_torch)


composite_tiles.launches = 0
composite_tiles_bwd.launches = 0
