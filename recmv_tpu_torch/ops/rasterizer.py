"""Point and mesh rasterization (counterpart of
``recmv_tpu/ops/rasterizer.py``), with the semantics of the JAX package's
Pallas backend: one fused (tile, quantized z) sort bins the primitives
into per-tile candidate lists of at most ``cap`` entries (the nearest
kept), then the per-tile kernels K1 (``mesh_raster.py``) and K2
(``composite.py``) sweep those lists front to back.

Inputs are screen-space (x_pix, y_pix, z_cam) as ``screen_with_cam_z``
makes them; pixel centres sit at integer coordinates; point radii are in
pytorch3d NDC units (2/min(H, W) per pixel). Every function takes a
leading batch of frames; frames go through one sort and one kernel
launch together.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from ..models.camera import transform_points_screen, world_to_cam
from .composite import composite_tiles
from .mesh_raster import mesh_tiles


class MeshFragments(NamedTuple):
    pix_to_face: torch.Tensor  # (B, H, W, 1) int32, -1 = empty
    bary_coords: torch.Tensor  # (B, H, W, 1, 3) perspective-corrected
    zbuf: torch.Tensor         # (B, H, W, 1) camera z, -1 = empty


def screen_with_cam_z(cam, pts: torch.Tensor) -> torch.Tensor:
    """World points → (x_pix, y_pix, z_cam), as pytorch3d's
    MeshRasterizer.transform swaps view-space z into the projection."""
    s = transform_points_screen(cam, pts)
    return torch.cat([s[..., :2], world_to_cam(cam, pts)[..., 2:]], dim=-1)


def _bin_sorted(tx0, tx1, ty0, ty1, z, valid, Ht: int, Wt: int, cap: int, span: int = 2):
    """Per-tile candidate lists for a batch of frames (``_bin_sorted`` of
    the JAX module, batched).

    All inputs are (B, P). Each primitive is copied to the span² tiles
    (ty0 + dy, tx0 + dx) it overlaps; one stable sort by the fused key
    (frame·T + tile) << zbits | zq orders the copies by tile, then near to
    far. zq quantizes z over each frame's own [zmin, zmax] to zbits =
    32 − ⌈log2(T + 2)⌉ bits, exactly as the JAX uint32 keys, so the order
    — and which candidates a full tile keeps — is the JAX order.

    Returns (B, T, cap) int64 primitive indices (0 where invalid),
    (B, T, cap) bool validity and (B, T) int32 counts (≤ cap)."""
    B, P = z.shape
    dev = z.device
    T = Ht * Wt
    tbits = max(int(np.ceil(np.log2(T + 2))), 1)
    zbits = 32 - tbits
    nq = 2 ** zbits - 1

    inf = torch.tensor(float("inf"), device=dev)
    zmin = torch.where(valid, z, inf).amin(dim=1, keepdim=True)
    zmax = torch.where(valid, z, -inf).amax(dim=1, keepdim=True)
    scale = torch.tensor(np.float32(nq), device=dev)
    zq = (z - zmin) / torch.clamp(zmax - zmin, min=1e-12) * scale
    zq = torch.clamp(torch.clamp(zq, min=0.0).to(torch.int64), max=nq)

    frame = torch.arange(B, device=dev)[:, None]
    keys, idxs = [], []
    prim = torch.arange(P, device=dev).expand(B, P)
    for dy in range(span):
        for dx in range(span):
            ty = ty0 + dy
            tx = tx0 + dx
            ok = (valid & (ty <= ty1) & (tx <= tx1)
                  & (ty >= 0) & (ty < Ht) & (tx >= 0) & (tx < Wt))
            tid = torch.where(ok, frame * T + ty * Wt + tx, B * T)
            keys.append((tid << zbits) | torch.where(ok, zq, nq))
            idxs.append(prim)
    keys = torch.stack(keys, dim=1).reshape(-1)     # frame-major, then JAX's order
    idxs = torch.stack(idxs, dim=1).reshape(-1)
    keys, order = torch.sort(keys, stable=True)
    idxs = idxs[order]

    tile_of = keys >> zbits
    starts = torch.searchsorted(tile_of, torch.arange(B * T + 1, device=dev))
    count = starts[1:] - starts[:-1]
    j = torch.arange(cap, device=dev)
    gidx = torch.clamp(starts[:-1, None] + j[None], max=keys.shape[0] - 1)
    pidx = idxs[gidx]
    count = torch.clamp(count, max=cap).to(torch.int32)
    pvalid = j[None] < count[:, None]
    pidx = torch.where(pvalid, pidx, 0)
    return pidx.reshape(B, T, cap), pvalid.reshape(B, T, cap), count.reshape(B, T)


def _untile(a: torch.Tensor, Ht: int, Wt: int, tile: int, H: int, W: int) -> torch.Tensor:
    """(B, T, ..., tile²) → (B, H, W, ...)."""
    B = a.shape[0]
    mid = a.shape[2:-1]
    a = a.reshape(B, Ht, Wt, *mid, tile, tile)
    a = a.movedim(3 + len(mid), 2)                      # (B, Ht, tile_y, Wt, ..., tile_x)
    a = a.movedim(-1, 4)                                # (B, Ht, tile_y, Wt, tile_x, ...)
    a = a.reshape(B, Ht * tile, Wt * tile, *mid)
    return a[:, :H, :W]


def composite_tile_inputs(pts: torch.Tensor, radius: float, features: torch.Tensor,
                          image_size, tile: int = 32, cap: int = 768):
    """Binning prologue of ``composite_points``: the per-tile candidate
    lists in the layout ``composite_tiles`` takes → (cx, cy, val, feat,
    inv_r2, cnt, Wt)."""
    H, W = image_size
    B, P, _ = pts.shape
    C = features.shape[1]
    ndc_scale = 2.0 / min(H, W)
    r_pix = radius / ndc_scale
    Ht, Wt = -(-H // tile), -(-W // tile)
    x, y, z = pts[..., 0], pts[..., 1], pts[..., 2]
    valid = z > 0
    tx0 = torch.floor((x - r_pix) / tile).to(torch.int64)
    tx1 = torch.floor((x + r_pix) / tile).to(torch.int64)
    ty0 = torch.floor((y - r_pix) / tile).to(torch.int64)
    ty1 = torch.floor((y + r_pix) / tile).to(torch.int64)
    pidx, pvalid, cnt = _bin_sorted(tx0, tx1, ty0, ty1, z, valid, Ht, Wt, min(cap, P))
    # coordinates and features are gathered apart, so constant features
    # (the mask branch's section one-hots) never require grad and the
    # backward skips their sums
    flat = pidx.reshape(B, -1)
    g = torch.gather(pts[..., :2], 1, flat[..., None].expand(-1, -1, 2))
    g = g.reshape(B, Ht * Wt, -1, 2)
    va = pvalid.to(torch.float32)
    ft = features.expand(B, P, C).gather(1, flat[..., None].expand(-1, -1, C))
    ft = (ft.reshape(B, Ht * Wt, -1, C) * va[..., None]).transpose(2, 3).contiguous()
    return (g[..., 0].contiguous(), g[..., 1].contiguous(), va, ft,
            ndc_scale ** 2 / (radius * radius), cnt, Wt)


def composite_points(pts: torch.Tensor, radius: float, features: torch.Tensor,
                     image_size, tile: int = 32, cap: int = 768) -> torch.Tensor:
    """Fused point rasterization + front-to-back alpha compositing.

    pts (B, P, 3) screen-space (points with z ≤ 0 are skipped), radius in
    NDC units, features (P, C) → (B, H, W, C): per pixel
    Σ_k w_k f_k Π_{j<k}(1 − w_j + 1e-10), w_k = clip(1 − d²/r², 0, 1),
    over every point of its tile's (≤ cap, nearest-kept) list.
    Differentiable in the screen coordinates and, where they require
    grad, the features (``composite_tiles``: K2 forward, K3 backward)."""
    H, W = image_size
    *args, Wt = composite_tile_inputs(pts, radius, features, image_size, tile, cap)
    out = composite_tiles(*args, Wt, tile)                                  # (B, T, C, tile²)
    return _untile(out, -(-H // tile), Wt, tile, H, W)


def mesh_tile_inputs(verts: torch.Tensor, faces: torch.Tensor, image_size,
                     tile: int = 32, cap: int = 512):
    """Binning prologue of ``rasterize_mesh``: per-face premultiplied
    coefficients gathered into the per-tile candidate lists that
    ``mesh_tiles`` takes → (prm, fid, cnt, Wt)."""
    H, W = image_size
    B = verts.shape[0]
    F = faces.shape[0]
    Ht, Wt = -(-H // tile), -(-W // tile)
    faces = faces.to(torch.int64)
    tri = verts[:, faces]                                  # (B, F, 3, 3)
    v0, v1, v2 = tri[:, :, 0], tri[:, :, 1], tri[:, :, 2]
    z_ok = (tri[..., 2] > 1e-6).all(-1)
    area = ((v1[..., 0] - v0[..., 0]) * (v2[..., 1] - v0[..., 1])
            - (v1[..., 1] - v0[..., 1]) * (v2[..., 0] - v0[..., 0]))
    fvalid = z_ok & (area.abs() >= 1e-10)
    inv_area = torch.where(fvalid, 1.0 / torch.where(fvalid, area, 1.0), 0.0)

    def edge_coeffs(p0, p1):
        # w(p) = [A(py − p0y) + B(px − p0x)]/area, A = p1x − p0x, B = −(p1y − p0y)
        A = (p1[..., 0] - p0[..., 0]) * inv_area
        Bc = -(p1[..., 1] - p0[..., 1]) * inv_area
        return A, Bc, -A * p0[..., 1] - Bc * p0[..., 0]

    qs = tuple(torch.where(fvalid, 1.0 / torch.clamp(t[..., 2], min=1e-6), 0.0)
               for t in (v0, v1, v2))
    params = torch.stack(edge_coeffs(v1, v2) + edge_coeffs(v2, v0) + edge_coeffs(v0, v1) + qs,
                         dim=-1)
    params = params * fvalid[..., None]                    # (B, F, 12)

    tx0 = torch.floor(tri[..., 0].amin(-1) / tile).to(torch.int64)
    tx1 = torch.floor(tri[..., 0].amax(-1) / tile).to(torch.int64)
    ty0 = torch.floor(tri[..., 1].amin(-1) / tile).to(torch.int64)
    ty1 = torch.floor(tri[..., 1].amax(-1) / tile).to(torch.int64)
    zmean = tri[..., 2].mean(-1)
    fidx, fval, cnt = _bin_sorted(tx0, tx1, ty0, ty1, zmean, fvalid, Ht, Wt,
                                  min(cap, F), span=3)
    g = torch.gather(params, 1, fidx.reshape(B, -1, 1).expand(-1, -1, 12))
    prm = (g.reshape(B, Ht * Wt, -1, 12) * fval[..., None]).transpose(2, 3).contiguous()
    return prm, torch.where(fval, fidx, -1).to(torch.int32), cnt, Wt


def rasterize_mesh(verts: torch.Tensor, faces: torch.Tensor, image_size,
                   tile: int = 32, cap: int = 512) -> MeshFragments:
    """verts (B, V, 3) screen-space, faces (F, 3) → K = 1 fragments.

    A pixel is inside a face when all three barycentrics are > 0 (either
    winding); barycentrics and zbuf are perspective-correct. Faces with a
    vertex at z ≤ 1e-6 or a degenerate area are skipped. Forward only:
    every consumer stops the gradient."""
    H, W = image_size
    Ht = -(-H // tile)
    prm, fid, cnt, Wt = mesh_tile_inputs(verts, faces, image_size, tile, cap)
    zb, fo, bc = mesh_tiles(prm, fid, cnt, Wt, tile)
    zbuf = _untile(zb, Ht, Wt, tile, H, W)[..., None]
    p2f = _untile(fo, Ht, Wt, tile, H, W)[..., None]
    bary = _untile(bc, Ht, Wt, tile, H, W)[..., None, :]
    return MeshFragments(p2f, bary, zbuf)


def find_surface_points(frag: MeshFragments, verts_canonical: torch.Tensor,
                        faces: torch.Tensor):
    """FindSurfacePs on a batch of frames: dense per-pixel canonical
    surface points and a hit mask → (hit (B, H, W), pts (B, H, W, 3),
    face_id (B, H, W))."""
    hit = (frag.pix_to_face[..., 0] >= 0) & (frag.bary_coords[..., 0, :] > 0).all(-1)
    fid = torch.clamp(frag.pix_to_face[..., 0], min=0).to(torch.int64)
    w = torch.where(hit[..., None], frag.bary_coords[..., 0, :], 0.0)
    tri = verts_canonical[faces.to(torch.int64)[fid]]     # (B, H, W, 3, 3)
    pts = torch.einsum("bhwk,bhwkc->bhwc", w, tri)
    return hit, pts, torch.where(hit, frag.pix_to_face[..., 0], -1)

