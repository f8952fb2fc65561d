"""Marching cubes over a dense SDF volume on the volume's device
(counterpart of ``recmv_tpu/ops/marching_cubes.py``).

The same algorithm as the JAX package's, and so the same mesh in the same
order:

1. three active-edge masks (a sign change along x, y, z);
2. every active edge gets its vertex slot in edge-linear order: the
   x-edges, then the y-edges, then the z-edges, each in (z, y, x) raster
   order;
3. each vertex is interpolated on its edge by gathers only, with the JAX
   package's float32 formula: ``t = where(|v1 − v0| < 1e-12, 0.5,
   (level − v0)/(v1 − v0))`` clipped to [0, 1], then ``(x0 + dx·t)·spacing
   + origin``;
4. per cell, the 8-corner configuration selects up to 5 triangles of the
   generated tables (``mc_tables.py``); the triangles come out in cell
   order, then in table order within a cell.

The JAX version keeps static shapes for the TPU: lane-major ``(3, cap)``
buffers, fixed-capacity scatters and an ``active_cap`` on the compacted
active cells, which its caller grows and re-extracts with on overflow
(``recmv_tpu/core/network.py`` ``discretize_sdf``). Those are throughput
knobs for XLA's static shapes and change no result; here the compaction is
``torch.nonzero`` and the arrays come out at their exact sizes, so neither
the capacity nor the re-extraction loop exists.

Memory: the dense intermediates are boolean or uint8. At the fine
pyramid's grid (D, H, W) = (225, 417, 321) there are ≈ 90.05M edges and
29.8M cells: 90 MB of edge masks and 30 MB of cell configurations. At 513³
there are ≈ 404M edges (404 MB of masks) and 134M cells. A dense int32
slot array, as the JAX version's cumsum makes, would be 360 MB and 1.6 GB
there; instead a cell's edge finds its vertex slot by ``searchsorted``
over the sorted active-edge ids, whose size is the surface's.

Volume layout: vol[z, y, x] (D, H, W); the surface is at ``level`` with
"inside" = vol < level; spacing and origin are (x, y, z).
"""

from __future__ import annotations

import numpy as np
import torch

from .mc_tables import CORNERS, MAX_TRIS, N_TRIS, TRI_TABLE

# Per-cell local edge → (axis, dz, dy, dx) of the global edge it is:
# axis 0 = x-edge, 1 = y-edge, 2 = z-edge, offsets from the cell's origin.
_EDGE_AXIS_OFFSET = np.array(
    [[0, 0, 0, 0],   # e0 (c0, c1): x-edge @ (0, 0, 0)
     [1, 0, 0, 1],   # e1 (c1, c2): y-edge @ (0, 0, 1)
     [0, 0, 1, 0],   # e2 (c2, c3): x-edge @ (0, 1, 0)
     [1, 0, 0, 0],   # e3 (c3, c0): y-edge @ (0, 0, 0)
     [0, 1, 0, 0],   # e4 (c4, c5): x-edge @ (1, 0, 0)
     [1, 1, 0, 1],   # e5 (c5, c6): y-edge @ (1, 0, 1)
     [0, 1, 1, 0],   # e6 (c6, c7): x-edge @ (1, 1, 0)
     [1, 1, 0, 0],   # e7 (c7, c4): y-edge @ (1, 0, 0)
     [2, 0, 0, 0],   # e8 (c0, c4): z-edge @ (0, 0, 0)
     [2, 0, 0, 1],   # e9 (c1, c5): z-edge @ (0, 0, 1)
     [2, 0, 1, 1],   # e10 (c2, c6): z-edge @ (0, 1, 1)
     [2, 0, 1, 0]],  # e11 (c3, c7): z-edge @ (0, 1, 0)
    dtype=np.int64,
)


def marching_cubes(vol: torch.Tensor, level: float = 0.0, origin=(0.0, 0.0, 0.0),
                   spacing=(1.0, 1.0, 1.0), max_verts: int = 1 << 17,
                   max_faces: int = 1 << 18):
    """Extract the iso-surface of ``vol`` (D, H, W) on its device →
    (verts (V, 3) float32 world coordinates, faces (F, 3) int64), in the
    JAX ``marching_cubes``' order. Raises ValueError when V > ``max_verts``
    or F > ``max_faces`` (the JAX package's and the host path's buffers;
    an overflow is never truncated)."""
    dev = vol.device
    vol = vol.to(torch.float32)
    D, H, W = vol.shape
    lvl = torch.tensor(level, dtype=torch.float32, device=dev)
    org = torch.tensor(np.asarray(origin, np.float32), device=dev)
    spc = torch.tensor(np.asarray(spacing, np.float32), device=dev)
    inside = vol < lvl

    # active edges in edge-linear order: x-edges, y-edges, z-edges
    sizes = (D * H * (W - 1), D * (H - 1) * W, (D - 1) * H * W)
    offs = (0, sizes[0], sizes[0] + sizes[1])
    masks = (inside[:, :, :-1] != inside[:, :, 1:], inside[:, :-1, :] != inside[:, 1:, :],
             inside[:-1] != inside[1:])
    edge_ids = torch.cat([torch.nonzero(m.reshape(-1))[:, 0] + o for m, o in zip(masks, offs)])
    del masks
    n_verts = edge_ids.numel()
    if n_verts > max_verts:
        raise ValueError(f"MC overflow: nv={n_verts}/{max_verts}")

    # decode each active edge → lower corner (z0, y0, x0) and its axis
    axis = (edge_ids >= offs[1]).long() + (edge_ids >= offs[2]).long()
    rel = edge_ids - torch.tensor(offs, device=dev)[axis]
    dims_w = torch.tensor((W - 1, W, W), device=dev)[axis]
    dims_h = torch.tensor((H, H - 1, H), device=dev)[axis]
    x0 = rel % dims_w
    y0 = (rel // dims_w) % dims_h
    z0 = rel // (dims_w * dims_h)
    dx, dy, dz = ((axis == a).long() for a in range(3))
    v0 = vol[z0, y0, x0]
    v1 = vol[z0 + dz, y0 + dy, x0 + dx]
    denom = v1 - v0
    t = torch.where(denom.abs() < 1e-12, torch.full_like(denom, 0.5), (lvl - v0) / denom)
    t = t.clamp(0.0, 1.0)
    verts = torch.stack([(x0.float() + dx.float() * t) * spc[0] + org[0],
                         (y0.float() + dy.float() * t) * spc[1] + org[1],
                         (z0.float() + dz.float() * t) * spc[2] + org[2]], dim=1)

    # per-cell configurations (uint8: bit i set ⇔ corner i inside)
    Dc, Hc, Wc = D - 1, H - 1, W - 1
    cfg = torch.zeros((Dc, Hc, Wc), dtype=torch.uint8, device=dev)
    for i, (cx, cy, cz) in enumerate(CORNERS.tolist()):
        cfg |= inside[cz:cz + Dc, cy:cy + Hc, cx:cx + Wc].to(torch.uint8) << i
    del inside
    cfg = cfg.reshape(-1)
    cells = torch.nonzero((cfg != 0) & (cfg != 255))[:, 0]
    cfg_a = cfg[cells].long()
    del cfg
    ntri = torch.as_tensor(N_TRIS, device=dev).long()[cfg_a]
    keep = ntri > 0
    cells, cfg_a, ntri = cells[keep], cfg_a[keep], ntri[keep]

    # each active cell's triangles in table order → global edge ids → slots
    czc, rem = cells // (Hc * Wc), cells % (Hc * Wc)
    cyc, cxc = rem // Wc, rem % Wc
    le = torch.as_tensor(TRI_TABLE, device=dev).long()[cfg_a]         # (A, 15)
    tri_on = (torch.arange(MAX_TRIS, device=dev)[None] < ntri[:, None])  # (A, 5)
    le = le.reshape(-1, MAX_TRIS, 3)[tri_on]                            # (F, 3) cell, k order
    n_faces = le.shape[0]
    if n_faces > max_faces:
        raise ValueError(f"MC overflow: nf={n_faces}/{max_faces}")
    cell_of = torch.repeat_interleave(torch.arange(cells.numel(), device=dev), ntri)
    eao = torch.as_tensor(_EDGE_AXIS_OFFSET, device=dev)[le]            # (F, 3, 4)
    e_axis = eao[..., 0]
    gz = czc[cell_of][:, None] + eao[..., 1]
    gy = cyc[cell_of][:, None] + eao[..., 2]
    gx = cxc[cell_of][:, None] + eao[..., 3]
    flat = torch.where(e_axis == 0, (gz * H + gy) * (W - 1) + gx,
                       torch.where(e_axis == 1, offs[1] + (gz * (H - 1) + gy) * W + gx,
                                   offs[2] + (gz * H + gy) * W + gx))
    faces = torch.searchsorted(edge_ids, flat.reshape(-1)).reshape(-1, 3)
    return verts, faces


def marching_cubes_np(vol, level=0.0, origin=(0, 0, 0), spacing=(1, 1, 1),
                      max_verts=1 << 17, max_faces=1 << 18):
    """Host wrapper: ``vol`` a numpy volume, run on the CPU → (verts (V, 3)
    float32, faces (F, 3) int64) numpy arrays."""
    v, f = marching_cubes(torch.as_tensor(np.asarray(vol, np.float32)), level, origin,
                          spacing, max_verts=max_verts, max_faces=max_faces)
    return v.numpy(), f.numpy()
