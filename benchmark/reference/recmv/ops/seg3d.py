"""Coarse-to-fine ("lossless") SDF evaluation on a resolution pyramid
(counterpart of ``recmv_tpu/ops/seg3d.py``, ``seg3d_forward``).

Evaluate the query on the coarsest grid; per level, upsample 2x
(trilinear, align_corners=True), find sign-boundary voxels, dilate them
3x3x3 and re-query those not yet evaluated; then re-query the dilated
neighbourhoods of sign conflicts until none remain. The result equals a
dense evaluation of the finest grid on every sign-relevant voxel.

The JAX version works on fixed per-level budgets to keep shapes static;
its budgets are throughput knobs only. Here the candidate voxels are
gathered with ``nonzero`` and queried in chunks, which gives the same
volume.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from .grid_sample import max_pool_3d_same, upsample2x


@dataclass(frozen=True)
class Seg3dConfig:
    b_min: tuple           # (3,) world bbox min (x, y, z)
    b_max: tuple           # (3,)
    resolutions: tuple     # ((W, H, D), ...) coarse → fine, res_{k+1} = 2 res_k − 1

    def __post_init__(self):
        res = tuple(tuple(int(v) for v in r) for r in self.resolutions)
        object.__setattr__(self, "resolutions", res)
        for a, b in zip(res[:-1], res[1:]):
            for x, y in zip(a, b):
                assert y == 2 * x - 1, f"pyramid must double-refine: {a} -> {b}"


def _world_coords(cfg: Seg3dConfig, coords_xyz: torch.Tensor) -> torch.Tensor:
    """Integer coords on the finest grid → world points (voxel centres)."""
    dev = coords_xyz.device
    res_last = torch.tensor(cfg.resolutions[-1], dtype=torch.float32, device=dev)
    b_min = torch.tensor(cfg.b_min, dtype=torch.float32, device=dev)
    b_max = torch.tensor(cfg.b_max, dtype=torch.float32, device=dev)
    c = coords_xyz.to(torch.float32) / res_last + 0.5 / res_last
    return c * (b_max - b_min) + b_min


def final_grid_spacing(cfg: Seg3dConfig):
    """(spacing_xyz, origin_xyz) of the finest grid, for marching cubes."""
    res = np.asarray(cfg.resolutions[-1], np.float64)
    b_min = np.asarray(cfg.b_min, np.float64)
    b_max = np.asarray(cfg.b_max, np.float64)
    spacing = (b_max - b_min) / res
    return tuple(spacing), tuple(b_min + spacing / 2.0)


def _query_flat(query_fn, cfg, flat_idx, shape, stride, chunk):
    """Query the voxels ``flat_idx`` of a level grid (D, H, W)."""
    D, H, W = shape
    out = []
    for s in range(0, flat_idx.shape[0], chunk):
        idx = flat_idx[s:s + chunk]
        zc, rem = idx // (H * W), idx % (H * W)
        coords = torch.stack([rem % W, rem // W, zc], -1) * stride
        out.append(query_fn(_world_coords(cfg, coords)))
    if not out:
        return torch.empty(0, device=flat_idx.device)
    return torch.cat(out)


def seg3d_forward(query_fn, cfg: Seg3dConfig, device=None, chunk: int = 1 << 18) -> torch.Tensor:
    """query_fn: (N, 3) world points → (N,) values. Returns the finest
    dense volume (D, H, W); signs are taken about 0."""
    res_last = np.asarray(cfg.resolutions[-1])
    W0, H0, D0 = cfg.resolutions[0]
    stride0 = torch.as_tensor((res_last - 1) // (np.asarray(cfg.resolutions[0]) - 1),
                              device=device)
    all0 = torch.arange(W0 * H0 * D0, device=device)
    occ = _query_flat(query_fn, cfg, all0, (D0, H0, W0), stride0, chunk).reshape(D0, H0, W0)
    evaluated = torch.ones_like(occ, dtype=torch.bool)

    for W, H, D in cfg.resolutions[1:]:
        stride = torch.as_tensor((res_last - 1) // (np.asarray((W, H, D)) - 1), device=device)
        valid = upsample2x((occ > 0).to(torch.float32))
        occ = upsample2x(occ)
        is_boundary = max_pool_3d_same((valid > 0.0) & (valid < 1.0), 3)
        ev_up = torch.zeros((D, H, W), dtype=torch.bool, device=device)
        ev_up[::2, ::2, ::2] = evaluated
        newly = is_boundary & ~ev_up
        occ_interp = occ.clone()
        idx = torch.nonzero(newly.reshape(-1))[:, 0]
        occ.view(-1)[idx] = _query_flat(query_fn, cfg, idx, (D, H, W), stride, chunk)
        evaluated = ev_up | newly
        while True:
            conflict = newly & (occ_interp * occ < 0)
            neigh = max_pool_3d_same(conflict, 3) & ~evaluated
            idx = torch.nonzero(neigh.reshape(-1))[:, 0]
            if idx.numel() == 0:
                break
            occ.view(-1)[idx] = _query_flat(query_fn, cfg, idx, (D, H, W), stride, chunk)
            evaluated = evaluated | neigh
            newly = neigh
    return occ


def seg3d_dense(query_fn, cfg: Seg3dConfig, device=None, chunk: int = 1 << 18) -> torch.Tensor:
    """The finest grid evaluated densely, in chunks of ``chunk`` points:
    the reference ``seg3d_forward`` must equal on every sign-relevant
    voxel (the lossless property). Nothing on the training path calls it."""
    W, H, D = cfg.resolutions[-1]
    idx = torch.arange(W * H * D, device=device)
    stride = torch.ones(3, dtype=torch.int64, device=device)
    return _query_flat(query_fn, cfg, idx, (D, H, W), stride, chunk).reshape(D, H, W)
