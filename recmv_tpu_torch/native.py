"""Host marching cubes (counterpart of ``recmv_tpu/native/__init__.py``
``marching_cubes_host``): the same C++ source and the same generated
tables, compiled into the port's own build directory (``_build.py``)."""

from __future__ import annotations

import numpy as np

from . import _build
from .ops.mc_tables import N_TRIS, TRI_TABLE


def marching_cubes_host(vol: np.ndarray, level: float = 0.0,
                        origin=(0, 0, 0), spacing=(1, 1, 1),
                        max_verts: int = 1 << 21, max_faces: int = 1 << 22):
    """vol (D, H, W) float32, inside = vol < level → (verts (V, 3) f32
    world coordinates, faces (F, 3) int64). Raises on buffer overflow."""
    lib = _build.meshops()
    vol = np.ascontiguousarray(vol, np.float32)
    D, H, W = vol.shape
    out_v = np.empty((max_verts, 3), np.float32)
    out_f = np.empty((max_faces, 3), np.int32)
    counts = np.zeros(2, np.int64)
    ret = lib.mc_run(vol.reshape(-1), D, H, W, np.float32(level),
                     np.asarray(origin, np.float32), np.asarray(spacing, np.float32),
                     np.ascontiguousarray(TRI_TABLE.reshape(-1), np.int32),
                     np.ascontiguousarray(N_TRIS, np.int32),
                     out_v.reshape(-1), max_verts, out_f.reshape(-1), max_faces,
                     counts)
    if ret != 0:
        raise ValueError("mc_run overflow: raise max_verts/max_faces")
    return out_v[: counts[0]].copy(), out_f[: counts[1]].astype(np.int64)
