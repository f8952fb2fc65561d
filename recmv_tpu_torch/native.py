"""Host marching cubes and isotropic remesh (counterpart of
``recmv_tpu/native/__init__.py`` ``marching_cubes_host`` and
``isotropic_remesh``): the same C++ source and the same generated tables,
compiled into the port's own build directory (``_build.py``). A build or
load failure raises."""

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


def isotropic_remesh(verts: np.ndarray, faces: np.ndarray, target_len: float,
                     iters: int = 3, grow: float = 8.0):
    """Native isotropic remesh (the pymeshlab replacement of the
    registration, garment_structure.py:402-460); boundary vertices are
    pinned → (verts (V, 3) f32, faces (F, 3) int64). Raises ValueError when
    the output outgrows ``grow`` times the input."""
    lib = _build.meshops()
    verts = np.ascontiguousarray(verts, np.float32)
    faces = np.ascontiguousarray(faces, np.int32)
    max_v = int(len(verts) * grow) + 1024
    max_f = int(len(faces) * grow) + 2048
    out_v = np.empty((max_v, 3), np.float32)
    out_f = np.empty((max_f, 3), np.int32)
    counts = np.zeros(2, np.int64)
    ret = lib.isotropic_remesh(verts.reshape(-1), len(verts), faces.reshape(-1), len(faces),
                               np.float32(target_len), np.int32(iters), out_v.reshape(-1),
                               max_v, out_f.reshape(-1), max_f, counts)
    if ret != 0:
        raise ValueError("isotropic_remesh overflow")
    return out_v[: counts[0]].copy(), out_f[: counts[1]].astype(np.int64)
