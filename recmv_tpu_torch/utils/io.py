"""Copy of ``recmv_tpu/utils/io.py`` (``save_obj``, ``load_obj``,
``save_ply``): numpy only, kept here because importing any ``recmv_tpu``
module imports JAX. Mesh IO helpers (obj/ply writers, replacing
pytorch3d.io)."""

from __future__ import annotations

import os

import numpy as np


def save_obj(path: str, verts, faces, colors=None):
    verts = np.asarray(verts)
    faces = np.asarray(faces)
    parent = os.path.dirname(path)
    if parent:
        os.makedirs(parent, exist_ok=True)
    with open(path, "w") as f:
        if colors is not None:
            colors = np.asarray(colors)
            for v, c in zip(verts, colors):
                f.write(f"v {v[0]} {v[1]} {v[2]} {c[0]} {c[1]} {c[2]}\n")
        else:
            for v in verts:
                f.write(f"v {v[0]} {v[1]} {v[2]}\n")
        for fc in faces:
            f.write(f"f {fc[0]+1} {fc[1]+1} {fc[2]+1}\n")


def load_obj(path: str):
    verts, faces = [], []
    with open(path) as f:
        for line in f:
            if line.startswith("v "):
                verts.append([float(x) for x in line.split()[1:4]])
            elif line.startswith("f "):
                faces.append([int(p.split("/")[0]) - 1 for p in line.split()[1:4]])
    return np.asarray(verts, np.float32), np.asarray(faces, np.int64)


def save_ply(path: str, verts, faces=None):
    verts = np.asarray(verts)
    with open(path, "w") as f:
        f.write("ply\nformat ascii 1.0\n")
        f.write(f"element vertex {len(verts)}\n")
        f.write("property float x\nproperty float y\nproperty float z\n")
        if faces is not None:
            faces = np.asarray(faces)
            f.write(f"element face {len(faces)}\n")
            f.write("property list uchar int vertex_indices\n")
        f.write("end_header\n")
        for v in verts:
            f.write(f"{v[0]} {v[1]} {v[2]}\n")
        if faces is not None:
            for fc in faces:
                f.write(f"3 {fc[0]} {fc[1]} {fc[2]}\n")
