"""Builds the port's native code at first use, from the sources in the
checkout, into ``recmv_tpu_torch/_build/`` (listed in ``.gitignore``).

- ``kernels()``: the Hopper kernels in ``csrc/*.cu``, compiled by ``nvcc``
  for ``sm_90a`` into one shared library with a plain C interface and
  loaded with ctypes. Each C entry point launches on the stream it is
  given and returns ``cudaGetLastError()``.
- ``meshops()``: the host C++ marching cubes, compiled by ``g++`` from the
  JAX package's ``recmv_tpu/native/meshops.cpp`` (the source is shared;
  the library is the port's own, so the JAX package's directory is never
  written).

A library's file name carries a hash of its sources and flags, so an edit
to a source never loads a stale build.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import os.path as osp
import subprocess
import tempfile

_PKG = osp.dirname(osp.abspath(__file__))
BUILD_DIR = osp.join(_PKG, "_build")
CSRC = osp.join(_PKG, "csrc")
KERNEL_SOURCES = ("mesh_raster.cu", "composite_fwd.cu", "composite_bwd.cu")
MESHOPS_SRC = osp.join(osp.dirname(_PKG), "recmv_tpu", "native", "meshops.cpp")

NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-fmad=false"]
GXX_FLAGS = ["-O3", "-shared", "-fPIC", "-std=c++17"]

_LIBS: dict = {}


def _nvcc() -> str:
    cand = osp.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"), "bin", "nvcc")
    return cand if osp.isfile(cand) else "nvcc"


def _compile(tag: str, compiler: str, flags: list, sources: list) -> str:
    """Compile ``sources`` into ``_build/lib<tag>_<hash>.so`` unless that
    file exists; returns its path. Writes to a temporary name first and
    renames, so an interrupted build leaves no library behind."""
    h = hashlib.sha256(" ".join(flags).encode())
    for s in sources:
        with open(s, "rb") as f:
            h.update(f.read())
    path = osp.join(BUILD_DIR, f"lib{tag}_{h.hexdigest()[:16]}.so")
    if osp.isfile(path):
        return path
    os.makedirs(BUILD_DIR, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    try:
        proc = subprocess.run([compiler, *flags, *sources, "-o", tmp],
                              capture_output=True, text=True)
        if proc.returncode != 0:
            raise RuntimeError(f"building {tag} failed:\n{proc.stdout}\n{proc.stderr}")
        os.replace(tmp, path)
    finally:
        if osp.exists(tmp):
            os.remove(tmp)
    return path


def kernels() -> ctypes.CDLL:
    """The CUDA kernel library (built on first call)."""
    if "kernels" not in _LIBS:
        path = _compile("recmv_kernels", _nvcc(), NVCC_FLAGS,
                        [osp.join(CSRC, s) for s in KERNEL_SOURCES])
        lib = ctypes.CDLL(path)
        p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
        lib.mesh_tiles_launch.restype = i
        lib.mesh_tiles_launch.argtypes = [p, p, p, p, p, p, i, i, i, i, i, p]
        lib.composite_fwd_launch.restype = i
        lib.composite_fwd_launch.argtypes = [p, p, p, p, p, p, f, i, i, i, i, i, i, p]
        lib.composite_bwd_scratch.restype = ctypes.c_long
        lib.composite_bwd_scratch.argtypes = [i, i, i, i, i, i]
        lib.composite_bwd_launch.restype = i
        lib.composite_bwd_launch.argtypes = [p, p, p, p, p, p, p, p, p, p, f,
                                             i, i, i, i, i, i, i, p]
        _LIBS["kernels"] = lib
    return _LIBS["kernels"]


def meshops() -> ctypes.CDLL:
    """The host marching-cubes library (built on first call)."""
    if "meshops" not in _LIBS:
        import numpy as np

        path = _compile("meshops", "g++", GXX_FLAGS, [MESHOPS_SRC])
        lib = ctypes.CDLL(path)
        i64 = ctypes.c_int64
        f32p = np.ctypeslib.ndpointer(np.float32, flags="C")
        i32p = np.ctypeslib.ndpointer(np.int32, flags="C")
        i64p = np.ctypeslib.ndpointer(np.int64, flags="C")
        lib.mc_run.restype = i64
        lib.mc_run.argtypes = [f32p, i64, i64, i64, ctypes.c_float, f32p, f32p,
                               i32p, i32p, f32p, i64, i32p, i64, i64p]
        _LIBS["meshops"] = lib
    return _LIBS["meshops"]


def build_all() -> None:
    """Build every native library of the port (the kernels need nvcc)."""
    kernels()
    meshops()
