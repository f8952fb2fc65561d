"""Builds the port's native code at first use, from the sources in the
checkout, into ``recmv_tpu_torch/_build/`` (listed in ``.gitignore``).

- ``kernels()``: the Hopper kernels in ``csrc/*.cu``, compiled by ``nvcc``
  for ``sm_90a`` into one shared library with a plain C interface and
  loaded with ctypes. Each C entry point launches on the stream it is
  given and returns ``cudaGetLastError()``.
- ``meshops()``: the host C++ marching cubes and isotropic remesher,
  compiled by ``g++`` from ``csrc/meshops.cpp``, the port's copy of
  ``recmv_tpu/native/meshops.cpp``, with the JAX package's flags
  (``-march=native`` among them: both builds contract the same
  multiply-adds, so both give the same arrays on one machine).
- ``imageio()``: the host JPEG decoder and PNG unfilter behind
  ``data/image.imread``, compiled by ``g++`` from ``csrc/imageio.cpp``
  with the same flags (its arithmetic is integer, so they cannot change
  its bits).

Every source compiled here lies under ``recmv_tpu_torch/csrc/``.

A library's sources compile at the same time, one compiler process each,
and are then linked. Its file name carries a hash of its sources and
flags, so an edit to a source never loads a stale build. The compiler's
output is kept
beside the library as ``<library>.log`` (for the kernels, ptxas's
registers, shared memory and spills per kernel: ``kernels_build_log()``).
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import os.path as osp
import shutil
import subprocess
import tempfile

_PKG = osp.dirname(osp.abspath(__file__))
BUILD_DIR = osp.join(_PKG, "_build")
CSRC = osp.join(_PKG, "csrc")
KERNEL_SOURCES = ("mesh_raster.cu", "composite_fwd.cu", "composite_bwd.cu")
MESHOPS_SRC = osp.join(CSRC, "meshops.cpp")
IMAGEIO_SRC = osp.join(CSRC, "imageio.cpp")

NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-Xcompiler", "-fPIC", "-fmad=false", "-Xptxas", "-v"]
GXX_FLAGS = ["-O3", "-march=native", "-fPIC", "-std=c++17"]

_LIBS: dict = {}


def _nvcc() -> str:
    cand = osp.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"), "bin", "nvcc")
    return cand if osp.isfile(cand) else "nvcc"


def _compile(tag: str, compiler: str, flags: list, sources: list) -> str:
    """Compile ``sources`` into ``_build/lib<tag>_<hash>.so`` unless that
    file exists; returns its path. Each source compiles to an object in
    its own process, all started together, and the objects are then linked
    with ``-shared``. Builds in a temporary directory and renames, so an
    interrupted build leaves no library behind; the compiler's output goes
    to ``<path>.log``."""
    h = hashlib.sha256(" ".join(flags).encode())
    for s in sources:
        with open(s, "rb") as f:
            h.update(f.read())
    path = osp.join(BUILD_DIR, f"lib{tag}_{h.hexdigest()[:16]}.so")
    if osp.isfile(path):
        return path
    os.makedirs(BUILD_DIR, exist_ok=True)
    work = tempfile.mkdtemp(dir=BUILD_DIR)
    try:
        objs = [osp.join(work, f"{i}.o") for i in range(len(sources))]
        procs = [subprocess.Popen([compiler, *flags, "-c", s, "-o", o], stdout=subprocess.PIPE,
                                  stderr=subprocess.STDOUT, text=True)
                 for s, o in zip(sources, objs)]
        outs = [p.communicate()[0] for p in procs]
        log = "".join(outs)
        if any(p.returncode != 0 for p in procs):
            raise RuntimeError(f"building {tag} failed:\n{log}")
        lib = osp.join(work, "lib.so")
        link = subprocess.run([compiler, *flags, "-shared", *objs, "-o", lib],
                              capture_output=True, text=True)
        if link.returncode != 0:
            raise RuntimeError(f"linking {tag} failed:\n{link.stdout}\n{link.stderr}")
        with open(path + ".log", "w") as f:
            f.write(log + link.stdout + link.stderr)
        os.replace(lib, path)
    finally:
        shutil.rmtree(work, ignore_errors=True)
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
        lib.composite_bwd_launch.restype = i
        lib.composite_bwd_launch.argtypes = [p, p, p, p, p, p, p, p, p, f,
                                             i, i, i, i, i, i, i, p]
        _LIBS["kernels"] = lib
    return _LIBS["kernels"]


def kernels_build_log() -> str:
    """What the compiler printed when it built the kernel library (ptxas's
    resource use per kernel; empty when the library was built without a
    log); builds the library first if needed."""
    log = kernels()._name + ".log"
    if not osp.isfile(log):
        return ""
    with open(log) as f:
        return f.read()


def meshops() -> ctypes.CDLL:
    """The host marching-cubes and remeshing library (built on first
    call)."""
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
        lib.isotropic_remesh.restype = i64
        lib.isotropic_remesh.argtypes = [f32p, i64, i32p, i64, ctypes.c_float,
                                         ctypes.c_int32, f32p, i64, i32p, i64, i64p]
        _LIBS["meshops"] = lib
    return _LIBS["meshops"]


def imageio() -> ctypes.CDLL:
    """The host image decoding library (built on first call)."""
    if "imageio" not in _LIBS:
        path = _compile("imageio", "g++", GXX_FLAGS, [IMAGEIO_SRC])
        lib = ctypes.CDLL(path)
        p, i64 = ctypes.c_void_p, ctypes.c_int64
        lib.jpeg_decode.restype = ctypes.c_int
        lib.jpeg_decode.argtypes = [p, i64, p, i64, i64, ctypes.c_char_p, i64]
        lib.png_unfilter.restype = i64
        lib.png_unfilter.argtypes = [p, p, i64, i64, i64]
        _LIBS["imageio"] = lib
    return _LIBS["imageio"]


def build_all() -> None:
    """Build every native library of the port (the kernels need nvcc)."""
    kernels()
    meshops()
    imageio()
