"""recmv_tpu_torch — the PyTorch + CUDA port of ``recmv_tpu``.

The JAX package ``recmv_tpu`` is the reference; this package mirrors its
layout (``config/ ops/ models/ core/ data/``) and its function names, so
each module's counterpart is found under the same path. It imports torch,
numpy and scipy, never JAX.

The port does all that the JAX package does: the whole training step
(remesh: seg3d and the marching cubes on the device), the ① curve
branch with its visibility gates (body and garment z-buffers through the
mesh rasterizer), the ② mask branch's
point-splat render and IoU with its backward, ray seeding through the mesh
rasterizer, the surface solve, the whole ③ ``main_loss`` through the
implicit surface adjoint, and the optimizer updates; the one-time scene
initialization (templates, the curve fit, the Laplacian registration and
the IGR fits of the SDFs), checkpoints and the training CLI
(``python -m recmv_tpu_torch.train``); inference and registration; the
body priors (the TCMR joints, the beta pre-fit, licensed SMPL assets),
the large-pose stage (``python -m recmv_tpu_torch.train_large_pose``)
and the debug renders; the benches and the quality evaluation
(``recmv_tpu_torch.tools``, ``python -m recmv_tpu_torch.bench``); and the
scene-preparation and visualization tools (``recmv_tpu_torch.tools``). The
three TPU kernels
on that path (the mesh z-buffer, the point composite and its backward) are
hand-written CUDA C++ for Hopper (``csrc/``), built with ``nvcc`` at first
use and bound with ctypes (``_build.py``); each sits beside a plain
PyTorch version of the same function, which the wrapper takes for CPU
tensors only. Entry points run on the card unless a device is named.

Precision: float32, with TF32 switched off for matmuls and cuDNN below,
except where the JAX package computes with bf16 operands: the translator
and the pc-sdf and curve-aware values take bf16 operands with f32 accumulation
(``models/mlp.Linear`` with ``compute_dtype``), as there.
"""

import torch as _torch

__version__ = "0.1.0"

_torch.backends.cuda.matmul.allow_tf32 = False
_torch.backends.cudnn.allow_tf32 = False


def resolve_device(device=None) -> _torch.device:
    """``device`` as a ``torch.device``; when none is given, the CUDA card.
    Raises when the device is (or defaults to) the card and there is none:
    the port runs on the CPU only when asked to."""
    device = _torch.device("cuda" if device is None else device)
    if device.type == "cuda" and not _torch.cuda.is_available():
        raise RuntimeError("no CUDA device; pass device='cpu' to run the port on the CPU")
    return device
