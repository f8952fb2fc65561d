"""recmv_tpu_torch — the PyTorch + CUDA port of ``recmv_tpu``.

The JAX package ``recmv_tpu`` is the reference; this package mirrors its
layout (``config/ ops/ models/ core/ data/``) and its function names, so
each module's counterpart is found under the same path. It imports torch,
numpy and scipy, never JAX.

What is ported so far is the forward of the training step: remesh
(seg3d + host marching cubes), the mask branch's point-splat render and
IoU, ray seeding through the mesh rasterizer, the surface solve, and the
IDR colour at the solved points. The two TPU kernels on that path are
hand-written CUDA C++ for Hopper (``csrc/``), built with ``nvcc`` at first
use and bound with ctypes (``_build.py``); each sits beside a plain
PyTorch version of the same function, which the wrapper takes for CPU
tensors only.

Precision: float32 throughout. TF32 is switched off for matmuls and cuDNN
below, so the MLPs run in full f32 (the JAX package ran them at its
"high" matmul precision on the TPU).
"""

import torch as _torch

__version__ = "0.1.0"

_torch.backends.cuda.matmul.allow_tf32 = False
_torch.backends.cudnn.allow_tf32 = False
