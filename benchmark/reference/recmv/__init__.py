"""A frozen copy of the plain path of ``recmv_tpu_torch``'s training step,
the benchmark's reference.

The modules are copies of the port's as the benchmark was defined, with
every import kept inside this copy. What differs: K1, K2 and K3
(``ops/mesh_raster``, ``ops/composite``) always take their plain PyTorch
versions; PNGs are read with numpy alone (``data/png``: filter 0, the only
filter the scene generator writes); there is no JPEG decoder, no TCMR
reader, no host marching cubes, no FLOP counter, no split of the step
over several ranks, no bridge to the JAX package's parameter trees, no
forward-only step, and none of the modules that only the one-time
initialization imports (the Laplacian registration, the template
matching, the garment templates, the KNN). Later changes to the
port do not reach this copy: it is the yardstick the port's step is held
to (``benchmark/check.py``).
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
