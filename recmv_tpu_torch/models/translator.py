"""Non-rigid offset field (counterpart of
``recmv_tpu/models/translator.py``): a 5-layer ReLU MLP mapping
[PE(xyz), per-frame latent] → 3-d offset, last layer N(0, 1e-3).

As in the JAX package, all five layers take bf16 operands with f32
accumulation and an f32 bias (``mlp.Linear`` with ``compute_dtype``), and
the hidden activations are stored in bf16 after the ReLU.
"""

from __future__ import annotations

import torch
import torch.nn as nn

from ..ops.embedder import Embedder, embed_with_ratio
from .mlp import Linear, torch_linear_init


class Translator(nn.Module):
    def __init__(self, layers, multires: int, condlen: int):
        super().__init__()
        self.lins = nn.ModuleList(layers)
        self.multires = multires
        self.condlen = condlen
        self.embedder = Embedder(multires) if multires > 0 else None


def init_translator(gen: torch.Generator, condlen: int = 128, multires: int = 6) -> Translator:
    input_ch = (Embedder(multires).out_dim if multires > 0 else 3) + condlen
    dims = [input_ch, 512, 512, 512, 512, 3]
    layers = []
    for l in range(len(dims) - 1):
        if l == len(dims) - 2:
            W = 1e-3 * torch.randn(dims[l + 1], dims[l], generator=gen)
            b = torch.zeros(dims[l + 1])
        else:
            W, b = torch_linear_init(gen, dims[l], dims[l + 1])
        layers.append(Linear(W, b))
    return Translator(layers, multires, condlen)


def translator_offset(net: Translator, ps: torch.Tensor, cond: torch.Tensor, ratio=None):
    """ps (..., 3) canonical points, cond (..., condlen) → offsets (..., 3)."""
    if isinstance(ratio, dict):
        ratio = ratio.get("deformerRatio")
    return translator_layers(net, torch.cat([embed_with_ratio(net.embedder, ps, ratio), cond],
                                            dim=-1))


def translator_layers(net: Translator, x: torch.Tensor) -> torch.Tensor:
    """``translator_offset`` from its input [PE(xyz), cond] on."""
    for l, lin in enumerate(net.lins):
        x = lin(x, compute_dtype=torch.bfloat16)
        if l < len(net.lins) - 1:
            x = torch.relu(x).to(torch.bfloat16)
    return x


def translator_apply(net: Translator, ps, cond, ratio=None):
    """Returns (deformed points ps + f(ps, cond), offsets)."""
    off = translator_offset(net, ps, cond, ratio)
    return ps + off, off
