"""MLP building blocks (counterpart of ``recmv_tpu/models/mlp.py``):
torch-style Linear initialization, weight normalization and softplus
with β = 100.

A layer keeps the JAX parameter names — ``W, b`` for a plain layer,
``v, g, b`` for a weight-normalized one with w = g · v / ‖v‖ — but stores
matrices in torch's (out, in) layout; the loaders transpose.

``Linear(x, compute_dtype=torch.bfloat16)`` is the JAX ``linear_apply``
with that ``compute_dtype``: bf16 operands, f32 accumulation, f32 result,
then the f32 bias. It runs as the f32 product of the bf16-rounded
operands, which holds the same exact products (a product of two bf16
numbers fits in f32) and has a double backward; autograd rounds the
gradients at the two casts as JAX's transposes of ``astype`` do.
"""

from __future__ import annotations

import math

import torch
import torch.nn as nn
import torch.nn.functional as F


class Linear(nn.Module):
    """One dense layer, plain or weight-normalized (norm over inputs)."""

    def __init__(self, W: torch.Tensor, b: torch.Tensor, weight_norm: bool = False):
        super().__init__()
        self.weight_norm = weight_norm
        if weight_norm:
            self.v = nn.Parameter(W.clone())
            self.g = nn.Parameter(torch.linalg.norm(W, dim=1))
        else:
            self.W = nn.Parameter(W.clone())
        self.b = nn.Parameter(b.clone())

    def weight(self) -> torch.Tensor:
        if self.weight_norm:
            norm = torch.clamp(torch.linalg.norm(self.v, dim=1), min=1e-12)
            return self.v * (self.g / norm)[:, None]
        return self.W

    def forward(self, x: torch.Tensor, compute_dtype=None) -> torch.Tensor:
        if compute_dtype is None:
            return F.linear(x, self.weight(), self.b)
        # the f32 product of the operands rounded to compute_dtype
        return F.linear(x.to(compute_dtype).float(),
                        self.weight().to(compute_dtype).float()) + self.b


def torch_linear_init(gen: torch.Generator, d_in: int, d_out: int):
    """nn.Linear's default init: kaiming_uniform(a=√5) weight, uniform
    bias bounded by 1/√fan_in. Returns (W (out, in), b)."""
    bound_w = math.sqrt(6.0 / ((1 + 5) * d_in))
    W = (torch.rand(d_out, d_in, generator=gen) * 2.0 - 1.0) * bound_w
    bound_b = 1.0 / math.sqrt(d_in)
    b = (torch.rand(d_out, generator=gen) * 2.0 - 1.0) * bound_b
    return W, b


def softplus_beta(x: torch.Tensor, beta: float = 100.0, threshold: float = 20.0) -> torch.Tensor:
    """(1/β) log(1 + exp(βx)), linear above threshold/β."""
    return F.softplus(x, beta=beta, threshold=threshold)
