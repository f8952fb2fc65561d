"""Implicit SDF network (counterpart of ``recmv_tpu/models/sdf.py``): an
8×512 softplus(β=100) MLP with a skip connection at layer 4, geometric
(sphere) initialization, weight normalization and annealed positional
encoding; output = SDF value + a 256-d rendering feature."""

from __future__ import annotations

import math

import torch
import torch.nn as nn

from ..ops.embedder import Embedder, embed_with_ratio
from .mlp import Linear, softplus_beta


class SdfNet(nn.Module):
    """Parameters ``lin0 … lin{n-2}`` as in the JAX pytree."""

    def __init__(self, layers, multires: int, skip_in):
        super().__init__()
        self.lins = nn.ModuleList(layers)
        self.multires = multires
        self.skip_in = tuple(skip_in)
        self.n_layers = len(layers) + 1
        self.embedder = Embedder(multires) if multires > 0 else None


def init_sdf_net(gen: torch.Generator, multires: int = 6, bias: float = 0.6,
                 feature_vector_size: int = 256, dims=(512,) * 8, skip_in=(4,)) -> SdfNet:
    """Geometric initialization (IGR): the raw network starts near
    |x| − bias; first-layer PE channels and the skip layer's PE columns
    are zero."""
    input_ch = Embedder(multires).out_dim if multires > 0 else 3
    all_dims = [input_ch] + list(dims) + [1 + feature_vector_size]
    n_layers = len(all_dims)
    layers = []
    for l in range(n_layers - 1):
        out_dim = all_dims[l + 1] - all_dims[0] if l + 1 in skip_in else all_dims[l + 1]
        in_dim = all_dims[l]
        if l == n_layers - 2:
            W = math.sqrt(math.pi) / math.sqrt(in_dim) + 1e-4 * torch.randn(
                out_dim, in_dim, generator=gen)
            b = torch.full((out_dim,), -bias)
        elif multires > 0 and l == 0:
            W = torch.zeros(out_dim, in_dim)
            W[:, :3] = math.sqrt(2.0) / math.sqrt(out_dim) * torch.randn(out_dim, 3, generator=gen)
            b = torch.zeros(out_dim)
        elif multires > 0 and l in skip_in:
            W = math.sqrt(2.0) / math.sqrt(out_dim) * torch.randn(out_dim, in_dim, generator=gen)
            W[:, -(input_ch - 3):] = 0.0
            b = torch.zeros(out_dim)
        else:
            W = math.sqrt(2.0) / math.sqrt(out_dim) * torch.randn(out_dim, in_dim, generator=gen)
            b = torch.zeros(out_dim)
        layers.append(Linear(W, b, weight_norm=True))
    return SdfNet(layers, multires, skip_in)


def sdf_apply(net: SdfNet, pts: torch.Tensor, ratio=None):
    """pts (..., 3) → (sdf (...,), rendcond (..., F)). ``ratio`` is the PE
    annealing ratio (number, tensor, or the dict form {'sdfRatio': r})."""
    if isinstance(ratio, dict):
        ratio = ratio.get("sdfRatio")
    x = embed_with_ratio(net.embedder, pts, ratio)
    inp = x
    for l, lin in enumerate(net.lins):
        if l in net.skip_in:
            x = torch.cat([x, inp], dim=-1) / math.sqrt(2.0)
        x = lin(x)
        if l < net.n_layers - 2:
            x = softplus_beta(x, 100.0)
    return x[..., 0], x[..., 1:]


def sdf_value(net: SdfNet, pts: torch.Tensor, ratio=None) -> torch.Tensor:
    return sdf_apply(net, pts, ratio)[0]


def _point_input(pts: torch.Tensor, create_graph: bool) -> torch.Tensor:
    """The tensor to differentiate with respect to: ``pts`` itself where
    its own graph must be kept, else a fresh leaf."""
    if create_graph and pts.requires_grad:
        return pts
    return pts.detach().requires_grad_(True)


def sdf_value_and_gradient(net: SdfNet, pts: torch.Tensor, ratio=None,
                           create_graph: bool = True):
    """(sdf(x), ∇ₓ sdf(x)) for pts (..., 3): points are independent, so
    one backward pass of Σ sdf gives every point's gradient. With
    ``create_graph`` (the default) both carry the graph to the network's
    parameters and to ``pts``, as the JAX jvps do; without it neither
    does (the solver's and the seeding's use). Works under no_grad."""
    with torch.enable_grad():
        p = _point_input(pts, create_graph)
        vals = sdf_value(net, p, ratio)
        (g,) = torch.autograd.grad(vals.sum(), p, create_graph=create_graph)
    if not create_graph:
        vals = vals.detach()
    return vals, g


def sdf_gradient(net: SdfNet, pts: torch.Tensor, ratio=None,
                 create_graph: bool = False) -> torch.Tensor:
    """∇ₓ sdf(x) for pts (..., 3); differentiable with ``create_graph``
    (see ``sdf_value_and_gradient``), else it carries no graph."""
    return sdf_value_and_gradient(net, pts, ratio, create_graph)[1]
