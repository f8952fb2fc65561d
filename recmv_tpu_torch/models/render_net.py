"""IDR rendering network (counterpart of
``recmv_tpu/models/render_net.py``, mode "idr", the one the configs use):
[points, PE(view dirs), normals, features] → 4×512 ReLU MLP
(weight-normalized) → tanh RGB in [-1, 1]."""

from __future__ import annotations

import torch
import torch.nn as nn

from ..ops.embedder import Embedder, embed_with_ratio
from .mlp import Linear, torch_linear_init


class RenderNet(nn.Module):
    def __init__(self, layers, multires_v: int, multires_n: int):
        super().__init__()
        self.lins = nn.ModuleList(layers)
        self.embed_v = Embedder(multires_v) if multires_v > 0 else None
        self.embed_n = Embedder(multires_n) if multires_n > 0 else None


def init_render_net(gen: torch.Generator, condlen: int = 256, multires_v: int = 4,
                    multires_n: int = 0) -> RenderNet:
    input_ch = 9 + condlen
    if multires_v > 0:
        input_ch += Embedder(multires_v).out_dim - 3
    if multires_n > 0:
        input_ch += Embedder(multires_n).out_dim - 3
    all_dims = [input_ch, 512, 512, 512, 512, 3]
    layers = [Linear(*torch_linear_init(gen, all_dims[l], all_dims[l + 1]), weight_norm=True)
              for l in range(len(all_dims) - 1)]
    return RenderNet(layers, multires_v, multires_n)


def render_net_apply(net: RenderNet, points, normals, view_dirs, feature_vectors, ratio=None):
    """All inputs (..., 3) except feature_vectors (..., condlen)."""
    if isinstance(ratio, dict):
        ratio = ratio.get("renderRatio")
    view_dirs = embed_with_ratio(net.embed_v, view_dirs, ratio)
    normals = embed_with_ratio(net.embed_n, normals, ratio)
    x = torch.cat([points, view_dirs, normals, feature_vectors], dim=-1)
    for l, lin in enumerate(net.lins):
        x = lin(x)
        if l < len(net.lins) - 1:
            x = torch.relu(x)
    return torch.tanh(x)
