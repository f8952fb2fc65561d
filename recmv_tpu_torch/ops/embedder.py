"""NeRF positional encoding with coarse-to-fine annealing weights
(counterpart of ``recmv_tpu/ops/embedder.py``).

Layout ``[x, sin(2^0 x), cos(2^0 x), ..., sin(2^(L-1) x), cos(2^(L-1) x)]``
with log-sampled bands, and the cosine annealing window over bands.
"""

from __future__ import annotations

import math

import torch


def annealing_weights(multires: int, ratio, device=None) -> torch.Tensor:
    """(2*multires,) weights; sin and cos of one band share a weight."""
    alpha = torch.as_tensor(ratio, dtype=torch.float32, device=device) * multires
    ind = torch.arange(multires, dtype=torch.float32, device=alpha.device)
    w = (1.0 - torch.cos(math.pi * torch.clamp(alpha - ind, 0.0, 1.0))) / 2.0
    return torch.repeat_interleave(w, 2)


class Embedder:
    """Positional encoder: ``emb(x)`` or ``emb(x, ws)``; x (..., 3) →
    (..., 3 * (1 + 2 * multires)), the input first."""

    def __init__(self, multires: int):
        self.multires = int(multires)
        self.freq_bands = [2.0 ** i for i in range(self.multires)]
        self.out_dim = 3 * (1 + 2 * self.multires)
        self._freqs = {}              # (device, dtype) → the bands as a tensor, made once

    def __call__(self, x: torch.Tensor, ws=None) -> torch.Tensor:
        freqs = self._freqs.get((x.device, x.dtype))
        if freqs is None:
            freqs = self._freqs[x.device, x.dtype] = torch.tensor(
                self.freq_bands, dtype=x.dtype, device=x.device)
        xf = x[..., None, :] * freqs[:, None]                       # (..., L, d)
        enc = torch.stack([torch.sin(xf), torch.cos(xf)], dim=-2)   # (..., L, 2, d)
        if ws is not None:
            w = torch.as_tensor(ws, dtype=enc.dtype, device=x.device)
            enc = enc * w.reshape(self.multires, 2)[..., None]
        enc = enc.reshape(x.shape[:-1] + (2 * self.multires * 3,))
        return torch.cat([x, enc], dim=-1)


def ratio_weights(emb: Embedder, ratio, device=None) -> torch.Tensor | None:
    """The band weights ``embed_with_ratio`` gives ``emb`` for ``ratio``, on
    ``device``: None (unweighted bands) for None; zero for ratio ≤ 0;
    otherwise annealed."""
    if ratio is None:
        return None
    r = torch.clamp(torch.as_tensor(ratio, dtype=torch.float32, device=device), min=0.0)
    return annealing_weights(emb.multires, r)


def embed_with_ratio(emb: Embedder | None, x: torch.Tensor, ratio) -> torch.Tensor:
    """The reference's ratio semantics (``ratio_weights``)."""
    if emb is None:
        return x
    return emb(x, ratio_weights(emb, ratio, x.device))
