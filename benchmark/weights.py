"""The networks' initial weights, made on the device in a few large draws:
the geometric init of the SDFs (IGR: the raw network starts near
|x| − 0.6; the garment SDFs' output bias −0.48, so that their zero level
lies inside this scene's seg3d box), the default ``nn.Linear`` init of
the translator and the render net with the translator's last layer at
1e-3 · N(0, 1). The shapes follow from the configuration's widths alone;
the same tensors go to the port and to the reference.

The translator and the render net are drawn from the run's seed. The
SDFs are drawn from fixed seeds (``SDF_SEED`` + the net's index): their
zero level sets are the meshes that the remesh extracts, and an SDF drawn
from the run's seed gave a garment of 1,648 to 169,560 vertices (or
none) from seed to seed, which changed the work of a step with the seed.
So every seed runs on the same meshes, with other deformation and colour
weights; ``SDF_SEED`` gives garments near the middle of 40 draws. A
configuration whose garment set needs another seed, picked by the same
40 draws, states it as ``sdf_seed``."""

from __future__ import annotations

import math

import torch

SDF_BIAS = 0.6
GARMENT_SDF_BIAS = 0.48
SDF_SEED = 90     # garments of 88,266 vertices (tube, fine) and 39,406 + 36,008 (coarse)


def _pe(multires: int) -> int:
    return 3 * (1 + 2 * multires) if multires > 0 else 3


def layers(config: dict) -> list:
    """[(name prefix, kind, in, out, extra)] of every dense layer, in the
    port's parameter order. kind: "sdf_first", "sdf_skip", "sdf_hidden",
    "sdf_last", "linear", "tiny"; extra: the output bias of "sdf_last" or
    the number of zeroed trailing input columns of "sdf_skip"."""
    out = []
    pe = _pe(config["sdf_multires"])
    dims = [pe] + list(config["sdf_hidden"]) + [1 + config["sdf_feature_size"]]
    skip = set(config["sdf_skip_in"])
    nets = [("sdf", SDF_BIAS)] + [(f"garment_sdfs.{i}", GARMENT_SDF_BIAS)
                                  for i in range(len(config["garments"]))]
    for prefix, bias in nets:
        for l in range(len(dims) - 1):
            d_in, d_out = dims[l], dims[l + 1] - (dims[0] if l + 1 in skip else 0)
            name = f"{prefix}.lins.{l}"
            if l == len(dims) - 2:
                out.append((name, "sdf_last", d_in, d_out, bias))
            elif l == 0:
                out.append((name, "sdf_first", d_in, d_out, None))
            elif l in skip:
                out.append((name, "sdf_skip", d_in, d_out, pe - 3))
            else:
                out.append((name, "sdf_hidden", d_in, d_out, None))
    tdims = ([_pe(config["translator_multires"]) + config["translator_condlen"]]
             + list(config["translator_hidden"]) + [3])
    for l in range(len(tdims) - 1):
        kind = "tiny" if l == len(tdims) - 2 else "linear"
        out.append((f"translator.lins.{l}", kind, tdims[l], tdims[l + 1], None))
    rdims = ([9 + config["render_condlen"] + _pe(config["render_multires_v"]) - 3]
             + list(config["render_hidden"]) + [3])
    for l in range(len(rdims) - 1):
        out.append((f"render.lins.{l}", "linear_wn", rdims[l], rdims[l + 1], None))
    return out


def make_weights(config: dict, seed: int, device) -> dict:
    """{parameter name: tensor} for the leaves ``sdf.*``, ``garment_sdfs.*``,
    ``translator.*`` and ``render.*``, float32 on ``device``: the SDFs from
    the configuration's ``sdf_seed`` (``SDF_SEED`` where it states none) +
    their index, the rest from ``seed``."""
    groups = {}
    for spec in layers(config):
        net = spec[0].rsplit(".lins.", 1)[0]
        groups.setdefault(net, []).append(spec)
    out = {}
    sdf_nets = [n for n in groups if n == "sdf" or n.startswith("garment_sdfs.")]
    sdf_seed = int(config.get("sdf_seed", SDF_SEED))
    for net, specs in groups.items():
        g_seed = sdf_seed + sdf_nets.index(net) if net in sdf_nets else seed
        out.update(_draw(specs, torch.Generator(device=device).manual_seed(int(g_seed)), device))
    return out


def _draw(specs: list, gen, device) -> dict:
    n_normal = sum(o * i for _, k, i, o, _ in specs if k in ("sdf_hidden", "sdf_skip",
                                                              "sdf_last", "tiny"))
    n_normal += sum(o * 3 for _, k, i, o, _ in specs if k == "sdf_first")
    n_unif = sum(o * i + o for _, k, i, o, _ in specs if k in ("linear", "linear_wn"))
    normal = torch.randn(n_normal, generator=gen, device=device)
    unif = torch.rand(n_unif, generator=gen, device=device) * 2.0 - 1.0
    at = {"n": 0, "u": 0}

    def take(kind, n, shape):
        src = normal if kind == "n" else unif
        t = src[at[kind]:at[kind] + n].reshape(shape)
        at[kind] += n
        return t

    out = {}
    for name, kind, d_in, d_out, extra in specs:
        b = torch.zeros(d_out, device=device)
        if kind == "sdf_first":
            W = torch.zeros(d_out, d_in, device=device)
            W[:, :3] = math.sqrt(2.0) / math.sqrt(d_out) * take("n", d_out * 3, (d_out, 3))
        elif kind in ("sdf_hidden", "sdf_skip"):
            W = math.sqrt(2.0) / math.sqrt(d_out) * take("n", d_out * d_in, (d_out, d_in))
            if kind == "sdf_skip":
                W[:, -extra:] = 0.0
        elif kind == "sdf_last":
            W = math.sqrt(math.pi) / math.sqrt(d_in) + 1e-4 * take("n", d_out * d_in,
                                                                 (d_out, d_in))
            b = torch.full((d_out,), -extra, device=device)
        elif kind == "tiny":
            W = 1e-3 * take("n", d_out * d_in, (d_out, d_in))
        else:
            bound = 1.0 / math.sqrt(d_in)     # kaiming_uniform(a=√5) and the bias bound
            W = take("u", d_out * d_in, (d_out, d_in)) * bound
            b = take("u", d_out, (d_out,)) * bound
        if kind == "linear" or kind == "tiny":
            out[f"{name}.W"] = W
        else:
            out[f"{name}.v"] = W
            out[f"{name}.g"] = torch.linalg.norm(W, dim=1)
        out[f"{name}.b"] = b
    return out


def load_weights(net, weights: dict) -> None:
    """Copy ``weights`` into the network's leaves of the same names; raises
    unless the names and shapes are the same sets."""
    leaves = {k: v for k, v in net.global_leaves().items() if not k.startswith("scene.")}
    if set(leaves) != set(weights):
        raise ValueError(f"weight names differ: network only "
                         f"{sorted(set(leaves) - set(weights))[:5]}, benchmark only "
                         f"{sorted(set(weights) - set(leaves))[:5]}")
    with torch.no_grad():
        for k, p in leaves.items():
            if p.shape != weights[k].shape:
                raise ValueError(f"{k}: network {tuple(p.shape)}, benchmark "
                                 f"{tuple(weights[k].shape)}")
            p.copy_(weights[k])
