"""Parameter bridge between the JAX package's pytrees and the port.

The JAX side is given as nested dicts of numpy arrays (call ``np.asarray``
on each JAX leaf first; this module imports no JAX) and, for the skinner,
any object or dict with the ``SkinnerParams`` fields.

- MLP layers: JAX ``lin{l}`` with ``W`` (in, out), ``b`` — or ``v``
  (in, out), ``g``, ``b`` when weight-normalized — map to the port's
  ``lins[l]`` with matrices transposed to (out, in).
- ``sdf``, ``garment_sdfs``, ``translator``, ``render``: loaded into the
  port's modules in place; exported back as JAX-layout dicts.
- ``skinner``: ``SkinnerParams`` fields, unchanged layout.
- the scene tree (poses, trans, shape, conds, camera): dicts of tensors;
  ``load_scene`` copies a JAX tree into a network's scene leaves in place.
- the garment mesh buffers of a remesh era: ``load_mesh`` gives them to a
  network (with a fresh vertex optimizer), ``mesh_to_numpy`` takes them
  back.
"""

from __future__ import annotations

from dataclasses import fields

import numpy as np
import torch

from .models.skinner import SkinnerParams

NETS = ("sdf", "translator", "render")


def _layer_names(layer) -> tuple:
    return ("v", "g", "b") if layer.weight_norm else ("W", "b")


def load_mlp(module, tree: dict) -> None:
    """Copy a JAX MLP pytree {lin0: {...}, ...} into ``module.lins``."""
    if len(tree) != len(module.lins):
        raise ValueError(f"layer count: JAX {len(tree)} vs port {len(module.lins)}")
    with torch.no_grad():
        for l, layer in enumerate(module.lins):
            src = tree[f"lin{l}"]
            for name in _layer_names(layer):
                a = np.asarray(src[name], np.float32)
                if a.ndim == 2:
                    a = a.T
                dst = getattr(layer, name)
                if tuple(a.shape) != tuple(dst.shape):
                    raise ValueError(f"lin{l}.{name}: JAX {a.shape} vs port {tuple(dst.shape)}")
                dst.copy_(torch.tensor(a))


def export_mlp(module) -> dict:
    """The port's MLP as a JAX-layout pytree of numpy arrays."""
    out = {}
    for l, layer in enumerate(module.lins):
        d = {}
        for name in _layer_names(layer):
            a = getattr(layer, name).detach().cpu().numpy()
            d[name] = a.T.copy() if a.ndim == 2 else a.copy()
        out[f"lin{l}"] = d
    return out


def skinner_from_jax(sk, device=None) -> SkinnerParams:
    get = (lambda k: sk[k]) if isinstance(sk, dict) else (lambda k: getattr(sk, k))
    return SkinnerParams(**{f.name: torch.tensor(np.asarray(get(f.name), np.float32),
                                                    device=device)
                            for f in fields(SkinnerParams)})


def skinner_to_numpy(sk: SkinnerParams) -> dict:
    return {f.name: getattr(sk, f.name).detach().cpu().numpy() for f in fields(SkinnerParams)}


def load_jax_params(params: dict, jax_params: dict) -> None:
    """Load the JAX model pytree (``init_model``'s params) into the port's
    params dict in place: nets, garment SDFs and the skinner."""
    for k in NETS:
        load_mlp(params[k], jax_params[k])
    if len(jax_params["garment_sdfs"]) != len(params["garment_sdfs"]):
        raise ValueError("garment count differs")
    for mod, tree in zip(params["garment_sdfs"], jax_params["garment_sdfs"]):
        load_mlp(mod, tree)
    params["skinner"] = skinner_from_jax(jax_params["skinner"],
                                         device=params["skinner"].ws.device)


def export_params(params: dict) -> dict:
    """The port's params as the JAX pytree layout (numpy leaves)."""
    out = {k: export_mlp(params[k]) for k in NETS}
    out["garment_sdfs"] = tuple(export_mlp(m) for m in params["garment_sdfs"])
    out["skinner"] = skinner_to_numpy(params["skinner"])
    return out


def _map(tree, fn):
    return {k: _map(v, fn) if isinstance(v, dict) else fn(v) for k, v in tree.items()}


def scene_from_jax(scene: dict, device=None) -> dict:
    """JAX scene tree (poses, trans, shape, conds, camera) → tensors."""
    return _map(scene, lambda a: torch.tensor(np.asarray(a, np.float32), device=device))


def scene_to_numpy(scene: dict) -> dict:
    return _map(scene, lambda t: t.detach().cpu().numpy())


def load_scene(scene: dict, tree: dict) -> None:
    """Copy a JAX scene tree into the port's scene tensors in place (the
    optimizer keeps holding the same leaves)."""
    with torch.no_grad():
        for k, v in tree.items():
            if isinstance(v, dict):
                load_scene(scene[k], v)
            else:
                scene[k].copy_(torch.tensor(np.asarray(v, np.float32)))


def load_mesh(net, garment_vs, garment_fs, garment_n, garment_fn) -> None:
    """Install the JAX package's garment mesh buffers (padded vertex and
    face arrays, live counts) in a port network whose mesh exists."""
    net.mesh.garment_vs = [torch.tensor(np.asarray(v, np.float32), device=net.device)
                           for v in garment_vs]
    net.mesh.garment_fs = [torch.tensor(np.asarray(f, np.int64), device=net.device)
                           for f in garment_fs]
    net.mesh.garment_n = [int(n) for n in garment_n]
    net.mesh.garment_fn = [int(n) for n in garment_fn]
    net.reset_vertex_optimizer()


def mesh_to_numpy(net) -> tuple:
    """(vertex buffers, face buffers) of a port network as numpy lists."""
    return ([v.detach().cpu().numpy() for v in net.mesh.garment_vs],
            [f.cpu().numpy() for f in net.mesh.garment_fs])
