"""The model state and the closures the losses and the surface solver use
(counterpart of ``recmv_tpu/models/garment_model.py``).

Parameters are a dict like the JAX pytree: ``sdf`` (body SDF),
``garment_sdfs`` (one per garment), ``translator``, ``render`` (modules)
and ``skinner`` (``SkinnerParams``); ``curves`` (``models/curves.py``)
joins them when the network's ``align_fl`` builds the feature curves.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch
import torch.nn as nn

from .. import resolve_device
from .camera import Camera
from .render_net import init_render_net
from .sdf import init_sdf_net
from .skinner import SkinnerParams, skinner_apply
from .translator import init_translator, translator_apply


@dataclass
class ModelStatics:
    garment_names: tuple
    image_size: tuple  # (W, H)

    @property
    def garment_size(self):
        return len(self.garment_names)


def init_model(gen: torch.Generator, conf, garment_names, skinner: SkinnerParams,
               image_size, device=None):
    """Build (params, statics) from a HOCON config; ``gen`` draws the
    initial weights on the CPU, which then move to ``device`` (the CUDA
    card when none is given)."""
    device = resolve_device(device)
    sdf_multires = conf.get_int("sdf_net.multires")
    g_multires = conf.get_int("garment_sdf_net.multires")
    condlen_render = conf.get_int("render_net.condlen")
    condlen_deform = conf.get_int("mlp_deformer.condlen")
    deform_multires = conf.get_int("mlp_deformer.multires")
    params = {
        "sdf": init_sdf_net(gen, sdf_multires, 0.6, condlen_render).to(device),
        "garment_sdfs": nn.ModuleList(
            [init_sdf_net(gen, g_multires, 0.6, condlen_render)
             for _ in garment_names]).to(device),
        "translator": init_translator(gen, condlen_deform, deform_multires).to(device),
        "render": init_render_net(gen, condlen_render,
                                  conf.get_int("render_net.multires_v"),
                                  conf.get_int("render_net.multires_n")).to(device),
        "skinner": skinner.to(device),
    }
    statics = ModelStatics(garment_names=tuple(garment_names), image_size=tuple(image_size))
    return params, statics


def scene_camera(scene: dict, image_size) -> Camera:
    """Camera from the scene parameter dict."""
    cam = scene["camera"]
    return Camera(focal=cam["focal_length"].reshape(2),
                  principal=cam["princeple_points"].reshape(2),
                  quat=cam["cam2world_coord_quat"].reshape(4),
                  trans=cam["world2cam_coord_trans"].reshape(3),
                  image_size=tuple(image_size))


def split_deform_conds(cond: torch.Tensor, garment_size: int):
    """(N, L·(1+G)) → [(N, L)]: body slice first, then one per garment."""
    L = cond.shape[-1] // (garment_size + 1)
    return [cond[..., i * L:(i + 1) * L] for i in range(garment_size + 1)]


def make_deform_fn(params, d_cond, poses, trans, ratio, batch_inds=None,
                   with_lbs_only=False):
    """Closure: canonical points → posed points for one garment's latent.

    Points are (B, N, 3) with d_cond (B, condlen), or flat (M, 3) with
    ``batch_inds`` (M,). ``with_lbs_only``: also return the un-offset
    points posed with the same blended transforms."""

    def deform(pts):
        if batch_inds is not None:
            off_pts, _ = translator_apply(params["translator"], pts, d_cond[batch_inds], ratio)
            return skinner_apply(params["skinner"], off_pts, poses, trans,
                                 batch_inds=batch_inds,
                                 also_apply=pts if with_lbs_only else None)
        B, Np, _ = pts.shape
        cond_b = d_cond[:, None, :].expand(B, Np, d_cond.shape[-1])
        off_pts, _ = translator_apply(params["translator"], pts, cond_b, ratio)
        return skinner_apply(params["skinner"], off_pts, poses, trans,
                             also_apply=pts if with_lbs_only else None)

    return deform

