"""Network assembly from config + dataset (counterpart of
``recmv_tpu/core/builder.py``): the skinner (cached per scene in the same
``initial_skinner_<type>.npz`` layout the JAX builder writes, with the
canonical body mesh the ① body z-buffer poses), the SDF, deformer and
render nets, the seg3d pyramid and the ``TrainConfig``. On a cold skinner
cache with TCMR 2D joints in the dataset, the beta pre-fit
(``beta_optimizer.smpl_beta_optimizer``) refines ``dataset.params.shape``
and gives the skinner its extra translation first, as
``recmv_tpu/core/builder.py:92-101`` does; the cache records the result.
"""

from __future__ import annotations

import os
import os.path as osp

import numpy as np
import torch

from .. import resolve_device
from ..config.constants import TEMPLATE_GARMENT
from ..models.garment_model import init_model
from ..models.skinner import SkinnerParams, bbox_size, initial_lbs_skinner
from ..models.smpl import get_smpl
from ..ops.seg3d import Seg3dConfig
from .beta_optimizer import smpl_beta_optimizer
from .network import GarmentOptimNetwork, TrainConfig


def apose_from_type(init_pose_type: int = 0) -> np.ndarray:
    """The reference's template A-poses (utils.smpl_tmp_Apose)."""
    pose = np.zeros((24, 3), np.float32)
    legs, arms = {0: (10.0, 45.0), 1: (7.0, 55.0), 2: (15.0, 55.0),
                  3: (15.0, 0.0)}[init_pose_type]
    pose[1] = [0, 0, legs / 180 * np.pi]
    pose[2] = [0, 0, -legs / 180 * np.pi]
    pose[16] = [0, 0, -arms / 180 * np.pi]
    pose[17] = [0, 0, arms / 180 * np.pi]
    return pose


def resolution_pyramids(level: str):
    """MC grid pyramids; each axis satisfies res_{k+1} = 2·res_k − 1."""
    base = {
        "coarse": (15, 21, 9),     # → (225, 321, 129)
        "medium": (19, 25, 13),    # → (289, 385, 193)
        "fine": (21, 27, 15),      # → (321, 417, 225)
        "higher": (33, 33, 33),    # → (513, 513, 513)
        "small": (9, 13, 7),
        "tiny": (7, 9, 5),         # → (13, 17, 9)
    }[level]
    levels = {"coarse": 4, "medium": 4, "fine": 4, "higher": 4, "small": 3, "tiny": 1}[level]
    out = [tuple(base)]
    for _ in range(levels):
        out.append(tuple(2 * r - 1 for r in out[-1]))
    return tuple(out)


def scene_caps(image_size, resolutions) -> dict:
    """The ``TrainConfig`` defaults that follow from the scene: the marching
    cubes' buffers from the finest seg3d level, and a half-resolution mask
    render from 720 px up."""
    Wg, Hg, Dg = resolutions[-1]
    cap_v = 1 << int(np.ceil(np.log2(8 * max(Wg * Hg, Wg * Dg, Hg * Dg))))
    return dict(mc_capacity_v=cap_v, mc_capacity_f=2 * cap_v,
                mask_render_downscale=2 if min(image_size) >= 720 else 1)


_SKIN_FIELDS = ("ws", "Js", "init_pose_inv", "extra_trans", "bbox_center",
                "bbox_extend", "b_min", "b_max")


def build_opt_net(conf, dataset, save_root: str, resolutions=None,
                  skinner_res=(129, 225, 65), train_cfg: TrainConfig | None = None,
                  seed: int = 0, smpl_dir: str | None = None, device=None):
    """Assemble the GarmentOptimNetwork for a scene on ``device`` (the CUDA
    card when none is given)."""
    device = resolve_device(device)
    garment_names = TEMPLATE_GARMENT[conf.get_string("train.garment_type")]
    init_pose_type = conf.get_int("train.skinner_pose_type", 0)

    os.makedirs(save_root, exist_ok=True)
    skin_cache = osp.join(save_root, f"initial_skinner_{init_pose_type}.npz")
    if osp.isfile(skin_cache):
        data = np.load(skin_cache)
        sk = SkinnerParams(**{k: torch.as_tensor(data[k], device=device)
                              for k in _SKIN_FIELDS})
        body_vs, body_fs = data["tmpBodyVs"], data["tmpBodyFs"]
    else:
        model = get_smpl(dataset.gender, smpl_dir)
        init_pose = apose_from_type(init_pose_type)
        extra_trans = None
        if dataset.gt_joints2d is not None:
            betas, extra_trans = smpl_beta_optimizer(model, init_pose, dataset, device=device)
            dataset.params.shape = np.asarray(betas, np.float32).reshape(-1)
        sk, body_vs, body_fs = initial_lbs_skinner(
            model, torch.as_tensor(dataset.params.shape, device=device), init_pose,
            skinner_res, extra_trans=extra_trans)
        fite = osp.join(dataset.root, "diffused_skinning_weights.npy")
        if osp.isfile(fite):
            ws = np.load(fite)
            sk.ws = torch.as_tensor(ws.reshape(ws.shape[-4:]), device=device)
        body_vs, body_fs = body_vs.cpu().numpy(), np.asarray(body_fs)
        np.savez(skin_cache, tmpBodyVs=body_vs, tmpBodyFs=body_fs,
                 **{k: getattr(sk, k).cpu().numpy() for k in _SKIN_FIELDS})

    image_size = (dataset.W, dataset.H)
    params, statics = init_model(torch.Generator().manual_seed(seed), conf, garment_names,
                                 sk, image_size, device=device)
    bmin, bmax = bbox_size(sk)
    seg3d_cfg = Seg3dConfig(b_min=tuple(bmin.tolist()), b_max=tuple(bmax.tolist()),
                            resolutions=tuple(resolutions or resolution_pyramids("coarse")))

    caps = scene_caps(image_size, seg3d_cfg.resolutions)

    def _cap(key, default=None):
        return conf.get_int(f"train.caps.{key}", caps.get(key, default))

    cfg = train_cfg or TrainConfig(
        sample_pix=conf.get_int("train.sample_pix_num", 2048),
        point_radius=conf.get_float("train.coarse.point_render.radius", 0.006),
        remesh_intersect=conf.get_int("train.coarse.point_render.remesh_intersect", 30),
        mc_capacity_v=_cap("mc_capacity_v"),
        mc_capacity_f=_cap("mc_capacity_f"),
        raster_tile=_cap("raster_tile", 32),
        raster_cap_mesh=_cap("raster_cap_mesh", 512),
        raster_cap_points=_cap("raster_cap_points", 768),
        solver_times=_cap("solver_times", 20),
        surface_sample=_cap("surface_sample", 4096),
        zbuf_downscale=_cap("zbuf_downscale", 4),
        seed_downscale=_cap("seed_downscale", 2),
        mask_render_downscale=_cap("mask_render_downscale"),
    )
    loss_conf = conf.get_config("loss_coarse") if "loss_coarse" in conf else conf
    net = GarmentOptimNetwork(conf, dataset, params, statics, seg3d_cfg, cfg, device=device,
                              body_vs=body_vs, body_fs=body_fs)
    net.conf = _MergedConf(conf, loss_conf)
    return net


class _MergedConf:
    """Lookup shim: loss keys resolve in the active loss block, train.*
    keys in the full config."""

    def __init__(self, full, loss):
        self.full = full
        self.loss = loss

    def _get(self, kind: str, path, default):
        src = self.full if path.startswith("train") else self.loss
        for tree in (src, self.full):
            if path in tree:
                return getattr(tree, f"get_{kind}")(path)
        if default is not None:
            return default
        raise KeyError(path)

    def get_float(self, path, default=None):
        return self._get("float", path, default)

    def get_bool(self, path, default=None):
        return self._get("bool", path, default)

    def get_string(self, path, default=None):
        return self._get("string", path, default)

    def set_loss_block(self, loss):
        """Make ``loss`` the active loss block (a stage promotion)."""
        self.loss = loss
