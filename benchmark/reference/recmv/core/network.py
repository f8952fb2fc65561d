"""The per-scene garment network and its training step (counterpart of
``recmv_tpu/core/network.py``).

Ported: ``TrainConfig``, ``MeshState`` and, on ``GarmentOptimNetwork``,
the remesh (``marching_cube_update``: seg3d pyramid + marching cubes on
the device + the capacity trim), the feature curves (``align_fl``), the
① curve branch (``fl_branch_loss``: the visibility gates, the body and
garment z-buffers through K1, the 2D chamfer, the curve regularizers and
the SDF anchoring), the ② mask branch (``pc_branch_loss``), ray seeding
(``find_and_sample_rays``), the surface solve (``solve_surface_points``),
③ ``main_loss`` with the implicit surface adjoint and the curve-aware
term, the optimizers (AdamW over the curves; Adam over the global
parameters with the trainable mask and the lr scale; SGD with momentum
over the mesh vertices) and ``train_step``, which does what the fused
JAX ``step_fn`` does.

The frozen copy keeps the one-device training step and what it calls;
the one-time initialization (``initialize_tmp_sdf`` and its parts), the
checkpoints, the forward-only step, the split over several ranks
(``set_parallel``) and the step's FLOP count are not copied.
"""

from __future__ import annotations

import sys
import time
from dataclasses import dataclass

import numpy as np
import torch
import torch.nn.functional as F

from .. import resolve_device
from ..config.constants import CURVE_AWARE, FL_EXTRACT, ZBUF_THRESHOLD
from ..data.dataset import trainable_mask
from ..models import camera as cam_mod
from ..models.curves import curves_forward, curves_regularization, init_curves
from ..models.deformer import (InverseFlBody, cardinal_rays_from_jac,
                               deformed_normals_from_grads, deformer_jacobian)
from ..models.garment_model import ModelStatics, make_deform_fn, scene_camera, split_deform_conds
from ..models.render_net import render_net_apply
from ..models.sdf import sdf_apply, sdf_gradient, sdf_value, sdf_value_and_gradient
from ..models.skinner import posed_skeleton, skinner_apply
from ..models.translator import translator_apply
from ..ops.marching_cubes import marching_cubes
from ..ops.math3d import dct_null_space, gm_robust_error
from ..ops.rasterizer import composite_points, find_surface_points, rasterize_mesh, screen_with_cam_z
from ..ops.seg3d import Seg3dConfig, final_grid_spacing, seg3d_forward
from . import losses as L
from . import visibility as V
from .surface_ps import attach_implicit_surface, optimize_surface_points, ray_constraint


@dataclass
class MeshState:
    """Explicit meshes of one remesh era, padded to a capacity."""

    body_n: int
    garment_vs: list   # per garment (cap, 3) f32
    garment_fs: list   # per garment (capF, 3) int64
    garment_n: list    # live vertex counts
    garment_fn: list   # live face counts


@dataclass
class TrainConfig:
    """Per-phase knobs resolved from HOCON: the fields of the JAX
    ``TrainConfig`` that the ported phases read."""

    sample_pix: int = 2048
    point_radius: float = 0.006
    remesh_intersect: int = 30
    mc_capacity_v: int = 1 << 18
    mc_capacity_f: int = 1 << 19
    raster_tile: int = 32
    raster_cap_mesh: int = 512
    raster_cap_points: int = 768
    solver_times: int = 20
    surface_sample: int = 4096
    seed_downscale: int = 2
    mask_render_downscale: int = 1
    zbuf_downscale: int = 4       # the ① z-buffers' resolution divisor
    curve_lr: float = 1e-4        # the curves' AdamW learning rate


def _ratio_dict(ratio) -> dict:
    if not isinstance(ratio, dict):
        ratio = {"sdfRatio": 1.0, "deformerRatio": ratio, "renderRatio": 1.0}
    return {k: float(v) for k, v in ratio.items()}


class GarmentOptimNetwork:
    """Host orchestrator of the ported phases."""

    _MASK_KEYS = ("mask", "upper", "bottom", "upper_bottom", "body")

    def __init__(self, conf, dataset, params: dict, statics: ModelStatics,
                 seg3d_cfg: Seg3dConfig, train_cfg: TrainConfig | None = None,
                 sdf_shrink: float = 0.0, device=None, body_vs=None, body_fs=None,
                 large_pose: bool = False):
        """``body_vs`` (V, 3) / ``body_fs`` (F, 3): the canonical body mesh
        that the ① body z-buffer poses (``build_opt_net``'s skinner mesh).
        ``large_pose``: the large-pose stage (OptimGarmentNetwork_LargePose,
        OptimGarmentNetwork_Large_Pose.py:120-474): the SDFs are frozen and
        ① is off, so only the deformer, render net and scene leaves train;
        set the attribute and call ``_init_global_opt`` to switch stages."""
        self.conf = conf
        self.full_conf = conf
        self.dataset = dataset
        self.params = params
        self.statics = statics
        self.device = resolve_device(device)
        self.seg3d_cfg = seg3d_cfg
        self.cfg = train_cfg or TrainConfig()
        self.sdf_shrink = float(sdf_shrink)
        self.mesh: MeshState | None = None
        self.opt_times = 0.0
        self._remeshed_at = -1.0
        self.info = {}
        self.ang_thred = None
        self.isfine = False
        self.dct_null = torch.as_tensor(dct_null_space(10, 30), device=self.device)
        self.tmp_body_vs = (None if body_vs is None else
                            torch.as_tensor(body_vs, dtype=torch.float32, device=self.device))
        self.tmp_body_fs = (None if body_fs is None else
                            torch.as_tensor(np.asarray(body_fs), dtype=torch.int64,
                                            device=self.device))
        self.curve_statics = None     # set with params["curves"] by align_fl
        self.inverse_fl_body = None
        self.curve_opt = None
        self.garment_templates = None       # registered templates (the initialization's)
        self.garment_extract_bboxes = None  # per garment (bmin, bmax) extraction clip box
        self.init_times = {}                # seconds per part of the last initialization
        self.fl_rescued = []                # curves the last curve fit rescued by extent
        self.fl_fit = {}                    # the last initialization's curve fit, {name: (T, s)}
        p = dataset.params

        def t(a):
            return torch.as_tensor(np.asarray(a, np.float32), device=self.device).requires_grad_()

        # the scene tree: leaves the global optimizer updates in place
        self.scene = {
            "poses": t(p.poses), "trans": t(p.trans), "shape": t(p.shape),
            "conds": {k: t(v) for k, v in p.conds.items()},
            "camera": {k: t(v) for k, v in p.camera.items()},
        }
        self._lr = conf.get_float("train.learning_rate", 1e-4) if "train" in conf else 1e-4
        self.large_pose = bool(large_pose)
        self._init_global_opt()
        self.vert_opt = None
        self._lr_scale = 1.0

    # ------------------------------------------------------------------
    # parameters and optimizers
    # ------------------------------------------------------------------

    def global_leaves(self) -> dict:
        """The leaves the global Adam updates, by name: the parameters of
        ``sdf``, ``garment_sdfs``, ``translator`` and ``render``
        (``<net>.<parameter>``) and the scene tree (``scene.<key>`` or
        ``scene.<group>.<key>``)."""
        out = {}
        for net in ("sdf", "garment_sdfs", "translator", "render"):
            for name, prm in self.params[net].named_parameters():
                out[f"{net}.{name}"] = prm
        for k, v in self.scene.items():
            if isinstance(v, dict):
                out.update({f"scene.{k}.{kk}": vv for kk, vv in v.items()})
            else:
                out[f"scene.{k}"] = v
        return out

    def _init_global_opt(self, lr: float | None = None):
        """A fresh Adam(lr, betas (0.9, 0.999), eps 1e-8) (``lr`` defaults to
        ``train.learning_rate``), which equals ``optax.adam(lr)`` as long as
        every leaf gets a gradient tensor at every step (zeros, never
        None): optax moves a zero-gradient leaf by its momentum and counts
        one step for all leaves. The trainable mask follows
        ``trainable_mask``: the network leaves all train, but for the
        ``sdf`` and ``garment_sdfs`` leaves in the large-pose stage, the
        scene leaves as the ``train.opt_*`` config says. A frozen leaf
        gets zero gradients from a fresh optimizer, so its moments stay 0
        and it comes out of every step bit-equal."""
        mask = trainable_mask(self.full_conf, self.dataset.frame_num)
        self._trainable = {}
        for name in self.global_leaves():
            parts = name.split(".")
            if parts[0] != "scene":
                self._trainable[name] = not (self.large_pose
                                             and parts[0] in ("sdf", "garment_sdfs"))
                continue
            m = mask[parts[1]]
            self._trainable[name] = bool(m[parts[2]] if isinstance(m, dict) else m)
        self.global_opt = torch.optim.Adam(list(self.global_leaves().values()),
                                           lr=self._lr if lr is None else lr,
                                           betas=(0.9, 0.999), eps=1e-8)

    def curve_leaves(self) -> list:
        """The curve parameters the curve AdamW updates: [scale, nx_scale]."""
        cp = self.params["curves"]
        return [cp["scale"], cp["nx_scale"]]

    def reset_curve_optimizer(self):
        """AdamW(curve_lr, betas (0.9, 0.999), eps 1e-8, weight decay 1e-4),
        which equals ``optax.adamw(curve_lr)``: optax's default weight
        decay is 1e-4 (torch's 1e-2), and both decay by lr·wd·p from the
        pre-update parameter."""
        self.curve_opt = torch.optim.AdamW(self.curve_leaves(), lr=self.cfg.curve_lr,
                                           betas=(0.9, 0.999), eps=1e-8, weight_decay=1e-4)

    def align_fl(self, aligned_curves: dict, template_curves: dict, rigid: dict):
        """Build the curve parameterization from the aligned curves, the
        template curves and the rigid (t, s) of each curve (name → (S, 3),
        (S, 3), ((3,), ())), with the inverse map to canonical body space;
        curves follow the dataset's order. Sets ``params["curves"]``,
        ``curve_statics``, ``inverse_fl_body`` and a fresh curve optimizer.
        Returns (params, statics)."""
        fl_names = [n for n in self.dataset.fl_names if n in aligned_curves]
        inv = InverseFlBody(fl_names, [template_curves[n] for n in fl_names],
                            [rigid[n][0] for n in fl_names], [rigid[n][1] for n in fl_names],
                            device=self.device)
        cano_smpl = inv([torch.as_tensor(aligned_curves[n], dtype=torch.float32,
                                         device=self.device) for n in fl_names], fl_names)
        params, statics = init_curves([aligned_curves[n] for n in fl_names], cano_smpl, fl_names,
                                      device=self.device)
        self.params["curves"] = params
        self.curve_statics = statics
        self.inverse_fl_body = inv
        self.reset_curve_optimizer()
        return params, statics

    def set_lr_scale(self, scale: float):
        """MultiStepLR counterpart, as in the JAX package: the factor scales
        the gradients fed to the fixed-lr Adam, which makes it a no-op up to
        eps (Adam's update is invariant to a common gradient scale)."""
        self._lr_scale = float(scale)

    def on_phase_change(self):
        """The JAX package drops its compiled phase functions here; the port
        runs eagerly and has nothing to drop."""

    # ------------------------------------------------------------------
    # marching-cube remesh
    # ------------------------------------------------------------------

    def _extract_query(self, net, r, gi):
        """The field the extraction queries: the SDF, intersected for garment
        ``gi`` with its clip box (max(sdf, max(pts − bmax, bmin − pts)))
        where one is recorded. The box keeps far-field zero crossings of a
        short IGR fit out of the mesh; the losses see the raw SDF."""
        boxes = self.garment_extract_bboxes
        if gi is None or not boxes or gi >= len(boxes) or boxes[gi] is None:
            return lambda pts: sdf_value(net, pts, r)
        bmin, bmax = (torch.as_tensor(np.asarray(b, np.float32), device=self.device)
                      for b in boxes[gi])
        return lambda pts: torch.maximum(sdf_value(net, pts, r),
                                         torch.maximum(pts - bmax, bmin - pts).amax(-1))

    def discretize_sdf(self, ratio, balance_value: float = 0.0, include_body: bool = True,
                       max_verts: int | None = None, max_faces: int | None = None,
                       host: bool = False):
        """Seg3d pyramid over each SDF (each garment's within its clip box,
        ``_extract_query``), then marching cubes → per net (verts (V, 3)
        float32, faces (F, 3) int64). By default both run on the network's
        device and the meshes stay there, in the JAX ``discretize_sdf``'s
        vertex order (``ops/marching_cubes``). ``host`` is the JAX
        ``discretize_sdf_host``: the volume goes to the host and through
        ``marching_cubes_host``, and the meshes are numpy arrays in that
        path's order. The buffers are ``mc_capacity_v``/``_f`` unless
        given; a mesh that outgrows them raises."""
        cfg = self.seg3d_cfg
        r = _ratio_dict(ratio)["sdfRatio"]
        spacing, origin = final_grid_spacing(cfg)
        max_verts = max_verts or self.cfg.mc_capacity_v
        max_faces = max_faces or self.cfg.mc_capacity_f
        nets = [(n, self.params["garment_sdfs"][i], i) for i, n in
                enumerate(self.statics.garment_names)]
        if include_body:
            nets = [("body", self.params["sdf"], None)] + nets
        out = []
        for name, net, gi in nets:
            t0 = time.time()
            with torch.no_grad():
                vol = seg3d_forward(self._extract_query(net, r, gi), cfg, device=self.device)
                if host:
                    raise ValueError("the frozen copy has no host marching cubes")
                v, f = marching_cubes(vol, balance_value, origin, spacing,
                                      max_verts=max_verts, max_faces=max_faces)
            del vol
            sys.stderr.write(f"[net] extract {name}: {time.time() - t0:.1f}s nv={len(v)}\n")
            out.append((v, f))
        return out

    def _garment_cap_floor(self) -> int:
        """Vertex-capacity floor: at production grids (≥ 2^24 final cells)
        the expected steady-state surface size, else none."""
        cells = int(np.prod(self.seg3d_cfg.resolutions[-1]))
        if cells < (1 << 24):
            return 0
        est = 1.2 * cells ** (2.0 / 3.0) / max(1, self.statics.garment_size)
        return 1 << int(np.ceil(np.log2(est)))

    def marching_cube_update(self, ratio, higher: bool = False):
        """Extract fresh garment meshes into buffers trimmed to the next
        power of two above 1.15x the live count (at least 2048 and the
        capacity floor, at most the marching cubes' buffers); padding
        vertices are zeros and padding faces (0, 0, 0), which the
        rasterizer skips as degenerate. The body is extracted on the first
        call. ``higher`` is inference's ``--quality higher`` (the JAX
        ``marching_cube_update_host``): the body again too, the host
        marching cubes (that path's vertex order) and its buffers at 2^22
        vertices and 2^23 faces in place of ``mc_capacity_v``/``_f``. The
        vertex SGD and, where curves exist, the curve AdamW start afresh."""
        self._extract_mesh(ratio, higher)
        self._remeshed_at = self.opt_times
        self.reset_vertex_optimizer()
        if self.params.get("curves"):
            self.reset_curve_optimizer()

    def _extract_mesh(self, ratio, higher: bool):
        max_verts, max_faces = ((1 << 22, 1 << 23) if higher else
                                (self.cfg.mc_capacity_v, self.cfg.mc_capacity_f))
        fresh_body = higher or self.mesh is None
        meshes = self.discretize_sdf(ratio, -self.sdf_shrink, include_body=fresh_body,
                                     max_verts=max_verts, max_faces=max_faces, host=higher)
        if fresh_body:
            body, garments = meshes[0], meshes[1:]
            assert len(body[0]) > 0, "tmp sdf vanished"
            body_n = len(body[0])
        else:
            garments, body_n = meshes, self.mesh.body_n
        floor_v = self._garment_cap_floor()

        def cap_of(n, floor=2048):
            c = 1 << int(np.ceil(np.log2(max(n, 1) * 1.15 + 1)))
            return max(c, 2048, floor)

        def pad(v, f):
            cv = min(cap_of(len(v), floor_v), max_verts)
            cf = min(cap_of(len(f), 2 * floor_v), max_faces)
            vp = torch.zeros(cv, 3, dtype=torch.float32, device=self.device)
            vp[:len(v)] = torch.as_tensor(v, device=self.device)
            fp = torch.zeros(cf, 3, dtype=torch.int64, device=self.device)
            fp[:len(f)] = torch.as_tensor(f, device=self.device)
            return vp, fp

        padded = [pad(v, f) for v, f in garments]
        self.mesh = MeshState(
            body_n=body_n,
            garment_vs=[p[0] for p in padded], garment_fs=[p[1] for p in padded],
            garment_n=[len(g[0]) for g in garments], garment_fn=[len(g[1]) for g in garments])

    def reset_vertex_optimizer(self):
        """SGD(0.05, momentum 0.9) over the mesh vertex buffers, which equals
        ``optax.sgd(0.05, momentum=0.9)``; made anew, with no momentum, for
        every new mesh."""
        self.vert_opt = torch.optim.SGD(self.mesh.garment_vs, lr=0.05, momentum=0.9)

    # ------------------------------------------------------------------
    # shared sub-steps
    # ------------------------------------------------------------------

    def _camera(self):
        return scene_camera(self.scene, self.statics.image_size)

    def _deform_garment_verts(self, garment_vs_list, frame_ids, ratio,
                              with_lbs_only: bool = False):
        """Per garment: (N, cap, 3) posed vertices (or (posed, lbs_only)
        pairs with ``with_lbs_only``)."""
        r = _ratio_dict(ratio)
        conds = split_deform_conds(self.scene["conds"]["deformer"][frame_ids],
                                   self.statics.garment_size)
        poses = self.scene["poses"][frame_ids]
        trans = self.scene["trans"][frame_ids]
        N = frame_ids.shape[0]
        out = []
        for gi, vs in enumerate(garment_vs_list):
            deform = make_deform_fn(self.params, conds[gi + 1], poses, trans,
                                    r["deformerRatio"], with_lbs_only=with_lbs_only)
            out.append(deform(vs.expand((N,) + vs.shape)))
        return out

    def _garment_mask_keys(self):
        keys = []
        for gname in self.statics.garment_names:
            if self.statics.garment_size == 1 and bool(
                    self.full_conf.get_bool("train.is_upper_bottom", False)):
                keys.append("upper_bottom")
            elif gname in ("long_pants", "short_pants", "skirt"):
                keys.append("bottom")
            else:
                keys.append("upper")
        return keys

    def device_batch(self, batch: dict) -> dict:
        """Move one step's numpy frame data to the device; masks become
        bool."""
        out = {}
        for k, v in batch.items():
            v = np.asarray(v)
            t = torch.as_tensor(v, device=self.device)
            out[k] = t > 0 if k in self._MASK_KEYS else t
        return out

    # ------------------------------------------------------------------
    # ① curve (feature-line) branch
    # ------------------------------------------------------------------

    @torch.no_grad()
    def _body_zbuf_image(self, frame_ids, cam):
        """The canonical body mesh posed by the skinner to the frames and
        its z-buffer at 1/zbuf_downscale resolution → (zbuf (N, h, w),
        posed (N, V, 3)); no graph."""
        N = frame_ids.shape[0]
        body = self.tmp_body_vs.expand((N,) + self.tmp_body_vs.shape)
        posed = skinner_apply(self.params["skinner"], body, self.scene["poses"][frame_ids],
                              self.scene["trans"][frame_ids])
        zb = V.mesh_zbuf_image(cam, posed, self.tmp_body_fs, self.statics.image_size,
                               tile=self.cfg.raster_tile, cap=self.cfg.raster_cap_mesh,
                               downscale=self.cfg.zbuf_downscale)
        return zb, posed

    def _sample_zbuf(self, zbuf, screen_pts):
        return V.sample_zbuf(zbuf, screen_pts, self.statics.image_size)

    def fl_branch_loss(self, curve_params, frame_ids, fl_pts, fl_masks, ratio,
                       garment_vs_t=None, garment_fs_t=None):
        """①: per garment and curve, the deformed curve's 2D chamfer against
        the gt polyline on the points that pass the visibility gate of
        ``fl_visible_method`` (weighted per curve, averaged over the frames
        with a visible point and the visible points), the curve
        regularizers, and the canonical curves anchored to the garment SDF
        (f32). The gates carry no gradient; the garment z-buffer needs the
        mesh buffers ``garment_vs_t``/``garment_fs_t``. Returns
        (10·sdf + projection, info)."""
        cam = self._camera()
        N = frame_ids.shape[0]
        r = _ratio_dict(ratio)
        cs = self.curve_statics
        image_size = self.statics.image_size
        curves = curves_forward(curve_params, cs)                  # (C, S, 3)
        conds = split_deform_conds(self.scene["conds"]["deformer"][frame_ids],
                                   self.statics.garment_size)
        poses = self.scene["poses"][frame_ids]
        trans = self.scene["trans"][frame_ids]
        method = self.conf.get_string("fl_visible_method", "zbuff")
        thr_scale = float(self.conf.get_float("fl_weight.zbuf_threshold_scale", 1.0))
        fl_w = float(self.conf.get_float("fl_weight.weight", 1.0))
        sdf_w = float(self.conf.get_float("fl_weight.sdf_weight", 60.0))
        need_body = method in ("zbuff", "zbuff_and")
        need_garment = method in ("garment_zbuff", "zbuff_and") and garment_vs_t is not None
        zbuf = self._body_zbuf_image(frame_ids, cam)[0] if need_body else None
        name_to_idx = {n: i for i, n in enumerate(cs.fl_names)}
        ds_col = {n: i for i, n in enumerate(self.dataset.fl_names)}
        info = {}
        proj_loss = 0.0
        fl_sdf_loss = 0.0
        S = curves.shape[1]
        terms = []            # per curve: (garment, weight, chamfer sum, valid frames, points)
        n_curves = []

        for gi, gname in enumerate(self.statics.garment_names):
            fl_names = [n for n in FL_EXTRACT[gname] if n in name_to_idx]
            n_curves.append(len(fl_names))
            gsdf = self.params["garment_sdfs"][gi]
            deform = make_deform_fn(self.params, conds[gi + 1], poses, trans, r["deformerRatio"])
            g_zbuf = None
            if need_garment:
                with torch.no_grad():                # the deformed garment mesh's z-buffer
                    vs = garment_vs_t[gi]
                    g_zbuf = V.mesh_zbuf_image(cam, deform(vs.expand((N,) + vs.shape)),
                                               garment_fs_t[gi], image_size,
                                               tile=self.cfg.raster_tile,
                                               cap=self.cfg.raster_cap_mesh,
                                               downscale=self.cfg.zbuf_downscale)
            for cname in fl_names:
                ci = name_to_idx[cname]
                cv = curves[ci]                                    # (S, 3)
                scr = screen_with_cam_z(cam, deform(cv.expand(N, S, 3)))
                thr = ZBUF_THRESHOLD[cname] * thr_scale
                with torch.no_grad():
                    body_vis = garment_vis = nrm_vis = None
                    if need_body:                    # LBS-posed canonical-SMPL curve
                        def_smpl = skinner_apply(self.params["skinner"],
                                                 cs.cano_smpl_verts[ci].expand(N, S, 3),
                                                 poses, trans)
                        scr_smpl = screen_with_cam_z(cam, def_smpl)
                        body_vis = V.zbuf_visible(scr_smpl[..., 2],
                                                  self._sample_zbuf(zbuf, scr_smpl), thr)
                    if need_garment:                 # the fully deformed curve
                        garment_vis = V.zbuf_visible(scr[..., 2],
                                                     self._sample_zbuf(g_zbuf, scr), thr)
                    if method in ("surface", "sdf"):
                        if method == "surface":
                            nrm = V.outward_curve_normals(cv)
                        else:
                            nrm = sdf_gradient(gsdf, cv, r["sdfRatio"])
                            nrm = nrm / torch.clamp(torch.linalg.norm(nrm, dim=-1, keepdim=True),
                                                    min=1e-9)
                        b_inds = torch.arange(N, device=self.device).repeat_interleave(S)
                        deform_flat = make_deform_fn(self.params, conds[gi + 1], poses, trans,
                                                     r["deformerRatio"], batch_inds=b_inds)
                        posed_n = V.warp_normals_to_posed(
                            deform_flat, cv.expand(N, S, 3).reshape(-1, 3),
                            nrm.expand(N, S, 3).reshape(-1, 3))
                        nrm_vis = V.normal_visible(posed_n.reshape(N, S, 3))
                    visible = V.combine_visibility(method, body_vis, garment_vis, nrm_vis)
                col = ds_col[cname]
                pred_valid = visible & fl_masks[:, col][:, None]  # (N, S)
                gt = fl_pts[:, col]                                # (N, G, 2)
                w_curve = float(self.dataset.fl_weights.get(cname, 1.0))
                d2 = ((scr[:, :, None, :2] - gt[:, None, :, :]) ** 2).sum(-1)   # (N, S, G)
                min_pg = torch.where(pred_valid[..., None], d2, 1e12).amin(1)    # gt → pred
                min_gp = d2.amin(2)                                # pred → gt (all gt)
                any_v = pred_valid.any(1)
                s = (torch.where(pred_valid, min_gp, 0.0).sum(1)
                     + torch.where(any_v, min_pg.sum(1), 0.0))
                chams = torch.where(any_v, s, 0.0)
                valid_frames = (pred_valid.sum(-1) > 0).to(torch.float32).sum()
                n_vis = pred_valid.to(torch.float32).sum()
                terms.append((gi, w_curve, chams.sum(), valid_frames, n_vis))

            cano_fl = torch.cat([curves[name_to_idx[n]] for n in fl_names], 0)
            s_loss = (sdf_value(gsdf, cano_fl, r["sdfRatio"]) + self.sdf_shrink).abs().mean()
            info[f"fl_pc_{gname}_loss_sdf"] = s_loss
            fl_sdf_loss = fl_sdf_loss + s_loss * sdf_w

        g_proj = [0.0] * len(self.statics.garment_names)
        for gi, w_curve, cham_sum, valid_frames, n_vis in terms:
            batch_loss = w_curve * cham_sum / torch.clamp(valid_frames, min=1.0)
            g_proj[gi] = g_proj[gi] + batch_loss / torch.clamp(n_vis, min=1.0)
        for gi, gname in enumerate(self.statics.garment_names):
            g = g_proj[gi] / max(n_curves[gi], 1) * fl_w
            info[f"{gname}_project_loss"] = g
            proj_loss = proj_loss + g

        reg = curves_regularization(curve_params, cs, fl_masks)
        center_w = float(self.conf.get_float("alpha_weight.center_weight", 1.0))
        diff_w = float(self.conf.get_float("alpha_weight.diff_weight", 1.0))
        proj_loss = proj_loss + reg["center_offset"] * center_w + reg["diff_a_loss"] * diff_w
        info["fl_center_loss"] = reg["center_offset"] * center_w
        info["fl_diff_loss"] = reg["diff_a_loss"] * diff_w
        return 10.0 * fl_sdf_loss + 1.0 * proj_loss, info

    # ------------------------------------------------------------------
    # ② mask (point-cloud) branch
    # ------------------------------------------------------------------

    def pc_branch_loss(self, garment_vs, frame_ids, gt_garment_masks, ratio, counts,
                       body_mask=None):
        """Render every garment's soft mask in one point-splat composite
        (section one-hots as feature channels) and score 1 − IoU against
        the radius-dilated gt masks, plus the deformation-consistency
        term. With ``pc_weight.occlusion_gate`` > 0 and a ``body_mask``
        (N, H, W), body pixels outside a dilated gt mask are not scored.
        Returns (loss, (info, masks (N, G, Hm, Wm), deformed verts))."""
        cam = self._camera()
        W, H = self.statics.image_size
        radius = self.cfg.point_radius
        radius_px = L.point_render_radius_px(radius, H, W)
        cw = float(self.conf.get_float("pc_weight.def_consistent.weight", -1.0))
        need_cons = cw > 0
        deformed = self._deform_garment_verts(list(garment_vs), frame_ids, ratio,
                                              with_lbs_only=need_cons)
        if need_cons:
            def_vs = [d[0] for d in deformed]
            lbs_vs = [d[1] for d in deformed]
        else:
            def_vs, lbs_vs = deformed, None
        all_def = torch.cat(def_vs, dim=1)                       # (N, ΣcapV, 3)
        caps = [v.shape[0] for v in garment_vs]
        valid_sections = [torch.arange(cap, device=self.device) < counts[i]
                          for i, cap in enumerate(caps)]
        valid_all = torch.cat(valid_sections)

        ds = max(1, int(self.cfg.mask_render_downscale))
        Hm, Wm = H // ds, W // ds
        gate = float(self.conf.get_float("pc_weight.occlusion_gate", -1.0)) > 0
        mgt_list = []
        for m in gt_garment_masks:
            pooled = L.max_pool_mask(m.to(torch.float32), radius_px)
            keep = None
            if gate and body_mask is not None:
                keep = torch.maximum(pooled, 1.0 - body_mask.to(torch.float32))
            if ds > 1:
                pooled = pooled[..., ::ds, ::ds][..., :Hm, :Wm]
                if keep is not None:
                    keep = keep[..., ::ds, ::ds][..., :Hm, :Wm]
            mgt_list.append((pooled, keep))

        G = len(caps)
        sections = torch.cat([F.one_hot(torch.full((c,), s, device=self.device), G)
                              for s, c in enumerate(caps)]).to(torch.float32)
        scr = screen_with_cam_z(cam, all_def)
        if ds > 1:
            scr = torch.cat([scr[..., :2] / ds, scr[..., 2:]], -1)
        hidden = torch.tensor([0.0, 0.0, -1.0], device=self.device)
        scr = torch.where(valid_all[:, None], scr, hidden)     # padding behind the camera
        img = composite_points(scr, radius, sections, (Hm, Wm), tile=self.cfg.raster_tile,
                               cap=self.cfg.raster_cap_points * ds)
        masks = img.movedim(-1, 1)                               # (N, G, Hm, Wm)

        total = 0.0
        info = {}
        for gi, gname in enumerate(self.statics.garment_names):
            m_loss = L.iou_mask_loss(masks[:, gi], *mgt_list[gi])
            info[f"{gname}_mask_loss"] = m_loss
            total = total + m_loss * float(self.conf.get_float("pc_weight.mask_weight", 1.0))
            if need_cons:
                c = float(self.conf.get_float("pc_weight.def_consistent.c", 0.01))
                off2 = torch.sum((def_vs[gi] - lbs_vs[gi]) ** 2, -1)
                # a (1, cap) mask as in the JAX package: the sum runs over
                # the batch's frames, the count over one frame's live verts
                vmask = valid_sections[gi][None, :]
                if c > 0:
                    cons = L.masked_mean(gm_robust_error(off2, c), vmask)
                else:
                    cons = L.masked_mean(torch.sqrt(off2 + 1e-12), vmask)
                info[f"{gname}_defconst_loss"] = cons
                total = total + cons * cw
        return total, (info, masks, def_vs)

    # ------------------------------------------------------------------
    # ray seeding and the surface solve
    # ------------------------------------------------------------------

    def find_and_sample_rays(self, frame_ids, gt_garment_masks, ratio, garment_vs,
                             garment_fs, def_vs=None, generator=None, uniforms=None):
        """Rasterize the deformed garment meshes at 1/seed_downscale
        resolution, take first-hit canonical seeds at pixels inside the gt
        garment mask, and keep a fixed per-garment budget of them with the
        highest random scores (ties to the lower pixel index). ``uniforms``
        (one (N·Hs·Ws,) tensor per garment) replaces the draws from
        ``generator``.

        Returns per garment a dict of (rays,) arrays: batch_inds, rows,
        cols, init_pts, rays, valid."""
        cam = self._camera()
        N = frame_ids.shape[0]
        W, H = self.statics.image_size
        budget = max(self.cfg.sample_pix // self.statics.garment_size, 1) * N
        s = max(1, int(self.cfg.seed_downscale))
        Hs, Ws = H // s, W // s
        HW = Hs * Ws
        if def_vs is None:
            def_vs = self._deform_garment_verts(list(garment_vs), frame_ids, ratio)
        picks = []
        for gi in range(self.statics.garment_size):
            scr = screen_with_cam_z(cam, def_vs[gi].detach())
            if s > 1:
                scr = torch.cat([scr[..., :2] / s, scr[..., 2:]], -1)
            frag = rasterize_mesh(scr, garment_fs[gi], (Hs, Ws), tile=self.cfg.raster_tile,
                                  cap=self.cfg.raster_cap_mesh)
            hits, pts, _ = find_surface_points(frag, garment_vs[gi], garment_fs[gi])
            gt_s = gt_garment_masks[gi][:, ::s, ::s][:, :Hs, :Ws]
            flat = (hits & (gt_s > 0)).reshape(-1)
            if uniforms is not None:
                u = uniforms[gi].to(self.device)
            else:
                u = torch.rand(N * HW, generator=generator,
                               device=generator.device if generator is not None else self.device
                               ).to(self.device)
            u = u[:flat.shape[0]]
            scores = torch.where(flat, u, -1.0)
            k = min(budget, flat.shape[0])
            idx = torch.sort(scores, descending=True, stable=True).indices[:k]
            picks.append((idx, pts.reshape(-1, 3)[idx], flat[idx]))
        out = []
        for idx, init_pts, valid in picks:
            b = idx // HW
            rr = ((idx % HW) // Ws) * s
            cc = (idx % Ws) * s
            pix = torch.stack([cc.to(torch.float32), rr.to(torch.float32),
                               torch.ones_like(cc, dtype=torch.float32)], -1)
            out.append(dict(batch_inds=b, rows=rr, cols=cc, init_pts=init_pts,
                            rays=cam_mod.view_rays(cam, pix), valid=valid))
        return out

    def solve_surface_points(self, ray_data, frame_ids, ratio):
        """Refine the seeds to surface/ray intersections per garment."""
        cam = self._camera()
        r = _ratio_dict(ratio)
        conds = split_deform_conds(self.scene["conds"]["deformer"][frame_ids],
                                   self.statics.garment_size)
        poses = self.scene["poses"][frame_ids]
        trans = self.scene["trans"][frame_ids]
        origin = cam_mod.cam_pos(cam).detach()
        if self.ang_thred is None:
            self.ang_thred = cam_mod.ang_threshold(cam)
        results = []
        for gi, rd in enumerate(ray_data):
            deform = make_deform_fn(self.params, conds[gi + 1], poses, trans,
                                    r["deformerRatio"], batch_inds=rd["batch_inds"])
            gsdf = self.params["garment_sdfs"][gi]
            pts, conv = optimize_surface_points(
                lambda p, net=gsdf: sdf_value(net, p, r["sdfRatio"]), deform, origin,
                rd["rays"].detach(), rd["init_pts"].detach(), rd["valid"],
                athreshold_deg=self.ang_thred, times=self.cfg.solver_times)
            results.append(dict(pts=pts, conv=conv, **rd))
        return results

    # ------------------------------------------------------------------
    # ③ main loss
    # ------------------------------------------------------------------

    def main_draws(self, solved, garment_vs_t, generator=None) -> list:
        """The random draws of ``main_loss``, per garment: ``vsel``
        (surface_sample,) vertex indices into the buffer, ``local`` and
        ``reg`` standard normals of the sample base's shape, ``glob``
        uniforms in [−1.8, 1.8] (base rows // 6, 3)."""
        dev = generator.device if generator is not None else self.device
        out = []
        for gi, vs in enumerate(garment_vs_t):
            n_base = solved[gi]["pts"].shape[0] + self.cfg.surface_sample
            out.append(dict(
                vsel=torch.randint(0, vs.shape[0], (self.cfg.surface_sample,),
                                   generator=generator, device=dev).to(self.device),
                local=torch.randn(n_base, 3, generator=generator, device=dev).to(self.device),
                glob=(torch.rand(n_base // 6, 3, generator=generator, device=dev) * 3.6
                      - 1.8).to(self.device),
                reg=torch.randn(n_base, 3, generator=generator, device=dev).to(self.device)))
        return out

    def _window_ids(self, fids, Nlen):
        """Global frame indices of the DCT windows (sliding, clamped to the
        video segment bounds)."""
        self.dataset._frame_index_helper = (np.arange(self.dataset.frame_num)
                                            + self.dataset.start_idx)
        win, _ = self.dataset.get_batchframe_data("_frame_index_helper", fids, Nlen)
        return win

    def _curve_aware_target(self):
        """The curve of the curve-aware term, or None where it does not
        fire: ``upper_bottom`` when the curves have one, else the garment
        type's ``CURVE_AWARE`` curve in the fine stage; never with a zero
        ``pc_weight.curve_aware_weight``. Raises where the term would fire
        on curves that ``align_fl`` has not built yet."""
        if float(self.conf.get_float("pc_weight.curve_aware_weight", 0.0)) <= 0:
            return None
        fine = self.dataset.garment_type in CURVE_AWARE and self.isfine
        if self.curve_statics is None:
            if "upper_bottom" in self.dataset.fl_names or fine:
                raise ValueError("the curve-aware term needs the feature curves (align_fl)")
            return None
        if "upper_bottom" in self.curve_statics.fl_names:
            return "upper_bottom"
        return CURVE_AWARE[self.dataset.garment_type] if fine else None

    def curve_aware_draws(self, generator=None) -> dict:
        """The curve-aware term's 50,000 fan-disc draws: ``tri_i`` segment
        indices into the target curve and ``uv`` (50000, 2) uniforms."""
        dev = generator.device if generator is not None else self.device
        S = self.curve_statics.v_dirs.shape[1]
        return dict(tri_i=torch.randint(0, S, (50000,), generator=generator,
                                        device=dev).to(self.device),
                    uv=torch.rand(50000, 2, generator=generator, device=dev).to(self.device))

    def main_loss(self, solved, frame_ids, batch, garment_vs_t, counts, win_ids, ratio,
                  draws, curve_draws=None):
        """③: pc-sdf on the (updated, detached) mesh vertices; the
        curve-aware term where it fires, on the current curves as
        constants; per garment the eikonal term on local and global samples
        around the solved points and vertices, the offset field's rigidity
        prior, and the colour and normal losses on converged rays,
        reattached to the parameters by the implicit surface adjoint; the
        DCT pose prior over ``win_ids``. ``draws`` as ``main_draws`` and
        ``curve_draws`` as ``curve_aware_draws`` make them. Returns
        (total, info)."""
        scene = self.scene
        cam = self._camera()
        N = frame_ids.shape[0]
        r = _ratio_dict(ratio)
        conds = split_deform_conds(scene["conds"]["deformer"][frame_ids],
                                   self.statics.garment_size)
        poses = scene["poses"][frame_ids]
        trans = scene["trans"][frame_ids]
        info = {}
        total = 0.0

        # pc-sdf: anchor the updated explicit vertices to the implicit
        # surface (the SDF with bf16 operands, as the curve-aware term)
        pc_w = float(self.conf.get_float("pc_weight.weight", 60.0))
        for gi, gname in enumerate(self.statics.garment_names):
            vs = garment_vs_t[gi].detach()
            valid = torch.arange(vs.shape[0], device=self.device) < counts[gi]
            sdfv = sdf_value(self.params["garment_sdfs"][gi], vs, r["sdfRatio"],
                             compute_dtype=torch.bfloat16)
            s_loss = L.sdf_shrink_loss(sdfv, self.sdf_shrink, valid)
            info[f"pc_{gname}_loss_sdf"] = s_loss
            total = total + s_loss * pc_w

        # curve-aware hemline disc: the last garment's SDF on the fan disc
        # of the (updated, constant) target curve
        target = self._curve_aware_target()
        if target is not None:
            if curve_draws is None:
                raise ValueError("the curve-aware term needs its draws (curve_aware_draws)")
            with torch.no_grad():
                cv = curves_forward(self.params["curves"], self.curve_statics)[
                    list(self.curve_statics.fl_names).index(target)]
                center = cv.mean(0, keepdim=True)
                tri_i, uv = curve_draws["tri_i"], curve_draws["uv"]
                flip = uv[:, 0] + uv[:, 1] > 1
                u = torch.where(flip, 1 - uv[:, 0], uv[:, 0])
                v = torch.where(flip, 1 - uv[:, 1], uv[:, 1])
                pts = (cv[tri_i] * u[:, None] + cv[(tri_i + 1) % cv.shape[0]] * v[:, None]
                       + center * (1 - u - v)[:, None])
            sdfv = sdf_value(self.params["garment_sdfs"][-1], pts, r["sdfRatio"],
                             compute_dtype=torch.bfloat16)
            ca_loss = (sdfv + self.sdf_shrink).abs().mean()
            info["curve_aware_loss"] = ca_loss
            total = total + ca_loss * float(self.conf.get_float("pc_weight.curve_aware_weight"))

        grad_w = float(self.conf.get_float("grad_weight", 1.0))
        dr_w = float(self.conf.get_float("def_regu.weight", 0.0))
        cw = float(self.conf.get_float("color_weight", 0.0))
        nw = float(self.conf.get_float("normal_weight", 0.0))
        origin = cam_mod.cam_pos(cam)
        for gi, gname in enumerate(self.statics.garment_names):
            sd = solved[gi]
            n_rays = sd["pts"].shape[0]
            dr = draws[gi]
            gsdf = self.params["garment_sdfs"][gi]
            d_cond = conds[gi + 1]
            b_inds = sd["batch_inds"]
            deform = make_deform_fn(self.params, d_cond, poses, trans, r["deformerRatio"],
                                    batch_inds=b_inds)

            # eikonal on local + global samples around the surface points
            vs = garment_vs_t[gi]
            n_vsel, n_glob = dr["vsel"].shape[0], dr["glob"].shape[0]
            vsel = dr["vsel"] % max(int(counts[gi]), 1)
            base = torch.cat([sd["pts"], vs[vsel].detach()], 0)
            nonmnfld = torch.cat([base + 0.01 * dr["local"], dr["glob"]], 0)
            _, grads = sdf_value_and_gradient(gsdf, nonmnfld, r["sdfRatio"])
            n_base = n_rays + n_vsel
            g_loss = L.eikonal_loss(grads, total=n_base + n_glob)
            info[f"{gname}_grad_loss"] = g_loss
            total = total + g_loss * grad_w

            # rigidity of the offset field (frame 0's latent)
            if dr_w > 0:
                reg_base = torch.cat([base, base + 0.01 * dr["reg"]], 0)
                cond0 = d_cond[0]
                Jo = deformer_jacobian(
                    lambda p: translator_apply(self.params["translator"], p,
                                               cond0.expand(p.shape[0], -1),
                                               r["deformerRatio"])[0],
                    reg_base, create_graph=True)
                d_loss = L.def_regularization_loss(
                    Jo, float(self.conf.get_float("def_regu.c", 0.5)),
                    total=2 * n_base)
                info[f"def_{gname}_loss"] = d_loss
                total = total + d_loss * dr_w

            # colour + normal on converged rays, through the implicit adjoint
            rays = sd["rays"]
            TmpPs = attach_implicit_surface(
                sd["pts"], lambda p: sdf_value(gsdf, p, r["sdfRatio"]),
                lambda p: ray_constraint(deform(p), origin, rays))
            _, feat = sdf_apply(gsdf, TmpPs, r["sdfRatio"])
            nx = sdf_gradient(gsdf, TmpPs, r["sdfRatio"], create_graph=True)
            nx = nx / torch.clamp(torch.linalg.norm(nx, dim=-1, keepdim=True), min=1e-9)
            jac = deformer_jacobian(deform, TmpPs, create_graph=True)
            crays, _ = cardinal_rays_from_jac(jac, rays)
            conv = sd["conv"]
            if cw > 0:
                colors = render_net_apply(self.params["render"], TmpPs, nx, crays, feat,
                                          ratio=r["renderRatio"])
                gt_rgb = batch["img"][b_inds, sd["rows"], sd["cols"]]
                c_loss = L.color_loss(colors, gt_rgb, b_inds, conv, N)
                info[f"{gname}_color_loss"] = c_loss
                total = total + cw * c_loss
            if nw > 0 and "normal" in batch:
                gtn = batch["normal"][b_inds, sd["rows"], sd["cols"]]
                cnx, _ = deformed_normals_from_grads(jac.detach(), nx.detach())
                n_loss = L.normal_pullback_loss(
                    gtn, jac, nx, rays, cam.R, b_inds, conv, N,
                    weighted=bool(self.conf.get_bool("weighted_normal", True)),
                    deformed_normals=cnx)
                info[f"{gname}_normal_loss"] = n_loss
                total = total + nw * n_loss

        # DCT temporal prior over the posed joints
        dct_w = float(self.conf.get_float("dct_weight", 0.0))
        if dct_w > 0 and win_ids is not None:
            Nlen = self.dct_null.shape[1]
            flat = win_ids.reshape(-1)
            js = (posed_skeleton(self.params["skinner"], scene["poses"][flat])
                  + scene["trans"][flat][:, None, :])
            d_loss = L.dct_pose_loss(self.dct_null, js.reshape(N, Nlen, 24, 3))
            info["dct_loss"] = d_loss
            total = total + d_loss * dct_w
        return total, info

    # ------------------------------------------------------------------
    # one training step
    # ------------------------------------------------------------------

    def _grads(self, loss, inputs):
        """∂loss/∂inputs with zeros for inputs the loss does not reach."""
        if not (torch.is_tensor(loss) and loss.requires_grad):
            return [torch.zeros_like(x) for x in inputs]
        gs = torch.autograd.grad(loss, inputs, allow_unused=True)
        return [torch.zeros_like(x) if g is None else g for g, x in zip(gs, inputs)]

    def train_step(self, batch, frame_ids, ratio, generator=None, draws=None, timer=None):
        """One optimization step, as the fused JAX ``step_fn``: remesh when
        due; with feature curves, ① forward on the pre-update parameters
        and mesh, backward to the curve leaves alone, and the curves' AdamW
        step; ② mask branch forward and backward to the vertices and the
        global parameters; the vertices' SGD step; ray seeding from the
        pre-update mesh, reusing ②'s (detached) deformation; the surface
        solve; ③ ``main_loss`` forward and backward on the updated vertices
        and curves; one Adam step on the sum of the ② and ③ global
        gradients after the trainable mask and the lr scale.

        In the large-pose stage (``large_pose``) ① is skipped entirely, as
        the JAX step does (``network.py:1503``, ``:1817``): no curve loss, no
        curve step and no ``fl_*`` info; the curve-aware ③ term still follows
        its weight.

        ``batch``: numpy dict from ``dataset.get_batch``; ``frame_ids``
        local indices. Random draws come from ``generator``; ``draws``
        ({"uniforms": per garment seeding uniforms, "main": ``main_draws``'
        list, "curve_aware": ``curve_aware_draws``' dict where the term
        fires}) replaces them. ``timer``, if given, is called with each
        phase name after the phase. Returns (main loss, info); ``info``'s
        ``remeshed`` is 1.0 when the step ran ``marching_cube_update`` and
        0.0 otherwise (the JAX step tells it by a wall time,
        ``t_remesh > 0.5``)."""
        local = np.asarray(frame_ids)
        fids = torch.as_tensor(local + self.dataset.start_idx, device=self.device)
        mark = timer or (lambda name: None)
        r = _ratio_dict(ratio)
        N = len(local)
        remeshed = self.mesh is None or (self.opt_times % self.cfg.remesh_intersect == 0
                                         and self._remeshed_at != self.opt_times)
        if remeshed:
            self.marching_cube_update(r)
        mark("remesh")

        dev = self.device_batch(batch)
        mark("upload")
        info_fl, gnorms = {}, {}
        if not self.large_pose and self.params.get("curves"):
            curve_leaves = self.curve_leaves()
            fl_loss, info_fl = self.fl_branch_loss(
                self.params["curves"], fids, dev["fl_pts"], dev["fl_masks"], r,
                self.mesh.garment_vs, self.mesh.garment_fs)
            g_cur = self._grads(fl_loss, curve_leaves)
            with torch.no_grad():
                for p, g in zip(curve_leaves, g_cur):
                    p.grad = g
                self.curve_opt.step()
                self.curve_opt.zero_grad(set_to_none=True)
                info_fl["fl_loss_total"] = fl_loss
                gnorms["gnorm_fl"] = torch.sqrt(sum(torch.sum(g * g) for g in g_cur))
        mark("fl")

        gt_masks = [dev[k] for k in self._garment_mask_keys()]
        counts = torch.as_tensor(self.mesh.garment_n, device=self.device)
        leaves = self.global_leaves()
        names, prms = list(leaves), list(leaves.values())
        gvs = self.mesh.garment_vs
        gvs_in = [v.detach().requires_grad_(True) for v in gvs]
        body = dev.get("body")
        pc_loss, (info_pc, _, def_vs) = self.pc_branch_loss(
            gvs_in, fids, gt_masks, r, counts, body_mask=body)
        g_all = self._grads(pc_loss, gvs_in + prms)
        g_verts, g_pc = g_all[:len(gvs)], g_all[len(gvs):]
        mark("pc")

        pre_vs = [v.detach().clone() for v in gvs]
        with torch.no_grad():
            for v, g, n in zip(gvs, g_verts, self.mesh.garment_n):
                v.grad = torch.where((torch.arange(v.shape[0], device=v.device) < n)[:, None],
                                     g, 0.0)
            self.vert_opt.step()
            for v in gvs:
                v.grad = None
        mark("verts")

        with torch.no_grad():
            ray_data = self.find_and_sample_rays(
                fids, gt_masks, r, pre_vs, self.mesh.garment_fs,
                def_vs=[d.detach() for d in def_vs], generator=generator,
                uniforms=None if draws is None else draws["uniforms"])
        mark("rays")
        with torch.no_grad():
            solved = self.solve_surface_points(ray_data, fids, r)
        mark("solve")

        win_ids = None
        if (float(self.conf.get_float("dct_weight", 0.0)) > 0
                and self.dataset.frame_num > self.dct_null.shape[1]):
            win_ids = torch.as_tensor(self._window_ids(local, self.dct_null.shape[1]),
                                      device=self.device)
        main_draws = (draws["main"] if draws is not None
                      else self.main_draws(solved, gvs, generator))
        curve_draws = None
        if self._curve_aware_target() is not None:
            curve_draws = (draws["curve_aware"] if draws is not None
                           else self.curve_aware_draws(generator))
        m_loss, info_m = self.main_loss(solved, fids, dev, gvs, counts, win_ids, r, main_draws,
                                        curve_draws)
        g_main = self._grads(m_loss, prms)
        mark("main")

        with torch.no_grad():
            gnorms["gnorm_pc"] = torch.sqrt(sum(torch.sum(g * g) for g in g_pc))
            gnorms["gnorm_main"] = torch.sqrt(sum(torch.sum(g * g) for g in g_main))
            for name, p, a, b in zip(names, prms, g_pc, g_main):
                g = a + b if self._trainable[name] else torch.zeros_like(p)
                p.grad = g * self._lr_scale
            self.global_opt.step()
            self.global_opt.zero_grad(set_to_none=True)
        mark("update")

        terms = {**info_fl, **info_pc, "pc_loss_total": pc_loss, **info_m,
                 "m_loss_total": m_loss}
        for gi, gname in enumerate(self.statics.garment_names):
            terms[f"{gname}_rayConv"] = solved[gi]["conv"].sum()
        vals = torch.stack([torch.as_tensor(v, dtype=torch.float64, device=self.device
                                            ).detach().reshape(()) for v in terms.values()])
        info = dict(zip(terms, vals.tolist()))
        info.update({k: float(v) for k, v in gnorms.items()})
        info["remeshed"] = float(remeshed)
        budget = max(self.cfg.sample_pix // self.statics.garment_size, 1) * N
        for gname in self.statics.garment_names:
            info[f"{gname}_rayBudget"] = float(budget)
        self.info = info
        self.opt_times += 1.0
        return self.info["m_loss_total"], self.info

