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
JAX ``step_fn`` does. ``forward_step`` runs the phases from ② on without
gradients or updates, with ``idr_color_loss`` for the colour block.

The one-time scene initialization (``initialize_tmp_sdf``: the garment
templates, the curve fit ``initialize_fl`` through the body z-buffer,
the Laplacian registration of the templates, ``align_fl`` and the IGR
fits ``igr_fit_sdf``), the extraction clip boxes it sets, and
``save_checkpoint``/``load_checkpoint`` (which also read the JAX
package's checkpoints) are ported too, and for inference the extraction
of ``--quality higher`` (``marching_cube_update(higher=True)``: a fresh
body and the JAX host path's buffers) and the scene's exchange with
``dataset.params`` (``sync_scene_to_dataset``, ``invalidate_scene``).

For the benches, ``step_cost_analysis`` counts the floating-point
operations of a training step.
"""

from __future__ import annotations

import os
import sys
import time
from dataclasses import dataclass

import numpy as np
import torch
import torch.nn.functional as F

from .. import bridge, resolve_device
from ..config.constants import CURVE_AWARE, FL_EXTRACT, INI_FL_SCALE, ZBUF_THRESHOLD
from ..data.dataset import trainable_mask
from ..models import camera as cam_mod
from ..models.curves import CurveStatics, curves_forward, curves_regularization, init_curves
from ..models.deformer import (InverseFlBody, cardinal_rays_from_jac,
                               deformed_normals_from_grads, deformer_jacobian)
from ..models.garment_model import ModelStatics, make_deform_fn, scene_camera, split_deform_conds
from ..models.render_net import render_net_apply
from ..models.sdf import sdf_apply, sdf_gradient, sdf_value, sdf_value_and_gradient
from ..models.skinner import posed_skeleton, skinner_apply
from ..models.translator import translator_apply
from ..native import marching_cubes_host
from ..ops.marching_cubes import marching_cubes
from ..ops.math3d import dct_null_space, gm_robust_error
from ..ops.rasterizer import composite_points, find_surface_points, rasterize_mesh, screen_with_cam_z
from ..ops.seg3d import Seg3dConfig, final_grid_spacing, seg3d_forward
from ..utils.checkpoint import read_checkpoint, write_checkpoint
from ..utils.profiling import count_flops
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
        self.garment_templates = None       # registered templates (initialize_tmp_sdf)
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
                    v, f = marching_cubes_host(vol.cpu().numpy(), balance_value,
                                               origin=np.asarray(origin),
                                               spacing=np.asarray(spacing),
                                               max_verts=max_verts, max_faces=max_faces)
                else:
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
        self._remeshed_at = self.opt_times
        self.reset_vertex_optimizer()
        if self.params.get("curves"):
            self.reset_curve_optimizer()

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

    def sync_scene_to_dataset(self):
        """Copy the scene leaves (``self.scene``, which the optimizer
        updates) into ``dataset.params`` as numpy, for host consumers such
        as the pose smoothing."""
        sp = self.dataset.params
        sc = bridge._map(self.scene, lambda t: t.detach().cpu().numpy().copy())
        sp.poses, sp.trans, sp.shape = sc["poses"], sc["trans"], sc["shape"]
        sp.conds, sp.camera = dict(sc["conds"]), dict(sc["camera"])

    def invalidate_scene(self):
        """After host code changed ``dataset.params``: copy it into the
        scene leaves in place (the JAX package drops its device copy
        here; the port's leaves are the tensors themselves)."""
        sp = self.dataset.params
        bridge.load_scene(self.scene, {"poses": sp.poses, "trans": sp.trans, "shape": sp.shape,
                                       "conds": sp.conds, "camera": sp.camera})

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

        for gi, gname in enumerate(self.statics.garment_names):
            fl_names = [n for n in FL_EXTRACT[gname] if n in name_to_idx]
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
            g_proj = 0.0
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
                batch_loss = w_curve * chams.sum() / torch.clamp(valid_frames, min=1.0)
                n_vis = pred_valid.to(torch.float32).sum()
                g_proj = g_proj + batch_loss / torch.clamp(n_vis, min=1.0)
            g_proj = g_proj / max(len(fl_names), 1) * fl_w
            info[f"{gname}_project_loss"] = g_proj
            proj_loss = proj_loss + g_proj

            cano_fl = torch.cat([curves[name_to_idx[n]] for n in fl_names], 0)
            s_loss = (sdf_value(gsdf, cano_fl, r["sdfRatio"]) + self.sdf_shrink).abs().mean()
            info[f"fl_pc_{gname}_loss_sdf"] = s_loss
            fl_sdf_loss = fl_sdf_loss + s_loss * sdf_w

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
        highest random scores. ``uniforms`` (one (N·Hs·Ws,) tensor per
        garment) replaces the draws from ``generator``.

        Returns per garment a dict of (budget,) arrays: batch_inds, rows,
        cols, init_pts, rays, valid."""
        cam = self._camera()
        N = frame_ids.shape[0]
        W, H = self.statics.image_size
        budget = max(self.cfg.sample_pix // self.statics.garment_size, 1) * N
        s = max(1, int(self.cfg.seed_downscale))
        Hs, Ws = H // s, W // s
        if def_vs is None:
            def_vs = self._deform_garment_verts(list(garment_vs), frame_ids, ratio)
        out = []
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
                u = torch.rand(flat.shape, generator=generator,
                               device=generator.device if generator is not None else self.device
                               ).to(self.device)
            scores = torch.where(flat, u, -1.0)
            k = min(budget, flat.shape[0])
            idx = torch.sort(scores, descending=True, stable=True).indices[:k]
            valid = flat[idx]
            b = idx // (Hs * Ws)
            rr = ((idx % (Hs * Ws)) // Ws) * s
            cc = (idx % Ws) * s
            pix = torch.stack([cc.to(torch.float32), rr.to(torch.float32),
                               torch.ones_like(cc, dtype=torch.float32)], -1)
            out.append(dict(batch_inds=b, rows=rr, cols=cc, init_pts=pts.reshape(-1, 3)[idx],
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
    # ③ IDR colour block of main_loss
    # ------------------------------------------------------------------

    def idr_color_loss(self, solved, frame_ids, batch, ratio):
        """The colour terms of ``main_loss``: the garment SDF's feature and
        normal at the solved points, the view ray pulled back through the
        deformer Jacobian, the render MLP, and the per-frame L1 against the
        gt pixel on converged rays. The implicit adjoint that reattaches
        the solved points to the parameters is the identity here (forward
        only). Returns (weighted loss, info)."""
        r = _ratio_dict(ratio)
        N = frame_ids.shape[0]
        conds = split_deform_conds(self.scene["conds"]["deformer"][frame_ids],
                                   self.statics.garment_size)
        poses = self.scene["poses"][frame_ids]
        trans = self.scene["trans"][frame_ids]
        cw = float(self.conf.get_float("color_weight", 0.0))
        total = 0.0
        info = {}
        for gi, gname in enumerate(self.statics.garment_names):
            sd = solved[gi]
            gsdf = self.params["garment_sdfs"][gi]
            b_inds = sd["batch_inds"]
            deform = make_deform_fn(self.params, conds[gi + 1], poses, trans,
                                    r["deformerRatio"], batch_inds=b_inds)
            pts = sd["pts"]
            _, feat = sdf_apply(gsdf, pts, r["sdfRatio"])
            nx = sdf_gradient(gsdf, pts, r["sdfRatio"])
            nx = nx / torch.clamp(torch.linalg.norm(nx, dim=-1, keepdim=True), min=1e-9)
            jac = deformer_jacobian(deform, pts)
            crays, _ = cardinal_rays_from_jac(jac, sd["rays"])
            if cw > 0:
                colors = render_net_apply(self.params["render"], pts, nx, crays, feat,
                                          ratio=r["renderRatio"])
                gt_rgb = batch["img"][b_inds, sd["rows"], sd["cols"]]
                c_loss = L.color_loss(colors, gt_rgb, b_inds, sd["conv"], N)
                info[f"{gname}_color_loss"] = c_loss
                total = total + cw * c_loss
        return total, info

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

        # pc-sdf: anchor the updated explicit vertices to the implicit surface
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
            dr = draws[gi]
            gsdf = self.params["garment_sdfs"][gi]
            d_cond = conds[gi + 1]
            b_inds = sd["batch_inds"]
            deform = make_deform_fn(self.params, d_cond, poses, trans, r["deformerRatio"],
                                    batch_inds=b_inds)

            # eikonal on local + global samples around the surface points
            vs = garment_vs_t[gi]
            vsel = dr["vsel"] % max(int(counts[gi]), 1)
            base = torch.cat([sd["pts"], vs[vsel].detach()], 0)
            nonmnfld = torch.cat([base + 0.01 * dr["local"], dr["glob"]], 0)
            _, grads = sdf_value_and_gradient(gsdf, nonmnfld, r["sdfRatio"])
            g_loss = L.eikonal_loss(grads)
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
                    Jo, float(self.conf.get_float("def_regu.c", 0.5)))
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
    # the forward of one training step
    # ------------------------------------------------------------------

    def forward_step(self, batch, frame_ids, ratio, generator=None, timer=None):
        """The forward of the fused JAX ``step_fn``: remesh when due, ②
        mask branch, ray seeding from the pre-update mesh (reusing the ②
        deformation), the surface solve, and the ③ colour block; no
        gradients and no optimizer updates. ``batch``: numpy dict from
        ``dataset.get_batch``; ``frame_ids`` local indices. ``timer``, if
        given, is called with each phase name after the phase (a hook for
        device timers). Returns (info, solved)."""
        local = np.asarray(frame_ids)
        fids = torch.as_tensor(local + self.dataset.start_idx, device=self.device)
        mark = timer or (lambda name: None)
        self.info = {}
        with torch.no_grad():
            if self.mesh is None or (self.opt_times % self.cfg.remesh_intersect == 0
                                     and self._remeshed_at != self.opt_times):
                self.marching_cube_update(ratio)
            mark("remesh")
            dev = self.device_batch(batch)
            gt_masks = [dev[k] for k in self._garment_mask_keys()]
            counts = torch.as_tensor(self.mesh.garment_n, device=self.device)
            pc_loss, (info_pc, _, def_vs) = self.pc_branch_loss(
                self.mesh.garment_vs, fids, gt_masks, ratio, counts, body_mask=dev.get("body"))
            mark("pc")
            ray_data = self.find_and_sample_rays(fids, gt_masks, ratio, self.mesh.garment_vs,
                                                 self.mesh.garment_fs, def_vs=def_vs,
                                                 generator=generator)
            mark("rays")
            solved = self.solve_surface_points(ray_data, fids, ratio)
            mark("solve")
            c_loss, info_c = self.idr_color_loss(solved, fids, dev, ratio)
            mark("color")
        info = {**info_pc, **info_c, "pc_loss_total": pc_loss, "color_loss_total": c_loss}
        for gi, gname in enumerate(self.statics.garment_names):
            info[f"{gname}_rayConv"] = solved[gi]["conv"].sum()
            info[f"{gname}_rayValid"] = solved[gi]["valid"].sum()
        self.info = {k: float(v) for k, v in info.items()}
        self.opt_times += 1.0
        return self.info, solved

    # ------------------------------------------------------------------
    # one training step
    # ------------------------------------------------------------------

    def _grads(self, loss, inputs):
        """∂loss/∂inputs with zeros for inputs the loss does not reach."""
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
        info_fl = {}
        if not self.large_pose and self.params.get("curves"):
            curve_leaves = self.curve_leaves()
            fl_loss, info_fl = self.fl_branch_loss(
                self.params["curves"], fids, dev["fl_pts"], dev["fl_masks"], r,
                self.mesh.garment_vs, self.mesh.garment_fs)
            g_cur = torch.autograd.grad(fl_loss, curve_leaves)
            with torch.no_grad():
                for p, g in zip(curve_leaves, g_cur):
                    p.grad = g
                self.curve_opt.step()
                self.curve_opt.zero_grad(set_to_none=True)
                info_fl["fl_loss_total"] = fl_loss
                info_fl["gnorm_fl"] = torch.sqrt(sum(torch.sum(g * g) for g in g_cur))
        mark("fl")

        gt_masks = [dev[k] for k in self._garment_mask_keys()]
        counts = torch.as_tensor(self.mesh.garment_n, device=self.device)
        leaves = self.global_leaves()
        names, prms = list(leaves), list(leaves.values())
        gvs = self.mesh.garment_vs
        gvs_in = [v.detach().requires_grad_(True) for v in gvs]
        pc_loss, (info_pc, _, def_vs) = self.pc_branch_loss(
            gvs_in, fids, gt_masks, r, counts, body_mask=dev.get("body"))
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
            gnorm_pc = torch.sqrt(sum(torch.sum(g * g) for g in g_pc))
            gnorm_main = torch.sqrt(sum(torch.sum(g * g) for g in g_main))
            for name, p, a, b in zip(names, prms, g_pc, g_main):
                g = a + b if self._trainable[name] else torch.zeros_like(p)
                p.grad = g * self._lr_scale
            self.global_opt.step()
            self.global_opt.zero_grad(set_to_none=True)
        mark("update")

        info = {**info_fl, **info_pc, "pc_loss_total": pc_loss, **info_m, "m_loss_total": m_loss,
                "gnorm_pc": gnorm_pc, "gnorm_main": gnorm_main, "remeshed": float(remeshed)}
        budget = max(self.cfg.sample_pix // self.statics.garment_size, 1) * N
        for gi, gname in enumerate(self.statics.garment_names):
            info[f"{gname}_rayConv"] = solved[gi]["conv"].sum()
            info[f"{gname}_rayBudget"] = budget
        self.info = {k: float(v.detach()) if torch.is_tensor(v) else float(v)
                     for k, v in info.items()}
        self.opt_times += 1.0
        return self.info["m_loss_total"], self.info

    def step_cost_analysis(self, step) -> dict:
        """Floating-point operations of ``step()``, a callable that runs one
        training step (the benches pass ``lambda: net.train_step(...)``),
        for the MFU the benches report (the JAX package reads XLA's cost
        analysis of its compiled step): the aten GEMMs of the forward, the
        backward and the double backward as ``FlopCounterMode`` counts them,
        plus the operations K1–K3 do on the arguments the step gave them
        (``utils.profiling.count_flops``), which the counter does not see.
        Returns {"flops", "bytes accessed": None, ...}: no counter of device
        memory traffic covers the eager step."""
        return count_flops(step)

    # ------------------------------------------------------------------
    # one-time initializations
    # ------------------------------------------------------------------

    def igr_fit_sdf(self, which, verts, normals, nepochs: int = 1200, batch_size: int = 5000,
                    lr: float = 5e-3, generator=None, draws=None):
        """IGR fit of one SDF (``which`` = "sdf" or ("garment", i)) to a
        surface point set with optional normals: per epoch a permutation of
        the points, per minibatch one Adam step on |sdf| + 0.1·eikonal +
        normal term (``losses.igr_init_loss``), the eikonal on local
        (σ 0.01) and global (U(−1.8, 1.8), bs // 6 points) samples. The
        learning rate is derated for short budgets (≤ 5e-4 below 32
        epochs, ≤ 2e-3 below 200) and halved every 500 Adam updates; the
        SDF's output bias first shifts by the mean SDF over the first 4,096
        points, so the initial surface crosses the data.

        Random draws come from ``generator``; ``draws`` (one dict per epoch:
        ``perm`` (V,), ``local`` and ``glob`` lists of (bs, 3) normals and
        (bs // 6, 3) uniforms per minibatch) replaces them. Returns the
        last minibatch's loss, read from the device once."""
        net = self.params["sdf"] if which == "sdf" else self.params["garment_sdfs"][which[1]]
        dev = self.device
        verts = torch.as_tensor(np.asarray(verts, np.float32), device=dev)
        normals = (None if normals is None
                   else torch.as_tensor(np.asarray(normals, np.float32), device=dev))
        V = verts.shape[0]
        bs = min(batch_size, V)
        nb = max(V // bs, 1)
        if nepochs < 32:
            lr = min(lr, 5e-4)
        elif nepochs < 200:
            lr = min(lr, 2e-3)
        with torch.no_grad():
            v0 = sdf_value(net, verts[:min(V, 4096)], -1.0)
            net.lins[net.n_layers - 2].b[0] -= v0.mean()
        opt = torch.optim.Adam(net.parameters(), lr=lr, betas=(0.9, 0.999), eps=1e-8)
        gdev = generator.device if generator is not None else dev
        loss = None
        for epoch in range(nepochs):
            d = draws[epoch] if draws is not None else None
            perm = (d["perm"] if d is not None
                    else torch.randperm(V, generator=generator, device=gdev)).to(dev)
            sel = perm[:nb * bs]
            evs = verts[sel].reshape(nb, bs, 3)
            ens = None if normals is None else normals[sel].reshape(nb, bs, 3)
            for b in range(nb):
                for group in opt.param_groups:      # optax.exponential_decay(lr, 500, 0.5)
                    group["lr"] = lr * 0.5 ** ((epoch * nb + b) // 500)
                if d is not None:
                    local, glob = d["local"][b].to(dev), d["glob"][b].to(dev)
                else:
                    local = torch.randn(bs, 3, generator=generator, device=gdev).to(dev)
                    glob = (torch.rand(bs // 6, 3, generator=generator, device=gdev) * 3.6
                            - 1.8).to(dev)
                pts = evs[b]
                vals, grads_s = sdf_value_and_gradient(net, pts, -1.0)
                _, grads_o = sdf_value_and_gradient(net, torch.cat([pts + 0.01 * local, glob]),
                                                    -1.0)
                loss, _ = L.igr_init_loss(vals, grads_s, grads_o,
                                          None if ens is None else ens[b])
                opt.zero_grad(set_to_none=True)
                loss.backward()
                opt.step()
        opt.zero_grad(set_to_none=True)
        return None if loss is None else float(loss.detach())

    def initialize_fl(self, fl_template_curves: dict, n_iters: int = 150, lr: float = 5e-3,
                      cache_path: str | None = None, gate=None):
        """Fit a rigid translation T and a scale s about its centre to each
        template curve (name → (S, 3)) against the gt 2D curves of up to 16
        supervised frames: a trimmed 2D chamfer on the points that a gate
        frozen at the initial configuration calls visible (the posed body's
        z-buffer through K1, 0.01 behind it at most); an upward-only
        closed-form scale rescue from the silhouette widths
        (``_extent_scale``), after which the rescued curves get a T-only
        warm-up and a re-frozen gate; T and s jointly, then s alone for
        max(n//5, 10) steps, each on Adam(lr), s clipped to [0.3, 3].

        ``gate``, a function (T (C, 3), s (C,)) → (N, C·S) bool, replaces
        the body z-buffer gate. ``cache_path`` is the
        ``init_trans_matrix.npz`` cache (T, s), read when it exists and
        written after a fit, in the JAX package's layout. The names of the
        rescued curves go to ``fl_rescued``. Returns (rigid
        {name: (T (3,), s ())}, aligned curves {name: (S, 3)}, fl_names),
        numpy."""
        dev = self.device
        fl_names = [n for n in self.dataset.fl_names if n in fl_template_curves]
        curves0 = torch.as_tensor(np.stack([fl_template_curves[n] for n in fl_names]),
                                  dtype=torch.float32, device=dev)
        centers = curves0.mean(1, keepdim=True)
        C, S, _ = curves0.shape

        def aligned_of(T, s):
            return (curves0 - centers) * s[:, None, None] + centers + T[:, None, :]

        def result(T, s):
            al = aligned_of(T, s).cpu().numpy()
            T, s = T.cpu().numpy(), s.cpu().numpy()
            return (dict(zip(fl_names, zip(T, s))), dict(zip(fl_names, al)), fl_names)

        if cache_path and os.path.isfile(cache_path):
            data = np.load(cache_path)
            return result(torch.as_tensor(data["T"], device=dev),
                          torch.as_tensor(data["s"], device=dev))

        sup = [i for i, x in enumerate(self.dataset.fl_supervised) if x]
        sup = sup[:: max(len(sup) // 16, 1)][:16] or [0]
        batch = self.dataset.get_batch([i - self.dataset.start_idx for i in sup])
        fl_pts = torch.as_tensor(np.asarray(batch["fl_pts"], np.float32), device=dev)
        fl_masks = torch.as_tensor(np.asarray(batch["fl_masks"]), device=dev) > 0
        fids = torch.as_tensor(sup, device=dev)  # scene arrays are indexed globally
        N = len(sup)
        sk = self.params["skinner"]
        with torch.no_grad():
            cam = self._camera()
            poses = self.scene["poses"][fids]
            trans = self.scene["trans"][fids]
            zbuf = self._body_zbuf_image(fids, cam)[0] if gate is None else None
        name_to_col = {n: i for i, n in enumerate(self.dataset.fl_names)}

        def screen(T, s):
            flat = aligned_of(T, s).reshape(1, C * S, 3).expand(N, C * S, 3)
            return screen_with_cam_z(cam, skinner_apply(sk, flat, poses, trans))

        @torch.no_grad()
        def frozen_vis(T, s):
            scr = screen(T, s)
            return (scr[..., 2] - self._sample_zbuf(zbuf, scr)) < 0.01

        gate = gate or frozen_vis

        def proj_loss(T, s, vis):
            scr = screen(T, s)
            loss = 0.0
            for ci, name in enumerate(fl_names):
                col = name_to_col[name]
                sc = scr[:, ci * S:(ci + 1) * S, :2]
                v = vis[:, ci * S:(ci + 1) * S] & fl_masks[:, col][:, None]
                d2 = ((sc[:, :, None, :] - fl_pts[:, col][:, None, :, :]) ** 2).sum(-1)
                m_pg = torch.where(v[:, :, None], d2, 1e12).amin(1)
                m_gp = d2.amin(2)
                anyv = v.any(1)
                # trimmed pred → gt: points beyond 4× the median distance
                # (the gate's off-silhouette tail) do not pull the ring in
                cap = 4.0 * _nanmedian(torch.where(v, m_gp, torch.nan).detach(), dim=1)
                vtrim = v & (m_gp <= torch.where(torch.isnan(cap), 1e12, cap))
                cham = (L.masked_mean(m_gp, vtrim, dim=1)
                        + torch.where(anyv, m_pg.mean(1), 0.0))
                loss = loss + (torch.where(anyv, cham, 0.0).sum()
                               / torch.clamp(anyv.sum(), min=1).to(torch.float32))
            return loss

        @torch.no_grad()
        def extent_scale(T0, s0):
            """Per curve the median over frames of the gt arc's x-extent
            over the projected curve's, where it exceeds 1.3, in [0.5, 2.5];
            else 1."""
            scr = screen(T0, s0)
            mults = []
            for ci, name in enumerate(fl_names):
                col = name_to_col[name]
                px = scr[:, ci * S:(ci + 1) * S, 0]
                gx = fl_pts[:, col, :, 0]
                ext_p = px.amax(1) - px.amin(1)
                ext_g = gx.amax(1) - gx.amin(1)
                ok = fl_masks[:, col] & (ext_p > 1.0) & (ext_g > 1.0)
                ratio = torch.where(ok, ext_g / torch.clamp(ext_p, min=1.0), 1.0)
                med = _nanmedian(torch.where(ok, ratio, torch.nan), dim=0)
                med = torch.where(torch.isnan(med), 1.0, med)
                med = torch.where(med > 1.3, med, 1.0)
                mults.append(torch.clamp(med, 0.5, 2.5))
            return torch.cat(mults)

        def fit(T, s, vis, n, train_T, train_s):
            T = T.clone().requires_grad_(train_T)
            s = s.clone().requires_grad_(train_s)
            leaves = [x for x, on in ((T, train_T), (s, train_s)) if on]
            opt = torch.optim.Adam(leaves, lr=lr, betas=(0.9, 0.999), eps=1e-8)
            for _ in range(n):
                for p, g in zip(leaves, torch.autograd.grad(proj_loss(T, s, vis), leaves)):
                    p.grad = g
                opt.step()
                if train_s:
                    with torch.no_grad():
                        s.clamp_(0.3, 3.0)
            return T.detach(), s.detach()

        T = torch.zeros(C, 3, device=dev)
        s = torch.tensor([INI_FL_SCALE.get(n, 1.5) for n in fl_names], dtype=torch.float32,
                         device=dev)
        mult = extent_scale(T, s)
        rescued = (mult - 1.0).abs() > 1e-6
        self.fl_rescued = [n for n, r in zip(fl_names, rescued.tolist()) if r]
        s = torch.clamp(s * mult, 0.3, 3.0)
        vis0 = gate(T, s)
        vis1 = vis0
        if bool(rescued.any()):
            T_w, _ = fit(T, s, vis0, max(n_iters // 3, 10), True, False)
            T = torch.where(rescued[:, None], T_w, T)
            vis1 = torch.where(rescued[None, :, None], gate(T, s).reshape(N, C, S),
                               vis0.reshape(N, C, S)).reshape(N, C * S)
        T, s = fit(T, s, vis1, n_iters, True, True)
        _, s = fit(T, s, vis1, max(n_iters // 5, 10), False, True)
        if cache_path:
            os.makedirs(os.path.dirname(cache_path), exist_ok=True)
            np.savez(cache_path, T=T.cpu().numpy(), s=s.cpu().numpy())
        return result(T, s)

    def initialize_tmp_sdf(self, nepochs: int = 1200, save_dir: str | None = None,
                           with_normals: bool = True, template_dir: str | None = None,
                           body_normals=None, fl_iters: int = 150, generator=None,
                           igr_draws=None):
        """The one-time scene initialization: garment templates from the
        canonical body (or the ``template_dir`` assets) with
        ``dense_boundary(2)``; their feature lines, merged (the first
        garment's wins); ``initialize_fl``; each template's labelled
        boundary loops matched to the aligned curves and pulled there by
        ``laplacian_deform(constrain_weight=1, smooth=True)``; ``align_fl``;
        the body SDF's IGR fit on the body's vertex normals; per garment
        the closed template, ``max(V, 8192)`` area-weighted surface samples
        (seed = garment index), its IGR fit and its extraction clip box
        (the closed template's bbox grown by 20% of its diagonal); and
        ``initial_sdf.ckpt`` in ``save_dir`` when given. Seconds per part
        go to ``init_times`` (the IGR fits with their epochs and last
        loss), the curve fit's (T, s) per curve to ``fl_fit``.

        ``igr_draws`` (a list: the body fit's draws, then each garment's,
        as ``igr_fit_sdf`` takes them) replaces the IGR fits' draws from
        ``generator``."""
        from ..geometry.laplacian import laplacian_deform
        from ..geometry.matching import match_template_boundaries
        from ..geometry.mesh_utils import sample_mesh_surface, vertex_normals
        from ..models.garment import garment_templates_from_body

        times = self.init_times = {}

        def mark(name, t0, **extra):
            if self.device.type == "cuda":
                torch.cuda.synchronize(self.device)
            times[name] = dict(seconds=time.time() - t0, **extra)

        t0 = time.time()
        body_vs = self.tmp_body_vs.cpu().numpy()
        body_fs = self.tmp_body_fs.cpu().numpy()
        joints = self.params["skinner"].Js.cpu().numpy()
        templates = garment_templates_from_body(self.statics.garment_names, body_vs, body_fs,
                                                joints, template_dir)
        templates = [t.dense_boundary(2) for t in templates]
        template_curves = {}
        for t in templates:
            for name, curve in t.extract_featurelines().items():
                template_curves.setdefault(name, curve)
        mark("templates", t0)

        t0 = time.time()
        cache = os.path.join(save_dir, "fl_init", "init_trans_matrix.npz") if save_dir else None
        rigid, aligned_curves, _ = self.initialize_fl(template_curves, n_iters=fl_iters,
                                                      cache_path=cache)
        self.fl_fit = rigid
        mark("initialize_fl", t0, iters=fl_iters)

        t0 = time.time()
        # float32, as the JAX package solves it: the IGR fit samples the
        # aligned template by face area, so a float64 alignment (1.96e-4
        # from the JAX one on the tube template) moves 63% of the samples
        # and gives another initialized scene (chip_smoke phase 15: 18,082
        # garment vertices after its steps, against 34,036)
        for t in templates:
            cids, targets = match_template_boundaries(t.verts, t.boundary_labels, aligned_curves)
            if len(cids):
                t.verts = laplacian_deform(t.verts, t.faces, cids, targets, constrain_weight=1.0,
                                           smooth=True, device=self.device,
                                           float64=False).cpu().numpy()
        self.garment_templates = templates
        mark("laplacian", t0, verts=[len(t.verts) for t in templates])

        self.align_fl(aligned_curves, template_curves, rigid)

        t0 = time.time()
        if body_normals is None:
            body_normals = vertex_normals(body_vs, body_fs)
        draws = igr_draws or [None] * (1 + len(templates))
        loss = self.igr_fit_sdf("sdf", body_vs, body_normals if with_normals else None, nepochs,
                                generator=generator, draws=draws[0])
        mark("igr body", t0, epochs=nepochs, points=len(body_vs), loss=loss)
        self.garment_extract_bboxes = []
        for gi, t in enumerate(templates):
            t0 = time.time()
            cv, cf, _ = t.close_hole()
            sp, sn = sample_mesh_surface(cv, cf, max(len(cv), 8192), seed=gi)
            loss = self.igr_fit_sdf(("garment", gi), sp, sn if with_normals else None, nepochs,
                                    generator=generator, draws=draws[1 + gi])
            mark(f"igr {t.name}", t0, epochs=nepochs, points=len(sp), loss=loss)
            self.garment_extract_bboxes.append(_template_box(cv))
        if save_dir:
            self.save_checkpoint(os.path.join(save_dir, "initial_sdf.ckpt"), epoch=0)

    # ------------------------------------------------------------------
    # checkpoints
    # ------------------------------------------------------------------

    def save_checkpoint(self, path: str, epoch: int):
        """Pickle the state as the JAX package does: ``epoch``, ``params``
        (the nets and the curve leaves in the JAX layout, numpy),
        ``skinner`` (a dict of arrays), ``scene``, ``opt_times``,
        ``garment_extract_bboxes``, and where they exist the curve statics
        (the leaf list and ``curve_fl_names``) and the registered
        templates."""
        params = bridge.export_params(self.params)
        skinner = params.pop("skinner")
        if self.params.get("curves"):
            params["curves"] = {k: v.detach().cpu().numpy()
                                for k, v in self.params["curves"].items()}
        state = {"epoch": epoch, "params": params, "skinner": skinner,
                 "scene": bridge.scene_to_numpy(self.scene), "opt_times": self.opt_times,
                 "garment_extract_bboxes": self.garment_extract_bboxes}
        if self.curve_statics is not None:
            cs = self.curve_statics
            state["curve_statics"] = [getattr(cs, k).detach().cpu().numpy()
                                      for k in bridge.CURVE_FIELDS]
            state["curve_fl_names"] = tuple(cs.fl_names)
        if self.garment_templates:
            state["garment_templates"] = [
                {"name": t.name, "verts": np.asarray(t.verts), "faces": np.asarray(t.faces),
                 "boundary_labels": {k: np.asarray(v) for k, v in t.boundary_labels.items()}}
                for t in self.garment_templates]
        write_checkpoint(path, state)

    def load_checkpoint(self, path: str) -> int:
        """Restore a checkpoint of either package: the nets, the skinner,
        the scene (leaves and ``dataset.params``), the curves and their
        statics, the templates, the clip boxes (from the templates where an
        older checkpoint has none) and ``opt_times``. The global Adam and
        the curve AdamW start afresh. Returns the saved epoch."""
        from ..models.garment import GarmentTemplate

        state = read_checkpoint(path)
        for k, v in state["params"].items():
            if k == "curves":
                self.params["curves"] = {
                    kk: torch.tensor(np.asarray(vv, np.float32), device=self.device
                                     ).requires_grad_() for kk, vv in v.items()}
            elif k == "garment_sdfs":
                for mod, tree in zip(self.params["garment_sdfs"], v, strict=True):
                    bridge.load_mlp(mod, tree)
            else:
                bridge.load_mlp(self.params[k], v)
        self.params["skinner"] = bridge.skinner_from_jax(state["skinner"], device=self.device)
        sc = state["scene"]
        bridge.load_scene(self.scene, sc)
        sp = self.dataset.params
        sp.poses, sp.trans, sp.shape = sc["poses"], sc["trans"], sc["shape"]
        sp.conds, sp.camera = dict(sc["conds"]), dict(sc["camera"])
        if "curve_statics" in state:
            self.curve_statics = CurveStatics(
                *[torch.tensor(np.asarray(x, np.float32), device=self.device)
                  for x in state["curve_statics"]], fl_names=tuple(state["curve_fl_names"]))
        if "garment_templates" in state:
            self.garment_templates = [GarmentTemplate(d["name"], d["verts"], d["faces"],
                                                      dict(d["boundary_labels"]))
                                      for d in state["garment_templates"]]
        self.opt_times = float(state.get("opt_times", 0.0))
        if state.get("garment_extract_bboxes") is not None:
            self.garment_extract_bboxes = list(state["garment_extract_bboxes"])
        elif self.garment_templates:
            self.garment_extract_bboxes = [_template_box(t.verts) for t in self.garment_templates]
        self._init_global_opt()
        if self.params.get("curves"):
            self.reset_curve_optimizer()
        return state["epoch"]


def _nanmedian(x, dim: int):
    """``jnp.nanmedian`` along ``dim`` (kept): the mean of the two middle
    values of an even count (``torch.nanmedian`` takes the lower one); NaN
    where every value is NaN."""
    return torch.nanquantile(x, 0.5, dim=dim, keepdim=True)


def _template_box(verts) -> tuple:
    """Extraction clip box of a garment: the bbox of its (closed) template
    grown by 20% of its diagonal → (bmin, bmax) float32."""
    v = np.asarray(verts)
    lo, hi = v.min(0), v.max(0)
    m = 0.2 * float(np.linalg.norm(hi - lo))
    return (lo - m).astype(np.float32), (hi + m).astype(np.float32)
