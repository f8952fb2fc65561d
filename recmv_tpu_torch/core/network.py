"""The per-scene garment network and its training step (counterpart of
``recmv_tpu/core/network.py``).

Ported: ``TrainConfig``, ``MeshState`` and, on ``GarmentOptimNetwork``,
the remesh (``marching_cube_update``: seg3d pyramid + host marching cubes
+ the capacity trim), the ② mask branch (``pc_branch_loss``), ray seeding
(``find_and_sample_rays``), the surface solve (``solve_surface_points``),
③ ``main_loss`` with the implicit surface adjoint, the optimizers (Adam
over the global parameters with the trainable mask and the lr scale, SGD
with momentum over the mesh vertices) and ``train_step``, which does what
the fused JAX ``step_fn`` does for a scene without feature curves.
``forward_step`` runs the same phases without gradients or updates, with
``idr_color_loss`` for the colour block.

Not ported yet: the ① curve branch and the curve-aware ③ term (which
raises when its gate names a curve), the initializations, checkpoints
and the large-pose stage.
"""

from __future__ import annotations

import sys
import time
from dataclasses import dataclass

import numpy as np
import torch
import torch.nn.functional as F

from ..config.constants import CURVE_AWARE
from ..data.dataset import trainable_mask
from ..models import camera as cam_mod
from ..models.deformer import (cardinal_rays_from_jac, deformed_normals_from_grads,
                               deformer_jacobian)
from ..models.garment_model import ModelStatics, make_deform_fn, scene_camera, split_deform_conds
from ..models.render_net import render_net_apply
from ..models.sdf import sdf_apply, sdf_gradient, sdf_value, sdf_value_and_gradient
from ..models.skinner import posed_skeleton
from ..models.translator import translator_apply
from ..native import marching_cubes_host
from ..ops.math3d import dct_null_space, gm_robust_error
from ..ops.rasterizer import composite_points, find_surface_points, rasterize_mesh, screen_with_cam_z
from ..ops.seg3d import Seg3dConfig, final_grid_spacing, seg3d_forward
from . import losses as L
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


def _ratio_dict(ratio) -> dict:
    if not isinstance(ratio, dict):
        ratio = {"sdfRatio": 1.0, "deformerRatio": ratio, "renderRatio": 1.0}
    return {k: float(v) for k, v in ratio.items()}


class GarmentOptimNetwork:
    """Host orchestrator of the ported phases."""

    _MASK_KEYS = ("mask", "upper", "bottom", "upper_bottom", "body")

    def __init__(self, conf, dataset, params: dict, statics: ModelStatics,
                 seg3d_cfg: Seg3dConfig, train_cfg: TrainConfig | None = None,
                 sdf_shrink: float = 0.0, device=None):
        self.conf = conf
        self.full_conf = conf
        self.dataset = dataset
        self.params = params
        self.statics = statics
        self.device = torch.device(device) if device is not None else torch.device("cpu")
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
        p = dataset.params

        def t(a):
            return torch.as_tensor(np.asarray(a, np.float32), device=self.device).requires_grad_()

        # the scene tree: leaves the global optimizer updates in place
        self.scene = {
            "poses": t(p.poses), "trans": t(p.trans), "shape": t(p.shape),
            "conds": {k: t(v) for k, v in p.conds.items()},
            "camera": {k: t(v) for k, v in p.camera.items()},
        }
        lr = conf.get_float("train.learning_rate", 1e-4) if "train" in conf else 1e-4
        self._init_global_opt(lr)
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

    def _init_global_opt(self, lr: float):
        """Adam(lr, betas (0.9, 0.999), eps 1e-8), which equals
        ``optax.adam(lr)`` as long as every leaf gets a gradient tensor at
        every step (zeros, never None): optax moves a zero-gradient leaf by
        its momentum and counts one step for all leaves. The trainable
        mask follows ``trainable_mask``: the network leaves all train, the
        scene leaves as the ``train.opt_*`` config says."""
        mask = trainable_mask(self.full_conf, self.dataset.frame_num)
        self._trainable = {}
        for name in self.global_leaves():
            parts = name.split(".")
            if parts[0] != "scene":
                self._trainable[name] = True
                continue
            m = mask[parts[1]]
            self._trainable[name] = bool(m[parts[2]] if isinstance(m, dict) else m)
        self.global_opt = torch.optim.Adam(list(self.global_leaves().values()), lr=lr,
                                           betas=(0.9, 0.999), eps=1e-8)

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

    def discretize_sdf(self, ratio, balance_value: float = 0.0, include_body: bool = True):
        """Seg3d pyramid over each SDF + host marching cubes → per net
        (verts (V, 3) f32, faces (F, 3) int64) numpy meshes."""
        cfg = self.seg3d_cfg
        r = _ratio_dict(ratio)["sdfRatio"]
        spacing, origin = final_grid_spacing(cfg)
        nets = [(n, self.params["garment_sdfs"][i]) for i, n in
                enumerate(self.statics.garment_names)]
        if include_body:
            nets = [("body", self.params["sdf"])] + nets
        out = []
        for name, net in nets:
            t0 = time.time()
            with torch.no_grad():
                vol = seg3d_forward(lambda pts: sdf_value(net, pts, r), cfg,
                                    device=self.device)
            v, f = marching_cubes_host(vol.cpu().numpy(), balance_value,
                                       origin=np.asarray(origin), spacing=np.asarray(spacing),
                                       max_verts=self.cfg.mc_capacity_v,
                                       max_faces=self.cfg.mc_capacity_f)
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

    def marching_cube_update(self, ratio):
        """Extract fresh garment meshes into buffers trimmed to the next
        power of two above 1.15x the live count (at least 2048 and the
        capacity floor); padding vertices are zeros and padding faces
        (0, 0, 0), which the rasterizer skips as degenerate."""
        fresh_body = self.mesh is None
        meshes = self.discretize_sdf(ratio, -self.sdf_shrink, include_body=fresh_body)
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
            cv = min(cap_of(len(v), floor_v), self.cfg.mc_capacity_v)
            cf = min(cap_of(len(f), 2 * floor_v), self.cfg.mc_capacity_f)
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
                vmask = valid_sections[gi][None, :].expand_as(off2)
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
                               device=generator.device if generator is not None else "cpu"
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

    def main_loss(self, solved, frame_ids, batch, garment_vs_t, counts, win_ids, ratio,
                  draws):
        """③: pc-sdf on the (updated, detached) mesh vertices; per garment
        the eikonal term on local and global samples around the solved
        points and vertices, the offset field's rigidity prior, and the
        colour and normal losses on converged rays, reattached to the
        parameters by the implicit surface adjoint; the DCT pose prior over
        ``win_ids``. ``draws`` as ``main_draws`` makes them. Returns
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
            sdfv = sdf_value(self.params["garment_sdfs"][gi], vs, r["sdfRatio"])
            s_loss = L.sdf_shrink_loss(sdfv, self.sdf_shrink, valid)
            info[f"pc_{gname}_loss_sdf"] = s_loss
            total = total + s_loss * pc_w

        # the curve-aware hemline disc loss needs the feature curves
        ca_w = float(self.conf.get_float("pc_weight.curve_aware_weight", 0.0))
        if ca_w > 0 and ("upper_bottom" in self.dataset.fl_names
                         or (self.dataset.garment_type in CURVE_AWARE and self.isfine)):
            raise NotImplementedError("the curve-aware loss needs the feature curves, "
                                      "which are not ported")

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
        """One optimization step, as the fused JAX ``step_fn`` without
        feature curves: remesh when due; ② mask branch forward and backward
        to the vertices and the global parameters; the vertices' SGD step;
        ray seeding from the pre-update mesh, reusing ②'s (detached)
        deformation; the surface solve; ③ ``main_loss`` forward and
        backward on the updated vertices; one Adam step on the sum of the
        two global gradients after the trainable mask and the lr scale.

        ``batch``: numpy dict from ``dataset.get_batch``; ``frame_ids``
        local indices. Random draws come from ``generator``; ``draws``
        ({"uniforms": per garment seeding uniforms, "main": ``main_draws``'
        list}) replaces them. ``timer``, if given, is called with each
        phase name after the phase. Returns (main loss, info)."""
        local = np.asarray(frame_ids)
        fids = torch.as_tensor(local + self.dataset.start_idx, device=self.device)
        mark = timer or (lambda name: None)
        r = _ratio_dict(ratio)
        N = len(local)
        if self.mesh is None or (self.opt_times % self.cfg.remesh_intersect == 0
                                 and self._remeshed_at != self.opt_times):
            self.marching_cube_update(r)
        mark("remesh")

        dev = self.device_batch(batch)
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
        m_loss, info_m = self.main_loss(solved, fids, dev, gvs, counts, win_ids, r, main_draws)
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

        info = {**info_pc, "pc_loss_total": pc_loss, **info_m, "m_loss_total": m_loss,
                "gnorm_pc": gnorm_pc, "gnorm_main": gnorm_main}
        budget = max(self.cfg.sample_pix // self.statics.garment_size, 1) * N
        for gi, gname in enumerate(self.statics.garment_names):
            info[f"{gname}_rayConv"] = solved[gi]["conv"].sum()
            info[f"{gname}_rayBudget"] = budget
        self.info = {k: float(v.detach()) if torch.is_tensor(v) else float(v)
                     for k, v in info.items()}
        self.opt_times += 1.0
        return self.info["m_loss_total"], self.info
