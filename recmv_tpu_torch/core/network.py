"""The per-scene garment network, forward of the training step
(counterpart of ``recmv_tpu/core/network.py``).

Ported: ``TrainConfig``, ``MeshState`` and, on ``GarmentOptimNetwork``,
the remesh (``marching_cube_update``: seg3d pyramid + host marching cubes
+ the capacity trim), the ② mask branch (``pc_branch_loss``), ray seeding
(``find_and_sample_rays``), the surface solve (``solve_surface_points``)
and the IDR colour block of ③ ``main_loss`` (``idr_color_loss``).
``forward_step`` chains them as the fused JAX ``step_fn`` does, without
the optimizer updates.

Not ported yet: the ① curve branch, the other ③ terms, the optimizers
and ``train_step``, the initializations and checkpoints.
"""

from __future__ import annotations

import sys
import time
from dataclasses import dataclass

import numpy as np
import torch
import torch.nn.functional as F

from ..models import camera as cam_mod
from ..models.deformer import cardinal_rays_from_jac, deformer_jacobian
from ..models.garment_model import ModelStatics, make_deform_fn, scene_camera, split_deform_conds
from ..models.render_net import render_net_apply
from ..models.sdf import sdf_apply, sdf_gradient, sdf_value
from ..native import marching_cubes_host
from ..ops.math3d import gm_robust_error
from ..ops.rasterizer import composite_points, find_surface_points, rasterize_mesh, screen_with_cam_z
from ..ops.seg3d import Seg3dConfig, final_grid_spacing, seg3d_forward
from . import losses as L
from .surface_ps import optimize_surface_points


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
        p = dataset.params

        def t(a):
            return torch.as_tensor(np.asarray(a, np.float32), device=self.device)

        self.scene = {
            "poses": t(p.poses), "trans": t(p.trans), "shape": t(p.shape),
            "conds": {k: t(v) for k, v in p.conds.items()},
            "camera": {k: t(v) for k, v in p.camera.items()},
        }

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
