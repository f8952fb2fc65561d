"""Inference: garment registration, per-frame exports and animation
(counterpart of ``recmv_tpu/core/inference.py``; the reference's
OptimGarmentNetwork.py, SURVEY §3.5).

- ``register_garment`` (:2316-2514): register an open garment template
  onto the closed marching-cube surface: Laplacian curve alignment, the
  multi-view visible-vertex scan (``visible_vertex_mask``, twelve 512²
  z-buffers in one launch of kernel K1), NRICP coarse, isotropic remesh
  with subdivision, NRICP refine; ``GarmentInference.ensure_registration``
  caches it per garment and sews the waist of two-garment subjects.
- ``GarmentInference.infer_garment`` (:2950): per-frame posed garments and
  the five export families (``meshs``, ``render``, ``def1meshs``,
  ``colors``, ``smpl_meshs``); every render and the colours' fragments
  are K1 z-buffers at the scene's size.
- ``infer_garment_fl`` (:2861): tube meshes of the feature curves.
- ``infer_garment_animation`` (:2729): the registered garments driven by a
  novel pose sequence (averaged latents, given translations).
- ``offset_filter`` (:2519) and ``one_euro_smooth``/``smooth_scene_poses``
  (``smooth_trans``, :2567).

Everything runs on the network's device under ``torch.no_grad()``; the
colour pass differentiates inside the surface solve (``SurfaceSolver``),
``sdf_gradient`` and ``deformer_jacobian``, which take their gradients
under ``torch.enable_grad()`` themselves and return tensors with no graph.
PNGs are written with ``data/png.imwrite`` and hold the RGB images (it
takes BGR, as OpenCV does). A build or load failure of the native
remesher raises; only its buffer overflow skips the remesh, as in the
JAX package, and says so on stderr.
"""

from __future__ import annotations

import os
import os.path as osp
import sys
import time

import numpy as np
import torch

from .. import resolve_device
from ..config.constants import FL_EXTRACT, RENDER_COLORS
from ..data.png import imwrite
from ..geometry.laplacian import laplacian_deform
from ..geometry.mesh_utils import boundary_loops, largest_component, vertex_normals
from ..geometry.nricp import NricpConfig, nricp_fit
from ..models import camera as cam_mod
from ..models.curves import curve_to_tube_mesh, curves_forward
from ..models.garment_model import make_deform_fn, split_deform_conds
from ..models.skinner import skinner_apply
from ..ops.rasterizer import (find_surface_points, phong_render, rasterize_mesh,
                              screen_with_cam_z)
from ..utils.io import load_obj, save_obj
from .network import _ratio_dict


def _sync(device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _f32(a, device):
    return torch.as_tensor(np.array(a, np.float32), device=device)


@torch.no_grad()
def visible_vertex_mask(verts, faces, n_views: int = 12, image: int = 512,
                        radius: float = 3.0, device=None) -> np.ndarray:
    """Multi-view visibility scan (surface_finder,
    OptimGarmentNetwork.py:2321-2387): rasterize the mesh from ``n_views``
    turntable cameras (one batched z-buffer, tile 32, cap 512) and mark the
    vertices of every face seen in front → (V,) bool numpy. Runs on
    ``device`` (the CUDA card when none is given)."""
    device = resolve_device(device)
    verts = np.asarray(verts, np.float32)
    faces_t = torch.as_tensor(np.array(faces, np.int64), device=device)
    shifted = _f32(verts - verts.mean(0), device)
    scr = []
    for k in range(n_views):
        ang = 2 * np.pi * k / n_views
        # a camera on a circle in the xz plane looking at the centre
        quat = np.asarray([np.cos((ang + np.pi) / 2), 0.0, np.sin((ang + np.pi) / 2), 0.0],
                          np.float32)
        cam = cam_mod.Camera(focal=_f32([image * 1.2, image * 1.2], device),
                             principal=_f32([image / 2.0, image / 2.0], device),
                             quat=_f32(quat, device), trans=_f32([0.0, 0.0, radius], device),
                             image_size=(image, image))
        scr.append(screen_with_cam_z(cam, shifted))
    frag = rasterize_mesh(torch.stack(scr), faces_t, (image, image), tile=32, cap=512)
    fid = frag.pix_to_face[..., 0]
    hit_faces = torch.unique(fid[fid >= 0]).to(torch.int64)
    vis = torch.zeros(len(verts), dtype=torch.bool, device=device)
    vis[faces_t[hit_faces].reshape(-1)] = True
    return vis.cpu().numpy()


def relabel_boundaries_after_remesh(new_verts, new_faces, old_verts,
                                    old_boundary_labels: dict) -> dict:
    """Labelled boundary loops of a remeshed garment by KNN label transfer
    from the old labelled boundary vertices (the reference's post-remesh
    rebuild, garment_structure.py:440-460), as a one-to-one optimal
    assignment of labels to loops (a majority vote can give two loops one
    label and drop the other)."""
    loops = boundary_loops(np.asarray(new_faces))
    if not old_boundary_labels or not loops:
        return {}
    names = list(old_boundary_labels.keys())
    old_pts = [np.asarray(old_verts)[np.asarray(old_boundary_labels[n])] for n in names]
    cost = np.full((len(names), len(loops)), np.inf)
    for i, p in enumerate(old_pts):
        for j, loop in enumerate(loops):
            lv = np.asarray(new_verts)[loop]
            cost[i, j] = np.mean(np.min(np.linalg.norm(lv[:, None] - p[None], axis=-1),
                                        axis=1))
    from scipy.optimize import linear_sum_assignment

    ri, ci = linear_sum_assignment(cost)
    return {names[i]: loops[j] for i, j in zip(ri, ci)}


def remesh_registered(verts, faces, boundary_labels: dict, target_frac: float = 0.02,
                      subdivide: bool = True):
    """Isotropic remesh + midpoint subdivision between the NRICP passes
    (remesh_garment_mesh, OptimGarmentNetwork.py:2445-2481), with the
    native remesher (boundary vertices pinned) → (verts, faces, relabelled
    loops). A remesh that overflows its buffers is skipped (logged)."""
    from ..geometry.mesh_utils import subdivide_faces
    from ..native import isotropic_remesh

    v = np.asarray(verts, np.float32)
    f = np.asarray(faces, np.int64)
    diag = float(np.linalg.norm(v.max(0) - v.min(0)))
    try:
        nv, nf = isotropic_remesh(v, f, target_len=target_frac * diag, iters=3)
    except ValueError as e:                # overflow: keep the mesh, as the JAX package
        sys.stderr.write(f"[inference] remesh skipped: {e}\n")
        nv, nf = v, f
    if subdivide:
        nv, nf = subdivide_faces(nv, nf, np.arange(len(nf)))[:2]
    labels = relabel_boundaries_after_remesh(nv, nf, v, boundary_labels)
    return nv.astype(np.float32), np.asarray(nf, np.int64), labels


def register_garment(template, mc_verts, mc_faces, curves_by_name: dict,
                     save_path: str | None = None, nricp_cfg: NricpConfig | None = None,
                     refine_cfg: NricpConfig | None = None, remesh: bool = True,
                     device=None, times: dict | None = None):
    """Register one open template to the closed MC surface
    (OptimGarmentNetwork.py:2445-2481): (1) Laplacian-align the template's
    boundary loops to the optimized curves with optimal-assignment
    correspondences, (2) NRICP coarse onto the visible MC vertices,
    (3) isotropic remesh (+ subdivision), (4) NRICP refine. Runs on
    ``device`` (the CUDA card when none is given); ``times`` receives the
    seconds of each stage. Returns the registered open mesh (verts, faces,
    boundary labels)."""
    from ..geometry.matching import match_template_boundaries

    device = resolve_device(device)
    times = {} if times is None else times
    t_verts = np.asarray(template.verts, np.float32)
    t_faces = np.asarray(template.faces, np.int64)
    labels = dict(template.boundary_labels)

    t0 = time.time()
    cids, targets = match_template_boundaries(t_verts, labels, curves_by_name)
    if len(cids):
        t_verts = laplacian_deform(t_verts, t_faces, cids, targets, constrain_weight=1.0,
                                   smooth=True, device=device).cpu().numpy()
    times["laplacian"] = time.time() - t0

    t0 = time.time()
    vis = visible_vertex_mask(mc_verts, mc_faces, device=device)
    times["visibility"] = time.time() - t0
    tgt_normals = vertex_normals(np.asarray(mc_verts), np.asarray(mc_faces))

    def static_of(lbl):
        return np.concatenate([np.asarray(x) for x in lbl.values()]) if lbl else None

    t0 = time.time()
    # coarse pass (reference fl_fit_registry: 200 epochs, stiffness 50 →
    # 0.1 at 8 milestones, Laplacian 250, normal-cosine gate 0.3)
    cfg = nricp_cfg or NricpConfig(
        epochs=200, inner_iter=10, first_inner_iter=60,
        stiffness_weight=(50.0, 20.0, 5.0, 2.0, 0.8, 0.5, 0.35, 0.2, 0.1),
        milestones=(50, 80, 100, 110, 120, 130, 140, 150),
        laplacian_weight=(250.0,) * 9, threshold=0.3, lr=1e-3, max_dist=0.04)
    out_v = nricp_fit(t_verts, t_faces, np.asarray(mc_verts), tgt_normals, target_mask=vis,
                      static_ids=static_of(labels), cfg=cfg, device=device)
    times["nricp_coarse"] = time.time() - t0
    out_f = t_faces

    t0 = time.time()
    if remesh:
        out_v, out_f, labels = remesh_registered(out_v, out_f, labels)
    times["remesh"] = time.time() - t0

    t0 = time.time()
    # refine pass (fl_refine_registry: 100 epochs, stiffness 2 → 0.1,
    # milestones 10/20/30/40/80, gate 0.5)
    rcfg = refine_cfg or NricpConfig(
        epochs=100, inner_iter=10, first_inner_iter=30,
        stiffness_weight=(2.0, 0.8, 0.5, 0.35, 0.2, 0.1), milestones=(10, 20, 30, 40, 80),
        laplacian_weight=(250.0,) * 6, threshold=0.5, lr=5e-4, max_dist=0.04)
    out_v = nricp_fit(out_v, out_f, np.asarray(mc_verts), tgt_normals, target_mask=vis,
                      static_ids=static_of(labels), cfg=rcfg, device=device)
    times["nricp_refine"] = time.time() - t0
    if save_path:
        save_obj(save_path, out_v, out_f)
    return out_v.astype(np.float32), out_f, labels


def _imwrite(path: str, rgb_u8) -> None:
    """(H, W, 3) RGB uint8 → a PNG holding those colours (``imwrite``
    takes BGR)."""
    imwrite(path, np.ascontiguousarray(np.asarray(rgb_u8)[:, :, ::-1]))


def _u8(rgb: torch.Tensor) -> np.ndarray:
    return torch.clamp(rgb * 255.0, 0, 255).to(torch.uint8).cpu().numpy()


class GarmentInference:
    """Drives registration and per-frame extraction from a trained
    network."""

    def __init__(self, net):
        self.net = net
        self.registered = {}            # garment → (verts, faces) numpy
        self.filter_list = {}           # garment → per-frame stable frame index
        self.registration_times = {}    # garment → seconds per registration stage
        self.stats = {}                 # the last export's seconds and colour-pass counts

    @property
    def device(self):
        return self.net.device

    def _frames(self, frame_ids) -> torch.Tensor:
        """Local dataset frame indices → global scene indices on the device."""
        return torch.as_tensor(np.asarray(frame_ids) + self.net.dataset.start_idx,
                               dtype=torch.int64, device=self.device)

    def _deform_conds(self, frame_ids):
        return split_deform_conds(self.net.scene["conds"]["deformer"][self._frames(frame_ids)],
                                  self.net.statics.garment_size)

    @torch.no_grad()
    def ensure_registration(self, ratio, save_dir: str | None = None, sew_waist: bool = True,
                            nricp_cfg: NricpConfig | None = None,
                            refine_cfg: NricpConfig | None = None):
        """Register every garment once (cached as ``registry_<name>.obj``
        with its boundary labels in ``registry_<name>_labels.npz``);
        two-garment subjects get their waists sewn afterwards
        (``Laplacian_Deform_upper_and_domn_Optimzier``). ``nricp_cfg`` and
        ``refine_cfg`` go to ``register_garment`` (None: its production
        schedules); the quality bench passes its quick ones."""
        net = self.net
        if net.mesh is None:
            net.marching_cube_update(_ratio_dict(ratio))
        if not net.garment_templates:
            # rebuild the templates from the A-pose body, as the reference's
            # registration does (OptimGarmentNetwork.py:2388)
            from ..models.garment import garment_templates_from_body

            tmpls = garment_templates_from_body(
                net.statics.garment_names, net.tmp_body_vs.cpu().numpy(),
                net.tmp_body_fs.cpu().numpy(), net.params["skinner"].Js.cpu().numpy(), None)
            net.garment_templates = [t.dense_boundary(2) for t in tmpls]
        curves = curves_forward(net.params["curves"], net.curve_statics).cpu().numpy()
        curves_by_name = {n: curves[i] for i, n in enumerate(net.curve_statics.fl_names)}
        reg_labels = {}
        for gi, gname in enumerate(net.statics.garment_names):
            cache = osp.join(save_dir, f"registry_{gname}.obj") if save_dir else None
            lcache = osp.join(save_dir, f"registry_{gname}_labels.npz") if save_dir else None
            if gname in self.registered or (cache and osp.isfile(cache)):
                if gname not in self.registered:
                    self.registered[gname] = load_obj(cache)
                # the labels are kept beside the cached obj, so the waist
                # sewing still runs (or is verified) on a cache hit
                if gname not in reg_labels and lcache and osp.isfile(lcache):
                    with np.load(lcache) as z:
                        reg_labels[gname] = {k: z[k] for k in z.files}
                continue
            nv, nf = net.mesh.garment_n[gi], net.mesh.garment_fn[gi]
            mc_v = net.mesh.garment_vs[gi][:nv].detach().cpu().numpy()
            mc_f = net.mesh.garment_fs[gi][:nf].cpu().numpy()
            # the target is the main surface only: MC of a weakly
            # constrained far-field SDF can carry floating junk
            mc_v, mc_f = largest_component(mc_v, mc_f)
            times = self.registration_times[gname] = {}
            rv, rf, labels = register_garment(
                net.garment_templates[gi], mc_v, mc_f,
                {n: curves_by_name[n] for n in FL_EXTRACT[gname] if n in curves_by_name},
                save_path=cache, nricp_cfg=nricp_cfg, refine_cfg=refine_cfg,
                device=self.device, times=times)
            self.registered[gname] = (rv, rf)
            reg_labels[gname] = labels
            if lcache:
                np.savez(lcache, **{k: np.asarray(v, np.int64) for k, v in labels.items()})
            if save_dir:
                # a fresh registration invalidates any earlier sewing
                marker = osp.join(save_dir, "registry_sewn.marker")
                if osp.isfile(marker):
                    os.remove(marker)

        # waist sewing for two-garment subjects: deform the bottom so its
        # 'upper_bottom' loop lands on the upper's waist loop
        names = list(net.statics.garment_names)
        marker = osp.join(save_dir, "registry_sewn.marker") if save_dir else None
        already_sewn = marker is not None and osp.isfile(marker)
        if (sew_waist and not already_sewn and len(names) == 2
                and all(n in reg_labels for n in names)
                and all("upper_bottom" in reg_labels[n] for n in names)):
            from ..geometry.laplacian import sew_upper_bottom

            up_name, bot_name = names
            uv, _ = self.registered[up_name]
            bv, bf = self.registered[bot_name]
            blab = reg_labels[bot_name]
            static = (np.concatenate([np.asarray(ids) for c, ids in blab.items()
                                      if c != "upper_bottom"]) if len(blab) > 1 else None)
            new_bv = sew_upper_bottom(uv, reg_labels[up_name]["upper_bottom"], bv, bf,
                                      blab["upper_bottom"], static_ids=static,
                                      device=self.device)
            self.registered[bot_name] = (new_bv.astype(np.float32), bf)
            if save_dir:
                save_obj(osp.join(save_dir, f"registry_{bot_name}.obj"), new_bv, bf)
                with open(marker, "w") as fh:
                    fh.write("sewn\n")
        return self.registered

    @torch.no_grad()
    def offset_filter(self, ratio, chunk: int = 8, sigma: float = 3.0,
                      outlier_count: int = 500) -> dict:
        """Per-frame offset-field outlier filter (offset_filter,
        OptimGarmentNetwork.py:2519-2560): each registered garment's
        translator offsets over all frames, their per-vertex mean and
        variance over time, and the frames where more than
        ``outlier_count`` vertices deviate beyond ``sigma``; such frames
        reuse the last stable frame's deformer latent. Returns and keeps
        {garment: [frame index to query, per frame]}."""
        from ..models.translator import translator_apply

        net = self.net
        r = _ratio_dict(ratio)
        F = net.dataset.frame_num
        self.filter_list = {}
        for gi, gname in enumerate(net.statics.garment_names):
            pts = _f32(self.registered[gname][0], self.device)
            offs = []
            for start in range(0, F, chunk):
                cond = self._deform_conds(np.arange(start, min(start + chunk, F)))[gi + 1]
                n = cond.shape[0]
                _, off = translator_apply(net.params["translator"],
                                          pts.expand((n,) + pts.shape),
                                          cond[:, None, :].expand(n, pts.shape[0], -1),
                                          r["deformerRatio"])
                offs.append(off.cpu().numpy())
            offs = np.concatenate(offs, 0)                         # (F, V, 3)
            mean = offs.mean(0)
            var = offs.var(0, ddof=1) + 1e-12
            query, pre = [0], 0
            var_mean = var.mean(0, keepdims=True)
            for i in range(1, F):
                n_out = (np.sqrt((offs[i] - mean) ** 2 / var_mean) > sigma).sum() / 3.0
                if n_out > outlier_count:
                    query.append(pre)
                else:
                    pre = i
                    query.append(i)
            self.filter_list[gname] = query
        return self.filter_list

    def _deform(self, verts, gi, frame_ids, ratio, poses=None, trans=None, cond=None):
        """Canonical (V, 3) → posed (N, V, 3) numpy for the frames (or the
        given poses, translations and latent)."""
        net = self.net
        r = _ratio_dict(ratio)
        fids = self._frames(frame_ids)
        d_cond = cond if cond is not None else self._deform_conds(frame_ids)[gi + 1]
        p = poses if poses is not None else net.scene["poses"][fids]
        t = trans if trans is not None else net.scene["trans"][fids]
        deform = make_deform_fn(net.params, d_cond, p, t, r["deformerRatio"])
        v = _f32(verts, self.device)
        return deform(v.expand((fids.shape[0],) + v.shape)).cpu().numpy()

    # -- inference-time rendering ------------------------------------------

    def _garment_color(self, gi) -> np.ndarray:
        cmap = RENDER_COLORS.get(getattr(self.net.dataset, "garment_type", ""), None)
        if cmap and gi < len(cmap) and len(cmap[gi]) == 3:
            return np.asarray(cmap[gi], np.float32)
        fallback = [[255, 99, 128], [193, 210, 240], [170, 170, 255]]
        return np.asarray(fallback[gi % len(fallback)], np.float32)

    def _phong_u8(self, cam, verts, faces, color_rgb, light_loc=None):
        """(V, 3) world vertices + a flat colour → (H, W, 3) uint8 and the
        hit mask, both numpy."""
        net = self.net
        W, H = net.statics.image_size
        cp = cam_mod.cam_pos(cam)
        light = cp if light_loc is None else _f32(light_loc, self.device)
        v = _f32(verts, self.device)
        vc = (_f32(color_rgb, self.device) / 255.0).expand(v.shape)
        faces_t = torch.as_tensor(np.array(faces, np.int64), device=self.device)
        rgb, hit = phong_render(cam, v, faces_t, vc, (H, W), light, cp,
                                tile=net.cfg.raster_tile, cap=net.cfg.raster_cap_mesh)
        return _u8(rgb), hit.cpu().numpy()

    def _color_chunk(self, gi, cond, poses, trans, origin, rays, seeds, r, ang):
        """Per-pixel colours of one chunk of hit pixels: 30 steps of
        surface refinement (OptimizeGarmentSurfaceSinlge), the SDF normal,
        the cardinal rays and RenderNet (compute_netRender_color,
        OptimGarmentNetwork.py:3186-3207) → (colours (M, 3), converged)."""
        from ..models.deformer import cardinal_rays_from_jac, deformer_jacobian
        from ..models.render_net import render_net_apply
        from ..models.sdf import sdf_apply, sdf_gradient
        from ..models.skinner import skinning_transforms

        net = self.net
        gsdf = net.params["garment_sdfs"][gi]
        sk = net.params["skinner"]
        M = rays.shape[0]
        b_inds = torch.zeros(M, dtype=torch.int64, device=self.device)
        deform = make_deform_fn(net.params, cond, poses, trans, r["deformerRatio"],
                                batch_inds=b_inds)
        valid = torch.ones(M, dtype=torch.bool, device=self.device)
        pts, conv = net.surface_solver(gi).solve(
            gsdf, net.params["translator"], sk, origin, rays, seeds, valid, b_inds, cond,
            skinning_transforms(sk, poses), trans + sk.extra_trans,
            (r["sdfRatio"], r["deformerRatio"]), athreshold_deg=ang, times=30, dthreshold=1e-4)
        _, feat = sdf_apply(gsdf, pts, r["sdfRatio"])
        nx = sdf_gradient(gsdf, pts, r["sdfRatio"])
        nx = nx / torch.clamp(torch.linalg.norm(nx, dim=-1, keepdim=True), min=1e-9)
        crays, _ = cardinal_rays_from_jac(deformer_jacobian(deform, pts), rays)
        cols = render_net_apply(net.params["render"], pts, nx, crays, feat,
                                ratio=r["renderRatio"])
        return cols, conv

    @torch.no_grad()
    def _colors_image(self, gi, cano_v, faces, posed_v, fid, ratio, chunk: int = 8192,
                      stats: dict | None = None) -> np.ndarray:
        """Per-pixel RenderNet colour image of one posed garment frame
        (white background), by surface refinement at every hit pixel;
        ``stats`` receives the hit pixels and the converged ones."""
        net = self.net
        dev = self.device
        r = _ratio_dict(ratio)
        cam = net._camera()
        W, H = net.statics.image_size
        if net.ang_thred is None:
            net.ang_thred = cam_mod.ang_threshold(cam)
        faces_t = torch.as_tensor(np.array(faces, np.int64), device=dev)
        scr = screen_with_cam_z(cam, _f32(posed_v, dev))[None]
        frag = rasterize_mesh(scr, faces_t, (H, W), tile=net.cfg.raster_tile,
                              cap=net.cfg.raster_cap_mesh)
        hit, seeds, _ = find_surface_points(frag, _f32(cano_v, dev), faces_t)
        rows, cols_px = torch.nonzero(hit[0], as_tuple=True)
        M = rows.shape[0]
        canvas = np.full((H, W, 3), 255, np.uint8)
        if stats is not None:
            stats.update(hit=int(M), converged=0)
        if M == 0:
            return canvas
        pix = torch.stack([cols_px, rows, torch.ones_like(rows)], -1).to(torch.float32)
        rays = cam_mod.view_rays(cam, pix)
        seeds = seeds[0, rows, cols_px]
        origin = cam_mod.cam_pos(cam)
        fids = self._frames([fid])
        cond = self._deform_conds([fid])[gi + 1]
        poses, trans = net.scene["poses"][fids], net.scene["trans"][fids]
        out, conv = [], 0
        for s in range(0, M, chunk):
            c, cv = self._color_chunk(gi, cond, poses, trans, origin, rays[s:s + chunk],
                                      seeds[s:s + chunk], r, float(net.ang_thred))
            out.append(c)
            conv = conv + cv.sum()
        rgb = torch.clamp((torch.cat(out) / 2.0 + 0.5) * 255.0, 0, 255).to(torch.uint8)
        canvas[rows.cpu().numpy(), cols_px.cpu().numpy()] = rgb.cpu().numpy()
        if stats is not None:
            stats["converged"] = int(conv)
        return canvas

    def _mask_error(self, fid, hit) -> float:
        """1 − IoU of a render's hit mask against the dataset's mask of the
        frame; −1 where the dataset has no mask file for it."""
        ds = self.net.dataset
        if not osp.isfile(ds.mask_ns[int(fid) + ds.start_idx]):
            return -1.0
        gt = ds[int(fid)][1]["mask"] > 0
        inter = (hit & gt).sum()
        union = (hit | gt).sum()
        return 1.0 - inter / max(union, 1)

    @torch.no_grad()
    def infer_garment(self, frame_ids, ratio, out_dir: str, images: bool = True,
                      colors: bool = True, color_chunk: int = 8192):
        """Per-frame posed registered garments (+ body) → the reference's
        five export families (infer_garment, OptimGarmentNetwork.py:
        2950-3213 + infer_fl.py:227-280):

        - ``meshs/NNNN_<garment>.obj`` posed garment meshes (+ ``.png``
          per-garment Phong renders when ``images``),
        - ``render/NNNN.png`` merged Phong render of all garments,
        - ``def1meshs/NNNN_<garment>.png`` offset-only (translator, no
          LBS) mesh from the reference's fixed frontal camera at the mean
          translation with a point light,
        - ``colors/NNNN_<garment>.png`` per-pixel RenderNet colours after
          30-step surface refinement at every hit pixel (when ``colors``),
        - ``smpl_meshs/NNNN.obj`` posed SMPL bodies.

        Returns (outputs, errors): errors['maskE'] is the per-frame mask
        IoU error of the merged render against the dataset's mask.
        ``self.stats`` keeps the seconds per family and each colour
        image's hit and converged pixels."""
        from ..models.translator import translator_apply

        net = self.net
        dev = self.device
        for sub in ("meshs", "smpl_meshs") + (("render", "def1meshs") if images else ()) + (
                ("colors",) if colors else ()):
            os.makedirs(osp.join(out_dir, sub), exist_ok=True)
        self.ensure_registration(ratio, out_dir)
        r = _ratio_dict(ratio)
        cam = net._camera()
        fids_np = np.asarray(frame_ids)
        N = len(fids_np)
        secs, color_stats = {}, []
        self.stats = {"seconds": secs, "colors": color_stats}

        def tick(name, t0):
            _sync(dev)
            secs[name] = secs.get(name, 0.0) + time.time() - t0

        # the reference's def1 camera: fixed frontal R = diag(−1, 1, −1)
        # (quat [0, 0, 1, 0]) at the mean translation, a point light at
        # (0, 1, T_z) (OptimGarmentNetwork.py:3178-3183)
        mean_t = net.scene["trans"].mean(0).cpu().numpy()
        def1_cam = cam_mod.Camera(focal=cam.focal, principal=cam.principal,
                                  quat=_f32([0.0, 0.0, 1.0, 0.0], dev),
                                  trans=_f32(mean_t, dev), image_size=cam.image_size)
        def1_light = [0.0, 1.0, float(mean_t[2])]

        outputs, posed_all = [], []
        for gi, gname in enumerate(net.statics.garment_names):
            t0 = time.time()
            rv, rf = self.registered[gname]
            cond = None
            if gname in self.filter_list:
                # outlier frames take the last stable frame's deformer latent
                # (offset_filter consumption, OptimGarmentNetwork.py:2777)
                cond = self._deform_conds(np.asarray(self.filter_list[gname])[fids_np])[gi + 1]
            posed = self._deform(rv, gi, frame_ids, ratio, cond=cond)
            posed_all.append(posed)
            color = self._garment_color(gi)
            if images:
                # def1: translator offsets only, no skeletal transform
                pts = _f32(rv, dev)
                c1 = self._deform_conds(fids_np)[gi + 1]
                def1_vs, _ = translator_apply(net.params["translator"],
                                              pts.expand((N,) + pts.shape),
                                              c1[:, None, :].expand(N, pts.shape[0], -1),
                                              r["deformerRatio"])
                def1_vs = def1_vs.cpu().numpy()
            tick("deform", t0)
            for k, fid in enumerate(fids_np):
                stem = f"{int(fid):04d}_{gname}"
                t0 = time.time()
                save_obj(osp.join(out_dir, "meshs", stem + ".obj"), posed[k], rf)
                tick("meshs_obj", t0)
                if images:
                    t0 = time.time()
                    img, _ = self._phong_u8(cam, posed[k], rf, color)
                    _imwrite(osp.join(out_dir, "meshs", stem + ".png"), img)
                    d1, _ = self._phong_u8(def1_cam, def1_vs[k], rf, color, light_loc=def1_light)
                    _imwrite(osp.join(out_dir, "def1meshs", stem + ".png"), d1)
                    tick("meshs_png_def1", t0)
                if colors:
                    t0 = time.time()
                    cst = {}
                    cimg = self._colors_image(gi, rv, rf, posed[k], int(fid), ratio,
                                              chunk=color_chunk, stats=cst)
                    _imwrite(osp.join(out_dir, "colors", stem + ".png"), cimg)
                    tick("colors", t0)
                    color_stats.append(dict(frame=int(fid), garment=gname, **cst))
            outputs.append(posed)

        # merged render of all garments + the mask IoU error
        errors = {"maskE": np.full(N, -1.0)}
        if images:
            t0 = time.time()
            names = net.statics.garment_names
            offs = np.cumsum([0] + [self.registered[g][0].shape[0] for g in names])
            all_f = torch.as_tensor(np.concatenate(
                [np.asarray(self.registered[g][1]) + offs[i] for i, g in enumerate(names)]),
                device=dev)
            all_c = _f32(np.concatenate(
                [np.broadcast_to(self._garment_color(i), (self.registered[g][0].shape[0], 3))
                 for i, g in enumerate(names)]), dev) / 255.0
            W, H = net.statics.image_size
            cp = cam_mod.cam_pos(cam)
            for k, fid in enumerate(fids_np):
                mv = _f32(np.concatenate([p[k] for p in posed_all]), dev)
                rgb, hit = phong_render(cam, mv, all_f, all_c, (H, W), cp, cp,
                                        tile=net.cfg.raster_tile, cap=net.cfg.raster_cap_mesh)
                _imwrite(osp.join(out_dir, "render", f"{int(fid):04d}.png"), _u8(rgb))
                errors["maskE"][k] = self._mask_error(fid, hit.cpu().numpy())
            tick("render", t0)

        # posed body (LBS only)
        t0 = time.time()
        fids = self._frames(fids_np)
        body_vs = net.tmp_body_vs
        body = skinner_apply(net.params["skinner"], body_vs.expand((N,) + body_vs.shape),
                             net.scene["poses"][fids], net.scene["trans"][fids]).cpu().numpy()
        body_fs = net.tmp_body_fs.cpu().numpy()
        for k, fid in enumerate(fids_np):
            save_obj(osp.join(out_dir, "smpl_meshs", f"{int(fid):04d}.obj"), body[k], body_fs)
        tick("smpl_meshs", t0)
        return outputs, errors

    @torch.no_grad()
    def infer_garment_fl(self, frame_ids, ratio, out_dir: str, curve_radius: float = 0.002,
                         num_joints: int = 6):
        """Per-frame tube meshes of the optimized feature curves
        (infer_garment_fl, OptimGarmentNetwork.py:2861-2949)."""
        net = self.net
        os.makedirs(out_dir, exist_ok=True)
        curves = curves_forward(net.params["curves"], net.curve_statics).cpu().numpy()
        nx = net.curve_statics.nx[:, 0].cpu().numpy()
        for gi, gname in enumerate(net.statics.garment_names):
            for ci, cname in enumerate(net.curve_statics.fl_names):
                if cname not in FL_EXTRACT[gname]:
                    continue
                tv, tf = curve_to_tube_mesh(curves[ci], nx[ci], curve_radius, num_joints)
                posed = self._deform(tv, gi, frame_ids, ratio)
                for k, fid in enumerate(np.asarray(frame_ids)):
                    save_obj(osp.join(out_dir, f"{int(fid):04d}_{cname}.obj"), posed[k], tf)

    @torch.no_grad()
    def infer_garment_animation(self, poses, trans, ratio, out_dir: str):
        """Drive the registered garments with a novel pose sequence, with
        the latent code averaged over the scene's frames
        (infer_garment_animation, OptimGarmentNetwork.py:2729-2860)."""
        net = self.net
        os.makedirs(out_dir, exist_ok=True)
        self.ensure_registration(ratio, out_dir)
        mean_cond = net.scene["conds"]["deformer"].mean(0, keepdim=True)
        conds = split_deform_conds(mean_cond, net.statics.garment_size)
        poses = _f32(np.asarray(poses, np.float32).reshape(-1, 24, 3), self.device)
        trans = _f32(np.asarray(trans, np.float32).reshape(-1, 3), self.device)
        T = poses.shape[0]
        for gi, gname in enumerate(net.statics.garment_names):
            rv, rf = self.registered[gname]
            for start in range(0, T, 8):
                chunk = np.arange(start, min(start + 8, T))
                cond = conds[gi + 1].expand(len(chunk), -1)
                posed = self._deform(rv, gi, chunk, ratio, poses=poses[chunk],
                                     trans=trans[chunk], cond=cond)
                for k, fid in enumerate(chunk):
                    save_obj(osp.join(out_dir, f"{int(fid):04d}_{gname}.obj"), posed[k], rf)


def one_euro_smooth(x: np.ndarray, min_cutoff=0.004, beta=0.7, d_cutoff=1.0, freq=30.0):
    """OneEuro filter over the time axis (engineer/utils/smooth_poses.py);
    numpy, as the JAX function."""
    x = np.asarray(x, np.float64)
    out = np.empty_like(x)
    out[0] = x[0]
    dx_prev = np.zeros_like(x[0])
    x_prev = x[0]

    def alpha(cutoff):
        tau = 1.0 / (2 * np.pi * cutoff)
        te = 1.0 / freq
        return 1.0 / (1.0 + tau / te)

    for i in range(1, len(x)):
        dx = (x[i] - x_prev) * freq
        ad = alpha(d_cutoff)
        dx_hat = ad * dx + (1 - ad) * dx_prev
        a = alpha(min_cutoff + beta * np.abs(dx_hat))
        out[i] = a * x[i] + (1 - a) * x_prev
        x_prev = out[i]
        dx_prev = dx_hat
    return out.astype(np.float32)


def smooth_scene_poses(dataset, ranges=None):
    """smooth_trans (OptimGarmentNetwork.py:2567-2728): OneEuro-smooth the
    poses and translations of ``dataset.params``, only within the given
    frame ranges where some are given. The network's scene takes them with
    ``net.invalidate_scene()``."""
    p = dataset.params
    sp = one_euro_smooth(p.poses.reshape(len(p.poses), -1)).reshape(p.poses.shape)
    st = one_euro_smooth(p.trans)
    if ranges:
        for rg in ranges:
            if len(rg) == 2:
                a, b = rg
                p.poses[a:b] = sp[a:b]
                p.trans[a:b] = st[a:b]
    else:
        p.poses, p.trans = sp, st
    return p
