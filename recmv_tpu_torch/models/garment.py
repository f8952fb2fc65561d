"""Copy of ``recmv_tpu/models/garment.py``, kept byte-for-byte apart from this note and
its imports: the port runs where JAX is absent, and importing any
``recmv_tpu`` module imports JAX.

Garment templates: loading, body-slicing, boundary decoding.

Parity targets: ``Garment_Mesh`` (reference
``engineer/utils/garment_structure.py:357-1080``) and
``garment_by_init_smpl`` / ``__load_smpl_garment_tempalte`` /
``__load_deepfashion3d_template`` (``OptimGarmentNetwork.py:196-384``).

The reference slices the SMPL A-pose body by pre-annotated vertex ids
shipped in an external ``smpl_clothes_template`` folder (vertex-color
coded boundary labels from registered DeepFashion3D templates). We load
that asset layout when present (``load_template_assets``); otherwise we
build *procedural* templates by slicing the body mesh with
skeleton-derived planes per garment type — same downstream interface
(open patch meshes whose boundary loops carry curve labels).
"""

from __future__ import annotations

import os
import os.path as osp
from dataclasses import dataclass, field

import numpy as np

from ..config.constants import FL_EXTRACT, GARMENT_COLOR_MAP, GARMENT_FL_MATCH
from ..geometry.mesh_utils import (
    boundary_loops,
    close_holes,
    dense_boundary,
    largest_component,
    slice_mesh_by_vertex_ids,
    vertex_normals,
)
from ..geometry.polygons import uniform_sample_3d


@dataclass
class GarmentTemplate:
    """An open garment patch with labeled boundary loops."""

    name: str
    verts: np.ndarray              # (V, 3)
    faces: np.ndarray              # (F, 3)
    boundary_labels: dict = field(default_factory=dict)  # curve name → vertex ids (ordered loop)
    static_vertex_ids: np.ndarray | None = None

    def dense_boundary(self, times: int = 1) -> "GarmentTemplate":
        """Subdivide near the boundary (garment_structure.py:857) —
        re-derives labeled loops afterwards by nearest-loop matching."""
        old = {k: self.verts[v] for k, v in self.boundary_labels.items()}
        verts, faces = dense_boundary(self.verts, self.faces, times)
        out = GarmentTemplate(self.name, verts, faces)
        out.label_boundaries_from_curves(old)
        return out

    def label_boundaries_from_curves(self, curve_pts_by_name: dict):
        """Assign each boundary loop to the nearest labeled reference
        curve (centroid distance)."""
        loops = boundary_loops(self.faces)
        self.boundary_labels = {}
        taken = set()
        for name, ref in curve_pts_by_name.items():
            c_ref = np.asarray(ref).mean(0)
            best, best_d = None, np.inf
            for i, loop in enumerate(loops):
                if i in taken:
                    continue
                d = np.linalg.norm(self.verts[loop].mean(0) - c_ref)
                if d < best_d:
                    best, best_d = i, d
            if best is not None:
                taken.add(best)
                self.boundary_labels[name] = loops[best]

    def extract_featurelines(self, sample_num: int = 200) -> dict:
        """curve name → uniformly resampled (sample_num, 3) loop
        (extract_featurelines, garment_structure.py:544)."""
        out = {}
        for name, loop in self.boundary_labels.items():
            out[name] = uniform_sample_3d(self.verts[loop], sample_num).astype(np.float32)
        return out

    def close_hole(self):
        """Fan-close all boundary loops + 2x subdivision
        (garment_structure.py:775). Returns (verts, normals) for IGR
        fitting of the closed garment SDF."""
        v, f, _ = close_holes(self.verts, self.faces, subdivide_times=2)
        return v.astype(np.float32), f, vertex_normals(v, f).astype(np.float32)


def load_template_assets(template_dir: str, garment_name: str) -> GarmentTemplate | None:
    """Load a reference-layout template (obj with vertex colors encoding
    boundary labels per GARMENT_COLOR_MAP) if the external asset exists."""
    for cand in (f"{garment_name}.obj", f"{garment_name}/template.obj"):
        p = osp.join(template_dir, cand)
        if osp.isfile(p):
            verts, faces, colors = _load_obj_with_colors(p)
            t = GarmentTemplate(garment_name, verts, faces)
            cmap = GARMENT_COLOR_MAP.get(garment_name, {})
            curve_ref = {}
            for label, rgb in cmap.items():
                if label == "back_ground":
                    continue
                sel = (np.abs(colors - np.asarray(rgb) / 255.0) < 0.02).all(1)
                if sel.any():
                    curve_ref[label] = verts[sel]
            t.label_boundaries_from_curves(curve_ref)
            return t
    return None


def _load_obj_with_colors(path):
    verts, colors, faces = [], [], []
    with open(path) as f:
        for line in f:
            if line.startswith("v "):
                parts = line.split()
                verts.append([float(x) for x in parts[1:4]])
                colors.append([float(x) for x in parts[4:7]] if len(parts) >= 7 else [1, 1, 1])
            elif line.startswith("f "):
                idx = [int(p.split("/")[0]) - 1 for p in line.split()[1:4]]
                faces.append(idx)
    return (np.asarray(verts, np.float32), np.asarray(faces, np.int64),
            np.asarray(colors, np.float32))


# ---------------------------------------------------------------------------
# Procedural body-slice templates (no external assets)
# ---------------------------------------------------------------------------

def _slice_by_mask(verts, faces, keep_mask):
    sv, sf, old_ids = slice_mesh_by_vertex_ids(verts, faces, np.where(keep_mask)[0])
    return sv, sf, old_ids


def _swept_tube_template(name: str, body_verts: np.ndarray, hip_y: float,
                         top_y: float, top_label: str, bottom_label: str,
                         sho_x: float, offset: float = 0.012,
                         ny: int = 33, na: int = 64) -> GarmentTemplate:
    """Strapless-tube template as a swept cylindrical surface around the
    torso: radius field r(y, θ) from the body vertices binned on a
    (height, angle) grid (arm vertices pre-filtered by |x|), holes filled
    and smoothed, offset outward. Slicing the body mesh cannot produce
    this template cleanly — the y-band slice drags non-local boundary
    excursions wherever arm↔torso bridging faces cross the band — and
    the reference's DeepFashion3D tube templates are proper tubes with
    two planar rings, which is exactly what this sweep yields."""
    v = np.asarray(body_verts, np.float32)
    band = v[(v[:, 1] > hip_y - 0.05) & (v[:, 1] < top_y + 0.05)]
    band = band[np.abs(band[:, 0]) < 0.8 * abs(sho_x)]
    ys = np.linspace(hip_y, top_y, ny).astype(np.float32)
    row = np.clip(np.round((band[:, 1] - hip_y) / (top_y - hip_y) * (ny - 1)),
                  0, ny - 1).astype(np.int64)

    # per-height axis center (torso axis drifts with belly/back shape)
    cx = np.zeros((ny, 2), np.float32)
    cnt = np.zeros(ny)
    np.add.at(cx, row, band[:, [0, 2]])
    np.add.at(cnt, row, 1.0)
    have = cnt > 0
    cx[have] /= cnt[have, None]
    for _ in range(ny):                    # fill empty rows from neighbors
        if have.all():
            break
        for i in np.where(~have)[0]:
            nb = [j for j in (i - 1, i + 1) if 0 <= j < ny and have[j]]
            if nb:
                cx[i] = np.mean(cx[nb], 0)
                have[i] = True

    rel = band[:, [0, 2]] - cx[row]
    theta = np.arctan2(rel[:, 1], rel[:, 0])
    col = np.clip(((theta + np.pi) / (2 * np.pi) * na).astype(np.int64), 0, na - 1)
    R = np.full((ny, na), np.nan, np.float32)
    rad = np.linalg.norm(rel, axis=1)
    flat = row * na + col
    order = np.argsort(rad)                # later (larger) wins
    Rf = R.reshape(-1)
    Rf[flat[order]] = rad[order]           # per-bin max radius
    # fill empty bins by neighbor means (θ wraps), then smooth twice
    for _ in range(ny + na):
        nanm = np.isnan(R)
        if not nanm.any():
            break
        nb = np.stack([np.roll(R, 1, 1), np.roll(R, -1, 1),
                       np.vstack([R[:1], R[:-1]]), np.vstack([R[1:], R[-1:]])])
        good = ~np.isnan(nb)
        cnt = good.sum(0)
        fill = np.where(good, nb, 0.0).sum(0) / np.maximum(cnt, 1)
        R[nanm & (cnt > 0)] = fill[nanm & (cnt > 0)]
    for _ in range(2):
        R = 0.5 * R + 0.125 * (np.roll(R, 1, 1) + np.roll(R, -1, 1)
                               + np.vstack([R[:1], R[:-1]])
                               + np.vstack([R[1:], R[-1:]]))
    R = R + offset

    ang = (np.arange(na) + 0.5) / na * 2 * np.pi - np.pi
    px = cx[:, None, 0] + R * np.cos(ang)[None, :]
    pz = cx[:, None, 1] + R * np.sin(ang)[None, :]
    py = np.broadcast_to(ys[:, None], (ny, na))
    verts = np.stack([px, py, pz], -1).reshape(-1, 3).astype(np.float32)

    faces = []
    for i in range(ny - 1):
        for j in range(na):
            a = i * na + j
            b = i * na + (j + 1) % na
            c = (i + 1) * na + j
            d = (i + 1) * na + (j + 1) % na
            faces.append([a, b, c])
            faces.append([b, d, c])
    faces = np.asarray(faces, np.int64)
    # outward winding: flip if face normals point toward the axis
    fn = np.cross(verts[faces[:, 1]] - verts[faces[:, 0]],
                  verts[faces[:, 2]] - verts[faces[:, 0]])
    fc = verts[faces].mean(1)
    out_dir = fc - np.concatenate(
        [np.interp(fc[:, 1], ys, cx[:, 0])[:, None],
         fc[:, 1:2] * 0,
         np.interp(fc[:, 1], ys, cx[:, 1])[:, None]], 1)
    if float(np.sum(np.sum(fn * out_dir, 1))) < 0:
        faces = faces[:, [0, 2, 1]]

    t = GarmentTemplate(name, verts, faces)
    t.boundary_labels = {top_label: np.arange((ny - 1) * na, ny * na),
                         bottom_label: np.arange(0, na)}
    return t


def _tube_top_y(sho_y: float, hip_y: float) -> float:
    """Strapless (tube-top) upper cut: 80% of the hip→shoulder span,
    i.e. just below the armpit. Skeleton-derived on purpose: mesh-probing
    the armpit is fragile (a y<neck_y slice's top boundary is the merged
    neck+armhole loop — non-planar, narrow at the anatomical neck — the
    r3 0.27-up rim-spill root cause; and on an A-posed body the hanging
    arms flank the torso at every height, so 'no arm in this slab'
    criteria never fire where the armpit actually is). The garment's true
    extent is subject-specific anyway — the curve fit + registration
    machinery absorbs the residual, exactly as with the reference's
    library templates (smpl_clothes_template flat-cut tubes)."""
    return float(hip_y + 0.8 * (sho_y - hip_y))


def procedural_template(garment_name: str, body_verts: np.ndarray,
                        body_faces: np.ndarray, joints: np.ndarray) -> GarmentTemplate:
    """Slice the A-pose body into a garment patch using skeleton planes.

    joints (24,3) SMPL-ordered rest joints. The cut heights follow the
    garment taxonomy (GARMENT_FL_MATCH): e.g. short_sleeve_upper = torso
    band between neck and hips plus upper arms to mid-upper-arm.
    """
    v = np.asarray(body_verts)
    y = v[:, 1]
    x = v[:, 0]
    neck_y = joints[12, 1]
    hip_y = (joints[1, 1] + joints[2, 1]) / 2.0
    knee_y = (joints[4, 1] + joints[5, 1]) / 2.0
    ankle_y = (joints[7, 1] + joints[8, 1]) / 2.0
    sho_l = joints[16]
    sho_r = joints[17]
    elb_l = joints[18]
    elb_r = joints[19]
    wri_l = joints[20]
    wri_r = joints[21]

    def arm_frac(frac):
        return (abs(sho_l[0] + frac * (elb_l[0] - sho_l[0])),)

    torso = (y > hip_y) & (y < neck_y) & (np.abs(x) < abs(sho_l[0]) * 1.15)
    if garment_name in ("short_sleeve_upper",):
        cut = sho_l[0] + 0.55 * (elb_l[0] - sho_l[0])
        arms = (y > hip_y) & (np.abs(x) >= abs(sho_l[0]) * 0.9) & (np.abs(x) < abs(cut))
        keep = torso | arms
        curve_y = {"neck": neck_y, "upper_bottom": hip_y}
    elif garment_name in ("long_sleeve_upper",):
        cut = wri_l[0]
        arms = (y > hip_y - 0.02) & (np.abs(x) >= abs(sho_l[0]) * 0.9) & (np.abs(x) < abs(cut))
        keep = torso | arms
        curve_y = {"neck": neck_y, "upper_bottom": hip_y}
    elif garment_name == "no_sleeve_upper":
        keep = torso
        curve_y = {"neck": neck_y, "bottom_curve": hip_y}
    elif garment_name in ("tube", "upper_tube"):
        # strapless: swept cylindrical surface ending flat below the
        # armpits ("upper_tube" variant: the bottom loop is a WAIST
        # shared with a bottom garment — sew_upper_bottom target)
        top_y = _tube_top_y(sho_l[1], hip_y)
        bottom_label = ("bottom_curve" if garment_name == "tube"
                        else "upper_bottom")
        return _swept_tube_template(garment_name, v, hip_y, top_y,
                                    "neck", bottom_label, sho_l[0])
    elif garment_name == "dress":
        keep = (y > knee_y) & (y < neck_y)
        keep &= ~((np.abs(x) > abs(elb_l[0])) & (y > hip_y))
        curve_y = {"neck": neck_y, "bottom_curve": knee_y}
    elif garment_name == "skirt":
        # A skirt is a CONE around both legs, not a body slice: slicing
        # knee→hip keeps two leg tubes + crotch, and the knee boundary
        # loop undulates down one leg and up the other (measured y-spread
        # 0.32 on the synthetic two-garment scene). The curve init then
        # scales that undulation with the ring and the 2D chamfer
        # COLLAPSES the scale to flatten it (hem s 2.0 → 0.8, r 0.09 vs
        # gt 0.225). The swept surface makes the hull-of-both-legs
        # surface with two planar rings — the same shape DeepFashion3D
        # skirt templates have (the reference's skirt path,
        # OptimGarmentNetwork.py:196-384, loads DF3D assets).
        return _swept_tube_template(garment_name, v, knee_y, hip_y + 0.05,
                                    "upper_bottom", "bottom_curve",
                                    sho_l[0])
    elif garment_name in ("long_pants",):
        keep = (y > ankle_y) & (y < hip_y + 0.05) & (np.abs(x) < abs(sho_l[0]))
        curve_y = {"upper_bottom": hip_y + 0.04, "left_pant": ankle_y, "right_pant": ankle_y}
    elif garment_name in ("short_pants",):
        keep = (y > knee_y) & (y < hip_y + 0.05) & (np.abs(x) < abs(sho_l[0]))
        curve_y = {"upper_bottom": hip_y + 0.04, "left_pant": knee_y, "right_pant": knee_y}
    else:
        raise ValueError(f"no procedural template for {garment_name}")

    sv, sf, _ = _slice_by_mask(v, body_faces, keep)
    # keep the torso component only: a y-band slice also catches the
    # disconnected arm segments passing diagonally through the band
    # (A-pose), and their cut rings pollute boundary-loop labeling
    sv, sf = largest_component(sv, sf)
    # offset outward so the garment sits above the skin
    sn = vertex_normals(sv, sf)
    sv = sv + sn * 0.012

    t = GarmentTemplate(garment_name, sv, sf)
    # label loops by expected curve locations
    loops = boundary_loops(sf)
    refs = {}
    # label with the MATCHING superset (GARMENT_FL_MATCH) rather than the
    # parameterized-curve subset (FL_EXTRACT): e.g. the skirt's
    # 'upper_bottom' waist loop has no explicit curve but registration
    # matching and two-garment waist SEWING both need the label
    for cname in GARMENT_FL_MATCH.get(garment_name, FL_EXTRACT[garment_name]):
        ylv = curve_y.get(cname)
        if ylv is None:
            continue
        side = 0.0
        if cname.startswith("left"):
            side = +0.2
        elif cname.startswith("right"):
            side = -0.2
        refs[cname] = np.asarray([[side, ylv, 0.0]])
    # cuffs: arm-end loops
    if "left_cuff" in GARMENT_FL_MATCH.get(garment_name,
                                           FL_EXTRACT[garment_name]):
        xr = max(abs(sv[:, 0].max()), abs(sv[:, 0].min()))
        refs["left_cuff"] = np.asarray([[xr, sho_l[1], 0.0]])
        refs["right_cuff"] = np.asarray([[-xr, sho_r[1], 0.0]])
    t.label_boundaries_from_curves(refs)
    return t


def garment_templates_from_body(garment_names, body_verts, body_faces, joints,
                                template_dir: str | None = None):
    """Templates for all garments of a subject: external assets when
    available, procedural slices otherwise (garment_by_init_smpl parity)."""
    out = []
    for name in garment_names:
        t = None
        if template_dir:
            t = load_template_assets(template_dir, name)
        if t is None:
            t = procedural_template(name, body_verts, body_faces, joints)
        out.append(t)
    return out
