"""Feature-curve visibility gates (counterpart of
``recmv_tpu/core/visibility.py``), selected by ``fl_visible_method``:

- ``zbuff``: the posed body z-buffer probed at the LBS-posed
  canonical-SMPL curve points; visible where z − zbuf < the curve's
  threshold;
- ``garment_zbuff``: the deformed garment mesh z-buffer probed at the
  fully deformed curve points (inter-garment occlusion);
- ``zbuff_and``: both;
- ``surface`` / ``sdf``: outward curve normals, or the garment SDF's
  gradient, warped to posed space by J⁻ᵀ; visible where the posed normal
  faces the camera (z < 0).

Visibility is a gate, not a gradient path: every function here returns
tensors without a graph.
"""

from __future__ import annotations

import torch

from ..models.deformer import deformed_normals_from_grads, deformer_jacobian
from ..ops.grid_sample import grid_sample_2d
from ..ops.rasterizer import rasterize_mesh, screen_with_cam_z

VISIBLE_METHODS = ("zbuff", "garment_zbuff", "zbuff_and", "surface", "sdf")


@torch.no_grad()
def mesh_zbuf_image(cam, posed, faces, image_size, tile: int = 32, cap: int = 512,
                    downscale: int = 1) -> torch.Tensor:
    """posed (N, V, 3) world points → (N, ⌈H/downscale⌉, ⌈W/downscale⌉)
    camera-space depth of the nearest face (K1 through ``rasterize_mesh``,
    all frames in one launch), with empty pixels filled by the frame's
    largest vertex depth over all V vertices."""
    W, H = image_size
    Hs, Ws = -(-H // downscale), -(-W // downscale)
    inv = torch.tensor([1.0 / downscale, 1.0 / downscale, 1.0], device=posed.device)
    scr = screen_with_cam_z(cam, posed) * inv
    zb = rasterize_mesh(scr, faces, (Hs, Ws), tile=tile, cap=cap).zbuf[..., 0]
    return torch.where(zb <= 0, scr[..., 2].amax(1)[:, None, None], zb)


@torch.no_grad()
def sample_zbuf(zbuf, screen_pts, image_size) -> torch.Tensor:
    """Bilinear z-buffer lookup at screen points, normalized by the full
    ``image_size`` (W, H) whatever the buffer's resolution, align_corners
    uv, zero outside. zbuf (N, h, w); screen_pts (N, P, 2+) → (N, P)."""
    W, H = image_size
    N, P = screen_pts.shape[:2]
    uv = torch.stack([2.0 * screen_pts[..., 0] / W - 1.0,
                      2.0 * screen_pts[..., 1] / H - 1.0], -1)
    frame = torch.arange(N, device=zbuf.device).repeat_interleave(P)
    out = grid_sample_2d(zbuf[:, None], uv.reshape(N * P, 2), align_corners=True,
                         image_ids=frame)
    return out.reshape(N, P)


def zbuf_visible(z, surf_z, threshold: float):
    """(N, P) depth test: in front of, or within ``threshold`` behind, the
    rasterized surface."""
    return (z - surf_z) < threshold


def normal_visible(posed_normals):
    """The camera looks along +z: visible where the posed normal points
    back at it."""
    return posed_normals[..., 2] < 0.0


def outward_curve_normals(curve_pts):
    """Unit radial directions of a closed curve (S, 3) from its centre."""
    d = curve_pts - curve_pts.mean(0, keepdim=True)
    return d / torch.clamp(torch.linalg.norm(d, dim=-1, keepdim=True), min=1e-9)


@torch.no_grad()
def warp_normals_to_posed(deform_flat_fn, pts_flat, normals_flat):
    """normalize(J⁻ᵀ n) with the singular fallback, J the deformation's
    Jacobian at ``pts_flat`` (M, 3)."""
    jac = deformer_jacobian(deform_flat_fn, pts_flat)
    return deformed_normals_from_grads(jac, normals_flat)[0]


def combine_visibility(method: str, body_vis=None, garment_vis=None, normal_vis=None):
    """The gate of ``method`` from the computed ones."""
    if method == "zbuff":
        return body_vis
    if method == "garment_zbuff":
        if garment_vis is None:
            raise ValueError(
                "fl_visible_method='garment_zbuff' requires deformed garment "
                "meshes (pass garment_vs_t/garment_fs_t to fl_branch_loss); "
                "none were provided — use 'zbuff' before the first MC mesh "
                "exists")
        return garment_vis
    if method == "zbuff_and":
        if garment_vis is None:
            return body_vis
        return body_vis & garment_vis
    if method in ("surface", "sdf"):
        return normal_vis
    raise ValueError(f"unknown fl_visible_method {method!r}; "
                     f"expected one of {VISIBLE_METHODS}")
