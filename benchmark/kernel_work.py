"""The least work of the port's three hand-written kernels, frozen here
and worked out from the shapes of the problem each launch solves, not
from the binning that feeds it: each input byte read once, each output
byte written once, float32 and int32 at 4 bytes.

- K1 (``csrc/mesh_raster.cu``), the mesh z-buffer of ``rasterize_mesh``:
  reads the B frames' F triangles (3 corners × x, y, z) and writes per
  pixel the depth, the face id and 3 barycentrics.
- K2 (``csrc/composite_fwd.cu``), the point composite of
  ``composite_points``: reads the B frames' P screen points (x, y, z) and
  the P × C features, writes the B × H × W × C image.
- K3 (``csrc/composite_bwd.cu``), its backward: reads what K2 reads and
  the upstream gradient of the image, writes the gradient of each
  point's screen x, y per frame and, where autograd asks for it, of the
  features.

No operation count is independent of the implementation here (the pairs
of pixel and candidate a kernel visits depend on its culling and caps),
so the operations are not counted and the bound is the bytes' time.
"""

from __future__ import annotations

from .peaks import FP32_FLOP_PER_S, HBM_BYTES_PER_S

F32 = 4


def k1_bytes(B: int, F: int, H: int, W: int) -> int:
    return B * F * 9 * F32 + B * H * W * 5 * F32


def k2_bytes(B: int, P: int, C: int, H: int, W: int) -> int:
    return B * P * 3 * F32 + P * C * F32 + B * H * W * C * F32


def k3_bytes(B: int, P: int, C: int, H: int, W: int, dfeat: bool) -> int:
    return (k2_bytes(B, P, C, H, W) + B * P * 2 * F32
            + (P * C * F32 if dfeat else 0))


def bound_s(nbytes: int, ops: int = 0) -> float:
    """The least time the chip could take: the larger of the bytes over the
    memory bandwidth and the operations over the float32 peak."""
    return max(nbytes / HBM_BYTES_PER_S, ops / FP32_FLOP_PER_S)


class LaunchLog:
    """Records the problem of every K1, K2 and K3 launch while installed:
    it wraps the binning prologues ``mesh_tile_inputs`` and
    ``composite_tile_inputs`` of a rasterizer module (the port's
    ``ops.rasterizer``), which ``rasterize_mesh`` and ``composite_points``
    look up at each call; each such call is followed by one K1, or one K2
    and, where its inputs require a gradient, one K3."""

    def __init__(self, rasterizer):
        self.mod = rasterizer
        self.k1, self.k2, self.k3 = [], [], []
        self._orig = None

    def __enter__(self):
        mesh_in, comp_in = self.mod.mesh_tile_inputs, self.mod.composite_tile_inputs
        self._orig = (mesh_in, comp_in)

        def mesh_tile_inputs(verts, faces, image_size, *a, **k):
            H, W = image_size
            self.k1.append(k1_bytes(verts.shape[0], faces.shape[0], H, W))
            return mesh_in(verts, faces, image_size, *a, **k)

        def composite_tile_inputs(pts, radius, features, image_size, *a, **k):
            H, W = image_size
            B, P, C = pts.shape[0], pts.shape[1], features.shape[-1]
            self.k2.append(k2_bytes(B, P, C, H, W))
            if pts.requires_grad or features.requires_grad:
                self.k3.append(k3_bytes(B, P, C, H, W, features.requires_grad))
            return comp_in(pts, radius, features, image_size, *a, **k)

        self.mod.mesh_tile_inputs = mesh_tile_inputs
        self.mod.composite_tile_inputs = composite_tile_inputs
        return self

    def __exit__(self, *exc):
        self.mod.mesh_tile_inputs, self.mod.composite_tile_inputs = self._orig

    def bound_s(self) -> dict:
        """{"K1", "K2", "K3": (launches, bound seconds)}."""
        return {k: (len(v), sum(bound_s(b) for b in v))
                for k, v in (("K1", self.k1), ("K2", self.k2), ("K3", self.k3))}
