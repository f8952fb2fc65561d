"""A crop top: one tube from under the arms to above the navel, looser
than the built-in tube, with the curves ``neck`` and ``bottom_curve``.
No cell of ``BENCHMARK.json`` uses it; the harness's tests run a
configuration on it (garment type ``bench-crop-top``, which neither the
frozen copy nor the port lists) to show that a configuration can bring its
scene and garment set as new files."""

from __future__ import annotations

import numpy as np

from ..reference.recmv.data.synthetic import boundary_ring, garment_mesh
from .render import render_scene

SCENE_VERSION = 1
GARMENT_TYPE = "bench-crop-top"
OFFSET = 0.035
BAND = (-0.1, 0.23)


def curve_rings() -> list:
    return [("neck", boundary_ring(BAND[1] - 0.01, offset=OFFSET).astype(np.float32)),
            ("bottom_curve", boundary_ring(BAND[0] + 0.01, offset=OFFSET).astype(np.float32))]


def generate_scene(out_dir, n_frames, image_size, skinner_res, raster_cap, device) -> str:
    return render_scene(out_dir, n_frames, image_size, skinner_res, raster_cap, device,
                        garment_type=GARMENT_TYPE, version=SCENE_VERSION,
                        pieces=[("tube", garment_mesh(offset=OFFSET, band=BAND), 4)],
                        rings=curve_rings())
