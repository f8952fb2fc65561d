"""The cell's scene: the frozen copy of the port's synthetic-scene
generator (``reference/recmv/data/synthetic.py``, the plain rasterizer),
or the scene module that the configuration names (``scenes/<module>.py``),
writes the frames that both the port and the reference read, and gives
the feature curves' canonical rings. The scene does not depend on the
seed: every seed trains on the same frames, in another order. So a run
keeps it under ``TMPDIR`` at a path fixed by its parameters, and a later
run there reads it again (``cached``)."""

from __future__ import annotations

import hashlib
import importlib
import json
import os
import os.path as osp
import shutil
import tempfile

import numpy as np

from .reference.recmv.data import synthetic
from .reference.recmv.geometry.polygons import uniform_sample_3d

CURVE_POINTS = 200


def scene_module(config: dict):
    """The module ``scenes/<module>.py`` that the configuration's scene
    names, or None for the frozen generator."""
    name = config["scene"].get("module")
    return None if name is None else importlib.import_module(f"{__package__}.scenes.{name}")


def generate(out_dir: str, config: dict, traffic: dict, device) -> str:
    """Write the scene of ``config`` at the traffic's image size and frame
    count into ``out_dir`` on ``device``."""
    sc = config["scene"]
    mod = scene_module(config)
    if mod is not None:
        return mod.generate_scene(out_dir, n_frames=traffic["frames"],
                                  image_size=traffic["image"],
                                  skinner_res=tuple(sc["skinner_res"]),
                                  raster_cap=sc["raster_cap"], device=device)
    return synthetic.generate_scene(out_dir, n_frames=traffic["frames"],
                                    image_size=traffic["image"],
                                    skinner_res=tuple(sc["skinner_res"]),
                                    raster_cap=sc["raster_cap"],
                                    garment_type=sc["generator"], device=device)


def cached(config: dict, traffic: dict, device) -> str:
    """The scene's directory under ``TMPDIR``: made by ``generate`` on the first
    run there (into a temporary name, then renamed), read as it is by
    later ones. The name carries the generator's parameters (a scene
    module's version in place of the frozen generator's); a directory
    without the generator's last file (``scene_meta.json``) is made anew."""
    sc, mod = config["scene"], scene_module(config)
    key = {"scene": sc, "image": traffic["image"], "frames": traffic["frames"],
           "version": synthetic.SCENE_VERSION if mod is None else mod.SCENE_VERSION}
    tag = hashlib.sha1(json.dumps(key, sort_keys=True).encode()).hexdigest()[:12]
    root = osp.join(tempfile.gettempdir(), "recmv_bench_scenes")
    final = osp.join(root, f"{sc['generator'] if mod is None else sc['module']}_"
                           f"{traffic['image']}_{traffic['frames']}_{tag}")
    if osp.isfile(osp.join(final, "scene_meta.json")):
        return final
    os.makedirs(root, exist_ok=True)
    part = tempfile.mkdtemp(prefix="part_", dir=root)
    try:
        generate(part, config, traffic, device)
        shutil.rmtree(final, ignore_errors=True)
        os.rename(part, final)
    finally:
        shutil.rmtree(part, ignore_errors=True)
    return final


def curves(config: dict) -> tuple:
    """``align_fl``'s arguments as an exact fit gives them: each curve its
    canonical boundary ring resampled to 200 points, aligned = template,
    t = 0, s = 1."""
    mod = scene_module(config)
    if mod is None:
        raw = [(name, synthetic.boundary_ring(y, offset=off))
               for name, y, off in synthetic.SCENE_CURVES[config["scene"]["generator"]]]
    else:
        raw = mod.curve_rings()
    rings = {name: uniform_sample_3d(ring, CURVE_POINTS).astype(np.float32) for name, ring in raw}
    rigid = {name: (np.zeros(3, np.float32), np.float32(1.0)) for name in rings}
    return rings, rings, rigid
