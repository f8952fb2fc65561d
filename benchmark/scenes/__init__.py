"""Scenes that a configuration brings as a file of its own.

A configuration's ``scene`` block names the frozen generator
(``"generator"``: ``reference/recmv/data/synthetic.py`` and its three
built-in scenes) or a module of this package (``"module": "<name>"`` for
``scenes/<name>.py``). Such a module provides

- ``generate_scene(out_dir, n_frames, image_size, skinner_res,
  raster_cap, device)``, which writes the scene and returns ``out_dir``;
- ``curve_rings()``: ``[(curve name, (n, 3) float32 ring)]`` in canonical
  space, the rings the curves are fitted to;
- ``SCENE_VERSION``, part of the scene cache's key.

It may import numpy, torch, scipy and the frozen copy
(``benchmark.reference.recmv``), and nothing of the port. It adds its
garments and rings and leaves the rest to ``render.render_scene``: the
copy's body, pose, camera and file layout, so that every configuration
poses the same body.
"""
