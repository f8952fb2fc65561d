"""Copy of ``LocalVisualizer`` and ``get_visualizer`` from
``recmv_tpu/utils/visualizer.py``: the port runs where JAX is absent, and
importing any ``recmv_tpu`` module imports JAX. Images are written with
the package's own PNG writer (``data/png.py``) in place of OpenCV, which
that machine lacks. The base class and the wandb backend are not ported:
the machine with the card has no network, and ``get_visualizer`` refuses
``use_wandb``.

Observability: scalar/image logging — reference visualizer parity
(``engineer/visualizer/wandb_visualizer.py`` + base class): scalars and
images per optimization step, with a local JSONL/PNG backend.
"""

from __future__ import annotations

import json
import os
import os.path as osp
import time

import numpy as np

from ..data.png import imwrite


class LocalVisualizer:
    """Scalars → <dir>/scalars.jsonl; images → <dir>/imgs/<tag>_<step>.png."""

    def __init__(self, log_dir: str):
        self.dir = log_dir
        os.makedirs(osp.join(log_dir, "imgs"), exist_ok=True)
        self._f = open(osp.join(log_dir, "scalars.jsonl"), "a")

    def add_scalar(self, tag, value, step):
        self._f.write(json.dumps({"t": time.time(), "step": int(step),
                                  "tag": tag, "value": float(value)}) + "\n")
        self._f.flush()

    def add_scalars(self, scalars: dict, step):
        for k, v in scalars.items():
            if isinstance(v, (int, float)) and np.isfinite(v):
                self.add_scalar(k, v, step)

    def add_image(self, tag, img, step):
        img = np.asarray(img)
        if img.dtype != np.uint8:
            img = np.clip((img + 1) / 2 if img.min() < 0 else img, 0, 1)
            img = (img * 255).astype(np.uint8)
        if img.ndim == 3 and img.shape[-1] == 3:
            img = img[:, :, ::-1]  # RGB → BGR, as imwrite takes it
        safe = tag.replace("/", "_")
        imwrite(osp.join(self.dir, "imgs", f"{safe}_{int(step):06d}.png"), img)

    def close(self):
        self._f.close()


def get_visualizer(log_dir: str, project: str = "recmv_tpu", name: str = "run",
                   use_wandb: bool = False) -> LocalVisualizer:
    """The local backend; ``project`` and ``name`` name a wandb run, and
    ``use_wandb`` is refused (not ported)."""
    if use_wandb:
        raise ValueError("the wandb backend is not ported; the local JSONL/PNG backend is")
    return LocalVisualizer(log_dir)
