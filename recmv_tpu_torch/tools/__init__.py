"""The port's measurement, evaluation, scene-preparation and visualization
programs (counterparts of the repo's ``tools/bench_*.py``,
``eval_chamfer.py``, ``compute_CSI.py``, ``fitting_garment_meshes.py``,
``generate_normals.py``, ``parsing_mask_to_fl.py``, ``visualize.py``,
``visualize_curve.py``, ``comparison_results.py`` and
``preprocess/mask2parsing_mask.py``), each run as ``python -m
recmv_tpu_torch.tools.<name>`` and callable as ``main(argv)``.

They run on the CUDA card (``--device cuda``, the default) and raise
without one; ``--device cpu`` runs them on the CPU (the tests);
``mask2parsing_mask`` runs on the host. Records
and cached scenes go under ``recmv_tpu_torch/_bench/`` (not committed),
never the repo root, whose ``bench_*.json`` are the JAX package's TPU
records; each record's ``device`` names the card and its power limit.
"""

from __future__ import annotations

import json
import os
import os.path as osp
import subprocess
import time

import torch

BENCH_DIR = osp.join(osp.dirname(osp.dirname(osp.abspath(__file__))), "_bench")
REPO = osp.dirname(osp.dirname(osp.dirname(osp.abspath(__file__))))


def bench_path(*parts) -> str:
    """A path under ``recmv_tpu_torch/_bench/``."""
    return osp.join(BENCH_DIR, *parts)


def card_line() -> str:
    """The card's name and power limit as ``nvidia-smi`` gives them."""
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def device_record(device: torch.device) -> dict:
    """{"device", "platform"} of a record: the card's name and power limit
    and "gpu", or "cpu" and "cpu"."""
    if device.type == "cuda":
        return {"device": card_line(), "platform": "gpu"}
    return {"device": "cpu", "platform": "cpu"}


def sync(device: torch.device) -> None:
    """Wait for the device's work (a host clock around it then covers it)."""
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def write_record(path: str, record: dict) -> dict:
    """Stamp ``record`` with the time, write it as JSON to ``path`` and print
    it on one line."""
    record["measured_utc"] = time.strftime("%Y-%m-%dT%H:%M:%SZ", time.gmtime())
    os.makedirs(osp.dirname(osp.abspath(path)), exist_ok=True)
    with open(path, "w") as f:
        json.dump(record, f, indent=1)
    print(json.dumps(record), flush=True)
    return record


class PhaseClock:
    """Per-phase milliseconds of one training step: ``mark`` is
    ``train_step``'s ``timer`` hook; on the card each mark records a CUDA
    event (as ``chip_smoke.timed_train_step``), on the CPU it reads the host
    clock. ``read()`` → {phase: ms} after the step's work is done."""

    def __init__(self, device: torch.device):
        self.cuda = device.type == "cuda"
        self.marks = [("start", self._now())]

    def _now(self):
        if self.cuda:
            e = torch.cuda.Event(enable_timing=True)
            e.record()
            return e
        return time.perf_counter()

    def mark(self, name: str) -> None:
        self.marks.append((name, self._now()))

    def read(self) -> dict:
        out = {}
        for (_, a), (name, b) in zip(self.marks, self.marks[1:]):
            ms = a.elapsed_time(b) if self.cuda else (b - a) * 1e3
            out[name] = out.get(name, 0.0) + ms
        return out


def timed_step(net, batch, fids, ratio, generator) -> tuple:
    """One ``train_step`` under a host clock that ends in a synchronize, with
    per-phase ms → (loss, info, seconds, {phase: ms})."""
    clock = PhaseClock(net.device)
    t0 = time.perf_counter()
    loss, info = net.train_step(batch, fids, ratio, generator=generator, timer=clock.mark)
    sync(net.device)
    return loss, info, time.perf_counter() - t0, clock.read()
