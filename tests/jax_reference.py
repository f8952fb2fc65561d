"""Run the JAX package's ``tools/bench_quality.py`` on the CPU at the
configurations of ``quality_vs_records`` and keep its records as the port's
reference of today's JAX package.

    python tests/jax_reference.py tube512_gateon --steps 1 \\
        --scene-dir <dir> [--cpus 2-4] [--reuse-init]

A harness of the tests side, not part of the port and not a test: it
needs a machine with the JAX package's dependencies (the card's machine
has no JAX), and runs the tool as its own process (``python
tools/bench_quality.py --platform cpu ...``), never imported. The port
keeps only the records it writes and their reader
(``quality_vs_records.jax_cpu_record``).
``--steps`` overrides the configuration's step count (``--steps 1`` is the
initialization and the step-0 probe: ``mc_pred_to_gt_trend["0"]`` is taken
before training). Each run gets the scene directory ``<scene-dir>/<name>``;
the JAX tool caches its initialization there as
``result/quality_init.ckpt`` and loads it when it exists, so a fresh
directory means a fresh initialization. ``--reuse-init`` allows a
directory that already holds one (made by this same code, e.g. a
``--steps 1`` run before the full one); the record then says so
(``init_reused``). The JAX tool also reuses a registration cached in the
scene's ``result/infer/`` (the TPU tube record with the gate on did:
``t_registration_s`` 0.1), which would score this run's exports through
the earlier run's registered template, so ``--reuse-init`` deletes that
directory first. ``--cpus`` pins the process to those cores
(``taskset``; XLA sizes its thread pool to them).

The record, ``records/jax_cpu_<name>[_steps<N>].json`` (the suffix when
``--steps`` differs from the configuration's), is the tool's JSON with
``jax_cpu`` added: the CPU model (``lscpu``), the cores, the command and
the wall seconds. Its numbers are CPU figures.

``--export DIR`` runs nothing: it copies the JAX run's scene and cached
initialization to ``DIR`` in the layout the port's ``bench_quality`` reads
(the port's ``scene_meta.json``, the skinner cache, the initialization as
``result/quality_init_s0.ckpt`` and the trained state, where the run
saved one, as ``result/jax_final.ckpt`` for ``rescore_quality``), so that

    python -m recmv_tpu_torch.tools.bench_quality <the configuration's flags> \
        --seed 0 --scene DIR/<name>

starts from the JAX package's initialized state on its scene.
"""

from __future__ import annotations

import argparse
import json
import os
import os.path as osp
import shutil
import subprocess
import sys
import time

import numpy as np

sys.path.insert(0, osp.dirname(osp.dirname(osp.abspath(__file__))))

from recmv_tpu_torch.tools import REPO  # noqa: E402
from recmv_tpu_torch.tools.bench_quality import SKINNER_RES  # noqa: E402
from recmv_tpu_torch.tools.quality_vs_records import (CONFIGS, RECORDS, steps_of,  # noqa: E402
                                                      with_steps)


def cpu_model() -> str:
    """``lscpu``'s model name."""
    out = subprocess.run(["lscpu"], capture_output=True, text=True, check=True).stdout
    return next((ln.split(":", 1)[1].strip() for ln in out.splitlines()
                 if ln.startswith("Model name")), "unknown")


def record_name(name: str, steps: int) -> str:
    return f"jax_cpu_{name}" + ("" if steps == steps_of(CONFIGS[name][0]) else f"_steps{steps}")


def scene_of(name: str) -> tuple:
    """(directory name under ``--scene-dir``, image size, frames, garment
    type) of configuration ``name``'s scene: both tools append
    ``_<image>_<frames>[_two|_skirt]`` to ``--scene`` (defaults: 256 px, 8
    frames, the tube)."""
    args = CONFIGS[name][0]
    flag = {a: b for a, b in zip(args, args[1:] + [""]) if a.startswith("--")}
    image, frames = int(flag.get("--image", 256)), int(flag.get("--frames", 8))
    garment_type = flag.get("--garment-type", "synthetic-tube")
    suffix = {"synthetic-two": "_two", "synthetic-skirt": "_skirt"}.get(garment_type, "")
    return f"{name}_{image}_{frames}{suffix}", image, frames, garment_type


def export_for_port(scene_dir: str, name: str, dest: str) -> str:
    """Copy the JAX run's scene of configuration ``name`` and its
    ``quality_init.ckpt`` to ``dest`` for the port's ``bench_quality``
    (module docstring). Returns the port's scene directory."""
    from recmv_tpu_torch.data.synthetic import _scene_meta

    leaf, image, frames, garment_type = scene_of(name)
    src, out = osp.join(scene_dir, leaf), osp.join(dest, leaf)
    shutil.copytree(src, out, ignore=lambda d, names: [
        n for n in names if d == osp.join(src, "result") and n != "initial_skinner_0.npz"])
    shutil.copy(osp.join(src, "result", "quality_init.ckpt"),
                osp.join(out, "result", "quality_init_s0.ckpt"))
    if osp.isfile(osp.join(src, "result", "quality_final.ckpt")):
        shutil.copy(osp.join(src, "result", "quality_final.ckpt"),
                    osp.join(out, "result", "jax_final.ckpt"))
    # the JAX tool generates with the port tool's defaults for these
    meta = _scene_meta(frames, image, 2 * np.pi, SKINNER_RES, 1024, garment_type)
    with open(osp.join(out, "scene_meta.json"), "w") as f:
        json.dump(meta, f)
    return out


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("config", choices=list(CONFIGS))
    ap.add_argument("--steps", type=int, default=None)
    ap.add_argument("--scene-dir", required=True)
    ap.add_argument("--cpus", default=None, help="cores to pin to, as taskset takes them")
    ap.add_argument("--reuse-init", action="store_true")
    ap.add_argument("--export", default=None, metavar="DIR",
                    help="copy the run's scene and initialization for the port; run nothing")
    args = ap.parse_args(argv)
    if args.export:
        print(f"[jax_reference] {export_for_port(args.scene_dir, args.config, args.export)}")
        return {}
    tool_args = with_steps(CONFIGS[args.config][0], args.steps)
    steps = steps_of(tool_args)
    scene = osp.join(args.scene_dir, args.config)
    cached = osp.isfile(osp.join(args.scene_dir, scene_of(args.config)[0], "result",
                                 "quality_init.ckpt"))
    if cached and not args.reuse_init:
        raise SystemExit(f"{scene}_* holds an initialization; pass --reuse-init to use it")
    shutil.rmtree(osp.join(args.scene_dir, scene_of(args.config)[0], "result", "infer"),
                  ignore_errors=True)
    os.makedirs(args.scene_dir, exist_ok=True)
    out = osp.join(args.scene_dir, record_name(args.config, steps) + ".json")
    cmd = [sys.executable, "-u", osp.join("tools", "bench_quality.py"), "--platform", "cpu",
           *tool_args, "--scene", scene, "--out", out]
    if args.cpus:
        cmd = ["taskset", "-c", args.cpus, *cmd]
    t0 = time.time()
    subprocess.run(cmd, cwd=REPO, check=True)
    wall = time.time() - t0
    with open(out) as f:
        record = json.load(f)
    record["jax_cpu"] = {
        "cpu_model": cpu_model(),
        "cpus": args.cpus or f"all {os.cpu_count()}",
        "command": " ".join({out: "<out>", scene: "<scene>", sys.executable: "python"}.get(c, c)
                            for c in cmd[cmd.index(sys.executable):]),
        "wall_s": round(wall, 1),
        "init_reused": cached,
    }
    os.makedirs(RECORDS, exist_ok=True)
    path = osp.join(RECORDS, record_name(args.config, steps) + ".json")
    with open(path, "w") as f:
        json.dump(record, f, indent=1)
    print(f"[jax_reference] {path}: wall {wall:.1f} s", flush=True)
    return record


if __name__ == "__main__":
    main()
