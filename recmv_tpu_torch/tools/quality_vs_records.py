"""Run ``bench_quality`` on the three configurations the JAX package
recorded on a TPU and set each run beside its record.

    python -m recmv_tpu_torch.tools.quality_vs_records [--seeds 0 1] \\
        [--configs tube512_gateon two skirt] [--steps N]

Each (configuration, seed) runs as its own ``python -m
recmv_tpu_torch.tools.bench_quality`` process on the card, with its own
scene directory, ``JOBS`` (8) at a time (the steps are launch-bound, so
the processes share the card well; their seconds are then those of a
shared card and host; 16 at once ran the card out of memory in their
scoring). Records and logs go to
``--out-dir`` (``recmv_tpu_torch/_bench/quality/``), the scenes with their
checkpoints to ``--scene-dir``. The report
(``report.json``, and printed) gives per run its ``chamfer_l2_sym_mean``
and the ratio to the record's, ``pred_to_gt_dist_mean``, the per-garment
scores, the seam gap, both trends beside the record's at each probe step,
and the first probe step where the port's ``mc_pred_to_gt_trend`` leaves
0.75–1.33× of the record's; and whether the run's configuration equals
the record's. The root records are the JAX package's on a TPU v5e: they
are read here for the comparison and never written. Under ``jax_cpu``
each run stands beside today's JAX package, run on the CPU by
``tests/jax_reference.py`` (``records/jax_cpu_*.json``, the record of the
run's step count), with the same keys and the same band. ``--steps``
overrides every configuration's step count (``--steps 1``: the
initialization and the step-0 probe, e.g. over many seeds); such runs are
named ``<config>_steps<N>_s<seed>`` and reported in
``report_steps<N>.json``; ``--no-run`` only reports, from the records
already in ``--out-dir``.
"""

from __future__ import annotations

import argparse
import json
import os
import os.path as osp
import subprocess
import sys
import time

from . import REPO, bench_path

CONFIGS = {
    "tube512_gateon": (["--image", "512", "--frames", "8", "--steps", "500", "--init-epochs",
                        "400", "--occlusion-gate", "--production-nricp", "--curve-lr", "1e-3"],
                       "bench_quality_512_gateon.json"),
    "two": (["--garment-type", "synthetic-two", "--image", "256", "--steps", "120",
             "--init-epochs", "400"], "bench_quality_two.json"),
    "skirt": (["--garment-type", "synthetic-skirt", "--image", "256", "--steps", "120",
               "--init-epochs", "400"], "bench_quality_skirt.json"),
}
BAND = (0.75, 1.33)
JOBS = 8
RECORDS = osp.join(osp.dirname(osp.abspath(__file__)), "records")


def jax_cpu_record(name: str, steps: int, records: str = RECORDS) -> dict | None:
    """Today's JAX package's CPU record of configuration ``name`` at
    ``steps`` steps (``tests/jax_reference.py``), None when there is none:
    a run is set only beside a record of its own step count."""
    full = steps_of(CONFIGS[name][0])
    path = osp.join(records, f"jax_cpu_{name}" + ("" if steps == full else f"_steps{steps}")
                    + ".json")
    if not osp.isfile(path):
        return None
    with open(path) as f:
        return json.load(f)


def steps_of(args: list) -> int:
    """The ``--steps`` of a configuration's arguments."""
    return int(args[args.index("--steps") + 1])


def with_steps(args: list, steps: int | None) -> list:
    """A configuration's arguments with ``--steps`` set to ``steps``."""
    args = list(args)
    if steps is not None:
        args[args.index("--steps") + 1] = str(steps)
    return args


def compare(run: dict, record: dict, jax_cpu: dict | None = None) -> dict:
    """One run beside its TPU record and, under ``jax_cpu``, beside today's
    JAX package's CPU record when one is given (the same keys, the same
    band)."""
    out = _beside(run, record)
    out["device"] = run["device"]
    out["seconds"] = {k: run[k] for k in ("t_init_s", "t_train_s", "t_registration_s")}
    if jax_cpu is not None:
        out["jax_cpu"] = _beside(run, jax_cpu)
    return out


def _beside(run: dict, record: dict) -> dict:
    def ratio(a, b):
        return None if a is None or not b else round(a / b, 4)

    trend = {k: (v, record["mc_pred_to_gt_trend"].get(k),
                 ratio(v, record["mc_pred_to_gt_trend"].get(k)))
             for k, v in run["mc_pred_to_gt_trend"].items()}
    fresh = {k: (v, record["mc_fresh_to_gt_trend"].get(k),
                 ratio(v, record["mc_fresh_to_gt_trend"].get(k)))
             for k, v in run["mc_fresh_to_gt_trend"].items()}
    leaves = [int(k) for k, (_, _, r) in trend.items()
              if r is not None and not BAND[0] <= r <= BAND[1]]
    same_config = {k: (run["config"].get(k), v) for k, v in record["config"].items()
                   if run["config"].get(k) != v}
    return {
        "chamfer_l2_sym_mean": (run["chamfer_l2_sym_mean"], record["chamfer_l2_sym_mean"],
                                ratio(run["chamfer_l2_sym_mean"],
                                      record["chamfer_l2_sym_mean"])),
        "pred_to_gt_dist_mean": (run["pred_to_gt_dist_mean"], record["pred_to_gt_dist_mean"],
                                 ratio(run["pred_to_gt_dist_mean"],
                                       record["pred_to_gt_dist_mean"])),
        "per_garment_pred_to_gt": {g: (v, record.get("per_garment_pred_to_gt", {}).get(g))
                                   for g, v in run["per_garment_pred_to_gt"].items()},
        "waist_seam_gap": (run["waist_seam_gap"], record.get("waist_seam_gap")),
        "mc_pred_to_gt_trend": trend,
        "mc_fresh_to_gt_trend": fresh,
        "trend_leaves_band_at": min(leaves) if leaves else None,
        "in_band": BAND[0] <= run["chamfer_l2_sym_mean"] / record["chamfer_l2_sym_mean"]
        <= BAND[1],
        "config_differs": same_config,
    }


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--configs", nargs="+", default=list(CONFIGS), choices=list(CONFIGS))
    ap.add_argument("--seeds", nargs="+", type=int, default=[0, 1])
    ap.add_argument("--steps", type=int, default=None,
                    help="override the configurations' step counts (1: the initialization "
                         "and the step-0 probe)")
    ap.add_argument("--no-run", action="store_true",
                    help="only report, from the records already in --out-dir")
    ap.add_argument("--out-dir", default=bench_path("quality"), help="records, logs, report")
    ap.add_argument("--scene-dir", default=bench_path("scenes"), help="the runs' scenes")
    args = ap.parse_args(argv)
    os.makedirs(args.out_dir, exist_ok=True)
    runs = [(name, seed) for name in args.configs for seed in args.seeds]
    tag = "" if args.steps is None else f"_steps{args.steps}"
    active, done = [], {}
    t0 = time.time()

    def finish(name, seed, log, proc):
        done[(name, seed)] = proc.wait()
        log.close()
        print(f"[quality] {name} seed {seed}: exit {done[(name, seed)]} at "
              f"{time.time() - t0:.0f} s", flush=True)

    for name, seed in [] if args.no_run else runs:
        if len(active) >= JOBS:
            finish(*active.pop(0))
        cmd = [sys.executable, "-m", "recmv_tpu_torch.tools.bench_quality",
               *with_steps(CONFIGS[name][0], args.steps), "--seed", str(seed),
               "--scene", osp.join(args.scene_dir, f"{name}{tag}_s{seed}"),
               "--out", osp.join(args.out_dir, f"{name}{tag}_s{seed}.json")]
        log = open(osp.join(args.out_dir, f"{name}{tag}_s{seed}.log"), "w")
        active.append((name, seed, log, subprocess.Popen(cmd, cwd=REPO, stdout=log,
                                                         stderr=subprocess.STDOUT)))
    for job in active:
        finish(*job)
    report = {}
    for name, seed in runs:
        key = f"{name}{tag}_s{seed}"
        if done.get((name, seed), 0) != 0:
            report[key] = {"exit": done[(name, seed)]}
            continue
        with open(osp.join(args.out_dir, f"{key}.json")) as f:
            run = json.load(f)
        with open(osp.join(REPO, CONFIGS[name][1])) as f:
            record = json.load(f)
        report[key] = compare(run, record, jax_cpu_record(name, run["config"]["steps"]))
        report[key]["init_curve_fit"] = run.get("init_curve_fit")
    with open(osp.join(args.out_dir, f"report{tag}.json"), "w") as f:
        json.dump(report, f, indent=1)
    for key, rec in report.items():
        print(f"[quality] {key}: {json.dumps(rec)}", flush=True)
    failed = [k for k, v in report.items() if "exit" in v]
    if failed:
        raise RuntimeError(f"bench_quality failed: {failed} (logs in {args.out_dir})")
    return report


if __name__ == "__main__":
    main()
