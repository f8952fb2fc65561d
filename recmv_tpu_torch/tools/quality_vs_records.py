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
run's step count), with the same keys and the same band, and under
``jax_cpu_pallas_scan`` beside the JAX package's run with the port's
visibility scan (``jax_reference --port-scan``: the Pallas binning of the
TPU path, which the port follows; the CPU run's own scan bins as the XLA
path does) where that record exists. ``--rescore`` then scores each
run's final checkpoint again with ``rescore_quality``, which registers a
fresh extraction of its SDF where the run registered its training mesh,
and reports both beside each other (``fresh_vs_training``: the
symmetric chamfer and each garment's one-sided distance, training, fresh
and fresh / training). ``--steps``
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


def jax_cpu_record(name: str, steps: int, records: str = RECORDS,
                   port_scan: bool = False) -> dict | None:
    """Today's JAX package's CPU record of configuration ``name`` at
    ``steps`` steps (``tests/jax_reference.py``; with ``port_scan``, its
    run with the port's visibility scan), None when there is none: a run is
    set only beside a record of its own step count."""
    full = steps_of(CONFIGS[name][0])
    path = osp.join(records, f"jax_cpu_{name}" + ("" if steps == full else f"_steps{steps}")
                    + ("_pallas_scan" if port_scan else "") + ".json")
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


def compare(run: dict, record: dict, jax_cpu: dict | None = None,
            jax_cpu_pallas_scan: dict | None = None) -> dict:
    """One run beside its TPU record and, under ``jax_cpu`` and
    ``jax_cpu_pallas_scan``, beside today's JAX package's CPU records when
    they are given (the same keys, the same band)."""
    out = _beside(run, record)
    out["device"] = run["device"]
    out["seconds"] = {k: run[k] for k in ("t_init_s", "t_train_s", "t_registration_s")}
    if jax_cpu is not None:
        out["jax_cpu"] = _beside(run, jax_cpu)
    if jax_cpu_pallas_scan is not None:
        out["jax_cpu_pallas_scan"] = _beside(run, jax_cpu_pallas_scan)
    return out


def fresh_vs_training(run: dict, fresh: dict) -> dict:
    """A run's scores (its training mesh registered) beside
    ``rescore_quality``'s on its final checkpoint (a fresh extraction
    registered): (training, fresh, fresh / training)."""
    def three(a, b):
        return (a, b, None if not a else round(b / a, 4))

    return {"chamfer_l2_sym_mean": three(run["chamfer_l2_sym_mean"],
                                         fresh["chamfer_l2_sym_mean"]),
            "per_garment_pred_to_gt": {g: three(v, fresh["per_garment_pred_to_gt"].get(g))
                                       for g, v in run["per_garment_pred_to_gt"].items()},
            "device": fresh["device"]}


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
    ap.add_argument("--rescore", action="store_true",
                    help="also score each run's final checkpoint on a fresh extraction "
                         "(rescore_quality) and report it beside the run's own score")
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

    def finish(key, log, proc):
        done[key] = proc.wait()
        log.close()
        print(f"[quality] {key}: exit {done[key]} at {time.time() - t0:.0f} s", flush=True)

    def run_all(jobs):
        for key, cmd in jobs:
            if len(active) >= JOBS:
                finish(*active.pop(0))
            log = open(osp.join(args.out_dir, f"{key}.log"), "w")
            active.append((key, log, subprocess.Popen(cmd, cwd=REPO, stdout=log,
                                                      stderr=subprocess.STDOUT)))
        while active:
            finish(*active.pop(0))

    def bench_args(name, seed):
        return [*with_steps(CONFIGS[name][0], args.steps), "--seed", str(seed),
                "--scene", osp.join(args.scene_dir, f"{name}{tag}_s{seed}")]

    run_all([] if args.no_run else [
        (f"{name}{tag}_s{seed}",
         [sys.executable, "-m", "recmv_tpu_torch.tools.bench_quality", *bench_args(name, seed),
          "--out", osp.join(args.out_dir, f"{name}{tag}_s{seed}.json")])
        for name, seed in runs])
    if args.rescore and not args.no_run:
        from .bench_quality import parse_args, scene_path

        run_all([(f"{name}{tag}_s{seed}_rescore",
                  [sys.executable, "-m", "recmv_tpu_torch.tools.rescore_quality", "--ckpt",
                   osp.join(scene_path(parse_args(bench_args(name, seed))), "result",
                            f"quality_final_s{seed}.ckpt"), *bench_args(name, seed),
                   "--out", osp.join(args.out_dir, f"{name}{tag}_s{seed}_rescore.json")])
                 for name, seed in runs if done.get(f"{name}{tag}_s{seed}") == 0])
    report = {}
    for name, seed in runs:
        key = f"{name}{tag}_s{seed}"
        if done.get(key, 0) != 0:
            report[key] = {"exit": done[key]}
            continue
        with open(osp.join(args.out_dir, f"{key}.json")) as f:
            run = json.load(f)
        with open(osp.join(REPO, CONFIGS[name][1])) as f:
            record = json.load(f)
        report[key] = compare(run, record, jax_cpu_record(name, run["config"]["steps"]),
                              jax_cpu_record(name, run["config"]["steps"], port_scan=True))
        report[key]["init_curve_fit"] = run.get("init_curve_fit")
        rescored = osp.join(args.out_dir, f"{key}_rescore.json")
        if done.get(f"{key}_rescore", 0) != 0:
            report[key]["fresh_vs_training"] = {"exit": done[f"{key}_rescore"]}
        elif args.rescore and osp.isfile(rescored):
            with open(rescored) as f:
                report[key]["fresh_vs_training"] = fresh_vs_training(run, json.load(f))
    with open(osp.join(args.out_dir, f"report{tag}.json"), "w") as f:
        json.dump(report, f, indent=1)
    for key, rec in report.items():
        print(f"[quality] {key}: {json.dumps(rec)}", flush=True)
    failed = [k for k, v in report.items()
              if "exit" in v or "exit" in v.get("fresh_vs_training", {})]
    if failed:
        raise RuntimeError(f"bench_quality failed: {failed} (logs in {args.out_dir})")
    return report


if __name__ == "__main__":
    main()
