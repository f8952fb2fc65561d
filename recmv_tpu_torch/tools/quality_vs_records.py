"""Run ``bench_quality`` on the three configurations the JAX package
recorded on a TPU and set each run beside its record.

    python -m recmv_tpu_torch.tools.quality_vs_records [--seeds 0 1] \\
        [--configs tube512_gateon two skirt]

Each (configuration, seed) runs as its own ``python -m
recmv_tpu_torch.tools.bench_quality`` process on the card, with its own
scene directory, all at once (the steps are launch-bound, so the
processes share the card well; their seconds are then those of a shared
card and host). Records and logs go to
``--out-dir`` (``recmv_tpu_torch/_bench/quality/``), the scenes with their
checkpoints to ``--scene-dir``. The report
(``report.json``, and printed) gives per run its ``chamfer_l2_sym_mean``
and the ratio to the record's, ``pred_to_gt_dist_mean``, the per-garment
scores, the seam gap, both trends beside the record's at each probe step,
and the first probe step where the port's ``mc_pred_to_gt_trend`` leaves
0.75–1.33× of the record's; and whether the run's configuration equals
the record's. The root records are the JAX package's on a TPU v5e: they
are read here for the comparison and never written.
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


def compare(run: dict, record: dict) -> dict:
    """One run beside its TPU record."""
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
        "device": run["device"],
        "seconds": {k: run[k] for k in ("t_init_s", "t_train_s", "t_registration_s")},
    }


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--configs", nargs="+", default=list(CONFIGS), choices=list(CONFIGS))
    ap.add_argument("--seeds", nargs="+", type=int, default=[0, 1])
    ap.add_argument("--out-dir", default=bench_path("quality"), help="records, logs, report")
    ap.add_argument("--scene-dir", default=bench_path("scenes"), help="the runs' scenes")
    args = ap.parse_args(argv)
    os.makedirs(args.out_dir, exist_ok=True)
    runs = [(name, seed) for name in args.configs for seed in args.seeds]
    active, done = [], {}
    t0 = time.time()
    for name, seed in runs:
        cmd = [sys.executable, "-m", "recmv_tpu_torch.tools.bench_quality", *CONFIGS[name][0],
               "--seed", str(seed), "--scene", osp.join(args.scene_dir, f"{name}_s{seed}"),
               "--out", osp.join(args.out_dir, f"{name}_s{seed}.json")]
        log = open(osp.join(args.out_dir, f"{name}_s{seed}.log"), "w")
        active.append((name, seed, log, subprocess.Popen(cmd, cwd=REPO, stdout=log,
                                                         stderr=subprocess.STDOUT)))
    for name, seed, log, proc in active:
        done[(name, seed)] = proc.wait()
        log.close()
        print(f"[quality] {name} seed {seed}: exit {done[(name, seed)]} at "
              f"{time.time() - t0:.0f} s", flush=True)
    report = {}
    for name, seed in runs:
        if done[(name, seed)] != 0:
            report[f"{name}_s{seed}"] = {"exit": done[(name, seed)]}
            continue
        with open(osp.join(args.out_dir, f"{name}_s{seed}.json")) as f:
            run = json.load(f)
        with open(osp.join(REPO, CONFIGS[name][1])) as f:
            record = json.load(f)
        report[f"{name}_s{seed}"] = compare(run, record)
    with open(osp.join(args.out_dir, "report.json"), "w") as f:
        json.dump(report, f, indent=1)
    for key, rec in report.items():
        print(f"[quality] {key}: {json.dumps(rec)}", flush=True)
    failed = [k for k, v in report.items() if "exit" in v]
    if failed:
        raise RuntimeError(f"bench_quality failed: {failed} (logs in {args.out_dir})")
    return report


if __name__ == "__main__":
    main()
