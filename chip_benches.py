"""Run the port's benches on the card, each in its own process, in the
order and with the arguments ``PERF.md`` reports:

    python3 chip_benches.py [--out-dir recmv_tpu_torch/_bench/benches]

1. ``python -m recmv_tpu_torch.tools.bench_fullstep`` with its defaults
   (1080², the fine pyramid, 2,048 rays, batch 1, 4 timed steps);
2. the same with ``--sustain 20`` (the scene and its initialization
   cached by run 1);
3. ``python -m recmv_tpu_torch.tools.bench_largepose`` with its defaults;
4. ``python -m recmv_tpu_torch.tools.bench_animation`` with its defaults
   (run 1's scene and initialization);
5. ``python -m recmv_tpu_torch.bench`` with its defaults, embedding the
   records of runs 1, 3 and 4.

Each record is written to ``--out-dir`` (named as the repo root's TPU
records, ``bench_fullstep_sustain.json`` for run 2) with a log beside it;
the scenes go to ``recmv_tpu_torch/_bench/``. It stops at the first run
that fails, and exits with its code. Without a CUDA device the benches
raise: they do not run on the CPU unless told to.
"""

from __future__ import annotations

import argparse
import os
import os.path as osp
import subprocess
import sys
import time

ROOT = osp.dirname(osp.abspath(__file__))


def runs(out: str) -> list:
    tools = "recmv_tpu_torch.tools."
    return [("bench_fullstep", tools + "bench_fullstep", ["--out", f"{out}/bench_fullstep.json"]),
            ("bench_fullstep_sustain", tools + "bench_fullstep",
             ["--sustain", "20", "--out", f"{out}/bench_fullstep_sustain.json"]),
            ("bench_largepose", tools + "bench_largepose",
             ["--out", f"{out}/bench_largepose.json"]),
            ("bench_animation", tools + "bench_animation",
             ["--out", f"{out}/bench_animation.json"]),
            ("bench", "recmv_tpu_torch.bench", ["--bench-dir", out])]


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--out-dir", default=osp.join("recmv_tpu_torch", "_bench", "benches"))
    args = ap.parse_args()
    out = osp.abspath(args.out_dir)
    os.makedirs(out, exist_ok=True)
    for name, module, argv in runs(out):
        t0 = time.time()
        with open(osp.join(out, f"{name}.log"), "w") as log:
            rc = subprocess.run([sys.executable, "-m", module, *argv], cwd=ROOT, stdout=log,
                                stderr=subprocess.STDOUT).returncode
        print(f"[benches] {name}: exit {rc} in {time.time() - t0:.1f} s", flush=True)
        if rc != 0:
            return rc
    return 0


if __name__ == "__main__":
    sys.exit(main())
