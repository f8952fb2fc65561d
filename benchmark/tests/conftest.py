"""The harness's tests compare the port's step with the frozen copy's bit for
bit on the CPU, so both must get the same BLAS arithmetic. MKL picks its
code path from run to run (by memory alignment and the threads it gets)
unless its conditional numerical reproducibility is fixed: without it a
loaded CPU gave the two sides first gradients of ``scene.poses`` a few
ulps apart. MKL reads the setting at its first computation."""

import os

os.environ.setdefault("MKL_CBWR", "COMPATIBLE")
