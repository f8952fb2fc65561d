"""``step_mfu_pct``: the model FLOPs of a step (``flops.py``, from the
cell's shapes and the configuration's widths) × steps / seconds of the
traced run's unprofiled window, over the float32 peak, in %."""

from ..peaks import FP32_FLOP_PER_S


def read(run: dict):
    f = run.get("flops_per_step")
    if not f or not run.get("steps"):
        return None
    return 100.0 * f * run["steps"] / run["window_s"] / FP32_FLOP_PER_S
