"""``device_idle_pct``: 1 − (device-busy time per step, the union of the
device's intervals in the profiled tail) / (step time of the traced run's
unprofiled part), in %. The divisor is not the profiler's own wall time,
which the profiler stretches."""


def read(run: dict):
    p = run.get("profile")
    if not p or p["busy_s"] <= 0 or not run.get("steps"):
        return None
    step_s = run["window_s"] / run["steps"]
    return 100.0 * (1.0 - (p["busy_s"] / p["steps"]) / step_s)
