"""``launches_per_step``: device kernels in the profiled tail per step
(every kernel launch, the ctypes-launched K1–K3 among them)."""


def read(run: dict):
    p = run.get("profile")
    return p["launches"] / p["steps"] if p and p["launches"] else None
