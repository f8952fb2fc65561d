"""``kernel_roofline_pct``: Σ bound over Σ device time of every K1, K2 and
K3 launch in the profiled tail, in %; the bound from the frozen counts of
``kernel_work.py``. Nothing where no K1–K3 launch ran in the tail; a tail
whose launches differ in number from the problems recorded stops the run
(``run.profile_tail``)."""


def read(run: dict):
    p = run.get("profile")
    if not p or not p.get("kernel_bound"):
        return None
    dev = sum(p["kernel_s"].values())
    bound = sum(b for _, b in p["kernel_bound"].values())
    return 100.0 * bound / dev if dev > 0 else None
