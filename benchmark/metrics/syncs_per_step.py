"""``syncs_per_step``: the host's stream, device and event synchronizations
and blocking copies in the profiled tail per step."""


def read(run: dict):
    p = run.get("profile")
    return p["syncs"] / p["steps"] if p and p["launches"] else None
