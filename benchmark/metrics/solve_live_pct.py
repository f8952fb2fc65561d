"""``solve_live_pct``: of the rows that the surface solve's evaluations
ran on, the share still valid and unfinished as each evaluation started,
over the span pass's steps (the port's counters 100 · ``solve.live`` /
``solve.rows``), in %. The rest is work on finished or invalid rays."""

from ._spans import counters


def read(run: dict):
    c = counters(run)
    return 100.0 * c["solve.live"] / c["solve.rows"] if c.get("solve.rows") else None
