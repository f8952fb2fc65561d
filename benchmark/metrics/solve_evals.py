"""``solve_evals``: the surface solve's Newton evaluations per garment
solve over the span pass's steps (the port's counters ``solve.evals`` /
``solve.calls``); at most the solver's ``times`` + 1, fewer where every
ray converged or left the unfinished set early."""

from ._spans import counters


def read(run: dict):
    c = counters(run)
    return c["solve.evals"] / c["solve.calls"] if c.get("solve.calls") else None
