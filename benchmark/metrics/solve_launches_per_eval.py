"""``solve_launches_per_eval``: the device kernels launched inside the
port's ``solve/*`` spans in the span pass per Newton evaluation
(``solve.evals``)."""

from ._spans import solve_per_eval


def read(run: dict):
    return solve_per_eval(run, "launches")
