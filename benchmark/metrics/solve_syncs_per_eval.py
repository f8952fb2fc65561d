"""``solve_syncs_per_eval``: the host's synchronizations (``trace.SYNC``)
inside the port's ``solve/*`` spans in the span pass per Newton
evaluation (``solve.evals``); 1 where the stop test's read is the only
one."""

from ._spans import solve_per_eval


def read(run: dict):
    return solve_per_eval(run, "syncs")
