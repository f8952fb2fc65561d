"""The span pass's record (``spans.py``): the port's counters, and a
count over the surface solve's spans per Newton evaluation."""

from __future__ import annotations


def counters(run: dict) -> dict:
    return (run.get("spans") or {}).get("counters") or {}


def solve_per_eval(run: dict, key: str):
    """Σ ``key`` ("launches", "syncs") over the ``solve/*`` spans of the span
    pass over its ``solve.evals``."""
    s = run.get("spans")
    evals = counters(run).get("solve.evals")
    if not s or not evals:
        return None
    n = sum(r[key] for lab, r in s["by_span"].items() if lab.startswith("solve/"))
    return n * s["steps"] / evals
