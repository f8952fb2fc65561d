"""The mean over the window's steps of one phase of ``train_step``'s timer
hook (CUDA events), in ms."""

from __future__ import annotations


def phase_mean(run: dict, phase: str, only_remeshed: bool = False):
    rows = [p[phase] for p, r in zip(run.get("phase_ms", []), run.get("remeshed", []))
            if phase in p and (r or not only_remeshed)]
    return sum(rows) / len(rows) if rows else None
