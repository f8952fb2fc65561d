"""``fl_ms``: the mean of the ``fl`` phase of ``train_step`` over the
unprofiled steps of the traced run's window (CUDA events), in ms."""

from ._phase import phase_mean


def read(run: dict):
    return phase_mean(run, "fl")
