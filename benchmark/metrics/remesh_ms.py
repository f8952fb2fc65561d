"""``remesh_ms``: the mean of the ``remesh`` phase over the window's steps
that remeshed (CUDA events), in ms; nothing where none did."""

from ._phase import phase_mean


def read(run: dict):
    return phase_mean(run, "remesh", only_remeshed=True)
