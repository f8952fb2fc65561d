"""Checkpoint files: the pickled state dict that ``save_checkpoint`` of
either package writes.

The JAX package's pickles hold instances of its own classes (the skinner's
``recmv_tpu.models.skinner.SkinnerParams``), so a plain ``pickle.load``
would import ``recmv_tpu`` and with it JAX. ``read_checkpoint`` maps every
class of that package to a plain attribute record of the same name and
never imports it; a pickle that names a JAX class is refused.
"""

from __future__ import annotations

import os
import pickle


class PackageRecord:
    """Stand-in for an instance of a JAX-package class: its pickled
    attributes, nothing else."""

    def __setstate__(self, state):
        if isinstance(state, tuple) and len(state) == 2:    # (__dict__, __slots__ values)
            state = {**(state[0] or {}), **(state[1] or {})}
        self.__dict__.update(state)


class CheckpointUnpickler(pickle.Unpickler):
    """``pickle.Unpickler`` that reads the JAX package's classes as
    ``PackageRecord`` subclasses and refuses JAX's own."""

    def find_class(self, module, name):
        top = module.split(".")[0]
        if top == "recmv_tpu":
            return type(name, (PackageRecord,), {"source": f"{module}.{name}"})
        if top in ("jax", "jaxlib"):
            raise pickle.UnpicklingError(
                f"the checkpoint holds a JAX object ({module}.{name}); save numpy leaves")
        return super().find_class(module, name)


def read_checkpoint(path: str) -> dict:
    """The state dict of a checkpoint written by either package."""
    with open(path, "rb") as f:
        return CheckpointUnpickler(f).load()


def write_checkpoint(path: str, state: dict) -> None:
    """Pickle ``state`` to ``path``, creating its directory."""
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    with open(path, "wb") as f:
        pickle.dump(state, f)
