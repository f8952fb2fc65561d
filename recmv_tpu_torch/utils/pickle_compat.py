"""Read a ``joblib.dump`` file without joblib (the TCMR output a scene
ships as ``<garment>_tcmr_output.pkl``); plain pickles read too.

joblib's uncompressed format is a pickle in which each numpy array is
written as a ``joblib.numpy_pickle.NumpyArrayWrapper`` (the array's
subclass, shape, order and dtype), and the array's raw bytes follow that
object's ``BUILD`` opcode in the stream, after one byte giving an
alignment pad and the pad itself (joblib ≥ 1.2; older dumps have no pad).
The C unpickler cannot stop after a ``BUILD`` to read raw bytes, so this
reader subclasses the pure-Python ``pickle._Unpickler``, maps the wrapper
class to a local stub and reads the array where joblib's own
``NumpyUnpickler.load_build`` does. Compressed dumps (zlib, gzip, bz2,
lzma, xz, lz4) raise :class:`CompressedDumpError`.

Unpickling runs code named by the file: read only files the scene's own
preprocessing wrote.
"""

from __future__ import annotations

import pickle

import numpy as np

_COMPRESSED_MAGIC = {b"\x78": "zlib", b"\x1f\x8b": "gzip", b"BZ": "bz2",
                     b"\x5d\x00": "lzma", b"\xfd7zXZ": "xz", b"\x04\x22\x4d\x18": "lz4"}


class CompressedDumpError(ValueError):
    """The file is a compressed joblib dump, which this reader does not
    decompress."""


class _ArrayWrapper:
    """Stands for ``joblib.numpy_pickle.NumpyArrayWrapper``: ``BUILD`` fills
    its ``subclass``, ``shape``, ``order``, ``dtype`` and, from joblib 1.2
    on, ``numpy_array_alignment_bytes``."""

    def read(self, f) -> np.ndarray:
        """The array whose bytes follow in ``f`` (joblib's
        ``read_array``, without memory mapping)."""
        if self.dtype.hasobject:
            return pickle.load(f)
        if getattr(self, "numpy_array_alignment_bytes", None) is not None:
            pad = int.from_bytes(f.read(1), "little")
            if pad:
                f.read(pad)
        count = int(np.prod(self.shape, dtype=np.int64))
        nbytes = count * self.dtype.itemsize
        data = f.read(nbytes)
        if len(data) != nbytes:
            raise EOFError(f"array data ends after {len(data)} of {nbytes} bytes")
        arr = np.frombuffer(data, dtype=self.dtype).copy()
        if self.order == "F":
            arr = arr.reshape(self.shape[::-1]).transpose()
        else:
            arr = arr.reshape(self.shape)
        if not arr.dtype.isnative:
            arr = arr.astype(arr.dtype.newbyteorder("="))
        return arr


class _JoblibUnpickler(pickle._Unpickler):
    dispatch = pickle._Unpickler.dispatch.copy()

    def __init__(self, f):
        super().__init__(f)
        self._raw = f

    def find_class(self, module, name):
        if module.split(".")[-1] == "numpy_pickle" and name == "NumpyArrayWrapper":
            return _ArrayWrapper
        return super().find_class(module, name)

    def load_build(self):
        pickle._Unpickler.load_build(self)
        if isinstance(self.stack[-1], _ArrayWrapper):
            self.stack.append(self.stack.pop().read(self._raw))

    dispatch[pickle.BUILD[0]] = load_build


def load_joblib(path: str):
    """The object in ``path``: an uncompressed ``joblib.dump`` or a plain
    pickle. Raises :class:`CompressedDumpError` on a compressed dump."""
    with open(path, "rb") as f:
        head = f.read(8)
        for magic, kind in _COMPRESSED_MAGIC.items():
            if head.startswith(magic):
                raise CompressedDumpError(f"{path} is a {kind}-compressed joblib dump; "
                                          "write it with compress=0")
        f.seek(0)
        return _JoblibUnpickler(f).load()
