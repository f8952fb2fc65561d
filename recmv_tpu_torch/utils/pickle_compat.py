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
``NumpyUnpickler.load_build`` does. A compressed dump is that same stream
in a zlib, gzip, bz2, lzma (``FORMAT_ALONE``) or xz container, which the
standard library opens; lz4 needs the ``lz4`` package and joblib < 0.10's
``ZF`` format keeps its arrays in side files, so both raise
:class:`CompressedDumpError`.

Unpickling runs code named by the file: read only files the scene's own
preprocessing wrote.
"""

from __future__ import annotations

import bz2
import gzip
import io
import lzma
import pickle
import zlib

import numpy as np

# joblib's compressor magics (numpy_pickle_utils / compressor.py)
_DECOMPRESS = {b"\x78": zlib.decompress, b"\x1f\x8b": gzip.decompress, b"BZ": bz2.decompress,
               b"\x5d\x00": lambda d: lzma.decompress(d, format=lzma.FORMAT_ALONE),
               b"\xfd7zXZ": lambda d: lzma.decompress(d, format=lzma.FORMAT_XZ)}
_REFUSED = {b"\x04\x22\x4d\x18": "is an lz4-compressed joblib dump; reading it needs the lz4 "
                                  "package, which this reader does without: write it with "
                                  "another compressor",
            b"ZF": "is a joblib < 0.10 dump (ZF), whose arrays live in side files; "
                   "write it again with a current joblib"}


class CompressedDumpError(ValueError):
    """The file is a joblib dump in a format this reader does not
    decompress (lz4, or joblib < 0.10's ``ZF``)."""


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
    """The object in ``path``: a ``joblib.dump`` (uncompressed, or zlib,
    gzip, bz2, lzma or xz) or a plain pickle. Raises
    :class:`CompressedDumpError` on an lz4 or ``ZF`` dump."""
    with open(path, "rb") as f:
        data = f.read()
    for magic, why in _REFUSED.items():
        if data.startswith(magic):
            raise CompressedDumpError(f"{path} {why}")
    for magic, decompress in _DECOMPRESS.items():
        if data.startswith(magic):
            data = decompress(data)
            break
    return _JoblibUnpickler(io.BytesIO(data)).load()
