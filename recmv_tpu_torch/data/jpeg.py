"""JPEG reading for ``data/image.imread``: the frame's size and EXIF
orientation from one pass over the markers, and the pixels from
``csrc/imageio.cpp``'s decoder (baseline, extended sequential and
progressive Huffman-coded 8-bit files with 1 or 3 components), which
computes what libjpeg-turbo computes under ``cv2.imread``. Arithmetic
coding, 12-bit samples, lossless and hierarchical files and 4-component
(CMYK/YCCK) files raise ``ValueError`` naming the mode. Without the
native library (no ``g++``) reading a JPEG raises: there is no second
decoder.
"""

from __future__ import annotations

import ctypes
import struct

import numpy as np

from .. import _build

SIGNATURE = b"\xff\xd8\xff"
# start-of-frame markers: every SOFn but DHT (C4), JPG (C8) and DAC (CC)
_SOF = {0xC0, 0xC1, 0xC2, 0xC3, 0xC5, 0xC6, 0xC7, 0xC9, 0xCA, 0xCB, 0xCD, 0xCE, 0xCF}


def header(data: bytes) -> tuple:
    """(height, width, the first ``Exif`` APP1 payload or None) of a JPEG
    file's bytes; raises ``ValueError`` when no frame header precedes the
    first scan."""
    pos, exif = 2, None
    n = len(data)
    while pos + 4 <= n:
        if data[pos] != 0xFF:
            pos += 1
            continue
        m = data[pos + 1]
        if m == 0xFF:
            pos += 1
            continue
        if 0xD0 <= m <= 0xD8 or m == 0x01:
            pos += 2
            continue
        (length,) = struct.unpack_from(">H", data, pos + 2)
        body = data[pos + 4:pos + 2 + length]
        if m in _SOF:
            if len(body) < 5:
                raise ValueError("truncated JPEG frame header")
            h, w = struct.unpack_from(">HH", body, 1)
            return h, w, exif
        if m in (0xDA, 0xD9):
            break
        if m == 0xE1 and exif is None and body.startswith(b"Exif\x00\x00"):
            exif = body[6:]
        pos += 2 + length
    raise ValueError("no JPEG frame header")


def decode(data: bytes) -> tuple:
    """JPEG file bytes → ((H, W, 3) uint8 BGR as ``cv2.imread`` gives
    before the EXIF orientation, the ``Exif`` payload or None)."""
    h, w, exif = header(data)
    if h == 0 or w == 0:
        raise ValueError(f"unsupported JPEG: frame size {w}x{h}")
    lib = _build.imageio()
    out = np.empty((h, w, 3), np.uint8)
    err = ctypes.create_string_buffer(256)
    buf = np.frombuffer(data, np.uint8)
    if lib.jpeg_decode(buf.ctypes.data, len(data), out.ctypes.data, h, w, err, len(err)):
        raise ValueError(err.value.decode())
    return out, exif
