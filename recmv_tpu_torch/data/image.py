"""The port's image reader: ``imread(path)`` gives what
``cv2.imread(path)`` (``IMREAD_COLOR``) gives for the scene inputs the JAX
package reads with OpenCV, on machines without OpenCV.

The format is picked by the file's leading bytes, as OpenCV picks it, not
by its extension: PNG (``data/png.py``) or JPEG (``data/jpeg.py``). The
EXIF orientation (JPEG ``APP1``, PNG ``eXIf``) is applied as OpenCV
applies it. Where ``cv2.imread`` would return ``None`` (a missing file,
another format, a file its decoder refuses) this raises, naming the path.
"""

from __future__ import annotations

import struct

import numpy as np

from . import jpeg, png


def exif_orientation(tiff: bytes | None) -> int:
    """The Orientation tag (0x0112) of IFD0 of an EXIF payload (a TIFF
    header, with or without the ``Exif\\0\\0`` prefix); 1 when absent or
    unreadable."""
    if not tiff:
        return 1
    if tiff.startswith(b"Exif\x00\x00"):
        tiff = tiff[6:]
    order = {b"II": "<", b"MM": ">"}.get(tiff[:2])
    if order is None or len(tiff) < 8:
        return 1
    (ifd,) = struct.unpack_from(order + "I", tiff, 4)
    if ifd + 2 > len(tiff):
        return 1
    (n,) = struct.unpack_from(order + "H", tiff, ifd)
    for i in range(n):
        at = ifd + 2 + 12 * i
        if at + 12 > len(tiff):
            break
        tag, typ, _ = struct.unpack_from(order + "HHI", tiff, at)
        if tag == 0x0112:
            fmt = "H" if typ == 3 else "I" if typ == 4 else None
            return struct.unpack_from(order + fmt, tiff, at + 8)[0] if fmt else 1
    return 1


def apply_orientation(img: np.ndarray, orientation: int) -> np.ndarray:
    """OpenCV's ``ExifTransform``: flips and transposes that show the image
    upright for EXIF orientations 2-8."""
    if 5 <= orientation <= 8:
        img = img.transpose(1, 0, 2)
        orientation = {5: 1, 6: 2, 7: 3, 8: 4}[orientation]
    if orientation == 2:
        img = img[:, ::-1]
    elif orientation == 3:
        img = img[::-1, ::-1]
    elif orientation == 4:
        img = img[::-1]
    return np.ascontiguousarray(img)


def imread(path: str) -> np.ndarray:
    """An image file → (H, W, 3) uint8 BGR, as ``cv2.imread(path)``."""
    with open(path, "rb") as f:
        data = f.read()
    try:
        if data.startswith(png.SIGNATURE):
            img, exif = png.decode(data)
        elif data.startswith(jpeg.SIGNATURE):
            img, exif = jpeg.decode(data)
        else:
            raise ValueError("not a PNG or JPEG file")
    except ValueError as e:
        raise ValueError(f"{path}: {e}") from None
    return apply_orientation(img, exif_orientation(exif))
