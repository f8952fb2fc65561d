"""PNG reader and writer (numpy + zlib, the scanline filters in
``csrc/imageio.cpp``), standing in for OpenCV's ``imread`` / ``imwrite``
on machines without OpenCV.

``decode`` reads every PNG that ``cv2.imread(IMREAD_COLOR)`` reads
through libpng and gives the same pixels: gray, RGB, gray+alpha, RGBA and
palette colour types; bit depths 1, 2 and 4 (gray scaled to 0-255 as
libpng's ``expand_gray_1_2_4_to_8``; palette indices), 8 and 16 (the
high byte, ``>> 8``); Adam7 interlace; all five filters. Alpha and
``tRNS`` are dropped, gray is repeated to three channels, the result is
BGR. ``imwrite`` writes 8-bit grayscale or BGR arrays with filter 0.
"""

from __future__ import annotations

import struct
import zlib

import numpy as np


SIGNATURE = b"\x89PNG\r\n\x1a\n"
_CHANNELS = {0: 1, 2: 3, 3: 1, 4: 2, 6: 4}
_DEPTHS = {0: (1, 2, 4, 8, 16), 2: (8, 16), 3: (1, 2, 4, 8), 4: (8, 16), 6: (8, 16)}
_GRAY_SCALE = {1: 255, 2: 0x55, 4: 0x11, 8: 1}
# Adam7 passes: (x0, y0, dx, dy)
_ADAM7 = ((0, 0, 8, 8), (4, 0, 8, 8), (0, 4, 4, 8), (2, 0, 4, 4), (0, 2, 2, 4), (1, 0, 2, 2),
          (0, 1, 1, 2))


def _samples(raw: np.ndarray, h: int, w: int, ch: int, depth: int) -> np.ndarray:
    """Unfiltered (h, rowbytes) bytes → (h, w, ch) uint8 samples (16-bit
    samples keep their high byte; depths below 8 are unpacked, not
    scaled)."""
    if depth == 8:
        return raw[:, :w * ch].reshape(h, w, ch)
    if depth == 16:
        return raw[:, 0:2 * w * ch:2].reshape(h, w, ch)
    bits = np.unpackbits(raw, axis=1)[:, :w * ch * depth].reshape(h, w * ch, depth)
    weights = (1 << np.arange(depth - 1, -1, -1)).astype(np.uint8)
    return (bits * weights).sum(-1, dtype=np.uint8).reshape(h, w, ch)


def _unfilter(lib, data: bytes, pos: int, h: int, w: int, ch: int, depth: int) -> tuple:
    """The sub-image of (h, w) whose rows start at ``data[pos]``, all of
    filter type 0 (the only filter ``imwrite`` writes) → (samples, next
    position). ``lib`` is unused."""
    rowbytes = (w * ch * depth + 7) // 8
    raw = np.frombuffer(data, np.uint8, (rowbytes + 1) * h, pos).reshape(h, rowbytes + 1)
    if h and raw[:, 0].any():
        raise ValueError(f"PNG filter type {int(raw[raw[:, 0] != 0][0, 0])}: the frozen "
                         "decoder reads filter 0 only")
    return _samples(np.ascontiguousarray(raw[:, 1:]), h, w, ch, depth), pos + (rowbytes + 1) * h


def decode(data: bytes) -> tuple:
    """PNG file bytes → ((H, W, 3) uint8 BGR as ``cv2.imread`` gives it
    before the EXIF orientation, the ``eXIf`` payload or None). Raises
    ``ValueError`` on a file libpng refuses: a bad signature, header,
    critical-chunk CRC or image data."""
    if not data.startswith(SIGNATURE):
        raise ValueError("not a PNG file")
    pos, idat, hdr, plte, exif = 8, [], None, None, None
    while pos + 8 <= len(data):
        n, ctype = struct.unpack_from(">I4s", data, pos)
        body = data[pos + 8:pos + 8 + n]
        if len(body) != n or pos + 12 + n > len(data):
            raise ValueError("truncated PNG chunk")
        if ctype[0] & 0x20 == 0:  # critical chunk: libpng stops on a bad CRC
            (crc,) = struct.unpack_from(">I", data, pos + 8 + n)
            if zlib.crc32(body, zlib.crc32(ctype)) != crc:
                raise ValueError(f"PNG {ctype.decode('latin-1')} chunk CRC error")
        if ctype == b"IHDR":
            hdr = struct.unpack(">IIBBBBB", body)
        elif ctype == b"PLTE":
            plte = np.frombuffer(body, np.uint8).reshape(-1, 3)
        elif ctype == b"IDAT":
            idat.append(body)
        elif ctype == b"eXIf" and exif is None:
            exif = body
        elif ctype == b"IEND":
            break
        pos += 12 + n
    if hdr is None or not idat:
        raise ValueError("PNG without IHDR or IDAT")
    w, h, depth, color, comp, filt, interlace = hdr
    if (color not in _DEPTHS or depth not in _DEPTHS[color] or comp or filt
            or interlace > 1 or w == 0 or h == 0):
        raise ValueError(f"bad PNG header (depth {depth}, colour type {color}, "
                         f"interlace {interlace})")
    if color == 3 and plte is None:
        raise ValueError("palette PNG without PLTE")
    ch = _CHANNELS[color]
    lib = None
    try:
        raw = zlib.decompressobj().decompress(b"".join(idat))
    except zlib.error as e:
        raise ValueError(f"PNG image data: {e}") from None
    if interlace:
        img = np.empty((h, w, ch), np.uint8)
        at = 0
        for x0, y0, dx, dy in _ADAM7:
            pw, ph = (w - x0 + dx - 1) // dx, (h - y0 + dy - 1) // dy
            if pw > 0 and ph > 0:
                img[y0::dy, x0::dx], at = _unfilter(lib, raw, at, ph, pw, ch, depth)
    else:
        img, _ = _unfilter(lib, raw, 0, h, w, ch, depth)
    if color == 3:
        pal = np.zeros((256, 3), np.uint8)  # libpng zero-fills past the palette
        pal[:len(plte)] = plte[:256]
        rgb = pal[img[..., 0]]
    elif color in (0, 4):
        rgb = np.repeat(img[..., :1] * np.uint8(_GRAY_SCALE.get(depth, 1)), 3, axis=-1)
    else:
        rgb = img[..., :3]
    return np.ascontiguousarray(rgb[..., ::-1]), exif


def _chunk(ctype: bytes, body: bytes) -> bytes:
    return (struct.pack(">I", len(body)) + ctype + body
            + struct.pack(">I", zlib.crc32(ctype + body) & 0xFFFFFFFF))


def imwrite(path: str, img: np.ndarray) -> None:
    """(H, W) gray or (H, W, 3) BGR uint8 → PNG file."""
    img = np.asarray(img)
    if img.dtype != np.uint8:
        raise ValueError("imwrite takes uint8 images")
    if img.ndim == 2:
        color, rgb = 0, img[..., None]
    elif img.ndim == 3 and img.shape[2] == 3:
        color, rgb = 2, img[..., ::-1]
    else:
        raise ValueError(f"imwrite takes (H, W) or (H, W, 3), got {img.shape}")
    h, w = rgb.shape[:2]
    rows = np.concatenate([np.zeros((h, 1), np.uint8),
                           np.ascontiguousarray(rgb).reshape(h, -1)], axis=1)
    with open(path, "wb") as f:
        f.write(SIGNATURE)
        f.write(_chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, color, 0, 0, 0)))
        f.write(_chunk(b"IDAT", zlib.compress(rows.tobytes(), 1)))
        f.write(_chunk(b"IEND", b""))
