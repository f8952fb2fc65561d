"""Minimal PNG reader and writer (numpy + zlib), standing in for OpenCV's
``imread`` / ``imwrite`` on machines without OpenCV.

Reads 8-bit, non-interlaced grayscale, RGB, gray+alpha and RGBA files
with any of the five scanline filters; returns 3-channel BGR like
``cv2.imread`` (alpha dropped, gray repeated). Writes 8-bit grayscale or
BGR arrays with filter 0.
"""

from __future__ import annotations

import struct
import zlib

import numpy as np

_SIG = b"\x89PNG\r\n\x1a\n"
_CHANNELS = {0: 1, 2: 3, 4: 2, 6: 4}


def _paeth(a, b, c):
    p = a + b - c
    pa, pb, pc = np.abs(p - a), np.abs(p - b), np.abs(p - c)
    return np.where((pa <= pb) & (pa <= pc), a, np.where(pb <= pc, b, c))


def _unfilter(raw: np.ndarray, h: int, w: int, ch: int) -> np.ndarray:
    stride = w * ch
    rows = raw.reshape(h, stride + 1)
    out = np.zeros((h, stride), np.uint8)
    prior = np.zeros(stride, np.uint8)
    for y in range(h):
        ftype, line = rows[y, 0], rows[y, 1:]
        if ftype == 0:
            cur = line.copy()
        elif ftype == 1:      # Sub: running sum along the row, per channel
            cur = np.cumsum(line.reshape(w, ch), axis=0, dtype=np.uint8).reshape(-1)
        elif ftype == 2:      # Up
            cur = line + prior
        elif ftype in (3, 4):  # Average / Paeth: sequential along the row
            cur = np.zeros(stride, np.int32)
            li = line.astype(np.int32)
            pi = prior.astype(np.int32)
            for x in range(0, stride, ch):
                a = cur[x - ch:x] if x else np.zeros(ch, np.int32)
                b = pi[x:x + ch]
                if ftype == 3:
                    pred = (a + b) // 2
                else:
                    c = pi[x - ch:x] if x else np.zeros(ch, np.int32)
                    pred = _paeth(a, b, c)
                cur[x:x + ch] = (li[x:x + ch] + pred) & 0xFF
            cur = cur.astype(np.uint8)
        else:
            raise ValueError(f"bad PNG filter type {ftype}")
        out[y] = cur
        prior = cur
    return out.reshape(h, w, ch)


def imread(path: str) -> np.ndarray:
    """PNG file → (H, W, 3) uint8 BGR."""
    with open(path, "rb") as f:
        data = f.read()
    if data[:8] != _SIG:
        raise ValueError(f"{path}: not a PNG file")
    pos, idat, hdr = 8, [], None
    while pos < len(data):
        n, ctype = struct.unpack(">I4s", data[pos:pos + 8])
        body = data[pos + 8:pos + 8 + n]
        if ctype == b"IHDR":
            hdr = struct.unpack(">IIBBBBB", body)
        elif ctype == b"IDAT":
            idat.append(body)
        elif ctype == b"IEND":
            break
        pos += 12 + n
    w, h, depth, color, _, _, interlace = hdr
    if depth != 8 or interlace != 0 or color not in _CHANNELS:
        raise ValueError(f"{path}: unsupported PNG (depth {depth}, "
                         f"color type {color}, interlace {interlace})")
    ch = _CHANNELS[color]
    raw = np.frombuffer(zlib.decompress(b"".join(idat)), np.uint8)
    img = _unfilter(raw, h, w, ch)
    if ch in (1, 2):
        img = np.repeat(img[..., :1], 3, axis=-1)
    return np.ascontiguousarray(img[..., 2::-1])


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
        f.write(_SIG)
        f.write(_chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, color, 0, 0, 0)))
        f.write(_chunk(b"IDAT", zlib.compress(rows.tobytes(), 1)))
        f.write(_chunk(b"IEND", b""))
