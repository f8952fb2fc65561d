"""Writes the committed fixtures of the port's scene-input readers and what
OpenCV and joblib make of them.

    python tests/torch_fixtures/make_image_fixtures.py [--out DIR]

It needs ``cv2``, ``PIL`` and ``joblib`` (and the port, for the 1080²
frame), so it runs on a development host and never on the GPU machine,
which has none of them. Every image is made with numpy from a seed
(smooth fields, edges and noise, odd sizes):

- JPEGs written by ``cv2.imwrite`` at qualities 50 and 95 with each
  ``IMWRITE_JPEG_SAMPLING_FACTOR`` (444, 422, 420, 440, 411), progressive,
  with a restart interval, and gray;
- a JPEG and a PNG with EXIF orientations 3, 6 and 8, written by PIL;
- PNGs: palette with and without ``tRNS``, gray at 1, 2 and 4 bits, gray,
  RGB and RGBA at 16 bits, Adam7-interlaced ones (written by
  ``encode_png`` below: neither OpenCV nor PIL writes Adam7), and each of
  the five filters forced through ``IMWRITE_PNG_FILTER``;
- ``frame_1080.jpg``: frame 0 of the port's ``generate_scene(n_frames=16,
  image_size=1080, skinner_res=(129, 225, 65))`` rendered on the CPU
  (frame 0's pose, yaw 2π·0/16, does not depend on the frame count, so
  one frame is rendered), encoded by ``cv2`` at quality 95, 4:2:0; and
  ``frame_1080.png``, the same pixels written by PIL (its adaptive filter
  choice puts 130 Paeth rows among Up, Sub and unfiltered ones);
- TCMR-shaped dumps from ``joblib.dump(..., compress=(c, 3))`` for zlib,
  gzip, bz2, lzma and xz, each holding ``{1: {frame_ids, gt_joints2d,
  pose, betas}}`` plus an F-ordered, a big-endian and an object array.

``expected.npz`` holds ``cv2.imread`` of every image (key ``img/<file>``;
for the two 1080² files, which would not fit the directory's budget, the
SHA-256 of the array's bytes and its shape, ``sha256/<file>`` and
``shape/<file>``) and the content every dump loads to (``tcmr/...``; the
object array needs ``allow_pickle``). Last it prints the port's and
OpenCV's milliseconds per read of the 1080² files (10 reads each, host
clock, this host's CPU).
"""

from __future__ import annotations

import argparse
import hashlib
import os
import os.path as osp
import platform
import shutil
import struct
import sys
import tempfile
import time
import zlib

import numpy as np

HERE = osp.dirname(osp.abspath(__file__))
ROOT = osp.dirname(osp.dirname(HERE))
SAMPLING = ("444", "422", "420", "440", "411")
COMPRESSORS = ("zlib", "gzip", "bz2", "lzma", "xz")
FRAME_SKINNER_RES = (129, 225, 65)
_CHANNELS = {0: 1, 2: 3, 3: 1, 4: 2, 6: 4}
_ADAM7 = ((0, 0, 8, 8), (4, 0, 8, 8), (0, 4, 4, 8), (2, 0, 4, 4), (0, 2, 2, 4), (1, 0, 2, 2),
          (0, 1, 1, 2))


def seeded_image(h: int, w: int, seed: int, noise: float = 3.0) -> np.ndarray:
    """(h, w, 3) uint8: smooth colour fields, a checker of hard edges, a
    diagonal ramp and seeded Gaussian noise."""
    rng = np.random.RandomState(seed)
    y, x = np.mgrid[0:h, 0:w].astype(np.float64)
    img = np.stack([128 + 90 * np.sin(x / (5.0 + c) + c) * np.cos(y / (9.0 - c) - c)
                    for c in range(3)], -1)
    img[((x // 11 + y // 7) % 2) == 0] += 45
    img[x + y < (h + w) / 3] -= 60
    img += rng.randn(h, w, 3) * noise
    return np.clip(np.round(img), 0, 255).astype(np.uint8)


def _paeth(a, b, c):
    p = a + b - c
    pa, pb, pc = np.abs(p - a), np.abs(p - b), np.abs(p - c)
    return np.where((pa <= pb) & (pa <= pc), a, np.where(pb <= pc, b, c))


def _filtered(rows: np.ndarray, bpp: int, filters) -> bytes:
    """PNG scanlines: each row of bytes behind its filter type, the types
    taken in turn from ``filters``."""
    out, prior = [], np.zeros(rows.shape[1], np.int32)
    for y, row in enumerate(rows.astype(np.int32)):
        f = filters[y % len(filters)]
        a = np.concatenate([np.zeros(bpp, np.int32), row])[:len(row)]
        c = np.concatenate([np.zeros(bpp, np.int32), prior])[:len(row)]
        pred = {0: 0, 1: a, 2: prior, 3: (a + prior) >> 1, 4: _paeth(a, prior, c)}[f]
        out.append(bytes([f]) + ((row - pred) & 255).astype(np.uint8).tobytes())
        prior = row
    return b"".join(out)


def _packed(s: np.ndarray, depth: int) -> np.ndarray:
    """(h, w, ch) samples → (h, rowbytes) bytes at ``depth`` bits."""
    h = s.shape[0]
    if depth == 16:
        return s.astype(">u2").view(np.uint8).reshape(h, -1)
    if depth == 8:
        return s.astype(np.uint8).reshape(h, -1)
    v = s.reshape(h, -1, 1).astype(np.uint8)
    bits = (v >> np.arange(depth - 1, -1, -1, dtype=np.uint8)) & 1
    return np.packbits(bits.reshape(h, -1), axis=1)


def _chunk(ctype: bytes, body: bytes) -> bytes:
    return (struct.pack(">I", len(body)) + ctype + body
            + struct.pack(">I", zlib.crc32(ctype + body) & 0xFFFFFFFF))


def encode_png(samples: np.ndarray, color: int, depth: int, *, interlace: bool = False,
               filters=(0, 1, 2, 3, 4), plte=None, trns: bytes | None = None,
               exif: bytes | None = None) -> bytes:
    """A PNG of ``samples`` ((h, w) or (h, w, ch) palette indices or
    samples below ``2**depth``) in colour type ``color``, non-interlaced or
    Adam7, with the filter types taken in turn from ``filters``."""
    s = np.asarray(samples)
    h, w = s.shape[:2]
    ch = _CHANNELS[color]
    s = s.reshape(h, w, ch)
    bpp = max(1, ch * depth // 8)
    if interlace:
        passes = [s[y0::dy, x0::dx] for x0, y0, dx, dy in _ADAM7]
        raw = b"".join(_filtered(_packed(p, depth), bpp, filters) for p in passes if p.size)
    else:
        raw = _filtered(_packed(s, depth), bpp, filters)
    out = [b"\x89PNG\r\n\x1a\n",
           _chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, depth, color, 0, 0, int(interlace)))]
    if plte is not None:
        out.append(_chunk(b"PLTE", np.asarray(plte, np.uint8).tobytes()))
    if trns is not None:
        out.append(_chunk(b"tRNS", trns))
    if exif is not None:
        out.append(_chunk(b"eXIf", exif))
    out += [_chunk(b"IDAT", zlib.compress(raw, 9)), _chunk(b"IEND", b"")]
    return b"".join(out)


def palette_of(img: np.ndarray, n: int, seed: int) -> tuple:
    """(indices (h, w) uint8 in [0, n), an (n, 3) RGB palette): each pixel
    takes the nearest of n seeded colours."""
    rng = np.random.RandomState(seed)
    pal = rng.randint(0, 256, (n, 3)).astype(np.uint8)
    d = ((img[..., None, ::-1].astype(np.int32) - pal.astype(np.int32)) ** 2).sum(-1)
    return d.argmin(-1).astype(np.uint8), pal


def png_cases(seed: int = 7) -> dict:
    """File name → PNG bytes for every PNG case."""
    import cv2

    base = seeded_image(27, 39, seed)
    gray = base[..., 1]
    idx, pal = palette_of(base, 11, seed)
    idx4, pal4 = palette_of(base, 4, seed + 1)
    out = {
        "png_palette.png": encode_png(idx, 3, 8, plte=pal),
        "png_palette_trns.png": encode_png(idx, 3, 8, plte=pal, trns=bytes(range(0, 220, 20))),
        "png_palette_2bit.png": encode_png(idx4, 3, 2, plte=pal4),
        "png_gray1.png": encode_png(gray >> 7, 0, 1),
        "png_gray2.png": encode_png(gray >> 6, 0, 2),
        "png_gray4.png": encode_png(gray >> 4, 0, 4),
        "png_gray16.png": encode_png(gray.astype(np.uint16) * 256 + 131, 0, 16),
        "png_rgb16.png": encode_png(base[..., ::-1].astype(np.uint16) * 251 + 97, 2, 16),
        "png_rgba16.png": encode_png(np.concatenate(
            [base[..., ::-1].astype(np.uint16) * 256 + 255, np.full(base.shape[:2] + (1,), 4096,
                                                                    np.uint16)], -1), 6, 16),
        "png_adam7_rgb.png": encode_png(base[..., ::-1], 2, 8, interlace=True),
        "png_adam7_gray4.png": encode_png(gray >> 4, 0, 4, interlace=True),
        "png_adam7_palette2.png": encode_png(idx4, 3, 2, plte=pal4, interlace=True),
        "png_adam7_rgba16.png": encode_png(np.concatenate(
            [base[..., ::-1].astype(np.uint16) * 257, np.full(base.shape[:2] + (1,), 9, np.uint16)],
            -1), 6, 16, interlace=True),
        "png_gray_alpha.png": encode_png(np.stack([gray, 255 - gray], -1), 4, 8),
    }
    for name in ("NONE", "SUB", "UP", "AVG", "PAETH"):
        ok, buf = cv2.imencode(".png", base, [cv2.IMWRITE_PNG_FILTER,
                                              getattr(cv2, "IMWRITE_PNG_FILTER_" + name)])
        assert ok
        out[f"png_filter_{name.lower()}.png"] = buf.tobytes()
    return out


def jpeg_cases(seed: int = 3) -> dict:
    """File name → JPEG bytes for every JPEG case written by OpenCV."""
    import cv2

    base = seeded_image(97, 131, seed)
    small = seeded_image(29, 43, seed + 1)
    out = {}

    def enc(img, params):
        ok, buf = cv2.imencode(".jpg", img, params)
        assert ok
        return buf.tobytes()

    for q in (50, 95):
        for sf in SAMPLING:
            img = base if (q, sf) == (95, "420") else small
            out[f"jpg_q{q}_{sf}.jpg"] = enc(img, [
                cv2.IMWRITE_JPEG_QUALITY, q, cv2.IMWRITE_JPEG_SAMPLING_FACTOR,
                getattr(cv2, "IMWRITE_JPEG_SAMPLING_FACTOR_" + sf)])
    out["jpg_progressive_420.jpg"] = enc(small, [cv2.IMWRITE_JPEG_QUALITY, 90,
                                                 cv2.IMWRITE_JPEG_PROGRESSIVE, 1])
    out["jpg_progressive_444.jpg"] = enc(small, [
        cv2.IMWRITE_JPEG_QUALITY, 60, cv2.IMWRITE_JPEG_PROGRESSIVE, 1,
        cv2.IMWRITE_JPEG_SAMPLING_FACTOR, cv2.IMWRITE_JPEG_SAMPLING_FACTOR_444])
    out["jpg_rst_420.jpg"] = enc(small, [cv2.IMWRITE_JPEG_QUALITY, 90,
                                         cv2.IMWRITE_JPEG_RST_INTERVAL, 2])
    out["jpg_gray.jpg"] = enc(small[..., 1], [cv2.IMWRITE_JPEG_QUALITY, 95])
    return out


def exif_cases(seed: int = 5) -> dict:
    """File name → bytes: a PIL-written JPEG and PNG for EXIF orientations
    3, 6 and 8 of a 16×24 image."""
    import io

    from PIL import Image

    img = Image.fromarray(seeded_image(16, 24, seed)[..., ::-1])
    out = {}
    for o in (3, 6, 8):
        ex = Image.Exif()
        ex[0x0112] = o
        for ext, kw in (("jpg", dict(quality=90)), ("png", {})):
            buf = io.BytesIO()
            img.save(buf, format="JPEG" if ext == "jpg" else "PNG", exif=ex, **kw)
            out[f"exif{o}.{ext}"] = buf.getvalue()
    return out


def tcmr_content(seed: int = 11) -> dict:
    """What every TCMR fixture dump holds: the TCMR record the dataset
    reads, and arrays of the layouts joblib stores apart."""
    rng = np.random.RandomState(seed)
    n = 6
    return {1: {"frame_ids": np.arange(n),
                "gt_joints2d": np.concatenate([64 * rng.rand(n, 49, 2), np.ones((n, 49, 1))],
                                              -1).astype(np.float32),
                "pose": rng.randn(n, 72).astype(np.float32),
                "betas": 0.1 * rng.randn(n, 10).astype(np.float32)},
            "f_order": np.asfortranarray(rng.randn(5, 7)),
            "big_endian": rng.randn(4, 3).astype(">f4"),
            "objects": np.array(["left", 3, None, (1.5, "x")], dtype=object)}


def frame_1080(work: str) -> np.ndarray:
    """Frame 0 of the CPU-rendered 1080² synthetic-tube scene, BGR."""
    sys.path.insert(0, ROOT)
    from recmv_tpu_torch.data.image import imread
    from recmv_tpu_torch.data.synthetic import generate_scene

    scene = generate_scene(osp.join(work, "scene"), n_frames=1, image_size=1080,
                           skinner_res=FRAME_SKINNER_RES, device="cpu")
    return imread(osp.join(scene, "imgs", "0.png"))


def write_all(out: str) -> None:
    import cv2
    import joblib
    from PIL import Image

    os.makedirs(out, exist_ok=True)
    files = {**jpeg_cases(), **png_cases(), **exif_cases()}
    for name, data in files.items():
        with open(osp.join(out, name), "wb") as f:
            f.write(data)
    expected = {f"img/{n}": cv2.imread(osp.join(out, n)) for n in files}
    for n, v in expected.items():
        assert v is not None, n

    work = tempfile.mkdtemp()
    try:
        frame = frame_1080(work)
    finally:
        shutil.rmtree(work, ignore_errors=True)
    cv2.imwrite(osp.join(out, "frame_1080.jpg"), frame, [
        cv2.IMWRITE_JPEG_QUALITY, 95, cv2.IMWRITE_JPEG_SAMPLING_FACTOR,
        cv2.IMWRITE_JPEG_SAMPLING_FACTOR_420])
    Image.fromarray(frame[..., ::-1]).save(osp.join(out, "frame_1080.png"))
    for n in ("frame_1080.jpg", "frame_1080.png"):
        arr = cv2.imread(osp.join(out, n))
        expected[f"sha256/{n}"] = np.frombuffer(hashlib.sha256(arr.tobytes()).digest(), np.uint8)
        expected[f"shape/{n}"] = np.asarray(arr.shape)

    content = tcmr_content()
    for c in COMPRESSORS:
        path = osp.join(out, f"tcmr_{c}.pkl")
        joblib.dump(content, path, compress=(c, 3))
        got = joblib.load(path)
        assert np.array_equal(got["objects"], content["objects"]), c
    loaded = joblib.load(osp.join(out, "tcmr_zlib.pkl"))
    for k, v in loaded[1].items():
        expected[f"tcmr/1/{k}"] = v
    for k in ("f_order", "big_endian", "objects"):
        expected[f"tcmr/{k}"] = loaded[k]
    np.savez_compressed(osp.join(out, "expected.npz"), **expected)


def read_times(out: str, reps: int = 10) -> None:
    """Milliseconds per read of the 1080² fixtures and of a PNG written by
    ``png.imwrite``, by the port's reader and by OpenCV (host clock)."""
    import cv2

    sys.path.insert(0, ROOT)
    from recmv_tpu_torch.data import png
    from recmv_tpu_torch.data.image import imread

    work = tempfile.mkdtemp()
    try:
        plain = osp.join(work, "imwrite.png")
        png.imwrite(plain, imread(osp.join(out, "frame_1080.png")))
        for path in (osp.join(out, "frame_1080.jpg"), osp.join(out, "frame_1080.png"), plain):
            for name, fn in (("port", imread), ("cv2", cv2.imread)):
                fn(path)
                t0 = time.perf_counter()
                for _ in range(reps):
                    fn(path)
                ms = 1e3 * (time.perf_counter() - t0) / reps
                print(f"{name} {osp.basename(path)}: {ms:.3f} ms per read "
                      f"({platform.processor() or platform.machine()}, {os.cpu_count()} cores)")
    finally:
        shutil.rmtree(work, ignore_errors=True)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--out", default=HERE)
    args = ap.parse_args(argv)
    write_all(args.out)
    read_times(args.out)
    return 0


if __name__ == "__main__":
    sys.exit(main())
