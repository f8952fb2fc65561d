"""The port's scene-input readers against the readers the JAX package
uses, on the CPU: ``data/image.imread`` against ``cv2.imread`` and
``utils/pickle_compat.load_joblib`` against ``joblib.load``.

- PNG, bit for bit, on files this test writes from a seed: every colour
  type at every bit depth PNG allows (palette with and without ``tRNS``,
  gray at 1, 2 and 4 bits, 16-bit gray, RGB and RGBA), plain and Adam7,
  and each filter forced by OpenCV;
- JPEG written by OpenCV, bit for bit: baseline at qualities 50 and 95
  with sampling 4:4:4, 4:2:2, 4:2:0, 4:4:0 and 4:1:1, progressive,
  restart intervals, gray, at odd sizes;
- JPEG in the modes PIL writes (optimized Huffman tables, PIL's
  progressive scans and subsampling): held to max |Δ| ≤ 1; measured 0 on
  OpenCV 5.0.0 with libjpeg-turbo 3.1.2;
- EXIF orientations 1-8 on JPEG and PNG: OpenCV's shape and pixels;
- the committed fixtures of ``tests/torch_fixtures`` (written by its
  ``make_image_fixtures.py``) against the ``cv2.imread`` arrays and dump
  contents stored beside them, and against OpenCV and joblib here;
- refused inputs raise: arithmetic-coded, 12-bit, lossless and CMYK JPEG,
  a PNG with a bad CRC, another format (``ValueError`` naming the path);
  lz4 and joblib < 0.10 ``ZF`` dumps (``CompressedDumpError``).
"""

import hashlib
import io
import os
import os.path as osp
import sys

import numpy as np
import pytest

cv2 = pytest.importorskip("cv2")

FIXTURES = osp.join(osp.dirname(__file__), "torch_fixtures")
sys.path.insert(0, FIXTURES)
import make_image_fixtures as mk  # noqa: E402

from recmv_tpu_torch.data.image import imread  # noqa: E402
from recmv_tpu_torch.utils.pickle_compat import CompressedDumpError, load_joblib  # noqa: E402

IMAGES = sorted(n for n in os.listdir(FIXTURES) if n.endswith((".jpg", ".png")))
PNG_DEPTHS = [(c, d) for c, ds in ((0, (1, 2, 4, 8, 16)), (2, (8, 16)), (3, (1, 2, 4, 8)),
                                   (4, (8, 16)), (6, (8, 16))) for d in ds]


def _write(path, data: bytes) -> str:
    with open(path, "wb") as f:
        f.write(data)
    return str(path)


def _max_diff(a, b) -> int:
    assert a.shape == b.shape, (a.shape, b.shape)
    return int(np.abs(a.astype(np.int32) - b.astype(np.int32)).max())


@pytest.fixture(scope="module")
def expected():
    with np.load(osp.join(FIXTURES, "expected.npz"), allow_pickle=True) as npz:
        return {k: npz[k] for k in npz.files}


# ---------------------------------------------------------------------------
# PNG
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("interlace", [False, True], ids=["plain", "adam7"])
@pytest.mark.parametrize("color,depth", PNG_DEPTHS, ids=[f"c{c}d{d}" for c, d in PNG_DEPTHS])
def test_png_matches_opencv(tmp_path, color, depth, interlace):
    """Seeded samples in every colour type and depth, every filter in
    turn, an odd size; palettes shorter than the index range."""
    rng = np.random.RandomState(color * 100 + depth + 7 * interlace)
    h, w = 19 + rng.randint(9), 23 + rng.randint(9)
    ch = {0: 1, 2: 3, 3: 1, 4: 2, 6: 4}[color]
    top = (1 << depth) - 1
    smooth = mk.seeded_image(h, w, color + depth).astype(np.int64)
    samples = np.concatenate([smooth, smooth[..., :1]], -1)[..., :ch] * top // 255
    samples = samples + rng.randint(-2, 3, samples.shape)
    samples = np.clip(samples, 0, top).astype(np.uint16 if depth == 16 else np.uint8)
    plte = trns = None
    if color == 3:
        n = min(1 << depth, 200)
        samples = np.minimum(samples, n - 1)
        plte = rng.randint(0, 256, (n, 3))
        trns = bytes(rng.randint(0, 256, n // 2).astype(np.uint8))
    path = _write(tmp_path / "a.png", mk.encode_png(samples, color, depth, interlace=interlace,
                                                    plte=plte, trns=trns))
    want = cv2.imread(path)
    got = imread(path)
    assert got.dtype == np.uint8 and got.shape == want.shape
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("name", ["NONE", "SUB", "UP", "AVG", "PAETH"])
def test_png_forced_filters_match_opencv(tmp_path, name):
    """OpenCV's writer with one filter forced: every row carries it."""
    img = mk.seeded_image(41, 67, 3)
    path = str(tmp_path / "f.png")
    cv2.imwrite(path, img, [cv2.IMWRITE_PNG_FILTER, getattr(cv2, "IMWRITE_PNG_FILTER_" + name)])
    np.testing.assert_array_equal(imread(path), cv2.imread(path))


def test_png_bilevel_and_gray_trns_match_opencv(tmp_path):
    """OpenCV's 1-bit writer, and a gray PNG with a ``tRNS`` colour."""
    img = mk.seeded_image(33, 47, 5)[..., 0]
    p1 = str(tmp_path / "bilevel.png")
    cv2.imwrite(p1, img, [cv2.IMWRITE_PNG_BILEVEL, 1])
    np.testing.assert_array_equal(imread(p1), cv2.imread(p1))
    p2 = _write(tmp_path / "trns.png", mk.encode_png(img, 0, 8, trns=b"\x00\x80"))
    np.testing.assert_array_equal(imread(p2), cv2.imread(p2))


# ---------------------------------------------------------------------------
# JPEG
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("mode", ["baseline", "progressive", "restart"])
@pytest.mark.parametrize("sampling", mk.SAMPLING)
@pytest.mark.parametrize("quality", [50, 95])
def test_jpeg_from_opencv_matches_bit_for_bit(tmp_path, quality, sampling, mode):
    """OpenCV-written JPEGs at odd sizes (sizes that are no multiple of
    the MCU, and 1×1, 2×3)."""
    extra = {"baseline": [], "progressive": [cv2.IMWRITE_JPEG_PROGRESSIVE, 1],
             "restart": [cv2.IMWRITE_JPEG_RST_INTERVAL, 3]}[mode]
    params = [cv2.IMWRITE_JPEG_QUALITY, quality, cv2.IMWRITE_JPEG_SAMPLING_FACTOR,
              getattr(cv2, "IMWRITE_JPEG_SAMPLING_FACTOR_" + sampling)] + extra
    for i, (h, w) in enumerate([(97, 131), (17, 5), (1, 1), (2, 3)]):
        path = str(tmp_path / f"{i}.jpg")
        assert cv2.imwrite(path, mk.seeded_image(h, w, quality + i, noise=10.0), params)
        np.testing.assert_array_equal(imread(path), cv2.imread(path), err_msg=f"{h}x{w}")


@pytest.mark.parametrize("extra", [[], [cv2.IMWRITE_JPEG_PROGRESSIVE, 1],
                                   [cv2.IMWRITE_JPEG_RST_INTERVAL, 1]],
                         ids=["baseline", "progressive", "restart"])
def test_gray_jpeg_matches_bit_for_bit(tmp_path, extra):
    path = str(tmp_path / "g.jpg")
    cv2.imwrite(path, mk.seeded_image(53, 71, 9, noise=10.0)[..., 2],
                [cv2.IMWRITE_JPEG_QUALITY, 80] + extra)
    np.testing.assert_array_equal(imread(path), cv2.imread(path))


@pytest.mark.parametrize("kw", [dict(quality=90, optimize=True),
                                dict(quality=75, subsampling=1),
                                dict(quality=85, progressive=True),
                                dict(quality=30, progressive=True, subsampling=2, optimize=True),
                                dict(quality=95, subsampling=0)],
                         ids=["optimize", "422", "progressive", "progressive420", "444"])
def test_jpeg_from_pil_within_one(tmp_path, kw):
    """JPEG modes that OpenCV does not write: max |Δ| ≤ 1 (measured 0)."""
    from PIL import Image

    for i, (h, w) in enumerate([(77, 121), (9, 14)]):
        path = str(tmp_path / f"{i}.jpg")
        Image.fromarray(mk.seeded_image(h, w, i, noise=10.0)[..., ::-1]).save(path, **kw)
        assert _max_diff(imread(path), cv2.imread(path)) <= 1


# ---------------------------------------------------------------------------
# EXIF orientation
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("orientation", range(1, 9))
def test_exif_orientation_matches_opencv(tmp_path, orientation):
    """PIL-written JPEG and PNG (``eXIf``) with each orientation, and a
    PNG whose ``eXIf`` is big-endian: OpenCV's shape and pixels."""
    from PIL import Image

    img = mk.seeded_image(16, 24, orientation)
    ex = Image.Exif()
    ex[0x0112] = orientation
    paths = []
    for ext, kw in (("jpg", dict(quality=90)), ("png", {})):
        paths.append(str(tmp_path / f"o.{ext}"))
        Image.fromarray(img[..., ::-1]).save(paths[-1], exif=ex, **kw)
    tiff = (b"MM\x00*\x00\x00\x00\x08\x00\x01" + b"\x01\x12\x00\x03\x00\x00\x00\x01"
            + bytes([0, orientation, 0, 0]) + b"\x00\x00\x00\x00")
    paths.append(_write(tmp_path / "mm.png", mk.encode_png(img[..., ::-1], 2, 8, exif=tiff)))
    for p in paths:
        want = cv2.imread(p)
        assert want.shape[:2] == ((16, 24) if orientation < 5 else (24, 16))
        np.testing.assert_array_equal(imread(p), want, err_msg=p)


# ---------------------------------------------------------------------------
# the committed fixtures
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name", IMAGES)
def test_fixture_matches_stored_opencv_array(expected, name):
    """Every committed image reads to the ``cv2.imread`` array stored
    beside it (its SHA-256 for the 1080² frames), and OpenCV here still
    reads it so."""
    path = osp.join(FIXTURES, name)
    got = imread(path)
    want = cv2.imread(path)
    if f"img/{name}" in expected:
        np.testing.assert_array_equal(expected[f"img/{name}"], want)
        np.testing.assert_array_equal(got, want)
    else:
        assert tuple(expected[f"shape/{name}"]) == got.shape
        assert hashlib.sha256(got.tobytes()).digest() == expected[f"sha256/{name}"].tobytes()
        np.testing.assert_array_equal(got, want)


def test_fixture_paeth_frame_has_paeth_rows():
    """``frame_1080.png`` is the slow case of a row-at-a-time unfilter:
    PIL's writer puts Paeth rows among Up, Sub and unfiltered ones."""
    import struct
    import zlib

    with open(osp.join(FIXTURES, "frame_1080.png"), "rb") as f:
        data = f.read()
    pos, idat = 8, b""
    while pos < len(data):
        n, ctype = struct.unpack_from(">I4s", data, pos)
        if ctype == b"IDAT":
            idat += data[pos + 8:pos + 8 + n]
        pos += 12 + n
    kinds = np.bincount(np.frombuffer(zlib.decompress(idat), np.uint8)[::1080 * 3 + 1],
                        minlength=5)
    assert kinds[4] > 100 and kinds.sum() == 1080, kinds


# ---------------------------------------------------------------------------
# joblib dumps
# ---------------------------------------------------------------------------

def _assert_same_dump(got, want):
    assert sorted(got[1]) == sorted(want[1])
    for k, v in want[1].items():
        assert got[1][k].dtype == v.dtype and got[1][k].shape == v.shape, k
        np.testing.assert_array_equal(got[1][k], v, err_msg=k)
    for k in ("f_order", "big_endian"):
        assert got[k].dtype == want[k].dtype, k
        assert got[k].flags.f_contiguous == want[k].flags.f_contiguous, k
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    assert got["objects"].dtype == object and got["objects"].tolist() == want["objects"].tolist()


@pytest.mark.parametrize("compressor", mk.COMPRESSORS)
def test_load_joblib_matches_joblib(tmp_path, expected, compressor):
    """The committed dump and one this test writes from a seed, in each
    compressor: ``load_joblib`` equals ``joblib.load``, dtypes and
    orders included, and the content stored with the fixtures."""
    joblib = pytest.importorskip("joblib")
    committed = osp.join(FIXTURES, f"tcmr_{compressor}.pkl")
    fresh = str(tmp_path / "fresh.pkl")
    joblib.dump(mk.tcmr_content(seed=len(compressor)), fresh, compress=(compressor, 3))
    for path in (committed, fresh):
        _assert_same_dump(load_joblib(path), joblib.load(path))
    got = load_joblib(committed)
    for k, v in got[1].items():
        np.testing.assert_array_equal(v, expected[f"tcmr/1/{k}"])
    for k in ("f_order", "big_endian"):
        np.testing.assert_array_equal(got[k], expected[f"tcmr/{k}"])
    assert got["objects"].tolist() == expected["tcmr/objects"].tolist()


@pytest.mark.parametrize("head,word", [(b"\x04\x22\x4d\x18", "lz4"), (b"ZF0x1a\n", "ZF")])
def test_load_joblib_refuses_lz4_and_zf(tmp_path, head, word):
    path = _write(tmp_path / "x.pkl", head + bytes(32))
    with pytest.raises(CompressedDumpError, match=word):
        load_joblib(path)


# ---------------------------------------------------------------------------
# refused inputs
# ---------------------------------------------------------------------------

def _jpeg_bytes(**kw) -> bytes:
    from PIL import Image

    buf = io.BytesIO()
    mode = kw.pop("mode", "RGB")
    img = mk.seeded_image(16, 16, 0)
    Image.fromarray(img).convert(mode).save(buf, format="JPEG", **kw)
    return buf.getvalue()


def _patch_sof(data: bytes, marker: int, precision: int = 8) -> bytes:
    i = data.index(b"\xff\xc0")
    return data[:i + 1] + bytes([marker]) + data[i + 2:i + 4] + bytes([precision]) + data[i + 5:]


@pytest.mark.parametrize("case,message", [
    ("arithmetic", "arithmetic coding"),
    ("12bit", "12-bit samples"),
    ("lossless", "lossless"),
    ("hierarchical", "hierarchical"),
    ("cmyk", "CMYK"),
    ("bmp", "not a PNG or JPEG"),
    ("png_crc", "CRC"),
])
def test_unsupported_inputs_raise(tmp_path, case, message):
    if case == "cmyk":
        data = _jpeg_bytes(mode="CMYK")
    elif case == "bmp":
        ok, buf = cv2.imencode(".bmp", mk.seeded_image(8, 8, 0))
        data = buf.tobytes()
    elif case == "png_crc":
        data = bytearray(mk.encode_png(mk.seeded_image(8, 8, 0), 2, 8))
        data[-20] ^= 1  # inside IDAT
        data = bytes(data)
    else:
        base = _jpeg_bytes()
        data = {"arithmetic": lambda: _patch_sof(base, 0xC9),
                "12bit": lambda: _patch_sof(base, 0xC1, 12),
                "lossless": lambda: _patch_sof(base, 0xC3),
                "hierarchical": lambda: _patch_sof(base, 0xC5)}[case]()
    path = _write(tmp_path / f"{case}.img", data)
    with pytest.raises(ValueError, match=message) as info:
        imread(path)
    assert path in str(info.value)


def test_missing_file_raises(tmp_path):
    with pytest.raises(FileNotFoundError):
        imread(str(tmp_path / "nothing.png"))


def test_corrupt_files_raise_or_decode():
    """Seeded corruptions and truncations of a JPEG in three modes and of
    an Adam7 PNG: each read raises ``ValueError`` or gives an array of the
    header's shape; none crashes the process."""
    from recmv_tpu_torch.data import jpeg, png

    rng = np.random.RandomState(0)
    img = mk.seeded_image(37, 45, 1, noise=20.0)
    bases = [cv2.imencode(".jpg", img, p)[1].tobytes() for p in (
        [cv2.IMWRITE_JPEG_QUALITY, 80], [cv2.IMWRITE_JPEG_PROGRESSIVE, 1],
        [cv2.IMWRITE_JPEG_RST_INTERVAL, 1, cv2.IMWRITE_JPEG_SAMPLING_FACTOR,
         cv2.IMWRITE_JPEG_SAMPLING_FACTOR_411])]
    bases.append(mk.encode_png(img[..., ::-1], 2, 8, interlace=True))
    outcomes = {"array": 0, "ValueError": 0}
    for it in range(400):
        data = bytearray(bases[it % 4])
        for _ in range(rng.randint(1, 6)):
            data[rng.randint(2, len(data))] = rng.randint(256)
        if it % 7 == 0:
            data = data[:rng.randint(4, len(data))]
        decode = png.decode if data.startswith(png.SIGNATURE[:4]) else jpeg.decode
        try:
            out, _ = decode(bytes(data))
        except ValueError:
            outcomes["ValueError"] += 1
        else:
            assert out.dtype == np.uint8 and out.ndim == 3 and out.shape[2] == 3
            outcomes["array"] += 1
    assert min(outcomes.values()) > 0, outcomes
