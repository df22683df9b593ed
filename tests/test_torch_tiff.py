"""The port's TIFF decoder (``data/tiff.py``, the LZW, PackBits and
predictor loops of ``ops/csrc/image_codec.c``) against OpenCV on the CPU.

Tolerance everywhere: bitwise. Every variant the port decodes gives
exactly ``cv2.imdecode(buf, IMREAD_COLOR)[..., ::-1]``; every variant it
refuses raises naming ROADMAP item 14; a cut or damaged stream raises
``TiffError`` and never reads out of bounds. Fixtures: the committed
variants of ``tests/data/preprocess`` (written by
``tests/make_torch_fixtures.py`` with OpenCV, PIL and its ``tiff_bytes``)
and variants made here with ``tiff_bytes``."""

import json
import os
import subprocess

import cv2
import numpy as np
import pytest

from jama16_retina_tpu_torch.data import imdecode, tiff
from jama16_retina_tpu_torch.ops import build
from make_torch_fixtures import lzw_encode, packbits_encode, tiff_bytes

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FIXTURES = os.path.join(REPO, "tests", "data", "preprocess")
with open(os.path.join(FIXTURES, "manifest.json")) as _f:
    MANIFEST = json.load(_f)["files"]
DECODED = sorted(n for n, e in MANIFEST.items()
                 if n.endswith(".tif") and "refused" not in e)
REFUSED = sorted(n for n, e in MANIFEST.items() if "refused" in e)


def _read(name: str) -> bytes:
    with open(os.path.join(FIXTURES, name), "rb") as f:
        return f.read()


def _cv2_rgb(data: bytes):
    bgr = cv2.imdecode(np.frombuffer(data, np.uint8), cv2.IMREAD_COLOR)
    return None if bgr is None else np.ascontiguousarray(bgr[..., ::-1])


def _sha(a) -> str:
    import hashlib

    return hashlib.sha256(np.ascontiguousarray(a).tobytes()).hexdigest()


@pytest.mark.parametrize("name", DECODED)
def test_fixture_decodes_bitwise_as_opencv(name):
    data = _read(name)
    entry = MANIFEST[name]
    got = tiff.decode_tiff(data)
    np.testing.assert_array_equal(got, _cv2_rgb(data))
    assert (_sha(got), list(got.shape)) == (entry["cv2_rgb"],
                                            entry["cv2_shape"])
    rgb, why = imdecode.read_image(data)
    assert why is None
    np.testing.assert_array_equal(rgb, got)


@pytest.mark.parametrize("name", REFUSED)
def test_refused_fixture_names_item_14(name):
    data = _read(name)
    with pytest.raises(tiff.TiffError, match="item 14") as e:
        tiff.decode_tiff(data)
    assert e.value.unsupported
    assert MANIFEST[name]["refused"] in str(e.value)
    rgb, why = imdecode.read_image(data)
    assert rgb is None and "item 14" in why


def _image(rng, bits: int, spp: int, h: int = 37, w: int = 45):
    top = 256 if bits == 8 else 65536
    return rng.integers(0, top, (h, w, spp)).astype(
        np.uint8 if bits == 8 else np.uint16)


LAYOUTS = {"strip": dict(rows_per_strip=37), "strips7": dict(
    rows_per_strip=7), "tiles16": dict(tile=(16, 16)),
    "tiles32x48": dict(tile=(32, 48))}
GRID = [(bits, kind, comp, pred, be, layout)
        for bits, kind in (("8", "rgb"), ("8", "rgba"), ("8", "grey"),
                           ("8", "white"), ("16", "rgb"), ("16", "rgba"),
                           ("16", "grey"))
        for comp, pred, be, layout in (
            (1, 1, False, "strip"), (5, 2, True, "strips7"),
            (8, 2, False, "tiles16"), (32946, 1, True, "tiles32x48"),
            (32773, 1, False, "strips7"), (5, 1, False, "tiles32x48"))]


@pytest.mark.parametrize("bits,kind,comp,pred,be,layout", GRID)
def test_generated_variant_decodes_as_opencv(bits, kind, comp, pred, be,
                                             layout):
    """Both byte orders, strips and tiles, chunky and (for 3 or 4
    samples, every other case) planar, each compression and predictor;
    a variant OpenCV reads no image from (an uncompressed tile that is not
    a multiple of 1 KiB) is corrupt here too, and a 16-bit grey tile
    clipped at the right edge (which OpenCV reads wrongly) is refused."""
    rng = np.random.default_rng([int(bits), comp, pred, be])
    spp = {"rgb": 3, "rgba": 4, "grey": 1, "white": 1}[kind]
    img = _image(rng, int(bits), spp)
    planar = 2 if spp > 1 and (comp + pred) % 2 else 1
    kw = dict(compression=comp, predictor=pred, big_endian=be,
              planar=planar, photometric=0 if kind == "white" else None,
              extra_samples=(2,) if kind == "rgba" else None,
              **LAYOUTS[layout])
    data = tiff_bytes(img, **kw)
    want = _cv2_rgb(data)
    rgb, why = imdecode.read_image(data)
    if bits == "16" and spp == 1 and "tile" in kw and 45 % kw["tile"][1]:
        assert rgb is None and "item 14" in why
    elif want is None:
        assert rgb is None and why is None
    else:
        assert why is None
        np.testing.assert_array_equal(rgb, want)


@pytest.mark.parametrize("orientation", range(0, 10))
@pytest.mark.parametrize("layout", ["strips", "tiles", "tiles_planar"])
def test_orientation_is_read_as_opencv_reads_it(orientation, layout):
    """libtiff flips each strip or tile it reads (a horizontal flip of a
    tiled image mirrors each tile in place); OpenCV transposes 5-8."""
    rng = np.random.default_rng(orientation)
    img = rng.integers(0, 256, (40, 50, 3), dtype=np.uint8)
    kw = {"strips": dict(rows_per_strip=7),
          "tiles": dict(tile=(16, 32), compression=8),
          "tiles_planar": dict(tile=(32, 16), compression=5, planar=2)}
    data = tiff_bytes(img, orientation=orientation, **kw[layout])
    np.testing.assert_array_equal(tiff.decode_tiff(data), _cv2_rgb(data))


@pytest.mark.parametrize("colormap", ["16bit", "8bit"])
def test_palette_is_expanded_as_opencv(colormap):
    rng = np.random.default_rng(3)
    top = 65536 if colormap == "16bit" else 256
    cmap = rng.integers(0, top, (256, 3))
    idx = rng.integers(0, 256, (33, 41), dtype=np.uint8)
    for comp in (1, 5):
        data = tiff_bytes(idx, colormap=cmap, compression=comp)
        np.testing.assert_array_equal(tiff.decode_tiff(data), _cv2_rgb(data))


def test_grey_with_alpha_and_other_depths_are_refused():
    rng = np.random.default_rng(4)
    grey_alpha = rng.integers(0, 256, (9, 11, 2), dtype=np.uint8)
    with pytest.raises(tiff.TiffError, match="item 14"):
        tiff.decode_tiff(tiff_bytes(grey_alpha, photometric=1))
    rgb = rng.integers(0, 256, (9, 11, 3), dtype=np.uint8)
    for tags, what in ((((258, (3, [4, 4, 4])),), "4-bit"),
                       (((259, (3, [3])),), "CCITT"),
                       (((266, (3, [2])),), "fill order"),
                       (((317, (3, [3])),), "predictor 3")):
        data = tiff_bytes(rgb, compression=5, extra_tags=tags)
        with pytest.raises(tiff.TiffError, match=what) as e:
            tiff.decode_tiff(data)
        assert e.value.unsupported
    big = b"II+\x00" + bytes(12)
    rgb_, why = imdecode.read_image(big)
    assert rgb_ is None and "BigTIFF" in why


def test_cut_and_mutated_files_raise_tiff_error():
    """Every cut of a small LZW TIFF and of the Messidor-size one's head,
    and many random byte changes, decode or raise ``TiffError``: never
    another exception, and never a large allocation for a bogus size."""
    rng = np.random.default_rng(5)
    sources = [_read("t_be_lzw_pred.tif"), _read("t_tiles_deflate_pred.tif"),
               _read("t_white_packbits.tif"), _read("t_planar_lzw.tif")]
    n_raised = 0
    for data in sources:
        cuts = range(0, len(data), max(1, len(data) // 150))
        mutants = [data[:c] for c in cuts]
        for _ in range(150):
            m = bytearray(data)
            for _ in range(int(rng.integers(1, 6))):
                at = int(rng.integers(0, len(m)))
                if rng.random() < 0.5:
                    at = len(m) - 1 - at % min(len(m), 400)  # the IFD
                m[at] = int(rng.integers(0, 256))
            mutants.append(bytes(m))
        for m in mutants:
            try:
                tiff.decode_tiff(m)
            except tiff.TiffError:
                n_raised += 1
    assert n_raised > 100


def test_unpacking_stays_in_bounds_under_address_sanitizer(tmp_path):
    """``tests/fuzz_image_codec.c`` drives the LZW and PackBits unpacking
    (whole, cut and mutated strips, and random LZW codes, most past the
    table), the predictor and the JPEG encoder, built with the codec under
    ``-fsanitize=address,undefined``; any access out of bounds aborts."""
    exe = tmp_path / "fuzz_image_codec"
    cmd = [build.host_cc(), "-O1", "-g", "-std=c11",
           "-fsanitize=address,undefined", "-fno-sanitize-recover=all",
           "-o", str(exe), os.path.join(REPO, "tests", "fuzz_image_codec.c"),
           str(build.source_path("image_codec"))]
    made = subprocess.run(cmd, capture_output=True, text=True, timeout=120)
    assert made.returncode == 0, made.stdout + made.stderr
    rng = np.random.default_rng(6)
    raw = (rng.integers(0, 6, 12000) * 40).astype(np.uint8).tobytes()
    args = []
    for kind, packed in (("lzw", lzw_encode(raw)),
                         ("packbits", packbits_encode(raw))):
        path = tmp_path / f"strip.{kind}"
        path.write_bytes(packed)
        args.append(f"{kind}:{path}")
    out = subprocess.run([str(exe), "150", *args], capture_output=True,
                         text=True, timeout=120,
                         env={**os.environ, "ASAN_OPTIONS": "detect_leaks=0"})
    assert out.returncode == 0, out.stderr[-3000:]
    tag, decoded, refused = out.stdout.split()
    assert tag == "OK" and int(decoded) > 0 and int(refused) > 0


def test_lzw_and_packbits_unpack_what_libtiff_packs():
    """The unpackers against the packers of ``make_torch_fixtures`` (whose
    LZW is byte for byte libtiff's): long runs fill and clear the LZW
    table several times; an output shorter than the data cuts it."""
    rng = np.random.default_rng(7)
    for raw in (bytes(20000), rng.integers(0, 3, 30000).astype(
            np.uint8).tobytes(), rng.integers(0, 256, 5000).astype(
            np.uint8).tobytes()):
        for comp, packed in ((5, lzw_encode(raw)),
                             (32773, packbits_encode(raw))):
            got = tiff._unpack(packed, comp, len(raw))
            assert got.tobytes() == raw
            assert tiff._unpack(packed, comp, 100).tobytes() == raw[:100]
            with pytest.raises(tiff.TiffError):
                tiff._unpack(packed[:len(packed) // 2], comp, len(raw))
