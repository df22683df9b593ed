"""The port's image codec (``data/jpeg.py``, ``data/png.py``,
``data/imdecode.py``, ``ops/csrc/image_codec.c``) and JPEG records
against OpenCV, TensorFlow and the JAX pipeline on the CPU.

Tolerance everywhere: bitwise. A JPEG decodes to exactly what
``cv2.imdecode(IMREAD_COLOR)[..., ::-1]`` returns (EXIF orientation
applied) and exactly what ``tf.io.decode_jpeg(dct_method=
"INTEGER_ACCURATE")`` returns (EXIF ignored); a PNG to exactly what
OpenCV returns; a JPEG split streams exactly as the JAX pipeline streams
it, resized as it resizes. Fixtures: ``tests/data/jpeg`` (written by
``tests/make_torch_fixtures.py``), checked against their manifest too."""

import functools
import hashlib
import io
import json
import os
import struct
import subprocess
import sys
import zlib

import cv2
import numpy as np
import pytest
import tensorflow as tf
import torch
from hypothesis import given, settings
from hypothesis import strategies as st

from jama16_retina_tpu.data import pipeline as jax_pipeline
from jama16_retina_tpu.data import tfrecord as jax_tfrecord
from jama16_retina_tpu_torch import configs
from jama16_retina_tpu_torch.data import imdecode, jpeg, pipeline, png
from jama16_retina_tpu_torch.data import tfrecord
from jama16_retina_tpu_torch.ops import build
from make_torch_fixtures import SAMPLING, exif_app1, with_exif

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FIXTURES = os.path.join(REPO, "tests", "data", "jpeg")
with open(os.path.join(FIXTURES, "manifest.json")) as _f:
    MANIFEST = json.load(_f)
JPEGS = sorted(n for n in MANIFEST if n.endswith(".jpg")
               and not n.startswith("progressive"))
PROGRESSIVE = sorted(n for n in MANIFEST if n.startswith("progressive"))
PNGS = sorted(n for n in MANIFEST if n.endswith(".png"))
BATCH = 4


def _read(name: str) -> bytes:
    with open(os.path.join(FIXTURES, name), "rb") as f:
        return f.read()


def _sha(a) -> str:
    return hashlib.sha256(np.ascontiguousarray(a).tobytes()).hexdigest()


def _cv2_rgb(data: bytes) -> np.ndarray:
    return cv2.imdecode(np.frombuffer(data, np.uint8),
                        cv2.IMREAD_COLOR)[..., ::-1]


def _tf_rgb(data: bytes) -> np.ndarray:
    return tf.io.decode_jpeg(data, channels=3,
                             dct_method="INTEGER_ACCURATE").numpy()


@pytest.mark.parametrize("name", JPEGS)
def test_fixture_decodes_bitwise_as_opencv_and_tensorflow(name):
    data = _read(name)
    entry = MANIFEST[name]
    assert hashlib.sha256(data).hexdigest() == entry["sha256"]
    host = jpeg.decode_jpeg(data, exif_orientation=True)
    records = jpeg.decode_jpeg(data, exif_orientation=False)
    np.testing.assert_array_equal(host, _cv2_rgb(data))
    np.testing.assert_array_equal(records, _tf_rgb(data))
    assert (_sha(host), list(host.shape)) == (entry["cv2_rgb"],
                                              entry["cv2_shape"])
    assert (_sha(records), list(records.shape)) == (entry["tf_rgb"],
                                                    entry["tf_shape"])
    np.testing.assert_array_equal(imdecode.imdecode(data), host)


@pytest.mark.parametrize("name", PROGRESSIVE)
def test_progressive_fixture_decodes_bitwise_as_opencv_and_tensorflow(name):
    """SOF2 frames (cv2's jpeg_simple_progression: DC first and refine, AC
    first and refine, spectral bands; 4:2:0, 4:4:4, grey, a restart
    interval, optimized tables between scans) decode bitwise on both
    paths."""
    data = _read(name)
    assert b"\xff\xc2" in data
    test_fixture_decodes_bitwise_as_opencv_and_tensorflow(name)


def _scan_starts(data: bytes) -> "list[int]":
    return [i for i in range(len(data) - 1) if data[i:i + 2] == b"\xff\xda"]


@pytest.mark.parametrize("name", PROGRESSIVE)
def test_truncated_progressive_jpeg_is_refused(name):
    """Cut inside a scan, or between scans without EOI: refused as
    truncated, where libjpeg warns and decodes what it has."""
    data = _read(name)
    scans = _scan_starts(data)
    assert len(scans) >= 6
    for cut in (len(data) // 2, scans[-1] + 20, scans[-1]):
        with pytest.raises(jpeg.JpegError) as e:
            jpeg.decode_jpeg(data[:cut], exif_orientation=False)
        assert e.value.code == -2 and not e.value.unsupported, cut
    # Without its EOI marker alone the stream is whole: decoded.
    np.testing.assert_array_equal(
        jpeg.decode_jpeg(data[:-2], exif_orientation=False), _tf_rgb(data))


def test_progressive_jpeg_is_refused_naming_its_item():
    """A progressive stream that ends (with EOI) before the scan refining
    coefficients 1-9 to full precision: libjpeg smooths such blocks
    (jdcoefct.c), so the port refuses it naming item 14."""
    data = _read("progressive.jpg")
    scans = _scan_starts(data)
    cut = data[:scans[-1]] + b"\xff\xd9"
    with pytest.raises(jpeg.JpegError, match="item 14") as e:
        jpeg.decode_jpeg(cut, exif_orientation=False)
    assert e.value.unsupported and e.value.code == -13
    rgb, why = imdecode.read_image(cut)
    assert rgb is None and "progressive" in why and "item 14" in why


@pytest.mark.parametrize("name", PNGS)
def test_png_fixture_decodes_bitwise_as_opencv(name):
    data = _read(name)
    got = png.decode_png(data)
    np.testing.assert_array_equal(got, _cv2_rgb(data))
    assert _sha(got) == MANIFEST[name]["cv2_rgb"]
    np.testing.assert_array_equal(imdecode.imdecode(data), got)


@pytest.mark.parametrize("mode,bits", [("P", 8), ("P", 4), ("P", 1),
                                       ("1", 1), ("LA", 8), ("I;16", 16)])
def test_png_palette_and_depths_decode_bitwise_as_opencv(mode, bits):
    from PIL import Image

    img = np.random.default_rng(bits).integers(0, 256, (23, 37, 3),
                                               dtype=np.uint8)
    pil = Image.fromarray(img)
    if mode == "P":
        pil = pil.quantize(colors=1 << min(bits, 8))
    elif mode == "I;16":
        pil = Image.fromarray(img[..., 0].astype(np.uint16) * 251)
    else:
        pil = pil.convert(mode)
    buf = io.BytesIO()
    pil.save(buf, format="PNG", **({"bits": bits} if mode == "P" else {}))
    data = buf.getvalue()
    assert struct.unpack(">B", data[24:25])[0] == bits
    np.testing.assert_array_equal(png.decode_png(data), _cv2_rgb(data))


def test_interlaced_png_and_other_formats_are_refused():
    """(A TIFF that ``data/tiff.py`` decodes is not refused since the
    preprocess runners' slice: it decodes as OpenCV decodes it; a CMYK
    one still is.)"""
    from PIL import Image

    img = np.zeros((8, 8, 3), np.uint8)
    ok, tiff = cv2.imencode(".tiff", img)
    np.testing.assert_array_equal(imdecode.imdecode(tiff.tobytes()),
                                  _cv2_rgb(tiff.tobytes()))
    cmyk = io.BytesIO()
    Image.fromarray(img).convert("CMYK").save(cmyk, format="TIFF")
    ok, bmp = cv2.imencode(".bmp", img)
    for data, what in ((cmyk.getvalue(), "TIFF"), (bmp.tobytes(), "BMP")):
        rgb, why = imdecode.read_image(data)
        assert rgb is None and why.startswith(what) and "item 14" in why
    assert imdecode.read_image(b"not an image at all") == (None, None)
    # An Adobe marker with transform 0 (and no JFIF): libjpeg reads RGB.
    ok, buf = cv2.imencode(".jpg", img)
    data = buf.tobytes()
    app0_end = 4 + struct.unpack(">H", data[4:6])[0]
    adobe = b"Adobe" + struct.pack(">HHHB", 100, 0, 0, 0)
    rgb_jpeg = (data[:2] + b"\xff\xee" + struct.pack(">H", len(adobe) + 2)
                + adobe + data[app0_end:])
    rgb, why = imdecode.read_image(rgb_jpeg)
    assert rgb is None and why.startswith("JPEG in RGB") and "item 14" in why
    assert imdecode.read_image(b"\xff\xd8\xff\xe0junk") == (None, None)
    # Adam7: the IHDR's interlace byte set on a real stream.
    ok, p = cv2.imencode(".png", img)
    raw = bytearray(p.tobytes())
    raw[28] = 1
    raw[29:33] = struct.pack(">I", zlib.crc32(bytes(raw[12:29])))
    with pytest.raises(png.PngError, match="item 14"):
        png.decode_png(bytes(raw))


@pytest.mark.parametrize("size", [64, 139, 299])
def test_jax_written_jpeg_records_decode_as_tensorflow(tmp_path, size):
    paths = jax_tfrecord.write_synthetic_split(
        str(tmp_path), "val", 3, size, num_shards=1, seed=size,
        encoding="jpeg")
    parse = jax_tfrecord.parse_fn()
    for data in tfrecord.read_records(paths[0]):
        want, grade, name = parse(tf.constant(data))
        rec = tfrecord.parse_record(data)
        np.testing.assert_array_equal(rec.image, want.numpy())
        assert (rec.grade, rec.name) == (int(grade), name.numpy())


@settings(max_examples=25, deadline=None)
@given(h=st.integers(1, 80), w=st.integers(1, 80),
       sampling=st.sampled_from(sorted(SAMPLING)),
       quality=st.integers(1, 100), restart=st.integers(0, 6),
       grey=st.booleans(), seed=st.integers(0, 2 ** 16))
def test_random_jpegs_decode_bitwise_as_opencv(h, w, sampling, quality,
                                                restart, grey, seed):
    img = np.random.default_rng(seed).integers(0, 256, (h, w, 3),
                                               dtype=np.uint8)
    params = [cv2.IMWRITE_JPEG_QUALITY, quality,
              cv2.IMWRITE_JPEG_SAMPLING_FACTOR, SAMPLING[sampling],
              cv2.IMWRITE_JPEG_RST_INTERVAL, restart]
    ok, buf = cv2.imencode(".jpg", img[..., 0] if grey else img, params)
    data = buf.tobytes()
    got = jpeg.decode_jpeg(data, exif_orientation=False)
    np.testing.assert_array_equal(got, _cv2_rgb(data))


@pytest.mark.parametrize("big_endian", [True, False])
@pytest.mark.parametrize("orientation", range(1, 9))
def test_exif_orientation_applies_to_the_host_path_only(orientation,
                                                        big_endian):
    img = np.random.default_rng(orientation).integers(
        0, 256, (21, 34, 3), dtype=np.uint8)
    ok, buf = cv2.imencode(".jpg", img)
    data = with_exif(buf.tobytes(), orientation, big_endian)
    assert exif_app1(orientation, big_endian) in data
    host = jpeg.decode_jpeg(data, exif_orientation=True)
    np.testing.assert_array_equal(host, _cv2_rgb(data))
    np.testing.assert_array_equal(
        jpeg.decode_jpeg(data, exif_orientation=False), _tf_rgb(data))
    assert host.shape[:2] == ((34, 21) if orientation >= 5 else (21, 34))


_BAD_INPUT = r"""
import sys
import numpy as np
from jama16_retina_tpu_torch.data import jpeg
data = open(sys.argv[1], "rb").read()
want = jpeg.decode_jpeg(data, exif_orientation=False)
n_raised = n_decoded = 0
for cut in range(0, len(data) - 2, 7):
    try:
        jpeg.decode_jpeg(data[:cut], exif_orientation=False)
    except jpeg.JpegError:
        n_raised += 1
    else:
        raise SystemExit(f"a stream cut at {cut} of {len(data)} decoded")
rng = np.random.default_rng(0)
for trial in range(300):
    bad = bytearray(data)
    for _ in range(1 + trial % 4):
        bit = int(rng.integers(0, 8 * len(bad)))
        bad[bit // 8] ^= 1 << (bit % 8)
    try:
        out = jpeg.decode_jpeg(bytes(bad), exif_orientation=False)
        assert out.dtype == np.uint8 and out.ndim == 3
        n_decoded += 1
    except jpeg.JpegError:
        n_raised += 1
print("OK", n_raised, n_decoded)
"""


@pytest.mark.parametrize("name", ["small_rst.jpg", "fundus299_0.jpg"])
def test_truncated_and_bit_flipped_streams_raise_and_never_crash(name):
    """In a subprocess, so a crash is a failed test, not a dead worker:
    every cut inside the entropy data raises ``JpegError``; a flipped bit
    raises it or decodes to some image of the header's shape."""
    out = subprocess.run(
        [sys.executable, "-c", _BAD_INPUT, os.path.join(FIXTURES, name)],
        cwd=REPO, capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr[-2000:]
    assert out.stdout.split()[0] == "OK"


def _segments(data: bytes) -> list:
    """(marker, offset, length) of each header segment up to the first
    SOS."""
    at, out = 2, []
    while True:
        marker = data[at + 1]
        length = struct.unpack(">H", data[at + 2:at + 4])[0]
        out.append((marker, at, length))
        if marker == 0xDA:
            return out
        at += 2 + length


@pytest.mark.parametrize("first", [2, 3, 12])
def test_an_oversubscribed_huffman_table_is_refused_as_opencv_refuses_it(
        first):
    """Codes moved to length 1 of each Huffman table in turn, the
    table's symbol count kept so the segment still parses: ``first``
    codes of one bit do not fit (2 would make the all-ones code, which
    libjpeg refuses too; 12 is every symbol of a DC table). The decoder raises ``JpegError``, as OpenCV
    refuses the stream, and writes nothing out of its table."""
    data = _read("small_420.jpg")
    tables = [at for m, at, _ in _segments(data) if m == 0xC4]
    assert len(tables) == 4
    for at in tables:
        bad = bytearray(data)
        counts = bad[at + 5:at + 21]
        need = first - counts[0]
        for k in range(15, 0, -1):
            take = min(need, counts[k])
            counts[k] -= take
            need -= take
        assert need == 0
        counts[0] = first
        bad[at + 5:at + 21] = counts
        with pytest.raises(jpeg.JpegError, match="corrupt"):
            jpeg.decode_jpeg(bytes(bad), exif_orientation=False)
        assert cv2.imdecode(np.frombuffer(bytes(bad), np.uint8),
                            cv2.IMREAD_COLOR) is None


def test_a_scan_header_cut_after_its_length_is_refused():
    """An SOS whose length field says 2, at the very end of the buffer:
    refused without reading the component count past the end."""
    data = _read("small_420.jpg")
    sos = next(at for m, at, _ in _segments(data) if m == 0xDA)
    with pytest.raises(jpeg.JpegError):
        jpeg.decode_jpeg(data[:sos] + b"\xff\xda\x00\x02",
                         exif_orientation=False)


def test_mutated_streams_stay_in_bounds_under_address_sanitizer(tmp_path):
    """``tests/fuzz_image_codec.c`` drives the decoder, built with it
    under ``-fsanitize=address,undefined``, over cut, mutated and
    oversubscribed-table copies of four fixtures (restart markers, 4:2:0,
    4:1:1, grey); any access out of bounds aborts it."""
    exe = tmp_path / "fuzz_image_codec"
    cmd = [build.host_cc(), "-O1", "-g", "-std=c11",
           "-fsanitize=address,undefined", "-fno-sanitize-recover=all",
           "-o", str(exe), os.path.join(REPO, "tests", "fuzz_image_codec.c"),
           str(build.source_path("image_codec"))]
    made = subprocess.run(cmd, capture_output=True, text=True, timeout=120)
    assert made.returncode == 0, made.stdout + made.stderr
    names = ["small_420.jpg", "small_rst.jpg", "small_411.jpg",
             "small_grey.jpg"]
    out = subprocess.run(
        [str(exe), "200", *[os.path.join(FIXTURES, n) for n in names]],
        capture_output=True, text=True, timeout=120,
        env={**os.environ, "ASAN_OPTIONS": "detect_leaks=0"})
    assert out.returncode == 0, out.stderr[-3000:]
    tag, decoded, refused = out.stdout.split()
    assert tag == "OK" and int(decoded) > 0 and int(refused) > 0


@pytest.fixture(scope="module")
def jpeg_splits(tmp_path_factory):
    """JPEG splits written by the JAX writer: ``val`` at 64 px in 3
    shards, and ``big`` at 71 px (read back at 64, the resize path)."""
    root = tmp_path_factory.mktemp("jpeg_splits")
    jax_tfrecord.write_synthetic_split(str(root), "val", 11, 64,
                                       num_shards=3, seed=5,
                                       encoding="jpeg")
    jax_tfrecord.write_synthetic_split(str(root), "big", 9, 71,
                                       num_shards=2, seed=6,
                                       encoding="jpeg")
    return str(root)


@pytest.mark.parametrize("split,size", [("val", 64), ("big", 64)])
def test_jpeg_eval_stream_is_the_references_bitwise(jpeg_splits, split,
                                                    size):
    want = list(jax_pipeline.eval_batches(
        jpeg_splits, split, BATCH, size, process_index=0, process_count=1))
    got = list(pipeline.eval_batches(jpeg_splits, split, BATCH, size))
    assert len(got) == len(want) > 1
    for g, w in zip(got, want):
        for k in w:
            np.testing.assert_array_equal(g[k], w[k], err_msg=k)


def test_jpeg_train_stream_epochs_are_permutations(jpeg_splits):
    recs = [tfrecord.parse_record(d) for p in tfrecord.list_split(
        jpeg_splits, "val") for d in tfrecord.read_records(p)]
    by_image = {r.image.tobytes(): r.name for r in recs}
    n = len(by_image)
    it = pipeline.train_batches(jpeg_splits, "val",
                                configs.DataConfig(batch_size=BATCH), 64,
                                seed=3)
    batches = [next(it) for _ in range(2 * n // BATCH + 1)]
    it.close()
    names = [by_image[img.tobytes()] for b in batches
             for img in b["image"].numpy()]
    assert all(b["image"].dtype == torch.uint8 for b in batches)
    for e in (names[:n], names[n:2 * n]):
        assert sorted(e) == sorted(by_image.values())


def test_a_317_px_split_is_resized_to_299_as_the_reference(tmp_path):
    jax_tfrecord.write_synthetic_split(str(tmp_path), "test", 3, 317,
                                       num_shards=1, seed=8,
                                       encoding="jpeg")
    want = list(jax_pipeline.eval_batches(
        str(tmp_path), "test", BATCH, 299, process_index=0,
        process_count=1))
    got = list(pipeline.eval_batches(str(tmp_path), "test", BATCH, 299))
    assert len(got) == len(want) == 1
    np.testing.assert_array_equal(got[0]["image"], want[0]["image"])


def test_make_jpeg_example_reads_back_through_the_reference(tmp_path):
    data = _read("small_420.jpg")
    tfrecord.write_example_shards(
        [tfrecord.make_jpeg_example(data, 3, "s0", 0.5)], str(tmp_path),
        "test", 1)
    (path,) = tfrecord.list_split(str(tmp_path), "test")
    (raw,) = tfrecord.read_records(path)
    want, grade, name = jax_tfrecord.parse_fn()(tf.constant(raw))
    rec = tfrecord.parse_record(raw)
    np.testing.assert_array_equal(rec.image, want.numpy())
    assert (rec.grade, rec.name, rec.quality) == (3, b"s0", 0.5)
    assert int(grade) == 3 and name.numpy() == b"s0"


def test_the_codec_is_built_by_the_host_compiler(monkeypatch, tmp_path):
    assert "image_codec" in build.sources()
    path = build.library_path("image_codec")
    assert path.parent == build.BUILD_DIR and path.suffix == ".so"
    build.build_all(["image_codec"])
    assert path.is_file()
    monkeypatch.setenv("CC", "")
    monkeypatch.setenv("PATH", str(tmp_path))
    with pytest.raises(RuntimeError, match="no host C compiler"):
        build.host_cc()


def test_the_codec_library_is_named_after_its_compiler(monkeypatch,
                                                       tmp_path):
    """Another compiler (another machine's, say) gives the library
    another name, so a build from elsewhere is never loaded."""
    here = build.library_path("image_codec")
    other = tmp_path / "cc"
    other.write_text("#!/bin/sh\necho 'other cc 1.0'\n")
    other.chmod(0o755)
    monkeypatch.setenv("CC", str(other))
    assert build.host_cc() == str(other)
    assert build.library_path("image_codec") != here
    assert build.library_path("image_codec").parent == here.parent


# The encoder: cv2.imencode's bytes. Sizes cross the MCU (16 px) and block
# (8 px) edges every way: one pixel, under one block, odd sizes, the
# model's size, a render's, and an odd size near 1000 px.
ENCODE_SIZES = [(1, 1), (7, 9), (37, 53), (299, 299), (317, 317),
                (997, 1003)]


@functools.lru_cache(maxsize=None)
def _encode_input(kind: str, h: int, w: int) -> np.ndarray:
    if kind == "random":
        return np.random.default_rng(h * 7919 + w).integers(
            0, 256, (h, w, 3), dtype=np.uint8)
    from jama16_retina_tpu.data import synthetic

    size = max(h, w)
    disc = synthetic.render_fundus(np.random.default_rng(size), 3,
                                   synthetic.SynthConfig(image_size=size))
    return np.ascontiguousarray(disc[:h, :w])


def _cv2_jpeg(rgb: np.ndarray, quality: int) -> bytes:
    ok, buf = cv2.imencode(".jpg", rgb[..., ::-1],
                           [int(cv2.IMWRITE_JPEG_QUALITY), quality])
    assert ok
    return buf.tobytes()


@pytest.mark.parametrize("kind", ["random", "rendered"])
@pytest.mark.parametrize("h,w", ENCODE_SIZES)
def test_encode_jpeg_is_opencvs_bytes(h, w, kind):
    rgb = _encode_input(kind, h, w)
    assert jpeg.encode_jpeg(rgb) == _cv2_jpeg(rgb, 92)
    assert jpeg.encode_jpeg(rgb, quality=92) == jpeg.encode_jpeg(rgb)


@pytest.mark.parametrize("quality", [50, 75, 100])
@pytest.mark.parametrize("h,w", ENCODE_SIZES)
def test_encode_jpeg_is_opencvs_bytes_at_other_qualities(h, w, quality):
    for kind in ("random", "rendered"):
        rgb = _encode_input(kind, h, w)
        assert jpeg.encode_jpeg(rgb, quality) == _cv2_jpeg(rgb, quality)


def test_encode_jpeg_decodes_back_and_refuses_other_arrays():
    rgb = _encode_input("rendered", 64, 64)
    data = jpeg.encode_jpeg(rgb)
    np.testing.assert_array_equal(
        jpeg.decode_jpeg(data, exif_orientation=False), _cv2_rgb(data))
    for bad in (rgb[..., :2], rgb.astype(np.float32), rgb[..., 0]):
        with pytest.raises(ValueError, match="uint8 HW3"):
            jpeg.encode_jpeg(bad)


def test_write_synthetic_split_jpeg_is_the_references_bytes(tmp_path):
    """The default encoding is the reference's, and the shards are its
    bytes (framing, Examples and JPEG streams)."""
    for root, writer in ((tmp_path / "jax", jax_tfrecord),
                         (tmp_path / "port", tfrecord)):
        writer.write_synthetic_split(str(root), "val", 7, 48, num_shards=3,
                                     seed=4)
    for name in sorted(os.listdir(tmp_path / "jax")):
        assert (tmp_path / "jax" / name).read_bytes() == \
            (tmp_path / "port" / name).read_bytes(), name
    assert len(os.listdir(tmp_path / "port")) == 3
