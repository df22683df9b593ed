"""Writes the image fixtures of the port's codec tests into
``tests/data/jpeg/`` with their ``manifest.json``.

    python tests/make_torch_fixtures.py [jpeg] [preprocess] [hbm] [grain]

It needs the JAX package's synthetic renderer, OpenCV and TensorFlow, so
it runs where the reference runs, not on the card machine. The manifest
holds, for each file, its sha256, the sha256 of OpenCV's RGB decode
(``cv2.imdecode(IMREAD_COLOR)[..., ::-1]``, EXIF orientation applied),
that of TensorFlow's (``tf.io.decode_jpeg(channels=3,
dct_method="INTEGER_ACCURATE")``, EXIF ignored; JPEG only) with their
shapes, and for the photographs the sha256 of the port's
``resize_and_center_fundus`` canvas at 299 px. ``chip_smoke.py`` holds the
card machine's host to these digests; the CPU tests hold the decoders
to OpenCV and TensorFlow directly.

It also writes ``tests/data/preprocess/``: TIFF variants made with
OpenCV, PIL and the small TIFF writer here (``tiff_bytes``; decoded ones
with the sha256 of OpenCV's RGB decode, refused ones with the format
they stand for), larger JPEG photos and a Messidor-size TIFF, and a
``manifest.json`` with the sha256 of ``cv2.imencode`` of every photo and
canvas at quality 92, the runners' directory specs (names, the photo
each name copies, grades) and, for each spec and run, the sha256 of
every file the reference's ``preprocess_eyepacs.py`` or
``preprocess_messidor.py`` wrote and the JSON report it printed.

``grain`` writes ``tests/data/grain_order.json`` from the ``grain``
package and the reference's grain loader: for seeds 0, 1, 42 and
2**32-1 the sha256 of grain's ``index_shuffle`` permutations of
``[0, m]`` for every m from 0 to 300, end to end (int64); for seeds 0
and 42 the sha256 of the record keys of the first two epochs of
``IndexSampler`` over ``chip_smoke.GRAIN_RECORDS`` records; and, for
the reference's ``make_train_iterator`` over that many records at
``chip_smoke.GRAIN_SIZE`` px, batch ``chip_smoke.GRAIN_BATCH``, seed
``chip_smoke.GRAIN_SEED`` and each of ``chip_smoke.GRAIN_WORKERS``, the
sha256 of its ``get_state()`` bytes after each of
``chip_smoke.GRAIN_STATE_AT`` batches.

``hbm`` writes ``tests/data/jpeg/hbm_load.json``: for each split of the
JPEG records ``chip_smoke.write_jpeg_splits`` packs from the fixtures
above, the sha256 of the images and grades that the reference's
``hbm_pipeline.load_split_numpy`` decodes from it at 299 px (OpenCV's
JPEG decode with EXIF applied, its INTER_LINEAR for the 317-px records).
"""

from __future__ import annotations

import hashlib
import json
import os
import shutil
import struct
import subprocess
import sys
import tempfile
import zlib

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))
OUT = os.path.join(HERE, "data", "jpeg")
PRE_OUT = os.path.join(HERE, "data", "preprocess")
REPO = os.path.dirname(HERE)
sys.path.insert(0, REPO)

SAMPLING = {"420": 0x221111, "422": 0x211111, "440": 0x121111,
            "411": 0x411111, "444": 0x111111}


def sha(b) -> str:
    return hashlib.sha256(bytes(b)).hexdigest()


def exif_app1(orientation: int, big_endian: bool = True) -> bytes:
    """An APP1 segment holding a TIFF IFD0 with one Orientation entry."""
    e = ">" if big_endian else "<"
    tiff = (b"MM" if big_endian else b"II") + struct.pack(e + "HI", 42, 8)
    tiff += struct.pack(e + "H", 1)
    tiff += struct.pack(e + "HHI", 0x0112, 3, 1) + struct.pack(
        e + "HH", orientation, 0)
    tiff += struct.pack(e + "I", 0)
    body = b"Exif\x00\x00" + tiff
    return b"\xff\xe1" + struct.pack(">H", len(body) + 2) + body


def with_exif(jpeg_bytes: bytes, orientation: int,
              big_endian: bool = True) -> bytes:
    """``jpeg_bytes`` with an EXIF APP1 after its JFIF APP0 (or SOI)."""
    pos = 2
    if jpeg_bytes[2:4] == b"\xff\xe0":
        pos = 4 + struct.unpack(">H", jpeg_bytes[4:6])[0]
    return jpeg_bytes[:pos] + exif_app1(orientation, big_endian) + \
        jpeg_bytes[pos:]


def encode(rgb: np.ndarray, *params) -> bytes:
    import cv2

    arr = rgb[..., ::-1] if rgb.ndim == 3 else rgb
    ok, buf = cv2.imencode(".jpg", arr, list(params))
    assert ok
    return buf.tobytes()


def render(seed: int, grade: int, size: int) -> np.ndarray:
    from jama16_retina_tpu.data import synthetic

    return synthetic.render_fundus(np.random.default_rng(seed), grade,
                                   synthetic.SynthConfig(image_size=size))


def files() -> "dict[str, tuple[bytes, bool]]":
    """name -> (bytes, is a photograph to normalize)."""
    import cv2

    q = cv2.IMWRITE_JPEG_QUALITY
    out = {}
    for i in range(8):
        out[f"fundus299_{i}.jpg"] = (encode(render(100 + i, i % 5, 299),
                                            q, 92), True)
    for i in range(4):
        out[f"fundus317_{i}.jpg"] = (encode(render(200 + i, (i + 2) % 5, 317),
                                            q, 92), True)
    out["fundus1024.jpg"] = (encode(render(300, 3, 1024), q, 92), True)
    small = render(400, 4, 64)[5:42, 3:56]  # 37 x 53
    for name, factor in SAMPLING.items():
        out[f"small_{name}.jpg"] = (encode(
            small, q, 92, cv2.IMWRITE_JPEG_SAMPLING_FACTOR, factor), False)
    out["small_grey.jpg"] = (encode(small[..., 1], q, 92), False)
    out["small_rst.jpg"] = (encode(small, q, 92,
                                   cv2.IMWRITE_JPEG_RST_INTERVAL, 2), False)
    out["small_optimize.jpg"] = (encode(small, q, 92,
                                        cv2.IMWRITE_JPEG_OPTIMIZE, 1), False)
    out["small_q50.jpg"] = (encode(small, q, 50), False)
    out["small_q100.jpg"] = (encode(small, q, 100), False)
    out["exif6.jpg"] = (with_exif(encode(render(500, 2, 299)[:, 20:280],
                                         q, 92), 6), True)
    out["progressive.jpg"] = (encode(render(600, 1, 299), q, 92,
                                     cv2.IMWRITE_JPEG_PROGRESSIVE, 1), True)
    prog = [q, 92, cv2.IMWRITE_JPEG_PROGRESSIVE, 1]
    for name, img, extra in (
            ("420", small, []),
            ("444", small, [cv2.IMWRITE_JPEG_SAMPLING_FACTOR, 0x111111]),
            ("grey", small[..., 1], []),
            ("rst", small, [cv2.IMWRITE_JPEG_RST_INTERVAL, 2]),
            ("optimize", small, [cv2.IMWRITE_JPEG_OPTIMIZE, 1])):
        out[f"progressive_{name}.jpg"] = (encode(img, *prog, *extra), False)
    png_src = render(700, 3, 96)
    for name, arr in (("rgb", png_src[..., ::-1]),
                      ("rgba", np.dstack([png_src[..., ::-1],
                                          png_src[..., :1]])),
                      ("grey", png_src[..., 1]),
                      ("16bit", png_src[..., ::-1].astype(np.uint16) * 257
                       + np.uint16(91))):
        ok, buf = cv2.imencode(".png", arr)
        assert ok
        out[f"png_{name}.png"] = (buf.tobytes(), name != "grey")
    return out


def lzw_encode(data: bytes) -> bytes:
    """TIFF LZW as libtiff writes it: MSB-first codes from 9 to 12 bits,
    the width growing when the next free entry passes 511, 1023, 2047;
    Clear first and when the table fills; EOI last."""
    out = bytearray()
    acc = nacc = 0
    nbits, nxt = 9, 258
    def emit(code):
        nonlocal acc, nacc
        acc = (acc << nbits) | code
        nacc += nbits
        while nacc >= 8:
            out.append((acc >> (nacc - 8)) & 0xFF)
            nacc -= 8
    def bump():
        nonlocal nbits, nxt, table
        nxt += 1
        if nxt == 4094:
            emit(256)
            table = {bytes([i]): i for i in range(256)}
            nxt, nbits = 258, 9
        elif nxt > (1 << nbits) - 1:
            nbits += 1
    table = {bytes([i]): i for i in range(256)}
    emit(256)
    w = b""
    for b in data:
        wc = w + bytes([b])
        if wc in table:
            w = wc
            continue
        emit(table[w])
        table[wc] = nxt
        bump()
        w = bytes([b])
    if w:
        emit(table[w])
        bump()
    emit(257)
    if nacc:
        out.append((acc << (8 - nacc)) & 0xFF)
    return bytes(out)


def packbits_encode(data: bytes) -> bytes:
    """PackBits: runs of 2-128 equal bytes, literals of up to 128."""
    out, i, n = bytearray(), 0, len(data)
    while i < n:
        j = i
        while j + 1 < n and data[j + 1] == data[i] and j - i < 127:
            j += 1
        if j > i:
            out += bytes([(257 - (j - i + 1)) & 0xFF, data[i]])
            i = j + 1
            continue
        j = i
        while j < n and j - i < 128 and not (
                j + 1 < n and data[j + 1] == data[j]):
            j += 1
        j = max(j, i + 1)
        out.append(j - i - 1)
        out += data[i:j]
        i = j
    return bytes(out)


def _predict(a):
    """Horizontal differencing along axis 1 (modular)."""
    d = a.copy()
    d[:, 1:] = a[:, 1:] - a[:, :-1]
    return d


def tiff_bytes(img, *, compression=1, predictor=1, big_endian=False,
               tile=None, rows_per_strip=None, planar=1, photometric=None,
               extra_samples=None, orientation=None, colormap=None,
               extra_tags=()):
    """A one-page TIFF of ``img`` ([H, W] or [H, W, spp], uint8 or
    uint16): the chunks after the header, then the directory and its
    out-of-line values; ``extra_tags`` ((tag, (type, values)), ...) are
    set last, over any tag made here."""
    img = np.asarray(img)
    if img.ndim == 2:
        img = img[..., None]
    h, w, spp = img.shape
    bits = img.dtype.itemsize * 8
    e = ">" if big_endian else "<"
    if photometric is None:
        photometric = 3 if colormap is not None else (2 if spp >= 3 else 1)
    data = img.astype(img.dtype.newbyteorder(e))

    def compress(raw):
        if compression == 1:
            return raw
        if compression == 5:
            return lzw_encode(raw)
        if compression in (8, 32946):
            return zlib.compress(raw)
        if compression == 32773:
            return packbits_encode(raw)
        raise ValueError(compression)

    def chunk_bytes(block):  # [rows, cols, samples], file byte order
        if predictor == 2:
            native = block.astype(img.dtype)
            block = _predict(native).astype(data.dtype)
        return compress(np.ascontiguousarray(block).tobytes())

    planes = ([data] if planar == 1
              else [data[..., s:s + 1] for s in range(spp)])
    chunks = []
    if tile:
        th, tw = tile
        for p in planes:
            for y in range(0, h, th):
                for x in range(0, w, tw):
                    blk = np.zeros((th, tw, p.shape[2]), data.dtype)
                    part = p[y:y + th, x:x + tw]
                    blk[:part.shape[0], :part.shape[1]] = part
                    chunks.append(chunk_bytes(blk))
    else:
        rps = rows_per_strip or h
        for p in planes:
            for y in range(0, h, rps):
                chunks.append(chunk_bytes(p[y:y + rps]))
    tags = {256: (3 if w < 65536 else 4, [w]), 257: (3, [h]),
            258: (3, [bits] * spp), 259: (3, [compression]),
            262: (3, [photometric]), 277: (3, [spp]), 284: (3, [planar])}
    if predictor != 1:
        tags[317] = (3, [predictor])
    if tile:
        tags[322] = (3, [tile[1]])
        tags[323] = (3, [tile[0]])
    else:
        tags[278] = (3, [rows_per_strip or h])
    if extra_samples is not None:
        tags[338] = (3, list(extra_samples))
    if orientation is not None:
        tags[274] = (3, [orientation])
    if colormap is not None:
        tags[320] = (3, list(np.asarray(colormap, np.uint16).T.reshape(-1)))
    for t, v in extra_tags:
        tags[t] = v
    off_tag, cnt_tag = (324, 325) if tile else (273, 279)
    body = bytearray(b"MM\x00*" if big_endian else b"II*\x00")
    body += b"\0\0\0\0"
    offsets = []
    for c in chunks:
        offsets.append(len(body))
        body += c
        if len(body) % 2:
            body += b"\0"
    tags[off_tag] = (4, offsets)
    tags[cnt_tag] = (4, [len(c) for c in chunks])
    ifd_at = len(body)
    struct.pack_into(e + "I", body, 4, ifd_at)
    n = len(tags)
    extra_at = ifd_at + 2 + 12 * n + 4
    ifd = bytearray(struct.pack(e + "H", n))
    extra = bytearray()
    for t in sorted(tags):
        typ, vals = tags[t]
        fmt = {3: "H", 4: "I"}[typ]
        payload = b"".join(struct.pack(e + fmt, v) for v in vals)
        if len(payload) <= 4:
            ifd += struct.pack(e + "HHI", t, typ, len(vals))
            ifd += payload.ljust(4, b"\0")
        else:
            ifd += struct.pack(e + "HHII", t, typ, len(vals),
                               extra_at + len(extra))
            extra += payload
            if len(extra) % 2:
                extra += b"\0"
    ifd += b"\0\0\0\0"
    return bytes(body + ifd + extra)


def write_jpeg_fixtures() -> None:
    import cv2
    import tensorflow as tf

    from jama16_retina_tpu_torch.preprocess import fundus

    os.makedirs(OUT, exist_ok=True)
    manifest = {}
    for name, (data, photo) in sorted(files().items()):
        with open(os.path.join(OUT, name), "wb") as f:
            f.write(data)
        rgb = np.ascontiguousarray(cv2.imdecode(
            np.frombuffer(data, np.uint8), cv2.IMREAD_COLOR)[..., ::-1])
        entry = {"sha256": sha(data), "cv2_rgb": sha(rgb),
                 "cv2_shape": list(rgb.shape)}
        if name.endswith(".jpg"):
            tfr = tf.io.decode_jpeg(data, channels=3,
                                    dct_method="INTEGER_ACCURATE").numpy()
            entry.update(tf_rgb=sha(tfr), tf_shape=list(tfr.shape))
        if photo:
            canvas = fundus.resize_and_center_fundus(rgb, diameter=299)
            entry["canvas299"] = sha(canvas)
        manifest[name] = entry
    with open(os.path.join(OUT, "manifest.json"), "w") as f:
        json.dump(manifest, f, indent=1, sort_keys=True)
        f.write("\n")
    total = sum(os.path.getsize(os.path.join(OUT, n)) for n in manifest)
    print(f"{len(manifest)} files, {total} bytes in {OUT}")



def photo(seed: int, grade: int, size: int, width: int) -> np.ndarray:
    """A ``size``-px render centred on a black frame ``width`` wide, as a
    fundus camera frames the disc."""
    out = np.zeros((size, width, 3), np.uint8)
    x = (width - size) // 2
    out[:, x:x + size] = render(seed, grade, size)
    return out


def cv2_tiff(img: np.ndarray, *params) -> bytes:
    import cv2

    arr = img[..., ::-1] if img.ndim == 3 and img.shape[2] == 3 else img
    ok, buf = cv2.imencode(".tif", arr, list(params))
    assert ok
    return buf.tobytes()


def pil_tiff(img, **kw) -> bytes:
    import io

    from PIL import Image

    buf = io.BytesIO()
    (img if isinstance(img, Image.Image) else Image.fromarray(img)).save(
        buf, format="TIFF", **kw)
    return buf.getvalue()


def tiff_variants() -> "dict[str, tuple[bytes, str | None]]":
    """name -> (bytes, None for a variant the port decodes, else the
    feature it refuses)."""
    import cv2
    from PIL import Image

    c = cv2.IMWRITE_TIFF_COMPRESSION
    rgb = photo(800, 2, 48, 64)
    rgb[:, :8] = np.arange(48, dtype=np.uint8)[:, None, None] * 5
    alpha = (np.arange(64, dtype=np.uint8)[None, :, None] * 4 + 3).repeat(
        48, 0)
    grey16 = rgb[..., 1].astype(np.uint16) * 257 + np.uint16(77)
    rgb16 = rgb.astype(np.uint16) * 257 + np.uint16(129)
    out = {
        "t_cv2_lzw.tif": (cv2_tiff(rgb), None),
        "t_cv2_none.tif": (cv2_tiff(rgb, c, 1), None),
        "t_cv2_deflate_pred.tif": (cv2_tiff(
            rgb, c, 8, cv2.IMWRITE_TIFF_PREDICTOR, 2), None),
        "t_cv2_packbits.tif": (cv2_tiff(rgb, c, 32773), None),
        "t_pil_adobe_deflate.tif": (pil_tiff(
            rgb, compression="tiff_adobe_deflate"), None),
        "t_pil_grey_lzw.tif": (pil_tiff(rgb[..., 1],
                                        compression="tiff_lzw"), None),
        "t_pil_palette.tif": (pil_tiff(Image.fromarray(rgb).quantize(64)),
                              None),
        "t_pil_rgba.tif": (pil_tiff(np.concatenate([rgb, alpha], 2),
                                    compression="tiff_deflate"), None),
        "t_pil_grey16.tif": (pil_tiff(Image.fromarray(grey16, "I;16")),
                             None),
        "t_be_lzw_pred.tif": (tiff_bytes(rgb, compression=5, predictor=2,
                                         big_endian=True,
                                         rows_per_strip=7), None),
        "t_tiles_deflate_pred.tif": (tiff_bytes(
            rgb, compression=8, predictor=2, tile=(16, 16)), None),
        "t_planar_lzw.tif": (tiff_bytes(rgb, compression=5, planar=2,
                                        rows_per_strip=16), None),
        "t_rgb16_be_deflate_pred.tif": (tiff_bytes(
            rgb16, compression=32946, predictor=2, big_endian=True), None),
        "t_white_packbits.tif": (tiff_bytes(
            255 - rgb[..., 1], compression=32773, photometric=0), None),
        "t_unassoc_alpha.tif": (tiff_bytes(
            np.concatenate([rgb, alpha], 2), compression=5,
            extra_samples=(2,)), None),
        "t_orient3.tif": (tiff_bytes(rgb, orientation=3,
                                     rows_per_strip=10), None),
        "t_orient6.tif": (tiff_bytes(rgb, compression=8, orientation=6),
                          None),
        "t_orient2_tiles.tif": (tiff_bytes(rgb, compression=5, tile=(16, 16),
                                           orientation=2), None),
        "r_jpeg.tif": (pil_tiff(rgb, compression="jpeg"), "JPEG compression"),
        "r_ccitt.tif": (pil_tiff(Image.fromarray(rgb).convert("1"),
                                 compression="group4"), "CCITT compression"),
        "r_ycbcr.tif": (tiff_bytes(rgb, photometric=6, extra_tags=(
            (530, (3, [2, 2])),)), "YCbCr colour"),
        "r_cmyk.tif": (pil_tiff(Image.fromarray(rgb).convert("CMYK")),
                       "CMYK (separated) colour"),
        "r_float.tif": (pil_tiff(Image.fromarray(
            rgb[..., 1].astype(np.float32), "F")),
            "samples other than unsigned integers"),
        "r_bilevel.tif": (pil_tiff(Image.fromarray(rgb).convert("1")),
                          "1-bit samples"),
    }
    return out


def large_photos() -> "dict[str, bytes]":
    """JPEG photos whose disc is downscaled at 299 px, framed 4:3, a
    Messidor-size (1440 x 960) TIFF, LZW with the horizontal predictor,
    a blank photo and a file that is no image."""
    import cv2

    q = cv2.IMWRITE_JPEG_QUALITY
    out = {f"eyepacs_{k}.jpg": encode(photo(900 + k, k, size, size * 4 // 3),
                                      q, 92)
           for k, size in enumerate((400, 440, 480, 520))}
    # A 480-px render at twice its size: smoother, as a photograph is,
    # so it compresses to about 1.3 MB.
    messidor = np.zeros((960, 1440, 3), np.uint8)
    messidor[:, 240:1200] = render(950, 3, 480).repeat(2, 0).repeat(2, 1)
    out["messidor_0.tif"] = cv2_tiff(
        messidor, cv2.IMWRITE_TIFF_COMPRESSION, 5,
        cv2.IMWRITE_TIFF_PREDICTOR, 2)
    out["blank.jpg"] = encode(np.zeros((200, 200, 3), np.uint8), q, 92)
    out["junk.jpeg"] = b"not an image\n"
    return out


# Photos of the JPEG fixtures (tests/data/jpeg) whose disc is downscaled
# at 299 px, and the runners' photo sets.
EYEPACS_PHOTOS = ("preprocess/eyepacs_0.jpg", "preprocess/eyepacs_1.jpg",
                  "preprocess/eyepacs_2.jpg", "preprocess/eyepacs_3.jpg",
                  "jpeg/fundus1024.jpg")
CPU_PHOTOS = (*(f"jpeg/fundus299_{i}.jpg" for i in range(8)),
              *(f"jpeg/fundus317_{i}.jpg" for i in range(4)),
              "jpeg/png_rgb.png", "jpeg/exif6.jpg",
              "preprocess/messidor_0.tif")
ODD = ((None, "missing"), ("preprocess/blank.jpg", "blank"),
       ("preprocess/junk.jpeg", "junk"))


def eyepacs_spec(photos, n: int, ext: str = ".jpeg") -> dict:
    """``n`` EyePACS-style names (``<id>_left``/``_right``) over the photos
    in turn, grades cycling 0-4, then one missing, one blank and one
    unreadable photo; the labels CSV as EyePACS writes it."""
    entries = []
    for i in range(n):
        name = f"{10 + i // 2}_{'left' if i % 2 == 0 else 'right'}"
        entries.append([name + ext, photos[i % len(photos)], i % 5])
    for k, (src, tag) in enumerate(ODD):
        entries.append([f"{tag}_{k}{ext}", src, (k + 2) % 5])
    csv_text = "image,level\n" + "".join(
        f"{os.path.splitext(e[0])[0]},{e[2]}\n" for e in entries)
    return {"cli": "preprocess_eyepacs", "labels_csv": "trainLabels.csv",
            "csv": csv_text, "entries": entries}


def messidor_spec(photos, n: int) -> dict:
    """``n`` Messidor-2-style names over the photos, grades cycling 0-4,
    in a ``;``-separated CSV that names the files with their extension."""
    entries = [[f"2005{1020 + i:04d}_{43808 + 24 * i}_0100_PP"
                f"{os.path.splitext(photos[i % len(photos)])[1]}",
                photos[i % len(photos)], i % 5] for i in range(n)]
    csv_text = "Image name;Retinopathy grade;Risk of macular edema\n" + \
        "".join(f"{e[0]};{e[2]};0\n" for e in entries)
    return {"cli": "preprocess_messidor", "labels_csv": "grades.csv",
            "csv": csv_text, "entries": entries}


def build_runner_dir(spec: dict, data_root: str, out_dir: str) -> str:
    """The spec's photo directory under ``out_dir/images`` and its labels
    CSV; returns the CSV's path."""
    images = os.path.join(out_dir, "images")
    os.makedirs(images, exist_ok=True)
    for name, src, _ in spec["entries"]:
        if src is not None:
            shutil.copyfile(os.path.join(data_root, src),
                            os.path.join(images, name))
    labels = os.path.join(out_dir, spec["labels_csv"])
    with open(labels, "w") as f:
        f.write(spec["csv"])
    return labels


def file_digests(d: str) -> "dict[str, str]":
    out = {}
    for n in sorted(os.listdir(d)):
        with open(os.path.join(d, n), "rb") as f:
            out[n] = sha(f.read())
    return out


def reference_run(spec: dict, argv: "list[str]", work: str) -> dict:
    """The reference CLI on the spec's directory: its files' sha256 and
    what it printed (the JSON report)."""
    labels = build_runner_dir(spec, os.path.join(HERE, "data"), work)
    out = os.path.join(work, "out")
    shutil.rmtree(out, ignore_errors=True)
    cmd = [sys.executable, os.path.join(REPO, spec["cli"] + ".py"),
           f"--data_dir={os.path.join(work, 'images')}",
           f"--labels_csv={labels}", f"--output_dir={out}", *argv]
    done = subprocess.run(cmd, capture_output=True, text=True, check=True,
                          env={**os.environ, "CUDA_VISIBLE_DEVICES": "-1"})
    return {"argv": argv, "files": file_digests(out), "stdout": done.stdout}


RUNS = {
    # spec name -> {run name: flags}
    "eyepacs": {"jpeg_workers2": ["--workers=2"],
                "raw_workers0": ["--encoding=raw", "--workers=0"]},
    "messidor": {"jpeg_workers2": ["--workers=2"],
                 "raw_workers0": ["--encoding=raw", "--workers=0"]},
    "eyepacs_cpu": {"jpeg": ["--image_size=64", "--num_shards=3"],
                    "jpeg_min_quality": ["--image_size=64", "--num_shards=3",
                                         "--min_quality=0.55"],
                    "raw_min_quality": ["--image_size=64", "--num_shards=3",
                                        "--min_quality=0.55",
                                        "--encoding=raw"]},
    "messidor_cpu": {"jpeg": ["--image_size=64", "--num_shards=2"]},
}


def write_preprocess_fixtures() -> None:
    import cv2

    from jama16_retina_tpu_torch.preprocess import fundus

    os.makedirs(PRE_OUT, exist_ok=True)
    data_root = os.path.join(HERE, "data")
    manifest = {"files": {}, "encode": {}, "runners": {}}
    made = {**{n: (b, why) for n, (b, why) in tiff_variants().items()},
            **{n: (b, None) for n, b in large_photos().items()}}
    for name, (data, refused) in sorted(made.items()):
        with open(os.path.join(PRE_OUT, name), "wb") as f:
            f.write(data)
        entry = {"sha256": sha(data)}
        if refused is not None:
            entry["refused"] = refused
        elif name != "junk.jpeg":
            rgb = np.ascontiguousarray(cv2.imdecode(
                np.frombuffer(data, np.uint8), cv2.IMREAD_COLOR)[..., ::-1])
            entry.update(cv2_rgb=sha(rgb), cv2_shape=list(rgb.shape))
            if name.startswith(("eyepacs_", "messidor_", "t_")):
                entry["canvas299"] = sha(fundus.resize_and_center_fundus(
                    rgb, diameter=299))
        manifest["files"][name] = entry
    # cv2.imencode at quality 92 of each photo's decode and canvas.
    q = cv2.IMWRITE_JPEG_QUALITY
    for src in sorted(set(EYEPACS_PHOTOS + CPU_PHOTOS[:12])):
        data = open(os.path.join(data_root, src), "rb").read()
        rgb = np.ascontiguousarray(cv2.imdecode(
            np.frombuffer(data, np.uint8), cv2.IMREAD_COLOR)[..., ::-1])
        canvas = fundus.resize_and_center_fundus(rgb, diameter=299)
        manifest["encode"][src] = sha(encode(rgb, q, 92))
        manifest["encode"][src + ":canvas299"] = sha(encode(canvas, q, 92))
    # Every photo of a runner spec is downscaled at its size: an upscale
    # is OpenCV's INTER_CUBIC, which the port matches within 1 level only.
    for photos, size in ((EYEPACS_PHOTOS, 299), (CPU_PHOTOS, 64),
                         (("preprocess/messidor_0.tif",), 299)):
        for src in photos:
            data = open(os.path.join(data_root, src), "rb").read()
            rgb = cv2.imdecode(np.frombuffer(data, np.uint8),
                               cv2.IMREAD_COLOR)[..., ::-1]
            circle = fundus.find_fundus_circle(rgb)
            assert size * 0.98 < 2 * circle.radius, (src, size)
    specs = {"eyepacs": eyepacs_spec(EYEPACS_PHOTOS, 96),
             "messidor": messidor_spec(("preprocess/messidor_0.tif",), 8),
             "eyepacs_cpu": eyepacs_spec(CPU_PHOTOS, 18),
             "messidor_cpu": messidor_spec(
                 ("preprocess/messidor_0.tif", "jpeg/fundus1024.jpg",
                  "jpeg/fundus317_1.jpg"), 5)}
    for spec_name, spec in specs.items():
        runs = {}
        for run, argv in RUNS[spec_name].items():
            with tempfile.TemporaryDirectory() as work:
                runs[run] = reference_run(spec, argv, work)
            print(f"{spec_name} {run}: {runs[run]['stdout']}")
        manifest["runners"][spec_name] = {**spec, "runs": runs}
    with open(os.path.join(PRE_OUT, "manifest.json"), "w") as f:
        json.dump(manifest, f, indent=1, sort_keys=True)
        f.write("\n")
    total = sum(len(b) for b, _ in made.values())
    print(f"{len(made)} files, {total} bytes in {PRE_OUT}")


HBM_LOAD = os.path.join(OUT, "hbm_load.json")
HBM_SIZE = 299


def write_hbm_fixtures() -> None:
    from pathlib import Path

    import chip_smoke
    from jama16_retina_tpu.data import hbm_pipeline

    out = {}
    with tempfile.TemporaryDirectory() as tmp:
        jdir, _ = chip_smoke.write_jpeg_splits(Path(tmp))
        for split, n, _ in chip_smoke.JPEG_SPLITS:
            images, grades = hbm_pipeline.load_split_numpy(
                str(jdir), split, HBM_SIZE)
            assert images.shape == (n, HBM_SIZE, HBM_SIZE, 3)
            out[split] = {"images": sha(images), "grades": sha(grades),
                          "n": n, "image_size": HBM_SIZE}
    with open(HBM_LOAD, "w") as f:
        json.dump(out, f, indent=1, sort_keys=True)
        f.write("\n")
    print(f"{len(out)} splits in {HBM_LOAD}")


GRAIN_ORDER = os.path.join(HERE, "data", "grain_order.json")
SHUFFLE_SEEDS = (0, 1, 42, 2**32 - 1)
SHUFFLE_MAX = 300


def write_grain_fixtures() -> None:
    import chip_smoke
    import grain.python as pygrain
    from grain._src.python.experimental.index_shuffle.python import (
        index_shuffle_module)
    from jama16_retina_tpu.configs import DataConfig
    from jama16_retina_tpu.data import grain_pipeline, tfrecord

    shuffle = {}
    for seed in SHUFFLE_SEEDS:
        perms = [index_shuffle_module.index_shuffle(
            i, max_index=m, seed=seed, rounds=4)
            for m in range(SHUFFLE_MAX + 1) for i in range(m + 1)]
        shuffle[str(seed)] = sha(np.asarray(perms, np.int64))
    n, bs = chip_smoke.GRAIN_RECORDS, chip_smoke.GRAIN_BATCH
    order = {}
    for seed in (0, 42):
        sampler = pygrain.IndexSampler(
            n, shard_options=pygrain.ShardOptions(0, 1, drop_remainder=True),
            shuffle=True, num_epochs=None, seed=seed)
        order[str(seed)] = sha(np.asarray(
            [sampler[g].record_key for g in range(2 * n)], np.int64))
    states = {}
    with tempfile.TemporaryDirectory() as tmp:
        # The state bytes do not read pixels: small records do.
        tfrecord.write_synthetic_split(tmp, "train", n, 8, num_shards=4,
                                       seed=1, encoding="raw")
        for workers in chip_smoke.GRAIN_WORKERS:
            it = grain_pipeline.make_train_iterator(
                tmp, "train", DataConfig(batch_size=bs),
                chip_smoke.GRAIN_SIZE, seed=chip_smoke.GRAIN_SEED,
                worker_count=workers)
            got = {}
            for b in range(1, max(chip_smoke.GRAIN_STATE_AT) + 1):
                next(it)
                if b in chip_smoke.GRAIN_STATE_AT:
                    got[str(b)] = sha(it.get_state())
            states[str(workers)] = got
            del it
    with open(GRAIN_ORDER, "w") as f:
        json.dump({"shuffle_0_300": shuffle, "order_2_epochs": order,
                   "states": states, "records": n, "batch": bs,
                   "image_size": chip_smoke.GRAIN_SIZE,
                   "seed": chip_smoke.GRAIN_SEED}, f, indent=1,
                  sort_keys=True)
        f.write("\n")
    print(f"grain order and states in {GRAIN_ORDER}")


def main(argv: "list[str] | None" = None) -> int:
    which = (argv if argv is not None else sys.argv[1:]) or ["jpeg",
                                                             "preprocess",
                                                             "hbm", "grain"]
    if "jpeg" in which:
        write_jpeg_fixtures()
    if "preprocess" in which:
        write_preprocess_fixtures()
    if "hbm" in which:
        write_hbm_fixtures()
    if "grain" in which:
        write_grain_fixtures()
    return 0


if __name__ == "__main__":
    sys.exit(main())
