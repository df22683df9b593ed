"""Writes the image fixtures of the port's codec tests into
``tests/data/jpeg/`` with their ``manifest.json``.

    python tests/make_torch_fixtures.py

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
"""

from __future__ import annotations

import hashlib
import json
import os
import struct
import sys

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))
OUT = os.path.join(HERE, "data", "jpeg")
sys.path.insert(0, os.path.dirname(HERE))

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


def main() -> int:
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
        if photo and name != "progressive.jpg":
            canvas = fundus.resize_and_center_fundus(rgb, diameter=299)
            entry["canvas299"] = sha(canvas)
        manifest[name] = entry
    with open(os.path.join(OUT, "manifest.json"), "w") as f:
        json.dump(manifest, f, indent=1, sort_keys=True)
        f.write("\n")
    total = sum(os.path.getsize(os.path.join(OUT, n)) for n in manifest)
    print(f"{len(manifest)} files, {total} bytes in {OUT}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
