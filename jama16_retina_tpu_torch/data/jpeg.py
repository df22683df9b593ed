"""JPEG decoding and baseline encoding without OpenCV, PIL or TensorFlow.

``decode_jpeg`` returns what ``cv2.imdecode(buf, IMREAD_COLOR)[..., ::-1]``
and ``tf.io.decode_jpeg(buf, channels=3, dct_method="INTEGER_ACCURATE")``
return for the same bytes, bit for bit: libjpeg's accurate integer IDCT,
its default ("fancy") chroma upsampling and its YCbCr -> RGB tables, in C
(``ops/csrc/image_codec.c``, built by the host compiler at first use).
The two references differ in one thing, the EXIF Orientation tag: OpenCV
applies it and TensorFlow ignores it, so the caller chooses
(``exif_orientation``): the host stage applies it, the records path does
not.

Sequential and progressive Huffman frames of 8-bit precision with one or
three (YCbCr) components are decoded; an arithmetic-coded, lossless or
12-bit frame, an RGB or CMYK one, or a progressive one whose last scan
leaves its low coefficients short of full precision (libjpeg smooths
those blocks), raises ``JpegError`` naming ``FORMATS_ITEM``, and so does
a truncated or corrupt stream (where libjpeg would warn and fill the rest
with grey).

``encode_jpeg`` returns the bytes of ``cv2.imencode(".jpg", rgb[..., ::-1],
[cv2.IMWRITE_JPEG_QUALITY, quality])``: what the reference's
``tfrecord.encode_jpeg`` writes into its records.
"""

from __future__ import annotations

import ctypes
import struct

import numpy as np

from jama16_retina_tpu_torch.ops import image_codec

FORMATS_ITEM = ("ROADMAP.md Queue A item 14 (image formats the port does "
                "not decode yet)")

_ERRORS = {
    -1: "corrupt JPEG data",
    -2: "truncated JPEG data",
    -4: f"arithmetic-coded JPEG is not decoded by the port yet; see "
        f"{FORMATS_ITEM}",
    -5: f"JPEG of a precision other than 8 bits is not decoded by the port "
        f"yet; see {FORMATS_ITEM}",
    -6: f"JPEG with other than 1 or 3 components (CMYK, YCCK) is not "
        f"decoded by the port yet; see {FORMATS_ITEM}",
    -7: "JPEG with non-integral sampling factors is not supported",
    -8: "out of memory decoding JPEG",
    -9: f"lossless, hierarchical or DNL-sized JPEG is not decoded by the "
        f"port yet; see {FORMATS_ITEM}",
    -10: "JPEG frame larger than 2^28 pixels",
    -11: "bad arguments to the JPEG decoder",
    -12: f"JPEG in RGB (no YCbCr transform) is not decoded by the port yet; "
         f"see {FORMATS_ITEM}",
    -13: f"progressive JPEG whose scans leave coefficients 1-9 short of full "
         f"precision (libjpeg's block smoothing) is not decoded by the port "
         f"yet; see {FORMATS_ITEM}",
}
# Codes of a stream the port recognizes but does not decode.
UNSUPPORTED = (-4, -5, -6, -9, -12, -13)


class JpegError(ValueError):
    """A JPEG stream that is corrupt, truncated or not supported;
    ``code`` is the decoder's error code."""

    def __init__(self, message: str, code: int = -1):
        super().__init__(message)
        self.code = code

    @property
    def unsupported(self) -> bool:
        return self.code in UNSUPPORTED


def _raise(code: int) -> None:
    raise JpegError(_ERRORS.get(code, f"JPEG decoder error {code}"), code)


def exif_orientation_of(data) -> int:
    """The EXIF Orientation (1-8) as OpenCV reads it, or 1: the first APP1
    segment before the first SOS, six bytes in (the ``Exif\\0\\0``
    header, not checked, as OpenCV does not), a TIFF header in either
    byte order, and tag 0x0112 of IFD0."""
    buf = memoryview(data).cast("B")
    n, pos = len(buf), 2
    while pos + 4 <= n:
        if buf[pos] != 0xFF:
            return 1
        marker = buf[pos + 1]
        if marker == 0xFF:
            pos += 1
            continue
        if marker in (0xD8, 0x01) or 0xD0 <= marker <= 0xD7:
            pos += 2
            continue
        if marker in (0xDA, 0xD9):
            return 1
        (length,) = struct.unpack(">H", buf[pos + 2:pos + 4])
        if marker == 0xE1:
            return _tiff_orientation(bytes(buf[pos + 4 + 6:pos + 2 + length]))
        pos += 2 + length
    return 1


def _tiff_orientation(tiff: bytes) -> int:
    if len(tiff) < 8 or tiff[:2] not in (b"II", b"MM"):
        return 1
    e = "<" if tiff[:2] == b"II" else ">"
    if struct.unpack(e + "H", tiff[2:4])[0] != 42:
        return 1
    (ifd,) = struct.unpack(e + "I", tiff[4:8])
    if ifd + 2 > len(tiff):
        return 1
    (count,) = struct.unpack(e + "H", tiff[ifd:ifd + 2])
    for k in range(count):
        at = ifd + 2 + 12 * k
        if at + 12 > len(tiff):
            return 1
        tag, _, _ = struct.unpack(e + "HHI", tiff[at:at + 8])
        if tag == 0x0112:
            (value,) = struct.unpack(e + "H", tiff[at + 8:at + 10])
            return value if 1 <= value <= 8 else 1
    return 1


def apply_orientation(image: np.ndarray, orientation: int) -> np.ndarray:
    """OpenCV's ``ExifTransform``: flips for 2-4, a transpose and a flip
    for 5-8."""
    if orientation >= 5:
        image = image.transpose(1, 0, 2)
    if orientation in (2, 6):
        image = image[:, ::-1]
    elif orientation in (3, 7):
        image = image[::-1, ::-1]
    elif orientation in (4, 8):
        image = image[::-1]
    return np.ascontiguousarray(image)


def header(data) -> "tuple[int, int]":
    """(height, width) of the stream's frame; raises ``JpegError``."""
    src = np.frombuffer(data, np.uint8)
    w, h = ctypes.c_int(), ctypes.c_int()
    rc = image_codec.lib().jpeg_header(image_codec.ptr(src), src.size,
                                       ctypes.byref(w), ctypes.byref(h))
    if rc:
        _raise(rc)
    return h.value, w.value


def decode_jpeg(data, *, exif_orientation: bool) -> np.ndarray:
    """JPEG bytes -> uint8 RGB [H, W, 3]; raises ``JpegError``."""
    src = np.frombuffer(data, np.uint8)
    h, w = header(src)
    out = np.empty((h, w, 3), np.uint8)
    rc = image_codec.lib().jpeg_decode(image_codec.ptr(src), src.size,
                                       image_codec.ptr(out), w, h)
    if rc:
        _raise(rc)
    if exif_orientation:
        orientation = exif_orientation_of(src)
        if orientation != 1:
            out = apply_orientation(out, orientation)
    return out


def encode_jpeg(image_rgb_u8: np.ndarray, quality: int = 92) -> bytes:
    """RGB uint8 [H, W, 3] -> the bytes of ``cv2.imencode(".jpg", rgb[...,
    ::-1], [cv2.IMWRITE_JPEG_QUALITY, quality])``: a baseline JFIF stream
    at 4:2:0 with the standard tables, libjpeg's arithmetic term for term
    (``ops/csrc/image_codec.c``)."""
    image = np.ascontiguousarray(image_rgb_u8)
    if image.ndim != 3 or image.shape[2] != 3 or image.dtype != np.uint8:
        raise ValueError(f"expected uint8 HW3, got {image.dtype} "
                         f"{image.shape}")
    h, w, _ = image.shape
    lib = image_codec.lib()
    out = np.empty(lib.jpeg_encode_bound(w, h), np.uint8)
    n = ctypes.c_size_t()
    rc = lib.jpeg_encode(image_codec.ptr(image), w, h, int(quality),
                         image_codec.ptr(out), out.size, ctypes.byref(n))
    if rc:
        _raise(rc)
    return out[:n.value].tobytes()
