"""PNG decoding without OpenCV or PIL, to what ``cv2.imdecode(buf,
IMREAD_COLOR)[..., ::-1]`` returns: RGB uint8, alpha dropped, 16-bit
samples cut to their high byte, grey replicated, palette expanded (1, 2
and 4-bit grey scaled to 8 bits as libpng does).

Non-interlaced images of every standard colour type and bit depth are
decoded: chunk CRCs of the critical chunks checked, the image data
inflated by the standard library's ``zlib`` and unfiltered in C
(``ops/csrc/image_codec.c``: Paeth is sequential). An interlaced (Adam7)
image raises ``PngError`` naming ``jpeg.FORMATS_ITEM``; a corrupt one
raises ``PngError``.
"""

from __future__ import annotations

import struct
import zlib

import numpy as np

from jama16_retina_tpu_torch.data import jpeg
from jama16_retina_tpu_torch.ops import image_codec

SIGNATURE = b"\x89PNG\r\n\x1a\n"
# Colour type -> (samples per pixel, allowed bit depths).
_TYPES = {0: (1, (1, 2, 4, 8, 16)), 2: (3, (8, 16)), 3: (1, (1, 2, 4, 8)),
          4: (2, (8, 16)), 6: (4, (8, 16))}
_CRITICAL = (b"IHDR", b"PLTE", b"IDAT", b"IEND")


class PngError(ValueError):
    """A PNG stream that is corrupt or not supported (``unsupported``)."""

    def __init__(self, message: str, unsupported: bool = False):
        super().__init__(message)
        self.unsupported = unsupported


def _chunks(data: bytes):
    pos = len(SIGNATURE)
    while pos + 12 <= len(data):
        (length,) = struct.unpack(">I", data[pos:pos + 4])
        kind = data[pos + 4:pos + 8]
        end = pos + 8 + length
        if end + 4 > len(data):
            raise PngError(f"truncated PNG chunk {kind!r}")
        body = data[pos + 8:end]
        if kind in _CRITICAL:
            (crc,) = struct.unpack(">I", data[end:end + 4])
            if zlib.crc32(kind + body) != crc:
                raise PngError(f"CRC mismatch in PNG chunk {kind!r}")
        yield kind, body
        if kind == b"IEND":
            return
        pos = end + 4
    raise PngError("PNG stream ends before IEND")


def decode_png(data) -> np.ndarray:
    """PNG bytes -> uint8 RGB [H, W, 3]; raises ``PngError``."""
    data = bytes(data)
    if not data.startswith(SIGNATURE):
        raise PngError("not a PNG stream")
    ihdr, palette, idat = None, None, []
    for kind, body in _chunks(data):
        if kind == b"IHDR":
            if len(body) != 13:
                raise PngError("malformed IHDR")
            ihdr = struct.unpack(">IIBBBBB", body)
        elif kind == b"PLTE":
            if len(body) % 3 or not body:
                raise PngError("malformed PLTE")
            palette = np.frombuffer(body, np.uint8).reshape(-1, 3)
        elif kind == b"IDAT":
            idat.append(body)
    if ihdr is None:
        raise PngError("PNG stream without IHDR")
    width, height, depth, ctype, comp, filt, interlace = ihdr
    if ctype not in _TYPES or depth not in _TYPES[ctype][1]:
        raise PngError(f"invalid PNG colour type {ctype} at bit depth {depth}")
    if comp != 0 or filt != 0 or width == 0 or height == 0:
        raise PngError("invalid PNG header")
    if interlace:
        raise PngError("interlaced PNG is not decoded by the port yet; see "
                       f"{jpeg.FORMATS_ITEM}", unsupported=True)
    if ctype == 3 and palette is None:
        raise PngError("palette PNG without PLTE")
    if width * height > 1 << 28:
        raise PngError("PNG image larger than 2^28 pixels")
    samples = _TYPES[ctype][0]
    bits = samples * depth
    rowbytes = (width * bits + 7) // 8
    try:
        raw = zlib.decompress(b"".join(idat))
    except zlib.error as e:
        raise PngError(f"corrupt PNG image data: {e}") from None
    if len(raw) < height * (rowbytes + 1):
        raise PngError("truncated PNG image data")
    src = np.frombuffer(raw, np.uint8)
    rows = np.empty((height, rowbytes), np.uint8)
    rc = image_codec.lib().png_unfilter(
        image_codec.ptr(src), src.size, height, rowbytes, max(1, bits // 8),
        image_codec.ptr(rows))
    if rc:
        raise PngError("corrupt PNG row filter")
    if depth == 16:
        px = rows.reshape(height, width, samples, 2)[..., 0]
    elif depth == 8:
        px = rows.reshape(height, width, samples)
    else:
        px = np.unpackbits(rows, axis=1).reshape(height, -1, depth)
        px = (px * (1 << np.arange(depth - 1, -1, -1, dtype=np.uint8))).sum(
            axis=2, dtype=np.uint8)[:, :width, None]
    if ctype == 3:
        full = np.zeros((256, 3), np.uint8)
        full[:len(palette[:256])] = palette[:256]
        return full[px[..., 0]]
    if ctype in (0, 4):
        grey = px[..., 0]
        if depth < 8:
            grey = grey * np.uint8(255 // ((1 << depth) - 1))
        return np.ascontiguousarray(np.repeat(grey[..., None], 3, axis=2))
    return np.ascontiguousarray(px[..., :3])
