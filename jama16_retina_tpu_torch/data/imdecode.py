"""``imdecode``: the counterpart of ``cv2.imdecode(buf, IMREAD_COLOR)``
for the host stages, returning RGB (OpenCV returns BGR) or None for
bytes it cannot read.

The format is sniffed from the magic bytes, as OpenCV sniffs it: JPEG
(sequential or progressive, EXIF orientation applied, as OpenCV does),
PNG and TIFF are decoded. A
format that is recognized but not decoded yet (BMP, GIF, WebP, JPEG
2000, the PNM family, Sun raster, OpenEXR, Radiance HDR, AVIF, an
arithmetic-coded JPEG, an interlaced PNG, a TIFF variant ``data/tiff.py``
refuses) also gives None, and ``read_image`` names it and
``jpeg.FORMATS_ITEM``; there is no fallback to another decoder.
"""

from __future__ import annotations

import re

import numpy as np

from jama16_retina_tpu_torch.data import jpeg, png, tiff

# Magic bytes of formats OpenCV reads that the port does not decode yet.
_OTHER = ((b"BM", "BMP"), (b"GIF87a", "GIF"), (b"GIF89a", "GIF"),
          (b"\x00\x00\x00\x0cjP  \r\n\x87\n", "JPEG 2000"),
          (b"\xff\x4f\xff\x51", "JPEG 2000"),
          (b"\x59\xa6\x6a\x95", "Sun raster"),
          (b"\x76\x2f\x31\x01", "OpenEXR"),
          (b"#?RADIANCE", "Radiance HDR"), (b"#?RGBE", "Radiance HDR"))
# PBM/PGM/PPM/PAM and PFM headers: "P1".."P7" or "PF"/"Pf", then white space.
_PNM = re.compile(rb"P[1-7Ff][ \t\r\n]")


def _not_yet(name: str) -> str:
    return f"{name} is not decoded by the port yet; see {jpeg.FORMATS_ITEM}"


def read_image(data) -> "tuple[np.ndarray | None, str | None]":
    """(RGB uint8 [H, W, 3], None), or (None, why) where ``why`` is None
    for bytes that are no image the port recognizes and names the format
    and the roadmap item for one it recognizes but does not decode."""
    buf = bytes(data[:16])
    try:
        if buf.startswith(b"\xff\xd8\xff"):
            return jpeg.decode_jpeg(data, exif_orientation=True), None
        if buf.startswith(png.SIGNATURE):
            return png.decode_png(data), None
        if buf.startswith(tiff.MAGICS) or buf[:4] in (b"II+\x00",
                                                      b"MM\x00+"):
            return tiff.decode_tiff(data), None
    except (jpeg.JpegError, png.PngError, tiff.TiffError) as e:
        unsupported = getattr(e, "unsupported", False)
        return None, (str(e) if unsupported else None)
    if buf.startswith(b"RIFF") and buf[8:12] == b"WEBP":
        return None, _not_yet("WebP")
    if buf[4:12] in (b"ftypavif", b"ftypavis"):
        return None, _not_yet("AVIF")
    for magic, name in _OTHER:
        if buf.startswith(magic):
            return None, _not_yet(name)
    if _PNM.match(buf):
        return None, _not_yet("PNM")
    return None, None


def imdecode(data) -> "np.ndarray | None":
    """Image bytes -> RGB uint8 [H, W, 3], or None if unreadable."""
    return read_image(data)[0]
