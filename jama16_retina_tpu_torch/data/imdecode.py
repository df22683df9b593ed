"""``imdecode``: the counterpart of ``cv2.imdecode(buf, IMREAD_COLOR)``
for the serving host stage, returning RGB (OpenCV returns BGR) or None
for bytes it cannot read.

The format is sniffed from the magic bytes: JPEG (EXIF orientation
applied, as OpenCV does) and PNG are decoded. A format that is
recognized but not decoded yet (TIFF, BMP, GIF, WebP, a progressive
JPEG, an interlaced PNG) also gives None, and ``read_image`` names it
and ``jpeg.FORMATS_ITEM``; there is no fallback to another decoder.
"""

from __future__ import annotations

import numpy as np

from jama16_retina_tpu_torch.data import jpeg, png

# Magic bytes of formats OpenCV reads that the port does not decode yet.
_OTHER = ((b"II*\x00", "TIFF"), (b"MM\x00*", "TIFF"), (b"BM", "BMP"),
          (b"GIF87a", "GIF"), (b"GIF89a", "GIF"))


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
    except (jpeg.JpegError, png.PngError) as e:
        unsupported = getattr(e, "unsupported", False)
        return None, (str(e) if unsupported else None)
    if buf.startswith(b"RIFF") and buf[8:12] == b"WEBP":
        return None, f"WebP is not decoded by the port yet; see " \
                     f"{jpeg.FORMATS_ITEM}"
    for magic, name in _OTHER:
        if buf.startswith(magic):
            return None, f"{name} is not decoded by the port yet; see " \
                         f"{jpeg.FORMATS_ITEM}"
    return None, None


def imdecode(data) -> "np.ndarray | None":
    """Image bytes -> RGB uint8 [H, W, 3], or None if unreadable."""
    return read_image(data)[0]
