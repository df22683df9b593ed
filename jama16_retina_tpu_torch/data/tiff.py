"""TIFF decoding without OpenCV, PIL or libtiff, to what
``cv2.imdecode(buf, IMREAD_COLOR)[..., ::-1]`` returns: OpenCV reads an
8-bit colour image through libtiff's RGBA interface
(``TIFFReadRGBAStrip``/``TIFFReadRGBATile``), and this module follows it.

Decoded: the first page (IFD) only, in either byte order, in strips or
tiles, chunky or planar; compression none, LZW, Deflate (8 and 32946)
and PackBits; Predictor 1 or 2; 8- or 16-bit unsigned samples of

- RGB, with or without an alpha sample (dropped; an unassociated alpha
  premultiplies the colour first, ``(v * a + 127) // 255``, as libtiff
  does);
- min-is-black or min-is-white grey (one sample);
- an 8-bit palette (a colour map with no entry above 255 is taken as
  8-bit, as libtiff takes it, else its high bytes).

16-bit samples are cut to 8 bits as libtiff's RGBA interface cuts them:
colour ``(v + 128) // 257``, grey its high byte. The Orientation tag acts
as it acts there: libtiff flips each strip or tile it reads (so a
horizontal flip of a tiled image mirrors each tile in its place), OpenCV
flips the image vertically for orientations 3, 4, 7 and 8 and then
transposes it for 5-8 (and turns it by 180 degrees for 6 and 8).

The unpacking (LZW, PackBits, the predictor) is C
(``ops/csrc/image_codec.c``); Deflate is the standard library's ``zlib``.
JPEG-in-TIFF, CCITT, YCbCr, CMYK (separated), old-style LZW, other
sample formats and bit depths, BigTIFF and a reversed fill order raise
``TiffError`` naming ``jpeg.FORMATS_ITEM`` (``unsupported``); a truncated
or corrupt stream raises ``TiffError``, where libtiff would fill the
damaged strip with what it decoded and zeros (ROADMAP Queue C).
"""

from __future__ import annotations

import struct
import zlib

import numpy as np

from jama16_retina_tpu_torch.data import jpeg
from jama16_retina_tpu_torch.ops import image_codec

MAGICS = (b"II*\x00", b"MM\x00*")
_MAX_PIXELS = 1 << 28
# Field type -> (struct code, bytes) of the integer types read here.
_TYPES = {1: ("B", 1), 3: ("H", 2), 4: ("I", 4), 6: ("b", 1), 8: ("h", 2),
          9: ("i", 4)}
_COMPRESSIONS = {1: "none", 5: "LZW", 8: "Deflate", 32946: "Deflate",
                 32773: "PackBits"}
# The most bytes one packed byte can unpack to (Deflate's limit is 1032;
# a 12-bit LZW code stands for at most 4094 bytes; a PackBits run is two
# bytes for 128): a chunk that claims more is refused before anything is
# allocated for it.
_EXPANSION = {1: 1, 5: 4096, 8: 1032, 32946: 1032, 32773: 64}
_UNSUPPORTED_COMPRESSION = {2: "CCITT", 3: "CCITT", 4: "CCITT", 6: "JPEG",
                            7: "JPEG"}
_UNSUPPORTED_PHOTOMETRIC = {4: "transparency mask", 5: "CMYK (separated)",
                            6: "YCbCr", 8: "CIELab", 9: "ICCLab",
                            10: "ITULab", 32844: "LogL", 32845: "LogLuv"}


class TiffError(ValueError):
    """A TIFF stream that is corrupt or not supported (``unsupported``)."""

    def __init__(self, message: str, unsupported: bool = False):
        super().__init__(message)
        self.unsupported = unsupported


def _unsupported(what: str) -> TiffError:
    return TiffError(f"TIFF with {what} is not decoded by the port yet; see "
                     f"{jpeg.FORMATS_ITEM}", unsupported=True)


def _tags(data: bytes) -> "tuple[str, dict[int, list[int]]]":
    """The byte order and the first IFD's integer tags (other types are
    kept as empty lists: present, not read)."""
    if len(data) < 8 or data[:4] not in MAGICS:
        if data[:2] in (b"II", b"MM") and len(data) >= 4:
            e = "<" if data[:2] == b"II" else ">"
            if struct.unpack(e + "H", data[2:4])[0] == 43:
                raise _unsupported("64-bit offsets (BigTIFF)")
        raise TiffError("not a TIFF stream")
    e = "<" if data[:2] == b"II" else ">"
    (ifd,) = struct.unpack(e + "I", data[4:8])
    if ifd + 2 > len(data):
        raise TiffError("TIFF directory offset past the end of the data")
    (count,) = struct.unpack(e + "H", data[ifd:ifd + 2])
    if ifd + 2 + 12 * count > len(data):
        raise TiffError("truncated TIFF directory")
    tags: "dict[int, list[int]]" = {}
    for k in range(count):
        at = ifd + 2 + 12 * k
        tag, typ, n = struct.unpack(e + "HHI", data[at:at + 8])
        if typ not in _TYPES:
            tags.setdefault(tag, [])
            continue
        code, size = _TYPES[typ]
        nbytes = size * n
        if nbytes <= 4:
            where = at + 8
        else:
            (where,) = struct.unpack(e + "I", data[at + 8:at + 12])
        if where + nbytes > len(data):
            raise TiffError(f"TIFF tag {tag} points past the end of the data")
        tags[tag] = np.frombuffer(data, np.dtype(e + code), n,
                                  where).astype(np.int64).tolist()
    return e, tags


def _one(tags: dict, tag: int, default=None) -> int:
    v = tags.get(tag)
    if not v:
        if default is None:
            raise TiffError(f"TIFF lacks required tag {tag}")
        return default
    return int(v[0])


def _unpack(chunk: bytes, compression: int, need: int) -> np.ndarray:
    """One strip or tile's bytes -> exactly ``need`` decoded bytes."""
    out = np.empty(need, np.uint8)
    if compression in (8, 32946):
        d = zlib.decompressobj()
        try:
            raw = d.decompress(chunk, need)
        except zlib.error as err:
            raise TiffError(f"corrupt Deflate data in TIFF: {err}") from None
        if len(raw) < need:
            raise TiffError("truncated Deflate data in TIFF")
        out[:] = np.frombuffer(raw, np.uint8)
        return out
    if compression == 5 and len(chunk) >= 2 and chunk[0] == 0 and \
            chunk[1] & 1:
        raise _unsupported("old-style LZW compression")
    src = np.frombuffer(chunk, np.uint8)
    fn = (image_codec.lib().tiff_lzw_decode if compression == 5
          else image_codec.lib().tiff_packbits_decode)
    rc = fn(image_codec.ptr(src) if src.size else None, src.size,
            image_codec.ptr(out), need)
    if rc:
        raise TiffError(f"corrupt or truncated {_COMPRESSIONS[compression]} "
                        "data in TIFF")
    return out


def decode_tiff(data) -> np.ndarray:
    """TIFF bytes -> uint8 RGB [H, W, 3]; raises ``TiffError``."""
    data = bytes(data)
    e, tags = _tags(data)
    width, height = _one(tags, 256), _one(tags, 257)
    if width <= 0 or height <= 0:
        raise TiffError("TIFF with an empty image")
    if width * height > _MAX_PIXELS:
        raise TiffError("TIFF image larger than 2^28 pixels")
    compression = _one(tags, 259, 1)
    if compression in _UNSUPPORTED_COMPRESSION:
        raise _unsupported(f"{_UNSUPPORTED_COMPRESSION[compression]} "
                           "compression")
    if compression not in _COMPRESSIONS:
        raise _unsupported(f"compression {compression}")
    spp = _one(tags, 277, 1)
    photometric = _one(tags, 262, -1)
    if photometric in _UNSUPPORTED_PHOTOMETRIC:
        raise _unsupported(f"{_UNSUPPORTED_PHOTOMETRIC[photometric]} "
                           "colour")
    allowed = {0: (1,), 1: (1,), 2: (3, 4), 3: (1,)}.get(photometric)
    if allowed is None or spp not in allowed:
        raise _unsupported(f"photometric interpretation {photometric} with "
                           f"{spp} samples a pixel")
    if set((tags.get(339) or [1])[:spp]) != {1}:
        raise _unsupported("samples other than unsigned integers")
    bits = tags.get(258) or [1]
    if len(set(bits[:spp])) != 1 or bits[0] not in (8, 16) or \
            (photometric == 3 and bits[0] != 8):
        raise _unsupported(f"{bits[0]}-bit samples")
    nbytes = bits[0] // 8
    if _one(tags, 266, 1) != 1:
        raise _unsupported("the reversed bit fill order")
    # The Predictor tag belongs to the LZW and Deflate codecs: libtiff
    # ignores it under the others.
    predictor = _one(tags, 317, 1) if compression in (5, 8, 32946) else 1
    if predictor not in (1, 2):
        raise _unsupported(f"predictor {predictor}")
    planar = _one(tags, 284, 1)
    if planar not in (1, 2):
        raise TiffError(f"TIFF with planar configuration {planar}")
    per_chunk = spp if planar == 1 else 1
    planes = spp if planar == 2 else 1
    tiled = 322 in tags or 324 in tags
    if tiled:
        tw, th = _one(tags, 322), _one(tags, 323)
        offsets, counts = tags.get(324), tags.get(325)
        across, down = -(-width // tw), -(-height // th)
    else:
        th = min(_one(tags, 278, height), height)
        tw = width
        offsets, counts = tags.get(273), tags.get(279)
        across, down = 1, -(-height // th)
    if tw <= 0 or th <= 0:
        raise TiffError("TIFF with empty strips or tiles")
    n_chunks = across * down * planes
    if not offsets or not counts:
        raise _unsupported("no strip or tile byte counts")
    if len(offsets) < n_chunks or len(counts) < n_chunks:
        raise TiffError("TIFF lists fewer strips or tiles than its image "
                        "needs")
    if tiled and nbytes == 2 and photometric in (0, 1) and width % tw:
        # libtiff steps through a clipped 16-bit grey tile by the wrong
        # unit and shows zeros and other pixels there.
        raise _unsupported("16-bit grey tiles clipped at the right edge")
    if tiled and compression == 1 and (tw * th * per_chunk * nbytes) % 1024:
        # libtiff as OpenCV builds it refuses an uncompressed tile whose
        # size is not a multiple of 1 KiB ("Invalid tile byte count"), so
        # OpenCV reads no image.
        raise TiffError("uncompressed TIFF tile of a size that is not a "
                        "multiple of 1024 bytes")
    if width * height * spp * nbytes > _EXPANSION[compression] * len(data):
        raise TiffError("TIFF data too short for its image")
    dtype = np.dtype(e + ("u2" if nbytes == 2 else "u1"))
    samples = np.empty((height, width, spp),
                       np.uint16 if nbytes == 2 else np.uint8)
    lib = image_codec.lib()
    k = 0
    for p in range(planes):
        for cy in range(down):
            for cx in range(across):
                rows = th if tiled else min(th, height - cy * th)
                need = rows * tw * per_chunk * nbytes
                off, cnt = offsets[k], counts[k]
                k += 1
                if compression == 1:
                    # libtiff reads an uncompressed chunk's full size
                    # whatever its byte count says.
                    if off < 0 or off + need > len(data):
                        raise TiffError("TIFF strip or tile past the end of "
                                        "the data")
                    raw = np.frombuffer(data, np.uint8, need, off).copy()
                else:
                    if off < 0 or cnt < 0 or off + cnt > len(data):
                        raise TiffError("TIFF strip or tile past the end of "
                                        "the data")
                    if need > _EXPANSION[compression] * cnt:
                        raise TiffError("TIFF strip or tile too short for "
                                        "its pixels")
                    raw = _unpack(data[off:off + cnt], compression, need)
                block = raw.view(dtype).astype(samples.dtype, copy=False)
                block = np.ascontiguousarray(block)
                if predictor == 2:
                    rc = lib.tiff_unpredict(
                        image_codec.ptr(block.view(np.uint8)), rows,
                        tw * per_chunk, per_chunk, nbytes)
                    if rc:
                        raise TiffError("TIFF predictor over a row of "
                                        "partial pixels")
                block = block.reshape(rows, tw, per_chunk)
                y0, x0 = cy * th, cx * tw
                h = min(rows, height - y0)
                w = min(tw, width - x0)
                dst = samples[y0:y0 + h, x0:x0 + w]
                if planar == 1:
                    dst[...] = block[:h, :w]
                else:
                    dst[..., p] = block[:h, :w, 0]
    rgb = _to_rgb(samples, photometric, nbytes, tags)
    return _orient(rgb, _one(tags, 274, 1), tw if tiled else width)


def _to_rgb(samples: np.ndarray, photometric: int, nbytes: int,
            tags: dict) -> np.ndarray:
    if photometric == 3:
        cmap = np.asarray(tags.get(320) or [], np.int64)
        if cmap.size < 3 * 256:
            raise TiffError("palette TIFF without a full colour map")
        cmap = cmap[:3 * 256].reshape(3, 256).T
        if (cmap >= 256).any():
            cmap = cmap >> 8
        return cmap.astype(np.uint8)[samples[..., 0]]
    if photometric in (0, 1):
        grey = samples[..., 0]
        if nbytes == 2:
            grey = (grey >> 8).astype(np.uint8)
        if photometric == 0:
            grey = 255 - grey
        return np.ascontiguousarray(np.repeat(grey[..., None], 3, axis=2))
    px = samples
    if nbytes == 2:
        px = ((px.astype(np.uint32) + 128) // 257).astype(np.uint8)
    rgb = px[..., :3]
    extra = tags.get(338) or []
    if px.shape[2] > 3 and extra and extra[0] == 2:
        alpha = px[..., 3:].astype(np.uint32)
        rgb = ((rgb.astype(np.uint32) * alpha + 127) // 255).astype(np.uint8)
    return np.ascontiguousarray(rgb)


def _orient(rgb: np.ndarray, orientation: int, chunk_width: int
            ) -> np.ndarray:
    """OpenCV's reading of the Orientation tag (values outside 1-8 count
    as 1, as libtiff drops them)."""
    if not 1 <= orientation <= 8:
        return rgb
    if orientation in (2, 3, 6, 7):
        width = rgb.shape[1]
        for x in range(0, width, chunk_width):
            rgb[:, x:x + chunk_width] = rgb[:, x:x + chunk_width][:, ::-1]
    if orientation in (3, 4, 7, 8):
        rgb = rgb[::-1]
    if orientation >= 5:
        rgb = rgb.transpose(1, 0, 2)
        if orientation in (6, 8):
            rgb = rgb[::-1, ::-1]
    return np.ascontiguousarray(rgb)
