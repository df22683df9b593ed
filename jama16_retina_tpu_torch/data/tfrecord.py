"""TFRecord shards in plain Python and numpy (counterpart of
``jama16_retina_tpu/data/tfrecord.py``): the card machine has no
TensorFlow, protobuf, OpenCV or PIL.

The on-disk contract is the reference's. A file is a sequence of records

    uint64 length | uint32 masked CRC-32C of length | data | uint32 masked
    CRC-32C of data

(little-endian), and each record's data is a serialized ``tf.train.Example``
with these features:

    image/encoded  bytes   JPEG (empty when the record is raw-encoded)
    image/raw      bytes   raw uint8 HWC pixels (empty when JPEG-encoded)
    image/height   int64   raw height (0 for JPEG records)
    image/width    int64   raw width (0 for JPEG records)
    image/grade    int64   ICDR grade 0..4 (binary label derived online)
    image/name     bytes   source image id
    image/quality  float   gradability score in [0,1]; -1 = not computed

Both CRCs are verified on every read; a mismatch raises
``CorruptRecordError`` naming the file and the record's index. Records
decode as ``parse_fn`` does: raw records reshape their bytes to ``[h, w,
3]`` uint8, and JPEG records (what the reference's preprocessing writes
by default) decode bit for bit as ``tf.io.decode_jpeg(dct_method=
"INTEGER_ACCURATE")`` does, EXIF orientation ignored (``data/jpeg.py``;
a format it does not decode raises ``jpeg.JpegError``). The writer packs
raw pixels (``make_raw_example``) or JPEG bytes (``make_jpeg_example``,
with ``jpeg.encode_jpeg`` giving OpenCV's bytes), each Example serialized
as TensorFlow's deterministic serialization writes it, so the port's
shards are byte for byte the reference's. Files are sharded
``<split>-00007-of-00016.tfrecord``.
"""

from __future__ import annotations

import functools
import glob
import os
import struct
from typing import Iterable, Iterator, NamedTuple, Sequence

import numpy as np

from jama16_retina_tpu_torch.obs import faultinject
from jama16_retina_tpu_torch.utils import retry

_POLY = 0x82F63B78  # CRC-32C (Castagnoli), reflected
_MASK_DELTA = 0xA282EAD8
# Below this many bytes a record is checked byte by byte; above it, in
# parallel lanes (``crc32c``).
_LANE_MIN_BYTES = 4096
_LANE_STEPS = 32


class CorruptRecordError(ValueError):
    """A record whose length or data does not match its CRC-32C, or a
    file that ends inside a record."""


def _byte_table() -> np.ndarray:
    table = np.zeros(256, np.uint32)
    for i in range(256):
        c = i
        for _ in range(8):
            c = (c >> 1) ^ _POLY if c & 1 else c >> 1
        table[i] = c
    return table


_TABLE = _byte_table()
_TABLE_LIST = [int(v) for v in _TABLE]
# Slicing-by-4 tables: _SLICE4[k][b] is the register of byte b followed by
# k zero bytes, so four bytes advance with four lookups. Held as int64, the
# index type of a numpy gather, so no lookup converts its indices.
_SLICE4 = [_TABLE]
for _ in range(3):
    _SLICE4.append((_SLICE4[-1] >> 8) ^ _TABLE[_SLICE4[-1] & 0xFF])
_SLICE4 = [t.astype(np.int64) for t in _SLICE4]


def _crc_bytes(state: int, data) -> int:
    """The raw CRC-32C register after ``data`` (no initial or final
    inversion), one table lookup per byte."""
    t = _TABLE_LIST
    for b in data:
        state = t[(state ^ b) & 0xFF] ^ (state >> 8)
    return state


def _apply(matrix: "list[int]", v: int) -> int:
    """A 32x32 GF(2) matrix (its 32 columns) times a 32-bit vector."""
    out, j = 0, 0
    while v:
        if v & 1:
            out ^= matrix[j]
        v >>= 1
        j += 1
    return out


@functools.lru_cache(maxsize=1024)
def _shift_tables(n_bytes: int) -> np.ndarray:
    """[4, 256] int64 lookup tables of the linear map that advances the
    CRC register over ``n_bytes`` zero bytes: the register after ``A + B``
    is ``shift(register after A, len(B)) ^ (register from 0 after B)``."""
    one = [_crc_bytes(1 << j, b"\0") for j in range(32)]  # one zero byte
    power = [1 << j for j in range(32)]  # identity
    n = n_bytes
    while n:
        if n & 1:
            power = [_apply(one, c) for c in power]
        one = [_apply(one, c) for c in one]
        n >>= 1
    tables = np.zeros((4, 256), np.int64)
    idx = np.arange(256, dtype=np.int64)
    for byte in range(4):
        for bit in range(8):
            tables[byte] ^= ((idx >> bit) & 1) * power[8 * byte + bit]
    return tables


def _shift(x: np.ndarray, n_bytes: int) -> np.ndarray:
    t = _shift_tables(n_bytes)
    return (t[0][x & 0xFF] ^ t[1][(x >> 8) & 0xFF]
            ^ t[2][(x >> 16) & 0xFF] ^ t[3][x >> 24])


def crc32c(data) -> int:
    """CRC-32C of ``data`` (bytes-like), table-driven.

    Long inputs run as 2^k lanes of equal length side by side (four
    numpy table lookups per 32-bit word position across all lanes,
    slicing-by-4), and the lanes'
    registers are joined pairwise with the zero-byte shift, since the CRC
    register is linear over GF(2). The initial all-ones register is the
    same as inverting the first four bytes and starting from zero, and a
    zero register stays zero over leading zero bytes, so the input is
    padded at the front to fill the lanes."""
    buf = memoryview(data).cast("B")
    n = len(buf)
    if n < _LANE_MIN_BYTES:
        return _crc_bytes(0xFFFFFFFF, buf) ^ 0xFFFFFFFF
    lanes = 1 << ((n // _LANE_STEPS).bit_length() - 1)
    steps = -(-n // (4 * lanes)) * 4
    padded = np.zeros(lanes * steps, np.uint8)
    padded[lanes * steps - n:] = np.frombuffer(buf, np.uint8)
    padded[lanes * steps - n:][:4] ^= 0xFF
    words = np.ascontiguousarray(
        padded.view("<u4").reshape(lanes, steps // 4).T, np.int64)
    t0, t1, t2, t3 = _SLICE4
    reg = np.zeros(lanes, np.int64)
    for w in words:
        reg ^= w
        reg = (t3[reg & 0xFF] ^ t2[(reg >> 8) & 0xFF]
               ^ t1[(reg >> 16) & 0xFF] ^ t0[reg >> 24])
    span = steps
    while reg.size > 1:
        reg = _shift(reg[0::2], span) ^ reg[1::2]
        span *= 2
    return int(reg[0]) ^ 0xFFFFFFFF


def masked_crc(data) -> int:
    c = crc32c(data)
    return (((c >> 15) | (c << 17)) + _MASK_DELTA) & 0xFFFFFFFF


# ---------------------------------------------------------------------------
# Record framing
# ---------------------------------------------------------------------------

class RecordSpan(NamedTuple):
    """Where one record's data lies in its file."""
    offset: int
    length: int


def _read_exact(f, n: int, path: str, index: int, what: str) -> bytes:
    buf = f.read(n)
    if len(buf) != n:
        raise CorruptRecordError(
            f"{path}: file ends inside the {what} of record {index}")
    return buf


def _read_header(f, path: str, index: int) -> "int | None":
    """The data length of the record at the file's position, after its
    length CRC is checked; None at a clean end of file."""
    head = f.read(12)
    if not head:
        return None
    if len(head) != 12:
        raise CorruptRecordError(
            f"{path}: file ends inside the header of record {index}")
    length, want = struct.unpack("<QI", head)
    if masked_crc(head[:8]) != want:
        raise CorruptRecordError(
            f"{path}: CRC-32C mismatch in the length of record {index}")
    return length


def _read_data(f, length: int, path: str, index: int) -> bytes:
    return _check_data(f, _read_exact(f, length, path, index, "data"),
                       path, index)


def _check_data(f, data: bytes, path: str, index: int) -> bytes:
    """``data`` after the data CRC that follows it in ``f`` is checked."""
    (want,) = struct.unpack(
        "<I", _read_exact(f, 4, path, index, "data CRC"))
    if masked_crc(data) != want:
        raise CorruptRecordError(
            f"{path}: CRC-32C mismatch in the data of record {index}")
    return data


def read_records(path: str) -> Iterator[bytes]:
    """Every record's data in file order, both CRCs checked."""
    with open(path, "rb") as f:
        index = 0
        while (length := _read_header(f, path, index)) is not None:
            yield _read_data(f, length, path, index)
            index += 1


def index_records(path: str) -> "list[RecordSpan]":
    """The span of every record of a file, from its headers alone (length
    CRCs checked; the data is checked when ``read_record_at`` reads it)."""
    spans = []
    with open(path, "rb") as f:
        while (length := _read_header(f, path, len(spans))) is not None:
            spans.append(RecordSpan(f.tell(), length))
            f.seek(length + 4, os.SEEK_CUR)
    return spans


def _read_at(f, span: RecordSpan, path: str, index: int) -> bytes:
    f.seek(span.offset)
    data = faultinject.corrupt(
        "tfrecord.read", _read_exact(f, span.length, path, index, "data"))
    return _check_data(f, data, path, index)


def read_record_at(f, span: RecordSpan, path: str, index: int) -> bytes:
    """One record's data from an open file, its data CRC checked (the
    reference's ``TFRecordIndex.read``). The data passes the
    ``tfrecord.read`` fault seam, and an ``OSError`` is retried up to 3
    times (``utils/retry.py``, counted as ``io.retries.tfrecord.read``); a
    damaged payload fails its CRC and raises ``CorruptRecordError``,
    which is not retried."""
    return retry.retry_call(_read_at, f, span, path, index, attempts=4,
                            site="tfrecord.read")


def frame_record(data: bytes) -> bytes:
    head = struct.pack("<Q", len(data))
    return b"".join((head, struct.pack("<I", masked_crc(head)), data,
                     struct.pack("<I", masked_crc(data))))


# ---------------------------------------------------------------------------
# tf.train.Example wire format (the subset this schema uses)
# ---------------------------------------------------------------------------

def _varint(buf, pos: int) -> "tuple[int, int]":
    result = shift = 0
    while True:
        b = buf[pos]
        pos += 1
        result |= (b & 0x7F) << shift
        if b < 0x80:
            return result, pos
        shift += 7
        if shift > 63:
            raise ValueError("malformed varint in tf.train.Example")


def _fields(buf) -> Iterator["tuple[int, int, object]"]:
    """(field number, wire type, value) of a message: the int of a
    varint, the bytes (a memoryview) of a length-delimited field, the raw
    bytes of a fixed32/fixed64."""
    pos, end = 0, len(buf)
    while pos < end:
        key, pos = _varint(buf, pos)
        field, wire = key >> 3, key & 7
        if wire == 0:
            value, pos = _varint(buf, pos)
        elif wire == 2:
            n, pos = _varint(buf, pos)
            value = buf[pos:pos + n]
            if len(value) != n:
                raise ValueError("truncated field in tf.train.Example")
            pos += n
        elif wire in (1, 5):
            n = 8 if wire == 1 else 4
            value = buf[pos:pos + n]
            pos += n
        else:
            raise ValueError(f"unsupported wire type {wire} in "
                             "tf.train.Example")
        yield field, wire, value


def _int64(v: int) -> int:
    return v - (1 << 64) if v >= 1 << 63 else v


def _decode_feature(buf) -> "tuple[str, list]":
    kind, values = "bytes", []
    for field, _, body in _fields(buf):
        if field == 1:  # BytesList
            kind = "bytes"
            values = [bytes(v) for f, _, v in _fields(body) if f == 1]
        elif field == 2:  # FloatList, packed or not
            kind, values = "float", []
            for f, wire, v in _fields(body):
                if f == 1:
                    values.extend(np.frombuffer(v, "<f4").tolist())
        elif field == 3:  # Int64List, packed or not
            kind, values = "int64", []
            for f, wire, v in _fields(body):
                if f != 1:
                    continue
                if wire == 0:
                    values.append(_int64(v))
                else:
                    pos = 0
                    while pos < len(v):
                        x, pos = _varint(v, pos)
                        values.append(_int64(x))
    return kind, values


def parse_example(data) -> "dict[str, tuple[str, list]]":
    """A serialized ``tf.train.Example`` -> ``{name: (kind, values)}``,
    kind one of ``bytes``, ``float``, ``int64``."""
    out = {}
    buf = memoryview(data).cast("B")
    for field, _, features in _fields(buf):
        if field != 1:
            continue
        for f, _, entry in _fields(features):
            if f != 1:
                continue
            key, value = "", memoryview(b"")
            for ef, _, ev in _fields(entry):
                if ef == 1:
                    key = bytes(ev).decode()
                elif ef == 2:
                    value = ev
            out[key] = _decode_feature(value)
    return out


def _scalar(feats: dict, name: str, kind: str, default=None):
    """A ``FixedLenFeature([])``: exactly one value of ``kind``, or the
    default when the feature is absent (absent with no default raises)."""
    if name not in feats:
        if default is None:
            raise ValueError(f"record lacks required feature {name!r}")
        return default
    got_kind, values = feats[name]
    if len(values) != 1 or (got_kind != kind and values):
        raise ValueError(f"feature {name!r} holds {len(values)} "
                         f"{got_kind} value(s), want one {kind}")
    return values[0]


class Record(NamedTuple):
    # uint8 [h, w, 3]: a read-only view of a raw record, a new array of a
    # JPEG one.
    image: np.ndarray
    grade: int
    name: bytes
    quality: float


def parse_record(data) -> Record:
    """One serialized Example -> ``Record``, as the reference's
    ``parse_fn`` decodes it: raw records reshape their bytes to
    ``[h, w, 3]`` uint8; JPEG records decode (``jpeg.decode_jpeg`` with
    the EXIF orientation ignored, as TensorFlow ignores it)."""
    from jama16_retina_tpu_torch.data import jpeg

    feats = parse_example(data)
    raw = _scalar(feats, "image/raw", "bytes", b"")
    if raw:
        h = _scalar(feats, "image/height", "int64", 0)
        w = _scalar(feats, "image/width", "int64", 0)
        if h * w * 3 != len(raw):
            raise ValueError(f"raw record of {len(raw)} bytes does not hold "
                             f"[{h}, {w}, 3] uint8")
        image = np.frombuffer(raw, np.uint8).reshape(h, w, 3)
    else:
        encoded = _scalar(feats, "image/encoded", "bytes", b"")
        if not encoded:
            raise ValueError("record holds neither image/raw nor "
                             "image/encoded bytes")
        image = jpeg.decode_jpeg(encoded, exif_orientation=False)
    return Record(
        image=image,
        grade=int(_scalar(feats, "image/grade", "int64")),
        name=_scalar(feats, "image/name", "bytes", b""),
        quality=float(_scalar(feats, "image/quality", "float", -1.0)))


def _key(field: int, wire: int) -> bytes:
    return _varint_bytes(field << 3 | wire)


def _varint_bytes(v: int) -> bytes:
    if v < 0:
        v += 1 << 64
    out = bytearray()
    while True:
        b = v & 0x7F
        v >>= 7
        if v:
            out.append(b | 0x80)
        else:
            out.append(b)
            return bytes(out)


def _len_field(field: int, payload: bytes) -> bytes:
    return b"".join((_key(field, 2), _varint_bytes(len(payload)), payload))


def _feature(kind: str, value) -> bytes:
    if kind == "bytes":
        return _len_field(1, _len_field(1, value))
    if kind == "float":
        return _len_field(2, _len_field(1, struct.pack("<f", value)))
    return _len_field(3, _len_field(1, _varint_bytes(int(value))))


def make_raw_example(image_u8: np.ndarray, grade: int, name: str = "",
                     quality: float = -1.0) -> bytes:
    """A serialized raw-encoded Example: uint8 HWC pixels stored
    verbatim, map entries in key order (as TensorFlow's deterministic
    serialization writes them)."""
    image_u8 = np.asarray(image_u8)
    if image_u8.ndim != 3 or image_u8.shape[2] != 3 or \
            image_u8.dtype != np.uint8:
        raise ValueError(f"expected uint8 HW3, got {image_u8.dtype} "
                         f"{image_u8.shape}")
    h, w, _ = image_u8.shape
    feats = {
        "image/grade": ("int64", grade),
        "image/height": ("int64", h),
        "image/name": ("bytes", name.encode()),
        "image/quality": ("float", quality),
        "image/raw": ("bytes", np.ascontiguousarray(image_u8).tobytes()),
        "image/width": ("int64", w),
    }
    entries = b"".join(
        _len_field(1, _len_field(1, k.encode()) + _len_field(2, _feature(*v)))
        for k, v in sorted(feats.items()))
    return _len_field(1, entries)


def make_jpeg_example(jpeg_bytes: bytes, grade: int, name: str = "",
                      quality: float = -1.0) -> bytes:
    """A serialized JPEG-encoded Example with the features the reference's
    ``make_example`` writes (``image/encoded``, grade, name, quality: no
    height or width, which read back as 0), from bytes that are already
    JPEG."""
    feats = {
        "image/encoded": ("bytes", bytes(jpeg_bytes)),
        "image/grade": ("int64", grade),
        "image/name": ("bytes", name.encode()),
        "image/quality": ("float", quality),
    }
    entries = b"".join(
        _len_field(1, _len_field(1, k.encode()) + _len_field(2, _feature(*v)))
        for k, v in sorted(feats.items()))
    return _len_field(1, entries)


def shard_path(out_dir: str, split: str, shard: int, num_shards: int) -> str:
    return os.path.join(
        out_dir, f"{split}-{shard:05d}-of-{num_shards:05d}.tfrecord")


def write_example_shards(examples: Iterable[bytes], out_dir: str, split: str,
                         num_shards: int) -> "list[str]":
    """Round-robin serialized Examples into ``num_shards`` files."""
    os.makedirs(out_dir, exist_ok=True)
    paths = [shard_path(out_dir, split, i, num_shards)
             for i in range(num_shards)]
    files = [open(p, "wb") for p in paths]
    try:
        for i, ex in enumerate(examples):
            files[i % num_shards].write(frame_record(ex))
    finally:
        for f in files:
            f.close()
    return paths


def write_synthetic_split(out_dir: str, split: str, n: int,
                          image_size: "int | None" = None,
                          num_shards: int = 4, seed: int = 0,
                          encoding: str = "jpeg") -> "list[str]":
    """Synthetic fundus images (``data/synthetic.py``) as TFRecord shards,
    JPEG-encoded at quality 92 (``encoding="jpeg"``, the reference's
    default) or raw, named ``<split>_<seed>_<i>`` as the reference names
    them; the same arguments write the same bytes in both packages."""
    from jama16_retina_tpu_torch.data import jpeg, synthetic

    if encoding not in ("jpeg", "raw"):
        raise ValueError(f"encoding must be jpeg|raw, got {encoding!r}")
    images, grades = synthetic.make_dataset(
        n, synthetic.SynthConfig(
            image_size=299 if image_size is None else image_size), seed=seed)

    def example(i: int) -> bytes:
        name, grade = f"{split}_{seed}_{i:05d}", int(grades[i])
        if encoding == "raw":
            return make_raw_example(images[i], grade, name)
        return make_jpeg_example(jpeg.encode_jpeg(images[i]), grade, name)

    return write_example_shards((example(i) for i in range(n)), out_dir,
                                split, num_shards)


def list_split(data_dir: str, split: str) -> "list[str]":
    paths = sorted(glob.glob(os.path.join(data_dir, f"{split}-*.tfrecord")))
    if not paths:
        raise FileNotFoundError(
            f"no TFRecord shards for split {split!r} in {data_dir!r} — run "
            "preprocessing (preprocess_eyepacs.py) or the synthetic fixture "
            "writer first")
    return paths


def count_records(paths: Sequence[str]) -> int:
    """The records of ``paths``, a transient ``OSError`` retried
    (``io.retries.tfrecord.count``)."""
    return retry.retry_call(
        lambda: sum(len(index_records(p)) for p in paths), attempts=3,
        site="tfrecord.count")


def read_quality_by_name(paths: Sequence[str]) -> "dict[bytes, float]":
    """{image/name: image/quality} over every record (-1.0 where the
    record has no quality)."""
    out = {}
    for p in paths:
        for data in read_records(p):
            feats = parse_example(data)
            out[_scalar(feats, "image/name", "bytes", b"")] = float(
                _scalar(feats, "image/quality", "float", -1.0))
    return out
