"""Ahead-of-time raw-shard transcode and loader: ``data.loader="rawshard"``
(counterpart of ``jama16_retina_tpu/data/rawshard.py``).

  TRANSCODE (offline, once): TFRecord shards (JPEG or raw) -> resized
      uint8 arrays written as plain ``.npy`` shard pairs (images +
      grades) with a sealed, versioned JSON manifest
      (``python -m jama16_retina_tpu_torch.transcode_shards``).
  LOAD (every epoch): each shard is memory-mapped (``np.load
      mmap_mode``); reading record i is a bisect and one row copy out of
      the page cache — no proto parse, no decode, no framing scan.

The transcode decodes record i of the source split with the same
``_decode_example`` and quarantine substitution the streamed tier applies
online (``grain_pipeline.ParallelDecoder``) and stores it at global index
i, so the rawshard loader yields the same batches as the tiered loader
over the source records at the same seed and residency, and the shard
files are the reference's byte for byte. Either package reads the
other's shards.

The loader is the tiered loader with another decode stage:
``RawShardDecoder`` subclasses ``ParallelDecoder`` overriding only the
per-record read, and ``train_batches`` plugs it into
``tiered_pipeline.train_batches``' ``decoder_factory`` seam — residency,
staging, quarantine, autotuner knobs and telemetry apply unchanged.

Durability: shard writes are atomic (``integrity/artifact.
atomic_write_bytes``, retried as ``io.retries.rawshard.write``) and the
manifest is rewritten after every completed shard, so an interrupted
transcode resumes from the last durable shard. The manifest pins format
version, image size, per-shard byte sizes and digests, and the source
files' names and sizes; the loader refuses shards that are stale against
their source or written at another size.
"""

from __future__ import annotations

import bisect
import hashlib
import io
import json
import logging
import os
import time
from typing import Iterator

import numpy as np

from jama16_retina_tpu_torch.configs import DataConfig
from jama16_retina_tpu_torch.data import tfrecord
from jama16_retina_tpu_torch.data.grain_pipeline import (
    ParallelDecoder,
    TFRecordIndex,
    resolve_decode_workers,
)
from jama16_retina_tpu_torch.integrity import artifact as artifact_lib
from jama16_retina_tpu_torch.utils import retry as retry_lib

_log = logging.getLogger(__name__)

MANIFEST_FORMAT = "jama16.rawshard"
MANIFEST_VERSION = 1
TRANSCODE_CMD = "python -m jama16_retina_tpu_torch.transcode_shards"


def manifest_path(shard_dir: str, split: str) -> str:
    return os.path.join(shard_dir, f"{split}.rawshard.json")


def default_shard_dir(data_dir: str, image_size: int) -> str:
    """Where ``data.loader=rawshard`` looks when ``data.rawshard_dir`` is
    unset: a size-suffixed sibling of the source shards."""
    return os.path.join(data_dir, f"rawshard{image_size}")


def _shard_names(split: str, i: int, num: int) -> tuple[str, str]:
    stem = f"{split}-{i:05d}-of-{num:05d}"
    return f"{stem}.images.npy", f"{stem}.grades.npy"


def _atomic_save(path: str, arr: np.ndarray) -> str:
    """``np.save`` bytes of ``arr`` published through the sealed writer
    seam (tmp + fsync + ``os.replace``, the ``integrity.write`` fault
    sites), retried as ``io.retries.rawshard.write``; -> the sha256 of
    the written bytes (the manifest's per-shard digest)."""
    buf = io.BytesIO()
    np.save(buf, arr)
    # A zero-copy view: one transient copy of the shard, not two.
    blob = buf.getbuffer()
    digest = hashlib.sha256(blob).hexdigest()

    def _write() -> None:
        artifact_lib.atomic_write_bytes(path, blob)

    retry_lib.retry_call(_write, attempts=3, site="rawshard.write")
    return digest


def _atomic_write_json(path: str, obj: dict) -> None:
    artifact_lib.write_sealed_json(
        path, obj, schema="rawshard.manifest", version=MANIFEST_VERSION
    )


def source_fingerprint(paths) -> list[dict]:
    """What "the same source split" means for staleness: file names and
    byte sizes of every TFRecord shard (not mtimes: a byte-identical
    re-copy does not read as stale)."""
    return [
        {"name": os.path.basename(p), "bytes": os.path.getsize(p)}
        for p in sorted(paths)
    ]


def _entry_valid(shard_dir: str, e: dict) -> bool:
    """A manifest entry counts only if both files exist at the recorded
    sizes (the resume gate)."""
    for k, size_k in (("images", "images_bytes"), ("grades", "grades_bytes")):
        p = os.path.join(shard_dir, e[k])
        if not os.path.exists(p) or os.path.getsize(p) != e[size_k]:
            return False
    return True


def transcode_split(
    data_dir: str,
    split: str,
    out_dir: "str | None" = None,
    image_size: int = 299,
    shard_records: int = 256,
    workers: int = 0,
    quarantine: bool = True,
    resume: bool = True,
) -> dict:
    """Transcode one TFRecord split into raw ``.npy`` shard pairs +
    manifest; returns the manifest dict. Idempotent and resumable:
    shards already durable (listed in the manifest at their recorded
    sizes) are skipped; ``resume=False`` rebuilds from scratch.
    ``quarantine=True`` bakes the streamed tier's poison-record
    substitution into the shards; ``False`` makes a poison source record
    fail the transcode."""
    out_dir = out_dir or default_shard_dir(data_dir, image_size)
    os.makedirs(out_dir, exist_ok=True)
    src_paths = tfrecord.list_split(data_dir, split)
    index = TFRecordIndex(src_paths)
    n = len(index)
    if n == 0:
        raise ValueError(f"no records under {data_dir}/{split}")
    shard_records = max(1, int(shard_records))
    num_shards = -(-n // shard_records)  # ceil
    fp = source_fingerprint(src_paths)

    manifest = {
        "format": MANIFEST_FORMAT,
        "version": MANIFEST_VERSION,
        "split": split,
        "image_size": int(image_size),
        "num_records": n,
        "shard_records": shard_records,
        "quarantine_baked": bool(quarantine),
        "source": {"files": fp, "num_records": n},
        "shards": [],
    }
    done: dict[int, dict] = {}
    mpath = manifest_path(out_dir, split)
    if resume and os.path.exists(mpath):
        try:
            with open(mpath) as f:
                prev = json.load(f)
        except (OSError, json.JSONDecodeError):
            prev = None
        head_keys = (
            "format", "version", "split", "image_size", "num_records",
            "shard_records", "quarantine_baked", "source",
        )
        if prev and all(prev.get(k) == manifest[k] for k in head_keys):
            for e in prev.get("shards", []):
                if _entry_valid(out_dir, e):
                    done[e["start"] // shard_records] = e
            if done:
                _log.info(
                    "rawshard transcode: resuming %s/%s — %d/%d shards "
                    "already durable", out_dir, split, len(done), num_shards,
                )
        elif prev:
            _log.warning(
                "rawshard transcode: existing manifest at %s does not "
                "match this transcode's parameters/source — rebuilding "
                "all shards", mpath,
            )

    decoder = ParallelDecoder(
        index, image_size, workers=resolve_decode_workers(workers),
        quarantine=quarantine,
    )
    t0 = time.perf_counter()
    written = 0
    try:
        for i in range(num_shards):
            lo, hi = i * shard_records, min(n, (i + 1) * shard_records)
            if i in done:
                manifest["shards"].append(done[i])
                continue
            images, grades = decoder.decode_range(lo, hi)
            img_name, gr_name = _shard_names(split, i, num_shards)
            img_sha = _atomic_save(os.path.join(out_dir, img_name), images)
            gr_sha = _atomic_save(os.path.join(out_dir, gr_name), grades)
            entry = {
                "images": img_name,
                "grades": gr_name,
                "start": lo,
                "records": hi - lo,
                "images_bytes": os.path.getsize(
                    os.path.join(out_dir, img_name)
                ),
                "grades_bytes": os.path.getsize(
                    os.path.join(out_dir, gr_name)
                ),
                "images_sha256": img_sha,
                "grades_sha256": gr_sha,
            }
            manifest["shards"].append(entry)
            written += 1
            # The resume point advances with every durable shard.
            _atomic_write_json(mpath, manifest)
    finally:
        decoder.close()
    _atomic_write_json(mpath, manifest)
    _log.info(
        "rawshard transcode: %s/%s -> %s: %d records, %d shards "
        "(%d written, %d reused) in %.1fs",
        data_dir, split, out_dir, n, num_shards, written,
        num_shards - written, time.perf_counter() - t0,
    )
    return manifest


class RawShardSplit:
    """Validated view over one transcoded split: manifest + lazily
    memory-mapped shard arrays.

    ``source_dir``: when the original TFRecord split is reachable, its
    fingerprint is checked against the manifest's, and stale shards are
    refused with the command that fixes them. A missing source is fine:
    steady-state training does not need the TFRecords."""

    def __init__(self, shard_dir: str, split: str,
                 image_size: "int | None" = None,
                 source_dir: "str | None" = None):
        self.shard_dir = shard_dir
        self.split = split
        mpath = manifest_path(shard_dir, split)
        if not os.path.exists(mpath):
            raise FileNotFoundError(
                f"no rawshard manifest at {mpath} — transcode the split "
                f"first: {TRANSCODE_CMD} "
                f"--data_dir <tfrecord dir> --splits {split}"
                + (f" --image_size {image_size}" if image_size else "")
            )
        with open(mpath) as f:
            self.manifest = json.load(f)
        m = self.manifest
        if m.get("format") != MANIFEST_FORMAT or (
                m.get("version") != MANIFEST_VERSION):
            raise ValueError(
                f"rawshard manifest {mpath} has format/version "
                f"{m.get('format')!r}/{m.get('version')!r}; this build "
                f"reads {MANIFEST_FORMAT!r}/{MANIFEST_VERSION} — "
                f"re-transcode with {TRANSCODE_CMD}"
            )
        # The seal after the format refusal: a bit-flipped manifest
        # raises ArtifactCorrupt (counted) before its values are used.
        artifact_lib.verify_payload(m, mpath, artifact="rawshard")
        if image_size is not None and m["image_size"] != image_size:
            raise ValueError(
                f"rawshard split at {shard_dir} was transcoded at "
                f"{m['image_size']}px but the model wants {image_size}px "
                f"— re-transcode: {TRANSCODE_CMD} "
                f"--data_dir <tfrecord dir> --splits {split} "
                f"--image_size {image_size}"
            )
        expect = sum(e["records"] for e in m["shards"])
        if expect != m["num_records"]:
            raise ValueError(
                f"rawshard manifest {mpath} is incomplete: shards cover "
                f"{expect} of {m['num_records']} records — the transcode "
                f"was interrupted; re-run {TRANSCODE_CMD} "
                "(it resumes from the last durable shard)"
            )
        if source_dir is not None:
            try:
                src = tfrecord.list_split(source_dir, split)
            except FileNotFoundError:
                src = None
            if src is not None and (
                    source_fingerprint(src) != m["source"]["files"]):
                raise ValueError(
                    f"rawshard split at {shard_dir} is STALE: the source "
                    f"TFRecords under {source_dir} changed since the "
                    f"transcode — re-run {TRANSCODE_CMD}"
                )
        self.image_size = int(m["image_size"])
        self._entries = sorted(m["shards"], key=lambda e: e["start"])
        self._starts = [e["start"] for e in self._entries]
        # Not locked: two decode threads may both map a shard, and the
        # second mapping simply wins (the reference's stance).
        self._mmaps: dict[int, tuple] = {}

    def __len__(self) -> int:
        return int(self.manifest["num_records"])

    def shard_arrays(self, j: int) -> tuple[np.ndarray, np.ndarray]:
        """(images mmap [k,S,S,3] u8, grades [k] i32) for shard j, mapped
        lazily and cached. Opens retry as ``io.retries.rawshard.read``;
        a still-failing or mis-shaped shard raises for the decoder's
        quarantine."""
        cached = self._mmaps.get(j)
        if cached is not None:
            return cached
        e = self._entries[j]

        def _open():
            imgs = np.load(
                os.path.join(self.shard_dir, e["images"]), mmap_mode="r"
            )
            grs = np.load(
                os.path.join(self.shard_dir, e["grades"]), mmap_mode="r"
            )
            return imgs, grs

        imgs, grs = retry_lib.retry_call(
            _open, attempts=3, site="rawshard.read"
        )
        want = (e["records"], self.image_size, self.image_size, 3)
        if tuple(imgs.shape) != want or grs.shape != (e["records"],):
            raise ValueError(
                f"rawshard shard {e['images']} has shape {imgs.shape} / "
                f"{grs.shape}, manifest says {want} — shard corrupt or "
                f"manifest stale; re-run {TRANSCODE_CMD}"
            )
        self._mmaps[j] = (imgs, grs)
        return imgs, grs

    def row(self, i: int) -> dict:
        j = bisect.bisect_right(self._starts, i) - 1
        imgs, grs = self.shard_arrays(j)
        r = i - self._starts[j]
        # Contiguous copies out of the mmap.
        return {
            "image": np.ascontiguousarray(imgs[r]),
            "grade": np.int32(grs[r]),
        }


class RawShardDecoder(ParallelDecoder):
    """``ParallelDecoder`` whose per-record read is a shard-row copy: the
    worker pool, ``set_workers``, the poison quarantine with its
    next-readable substitution, ``decode_batch`` / ``decode_range`` and
    the ``data.decode.*`` telemetry all come with it."""

    def __init__(self, split: RawShardSplit, workers: int = 1,
                 registry=None, quarantine: bool = True):
        # ``split`` stands in for the index: the quarantine's scan only
        # needs len(); reads go through _read_decode.
        super().__init__(
            split, split.image_size, workers=workers, registry=registry,
            quarantine=quarantine,
        )
        self._split = split

    def _read_decode(self, i: int, n: "int | None" = None) -> dict:
        return self._split.row(i % n if n else i)


def train_batches(
    data_dir: str,
    split: str,
    cfg: DataConfig,
    image_size: int,
    seed: int = 0,
    skip_batches: int = 0,
    mesh=None,
    max_fraction: float = 0.6,
    knobs=None,
    device=None,
) -> Iterator[dict]:
    """``tiered_pipeline.train_batches`` reading the transcoded shards
    (``data.rawshard_dir``, else ``default_shard_dir``): the same plan,
    staging, quarantine and knobs, so the same batches."""
    from jama16_retina_tpu_torch.data import tiered_pipeline

    shard_dir = (
        cfg.rawshard_dir if cfg.rawshard_dir
        else default_shard_dir(data_dir, image_size)
    )
    rs = RawShardSplit(
        shard_dir, split, image_size=image_size, source_dir=data_dir
    )

    def factory(workers: int, quarantine: bool) -> RawShardDecoder:
        return RawShardDecoder(rs, workers=workers, quarantine=quarantine)

    return tiered_pipeline.train_batches(
        data_dir, split, cfg, image_size, seed=seed,
        skip_batches=skip_batches, mesh=mesh, max_fraction=max_fraction,
        knobs=knobs, decoder_factory=factory, device=device,
    )
