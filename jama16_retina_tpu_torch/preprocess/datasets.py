"""Dataset preprocessing runners (counterpart of
``jama16_retina_tpu/preprocess/datasets.py``): the shared machinery of
``preprocess_eyepacs`` and ``preprocess_messidor``.

Flexible label-CSV parsing, stratified train/val/test partitioning, and
image -> fundus-normalize -> JPEG (or raw) -> sharded TFRecords, on the
host with no OpenCV, TensorFlow or torch: the decode is
``data/imdecode.read_image`` (what ``cv2.imread(IMREAD_COLOR)`` reads,
EXIF orientation applied), the normalize ``preprocess/fundus.py``, the
encode ``data/jpeg.encode_jpeg`` (``cv2.imencode``'s bytes), the records
``data/tfrecord.py``. Shards and quality CSVs are byte for byte the
reference's where its decode and normalize are (every downscaled photo;
see ``fundus.py`` for the upscale and ``ben_graham`` paths).

A photo in a format the port recognizes but does not decode yet stops
the run with ``UnsupportedImage`` naming ``jpeg.FORMATS_ITEM``: the
reference would have written its record, so counting it as unreadable
would make another dataset. Bytes that are no image the port recognizes,
or a corrupt or truncated one, count as ``skipped_unreadable``, as
unreadable files do in the reference (where libjpeg or libtiff would
decode a damaged file in part, this counts it; ROADMAP Queue C).
"""

from __future__ import annotations

import csv
import dataclasses
import os
from typing import Iterator, Sequence

import numpy as np

from jama16_retina_tpu_torch.data import imdecode, jpeg, tfrecord
from jama16_retina_tpu_torch.preprocess import fundus

IMAGE_EXTENSIONS = (".jpeg", ".jpg", ".png", ".tif", ".tiff", ".JPG")


class UnsupportedImage(ValueError):
    """A photo in a format the port recognizes but does not decode yet."""


def parse_labels_csv(path: str) -> "dict[str, int]":
    """-> {image_name_without_extension: grade}. The delimiter is sniffed
    (``;`` for Messidor-2, else ``,``), and the name and grade columns are
    picked by header keywords, else the first and second columns."""
    with open(path, newline="") as fh:
        sample = fh.read(4096)
        fh.seek(0)
        delim = ";" if sample.count(";") > sample.count(",") else ","
        rows = list(csv.reader(fh, delimiter=delim))
    if not rows:
        raise ValueError(f"empty labels file {path!r}")

    header = [c.strip().lower() for c in rows[0]]
    name_col, grade_col = 0, 1
    has_header = any(not _is_int(c) for c in rows[0][1:2]) and any(
        k in " ".join(header) for k in ("image", "name", "level", "grade"))
    if has_header:
        for i, col in enumerate(header):
            if "image" in col or "name" in col:
                name_col = i
                break
        for i, col in enumerate(header):
            if "level" in col or "grade" in col or "retinopathy" in col:
                grade_col = i
                break
        rows = rows[1:]

    labels: "dict[str, int]" = {}
    for row in rows:
        if len(row) <= max(name_col, grade_col) or not row[name_col].strip():
            continue
        name = os.path.splitext(row[name_col].strip())[0]
        labels[name] = int(float(row[grade_col].strip()))
    if not labels:
        raise ValueError(f"no (name, grade) rows parsed from {path!r}")
    return labels


def _is_int(s: str) -> bool:
    try:
        int(float(s.strip()))
        return True
    except (ValueError, AttributeError):
        return False


def find_image(data_dir: str, name: str) -> "str | None":
    for ext in IMAGE_EXTENSIONS:
        p = os.path.join(data_dir, name + ext)
        if os.path.exists(p):
            return p
    return None


def stratified_split(
    labels: "dict[str, int]", val_frac: float, test_frac: float,
    seed: int = 0,
) -> "dict[str, list[tuple[str, int]]]":
    """Per-grade shuffle (``default_rng(seed)``, grades in order) then
    slice: the grade marginals are equal across splits."""
    rng = np.random.default_rng(seed)
    splits: "dict[str, list[tuple[str, int]]]" = {
        "train": [], "val": [], "test": []}
    by_grade: "dict[int, list[str]]" = {}
    for name, g in sorted(labels.items()):
        by_grade.setdefault(g, []).append(name)
    for g, names in sorted(by_grade.items()):
        names = list(names)
        rng.shuffle(names)
        n = len(names)
        n_test = int(round(n * test_frac))
        n_val = int(round(n * val_frac))
        for name in names[:n_test]:
            splits["test"].append((name, g))
        for name in names[n_test:n_test + n_val]:
            splits["val"].append((name, g))
        for name in names[n_test + n_val:]:
            splits["train"].append((name, g))
    return splits


@dataclasses.dataclass
class PreprocessStats:
    written: int = 0
    skipped_missing: int = 0
    skipped_unreadable: int = 0
    skipped_no_fundus: int = 0
    skipped_low_quality: int = 0
    # Gradability scores of the WRITTEN records.
    quality_mean: float = 0.0
    quality_min: float = 0.0

    def as_dict(self) -> dict:
        return dataclasses.asdict(self)


def _process_one(task: tuple) -> tuple:
    """One (name, grade) -> (status, quality stats, serialized Example).
    Module-level and arg-packed so the worker pool can pickle it; the
    serial path runs the same function, so pooled output is the serial
    output byte for byte."""
    (name, grade, data_dir, image_size, ben_graham, jpeg_quality,
     encoding, min_quality) = task
    path = find_image(data_dir, name)
    if path is None:
        return "missing", None, None
    with open(path, "rb") as f:
        rgb, why = imdecode.read_image(f.read())
    if rgb is None:
        if why is not None:
            raise UnsupportedImage(f"{path}: {why}")
        return "unreadable", None, None
    try:
        norm, q = fundus.resize_and_center_fundus(
            rgb, diameter=image_size, ben_graham=ben_graham,
            with_quality=True)
    except fundus.FundusNotFound:
        return "no_fundus", None, None
    if q["quality"] < min_quality:
        return "low_quality", q, None
    if encoding == "raw":
        ex = tfrecord.make_raw_example(norm, grade, name, quality=q["quality"])
    else:
        ex = tfrecord.make_jpeg_example(
            jpeg.encode_jpeg(norm, quality=jpeg_quality), grade, name,
            quality=q["quality"])
    return "written", q, ex


def process_split(
    items: "Sequence[tuple[str, int]]",
    data_dir: str,
    out_dir: str,
    split: str,
    image_size: int = 299,
    num_shards: int = 16,
    ben_graham: bool = False,
    jpeg_quality: int = 92,
    encoding: str = "jpeg",
    min_quality: float = 0.0,
    workers: int = 0,
) -> PreprocessStats:
    """Normalize every (name, grade) photo and write TFRecord shards.

    Every photo gets a gradability score (``fundus.gradability_stats``),
    stored in its record (``image/quality``) and in
    ``<out_dir>/quality_<split>.csv``; ``min_quality`` > 0 drops photos
    scoring below it. ``workers`` > 0 fans the per-image stage over that
    many spawned processes; ``imap`` keeps results in item order and this
    process does all the writing, so shards and the CSV are the serial
    run's byte for byte. On an error (a photo the port does not decode, a
    full disk) the pool is terminated, not drained.
    """
    if encoding not in ("jpeg", "raw"):
        raise ValueError(f"encoding must be jpeg|raw, got {encoding!r}")
    stats = PreprocessStats()
    qualities: "list[float]" = []
    os.makedirs(out_dir, exist_ok=True)
    report = open(os.path.join(out_dir, f"quality_{split}.csv"), "w",
                  newline="")
    report_csv = csv.writer(report)
    report_csv.writerow(["name", "grade", "quality", "lap_var", "mean",
                         "std", "written"])

    tasks = [(name, grade, data_dir, image_size, ben_graham, jpeg_quality,
              encoding, min_quality) for name, grade in items]
    bump = {"missing": "skipped_missing",
            "unreadable": "skipped_unreadable",
            "no_fundus": "skipped_no_fundus",
            "low_quality": "skipped_low_quality"}

    def consume(results) -> Iterator[bytes]:
        for (name, grade, *_), (status, q, data) in zip(tasks, results):
            if q is not None:
                report_csv.writerow([name, grade, q["quality"], q["lap_var"],
                                     q["mean"], q["std"],
                                     int(status == "written")])
            if status != "written":
                setattr(stats, bump[status], getattr(stats, bump[status]) + 1)
                continue
            stats.written += 1
            qualities.append(q["quality"])
            yield data

    pool = None
    if workers > 0:
        import multiprocessing as mp

        pool = mp.get_context("spawn").Pool(workers)
        results = pool.imap(_process_one, tasks, chunksize=8)
    else:
        results = map(_process_one, tasks)
    ok = False
    try:
        tfrecord.write_example_shards(consume(results), out_dir, split,
                                      num_shards)
        ok = True
    finally:
        report.close()
        if pool is not None:
            if ok:
                pool.close()
            else:
                pool.terminate()
            pool.join()
    if qualities:
        stats.quality_mean = round(float(np.mean(qualities)), 4)
        stats.quality_min = round(float(np.min(qualities)), 4)
    return stats
