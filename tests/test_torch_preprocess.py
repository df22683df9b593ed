"""The port's preprocess runners (``preprocess/datasets.py``,
``preprocess_eyepacs``, ``preprocess_messidor``) against the JAX
package's on the CPU.

The label parsing and the stratified split are held to the reference's
functions on the inputs of ``tests/test_preprocess.py``. The shards,
quality CSVs and printed reports are held bitwise to what the reference's
CLIs wrote on the same directories (``tests/data/preprocess/
manifest.json``, written by ``tests/make_torch_fixtures.py``, which runs
``preprocess_eyepacs.py`` and ``preprocess_messidor.py``): photos at 64
px from 96-1440-px JPEG, PNG and TIFF files, all downscaled, with a
missing, a blank and an unreadable photo, and a ``min_quality`` that
drops some. A format the port does not decode yet stops the run."""

import json
import os
import subprocess
import sys
from pathlib import Path

import pytest

from jama16_retina_tpu.preprocess import datasets as jax_datasets
from jama16_retina_tpu_torch import preprocess_eyepacs, preprocess_messidor
from jama16_retina_tpu_torch.data import jpeg
from jama16_retina_tpu_torch.preprocess import datasets
from make_torch_fixtures import build_runner_dir, file_digests

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
DATA = os.path.join(REPO, "tests", "data")
with open(os.path.join(DATA, "preprocess", "manifest.json")) as _f:
    RUNNERS = json.load(_f)["runners"]

LABEL_FILES = {
    "eyepacs": ([["image", "level"], ["10_left", "0"], ["10_right", "3"],
                 ["13_left", "2"]], ","),
    "messidor": ([["Image name", "Retinopathy grade", "Macular edema"],
                  ["20051020_43808_0100_PP.tif", "2", "0"],
                  ["20051020_43832_0100_PP.tif", "0", "1"]], ";"),
    "headerless": ([["img_a", "1"], ["img_b", "4"]], ","),
    "float_grades": ([["name", "grade"], ["a.jpeg", "2.0"], ["b", " 1 "],
                      ["", "3"], ["short"]], ","),
}


def _write_csv(path, rows, delim):
    import csv

    with open(path, "w", newline="") as fh:
        csv.writer(fh, delimiter=delim).writerows(rows)


@pytest.mark.parametrize("case", sorted(LABEL_FILES))
def test_labels_csv_parses_as_the_reference(case, tmp_path):
    rows, delim = LABEL_FILES[case]
    p = str(tmp_path / "labels.csv")
    _write_csv(p, rows, delim)
    assert datasets.parse_labels_csv(p) == jax_datasets.parse_labels_csv(p)


def test_empty_labels_raise_as_the_reference(tmp_path):
    p = str(tmp_path / "empty.csv")
    _write_csv(p, [], ",")
    for mod in (datasets, jax_datasets):
        with pytest.raises(ValueError, match="empty labels"):
            mod.parse_labels_csv(p)


@pytest.mark.parametrize("labels,val,test,seed", [
    ({f"g{g}_{i}": g for g in range(5) for i in range(40)}, 0.1, 0.2, 0),
    ({f"im{i}": i % 5 for i in range(50)}, 0.2, 0.2, 3),
    ({f"x{i}": (i * 7) % 3 for i in range(23)}, 0.15, 0.3, 11)])
def test_stratified_split_is_the_references(labels, val, test, seed):
    assert datasets.stratified_split(labels, val, test, seed) == \
        jax_datasets.stratified_split(labels, val, test, seed)


def _argv(spec: dict, run: dict, root) -> "list[str]":
    labels = build_runner_dir(spec, DATA, str(root))
    return [f"--data_dir={root / 'images'}", f"--labels_csv={labels}",
            f"--output_dir={root / 'out'}", *run["argv"]]


@pytest.mark.parametrize("run,workers", [
    ("jpeg", 0), ("jpeg_min_quality", 0), ("jpeg_min_quality", 2),
    ("raw_min_quality", 0), ("raw_min_quality", 2)])
def test_process_split_writes_the_references_bytes(run, workers, tmp_path):
    """Each split through ``process_split`` as the EyePACS CLI drives it:
    every shard and ``quality_<split>.csv`` bitwise the reference's, the
    counts its report's, at ``workers`` 0 and 2."""
    spec = RUNNERS["eyepacs_cpu"]
    want = spec["runs"][run]
    args = preprocess_eyepacs._parser().parse_args(_argv(spec, want,
                                                         tmp_path))
    labels = datasets.parse_labels_csv(args.labels_csv)
    report = {}
    for split, items in datasets.stratified_split(
            labels, args.val_frac, args.test_frac, args.seed).items():
        stats = datasets.process_split(
            items, args.data_dir, args.output_dir, split,
            image_size=args.image_size, num_shards=args.num_shards,
            encoding=args.encoding, min_quality=args.min_quality,
            workers=workers)
        report[split] = {"n_labeled": len(items), **stats.as_dict()}
    assert report == json.loads(want["stdout"])
    assert file_digests(args.output_dir) == want["files"]
    if "min_quality" in run:
        assert sum(r["skipped_low_quality"] for r in report.values()) > 0
    counts = {k: sum(r[k] for r in report.values()) for k in (
        "skipped_missing", "skipped_unreadable", "skipped_no_fundus")}
    assert counts == {"skipped_missing": 1, "skipped_unreadable": 1,
                      "skipped_no_fundus": 1}


_RUN_CLI = r"""
import sys
from jama16_retina_tpu_torch import preprocess_eyepacs, preprocess_messidor
cli = {"preprocess_eyepacs": preprocess_eyepacs,
       "preprocess_messidor": preprocess_messidor}[sys.argv[1]]
code = cli.main(sys.argv[2:])
bad = sorted(m for m in sys.modules
             if m.split(".")[0] in ("torch", "jax", "jaxlib", "tensorflow",
                                    "absl", "cv2", "PIL")
             or m == "jama16_retina_tpu" or m.startswith("jama16_retina_tpu."))
print("BAD", bad, "CODE", code, file=sys.stderr)
"""


@pytest.mark.parametrize("spec_name,run", [("eyepacs_cpu", "jpeg"),
                                           ("messidor_cpu", "jpeg")])
def test_cli_prints_and_writes_what_the_reference_cli_did(spec_name, run,
                                                          tmp_path):
    """``python -m jama16_retina_tpu_torch.preprocess_{eyepacs,messidor}``
    with the reference CLI's flags: the same printed JSON, character for
    character, and the same files, with no torch, JAX, TensorFlow,
    OpenCV or PIL loaded."""
    spec = RUNNERS[spec_name]
    want = spec["runs"][run]
    out = subprocess.run(
        [sys.executable, "-c", _RUN_CLI, spec["cli"],
         *_argv(spec, want, tmp_path)],
        cwd=REPO, capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-3000:]
    assert out.stderr.strip().splitlines()[-1] == "BAD [] CODE 0"
    assert out.stdout == want["stdout"]
    assert file_digests(str(tmp_path / "out")) == want["files"]


@pytest.mark.parametrize("kind,workers", [("webp", 0), ("gif", 2)])
def test_a_format_not_decoded_yet_stops_the_run(kind, workers, tmp_path):
    """The reference would write its record, so the run stops naming
    ROADMAP item 14 instead of counting the photo as unreadable; the
    pooled run is stopped, not drained."""
    images = tmp_path / "images"
    images.mkdir()
    jpegs = Path(DATA) / "jpeg"
    items = []
    for i in range(12):
        (images / f"ok_{i}.jpeg").write_bytes(
            (jpegs / "fundus299_0.jpg").read_bytes())
        items.append((f"ok_{i}", i % 5))
    if kind == "webp":
        odd = b"RIFF\x24\x00\x00\x00WEBPVP8 " + bytes(24)
    else:
        odd = b"GIF89a" + bytes(32)
    (images / "odd.jpeg").write_bytes(odd)
    items.insert(3, ("odd", 2))
    with pytest.raises(datasets.UnsupportedImage, match="item 14"):
        datasets.process_split(items, str(images), str(tmp_path / "out"),
                               "train", image_size=64, num_shards=2,
                               workers=workers)


def test_encoding_must_be_jpeg_or_raw(tmp_path):
    with pytest.raises(ValueError, match="jpeg|raw"):
        datasets.process_split([], str(tmp_path), str(tmp_path), "train",
                               encoding="png")
    with pytest.raises(SystemExit):
        preprocess_messidor.main(["--data_dir=x", "--labels_csv=y"])


def test_the_manifests_encodings_are_the_ports():
    """The sha256 of ``cv2.imencode`` (quality 92) of each photo's decode
    and of its 299-px canvas, which ``chip_smoke.py`` holds the card
    machine's host to, are the port encoder's here."""
    import hashlib

    from jama16_retina_tpu_torch.data import imdecode
    from jama16_retina_tpu_torch.preprocess import fundus

    with open(os.path.join(DATA, "preprocess", "manifest.json")) as f:
        encode = json.load(f)["encode"]
    for src in sorted(k for k in encode if ":" not in k)[:4]:
        rgb = imdecode.imdecode((Path(DATA) / src).read_bytes())
        canvas = fundus.resize_and_center_fundus(rgb, diameter=299)
        for key, img in ((src, rgb), (src + ":canvas299", canvas)):
            got = hashlib.sha256(jpeg.encode_jpeg(img)).hexdigest()
            assert got == encode[key], key


@pytest.mark.parametrize("ext", [".ppm", ".pam", ".pfm", ".sr", ".hdr",
                                 ".webp", ".bmp", ".avif", ".gif"])
def test_every_format_opencv_reads_is_decoded_or_named(ext):
    """OpenCV reads each of these, so the reference's runner would write
    its record: the port must recognize the format (and so stop a run
    naming item 14), never take it for unreadable bytes."""
    import cv2
    import numpy as np

    from jama16_retina_tpu_torch.data import imdecode

    img = (np.arange(24 * 32 * 3) % 251).astype(np.uint8).reshape(24, 32, 3)
    if ext in (".pfm", ".hdr"):
        img = img.astype(np.float32) / 255
    ok, buf = cv2.imencode(ext, img)
    assert ok and cv2.imdecode(buf, cv2.IMREAD_COLOR) is not None
    rgb, why = imdecode.read_image(buf.tobytes())
    assert rgb is None and "item 14" in why
