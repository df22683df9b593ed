"""The port's TFRecord reader, writer and pipeline against the JAX
package's on the CPU: shards written by either side decode identically
through the other, the eval stream is bit for bit the reference's
(tf.data's deterministic interleave over unequal shards), corrupt
records and undecodable JPEG records raise, records of another size are
resized as the reference resizes them, and the port's own train stream
is a pure, resumable function of (files, seed). Images are 32 px to keep
the files small."""

import glob
import os
import shutil

import numpy as np
import pytest
import tensorflow as tf
import torch

from jama16_retina_tpu.data import pipeline as jax_pipeline
from jama16_retina_tpu.data import tfrecord as jax_tfrecord
from jama16_retina_tpu_torch import configs
from jama16_retina_tpu_torch.data import pipeline, tfrecord

SIZE = 32
BATCH = 4


def _relabel(src_dir, split, dst_dir, dst_split, shard, n_shards):
    """Move a one-shard split into shard ``shard`` of ``dst_split``."""
    (src,) = glob.glob(os.path.join(src_dir, f"{split}-*.tfrecord"))
    shutil.move(src, tfrecord.shard_path(dst_dir, dst_split, shard,
                                         n_shards))


@pytest.fixture(scope="module")
def jax_splits(tmp_path_factory):
    """Raw shards written by the JAX writer: ``rr`` round-robins 21
    images into 5 shards (5, 4, 4, 4, 4 records); ``uneven`` has 6
    shards of 1, 6, 0, 2, 5 and 3 records, so files run out at different
    times inside the interleave's cycle of 4."""
    root = tmp_path_factory.mktemp("jax_splits")
    jax_tfrecord.write_synthetic_split(str(root), "rr", 21, SIZE,
                                       num_shards=5, seed=2, encoding="raw")
    lengths = (1, 6, 0, 2, 5, 3)
    scratch = root / "scratch"
    for i, n in enumerate(lengths):
        if n:
            jax_tfrecord.write_synthetic_split(
                str(scratch), f"p{i}", n, SIZE, num_shards=1, seed=10 + i,
                encoding="raw")
            _relabel(str(scratch), f"p{i}", str(root), "uneven", i,
                     len(lengths))
        else:
            open(tfrecord.shard_path(str(root), "uneven", i, len(lengths)),
                 "wb").close()
    return str(root)


@pytest.mark.parametrize("split", ["rr", "uneven"])
def test_eval_batches_match_the_reference_bitwise(jax_splits, split):
    want = list(jax_pipeline.eval_batches(
        jax_splits, split, BATCH, SIZE, process_index=0, process_count=1))
    got = list(pipeline.eval_batches(jax_splits, split, BATCH, SIZE))
    assert len(got) == len(want) > 1
    for g, w in zip(got, want):
        assert set(g) == set(w)
        for k in w:
            assert g[k].dtype == w[k].dtype, k
            np.testing.assert_array_equal(g[k], w[k], err_msg=k)
    assert want[-1]["mask"].sum() < BATCH  # the last batch is padded


def test_interleave_matches_tf_data_order(jax_splits):
    paths = tfrecord.list_split(jax_splits, "uneven")
    ds = tf.data.Dataset.from_tensor_slices(paths).interleave(
        tf.data.TFRecordDataset, cycle_length=min(4, len(paths)),
        num_parallel_calls=tf.data.AUTOTUNE, deterministic=True)
    assert list(pipeline.interleave_records(paths)) == [
        bytes(r) for r in ds.as_numpy_iterator()]


def _tf_decode(paths):
    parse = jax_tfrecord.parse_fn()
    out = []
    for path in paths:
        for serialized in tf.data.TFRecordDataset([path]):
            image, grade, name = parse(serialized)
            out.append((image.numpy(), int(grade), name.numpy()))
    return out


def test_port_written_shards_read_back_through_the_reference(tmp_path):
    paths = tfrecord.write_synthetic_split(str(tmp_path), "train", 7, SIZE,
                                           num_shards=3, seed=5,
                                           encoding="raw")
    assert paths == tfrecord.list_split(str(tmp_path), "train")
    assert tfrecord.count_records(paths) == 7
    got = _tf_decode(paths)
    ours = [tfrecord.parse_record(d) for p in paths
            for d in tfrecord.read_records(p)]
    assert len(got) == len(ours) == 7
    for (image, grade, name), rec in zip(got, ours):
        np.testing.assert_array_equal(image, rec.image)
        assert (grade, name) == (rec.grade, rec.name)
        assert rec.quality == -1.0
    assert tfrecord.read_quality_by_name(paths) == {
        r.name: -1.0 for r in ours}


def test_both_writers_write_the_same_records(tmp_path):
    jax_tfrecord.write_synthetic_split(str(tmp_path / "j"), "val", 6, SIZE,
                                       num_shards=2, seed=3, encoding="raw")
    tfrecord.write_synthetic_split(str(tmp_path / "p"), "val", 6, SIZE,
                                   num_shards=2, seed=3, encoding="raw")
    for jp, pp in zip(tfrecord.list_split(str(tmp_path / "j"), "val"),
                      tfrecord.list_split(str(tmp_path / "p"), "val")):
        for jd, pd in zip(tfrecord.read_records(jp),
                          tfrecord.read_records(pp)):
            assert tfrecord.parse_example(jd) == tfrecord.parse_example(pd)


@pytest.mark.parametrize("n", [0, 1, 9, 4095, 4096, 4097, 70001, 268203])
def test_crc32c_lanes_match_the_byte_loop(n):
    data = np.random.default_rng(n).integers(0, 256, n, np.uint8).tobytes()
    want = tfrecord._crc_bytes(0xFFFFFFFF, data) ^ 0xFFFFFFFF
    assert tfrecord.crc32c(data) == want
    assert tfrecord.crc32c(b"123456789") == 0xE3069283  # the check value


@pytest.mark.parametrize("where,what", [(-7, "data"), (3, "length")])
def test_a_flipped_byte_raises_a_crc_error(tmp_path, where, what):
    (path,) = tfrecord.write_synthetic_split(str(tmp_path), "val", 3, SIZE,
                                             num_shards=1, encoding="raw")
    spans = tfrecord.index_records(path)
    blob = bytearray(open(path, "rb").read())
    # Byte `where` of record 2's data (counted from its end), or of its
    # length field.
    at = (spans[2].offset + spans[2].length + where if where < 0
          else spans[2].offset - 12 + where)
    blob[at] ^= 0x10
    open(path, "wb").write(bytes(blob))
    with pytest.raises(tfrecord.CorruptRecordError,
                       match=rf"val-00000-of-00001.*{what} of record 2"):
        list(tfrecord.read_records(path))


def test_a_truncated_file_raises(tmp_path):
    (path,) = tfrecord.write_synthetic_split(str(tmp_path), "val", 2, SIZE,
                                             num_shards=1, encoding="raw")
    blob = open(path, "rb").read()
    open(path, "wb").write(blob[:-5])
    with pytest.raises(tfrecord.CorruptRecordError, match="record 1"):
        list(tfrecord.read_records(path))


def test_jpeg_records_raise_naming_their_item(tmp_path):
    """JPEG records decode (tests/test_torch_jpeg.py), progressive ones
    too, as TensorFlow decodes them; one the port cannot decode raises
    ``JpegError``, naming item 14 for a recognized format (arithmetic
    coding); the synthetic writer writes JPEG records (the default) or raw
    ones and refuses any other encoding."""
    import cv2

    from jama16_retina_tpu_torch.data import jpeg

    img = np.random.default_rng(0).integers(0, 256, (SIZE, SIZE, 3),
                                            dtype=np.uint8)
    ok, prog = cv2.imencode(".jpg", img, [cv2.IMWRITE_JPEG_PROGRESSIVE, 1])
    ok, base = cv2.imencode(".jpg", img)
    arith = base.tobytes().replace(b"\xff\xc0", b"\xff\xc9", 1)
    exs = [jax_tfrecord.make_example(b"\xff\xd8\xff\xe0not-decoded", 3,
                                     "j0"),
           jax_tfrecord.make_example(prog.tobytes(), 1, "j1"),
           jax_tfrecord.make_example(arith, 2, "j2")]
    jax_tfrecord.write_example_shards(exs, str(tmp_path), "test", 1)
    junk, progressive, arithmetic = tfrecord.read_records(
        tfrecord.list_split(str(tmp_path), "test")[0])
    with pytest.raises(jpeg.JpegError, match="corrupt|truncated"):
        tfrecord.parse_record(junk)
    np.testing.assert_array_equal(
        tfrecord.parse_record(progressive).image,
        tf.io.decode_jpeg(prog.tobytes(), channels=3,
                          dct_method="INTEGER_ACCURATE").numpy())
    with pytest.raises(jpeg.JpegError, match="Queue A item 14"):
        tfrecord.parse_record(arithmetic)
    with pytest.raises(jpeg.JpegError):
        list(pipeline.eval_batches(str(tmp_path), "test", BATCH, SIZE))
    (path,) = tfrecord.write_synthetic_split(str(tmp_path), "x", 1, SIZE,
                                             num_shards=1)
    (record,) = tfrecord.read_records(path)
    assert tfrecord.parse_example(record)["image/encoded"][1][0][:3] == \
        b"\xff\xd8\xff"
    with pytest.raises(ValueError, match="jpeg|raw"):
        tfrecord.write_synthetic_split(str(tmp_path), "y", 1, SIZE,
                                       encoding="png")


def test_records_of_another_size_raise(jax_splits):
    """They no longer raise: a record that is not at the model's size is
    resized as the reference's pipeline resizes it (bilinear, half-pixel
    centres, truncated to uint8), bit for bit, up and down."""
    for size in (SIZE + 1, SIZE - 5):
        want = list(jax_pipeline.eval_batches(
            jax_splits, "rr", BATCH, size, process_index=0, process_count=1))
        got = list(pipeline.eval_batches(jax_splits, "rr", BATCH, size))
        assert len(got) == len(want) > 1
        for g, w in zip(got, want):
            for k in w:
                np.testing.assert_array_equal(g[k], w[k], err_msg=k)


def _names_by_image(data_dir, split):
    return {r.image.tobytes(): r.name for p in tfrecord.list_split(
        data_dir, split) for r in map(tfrecord.parse_record,
                                      tfrecord.read_records(p))}


def _stream(data_dir, split, seed, skip=0, n_batches=12):
    cfg = configs.DataConfig(batch_size=BATCH)
    it = pipeline.train_batches(data_dir, split, cfg, SIZE, seed=seed,
                                skip_batches=skip)
    out = [next(it) for _ in range(n_batches)]
    it.close()
    return out


@pytest.mark.parametrize("split", ["rr", "uneven"])
def test_train_stream_epochs_are_permutations(jax_splits, split):
    by_image = _names_by_image(jax_splits, split)
    n = len(by_image)
    batches = _stream(jax_splits, split, seed=4)
    assert all(b["image"].dtype == torch.uint8
               and tuple(b["image"].shape) == (BATCH, SIZE, SIZE, 3)
               and b["grade"].dtype == torch.int32 for b in batches)
    names = [by_image[img.tobytes()] for b in batches
             for img in b["image"].numpy()]
    epochs = [names[i:i + n] for i in range(0, len(names) - n + 1, n)]
    assert len(epochs) >= 2
    for e in epochs:
        assert sorted(e) == sorted(by_image.values())
    assert epochs[0] != epochs[1]  # reshuffled each epoch


def test_train_stream_is_a_pure_function_of_files_and_seed(jax_splits):
    a, b = _stream(jax_splits, "rr", 7), _stream(jax_splits, "rr", 7)
    c = _stream(jax_splits, "rr", 8)
    for x, y in zip(a, b):
        assert all(np.array_equal(x[k], y[k]) for k in x)
    assert any(not np.array_equal(x["image"], z["image"])
               for x, z in zip(a, c))


@pytest.mark.parametrize("skip", [1, 5, 6])
def test_skip_batches_drops_the_first_batches(jax_splits, skip):
    full = _stream(jax_splits, "uneven", 3, n_batches=10)
    rest = _stream(jax_splits, "uneven", 3, skip=skip, n_batches=10 - skip)
    for x, y in zip(full[skip:], rest):
        assert all(np.array_equal(x[k], y[k]) for k in x)
