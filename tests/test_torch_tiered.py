"""The port's tiered loader (``data/tiered_pipeline.py``) and ingest
autotuner (``data/autotune.py``, the knob polls of
``data/pipeline.DevicePrefetch``) against the JAX
package's on the CPU (a raw split of 48 records at 32 px written by the
JAX writer, batch 8: 6 steps an epoch):

- ``plan_residency``, ``host_spill_plan``, ``host_spill_ids`` and
  ``resolve_stage_depth`` over the reference's boundary cases;
- ``train_batches`` at residency 0, partial (24 rows) and full, across an
  epoch boundary, from step 0 and from a step past it, at 1 and 3 decode
  threads, with the same telemetry (names, help strings, counts);
- a live worker and stage-depth change; ``host_reference_batches`` and
  ``streamed_batches``; a quarantined streamed record under the same
  ``tfrecord.read`` plan;
- ``decide`` over the reference's five rules and seeded stat sequences,
  ``IngestAutotuner``'s telemetry, ``for_config``'s start values;
- the prefetch queues draining and growing with the knob, and an
  autotuned ``fit`` bitwise the hand-set one in losses and AUCs.

Tolerance 0 throughout: record ids, pixels, grades, decisions, counts,
losses and AUCs are compared for equality."""

import dataclasses
import os
import time

import numpy as np
import pytest
import torch

from jama16_retina_tpu import configs as jax_configs
from jama16_retina_tpu.data import autotune as jax_autotune
from jama16_retina_tpu.data import tfrecord as jax_tfrecord
from jama16_retina_tpu.data import tiered_pipeline as jax_tiered
from jama16_retina_tpu.obs import faultinject as jax_faults
from jama16_retina_tpu.obs import registry as jax_registry
from jama16_retina_tpu.obs import trace as jax_trace
from jama16_retina_tpu_torch import configs, trainer
from jama16_retina_tpu_torch.data import autotune, hbm_pipeline, pipeline
from jama16_retina_tpu_torch.data import tiered_pipeline
from jama16_retina_tpu_torch.obs import faultinject
from jama16_retina_tpu_torch.obs import registry as obs_registry
from jama16_retina_tpu_torch.obs import trace as obs_trace
from jama16_retina_tpu_torch.utils.logging import read_jsonl
from torch_parity import one_torch_thread  # noqa: F401 - autouse fixture

SIZE = 32
BATCH = 8
N_TRAIN = 48
STEPS_PER_EPOCH = N_TRAIN // BATCH
ROW = hbm_pipeline.row_bytes(SIZE)
RESIDENCY = {"0pct": 0, "50pct": 24 * ROW, "100pct": 10**9}


@pytest.fixture(scope="module")
def data_dir(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("tiered"))
    jax_tfrecord.write_synthetic_split(root, "train", N_TRAIN, SIZE,
                                       num_shards=3, seed=1, encoding="raw")
    jax_tfrecord.write_synthetic_split(root, "val", 16, SIZE, num_shards=2,
                                       seed=2, encoding="raw")
    return root


@pytest.fixture(autouse=True)
def _fresh_registries():
    regs = obs_registry.Registry(), jax_registry.Registry()
    prev = (obs_registry.set_default_registry(regs[0]),
            jax_registry.set_default_registry(regs[1]))
    yield regs
    obs_registry.set_default_registry(prev[0])
    jax_registry.set_default_registry(prev[1])


def _data_cfgs(*items):
    base = [f"model.image_size={SIZE}", f"data.batch_size={BATCH}",
            f"eval.batch_size={BATCH}", *items]
    return (configs.override(configs.get_config("smoke"), base),
            jax_configs.override(jax_configs.get_config("smoke"), base))


def _equal(got: dict, want: dict) -> None:
    assert got["image"].dtype == torch.uint8
    assert got["grade"].dtype == torch.int32
    np.testing.assert_array_equal(got["image"].numpy(),
                                  np.asarray(want["image"]))
    np.testing.assert_array_equal(got["grade"].numpy(),
                                  np.asarray(want["grade"]))


def test_plans_are_the_reference():
    """The reference's residency boundaries (0 / partial / rounding /
    full / n % B / one streamed slot kept / an oversized batch), its
    spill plans and the stage-depth rule."""
    for args in ((48, 8, 0), (48, 8, 10**6), (48, 8, 24), (48, 8, 23),
                 (50, 8, 10**6), (50, 8, 49), (48, 8, -3), (9, 8, 8)):
        assert tiered_pipeline.plan_residency(*args) == \
            jax_tiered.plan_residency(*args), args
    assert tiered_pipeline.plan_residency(48, 8, 23) == (6, 3, 18)
    for lib in (tiered_pipeline, jax_tiered):
        with pytest.raises(ValueError, match="batch_size"):
            lib.plan_residency(4, 8, 0)
    for n_padded, procs in ((8, 1), (8, 2), (8, 4), (12, 3), (0, 2)):
        assert tiered_pipeline.host_spill_plan(n_padded, procs) == \
            jax_tiered.host_spill_plan(n_padded, procs)
        for p in range(procs):
            for n_res in (n_padded, max(1, n_padded - 3), 0):
                np.testing.assert_array_equal(
                    tiered_pipeline.host_spill_ids(n_res, n_padded, p, procs),
                    jax_tiered.host_spill_ids(n_res, n_padded, p, procs))
    for args in ((7, 2), (8, 0)):
        msgs = []
        for lib in (tiered_pipeline, jax_tiered):
            with pytest.raises(ValueError) as e:
                lib.host_spill_plan(*args)
            msgs.append(str(e.value))
        assert msgs[0] == msgs[1]
    for depth, prefetch in ((0, 0), (0, 1), (0, 5), (3, 7)):
        cfg, jcfg = _data_cfgs(f"data.stage_depth={depth}",
                               f"data.prefetch_batches={prefetch}")
        assert tiered_pipeline.resolve_stage_depth(cfg.data) == \
            jax_tiered.resolve_stage_depth(jcfg.data)


@pytest.mark.parametrize("skip", [0, STEPS_PER_EPOCH + 1])
@pytest.mark.parametrize("residency", sorted(RESIDENCY))
def test_train_batches_are_the_reference(data_dir, residency, skip,
                                         _fresh_registries):
    """Two epochs and two batches of the next from ``skip`` on (1 decode
    thread from step 0, 3 past the boundary), and the loader's metrics:
    the same names, help strings and counts."""
    workers = 1 if skip == 0 else 3
    cfg, jcfg = _data_cfgs(
        f"data.tiered_resident_bytes={RESIDENCY[residency]}",
        f"data.decode_workers={workers}")
    steps = 2 * STEPS_PER_EPOCH + 2
    port = tiered_pipeline.train_batches(data_dir, "train", cfg.data, SIZE,
                                         seed=3, skip_batches=skip,
                                         device="cpu")
    ref = jax_tiered.train_batches(data_dir, "train", jcfg.data, SIZE, seed=3,
                                   skip_batches=skip)
    for _ in range(steps):
        _equal(next(port), next(ref))
    port.close()
    ref.close()
    regs = _fresh_registries
    snaps = [r.snapshot() for r in regs]
    names = [{k for k in s[kind] if k.startswith("data.tiered.")}
             for s in snaps for kind in ("counters", "gauges", "histograms")]
    assert names[:3] == names[3:] and all(names)
    assert snaps[0]["help"] == snaps[1]["help"]
    timed = "data.decode.busy_s"
    assert ({k: v for k, v in snaps[0]["counters"].items() if k != timed}
            == {k: v for k, v in snaps[1]["counters"].items() if k != timed})
    assert snaps[0]["gauges"] == snaps[1]["gauges"]
    hist = "data.tiered.decode_batch_s"
    assert (snaps[0]["histograms"].get(hist, {}).get("count")
            == snaps[1]["histograms"].get(hist, {}).get("count"))


def test_live_knobs_change_no_batch(data_dir, _fresh_registries):
    """A stage-depth raise and a worker resize mid-stream (then a cut):
    the batches stay the reference's, and the gauges show the new
    values."""
    cfg, jcfg = _data_cfgs(f"data.tiered_resident_bytes={24 * ROW}")
    knobs = autotune.Knobs(1, 1, 1)
    port = tiered_pipeline.train_batches(data_dir, "train", cfg.data, SIZE,
                                         seed=4, knobs=knobs, device="cpu")
    ref = jax_tiered.train_batches(data_dir, "train", jcfg.data, SIZE, seed=4)
    reg = _fresh_registries[0]
    for i in range(10):
        if i == 2:
            knobs.set("stage_depth", 4)
            knobs.set("decode_workers", 3)
        if i == 6:
            knobs.set("stage_depth", 1)
        _equal(next(port), next(ref))
        if i == 2:
            assert reg.gauge("data.decode.workers").value == 3
            assert reg.gauge("data.tiered.stage_depth").value == 5
    port.close()
    ref.close()


def test_host_reference_and_streamed_batches_are_the_reference(data_dir):
    """The oracle at partial residency from a skip, and the pure streamed
    tier, bitwise the reference's."""
    cfg, jcfg = _data_cfgs("data.decode_workers=2")
    port = tiered_pipeline.host_reference_batches(
        data_dir, "train", cfg.data, SIZE, seed=5, skip_batches=4,
        capacity_rows=24)
    ref = jax_tiered.host_reference_batches(
        data_dir, "train", jcfg.data, SIZE, seed=5, skip_batches=4,
        capacity_rows=24)
    loader = tiered_pipeline.train_batches(
        data_dir, "train", dataclasses.replace(
            cfg.data, tiered_resident_bytes=24 * ROW), SIZE, seed=5,
        skip_batches=4, device="cpu")
    for _ in range(STEPS_PER_EPOCH):
        got, want = next(port), next(ref)
        for k in ("image", "grade"):
            np.testing.assert_array_equal(got[k], want[k])
        _equal(next(loader), want)
    for it in (port, ref, loader):
        it.close()
    port = tiered_pipeline.streamed_batches(data_dir, "train", cfg.data,
                                            SIZE, seed=6, device="cpu")
    ref = jax_tiered.streamed_batches(data_dir, "train", jcfg.data, SIZE,
                                      seed=6)
    for _ in range(STEPS_PER_EPOCH + 1):
        _equal(next(port), next(ref))
    port.close()
    ref.close()


def test_quarantined_streamed_record_is_the_reference(data_dir,
                                                      _fresh_registries):
    """A ``tfrecord.read`` corrupt plan on call 27 at one decode thread:
    the resident tier takes calls 1-24, so a streamed record is
    quarantined and substituted, in both packages alike."""
    cfg, jcfg = _data_cfgs(f"data.tiered_resident_bytes={24 * ROW}",
                           "data.decode_workers=1")
    plan = {"tfrecord.read": {"kind": "corrupt", "on_calls": [27]}}
    got, want = [], []
    for arm, disarm, lib, c, out, kw in (
            (faultinject.arm, faultinject.disarm, tiered_pipeline, cfg,
             got, {"device": "cpu"}),
            (jax_faults.arm, jax_faults.disarm, jax_tiered, jcfg, want, {})):
        arm(plan)
        try:
            it = lib.train_batches(data_dir, "train", c.data, SIZE, seed=7,
                                   **kw)
            out.extend(next(it) for _ in range(STEPS_PER_EPOCH))
            it.close()
        finally:
            disarm()
    for g, w in zip(got, want):
        _equal(g, w)
    counters = [r.snapshot()["counters"] for r in _fresh_registries]
    for c in counters:
        assert c["data.quarantined"] == 1
        assert c["data.quarantined.decode_error"] == 1
    clean = jax_tiered.train_batches(data_dir, "train", jcfg.data, SIZE,
                                     seed=7)
    assert any(not np.array_equal(np.asarray(next(clean)["image"]),
                                  g["image"].numpy()) for g in got)
    clean.close()


def test_a_mesh_or_processes_are_refused_naming_item_8(data_dir):
    cfg, _ = _data_cfgs()
    with pytest.raises(NotImplementedError, match="Queue A item 8"):
        next(tiered_pipeline.train_batches(data_dir, "train", cfg.data, SIZE,
                                           mesh=object(), device="cpu"))
    with pytest.raises(NotImplementedError, match="Queue A item 8"):
        tiered_pipeline.stage_resident(None, 4, process_count=2,
                                       device="cpu")
    with pytest.raises(NotImplementedError, match="Queue A item 8"):
        autotune.for_config(cfg, mesh=object(), device="cpu")


# ---------------------------------------------------------------- autotune

def _limits(lib, **kw):
    base = dict(max_decode_workers=6, hbm_headroom_bytes=100 * 10**6,
                batch_bytes=10**6)
    base.update(kw)
    return lib.Limits(**base)


def _rule_scenarios():
    """The reference's rule scenarios: (start knobs, limits kwargs,
    windows, wait model, busy model)."""
    hw = jax_autotune.HIGH_WATER
    return {
        "starved_decoder": (
            {"decode_workers": 1, "stage_depth": 2, "prefetch_depth": 2}, {},
            20, lambda k: max(0.0, 0.6 - 0.2 * (k["decode_workers"] - 1)),
            None),
        "idle_decoder": (
            {"decode_workers": 2, "stage_depth": 2, "prefetch_depth": 2}, {},
            8, lambda k: max(0.0, 0.4 - 0.1 * (k["stage_depth"] - 2)),
            lambda k: 0.1),
        "budget_clamp": (
            {"decode_workers": 2, "stage_depth": 8, "prefetch_depth": 4},
            {"hbm_headroom_bytes": 6 * 10**6}, 30, lambda k: 0.5,
            lambda k: 0.2),
        "decay_reverted": (
            {"decode_workers": 2, "stage_depth": 4, "prefetch_depth": 1}, {},
            30, lambda k: 0.0 if k["stage_depth"] >= 4 else 0.5,
            lambda k: 0.1),
        "dead_band": (
            {"decode_workers": 2, "stage_depth": 2, "prefetch_depth": 2}, {},
            10, lambda k: (hw + jax_autotune.LOW_WATER) / 2, None),
    }


def _drive(lib, knobs, limits, windows, wait, busy, spill=1.0):
    state = lib.ControlState()
    seq, states = [], []
    for _ in range(windows):
        w = wait(knobs)
        stats = lib.WindowStats(
            window_sec=1.0, input_wait_frac=w,
            decoder_busy_frac=(busy(knobs) if busy is not None
                               else (0.9 if w > lib.HIGH_WATER else 0.1)),
            spill_frac=spill)
        adjs, state = lib.decide(stats, knobs, limits, state)
        for a in adjs:
            knobs[a.knob] = a.new
            seq.append((a.knob, a.old, a.new, a.reason))
        states.append(dataclasses.asdict(state))
    return seq, states, knobs


@pytest.mark.parametrize("scenario", sorted(_rule_scenarios()))
def test_decide_follows_the_reference_rules(scenario):
    start, lim, windows, wait, busy = _rule_scenarios()[scenario]
    got = _drive(autotune, dict(start), _limits(autotune, **lim), windows,
                 wait, busy)
    want = _drive(jax_autotune, dict(start), _limits(jax_autotune, **lim),
                  windows, wait, busy)
    assert got == want
    assert got[0] or scenario == "dead_band"


@pytest.mark.parametrize("seed", [0, 7, 2024])
def test_decide_is_the_reference_over_seeded_stats(seed):
    """Random windows (short ones included), spill fractions and
    headrooms, 60 windows each: the same adjustments and states."""
    rng = np.random.default_rng(seed)
    for _ in range(4):
        lim = {"hbm_headroom_bytes": int(rng.integers(0, 20)) * 10**6,
               "batch_bytes": int(rng.integers(0, 3)) * 10**6}
        start = {"decode_workers": int(rng.integers(1, 5)),
                 "stage_depth": int(rng.integers(1, 9)),
                 "prefetch_depth": int(rng.integers(1, 6))}
        draws = rng.uniform(0, 1, (60, 4))
        out = []
        for lib in (autotune, jax_autotune):
            knobs, state, seq = dict(start), lib.ControlState(), []
            for sec, wait, busy, spill in draws:
                stats = lib.WindowStats(0.1 * sec, 0.3 * wait, busy,
                                        float(spill))
                adjs, state = lib.decide(stats, knobs, _limits(lib, **lim),
                                         state)
                for a in adjs:
                    knobs[a.knob] = a.new
                seq.append(([dataclasses.astuple(a) for a in adjs],
                            dataclasses.astuple(state)))
            out.append(seq)
        assert out[0] == out[1]
        for s in (0.0, 0.125, 0.5, 1.0):
            assert autotune.staged_cap(_limits(autotune, **lim), s) == \
                jax_autotune.staged_cap(_limits(jax_autotune, **lim), s)


def test_tuner_telemetry_is_the_reference():
    """Two windows of ``observe`` from the same registry deltas: the same
    adjustments, counters, gauges (with help strings) and trace
    instants."""
    out = []
    for lib, reg_lib, trace_lib in (
            (autotune, obs_registry, obs_trace),
            (jax_autotune, jax_registry, jax_trace)):
        reg = reg_lib.Registry()
        tracer = trace_lib.Tracer(enabled=True, buffer_events=64)
        knobs = lib.Knobs(1, 2, 2)
        tuner = lib.IngestAutotuner(knobs, _limits(lib), registry=reg,
                                    tracer=tracer)
        reg.counter("data.decode.busy_s").inc(0.95)
        adjs = [tuner.observe(1.0, 0.5), tuner.observe(1.0, 0.5)]
        snap = reg.snapshot()
        out.append((
            [[dataclasses.astuple(a) for a in a_] for a_ in adjs],
            snap["counters"], snap["gauges"],
            snap["help"],
            [(e["name"], e["ph"], e.get("args")) for e in tracer.events()],
            knobs.as_dict()))
    assert out[0] == out[1]
    assert out[0][0] == [[("decode_workers", 1, 2, "decoder_saturated")],
                         [("stage_depth", 2, 3, "staging_shallow")]]


@pytest.mark.parametrize("items", [
    ("data.decode_workers=3", "data.stage_depth=5",
     "data.prefetch_batches=2", f"data.hbm_budget_bytes={4 * 1024**3}"),
    ("data.prefetch_batches=0",)])
def test_for_config_starts_at_the_reference_values(items):
    cfg, jcfg = _data_cfgs("data.autotune=true", *items)
    got = autotune.for_config(cfg, registry=obs_registry.Registry(),
                              device="cpu")
    want = jax_autotune.for_config(jcfg, registry=jax_registry.Registry())
    assert got[0].as_dict() == want[0].as_dict()
    assert dataclasses.asdict(got[1].limits) == \
        dataclasses.asdict(want[1].limits)


def _wait_for(cond, what: str) -> None:
    t_end = time.monotonic() + 10
    while not cond():
        assert time.monotonic() < t_end, what
        time.sleep(0.005)


def test_prefetch_queues_follow_the_knob():
    """``DevicePrefetch``: the queue deepens after a raise (its ring
    grows) and drains after a cut, and every batch comes out once, in
    order."""
    knobs = autotune.Knobs(1, 1, 3)
    pulled = []

    def source():
        for i in range(24):
            pulled.append(i)
            yield {"i": np.asarray(i)}

    it = pipeline.DevicePrefetch(source(), "cpu", size=99, knobs=knobs)
    out = [int(next(it)["i"])]
    _wait_for(lambda: len(it._ready) == 3, "no queue of 3")
    knobs.set("prefetch_depth", 1)
    out += [int(next(it)["i"]) for _ in range(3)]
    _wait_for(lambda: len(it._ready) == 1, "no drain to 1")
    time.sleep(0.05)
    assert len(it._ready) == 1 and len(pulled) == len(out) + 1
    knobs.set("prefetch_depth", 5)
    out.append(int(next(it)["i"]))
    _wait_for(lambda: len(it._ready) == 5, "no queue of 5")
    assert len(it._ring._slots) == 6
    out += [int(b["i"]) for b in it]
    assert out == list(range(24))
    it.close()



@pytest.mark.parametrize("loader", ["tiered", "tfdata"])
def test_autotuned_fit_is_bitwise_the_hand_set_fit(data_dir, tmp_path,
                                                   loader):
    """A fit from pessimal knobs (1 thread, depth 1, prefetch 1), the
    tiered loader at partial residency with evals from the val cache, or
    the TFRecord stream through ``DevicePrefetch``; 8 steps, evals at 4
    and 8: with ``data.autotune=true`` its losses and AUCs are the
    hand-set run's."""
    cfg, _ = _data_cfgs(
        f"data.loader={loader}", "train.steps=8", "train.eval_every=4",
        "train.log_every=2", "train.lr_schedule=constant",
        "data.decode_workers=1", "data.stage_depth=1",
        "data.prefetch_batches=1", f"data.tiered_resident_bytes={24 * ROW}")

    def run(c, name):
        wd = str(tmp_path / name)
        trainer.fit(c, data_dir, wd, seed=5, device="cpu")
        recs = read_jsonl(os.path.join(wd, "metrics.jsonl"))
        return ({r["step"]: r["loss"] for r in recs if r["kind"] == "train"},
                {r["step"]: r["val_auc"] for r in recs
                 if r["kind"] == "eval"})

    loss_a, auc_a = run(cfg, "handset")
    tuned = configs.override(cfg, ["data.autotune=true"])
    loss_b, auc_b = run(tuned, "tuned")
    assert sorted(loss_a) == [2, 4, 6, 8] and sorted(auc_a) == [4, 8]
    assert (loss_a, auc_a) == (loss_b, auc_b)
    gauges = obs_registry.default_registry().snapshot()["gauges"]
    assert {f"data.autotune.{k}" for k in autotune.Knobs.FIELDS} <= set(
        gauges)
