"""Fault injection and bounded retries of the port (``obs/faultinject.py``,
``utils/retry.py`` and the seams that fire them) against the JAX package
on the CPU, mirroring ``tests/test_faults.py`` where the port has the
code: the plan machinery (``:59``-``:153``), the retry (``:165``-``:204``),
the transient TFRecord read (``:282``), the restore retry and the corrupt
checkpoint (``:369``, ``:392``), the batcher's window fault (``:476``), the
``trainer.step`` blackbox (``:884``), ``predict --max_retries`` (``:1004``)
and the kill -9 drill of an in-flight async save (``:1055``).

Each package is armed and disarmed through its own ``faultinject``; the
same plan goes to both, and the outcomes (rows, counters, ledgers,
blackboxes, exceptions) are held equal. The one stated difference: at
``data.readers`` >= 2 the ``tfrecord.read`` ordinals count per reader
process (ROADMAP Queue C). Small shapes (``smoke``: tiny_cnn at 32 px),
torch on one thread.
"""

import dataclasses
import gc
import json
import os
import shutil
import signal
import subprocess
import sys
import time

import jax
import numpy as np
import pytest
import torch

from jama16_retina_tpu import configs as jax_configs
from jama16_retina_tpu import models as jax_models
from jama16_retina_tpu import train_lib as jax_train_lib
from jama16_retina_tpu import trainer as jax_trainer
from jama16_retina_tpu.obs import faultinject as jax_fi
from jama16_retina_tpu.obs import registry as jax_registry
from jama16_retina_tpu.obs import trace as jax_trace
from jama16_retina_tpu.serve import batcher as jax_batcher
from jama16_retina_tpu.serve import engine as jax_engine
from jama16_retina_tpu.serve import host as jax_host
from jama16_retina_tpu.serve import policy as jax_policy
from jama16_retina_tpu.utils import checkpoint as jax_ckpt
from jama16_retina_tpu.utils import retry as jax_retry
from jama16_retina_tpu_torch import configs, models, predict, trainer
from jama16_retina_tpu_torch import train_lib
from jama16_retina_tpu_torch.data import pipeline, tfrecord
from jama16_retina_tpu_torch.data import readers as readers_lib
from jama16_retina_tpu_torch.models import convert
from jama16_retina_tpu_torch.obs import alerts as obs_alerts
from jama16_retina_tpu_torch.obs import export as obs_export
from jama16_retina_tpu_torch.obs import faultinject as fi
from jama16_retina_tpu_torch.obs import registry as obs_registry
from jama16_retina_tpu_torch.obs import trace as obs_trace
from jama16_retina_tpu_torch.serve import batcher, host
from jama16_retina_tpu_torch.serve import policy as policy_lib
from jama16_retina_tpu_torch.serve.engine import ServingEngine
from jama16_retina_tpu_torch.utils import checkpoint as ckpt_lib
from jama16_retina_tpu_torch.utils import retry
from jama16_retina_tpu_torch.utils.logging import read_jsonl
from torch_parity import one_torch_thread  # noqa: F401 - autouse fixture
from torch_parity import random_flat, stacked_state

SIZE = 32
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# The two packages' (faultinject, retry, Registry module) by name.
PKGS = {"port": (fi, retry, obs_registry),
        "jax": (jax_fi, jax_retry, jax_registry)}


@pytest.fixture(autouse=True)
def _disarmed():
    """No plan outlives its test, in either package, and no test leaves
    the variable set."""
    yield
    fi.disarm()
    jax_fi.disarm()
    assert fi.ENV_VAR not in os.environ


class _Registries:
    """Fresh default registries in both packages inside the block (the
    retry counters go to the default one)."""

    def __enter__(self):
        self.port, self.jax = obs_registry.Registry(), jax_registry.Registry()
        self._prev = (obs_registry.set_default_registry(self.port),
                      jax_registry.set_default_registry(self.jax))
        return self

    def __exit__(self, *exc):
        obs_registry.set_default_registry(self._prev[0])
        jax_registry.set_default_registry(self._prev[1])


def _counter(reg, name):
    return reg.snapshot()["counters"].get(name, 0)


# ---------------------------------------------------------------------------
# FaultPlan: specs, validation, fire sequences, damage
# ---------------------------------------------------------------------------

GOOD_SPECS = {
    "corrupt": {"tfrecord.read": {"kind": "corrupt", "on_calls": [3]}},
    "error": {"ckpt.restore": {"kind": "error", "error": "OSError",
                               "on_calls": [1, 2]}},
    "mixed": {"host.decode": {"kind": "latency", "on_calls": [1, 2],
                              "delay_s": 0.05},
              "trainer.step": {"every": 2, "max_fires": 3,
                               "message": "chaos"}},
}
BAD_SPECS = {
    "unknown_key": {"x": {"kind": "error", "bogus": 1}},
    "unknown_kind": {"x": {"kind": "explode"}},
    "unknown_error": {"x": {"error": "SystemExit"}},
    "typo_site": {"trainer.stpe": {"kind": "error"}},
    "unknown_site": {"nonsense.site": {"kind": "error"}},
    "not_an_object": [1, 2],
}


def _sites(plan):
    return {n: dataclasses.asdict(s) for n, s in plan.sites.items()}


@pytest.mark.parametrize("form", ["dict", "text", "file"])
@pytest.mark.parametrize("name", list(GOOD_SPECS))
def test_spec_parses_as_the_jax_package_parses_it(tmp_path, name, form):
    spec = GOOD_SPECS[name]
    if form == "text":
        spec = json.dumps(spec)
    elif form == "file":
        path = tmp_path / "plan.json"
        path.write_text(json.dumps(spec))
        spec = str(path)
    assert _sites(fi.plan_from_spec(spec)) == _sites(
        jax_fi.plan_from_spec(spec))
    plan = fi.plan_from_spec(spec)
    assert _sites(fi.plan_from_spec(plan.spec())) == _sites(plan)


@pytest.mark.parametrize("as_text", [False, True])
@pytest.mark.parametrize("name", list(BAD_SPECS))
def test_bad_spec_raises_the_jax_value_error(name, as_text):
    spec = BAD_SPECS[name]
    if as_text:
        spec = json.dumps(spec)
    errs = []
    for mod in (fi, jax_fi):
        with pytest.raises(ValueError) as e:
            mod.plan_from_spec(spec)
        errs.append(str(e.value))
    assert errs[0] == errs[1]
    if name == "typo_site":
        assert "did you mean 'trainer.step'" in errs[0]


def test_arm_validates_a_built_plan_and_arms_every_fired_site():
    """``:80``: arm refuses an undeclared site in a built plan and leaves
    nothing armed; every site the port fires arms (in both packages)."""
    for mod in (fi, jax_fi):
        plan = mod.plan_from_spec({"bogus.seam": {"kind": "error"}},
                                  allow_unknown=True)
        with pytest.raises(ValueError, match="bogus.seam"):
            mod.arm(plan)
        assert mod.active_plan() is None
        mod.arm({s: {"kind": "error", "on_calls": [1]}
                 for s in fi.PORT_SITES})
        assert set(mod.active_plan().sites) == set(fi.PORT_SITES)
        mod.disarm()


@pytest.mark.parametrize("site", sorted(fi.UNFIRED))
def test_a_site_the_port_does_not_fire_is_refused_naming_its_item(site):
    """The reference arms it; the port, which has no seam for it yet,
    refuses with NotImplementedError naming its ROADMAP item, from a
    spec, a built plan, or a plan that adds it to fired sites."""
    jax_fi.arm({site: {"kind": "error"}})
    assert set(jax_fi.active_plan().sites) == {site}
    for plan in ({site: {"kind": "error"}},
                 fi.plan_from_spec({site: {"kind": "error"},
                                    "trainer.step": {"kind": "error"}})):
        with pytest.raises(NotImplementedError,
                           match=r"ROADMAP\.md Queue A item (9|11)"):
            fi.arm(plan)
        assert fi.active_plan() is None


MODES = {
    "on_calls": {"kind": "error", "on_calls": [2, 4], "error": "ValueError"},
    "every": {"kind": "error", "every": 3},
    "every_max_fires": {"kind": "error", "every": 2, "max_fires": 2},
    "on_calls_max_fires": {"on_calls": [1, 5, 9, 13], "max_fires": 3,
                           "error": "OSError", "message": "flap"},
    "on_calls_and_every": {"on_calls": [1], "every": 7,
                           "error": "TimeoutError"},
    "latency": {"kind": "latency", "every": 4, "delay_s": 0.0},
    "corrupt_kind_at_check": {"kind": "corrupt", "on_calls": [3]},
}


def _sequence(mod, entry, hook):
    """Outcomes of 20 seam calls under ``entry`` and the plan's counts."""
    plan = mod.plan_from_spec({"s": entry}, allow_unknown=True)
    mod.arm(plan, allow_unknown=True)
    out = []
    for _ in range(20):
        try:
            if hook == "check":
                mod.check("s")
                out.append("ok")
            else:
                out.append(mod.corrupt("s", b"payload bytes").hex())
        except Exception as e:  # noqa: BLE001 - compared across packages
            out.append(f"{type(e).__name__}: {e}")
    mod.disarm()
    return out, plan.counts()


@pytest.mark.parametrize("hook", ["check", "corrupt"])
@pytest.mark.parametrize("mode", list(MODES))
def test_fire_sequence_over_20_calls_equals_the_jax_plan(mode, hook):
    """``:102``, ``:124``: the same plan fires at the same ordinals, with
    the same exceptions and counts, run after run."""
    got = _sequence(fi, MODES[mode], hook)
    assert got == _sequence(jax_fi, MODES[mode], hook)
    assert got == _sequence(fi, MODES[mode], hook)


PAYLOADS = {"empty": b"", "one": b"x", "text": b"hello world payload",
            "random": np.random.default_rng(5).integers(
                0, 256, 1001, np.uint8).tobytes()}


@pytest.mark.parametrize("payload", list(PAYLOADS))
@pytest.mark.parametrize("kind", ["corrupt", "torn", "bitflip", "truncate"])
def test_damage_is_bitwise_the_jax_damage(kind, payload):
    """``:139``: each corrupt-family kind damages the bytes as the
    reference does, through ``corrupt`` on its firing call only."""
    data = PAYLOADS[payload]
    assert fi._damage(kind, data) == jax_fi._damage(kind, data)
    for mod in (fi, jax_fi):
        mod.arm({"s": {"kind": kind, "on_calls": [2]}}, allow_unknown=True)
        assert mod.corrupt("s", data) == data
        assert mod.corrupt("s", data) == jax_fi._damage(kind, data)
        assert mod.corrupt("s", data) == data
        mod.disarm()
    if len(data) > 1:  # one byte: a prefix of at least one byte is all
        assert fi._damage(kind, data) != data


def test_unarmed_check_is_a_no_op_and_an_unlisted_site_is_inert():
    """``:153``."""
    for mod in (fi, jax_fi):
        mod.disarm()
        mod.check("anything")
        assert mod.corrupt("anything", b"ab") == b"ab"
        mod.arm({"s": {"kind": "error"}}, allow_unknown=True)
        mod.check("other.site")


ENV_CASES = {
    "env_wins": (True, True, False, "ckpt.save"),
    "config_when_no_env": (False, True, False, "trainer.step"),
    "env_over_armed": (True, False, True, "ckpt.save"),
    "config_over_armed": (False, True, True, "trainer.step"),
    "neither_leaves_armed": (False, False, True, "host.decode"),
    "neither_nothing_armed": (False, False, False, None),
}


@pytest.mark.parametrize("case", list(ENV_CASES))
def test_arm_from_env_or_config_precedence_equals_the_jax_rule(
        case, monkeypatch):
    env, config, armed, want = ENV_CASES[case]
    got = []
    for mod in (fi, jax_fi):
        mod.disarm()
        if armed:
            mod.arm({"host.decode": {"kind": "error"}})
        with monkeypatch.context() as m:
            if env:
                m.setenv(mod.ENV_VAR, json.dumps({"ckpt.save": {}}))
            else:
                m.delenv(mod.ENV_VAR, raising=False)
            mod.arm_from_env_or_config(
                json.dumps({"trainer.step": {}}) if config else "")
        plan = mod.active_plan()
        got.append(sorted(plan.sites) if plan is not None else None)
        mod.disarm()
    assert got[0] == got[1] == ([want] if want else None)


# ---------------------------------------------------------------------------
# utils/retry.py
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("args", [(5, 0.5, 1.0), (1, 0.05, 2.0),
                                  (4, 0.05, 2.0), (0, 1.0, 1.0),
                                  (7, 0.3, 5.0)])
def test_backoff_delays_equal_the_jax_schedule(args):
    """``:204``."""
    assert list(retry.backoff_delays(*args)) == list(
        jax_retry.backoff_delays(*args))


def _retry_run(pkg, failures, attempts, exc):
    mod_fi, mod_retry, mod_reg = PKGS[pkg]
    calls, slept = [0], []

    def flaky():
        calls[0] += 1
        if calls[0] <= failures:
            raise exc(f"flap {calls[0]}")
        return "ok"

    reg = mod_reg.Registry()
    try:
        out = mod_retry.retry_call(flaky, attempts=attempts,
                                   sleep=slept.append, site="t",
                                   registry=reg)
    except Exception as e:  # noqa: BLE001 - compared across packages
        out = f"{type(e).__name__}: {e}"
    counters = {k: v for k, v in reg.snapshot()["counters"].items()}
    return out, calls[0], slept, counters


@pytest.mark.parametrize("exc", [OSError, TimeoutError, ValueError])
@pytest.mark.parametrize("failures", [0, 1, 2, 3])
def test_retry_schedule_exhaustion_and_pass_through_equal_the_jax_retry(
        failures, exc):
    """``:165``, ``:192``: the sleeps, the counters, the re-raised
    original on exhaustion and the non-transient error passed through on
    its first raise."""
    got = _retry_run("port", failures, 3, exc)
    assert got == _retry_run("jax", failures, 3, exc)
    if failures and exc is ValueError:
        assert got[1] == 1 and got[2] == []
    if failures == 2 and exc is OSError:
        assert got[0] == "ok" and got[2] == [0.05, 0.1]
        assert got[3] == {"io.retries": 2, "io.retries.t": 2}


def test_retry_refuses_zero_attempts_as_the_jax_retry():
    errs = []
    for mod in (retry, jax_retry):
        with pytest.raises(ValueError) as e:
            mod.retry_call(lambda: 1, attempts=0)
        errs.append(str(e.value))
    assert errs[0] == errs[1]


# ---------------------------------------------------------------------------
# tfrecord.read: the train stream's readers
# ---------------------------------------------------------------------------

RECORDS = 16
BATCH = 4


@pytest.fixture(scope="module")
def split(tmp_path_factory):
    """16 raw 32 px train records in 2 shards (the port's writer)."""
    root = str(tmp_path_factory.mktemp("fault_split"))
    tfrecord.write_synthetic_split(root, "train", RECORDS, SIZE,
                                   num_shards=2, seed=1, encoding="raw")
    tfrecord.write_synthetic_split(root, "val", 8, SIZE, num_shards=1,
                                   seed=2, encoding="raw")
    return root


def _stream(root, readers, n):
    it = pipeline.train_batches(root, "train",
                                configs.DataConfig(batch_size=BATCH), SIZE,
                                seed=3, readers=readers)
    try:
        return [next(it) for _ in range(n)]
    finally:
        it.close()


def _jax_decode(root, plan):
    from jama16_retina_tpu.data.grain_pipeline import (ParallelDecoder,
                                                       TFRecordIndex)

    index = TFRecordIndex(tfrecord.list_split(root, "train"))
    with _Registries() as regs:
        if plan is not None:
            jax_fi.arm(plan)
        dec = ParallelDecoder(index, SIZE, workers=1, registry=regs.jax)
        batch = dec.decode_batch(range(RECORDS))
        dec.close()
        counts = (jax_fi.active_plan().counts()
                  if plan is not None else None)
        jax_fi.disarm()
    return batch["image"], regs.jax, counts


TRANSIENT = {"tfrecord.read": {"kind": "error", "error": "OSError",
                               "on_calls": [3], "message": "flap"}}


@pytest.mark.parametrize("readers", [1, 2])
def test_transient_read_is_retried_then_bitwise_in_the_trainer_registry(
        split, readers):
    """``:282``: an injected transient OSError on a record read is
    absorbed by the bounded retry in the reader process; the stream is
    bitwise the unarmed one, and the retry and the plan's fire reach this
    process's registry and plan. At one reader the counts equal the
    reference's over the same records (16 reads, the 3rd fails once); at
    two the ordinals count per reader, so each reader that read 3 records
    fired once (ROADMAP Queue C), and the registry holds every fire."""
    n = RECORDS // BATCH
    clean = _stream(split, readers, n)
    with _Registries() as regs:
        plan = fi.plan_from_spec(TRANSIENT)
        fi.arm(plan)
        got = _stream(split, readers, n)
        fi.disarm()
    for g, w in zip(got, clean, strict=True):
        assert all(torch.equal(g[k], w[k]) for k in w)
    fires = plan.counts()["tfrecord.read"]["fires"]
    assert plan.counts()["tfrecord.read"]["calls"] == RECORDS + fires
    assert _counter(regs.port, "io.retries.tfrecord.read") == fires
    assert _counter(regs.port, "io.retries") == fires
    want_images, jreg, jcounts = _jax_decode(split, TRANSIENT)
    clean_images, _, _ = _jax_decode(split, None)
    np.testing.assert_array_equal(want_images, clean_images)
    assert jcounts == {"tfrecord.read": {"calls": RECORDS + 1, "fires": 1}}
    assert jreg.counter("io.retries.tfrecord.read").value == 1
    if readers == 1:
        assert plan.counts() == jcounts
    else:
        assert 1 <= fires <= readers


def test_a_reader_counts_ordinals_from_its_own_copy_of_the_plan(split):
    """The parity gap, pinned without a second process: a reader arms a
    fresh copy of the plan's spec (``readers.init``), so its call 3 fires
    whatever the trainer's plan had counted, and ``read_into`` reports
    what the batch added."""
    from multiprocessing import shared_memory

    order = readers_lib.TrainOrder(split, "train", BATCH, SIZE, seed=3)
    plan = fi.plan_from_spec(TRANSIENT)
    fi.arm(plan)
    with plan._lock:  # the trainer's plan has counted 10 calls already
        plan.sites["tfrecord.read"].calls = 10
    shm = shared_memory.SharedMemory(
        create=True, size=readers_lib.slot_bytes(1, order.shape()))
    try:
        with _Registries():
            readers_lib.init(order, shm.name, 1, plan.spec())
            try:
                first = readers_lib.read_into(0, 0)
                second = readers_lib.read_into(1, 0)
            finally:
                r = readers_lib._READER
                for f in r.pop("files"):
                    f.close()
                del r["images"], r["grades"]
                gc.collect()  # the views' last references
                r.pop("shm").close()
                r.clear()
    finally:
        shm.close()
        shm.unlink()
    assert first == (0, {"retries": {"io.retries": 1,
                                     "io.retries.tfrecord.read": 1},
                         "faults": {"tfrecord.read": {"calls": 5,
                                                     "fires": 1}}})
    assert second == (0, {"retries": {},
                          "faults": {"tfrecord.read": {"calls": 4,
                                                       "fires": 0}}})
    assert plan.counts()["tfrecord.read"] == {"calls": 10, "fires": 0}


def test_a_damaged_record_raises_at_its_batch_and_a_late_plan_refuses(
        split):
    """A corrupt-family plan damages the payload, whose CRC then fails:
    ``CorruptRecordError`` at the batch, never retried. A plan armed while
    the stream runs cannot reach its readers: the next batch raises."""
    fi.arm({"tfrecord.read": {"kind": "corrupt", "on_calls": [6]}})
    it = pipeline.train_batches(split, "train",
                                configs.DataConfig(batch_size=BATCH), SIZE,
                                seed=3, readers=1)
    try:
        next(it)
        with pytest.raises(tfrecord.CorruptRecordError, match="CRC"):
            next(it)
    finally:
        it.close()
    fi.disarm()
    it = pipeline.train_batches(split, "train",
                                configs.DataConfig(batch_size=BATCH), SIZE,
                                seed=3, readers=1)
    try:
        next(it)
        fi.arm({"tfrecord.read": {"kind": "error", "on_calls": [1]}})
        with pytest.raises(RuntimeError, match="fault plan changed"):
            next(it)
    finally:
        it.close()


def test_count_records_retries_a_transient_error(split, monkeypatch):
    real, calls = tfrecord.index_records, [0]

    def flaky(path):
        calls[0] += 1
        if calls[0] == 2:
            raise OSError("flap")
        return real(path)

    monkeypatch.setattr(tfrecord, "index_records", flaky)
    with _Registries() as regs:
        n = tfrecord.count_records(tfrecord.list_split(split, "train"))
    assert n == RECORDS
    assert _counter(regs.port, "io.retries.tfrecord.count") == 1


# ---------------------------------------------------------------------------
# ckpt.restore / ckpt.save
# ---------------------------------------------------------------------------


def _smoke_cfgs(*items):
    base = [f"model.image_size={SIZE}", *items]
    return (jax_configs.override(jax_configs.get_config("smoke"), base),
            configs.override(configs.get_config("smoke"), base))


@pytest.fixture(scope="module")
def checkpoints(tmp_path_factory):
    """One step-1 checkpoint per package of one smoke state: JAX (orbax)
    and the port's (``state.npz``)."""
    jcfg, pcfg = _smoke_cfgs()
    jmodel = jax_models.build(jcfg.model)
    root = tmp_path_factory.mktemp("ckpts")
    jstate, _ = jax_train_lib.create_state(jcfg, jmodel, jax.random.key(0))
    jdir = str(root / "jax" / "member_00")
    ck = jax_ckpt.Checkpointer(jdir)
    ck.save(1, jax.device_get(jstate), {"val_auc": 0.5})
    ck.wait()
    ck.close()
    pstate = train_lib.create_state(pcfg, models.build(pcfg.model), "cpu")
    pdir = str(root / "port" / "member_00")
    ckpt_lib.Checkpointer(pdir).save(1, train_lib.state_to_flat(pstate),
                                     {"val_auc": 0.5})
    return {"jcfg": jcfg, "jmodel": jmodel, "jdir": jdir, "pcfg": pcfg,
            "pdir": pdir}


RESTORE_PLANS = {
    "once": ({"kind": "error", "error": "OSError", "on_calls": [1]}, 1),
    "twice": ({"kind": "error", "error": "OSError", "on_calls": [1, 2]}, 2),
    "exhausted": ({"kind": "error", "error": "OSError",
                   "on_calls": [1, 2, 3]}, 2),
    "not_transient": ({"kind": "error", "error": "ValueError",
                       "on_calls": [1]}, 0),
    "latency": ({"kind": "latency", "on_calls": [1], "delay_s": 0.01}, 0),
}


def _restore(pkg, ck, plan):
    with _Registries() as regs:
        mod = fi if pkg == "port" else jax_fi
        mod.arm({"ckpt.restore": plan})
        try:
            if pkg == "port":
                state = ckpt_lib.Checkpointer(ck["pdir"]).restore(1)
                ok = bool(state)
            else:
                state = jax_trainer.restore_for_eval(ck["jcfg"], ck["jmodel"],
                                                     ck["jdir"])
                ok = state.params is not None
            out = ("ok", ok)
        except Exception as e:  # noqa: BLE001 - compared across packages
            out = (type(e).__name__, str(e).replace(
                repr(ck["pdir"] if pkg == "port" else ck["jdir"]), "<dir>"))
        counts = mod.active_plan().counts()
        mod.disarm()
        reg = regs.port if pkg == "port" else regs.jax
        return out, counts, _counter(reg, "io.retries.ckpt.restore")


@pytest.mark.parametrize("name", list(RESTORE_PLANS))
def test_restore_retry_and_its_error_equal_the_jax_checkpointer(
        checkpoints, name):
    """``:392``: a transient restore error is retried (``io.retries.
    ckpt.restore``); retries exhausted, or a non-transient error, raise
    ``CheckpointError`` naming the directory and the step, in the
    reference's words."""
    plan, retries = RESTORE_PLANS[name]
    got = _restore("port", checkpoints, plan)
    want = _restore("jax", checkpoints, plan)
    assert got == want
    assert got[2] == retries
    if name in ("exhausted", "not_transient"):
        assert got[0][0] == "CheckpointError" and "step 1" in got[0][1]


def _truncate_payloads(d):
    victims = []
    for dirpath, _, names in os.walk(d):
        for n in names:
            path = os.path.join(dirpath, n)
            if os.path.getsize(path) > 64 and "_METADATA" not in path \
                    and not n.endswith(".json"):
                with open(path, "r+b") as f:
                    f.truncate(16)
                victims.append(path)
    assert victims
    return d


def test_a_truncated_checkpoint_raises_an_actionable_error_as_the_jax_one(
        checkpoints, tmp_path):
    """``:369``: both packages name the member dir, the step and the
    likely cause; so does the port's resume of a state missing a leaf."""
    msgs = []
    for pkg, src in (("port", checkpoints["pdir"]),
                     ("jax", checkpoints["jdir"])):
        broken = str(tmp_path / pkg / "member_broken")
        shutil.copytree(src, broken)
        _truncate_payloads(broken)
        with pytest.raises(Exception) as e:
            if pkg == "port":
                ckpt_lib.Checkpointer(broken).restore(1)
            else:
                jax_trainer.restore_for_eval(checkpoints["jcfg"],
                                             checkpoints["jmodel"], broken)
        assert type(e.value).__name__ == "CheckpointError"
        msgs.append(str(e.value))
    for m in msgs:
        assert "member_broken" in m and "step 1" in m
        assert "truncated/corrupted" in m
    pcfg = checkpoints["pcfg"]
    ck = ckpt_lib.Checkpointer(checkpoints["pdir"])
    flat = ck.restore(1)
    gone = next(k for k in flat if k.startswith("params/"))
    leafless = ckpt_lib.Checkpointer(str(tmp_path / "leafless"))
    leafless.save(1, {k: v for k, v in flat.items() if k != gone},
                  {"val_auc": 0.5})
    state = train_lib.create_state(pcfg, models.build(pcfg.model), "cpu")
    with pytest.raises(ckpt_lib.CheckpointError,
                       match=r"step 1 under .*leafless.*truncated/corrupted"):
        trainer._load_restored(state, leafless, 1)


@pytest.mark.parametrize("which", ["save", "save_latest"])
def test_an_injected_save_error_writes_nothing_as_in_the_jax_checkpointer(
        checkpoints, tmp_path, which):
    """``ckpt.save`` fires before the write, on the calling thread: the
    error reaches the caller and no step is left behind."""
    jcfg = checkpoints["jcfg"]
    jstate, _ = jax_train_lib.create_state(jcfg, checkpoints["jmodel"],
                                           jax.random.key(0))
    flat = ckpt_lib.Checkpointer(checkpoints["pdir"]).restore(1)
    plan = {"ckpt.save": {"kind": "error", "error": "OSError",
                          "on_calls": [1], "message": "disk full"}}
    got = []
    for pkg in ("port", "jax"):
        mod = fi if pkg == "port" else jax_fi
        d = str(tmp_path / pkg)
        ck = (ckpt_lib.Checkpointer(d) if pkg == "port"
              else jax_ckpt.Checkpointer(d))
        state = flat if pkg == "port" else jax.device_get(jstate)
        mod.arm(plan)
        with pytest.raises(OSError) as e:
            if which == "save":
                ck.save(2, state, {"val_auc": 0.5})
            else:
                ck.save_latest(2, state)
        got.append((str(e.value), ck.latest_step, mod.active_plan().counts()))
        mod.disarm()
        if pkg == "jax":
            ck.close()
    assert got[0] == got[1] == ("disk full (injected, call 1)", None,
                                {"ckpt.save": {"calls": 1, "fires": 1}})


# ---------------------------------------------------------------------------
# engine.dispatch under the micro-batcher
# ---------------------------------------------------------------------------

DISPATCH = {"engine.dispatch": {"kind": "error", "error": "RuntimeError",
                                "on_calls": [2], "message": "chaos"}}


def _sums(rows):
    return rows.reshape(rows.shape[0], -1).astype(np.float64).sum(axis=1)


def _window_drill(pkg):
    """``:476`` as written: the fault reaches exactly its window's futures,
    the worker survives, ``serve.batcher.window_errors`` counts it."""
    mod_fi, _, mod_reg = PKGS[pkg]
    lib = batcher if pkg == "port" else jax_batcher
    reg = mod_reg.Registry()

    def infer(rows):
        mod_fi.check("engine.dispatch")
        return _sums(rows)

    mod_fi.arm(DISPATCH)
    out = []
    with lib.MicroBatcher(infer, max_batch=4, max_wait_ms=1.0,
                          registry=reg) as b:
        for v in (1.0, 2.0, 3.0):
            f = b.submit(np.full((1, 4), v))
            try:
                out.append(f.result(timeout=30).tolist())
            except RuntimeError as e:
                out.append(str(e))
    counts = mod_fi.active_plan().counts()
    mod_fi.disarm()
    return out, counts, reg.counter("serve.batcher.window_errors").value


def test_an_injected_dispatch_fails_one_window_and_the_worker_survives():
    got = _window_drill("port")
    assert got == _window_drill("jax")
    assert got[0] == [[4.0], "chaos (injected, call 2)", [12.0]]
    assert got[2] == 1


@pytest.fixture(scope="module")
def engines():
    """One random tiny_cnn member as a JAX engine and a port engine
    (float32, one bucket of 4, converted weights)."""
    items = [f"model.image_size={SIZE}", "model.compute_dtype=float32",
             "serve.max_batch=4", "serve.bucket_sizes=4"]
    jcfg, pcfg = _smoke_cfgs(*items[1:])
    jmodel = jax_models.build(jcfg.model)
    flat = random_flat(jmodel, (2, SIZE, SIZE, 3), seed=7)
    jeng = jax_engine.ServingEngine(jcfg, model=jmodel,
                                    state=stacked_state([flat]),
                                    registry=jax_registry.Registry())
    peng = ServingEngine(pcfg, state_dicts=[convert.flax_to_torch(
        flat, models.build(pcfg.model))], device="cpu",
        registry=obs_registry.Registry())
    images = np.random.default_rng(8).integers(0, 256, (10, SIZE, SIZE, 3),
                                               np.uint8)
    return jeng, peng, images


def _engine_drill(mod, eng, images):
    """Three requests of 3, 6 (two chunks) and 1 rows under DISPATCH:
    (outcome per request, plan counts)."""
    mod.arm(DISPATCH)
    out = []
    for lo, hi in ((0, 3), (3, 9), (9, 10)):
        try:
            out.append(np.asarray(eng.probs(images[lo:hi])))
        except RuntimeError as e:
            out.append(str(e))
    counts = mod.active_plan().counts()
    mod.disarm()
    return out, counts


def test_engine_dispatch_fails_its_request_as_the_jax_engine(engines):
    """The seam once a chunk: the second chunk (the 6-row request's first)
    fails that request only; the others score within 1e-5 of the JAX
    engine, and bitwise the port engine unarmed."""
    jeng, peng, images = engines
    got, counts = _engine_drill(fi, peng, images)
    want, jcounts = _engine_drill(jax_fi, jeng, images)
    assert counts == jcounts == {"engine.dispatch": {"calls": 3,
                                                     "fires": 1}}
    assert got[1] == want[1] == "chaos (injected, call 2)"
    for g, w, (lo, hi) in zip((got[0], got[2]), (want[0], want[2]),
                              ((0, 3), (9, 10))):
        np.testing.assert_allclose(g, w, rtol=0, atol=1e-5)
        np.testing.assert_array_equal(g, peng.probs(images[lo:hi]))


def test_engine_batcher_survives_an_injected_dispatch(engines):
    """The port engine under its own batcher: exactly the failing window's
    future carries the error; the next requests' rows equal the engine's
    unarmed rows bitwise."""
    _, peng, images = engines
    want = [peng.probs(images[i:i + 1]) for i in range(4)]
    b = peng.make_batcher()
    try:
        fi.arm(DISPATCH)
        out = []
        for i in range(4):
            f = b.submit(images[i:i + 1])
            try:
                out.append(f.result(timeout=30))
            except RuntimeError as e:
                out.append(str(e))
        fi.disarm()
    finally:
        b.close()
    assert out[1] == "chaos (injected, call 2)"
    for i in (0, 2, 3):
        np.testing.assert_array_equal(out[i], want[i])


# ---------------------------------------------------------------------------
# trainer.step: the blackbox of an exception, no preemption save
# ---------------------------------------------------------------------------

FIT_ITEMS = ("train.steps=6", "train.eval_every=3", "train.log_every=2",
             "data.batch_size=8", "data.augment=false", "eval.batch_size=8",
             "obs.flush_every_s=0")
STEP_FAULT = {"trainer.step": {"kind": "error", "error": "RuntimeError",
                               "on_calls": [5], "message": "chaos step"}}


def _fit_outcome(wd):
    recs = read_jsonl(os.path.join(wd, "metrics.jsonl"))
    return {"preempt_save": [r for r in recs if r["kind"] == "preempt_save"],
            "dumps": [d.split("-", 1)[1] for d in
                      sorted(os.listdir(os.path.join(wd, "blackbox")))],
            "evals": [r["step"] for r in recs if r["kind"] == "eval"],
            "trains": [r["step"] for r in recs if r["kind"] == "train"]}


def _chaos_fit(pkg, split, wd, how):
    """A fit under STEP_FAULT, armed by the caller or through
    ``obs.fault_plan`` (then the fit arms it at its start, and no eval
    may re-arm it: the eval at 3 comes before the fault at 5)."""
    items = FIT_ITEMS + ((f"obs.fault_plan={json.dumps(STEP_FAULT)}",)
                         if how == "config" else ())
    jcfg, pcfg = _smoke_cfgs(*items)
    mod = fi if pkg == "port" else jax_fi
    prev = ((obs_registry.set_default_registry(obs_registry.Registry()),
             obs_trace.set_default_tracer(obs_trace.Tracer()))
            if pkg == "port" else
            (jax_registry.set_default_registry(jax_registry.Registry()),
             jax_trace.set_default_tracer(jax_trace.Tracer())))
    try:
        if how == "arm":
            mod.arm(STEP_FAULT)
        with pytest.raises(RuntimeError, match="chaos step") as e:
            if pkg == "port":
                trainer.fit(pcfg, split, wd, seed=0, device="cpu")
            else:
                jax_trainer.fit(jcfg, split, wd, seed=0)
        counts = mod.active_plan().counts()
        mod.disarm()
    finally:
        if pkg == "port":
            obs_registry.set_default_registry(prev[0])
            obs_trace.set_default_tracer(prev[1])
        else:
            jax_registry.set_default_registry(prev[0])
            jax_trace.set_default_tracer(prev[1])
    return str(e.value), counts, _fit_outcome(wd)


@pytest.mark.parametrize("how", ["arm", "config"])
def test_an_injected_step_error_dumps_and_keeps_the_jsonl_as_jax_does(
        split, tmp_path, how):
    """``:884``: the 5th step boundary raises; the exception path writes
    one blackbox ending in ``exception`` and no ``preempt_save``, the
    JSONL stays whole with the eval at 3, and the error reaches the
    caller, as in the reference's fit."""
    got = _chaos_fit("port", split, str(tmp_path / "port"), how)
    want = _chaos_fit("jax", split, str(tmp_path / "jax"), how)
    assert got == want
    assert got[2]["dumps"] == ["exception"] and got[2]["evals"] == [3]
    assert got[2]["preempt_save"] == []
    assert ckpt_lib.Checkpointer(str(tmp_path / "port")).latest_step == 3


# ---------------------------------------------------------------------------
# host.decode and predict --max_retries
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def photos(tmp_path_factory):
    import cv2

    from jama16_retina_tpu_torch.data import synthetic

    d = tmp_path_factory.mktemp("fault_photos")
    paths = []
    for i in range(3):
        img = synthetic.render_fundus(np.random.default_rng(i), 1,
                                      synthetic.SynthConfig(image_size=96))
        p = str(d / f"eye_{i}.jpeg")
        cv2.imwrite(p, img[..., ::-1])
        paths.append(p)
    return paths


HOST_CASES = {
    "retried": ({"kind": "error", "error": "OSError", "on_calls": [2]}, 2),
    "not_retried": ({"kind": "error", "error": "OSError",
                     "on_calls": [2]}, 0),
    "exhausted": ({"kind": "error", "error": "OSError",
                   "on_calls": [2, 3, 4]}, 2),
    "corrupt": ({"kind": "corrupt", "on_calls": [2]}, 2),
    "latency": ({"kind": "latency", "on_calls": [1], "delay_s": 0.01}, 2),
}


def _host(pkg, paths, plan, max_retries):
    mod = fi if pkg == "port" else jax_fi
    lib = host if pkg == "port" else jax_host
    with _Registries() as regs:
        reg = regs.port if pkg == "port" else regs.jax
        mod.arm({"host.decode": plan})
        pre = lib.preprocess_paths(paths, 64, workers=1, registry=reg,
                                   max_retries=max_retries)
        counts = mod.active_plan().counts()
        mod.disarm()
        counters = {k: v for k, v in reg.snapshot()["counters"].items()
                    if k.startswith(("serve.input", "io.retries"))}
    return (pre.kept, pre.skipped, pre.retried, counters, counts), pre


@pytest.mark.parametrize("case", list(HOST_CASES))
def test_host_stage_ledgers_and_counters_equal_jax_preprocess_paths(
        photos, case):
    """``:1004``: the kept, skipped and retried ledgers, the
    ``serve.input_*`` and ``io.retries`` counters and the plan's counts,
    against the reference's host stage under the same plan (one worker,
    so the ordinals fall on the same files); the kept canvases are
    bitwise the unarmed ones."""
    plan, max_retries = HOST_CASES[case]
    got, pre = _host("port", photos, plan, max_retries)
    want, _ = _host("jax", photos, plan, max_retries)
    assert got == want
    clean = host.preprocess_paths(photos, 64, workers=1,
                                  registry=obs_registry.Registry())
    for p, img in zip(pre.kept, pre.images):
        np.testing.assert_array_equal(img, clean.images[photos.index(p)])
    if case == "retried":
        assert got[2] == [photos[1]] and got[1] == []
        assert got[3]["serve.input_retried"] == 1
    if case in ("not_retried", "corrupt"):
        assert [p for p, _ in got[1]] == [photos[1]] and got[2] == []


@pytest.fixture(scope="module")
def member(tmp_path_factory):
    flat = random_flat(jax_models.build(jax_configs.get_config("smoke").model),
                       (2, SIZE, SIZE, 3), seed=11)
    d = str(tmp_path_factory.mktemp("fault_member") / "member_00")
    ckpt_lib.save_member(d, flat)
    return d


def _predict(capsys, argv):
    code = predict.main(argv)
    rows = [json.loads(x) for x in capsys.readouterr().out.splitlines()
            if x.strip()]
    return code, rows


@pytest.mark.parametrize("armed_by", ["arm", "env"])
def test_predict_max_retries_flags_the_row_and_strict_counts_only_skips(
        photos, member, capsys, monkeypatch, armed_by):
    """``--max_retries 2``: every image scored, the retried one flagged
    ``"retried": true`` before ``n_models``, exit 0 under ``--strict``;
    ``--max_retries 0 --strict``: the same fault is a reject, exit 2. The
    plan armed in the process or through ``JAMA16_FAULTS``."""
    plan = {"host.decode": {"kind": "error", "error": "OSError",
                            "on_calls": [2]}}
    base = [f"--checkpoint_dir={member}", f"--images={os.path.dirname(photos[0])}",
            "--config=smoke", "--device=cpu", "--batch_size=2",
            "--host_workers=1", "--strict", "--set",
            f"model.image_size={SIZE}"]
    out = {}
    for retries in (2, 0):
        with monkeypatch.context() as m:
            if armed_by == "env":
                m.setenv(fi.ENV_VAR, json.dumps(plan))
            else:
                fi.arm(plan)
            with _Registries():
                out[retries] = _predict(capsys, base + [
                    f"--max_retries={retries}"])
        fi.disarm()
    code, rows = out[2]
    assert code == 0 and len(rows) == 3
    assert [r.get("retried", False) for r in rows] == [False, True, False]
    assert list(rows[1])[-2:] == ["retried", "n_models"]
    code, rows = out[0]
    assert code == 2 and len(rows) == 3
    assert rows[0] == {"image": photos[1],
                       "error": "unreadable: injected fault (injected, "
                                "call 2)"}
    assert not any("retried" in r for r in rows)


# ---------------------------------------------------------------------------
# integrity.write on a sealed serve policy
# ---------------------------------------------------------------------------

WRITE_CASES = {
    "bitflip": {"integrity.write": {"kind": "bitflip", "on_calls": [1]}},
    "bitflip_in_a_value": {"integrity.write": {"kind": "bitflip",
                                               "on_calls": [1]}},
    "torn": {"integrity.write": {"kind": "torn", "on_calls": [1]}},
    "truncate": {"integrity.write": {"kind": "truncate", "on_calls": [1]}},
    "corrupt": {"integrity.write": {"kind": "corrupt", "on_calls": [1]}},
    "enospc": {"integrity.write": {"kind": "error", "error": "OSError",
                                   "on_calls": [1], "message": "ENOSPC"}},
    "commit": {"integrity.write.commit": {"kind": "error",
                                          "error": "OSError",
                                          "on_calls": [1]}},
}
# The refusal each damage meets. The policy's middle byte is a newline,
# whose flipped bit no JSON parser takes; padded so that it falls inside
# a string value, the file parses and only its seal refuses it.
WRITE_REFUSALS = {"bitflip": "PolicyStale",
                  "bitflip_in_a_value": "ArtifactCorrupt",
                  "torn": "PolicyStale", "truncate": "PolicyStale",
                  "corrupt": "PolicyStale"}
FRONTIER = [{"bucket": b, "concurrency": c, "images_per_sec": 10.0 * b / c,
             "p50_ms": 2.0 * b + c, "p99_ms": 3.0 * b + 2 * c}
            for b in (8, 16, 32) for c in (1, 4)]


def _policy(pkg, case=""):
    """(policy module, a policy derived from ``FRONTIER``); for
    ``bitflip_in_a_value`` its source is padded until the middle byte of
    the sealed file is a letter of the pad."""
    lib = policy_lib if pkg == "port" else jax_policy
    cfg = (configs if pkg == "port" else jax_configs).get_config(
        "eyepacs_binary")
    fp = lib.policy_fingerprint(cfg, n_devices=1)
    if case != "bitflip_in_a_value":
        return lib, lib.derive_policy(FRONTIER, fp, source={"sweep": "test"})
    for pad in range(0, 4096, 16):
        pol = lib.derive_policy(FRONTIER, fp,
                                source={"sweep": "test", "pad": "x" * pad})
        if _middle_is_pad(lib, pol):
            return lib, pol
    raise AssertionError("no pad puts the middle byte inside the pad")


def _middle_is_pad(lib, pol) -> bool:
    import tempfile

    with tempfile.TemporaryDirectory() as d:
        path = os.path.join(d, "p.json")
        lib.save_policy(path, pol)
        with open(path, "rb") as f:
            blob = f.read()
    i = len(blob) // 2
    return blob[i - 1:i + 2] == b"xxx"


@pytest.mark.parametrize("case", list(WRITE_CASES))
def test_a_damaged_policy_write_is_refused_as_the_jax_load_refuses_it(
        tmp_path, case):
    """The port's ``save_policy`` under the plan, then both packages'
    ``load_policy`` on the bytes it left: the same refusal. A save that
    fails leaves no file and no temporary file, as the reference's. A
    checksum refusal (``ArtifactCorrupt``) counts ``integrity.corrupt``
    and the ``artifact_corrupt`` rule fires at the next flush."""
    plan = WRITE_CASES[case]
    outcomes = []
    for pkg in ("port", "jax"):
        lib, pol = _policy(pkg, case)
        mod = fi if pkg == "port" else jax_fi
        d = tmp_path / pkg
        d.mkdir()
        path = str(d / "serve_policy.json")
        mod.arm(plan)
        try:
            lib.save_policy(path, pol)
            saved = "saved"
        except OSError as e:
            saved = f"{type(e).__name__}: {e}"
        mod.disarm()
        outcomes.append((saved, sorted(os.listdir(d))))
    assert outcomes[0] == outcomes[1]
    if outcomes[0][0] != "saved":
        assert outcomes[0][1] == []
        return
    with open(tmp_path / "port" / "serve_policy.json", "rb") as f:
        port_bytes = f.read()
    with open(tmp_path / "jax" / "serve_policy.json", "rb") as f:
        assert f.read() == port_bytes
    wd = str(tmp_path / "obs")
    cfg = configs.get_config("smoke")
    with _Registries() as regs:
        # rate() reads a counter in two snapshots: one registered by the
        # corruption it counts is missing from the flush before, and the
        # rule (in both packages) would miss a process's first detection.
        # A serving process that loaded an artifact before has it.
        artifact_counter = regs.port.counter("integrity.corrupt")
        snap = obs_export.Snapshotter(workdir=wd, every_s=0)
        snap.alerts = obs_alerts.manager_for(cfg, wd)
        snap.flush()
        errs = []
        for lib in (policy_lib, jax_policy):
            with pytest.raises(Exception) as e:
                lib.load_policy(str(tmp_path / "port" / "serve_policy.json"))
            errs.append(type(e.value).__name__)
        corrupt = artifact_counter.value
        time.sleep(0.01)
        snap.close()
    assert errs[0] == errs[1] and errs[0] in ("ArtifactCorrupt", "PolicyStale")
    alerts = [r["reason"] for r in read_jsonl(os.path.join(wd, "metrics.jsonl"))
              if r["kind"] == "alert" and r["state"] == "firing"]
    if errs[0] == "ArtifactCorrupt":
        assert corrupt == 1 and alerts == ["artifact_corrupt"]
    else:
        assert corrupt == 0 and alerts == []
    # Which refusal each damage meets, pinned (the same in both packages).
    assert errs[0] == WRITE_REFUSALS[case]


# ---------------------------------------------------------------------------
# ckpt.save: kill -9 while an async save is in flight
# ---------------------------------------------------------------------------

_KILL_CHILD = r"""
import sys

if __name__ == "__main__":
    from jama16_retina_tpu_torch import configs, trainer

    data, wd = sys.argv[1], sys.argv[2]
    cfg = configs.override(configs.get_config("smoke"), sys.argv[3:])
    trainer.fit(cfg, data, wd, device="cpu")
"""
KILL_ITEMS = (f"model.image_size={SIZE}", "train.steps=6",
              "train.eval_every=2", "train.log_every=1", "data.batch_size=8",
              "data.augment=false", "eval.batch_size=8",
              "train.async_save=true")


def _session(sid):
    """Live processes of session ``sid``."""
    pids = []
    for d in filter(str.isdigit, os.listdir("/proc")):
        try:
            with open(f"/proc/{d}/stat") as f:
                fields = f.read().rsplit(")", 1)[1].split()
        except OSError:
            continue
        if int(fields[3]) == sid and fields[0] != "Z":
            pids.append(int(d))
    return pids


def _reap(sid):
    """No process of the killed child's session outlives the test: its
    reader processes and forkserver are killed, then its resource tracker
    gets 10 s to unlink their shared memory and exit."""
    def wait_gone(pids):
        deadline = time.monotonic() + 10
        while set(_session(sid)) & set(pids) and time.monotonic() < deadline:
            time.sleep(0.1)

    helpers = []
    for p in _session(sid):
        try:
            with open(f"/proc/{p}/cmdline", "rb") as f:
                tracker = b"resource_tracker" in f.read()
        except OSError:
            continue
        if not tracker:
            helpers.append(p)
            try:
                os.kill(p, signal.SIGKILL)
            except ProcessLookupError:
                pass
    wait_gone(helpers)
    wait_gone(_session(sid))
    if _session(sid):
        os.killpg(sid, signal.SIGKILL)


def test_kill9_during_an_inflight_async_save_resumes_cleanly(split,
                                                             tmp_path):
    """``:1055``: a child fit (``train.async_save=true``) whose second
    eval-time save is held in flight by a ``ckpt.save`` latency plan
    (``JAMA16_FAULTS`` in the child's env only) is killed with SIGKILL.
    ``latest/`` is the previous step or the new one, whole; a resume from
    it completes to the last step."""
    wd = str(tmp_path / "wd")
    env = dict(os.environ, **{fi.ENV_VAR: json.dumps({"ckpt.save": {
        "kind": "latency", "on_calls": [2], "delay_s": 30.0}})})
    child = subprocess.Popen(
        [sys.executable, "-c", _KILL_CHILD, split, wd, *KILL_ITEMS],
        cwd=REPO, env=env, stdout=subprocess.DEVNULL,
        stderr=subprocess.PIPE, text=True, start_new_session=True)
    try:
        t0 = time.monotonic()
        metrics = os.path.join(wd, "metrics.jsonl")
        while time.monotonic() - t0 < 120 and child.poll() is None:
            if os.path.exists(metrics) and any(
                    r["kind"] == "eval" and r["step"] == 4
                    for r in read_jsonl(metrics)):
                break
            time.sleep(0.05)
        assert child.poll() is None, child.stderr.read()[-2000:]
        time.sleep(0.3)  # the saver is inside the held save now
        child.send_signal(signal.SIGKILL)
        child.wait(timeout=60)
    finally:
        if child.poll() is None:
            child.kill()
            child.wait()
        _reap(child.pid)
    assert child.returncode == -signal.SIGKILL
    assert _session(child.pid) == []
    ck = ckpt_lib.Checkpointer(wd)
    before = ck.latest_step
    assert before in (2, 4)
    assert set(ck.restore(before))  # whole: every file restores
    cfg = configs.override(configs.get_config("smoke"),
                           [*KILL_ITEMS, "train.resume=true"])
    res = trainer.fit(cfg, split, wd, device="cpu")
    assert res["best_auc"] is not None
    ck = ckpt_lib.Checkpointer(wd)
    assert ck.latest_step == 6 and set(ck.restore(6))
    assert [r["step"] for r in read_jsonl(os.path.join(wd, "metrics.jsonl"))
            if r["kind"] == "resume"] == [before]
