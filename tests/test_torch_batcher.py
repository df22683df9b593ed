"""The port's ``MicroBatcher`` (``serve/batcher.py``) against the JAX
package's, and over the port's engine, on the CPU.

No verdict rests on the wall clock: queues are staged with
``autostart=False`` before the worker starts, a window closes on its row
count before ``max_wait_ms`` can matter, ``infer_fn`` is a fake that
records its windows (and blocks on an event where a test needs the
worker held), and deadlines run on a fake monotonic clock."""

import threading

import numpy as np
import pytest
import torch

from jama16_retina_tpu.obs.registry import Registry as JaxRegistry
from jama16_retina_tpu.serve import batcher as jax_batcher
from jama16_retina_tpu_torch import configs, models
from jama16_retina_tpu_torch.obs.registry import Registry
from jama16_retina_tpu_torch.serve import batcher
from jama16_retina_tpu_torch.serve.engine import ServingEngine
from torch_parity import one_torch_thread  # noqa: F401 (autouse)

TIMEOUT = 60


class Recorder:
    """A row-wise fake ``infer_fn`` (row -> its first value + 0.5) that
    records each window's row count."""

    def __init__(self):
        self.windows = []

    def __call__(self, rows):
        self.windows.append(rows.shape[0])
        return rows.reshape(rows.shape[0], -1)[:, 0] + 0.5


def _rows(n, start):
    return np.arange(start, start + n, dtype=np.float64)[:, None]


def _counts(snapshot):
    return {k: v for k, v in snapshot["counters"].items()
            if k.startswith(("serve.batcher", "serve.shed"))}


def _drive(module, registry, sizes, **kw):
    """Stage requests of ``sizes`` rows before the worker starts, then
    serve them: (windows, per-request results, counters)."""
    rec = Recorder()
    b = module.MicroBatcher(rec, autostart=False, registry=registry, **kw)
    futures, start = [], 0
    for n in sizes:
        futures.append(b.submit(_rows(n, start)))
        start += n
    b.start()
    results = [f.result(timeout=TIMEOUT) for f in futures]
    b.close()
    return rec.windows, results, _counts(registry.snapshot())


@pytest.mark.parametrize("sizes,max_batch,max_wait_ms,windows", [
    ((3, 3, 3), 8, 1e4, [9]),           # closes at >= max_batch rows
    ((2, 2, 2, 2), 4, 1e4, [4, 4]),
    ((5, 1, 9, 6), 6, 1e4, [6, 9, 6]),  # a request is never split
    ((1, 1, 1), 8, 0.0, [1, 1, 1]),     # max_wait 0: no coalescing
])
def test_windows_equal_the_jax_batcher(sizes, max_batch, max_wait_ms,
                                       windows):
    kw = dict(max_batch=max_batch, max_wait_ms=max_wait_ms)
    ours = _drive(batcher, Registry(), sizes, **kw)
    theirs = _drive(jax_batcher, JaxRegistry(), sizes, **kw)
    assert ours[0] == theirs[0] == windows
    start = 0
    for n, got, want in zip(sizes, ours[1], theirs[1]):
        np.testing.assert_array_equal(got, want)
        np.testing.assert_array_equal(got, np.arange(start, start + n) + 0.5)
        start += n
    assert ours[2] == theirs[2]
    assert ours[2]["serve.batcher.batches"] == len(windows)
    assert ours[2]["serve.batcher.rows"] == sum(sizes)


def test_shedding_raises_overloaded_at_submit_as_the_jax_batcher():
    for module, reg in ((batcher, Registry()), (jax_batcher, JaxRegistry())):
        b = module.MicroBatcher(Recorder(), autostart=False, registry=reg,
                                shed_queue_depth=2)
        b.submit(_rows(1, 0))
        b.submit(_rows(1, 1))
        with pytest.raises(module.Overloaded, match="queue depth 2"):
            b.submit(_rows(1, 2))
        b.close()
        c = module.MicroBatcher(Recorder(), autostart=False, registry=reg,
                                shed_in_flight=1)
        c.submit(_rows(1, 0))
        with pytest.raises(module.Overloaded, match="in flight"):
            c.submit(_rows(1, 1))
        c.close()
        counts = _counts(reg.snapshot())
        assert counts["serve.shed.queue_depth"] == 1
        assert counts["serve.shed.in_flight"] == 1
        assert reg.snapshot()["gauges"]["serve.batcher.in_flight"] == 0


class _Clock:
    def __init__(self):
        self.t = 100.0

    def monotonic(self):
        return self.t


def test_an_expired_deadline_fails_before_any_device_work(monkeypatch):
    """On a fake clock: of three staged requests (deadline 5 ms, the
    default 50 ms, none) the clock is moved 20 ms on; at window close the
    first fails ``DeadlineExceeded`` and never reaches ``infer_fn``."""
    clock = _Clock()
    monkeypatch.setattr(batcher, "time", clock)
    rec, reg = Recorder(), Registry()
    b = batcher.MicroBatcher(rec, autostart=False, registry=reg,
                             default_deadline_ms=50.0)
    late = b.submit(_rows(2, 0), deadline_ms=5.0)
    default = b.submit(_rows(3, 10))
    free = b.submit(_rows(1, 20), deadline_ms=0)
    clock.t += 0.020
    b.close()  # never started: close serves the queue on this thread
    with pytest.raises(batcher.DeadlineExceeded, match="no device work"):
        late.result(timeout=TIMEOUT)
    np.testing.assert_array_equal(default.result(timeout=TIMEOUT),
                                  [10.5, 11.5, 12.5])
    np.testing.assert_array_equal(free.result(timeout=TIMEOUT), [20.5])
    assert rec.windows == [4]
    counts = _counts(reg.snapshot())
    assert counts["serve.shed.deadline"] == 1
    assert counts["serve.batcher.close_flushed_windows"] == 1
    clock.t += 0.1
    only = batcher.MicroBatcher(rec, autostart=False, registry=reg,
                                default_deadline_ms=1.0)
    gone = only.submit(_rows(1, 0))
    clock.t += 1.0
    only.close()
    with pytest.raises(batcher.DeadlineExceeded):
        gone.result(timeout=TIMEOUT)
    assert rec.windows == [4]  # the all-expired window ran nothing
    assert reg.snapshot()["gauges"]["serve.batcher.in_flight"] == 0


def test_close_resolves_every_future_and_refuses_later_submits():
    """The worker is held inside ``infer_fn`` on the first request while
    two more queue; ``close()`` returns only after all three are served."""
    entered, release = threading.Event(), threading.Event()
    rec = Recorder()

    def blocked(rows):
        entered.set()
        assert release.wait(TIMEOUT)
        return rec(rows)

    reg = Registry()
    b = batcher.MicroBatcher(blocked, max_batch=1, registry=reg)
    first = b.submit(_rows(1, 0))
    assert entered.wait(TIMEOUT)
    queued = [b.submit(_rows(1, 1)), b.submit(_rows(1, 2))]
    closer = threading.Thread(target=b.close)
    closer.start()
    release.set()
    closer.join(TIMEOUT)
    assert not closer.is_alive()
    for f, want in zip([first, *queued], (0.5, 1.5, 2.5)):
        assert f.done()
        np.testing.assert_array_equal(f.result(), [want])
    with pytest.raises(RuntimeError, match="closed"):
        b.submit(_rows(1, 3))
    assert _counts(reg.snapshot())["serve.batcher.rejected_at_close"] == 1
    assert rec.windows == [1, 1, 1]


def test_a_failing_window_fails_only_its_futures():
    calls = []

    def flaky(rows):
        calls.append(rows.shape[0])
        if len(calls) == 1:
            raise ValueError("boom")
        return rows[:, 0]

    reg = Registry()
    b = batcher.MicroBatcher(flaky, max_batch=2, autostart=False,
                             registry=reg)
    bad = [b.submit(_rows(1, 0)), b.submit(_rows(1, 1))]
    good = b.submit(_rows(2, 5))
    b.start()
    np.testing.assert_array_equal(good.result(timeout=TIMEOUT), [5.0, 6.0])
    for f in bad:
        with pytest.raises(ValueError, match="boom"):
            f.result(timeout=TIMEOUT)
    b.close()
    assert _counts(reg.snapshot())["serve.batcher.window_errors"] == 1
    with pytest.raises(ValueError, match="n >= 1"):
        b.submit(np.zeros((0, 1)))


@pytest.fixture(scope="module")
def engine():
    """``smoke`` at 64 px, k=2 random members, one bucket of 8, the
    quality monitor on (no profile: scores and positive rate only)."""
    cfg = configs.override(configs.get_config("smoke"), [
        "model.image_size=64", "model.compute_dtype=float32",
        "serve.max_batch=8", "serve.bucket_sizes=8", "serve.max_wait_ms=1e4",
        "obs.quality.enabled=true"])
    sds = []
    for m in range(2):
        gen = torch.Generator().manual_seed(m)
        sds.append({k: (v if k.endswith((".mean", ".var"))
                        else v + 0.05 * torch.randn(v.shape, generator=gen))
                    for k, v in models.build(cfg.model).state_dict().items()})
    return ServingEngine(cfg, state_dicts=sds, device="cpu",
                         registry=Registry())


def test_engine_batcher_rows_equal_engine_probs_at_one_bucket(engine):
    """Requests of 1-8 rows from 3 threads, coalesced in whatever order
    they arrive: every row's result equals ``engine.probs`` of that
    request alone (one bucket, so one shape), and the engine's monitor
    saw each row exactly once."""
    rng = np.random.default_rng(0)
    reqs = [rng.integers(0, 256, (n, 64, 64, 3), np.uint8)
            for n in (1, 8, 3, 5, 2, 7, 4, 6, 1)]
    want = [engine.probs(r) for r in reqs]
    before = engine.registry.snapshot()["counters"]["quality.scores"]
    b = engine.make_batcher()
    out = [None] * len(reqs)

    def client(idx):
        for i in idx:
            out[i] = b.submit(reqs[i])

    threads = [threading.Thread(target=client, args=(range(t, len(reqs), 3),))
               for t in range(3)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(TIMEOUT)
    b.close()  # the last partial window is served now, not at max_wait
    for f, w in zip(out, want):
        np.testing.assert_array_equal(f.result(timeout=TIMEOUT), w)
    snap = engine.registry.snapshot()
    assert snap["counters"]["quality.scores"] - before == 37
    assert snap["histograms"]["serve.request_latency_s"]["count"] == len(reqs)
    assert snap["counters"]["serve.batcher.rows"] == 37


def test_engine_batcher_refuses_malformed_rows_at_submit(engine):
    b = engine.make_batcher()
    with pytest.raises(ValueError, match="rows must be"):
        b.submit(np.zeros((2, 32, 32, 3), np.uint8))
    with pytest.raises(ValueError, match="uint8"):
        b.submit(np.zeros((2, 64, 64, 3), np.float32))
    assert b.max_batch == 8 and b.max_wait_s == 10.0
    b.close()
