"""The port's distilled cascade (``serve/cascade.py``), engine assembly
(``serve/assemble.py``) and the predict CLI's cascade path, against the
JAX package's ``CascadeEngine``.

Over the same stub engines (fixed scores keyed by row index, as the JAX
package's own cascade tests use) the two cascades give equal outputs,
escalation masks, counters, ensemble calls and gate verdicts, exactly.
Over real smoke engines (``tiny_cnn``, 64 px, float32, converted
weights) the port's cascade is within 1e-6 of the JAX cascade, and its
rows are bitwise those of the port engine call that scored them.
Speculative escalation scores all rows at the request's bucket instead
of the escalated rows at theirs; on the CPU it is held to the serial
cascade within 1e-6 (ROADMAP "Parity gaps by design")."""

import json

import numpy as np
import pytest

from jama16_retina_tpu import configs as jax_configs
from jama16_retina_tpu import models as jax_models
from jama16_retina_tpu.obs import quality as jax_quality
from jama16_retina_tpu.obs.registry import Registry as JaxRegistry
from jama16_retina_tpu.serve import cascade as jax_cascade
from jama16_retina_tpu.serve import engine as jax_engine
from jama16_retina_tpu_torch import configs, models, predict
from jama16_retina_tpu_torch.models import convert
from jama16_retina_tpu_torch.obs import quality
from jama16_retina_tpu_torch.obs.registry import Registry
from jama16_retina_tpu_torch.serve import assemble as assemble_lib
from jama16_retina_tpu_torch.serve import host
from jama16_retina_tpu_torch.serve.cascade import (CascadeEngine,
                                                   CascadeRejected)
from jama16_retina_tpu_torch.serve.engine import ServingEngine
from jama16_retina_tpu_torch.utils import checkpoint as ckpt_lib
from torch_parity import one_torch_thread  # noqa: F401 - autouse fixture
from torch_parity import random_flat, stacked_state

SMOKE = ["model.image_size=64", "model.compute_dtype=float32",
         "serve.max_batch=8", "serve.bucket_sizes=4,8"]
COUNTERS = ("serve.cascade.student_rows", "serve.cascade.escalated_rows",
            "serve.cascade.speculated", "serve.cascade.speculated.wasted")


def _configs(overrides):
    return (jax_configs.override(jax_configs.get_config("smoke"), overrides),
            configs.override(configs.get_config("smoke"), overrides))


class _Stub:
    """An engine half of fixed scores keyed by row index: a row's first
    value is its index. Records the indices of every call."""

    def __init__(self, scores):
        self.scores = np.asarray(scores, np.float64)
        self.calls = []

    def probs(self, rows):
        idx = np.asarray(rows).reshape(len(rows), -1)[:, 0].astype(int)
        self.calls.append(idx.tolist())
        return self.scores[idx]


def _rows(n):
    return np.broadcast_to(np.arange(n, dtype=np.uint8)[:, None, None, None],
                           (n, 1, 1, 3)).copy()


def _multi(referable):
    """5-class distributions whose P(grade >= 2) is ``referable``."""
    r = np.asarray(referable, np.float64)[:, None]
    return np.concatenate([(1 - r) * [0.6, 0.4], r * [0.5, 0.3, 0.2]], 1)


SCENARIOS = {
    "band": ([0.1, 0.48, 0.52, 0.9, 0.5], [0.9, 0.8, 0.7, 0.6, 0.5],
             ["serve.cascade_band=0.05", "serve.cascade_thresholds=0.5"]),
    "two_thresholds": ([0.2, 0.86, 0.5, 0.97], [0.0, 0.1, 0.2, 0.3],
                       ["serve.cascade_band=0.02",
                        "serve.cascade_thresholds=0.87,0.98"]),
    "band_0": ([0.1, 0.4, 0.5, 0.9], [0.7] * 4,
               ["serve.cascade_band=0", "serve.cascade_thresholds=0.5"]),
    "band_0_no_hit": ([0.1, 0.4, 0.6, 0.9], [0.7] * 4,
                      ["serve.cascade_band=0"]),
    "band_covers_0_1": ([0.1, 0.4, 0.6, 0.9], [0.5] * 4,
                        ["serve.cascade_band=1.0"]),
    "multi_head": (_multi([0.1, 0.47, 0.55, 0.9]), _multi([0.3] * 4),
                   ["serve.cascade_band=0.05"]),
}


def _pair(overrides, student, ensemble, quality=(None, None)):
    """(JAX cascade, its ensemble stub, port cascade, its ensemble stub)
    over the same scores under one override list; ``quality`` is the
    (JAX, port) pair of cascade monitors."""
    jcfg, pcfg = _configs(overrides)
    js, je, ps, pe = _Stub(student), _Stub(ensemble), _Stub(student), \
        _Stub(ensemble)
    jq, pq = quality
    jc = jax_cascade.CascadeEngine(jcfg, js, je, registry=JaxRegistry(),
                                   quality=jq)
    pc = CascadeEngine(pcfg, ps, pe, registry=Registry(), quality=pq)
    return jc, je, pc, pe


@pytest.mark.parametrize("speculative", [False, True],
                         ids=["serial", "speculative"])
@pytest.mark.parametrize("scenario", list(SCENARIOS))
def test_stub_cascades_equal_the_jax_cascade(scenario, speculative):
    student, ensemble, overrides = SCENARIOS[scenario]
    jc, je, pc, pe = _pair(
        overrides + [f"serve.cascade_speculative={speculative}"],
        student, ensemble)
    rows = _rows(len(student))
    try:
        want, want_mask = jc._probs_masked(rows)
        got, got_mask = pc._probs_masked(rows)
        np.testing.assert_array_equal(got, want)
        np.testing.assert_array_equal(got_mask, want_mask)
        assert pe.calls == je.calls
        for name in COUNTERS:
            assert (pc.registry.counter(name).value
                    == jc.registry.counter(name).value), name
        np.testing.assert_array_equal(pc.probs(rows), jc.probs(rows))
    finally:
        jc.close()
        pc.close()


def test_the_edges_escalate_all_rows_or_none():
    _, _, pc, pe = _pair(["serve.cascade_band=1.0"], [0.1, 0.9], [0.5, 0.5])
    np.testing.assert_array_equal(pc.probs(_rows(2)), [0.5, 0.5])
    _, _, pc, pe = _pair(["serve.cascade_band=0"], [0.1, 0.9], [0.5, 0.5])
    np.testing.assert_array_equal(pc.probs(_rows(2)), [0.1, 0.9])
    assert pe.calls == []


@pytest.mark.parametrize("override,match", [
    ("serve.cascade_band=-0.1", "cascade_band"),
    ("serve.cascade_thresholds=1.5", "cascade_thresholds")])
def test_validation_errors_equal_the_jax_cascade(override, match):
    jcfg, pcfg = _configs([override])
    with pytest.raises(ValueError, match=match) as want:
        jax_cascade.CascadeEngine(jcfg, _Stub([0.5]), _Stub([0.5]),
                                  registry=JaxRegistry())
    with pytest.raises(ValueError, match=match) as got:
        CascadeEngine(pcfg, _Stub([0.5]), _Stub([0.5]), registry=Registry())
    assert str(got.value) == str(want.value)


def _gate_rows():
    n = 40
    full = np.random.default_rng(3).uniform(0.05, 0.95, n)
    return full, np.where(full >= 0.5, 3, 0), _rows(n)


@pytest.mark.parametrize("student", ["garbage", "faithful"])
def test_gate_verdicts_equal_the_jax_gate(student):
    """A student inverting the ensemble's ranking is refused by the
    auc_floor gate, one equal to it admitted; the verdict rows and the
    refusal's message are the JAX gate's."""
    full, grades, rows = _gate_rows()
    scores = 1.0 - full if student == "garbage" else full
    jc, _, pc, _ = _pair(["serve.cascade_band=0"], scores, full)
    want = [v.as_dict() for v in jc.gate(rows, grades)]
    got = [v.as_dict() for v in pc.gate(rows, grades)]
    assert got == want
    assert got[0]["skipped"] and got[0]["name"] == "golden_canary"
    if student == "garbage":
        with pytest.raises(jax_cascade.CascadeRejected) as e_want:
            jc.go_live(rows, grades)
        with pytest.raises(CascadeRejected, match="auc_floor") as e_got:
            pc.go_live(rows, grades)
        assert str(e_got.value) == str(e_want.value)
    else:
        assert [v.as_dict() for v in pc.go_live(rows, grades)] == want
    assert [v.as_dict() for v in pc.gate()] == [
        v.as_dict() for v in jc.gate()]


def test_gate_canary_reads_the_cascades_own_monitor():
    """With a monitor on the cascade (the assembled wiring) the
    golden_canary verdict reads its pinned canary; a deviating pin is
    refused. Both packages' verdicts agree."""
    pinned = np.array([0.1, 0.2, 0.3, 0.4])
    monitors = []
    for qlib, reg in ((jax_quality, JaxRegistry), (quality, Registry)):
        canary = qlib.GoldenCanary(_rows(4), reference_scores=pinned,
                                   registry=reg())
        qcfg = type("Q", (), {"enabled": True, "score_bins": 20,
                              "window_scores": 256})()
        monitors.append(qlib.QualityMonitor(qcfg, registry=reg(),
                                            canary=canary))
    jc, _, pc, _ = _pair(["serve.cascade_band=0",
                          "serve.cascade_thresholds=0.99"],
                         pinned, [0.9] * 4, quality=tuple(monitors))
    want, got = jc.gate()[0].as_dict(), pc.gate()[0].as_dict()
    assert got == want and not got["skipped"] and got["value"] == 0.0
    for m in monitors:
        m.canary.reference = pinned + 10.0
    with pytest.raises(CascadeRejected, match="golden_canary"):
        pc.go_live()
    assert pc.gate()[0].as_dict() == jc.gate()[0].as_dict()


# ---------------------------------------------------------------------------
# Real smoke engines
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def smoke(tmp_path_factory):
    """k=2 random tiny_cnn members (Flax trees and port member dirs), the
    student being member 0 alone; JAX engines over both; 24 images."""
    jcfg, pcfg = _configs(SMOKE)
    flats = [random_flat(jax_models.build(jcfg.model), (2, 64, 64, 3),
                         seed=40 + m) for m in range(2)]
    root = tmp_path_factory.mktemp("cascade_members")
    for m, flat in enumerate(flats):
        ckpt_lib.save_member(str(root / "ensemble" / f"member_{m:02d}"), flat)
    ckpt_lib.save_member(str(root / "student"), flats[0])
    model = jax_models.build(jcfg.model)
    j_student = jax_engine.ServingEngine(
        jcfg, model=model, state=stacked_state(flats[:1]),
        registry=JaxRegistry())
    j_ensemble = jax_engine.ServingEngine(
        jcfg, model=model, state=stacked_state(flats),
        registry=JaxRegistry())
    images = np.random.default_rng(5).integers(0, 256, (24, 64, 64, 3),
                                               np.uint8)
    return {"flats": flats, "root": root, "j_student": j_student,
            "j_ensemble": j_ensemble, "images": images}


def _port_engines(smoke, overrides=()):
    _, pcfg = _configs(SMOKE + list(overrides))
    model = models.build(pcfg.model)
    sds = [convert.flax_to_torch(f, model) for f in smoke["flats"]]
    return (pcfg,
            ServingEngine(pcfg, state_dicts=sds[:1], device="cpu",
                          registry=Registry()),
            ServingEngine(pcfg, state_dicts=sds, device="cpu",
                          registry=Registry()))


def _band(scores):
    """A threshold at the median and a band escalating about 40 % of the
    rows, with every score at least 1e-5 from the band's edges (so the
    two frameworks' masks cannot differ by rounding)."""
    thr = float(np.median(scores))
    dist = np.sort(np.abs(scores - thr))
    i = int(0.4 * len(dist))
    band = float((dist[i] + dist[i + 1]) / 2)
    assert dist[i + 1] - dist[i] > 2e-5
    return thr, band


def test_smoke_cascade_within_1e6_of_the_jax_cascade(smoke):
    imgs = smoke["images"]
    _, student, ensemble = _port_engines(smoke)
    thr, band = _band(student.probs(imgs))
    overrides = [f"serve.cascade_band={band}",
                 f"serve.cascade_thresholds={thr}"]
    jcfg, _ = _configs(SMOKE + overrides)
    pcfg, student, ensemble = _port_engines(smoke, overrides)
    jc = jax_cascade.CascadeEngine(jcfg, smoke["j_student"],
                                   smoke["j_ensemble"], registry=JaxRegistry())
    pc = CascadeEngine(pcfg, student, ensemble, registry=Registry())
    want, want_mask = jc._probs_masked(imgs)
    got, mask = pc._probs_masked(imgs)
    np.testing.assert_array_equal(mask, want_mask)
    assert 0 < mask.sum() < len(mask)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)
    # Every row is bitwise the port engine call that scored it.
    np.testing.assert_array_equal(got[~mask], student.probs(imgs)[~mask])
    np.testing.assert_array_equal(got[mask], ensemble.probs(imgs[mask]))
    assert pc.registry.counter("serve.cascade.escalated_rows").value == \
        mask.sum()
    assert pc.registry.counter("serve.cascade.student_rows").value == 24


def test_speculative_within_1e6_of_serial_with_its_ledger(smoke):
    imgs = smoke["images"]
    _, student, _ = _port_engines(smoke)
    thr, band = _band(student.probs(imgs))
    overrides = [f"serve.cascade_band={band}",
                 f"serve.cascade_thresholds={thr}"]
    pcfg, student, ensemble = _port_engines(smoke, overrides)
    serial = CascadeEngine(pcfg, student, ensemble, registry=Registry())
    spec_cfg = configs.override(pcfg, ["serve.cascade_speculative=true"])
    spec = CascadeEngine(spec_cfg, student, ensemble, registry=Registry())
    try:
        want, mask = serial._probs_masked(imgs)
        got, spec_mask = spec._probs_masked(imgs)
    finally:
        spec.close()
    np.testing.assert_array_equal(spec_mask, mask)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)
    np.testing.assert_array_equal(got[mask], ensemble.probs(imgs)[mask])
    reg = spec.registry
    assert reg.counter("serve.cascade.speculated").value == 24
    assert (reg.counter("serve.cascade.speculated.wasted").value
            == 24 - mask.sum())


def test_go_live_admits_a_faithful_cascade_and_refuses_a_garbage_student(
        smoke, tmp_path):
    """Against a canary pinned from the ensemble's scores: a band covering
    [0, 1] is the ensemble and passes; a student whose head bias is +20
    (it scores about 1 everywhere) under band 0 is refused."""
    imgs = smoke["images"]
    _, _, ensemble = _port_engines(smoke)
    canary = quality.save_canary(str(tmp_path / "canary"), imgs[:8],
                                 ensemble.probs(imgs[:8]))
    mon = ["obs.quality.enabled=true", f"obs.quality.canary_path={canary}"]
    pcfg, student, ensemble = _port_engines(
        smoke, mon + ["serve.cascade_band=1.0"])
    faithful = CascadeEngine(pcfg, student, ensemble, registry=Registry(),
                             quality=quality.monitor_from_config(
                                 pcfg.obs.quality, registry=Registry()))
    grades = np.where(ensemble.probs(imgs) >= np.median(
        ensemble.probs(imgs)), 3, 0)
    verdicts = {v.name: v for v in faithful.go_live(imgs, grades)}
    assert verdicts["golden_canary"].value == 0.0
    assert verdicts["auc_floor"].passed and not verdicts["auc_floor"].skipped

    bad_cfg = configs.override(pcfg, ["serve.cascade_band=0"])
    flat = dict(smoke["flats"][0])
    flat["params/Logits/bias"] = flat["params/Logits/bias"] + 20.0
    garbage = ServingEngine(
        bad_cfg, state_dicts=[convert.flax_to_torch(
            flat, models.build(bad_cfg.model))],
        device="cpu", registry=Registry())
    assert garbage.probs(imgs).min() > 0.99
    cascade = CascadeEngine(bad_cfg, garbage, ensemble, registry=Registry(),
                            quality=quality.monitor_from_config(
                                bad_cfg.obs.quality, registry=Registry()))
    with pytest.raises(CascadeRejected, match="golden_canary"):
        cascade.go_live()


def test_make_batcher_round_trips(smoke):
    imgs = smoke["images"][:12]
    pcfg, student, ensemble = _port_engines(smoke, [
        "serve.cascade_band=0.3", "serve.bucket_sizes=8", "serve.max_batch=8",
        "serve.max_wait_ms=1"])
    cascade = CascadeEngine(pcfg, student, ensemble, registry=Registry())
    batcher = cascade.make_batcher()
    try:
        futs = [batcher.submit(imgs[i:i + 3]) for i in range(0, 12, 3)]
        got = np.concatenate([f.result(timeout=60) for f in futs])
    finally:
        batcher.close()
    want = np.concatenate([cascade.probs(imgs[i:i + 3])
                           for i in range(0, 12, 3)])
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)


def test_assemble_builds_the_engine_or_the_cascade(smoke):
    imgs = smoke["images"]
    _, pcfg = _configs(SMOKE)
    ens = ckpt_lib.discover_member_dirs(str(smoke["root"] / "ensemble"))
    plain = assemble_lib.assemble(assemble_lib.EngineSpec(
        cfg=pcfg, member_dirs=tuple(ens), device="cpu"))
    direct = ServingEngine(pcfg, ens, device="cpu")
    assert type(plain) is ServingEngine
    np.testing.assert_array_equal(plain.probs(imgs), direct.probs(imgs))

    student_cfg = configs.override(pcfg, [
        f"serve.cascade_student_dir={smoke['root'] / 'student'}"])
    casc = assemble_lib.assemble(assemble_lib.EngineSpec(
        cfg=student_cfg, member_dirs=tuple(ens), device="cpu",
        registry=Registry(), go_live=True))
    assert isinstance(casc, CascadeEngine)
    assert casc.student.quality is None and casc.ensemble.quality is None
    plain_again = assemble_lib.assemble(assemble_lib.EngineSpec(
        cfg=student_cfg, member_dirs=tuple(ens), device="cpu",
        cascade=False))
    assert type(plain_again) is ServingEngine
    with pytest.raises(NotImplementedError, match="Queue A item 8"):
        assemble_lib.assemble(assemble_lib.EngineSpec(
            cfg=pcfg, member_dirs=tuple(ens), device="cpu", mesh=object()))


def test_assemble_moves_the_monitor_to_the_cascade(smoke, tmp_path):
    """Quality on: both halves are built quality-off and the cascade's
    monitor observes the merged scores; fused preprocess feeds it B4's
    statistics (the plain version on the CPU)."""
    ens = ckpt_lib.discover_member_dirs(str(smoke["root"] / "ensemble"))
    imgs = smoke["images"]
    profile = quality.save_profile(str(tmp_path / "profile.json"),
                                   quality.build_profile(
                                       np.linspace(0, 1, 24),
                                       stat_values=quality.input_stat_values(
                                           imgs)))
    _, pcfg = _configs(SMOKE + [
        "obs.quality.enabled=true", "serve.fused_preprocess=true",
        f"obs.quality.profile_path={profile}",
        f"serve.cascade_student_dir={smoke['root'] / 'student'}"])
    casc = assemble_lib.assemble(assemble_lib.EngineSpec(
        cfg=pcfg, member_dirs=tuple(ens), device="cpu", registry=Registry()))
    assert casc.student.quality is None and casc.ensemble.quality is None
    imgs = imgs[:5]
    seen = []
    stats_fn = casc.quality.stats_fn
    casc.quality.stats_fn = lambda rows: seen.append(len(rows)) or stats_fn(
        rows)
    casc.probs(imgs)
    assert seen == [5]
    assert casc.registry.counter("quality.scores").value == 5
    want = host.stats_only(imgs, device="cpu")
    got = stats_fn(imgs)
    for k in want:
        np.testing.assert_array_equal(got[k], want[k])


@pytest.fixture(scope="module")
def fundus_dir(tmp_path_factory):
    import cv2

    from jama16_retina_tpu_torch.data import synthetic

    imgdir = tmp_path_factory.mktemp("cascade_imgs")
    for i in range(5):
        img = synthetic.render_fundus(np.random.default_rng(i), i % 5,
                                      synthetic.SynthConfig(image_size=96))
        cv2.imwrite(str(imgdir / f"eye_{i}.jpeg"), img[..., ::-1])
    return str(imgdir)


def _predict(capsys, args):
    code = predict.main(args)
    rows = [json.loads(line) for line in
            capsys.readouterr().out.splitlines() if line.strip()]
    return code, rows


def test_predict_serves_the_cascade_and_exits_on_a_refusal(
        smoke, fundus_dir, tmp_path, capsys):
    ens, student = smoke["root"] / "ensemble", smoke["root"] / "student"
    sets = ["model.image_size=64", "model.compute_dtype=float32",
            f"serve.cascade_student_dir={student}", "serve.cascade_band=0.1",
            "obs.enabled=false"]
    args = [f"--checkpoint_dir={ens}", f"--images={fundus_dir}",
            "--config=smoke", "--device=cpu", "--batch_size=4"]
    code, rows = _predict(capsys, args + [a for s in sets
                                          for a in ("--set", s)])
    assert code == 0 and len(rows) == 5
    _, pcfg = _configs(sets + ["serve.max_batch=4", "serve.bucket_sizes=4"])
    pre = host.preprocess_paths(predict._expand([fundus_dir]), 64)
    cascade = CascadeEngine(
        pcfg, ServingEngine(pcfg, [str(student)], device="cpu"),
        ServingEngine(pcfg, ckpt_lib.discover_member_dirs(str(ens)),
                      device="cpu"), registry=Registry())
    want = cascade.probs(pre.images)
    assert [r["image"] for r in rows] == pre.kept
    np.testing.assert_allclose([r["prob"] for r in rows], want, atol=5e-7)
    assert all(r["n_models"] == 2 for r in rows)

    canary = quality.save_canary(str(tmp_path / "far"), pre.images[:2],
                                 np.full(2, 10.0))
    refused = sets[:-1] + ["obs.quality.enabled=true",
                           f"obs.quality.canary_path={canary}"]
    with pytest.raises(SystemExit, match="golden_canary") as e:
        _predict(capsys, args + [a for s in refused for a in ("--set", s)])
    assert e.value.code != 0
    assert capsys.readouterr().out == ""
