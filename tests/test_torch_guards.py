"""Ground rules of the port: it imports neither JAX nor the JAX package,
its entry points never run on the CPU unless asked, its kernel wrappers
never fall back from the card to the plain version, and config knobs
it cannot honour raise instead of being ignored."""

import dataclasses
import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from jama16_retina_tpu_torch import configs, models
from jama16_retina_tpu_torch.ops import adamw, build, color_jitter
from jama16_retina_tpu_torch.ops import serve_preprocess
from jama16_retina_tpu_torch.serve import host
from jama16_retina_tpu_torch.serve.engine import ServingEngine

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

_IMPORT_ALL = r"""
import importlib, pkgutil, sys
import jama16_retina_tpu_torch as pkg
names = [m.name for m in pkgutil.walk_packages(pkg.__path__, pkg.__name__ + ".")]
for name in names:
    importlib.import_module(name)
importlib.import_module("chip_smoke")
bad = sorted(m for m in sys.modules
             if m.split(".")[0] in ("jax", "jaxlib", "flax", "optax", "orbax",
                                    "tensorflow", "absl", "aqt", "grain")
             or m == "jama16_retina_tpu" or m.startswith("jama16_retina_tpu."))
print(len(names), bad, "|", " ".join(names))
"""


def test_port_and_chip_smoke_import_no_jax_and_no_jax_package():
    out = subprocess.run([sys.executable, "-c", _IMPORT_ALL], cwd=REPO,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    head, names = out.stdout.split("|")
    n_modules, bad = head.split(" ", 1)
    # Every module of the package: the train slice's (train_lib, trainer,
    # train, ops/color_jitter, ops/adamw, models/init), the fit and
    # evaluate slice's (data/tfrecord, data/pipeline, utils/logging,
    # evaluate), the serving knobs' (obs, integrity, serve/quantize,
    # serve/batcher), the optimizer families' (optim; the ensemble
    # code lives in train_lib and trainer) and the telemetry planes'
    # (obs/trace, spans, export, criticalpath, flightrec, alerts) and the
    # fault plane's (obs/faultinject, utils/retry) and the preprocess
    # runners' (data/tiff, preprocess/datasets and both entry points) and
    # the hbm loader's (data/grain_pipeline, data/hbm_pipeline,
    # data/threefry) and the tiered loader's (data/tiered_pipeline,
    # data/autotune, data/rawshard, transcode_shards) and the grain
    # loader's (data/grain_index) and the lifecycle's (lifecycle/journal,
    # lifecycle_run) included.
    assert int(n_modules) >= 52
    assert {f"jama16_retina_tpu_torch.{m}" for m in (
        "obs.registry", "obs.quality", "integrity.artifact",
        "serve.quantize", "serve.batcher", "optim", "train_lib",
        "trainer", "obs.trace", "obs.spans", "obs.export",
        "obs.criticalpath", "obs.flightrec", "obs.alerts",
        "obs.faultinject", "utils.retry", "data.tiff",
        "preprocess.datasets", "preprocess_eyepacs", "preprocess_messidor",
        "data.grain_pipeline", "data.hbm_pipeline", "data.threefry",
        "data.tiered_pipeline", "data.autotune", "data.rawshard",
        "transcode_shards", "data.grain_index", "lifecycle.controller",
        "lifecycle.journal", "lifecycle_run")
        } <= set(names.split())
    assert bad.strip() == "[]"


_RUN_FIT_AND_EVALUATE = r"""
import sys
from jama16_retina_tpu_torch import evaluate, train
d, wd = sys.argv[1], sys.argv[2]
train.main(["--config=smoke", "--synthetic=8", "--device=cpu",
            f"--data_dir={d}", f"--workdir={wd}", "--set", "train.steps=2",
            "--set", "train.eval_every=1", "--set", "model.image_size=32"])
evaluate.main(["--config=smoke", "--device=cpu", f"--data_dir={d}",
               f"--checkpoint_dir={wd}", "--set", "model.image_size=32"])
bad = sorted(m for m in sys.modules
             if m.split(".")[0] in ("jax", "jaxlib", "flax", "optax", "orbax",
                                    "tensorflow", "absl", "cv2", "PIL")
             or m == "jama16_retina_tpu" or m.startswith("jama16_retina_tpu."))
print("BAD", bad)
"""


def test_fit_and_evaluate_run_without_jax_or_tensorflow(tmp_path):
    """Run, not just import: the train CLI writes its splits, trains,
    evaluates and checkpoints, and the evaluate CLI scores the run, with
    none of JAX, TensorFlow, absl, OpenCV or PIL loaded."""
    out = subprocess.run(
        [sys.executable, "-c", _RUN_FIT_AND_EVALUATE, str(tmp_path / "d"),
         str(tmp_path / "wd")], cwd=REPO, capture_output=True, text=True,
        timeout=300)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip().splitlines()[-1] == "BAD []"


_RUN_JPEG_FIT_AND_PREDICT = r"""
import glob, json, sys
from jama16_retina_tpu_torch import predict, train
d, wd, images = sys.argv[1], sys.argv[2], sys.argv[3]
train.main(["--config=smoke", "--device=cpu", f"--data_dir={d}",
            f"--workdir={wd}", "--set", "train.steps=2", "--set",
            "train.eval_every=1", "--set", "model.image_size=32",
            "--set", "data.batch_size=4", "--set", "eval.batch_size=4"])
code = predict.main([f"--checkpoint_dir={wd}", f"--images={images}",
                     "--config=smoke", "--device=cpu", "--set",
                     "model.image_size=32"])
print("CODE", code)
bad = sorted(m for m in sys.modules
             if m.split(".")[0] in ("jax", "jaxlib", "flax", "optax", "orbax",
                                    "tensorflow", "absl", "cv2", "PIL")
             or m == "jama16_retina_tpu" or m.startswith("jama16_retina_tpu."))
print("BAD", bad)
"""


def test_jpeg_fit_and_predict_run_without_opencv_or_tensorflow(tmp_path):
    """A fit from JPEG splits the JAX package wrote (train at 40 px, read
    at 32 through the resize) and ``predict`` on JPEG and PNG files, with
    none of JAX, TensorFlow, absl, OpenCV or PIL loaded."""
    import shutil

    from jama16_retina_tpu.data import tfrecord as jax_tfrecord

    data = tmp_path / "d"
    for split, n, size, seed in (("train", 8, 40, 1), ("val", 6, 32, 2)):
        jax_tfrecord.write_synthetic_split(str(data), split, n, size,
                                           num_shards=2, seed=seed,
                                           encoding="jpeg")
    images = tmp_path / "imgs"
    images.mkdir()
    fixtures = os.path.join(REPO, "tests", "data", "jpeg")
    for name in ("fundus299_0.jpg", "exif6.jpg", "png_rgb.png",
                 "png_16bit.png"):
        shutil.copy(os.path.join(fixtures, name), images / name)
    out = subprocess.run(
        [sys.executable, "-c", _RUN_JPEG_FIT_AND_PREDICT, str(data),
         str(tmp_path / "wd"), str(images)], cwd=REPO, capture_output=True,
        text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-3000:]
    lines = out.stdout.strip().splitlines()
    assert lines[-1] == "BAD []" and lines[-2] == "CODE 0"
    rows = [json.loads(x) for x in lines if x.startswith('{"image"')]
    assert len(rows) == 4 and all(0 <= r["prob"] <= 1 for r in rows)


def test_no_port_module_imports_opencv_pil_tensorflow_or_jax():
    """A source check beside the import checks above: no line of the
    port imports one of these, even inside a function."""
    import re

    pattern = re.compile(r"^\s*(import|from)\s+(cv2|PIL|tensorflow|jax|"
                         r"jaxlib|flax|jama16_retina_tpu)\b", re.M)
    root = os.path.join(REPO, "jama16_retina_tpu_torch")
    offenders = []
    for dirpath, _, names in os.walk(root):
        for name in names:
            if name.endswith(".py"):
                path = os.path.join(dirpath, name)
                with open(path) as f:
                    offenders += [f"{path}: {m.group(0).strip()}"
                                  for m in pattern.finditer(f.read())]
    assert offenders == []


@pytest.fixture
def no_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)


def test_engine_defaults_to_the_card_and_raises_without_one(no_card):
    cfg = configs.get_config("smoke")
    sds = [models.build(cfg.model).state_dict()]
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ServingEngine(cfg, state_dicts=sds)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        host.prepare_images(np.zeros((1, 8, 8, 3), np.uint8), fused=True)
    assert ServingEngine(cfg, state_dicts=sds, device="cpu").n_members == 1


def test_cascade_and_distill_default_to_the_card_and_raise_without_one(
        no_card, tmp_path):
    """``assemble`` (an engine or a cascade) and a distilling fit run on
    the card unless ``device="cpu"`` is passed; nothing is written."""
    from jama16_retina_tpu_torch import trainer
    from jama16_retina_tpu_torch.models import convert
    from jama16_retina_tpu_torch.serve import assemble as assemble_lib
    from jama16_retina_tpu_torch.utils import checkpoint as ckpt_lib

    cfg = configs.get_config("smoke")
    member = str(tmp_path / "m")
    ckpt_lib.save_member(member, convert.torch_to_flax(
        models.build(cfg.model)))
    for student in ((), (member,)):
        spec = assemble_lib.EngineSpec(cfg=cfg, member_dirs=(member,),
                                       student_dirs=student)
        with pytest.raises(RuntimeError, match="no CUDA device"):
            assemble_lib.assemble(spec)
        built = assemble_lib.assemble(dataclasses.replace(spec,
                                                          device="cpu"))
        assert type(built).__name__ == ("CascadeEngine" if student
                                        else "ServingEngine")
    distill = configs.override(cfg, [f"train.distill_from={member}"])
    with pytest.raises(RuntimeError, match="no CUDA device"):
        trainer.fit(distill, str(tmp_path), str(tmp_path / "wd"))
    assert sorted(os.listdir(tmp_path)) == ["m"]


def test_fit_and_evaluate_default_to_the_card_and_raise_without_one(
        no_card, tmp_path):
    from jama16_retina_tpu_torch import evaluate, trainer

    cfg = configs.get_config("smoke")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        trainer.fit(cfg, str(tmp_path), str(tmp_path / "wd"))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        evaluate.main([f"--data_dir={tmp_path}",
                       f"--checkpoint_dir={tmp_path}"])
    assert not os.path.exists(tmp_path / "wd")


def test_ensemble_entry_points_default_to_the_card_and_raise_without_one(
        no_card, tmp_path):
    """The member-parallel driver, through ``fit_ensemble`` and directly,
    and the optimizer families' fits, raise without a card unless the
    caller passes ``device="cpu"``; nothing is written."""
    from jama16_retina_tpu_torch import trainer

    ens = configs.override(configs.get_config("smoke"), [
        "train.ensemble_size=2", "train.ensemble_parallel=true",
        "train.ensemble_parallel_force=true"])
    with pytest.raises(RuntimeError, match="no CUDA device"):
        trainer.fit_ensemble(ens, str(tmp_path), str(tmp_path / "a"))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        trainer.fit_ensemble_parallel(ens, str(tmp_path),
                                      str(tmp_path / "b"))
    for family in ("sgdm", "rmsprop", "lamb"):
        cfg = configs.override(configs.get_config("smoke"), [
            f"train.optimizer={family}", "train.gradient_clip_norm=1.0"])
        with pytest.raises(RuntimeError, match="no CUDA device"):
            trainer.fit_synthetic(cfg, str(tmp_path / family), 2)
    assert sorted(os.listdir(tmp_path)) == []


def test_kernel_wrapper_never_falls_back_from_the_card():
    imgs = torch.zeros((2, 8, 8, 3), dtype=torch.uint8)
    before = serve_preprocess.launches
    with pytest.raises(ValueError, match="requested"):
        serve_preprocess.fused_serve_preprocess(imgs, device="cuda")
    with pytest.raises(TypeError, match="uint8"):
        serve_preprocess.fused_serve_preprocess(imgs.float())
    with pytest.raises(ValueError, match=r"\[B, H, W, 3\]"):
        serve_preprocess.fused_serve_preprocess(imgs[..., :2])
    assert serve_preprocess.launches == before


def test_train_kernel_wrappers_never_fall_back_from_the_card():
    imgs = torch.zeros((2, 8, 8, 3), dtype=torch.uint8)
    a, o = torch.zeros((2, 3, 3)), torch.zeros((2, 3))
    before = (dict(color_jitter.launches), adamw.launches)
    with pytest.raises(ValueError, match="lie on"):
        color_jitter.fused_color_jitter(imgs, a.to("meta"), o)
    with pytest.raises(ValueError, match="unsupported device"):
        color_jitter.fused_normalize_color_jitter(
            imgs.to("meta"), a.to("meta"), o[:, 0].to("meta"),
            o[:, 1].to("meta"))
    p = [torch.zeros(3, device="meta")]
    with pytest.raises(ValueError, match="unsupported device"):
        adamw.fused_adamw_update(p, p, p, p, [False],
                                 torch.zeros(3, device="meta"), 0.0)
    assert (dict(color_jitter.launches), adamw.launches) == before


def test_kernel_build_raises_without_nvcc(monkeypatch, tmp_path):
    monkeypatch.setenv("CUDA_HOME", str(tmp_path))
    monkeypatch.setenv("PATH", str(tmp_path))
    assert {"serve_preprocess", "color_jitter", "adamw"} <= set(
        build.sources())
    assert build.library_path("serve_preprocess").suffix == ".so"
    with pytest.raises(RuntimeError, match="nvcc not found"):
        build.build_all()


@pytest.mark.parametrize("item,exc", [
    ("data.loader=served", NotImplementedError),
    ("obs.device_hbm_headroom_alert=0.2", NotImplementedError),
    ("serve.compile_cache_dir=/x", NotImplementedError),
    ("model.stem_s2d=true", NotImplementedError),
    ("model.remat_stem=true", NotImplementedError),
])
def test_unported_knobs_raise(item, exc):
    cfg = configs.override(configs.get_config("smoke"), [item])
    # The loader is read only when training; the other knobs are refused
    # on the serve and eval path as well.
    with pytest.raises(exc, match="ROADMAP"):
        configs.check_supported(
            cfg, training=item.startswith("data.loader"))


@pytest.mark.parametrize("item", [
    "model.head=multi", "model.arch=resnet50",
    "model.arch=efficientnet_b4"])
def test_knobs_ported_since_build_and_train_a_step(item, tmp_path):
    """Knobs that raised until the backbones and the 5-class head were
    ported: the model builds and one ``fit_synthetic`` step runs on the
    CPU (the smoke preset at 64 px, batch 2)."""
    cfg = configs.override(configs.get_config("smoke"), [
        item, "train.steps=1", "train.log_every=1", "data.batch_size=2"])
    configs.check_supported(cfg, training=True)
    from jama16_retina_tpu_torch import trainer

    # One CPU thread: the suite's worker processes share the cores, and
    # EfficientNet's many small ops slow down tenfold when each spins a
    # thread per core.
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        logits, _ = models.build(cfg.model)(torch.zeros(2, 3, 64, 64))
        res = trainer.fit_synthetic(cfg, str(tmp_path), 2, device="cpu")
    finally:
        torch.set_num_threads(threads)
    assert logits.shape == (2, cfg.model.num_classes)
    assert res["steps"] == 1 and np.isfinite(res["final_loss"])


def test_every_jax_config_field_is_ported_or_names_its_roadmap_item():
    """Each leaf field of the JAX package's ``ExperimentConfig`` is a field
    of the port, or overriding it raises ``NotImplementedError`` naming
    its ROADMAP item (``configs._NOT_PORTED`` by field or by section;
    ``configs._UNIMPLEMENTED`` for copied knobs), never the typo error.
    The data plane is item 7, multi-device item 8, the planes item 11."""
    from jama16_retina_tpu import configs as jax_configs

    def leaves(obj, prefix=""):
        for f in dataclasses.fields(obj):
            value = getattr(obj, f.name)
            if dataclasses.is_dataclass(value):
                yield from leaves(value, f"{prefix}{f.name}.")
            else:
                yield f"{prefix}{f.name}", value

    ours = dict(leaves(configs.ExperimentConfig()))
    items = {}
    for key, value in leaves(jax_configs.ExperimentConfig()):
        if key in ours:
            continue
        raw = ",".join(map(str, value)) if isinstance(value, tuple) else value
        with pytest.raises(NotImplementedError,
                           match=r"ROADMAP\.md Queue [AC]") as e:
            configs.override(configs.get_config("smoke"), [f"{key}={raw}"])
        items[key] = str(e.value)
    # 80 until the cascade, the generations and the distillation ported
    # their 7 fields (train.distill_from was copied and refused before);
    # 77 until the router, fusion, policy and scaler ported their 12; 65
    # until telemetry, tracing, the flight recorder and alerts ported
    # their 13 (and copied obs.quarantine_alert_per_s and
    # obs.device_hbm_headroom_alert, refused away from their defaults); 52
    # until faults and retries ported obs.fault_plan; 51 until the hbm
    # loader ported data.hbm_budget_bytes, data.decode_workers and
    # data.quarantine_bad_records; 48 until the tiered and rawshard
    # loaders and the autotuner ported data.autotune, data.rawshard_dir,
    # data.stage_depth and data.tiered_resident_bytes; 44 until the grain
    # loader ported data.grain_workers; 43 until the lifecycle ported its
    # 11; 32 until the data mesh ported parallel's 5 (member_axis_size and
    # serve_devices copied and refused away from their defaults),
    # eval.sharded and data.stage_per_shard.
    assert len(items) >= 25
    for key, item in (("train.ensemble_manual_data", "item 8,"),
                      ("obs.fleet_dir", "item 11"),
                      ("ingest.socket_path", "item 11"),
                      ("integrity.cache_max_bytes", "item 11"),
                      ("obs.audit.enabled", "item 11"),
                      ("obs.device_enabled", "item 11")):
        assert f"Queue A {item} " in items[key], (key, items[key])
    for key in ("train.optimizer", "train.gradient_clip_norm",
                "train.lr_scale_ref_batch", "train.recipe_curve_ref",
                "train.recipe_curve_tol", "train.ensemble_parallel",
                "train.ensemble_parallel_force", "train.distill_from",
                "serve.cascade_band", "serve.cascade_thresholds",
                "serve.cascade_student_dir", "serve.cascade_speculative",
                "serve.rollback_keep_s", "lifecycle.gate_canary_max_dev",
                "lifecycle.gate_auc_floor_delta", "serve.router_replicas",
                "serve.router_policy", "serve.router_tick_ms",
                "serve.router_shed_rows", "serve.router_batch_shed_frac",
                "serve.router_escalation_replicas", "serve.router_fusion",
                "serve.policy_from", "serve.scaler_min_replicas",
                "serve.scaler_max_replicas", "serve.scaler_window_s",
                "serve.scaler_slo_p99_ms", "obs.flush_every_s",
                "obs.trace_enabled", "obs.trace_buffer_events",
                "obs.slow_step_factor", "obs.blackbox_events",
                "obs.blackbox_keep", "obs.diagnosis_enabled",
                "obs.diagnosis_top_k", "obs.quality.psi_alert",
                "obs.quality.input_psi_alert", "obs.quality.alert_for_s",
                "obs.quality.alert_rules", "train.tensorboard",
                "train.debug", "train.profile_steps",
                "data.hbm_budget_bytes", "data.decode_workers",
                "data.quarantine_bad_records", "obs.quarantine_alert_per_s",
                "data.autotune", "data.rawshard_dir", "data.stage_depth",
                "data.tiered_resident_bytes", "data.stage_per_shard",
                "eval.sharded", "parallel.data_axis", "parallel.num_devices",
                "parallel.model_axis_size", "parallel.member_axis_size",
                "parallel.serve_devices"):
        assert key in ours
    # The lifecycle's fields, refused until it was ported: each override
    # is accepted and reaches cfg.lifecycle, with the JAX default.
    lifecycle = [k for k in ours if k.startswith("lifecycle.")]
    assert not [k for k in items if k.startswith("lifecycle.")]
    assert len(lifecycle) == 13
    jax_lc = jax_configs.ExperimentConfig().lifecycle
    for key, raw, want in (
            ("lifecycle.enabled", "true", True),
            ("lifecycle.trigger_reasons", "quality_drift,slo_breach",
             ("quality_drift", "slo_breach")),
            ("lifecycle.retrain_steps", "40", 40),
            ("lifecycle.gate_canary_max_dev", "0.3", 0.3),
            ("lifecycle.gate_parity_psi_max", "0.25", 0.25),
            ("lifecycle.gate_auc_floor_delta", "0.02", 0.02),
            ("lifecycle.gate_eval_rows", "64", 64),
            ("lifecycle.shadow_fraction", "0.5", 0.5),
            ("lifecycle.shadow_requests", "3", 3),
            ("lifecycle.shadow_wait_s", "2.5", 2.5),
            ("lifecycle.watch_rules", "quality.canary_ok < 1,serve.x > 2",
             ("quality.canary_ok < 1", "serve.x > 2")),
            ("lifecycle.watch_probes", "5", 5),
            ("lifecycle.watch_interval_s", "1.5", 1.5)):
        field = key.split(".", 1)[1]
        assert ours[key] == getattr(jax_lc, field), key
        cfg = configs.override(configs.get_config("smoke"), [f"{key}={raw}"])
        configs.check_supported(cfg)
        assert getattr(cfg.lifecycle, field) == want, key
        lifecycle.remove(key)
    assert not lifecycle


def test_unknown_arch_or_head_raises():
    for item in ("model.arch=vgg16", "model.head=ordinal"):
        cfg = configs.override(configs.get_config("smoke"), [item])
        with pytest.raises(ValueError, match="unknown model"):
            configs.check_supported(cfg)
    with pytest.raises(ValueError, match="unknown arch"):
        models.build(configs.override(configs.get_config("smoke"),
                                      ["model.arch=vgg16"]).model)


@pytest.mark.parametrize("item", [
    "train.steps=x", "serve.max_wait_ms=x", "model.aux_weight=x",
    "train.stpes=3", "serve", "serve.max_batch", "serve.max_batch.x=1",
])
def test_unknown_or_malformed_overrides_raise(item):
    with pytest.raises(ValueError):
        configs.override(configs.get_config("smoke"), [item])


@pytest.mark.parametrize("item", [
    "serve.compile_cache_dir=/x", "obs.http_port=9090",
    "obs.fleet_role=x", "obs.fleet_dir=/x",
    "obs.audit.enabled=true", "obs.device_enabled=true"])
def test_refused_serving_and_obs_knobs_name_their_roadmap_item(item):
    with pytest.raises(NotImplementedError, match="ROADMAP.md Queue A item"):
        configs.check_supported(
            configs.override(configs.get_config("smoke"), [item]))


def test_serving_knobs_take_the_jax_names_and_defaults():
    """The serve and obs.quality fields the port reads, against the JAX
    package's ServeConfig and QualityConfig."""
    from jama16_retina_tpu import configs as jax_configs

    ours, theirs = configs.ExperimentConfig(), jax_configs.ExperimentConfig()
    for f in dataclasses.fields(ours.serve):
        assert getattr(ours.serve, f.name) == getattr(theirs.serve, f.name)
    assert ours.obs.quality == configs.QualityConfig(
        **dataclasses.asdict(theirs.obs.quality))
    assert ours.obs.enabled is theirs.obs.enabled is True
    cfg = configs.override(configs.get_config("smoke"), [
        "serve.dtype=int8", "serve.member_parallel=true",
        "serve.max_wait_ms=2.5", "serve.shed_queue_depth=4",
        "serve.shed_in_flight=9", "serve.default_deadline_ms=250",
        "serve.dtype_canary_max_dev=0.01", "obs.quality.enabled=true",
        "obs.quality.window_scores=64", "obs.quality.canary_atol=1e-6"])
    configs.check_supported(cfg)
    assert (cfg.serve.dtype, cfg.serve.member_parallel, cfg.serve.max_wait_ms,
            cfg.serve.default_deadline_ms) == ("int8", True, 2.5, 250.0)
    assert cfg.obs.quality.window_scores == 64


def test_overrides_parse_like_the_jax_package():
    cfg = configs.override(configs.get_config("eyepacs_binary"), [
        "serve.bucket_sizes=8,16", "eval.tta=true", "model.image_size=139",
        "serve.fused_preprocess=1"])
    assert cfg.serve.bucket_sizes == (8, 16) and cfg.eval.tta is True
    assert cfg.model.image_size == 139 and cfg.serve.fused_preprocess is True
    assert configs.get_config("eyepacs_binary_quality").eval.tta is True
    with pytest.raises(ValueError, match="unknown config preset"):
        configs.get_config("icdr7")


# ---------------------------------------------------------------------------
# Fault sites: the port's analog of graftlint's ``faults`` rule
# ---------------------------------------------------------------------------


def _fired_sites() -> "dict[str, list[str]]":
    """{site: [file:line, ...]} of every literal site at a
    ``faultinject.check("...")`` or ``faultinject.corrupt("...", ...)``
    call in the port's sources and ``chip_smoke.py``; a call whose site is
    not a literal is listed under ``None``."""
    import ast

    from jama16_retina_tpu_torch.obs import faultinject

    files = [os.path.join(REPO, "chip_smoke.py")]
    root = os.path.join(REPO, "jama16_retina_tpu_torch")
    for dirpath, _, names in os.walk(root):
        files += [os.path.join(dirpath, n) for n in names if n.endswith(".py")]
    out: dict = {}
    for path in files:
        if path.endswith(os.path.join("obs", "faultinject.py")):
            continue  # the module itself: check/corrupt take a parameter
        with open(path) as f:
            tree = ast.parse(f.read())
        for node in ast.walk(tree):
            if not (isinstance(node, ast.Call)
                    and isinstance(node.func, ast.Attribute)
                    and node.func.attr in ("check", "corrupt")
                    and isinstance(node.func.value, ast.Name)
                    and node.func.value.id == "faultinject"):
                continue
            arg = node.args[0] if node.args else None
            site = (arg.value if isinstance(arg, ast.Constant)
                    and isinstance(arg.value, str) else None)
            out.setdefault(site, []).append(
                f"{os.path.relpath(path, REPO)}:{node.lineno}")
    assert set(faultinject.PORT_SITES) | set(faultinject.UNFIRED) == set(
        faultinject.SITES)
    return out


def test_fault_sites_are_the_jax_sites():
    """The port declares the reference's sites, name for name, in its
    order, so a plan the reference accepts parses here."""
    from jama16_retina_tpu.obs import faultinject as jax_faultinject
    from jama16_retina_tpu_torch.obs import faultinject

    assert list(faultinject.SITES) == list(jax_faultinject.SITES)
    assert faultinject._KINDS == jax_faultinject._KINDS
    assert set(faultinject._ERRORS) == set(jax_faultinject._ERRORS)


@pytest.mark.parametrize("rule", ["declared", "seamed", "refused"])
def test_fault_site_population(rule):
    """``declared``: every literal site at a seam is in ``SITES`` and no
    seam passes a computed site. ``seamed``: every site the port fires
    (``PORT_SITES``) has at least one seam. ``refused``: no site the
    port refuses to arm (``UNFIRED``) has a seam, and each names a
    ROADMAP item."""
    from jama16_retina_tpu_torch.obs import faultinject

    fired = _fired_sites()
    if rule == "declared":
        assert None not in fired, fired.get(None)
        assert set(fired) <= set(faultinject.SITES), sorted(
            set(fired) - set(faultinject.SITES))
    elif rule == "seamed":
        assert set(faultinject.PORT_SITES) <= set(fired), sorted(
            set(faultinject.PORT_SITES) - set(fired))
    else:
        assert not set(faultinject.UNFIRED) & set(fired)
        assert all(item.startswith("Queue A item ")
                   for item in faultinject.UNFIRED.values())


def test_obs_fault_plan_is_ported_and_an_unfired_site_names_its_item():
    """``obs.fault_plan`` takes the JAX field's default and type; a plan in
    it that arms a site the port cannot fire yet raises naming the item,
    at the run's and the engine's arming point."""
    from jama16_retina_tpu import configs as jax_configs
    from jama16_retina_tpu_torch.obs import faultinject

    assert (configs.ExperimentConfig().obs.fault_plan
            == jax_configs.ExperimentConfig().obs.fault_plan == "")
    spec = json.dumps({"audit.seal": {"kind": "error"}})
    cfg = configs.override(configs.get_config("smoke"),
                           [f"obs.fault_plan={spec}"])
    configs.check_supported(cfg)
    try:
        with pytest.raises(NotImplementedError,
                           match=r"ROADMAP\.md Queue A item 11 \(part 5"):
            faultinject.arm_from_env_or_config(cfg.obs.fault_plan)
        assert faultinject.active_plan() is None
    finally:
        faultinject.disarm()


def test_a_lifecycle_fault_plan_arms_and_fires(tmp_path):
    """The ``lifecycle.*`` sites, refused until the lifecycle was ported,
    arm from ``obs.fault_plan`` and fire: a ``lifecycle.gate`` plan fails
    the controller's GATE closed, with the injected error as its
    verdict."""
    from jama16_retina_tpu_torch.lifecycle import (GateVerdict,
                                                   LifecycleController)
    from jama16_retina_tpu_torch.obs import faultinject
    from jama16_retina_tpu_torch.obs.registry import Registry

    spec = json.dumps({"lifecycle.gate": {"kind": "error", "on_calls": [1],
                                          "error": "RuntimeError"}})
    cfg = configs.override(configs.get_config("smoke"), [
        f"obs.fault_plan={spec}", "lifecycle.enabled=true"])
    try:
        faultinject.arm_from_env_or_config(cfg.obs.fault_plan)
        ctl = LifecycleController(
            cfg, str(tmp_path), registry=Registry(),
            retrain_fn=lambda c, root: ["cand"],
            gate_fns=[lambda c, cand: GateVerdict("ok", True)],
            live_member_dirs=["live"], sleep=lambda s: None)
        ctl.trigger(reason="quality_drift")
        assert ctl.run() == "ROLLBACK"
        assert faultinject.active_plan().counts()["lifecycle.gate"] == {
            "calls": 1, "fires": 1}
    finally:
        faultinject.disarm()
    gate = ctl.journal.find("GATE")
    assert gate["passed"] is False
    assert gate["verdicts"][0]["name"] == "gate_error"
    assert "RuntimeError: injected fault" in gate["verdicts"][0]["detail"]
