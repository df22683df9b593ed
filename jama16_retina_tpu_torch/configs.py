"""The slice of ``jama16_retina_tpu/configs.py`` that the port reads
(serving, training, eval, checkpoints and resume of every preset of the
JAX package: the binary and 5-class heads, Inception-v3, ResNet-50,
EfficientNet-B4 and the smoke ``tiny_cnn``; the serving knobs; the
telemetry, tracing, flight-recorder and alert planes of ``obs``).

Field names, defaults, preset names and the dotted ``--set`` syntax are
those of the JAX package, so one override list configures both. Only the
fields this port reads are copied; an override naming any other field
raises. Knobs that exist here but are not implemented yet raise
``NotImplementedError`` from ``check_supported`` when set away from their
default, naming the ROADMAP item that will bring them.
"""

from __future__ import annotations

import dataclasses
import difflib
from typing import Sequence


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    # inception_v3 | resnet50 | efficientnet_b4 | tiny_cnn
    arch: str = "inception_v3"
    head: str = "binary"  # binary (referable DR) | multi (5 ICDR grades)
    image_size: int = 299
    dropout_rate: float = 0.2
    compute_dtype: str = "bfloat16"
    aux_head: bool = True
    aux_weight: float = 0.4
    stem_s2d: bool = False
    remat_stem: bool = False

    @property
    def num_classes(self) -> int:
        return 5 if self.head == "multi" else 1


@dataclasses.dataclass(frozen=True)
class DataConfig:
    # Split roots: the train CLI defaults --data_dir to train_dir, the
    # evaluate CLI to test_dir.
    train_dir: str = ""
    test_dir: str = ""
    batch_size: int = 32
    # Train-stream loader: "tfdata" names the TFRecord stream
    # (data/pipeline.py); "hbm" decodes the split once and keeps it on the
    # card (data/hbm_pipeline.py); "tiered" keeps as many rows on the card
    # as the budget admits and streams the rest through the host decode
    # (data/tiered_pipeline.py); "rawshard" is "tiered" reading shards
    # transcoded ahead of time (data/rawshard.py); "grain" is the
    # reference's grain loader, its order and iterator state bitwise
    # (data/grain_pipeline.py). The reference's served loader is not
    # ported.
    loader: str = "tfdata"
    # Grain loader only: worker processes that decode and batch (0 = in
    # the trainer's process). With workers a resume restores the iterator
    # state persisted beside each checkpoint (grain_state/<step>.json),
    # not the (seed, step) derivation, which has no closed form across
    # workers (data/grain_pipeline.state_at_step).
    grain_workers: int = 0
    # Closed-loop ingest autotuner (data/autotune.py): the train loops
    # observe their own stall attribution over tumbling log windows and
    # adjust decode_workers / stage_depth / prefetch depth ONLINE
    # (hill-climb with hysteresis, HBM-budget clamped). Every tunable knob
    # is content-invariant, so a tuned run's batches — and final eval
    # metrics — are bit-identical to the same seed with hand-set knobs.
    # Off by default (the hand-set values below then apply verbatim).
    autotune: bool = False
    # Memory-limit override (bytes, before the 0.6 budget fraction) for
    # the hbm loader's size gate and the eval caches; 0 = the card's total
    # memory (hbm_pipeline.hbm_budget_bytes; 8 GB assumed on the CPU).
    hbm_budget_bytes: int = 0
    # Directory of ahead-of-time transcoded raw shards for
    # data.loader=rawshard. Empty = <data_dir>/rawshard<image_size>,
    # the default python -m jama16_retina_tpu_torch.transcode_shards
    # writes to.
    rawshard_dir: str = ""
    # Host decode threads for the tiered loader's streamed tier and the
    # hbm/tiered one-time resident load (grain_pipeline.ParallelDecoder);
    # 0 = one per core up to 8, leaving one. Batches do not depend on it.
    decode_workers: int = 0
    # Tiered loader only: how many batches the loader keeps decoded +
    # dispatched AHEAD of consumption (its internal staging queue, on
    # top of prefetch_batches). 0 = auto: max(2, prefetch_batches).
    stage_depth: int = 0
    # Tiered loader only: TOTAL bytes of card memory the resident tier
    # may pin. -1 = auto-derive from the card's budget
    # (hbm_pipeline.hbm_budget_bytes); 0 = pin nothing (pure streamed
    # mode — bit-identical batch sequence to
    # tiered_pipeline.streamed_batches); >0 = explicit cap (what the
    # tests use for reproducible partial residency).
    tiered_resident_bytes: int = -1
    # A record that fails to read or decode in the hbm, tiered or rawshard
    # loader (or the transcode) is counted (data.quarantined{,.reason}) and replaced by the next decodable
    # record; False raises instead.
    quarantine_bad_records: bool = True
    # Augmentation (data/augment.py): flips and the square-only transpose,
    # brightness, contrast about the per-image mean, YIQ saturation/hue.
    augment: bool = True
    flip: bool = True
    brightness_delta: float = 0.25
    contrast_range: tuple[float, float] = (0.75, 1.25)
    saturation_range: tuple[float, float] = (0.8, 1.2)
    hue_delta: float = 0.05
    rotate: bool = True
    # Colour half of the augment through kernel B1 (ops/color_jitter.py).
    use_pallas: bool = False
    # Train batches staged on the device ahead of the step
    # (data/pipeline.DevicePrefetch); 0 reads each batch on the step's
    # thread.
    prefetch_batches: int = 2
    # Stage each device's row block of a batch on its own. One rank owns
    # one device and stages only its own block, so under a data mesh this
    # is what every run does; accepted for the reference's configs.
    stage_per_shard: bool = False
    # Port-only: reader processes decoding train batches in parallel
    # (the counterpart of tf.data's parallel parse; at least 1). Batches
    # keep their order at any count.
    readers: int = 1


@dataclasses.dataclass(frozen=True)
class TrainConfig:
    steps: int = 30000
    eval_every: int = 500
    log_every: int = 50
    learning_rate: float = 1e-3
    lr_schedule: str = "cosine"  # constant | cosine | warmup_cosine
    warmup_steps: int = 500
    weight_decay: float = 4e-5
    # adamw | sgdm | rmsprop | lamb (optim.py), each optax's chain.
    optimizer: str = "adamw"
    momentum: float = 0.9
    # The large-batch recipe: with a reference batch R > 0 the peak
    # learning rate becomes learning_rate * data.batch_size / R, resolved
    # once at fit entry (train_lib.resolve_large_batch).
    lr_scale_ref_batch: int = 0
    # A pinned baseline run's metrics.jsonl: a recipe run (lamb, or a
    # scaled learning rate) whose val AUC drifts beyond recipe_curve_tol
    # of it at a matching step is refused (train_lib.RecipeCurveRejected).
    # Empty = ungated (logged).
    recipe_curve_ref: str = ""
    recipe_curve_tol: float = 0.02
    # fp32 | bf16: bf16 runs forward and backward on a bfloat16 view of
    # float32 master weights (train_lib.compute_grads).
    dtype: str = "fp32"
    # A pinned fp32 run's metrics.jsonl: a bf16 run whose val AUC drifts
    # beyond dtype_curve_tol of it at a matching step is refused
    # (train_lib.DtypeCurveRejected). Empty = ungated (logged).
    dtype_curve_ref: str = ""
    dtype_curve_tol: float = 0.02
    # Kernels B2 (normalize + colour jitter, means in-kernel) and B3
    # (AdamW, one multi-tensor launch) in place of B1 and the plain AdamW.
    use_pallas_fused: bool = False
    accum_steps: int = 1
    gradient_clip_norm: float = 0.0
    label_smoothing: float = 0.0
    ema_decay: float = 0.0
    # Early stopping on val AUC: stop after this many evals without an
    # improvement above min_delta.
    early_stop_patience: int = 10
    min_delta: float = 1e-4
    # The train CLI's default workdir; best/ keeps the top max_to_keep
    # steps by val AUC, latest/ the newest.
    checkpoint_dir: str = "/tmp/retina_ckpt"
    max_to_keep: int = 3
    resume: bool = False
    # Save a checkpoint every N-th eval (the last step, a stopping eval
    # and, with save_first_eval, the first eval always save).
    save_every_evals: int = 1
    save_first_eval: bool = True
    seed: int = 0
    ensemble_size: int = 1
    # Train the ensemble_size members in one stacked step
    # (trainer.fit_ensemble_parallel) instead of one after another. On
    # one device the members are trained in turn anyway, with the reason
    # logged, unless ensemble_parallel_force.
    ensemble_parallel: bool = False
    ensemble_parallel_force: bool = False
    init_from: str = ""
    # A torch.profiler capture of this many steps (from step 10, clamped
    # inside short runs) into <workdir>/profile as a Chrome trace.
    profile_steps: int = 0
    # Mirror the numeric fields of step-indexed records into <workdir>/tb
    # as TensorBoard scalars (utils/logging.py).
    tensorboard: bool = False
    # Steps under torch.autograd.detect_anomaly(check_nan=True) with the
    # loss checked too: the first non-finite value raises
    # FloatingPointError naming the step.
    debug: bool = False
    # Teacher ensemble root (or one member dir): the student trains
    # against its members' averaged soft scores on each batch's clean
    # images instead of the hard grades (trainer.fit). Empty: hard labels.
    distill_from: str = ""
    async_save: bool = False
    eval_overlap: bool = False


@dataclasses.dataclass(frozen=True)
class ParallelConfig:
    """The data mesh (``parallel/mesh.py``): one rank a replica, each on
    its own device, launched by ``torch.distributed.run`` (or the train
    CLI's ``--fake_devices`` on the CPU)."""
    # Name of the data axis batches shard over.
    data_axis: str = "data"
    # Ranks of the mesh: 0 = every rank of the launch.
    num_devices: int = 0
    # The reference's seam for a model axis; read nowhere, as there.
    model_axis_size: int = 1
    # The member axis of a member-parallel mesh and the serving mesh:
    # refused away from their defaults (Queue A item 8, part 2).
    member_axis_size: int = 0
    serve_devices: int = 0


@dataclasses.dataclass(frozen=True)
class EvalConfig:
    batch_size: int = 64
    # Operating points: thresholds chosen on the ROC curve at these
    # specificities.
    operating_specificities: tuple[float, float] = (0.87, 0.98)
    # Member dirs whose probabilities the evaluate CLI averages when it
    # is given none.
    ensemble_dirs: tuple[str, ...] = ()
    # Average probabilities over the 4 flip views (identity/h/v/hv).
    tta: bool = False
    # Under a data mesh of more than one rank, each rank decodes only every
    # P-th record of an eval split (data/pipeline.eval_batches_sharded)
    # instead of the whole split; the probabilities and the AUC are the
    # same.
    sharded: bool = False


@dataclasses.dataclass(frozen=True)
class ServeConfig:
    # Largest chunk one engine forward serves; larger requests are chunked.
    # The micro-batcher closes a window at this many rows.
    max_batch: int = 64
    # Longest a request waits in the micro-batcher for co-riders (ms).
    max_wait_ms: float = 5.0
    # Padded batch shapes; empty = powers of two from 8 up to max_batch.
    bucket_sizes: tuple[int, ...] = ()
    # Members forward in one vmap over their stacked weights (float-
    # equivalent to the default one-after-another form, not bitwise).
    member_parallel: bool = False
    # Host threads for fundus normalization (0 = auto).
    host_workers: int = 0
    # Micro-batcher admission control (0 = off): requests waiting, and
    # requests admitted but unresolved, beyond which submit raises
    # serve.batcher.Overloaded.
    shed_queue_depth: int = 0
    shed_in_flight: int = 0
    # Deadline given at submit to a request that names none (ms; 0 =
    # none). An expired request fails with DeadlineExceeded at window
    # close, before any device work.
    default_deadline_ms: float = 0.0
    # fp32 | bf16 | int8 weights on the device (serve/quantize.py).
    dtype: str = "fp32"
    # Max |score - pinned canary| a bf16/int8 engine may show at
    # construction (binds only with a pinned obs.quality canary).
    dtype_canary_max_dev: float = 0.05
    compile_cache_dir: str = ""
    # Normalize each padded chunk with the fused CUDA kernel
    # (ops/serve_preprocess.py) and keep the per-image input statistics.
    fused_preprocess: bool = False
    # The distilled cascade (serve/cascade.py): rows whose student score
    # lies within cascade_band of any of cascade_thresholds (empty means
    # (0.5,)) are scored again by the full ensemble. predict serves a
    # cascade when cascade_student_dir names the student; with
    # cascade_speculative the ensemble scores the whole request beside
    # the student and the escalated rows take its scores.
    cascade_band: float = 0.05
    cascade_thresholds: tuple[float, ...] = ()
    cascade_student_dir: str = ""
    cascade_speculative: bool = False
    # Seconds a reload keeps the previous generation on the device for
    # an instant rollback (0: none is kept).
    rollback_keep_s: float = 900.0
    # The front-door router (serve/router.py). Replicas it builds from
    # its replica factory when it is handed no engines.
    router_replicas: int = 1
    # Bin -> replica: least_in_flight (fewest rows queued or scoring) or
    # bucket_affinity (prefer a replica that already served the bin's
    # bucket, least in flight among those).
    router_policy: str = "least_in_flight"
    # How often queued rows are re-binned across bucket boundaries (ms).
    # A full bucket dispatches at the next tick; only a partial remainder
    # waits out max_wait_ms.
    router_tick_ms: float = 2.0
    # Rows queued plus in flight beyond which submits raise Overloaded
    # (0 = off): interactive at this, batch at router_batch_shed_frac
    # of it, so batch sheds first.
    router_shed_rows: int = 0
    router_batch_shed_frac: float = 0.5
    # Engines of the shared full-ensemble EscalationPool behind student
    # cascade replicas (predict --replicas with cascade_student_dir).
    router_escalation_replicas: int = 1
    # Bins may mix rows of different models (serve/fusion.py): one
    # forward over the concatenated members when the engines' programs
    # agree, one call per model otherwise.
    router_fusion: bool = False
    # A sealed serving-policy artifact (serve/policy.py); the knobs it
    # derives fill fields still at their defaults. Empty = off.
    policy_from: str = ""
    # The autoscaler (serve/scaler.py): bounds of the desired replica
    # count, its window (s) and the p99 SLO it treats as hot (ms; 0 off).
    scaler_min_replicas: int = 1
    scaler_max_replicas: int = 8
    scaler_window_s: float = 10.0
    scaler_slo_p99_ms: float = 0.0


@dataclasses.dataclass(frozen=True)
class QualityConfig:
    """The quality monitor (obs/quality.py): drift of live scores and
    input statistics against a reference profile, and the golden-set
    canary. Off by default."""

    enabled: bool = False
    # Reference profile to compare against (evaluate --profile_out).
    profile_path: str = ""
    # fit/fit_ensemble write the run's own reference profile here.
    profile_out: str = ""
    # Scores per tumbling drift window.
    window_scores: int = 256
    # Histogram bins over [0, 1], for scores and input statistics.
    score_bins: int = 20
    # The alert plane (obs/alerts.py): the built-in drift and canary
    # rules fire above these PSIs (and on a failed canary) once they have
    # held alert_for_s seconds; alert_rules are user rules in its grammar.
    psi_alert: float = 0.2
    input_psi_alert: float = 0.25
    alert_for_s: float = 0.0
    alert_rules: tuple[str, ...] = ()
    # Golden-set canary .npz (images, optional pinned scores); empty off.
    canary_path: str = ""
    # Seconds between canary runs on live requests (<= 0: explicit only).
    canary_every_s: float = 300.0
    # 0 compares canary scores exactly; > 0 allows this deviation.
    canary_atol: float = 0.0


@dataclasses.dataclass(frozen=True)
class ObsConfig:
    """Telemetry, tracing, the flight recorder and alerts (obs/). Off: every
    metric op, span and trace event is one branch, no monitor is built and
    nothing is exported."""

    enabled: bool = True
    # Seconds between telemetry flushes (the `telemetry` and `heartbeat`
    # records and <workdir>/telemetry.prom), checked at the train loop's
    # logging cadence and predict's blocks.
    flush_every_s: float = 60.0
    # Event tracing (obs/trace.py): per-thread rings of this many events,
    # the blackbox's source.
    trace_enabled: bool = True
    trace_buffer_events: int = 4096
    # A loop iteration above this factor x the rolling median of recent
    # steps dumps a blackbox and asks for one profiler capture (<= 0 off).
    slow_step_factor: float = 4.0
    # Newest trace events a blackbox dump carries, and the newest dump
    # directories kept under <workdir>/blackbox (<= 0 keeps all).
    blackbox_events: int = 1024
    blackbox_keep: int = 20
    # The critical-path verdict (obs/criticalpath.py) in every dump, with
    # this many slowest waterfalls of each kind.
    diagnosis_enabled: bool = True
    diagnosis_top_k: int = 3
    # The data_quarantine rule: rate(data.quarantined) above this many a
    # second (the hbm loader's poison quarantine); <= 0 disables it.
    quarantine_alert_per_s: float = 0.5
    # The hbm_pressure rule's threshold; the port does not publish its
    # metric (device.hbm.headroom_frac) yet, so the rule stays inactive,
    # as the reference's does on a backend without it.
    device_hbm_headroom_alert: float = 0.1
    # Deterministic fault-injection plan (obs/faultinject.py): a JSON spec
    # or a path to one, armed at run start and engine construction. The
    # JAMA16_FAULTS variable wins over it. Empty: nothing armed, and every
    # fault seam costs one branch.
    fault_plan: str = ""
    quality: QualityConfig = dataclasses.field(default_factory=QualityConfig)


@dataclasses.dataclass(frozen=True)
class LifecycleConfig:
    """The drift-to-retrain lifecycle (``lifecycle/``; the JAX package's
    ``lifecycle`` section, field for field): DRIFT_DETECTED -> RETRAIN
    (warm-start fine-tune) -> GATE (named candidate gates) ->
    STAGED_ROLLOUT (shadow + promote) -> WATCH (post-swap regression
    window) -> COMMIT or ROLLBACK, every transition journaled under
    ``<workdir>/lifecycle/``.

    Off by default: the controller runs where an operator wires it
    (``python -m jama16_retina_tpu_torch.lifecycle_run`` or an
    ``AlertManager(on_fire=)`` trigger). The cascade's go-live gate reads
    ``gate_canary_max_dev`` and ``gate_auc_floor_delta`` too.
    """

    enabled: bool = False
    # Alert reasons that open a cycle through the AlertManager(on_fire=)
    # seam; other reasons only log.
    trigger_reasons: tuple[str, ...] = ("quality_drift",)
    # Fine-tune steps of a RETRAIN candidate (0 = the full train.steps).
    retrain_steps: int = 0
    # GATE bounds. Max |candidate - pinned canary| score deviation: a
    # loose sanity bound against degenerate candidates, not the reload's
    # byte-stability atol. (The cascade: max |cascade - pinned canary|
    # referable-score deviation.)
    gate_canary_max_dev: float = 0.2
    # Max debiased PSI of the candidate's val-split score histogram
    # against the loaded reference profile (-1 = obs.quality.psi_alert).
    gate_parity_psi_max: float = -1.0
    # Candidate val AUC must be >= the live model's minus this delta.
    # (The cascade: its AUC, and sensitivity/specificity at every cascade
    # threshold, may fall at most this far below the full ensemble's.)
    gate_auc_floor_delta: float = 0.01
    # Val rows the parity and AUC gates score (0 = all).
    gate_eval_rows: int = 0
    # STAGED_ROLLOUT: the share of live requests shadow-scored through
    # the candidate (every Nth), the shadowed requests to collect before
    # the promote, and the seconds to wait for them (on a timeout the
    # promote goes ahead on what evidence there is, loudly).
    shadow_fraction: float = 0.25
    shadow_requests: int = 8
    shadow_wait_s: float = 60.0
    # WATCH: rules (obs/alerts.py grammar, plain metric/threshold forms:
    # rate() and 'for' are refused at construction) probed against the
    # live registry; any rule true is a regression -> ROLLBACK. The
    # default watches the golden canary, which the promote re-pins to
    # the candidate.
    watch_rules: tuple[str, ...] = ("quality.canary_ok < 1",)
    watch_probes: int = 3
    watch_interval_s: float = 30.0


@dataclasses.dataclass(frozen=True)
class ExperimentConfig:
    name: str = "eyepacs_binary"
    model: ModelConfig = dataclasses.field(default_factory=ModelConfig)
    data: DataConfig = dataclasses.field(default_factory=DataConfig)
    train: TrainConfig = dataclasses.field(default_factory=TrainConfig)
    parallel: ParallelConfig = dataclasses.field(
        default_factory=ParallelConfig)
    eval: EvalConfig = dataclasses.field(default_factory=EvalConfig)
    serve: ServeConfig = dataclasses.field(default_factory=ServeConfig)
    obs: ObsConfig = dataclasses.field(default_factory=ObsConfig)
    lifecycle: LifecycleConfig = dataclasses.field(
        default_factory=LifecycleConfig)

    def replace(self, **sections) -> "ExperimentConfig":
        return dataclasses.replace(self, **sections)


def _preset_eyepacs_binary() -> ExperimentConfig:
    return ExperimentConfig(
        name="eyepacs_binary", data=DataConfig(use_pallas=True))


def _preset_eyepacs_binary_quality() -> ExperimentConfig:
    base = _preset_eyepacs_binary()
    return base.replace(
        name="eyepacs_binary_quality",
        train=dataclasses.replace(
            base.train, lr_schedule="warmup_cosine", ema_decay=0.999,
            label_smoothing=0.1),
        eval=EvalConfig(tta=True),
    )


def _preset_messidor2_eval() -> ExperimentConfig:
    return ExperimentConfig(
        name="messidor2_eval",
        eval=EvalConfig(operating_specificities=(0.87, 0.98)),
    )


def _preset_icdr5() -> ExperimentConfig:
    return ExperimentConfig(
        name="icdr5",
        model=ModelConfig(head="multi"),
        train=TrainConfig(label_smoothing=0.1),
    )


def _preset_ensemble10() -> ExperimentConfig:
    return ExperimentConfig(name="ensemble10",
                            train=TrainConfig(ensemble_size=10))


def _preset_resnet50() -> ExperimentConfig:
    return ExperimentConfig(name="resnet50",
                            model=ModelConfig(arch="resnet50"))


def _preset_efficientnet_b4() -> ExperimentConfig:
    return ExperimentConfig(
        name="efficientnet_b4",
        # B4 compound scaling specifies dropout 0.4 (vs the generic 0.2).
        model=ModelConfig(arch="efficientnet_b4", dropout_rate=0.4),
    )


def _preset_smoke() -> ExperimentConfig:
    return ExperimentConfig(
        name="smoke",
        model=ModelConfig(arch="tiny_cnn", image_size=64, aux_head=False),
        data=DataConfig(batch_size=8),
        train=TrainConfig(steps=50, eval_every=25, log_every=10,
                          learning_rate=3e-3, warmup_steps=5,
                          early_stop_patience=100),
        eval=EvalConfig(batch_size=8),
    )


PRESETS = {
    "eyepacs_binary": _preset_eyepacs_binary,
    "eyepacs_binary_quality": _preset_eyepacs_binary_quality,
    "messidor2_eval": _preset_messidor2_eval,
    "icdr5": _preset_icdr5,
    "ensemble10": _preset_ensemble10,
    "resnet50": _preset_resnet50,
    "efficientnet_b4": _preset_efficientnet_b4,
    "smoke": _preset_smoke,
}

# The multi-device forms still to port: the member axis, the serving mesh,
# manual data, the other loaders, accumulation and distillation across
# ranks.
MESH_PART_2 = "Queue A item 8, part 2"
# Knob -> (its default, the ROADMAP item that will implement it).
_UNIMPLEMENTED = {
    ("model", "stem_s2d"): (False, "Queue A item 2 (stem_s2d)"),
    ("model", "remat_stem"): (False, "Queue A item 2 (remat_stem)"),
    ("serve", "compile_cache_dir"): (
        "", "Queue A item 9 (compile cache / CUDA graphs)"),
    ("obs", "device_hbm_headroom_alert"): (
        0.1, "Queue A item 11 (part 4: the device plane, whose "
             "device.hbm.headroom_frac gauge the rule reads)"),
    ("parallel", "member_axis_size"): (
        0, MESH_PART_2 + " (the member axis of a member-parallel mesh)"),
}
_PLANES = "Queue A item 11 (planes)"
# JAX-package fields (or whole sections) this port has no copy of yet.
# Overriding one raises NotImplementedError naming its item; any other
# unknown field is a typo and raises ValueError.
_NOT_PORTED = {
    "data.shuffle_buffer": "Queue C (the port's train stream shuffles "
                           "the whole split; no buffer)",
    "train.ensemble_manual_data": MESH_PART_2 + " (the manual data axis "
                                  "of a member-parallel mesh)",
    "ingest": _PLANES + " (the ingest service)",
    "integrity": _PLANES + " (integrity: caches, telemetry retention)",
    # The obs fields of the planes still to port; obs.audit covers its
    # own fields.
    "obs.device_enabled": "Queue A item 11 (part 4: the device plane, "
                          "obs/device.py)",
    **dict.fromkeys(
        ("obs.fleet_dir", "obs.fleet_role", "obs.fleet_keep_segments",
         "obs.fleet_rules"),
        "Queue A item 11 (part 5: the fleet plane, obs/fleet.py)"),
    "obs.http_port": "Queue A item 11 (part 5: obs/httpd.py, the HTTP "
                     "endpoint)",
    "obs.audit": "Queue A item 11 (part 5: the audit plane, obs/audit.py)",
}
# Fields of this port that the JAX package's configs.py does not have.
PORT_FIELDS = {("data", "readers")}
# data.loader values: the TFRecord stream, the card-resident split, the
# tiered loader over records or transcoded shards and the grain loader
# are ported; the served loader comes with the ingest service.
_LOADERS = ("tfdata", "hbm", "tiered", "rawshard", "grain")
_LOADER_ITEM = "Queue A item 11, part 5 (the served loader)"
_ARCHS = ("inception_v3", "resnet50", "efficientnet_b4", "tiny_cnn")
_HEADS = ("binary", "multi")
_DTYPES = ("float32", "bfloat16")
_SCHEDULES = ("constant", "cosine", "warmup_cosine")
_OPTIMIZERS = ("adamw", "sgdm", "rmsprop", "lamb")


def check_supported(cfg: ExperimentConfig, training: bool = False) -> None:
    """Raise on any knob this port cannot honour yet, instead of
    silently serving or training something other than what was
    configured. The ``train`` section's knobs are checked only when
    ``training``: serving a member never reads them."""
    for (section, field), (default, item) in _UNIMPLEMENTED.items():
        sec = cfg
        for part in section.split("."):
            sec = getattr(sec, part)
        value = getattr(sec, field)
        if value != default:
            raise NotImplementedError(
                f"{section}.{field}={value!r} is not ported yet; see "
                f"ROADMAP.md {item}"
            )
    if cfg.parallel.serve_devices > 1:
        raise NotImplementedError(
            f"parallel.serve_devices={cfg.parallel.serve_devices} (a serving "
            f"mesh) is not ported yet; see ROADMAP.md {MESH_PART_2}")
    if cfg.model.arch not in _ARCHS:
        raise ValueError(f"unknown model.arch {cfg.model.arch!r} (want one "
                         f"of {_ARCHS})")
    if cfg.model.head not in _HEADS:
        raise ValueError(f"unknown model.head {cfg.model.head!r} (want one "
                         f"of {_HEADS})")
    if cfg.model.compute_dtype not in _DTYPES:
        raise ValueError(
            f"model.compute_dtype must be one of {_DTYPES}, got "
            f"{cfg.model.compute_dtype!r}"
        )
    if training and cfg.train.ensemble_size != 1:
        raise NotImplementedError(
            f"train.ensemble_size={cfg.train.ensemble_size!r}: one fit "
            "trains one model; trainer.fit_ensemble (the train CLI's route) "
            "trains the members, one after another or stacked "
            "(train.ensemble_parallel)")
    if training and cfg.train.optimizer not in _OPTIMIZERS:
        raise ValueError(f"unknown optimizer {cfg.train.optimizer!r} (want "
                         f"one of {_OPTIMIZERS})")
    if training and cfg.train.lr_schedule not in _SCHEDULES:
        raise ValueError(f"unknown lr_schedule {cfg.train.lr_schedule!r}")
    if training and cfg.data.prefetch_batches < 0:
        raise ValueError(f"data.prefetch_batches="
                         f"{cfg.data.prefetch_batches} must be >= 0")
    if training and cfg.data.readers < 1:
        raise ValueError(f"data.readers={cfg.data.readers} must be >= 1")
    if training and cfg.data.loader not in _LOADERS:
        raise NotImplementedError(
            f"data.loader={cfg.data.loader!r} is not ported yet (have "
            f"{_LOADERS}); see ROADMAP.md {_LOADER_ITEM}")


def validate_train_knobs(tc: TrainConfig) -> None:
    """Copy of ``train_lib.validate_train_knobs``: the fused step path
    implements unclipped adamw only, and refuses anything else at
    construction instead of mistraining."""
    if tc.dtype not in ("fp32", "bf16"):
        raise ValueError(f"unknown train.dtype {tc.dtype!r} (want fp32|bf16)")
    if tc.accum_steps < 1:
        raise ValueError(f"train.accum_steps={tc.accum_steps} must be >= 1")
    if tc.use_pallas_fused:
        if tc.optimizer != "adamw":
            raise ValueError(
                "train.use_pallas_fused implements the fused optimizer "
                f"update for adamw only (got {tc.optimizer!r}); unset the "
                "flag or switch optimizers")
        if tc.gradient_clip_norm > 0:
            raise ValueError(
                "train.use_pallas_fused cannot compose with "
                "train.gradient_clip_norm (the fused kernel replaces the "
                "whole optimizer chain; the clip would be silently "
                "dropped); disable one of the two")


def get_config(name: str) -> ExperimentConfig:
    if name not in PRESETS:
        raise ValueError(
            f"unknown config preset {name!r}; available: {sorted(PRESETS)}"
        )
    return PRESETS[name]()


def _fields(obj) -> list[str]:
    return [f.name for f in dataclasses.fields(obj)]


def _unknown(parent, attr: str, item: str) -> ValueError:
    if not dataclasses.is_dataclass(parent):
        return ValueError(
            f"override {item!r} descends into {attr!r}, but the path "
            f"already reached a {type(parent).__name__} value"
        )
    names = _fields(parent)
    close = difflib.get_close_matches(attr, names, n=1)
    hint = f"; did you mean {close[0]!r}?" if close else ""
    return ValueError(
        f"unknown config field {attr!r} in override {item!r}{hint} "
        f"(this port reads {type(parent).__name__} fields: "
        f"{', '.join(sorted(names))})"
    )


def _parse(raw: str, current, section, field: str, item: str):
    try:
        if isinstance(current, bool):
            return raw.lower() in ("1", "true", "yes")
        if isinstance(current, int):
            return int(raw)
        if isinstance(current, float):
            return float(raw)
        if isinstance(current, tuple):
            ann = str(next(
                f.type for f in dataclasses.fields(section) if f.name == field
            ))
            elem = int if "int" in ann else float if "float" in ann else str
            return tuple(elem(p) for p in raw.split(",") if p)
        return raw
    except ValueError:
        raise ValueError(
            f"bad value in override {item!r}: cannot parse {raw!r} as "
            f"{type(current).__name__}"
        ) from None


def override(cfg: ExperimentConfig, dotted: Sequence[str]) -> ExperimentConfig:
    """Apply ``section.field=value`` overrides (the CLI's ``--set``)."""
    for item in dotted:
        key, eq, raw = item.partition("=")
        parts = key.split(".")
        for k in (".".join(parts[:i]) for i in range(1, len(parts) + 1)):
            if k in _NOT_PORTED:
                raise NotImplementedError(
                    f"{key} is not ported yet; see ROADMAP.md "
                    f"{_NOT_PORTED[k]}")
        if not eq or len(parts) < 2 or not all(parts):
            raise ValueError(
                f"malformed override {item!r}; expected section.field=value"
            )
        chain = [cfg]
        for p in parts[:-1]:
            parent = chain[-1]
            if not (dataclasses.is_dataclass(parent) and p in _fields(parent)):
                raise _unknown(parent, p, item)
            chain.append(getattr(parent, p))
        section, field = chain[-1], parts[-1]
        if not (dataclasses.is_dataclass(section)
                and field in _fields(section)):
            raise _unknown(section, field, item)
        current = getattr(section, field)
        if dataclasses.is_dataclass(current):
            raise ValueError(
                f"override {item!r} targets a config section; set its "
                "fields individually"
            )
        obj: object = dataclasses.replace(
            section, **{field: _parse(raw, current, section, field, item)}
        )
        for parent, name in zip(reversed(chain[:-1]), reversed(parts[:-1])):
            obj = dataclasses.replace(parent, **{name: obj})
        cfg = obj
    return cfg
