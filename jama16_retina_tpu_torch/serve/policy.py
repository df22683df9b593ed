"""Frontier-derived serving policy (counterpart of
``jama16_retina_tpu/serve/policy.py``): bucket sizes, coalescing wait and
shed thresholds read off a measured throughput/latency frontier.

A frontier is a list of points ``{bucket, concurrency, images_per_sec,
p50_ms, p99_ms}``, one per (bucket, offered concurrency) the sweep ran.
``derive_policy`` turns it into a :class:`ServePolicy`, a pure function
of the sweep: the same frontier and fingerprint always give the same
payload and content version, in this package and in the JAX one.
``save_policy`` seals it (``integrity/artifact.py``, the reference's
envelope), ``load_policy`` reads an artifact either package sealed, and
``serve.policy_from`` applies one at router or predict construction
through ``maybe_apply_policy``: a knob still at its ``ServeConfig``
default is filled, a hand-set one wins. An artifact derived for another
(arch, image_size, head, n_devices) raises :class:`PolicyStale`.

The derivation (each rule inline below):

  * ``max_batch``: the smallest swept bucket within ``KNEE_FRAC`` of the
    best throughput (after an SLO filter, when one is given);
  * ``bucket_sizes``: every swept bucket up to ``max_batch``;
  * ``max_wait_ms``: half the chosen point's p50, within [1, 25] ms;
  * ``shed_in_flight`` / ``shed_queue_depth``: multiples of the
    concurrency at which the chosen bucket peaked;
  * the v2 class table: the batch class keeps the knee rule, the
    interactive class takes the lowest p99 under the SLO at the target
    load, and a small interactive bucket opts it into int8, speculation,
    fusion and the fused preprocess.
"""

from __future__ import annotations

import dataclasses
import hashlib
import json
import logging

from jama16_retina_tpu_torch.integrity import artifact as artifact_lib

_log = logging.getLogger(__name__)

FORMAT = "jama16.serve_policy"
# v2 adds the per-priority-class table (``classes``) and the per-bucket
# p99 ledger; v1 artifacts still load, with an empty class table.
VERSION = 2
COMPAT_VERSIONS = (1, VERSION)
# An interactive bucket this small rides the cheap path (int8 student,
# speculation, fusion); larger interactive buckets keep the engine dtype.
INTERACTIVE_SMALL_BUCKET = 8
# The knee rule: the smallest bucket within this share of the sweep's
# best throughput becomes max_batch.
KNEE_FRAC = 0.90
# Shed thresholds as multiples of the peak-throughput concurrency.
SHED_IN_FLIGHT_X = 4
SHED_QUEUE_X = 8

_REDERIVE = ("re-derive it: policy.derive_policy over a fresh "
             "serve_frontier sweep of this model, then save_policy")


class PolicyStale(RuntimeError):
    """The artifact was derived for another model or device fingerprint,
    or is of a format or version this code cannot read, or is torn."""


@dataclasses.dataclass(frozen=True)
class ServePolicy:
    """One derived policy. ``version`` is a content hash: two artifacts
    with the same knobs and fingerprint carry the same version."""

    bucket_sizes: tuple
    max_batch: int
    max_wait_ms: float
    shed_in_flight: int
    shed_queue_depth: int
    fingerprint: dict
    source: dict
    version: str = ""
    # v2: {"interactive": {...}, "batch": {...}} and bucket -> the best
    # point's p99_ms; both empty on a loaded v1 artifact.
    classes: dict = dataclasses.field(default_factory=dict)
    per_bucket_p99: dict = dataclasses.field(default_factory=dict)

    def payload(self) -> dict:
        return {
            "format": FORMAT,
            "version": VERSION,
            "bucket_sizes": [int(b) for b in self.bucket_sizes],
            "max_batch": int(self.max_batch),
            "max_wait_ms": float(self.max_wait_ms),
            "shed_in_flight": int(self.shed_in_flight),
            "shed_queue_depth": int(self.shed_queue_depth),
            "fingerprint": dict(self.fingerprint),
            "source": dict(self.source),
            "classes": {k: dict(v) for k, v in self.classes.items()},
            "per_bucket_p99": {
                str(k): v for k, v in self.per_bucket_p99.items()
            },
        }


def _content_version(payload: dict) -> str:
    blob = json.dumps(payload, sort_keys=True).encode()
    return f"sp{VERSION}-{hashlib.sha256(blob).hexdigest()[:10]}"


def policy_fingerprint(cfg, n_devices: int = 1) -> dict:
    """What a frontier is a function of: the model's shapes and the
    device count its rates were measured on."""
    return {
        "arch": cfg.model.arch,
        "image_size": int(cfg.model.image_size),
        "head": cfg.model.head,
        "n_devices": int(n_devices),
    }


def frontier_from_bench_json(obj: dict) -> list:
    """The ``serve_frontier`` list of a bench JSON (top level, or nested
    under ``parsed`` or ``extras``); raises when there is none."""
    for holder in (obj, obj.get("parsed") or {}, obj.get("extras") or {}):
        if isinstance(holder, dict) and holder.get("serve_frontier"):
            return list(holder["serve_frontier"])
    raise ValueError(
        "bench JSON carries no 'serve_frontier' sweep — measure a "
        "frontier (bucket x concurrency) first"
    )


def _interactive_class(points: list, slo_p99_ms: float,
                       target_images_per_sec: float) -> dict:
    """The v2 interactive class: among the points with p99 <= SLO and a
    rate >= the target, the lowest p99 (ties to the smaller bucket). An
    unsatisfiable constraint is dropped with a warning, the target
    first, then the SLO."""
    with_p99 = [p for p in points if p.get("p99_ms") is not None]
    if not with_p99:
        return {}
    pool = with_p99
    if slo_p99_ms > 0:
        under = [p for p in pool if p["p99_ms"] <= slo_p99_ms]
        if under:
            pool = under
        else:
            _log.warning(
                "no frontier point meets interactive p99 <= %g ms; "
                "interactive class minimizes p99 unconstrained",
                slo_p99_ms,
            )
    if target_images_per_sec > 0:
        loaded = [
            p for p in pool
            if p["images_per_sec"] >= target_images_per_sec
        ]
        if loaded:
            pool = loaded
        else:
            _log.warning(
                "no frontier point under the SLO sustains %g img/s; "
                "interactive class drops the load target",
                target_images_per_sec,
            )
    chosen = min(pool, key=lambda p: (p["p99_ms"], int(p["bucket"])))
    bucket = int(chosen["bucket"])
    p50 = float(chosen.get("p50_ms") or 2.0)
    cls = {
        "bucket": bucket,
        "max_wait_ms": round(min(25.0, max(1.0, p50 / 2.0)), 2),
        "p99_ms": float(chosen["p99_ms"]),
        "concurrency": int(chosen.get("concurrency") or 1),
        "speculative": True,
        "fusion": True,
        "fused_preprocess": True,
    }
    if bucket <= INTERACTIVE_SMALL_BUCKET:
        cls["dtype"] = "int8"
    return cls


def derive_policy(frontier: list, fingerprint: dict,
                  slo_p99_ms: float = 0.0,
                  source: "dict | None" = None,
                  target_images_per_sec: float = 0.0) -> ServePolicy:
    """A ServePolicy from frontier points (a point whose rate is None is
    skipped). ``slo_p99_ms`` > 0 restricts ``max_batch`` to buckets whose
    best-throughput point keeps p99 under the SLO; when none does, the
    SLO is ignored with a warning."""
    points = [
        p for p in frontier
        if p.get("images_per_sec") is not None and p.get("bucket")
    ]
    if not points:
        raise ValueError(
            "serve_frontier sweep has no usable points (all rates "
            "withheld?) — cannot derive a policy"
        )
    best: dict = {}
    for p in points:
        b = int(p["bucket"])
        if b not in best or p["images_per_sec"] > best[b]["images_per_sec"]:
            best[b] = p
    # The SLO filter first, then the knee among the eligible buckets.
    eligible = dict(best)
    if slo_p99_ms > 0:
        under_slo = {
            b: p for b, p in best.items()
            if p.get("p99_ms") is not None and p["p99_ms"] <= slo_p99_ms
        }
        if under_slo:
            eligible = under_slo
        else:
            _log.warning(
                "no frontier bucket meets p99 <= %g ms at its best "
                "throughput; deriving policy from the knee rule alone",
                slo_p99_ms,
            )
    peak_rate = max(p["images_per_sec"] for p in eligible.values())
    candidates = sorted(
        b for b, p in eligible.items()
        if p["images_per_sec"] >= KNEE_FRAC * peak_rate
    )
    max_batch = candidates[0]
    chosen = best[max_batch]
    buckets = tuple(sorted(b for b in best if b <= max_batch))
    p50 = float(chosen.get("p50_ms") or 2.0)
    max_wait_ms = round(min(25.0, max(1.0, p50 / 2.0)), 2)
    peak_conc = max(1, int(chosen.get("concurrency") or 1))
    classes = {
        "batch": {
            "bucket": int(max_batch),
            "max_wait_ms": max_wait_ms,
        },
    }
    interactive = _interactive_class(
        points, slo_p99_ms, target_images_per_sec
    )
    if interactive:
        classes["interactive"] = interactive
    policy = ServePolicy(
        bucket_sizes=buckets,
        max_batch=int(max_batch),
        max_wait_ms=max_wait_ms,
        shed_in_flight=SHED_IN_FLIGHT_X * peak_conc,
        shed_queue_depth=SHED_QUEUE_X * peak_conc,
        fingerprint=dict(fingerprint),
        source=dict(source or {}),
        classes=classes,
        per_bucket_p99={
            str(b): (float(p["p99_ms"])
                     if p.get("p99_ms") is not None else None)
            for b, p in sorted(best.items())
        },
    )
    return dataclasses.replace(
        policy, version=_content_version(policy.payload())
    )


def save_policy(path: str, policy: ServePolicy) -> str:
    """Sealed atomic write of the artifact: a torn file never parses and
    a changed one fails its checksum on load."""
    payload = policy.payload()
    payload["policy_version"] = (
        policy.version or _content_version(payload)
    )
    return artifact_lib.write_sealed_json(
        path, payload, schema="serve.policy", version=VERSION
    )


def load_policy(path: str) -> ServePolicy:
    """Load and validate an artifact: an unreadable, foreign, unknown
    version or torn one raises :class:`PolicyStale`; a checksum mismatch
    raises ``ArtifactCorrupt``, counted."""
    try:
        with open(path) as f:
            obj = json.load(f)
    except (OSError, ValueError) as e:
        raise PolicyStale(
            f"cannot read policy artifact {path}: "
            f"{type(e).__name__}: {e} — {_REDERIVE}"
        ) from e
    if (obj.get("format") != FORMAT
            or obj.get("version") not in COMPAT_VERSIONS):
        raise PolicyStale(
            f"policy artifact {path} is "
            f"{obj.get('format')!r} v{obj.get('version')!r}, this code "
            f"reads {FORMAT!r} v{sorted(COMPAT_VERSIONS)} — {_REDERIVE}"
        )
    expected = {
        "bucket_sizes", "max_batch", "max_wait_ms", "shed_in_flight",
        "shed_queue_depth", "fingerprint",
    }
    missing = expected - set(obj)
    if missing:
        raise PolicyStale(
            f"policy artifact {path} is torn/incomplete (missing "
            f"{sorted(missing)}) — {_REDERIVE}"
        )
    # The checksum last, so the typed refusals above keep their errors.
    artifact_lib.verify_payload(obj, path, artifact="policy")
    return ServePolicy(
        bucket_sizes=tuple(int(b) for b in obj["bucket_sizes"]),
        max_batch=int(obj["max_batch"]),
        max_wait_ms=float(obj["max_wait_ms"]),
        shed_in_flight=int(obj["shed_in_flight"]),
        shed_queue_depth=int(obj["shed_queue_depth"]),
        fingerprint=dict(obj["fingerprint"]),
        source=dict(obj.get("source") or {}),
        version=str(obj.get("policy_version") or ""),
        classes={
            k: dict(v) for k, v in (obj.get("classes") or {}).items()
        },
        per_bucket_p99=dict(obj.get("per_bucket_p99") or {}),
    )


def check_fingerprint(policy: ServePolicy, cfg,
                      n_devices: int = 1, path: str = "") -> None:
    """Refuse a policy derived for another model or device count."""
    want = policy_fingerprint(cfg, n_devices)
    if dict(policy.fingerprint) != want:
        raise PolicyStale(
            f"policy artifact {path or '(loaded)'} was derived for "
            f"{policy.fingerprint} but this config runs {want} — "
            f"{_REDERIVE}"
        )


def apply_policy(cfg, policy: ServePolicy) -> "tuple[object, list]":
    """``cfg`` with the policy's knobs filled into ``cfg.serve`` where a
    field still holds its ``ServeConfig`` default (hand-set knobs win),
    and the sorted list of the fields filled."""
    from jama16_retina_tpu_torch.configs import ServeConfig

    defaults = ServeConfig()
    sc = cfg.serve
    updates: dict = {}
    if tuple(sc.bucket_sizes) == tuple(defaults.bucket_sizes):
        updates["bucket_sizes"] = tuple(policy.bucket_sizes)
    if sc.max_batch == defaults.max_batch:
        updates["max_batch"] = policy.max_batch
    if sc.max_wait_ms == defaults.max_wait_ms:
        updates["max_wait_ms"] = policy.max_wait_ms
    if sc.shed_in_flight == defaults.shed_in_flight:
        updates["shed_in_flight"] = policy.shed_in_flight
    if sc.shed_queue_depth == defaults.shed_queue_depth:
        updates["shed_queue_depth"] = policy.shed_queue_depth
    # The v2 interactive class is the policy's way to turn the
    # speculative, fusion and fused-preprocess knobs on, knob by knob
    # under the same hand-set-wins rule.
    interactive = policy.classes.get("interactive") or {}
    if interactive:
        if (interactive.get("dtype")
                and sc.dtype == defaults.dtype):
            updates["dtype"] = str(interactive["dtype"])
        if (interactive.get("speculative")
                and sc.cascade_speculative == defaults.cascade_speculative):
            updates["cascade_speculative"] = True
        if (interactive.get("fusion")
                and sc.router_fusion == defaults.router_fusion):
            updates["router_fusion"] = True
        if (interactive.get("fused_preprocess")
                and sc.fused_preprocess == defaults.fused_preprocess):
            updates["fused_preprocess"] = True
    if not updates:
        return cfg, []
    new_cfg = cfg.replace(serve=dataclasses.replace(sc, **updates))
    return new_cfg, sorted(updates)


def maybe_apply_policy(cfg, n_devices: int = 1) -> "tuple[object, dict]":
    """With ``serve.policy_from`` set: load, check the fingerprint, apply,
    and return (the updated cfg, provenance for reports). Without it:
    (cfg, {})."""
    path = cfg.serve.policy_from
    if not path:
        return cfg, {}
    policy = load_policy(path)
    check_fingerprint(policy, cfg, n_devices=n_devices, path=path)
    cfg, applied = apply_policy(cfg, policy)
    _log.info(
        "serve policy %s applied from %s (fields: %s)",
        policy.version, path, ", ".join(applied) or "none — all knobs "
        "hand-set",
    )
    return cfg, {
        "path": path,
        "version": policy.version,
        "applied": applied,
        "source": dict(policy.source),
    }
