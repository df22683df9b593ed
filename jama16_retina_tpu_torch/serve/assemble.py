"""Engine assembly (counterpart of ``jama16_retina_tpu/serve/assemble.py``):
one seam from a declared ``EngineSpec`` to a built engine.

At the default spec (no student, no ``serve.cascade_student_dir``)
``assemble`` builds exactly ``ServingEngine(cfg, member_dirs,
state_dicts=..., device=..., registry=...)``. With a student it builds a
``CascadeEngine`` with the reference's wiring: both halves are built
with ``obs.quality`` off, and the cascade's own monitor observes the
merged scores (its input statistics from kernel B4 under
``serve.fused_preprocess``); a bf16 or int8 ensemble with a pinned
canary is built on a detached registry for its ``DtypeRejected``
construction gate and then loses its monitor; ``go_live`` runs the
cascade's gates before the engine is returned. A mesh is refused: the
port serves on one card.
"""

from __future__ import annotations

import dataclasses
from typing import Any

from jama16_retina_tpu_torch.configs import ExperimentConfig


@dataclasses.dataclass(frozen=True)
class EngineSpec:
    """Everything an engine assembly needs. ``member_dirs`` XOR
    ``state_dicts`` is the ensemble's source (the engine's contract)."""

    cfg: ExperimentConfig
    # Ensemble member dirs.
    member_dirs: tuple = ()
    # Distilled-student member dirs: non-empty assembles a cascade. Empty
    # falls back to serve.cascade_student_dir (discovered), then to none.
    student_dirs: tuple = ()
    # Ready member state_dicts, in place of member_dirs.
    state_dicts: Any = None
    # Where the engines run (None: the card).
    device: Any = None
    # Not supported: the port serves on one card.
    mesh: Any = None
    # Telemetry registry; None: the engine's own default wiring.
    registry: Any = None
    # The cascade's monitor; None builds one from cfg.obs.quality.
    quality: Any = None
    # Run the cascade's go-live gates before returning.
    go_live: bool = False
    # False assembles the plain ensemble even with a student configured.
    cascade: bool = True


def _quality_off(cfg: ExperimentConfig) -> ExperimentConfig:
    """cfg with the engine-level quality monitor off: the config of each
    half of a cascade, whose merged view owns the monitor."""
    return cfg.replace(obs=dataclasses.replace(
        cfg.obs, quality=dataclasses.replace(cfg.obs.quality,
                                             enabled=False)))


def _resolve_student_dirs(spec: EngineSpec) -> tuple:
    if not spec.cascade:
        return ()
    if spec.student_dirs:
        return tuple(spec.student_dirs)
    if spec.cfg.serve.cascade_student_dir:
        from jama16_retina_tpu_torch.utils import checkpoint as ckpt_lib

        return tuple(ckpt_lib.discover_member_dirs(
            spec.cfg.serve.cascade_student_dir))
    return ()


def cascade_monitor(cfg: ExperimentConfig, registry, device, quality=None):
    """The quality monitor a cascade's merged view owns: ``quality``, or
    one built from ``cfg.obs.quality`` (None with ``obs`` off), its input
    statistics from kernel B4 under ``serve.fused_preprocess``."""
    if quality is None and cfg.obs.enabled:
        from jama16_retina_tpu_torch.obs import quality as quality_lib

        quality = quality_lib.monitor_from_config(cfg.obs.quality,
                                                  registry=registry)
    if quality is not None and cfg.serve.fused_preprocess:
        from jama16_retina_tpu_torch.serve import host

        quality.stats_fn = lambda rows: host.stats_only(
            rows, fused=True, device=device, registry=registry)
    return quality


def assemble(spec: EngineSpec):
    """Spec -> ready engine: a ``ServingEngine``, or a ``CascadeEngine``
    when the spec carries a student."""
    from jama16_retina_tpu_torch.serve.engine import ServingEngine

    if spec.mesh is not None:
        raise NotImplementedError(
            "EngineSpec.mesh: serving across devices is not ported yet; "
            "see ROADMAP.md Queue A item 8, part 2")
    cfg = spec.cfg
    member_dirs = list(spec.member_dirs) if spec.member_dirs else None
    student_dirs = _resolve_student_dirs(spec)
    if not student_dirs:
        return ServingEngine(cfg, member_dirs, state_dicts=spec.state_dicts,
                             device=spec.device, registry=spec.registry)

    from jama16_retina_tpu_torch.obs import registry as obs_registry
    from jama16_retina_tpu_torch.serve.cascade import CascadeEngine

    sub = _quality_off(cfg)
    if (cfg.serve.dtype != "fp32" and cfg.obs.quality.enabled
            and cfg.obs.quality.canary_path):
        # The monitor exists to arm the construction gate; its gauges go
        # to a registry of their own, and the cascade's monitor below
        # takes over.
        ensemble = ServingEngine(cfg, member_dirs,
                                 state_dicts=spec.state_dicts,
                                 device=spec.device,
                                 registry=obs_registry.Registry())
        ensemble.quality = None
    else:
        ensemble = ServingEngine(sub, member_dirs,
                                 state_dicts=spec.state_dicts,
                                 device=spec.device, registry=spec.registry)
    registry = (spec.registry if spec.registry is not None
                else obs_registry.default_registry())
    quality = cascade_monitor(cfg, registry, ensemble.device, spec.quality)
    engine = CascadeEngine(
        cfg, ServingEngine(sub, list(student_dirs), device=spec.device),
        ensemble, registry=registry, quality=quality)
    if spec.go_live:
        engine.go_live()
    return engine
