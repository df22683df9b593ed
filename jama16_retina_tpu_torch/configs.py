"""The slice of ``jama16_retina_tpu/configs.py`` that the serving port reads.

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
    arch: str = "inception_v3"  # inception_v3 | tiny_cnn in this port
    head: str = "binary"
    image_size: int = 299
    dropout_rate: float = 0.2
    compute_dtype: str = "bfloat16"
    aux_head: bool = True
    stem_s2d: bool = False
    remat_stem: bool = False

    @property
    def num_classes(self) -> int:
        return 5 if self.head == "multi" else 1


@dataclasses.dataclass(frozen=True)
class EvalConfig:
    # Average probabilities over the 4 flip views (identity/h/v/hv).
    tta: bool = False


@dataclasses.dataclass(frozen=True)
class ServeConfig:
    # Largest chunk one engine forward serves; larger requests are chunked.
    max_batch: int = 64
    # Padded batch shapes; empty = powers of two from 8 up to max_batch.
    bucket_sizes: tuple[int, ...] = ()
    # Normalize each padded chunk with the fused CUDA kernel
    # (ops/serve_preprocess.py) and keep the per-image input statistics.
    fused_preprocess: bool = False
    # Host threads for fundus normalization (0 = auto).
    host_workers: int = 0
    dtype: str = "fp32"
    member_parallel: bool = False
    compile_cache_dir: str = ""


@dataclasses.dataclass(frozen=True)
class ExperimentConfig:
    name: str = "eyepacs_binary"
    model: ModelConfig = dataclasses.field(default_factory=ModelConfig)
    eval: EvalConfig = dataclasses.field(default_factory=EvalConfig)
    serve: ServeConfig = dataclasses.field(default_factory=ServeConfig)

    def replace(self, **sections) -> "ExperimentConfig":
        return dataclasses.replace(self, **sections)


def _preset_eyepacs_binary() -> ExperimentConfig:
    return ExperimentConfig(name="eyepacs_binary")


def _preset_eyepacs_binary_quality() -> ExperimentConfig:
    # The serving-visible part of the JAX preset: flip-TTA at eval.
    return ExperimentConfig(
        name="eyepacs_binary_quality", eval=EvalConfig(tta=True)
    )


def _preset_smoke() -> ExperimentConfig:
    return ExperimentConfig(
        name="smoke",
        model=ModelConfig(arch="tiny_cnn", image_size=64, aux_head=False),
    )


PRESETS = {
    "eyepacs_binary": _preset_eyepacs_binary,
    "eyepacs_binary_quality": _preset_eyepacs_binary_quality,
    "smoke": _preset_smoke,
}

# Knob -> (its default, the ROADMAP item that will implement it).
_UNIMPLEMENTED = {
    ("model", "head"): ("binary", "Queue A item 10 (head=multi)"),
    ("model", "stem_s2d"): (False, "Queue A item 2 (stem_s2d)"),
    ("model", "remat_stem"): (False, "Queue A item 2 (remat_stem)"),
    ("serve", "dtype"): ("fp32", "Queue A item 9 (serve/quantize.py)"),
    ("serve", "member_parallel"): (
        False, "Queue A item 9 (member-parallel serving)"),
    ("serve", "compile_cache_dir"): (
        "", "Queue A item 9 (compile cache / CUDA graphs)"),
}
_ARCHS = ("inception_v3", "tiny_cnn")
_DTYPES = ("float32", "bfloat16")


def check_supported(cfg: ExperimentConfig) -> None:
    """Raise on any knob this port cannot honour yet, instead of
    silently serving something other than what was configured."""
    for (section, field), (default, item) in _UNIMPLEMENTED.items():
        value = getattr(getattr(cfg, section), field)
        if value != default:
            raise NotImplementedError(
                f"{section}.{field}={value!r} is not ported yet; see "
                f"ROADMAP.md {item}"
            )
    if cfg.model.arch not in _ARCHS:
        raise NotImplementedError(
            f"model.arch={cfg.model.arch!r} is not ported yet (have "
            f"{_ARCHS}); see ROADMAP.md Queue A item 10"
        )
    if cfg.model.compute_dtype not in _DTYPES:
        raise ValueError(
            f"model.compute_dtype must be one of {_DTYPES}, got "
            f"{cfg.model.compute_dtype!r}"
        )


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
