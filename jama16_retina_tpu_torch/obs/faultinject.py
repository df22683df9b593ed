"""Deterministic fault injection at named seams (counterpart of
``jama16_retina_tpu/obs/faultinject.py``).

Recovery paths that only run when production breaks are recovery paths
that have never run. Each seam of the port calls ``check(site)`` (or
``corrupt(site, data)`` where it carries bytes), and a ``FaultPlan``
armed for that site injects the configured fault on exactly the calls
it names: an exception, added latency, or damaged bytes.

``SITES`` is the reference's declared-site registry, name for name, so
a plan the reference accepts parses the same way here. The port fires
the sites whose code it has (``PORT_SITES``); ``arm`` refuses a plan
naming one of the others (``UNFIRED``), raising ``NotImplementedError``
with the ROADMAP item that brings its seam: an armed site that can
never fire is a drill that silently tests nothing.

Unarmed, every seam reads one module global and branches. Arming is
process-global (``arm``/``disarm``) because the seams run on several
threads (the prefetcher, the saver, the batcher's worker, the router's
replica workers, the host stage's pool). The train stream's reader
*processes* do not share it: ``data/pipeline.train_batches`` sends
them the armed plan's ``spec()`` and adds their counts back
(``absorb``), so at ``data.readers`` >= 2 a site's call ordinals count
per reader.

Plans come from code, from a JSON spec (``plan_from_spec``: the text,
a path to a file holding it, or a dict), or from the ``JAMA16_FAULTS``
variable (``plan_from_env``). One entry per site:

    {"tfrecord.read": {"kind": "error", "on_calls": [3],
                       "error": "OSError", "message": "injected"},
     "host.decode":   {"kind": "latency", "on_calls": [1, 2],
                       "delay_s": 0.05},
     "ckpt.restore":  {"kind": "corrupt", "on_calls": [1]}}

``on_calls`` are 1-based per-site call ordinals; ``"every": N`` fires
on every Nth call instead; ``max_fires`` bounds a site's injections
(0: unbounded).
"""

from __future__ import annotations

import json
import logging
import os
import threading
import time
from dataclasses import dataclass, field

_log = logging.getLogger(__name__)

# The reference's declared sites, with where each seam sits in the port
# (or which reference module holds it, for the sites in ``UNFIRED``).
SITES = {
    "tfrecord.read": "one record's data read, under retry: "
                     "data/tfrecord.read_record_at in the tfdata train "
                     "stream's reader processes (CRC checked), and "
                     "data/grain_pipeline.TFRecordIndex.read on the "
                     "decode threads of the hbm and tiered loaders and the "
                     "rawshard transcode (no CRC, as the reference's index; "
                     "a damaged payload that still parses is kept)",
    "host.decode": "serve/host per-image file read before the decode and "
                   "fundus normalization",
    "ckpt.restore": "Checkpointer.restore, under retry "
                    "(utils/checkpoint.py)",
    "ckpt.save": "Checkpointer.save/save_latest before the write, on "
                 "whichever thread runs it (the train loop, or the "
                 "AsyncSaver worker under train.async_save); latency "
                 "plans widen the in-flight-save window for kill drills",
    "engine.dispatch": "ServingEngine per-chunk dispatch "
                       "(serve/engine.py)",
    "serve.router.dispatch": "Router per-bin replica dispatch "
                             "(serve/router.py; an injected failure kills "
                             "the replica, its bins retry on siblings)",
    "serve.compile_cache.load": "persistent compile-cache entry load "
                                "(reference serve/compilecache.py)",
    "trainer.step": "the train loops' per-step boundary (trainer.py)",
    "lifecycle.retrain": "LifecycleController RETRAIN phase entry "
                         "(lifecycle/controller.py)",
    "lifecycle.gate": "LifecycleController GATE evaluation; a fault fails "
                      "the gate closed (lifecycle/controller.py)",
    "lifecycle.swap": "LifecycleController STAGED_ROLLOUT, before the "
                      "shadow session and the promote "
                      "(lifecycle/controller.py)",
    "integrity.write": "sealed-artifact payload seam (integrity/"
                       "artifact.atomic_write_bytes, every durable writer: "
                       "serve policy, profiles, canary, telemetry.prom): "
                       "corrupt-family kinds damage the serialized blob, "
                       "error kinds fail the write ENOSPC-style",
    "integrity.write.commit": "between the sealed writer's tmp-file fsync "
                              "and its os.replace publish (integrity/"
                              "artifact.py); a latency plan holds the "
                              "window open for a kill -9 drill",
    "ingest.attach": "ingest-server consumer attach (reference "
                     "ingest/server.py)",
    "ingest.ring.write": "ingest-server shared-memory ring slot write "
                         "(reference ingest/server.py)",
    "audit.seal": "audit-ledger segment seal (reference obs/audit.py)",
    "ingest.decode": "ingest-server cache-miss batch decode (reference "
                     "ingest/server.py)",
}

# Declared sites the port has no seam for yet -> the ROADMAP item that
# brings it.
UNFIRED = {
    "serve.compile_cache.load": "Queue A item 9 (the compile cache / CUDA "
                                "graphs)",
    **dict.fromkeys(("ingest.attach", "ingest.ring.write", "ingest.decode"),
                    "Queue A item 11 (part 5: the ingest service)"),
    "audit.seal": "Queue A item 11 (part 5: the audit plane)",
}
# The sites the port fires.
PORT_SITES = tuple(s for s in SITES if s not in UNFIRED)

# Error classes a JSON spec may name: the faults the seams handle.
_ERRORS = {
    "OSError": OSError,
    "IOError": IOError,
    "ValueError": ValueError,
    "RuntimeError": RuntimeError,
    "TimeoutError": TimeoutError,
}


class InjectedFault(RuntimeError):
    """Exception of kind="error" entries that name no class."""


# The corrupt family damages the bytes at data-carrying seams: "corrupt"
# (half, every byte XOR-flipped), "torn" (a third lands), "bitflip" (one
# bit mid-payload), "truncate" (the last quarter is lost).
_KINDS = ("error", "latency", "corrupt", "torn", "bitflip", "truncate")
_CORRUPT_KINDS = ("corrupt", "torn", "bitflip", "truncate")


def _damage(kind: str, data: bytes) -> bytes:
    """Deterministic byte damage of a corrupt-family kind."""
    if len(data) == 0:
        return data
    if kind == "torn":
        return data[: max(1, len(data) // 3)]
    if kind == "bitflip":
        i = len(data) // 2
        return data[:i] + bytes([data[i] ^ 0x01]) + data[i + 1:]
    if kind == "truncate":
        return data[: max(1, (len(data) * 3) // 4)]
    half = data[: max(1, len(data) // 2)]
    return bytes(b ^ 0xFF for b in half)


@dataclass
class FaultSite:
    """One site's fault configuration inside a FaultPlan."""

    kind: str = "error"            # one of _KINDS
    on_calls: tuple = ()           # 1-based ordinals that fire
    every: int = 0                 # fire on every Nth call (0 = off)
    error: str = ""                # _ERRORS key; "" -> InjectedFault
    message: str = "injected fault"
    delay_s: float = 0.0           # latency kind: seconds to add
    max_fires: int = 0             # 0 = unbounded
    calls: int = 0                 # mutable: per-site call count
    fires: int = 0                 # mutable: injections delivered

    def should_fire(self) -> bool:
        """Call-counted decision; the caller holds the plan's lock."""
        self.calls += 1
        if self.max_fires and self.fires >= self.max_fires:
            return False
        hit = self.calls in self.on_calls or (
            self.every > 0 and self.calls % self.every == 0)
        if hit:
            self.fires += 1
        return hit

    def make_error(self) -> BaseException:
        cls = _ERRORS.get(self.error, InjectedFault)
        return cls(f"{self.message} (injected, call {self.calls})")


@dataclass
class FaultPlan:
    """A named-site fault schedule; the per-site counts mutate under
    ``_lock``."""

    sites: dict = field(default_factory=dict)  # site -> FaultSite
    _lock: threading.Lock = field(default_factory=threading.Lock,
                                  repr=False)

    def site(self, name: str) -> "FaultSite | None":
        return self.sites.get(name)

    def counts(self) -> dict:
        """{site: {'calls': n, 'fires': m}}."""
        with self._lock:
            return {name: {"calls": s.calls, "fires": s.fires}
                    for name, s in self.sites.items()}

    def spec(self) -> dict:
        """The plan's JSON spec, counts left out: what a reader process
        arms (``plan_from_spec(plan.spec())`` is a fresh copy)."""
        return {name: {"kind": s.kind, "on_calls": list(s.on_calls),
                       "every": s.every, "error": s.error,
                       "message": s.message, "delay_s": s.delay_s,
                       "max_fires": s.max_fires}
                for name, s in self.sites.items()}

    def absorb(self, counts: dict) -> None:
        """Add another process's {site: {'calls', 'fires'}} to this
        plan's counts (a reader process's, shipped with its batch)."""
        with self._lock:
            for name, c in counts.items():
                s = self.sites[name]
                s.calls += c["calls"]
                s.fires += c["fires"]

    def validate_sites(self) -> None:
        """Every site must be declared in ``SITES``; raises with a
        did-you-mean otherwise."""
        import difflib

        for name in self.sites:
            if name in SITES:
                continue
            close = difflib.get_close_matches(name, sorted(SITES), n=1)
            hint = f"; did you mean {close[0]!r}?" if close else ""
            raise ValueError(
                f"unknown fault site {name!r}{hint} (declared sites: "
                f"{', '.join(sorted(SITES))}) — an unknown site would "
                "never fire; pass allow_unknown=True only to test the "
                "fault machinery itself")

    def refuse_unfired(self) -> None:
        """Raise ``NotImplementedError`` for a site the port has no seam
        for yet, naming its item."""
        for name in self.sites:
            if name in UNFIRED:
                raise NotImplementedError(
                    f"fault site {name!r} has no seam in the port yet, so "
                    f"a plan arming it would never fire; see ROADMAP.md "
                    f"{UNFIRED[name]}")


def plan_from_spec(spec: "str | dict",
                   allow_unknown: bool = False) -> FaultPlan:
    """A FaultPlan from the JSON spec shape in the module docstring: the
    JSON text, a path to a JSON file, or a parsed dict. Unknown keys,
    kinds and error classes raise, as do (unless ``allow_unknown``) site
    names outside ``SITES``."""
    if isinstance(spec, str):
        if os.path.exists(spec):
            with open(spec) as f:
                spec = json.load(f)
        else:
            spec = json.loads(spec)
    if not isinstance(spec, dict):
        raise ValueError(f"fault spec must be a JSON object, got {spec!r}")
    sites = {}
    allowed = {"kind", "on_calls", "every", "error", "message",
               "delay_s", "max_fires"}
    for name, entry in spec.items():
        unknown = set(entry) - allowed
        if unknown:
            raise ValueError(
                f"fault site {name!r}: unknown keys {sorted(unknown)} "
                f"(allowed: {sorted(allowed)})")
        kind = entry.get("kind", "error")
        if kind not in _KINDS:
            raise ValueError(
                f"fault site {name!r}: unknown kind {kind!r} "
                f"(want {'|'.join(_KINDS)})")
        err = entry.get("error", "")
        if err and err not in _ERRORS:
            raise ValueError(
                f"fault site {name!r}: unknown error class {err!r} "
                f"(allowed: {sorted(_ERRORS)})")
        sites[name] = FaultSite(
            kind=kind,
            on_calls=tuple(int(c) for c in entry.get("on_calls", ())),
            every=int(entry.get("every", 0)),
            error=err,
            message=str(entry.get("message", "injected fault")),
            delay_s=float(entry.get("delay_s", 0.0)),
            max_fires=int(entry.get("max_fires", 0)),
        )
    plan = FaultPlan(sites=sites)
    if not allow_unknown:
        plan.validate_sites()
    return plan


ENV_VAR = "JAMA16_FAULTS"


def plan_from_env() -> "FaultPlan | None":
    """The plan ``JAMA16_FAULTS`` holds (JSON text or a file path), or
    None when it is unset or empty."""
    raw = os.environ.get(ENV_VAR, "")
    if not raw:
        return None
    return plan_from_spec(raw)


# The one global every seam reads.
_active: "FaultPlan | None" = None


def arm(plan: "FaultPlan | str | dict | None",
        allow_unknown: bool = False) -> "FaultPlan | None":
    """Install ``plan`` process-wide (a str or dict spec is parsed) and
    return the previous one; ``None`` disarms. Site names are validated
    against ``SITES`` unless ``allow_unknown``, and a declared site the
    port does not fire yet raises ``NotImplementedError`` either way."""
    global _active
    prev = _active
    if plan is not None:
        if not isinstance(plan, FaultPlan):
            plan = plan_from_spec(plan, allow_unknown=allow_unknown)
        elif not allow_unknown:
            plan.validate_sites()
        plan.refuse_unfired()
    _active = plan
    if plan is not None:
        _log.warning("FAULT INJECTION ARMED at sites %s", sorted(plan.sites))
    return prev


def disarm() -> None:
    arm(None)


def active_plan() -> "FaultPlan | None":
    return _active


def arm_from_env_or_config(config_spec: str = "") -> None:
    """The run-entry arming rule (the trainer's run start, a
    ServingEngine's construction): ``JAMA16_FAULTS`` wins, else the
    config's ``obs.fault_plan``, else whatever is armed stays armed
    (tests arm before they build the engine or start the fit)."""
    env = plan_from_env()
    if env is not None:
        arm(env)
    elif config_spec:
        arm(plan_from_spec(config_spec))


def check(site: str) -> None:
    """The seam hook. Unarmed: one global read and one branch. Armed:
    count the call and deliver the site's fault: raise (kind="error"),
    sleep (kind="latency"); a corrupt-family kind at a seam that carries
    no bytes raises too, so a plan is never silently inert."""
    plan = _active
    if plan is None:
        return
    s = plan.site(site)
    if s is None:
        return
    with plan._lock:
        fire = s.should_fire()
    if not fire:
        return
    if s.kind == "latency":
        time.sleep(s.delay_s)
        return
    raise s.make_error()


def corrupt(site: str, data: bytes) -> bytes:
    """The data-carrying seam hook: ``data`` untouched unless a
    corrupt-family entry fires, which returns it damaged per its kind
    (``_damage``); error and latency entries act as in ``check``."""
    plan = _active
    if plan is None:
        return data
    s = plan.site(site)
    if s is None:
        return data
    with plan._lock:
        fire = s.should_fire()
    if not fire:
        return data
    if s.kind == "latency":
        time.sleep(s.delay_s)
        return data
    if s.kind == "error":
        raise s.make_error()
    return _damage(s.kind, data)
