"""The sealed-artifact envelope (counterpart of
``jama16_retina_tpu/integrity/artifact.py``): the part the quality
profile, the golden-set canary and the serving policy are written and
read through.

The seal format is the reference's, byte for byte, so a profile,
canary or policy written by either package loads in the other:

  * a JSON artifact carries an embedded ``__seal__`` block (seal
    version, schema name and version, an environment fingerprint, and a
    sha256 over the canonical payload JSON), and is written as
    ``json.dumps(doc, indent=1, sort_keys=True) + "\\n"``;
  * a binary artifact (the canary ``.npz``) has a ``<name>.seal.json``
    sidecar, itself a sealed JSON artifact, pinning its size and sha256;
  * every write is atomic: a temporary file in the same directory,
    fsync, ``os.replace``.

Dump-grade files (blackbox dumps, Chrome traces) go through
``write_json``, the ``.prom`` snapshot through ``atomic_write_text``.

The fingerprint holds the python and numpy versions and the platform
only (no clocks, no hosts), so two writes of one payload on one machine
are byte-identical. A load whose digest disagrees raises
:class:`ArtifactCorrupt` and counts ``integrity.corrupt`` and
``integrity.corrupt.<artifact>``. Every write passes the
``integrity.write`` fault seam (a corrupt-family plan damages the blob,
an error plan fails the write) and ``integrity.write.commit`` between
the fsync and the rename (``obs/faultinject.py``).
"""

from __future__ import annotations

import hashlib
import json
import os
import sys

from jama16_retina_tpu_torch.obs import faultinject

SEAL_KEY = "__seal__"
SEAL_VERSION = 1

# What an ArtifactCorrupt message tells the operator to do, by the short
# artifact class a loader tags it with.
REBUILD = {
    "profile": "re-emit with python -m jama16_retina_tpu_torch.evaluate "
               "--profile_out",
    "canary": "NOT derivable — restore it, or re-pin with "
              "obs/quality.save_canary on the served checkpoint",
    "policy": "re-derive with serve/policy.derive_policy over a fresh "
              "serve_frontier sweep, then save_policy",
    "rawshard": "re-run python -m jama16_retina_tpu_torch.transcode_shards "
                "(it resumes from the last durable shard)",
    "journal": "NOT derivable — inspect or restore it; a fresh journal "
               "starts idle (live.json still names the serving set)",
    "live": "NOT derivable — restore it, or re-point it at the blessed "
            "checkpoint set (python -m jama16_retina_tpu_torch.lifecycle_run "
            "--status shows the journal's view)",
}


class ArtifactCorrupt(RuntimeError):
    """A sealed artifact failed its checksum: the bytes on disk are not
    the bytes the writer sealed. The message names the file, both
    digests and the rebuild command for its class."""

    def __init__(self, path: str, expected: str, actual: str,
                 artifact: str = "", detail: str = ""):
        self.path = path
        self.expected = expected
        self.actual = actual
        self.artifact = artifact
        super().__init__(
            f"artifact {path} is CORRUPT"
            + (f" ({detail})" if detail else "")
            + f": sealed sha256 {expected} but content is {actual}"
            + (f" [{artifact}]" if artifact else "")
            + f" — {REBUILD.get(artifact, 'inspect or restore the file')}")


def env_fingerprint() -> dict:
    """What produced an artifact: deterministic per machine."""
    import numpy as np

    return {
        "python": ".".join(str(v) for v in sys.version_info[:3]),
        "numpy": str(np.__version__),
        "platform": sys.platform,
    }


def payload_digest(payload: dict) -> str:
    """sha256 of the canonical (sorted, compact) JSON of the payload
    without its seal."""
    body = {k: v for k, v in payload.items() if k != SEAL_KEY}
    blob = json.dumps(body, sort_keys=True,
                      separators=(",", ":")).encode("utf-8")
    return hashlib.sha256(blob).hexdigest()


def sha256_file(path: str, chunk: int = 1 << 20) -> str:
    h = hashlib.sha256()
    with open(path, "rb") as f:
        while True:
            b = f.read(chunk)
            if not b:
                break
            h.update(b)
    return h.hexdigest()


def count_corrupt(artifact: str, registry=None) -> None:
    """One detected corruption: ``integrity.corrupt`` and
    ``integrity.corrupt.<artifact>``."""
    from jama16_retina_tpu_torch.obs import registry as registry_lib

    reg = (registry if registry is not None
           else registry_lib.default_registry())
    reg.counter("integrity.corrupt",
                help="sealed artifacts that failed verification on load"
                ).inc()
    reg.counter(f"integrity.corrupt.{artifact}",
                help="corrupt-artifact detections by class").inc()


def atomic_write_bytes(path: str, blob: bytes, fsync: bool = True) -> None:
    """Write ``blob`` to a temporary file beside ``path``, fsync it and
    rename it over ``path``: a reader sees the old file or the new one,
    never a torn one. ``fsync=False`` keeps the rename's atomicity for a
    snapshot rewritten on every flush (``telemetry.prom``), which needs
    to be whole, not durable. The ``integrity.write`` fault seam damages
    or fails the blob; ``integrity.write.commit`` sits between the fsync
    and the rename."""
    blob = faultinject.corrupt("integrity.write", blob)
    tmp = f"{path}.tmp.{os.getpid()}"
    try:
        with open(tmp, "wb") as f:
            f.write(blob)
            if fsync:
                f.flush()
                os.fsync(f.fileno())
        faultinject.check("integrity.write.commit")
        os.replace(tmp, path)
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)


def atomic_write_text(path: str, text: str, fsync: bool = True) -> None:
    """Atomic write of an unsealed text file (the ``.prom`` snapshot,
    read by a scrape parser)."""
    atomic_write_bytes(path, text.encode("utf-8"), fsync=fsync)


def write_json(path: str, obj, indent: "int | None" = 1,
               sort_keys: bool = False, default=None) -> None:
    """Plain JSON write, not atomic and not sealed, for dump-grade files
    (blackbox dumps, Chrome traces)."""
    with open(path, "w", encoding="utf-8") as f:
        json.dump(obj, f, indent=indent, sort_keys=sort_keys,
                  default=default)


def make_seal(payload: dict, schema: str, version) -> dict:
    return {
        "seal_version": SEAL_VERSION,
        "schema": schema,
        "schema_version": version,
        "sha256": payload_digest(payload),
        "env": env_fingerprint(),
    }


def write_sealed_json(path: str, payload: dict, schema: str,
                      version) -> str:
    """Atomically write ``payload`` with its embedded ``__seal__``."""
    doc = dict(payload)
    doc.pop(SEAL_KEY, None)
    doc[SEAL_KEY] = make_seal(doc, schema, version)
    blob = (json.dumps(doc, indent=1, sort_keys=True) + "\n").encode()
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    atomic_write_bytes(path, blob)
    return path


def verify_payload(doc: dict, path: str, artifact: str = "",
                   registry=None) -> "dict | None":
    """Verify a parsed sealed document in place (its seal is popped) and
    return the seal, or None for an unsealed file, which loads. A digest
    mismatch raises :class:`ArtifactCorrupt`, counted. Loaders run their
    own format checks first, so a wrong version keeps its own error."""
    seal = doc.pop(SEAL_KEY, None)
    if seal is None:
        return None
    actual = payload_digest(doc)
    expected = str(seal.get("sha256", ""))
    if actual != expected:
        count_corrupt(artifact or str(seal.get("schema", "unknown")),
                      registry=registry)
        raise ArtifactCorrupt(path, expected, actual, artifact=artifact)
    return seal


def read_sealed_json(path: str, artifact: str = "",
                     registry=None) -> "tuple[dict, dict | None]":
    """(payload, seal or None), the digest verified."""
    with open(path, encoding="utf-8") as f:
        doc = json.load(f)
    if not isinstance(doc, dict):
        raise ValueError(f"{path} is not a JSON object artifact")
    return doc, verify_payload(doc, path, artifact=artifact,
                               registry=registry)


def sidecar_path(path: str) -> str:
    return path + ".seal.json"


def write_seal_sidecar(path: str, schema: str, version,
                       blob: "bytes | None" = None) -> str:
    """Seal the binary artifact at ``path`` with a sidecar pinning its
    size and sha256: of ``blob``, the bytes the writer meant, when
    given, else of the file."""
    if blob is not None:
        size, digest = len(blob), hashlib.sha256(blob).hexdigest()
    else:
        size, digest = os.path.getsize(path), sha256_file(path)
    payload = {"target": os.path.basename(path), "bytes": size,
               "sha256": digest}
    return write_sealed_json(sidecar_path(path), payload, schema, version)


def verify_sidecar(path: str, artifact: str = "", registry=None) -> str:
    """``"ok"`` when the file matches its sidecar, ``"unsealed"`` when it
    has none; a size or digest that disagrees raises
    :class:`ArtifactCorrupt`, counted."""
    sc = sidecar_path(path)
    if not os.path.exists(sc):
        return "unsealed"
    payload, _ = read_sealed_json(sc, artifact=artifact, registry=registry)
    want_bytes = int(payload.get("bytes", -1))
    if not os.path.exists(path) or os.path.getsize(path) != want_bytes:
        have = os.path.getsize(path) if os.path.exists(path) else -1
        count_corrupt(artifact or "sidecar", registry=registry)
        raise ArtifactCorrupt(path, f"{want_bytes} bytes", f"{have} bytes",
                              artifact=artifact,
                              detail="size mismatch vs seal sidecar")
    actual = sha256_file(path)
    expected = str(payload.get("sha256", ""))
    if actual != expected:
        count_corrupt(artifact or "sidecar", registry=registry)
        raise ArtifactCorrupt(path, expected, actual, artifact=artifact)
    return "ok"
