"""The lifecycle's crash-safe journal (counterpart of
``jama16_retina_tpu/lifecycle/journal.py``): the controller's only
durable state.

The state machine (``lifecycle/controller.py``) performs one idempotent
step per transition and appends the arrival record here. The whole file
is rewritten atomically on every append (``integrity/artifact.py``: a
temporary file, fsync, rename, and an embedded seal), so a reader, or a
controller resumed after kill -9, sees the journal before the transition
or after it, never a torn file. A ``.tmp`` leftover of a killed write is
ignored and overwritten by the next append.

Entries are append-only dicts::

    {"seq": N, "cycle": C, "state": "<STATE>", "t": <unix>, ...payload}

``state`` names the state the controller has arrived at with that
state's work complete: a ``RETRAIN`` entry means the candidate
checkpoints it lists are durable. One journal spans many cycles (one a
trigger); ``cycle_entries()`` returns the newest cycle's entries, all a
resuming controller needs.

Beside the journal lives the live pointer (``live.json``, written the
same way): the checkpoint set the serving engine should be built from.
The promote and rollback steps update it before journaling their
transition, so re-applying a half-done swap after a crash is a pointer
read and a reload. The file format, the seal's schemas and the bytes
written for the same entries and clock are the reference's: either
package reads the other's journal.
"""

from __future__ import annotations

import json
import os
import time

from jama16_retina_tpu_torch.integrity import artifact as artifact_lib

FORMAT = "jama16.lifecycle"
VERSION = 1


class Journal:
    """The append-only, atomically rewritten transition journal.

    Built over a directory (made at the first append); an existing
    journal loads at once, version-checked and seal-verified. A torn or
    unparseable file raises ``ValueError``, a wrong format or version
    raises ``ValueError`` naming it, and a seal that disagrees with the
    content raises ``ArtifactCorrupt``: a controller never restarts a
    half-done rollout from a guess. ``now_fn`` is the clock of the
    entries' ``t`` (injected so that tests can pin the bytes)."""

    def __init__(self, journal_dir: str,
                 terminal_states=("COMMIT", "ROLLBACK"), now_fn=time.time):
        self._now = now_fn
        self.dir = journal_dir
        self.path = os.path.join(journal_dir, "journal.json")
        self.live_path = os.path.join(journal_dir, "live.json")
        self._terminal = tuple(terminal_states)
        self.entries: list[dict] = []
        if os.path.exists(self.path):
            try:
                with open(self.path) as f:
                    doc = json.load(f)
            except (OSError, json.JSONDecodeError) as e:
                raise ValueError(
                    f"lifecycle journal {self.path} is unreadable "
                    f"({type(e).__name__}: {e}); refusing to guess at "
                    "rollout state — inspect or move it aside") from e
            if doc.get("format") != FORMAT or doc.get("version") != VERSION:
                raise ValueError(
                    f"lifecycle journal {self.path} has format "
                    f"{doc.get('format')!r} v{doc.get('version')!r}; this "
                    f"code reads {FORMAT} v{VERSION}")
            # After the format refusal, so a hand-bumped version keeps its
            # own error.
            artifact_lib.verify_payload(doc, self.path, artifact="journal")
            self.entries = list(doc.get("entries", ()))

    # -- reads ---------------------------------------------------------------

    def refresh(self) -> None:
        """Re-read the entries from disk: a supervising ``--watch`` picks
        up a ``--trigger`` another process appended. Writers never
        interleave: a trigger appends only to a closed cycle, the
        supervisor only to an open one."""
        if os.path.exists(self.path):
            with open(self.path) as f:
                self.entries = list(json.load(f).get("entries", ()))

    @property
    def state(self) -> "str | None":
        """The newest entry's state (None: an empty journal)."""
        return self.entries[-1]["state"] if self.entries else None

    @property
    def cycle(self) -> int:
        """The newest cycle id (-1 before the first trigger)."""
        return self.entries[-1]["cycle"] if self.entries else -1

    def cycle_entries(self, cycle: "int | None" = None) -> list[dict]:
        """The entries of ``cycle`` (default: the newest)."""
        c = self.cycle if cycle is None else cycle
        return [e for e in self.entries if e["cycle"] == c]

    def cycle_open(self) -> bool:
        """True while the newest cycle has not reached a terminal state:
        exactly when a trigger must be refused."""
        return bool(self.entries) and self.state not in self._terminal

    def find(self, state: str, cycle: "int | None" = None) -> "dict | None":
        """The newest entry for ``state`` within one cycle (the
        idempotency lookup: did this step already complete?)."""
        for e in reversed(self.cycle_entries(cycle)):
            if e["state"] == state:
                return e
        return None

    # -- writes --------------------------------------------------------------

    def append(self, state: str, cycle: "int | None" = None,
               **payload) -> dict:
        """One completed transition, durably. Returns the entry."""
        entry = {
            "seq": len(self.entries),
            "cycle": self.cycle + 1 if cycle is None else cycle,
            "state": state,
            "t": round(self._now(), 3),
            **payload,
        }
        self.entries.append(entry)
        os.makedirs(self.dir, exist_ok=True)
        artifact_lib.write_sealed_json(self.path, {
            "format": FORMAT, "version": VERSION, "entries": self.entries,
        }, schema="lifecycle.journal", version=VERSION)
        return entry

    # -- the live pointer ----------------------------------------------------

    def read_live(self) -> "list[str] | None":
        """The blessed serving checkpoint set (None: never written, serve
        what the deployment names), seal-verified: a corrupt pointer
        raises ``ArtifactCorrupt``."""
        if not os.path.exists(self.live_path):
            return None
        doc, _seal = artifact_lib.read_sealed_json(self.live_path,
                                                   artifact="live")
        return list(doc["member_dirs"])

    def write_live(self, member_dirs) -> None:
        os.makedirs(self.dir, exist_ok=True)
        artifact_lib.write_sealed_json(self.live_path, {
            "format": FORMAT, "version": VERSION,
            "member_dirs": list(member_dirs),
            "t": round(self._now(), 3),
        }, schema="lifecycle.live", version=VERSION)
