"""Operator entry point of the drift-to-retrain lifecycle (counterpart of
``scripts/lifecycle_run.py``), over a serving deployment's workdir:

    # journal state, live pointer and the last cycle's timeline:
    python -m jama16_retina_tpu_torch.lifecycle_run --workdir WD --status

    # open a cycle by hand (what an AlertManager(on_fire=) trigger does
    # inside a serving session):
    python -m jama16_retina_tpu_torch.lifecycle_run --workdir WD \\
        --trigger manual --ckpt /ckpt/member_00

    # one journaled transition, then exit; re-run until COMMIT/ROLLBACK
    # (killing it at any point is safe: the journal resumes it):
    python -m jama16_retina_tpu_torch.lifecycle_run --workdir WD \\
        --data_dir /data/eyepacs --ckpt /ckpt/member_00 --step

    # supervise: drive open cycles to their end, picking up --trigger
    # appends from other invocations:
    python -m jama16_retina_tpu_torch.lifecycle_run --workdir WD \\
        --data_dir /data/eyepacs --ckpt /ckpt/member_00 --watch

``--step`` and ``--watch`` build a ``ServingEngine`` from the journal's
live pointer (else ``--ckpt``) through ``serve/assemble.py`` on
``--device`` (the card by default; ``--device cpu`` runs on the CPU
deliberately), so the gates, shadow scoring, promote, rollback and the
retrain's fits run against real model state there. ``--status`` and
``--trigger`` touch only the journal.

Exit codes: 0 ok (for ``--step``: a transition applied or nothing to
do); 2 the cycle reached ROLLBACK in this invocation.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time


def _build_controller(cfg, args):
    from jama16_retina_tpu_torch.lifecycle import Journal, LifecycleController
    from jama16_retina_tpu_torch.serve.assemble import EngineSpec, assemble

    journal = Journal(os.path.join(args.workdir, "lifecycle"))
    live = journal.read_live() or list(args.ckpt or ())
    if not live:
        raise SystemExit(
            "need the live checkpoint set: --ckpt member_dir [...] "
            "(or a journal live pointer from a previous promote)")
    engine = assemble(EngineSpec(cfg=cfg, member_dirs=tuple(live),
                                 device=args.device))
    return LifecycleController(cfg, args.workdir, engine=engine,
                               data_dir=args.data_dir, live_member_dirs=live)


def _status(args) -> int:
    from jama16_retina_tpu_torch.lifecycle import Journal

    journal = Journal(os.path.join(args.workdir, "lifecycle"))
    out = {
        "state": journal.state or "IDLE",
        "cycle": journal.cycle,
        "cycle_open": journal.cycle_open(),
        "live_member_dirs": journal.read_live(),
        "timeline": [
            {k: v for k, v in e.items() if k != "live_member_dirs"}
            for e in journal.cycle_entries()],
    }
    if args.json:
        print(json.dumps(out))
    else:
        print(f"state: {out['state']}  (cycle {out['cycle']}, "
              f"{'open' if out['cycle_open'] else 'closed'})")
        print(f"live:  {out['live_member_dirs'] or '(deployment config)'}")
        for e in out["timeline"]:
            extra = {k: v for k, v in e.items()
                     if k not in ("seq", "cycle", "state", "t")}
            print(f"  [{e['seq']}] {e['state']}"
                  + (f"  {extra}" if extra else ""))
    return 0


def _trigger(args) -> int:
    """The journal-only trigger: no engine and no device, safe from a cron
    job or an alert webhook. The process mints the cycle's trace context
    into the entry, so the steps another process runs share its id."""
    from jama16_retina_tpu_torch.lifecycle import Journal, TERMINAL_STATES
    from jama16_retina_tpu_torch.obs import trace as obs_trace

    journal = Journal(os.path.join(args.workdir, "lifecycle"),
                      terminal_states=TERMINAL_STATES)
    if journal.cycle_open():
        print(f"refused: cycle {journal.cycle} is open at {journal.state}")
        return 0
    live = journal.read_live() or list(args.ckpt or ())
    ctx = obs_trace.new_context()
    journal.append(
        "DRIFT_DETECTED", cycle=journal.cycle + 1, reason=args.trigger,
        live_member_dirs=live or None, source="lifecycle_run",
        trace=ctx.wire())
    print(f"cycle {journal.cycle} opened (reason={args.trigger}, "
          f"trace {ctx.trace_id})")
    return 0


def _watch(cfg, args, ctl) -> int:
    """The supervisor loop. A step that fails leaves the journal where it
    was, and the supervisor keeps driving after ``--poll_s``. With
    ``obs.enabled`` it exports its own heartbeat and telemetry into
    ``lifecycle.jsonl`` and ``lifecycle.prom`` (never the serving
    session's ``metrics.jsonl``: two writers would tear it)."""
    snap = None
    watch_log = None
    if cfg.obs.enabled:
        from jama16_retina_tpu_torch.obs import export as obs_export
        from jama16_retina_tpu_torch.utils.logging import RunLog

        watch_log = RunLog(args.workdir, name="lifecycle.jsonl")
        snap = obs_export.Snapshotter(
            workdir=args.workdir, runlog=watch_log,
            every_s=min(cfg.obs.flush_every_s, max(1.0, args.poll_s)),
            prom_name="lifecycle.prom")
    done = 0
    polls = 0
    try:
        while True:
            ctl.journal.refresh()
            polls += 1
            if snap is not None:
                # Progress is the poll count: alive but idle, or wedged.
                snap.progress(polls)
                snap.maybe_flush()
            if ctl.journal.cycle_open():
                try:
                    terminal = ctl.run()
                except Exception as e:  # noqa: BLE001 - retried step
                    print(f"step failed at {ctl.state} "
                          f"({type(e).__name__}: {e}); retrying in "
                          f"{args.poll_s:g}s")
                    time.sleep(args.poll_s)
                    continue
                if ctl.journal.cycle_open():
                    continue  # run() bounded out mid-cycle
                done += 1
                print(f"cycle {ctl.journal.cycle} -> {terminal}")
                if args.max_cycles and done >= args.max_cycles:
                    return 2 if terminal == "ROLLBACK" else 0
            else:
                time.sleep(args.poll_s)
    except KeyboardInterrupt:
        print(f"\nstopped at {ctl.state} (journal resumes it)")
        return 0
    finally:
        if snap is not None:
            snap.close()
        if watch_log is not None:
            watch_log.close()


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(
        description=__doc__,
        formatter_class=argparse.RawDescriptionHelpFormatter)
    parser.add_argument("--workdir", required=True,
                        help="the serving deployment's workdir (journal "
                             "lives under <workdir>/lifecycle)")
    parser.add_argument("--data_dir", default="",
                        help="dataset root: fresh training data for "
                             "RETRAIN + the val split the gates score")
    parser.add_argument("--ckpt", nargs="*", default=None, metavar="DIR",
                        help="live member checkpoint dirs (the fallback "
                             "identity before the first promote writes "
                             "the live pointer)")
    parser.add_argument("--config", default="eyepacs_binary",
                        help="config preset name")
    parser.add_argument("--set", action="append", default=[],
                        metavar="SECTION.FIELD=VALUE", dest="overrides",
                        help="config overrides (repeatable), e.g. "
                             "--set lifecycle.retrain_steps=2000")
    parser.add_argument("--device", choices=("cuda", "cpu"), default="cuda",
                        help="where --step/--watch serve and retrain")
    parser.add_argument("--status", action="store_true",
                        help="print journal state and exit (no engine)")
    parser.add_argument("--trigger", default=None, metavar="REASON",
                        help="open a cycle at DRIFT_DETECTED (refused "
                             "while one is open); journal-only")
    parser.add_argument("--step", action="store_true",
                        help="one-shot: execute exactly one transition")
    parser.add_argument("--watch", action="store_true",
                        help="supervise: drive open cycles to terminal, "
                             "polling the journal for new triggers")
    parser.add_argument("--poll_s", type=float, default=30.0,
                        help="--watch idle poll interval")
    parser.add_argument("--max_cycles", type=int, default=0,
                        help="--watch: exit after this many terminal "
                             "cycles (0 = run until interrupted)")
    parser.add_argument("--json", action="store_true",
                        help="machine-readable --status/--step output")
    args = parser.parse_args(argv)

    from jama16_retina_tpu_torch import configs

    cfg = configs.override(configs.get_config(args.config), args.overrides)

    if args.status:
        return _status(args)
    if args.trigger is not None and not (args.step or args.watch):
        return _trigger(args)
    if not (args.step or args.watch):
        parser.error("pick a mode: --status, --trigger, --step or --watch")

    ctl = _build_controller(cfg, args)
    if args.trigger is not None:
        ctl.trigger(reason=args.trigger)
    if args.watch:
        return _watch(cfg, args, ctl)
    entry = ctl.step()
    if args.json:
        print(json.dumps({
            "applied": entry is not None, "state": ctl.state,
            "entry": ({k: v for k, v in entry.items()
                       if k != "live_member_dirs"} if entry else None),
        }))
    elif entry is None:
        print(f"nothing to do (state {ctl.state})")
    else:
        print(f"-> {entry['state']} (cycle {entry['cycle']}, "
              f"seq {entry['seq']})")
    return 2 if ctl.state == "ROLLBACK" and entry is not None else 0


if __name__ == "__main__":
    sys.exit(main())
