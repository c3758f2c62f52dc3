"""Crash-durable run journal: append-only JSONL lifecycle log (parity:
``mxnet_tpu/observability/journal.py``; the file format is the same, so
either package's reporter reads what the other wrote).

Every other telemetry surface (metrics registry, flight ring, memory
ledger) lives in process memory and dies with the
process.  That is precisely backwards for the events an operator needs
*after* a crash: why did the run end, what was the last completed step,
which checkpoint is the resume point, how often did the supervisor
rewind.  This module is the survivor: a single append-only
``journal.jsonl`` under ``MXNET_RUN_DIR`` where each lifecycle event is
one self-contained JSON line written with a single ``write()`` call
(atomic at the OS level for sane line sizes) and — for *durable* events
(checkpoint saves, post-mortems, terminal preemption entries) —
``fsync``'d before the caller proceeds, so a SIGKILL one instruction
later still leaves the entry on disk.

Design points:

  * **Run-id continuity across restart.** The first process to open the
    journal mints ``run-<epoch>-<pidhex>`` and writes a
    ``process_start`` entry; a restarted process finds the existing
    ``journal.jsonl``, reads the run id from its first line, and keeps
    appending under the same id — so goodput accounting and the offline
    reporter see preemption→resume as one run with two incarnations.
  * **Never raises.** Journaling is observability, not control flow: a
    full disk degrades to a warning, not a dead training loop.
  * **Rotation-capped.** At ``MAX_BYTES`` the file shifts to
    ``journal.1.jsonl`` (one generation kept) and a fresh segment
    re-records the run header, so a runaway event source cannot eat the
    disk.
  * **Gate contract.** ``ENABLED`` is derived once at import from
    ``MXNET_RUN_DIR``; every hook in other modules reduces to
    ``if _journal.ENABLED:`` — one boolean, no env re-reads.

The offline consumer is ``python -m mxnet_tpu_torch.observability.report``
(``report.py``).
"""
from __future__ import annotations

import json
import logging
import os
import time
from typing import IO, Optional

from ..base import getenv
from ..analysis.sanitizer import make_lock

log = logging.getLogger(__name__)

__all__ = ["ENABLED", "RUN_DIR", "emit", "run_id", "path", "note_dump",
           "resume_marker", "maybe_milestone", "configure", "reset",
           "FILE_NAME", "MAX_BYTES", "MILESTONE_EVERY"]

#: run directory; empty string == journaling off.  Read ONCE at import —
#: the journal is a process-lifetime artifact, not a per-call toggle.
RUN_DIR: str = getenv("MXNET_RUN_DIR", "")

#: the one-boolean gate every cross-module hook tests.
#: Deliberately derived from RUN_DIR rather than a dedicated bool env:
#: "journaling on" and "where the journal lives" are the same fact.
ENABLED: bool = bool(RUN_DIR)

#: journal segment filename inside the run dir
FILE_NAME = "journal.jsonl"

#: rotate the active segment past this size (one prior generation kept)
MAX_BYTES: int = 64 * 1024 * 1024

#: step milestones are recorded every N steps per source (tests set 1)
MILESTONE_EVERY: int = 25

_lock = make_lock("journal.file")
_fh: Optional[IO[str]] = None
_run_id: Optional[str] = None
_bytes: int = 0
# per-source last-milestone step, so trainer/wholestep/supervisor each
# get their own cadence without double-recording the same step
_milestone_at: dict = {}


# ---------------------------------------------------------------------------
# open / run-id continuity
# ---------------------------------------------------------------------------
def _read_existing_run_id(fpath: str) -> Optional[str]:
    """Recover the run id from an existing journal's first valid line —
    a torn tail (SIGKILL mid-write) must not break resumption, so every
    line is parsed tolerantly until one carries ``run``."""
    try:
        with open(fpath, "r", encoding="utf-8") as f:
            for raw in f:
                try:
                    rid = json.loads(raw).get("run")
                except Exception:  # noqa: BLE001 — torn line, keep scanning
                    continue
                if rid:
                    return str(rid)
    except OSError:
        return None
    return None


def _open_locked() -> Optional[IO[str]]:
    """Open (creating) the active journal segment; mint or resume the
    run id.  Caller holds ``_lock``."""
    global _fh, _run_id, _bytes
    if _fh is not None:
        return _fh
    if not ENABLED:
        return None
    try:
        os.makedirs(RUN_DIR, exist_ok=True)
        fpath = os.path.join(RUN_DIR, FILE_NAME)
        existing = _read_existing_run_id(fpath)
        resumed = existing is not None
        if resumed:
            _run_id = existing
        else:
            _run_id = "run-%d-%x" % (int(time.time()), os.getpid())
        # append-only ON PURPOSE: the journal's durability unit is one
        # LINE (single write() + fsync), not the file — atomic_write's
        # tmp+rename would wipe prior incarnations' entries, the exact
        # history the journal exists to keep.  A torn tail line is
        # expected after SIGKILL and every reader skips it
        # (_read_existing_run_id, report.py).
        _fh = open(fpath, "a", encoding="utf-8")
        _bytes = _fh.tell()
        _write_locked({"event": "process_start", "run": _run_id,
                       "t": time.time(), "pid": os.getpid(),
                       "resumed": resumed}, durable=True)
    except Exception as e:  # noqa: BLE001 — journal must never kill the run
        log.warning("run journal open failed (%s): %s", RUN_DIR, e)
        _fh = None
        _run_id = None
    return _fh


def _rotate_locked() -> None:
    """Shift the active segment to ``journal.1.jsonl`` and start fresh
    (re-recording the run header so each segment is self-describing)."""
    global _fh, _bytes
    if _fh is None:
        return
    try:
        _fh.close()
    except Exception:  # noqa: BLE001
        pass
    _fh = None
    fpath = os.path.join(RUN_DIR, FILE_NAME)
    old = os.path.join(RUN_DIR, "journal.1.jsonl")
    try:
        os.replace(fpath, old)
    except OSError as e:
        log.warning("journal rotation failed: %s", e)
    try:
        _fh = open(fpath, "a", encoding="utf-8")
        _bytes = 0
        _write_locked({"event": "rotated", "run": _run_id,
                       "t": time.time(), "pid": os.getpid()},
                      durable=True)
    except Exception as e:  # noqa: BLE001
        log.warning("journal reopen after rotation failed: %s", e)
        _fh = None


def _write_locked(entry: dict, durable: bool = False) -> None:
    """Serialize + append one line; fsync when durable.  Caller holds
    ``_lock`` and guarantees ``_fh`` is open."""
    global _bytes
    line = json.dumps(entry, default=str, separators=(",", ":")) + "\n"
    _fh.write(line)
    _fh.flush()
    if durable:
        os.fsync(_fh.fileno())
    _bytes += len(line)
    if _bytes > MAX_BYTES:
        _rotate_locked()


# ---------------------------------------------------------------------------
# public API
# ---------------------------------------------------------------------------
def emit(event: str, step: Optional[int] = None, durable: bool = False,
         **fields) -> Optional[dict]:
    """Append one journal entry: ``{"event", "run", "t", "pid",
    ["step"], **fields}``.  ``durable=True`` fsyncs before returning —
    reserve it for lifecycle events (saves, post-mortems, terminal
    entries); milestones ride the page cache.  Never raises; returns the
    entry dict (tests) or ``None`` when disabled/failed.

    ``event`` must be a bounded literal name (a dynamically built one
    makes the journal's event set unbounded); put variability in
    ``fields``.
    """
    if not ENABLED:
        return None
    try:
        with _lock:
            if _open_locked() is None:
                return None
            entry = {"event": event, "run": _run_id, "t": time.time(),
                     "pid": os.getpid()}
            if step is not None:
                entry["step"] = int(step)
            entry.update(fields)
            _write_locked(entry, durable=durable)
            return entry
    except Exception as e:  # noqa: BLE001 — never let the journal kill a run
        log.warning("journal emit(%s) failed: %s", event, e)
        return None


def run_id() -> Optional[str]:
    """The active run id (minted or resumed), ``None`` when disabled."""
    if not ENABLED:
        return None
    with _lock:
        _open_locked()
        return _run_id


def path() -> Optional[str]:
    """Absolute path of the active journal segment, ``None`` when
    disabled — what post-mortems embed so an operator can pivot from a
    crash report to the run timeline."""
    if not ENABLED:
        return None
    return os.path.abspath(os.path.join(RUN_DIR, FILE_NAME))


def note_dump(dump_path: Optional[str], reason: str) -> None:
    """Cross-reference a flight/post-mortem dump file in the journal
    (journal rows carry dump filenames and dumps carry the run id, so
    either leads to the other)."""
    if not ENABLED or not dump_path:
        return
    emit("flight_dump", durable=False, dump_path=dump_path, why=reason)


def resume_marker(step: int, source: str = "checkpoint", **fields) -> None:
    """Record that a restarted process re-entered training at ``step``
    (called from ``restore_trainer``/``restore_or_initialize``) — the
    durable stitch between incarnations of one run."""
    if not ENABLED:
        return
    emit("run_resumed", step=step, durable=True, source=source, **fields)


def maybe_milestone(step: int, source: str, **fields) -> None:
    """Record a step milestone every ``MILESTONE_EVERY`` steps per
    source, annotated with the live goodput summary when available.
    Non-durable (milestones are recoverable by replay; fsync here would
    tax the hot loop)."""
    if not ENABLED:
        return
    last = _milestone_at.get(source)
    if last is not None and step - last < MILESTONE_EVERY:
        return
    _milestone_at[source] = step
    try:
        from . import goodput as _goodput
        if _goodput.ENABLED:
            g = _goodput.report()
            fields.setdefault("goodput_pct", g.get("goodput_pct"))
            fields.setdefault("classes", g.get("classes"))
    except Exception:  # noqa: BLE001 — milestone stays useful without goodput
        pass
    emit("milestone", step=step, durable=False, source=source, **fields)


# ---------------------------------------------------------------------------
# test plumbing
# ---------------------------------------------------------------------------
def configure(run_dir: Optional[str] = None) -> None:
    """Re-point the journal (tests): closes the active segment, resets
    run-id/milestone state, and re-derives ``ENABLED`` from the new
    directory (empty string disables)."""
    global RUN_DIR, ENABLED
    reset()
    if run_dir is not None:
        RUN_DIR = run_dir
        ENABLED = bool(run_dir)


def reset() -> None:
    """Close the journal and drop in-memory state (tests).  The file on
    disk is left alone — that is the whole point of the journal."""
    global _fh, _run_id, _bytes
    with _lock:
        if _fh is not None:
            try:
                _fh.close()
            except Exception:  # noqa: BLE001
                pass
        _fh = None
        _run_id = None
        _bytes = 0
        _milestone_at.clear()
