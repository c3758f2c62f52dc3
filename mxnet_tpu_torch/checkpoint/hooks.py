"""Emergency-save hooks: flush a checkpoint on SIGTERM / interpreter
exit, so a preempted worker (spot VM reclaim, k8s pod eviction — the
cloud sends SIGTERM and gives you seconds) resumes from its last step
instead of its last periodic checkpoint.

The port's copy of ``mxnet_tpu/checkpoint/hooks.py``: after the save the
hook dumps the flight ring (``reason="preempt"``) and writes the run
journal's terminal ``preempted`` entry.
"""
from __future__ import annotations

import atexit
import logging
import signal
import sys
from typing import Callable, Tuple

from ..analysis.sanitizer import make_lock
from .manager import CheckpointManager

log = logging.getLogger(__name__)


class _PreemptionHook:
    def __init__(self, manager: CheckpointManager,
                 state_fn: Callable[[], Tuple[int, dict]],
                 signals, exit_on_signal: bool):
        self.manager = manager
        self.state_fn = state_fn
        self.exit_on_signal = exit_on_signal
        self._fired = False
        self._lock = make_lock("checkpoint.hooks.fired")
        self._prev = {}
        self._signals = tuple(signals)
        self._atexit_registered = False

    def _save_once(self, why: str) -> None:
        with self._lock:
            if self._fired:
                return
            self._fired = True
        step = None
        try:
            step, state = self.state_fn()
            if self.manager._last_saved_step == int(step) and \
                    self.manager.all_finished():
                log.info("preemption hook (%s): step %d already saved",
                         why, step)
                return
            log.warning("preemption hook (%s): saving checkpoint step %d "
                        "to %s", why, step, self.manager.directory)
            # synchronous: the process is about to die, there is no
            # background left to rely on
            self.manager.save(int(step), state, block=True,
                              meta={"emergency": why})
            # and drain anything training had queued before the signal —
            # the daemon writer thread dies with the process
            self.manager.wait(timeout=300)
        except Exception as e:  # noqa: BLE001 — dying anyway; log, don't mask
            log.error("preemption-hook save failed: %s", e)
        finally:
            # the timeline of what the run was doing when it was reclaimed,
            # after the save (its spans belong in the dump), inline (the
            # process is exiting), never masking a save failure
            self._dump_flight()
            # the journal's terminal entry, fsync'd before the exit
            try:
                from ..observability import journal as _journal
                if _journal.ENABLED:
                    _journal.emit("preempted", step=step, durable=True,
                                  why=why)
            except Exception as e:  # noqa: BLE001 — dying anyway
                log.error("preemption-hook journal entry failed: %s", e)

    @staticmethod
    def _dump_flight() -> None:
        try:
            from ..observability import flight as _flight
            if _flight.ENABLED:
                path = _flight.dump(reason="preempt")
                log.warning("preemption hook: flight timeline dumped to %s",
                            path)
        except Exception as e:  # noqa: BLE001
            log.error("preemption-hook flight dump failed: %s", e)

    def _on_signal(self, signum, frame):
        self._save_once(f"signal {signum}")
        prev = self._prev.get(signum)
        if callable(prev):
            prev(signum, frame)
        elif self.exit_on_signal:
            # 128+signum: the exit status a signal-terminated process
            # reports, so supervisors still see "killed by SIGTERM"
            sys.exit(128 + signum)

    def _on_atexit(self):
        self._save_once("atexit")

    def install(self, use_atexit: bool) -> None:
        for sig in self._signals:
            self._prev[sig] = signal.signal(sig, self._on_signal)
        if use_atexit:
            atexit.register(self._on_atexit)
            self._atexit_registered = True

    def uninstall(self) -> None:
        for sig, prev in self._prev.items():
            try:
                signal.signal(sig, prev if prev is not None
                              else signal.SIG_DFL)
            except (ValueError, OSError):  # non-main thread / exotic sig
                pass
        self._prev.clear()
        if self._atexit_registered:
            try:
                atexit.unregister(self._on_atexit)
            except Exception:  # noqa: BLE001
                pass
            self._atexit_registered = False


def install_preemption_hook(
        manager: CheckpointManager,
        state_fn: Callable[[], Tuple[int, dict]],
        signals=(signal.SIGTERM,),
        use_atexit: bool = True,
        exit_on_signal: bool = True) -> Callable[[], None]:
    """Arrange an emergency synchronous checkpoint on SIGTERM (and,
    optionally, normal interpreter exit).

    ``state_fn() -> (step, state)`` is called AT SAVE TIME from the
    main thread, so it should read live training state (e.g. close
    over the trainer and a step counter).  The save runs at most once
    per install, is skipped when ``step`` is already on disk, and uses
    the manager's full retry + atomic-commit path.  Returns an
    ``uninstall()`` callable that restores the previous handlers.

    Must be called from the main thread (CPython restricts
    ``signal.signal`` to it).
    """
    hook = _PreemptionHook(manager, state_fn, signals, exit_on_signal)
    hook.install(use_atexit)
    return hook.uninstall
