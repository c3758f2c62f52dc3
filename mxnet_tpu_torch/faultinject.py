"""Deterministic fault injection — make failure behavior *testable*
(parity: ``mxnet_tpu/faultinject.py``).

A ``FaultPlan`` maps named injection *sites* to deterministic fault
rules (raise / delay / corrupt, with exact occurrence windows — no
randomness, so a chaos test that passes once passes always), and the
runtime calls ``fire(site)`` at each wired site.  With no plan installed
``fire`` is one module-global ``is None`` test.

A captured CUDA graph runs no Python when it replays, so every site
fires on the host BEFORE the replay call, never inside a captured
region: an injected raise leaves every tensor as the previous step left
it.  Wired sites:

  ======================  ==================================================
  ``serving.dispatch``    ``BucketedPredictor`` — every bucket dispatch
                          (delay = slow model, raise = failed dispatch
                          routed to the caller/future)
  ``serving.batcher``     ``MicroBatcher`` dispatcher thread, before each
                          group dispatch (raise = worker death; pending
                          futures fail typed, never hang)
  ``serving.hot_reload``  ``BucketedPredictor.hot_reload`` entry (raise =
                          failed weight swap; old weights keep serving)
  ``checkpoint.io``       ``CheckpointManager`` write attempts (raise
                          ``OSError`` to exercise the retry path, the
                          default ``InjectedFault`` to exhaust it) plus a
                          post-write ``corrupt`` hook that flips bytes in a
                          committed shard (restore must skip it via CRC)
  ``memory.oom``          the dispatch chokepoints guarded by
                          ``memory.oom_guard`` (the executor's fused step,
                          the fused update, the serving dispatch) — a
                          ``raise`` rule is a synthetic out-of-memory
                          (``is_oom`` matches the site name)
  ``trainer.step``        every Gluon training step — ``Trainer.step``,
                          ``WholeStepCompiler`` before its replay call and
                          ``SuperStepCompiler`` once per training step
                          (raise = failed step the ``TrainingSupervisor``
                          classifies and retries; delay = slow step that
                          feeds the stall watchdog)
  ``data.batch``          ``AsyncPrefetcher`` worker, before each source
                          read (raise ``OSError`` = transient IO the
                          worker respawns once over; raise
                          ``DataCorruptionError`` = corrupt record the
                          ``MXNET_DATA_SKIP_BUDGET`` consumes)
  ``kvstore.allreduce``   ``KVStore.allreduce`` entry — the fused
                          Trainer's bucketed reduce (the whole step
                          reduces inline and does not fire it)
  ``device.unavailable``  the whole step's dispatch and the fused update —
                          a ``raise`` rule defaults to the typed
                          ``DeviceUnavailableError`` (classified
                          transient)
  ======================  ==================================================

Configuration is API- or env-driven::

    plan = faultinject.FaultPlan()
    plan.add("serving.dispatch", "delay", delay_s=0.05)
    plan.add("checkpoint.io", "raise", exc=OSError, times=2)
    with faultinject.active(plan):
        ...  # chaos test body

    MXNET_FAULT_PLAN="serving.dispatch:delay:0.05;checkpoint.io:raise:OSError:2"

The env form is parsed at import (and by ``install_from_env()``), so a
subprocess chaos drill needs no code changes.
"""
from __future__ import annotations

import logging
import os
import threading
import time
from contextlib import contextmanager
from typing import Callable, Dict, List, Optional

from .base import MXNetError
from .observability import metrics as _metrics
from .resilience import DataCorruptionError, DeviceUnavailableError

__all__ = ["InjectedFault", "FaultRule", "FaultPlan", "parse_plan",
           "install", "install_from_env", "clear", "active", "plan",
           "fire", "SITES", "ENV_VAR"]

log = logging.getLogger(__name__)

ENV_VAR = "MXNET_FAULT_PLAN"

#: the named sites the runtime has wired (fire() accepts any name — new
#: sites need no registration — but these are the documented ones)
SITES = ("serving.dispatch", "serving.batcher", "serving.hot_reload",
         "serving.evict", "serving.decode_step", "checkpoint.io",
         "memory.oom", "trainer.step", "data.batch",
         "kvstore.allreduce", "kvstore.sparse_allreduce",
         "device.unavailable")

_MODES = ("raise", "delay", "corrupt")


class InjectedFault(MXNetError):
    """The default exception a ``raise`` rule throws — typed, so tests
    and operators can tell an injected failure from an organic one."""


# exception classes the env syntax may name.  OSError is the important
# one: the checkpoint retry loop only retries OSError/IOError, so
# "checkpoint.io:raise:OSError:2" exercises retry-and-recover while the
# default InjectedFault exhausts straight to a CheckpointError.
_EXC_TYPES: Dict[str, type] = {
    "InjectedFault": InjectedFault,
    "MXNetError": MXNetError,
    "OSError": OSError,
    "IOError": IOError,
    "RuntimeError": RuntimeError,
    "TimeoutError": TimeoutError,
    # the training-resilience taxonomy (resilience.py): a
    # transient device loss and a corrupt input record, so a chaos plan
    # can drive the supervisor retry and the data skip budget by name
    "DeviceUnavailableError": DeviceUnavailableError,
    "DataCorruptionError": DataCorruptionError,
}


class FaultRule:
    """One deterministic fault at one site.

    Parameters
    ----------
    site : str
        Injection-site name (see ``SITES``).
    mode : str
        ``"raise"`` | ``"delay"`` | ``"corrupt"``.
    delay_s : float
        Sleep duration for ``delay`` rules.
    exc : type
        Exception class for ``raise`` rules (default ``InjectedFault``).
    message : str, optional
        Exception message for ``raise`` rules.
    times : int, optional
        Fire on at most this many matching ``fire()`` calls (None =
        every call).
    after : int
        Skip the first ``after`` matching calls (fire on calls
        ``after .. after+times-1``) — lets a plan hit exactly the Nth
        dispatch.
    """

    def __init__(self, site: str, mode: str, delay_s: float = 0.0,
                 exc: type = InjectedFault, message: Optional[str] = None,
                 times: Optional[int] = None, after: int = 0):
        if mode not in _MODES:
            raise MXNetError(f"fault mode must be one of {_MODES}, "
                             f"got {mode!r}")
        if times is not None and times < 1:
            raise MXNetError(f"times must be >= 1 (or None), got {times}")
        if after < 0 or delay_s < 0:
            raise MXNetError("after/delay_s must be >= 0")
        self.site = str(site)
        self.mode = mode
        self.delay_s = float(delay_s)
        if exc is InjectedFault and self.site == "device.unavailable":
            # the site's whole point is modeling a transient device
            # loss — default its raise rules to the typed error the
            # resilience classifier maps to "transient"
            exc = DeviceUnavailableError
        self.exc = exc
        self.message = message
        self.times = times
        self.after = int(after)
        self.seen = 0   # matching fire() calls observed
        self.fired = 0  # times this rule actually acted

    def _should_fire(self) -> bool:
        """Advance the occurrence window.  Caller holds the plan lock."""
        idx = self.seen
        self.seen += 1
        if idx < self.after:
            return False
        if self.times is not None and idx >= self.after + self.times:
            return False
        self.fired += 1
        return True

    def __repr__(self):
        win = f"[{self.after}:" + (
            f"{self.after + self.times}]" if self.times is not None else "]")
        return (f"FaultRule({self.site}:{self.mode} {win} "
                f"fired={self.fired})")


class FaultPlan:
    """An ordered set of ``FaultRule``s; install process-wide with
    ``faultinject.install(plan)`` / ``with faultinject.active(plan):``."""

    def __init__(self):
        self._rules: List[FaultRule] = []
        from .analysis.sanitizer import make_lock
        self._lock = make_lock("faultinject.plan")

    def add(self, site: str, mode: str, **kw) -> "FaultPlan":
        """Append a rule (chainable): ``plan.add("serving.dispatch",
        "delay", delay_s=0.05).add("checkpoint.io", "raise",
        exc=OSError, times=2)``."""
        with self._lock:
            self._rules.append(FaultRule(site, mode, **kw))
        return self

    def rules(self, site: Optional[str] = None) -> List[FaultRule]:
        with self._lock:
            return [r for r in self._rules
                    if site is None or r.site == site]

    def stats(self) -> Dict[str, int]:
        """Per-site fired counts — chaos tests assert on these."""
        out: Dict[str, int] = {}
        with self._lock:
            for r in self._rules:
                out[r.site] = out.get(r.site, 0) + r.fired
        return out

    def reset(self) -> None:
        """Zero every rule's occurrence window (reuse one plan across
        test cases)."""
        with self._lock:
            for r in self._rules:
                r.seen = r.fired = 0

    # -- the injection hook --------------------------------------------------
    def _fire(self, site: str, only: Optional[str],
              corrupt: Optional[Callable[[], None]], ctx: dict) -> None:
        # decide under the lock (deterministic windows even with
        # concurrent fire()s), act outside it (a delay rule must not
        # serialize unrelated sites)
        firing: List[FaultRule] = []
        with self._lock:
            for r in self._rules:
                if r.site != site or (only is not None and r.mode != only):
                    continue
                if r.mode == "corrupt" and corrupt is None:
                    # corrupt rules act only at call points that offer
                    # a corruption hook — a hook-less fire() at the same
                    # site must not consume the occurrence window
                    continue
                if r._should_fire():
                    firing.append(r)
        for r in firing:
            if _metrics.ENABLED:
                _metrics.FAULTS_INJECTED.inc(site=site, mode=r.mode)
            log.warning("faultinject: %s at %s %s", r.mode, site,
                        ctx if ctx else "")
            if r.mode == "delay":
                time.sleep(r.delay_s)
            elif r.mode == "corrupt":
                if corrupt is not None:
                    corrupt()
            else:  # raise
                msg = r.message or (
                    f"injected fault at {site} "
                    f"(occurrence {r.fired - 1 + r.after})")
                raise r.exc(msg)


# ---------------------------------------------------------------------------
# process-wide active plan
# ---------------------------------------------------------------------------
_ACTIVE: Optional[FaultPlan] = None


def fire(site: str, only: Optional[str] = None,
         corrupt: Optional[Callable[[], None]] = None, **ctx) -> None:
    """The runtime-side hook: no-op (one global read) unless a plan is
    installed.  ``only`` restricts which rule modes may act at this call
    point (the checkpoint writer fires ``only="corrupt"`` AFTER the
    commit so a raise rule cannot double-fire); ``corrupt`` is the
    call-site-supplied mutator a corrupt rule invokes."""
    plan_ = _ACTIVE
    if plan_ is None:
        return
    plan_._fire(site, only, corrupt, ctx)


def install(plan_: Optional[FaultPlan]) -> Optional[FaultPlan]:
    """Install ``plan_`` process-wide (None clears).  Returns the
    previously active plan."""
    global _ACTIVE
    prev = _ACTIVE
    _ACTIVE = plan_
    return prev


def clear() -> None:
    install(None)


def plan() -> Optional[FaultPlan]:
    """The currently active plan (None = fault injection off)."""
    return _ACTIVE


@contextmanager
def active(plan_: FaultPlan):
    """Scope a plan to a with-block — the chaos-test idiom.  Restores
    whatever was active before (usually nothing) on exit, even when the
    body raises."""
    prev = install(plan_)
    try:
        yield plan_
    finally:
        install(prev)


# ---------------------------------------------------------------------------
# env-driven configuration
# ---------------------------------------------------------------------------
def parse_plan(spec: str) -> FaultPlan:
    """Parse the ``MXNET_FAULT_PLAN`` syntax: rules separated by ``;``
    (or ``,``), each ``site:mode[:arg][:times[:after]]``::

        serving.dispatch:delay:0.05        # 50 ms delay, every dispatch
        serving.batcher:raise              # InjectedFault, every group
        checkpoint.io:raise:OSError:2      # OSError on the first 2 writes
        checkpoint.io:corrupt:1            # corrupt the first commit
        trainer.step:raise:OSError:1:6     # fail exactly the 7th step

    ``arg`` is seconds for ``delay`` and an exception name for ``raise``
    (InjectedFault, MXNetError, OSError, IOError, RuntimeError,
    TimeoutError, DeviceUnavailableError, DataCorruptionError; a bare
    ``device.unavailable:raise`` defaults to DeviceUnavailableError);
    for ``corrupt`` the first optional slot holds ``times`` directly.
    ``after`` skips that many matching occurrences first (the
    ``FaultRule`` window, so an env-driven drill can hit exactly the
    Nth step/dispatch).  Malformed specs — unknown tokens and TRAILING
    EXTRAS included — raise loudly: a silently-ignored field would make
    a chaos drill pass vacuously."""
    out = FaultPlan()
    for token in spec.replace(";", ",").split(","):
        token = token.strip()
        if not token:
            continue
        parts = token.split(":")
        if len(parts) < 2:
            raise MXNetError(f"{ENV_VAR}: rule {token!r} needs at least "
                             f"site:mode")
        site, mode, rest = parts[0], parts[1], parts[2:]
        try:
            if mode == "delay":
                if not rest:
                    raise ValueError("delay needs seconds")
                kw = {"delay_s": float(rest[0])}
            elif mode == "raise":
                kw = {}
                if rest:
                    if rest[0] not in _EXC_TYPES:
                        raise ValueError(
                            f"unknown exception {rest[0]!r} (have "
                            f"{sorted(_EXC_TYPES)})")
                    kw["exc"] = _EXC_TYPES[rest[0]]
            elif mode == "corrupt":
                # corrupt has no arg slot: times/after shift left one
                kw = {}
                rest = [None] + rest
            else:
                raise ValueError(f"unknown mode {mode!r}")
            if len(rest) > 1:
                kw["times"] = int(rest[1])
            if len(rest) > 2:
                kw["after"] = int(rest[2])
            if len(rest) > 3:
                raise ValueError(
                    f"trailing fields {rest[3:]} (syntax is "
                    "site:mode[:arg][:times[:after]])")
        except ValueError as e:
            raise MXNetError(f"{ENV_VAR}: bad rule {token!r}: {e}") from None
        out.add(site, mode, **kw)
    return out


def install_from_env() -> Optional[FaultPlan]:
    """Parse + install ``MXNET_FAULT_PLAN`` (clears when unset/empty).
    Called once at import; call again after changing the env."""
    spec = os.environ.get(ENV_VAR, "").strip()
    if not spec:
        return None
    plan_ = parse_plan(spec)
    install(plan_)
    log.warning("faultinject: %s active with %d rule(s): %s", ENV_VAR,
                len(plan_.rules()), spec)
    return plan_


install_from_env()
