"""Runtime concurrency sanitizer: lock-order graph and no-sync regions
(parity: ``mxnet_tpu/analysis/sanitizer.py``).

Under ``MXNET_SANITIZE=1`` every lock the package creates through this
module's factories is wrapped to:

  * record a **lock-order graph**: an edge A->B whenever a thread
    acquires B while holding A (aggregated by lock NAME, so two
    instances of the same subsystem count as one node: an ABBA
    inversion across instances is the same hazard);
  * detect **cycles** in that graph at edge-insert time and **raise**
    ``LockOrderError`` (``MXNET_SANITIZE_RAISE=0`` records instead);
  * detect **same-thread re-acquisition of a non-reentrant lock** (a
    signal handler re-entering a critical section), which would
    otherwise hang forever.

It also arms ``no_sync()`` regions: inside ``with analysis.no_sync():``
every device-to-host read the port performs (``nd.asnumpy``,
``nd.asscalar``, ``nd.waitall``, the ``.item()`` reads of
``gluon.Trainer`` and ``metric``) raises ``SyncViolation``.  A replayed
CUDA graph runs no Python, so a region around a replay sees only the
host reads around it.

The port donates no buffer to a dispatch (a captured step writes its
tensors in place), so ``poison_donated`` and ``poison_mapping`` keep
their names and return 0: nothing is ever consumed by a failed dispatch.

With the sanitizer off (the default) the factories return PLAIN
``threading`` primitives and every hook is one module-flag test.
Results surface in ``observability.snapshot()["analysis"]``.
"""
from __future__ import annotations

import os
import threading
import traceback
from contextlib import contextmanager
from typing import Dict, List, Optional, Tuple

from ..base import MXNetError, getenv

__all__ = ["ENABLED", "enable", "disable", "enabled", "sanitized",
           "make_lock", "make_rlock", "make_condition", "no_sync",
           "check_sync", "hot_path", "LockOrderError", "SyncViolation",
           "DonatedBufferError", "poison_donated", "poison_mapping",
           "lock_graph", "violations", "reset", "state"]

# read once at import; enable()/disable() flip it at runtime (tests).
ENABLED: bool = getenv("MXNET_SANITIZE", False)
RAISE: bool = getenv("MXNET_SANITIZE_RAISE", True)


class LockOrderError(MXNetError):
    """The sanitizer observed a lock-order cycle or a guaranteed
    same-thread deadlock (non-reentrant re-acquisition)."""


class SyncViolation(MXNetError):
    """A device→host synchronization happened inside a ``no_sync()``
    region."""


class DonatedBufferError(MXNetError):
    """A buffer consumed by a donated dispatch was accessed afterwards.
    Kept for the JAX package's surface; the port donates no buffer, so it
    never raises it."""


def enable() -> None:
    global ENABLED
    ENABLED = True


def disable() -> None:
    global ENABLED
    ENABLED = False


def enabled() -> bool:
    return ENABLED


@contextmanager
def sanitized():
    """Enable for a scope (tests): locks CREATED inside are tracked."""
    global ENABLED
    prev = ENABLED
    ENABLED = True
    try:
        yield
    finally:
        ENABLED = prev


# -- global sanitizer state ---------------------------------------------------
# the graph's own lock is a PLAIN primitive on purpose: tracking the
# tracker would recurse
_STATE_LOCK = threading.Lock()
_EDGES: Dict[Tuple[str, str], dict] = {}   # (from, to) -> {count, stack}
_VIOLATIONS: List[dict] = []
_MAX_VIOLATIONS = 256

_tls = threading.local()


def _held() -> list:
    h = getattr(_tls, "held", None)
    if h is None:
        h = _tls.held = []
    return h


def lock_graph() -> Dict[Tuple[str, str], int]:
    with _STATE_LOCK:
        return {k: v["count"] for k, v in _EDGES.items()}


def violations() -> List[dict]:
    with _STATE_LOCK:
        return list(_VIOLATIONS)


def reset() -> None:
    """Clear the graph + violation log (NOT per-thread held sets —
    those empty themselves as locks release)."""
    with _STATE_LOCK:
        _EDGES.clear()
        _VIOLATIONS.clear()


def state() -> dict:
    """The snapshot() payload: JSON-able summary of sanitizer state."""
    with _STATE_LOCK:
        cycles = sum(1 for v in _VIOLATIONS if v["kind"] == "cycle")
        reentry = sum(1 for v in _VIOLATIONS if v["kind"] == "reentry")
        sync = sum(1 for v in _VIOLATIONS if v["kind"] == "sync")
        donated = sum(1 for v in _VIOLATIONS if v["kind"] == "donated")
        return {"enabled": ENABLED, "lock_edges": len(_EDGES),
                "cycles": cycles, "reentry": reentry,
                "sync_violations": sync, "donated_poisoned": donated,
                "violations": [
                    {k: v[k] for k in ("kind", "detail")}
                    for v in _VIOLATIONS[:16]]}


def _record_violation(kind: str, detail: str, extra: Optional[dict] = None,
                      do_raise: bool = True) -> None:
    with _STATE_LOCK:
        if len(_VIOLATIONS) < _MAX_VIOLATIONS:
            entry = {"kind": kind, "detail": detail,
                     "stack": traceback.format_stack(limit=12)}
            if extra:
                entry.update(extra)
            _VIOLATIONS.append(entry)
    try:  # lazy: metrics imports this module's factories at its import
        from ..observability import metrics as _m
        if _m.ENABLED:
            if kind == "sync":
                _m.ANALYSIS_SYNC_VIOLATIONS.inc()
            else:
                _m.ANALYSIS_LOCK_VIOLATIONS.inc(kind=kind)
    except Exception:  # noqa: BLE001 — sanitizer must not crash the host
        pass
    if do_raise and RAISE:
        raise LockOrderError(f"sanitizer: {kind}: {detail}") \
            if kind != "sync" else SyncViolation(detail)


def _find_path(src: str, dst: str) -> Optional[List[str]]:
    """DFS src→dst in the name graph.  Caller holds _STATE_LOCK."""
    stack, seen = [(src, [src])], {src}
    adj: Dict[str, list] = {}
    for a, b in _EDGES:
        adj.setdefault(a, []).append(b)
    while stack:
        node, path = stack.pop()
        if node == dst:
            return path
        for nxt in adj.get(node, ()):
            if nxt not in seen:
                seen.add(nxt)
                stack.append((nxt, path + [nxt]))
    return None


def _on_acquire(lock: "_TrackedLock") -> None:
    """Pre-acquire bookkeeping: re-entry + ordering edges + cycles."""
    held = _held()
    for h, _n in held:
        if h is lock:
            if lock.reentrant:
                return  # legal recursion; no new edges
            _record_violation(
                "reentry",
                f"non-reentrant lock '{lock.name}' re-acquired by the "
                f"thread already holding it (held: "
                f"{[n for _, n in held]}) — this acquire would "
                f"deadlock forever")
            # MXNET_SANITIZE_RAISE=0 only records; the acquire below
            # then genuinely hangs (that IS the bug being recorded)
            return
    for h, hname in held:
        if hname == lock.name:
            continue  # same lock class (two instances): not an order edge
        edge = (hname, lock.name)
        with _STATE_LOCK:
            known = edge in _EDGES
            if not known:
                # cycle check BEFORE inserting: a path to→from plus
                # this edge closes a loop
                path = _find_path(lock.name, hname)
                _EDGES[edge] = {"count": 1,
                                "stack": traceback.format_stack(limit=8)}
            else:
                _EDGES[edge]["count"] += 1
                path = None
        if not known and path is not None:
            cycle = " -> ".join(path + [lock.name])
            _record_violation(
                "cycle",
                f"lock-order cycle: acquiring '{lock.name}' while "
                f"holding '{hname}', but an established order already "
                f"goes {cycle} — ABBA deadlock hazard",
                extra={"cycle": path + [lock.name]})


class _TrackedLock:
    """Wrapper around threading.Lock/RLock that feeds the lock-order
    graph.  Implements the ``_release_save``/``_acquire_restore``/
    ``_is_owned`` trio so ``threading.Condition`` composes (wait()
    fully releases, including RLock recursion)."""

    def __init__(self, name: str, reentrant: bool):
        self.name = name
        self.reentrant = reentrant
        self._inner = threading.RLock() if reentrant else threading.Lock()

    # -- core protocol -------------------------------------------------------
    def acquire(self, blocking: bool = True, timeout: float = -1):
        if ENABLED:
            _on_acquire(self)
        got = self._inner.acquire(blocking, timeout)
        if got and ENABLED:
            _held().append((self, self.name))
        return got

    def release(self):
        self._inner.release()
        held = _held()
        for i in range(len(held) - 1, -1, -1):
            if held[i][0] is self:
                del held[i]
                break

    __enter__ = acquire

    def __exit__(self, *exc):
        self.release()

    def locked(self):
        return self._inner.locked() if hasattr(self._inner, "locked") \
            else self._is_owned()

    # -- Condition compatibility --------------------------------------------
    def _release_save(self):
        held = _held()
        removed = 0
        for i in range(len(held) - 1, -1, -1):
            if held[i][0] is self:
                del held[i]
                removed += 1
        if self.reentrant:
            return (self._inner._release_save(), removed)
        self._inner.release()
        return (None, removed)

    def _acquire_restore(self, saved):
        inner_state, removed = saved
        if self.reentrant:
            self._inner._acquire_restore(inner_state)
        else:
            self._inner.acquire()
        if ENABLED:
            _held().extend([(self, self.name)] * max(1, removed))

    def _is_owned(self):
        if self.reentrant:
            return self._inner._is_owned()
        # plain-Lock heuristic (what threading.Condition itself does)
        if self._inner.acquire(False):
            self._inner.release()
            return False
        return True


def make_lock(name: str):
    """A mutex for package subsystems: plain ``threading.Lock`` when
    the sanitizer is off (zero overhead), tracked when on.  ``name``
    is the lock-order graph node (one per subsystem role)."""
    if ENABLED:
        return _TrackedLock(name, reentrant=False)
    return threading.Lock()


def make_rlock(name: str):
    if ENABLED:
        return _TrackedLock(name, reentrant=True)
    return threading.RLock()


def make_condition(name: str, reentrant: bool = True):
    """A ``threading.Condition`` whose underlying lock is tracked.
    Reentrant (RLock-backed) by default — matching what a bare
    ``threading.Condition()`` gives you — so signal handlers /
    reentrant callers may re-enter the critical section
    (Condition.wait still fully releases; threading handles the
    recursion count via _release_save).  ``reentrant=False`` opts into
    a plain-Lock condition, which the sanitizer then treats as a
    re-entry deadlock hazard."""
    if ENABLED:
        return threading.Condition(_TrackedLock(name, reentrant))
    return threading.Condition(threading.RLock() if reentrant
                               else threading.Lock())


# -- no-sync regions ----------------------------------------------------------
@contextmanager
def no_sync(label: str = "no_sync"):
    """Assert no device→host synchronization happens in this region
    (armed only under the sanitizer; a no-op otherwise, so hot loops
    may keep the region in production code)."""
    if not ENABLED:
        yield
        return
    depth = getattr(_tls, "no_sync", 0)
    prev_label = getattr(_tls, "no_sync_label", None)
    _tls.no_sync = depth + 1
    _tls.no_sync_label = label
    try:
        yield
    finally:
        _tls.no_sync = depth
        _tls.no_sync_label = prev_label  # outer region keeps ITS label


def check_sync(what: str) -> None:
    """Called by the port's device-to-host reads (``asnumpy``,
    ``asscalar``, ``waitall``, the trainer's and the metrics' ``.item()``).
    One module-flag test when the sanitizer is off."""
    if not ENABLED:
        return
    if getattr(_tls, "no_sync", 0) > 0:
        label = getattr(_tls, "no_sync_label", "no_sync")
        _record_violation(
            "sync",
            f"device->host sync '{what}' inside no_sync region "
            f"'{label}' — the hot path this region protects just "
            f"gained a blocking host read")


# -- donated-buffer poisoning ----------------------------------------------
def poison_donated(site: str, *wrappers) -> int:
    """The JAX package marks wrappers whose buffers a failed donated XLA
    dispatch may have consumed.  The port donates nothing (a captured step
    writes its tensors in place and a failed one leaves them readable), so
    there is nothing to poison: returns 0."""
    return 0


def poison_mapping(site: str, mapping: dict) -> int:
    """The serving-boundary twin of ``poison_donated``; the port's serving
    dispatch donates no input either, so this returns 0."""
    return 0


# -- hot-path marker ----------------------------------------------------------
def hot_path(fn):
    """Mark a function as a dispatch-critical hot path.  Zero runtime
    cost: an attribute that a static host-sync checker can read."""
    fn.__mxt_hot_path__ = True
    return fn
