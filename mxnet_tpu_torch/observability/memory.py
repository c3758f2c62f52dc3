"""Device-memory ledger: attribution over the CUDA caching allocator,
budget watchdog, OOM post-mortem (parity:
``mxnet_tpu/observability/memory.py``).

  * **weakref ledger** — the port's tensors are plain ``torch.Tensor``s,
    so the tensors a subsystem owns register at the places the JAX
    package tags them (``register``; ``register_nd`` keeps its name):
    parameters (``param``), gradient buffers (``grad``), optimizer states
    (``optimizer_state``), bucket residuals (``compression_residual``),
    the loss scaler, executor arrays, served weights, staged batches
    (``prefetch``/``data``), each under an explicit tag or the innermost
    ``memory_scope`` on the current thread.  Entries are weakrefs with a
    death callback, so the ledger tracks LIVE bytes with zero sweeps and
    never pins a tensor.
  * **attribution surfaces** — ``report()`` (per-tag live/peak bytes,
    top-N tensors with shape/dtype/tag, the untagged remainder called
    out explicitly, and ``torch.cuda.memory_stats``/``mem_get_info``
    beside it), ``snapshot()["memory"]`` and per-phase net-delta records
    in the flight ring (``flight.phase_span(..., mem=True)``).
  * **budget watchdog** — ``MXNET_HBM_BUDGET_MB`` arms a soft budget
    over tracked device bytes: one warning at 90%, a typed
    ``HBMBudgetError`` past 100% — fail *before* the allocator does,
    with attribution attached.  ``ensure_headroom`` asks before a large
    allocation (the superstep's K staged batches).
  * **OOM post-mortem** — ``oom_guard(site)`` wraps the dispatch
    chokepoints (executor, fused update, whole step, serving dispatch);
    a caught ``torch.cuda.OutOfMemoryError`` (or the allocator's "CUDA
    out of memory" text, or the ``memory.oom`` fault site) auto-dumps
    ledger report + flight ring to ``MXNET_FLIGHT_DIR`` (rate-limited,
    off-thread) and re-raises a typed ``DeviceMemoryError``.
  * **captured programs** — a CUDA graph has no compiled-memory report
    as an XLA program has; ``note_compiled`` files the change of the
    caching allocator's allocated and reserved bytes across a capture
    (``compiled_stats_dict(before, after)``).

Overhead contract: ``MXNET_MEMORY_LEDGER=0`` reduces every hook to ONE
module-global boolean test.

Accuracy notes: live bytes are computed from shape/dtype metadata
(never a device sync); views sharing one storage (a parameter and its
``detach()``, a gradient viewed into a bucket) are deduplicated by
``untyped_storage().data_ptr()`` in ``report()``, while the cheap per-tag
counters count each registration — the counters drive the budget check
and the phase deltas, the report is the audit.
"""
from __future__ import annotations

import collections
import contextlib
import json
import logging
import os
import threading
import time
import weakref
from typing import Dict, List, Optional

from ..base import MXNetError, getenv, atomic_write, unique_path
from ..analysis import sanitizer as _san

log = logging.getLogger(__name__)

__all__ = ["ENABLED", "enabled", "enable", "disable", "memory_scope",
           "current_tag", "register", "register_nd", "register_host",
           "tracked_bytes", "live_by_tag", "report", "snapshot_summary",
           "refresh_gauge", "nbytes_of",
           "reset", "configure", "note_compiled", "compiled_stats",
           "compiled_stats_dict", "oom_guard", "is_oom",
           "wait_oom_dump", "last_oom", "DeviceMemoryError",
           "HBMBudgetError", "UNTAGGED", "budget_bytes",
           "headroom_bytes", "set_budget_arbiter", "ensure_headroom"]

# -- the fast-path switch ----------------------------------------------------
# Hooks across ndarray/gluon/serving/checkpoint read this module global
# directly: `if memory.ENABLED: memory.register_nd(self)`.
ENABLED: bool = getenv("MXNET_MEMORY_LEDGER", True)
#: soft HBM budget in MB over TRACKED device bytes (0 = watchdog off):
#: one warning when tracked bytes cross 90% of it, a typed
#: HBMBudgetError past 100% — before the hardware raises
BUDGET_MB: float = float(getenv("MXNET_HBM_BUDGET_MB", 0.0))
#: minimum seconds between OOM post-mortem dumps (tests set 0)
OOM_DUMP_MIN_S: float = 30.0

#: the tag live/peak counters file untagged registrations under — kept
#: out of user tag space (scopes reject it)
UNTAGGED = "_untagged"


class DeviceMemoryError(MXNetError):
    """Typed re-raise of a device out-of-memory error caught at a
    dispatch chokepoint — by the time this propagates, the post-mortem
    (ledger report + flight ring) is being written to
    ``MXNET_FLIGHT_DIR``."""


class HBMBudgetError(MXNetError):
    """Tracked device bytes exceeded ``MXNET_HBM_BUDGET_MB`` — the
    soft-budget watchdog failing BEFORE the hardware does.  The message
    carries the per-tag attribution at the moment of the crossing."""


def enabled() -> bool:
    return ENABLED


def enable() -> None:
    global ENABLED
    ENABLED = True


def disable() -> None:
    global ENABLED
    ENABLED = False


# -- tag scopes ---------------------------------------------------------------
_tls = threading.local()


def current_tag() -> Optional[str]:
    """Innermost ``memory_scope`` tag on this thread (None outside)."""
    stack = getattr(_tls, "tags", None)
    return stack[-1] if stack else None


@contextlib.contextmanager
def memory_scope(tag: str):
    """Attribute every buffer registered on this thread inside the
    block to ``tag`` (nestable — the innermost scope wins).  Tags must
    come from a bounded literal set: each distinct tag is a forever
    entry in the per-tag counters and a label value on the
    ``mxnet_memory_ledger_bytes`` gauge."""
    if not ENABLED:
        # MXNET_MEMORY_LEDGER=0 contract: hot-path callers wrap every
        # batch/step in a scope — skip tag validation and the TLS
        # stack entirely, nothing downstream will read the tag anyway
        yield
        return
    if not isinstance(tag, str) or not tag or tag.startswith("_"):
        raise MXNetError(f"memory_scope tag must be a non-empty str not "
                         f"starting with '_', got {tag!r}")
    stack = getattr(_tls, "tags", None)
    if stack is None:
        stack = _tls.tags = []
    stack.append(tag)
    try:
        yield
    finally:
        stack.pop()


# -- the ledger ---------------------------------------------------------------
# entry: token -> (ref, tag, nbytes, space)
# space: "device" (the port's tensors) or "host" (checkpoint and
# supervisor snapshot twins).  The death callback queues a record; the next
# ledger operation drains the queue under the lock — no sweep ever
# runs and no counter update happens in gc context (see _dead below).
# RLock on purpose: a weakref death callback can fire from the garbage
# collector at ANY allocation point — including inside a ledger
# critical section on the same thread (a dead reference cycle holding
# a registered NDArray); the append-only callback needs no lock, but
# keeping the ledger lock reentrant means even a future callback that
# does take it cannot self-deadlock.
_lock = _san.make_rlock("memory.ledger")
_entries: Dict[int, tuple] = {}
_by_id: Dict[int, int] = {}         # id(live tracked obj) -> token
_next_token = 0
_live: Dict[tuple, float] = {}      # (space, tag) -> live bytes
_peak: Dict[tuple, float] = {}      # (space, tag) -> peak live bytes
_counts: Dict[tuple, int] = {}      # (space, tag) -> live buffer count
_device_total = 0.0                 # running sum over device-space tags
_budget_warned = False


def nbytes_of(obj) -> int:
    """Byte size from metadata only — never a device sync: itemsize x
    prod(shape) (a tensor's ``dtype.itemsize``, a numpy array's)."""
    try:
        n = obj.dtype.itemsize
        for d in obj.shape:
            n *= d
        return n
    except (AttributeError, TypeError):
        pass
    n = getattr(obj, "nbytes", None)
    if n is not None:
        try:
            return int(n)
        except (TypeError, ValueError):
            pass
    return 0


# Death callbacks only APPEND here (deque appends are GIL-atomic, no
# lock, no read-modify-write): a callback fires from the garbage
# collector at ANY allocation point — including in the middle of a
# counter update on the same thread, where a direct decrement would be
# overwritten by the interrupted frame's stale value (lost-decrement
# drift).  The queue is drained inside the lock by the next ledger
# operation; a nested callback during a drain just appends again.
_dead = collections.deque()


def _on_death(token: int, space_tag: tuple, nbytes: int) -> None:
    _dead.append((token, space_tag, nbytes))


def _drain_dead_locked() -> None:
    """Apply queued death records to the counters.  Caller holds
    ``_lock``; entries dropped by ``reset()`` are skipped (a buffer
    registered before a reset dying after it must not corrupt the
    fresh counters)."""
    global _device_total
    while _dead:
        try:
            token, st, nb = _dead.popleft()
        except IndexError:
            break
        e = _entries.pop(token, None)
        if e is None:
            continue
        if _by_id.get(e[4]) == token:
            del _by_id[e[4]]
        _live[st] = max(0.0, _live.get(st, 0.0) - nb)
        _counts[st] = max(0, _counts.get(st, 0) - 1)
        if st[0] == "device":
            _device_total = max(0.0, _device_total - nb)


def register(obj, tag: Optional[str] = None, space: str = "device",
             nbytes: Optional[int] = None):
    """Track ``obj`` (any weakref-able array-ish: torch.Tensor, numpy)
    under ``tag`` (default: the current ``memory_scope``; no
    scope → the untagged remainder).  Returns ``obj`` so call sites can
    wrap in-line.  One boolean test when the ledger is off.

    Hot-path discipline: the entry stores only (ref, tag, bytes, space) —
    shape/dtype are read from the live object at ``report()`` time."""
    global _next_token, _device_total, _budget_warned
    if not ENABLED:
        return obj
    if tag is None:
        tag = current_tag() or UNTAGGED
    nb = nbytes_of(obj) if nbytes is None else nbytes
    st = (space, tag)
    budget_exceeded = None
    oid = id(obj)
    with _lock:
        if _dead:
            _drain_dead_locked()
        prev_tok = _by_id.get(oid)
        if prev_tok is not None:
            prev = _entries.get(prev_tok)
            if prev is not None and prev[0]() is obj and \
                    prev[1] == tag and prev[2] == nb and prev[3] == space:
                # already tracked as it is (a parameter's gradient seen
                # again at the next step): nothing to move
                return obj
            if prev is not None and prev[0]() is obj:
                # re-registration of a still-live object (a
                # parameter retagged after a load): MOVE the bytes to the new (space, tag)
                # instead of double counting.  Drop the old entry so
                # the old weakref's death callback becomes a no-op —
                # the fresh entry below carries the new accounting.
                _, p_tag, p_nb, p_space, _o = prev
                del _entries[prev_tok]
                p_st = (p_space, p_tag)
                _live[p_st] = max(0.0, _live.get(p_st, 0.0) - p_nb)
                _counts[p_st] = max(0, _counts.get(p_st, 0) - 1)
                if p_space == "device":
                    _device_total = max(0.0, _device_total - p_nb)
            # else: a dead buffer's id was reused — fall through and
            # let the fresh entry below take over the mapping
        token = _next_token = _next_token + 1
        try:
            ref = weakref.ref(obj, lambda _r, t=token, s=st, n=nb:
                              _on_death(t, s, n))
        except TypeError:
            return obj  # not weakref-able: out of ledger scope
        _entries[token] = (ref, tag, nb, space, oid)
        _by_id[oid] = token
        live = _live[st] = _live.get(st, 0.0) + nb
        _counts[st] = _counts.get(st, 0) + 1
        if live > _peak.get(st, 0.0):
            _peak[st] = live
        if space == "device":
            _device_total += nb
            budget = BUDGET_MB * 1048576.0
            if budget > 0.0:
                if _device_total > budget:
                    budget_exceeded = _device_total
                    # snapshot while still under the lock: the raise
                    # below must never trip over a concurrent register
                    live_items = list(_live.items())
                elif _device_total > 0.9 * budget and not _budget_warned:
                    _budget_warned = True
                    log.warning(
                        "HBM budget watchdog: tracked device bytes %.1f MB "
                        "crossed 90%% of MXNET_HBM_BUDGET_MB=%.0f",
                        _device_total / 1048576, BUDGET_MB)
                elif _device_total < 0.8 * budget:
                    _budget_warned = False
    if budget_exceeded is not None:
        # the entry stays registered (accounting is consistent; the
        # buffer exists whether or not the caller survives this raise)
        attribution = {t: round(v / 1048576, 2)
                       for (sp, t), v in sorted(live_items)
                       if sp == "device" and v}
        raise HBMBudgetError(
            f"tracked device bytes {budget_exceeded / 1048576:.1f} MB "
            f"exceed MXNET_HBM_BUDGET_MB={BUDGET_MB:.0f} — attribution "
            f"(MB): {attribution}")
    return obj


def register_nd(nd_arr) -> None:
    """The JAX package's NDArray-creation hook; the port's arrays are
    tensors, so this is ``register`` under the current scope."""
    register(nd_arr)


def register_host(obj, tag: Optional[str] = None):
    """Track a host-side buffer (numpy, a pinned tensor) — the ledger
    twin for host-RAM hogs like checkpoint and supervisor snapshots."""
    return register(obj, tag=tag, space="host")


# -- queries ------------------------------------------------------------------
def tracked_bytes(space: str = "device") -> float:
    """Cheap total of tracked live bytes (O(1) read of the running
    device sum; O(#tags) for host) — the phase-delta sampling hook."""
    if _dead:
        with _lock:
            _drain_dead_locked()
    if space == "device":
        return _device_total
    with _lock:
        return sum(v for (sp, _t), v in _live.items() if sp == space)


def live_by_tag(space: str = "device") -> Dict[str, float]:
    with _lock:
        _drain_dead_locked()
        return {t: v for (sp, t), v in sorted(_live.items())
                if sp == space and v > 0}


def _storage_key(handle):
    """What two views of one allocation share: the device and the
    storage's address for a tensor (0-byte storages and meta tensors
    fall back to identity), the object's id otherwise."""
    try:
        ptr = handle.untyped_storage().data_ptr()
        if ptr:
            return (str(handle.device), ptr)
    except Exception:  # noqa: BLE001 — numpy and the rest
        pass
    return ("id", id(handle))


def report(top: int = 10) -> dict:
    """The audit view: per-tag live/peak/count (device and host
    sections), the ``top`` largest live buffers with shape/dtype/tag,
    the untagged remainder called out explicitly, per-program compiled
    stats (captured graphs' pool growth), and the CUDA allocator's own
    numbers (``hbm``).  Live bytes here are DEDUPLICATED by storage —
    views of one allocation count once."""
    with _lock:
        _drain_dead_locked()
        entries = list(_entries.values())
        peaks = dict(_peak)
        compiled = {k: dict(v) for k, v in _compiled.items()}
    # dedupe by buffer id; deref outside the lock (callbacks may fire)
    buffers: List[dict] = []
    seen: Dict[tuple, int] = {}
    agg: Dict[tuple, dict] = {}
    for ref, tag, nb, space, _oid in entries:
        obj = ref()
        if obj is None:
            continue
        handle = obj
        hid = _storage_key(handle)
        if hid in seen:
            continue
        seen[hid] = 1
        nb_now = nbytes_of(handle) or nb
        st = (space, tag)
        a = agg.setdefault(st, {"live_bytes": 0, "buffers": 0})
        a["live_bytes"] += nb_now
        a["buffers"] += 1
        buffers.append({"tag": tag, "space": space, "bytes": nb_now,
                        "shape": tuple(getattr(handle, "shape", ()) or ()),
                        "dtype": str(getattr(handle, "dtype", "?"))})
    buffers.sort(key=lambda b: -b["bytes"])

    def _section(space: str) -> dict:
        tags = {t: {"live_bytes": int(v["live_bytes"]),
                    "buffers": v["buffers"],
                    "peak_bytes": int(peaks.get((space, t), 0.0))}
                for (sp, t), v in sorted(agg.items()) if sp == space}
        untagged = tags.pop(UNTAGGED, {"live_bytes": 0, "buffers": 0,
                                       "peak_bytes": 0})
        tagged = sum(v["live_bytes"] for v in tags.values())
        total = tagged + untagged["live_bytes"]
        return {"tags": tags, "tagged_bytes": int(tagged),
                "untagged": untagged,
                "untagged_bytes": int(untagged["live_bytes"]),
                "total_bytes": int(total),
                "attribution_pct": round(100.0 * tagged / total, 2)
                if total else 100.0}

    from .metrics import hbm_stats
    return {"enabled": ENABLED,
            "device": _section("device"),
            "host": _section("host"),
            "top": buffers[:max(0, top)],
            "compiled": compiled,
            "budget_mb": BUDGET_MB,
            "mesh": "replicated",
            "hbm": hbm_stats()}


def _live_split() -> tuple:
    """Drain dead buffers under the lock, then split live bytes into
    per-space ``{tag: bytes}`` dicts (zero-byte tags dropped) — the one
    place the gauge/snapshot filtering rule lives, so the snapshot()-fed
    and render-fed gauge refreshes can't drift apart."""
    with _lock:
        _drain_dead_locked()
        live = dict(_live)
        peaks = dict(_peak)
    dev = {t: int(v) for (sp, t), v in sorted(live.items())
           if sp == "device" and v > 0}
    host = {t: int(v) for (sp, t), v in sorted(live.items())
            if sp == "host" and v > 0}
    return dev, host, peaks


def snapshot_summary() -> dict:
    """The compact block ``observability.snapshot()["memory"]`` carries
    (and the export-time feed of the ``mxnet_memory_ledger_bytes``
    gauge — bounded tag labels, untagged included as ``_untagged``)."""
    dev, host, peaks = _live_split()
    tagged = sum(v for t, v in dev.items() if t != UNTAGGED)
    untagged = dev.get(UNTAGGED, 0)
    total = tagged + untagged
    out = {"enabled": ENABLED,
           "tracked_bytes": int(total),
           "tags": dev,
           "host_tags": host,
           "untagged_bytes": int(untagged),
           "attribution_pct": round(100.0 * tagged / total, 2)
           if total else 100.0,
           "peak_by_tag": {t: int(v) for (sp, t), v in sorted(peaks.items())
                           if sp == "device" and v > 0},
           "budget_mb": BUDGET_MB,
           "oom": dict(_last_oom)}
    _refresh_gauge_from(dev, host)
    return out


def _refresh_gauge_from(dev: Dict[str, int], host: Dict[str, int]) -> None:
    try:
        from . import metrics as _metrics
        if _metrics.ENABLED:
            # export-time gauge refresh (the on-demand-expensive rule):
            # one atomic child-set swap, so dead tags don't linger AND
            # a concurrent scrape never renders a half-rebuilt gauge
            _metrics.MEMORY_LEDGER_BYTES.replace_children(
                [({"tag": t, "space": "device"}, v)
                 for t, v in dev.items()] +
                [({"tag": t, "space": "host"}, v)
                 for t, v in host.items()])
    except Exception:  # noqa: BLE001 — export must never fail on gauges
        pass


def refresh_gauge() -> None:
    """Push current per-tag live bytes onto ``mxnet_memory_ledger_bytes``.
    Called at every export chokepoint — ``snapshot()`` and the
    Prometheus/JSON render paths — so a scrape that never goes through
    ``snapshot()`` still sees fresh values; never on the hot path."""
    dev, host, _ = _live_split()
    _refresh_gauge_from(dev, host)


# -- budget arbitration -------------------------------------------------------
# The soft budget above only WATCHES (warn at 90%, raise past 100%);
# arbitration is the layer that NEGOTIATES: before a large allocation,
# a subsystem asks ensure_headroom() whether the bytes fit, and a
# registered arbiter (an LRU evictor) gets the chance to free colder
# memory first.
_arbiter = None  # (deficit_bytes: float, why: str) -> freed estimate


def budget_bytes() -> float:
    """The armed soft budget in bytes (0.0 = budget off)."""
    return BUDGET_MB * 1048576.0


def headroom_bytes(budget: Optional[float] = None) -> float:
    """Budget minus tracked live device bytes (+inf when no budget is
    armed and no override is given).  ``budget`` overrides the env-armed
    ``MXNET_HBM_BUDGET_MB`` in bytes — a registry running its own budget
    passes it here so one arbitration code path serves both."""
    b = budget_bytes() if budget is None else float(budget)
    if b <= 0.0:
        return float("inf")
    return b - tracked_bytes()


def set_budget_arbiter(fn):
    """Install ``fn(deficit_bytes, why) -> freed_bytes_estimate`` as the
    process arbiter (None uninstalls).  Returns the previous arbiter.
    The arbiter is called OUTSIDE the ledger lock and must be safe to
    invoke from any thread that allocates."""
    global _arbiter
    prev, _arbiter = _arbiter, fn
    return prev


def ensure_headroom(nbytes: float, why: str = "",
                    budget: Optional[float] = None) -> bool:
    """The budget arbitration chokepoint: would ``nbytes`` more tracked
    device bytes still fit?  On a shortfall the registered arbiter is
    asked to free the deficit (LRU eviction), then the answer is
    re-evaluated.  True when the allocation fits (always, with no budget
    armed); False means the caller should degrade (typed
    ``ModelUnavailable`` / defer) instead of allocating into a certain
    ``HBMBudgetError``."""
    h = headroom_bytes(budget)
    if h >= nbytes:
        return True
    fn = _arbiter
    if fn is not None:
        try:
            fn(float(nbytes) - h, why)
        except Exception as e:  # noqa: BLE001 — arbiter is best-effort
            log.warning("budget arbiter failed (%s): %s", why, str(e))
        return headroom_bytes(budget) >= nbytes
    return False


# -- compiled-program stats (CompiledMemoryStats registry) --------------------
_compiled: Dict[str, dict] = {}


def compiled_stats_dict(before, after=None) -> dict:
    """The memory a captured CUDA graph keeps, from
    ``torch.cuda.memory_stats`` read ``before`` and ``after`` the capture:
    the growth of the allocated bytes (its static outputs and the
    tensors it holds) and the change of the allocator's reserved bytes
    (the graph's private pool, less whatever cached memory the allocator
    released to make room for it: it can be negative).  ``peak_bytes`` is
    the larger of the two, at least 0.  Always the same keys; ``{}`` when
    either read is missing (the CPU) — callers treat falsy as
    unavailable."""
    if not before or not after:
        return {}

    def d(key):
        return int(after.get(key, 0)) - int(before.get(key, 0))
    reserved = d("reserved_bytes.all.current")
    alloc = d("allocated_bytes.all.current")
    return {"allocated_bytes": alloc, "reserved_delta_bytes": reserved,
            "peak_bytes": max(reserved, alloc, 0), "peak_estimated": False}


def note_compiled(name: str, stats: dict) -> None:
    """File one captured graph's memory under ``name`` (bounded names:
    ``whole-step``, ``superstep``, ``module-step``).  Shows up in
    ``report()["compiled"]``."""
    if not ENABLED or not stats:
        return
    with _lock:
        _compiled[name] = dict(stats)


def compiled_stats() -> Dict[str, dict]:
    with _lock:
        return {k: dict(v) for k, v in _compiled.items()}


# -- OOM post-mortem ----------------------------------------------------------
_last_oom: dict = {}
# None, not 0.0: time.monotonic() can be < OOM_DUMP_MIN_S early after
# boot, and the FIRST post-mortem must never look rate-limited
_last_oom_dump: Optional[float] = None
# starts SET: "no dump in flight" — wait_oom_dump() on a process that
# never OOM'd must return immediately, not stall out its timeout
_oom_dump_done = threading.Event()
_oom_dump_done.set()
_oom_dumps = 0


def is_oom(exc: BaseException) -> bool:
    """Does ``exc`` look like device memory exhaustion?  Matches
    ``torch.cuda.OutOfMemoryError``, the caching allocator's "CUDA out of
    memory" text (older PyTorch raises it as a RuntimeError), the JAX
    package's RESOURCE_EXHAUSTED, and the synthetic ``memory.oom``
    faultinject site (its message names the site), never generic
    errors."""
    if type(exc).__name__ == "OutOfMemoryError":
        return True
    s = f"{type(exc).__name__}: {exc}"
    return ("CUDA out of memory" in s or "RESOURCE_EXHAUSTED" in s
            or "memory.oom" in s)


@contextlib.contextmanager
def oom_guard(site: str):
    """Wrap a dispatch chokepoint: a caught out-of-memory error triggers
    the rate-limited off-thread post-mortem (ledger report + flight
    ring to ``MXNET_FLIGHT_DIR``, atomic writes) and re-raises typed.
    One boolean test when the ledger is off."""
    if not ENABLED:
        yield
        return
    try:
        yield
    except DeviceMemoryError:
        raise  # an inner guard already handled it — never dump twice
    except Exception as e:  # noqa: BLE001 — filtered to OOM below
        if not is_oom(e):
            raise
        _post_mortem(site, e)
        raise DeviceMemoryError(
            f"device memory exhausted at {site} — post-mortem (ledger "
            f"report + flight ring) dumping to "
            f"{os.environ.get('MXNET_FLIGHT_DIR', '.') or '.'}; "
            f"original: {type(e).__name__}: {e}") from e


def _post_mortem(site: str, exc: BaseException) -> None:
    global _last_oom_dump
    now = time.monotonic()
    with _lock:
        rate_limited = _last_oom_dump is not None and \
            now - _last_oom_dump < OOM_DUMP_MIN_S
        if not rate_limited:
            _last_oom_dump = now
    rec = {"site": site, "error": f"{type(exc).__name__}: {exc}",
           "rate_limited": rate_limited}
    if rate_limited:
        # no new dump this window — keep pointing consumers
        # (wait_oom_dump, snapshot()["memory"]["oom"], readyz) at the
        # on-disk post-mortem that opened the rate window
        for k in ("report_path", "flight_path"):
            if k in _last_oom:
                rec[k] = _last_oom[k]
    _last_oom.clear()
    _last_oom.update(rec)
    if rate_limited:
        return
    _oom_dump_done.clear()
    # off-thread per the flight handler rules: the failing thread may
    # hold subsystem locks the dump path would need; the ledger/ring
    # already hold the moments before the OOM regardless of scheduling.
    # The dump thread gets its OWN copy of the record — a second OOM
    # rewriting _last_oom mid-dump must not change what gets written
    # (or which record the report_path lands on)
    threading.Thread(target=_bg_oom_dump, args=(site, rec),
                     name="mxt-oom-dump", daemon=True).start()


def _bg_oom_dump(site: str, rec: dict) -> None:
    global _oom_dumps
    try:
        from . import journal as _journal
        if _journal.ENABLED:
            # cross-reference the run journal in the OOM report (and
            # vice versa below) — pivot from badput row to timeline
            rec["run_id"] = _journal.run_id()
            rec["journal_path"] = _journal.path()
        d = os.environ.get("MXNET_FLIGHT_DIR", ".") or "."
        os.makedirs(d, exist_ok=True)
        path = unique_path(d, "oom", ".json")
        atomic_write(path, json.dumps(
            {"oom": dict(rec), "report": report(top=20)},
            default=str))
        rec["report_path"] = path
        from . import flight as _flight
        if _flight.ENABLED:
            rec["flight_path"] = _flight.dump(reason="oom")
        # publish onto last_oom() only if a newer OOM hasn't replaced
        # the record this dump belongs to
        if _last_oom.get("site") == rec["site"] and \
                _last_oom.get("error") == rec["error"]:
            _last_oom.update(rec)
        else:
            # a newer (rate-limited) OOM replaced the record while this
            # dump was in flight — it belongs to the same rate window,
            # so consumers still get pointed at the on-disk post-mortem
            for k in ("report_path", "flight_path"):
                if k in rec:
                    _last_oom.setdefault(k, rec[k])
        _oom_dumps += 1
        log.error("device OOM post-mortem at %s: %s", site, path)
        if _journal.ENABLED:
            _journal.emit("oom", durable=True, site=site,
                          report_path=rec.get("report_path"),
                          flight_path=rec.get("flight_path"))
    except Exception as e:  # noqa: BLE001 — a failed dump must not mask
        log.warning("OOM post-mortem dump failed: %s", e)
    finally:
        _oom_dump_done.set()


def wait_oom_dump(timeout: float = 10.0) -> Optional[str]:
    """Test/ops hook: block until the in-flight OOM dump (if any)
    finishes; returns the report path (None when nothing dumped)."""
    _oom_dump_done.wait(timeout)
    return _last_oom.get("report_path")


def last_oom() -> dict:
    return dict(_last_oom)


def oom_dumps() -> int:
    return _oom_dumps


# -- lifecycle ----------------------------------------------------------------
def reset() -> None:
    """Drop every entry/counter and the OOM/budget state (tests).
    Weakref callbacks from still-live buffers registered before the
    reset become no-ops (their tokens are gone)."""
    global _device_total, _budget_warned, _last_oom_dump, _oom_dumps
    global _arbiter
    _arbiter = None  # a dead registry's evictor must not outlive it
    with _lock:
        _dead.clear()
        _entries.clear()
        _by_id.clear()
        _live.clear()
        _peak.clear()
        _counts.clear()
        _compiled.clear()
        _device_total = 0.0
        _budget_warned = False
    _last_oom.clear()
    _last_oom_dump = None
    _oom_dumps = 0
    _oom_dump_done.set()


def configure(budget_mb: Optional[float] = None,
              oom_dump_min_s: Optional[float] = None) -> None:
    """Re-read knobs (tests / long-lived jobs that flip the env)."""
    global BUDGET_MB, OOM_DUMP_MIN_S, _budget_warned
    if budget_mb is not None:
        BUDGET_MB = float(budget_mb)
    else:
        BUDGET_MB = float(getenv("MXNET_HBM_BUDGET_MB", 0.0))
    if oom_dump_min_s is not None:
        OOM_DUMP_MIN_S = float(oom_dump_min_s)
    _budget_warned = False
