"""CheckpointManager: non-blocking snapshots, retention, auto-resume.

The port's copy of ``mxnet_tpu/checkpoint/manager.py``, with the same
behaviour and the same state keys:

  * **async snapshots** — ``save(step, state)`` copies every tensor to
    host eagerly (training may overwrite its buffers immediately) and
    hands serialization + IO to one background writer thread, so the step
    critical path pays only the copy.  ``wait()`` is the barrier;
    ``MXNET_CHECKPOINT_ASYNC=0`` (or ``async_save=False``) keeps
    everything on the caller thread.
  * **atomic, validated layout** — see ``layout.py``: tmp + rename
    commit, per-entry CRC32, size-checked shards.  Restore walks steps
    newest-first and a torn/corrupt checkpoint is skipped (and logged),
    never loaded.
  * **retention + discovery** — ``max_to_keep`` GC with ``keep_period``
    pinning; ``latest_step()`` / ``all_steps()`` ignore invalid dirs.

Transient IO errors retry with exponential backoff
(``MXNET_CHECKPOINT_RETRIES``, default 3 retries); tests inject faults
through ``fault_hook``.  A failed write is never silent: it raises from
``save`` in sync mode, else from the next ``save``, ``wait`` or
``close``.

The JAX package's calls into ``analysis.sanitizer`` (its locks are plain
``threading`` ones here), ``faultinject`` and ``observability``
``flight``/``journal``/``memory``/``metrics`` wait for ROADMAP.md item 5;
the mesh signature is the one-device one (``"replicated"``) until item 6.
A trainer's checkpoint is stamped with the AMP policy its last step ran
under (the updater's ``dtype_policy``: the whole step's, or "f32" after a
fused step), and a restore under another configured policy warns.
"""
from __future__ import annotations

import atexit
import itertools
import logging
import os
import shutil
import threading
import time
from typing import Callable, Dict, List, Optional, Tuple

from ..base import MXNetError, getenv
from ..faultinject import fire as _fi_fire
from ..observability import flight as _flight
from ..observability import journal as _journal
from ..observability import memory as _memory
from ..observability import metrics as _metrics
from . import layout as _layout
from .layout import CheckpointInvalidError

log = logging.getLogger(__name__)

# the mesh signature a one-device port writes and accepts
_MESH_SIGNATURE = "replicated"


def _configured_amp() -> str:
    """The policy this process would train under: ``MXNET_AMP`` applies
    only inside the whole step."""
    if not getenv("MXNET_WHOLE_STEP", False):
        return "f32"
    from ..gluon.wholestep import amp_policy
    try:
        return amp_policy()
    except MXNetError:
        return "f32"


def _corrupt_step_dir(path: str) -> None:
    """The ``checkpoint.io`` corrupt rule's damage: flip one byte in the
    middle of the first shard of a COMMITTED checkpoint (sizes unchanged,
    quick validation passes; the CRC-validated load must reject it)."""
    try:
        names = sorted(n for n in os.listdir(path) if n.endswith(".npz"))
    except OSError:
        return
    if not names:
        return
    fp = os.path.join(path, names[0])
    size = os.path.getsize(fp)
    with open(fp, "r+b") as f:
        f.seek(size // 2)
        b = f.read(1)
        f.seek(size // 2)
        f.write(bytes([b[0] ^ 0xFF]))


class CheckpointError(MXNetError):
    """A checkpoint write failed after exhausting retries."""


class CheckpointManager:
    """Manage a directory of atomic, validated ``step_N`` checkpoints.

    Parameters
    ----------
    directory : str
        Checkpoint root; created on first save.
    max_to_keep : int, optional
        GC all but the newest N valid checkpoints (None keeps all).
    keep_period : int, optional
        Steps divisible by this are pinned — never GC'd — regardless
        of ``max_to_keep``.
    async_save : bool, optional
        Default ``MXNET_CHECKPOINT_ASYNC`` (on).  Off = every save
        completes before ``save()`` returns.
    retries : int, optional
        Transient-IO retries per save, default
        ``MXNET_CHECKPOINT_RETRIES`` (3).
    backoff_s : float, optional
        First retry delay, doubling each attempt; default
        ``MXNET_CHECKPOINT_RETRY_BACKOFF_S`` (0.05).
    fault_hook : callable, optional
        ``fault_hook(step, attempt)`` runs at the top of every write
        attempt — tests raise from it to exercise the retry path.
    max_pending : int, optional
        Backpressure bound on queued async saves (default
        ``MXNET_CHECKPOINT_MAX_PENDING``, 2): each queued save pins a full
        host copy of the state, so ``save()`` blocks until a slot frees.
    """

    def __init__(self, directory: str, max_to_keep: Optional[int] = None,
                 keep_period: Optional[int] = None,
                 async_save: Optional[bool] = None,
                 retries: Optional[int] = None,
                 backoff_s: Optional[float] = None,
                 fault_hook: Optional[Callable[[int, int], None]] = None,
                 max_pending: Optional[int] = None):
        self.directory = str(directory)
        self.max_to_keep = None if max_to_keep is None else int(max_to_keep)
        self.keep_period = None if keep_period is None else int(keep_period)
        if self.max_to_keep is not None and self.max_to_keep < 1:
            raise MXNetError("max_to_keep must be >= 1 (or None)")
        if self.keep_period is not None and self.keep_period < 1:
            raise MXNetError("keep_period must be >= 1 (or None)")
        self._async = bool(getenv("MXNET_CHECKPOINT_ASYNC", True)) \
            if async_save is None else bool(async_save)
        self.retries = int(getenv("MXNET_CHECKPOINT_RETRIES", 3)) \
            if retries is None else int(retries)
        self.backoff_s = float(getenv("MXNET_CHECKPOINT_RETRY_BACKOFF_S",
                                      0.05)) if backoff_s is None \
            else float(backoff_s)
        self.fault_hook = fault_hook
        self.max_pending = int(getenv("MXNET_CHECKPOINT_MAX_PENDING", 2)) \
            if max_pending is None else int(max_pending)
        if self.max_pending < 1:
            raise MXNetError("max_pending must be >= 1")
        # lock-free token source: the writer takes it while holding
        # _write_lock, and must never wait on _lock there
        self._seq = itertools.count(1)
        self._last_saved_step: Optional[int] = None
        # serializes writes (a block=True save may run on the caller
        # thread beside the worker); reentrant, because a SIGTERM handler
        # on the main thread may interrupt a save there
        self._write_lock = threading.RLock()
        # queue/accounting condition, reentrant for the same reason
        self._lock = threading.Condition(threading.RLock())
        self._queue: List[tuple] = []
        self._pending = 0
        self._errors: List[BaseException] = []
        self._worker: Optional[threading.Thread] = None
        self._closed = False

    # -- save ----------------------------------------------------------------
    def save(self, step: int, state: Dict, meta: Optional[dict] = None,
             signatures: Optional[dict] = None, block: bool = False) -> None:
        """Snapshot ``state`` (device→host, eager) and persist it as
        checkpoint ``step``.  Returns as soon as the snapshot is taken
        unless sync mode / ``block=True``.  A previously failed async
        save raises here (and from ``wait()``) — failures are never
        silent."""
        if self._closed:
            raise CheckpointError("CheckpointManager is closed")
        self._raise_pending_error()
        step = int(step)
        t0 = time.perf_counter()
        # the caller-visible blocking phase: snapshot + (async) queue
        # admission, or the whole write in sync mode
        with _flight.phase_span("checkpoint_block", cat="checkpoint",
                                step=step, mem=True):
            snap = _layout.snapshot_state(state)
            if _memory.ENABLED:
                # each queued save pins a host snapshot until committed
                for _name, (kind, payload) in snap.items():
                    if kind == "array":
                        _memory.register_host(payload, tag="checkpoint_host")
            job = (step, snap, dict(meta or {}), dict(signatures or {}), t0)
            if self._async and not block:
                with self._lock:
                    self._ensure_worker()
                    # backpressure: each queued job pins a full host
                    # snapshot
                    while self._pending >= self.max_pending:
                        self._lock.wait()
                    self._queue.append(job)
                    self._pending += 1
                    self._lock.notify_all()
            else:
                self._run_job(job)
                self._raise_pending_error()
        if _metrics.ENABLED:
            _metrics.CHECKPOINT_SAVE_BLOCKED_SECONDS.observe(
                time.perf_counter() - t0)

    def _ensure_worker(self) -> None:
        if self._worker is not None and self._worker.is_alive():
            return
        self._worker = threading.Thread(
            target=self._worker_loop, name="mxt-checkpoint-writer",
            daemon=True)
        self._worker.start()

    def _worker_loop(self) -> None:
        while True:
            with self._lock:
                while not self._queue and not self._closed:
                    self._lock.wait()
                if not self._queue and self._closed:
                    return
                job = self._queue.pop(0)
            try:
                self._run_job(job)
            finally:
                with self._lock:
                    self._pending -= 1
                    self._lock.notify_all()

    def _run_job(self, job: tuple) -> None:
        """Any exception — retried IO or a serialization bug — raises
        (sync) or lands in _errors for wait()/the next save() (async)."""
        step = job[0]
        try:
            with self._write_lock, \
                    _flight.phase_span("checkpoint_write", cat="checkpoint",
                                       step=step):
                self._run_attempts(*job)
        except Exception as e:  # noqa: BLE001 — see docstring
            err = e if isinstance(e, CheckpointError) else CheckpointError(
                f"checkpoint step {step} failed: {e}")
            if self._async:
                log.error("%s", err)
                with self._lock:
                    self._errors.append(err)
                return
            raise err from e

    def _run_attempts(self, step, snap, meta, signatures, t0) -> None:
        attempts = self.retries + 1
        delay = self.backoff_s
        for attempt in range(attempts):
            try:
                if self.fault_hook is not None:
                    self.fault_hook(step, attempt)
                # the process-wide fault site: OSError exercises the retry
                # path, the default InjectedFault exhausts it
                _fi_fire("checkpoint.io", step=step, attempt=attempt)
                written = _layout.write_checkpoint_dir(
                    self.directory, step, snap, meta=meta,
                    signatures=signatures,
                    tmp_token=f"{os.getpid()}-{next(self._seq)}")
                # corrupt rules act AFTER the commit: the next restore
                # must skip this checkpoint by its CRC
                _fi_fire("checkpoint.io", only="corrupt",
                         corrupt=lambda: _corrupt_step_dir(os.path.join(
                             self.directory, _layout.step_dirname(step))))
                break
            except (OSError, IOError) as e:
                if _metrics.ENABLED:
                    _metrics.CHECKPOINT_FAILURES.inc(
                        stage="save_attempt", reason=type(e).__name__)
                if attempt == attempts - 1:
                    raise CheckpointError(
                        f"checkpoint step {step} failed after "
                        f"{attempts} attempts: {e}") from e
                log.warning("checkpoint step %d attempt %d/%d failed "
                            "(%s); retrying in %.3fs", step, attempt + 1,
                            attempts, e, delay)
                time.sleep(delay)
                delay *= 2
        self._last_saved_step = step
        if _metrics.ENABLED:
            _metrics.CHECKPOINT_SAVE_SECONDS.observe(
                time.perf_counter() - t0)
            _metrics.CHECKPOINT_BYTES_WRITTEN.inc(written)
            _metrics.CHECKPOINT_LAST_STEP.set(step)
        if _journal.ENABLED:
            # durable: after a crash the last checkpoint_save row is the
            # resume point
            _journal.emit("checkpoint_save", step=step, durable=True,
                          bytes=written,
                          seconds=round(time.perf_counter() - t0, 6))
        try:
            self._gc()
        except Exception as e:  # noqa: BLE001 — GC must not fail a save
            log.warning("checkpoint GC failed: %s", e)
            if _metrics.ENABLED:
                _metrics.CHECKPOINT_FAILURES.inc(
                    stage="gc", reason=type(e).__name__)

    # -- barrier -------------------------------------------------------------
    def wait(self, timeout: Optional[float] = None) -> None:
        """Block until every queued save has committed; raise the first
        deferred write error if one occurred."""
        deadline = None if timeout is None else time.monotonic() + timeout
        with self._lock:
            while self._pending > 0:
                remaining = None if deadline is None \
                    else deadline - time.monotonic()
                if remaining is not None and remaining <= 0:
                    raise CheckpointError(
                        f"wait() timed out with {self._pending} pending")
                self._lock.wait(remaining)
        self._raise_pending_error()

    def all_finished(self) -> bool:
        with self._lock:
            return self._pending == 0

    def _raise_pending_error(self) -> None:
        with self._lock:
            if self._errors:
                raise self._errors.pop(0)

    def close(self) -> None:
        """Drain the queue and stop the writer thread."""
        try:
            self.wait()
        finally:
            with self._lock:
                self._closed = True
                self._lock.notify_all()
            if self._worker is not None:
                self._worker.join(timeout=5)

    # -- retention -----------------------------------------------------------
    def _pinned(self, step: int) -> bool:
        return self.keep_period is not None and step % self.keep_period == 0

    def _gc(self) -> None:
        # stale tmp dirs from crashed writers are junk; only the writer
        # runs here (under _write_lock), so no in-flight tmp is caught
        for path in _layout.tmp_dirs(self.directory):
            shutil.rmtree(path, ignore_errors=True)
        if self.max_to_keep is None:
            return
        steps = _layout.all_steps(self.directory)
        disposable = [s for s in steps if not self._pinned(s)]
        for step in disposable[:max(0, len(disposable) - self.max_to_keep)]:
            shutil.rmtree(
                os.path.join(self.directory, _layout.step_dirname(step)),
                ignore_errors=True)

    # -- discovery -----------------------------------------------------------
    def all_steps(self) -> List[int]:
        return _layout.all_steps(self.directory)

    def latest_step(self) -> Optional[int]:
        return _layout.latest_step(self.directory)

    # -- restore -------------------------------------------------------------
    def restore(self, step: Optional[int] = None,
                with_manifest: bool = False):
        """Load the newest fully-valid checkpoint (or exactly ``step``).

        Auto mode (``step=None``) walks every ``step_N`` dir newest-first:
        a torn or CRC-corrupt checkpoint is logged and skipped for the
        previous valid step.  An explicit ``step`` raises
        ``CheckpointInvalidError`` instead.  Returns ``(step, state)`` (or
        ``(step, state, manifest)``); ``None`` when the directory holds no
        ``step_N`` candidate at all.  When candidates exist but every one
        is invalid, raises ``CheckpointError`` listing each step and why
        it was rejected."""
        self.wait()
        t0 = time.perf_counter()
        candidates = [int(step)] if step is not None \
            else sorted(_layout.raw_steps(self.directory), reverse=True)
        rejected: List[Tuple[int, str, str]] = []
        for cand in candidates:
            path = os.path.join(self.directory, _layout.step_dirname(cand))
            try:
                manifest, state = _layout.load_checkpoint_dir(path)
            except CheckpointInvalidError as e:
                if step is not None:
                    raise
                rejected.append((cand, getattr(e, "kind", "invalid"),
                                 str(e)))
                log.warning("skipping invalid checkpoint %s: %s", path, e)
                if _metrics.ENABLED:
                    _metrics.CHECKPOINT_FAILURES.inc(
                        stage="restore", reason=getattr(e, "kind",
                                                        "invalid"))
                continue
            if _metrics.ENABLED:
                _metrics.CHECKPOINT_RESTORE_SECONDS.observe(
                    time.perf_counter() - t0)
            if _journal.ENABLED:
                _journal.emit("checkpoint_restore", step=cand,
                              durable=False,
                              seconds=round(time.perf_counter() - t0, 6))
            if with_manifest:
                return cand, state, manifest
            return cand, state
        if rejected:
            lines = "\n".join(
                f"  step {s}: [{kind}] {msg}" for s, kind, msg in rejected)
            raise CheckpointError(
                f"no valid checkpoint in {self.directory}: scanned "
                f"{len(rejected)} candidate(s) newest-first and rejected "
                f"every one —\n{lines}\n(torn = incomplete write, crc = "
                "bit-rot, manifest/shard = unreadable metadata or payload)")
        return None


# ---------------------------------------------------------------------------
# env-routed default manager
# ---------------------------------------------------------------------------
_ENV_MANAGERS: Dict[str, CheckpointManager] = {}
_ENV_LOCK = threading.Lock()


def _drain_env_managers() -> None:
    # the writer is a daemon thread: the last checkpoint of a run must
    # not still be in flight when the interpreter exits
    with _ENV_LOCK:
        managers = list(_ENV_MANAGERS.values())
    for mgr in managers:
        try:
            mgr.wait(timeout=300)
        except Exception as e:  # noqa: BLE001 — exiting; report, don't mask
            log.error("checkpoint flush at exit failed: %s", e)


atexit.register(_drain_env_managers)


def env_manager() -> Optional[CheckpointManager]:
    """The process-wide manager for ``MXNET_CHECKPOINT_DIR``, or None
    when the env is unset (read at each call; one manager per
    directory)."""
    root = os.environ.get("MXNET_CHECKPOINT_DIR")
    if not root:
        return None
    with _ENV_LOCK:
        mgr = _ENV_MANAGERS.get(root)
        if mgr is None:
            mgr = CheckpointManager(
                root, max_to_keep=int(getenv("MXNET_CHECKPOINT_KEEP", 5)))
            _ENV_MANAGERS[root] = mgr
        return mgr


# ---------------------------------------------------------------------------
# state packing conventions shared by the integrations
# ---------------------------------------------------------------------------
PARAM_PREFIX = "param:"
ARG_PREFIX = "arg:"
AUX_PREFIX = "aux:"
TRAINER_STATES_KEY = "trainer:states"
OPTIMIZER_STATES_KEY = "optimizer:states"
SYMBOL_KEY = "symbol:json"


def pack_module_state(symbol, arg_params: Dict, aux_params: Dict,
                      optimizer_states: Optional[bytes] = None) -> Dict:
    state: Dict = {f"{ARG_PREFIX}{k}": v for k, v in arg_params.items()}
    state.update({f"{AUX_PREFIX}{k}": v for k, v in aux_params.items()})
    if symbol is not None:
        state[SYMBOL_KEY] = symbol.tojson().encode("utf-8")
    if optimizer_states is not None:
        state[OPTIMIZER_STATES_KEY] = optimizer_states
    return state


def unpack_module_state(state: Dict):
    """→ (arg_params, aux_params, optimizer_states_bytes_or_None,
    symbol_json_or_None) with arrays left as numpy."""
    arg_p = {k[len(ARG_PREFIX):]: v for k, v in state.items()
             if k.startswith(ARG_PREFIX)}
    aux_p = {k[len(AUX_PREFIX):]: v for k, v in state.items()
             if k.startswith(AUX_PREFIX)}
    opt = state.get(OPTIMIZER_STATES_KEY)
    sym_json = state.get(SYMBOL_KEY)
    if isinstance(sym_json, bytes):
        sym_json = sym_json.decode("utf-8")
    return arg_p, aux_p, opt, sym_json


def _as_param_dict(params):
    """Accept a gluon Block, ParameterDict, or {name: Parameter}.
    Returns ``{stripped_name: Parameter}``: names are stored without the
    Block's prefix, so a checkpoint written by ``hybridsequential0_``
    restores into a fresh ``hybridsequential1_`` net.  A dict is taken
    as it is."""
    from ..gluon.parameter import ParameterDict
    prefix = ""
    if hasattr(params, "collect_params"):
        prefix = getattr(params, "prefix", "")
        params = params.collect_params()
    if isinstance(params, ParameterDict):
        prefix = prefix or params.prefix
        if any(not name.startswith(prefix) for name in params.keys()):
            prefix = ""  # mixed scopes: full names
        return {name[len(prefix):]: params[name] for name in params.keys()}
    if isinstance(params, dict):
        return params
    raise MXNetError("expected a gluon Block, ParameterDict, or dict of "
                     f"Parameters, got {type(params)}")


def save_trainer(manager: CheckpointManager, step: int, params,
                 trainer=None, extra_state: Optional[Dict] = None,
                 block: bool = False) -> None:
    """Checkpoint a gluon training job: the parameters (BatchNorm's moving
    statistics among them) and, with ``trainer``, its
    ``get_states_bytes()`` (the updater's states and the optimizer)."""
    pd = _as_param_dict(params)
    state: Dict = {f"{PARAM_PREFIX}{name}": p.data()
                   for name, p in pd.items()}
    signatures = {"mesh_signature": _MESH_SIGNATURE}
    if trainer is not None:
        state[TRAINER_STATES_KEY] = trainer.get_states_bytes()
        if trainer._bucket_sig is not None:
            signatures["trainer_bucket_sig"] = repr(trainer._bucket_sig)
        signatures["amp_policy"] = getattr(trainer._updater,
                                           "dtype_policy", "f32")
    if extra_state:
        overlap = set(extra_state) & set(state)
        if overlap:
            raise MXNetError(f"extra_state collides with packed keys: "
                             f"{sorted(overlap)}")
        state.update(extra_state)
    manager.save(step, state, signatures=signatures, block=block)


def restore_trainer(manager: CheckpointManager, params, trainer=None,
                    step: Optional[int] = None,
                    ctx=None) -> Optional[int]:
    """Load the newest valid checkpoint into ``params`` (and
    ``trainer``).  Returns the restored step, or None when the
    directory holds no checkpoint.  Missing parameters raise and nothing
    is loaded — a half-restored model must never train silently."""
    res = manager.restore(step, with_manifest=True)
    if res is None:
        return None
    got_step, state, manifest = res
    sigs = manifest.get("signatures") or {}
    saved_amp = sigs.get("amp_policy")
    cur_amp = _configured_amp() if saved_amp is not None else None
    if saved_amp is not None and saved_amp != cur_amp:
        log.warning("checkpoint step %s was written under effective "
                    "MXNET_AMP=%s but this process is configured for %s — "
                    "resuming changes the numeric trajectory (the loss "
                    "scaler restores regardless)", got_step, saved_amp,
                    cur_amp)
    saved_mesh = sigs.get("mesh_signature")
    if saved_mesh is not None and saved_mesh != _MESH_SIGNATURE:
        raise CheckpointError(
            f"checkpoint step {got_step} was written on mesh [{saved_mesh}] "
            f"but this process runs one device [{_MESH_SIGNATURE}]: "
            "sharded checkpoints wait for ROADMAP.md item 6")
    pd = _as_param_dict(params)
    missing = [name for name in pd
               if f"{PARAM_PREFIX}{name}" not in state]
    if missing:
        raise CheckpointError(
            f"checkpoint step {got_step} lacks parameters {missing[:5]}"
            f"{'...' if len(missing) > 5 else ''}")
    for name, p in pd.items():
        arr = state[f"{PARAM_PREFIX}{name}"]
        try:
            pctx = p.list_ctx()
        except Exception:  # noqa: BLE001 — uninitialized, no deferred ctx
            from ..context import cpu
            pctx = [ctx] if ctx is not None else [cpu()]
        p._load_init(_host_tensor(arr), pctx)
    if trainer is not None and TRAINER_STATES_KEY in state:
        trainer.set_states_bytes(state[TRAINER_STATES_KEY])
    if _journal.ENABLED:
        _journal.resume_marker(got_step, source="restore_trainer")
    return got_step


def _host_tensor(arr):
    """A CPU tensor over a loaded array (bfloat16's ``|V2`` included)."""
    import torch
    from ..ndarray import array
    return array(arr, ctx=torch.device("cpu"))


def restore_or_initialize(manager: CheckpointManager, params, trainer=None,
                          initializer=None, ctx=None,
                          step: Optional[int] = None) -> Optional[int]:
    """Auto-resume convenience: restore the latest valid checkpoint, or —
    when none exists — initialize the parameters fresh.  Returns the
    restored step (None = initialized from scratch)::

        mgr = mx.checkpoint.CheckpointManager(dir, max_to_keep=5)
        start = mx.checkpoint.restore_or_initialize(
            mgr, net, trainer, initializer=mx.init.Xavier()) or 0
        for step in range(start, total_steps):
            ... train ...
            if step % 100 == 0:
                mx.checkpoint.save_trainer(mgr, step, net, trainer)
    """
    got = restore_trainer(manager, params, trainer=trainer, step=step,
                          ctx=ctx)
    if got is not None:
        return got
    pd = _as_param_dict(params)
    from ..gluon.parameter import ParameterDict
    holder = params.collect_params() if hasattr(params, "collect_params") \
        else params
    if isinstance(holder, ParameterDict):
        holder.initialize(init=initializer, ctx=ctx)
    else:
        for p in pd.values():
            p.initialize(init=initializer, ctx=ctx)
    return None
