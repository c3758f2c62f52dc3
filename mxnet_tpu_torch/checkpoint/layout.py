"""On-disk checkpoint layout: atomic step directories with a validated
manifest (the port's copy of ``mxnet_tpu/checkpoint/layout.py``: the same
format, so either package reads a directory the other wrote).

One checkpoint = one directory::

    <root>/
      step_200/
        manifest.json          # commit record: entries, shapes, CRCs
        shard_0.npz            # array payload, size-capped shards
        shard_1.npz
      step_400/ ...
      .tmp-step_600-1234-7/    # in-flight write; ignored by discovery

The write protocol makes a torn write IMPOSSIBLE to load:

  1. everything is written into a ``.tmp-*`` sibling directory;
  2. the manifest (which carries per-entry CRC32s and per-shard sizes)
     is written last, via its own temp-file + ``os.replace``;
  3. the directory is fsynced and renamed (``os.replace``) to
     ``step_N`` — the rename is the commit point, atomic on POSIX.

A crash at any earlier point leaves only a ``.tmp-*`` directory, which
discovery skips and the manager's GC removes.  A checkpoint that lost a
shard, had its manifest truncated, or whose array bytes rot on disk
fails validation (existence + size at scan time, CRC32 at load time)
and is treated as absent — never loaded.

State model: a flat ``{name: value}`` dict where each value is an
array (a tensor or numpy), ``bytes`` (opaque blobs: optimizer-state
pickles, symbol JSON), or a JSON-able python value.  Arrays and bytes
land in npz shards under generated keys; JSON values inline into the
manifest.

bfloat16 is stored as numpy stores it, 2-byte raw data (``|V2``), under
the manifest dtype ``bfloat16`` (the name the JAX package writes), and
loads back as ``|V2`` arrays, which the port's ``nd.array`` reads as
bfloat16: no ``ml_dtypes`` is needed either way.  The JAX package's reader
compares the loaded ``|V2`` against ``bfloat16`` and rejects such an
entry, in its own directories too.
"""
from __future__ import annotations

import json
import os
import re
import zlib
from typing import Dict, List, Optional, Tuple

import numpy as _np

import torch

from ..base import MXNetError, getenv
from ..ndarray.ndarray import host_copy

FORMAT_VERSION = 1
MANIFEST = "manifest.json"
_STEP_RE = re.compile(r"^step_(\d+)$")
_TMP_PREFIX = ".tmp-"
_RAW_BF16 = _np.dtype("V2")


class CheckpointInvalidError(MXNetError):
    """A checkpoint directory failed validation (torn write, missing
    shard, CRC mismatch, unreadable manifest).  ``kind`` names the
    rejection class — ``manifest`` (unreadable/unsupported/drifted
    manifest), ``torn`` (missing shard / size mismatch / missing
    entry: an incomplete write), ``crc`` (bit-rot: stored CRC32
    disagrees), ``shard`` (shard file unreadable) — so
    ``CheckpointManager.restore``'s exhaustion diagnostics can say WHY
    each candidate was rejected."""

    def __init__(self, msg: str, kind: str = "invalid"):
        super().__init__(msg)
        self.kind = kind


def step_dirname(step: int) -> str:
    return f"step_{int(step)}"


def parse_step(name: str) -> Optional[int]:
    m = _STEP_RE.match(name)
    return int(m.group(1)) if m else None


def is_tmp_dirname(name: str) -> bool:
    return name.startswith(_TMP_PREFIX)


# ---------------------------------------------------------------------------
# state snapshot (device -> host, eager)
# ---------------------------------------------------------------------------
def snapshot_state(state: Dict) -> Dict[str, tuple]:
    """Copy every entry off the device / out of caller-mutable memory
    NOW, so training may overwrite its buffers the moment ``save()``
    returns.  Returns ``{name: (kind, payload)}`` with kind in {'array',
    'bytes', 'json'}."""
    if not isinstance(state, dict):
        raise MXNetError("checkpoint state must be a {name: value} dict, "
                         f"got {type(state)}")
    out: Dict[str, tuple] = {}
    for name, value in state.items():
        if not isinstance(name, str) or not name:
            raise MXNetError(f"state keys must be non-empty str, got {name!r}")
        if isinstance(value, (bytes, bytearray, memoryview)):
            out[name] = ("bytes", bytes(value))
        elif isinstance(value, torch.Tensor):
            # an owned host copy; bfloat16 as 2-byte raw data
            out[name] = ("array", host_copy(value))
        elif isinstance(value, _np.ndarray) or hasattr(value, "__array__"):
            out[name] = ("array", _np.array(value, copy=True))
        else:
            try:
                json.dumps(value)
            except (TypeError, ValueError):
                raise MXNetError(
                    f"state['{name}'] ({type(value).__name__}) is not an "
                    "array, bytes, or JSON-able value") from None
            out[name] = ("json", value)
    return out


def _dtype_name(arr: _np.ndarray) -> str:
    return "bfloat16" if arr.dtype == _RAW_BF16 else str(arr.dtype)


def _crc32(arr: _np.ndarray) -> int:
    """CRC32 of the array's bytes in C order, read in place."""
    return zlib.crc32(_np.ascontiguousarray(arr).reshape(-1).view(_np.uint8))


# ---------------------------------------------------------------------------
# write
# ---------------------------------------------------------------------------
def _fsync_on() -> bool:
    # MXNET_CHECKPOINT_FSYNC=0 trades durability-past-OS-crash for
    # speed (atomicity vs PROCESS crash still holds — that comes from
    # the rename, not the fsyncs).  Read per-write so tests can flip it.
    return bool(getenv("MXNET_CHECKPOINT_FSYNC", True))


def _fsync_file(path: str) -> None:
    if not _fsync_on():
        return
    fd = os.open(path, os.O_RDONLY)
    try:
        os.fsync(fd)
    finally:
        os.close(fd)


def _fsync_dir(path: str) -> None:
    if not _fsync_on():
        return
    try:
        fd = os.open(path, os.O_RDONLY)
    except OSError:
        return  # platform without O_RDONLY dir opens: best-effort
    try:
        os.fsync(fd)
    except OSError:
        pass
    finally:
        os.close(fd)


def _entry_bytes(kind: str, payload) -> _np.ndarray:
    if kind == "bytes":
        return _np.frombuffer(payload, dtype=_np.uint8)
    return payload


def write_checkpoint_dir(root: str, step: int, snap: Dict[str, tuple],
                         tmp_token: str, meta: Optional[dict] = None,
                         signatures: Optional[dict] = None,
                         shard_cap_bytes: Optional[int] = None) -> int:
    """Write one checkpoint under ``root`` using the tmp+rename
    protocol.  ``snap`` is ``snapshot_state`` output.  Returns payload
    bytes written.  Raises OSError (and friends) on IO failure — the
    manager retries around this."""
    import time as _time
    if shard_cap_bytes is None:
        shard_cap_bytes = int(float(getenv("MXNET_CHECKPOINT_SHARD_MB",
                                           256.0)) * (1 << 20))
    final = os.path.join(root, step_dirname(step))
    tmp = os.path.join(root, f"{_TMP_PREFIX}{step_dirname(step)}-{tmp_token}")
    os.makedirs(root, exist_ok=True)
    if os.path.exists(tmp):
        import shutil
        shutil.rmtree(tmp)
    os.makedirs(tmp)

    # size-capped shard packing, insertion order (stable across runs)
    entries: Dict[str, dict] = {}
    shards: List[Dict[str, _np.ndarray]] = []
    shard_fill = 0
    for name, (kind, payload) in snap.items():
        if kind == "json":
            entries[name] = {"kind": "json", "value": payload}
            continue
        arr = _entry_bytes(kind, payload)
        nbytes = int(arr.nbytes)
        if not shards or (shard_fill and shard_fill + nbytes > shard_cap_bytes):
            shards.append({})
            shard_fill = 0
        sid = len(shards) - 1
        key = f"e_{len(shards[sid])}"
        shards[sid][key] = arr
        shard_fill += nbytes
        entry = {"kind": kind, "shard": f"shard_{sid}.npz", "key": key,
                 "crc32": _crc32(arr)}
        if kind == "array":
            entry["shape"] = list(arr.shape)
            entry["dtype"] = _dtype_name(arr)
        entries[name] = entry

    written = 0
    shard_meta = {}
    for sid, shard in enumerate(shards):
        fname = f"shard_{sid}.npz"
        path = os.path.join(tmp, fname)
        with open(path, "wb") as f:
            _np.savez(f, **shard)
        _fsync_file(path)
        shard_meta[fname] = {"bytes": os.path.getsize(path)}
        written += shard_meta[fname]["bytes"]

    from .. import __version__
    manifest = {
        "format_version": FORMAT_VERSION,
        "step": int(step),
        "time": _time.time(),
        "library_version": __version__,
        "entries": entries,
        "shards": shard_meta,
        "signatures": signatures or {},
        "meta": meta or {},
    }
    mpath = os.path.join(tmp, MANIFEST)
    mtmp = mpath + ".tmp"
    with open(mtmp, "w") as f:
        json.dump(manifest, f, indent=1, sort_keys=True)
        f.flush()
        os.fsync(f.fileno())
    os.replace(mtmp, mpath)
    _fsync_dir(tmp)

    if os.path.exists(final):
        # re-save of an existing step: replace it (rare — a resumed run
        # re-reaching the same step).  The window between rmtree and
        # rename only ever risks THIS step; older steps stay intact.
        import shutil
        shutil.rmtree(final)
    os.replace(tmp, final)
    _fsync_dir(root)
    return written


# ---------------------------------------------------------------------------
# validate / read
# ---------------------------------------------------------------------------
def read_manifest(step_dir: str) -> dict:
    mpath = os.path.join(step_dir, MANIFEST)
    try:
        with open(mpath) as f:
            manifest = json.load(f)
    except (OSError, ValueError) as e:
        raise CheckpointInvalidError(
            f"{step_dir}: unreadable manifest ({e})",
            kind="manifest") from None
    if manifest.get("format_version") != FORMAT_VERSION:
        raise CheckpointInvalidError(
            f"{step_dir}: unsupported format_version "
            f"{manifest.get('format_version')!r}", kind="manifest")
    return manifest


def quick_validate(step_dir: str) -> dict:
    """Cheap scan-time validation: manifest parses, every shard exists
    with the recorded size.  Returns the manifest."""
    manifest = read_manifest(step_dir)
    for fname, info in manifest.get("shards", {}).items():
        path = os.path.join(step_dir, fname)
        try:
            size = os.path.getsize(path)
        except OSError:
            raise CheckpointInvalidError(
                f"{step_dir}: missing shard {fname}",
                kind="torn") from None
        if size != info.get("bytes"):
            raise CheckpointInvalidError(
                f"{step_dir}: shard {fname} is {size} bytes, manifest "
                f"says {info.get('bytes')}", kind="torn")
    return manifest


def load_checkpoint_dir(step_dir: str) -> Tuple[dict, Dict]:
    """Full validation + load: every entry's CRC32 must match the
    manifest.  Returns ``(manifest, state)`` with arrays as numpy
    (bfloat16 as ``|V2``), bytes entries as bytes, json entries
    verbatim."""
    manifest = quick_validate(step_dir)
    loaded_shards: Dict[str, dict] = {}
    for fname in manifest.get("shards", {}):
        path = os.path.join(step_dir, fname)
        try:
            with _np.load(path, allow_pickle=False) as z:
                loaded_shards[fname] = {k: z[k] for k in z.keys()}
        except Exception as e:  # noqa: BLE001 — any zip/npy damage
            raise CheckpointInvalidError(
                f"{step_dir}: shard {fname} unreadable ({e})",
                kind="shard") from None
    state: Dict = {}
    for name, entry in manifest["entries"].items():
        kind = entry["kind"]
        if kind == "json":
            state[name] = entry["value"]
            continue
        shard = loaded_shards.get(entry["shard"], {})
        if entry["key"] not in shard:
            raise CheckpointInvalidError(
                f"{step_dir}: entry '{name}' missing from {entry['shard']}",
                kind="torn")
        arr = shard[entry["key"]]
        crc = _crc32(arr)
        if crc != entry["crc32"]:
            raise CheckpointInvalidError(
                f"{step_dir}: CRC mismatch on '{name}' "
                f"(stored {entry['crc32']}, computed {crc})", kind="crc")
        if kind == "bytes":
            state[name] = arr.tobytes()
        else:
            if list(arr.shape) != entry.get("shape") or \
                    _dtype_name(arr) != entry.get("dtype"):
                raise CheckpointInvalidError(
                    f"{step_dir}: entry '{name}' shape/dtype drifted from "
                    "manifest", kind="manifest")
            state[name] = arr
    return manifest, state


# ---------------------------------------------------------------------------
# discovery
# ---------------------------------------------------------------------------
def raw_steps(root: str) -> List[int]:
    """Every ``step_N`` directory, valid or not (restore walks this so
    invalid checkpoints are COUNTED as they are skipped)."""
    try:
        names = os.listdir(root)
    except OSError:
        return []
    return sorted(s for s in (parse_step(n) for n in names)
                  if s is not None)


def all_steps(root: str) -> List[int]:
    """Sorted steps whose directories pass quick validation.  Junk
    files, in-flight ``.tmp-*`` dirs, and torn checkpoints are
    silently skipped — discovery never raises on bad entries."""
    steps = []
    for step in raw_steps(root):
        try:
            quick_validate(os.path.join(root, step_dirname(step)))
        except CheckpointInvalidError:
            continue
        steps.append(step)
    return sorted(steps)


def latest_step(root: str) -> Optional[int]:
    steps = all_steps(root)
    return steps[-1] if steps else None


def tmp_dirs(root: str) -> List[str]:
    try:
        names = os.listdir(root)
    except OSError:
        return []
    return [os.path.join(root, n) for n in names if is_tmp_dirname(n)]
