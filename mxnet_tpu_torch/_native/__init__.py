"""ctypes bindings for the native host runtime (``src/runtime/``).

The counterpart of ``mxnet_tpu/_native/__init__.py``.  ``lib()`` builds the
runtime's sources (``storage``, ``engine``, ``recordio``, ``prefetch``: the
pooled host allocator, the dependency engine, the record codec and the
threaded batch loader) with ``g++ -O2 -std=c++17 -fPIC -pthread`` into
``build/runtime/`` on first use, through ``kernels/_build.py`` (one lock,
a rebuild when a source changes), loads the library and binds its C
functions.  A failed build raises
``MXNetError`` with the compiler's output: there is no pure-Python
fallback and no switch to turn the runtime off.
"""
from __future__ import annotations

import atexit
import ctypes
import os
import threading

from ..kernels import _build

_ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
_SRC = os.path.join(_ROOT, "src", "runtime")
SOURCES = tuple(os.path.join(_SRC, f + ".cc")
                for f in ("storage", "engine", "recordio", "prefetch"))
HEADERS = (os.path.join(_SRC, "mxt_runtime.h"),)
# engine.cc calls fprintf without including <cstdio>, which older
# libstdc++ headers pulled in through <thread>; newer ones do not
FLAGS = ("-O2", "-std=c++17", "-fPIC", "-Wall", "-pthread",
         "-fvisibility=hidden", "-include", "cstdio")

_lib = None
_lock = threading.Lock()


def _bind(l):
    u64, i32, vp, cp = (ctypes.c_uint64, ctypes.c_int, ctypes.c_void_p,
                        ctypes.c_char_p)
    l.MXTStorageAlloc.restype = vp
    l.MXTStorageAlloc.argtypes = [ctypes.c_size_t]
    l.MXTStorageFree.argtypes = [vp, ctypes.c_size_t]
    l.MXTStoragePoolStats.argtypes = [ctypes.POINTER(u64)] * 4
    l.MXTEngineStart.argtypes = [i32]
    l.MXTEngineNewVar.restype = u64
    l.MXTEngineDeleteVar.argtypes = [u64]
    l.MXTEnginePushAsync.argtypes = [
        ctypes.CFUNCTYPE(None, vp), vp,
        ctypes.POINTER(u64), i32, ctypes.POINTER(u64), i32, i32]
    l.MXTEngineWaitForVar.argtypes = [u64]
    l.MXTEngineNumWorkers.restype = i32
    l.MXTEngineNumPushed.restype = u64
    l.MXTRecordIOWriterCreate.restype = vp
    l.MXTRecordIOWriterCreate.argtypes = [cp]
    l.MXTRecordIOWriterWrite.argtypes = [vp, ctypes.c_char_p, u64]
    l.MXTRecordIOWriterWrite.restype = i32
    l.MXTRecordIOWriterTell.restype = u64
    l.MXTRecordIOWriterTell.argtypes = [vp]
    l.MXTRecordIOWriterClose.argtypes = [vp]
    l.MXTRecordIOReaderCreate.restype = vp
    l.MXTRecordIOReaderCreate.argtypes = [cp]
    l.MXTRecordIOReaderNext.argtypes = [vp, ctypes.POINTER(vp),
                                        ctypes.POINTER(u64)]
    l.MXTRecordIOReaderNext.restype = i32
    l.MXTRecordIOReaderSeek.argtypes = [vp, u64]
    l.MXTRecordIOReaderTell.restype = u64
    l.MXTRecordIOReaderTell.argtypes = [vp]
    l.MXTRecordIOReaderClose.argtypes = [vp]
    l.MXTBatchLoaderCreate.restype = vp
    l.MXTBatchLoaderCreate.argtypes = [cp, i32, u64, i32, i32, i32, u64]
    l.MXTBatchLoaderNext.argtypes = [vp, ctypes.POINTER(vp),
                                     ctypes.POINTER(vp)]
    l.MXTBatchLoaderNext.restype = i32
    l.MXTBatchLoaderReset.argtypes = [vp]
    l.MXTBatchLoaderNumSamples.restype = u64
    l.MXTBatchLoaderNumSamples.argtypes = [vp]
    l.MXTBatchLoaderFree.argtypes = [vp]
    l.MXTGetLastError.restype = cp
    return l


def lib_path() -> str:
    """The runtime's shared library, built first if it is not yet."""
    return _build.build_host("mxtpu_runtime", SOURCES, HEADERS, FLAGS)


def lib() -> ctypes.CDLL:
    """The loaded runtime, built and bound on the first call."""
    global _lib
    with _lock:
        if _lib is None:
            l = _bind(ctypes.CDLL(lib_path()))
            # drain the engine's queued host ops before the interpreter
            # finalizes: its static destructor would otherwise run ctypes
            # trampolines on a dead interpreter
            atexit.register(l.MXTEngineWaitAll)
            _lib = l
        return _lib
