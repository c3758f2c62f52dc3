"""Build the port's CUDA kernels from ``csrc/`` and load them with ctypes.

Each ``csrc/<name>.cu`` compiles on its own, with ``nvcc`` and no PyTorch
headers, into ``build/kernels/lib<name>-<hash>.so`` at the repository root
(the hash covers the sources and the flags, so an edit rebuilds).  The
libraries export plain C functions that take raw pointers and a stream;
``load(name)`` builds on first use and returns the ``ctypes.CDLL``.
``build()`` starts one ``nvcc`` per source, all at once, and waits for all.

Nothing here runs when the package is imported: the CPU tests import every
module on a machine that has no ``nvcc``.
"""
from __future__ import annotations

import ctypes
import glob
import hashlib
import os
import shutil
import subprocess
import threading
import time

from ..base import MXNetError

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC = os.path.join(_PKG, "csrc")
BUILD_DIR = os.path.join(os.path.dirname(_PKG), "build", "kernels")
SOURCES = ("add_one", "flash_attention_fwd")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

# name -> {"seconds": float, "log": compiler output} for builds in this process
BUILD_LOG: dict = {}
_LIBS: dict = {}
_LOCK = threading.Lock()


def nvcc() -> str:
    home = os.environ.get("CUDA_HOME") or "/usr/local/cuda"
    for cand in (os.path.join(home, "bin", "nvcc"), shutil.which("nvcc")):
        if cand and os.access(cand, os.X_OK):
            return cand
    raise MXNetError("nvcc not found (looked in $CUDA_HOME/bin, "
                     "/usr/local/cuda/bin and PATH): the CUDA kernels of "
                     "mxnet_tpu_torch are built on the machine with the card")


def lib_path(name: str) -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for f in sorted(glob.glob(os.path.join(CSRC, "*.cuh"))) + [
            os.path.join(CSRC, name + ".cu")]:
        with open(f, "rb") as fh:
            h.update(fh.read())
    return os.path.join(BUILD_DIR, f"lib{name}-{h.hexdigest()[:16]}.so")


def build(names=SOURCES, force=False) -> dict:
    """Compile every library in ``names`` that is not built yet (all of them
    with ``force``), all in parallel; returns ``BUILD_LOG``.  Raises if any
    compile fails."""
    jobs = []
    for name in names:
        out = lib_path(name)
        if os.path.exists(out) and not force:
            continue
        os.makedirs(BUILD_DIR, exist_ok=True)
        tmp = f"{out}.tmp{os.getpid()}"
        cmd = [nvcc(), *NVCC_FLAGS, "-o", tmp,
               os.path.join(CSRC, name + ".cu")]
        proc = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                stderr=subprocess.STDOUT, text=True)
        jobs.append((name, proc, tmp, out, time.perf_counter()))
    failed = []
    for name, proc, tmp, out, t0 in jobs:
        log, _ = proc.communicate()
        BUILD_LOG[name] = {"seconds": time.perf_counter() - t0, "log": log}
        if proc.returncode != 0:
            failed.append(f"nvcc failed for {name}.cu "
                          f"(exit {proc.returncode}):\n{log}")
            continue
        os.replace(tmp, out)
    if failed:
        raise MXNetError("\n".join(failed))
    return BUILD_LOG


def load(name: str) -> ctypes.CDLL:
    """The loaded library for ``csrc/<name>.cu``, built on first use."""
    with _LOCK:
        lib = _LIBS.get(name)
        if lib is None:
            build((name,))
            lib = ctypes.CDLL(lib_path(name))
            lib.mxt_error_string.argtypes = [ctypes.c_int]
            lib.mxt_error_string.restype = ctypes.c_char_p
            _LIBS[name] = lib
        return lib


def check(lib: ctypes.CDLL, err: int, what: str) -> None:
    """Raise if a C entry point reported a CUDA error."""
    if err != 0:
        raise MXNetError(f"{what} failed: CUDA error {err} "
                         f"({lib.mxt_error_string(err).decode()})")
