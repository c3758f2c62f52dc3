"""Build the port's CUDA kernels from ``csrc/`` and load them with ctypes.

Each ``csrc/<name>.cu`` compiles on its own, with ``nvcc`` and no PyTorch
headers, into ``build/kernels/lib<name>-<hash>.so`` at the repository root
(the hash covers the sources and the flags, so an edit rebuilds).  The
libraries export plain C functions that take raw pointers and a stream;
``load(name)`` builds on first use and returns the ``ctypes.CDLL``, and an
``Entry`` is one bound entry point that a wrapper calls.
``build()`` starts one ``nvcc`` per source, all at once, and waits for all.
``build_host(name, sources, headers, flags)`` does the same for a C++
library of the host (the native runtime, ``_native/``): ``g++`` into
``build/runtime/lib<name>-<hash>.so``, rebuilt when a source, a header or
a flag changes, under the same lock.

Nothing here runs when the package is imported: the CPU tests import every
module on a machine that has no ``nvcc``.
"""
from __future__ import annotations

import ctypes
import glob
import hashlib
import os
import platform
import shutil
import subprocess
import threading
import time

import torch

from ..base import MXNetError

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC = os.path.join(_PKG, "csrc")
BUILD_DIR = os.path.join(os.path.dirname(_PKG), "build", "kernels")
SOURCES = ("add_one", "flash_attention_fwd", "flash_attention_fwd_sm90",
           "flash_attention_bwd", "flash_attention_bwd_sm90", "nms",
           "roi_pooling")
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


def build_host(name: str, sources, headers=(), flags=()) -> str:
    """Compile the C++ ``sources`` (paths) into one shared library with
    ``g++ flags -shared`` unless it is built already; returns its path.
    The file name carries a hash of the sources, ``headers``, flags, the
    compiler's version and the machine's architecture, so that a library
    built by another toolchain is never loaded.
    Raises ``MXNetError`` with the compiler's output if the build fails."""
    cxx = shutil.which("g++")
    if cxx is None:
        raise MXNetError(f"building {name} needs g++, and none was found")
    version = subprocess.run([cxx, "--version"], capture_output=True,
                             text=True).stdout
    h = hashlib.sha256("\0".join([*flags, version, platform.machine()])
                       .encode())
    for f in list(sources) + list(headers):
        with open(f, "rb") as fh:
            h.update(fh.read())
    out_dir = os.path.join(os.path.dirname(BUILD_DIR), "runtime")
    out = os.path.join(out_dir, f"lib{name}-{h.hexdigest()[:16]}.so")
    with _LOCK:
        if os.path.exists(out):
            return out
        os.makedirs(out_dir, exist_ok=True)
        tmp = f"{out}.tmp{os.getpid()}"
        t0 = time.perf_counter()
        proc = subprocess.run([cxx, *flags, "-shared", "-o", tmp,
                               *sources], capture_output=True, text=True)
        BUILD_LOG[name] = {"seconds": time.perf_counter() - t0,
                           "log": proc.stdout + proc.stderr}
        if proc.returncode != 0:
            raise MXNetError(f"g++ failed for {name} (exit "
                             f"{proc.returncode}):\n{proc.stderr}")
        os.replace(tmp, out)
    return out


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


class Entry:
    """One C entry point ``symbol`` of ``csrc/<lib>.cu`` whose last argument
    is a stream.  The library is built, loaded and the argument types bound
    on the first call; later calls pay only the device check and the call.

    ``entry(device, *args)`` launches on ``device``'s current stream,
    entering ``torch.cuda.device`` only when it is not the current device,
    and raises if the C function reports a CUDA error."""

    def __init__(self, lib: str, symbol: str, argtypes):
        self.lib_name, self.symbol, self.argtypes = lib, symbol, argtypes
        self._lib = self._fn = None

    def __call__(self, device, *args) -> None:
        if self._fn is None:
            lib = load(self.lib_name)
            fn = getattr(lib, self.symbol)
            fn.argtypes = list(self.argtypes) + [ctypes.c_void_p]
            fn.restype = ctypes.c_int
            self._lib, self._fn = lib, fn
        if device.index == torch.cuda.current_device():
            err = self._fn(*args, torch.cuda.current_stream().cuda_stream)
        else:
            with torch.cuda.device(device):
                err = self._fn(*args, torch.cuda.current_stream().cuda_stream)
        check(self._lib, err, f"{self.symbol} launch")


def check(lib: ctypes.CDLL, err: int, what: str) -> None:
    """Raise if a C entry point reported a CUDA error."""
    if err != 0:
        raise MXNetError(f"{what} failed: CUDA error {err} "
                         f"({lib.mxt_error_string(err).decode()})")
