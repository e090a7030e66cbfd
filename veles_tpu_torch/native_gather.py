"""ctypes wrapper over the native multithreaded minibatch gather.

The port's counterpart of `veles_tpu/native_gather.py`, over its own copy
of the C++ source (`native/host_gather.cpp`). The packed-memmap
pipeline's hot path is a row gather + flip + normalize; the library fans
it over threads. Python resolves shard bases + row offsets into flat
per-row source addresses, so the C++ side is shard-agnostic.

The library is built at first use with `g++ -O2 -pthread -shared` into
`veles_tpu_torch/_build/`, keyed by the source's hash, as ops/kernels.py
builds the CUDA sources. Where no toolchain builds it, `available()` is
False and the loader's `native="auto"` keeps the numpy path; `last_error`
says why.
"""

from __future__ import annotations

import ctypes
import fcntl
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path
from typing import Optional

import numpy as np

_PKG = Path(__file__).resolve().parent
SOURCE = _PKG / "native" / "host_gather.cpp"
BUILD_DIR = _PKG / "_build"
CXX_FLAGS = ("-O2", "-std=c++17", "-fPIC", "-pthread", "-shared")

_lib: Optional[ctypes.CDLL] = None
_lib_failed = False
#: why the library is unavailable (None while it is, or before a try)
last_error: Optional[str] = None
_lib_lock = threading.Lock()   # one build and dlopen under concurrent use

#: threads for the row fan-out: the gather is bound by memory bandwidth,
#: so a handful saturates it
DEFAULT_THREADS = min(8, os.cpu_count() or 1)


def library_path() -> Path:
    h = hashlib.sha256(" ".join(CXX_FLAGS).encode())
    h.update(SOURCE.read_bytes())
    return BUILD_DIR / f"libhostgather-{h.hexdigest()[:16]}.so"


def _build(out: Path) -> None:
    cxx = shutil.which(os.environ.get("CXX", "g++"))
    if cxx is None:
        raise OSError("no C++ compiler (g++) on PATH")
    BUILD_DIR.mkdir(exist_ok=True)
    # a file lock: several processes of one checkout build once
    with open(BUILD_DIR / ".lock", "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        if out.exists():
            return
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        r = subprocess.run([cxx, *CXX_FLAGS, "-o", str(tmp), str(SOURCE)],
                           capture_output=True, text=True)
        if r.returncode != 0:
            raise OSError(f"g++ failed:\n{r.stdout}{r.stderr}")
        os.replace(tmp, out)


def _load_lib() -> Optional[ctypes.CDLL]:
    global _lib, _lib_failed, last_error
    if _lib is not None or _lib_failed:
        return _lib
    with _lib_lock:
        if _lib is not None or _lib_failed:   # built while we waited
            return _lib
        try:
            out = library_path()
            if not out.exists():
                _build(out)
            lib = ctypes.CDLL(str(out))
            lib.hg_gather_u8.argtypes = [
                ctypes.POINTER(ctypes.c_longlong), ctypes.c_int,
                ctypes.c_longlong, ctypes.POINTER(ctypes.c_ubyte),
                ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_int]
            lib.hg_gather_f32.argtypes = [
                ctypes.POINTER(ctypes.c_longlong), ctypes.c_int,
                ctypes.c_longlong, ctypes.POINTER(ctypes.c_float),
                ctypes.c_void_p, ctypes.c_float, ctypes.c_float,
                ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_int]
            _lib = lib
        except OSError as e:
            _lib_failed = True
            last_error = str(e)
    return _lib


def available() -> bool:
    return _load_lib() is not None


def _flip_ptr(flip_arr: Optional[np.ndarray]):
    if flip_arr is None or not flip_arr.any():
        return None
    return flip_arr.ctypes.data_as(ctypes.c_void_p)


def gather_u8(src_addrs: np.ndarray, row_bytes: int, out: np.ndarray,
              flip: Optional[np.ndarray], w: int, c: int,
              n_threads: int = 0) -> None:
    """Copy len(src_addrs) rows of `row_bytes` bytes from the given
    absolute addresses into `out` (N, row_bytes...) uint8, flipping rows
    where `flip` is set. The source arrays must stay alive across the
    call (the loader holds its shard maps)."""
    lib = _load_lib()
    assert lib is not None, "native gather unavailable"
    src = np.ascontiguousarray(src_addrs, np.int64)
    # a reference, so the pointer stays valid through the call
    flip_arr = None if flip is None else np.ascontiguousarray(flip, np.uint8)
    lib.hg_gather_u8(
        src.ctypes.data_as(ctypes.POINTER(ctypes.c_longlong)), len(src),
        row_bytes, out.ctypes.data_as(ctypes.POINTER(ctypes.c_ubyte)),
        _flip_ptr(flip_arr), w, c, n_threads or DEFAULT_THREADS)


def gather_f32(src_addrs: np.ndarray, row_bytes: int, out: np.ndarray,
               mean: Optional[np.ndarray], scale: float, offset: float,
               flip: Optional[np.ndarray], w: int, c: int,
               n_threads: int = 0) -> None:
    """gather_u8 + the fused uint8 -> float32 `x / scale + offset - mean`
    (a division, so it gives the numpy path's bits)."""
    lib = _load_lib()
    assert lib is not None, "native gather unavailable"
    src = np.ascontiguousarray(src_addrs, np.int64)
    mean_arr = (None if mean is None
                else np.ascontiguousarray(mean, np.float32))
    flip_arr = None if flip is None else np.ascontiguousarray(flip, np.uint8)
    lib.hg_gather_f32(
        src.ctypes.data_as(ctypes.POINTER(ctypes.c_longlong)), len(src),
        row_bytes, out.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
        None if mean_arr is None
        else mean_arr.ctypes.data_as(ctypes.c_void_p),
        scale, offset, _flip_ptr(flip_arr), w, c,
        n_threads or DEFAULT_THREADS)
