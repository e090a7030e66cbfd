"""ctypes wrapper over the native C++ forward engine.

The port's copy of `veles_tpu/native_engine.py`: load a package written
by `veles_tpu_torch.export.export_workflow` and run the forward on the
host CPU with no PyTorch in the loop (the libVeles/libZnicz slot of the
original VELES). The engine is the port's copy of the C++ source,
`native/znicz_engine.cpp`, built at first use with `g++ -O2` into
`veles_tpu_torch/_build/`, keyed by the source's hash, as
native_gather.py builds `host_gather.cpp`: the compiler writes a file of
its own, which is renamed into place, so that two processes building at
once never load a torn library.
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
SOURCE = _PKG / "native" / "znicz_engine.cpp"
BUILD_DIR = _PKG / "_build"
CXX_FLAGS = ("-O2", "-std=c++17", "-fPIC", "-shared")

_lib: Optional[ctypes.CDLL] = None
_lib_lock = threading.Lock()   # one build and dlopen under concurrent use


def library_path() -> Path:
    h = hashlib.sha256(" ".join(CXX_FLAGS).encode())
    h.update(SOURCE.read_bytes())
    return BUILD_DIR / f"libznicz-{h.hexdigest()[:16]}.so"


def build_library() -> str:
    """Compile the engine unless the library of the current source's
    hash exists; returns its path. Raises OSError without a compiler or
    with its output when it fails."""
    out = library_path()
    if out.exists():
        return str(out)
    cxx = shutil.which(os.environ.get("CXX", "g++"))
    if cxx is None:
        raise OSError("no C++ compiler (g++) on PATH")
    BUILD_DIR.mkdir(exist_ok=True)
    # a file lock: several processes of one checkout build once
    with open(BUILD_DIR / ".lock", "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        if out.exists():
            return str(out)
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        r = subprocess.run([cxx, *CXX_FLAGS, "-o", str(tmp), str(SOURCE)],
                           capture_output=True, text=True)
        if r.returncode != 0:
            raise OSError(f"g++ failed:\n{r.stdout}{r.stderr}")
        os.replace(tmp, out)
    return str(out)


def _load_lib() -> ctypes.CDLL:
    global _lib
    with _lib_lock:
        if _lib is None:
            lib = ctypes.CDLL(build_library())
            lib.znicz_load.restype = ctypes.c_void_p
            lib.znicz_load.argtypes = [ctypes.c_char_p]
            lib.znicz_error.restype = ctypes.c_char_p
            lib.znicz_error.argtypes = [ctypes.c_void_p]
            lib.znicz_input_size.restype = ctypes.c_int
            lib.znicz_input_size.argtypes = [ctypes.c_void_p]
            lib.znicz_output_size.restype = ctypes.c_int
            lib.znicz_output_size.argtypes = [ctypes.c_void_p]
            lib.znicz_infer.restype = ctypes.c_int
            lib.znicz_infer.argtypes = [
                ctypes.c_void_p, ctypes.POINTER(ctypes.c_float),
                ctypes.c_int, ctypes.c_int, ctypes.POINTER(ctypes.c_float),
                ctypes.c_longlong]
            lib.znicz_free.argtypes = [ctypes.c_void_p]
            _lib = lib
    return _lib


class NativeEngine:
    """Forward-only inference over an exported package directory."""

    def __init__(self, package_dir: str) -> None:
        self._lib = _load_lib()
        self._h = self._lib.znicz_load(str(package_dir).encode())
        err = self._lib.znicz_error(self._h)
        if err:
            msg = err.decode()
            self.close()
            raise RuntimeError(f"znicz_load: {msg}")
        self.input_size = self._lib.znicz_input_size(self._h)
        self.output_size = self._lib.znicz_output_size(self._h)
        if self.output_size < 0:
            msg = self._lib.znicz_error(self._h).decode()
            self.close()
            raise RuntimeError(f"znicz_output_size: {msg}")

    def infer(self, x: np.ndarray) -> np.ndarray:
        """x: (N, ...) float32 — returns (N, output_size)."""
        x = np.ascontiguousarray(x, np.float32)
        n = x.shape[0]
        if n == 0:
            return np.empty((0, self.output_size), np.float32)
        sample_len = int(np.prod(x.shape[1:]))
        out = np.empty(n * self.output_size, np.float32)
        res = self._lib.znicz_infer(
            self._h, x.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
            n, sample_len,
            out.ctypes.data_as(ctypes.POINTER(ctypes.c_float)), out.size)
        if res < 0:
            raise RuntimeError(
                f"znicz_infer: {self._lib.znicz_error(self._h).decode()}")
        return out[:n * res].reshape(n, res).copy()

    def close(self) -> None:
        if getattr(self, "_h", None):
            self._lib.znicz_free(self._h)
            self._h = None

    def __enter__(self) -> "NativeEngine":
        return self

    def __exit__(self, *exc) -> None:
        self.close()

    def __del__(self) -> None:
        try:
            self.close()
        except Exception:  # noqa: BLE001 — interpreter teardown
            pass
