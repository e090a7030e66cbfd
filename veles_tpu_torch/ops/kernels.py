"""The serving slice's hand-written Hopper kernels, their wrappers, their
plain PyTorch versions and their launch counters.

The port's counterpart of `veles_tpu/ops/pallas_kernels.py`:

- K2 `lrn_forward` replaces `_lrn_fwd_kernel` (via `lrn_forward_pallas`);
- K4 `lrn_maxpool_forward` replaces `_lrn_pool_fwd_kernel` (via
  `lrn_maxpool_pallas`).

The kernels are CUDA C++ for `sm_90a` under `veles_tpu_torch/csrc/`,
each source compiled by `nvcc` into its own shared library with a plain C
interface and loaded with `ctypes` (no PyTorch headers, so a build takes
seconds). `build()` compiles at first use into `veles_tpu_torch/_build/`,
keyed by the hash of the sources, all `nvcc` processes at once.

A wrapper launches its kernel for a CUDA tensor — or raises; it never
falls back — and takes the plain version only because its tensor lies on
the CPU. Each launch adds one to the kernel's counter in `LAUNCHES`, and
nothing else does.
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
from typing import Dict, Tuple

import torch

from veles_tpu_torch.ops import functional as fn

_PKG = Path(__file__).resolve().parent.parent
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG / "_build"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC")

#: kernel name -> its source under csrc/ and its C entry point
KERNELS: Dict[str, Tuple[str, str]] = {
    "lrn_forward": ("lrn_forward.cu", "lrn_forward_f32"),
    "lrn_maxpool_forward": ("lrn_maxpool_forward.cu",
                            "lrn_maxpool_forward_f32"),
}

#: kernel name -> launches since the last reset_launch_counts()
LAUNCHES: Dict[str, int] = {name: 0 for name in KERNELS}
_count_lock = threading.Lock()

_libs: Dict[str, ctypes.CDLL] = {}
_lib_paths: Dict[str, Path] = {}
_build_lock = threading.Lock()


def reset_launch_counts() -> None:
    with _count_lock:
        for name in LAUNCHES:
            LAUNCHES[name] = 0


def launch_counts() -> Dict[str, int]:
    with _count_lock:
        return dict(LAUNCHES)


def _count(name: str) -> None:
    with _count_lock:
        LAUNCHES[name] += 1


# ---------------------------------------------------------------------------
# build and load
# ---------------------------------------------------------------------------


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    for root in (os.environ.get("CUDA_HOME"), "/usr/local/cuda"):
        if root and os.access(os.path.join(root, "bin", "nvcc"), os.X_OK):
            return os.path.join(root, "bin", "nvcc")
    raise RuntimeError("nvcc not found (PATH, $CUDA_HOME, /usr/local/cuda): "
                       "the port's CUDA kernels cannot be built")


def _sources_digest() -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for path in sorted(CSRC.iterdir()):
        if path.suffix in (".cu", ".cuh"):
            h.update(path.name.encode())
            h.update(path.read_bytes())
    return h.hexdigest()[:16]


def build() -> Dict[str, Path]:
    """Compile every kernel source that has no library for the current
    sources' hash — one `nvcc` per source, all started together — and
    load them all. Idempotent; a failed build raises with nvcc's output."""
    with _build_lock:
        if len(_libs) == len(KERNELS):
            return dict(_lib_paths)
        BUILD_DIR.mkdir(exist_ok=True)
        digest = _sources_digest()
        outs = {name: BUILD_DIR / f"{Path(src).stem}-{digest}.so"
                for name, (src, _) in KERNELS.items()}
        # a file lock: several processes of one checkout build once
        with open(BUILD_DIR / ".lock", "w") as lock:
            fcntl.flock(lock, fcntl.LOCK_EX)
            todo = {name: out for name, out in outs.items()
                    if not out.exists()}
            if todo:
                nvcc = _nvcc()
                procs = {}
                for name, out in todo.items():
                    tmp = out.with_suffix(f".{os.getpid()}.tmp")
                    cmd = [nvcc, *NVCC_FLAGS, "-o", str(tmp),
                           str(CSRC / KERNELS[name][0])]
                    procs[name] = (subprocess.Popen(
                        cmd, stdout=subprocess.PIPE,
                        stderr=subprocess.STDOUT, text=True), tmp, out)
                failed = []
                for name, (proc, tmp, out) in procs.items():
                    log, _ = proc.communicate()
                    if proc.returncode != 0:
                        failed.append(f"{KERNELS[name][0]}:\n{log}")
                    else:
                        os.replace(tmp, out)
                if failed:
                    raise RuntimeError("nvcc failed:\n" + "\n".join(failed))
        for name, out in outs.items():
            lib = ctypes.CDLL(str(out))
            _declare(lib, KERNELS[name][1])
            _libs[name] = lib
        _lib_paths.update(outs)
        return outs


_P = ctypes.c_void_p
_I = ctypes.c_int
_L = ctypes.c_int64
_F = ctypes.c_float
_ARGTYPES = {
    # x, y, rows, C, half, k, alpha, q, beta, stream
    "lrn_forward_f32": [_P, _P, _L, _I, _I, _F, _F, _I, _F, _P],
    # x, y, n, H, W, C, OH, OW, ky, kx, sy, sx, half, k, alpha, q, beta,
    # stream
    "lrn_maxpool_forward_f32": [_P, _P, _L, _I, _I, _I, _I, _I, _I, _I,
                                _I, _I, _I, _F, _F, _I, _F, _P],
}


def _declare(lib: ctypes.CDLL, symbol: str) -> None:
    f = getattr(lib, symbol)
    f.argtypes = _ARGTYPES[symbol]
    f.restype = ctypes.c_int


def _entry(name: str):
    if name not in _libs:
        build()
    return getattr(_libs[name], KERNELS[name][1])


# ---------------------------------------------------------------------------
# argument checks shared by the wrappers
# ---------------------------------------------------------------------------


def _check_lrn_args(x: torch.Tensor, n: int, ndim: int) -> None:
    if x.dtype != torch.float32:
        raise TypeError(f"kernel takes float32, got {x.dtype}")
    if x.dim() != ndim:
        raise ValueError(f"expected a {ndim}-d NHWC tensor, got shape "
                         f"{tuple(x.shape)}")
    if not x.is_contiguous():
        raise ValueError("kernel takes a contiguous (NHWC) tensor")
    if n % 2 == 0 or n < 1:
        raise ValueError(f"LRN window n must be odd, got {n}")
    if x.requires_grad and torch.is_grad_enabled():
        raise RuntimeError("the LRN kernels are forward-only in this "
                           "slice: call them under torch.inference_mode()")


def _check_status(name: str, status: int) -> None:
    if status != 0:
        raise RuntimeError(f"{name} kernel launch failed: CUDA error "
                           f"{status}")


def _stream(x: torch.Tensor) -> int:
    return torch.cuda.current_stream(x.device).cuda_stream


# ---------------------------------------------------------------------------
# K2: LRN forward
# ---------------------------------------------------------------------------


def lrn_forward_plain(x: torch.Tensor, k: float = 2.0, alpha: float = 1e-4,
                      beta: float = 0.75, n: int = 5) -> torch.Tensor:
    """Plain PyTorch version of K2 (any layout whose LAST axis is C)."""
    return fn.lrn_forward(x, k, alpha, beta, n)


def lrn_forward(x: torch.Tensor, k: float = 2.0, alpha: float = 1e-4,
                beta: float = 0.75, n: int = 5) -> torch.Tensor:
    """Across-channel LRN of an NHWC tensor: K2 for a CUDA tensor, the
    plain version for a CPU one."""
    if x.device.type == "cpu":
        return lrn_forward_plain(x, k, alpha, beta, n)
    if x.device.type != "cuda":
        raise ValueError(f"lrn_forward runs on cuda or cpu, not {x.device}")
    _check_lrn_args(x, n, 4)
    c = x.shape[-1]
    rows = x.numel() // c if c else 0
    y = torch.empty_like(x)
    with torch.cuda.device(x.device):
        status = _entry("lrn_forward")(
            x.data_ptr(), y.data_ptr(), rows, c, n // 2, k, alpha,
            fn.quarter_exponent(beta), beta, _stream(x))
    _check_status("lrn_forward", status)
    _count("lrn_forward")
    return y


# ---------------------------------------------------------------------------
# K4: fused LRN -> ceil-mode max pool forward
# ---------------------------------------------------------------------------


def lrn_maxpool_forward_plain(x: torch.Tensor, k: float = 2.0,
                              alpha: float = 1e-4, beta: float = 0.75,
                              n: int = 5, ksize=(3, 3),
                              stride=(2, 2)) -> torch.Tensor:
    """Plain PyTorch version of K4: the LRN, then the ceil-mode pool."""
    return fn.maxpool_forward(fn.lrn_forward(x, k, alpha, beta, n),
                              tuple(ksize), tuple(stride))


def lrn_maxpool_forward(x: torch.Tensor, k: float = 2.0, alpha: float = 1e-4,
                        beta: float = 0.75, n: int = 5, ksize=(3, 3),
                        stride=(2, 2)) -> torch.Tensor:
    """LRN then ceil-mode max pool of an NHWC tensor, writing only the
    pooled output: K4 for a CUDA tensor, the plain version for a CPU
    one."""
    if x.device.type == "cpu":
        return lrn_maxpool_forward_plain(x, k, alpha, beta, n, ksize, stride)
    if x.device.type != "cuda":
        raise ValueError(f"lrn_maxpool_forward runs on cuda or cpu, not "
                         f"{x.device}")
    _check_lrn_args(x, n, 4)
    ky, kx = (int(v) for v in ksize)
    sy, sx = (int(v) for v in stride)
    if min(ky, kx, sy, sx) < 1:
        raise ValueError(f"bad pooling geometry ksize={ksize} "
                         f"stride={stride}")
    nb, h, w, c = x.shape
    oh, ow = fn.pool_out_hw(h, w, ky, kx, sy, sx)
    y = torch.empty((nb, oh, ow, c), dtype=x.dtype, device=x.device)
    with torch.cuda.device(x.device):
        status = _entry("lrn_maxpool_forward")(
            x.data_ptr(), y.data_ptr(), nb, h, w, c, oh, ow, ky, kx, sy, sx,
            n // 2, k, alpha, fn.quarter_exponent(beta), beta, _stream(x))
    _check_status("lrn_maxpool_forward", status)
    _count("lrn_maxpool_forward")
    return y
