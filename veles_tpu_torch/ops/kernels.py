"""The port's hand-written Hopper kernels, their wrappers, their plain
PyTorch versions, their launch counters, and the two autograd functions
that pair the LRN kernels into forward and backward.

The port's counterpart of `veles_tpu/ops/pallas_kernels.py`:

- K1 `sgd_update` replaces `_sgd_kernel` (via `sgd_update_pallas`);
- K2 `lrn_forward` replaces `_lrn_fwd_kernel` (via `lrn_forward_pallas`);
- K3 `lrn_backward` replaces `_lrn_bwd_kernel` (via `lrn_backward_pallas`);
- K4 `lrn_maxpool_forward` replaces `_lrn_pool_fwd_kernel` (via
  `lrn_maxpool_pallas`);
- K5 `lrn_maxpool_backward` replaces `_lrn_pool_bwd_kernel` (via
  `_lrn_pool_bwd_rule`);
- `LRNFunction` (K2 forward, K3 backward) and `LRNMaxPoolFunction` (K4
  forward, K5 backward) are the counterparts of the custom VJPs
  `lrn_pallas` and `lrn_maxpool_pallas`.

The kernels are CUDA C++ for `sm_90a` under `veles_tpu_torch/csrc/`,
each source compiled by `nvcc` into its own shared library with a plain C
interface and loaded with `ctypes` (no PyTorch headers, so a build takes
seconds). `build()` compiles at first use into `veles_tpu_torch/_build/`,
keyed by the hash of the sources, all `nvcc` processes at once.

A wrapper launches its kernel for a CUDA tensor — or raises; it never
falls back — and takes the plain version only because its tensor lies on
the CPU. Each call that launches adds one to the kernel's counter in
`LAUNCHES` (K5's call is three launches and counts once), and nothing
else does. On the CPU the autograd functions run the plain closed forms
both ways — never autograd of the plain forward.
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
    "sgd_update": ("sgd_update.cu", "sgd_update_f32"),
    "lrn_forward": ("lrn_forward.cu", "lrn_forward_f32"),
    "lrn_backward": ("lrn_backward.cu", "lrn_backward_f32"),
    "lrn_maxpool_forward": ("lrn_maxpool_forward.cu",
                            "lrn_maxpool_forward_f32"),
    "lrn_maxpool_backward": ("lrn_maxpool_backward.cu",
                             "lrn_maxpool_backward_f32"),
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
    # p, g, v, n, lr, momentum, weight_decay, stream
    "sgd_update_f32": [_P, _P, _P, _L, _F, _F, _F, _P],
    # x, y, rows, C, half, k, alpha, q, beta, stream
    "lrn_forward_f32": [_P, _P, _L, _I, _I, _F, _F, _I, _F, _P],
    # x, g, dx, rows, C, half, k, alpha, q, beta, c2, stream
    "lrn_backward_f32": [_P, _P, _P, _L, _I, _I, _F, _F, _I, _F, _F, _P],
    # x, y, n, H, W, C, OH, OW, ky, kx, sy, sx, half, k, alpha, q, beta,
    # stream
    "lrn_maxpool_forward_f32": [_P, _P, _L, _I, _I, _I, _I, _I, _I, _I,
                                _I, _I, _I, _F, _F, _I, _F, _P],
    # x, g, dx, win, g_lrn, n, H, W, C, OH, OW, ky, kx, sy, sx, half, k,
    # alpha, q, beta, c2, stream
    "lrn_maxpool_backward_f32": [_P, _P, _P, _P, _P, _L, _I, _I, _I, _I,
                                 _I, _I, _I, _I, _I, _I, _F, _F, _I, _F,
                                 _F, _P],
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


def _on_card(name: str, x: torch.Tensor) -> bool:
    """False for a CPU tensor (the wrapper takes the plain version), True
    for a CUDA one; any other device raises."""
    if x.device.type == "cpu":
        return False
    if x.device.type != "cuda":
        raise ValueError(f"{name} runs on cuda or cpu, not {x.device}")
    return True


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


def _check_like(name: str, t: torch.Tensor, shape, ref: torch.Tensor):
    """`t` on `ref`'s device in float32 with `shape`; returns it
    contiguous (an incoming gradient may be a permuted view)."""
    if t.device != ref.device or t.dtype != torch.float32:
        raise TypeError(f"{name}: expected float32 on {ref.device}, got "
                        f"{t.dtype} on {t.device}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name}: shape {tuple(t.shape)} != "
                         f"{tuple(shape)}")
    return t.contiguous()


def _pool_geometry(ksize, stride) -> Tuple[int, int, int, int]:
    ky, kx = (int(v) for v in ksize)
    sy, sx = (int(v) for v in stride)
    if min(ky, kx, sy, sx) < 1:
        raise ValueError(f"bad pooling geometry ksize={ksize} "
                         f"stride={stride}")
    return ky, kx, sy, sx


def _check_status(name: str, status: int) -> None:
    if status != 0:
        raise RuntimeError(f"{name} kernel launch failed: CUDA error "
                           f"{status}")


def _stream(x: torch.Tensor) -> int:
    return torch.cuda.current_stream(x.device).cuda_stream


# ---------------------------------------------------------------------------
# K1: SGD + momentum + L2 update of one leaf, in place
# ---------------------------------------------------------------------------


def sgd_update_plain(p: torch.Tensor, g: torch.Tensor, v: torch.Tensor,
                     lr: float, momentum: float = 0.0,
                     weight_decay: float = 0.0) -> None:
    """Plain PyTorch version of K1, in place: g' = g + wd·p;
    v ← μ·v − lr·g'; p ← p + v (each product and sum its own op)."""
    reg = g + weight_decay * p
    v.copy_(momentum * v - lr * reg)
    p.add_(v)


def sgd_update(p: torch.Tensor, g: torch.Tensor, v: torch.Tensor,
               lr: float, momentum: float = 0.0,
               weight_decay: float = 0.0) -> None:
    """Update the leaf `p` and its velocity `v` in place from its
    gradient `g`: K1 for CUDA tensors, the plain version for CPU ones.
    `lr` is the leaf's own (optim.sgd_leaf_lr)."""
    if not _on_card("sgd_update", p):
        sgd_update_plain(p, g, v, lr, momentum, weight_decay)
        return
    if p.dtype != torch.float32 or not p.is_contiguous():
        raise TypeError("sgd_update takes a contiguous float32 leaf")
    g = _check_like("sgd_update gradient", g, p.shape, p)
    if v.device != p.device or v.dtype != torch.float32 \
            or tuple(v.shape) != tuple(p.shape) or not v.is_contiguous():
        raise ValueError("sgd_update: the velocity must be a contiguous "
                         "float32 tensor shaped and placed like the leaf")
    with torch.cuda.device(p.device):
        status = _entry("sgd_update")(
            p.data_ptr(), g.data_ptr(), v.data_ptr(), p.numel(), lr,
            momentum, weight_decay, _stream(p))
    _check_status("sgd_update", status)
    _count("sgd_update")
    # the kernel wrote through raw pointers: bump the version counters,
    # as an in-place PyTorch op would, so that whatever is keyed on them
    # (the conv units' cached weight layouts) sees the change
    torch.autograd.graph.increment_version(p)
    torch.autograd.graph.increment_version(v)


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
    if not _on_card("lrn_forward", x):
        return lrn_forward_plain(x, k, alpha, beta, n)
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
# K3: LRN backward
# ---------------------------------------------------------------------------


def lrn_backward_plain(x: torch.Tensor, g: torch.Tensor, k: float = 2.0,
                       alpha: float = 1e-4, beta: float = 0.75,
                       n: int = 5) -> torch.Tensor:
    """Plain PyTorch version of K3: the closed-form gradient."""
    return fn.lrn_backward(x, g, k, alpha, beta, n)


def lrn_backward(x: torch.Tensor, g: torch.Tensor, k: float = 2.0,
                 alpha: float = 1e-4, beta: float = 0.75,
                 n: int = 5) -> torch.Tensor:
    """Gradient of the LRN of NHWC `x` given the output gradient `g`: K3
    for CUDA tensors, the plain version for CPU ones."""
    if not _on_card("lrn_backward", x):
        return lrn_backward_plain(x, g, k, alpha, beta, n)
    _check_lrn_args(x, n, 4)
    g = _check_like("lrn_backward gradient", g, x.shape, x)
    c = x.shape[-1]
    rows = x.numel() // c if c else 0
    dx = torch.empty_like(x)
    with torch.cuda.device(x.device):
        status = _entry("lrn_backward")(
            x.data_ptr(), g.data_ptr(), dx.data_ptr(), rows, c, n // 2, k,
            alpha, fn.quarter_exponent(beta), beta, 2.0 * alpha * beta,
            _stream(x))
    _check_status("lrn_backward", status)
    _count("lrn_backward")
    return dx


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
    if not _on_card("lrn_maxpool_forward", x):
        return lrn_maxpool_forward_plain(x, k, alpha, beta, n, ksize, stride)
    _check_lrn_args(x, n, 4)
    ky, kx, sy, sx = _pool_geometry(ksize, stride)
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


# ---------------------------------------------------------------------------
# K5: fused LRN -> ceil-mode max pool backward
# ---------------------------------------------------------------------------


def lrn_maxpool_backward_plain(x: torch.Tensor, g: torch.Tensor,
                               k: float = 2.0, alpha: float = 1e-4,
                               beta: float = 0.75, n: int = 5, ksize=(3, 3),
                               stride=(2, 2)) -> torch.Tensor:
    """Plain PyTorch version of K5: first-max routing, then the
    closed-form LRN gradient."""
    return fn.lrn_maxpool_backward(x, g, k, alpha, beta, n, tuple(ksize),
                                   tuple(stride))


def lrn_maxpool_backward(x: torch.Tensor, g: torch.Tensor, k: float = 2.0,
                         alpha: float = 1e-4, beta: float = 0.75, n: int = 5,
                         ksize=(3, 3), stride=(2, 2)) -> torch.Tensor:
    """Gradient of LRN→max pool of NHWC `x` given the pooled gradient
    `g`: K5 for CUDA tensors, the plain version for CPU ones."""
    if not _on_card("lrn_maxpool_backward", x):
        return lrn_maxpool_backward_plain(x, g, k, alpha, beta, n, ksize,
                                          stride)
    _check_lrn_args(x, n, 4)
    ky, kx, sy, sx = _pool_geometry(ksize, stride)
    if ky * kx > 254:
        raise ValueError(f"a {ky}x{kx} window has more taps than K5's "
                         f"one-byte tap record holds")
    nb, h, w, c = x.shape
    oh, ow = fn.pool_out_hw(h, w, ky, kx, sy, sx)
    g = _check_like("lrn_maxpool_backward gradient", g, (nb, oh, ow, c), x)
    dx = torch.empty_like(x)
    win = torch.empty((nb, oh, ow, c), dtype=torch.uint8, device=x.device)
    g_lrn = torch.empty_like(x)
    with torch.cuda.device(x.device):
        status = _entry("lrn_maxpool_backward")(
            x.data_ptr(), g.data_ptr(), dx.data_ptr(), win.data_ptr(),
            g_lrn.data_ptr(), nb, h, w, c, oh, ow, ky, kx, sy, sx, n // 2, k,
            alpha, fn.quarter_exponent(beta), beta, 2.0 * alpha * beta,
            _stream(x))
    _check_status("lrn_maxpool_backward", status)
    _count("lrn_maxpool_backward")
    return dx


# ---------------------------------------------------------------------------
# the custom VJPs: forward kernel, backward kernel, x saved
# ---------------------------------------------------------------------------


class LRNFunction(torch.autograd.Function):
    """LRN with K2 forward and K3 backward (`lrn_pallas`'s custom VJP)."""

    @staticmethod
    def forward(ctx, x, k, alpha, beta, n):
        ctx.save_for_backward(x)
        ctx.hyper = (k, alpha, beta, n)
        return lrn_forward(x, k, alpha, beta, n)

    @staticmethod
    def backward(ctx, g):
        (x,) = ctx.saved_tensors
        return (lrn_backward(x, g, *ctx.hyper),) + (None,) * 4


class LRNMaxPoolFunction(torch.autograd.Function):
    """LRN then ceil-mode max pool with K4 forward and K5 backward
    (`lrn_maxpool_pallas`'s custom VJP)."""

    @staticmethod
    def forward(ctx, x, k, alpha, beta, n, ksize, stride):
        ctx.save_for_backward(x)
        ctx.hyper = (k, alpha, beta, n, tuple(ksize), tuple(stride))
        return lrn_maxpool_forward(x, k, alpha, beta, n, ksize, stride)

    @staticmethod
    def backward(ctx, g):
        (x,) = ctx.saved_tensors
        return (lrn_maxpool_backward(x, g, *ctx.hyper),) + (None,) * 6
