"""The port's hand-written Hopper kernels, their wrappers, their plain
PyTorch versions, their launch counters, and the three autograd
functions that pair them into forward and backward.

The port's counterpart of `veles_tpu/ops/pallas_kernels.py`:

- K1 `sgd_update` replaces `_sgd_kernel` (via `sgd_update_pallas`);
- K2 `lrn_forward` replaces `_lrn_fwd_kernel` (via `lrn_forward_pallas`);
- K3 `lrn_backward` replaces `_lrn_bwd_kernel` (via `lrn_backward_pallas`);
- K4 `lrn_maxpool_forward` replaces `_lrn_pool_fwd_kernel` (via
  `lrn_maxpool_pallas`);
- K5 `lrn_maxpool_backward` replaces `_lrn_pool_bwd_kernel` (via
  `_lrn_pool_bwd_rule`);
- K6 `flash_attention_forward` replaces `_flash_kernel` (via
  `_flash_fwd_core` / `flash_attention_pallas`);
- K7 `flash_attention_backward` replaces `_flash_dq_kernel` and
  `_flash_dkv_kernel` (via `_flash_bwd_pallas`);
- `LRNFunction` (K2 forward, K3 backward), `LRNMaxPoolFunction` (K4
  forward, K5 backward) and `FlashAttentionFunction` (K6 forward, K7
  backward) are the counterparts of the custom VJPs `lrn_pallas`,
  `lrn_maxpool_pallas` and `_flash_attn` / `_flash_attn_drop`.

The kernels are CUDA C++ for `sm_90a` under `veles_tpu_torch/csrc/`,
each source compiled by `nvcc` into its own shared library with a plain C
interface and loaded with `ctypes` (no PyTorch headers, so a build takes
seconds). `build()` compiles at first use into `veles_tpu_torch/_build/`,
keyed by the hash of the sources, all `nvcc` processes at once.

A wrapper launches its kernel for a CUDA tensor — or raises; it never
falls back — and takes the plain version only because its tensor lies on
the CPU. Each call that launches adds one to the kernel's counter in
`LAUNCHES` (K5's and K7's calls are two launches each, and each counts
once), and nothing else does. On the CPU the autograd functions run the
plain closed forms both ways — never autograd of the plain forward.
"""

from __future__ import annotations

import ctypes
import fcntl
import hashlib
import math
import os
import shutil
import subprocess
import threading
from pathlib import Path
from typing import Dict, Tuple

import torch

from veles_tpu_torch.ops import functional as fn
from veles_tpu_torch.ops.attention import NEG_INF

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
    "flash_attention_forward": ("flash_attention_forward.cu",
                                "flash_attention_forward_f32"),
    "flash_attention_backward": ("flash_attention_backward.cu",
                                 "flash_attention_backward_f32"),
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
    # x, y, rows, C, half, k, alpha, q, beta, generic, stream
    "lrn_forward_f32": [_P, _P, _L, _I, _I, _F, _F, _I, _F, _I, _P],
    # x, g, dx, rows, C, half, k, alpha, q, beta, c2, generic, stream
    "lrn_backward_f32": [_P, _P, _P, _L, _I, _I, _F, _F, _I, _F, _F, _I,
                         _P],
    # x, y, n, H, W, C, OH, OW, ky, kx, sy, sx, half, k, alpha, q, beta,
    # generic, stream
    "lrn_maxpool_forward_f32": [_P, _P, _L, _I, _I, _I, _I, _I, _I, _I,
                                _I, _I, _I, _F, _F, _I, _F, _I, _P],
    # x, g, dx, win, n, H, W, C, OH, OW, ky, kx, sy, sx, half, k, alpha,
    # q, beta, c2, generic, stream
    "lrn_maxpool_backward_f32": [_P, _P, _P, _P, _L, _I, _I, _I, _I, _I,
                                 _I, _I, _I, _I, _I, _F, _F, _I, _F, _F,
                                 _I, _P],
    # q, k, v, mask, o, lse, bh, s, d, scale, causal, reverse_kv, stream
    "flash_attention_forward_f32": [_P, _P, _P, _P, _P, _P, _L, _L, _I, _F,
                                    _I, _I, _P],
    # q, k, v, dout, lse, di, dq, dk, dv, bh, s, d, scale, causal, stream
    "flash_attention_backward_f32": [_P, _P, _P, _P, _P, _P, _P, _P, _P, _L,
                                     _L, _I, _F, _I, _P],
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
                beta: float = 0.75, n: int = 5, *,
                generic: bool = False) -> torch.Tensor:
    """Across-channel LRN of an NHWC tensor: K2 for a CUDA tensor, the
    plain version for a CPU one. K2 runs AlexNet's geometry (n 5, beta
    0.75) as an instance with it compiled in, unless `generic`, which
    takes the run-time instance every other geometry takes (the same
    bits; it times what the constants buy)."""
    if not _on_card("lrn_forward", x):
        return lrn_forward_plain(x, k, alpha, beta, n)
    _check_lrn_args(x, n, 4)
    c = x.shape[-1]
    rows = x.numel() // c if c else 0
    y = torch.empty_like(x)
    with torch.cuda.device(x.device):
        status = _entry("lrn_forward")(
            x.data_ptr(), y.data_ptr(), rows, c, n // 2, k, alpha,
            fn.quarter_exponent(beta), beta, int(generic), _stream(x))
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
                 alpha: float = 1e-4, beta: float = 0.75, n: int = 5, *,
                 generic: bool = False) -> torch.Tensor:
    """Gradient of the LRN of NHWC `x` given the output gradient `g`: K3
    for CUDA tensors, the plain version for CPU ones. K3 runs AlexNet's
    geometry (n 5, beta 0.75) as an instance with it compiled in, unless
    `generic`, which takes the run-time instance every other geometry
    takes (the same bits; it times what the constants buy)."""
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
            int(generic), _stream(x))
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
                        stride=(2, 2), *,
                        generic: bool = False) -> torch.Tensor:
    """LRN then ceil-mode max pool of an NHWC tensor, writing only the
    pooled output: K4 for a CUDA tensor, the plain version for a CPU
    one. K4 runs AlexNet's geometry (n 5, beta 0.75, 3x3/2) as an
    instance with it compiled in, unless `generic`, which takes the
    run-time instance every other geometry takes (the same bits; it
    times what the constants buy)."""
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
            n // 2, k, alpha, fn.quarter_exponent(beta), beta, int(generic),
            _stream(x))
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
                         ksize=(3, 3), stride=(2, 2), *,
                         generic: bool = False) -> torch.Tensor:
    """Gradient of LRN→max pool of NHWC `x` given the pooled gradient
    `g`: K5 (a route launch, then a gather and LRN-backward launch) for
    CUDA tensors, the plain version for CPU ones. K5 runs AlexNet's
    geometry (n 5, beta 0.75, 3x3/2) as an instance with it compiled in,
    unless `generic`, which takes the run-time instance every other
    geometry takes (the same bits; it times what the constants buy)."""
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
    with torch.cuda.device(x.device):
        status = _entry("lrn_maxpool_backward")(
            x.data_ptr(), g.data_ptr(), dx.data_ptr(), win.data_ptr(), nb, h,
            w, c, oh, ow, ky, kx, sy, sx, n // 2, k, alpha,
            fn.quarter_exponent(beta), beta, 2.0 * alpha * beta,
            int(generic), _stream(x))
    _check_status("lrn_maxpool_backward", status)
    _count("lrn_maxpool_backward")
    return dx


# ---------------------------------------------------------------------------
# K6 / K7: flash attention forward and backward, heads-first (B·H, S, D)
# ---------------------------------------------------------------------------

#: head widths K6 and K7 are compiled for: those the port's workflows run
#: (the char-transformer's 16, or 32 at 2 heads; the toy transformer's 8);
#: the wrappers refuse any other on the card, and a configuration with
#: another width adds its instance to both .cu switches
FLASH_HEAD_DIMS = (8, 16, 32)
KV_ORDERS = ("fwd", "rev")
#: score elements the plain versions hold at once (2^26 f32 = 256 MB): at
#: S = 4096 four heads, never the whole (B·H, S, S) tensor
_PLAIN_CHUNK_ELEMENTS = 1 << 26


def _flash_scale(d: int, scale) -> float:
    return 1.0 / math.sqrt(d) if scale is None else float(scale)


def _plain_chunks(bh: int, s: int):
    step = max(1, _PLAIN_CHUNK_ELEMENTS // max(s * s, 1))
    return [(lo, min(lo + step, bh)) for lo in range(0, bh, step)]


def _masked_scores(qc, kc, scale: float, causal: bool):
    """(q·kᵀ)·scale of one chunk of rows, −1e30 above the diagonal under
    causal masking (the JAX kernels' NEG_INF)."""
    sc = torch.matmul(qc, kc.transpose(1, 2)) * scale
    if causal:
        s = sc.shape[-1]
        keep = torch.ones(s, s, dtype=torch.bool, device=sc.device).tril()
        sc = torch.where(keep, sc, torch.full((), NEG_INF, dtype=sc.dtype,
                                              device=sc.device))
    return sc


def flash_attention_forward_plain(qf: torch.Tensor, kf: torch.Tensor,
                                  vf: torch.Tensor, causal: bool = False,
                                  scale=None, kv_order: str = "fwd",
                                  mask=None):
    """Plain PyTorch version of K6 on heads-first (B·H, S, D) tensors:
    (O, lse (B·H, S, 1)) from the materialised masked softmax, a chunk of
    rows at a time. O = softmax(s)·V (times the pre-scaled `mask` when
    given), lse = logsumexp(s). `kv_order` changes only the kernel's
    summation order, so it does not enter here."""
    if kv_order not in KV_ORDERS:
        raise ValueError(f"kv_order must be one of {KV_ORDERS}, got "
                         f"{kv_order!r}")
    bh, s, d = qf.shape
    scale = _flash_scale(d, scale)
    out = torch.empty_like(qf)
    lse = torch.empty((bh, s, 1), dtype=qf.dtype, device=qf.device)
    for lo, hi in _plain_chunks(bh, s):
        sc = _masked_scores(qf[lo:hi], kf[lo:hi], scale, causal)
        lse[lo:hi] = torch.logsumexp(sc, dim=-1, keepdim=True)
        o = torch.matmul(torch.exp(sc - lse[lo:hi]), vf[lo:hi])
        out[lo:hi] = o if mask is None else o * mask[lo:hi]
    return out, lse


def flash_attention_backward_plain(qf: torch.Tensor, kf: torch.Tensor,
                                   vf: torch.Tensor, do: torch.Tensor,
                                   lse: torch.Tensor, di: torch.Tensor,
                                   causal: bool = False, scale=None):
    """Plain PyTorch version of K7 on heads-first tensors: (dQ, dK, dV)
    from P = exp(s − lse), dS = P ⊙ (dO·Vᵀ − D)·scale, dQ = dS·K,
    dV = Pᵀ·dO, dK = dSᵀ·Q (`_flash_bwd_pallas`'s formulas), a chunk of
    rows at a time. `lse` and `di` are (B·H, S, 1)."""
    bh, s, d = qf.shape
    scale = _flash_scale(d, scale)
    dq, dk, dv = (torch.empty_like(qf) for _ in range(3))
    for lo, hi in _plain_chunks(bh, s):
        qc, kc, vc, doc = qf[lo:hi], kf[lo:hi], vf[lo:hi], do[lo:hi]
        p = torch.exp(_masked_scores(qc, kc, scale, causal) - lse[lo:hi])
        dv[lo:hi] = torch.matmul(p.transpose(1, 2), doc)
        dp = torch.matmul(doc, vc.transpose(1, 2))
        ds = p * (dp - di[lo:hi]) * scale
        dq[lo:hi] = torch.matmul(ds, kc)
        dk[lo:hi] = torch.matmul(ds.transpose(1, 2), qc)
    return dq, dk, dv


def _check_flash(name: str, ref: torch.Tensor, **tensors) -> None:
    if ref.dtype != torch.float32 or ref.dim() != 3:
        raise TypeError(f"{name} takes (B·H, S, D) float32 tensors, got "
                        f"{ref.dtype} {tuple(ref.shape)}")
    if ref.shape[-1] not in FLASH_HEAD_DIMS:
        raise ValueError(f"{name} is compiled for head widths "
                         f"{FLASH_HEAD_DIMS}, got {ref.shape[-1]}")
    for what, t in tensors.items():
        if t.device != ref.device or t.dtype != torch.float32:
            raise TypeError(f"{name}: {what} must be float32 on "
                            f"{ref.device}, got {t.dtype} on {t.device}")


def _kernel_operand(name: str, t: torch.Tensor, shape) -> torch.Tensor:
    """`t` contiguous with `shape`, its data 16-byte aligned (the kernels
    move rows as float4)."""
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name}: shape {tuple(t.shape)} != "
                         f"{tuple(shape)}")
    t = t.contiguous()
    return t if t.data_ptr() % 16 == 0 else t.clone()


def flash_attention_forward(qf: torch.Tensor, kf: torch.Tensor,
                            vf: torch.Tensor, causal: bool = False,
                            scale=None, kv_order: str = "fwd", mask=None):
    """Blocked attention of heads-first (B·H, S, D) f32 tensors: K6 for
    CUDA tensors, the plain version for CPU ones. Returns (O, lse) with
    lse (B·H, S, 1), as `_flash_fwd_core` does. `mask` (B·H, S, D),
    pre-scaled 0 or 1/keep, multiplies O in the kernel's final write."""
    if not _on_card("flash_attention_forward", qf):
        return flash_attention_forward_plain(qf, kf, vf, causal, scale,
                                             kv_order, mask)
    if kv_order not in KV_ORDERS:
        raise ValueError(f"kv_order must be one of {KV_ORDERS}, got "
                         f"{kv_order!r}")
    extra = {"k": kf, "v": vf}
    if mask is not None:
        extra["mask"] = mask
    _check_flash("flash_attention_forward", qf, **extra)
    bh, s, d = qf.shape
    q, k, v = (_kernel_operand(n, t, qf.shape)
               for n, t in (("q", qf), ("k", kf), ("v", vf)))
    m = None if mask is None else _kernel_operand("mask", mask, qf.shape)
    out = torch.empty_like(q)
    lse = torch.empty((bh, s, 1), dtype=q.dtype, device=q.device)
    with torch.cuda.device(q.device):
        status = _entry("flash_attention_forward")(
            q.data_ptr(), k.data_ptr(), v.data_ptr(),
            None if m is None else m.data_ptr(), out.data_ptr(),
            lse.data_ptr(), bh, s, d, _flash_scale(d, scale), int(causal),
            int(kv_order == "rev"), _stream(q))
    _check_status("flash_attention_forward", status)
    _count("flash_attention_forward")
    return out, lse


def flash_attention_backward(qf: torch.Tensor, kf: torch.Tensor,
                             vf: torch.Tensor, do: torch.Tensor,
                             lse: torch.Tensor, di: torch.Tensor,
                             causal: bool = False, scale=None):
    """(dQ, dK, dV) of blocked attention from the forward's inputs, the
    output gradient `do`, the saved `lse` and D = rowsum(dO⊙O) `di` (both
    (B·H, S, 1)): K7 (a dQ launch, then a dK/dV launch) for CUDA tensors,
    the plain version for CPU ones."""
    if not _on_card("flash_attention_backward", qf):
        return flash_attention_backward_plain(qf, kf, vf, do, lse, di,
                                              causal, scale)
    _check_flash("flash_attention_backward", qf, k=kf, v=vf, do=do, lse=lse,
                 di=di)
    bh, s, d = qf.shape
    q, k, v, g = (_kernel_operand(n, t, qf.shape)
                  for n, t in (("q", qf), ("k", kf), ("v", vf), ("do", do)))
    lse = _kernel_operand("lse", lse, (bh, s, 1))
    di = _kernel_operand("di", di, (bh, s, 1))
    dq, dk, dv = (torch.empty_like(q) for _ in range(3))
    with torch.cuda.device(q.device):
        status = _entry("flash_attention_backward")(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), g.data_ptr(),
            lse.data_ptr(), di.data_ptr(), dq.data_ptr(), dk.data_ptr(),
            dv.data_ptr(), bh, s, d, _flash_scale(d, scale), int(causal),
            _stream(q))
    _check_status("flash_attention_backward", status)
    _count("flash_attention_backward")
    return dq, dk, dv


# ---------------------------------------------------------------------------
# the custom VJPs: forward kernel, backward kernel, inputs saved
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


def _heads_first(x: torch.Tensor) -> torch.Tensor:
    """(B, S, H, D) -> a contiguous heads-first (B·H, S, D) copy."""
    b, s, h, d = x.shape
    return x.permute(0, 2, 1, 3).reshape(b * h, s, d)


def _heads_last(x: torch.Tensor, b: int, h: int) -> torch.Tensor:
    """(B·H, S, D) -> a (B, S, H, D) view."""
    _, s, d = x.shape
    return x.reshape(b, h, s, d).permute(0, 2, 1, 3)


class FlashAttentionFunction(torch.autograd.Function):
    """Blocked attention of (B, S, H, D) q, k, v -> (B, S, H, D) with K6
    forward and K7 backward: `flash_attention_pallas`'s counterpart (the
    custom VJPs `_flash_attn` and, with a dropout `mask` of (B, S, H, D),
    pre-scaled 0 or 1/keep, `_flash_attn_drop`). Arguments after v:
    causal, scale (None: 1/√D), kv_order, mask. The forward saves the
    heads-first inputs, O and the row logsumexp; the backward takes
    D = rowsum(dO⊙O) here with torch, as the JAX package leaves it to XLA.
    With a mask the saved O is the masked output, dO = g⊙mask, and
    D = rowsum(g⊙O) equals the unmasked rowsum(dO⊙O_unmasked)."""

    @staticmethod
    def forward(ctx, q, k, v, causal=False, scale=None, kv_order="fwd",
                mask=None):
        b, _, h, _ = q.shape
        qf, kf, vf = _heads_first(q), _heads_first(k), _heads_first(v)
        mf = None if mask is None else _heads_first(mask)
        out, lse = flash_attention_forward(qf, kf, vf, causal, scale,
                                           kv_order, mf)
        ctx.save_for_backward(qf, kf, vf, out, lse, mf)
        ctx.hyper = (b, h, causal, scale)
        return _heads_last(out, b, h)

    @staticmethod
    def backward(ctx, g):
        qf, kf, vf, out, lse, mf = ctx.saved_tensors
        b, h, causal, scale = ctx.hyper
        gf = _heads_first(g)
        di = torch.sum(gf * out, dim=-1, keepdim=True)
        do = gf if mf is None else gf * mf
        dq, dk, dv = flash_attention_backward(qf, kf, vf, do, lse, di, causal,
                                              scale)
        return (_heads_last(dq, b, h), _heads_last(dk, b, h),
                _heads_last(dv, b, h), None, None, None, None)
