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
  `lrn_maxpool_pallas` and `_flash_attn` / `_flash_attn_drop`;
- `lrn_forward_op` and `lrn_maxpool_forward_op` are K2 and K4 as the
  `torch.library` operators `veles::lrn_forward` and
  `veles::lrn_maxpool_forward` (the wrappers on the card, the plain
  versions on the CPU, a fake-tensor rule each), which the two LRN
  autograd functions call inside `operators_traced()`: what a
  `torch.export` program of a forward records and calls
  (serving_aot.py).

The kernels are CUDA C++ for `sm_90a` under `veles_tpu_torch/csrc/`,
each source compiled by `nvcc` into its own shared library with a plain C
interface and loaded with `ctypes` (no PyTorch headers, so a build takes
seconds). `build()` compiles at first use into `veles_tpu_torch/_build/`,
keyed by the hash of the sources, all `nvcc` processes at once.

A wrapper launches its kernel for a CUDA tensor — or raises; it never
falls back — and takes the plain version only because its tensor lies on
the CPU. Each call that launches adds one to its instance's counter in
`LAUNCHES` (K5's and K7's calls are two launches each, and each counts
once), and nothing else does. On the CPU the autograd functions run the
plain closed forms both ways — never autograd of the plain forward.

Launch shapes: K1's block (`threads`), K2's and K3's tile (`tile`) and
K4's band (`rb` x `cb`) are run-time arguments, 0 (the default) taking the
source's constant (`SGD_THREADS`, `LRN_TILE`, `LRN_POOL_BAND`): the kernel
search's axes (ops/templates.py). `lrn_rows_plan`, `lrn_maxpool_plan`
and the `*_smem_bytes` functions below mirror the sources' `plan` in
Python, byte for byte, so that the search can size and refuse a point on
the CPU; chip_smoke.py holds each mirror against the C entry of the same
name.

Device memory's dtype: K1, K6 and K7 take f32. K2–K5 take f32 or bf16
(the JAX kernels' io_dtype="native" under a bf16 step): each source has
a second C entry `*_bf16`, an instance that loads bf16, computes in f32
as the f32 instance does, and rounds each output once; its launches
count under `<kernel>_bf16`, the f32 instance's under `<kernel>`. Any
other dtype raises on the card. `FlashAttentionFunction` casts bf16 q, k
and v to f32 around K6 and K7, as `flash_attention_pallas` does.
"""

from __future__ import annotations

import contextlib
import ctypes
import fcntl
import hashlib
import math
import os
import shutil
import subprocess
import threading
from pathlib import Path
from typing import Dict, List, Optional, Tuple

import torch

from veles_tpu_torch.ops import functional as fn
from veles_tpu_torch.ops.attention import NEG_INF

_PKG = Path(__file__).resolve().parent.parent
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG / "_build"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC")

#: kernel name -> its source under csrc/ and its (f32) C entry point
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

#: the kernels with a bf16 instance: K2-K5
BF16_KERNELS = ("lrn_forward", "lrn_backward", "lrn_maxpool_forward",
                "lrn_maxpool_backward")
#: kernel instance -> (its kernel, its C entry point): each kernel's f32
#: instance under the kernel's name, the bf16 ones under `<kernel>_bf16`
INSTANCES: Dict[str, Tuple[str, str]] = {
    **{name: (name, entry) for name, (_, entry) in KERNELS.items()},
    **{f"{name}_bf16": (name, f"{name}_bf16") for name in BF16_KERNELS}}

#: kernel instance -> launches since the last reset_launch_counts()
LAUNCHES: Dict[str, int] = {name: 0 for name in INSTANCES}
_count_lock = threading.Lock()

_libs: Dict[str, ctypes.CDLL] = {}
_lib_paths: Dict[str, Path] = {}
_build_lock = threading.Lock()
#: what build() has done in this process: `nvcc` processes run and
#: kernel libraries loaded (what a server's start cost; serving.py)
_BUILDS: Dict[str, int] = {"nvcc": 0, "loads": 0}


def reset_launch_counts() -> None:
    with _count_lock:
        for name in LAUNCHES:
            LAUNCHES[name] = 0


def launch_counts() -> Dict[str, int]:
    with _count_lock:
        return dict(LAUNCHES)


def build_counts() -> Dict[str, int]:
    """`nvcc` runs and library loads by build() in this process."""
    with _build_lock:
        return dict(_BUILDS)


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
                    _BUILDS["nvcc"] += 1
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
            _libs[name] = ctypes.CDLL(str(out))
            _BUILDS["loads"] += 1
        for kernel, entry in INSTANCES.values():
            _declare(_libs[kernel], entry)
        _lib_paths.update(outs)
        return outs


_P = ctypes.c_void_p
_I = ctypes.c_int
_L = ctypes.c_int64
_F = ctypes.c_float
_ARGTYPES = {
    # p, g, v, n, lr, momentum, weight_decay, threads, stream
    "sgd_update_f32": [_P, _P, _P, _L, _F, _F, _F, _I, _P],
    # x, y, rows, C, half, k, alpha, q, beta, generic, tile, stream
    "lrn_forward_f32": [_P, _P, _L, _I, _I, _F, _F, _I, _F, _I, _I, _P],
    # x, g, dx, rows, C, half, k, alpha, q, beta, c2, generic, tile, stream
    "lrn_backward_f32": [_P, _P, _P, _L, _I, _I, _F, _F, _I, _F, _F, _I,
                         _I, _P],
    # x, y, n, H, W, C, OH, OW, ky, kx, sy, sx, half, k, alpha, q, beta,
    # generic, rb, cb, stream
    "lrn_maxpool_forward_f32": [_P, _P, _L, _I, _I, _I, _I, _I, _I, _I,
                                _I, _I, _I, _F, _F, _I, _F, _I, _I, _I,
                                _P],
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
# the bf16 instances take the f32 ones' arguments
_ARGTYPES.update({f"{name}_bf16": _ARGTYPES[f"{name}_f32"]
                  for name in BF16_KERNELS})


def _declare(lib: ctypes.CDLL, symbol: str) -> None:
    f = getattr(lib, symbol)
    f.argtypes = _ARGTYPES[symbol]
    f.restype = ctypes.c_int


def _entry(instance: str):
    kernel, entry = INSTANCES[instance]
    if kernel not in _libs:
        build()
    return getattr(_libs[kernel], entry)


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


#: device memory's dtype -> the suffix of the LRN kernels' instance
_LRN_DTYPES = {torch.float32: "", torch.bfloat16: "_bf16"}


def _check_lrn_args(x: torch.Tensor, n: int, ndim: int) -> str:
    """Checks an LRN kernel's x; returns the suffix of the kernel's
    instance that takes x's dtype ("" for f32, "_bf16"; any other dtype
    raises)."""
    if x.dtype not in _LRN_DTYPES:
        raise TypeError(f"kernel takes float32 or bfloat16, got {x.dtype}")
    if x.dim() != ndim:
        raise ValueError(f"expected a {ndim}-d NHWC tensor, got shape "
                         f"{tuple(x.shape)}")
    if not x.is_contiguous():
        raise ValueError("kernel takes a contiguous (NHWC) tensor")
    if n % 2 == 0 or n < 1:
        raise ValueError(f"LRN window n must be odd, got {n}")
    return _LRN_DTYPES[x.dtype]


def _check_like(name: str, t: torch.Tensor, shape, ref: torch.Tensor):
    """`t` on `ref`'s device in `ref`'s dtype with `shape`; returns it
    contiguous (an incoming gradient may be a permuted view)."""
    if t.device != ref.device or t.dtype != ref.dtype:
        raise TypeError(f"{name}: expected {ref.dtype} on {ref.device}, "
                        f"got {t.dtype} on {t.device}")
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
# launch shapes: the sources' constants and their plans, mirrored
# ---------------------------------------------------------------------------

#: K1's threads a block (sgd_update.cu kThreads)
SGD_THREADS = 256
#: K2's and K3's own elements of a tile at most (kTile of both sources)
LRN_TILE = 3072
#: K4's band: pooled rows x pooled columns at most (kRB, kCB)
LRN_POOL_BAND = (3, 16)
#: dynamic shared memory a K2, K3 or K4 block takes at most (kSmemMax),
#: and the grid's y extent K2 and K3 cut a row into (kMaxGridY)
_LRN_SMEM_MAX = 48 * 1024
_MAX_GRID_Y = 65535
#: K4's channels a block (kCT) and the largest grid extent (INT_MAX)
_POOL_CT = 32
_INT_MAX = 2 ** 31 - 1


def check_launch(threads: int = 0, tile: int = 0, rb: int = 0,
                 cb: int = 0) -> None:
    """Refuses, on either device, a launch argument no source takes: K1's
    threads a multiple of 32 up to 1024, K2's and K3's tile a multiple of
    4, K4's band not negative (0 everywhere: the source's constant)."""
    if threads and (threads < 32 or threads > 1024 or threads % 32):
        raise ValueError(f"threads {threads}: a multiple of 32 up to 1024")
    if tile and (tile < 4 or tile % 4):
        raise ValueError(f"tile {tile}: a multiple of 4")
    if rb < 0 or cb < 0:
        raise ValueError(f"band {rb} x {cb}: not negative")


def lrn_rows_plan(c: int, half: int, tile: int = 0,
                  backward: bool = False) -> Optional[Tuple[int, int, int]]:
    """(rb rows, ct channels of a tile, shared-memory bytes of a block) of
    K2 (`backward` False: lrn_forward.cu `plan`) or K3 (True:
    lrn_backward.cu `plan`) for C-wide rows under a window of 2*half + 1
    channels and tiles of `tile` own elements (0: LRN_TILE); None where
    the source refuses the geometry."""
    t = tile or LRN_TILE
    if c < 1 or half < 0 or t < 4 or t % 4 or half > t:
        return None
    ct = min(c, t)
    n_ct = -(-c // ct)
    if backward:
        xp = (2 * half + 3) // 4 * 4
        row = (ct + 2 * xp + ct + ct + 2 * half) * 4
    else:
        xp = (half + 3) // 4 * 4
        row = (ct + 2 * xp) * 4
    rb = min(t // ct, _LRN_SMEM_MAX // row)
    if rb <= 0 or n_ct > _MAX_GRID_Y:
        return None
    return rb, ct, rb * row


def lrn_forward_smem_bytes(c: int, half: int, tile: int = 0) -> int:
    """lrn_forward.cu's C entry of the same name: a K2 block's dynamic
    shared memory, -1 where refused."""
    plan = lrn_rows_plan(c, half, tile)
    return -1 if plan is None else plan[2]


def lrn_backward_smem_bytes(c: int, half: int, tile: int = 0) -> int:
    """lrn_backward.cu's C entry of the same name: a K3 block's dynamic
    shared memory, -1 where refused."""
    plan = lrn_rows_plan(c, half, tile, backward=True)
    return -1 if plan is None else plan[2]


def lrn_maxpool_plan(h: int, w: int, c: int, oh: int, ow: int, ky: int,
                     kx: int, sy: int, sx: int, half: int, rb0: int = 0,
                     cb0: int = 0) -> Optional[Tuple[int, int, int]]:
    """(rb, cb, shared-memory bytes of a block) of K4's band at this
    geometry under bands of at most rb0 x cb0 pooled pixels (0:
    LRN_POOL_BAND), shrunk as lrn_maxpool_forward.cu's `plan` shrinks it;
    None where the source refuses it."""
    if rb0 < 0 or cb0 < 0:
        return None
    xw = _POOL_CT + 2 * ((half + 3) // 4 * 4)

    def smem(rb, cb):
        return min((rb - 1) * sy + ky, h) * min((cb - 1) * sx + kx, w) \
            * xw * 4

    rb = min(rb0 or LRN_POOL_BAND[0], oh)
    cb = min(cb0 or LRN_POOL_BAND[1], ow)
    while smem(rb, cb) > _LRN_SMEM_MAX and (rb > 1 or cb > 1):
        if rb > 1:
            rb -= 1
        else:
            cb = (cb + 1) // 2
    blocks = -(-oh // rb) * -(-ow // cb) * -(-c // _POOL_CT)
    if smem(rb, cb) > _LRN_SMEM_MAX or blocks > _INT_MAX:
        return None
    return rb, cb, smem(rb, cb)


def lrn_maxpool_forward_smem_bytes(h: int, w: int, c: int, oh: int, ow: int,
                                   ky: int, kx: int, sy: int, sx: int,
                                   half: int, rb0: int = 0,
                                   cb0: int = 0) -> int:
    """lrn_maxpool_forward.cu's C entry of the same name: a K4 block's
    dynamic shared memory, -1 where refused."""
    plan = lrn_maxpool_plan(h, w, c, oh, ow, ky, kx, sy, sx, half, rb0, cb0)
    return -1 if plan is None else plan[2]


def flash_attention_forward_smem_bytes(d: int) -> int:
    """A K6 block's dynamic shared memory at head width d: the streamed
    tiles (flash_common.cuh `Tiles<D>`: two raw stages of K and V, 64
    rows of d floats each, and the landed tile's TF32 hi and lo planes at
    a pitch of d + 4 words). The C entry of the same name answers only
    for the compiled widths; this gives any multiple of 8, so that the
    search can prune a width the card could not hold (-1 elsewhere)."""
    if d < 8 or d % 8:
        return -1
    return 2048 * d + 4096


def flash_attention_backward_smem_bytes(d: int) -> int:
    """A K7 block's (either launch's) dynamic shared memory at head width
    d: K6's tiles, and from d = 64 on the two resident arrays of each of
    the 4 warps that RowPlace moves there (2·(d/8)·32 16-byte words each);
    -1 where d is no multiple of 8."""
    fwd = flash_attention_forward_smem_bytes(d)
    if fwd < 0:
        return -1
    return fwd + (4 * 2 * 2 * (d // 8) * 32 * 16 if d >= 64 else 0)


# ---------------------------------------------------------------------------
# K1: SGD + momentum + L2 update of one leaf, in place
# ---------------------------------------------------------------------------


def sgd_update_plain(p: torch.Tensor, g: torch.Tensor, v: torch.Tensor,
                     lr: float, momentum: float = 0.0,
                     weight_decay: float = 0.0, threads: int = 0) -> None:
    """Plain PyTorch version of K1, in place: g' = g + wd·p;
    v ← μ·v − lr·g'; p ← p + v (each product and sum its own op).
    `threads`, K1's launch shape, changes nothing here (as for each plain
    version below: a launch shape does not change the function)."""
    reg = g + weight_decay * p
    v.copy_(momentum * v - lr * reg)
    p.add_(v)


def sgd_update(p: torch.Tensor, g: torch.Tensor, v: torch.Tensor,
               lr: float, momentum: float = 0.0,
               weight_decay: float = 0.0, threads: int = 0) -> None:
    """Update the leaf `p` and its velocity `v` in place from its
    gradient `g`: K1 for CUDA tensors, the plain version for CPU ones.
    `lr` is the leaf's own (optim.sgd_leaf_lr); `threads`, K1's block (0:
    SGD_THREADS)."""
    check_launch(threads=threads)
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
            momentum, weight_decay, threads, _stream(p))
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
                      beta: float = 0.75, n: int = 5,
                      tile: int = 0) -> torch.Tensor:
    """Plain PyTorch version of K2 (any layout whose LAST axis is C; a
    bf16 x is computed in f32 and rounded once)."""
    return fn.lrn_forward(x, k, alpha, beta, n)


def lrn_forward(x: torch.Tensor, k: float = 2.0, alpha: float = 1e-4,
                beta: float = 0.75, n: int = 5, *,
                generic: bool = False, tile: int = 0) -> torch.Tensor:
    """Across-channel LRN of an NHWC tensor: K2 for a CUDA tensor, the
    plain version for a CPU one. K2 runs AlexNet's geometry (n 5, beta
    0.75) as an instance with it compiled in, unless `generic`, which
    takes the run-time instance every other geometry takes (the same
    bits; it times what the constants buy). x is f32 or bf16, and y
    comes back in x's dtype. `tile`: K2's own elements of a tile at most
    (0: LRN_TILE)."""
    check_launch(tile=tile)
    if not _on_card("lrn_forward", x):
        return lrn_forward_plain(x, k, alpha, beta, n)
    inst = "lrn_forward" + _check_lrn_args(x, n, 4)
    c = x.shape[-1]
    rows = x.numel() // c if c else 0
    y = torch.empty_like(x)
    with torch.cuda.device(x.device):
        status = _entry(inst)(
            x.data_ptr(), y.data_ptr(), rows, c, n // 2, k, alpha,
            fn.quarter_exponent(beta), beta, int(generic), tile,
            _stream(x))
    _check_status(inst, status)
    _count(inst)
    return y


# ---------------------------------------------------------------------------
# K3: LRN backward
# ---------------------------------------------------------------------------


def lrn_backward_plain(x: torch.Tensor, g: torch.Tensor, k: float = 2.0,
                       alpha: float = 1e-4, beta: float = 0.75,
                       n: int = 5, tile: int = 0) -> torch.Tensor:
    """Plain PyTorch version of K3: the closed-form gradient."""
    return fn.lrn_backward(x, g, k, alpha, beta, n)


def lrn_backward(x: torch.Tensor, g: torch.Tensor, k: float = 2.0,
                 alpha: float = 1e-4, beta: float = 0.75, n: int = 5, *,
                 generic: bool = False, tile: int = 0) -> torch.Tensor:
    """Gradient of the LRN of NHWC `x` given the output gradient `g`: K3
    for CUDA tensors, the plain version for CPU ones. K3 runs AlexNet's
    geometry (n 5, beta 0.75) as an instance with it compiled in, unless
    `generic`, which takes the run-time instance every other geometry
    takes (the same bits; it times what the constants buy). x is f32 or
    bf16, g has x's dtype, and dx comes back in it. `tile`: K3's own
    elements of a tile at most (0: LRN_TILE)."""
    check_launch(tile=tile)
    if not _on_card("lrn_backward", x):
        return lrn_backward_plain(x, g, k, alpha, beta, n)
    inst = "lrn_backward" + _check_lrn_args(x, n, 4)
    g = _check_like("lrn_backward gradient", g, x.shape, x)
    c = x.shape[-1]
    rows = x.numel() // c if c else 0
    dx = torch.empty_like(x)
    with torch.cuda.device(x.device):
        status = _entry(inst)(
            x.data_ptr(), g.data_ptr(), dx.data_ptr(), rows, c, n // 2, k,
            alpha, fn.quarter_exponent(beta), beta, 2.0 * alpha * beta,
            int(generic), tile, _stream(x))
    _check_status(inst, status)
    _count(inst)
    return dx


# ---------------------------------------------------------------------------
# K4: fused LRN -> ceil-mode max pool forward
# ---------------------------------------------------------------------------


def lrn_maxpool_forward_plain(x: torch.Tensor, k: float = 2.0,
                              alpha: float = 1e-4, beta: float = 0.75,
                              n: int = 5, ksize=(3, 3), stride=(2, 2),
                              rb: int = 0, cb: int = 0) -> torch.Tensor:
    """Plain PyTorch version of K4: the LRN, then the ceil-mode pool."""
    return fn.maxpool_forward(fn.lrn_forward(x, k, alpha, beta, n),
                              tuple(ksize), tuple(stride))


def lrn_maxpool_forward(x: torch.Tensor, k: float = 2.0, alpha: float = 1e-4,
                        beta: float = 0.75, n: int = 5, ksize=(3, 3),
                        stride=(2, 2), *, generic: bool = False,
                        rb: int = 0, cb: int = 0) -> torch.Tensor:
    """LRN then ceil-mode max pool of an NHWC tensor, writing only the
    pooled output: K4 for a CUDA tensor, the plain version for a CPU
    one. K4 runs AlexNet's geometry (n 5, beta 0.75, 3x3/2) as an
    instance with it compiled in, unless `generic`, which takes the
    run-time instance every other geometry takes (the same bits; it
    times what the constants buy). x is f32 or bf16, and the output comes
    back in x's dtype. `rb` x `cb`: K4's band at most (0: LRN_POOL_BAND),
    shrunk by the source's plan until a block fits."""
    check_launch(rb=rb, cb=cb)
    if not _on_card("lrn_maxpool_forward", x):
        return lrn_maxpool_forward_plain(x, k, alpha, beta, n, ksize, stride)
    inst = "lrn_maxpool_forward" + _check_lrn_args(x, n, 4)
    ky, kx, sy, sx = _pool_geometry(ksize, stride)
    nb, h, w, c = x.shape
    oh, ow = fn.pool_out_hw(h, w, ky, kx, sy, sx)
    y = torch.empty((nb, oh, ow, c), dtype=x.dtype, device=x.device)
    with torch.cuda.device(x.device):
        status = _entry(inst)(
            x.data_ptr(), y.data_ptr(), nb, h, w, c, oh, ow, ky, kx, sy, sx,
            n // 2, k, alpha, fn.quarter_exponent(beta), beta, int(generic),
            rb, cb, _stream(x))
    _check_status(inst, status)
    _count(inst)
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
    geometry takes (the same bits; it times what the constants buy). x is
    f32 or bf16 (routed on its f32 LRN values), g has x's dtype, and dx
    comes back in it."""
    if not _on_card("lrn_maxpool_backward", x):
        return lrn_maxpool_backward_plain(x, g, k, alpha, beta, n, ksize,
                                          stride)
    inst = "lrn_maxpool_backward" + _check_lrn_args(x, n, 4)
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
        status = _entry(inst)(
            x.data_ptr(), g.data_ptr(), dx.data_ptr(), win.data_ptr(), nb, h,
            w, c, oh, ow, ky, kx, sy, sx, n // 2, k, alpha,
            fn.quarter_exponent(beta), beta, 2.0 * alpha * beta,
            int(generic), _stream(x))
    _check_status(inst, status)
    _count(inst)
    return dx


# ---------------------------------------------------------------------------
# K6 / K7: flash attention forward and backward, heads-first (B·H, S, D)
# ---------------------------------------------------------------------------

#: head widths K6 and K7 are compiled for: those the port's workflows run
#: (the char-transformer's 16, 32 at 2 heads and 64 at 1; the toy
#: transformer's 8); the wrappers refuse any other on the card, and a
#: configuration with another width adds its instance to both .cu switches
FLASH_HEAD_DIMS = (8, 16, 32, 64)
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


# ---------------------------------------------------------------------------
# K2 and K4 as operators of the `veles` namespace: a program traced by
# torch.export records one call of each (a ctypes call cannot be traced),
# and a loaded program calls the hand kernel through them
# ---------------------------------------------------------------------------

_tracing = threading.local()


@contextlib.contextmanager
def operators_traced():
    """While a program is traced (serving_aot.export_forward), the LRN
    autograd functions call K2 and K4 through their operators, which the
    program records. Elsewhere they call the wrappers: an operator's
    dispatch costs an eager call 20-45 host us more (op_dispatch_cost.py
    on an H100 80GB HBM3 machine), which slowed AlexNet's bf16 64-row
    ring round by 2%."""
    before = getattr(_tracing, "on", False)
    _tracing.on = True
    try:
        yield
    finally:
        _tracing.on = before


@torch.library.custom_op("veles::lrn_forward", mutates_args=(),
                         device_types="cuda")
def lrn_forward_op(x: torch.Tensor, k: float, alpha: float, beta: float,
                   n: int, tile: int) -> torch.Tensor:
    """K2 (through `lrn_forward`, which counts the launch) on the card."""
    return lrn_forward(x, k, alpha, beta, n, tile=tile)


@lrn_forward_op.register_kernel("cpu")
def _lrn_forward_op_cpu(x, k, alpha, beta, n, tile):
    return lrn_forward_plain(x, k, alpha, beta, n)


@lrn_forward_op.register_fake
def _lrn_forward_op_fake(x, k, alpha, beta, n, tile):
    return torch.empty_like(x)


@torch.library.custom_op("veles::lrn_maxpool_forward", mutates_args=(),
                         device_types="cuda")
def lrn_maxpool_forward_op(x: torch.Tensor, k: float, alpha: float,
                           beta: float, n: int, ksize: List[int],
                           stride: List[int], rb: int,
                           cb: int) -> torch.Tensor:
    """K4 (through `lrn_maxpool_forward`, which counts the launch) on the
    card."""
    return lrn_maxpool_forward(x, k, alpha, beta, n, ksize, stride,
                               rb=rb, cb=cb)


@lrn_maxpool_forward_op.register_kernel("cpu")
def _lrn_maxpool_forward_op_cpu(x, k, alpha, beta, n, ksize, stride, rb,
                                cb):
    return lrn_maxpool_forward_plain(x, k, alpha, beta, n, ksize, stride)


@lrn_maxpool_forward_op.register_fake
def _lrn_maxpool_forward_op_fake(x, k, alpha, beta, n, ksize, stride, rb,
                                 cb):
    nb, h, w, c = x.shape
    oh, ow = fn.pool_out_hw(h, w, *_pool_geometry(ksize, stride))
    return x.new_empty((nb, oh, ow, c))


class LRNFunction(torch.autograd.Function):
    """LRN with K2 forward and K3 backward (`lrn_pallas`'s custom VJP);
    `tile` (0: LRN_TILE) is both kernels', as the JAX `row_tile` is both
    passes'. Inside `operators_traced()` the forward calls K2 through its
    operator (`lrn_forward_op`), so that an exported program keeps it."""

    @staticmethod
    def forward(ctx, x, k, alpha, beta, n, tile=0):
        ctx.save_for_backward(x)
        ctx.hyper = (k, alpha, beta, n)
        ctx.tile = tile
        if getattr(_tracing, "on", False):
            return lrn_forward_op(x, float(k), float(alpha), float(beta),
                                  int(n), int(tile))
        return lrn_forward(x, k, alpha, beta, n, tile=tile)

    @staticmethod
    def backward(ctx, g):
        (x,) = ctx.saved_tensors
        return (lrn_backward(x, g, *ctx.hyper, tile=ctx.tile),) \
            + (None,) * 5


class LRNMaxPoolFunction(torch.autograd.Function):
    """LRN then ceil-mode max pool with K4 forward and K5 backward
    (`lrn_maxpool_pallas`'s custom VJP); `rb` x `cb` is K4's band (K5
    keeps its own). Inside `operators_traced()` the forward calls K4
    through its operator (`lrn_maxpool_forward_op`), so that an exported
    program keeps it."""

    @staticmethod
    def forward(ctx, x, k, alpha, beta, n, ksize, stride, rb=0, cb=0):
        ctx.save_for_backward(x)
        ctx.hyper = (k, alpha, beta, n, tuple(ksize), tuple(stride))
        if getattr(_tracing, "on", False):
            return lrn_maxpool_forward_op(
                x, float(k), float(alpha), float(beta), int(n),
                [int(v) for v in ksize], [int(v) for v in stride],
                int(rb), int(cb))
        return lrn_maxpool_forward(x, k, alpha, beta, n, ksize, stride,
                                   rb=rb, cb=cb)

    @staticmethod
    def backward(ctx, g):
        (x,) = ctx.saved_tensors
        return (lrn_maxpool_backward(x, g, *ctx.hyper),) + (None,) * 8


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
    D = rowsum(g⊙O) equals the unmasked rowsum(dO⊙O_unmasked).

    The kernels take f32. As `flash_attention_pallas` does, q, k, v and
    the mask are cast to f32 before K6 and O back to q's dtype; the
    backward casts g to f32 and returns each gradient in its input's
    dtype (the VJPs of those casts). Nothing is cast in an f32 step."""

    @staticmethod
    def forward(ctx, q, k, v, causal=False, scale=None, kv_order="fwd",
                mask=None):
        b, _, h, _ = q.shape
        qf, kf, vf = (_heads_first(t).to(torch.float32) for t in (q, k, v))
        mf = None if mask is None else \
            _heads_first(mask).to(torch.float32)
        out, lse = flash_attention_forward(qf, kf, vf, causal, scale,
                                           kv_order, mf)
        ctx.save_for_backward(qf, kf, vf, out, lse, mf)
        ctx.hyper = (b, h, causal, scale, q.dtype, k.dtype, v.dtype)
        return _heads_last(out, b, h).to(q.dtype)

    @staticmethod
    def backward(ctx, g):
        qf, kf, vf, out, lse, mf = ctx.saved_tensors
        b, h, causal, scale, qt, kt, vt = ctx.hyper
        gf = _heads_first(g).to(torch.float32)
        di = torch.sum(gf * out, dim=-1, keepdim=True)
        do = gf if mf is None else gf * mf
        dq, dk, dv = flash_attention_backward(qf, kf, vf, do, lse, di, causal,
                                              scale)
        return (_heads_last(dq, b, h).to(qt), _heads_last(dk, b, h).to(kt),
                _heads_last(dv, b, h).to(vt), None, None, None, None)
