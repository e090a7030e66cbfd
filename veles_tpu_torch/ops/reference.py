"""Golden NumPy implementations of every znicz op (forward and backward).

The port's own copy of `veles_tpu/ops/reference.py`, value for value: the
numpy backend of the granular units (`numpy_run`) computes with it, so a
`-b numpy` run of the port gives the JAX package's numpy run bit for bit,
and the tests hold the port's torch paths against it. Parity: the
reference's NumPy backend (`numpy_run` methods across `veles/znicz/*.py`)
— the bit-authoritative model its OpenCL/CUDA kernels were tested
against.

Activation semantics follow the reference:
- "tanh" is the scaled LeCun tanh  y = 1.7159·tanh(0.6666·x)
  (reference `All2AllTanh`/`ConvTanh`);
- "relu" is the reference's smooth RELU  y = ln(1+eˣ) (softplus)
  (reference `All2AllRELU`);
- "strictrelu" is max(x, 0) (reference `All2AllStrictRELU`/`ConvStrictRELU`).
Backward derivatives are expressed in terms of the *output* y where the
reference did so (tanh/sigmoid/relu), keeping its memory model (no need to
retain pre-activations).
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np

# ---------------------------------------------------------------------------
# activations
# ---------------------------------------------------------------------------

TANH_A = 1.7159
TANH_B = 0.6666


def act_forward(name: str, x: np.ndarray) -> np.ndarray:
    if name == "linear":
        return x
    if name == "tanh":
        return TANH_A * np.tanh(TANH_B * x)
    if name == "relu":  # reference RELU = softplus
        return np.logaddexp(x, 0.0)
    if name == "strictrelu":
        return np.maximum(x, 0.0)
    if name == "sigmoid":
        return 1.0 / (1.0 + np.exp(-x))
    if name == "log":  # reference Log activation: asinh
        return np.arcsinh(x)
    raise ValueError(f"unknown activation {name!r}")


def act_backward(name: str, y: np.ndarray, err: np.ndarray,
                 x: Optional[np.ndarray] = None) -> np.ndarray:
    """dL/dx given dL/dy (=err) and the forward output y (input x only for
    activations whose derivative needs it)."""
    if name == "linear":
        return err
    if name == "tanh":
        return err * (TANH_B * (TANH_A - y * y / TANH_A))
    if name == "relu":
        return err * (1.0 - np.exp(-y))
    if name == "strictrelu":
        return err * (y > 0)
    if name == "sigmoid":
        return err * y * (1.0 - y)
    if name == "log":
        assert x is not None
        return err / np.sqrt(x * x + 1.0)
    raise ValueError(f"unknown activation {name!r}")


# ---------------------------------------------------------------------------
# fully connected (parity: veles/znicz/all2all.py + gd.py)
# ---------------------------------------------------------------------------

def all2all_forward(x: np.ndarray, w: np.ndarray, b: np.ndarray,
                    activation: str = "linear") -> np.ndarray:
    """y = act(x @ W + b); x: (N, in), W: (in, out), b: (out,)."""
    x2 = x.reshape(x.shape[0], -1)
    return act_forward(activation, x2 @ w + b)


def all2all_backward(x: np.ndarray, w: np.ndarray, y: np.ndarray,
                     err_y: np.ndarray, activation: str = "linear"
                     ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Returns (err_x, dW, db) — parity: GradientDescent.numpy_run."""
    x2 = x.reshape(x.shape[0], -1)
    pre_err = act_backward(activation, y, err_y)
    dw = x2.T @ pre_err
    db = pre_err.sum(axis=0)
    err_x = (pre_err @ w.T).reshape(x.shape)
    return err_x, dw, db


def softmax(x: np.ndarray) -> np.ndarray:
    """Max-subtracted softmax (parity: All2AllSoftmax fused max-subtract)."""
    e = np.exp(x - x.max(axis=-1, keepdims=True))
    return e / e.sum(axis=-1, keepdims=True)


# ---------------------------------------------------------------------------
# convolution (parity: veles/znicz/conv.py + gd_conv.py) — NHWC / HWIO
# ---------------------------------------------------------------------------

def _im2col(x: np.ndarray, kh: int, kw: int, sy: int, sx: int,
            ph: int, pw: int) -> Tuple[np.ndarray, int, int]:
    n, h, w, c = x.shape
    xp = np.pad(x, ((0, 0), (ph, ph), (pw, pw), (0, 0)))
    oh = (h + 2 * ph - kh) // sy + 1
    ow = (w + 2 * pw - kw) // sx + 1
    cols = np.zeros((n, oh, ow, kh, kw, c), x.dtype)
    for i in range(kh):
        for j in range(kw):
            cols[:, :, :, i, j, :] = xp[:, i:i + oh * sy:sy, j:j + ow * sx:sx, :]
    return cols, oh, ow


def conv2d_forward(x: np.ndarray, w: np.ndarray, b: np.ndarray,
                   stride: Tuple[int, int] = (1, 1),
                   padding: Tuple[int, int] = (0, 0),
                   activation: str = "linear") -> np.ndarray:
    """x: (N,H,W,C), w: (kh,kw,C,OC), b: (OC,) -> (N,OH,OW,OC)."""
    kh, kw, _, oc = w.shape
    cols, oh, ow = _im2col(x, kh, kw, *stride, *padding)
    y = np.tensordot(cols, w, axes=([3, 4, 5], [0, 1, 2])) + b
    return act_forward(activation, y)


def conv2d_backward(x: np.ndarray, w: np.ndarray, y: np.ndarray,
                    err_y: np.ndarray,
                    stride: Tuple[int, int] = (1, 1),
                    padding: Tuple[int, int] = (0, 0),
                    activation: str = "linear"
                    ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Returns (err_x, dW, db) — parity: GradientDescentConv."""
    n, h, wid, c = x.shape
    kh, kw, _, oc = w.shape
    sy, sx = stride
    ph, pw = padding
    pre_err = act_backward(activation, y, err_y)  # (N,OH,OW,OC)
    cols, oh, ow = _im2col(x, kh, kw, sy, sx, ph, pw)
    dw = np.tensordot(cols, pre_err, axes=([0, 1, 2], [0, 1, 2]))
    db = pre_err.sum(axis=(0, 1, 2))
    # scatter err back through im2col (col2im)
    dcols = np.tensordot(pre_err, w, axes=([3], [3]))  # (N,OH,OW,kh,kw,C)
    err_xp = np.zeros((n, h + 2 * ph, wid + 2 * pw, c), x.dtype)
    for i in range(kh):
        for j in range(kw):
            err_xp[:, i:i + oh * sy:sy, j:j + ow * sx:sx, :] += \
                dcols[:, :, :, i, j, :]
    err_x = err_xp[:, ph:ph + h, pw:pw + wid, :]
    return err_x, dw, db


def deconv2d_forward(x: np.ndarray, w: np.ndarray,
                     stride: Tuple[int, int] = (1, 1),
                     padding: Tuple[int, int] = (0, 0),
                     out_hw: Optional[Tuple[int, int]] = None) -> np.ndarray:
    """Transposed conv (parity: veles/znicz/deconv.py `Deconv`): the adjoint
    of conv2d_forward wrt its input. x: (N,OH,OW,OC), w: (kh,kw,C,OC)."""
    n, oh, ow, oc = x.shape
    kh, kw, c, _ = w.shape
    sy, sx = stride
    ph, pw = padding
    if out_hw is None:
        out_hw = ((oh - 1) * sy + kh - 2 * ph, (ow - 1) * sx + kw - 2 * pw)
    h, wid = out_hw
    dcols = np.tensordot(x, w, axes=([3], [3]))  # (N,OH,OW,kh,kw,C)
    yp = np.zeros((n, h + 2 * ph, wid + 2 * pw, c), x.dtype)
    for i in range(kh):
        for j in range(kw):
            yp[:, i:i + oh * sy:sy, j:j + ow * sx:sx, :] += \
                dcols[:, :, :, i, j, :]
    return yp[:, ph:ph + h, pw:pw + wid, :]


def deconv2d_backward(x: np.ndarray, w: np.ndarray, err_y: np.ndarray,
                      stride: Tuple[int, int] = (1, 1),
                      padding: Tuple[int, int] = (0, 0)
                      ) -> Tuple[np.ndarray, np.ndarray]:
    """Gradient of deconv2d_forward (parity: veles/znicz/gd_deconv.py
    `GDDeconv`). Since deconv is the adjoint of conv wrt its input, its
    input-gradient is the plain forward conv of err_y, and its weight
    gradient is conv's dW with the roles of input and output error swapped.
    x: (N,OH,OW,OC), w: (kh,kw,C,OC), err_y: (N,H,W,C).
    Returns (err_x, dW)."""
    kh, kw, c, oc = w.shape
    zero_b = np.zeros((oc,), x.dtype)
    err_x = conv2d_forward(err_y, w, zero_b, stride, padding)
    cols, _, _ = _im2col(err_y, kh, kw, *stride, *padding)
    dw = np.tensordot(cols, x, axes=([0, 1, 2], [0, 1, 2]))
    return err_x, dw


def depool_forward(x: np.ndarray, idx: np.ndarray,
                   out_shape: Tuple[int, ...]) -> np.ndarray:
    """Depooling (parity: veles/znicz/depooling.py): scatter each pooled
    value back to its recorded winner offset — the exact adjoint of max
    pooling, used by autoencoder decoders. Sentinel offsets (== out size)
    mark dead windows and are dropped."""
    out = np.zeros(int(np.prod(out_shape)) + 1, x.dtype)
    np.add.at(out, idx.ravel(), x.ravel())
    return out[:-1].reshape(out_shape)


def depool_backward(err_y: np.ndarray, idx: np.ndarray) -> np.ndarray:
    """Gather: dL/dx of the scatter is err at each winner offset."""
    flat = np.append(err_y.ravel(), 0.0).astype(err_y.dtype)
    return flat[idx.ravel()].reshape(idx.shape)


def cut_forward(x: np.ndarray, crop: Tuple[int, int]) -> np.ndarray:
    """Cutter (parity: veles/znicz/cutter.py): crop `crop` = (cy, cx)
    border pixels off each spatial edge."""
    cy, cx = crop
    n, h, w, c = x.shape
    return x[:, cy:h - cy, cx:w - cx, :].copy()


def cut_backward(err_y: np.ndarray, x_shape: Tuple[int, ...],
                 crop: Tuple[int, int]) -> np.ndarray:
    cy, cx = crop
    err_x = np.zeros(x_shape, err_y.dtype)
    err_x[:, cy:x_shape[1] - cy, cx:x_shape[2] - cx, :] = err_y
    return err_x


# ---------------------------------------------------------------------------
# pooling (parity: veles/znicz/pooling.py + gd_pooling.py)
# ---------------------------------------------------------------------------

def _pool_windows(x, ky, kx, sy, sx):
    n, h, w, c = x.shape
    oh = int(np.ceil((h - ky) / sy)) + 1 if h > ky else 1
    ow = int(np.ceil((w - kx) / sx)) + 1 if w > kx else 1
    return oh, ow


def maxpool_forward(x: np.ndarray, ksize: Tuple[int, int],
                    stride: Tuple[int, int], use_abs: bool = False
                    ) -> Tuple[np.ndarray, np.ndarray]:
    """Max (or max-|·|, sign kept — reference MaxAbsPooling) pooling.
    Returns (y, flat offsets of the winners into x) — the reference kernels
    record argmax offsets for the backward scatter."""
    n, h, w, c = x.shape
    ky, kx = ksize
    sy, sx = stride
    oh, ow = _pool_windows(x, ky, kx, sy, sx)
    y = np.zeros((n, oh, ow, c), x.dtype)
    idx = np.zeros((n, oh, ow, c), np.int64)
    for i in range(oh):
        for j in range(ow):
            y0, x0 = i * sy, j * sx
            win = x[:, y0:y0 + ky, x0:x0 + kx, :]
            key = np.abs(win) if use_abs else win
            flat = key.reshape(n, -1, c)
            am = flat.argmax(axis=1)  # (n, c)
            wh = win.shape[1] * win.shape[2]
            picked = np.take_along_axis(win.reshape(n, wh, c), am[:, None, :],
                                        1)[:, 0, :]
            y[:, i, j, :] = picked
            dy, dx = np.unravel_index(am, (win.shape[1], win.shape[2]))
            nn = np.arange(n)[:, None]
            cc = np.arange(c)[None, :]
            idx[:, i, j, :] = ((nn * h + (y0 + dy)) * w + (x0 + dx)) * c + cc
    return y, idx


def maxpool_backward(err_y: np.ndarray, idx: np.ndarray,
                     x_shape: Tuple[int, ...]) -> np.ndarray:
    err_x = np.zeros(int(np.prod(x_shape)), err_y.dtype)
    np.add.at(err_x, idx.ravel(), err_y.ravel())
    return err_x.reshape(x_shape)


def stochastic_pool_forward(x: np.ndarray, rng: np.random.RandomState,
                            ksize: Tuple[int, int], stride: Tuple[int, int]
                            ) -> Tuple[np.ndarray, np.ndarray]:
    """Stochastic pooling (Zeiler & Fergus; reference StochasticPooling):
    sample a window element with probability ∝ its positive magnitude;
    all-nonpositive windows yield 0. Returns (y, flat winner offsets into x;
    `x.size` marks dead windows — the backward scatter skips those).

    Sampling is host-RNG-driven so it cannot match the XLA path
    sample-for-sample; tests assert distributional/structural properties
    instead (the reference had the same OpenCL-vs-numpy RNG split)."""
    n, h, w, c = x.shape
    ky, kx = ksize
    sy, sx = stride
    oh, ow = _pool_windows(x, ky, kx, sy, sx)
    y = np.zeros((n, oh, ow, c), x.dtype)
    idx = np.full((n, oh, ow, c), x.size, np.int64)
    for i in range(oh):
        for j in range(ow):
            y0, x0 = i * sy, j * sx
            win = x[:, y0:y0 + ky, x0:x0 + kx, :]
            wh = win.shape[1] * win.shape[2]
            flat = win.reshape(n, wh, c)
            pos = np.maximum(flat, 0.0)
            tot = pos.sum(axis=1)                       # (n, c)
            cum = np.cumsum(pos, axis=1)
            u = rng.random_sample((n, 1, c)) * tot[:, None, :]
            am = (cum > u).argmax(axis=1)               # first bin past u
            picked = np.take_along_axis(flat, am[:, None, :], 1)[:, 0, :]
            alive = tot > 0
            y[:, i, j, :] = np.where(alive, picked, 0.0)
            dy, dx = np.unravel_index(am, (win.shape[1], win.shape[2]))
            nn = np.arange(n)[:, None]
            cc = np.arange(c)[None, :]
            off = ((nn * h + (y0 + dy)) * w + (x0 + dx)) * c + cc
            idx[:, i, j, :] = np.where(alive, off, x.size)
    return y, idx


def stochastic_pool_backward(err_y: np.ndarray, idx: np.ndarray,
                             x_shape: Tuple[int, ...]) -> np.ndarray:
    """Scatter err to the sampled winners; `x.size` offsets (dead windows)
    land in a scratch slot that is dropped."""
    err_x = np.zeros(int(np.prod(x_shape)) + 1, err_y.dtype)
    np.add.at(err_x, idx.ravel(), err_y.ravel())
    return err_x[:-1].reshape(x_shape)


def avgpool_forward(x: np.ndarray, ksize: Tuple[int, int],
                    stride: Tuple[int, int]) -> np.ndarray:
    n, h, w, c = x.shape
    ky, kx = ksize
    sy, sx = stride
    oh, ow = _pool_windows(x, ky, kx, sy, sx)
    y = np.zeros((n, oh, ow, c), x.dtype)
    for i in range(oh):
        for j in range(ow):
            win = x[:, i * sy:i * sy + ky, j * sx:j * sx + kx, :]
            y[:, i, j, :] = win.mean(axis=(1, 2))
    return y


def avgpool_backward(err_y: np.ndarray, x_shape: Tuple[int, ...],
                     ksize: Tuple[int, int], stride: Tuple[int, int]
                     ) -> np.ndarray:
    n, h, w, c = x_shape
    ky, kx = ksize
    sy, sx = stride
    oh, ow = err_y.shape[1], err_y.shape[2]
    err_x = np.zeros(x_shape, err_y.dtype)
    for i in range(oh):
        for j in range(ow):
            win = err_x[:, i * sy:i * sy + ky, j * sx:j * sx + kx, :]
            cnt = win.shape[1] * win.shape[2]
            win += (err_y[:, i:i + 1, j:j + 1, :] / cnt)
    return err_x


# ---------------------------------------------------------------------------
# local response normalization (parity: veles/znicz/normalization.py)
# ---------------------------------------------------------------------------

def lrn_forward(x: np.ndarray, k: float = 2.0, alpha: float = 1e-4,
                beta: float = 0.75, n: int = 5) -> np.ndarray:
    """AlexNet-style across-channel LRN: y = x / (k + α·Σ x²)^β over a
    window of n channels centered at each channel."""
    sq = x * x
    c = x.shape[-1]
    half = n // 2
    ssum = np.zeros_like(x)
    for d in range(-half, half + 1):
        lo, hi = max(0, -d), min(c, c - d)
        ssum[..., lo:hi] += sq[..., lo + d:hi + d]
    return x * (k + alpha * ssum) ** (-beta)


def lrn_backward(x: np.ndarray, err_y: np.ndarray, k: float = 2.0,
                 alpha: float = 1e-4, beta: float = 0.75, n: int = 5
                 ) -> np.ndarray:
    """Hand-derived LRN gradient (the reference shipped a dedicated kernel;
    the card's kernel K3 computes the same closed form)."""
    sq = x * x
    c = x.shape[-1]
    half = n // 2
    ssum = np.zeros_like(x)
    for d in range(-half, half + 1):
        lo, hi = max(0, -d), min(c, c - d)
        ssum[..., lo:hi] += sq[..., lo + d:hi + d]
    scale = k + alpha * ssum
    # dy_i/dx_j = δ_ij·scale_i^-β − 2αβ·x_i·x_j·scale_i^-(β+1) for |i−j|≤half
    t = err_y * x * scale ** (-beta - 1.0)  # (…, c)
    tsum = np.zeros_like(x)
    for d in range(-half, half + 1):
        lo, hi = max(0, -d), min(c, c - d)
        tsum[..., lo:hi] += t[..., lo + d:hi + d]
    return err_y * scale ** (-beta) - 2.0 * alpha * beta * x * tsum


# ---------------------------------------------------------------------------
# composed goldens (NO 2015 parity — the gates for the searched CROSS-OP
# fusion templates, ops/templates.py). Each is built by COMPOSING the
# existing per-op goldens above, nothing else: tests assert these helpers
# are BITWISE equal to applying the member goldens sequentially, so a
# fused Pallas kernel gated against a composed golden is transitively
# gated against every member op's golden.
# ---------------------------------------------------------------------------

def lrn_maxpool_forward(x: np.ndarray, k: float = 2.0, alpha: float = 1e-4,
                        beta: float = 0.75, n: int = 5,
                        ksize: Tuple[int, int] = (3, 3),
                        stride: Tuple[int, int] = (2, 2)) -> np.ndarray:
    """LRN then max pooling over the same activation — the composed
    golden the fused `lrn_maxpool` template points are gated against."""
    y = lrn_forward(x, k, alpha, beta, n)
    return maxpool_forward(y, ksize, stride, False)[0]


def lrn_maxpool_backward(x: np.ndarray, err_y: np.ndarray, k: float = 2.0,
                         alpha: float = 1e-4, beta: float = 0.75,
                         n: int = 5, ksize: Tuple[int, int] = (3, 3),
                         stride: Tuple[int, int] = (2, 2)) -> np.ndarray:
    """Backward of the composed pair: scatter the pooled error to the
    recorded winners (first max in window scan order — the argmax
    convention every maxpool golden and lowering shares), then the LRN
    backward."""
    y = lrn_forward(x, k, alpha, beta, n)
    _, idx = maxpool_forward(y, ksize, stride, False)
    g_lrn = maxpool_backward(err_y, idx, y.shape)
    return lrn_backward(x, g_lrn, k, alpha, beta, n)


def conv_lrn_forward(x: np.ndarray, w: np.ndarray, b: np.ndarray,
                     stride: Tuple[int, int] = (1, 1),
                     padding: Tuple[int, int] = (0, 0),
                     activation: str = "linear", k: float = 2.0,
                     alpha: float = 1e-4, beta: float = 0.75,
                     n: int = 5) -> np.ndarray:
    """conv+bias+activation with the LRN folded into the epilogue — the
    composed golden for the conv_stem template's `epi=lrn` points."""
    return lrn_forward(conv2d_forward(x, w, b, stride, padding,
                                      activation), k, alpha, beta, n)


def conv_lrn_backward(x: np.ndarray, w: np.ndarray, b: np.ndarray,
                      err_y: np.ndarray,
                      stride: Tuple[int, int] = (1, 1),
                      padding: Tuple[int, int] = (0, 0),
                      activation: str = "linear", k: float = 2.0,
                      alpha: float = 1e-4, beta: float = 0.75, n: int = 5
                      ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """(err_x, dW, db) of the composed conv+LRN epilogue."""
    y_conv = conv2d_forward(x, w, b, stride, padding, activation)
    g_conv = lrn_backward(y_conv, err_y, k, alpha, beta, n)
    return conv2d_backward(x, w, y_conv, g_conv, stride, padding,
                           activation)


def attn_dropout_forward(q: np.ndarray, k: np.ndarray, v: np.ndarray,
                         mask: np.ndarray, scale: float = None,
                         causal: bool = False) -> np.ndarray:
    """Attention with the pre-scaled dropout mask applied to the output
    block — the composed golden for the flash_attn template's `drop=1`
    points (mask (B, S, H, D), values 0 or 1/keep; the backward leg is
    `dropout_backward` on the incoming error, composed in tests)."""
    return dropout_forward(mha_forward(q, k, v, scale=scale,
                                       causal=causal), mask)


# ---------------------------------------------------------------------------
# fused SGD+momentum update (parity: veles/znicz/nn_units.py weight-update
# kernels; the golden for the `sgd_update` lowering variants)
# ---------------------------------------------------------------------------

def sgd_momentum_update(p: np.ndarray, g: np.ndarray, v: np.ndarray,
                        lr: float, momentum: float = 0.0,
                        weight_decay: float = 0.0,
                        l1_decay: float = 0.0):
    """One leaf of the reference update rule:
    v ← μ·v − lr·(g + λ2·w + λ1·sign(w));  w ← w + v."""
    reg = g + weight_decay * p + l1_decay * np.sign(p)
    v_new = momentum * v - lr * reg
    return p + v_new, v_new


# ---------------------------------------------------------------------------
# blockwise int8 quantization (NO 2015 parity — the golden for the EQuARX
# gradient wire compression: per-block absmax scales,
# round-to-nearest-even codes; kept with the other goldens for the
# collectives of a later slice)
# ---------------------------------------------------------------------------

def quantize_blockwise(x: np.ndarray, block: int
                       ) -> Tuple[np.ndarray, np.ndarray]:
    """Per-block absmax int8 quantization over the LAST axis (its length
    must divide `block` — callers zero-pad first; a zero pad block gets
    scale 1 and all-zero codes, contributing nothing on dequantize).
    Returns (codes int8, scales f32); codes = clip(rint(x/scale), ±127)
    with scale = absmax/127 (1.0 for an all-zero block)."""
    assert x.shape[-1] % block == 0, (x.shape, block)
    xb = x.reshape(x.shape[:-1] + (x.shape[-1] // block, block)) \
        .astype(np.float32)
    absmax = np.max(np.abs(xb), axis=-1)
    scale = np.where(absmax > 0, absmax / np.float32(127.0),
                     np.float32(1.0)).astype(np.float32)
    q = np.clip(np.rint(xb / scale[..., None]), -127, 127).astype(np.int8)
    return q.reshape(x.shape), scale


def dequantize_blockwise(q: np.ndarray, scale: np.ndarray,
                         block: int) -> np.ndarray:
    """Inverse of `quantize_blockwise`: codes x scales -> f32 values."""
    assert q.shape[-1] % block == 0, (q.shape, block)
    qb = q.reshape(q.shape[:-1] + (q.shape[-1] // block, block)) \
        .astype(np.float32)
    return (qb * scale[..., None].astype(np.float32)).reshape(q.shape)


# ---------------------------------------------------------------------------
# quantized serving forward (NO 2015 parity — the golden of a quantized
# serving path. Weight-only quantization reuses the blockwise int8 golden
# above — one quantization rule for collectives and serving, never two.)
# ---------------------------------------------------------------------------

def serve_forward_mlp(x: np.ndarray, layers) -> np.ndarray:
    """Canonical tanh-MLP serving forward in numpy: `layers` is a list
    of (w, b) pairs, tanh between layers, linear head. The serve_forward
    equivalence contract runs every wire variant against THIS model with
    the variant's own weight transform applied through the reference
    quantizers, so the contract isolates the forward math from the
    (separately bitwise-asserted) quantization."""
    h = x.astype(np.float64)
    for i, (w, b) in enumerate(layers):
        h = h @ w.astype(np.float64) + b.astype(np.float64)
        if i < len(layers) - 1:
            h = np.tanh(h)
    return h.astype(np.float32)


def serve_quantize_weight(w: np.ndarray, block: int
                          ) -> Tuple[np.ndarray, np.ndarray]:
    """Weight-only int8 serving transform of one >=2-D param leaf:
    reshape to (rows, cols) = (prod(leading), last), zero-pad cols to a
    block multiple, per-block absmax int8 via `quantize_blockwise`.
    Returns (codes int8 (rows, colsp), scales f32 (rows, colsp//block)).
    A dequantize on the device must reproduce `dequantize_blockwise` of
    exactly these codes/scales."""
    rows = int(np.prod(w.shape[:-1], dtype=np.int64))
    cols = w.shape[-1]
    pad = (-cols) % block
    w2 = w.reshape(rows, cols).astype(np.float32)
    if pad:
        w2 = np.concatenate(
            [w2, np.zeros((rows, pad), np.float32)], axis=1)
    return quantize_blockwise(w2, block)


# ---------------------------------------------------------------------------
# multi-head attention (NO 2015 parity — the reference framework has no
# attention anywhere; this numpy model is the golden the
# `flash_attn` lowering variants are equivalence-gated against)
# ---------------------------------------------------------------------------

def mha_forward(q: np.ndarray, k: np.ndarray, v: np.ndarray,
                scale: float = None, causal: bool = False) -> np.ndarray:
    """Plain softmax attention in numpy. q/k/v: (B, S, H, D) ->
    (B, S, H, D)."""
    b, s, h, d = q.shape
    if scale is None:
        scale = 1.0 / np.sqrt(d)
    sc = np.einsum("bqhd,bkhd->bhqk", q, k).astype(np.float64) * scale
    if causal:
        mask = np.tril(np.ones((s, s), bool))
        sc = np.where(mask[None, None], sc, -np.inf)
    sc -= sc.max(axis=-1, keepdims=True)
    p = np.exp(sc)
    p /= p.sum(axis=-1, keepdims=True)
    return np.einsum("bhqk,bkhd->bqhd", p, v.astype(np.float64)) \
        .astype(q.dtype)


# ---------------------------------------------------------------------------
# dropout (parity: veles/znicz/dropout.py)
# ---------------------------------------------------------------------------

def dropout_forward(x: np.ndarray, mask: np.ndarray) -> np.ndarray:
    """mask is pre-scaled (0 or 1/keep_prob), generated by the caller's PRNG;
    the reference likewise generated the mask with its device RNG kernel."""
    return x * mask


def dropout_backward(err_y: np.ndarray, mask: np.ndarray) -> np.ndarray:
    return err_y * mask


def make_dropout_mask(rng: np.random.RandomState, shape, drop_prob: float,
                      dtype=np.float32) -> np.ndarray:
    keep = 1.0 - drop_prob
    return (rng.random_sample(shape) < keep).astype(dtype) / dtype(keep)


# ---------------------------------------------------------------------------
# evaluators (parity: veles/znicz/evaluator.py)
# ---------------------------------------------------------------------------

def softmax_ce(probs: np.ndarray, labels: np.ndarray, n_classes: int,
               weights: np.ndarray = None
               ) -> Tuple[float, np.ndarray, int, np.ndarray]:
    """EvaluatorSoftmax: input is the softmax OUTPUT (All2AllSoftmax yields
    probabilities). Returns (mean CE loss, err wrt pre-softmax logits,
    n_err, confusion matrix). `weights` (N,) sample weights (the Loader's
    pad mask) — zero rows drop out of every metric; None == all-ones.

    Deviation from reference (documented): err is divided by batch size so
    learning rates are batch-size-invariant; the reference folded this into
    its lr convention.
    """
    n = probs.shape[0]
    onehot = np.zeros((n, n_classes), probs.dtype)
    onehot[np.arange(n), labels] = 1.0
    eps = np.finfo(probs.dtype).tiny
    logs = -np.log(np.maximum(probs[np.arange(n), labels], eps))
    pred = probs.argmax(axis=1)
    wrong = pred != labels
    confusion = np.zeros((n_classes, n_classes), np.int64)
    if weights is None:
        loss = float(logs.mean())
        err = (probs - onehot) / np.asarray(n, probs.dtype)
        n_err = int(wrong.sum())
        np.add.at(confusion, (labels, pred), 1)
    else:
        w = weights.astype(probs.dtype)
        wsum = max(float(w.sum()), float(eps))
        loss = float((logs * w).sum() / wsum)
        err = (probs - onehot) * w[:, None] / wsum
        n_err = int((wrong & (w > 0)).sum())
        np.add.at(confusion, (labels, pred), (w > 0).astype(np.int64))
    return loss, err, n_err, confusion


def mse(y: np.ndarray, target: np.ndarray, weights: np.ndarray = None
        ) -> Tuple[float, np.ndarray]:
    """EvaluatorMSE: returns (mean-over-batch MSE, err wrt y); `weights`
    (N,) sample weights as in softmax_ce."""
    n = y.shape[0]
    diff = y - target
    if weights is None:
        loss = float((diff * diff).sum() / n)
        return loss, 2.0 * diff / np.asarray(n, y.dtype)
    wb = weights.astype(y.dtype).reshape((n,) + (1,) * (y.ndim - 1))
    wsum = max(float(weights.sum()), 1e-9)
    loss = float((wb * diff * diff).sum() / wsum)
    return loss, 2.0 * diff * wb / np.asarray(wsum, y.dtype)


# ---------------------------------------------------------------------------
# Kohonen SOM (parity: veles/znicz/kohonen.py — NOT gradient descent)
# ---------------------------------------------------------------------------

def kohonen_forward(x: np.ndarray, w: np.ndarray) -> np.ndarray:
    """Winner indices: argmin over squared L2 distance to each neuron.
    x: (N, D), w: (K, D) -> (N,) int winners."""
    d2 = (x * x).sum(1)[:, None] - 2.0 * x @ w.T + (w * w).sum(1)[None, :]
    return d2.argmin(axis=1)


def kohonen_update(x: np.ndarray, w: np.ndarray, grid: np.ndarray,
                   lr: float, sigma: float) -> np.ndarray:
    """One batch of neighborhood-decay updates: for each sample, every
    neuron moves toward it weighted by a Gaussian over grid distance to the
    winner. grid: (K, 2) neuron coordinates. Returns the new weights."""
    w = w.copy()
    for xi in x:
        win = int(kohonen_forward(xi[None, :], w)[0])
        gd2 = ((grid - grid[win]) ** 2).sum(axis=1)
        h = np.exp(-gd2 / (2.0 * sigma * sigma)).astype(w.dtype)
        w += lr * h[:, None] * (xi[None, :] - w)
    return w


# ---------------------------------------------------------------------------
# RBM (parity: veles/znicz/rbm_units.py — CD-1)
# ---------------------------------------------------------------------------

def rbm_cd1(v0: np.ndarray, w: np.ndarray, bv: np.ndarray, bh: np.ndarray,
            rng: np.random.RandomState
            ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """One contrastive-divergence step. v0: (N, V), w: (V, H).
    Returns (dW, dbv, dbh) — gradients to ADD (ascent on log-likelihood)."""
    sig = lambda a: 1.0 / (1.0 + np.exp(-a))  # noqa: E731
    h0p = sig(v0 @ w + bh)
    h0 = (rng.random_sample(h0p.shape) < h0p).astype(v0.dtype)
    v1p = sig(h0 @ w.T + bv)
    h1p = sig(v1p @ w + bh)
    n = v0.shape[0]
    dw = (v0.T @ h0p - v1p.T @ h1p) / n
    dbv = (v0 - v1p).mean(axis=0)
    dbh = (h0p - h1p).mean(axis=0)
    return dw, dbv, dbh


# ---------------------------------------------------------------------------
# LSTM cell (parity: the reference's char-LSTM built from all2all+activation
# units with explicit unrolling; here a fused cell, scanned on device)
# ---------------------------------------------------------------------------

def lstm_step(x: np.ndarray, h: np.ndarray, c: np.ndarray, wx: np.ndarray,
              wh: np.ndarray, b: np.ndarray
              ) -> Tuple[np.ndarray, np.ndarray]:
    """Standard LSTM cell; gate order [i, f, g, o]. wx: (D, 4H), wh: (H, 4H)."""
    sig = lambda a: 1.0 / (1.0 + np.exp(-a))  # noqa: E731
    z = x @ wx + h @ wh + b
    hsz = h.shape[1]
    i = sig(z[:, 0 * hsz:1 * hsz])
    f = sig(z[:, 1 * hsz:2 * hsz])
    g = np.tanh(z[:, 2 * hsz:3 * hsz])
    o = sig(z[:, 3 * hsz:4 * hsz])
    c_new = f * c + i * g
    h_new = o * np.tanh(c_new)
    return h_new, c_new


def lstm_forward(xs: np.ndarray, h0: np.ndarray, c0: np.ndarray,
                 wx: np.ndarray, wh: np.ndarray, b: np.ndarray
                 ) -> Tuple[np.ndarray, dict]:
    """Unrolled forward over time. xs: (T, N, D) -> hs: (T, N, H), plus the
    per-step cache (gates, cell states) that lstm_backward consumes."""
    sig = lambda a: 1.0 / (1.0 + np.exp(-a))  # noqa: E731
    T, n, _ = xs.shape
    hsz = h0.shape[1]
    hs = np.zeros((T, n, hsz), xs.dtype)
    cache = {k: np.zeros((T, n, hsz), xs.dtype)
             for k in ("i", "f", "g", "o", "c", "hprev", "cprev")}
    h, c = h0, c0
    for t in range(T):
        z = xs[t] @ wx + h @ wh + b
        i = sig(z[:, 0 * hsz:1 * hsz])
        f = sig(z[:, 1 * hsz:2 * hsz])
        g = np.tanh(z[:, 2 * hsz:3 * hsz])
        o = sig(z[:, 3 * hsz:4 * hsz])
        cache["hprev"][t], cache["cprev"][t] = h, c
        c = f * c + i * g
        h = o * np.tanh(c)
        for k, v in (("i", i), ("f", f), ("g", g), ("o", o), ("c", c)):
            cache[k][t] = v
        hs[t] = h
    return hs, cache


def lstm_backward(xs: np.ndarray, wx: np.ndarray, wh: np.ndarray,
                  dhs: np.ndarray, cache: dict
                  ) -> Tuple[np.ndarray, np.ndarray, np.ndarray, np.ndarray]:
    """BPTT through lstm_forward (parity: the reference's char-LSTM
    backward, which its unit graph unrolled step-by-step on host).
    dhs: (T, N, H) = dL/dh_t for every step. Returns (dxs, dwx, dwh, db)."""
    T, n, d = xs.shape
    hsz = dhs.shape[2]
    dxs = np.zeros_like(xs)
    dwx = np.zeros_like(wx)
    dwh = np.zeros_like(wh)
    db = np.zeros((4 * hsz,), xs.dtype)
    dh_next = np.zeros((n, hsz), xs.dtype)
    dc_next = np.zeros((n, hsz), xs.dtype)
    for t in range(T - 1, -1, -1):
        i, f, g, o = (cache[k][t] for k in ("i", "f", "g", "o"))
        c, cprev, hprev = cache["c"][t], cache["cprev"][t], cache["hprev"][t]
        tanh_c = np.tanh(c)
        dh = dhs[t] + dh_next
        dc = dc_next + dh * o * (1.0 - tanh_c * tanh_c)
        do = dh * tanh_c
        df = dc * cprev
        di = dc * g
        dg = dc * i
        dz = np.concatenate([di * i * (1 - i), df * f * (1 - f),
                             dg * (1 - g * g), do * o * (1 - o)], axis=1)
        dxs[t] = dz @ wx.T
        dh_next = dz @ wh.T
        dc_next = dc * f
        dwx += xs[t].T @ dz
        dwh += hprev.T @ dz
        db += dz.sum(axis=0)
    return dxs, dwx, dwh, db
