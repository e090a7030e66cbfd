"""Plain PyTorch versions of the port's ops (NHWC activations): the
forwards, the closed-form LRN and LRN→max-pool backwards of the JAX
package's Pallas kernels, the fused step's cross-entropy and dropout mask.

The port's counterpart of `veles_tpu/ops/xla.py` and, for the backwards,
of the math in `veles_tpu/ops/pallas_kernels.py`. Layouts at the function
boundaries are the JAX package's: activations NHWC, conv weights HWIO
(ky, kx, cin, cout), FC weights (fan_in, units). Inside, a convolution
views its NHWC input as a channels-last NCHW tensor — no copy — for
`F.conv2d`.

These are the CPU path of the kernels in ops/kernels.py and the
references the card's kernels are held against; where the JAX package
leaves an op to XLA (convolutions, matrix products, plain pooling) the
port leaves it to PyTorch here.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.nn.functional as F


#: the reference's scaled tanh, A·tanh(B·x) (xla.py TANH_A, TANH_B)
TANH_A = 1.7159
TANH_B = 0.6666


def act_forward(name: str, x: torch.Tensor) -> torch.Tensor:
    """The port's activations so far: "linear", "tanh" = the reference's
    scaled 1.7159·tanh(0.6666·x), and "strictrelu" = max(x, 0) (NaN
    propagates, as in jnp.maximum). The softplus "relu", sigmoid and log
    come with a later slice."""
    if name == "linear":
        return x
    if name == "tanh":
        if x.element_size() < 4:
            # a bf16 x: the constants round to its dtype first, as the
            # JAX package's weakly typed Python floats do (B 0.66796875,
            # A 1.71875); torch would multiply by their f32 values
            a, b = x.new_tensor(TANH_A), x.new_tensor(TANH_B)
            return a * torch.tanh(b * x)
        return TANH_A * torch.tanh(TANH_B * x)
    if name == "strictrelu":
        if x.element_size() < 4:
            # bf16 pre-activations are exactly 0 often enough for the tie's
            # gradient to count: jnp.maximum(x, 0) and torch.maximum give
            # it half, torch.relu none
            return torch.maximum(x, x.new_zeros(()))
        return torch.relu(x)
    raise ValueError(f"unknown activation {name!r}")


# ---------------------------------------------------------------------------
# fully connected
# ---------------------------------------------------------------------------


def matmul(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a @ b in the dtype the JAX package's `@` promotes its operands to
    (`torch.promote_types`): f32 activations against bf16 weights compute
    in f32, where `torch.matmul` would refuse the mixed dtypes."""
    t = torch.promote_types(a.dtype, b.dtype)
    return a.to(t) @ b.to(t)


def all2all_forward(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor,
                    activation: str = "linear") -> torch.Tensor:
    """y = act(x @ W + b). Trailing dims flatten in NHWC order (H·W·C), the
    row order of the JAX package's FC weights. In f32 the bias is added
    inside the product (addmm); a sub-f32 (bf16) product is rounded before
    the bias is added, as the JAX package's `x @ W + b` rounds it."""
    x2 = x.reshape(x.shape[0], -1)
    if x2.element_size() < 4:
        return act_forward(activation, x2 @ w + b)
    return act_forward(activation, torch.addmm(b, x2, w))


# ---------------------------------------------------------------------------
# convolution — NHWC activations, HWIO weights at the boundary
# ---------------------------------------------------------------------------


def conv_weight_oihw(w: torch.Tensor) -> torch.Tensor:
    """HWIO -> the OIHW layout F.conv2d takes, stored channels-last (the
    layout cuDNN runs NHWC convolutions in)."""
    return w.permute(3, 2, 0, 1).contiguous(
        memory_format=torch.channels_last)


def conv2d_forward(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor,
                   stride: Tuple[int, int] = (1, 1),
                   padding: Tuple[int, int] = (0, 0),
                   activation: str = "linear",
                   w_oihw: Optional[torch.Tensor] = None) -> torch.Tensor:
    """act(conv2d(x, W) + b) with symmetric (ph, ph), (pw, pw) padding and
    the bias added before the activation (xla.py conv2d_forward).
    `w_oihw` is `conv_weight_oihw(w)` when the caller caches it. In f32
    cuDNN adds the bias inside the convolution; a sub-f32 (bf16)
    convolution is rounded before the bias is added, as XLA's conv
    followed by `+ b` rounds it in the JAX package."""
    if w_oihw is None:
        w_oihw = conv_weight_oihw(w)
    narrow = x.element_size() < 4
    y = F.conv2d(x.permute(0, 3, 1, 2), w_oihw, None if narrow else b,
                 tuple(stride), tuple(padding)).permute(0, 2, 3, 1)
    if narrow:
        y = y + b
    return act_forward(activation, y.contiguous())


# ---------------------------------------------------------------------------
# pooling — ceil-mode geometry, -inf padding
# ---------------------------------------------------------------------------


def pool_out_hw(h: int, w: int, ky: int, kx: int, sy: int,
                sx: int) -> Tuple[int, int]:
    """Ceil-mode pooled extent: edge windows truncate; an input no larger
    than the window still gives one output (pallas_kernels._pool_out_hw,
    xla._ceil_pads, reference._pool_windows)."""
    oh = -(-(h - ky) // sy) + 1 if h > ky else 1
    ow = -(-(w - kx) // sx) + 1 if w > kx else 1
    return oh, ow


def maxpool_forward(x: torch.Tensor, ksize: Tuple[int, int],
                    stride: Tuple[int, int]) -> torch.Tensor:
    """Ceil-mode max pooling of NHWC `x`. The bottom/right edge is padded
    with -inf up to whole windows, then pooled without ceil mode: the
    geometry is the JAX package's by construction, including inputs no
    larger than the window, which `F.max_pool2d(ceil_mode=True)` refuses.
    NaN propagates through the max, as in jnp.maximum."""
    ky, kx = ksize
    sy, sx = stride
    _, h, w, _ = x.shape
    oh, ow = pool_out_hw(h, w, ky, kx, sy, sx)
    xp = x.permute(0, 3, 1, 2)
    eh, ew = (oh - 1) * sy + ky - h, (ow - 1) * sx + kx - w
    if eh or ew:
        xp = F.pad(xp, (0, ew, 0, eh), value=float("-inf"))
    y = F.max_pool2d(xp, (ky, kx), (sy, sx))
    return y.permute(0, 2, 3, 1).contiguous()


# ---------------------------------------------------------------------------
# local response normalization (across channels, odd n)
# ---------------------------------------------------------------------------


def lrn_window_sum(a: torch.Tensor, n: int) -> torch.Tensor:
    """±n//2 across-channel window sum over the last axis, zero outside
    the channel range. Taps add in the order of the JAX package's Pallas
    `_window_sum` and of the kernels: the centre, then +d and -d."""
    out = a
    for d in range(1, n // 2 + 1):
        out = out + F.pad(a[..., d:], (0, d)) + F.pad(a[..., :-d], (d, 0))
    return out


def quarter_exponent(beta: float) -> int:
    """q = 4·beta when that is an integer in [1, 16], else 0: the case
    where s^(-beta) decomposes into sqrt/rsqrt products."""
    q4 = 4.0 * beta
    q = int(round(q4))
    return q if abs(q4 - q) < 1e-12 and 1 <= q <= 16 else 0


def pow_neg_quarters(s: torch.Tensor, beta: float) -> torch.Tensor:
    """s^(-beta). When 4·beta is an integer q in [1, 16] (AlexNet's
    beta = 0.75 gives q = 3), s^(-q/4) is built from products of
    squarings of s^(-1/4) = sqrt(rsqrt(s)) — the decomposition of
    xla._pow_neg_quarters, which the kernels use too."""
    q = quarter_exponent(beta)
    if q:
        t = torch.sqrt(torch.rsqrt(s))
        out = None
        while q:
            if q & 1:
                out = t if out is None else out * t
            q >>= 1
            if q:
                t = t * t
        return out
    return s ** (-beta)


def _f32(t: torch.Tensor) -> torch.Tensor:
    """`t` in f32 where its floating dtype is narrower (bf16, f16), else
    `t` itself."""
    if t.is_floating_point() and t.element_size() < 4:
        return t.to(torch.float32)
    return t


def lrn_forward(x: torch.Tensor, k: float = 2.0, alpha: float = 1e-4,
                beta: float = 0.75, n: int = 5) -> torch.Tensor:
    """AlexNet across-channel LRN: y = x·(k + α·W(x²))^(−β), W the ±n//2
    window (odd n only: even n would silently widen to n+1 taps). A
    sub-f32 x (bf16) is computed in f32 and y rounded once to x's dtype,
    as the JAX package's Pallas kernel computes its blocks."""
    if n % 2 == 0:
        raise ValueError(f"LRN window n must be odd, got {n}")
    xf = _f32(x)
    s = k + alpha * lrn_window_sum(xf * xf, n)
    return (xf * pow_neg_quarters(s, beta)).to(x.dtype)


def lrn_backward(x: torch.Tensor, g: torch.Tensor, k: float = 2.0,
                 alpha: float = 1e-4, beta: float = 0.75,
                 n: int = 5) -> torch.Tensor:
    """Closed-form LRN gradient, the math of the JAX package's Pallas
    `_lrn_bwd_kernel`: dx = g·d − 2αβ·x·W(g·x·d/s), s = k + α·W(x²),
    d = s^(−β), in that kernel's order of operations. Sub-f32 x and g
    (bf16) are computed in f32 and dx rounded once to x's dtype."""
    if n % 2 == 0:
        raise ValueError(f"LRN window n must be odd, got {n}")
    xf, gf = _f32(x), _f32(g)
    s = k + alpha * lrn_window_sum(xf * xf, n)
    d = pow_neg_quarters(s, beta)
    tsum = lrn_window_sum(gf * xf * d / s, n)
    return (gf * d - (2.0 * alpha * beta) * xf * tsum).to(x.dtype)


def lrn_maxpool_backward(x: torch.Tensor, g: torch.Tensor, k: float = 2.0,
                         alpha: float = 1e-4, beta: float = 0.75, n: int = 5,
                         ksize: Tuple[int, int] = (3, 3),
                         stride: Tuple[int, int] = (2, 2)) -> torch.Tensor:
    """Gradient of LRN followed by the ceil-mode max pool, given the
    pooled gradient `g` — the JAX package's `_lrn_pool_bwd_kernel`:
    recompute the LRN output, route each window's gradient to its FIRST
    maximum in scan order (dy, then dx; post-ReLU zeros tie constantly),
    sum the routed gradients in that tap order, then the closed-form LRN
    backward. A NaN in a window makes its maximum NaN, which equals no
    tap: that window's gradient goes nowhere. Sub-f32 x and g (bf16) are
    computed in f32, routed on the f32 LRN values as the JAX kernel
    routes its promoted block, and dx rounded once to x's dtype."""
    dtype, x, g = x.dtype, _f32(x), _f32(g)
    ky, kx = ksize
    sy, sx = stride
    nb, h, w, c = x.shape
    oh, ow = pool_out_hw(h, w, ky, kx, sy, sx)
    hp, wp = (oh - 1) * sy + ky, (ow - 1) * sx + kx
    y = F.pad(lrn_forward(x, k, alpha, beta, n), (0, 0, 0, wp - w, 0, hp - h),
              value=float("-inf"))
    views = [(dy, dx, (slice(None), slice(dy, dy + (oh - 1) * sy + 1, sy),
                       slice(dx, dx + (ow - 1) * sx + 1, sx)))
             for dy in range(ky) for dx in range(kx)]
    m = y[views[0][2]]
    for _, _, v in views[1:]:
        m = torch.maximum(m, y[v])
    win = torch.full(m.shape, len(views), dtype=torch.int64, device=x.device)
    for lin in reversed(range(len(views))):
        win = torch.where(y[views[lin][2]] == m, lin, win)
    g_lrn = torch.zeros((nb, hp, wp, c), dtype=x.dtype, device=x.device)
    zero = torch.zeros((), dtype=g.dtype, device=g.device)
    for lin, (_, _, v) in enumerate(views):
        g_lrn[v] += torch.where(win == lin, g, zero)
    return lrn_backward(x, g_lrn[:, :h, :w, :], k, alpha, beta,
                        n).to(dtype)


# ---------------------------------------------------------------------------
# loss and dropout of the fused train step
# ---------------------------------------------------------------------------


def ce_loss_from_logits(logits: torch.Tensor, labels: torch.Tensor,
                        weights: Optional[torch.Tensor] = None,
                        denom: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Scalar cross-entropy from logits through log-softmax (xla.py
    ce_loss_from_logits): −Σ w·log p[label] / max(denom, 1e-9), denom
    defaulting to Σ w, so the Loader's pad-mask rows drop out; the plain
    mean without weights."""
    logits = logits.reshape(-1, logits.shape[-1])
    flat = labels.reshape(-1)
    picked = torch.log_softmax(logits, dim=-1).gather(1, flat[:, None])[:, 0]
    if weights is None:
        return -picked.mean()
    w = weights.broadcast_to(labels.shape).reshape(-1).to(picked.dtype)
    d = w.sum() if denom is None else denom
    return -(picked * w).sum() / torch.clamp(d, min=1e-9)


def dropout_mask(shape, drop_prob: float, generator: torch.Generator,
                 device: torch.device,
                 dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """Pre-scaled dropout mask, values 0 or 1/keep: (u < keep) / keep with
    u uniform in [0, 1) from `generator` (xla.py make_dropout_mask; the
    bits cannot match jax's, so tests hand both packages the same
    masks). As there, the comparison's 0/1 is cast to `dtype` first and
    divided by keep as `dtype` holds it: under bf16, round(1 /
    round(keep))."""
    keep = 1.0 - drop_prob
    u = torch.rand(shape, generator=generator, device=device)
    return (u < keep).to(dtype) / float(torch.tensor(keep, dtype=dtype))
