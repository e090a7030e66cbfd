"""Plain PyTorch versions of the serving slice's ops (NHWC activations).

The port's counterpart of `veles_tpu/ops/xla.py`. Layouts at the function
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


def act_forward(name: str, x: torch.Tensor) -> torch.Tensor:
    """The serving slice's activations: "linear" and "strictrelu" =
    max(x, 0) (NaN propagates, as in jnp.maximum). The reference's scaled
    tanh, softplus "relu", sigmoid and log come with a later slice."""
    if name == "linear":
        return x
    if name == "strictrelu":
        return torch.relu(x)
    raise ValueError(f"unknown activation {name!r}")


# ---------------------------------------------------------------------------
# fully connected
# ---------------------------------------------------------------------------


def all2all_forward(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor,
                    activation: str = "linear") -> torch.Tensor:
    """y = act(x @ W + b). Trailing dims flatten in NHWC order (H·W·C), the
    row order of the JAX package's FC weights."""
    x2 = x.reshape(x.shape[0], -1)
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
    `w_oihw` is `conv_weight_oihw(w)` when the caller caches it."""
    if w_oihw is None:
        w_oihw = conv_weight_oihw(w)
    y = F.conv2d(x.permute(0, 3, 1, 2), w_oihw, b, tuple(stride),
                 tuple(padding))
    return act_forward(activation, y.permute(0, 2, 3, 1).contiguous())


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


def lrn_forward(x: torch.Tensor, k: float = 2.0, alpha: float = 1e-4,
                beta: float = 0.75, n: int = 5) -> torch.Tensor:
    """AlexNet across-channel LRN: y = x·(k + α·W(x²))^(−β), W the ±n//2
    window (odd n only: even n would silently widen to n+1 taps)."""
    if n % 2 == 0:
        raise ValueError(f"LRN window n must be odd, got {n}")
    s = k + alpha * lrn_window_sum(x * x, n)
    return x * pow_neg_quarters(s, beta)
