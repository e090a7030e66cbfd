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

import functools
import math
from typing import Optional, Tuple

import torch
import torch.nn.functional as F


#: the reference's scaled tanh, A·tanh(B·x) (xla.py TANH_A, TANH_B)
TANH_A = 1.7159
TANH_B = 0.6666


def act_forward(name: str, x: torch.Tensor) -> torch.Tensor:
    """The port's activations: "linear", "tanh" = the reference's scaled
    1.7159·tanh(0.6666·x), "relu" = the reference's smooth RELU
    ln(1 + eˣ) (softplus), "strictrelu" = max(x, 0) (NaN propagates, as
    in jnp.maximum), "sigmoid" and "log" = asinh(x)."""
    if name == "linear":
        return x
    if name == "log":
        return torch.asinh(x)
    if name == "relu":
        return F.softplus(x)
    if name == "sigmoid":
        return torch.sigmoid(x)
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


def sqrt(t: torch.Tensor) -> torch.Tensor:
    """`torch.sqrt`, correctly rounded on the CPU as on the card. On the
    CPU ATen takes an f32 sqrt from MKL VML, which is not correctly
    rounded (about one value in eight an ulp off) and whose first call in
    a process has returned one thread's share of a tensor about 2^-12 off
    on AVX512-FP16 CPUs; an f64 sqrt rounded to f32 is the correctly
    rounded f32 sqrt (53 >= 2*24 + 2 bits), and stays within an ulp where
    the f64 call is itself a little off. On the card CUDA's sqrt is
    correctly rounded already."""
    if t.device.type != "cpu" or t.dtype == torch.float64:
        return torch.sqrt(t)
    return torch.sqrt(t.double()).to(t.dtype)


def act_backward(name: str, y: torch.Tensor, err: torch.Tensor,
                 x: Optional[torch.Tensor] = None) -> torch.Tensor:
    """dL/dx from dL/dy (`err`) and the forward OUTPUT y, the reference's
    memory model (pre-activations are never kept), and the input `x`
    where the derivative needs it (the log flavor): xla.py / reference.py
    act_backward, the granular gradient units' rule."""
    if name == "log":
        if x is None:
            raise ValueError("the log activation's backward needs its "
                             "input x")
        return err / sqrt(x * x + 1.0)
    if name == "linear":
        return err
    if name == "tanh":
        return err * (TANH_B * (TANH_A - y * y / TANH_A))
    if name == "relu":
        return err * (1.0 - torch.exp(-y))
    if name == "strictrelu":
        return err * (y > 0)
    if name == "sigmoid":
        return err * y * (1.0 - y)
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
                   w_oihw: Optional[torch.Tensor] = None,
                   s2d: bool = False, acc: str = "native") -> torch.Tensor:
    """act(conv2d(x, W) + b) with symmetric (ph, ph), (pw, pw) padding and
    the bias added before the activation (xla.py conv2d_forward).
    `w_oihw` is `conv_weight_oihw(w)` when the caller caches it. In f32
    cuDNN adds the bias inside the convolution; a sub-f32 (bf16)
    convolution is rounded before the bias is added, as XLA's conv
    followed by `+ b` rounds it in the JAX package. `s2d` with a square
    stride > 1 runs the convolution as `conv2d_space_to_depth` (the
    cached `w_oihw` is then not used). `acc="f32"` pins a sub-f32
    convolution's accumulation to f32 (xla.py's `preferred_element_type`
    axis of the conv_stem template): x and w widened, the result rounded
    to x's dtype once, before the bias; "native" leaves the accumulation
    to the backend."""
    if acc not in ("native", "f32"):
        raise ValueError(f"acc must be 'native' or 'f32', got {acc!r}")
    narrow = x.element_size() < 4
    if narrow and acc == "f32":
        y = conv2d_forward(x.to(torch.float32), w.to(torch.float32),
                           torch.zeros_like(b, dtype=torch.float32),
                           stride, padding, "linear", s2d=s2d)
        return act_forward(activation, y.to(x.dtype) + b)
    if s2d and stride[0] == stride[1] and stride[0] > 1:
        y = conv2d_space_to_depth(x, w, stride[0], tuple(padding),
                                  None if narrow else b)
    else:
        if w_oihw is None:
            w_oihw = conv_weight_oihw(w)
        y = F.conv2d(x.permute(0, 3, 1, 2), w_oihw, None if narrow else b,
                     tuple(stride), tuple(padding)).permute(0, 2, 3, 1)
    if narrow:
        y = y + b
    return act_forward(activation, y.contiguous())


def conv2d_space_to_depth(x: torch.Tensor, w: torch.Tensor, b_: int,
                          padding: Tuple[int, int],
                          bias: Optional[torch.Tensor] = None
                          ) -> torch.Tensor:
    """The stride-`b_` convolution of NHWC `x` by HWIO `w` rewritten as a
    stride-1 convolution on space-to-depth packed operands (xla.py
    conv2d_space_to_depth): x padded by `padding`, then with zeros so
    every tap of the kernel padded to multiples of `b_` (zero taps) lies
    inside; both pixel-unshuffled into b_·b_·C channels in (row, column,
    channel) order; `F.conv2d` at stride 1, `bias` added inside it. The
    same sums as the direct convolution in another order; a thin-channel
    stem (AlexNet's cin 3 at stride 4) becomes 48 channels over a 4x
    smaller extent. Returns (N, OH, OW, O), NHWC."""
    n, h, wd, c = x.shape
    kh, kw, _, co = w.shape
    ph, pw = padding
    h, wd = h + 2 * ph, wd + 2 * pw
    oh = (h - kh) // b_ + 1
    ow = (wd - kw) // b_ + 1
    kh2, kw2 = -(-kh // b_) * b_, -(-kw // b_) * b_
    need_h, need_w = (oh - 1) * b_ + kh2, (ow - 1) * b_ + kw2
    # (left, right, top, bottom) of W, then H; C untouched
    x = F.pad(x, (0, 0, pw, pw + max(0, need_w - wd), ph,
                  ph + max(0, need_h - h)))
    w = F.pad(w, (0, 0, 0, 0, 0, kw2 - kw, 0, kh2 - kh))
    hb, wb = need_h // b_, need_w // b_
    xs = x[:, :hb * b_, :wb * b_, :].reshape(n, hb, b_, wb, b_, c)
    xs = xs.permute(0, 1, 3, 2, 4, 5).reshape(n, hb, wb, b_ * b_ * c)
    ws = w.reshape(kh2 // b_, b_, kw2 // b_, b_, c, co)
    ws = ws.permute(0, 2, 1, 3, 4, 5).reshape(kh2 // b_, kw2 // b_,
                                              b_ * b_ * c, co)
    y = F.conv2d(xs.permute(0, 3, 1, 2), conv_weight_oihw(ws), bias)
    return y.permute(0, 2, 3, 1)


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


def maxpool_forward_slices(x: torch.Tensor, ksize: Tuple[int, int],
                           stride: Tuple[int, int], use_abs: bool = False,
                           fold: str = "linear") -> torch.Tensor:
    """Ceil-mode max pooling of NHWC `x` as a max-fold over the ky·kx
    shifted strided slices of the padded input (xla.py
    `maxpool_forward_slices`, the `maxpool` op's `slices` lowering): the
    values of `maxpool_forward`, with a backward of elementwise selects
    instead of the pool's index scatter. The fill is -inf, and 0 for the
    max-abs flavor, whose combine keeps the signed value of the larger
    |x| (the first on a tie). `fold` "linear" combines the slices left to
    right, "tree" pairwise (the template's combine-DAG axis)."""
    if fold not in ("linear", "tree"):
        raise ValueError(f"fold must be 'linear' or 'tree', got {fold!r}")
    ky, kx = ksize
    sy, sx = stride
    _, h, w, _ = x.shape
    oh, ow = pool_out_hw(h, w, ky, kx, sy, sx)
    eh, ew = (oh - 1) * sy + ky - h, (ow - 1) * sx + kx - w
    xp = F.pad(x, (0, 0, 0, ew, 0, eh),
               value=0.0 if use_abs else float("-inf"))

    def comb(a, b):
        if use_abs:
            return torch.where(a.abs() >= b.abs(), a, b)
        return torch.maximum(a, b)

    slices = [xp[:, dy:dy + (oh - 1) * sy + 1:sy,
                 dx:dx + (ow - 1) * sx + 1:sx, :]
              for dy in range(ky) for dx in range(kx)]
    if fold == "tree":
        while len(slices) > 1:
            slices = [comb(slices[i], slices[i + 1])
                      if i + 1 < len(slices) else slices[i]
                      for i in range(0, len(slices), 2)]
        return slices[0].contiguous()
    out = slices[0]
    for t in slices[1:]:
        out = comb(out, t)
    return out.contiguous()


def maxpool_forward_with_idx(x: torch.Tensor, ksize: Tuple[int, int],
                             stride: Tuple[int, int], use_abs: bool = False
                             ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Ceil-mode max pooling of NHWC `x` that also records each window's
    winner as a flat offset into x: the rule of the JAX package's
    `maxpool_forward_with_idx` (xla.py:283-308), an argmax — the FIRST
    maximum in row-major window order (dy, then dx), where the padded
    slots never win. After a ReLU windows tie constantly (all zeros), so
    the rule is computed here, not taken from `F.max_pool2d`'s indices,
    which promise no order. `use_abs` (MaxAbsPooling) ranks by |x| and
    keeps the winner's signed value, gathered from x, so autograd routes
    the gradient to the winner (the JAX fused step's max-abs lowering).
    Offsets are int64, ((n·H + i·sy + dy)·W + j·sx + dx)·C + c (xla.py
    `_flat_offsets`)."""
    ky, kx = ksize
    nb, h, w, c = x.shape
    taps = _pool_taps(x.abs() if use_abs else x, ksize, stride,
                      float("-inf"))
    y = taps[0]
    for t in taps[1:]:
        y = torch.maximum(y, t)
    # the first tap equal to the maximum, scanning backwards so that the
    # earliest one is written last (every window's tap 0 is a real pixel)
    choice = torch.zeros(y.shape, dtype=torch.int64, device=x.device)
    for lin in reversed(range(len(taps))):
        choice = torch.where(taps[lin] == y, lin, choice)
    oh, ow = y.shape[1], y.shape[2]
    idx = _flat_offsets(choice, nb, h, w, c, oh, ow, stride, kx, x.device)
    if use_abs:
        return x.reshape(-1)[idx], idx
    return y.contiguous(), idx


def pool_scatter(err_y: torch.Tensor, idx: torch.Tensor,
                 x_shape: Tuple[int, ...]) -> torch.Tensor:
    """The backward of the pooling flavors that record winners (max,
    max-abs, stochastic; xla.py pool_scatter): each window's gradient
    added at its recorded winner, overlapping windows that share a winner
    summing; out-of-range sentinel offsets (x.size: a stochastic window
    with nothing positive) drop, as `mode="drop"` drops them there."""
    size = math.prod(x_shape)
    idx, err = idx.reshape(-1), err_y.reshape(-1)
    live = idx < size
    flat = torch.zeros(size, dtype=err_y.dtype, device=err_y.device)
    flat.index_add_(0, torch.where(live, idx, 0),
                    torch.where(live, err, torch.zeros_like(err)))
    return flat.reshape(x_shape)


def _pool_taps(x: torch.Tensor, ksize: Tuple[int, int],
               stride: Tuple[int, int], fill: float):
    """The ky·kx strided views of NHWC `x` padded with `fill` to whole
    windows at the bottom/right edge, in row-major window order (dy,
    then dx), each (N, OH, OW, C)."""
    ky, kx = ksize
    sy, sx = stride
    _, h, w, _ = x.shape
    oh, ow = pool_out_hw(h, w, ky, kx, sy, sx)
    hp, wp = (oh - 1) * sy + ky, (ow - 1) * sx + kx
    xp = F.pad(x, (0, 0, 0, wp - w, 0, hp - h), value=fill)
    return [xp[:, dy:dy + (oh - 1) * sy + 1:sy, dx:dx + (ow - 1) * sx + 1:sx]
            for dy in range(ky) for dx in range(kx)]


def _window_counts(h: int, w: int, ksize: Tuple[int, int],
                   stride: Tuple[int, int], device) -> torch.Tensor:
    """(OH, OW, 1) real pixels in each ceil-mode window (edge windows
    truncate), as f32."""
    ky, kx = ksize
    sy, sx = stride
    oh, ow = pool_out_hw(h, w, ky, kx, sy, sx)
    rows = torch.clamp(h - torch.arange(oh, device=device) * sy, max=ky)
    cols = torch.clamp(w - torch.arange(ow, device=device) * sx, max=kx)
    return (rows[:, None] * cols[None, :]).to(torch.float32)[..., None]


def avgpool_forward(x: torch.Tensor, ksize: Tuple[int, int],
                    stride: Tuple[int, int]) -> torch.Tensor:
    """Ceil-mode average pooling of NHWC `x`: each window's sum over its
    real pixels divided by their count, so edge windows average only what
    they cover (xla.py avgpool_forward; golden reference.avgpool_forward).
    Differentiable: the fused step's backward is its autograd."""
    _, h, w, _ = x.shape
    taps = _pool_taps(x, ksize, stride, 0.0)
    ssum = taps[0]
    for t in taps[1:]:
        ssum = ssum + t
    return ssum / _window_counts(h, w, ksize, stride, x.device).to(x.dtype)


def avgpool_backward(err_y: torch.Tensor, x_shape: Tuple[int, ...],
                     ksize: Tuple[int, int],
                     stride: Tuple[int, int]) -> torch.Tensor:
    """The average pooling's backward (golden reference.avgpool_backward):
    each window's error divided by its pixel count and added to every
    pixel it covers; overlapping windows sum."""
    ky, kx = ksize
    sy, sx = stride
    nb, h, w, c = x_shape
    oh, ow = pool_out_hw(h, w, ky, kx, sy, sx)
    hp, wp = (oh - 1) * sy + ky, (ow - 1) * sx + kx
    g = err_y / _window_counts(h, w, ksize, stride,
                               err_y.device).to(err_y.dtype)
    out = torch.zeros((nb, hp, wp, c), dtype=err_y.dtype,
                      device=err_y.device)
    for dy in range(ky):
        for dx in range(kx):
            out[:, dy:dy + (oh - 1) * sy + 1:sy,
                dx:dx + (ow - 1) * sx + 1:sx] += g
    return out[:, :h, :w, :].contiguous()


def gumbel_noise(shape, generator: torch.Generator, device,
                 dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """−log(−log u), u uniform in (0, 1) from `generator`: stochastic
    pooling's Gumbel draw (jax.random.gumbel's distribution)."""
    u = torch.rand(shape, generator=generator, device=device)
    tiny = torch.finfo(torch.float32).tiny
    return (-torch.log(-torch.log(torch.clamp(u, min=tiny)))).to(dtype)


def stochastic_pool_forward_with_idx(
        x: torch.Tensor, ksize: Tuple[int, int], stride: Tuple[int, int],
        generator: Optional[torch.Generator] = None,
        noise: Optional[torch.Tensor] = None
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Stochastic pooling (Zeiler & Fergus; xla.py
    stochastic_pool_forward_with_idx): each ceil-mode window picks one of
    its elements with probability proportional to its positive part, by
    Gumbel-max over log-probabilities (padded slots and non-positive
    elements have probability 0). A window with nothing positive gives 0
    and the sentinel offset x.numel(), which `pool_scatter` drops.
    `noise` (N, OH, OW, C, ky·kx), window order (dy, then dx) last, is the
    Gumbel draw — a test hands in the JAX function's own
    `jax.random.gumbel` — else −log(−log u), u uniform in (0, 1) from
    `generator` (jax.random.gumbel's distribution, not its bits).
    Returns (y, flat winner offsets into x, int64)."""
    ky, kx = ksize
    sy, sx = stride
    nb, h, w, c = x.shape
    p = torch.stack(_pool_taps(x, ksize, stride, 0.0), dim=-1)
    oh, ow = p.shape[1], p.shape[2]
    pos = torch.clamp(p, min=0.0)
    tot = pos.sum(-1, keepdim=True)
    zero = torch.zeros((), dtype=p.dtype, device=p.device)
    probs = torch.where(tot > 0, pos / torch.clamp(tot, min=1e-30), zero)
    if noise is None:
        if generator is None:
            raise ValueError("stochastic pooling needs a generator or the "
                             "noise")
        noise = gumbel_noise(p.shape, generator, x.device, p.dtype)
    logp = torch.where(probs > 0, torch.log(torch.clamp(probs, min=1e-30)),
                       torch.full((), float("-inf"), dtype=p.dtype,
                                  device=p.device))
    choice = _first_argmax(logp + noise)
    picked = p.gather(-1, choice[..., None])[..., 0]
    alive = tot[..., 0] > 0
    y = torch.where(alive, picked, zero)
    idx = _flat_offsets(choice, nb, h, w, c, oh, ow, stride, kx, x.device)
    return y, torch.where(alive, idx, x.numel())


def _first_argmax(a: torch.Tensor) -> torch.Tensor:
    """Index of the FIRST maximum along the last axis (jnp.argmax's
    rule; torch.argmax promises no tie order). A row of −inf gives 0."""
    m = a.max(dim=-1, keepdim=True).values
    n = a.shape[-1]
    lin = torch.arange(n, device=a.device).expand(a.shape)
    return torch.where(a == m, lin, n).min(dim=-1).values.clamp(max=n - 1)


def _flat_offsets(choice: torch.Tensor, nb: int, h: int, w: int, c: int,
                  oh: int, ow: int, stride: Tuple[int, int], kx: int,
                  device) -> torch.Tensor:
    """Flat offsets into an (N, H, W, C) input of each window's winner
    `choice` (its index in window order): ((n·H + i·sy + dy)·W + j·sx +
    dx)·C + c, xla.py `_flat_offsets`."""
    sy, sx = stride
    dy, dx = choice // kx, choice % kx
    ar = functools.partial(torch.arange, device=device)
    ii = ar(oh)[None, :, None, None] * sy + dy
    jj = ar(ow)[None, None, :, None] * sx + dx
    nn_ = ar(nb)[:, None, None, None]
    cc = ar(c)[None, None, None, :]
    return ((nn_ * h + ii) * w + jj) * c + cc


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
        t = sqrt(torch.rsqrt(s))
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


def _lrn_band(c: int, n: int, dtype: torch.dtype,
              device: torch.device) -> torch.Tensor:
    """(C, C) 0/1 band: band[i, j] = |i − j| <= n//2 (xla.py `_lrn_band`)."""
    i = torch.arange(c, device=device)
    return ((i[:, None] - i[None, :]).abs() <= n // 2).to(dtype)


def lrn_window_sum_banded(a: torch.Tensor, n: int) -> torch.Tensor:
    """The ±n//2 window sum as a banded matmul, a @ band, accumulated in
    at least f32 and rounded back to a's dtype (xla.py
    `_lrn_window_sum`); shifted adds above 4096 channels, as there."""
    c = a.shape[-1]
    if c > 4096:
        return lrn_window_sum(a, n)
    acc = a.dtype if a.dtype in (torch.float32, torch.float64) \
        else torch.float32
    return torch.matmul(a.to(acc),
                        _lrn_band(c, n, acc, a.device)).to(a.dtype)


class BandedLRNFunction(torch.autograd.Function):
    """The `lrn` op's banded-matmul lowerings (xla.py `lrn_forward`'s two
    custom VJPs), computed in x's dtype as there: y = x·s^(−β) with
    s = k + α·W(x²); the closed-form backward g·d − 2αβ·x·W(g·x·d/s).
    `cache` False recomputes s and d from x (`banded_matmul`), True keeps
    them from the forward (`cached_residual`)."""

    @staticmethod
    def forward(ctx, x, k, alpha, beta, n, cache):
        s = k + alpha * lrn_window_sum_banded(x * x, n)
        d = pow_neg_quarters(s, beta)
        ctx.save_for_backward(*((x, d, s) if cache else (x,)))
        ctx.hyper = (k, alpha, beta, n)
        return x * d

    @staticmethod
    def backward(ctx, g):
        k, alpha, beta, n = ctx.hyper
        if len(ctx.saved_tensors) == 3:
            x, d, s = ctx.saved_tensors
        else:
            (x,) = ctx.saved_tensors
            s = k + alpha * lrn_window_sum_banded(x * x, n)
            d = pow_neg_quarters(s, beta)
        core = lrn_window_sum_banded(g * x * d / s, n)
        return (g * d - (2.0 * alpha * beta) * x * core,) + (None,) * 5


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


def confusion(labels: torch.Tensor, pred: torch.Tensor, n_classes: int,
              weights: Optional[torch.Tensor] = None) -> torch.Tensor:
    """(C, C) int64 confusion counts, true class by row and predicted by
    column; a row of weight 0 (the Loader's pad mask) counts nothing
    (xla.py softmax_ce's `confusion`, exact integers)."""
    inc = (torch.ones_like(labels, dtype=torch.int64) if weights is None
           else (weights > 0).to(torch.int64))
    flat = labels.long() * n_classes + pred.long()
    out = torch.zeros(n_classes * n_classes, dtype=torch.int64,
                      device=labels.device)
    out.index_add_(0, flat.reshape(-1), inc.reshape(-1))
    return out.reshape(n_classes, n_classes)


def softmax_ce(probs: torch.Tensor, labels: torch.Tensor, n_classes: int,
               weights: Optional[torch.Tensor] = None):
    """The granular softmax evaluator's metrics (xla.py softmax_ce): from
    probabilities and integer labels, (loss, err wrt the logits, n_err,
    confusion). `weights` (N,) are the Loader's pad mask: zero-weight rows
    add to no metric and get no gradient; err is (probs − onehot)·w /
    Σw."""
    onehot = F.one_hot(labels.long(), n_classes).to(probs.dtype)
    eps = torch.finfo(probs.dtype).tiny
    picked = probs.gather(1, labels.long()[:, None])[:, 0]
    logs = -torch.log(torch.clamp(picked, min=eps))
    pred = probs.argmax(dim=1)
    wrong = pred != labels
    conf = confusion(labels, pred, n_classes, weights)
    if weights is None:
        return (logs.mean(), (probs - onehot) / probs.shape[0],
                wrong.sum(), conf)
    w = weights.to(probs.dtype)
    wsum = torch.clamp(w.sum(), min=eps)
    return ((logs * w).sum() / wsum, (probs - onehot) * w[:, None] / wsum,
            (wrong & (w > 0)).sum(), conf)


def mse(y: torch.Tensor, target: torch.Tensor,
        weights: Optional[torch.Tensor] = None,
        denom: Optional[torch.Tensor] = None):
    """(the MSE evaluator's loss, err wrt y), xla.py mse: the per-sample
    summed squared error over the batch, Σ w·(y − t)² / max(denom, 1e-9)
    with denom defaulting to Σ w (the plain sum over N without weights),
    and its derivative 2·(y − t)·w / denom."""
    n = y.shape[0]
    diff = y - target
    if weights is None:
        return (diff * diff).sum() / n, 2.0 * diff / n
    wb = weights.to(y.dtype).reshape((n,) + (1,) * (y.dim() - 1))
    d = weights.to(y.dtype).sum() if denom is None else denom
    d = torch.clamp(d, min=1e-9)
    return (wb * diff * diff).sum() / d, 2.0 * diff * wb / d


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
