"""Convolutional forward units.

The port's counterpart of `veles_tpu/znicz/conv.py`: y = act(conv2d(x, W)
+ b) with x NHWC and W HWIO (ky, kx, cin, n_kernels), symmetric padding
and the bias before the activation. The convolution runs through
`F.conv2d` on a channels-last view; the OIHW copy of the weights it needs
is made once per weight tensor and cached where no gradient is recorded
(serving, evaluation) — a training forward permutes afresh, so that the
copy is part of its autograd graph.

`s2d` ("auto", "on" or "off", JAX conv.py:36-90) picks the
space-to-depth rewrite of a strided convolution
(`functional.conv2d_space_to_depth`: the same sums, a stride-1
convolution over b·b·C channels): "on" forces it (a square stride > 1 is
required), "off" never takes it, and "auto" asks the registry's
`conv_stem` op (`resolve("conv_stem")`, default `direct`) where the
layer is a thin-channel stem — square stride > 1 and fewer than 8 input
channels (`_s2d_applicable`) — and runs the direct convolution
elsewhere. A generated `conv_stem` point (`gen[pack,acc,epi]`,
ops/templates.py) runs whole there: its packing and its accumulator;
its `epi=lrn` claims the LRN unit after the stem in the fused step
(parallel/fused.py), and an unclaimed stem runs and reports the
`epi=none` twin. The fused step and the granular node both run
`fused_apply`, so both follow the choice; the backward is autograd's in
the fused step and gd_conv.py's hand-derived one in the graph, as in the
JAX package. `variant_op` is "conv_stem" (JAX conv.py:35): the fused
plan resolves it for every convolution, and only an auto stem uses it.

`ConvUnit` is the layer's node in the granular graph (JAX conv.py
`numpy_run` / `xla_run`): the numpy golden `reference.conv2d_forward`, or
the same `F.conv2d` forward the fused step runs; its gradient twin is in
gd_conv.py.
"""

from __future__ import annotations

import weakref
from typing import Any, Dict, Optional, Tuple

import torch

from veles_tpu_torch.ops import functional as fn
from veles_tpu_torch.ops import reference as ref
from veles_tpu_torch.ops import templates, variants
from veles_tpu_torch.znicz.nn_units import Forward, ForwardUnit, dev, host, \
    register_unit


class Conv(Forward):
    """y = act(conv2d(x, W) + b); x: (N,H,W,C), W: (ky,kx,C,n_kernels)."""

    activation = "linear"
    variant_op = "conv_stem"

    def __init__(self, n_kernels: int = 16, kx: int = 3, ky: int = 3,
                 stride: Tuple[int, int] = (1, 1),
                 padding: Tuple[int, int] = (0, 0), s2d: str = "auto",
                 **kwargs: Any) -> None:
        super().__init__(**kwargs)
        self.n_kernels = n_kernels
        self.kx = kx
        self.ky = ky
        self.stride = tuple(stride)
        self.padding = tuple(padding)
        if s2d not in ("off", "on", "auto"):
            raise ValueError(f"s2d must be 'off'|'on'|'auto', got {s2d!r}")
        if s2d == "on" and not (self.stride[0] == self.stride[1]
                                and self.stride[0] > 1):
            raise ValueError(
                f"s2d='on' needs a square stride > 1 (got "
                f"{self.stride}): the rewrite repacks stride blocks")
        self.s2d = s2d
        #: (weakref to the HWIO tensor, its version, its device)
        self._oihw_src = None
        self._oihw = None

    def __getstate__(self):
        d = super().__getstate__()
        # the OIHW copy is a cache (a weakref keys it): made again on use
        d["_oihw_src"] = d["_oihw"] = None
        return d

    def output_hw(self, h: int, w: int) -> Tuple[int, int]:
        sy, sx = self.stride
        ph, pw = self.padding
        return ((h + 2 * ph - self.ky) // sy + 1,
                (w + 2 * pw - self.kx) // sx + 1)

    def initialize(self, sample_shape, device):
        h, w, c = sample_shape
        self.init_params((self.ky, self.kx, c, self.n_kernels),
                         self.kx * self.ky * c, device)
        return self.output_hw(h, w) + (self.n_kernels,)

    def _weights_oihw(self, w: torch.Tensor) -> torch.Tensor:
        """F.conv2d's layout of `w`, made once per weight tensor, in-place
        version and device of it. A weight made under inference mode (a
        bf16 step's cast, made anew each call) has no version to key on
        and is not cached."""
        if w.is_inference():
            return fn.conv_weight_oihw(w)
        src = self._oihw_src
        if src is None or src[0]() is not w \
                or src[1:] != (w._version, w.device):
            self._oihw = fn.conv_weight_oihw(w)
            self._oihw_src = (weakref.ref(w), w._version, w.device)
        return self._oihw

    def _s2d_applicable(self, cin: int) -> bool:
        """A square-strided thin-channel stem: where "auto" asks the
        registry."""
        sy, sx = self.stride
        return sy == sx and sy > 1 and cin < 8

    def _use_s2d(self, cin: int, variant=None) -> bool:
        """Whether the convolution packs space to depth: the knob, or
        for an auto stem the `conv_stem` lowering's packing (`variant`:
        the fused plan's; None resolves it now)."""
        if self.s2d != "auto":
            return self.s2d == "on"
        if not self._s2d_applicable(cin):
            return False
        name = (variant or variants.resolve("conv_stem", unit=self)).name
        parsed = templates.parse_point("conv_stem", name)
        return parsed[1]["pack"] == "s2d" if parsed else name == "s2d"

    def variant_signature(self, sample_shape) -> Optional[Dict[str, Any]]:
        """The kernel search's cache-key payload at the per-sample input
        shape (JAX conv.py:121-133): only an auto stem is tunable."""
        if self.s2d != "auto" or not self._s2d_applicable(sample_shape[-1]):
            return None
        return {"sample_shape": list(sample_shape), "dtype": "float32",
                "params": {"n_kernels": self.n_kernels, "kx": self.kx,
                           "ky": self.ky, "stride": list(self.stride),
                           "padding": list(self.padding),
                           "activation": self.activation}}

    def variant_effective(self, variant=None) -> Optional[str]:
        """The `conv_stem` lowering this layer runs, for the fused
        step's variant table (JAX conv.py:93-119): the knob's where it is
        "on" or "off", None where an auto layer is no stem, and for an
        `epi=lrn` point its `epi=none` twin (an unclaimed stem gets no
        epilogue: the fused step reports a claimed pair itself)."""
        if self.s2d != "auto":
            return "s2d" if self.s2d == "on" else "direct"
        if self.weights is None or not self._s2d_applicable(
                self.weights.shape[2]):
            return None
        name = (variant or variants.resolve("conv_stem", unit=self)).name
        if templates.fusion_config("conv_stem", name) is not None:
            t, cfg = templates.parse_point("conv_stem", name)
            return t.name({**cfg, t.fuse_axis: "none"})
        return name

    def fused_apply(self, params, x, *, train=False, variant=None,
                    reduce=None):
        """`variant`: the `conv_stem` lowering the fused forward
        resolved at build time (used only where the layer is an auto
        stem); None resolves it now. `reduce`: tensor parallelism's
        row-parallel sum (parallel/tp.py), applied to the convolution of
        this rank's input channels before the bias and the activation."""
        w, b = params["weights"], params["bias"]
        if reduce is None:
            return self._conv(x, w, b, self.activation, variant)
        y = reduce(self._conv(x, w, torch.zeros_like(b), "linear", variant))
        return fn.act_forward(self.activation, y + b)

    def _conv(self, x, w, b, activation, variant):
        """act(conv2d(x, w) + b) through the layer's lowering."""
        if self.s2d == "auto" and self._s2d_applicable(x.shape[-1]):
            v = variant or variants.resolve("conv_stem", unit=self)
            if v.generated:
                return v.apply(x, w, b, self.stride, self.padding,
                               activation)
            variant = v
        if self._use_s2d(x.shape[-1], variant):
            return fn.conv2d_forward(x, w, b, self.stride, self.padding,
                                     activation, s2d=True)
        return fn.conv2d_forward(
            x, w, b, self.stride, self.padding, activation,
            w_oihw=None if torch.is_grad_enabled() else self._weights_oihw(w))


class ConvTanh(Conv):
    activation = "tanh"


class ConvRELU(Conv):
    activation = "relu"


class ConvStrictRELU(Conv):
    activation = "strictrelu"


class ConvSigmoid(Conv):
    activation = "sigmoid"


@register_unit(Conv)
class ConvUnit(ForwardUnit):
    """y = act(conv2d(x, W) + b) of the layer, one firing per minibatch."""

    def numpy_run(self) -> None:
        c = self.layer
        self.output.mem = ref.conv2d_forward(
            host(self.input), self.weights.mem, self.bias.mem, c.stride,
            c.padding, c.activation)

    def torch_run(self) -> None:
        c = self.layer
        x = dev(self.input, self.device)
        self.output.set_devmem(c.fused_apply(c.param_arrays(), x))
