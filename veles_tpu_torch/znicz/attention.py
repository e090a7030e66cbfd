"""Multi-head self-attention unit, local mode.

The port's counterpart of `MultiHeadAttention` in
`veles_tpu/znicz/attention.py`: input (N, S, E) -> output (N, S, E), with
the parameters wq, wk, wv (E, H·D) and wo (H·D, E), filled in that order
from the same numpy stream, and the options `n_heads`, `head_dim`,
`causal`, `residual` and `use_flash`.

Each call picks its lowering by the flash gate `_flash_ok(S)`: "on"
always takes the registry op `flash_attn` (K6 forward, K7 backward on the
card, through the variant the fused plan resolved), "off" never does,
and "auto" does for S >= 4096 with S % 128 == 0, the sequences at which
the JAX package routes its local path to the Pallas kernel. Elsewhere the
einsum golden `ops/attention.py` `mha_forward` runs. The device plays no
part in the gate: on the CPU the kernel's wrapper takes its plain
version. (The JAX package's "auto" also asks for a TPU, since its kernel
runs nowhere else.) `variant_effective()` reports what a call at the
unit's sequence length runs: `mha` where the gate keeps the kernel out.

Ring and Ulysses attention (`parallel_mode` "ring" / "ulysses") and
megatron tensor parallelism shard over several cards and come with the
many-GPU slice.
"""

from __future__ import annotations

from typing import Any, Dict, Optional

from veles_tpu_torch.ops import attention, variants
from veles_tpu_torch.ops import functional as fn
from veles_tpu_torch.znicz.nn_units import Forward

FLASH_MIN_SEQ = 4096
FLASH_SEQ_MULTIPLE = 128


class MultiHeadAttention(Forward):
    """Self-attention block: (N, S, E) -> (N, S, E), y = x + attn(x) when
    `residual`. Velocities `vel_wq`, `vel_wk`, `vel_wv`, `vel_wo`."""

    variant_op = "flash_attn"

    def __init__(self, n_heads: int = 4, head_dim: Optional[int] = None,
                 causal: bool = True, parallel_mode: str = "local",
                 residual: bool = False, use_flash: str = "auto",
                 **kwargs: Any) -> None:
        super().__init__(**kwargs)
        if parallel_mode != "local":
            raise NotImplementedError(
                f"parallel_mode {parallel_mode!r} shards the sequence over "
                f"several cards: ring and Ulysses attention come with the "
                f"many-GPU slice (ROADMAP Slice 3); this one runs 'local'")
        if use_flash not in ("auto", "on", "off"):
            raise ValueError(f"use_flash must be 'auto', 'on' or 'off', got "
                             f"{use_flash!r}")
        self.n_heads = n_heads
        self.head_dim = head_dim
        self.causal = causal
        self.parallel_mode = parallel_mode
        self.residual = residual
        self.use_flash = use_flash
        self.wq = self.wk = self.wv = self.wo = None
        #: the sequence length the unit was initialized for
        self.seq_len: Optional[int] = None

    def param_arrays(self) -> Dict[str, Any]:
        if self.wq is None:
            return {}
        return {"wq": self.wq, "wk": self.wk, "wv": self.wv, "wo": self.wo}

    def initialize(self, sample_shape, device):
        s, e = sample_shape
        if self.head_dim is None:
            if e % self.n_heads:
                raise ValueError(f"embedding {e} does not split into "
                                 f"{self.n_heads} heads")
            self.head_dim = e // self.n_heads
        hd = self.n_heads * self.head_dim
        if self.wq is None:
            std = self.weights_stddev or self.default_stddev(e)
            self.wq, self.wk, self.wv, self.wo = (
                self._param(self._fill(shape, self.weights_filling, std),
                            device)
                for shape in ((e, hd), (e, hd), (e, hd), (hd, e)))
        self.seq_len = s
        return (s, e)

    def _flash_ok(self, s: int) -> bool:
        if self.use_flash == "off":
            return False
        if self.use_flash == "on":
            return True
        return s >= FLASH_MIN_SEQ and s % FLASH_SEQ_MULTIPLE == 0

    def variant_effective(self, variant=None) -> Optional[str]:
        """The `flash_attn` lowering a call at the unit's sequence length
        runs — `mha` where the gate keeps the kernel out, else `variant`
        (the fused plan's) or the registry's — or None before
        initialize."""
        if self.seq_len is None:
            return None
        if not self._flash_ok(self.seq_len):
            return "mha"
        return (variant or variants.resolve(self.variant_op, unit=self)).name

    def fused_apply(self, params, x, *, train=False, variant=None):
        """`variant`: the `flash_attn` lowering a fused forward resolved at
        build time, taken where the gate admits S; None resolves it now."""
        n, s, _ = x.shape
        d = self.head_dim
        h = params["wq"].shape[1] // d
        q = fn.matmul(x, params["wq"]).reshape(n, s, h, d)
        k = fn.matmul(x, params["wk"]).reshape(n, s, h, d)
        v = fn.matmul(x, params["wv"]).reshape(n, s, h, d)
        if self._flash_ok(s):
            v_ = variant or variants.resolve(self.variant_op, unit=self)
            o = v_.apply(q, k, v, causal=self.causal)
        else:
            o = attention.mha_forward(q, k, v, causal=self.causal)
        # the einsum's output is f32 under bf16 (mha_forward's promotion):
        # so is everything after it, as in the JAX unit
        y = fn.matmul(o.reshape(n, s, h * d), params["wo"])
        return x + y if self.residual else y
