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

`AttentionUnit` is the layer's node in the granular graph (JAX
attention.py:187-244) and `GDMultiHeadAttention` its gradient twin, the
vjp of the same forward (nn_units.GradientDescentVJP): on the torch
backend both follow the flash gate (K6 in the forward firing, K6 and K7
in the twin's differentiation); on the numpy backend `allow_flash=False`
keeps them on the einsum golden, as the JAX unit's `numpy_run` does, so
the host path stays a reference independent of the kernels.

Under the fused step's tensor parallelism (mode "gspmd", parallel/tp.py)
the JAX plan's last-dim rule shards wq, wk, wv on H·D and wo on E
(`fused_apply(..., tp=)`): the rank projects the gathered input onto its
columns of wq, wk and wv, which are its whole heads where the model
group divides the heads (K6 / K7 run on them), else parts of heads that
it all-gathers to run every head; the heads' output is all-gathered for
wo's contraction, and the rank keeps its block of E. The flash gate is
the local one. Ring and Ulysses attention (`parallel_mode` "ring" /
"ulysses") shard the sequence and come with the next many-GPU slice.
"""

from __future__ import annotations

from typing import Any, Dict, Optional

from veles_tpu_torch.ops import attention, templates, variants
from veles_tpu_torch.ops import functional as fn
from veles_tpu_torch.znicz.nn_units import Forward, GradientDescentVJP, \
    VJPForwardUnit, register_gd, register_unit

FLASH_MIN_SEQ = 4096
FLASH_SEQ_MULTIPLE = 128


class MultiHeadAttention(Forward):
    """Self-attention block: (N, S, E) -> (N, S, E), y = x + attn(x) when
    `residual`. Velocities `vel_wq`, `vel_wk`, `vel_wv`, `vel_wo`."""

    variant_op = "flash_attn"
    #: runs its own tensor-parallel rank program (parallel/tp.py)
    tp_program = True

    def __init__(self, n_heads: int = 4, head_dim: Optional[int] = None,
                 causal: bool = True, parallel_mode: str = "local",
                 residual: bool = False, use_flash: str = "auto",
                 **kwargs: Any) -> None:
        super().__init__(**kwargs)
        if parallel_mode != "local":
            raise NotImplementedError(
                f"parallel_mode {parallel_mode!r} shards the sequence over "
                f"several cards: ring and Ulysses attention come with the "
                f"next many-GPU slice (ROADMAP Queue 1 item 1(b)); this one "
                f"runs 'local'")
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

    def variant_signature(self, sample_shape) -> Optional[Dict[str, Any]]:
        """The kernel search's cache-key payload at the per-sample input
        shape (S, E) (JAX attention.py:108-123); None under an override,
        with flash off, or at a sequence the gate keeps out."""
        if self.variant_override is not None or self.use_flash == "off":
            return None
        s, e = sample_shape
        if not self._flash_ok(s):
            return None
        return {"sample_shape": [s, e], "heads": self.n_heads,
                "head_dim": self.head_dim, "causal": self.causal}

    def variant_effective(self, variant=None) -> Optional[str]:
        """The `flash_attn` lowering a call at the unit's sequence length
        runs — `mha` where the gate keeps the kernel out, else `variant`
        (the fused plan's) or the registry's — or None before
        initialize. A winner whose `drop` axis is on reports its drop=0
        twin: this unit feeds the kernel no mask, so that is what runs
        (JAX attention.py:125-146)."""
        if self.seq_len is None:
            return None
        if not self._flash_ok(self.seq_len):
            return "mha"
        name = (variant or variants.resolve(self.variant_op,
                                            unit=self)).name
        if templates.fusion_config(self.variant_op, name) is not None:
            t, cfg = templates.parse_point(self.variant_op, name)
            return t.name({**cfg, t.fuse_axis: 0})
        return name

    def tp_check(self, role, spec, m) -> None:
        """The last-dim rule's program needs wo's E sharded wherever a
        projection is."""
        if role == "lastdim" and not spec["wo"]:
            raise NotImplementedError(
                f"{self.name}: wq, wk, wv sharded with wo replicated "
                f"(E {self.wo.shape[1]} does not divide over {m} ranks)")

    def fused_apply(self, params, x, *, train=False, variant=None,
                    tp=None):
        """`variant`: the `flash_attn` lowering a fused forward resolved at
        build time, taken where the gate admits S; None resolves it now.
        `tp`: this rank's part of the tensor-parallel plan
        (parallel/tp.py UnitRank), None on whole tensors."""
        if tp is not None and tp.role == "lastdim":
            return self._rank_apply(params, x, tp, variant)
        return self.apply_model(params, x, variant=variant)

    def _attend(self, q, k, v, allow_flash=True, variant=None):
        """The heads' output (N, S, h·D) of the projections (N, S, h·D):
        K6 / K7 where the gate admits S, else the einsum golden."""
        n, s, hd = q.shape
        d = self.head_dim
        q, k, v = (t.reshape(n, s, hd // d, d) for t in (q, k, v))
        if allow_flash and self._flash_ok(s):
            v_ = variant or variants.resolve(self.variant_op, unit=self)
            o = v_.apply(q, k, v, causal=self.causal)
        else:
            o = attention.mha_forward(q, k, v, causal=self.causal)
        return o.reshape(n, s, hd)

    def apply_model(self, params, x, allow_flash=True, variant=None):
        """The forward; `allow_flash=False` runs the einsum golden
        whatever the gate says (the numpy backend's)."""
        q, k, v = (fn.matmul(x, params[w]) for w in ("wq", "wk", "wv"))
        # the einsum's output is f32 under bf16 (mha_forward's promotion):
        # so is everything after it, as in the JAX unit
        y = fn.matmul(self._attend(q, k, v, allow_flash, variant),
                      params["wo"])
        return x + y if self.residual else y

    def _rank_apply(self, params, x, tp, variant):
        """The rank's program under the last-dim rule: (N, S, E/m), its
        block of E. wq, wk and wv are sharded alike (one H·D); a
        replicated one (H·D does not divide) passes megatron's f."""
        x = tp.whole(x)
        q, k, v = (fn.matmul(x, params[w] if tp.is_sharded(w)
                             else tp.copy_in(params[w]))
                   for w in ("wq", "wk", "wv"))
        if not tp.is_sharded("wq"):
            o = self._attend(q, k, v, variant=variant)
        elif self.n_heads % tp.m == 0:
            # the rank's whole heads, contiguous in the last dim
            o = tp.gather(self._attend(q, k, v, variant=variant))
        else:
            # heads straddle ranks: every rank runs every head
            o = self._attend(tp.gather(q), tp.gather(k), tp.gather(v),
                             variant=variant)
        y = fn.matmul(o, params["wo"])
        return tp.mine(x) + y if self.residual else y


@register_unit(MultiHeadAttention)
class AttentionUnit(VJPForwardUnit):
    """(N, S, E) -> (N, S, E), one firing per minibatch."""


@register_gd(MultiHeadAttention)
class GDMultiHeadAttention(GradientDescentVJP):
    """The vjp of the attention forward and the update of wq, wk, wv and
    wo (`vel_wq`, `vel_wk`, `vel_wv`, `vel_wo`)."""
