"""Attention ops: the single-device reference.

The port's counterpart of `mha_forward` and `NEG_INF` in
`veles_tpu/ops/attention.py` (attention.py:33-49 there): q, k, v in the
(B, S, H, D) layout, scores masked to −1e30 above the causal diagonal, a
softmax over the keys. It is the `flash_attn` registry op's `mha`
lowering (the counterpart of `xla_mha`) and the golden the blocked
kernels are held against. Ring and Ulysses attention, which shard the
sequence over several cards, come with the many-GPU slice.

Dtypes follow the JAX function's promotion: its default scale
`1.0 / np.sqrt(d)` is a numpy float64, a strongly typed scalar, so bf16
scores (rounded to bf16 by the einsum) are promoted to f32 before the
scale multiplies them, the softmax runs in f32, and the second einsum
takes v promoted to f32: bf16 q, k, v give an f32 output. An explicit
`scale` is a weakly typed Python float there and keeps the input dtype.
"""

from __future__ import annotations

import math
from typing import Optional

import torch

NEG_INF = -1e30


def mha_forward(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                scale: Optional[float] = None,
                causal: bool = False) -> torch.Tensor:
    """Plain multi-head attention. q/k/v: (B, S, H, D) -> (B, S, H, D),
    differentiable by autograd."""
    s = torch.einsum("bqhd,bkhd->bhqk", q, k)
    if scale is None:
        s = s.to(torch.promote_types(s.dtype, torch.float32))
        scale = 1.0 / math.sqrt(q.shape[-1])
    s = s * scale
    if causal:
        keep = torch.ones(q.shape[1], k.shape[1], dtype=torch.bool,
                          device=q.device).tril()
        s = torch.where(keep, s, torch.full((), NEG_INF, dtype=s.dtype,
                                            device=s.device))
    p = torch.softmax(s, dim=-1)
    return torch.einsum("bhqk,bkhd->bqhd", p,
                        v.to(torch.promote_types(p.dtype, v.dtype)))
