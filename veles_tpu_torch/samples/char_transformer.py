"""Character-transformer language model.

The port's counterpart of `veles_tpu/samples/char_transformer.py`, with
the same `root.char_transformer` defaults and layer list: one-hot chars
-> SeqLinear embed (+ learned positions) -> causal MultiHeadAttention
(residual) -> SeqFFN (residual, scaled tanh) -> per-token SeqSoftmax(V),
embed 64, 4 heads, ffn 128, minibatch 32, SGD lr 0.2 with momentum 0.9.

Train it: `python -m veles_tpu_torch
veles_tpu_torch/samples/char_transformer.py [--fused] [--device cpu]
[-r SEED] [root.char_transformer.loader.seq_len=4096 ...]`, through the
fused step with `--fused`, else through the granular Unit/Workflow graph
(`-b torch`, the default, or `-b numpy`). At the default seq_len 32 the
attention runs the einsum `mha` path; at seq_len 4096 (S >= 4096,
S % 128 == 0, the attention unit's flash gate) it runs K6 forward and K7
backward, in the granular graph K6 in the attention unit's firing and K6
and K7 in its gradient unit's vjp. `root.char_transformer.moe_experts=N`
(N > 0) replaces the FFN with an N-expert token-routed switch MoE
(znicz/moe.py; hidden `ffn`, residual, capacity factor
`moe_capacity_factor`), which the data-parallel step can shard over its
ranks (`-l/-m --ep`). Dense or MoE, the gspmd step trains it under
tensor parallelism over K ranks (`-l/-m --tp K`: the attention's heads,
the embed and the head split, parallel/tp.py). The sequence-parallel
modes (`parallel_mode` "ring" / "ulysses") come with the many-GPU
slice.
"""

from __future__ import annotations

from typing import Optional

from veles_tpu_torch.config import root
from veles_tpu_torch.loader.text import CharSequenceLoader
from veles_tpu_torch.znicz.standard_workflow import StandardWorkflow

root.char_transformer.loader.minibatch_size = 32
root.char_transformer.loader.seq_len = 32
root.char_transformer.loader.n_validation = 40
root.char_transformer.embed = 64
root.char_transformer.n_heads = 4
root.char_transformer.ffn = 128
root.char_transformer.parallel_mode = "local"  # | "ring" | "ulysses"
#: 0 = dense SeqFFN; N = replace it with an N-expert token-routed MoE
root.char_transformer.moe_experts = 0
#: per-expert slot budget (capacity = factor x tokens / experts); raise
#: it to the expert count for zero-drop runs
root.char_transformer.moe_capacity_factor = 2.0
root.char_transformer.decision.max_epochs = 5
root.char_transformer.decision.fail_iterations = 20
root.char_transformer.gd.learning_rate = 0.2
root.char_transformer.gd.gradient_moment = 0.9


class CharTransformerWorkflow(StandardWorkflow):
    """embed → causal attention → FFN → per-token softmax(V)."""


def create_workflow(text: Optional[str] = None) -> CharTransformerWorkflow:
    cfg = root.char_transformer
    loader = CharSequenceLoader(
        text=text, seq_len=cfg.loader.seq_len,
        n_validation=cfg.loader.n_validation,
        minibatch_size=cfg.loader.minibatch_size)
    e = cfg.embed
    if cfg.moe_experts:
        ffn = {"type": "moe", "n_experts": cfg.moe_experts,
               "hidden": cfg.ffn, "residual": True,
               "capacity_factor": float(cfg.moe_capacity_factor),
               "weights_stddev": 0.05}
    else:
        ffn = {"type": "seq_ffn", "hidden": cfg.ffn, "activation": "tanh",
               "weights_stddev": 0.05}
    return CharTransformerWorkflow(
        layers=[
            {"type": "seq_linear", "output_features": e,
             "pos_embed": True, "weights_stddev": 0.05},
            {"type": "attention", "n_heads": cfg.n_heads, "causal": True,
             "residual": True, "parallel_mode": cfg.parallel_mode,
             "weights_stddev": 0.05},
            ffn,
            {"type": "seq_softmax", "output_features": loader.n_vocab,
             "weights_stddev": 0.05},
        ],
        loader=loader, loss="softmax", n_classes=loader.n_vocab,
        decision_config=cfg.decision.to_dict(),
        gd_config=cfg.gd.to_dict(),
        name="CharTransformerWorkflow")


def run(load, main):
    load(create_workflow)
    main()
