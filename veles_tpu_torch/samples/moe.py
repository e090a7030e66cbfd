"""Mixture-of-experts classifier sample: a switch-style top-1 MoE FFN
between two dense layers, All2AllTanh(64) -> MoE(8 experts, hidden 128)
-> Softmax(8), on the synthetic classifier set.

The port's counterpart of `veles_tpu/samples/moe.py`, with its layer
list and `root.moe` defaults. It trains dense-local through the granular
graph or the fused step, and expert-parallel in the data-parallel fused
step, each rank holding 8/R of the experts: `build_fused_step(mesh=...,
ep=True)` / `run_fused(mesh=..., ep=True)`, or the CLI's `-l/-m --ep`;
and tensor-parallel in the gspmd step (`-l/-m --tp K`: every MoE leaf
on its last dim, parallel/tp.py).

Train it: `python -m veles_tpu_torch veles_tpu_torch/samples/moe.py
[--fused | --pp M] [-b torch|numpy] [--device cpu] [-r SEED]
[root.moe.x=y ...]`; expert-parallel over two processes on the CPU:
`... --device cpu -l 127.0.0.1:P --process-id 0 --n-processes 2 --ep`
and the same with `-m 127.0.0.1:P --process-id 1`.
"""

from __future__ import annotations

from veles_tpu_torch.config import root
from veles_tpu_torch.loader.synthetic import SyntheticClassifierLoader
from veles_tpu_torch.znicz.standard_workflow import StandardWorkflow

root.moe.loader.minibatch_size = 64
root.moe.loader.n_validation = 256
root.moe.loader.n_train = 1024
root.moe.loader.n_classes = 8
root.moe.layers = [
    {"type": "all2all_tanh", "output_sample_shape": 64,
     "weights_stddev": 0.1},
    {"type": "moe", "n_experts": 8, "hidden": 128,
     "capacity_factor": 2.0, "weights_stddev": 0.1},
    {"type": "softmax", "output_sample_shape": 8, "weights_stddev": 0.05},
]
root.moe.decision.max_epochs = 8
root.moe.decision.fail_iterations = 50
root.moe.gd.learning_rate = 0.05
root.moe.gd.gradient_moment = 0.9


class MoEWorkflow(StandardWorkflow):
    """All2AllTanh(64) -> MoE(8 experts, hidden 128) -> Softmax(8)."""


def create_workflow() -> MoEWorkflow:
    cfg = root.moe.loader
    loader = SyntheticClassifierLoader(
        n_classes=cfg.n_classes, sample_shape=(32,),
        n_validation=cfg.n_validation, n_train=cfg.n_train,
        minibatch_size=cfg.minibatch_size, noise=0.4)
    return MoEWorkflow(
        layers=root.moe.layers,
        loader=loader, loss="softmax", n_classes=cfg.n_classes,
        decision_config=root.moe.decision.to_dict(),
        gd_config=root.moe.gd.to_dict(),
        name="MoEWorkflow")


def run(load, main):
    load(create_workflow)
    main()
