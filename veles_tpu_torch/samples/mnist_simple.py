"""MnistSimple: the reference's one-matmul MNIST sample
(`veles/znicz/samples/MnistSimple`), a single All2AllSoftmax layer from
the pixels to the class logits, the smallest StandardWorkflow.

The port's counterpart of `veles_tpu/samples/mnist_simple.py`, with its
layer list and `root.mnist_simple` defaults. It shares samples/mnist.py's
loader (synthetic, or the IDX files under
`root.mnist_simple.loader.data_path`).

Train it: `python -m veles_tpu_torch
veles_tpu_torch/samples/mnist_simple.py [--fused] [-b torch|numpy]
[--device cpu] [-r SEED] [root.mnist_simple.x=y ...]`.
"""

from __future__ import annotations

from veles_tpu_torch.config import root
from veles_tpu_torch.samples import mnist
from veles_tpu_torch.znicz.standard_workflow import StandardWorkflow

root.mnist_simple.loader.minibatch_size = 100
root.mnist_simple.loader.n_validation = 200
root.mnist_simple.loader.n_train = 1000
root.mnist_simple.loader.data_path = ""
root.mnist_simple.layers = [
    {"type": "softmax", "output_sample_shape": 10, "weights_stddev": 0.05},
]
root.mnist_simple.decision.max_epochs = 5
root.mnist_simple.decision.fail_iterations = 25
root.mnist_simple.gd.learning_rate = 0.1
root.mnist_simple.gd.gradient_moment = 0.9


class MnistSimpleWorkflow(StandardWorkflow):
    """All2AllSoftmax(10): logistic regression on the pixels."""


def create_workflow() -> MnistSimpleWorkflow:
    cfg = root.mnist_simple
    return MnistSimpleWorkflow(
        layers=cfg.layers,
        loader=mnist.make_loader(cfg.loader),
        loss="softmax", n_classes=10,
        decision_config=cfg.decision.to_dict(),
        gd_config=cfg.gd.to_dict(),
        name="MnistSimpleWorkflow")


def run(load, main):
    load(create_workflow)
    main()
