"""MNIST-style fully connected softmax workflow: configuration 1 of
BASELINE.json, the reference's first sample (`veles/znicz/samples/MNIST`:
All2AllTanh hidden layer → All2AllSoftmax, EvaluatorSoftmax, DecisionGD,
the GD chain).

The port's counterpart of `veles_tpu/samples/mnist.py`, with its layer
list, widths (784 → 100 → 10) and `root.mnist` defaults. It trains on the
deterministic synthetic MNIST-shaped dataset (loader/synthetic.py) unless
`root.mnist.loader.data_path` names a directory holding the IDX files
`train-images-idx3-ubyte.gz` and `train-labels-idx1-ubyte.gz`, which are
read whole and scaled to [-1, 1].

Train it: `python -m veles_tpu_torch veles_tpu_torch/samples/mnist.py
[--fused] [-b torch|numpy] [--device cpu] [-r SEED] [root.mnist.x=y ...]`.
"""

from __future__ import annotations

import gzip
import struct

import numpy as np

from veles_tpu_torch.config import root
from veles_tpu_torch.loader.fullbatch import FullBatchLoader
from veles_tpu_torch.loader.synthetic import SyntheticClassifierLoader
from veles_tpu_torch.znicz.standard_workflow import StandardWorkflow

root.mnist.loader.minibatch_size = 100
root.mnist.loader.n_validation = 200
root.mnist.loader.n_train = 1000
root.mnist.loader.data_path = ""
root.mnist.layers = [
    {"type": "all2all_tanh", "output_sample_shape": 100,
     "weights_stddev": 0.05},
    {"type": "softmax", "output_sample_shape": 10, "weights_stddev": 0.05},
]
root.mnist.decision.max_epochs = 10
root.mnist.decision.fail_iterations = 50
root.mnist.gd.learning_rate = 0.1
root.mnist.gd.gradient_moment = 0.9
root.mnist.gd.weights_decay = 0.0


class MnistWorkflow(StandardWorkflow):
    """All2AllTanh(100) → All2AllSoftmax(10)."""


def read_idx(path: str) -> np.ndarray:
    """An IDX (ubyte) file, gzipped where its name ends in .gz."""
    opener = gzip.open if path.endswith(".gz") else open
    with opener(path, "rb") as f:
        magic, = struct.unpack(">I", f.read(4))
        ndim = magic & 0xFF
        dims = struct.unpack(f">{ndim}I", f.read(4 * ndim))
        return np.frombuffer(f.read(), np.uint8).reshape(dims)


def make_loader(cfg=None) -> FullBatchLoader:
    """The MNIST loader of a config node (default `root.mnist.loader`;
    samples/mnist_simple.py passes its own)."""
    if cfg is None:
        cfg = root.mnist.loader
    if cfg.data_path:
        data = read_idx(f"{cfg.data_path}/train-images-idx3-ubyte.gz")
        labels = read_idx(f"{cfg.data_path}/train-labels-idx1-ubyte.gz")
        x = (data.astype(np.float32) - 127.5) / 127.5
        n_valid = int(cfg.n_validation)
        loader = FullBatchLoader(minibatch_size=cfg.minibatch_size)
        loader.bind_arrays(x, labels.astype(np.int64), 0, n_valid,
                           len(x) - n_valid)
        return loader
    return SyntheticClassifierLoader(
        n_classes=10, sample_shape=(28, 28),
        n_validation=cfg.n_validation, n_train=cfg.n_train,
        minibatch_size=cfg.minibatch_size)


def create_workflow() -> MnistWorkflow:
    return MnistWorkflow(
        layers=root.mnist.layers,
        loader=make_loader(),
        loss="softmax", n_classes=10,
        decision_config=root.mnist.decision.to_dict(),
        gd_config=root.mnist.gd.to_dict(),
        name="MnistWorkflow")


def run(load, main):
    """The reference's module convention: `load` builds the workflow,
    `main` trains it."""
    load(create_workflow)
    main()
