"""CIFAR-10-style convolutional workflow: configuration 2 of
BASELINE.json, the reference's `veles/znicz/samples/CIFAR10` — conv →
max pool → LRN → conv → average pool → FC → softmax.

The port's counterpart of `veles_tpu/samples/cifar10.py`, with its layer
list, widths (two convolutions of 32 5×5 kernels, FC 64, softmax 10) and
`root.cifar` defaults. Its LRN follows a max pool and precedes a
convolution, so it never fuses with a pooling: on the card it runs K2
forward and K3 backward in both modes. It trains on the synthetic
CIFAR-shaped dataset unless `root.cifar.loader.data_path` names a
`cifar-10-batches-py` directory (the pickled `data_batch_*` files, read
whole and scaled to [-1, 1]).

Train it: `python -m veles_tpu_torch veles_tpu_torch/samples/cifar10.py
[--fused] [-b torch|numpy] [--device cpu] [-r SEED] [root.cifar.x=y ...]`.
"""

from __future__ import annotations

import os
import pickle

import numpy as np

from veles_tpu_torch.config import root
from veles_tpu_torch.loader.fullbatch import FullBatchLoader
from veles_tpu_torch.loader.synthetic import SyntheticClassifierLoader
from veles_tpu_torch.znicz.standard_workflow import StandardWorkflow

root.cifar.loader.minibatch_size = 100
root.cifar.loader.n_validation = 400
root.cifar.loader.n_train = 2000
root.cifar.loader.data_path = ""
root.cifar.layers = [
    {"type": "conv_strictrelu", "n_kernels": 32, "kx": 5, "ky": 5,
     "padding": (2, 2), "weights_stddev": 0.05},
    {"type": "max_pooling", "ksize": (2, 2)},
    {"type": "lrn"},
    {"type": "conv_strictrelu", "n_kernels": 32, "kx": 5, "ky": 5,
     "padding": (2, 2), "weights_stddev": 0.05},
    {"type": "avg_pooling", "ksize": (2, 2)},
    {"type": "all2all_strictrelu", "output_sample_shape": 64,
     "weights_stddev": 0.05},
    {"type": "softmax", "output_sample_shape": 10, "weights_stddev": 0.05},
]
root.cifar.decision.max_epochs = 10
root.cifar.decision.fail_iterations = 50
root.cifar.gd.learning_rate = 0.05
root.cifar.gd.gradient_moment = 0.9
root.cifar.gd.weights_decay = 0.0004


class Cifar10Workflow(StandardWorkflow):
    """conv → pool → LRN → conv → pool → FC → softmax."""


def read_cifar_batches(path: str):
    """(x NHWC in [-1, 1], labels) of every `data_batch_*` file under
    `path`, in name order."""
    xs, ys = [], []
    for name in sorted(os.listdir(path)):
        if not name.startswith("data_batch"):
            continue
        with open(os.path.join(path, name), "rb") as f:
            d = pickle.load(f, encoding="bytes")
        xs.append(np.asarray(d[b"data"], np.uint8))
        ys.append(np.asarray(d[b"labels"], np.int64))
    x = np.concatenate(xs).reshape(-1, 3, 32, 32).transpose(0, 2, 3, 1)
    return (x.astype(np.float32) - 127.5) / 127.5, np.concatenate(ys)


def make_loader() -> FullBatchLoader:
    cfg = root.cifar.loader
    if cfg.data_path:
        x, y = read_cifar_batches(cfg.data_path)
        n_valid = int(cfg.n_validation)
        loader = FullBatchLoader(minibatch_size=cfg.minibatch_size)
        loader.bind_arrays(x, y, 0, n_valid, len(x) - n_valid)
        return loader
    return SyntheticClassifierLoader(
        n_classes=10, sample_shape=(32, 32, 3),
        n_validation=cfg.n_validation, n_train=cfg.n_train,
        minibatch_size=cfg.minibatch_size, noise=0.4)


def create_workflow() -> Cifar10Workflow:
    return Cifar10Workflow(
        layers=root.cifar.layers,
        loader=make_loader(), loss="softmax", n_classes=10,
        decision_config=root.cifar.decision.to_dict(),
        gd_config=root.cifar.gd.to_dict(),
        name="Cifar10Workflow")


def run(load, main):
    load(create_workflow)
    main()
