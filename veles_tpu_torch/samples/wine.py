"""Wine tabular classification: the reference's `veles/znicz/samples/Wine`,
a single softmax layer over the 13 features of the UCI wine dataset.

The port's counterpart of `veles_tpu/samples/wine.py`, with its layer list
and `root.wine` defaults. It reads the classic `wine.data` CSV where
`root.wine.loader.data_path` names it (features standardized, rows
shuffled by the "wine_split" stream), else a synthetic 13-feature
stand-in.

Train it: `python -m veles_tpu_torch veles_tpu_torch/samples/wine.py
[--fused] [-b torch|numpy] [--device cpu] [-r SEED] [root.wine.x=y ...]`.
"""

from __future__ import annotations

import numpy as np

from veles_tpu_torch import prng
from veles_tpu_torch.config import root
from veles_tpu_torch.loader.fullbatch import FullBatchLoader
from veles_tpu_torch.loader.synthetic import SyntheticClassifierLoader
from veles_tpu_torch.znicz.standard_workflow import StandardWorkflow

root.wine.loader.minibatch_size = 30
root.wine.loader.n_validation = 40
root.wine.loader.n_train = 138
root.wine.loader.data_path = ""
root.wine.layers = [
    {"type": "softmax", "output_sample_shape": 3, "weights_stddev": 0.05},
]
root.wine.decision.max_epochs = 50
root.wine.decision.fail_iterations = 50
root.wine.gd.learning_rate = 0.3
root.wine.gd.gradient_moment = 0.9


class WineWorkflow(StandardWorkflow):
    """13 features → softmax(3)."""


def make_loader() -> FullBatchLoader:
    cfg = root.wine.loader
    if cfg.data_path:
        raw = np.loadtxt(cfg.data_path, delimiter=",")
        labels = raw[:, 0].astype(np.int64) - 1   # classes are 1..3
        x = raw[:, 1:].astype(np.float32)
        x = (x - x.mean(0)) / x.std(0)            # standardize features
        n_valid = int(cfg.n_validation)
        perm = prng.get("wine_split").permutation(len(x))
        loader = FullBatchLoader(minibatch_size=cfg.minibatch_size)
        loader.bind_arrays(x[perm], labels[perm], 0, n_valid,
                           len(x) - n_valid)
        return loader
    return SyntheticClassifierLoader(
        n_classes=3, sample_shape=(13,),
        n_validation=cfg.n_validation, n_train=cfg.n_train,
        minibatch_size=cfg.minibatch_size, noise=0.8)


def create_workflow() -> WineWorkflow:
    return WineWorkflow(
        layers=root.wine.layers, loader=make_loader(),
        loss="softmax", n_classes=3,
        decision_config=root.wine.decision.to_dict(),
        gd_config=root.wine.gd.to_dict(), name="WineWorkflow")


def run(load, main):
    load(create_workflow)
    main()
