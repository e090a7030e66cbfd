"""ImageNet AlexNet workflow (Krizhevsky et al. 2012, single tower).

The port's counterpart of `veles_tpu/samples/alexnet.py`, with the same
layer list, geometry, `init` modes and `root.alexnet` defaults: 5 conv
blocks with LRN and overlapping 3×3/2 max pooling, two 4096-wide FC
layers with dropout, a 1000-way softmax head, on the deterministic
synthetic ImageNet-shaped dataset, on a packed uint8 memmap dataset
(`root.alexnet.loader.data_path`, a directory holding the `manifest.json`
that loader/memmap.py's `pack_arrays` or `pack_image_dataset` writes),
which the fused loop sends to the card as raw bytes, or on an image tree
(`data_path` a `<root>/<class>/<image>` directory without a manifest,
loader/image.py, `n_validation` images held out), decoded on the host.
`root.alexnet.width_mult` and `root.alexnet.fc_width` (defaults 1.0 and
4096, the JAX package's argument defaults) let a command line cut the
widths for a toy run.

Train it: `python -m veles_tpu_torch veles_tpu_torch/samples/alexnet.py
--fused [--device cpu] [-r SEED] [root.x=y ...]`; serve it: the same with
`--serve PORT` in place of `--fused`. The decision and gradient defaults
are the JAX package's: 10 epochs at most, 10 without improvement, SGD at
lr 0.01 with momentum 0.9 and weight decay 5e-4.
"""

from __future__ import annotations

import os
from typing import Any, Dict, List, Optional

import numpy as np

from veles_tpu_torch.config import root
from veles_tpu_torch.loader.image import ImageDirectoryLoader
from veles_tpu_torch.loader.memmap import MANIFEST, MemmapImageLoader
from veles_tpu_torch.loader.synthetic import SyntheticClassifierLoader
from veles_tpu_torch.znicz.standard_workflow import StandardWorkflow

root.alexnet.loader.minibatch_size = 128
root.alexnet.loader.n_validation = 128
root.alexnet.loader.n_train = 512
root.alexnet.loader.input_hw = 227
root.alexnet.loader.data_path = ""
root.alexnet.n_classes = 1000
root.alexnet.decision.max_epochs = 10
root.alexnet.decision.fail_iterations = 10
root.alexnet.gd.learning_rate = 0.01
root.alexnet.gd.gradient_moment = 0.9
root.alexnet.gd.weights_decay = 0.0005
root.alexnet.width_mult = 1.0
root.alexnet.fc_width = 4096


def alexnet_layers(n_classes: int = 1000, width_mult: float = 1.0,
                   fc_width: int = 4096,
                   init: str = "reference") -> List[Dict[str, Any]]:
    """The Krizhevsky-2012 layer list. init="reference": the fixed
    stddevs (0.01 conv / 0.005 fc); init="scaled": Kaiming √(2/fan_in) for
    the convs and the LeCun fan-in default for the FC tail (for runs at
    width_mult < 1, where the reference stddevs vanish)."""
    if init not in ("reference", "scaled"):
        raise ValueError(f"unknown init {init!r}")
    w = lambda n: max(int(n * width_mult), 1)  # noqa: E731

    def conv_std(kx: int, cin: int, ref: float) -> Optional[float]:
        if init == "reference":
            return ref
        return float(np.sqrt(2.0 / (kx * kx * cin)))

    fc_std = 0.005 if init == "reference" else None
    head_std = 0.01 if init == "reference" else None
    return [
        {"type": "conv_strictrelu", "n_kernels": w(96), "kx": 11, "ky": 11,
         "stride": (4, 4), "padding": (0, 0),
         "weights_stddev": conv_std(11, 3, 0.01)},
        {"type": "norm", "k": 2.0, "alpha": 1e-4, "beta": 0.75, "n": 5},
        {"type": "max_pooling", "ksize": (3, 3), "stride": (2, 2)},
        {"type": "conv_strictrelu", "n_kernels": w(256), "kx": 5, "ky": 5,
         "stride": (1, 1), "padding": (2, 2),
         "weights_stddev": conv_std(5, w(96), 0.01)},
        {"type": "norm", "k": 2.0, "alpha": 1e-4, "beta": 0.75, "n": 5},
        {"type": "max_pooling", "ksize": (3, 3), "stride": (2, 2)},
        {"type": "conv_strictrelu", "n_kernels": w(384), "kx": 3, "ky": 3,
         "stride": (1, 1), "padding": (1, 1),
         "weights_stddev": conv_std(3, w(256), 0.01)},
        {"type": "conv_strictrelu", "n_kernels": w(384), "kx": 3, "ky": 3,
         "stride": (1, 1), "padding": (1, 1),
         "weights_stddev": conv_std(3, w(384), 0.01)},
        {"type": "conv_strictrelu", "n_kernels": w(256), "kx": 3, "ky": 3,
         "stride": (1, 1), "padding": (1, 1),
         "weights_stddev": conv_std(3, w(384), 0.01)},
        {"type": "max_pooling", "ksize": (3, 3), "stride": (2, 2)},
        {"type": "all2all_strictrelu", "output_sample_shape": fc_width,
         "weights_stddev": fc_std},
        {"type": "dropout", "dropout_ratio": 0.5},
        {"type": "all2all_strictrelu", "output_sample_shape": fc_width,
         "weights_stddev": fc_std},
        {"type": "dropout", "dropout_ratio": 0.5},
        {"type": "softmax", "output_sample_shape": n_classes,
         "weights_stddev": head_std},
    ]


class AlexNetWorkflow(StandardWorkflow):
    """loader → 5 conv blocks → FC 4096×2 (dropout) → softmax 1000."""


def create_workflow(minibatch_size: Optional[int] = None,
                    input_hw: Optional[int] = None,
                    n_classes: Optional[int] = None,
                    width_mult: Optional[float] = None,
                    fc_width: Optional[int] = None,
                    n_train: Optional[int] = None,
                    n_validation: Optional[int] = None,
                    init: str = "reference") -> AlexNetWorkflow:
    cfg = root.alexnet
    mb = minibatch_size or cfg.loader.minibatch_size
    hw = input_hw or cfg.loader.input_hw
    nc = n_classes or cfg.n_classes
    data_path = cfg.loader.get("data_path")
    if data_path:
        if os.path.exists(os.path.join(data_path, MANIFEST)):
            # the packed format: pack once, train many times
            loader = MemmapImageLoader(data_path=data_path,
                                       minibatch_size=mb)
        else:
            loader = ImageDirectoryLoader(
                data_path=data_path, size_hw=(hw, hw),
                n_validation=(n_validation if n_validation is not None
                              else cfg.loader.n_validation),
                minibatch_size=mb)
    else:
        loader = SyntheticClassifierLoader(
            n_classes=min(nc, 64),  # prototype count, not the head width
            sample_shape=(hw, hw, 3),
            n_validation=(n_validation if n_validation is not None
                          else cfg.loader.n_validation),
            n_train=n_train if n_train is not None else cfg.loader.n_train,
            minibatch_size=mb, noise=0.5)
    return AlexNetWorkflow(
        layers=alexnet_layers(
            nc, width_mult if width_mult is not None else cfg.width_mult,
            fc_width if fc_width is not None else cfg.fc_width, init=init),
        loader=loader, loss="softmax", n_classes=nc,
        decision_config=cfg.decision.to_dict(),
        gd_config=cfg.gd.to_dict(),
        name="AlexNetWorkflow")


def run(load, main):
    load(create_workflow)
    main()
