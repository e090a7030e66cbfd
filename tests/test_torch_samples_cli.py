"""The samples' command line on the CPU, at the JAX functional tests'
sizes and thresholds: `python -m veles_tpu_torch <sample> --device cpu
-r 1234` for MNIST (tests/test_mnist_functional.py: 500 + 100 rows,
minibatch 50, 3 epochs, at most 20 errors of 100 — strictly below here)
and CIFAR-10 (tests/test_cifar_functional.py: 300 + 100 rows, 4 epochs,
below 30 errors of 100), through the fused step (`--fused`) and the
granular graph on the torch backend (`-b torch`): exit 0 and a TRAINED
line with the epochs asked for and a best validation error below the
threshold. Each run is a subprocess limited to 2 intra-op threads, so
that the suite's workers do not oversubscribe the cores.
"""

import os
import re
import subprocess
import sys
from pathlib import Path

import pytest

REPO = Path(__file__).resolve().parent.parent


@pytest.fixture(autouse=True, scope="module")
def _own_autotune_cache(tmp_path_factory):
    """A plain `--fused` run applies the autotune cache's winners: this
    module's runs read a cache of their own, not one under HOME."""
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("VELES_AUTOTUNE_CACHE",
                  str(tmp_path_factory.mktemp("autotune") / "autotune.json"))
        yield


@pytest.mark.parametrize("sample,node,sizes,threshold", [
    ("mnist", "mnist", {"loader.n_train": 500, "loader.n_validation": 100,
                        "loader.minibatch_size": 50,
                        "decision.max_epochs": 3}, 20),
    ("cifar10", "cifar", {"loader.n_train": 300, "loader.n_validation": 100,
                          "loader.minibatch_size": 50,
                          "decision.max_epochs": 4}, 30)])
@pytest.mark.parametrize("mode", [["--fused"], ["-b", "torch"]])
def test_cli_trains_the_sample(sample, node, sizes, threshold, mode):
    cmd = [sys.executable, "-m", "veles_tpu_torch",
           f"veles_tpu_torch/samples/{sample}.py", "--device", "cpu",
           "-r", "1234", *mode,
           *(f"root.{node}.{k}={v}" for k, v in sizes.items())]
    env = dict(os.environ, OMP_NUM_THREADS="2")
    out = subprocess.run(cmd, cwd=REPO, capture_output=True, text=True,
                         timeout=300, env=env)
    assert out.returncode == 0, out.stderr[-2000:]
    m = re.search(r"TRAINED (\d+) epochs: .* best_err (\S+) ", out.stdout)
    assert m, out.stdout[-2000:]
    assert int(m.group(1)) == sizes["decision.max_epochs"]
    assert float(m.group(2)) < threshold, out.stdout[-2000:]
