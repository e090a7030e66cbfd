"""The port's command line: `python -m veles_tpu_torch <alexnet.py> --serve
0 --device cpu` serves a toy AlexNet, answers a request over loopback, and
exits cleanly on SIGINT; `--fused` trains it; the two together are
refused."""

import json
import os
import signal
import subprocess
import sys
import threading
import urllib.request
from pathlib import Path

import numpy as np
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


def test_cli_serves_and_stops_on_sigint():
    cmd = [sys.executable, "-m", "veles_tpu_torch",
           "veles_tpu_torch/samples/alexnet.py", "--serve", "0",
           "--device", "cpu", "-r", "5", "--serve-ring", "4",
           "--lrn-maxpool", "composed",
           "root.alexnet.loader.input_hw=67", "root.alexnet.width_mult=0.125",
           "root.alexnet.fc_width=64", "root.alexnet.n_classes=16",
           "root.alexnet.loader.n_train=8",
           "root.alexnet.loader.n_validation=4"]
    env = dict(os.environ, PYTHONPATH=str(REPO))
    proc = subprocess.Popen(cmd, cwd=REPO, env=env, stdout=subprocess.PIPE,
                            stderr=subprocess.PIPE, text=True)
    try:
        lines = []
        reader = threading.Thread(
            target=lambda: lines.append(proc.stdout.readline()),
            daemon=True)
        reader.start()
        reader.join(timeout=120)
        assert lines and lines[0].startswith("SERVING http://"), (
            lines, proc.poll())
        url = lines[0].split()[1]
        x = np.random.RandomState(0).randn(2, 67, 67, 3).tolist()
        req = urllib.request.Request(
            url + "/predict", data=json.dumps({"inputs": x}).encode(),
            method="POST")
        with urllib.request.urlopen(req, timeout=60) as r:
            assert r.status == 200
            resp = json.loads(r.read())
        out = np.asarray(resp["outputs"])
        assert out.shape == (2, 16) and np.isfinite(out).all()
        assert resp["classes"] == out.argmax(axis=1).tolist()
        with urllib.request.urlopen(url + "/info", timeout=60) as r:
            info = json.loads(r.read())
        # the stem and the pools report their lowerings beside the LRN's
        assert info["variants"] == {"lrn": "kernel", "conv_stem": "direct",
                                    "maxpool": "reduce_window"}
        assert info["device"] == "cpu" and info["ring_slots"] == 4
        proc.send_signal(signal.SIGINT)
        assert proc.wait(timeout=60) == 0, proc.stderr.read()[-2000:]
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait(timeout=30)
        proc.stdout.close()
        proc.stderr.close()


TOY = ["root.alexnet.loader.input_hw=67", "root.alexnet.width_mult=0.125",
       "root.alexnet.fc_width=64", "root.alexnet.n_classes=16",
       "root.alexnet.loader.n_train=8", "root.alexnet.loader.n_validation=4",
       "root.alexnet.loader.minibatch_size=4"]


def test_cli_trains_with_fused():
    cmd = [sys.executable, "-m", "veles_tpu_torch",
           "veles_tpu_torch/samples/alexnet.py", "--fused", "--device", "cpu",
           "-r", "1", "--lrn-maxpool", "composed", *TOY,
           "root.alexnet.decision.max_epochs=1"]
    env = dict(os.environ, PYTHONPATH=str(REPO))
    r = subprocess.run(cmd, cwd=REPO, env=env, capture_output=True,
                       text=True, timeout=300)
    assert r.returncode == 0, r.stderr[-2000:]
    line = r.stdout.strip().splitlines()[-1]
    assert line.startswith("TRAINED 1 epochs: loss "), line
    assert "'epoch': 1" in line and "'train_err'" in line


@pytest.mark.parametrize("mode", [["--fused", "--serve", "0"], []])
def test_cli_needs_exactly_one_of_fused_and_serve(mode):
    """Both flags exit 2; neither, once a refusal, now trains through the
    granular unit graph (tests/test_torch_granular_numpy.py holds that
    mode against the JAX package)."""
    cmd = [sys.executable, "-m", "veles_tpu_torch",
           "veles_tpu_torch/samples/alexnet.py", "--device", "cpu", *mode,
           *TOY, *([] if mode else ["root.alexnet.decision.max_epochs=1"])]
    env = dict(os.environ, PYTHONPATH=str(REPO))
    r = subprocess.run(cmd, cwd=REPO, env=env, capture_output=True,
                       text=True, timeout=300)
    if mode:
        assert r.returncode == 2, (r.returncode, r.stderr[-2000:])
        assert "give one of them" in r.stderr
    else:
        assert r.returncode == 0, r.stderr[-2000:]
        assert r.stdout.strip().splitlines()[-1].startswith(
            "TRAINED 1 epochs: loss ")
