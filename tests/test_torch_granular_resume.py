"""Snapshots, exact resume and the supervisor of a granular run, on the
CPU.

- The granular graph's Snapshotter is a unit after the Decision, at the
  end of the pulse's gradient chain, gated on the Decision's `improved`
  (re-derived when a pickle is restored).
- Through the CLI's function (`launcher.train` without `--fused`): the
  toy AlexNet (dropout 0.5) trained 3 epochs without a break against the
  same argv cut at 2 epochs and resumed from its newest snapshot with
  `-s` — on the torch and the numpy backend, and with no validation set
  (the improvement then falls on the last train minibatch of an epoch,
  whose updates the snapshot must hold). The snapshot is one taken
  after train minibatches (the epoch counter past 0, non-zero
  velocities, a dropout stream past its seed's position), and the
  resumed run gives the uninterrupted run's bits: every parameter and
  velocity, the history, the loss, best_validation_err and the epoch
  counter — neither an update, a loader step nor a dropout draw
  repeated or skipped.
- A supervised granular child killed at epoch 3 (`--supervise`,
  VELES_FAULT_PLAN=kill@epoch=3; tests/test_crash_recovery.py:54 and
  tests/test_torch_supervisor.py for the fused run) restarts once from
  a snapshot and ends on the uninterrupted run's TRAINED line.
"""

import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from veles_tpu_torch import launcher, prng
from veles_tpu_torch.config import root
from veles_tpu_torch.snapshotter import Snapshotter

REPO = Path(__file__).resolve().parent.parent

#: the toy AlexNet of tests/test_torch_resume.py, dropout 0.5 as the
#: sample has it, snapshotting (codec none) on every improvement
WORKFLOW_SRC = '''
from veles_tpu_torch.config import root
from veles_tpu_torch.loader.synthetic import SyntheticClassifierLoader
from veles_tpu_torch.samples import alexnet
from veles_tpu_torch.znicz.standard_workflow import StandardWorkflow

root.gres.snapshot_dir = "."
root.gres.max_epochs = 3
root.gres.n_validation = 8

def create_workflow():
    loader = SyntheticClassifierLoader(
        n_classes=16, sample_shape=(67, 67, 3),
        n_validation=root.gres.n_validation, n_train=24, minibatch_size=8,
        noise=0.5)
    return StandardWorkflow(
        layers=alexnet.alexnet_layers(n_classes=16, width_mult=0.125,
                                      fc_width=64, init="scaled"),
        loader=loader, loss="softmax", n_classes=16,
        decision_config={"max_epochs": root.gres.max_epochs,
                         "fail_iterations": 100},
        gd_config={"learning_rate": 0.03, "gradient_moment": 0.9,
                   "weights_decay": 0.0005},
        snapshot_config={"directory": root.gres.snapshot_dir,
                         "prefix": "gres", "compression": ""},
        name="GranularResume")

def run(load, main):
    wf, restored = load(create_workflow)
    if restored:
        wf.decision.max_epochs = root.gres.max_epochs
        wf.decision.complete = False
    main()
'''


@pytest.fixture(autouse=True, scope="module")
def _own_autotune_cache(tmp_path_factory):
    """A plain `--fused` run applies the autotune cache's winners: this
    module's runs read a cache of their own, not one under HOME."""
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("VELES_AUTOTUNE_CACHE",
                  str(tmp_path_factory.mktemp("autotune") / "autotune.json"))
        yield


@pytest.fixture(autouse=True)
def _fresh(monkeypatch):
    monkeypatch.setattr(prng, "_generators", {})
    monkeypatch.setattr(prng, "_base_seed", None)
    saved = root.gres.to_dict()
    yield
    root.gres = saved


def _train(wf_py, snap_dir, epochs, backend, n_validation, *extra):
    return launcher.train([
        str(wf_py), "--device", "cpu", "-r", "11", "-b", backend,
        f"root.gres.snapshot_dir={snap_dir}",
        f"root.gres.max_epochs={epochs}",
        f"root.gres.n_validation={n_validation}", *extra])


def _state(wf):
    n = len(wf.forwards)
    return [{k: (t.detach().clone(), wf.gds[n - 1 - i].velocity(k).clone())
             for k, t in u.param_arrays().items()}
            for i, u in enumerate(wf.forwards)]


def test_snapshotter_is_a_gated_unit_after_the_gradient_chain(tmp_path):
    import pickle
    wf_py = tmp_path / "gres.py"
    wf_py.write_text(WORKFLOW_SRC)
    wf = _train(wf_py, tmp_path, 1, "torch", 8)
    snap = wf.snapshotter
    assert snap in wf.units and snap in wf.gds[-1]._links_to
    assert list(snap._links_from) == [wf.gds[-1]]
    assert snap.run_count >= 1 and os.path.exists(snap.destination)
    for improved in (True, False):
        wf.decision.improved = improved
        assert bool(snap.gate_skip) is not improved
    back = pickle.loads(pickle.dumps(wf))
    back._wire_gates()
    for improved in (True, False):
        back.decision.improved = improved
        assert bool(back.snapshotter.gate_skip) is not improved


@pytest.mark.parametrize("backend, n_validation", [
    ("torch", 8), ("numpy", 8), ("torch", 0)])
def test_resumed_granular_run_gives_the_uninterrupted_runs_bits(
        tmp_path, backend, n_validation):
    wf_py = tmp_path / "gres.py"
    wf_py.write_text(WORKFLOW_SRC)
    (tmp_path / "full").mkdir()
    (tmp_path / "cut").mkdir()
    full = _train(wf_py, tmp_path / "full", 3, backend, n_validation)
    want = _state(full)
    want_run = (full.decision.history, full.evaluator.loss,
                full.decision.best_validation_err,
                full.decision.epoch_number)
    del full
    prng.seed_all(12345)
    _train(wf_py, tmp_path / "cut", 2, backend, n_validation)
    path = Snapshotter.latest(str(tmp_path / "cut"), prefix="gres")
    assert path is not None and Snapshotter.verify(path)
    # a snapshot after train minibatches: trained, with velocities, the
    # dropout stream past its seed's position
    prng.seed_all(999)
    snap = Snapshotter.import_(path)
    assert snap.decision.epoch_number >= 1 and snap.restored
    assert all(g.velocity(k) is not None and g.velocity(k).abs().max() > 0
               for g in snap.gds for k in g._pnames)
    if backend == "torch":
        assert prng.get()._stream_states["cpu"].shape[0] > 0
    del snap
    prng.seed_all(12345)
    resumed = _train(wf_py, tmp_path / "cut", 3, backend, n_validation,
                     "-s", path)
    assert (resumed.decision.history, resumed.evaluator.loss,
            resumed.decision.best_validation_err,
            resumed.decision.epoch_number) == want_run
    for i, (got, exp) in enumerate(zip(_state(resumed), want)):
        for k, (p, v) in got.items():
            assert torch.equal(p, exp[k][0]), (i, k)
            assert torch.equal(v, exp[k][1]), (i, "velocity", k)


# -- the supervisor -----------------------------------------------------------

#: a small granular run that snapshots on every improvement (the
#: supervised workflow of tests/test_torch_supervisor.py)
SUPERVISED_SRC = '''
from veles_tpu_torch.config import root
from veles_tpu_torch.loader.synthetic import SyntheticClassifierLoader
from veles_tpu_torch.znicz.standard_workflow import StandardWorkflow

root.supwf.snapshot_dir = "."
root.supwf.max_epochs = 6

def create_workflow():
    loader = SyntheticClassifierLoader(
        n_classes=4, sample_shape=(10,), n_validation=40, n_train=200,
        minibatch_size=40, noise=0.4)
    return StandardWorkflow(
        layers=[{"type": "all2all_strictrelu", "output_sample_shape": 16,
                 "weights_stddev": 0.1},
                {"type": "dropout", "dropout_ratio": 0.3},
                {"type": "softmax", "output_sample_shape": 4,
                 "weights_stddev": 0.05}],
        loader=loader, loss="softmax", n_classes=4,
        decision_config={"max_epochs": root.supwf.max_epochs,
                         "fail_iterations": 100000},
        gd_config={"learning_rate": 0.05, "gradient_moment": 0.9},
        snapshot_config={"directory": root.supwf.snapshot_dir,
                         "prefix": "supwf", "keep_last": 3},
        name="SupWF")

def run(load, main):
    wf, restored = load(create_workflow)
    if restored:
        wf.decision.max_epochs = root.supwf.max_epochs
        wf.decision.complete = False
    main()
'''


def _env(fault_plan=""):
    env = dict(os.environ, PYTHONPATH=str(REPO))
    for k in ("VELES_FAULT_STATE", "VELES_HEARTBEAT_FILE",
              "VELES_FAULT_PLAN"):
        env.pop(k, None)
    if fault_plan:
        env["VELES_FAULT_PLAN"] = fault_plan
    return env


def _cmd(d, *extra):
    wf_py = d / "supwf.py"
    wf_py.write_text(SUPERVISED_SRC)
    return [sys.executable, "-m", "veles_tpu_torch", str(wf_py),
            "--device", "cpu", "-r", "7", f"root.supwf.snapshot_dir={d}",
            *extra]


def _trained_line(stdout):
    lines = [ln for ln in stdout.splitlines() if ln.startswith("TRAINED")]
    assert lines, stdout
    return lines[-1]


def test_supervisor_recovers_a_killed_granular_child(tmp_path):
    import json
    sup, ref = tmp_path / "supervised", tmp_path / "uninterrupted"
    sup.mkdir()
    ref.mkdir()
    report = sup / "report.json"
    out = subprocess.run(
        _cmd(sup, "--supervise", "--snapshot-dir", str(sup),
             "--snapshot-prefix", "supwf", "--max-restarts", "2",
             "--supervise-report", str(report)),
        env=_env("kill@epoch=3"), cwd=sup, capture_output=True, text=True,
        timeout=240)
    assert out.returncode == 0, (out.stdout[-2000:], out.stderr[-2000:])
    plain = subprocess.run(_cmd(ref), env=_env(), cwd=ref,
                           capture_output=True, text=True, timeout=240)
    assert plain.returncode == 0, plain.stderr[-2000:]
    line = _trained_line(out.stdout)
    assert line.startswith("TRAINED 6 epochs")
    assert line == _trained_line(plain.stdout)
    attempts = json.loads(report.read_text())["attempts"]
    assert len(attempts) == 2
    assert attempts[0]["reason"] == "died" \
        and attempts[0]["exit_codes"] == [-9]
    assert attempts[1]["snapshot"] and attempts[1]["reason"] == "ok"
    assert np.isfinite(float(line.split("loss ")[1].split()[0]))
