"""The port's supervisor and resume, on the CPU: the twins of
tests/test_supervisor.py and tests/test_crash_recovery.py.

Through the command line (`--device cpu`), one supervised run shared by
four tests: a parent that cannot import torch (so never initializes
CUDA) supervises `--fused` under corrupt_snapshot@write=2 and
kill@epoch=3; the restart skips the torn newest snapshot by its sidecar,
resumes from the previous valid one, and the final TRAINED line
(epochs, loss, history) equals an uninterrupted run's, dropout on; its
report carries the child's device-feed counters. Also through the
command line:

- `--nonfinite-guard` with nan@step=K: exit 81, and the supervisor
  rolls back one snapshot;
- a run SIGKILLed by hand resumes from `Snapshotter.latest` through
  `-s` with its epoch counter, and `--serve 0 -s SNAPSHOT` serves the
  snapshot's weights (the restored workflow's forward, to 1e-6).

In process, the Supervisor's decisions on a stand-in child (a small
Python that writes the heartbeat and exits, or hangs, as told) under a
clock that skips the restart backoff: the retry budget (exit 82, the
report), the no-progress cutoff, the stall detector.
"""

import json
import os
import signal
import subprocess
import sys
import threading
import time
import urllib.request
from pathlib import Path

import numpy as np
import pytest
import torch

from veles_tpu_torch.resilience import EXIT_GIVEUP, EXIT_NONFINITE, \
    EXIT_STALLED
from veles_tpu_torch.resilience.clock import Clock
from veles_tpu_torch.resilience.supervisor import BACKOFF_BASE, \
    BACKOFF_JITTER, Supervisor
from veles_tpu_torch.snapshotter import Snapshotter

REPO = Path(__file__).resolve().parent.parent

#: a small supervised run that snapshots on every improvement; a
#: restored run trains on to root.supwf.max_epochs
WORKFLOW_SRC = '''
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

#: a supervisor parent that cannot import torch: it can neither
#: initialize CUDA nor hold the card; its children, fresh interpreters,
#: import torch as usual
TORCHLESS_PARENT = ("import sys; sys.modules['torch'] = None; "
                    "from veles_tpu_torch.launcher import main; "
                    "sys.exit(main(sys.argv[1:]))")


@pytest.fixture(autouse=True, scope="module")
def _own_autotune_cache(tmp_path_factory):
    """A plain `--fused` run applies the autotune cache's winners: this
    module's runs read a cache of their own, not one under HOME."""
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("VELES_AUTOTUNE_CACHE",
                  str(tmp_path_factory.mktemp("autotune") / "autotune.json"))
        yield


def _env(fault_plan=""):
    env = dict(os.environ, PYTHONPATH=str(REPO))
    env.pop("VELES_FAULT_STATE", None)
    env.pop("VELES_HEARTBEAT_FILE", None)
    if fault_plan:
        env["VELES_FAULT_PLAN"] = fault_plan
    else:
        env.pop("VELES_FAULT_PLAN", None)
    return env


def _cmd(tmp_path, src, *extra):
    wf_py = tmp_path / "supwf.py"
    wf_py.write_text(src)
    return [sys.executable, "-m", "veles_tpu_torch", str(wf_py), "--fused",
            "--device", "cpu", "-r", "7",
            f"root.supwf.snapshot_dir={tmp_path}", *extra]


def _run_supervised(tmp_path, fault_plan="", extra=(), timeout=240,
                    workflow_src=WORKFLOW_SRC, parent=None):
    report = tmp_path / "supervisor_report.json"
    cmd = _cmd(tmp_path, workflow_src, "-v", "--supervise",
               "--snapshot-dir", str(tmp_path), "--snapshot-prefix",
               "supwf", "--supervise-report", str(report), *extra)
    if parent is not None:
        cmd = [sys.executable, "-c", parent] + cmd[3:]
    out = subprocess.run(cmd, env=_env(fault_plan), cwd=tmp_path,
                         capture_output=True, text=True, timeout=timeout)
    report_data = (json.loads(report.read_text())
                   if report.exists() else None)
    return out, report_data


def _trained_line(stdout):
    lines = [ln for ln in stdout.splitlines() if ln.startswith("TRAINED")]
    assert lines, stdout
    return lines[-1]


def _uninterrupted(tmp_path):
    d = tmp_path / "uninterrupted"
    d.mkdir()
    r = subprocess.run(_cmd(d, WORKFLOW_SRC), env=_env(), cwd=d,
                       capture_output=True, text=True, timeout=240)
    assert r.returncode == 0, r.stderr[-2000:]
    return _trained_line(r.stdout)


@pytest.fixture(scope="module")
def supervised(tmp_path_factory):
    """One supervised run, its parent torchless: the second snapshot
    written is torn, the child is SIGKILLed at epoch 3 and restarted.
    Returns (directory, the completed process, the report)."""
    tmp_path = tmp_path_factory.mktemp("supervised")
    out, report = _run_supervised(
        tmp_path, fault_plan="corrupt_snapshot@write=2; kill@epoch=3",
        extra=("--max-restarts", "3"), parent=TORCHLESS_PARENT)
    return tmp_path, out, report


def test_supervisor_recovers_from_kill_with_the_uninterrupted_bits(
        supervised):
    """kill@epoch=3 SIGKILLs the child; the supervisor restarts it from
    a snapshot and the run ends with the uninterrupted run's epochs,
    loss and history, dropout masks included."""
    tmp_path, out, report = supervised
    assert out.returncode == 0, (out.stdout[-2000:], out.stderr[-2000:])
    line = _trained_line(out.stdout)
    assert line.startswith("TRAINED 6 epochs")
    assert line == _uninterrupted(tmp_path)
    assert report["outcome"] == "completed"
    assert len(report["attempts"]) == 2          # initial + 1 restart
    first, second = report["attempts"]
    assert first["reason"] == "died" and first["exit_codes"] == [-9]
    assert first["epoch_reached"] == 3
    assert second["snapshot"] and second["reason"] == "ok"
    assert second["epoch_reached"] == 6
    # the supervisor's child ran without the supervisor's flags
    assert "--supervise" not in out.stderr.split("attempt 1")[0]


def test_supervisor_corrupt_snapshot_fallback(supervised):
    """The second snapshot is torn (fault hook) before the kill; the
    restart skips it by its sha256 sidecar and resumes from the previous
    VALID snapshot."""
    _, out, report = supervised
    assert out.returncode == 0, (out.stdout[-2000:], out.stderr[-2000:])
    resumed_from = report["attempts"][1]["snapshot"]
    assert resumed_from and Snapshotter.verify(resumed_from)
    # the torn file was skipped by its checksum (the resumed run, which
    # reaches the same best error again, later writes a good file under
    # its name)
    skipped = [ln for ln in out.stderr.splitlines()
               if "failed integrity check" in ln]
    assert skipped and os.path.basename(resumed_from) not in skipped[0]


def test_supervisor_report_carries_feed_counters(supervised):
    _, out, report = supervised
    assert out.returncode == 0, (out.stdout[-2000:], out.stderr[-2000:])
    feed = report["feed"]
    assert feed["batches"] > 0 and feed["bytes_h2d"] > 0
    assert "loader_block_s" in feed and "device_sync_s" in feed
    assert "epoch_log" not in feed and feed["from_attempt"] == 2
    assert all(a["feed"]["batches"] > 0 for a in report["attempts"])


def test_supervisor_parent_never_imports_torch(supervised):
    """The shared run's parent ran with torch made unimportable (so it
    could neither initialize CUDA nor hold the card); its children,
    fresh interpreters, trained and recovered as usual."""
    _, out, report = supervised
    assert out.returncode == 0, (out.stdout[-2000:], out.stderr[-2000:])
    assert _trained_line(out.stdout).startswith("TRAINED 6 epochs")
    assert [a["reason"] for a in report["attempts"]] == ["died", "ok"]


def test_nonfinite_guard_exits_81_and_rolls_back_one_snapshot(tmp_path):
    """nan@step=16 (epoch 4's first train step) under --nonfinite-guard:
    the child exits 81 before the poisoned pass is counted; the
    supervisor restarts from the second-newest snapshot, not the newest,
    and the run completes."""
    out, report = _run_supervised(
        tmp_path, fault_plan="nan@step=16",
        extra=("--max-restarts", "3", "--nonfinite-guard"))
    assert out.returncode == 0, (out.stdout[-2000:], out.stderr[-2000:])
    first, second = report["attempts"]
    assert first["exit_codes"] == [EXIT_NONFINITE]
    assert "non-finite loss" in out.stderr
    snaps = sorted((p for p in os.listdir(tmp_path)
                    if p.startswith("supwf") and p.endswith(".gz")),
                   key=lambda p: os.path.getmtime(str(tmp_path / p)))
    assert second["snapshot"] and second["reason"] == "ok"
    assert _trained_line(out.stdout).startswith("TRAINED 6 epochs")
    # the newest snapshot before the abort was skipped (rolled back one)
    assert "falling back to" in out.stderr
    assert snaps


# -- the supervisor's decisions on a stand-in child ---------------------------

#: a stand-in for the training child: attempt n (counted in a file)
#: follows attempts[n] (the last one repeats): it writes the heartbeat
#: of epochs 0..epochs, then hangs or exits with `code`
STAND_IN = """
import json, os, sys, time
from veles_tpu_torch.resilience.supervisor import write_heartbeat
spec = json.loads(sys.argv[1])
n = 0
if os.path.exists(spec["counter"]):
    with open(spec["counter"]) as f:
        n = int(f.read())
with open(spec["counter"], "w") as f:
    f.write(str(n + 1))
plan = spec["attempts"][min(n, len(spec["attempts"]) - 1)]
for epoch in range(plan["epochs"] + 1):
    write_heartbeat(os.environ["VELES_HEARTBEAT_FILE"], epoch)
if plan.get("hang"):
    time.sleep(600)
sys.exit(plan.get("code", 0))
"""


class SkippingClock(Clock):
    """Records every wait and sleeps at most 10 ms of it: the restart
    backoff takes no time, the poll stays a poll."""

    def __init__(self):
        self.slept = []

    def sleep(self, seconds):
        self.slept.append(seconds)
        time.sleep(min(seconds, 0.01))

    def backoffs(self):
        """The restart waits (every poll is shorter than BACKOFF_BASE)."""
        return [s for s in self.slept if s >= BACKOFF_BASE]


def _stand_in(tmp_path, monkeypatch, attempts, **kwargs):
    """Supervise the stand-in through `attempts`; returns (exit code,
    the report, the clock)."""
    monkeypatch.setenv("PYTHONPATH", str(REPO))
    for name in ("VELES_FAULT_STATE", "VELES_HEARTBEAT_FILE",
                 "VELES_FAULT_PLAN"):
        monkeypatch.delenv(name, raising=False)
    spec = {"counter": str(tmp_path / "attempts"), "attempts": attempts}
    report = tmp_path / "report.json"
    clock = SkippingClock()
    code = Supervisor(
        [sys.executable, "-c", STAND_IN, json.dumps(spec)],
        snapshot_dir=str(tmp_path), report_path=str(report), clock=clock,
        **kwargs).run()
    return code, json.loads(report.read_text()), clock


def test_supervisor_gives_up_with_exit_report(tmp_path, monkeypatch,
                                              capsys):
    code, report, clock = _stand_in(
        tmp_path, monkeypatch, [{"epochs": 0, "code": 1},
                                {"epochs": 1, "code": 1}],
        max_restarts=1)
    assert code == report["exit_code"] == EXIT_GIVEUP
    assert len(report["attempts"]) == 2          # initial + 1 restart
    assert all(a["reason"] == "died" and a["exit_codes"] == [1]
               for a in report["attempts"])
    assert "retry budget exhausted" in report["outcome"]
    assert "supervisor:" in capsys.readouterr().err   # the human report
    (wait,) = clock.backoffs()
    assert BACKOFF_BASE <= wait < BACKOFF_BASE * (1 + BACKOFF_JITTER)


def test_supervisor_no_progress_cutoff(tmp_path, monkeypatch):
    """Every attempt dies at epoch 2: the third without an epoch advance
    over the best is the last, whatever budget is left."""
    code, report, clock = _stand_in(
        tmp_path, monkeypatch, [{"epochs": 2, "code": 1}],
        max_restarts=10)
    assert code == EXIT_GIVEUP
    assert "no epoch progress" in report["outcome"]
    assert [a["epoch_reached"] for a in report["attempts"]] == [2, 2, 2]
    assert all(a["reason"] == "died" for a in report["attempts"])
    # exponential backoff: ~1 s, then ~2 s
    waits = clock.backoffs()
    assert len(waits) == 2
    for k, wait in enumerate(waits):
        base = BACKOFF_BASE * 2 ** k
        assert base <= wait < base * (1 + BACKOFF_JITTER)


def test_supervisor_detects_stall_and_restarts(tmp_path, monkeypatch):
    """The child hangs after epoch 1 (heartbeats stop); the stall
    detector kills it and the restart finishes the run."""
    code, report, _ = _stand_in(
        tmp_path, monkeypatch, [{"epochs": 1, "hang": True},
                                {"epochs": 3}],
        max_restarts=3, stall_timeout=1.0)
    assert code == 0 and report["outcome"] == "completed"
    first, second = report["attempts"]
    assert first["reason"] == "stall"
    assert first["exit_codes"] == [EXIT_STALLED]
    assert first["epoch_reached"] == 1
    assert second["reason"] == "ok" and second["epoch_reached"] == 3


def _train_until_snapshots(tmp_path, n=2):
    """Train the workflow with a high epoch cap until `n` snapshots
    landed, then SIGKILL it (a hard crash)."""
    p = subprocess.Popen(_cmd(tmp_path, WORKFLOW_SRC,
                              "root.supwf.max_epochs=4000"),
                         env=_env(), cwd=tmp_path,
                         stdout=subprocess.DEVNULL,
                         stderr=subprocess.PIPE, text=True)
    deadline = time.time() + 120
    try:
        while time.time() < deadline:
            if len([f for f in os.listdir(tmp_path)
                    if f.startswith("supwf")
                    and f.endswith(".sha256")]) >= n:
                break
            assert p.poll() is None, p.stderr.read()[-2000:]
            time.sleep(0.2)
        else:
            raise AssertionError("no snapshot appeared in 120s")
    finally:
        if p.poll() is None:
            p.send_signal(signal.SIGKILL)
        p.wait()
        p.stderr.close()
    snap = Snapshotter.latest(str(tmp_path), prefix="supwf")
    assert snap is not None
    return snap


def test_kill_and_resume_from_latest_snapshot(tmp_path):
    snap = _train_until_snapshots(tmp_path)
    restored = Snapshotter.import_(snap, restore_prng=False)
    at = restored.decision.epoch_number
    out = subprocess.run(
        _cmd(tmp_path, WORKFLOW_SRC, "-s", snap,
             f"root.supwf.max_epochs={at + 2}"),
        env=_env(), cwd=tmp_path, capture_output=True, text=True,
        timeout=180)
    assert out.returncode == 0, out.stderr[-2000:]
    # the epoch counter CONTINUED from the snapshot's
    assert _trained_line(out.stdout).startswith(f"TRAINED {at + 2} epochs")
    assert at >= 1


def test_cli_serves_a_restored_snapshot(tmp_path):
    snap = _train_until_snapshots(tmp_path)
    srv = subprocess.Popen(
        _cmd(tmp_path, WORKFLOW_SRC, "-s", snap)[:4]
        + ["--serve", "0", "--device", "cpu", "--serve-ring", "8",
           "-s", snap],
        env=_env(), cwd=tmp_path, stdout=subprocess.PIPE,
        stderr=subprocess.PIPE, text=True)
    try:
        lines = []
        reader = threading.Thread(
            target=lambda: lines.append(srv.stdout.readline()),
            daemon=True)
        reader.start()
        reader.join(timeout=120)
        assert lines and lines[0].startswith("SERVING"), (lines,
                                                          srv.poll())
        url = lines[0].split()[1]
        x = np.random.RandomState(0).randn(3, 10).astype(np.float32)
        req = urllib.request.Request(
            url + "/predict", data=json.dumps({"inputs": x.tolist()}).encode(),
            method="POST")
        with urllib.request.urlopen(req, timeout=60) as r:
            resp = json.loads(r.read())
        # the restored workflow's own forward on the same rows
        wf = Snapshotter.import_(snap, restore_prng=False)
        wf.place("cpu")
        fwd = wf.build_forward()
        want = torch.softmax(fwd._forward(fwd.params(), torch.from_numpy(x)),
                             dim=-1).numpy()
        np.testing.assert_allclose(np.asarray(resp["outputs"]), want,
                                   rtol=0, atol=1e-6)
        srv.send_signal(signal.SIGINT)
        assert srv.wait(timeout=60) == 0
    finally:
        if srv.poll() is None:
            srv.kill()
            srv.wait(timeout=30)
        srv.stdout.close()
        srv.stderr.close()
