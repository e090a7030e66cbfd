"""The port's snapshots and the in-process half of its resilience layer,
held against the JAX package's contract (tests/test_resilience.py):

- the hardened write (sha256 sidecar, `.tmp` + rename), `verify`, and
  `latest` skipping truncated, bit-flipped and legacy files and garbage
  or truncated sidecars, `skip` rolling back one, `keep_last`, the
  `corrupt_snapshot` fault, `restore_prng=False`; on the same files the
  port's `latest` and the JAX package's choose the same one;
- the codecs sniffed by magic, deterministic gzip, tensors written as
  host bytes (every dtype's bits, parameters, shared identity), a JAX
  package pickle refused;
- the fault-plan grammar, fire-once persistence, the epoch hooks and
  the Decision firing them, the non-finite guard;
- the PRNG registry through a pickle: numpy states and the device
  stream's position.
"""

import json
import os
import pickle
import types

import numpy as np
import pytest
import torch

from veles_tpu.snapshotter import Snapshotter as JaxSnapshotter
from veles_tpu_torch import prng
from veles_tpu_torch.resilience import NonFiniteLossError
from veles_tpu_torch.resilience import faults as rfaults
from veles_tpu_torch.resilience import hooks as rhooks
from veles_tpu_torch.resilience.faults import FaultPlan
from veles_tpu_torch.snapshotter import Snapshotter


@pytest.fixture(autouse=True)
def _clean_state(monkeypatch):
    """No fault plan, epoch hook or generator leaks between tests."""
    rfaults.install_plan(None)
    rhooks.clear_epoch_hooks()
    monkeypatch.setattr(prng, "_generators", {})
    monkeypatch.setattr(prng, "_base_seed", None)
    yield
    rfaults.install_plan(None)
    rhooks.clear_epoch_hooks()


# -- fault-plan grammar -------------------------------------------------------

def test_fault_plan_compact_grammar():
    plan = FaultPlan.parse("kill@epoch=2; hang@epoch=5; nan@step=10; "
                           "corrupt_snapshot@write=2")
    assert [e.key for e in plan.entries] == [
        "kill@epoch=2", "hang@epoch=5", "nan@step=10",
        "corrupt_snapshot@write=2"]


def test_fault_plan_bare_action_defaults_to_one():
    plan = FaultPlan.parse("corrupt_snapshot")
    assert plan.entries[0].key == "corrupt_snapshot@write=1"


def test_fault_plan_json_grammar():
    plan = FaultPlan.parse(json.dumps(
        [{"action": "kill", "epoch": 3}, {"action": "nan", "step": 7}]))
    assert [e.key for e in plan.entries] == ["kill@epoch=3", "nan@step=7"]


@pytest.mark.parametrize("bad", [
    "explode@epoch=1",        # unknown action
    "kill@step=1",            # kill keys on epoch, not step
    "nan@step=zero",          # non-numeric trigger
    "",                       # empty
    ";;",                     # no entries
    "host_loss@epoch=1",      # a cluster action: not in the port yet
])
def test_fault_plan_rejects_bad_grammar(bad):
    with pytest.raises(ValueError):
        FaultPlan.parse(bad)


def test_fault_entries_fire_once_and_persist(tmp_path):
    """An entry fires at most once, and with a state file the fired set
    survives into a new plan instance (a restarted process whose epoch
    counter re-crosses the trigger must not re-fire the fault)."""
    state = str(tmp_path / "fault_state.json")
    plan = FaultPlan.parse("nan@step=2", state_path=state)
    assert not plan.nan_at_step()          # step 1
    assert plan.nan_at_step()              # step 2: fires
    assert not plan.nan_at_step(2)         # same trigger: spent
    plan2 = FaultPlan.parse("nan@step=2", state_path=state)
    assert not plan2.nan_at_step(2)


def test_active_plan_reads_env(monkeypatch):
    rfaults.reset()
    monkeypatch.delenv("VELES_FAULT_PLAN", raising=False)
    assert rfaults.active_plan() is None
    rfaults.reset()
    monkeypatch.setenv("VELES_FAULT_PLAN", "nan@step=3")
    plan = rfaults.active_plan()
    assert plan is not None and plan.entries[0].key == "nan@step=3"
    rfaults.reset()


# -- epoch hooks, the Decision, the non-finite guard --------------------------

def test_epoch_hooks_fire_in_order_and_remove():
    seen = []
    a = rhooks.add_epoch_hook(lambda e: seen.append(("a", e)))
    rhooks.add_epoch_hook(lambda e: seen.append(("b", e)))
    rhooks.fire_epoch(1)
    assert seen == [("a", 1), ("b", 1)]
    rhooks.remove_epoch_hook(a)
    rhooks.remove_epoch_hook(a)     # double-remove is a no-op
    rhooks.fire_epoch(2)
    assert seen[-1] == ("b", 2)


def _tiny_workflow(max_epochs=5, snapshot_dir=None):
    from veles_tpu_torch.loader.synthetic import SyntheticClassifierLoader
    from veles_tpu_torch.znicz.standard_workflow import StandardWorkflow
    prng.seed_all(13)
    loader = SyntheticClassifierLoader(
        n_classes=3, sample_shape=(8,), n_validation=30, n_train=90,
        minibatch_size=30, noise=0.3)
    return StandardWorkflow(
        layers=[{"type": "all2all_strictrelu", "output_sample_shape": 8,
                 "weights_stddev": 0.1},
                {"type": "softmax", "output_sample_shape": 3,
                 "weights_stddev": 0.05}],
        loader=loader, loss="softmax", n_classes=3,
        decision_config={"max_epochs": max_epochs,
                         "fail_iterations": 1000},
        gd_config={"learning_rate": 0.05},
        snapshot_config=(None if snapshot_dir is None else
                         {"directory": str(snapshot_dir),
                          "prefix": "guard"}),
        name="GuardWF")


def test_decision_fires_epoch_hook():
    wf = _tiny_workflow(max_epochs=3)
    seen = []
    rhooks.add_epoch_hook(seen.append)
    wf.run_fused(device="cpu")
    assert seen == [1, 2, 3]


def test_nonfinite_guard_aborts_on_injected_nan(tmp_path):
    """nan@step=K + guard: the loop raises NonFiniteLossError at the
    class-pass boundary before the Decision counts the pass or a
    snapshot is taken on it."""
    rfaults.install_plan(FaultPlan.parse("nan@step=2"))
    wf = _tiny_workflow(snapshot_dir=tmp_path)
    with pytest.raises(NonFiniteLossError) as exc:
        wf.run_fused(device="cpu", nonfinite_guard=True)
    assert "non-finite loss" in str(exc.value)
    assert wf.decision.epoch_number == 0
    # the only snapshot is the validation pass's, before the NaN
    assert len([n for n in os.listdir(tmp_path)
                if n.endswith(".gz")]) == 1
    # a pickle leaves the guard out: a restored run arms it itself
    assert wf.decision.nonfinite_guard
    assert not pickle.loads(pickle.dumps(wf.decision)).nonfinite_guard


def test_nonfinite_guard_off_by_default():
    rfaults.install_plan(FaultPlan.parse("nan@step=2"))
    wf = _tiny_workflow(max_epochs=2)
    wf.run_fused(device="cpu")      # completes despite the NaN
    assert wf.decision.epoch_number == 2


def test_clean_run_unaffected_by_guard():
    wf = _tiny_workflow(max_epochs=2)
    wf.run_fused(device="cpu", nonfinite_guard=True)
    assert wf.decision.epoch_number == 2
    assert np.isfinite(wf.evaluator.loss)


# -- hardened snapshot writes -------------------------------------------------

def _snapshot(tmp_path, suffix, mtime=None, compression="gz",
              workflow=None):
    """Write one real snapshot with a pinned stamp."""
    snap = Snapshotter(workflow or types.SimpleNamespace(name="SnapWF"),
                       prefix="hard", directory=str(tmp_path),
                       compression=compression)
    snap.initialize()
    snap.suffix = suffix
    path = snap.export()
    if mtime is not None:
        os.utime(path, (mtime, mtime))
    return path


def _both_latest(directory, **kw):
    """The port's latest and the JAX package's, on the same files."""
    mine = Snapshotter.latest(str(directory), **kw)
    assert mine == JaxSnapshotter.latest(str(directory), **kw)
    return mine


def test_export_writes_sha256_sidecar_and_verifies(tmp_path):
    path = _snapshot(tmp_path, "a")
    sidecar = path + ".sha256"
    assert os.path.exists(sidecar)
    with open(sidecar) as f:
        digest, name = f.read().split()
    assert len(digest) == 64 and name == os.path.basename(path)
    assert Snapshotter.verify(path) and JaxSnapshotter.verify(path)
    assert not os.path.exists(path + ".tmp")
    assert os.path.basename(path) == "hard_a.pickle.gz"
    assert _both_latest(tmp_path, prefix="hard") == path


def test_latest_skips_truncated_snapshot(tmp_path):
    old = _snapshot(tmp_path, "old", mtime=1_000_000)
    new = _snapshot(tmp_path, "new", mtime=2_000_000)
    with open(new, "r+b") as f:
        f.truncate(os.path.getsize(new) // 2)
    assert not Snapshotter.verify(new)
    assert _both_latest(tmp_path, prefix="hard") == old


def test_latest_skips_bitflipped_snapshot_via_checksum(tmp_path):
    old = _snapshot(tmp_path, "old", mtime=1_000_000)
    new = _snapshot(tmp_path, "new", mtime=2_000_000)
    size = os.path.getsize(new)
    with open(new, "r+b") as f:       # same size, different bytes
        f.seek(size // 2)
        f.write(b"\x00\xff\x00\xff")
    assert not Snapshotter.verify(new)
    assert _both_latest(tmp_path, prefix="hard") == old


def test_latest_verifies_legacy_gz_without_sidecar(tmp_path):
    """Without a sidecar the gz stream's integrity is the check, so a
    truncated file is still skipped."""
    old = _snapshot(tmp_path, "old", mtime=1_000_000)
    new = _snapshot(tmp_path, "new", mtime=2_000_000)
    os.remove(old + ".sha256")
    os.remove(new + ".sha256")
    with open(new, "r+b") as f:
        f.truncate(os.path.getsize(new) // 2)
    assert Snapshotter.verify(old)
    assert not Snapshotter.verify(new)
    assert _both_latest(tmp_path, prefix="hard") == old


def test_latest_skip_rolls_back_one_valid(tmp_path):
    """skip=1 = the supervisor's non-finite rollback: second-newest
    VALID snapshot (corrupt ones don't count against the skip)."""
    oldest = _snapshot(tmp_path, "a", mtime=1_000_000)
    middle = _snapshot(tmp_path, "b", mtime=2_000_000)
    newest = _snapshot(tmp_path, "c", mtime=3_000_000)
    assert _both_latest(tmp_path, prefix="hard", skip=1) == middle
    with open(newest, "r+b") as f:
        f.truncate(10)
    assert _both_latest(tmp_path, prefix="hard", skip=1) == oldest
    assert _both_latest(tmp_path, prefix="hard", skip=2) is None


def test_latest_returns_none_when_all_corrupt(tmp_path):
    path = _snapshot(tmp_path, "only")
    with open(path, "r+b") as f:
        f.truncate(8)
    assert _both_latest(tmp_path, prefix="hard") is None
    assert _both_latest(tmp_path / "missing", prefix="hard") is None


def test_latest_skips_in_flight_tmp_and_other_prefixes(tmp_path):
    path = _snapshot(tmp_path, "a", mtime=1_000_000)
    with open(str(tmp_path / "hard_b.pickle.gz.tmp"), "wb") as f:
        f.write(b"\x1f\x8b torn")
    other = _snapshot(tmp_path, "z", mtime=2_000_000)
    os.rename(other, str(tmp_path / "else_z.pickle.gz"))
    assert _both_latest(tmp_path, prefix="hard") == path


def test_corrupt_snapshot_fault_hook(tmp_path):
    """corrupt_snapshot@write=2 tears exactly the second export, and
    latest() falls back to the first."""
    rfaults.install_plan(FaultPlan.parse("corrupt_snapshot@write=2"))
    snap = Snapshotter(types.SimpleNamespace(name="SnapWF"),
                       prefix="fault", directory=str(tmp_path), interval=1)
    snap.initialize()
    snap.suffix = "w1"
    snap.run()
    first = snap.destination
    os.utime(first, (1_000_000, 1_000_000))
    snap.suffix = "w2"
    snap._last_time = 0.0
    snap.run()
    second = snap.destination
    assert second != first
    assert Snapshotter.verify(first)
    assert not Snapshotter.verify(second)
    assert _both_latest(tmp_path, prefix="fault") == first


def test_keep_last_prunes_sidecars(tmp_path):
    snap = Snapshotter(types.SimpleNamespace(name="SnapWF"),
                       prefix="prune", directory=str(tmp_path),
                       interval=1, keep_last=1)
    snap.initialize()
    for i in range(3):
        snap.suffix = f"s{i}"
        snap._last_time = 0.0
        snap.run()
    files = sorted(os.listdir(tmp_path))
    assert files == ["prune_s2.pickle.gz", "prune_s2.pickle.gz.sha256"]


def test_interval_time_interval_and_dry_run(tmp_path):
    snap = Snapshotter(types.SimpleNamespace(name="SnapWF"), prefix="iv",
                       directory=str(tmp_path), interval=2,
                       time_interval=3600.0)
    snap.initialize()
    snap.suffix = "a"
    snap.run()                      # 1st call: skipped by the interval
    assert snap.destination == ""
    snap.run()                      # 2nd: written
    assert os.path.basename(snap.destination) == "iv_a.pickle.gz"
    snap.suffix = "b"
    snap.run()
    snap.run()                      # due by interval, not by the clock
    assert not os.path.exists(str(tmp_path / "iv_b.pickle.gz"))
    dry = Snapshotter(types.SimpleNamespace(name="SnapWF"), prefix="dry",
                      directory=str(tmp_path))
    dry.initialize()
    dry.dry_run = True
    dry.run()
    assert dry.destination == ""
    assert not [n for n in os.listdir(tmp_path) if n.startswith("dry")]


def test_import_still_reads_hardened_snapshot(tmp_path):
    path = _snapshot(tmp_path, "roundtrip")
    wf = Snapshotter.import_(path)
    assert wf.name == "SnapWF"


def test_latest_skips_snapshot_with_garbage_sidecar(tmp_path):
    old = _snapshot(tmp_path, "old", mtime=1_000_000)
    new = _snapshot(tmp_path, "new", mtime=2_000_000)
    with open(new + ".sha256", "w") as f:
        f.write("deadbeef" * 8 + "  " + os.path.basename(new) + "\n")
    assert not Snapshotter.verify(new)
    assert _both_latest(tmp_path, prefix="hard", verify=True) == old


def test_latest_skips_snapshot_with_truncated_sidecar(tmp_path):
    """A sidecar truncated to zero bytes fails verification — it does
    not fall through to the no-sidecar stream check, which the intact gz
    body would pass."""
    old = _snapshot(tmp_path, "old", mtime=1_000_000)
    new = _snapshot(tmp_path, "new", mtime=2_000_000)
    with open(new + ".sha256", "w"):
        pass
    assert not Snapshotter.verify(new)
    assert _both_latest(tmp_path, prefix="hard", verify=True) == old


def test_import_restore_prng_false_preserves_process_streams(tmp_path):
    path = _snapshot(tmp_path, "prng")
    prng.seed_all(777)
    marker = prng.get().randint(0, 10 ** 6, size=8)
    prng.seed_all(777)
    Snapshotter.import_(path, restore_prng=False)
    np.testing.assert_array_equal(
        prng.get().randint(0, 10 ** 6, size=8), marker)


# -- the port's format --------------------------------------------------------

@pytest.mark.parametrize("compression, ext, magic", [
    ("gz", ".gz", b"\x1f\x8b"), ("bz2", ".bz2", b"BZh"),
    ("xz", ".xz", b"\xfd7zXZ\x00"), ("", "", b"\x80")])
def test_codecs_are_sniffed_by_magic(tmp_path, compression, ext, magic):
    path = _snapshot(tmp_path, "c", compression=compression)
    assert path.endswith(".pickle" + ext)
    with open(path, "rb") as f:
        assert f.read(len(magic)) == magic
    renamed = str(tmp_path / "renamed.bin")
    os.rename(path, renamed)
    assert Snapshotter.import_(renamed).name == "SnapWF"


def test_gzip_is_deterministic(tmp_path):
    """One state writes one file: the gzip header carries no time."""
    a = _snapshot(tmp_path / "a", "x")
    b = _snapshot(tmp_path / "b", "x")
    with open(a, "rb") as fa, open(b, "rb") as fb:
        assert fa.read() == fb.read()


def test_tensors_are_written_as_host_bytes(tmp_path):
    """Every dtype comes back with its bits, a Parameter as a Parameter,
    and a tensor referenced twice as one tensor; torch's own pickling
    (which records the tensor's device) is not in the file."""
    rs = np.random.RandomState(0)
    f32 = torch.from_numpy(rs.randn(3, 5).astype(np.float32))
    obj = types.SimpleNamespace(
        name="SnapWF",
        f32=f32, alias=f32,
        bf16=torch.from_numpy(rs.randn(7).astype(np.float32)).bfloat16(),
        i64=torch.arange(4), u8=torch.tensor([0, 255], dtype=torch.uint8),
        scalar=torch.tensor(2.5),
        param=torch.nn.Parameter(torch.ones(2, 2)),
        strided=torch.arange(12.0).reshape(3, 4).t())
    path = _snapshot(tmp_path, "t", compression="", workflow=obj)
    with open(path, "rb") as f:
        raw = f.read()
    assert b"_rebuild_tensor" in raw and b"torch._utils" not in raw
    back = Snapshotter.import_(path)
    for name in ("f32", "bf16", "i64", "u8", "scalar", "param", "strided"):
        got, want = getattr(back, name), getattr(obj, name)
        assert got.dtype == want.dtype and got.shape == want.shape, name
        assert got.device.type == "cpu"
        assert torch.equal(got.view(-1).view(torch.uint8)
                           if got.dtype == torch.bfloat16 else got,
                           want.reshape(-1).view(torch.uint8)
                           if want.dtype == torch.bfloat16 else want), name
    assert isinstance(back.param, torch.nn.Parameter)
    assert back.param.requires_grad
    assert back.alias is back.f32


def test_a_pickle_without_the_marker_is_refused(tmp_path):
    path = str(tmp_path / "wf_1.pickle")
    with open(path, "wb") as f:
        pickle.dump({"__veles_snapshot__": 2, "workflow": None}, f)
    with pytest.raises(ValueError, match="not a snapshot"):
        Snapshotter.import_(path)


# -- the PRNG registry through a pickle ---------------------------------------

def test_registry_restores_numpy_states_and_the_device_streams_position():
    prng.seed_all(5)
    gen = prng.get()
    stream = gen.device_stream("cpu")
    assert gen.device_stream("cpu") is stream       # one stream
    torch.rand(3, generator=stream)
    gen.randint(0, 10, 4)
    saved = pickle.loads(pickle.dumps(prng.snapshot_registry()))
    want_np = gen.randint(0, 10 ** 6, 4)
    want_dev = torch.rand(5, generator=stream)
    prng.seed_all(99)
    prng.restore_registry(saved)
    again = prng.get()
    np.testing.assert_array_equal(again.randint(0, 10 ** 6, 4), want_np)
    torch.testing.assert_close(
        torch.rand(5, generator=again.device_stream("cpu")), want_dev,
        rtol=0, atol=0)
    # the fresh generator of torch_generator still starts at the seed
    fresh = torch.rand(3, generator=again.torch_generator("cpu"))
    torch.testing.assert_close(
        fresh, torch.rand(3, generator=prng.RandomGenerator(
            "x", 5).torch_generator("cpu")), rtol=0, atol=0)
