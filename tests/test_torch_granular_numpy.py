"""The granular graph's numpy backend, its learning-rate schedule and its
command line, held against the JAX package.

- `-b numpy`: the port's toy AlexNet epoch on `NumpyDevice` against the
  JAX package's on its `NumpyDevice` — the same goldens
  (ops/reference.py, copied value for value), the same seeded streams
  (the dropout masks included): parameters, velocities, the Decision's
  history and the loss equal bit for bit. Carried across with
  `convert.granular_from_jax`, a JAX run's state continues in the port
  bit for bit too.
- `LearningRateAdjust`: each policy's scale equals the JAX unit's over
  the first iterations, and spliced into the loop as the JAX package's
  tests splice it, the scale reaches the update: the iteration count,
  every gradient unit's `lr_scale` and the trained weights equal the JAX
  run's (numpy backend, bit for bit; the torch backend on the CPU, whose
  update is K1's plain version there, to rtol 1e-4, atol 1e-6).
- The command line: the toy AlexNet trains through the graph without
  `--fused` on `--device cpu` under both backends; without `--fused` it
  also takes `-s` (a snapshot of the toy workflow, restored and
  trained), `--snapshot-dir` and `--supervise` (a supervised granular
  child), while `--accum` and `--feed-ahead` exit 2 naming what to do.
"""

import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

from veles_tpu import prng as jprng
from veles_tpu.backends import NumpyDevice, XLADevice
from veles_tpu.config import root as jroot
from veles_tpu.loader.synthetic import \
    SyntheticClassifierLoader as JSynthetic
from veles_tpu.samples import alexnet as jalexnet
from veles_tpu.znicz import lr_adjust as jlr
from veles_tpu.znicz.standard_workflow import \
    StandardWorkflow as JStandardWorkflow
from veles_tpu_torch import convert, prng, root
from veles_tpu_torch.loader.synthetic import SyntheticClassifierLoader
from veles_tpu_torch.samples import alexnet
from veles_tpu_torch.znicz import lr_adjust
from veles_tpu_torch.znicz.standard_workflow import StandardWorkflow

REPO = Path(__file__).resolve().parent.parent
TOY = dict(minibatch_size=16, input_hw=67, width_mult=0.125, fc_width=64,
           n_train=48, n_validation=16, n_classes=8, init="scaled")


@pytest.fixture(autouse=True, scope="module")
def _own_autotune_cache(tmp_path_factory):
    """A plain `--fused` run applies the autotune cache's winners: this
    module's runs read a cache of their own, not one under HOME."""
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("VELES_AUTOTUNE_CACHE",
                  str(tmp_path_factory.mktemp("autotune") / "autotune.json"))
        yield


@pytest.fixture(autouse=True)
def _restore():
    saved = (jprng._base_seed, prng._base_seed, jroot.alexnet.to_dict(),
             root.alexnet.to_dict())
    yield
    jprng._base_seed, prng._base_seed, jroot.alexnet, root.alexnet = saved


def _toy(pkg_root, pkg_prng, create, epochs=1):
    pkg_prng.seed_all(4321)
    pkg_root.alexnet.decision.max_epochs = epochs
    pkg_root.alexnet.decision.fail_iterations = 99
    pkg_root.alexnet.gd.learning_rate = 0.01
    return create(**TOY)


def _assert_same_state(jwf, pwf):
    n = len(pwf.forwards)
    for i, (ju, pu) in enumerate(zip(jwf.forwards, pwf.forwards)):
        jg, pg = jwf.gds[n - 1 - i], pwf.gds[n - 1 - i]
        for k, t in pu.param_arrays().items():
            np.testing.assert_array_equal(t.detach().numpy(),
                                          np.asarray(getattr(ju, k).mem),
                                          err_msg=f"unit {i} {k}")
            np.testing.assert_array_equal(
                pg.velocity(k).numpy(),
                np.asarray(getattr(jg, pg.vel_attr(k)).mem),
                err_msg=f"unit {i} velocity {k}")
    assert pwf.decision.history == jwf.decision.history
    assert pwf.evaluator.loss == jwf.evaluator.loss


def test_numpy_backend_gives_the_jax_numpy_run_bit_for_bit():
    jwf = _toy(jroot, jprng, jalexnet.create_workflow)
    jwf.initialize(device=NumpyDevice())
    jwf.run()
    pwf = _toy(root, prng, alexnet.create_workflow)
    pwf.initialize(backend="numpy")
    assert pwf.device.type == "cpu"
    pwf.run()
    _assert_same_state(jwf, pwf)
    assert [u.run_count for u in pwf.units] == \
        [u.run_count for u in jwf.units if u is not jwf.snapshotter]
    jwf._stop_units()


def test_a_jax_run_carried_across_continues_bit_for_bit():
    jwf = _toy(jroot, jprng, jalexnet.create_workflow)
    jwf.initialize(device=NumpyDevice())
    jwf.run()
    # the port built from another seed: everything it continues from is
    # the carried state
    pwf = _toy(root, prng, alexnet.create_workflow)
    prng.seed_all(99)
    pwf.initialize(backend="numpy")
    convert.granular_from_jax(jwf, pwf)
    _assert_same_state(jwf, pwf)
    assert pwf.loader._cursor == jwf.loader._cursor == 0
    # the carried shuffle stream: the next epoch's order is drawn from it
    prng.get().state.set_state(jprng.get().state.get_state())
    for wf in (jwf, pwf):
        wf.decision.max_epochs = 2
        wf.decision.complete <<= False     # the Bool the gates read
        wf.run()
    _assert_same_state(jwf, pwf)
    assert pwf.decision.epoch_number == jwf.decision.epoch_number == 2
    # the port updated in the second epoch only; its last update skipped
    assert (pwf.gds[0].run_count, jwf.gds[0].run_count) == (2, 4)
    jwf._stop_units()


# -- LearningRateAdjust -------------------------------------------------------

POLICIES = {
    "step": dict(base=1.0, gamma=0.5, step=3),
    "exp": dict(gamma=0.9),
    "inv": dict(gamma=0.1, power=0.75),
    "fixed": dict(base=0.3),
    "poly": dict(power=2.0, max_iter=10),
    "multistep": dict(gamma=0.1, steps=[4, 2]),
}


@pytest.mark.parametrize("policy", sorted(POLICIES))
def test_lr_policy_scale_matches_the_jax_unit(policy):
    kw = POLICIES[policy]
    ju = jlr.LearningRateAdjust(policy=policy, **kw)
    pu = lr_adjust.LearningRateAdjust(policy=policy, **kw)
    for it in range(12):
        ju.iteration = pu.iteration = it
        assert pu.current_scale == ju.current_scale, (policy, it)
    import pickle
    assert pickle.loads(pickle.dumps(pu)).current_scale == pu.current_scale


def _mlp(pkg_wf, loader_cls, pkg_prng):
    pkg_prng.seed_all(1234)
    loader = loader_cls(n_classes=5, sample_shape=(6, 6), n_validation=50,
                        n_train=200, minibatch_size=50, noise=0.5)
    return pkg_wf(
        layers=[{"type": "all2all_tanh", "output_sample_shape": 16,
                 "weights_stddev": 0.05},
                {"type": "softmax", "output_sample_shape": 5,
                 "weights_stddev": 0.05}],
        loader=loader, loss="softmax", n_classes=5,
        decision_config={"max_epochs": 2, "fail_iterations": 50},
        gd_config={"learning_rate": 0.1, "gradient_moment": 0.9},
        name="LrTest")


def _splice(wf, lr_cls):
    """The JAX package's wiring (tests/test_misc_services.py): the
    schedule fires after the gradient chain, once per train minibatch."""
    lr = lr_cls(wf, policy="exp", gamma=0.9).link_gds(wf.gds)
    wf.repeater.unlink_from(wf.gds[-1])
    lr.link_from(wf.gds[-1])
    wf.repeater.link_from(lr)
    lr.gate_skip = wf.loader.not_train
    return lr


@pytest.mark.parametrize("backend", ["numpy", "torch"])
def test_lr_adjust_drives_the_update_as_in_the_jax_graph(backend):
    jwf = _mlp(JStandardWorkflow, JSynthetic, jprng)
    jlr_u = _splice(jwf, jlr.LearningRateAdjust)
    jwf.initialize(device=NumpyDevice() if backend == "numpy"
                   else XLADevice())
    jwf.run()
    pwf = _mlp(StandardWorkflow, SyntheticClassifierLoader, prng)
    plr = _splice(pwf, lr_adjust.LearningRateAdjust)
    pwf.initialize(device="cpu", backend=backend)
    pwf.run()
    assert plr.iteration == jlr_u.iteration == 7
    assert [g.lr_scale for g in pwf.gds] == [g.lr_scale for g in jwf.gds]
    assert pwf.gds[0].lr_scale == pytest.approx(0.9 ** 6)
    for ju, pu in zip(jwf.forwards, pwf.forwards):
        for k, t in pu.param_arrays().items():
            if backend == "numpy":
                np.testing.assert_array_equal(
                    t.detach().numpy(), np.asarray(getattr(ju, k).mem))
            else:
                np.testing.assert_allclose(
                    t.detach().numpy(), np.asarray(getattr(ju, k).mem),
                    rtol=1e-4, atol=1e-6)
    jwf._stop_units()


# -- the command line ---------------------------------------------------------

CLI_TOY = ["root.alexnet.loader.input_hw=67", "root.alexnet.width_mult=0.125",
           "root.alexnet.fc_width=64", "root.alexnet.n_classes=16",
           "root.alexnet.loader.n_train=8",
           "root.alexnet.loader.n_validation=4",
           "root.alexnet.loader.minibatch_size=4"]


def _cli(*args, timeout=300):
    cmd = [sys.executable, "-m", "veles_tpu_torch",
           "veles_tpu_torch/samples/alexnet.py", *args]
    env = dict(os.environ, PYTHONPATH=str(REPO))
    return subprocess.run(cmd, cwd=REPO, env=env, capture_output=True,
                          text=True, timeout=timeout)


@pytest.mark.parametrize("backend", ["torch", "numpy"])
def test_cli_trains_through_the_granular_graph(backend):
    r = _cli("--device", "cpu", "-r", "1", "-b", backend,
             "--nonfinite-guard", *CLI_TOY,
             "root.alexnet.decision.max_epochs=1")
    assert r.returncode == 0, r.stderr[-2000:]
    line = r.stdout.strip().splitlines()[-1]
    assert line.startswith("TRAINED 1 epochs: loss "), line
    assert "'epoch': 1" in line and "'train_err'" in line


@pytest.mark.parametrize("flag", ["-s", "--snapshot-dir", "--supervise"])
def test_cli_takes_the_snapshot_flags_without_fused(tmp_path, flag):
    if flag == "-s":
        from veles_tpu_torch.snapshotter import Snapshotter
        saved = root.alexnet.to_dict()
        try:
            root.alexnet.decision.max_epochs = 1
            prng.seed_all(1)
            wf = alexnet.create_workflow(
                minibatch_size=4, input_hw=67, n_classes=16,
                width_mult=0.125, fc_width=64, n_train=8, n_validation=4)
            wf.initialize(device="cpu")
            extra = ["-s", Snapshotter(wf, directory=str(tmp_path),
                                       prefix="cli").export()]
        finally:
            root.alexnet = saved
    elif flag == "--snapshot-dir":
        extra = ["--snapshot-dir", str(tmp_path)]
    else:
        extra = ["--supervise", "--snapshot-dir", str(tmp_path),
                 "--stall-timeout", "0"]
    r = _cli("--device", "cpu", "-r", "1", *extra, *CLI_TOY,
             "root.alexnet.decision.max_epochs=1")
    assert r.returncode == 0, r.stderr[-2000:]
    line = [ln for ln in r.stdout.splitlines()
            if ln.startswith("TRAINED")][-1]
    assert line.startswith("TRAINED 1 epochs: loss "), line
    assert "'train_err'" in line


@pytest.mark.parametrize("flags, says", [
    (["--accum", "2"], "combine with --fused"),
    (["--feed-ahead", "1"], "combine it with --fused"),
    (["--serve", "0", "-b", "numpy"], "without --fused and --serve"),
], ids=["flags3-combine with --fused", "flags4-combine it with --fused",
        "flags5-without --fused and --serve"])
def test_cli_refuses_what_the_granular_graph_does_not_take(flags, says):
    r = _cli("--device", "cpu", *flags, *CLI_TOY, timeout=120)
    assert r.returncode == 2, (r.returncode, r.stderr[-2000:])
    assert says in r.stderr, r.stderr[-2000:]
