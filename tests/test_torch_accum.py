"""Gradient accumulation in the port (`FusedTrainStep.train_accum`,
`run_fused(accum_steps=K)`, the CLI's `--accum K`) on the CPU, held
against the port's full-batch step and against the JAX package's
`train_accum` and `run_fused(accum_steps=K)`.

The workflow is the JAX fused-step tests' FC workflow
(tests/test_parallel_fused.py `build`: a scaled-tanh layer of 32 and a
softmax of 10 on 8x8 synthetic samples, SGD lr 0.1 momentum 0.9), built
in both packages from one seed. Tolerances:
- `train_accum(k=4)` against the port's own `train` on the full batch of
  48 with `w[-5:] = 0`: the JAX test's, loss rel 1e-5 and parameters
  rtol 1e-5, atol 1e-6 (k microbatch gradient sums against one sum);
- the port's `train_accum` against the JAX `train_accum` on the same
  state: the port's train-step tolerances (loss rtol 1e-5; leaves,
  velocities and moments rtol 1e-4, atol 1e-7; with Adam's sign-trap
  allowance of tests/test_torch_adam.py, which these batches do not use);
- `run_fused(accum_steps=4)` for 3 epochs in both packages: the
  Decision's history equal, the loss rtol 1e-5, the written-back
  parameters and velocities rtol 1e-4, atol 1e-7.
"""

from pathlib import Path

import numpy as np
import pytest
import torch

from veles_tpu import prng as jprng
from veles_tpu_torch import launcher, prng, root
from veles_tpu_torch.resilience.supervisor import strip_flags
from veles_tpu_torch.znicz.standard_workflow import AccumulatingStep
from tests.test_torch_adam import compare_adam, compare_states, fc_batch, \
    fc_workflows
from tests.test_torch_train_step import _workflows

ALEXNET = str(Path(__file__).resolve().parent.parent / "veles_tpu_torch"
              / "samples" / "alexnet.py")
SGD = {"learning_rate": 0.1, "gradient_moment": 0.9}
TOY_CLI = ["root.alexnet.loader.input_hw=67", "root.alexnet.width_mult=0.125",
           "root.alexnet.fc_width=64", "root.alexnet.n_classes=16",
           "root.alexnet.loader.minibatch_size=8",
           "root.alexnet.loader.n_train=16",
           "root.alexnet.loader.n_validation=8",
           "root.alexnet.decision.max_epochs=1"]


@pytest.fixture(autouse=True, scope="module")
def _own_autotune_cache(tmp_path_factory):
    """A plain `--fused` run applies the autotune cache's winners: this
    module's runs read a cache of their own, not one under HOME."""
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("VELES_AUTOTUNE_CACHE",
                  str(tmp_path_factory.mktemp("autotune") / "autotune.json"))
        yield


@pytest.fixture(autouse=True)
def _restore_base_seeds():
    saved = jprng._base_seed, prng._base_seed
    yield
    jprng._base_seed, prng._base_seed = saved


@pytest.mark.parametrize("optimizer", ["sgd", "adam"])
def test_train_accum_matches_full_batch(optimizer):
    jwf, pwf = fc_workflows(seed=1234, gd_config=SGD)
    jwf.initialize(device=None)
    pwf.initialize("cpu")
    for wf in (jwf, pwf):
        for g in wf.gds:
            g.optimizer = optimizer
    jstep, pstep = jwf.build_fused_step(), pwf.build_fused_step()
    x, y, w = fc_batch(21)
    w[-5:] = 0.0
    sa = pstep.init_state()
    sa, (loss_a, err_a) = pstep.train(sa, x, y, w)
    sb = pstep.init_state()
    sb, (loss_b, err_b) = pstep.train_accum(sb, x, y, 4, w)
    assert loss_b.dim() == 0 and err_b.dim() == 0
    assert float(loss_a) == pytest.approx(float(loss_b), rel=1e-5)
    assert int(err_a) == int(err_b)
    for pa, pb in zip(sa["params"], sb["params"]):
        for k in pa:
            np.testing.assert_allclose(pa[k].detach().numpy(),
                                       pb[k].detach().numpy(),
                                       rtol=1e-5, atol=1e-6)
    # ... and the JAX train_accum on the same state and batch
    js = jstep.init_state()
    js, (jloss, jerr) = jstep.train_accum(js, x, y, 4, w)
    np.testing.assert_allclose(float(loss_b), float(jloss), rtol=1e-5)
    assert int(err_b) == int(jerr)
    if optimizer == "adam":
        assert compare_adam(js, sb, "train_accum", 0.1, 1) == 0
        assert all(int(v["t"]) == 1 for v in sb["vel"])
    else:
        compare_states(js, sb, "train_accum")
    jwf._stop_units()


def test_train_accum_with_dropout_draws_microbatch_after_microbatch():
    _, pwf = _workflows(0.5)
    step = pwf.build_fused_step()
    rs = np.random.RandomState(4)
    x = rs.randn(8, 67, 67, 3).astype(np.float32)
    y = rs.randint(0, 16, 8)
    start = step.gen.get_state()
    s1, (l1, _) = step.train_accum(step.init_state(), x, y, 2)
    after = step.gen.get_state()
    assert not torch.equal(after, start)
    step.gen.set_state(start)
    s2, (l2, _) = step.train_accum(step.init_state(), x, y, 2)
    assert torch.equal(step.gen.get_state(), after)
    assert float(l1) == float(l2)
    for a, b in zip(s1["params"], s2["params"]):
        for k in a:
            assert torch.equal(a[k], b[k])


def test_train_accum_refuses_what_does_not_split():
    _, pwf = fc_workflows(gd_config=SGD)
    pwf.initialize("cpu")
    step = pwf.build_fused_step()
    x, y, w = fc_batch(3, n=48)
    with pytest.raises(ValueError, match="batch 48 not divisible by k=5"):
        step.train_accum(step.init_state(), x, y, 5, w)
    # flat (N·S,) per-token labels: the JAX function's reshape of y to
    # (k, N/k) cannot take them in local mode
    flat = np.repeat(y, 4)
    with pytest.raises(ValueError, match=r"x \(48, 8, 8\) and y \(192,\)"):
        step.train_accum(step.init_state(), x, flat, 4, w)


def test_run_fused_accum_steps_tracks_the_jax_run():
    jwf, pwf = fc_workflows(seed=1234, gd_config=SGD, max_epochs=3,
                            n_validation=96, n_train=480)
    jwf.run_fused(accum_steps=4, uint8_wire=False)
    seen = []
    from veles_tpu_torch.parallel.fused import FusedTrainStep
    inner = FusedTrainStep.train_accum

    def spy(self, state, x, y, k, w=None):
        seen.append((tuple(x.shape), k))
        return inner(self, state, x, y, k, w)

    FusedTrainStep.train_accum = spy
    try:
        pwf.run_fused(accum_steps=4, device="cpu")
    finally:
        FusedTrainStep.train_accum = inner
    assert seen == [((48, 8, 8), 4)] * 30       # 10 a epoch, 3 epochs
    assert pwf.decision.epoch_number == 3 and pwf.decision.complete
    assert pwf.decision.best_validation_err < 96        # learns something
    assert pwf.decision.history == jwf.decision.history
    assert pwf.decision.best_validation_err \
        == jwf.decision.best_validation_err
    np.testing.assert_allclose(pwf.evaluator.loss, float(jwf.evaluator.loss),
                               rtol=1e-5)
    n = len(pwf.forwards)
    for i, (ju, pu) in enumerate(zip(jwf.forwards, pwf.forwards)):
        jg, pg = jwf.gds[n - 1 - i], pwf.gds[n - 1 - i]
        for k, a in ju.param_arrays().items():
            np.testing.assert_allclose(
                pu.param_arrays()[k].detach().numpy(), np.asarray(a.mem),
                rtol=1e-4, atol=1e-7, err_msg=f"unit {i} {k}")
        for name in ("vel_w", "vel_b"):
            np.testing.assert_allclose(
                getattr(pg, name).numpy(), np.asarray(getattr(jg, name).mem),
                rtol=1e-4, atol=1e-7, err_msg=f"unit {i} {name}")
    jwf._stop_units()


def test_accumulating_step_keeps_the_step_surface():
    _, pwf = fc_workflows(gd_config=SGD)
    pwf.initialize("cpu")
    step = pwf.build_fused_step()
    acc = AccumulatingStep(step, 4)
    assert acc.device == step.device and acc.cfgs is step.cfgs
    assert acc.evaluate == step.evaluate and acc.gen is step.gen
    x, y, w = fc_batch(8)
    s1, (l1, _) = acc.train(step.init_state(), x, y, w)
    s2, (l2, _) = step.train_accum(step.init_state(), x, y, 4, w)
    assert float(l1) == float(l2)


@pytest.mark.parametrize("argv,msg", [
    (["--fused", "--accum", "0"], "--accum needs K >= 1 (got 0)"),
    (["--fused", "--accum", "-2"], "--accum needs K >= 1 (got -2)"),
    (["--serve", "0", "--accum", "2"],
     "--accum applies to the fused step: combine with --fused"),
])
def test_cli_refuses_accum_as_the_jax_launcher(argv, msg, capsys):
    with pytest.raises(SystemExit) as e:
        launcher.parse_args([ALEXNET, *argv])
    assert e.value.code == 2
    assert msg in capsys.readouterr().err


def test_cli_accum_reaches_run_fused_and_the_supervised_child():
    # --accum 1 is one microbatch: allowed with --serve, as in the JAX
    # launcher
    assert launcher.parse_args([ALEXNET, "--serve", "0", "--accum",
                                "1"]).accum == 1
    argv = [ALEXNET, "--fused", "--accum", "2", "--device", "cpu", "-r", "5",
            "--supervise", "--max-restarts", "1", *TOY_CLI]
    child = strip_flags(argv, launcher.supervisor_flags())
    assert child == [ALEXNET, "--fused", "--accum", "2", "--device", "cpu",
                     "-r", "5", *TOY_CLI]
    seen = []
    from veles_tpu_torch.parallel.fused import FusedTrainStep
    inner = FusedTrainStep.train_accum

    def spy(self, state, x, y, k, w=None):
        seen.append((tuple(x.shape), k))
        return inner(self, state, x, y, k, w)

    saved = root.alexnet.to_dict()
    prng._generators.clear()
    FusedTrainStep.train_accum = spy
    try:
        wf = launcher.train(child)
    finally:
        FusedTrainStep.train_accum = inner
        root.alexnet = saved
    assert seen == [((8, 67, 67, 3), 2)] * 2
    assert wf.decision.epoch_number == 1 and np.isfinite(wf.evaluator.loss)
