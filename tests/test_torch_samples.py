"""BASELINE configurations 1 and 2 and the small samples in the port,
held against the JAX package's functional tests on the CPU.

- MNIST (tests/test_mnist_functional.py's twin): the All2AllTanh →
  softmax workflow trains below 20 errors of 100 in 3 epochs on both
  backends, with the JAX test's run counts; the two backends agree
  (first-layer weights rtol 2e-3, atol 2e-4; validation errors within
  3); a pickled numpy run resumes and keeps training; early stop on
  patience. The sample's own workflow, one granular epoch on the numpy
  backend, equals the JAX package's numpy run bit for bit (parameters,
  velocities, history, loss, the confusion matrix).
- CIFAR-10 (tests/test_cifar_functional.py's twin): the conv / max pool
  / LRN / conv / avg pool / FC / softmax tower below 30 errors of 100 in
  4 epochs on the numpy backend (the torch backend and the fused step:
  test_torch_samples_cli.py); the fused step tracks the JAX
  `FusedTrainStep` (Pallas in interpret mode) for 3 steps: loss rtol
  1e-5, n_err equal, parameters and velocities rtol 1e-4, atol 1e-7.
- MnistSimple and Wine (tests/test_sample_breadth.py's twin): one softmax
  layer below 25 errors of 100 (MnistSimple), and Wine trains.
- AlexNet (the second case of tests/test_alexnet_functional.py): one
  granular epoch's validation errors equal the fused epoch's.
"""

import pickle

import numpy as np
import pytest
import torch

from veles_tpu import prng as jprng
from veles_tpu.backends import NumpyDevice
from veles_tpu.config import root as jroot
from veles_tpu.ops import variants as jvariants
from veles_tpu.samples import cifar10 as jcifar10
from veles_tpu.samples import mnist as jmnist
from veles_tpu_torch import convert, prng
from veles_tpu_torch.config import root
from veles_tpu_torch.loader.synthetic import SyntheticClassifierLoader
from veles_tpu_torch.samples import alexnet, cifar10, mnist, \
    mnist_simple, wine
from veles_tpu_torch.znicz.standard_workflow import StandardWorkflow

LOSS_RTOL = 1e-5
RTOL, ATOL = 1e-4, 1e-7


@pytest.fixture(autouse=True, scope="module")
def _two_threads():
    """2 intra-op threads for this file's small ops, so that the suite's
    workers do not oversubscribe the cores; restored after."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


#: the samples' configuration trees as their modules set them, taken when
#: this file is imported (before any test runs): a test of another file in
#: the same worker may leave, say, the JAX `root.mnist.loader.minibatch_size`
#: changed, and the pairs below hold both packages to the same settings
_AT_IMPORT = [(node, node.to_dict()) for node in (
    root.cifar, root.mnist, root.mnist_simple, root.alexnet, jroot.cifar,
    jroot.mnist)]


@pytest.fixture(autouse=True)
def _restore():
    saved = (jprng._base_seed, prng._base_seed, root.cifar.to_dict(),
             root.mnist.to_dict(), root.mnist_simple.to_dict(),
             jroot.cifar.to_dict(), jroot.mnist.to_dict(),
             root.alexnet.to_dict())
    for node, values in _AT_IMPORT:
        node.update(values)
    yield
    (jprng._base_seed, prng._base_seed, cifar, mn, ms, jcifar,
     jmn, alex) = saved
    root.alexnet.update(alex)
    root.cifar.update(cifar)
    root.mnist.update(mn)
    root.mnist_simple.update(ms)
    jroot.cifar.update(jcifar)
    jroot.mnist.update(jmn)


def build_mnist(max_epochs=3):
    """tests/test_mnist_functional.py's `build`, in the port."""
    prng.seed_all(1234)
    loader = SyntheticClassifierLoader(
        n_classes=10, sample_shape=(8, 8), n_validation=100, n_train=500,
        minibatch_size=50, noise=0.6)
    return StandardWorkflow(
        layers=[
            {"type": "all2all_tanh", "output_sample_shape": 32,
             "weights_stddev": 0.05},
            {"type": "softmax", "output_sample_shape": 10,
             "weights_stddev": 0.05},
        ],
        loader=loader, loss="softmax", n_classes=10,
        decision_config={"max_epochs": max_epochs, "fail_iterations": 50},
        gd_config={"learning_rate": 0.1, "gradient_moment": 0.9},
        name="TestMnist")


@pytest.mark.parametrize("backend", ["numpy", "torch"])
def test_mnist_trains_to_low_error(backend):
    wf = build_mnist(max_epochs=3)
    wf.initialize(device="cpu", backend=backend)
    wf.run()
    assert wf.decision.epoch_number == 3
    assert wf.decision.best_validation_err <= 20, \
        wf.decision.best_validation_err
    n_steps = wf.decision.epoch_number * (500 // 50 + 100 // 50)
    assert wf.fwd_units[0].run_count == n_steps
    # the last train minibatch's update is skipped once the Decision
    # completes
    assert wf.gds[0].run_count == wf.decision.epoch_number * (500 // 50) - 1


def test_mnist_backends_agree():
    wf_np = build_mnist(max_epochs=1)
    wf_np.initialize(device="cpu", backend="numpy")
    wf_np.run()
    wf_t = build_mnist(max_epochs=1)
    wf_t.initialize(device="cpu", backend="torch")
    wf_t.run()
    assert wf_np.decision.epoch_n_err[1] == pytest.approx(
        wf_t.decision.epoch_n_err[1], abs=3)
    np.testing.assert_allclose(wf_np.params_host()[0]["weights"],
                               wf_t.params_host()[0]["weights"], rtol=2e-3,
                               atol=2e-4)


def test_mnist_snapshot_resume_keeps_training():
    """A pickled numpy run re-derives its gates and trains on."""
    wf = build_mnist(max_epochs=2)
    wf.initialize(device="cpu", backend="numpy")
    wf.run()
    wf2 = pickle.loads(pickle.dumps(wf))
    assert wf2.restored
    wf2.decision.max_epochs = 4
    wf2.decision.complete <<= False
    w_before = wf2.params_host()[0]["weights"].copy()
    gd_runs_before = wf2.gds[0].run_count
    wf2.initialize(device="cpu", backend="numpy")
    wf2.run()
    assert wf2.decision.epoch_number == 4
    assert wf2.gds[0].run_count > gd_runs_before
    assert not np.allclose(wf2.params_host()[0]["weights"], w_before)


def test_mnist_early_stop_on_patience():
    wf = build_mnist(max_epochs=100)
    wf.decision.fail_iterations = 2
    wf.initialize(device="cpu", backend="numpy")
    wf.run()
    assert wf.decision.epoch_number < 100


def _sample_pair(jmod, pmod, node, overrides, seed=1234):
    """The sample's workflow in both packages at `overrides` (config
    keys under `node`)."""
    for r in (jroot, root):
        for k, v in overrides.items():
            getattr(r, node).override(k, v)
    jprng._generators.clear()
    jprng.seed_all(seed)
    jwf = jmod.create_workflow()
    prng._generators.clear()
    prng.seed_all(seed)
    return jwf, pmod.create_workflow()


def test_mnist_sample_numpy_run_is_bit_equal_to_jax():
    jwf, pwf = _sample_pair(jmnist, mnist, "mnist", {
        "loader.n_train": 300, "loader.n_validation": 100,
        "decision.max_epochs": 1})
    jwf.initialize(device=NumpyDevice())
    jwf.run()
    pwf.initialize(device="cpu", backend="numpy")
    pwf.run()
    n = len(pwf.forwards)
    for i, (ju, pu) in enumerate(zip(jwf.forwards, pwf.forwards)):
        jg, pg = jwf.gds[n - 1 - i], pwf.gds[n - 1 - i]
        for k, t in pu.param_arrays().items():
            np.testing.assert_array_equal(t.detach().numpy(),
                                          np.asarray(getattr(ju, k).mem))
            np.testing.assert_array_equal(
                pg.velocity(k).numpy(),
                np.asarray(getattr(jg, pg.vel_attr(k)).mem))
    assert pwf.decision.history == jwf.decision.history
    assert pwf.evaluator.loss == jwf.evaluator.loss
    np.testing.assert_array_equal(pwf.evaluator.confusion_matrix.mem,
                                  jwf.evaluator.confusion_matrix.mem)
    jwf._stop_units()


def build_cifar(max_epochs=2):
    """tests/test_cifar_functional.py's `build`, in the port."""
    prng.seed_all(1234)
    root.cifar.loader.n_train = 300
    root.cifar.loader.n_validation = 100
    root.cifar.loader.minibatch_size = 50
    root.cifar.decision.max_epochs = max_epochs
    return cifar10.create_workflow()


def test_cifar_trains_below_chance_on_the_goldens():
    """The JAX test's NumpyDevice case; its XLADevice case and
    `test_cifar_fused_trains` are test_torch_samples_cli.py's granular and
    fused CLI runs at the same sizes, seed and threshold."""
    wf = build_cifar(max_epochs=4)
    wf.initialize(device="cpu", backend="numpy")
    wf.run()
    assert wf.decision.epoch_number == 4
    assert wf.decision.best_validation_err < 30, \
        wf.decision.best_validation_err


class _Selected:
    """Select registry variants for a block and restore the previous
    selections afterwards (the registries are process-global)."""

    def __init__(self, registry, **sel):
        self.registry, self.sel = registry, sel

    def __enter__(self):
        self.prev = {op: self.registry.selected(op) for op in self.sel}
        for op, name in self.sel.items():
            self.registry.select(op, name)

    def __exit__(self, *exc):
        for op, name in self.prev.items():
            if name is None:
                self.registry.clear_selection(op)
            else:
                self.registry.select(op, name)


def test_cifar_fused_step_tracks_the_jax_step():
    jwf, pwf = _sample_pair(jcifar10, cifar10, "cifar", {
        "loader.n_train": 100, "loader.n_validation": 20,
        "loader.minibatch_size": 20}, seed=7)
    jwf.initialize(device=None)
    pwf.initialize("cpu")
    with jvariants.pallas_interpret(), \
            _Selected(jvariants, lrn="pallas_one_pass",
                      sgd_update="pallas_rows[rt=8]"):
        jstep = jwf.build_fused_step()
        pstep = pwf.build_fused_step()
        assert pstep.fusion_pairs() == []
        jstate = jstep.init_state()
        pstate = pstep.init_state()
        _compare_states(jstate, pstate, "initial state")
        rs = np.random.RandomState(3)
        for i in range(3):
            x = rs.randn(20, 32, 32, 3).astype(np.float32)
            y = rs.randint(0, 10, 20)
            w = np.ones(20, np.float32)
            if i == 1:
                w[-2:] = 0.0
            jstate, (jloss, jerr) = jstep.train(jstate, x, y, w)
            pstate, (ploss, perr) = pstep.train(pstate, x, y, w)
            np.testing.assert_allclose(float(ploss), float(jloss),
                                       rtol=LOSS_RTOL, err_msg=f"step {i}")
            assert int(perr) == int(jerr), i
            _compare_states(jstate, pstate, f"after step {i}")
    jwf._stop_units()


def _compare_states(jstate, pstate, what):
    host = convert.state_to_numpy(pstate)
    for slot in ("params", "vel"):
        for i, (a, b) in enumerate(zip(jstate[slot], host[slot])):
            assert sorted(a) == sorted(b)
            for k in a:
                np.testing.assert_allclose(
                    b[k], np.asarray(a[k]), rtol=RTOL, atol=ATOL,
                    err_msg=f"{what}: {slot} unit {i} {k}")


def test_mnist_simple_trains():
    prng.seed_all(1234)
    root.mnist_simple.loader.n_train = 500
    root.mnist_simple.loader.n_validation = 100
    root.mnist_simple.decision.max_epochs = 3
    wf = mnist_simple.create_workflow()
    wf.initialize(device="cpu", backend="torch")
    wf.run()
    assert wf.decision.epoch_number == 3
    assert wf.decision.best_validation_err <= 25, \
        wf.decision.best_validation_err
    assert len(wf.forwards) == 1


def test_wine_trains():
    prng.seed_all(1234)
    wf = wine.create_workflow()
    wf.run_fused(device="cpu")
    # 3 classes, 40 validation rows: chance is ~27 errors
    assert wf.decision.best_validation_err <= 10, \
        wf.decision.best_validation_err


def _small_alexnet(epochs):
    """tests/test_alexnet_functional.py's `_small`, in the port."""
    prng.seed_all(4321)
    root.alexnet.decision.max_epochs = epochs
    root.alexnet.decision.fail_iterations = 99
    root.alexnet.gd.learning_rate = 0.01
    return alexnet.create_workflow(minibatch_size=16, input_hw=67,
                                   width_mult=0.125, fc_width=64,
                                   n_train=160, n_validation=48,
                                   n_classes=8, init="scaled")


def test_alexnet_fused_matches_granular_epoch_metrics():
    wf_g = _small_alexnet(epochs=1)
    wf_g.initialize(device="cpu", backend="torch")
    wf_g.run()
    wf_f = _small_alexnet(epochs=1)
    wf_f.run_fused(device="cpu")
    # the dropout-free validation pass (the train pass counts through
    # dropout, whose masks the two schedules draw in another order)
    assert int(wf_g.decision.best_validation_err) == \
        int(wf_f.decision.best_validation_err)
    assert [int(m) for m in wf_g.decision.epoch_n_err[:2]] == \
        [int(m) for m in wf_f.decision.epoch_n_err[:2]]
