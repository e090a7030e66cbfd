"""The port's granular units on the CPU against the JAX package's
(`XLADevice`, the units' jitted `ops/xla.py` functions, f32 with the
conftest's "highest" matmul precision) on the same numpy inputs.

- Each forward unit and its gradient unit (conv with each activation,
  all2all with each activation, LRN, max pooling, dropout, and the
  softmax head through the evaluator into `GDSoftmax`) start from the JAX
  unit's parameters and take two forward/backward/update rounds with
  momentum, weight decay and the bias multiplier; outputs, err_input,
  parameters and velocities agree to rtol 1e-4, atol 1e-6 (the two
  packages sum their products and convolutions in other orders), the max
  pooling's winner offsets exactly, on windows of equal values included.
- Dropout runs with the JAX unit's own mask, handed to the port through
  `dropout.make_mask` (the two random streams cannot agree).
- The toy AlexNet (`width_mult=0.125`, `input_hw=67`, `fc_width=64`, as
  tests/test_alexnet_functional.py) trains one granular epoch in both
  packages, the JAX masks handed over: the Decision's error counts
  equal, the last loss to rtol 1e-4, parameters and velocities to
  rtol 1e-3, atol 1e-5 (two updates through eight layers); and the
  port's granular epoch gives the port's fused epoch's validation counts.
"""

import numpy as np
import pytest
import torch

import veles_tpu.workflow as jworkflow
from veles_tpu import prng as jprng
from veles_tpu.backends import XLADevice
from veles_tpu.config import root as jroot
from veles_tpu.samples import alexnet as jalexnet
from veles_tpu.znicz import all2all as jall2all
from veles_tpu.znicz import conv as jconv
from veles_tpu.znicz import dropout as jdropout
from veles_tpu.znicz import normalization as jnorm
from veles_tpu.znicz import pooling as jpooling
from veles_tpu.znicz.evaluator import EvaluatorSoftmax as JEvaluator
from veles_tpu.znicz.nn_units import gd_for as jgd_for
from veles_tpu_torch import prng, root
from veles_tpu_torch import workflow as pworkflow
from veles_tpu_torch.backends import TorchDevice
from veles_tpu_torch.samples import alexnet
from veles_tpu_torch.znicz import all2all, conv, dropout, normalization, \
    pooling
from veles_tpu_torch.znicz import standard_workflow  # noqa: F401 (pairs)
from veles_tpu_torch.znicz.evaluator import EvaluatorSoftmax
from veles_tpu_torch.znicz.nn_units import gd_for, unit_for

RTOL, ATOL = 1e-4, 1e-6
GD_KW = dict(learning_rate=0.05, gradient_moment=0.9, weights_decay=5e-4,
             learning_rate_bias=2.0)


@pytest.fixture(autouse=True)
def _restore_seeds():
    saved = jprng._base_seed, prng._base_seed
    yield
    jprng._base_seed, prng._base_seed = saved


def _close(a, b, what, rtol=RTOL, atol=ATOL):
    np.testing.assert_allclose(np.asarray(b), np.asarray(a), rtol=rtol,
                               atol=atol, err_msg=what)


def _port_host(v):
    return v.detach().cpu().numpy() if isinstance(v, torch.Tensor) \
        else np.asarray(v.mem)


class Pair:
    """One layer as a JAX forward + gradient unit and as the port's layer,
    node and gradient unit; the port starts from the JAX parameters."""

    def __init__(self, jcls, pcls, x, gd_kw=GD_KW, **kw):
        jprng.seed_all(3)
        self.jwf = jworkflow.Workflow(name="j")
        self.jf = jcls(self.jwf, **kw)
        self.jf.input.reset(x)
        self.jf.initialize(device=XLADevice())
        self.pwf = pworkflow.Workflow(name="p")
        layer = pcls(**kw)
        self.pf = unit_for(pcls)(self.pwf, layer=layer)
        self.pf.input.reset(x)
        self.pf.input_sample_shape = x.shape[1:]
        self.dev = TorchDevice("cpu")
        self.pf.initialize(device=self.dev)
        with torch.no_grad():
            for k, t in layer.param_arrays().items():
                t.copy_(torch.from_numpy(np.array(getattr(self.jf, k).mem)))
        self.jg = jgd_for(jcls)(self.jwf, **gd_kw)
        self.jg.link_forward(self.jf)
        self.pg = gd_for(pcls)(self.pwf, **gd_kw)
        self.pg.link_forward(self.pf)

    def forward(self):
        self.jf.run()
        self.pf.run()
        _close(self.jf.output.mem, self.pf.output.mem, "output")

    def backward(self, err):
        for g, dev in ((self.jg, XLADevice()), (self.pg, self.dev)):
            g.err_output.reset(err)
            if not g.is_initialized:
                assert g.initialize(device=dev) is not False
            g.run()
        _close(self.jg.err_input.mem, self.pg.err_input.mem, "err_input")
        for k in self.pg._pnames:
            _close(getattr(self.jg, k).mem, getattr(self.pg, k).mem, k)
            jv = getattr(self.jg, self.pg.vel_attr(k))
            _close(jv.mem, _port_host(self.pg.velocity(k)), f"vel {k}")

    def rounds(self, n=2, seed=11):
        rng = np.random.RandomState(seed)
        for _ in range(n):
            self.forward()
            self.backward(rng.randn(*self.jf.output.shape)
                          .astype(np.float32) * 0.1)


def _x(shape, seed=5):
    return np.random.RandomState(seed).randn(*shape).astype(np.float32)


@pytest.mark.parametrize("kind", ["Conv", "ConvTanh", "ConvRELU",
                                  "ConvStrictRELU", "ConvSigmoid"])
def test_conv_unit_pair_tracks_the_jax_units(kind):
    Pair(getattr(jconv, kind), getattr(conv, kind), _x((4, 9, 9, 3)),
         n_kernels=6, kx=3, ky=3, stride=(2, 2), padding=(1, 1)).rounds()


@pytest.mark.parametrize("kind", ["All2All", "All2AllTanh", "All2AllRELU",
                                  "All2AllStrictRELU", "All2AllSigmoid"])
def test_all2all_unit_pair_tracks_the_jax_units(kind):
    Pair(getattr(jall2all, kind), getattr(all2all, kind), _x((6, 3, 3, 4)),
         output_sample_shape=7).rounds()


def test_lrn_unit_pair_tracks_the_jax_units():
    p = Pair(jnorm.LRNormalizerForward, normalization.LRNormalizerForward,
             _x((3, 4, 5, 16)) * 3, k=2.0, alpha=1e-2, beta=0.75, n=5)
    p.rounds()


def test_max_pooling_pair_records_the_jax_winners_on_ties():
    x = np.maximum(_x((3, 9, 9, 4)), 0)    # ReLU'd: windows tie at 0
    x[0, :5, :5, :] = 0.0                  # whole windows of zeros
    x[1, 2, 2, 1] = x[1, 2, 3, 1] = x[1, 3, 2, 1] = 7.0   # ties at a max
    p = Pair(jpooling.MaxPooling, pooling.MaxPooling, x, ksize=(3, 3),
             stride=(2, 2))
    p.forward()
    np.testing.assert_array_equal(p.pf.input_offset.mem,
                                  np.asarray(p.jf.input_offset.mem))
    assert (x.reshape(-1)[p.pf.input_offset.mem] == p.pf.output.mem).all()
    p.backward(_x(p.jf.output.shape, 9))


def test_dropout_pair_with_the_jax_mask(monkeypatch):
    x = _x((4, 10))
    p = Pair(jdropout.DropoutForward, dropout.DropoutForward, x,
             dropout_ratio=0.5)
    p.jf.run()
    mask = np.asarray(p.jf.mask.mem)
    assert 0.2 < float((mask > 0).mean()) < 0.8
    monkeypatch.setattr(dropout, "make_mask",
                        lambda shape, ratio, gen, device, dtype=None:
                        torch.tensor(mask))
    p.pf.run()
    _close(p.jf.output.mem, p.pf.output.mem, "output")
    p.backward(_x(x.shape, 2))
    # a non-train minibatch passes through, and draws no mask
    p.jf.minibatch_class = p.pf.minibatch_class = 1
    p.jf.run()
    p.pf.run()
    _close(x, p.pf.output.mem, "eval output")


def test_softmax_head_through_the_evaluator_into_gd_softmax():
    x = _x((8, 12))
    labels = np.random.RandomState(1).randint(0, 5, 8)
    valid = np.ones(8, np.float32)
    valid[-2:] = 0.0                       # pad-mask rows drop out
    p = Pair(jall2all.All2AllSoftmax, all2all.All2AllSoftmax, x,
             output_sample_shape=5)
    jev = JEvaluator(p.jwf, n_classes=5)
    jev.link_attrs(p.jf, ("input", "output"))
    jev.labels.reset(labels)
    jev.sample_weights.reset(valid)
    pev = EvaluatorSoftmax(p.pwf, n_classes=5)
    pev.link_attrs(p.pf, ("input", "output"))
    pev.labels.reset(labels)
    pev.sample_weights.reset(valid)
    jev.initialize(device=XLADevice())
    pev.initialize(device=p.dev)
    for _ in range(2):
        p.forward()
        np.testing.assert_array_equal(p.pf.max_idx.mem,
                                      np.asarray(p.jf.max_idx.mem))
        jev.run()
        pev.run()
        assert pev.n_err == int(jev.n_err)
        np.testing.assert_allclose(pev.loss, float(jev.loss), rtol=1e-5)
        _close(jev.err_output.mem, pev.err_output.mem, "evaluator err")
        p.backward(np.asarray(jev.err_output.mem))


# -- the toy AlexNet: one granular epoch -------------------------------------

TOY = dict(minibatch_size=16, input_hw=67, width_mult=0.125, fc_width=64,
           n_train=48, n_validation=16, n_classes=8, init="scaled")


def _toy(pkg_root, pkg_prng, create, epochs=1):
    pkg_prng.seed_all(4321)
    pkg_root.alexnet.decision.max_epochs = epochs
    pkg_root.alexnet.decision.fail_iterations = 99
    pkg_root.alexnet.gd.learning_rate = 0.01
    return create(**TOY)


@pytest.fixture
def alexnet_roots():
    saved = jroot.alexnet.to_dict(), root.alexnet.to_dict()
    yield
    jroot.alexnet, root.alexnet = saved


def test_toy_alexnet_granular_epoch_tracks_the_jax_epoch(monkeypatch,
                                                        alexnet_roots):
    masks = []
    real_run = jdropout.DropoutForward.xla_run

    def recording_run(self):
        real_run(self)
        if self.training:
            masks.append(np.array(self.mask.mem))

    monkeypatch.setattr(jdropout.DropoutForward, "xla_run", recording_run)
    jwf = _toy(jroot, jprng, jalexnet.create_workflow)
    jwf.initialize(device=XLADevice())
    jwf.run()
    pwf = _toy(root, prng, alexnet.create_workflow)
    handed = list(masks)
    monkeypatch.setattr(dropout, "make_mask",
                        lambda shape, ratio, gen, device, dtype=None:
                        torch.tensor(handed.pop(0)))
    pwf.initialize(device="cpu")
    pwf.run()
    assert len(masks) == 6 and not handed   # 3 train minibatches, 2 units
    assert pwf.decision.history == jwf.decision.history
    np.testing.assert_allclose(pwf.evaluator.loss, float(jwf.evaluator.loss),
                               rtol=1e-4)
    n = len(pwf.forwards)
    assert [g.run_count for g in pwf.gds] == [g.run_count for g in jwf.gds]
    assert pwf.gds[0].run_count == 2       # the last update is skipped
    for i, (ju, pu) in enumerate(zip(jwf.forwards, pwf.forwards)):
        jg, pg = jwf.gds[n - 1 - i], pwf.gds[n - 1 - i]
        for k, t in pu.param_arrays().items():
            _close(getattr(ju, k).mem, t.detach().numpy(), f"unit {i} {k}",
                   1e-3, 1e-5)
            _close(getattr(jg, pg.vel_attr(k)).mem,
                   pg.velocity(k).numpy(), f"unit {i} velocity {k}",
                   1e-3, 1e-5)
    jwf._stop_units()


def test_toy_alexnet_granular_epoch_metrics_match_the_fused_epoch(
        alexnet_roots):
    g = _toy(root, prng, alexnet.create_workflow)
    g.initialize(device="cpu")
    g.run()
    f = _toy(root, prng, alexnet.create_workflow)
    f.run_fused(device="cpu")
    # the dropout-free test and validation passes run on the same initial
    # weights; the train pass draws other masks in the two loops
    assert g.decision.best_validation_err == f.decision.best_validation_err
    assert g.decision.epoch_n_err[:2] == f.decision.epoch_n_err[:2]
    assert g.decision.epoch_number == f.decision.epoch_number == 1


def test_a_fused_run_continues_from_the_granular_weights(alexnet_roots):
    wf = _toy(root, prng, alexnet.create_workflow)
    wf.initialize(device="cpu")
    first = [t.detach().clone() for u in wf.forwards
             for t in u.param_arrays().values()]
    wf.run()
    trained = [t.detach().clone() for u in wf.forwards
               for t in u.param_arrays().values()]
    assert any(not torch.equal(a, b) for a, b in zip(first, trained))
    step = wf.build_fused_step()
    state = step.init_state()
    for got, want in zip([t for p in state["params"] for t in p.values()],
                         trained):
        assert torch.equal(got.detach(), want)
    # an SGD twin seeds the step's velocities from the granular ones
    for g, v in zip(step.gd_units, state["vel"]):
        for k, t in v.items():
            assert torch.equal(t, g.velocity(k))


def test_granular_pickle_keeps_host_arrays_and_rewires_gates(alexnet_roots):
    import pickle
    wf = _toy(root, prng, alexnet.create_workflow)
    wf.initialize(device="cpu")
    wf.run()
    back = pickle.loads(pickle.dumps(wf))
    assert back.restored and not back.is_initialized
    assert isinstance(back.fwd_units[0].output, type(wf.fwd_units[0].output))
    np.testing.assert_array_equal(back.fwd_units[0].output.mem,
                                  wf.fwd_units[0].output.mem)
    back.decision.complete = False
    back._wire_gates()
    assert not bool(back.gds[0].gate_skip) or bool(back.loader.not_train)
    back.decision.complete = True
    assert bool(back.gds[0].gate_skip) and bool(back.repeater.gate_block)
