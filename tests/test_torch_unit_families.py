"""The slice's unit families held against the JAX package on the CPU:
the standalone activations, InputNormalize, the evaluators' confusion
matrix and the MSE loss, inputs from numpy seeds.

- Activations: `act_forward` / `act_backward` of every flavor (the log
  one, asinh, with its input) against ops/xla.py within rtol 1e-6,
  atol 1e-7 (transcendental functions of two libraries; the backward
  from the JAX forward's output), and each `activation_*` layer's
  forward.
- InputNormalize: the layer on uint8, f32 and bf16 x against the JAX
  layer (with a mean image) within 1 f32 ulp (rtol 2e-7, atol 1e-6: XLA
  may fuse the multiply-add; bf16 bit for bit), and a graph holding it
  negotiates no uint8 wire and gets its gradient unit.
- A stack of the slice's units (input_normalize, max-abs, average and
  stochastic pooling, log and tanh activations) one granular epoch on
  both packages' numpy backends: parameters, velocities and the
  Decision's history equal bit for bit (the stochastic samples from the
  same numpy stream), and the confusion matrix equal as integers; the
  same stack without the stochastic pooling on the port's torch backend
  against the JAX XLA backend within rtol 2e-3, atol 3e-4 (the JAX
  package's own cross-backend tolerance, tests/test_conv_units.py).
- The confusion matrix: `functional.confusion` and the softmax metrics'
  fourth output equal the JAX `softmax_ce`'s counts (pad rows counted
  nowhere); `FusedTrainStep.confusion` equals the JAX step's; with
  `plot_config={"confusion": True}` both modes keep each validation
  pass's matrix, whose counts sum to the validation rows and whose
  trace is the rows the pass got right.
- The MSE: `functional.mse` against `ox.mse` (weights, denominator);
  `EvaluatorMSE` granular on both backends against the JAX evaluator's
  run; the MSE fused step (the twin of the JAX package's
  tests/test_parallel_fused.py `test_mse_loss_fused`, local mode):
  reconstruction error below 5.0 after 15 epochs, and 2 epochs of
  `run_fused` against the JAX package's: history within rtol 1e-4.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from veles_tpu import prng as jprng
from veles_tpu.backends import NumpyDevice, XLADevice
from veles_tpu.loader.synthetic import \
    SyntheticClassifierLoader as JSynthetic
from veles_tpu.ops import xla as ox
from veles_tpu.znicz import activation as jactivation  # noqa: F401
from veles_tpu.znicz import normalization as jnormalization
from veles_tpu.znicz import pooling as jpooling  # noqa: F401
from veles_tpu.znicz.standard_workflow import \
    StandardWorkflow as JStandardWorkflow
from veles_tpu_torch import prng
from veles_tpu_torch.loader.synthetic import SyntheticClassifierLoader
from veles_tpu_torch.ops import functional as fn
from veles_tpu_torch.znicz import activation, normalization
from veles_tpu_torch.znicz.evaluator import EvaluatorMSE
from veles_tpu_torch.znicz.standard_workflow import LAYER_TYPES, \
    StandardWorkflow

ACTS = ("linear", "tanh", "relu", "strictrelu", "sigmoid", "log")
ACT_RTOL, ACT_ATOL = 1e-6, 1e-7
XB_RTOL, XB_ATOL = 2e-3, 3e-4

STACK = [
    {"type": "input_normalize", "scale": 0.5, "offset": 0.1},
    {"type": "conv_strictrelu", "n_kernels": 4, "kx": 3, "ky": 3,
     "padding": (1, 1), "weights_stddev": 0.1},
    {"type": "maxabs_pooling", "ksize": (2, 2)},
    {"type": "activation_log"},
    {"type": "conv_tanh", "n_kernels": 4, "kx": 3, "ky": 3,
     "weights_stddev": 0.1},
    {"type": "avg_pooling", "ksize": (2, 2), "stride": (1, 1)},
    {"type": "activation_tanh"},
    {"type": "stochastic_pooling", "ksize": (2, 2)},
    {"type": "activation_sigmoid"},
    {"type": "softmax", "output_sample_shape": 4, "weights_stddev": 0.05},
]


@pytest.fixture(autouse=True, scope="module")
def _two_threads():
    """2 intra-op threads for this file's small ops, so that the suite's
    workers do not oversubscribe the cores; restored after."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


@pytest.fixture(autouse=True)
def _restore_base_seeds():
    saved = jprng._base_seed, prng._base_seed
    yield
    jprng._base_seed, prng._base_seed = saved


def _x(shape, seed=0):
    return np.random.RandomState(seed).randn(*shape).astype(np.float32)


# -- activations --------------------------------------------------------------


@pytest.mark.parametrize("name", ACTS)
def test_activation_functions_match_jax(name):
    x = _x((3, 5, 4), 1) * 2.0
    err = _x((3, 5, 4), 2)
    y = fn.act_forward(name, torch.from_numpy(x))
    jy = ox.act_forward(name, jnp.asarray(x))
    np.testing.assert_allclose(y.numpy(), np.asarray(jy), rtol=ACT_RTOL,
                               atol=ACT_ATOL)
    # the backward on the JAX forward's y: near |y| = A the tanh's
    # derivative cancels, and 1 ulp of y would show as more there
    dx = fn.act_backward(name, torch.from_numpy(np.array(jy)),
                         torch.from_numpy(err), torch.from_numpy(x))
    jdx = ox.act_backward(name, jy, jnp.asarray(err), jnp.asarray(x))
    np.testing.assert_allclose(dx.numpy(), np.asarray(jdx), rtol=ACT_RTOL,
                               atol=ACT_ATOL)


def test_log_backward_needs_the_input():
    y = torch.zeros(3)
    with pytest.raises(ValueError, match="input"):
        fn.act_backward("log", y, y)


@pytest.mark.parametrize("kind", ["tanh", "relu", "strictrelu", "sigmoid",
                                  "log"])
def test_activation_layers_match_jax(kind):
    layer = LAYER_TYPES[f"activation_{kind}"]()
    assert isinstance(layer, activation.ActivationForward)
    assert layer.activation == kind
    x = _x((2, 4, 4, 3), 3)
    np.testing.assert_allclose(
        layer.fused_apply({}, torch.from_numpy(x)).numpy(),
        np.asarray(ox.act_forward(kind, jnp.asarray(x))), rtol=ACT_RTOL,
        atol=ACT_ATOL)


# -- InputNormalize ----------------------------------------------------------


@pytest.mark.parametrize("dtype", ["uint8", "float32", "bfloat16"])
def test_input_normalize_matches_the_jax_layer(dtype):
    """uint8 and f32 x compute in f32; a bf16 x (behind the fused step's
    bf16 entry cast) in bf16, its constants rounded first: the JAX
    layer's bits."""
    rs = np.random.RandomState(4)
    x = (rs.randint(0, 256, (3, 5, 5, 2)).astype(np.uint8)
         if dtype == "uint8" else rs.randn(3, 5, 5, 2).astype(np.float32))
    mean = rs.randn(5, 5, 2).astype(np.float32)
    ju = jnormalization.InputNormalize(None, scale=1 / 127.5, offset=-1.0)
    ju._mean = mean
    pu = normalization.InputNormalize(scale=1 / 127.5, offset=-1.0)
    pu.mean = mean
    jx, px = jnp.asarray(x), torch.from_numpy(x)
    if dtype == "bfloat16":
        jx, px = jx.astype(jnp.bfloat16), px.to(torch.bfloat16)
    want = np.asarray(ju._apply({}, jx).astype(jnp.float32))
    got = pu.fused_apply({}, px)
    assert got.dtype == (torch.bfloat16 if dtype == "bfloat16"
                         else torch.float32)
    np.testing.assert_allclose(got.float().numpy(), want, rtol=2e-7,
                               atol=1e-6)


def test_input_normalize_graph_negotiates_no_wire():
    loader = SyntheticClassifierLoader(n_classes=2, sample_shape=(4, 4, 1),
                                       n_validation=4, n_train=8,
                                       minibatch_size=4)
    wf = StandardWorkflow(
        layers=[{"type": "input_normalize"},
                {"type": "softmax", "output_sample_shape": 2}],
        loader=loader, n_classes=2)
    assert wf._wire_spec("auto") is None
    assert isinstance(wf.forwards[0], normalization.InputNormalize)
    assert isinstance(wf.gds[-1], normalization.GDInputNormalize)


# -- a stack of the slice's units, granular, both packages --------------------


def _stack(pkg, layers, confusion=False, epochs=1):
    kw = dict(n_classes=4, sample_shape=(10, 10, 1), n_validation=40,
              n_train=120, minibatch_size=40, noise=0.5)
    cfg = dict(loss="softmax", n_classes=4,
               decision_config={"max_epochs": epochs,
                                "fail_iterations": 50},
               gd_config={"learning_rate": 0.05, "gradient_moment": 0.9})
    if pkg == "jax":
        jprng._generators.clear()
        jprng.seed_all(1234)
        return JStandardWorkflow(layers=[dict(s) for s in layers],
                                 loader=JSynthetic(**kw), name="JStack",
                                 **cfg)
    prng._generators.clear()
    prng.seed_all(1234)
    return StandardWorkflow(
        layers=[dict(s) for s in layers],
        loader=SyntheticClassifierLoader(**kw), name="Stack",
        plot_config={"confusion": True} if confusion else None, **cfg)


def _jax_params(jwf):
    return [{k: np.asarray(a.mem) for k, a in u.param_arrays().items()}
            for u in jwf.forwards]


def test_stack_numpy_backend_is_bit_equal_to_jax():
    jwf = _stack("jax", STACK)
    jwf.initialize(device=NumpyDevice())
    jwf.run()
    pwf = _stack("torch", STACK)
    pwf.initialize(device="cpu", backend="numpy")
    pwf.run()
    assert pwf.decision.history == jwf.decision.history
    for i, (ju, pu) in enumerate(zip(_jax_params(jwf), pwf.params_host())):
        assert sorted(ju) == sorted(pu)
        for k in ju:
            np.testing.assert_array_equal(pu[k], ju[k], err_msg=f"{i} {k}")
    for jg, pg in zip(jwf.gds, pwf.gds):
        for k in pg._pnames:
            np.testing.assert_array_equal(
                pg.velocity(k).numpy(),
                np.asarray(getattr(jg, pg.vel_attr(k)).mem),
                err_msg=f"{pg.name} velocity {k}")
    np.testing.assert_array_equal(pwf.evaluator.confusion_matrix.mem,
                                  jwf.evaluator.confusion_matrix.mem)
    assert pwf.evaluator.confusion_matrix.mem.sum() == \
        3 * 40 + 40      # every minibatch of the epoch, as the JAX unit
    jwf._stop_units()


def test_stack_torch_backend_tracks_the_jax_xla_backend():
    layers = [s for s in STACK if s["type"] != "stochastic_pooling"]
    jwf = _stack("jax", layers)
    jwf.initialize(device=XLADevice())
    jwf.run()
    pwf = _stack("torch", layers)
    pwf.initialize(device="cpu", backend="torch")
    pwf.run()
    for i, (ju, pu) in enumerate(zip(_jax_params(jwf), pwf.params_host())):
        for k in ju:
            np.testing.assert_allclose(pu[k], ju[k], rtol=XB_RTOL,
                                       atol=XB_ATOL, err_msg=f"{i} {k}")
    assert pwf.decision.epoch_n_err[1] == pytest.approx(
        jwf.decision.epoch_metrics[1], abs=3)
    jwf._stop_units()


# -- the confusion matrix ----------------------------------------------------


def test_confusion_counts_equal_jax():
    rs = np.random.RandomState(5)
    probs = rs.dirichlet(np.ones(5), 30).astype(np.float32)
    labels = rs.randint(0, 5, 30)
    w = np.ones(30, np.float32)
    w[-4:] = 0.0
    *_, jconf = ox.softmax_ce(jnp.asarray(probs), jnp.asarray(labels), 5,
                              weights=jnp.asarray(w))
    *_, conf = fn.softmax_ce(torch.from_numpy(probs),
                             torch.from_numpy(labels), 5,
                             weights=torch.from_numpy(w))
    assert conf.dtype == torch.int64
    np.testing.assert_array_equal(conf.numpy(), np.asarray(jconf))
    assert int(conf.sum()) == 26
    np.testing.assert_array_equal(
        fn.confusion(torch.from_numpy(labels),
                     torch.from_numpy(probs.argmax(1)), 5).numpy(),
        np.asarray(ox.softmax_ce(jnp.asarray(probs), jnp.asarray(labels),
                                 5)[3]))


def test_fused_step_confusion_equals_the_jax_steps():
    layers = [{"type": "all2all_tanh", "output_sample_shape": 12,
               "weights_stddev": 0.1},
              {"type": "softmax", "output_sample_shape": 4,
               "weights_stddev": 0.1}]
    jwf, pwf = _stack("jax", layers), _stack("torch", layers)
    jwf.initialize(device=None)
    pwf.initialize("cpu")
    jstep, pstep = jwf.build_fused_step(), pwf.build_fused_step()
    jstate, pstate = jstep.init_state(), pstep.init_state()
    x = _x((40, 10, 10, 1), 6)
    y = np.random.RandomState(7).randint(0, 4, 40)
    w = np.ones(40, np.float32)
    w[-3:] = 0.0
    want = np.asarray(jstep.confusion(jstate, x, y, 4, w))
    got = pstep.confusion(pstate, x, y, 4, w)
    assert got.dtype == torch.int64 and int(got.sum()) == 37
    np.testing.assert_array_equal(got.numpy(), want.astype(np.int64))
    jwf._stop_units()


@pytest.mark.parametrize("mode", ["numpy", "torch", "fused"])
def test_confusion_of_each_validation_pass(mode):
    layers = [{"type": "all2all_tanh", "output_sample_shape": 12,
               "weights_stddev": 0.1},
              {"type": "softmax", "output_sample_shape": 4,
               "weights_stddev": 0.1}]
    wf = _stack("torch", layers, confusion=True, epochs=2)
    if mode == "fused":
        wf.run_fused(device="cpu")
    else:
        wf.initialize(device="cpu", backend=mode)
        wf.run()
    conf = wf.evaluator.confusion_matrix.mem
    assert conf.dtype == np.int64 and int(conf.sum()) == 40
    assert int(np.trace(conf)) == 40 - int(wf.decision.epoch_n_err[1])


# -- the MSE ------------------------------------------------------------------


def test_mse_matches_jax():
    y, t = _x((6, 3, 2), 8), _x((6, 3, 2), 9)
    w = np.array([1, 1, 0, 1, 1, 0], np.float32)
    for kw in ({}, {"weights": w}, {"weights": w, "denom": 3.0}):
        jl, je = ox.mse(jnp.asarray(y), jnp.asarray(t), **{
            k: (jnp.asarray(v) if k == "weights" else v)
            for k, v in kw.items()})
        pl, pe = fn.mse(torch.from_numpy(y), torch.from_numpy(t), **{
            k: (torch.from_numpy(v) if k == "weights" else torch.tensor(v))
            for k, v in kw.items()})
        np.testing.assert_allclose(float(pl), float(jl), rtol=1e-6)
        np.testing.assert_allclose(pe.numpy(), np.asarray(je), rtol=1e-6,
                                   atol=1e-8)


AE_LAYERS = [{"type": "all2all_tanh", "output_sample_shape": 16,
              "weights_stddev": 0.1},
             {"type": "all2all", "output_sample_shape": (6, 6),
              "weights_stddev": 0.1}]


def _ae(pkg, epochs):
    kw = dict(n_classes=4, sample_shape=(6, 6), n_validation=32,
              n_train=160, minibatch_size=32, noise=0.3, autoencoder=True)
    cfg = dict(loss="mse", decision_config={"max_epochs": epochs,
                                            "fail_iterations": 50},
               gd_config={"learning_rate": 0.02, "gradient_moment": 0.9})
    if pkg == "jax":
        jprng._generators.clear()
        jprng.seed_all(5)
        return JStandardWorkflow(layers=AE_LAYERS, loader=JSynthetic(**kw),
                                 name="FusedAE", **cfg)
    prng._generators.clear()
    prng.seed_all(5)
    return StandardWorkflow(layers=AE_LAYERS,
                            loader=SyntheticClassifierLoader(**kw),
                            name="FusedAE", **cfg)


def test_mse_loss_fused():
    """The JAX package's test_mse_loss_fused, local mode: identity target
    reconstruction error decreases."""
    wf = _ae("torch", 15)
    assert isinstance(wf.evaluator, EvaluatorMSE)
    wf.run_fused(device="cpu")
    assert wf.decision.best_validation_err < 5.0, wf.decision.epoch_n_err


def test_mse_run_fused_tracks_the_jax_package():
    jwf = _ae("jax", 2)
    jwf.run_fused()
    pwf = _ae("torch", 2)
    pwf.run_fused(device="cpu")
    assert len(pwf.decision.history) == len(jwf.decision.history) == 2
    for p, j in zip(pwf.decision.history, jwf.decision.history):
        for k in ("train_err", "valid_err"):
            np.testing.assert_allclose(p[k], j[k], rtol=1e-4)
    assert isinstance(pwf.evaluator.n_err, float)
    jwf._stop_units()


@pytest.mark.parametrize("backend", ["numpy", "torch"])
def test_granular_mse_evaluator_tracks_the_jax_run(backend):
    jwf = _ae("jax", 1)
    jwf.initialize(device=NumpyDevice() if backend == "numpy"
                   else XLADevice())
    jwf.run()
    pwf = _ae("torch", 1)
    pwf.initialize(device="cpu", backend=backend)
    pwf.run()
    rtol = 0.0 if backend == "numpy" else 1e-4
    for p, j in zip(pwf.decision.history, jwf.decision.history):
        for k in ("train_err", "valid_err"):
            np.testing.assert_allclose(p[k], j[k], rtol=rtol)
    jwf._stop_units()
