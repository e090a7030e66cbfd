"""`FusedTrainStep.train_repeat` and `train_many` of the port on the CPU.

- Both give the same bits as the same steps taken one `train` call at a
  time from the same state and the same dropout-stream position: every
  leaf, velocity (or Adam moment and `t`), loss and n_err, on the toy
  AlexNet at dropout 0.5 (SGD with momentum, and Adam).
- Their metrics come back as tensors with a leading dimension of k, on
  the step's device, without a host sync.
- `train_many` tracks the JAX package's `train_many` on the JAX test's
  FC workflow (tests/test_parallel_fused.py::
  test_train_many_matches_sequential: K = 4 batches of 50): the losses
  rtol 1e-5, the leaves and velocities at the port's train-step
  tolerances, rtol 1e-4, atol 1e-7.
"""

import numpy as np
import pytest
import torch

from veles_tpu import prng as jprng
from veles_tpu_torch import prng
from veles_tpu_torch.ops import optim
from tests.test_torch_adam import compare_states, fc_workflows
from tests.test_torch_train_step import _workflows


@pytest.fixture(autouse=True)
def _restore_base_seeds():
    saved = jprng._base_seed, prng._base_seed
    yield
    jprng._base_seed, prng._base_seed = saved


def _leaves(state):
    """Every tensor of the state, in a fixed order."""
    out = []
    for layer in state["params"]:
        out += [t.detach() for t in layer.values()]
    for layer in state["vel"]:
        if optim.is_adam_state(layer):
            out += list(layer["m"].values()) + list(layer["v"].values())
            out.append(layer["t"])
        else:
            out += list(layer.values())
    return out


def _same_bits(a, b):
    la, lb = _leaves(a), _leaves(b)
    return len(la) == len(lb) and all(
        x.dtype == y.dtype and torch.equal(x, y) for x, y in zip(la, lb))


def _toy_step(optimizer):
    _, pwf = _workflows(0.5)
    for g in pwf.gds:
        g.optimizer = optimizer
        if optimizer == "adam":
            g.learning_rate = 1e-4
    return pwf.build_fused_step()


def _toy_batches(k, seed=9):
    rs = np.random.RandomState(seed)
    xs = rs.randn(k, 8, 67, 67, 3).astype(np.float32)
    ys = rs.randint(0, 16, (k, 8))
    ws = np.ones((k, 8), np.float32)
    ws[-1, -3:] = 0.0
    return xs, ys, ws


@pytest.mark.parametrize("optimizer", ["sgd", "adam"])
def test_train_repeat_gives_the_bits_of_a_train_loop(optimizer):
    step = _toy_step(optimizer)
    xs, ys, ws = _toy_batches(1)
    start = step.gen.get_state()
    s_loop = step.init_state()
    losses, errs = [], []
    for _ in range(4):
        s_loop, (loss, err) = step.train(s_loop, xs[0], ys[0], ws[0])
        losses.append(loss)
        errs.append(err)
    step.gen.set_state(start)
    s_rep, (rlosses, rerrs) = step.train_repeat(step.init_state(), xs[0],
                                                ys[0], 4, ws[0])
    assert rlosses.shape == (4,) and rerrs.shape == (4,)
    assert rlosses.device == step.device
    assert torch.equal(rlosses, torch.stack(losses))
    assert torch.equal(rerrs, torch.stack(errs))
    assert _same_bits(s_rep, s_loop)
    assert len(set(rlosses.tolist())) == 4      # four real updates
    if optimizer == "adam":
        assert {int(v["t"]) for v, p in zip(s_rep["vel"], s_rep["params"])
                if p} == {4}


@pytest.mark.parametrize("optimizer", ["sgd", "adam"])
def test_train_many_gives_the_bits_of_a_train_loop(optimizer):
    step = _toy_step(optimizer)
    xs, ys, ws = _toy_batches(3)
    start = step.gen.get_state()
    s_loop = step.init_state()
    losses, errs = [], []
    for x, y, w in zip(xs, ys, ws):
        s_loop, (loss, err) = step.train(s_loop, x, y, w)
        losses.append(loss)
        errs.append(err)
    step.gen.set_state(start)
    s_many, (mlosses, merrs) = step.train_many(step.init_state(), xs, ys, ws)
    assert mlosses.shape == (3,) and merrs.shape == (3,)
    assert torch.equal(mlosses, torch.stack(losses))
    assert torch.equal(merrs, torch.stack(errs))
    assert _same_bits(s_many, s_loop)
    # ws=None is all ones
    step.gen.set_state(start)
    s_a, (la, _) = step.train_many(step.init_state(), xs[:1], ys[:1])
    step.gen.set_state(start)
    s_b, (lb, _) = step.train(step.init_state(), xs[0], ys[0],
                              np.ones(8, np.float32))
    assert float(la[0]) == float(lb) and _same_bits(s_a, s_b)


def test_train_many_tracks_the_jax_train_many():
    jwf, pwf = fc_workflows(seed=1234, minibatch_size=50, gd_config={
        "learning_rate": 0.1, "gradient_moment": 0.9})
    jwf.initialize(device=None)
    pwf.initialize("cpu")
    jstep, pstep = jwf.build_fused_step(), pwf.build_fused_step()
    rng = np.random.RandomState(0)
    xs = rng.randn(4, 50, 8, 8).astype(np.float32)
    ys = rng.randint(0, 10, (4, 50))
    js, (jlosses, jerrs) = jstep.train_many(jstep.init_state(), xs, ys)
    ps, (plosses, perrs) = pstep.train_many(pstep.init_state(), xs, ys)
    np.testing.assert_allclose(plosses.numpy(), np.asarray(jlosses),
                               rtol=1e-5)
    np.testing.assert_array_equal(perrs.numpy(), np.asarray(jerrs))
    compare_states(js, ps, "train_many")
    jwf._stop_units()
