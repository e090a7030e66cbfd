"""The pooling flavors of the port — max-abs, average and stochastic —
held against the JAX package's functions (ops/xla.py) and the goldens
(ops/reference.py), inputs from numpy seeds.

- Max-abs: values and flat winner offsets equal the JAX
  `maxpool_forward_with_idx(use_abs=True)`'s and the golden's, exactly,
  on ragged ceil-mode geometries; its gradient (the gather) equals
  `jax.grad` of the JAX fused lowering's (rtol 1e-6 where overlapping
  windows add at one winner in another order); a max-abs pool never
  joins an LRN pair.
- Average: forward and backward against the JAX forward and its
  `jax.vjp` within rtol 1e-6, atol 1e-7 (the sums run in other orders)
  and against the goldens.
- Stochastic: given the JAX function's own `jax.random.gumbel` draw, the
  port's values and offsets equal the JAX function's bit for bit; drawn
  from a torch generator, each output is one of its window's positive
  elements, dead windows give 0 and the sentinel offset x.size, and the
  scatter drops the sentinel as the golden does.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from veles_tpu.ops import reference as jref
from veles_tpu.ops import variants as jvariants
from veles_tpu.ops import xla as ox
from veles_tpu_torch.ops import functional as fn
from veles_tpu_torch.ops import reference as ref
from veles_tpu_torch.znicz import normalization, pooling
from veles_tpu_torch.znicz.standard_workflow import LAYER_TYPES

#: (x shape, ksize, stride): ceil-mode windows clipped on one or both
#: axes, overlapping windows, an input smaller than the window
GEOMETRIES = [((2, 7, 9, 4), (3, 3), (2, 2)),
              ((1, 8, 8, 3), (2, 2), (2, 2)),
              ((2, 5, 6, 2), (3, 2), (1, 2)),
              ((1, 2, 2, 5), (3, 3), (2, 2))]
AVG_RTOL, AVG_ATOL = 1e-6, 1e-7


@pytest.fixture(autouse=True, scope="module")
def _two_threads():
    """2 intra-op threads for this file's small ops, so that the suite's
    workers do not oversubscribe the cores; restored after."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _x(shape, seed=0):
    return np.random.RandomState(seed).randn(*shape).astype(np.float32)


@pytest.mark.parametrize("shape,ksize,stride", GEOMETRIES)
def test_maxabs_values_and_offsets_equal_jax(shape, ksize, stride):
    x = _x(shape, 1)
    x[0, 0, 0, 0] = -9.0          # a negative winner keeps its sign
    jy, jidx = ox.maxpool_forward_with_idx(jnp.asarray(x), ksize, stride,
                                           use_abs=True)
    y, idx = fn.maxpool_forward_with_idx(torch.from_numpy(x), ksize,
                                         stride, use_abs=True)
    gy, gidx = ref.maxpool_forward(x, ksize, stride, use_abs=True)
    np.testing.assert_array_equal(y.numpy(), np.asarray(jy))
    np.testing.assert_array_equal(idx.numpy(), np.asarray(jidx))
    np.testing.assert_array_equal(y.numpy(), gy)
    np.testing.assert_array_equal(idx.numpy(), gidx)
    assert (y.numpy() == -9.0).any()


def test_maxabs_ties_keep_the_first_in_window_order():
    """|x| ties (an all-zero window, +a beside -a) go to the first element
    in row-major window order, as jnp.argmax picks it."""
    x = np.zeros((1, 4, 4, 1), np.float32)
    x[0, 0, 1, 0], x[0, 1, 0, 0] = -2.0, 2.0      # window (0, 0)
    jy, jidx = ox.maxpool_forward_with_idx(jnp.asarray(x), (2, 2), (2, 2),
                                           use_abs=True)
    y, idx = fn.maxpool_forward_with_idx(torch.from_numpy(x), (2, 2),
                                         (2, 2), use_abs=True)
    np.testing.assert_array_equal(y.numpy(), np.asarray(jy))
    np.testing.assert_array_equal(idx.numpy(), np.asarray(jidx))
    assert float(y[0, 0, 0, 0]) == -2.0 and int(idx[0, 0, 0, 0]) == 1


@pytest.mark.parametrize("shape,ksize,stride", GEOMETRIES[:3])
def test_maxabs_gradient_equals_jax(shape, ksize, stride):
    """The fused step's max-abs gradient (autograd through the gather)
    against `jax.grad` of the JAX fused lowering (the same gather)."""
    x = _x(shape, 2)
    g = _x(ox.maxpool_forward_with_idx(jnp.asarray(x), ksize, stride,
                                       use_abs=True)[0].shape, 3)
    v = jvariants.resolve("maxpool")
    jgrad = jax.grad(lambda a: (v.apply(a, ksize, stride, True)
                                * g).sum())(jnp.asarray(x))
    xt = torch.from_numpy(x).requires_grad_(True)
    layer = pooling.MaxAbsPooling(ksize=ksize, stride=stride)
    (layer.fused_apply({}, xt, train=True) * torch.from_numpy(g)).sum() \
        .backward()
    # overlapping windows that share a winner add their gradients there,
    # in another order than XLA's scatter: rtol 1e-6
    np.testing.assert_allclose(xt.grad.numpy(), np.asarray(jgrad),
                               rtol=1e-6, atol=1e-7)


def test_maxabs_pooling_never_joins_an_lrn_pair():
    from veles_tpu_torch.parallel.fused import FusedForward
    lrn = normalization.LRNormalizerForward()
    assert FusedForward._pair_fusion(None, lrn, pooling.MaxAbsPooling()) \
        is None


@pytest.mark.parametrize("shape,ksize,stride", GEOMETRIES)
def test_avgpool_forward_and_backward_match_jax(shape, ksize, stride):
    x = _x(shape, 4)
    jy, vjp = jax.vjp(lambda a: ox.avgpool_forward(a, ksize, stride),
                      jnp.asarray(x))
    g = _x(jy.shape, 5)
    (jdx,) = vjp(jnp.asarray(g))
    y = fn.avgpool_forward(torch.from_numpy(x), ksize, stride)
    dx = fn.avgpool_backward(torch.from_numpy(g), shape, ksize, stride)
    np.testing.assert_allclose(y.numpy(), np.asarray(jy), rtol=AVG_RTOL,
                               atol=AVG_ATOL)
    np.testing.assert_allclose(dx.numpy(), np.asarray(jdx), rtol=AVG_RTOL,
                               atol=AVG_ATOL)
    np.testing.assert_allclose(y.numpy(), ref.avgpool_forward(x, ksize,
                                                              stride),
                               rtol=AVG_RTOL, atol=AVG_ATOL)
    np.testing.assert_allclose(
        dx.numpy(), ref.avgpool_backward(g, shape, ksize, stride),
        rtol=AVG_RTOL, atol=AVG_ATOL)
    # the fused step's gradient: autograd of the forward is the backward
    xt = torch.from_numpy(x).requires_grad_(True)
    (fn.avgpool_forward(xt, ksize, stride) * torch.from_numpy(g)).sum() \
        .backward()
    np.testing.assert_allclose(xt.grad.numpy(), dx.numpy(), rtol=AVG_RTOL,
                               atol=AVG_ATOL)


@pytest.mark.parametrize("shape,ksize,stride", GEOMETRIES)
@pytest.mark.parametrize("seed", [0, 1])
def test_stochastic_pooling_is_bit_equal_given_the_jax_draw(shape, ksize,
                                                            stride, seed):
    x = _x(shape, 6 + seed)
    x[0, :3, :3, 0] = -1.0        # a dead window (nothing positive)
    key = jax.random.key(seed)
    jy, jidx = ox.stochastic_pool_forward_with_idx(jnp.asarray(x), key,
                                                   ksize, stride)
    oh, ow = fn.pool_out_hw(shape[1], shape[2], *ksize, *stride)
    noise = jax.random.gumbel(key, (shape[0], oh, ow, shape[3],
                                    ksize[0] * ksize[1]), jnp.float32)
    y, idx = fn.stochastic_pool_forward_with_idx(
        torch.from_numpy(x), ksize, stride,
        noise=torch.from_numpy(np.array(noise)))
    np.testing.assert_array_equal(y.numpy(), np.asarray(jy))
    np.testing.assert_array_equal(idx.numpy(), np.asarray(jidx))
    assert int(idx[0, 0, 0, 0]) == x.size and float(y[0, 0, 0, 0]) == 0.0


def test_stochastic_pooling_properties():
    """Drawn from a torch generator: each output is one of its window's
    positive elements at its recorded offset; the JAX package's
    geometry."""
    x = np.abs(_x((2, 4, 4, 3), 8))
    gen = torch.Generator().manual_seed(0)
    y, idx = fn.stochastic_pool_forward_with_idx(torch.from_numpy(x), (2, 2),
                                                 (2, 2), generator=gen)
    y, idx = y.numpy(), idx.numpy()
    assert y.shape == (2, 2, 2, 3)
    np.testing.assert_array_equal(x.reshape(-1)[idx], y)
    for n in range(2):
        for i in range(2):
            for j in range(2):
                for c in range(3):
                    win = x[n, 2 * i:2 * i + 2, 2 * j:2 * j + 2, c]
                    assert y[n, i, j, c] in win
    x7 = _x((2, 7, 9, 4), 9)
    y7, _ = fn.stochastic_pool_forward_with_idx(
        torch.from_numpy(x7), (3, 3), (2, 2), generator=gen)
    assert tuple(y7.shape) == tuple(
        ox.maxpool_forward(jnp.asarray(x7), (3, 3), (2, 2)).shape)


def test_stochastic_samples_follow_the_positive_parts():
    """Over many draws a window picks each element in proportion to its
    positive part (the golden sampler's distribution)."""
    x = np.array([1.0, 3.0, 0.0, -2.0], np.float32).reshape(1, 2, 2, 1)
    xt = torch.from_numpy(np.repeat(x, 4000, axis=0))
    gen = torch.Generator().manual_seed(1)
    _, idx = fn.stochastic_pool_forward_with_idx(xt, (2, 2), (2, 2),
                                                 generator=gen)
    freq = np.bincount((idx.numpy().ravel() % 4), minlength=4) / 4000
    np.testing.assert_allclose(freq, [0.25, 0.75, 0.0, 0.0], atol=0.03)


def test_scatter_drops_the_sentinel_as_the_golden_does():
    x = _x((2, 5, 5, 2), 10)
    x[1] = -1.0                   # sample 1's windows are all dead
    gen = torch.Generator().manual_seed(2)
    y, idx = fn.stochastic_pool_forward_with_idx(torch.from_numpy(x), (2, 2),
                                                 (2, 2), generator=gen)
    assert (idx.numpy()[1] == x.size).all()
    g = _x(tuple(y.shape), 11)
    got = fn.pool_scatter(torch.from_numpy(g), idx, x.shape)
    want = ref.stochastic_pool_backward(g, idx.numpy(), x.shape)
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(
        got.numpy(), np.asarray(ox.pool_scatter(jnp.asarray(g),
                                                jnp.asarray(idx.numpy()),
                                                x.shape)))


def test_the_goldens_are_the_jax_packages():
    """The port's copies of the pooling goldens give the JAX package's
    values and offsets (the stochastic one from equal numpy streams)."""
    x = _x((2, 7, 9, 4), 12)
    for use_abs in (False, True):
        for a, b in zip(ref.maxpool_forward(x, (3, 3), (2, 2), use_abs),
                        jref.maxpool_forward(x, (3, 3), (2, 2), use_abs)):
            np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(ref.avgpool_forward(x, (3, 3), (2, 2)),
                                  jref.avgpool_forward(x, (3, 3), (2, 2)))
    for a, b in zip(
            ref.stochastic_pool_forward(x, np.random.RandomState(3), (3, 3),
                                        (2, 2)),
            jref.stochastic_pool_forward(x, np.random.RandomState(3),
                                         (3, 3), (2, 2))):
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("name,cls", [
    ("max_pooling", pooling.MaxPooling),
    ("maxabs_pooling", pooling.MaxAbsPooling),
    ("avg_pooling", pooling.AvgPooling),
    ("stochastic_pooling", pooling.StochasticPooling)])
def test_layer_types_registered(name, cls):
    assert LAYER_TYPES[name] is cls


def test_stochastic_pooling_averages_at_evaluation():
    x = torch.from_numpy(_x((2, 6, 6, 3), 13))
    layer = pooling.StochasticPooling(ksize=(2, 2))
    np.testing.assert_array_equal(
        layer.fused_apply({}, x, train=False).numpy(),
        fn.avgpool_forward(x, (2, 2), (2, 2)).numpy())
    with pytest.raises(ValueError, match="Generator"):
        layer.fused_apply({}, x, train=True)
