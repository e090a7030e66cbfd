"""The training slice's kernel functions on the CPU, held against the JAX
package: K3 (`lrn_backward`), K5 (`lrn_maxpool_backward`) and K1
(`sgd_update`), with the autograd functions that pair K2/K3 and K4/K5.

They are CUDA kernels that run only on the card, where chip_smoke.py holds
each against its plain version. Here every wrapper takes its plain
version, and these tests hold the plain versions — through the wrappers,
the autograd functions and the registry variants the train step calls —
against the JAX package's Pallas kernels (interpret mode) and the numpy
goldens of `veles_tpu.ops.reference`.

Tolerances: rtol 1e-4, atol 1e-5 for the LRN gradients, the JAX package's
own Pallas-vs-golden tolerance (both compute in f32 with the same tap
order and pow decomposition; rsqrt and the summation differ in the last
bits); rtol 1e-6, atol 1e-7 for the SGD update, three f32 operations per
element in the same order on both sides. The float64 gradchecks use
torch's defaults.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import veles_tpu.ops.pallas_kernels as pk
from veles_tpu.ops import optim as joptim
from veles_tpu.ops import reference as ref
from veles_tpu_torch.ops import functional as fn
from veles_tpu_torch.ops import kernels, optim, variants

RTOL, ATOL = 1e-4, 1e-5
K, ALPHA, BETA, N = 2.0, 1e-4, 0.75, 5


@pytest.fixture(autouse=True)
def _interpret_mode():
    pk._FORCE_INTERPRET = True
    yield
    pk._FORCE_INTERPRET = False


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _close(got, want, rtol=RTOL, atol=ATOL):
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else got
    np.testing.assert_allclose(got, np.asarray(want), rtol=rtol, atol=atol)


@pytest.mark.parametrize("c,n,alpha,beta", [(16, 5, ALPHA, BETA),
                                            (3, 5, 0.05, BETA),
                                            (16, 3, 0.05, BETA),
                                            (16, 5, 0.05, 0.6)])
def test_lrn_backward_plain_matches_pallas_and_golden(c, n, alpha, beta):
    """AlexNet's constants, C below the window (every tap near a channel
    edge), a narrower window, and a beta that is no quarter power."""
    rs = np.random.RandomState(c + n)
    x = (3.0 * rs.randn(2, 3, 4, c)).astype(np.float32)
    g = rs.randn(2, 3, 4, c).astype(np.float32)
    want_pallas = pk.lrn_backward_pallas(x, g, K, alpha, beta, n)
    want_gold = ref.lrn_backward(x, g, K, alpha, beta, n)
    xt = _t(x).requires_grad_(True)
    y = variants.get("lrn", "kernel").apply(xt, k=K, alpha=alpha, beta=beta,
                                            n=n)
    (via_autograd,) = torch.autograd.grad(y, xt, _t(g))
    for got in (kernels.lrn_backward(_t(x), _t(g), K, alpha, beta, n),
                kernels.lrn_backward_plain(_t(x), _t(g), K, alpha, beta, n),
                via_autograd):
        _close(got, want_pallas)
        _close(got, want_gold)


@pytest.mark.parametrize("hw", [8, 9])
def test_lrn_maxpool_backward_plain_matches_jax_vjp_and_golden(hw):
    """Post-ReLU inputs (half zeros, so windows tie constantly: the
    gradient must go to each window's FIRST maximum), at 8x8 (a ceil-mode
    edge window) and 9x9 (exact)."""
    rs = np.random.RandomState(hw)
    x = np.maximum(rs.randn(2, hw, hw, 16), 0).astype(np.float32)
    oh, ow = fn.pool_out_hw(hw, hw, 3, 3, 2, 2)
    g = rs.randn(2, oh, ow, 16).astype(np.float32)
    _, vjp = jax.vjp(lambda a: pk.lrn_maxpool_pallas(
        a, K, ALPHA, BETA, N, (3, 3), (2, 2)), jnp.asarray(x))
    (want_vjp,) = vjp(jnp.asarray(g))
    want_gold = ref.lrn_maxpool_backward(x, g, K, ALPHA, BETA, N, (3, 3),
                                         (2, 2))
    xt = _t(x).requires_grad_(True)
    y = variants.get("lrn_maxpool", "fused").apply(
        xt, k=K, alpha=ALPHA, beta=BETA, n=N, ksize=(3, 3), stride=(2, 2))
    assert tuple(y.shape) == g.shape
    (via_autograd,) = torch.autograd.grad(y, xt, _t(g))
    for got in (kernels.lrn_maxpool_backward(_t(x), _t(g), K, ALPHA, BETA, N),
                kernels.lrn_maxpool_backward_plain(_t(x), _t(g), K, ALPHA,
                                                   BETA, N),
                via_autograd):
        _close(got, want_vjp)
        _close(got, want_gold)
    # the routing itself: where the LRN output is 0 (x == 0), only the
    # first tied tap of a window may take that window's gradient, exactly
    # as the golden's argmax routes it
    np.testing.assert_array_equal(via_autograd.numpy() == 0, want_gold == 0)


def test_lrn_maxpool_backward_nan_window_routes_nowhere():
    """A NaN makes its window's maximum NaN, which equals no tap: that
    window's gradient goes nowhere (the JAX kernel's rule; PyTorch's own
    max_pool2d would route it to the NaN)."""
    rs = np.random.RandomState(3)
    x = np.maximum(rs.randn(1, 9, 9, 8), 0).astype(np.float32)
    x[0, 2, 2, 3] = np.nan
    g = rs.randn(1, 4, 4, 8).astype(np.float32)
    _, vjp = jax.vjp(lambda a: pk.lrn_maxpool_pallas(
        a, K, ALPHA, BETA, N, (3, 3), (2, 2)), jnp.asarray(x))
    want = np.asarray(vjp(jnp.asarray(g))[0])
    got = kernels.lrn_maxpool_backward(_t(x), _t(g), K, ALPHA, BETA,
                                       N).numpy()
    assert np.isnan(want).any()
    np.testing.assert_array_equal(np.isnan(got), np.isnan(want))
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL,
                               equal_nan=True)


def test_closed_form_backwards_pass_gradcheck_in_float64():
    """The closed forms the CPU path runs are the derivatives of the plain
    forwards: torch.autograd.gradcheck (finite differences) on the
    autograd functions, and autograd of the plain forwards, agree with
    them in float64. Inputs without ties: a pooling window's maximum must
    not move under the finite-difference step."""
    rs = np.random.RandomState(5)
    x = _t(rs.randn(2, 5, 5, 7)).requires_grad_(True)
    g = _t(rs.randn(2, 5, 5, 7))
    lrn = lambda a: kernels.LRNFunction.apply(a, K, 0.05, BETA, N)  # noqa
    assert torch.autograd.gradcheck(lrn, (x,))
    (want,) = torch.autograd.grad(fn.lrn_forward(x, K, 0.05, BETA, N), x, g)
    (got,) = torch.autograd.grad(lrn(x), x, g)
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=1e-10,
                               atol=1e-12)

    x = _t(rs.randn(2, 8, 8, 7)).requires_grad_(True)
    g = _t(rs.randn(2, 4, 4, 7))
    pool = lambda a: kernels.LRNMaxPoolFunction.apply(  # noqa: E731
        a, K, 0.05, BETA, N, (3, 3), (2, 2))
    assert torch.autograd.gradcheck(pool, (x,))
    (want,) = torch.autograd.grad(
        fn.maxpool_forward(fn.lrn_forward(x, K, 0.05, BETA, N), (3, 3),
                           (2, 2)), x, g)
    (got,) = torch.autograd.grad(pool(x), x, g)
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=1e-10,
                               atol=1e-12)


def _sgd_case(seed=11):
    rs = np.random.RandomState(seed)
    params = {"weights": rs.randn(33, 17).astype(np.float32),
              "bias": rs.randn(5).astype(np.float32)}
    grads = {k: rs.randn(*v.shape).astype(np.float32)
             for k, v in params.items()}
    vel = {k: rs.randn(*v.shape).astype(np.float32)
           for k, v in params.items()}
    return params, grads, vel


@pytest.mark.parametrize("variant", ["kernel", "tree"])
def test_sgd_update_matches_pallas_and_golden(variant):
    """Both lowerings of the `sgd_update` op against K1's TPU kernel and
    the golden, leaf by leaf, the 1-D bias leaf at lr · lr_bias_mult 2."""
    params, grads, vel = _sgd_case()
    cfg = optim.SGDConfig(lr=0.05, momentum=0.9, weight_decay=1e-3,
                          lr_bias_mult=2.0)
    p = {k: _t(a.copy()) for k, a in params.items()}
    v = {k: _t(a.copy()) for k, a in vel.items()}
    variants.get("sgd_update", variant).apply(
        p, {k: _t(a) for k, a in grads.items()}, v, cfg, lr_scale=0.5)
    for k in params:
        lr = 0.05 * 0.5 * (2.0 if params[k].ndim == 1 else 1.0)
        assert optim.sgd_leaf_lr(cfg, params[k].ndim, 0.5) == lr
        pp, vp = pk.sgd_update_pallas(params[k], grads[k], vel[k], lr, 0.9,
                                      1e-3)
        pg, vg = ref.sgd_momentum_update(params[k], grads[k], vel[k], lr,
                                         0.9, 1e-3)
        for got, want in ((p[k], pp), (v[k], vp), (p[k], pg), (v[k], vg)):
            _close(got, want, rtol=1e-6, atol=1e-7)


def test_sgd_update_with_l1_decay_takes_the_tree_rule():
    """K1 has no L1 term: with `l1_decay` set the kernel variant runs the
    tree rule (the JAX `pallas_rows` template's rule), and both match the
    JAX tree update and the golden."""
    params, grads, vel = _sgd_case(12)
    cfg = optim.SGDConfig(lr=0.05, momentum=0.9, weight_decay=1e-3,
                          l1_decay=1e-2)
    jcfg = joptim.SGDConfig(*cfg)
    want_p, want_v = joptim.sgd_update(params, grads, vel, jcfg, 1.0)
    for variant in ("kernel", "tree"):
        p = {k: _t(a.copy()) for k, a in params.items()}
        v = {k: _t(a.copy()) for k, a in vel.items()}
        variants.get("sgd_update", variant).apply(
            p, {k: _t(a) for k, a in grads.items()}, v, cfg)
        for k in params:
            lr = 0.05 * (2.0 if params[k].ndim == 1 else 1.0)
            pg, vg = ref.sgd_momentum_update(params[k], grads[k], vel[k],
                                             lr, 0.9, 1e-3, 1e-2)
            _close(p[k], want_p[k], rtol=1e-6, atol=1e-7)
            _close(v[k], want_v[k], rtol=1e-6, atol=1e-7)
            _close(p[k], pg, rtol=1e-6, atol=1e-7)
            _close(v[k], vg, rtol=1e-6, atol=1e-7)


def test_wrappers_check_the_gradient_they_are_given():
    x = torch.zeros(1, 9, 9, 8)
    kernels.reset_launch_counts()
    # a permuted (non-contiguous) incoming gradient is taken as it is on
    # the CPU, and gives what its contiguous copy gives
    g = torch.randn(1, 8, 9, 9).permute(0, 2, 3, 1)
    np.testing.assert_array_equal(
        kernels.lrn_backward(x + 1, g).numpy(),
        kernels.lrn_backward(x + 1, g.contiguous()).numpy())
    assert kernels.launch_counts() == {name: 0
                                       for name in kernels.INSTANCES}
