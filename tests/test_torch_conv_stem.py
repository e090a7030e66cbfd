"""The `conv_stem` op on the CPU: the space-to-depth rewrite of a strided
convolution and the `Conv` layer's `s2d` knob, against the JAX package.

- `functional.conv2d_forward(s2d=False/True)` against JAX
  `ops.xla.conv2d_forward(s2d=False/True)` at the four geometries of
  tests/test_ops_equivalence.py (AlexNet's 227x227x3 stem at 11x11/4
  among them), and the two port lowerings against each other: the
  forward within rtol 1e-5, atol 1e-5 (the JAX test's tolerance: the
  rewrite sums the same products in another order), and both gradients
  (input and weights) within rtol 1e-5, atol 1e-5 of the gradient's
  largest magnitude (the weight gradient sums N·OH·OW products, 6050 at
  the AlexNet stem, in another order in each package).
- The registry: `conv_stem` has `direct` and `s2d`, each the functional
  lowering above.
- `Conv(s2d=...)`: the JAX unit's errors (an unknown value; "on" without
  a square stride > 1); "auto" asks `resolve("conv_stem")` only where
  `_s2d_applicable` (square stride > 1, cin < 8), and a selection of
  `s2d` reaches the layer's forward in the fused step and the granular
  node.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from veles_tpu.ops import xla as ox
from veles_tpu.znicz import conv as jconv
from veles_tpu_torch.ops import functional as fn
from veles_tpu_torch.ops import variants
from veles_tpu_torch.znicz import conv

RTOL, ATOL = 1e-5, 1e-5
#: tests/test_ops_equivalence.py:test_conv_space_to_depth_exact
CASES = [
    ((2, 227, 227, 3), (11, 11, 3, 8), 4, (0, 0)),   # AlexNet stem
    ((2, 32, 32, 3), (7, 7, 3, 4), 2, (0, 0)),
    ((1, 29, 29, 2), (5, 5, 2, 6), 3, (2, 2)),       # with padding
    ((2, 16, 16, 4), (4, 4, 4, 8), 4, (0, 0)),       # kernel == stride
]


def _atol(name, want):
    """ATOL for the forward, ATOL of the largest magnitude for a
    gradient."""
    return ATOL if name == "y" else ATOL * float(np.abs(want).max())


def _inputs(xshape, wshape):
    rng = np.random.RandomState(0)
    x = rng.randn(*xshape).astype(np.float32)
    w = rng.randn(*wshape).astype(np.float32) * 0.1
    b = rng.randn(wshape[-1]).astype(np.float32)
    return x, w, b


def _jax(x, w, b, s, pad, s2d, g):
    def f(xx, ww):
        y = ox.conv2d_forward(xx, ww, jnp.asarray(b), stride=(s, s),
                              padding=pad, activation="tanh", s2d=s2d)
        return jnp.sum(y * g), y
    (_, y), (dx, dw) = jax.value_and_grad(f, argnums=(0, 1),
                                          has_aux=True)(
        jnp.asarray(x), jnp.asarray(w))
    return [np.asarray(a) for a in (y, dx, dw)]


def _port(x, w, b, s, pad, s2d, g):
    xt = torch.from_numpy(x).requires_grad_(True)
    wt = torch.from_numpy(w).requires_grad_(True)
    y = fn.conv2d_forward(xt, wt, torch.from_numpy(b), (s, s), pad,
                          "tanh", s2d=s2d)
    dx, dw = torch.autograd.grad((y * torch.from_numpy(g)).sum(), [xt, wt])
    return [a.detach().numpy() for a in (y, dx, dw)]


@pytest.mark.parametrize("xshape, wshape, s, pad", CASES)
@pytest.mark.parametrize("s2d", [False, True])
def test_lowering_and_its_gradients_match_the_jax_function(xshape, wshape,
                                                           s, pad, s2d):
    x, w, b = _inputs(xshape, wshape)
    oh = (xshape[1] + 2 * pad[0] - wshape[0]) // s + 1
    ow = (xshape[2] + 2 * pad[1] - wshape[1]) // s + 1
    g = np.random.RandomState(1).randn(
        xshape[0], oh, ow, wshape[-1]).astype(np.float32)
    want = _jax(x, w, b, s, pad, s2d, g)
    got = _port(x, w, b, s, pad, s2d, g)
    for name, a, e in zip(("y", "dx", "dw"), got, want):
        assert a.shape == e.shape, (name, a.shape, e.shape)
        np.testing.assert_allclose(a, e, rtol=RTOL, atol=_atol(name, e),
                                   err_msg=f"{name} {xshape} s2d={s2d}")


@pytest.mark.parametrize("xshape, wshape, s, pad", CASES)
def test_s2d_equals_direct(xshape, wshape, s, pad):
    x, w, b = _inputs(xshape, wshape)
    oh = (xshape[1] + 2 * pad[0] - wshape[0]) // s + 1
    ow = (xshape[2] + 2 * pad[1] - wshape[1]) // s + 1
    g = np.random.RandomState(2).randn(
        xshape[0], oh, ow, wshape[-1]).astype(np.float32)
    direct = _port(x, w, b, s, pad, False, g)
    s2d = _port(x, w, b, s, pad, True, g)
    for name, a, e in zip(("y", "dx", "dw"), s2d, direct):
        np.testing.assert_allclose(a, e, rtol=RTOL, atol=_atol(name, e),
                                   err_msg=f"{name} {xshape}")


def test_registry_holds_both_lowerings():
    spec = variants._OPS["conv_stem"]
    assert set(spec.variants) == {"direct", "s2d"}
    x, w, b = _inputs(*CASES[1][:2])
    xt, wt, bt = (torch.from_numpy(a) for a in (x, w, b))
    for name, s2d in (("direct", False), ("s2d", True)):
        got = variants.get("conv_stem", name).apply(
            xt, wt, bt, (2, 2), (0, 0), "strictrelu")
        want = fn.conv2d_forward(xt, wt, bt, (2, 2), (0, 0), "strictrelu",
                                 s2d=s2d)
        assert torch.equal(got, want), name


@pytest.mark.parametrize("kw", [dict(s2d="maybe"),
                                dict(s2d="on", stride=(1, 1)),
                                dict(s2d="on", stride=(2, 3))])
def test_knob_refuses_what_the_jax_unit_refuses(kw):
    with pytest.raises(ValueError) as jerr:
        jconv.Conv(None, **kw)
    with pytest.raises(ValueError) as perr:
        conv.Conv(**kw)
    assert str(perr.value) == str(jerr.value)


@pytest.mark.parametrize("cin, stride, s2d, asks", [
    (3, (4, 4), "auto", True), (7, (2, 2), "auto", True),
    (8, (4, 4), "auto", False), (3, (1, 1), "auto", False),
    (3, (2, 4), "auto", False), (3, (4, 4), "on", False),
    (3, (4, 4), "off", False)])
def test_auto_asks_the_registry_only_for_thin_strided_stems(
        monkeypatch, cin, stride, s2d, asks):
    calls = []
    inner = variants.resolve

    def resolve(op, unit=None):
        calls.append(op)
        return inner(op, unit)

    monkeypatch.setattr(variants, "resolve", resolve)
    layer = conv.Conv(n_kernels=4, kx=3, ky=3, stride=stride, s2d=s2d)
    assert layer._s2d_applicable(cin) == (
        stride[0] == stride[1] and stride[0] > 1 and cin < 8)
    layer._use_s2d(cin)
    assert calls == (["conv_stem"] if asks else [])


@pytest.fixture
def stem_selection():
    prev = variants.selected("conv_stem")
    yield
    if prev is None:
        variants.clear_selection("conv_stem")
    else:
        variants.select("conv_stem", prev)


def test_selection_reaches_the_fused_and_the_granular_forward(
        monkeypatch, stem_selection):
    from veles_tpu_torch import workflow as pworkflow
    from veles_tpu_torch.backends import TorchDevice
    from veles_tpu_torch.znicz.nn_units import unit_for
    seen = []
    inner = fn.conv2d_forward

    def spy(*a, **kw):
        seen.append(kw.get("s2d", False))
        return inner(*a, **kw)

    monkeypatch.setattr(fn, "conv2d_forward", spy)
    x, _, _ = _inputs((2, 32, 32, 3), (1,))
    layer = conv.ConvStrictRELU(n_kernels=4, kx=7, ky=7, stride=(2, 2))
    node = unit_for(type(layer))(pworkflow.Workflow(name="p"), layer=layer)
    node.input.reset(x)
    node.input_sample_shape = x.shape[1:]
    node.initialize(device=TorchDevice("cpu"))
    outs = {}
    for name in ("direct", "s2d"):
        variants.select("conv_stem", name)
        seen.clear()
        y = layer.fused_apply(layer.param_arrays(), torch.from_numpy(x),
                              train=True)
        node.run()
        assert seen == [name == "s2d"] * 2
        np.testing.assert_allclose(node.output.mem, y.detach().numpy(),
                                   rtol=0, atol=0)
        outs[name] = y.detach().numpy()
    np.testing.assert_allclose(outs["s2d"], outs["direct"], rtol=RTOL,
                               atol=ATOL)
