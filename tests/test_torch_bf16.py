"""bf16 compute over f32 master weights on the CPU, held against the JAX
package run with the same `compute_dtype`.

- The plain versions of K2-K5 on bf16 tensors against the JAX Pallas
  kernels in interpret mode on the same bf16 arrays (io_dtype="native":
  bf16 blocks, f32 math, one rounding on the store) and their VJPs. Both
  promote to f32, compute, and round once, so the bits are equal wherever
  the two packages' f32 values are; where those differ in their last bit
  (XLA's f32 rsqrt on the CPU is neither correctly rounded nor 1/sqrt,
  torch's is 1/sqrt), the rounded values may differ by one bf16 ulp and
  by no more. The same bf16 LRN computed in bf16, op by op (the port's
  plain LRN before it promoted), breaks the first rule.
- The precision rule (the twin of tests/test_parallel_fused.py's
  `test_precision_type_config_sets_fused_dtype`): root.common.precision_type
  "bfloat16" gives a bf16 step whose master weights stay f32, and an
  explicit argument wins; the CLI's override trains in bf16; the server
  still refuses it.
- The bf16 train step against the JAX bf16 step at the toy geometry of
  tests/test_torch_train_step.py, under both `lrn_maxpool` settings, with
  `JAX_SEL` and the port's kernels: two steps, each from one common state
  (the JAX step's, converted), and a validation batch.
- `FlashAttentionFunction` on bf16 q, k, v against
  `flash_attention_pallas` on the same bf16 arrays, forward and
  gradients.

The train step's tolerance. Both steps round at the same places: every
bf16 product and convolution accumulates in f32 and rounds once, the
bias is added to the rounded product, the LRN rounds once, the logits are
cast to f32 for the loss, the update is f32. So most values are the same
bits, and what differs starts from a last f32 bit (XLA's rsqrt, the JAX
stem's space-to-depth summation order) that moves a bf16 value by one
ulp near a rounding tie. In bf16 two taps of a pooling window tie, and a
ReLU input is exactly 0, far more often than in f32: both packages route
a tie of equal values to the first maximum and give a ReLU tie half the
gradient (jnp.maximum's rule), so equal values take equal paths, but a
one-ulp difference at a near tie sends a window's gradient to a
neighbouring tap. The comparison is therefore of each step's whole
update, not element by element: the distance between the two steps'
updates p' - p over all leaves (and likewise their velocities), relative
to the JAX update's norm, must stay within 2u = 2^-7, twice bf16's unit
roundoff u = 2^-8 (measured by this file's `_bf16_steps`: 3.1e-3 to
4.7e-3), from a common state each step, so that no difference
compounds. The loss agrees within u (relative), n_err exactly. The gate
catches the two faults it is meant to: the same steps with the LRN
computed in bf16 (the plain LRN before this slice) land at 3.7e-2 to
7.8e-2, and the steps left in f32 (x and parameters uncast) at 4.2e-2 to
1.1e-1 (`test_the_update_gate_catches_a_bf16_lrn_and_an_f32_step`
checks the first step of each).

The flash cast's tolerance: both sides compute in f32 (the online
softmax against the materialised one, rtol 2e-4 there) and round the
output and each gradient once to bf16, so each value is within one bf16
ulp (2^-7 relative at most) of the other, plus the f32 tolerances for
values near zero.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import veles_tpu.ops.pallas_kernels as pk
from tests.test_torch_train_step import JAX_SEL, _batch, _Selected, _workflows
from veles_tpu.ops import variants as jvariants
from veles_tpu_torch import convert, launcher, prng
from veles_tpu_torch.config import root
from veles_tpu_torch.ops import functional as fn
from veles_tpu_torch.ops import kernels, variants
from veles_tpu_torch.samples import alexnet

K, ALPHA, BETA, N = 2.0, 1e-4, 0.75, 5
BF16 = "bfloat16"
#: bf16's unit roundoff
U = 2.0 ** -8
UPDATE_RTOL = 2 * U
LOSS_RTOL = U
#: the flash cast: one bf16 ulp relative, the f32 gradients' atol
#: (test_torch_flash_kernels.py) near zero
FLASH_RTOL, FLASH_ATOL = 2 * U, 5e-5


@pytest.fixture(autouse=True, scope="module")
def _own_autotune_cache(tmp_path_factory):
    """A plain `--fused` run applies the autotune cache's winners: this
    module's runs read a cache of their own, not one under HOME."""
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("VELES_AUTOTUNE_CACHE",
                  str(tmp_path_factory.mktemp("autotune") / "autotune.json"))
        yield


@pytest.fixture(autouse=True)
def _interpret_mode():
    pk._FORCE_INTERPRET = True
    yield
    pk._FORCE_INTERPRET = False


@pytest.fixture
def precision_type():
    """root.common.precision_type, restored after the test."""
    prev = root.common.precision_type
    yield
    root.common.precision_type = prev


@pytest.fixture
def cli_state():
    """What a CLI run in this process sets for the process (root.alexnet,
    root.common, the seed), restored after the test."""
    saved = root.alexnet.to_dict(), root.common.to_dict(), prng._base_seed
    yield
    root.alexnet.update(saved[0])
    root.common.update(saved[1])
    prng._base_seed = saved[2]


# ---------------------------------------------------------------------------
# the plain K2-K5 at bf16 against the JAX kernels
# ---------------------------------------------------------------------------


def _bf16_inputs(seed, shape, pooled, scale):
    """Post-ReLU x and a gradient g for the LRN (`pooled`: for the
    LRN->pool), as bf16 numpy-seeded arrays: (x, g) in jnp and in torch,
    and the same values in f32 for the f32 references."""
    rs = np.random.RandomState(seed)
    x = np.maximum(rs.randn(*shape) * scale, 0).astype(np.float32)
    gshape = shape
    if pooled:
        oh, ow = fn.pool_out_hw(shape[1], shape[2], 3, 3, 2, 2)
        gshape = (shape[0], oh, ow, shape[3])
    g = rs.randn(*gshape).astype(np.float32)
    xj, gj = jnp.asarray(x, jnp.bfloat16), jnp.asarray(g, jnp.bfloat16)
    x32 = np.array(xj.astype(jnp.float32))
    g32 = np.array(gj.astype(jnp.float32))
    return (xj, gj), (torch.from_numpy(x32).to(torch.bfloat16),
                      torch.from_numpy(g32).to(torch.bfloat16)), (x32, g32)


def _bf16_ulp(a):
    """One bf16 ulp at each |a| (2^(e-8) for |a| in [2^(e-1), 2^e))."""
    _, e = np.frexp(np.abs(a))
    return np.ldexp(1.0, e - 8)


def _assert_rounds_like_jax(got16, want16, got32, want32, what):
    """`got16` (torch bf16) has `want16`'s (jnp bf16) bits wherever the
    f32 values the two round (`got32`, `want32`) are the same bits, and
    is within one bf16 ulp of it elsewhere. Returns the count of elements
    whose f32 values differ."""
    g = got16.float().numpy()
    w = np.asarray(want16.astype(jnp.float32))
    g32, w32 = np.asarray(got32), np.asarray(want32)
    assert g.shape == w.shape, what
    assert np.array_equal(np.isnan(g), np.isnan(w)), what
    same = (g32 == w32) | (np.isnan(g32) & np.isnan(w32))
    ok = ~np.isnan(w)
    np.testing.assert_array_equal(g[same & ok], w[same & ok],
                                  err_msg=f"{what}: bits where f32 agrees")
    other = ~same & ok
    assert np.all(np.abs(g - w)[other] <= _bf16_ulp(w)[other]), what
    return int(other.sum())


def _jax_and_port(op, xs):
    """(JAX bf16, port bf16, JAX f32, port f32) results of `op`, one of
    K2-K5's functions, on one bf16 input set."""
    (xj, gj), (xt, gt), (x32, g32) = xs
    if op == "lrn_forward":
        return (pk.lrn_forward_pallas(xj, K, ALPHA, BETA, N),
                kernels.lrn_forward(xt, K, ALPHA, BETA, N),
                pk.lrn_forward_pallas(x32, K, ALPHA, BETA, N),
                kernels.lrn_forward(torch.from_numpy(x32), K, ALPHA, BETA, N))
    if op == "lrn_backward":
        return (pk.lrn_backward_pallas(xj, gj, K, ALPHA, BETA, N),
                kernels.lrn_backward(xt, gt, K, ALPHA, BETA, N),
                pk.lrn_backward_pallas(x32, g32, K, ALPHA, BETA, N),
                kernels.lrn_backward(torch.from_numpy(x32),
                                     torch.from_numpy(g32), K, ALPHA, BETA,
                                     N))

    def pool(x):
        return pk.lrn_maxpool_pallas(x, K, ALPHA, BETA, N, (3, 3), (2, 2))

    if op == "lrn_maxpool_forward":
        return (pool(xj),
                kernels.lrn_maxpool_forward(xt, K, ALPHA, BETA, N),
                pool(jnp.asarray(x32)),
                kernels.lrn_maxpool_forward(torch.from_numpy(x32), K, ALPHA,
                                            BETA, N))
    return (jax.vjp(pool, xj)[1](gj)[0],
            kernels.lrn_maxpool_backward(xt, gt, K, ALPHA, BETA, N),
            jax.vjp(pool, jnp.asarray(x32))[1](jnp.asarray(g32))[0],
            kernels.lrn_maxpool_backward(torch.from_numpy(x32),
                                         torch.from_numpy(g32), K, ALPHA,
                                         BETA, N))


LRN_OPS = ("lrn_forward", "lrn_backward", "lrn_maxpool_forward",
           "lrn_maxpool_backward")
#: (x shape, scale of x): unit-scale activations, and small ones (the
#: toy AlexNet's, where s stays near k and many products lie near a bf16
#: rounding tie)
LRN_INPUTS = (((2, 9, 11, 40), 1.0), ((2, 7, 9, 12), 0.05))


@pytest.mark.parametrize("op", LRN_OPS)
@pytest.mark.parametrize("shape,scale", LRN_INPUTS,
                         ids=[f"scale {s}" for _, s in LRN_INPUTS])
def test_plain_lrn_at_bf16_rounds_like_the_jax_kernels(op, shape, scale):
    """The plain K2-K5 on bf16 x (and g) give the JAX kernels' bits
    wherever both packages' f32 values agree, one bf16 ulp at most
    elsewhere; each result is bf16, K5's routed on the f32 LRN values."""
    xs = _bf16_inputs(5, shape, op.startswith("lrn_maxpool"), scale)
    j16, p16, j32, p32 = _jax_and_port(op, xs)
    assert p16.dtype == torch.bfloat16 and j16.dtype == jnp.bfloat16
    # f32 differs in 10-55% of the elements; the bits must agree in the rest
    differ = _assert_rounds_like_jax(p16, j16, p32.numpy(), j32, op)
    assert differ < p16.numel(), op


def _lrn_computed_in_bf16(monkeypatch):
    """The plain LRN as it was before this slice: no promotion, so a bf16
    x is computed op by op in bf16."""
    monkeypatch.setattr(fn, "_f32", lambda t: t)


@pytest.mark.parametrize("op", LRN_OPS)
def test_an_lrn_computed_in_bf16_is_not_the_jax_kernels(monkeypatch, op):
    """The fault this slice repairs: computed in bf16 (each operation
    rounding), the LRN misses the JAX kernels' bits where the f32 values
    agree."""
    xs = _bf16_inputs(5, (2, 9, 11, 40), op.startswith("lrn_maxpool"), 1.0)
    _lrn_computed_in_bf16(monkeypatch)
    j16, p16, j32, p32 = _jax_and_port(op, xs)
    with pytest.raises(AssertionError):
        _assert_rounds_like_jax(p16, j16, p32.numpy(), j32, op)


# ---------------------------------------------------------------------------
# the precision rule
# ---------------------------------------------------------------------------

TOY = dict(minibatch_size=8, width_mult=0.125, fc_width=64, n_train=8,
           n_validation=4, n_classes=16, input_hw=67, init="scaled")


def test_precision_type_config_sets_fused_dtype(precision_type):
    """root.common.precision_type governs the fused step's default compute
    dtype; an explicit compute_dtype argument still wins; the master
    weights and velocities stay f32."""
    root.common.precision_type = BF16
    wf = alexnet.create_workflow(**TOY)
    wf.initialize("cpu")
    step = wf.build_fused_step()
    assert step.compute_dtype == BF16
    state = step.init_state()
    x, y, w = _batch(130)
    state, (loss, _) = step.train(state, x, y, w)
    assert loss.dtype == torch.float32 and np.isfinite(float(loss))
    for slot in ("params", "vel"):
        assert {t.dtype for layer in state[slot]
                for t in layer.values()} == {torch.float32}
    assert wf.build_fused_step(
        compute_dtype="float32").compute_dtype == "float32"
    root.common.precision_type = "float32"
    assert wf.build_fused_step().compute_dtype is None
    assert wf.build_fused_step(compute_dtype=BF16).compute_dtype == BF16
    with pytest.raises(ValueError, match="float16"):
        wf.build_fused_step(compute_dtype="float16")


def test_the_cli_override_trains_in_bf16_and_serving_refuses_it(
        cli_state, monkeypatch):
    """`root.common.precision_type=bfloat16` on the `--fused` CLI trains
    through a bf16 step. The server no longer refuses such a workflow
    (it did until the serving slice ported the JAX rule): it serves it
    as the JAX ring does, its forward computing in the workflow's bf16
    over the f32 parameters (the f32 wire). The name is kept from the
    slices where serving refused it, so that the test keeps its
    identity."""
    from veles_tpu_torch.serving import InferenceServer
    from veles_tpu_torch.znicz.standard_workflow import StandardWorkflow
    built = []
    real = StandardWorkflow.build_fused_step

    def spy(self, compute_dtype=None, **kwargs):
        built.append(real(self, compute_dtype, **kwargs))
        return built[-1]

    monkeypatch.setattr(StandardWorkflow, "build_fused_step", spy)
    toy = ["root.alexnet.loader.input_hw=67", "root.alexnet.width_mult=0.125",
           "root.alexnet.fc_width=64", "root.alexnet.n_classes=16",
           "root.alexnet.loader.minibatch_size=8",
           "root.alexnet.loader.n_train=16",
           "root.alexnet.loader.n_validation=8"]
    wf = launcher.train([alexnet.__file__, "--fused", "--device", "cpu",
                         "-r", "7", "root.common.precision_type=bfloat16",
                         "root.alexnet.decision.max_epochs=1", *toy])
    assert wf.loader.sample_shape == (67, 67, 3)
    assert [s.compute_dtype for s in built] == [BF16]
    assert np.isfinite(wf.evaluator.loss)
    for u in wf.forwards:
        assert all(t.dtype == torch.float32
                   for t in u.param_arrays().values())
    srv = InferenceServer(wf, port=0, device="cpu")
    assert srv._fwd.compute_dtype == BF16 and srv.quantize == "f32"
    x = np.random.RandomState(2).randn(2, 67, 67, 3).astype(np.float32)
    out = np.asarray(srv.predict(x)["outputs"])
    assert out.shape == (2, 16) and np.isfinite(out).all()
    fwd = wf.build_forward()        # the f32 wire's forward, as served
    assert fwd.compute_dtype == BF16
    ring = np.zeros((srv.ring_slots, 67, 67, 3), np.float32)
    ring[:2] = x
    with torch.inference_mode():
        want = torch.softmax(fwd._forward(fwd.params(), torch.from_numpy(
            ring)), dim=-1)[:2].numpy()
    np.testing.assert_array_equal(out, want)


# ---------------------------------------------------------------------------
# the bf16 train step against the JAX bf16 step
# ---------------------------------------------------------------------------


def _copy(state):
    """Host copies of a state's params and velocities (either
    package's)."""
    return {slot: [{k: np.array(v.detach() if isinstance(v, torch.Tensor)
                                else v) for k, v in layer.items()}
                   for layer in state[slot]] for slot in ("params", "vel")}


def _distance(jb, ja, pa, slot):
    """The port's step against the JAX step from the common state `jb`:
    ||Δport - Δjax|| / ||Δjax|| over every leaf of `slot` (Δ = after -
    before)."""
    num = den = 0.0
    for b, a, p in zip(jb[slot], ja[slot], pa[slot]):
        for k in b:
            dj = a[k].astype(np.float64) - b[k]
            dp = p[k].astype(np.float64) - b[k]
            num += float(np.sum((dp - dj) ** 2))
            den += float(np.sum(dj ** 2))
    return (num / den) ** 0.5


def _bf16_steps(setting, port_dtype=BF16, steps=2):
    """The JAX bf16 step and the port's step in `port_dtype` from one
    common state each step; yields (step, distances, losses, n_err) and,
    last, the validation batch's (losses, n_err)."""
    jwf, pwf = _workflows(0.0)
    try:
        with jvariants.pallas_interpret(), \
                _Selected(jvariants, **JAX_SEL[setting]), \
                _Selected(variants, lrn_maxpool=setting, sgd_update="kernel"):
            jstep = jwf.build_fused_step(compute_dtype=BF16)
            pstep = pwf.build_fused_step(compute_dtype=port_dtype)
            jstate = jstep.init_state()
            for i in range(steps):
                pstate = convert.state_from_jax(jstate, "cpu", pstep)
                before = _copy(pstate)
                x, y, w = _batch(130 + i, pad=3 if i == 1 else 0)
                jstate, (jl, je) = jstep.train(jstate, x, y, w)
                pstate, (pl, pe) = pstep.train(pstate, x, y, w)
                for slot in ("params", "vel"):
                    assert {t.dtype for layer in pstate[slot]
                            for t in layer.values()} == {torch.float32}
                ja, pa = _copy(jstate), _copy(pstate)
                yield i, {slot: _distance(before, ja, pa, slot)
                          for slot in ("params", "vel")}, \
                    (float(pl), float(jl)), (int(pe), int(je))
            pstate = convert.state_from_jax(jstate, "cpu", pstep)
            xv, yv, wv = _batch(200, pad=2)
            jl, je = jstep.evaluate(jstate, xv, yv, wv)
            pl, pe = pstep.evaluate(pstate, xv, yv, wv)
            yield "validation", None, (float(pl), float(jl)), (int(pe),
                                                               int(je))
    finally:
        jwf._stop_units()


@pytest.mark.parametrize("setting", ["composed", "fused"])
def test_bf16_steps_track_the_jax_bf16_step(setting):
    for i, dist, (pl, jl), (pe, je) in _bf16_steps(setting):
        np.testing.assert_allclose(pl, jl, rtol=LOSS_RTOL, err_msg=str(i))
        assert pe == je, i
        if dist is not None:
            assert dist["params"] <= UPDATE_RTOL, (i, dist)
            assert dist["vel"] <= UPDATE_RTOL, (i, dist)


@pytest.mark.parametrize("fault", ["bf16 LRN", "f32 step"])
def test_the_update_gate_catches_a_bf16_lrn_and_an_f32_step(monkeypatch,
                                                           fault):
    """The gate of the test above fails a step whose LRN is computed in
    bf16 (the plain LRN before this slice) and a step left in f32 (x and
    the parameters uncast), at the first step."""
    if fault == "bf16 LRN":
        _lrn_computed_in_bf16(monkeypatch)
    steps = _bf16_steps("composed", BF16 if fault == "bf16 LRN" else None,
                        steps=1)
    _, dist, _, _ = next(steps)
    steps.close()
    assert dist["params"] > 2 * UPDATE_RTOL, dist


# ---------------------------------------------------------------------------
# the f32 cast around K6 / K7
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("causal", [False, True])
def test_flash_function_on_bf16_casts_as_the_jax_wrapper(causal):
    """FlashAttentionFunction on bf16 q, k, v against
    `flash_attention_pallas` on the same bf16 arrays (both cast to f32
    around the kernels): O and each gradient bf16, within one bf16 ulp."""
    b, s, h, d, blk = 2, 64, 2, 8, 16
    rs = np.random.RandomState(9)
    arrs = [jnp.asarray(rs.randn(b, s, h, d), jnp.bfloat16)
            for _ in range(4)]
    q, k, v, w = arrs

    def attn(q, k, v):
        return pk.flash_attention_pallas(q, k, v, causal=causal, blk_q=blk,
                                         blk_k=blk)

    want, vjp = jax.vjp(attn, q, k, v)
    want_grads = vjp(w)
    ts = [torch.from_numpy(np.array(a.astype(jnp.float32))).to(
        torch.bfloat16).requires_grad_(i < 3) for i, a in enumerate(arrs)]
    kernels.reset_launch_counts()
    out = kernels.FlashAttentionFunction.apply(ts[0], ts[1], ts[2], causal,
                                               None, "fwd", None)
    out.backward(ts[3])
    assert kernels.launch_counts() == {n: 0 for n in kernels.INSTANCES}
    assert want.dtype == jnp.bfloat16 and out.dtype == torch.bfloat16
    for name, got, ref in zip("oqkv", [out] + [t.grad for t in ts[:3]],
                              [want, *want_grads]):
        assert got.dtype == torch.bfloat16, name
        np.testing.assert_allclose(got.detach().float().numpy(),
                                   np.asarray(ref.astype(jnp.float32)),
                                   rtol=FLASH_RTOL, atol=FLASH_ATOL,
                                   err_msg=name)
