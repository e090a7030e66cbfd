"""The char-transformer's bf16 train step on the CPU, held against the
JAX package's bf16 step, at the toy geometry of
tests/test_torch_transformer.py (embed 16, 2 heads of 8, ffn 24, seq_len
256, minibatch 4, the flash gate on in both packages, the JAX Pallas
kernels in interpret mode; the port's attention goes through
`FlashAttentionFunction`'s f32 cast).

- Each unit's bf16 forward against the JAX unit's on the same bf16
  parameters and input.
- Three train steps, each from one common state (the JAX step's,
  converted), one with a padded row, and a validation batch: the step's
  logits, the loss, n_err, and the update of every leaf and velocity.
- The logit check catches two faults: the scaled tanh's constants taken
  at their f32 values (the port's tanh before it rounded them to bf16,
  as the JAX package's weakly typed Python floats are rounded) and the
  step left in f32 (x and the parameters uncast).

Where the two packages round. Both round every bf16 product, sum and
activation once to bf16, so most values are the same bits; the f32
values inside the flash cast differ in their last bits (the online
softmax against the materialised one), which moves a bf16 value by one
ulp where it lies near a rounding tie. XLA on the CPU departs from the
program in two places, and the checks follow it there:

- It keeps the head's last sum (the logits' bias add) in f32 before the
  step's cast to f32 (excess precision), so the JAX logits are rounded to
  bf16 before they are compared with the port's, which the program's
  bf16 head rounds.
- Its reduction of a bf16 array is less accurate than an f32 sum rounded
  once, the port's. A bias vector's gradient is such a sum over the
  N·S = 1024 tokens: the JAX bf16 step's bias updates lie 1.1e-2 to
  8.9e-2 (of their norm) from the JAX f32 step's from the same state,
  the port's bf16 ones 4.8e-4 to 2.2e-3 (measured by this file's
  `_steps`). The four bias vectors are therefore held against the JAX
  f32 step, and every other leaf against the JAX bf16 step.

Tolerances, with u = 2^-8 bf16's unit roundoff:
- logits and unit outputs: at most 2^-10 of the values differ, each by at
  most one bf16 ulp (measured: 0 or 1 logit of 18,432 a step; the tanh
  fault moves 9% to 13% of them, the f32 step all but one);
- loss within u (relative); n_err equal but for tokens whose two largest
  bf16 logits lie within one ulp of each other;
- the update distance ||Δport - Δref|| / ||Δref|| (Δ = after - before)
  over the leaves of each group, params and velocities, within 2u, the
  gate of the AlexNet bf16 step in tests/test_torch_bf16.py (measured:
  2.5e-4 to 7.7e-4 against the JAX bf16 step, 4.8e-4 to 2.2e-3 for the
  bias vectors against the JAX f32 step).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.test_torch_bf16 import _bf16_ulp, _copy
from tests.test_torch_transformer import TOY, _batch, _Selected, _workflows
from veles_tpu.ops import variants as jvariants
from veles_tpu_torch import convert
from veles_tpu_torch.ops import functional as fn
from veles_tpu_torch.ops import variants

BF16 = "bfloat16"
#: bf16's unit roundoff
U = 2.0 ** -8
UPDATE_RTOL = 2 * U
LOSS_RTOL = U
#: the share of logits (or unit outputs) that may differ by one bf16 ulp
DIFFER_SHARE = 2.0 ** -10
#: the leaves whose gradient is a sum over every token
BIAS = ("bias", "b2")
SEL_J = {"sgd_update": "pallas_rows[rt=8]"}
SEL_P = {"sgd_update": "kernel"}


def _as_bf16(a):
    """A jnp array (any float dtype) rounded to bf16, as f32 numpy."""
    return np.array(jnp.asarray(a).astype(jnp.bfloat16).astype(
        jnp.float32))


def _differing(got, want):
    """(the share of `got` (f32 numpy) that differs from `want` (bf16
    values, f32 numpy), the count that differs by more than one bf16
    ulp)."""
    assert got.shape == want.shape
    diff = got != want
    far = np.abs(got - want) > _bf16_ulp(want)
    return float(diff.mean()), int(far.sum())


def _near_ties(logits):
    """Tokens whose two largest bf16 logits lie within one bf16 ulp of
    each other: there the packages may take different argmaxes."""
    top = np.sort(logits.reshape(-1, logits.shape[-1]), axis=-1)[:, -2:]
    return int(np.sum(top[:, 1] - top[:, 0] <= _bf16_ulp(top[:, 1])))


def _distance(before, ref, port, slot, bias):
    """||Δport - Δref|| / ||Δref|| over the leaves of `slot` that are
    bias vectors (`bias`) or are not."""
    num = den = 0.0
    for b, r, p in zip(before[slot], ref[slot], port[slot]):
        for k in b:
            if (k in BIAS) != bias:
                continue
            dr = r[k].astype(np.float64) - b[k]
            dp = p[k].astype(np.float64) - b[k]
            num += float(np.sum((dp - dr) ** 2))
            den += float(np.sum(dr ** 2))
    return (num / den) ** 0.5


def _steps(port_dtype=BF16, steps=3):
    """The JAX bf16 step, the JAX f32 step and the port's step in
    `port_dtype` from one common state each step; yields per step a dict
    of the share of differing logits, the losses, n_errs and near ties,
    the update distances and the JAX bf16 step's bias distance from its
    f32 step, then the validation batch's losses, n_errs
    and near ties."""
    jwf, pwf = _workflows(TOY, use_flash="on")
    try:
        with jvariants.pallas_interpret(), _Selected(jvariants, **SEL_J), \
                _Selected(variants, **SEL_P):
            jstep = jwf.build_fused_step(compute_dtype=BF16)
            jf32 = jwf.build_fused_step(compute_dtype="float32")
            pstep = pwf.build_fused_step(compute_dtype=port_dtype)
            # the step's forward, its casts included (the JAX package has
            # no public one)
            jfwd = jax.jit(lambda p, x: jstep._forward(
                p, x, jax.random.PRNGKey(0), False, local_trace=True))
            jstate = jstep.init_state()
            for i in range(steps):
                pstate = convert.state_from_jax(jstate, "cpu", pstep)
                before = _copy(pstate)
                x, y, w = _batch(pwf, 20 + i, pad=1 if i == 1 else 0)
                plog = pstep.fwd._forward(pstate["params"],
                                          torch.from_numpy(x)).numpy()
                differing = _differing(plog,
                                       _as_bf16(jfwd(jstate["params"], x)))
                copy = jax.tree_util.tree_map(
                    lambda a: a.copy() if hasattr(a, "copy") else a, jstate)
                fstate, _ = jf32.train(copy, x, y, w)
                jstate, (jl, je) = jstep.train(jstate, x, y, w)
                pstate, (pl, pe) = pstep.train(pstate, x, y, w)
                for slot in ("params", "vel"):
                    assert {t.dtype for layer in pstate[slot]
                            for t in layer.values()} == {torch.float32}
                ja, fa, pa = _copy(jstate), _copy(fstate), _copy(pstate)
                yield {"step": i, "logits_differing": differing,
                       "loss": (float(pl), float(jl)),
                       "n_err": (int(pe), int(je)), "ties": _near_ties(plog),
                       "distance": {
                           slot: (_distance(before, ja, pa, slot, False),
                                  _distance(before, fa, pa, slot, True))
                           for slot in ("params", "vel")},
                       # the JAX bf16 step's own bias vectors against its
                       # f32 step's (not checked: the docstring's reason)
                       "jax_bias_distance": {
                           slot: _distance(before, fa, ja, slot, True)
                           for slot in ("params", "vel")}}
            pstate = convert.state_from_jax(jstate, "cpu", pstep)
            data, labels = pwf.loader.data, pwf.loader.labels
            xv, yv = data[:4], labels[:4].reshape(-1)
            wv = np.array([1, 1, 1, 0], np.float32)
            jl, je = jstep.evaluate(jstate, xv, yv, wv)
            pl, pe = pstep.evaluate(pstate, xv, yv, wv)
            plog = pstep.fwd._forward(pstate["params"],
                                      torch.from_numpy(xv)).numpy()
            yield {"step": "validation", "loss": (float(pl), float(jl)),
                   "n_err": (int(pe), int(je)), "ties": _near_ties(plog)}
    finally:
        jwf._stop_units()


@pytest.mark.parametrize("unit", range(4))
def test_bf16_transformer_units_give_the_jax_units_bits(unit):
    """Unit `unit`'s bf16 forward against the JAX unit's on the same bf16
    parameters and input (the JAX units' outputs before it, from a
    one-hot batch)."""
    jwf, pwf = _workflows(TOY, use_flash="on")
    try:
        x = jnp.asarray(_batch(pwf, 20)[0], jnp.bfloat16)
        with jvariants.pallas_interpret():
            for i, (ju, pu) in enumerate(zip(jwf.forwards, pwf.forwards)):
                jp = {k: jnp.asarray(np.asarray(a.mem), jnp.bfloat16)
                      for k, a in ju.param_arrays().items()}
                want = jax.jit(lambda p, x, u=ju: u.fused_apply(
                    p, x, train=True))(jp, x)
                if i == unit:
                    break
                x = want
            pp = {k: t.detach().to(torch.bfloat16)
                  for k, t in pu.param_arrays().items()}
            got = pu.fused_apply(pp, torch.from_numpy(_as_bf16(x)).to(
                torch.bfloat16), train=True)
        assert want.dtype == jnp.bfloat16 and got.dtype == torch.bfloat16
        share, far = _differing(got.float().numpy(), _as_bf16(want))
        assert share <= DIFFER_SHARE and far == 0, (type(pu).__name__,
                                                    share, far)
    finally:
        jwf._stop_units()


def test_bf16_transformer_steps_track_the_jax_bf16_step():
    for r in _steps():
        i = r["step"]
        np.testing.assert_allclose(*r["loss"], rtol=LOSS_RTOL,
                                   err_msg=str(i))
        pe, je = r["n_err"]
        assert abs(pe - je) <= r["ties"], (i, r["n_err"], r["ties"])
        if i == "validation":
            continue
        share, far = r["logits_differing"]
        assert share <= DIFFER_SHARE and far == 0, r
        for slot, (other, bias) in r["distance"].items():
            assert other <= UPDATE_RTOL, (i, slot, r["distance"])
            assert bias <= UPDATE_RTOL, (i, slot, r["distance"])


@pytest.mark.parametrize("fault", ["f32 tanh constants", "f32 step"])
def test_the_logit_check_catches_f32_tanh_constants_and_an_f32_step(
        monkeypatch, fault):
    """The logit check of the test above fails a step whose scaled tanh
    multiplies by the constants' f32 values and a step left in f32, at
    the first step."""
    if fault == "f32 tanh constants":
        act = fn.act_forward

        def f32_constants(name, x):
            if name == "tanh":
                return fn.TANH_A * torch.tanh(fn.TANH_B * x)
            return act(name, x)

        monkeypatch.setattr(fn, "act_forward", f32_constants)
    steps = _steps(BF16 if fault == "f32 tanh constants" else None, steps=1)
    r = next(steps)
    steps.close()
    assert r["logits_differing"][0] > 16 * DIFFER_SHARE, r
