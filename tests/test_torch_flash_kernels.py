"""The attention slice's kernel functions on the CPU, held against the JAX
package: K6 (`flash_attention_forward`), K7 (`flash_attention_backward`),
the autograd function that pairs them, and the port's einsum golden.

K6 and K7 are CUDA kernels that run only on the card, where chip_smoke.py
holds each against its plain version. Here every wrapper takes its plain
version, and these tests hold the plain versions — through the wrappers,
`FlashAttentionFunction` and the `flash_attn` registry variants — against
the JAX package's Pallas kernels in interpret mode (`_flash_fwd_core`,
`_flash_bwd_pallas`, `flash_attention_pallas` at blk_q = blk_k = 16, so
that a 64-long sequence spans 4×4 tiles and the causal tile skip runs),
against `jax.grad` of its `mha_forward`, and against the numpy golden
`veles_tpu.ops.reference.mha_forward`. S = 72 covers a ragged last tile
(the plain versions and the port's kernels take any S; the JAX kernel
needs whole blocks, so there the golden alone is the reference).

Tolerances: forward rtol 2e-4, atol 2e-5; gradients rtol 5e-4, atol 5e-5
— the JAX package's own kernel-vs-golden tolerances
(tests/test_pallas_kernels.py): the online softmax sums in another order
than the materialised one.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import veles_tpu.ops.pallas_kernels as pk
from veles_tpu.ops import attention as joa
from veles_tpu.ops import reference as ref
from veles_tpu_torch.ops import attention, kernels, variants

FWD_RTOL, FWD_ATOL = 2e-4, 2e-5
BWD_RTOL, BWD_ATOL = 5e-4, 5e-5
B, S, H, D = 2, 64, 2, 8
BLK = 16


@pytest.fixture(autouse=True)
def _interpret_mode():
    pk._FORCE_INTERPRET = True
    yield
    pk._FORCE_INTERPRET = False


def _qkv(seed, s=S, n=3):
    rs = np.random.RandomState(seed)
    return [rs.randn(B, s, H, D).astype(np.float32) for _ in range(n)]


def _heads_first(x):
    return np.ascontiguousarray(x.transpose(0, 2, 1, 3).reshape(B * H, -1, D))


def _t(a, grad=False):
    return torch.tensor(np.asarray(a), requires_grad=grad)


def _flash(q, k, v, causal=False, mask=None):
    """`flash_attention_pallas`'s counterpart: K6/K7 through the autograd
    function, (B, S, H, D) in and out."""
    return kernels.FlashAttentionFunction.apply(q, k, v, causal, None, "fwd",
                                                mask)


def _host(a):
    return a.detach().numpy() if isinstance(a, torch.Tensor) else \
        np.asarray(a)


def _close(got, want, rtol, atol, what=""):
    np.testing.assert_allclose(_host(got), _host(want), rtol=rtol,
                               atol=atol, err_msg=what)


@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("kv_order", ["fwd", "rev"])
def test_plain_forward_matches_pallas(causal, kv_order):
    q, k, v = (_heads_first(a) for a in _qkv(1))
    scale = 1.0 / np.sqrt(D)
    want_o, want_lse = pk._flash_fwd_core(q, k, v, scale, causal, BLK, BLK,
                                          kv_order)
    for fn in (kernels.flash_attention_forward,
               kernels.flash_attention_forward_plain):
        o, lse = fn(_t(q), _t(k), _t(v), causal, None, kv_order)
        assert tuple(lse.shape) == (B * H, S, 1)
        _close(o, want_o, FWD_RTOL, FWD_ATOL, "O")
        _close(lse, want_lse, FWD_RTOL, FWD_ATOL, "lse")


@pytest.mark.parametrize("causal", [False, True])
def test_drop_mask_matches_the_fused_pallas_pair_and_golden(causal):
    q, k, v = _qkv(2)
    mask = ((np.random.RandomState(3).rand(B, S, H, D) < 0.75) / 0.75
            ).astype(np.float32)
    want = np.asarray(pk.flash_attention_pallas(
        q, k, v, causal=causal, blk_q=BLK, blk_k=BLK, drop_mask=mask))
    got = _flash(_t(q), _t(k), _t(v), causal=causal,
                                  mask=_t(mask))
    _close(got, want, FWD_RTOL, FWD_ATOL)
    _close(got, ref.attn_dropout_forward(q, k, v, mask, causal=causal),
           FWD_RTOL, FWD_ATOL)
    # the heads-first wrapper takes the heads-first mask
    o, _ = kernels.flash_attention_forward(
        *(_t(_heads_first(a)) for a in (q, k, v)), causal,
        mask=_t(_heads_first(mask)))
    _close(o, _heads_first(want), FWD_RTOL, FWD_ATOL)


@pytest.mark.parametrize("causal", [False, True])
def test_plain_backward_matches_pallas(causal):
    q, k, v = (_heads_first(a) for a in _qkv(4))
    do = np.random.RandomState(5).randn(B * H, S, D).astype(np.float32)
    scale = 1.0 / np.sqrt(D)
    out, lse = pk._flash_fwd_core(q, k, v, scale, causal, BLK, BLK)
    di = np.asarray(jnp.sum(do * out, axis=-1, keepdims=True))
    want = pk._flash_bwd_pallas(q, k, v, do, lse, di, scale, causal, BLK,
                                BLK)
    args = [_t(a) for a in (q, k, v, do, lse, di)]
    for fn in (kernels.flash_attention_backward,
               kernels.flash_attention_backward_plain):
        got = fn(*args, causal)
        for name, a, b in zip(("dq", "dk", "dv"), got, want):
            _close(a, b, BWD_RTOL, BWD_ATOL, name)


def _jax_grads(q, k, v, w, causal, mask=None):
    def loss(q, k, v):
        o = joa.mha_forward(q, k, v, causal=causal)
        if mask is not None:
            o = o * mask
        return jnp.sum(o * w)
    return jax.grad(loss, argnums=(0, 1, 2))(q, k, v)


def _port_grads(fn, q, k, v, w):
    ts = [_t(a, grad=True) for a in (q, k, v)]
    out = fn(*ts)
    (out * _t(w)).sum().backward()
    return out, [t.grad for t in ts]


@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("s", [S, 72])
def test_function_matches_jax_grad_of_the_golden(causal, s):
    """FlashAttentionFunction on the CPU (the plain K6 forward, the plain
    K7 backward) against jax.grad of the JAX package's einsum golden; at
    S = 72 the last 16-row tile of a blocked kernel would be ragged."""
    q, k, v, w = _qkv(6, s=s, n=4)
    out, got = _port_grads(
        lambda *a: _flash(*a, causal=causal), q, k, v, w)
    _close(out, ref.mha_forward(q, k, v, causal=causal), FWD_RTOL, FWD_ATOL)
    for name, a, b in zip("qkv", got, _jax_grads(q, k, v, w, causal)):
        _close(a, b, BWD_RTOL, BWD_ATOL, name)


@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("masked", [False, True])
def test_function_matches_autograd_of_the_port_golden(causal, masked):
    q, k, v, w = _qkv(7, n=4)
    mask = (((np.random.RandomState(8).rand(B, S, H, D) < 0.5) / 0.5)
            .astype(np.float32) if masked else None)
    m = None if mask is None else _t(mask)

    def golden(*a):
        o = attention.mha_forward(*a, causal=causal)
        return o if m is None else o * m

    out, got = _port_grads(
        lambda *a: _flash(*a, causal=causal, mask=m),
        q, k, v, w)
    want_out, want = _port_grads(golden, q, k, v, w)
    _close(out, want_out, FWD_RTOL, FWD_ATOL)
    for name, a, b in zip("qkv", got, want):
        _close(a, b, BWD_RTOL, BWD_ATOL, name)
    if masked:
        for name, a, b in zip("qkv", got,
                              _jax_grads(q, k, v, w, causal, mask)):
            _close(a, b, BWD_RTOL, BWD_ATOL, name)


def test_function_backward_is_the_plain_k7_not_autograd(monkeypatch):
    """On the CPU the backward runs the closed form through the K7
    wrapper, with D = rowsum(dO*O) taken beside it, never autograd of
    the plain forward."""
    calls = []
    inner = kernels.flash_attention_backward

    def spy(*args):
        calls.append(args)
        return inner(*args)

    monkeypatch.setattr(kernels, "flash_attention_backward", spy)
    q, k, v, w = _qkv(9, n=4)
    _, grads = _port_grads(
        lambda *a: _flash(*a, causal=True), q, k, v, w)
    assert len(calls) == 1 and all(g is not None for g in grads)
    qf, kf, vf, do, lse, di, causal, scale = calls[0]
    assert causal is True and scale is None
    assert tuple(do.shape) == (B * H, S, D) and tuple(di.shape) == (B * H,
                                                                    S, 1)
    assert not lse.requires_grad and not do.requires_grad


@pytest.mark.parametrize("causal", [False, True])
def test_port_mha_matches_the_jax_mha_and_golden(causal):
    q, k, v = _qkv(10)
    want = np.asarray(joa.mha_forward(q, k, v, causal=causal))
    for got in (attention.mha_forward(_t(q), _t(k), _t(v), causal=causal),
                variants.get("flash_attn", "mha").apply(
                    _t(q), _t(k), _t(v), causal=causal),
                variants.get("flash_attn", "kernel").apply(
                    _t(q), _t(k), _t(v), causal=causal)):
        _close(got, want, FWD_RTOL, FWD_ATOL)
        _close(got, ref.mha_forward(q, k, v, causal=causal), FWD_RTOL,
               FWD_ATOL)
    assert attention.NEG_INF == joa.NEG_INF
    assert variants.resolve("flash_attn").name == "kernel"


def test_plain_versions_chunk_the_rows(monkeypatch):
    """The plain versions hold a few heads' (S, S) scores at a time: the
    result does not depend on the chunking."""
    q, k, v, g = (_heads_first(a) for a in _qkv(11, n=4))
    args = [_t(a) for a in (q, k, v)]
    whole = kernels.flash_attention_forward_plain(*args, True)
    di = (_t(g) * whole[0]).sum(-1, keepdim=True)
    whole_b = kernels.flash_attention_backward_plain(*args, _t(g), whole[1],
                                                     di, True)
    monkeypatch.setattr(kernels, "_PLAIN_CHUNK_ELEMENTS", S * S)
    assert len(kernels._plain_chunks(B * H, S)) == B * H
    parts = kernels.flash_attention_forward_plain(*args, True)
    parts_b = kernels.flash_attention_backward_plain(*args, _t(g), whole[1],
                                                     di, True)
    for a, b in zip(parts + parts_b, whole + whole_b):
        np.testing.assert_array_equal(a.numpy(), b.numpy())


def test_wrappers_check_their_arguments():
    x = torch.zeros(2, 8, 8)
    with pytest.raises(ValueError, match="kv_order"):
        kernels.flash_attention_forward(x, x, x, kv_order="backward")
    meta = torch.zeros(2, 8, 8, device="meta")
    with pytest.raises(ValueError, match="cuda or cpu"):
        kernels.flash_attention_forward(meta, meta, meta)
    with pytest.raises(ValueError, match="cuda or cpu"):
        kernels.flash_attention_backward(meta, meta, meta, meta, meta, meta)
    before = kernels.launch_counts()
    kernels.flash_attention_forward(x, x, x)
    assert kernels.launch_counts() == before    # the CPU path never counts


# -- K7's 3xTF32 arithmetic ---------------------------------------------------
#
# K7 runs all five of its products on the tensor cores as 3xTF32. These
# tests hold that arithmetic, emulated in numpy, against the plain
# version under chip_smoke.py's K7 gate; they do not run the kernel (a
# CUDA kernel runs only on the card, where chip_smoke.py holds it).

#: chip_smoke.py's FLASH_BWD_RTOL / FLASH_BWD_ATOL: K7 against its plain
#: version on the card
K7_RTOL, K7_ATOL = 1e-4, 1e-5
TF32_S, TF32_BH = 256, 2


def _tf32(x):
    """`cvt.rna.tf32.f32`: round an f32 to 10 explicit mantissa bits, to
    nearest, ties away from zero (the bits below stay zero)."""
    bits = np.asarray(x, np.float32).view(np.uint32).astype(np.uint64)
    return ((bits + 0x1000) & 0xFFFFE000).astype(np.uint32).view(np.float32)


def _tf32_truncated(x):
    """What the tensor cores read of an f32 operand: its top 19 bits."""
    bits = np.asarray(x, np.float32).view(np.uint32)
    return (bits & np.uint32(0xFFFFE000)).view(np.float32)


def _tf32_product(a, b, passes):
    """a @ b (batched) as K7's tensor cores take it, in f32: one TF32
    product (passes=1), or three (a_lo·b_hi + a_hi·b_lo, then + a_hi·b_hi,
    x_hi = tf32(x) and x_lo = x − x_hi, truncated to TF32)."""
    a_hi, b_hi = _tf32(a), _tf32(b)
    if passes == 1:
        return np.matmul(a_hi, b_hi)
    a_lo, b_lo = _tf32_truncated(a - a_hi), _tf32_truncated(b - b_hi)
    return np.matmul(a_lo, b_hi) + np.matmul(a_hi, b_lo) + np.matmul(a_hi,
                                                                     b_hi)


def _tf32_backward(q, k, v, do, lse, di, causal, passes):
    """K7's arithmetic on heads-first f32 arrays: every product through
    `_tf32_product` (P and dS split too), p = exp2(s·scale·log2e −
    lse·log2e), p = 0 by index above the diagonal."""
    d = q.shape[-1]
    scale = np.float32(1.0 / np.sqrt(d))
    log2e = np.float32(np.log2(np.e))
    s = _tf32_product(q, k.transpose(0, 2, 1), passes)
    p = np.exp2(s * (scale * log2e) - lse * log2e).astype(np.float32)
    if causal:
        p = np.where(np.tri(q.shape[1], dtype=bool), p, np.float32(0))
    dp = _tf32_product(do, v.transpose(0, 2, 1), passes)
    ds = p * (dp - di) * scale
    return (_tf32_product(ds, k, passes),
            _tf32_product(ds.transpose(0, 2, 1), q, passes),
            _tf32_product(p.transpose(0, 2, 1), do, passes))


def _k7_case(d, causal, seed=12):
    """Inputs and the plain version's (dQ, dK, dV) at S = 256, B·H = 2."""
    rs = np.random.RandomState(seed)
    q, k, v, g = (rs.randn(TF32_BH, TF32_S, d).astype(np.float32)
                  for _ in range(4))
    tq, tk, tv, tg = (_t(a) for a in (q, k, v, g))
    o, lse = kernels.flash_attention_forward_plain(tq, tk, tv, causal)
    di = (tg * o).sum(-1, keepdim=True)
    want = kernels.flash_attention_backward_plain(tq, tk, tv, tg, lse, di,
                                                  causal)
    return (q, k, v, g, lse.numpy(), di.numpy()), [_host(w) for w in want]


@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("d", kernels.FLASH_HEAD_DIMS)
def test_3xtf32_products_meet_the_k7_gate(d, causal):
    """K7's arithmetic, not the kernel (chip_smoke.py holds the kernel on
    the card): all five products as 3xTF32, P and dS split too, in f32,
    within the K7 gate of the plain version."""
    args, want = _k7_case(d, causal)
    got = _tf32_backward(*args, causal, passes=3)
    for name, a, b in zip(("dq", "dk", "dv"), got, want):
        _close(a, b, K7_RTOL, K7_ATOL, name)


def test_one_tf32_product_misses_the_k7_gate():
    """Why K7 pays for three products: one TF32 product (~3 decimal
    digits) puts dQ, dK and dV outside the gate."""
    args, want = _k7_case(16, True)
    got = _tf32_backward(*args, True, passes=1)
    for name, a, b in zip(("dq", "dk", "dv"), got, want):
        with pytest.raises(AssertionError):
            _close(a, b, K7_RTOL, K7_ATOL, name)


# -- K6's 3xTF32 arithmetic ---------------------------------------------------
#
# K6 runs Q·Kᵀ and P·V on the tensor cores as 3xTF32, in 64-key tiles with
# the online rescale. These tests hold that arithmetic, emulated in numpy,
# against the plain version under chip_smoke.py's K6 gate; as for K7, they
# do not run the kernel.

#: chip_smoke.py's FLASH_FWD_RTOL / FLASH_FWD_ATOL: K6 against its plain
#: version on the card, for O and lse
K6_RTOL, K6_ATOL = 4e-5, 4e-6
#: a ragged S (3 whole 64-key tiles and one of 8 keys), as chip_smoke's
#: K6 small checks
K6_S, K6_TILE = 200, 64


def _tf32_forward(q, k, v, causal, kv_order, passes):
    """K6's arithmetic on heads-first f32 arrays: Q times scale·log2e
    before its split, x = Q·Kᵀ through `_tf32_product` per 64-key tile,
    visited first to last or (`rev`) last to first; masked keys (key >
    query, key ≥ S) set to −inf by index; m starts at −1e30; p =
    exp2(x − m'), l = l·2^(m − m') + Σp, acc = acc·2^(m − m') + P·V (P
    split too, a fresh sum per tile); O = acc / l, lse = m·ln2 + log l.
    Tiles wholly above the diagonal, which the kernel skips, leave m, l
    and acc as they were here too (a factor 2^0 = 1, p = 0)."""
    f32 = np.float32
    bh, s, d = q.shape
    sl2 = f32(1.0 / np.sqrt(d)) * f32(np.log2(np.e))
    qs = (q * sl2).astype(f32)
    rows = np.arange(s)[:, None]
    m = np.full((bh, s, 1), f32(-1e30), f32)
    l = np.zeros((bh, s, 1), f32)
    acc = np.zeros_like(q)
    starts = list(range(0, s, K6_TILE))
    for k0 in (starts[::-1] if kv_order == "rev" else starts):
        keys = np.arange(k0, min(k0 + K6_TILE, s))[None, :]
        x = _tf32_product(qs, k[:, k0:k0 + K6_TILE].transpose(0, 2, 1),
                          passes).astype(f32)
        if causal:
            x = np.where(keys > rows, f32(-np.inf), x)
        mn = np.maximum(m, x.max(-1, keepdims=True))
        alpha = np.exp2(m - mn).astype(f32)
        p = np.exp2(x - mn).astype(f32)
        l = (l * alpha + p.sum(-1, keepdims=True, dtype=f32)).astype(f32)
        part = _tf32_product(p, v[:, k0:k0 + K6_TILE], passes)
        acc = (acc * alpha + part).astype(f32)
        m = mn
    return ((acc / l).astype(f32),
            (m * f32(np.log(2.0)) + np.log(l)).astype(f32))


def _k6_case(d, causal, seed=13):
    """Inputs and the plain version's (O, lse) at S = 200, B·H = 2."""
    rs = np.random.RandomState(seed)
    q, k, v = (rs.randn(TF32_BH, K6_S, d).astype(np.float32)
               for _ in range(3))
    want = kernels.flash_attention_forward_plain(_t(q), _t(k), _t(v),
                                                 causal)
    return (q, k, v), [_host(w) for w in want]


@pytest.mark.parametrize("kv_order", kernels.KV_ORDERS)
@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("d", kernels.FLASH_HEAD_DIMS)
def test_3xtf32_products_meet_the_k6_gate(d, causal, kv_order):
    """K6's arithmetic, not the kernel (chip_smoke.py holds the kernel on
    the card): Q·Kᵀ and P·V as 3xTF32 in 64-key tiles with the online
    rescale, in either KV order, within the K6 gate of the plain version
    on O and lse."""
    args, (want_o, want_lse) = _k6_case(d, causal)
    o, lse = _tf32_forward(*args, causal, kv_order, passes=3)
    assert np.isfinite(o).all() and np.isfinite(lse).all()
    _close(o, want_o, K6_RTOL, K6_ATOL, "O")
    _close(lse, want_lse, K6_RTOL, K6_ATOL, "lse")


def test_one_tf32_product_misses_the_k6_gate():
    """Why K6 pays for three products: with one TF32 product for each of
    Q·Kᵀ and P·V, O falls outside the gate."""
    args, (want_o, _) = _k6_case(16, True)
    o, _ = _tf32_forward(*args, True, "fwd", passes=1)
    with pytest.raises(AssertionError):
        _close(o, want_o, K6_RTOL, K6_ATOL, "O")


def test_tf32_rounds_to_nearest_ties_away():
    one = np.float32(1.0)
    ulp = np.float32(2.0 ** -10)     # TF32's spacing at 1
    x = np.array([one + ulp / 2, -(one + ulp / 2), one + ulp / 2 * 0.99,
                  one + ulp * 1.5, np.float32(3.1415927)], np.float32)
    np.testing.assert_array_equal(
        _tf32(x), np.array([one + ulp, -(one + ulp), one, one + 2 * ulp,
                            np.float32(3.140625)], np.float32))
    assert (_tf32(x).view(np.uint32) & 0x1FFF == 0).all()
    np.testing.assert_array_equal(
        _tf32_truncated(x), np.array([one, -one, one, one + ulp,
                                      np.float32(3.140625)], np.float32))
