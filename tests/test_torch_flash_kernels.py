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
