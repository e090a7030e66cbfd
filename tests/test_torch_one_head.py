"""Attention at head width 64 on the CPU: K6/K7's plain versions and the
char-transformer at one head of 64, held against the JAX package.

- The plain versions of K6 and K7 (through their wrappers, which take
  them on the CPU) at D = 64 against the JAX package's Pallas kernels in
  interpret mode (`_flash_fwd_core`, `_flash_bwd_pallas` at blk_q =
  blk_k = 16, S = 64, causal or not): forward rtol 2e-4, atol 2e-5,
  gradients rtol 5e-4, atol 5e-5, the JAX package's kernel-vs-golden
  tolerances.
- The char-transformer at `n_heads=1` (embed 64: one head of 64, ffn 96,
  seq_len 256, minibatch 4, `use_flash="on"` on both sides): 3 fused
  steps against the JAX `FusedTrainStep` (Pallas interpreted) from the
  JAX state, one minibatch with a pad-mask row: loss rtol 1e-5, n_err
  equal, parameters and velocities rtol 1e-4, atol 1e-7.
"""

import contextlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import veles_tpu.ops.pallas_kernels as pk
from veles_tpu import prng as jprng
from veles_tpu.config import root as jroot
from veles_tpu.ops import variants as jvariants
from veles_tpu.samples import char_transformer as jct
from veles_tpu_torch import convert, prng
from veles_tpu_torch.config import root
from veles_tpu_torch.ops import kernels, variants
from veles_tpu_torch.samples import char_transformer as ct

FWD_RTOL, FWD_ATOL = 2e-4, 2e-5
BWD_RTOL, BWD_ATOL = 5e-4, 5e-5
LOSS_RTOL = 1e-5
RTOL, ATOL = 1e-4, 1e-7
BH, S, D, BLK = 2, 64, 64, 16
ONE_HEAD = {"embed": 64, "n_heads": 1, "ffn": 96, "loader.seq_len": 256,
            "loader.minibatch_size": 4, "loader.n_validation": 4}


@pytest.fixture(autouse=True)
def _interpret_and_seeds():
    saved = jprng._base_seed, prng._base_seed
    pk._FORCE_INTERPRET = True
    yield
    pk._FORCE_INTERPRET = False
    jprng._base_seed, prng._base_seed = saved


def _rows(seed, n):
    rs = np.random.RandomState(seed)
    return [rs.randn(BH, S, D).astype(np.float32) for _ in range(n)]


def _close(got, want, rtol, atol, what):
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               rtol=rtol, atol=atol, err_msg=what)


def test_d64_is_compiled():
    assert 64 in kernels.FLASH_HEAD_DIMS


@pytest.mark.parametrize("causal", [False, True])
def test_plain_forward_matches_pallas_at_d64(causal):
    q, k, v = _rows(1, 3)
    want_o, want_lse = pk._flash_fwd_core(q, k, v, 1.0 / np.sqrt(D), causal,
                                          BLK, BLK)
    o, lse = kernels.flash_attention_forward(
        *(torch.from_numpy(a) for a in (q, k, v)), causal)
    _close(o, want_o, FWD_RTOL, FWD_ATOL, "O")
    _close(lse, want_lse, FWD_RTOL, FWD_ATOL, "lse")


@pytest.mark.parametrize("causal", [False, True])
def test_plain_backward_matches_pallas_at_d64(causal):
    q, k, v, do = _rows(2, 4)
    scale = 1.0 / np.sqrt(D)
    out, lse = pk._flash_fwd_core(q, k, v, scale, causal, BLK, BLK)
    di = np.asarray(jnp.sum(do * out, axis=-1, keepdims=True))
    want = pk._flash_bwd_pallas(q, k, v, do, lse, di, scale, causal, BLK,
                                BLK)
    got = kernels.flash_attention_backward(
        *(torch.from_numpy(np.array(a)) for a in (q, k, v, do, lse, di)),
        causal)
    for name, a, b in zip(("dq", "dk", "dv"), got, want):
        _close(a, b, BWD_RTOL, BWD_ATOL, name)


@contextlib.contextmanager
def _config(node, overrides):
    saved = node.to_dict()
    for dotted, value in overrides.items():
        node.override(dotted, value)
    try:
        yield
    finally:
        node.update(saved)


@contextlib.contextmanager
def _selected(registry, **sel):
    prev = {op: registry.selected(op) for op in sel}
    for op, name in sel.items():
        registry.select(op, name)
    try:
        yield
    finally:
        for op, name in prev.items():
            if name is None:
                registry.clear_selection(op)
            else:
                registry.select(op, name)


def _compare_states(jstate, pstate, what):
    host = convert.state_to_numpy(pstate)
    for slot in ("params", "vel"):
        for i, (a, b) in enumerate(zip(jstate[slot], host[slot])):
            for key in a:
                np.testing.assert_allclose(
                    b[key], np.asarray(a[key]), rtol=RTOL, atol=ATOL,
                    err_msg=f"{what}: {slot} unit {i} {key}")


def test_one_head_of_64_tracks_the_jax_step():
    jprng._generators.clear()
    jprng.seed_all(13)
    with _config(jroot.char_transformer, ONE_HEAD):
        jwf = jct.create_workflow()
    prng._generators.clear()
    prng.seed_all(13)
    with _config(root.char_transformer, ONE_HEAD):
        pwf = ct.create_workflow()
    for wf in (jwf, pwf):
        wf.forwards[1].use_flash = "on"
    jwf.initialize(device=None)
    pwf.initialize("cpu")
    assert pwf.forwards[1].head_dim == 64
    with jvariants.pallas_interpret(), \
            _selected(jvariants, sgd_update="pallas_rows[rt=8]"), \
            _selected(variants, sgd_update="kernel"):
        jstep, pstep = jwf.build_fused_step(), pwf.build_fused_step()
        assert pstep.variant_table()["flash_attn"] == "kernel"
        jstate = jstep.init_state()
        pstate = convert.state_from_jax(jstate, "cpu", pstep)
        data, labels = pwf.loader.data, pwf.loader.labels
        n_valid = pwf.loader.class_lengths[1]
        for i in range(3):
            idx = n_valid + np.random.RandomState(20 + i).choice(
                len(data) - n_valid, 4, replace=False)
            x, y = data[idx], labels[idx].reshape(-1)
            w = np.ones(4, np.float32)
            if i == 1:
                w[-1] = 0.0
            jstate, (jloss, jerr) = jstep.train(jstate, x, y, w)
            pstate, (ploss, perr) = pstep.train(pstate, x, y, w)
            np.testing.assert_allclose(float(ploss), float(jloss),
                                       rtol=LOSS_RTOL, err_msg=f"step {i}")
            assert int(perr) == int(jerr), i
            _compare_states(jstate, pstate, f"after step {i}")
    jwf._stop_units()
