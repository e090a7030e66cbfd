"""The switch mixture of experts on the CPU, against the JAX package
(`veles_tpu/ops/moe.py`, `veles_tpu/znicz/moe.py`,
`veles_tpu/samples/moe.py`, the char-transformer's `moe_experts`).

- The routing: the port routes by index and builds no (N, E, C) mask;
  its `top1_dispatch` (the dense masks, for tests) gives the JAX
  function's masks exactly, first on ties, with a capacity that drops.
- `moe_forward` against the JAX `moe_forward` at a binding, the default
  and an ample capacity, rtol 1e-5, atol 1e-6 in f32 (both select the
  same rows and add only zeros; the experts' products sum in another
  order); its gradients against `jax.grad` likewise.
- The unit: `MoELayer`'s fill bit for bit, and its forward in token,
  sample and residual modes against the JAX unit's, rtol 1e-5, atol
  1e-6; the router-width check on restore.
- The index routing's guard: `moe_forward` at 131,072 tokens, 8 experts
  and D 8 finishes on the CPU, where the dense masks would take 137 GB;
  sampled tokens against the switch rule computed by hand.
- The bf16 count: the JAX function takes its prefix count in the
  probabilities' dtype, which in bf16 puts two tokens in one slot past
  256 (ROADMAP, the reference's gap); the port counts in integers.
- Training: the MoE sample and a toy MoE char-transformer, 3 fused steps
  against the JAX fused step from the JAX state and batches (loss rtol
  1e-5, parameters and velocities rtol 1e-4, atol 1e-7 per leaf), and 2
  granular epochs against the JAX granular run from one seed (the
  Decision's history equal, loss rtol 1e-5, parameters and velocities
  rtol 1e-4, atol 1e-6).
- A snapshot round trip (the JAX `test_moe_workflow_snapshot_roundtrip`)
  and the exporter: `_export_moe`'s files byte for byte the JAX
  exporter's, the native engine within the export tests' rtol 3e-4,
  atol 3e-5 of the port's forward.
"""

import contextlib
import os
import pickle
import shutil

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from veles_tpu import prng as jprng
from veles_tpu.backends import XLADevice
from veles_tpu.config import root as jroot
from veles_tpu.export import export_workflow as jexport
from veles_tpu.ops import moe as jmoe
from veles_tpu.samples import char_transformer as jct
from veles_tpu.samples import moe as jsample
from veles_tpu.znicz import moe as jzmoe
from veles_tpu_torch import convert, prng
from veles_tpu_torch.config import root
from veles_tpu_torch.export import export_workflow
from veles_tpu_torch.ops import moe as om
from veles_tpu_torch.samples import char_transformer as ct
from veles_tpu_torch.samples import moe as sample
from veles_tpu_torch.znicz.moe import MoELayer

RTOL, ATOL = 1e-5, 1e-6
STEP_RTOL, STEP_ATOL = 1e-4, 1e-7
GRANULAR_ATOL = 1e-6
ENGINE_RTOL, ENGINE_ATOL = 3e-4, 3e-5


@pytest.fixture(autouse=True)
def _restore():
    saved = (jprng._base_seed, prng._base_seed, jroot.moe.to_dict(),
             root.moe.to_dict(), jroot.char_transformer.to_dict(),
             root.char_transformer.to_dict())
    yield
    (jprng._base_seed, prng._base_seed, jroot.moe, root.moe,
     jroot.char_transformer, root.char_transformer) = saved


def _seeded(seed):
    jprng._generators.clear()
    jprng.seed_all(seed)
    prng._generators.clear()
    prng.seed_all(seed)


def _params(d=8, e=4, h=16, seed=0):
    rng = np.random.RandomState(seed)
    return (rng.randn(d, e).astype(np.float32) * 0.3,
            rng.randn(e, d, h).astype(np.float32) * 0.3,
            rng.randn(e, h).astype(np.float32) * 0.1,
            rng.randn(e, h, d).astype(np.float32) * 0.3,
            rng.randn(e, d).astype(np.float32) * 0.1)


def _t(arrays):
    return [torch.from_numpy(np.ascontiguousarray(a)) for a in arrays]


# -- routing ------------------------------------------------------------------

def test_top1_dispatch_capacity():
    """The JAX test's case: three tokens for expert 0 at capacity 2."""
    probs = np.array([[0.9, 0.1], [0.8, 0.2], [0.7, 0.3]], np.float32)
    d, c = om.top1_dispatch(torch.from_numpy(probs), 2)
    d, c = d.numpy(), c.numpy()
    assert d[0, 0, 0] == 1 and d[1, 0, 1] == 1 and d[2].sum() == 0
    np.testing.assert_allclose(c[0, 0, 0], 0.9)


@pytest.mark.parametrize("capacity", [1, 3, 7, 64])
def test_dispatch_masks_equal_the_jax_masks(capacity):
    """Random probabilities with exact ties planted (equal maxima in a
    row, which the first index wins), capacity binding to ample."""
    rng = np.random.RandomState(capacity)
    logits = rng.randn(48, 5).astype(np.float32)
    logits[::4, 3] = logits[::4, 1] = logits[::4].max(1) + 1.0
    probs = np.array(jax.nn.softmax(jnp.asarray(logits), axis=-1))
    assert (probs[::4, 1] == probs[::4, 3]).all()
    jd, jc = jmoe.top1_dispatch(jnp.asarray(probs), capacity)
    pd, pc = om.top1_dispatch(torch.from_numpy(probs), capacity)
    np.testing.assert_array_equal(pd.numpy(), np.asarray(jd))
    np.testing.assert_array_equal(pc.numpy(), np.asarray(jc))
    if capacity < 12:
        assert pd.numpy().sum() < 48       # the capacity dropped tokens
    expert, slot, keep, gate = om.top1_route(torch.from_numpy(probs),
                                             capacity)
    assert (expert.numpy()[::4] == 1).all()


@pytest.mark.parametrize("capacity", [3, None, 40])
def test_moe_forward_matches_jax(capacity):
    wr, w1, b1, w2, b2 = _params()
    x = np.random.RandomState(1).randn(40, 8).astype(np.float32)
    want = np.asarray(jmoe.moe_forward(x, wr, w1, b1, w2, b2,
                                       capacity=capacity))
    got = om.moe_forward(*_t((x, wr, w1, b1, w2, b2)), capacity=capacity)
    np.testing.assert_allclose(got.numpy(), want, rtol=RTOL, atol=ATOL)


def test_moe_forward_gradients_match_jax():
    """Gradients through the gate and the experts at a binding capacity;
    none through the argmax or the count."""
    arrays = (np.random.RandomState(2).randn(40, 8).astype(np.float32),
              *_params(seed=3))
    g = np.random.RandomState(4).randn(40, 8).astype(np.float32)

    def jloss(*a):
        return (jmoe.moe_forward(*a, capacity=6) * g).sum()
    want = jax.grad(jloss, argnums=tuple(range(6)))(
        *(jnp.asarray(a) for a in arrays))
    ts = [t.requires_grad_(True) for t in _t(arrays)]
    (om.moe_forward(*ts, capacity=6) * torch.from_numpy(g)).sum().backward()
    for name, t, w in zip(("x", "wr", "w1", "b1", "w2", "b2"), ts, want):
        np.testing.assert_allclose(t.grad.numpy(), np.asarray(w),
                                   rtol=RTOL, atol=ATOL, err_msg=name)


def test_index_routing_at_full_width_without_the_dense_mask():
    """131,072 tokens, 8 experts, D 8: capacity 32,768, so the JAX masks
    would be 131072 x 8 x 32768 f32 = 137 GB. The port's forward runs
    here; 256 sampled tokens equal the switch rule by hand (the kept
    ones gate * FFN of their expert, the dropped ones zero)."""
    n, e, d, h = 131072, 8, 8, 8
    rng = np.random.RandomState(7)
    wr = rng.randn(d, e).astype(np.float32)
    wr[:, 0] += 0.8              # with x's mean: expert 0 over capacity
    w1 = rng.randn(e, d, h).astype(np.float32) * 0.3
    b1 = rng.randn(e, h).astype(np.float32) * 0.1
    w2 = rng.randn(e, h, d).astype(np.float32) * 0.3
    b2 = rng.randn(e, d).astype(np.float32) * 0.1
    x = (rng.randn(n, d) + 0.5).astype(np.float32)
    cap = om.default_capacity(n, e)
    assert cap == 32768 and n * e * cap * 4 > 137e9
    y = om.moe_forward(*_t((x, wr, w1, b1, w2, b2))).numpy()
    assert y.shape == (n, d) and np.isfinite(y).all()
    probs = om.router_probs(torch.from_numpy(x), torch.from_numpy(wr))
    probs = probs.numpy()
    expert = probs.argmax(1)
    loads = np.bincount(expert, minlength=e)
    assert loads.max() > cap                 # the capacity binds
    slot = np.zeros(n, np.int64)
    seen = np.zeros(e, np.int64)
    for i, k in enumerate(expert):
        slot[i], seen[k] = seen[k], seen[k] + 1
    dropped = slot >= cap
    for i in sorted(rng.choice(n, 256, replace=False)) + \
            list(np.flatnonzero(dropped)[:8]):
        k = expert[i]
        if dropped[i]:
            np.testing.assert_array_equal(y[i], 0.0)
            continue
        hid = np.maximum(x[i] @ w1[k] + b1[k], 0.0)
        want = probs[i, k] * (hid @ w2[k] + b2[k])
        np.testing.assert_allclose(y[i], want, rtol=RTOL, atol=ATOL)


def test_the_bf16_count_in_the_reference_and_the_port():
    """600 tokens to one expert at capacity 600: the JAX function counts
    in bf16 and, past 256, puts tokens into one slot (and leaves slots
    empty); the port's integer count gives every token its own slot."""
    n = 600
    probs = np.tile(np.array([[0.75, 0.25]], np.float32), (n, 1))
    jd, _ = jmoe.top1_dispatch(jnp.asarray(probs, jnp.bfloat16), n)
    per_slot = np.asarray(jd.astype(jnp.float32))[:, 0, :].sum(0)
    assert (per_slot > 1).any()          # the reference's gap
    pd, _ = om.top1_dispatch(torch.from_numpy(probs).to(torch.bfloat16), n)
    per_slot = pd.float().numpy()[:, 0, :].sum(0)
    np.testing.assert_array_equal(per_slot, np.ones(n))
    jd32, _ = jmoe.top1_dispatch(jnp.asarray(probs), n)
    np.testing.assert_array_equal(pd.float().numpy(), np.asarray(jd32))


# -- the unit -----------------------------------------------------------------

@pytest.mark.parametrize("shape,kw", [
    ((6, 5, 8), {}),                                     # token (auto)
    ((6, 5, 8), {"route": "token", "residual": True}),
    ((6, 5, 8), {"route": "sample"}),
    ((12, 8), {}),                                       # sample (auto)
    ((12, 8), {"residual": True, "capacity_factor": 1.0})])
def test_unit_matches_the_jax_unit(shape, kw):
    kw = dict({"n_experts": 4, "hidden": 16, "capacity_factor": 2.0}, **kw)
    x = np.random.RandomState(1).randn(*shape).astype(np.float32)
    _seeded(90)
    ju = jzmoe.MoELayer(None, **kw)
    ju.input.reset(x)
    ju.initialize(device=None)
    pu = MoELayer(**kw)
    out_shape = pu.initialize(shape[1:], torch.device("cpu"))
    assert (shape[0],) + tuple(out_shape) == tuple(ju.output.shape)
    jp = {k: np.asarray(a.mem) for k, a in ju.param_arrays().items()}
    for k, t in pu.param_arrays().items():
        np.testing.assert_array_equal(t.detach().numpy(), jp[k], err_msg=k)
    want = np.asarray(ju.fused_apply({k: jnp.asarray(v)
                                      for k, v in jp.items()},
                                     jnp.asarray(x)))
    with torch.no_grad():
        got = pu.fused_apply(pu.param_arrays(), torch.from_numpy(x))
    np.testing.assert_allclose(got.numpy(), want, rtol=RTOL, atol=ATOL)


def test_a_router_of_another_width_is_refused():
    u = MoELayer(n_experts=4, hidden=8, route="sample")
    u.initialize((5, 8), torch.device("cpu"))     # routes 40 features
    u.route = "token"                             # now it would route 8
    with pytest.raises(ValueError, match="router expects feature dim 40"):
        u.initialize((5, 8), torch.device("cpu"))


# -- training -----------------------------------------------------------------

SAMPLE = {"loader.n_train": 256, "loader.n_validation": 64,
          "decision.max_epochs": 2}
CT_MOE = {"embed": 16, "n_heads": 2, "ffn": 24, "loader.seq_len": 32,
          "loader.minibatch_size": 8, "loader.n_validation": 16,
          "moe_experts": 4, "decision.max_epochs": 1}


@contextlib.contextmanager
def _config(node, overrides):
    saved = node.to_dict()
    for dotted, value in overrides.items():
        node.override(dotted, value)
    try:
        yield
    finally:
        node.update(saved)


def _both(name, device, seed=1234):
    """The model in both packages from one seed: the JAX workflow on
    `device` (a JAX backend) and the port's on the CPU."""
    jmod, pmod, jnode, pnode, over = {
        "sample": (jsample, sample, jroot.moe, root.moe, SAMPLE),
        "transformer": (jct, ct, jroot.char_transformer,
                        root.char_transformer, CT_MOE)}[name]
    _seeded(seed)
    with _config(jnode, over):
        jwf = jmod.create_workflow()
    with _config(pnode, over):
        pwf = pmod.create_workflow()
    jwf.initialize(device=device)
    pwf.initialize("cpu")
    return jwf, pwf


def _batches(pwf, k=3):
    """k train minibatches: the text's windows, or (the synthetic
    classifier's samples come on first use) rows drawn from a seed."""
    loader = pwf.loader
    mb = loader.minibatch_size
    if getattr(loader, "data", None) is None:
        rs = np.random.RandomState(11)
        return [(rs.randn(mb, *loader.sample_shape).astype(np.float32),
                 rs.randint(0, pwf.n_classes, mb)) for _ in range(k)]
    idx = loader._indices_per_class[2]
    out = []
    for i in range(k):
        rows = idx[i * mb:(i + 1) * mb]
        x = np.asarray(loader.data[rows], np.float32)
        y = loader.labels[rows]
        out.append((x, y.reshape(-1) if y.ndim > 1 else y))
    return out


def _close(want, got, what, rtol, atol):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want),
                               rtol=rtol, atol=atol, err_msg=what)


@pytest.mark.parametrize("name", ["sample", "transformer"])
def test_fused_steps_match_the_jax_fused_step(name):
    jwf, pwf = _both(name, XLADevice())
    assert any(type(u).__name__ == "MoELayer" for u in pwf.forwards)
    jstep = jwf.build_fused_step()
    jstate = jstep.init_state()
    pstep = pwf.build_fused_step()
    pstate = convert.state_from_jax(jstate, "cpu", step=pstep)
    for x, y in _batches(pwf):
        jstate, (jloss, jerr) = jstep.train(jstate, x, y)
        pstate, (ploss, perr) = pstep.train(pstate, x, y)
        np.testing.assert_allclose(float(ploss), float(jloss), rtol=RTOL)
        assert int(perr) == int(jerr)
    for i, (jp, pp, jv, pv) in enumerate(zip(
            jstate["params"], pstate["params"], jstate["vel"],
            pstate["vel"])):
        for k in pp:
            _close(jp[k], pp[k].detach().numpy(), f"unit {i} {k}",
                   STEP_RTOL, STEP_ATOL)
            _close(jv[k], pv[k].numpy(), f"unit {i} velocity {k}",
                   STEP_RTOL, STEP_ATOL)


@pytest.mark.parametrize("name", ["sample", "transformer"])
def test_granular_run_tracks_the_jax_granular_run(name):
    jwf, pwf = _both(name, XLADevice())
    jwf.run()
    pwf.run()
    assert pwf.decision.history == jwf.decision.history
    np.testing.assert_allclose(pwf.evaluator.loss, jwf.evaluator.loss,
                               rtol=RTOL)
    n = len(pwf.forwards)
    for i, (ju, pu) in enumerate(zip(jwf.forwards, pwf.forwards)):
        jg, pg = jwf.gds[n - 1 - i], pwf.gds[n - 1 - i]
        for k, t in pu.param_arrays().items():
            _close(getattr(ju, k).mem, t.detach().numpy(), f"unit {i} {k}",
                   STEP_RTOL, GRANULAR_ATOL)
            jv = getattr(jg, f"vel_{k}", None)
            if not jv:
                jv = getattr(jg, pg.vel_attr(k))
            _close(jv.mem, pg.velocity(k).numpy(),
                   f"unit {i} velocity {k}", STEP_RTOL, GRANULAR_ATOL)


def test_jax_granular_moe_state_continues_in_the_port():
    """`convert.granular_from_jax` carries the MoE leaves and their
    velocities (`vel_wr`, `vel_w1`, ...) across."""
    jwf, pwf = _both("sample", XLADevice())
    jwf.decision.max_epochs = 1
    jwf.run()
    convert.granular_from_jax(jwf, pwf)
    moe_j, moe_p = jwf.forwards[1], pwf.forwards[1]
    jg, pg = jwf.gds[1], pwf.gds[1]
    for k in ("wr", "w1", "b1", "w2", "b2"):
        np.testing.assert_array_equal(
            moe_p.param_arrays()[k].detach().numpy(), getattr(moe_j, k).mem)
        np.testing.assert_array_equal(pg.velocity(k).numpy(),
                                      getattr(jg, f"vel_{k}").mem)
        assert np.abs(pg.velocity(k).numpy()).max() > 0, k


def test_moe_workflow_snapshot_roundtrip():
    """Parameters (the experts and the router) survive the pickle and a
    restored workflow keeps training (the JAX test's flow)."""
    _seeded(777)
    with _config(root.moe, SAMPLE):
        wf = sample.create_workflow()
    wf.initialize("cpu")
    wf.run()
    w1_before = wf.forwards[1].w1.detach().clone()
    err_before = wf.decision.best_validation_err
    wf2 = pickle.loads(pickle.dumps(wf))
    assert torch.equal(wf2.forwards[1].w1.detach(), w1_before)
    assert wf2.decision.best_validation_err == err_before
    wf2.decision.max_epochs += 2
    wf2.decision.complete <<= False
    wf2.initialize("cpu")
    wf2.run()
    assert wf2.decision.epoch_number > wf.decision.epoch_number


# -- the exporter -------------------------------------------------------------

@pytest.fixture(scope="module")
def moe_packages(tmp_path_factory):
    """The MoE sample (sample routes) and the MoE char-transformer (token
    routes, residual) exported by both packages from the JAX parameters."""
    from veles_tpu.backends import NumpyDevice
    out = {}
    saved = (jroot.moe.to_dict(), root.moe.to_dict(),
             jroot.char_transformer.to_dict(),
             root.char_transformer.to_dict())
    try:
        for name in ("sample", "transformer"):
            jwf, pwf = _both(name, NumpyDevice())
            jparams = tuple({k: np.asarray(a.mem)
                             for k, a in u.param_arrays().items()}
                            for u in jwf.forwards)
            convert.params_from_jax(jparams, "cpu", workflow=pwf)
            d = tmp_path_factory.mktemp(name)
            out[name] = (pwf, jexport(jwf, str(d / "jax")),
                         export_workflow(pwf, str(d / "port")))
    finally:
        (jroot.moe, root.moe, jroot.char_transformer,
         root.char_transformer) = saved
    return out


@pytest.mark.parametrize("name", ["sample", "transformer"])
def test_export_moe_equals_the_jax_export(name, moe_packages):
    import json
    _, jpkg, ppkg = moe_packages[name]
    for f in ("topology.json", "weights.bin"):
        with open(os.path.join(jpkg, f), "rb") as a, \
                open(os.path.join(ppkg, f), "rb") as b:
            assert a.read() == b.read(), f
    spec = [lay for lay in json.load(open(os.path.join(
        ppkg, "topology.json")))["layers"] if lay["type"] == "moe"][0]
    assert spec["route"] == ("sample" if name == "sample" else "token")


@pytest.mark.skipif(shutil.which("g++") is None, reason="no C++ toolchain")
@pytest.mark.parametrize("name", ["sample", "transformer"])
def test_engine_matches_the_port_forward_on_moe(name, moe_packages):
    from veles_tpu_torch.native_engine import NativeEngine
    pwf, _, ppkg = moe_packages[name]
    x = np.asarray(pwf.loader.data[:4], np.float32) if name == "transformer" \
        else np.random.RandomState(5).randn(
            4, *pwf.loader.sample_shape).astype(np.float32)
    fwd = pwf.build_forward()
    with torch.no_grad():
        z = fwd._forward(fwd.params(), torch.from_numpy(x))
        want = torch.softmax(z, dim=-1).reshape(len(x), -1).numpy()
    with NativeEngine(ppkg) as eng:
        got = eng.infer(x)
    np.testing.assert_allclose(got, want, rtol=ENGINE_RTOL,
                               atol=ENGINE_ATOL)
