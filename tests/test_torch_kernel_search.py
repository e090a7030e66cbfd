"""The port's kernel search on the CPU, held against the JAX package's:
the search's pure functions, the names of its points, the points of the
same name, every kernel point's contract, and the gates that stand
between a candidate and its timing.

- `priority_order`, `allocate_budget` and `incumbent_floor` give the JAX
  functions' results on the same profile JSON and op lists (exactly:
  they are the same arithmetic); names round-trip and stale ones are
  refused as the JAX `KernelTemplate.parse` refuses them.
- Every `conv_stem` `gen[...]` and `maxpool` `gen[...]` point equals the
  JAX point of the same name, forward and gradients, on the four stem
  geometries of tests/test_ops_equivalence.py:339-360 (f32: rtol 1e-4,
  atol 1e-4 and 1e-4 of the largest value, the JAX contract's; bf16:
  2^-7 of each value and of the largest, one rounding of bf16 on either
  side; the stem's bf16 gradients against the JAX point in f32 on the
  bf16 values, behind a linear activation: a strict ReLU's mask flips
  where the bias is added to a rounded convolution within an ulp of 0).
- Every `lrn`, `lrn_maxpool`, `sgd_update` and `flash_attn` point passes
  its contract here (its plain route on the CPU), and equals the JAX
  point with the same io / fuse / kv_order / drop in interpret mode,
  forward and backward (f32: the JAX package's Pallas-vs-golden rtol
  1e-4, atol 1e-5; bf16: 2^-7 of each value, one bf16 rounding). The
  composed (fuse=0) points' bf16 backward is held in f32 only: the JAX
  composed LRN computes in bf16 (XLA), the port's in f32 rounded once
  (K2/K3), and a window whose two largest values round together routes
  its gradient by that rounding.
- The gates (after tests/test_kernel_search.py:168-223, :625): a failing
  contract is never timed, a ledger bypass raises
  `UngatedCandidateError`, an over-budget point is pruned and its timing
  refused (`InfeasibleCandidateError`: flash at D = 128 needs 266,240 B
  against a 227 KB budget), every timed trial was gated first, and a
  zero budget or an empty op list searches nothing.
"""

import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from veles_tpu.ops import autotune as jat
from veles_tpu.ops import templates as jtemplates
from veles_tpu.ops import variants as jvariants
from veles_tpu_torch.analysis import resources
from veles_tpu_torch.ops import autotune as at
from veles_tpu_torch.ops import kernels, templates, variants

F32_TOL = dict(rtol=1e-4, atol=1e-5)
BF16_REL = 2.0 ** -7


@pytest.fixture(autouse=True)
def _isolated():
    """The registries' selections and the ledger are process-wide; so are
    both packages' f32 precision settings, pinned here to full f32 for
    the comparisons (as tests/conftest.py pins JAX's) whatever an earlier
    test in this process left."""
    snaps = variants.selection_table(), jvariants.selection_table()
    prev = (torch.get_float32_matmul_precision(),
            jax.config.jax_default_matmul_precision)
    torch.set_float32_matmul_precision("highest")
    jax.config.update("jax_default_matmul_precision", "highest")
    yield
    torch.set_float32_matmul_precision(prev[0])
    jax.config.update("jax_default_matmul_precision", prev[1])
    for reg, snap in zip((variants, jvariants), snaps):
        reg.clear_selection()
        for op, name in snap.items():
            reg.select(op, name)
    templates.clear_ledger()


def _cache(tmp_path):
    return at.AutotuneCache(str(tmp_path / "cache.json"))


# ---------------------------------------------------------------------------
# 1. pure functions against the JAX package's
# ---------------------------------------------------------------------------

PROFILES = ({"ops": {"lrn": 0.4, "maxpool": 0.1, "conv_stem": 0.2,
                     "flash_attn": 0.05}},
            {"ops": {"sgd_update": 0.3, "lrn_maxpool": 0.0, "lrn": 0.2}},
            {"ops": {"lrn": "bad", "maxpool": 0.5}},
            None)
OP_LISTS = (["lrn", "maxpool", "lrn_maxpool", "conv_stem"],
            ["flash_attn", "sgd_update"],
            ["lrn_maxpool", "lrn", "maxpool", "conv_stem", "flash_attn",
             "sgd_update"],
            [])


@pytest.mark.parametrize("profile", PROFILES)
@pytest.mark.parametrize("ops", OP_LISTS)
def test_priority_order_matches_jax(tmp_path, profile, ops):
    path = tmp_path / "LAYER_PROFILE.json"
    if profile is not None:
        path.write_text(json.dumps(profile))
    assert at.priority_order(ops, str(path)) \
        == jat.priority_order(ops, str(path))


@pytest.mark.parametrize("budget", [0, 3, 8, 16, 19, 24, 40])
@pytest.mark.parametrize("shares", [
    [("lrn", 0.5), ("maxpool", 0.3), ("conv_stem", 0.2)],
    [("lrn_maxpool", 0.0), ("sgd_update", 0.0), ("flash_attn", 0.0)],
    [("a", 1.0)], []])
def test_allocate_budget_matches_jax(budget, shares):
    floors = {"lrn": 4, "maxpool": 3, "conv_stem": 3, "lrn_maxpool": 3}
    for fl in (None, floors):
        assert at.allocate_budget(shares, budget, fl) \
            == jat.allocate_budget(shares, budget, fl)


@pytest.mark.parametrize("op", ["lrn", "maxpool", "lrn_maxpool",
                                "conv_stem", "flash_attn", "sgd_update"])
def test_incumbent_floor_is_the_jax_rule(op):
    """Each hand-written incumbent plus one generated point: the JAX rule
    over each registry, so equal where the two hand-written sets are."""
    hand = [v for v in variants.variants_for(op) if v.tunable]
    assert at.incumbent_floor(op) == len(hand) + 1
    jhand = {v.name for v in jvariants.variants_for(op)
             if v.tunable and not v.generated}
    if op in ("maxpool", "conv_stem", "flash_attn"):
        assert at.incumbent_floor(op) == jat.incumbent_floor(op)
        assert len(jhand) == len(hand)


@pytest.mark.parametrize("op", ["lrn", "maxpool", "lrn_maxpool",
                                "conv_stem", "flash_attn", "sgd_update"])
def test_every_point_round_trips_by_name(op):
    (t,) = templates.templates_for(op)
    assert op in templates.CONTRACTS and op in templates.BENCHES
    for cfg in t.configs():
        name = t.name(cfg)
        assert t.parse(name) == cfg
        v = variants.get(op, name)
        assert v.generated and v.name == name
        assert variants.get(op, name) is v          # materialized once
    assert len(t.configs()) == t.size


STALE = ("gen[pack=s2d,acc=native]", "gen[pack=s2d,acc=native,epi=lrn,x=1]",
         "gen[pack=s2d,acc=bf16,epi=none]", "gen[pack=s2d,acc=native,epi]",
         "pallas[pack=s2d,acc=native,epi=none]", "gen[]", "gen",
         "gen[pack=s2d,acc=native,epi=none", "gen[algo=slices,fold=deep]",
         "gen[algo=slices]", "gen[fold=tree,algo=slices]",
         "gen[algo=reduce_window,fold=linear]",
         "gen[pack=direct,acc=f32,epi=lrn]")


@pytest.mark.parametrize("name", STALE)
@pytest.mark.parametrize("op", ["conv_stem", "maxpool"])
def test_parse_refuses_what_the_jax_parse_refuses(op, name):
    """The plain templates parse names exactly as the JAX ones do: the
    same configs, and None for a stale or foreign name."""
    (t,) = templates.templates_for(op)
    (jt,) = jtemplates.templates_for(op)
    assert t.parse(name) == jt.parse(name)
    assert variants.has(op, name) == jvariants.has(op, name)


@pytest.mark.parametrize("op,name", [
    ("lrn", "cuda[tile=3072]"), ("lrn", "cuda[tile=100,io=native]"),
    ("lrn", "pallas[rt=512,io=native]"),
    ("lrn_maxpool", "fused[rb=5,cb=16,io=native,fuse=1]"),
    ("sgd_update", "cuda_rows[threads=96]"),
    ("flash_attn", "cuda[blk_q=128,blk_k=64,kv_order=fwd,drop=0]")])
def test_stale_kernel_names_are_refused(op, name):
    assert templates.parse_point(op, name) is None
    assert not variants.has(op, name)
    with pytest.raises(KeyError):
        variants.select(op, name)


# ---------------------------------------------------------------------------
# 2. the plain points of the same name as the JAX package's
# ---------------------------------------------------------------------------

#: tests/test_ops_equivalence.py:339-360: (x, w, stride, padding)
STEMS = (((2, 227, 227, 3), (11, 11, 3, 8), 4, (0, 0)),
         ((2, 32, 32, 3), (7, 7, 3, 4), 2, (0, 0)),
         ((1, 29, 29, 2), (5, 5, 2, 6), 3, (2, 2)),
         ((2, 16, 16, 4), (4, 4, 4, 8), 4, (0, 0)))
EPI = {"k": 2.0, "alpha": 1e-3, "beta": 0.75, "n": 5}


def _close(got, want, dtype, what, scale=None):
    got = np.asarray(got, np.float32)
    want = np.asarray(want, np.float32)
    top = float(np.abs(want).max()) if want.size else 0.0
    if dtype == "f32":
        np.testing.assert_allclose(got, want, rtol=1e-4,
                                   atol=max(1e-4, 1e-4 * top), err_msg=what)
    else:
        np.testing.assert_allclose(got, want, rtol=BF16_REL,
                                   atol=BF16_REL * top, err_msg=what)


def _jax_in(a, dtype):
    return jnp.asarray(a, jnp.bfloat16 if dtype == "bf16" else jnp.float32)


def _torch_in(a, dtype, grad=True):
    t = torch.tensor(a)
    if dtype == "bf16":
        t = t.to(torch.bfloat16)
    return t.requires_grad_(grad)


def _np(x):
    return np.asarray(x.detach().float() if isinstance(x, torch.Tensor)
                      else jnp.asarray(x, jnp.float32))


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("stem", range(len(STEMS)))
@pytest.mark.parametrize("name", [
    templates.templates_for("conv_stem")[0].name(c)
    for c in templates.templates_for("conv_stem")[0].configs()])
def test_conv_stem_point_equals_the_jax_point(name, stem, dtype):
    xs, ws, s, pad = STEMS[stem]
    rs = np.random.RandomState(stem)
    x = rs.randn(*xs).astype(np.float32)
    w = (rs.randn(*ws) * 0.1).astype(np.float32)
    b = rs.randn(ws[-1]).astype(np.float32)
    kw = {"epilogue": EPI} if "epi=lrn" in name else {}
    jf = jvariants.get("conv_stem", name).apply

    def jax_point(dt):
        return jax.vjp(lambda a, c, d: jf(a, c, d, (s, s), pad, act, **kw),
                       *(_jax_in(a, dt) for a in (x, w, b)))

    act = "strictrelu" if dtype == "f32" else "linear"
    yj, vjp = jax_point(dtype)
    g = rs.randn(*yj.shape).astype(np.float32)
    if dtype == "bf16":
        # the gradients against the JAX point in f32 on the bf16 values:
        # XLA's CPU sums a bf16 array in bf16 (the bias gradient over
        # AlexNet's 2x55x55 outputs drifts by 4%), and jax 0.9.0 cannot
        # transpose the acc=f32 point's mixed-dtype convolution
        x, w, b, g = (np.asarray(_jax_in(a, "bf16"), np.float32)
                      for a in (x, w, b, g))
        vjp = jax_point("f32")[1]
        gj = vjp(_jax_in(g, "f32"))
    else:
        gj = vjp(_jax_in(g, dtype))
    # the JAX side done before the port's runs: XLA's thread pool and
    # PyTorch's never compute at once here
    yj, gj = jax.block_until_ready((yj, gj))
    ts = [_torch_in(a, dtype) for a in (x, w, b)]
    yp = variants.get("conv_stem", name).apply(*ts, (s, s), pad, act,
                                               **kw)
    gp = torch.autograd.grad(yp, ts, _torch_in(g, dtype, False))
    assert yp.dtype == (torch.bfloat16 if dtype == "bf16" else torch.float32)
    _close(_np(yp), _np(yj), dtype, f"{name} y")
    for nm, a, e in zip(("dx", "dw", "db"), gp, gj):
        _close(_np(a), _np(e), dtype, f"{name} {nm}")


#: the JAX contract's 7x7 and a ceil-mode edge window at 8x8
POOL_SHAPES = ((2, 7, 7, 6), (2, 8, 8, 6))


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("use_abs", [False, True])
@pytest.mark.parametrize("shape", POOL_SHAPES)
@pytest.mark.parametrize("name", [
    "gen[algo=reduce_window,fold=linear]", "gen[algo=reduce_window,fold=tree]",
    "gen[algo=slices,fold=linear]", "gen[algo=slices,fold=tree]"])
def test_maxpool_point_equals_the_jax_point(name, shape, use_abs, dtype):
    rs = np.random.RandomState(sum(shape))
    x = rs.randn(*shape).astype(np.float32)
    jf = jvariants.get("maxpool", name).apply
    yj, vjp = jax.vjp(lambda a: jf(a, (3, 3), (2, 2), use_abs),
                      _jax_in(x, dtype))
    g = rs.randn(*yj.shape).astype(np.float32)
    (gj,) = vjp(_jax_in(g, dtype))
    yj, gj = jax.block_until_ready((yj, gj))
    xt = _torch_in(x, dtype)
    yp = variants.get("maxpool", name).apply(xt, (3, 3), (2, 2), use_abs)
    (gp,) = torch.autograd.grad(yp, [xt], _torch_in(g, dtype, False))
    np.testing.assert_array_equal(_np(yp), _np(yj))
    _close(_np(gp), _np(gj), dtype, f"{name} dx")


# ---------------------------------------------------------------------------
# 3. the kernel points: their contracts, and the JAX points they match
# ---------------------------------------------------------------------------

KERNEL_POINTS = [(op, t.name(c)) for op in ("lrn", "lrn_maxpool",
                                            "sgd_update", "flash_attn")
                 for t in templates.templates_for(op) for c in t.configs()]


@pytest.mark.parametrize("op,name", KERNEL_POINTS,
                         ids=[f"{o}/{n}" for o, n in KERNEL_POINTS])
def test_kernel_point_passes_its_contract(op, name):
    rec = templates.check_equivalence(op, name, device="cpu")
    assert rec["status"] == "pass", rec
    assert templates.passed(op, name)


def _lrn_pair(dtype, io, shape=(2, 5, 7, 40), seed=3):
    rs = np.random.RandomState(seed)
    x = np.maximum(rs.randn(*shape), 0).astype(np.float32)
    g = rs.randn(*shape).astype(np.float32)
    return x, g


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("io", ["native", "f32"])
@pytest.mark.parametrize("tile", [1536, 12288])
def test_lrn_point_matches_the_jax_point(tile, io, dtype):
    """`cuda[tile=T,io=io]` (the plain route here) against the JAX
    `pallas[rt=..,io=io]` in interpret mode: io=f32 under bf16 casts
    around the f32 instance, as `lrn_pallas(io_dtype="f32")` does."""
    x, g = _lrn_pair(dtype, io)
    kw = dict(k=2.0, alpha=1e-4, beta=0.75, n=5)
    with jvariants.pallas_interpret():
        jf = jvariants.get("lrn", f"pallas[rt=64,io={io}]").apply
        yj, vjp = jax.vjp(lambda a: jf(a, **kw), _jax_in(x, dtype))
        (gj,) = vjp(_jax_in(g, dtype))
        yj, gj = jax.block_until_ready((yj, gj))
    xt = _torch_in(x, dtype)
    yp = variants.get("lrn", f"cuda[tile={tile},io={io}]").apply(xt, **kw)
    (gp,) = torch.autograd.grad(yp, [xt], _torch_in(g, dtype, False))
    assert yp.dtype == xt.dtype
    _cmp_kernel(yp, yj, dtype, "y")
    _cmp_kernel(gp, gj, dtype, "dx")


def _cmp_kernel(got, want, dtype, what):
    if dtype == "f32":
        np.testing.assert_allclose(_np(got), _np(want), err_msg=what,
                                   **F32_TOL)
    else:
        want = _np(want)
        np.testing.assert_allclose(_np(got), want, rtol=BF16_REL,
                                   atol=BF16_REL * float(np.abs(want).max()),
                                   err_msg=what)


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("io,fuse", [("native", 1), ("f32", 1),
                                     ("native", 0), ("f32", 0)])
def test_lrn_maxpool_point_matches_the_jax_point(io, fuse, dtype):
    rs = np.random.RandomState(21)
    x = rs.randn(2, 9, 9, 16).astype(np.float32)
    kw = dict(k=2.0, alpha=1e-4, beta=0.75, n=5, ksize=(3, 3),
              stride=(2, 2))
    with jvariants.pallas_interpret():
        jf = jvariants.get("lrn_maxpool",
                           f"fused[rt=2,io={io},fuse={fuse}]").apply
        yj, vjp = jax.vjp(lambda a: jf(a, **kw), _jax_in(x, dtype))
        g = rs.randn(*yj.shape).astype(np.float32)
        (gj,) = vjp(_jax_in(g, dtype))
        yj, gj = jax.block_until_ready((yj, gj))
    xt = _torch_in(x, dtype)
    yp = variants.get("lrn_maxpool",
                      f"fused[rb=2,cb=8,io={io},fuse={fuse}]").apply(xt, **kw)
    (gp,) = torch.autograd.grad(yp, [xt], _torch_in(g, dtype, False))
    _cmp_kernel(yp, yj, dtype, "y")
    if fuse or dtype == "f32":
        _cmp_kernel(gp, gj, dtype, "dx")


@pytest.mark.parametrize("kv_order", ["fwd", "rev"])
@pytest.mark.parametrize("drop", [0, 1])
def test_flash_point_matches_the_jax_point(kv_order, drop):
    rs = np.random.RandomState(7)
    b, s, h, d = 1, 256, 2, 8
    q, k, v, w = (rs.randn(b, s, h, d).astype(np.float32) for _ in range(4))
    mask = (rs.random_sample((b, s, h, d)) < 0.6).astype(np.float32) / 0.6
    jname = f"pallas[blk_q=128,blk_k=128,kv_order={kv_order},drop={drop}]"
    with jvariants.pallas_interpret():
        jf = jvariants.get("flash_attn", jname).apply
        kw = {"drop_mask": jnp.asarray(mask)} if drop else {}
        yj, gj = jax.value_and_grad(
            lambda *a: jnp.sum(jf(*a, causal=True, **kw) * w),
            argnums=(0, 1, 2))(*(jnp.asarray(a) for a in (q, k, v)))
        yj, gj = jax.block_until_ready((yj, gj))
    ts = [torch.tensor(a, requires_grad=True) for a in (q, k, v)]
    pf = variants.get("flash_attn",
                      f"cuda[blk_q=64,blk_k=64,kv_order={kv_order},"
                      f"drop={drop}]").apply
    kw = {"drop_mask": torch.tensor(mask)} if drop else {}
    yp = (pf(*ts, causal=True, **kw) * torch.tensor(w)).sum()
    gp = torch.autograd.grad(yp, ts)
    np.testing.assert_allclose(float(yp.detach()), float(yj), rtol=2e-4)
    for nm, a, e in zip("qkv", gp, gj):
        np.testing.assert_allclose(_np(a), np.asarray(e), rtol=5e-4,
                                   atol=5e-5, err_msg=nm)


@pytest.mark.parametrize("threads", [128, 256, 512, 1024])
def test_sgd_point_matches_the_jax_point(threads):
    from veles_tpu.ops import optim as joptim
    from veles_tpu_torch.ops import optim
    rs = np.random.RandomState(11)
    shapes = {"weights": (33, 17), "bias": (17,)}
    p, g, v = ({k: rs.randn(*s).astype(np.float32)
                for k, s in shapes.items()} for _ in range(3))
    with jvariants.pallas_interpret():
        jp, jv = jvariants.get("sgd_update", "pallas_rows[rt=8]").apply(
            {k: jnp.asarray(a) for k, a in p.items()},
            {k: jnp.asarray(a) for k, a in g.items()},
            {k: jnp.asarray(a) for k, a in v.items()},
            joptim.SGDConfig(lr=0.05, momentum=0.9, weight_decay=1e-3),
            lr_scale=0.5)
    pt, gt, vt = ({k: torch.tensor(a) for k, a in d.items()}
                  for d in (p, g, v))
    variants.get("sgd_update", f"cuda_rows[threads={threads}]").apply(
        pt, gt, vt, optim.SGDConfig(lr=0.05, momentum=0.9,
                                    weight_decay=1e-3), 0.5)
    for k in shapes:
        np.testing.assert_allclose(pt[k].numpy(), np.asarray(jp[k]),
                                   rtol=1e-6, atol=1e-7, err_msg=k)
        np.testing.assert_allclose(vt[k].numpy(), np.asarray(jv[k]),
                                   rtol=1e-6, atol=1e-7, err_msg=k)


# ---------------------------------------------------------------------------
# 4. the shared-memory ledger
# ---------------------------------------------------------------------------


def test_flash_footprints_are_the_kernels_and_d128_does_not_fit():
    """K6's 135,168 B and K7's 200,704 B at D = 64 (PERF.md); at D = 128
    the forward alone needs 266,240 B, above an H100's 227 KB."""
    assert kernels.flash_attention_forward_smem_bytes(64) == 135168
    assert kernels.flash_attention_backward_smem_bytes(64) == 200704
    name = "cuda[blk_q=64,blk_k=64,kv_order=fwd,drop=0]"
    assert resources.kernel_footprint("flash_attn", name,
                                      shapes={"d": 64}) == 200704
    assert resources.kernel_footprint("flash_attn", name,
                                      shapes={"d": 128}) > 227 * 1024
    ver = resources.kernel_verdict("flash_attn", name, shapes={"d": 128},
                                   budget=227 * 1024)
    assert ver["footprint"] == 266240 + 131072
    assert resources.kernel_verdict("flash_attn", name, shapes={"d": 64},
                                    budget=227 * 1024) is None


def test_kernel_plan_refusals_and_aliases():
    """A band the plan shrinks aliases by bench_key; a plan's refusal is
    infeasible whatever the budget (none on the CPU)."""
    (t,) = templates.templates_for("lrn_maxpool")
    shapes = {"inputs": [[55, 55, 96]]}
    key = lambda **c: t.bench_key({**t.seed, **c}, shapes, "bfloat16")  # noqa
    assert key(rb=4, cb=32) == key(rb=3, cb=32) == key(rb=2, cb=32)
    assert key(rb=1, cb=8) != key(rb=2, cb=8)
    assert key(fuse=0, rb=1) == key(fuse=0, rb=4) == ("composed",)
    assert key(io="f32") != key(io="native")
    assert t.bench_key({**t.seed, "io": "f32"}, shapes, None) \
        == t.bench_key(t.seed, shapes, None)          # f32 step: one kernel
    (lt,) = templates.templates_for("lrn")
    lk = lambda tile: lt.bench_key({"tile": tile, "io": "native"},  # noqa
                                   {"c": [96, 256]}, "bfloat16")
    assert lk(6144) != lk(12288)          # K2 differs at C 96
    assert resources.smem_budget("cpu") is None
    assert resources.kernel_verdict(
        "lrn", "cuda[tile=12288,io=native]", {"c": [96, 256]}) is None
    ver = resources.kernel_verdict(
        "lrn", "cuda[tile=1536,io=native]", {"c": [96, 256]},
        budget=10000)
    assert ver["footprint"] == 19200


def test_smem_budget_override_and_env(monkeypatch):
    monkeypatch.setenv(resources.SMEM_BUDGET_ENV, "1234")
    assert resources.smem_budget("cpu") == 1234
    assert resources.smem_budget("cpu", override=99) == 99
    monkeypatch.setenv(resources.SMEM_BUDGET_ENV, "many")
    assert resources.smem_budget("cpu") is None


def test_kernel_findings_name_an_infeasible_selection():
    variants.select("flash_attn", "cuda[blk_q=64,blk_k=64,kv_order=rev,"
                                  "drop=0]")
    sigs = {"flash_attn": [{"sample_shape": [4096, 256], "heads": 2,
                            "head_dim": 128, "causal": True}]}
    found = resources.kernel_findings(sigs, device="cpu", budget=232448)
    assert [f.rule for f in found] == ["smem-over-budget"]
    assert "flash_attn/cuda[" in found[0].unit
    sigs["flash_attn"][0]["head_dim"] = 64
    assert resources.kernel_findings(sigs, device="cpu",
                                     budget=232448) == []


# ---------------------------------------------------------------------------
# 5. the gates
# ---------------------------------------------------------------------------


def test_failing_contract_means_never_timed(tmp_path, monkeypatch):
    def bad_contract(apply, device):
        raise AssertionError("injected mismatch")

    def tripwire(*a, **k):
        raise AssertionError("timed an ungated candidate")
    monkeypatch.setitem(templates.CONTRACTS, "sgd_update", bad_contract)
    monkeypatch.setitem(templates.BENCHES, "sgd_update", tripwire)
    templates.clear_ledger()
    rep = at.search_op("sgd_update", budget=6, cache=_cache(tmp_path),
                       device="cpu")
    assert rep["source"] == "error"
    assert rep["trials"] == 6
    assert all(t["outcome"] in ("equiv_fail", "alias")
               for t in rep["trace"])
    assert rep["outcomes"]["equiv_fail"] == 6


def test_ledger_bypass_raises_ungated_error(tmp_path, monkeypatch):
    monkeypatch.setattr(templates, "check_equivalence",
                        lambda op, name, force=False, device=None:
                        {"status": "pass"})
    templates.clear_ledger()
    for op in ("sgd_update", "lrn_maxpool"):
        with pytest.raises(templates.UngatedCandidateError):
            at.search_op(op, budget=4, cache=_cache(tmp_path),
                         device="cpu")
    with pytest.raises(templates.UngatedCandidateError):
        templates.bench_candidate("lrn", "kernel", device="cpu")


def test_over_budget_points_are_pruned_and_never_timed(tmp_path):
    """Flash at D = 128 under a 227 KB budget: every generated point is
    pruned without a trial; the hand-written incumbents (no footprint
    rule) are timed."""
    templates.clear_ledger()
    rep = at.search_op("flash_attn", budget=6, cache=_cache(tmp_path),
                       smem_shapes={"d": 128}, smem_budget=227 * 1024,
                       device="cpu")
    t = templates.templates_for("flash_attn")[0]
    assert rep["pruned"] == sorted(t.name(c) for c in t.configs())
    timed = [r["variant"] for r in rep["trace"] if r["outcome"] == "timed"]
    assert sorted(timed) == ["kernel", "mha"]
    assert rep["trials"] == 2
    assert all(r["smem_budget"] == 227 * 1024 for r in rep["trace"]
               if r["outcome"] == "pruned")


def test_bypassed_pruning_raises_infeasible_error(tmp_path, monkeypatch):
    monkeypatch.setattr(at, "_prune_verdict", lambda *a, **k: None)
    templates.clear_ledger()
    with pytest.raises(resources.InfeasibleCandidateError):
        at.search_op("flash_attn", budget=6, cache=_cache(tmp_path),
                     smem_shapes={"d": 128}, smem_budget=227 * 1024,
                     device="cpu")


def test_every_timed_trial_was_gated_first(tmp_path):
    templates.clear_ledger()
    rep = at.search_workflow(budget=14, ops=["lrn", "flash_attn",
                                              "sgd_update", "lrn_maxpool"],
                             cache=_cache(tmp_path), device="cpu")
    timed = 0
    for op, r in rep.items():
        for trial in r["trace"]:
            if trial["outcome"] == "timed":
                timed += 1
                assert templates.passed(op, trial["variant"]), (op, trial)
                assert r["equivalence"][trial["variant"]] == "pass"
    assert timed >= 8


def test_zero_budget_and_empty_op_list_search_nothing(tmp_path, monkeypatch):
    def tripwire(*a, **k):
        raise AssertionError("searched with nothing to search")
    monkeypatch.setattr(templates, "check_equivalence", tripwire)
    before = dict(at.TIMINGS)
    assert at.search_workflow(budget=10, ops=[], cache=_cache(tmp_path),
                              device="cpu") == {}
    rep = at.search_op("lrn", budget=0, cache=_cache(tmp_path),
                       device="cpu")
    assert rep["source"] == "skipped" and rep["trials"] == 0
    assert at.TIMINGS == before


def test_search_times_each_round_in_turns_beside_the_leader(tmp_path):
    """The search hands the in-graph timer one round at a time: the new
    points with the leader so far (and the axis' current point), so a
    point is only ever compared with times taken in its own round; the
    round's fastest leads, and the last leader wins."""
    fast = {"cuda[tile=1536,io=native]": 0.5, "banded_matmul": 0.8}
    rounds = []

    def timer(names):
        rounds.append(list(names))
        return {n: fast.get(n, 1.0) for n in names}
    templates.clear_ledger()
    rep = at.search_op("lrn", budget=8, cache=_cache(tmp_path),
                       in_graph_timer=timer, device="cpu")
    # 3 hand-written, the seed and 3 tiles; in f32 io=f32 aliases native
    assert rep["source"] == "searched" and rep["trials"] == 7
    assert sorted(rep["aliases"]) == sorted(
        f"cuda[tile={t},io=f32]" for t in (1536, 3072, 6144, 12288))
    assert rep["variant"] == "cuda[tile=1536,io=native]"
    assert rounds[0] == [v.name for v in variants.variants_for("lrn")]
    for before, now in zip(rounds, rounds[1:]):
        leader = min(before, key=lambda n: fast.get(n, 1.0))
        assert now[0] == leader
    assert rounds[2][:2] == ["banded_matmul", "cuda[tile=3072,io=native]"]
    assert rep["rounds"] == [{n: fast.get(n, 1.0) for n in r}
                             for r in rounds]
    timed = [t["variant"] for t in rep["trace"] if t["outcome"] == "timed"]
    assert sorted(timed) == sorted({n for r in rounds for n in r})


def test_search_caches_and_a_rerun_times_nothing(tmp_path, monkeypatch):
    templates.clear_ledger()
    cache = _cache(tmp_path)
    rep = at.search_op("sgd_update", budget=7, cache=cache, device="cpu")
    assert rep["source"] == "searched"
    assert rep["trials"] <= 7
    assert rep["variant"] in rep["timings_s"]
    monkeypatch.setitem(templates.BENCHES, "sgd_update",
                        lambda *a: pytest.fail("timed on a cache hit"))
    again = at.search_op("sgd_update", budget=7,
                         cache=at.AutotuneCache(cache.path), device="cpu")
    assert again["source"] == "cache"
    assert again["variant"] == rep["variant"]
