"""The port's kernel functions on the CPU, held against the JAX package.

K2 (`lrn_forward`) and K4 (`lrn_maxpool_forward`) are CUDA kernels that
run only on the card, where chip_smoke.py holds each against its plain
PyTorch version. Here, with no card, every wrapper takes its plain
version, and these tests hold the plain versions — through the wrappers
and the registry variants the forward path calls — against the JAX
package's Pallas kernels (interpret mode, as tests/test_pallas_kernels.py
runs them) and the numpy goldens of `veles_tpu.ops.reference`.

Tolerance: rtol 1e-4, atol 1e-5, the JAX package's own Pallas-vs-golden
tolerance — both sides compute in f32 with the same tap order and pow
decomposition, but rsqrt and the summation differ in the last bits.
"""

import numpy as np
import pytest
import torch
import torch.nn.functional as F

import veles_tpu.ops.pallas_kernels as pk
from veles_tpu.ops import reference as ref
from veles_tpu_torch.ops import functional as fn
from veles_tpu_torch.ops import kernels, variants

RTOL, ATOL = 1e-4, 1e-5
K, ALPHA, BETA, N = 2.0, 1e-4, 0.75, 5


@pytest.fixture(autouse=True)
def _interpret_mode():
    pk._FORCE_INTERPRET = True
    yield
    pk._FORCE_INTERPRET = False


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def test_lrn_forward_plain_matches_pallas_and_golden():
    x = np.random.RandomState(1).randn(2, 5, 5, 16).astype(np.float32)
    want_pallas = np.asarray(pk.lrn_forward_pallas(x, K, ALPHA, BETA, N))
    want_gold = ref.lrn_forward(x, K, ALPHA, BETA, N)
    for got in (kernels.lrn_forward(_t(x), K, ALPHA, BETA, N),
                kernels.lrn_forward_plain(_t(x), K, ALPHA, BETA, N),
                variants.get("lrn", "kernel").apply(
                    _t(x), k=K, alpha=ALPHA, beta=BETA, n=N)):
        np.testing.assert_allclose(got.numpy(), want_pallas, rtol=RTOL,
                                   atol=ATOL)
        np.testing.assert_allclose(got.numpy(), want_gold, rtol=RTOL,
                                   atol=ATOL)


@pytest.mark.parametrize("c,n,beta", [(3, 5, 0.75), (16, 3, 0.75),
                                      (16, 5, 0.6)])
def test_lrn_channel_edges_and_generic_pow(c, n, beta):
    """C below the window (every tap near an edge is zero-padded), a
    narrower window, and a beta whose s^(-beta) is not a quarter power
    (the powf path)."""
    x = 3.0 * np.random.RandomState(2).randn(2, 3, 4, c).astype(np.float32)
    got = kernels.lrn_forward(_t(x), K, 0.05, beta, n).numpy()
    np.testing.assert_allclose(got, ref.lrn_forward(x, K, 0.05, beta, n),
                               rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(
        got, np.asarray(pk.lrn_forward_pallas(x, K, 0.05, beta, n)),
        rtol=RTOL, atol=ATOL)


def test_lrn_even_window_is_refused():
    with pytest.raises(ValueError, match="odd"):
        kernels.lrn_forward(torch.zeros(1, 2, 2, 4), K, ALPHA, BETA, 4)


@pytest.mark.parametrize("hw", [8, 9])
def test_lrn_maxpool_plain_matches_fused_pallas_and_golden(hw):
    """8x8 ends in a ceil-mode edge window (the padded extent is 9); 9x9
    pools exactly — the shapes of the JAX package's own contract
    (templates.py `_lrn_pool_contract`)."""
    x = np.random.RandomState(21).randn(2, hw, hw, 16).astype(np.float32)
    want_pallas = np.asarray(pk.lrn_maxpool_pallas(
        x, K, ALPHA, BETA, N, (3, 3), (2, 2)))
    want_gold = ref.lrn_maxpool_forward(x, K, ALPHA, BETA, N, (3, 3),
                                        (2, 2))
    assert want_gold.shape[1:3] == fn.pool_out_hw(hw, hw, 3, 3, 2, 2)
    kw = dict(k=K, alpha=ALPHA, beta=BETA, n=N, ksize=(3, 3),
              stride=(2, 2))
    for got in (kernels.lrn_maxpool_forward(_t(x), K, ALPHA, BETA, N),
                kernels.lrn_maxpool_forward_plain(_t(x), K, ALPHA, BETA, N),
                variants.get("lrn_maxpool", "fused").apply(_t(x), **kw)):
        assert tuple(got.shape) == want_gold.shape
        np.testing.assert_allclose(got.numpy(), want_pallas, rtol=RTOL,
                                   atol=ATOL)
        np.testing.assert_allclose(got.numpy(), want_gold, rtol=RTOL,
                                   atol=ATOL)


def test_lrn_maxpool_nan_and_inf_follow_jax():
    """A NaN anywhere in a window makes its max NaN, as jnp.maximum does
    (fmaxf would drop it); -inf normalizes to NaN on both sides."""
    x = np.random.RandomState(3).randn(1, 9, 9, 8).astype(np.float32)
    x[0, 0, 0, 0] = np.nan
    x[0, 4, 4, 3] = -np.inf
    x[0, 8, 8, 7] = np.inf
    want = np.asarray(pk.lrn_maxpool_pallas(x, K, ALPHA, BETA, N,
                                            (3, 3), (2, 2)))
    got = kernels.lrn_maxpool_forward(_t(x), K, ALPHA, BETA, N).numpy()
    assert np.isnan(want).any()
    np.testing.assert_array_equal(np.isnan(got), np.isnan(want))
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL,
                               equal_nan=True)


@pytest.mark.parametrize("hw", [2, 3, 4, 7, 8, 9, 13])
def test_maxpool_ceil_geometry_matches_golden(hw):
    """The plain pool's geometry is the JAX package's, including inputs
    no larger than the window (one output) and truncated edge windows."""
    x = np.random.RandomState(hw).randn(2, hw, hw + 1, 4).astype(np.float32)
    got = fn.maxpool_forward(_t(x), (3, 3), (2, 2)).numpy()
    want, _ = ref.maxpool_forward(x, (3, 3), (2, 2))
    assert got.shape == want.shape
    np.testing.assert_array_equal(got, want)
    if hw > 3:
        # where the input exceeds the window, PyTorch's own ceil mode
        # gives the same extent
        ceil = F.max_pool2d(_t(x).permute(0, 3, 1, 2), 3, 2,
                            ceil_mode=True)
        assert tuple(ceil.shape[2:]) == got.shape[1:3]


def test_cpu_path_counts_no_launch_and_other_devices_raise():
    kernels.reset_launch_counts()
    x = torch.randn(1, 9, 9, 8)
    kernels.lrn_forward(x)
    kernels.lrn_maxpool_forward(x)
    kernels.lrn_backward(x, torch.randn(1, 9, 9, 8))
    kernels.lrn_maxpool_backward(x, torch.randn(1, 4, 4, 8))
    p, v = torch.randn(5), torch.zeros(5)
    kernels.sgd_update(p, torch.randn(5), v, 0.1, 0.9, 1e-3)
    q = torch.randn(2, 8, 8)
    _, lse = kernels.flash_attention_forward(q, q, q, causal=True)
    kernels.flash_attention_backward(q, q, q, q, lse, lse, causal=True)
    assert kernels.launch_counts() == {name: 0
                                       for name in kernels.INSTANCES}
    assert set(kernels.KERNELS) == {"sgd_update", "lrn_forward",
                                    "lrn_backward", "lrn_maxpool_forward",
                                    "lrn_maxpool_backward",
                                    "flash_attention_forward",
                                    "flash_attention_backward"}
    meta = torch.empty(1, 9, 9, 8, device="meta")
    for call in (lambda: kernels.lrn_forward(meta),
                 lambda: kernels.lrn_maxpool_forward(meta),
                 lambda: kernels.lrn_backward(meta, meta),
                 lambda: kernels.lrn_maxpool_backward(meta, meta),
                 lambda: kernels.sgd_update(meta, meta, meta, 0.1)):
        with pytest.raises(ValueError, match="cuda or cpu"):
            call()


def test_registry_resolution_and_device_gating():
    """Every registry entry selects a path that runs; no entry depends on
    the device (a wrapper takes its plain version on a CPU tensor by
    itself), and `lrn_maxpool/composed` claims no pair (its `apply`, the
    LRN then the pool, is the kernel search's contract and bench). The
    hand-written variants: generated points (ops/templates.py) are kept
    apart."""
    assert {op: sorted(spec.variants) for op, spec in variants._OPS.items()} \
        == {"lrn": ["banded_matmul", "cached_residual", "kernel"],
            "maxpool": ["reduce_window", "slices"],
            "lrn_maxpool": ["composed", "fused"],
            "sgd_update": ["kernel", "tree"],
            "flash_attn": ["kernel", "mha"],
            "conv_stem": ["direct", "s2d"],
            "serve_forward": ["bf16", "f32", "int8"],
            "grad_reduce": ["bf16", "f32", "hier2", "int8_block",
                            "int8_ef"]}
    with pytest.raises(KeyError):
        variants.get("lrn", "plain")
    composed = variants.get("lrn_maxpool", "composed")
    assert composed.apply is not None and not composed.fused
    assert variants.get("lrn_maxpool", "fused").fused
    prev = {op: variants.selected(op)
            for op in ("lrn", "lrn_maxpool", "sgd_update")}
    try:
        variants.select("lrn_maxpool", "composed")
        assert variants.resolve("lrn_maxpool").name == "composed"

        class Unit:
            variant_override = "tree"
        assert variants.resolve("sgd_update").name == "kernel"
        assert variants.resolve("sgd_update", unit=Unit()).name == "tree"
        variants.select("sgd_update", "tree")
        assert variants.resolve("sgd_update").name == "tree"
        with pytest.raises(KeyError):
            variants.select("lrn_maxpool", "pallas_one_pass")
        with pytest.raises(KeyError):
            variants.select("lrn", "plain")
    finally:
        for op, name in prev.items():
            if name is None:
                variants.clear_selection(op)
            else:
                variants.select(op, name)
    assert variants.resolve("lrn_maxpool").name == "fused"   # default
    assert variants.resolve("sgd_update").name == "kernel"   # default


def test_kernel_argument_checks():
    with pytest.raises(TypeError, match="float32"):
        kernels._check_lrn_args(torch.zeros(1, 2, 2, 4,
                                            dtype=torch.float64), 5, 4)
    with pytest.raises(ValueError, match="contiguous"):
        kernels._check_lrn_args(torch.zeros(1, 4, 2, 2).permute(0, 2, 3, 1),
                                5, 4)
    with pytest.raises(ValueError, match="4-d"):
        kernels._check_lrn_args(torch.zeros(4, 4), 5, 4)
    with pytest.raises(ValueError, match="odd"):
        kernels._check_lrn_args(torch.zeros(1, 2, 2, 4), 4, 4)
    # a tensor that requires grad is taken: the kernels' gradients come
    # through LRNFunction / LRNMaxPoolFunction
    kernels._check_lrn_args(torch.zeros(1, 2, 2, 4, requires_grad=True), 5,
                            4)
    x = torch.zeros(1, 2, 2, 4)
    with pytest.raises(TypeError, match="float32"):
        kernels._check_like("g", x.double(), x.shape, x)
    with pytest.raises(ValueError, match="shape"):
        kernels._check_like("g", x[:, :1], x.shape, x)
    g = kernels._check_like("g", torch.zeros(1, 4, 2, 2).permute(0, 2, 3, 1),
                            x.shape, x)
    assert g.is_contiguous()
    with pytest.raises(ValueError, match="geometry"):
        kernels._pool_geometry((3, 0), (2, 2))


def test_cpu_sqrt_is_correctly_rounded():
    """`functional.sqrt` on the CPU (the plain LRN's s^(-1/4) =
    sqrt(rsqrt(s)), the log activation's backward, Adam's step) gives
    numpy's correctly rounded f32 sqrt bit for bit, as CUDA's sqrt does
    on the card; ATen's own CPU sqrt (MKL VML) is an ulp off for about
    one value in eight."""
    rs = np.random.RandomState(0)
    a = np.concatenate([(rs.rand(200_000) * 10 + 1e-3),
                        [0.0, 1.0, 4.0, np.inf]]).astype(np.float32)
    got = fn.sqrt(torch.from_numpy(a)).numpy()
    assert got.dtype == np.float32
    np.testing.assert_array_equal(got, np.sqrt(a))
    # s^(-3/4) as the kernels build it: t = sqrt(rsqrt(s)), t * (t * t)
    s = a[:-4] + np.float32(2.0)
    t = np.sqrt(np.float32(1) / np.sqrt(s))
    np.testing.assert_array_equal(
        fn.pow_neg_quarters(torch.from_numpy(s), 0.75).numpy(), t * (t * t))
