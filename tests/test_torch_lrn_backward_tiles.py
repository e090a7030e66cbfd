"""K3's CUDA source (`veles_tpu_torch/csrc/lrn_backward.cu`) run on the
CPU, held bit for bit against the plain version
`ops/functional.py:lrn_backward` (which `test_torch_backward_kernels.py`
holds against the JAX package's Pallas kernel and the golden).

The .cu file is compiled by g++ with the emulation of
`test_torch_lrn_pool_tiles.py` (one std::thread per CUDA thread, a
std::barrier for `__syncthreads`, the 4- and 16-byte cp.async copies as
plain copies) and called through the wrapper `kernels.lrn_backward`, so
the argument order of the C entry point is the wrapper's. The plain
version runs with a correctly rounded sqrt, as on the card and in g++.

Besides the build as written, a "narrow" build cuts K3's tile to 16
elements: rows wider than 16 channels are then cut into channel tiles
whose halo of t is recomputed, and narrow rows fill tiles of several
rows. Cases: AlexNet's C = 96 and 256 at a few rows, row counts that
leave a ragged last tile, C = 3, 40 and 70 (4-byte copies where
C % 4 != 0), LRN n = 3, an all-zero x, NaNs in x, an x that is not
16-byte aligned (4-byte copies at C = 96), and AlexNet's geometry
through the generic instance. It cannot see nvcc errors, register
pressure or speed: chip_smoke.py holds the kernel on the card.
"""

import ctypes

import numpy as np
import pytest
import torch

from tests.test_torch_lrn_pool_tiles import (ALPHA, BETA, K, bf16_at,
                                             compile_source, emulated_source,
                                             entry_in, find_gxx, load_entry,
                                             sub, wait_built, wrapper_on)
from veles_tpu_torch.ops import functional as fn
from veles_tpu_torch.ops import kernels

SOURCE = kernels.CSRC / "lrn_backward.cu"

#: build -> substitutions in the kernel's constants
BUILDS = {"as written": {},
          "narrow": {"kTile = 3072;": "kTile = 16;"}}

#: (what, x shape, LRN n, input)
SHAPES = (("AlexNet L1 C 96, one whole tile", (1, 3, 7, 96), 5, "relu"),
          ("AlexNet L1 C 96, ragged last tile", (1, 5, 9, 96), 5, "relu"),
          ("AlexNet L2 C 256, ragged last tile", (1, 3, 5, 256), 5, "relu"),
          ("C 3", (2, 14, 16, 3), 5, "relu"),
          ("C 40", (2, 5, 7, 40), 5, "relu"),
          ("C 70", (2, 5, 7, 70), 5, "relu"),
          ("LRN n 3", (2, 5, 7, 40), 3, "relu"),
          ("all zero", (2, 5, 7, 40), 5, "zero"),
          ("NaN in x", (2, 5, 7, 40), 5, "nan"),
          ("x not 16-byte aligned, C 96", (1, 5, 9, 96), 5, "misaligned"))


@pytest.fixture(scope="module")
def emulated_libs(tmp_path_factory):
    """build name -> K3's source compiled by g++ (the library), all
    builds compiled at once."""
    gxx = find_gxx()
    out = tmp_path_factory.mktemp("k3_emulation")
    started = {name: compile_source(gxx, emulated_source(SOURCE, consts, 1),
                                    out / f"{name.replace(' ', '_')}.so")
               for name, consts in BUILDS.items()}
    return {name: wait_built(*job) for name, job in started.items()}


@pytest.fixture(scope="module")
def emulated(emulated_libs):
    """build name -> the C entry point of K3's f32 instance."""
    return {name: entry_in(lib, "lrn_backward")
            for name, lib in emulated_libs.items()}


@pytest.fixture(scope="module")
def emulated_bf16(emulated_libs):
    """build name -> the C entry point of K3's bf16 instance."""
    return {name: entry_in(lib, "lrn_backward_bf16")
            for name, lib in emulated_libs.items()}


def _inputs(shape, kind, seed=3):
    rs = np.random.RandomState(seed)
    x = np.maximum(rs.randn(*shape), 0).astype(np.float32)
    if kind == "zero":
        x[:] = 0.0
    elif kind == "nan":
        x[0, 1, 2, 0] = x[1, 4, 6, 39] = x[1, 2, 3, 17] = np.nan
    g = torch.from_numpy(rs.randn(*shape).astype(np.float32))
    if kind == "misaligned":
        # one float into a fresh buffer: contiguous, 4 bytes past 16
        buf = torch.empty(x.size + 1, dtype=torch.float32)
        xt = buf[1:].view(shape)
        xt.copy_(torch.from_numpy(x))
        assert xt.data_ptr() % 16 != 0
        return xt, g
    return torch.from_numpy(x), g


def _run(entry, monkeypatch, shape, n, kind, generic=False, bf16_offset=None,
         tile=0):
    """(K3's source through the wrapper, the plain version) on one
    input; in bf16 (x `bf16_offset` elements into its buffer) unless
    None; `tile`: the launch's own elements of a tile (0: the source's)."""
    x, g = _inputs(shape, kind)
    if bf16_offset is not None:
        x, g = bf16_at(x, bf16_offset), g.to(torch.bfloat16)
    sqrt = torch.sqrt
    with monkeypatch.context() as m:
        m.setattr(torch, "sqrt", lambda t: sqrt(t.double()).to(t.dtype))
        want = fn.lrn_backward(x, g, K, ALPHA, BETA, n)
    with wrapper_on(entry, monkeypatch):
        got = kernels.lrn_backward(x, g, K, ALPHA, BETA, n, generic=generic,
                                   tile=tile)
    return got, want


def _assert_bit_equal(got, want):
    """The same bits everywhere, NaN where the plain version has NaN;
    returns the count of NaN."""
    nan = want.isnan()
    assert torch.equal(got.isnan(), nan)
    assert torch.equal(got.masked_fill(nan, 0.0), want.masked_fill(nan, 0.0))
    return int(nan.sum())


@pytest.mark.parametrize("build", list(BUILDS))
@pytest.mark.parametrize("what,shape,n,kind", SHAPES,
                         ids=[s[0] for s in SHAPES])
def test_k3_source_is_bit_equal_to_the_plain_version(emulated, monkeypatch,
                                                     build, what, shape, n,
                                                     kind):
    nans = _assert_bit_equal(*_run(emulated[build], monkeypatch, shape, n,
                                   kind))
    assert (nans > 0) == (kind == "nan")


@pytest.mark.parametrize("build", list(BUILDS))
def test_k3_generic_instance_at_alexnets_geometry(emulated, monkeypatch,
                                                  build):
    """The run-time instance, asked for at AlexNet's geometry (which the
    compile-time one takes otherwise), gives the plain version's bits and
    the compile-time instance's."""
    generic, want = _run(emulated[build], monkeypatch, (1, 5, 9, 96), 5,
                         "relu", generic=True)
    fixed, _ = _run(emulated[build], monkeypatch, (1, 5, 9, 96), 5, "relu")
    _assert_bit_equal(generic, want)
    assert torch.equal(generic, fixed)


#: K3's bf16 instance: (what, x shape, input, x's offset in elements from
#: 16-byte alignment); 8-byte copies where C % 4 == 0 and x is 8-byte
#: aligned, else 2-byte ones
BF16_SHAPES = (("C 96, ragged last tile", (1, 5, 9, 96), "relu", 0),
               ("C 256, ragged last tile", (1, 3, 5, 256), "relu", 0),
               ("C 3", (2, 14, 16, 3), "relu", 0),
               ("C 70", (2, 5, 7, 70), "relu", 0),
               ("NaN in x", (2, 5, 7, 40), "nan", 0),
               ("x 8 bytes off 16-byte alignment, C 96", (1, 5, 9, 96),
                "relu", 4),
               ("x 2 bytes off alignment, C 96", (1, 5, 9, 96), "relu", 1))


@pytest.mark.parametrize("build", list(BUILDS))
@pytest.mark.parametrize("what,shape,kind,offset", BF16_SHAPES,
                         ids=[s[0] for s in BF16_SHAPES])
def test_k3_bf16_source_is_bit_equal_to_the_plain_version(
        emulated_bf16, monkeypatch, build, what, shape, kind, offset):
    """The bf16 instance (bf16 x, g and dx; staged as f32, dx rounded
    once) gives the plain version's bits."""
    got, want = _run(emulated_bf16[build], monkeypatch, shape, 5, kind,
                     bf16_offset=offset)
    assert got.dtype == torch.bfloat16
    assert (_assert_bit_equal(got, want) > 0) == (kind == "nan")


def test_k3_bf16_generic_instance(emulated_bf16, monkeypatch):
    _assert_bit_equal(*_run(emulated_bf16["as written"], monkeypatch,
                            (1, 5, 9, 96), 5, "relu", generic=True,
                            bf16_offset=0))


def test_a_halo_left_at_zero_fails(tmp_path, monkeypatch):
    """The emulation sees the channel tiles: a narrow build whose halo of
    t is never computed (left at zero, as beyond the row's ends) is not
    bit-equal where a row is cut into tiles."""
    src = sub(emulated_source(SOURCE, BUILDS["narrow"], 1),
              "if (c0 + cc >= 0 && c0 + cc < p.C) {", "if (false) {")
    entry = load_entry(*compile_source(find_gxx(), src,
                                       tmp_path / "wrong.so"),
                       name="lrn_backward")
    with pytest.raises(AssertionError):
        _assert_bit_equal(*_run(entry, monkeypatch, (2, 5, 7, 40), 5,
                                "relu"))


#: the kernel search's K3 tiles at shapes whose last tile is ragged:
#: (what, x shape, tile)
TILE_POINTS = (("C 96 tile 1536: 16 rows a tile, last 6", (2, 9, 11, 96),
                1536),
               ("C 96 tile 6144: 40 rows a tile (48 KB), last 38",
                (2, 9, 11, 96), 6144),
               ("C 256 tile 1536: 6 rows a tile, last 5", (1, 5, 7, 256),
                1536),
               ("C 256 tile 12288: 15 rows a tile (48 KB), last 5",
                (1, 5, 7, 256), 12288))


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("what,shape,tile", TILE_POINTS,
                         ids=[t[0] for t in TILE_POINTS])
def test_k3_search_tiles_are_bit_equal(emulated, emulated_bf16, monkeypatch,
                                       dtype, what, shape, tile):
    """Each tile the kernel search can ask for, a run-time argument of
    the source, gives the plain version's bits (the last tile ragged)."""
    if dtype == "f32":
        got, want = _run(emulated["as written"], monkeypatch, shape, 5,
                         "relu", tile=tile)
    else:
        got, want = _run(emulated_bf16["as written"], monkeypatch, shape, 5,
                         "relu", bf16_offset=0, tile=tile)
    _assert_bit_equal(got, want)


#: (the smem entry's arguments C, half, tile; bytes): the source's tile
#: (0 or 3072) at AlexNet's widths, the search's, and refusals
K3_SMEM = (((96, 2, 0), 38400), ((256, 2, 0), 37440),
           ((96, 2, 3072), 38400), ((96, 2, 1536), 19200),
           ((96, 2, 12288), 48000), ((256, 2, 6144), 46800),
           ((96, 2, 10), -1), ((96, 4000, 0), -1))


@pytest.mark.parametrize("args,want", K3_SMEM)
def test_k3_smem_bytes_entry(emulated_libs, args, want):
    """lrn_backward_smem_bytes gives a block's dynamic shared memory (-1
    where refused), and the kernel search's Python mirror of the plan
    the same."""
    entry = ctypes.CDLL(str(emulated_libs["as written"])) \
        .lrn_backward_smem_bytes
    entry.argtypes = [ctypes.c_int] * 3
    entry.restype = ctypes.c_int
    assert entry(*args) == want
    assert kernels.lrn_backward_smem_bytes(*args) == want
