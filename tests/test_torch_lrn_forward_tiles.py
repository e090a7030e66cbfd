"""The CUDA sources of the forward LRN kernels run on the CPU, held bit
for bit against their plain versions: K4
(`veles_tpu_torch/csrc/lrn_maxpool_forward.cu`) against
`kernels.lrn_maxpool_forward_plain` and K2
(`veles_tpu_torch/csrc/lrn_forward.cu`) against
`kernels.lrn_forward_plain`, which `test_torch_kernels.py` holds against
the JAX package's Pallas kernels in interpret mode.

Each .cu file is compiled by g++ with the emulation of
`test_torch_lrn_pool_tiles.py` (one std::thread per CUDA thread, a
std::barrier for `__syncthreads` and one per warp for `__syncwarp`, the
4- and 16-byte cp.async copies as plain copies, csrc/'s headers inlined)
and called through the wrapper, so the argument order of each C entry
point is the wrapper's. The plain versions run with a correctly rounded
sqrt, as on the card and in g++.

Besides the builds as written, a "narrow" K4 build shrinks its shared
memory to 3 KB and its grid to one sample, so that bands shrink to one
pooled row and part of the width and blocks loop over the samples, and a
"narrow" K2 build cuts its tile to 16 elements, so that rows wider than
16 channels are cut into channel tiles whose halo is read from x.
Shapes: chip_smoke.py's K4 and K2 small checks (ragged edges and tiles,
C = 3, 40 and 70, all-zero and NaN inputs, 3x3/1 and 2x2/2 windows, a
2x2/3 pool whose last window lies wholly past the edge, rows cut into
channel tiles), AlexNet's two LRN widths at batch 1, LRN n = 3, an x 4
bytes off 16-byte alignment, and AlexNet's geometry through the generic
instance. A build that leaves the channel halo unstaged must fail. The
emulation cannot see nvcc errors, register pressure or speed:
chip_smoke.py holds the kernels on the card.
"""

import ctypes

import numpy as np
import pytest
import torch

from tests.test_torch_lrn_pool_tiles import (ALPHA, BETA, K, bf16_at,
                                             compile_source, emulated_source,
                                             entry_in, find_gxx, load_entry,
                                             wrapper_on)
from veles_tpu_torch.ops import functional as fn
from veles_tpu_torch.ops import kernels

#: kernel -> its source and its builds (name -> substitutions in the
#: kernel's constants)
SOURCES = {"lrn_maxpool_forward": kernels.CSRC / "lrn_maxpool_forward.cu",
           "lrn_forward": kernels.CSRC / "lrn_forward.cu"}
BUILDS = {"lrn_maxpool_forward": {
              "as written": {},
              "narrow": {"kSmemMax = 48 * 1024": "kSmemMax = 3 * 1024",
                         "kMaxGridY = 65535": "kMaxGridY = 1"}},
          "lrn_forward": {"as written": {},
                          "narrow": {"kTile = 3072;": "kTile = 16;"}}}
#: the channel halo left unstaged (zeros where x's neighbours belong)
UNSTAGED_HALO = {
    "const bool in = c0 + cc >= 0 && c0 + cc < p.C;":
        "const bool in = cc >= 0 && cc < kCT && c0 + cc < p.C;"}

#: K4: (what, x shape, window, stride, LRN n, input)
K4_SHAPES = (("clipped both axes, C 40", (2, 14, 16, 40), (3, 3), (2, 2), 5,
              "relu"),
             ("C 3", (2, 14, 16, 3), (3, 3), (2, 2), 5, "relu"),
             ("C 70", (2, 9, 11, 70), (3, 3), (2, 2), 5, "relu"),
             ("all zero", (2, 14, 16, 40), (3, 3), (2, 2), 5, "zero"),
             ("NaN windows", (2, 14, 16, 40), (3, 3), (2, 2), 5, "nan"),
             ("3x3 stride 1", (2, 13, 15, 40), (3, 3), (1, 1), 5, "relu"),
             ("2x2 stride 2", (2, 13, 15, 40), (2, 2), (2, 2), 5, "relu"),
             ("empty last window, 2x2 stride 3", (2, 12, 12, 40), (2, 2),
              (3, 3), 5, "relu"),
             ("LRN n 3", (2, 14, 16, 40), (3, 3), (2, 2), 3, "relu"),
             ("x not 16-byte aligned, C 96", (1, 9, 11, 96), (3, 3), (2, 2),
              5, "misaligned"),
             ("AlexNet L1", (1, 55, 55, 96), (3, 3), (2, 2), 5, "relu"),
             ("AlexNet L2", (1, 27, 27, 256), (3, 3), (2, 2), 5, "relu"))

#: K2: (what, x shape, LRN n, input)
K2_SHAPES = (("AlexNet L1 C 96, one whole tile", (1, 3, 7, 96), 5, "relu"),
             ("AlexNet L1 C 96, ragged last tile", (1, 5, 9, 96), 5,
              "relu"),
             ("AlexNet L2 C 256, ragged last tile", (1, 3, 5, 256), 5,
              "relu"),
             ("C 3", (2, 14, 16, 3), 5, "relu"),
             ("C 40", (2, 5, 7, 40), 5, "relu"),
             ("C 70", (2, 5, 7, 70), 5, "relu"),
             ("LRN n 3", (2, 5, 7, 40), 3, "relu"),
             ("all zero", (2, 5, 7, 40), 5, "zero"),
             ("NaN in x", (2, 5, 7, 40), 5, "nan"),
             ("x not 16-byte aligned, C 96", (1, 5, 9, 96), 5,
              "misaligned"))


@pytest.fixture(scope="module")
def emulated_libs(tmp_path_factory):
    """(kernel, build) -> (the library g++ built from the kernel's source,
    its C entry point), all builds compiled at once."""
    gxx = find_gxx()
    out = tmp_path_factory.mktemp("forward_emulation")
    started = {(name, build): compile_source(
                   gxx, emulated_source(SOURCES[name], consts, 1),
                   out / f"{name}_{build.replace(' ', '_')}.so")
               for name, builds in BUILDS.items()
               for build, consts in builds.items()}
    return {key: (job[0], load_entry(*job, name=key[0]))
            for key, job in started.items()}


@pytest.fixture(scope="module")
def emulated(emulated_libs):
    """(kernel, build) -> the C entry point of the kernel's source."""
    return {key: entry for key, (_, entry) in emulated_libs.items()}


@pytest.fixture(scope="module")
def emulated_bf16(emulated_libs):
    """(kernel, build) -> the C entry point of the kernel's bf16
    instance."""
    return {key: entry_in(lib, f"{key[0]}_bf16")
            for key, (lib, _) in emulated_libs.items()}


def _input(shape, kind, seed=8):
    rs = np.random.RandomState(seed)
    x = np.maximum(rs.randn(*shape), 0).astype(np.float32)
    if kind == "zero":
        x[:] = 0.0
    elif kind == "nan":
        hi = tuple(d - 1 for d in shape)
        x[0, 2, 2, 3] = x[hi] = x[shape[0] - 1, 3, 0, 0] = np.nan
    if kind == "misaligned":
        # one float into a fresh buffer: contiguous, 4 bytes past 16
        buf = torch.empty(x.size + 1, dtype=torch.float32)
        xt = buf[1:].view(shape)
        xt.copy_(torch.from_numpy(x))
        assert xt.data_ptr() % 16 != 0
        return xt
    return torch.from_numpy(x)


def _run(entry, monkeypatch, name, x, *args, generic=False,
         bf16_offset=None, **launch):
    """(the kernel's source through its wrapper, the plain version) on
    `x`; `args` are the wrapper's after x, `launch` its launch shape (K2's
    tile, K4's rb and cb). In bf16 (x `bf16_offset` elements into its
    buffer) unless None."""
    if bf16_offset is not None:
        x = bf16_at(x.contiguous(), bf16_offset)
    plain = getattr(kernels, f"{name}_plain")
    sqrt = torch.sqrt
    with monkeypatch.context() as m:
        m.setattr(torch, "sqrt", lambda t: sqrt(t.double()).to(t.dtype))
        want = plain(x, *args)
    with wrapper_on(entry, monkeypatch):
        got = getattr(kernels, name)(x, *args, generic=generic, **launch)
    return got, want


def _assert_bit_equal(got, want):
    """The same bits everywhere, NaN where the plain version has NaN;
    returns the count of NaN."""
    nan = want.isnan()
    assert torch.equal(got.isnan(), nan)
    assert torch.equal(got.masked_fill(nan, 0.0), want.masked_fill(nan, 0.0))
    return int(nan.sum())


def _k4(entry, monkeypatch, shape, ksize, stride, n, kind, generic=False,
        bf16_offset=None, **launch):
    return _run(entry, monkeypatch, "lrn_maxpool_forward",
                _input(shape, kind), K, ALPHA, BETA, n, ksize, stride,
                generic=generic, bf16_offset=bf16_offset, **launch)


def _k2(entry, monkeypatch, shape, n, kind, generic=False,
        bf16_offset=None, **launch):
    return _run(entry, monkeypatch, "lrn_forward", _input(shape, kind, 3), K,
                ALPHA, BETA, n, generic=generic, bf16_offset=bf16_offset,
                **launch)


@pytest.mark.parametrize("build", list(BUILDS["lrn_maxpool_forward"]))
@pytest.mark.parametrize("what,shape,ksize,stride,n,kind", K4_SHAPES,
                         ids=[s[0] for s in K4_SHAPES])
def test_k4_source_is_bit_equal_to_the_plain_version(emulated, monkeypatch,
                                                     build, what, shape,
                                                     ksize, stride, n, kind):
    got, want = _k4(emulated["lrn_maxpool_forward", build], monkeypatch,
                    shape, ksize, stride, n, kind)
    assert (_assert_bit_equal(got, want) > 0) == (kind == "nan")
    # a window wholly past the edge pools to -inf, and only there
    oh, ow = fn.pool_out_hw(*shape[1:3], *ksize, *stride)
    empty = (oh - 1) * stride[0] >= shape[1] or (ow - 1) * stride[1] \
        >= shape[2]
    assert bool(torch.isneginf(want).any()) == empty


@pytest.mark.parametrize("build", list(BUILDS["lrn_forward"]))
@pytest.mark.parametrize("what,shape,n,kind", K2_SHAPES,
                         ids=[s[0] for s in K2_SHAPES])
def test_k2_source_is_bit_equal_to_the_plain_version(emulated, monkeypatch,
                                                     build, what, shape, n,
                                                     kind):
    got, want = _k2(emulated["lrn_forward", build], monkeypatch, shape, n,
                    kind)
    assert (_assert_bit_equal(got, want) > 0) == (kind == "nan")


@pytest.mark.parametrize("name,build", [(name, build) for name in BUILDS
                                        for build in BUILDS[name]])
def test_generic_instance_at_alexnets_geometry(emulated, monkeypatch, name,
                                               build):
    """The run-time instance, asked for at AlexNet's geometry (which the
    compile-time one takes otherwise), gives the plain version's bits and
    the compile-time instance's."""
    entry = emulated[name, build]
    if name == "lrn_maxpool_forward":
        case = (entry, monkeypatch, (2, 14, 16, 40), (3, 3), (2, 2), 5,
                "relu")
        generic, want = _k4(*case, generic=True)
        fixed, _ = _k4(*case)
    else:
        generic, want = _k2(entry, monkeypatch, (1, 5, 9, 96), 5, "relu",
                            generic=True)
        fixed, _ = _k2(entry, monkeypatch, (1, 5, 9, 96), 5, "relu")
    _assert_bit_equal(generic, want)
    assert torch.equal(generic, fixed)


#: the bf16 instances at small shapes: (kernel, what, x shape, input, x's
#: offset in elements from 16-byte alignment); 8-byte copies of four
#: channels where C % 4 == 0 and x (and K2's y) are 8-byte aligned, else
#: 2-byte ones; K4 under 3x3/2 pools
BF16_CASES = (("lrn_maxpool_forward", "clipped both axes, C 40",
               (2, 14, 16, 40), "relu", 0),
              ("lrn_maxpool_forward", "C 3", (2, 14, 16, 3), "relu", 0),
              ("lrn_maxpool_forward", "NaN windows", (2, 14, 16, 40), "nan",
               0),
              ("lrn_maxpool_forward", "x 8 bytes off 16-byte alignment",
               (1, 9, 11, 96), "relu", 4),
              ("lrn_maxpool_forward", "x 2 bytes off alignment",
               (1, 9, 11, 96), "relu", 1),
              ("lrn_forward", "C 96, ragged last tile", (1, 5, 9, 96),
               "relu", 0),
              ("lrn_forward", "C 256, ragged last tile", (1, 3, 5, 256),
               "relu", 0),
              ("lrn_forward", "C 3", (2, 14, 16, 3), "relu", 0),
              ("lrn_forward", "C 70", (2, 5, 7, 70), "relu", 0),
              ("lrn_forward", "NaN in x", (2, 5, 7, 40), "nan", 0),
              ("lrn_forward", "x 8 bytes off 16-byte alignment",
               (1, 5, 9, 96), "relu", 4),
              ("lrn_forward", "x 2 bytes off alignment", (1, 5, 9, 96),
               "relu", 1))


@pytest.mark.parametrize("build", ["as written", "narrow"])
@pytest.mark.parametrize("name,what,shape,kind,offset", BF16_CASES,
                         ids=[f"{c[0]} {c[1]}" for c in BF16_CASES])
def test_bf16_source_is_bit_equal_to_the_plain_version(
        emulated_bf16, monkeypatch, build, name, what, shape, kind, offset):
    """The bf16 instances (bf16 x and y; staged as f32, K4's maximum taken
    in f32 and each output rounded once) give the plain versions' bits."""
    entry = emulated_bf16[name, build]
    if name == "lrn_maxpool_forward":
        got, want = _k4(entry, monkeypatch, shape, (3, 3), (2, 2), 5, kind,
                        bf16_offset=offset)
    else:
        got, want = _k2(entry, monkeypatch, shape, 5, kind,
                        bf16_offset=offset)
    assert got.dtype == torch.bfloat16
    assert (_assert_bit_equal(got, want) > 0) == (kind == "nan")


@pytest.mark.parametrize("name", list(SOURCES))
def test_bf16_generic_instance(emulated_bf16, monkeypatch, name):
    entry = emulated_bf16[name, "as written"]
    if name == "lrn_maxpool_forward":
        _assert_bit_equal(*_k4(entry, monkeypatch, (2, 14, 16, 40), (3, 3),
                               (2, 2), 5, "relu", generic=True,
                               bf16_offset=0))
    else:
        _assert_bit_equal(*_k2(entry, monkeypatch, (1, 5, 9, 96), 5, "relu",
                               generic=True, bf16_offset=0))


@pytest.mark.parametrize("name", list(SOURCES))
def test_a_channel_halo_left_unstaged_fails(tmp_path, monkeypatch, name):
    """The emulation sees the channel tiles: a build that stages only a
    tile's own channels (zeros where the window reaches into the next
    tile) is not bit-equal where C is cut into tiles (K4's 32 channels;
    K2's narrow 16)."""
    consts = dict(BUILDS[name]["narrow"])
    if name == "lrn_forward":
        consts.update({old: new.replace("kCT", "p.ct")
                       for old, new in UNSTAGED_HALO.items()})
    else:
        consts.update(UNSTAGED_HALO)
    src = emulated_source(SOURCES[name], consts, 1)
    entry = load_entry(*compile_source(find_gxx(), src,
                                       tmp_path / "unstaged.so"), name=name)
    with pytest.raises(AssertionError):
        if name == "lrn_maxpool_forward":
            _assert_bit_equal(*_k4(entry, monkeypatch, (2, 14, 16, 40),
                                   (3, 3), (2, 2), 5, "relu"))
        else:
            _assert_bit_equal(*_k2(entry, monkeypatch, (2, 5, 7, 40), 5,
                                   "relu"))



#: (kernel, the smem entry's arguments, bytes): K4 at AlexNet's two LRN
#: inputs under 3x3/2 pools (H, W, C, OH, OW, window, stride, half, and
#: the band at most, 0 x 0 for the source's 3 x 16) takes 7 x 33 and 7 x
#: 27 staged pixels of 32 + 2*4 floats; K2 at C 96 and 256 (C, half,
#: tile, 0 for the source's 3072) 32 rows of 104 and 12 of 264 floats; a
#: window too wide for 48 KB is refused (-1). Then the kernel search's
#: points: K4's band 4 x 32 shrunk to 2 x 27 at layer 1 (5 x 55 pixels),
#: 1 x 8 at layer 2 (3 x 17); K2's tile 6144 (64 rows of 104), 12288 at C
#: 256 (capped by 48 KB: 46 rows of 264), and a tile that is no multiple
#: of 4, refused
SMEM = (("lrn_maxpool_forward", (55, 55, 96, 27, 27, 3, 3, 2, 2, 2, 0, 0),
         36960),
        ("lrn_maxpool_forward", (27, 27, 256, 13, 13, 3, 3, 2, 2, 2, 0, 0),
         30240),
        ("lrn_maxpool_forward",
         (27, 27, 256, 13, 13, 3, 3, 2, 2, 1000, 0, 0), -1),
        ("lrn_maxpool_forward", (55, 55, 96, 27, 27, 3, 3, 2, 2, 2, 3, 16),
         36960),
        ("lrn_maxpool_forward", (55, 55, 96, 27, 27, 3, 3, 2, 2, 2, 4, 32),
         44000),
        ("lrn_maxpool_forward", (27, 27, 256, 13, 13, 3, 3, 2, 2, 2, 1, 8),
         8160),
        ("lrn_forward", (96, 2, 0), 13312),
        ("lrn_forward", (256, 2, 0), 12672),
        ("lrn_forward", (96, 5000, 0), -1),
        ("lrn_forward", (96, 2, 3072), 13312),
        ("lrn_forward", (96, 2, 6144), 26624),
        ("lrn_forward", (256, 2, 12288), 48576),
        ("lrn_forward", (96, 2, 6), -1))


@pytest.mark.parametrize("name,args,want", SMEM)
def test_smem_bytes_entry(emulated_libs, name, args, want):
    """The C entry chip_smoke.py's BUILD lines read gives the dynamic
    shared memory the launch takes, and -1 where the launch refuses; the
    kernel search's Python mirror of the source's plan
    (kernels.<name>_smem_bytes) gives the same."""
    entry = getattr(ctypes.CDLL(str(emulated_libs[name, "as written"][0])),
                    f"{name}_smem_bytes")
    entry.argtypes = [ctypes.c_int] * len(args)
    entry.restype = ctypes.c_int
    assert entry(*args) == want
    assert getattr(kernels, f"{name}_smem_bytes")(*args) == want


#: the kernel search's K2 tiles and K4 bands at shapes whose last tile or
#: band is ragged: (kernel, what, x shape, launch shape)
LAUNCH_POINTS = (
    ("lrn_forward", "C 96 tile 1536: 13 tiles of 16 rows, last 6",
     (2, 9, 11, 96), {"tile": 1536}),
    ("lrn_forward", "C 96 tile 6144: 4 tiles of 64 rows, last 6",
     (2, 9, 11, 96), {"tile": 6144}),
    ("lrn_forward", "C 96 tile 12288: 118 rows, then 80",
     (2, 9, 11, 96), {"tile": 12288}),
    ("lrn_forward", "C 256 tile 1536: 6 rows a tile, last 5",
     (1, 5, 7, 256), {"tile": 1536}),
    ("lrn_forward", "C 256 tile 6144: 24 rows, then 11",
     (1, 5, 7, 256), {"tile": 6144}),
    ("lrn_maxpool_forward", "band 1 x 8 over 13 x 13 pooled",
     (2, 27, 27, 40), {"rb": 1, "cb": 8}),
    ("lrn_maxpool_forward", "band 4 x 32 over 13 x 13 pooled",
     (2, 27, 27, 40), {"rb": 4, "cb": 32}),
    ("lrn_maxpool_forward", "band 2 x 16, ceil-mode edge",
     (2, 14, 16, 40), {"rb": 2, "cb": 16}))


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("name,what,shape,launch", LAUNCH_POINTS,
                         ids=[f"{p[0]} {p[1]}" for p in LAUNCH_POINTS])
def test_search_launch_shapes_are_bit_equal(emulated, emulated_bf16,
                                            monkeypatch, dtype, name, what,
                                            shape, launch):
    """Each launch shape the kernel search can ask for, a run-time
    argument of the source, gives the plain version's bits (the last tile
    or band ragged), as the source's constant does."""
    entry = (emulated if dtype == "f32" else emulated_bf16)[
        name, "as written"]
    off = 0 if dtype == "bf16" else None
    if name == "lrn_maxpool_forward":
        got, want = _k4(entry, monkeypatch, shape, (3, 3), (2, 2), 5,
                        "relu", bf16_offset=off, **launch)
    else:
        got, want = _k2(entry, monkeypatch, shape, 5, "relu",
                        bf16_offset=off, **launch)
    _assert_bit_equal(got, want)
