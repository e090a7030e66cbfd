"""The port's packed memmap dataset and its loader, held against the JAX
package's on the same packed directories.

- `pack_arrays` writes the JAX package's files byte for byte, and each
  package's loader reads the other's;
- the same seed gives the same minibatches (indices, rows, labels, the
  normalized floats' bits) in both packages, through the numpy gather
  and the native one;
- `hflip` flips train rows only, by the JAX package's hash: the flip
  masks are equal for the same seed;
- the native gather (the port's copy of host_gather.cpp, built with g++)
  gives the numpy gather's bits;
- `apply_input_normalize`, the uint8 wire's prologue, gives the JAX
  function's bits;
- pickling, the lookahead override, the throughput helper, and the
  AlexNet sample's `data_path`.
"""

import json
import os
import pickle
import shutil

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from veles_tpu import prng as jprng
from veles_tpu.loader import memmap as jmm
from veles_tpu_torch import native_gather, prng
from veles_tpu_torch.loader import memmap as mm
from veles_tpu_torch.parallel.fused import apply_input_normalize


@pytest.fixture(autouse=True)
def _fresh_generators():
    saved = jprng._base_seed, prng._base_seed
    prng._generators.clear()
    yield
    prng._generators.clear()
    jprng._base_seed, prng._base_seed = saved


def make_packed(tmp_path, n=40, hw=6, n_valid=8, shard_mb=0.0005,
                sub="packed", pack=mm.pack_arrays):
    rng = np.random.RandomState(0)
    data = rng.randint(0, 256, (n, hw, hw, 3), dtype=np.uint8)
    labels = np.arange(n, dtype=np.int64) % 4
    mean = data.astype(np.float64).mean(axis=0) / 127.5 - 1.0
    out = pack(str(tmp_path / sub), data, labels, [0, n_valid, n - n_valid],
               shard_mb=shard_mb, mean_image=mean.astype(np.float32))
    return out, data, labels


def _loaders(out, **kw):
    """The port's and the JAX package's loaders over `out`, each
    initialized from seed 5."""
    jprng.seed_all(5)
    jl = jmm.MemmapImageLoader(data_path=out, **kw)
    jl.initialize(device=None)
    prng.seed_all(5)
    pl = mm.MemmapImageLoader(data_path=out, **kw)
    pl.initialize()
    return jl, pl


def test_pack_writes_the_jax_packages_files(tmp_path):
    out, _, _ = make_packed(tmp_path)
    jout, _, _ = make_packed(tmp_path, sub="jax", pack=jmm.pack_arrays)
    names = sorted(os.listdir(out))
    assert names == sorted(os.listdir(jout))
    for name in names:
        with open(os.path.join(out, name), "rb") as a, \
                open(os.path.join(jout, name), "rb") as b:
            assert a.read() == b.read(), name
    with open(os.path.join(out, mm.MANIFEST)) as f:
        man = json.load(f)
    assert man["n_samples"] == 40 and len(man["shards"]) > 1
    assert man["shards"][0]["rows"] * 6 * 6 * 3 == os.path.getsize(
        os.path.join(out, man["shards"][0]["file"]))


@pytest.mark.parametrize("native", ["off", "auto"])
@pytest.mark.parametrize("emit", ["float32", "uint8"])
def test_minibatches_equal_the_jax_loaders(tmp_path, native, emit):
    """Two epochs of minibatches from one seed: the same indices, bits,
    labels, pad masks and class bookkeeping as the JAX loader's."""
    out, data, labels = make_packed(tmp_path, n=36)
    jl, pl = _loaders(out, minibatch_size=8, native=native, emit=emit)
    try:
        assert pl.class_lengths == list(jl.class_lengths) == [0, 8, 28]
        assert pl.sample_shape == (6, 6, 3)
        np.testing.assert_array_equal(pl.mean_image, jl.mean_image)
        for _ in range(2 * 5):
            jl.run()
            pl.run()
            idx = pl.minibatch_indices
            np.testing.assert_array_equal(idx, jl.minibatch_indices.mem)
            assert pl.minibatch_data.dtype == np.dtype(emit)
            np.testing.assert_array_equal(pl.minibatch_data,
                                          jl.minibatch_data.mem)
            np.testing.assert_array_equal(pl.minibatch_labels, labels[idx])
            np.testing.assert_array_equal(pl.minibatch_valid,
                                          jl.minibatch_valid.mem)
            assert pl.minibatch_class == jl.minibatch_class
            assert pl.last_minibatch == bool(jl.last_minibatch)
        assert pl.gather_used == ("numpy" if native == "off"
                                  or not native_gather.available()
                                  else "native")
        if emit == "float32":
            want = (data[idx].astype(np.float32) / 127.5 - 1.0
                    - pl.mean_image)
            np.testing.assert_array_equal(pl.minibatch_data, want)
    finally:
        jl.stop()
        pl.stop()


def test_each_package_reads_the_others_pack(tmp_path):
    jout, data, _ = make_packed(tmp_path, sub="jax", pack=jmm.pack_arrays)
    prng.seed_all(3)
    loader = mm.MemmapImageLoader(data_path=jout, minibatch_size=8,
                                  shuffle_train=False, emit="uint8")
    loader.initialize()
    loader.run()
    np.testing.assert_array_equal(loader.minibatch_data, data[:8])
    loader.stop()


def test_hflip_masks_equal_the_jax_loaders_and_flip_train_rows_only(
        tmp_path):
    """hflip: train rows flip by a seeded per-(sample, epoch) coin, the
    JAX package's hash under the JAX package's "hflip" seed, so both
    flip the same rows; validation rows never flip; a re-produce within
    the epoch flips alike and the next epoch draws anew."""
    out, data, _ = make_packed(tmp_path, n=40, n_valid=8)
    jl, pl = _loaders(out, minibatch_size=8, hflip=True,
                      mean_normalize=False, emit="uint8")
    try:
        assert pl._hflip_seed == jl._hflip_seed
        all_idx = np.arange(40, dtype=np.int64)
        flipped = unflipped = 0
        masks = []
        for epoch in range(2):
            np.testing.assert_array_equal(pl._flip_mask(all_idx),
                                          jl._flip_mask(all_idx))
            masks.append(pl._flip_mask(all_idx))
            assert not masks[-1][:8].any()
            for _ in range(5):
                jl.run()
                pl.run()
                idx = pl.minibatch_indices
                x = pl.minibatch_data
                np.testing.assert_array_equal(x, jl.minibatch_data.mem)
                if not pl.epoch_ended:
                    # the epoch's last batch rolls epoch_number first
                    np.testing.assert_array_equal(x, pl._produce(idx)[0])
                for row, i in zip(x, idx):
                    if np.array_equal(row, data[i]):
                        unflipped += 1
                    else:
                        np.testing.assert_array_equal(row, data[i][:, ::-1])
                        assert i >= 8, f"validation row {i} flipped"
                        flipped += 1
        assert flipped > 0 and unflipped > 0
        assert (masks[0] != masks[1]).any()
    finally:
        jl.stop()
        pl.stop()


def test_native_gather_matches_numpy(tmp_path):
    """The C++ gather gives the numpy gather's bits: the f32 + mean path,
    the uint8 path, each with and without the flip."""
    if shutil.which("g++") is None:
        pytest.skip("no C++ toolchain")
    assert native_gather.available(), native_gather.last_error
    assert native_gather.library_path().exists()
    out, _, _ = make_packed(tmp_path, n=40, hw=8, n_valid=8)

    def run_loader(native, emit, hflip):
        prng._generators.clear()
        prng.seed_all(11)
        loader = mm.MemmapImageLoader(
            data_path=out, minibatch_size=8, shuffle_train=False,
            native=native, emit=emit, hflip=hflip)
        loader.initialize()
        got = []
        for _ in range(5):
            loader.run()
            got.append((loader.minibatch_data.copy(),
                        loader.minibatch_labels.copy()))
        used = loader.gather_used
        loader.stop()
        return got, used

    for emit in ("float32", "uint8"):
        for hflip in (False, True):
            a, used_a = run_loader("auto", emit, hflip)
            b, used_b = run_loader("off", emit, hflip)
            assert (used_a, used_b) == ("native", "numpy")
            for (xa, ya), (xb, yb) in zip(a, b):
                np.testing.assert_array_equal(
                    xa, xb, err_msg=f"emit={emit} hflip={hflip}")
                np.testing.assert_array_equal(ya, yb)


def test_apply_input_normalize_gives_the_jax_functions_bits(tmp_path):
    """The prologue on a uint8 batch with a mean image: the JAX function's
    operations in its order, one rounding each, bit for bit. (XLA on the
    CPU contracts the jitted `x * scale + offset` into a fused
    multiply-add; the JAX function as written rounds twice, as the port
    does.)"""
    from veles_tpu.parallel.fused import apply_input_normalize as japply
    out, _, _ = make_packed(tmp_path, n=16, hw=6, n_valid=0)
    prng.seed_all(2)
    loader = mm.MemmapImageLoader(data_path=out, minibatch_size=16,
                                  emit="uint8")
    loader.initialize()
    loader.run()
    x = loader.minibatch_data
    spec = loader.wire_format()["normalize"]
    loader.stop()
    assert x.dtype == np.uint8 and spec["mean"] is not None
    got = apply_input_normalize(spec, torch.from_numpy(x))
    want = np.asarray(japply(spec, jnp.asarray(x)))
    assert got.dtype == torch.float32
    np.testing.assert_array_equal(got.numpy(), want)
    # and the host path it stands in for, within the division's rounding
    np.testing.assert_allclose(got.numpy(), loader._normalize(x), rtol=0,
                               atol=2.0 ** -22)
    assert apply_input_normalize(None, got) is got


def test_pickles_without_pool_and_restores(tmp_path):
    out, _, _ = make_packed(tmp_path)
    prng.seed_all(5)
    loader = mm.MemmapImageLoader(data_path=out, minibatch_size=8)
    loader.initialize()
    loader.run()
    loader.set_emit("uint8")
    loader._emit_pristine = "float32"
    loader.feed_stats = {"batches": 1}
    blob = pickle.dumps(loader)
    loader.stop()
    restored = pickle.loads(blob)
    try:
        assert restored._pool is None and restored._pending == {}
        assert restored.emit == "float32"
        assert not hasattr(restored, "feed_stats")
        assert len(restored._maps) > 1
        restored.run()
        assert restored.minibatch_data.shape == (8, 6, 6, 3)
    finally:
        restored.stop()


def test_lookahead_gives_way_to_other_indices(tmp_path):
    """fill_minibatch with indices other than the schedule's gets those
    rows, not the prefetched batch."""
    out, data, labels = make_packed(tmp_path)
    prng.seed_all(9)
    loader = mm.MemmapImageLoader(data_path=out, minibatch_size=8,
                                  shuffle_train=False, mean_normalize=False)
    loader.initialize()
    loader.run()
    idx = np.asarray([3, 5, 7, 9] * 2, np.int64)
    loader.fill_minibatch(idx)
    np.testing.assert_array_equal(
        loader.minibatch_data, data[idx].astype(np.float32) / 127.5 - 1.0)
    np.testing.assert_array_equal(loader.minibatch_labels, labels[idx])
    assert loader.rows_decoded >= 16
    loader.stop()


def test_loader_throughput_reports_a_rate(tmp_path):
    out, _, _ = make_packed(tmp_path, n=64, n_valid=0)
    prng.seed_all(6)
    loader = mm.MemmapImageLoader(data_path=out, minibatch_size=16,
                                  n_workers=2, prefetch=3)
    loader.initialize()
    stats = mm.loader_throughput(loader, n_batches=8)
    loader.stop()
    assert stats["batches"] == 8 and stats["samples_per_sec"] > 0


def test_alexnet_data_path_builds_the_memmap_loader(tmp_path):
    """A data_path holding a manifest builds MemmapImageLoader; a
    directory without one is taken for an image tree and builds
    ImageDirectoryLoader, as the JAX sample does."""
    from veles_tpu_torch import root
    from veles_tpu_torch.loader.image import ImageDirectoryLoader
    from veles_tpu_torch.samples import alexnet

    out, _, _ = make_packed(tmp_path)
    saved = root.alexnet.loader.data_path
    try:
        root.alexnet.loader.data_path = out
        wf = alexnet.create_workflow(minibatch_size=8)
        assert isinstance(wf.loader, mm.MemmapImageLoader)
        assert wf.loader.data_path == out
        assert wf.loader.minibatch_size == 8
        root.alexnet.loader.data_path = str(tmp_path)
        wf = alexnet.create_workflow(input_hw=67, n_validation=3)
        assert isinstance(wf.loader, ImageDirectoryLoader)
        assert wf.loader.data_path == str(tmp_path)
        assert wf.loader.size_hw == (67, 67)
        assert wf.loader.n_validation == 3
    finally:
        root.alexnet.loader.data_path = saved
