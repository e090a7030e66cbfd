"""The port's image-tree loader and `pack_image_dataset`, held against the
JAX package's (tests/test_image_loader.py's twins):

- the same list order, labels and class names, and the decoded floats'
  bits;
- the same split (the `image_split` permutation), mean image and
  minibatches from one seed; prefetched batches equal to a synchronous
  decode;
- `pack_image_dataset` writes the JAX function's files byte for byte
  (shards, labels, mean, manifest, classes), and the memmap loader
  reads them;
- the uint8 emit and its wire offer, the seeded flip in both emits;
- the toy AlexNet sample trains from a tree without a manifest, and a
  small conv workflow learns the tree's colour classes.
"""

import json
import os

import numpy as np
import pytest

from veles_tpu import prng as jprng
from veles_tpu.loader import image as jimage
from veles_tpu.loader import memmap as jmm
from veles_tpu_torch import prng
from veles_tpu_torch.loader import memmap as mm
from veles_tpu_torch.loader.image import (ImageDirectoryLoader, decode_image,
                                          list_image_tree)


@pytest.fixture(autouse=True)
def _fresh_generators(monkeypatch):
    monkeypatch.setattr(prng, "_generators", {})
    monkeypatch.setattr(prng, "_base_seed", None)
    saved = jprng._base_seed, dict(jprng._generators)
    yield
    jprng._base_seed = saved[0]
    jprng._generators.clear()
    jprng._generators.update(saved[1])


@pytest.fixture()
def image_tree(tmp_path):
    """3 classes x 8 images; class = solid color + noise so the tree is
    trivially learnable."""
    from PIL import Image
    rng = np.random.RandomState(0)
    colors = [(220, 30, 30), (30, 220, 30), (30, 30, 220)]
    root = tmp_path / "tree"
    for ci, color in enumerate(colors):
        d = root / f"class_{ci}"
        d.mkdir(parents=True)
        for i in range(8):
            arr = np.clip(np.array(color)[None, None, :]
                          + rng.randint(-25, 25, (12, 14, 3)), 0,
                          255).astype(np.uint8)
            Image.fromarray(arr).save(d / f"img_{i}.png")
    (root / "class_0" / "notes.txt").write_text("not an image")
    return str(root)


def _seed_both(seed):
    prng.seed_all(seed)
    jprng._generators.clear()
    jprng.seed_all(seed)


def test_list_and_decode_match_the_jax_package(image_tree):
    paths, labels, classes = list_image_tree(image_tree)
    assert (paths, labels, classes) == jimage.list_image_tree(image_tree)
    assert len(paths) == 24
    assert classes == ["class_0", "class_1", "class_2"]
    x = decode_image(paths[0], (8, 10))
    assert x.shape == (8, 10, 3) and x.dtype == np.float32
    assert -1.0 <= x.min() and x.max() <= 1.0
    np.testing.assert_array_equal(x, jimage.decode_image(paths[0], (8, 10)))


def _loaders(image_tree, **kw):
    _seed_both(7)
    port = ImageDirectoryLoader(data_path=image_tree, **kw)
    jax = jimage.ImageDirectoryLoader(data_path=image_tree, **kw)
    port.initialize()
    jax.initialize(device=None)
    return port, jax


@pytest.mark.parametrize("emit", ["float32", "uint8"])
def test_split_mean_and_minibatches_equal_the_jax_loaders(image_tree, emit):
    port, jax = _loaders(image_tree, size_hw=(8, 8), n_validation=6,
                         minibatch_size=6, prefetch=2, hflip=True,
                         emit=emit)
    try:
        assert port.paths == jax.paths
        np.testing.assert_array_equal(port.path_labels, jax.path_labels)
        assert port.class_lengths == list(jax.class_lengths)
        np.testing.assert_array_equal(port.mean_image, jax.mean_image)
        for _ in range(6):       # over one epoch boundary
            port.run()
            jax.run()
            assert port.minibatch_class == int(jax.minibatch_class)
            np.testing.assert_array_equal(port.minibatch_indices,
                                          jax.minibatch_indices.mem)
            np.testing.assert_array_equal(port.minibatch_data,
                                          jax.minibatch_data.mem)
            np.testing.assert_array_equal(port.minibatch_labels,
                                          jax.minibatch_labels.mem)
    finally:
        port.stop()
        jax.stop()


def test_prefetch_matches_sync_decode(image_tree):
    prng.seed_all(7)
    loader = ImageDirectoryLoader(
        data_path=image_tree, size_hw=(8, 8), n_validation=6,
        minibatch_size=6, mean_normalize=True, prefetch=2)
    loader.initialize()
    seen = []
    for _ in range(6):  # over one epoch boundary
        loader.run()
        seen.append((loader.minibatch_indices.copy(),
                     loader.minibatch_data.copy()))
    for idx, x in seen:
        gold, _ = loader._produce_batch(idx)
        np.testing.assert_array_equal(x, gold)
    loader.stop()


def test_pack_image_dataset_writes_the_jax_functions_files(image_tree,
                                                           tmp_path):
    _seed_both(3)
    mine = mm.pack_image_dataset(image_tree, str(tmp_path / "port"),
                                 size_hw=(8, 10), n_validation=5,
                                 shard_mb=0.0006, mean_sample=7)
    theirs = jmm.pack_image_dataset(image_tree, str(tmp_path / "jax"),
                                    size_hw=(8, 10), n_validation=5,
                                    shard_mb=0.0006, mean_sample=7)
    names = sorted(os.listdir(mine))
    assert names == sorted(os.listdir(theirs))
    assert len([n for n in names if n.startswith("shard_")]) > 1
    for name in names:
        with open(os.path.join(mine, name), "rb") as a, \
                open(os.path.join(theirs, name), "rb") as b:
            assert a.read() == b.read(), name
    with open(os.path.join(mine, mm.MANIFEST)) as f:
        man = json.load(f)
    assert man["class_lengths"] == [0, 5, 19]
    assert man["sample_shape"] == [8, 10, 3]
    # the image loader's split and rows: rint of its decoded floats
    prng.seed_all(3)
    ref = ImageDirectoryLoader(data_path=image_tree, size_hw=(8, 10),
                               n_validation=5, mean_normalize=False,
                               emit="uint8")
    ref.load_data()
    loader = mm.MemmapImageLoader(data_path=mine, minibatch_size=24,
                                  emit="uint8", shuffle_train=False)
    loader.initialize()
    rows, _ = loader._produce_batch(np.arange(24))
    want, labels = ref._produce_batch(np.arange(24))
    np.testing.assert_array_equal(rows, want)
    np.testing.assert_array_equal(np.load(os.path.join(mine, "labels.npy")),
                                  labels)
    loader.stop()


def test_uint8_emit_and_wire_format(image_tree):
    """emit="uint8": raw re-quantized bytes leave the host and the mean
    moves into the wire offer; a float32 loader offers no wire."""
    prng.seed_all(5)
    loader = ImageDirectoryLoader(
        data_path=image_tree, size_hw=(12, 12), n_validation=6,
        minibatch_size=6, shuffle_train=False, emit="uint8")
    loader.initialize()
    loader.run()
    x = loader.minibatch_data
    assert x.dtype == np.uint8
    spec = loader.wire_format()
    assert spec["emit"] == "uint8"
    assert spec["normalize"]["mean"] is loader.mean_image
    f32 = (x.astype(np.float32) / 127.5 - 1.0) - loader.mean_image
    prng.seed_all(5)
    ref = ImageDirectoryLoader(
        data_path=image_tree, size_hw=(12, 12), n_validation=6,
        minibatch_size=6, shuffle_train=False)
    ref.initialize()
    ref.run()
    np.testing.assert_allclose(f32, ref.minibatch_data, atol=0.5 / 127.5)
    assert ref.wire_format() is None
    loader.stop()
    ref.stop()
    with pytest.raises(ValueError, match="emit"):
        ImageDirectoryLoader(data_path=image_tree, emit="float16")


def test_hflip_agrees_across_emit_modes(image_tree):
    def produce(emit):
        prng.seed_all(23)
        loader = ImageDirectoryLoader(
            data_path=image_tree, size_hw=(8, 8), n_validation=6,
            minibatch_size=6, shuffle_train=False, hflip=True, emit=emit)
        loader.initialize()
        rows = []
        for _ in range(3):
            loader.run()
            rows.append(loader.minibatch_data.copy())
        mean = loader.mean_image
        loader.stop()
        return rows, mean

    u8_rows, mean = produce("uint8")
    f32_rows, _ = produce("float32")
    for u8, f32 in zip(u8_rows, f32_rows):
        dev = (u8.astype(np.float32) / 127.5 - 1.0) - mean
        np.testing.assert_allclose(dev, f32, atol=0.51 / 127.5)


def test_alexnet_sample_trains_from_an_image_tree(image_tree):
    """A data_path without a manifest: the toy AlexNet trains from the
    tree through `run_fused` on the CPU (the JAX sample's branch)."""
    from veles_tpu_torch import root
    from veles_tpu_torch.samples import alexnet
    saved = root.alexnet.loader.data_path
    try:
        root.alexnet.loader.data_path = image_tree
        prng.seed_all(1)
        wf = alexnet.create_workflow(minibatch_size=6, input_hw=67,
                                     n_validation=6, n_classes=3,
                                     width_mult=0.125, fc_width=32,
                                     init="scaled")
    finally:
        root.alexnet.loader.data_path = saved
    assert isinstance(wf.loader, ImageDirectoryLoader)
    wf.run_fused(epochs=1, device="cpu")
    assert wf.decision.epoch_number == 1
    assert np.isfinite(wf.evaluator.loss)
    assert wf.feed_stats["batches"] == 4 and not wf.feed_stats["uint8_wire"]


def test_fused_conv_learns_the_image_tree(image_tree):
    from veles_tpu_torch.znicz.standard_workflow import StandardWorkflow
    prng.seed_all(1234)
    loader = ImageDirectoryLoader(
        data_path=image_tree, size_hw=(12, 12), n_validation=6,
        minibatch_size=6, shuffle_train=True, prefetch=2)
    wf = StandardWorkflow(
        layers=[{"type": "conv_strictrelu", "n_kernels": 8, "kx": 5,
                 "ky": 5, "stride": (2, 2), "padding": (2, 2),
                 "weights_stddev": 0.1},
                {"type": "max_pooling", "ksize": (2, 2), "stride": (2, 2)},
                {"type": "softmax", "output_sample_shape": 3,
                 "weights_stddev": 0.05}],
        loader=loader, loss="softmax", n_classes=3,
        decision_config={"max_epochs": 6, "fail_iterations": 50},
        gd_config={"learning_rate": 0.05, "gradient_moment": 0.9},
        name="ImgFused")
    wf.run_fused(device="cpu")
    assert wf.decision.best_validation_err <= 2, \
        (wf.decision.best_validation_err, wf.decision.history)
    assert len(wf.decision.history) == 6
