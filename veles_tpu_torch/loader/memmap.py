"""Packed memmap dataset format and its loader (the ImageNet-scale path).

The port's counterpart of `veles_tpu/loader/memmap.py`: `pack_arrays`
writes fixed-geometry uint8 samples into sharded binary files with a JSON
manifest (labels and the mean image as .npy sidecars), in the JAX
package's layout, so one packed directory feeds both packages.
`MemmapImageLoader` maps the shards (or reads them into memory below
~4 GB), gathers minibatch rows on the PrefetchingLoader threads (the
native gather when it builds) and emits either normalized float32 (the
host path: `u8 / 127.5 - 1 - mean`) or the raw uint8 bytes, which the
fused step normalizes on the card (`wire_format`, the uint8 wire).
`pack_image_dataset` decodes an image tree (loader/image.py) once into
the same format, streaming one shard at a time, with the image loader's
split and a mean image, as the JAX function does.
"""

from __future__ import annotations

import json
import os
import time
from typing import Any, List, Optional, Sequence, Tuple

import numpy as np

from veles_tpu_torch.loader.base import PrefetchingLoader

MANIFEST = "manifest.json"


def pack_arrays(out_dir: str, data_u8: np.ndarray, labels: np.ndarray,
                class_lengths: Sequence[int],
                shard_mb: float = 512.0,
                mean_image: Optional[np.ndarray] = None) -> str:
    """Write an already-materialized uint8 dataset (N, H, W, C) into the
    packed format, rows in test|validation|train order (the Loader's
    class order). Returns out_dir."""
    assert data_u8.dtype == np.uint8, data_u8.dtype
    assert len(data_u8) == sum(class_lengths)
    os.makedirs(out_dir, exist_ok=True)
    row_bytes = int(np.prod(data_u8.shape[1:]))
    rows_per_shard = max(1, int(shard_mb * 2 ** 20) // row_bytes)
    shards = []
    for si, lo in enumerate(range(0, len(data_u8), rows_per_shard)):
        rows = data_u8[lo:lo + rows_per_shard]
        fname = f"shard_{si:05d}.bin"
        rows.tofile(os.path.join(out_dir, fname))
        shards.append({"file": fname, "rows": int(len(rows))})
    np.save(os.path.join(out_dir, "labels.npy"), labels)
    if mean_image is not None:
        np.save(os.path.join(out_dir, "mean.npy"),
                mean_image.astype(np.float32))
    with open(os.path.join(out_dir, MANIFEST), "w") as f:
        json.dump({
            "sample_shape": list(data_u8.shape[1:]),
            "dtype": "uint8",
            "n_samples": int(len(data_u8)),
            "class_lengths": [int(c) for c in class_lengths],
            "shards": shards,
        }, f, indent=1)
    return out_dir


def pack_image_dataset(src_tree: str, out_dir: str,
                       size_hw: Tuple[int, int] = (227, 227),
                       n_validation: int = 0,
                       shard_mb: float = 512.0,
                       mean_sample: int = 64) -> str:
    """Decode a class-per-directory image tree once into the packed
    format, rows in ImageDirectoryLoader's split and order (an
    `image_split` permutation, validation first). Streaming: images are
    decoded shard by shard and written as they go, so resident memory is
    one shard, never the dataset. Pixels are stored as `rint((x + 1) *
    127.5)` (rounding, not truncation: the f32 round trip lands just
    below the integer for about a quarter of the values); the mean image
    is that of every (n // mean_sample)-th decoded image, at most
    `mean_sample` of them. Writes classes.json beside the manifest.
    Returns out_dir."""
    from veles_tpu_torch.loader.image import (decode_image, list_image_tree,
                                              split_order)

    paths, labels, class_names = list_image_tree(src_tree)
    if not paths:
        raise FileNotFoundError(f"no images under {src_tree!r}")
    labels = np.asarray(labels, np.int64)
    n = len(paths)
    order, n_valid = split_order(n, n_validation)
    h, w = size_hw
    os.makedirs(out_dir, exist_ok=True)
    rows_per_shard = max(1, int(shard_mb * 2 ** 20) // (h * w * 3))
    shards = []
    acc = np.zeros((h, w, 3), np.float64)
    mean_step = max(1, n // mean_sample)
    mean_cnt = 0
    for si, lo in enumerate(range(0, n, rows_per_shard)):
        chunk_idx = order[lo:lo + rows_per_shard]
        chunk = np.zeros((len(chunk_idx), h, w, 3), np.uint8)
        for j, src_i in enumerate(chunk_idx):
            img = decode_image(paths[int(src_i)], size_hw)  # [-1, 1] f32
            chunk[j] = np.rint((img + 1.0) * 127.5).astype(np.uint8)
            if (lo + j) % mean_step == 0 and mean_cnt < mean_sample:
                acc += img
                mean_cnt += 1
        fname = f"shard_{si:05d}.bin"
        chunk.tofile(os.path.join(out_dir, fname))
        shards.append({"file": fname, "rows": int(len(chunk))})
    np.save(os.path.join(out_dir, "labels.npy"), labels[order])
    np.save(os.path.join(out_dir, "mean.npy"),
            (acc / max(mean_cnt, 1)).astype(np.float32))
    with open(os.path.join(out_dir, MANIFEST), "w") as f:
        json.dump({
            "sample_shape": [h, w, 3], "dtype": "uint8",
            "n_samples": n,
            "class_lengths": [0, n_valid, n - n_valid],
            "shards": shards,
        }, f, indent=1)
    with open(os.path.join(out_dir, "classes.json"), "w") as f:
        json.dump(class_names, f)
    return out_dir


class MemmapImageLoader(PrefetchingLoader):
    """Minibatch loader over the packed format: uint8 shards, a gather
    (plus the seeded flip and the normalize) on the produce threads."""

    def __init__(self, data_path: str = "", mean_normalize: bool = True,
                 emit: str = "float32", preload="auto", native: str = "auto",
                 n_workers: int = 2, prefetch: int = 2,
                 **kwargs: Any) -> None:
        super().__init__(n_workers=n_workers, prefetch=prefetch, **kwargs)
        if native not in ("auto", "off"):
            raise ValueError(f"native must be 'auto' or 'off', got "
                             f"{native!r}")
        if emit not in ("float32", "uint8"):
            raise ValueError(f"emit must be 'float32' or 'uint8', got "
                             f"{emit!r}")
        self.data_path = data_path
        self.mean_normalize = mean_normalize
        #: "auto": the C++ multithreaded gather (native/host_gather.cpp)
        #: where it builds; "off": numpy's, the golden twin
        self.native = native
        #: "float32": normalized floats leave the host; "uint8": the raw
        #: bytes do, and the fused step normalizes them on the card
        self.emit = emit
        #: read the shards into memory ("auto": below ~4 GB in all)
        #: rather than map them
        self.preload = preload
        self.mean_image: Optional[np.ndarray] = None
        self._maps: List[np.ndarray] = []
        self._shard_lo: Optional[np.ndarray] = None   # row offsets
        self._labels: Optional[np.ndarray] = None
        #: the gather that produced the last batch: "native" or "numpy"
        self.gather_used: Optional[str] = None

    def load_data(self) -> None:
        with open(os.path.join(self.data_path, MANIFEST)) as f:
            man = json.load(f)
        shape = tuple(man["sample_shape"])
        row_bytes = int(np.prod(shape))
        total = man["n_samples"] * row_bytes
        preload = (total < 4 * 2 ** 30 if self.preload == "auto"
                   else bool(self.preload))
        self._maps = []
        offsets = [0]
        for sh in man["shards"]:
            path = os.path.join(self.data_path, sh["file"])
            if preload:
                m = np.fromfile(path, np.uint8).reshape(
                    (sh["rows"],) + shape)
            else:
                m = np.memmap(path, dtype=np.uint8, mode="r",
                              shape=(sh["rows"],) + shape)
            self._maps.append(m)
            offsets.append(offsets[-1] + sh["rows"])
        self._shard_lo = np.asarray(offsets)
        assert offsets[-1] == man["n_samples"]
        self._labels = np.load(os.path.join(self.data_path, "labels.npy"))
        mean_path = os.path.join(self.data_path, "mean.npy")
        if self.mean_normalize and os.path.exists(mean_path):
            self.mean_image = np.load(mean_path)
        self.class_lengths = list(man["class_lengths"])
        self.sample_shape = shape

    def wire_format(self):
        """The uint8 wire's offer: the packed source is uint8, so the raw
        bytes with `_normalize`'s affine on the card lose nothing. The
        spec mirrors `_normalize` (scale, offset, then the mean image),
        with a multiplication where the host divides."""
        return {"emit": "uint8",
                "normalize": {"scale": 1.0 / 127.5, "offset": -1.0,
                              "mean": self.mean_image}}

    # -- gather ----------------------------------------------------------------

    def _use_native(self) -> bool:
        if self.native == "off":
            return False
        from veles_tpu_torch import native_gather
        return native_gather.available()

    def _produce_rows(self, indices: np.ndarray):
        """Gather + seeded flip + normalize, the flip applied to the raw
        bytes before the normalize (the mean image is not flipped with
        the sample): both emits and both gathers agree on this order."""
        return self._gather(indices, self._flip_mask(indices))

    def _produce_batch(self, indices: np.ndarray):
        return self._gather(indices, None)

    def _normalize(self, u8: np.ndarray) -> np.ndarray:
        x = u8.astype(np.float32) / 127.5 - 1.0
        if self.mean_image is not None:
            x -= self.mean_image
        return x

    def _gather(self, indices: np.ndarray,
                flip: Optional[np.ndarray]) -> Tuple[np.ndarray, np.ndarray]:
        shape = self._maps[0].shape[1:]
        # flips are defined on (H, W) and (H, W, C) samples only
        if len(shape) not in (2, 3):
            flip = None
        shard = np.searchsorted(self._shard_lo, indices, "right") - 1
        rows = indices - self._shard_lo[shard]
        if self._use_native():
            from veles_tpu_torch import native_gather
            self.gather_used = "native"
            row_bytes = int(np.prod(shape))
            bases = np.asarray([m.ctypes.data for m in self._maps],
                               np.int64)
            src = bases[shard] + rows.astype(np.int64) * row_bytes
            w, c = ((shape[1], shape[2]) if len(shape) == 3
                    else (shape[-1], 1))
            if self.emit == "uint8":
                out = self.empty_minibatch((len(indices),) + shape,
                                           np.uint8)
                native_gather.gather_u8(src, row_bytes, out, flip, w, c)
            else:
                out = self.empty_minibatch((len(indices),) + shape,
                                           np.float32)
                native_gather.gather_f32(src, row_bytes, out,
                                         self.mean_image, 127.5, -1.0,
                                         flip, w, c)
            return out, self._labels[indices]
        self.gather_used = "numpy"
        # per-shard fancy-index gathers (row copies that release the GIL),
        # scattered back to minibatch order
        u8 = (self.empty_minibatch((len(indices),) + shape, np.uint8)
              if self.emit == "uint8"
              else np.empty((len(indices),) + shape, np.uint8))
        for s in np.unique(shard):
            sel = shard == s
            u8[sel] = self._maps[s][rows[sel]]
        if flip is not None and flip.any():
            u8[flip] = u8[flip, :, ::-1]
        if self.emit == "uint8":
            return u8, self._labels[indices]
        return self._normalize(u8), self._labels[indices]

    def __getstate__(self):
        d = super().__getstate__()
        d["_maps"] = []
        return d

    def __setstate__(self, d):
        super().__setstate__(d)
        if self.data_path and os.path.exists(
                os.path.join(self.data_path, MANIFEST)):
            self.load_data()   # the maps again


def loader_throughput(loader, n_batches: int = 50) -> dict:
    """The host input pipeline's rate (samples/s) over `n_batches` fills:
    the figure to hold against the step's rate (the prefetch keeps up
    while the loader's rate is the larger). A device feed's counters ride
    along when one has wrapped the loader."""
    loader.run()   # warm the prefetch window
    t0 = time.perf_counter()
    n = 0
    for _ in range(n_batches):
        loader.run()
        n += loader.minibatch_size
    dt = time.perf_counter() - t0
    out = {"samples_per_sec": n / dt, "batches": n_batches,
           "minibatch_size": loader.minibatch_size}
    feed = getattr(loader, "feed_stats", None)
    if feed:
        out["feed"] = dict(feed)
    return out
