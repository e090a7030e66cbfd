"""Image loaders: a class-per-directory image tree, decoded on the host.

The port's counterpart of `veles_tpu/loader/image.py`:
`list_image_tree` scans `<root>/<class>/<image>` (classes and files
sorted, labels the class indices), `decode_image` decodes, scales the
shorter side and crops to a fixed geometry in [-1, 1] (the reference's
ImageNet recipe), and `ImageDirectoryLoader` keeps the index in memory
and decodes each minibatch on the PrefetchingLoader's threads, so the
decode overlaps the card's step. The split (an `image_split`
permutation, validation first) and the mean image (over a strided
subset of up to 64 images) are the JAX package's, so one seed gives the
same batches in both packages. `emit="uint8"` re-quantizes the decoded
pixels to bytes (`rint`, as `pack_image_dataset` does) and offers the
uint8 wire (`wire_format`), the normalize moving to the card: lossy, so
it is the operator's choice, never negotiated on its own.

PIL is imported where an image is decoded, not with the module: the
card's machine need not have it.
"""

from __future__ import annotations

import os
from typing import Any, List, Optional, Tuple

import numpy as np

from veles_tpu_torch import prng
from veles_tpu_torch.loader.base import PrefetchingLoader

IMAGE_EXTS = (".png", ".jpg", ".jpeg", ".bmp", ".gif", ".ppm")


def list_image_tree(root: str) -> Tuple[List[str], List[int], List[str]]:
    """Scan `<root>/<class_name>/*` -> (paths, labels, class_names)."""
    classes = sorted(d for d in os.listdir(root)
                     if os.path.isdir(os.path.join(root, d)))
    paths: List[str] = []
    labels: List[int] = []
    for ci, cname in enumerate(classes):
        cdir = os.path.join(root, cname)
        for fname in sorted(os.listdir(cdir)):
            if fname.lower().endswith(IMAGE_EXTS):
                paths.append(os.path.join(cdir, fname))
                labels.append(ci)
    return paths, labels, classes


def decode_image(path: str, size_hw: Tuple[int, int]) -> np.ndarray:
    """Decode + resize-shorter-side + center crop to (H, W, 3) float32
    in [-1, 1] (the reference's scale-then-crop ImageNet recipe; the JAX
    package's `crop="random"`, which no caller passes, is left out)."""
    from PIL import Image
    h, w = size_hw
    with Image.open(path) as im:
        im = im.convert("RGB")
        iw, ih = im.size
        scale = max(h / ih, w / iw)
        nw, nh = max(w, int(round(iw * scale))), max(h, int(round(ih * scale)))
        im = im.resize((nw, nh))
        x0, y0 = (nw - w) // 2, (nh - h) // 2
        im = im.crop((x0, y0, x0 + w, y0 + h))
        arr = np.asarray(im, np.float32)
    return arr / 127.5 - 1.0


def split_order(n: int, n_validation: int) -> Tuple[np.ndarray, int]:
    """(the tree's indices in loader order, the validation count): an
    `image_split` permutation, its first `n_validation` (at most n - 1)
    the validation set, the rest the train set."""
    n_valid = min(n_validation, n - 1)
    perm = prng.get("image_split").permutation(n)
    return np.concatenate([perm[:n_valid], perm[n_valid:]]), n_valid


class ImageDirectoryLoader(PrefetchingLoader):
    """Streaming minibatch loader over a class-per-directory image tree:
    the index (paths and labels) in memory, the pixels decoded per
    minibatch on the produce threads."""

    def __init__(self, data_path: str = "",
                 size_hw: Tuple[int, int] = (227, 227),
                 n_validation: int = 0, mean_normalize: bool = True,
                 emit: str = "float32", n_workers: int = 4,
                 prefetch: int = 2, **kwargs: Any) -> None:
        super().__init__(n_workers=n_workers, prefetch=prefetch, **kwargs)
        if emit not in ("float32", "uint8"):
            raise ValueError(f"emit must be 'float32' or 'uint8', got "
                             f"{emit!r}")
        self.data_path = data_path
        self.size_hw = tuple(size_hw)
        self.n_validation = n_validation
        self.mean_normalize = mean_normalize
        #: "float32": decoded, mean-subtracted floats leave the host;
        #: "uint8": the decoded pixels re-quantized to bytes, and the
        #: step normalizes them on the card (see the module docstring)
        self.emit = emit
        self.paths: List[str] = []
        self.path_labels: np.ndarray = np.empty(0, np.int64)
        self.class_names: List[str] = []
        self.mean_image: Optional[np.ndarray] = None

    # -- dataset index -------------------------------------------------------

    def load_data(self) -> None:
        paths, labels, self.class_names = list_image_tree(self.data_path)
        if not paths:
            raise FileNotFoundError(
                f"no images under {self.data_path!r} (expect "
                "<root>/<class>/<image> layout)")
        order, n_valid = split_order(len(paths), self.n_validation)
        self.paths = [paths[i] for i in order]
        self.path_labels = np.asarray(labels, np.int64)[order]
        self.class_lengths = [0, n_valid, len(paths) - n_valid]
        self.sample_shape = self.size_hw + (3,)
        if self.mean_normalize:
            self._compute_mean(min(64, len(paths)))

    def _compute_mean(self, n_sample: int) -> None:
        """Mean image over a deterministic strided subset."""
        step = max(1, len(self.paths) // n_sample)
        acc = np.zeros(self.size_hw + (3,), np.float64)
        cnt = 0
        for p in self.paths[::step][:n_sample]:
            acc += decode_image(p, self.size_hw)
            cnt += 1
        self.mean_image = (acc / max(cnt, 1)).astype(np.float32)

    # -- decode --------------------------------------------------------------

    def _produce_rows(self, indices: np.ndarray):
        """Decode, the seeded flip on the raw pixels, then the normalize
        (the memmap loader's order: the mean image is never flipped)."""
        return self._decode_batch(indices, self._flip_mask(indices))

    def _produce_batch(self, indices: np.ndarray):
        return self._decode_batch(indices, None)

    def _decode_batch(self, indices: np.ndarray, flip):
        h, w = self.size_hw
        x = np.zeros((len(indices), h, w, 3), np.float32)
        for i, idx in enumerate(indices):
            x[i] = decode_image(self.paths[int(idx)], self.size_hw)
        if flip is not None and flip.any():
            x[flip] = x[flip, :, ::-1]
        if self.emit == "uint8":
            # raw bytes; the mean moves into the card's prologue
            return (np.rint((x + 1.0) * 127.5).astype(np.uint8),
                    self.path_labels[indices])
        if self.mean_image is not None:
            x -= self.mean_image
        return x, self.path_labels[indices]

    def wire_format(self):
        """The uint8 wire's offer, only where `emit="uint8"` was chosen
        (the re-quantization is lossy)."""
        if self.emit != "uint8":
            return None
        return {"emit": "uint8",
                "normalize": {"scale": 1.0 / 127.5, "offset": -1.0,
                              "mean": self.mean_image}}
