"""Character-sequence loader of the char-transformer.

The port's counterpart of `veles_tpu/loader/text.py`: the same
deterministic synthetic text, the same vocabulary (the text's sorted
characters), the same (seq_len + 1)-character windows — x the one-hot
characters [:-1], y the next characters [1:] — laid out
test|validation|train with the LAST windows in validation, and labels
emitted flat, (N·seq_len,), for the per-token loss.
"""

from __future__ import annotations

from typing import Any, Optional

import numpy as np

from veles_tpu_torch.loader.fullbatch import FullBatchLoader


def synthetic_text(n_chars: int = 20000, seed: int = 97) -> str:
    """Deterministic structured text: words of a small alphabet drawn
    from a seeded stream, space-joined and cut to `n_chars`."""
    rng = np.random.RandomState(seed)
    words = ["the", "cat", "sat", "on", "mat", "dog", "ran", "far",
             "sun", "set", "red", "fox", "big", "box"]
    out = []
    total = 0   # sum(len(w) + 1 for w in out), kept as it grows
    while total < n_chars:
        out.append(words[rng.randint(len(words))])
        total += len(out[-1]) + 1
    return " ".join(out)[:n_chars]


class CharSequenceLoader(FullBatchLoader):
    """Chops `text` into (seq_len+1)-char windows: x = one-hot chars[:-1],
    y = chars[1:] (flattened). Builds its own vocabulary."""

    def __init__(self, text: Optional[str] = None, seq_len: int = 32,
                 n_validation: int = 50, **kwargs: Any) -> None:
        super().__init__(**kwargs)
        self.text = text if text is not None else synthetic_text()
        self.seq_len = seq_len
        self.n_validation = n_validation
        self.vocab = sorted(set(self.text))
        self.char_to_id = {c: i for i, c in enumerate(self.vocab)}

    @property
    def n_vocab(self) -> int:
        return len(self.vocab)

    def load_data(self) -> None:
        ids = np.array([self.char_to_id[c] for c in self.text], np.int64)
        t = self.seq_len
        n_seq = (len(ids) - 1) // t
        x_ids = ids[:n_seq * t].reshape(n_seq, t)
        y_ids = ids[1:n_seq * t + 1].reshape(n_seq, t)
        x = np.zeros((n_seq, t, self.n_vocab), np.float32)
        np.put_along_axis(x, x_ids[:, :, None], 1.0, axis=2)
        n_valid = min(self.n_validation, n_seq - 1)
        n_train = n_seq - n_valid
        # the last windows go to validation, so the two texts never overlap
        order = np.concatenate([np.arange(n_train, n_seq),
                                np.arange(0, n_train)])
        self.bind_arrays(x[order], y_ids[order], 0, n_valid, n_train)

    def fill_minibatch(self, indices: np.ndarray) -> None:
        self.minibatch_data = self.data[indices]
        # flat labels: (N, T) -> (N*T,) for the per-token loss
        self.minibatch_labels = self.labels[indices].reshape(-1)
