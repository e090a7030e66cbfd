"""Loader base: the minibatch engine, reduced to what serving and the
fused training loop need.

The port's counterpart of `veles_tpu/loader/base.py`: the three sample
classes (TEST=0, VALIDATION=1, TRAIN=2), the seeded per-epoch shuffle of
the train set, and static-size minibatches whose final one per class wraps
around with a `minibatch_valid` pad mask. The index math and every draw
from `prng.get()` happen in the JAX package's order, so the same seed
gives the same minibatch sequence — and leaves the default generator in
the same state for the weight fills that follow. `minibatch_class`,
`last_minibatch` and `class_lengths` drive the Decision.

The loader is a unit of the granular graph (`AcceleratedUnit`, with the
JAX `Loader`'s `IDistributable` job-piece hooks): each pulse produces the
next minibatch of the schedule into `minibatch_data` / `minibatch_labels`
/ `minibatch_valid`, host numpy arrays the first forward unit and the
evaluator link to, and the fused loop calls the same `run()` through the
device feed. `last_minibatch`, `epoch_ended` and `not_train` are
`mutable.Bool`s (`BoolField`s), the gates of the JAX package's graph:
`not_train` skips the gradient units on validation and test minibatches.

`PrefetchingLoader` is the counterpart of the JAX package's: minibatch
production on background threads with `prefetch` batches of exact
lookahead (the schedule within an epoch is known), and the seeded
horizontal flip of train rows (`hflip`) by the same integer hash, so one
seed flips the same rows in both packages. `wire_format()` is the uint8
wire's offer to the device feed (loader/device_feed.py).

A pickle (a snapshot) keeps the cursor, the schedule and the shuffled
indices of the last batch the loop trained, and drops the batch itself,
the produce threads and their lookahead: with the feed's `prefetch()`
after the Decision, a snapshot taken there holds the cursor of the
consumed batch + 1, and the restored loader produces from it again
(the exact-resume window). Class-balanced
sampling comes with a later slice.

Data-parallel production (`local_rows_fn`, JAX base.py:264-345): a dp
run (parallel/fused.py) sets it to the step's `local_rows`, and a rank
then produces only the rows of the global minibatch its data shard
trains on, the others zero-filled (the step never reads them), so the
host work divides by the ranks. Not pickled: the next run wires it.
"""

from __future__ import annotations

import threading
from concurrent.futures import CancelledError, ThreadPoolExecutor
from typing import Any, Dict, List, Optional, Tuple

import numpy as np

from veles_tpu_torch import prng
from veles_tpu_torch.accelerated_units import AcceleratedUnit
from veles_tpu_torch.distributable import IDistributable
from veles_tpu_torch.mutable import BoolField

TEST, VALIDATION, TRAIN = 0, 1, 2


class Loader(AcceleratedUnit, IDistributable):
    """Subclasses implement `load_data()` (fill `class_lengths` and
    `sample_shape`) and `fill_minibatch(indices)`."""

    #: the gates the Decision and the gradient units read
    last_minibatch = BoolField()
    epoch_ended = BoolField()
    #: True on validation and test minibatches
    not_train = BoolField()

    def __init__(self, minibatch_size: int = 100,
                 shuffle_train: bool = True,
                 name: Optional[str] = None, workflow=None) -> None:
        super().__init__(workflow, name=name)
        self.minibatch_size = int(minibatch_size)
        self.shuffle_train = shuffle_train
        self.class_lengths: List[int] = [0, 0, 0]
        #: per-sample shape every minibatch row (and every served request
        #: row) has
        self.sample_shape: Tuple[int, ...] = ()
        self.minibatch_data: Optional[np.ndarray] = None
        self.minibatch_labels: Optional[np.ndarray] = None
        self.minibatch_indices: Optional[np.ndarray] = None
        #: (minibatch_size,) 0/1 pad mask: 0 on wrap-around filler rows
        self.minibatch_valid: Optional[np.ndarray] = None
        self.minibatch_class = TRAIN
        self.last_minibatch = False
        self.epoch_ended = False
        self.not_train = False
        self.epoch_number = 0
        self._schedule: List[Tuple[int, int, bool]] = []
        self._cursor = 0
        self._indices_per_class: List[np.ndarray] = [
            np.empty(0, np.int64)] * 3
        #: `(shape, dtype) -> ndarray` for the minibatch data, set by the
        #: device feed for a run (its pinned pool: a gather writes there
        #: and the upload needs no host copy); None allocates with numpy
        self.out_alloc = None

    def empty_minibatch(self, shape, dtype) -> np.ndarray:
        """An uninitialized array for minibatch data: from `out_alloc`
        when the feed set one."""
        alloc = self.out_alloc
        return np.empty(shape, dtype) if alloc is None else alloc(shape,
                                                                  dtype)

    # -- subclass contract ---------------------------------------------------

    def load_data(self) -> None:
        raise NotImplementedError

    def fill_minibatch(self, indices: np.ndarray) -> None:
        raise NotImplementedError

    def wire_format(self) -> Optional[Dict[str, Any]]:
        """The uint8-over-the-wire offer for the device feed: loaders
        that can emit raw uint8 minibatches return {"emit": "uint8",
        "normalize": {"scale", "offset", "mean"}}, the affine on the card
        (`parallel.fused.apply_input_normalize`) that reproduces their
        host float path, and the host-to-card bytes drop 4x. None (the
        default) keeps the host float wire."""
        return None

    def __getstate__(self):
        d = super().__getstate__()
        # the feed's counters are process-local timings, its allocator
        # the run's
        d.pop("feed_stats", None)
        d["out_alloc"] = None
        # the batch of the moment (in the feed's pinned memory during a
        # run): the cursor says which comes next, and run() produces it
        d["minibatch_data"] = d["minibatch_labels"] = None
        # a run's negotiated wire (StandardWorkflow._run_with_step) stays
        # with the run: pickle the emit the loader was constructed with
        pristine = d.pop("_emit_pristine", None)
        if pristine is not None:
            d["emit"] = pristine
        d["_restored"] = True
        return d

    # -- lifecycle -----------------------------------------------------------

    def initialize(self, device=None, **kwargs: Any) -> Optional[bool]:
        """Load the data; a fresh loader then lays out its indices and
        draws its first epoch's shuffle, a restored one (a snapshot's)
        keeps the schedule, cursor and shuffle it carries, which another
        draw or a cursor reset would fork from the uninterrupted run
        (JAX loader/base.py:125-158)."""
        self.load_data()
        restored = self.__dict__.pop("_restored", False) \
            and bool(self._schedule)
        if not restored:
            offset = 0
            for cls in (TEST, VALIDATION, TRAIN):
                n = self.class_lengths[cls]
                self._indices_per_class[cls] = np.arange(
                    offset, offset + n, dtype=np.int64)
                offset += n
            self._start_epoch()
        return super().initialize(device=device, **kwargs)

    def _start_epoch(self) -> None:
        if self.shuffle_train:
            prng.get().shuffle(self._indices_per_class[TRAIN])
        self._schedule = []
        for cls in (TEST, VALIDATION, TRAIN):
            n = self.class_lengths[cls]
            if n == 0:
                continue
            n_batches = -(-n // self.minibatch_size)  # ceil
            for b in range(n_batches):
                self._schedule.append((cls, b, b == n_batches - 1))
        self._cursor = 0

    def run(self) -> None:
        """Produce the next minibatch of the schedule (one code path for
        both backends: host index math and host arrays)."""
        cls, b, last = self._schedule[self._cursor]
        idx = self._indices_per_class[cls]
        lo = b * self.minibatch_size
        take = np.arange(lo, lo + self.minibatch_size) % len(idx)
        chosen = idx[take]
        self.minibatch_class = cls
        self.last_minibatch = last
        self.not_train = cls != TRAIN
        self.minibatch_indices = chosen
        self.minibatch_valid = (np.arange(lo, lo + self.minibatch_size)
                                < len(idx)).astype(np.float32)
        self.fill_minibatch(chosen)
        self._cursor += 1
        self.epoch_ended = self._cursor >= len(self._schedule)
        if self.epoch_ended:
            self.epoch_number += 1
            self._start_epoch()

    # -- the JAX Loader's IDistributable job piece ----------------------------

    def generate_data_for_slave(self, slave: Any = None) -> Any:
        return {"indices": self.minibatch_indices}

    def apply_data_from_master(self, data: Any) -> None:
        if data and "indices" in data:
            self.fill_minibatch(np.asarray(data["indices"]))

    def generate_data_for_master(self) -> Any:
        """This process's epoch and minibatch accounting."""
        return {"epoch_number": self.epoch_number,
                "cursor": int(self._cursor),
                "rows_decoded": int(getattr(self, "rows_decoded", 0))}


class PrefetchingLoader(Loader):
    """Loader whose minibatch production runs on `n_workers` background
    threads with `prefetch` batches of exact lookahead. Subclasses
    implement `_produce_batch(indices) -> (x, y)` (a memmap gather, ...)
    or override `_produce_rows`."""

    def __init__(self, n_workers: int = 2, prefetch: int = 2,
                 hflip: bool = False, **kwargs: Any) -> None:
        super().__init__(**kwargs)
        self.n_workers = n_workers
        self.prefetch = prefetch
        #: seeded horizontal flip of TRAIN samples (never validation or
        #: test ones), on the produce threads
        self.hflip = hflip
        self._hflip_seed = 0
        self._pool: Optional[ThreadPoolExecutor] = None
        #: cursor -> (indices, future) of the lookahead
        self._pending: dict = {}
        #: data-parallel production: `local_rows_fn(n) -> bool (n,)` marks
        #: the global minibatch rows this rank trains on (set by a dp
        #: run); None produces every row
        self.local_rows_fn = None
        #: rows produced (tests, observability)
        self.rows_decoded = 0
        #: guards rows_decoded against the produce threads; made here and
        #: on unpickling, never lazily on a produce thread
        self._count_lock = threading.Lock()

    def initialize(self, device=None, **kwargs: Any) -> Optional[bool]:
        # the "hflip" stream's one draw comes before the shuffle, as in
        # the JAX package, so the stream registers at the same index; a
        # restored loader keeps its seed (the pickled stream is past it)
        if self.hflip and not self.__dict__.get("_restored"):
            self._hflip_seed = int(prng.get("hflip").randint(0, 2 ** 31))
        return super().initialize(device=device, **kwargs)

    def _produce_batch(self, indices: np.ndarray):
        raise NotImplementedError

    def _flip_mask(self, indices: np.ndarray) -> Optional[np.ndarray]:
        """Per-(sample, epoch) flip coins for TRAIN rows, None when the
        flip is off: a stateless integer hash, so the produce threads
        share no generator, a re-visit within an epoch flips alike and
        the next epoch draws anew. The JAX package's hash, bit for
        bit."""
        if not self.hflip:
            return None
        train_lo = self.class_lengths[TEST] + self.class_lengths[VALIDATION]
        h = (indices.astype(np.uint64) * np.uint64(2654435761)
             + np.uint64(self.epoch_number + 1) * np.uint64(0x9E3779B9)
             + np.uint64(self._hflip_seed))
        h ^= h >> np.uint64(15)
        h *= np.uint64(0x2545F4914F6CDD1D)
        flip = ((h >> np.uint64(32)) & np.uint64(1)).astype(bool)
        flip &= indices >= train_lo
        return flip

    def _augment(self, x: np.ndarray, indices: np.ndarray) -> np.ndarray:
        """Seeded horizontal flip of TRAIN rows (see _flip_mask)."""
        if x.ndim < 3:
            return x
        flip = self._flip_mask(indices)
        if flip is not None and flip.any():
            x = np.ascontiguousarray(x)
            x[flip] = x[flip, :, ::-1]
        return x

    def _produce_rows(self, indices: np.ndarray):
        """The rows of exactly these indices (a subclass hook; the default
        produces and augments)."""
        x, y = self._produce_batch(indices)
        return self._augment(x, indices), y

    def local_rows_mask(self, n: int) -> np.ndarray:
        """Which of `n` global minibatch rows this process produces (all
        of them outside a data-parallel run)."""
        fn = self.local_rows_fn
        return np.ones(n, bool) if fn is None else np.asarray(fn(n))

    def _produce(self, indices: np.ndarray):
        if self.local_rows_fn is not None:
            mask = self.local_rows_mask(len(indices))
            if not mask.all():
                x, y = self._produce_rows(indices[mask])
                with self._count_lock:
                    self.rows_decoded += int(mask.sum())
                fx = np.zeros((len(indices),) + x.shape[1:], x.dtype)
                fy = np.zeros((len(indices),) + y.shape[1:], y.dtype)
                fx[mask] = x
                fy[mask] = y
                return fx, fy
        x, y = self._produce_rows(indices)
        with self._count_lock:
            self.rows_decoded += len(indices)
        return x, y

    def _indices_at(self, cursor: int) -> Optional[np.ndarray]:
        if cursor >= len(self._schedule):
            return None
        cls, b, _ = self._schedule[cursor]
        idx = self._indices_per_class[cls]
        lo = b * self.minibatch_size
        take = np.arange(lo, lo + self.minibatch_size) % len(idx)
        return idx[take]

    def fill_minibatch(self, indices: np.ndarray) -> None:
        if self._pool is None:
            self._pool = ThreadPoolExecutor(
                max_workers=self.n_workers,
                thread_name_prefix=f"{self.name}-produce")
        pend = self._pending.pop(self._cursor, None)
        # the lookahead holds the schedule's indices: a caller asking for
        # others gets those
        fut = (pend[1] if pend is not None
               and np.array_equal(pend[0], indices) else None)
        if pend is not None and fut is None:
            pend[1].cancel()
        try:
            x, y = (fut.result() if fut is not None
                    else self._produce(indices))
        except CancelledError:
            # stop() from another thread cancelled the lookahead
            x, y = self._produce(indices)
        for ahead in range(1, self.prefetch + 1):
            pos = self._cursor + ahead
            if pos in self._pending:
                continue
            nxt = self._indices_at(pos)
            if nxt is None:
                break
            try:
                self._pending[pos] = (nxt, self._pool.submit(
                    self._produce, nxt))
            except RuntimeError:     # the pool was shut down by stop()
                break
        self.minibatch_data = x
        self.minibatch_labels = y

    def _drop_lookahead(self) -> None:
        for _, fut in self._pending.values():
            fut.cancel()
        self._pending.clear()

    def run(self) -> None:
        super().run()
        if self.epoch_ended:
            # a new shuffle: the lookahead is stale
            self._drop_lookahead()

    def set_emit(self, emit: str) -> None:
        """Switch the wire dtype between runs (the device feed's uint8
        negotiation), dropping lookahead produced in the old one. No-op
        for loaders without an `emit` or when it is unchanged."""
        if getattr(self, "emit", None) in (None, emit):
            return
        self.emit = emit
        self._drop_lookahead()

    def stop(self) -> None:
        if self._pool is not None:
            self._pool.shutdown(wait=False, cancel_futures=True)
            self._pool = None
        self._pending.clear()

    def __getstate__(self):
        d = super().__getstate__()
        d["_pool"] = None
        d["_pending"] = {}
        d["_count_lock"] = None
        d["local_rows_fn"] = None
        return d

    def __setstate__(self, d):
        super().__setstate__(d)
        self._count_lock = threading.Lock()
