"""DeviceFeed: the asynchronous host-to-card input pipeline.

The port's counterpart of `veles_tpu/loader/device_feed.py`. `DeviceFeed`
wraps a Loader and yields card-resident batches one step ahead: right
after step k is dispatched (the card still runs it), the training loop
calls `prefetch()`, which takes batch k+1 from the loader (whose
PrefetchingLoader threads gathered it meanwhile) and issues its upload,
so the copy runs under step k. Each `FeedBatch` carries the Decision
metadata of the batch it holds (`minibatch_class`, `last_minibatch`,
`epoch_ended`, the pad mask), and `next()` replays it onto the loader, so
the bookkeeping describes the batch being trained, not the one being
prefetched.

`prefetch()` is a call of its own at the bottom of the training loop,
after the Decision window, so that a snapshot taken there would pickle a
loader cursor at the consumed batch + 1, as the synchronous loop did.

The upload (`make_batch_put`), on the card:

- x, y and w lie in pinned host buffers of a pool (`PinnedPool`): the
  feed hands the pool's allocator to the loader (`Loader.out_alloc`),
  whose gather writes each batch straight into a pinned buffer; an array
  from elsewhere is copied into one first. A buffer returns to the pool
  when its array is freed and is handed out again only after the event
  of its last upload has completed;
- the uploads are `non_blocking` copies on a dedicated `torch.cuda.Stream`,
  into device tensors allocated on that stream and marked with
  `record_stream` for the compute stream, so the caching allocator hands
  their memory out again only after the compute stream's work queued at
  their release is done;
- an event recorded after the copies is waited on by the compute stream
  before anything queued later (the step that reads the batch) runs; the
  host does not wait.

If a buffer cannot be pinned or the stream cannot be made, it raises:
there is no synchronous pageable fallback on the card. On the CPU the
put is a plain `torch.as_tensor`.

Wire format: when the loader offers `wire_format()` (the memmap loader),
`StandardWorkflow` switches it to uint8 emission and builds the step with
the matching normalize prologue: the raw bytes cross the bus, 4x fewer
than the f32 wire's, and `stats()["bytes_per_batch"]` shows it.
`make_input_put`, the serving ring's single-input twin, comes with the
serving slice.
"""

from __future__ import annotations

import threading
import time
import weakref
from collections import deque
from typing import Any, Callable, Dict, List, Optional, Tuple

import numpy as np
import torch

from veles_tpu_torch.loader.base import TRAIN

#: how many trailing per-epoch counter rows stats() keeps
_EPOCH_LOG_KEEP = 8


class FeedBatch:
    """One fed minibatch and the Decision metadata that describes it
    (taken when it was produced: the loader has moved on since)."""

    __slots__ = ("x", "y", "w", "w_host", "minibatch_class",
                 "last_minibatch", "epoch_ended", "bytes_h2d",
                 "loader_block_s")

    def __init__(self) -> None:
        self.x = self.y = self.w = None
        self.w_host: Optional[np.ndarray] = None
        self.minibatch_class = TRAIN
        self.last_minibatch = False
        self.epoch_ended = False
        self.bytes_h2d = 0
        self.loader_block_s = 0.0


class PinnedPool:
    """Pinned host buffers handed out as numpy arrays. A buffer comes back
    to the pool when its array is freed, and is handed out again only
    after the event of its last upload has completed. Thread-safe: the
    loader's produce threads take buffers, the training loop's thread
    frees them."""

    def __init__(self) -> None:
        self._lock = threading.Lock()
        #: (shape, dtype) -> [(pinned tensor, event of its last upload)]
        self._free: Dict[tuple, list] = {}
        #: data pointer of a handed-out array -> its pinned tensor
        self._out: Dict[int, torch.Tensor] = {}
        #: data pointer -> event of the last upload from that buffer
        self._events: Dict[int, Any] = {}
        #: pinned buffers allocated so far (observability)
        self.allocated = 0

    def empty(self, shape, dtype) -> np.ndarray:
        """An uninitialized array of `shape` and `dtype` in pinned
        memory."""
        key = (tuple(int(n) for n in shape), np.dtype(dtype).str)
        with self._lock:
            free = self._free.get(key)
            t, ev = free.pop() if free else (None, None)
        if t is None:
            t = torch.empty(key[0], pin_memory=True, dtype=torch.from_numpy(
                np.empty(0, dtype)).dtype)
            if not t.is_pinned():
                raise RuntimeError("the feed's host buffers could not be "
                                   "pinned")
            with self._lock:
                self.allocated += 1
        elif ev is not None:
            # the buffer's last upload may still read it
            ev.synchronize()
        arr = t.numpy()
        ptr = arr.__array_interface__["data"][0]
        with self._lock:
            self._out[ptr] = t
        weakref.finalize(arr, self._give_back, key, ptr)
        return arr

    def _give_back(self, key, ptr) -> None:
        with self._lock:
            t = self._out.pop(ptr)
            self._free.setdefault(key, []).append(
                (t, self._events.pop(ptr, None)))

    def tensor_of(self, arr: np.ndarray) -> Optional[torch.Tensor]:
        """The pinned tensor behind `arr` when `arr` is one of this pool's
        arrays, whole; else None."""
        ptr = arr.__array_interface__["data"][0]
        with self._lock:
            t = self._out.get(ptr)
        if t is None or tuple(t.shape) != arr.shape \
                or t.numpy().dtype != arr.dtype:
            return None
        return t

    def note_upload(self, arr: np.ndarray, event) -> None:
        with self._lock:
            self._events[arr.__array_interface__["data"][0]] = event

    def pinned(self) -> bool:
        """Every buffer of the pool is pinned memory."""
        with self._lock:
            tensors = list(self._out.values()) + [
                t for free in self._free.values() for t, _ in free]
        return all(t.is_pinned() for t in tensors)


class PinnedStreamPut:
    """The card's upload: pinned host buffers (a `PinnedPool`), copies on
    a side stream, an event the compute stream waits on (see the module
    docstring). `empty` is the pool's allocator: a loader that gathers
    into it (`Loader.out_alloc`) hands over arrays that are uploaded
    with no host copy."""

    def __init__(self, device: torch.device) -> None:
        self.device = device
        #: the copy stream (raises where it cannot be made)
        self.stream = torch.cuda.Stream(device=device)
        self.pool = PinnedPool()
        self.empty = self.pool.empty
        #: uploads issued, and arrays that had to be copied into a pinned
        #: buffer first (observability)
        self.uploads = 0
        self.host_copies = 0

    def pinned(self) -> bool:
        return self.pool.pinned()

    def __call__(self, arrays: Tuple) -> Tuple[torch.Tensor, ...]:
        staged = []
        for a in arrays:
            a = np.ascontiguousarray(a)
            t = self.pool.tensor_of(a)
            if t is None:
                # not gathered into the pool: one host copy
                a_pinned = self.pool.empty(a.shape, a.dtype)
                t = self.pool.tensor_of(a_pinned)
                t.copy_(torch.from_numpy(a))
                a = a_pinned
                self.host_copies += 1
            staged.append((a, t))
        compute = torch.cuda.current_stream(self.device)
        out = []
        with torch.cuda.stream(self.stream):
            for _, t in staged:
                d = torch.empty(t.shape, dtype=t.dtype, device=self.device)
                d.copy_(t, non_blocking=True)
                # allocated on the copy stream, read on the compute one
                d.record_stream(compute)
                out.append(d)
            done = torch.cuda.Event()
            done.record(self.stream)
        for a, _ in staged:
            self.pool.note_upload(a, done)
        # the compute stream's queue runs in issue order: what it is
        # given after this (the step reading the batch) waits for the copy
        compute.wait_event(done)
        self.uploads += 1
        return tuple(out)


def make_batch_put(step) -> Callable:
    """The upload of `step`'s data inputs: (x, y, w) host arrays in, the
    matching tensors on the step's device out. On the card a
    `PinnedStreamPut`; on the CPU a plain `torch.as_tensor`."""
    dev = torch.device(step.device)
    if dev.type == "cuda":
        return PinnedStreamPut(dev)

    def put(arrays: Tuple) -> Tuple[torch.Tensor, ...]:
        return tuple(torch.as_tensor(a, device=dev) for a in arrays)
    return put


class DeviceFeed:
    """Asynchronous feed over a Loader. The training loop's contract:

        b = feed.next()          # pop (uploaded one step ago)
        state = step.train(state, b.x, b.y, b.w)   # queued on the card
        ... bookkeeping / snapshot window (the cursor is at b + 1) ...
        feed.prefetch()          # k+1's upload runs under step k

    `put` is `(x, y, w) tuple -> device tuple` (None passes the host
    arrays through, and the step uploads them). `ahead` is the lookahead
    depth: 1 the double buffer, 0 produce on demand (the upload is still
    asynchronous), n keeps n batches pending across the bookkeeping
    window.
    """

    def __init__(self, loader, put: Optional[Callable] = None,
                 ahead: int = 1) -> None:
        self.loader = loader
        self._put = put
        self.ahead = max(0, int(ahead))
        self._queue: deque = deque()
        self._n = 0
        self._on_demand = 0
        self._epochs = 0
        self._bytes = 0
        self._bytes_last = 0
        self._loader_block_s = 0.0
        self._put_block_s = 0.0
        self._device_sync_s = 0.0
        self._epoch_acc = self._new_epoch_acc()
        #: an epoch-ending batch was consumed but its row not yet rolled
        #: (held open so the class pass's device sync noted right after
        #: lands in the epoch it belongs to)
        self._pending_roll = False
        self._epoch_log: List[Dict[str, Any]] = []
        self._last_dtype = None

    @property
    def put(self) -> Optional[Callable]:
        """The upload (a PinnedStreamPut on the card), None for host
        handoff."""
        return self._put

    @staticmethod
    def _new_epoch_acc() -> Dict[str, Any]:
        return {"batches": 0, "bytes_h2d": 0, "loader_block_s": 0.0,
                "device_sync_s": 0.0}

    @classmethod
    def for_step(cls, loader, step, ahead: int = 1) -> "DeviceFeed":
        """A feed uploading to `step`'s device (make_batch_put)."""
        return cls(loader, put=make_batch_put(step), ahead=ahead)

    # -- production -----------------------------------------------------------

    def _produce(self) -> FeedBatch:
        ld = self.loader
        t0 = time.perf_counter()
        ld.run()
        t1 = time.perf_counter()
        x, y, w = ld.minibatch_data, ld.minibatch_labels, ld.minibatch_valid
        b = FeedBatch()
        b.minibatch_class = ld.minibatch_class
        b.last_minibatch = bool(ld.last_minibatch)
        b.epoch_ended = bool(ld.epoch_ended)
        b.w_host = w
        b.bytes_h2d = int(x.nbytes + y.nbytes + w.nbytes)
        if self._put is not None:
            b.x, b.y, b.w = self._put((x, y, w))
        else:
            b.x, b.y, b.w = x, y, w
        t2 = time.perf_counter()
        b.loader_block_s = t1 - t0
        self._loader_block_s += t1 - t0
        self._put_block_s += t2 - t1
        self._n += 1
        self._bytes += b.bytes_h2d
        self._bytes_last = b.bytes_h2d
        self._last_dtype = x.dtype
        return b

    def _flush_epoch(self) -> None:
        """Roll the held-open epoch row (see _pending_roll)."""
        if not self._pending_roll:
            return
        self._pending_roll = False
        self._epochs += 1
        row = {"epoch": self._epochs}
        row.update({k: (round(v, 6) if isinstance(v, float) else v)
                    for k, v in self._epoch_acc.items()})
        self._epoch_log.append(row)
        del self._epoch_log[:-_EPOCH_LOG_KEEP]
        self._epoch_acc = self._new_epoch_acc()
        # loader_throughput() and anything else holding the loader reads
        # the counters from it
        self.loader.feed_stats = self.stats()

    # -- consumption ----------------------------------------------------------

    def next(self) -> FeedBatch:
        """Pop the current batch (uploaded by the previous iteration's
        prefetch(), or produced now when none is pending: the first
        batch, or ahead=0) and replay its Decision metadata onto the
        loader."""
        if not self._queue:
            self._on_demand += 1
            self._queue.append(self._produce())
        b = self._queue.popleft()
        # epoch rows are kept by consumption; the ending row stays open
        # until the next pop or stats(), for the boundary's device sync
        self._flush_epoch()
        acc = self._epoch_acc
        acc["batches"] += 1
        acc["bytes_h2d"] += b.bytes_h2d
        acc["loader_block_s"] += b.loader_block_s
        if b.epoch_ended:
            self._pending_roll = True
        self._replay(b)
        return b

    def prefetch(self) -> None:
        """Produce and upload batches until `ahead` are pending. Call it
        after dispatching the step and after the Decision window."""
        while len(self._queue) < self.ahead:
            self._queue.append(self._produce())

    def _replay(self, b: FeedBatch) -> None:
        """Write batch `b`'s bookkeeping onto the loader, whose cursor is
        `ahead` batches past it."""
        ld = self.loader
        ld.minibatch_class = b.minibatch_class
        # the loader's flags are Bools: these assignments set them
        ld.last_minibatch = b.last_minibatch
        ld.epoch_ended = b.epoch_ended
        ld.not_train = b.minibatch_class != TRAIN
        ld.minibatch_valid = b.w_host

    def note_device_sync(self, seconds: float) -> None:
        """Time the training loop spent waiting for the card (the class
        pass's host sync), so stats() splits blocked time into loader and
        card."""
        self._device_sync_s += seconds
        self._epoch_acc["device_sync_s"] += seconds

    def stop(self) -> None:
        """Drop pending batches and stop the loader's produce threads
        (idempotent)."""
        self._queue.clear()
        self._flush_epoch()
        self.loader.feed_stats = self.stats()
        stop = getattr(self.loader, "stop", None)
        if stop is not None:
            stop()

    # -- observability --------------------------------------------------------

    def stats(self) -> Dict[str, Any]:
        """Counters: batches and bytes fed, whether uint8 crossed the
        bus, time blocked on the loader and on issuing uploads, time
        waiting for the card, and batches produced on demand (1 is the
        unavoidable first; more means the loader fell behind)."""
        self._flush_epoch()
        return {
            "batches": self._n,
            "epochs": self._epochs,
            "ahead": self.ahead,
            "bytes_h2d": self._bytes,
            "bytes_per_batch": self._bytes_last,
            "uint8_wire": bool(self._last_dtype == np.uint8),
            "loader_block_s": round(self._loader_block_s, 6),
            "put_block_s": round(self._put_block_s, 6),
            "device_sync_s": round(self._device_sync_s, 6),
            "on_demand": self._on_demand,
            "epoch_log": list(self._epoch_log),
        }
