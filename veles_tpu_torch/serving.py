"""In-process HTTP inference serving of a workflow's forward, on the card.

The port's counterpart of `veles_tpu/serving.py` on one device. It serves
a fresh workflow (initialized from the seed) or one restored from a
snapshot (`--serve PORT -s SNAPSHOT`), which it moves to the device.

Endpoints:
- POST /predict  {"inputs": [[...], ...]} -> {"outputs": [[...]],
  "classes": [...]} (softmax heads: outputs are probabilities and
  classes the per-row argmax — serving.py:902-945 there)
- POST /rollback re-point the ring at the PREVIOUS weight generation
  (token-guarded; 200 and the restored generation, 409 when none is
  resident)
- GET  /healthz  liveness, dispatch counters and the generation labels
  (live digest and serving-since, previous digest, the swap ledger);
  503 while draining
- GET  /info     model metadata, the wire's and the f32 model bytes, the
  lowerings the forward runs (`variant_table()`) and the kernel launch
  counts

Two dispatch cores (`dispatch=`):

- "ring" (the default): ONE fixed-shape batch of `ring_slots` rows. A
  dispatch loop admits whole queued requests into free slots, pads the
  rest with zeros, runs the forward, and returns each request its rows.
  On the card a round is enqueued whole: the copy of its pinned host
  batch in, the forward, and the copy of its answer out to pinned host
  memory, then an event. The loop enqueues round k+1 before it waits on
  round k's event, so the card runs round k+1 while round k's answers
  are handed out. `max_batch` caps a request's rows (at most the ring).
- "merge": the JAX package's pre-ring core, kept as its baseline:
  queued requests coalesce into one forward per round, padded to a
  power-of-two bucket (`_bucket`), with a `batch_window_ms` straggler
  window when several are queued; `max_batch` and `batch_window_ms` are
  read per round. f32 only, and no hot swap (the params are bound at
  build time).

The wire (`quantize=`, the `serve_forward` op of ops/variants.py):
"f32", "bf16" (params stored and computed in bf16, through the LRN
kernels' bf16 instances) or "int8" (weight-only blockwise codes decoded
to f32 on the card each round). A non-f32 wire rides the ring only, is
refused unserved without a passing equivalence record
(templates.check_equivalence), and is probed at startup against the
f32 forward of the served model: more than 0.05 apart refuses it. The
forward computes in the workflow's dtype (root.common.precision_type,
as the JAX step's compute dtype), in full f32 (no TF32) where that is
float32.

Hot swap (`swap_params`): a candidate workflow is checked off the
serving path, in five stages (geometry against `model_signature`, the
wire transform, placement on the device, then a probe of the candidate
through the live forward on a probe batch of its own against its own
f32 forward: non-finite, then beyond SWAP_PROBE_TOL), and committed as
one pointer swap in the GenerationLedger (serving_gen.py). The ring
reads the params once per round, so each round's upload, forward and
download run under one generation. The outgoing params stay on the
device as the rollback target; `rollback()` (and POST /rollback) swaps
back, bit for bit. Every refusal raises `SwapRefused` after it is
counted, and the current generation keeps serving. serving_watch.py's
WeightWatcher drives swaps from a snapshot mirror.

Robustness: at most `queue_limit` requests in flight (503 beyond it, with
a Retry-After from the measured round latency), a request body above
`max_body` gets 413, a configured `token` must come in `X-Veles-Token`
(403), a queued request that misses `request_timeout_s` gets 503, and
`stop()` drains in-flight rounds before it closes. Localhost by default.

Fleet identity (`replica=`, JAX serving.py:181-196): a replica is not a
process. The launcher's `--serve-replicas N` runs N servers of one
workflow build in one process, each with its own port, ring, generation
ledger and watcher; `replica` names one in `/healthz`, `/info` and its
beacon (serving_router.py), and its per-replica counters (requests,
rejected, latency, the live generation's age: the JAX package's
`veles_serving_replica_*` families) are attributes shown in `/healthz`.
On the card every replica's ring runs on the process's default CUDA
stream: rounds of two replicas are ordered on the card in the order
their loops enqueue them, and each round stages into pinned buffers and
device tensors of its own (`_ring_batch` and `_forward_ring` allocate
them per round), so no replica reads another's. The kernels are built
once per process (ops/kernels.py `build`): `kernel_builds` records the
`nvcc` runs and library loads a server's build caused, 0 for every
replica after the first.

The serialized program (`aot_cache=`, JAX serving.py:183, :505-600):
"auto" (the cache at `serving_aot.default_aot_path()`, i.e.
`$VELES_SERVING_AOT_CACHE` or under HOME) or an index path makes the
ring serve a `torch.export` program of its forward for this (model,
ring, wire) build, loaded from the cache when the signature's entry is
there (`aot_source` "cache", `aot_compiles` 0) and exported and stored
else ("export", 1); the program takes the parameters as inputs, so a
swap and a rollback feed it new ones, and calls K2 / K4 through their
operators. None (the default; the JAX default is "auto") keeps the eager
ring: an export costs seconds, and the port has no compile to spare.
The merge core stays eager, as in the JAX package.

Left out here and kept in ROADMAP: the telemetry registry and /metrics
(the counters are attributes and appear in /healthz), the capacity hint
of /healthz and `mesh=`.
"""

from __future__ import annotations

import hashlib
import json
import math
import threading
import time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Any, Dict, List, Optional

import numpy as np
import torch

from veles_tpu_torch.backends import DeviceLike, device_name, full_f32
from veles_tpu_torch.http_util import check_shared_token
from veles_tpu_torch.logger import Logger
from veles_tpu_torch.ops import kernels, templates, variants
from veles_tpu_torch.serving_aot import (ServingAotCache, call_trees,
                                         export_forward, model_signature,
                                         serve_signature)
from veles_tpu_torch.serving_gen import GenerationLedger


class ServerOverloaded(RuntimeError):
    """queue_limit requests already in flight — shed, don't queue."""

    def __init__(self, msg: str, retry_after: Optional[float] = None
                 ) -> None:
        super().__init__(msg)
        self.retry_after = retry_after


class ServerDraining(RuntimeError):
    """stop() has begun: no new work is admitted."""


class RequestTimeout(RuntimeError):
    """A queued request missed request_timeout_s."""


class SwapRefused(RuntimeError):
    """A hot swap was refused at some stage; the current generation keeps
    serving. `reason`: merge_core / geometry / wire_transform /
    device_put / equivalence / nonfinite / no_previous, and the
    watcher's fetch_failed / verify_failed / import_failed."""

    def __init__(self, reason: str, msg: str) -> None:
        super().__init__(msg)
        self.reason = reason


#: max |candidate - f32 reference| a swap candidate may show on the probe
#: rows: the bound of the startup probe of a non-f32 wire
SWAP_PROBE_TOL = 0.05


def params_digest(params_host) -> str:
    """Content hash of a host parameter tree (tuple of {name: ndarray}
    per layer): the digest a boot generation, or a swap given none,
    serves under. The JAX package's rule, so both give one tree one
    digest."""
    h = hashlib.sha256()
    for layer in params_host:
        for k in sorted(layer):
            a = np.ascontiguousarray(layer[k])
            h.update(k.encode())
            h.update(str(a.shape).encode())
            h.update(a.tobytes())
    return h.hexdigest()


class InferenceServer(Logger):
    """Serve a workflow's forward pass over HTTP."""

    def __init__(self, workflow, host: str = "127.0.0.1", port: int = 0,
                 max_batch: Optional[int] = None,
                 batch_window_ms: float = 2.0, queue_limit: int = 64,
                 request_timeout_s: float = 30.0,
                 token: Optional[str] = None, max_body: int = 32 << 20,
                 dispatch: str = "ring", ring_slots: Optional[int] = None,
                 quantize: str = "f32", device: DeviceLike = None,
                 replica: Optional[str] = None,
                 aot_cache: Any = None) -> None:
        self.workflow = workflow
        #: fleet identity: None for a lone server, else the replica id
        #: its beacon and the router know it by
        self.replica = str(replica) if replica is not None else None
        self.host = host
        self.port = port
        if dispatch not in ("ring", "merge"):
            raise ValueError(f"dispatch must be 'ring' or 'merge' "
                             f"(got {dispatch!r})")
        self.dispatch = dispatch
        if variants.serve_forward_config(quantize) is None:
            raise ValueError(f"quantize must be one of f32/bf16/int8 "
                             f"(got {quantize!r})")
        if quantize != "f32" and dispatch != "ring":
            raise ValueError(
                "quantized serving rides the ring dispatch path (the merge "
                "core is the unquantized pre-ring baseline): use "
                "dispatch='ring' or quantize='f32'")
        self.quantize = quantize
        if dispatch == "merge" and ring_slots is not None:
            raise ValueError(
                "ring_slots sizes the ring dispatch core: use "
                "dispatch='ring' (the merge core batches up to max_batch "
                "per round)")
        # the JAX default cap is 64; the ring alone sets it where no cap
        # is given (the port's ring was its own cap before)
        if max_batch is None:
            max_batch = ring_slots if ring_slots is not None else 64
        self.max_batch = int(max_batch)
        self.batch_window_ms = batch_window_ms
        self._ring_slots = (int(ring_slots) if ring_slots is not None
                            else self.max_batch)
        if self._ring_slots < 1:
            raise ValueError(f"ring_slots must be >= 1 (got {ring_slots})")
        if dispatch == "ring" and self._ring_slots < self.max_batch:
            raise ValueError(
                f"ring_slots ({self._ring_slots}) must hold a whole "
                f"max_batch request ({self.max_batch})")
        self.queue_limit = queue_limit
        self.request_timeout_s = request_timeout_s
        self.token = token
        self.max_body = max_body
        self._httpd: Optional[ThreadingHTTPServer] = None
        self._thread: Optional[threading.Thread] = None
        self._batcher: Optional[threading.Thread] = None
        # merge mode: forwards from handler threads run one at a time
        self._lock = threading.Lock()
        self._cv = threading.Condition()
        self._pending: List[dict] = []
        self._stopping = False
        self._draining = False
        self._inflight = 0
        self._started_at = time.time()
        #: EWMA of the measured per-round latency (s); guarded by _cv
        self._round_s = 0.0
        self.n_dispatches = 0
        self.n_rejected = 0
        self.n_timeouts = 0
        #: blue/green generations: the live (label, params), the previous
        #: pair on the device, the swap counter, the rolled-back pins.
        #: Mutated under _cv; the ring reads `params` once per round
        self._gens = GenerationLedger()
        self.n_swap_refusals = 0
        self._last_swap_refusal: Optional[Dict[str, Any]] = None
        #: per-replica counters (the JAX package's labeled families):
        #: requests admitted, and their summed seconds from admission to
        #: the answer or the failure
        self.n_requests = 0
        self.latency_s_sum = 0.0
        self.latency_n = 0
        #: a serving_watch.WeightWatcher feeding this server, stopped
        #: with it (the launcher's --serve-watch-mirror)
        self.watcher = None
        #: the launcher's fleet (its other servers, watchers and
        #: beacons) when this is its first server: stop() stops it all
        self.fleet = None
        #: the serialized program: None / False (the eager ring), "auto"
        #: or an index path; programs exported by this server, and where
        #: the served one came from ("export" / "cache"; None: eager)
        self._aot_req = aot_cache
        self.aot_compiles = 0
        self.aot_source: Optional[str] = None
        #: host seconds the program took to load, or to export and store
        self.aot_seconds: Optional[float] = None
        self._program = None
        builds = kernels.build_counts()
        self._build(device)
        #: the kernel builds this server's build caused: `nvcc`
        #: processes run and libraries loaded by ops/kernels.py
        self.kernel_builds = {k: v - builds[k]
                              for k, v in kernels.build_counts().items()}

    @property
    def ring_slots(self) -> Optional[int]:
        """Rows in the ring batch (None in merge mode); read-only: it is
        the shape every round runs at."""
        return self._ring_slots if self.dispatch == "ring" else None

    @property
    def n_swaps(self) -> int:
        return self._gens.n_swaps

    @property
    def rolled_back(self) -> set:
        return self._gens.rolled_back

    def _request_cap(self) -> int:
        """Largest admissible request: `max_batch`, within the ring."""
        if self.dispatch == "ring":
            return min(self.max_batch, self._ring_slots)
        return self.max_batch

    # -- build ----------------------------------------------------------------

    def _build(self, device: DeviceLike) -> None:
        wf = self.workflow
        # a fresh workflow is initialized, a restored one (a snapshot's,
        # on the host) moved to the device
        wf.place(device)
        self.device = wf.device
        self._fwd = wf.build_forward()
        self._sample_shape = tuple(wf.loader.sample_shape)
        self._softmax = wf.loss == "softmax"
        #: the geometry a swap candidate must match verbatim
        self._model_sig = model_signature(wf)
        if self.quantize != "f32":
            rec = templates.check_equivalence("serve_forward", self.quantize,
                                              device=self.device)
            if rec.get("status") != "pass":
                raise ValueError(
                    f"serve_forward/{self.quantize} refused unserved: no "
                    f"passing equivalence record "
                    f"({rec.get('error', 'contract failed')}) — the ledger "
                    f"gates every low-byte serving wire")
        self._sv = variants.get("serve_forward", self.quantize).apply
        params_host = wf.params_host()
        prepared, self._shapes = variants.serve_prepare_params(
            self.quantize, params_host)
        self._wire_bytes = variants.serve_param_bytes(prepared)
        self._f32_bytes = variants.serve_param_bytes(params_host)
        with self._cv:
            self._gens.boot(params_digest(params_host),
                            variants.serve_to_device(prepared, self.device))
        if self.dispatch == "ring" and self._aot_req not in (None, False):
            self._build_program()
        # warm + validate now: on the card this builds and launches the
        # kernels, so a build failure fails the start, not a request
        if self.dispatch == "ring":
            host, done = self._forward_ring(self._ring_batch())
            if done is not None:
                done.synchronize()
            if host.shape[0] != self._ring_slots:
                raise RuntimeError(f"forward returned {host.shape[0]} rows "
                                   f"for a {self._ring_slots}-slot ring")
        else:
            self._forward_now(np.zeros((self.max_batch,)
                                       + self._sample_shape, np.float32))
        if self.quantize != "f32":
            # the ledger checked the contract's MLP; this checks the model
            # actually served against its own f32 forward
            err = self._probe_err(self._gens.params, self._fwd.params())
            if err > SWAP_PROBE_TOL:
                raise ValueError(
                    f"serve_forward/{self.quantize} refused: max |quantized"
                    f" - f32| = {err:.3e} on the served model's probe "
                    f"exceeds {SWAP_PROBE_TOL}")
            self.info("quantized serving wire %s: probe max err %.2e vs "
                      "f32 (params %d -> %d bytes)", self.quantize, err,
                      self._f32_bytes, self._wire_bytes)

    def _serve_fn(self, params, xd: torch.Tensor) -> torch.Tensor:
        """The served function: the wire's forward, then the softmax of a
        softmax head (what a serialized program holds)."""
        out = self._sv(params, xd, self._fwd._forward, self._shapes)
        if self._softmax:
            out = torch.softmax(out, dim=-1)
        return out

    def _serve(self, params, xd: torch.Tensor) -> torch.Tensor:
        """The served function on device rows: through the loaded or
        exported program where there is one (in full f32, which the
        program cannot carry: backends.full_f32 sets process flags), else
        eagerly."""
        with torch.inference_mode():
            if self._program is not None:
                with full_f32(self.device):
                    return self._program(xd, params)
            return self._serve_fn(params, xd)

    def _build_program(self) -> None:
        """The ring's serialized program: loaded from the cache under
        this build's signature, else exported at the ring's shape and
        stored (JAX serving.py:562-591)."""
        t0 = time.perf_counter()
        sig = serve_signature(
            self.workflow, None, self._ring_slots, self.quantize,
            self._softmax, self._sample_shape,
            variants={**self._fwd.variant_table(),
                      "serve_forward": self.quantize},
            device=self.device)
        self._aot_signature = sig
        cache = ServingAotCache(None if self._aot_req == "auto"
                                else self._aot_req)
        x = self._ring_batch().to(self.device)
        params = self._gens.params
        program = cache.load(sig, call_trees((x, params))[0])
        if program is None:
            program = export_forward(self._serve_fn, x, params)
            self.aot_compiles += 1
            self.aot_source = "export"
            cache.store(sig, program)
        else:
            self.aot_source = "cache"
        self._program = program.module()
        self.aot_seconds = time.perf_counter() - t0

    def _f32_reference(self, params_f32, xd: torch.Tensor) -> torch.Tensor:
        """The f32 forward of the served model (the reference a non-f32
        wire and a swap candidate are probed against)."""
        with torch.inference_mode():
            out = self._fwd._forward(params_f32, xd)
            if self._softmax:
                out = torch.softmax(out, dim=-1)
        return out

    def _probe_err(self, params, params_f32) -> float:
        """Max |served - f32 reference| over the probe rows: a probe batch
        of the ring's shape (the merge core's max_batch), its first
        min(rows, 8) rows random from a fixed seed (the JAX package's
        RandomState(11)); non-finite outputs give NaN."""
        n = self._ring_slots if self.dispatch == "ring" else self.max_batch
        rows = min(n, 8)
        px = np.zeros((n,) + self._sample_shape, np.float32)
        px[:rows] = np.random.RandomState(11).randn(
            rows, *self._sample_shape).astype(np.float32)
        xd = torch.from_numpy(px).to(self.device)
        got = self._serve(params, xd)[:rows].cpu().numpy()
        if not np.all(np.isfinite(got)):
            return float("nan")
        want = self._f32_reference(params_f32, xd)[:rows].cpu().numpy()
        return float(np.max(np.abs(got - want)))

    def _ring_batch(self) -> torch.Tensor:
        """A fresh zeroed host batch of the ring's shape, pinned when
        serving on the card so the copies in and out are asynchronous."""
        return torch.zeros((self._ring_slots,) + self._sample_shape,
                           dtype=torch.float32,
                           pin_memory=self.device.type == "cuda")

    def _forward_ring(self, x: torch.Tensor):
        """Enqueue one ring round: `x` (host) in, the forward, the answer
        out to host. Returns `(host_out, done)`: on the card `host_out` is
        pinned and holds the answer once the event `done` has completed;
        on the CPU it is ready and `done` is None."""
        # the one lock-free read of the live params: once per round, so
        # the whole round runs under one generation (a swap commits the
        # pointer under _cv; either side is a valid generation)
        params = self._gens.params
        xd = x.to(self.device, non_blocking=True)
        out = self._serve(params, xd)
        if self.device.type != "cuda":
            return out, None
        host = torch.empty(out.shape, dtype=out.dtype, pin_memory=True)
        host.copy_(out, non_blocking=True)
        done = torch.cuda.Event()
        done.record(torch.cuda.current_stream(self.device))
        return host, done

    def _forward_now(self, x: np.ndarray) -> np.ndarray:
        """One synchronous forward of host rows (the merge core)."""
        xd = torch.from_numpy(np.ascontiguousarray(x)).to(self.device)
        return self._serve(self._gens.params, xd).cpu().numpy()

    # -- hot swap: blue/green weight generations ------------------------------

    def _refuse_swap(self, reason: str, msg: str) -> None:
        """Record one refused swap and raise: every refusal ends here, so
        the current generation keeps serving and the refusal is counted."""
        with self._cv:
            self.n_swap_refusals += 1
            self._last_swap_refusal = {"reason": reason,
                                       "error": msg[:300],
                                       "at": time.time()}
            live = self._gens.generation["digest"]
        self.warning("hot swap refused (%s): %s — still serving generation "
                     "%s", reason, msg, live[:12])
        raise SwapRefused(reason, msg)

    def note_swap_refused(self, reason: str, msg: str = "") -> None:
        """The watcher's refusals (fetch, verify, import), before any
        candidate workflow existed, land in the same ledger."""
        try:
            self._refuse_swap(reason, msg)
        except SwapRefused:
            pass

    def swap_params(self, workflow, *, digest: Optional[str] = None,
                    source: str = "watcher") -> Dict[str, Any]:
        """Hot-swap the served params to `workflow`'s between rounds: the
        candidate is checked off the serving path (geometry, the wire
        transform, placement, a probe through the live forward on its own
        probe batch against its own f32 forward) and committed as one
        pointer swap; the outgoing params stay on the device as the
        rollback target. Raises SwapRefused (counted) on any failure."""
        if self.dispatch != "ring":
            self._refuse_swap(
                "merge_core", "hot swap rides the ring dispatch core (the "
                "merge baseline binds params at build time)")
        # 1. geometry: the layer/param shapes and dtypes served, verbatim
        if model_signature(workflow) != self._model_sig:
            self._refuse_swap(
                "geometry", "candidate layer/param geometry does not match "
                "the served model's signature (a resized model needs a new "
                "server, not a swap)")
        params_host = workflow.params_host()
        # 2. the ledger-gated wire transform, on the host
        try:
            prepared, _ = variants.serve_prepare_params(self.quantize,
                                                        params_host)
        except Exception as e:  # noqa: BLE001 — a refusal, never a crash
            self._refuse_swap("wire_transform",
                              f"serve wire transform failed: {e}")
        # 3. placement on the device
        try:
            new_dev = variants.serve_to_device(prepared, self.device)
            f32_dev = new_dev if self.quantize == "f32" else \
                variants.serve_to_device(
                    variants.serve_prepare_params("f32", params_host)[0],
                    self.device)
        except Exception as e:  # noqa: BLE001
            self._refuse_swap("device_put", f"device placement failed: {e}")
        # 4. the probe (non-finite first: NaN params agree with their own
        # NaN reference, so the bound alone would wave them through)
        try:
            err = self._probe_err(new_dev, f32_dev)
        except Exception as e:  # noqa: BLE001
            self._refuse_swap("equivalence", f"candidate probe failed: {e}")
        del f32_dev
        if math.isnan(err):
            self._refuse_swap("nonfinite", "candidate forward produced "
                              "non-finite values on the probe rows")
        if err > SWAP_PROBE_TOL:
            self._refuse_swap(
                "equivalence", f"max |wire - f32| = {err:.3e} on the "
                f"candidate's probe exceeds {SWAP_PROBE_TOL}")
        # 5. commit: one pointer swap; the next round serves it
        if digest is None:
            digest = params_digest(params_host)
        with self._cv:
            gen = self._gens.commit(digest, source, new_dev)
        self.info("hot swap applied: serving generation %s (from %s, probe "
                  "err %.2e)", digest[:12], source, err)
        return gen

    def generation(self) -> Dict[str, Any]:
        """The live generation label (digest, since, source)."""
        with self._cv:
            return self._gens.snapshot()

    def rollback(self) -> Dict[str, Any]:
        """Re-point the ring at the previous generation (its params never
        left the device): the same between-rounds pointer swap, no host
        work; a second rollback rolls forward again. Refused
        (`no_previous`) before any swap."""
        with self._cv:
            have_prev = self._gens.prev_params is not None
        if not have_prev:
            self._refuse_swap("no_previous", "no previous generation is "
                              "resident (nothing was ever swapped in)")
        with self._cv:
            gen, outgoing = self._gens.rollback()
        self.info("rollback applied: serving generation %s (was %s)",
                  gen["digest"][:12], outgoing["digest"][:12])
        return gen

    # -- admission ------------------------------------------------------------

    def _bucket(self, n: int) -> int:
        """Merge mode: the smallest power of two >= n, at most max_batch."""
        b = 1
        while b < n:
            b *= 2
        return min(b, self.max_batch)

    def _note_round(self, seconds: float) -> None:
        """Fold one measured round into the Retry-After EWMA."""
        with self._cv:
            self._round_s = (seconds if self._round_s <= 0
                             else 0.8 * self._round_s + 0.2 * seconds)

    def _retry_after_locked(self) -> Optional[float]:
        """Seconds until capacity likely frees: measured round latency ×
        the rounds the queued backlog needs (called under _cv)."""
        if self._round_s <= 0:
            return None
        rows = sum(len(it["x"]) for it in self._pending)
        per_round = max(1, self._ring_slots if self.dispatch == "ring"
                        else self.max_batch)
        return (1 + rows // per_round) * self._round_s

    def _shed_locked(self) -> None:
        """The one rejection rule (called under _cv)."""
        if self._draining or self._stopping:
            self.n_rejected += 1
            raise ServerDraining("server draining")
        if self._inflight >= self.queue_limit:
            self.n_rejected += 1
            raise ServerOverloaded(
                f"overloaded: {self._inflight} requests in flight "
                f"(queue_limit {self.queue_limit})",
                retry_after=self._retry_after_locked())

    def shed_check(self) -> None:
        with self._cv:
            self._shed_locked()

    def predict(self, inputs) -> Dict[str, Any]:
        x = np.asarray(inputs, np.float32)
        if x.ndim == 0 or x.shape[1:] != self._sample_shape:
            raise ValueError(
                f"expected per-sample shape {self._sample_shape}, got "
                f"{x.shape[1:]}")
        cap = self._request_cap()
        if not 1 <= len(x) <= cap:
            raise ValueError(f"batch of {len(x)} rows: expected 1..{cap}")
        n = len(x)
        t_admit = time.perf_counter()
        with self._cv:
            self._shed_locked()
            self._inflight += 1
            self.n_requests += 1
        try:
            if self.dispatch == "ring" or self.batch_window_ms > 0:
                out = self._predict_batched(x)
            else:
                out = self._forward_rows(x)
        finally:
            elapsed = time.perf_counter() - t_admit
            with self._cv:
                self._inflight -= 1
                self.latency_s_sum += elapsed
                self.latency_n += 1
                self._cv.notify_all()   # drain waiters watch this count
        out = out.reshape(n, -1)
        resp: Dict[str, Any] = {"outputs": out.tolist()}
        if self._softmax:
            resp["classes"] = out.argmax(axis=-1).tolist()
        return resp

    def _dispatch_direct(self, x: np.ndarray) -> np.ndarray:
        """Synchronous dispatch for a server whose loop thread is not
        running (never start()ed): nothing to coalesce with."""
        if self.dispatch == "merge":
            return self._forward_rows(x)
        item = {"x": x, "out": None, "err": None, "done": threading.Event()}
        self._ring_deliver(self._ring_dispatch([item]))
        if item["err"] is not None:
            raise item["err"]
        return item["out"]

    def _predict_batched(self, x: np.ndarray) -> np.ndarray:
        item = {"x": x, "out": None, "err": None, "abandoned": False,
                "done": threading.Event()}
        with self._cv:
            if self._stopping:
                raise RuntimeError("server stopping")
            direct = self._batcher is None
            if not direct:
                self._pending.append(item)
                self._cv.notify()
        if direct:
            return self._dispatch_direct(x)
        timeout = self.request_timeout_s or None
        if not item["done"].wait(timeout):
            with self._cv:
                if not item["done"].is_set():
                    item["abandoned"] = True
                    # by identity: `in`/`remove` would compare the items'
                    # input arrays with ==
                    self._pending = [it for it in self._pending
                                     if it is not item]
                    self.n_timeouts += 1
                    raise RequestTimeout(
                        f"request timed out after {timeout:.1f}s in queue")
        if item["err"] is not None:
            raise item["err"]
        return item["out"]

    # -- the slot ring --------------------------------------------------------

    def _ring_dispatch(self, take: List[dict]):
        """Stage the admitted requests into a fresh zero-padded ring
        batch and enqueue the round. Returns the in-flight round."""
        x = self._ring_batch()
        xs = x.numpy()
        lo = 0
        for it in take:
            xs[lo:lo + len(it["x"])] = it["x"]
            lo += len(it["x"])
        with self._cv:
            self.n_dispatches += 1
        t0 = time.perf_counter()
        try:
            out = self._forward_ring(x)
        except Exception as e:  # noqa: BLE001 — surface to every waiter
            out = e
        return take, out, t0

    def _ring_deliver(self, round_) -> None:
        """Wait for a round's answer and hand each request its rows."""
        take, out, t0 = round_
        try:
            if isinstance(out, Exception):
                raise out
            host, done = out
            if done is not None:
                done.synchronize()      # this round's copy out has landed
            host = host.numpy()
        except Exception as e:  # noqa: BLE001 — surface to every waiter
            for it in take:
                it["err"] = e
                it["done"].set()
            return
        self._note_round(time.perf_counter() - t0)
        lo = 0
        for it in take:
            n = len(it["x"])
            it["out"] = host[lo:lo + n]
            lo += n
            it["done"].set()

    def _ring_loop(self) -> None:
        """Admit whole queued requests into the ring's free slots and
        dispatch the round, THEN deliver the previous round — so the card
        runs round k+1 while round k's answers are handed out. On stop the
        in-flight round is delivered and never-admitted requests get a
        clean "server stopping" error."""
        inflight = None
        while True:
            with self._cv:
                while not self._pending and not self._stopping \
                        and inflight is None:
                    self._cv.wait()
                stopping = self._stopping
                take, rows, rest = [], 0, []
                if stopping:
                    rest, self._pending = self._pending, []
                else:
                    for it in self._pending:
                        if it["abandoned"]:
                            continue
                        if rows + len(it["x"]) <= self._ring_slots:
                            take.append(it)
                            rows += len(it["x"])
                        else:
                            rest.append(it)
                    self._pending = rest
            if stopping:
                if inflight is not None:
                    self._ring_deliver(inflight)
                for it in rest:
                    it["err"] = RuntimeError("server stopping")
                    it["done"].set()
                return
            nxt = self._ring_dispatch(take) if take else None
            if inflight is not None:
                self._ring_deliver(inflight)
            inflight = nxt

    # -- the merge core -------------------------------------------------------

    def _forward_rows(self, x: np.ndarray) -> np.ndarray:
        """Merge mode: pad the rows to their bucket, run ONE forward,
        unpad."""
        n = len(x)
        pad = self._bucket(n) - n
        if pad:
            x = np.concatenate([x, np.zeros((pad,) + self._sample_shape,
                                            np.float32)])
        with self._cv:
            self.n_dispatches += 1
        t0 = time.perf_counter()
        with self._lock:
            out = self._forward_now(x)[:n]
        self._note_round(time.perf_counter() - t0)
        return out

    def _batch_loop(self) -> None:
        """Merge mode: coalesce queued requests into one forward per round.
        A lone request dispatches at once; only when several are queued
        does the loop wait up to batch_window_ms for stragglers. Whole
        requests only; one that would overflow max_batch waits a round.
        `batch_window_ms` and `max_batch` are read per round."""
        while True:
            with self._cv:
                while not self._pending and not self._stopping:
                    self._cv.wait()
                if self._stopping:
                    for it in self._pending:
                        it["err"] = RuntimeError("server stopping")
                        it["done"].set()
                    self._pending = []
                    return
                if len(self._pending) > 1 and self.batch_window_ms > 0:
                    self._cv.wait(self.batch_window_ms / 1000.0)
                take, rows, rest = [], 0, []
                for it in self._pending:
                    if it["abandoned"]:
                        continue
                    if rows + len(it["x"]) <= self.max_batch:
                        take.append(it)
                        rows += len(it["x"])
                    else:
                        rest.append(it)
                self._pending = rest
            if not take:
                continue
            try:
                merged = (take[0]["x"] if len(take) == 1 else
                          np.concatenate([it["x"] for it in take]))
                out = self._forward_rows(merged)
                lo = 0
                for it in take:
                    hi = lo + len(it["x"])
                    it["out"] = out[lo:hi]
                    lo = hi
            except Exception as e:  # noqa: BLE001 — surface to waiters
                for it in take:
                    it["err"] = e
            for it in take:
                it["done"].set()

    # -- reports --------------------------------------------------------------

    def health(self) -> Dict[str, Any]:
        with self._cv:
            status = "draining" if (self._draining or self._stopping) \
                else "ok"
            now = time.time()
            gen = self._gens.snapshot()
            gen["serving_for_s"] = round(now - gen["since"], 3)
            prev = self._gens.prev_gen
            return {"status": status,
                    "replica": self.replica,
                    "uptime_s": round(now - self._started_at, 3),
                    "inflight": self._inflight,
                    "pending": len(self._pending),
                    "n_dispatches": self.n_dispatches,
                    "n_rejected": self.n_rejected,
                    "n_timeouts": self.n_timeouts,
                    "queue_limit": self.queue_limit,
                    "max_batch": self.max_batch,
                    "dispatch": self.dispatch,
                    "ring_slots": self.ring_slots,
                    "aot": {"source": self.aot_source,
                            "compiles": self.aot_compiles},
                    "round_latency_s": round(self._round_s, 6),
                    "retry_after_s": self._retry_after_locked(),
                    # what a deploy pipeline polls to confirm a push
                    "generation": gen,
                    "previous_generation": (prev or {}).get("digest"),
                    "swaps": {"applied": self._gens.n_swaps,
                              "refused": self.n_swap_refusals,
                              "last_refusal": self._last_swap_refusal},
                    # the JAX package's veles_serving_replica_* families
                    "replica_counters": {
                        "requests": self.n_requests,
                        "rejected": self.n_rejected,
                        "latency_s_sum": round(self.latency_s_sum, 6),
                        "latency_n": self.latency_n,
                        "generation_age_s": gen["serving_for_s"]}}

    def model_info(self) -> Dict[str, Any]:
        wf = self.workflow
        info = {"workflow": wf.name,
                "replica": self.replica,
                "input_shape": list(self._sample_shape),
                "max_batch": self.max_batch,
                "batch_window_ms": self.batch_window_ms,
                "n_classes": wf.n_classes,
                "layers": [type(u).__name__ for u in wf.forwards],
                "dispatch": self.dispatch,
                "ring_slots": self.ring_slots,
                "quantize": self.quantize,
                "device": str(self.device),
                "device_name": device_name(self.device),
                "variants": self._fwd.variant_table(),
                "kernel_launches": kernels.launch_counts()}
        if self.dispatch == "ring":
            info["aot"] = {"source": self.aot_source,
                           "compiles": self.aot_compiles}
            info["param_bytes"] = {"f32": self._f32_bytes,
                                   "wire": self._wire_bytes}
        return info

    # -- http lifecycle -------------------------------------------------------

    def start(self) -> "InferenceServer":
        srv = self
        token = self.token

        class Handler(BaseHTTPRequestHandler):
            # keep-alive: every response below carries a Content-Length
            protocol_version = "HTTP/1.1"

            def _send(self, code: int, payload: Dict[str, Any],
                      headers: Optional[Dict[str, str]] = None) -> None:
                body = json.dumps(payload).encode()
                self.send_response(code)
                self.send_header("Content-Type", "application/json")
                self.send_header("Content-Length", str(len(body)))
                for k, v in (headers or {}).items():
                    self.send_header(k, v)
                self.end_headers()
                self.wfile.write(body)

            def do_GET(self) -> None:  # noqa: N802
                if self.path.startswith("/healthz"):
                    payload = srv.health()
                    self._send(200 if payload["status"] == "ok" else 503,
                               payload)
                elif self.path.startswith("/info"):
                    self._send(200, srv.model_info())
                else:
                    self._send(404, {"error": "unknown endpoint"})

            def _read_body(self):
                """The body when its Content-Length is admissible (read
                before any answer: closing with it unread resets the
                connection, and a client still sending sees a broken
                pipe, not the answer); (None, n) else, n None for a bad
                header."""
                try:
                    n: Optional[int] = int(
                        self.headers.get("Content-Length", "0"))
                except ValueError:
                    return None, None
                if 0 <= n <= srv.max_body:
                    return self.rfile.read(n), n
                return None, n

            def do_POST(self) -> None:  # noqa: N802
                # any response sent with the body still unread would
                # desync the next request on a kept-alive connection:
                # every reject path closes it; only the normal paths
                # (body consumed) keep what the request negotiated
                negotiated = self.close_connection
                self.close_connection = True
                if self.path.startswith("/rollback"):
                    self._rollback(negotiated)
                    return
                if not self.path.startswith("/predict"):
                    self._send(404, {"error": "unknown endpoint"})
                    return
                body, n = self._read_body()
                if not check_shared_token(self, token):
                    return
                if n is None:
                    self._send(400, {"error": "bad Content-Length"})
                    return
                if body is None:
                    self._send(413 if n > srv.max_body else 400,
                               {"error": f"body must be 0..{srv.max_body}"
                                         " bytes"})
                    return
                self.close_connection = negotiated
                try:
                    srv.shed_check()   # shed at header cost, before JSON
                    resp = srv.predict(json.loads(body)["inputs"])
                except (ValueError, KeyError, TypeError) as e:
                    self._send(400, {"error": str(e)[:300]})
                    return
                except RuntimeError as e:
                    payload: Dict[str, Any] = {"error": str(e)[:300]}
                    headers = None
                    ra = getattr(e, "retry_after", None)
                    if ra:
                        payload["retry_after_s"] = round(ra, 3)
                        headers = {"Retry-After":
                                   str(max(1, int(math.ceil(ra))))}
                    self._send(503, payload, headers)
                    return
                self._send(200, resp)

            def _rollback(self, negotiated) -> None:
                """POST /rollback: token-guarded (a rollback changes what
                every client is served)."""
                body, _ = self._read_body()
                if not check_shared_token(self, token):
                    return
                if body is None:
                    self._send(400, {"error": "bad Content-Length"})
                    return
                self.close_connection = negotiated
                try:
                    gen = srv.rollback()
                except SwapRefused as e:
                    self._send(409, {"error": str(e)[:300],
                                     "reason": e.reason})
                    return
                self._send(200, {"generation": gen})

            def log_message(self, *args: Any) -> None:
                pass

        self._draining = False
        self._started_at = time.time()
        if self._batcher is not None and not self._batcher.is_alive():
            # a stop() whose join timed out, the thread gone since
            self._batcher = None
            self._stopping = False
        if self._batcher is None and (self.dispatch == "ring"
                                      or self.batch_window_ms > 0):
            self._batcher = threading.Thread(
                target=(self._ring_loop if self.dispatch == "ring"
                        else self._batch_loop), daemon=True, name="batcher")
            self._batcher.start()
            # one round through the loop thread before the first client:
            # PyTorch creates its per-thread cuBLAS/cuDNN state at a
            # thread's first call (~0.3 s on the card), which the first
            # request would otherwise pay
            try:
                self._predict_batched(
                    np.zeros((1,) + self._sample_shape, np.float32))
            except BaseException:
                self.stop(drain_s=0)
                raise
        self._httpd = ThreadingHTTPServer((self.host, self.port), Handler)
        self.port = self._httpd.server_address[1]
        self._thread = threading.Thread(
            target=lambda: self._httpd.serve_forever(poll_interval=0.05),
            daemon=True, name="inference")
        self._thread.start()
        self.info("serving on http://%s:%d (POST /predict, POST /rollback, "
                  "GET /info, GET /healthz; %s dispatch, %s wire, on %s)",
                  self.host, self.port, self.dispatch, self.quantize,
                  self.device)
        return self

    def stop(self, drain_s: float = 5.0) -> None:
        """Refuse new requests (503), let in-flight ones finish (bounded
        by `drain_s`), then close the listener and stop the loop (and an
        attached watcher first: no swap lands in a stopping server). The
        first server of a fleet stops the whole fleet, through its drain
        protocol."""
        fleet, self.fleet = self.fleet, None
        if fleet is not None:
            fleet.stop(drain_s)
            return
        if self.watcher is not None:
            self.watcher.stop()
            self.watcher = None
        with self._cv:
            self._draining = True
            deadline = time.time() + drain_s
            while self._inflight > 0 and drain_s > 0:
                remaining = deadline - time.time()
                if remaining <= 0:
                    self.warning("drain timed out with %d request(s) in "
                                 "flight", self._inflight)
                    break
                self._cv.wait(remaining)
        if self._httpd is not None:
            self._httpd.shutdown()
            self._httpd.server_close()
            self._httpd = None
        if self._thread is not None:
            self._thread.join(timeout=5)
            self._thread = None
        if self._batcher is not None:
            with self._cv:
                self._stopping = True
                self._cv.notify_all()
            self._batcher.join(timeout=5)
            if self._batcher.is_alive():
                self.warning("dispatch loop still draining at stop()")
            else:
                with self._cv:
                    self._batcher = None
                    self._stopping = False
