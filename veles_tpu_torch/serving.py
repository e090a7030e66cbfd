"""In-process HTTP inference serving of a workflow's forward, on the card.

The port's counterpart of `veles_tpu/serving.py`, reduced to the serving
slice: the continuous-batching slot ring, f32 only, on one device. It
serves a fresh workflow (initialized from the seed) or one restored from
a snapshot (`--serve PORT -s SNAPSHOT`), which it moves to the device.

Endpoints:
- POST /predict  {"inputs": [[...], ...]} -> {"outputs": [[...]],
  "classes": [...]} (softmax heads: outputs are probabilities and
  classes the per-row argmax — serving.py:902-945 there)
- GET  /healthz  liveness + dispatch counters (503 while draining)
- GET  /info     model metadata, the lowerings the forward runs
  (`variant_table()`) and the kernel launch counts

Ring dispatch: the server keeps ONE fixed-shape batch of `ring_slots`
rows, which is also the most rows one request may send. A dispatch loop
admits whole queued requests into free slots, pads the rest with zeros,
runs the forward, and returns each request its rows. On the card a round
is enqueued whole: the copy of its pinned host batch in, the forward, and
the copy of its answer out to pinned host memory, then an event. The loop
enqueues round k+1 before it waits on round k's event, so the card runs
round k+1 while round k's answers are handed out, and round k's answers
wait for round k alone. The forward runs in full f32 (no TF32).

Robustness: at most `queue_limit` requests in flight (503 beyond it, with
a Retry-After from the measured round latency), a request body above
`max_body` gets 413, a configured `token` must come in `X-Veles-Token`
(403), a queued request that misses `request_timeout_s` gets 503, and
`stop()` drains in-flight rounds before it closes. Localhost by default.
"""

from __future__ import annotations

import hmac
import json
import math
import threading
import time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Any, Dict, List, Optional

import numpy as np
import torch

from veles_tpu_torch.backends import DeviceLike, device_name
from veles_tpu_torch.config import root
from veles_tpu_torch.logger import Logger
from veles_tpu_torch.ops import kernels


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


def check_shared_token(handler: BaseHTTPRequestHandler, token) -> bool:
    """Constant-time shared-token check: when `token` is set, the request
    must carry it in `X-Veles-Token`, or a 403 is sent and False
    returned."""
    if not token:
        return True
    if hmac.compare_digest(handler.headers.get("X-Veles-Token", ""), token):
        return True
    handler.send_response(403)
    handler.send_header("Content-Length", "0")
    handler.end_headers()
    return False


class InferenceServer(Logger):
    """Serve a workflow's forward pass over HTTP through a slot ring."""

    def __init__(self, workflow, host: str = "127.0.0.1", port: int = 0,
                 ring_slots: int = 64, queue_limit: int = 64,
                 request_timeout_s: float = 30.0,
                 token: Optional[str] = None, max_body: int = 32 << 20,
                 device: DeviceLike = None) -> None:
        self.workflow = workflow
        self.host = host
        self.port = port
        self._ring_slots = int(ring_slots)
        if self._ring_slots < 1:
            raise ValueError(f"ring_slots must be >= 1 (got {ring_slots})")
        self.queue_limit = queue_limit
        self.request_timeout_s = request_timeout_s
        self.token = token
        self.max_body = max_body
        self._httpd: Optional[ThreadingHTTPServer] = None
        self._thread: Optional[threading.Thread] = None
        self._batcher: Optional[threading.Thread] = None
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
        self._build(device)

    @property
    def ring_slots(self) -> int:
        """Rows in the ring batch and the most rows one request may send
        — read-only: it is the shape every round runs at."""
        return self._ring_slots

    # -- build ----------------------------------------------------------------

    def _build(self, device: DeviceLike) -> None:
        if root.common.precision_type != "float32":
            raise ValueError(
                f"root.common.precision_type="
                f"{root.common.precision_type!r}: the port serves float32 "
                f"only (bf16 comes with a later slice)")
        wf = self.workflow
        # a fresh workflow is initialized, a restored one (a snapshot's,
        # on the host) moved to the device
        wf.place(device)
        self.device = wf.device
        self._fwd = wf.build_forward()
        self._params = self._fwd.params()
        self._sample_shape = tuple(wf.loader.sample_shape)
        self._softmax = wf.loss == "softmax"
        # warm + validate now: on the card this builds and launches the
        # kernels, so a build failure fails the start, not a request
        host, done = self._forward_ring(self._ring_batch())
        if done is not None:
            done.synchronize()
        if host.shape[0] != self._ring_slots:
            raise RuntimeError(f"forward returned {host.shape[0]} rows for "
                               f"a {self._ring_slots}-slot ring")

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
        xd = x.to(self.device, non_blocking=True)
        out = self._fwd._forward(self._params, xd)
        if self._softmax:
            out = torch.softmax(out, dim=-1)
        if self.device.type != "cuda":
            return out, None
        host = torch.empty(out.shape, dtype=out.dtype, pin_memory=True)
        host.copy_(out, non_blocking=True)
        done = torch.cuda.Event()
        done.record(torch.cuda.current_stream(self.device))
        return host, done

    # -- admission ------------------------------------------------------------

    def _retry_after_locked(self) -> Optional[float]:
        """Seconds until capacity likely frees: measured round latency ×
        the rounds the queued backlog needs (called under _cv)."""
        if self._round_s <= 0:
            return None
        rows = sum(len(it["x"]) for it in self._pending)
        return (1 + rows // self._ring_slots) * self._round_s

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
        if not 1 <= len(x) <= self._ring_slots:
            raise ValueError(f"batch of {len(x)} rows: expected 1.."
                             f"{self._ring_slots}")
        n = len(x)
        with self._cv:
            self._shed_locked()
            self._inflight += 1
        try:
            out = self._predict_batched(x)
        finally:
            with self._cv:
                self._inflight -= 1
                self._cv.notify_all()   # drain waiters watch this count
        out = out.reshape(n, -1)
        resp: Dict[str, Any] = {"outputs": out.tolist()}
        if self._softmax:
            resp["classes"] = out.argmax(axis=-1).tolist()
        return resp

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
            # loop thread not running (never start()ed): one round now
            self._ring_deliver(self._ring_dispatch([item]))
        else:
            timeout = self.request_timeout_s or None
            if not item["done"].wait(timeout):
                with self._cv:
                    if not item["done"].is_set():
                        item["abandoned"] = True
                        # by identity: `in`/`remove` would compare the
                        # items' input arrays with ==
                        self._pending = [it for it in self._pending
                                         if it is not item]
                        self.n_timeouts += 1
                        raise RequestTimeout(
                            f"request timed out after {timeout:.1f}s in "
                            f"queue")
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
        dt = time.perf_counter() - t0
        with self._cv:
            self._round_s = (dt if self._round_s <= 0
                             else 0.8 * self._round_s + 0.2 * dt)
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

    # -- reports --------------------------------------------------------------

    def health(self) -> Dict[str, Any]:
        with self._cv:
            status = "draining" if (self._draining or self._stopping) \
                else "ok"
            return {"status": status,
                    "uptime_s": round(time.time() - self._started_at, 3),
                    "inflight": self._inflight,
                    "pending": len(self._pending),
                    "n_dispatches": self.n_dispatches,
                    "n_rejected": self.n_rejected,
                    "n_timeouts": self.n_timeouts,
                    "queue_limit": self.queue_limit,
                    "dispatch": "ring",
                    "ring_slots": self._ring_slots,
                    "round_latency_s": round(self._round_s, 6),
                    "retry_after_s": self._retry_after_locked()}

    def model_info(self) -> Dict[str, Any]:
        wf = self.workflow
        return {"workflow": wf.name,
                "input_shape": list(self._sample_shape),
                "n_classes": wf.n_classes,
                "layers": [type(u).__name__ for u in wf.forwards],
                "dispatch": "ring",
                "ring_slots": self._ring_slots,
                "quantize": "f32",
                "device": str(self.device),
                "device_name": device_name(self.device),
                "variants": self._fwd.variant_table(),
                "kernel_launches": kernels.launch_counts()}

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

            def do_POST(self) -> None:  # noqa: N802
                # any response sent with the body still unread would
                # desync the next request on a kept-alive connection:
                # every reject path closes it; only the normal path
                # (body consumed) keeps what the request negotiated
                negotiated = self.close_connection
                self.close_connection = True
                if not self.path.startswith("/predict"):
                    self._send(404, {"error": "unknown endpoint"})
                    return
                try:
                    n: Optional[int] = int(
                        self.headers.get("Content-Length", "0"))
                except ValueError:
                    n = None
                body = None
                if n is not None and 0 <= n <= srv.max_body:
                    # read an admissible body before any answer: closing
                    # with it unread resets the connection, and a client
                    # still sending sees a broken pipe, not the answer
                    body = self.rfile.read(n)
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

            def log_message(self, *args: Any) -> None:
                pass

        self._draining = False
        self._started_at = time.time()
        if self._batcher is None:
            self._batcher = threading.Thread(
                target=self._ring_loop, daemon=True, name="ring")
            self._batcher.start()
            # one round through the ring thread before the first client:
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
        self.info("serving on http://%s:%d (POST /predict, GET /info, "
                  "GET /healthz; ring of %d on %s)", self.host, self.port,
                  self._ring_slots, self.device)
        return self

    def stop(self, drain_s: float = 5.0) -> None:
        """Refuse new requests (503), let in-flight ones finish (bounded
        by `drain_s`), then close the listener and stop the ring loop."""
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
                self.warning("ring loop still draining at stop()")
            else:
                with self._cv:
                    self._batcher = None
                    self._stopping = False
