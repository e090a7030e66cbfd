"""The serving fleet's front door: presence beacons, a pure routing
core and the HTTP router.

The port's copy of `veles_tpu/serving_router.py`. One process (or many)
runs N independent :class:`~veles_tpu_torch.serving.InferenceServer`
slot rings (`--serve-replicas N`); this module makes them a *fleet*:

- **ReplicaBeacon** — each replica publishes a presence beacon on the
  mirror bus (`serve_replica_<rid>.json`): status up/draining/gone, the
  live `/healthz` capacity hint (the server's `queue_limit`), the
  blue/green generation labels, and a monotonic seq so a torn read can
  never roll a replica's state backwards. Beacons are meta records (no
  ".pickle" in the name), so they are invisible to the snapshot plane.
  The records keep the JAX package's keys and names, so one bus carries
  beacons of both packages.
- **RouterCore** — a PURE routing state machine (no threads, no
  sockets, no clock of its own: every method takes `now`). It owns the
  per-replica registry: capacity-weighted pick, per-replica
  Retry-After backpressure windows, a per-replica circuit breaker
  (closed → open after `fail_threshold` consecutive transport
  failures → half-open single probe → closed on success), a frugal
  p99 latency estimator that feeds request hedging, and drain
  discipline (a draining replica finishes its in-flight rounds but is
  never picked again).
- **ServingRouter** — the HTTP shell: discovers replicas from the bus
  (`Mirror.meta_names` — open membership, so join-mid-run needs no
  config push), proxies `POST /predict` with bounded
  retry-with-timeout (`resilience/backoff.py`), hedges to a second
  replica when the first exceeds the measured p99, fans `POST
  /rollback` out to every live replica, and aggregates the fleet view
  at `GET /fleet`. Every failure mode degrades to a
  shed-with-Retry-After — never a hung client.

Trust model: the router and the replicas share ONE token
(`X-Veles-Token`, `http_util.check_shared_token`): clients auth to the
router, the router re-presents the same token to replicas, and the
beacon bus is the same mirror the weight plane already trusts. The
router never reads request bodies beyond `max_body` and never forwards
anything but the verbatim client body — it holds no model state at
all, which is what makes it restartable at any moment.

The JAX package's metric families (`veles_router_*`) are plain
attributes here (`outcomes`, `dispatches`, `n_hedged`, `n_retries`,
the latency sum and count) and appear in `/healthz` and `/fleet`; the
telemetry registry and `/metrics` come with the port's telemetry.
Time comes from an injected :class:`~veles_tpu_torch.resilience.clock
.Clock`, so the tests own it. Standard library only: a router runs on a
box that cannot build the model.
"""

from __future__ import annotations

import json
import math
import threading
from concurrent.futures import FIRST_COMPLETED, ThreadPoolExecutor, wait
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Any, Callable, Dict, List, Optional, Tuple

from veles_tpu_torch.logger import Logger
from veles_tpu_torch.resilience.backoff import backoff_delay
from veles_tpu_torch.resilience.clock import SYSTEM_CLOCK, Clock

#: meta-record name prefix for serving-fleet presence beacons; the
#: suffix is the replica id. `Mirror.meta_names(BEACON_PREFIX)` is the
#: router's whole discovery protocol.
BEACON_PREFIX = "serve_replica_"

#: consecutive transport failures before a replica's circuit opens
FAIL_THRESHOLD = 3

#: seconds an open circuit waits before allowing the half-open probe
CIRCUIT_OPEN_S = 5.0

#: beacon silence after which a replica is presumed dead and evicted.
#: Deliberately MANY beacon intervals: a briefly-unreachable mirror
#: must not amputate a healthy fleet (the mirror-unreachable chaos
#: scenario) — during an outage no beacon refreshes, so the registry
#: coasts on last-known state until this TTL.
BEACON_TTL_S = 20.0

#: floor for the hedge trigger: below this a hedge costs more than it
#: saves (connection + dispatch overhead)
HEDGE_FLOOR_S = 0.05

#: Retry-After the router tells clients when NO replica can take the
#: request right now and no replica published a tighter hint
DEFAULT_RETRY_AFTER_S = 1.0


def beacon_name(rid: str) -> str:
    """Meta-record name for replica `rid`'s beacon. `rid` is
    constrained to filename-safe characters because it becomes part of
    a mirror meta name (DirMirror: a file under the mirror root)."""
    if not rid or not all(c.isalnum() or c in "._-" for c in rid):
        raise ValueError(f"replica id must be [A-Za-z0-9._-]+: {rid!r}")
    return f"{BEACON_PREFIX}{rid}.json"


class ReplicaState:
    """Router-side view of one replica. Mutated only by RouterCore
    (which is itself guarded by the ServingRouter's lock)."""

    __slots__ = ("rid", "url", "capacity", "status", "seq", "last_seen",
                 "not_before", "fails", "circuit", "open_until",
                 "inflight", "ewma_s", "p99_s", "n_ok", "n_fail",
                 "generation", "gen_age_s")

    def __init__(self, rid: str, url: str, now: float) -> None:
        self.rid = rid
        self.url = url
        self.capacity = 1.0
        self.status = "up"            # up | draining
        self.seq = -1
        self.last_seen = now
        self.not_before = 0.0         # Retry-After backpressure window
        self.fails = 0                # consecutive transport failures
        self.circuit = "closed"       # closed | open | half_open
        self.open_until = 0.0
        self.inflight = 0             # router-tracked, not replica's
        self.ewma_s = 0.0             # mean dispatch latency EWMA
        self.p99_s = 0.0              # frugal p99 estimate (hedging)
        self.n_ok = 0
        self.n_fail = 0
        self.generation = None        # live digest from the beacon
        self.gen_age_s = None

    def view(self, now: float) -> Dict[str, Any]:
        return {"rid": self.rid, "url": self.url,
                "status": self.status, "capacity": self.capacity,
                "circuit": self.circuit, "inflight": self.inflight,
                "fails": self.fails, "n_ok": self.n_ok,
                "n_fail": self.n_fail,
                "silent_for_s": round(max(0.0, now - self.last_seen), 3),
                "backpressure_s":
                    round(max(0.0, self.not_before - now), 3),
                "ewma_s": round(self.ewma_s, 6),
                "p99_s": round(self.p99_s, 6),
                "generation": self.generation,
                "generation_age_s": self.gen_age_s}


class RouterCore:
    """Pure fleet-routing state machine. Single-threaded by contract:
    the HTTP shell serializes access under its lock; the model checker
    calls it directly. No clock — callers pass `now` (monotonic
    seconds) so a VirtualClock can own time."""

    def __init__(self, fail_threshold: int = FAIL_THRESHOLD,
                 open_s: float = CIRCUIT_OPEN_S,
                 beacon_ttl_s: float = BEACON_TTL_S) -> None:
        self.replicas: Dict[str, ReplicaState] = {}
        self.fail_threshold = max(1, int(fail_threshold))
        self.open_s = float(open_s)
        self.beacon_ttl_s = float(beacon_ttl_s)
        self._rr = 0                  # rotation among weight-ties
        #: rid -> last seq seen before TTL eviction. A crashed
        #: replica's beacon file stays on the mirror; without this the
        #: next poll would re-create the corpse with a fresh last_seen
        #: and it would flap in and out of the registry forever. Only
        #: a seq ADVANCE past the tombstone (the replica actually came
        #: back) clears it.
        self._tombstones: Dict[str, int] = {}

    # -- registry (beacon plane) ------------------------------------------

    def observe_beacon(self, rec: Dict[str, Any], now: float
                       ) -> Optional[str]:
        """Apply one beacon record; returns the rid on a state-bearing
        update, None for malformed/stale records. A `seq` below the
        last seen one is a torn/stale read and is ignored — a replica's
        lifecycle (up → draining → gone) never rolls backwards."""
        rid = rec.get("rid")
        url = rec.get("url")
        status = rec.get("status")
        if not isinstance(rid, str) or not isinstance(url, str) \
                or status not in ("up", "draining", "gone"):
            return None
        try:
            seq = int(rec.get("seq", 0))
        except (TypeError, ValueError):
            return None
        dead_seq = self._tombstones.get(rid)
        if dead_seq is not None:
            if seq <= dead_seq:
                return None   # the evicted corpse's file, re-listed
            del self._tombstones[rid]
        st = self.replicas.get(rid)
        if st is not None and seq < st.seq:
            return None
        if status == "gone":
            self.replicas.pop(rid, None)
            return rid
        if st is None:
            st = self.replicas[rid] = ReplicaState(rid, url, now)
        elif seq > st.seq:
            # liveness = the beacon ADVANCED. A crashed replica's last
            # record stays on the mirror forever; re-reading that same
            # seq must not count as a heartbeat or the TTL eviction
            # below would never fire.
            st.last_seen = now
        st.url = url
        st.seq = seq
        st.status = status
        try:
            st.capacity = max(1.0, float(rec.get("capacity", 1.0)))
        except (TypeError, ValueError):
            st.capacity = 1.0
        gen = rec.get("generation")
        if isinstance(gen, dict):
            st.generation = gen.get("digest")
            st.gen_age_s = gen.get("serving_for_s")
        return rid

    def evict_silent(self, now: float) -> List[str]:
        """Drop replicas whose beacon went silent past the TTL (crashed
        without a 'gone' beacon). Returns the evicted rids. The evicted
        seq is tombstoned so the beacon file the corpse left on the
        mirror cannot re-register it (without the tombstone, eviction
        and re-discovery alternate every TTL)."""
        dead = [rid for rid, st in self.replicas.items()
                if now - st.last_seen > self.beacon_ttl_s]
        for rid in dead:
            self._tombstones[rid] = self.replicas[rid].seq
            del self.replicas[rid]
        return dead

    # -- pick -------------------------------------------------------------

    def _eligible(self, st: ReplicaState, now: float) -> bool:
        if st.status != "up":          # never route to a draining or
            return False               # deregistered replica
        if st.not_before > now:        # replica told us to back off
            return False
        if st.circuit == "open":
            if now < st.open_until:
                return False
            st.circuit = "half_open"   # readmission probe window
        if st.circuit == "half_open" and st.inflight > 0:
            return False               # exactly one probe at a time
        return True

    def pick(self, now: float, exclude: Tuple[str, ...] = ()
             ) -> Optional[str]:
        """Best replica to dispatch to right now, or None when the
        fleet has no capacity (caller sheds with Retry-After). Weight
        is `capacity / (1 + router-tracked inflight)` — the live
        /healthz capacity hint discounted by what we already sent
        there; weight ties rotate round-robin (a counter, so the
        choice stays deterministic and the model checker can replay
        schedules) — without the rotation a sequential client would
        pin the lexicographically-first replica forever."""
        cands: List[Tuple[float, str]] = []
        for rid in sorted(self.replicas):
            if rid in exclude:
                continue
            st = self.replicas[rid]
            if not self._eligible(st, now):
                continue
            cands.append((st.capacity / (1.0 + st.inflight), rid))
        if not cands:
            return None
        best_w = max(w for w, _ in cands)
        ties = [rid for w, rid in cands if w >= best_w - 1e-12]
        rid = ties[self._rr % len(ties)]
        self._rr += 1
        return rid

    def min_retry_after(self, now: float) -> float:
        """Shed hint when pick() returned None: the soonest any
        replica's backpressure window reopens, clamped to the default
        when nothing tighter is known."""
        waits = [st.not_before - now for st in self.replicas.values()
                 if st.status == "up" and st.not_before > now]
        if waits:
            return max(0.05, min(min(waits), DEFAULT_RETRY_AFTER_S * 30))
        return DEFAULT_RETRY_AFTER_S

    # -- dispatch outcomes ------------------------------------------------

    def note_dispatch(self, rid: str) -> None:
        st = self.replicas.get(rid)
        if st is not None:
            st.inflight += 1

    def note_ok(self, rid: str, latency_s: float) -> None:
        """Successful dispatch: closes the circuit (a half-open probe
        that succeeds readmits the replica), clears the failure streak,
        and feeds the latency estimators."""
        st = self.replicas.get(rid)
        if st is None:
            return
        st.inflight = max(0, st.inflight - 1)
        st.fails = 0
        st.circuit = "closed"
        st.n_ok += 1
        x = max(0.0, float(latency_s))
        st.ewma_s = x if st.ewma_s == 0.0 \
            else 0.8 * st.ewma_s + 0.2 * x
        # frugal p99: step up 5% of the sample when exceeded, down
        # 5%/99 otherwise — equilibrium where ~1% of samples exceed
        if st.p99_s == 0.0:
            st.p99_s = x
        elif x > st.p99_s:
            st.p99_s += 0.05 * x
        else:
            st.p99_s = max(0.0, st.p99_s - (0.05 / 99.0) * x)

    def note_fail(self, rid: str, now: float) -> None:
        """Transport failure (connect refused / timeout / 5xx without
        backpressure semantics). `fail_threshold` consecutive ones —
        or ANY failure of a half-open probe — open the circuit."""
        st = self.replicas.get(rid)
        if st is None:
            return
        st.inflight = max(0, st.inflight - 1)
        st.fails += 1
        st.n_fail += 1
        if st.circuit == "half_open" or st.fails >= self.fail_threshold:
            st.circuit = "open"
            st.open_until = now + self.open_s
            st.fails = 0

    def note_shed(self, rid: str, retry_after_s: float, now: float
                  ) -> None:
        """503 + Retry-After from the replica: backpressure, NOT a
        failure — the replica is alive and told us when to come back.
        Does not touch the circuit or the failure streak."""
        st = self.replicas.get(rid)
        if st is None:
            return
        st.inflight = max(0, st.inflight - 1)
        st.fails = 0
        st.not_before = max(st.not_before,
                            now + max(0.0, float(retry_after_s)))

    # -- views ------------------------------------------------------------

    def hedge_after_s(self, rid: str) -> Optional[float]:
        """Seconds to wait on `rid` before hedging to a second replica:
        the measured p99, floored — None until enough signal exists."""
        st = self.replicas.get(rid)
        if st is None or st.n_ok < 10 or st.p99_s <= 0.0:
            return None
        return max(HEDGE_FLOOR_S, st.p99_s)

    def live(self) -> List[str]:
        """rids the control plane should fan admin verbs out to —
        everything registered, up or draining (a draining replica
        still serves its in-flight generation)."""
        return sorted(self.replicas)

    def routable(self, now: float) -> int:
        return sum(1 for st in self.replicas.values()
                   if st.status == "up")

    def fleet_capacity(self) -> float:
        return sum(st.capacity for st in self.replicas.values()
                   if st.status == "up")

    def snapshot(self, now: float) -> Dict[str, Any]:
        return {"replicas": [self.replicas[r].view(now)
                             for r in sorted(self.replicas)],
                "routable": self.routable(now),
                "fleet_capacity": self.fleet_capacity()}


class ReplicaBeacon(Logger):
    """Presence beacon for ONE serving replica: publishes
    `serve_replica_<rid>.json` on the mirror bus every `interval_s`,
    carrying the replica's live /healthz capacity hint and generation
    labels. Lifecycle: start() beats 'up'; drain() flips the published
    status to 'draining' (the router stops picking it while in-flight
    work finishes); stop() publishes 'gone' best-effort and stops the
    beat thread. A replica that dies without stop() goes silent and is
    TTL-evicted by the router instead."""

    def __init__(self, mirror, rid: str, url: str,
                 health: Optional[Callable[[], Dict[str, Any]]] = None,
                 capacity: Optional[float] = None,
                 interval_s: float = 2.0,
                 clock: Clock = SYSTEM_CLOCK) -> None:
        self.mirror = mirror
        self.rid = rid
        self.url = url
        self.name = beacon_name(rid)
        self._health = health
        self._capacity = capacity
        self.interval_s = max(0.2, float(interval_s))
        self._clock = clock
        self._status = "up"
        self._seq = 0
        self._lock = threading.Lock()
        self._stop_evt = threading.Event()
        self._thread: Optional[threading.Thread] = None

    def record(self) -> Dict[str, Any]:
        with self._lock:
            self._seq += 1
            # the dict is built UNDER the lock so status and seq are
            # one consistent observation (seq gates staleness on the
            # router side — a torn pair could roll a drain backwards)
            rec: Dict[str, Any] = {"rid": self.rid, "url": self.url,
                                   "status": self._status,
                                   "seq": self._seq,
                                   "ts": self._clock.time()}
        health = None
        if self._health is not None:
            try:
                health = self._health()
            except Exception as e:  # beacon must outlive a sick server
                self.debug("beacon health probe failed: %s", e)
        if health is not None:
            if health.get("status") == "draining" \
                    and rec["status"] == "up":
                rec["status"] = "draining"
            rec["generation"] = {
                "digest": (health.get("generation") or {}).get("digest"),
                "serving_for_s":
                    (health.get("generation") or {}).get("serving_for_s")}
            rec["inflight"] = health.get("inflight")
            rec["retry_after_s"] = health.get("retry_after_s")
            if self._capacity is None:
                rec["capacity"] = float(health.get("queue_limit") or 1)
        if self._capacity is not None:
            rec["capacity"] = float(self._capacity)
        return rec

    def publish(self) -> bool:
        try:
            return bool(self.mirror.put_meta(self.name, self.record()))
        except Exception as e:      # unreachable mirror: beat again later
            self.debug("beacon publish failed: %s", e)
            return False

    def _beat_loop(self) -> None:
        while not self._stop_evt.wait(self.interval_s):
            self.publish()

    def start(self) -> "ReplicaBeacon":
        self.publish()
        self._thread = threading.Thread(target=self._beat_loop,
                                        daemon=True,
                                        name=f"beacon-{self.rid}")
        self._thread.start()
        return self

    def drain(self) -> None:
        """Announce graceful deregistration: the router stops routing
        here while the replica finishes in-flight rounds."""
        with self._lock:
            self._status = "draining"
        self.publish()

    def silence(self) -> None:
        """Stop beating WITHOUT the 'gone' goodbye — the crash
        simulation hook (the chaos and load tests): the beacon file stays
        on the mirror with a frozen seq, and the router must degrade
        via circuit + TTL eviction, never via a polite deregistration
        the dead process could not have sent."""
        self._stop_evt.set()
        if self._thread is not None:
            self._thread.join(timeout=5)
            self._thread = None

    def stop(self) -> None:
        with self._lock:
            self._status = "gone"
        self._stop_evt.set()
        self.publish()              # best-effort goodbye
        if self._thread is not None:
            self._thread.join(timeout=5)
            self._thread = None


class _Shed(RuntimeError):
    """Replica answered 503 + Retry-After (backpressure)."""

    def __init__(self, retry_after_s: float, body: bytes) -> None:
        super().__init__("replica shed")
        self.retry_after_s = retry_after_s
        self.body = body


class _ReplicaError(RuntimeError):
    """Transport-level dispatch failure (retryable elsewhere)."""


class ServingRouter(Logger):
    """Health-routing HTTP front door over a beacon-discovered replica
    fleet. Endpoints:

    - ``POST /predict``  — token + bounded body; capacity-weighted
      dispatch with bounded retry/backoff, hedging, circuit breaking;
      degrades to 503 + Retry-After when the fleet has no capacity.
    - ``POST /rollback`` — fans out to every live replica; 200 when
      all applied, 409 with per-replica outcomes otherwise.
    - ``GET /healthz``   — router liveness + fleet summary (unauthed,
      like the replica healthz: balancers probe it).
    - ``GET /fleet``     — full per-replica registry view and the
      router's counters (token-guarded: it leaks fleet internals).
    """

    def __init__(self, mirror, host: str = "127.0.0.1", port: int = 0,
                 token: Optional[str] = None, poll_s: float = 1.0,
                 max_body: int = 1 << 20, attempts: int = 3,
                 dispatch_timeout_s: float = 10.0,
                 total_timeout_s: float = 15.0,
                 backoff_base: float = 0.05, backoff_cap: float = 0.5,
                 hedge: bool = True, core: Optional[RouterCore] = None,
                 clock: Clock = SYSTEM_CLOCK) -> None:
        self.mirror = mirror
        self.host = host
        self.port = int(port)
        self.token = token
        self.poll_s = max(0.05, float(poll_s))
        self.max_body = int(max_body)
        self.attempts = max(1, int(attempts))
        self.dispatch_timeout_s = float(dispatch_timeout_s)
        self.total_timeout_s = float(total_timeout_s)
        self.backoff_base = float(backoff_base)
        self.backoff_cap = float(backoff_cap)
        self.hedge = bool(hedge)
        self._clock = clock
        self._core = core if core is not None else RouterCore()
        self._lock = threading.Lock()       # guards _core
        self._stop_evt = threading.Event()
        self._poller: Optional[threading.Thread] = None
        self._httpd: Optional[ThreadingHTTPServer] = None
        self._thread: Optional[threading.Thread] = None
        self._pool = ThreadPoolExecutor(max_workers=64,
                                        thread_name_prefix="router")
        #: the JAX package's `veles_router_*` counters as attributes
        #: (guarded by _stats_lock): client requests by terminal outcome,
        #: dispatch attempts by replica and outcome, hedged dispatches,
        #: retries, and the end-to-end /predict latency of answered
        #: requests (the gauges are /healthz's routable and capacity)
        self._stats_lock = threading.Lock()
        self.outcomes: Dict[str, int] = {o: 0 for o in
                                         ("ok", "shed", "error", "bad")}
        self.dispatches: Dict[str, Dict[str, int]] = {}
        self.n_hedged = 0
        self.n_retries = 0
        self.latency_s_sum = 0.0
        self.latency_n = 0

    # -- beacon plane -----------------------------------------------------

    def poll_once(self) -> None:
        """One discovery sweep: list beacons, apply each, evict the
        TTL-silent. A mirror outage yields an empty listing and no
        fresh records — the registry then COASTS on last-known state
        until the generous TTL, which is the mirror-unreachable
        degradation contract (requests keep routing; nothing is
        amputated by a listing hiccup)."""
        try:
            names = self.mirror.meta_names(BEACON_PREFIX)
        except Exception as e:
            self.debug("beacon listing failed: %s", e)
            names = []
        recs = []
        for name in names:
            try:
                rec = self.mirror.get_meta(name)
            except Exception:
                rec = None
            if isinstance(rec, dict):
                recs.append(rec)
        now = self._clock.monotonic()
        with self._lock:
            for rec in recs:
                self._core.observe_beacon(rec, now)
            evicted = self._core.evict_silent(now)
        for rid in evicted:
            self.warning("replica %s evicted: beacon silent > %.0fs",
                         rid, self._core.beacon_ttl_s)

    def _poll_loop(self) -> None:
        while not self._stop_evt.wait(self.poll_s):
            self.poll_once()

    # -- dispatch plane ---------------------------------------------------

    def _count_dispatch(self, rid: str, outcome: str) -> None:
        with self._stats_lock:
            per = self.dispatches.setdefault(rid, {})
            per[outcome] = per.get(outcome, 0) + 1

    def _count(self, outcome: str, latency_s: Optional[float] = None
               ) -> None:
        with self._stats_lock:
            self.outcomes[outcome] += 1
            if latency_s is not None:
                self.latency_s_sum += latency_s
                self.latency_n += 1

    def counters(self) -> Dict[str, Any]:
        """The router's counters (the JAX package's metric families)."""
        with self._stats_lock:
            return {"requests": dict(self.outcomes),
                    "dispatches": {r: dict(d)
                                   for r, d in self.dispatches.items()},
                    "hedged": self.n_hedged, "retries": self.n_retries,
                    "latency_s_sum": round(self.latency_s_sum, 6),
                    "latency_n": self.latency_n}

    def _post_replica(self, url: str, path: str, body: bytes,
                      timeout: float) -> Tuple[int, Dict[str, str],
                                               bytes]:
        """Raw POST to one replica; raises OSError-family on transport
        failure. Returns (status, lowered-headers, body)."""
        import http.client
        from urllib.parse import urlsplit
        parts = urlsplit(url)
        conn = http.client.HTTPConnection(parts.hostname,
                                          parts.port or 80,
                                          timeout=max(0.05, timeout))
        headers = {"Content-Type": "application/json",
                   "Content-Length": str(len(body))}
        if self.token:
            headers["X-Veles-Token"] = self.token
        try:
            conn.request("POST", path, body, headers)
            resp = conn.getresponse()
            data = resp.read()
            return resp.status, {k.lower(): v for k, v in
                                 resp.getheaders()}, data
        finally:
            conn.close()

    def _dispatch_one(self, rid: str, url: str, body: bytes,
                      timeout: float) -> Tuple[int, bytes]:
        """One /predict dispatch to one replica, with the outcome fed
        back into the core. Returns (status, body) for responses the
        client should see verbatim (200 and 4xx); raises `_Shed` on
        replica backpressure and `_ReplicaError` on transport/5xx."""
        t0 = self._clock.monotonic()
        try:
            status, headers, data = self._post_replica(
                url, "/predict", body, timeout)
        except Exception as e:
            with self._lock:
                self._core.note_fail(rid, self._clock.monotonic())
            self._count_dispatch(rid, "fail")
            raise _ReplicaError(f"{rid}: {e}") from e
        latency = self._clock.monotonic() - t0
        if status == 200:
            with self._lock:
                self._core.note_ok(rid, latency)
            self._count_dispatch(rid, "ok")
            return status, data
        if status == 503:
            ra = headers.get("retry-after")
            try:
                ra_s = max(0.05, float(ra)) if ra is not None \
                    else DEFAULT_RETRY_AFTER_S
            except ValueError:
                ra_s = DEFAULT_RETRY_AFTER_S
            with self._lock:
                self._core.note_shed(rid, ra_s,
                                     self._clock.monotonic())
            self._count_dispatch(rid, "shed")
            raise _Shed(ra_s, data)
        if 400 <= status < 500:
            # the CLIENT's fault — don't punish the replica, don't
            # retry elsewhere (every replica would say the same)
            with self._lock:
                self._core.note_ok(rid, latency)
            self._count_dispatch(rid, "client_error")
            return status, data
        with self._lock:
            self._core.note_fail(rid, self._clock.monotonic())
        self._count_dispatch(rid, "fail")
        raise _ReplicaError(f"{rid}: replica answered {status}")

    def _dispatch_hedged(self, rid: str, url: str, body: bytes,
                         deadline: float) -> Tuple[int, bytes]:
        """Dispatch to `rid`; when it exceeds its measured p99 and a
        second replica is eligible, hedge ONE duplicate there and take
        whichever answers first. The loser's outcome still lands in
        the core via its own `_dispatch_one` bookkeeping."""
        now = self._clock.monotonic()
        budget = max(0.05, min(self.dispatch_timeout_s, deadline - now))
        primary = self._pool.submit(self._dispatch_one, rid, url,
                                    body, budget)
        hedge_after = None
        if self.hedge:
            with self._lock:
                hedge_after = self._core.hedge_after_s(rid)
        if hedge_after is None or hedge_after >= budget:
            return primary.result()
        done, _ = wait([primary], timeout=hedge_after)
        if done:
            return primary.result()
        with self._lock:
            hedge_rid = self._core.pick(self._clock.monotonic(),
                                        exclude=(rid,))
            hedge_url = (self._core.replicas[hedge_rid].url
                         if hedge_rid is not None else None)
            if hedge_rid is not None:
                self._core.note_dispatch(hedge_rid)
        if hedge_rid is None:
            return primary.result()
        with self._stats_lock:
            self.n_hedged += 1
        self._count_dispatch(hedge_rid, "hedge")
        second = self._pool.submit(self._dispatch_one, hedge_rid,
                                   hedge_url, body, budget)
        pending = {primary, second}
        last_exc: Optional[BaseException] = None
        while pending:
            remaining = deadline - self._clock.monotonic()
            done, pending = wait(pending, timeout=max(0.05, remaining),
                                 return_when=FIRST_COMPLETED)
            if not done:        # total budget exhausted
                break
            for fut in done:
                try:
                    return fut.result()
                except BaseException as e:  # noqa: BLE001 — loser may
                    last_exc = e            # still win below
        if last_exc is not None:
            raise last_exc
        raise _ReplicaError(f"{rid}: dispatch exceeded total budget")

    def handle_predict(self, body: bytes
                       ) -> Tuple[int, Dict[str, Any],
                                  Optional[Dict[str, str]]]:
        """Route one client /predict. Returns (status, payload,
        extra-headers). Bounded: at most `attempts` replica dispatches
        inside `total_timeout_s`, jittered backoff between transport
        failures; every no-capacity exit is a shed with Retry-After."""
        t0 = self._clock.monotonic()
        deadline = t0 + self.total_timeout_s
        shed_hint: Optional[float] = None
        last_err = "no replica available"
        failed: Tuple[str, ...] = ()
        for attempt in range(self.attempts):
            now = self._clock.monotonic()
            if now >= deadline:
                break
            with self._lock:
                rid = self._core.pick(now, exclude=failed)
                url = (self._core.replicas[rid].url
                       if rid is not None else None)
                if rid is not None:
                    self._core.note_dispatch(rid)
            if rid is None:
                break
            if attempt:
                with self._stats_lock:
                    self.n_retries += 1
            try:
                status, data = self._dispatch_hedged(rid, url, body,
                                                     deadline)
            except _Shed as e:
                shed_hint = e.retry_after_s if shed_hint is None \
                    else min(shed_hint, e.retry_after_s)
                continue        # replica backpressure: try another NOW
            except _ReplicaError as e:
                last_err = str(e)
                failed = failed + (rid,)
                delay = backoff_delay(attempt, base=self.backoff_base,
                                      cap=self.backoff_cap)
                if self._clock.monotonic() + delay < deadline:
                    self._clock.sleep(delay)
                continue
            try:
                payload = json.loads(data) if data else {}
            except ValueError:
                payload = {"raw": data.decode("utf-8", "replace")[:300]}
            if status == 200:
                self._count("ok", self._clock.monotonic() - t0)
                return 200, payload, None
            self._count("bad")
            return status, payload, None
        with self._lock:
            fleet_hint = self._core.min_retry_after(
                self._clock.monotonic())
        ra = shed_hint if shed_hint is not None else fleet_hint
        if shed_hint is None and failed:
            # transport failures, not backpressure: still a bounded
            # shed (the client retries; the fleet may heal meanwhile)
            self._count("error")
            return 503, {"error": f"fleet dispatch failed: {last_err}"
                                  [:300],
                         "retry_after_s": round(ra, 3)}, \
                {"Retry-After": str(max(1, int(math.ceil(ra))))}
        self._count("shed")
        return 503, {"error": "fleet at capacity",
                     "retry_after_s": round(ra, 3)}, \
            {"Retry-After": str(max(1, int(math.ceil(ra))))}

    # -- admin plane ------------------------------------------------------

    def rollback_fleet(self) -> Tuple[int, Dict[str, Any]]:
        """Fan POST /rollback out to every live replica (up AND
        draining — a draining replica still serves its in-flight
        generation and must roll with the fleet). 200 when every
        replica applied; 409 with per-replica outcomes otherwise."""
        with self._lock:
            targets = [(rid, self._core.replicas[rid].url)
                       for rid in self._core.live()]
        outcomes: Dict[str, Any] = {}
        ok = True
        for rid, url in targets:
            try:
                status, _, data = self._post_replica(
                    url, "/rollback", b"", self.dispatch_timeout_s)
                try:
                    payload = json.loads(data) if data else {}
                except ValueError:
                    payload = {}
                if status == 200:
                    outcomes[rid] = {
                        "applied": True,
                        "generation":
                            (payload.get("generation") or {}).get(
                                "digest")}
                else:
                    ok = False
                    outcomes[rid] = {"applied": False,
                                     "error": payload.get(
                                         "error", f"status {status}"),
                                     "reason": payload.get("reason")}
            except Exception as e:
                ok = False
                outcomes[rid] = {"applied": False,
                                 "error": str(e)[:300]}
        if not targets:
            ok = False
        return (200 if ok else 409), {"fleet": True,
                                      "replicas": outcomes}

    def health(self) -> Dict[str, Any]:
        now = self._clock.monotonic()
        with self._lock:
            snap = self._core.snapshot(now)
        return {"status": "ok", "role": "router",
                "routable": snap["routable"],
                "replicas": len(snap["replicas"]),
                "fleet_capacity": snap["fleet_capacity"],
                "counters": self.counters()}

    def fleet(self) -> Dict[str, Any]:
        now = self._clock.monotonic()
        with self._lock:
            snap = self._core.snapshot(now)
        snap["counters"] = self.counters()
        return snap

    # -- http lifecycle ---------------------------------------------------

    def start(self) -> "ServingRouter":
        router = self
        token = self.token
        from veles_tpu_torch.http_util import check_shared_token

        class Handler(BaseHTTPRequestHandler):
            # same keep-alive discipline as the replica handler:
            # HTTP/1.1, Content-Length on every response, reject paths
            # close the connection because the body is still unread
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
                    self._send(200, router.health())
                elif self.path.startswith("/fleet"):
                    if not check_shared_token(self, token):
                        return
                    self._send(200, router.fleet())
                else:
                    self._send(404, {"error": "unknown endpoint"})

            def do_POST(self) -> None:  # noqa: N802
                negotiated = self.close_connection
                self.close_connection = True
                # the endpoint contract every control plane wires:
                # shared token first, bound the body BEFORE reading it
                if not check_shared_token(self, token):
                    return
                try:
                    n = int(self.headers.get("Content-Length", "0"))
                except ValueError:
                    self._send(400, {"error": "bad Content-Length"})
                    return
                if not 0 <= n <= router.max_body:
                    self._send(413 if n > router.max_body else 400,
                               {"error":
                                f"body must be 0..{router.max_body}"
                                " bytes"})
                    return
                self.close_connection = negotiated
                body = self.rfile.read(n)
                if self.path.startswith("/rollback"):
                    code, payload = router.rollback_fleet()
                    self._send(code, payload)
                    return
                if not self.path.startswith("/predict"):
                    self._send(404, {"error": "unknown endpoint"})
                    return
                code, payload, headers = router.handle_predict(body)
                self._send(code, payload, headers)

            def log_message(self, *args: Any) -> None:
                pass

        self.poll_once()            # warm registry before first request
        self._stop_evt.clear()
        self._poller = threading.Thread(target=self._poll_loop,
                                        daemon=True, name="router-poll")
        self._poller.start()
        self._httpd = ThreadingHTTPServer((self.host, self.port),
                                          Handler)
        self.port = self._httpd.server_address[1]
        # poll_interval bounds how long shutdown() blocks waiting for
        # the accept loop to notice the flag
        self._thread = threading.Thread(
            target=lambda: self._httpd.serve_forever(poll_interval=0.05),
            daemon=True, name="router-http")
        self._thread.start()
        self.info("router on http://%s:%d (POST /predict|/rollback, "
                  "GET /healthz|/fleet)", self.host, self.port)
        return self

    def stop(self) -> None:
        self._stop_evt.set()
        if self._poller is not None:
            self._poller.join(timeout=5)
            self._poller = None
        if self._httpd is not None:
            self._httpd.shutdown()
            self._httpd.server_close()
            self._httpd = None
        self._thread = None
        self._pool.shutdown(wait=False)
