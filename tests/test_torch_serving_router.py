"""The port's fleet front door (`veles_tpu_torch/serving_router.py`):
the port counterpart of each of tests/test_serving_router.py's 22 tests,
over the same stub replicas (no torch, no workflow: a handler whose
behavior each test scripts, plus DirMirror beacons), with the router's
counters read as attributes (`n_hedged`) where the JAX tests read its
metric families.

Then the port against the JAX package: one seeded sequence of 300
events (beacons, picks, dispatch outcomes, sheds, evictions, views) at
fixed `now`s goes into the JAX `RouterCore` and the port's, which give
the same answer and the same `snapshot(now)` after every event; and
beacons written by each package's `ReplicaBeacon` on its `DirMirror` are
discovered by the other package's `ServingRouter`.
"""

import json
import threading
import time
import urllib.error
import urllib.request
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

import numpy as np
import pytest

from veles_tpu import serving_router as jrouter
from veles_tpu.resilience.mirror import DirMirror as JDirMirror
from veles_tpu_torch.resilience.clock import VirtualClock
from veles_tpu_torch.resilience.mirror import DirMirror
from veles_tpu_torch.serving_router import (BEACON_PREFIX, ReplicaBeacon,
                                            RouterCore, ServingRouter,
                                            beacon_name)


def _beacon(rid, url="http://127.0.0.1:1", status="up", seq=1,
            capacity=1.0, **extra):
    rec = {"rid": rid, "url": url, "status": status, "seq": seq,
           "capacity": capacity}
    rec.update(extra)
    return rec


# -- RouterCore: registry ------------------------------------------------------


def test_observe_beacon_add_update_and_malformed():
    core = RouterCore()
    assert core.observe_beacon(_beacon("r0"), now=0.0) == "r0"
    assert core.replicas["r0"].capacity == 1.0
    # update with a newer seq refreshes liveness and fields
    core.observe_beacon(_beacon("r0", seq=2, capacity=8.0), now=5.0)
    st = core.replicas["r0"]
    assert st.seq == 2 and st.capacity == 8.0 and st.last_seen == 5.0
    # malformed records are ignored, not crashes
    for bad in ({}, {"rid": "x"}, _beacon("r1", status="meh"),
                _beacon("r1", seq="NaN"), {"rid": 3, "url": "u",
                                           "status": "up"}):
        assert core.observe_beacon(bad, now=6.0) is None
    assert core.live() == ["r0"]


def test_observe_beacon_stale_seq_never_rolls_lifecycle_back():
    core = RouterCore()
    core.observe_beacon(_beacon("r0", seq=5, status="draining"), 0.0)
    # a torn/stale read with an older seq claims the replica is up —
    # the lifecycle (up -> draining -> gone) must not roll backwards
    assert core.observe_beacon(_beacon("r0", seq=3), 1.0) is None
    assert core.replicas["r0"].status == "draining"


def test_gone_beacon_deregisters():
    core = RouterCore()
    core.observe_beacon(_beacon("r0"), 0.0)
    core.observe_beacon(_beacon("r0", seq=2, status="gone"), 1.0)
    assert core.live() == []


def test_ttl_eviction_requires_seq_advance():
    """A crashed replica's beacon file stays on the mirror: re-reading
    the SAME seq must not refresh liveness, and once evicted the
    tombstone keeps the corpse's file from re-registering it."""
    core = RouterCore(beacon_ttl_s=10.0)
    core.observe_beacon(_beacon("r0", seq=3), now=0.0)
    # stale re-reads: same seq, clock marches on
    core.observe_beacon(_beacon("r0", seq=3), now=8.0)
    assert core.replicas["r0"].last_seen == 0.0
    assert core.evict_silent(now=11.0) == ["r0"]
    # the file is still listed next poll; it must NOT come back
    core.observe_beacon(_beacon("r0", seq=3), now=12.0)
    assert core.live() == []
    # a real return (seq advanced: the replica actually beat again)
    # clears the tombstone
    core.observe_beacon(_beacon("r0", seq=4), now=13.0)
    assert core.live() == ["r0"]


# -- RouterCore: pick ----------------------------------------------------------


def test_pick_excludes_draining_and_rotates_ties():
    core = RouterCore()
    for rid in ("r0", "r1", "r2"):
        core.observe_beacon(_beacon(rid), 0.0)
    core.observe_beacon(_beacon("r1", seq=2, status="draining"), 0.0)
    picks = {core.pick(1.0) for _ in range(6)}
    assert picks == {"r0", "r2"}      # ties rotate; r1 never picked
    assert core.routable(1.0) == 2


def test_pick_weighs_capacity_against_inflight():
    core = RouterCore()
    core.observe_beacon(_beacon("big", capacity=8.0), 0.0)
    core.observe_beacon(_beacon("small", capacity=1.0), 0.0)
    assert core.pick(1.0) == "big"
    # pile inflight onto big until small wins: 8/(1+n) < 1
    for _ in range(8):
        core.note_dispatch("big")
    assert core.pick(1.0) == "small"


def test_shed_backpressure_window_and_min_retry_after():
    core = RouterCore()
    core.observe_beacon(_beacon("r0"), 0.0)
    core.note_dispatch("r0")
    core.note_shed("r0", retry_after_s=3.0, now=10.0)
    assert core.pick(11.0) is None            # inside the window
    assert core.min_retry_after(11.0) == pytest.approx(2.0)
    assert core.pick(13.5) == "r0"            # window reopened
    # shed is backpressure, not failure: circuit untouched
    assert core.replicas["r0"].circuit == "closed"


def test_circuit_opens_half_opens_and_closes():
    core = RouterCore(fail_threshold=3, open_s=5.0)
    core.observe_beacon(_beacon("r0"), 0.0)
    for _ in range(3):
        core.note_dispatch("r0")
        core.note_fail("r0", now=1.0)
    assert core.replicas["r0"].circuit == "open"
    assert core.pick(2.0) is None             # open: not eligible
    # after open_s the first pick flips half_open and admits ONE probe
    assert core.pick(6.5) == "r0"
    assert core.replicas["r0"].circuit == "half_open"
    core.note_dispatch("r0")
    assert core.pick(6.6) is None             # probe in flight: no more
    core.note_ok("r0", 0.02)
    assert core.replicas["r0"].circuit == "closed"
    assert core.pick(6.7) == "r0"


def test_half_open_probe_failure_reopens():
    core = RouterCore(fail_threshold=3, open_s=5.0)
    core.observe_beacon(_beacon("r0"), 0.0)
    for _ in range(3):
        core.note_dispatch("r0")
        core.note_fail("r0", now=1.0)
    assert core.pick(7.0) == "r0"             # half-open probe
    core.note_dispatch("r0")
    core.note_fail("r0", now=7.1)             # ANY half-open failure
    st = core.replicas["r0"]
    assert st.circuit == "open" and st.open_until == pytest.approx(12.1)


def test_hedge_after_needs_signal_then_tracks_p99():
    core = RouterCore()
    core.observe_beacon(_beacon("r0"), 0.0)
    assert core.hedge_after_s("r0") is None   # no latency signal yet
    for _ in range(12):
        core.note_dispatch("r0")
        core.note_ok("r0", 0.2)
    after = core.hedge_after_s("r0")
    assert after is not None and after >= 0.2 * 0.9


# -- ReplicaBeacon over a real DirMirror --------------------------------------


def test_beacon_lifecycle_on_mirror(tmp_path):
    mirror = DirMirror(str(tmp_path))
    health = {"status": "ok", "queue_limit": 6,
              "generation": {"digest": "abc123", "serving_for_s": 4.0},
              "inflight": 1, "retry_after_s": 0.5}
    b = ReplicaBeacon(mirror, "rA", "http://127.0.0.1:9",
                      health=lambda: dict(health), interval_s=0.2)
    assert b.publish()
    assert mirror.meta_names(BEACON_PREFIX) == [beacon_name("rA")]
    rec = mirror.get_meta(beacon_name("rA"))
    assert rec["status"] == "up" and rec["capacity"] == 6.0
    assert rec["generation"]["digest"] == "abc123"
    seq0 = rec["seq"]
    b.drain()
    rec = mirror.get_meta(beacon_name("rA"))
    assert rec["status"] == "draining" and rec["seq"] > seq0
    b.stop()
    assert mirror.get_meta(beacon_name("rA"))["status"] == "gone"


def test_beacon_rejects_path_traversal_rids():
    with pytest.raises(ValueError):
        beacon_name("../../etc/passwd")
    with pytest.raises(ValueError):
        beacon_name("a/b")


# -- HTTP shell over stub replicas --------------------------------------------


class StubReplica:
    """A /predict + /rollback HTTP stub whose behavior each test
    scripts: mode `ok` answers 200, `shed` 503 + Retry-After, `fail`
    500, `slow` sleeps then answers 200."""

    def __init__(self):
        self.mode = "ok"
        self.delay_s = 0.0
        self.rollback_status = 200
        self.hits = []
        stub = self

        class H(BaseHTTPRequestHandler):
            protocol_version = "HTTP/1.1"

            def _send(self, code, obj, extra=None):
                body = json.dumps(obj).encode()
                self.send_response(code)
                self.send_header("Content-Type", "application/json")
                self.send_header("Content-Length", str(len(body)))
                for k, v in (extra or {}).items():
                    self.send_header(k, v)
                self.end_headers()
                self.wfile.write(body)

            def do_POST(self):
                n = int(self.headers.get("Content-Length", "0"))
                self.rfile.read(n)
                stub.hits.append(self.path)
                if self.path.startswith("/rollback"):
                    if stub.rollback_status == 200:
                        self._send(200, {"applied": True, "generation":
                                         {"digest": "g1"}})
                    else:
                        self._send(stub.rollback_status,
                                   {"error": "rollback refused",
                                    "reason": "no_previous"})
                    return
                if stub.delay_s:
                    time.sleep(stub.delay_s)
                if stub.mode == "ok":
                    self._send(200, {"outputs": [[1.0]], "stub": True})
                elif stub.mode == "shed":
                    self._send(503, {"error": "overloaded"},
                               {"Retry-After": "2"})
                else:
                    self._send(500, {"error": "boom"})

            def log_message(self, *a):
                pass

        self.httpd = ThreadingHTTPServer(("127.0.0.1", 0), H)
        self.port = self.httpd.server_address[1]
        self.url = f"http://127.0.0.1:{self.port}"
        self._t = threading.Thread(
            target=lambda: self.httpd.serve_forever(poll_interval=0.05),
            daemon=True)
        self._t.start()

    def stop(self):
        self.httpd.shutdown()
        self.httpd.server_close()


@pytest.fixture()
def stubs():
    reps = [StubReplica() for _ in range(2)]
    yield reps
    for r in reps:
        r.stop()


def _seed_router(tmp_path, stubs, **kw):
    """Router over a DirMirror carrying one beacon per stub replica."""
    mirror = DirMirror(str(tmp_path))
    for i, s in enumerate(stubs):
        mirror.put_meta(beacon_name(f"r{i}"),
                        _beacon(f"r{i}", url=s.url, capacity=4.0))
    kw.setdefault("poll_s", 30.0)     # tests drive poll_once directly
    kw.setdefault("backoff_base", 0.01)
    kw.setdefault("backoff_cap", 0.02)
    return ServingRouter(mirror, **kw).start()


def _http(method, port, path, body=None, token=None, timeout=15):
    req = urllib.request.Request(
        f"http://127.0.0.1:{port}{path}",
        data=(body if body is not None
              else (b"{}" if method == "POST" else None)),
        method=method)
    if token:
        req.add_header("X-Veles-Token", token)
    try:
        with urllib.request.urlopen(req, timeout=timeout) as r:
            return r.status, dict(r.headers), json.loads(r.read())
    except urllib.error.HTTPError as e:
        raw = e.read()
        return e.code, dict(e.headers), (json.loads(raw) if raw else {})


def test_router_routes_and_spreads(tmp_path, stubs):
    router = _seed_router(tmp_path, stubs)
    try:
        for _ in range(4):
            status, _, payload = _http("POST", router.port, "/predict")
            assert status == 200 and payload["stub"] is True
        assert all(s.hits for s in stubs)      # both replicas served
        status, _, h = _http("GET", router.port, "/healthz")
        assert status == 200 and h["routable"] == 2
    finally:
        router.stop()


def test_router_retries_past_a_failing_replica(tmp_path, stubs):
    stubs[0].mode = "fail"
    router = _seed_router(tmp_path, stubs)
    try:
        for _ in range(4):
            status, _, payload = _http("POST", router.port, "/predict")
            assert status == 200        # failover, not a client error
        assert any("/predict" in p for p in stubs[1].hits)
    finally:
        router.stop()


def test_router_sheds_with_retry_after_when_fleet_at_capacity(
        tmp_path, stubs):
    for s in stubs:
        s.mode = "shed"
    router = _seed_router(tmp_path, stubs)
    try:
        status, headers, payload = _http("POST", router.port,
                                         "/predict")
        assert status == 503
        assert int(headers["Retry-After"]) >= 1
        assert payload["retry_after_s"] > 0
    finally:
        router.stop()


def test_router_all_replicas_down_degrades_to_shed(tmp_path, stubs):
    for s in stubs:
        s.mode = "fail"
    router = _seed_router(tmp_path, stubs, attempts=2,
                          total_timeout_s=5.0)
    try:
        status, headers, payload = _http("POST", router.port,
                                         "/predict")
        assert status == 503 and "Retry-After" in headers
        assert "fleet" in payload["error"]
    finally:
        router.stop()


def test_router_token_auth_and_bounded_body(tmp_path, stubs):
    router = _seed_router(tmp_path, stubs, token="sekrit",
                          max_body=128)
    try:
        status, _, _ = _http("POST", router.port, "/predict")
        assert status == 403                      # no token
        status, _, _ = _http("GET", router.port, "/fleet")
        assert status == 403                      # registry is guarded
        status, _, _ = _http("GET", router.port, "/healthz")
        assert status == 200                      # probes stay open
        status, _, _ = _http("POST", router.port, "/predict",
                             body=b"x" * 256, token="sekrit")
        assert status == 413                      # bounded body
        status, _, payload = _http("POST", router.port, "/predict",
                                   token="sekrit")
        assert status == 200 and payload["stub"] is True
    finally:
        router.stop()


def test_router_fleet_view_and_drain_discipline(tmp_path, stubs):
    router = _seed_router(tmp_path, stubs)
    try:
        # drain r0 (seq must advance for the update to land)
        router.mirror.put_meta(
            beacon_name("r0"),
            _beacon("r0", url=stubs[0].url, status="draining", seq=2,
                    capacity=4.0))
        router.poll_once()
        status, _, fleet = _http("GET", router.port, "/fleet")
        assert status == 200
        by_rid = {r["rid"]: r for r in fleet["replicas"]}
        assert by_rid["r0"]["status"] == "draining"
        assert fleet["routable"] == 1
        stubs[0].hits.clear()
        for _ in range(4):
            status, _, _ = _http("POST", router.port, "/predict")
            assert status == 200
        # the drain discipline: nothing routed to r0
        assert not any("/predict" in p for p in stubs[0].hits)
    finally:
        router.stop()


def test_router_rollback_fans_out_to_draining_too(tmp_path, stubs):
    router = _seed_router(tmp_path, stubs)
    try:
        router.mirror.put_meta(
            beacon_name("r0"),
            _beacon("r0", url=stubs[0].url, status="draining", seq=2,
                    capacity=4.0))
        router.poll_once()
        status, _, payload = _http("POST", router.port, "/rollback")
        assert status == 200 and payload["fleet"] is True
        assert set(payload["replicas"]) == {"r0", "r1"}
        assert all(r["applied"] for r in payload["replicas"].values())
        # one refusal -> 409 with per-replica outcomes
        stubs[1].rollback_status = 409
        status, _, payload = _http("POST", router.port, "/rollback")
        assert status == 409
        assert payload["replicas"]["r0"]["applied"] is True
        assert payload["replicas"]["r1"]["applied"] is False
        assert payload["replicas"]["r1"]["reason"] == "no_previous"
    finally:
        router.stop()


def test_router_rollback_empty_fleet_is_409(tmp_path):
    router = ServingRouter(DirMirror(str(tmp_path)), poll_s=30.0)
    router._core  # built; no start needed for the admin verb
    status, payload = router.rollback_fleet()
    assert status == 409 and payload["replicas"] == {}


def test_router_hedges_exactly_once_to_second_replica(tmp_path, stubs):
    router = _seed_router(tmp_path, stubs, hedge=True)
    try:
        # prime r0's latency estimators so hedge_after_s has signal
        with router._lock:
            for _ in range(12):
                router._core.note_dispatch("r0")
                router._core.note_ok("r0", 0.05)
            router._core.replicas["r1"].capacity = 0.5  # r0 picked 1st
        stubs[0].delay_s = 1.5                # r0 now exceeds its p99
        stubs[1].hits.clear()
        before = router.n_hedged
        t0 = time.monotonic()
        status, _, payload = _http("POST", router.port, "/predict")
        assert status == 200 and payload["stub"] is True
        # answered by the fast hedge, not the slow primary
        assert time.monotonic() - t0 < 1.4
        assert router.n_hedged == before + 1   # exactly once
        assert sum(1 for p in stubs[1].hits
                   if "/predict" in p) == 1
    finally:
        router.stop()


def test_router_poll_registers_and_evicts_on_silence(tmp_path, stubs):
    clock = VirtualClock()
    mirror = DirMirror(str(tmp_path))
    mirror.put_meta(beacon_name("r0"),
                    _beacon("r0", url=stubs[0].url))
    router = ServingRouter(mirror, poll_s=30.0, clock=clock,
                           core=RouterCore(beacon_ttl_s=5.0))
    router.poll_once()                  # no HTTP needed: poll directly
    assert router._core.live() == ["r0"]
    clock.advance(6.0)                  # beacon never advances seq
    router.poll_once()
    assert router._core.live() == []    # TTL-evicted, tombstoned
    clock.advance(1.0)
    router.poll_once()                  # stale file re-listed
    assert router._core.live() == []    # ...and stays out


# -- the port against the JAX package -----------------------------------------


RIDS = ("r0", "r1", "r2", "r3")


def _events(seed, n=300):
    """A seeded script of RouterCore calls: (method, args) with `now`
    rising by 0..3 s between events; beacons may be stale, draining,
    gone or malformed; TTL evictions and circuit windows both occur."""
    rs = np.random.RandomState(seed)
    now, seqs, out = 0.0, {r: 0 for r in RIDS}, []
    for _ in range(n):
        now += float(rs.choice([0.0, 0.25, 1.0, 3.0]))
        rid = RIDS[rs.randint(len(RIDS))]
        kind = rs.choice(["beacon", "beacon", "pick", "pick", "dispatch",
                          "ok", "fail", "shed", "evict", "retry", "hedge"])
        if kind == "beacon":
            step = int(rs.choice([-1, 0, 1, 1, 2]))
            seqs[rid] = max(0, seqs[rid] + step)
            rec = {"rid": rid, "url": f"http://127.0.0.1:{9000 + int(rid[1])}",
                   "status": str(rs.choice(["up", "up", "up", "draining",
                                            "gone", "bogus"])),
                   "seq": seqs[rid],
                   "capacity": float(rs.choice([0.5, 1.0, 4.0, 64.0])),
                   "generation": {"digest": f"g{rs.randint(3)}",
                                  "serving_for_s": float(rs.randint(100))}}
            out.append(("observe_beacon", (rec, now)))
        elif kind == "pick":
            excl = tuple(r for r in RIDS if rs.rand() < 0.25)
            out.append(("pick", (now, excl)))
        elif kind == "dispatch":
            out.append(("note_dispatch", (rid,)))
        elif kind == "ok":
            out.append(("note_ok", (rid, float(rs.choice([0.01, 0.2, 1.5])))))
        elif kind == "fail":
            out.append(("note_fail", (rid, now)))
        elif kind == "shed":
            out.append(("note_shed", (rid, float(rs.choice([0.0, 2.0])),
                                      now)))
        elif kind == "evict":
            out.append(("evict_silent", (now,)))
        elif kind == "retry":
            out.append(("min_retry_after", (now,)))
        else:
            out.append(("hedge_after_s", (rid,)))
        out[-1] = out[-1] + (now,)
    return out


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_router_core_matches_the_jax_core_event_for_event(seed):
    jcore = jrouter.RouterCore(fail_threshold=2, open_s=4.0,
                               beacon_ttl_s=12.0)
    core = RouterCore(fail_threshold=2, open_s=4.0, beacon_ttl_s=12.0)
    picks = 0
    for i, (method, args, now) in enumerate(_events(seed)):
        want = getattr(jcore, method)(*args)
        got = getattr(core, method)(*args)
        assert got == want, (i, method, args)
        picks += method == "pick" and got is not None
        for rid in RIDS:
            assert core.hedge_after_s(rid) == jcore.hedge_after_s(rid), i
        assert core.snapshot(now) == jcore.snapshot(now), (i, method)
    assert picks > 20      # the script routes, not only sheds


def test_port_router_discovers_jax_beacons(tmp_path):
    bus = JDirMirror(str(tmp_path))
    health = {"status": "ok", "queue_limit": 6,
              "generation": {"digest": "abc123", "serving_for_s": 4.0}}
    beacons = [jrouter.ReplicaBeacon(bus, f"j{i}", f"http://127.0.0.1:{i + 1}",
                                     health=lambda: dict(health))
               for i in range(2)]
    for b in beacons:
        assert b.publish()
    router = ServingRouter(DirMirror(str(tmp_path)), poll_s=30.0)
    router.poll_once()
    assert router._core.live() == ["j0", "j1"]
    st = router._core.replicas["j1"]
    assert st.url == "http://127.0.0.1:2" and st.capacity == 6.0
    assert st.generation == "abc123"
    beacons[0].drain()
    beacons[1].stop()
    router.poll_once()
    assert router._core.live() == ["j0"]
    assert router._core.replicas["j0"].status == "draining"


def test_jax_router_discovers_port_beacons(tmp_path):
    bus = DirMirror(str(tmp_path))
    beacons = [ReplicaBeacon(bus, f"p{i}", f"http://127.0.0.1:{i + 1}",
                             capacity=3.0) for i in range(2)]
    for b in beacons:
        assert b.publish()
    router = jrouter.ServingRouter(JDirMirror(str(tmp_path)), poll_s=30.0)
    router.poll_once()
    assert router._core.live() == ["p0", "p1"]
    assert router._core.replicas["p0"].capacity == 3.0
    beacons[1].drain()
    beacons[0].stop()
    router.poll_once()
    assert router._core.live() == ["p1"]
    assert router._core.replicas["p1"].status == "draining"
