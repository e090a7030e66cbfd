"""The port's serving fleet on the CPU: two real replicas of a narrow
conv -> LRN -> max pool -> softmax net (9x9x3 inputs, 4 kernels, 5
classes; the LRN -> pool pair is the one K4 serves on the card) started
in one process by `launcher.serve` with `--serve-replicas 2
--serve-announce DIR`, behind the port's `ServingRouter` over that bus:

- both replicas serve requests of 1 to 8 rows, each answer within 1e-5
  of the plain forward (every LRN through its plain version, no fused
  pair), and `/fleet` lists both with their rids, status and generation;
- a draining replica is never picked, and every request still gets 200;
- after a swap on both replicas, `/rollback` through the router restores
  both replicas' earlier outputs bit for bit;
- the JAX package's `ServingRouter` routes to the port's replicas;
- the launcher's fleet refusals exit as the JAX CLI's do, `--route`
  serves and stops on SIGTERM, `--serve-rollback` exits 0 on an applied
  rollback and 1 on a refusal or a transport failure, as the JAX
  client's do;
- SIGTERM runs the drain protocol in order: beacons draining, watchers
  stopped, servers stopped, beacons gone;
- `--serve PORT` gives 3 replicas PORT..PORT+2 (0: each its own), rids
  `r{i}-{pid}` or `r{i}-{host}` under VELES_SERVE_ADVERTISE, whose host
  the beacons advertise (a recording stand-in for the server).
"""

import importlib.util
import json
import os
import signal
import subprocess
import sys
import threading
import urllib.error
import urllib.request
from pathlib import Path

import numpy as np
import pytest
import torch

from veles_tpu import __main__ as jmain
from veles_tpu import prng as jprng
from veles_tpu import serving_router as jrouter
from veles_tpu.launcher import Launcher as JLauncher
from veles_tpu.resilience.mirror import DirMirror as JDirMirror
from veles_tpu_torch import launcher, prng
from veles_tpu_torch.ops import kernels
from veles_tpu_torch.resilience.mirror import DirMirror
from veles_tpu_torch.serving_router import ServingRouter, beacon_name

REPO = Path(__file__).resolve().parent.parent
ATOL = 1e-5
WORKFLOW = '''
from veles_tpu_torch.loader.synthetic import SyntheticClassifierLoader
from veles_tpu_torch.znicz.standard_workflow import StandardWorkflow

LAYERS = [{"type": "conv_strictrelu", "n_kernels": 4, "kx": 3, "ky": 3,
           "padding": (1, 1), "weights_stddev": 0.2},
          {"type": "lrn"},
          {"type": "max_pooling", "ksize": (3, 3), "stride": (2, 2)},
          {"type": "softmax", "output_sample_shape": 5,
           "weights_stddev": 0.2}]


def create_workflow():
    loader = SyntheticClassifierLoader(
        n_classes=5, sample_shape=(9, 9, 3), n_validation=8, n_train=16,
        minibatch_size=8, noise=0.5)
    return StandardWorkflow(layers=LAYERS, loader=loader, loss="softmax",
                            n_classes=5, name="FleetNet")


def run(load, main):
    load(create_workflow)
    main()
'''


@pytest.fixture(autouse=True)
def _restore_base_seeds():
    saved = jprng._base_seed, prng._base_seed
    yield
    jprng._base_seed, prng._base_seed = saved


@pytest.fixture(scope="module")
def wf_file(tmp_path_factory):
    path = tmp_path_factory.mktemp("fleet_wf") / "fleet_net.py"
    path.write_text(WORKFLOW)
    return str(path)


class Fleet:
    """Two replicas started by `launcher.serve`, and a router over
    their beacons."""

    def __init__(self, wf_file, bus):
        self.bus = bus
        self.srv = launcher.serve(
            [wf_file, "--serve", "0", "--serve-replicas", "2",
             "--serve-announce", bus, "--serve-ring", "8", "--device",
             "cpu", "-r", "5"])
        self.servers = self.srv.fleet.servers
        self.router = ServingRouter(DirMirror(bus), poll_s=30.0,
                                    backoff_base=0.01,
                                    backoff_cap=0.02).start()

    def stop(self):
        self.router.stop()
        self.srv.stop(drain_s=1)


@pytest.fixture()
def fleet(wf_file, tmp_path):
    f = Fleet(wf_file, str(tmp_path / "bus"))
    yield f
    f.stop()


def _post(url, x=None, path="/predict"):
    body = b"" if x is None else json.dumps({"inputs": x.tolist()}).encode()
    req = urllib.request.Request(url + path, data=body, method="POST")
    try:
        with urllib.request.urlopen(req, timeout=60) as r:
            return r.status, json.loads(r.read())
    except urllib.error.HTTPError as e:
        raw = e.read()
        return e.code, json.loads(raw) if raw else {}


def _get(url, path):
    with urllib.request.urlopen(url + path, timeout=60) as r:
        return json.loads(r.read())


def _plain(srv, x, params=None):
    """The served model's plain forward on the host: every LRN through
    its plain version, no fused pair, then the softmax."""
    with torch.no_grad():
        h = torch.from_numpy(x)
        ps = srv._fwd.params() if params is None else params
        for u, p in zip(srv._fwd.forwards, ps):
            if getattr(u, "variant_op", None) == "lrn":
                h = kernels.lrn_forward_plain(h, u.k, u.alpha, u.beta, u.n)
            else:
                h = u.fused_apply(p, h, train=False)
        return torch.softmax(h, dim=-1).numpy()


def _requests(n=8, seed=3):
    rs = np.random.RandomState(seed)
    return [rs.randn(1 + i % 8, 9, 9, 3).astype(np.float32)
            for i in range(n)]


def _url(port):
    return f"http://127.0.0.1:{port}"


def test_fleet_serves_through_the_router(fleet):
    srv = fleet.servers[0]
    assert len(fleet.servers) == 2 and fleet.servers[0] is fleet.srv
    pid = os.getpid()
    assert [s.replica for s in fleet.servers] == [f"r0-{pid}", f"r1-{pid}"]
    assert fleet.servers[1].kernel_builds == {"nvcc": 0, "loads": 0}
    before = [s.n_requests for s in fleet.servers]
    for x in _requests():
        status, resp = _post(_url(fleet.router.port), x)
        assert status == 200, resp
        out = np.asarray(resp["outputs"])
        assert out.shape == (len(x), 5)
        np.testing.assert_allclose(out, _plain(srv, x), rtol=0, atol=ATOL)
    served = [s.n_requests - b for s, b in zip(fleet.servers, before)]
    assert all(n > 0 for n in served) and sum(served) == 8
    view = _get(_url(fleet.router.port), "/fleet")
    by_rid = {r["rid"]: r for r in view["replicas"]}
    assert sorted(by_rid) == [s.replica for s in fleet.servers]
    for s in fleet.servers:
        r = by_rid[s.replica]
        assert r["status"] == "up" and r["url"] == _url(s.port)
        assert r["generation"] == s.generation()["digest"]
    assert view["routable"] == 2
    assert view["counters"]["requests"]["ok"] == 8
    h = _get(_url(fleet.servers[1].port), "/healthz")
    assert h["replica"] == fleet.servers[1].replica
    assert h["replica_counters"]["requests"] == fleet.servers[1].n_requests
    assert _get(_url(srv.port), "/info")["replica"] == srv.replica


def test_a_draining_replica_is_never_picked(fleet):
    drained = fleet.srv.fleet.beacons[0]
    drained.drain()
    fleet.router.poll_once()
    assert fleet.router.fleet()["routable"] == 1
    before = [s.n_requests for s in fleet.servers]
    for x in _requests(6, seed=4):
        status, _ = _post(_url(fleet.router.port), x)
        assert status == 200
    served = [s.n_requests - b for s, b in zip(fleet.servers, before)]
    assert served == [0, 6]


def test_router_rollback_restores_both_replicas_bit_for_bit(fleet, wf_file):
    x = _requests(1, seed=5)[0]
    boot = [_post(_url(s.port), x)[1]["outputs"] for s in fleet.servers]
    spec = importlib.util.spec_from_file_location("fleet_net_cand", wf_file)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    for s in fleet.servers:
        cand = mod.create_workflow()
        cand.initialize("cpu")
        for u, p in zip(cand.forwards, s.workflow.params_host()):
            for k, t in u.param_arrays().items():
                t.data.copy_(torch.from_numpy(p[k] * 1.01))
        s.swap_params(cand, source="test")
    swapped = [_post(_url(s.port), x)[1]["outputs"] for s in fleet.servers]
    assert all(a != b for a, b in zip(swapped, boot))
    status, resp = _post(_url(fleet.router.port), path="/rollback")
    assert status == 200 and resp["fleet"] is True
    assert sorted(resp["replicas"]) == [s.replica for s in fleet.servers]
    assert all(r["applied"] for r in resp["replicas"].values())
    back = [_post(_url(s.port), x)[1]["outputs"] for s in fleet.servers]
    assert back == boot
    # a second fleet rollback rolls forward again
    assert _post(_url(fleet.router.port), path="/rollback")[0] == 200
    assert [_post(_url(s.port), x)[1]["outputs"]
            for s in fleet.servers] == swapped


def test_the_jax_router_routes_to_port_replicas(fleet):
    router = jrouter.ServingRouter(JDirMirror(fleet.bus), poll_s=30.0)
    router.start()
    try:
        assert router._core.live() == sorted(s.replica
                                             for s in fleet.servers)
        for x in _requests(4, seed=6):
            status, resp = _post(_url(router.port), x)
            assert status == 200
            np.testing.assert_allclose(np.asarray(resp["outputs"]),
                                       _plain(fleet.srv, x), rtol=0,
                                       atol=ATOL)
    finally:
        router.stop()


def _jax_refusal(argv=None, **launcher_kw):
    with pytest.raises(SystemExit) as e:
        if argv is not None:
            jmain.main(argv)
        else:
            JLauncher(**launcher_kw)
    return e.value.code


def _port_refusal(argv):
    with pytest.raises(SystemExit) as e:
        launcher.main(argv)
    return e.value.code


@pytest.mark.parametrize("case", ["knob_without_serve", "announce_without_"
                                  "serve", "replicas_below_1"])
def test_fleet_knob_refusals_as_the_jax_launcher(case, wf_file):
    argv, kw, flag = {
        "knob_without_serve": (["--serve-replicas", "2"],
                               {"serve_replicas": 2}, "--serve-replicas"),
        "announce_without_serve": (["--serve-announce", "d"],
                                   {"serve_announce": "d"},
                                   "--serve-announce"),
        "replicas_below_1": (["--serve", "0", "--serve-replicas", "0"],
                             {"serve": 0, "serve_replicas": 0},
                             "--serve-replicas")}[case]
    jcode = _jax_refusal(**kw)
    assert flag in jcode
    # the port's parser refuses its serving knobs with argparse's exit 2
    assert _port_refusal([wf_file, *argv]) == 2


@pytest.mark.parametrize("argv", [["--route", "BUS", "WF"],
                                  ["WF", "--route-port", "5"],
                                  ["--serve-rollback", "u", "WF"]])
def test_mode_refusals_exit_as_the_jax_cli(argv, wf_file, tmp_path):
    argv = [{"BUS": str(tmp_path), "WF": wf_file}.get(a, a) for a in argv]
    assert _port_refusal(argv) == _jax_refusal(argv)


def test_route_cli_serves_and_stops_on_sigterm(tmp_path):
    bus = DirMirror(str(tmp_path))
    bus.put_meta(beacon_name("rX"), {"rid": "rX", "url": "http://127.0.0.1:1",
                                     "status": "up", "seq": 1})
    env = dict(os.environ, PYTHONPATH=str(REPO))
    proc = subprocess.Popen(
        [sys.executable, "-m", "veles_tpu_torch", "--route", str(tmp_path)],
        cwd=REPO, env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
        text=True)
    try:
        line = proc.stdout.readline()
        assert line.startswith("ROUTING http://127.0.0.1:"), (
            line, proc.poll(), proc.stderr.read()[-2000:])
        url = line.split()[1]
        h = _get(url, "/healthz")
        assert h["role"] == "router" and h["replicas"] == 1
        proc.send_signal(signal.SIGTERM)
        assert proc.wait(timeout=60) == 0
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait(timeout=30)
        proc.stdout.close()
        proc.stderr.close()


def test_serve_rollback_cli_exits_as_the_jax_client(fleet, capsys):
    srv = fleet.servers[0]
    url = _url(srv.port)
    # 409: no previous generation
    assert launcher.main(["--serve-rollback", url]) == 1
    assert jmain._serve_rollback(url) == 1
    assert "no_previous" in capsys.readouterr().out
    boot = srv.generation()["digest"]
    srv.swap_params(srv.workflow, digest="g" * 64, source="test")
    assert launcher.main(["--serve-rollback", url]) == 0
    out = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert out["generation"]["digest"] == boot
    assert jmain._serve_rollback(url) == 0         # rolls forward again
    assert srv.generation()["digest"] == "g" * 64
    # a transport failure: nothing listens on the router's old port
    fleet.router.stop()
    dead = _url(fleet.router.port)
    assert launcher.main(["--serve-rollback", dead]) == 1
    assert jmain._serve_rollback(dead) == 1
    fleet.router.start()


def test_sigterm_runs_the_drain_protocol_in_order(wf_file, tmp_path):
    bus = tmp_path / "bus"
    env = dict(os.environ, PYTHONPATH=str(REPO))
    proc = subprocess.Popen(
        [sys.executable, "-m", "veles_tpu_torch", wf_file, "--serve", "0",
         "--serve-replicas", "2", "--serve-announce", str(bus),
         "--serve-ring", "8", "--device", "cpu", "-r", "5", "-v"],
        cwd=REPO, env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
        text=True)
    try:
        lines = []
        reader = threading.Thread(
            target=lambda: lines.extend(proc.stdout.readline()
                                        for _ in range(2)), daemon=True)
        reader.start()
        reader.join(timeout=120)
        assert len(lines) == 2 and all(
            ln.startswith("SERVING http://") for ln in lines), (
            lines, proc.poll())
        names = DirMirror(str(bus)).meta_names("serve_replica_")
        assert len(names) == 2
        x = _requests(1)[0]
        assert _post(lines[1].split()[1], x)[0] == 200
        proc.send_signal(signal.SIGTERM)
        assert proc.wait(timeout=60) == 0
        err = proc.stderr.read()
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait(timeout=30)
        proc.stdout.close()
        proc.stderr.close()
    steps = ["fleet stop: beacons draining", "fleet stop: watchers stopped",
             "fleet stop: servers stopped", "fleet stop: beacons gone"]
    at = [err.find(s) for s in steps]
    assert all(i >= 0 for i in at) and at == sorted(at), err[-3000:]
    for name in names:
        rec = DirMirror(str(bus)).get_meta(name)
        # up (1), draining (2), gone (3): the goodbye is the last beat
        assert rec["status"] == "gone" and rec["seq"] >= 3, rec


class _Recorder:
    """A stand-in InferenceServer that records what the launcher built."""

    def __init__(self, wf, port=0, replica=None, token=None, **kw):
        self.port, self.replica, self.token = port, replica, token
        self.watcher = self.fleet = None
        self.stopped = False

    def start(self):
        return self

    def model_info(self):
        return {k: None for k in ("dispatch", "ring_slots", "max_batch",
                                  "quantize")}

    def health(self):
        return {"status": "ok", "queue_limit": 64}

    def stop(self, drain_s=5.0):
        self.stopped = True


@pytest.mark.parametrize("port,advertise", [(0, ""), (18000, ""),
                                            (18000, "pod-a:7")])
def test_replica_ports_and_rids(port, advertise, wf_file, tmp_path,
                                monkeypatch):
    """--serve PORT gives the replicas PORT..PORT+N-1 (0: each picks its
    own), and a replica's rid is r{i}-{pid}, or r{i}-{host} under
    VELES_SERVE_ADVERTISE, whose host also goes into its beacon URL."""
    import veles_tpu_torch.serving as serving
    monkeypatch.setattr(serving, "InferenceServer", _Recorder)
    monkeypatch.setenv("VELES_SERVE_ADVERTISE", advertise)
    bus = str(tmp_path / "bus")
    srv = launcher.serve([wf_file, "--serve", str(port), "--serve-replicas",
                          "3", "--serve-announce", bus, "--device", "cpu"])
    servers = srv.fleet.servers
    suffix = advertise.replace(":", "-") if advertise else str(os.getpid())
    assert [s.port for s in servers] == ([0, 0, 0] if port == 0 else
                                         [port, port + 1, port + 2])
    assert [s.replica for s in servers] == [f"r{i}-{suffix}"
                                            for i in range(3)]
    recs = [DirMirror(bus).get_meta(beacon_name(s.replica)) for s in servers]
    assert [r["url"] for r in recs] == [
        f"http://{advertise or '127.0.0.1'}:{s.port}" for s in servers]
    srv.fleet.stop(drain_s=0)       # what the first server's stop() runs
    assert all(s.stopped for s in servers)
    assert all(DirMirror(bus).get_meta(beacon_name(s.replica))["status"]
               == "gone" for s in servers)
