"""Hot swap, rollback, the generation ledger and the WeightWatcher of the
port's server on the CPU: the port's counterparts of the JAX package's
tests/test_serving_swap.py cases that need no metrics registry, on the
same 24-wide tanh MLP (10 inputs, 4 classes), and the JAX ledger driven
beside the port's under one fake clock.

Every refusal keeps the current generation serving; a rollback gives the
earlier generation's outputs bit for bit (its tensors never left the
device); the watcher applies a mirror push under the mirror's sidecar
digest, refuses a corrupt copy (retryable), remembers a poisoned digest,
skips a rolled-back one until a newer one is pushed, and leaves the
process's PRNG registry as it was.
"""

import json
import os
import urllib.error
import urllib.request

import numpy as np
import pytest

from veles_tpu import serving_gen as jserving_gen
from veles_tpu.serving import params_digest as jax_params_digest
from veles_tpu_torch import prng
from veles_tpu_torch.loader.synthetic import SyntheticClassifierLoader
from veles_tpu_torch.resilience.mirror import (DirMirror, HttpMirror,
                                               MirrorServer)
from veles_tpu_torch.serving import (InferenceServer, SwapRefused,
                                     params_digest)
from veles_tpu_torch.serving_gen import GenerationLedger
from veles_tpu_torch.serving_watch import WeightWatcher
from veles_tpu_torch.snapshotter import Snapshotter
from veles_tpu_torch.znicz.standard_workflow import StandardWorkflow


def _make_workflow(width=24, sample=10, n_classes=4, seed=41):
    prng._generators.clear()
    prng.seed_all(seed)
    loader = SyntheticClassifierLoader(
        n_classes=n_classes, sample_shape=(sample,), n_validation=40,
        n_train=160, minibatch_size=40, noise=0.3)
    wf = StandardWorkflow(
        layers=[{"type": "all2all_tanh", "output_sample_shape": width,
                 "weights_stddev": 0.1},
                {"type": "softmax", "output_sample_shape": n_classes,
                 "weights_stddev": 0.05}],
        loader=loader, loss="softmax", n_classes=n_classes,
        decision_config={"max_epochs": 2, "fail_iterations": 50},
        gd_config={"learning_rate": 0.1, "gradient_moment": 0.9},
        name="SwapWF")
    wf.initialize("cpu")
    return wf


@pytest.fixture(autouse=True)
def _restore_base_seed():
    saved = prng._base_seed
    yield
    prng._base_seed = saved


@pytest.fixture(scope="module")
def swap_wf():
    return _make_workflow()


def _server(wf, **kw):
    kw.setdefault("ring_slots", 16)
    return InferenceServer(wf, device="cpu", **kw)


def _perturbed(wf, factor=1.01):
    """Same geometry, every parameter times `factor`."""
    for u in wf.forwards:
        for t in u.param_arrays().values():
            t.data.mul_(factor)
    return wf


def _x(n=6):
    return np.random.RandomState(8).randn(n, 10).astype(np.float32)


def _post(url, path="/predict", rows=None, token=None):
    body = json.dumps({"inputs": rows}).encode() if rows is not None \
        else b""
    req = urllib.request.Request(url + path, data=body, method="POST",
                                 headers={"Content-Type":
                                          "application/json"})
    if token:
        req.add_header("X-Veles-Token", token)
    try:
        with urllib.request.urlopen(req, timeout=30) as r:
            return r.status, json.loads(r.read())
    except urllib.error.HTTPError as e:
        raw = e.read()
        return e.code, json.loads(raw) if raw else None


# -- swap_params ------------------------------------------------------------


def test_swap_changes_outputs(swap_wf):
    srv = _server(swap_wf)
    before = np.asarray(srv.predict(_x())["outputs"])
    boot = srv.generation()
    assert boot["source"] == "boot"
    assert boot["digest"] == params_digest(swap_wf.params_host())
    gen = srv.swap_params(_perturbed(_make_workflow()), source="test")
    after = np.asarray(srv.predict(_x())["outputs"])
    assert not np.allclose(before, after)
    assert srv.generation()["digest"] == gen["digest"] != boot["digest"]
    assert gen["source"] == "test" and srv.n_swaps == 1


def test_swap_default_digest_is_the_jax_content_hash(swap_wf):
    srv = _server(swap_wf)
    cand = _perturbed(_make_workflow())
    host = cand.params_host()
    gen = srv.swap_params(cand)
    assert gen["digest"] == params_digest(host) == jax_params_digest(host)


def test_swap_geometry_refused_keeps_serving(swap_wf):
    srv = _server(swap_wf)
    before = np.asarray(srv.predict(_x())["outputs"])
    live = srv.generation()["digest"]
    with pytest.raises(SwapRefused) as exc:
        srv.swap_params(_make_workflow(width=32, seed=43))
    assert exc.value.reason == "geometry"
    assert srv.generation()["digest"] == live
    np.testing.assert_array_equal(np.asarray(srv.predict(_x())["outputs"]),
                                  before)
    h = srv.health()
    assert srv.n_swap_refusals == h["swaps"]["refused"] == 1
    assert h["swaps"]["last_refusal"]["reason"] == "geometry"


def test_swap_nonfinite_candidate_refused(swap_wf):
    srv = _server(swap_wf)
    bad = _make_workflow()
    next(iter(bad.forwards[0].param_arrays().values())).data.fill_(np.nan)
    with pytest.raises(SwapRefused) as exc:
        srv.swap_params(bad)
    assert exc.value.reason == "nonfinite"
    assert srv.generation()["source"] == "boot"


def test_swap_beyond_the_probe_bound_refused(swap_wf):
    """A wire whose candidate lies beyond SWAP_PROBE_TOL of its own f32
    forward: refused as `equivalence` (here a bf16 wire at a tolerance
    below its rounding)."""
    import veles_tpu_torch.serving as serving
    srv = _server(swap_wf, quantize="bf16")
    tol = serving.SWAP_PROBE_TOL
    serving.SWAP_PROBE_TOL = 1e-9
    try:
        with pytest.raises(SwapRefused) as exc:
            srv.swap_params(_perturbed(_make_workflow()))
    finally:
        serving.SWAP_PROBE_TOL = tol
    assert exc.value.reason == "equivalence"
    assert srv.swap_params(_perturbed(_make_workflow()))["source"] \
        == "watcher"


def test_swap_refused_under_merge(swap_wf):
    srv = InferenceServer(swap_wf, device="cpu", dispatch="merge",
                          max_batch=16)
    with pytest.raises(SwapRefused) as exc:
        srv.swap_params(_perturbed(_make_workflow()))
    assert exc.value.reason == "merge_core"


# -- rollback ---------------------------------------------------------------


def test_rollback_restores_previous_generation_bit_for_bit(swap_wf):
    srv = _server(swap_wf)
    before = np.asarray(srv.predict(_x())["outputs"])
    boot = srv.generation()["digest"]
    with pytest.raises(SwapRefused) as exc:
        srv.rollback()
    assert exc.value.reason == "no_previous"
    gen = srv.swap_params(_perturbed(_make_workflow()))
    swapped = np.asarray(srv.predict(_x())["outputs"])
    rb = srv.rollback()
    assert rb["digest"] == boot and rb["source"] == "rollback"
    np.testing.assert_array_equal(np.asarray(srv.predict(_x())["outputs"]),
                                  before)
    assert gen["digest"] in srv.rolled_back
    # a second rollback rolls forward again
    assert srv.rollback()["digest"] == gen["digest"]
    np.testing.assert_array_equal(np.asarray(srv.predict(_x())["outputs"]),
                                  swapped)


def test_rollback_http_endpoint_and_token(swap_wf):
    srv = _server(swap_wf, token="s3cret").start()
    try:
        url = f"http://127.0.0.1:{srv.port}"
        assert _post(url, "/rollback")[0] == 403
        status, resp = _post(url, "/rollback", token="s3cret")
        assert status == 409 and resp["reason"] == "no_previous"
        srv.swap_params(_perturbed(_make_workflow()))
        assert _post(url, "/rollback")[0] == 403
        assert srv.generation()["source"] == "watcher"
        status, resp = _post(url, "/rollback", token="s3cret")
        assert status == 200
        assert resp["generation"]["source"] == "rollback"
        assert srv.generation()["digest"] == resp["generation"]["digest"]
        status, resp = _post(url, rows=_x(2).tolist(), token="s3cret")
        assert status == 200 and len(resp["outputs"]) == 2
    finally:
        srv.stop(drain_s=0)


def test_healthz_exposes_generations(swap_wf):
    srv = _server(swap_wf).start()
    try:
        url = f"http://127.0.0.1:{srv.port}"
        with urllib.request.urlopen(url + "/healthz", timeout=10) as r:
            h = json.loads(r.read())
        assert h["generation"]["source"] == "boot"
        assert h["generation"]["serving_for_s"] >= 0
        assert h["previous_generation"] is None
        assert h["swaps"] == {"applied": 0, "refused": 0,
                              "last_refusal": None}
        old = h["generation"]["digest"]
        srv.swap_params(_perturbed(_make_workflow()))
        with urllib.request.urlopen(url + "/healthz", timeout=10) as r:
            h = json.loads(r.read())
        assert h["generation"]["digest"] != old
        assert h["previous_generation"] == old
        assert h["swaps"]["applied"] == 1
    finally:
        srv.stop(drain_s=0)


class _FakeClock:
    def __init__(self):
        self.t = 1000.0

    def time(self):
        self.t += 1.5
        return self.t

    def sleep(self, s):
        self.t += s


def test_generation_ledger_matches_jax_under_one_clock():
    ledgers = [GenerationLedger(_FakeClock()),
               jserving_gen.GenerationLedger(_FakeClock())]

    def state(g):
        return (g.snapshot(), g.prev_gen, g.params, g.prev_params,
                g.n_swaps, sorted(g.rolled_back))

    steps = [lambda g: g.boot("d0", "P0"),
             lambda g: g.commit("d1", "watcher", "P1"),
             lambda g: g.rollback(),
             lambda g: g.commit("d2", "test", "P2"),
             lambda g: g.rollback(),
             lambda g: g.rollback()]
    for step in steps:
        outs = [step(g) for g in ledgers]
        assert outs[0] == outs[1]
        assert state(ledgers[0]) == state(ledgers[1])
    assert ledgers[0].rolled_back == {"d1", "d2", "d0"}
    for cls in (GenerationLedger, jserving_gen.GenerationLedger):
        g = cls(_FakeClock())
        g.boot("d0", "P0")
        with pytest.raises(LookupError):
            g.rollback()


# -- the WeightWatcher ------------------------------------------------------


def _push_snapshot(wf, tmp_path, tag):
    snap = Snapshotter(workflow=wf, prefix="swapwf",
                       directory=str(tmp_path))
    snap.suffix = tag
    path = snap.export()
    with open(path + ".sha256") as f:
        return path, f.read().split()[0]


def _watcher(srv, mirror, tmp_path):
    return WeightWatcher(srv, mirror, prefix="swapwf", poll_s=60,
                         tmp_dir=str(tmp_path / "scratch"))


def test_watcher_applies_mirror_push(swap_wf, tmp_path):
    srv = _server(swap_wf)
    mirror = DirMirror(str(tmp_path / "mirror"))
    w = _watcher(srv, mirror, tmp_path)
    assert w.poll_once() is None        # an empty mirror: no error
    assert w.status()["streak"] == 0
    cand = _perturbed(_make_workflow())
    want = _server(cand).predict(_x())["outputs"]
    path, digest = _push_snapshot(cand, tmp_path, "gen1")
    assert mirror.push(path)
    gen = w.poll_once()
    assert gen["digest"] == digest and gen["source"] == "watcher"
    assert srv.generation()["digest"] == digest
    np.testing.assert_array_equal(np.asarray(srv.predict(_x())["outputs"]),
                                  np.asarray(want))
    assert w.poll_once() is None        # already live
    assert w.status()["n_applied"] == 1


def test_watcher_over_an_http_mirror(swap_wf, tmp_path):
    store = MirrorServer(str(tmp_path / "store"), token="tok").start()
    try:
        srv = _server(swap_wf)
        mirror = HttpMirror(store.url, token="tok", retries=1)
        w = _watcher(srv, mirror, tmp_path)
        path, digest = _push_snapshot(_perturbed(_make_workflow()),
                                      tmp_path, "gen1")
        assert mirror.push(path)
        assert w.poll_once()["digest"] == digest
        assert w.status()["mirror"] == store.url
    finally:
        store.stop()


def test_watcher_refuses_corrupt_push_and_keeps_serving(swap_wf, tmp_path):
    srv = _server(swap_wf)
    live = srv.generation()["digest"]
    mirror = DirMirror(str(tmp_path / "mirror"))
    w = _watcher(srv, mirror, tmp_path)
    path, _ = _push_snapshot(_perturbed(_make_workflow()), tmp_path, "torn")
    mirror.push(path)
    mirror._corrupt(os.path.basename(path))
    assert w.poll_once() is None
    st = w.status()
    assert st["n_refused"] == 1 and "fetch_failed" in st["last_error"]
    assert st["refused_digests"] == []     # retryable
    assert srv.generation()["digest"] == live
    assert srv.health()["swaps"]["last_refusal"]["reason"] == "fetch_failed"


def test_watcher_remembers_poisoned_digest(swap_wf, tmp_path):
    srv = _server(swap_wf)
    mirror = DirMirror(str(tmp_path / "mirror"))
    w = _watcher(srv, mirror, tmp_path)
    path, digest = _push_snapshot(_make_workflow(width=32, seed=43),
                                  tmp_path, "wide")
    mirror.push(path)
    assert w.poll_once() is None
    st = w.status()
    assert st["n_refused"] == 1 and "geometry" in st["last_error"]
    assert st["refused_digests"] == [digest[:12]]
    assert w.poll_once() is None        # remembered: no refusal churn
    assert w.status()["n_refused"] == 1
    assert srv.generation()["source"] == "boot"
    assert srv.health()["swaps"]["refused"] == 1


def test_watcher_skips_rolled_back_digest(swap_wf, tmp_path):
    srv = _server(swap_wf)
    mirror = DirMirror(str(tmp_path / "mirror"))
    w = _watcher(srv, mirror, tmp_path)
    cand = _perturbed(_make_workflow())
    path, digest = _push_snapshot(cand, tmp_path, "gen1")
    mirror.push(path)
    assert w.poll_once()["digest"] == digest
    rb = srv.rollback()
    assert w.poll_once() is None        # still the newest: pinned
    assert srv.generation()["digest"] == rb["digest"]
    path2, digest2 = _push_snapshot(_perturbed(cand), tmp_path, "gen2")
    mirror.push(path2)
    assert w.poll_once()["digest"] == digest2


def test_watcher_import_leaves_the_prng_registry(swap_wf, tmp_path):
    srv = _server(swap_wf)
    mirror = DirMirror(str(tmp_path / "mirror"))
    w = _watcher(srv, mirror, tmp_path)
    path, _ = _push_snapshot(_perturbed(_make_workflow()), tmp_path, "gen1")
    mirror.push(path)
    prng.seed_all(12345)
    marker = prng.get().randint(0, 10 ** 6, size=8)
    prng.seed_all(12345)
    assert w.poll_once() is not None
    np.testing.assert_array_equal(prng.get().randint(0, 10 ** 6, size=8),
                                  marker)
