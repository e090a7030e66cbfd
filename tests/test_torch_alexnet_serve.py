"""The port's served AlexNet on the CPU, held against the JAX package.

Toy geometry of `__graft_entry__.py` (input_hw 67, width_mult 0.125,
fc_width 64, 16 classes), plus input_hw 71, whose pools end in ceil-mode
edge windows. One seed gives both packages the same loader shuffle and
bit-identical initial parameters (numpy streams in both); the served
outputs are held against the JAX `InferenceServer` under both
`lrn_maxpool` settings: the port's `composed` against JAX's
`lrn=pallas_one_pass`, the port's `fused` against JAX's fused point, the
Pallas kernels in interpret mode.

Tolerance of the served softmax outputs: rtol 1e-4, atol 1e-6. Both sides
run in f32 (the test conftest pins JAX matmuls to "highest"), but XLA's
and PyTorch's convolutions and matrix products sum in other orders; the
differences stay near f32 rounding, and the classes must be equal.
"""

import http.client
import json
import socket
import urllib.error
import urllib.request

import numpy as np
import pytest
import torch

from veles_tpu import prng as jprng
from veles_tpu.ops import variants as jvariants
from veles_tpu.samples import alexnet as jalexnet
from veles_tpu.serving import InferenceServer as JaxServer
from veles_tpu_torch import prng
from veles_tpu_torch.convert import params_from_jax
from veles_tpu_torch.ops import kernels, variants
from veles_tpu_torch.samples import alexnet
from veles_tpu_torch.serving import InferenceServer

TOY = dict(minibatch_size=8, width_mult=0.125, fc_width=64, n_train=8,
           n_validation=4, n_classes=16)
RING = 8
JAX_FUSED = "fused[rt=2,io=native,fuse=1]"


@pytest.fixture(autouse=True)
def _restore_base_seeds():
    """seed_all sets a module-global base seed in each package; later tests
    in this process must not inherit this file's."""
    saved = jprng._base_seed, prng._base_seed
    yield
    jprng._base_seed, prng._base_seed = saved


def _jax_wf(hw, init="reference", seed=7):
    jprng._generators.clear()
    jprng.seed_all(seed)
    wf = jalexnet.create_workflow(input_hw=hw, init=init, **TOY)
    wf.initialize(device=None)
    return wf


def _port_wf(hw, init="reference", seed=7):
    prng._generators.clear()
    prng.seed_all(seed)
    wf = alexnet.create_workflow(input_hw=hw, init=init, **TOY)
    wf.initialize("cpu")
    return wf


def _jax_params(wf):
    return tuple({k: np.asarray(a.mem) for k, a in u.param_arrays().items()}
                 for u in wf.forwards)


class _Selected:
    """Select registry variants for a block and restore the previous
    selections afterwards (the registries are process-global)."""

    def __init__(self, registry, **sel):
        self.registry, self.sel = registry, sel

    def __enter__(self):
        self.prev = {op: self.registry.selected(op) for op in self.sel}
        for op, name in self.sel.items():
            self.registry.select(op, name)

    def __exit__(self, *exc):
        for op, name in self.prev.items():
            if name is None:
                self.registry.clear_selection(op)
            else:
                self.registry.select(op, name)


@pytest.mark.parametrize("hw,init", [(67, "reference"), (67, "scaled"),
                                     (71, "scaled")])
def test_initial_params_equal_jax_under_one_seed(hw, init):
    jparams = _jax_params(_jax_wf(hw, init))
    pparams = _port_wf(hw, init).params_host()
    assert len(jparams) == len(pparams)
    for i, (a, b) in enumerate(zip(jparams, pparams)):
        assert sorted(a) == sorted(b), i
        for k in a:
            assert a[k].shape == b[k].shape, (i, k)
            np.testing.assert_array_equal(a[k], b[k], err_msg=f"{i} {k}")


def test_loader_minibatches_equal_jax():
    jwf, pwf = _jax_wf(67), _port_wf(67)
    assert tuple(jwf.loader.minibatch_data.shape[1:]) \
        == pwf.loader.sample_shape
    for _ in range(4):      # validation batch, then into the train pass
        jwf.loader.run()
        pwf.loader.run()
        for name in ("minibatch_data", "minibatch_labels",
                     "minibatch_indices", "minibatch_valid"):
            np.testing.assert_array_equal(
                np.asarray(getattr(jwf.loader, name).mem),
                getattr(pwf.loader, name), err_msg=name)
        assert int(jwf.loader.minibatch_class) \
            == pwf.loader.minibatch_class
    jwf._stop_units()


def test_params_from_jax_roundtrips_and_checks():
    jparams = _jax_params(_jax_wf(67, "scaled", seed=3))
    pwf = _port_wf(67, "scaled", seed=4)
    assert not np.array_equal(pwf.params_host()[0]["weights"],
                              jparams[0]["weights"])
    out = params_from_jax(jparams, "cpu", pwf)
    assert len(out) == len(jparams)
    for a, b, t in zip(jparams, pwf.params_host(), out):
        for k in a:
            np.testing.assert_array_equal(a[k], b[k])
            np.testing.assert_array_equal(a[k], t[k].numpy())
    bad_shape = tuple(dict(p) for p in jparams)
    bad_shape[0]["weights"] = bad_shape[0]["weights"][:-1]
    with pytest.raises(ValueError, match="shape"):
        params_from_jax(bad_shape, "cpu", pwf)
    bad_name = tuple(dict(p) for p in jparams)
    bad_name[0]["kernel"] = bad_name[0].pop("weights")
    with pytest.raises(ValueError, match="names"):
        params_from_jax(bad_name, "cpu", pwf)
    with pytest.raises(ValueError, match="forward units"):
        params_from_jax(jparams[:-1], "cpu", pwf)


@pytest.mark.parametrize("hw,lrn_maxpool", [(67, "composed"),
                                            (67, "fused"),
                                            (71, "fused")])
def test_served_predict_matches_jax_server(hw, lrn_maxpool):
    jwf = _jax_wf(hw, "scaled")
    jax_sel = ({"lrn": "pallas_one_pass"} if lrn_maxpool == "composed"
               else {"lrn_maxpool": JAX_FUSED})
    with jvariants.pallas_interpret(), _Selected(jvariants, **jax_sel):
        jsrv = JaxServer(jwf, mesh="off", aot_cache=None, max_batch=RING)
        assert jsrv._step.variant_table()[
            "lrn_maxpool" if lrn_maxpool == "fused" else "lrn"] \
            in (JAX_FUSED, "pallas_one_pass")
    pwf = alexnet.create_workflow(input_hw=hw, init="scaled", **TOY)
    pwf.initialize("cpu")
    params_from_jax(_jax_params(jwf), "cpu", pwf)
    with _Selected(variants, lrn_maxpool=lrn_maxpool):
        psrv = InferenceServer(pwf, ring_slots=RING, device="cpu")
    pairs = len(psrv._fwd.pairs)
    assert pairs == (2 if lrn_maxpool == "fused" else 0)
    x = np.random.RandomState(hw).randn(5, hw, hw, 3).astype(np.float32)
    want = jsrv.predict(x)
    got = psrv.predict(x)
    np.testing.assert_allclose(np.asarray(got["outputs"]),
                               np.asarray(want["outputs"]),
                               rtol=1e-4, atol=1e-6)
    assert got["classes"] == want["classes"]
    assert np.asarray(got["outputs"]).shape == (5, 16)
    jwf._stop_units()


def _post(url, payload, token=None):
    req = urllib.request.Request(url, data=json.dumps(payload).encode(),
                                 method="POST")
    req.add_header("Content-Type", "application/json")
    if token:
        req.add_header("X-Veles-Token", token)
    try:
        with urllib.request.urlopen(req, timeout=30) as r:
            return r.status, json.loads(r.read())
    except urllib.error.HTTPError as e:
        return e.code, None


def test_http_round_trip_on_loopback():
    pwf = _port_wf(67)
    srv = InferenceServer(pwf, ring_slots=4, device="cpu", token="s3cret",
                          max_body=1 << 20).start()
    try:
        base = f"http://127.0.0.1:{srv.port}"
        x = np.random.RandomState(0).randn(3, 67, 67, 3).astype(np.float32)
        code, resp = _post(base + "/predict", {"inputs": x.tolist()},
                           token="s3cret")
        assert code == 200
        out = np.asarray(resp["outputs"])
        assert out.shape == (3, 16) and np.isfinite(out).all()
        np.testing.assert_allclose(out.sum(axis=1), 1.0, atol=1e-5)
        assert resp["classes"] == out.argmax(axis=1).tolist()
        assert resp == srv.predict(x)
        assert _post(base + "/predict", {"inputs": x.tolist()})[0] == 403
        # a body above max_body is refused from its Content-Length alone
        conn = http.client.HTTPConnection("127.0.0.1", srv.port, timeout=30)
        conn.putrequest("POST", "/predict")
        conn.putheader("X-Veles-Token", "s3cret")
        conn.putheader("Content-Length", str((1 << 20) + 1))
        conn.endheaders()
        assert conn.getresponse().status == 413
        conn.close()
        assert _post(base + "/predict", {"inputs": x[:, :5].tolist()},
                     token="s3cret")[0] == 400
        with urllib.request.urlopen(base + "/healthz", timeout=30) as r:
            health = json.loads(r.read())
        assert health["status"] == "ok" and health["n_dispatches"] >= 2
        with urllib.request.urlopen(base + "/info", timeout=30) as r:
            info = json.loads(r.read())
        assert info["input_shape"] == [67, 67, 3]
        assert info["variants"]["lrn_maxpool"] == "fused"
        assert set(info["kernel_launches"]) == set(kernels.INSTANCES)
    finally:
        srv.stop()
    assert srv._batcher is None


def test_refused_request_is_answered_after_its_body():
    """A request refused for its token is answered only once its body is
    in: answering while the client still sends, then closing with the
    body unread, resets the connection, and the client sees a broken pipe
    in place of the 403."""
    srv = InferenceServer(_port_wf(67), ring_slots=4, device="cpu",
                          token="s3cret", max_body=1 << 20).start()
    try:
        body = b"x" * 4096
        with socket.create_connection(("127.0.0.1", srv.port),
                                      timeout=30) as s:
            s.sendall(b"POST /predict HTTP/1.1\r\nHost: t\r\n"
                      b"Content-Length: %d\r\n\r\n" % len(body)
                      + body[:1024])
            s.settimeout(0.5)
            with pytest.raises(socket.timeout):
                s.recv(1)
            s.settimeout(30)
            s.sendall(body[1024:])
            reply = s.makefile("rb").readline()
        assert reply.split()[1] == b"403", reply
    finally:
        srv.stop()


def test_overload_sheds_with_503():
    pwf = _port_wf(67)
    srv = InferenceServer(pwf, ring_slots=4, device="cpu", queue_limit=0)
    x = np.zeros((1, 67, 67, 3), np.float32)
    with pytest.raises(RuntimeError, match="overloaded"):
        srv.predict(x)
    assert srv.n_rejected == 1
    with pytest.raises(ValueError, match="rows"):
        InferenceServer(pwf, ring_slots=2, device="cpu").predict(
            np.zeros((3, 67, 67, 3), np.float32))


def test_fused_forward_freezes_its_lowerings():
    """A built forward keeps what it resolved: the registry changing later
    does not change what a running server serves."""
    pwf = _port_wf(67)
    with _Selected(variants, lrn_maxpool="fused"):
        fwd = pwf.build_forward()
    with _Selected(variants, lrn_maxpool="composed"):
        assert fwd.fusion_pairs() == []        # resolved fresh
        # the stem (conv1) and the pool after conv5 report their own
        # lowerings; the claimed pairs, theirs
        assert fwd.variant_table() == {"conv_stem": "direct",
                                       "maxpool": "reduce_window",
                                       "lrn_maxpool": "fused",
                                       "lrn": "lrn_maxpool/fused"}
        composed = pwf.build_forward()
        assert composed.variant_table() == {"conv_stem": "direct",
                                            "lrn": "kernel",
                                            "maxpool": "reduce_window"}
    x = torch.from_numpy(
        np.random.RandomState(5).randn(2, 67, 67, 3).astype(np.float32))
    np.testing.assert_allclose(fwd._forward(fwd.params(), x).numpy(),
                               composed._forward(composed.params(),
                                                 x).numpy(),
                               rtol=1e-5, atol=1e-6)


def test_forward_on_the_card_runs_without_tf32(monkeypatch):
    """The served forward turns TF32 off for itself on the card (PyTorch
    lets cuDNN use it by default) and leaves the process's flags as they
    were. Here the forward's device is only labelled `cuda`: its tensors
    stay on the CPU, where the flags are read but change nothing."""
    pwf = _port_wf(67)
    fwd = pwf.build_forward()
    fwd.device = torch.device("cuda", 0)
    seen = []
    conv = fwd.forwards[0]
    inner = conv.fused_apply

    def recording(*args, **kwargs):
        seen.append((torch.backends.cudnn.allow_tf32,
                     torch.backends.cuda.matmul.allow_tf32))
        return inner(*args, **kwargs)

    monkeypatch.setattr(conv, "fused_apply", recording)
    monkeypatch.setattr(torch.backends.cudnn, "allow_tf32", True)
    monkeypatch.setattr(torch.backends.cuda.matmul, "allow_tf32", True)
    x = torch.zeros(1, 67, 67, 3)
    fwd._forward(fwd.params(), x)
    assert seen == [(False, False)]
    assert torch.backends.cudnn.allow_tf32
    assert torch.backends.cuda.matmul.allow_tf32


def test_queued_request_times_out_behind_others():
    """A request that misses its deadline while queued behind another is
    answered RequestTimeout and leaves the queue; the one ahead of it
    still completes once the ring frees."""
    import threading
    import time

    pwf = _port_wf(67)
    srv = InferenceServer(pwf, ring_slots=4, device="cpu").start()
    gate = threading.Event()
    inner = srv._forward_ring

    def held(x):            # the next round blocks until the gate opens
        gate.wait(30)
        return inner(x)

    srv._forward_ring = held
    x = np.zeros((4, 67, 67, 3), np.float32)
    results = {}

    def call(name):
        try:
            results[name] = srv.predict(x.copy())   # an array of its own
        except RuntimeError as e:
            results[name] = e

    try:
        first = threading.Thread(target=call, args=("first",))
        first.start()                      # occupies the ring
        time.sleep(0.5)
        srv.request_timeout_s = 30.0
        ahead = threading.Thread(target=call, args=("ahead",))
        ahead.start()                      # queued, long deadline
        time.sleep(0.3)
        srv.request_timeout_s = 0.3
        call("late")                       # queued behind it, times out
        assert type(results["late"]).__name__ == "RequestTimeout"
        assert srv.n_timeouts == 1
        gate.set()
        first.join(30)
        ahead.join(30)
        assert not first.is_alive() and not ahead.is_alive()
        for name in ("first", "ahead"):
            assert np.asarray(results[name]["outputs"]).shape == (4, 16)
    finally:
        gate.set()
        srv.stop()
