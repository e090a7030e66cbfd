"""The port's serving wires and merge core on the CPU, held against the
JAX package.

A narrow conv -> LRN -> max pool -> FC -> softmax net (27x27x3 input, 8
kernels, an FC of 96 units: its weight is the one leaf whose last axis
holds a whole int8 block of 64, the padding of the second block
included; the conv weight and the head stay f32) gets the JAX
workflow's seeded parameters in both packages (`convert.params_from_
jax`). The JAX server runs on the CPU with `mesh="off"`,
`aot_cache=None`, its fused LRN -> pool point in Pallas interpret mode;
the port's runs its fused pair's plain version (K4's, on a CPU tensor).

Tolerances of the served softmax outputs against the JAX server's:
- f32 and int8: 1e-5 (both f32 forwards; the int8 wire decodes the same
  codes to the same f32 weights, so only the two frameworks' summation
  orders differ, near f32 rounding);
- bf16: BF16_ATOL = 2^-9. Both packages compute each layer in bf16 and
  round its output to bf16, but XLA's and PyTorch's CPU convolutions and
  matrix products sum in other orders, so an activation may round to
  the neighbouring bf16 value. The logits of this net stay below 1 in
  magnitude (its largest probability is under 0.3 over 10 classes), so
  a bf16 ulp of a logit is at most 2^-8; two such ulps through the
  softmax's slope (at most 1/4) move a probability by at most 2^-9.
  (Measured: at most 3.1e-4 over four seeds.)
"""

import threading
import time
import types

import numpy as np
import pytest
import torch

from veles_tpu import prng as jprng
from veles_tpu.launcher import Launcher as JaxLauncher
from veles_tpu.loader.synthetic import \
    SyntheticClassifierLoader as JaxLoader
from veles_tpu.ops import templates as jtemplates
from veles_tpu.ops import variants as jvariants
from veles_tpu.serving import InferenceServer as JaxServer
from veles_tpu.serving import params_digest as jax_params_digest
from veles_tpu.znicz.standard_workflow import \
    StandardWorkflow as JaxWorkflow
from veles_tpu_torch import launcher, prng
from veles_tpu_torch.convert import params_from_jax
from veles_tpu_torch.loader.synthetic import SyntheticClassifierLoader
from veles_tpu_torch.ops import reference, templates, variants
from veles_tpu_torch.serving import InferenceServer, params_digest
from veles_tpu_torch.znicz.standard_workflow import StandardWorkflow

HW, RING, N_CLASSES = 27, 8, 10
LAYERS = [
    {"type": "conv_strictrelu", "n_kernels": 8, "kx": 5, "ky": 5,
     "stride": (2, 2), "padding": (0, 0), "weights_stddev": 0.1},
    {"type": "norm", "k": 2.0, "alpha": 1e-4, "beta": 0.75, "n": 5},
    {"type": "max_pooling", "ksize": (3, 3), "stride": (2, 2)},
    {"type": "all2all_strictrelu", "output_sample_shape": 96,
     "weights_stddev": 0.05},
    {"type": "softmax", "output_sample_shape": N_CLASSES,
     "weights_stddev": 0.1},
]
JAX_FUSED = "fused[rt=2,io=native,fuse=1]"
WIRES = ("f32", "bf16", "int8")
BF16_ATOL = 2.0 ** -9


@pytest.fixture(autouse=True)
def _restore_base_seeds():
    saved = jprng._base_seed, prng._base_seed
    yield
    jprng._base_seed, prng._base_seed = saved


def _loader_kw():
    return dict(n_classes=N_CLASSES, sample_shape=(HW, HW, 3),
                n_validation=8, n_train=16, minibatch_size=8, noise=0.5)


def _jax_wf(seed=5):
    jprng._generators.clear()
    jprng.seed_all(seed)
    wf = JaxWorkflow(layers=LAYERS, loader=JaxLoader(**_loader_kw()),
                     loss="softmax", n_classes=N_CLASSES, name="WireWF")
    wf.initialize(device=None)
    return wf


def _jax_params(wf):
    return tuple({k: np.asarray(a.mem) for k, a in u.param_arrays().items()}
                 for u in wf.forwards)


def _port_wf(jparams=None):
    wf = StandardWorkflow(
        layers=LAYERS, loader=SyntheticClassifierLoader(**_loader_kw()),
        loss="softmax", n_classes=N_CLASSES, name="WireWF")
    wf.initialize("cpu")
    if jparams is not None:
        params_from_jax(jparams, "cpu", wf)
    return wf


@pytest.fixture(scope="module")
def jwf():
    wf = _jax_wf()
    yield wf
    wf._stop_units()


@pytest.fixture(scope="module")
def jparams(jwf):
    return _jax_params(jwf)


@pytest.fixture(scope="module")
def jax_servers(jwf):
    """One JAX ring server per wire (fused LRN -> pool point, Pallas
    interpreted), built once."""
    prev = jvariants.selected("lrn_maxpool")
    out = {}
    try:
        with jvariants.pallas_interpret():
            jvariants.select("lrn_maxpool", JAX_FUSED)
            for q in WIRES:
                out[q] = JaxServer(jwf, mesh="off", aot_cache=None,
                                   max_batch=RING, quantize=q)
    finally:
        if prev is None:
            jvariants.clear_selection("lrn_maxpool")
        else:
            jvariants.select("lrn_maxpool", prev)
    return out


@pytest.fixture(scope="module")
def port_servers(jparams):
    return {q: InferenceServer(_port_wf(jparams), ring_slots=RING,
                               device="cpu", quantize=q) for q in WIRES}


def _x(n, seed=3):
    return np.random.RandomState(seed).randn(n, HW, HW, 3).astype(
        np.float32)


# -- the wire transform -----------------------------------------------------


@pytest.mark.parametrize("wire", WIRES)
def test_prepare_params_equals_jax_bit_for_bit(wire, jparams):
    jprep, jshapes = jvariants.serve_prepare_params(wire, jparams)
    prep, shapes = variants.serve_prepare_params(wire, jparams)
    assert shapes == jshapes
    quantized = 0
    for jl, pl, src in zip(jprep, prep, jparams):
        assert sorted(jl) == sorted(pl)
        for k in jl:
            if isinstance(jl[k], dict):
                quantized += 1
                q, s = reference.serve_quantize_weight(src[k], 64)
                np.testing.assert_array_equal(pl[k]["q"].numpy(),
                                              np.asarray(jl[k]["q"]))
                np.testing.assert_array_equal(pl[k]["s"].numpy(),
                                              np.asarray(jl[k]["s"]))
                np.testing.assert_array_equal(pl[k]["q"].numpy(), q)
                np.testing.assert_array_equal(pl[k]["s"].numpy(), s)
                assert pl[k]["q"].dtype == torch.int8
            elif wire == "bf16":
                assert pl[k].dtype == torch.bfloat16
                np.testing.assert_array_equal(
                    pl[k].view(torch.int16).numpy(),
                    np.asarray(jl[k]).view(np.int16))
            else:
                # left untouched: the f32 leaf, bit for bit
                np.testing.assert_array_equal(pl[k].numpy(), src[k])
                np.testing.assert_array_equal(np.asarray(jl[k]), src[k])
    # int8 quantizes the FC weight alone (96 >= 64 columns)
    assert quantized == (1 if wire == "int8" else 0)
    assert variants.serve_param_bytes(prep) \
        == jvariants.serve_param_bytes(jprep)


def test_params_digest_equals_jax(jparams):
    assert params_digest(jparams) == jax_params_digest(jparams)
    moved = tuple(dict(layer) for layer in jparams)
    moved[0]["bias"] = moved[0]["bias"] + np.float32(1e-3)
    assert params_digest(moved) != params_digest(jparams)


def test_q8_decode_is_the_reference_dequantize():
    w = np.random.RandomState(2).randn(40, 150).astype(np.float32)
    q, s = reference.serve_quantize_weight(w, 64)
    got = variants.q8_decode(torch.from_numpy(q), torch.from_numpy(s), 64)
    np.testing.assert_array_equal(got.numpy(),
                                  reference.dequantize_blockwise(q, s, 64))


# -- the equivalence ledger -------------------------------------------------


@pytest.mark.parametrize("wire", WIRES)
def test_serve_forward_contract_passes(wire):
    rec = templates.check_equivalence("serve_forward", wire, force=True,
                                      device="cpu")
    assert rec["status"] == "pass", rec
    assert jtemplates.check_equivalence("serve_forward", wire)["status"] \
        == "pass"


def test_serve_forward_contract_fails_a_mutant_quantizer(monkeypatch):
    """Scales one ulp off the reference quantizer's: the bitwise check of
    the int8 transform refuses the wire, and the server with it."""
    inner = variants.serve_prepare_params

    def mutant(name, params):
        prep, shapes = inner(name, params)
        for layer in prep:
            for v in layer.values():
                if isinstance(v, dict):
                    s = v["s"].numpy()
                    v["s"] = torch.from_numpy(
                        np.nextafter(s, np.float32(np.inf)))
        return prep, shapes

    monkeypatch.setattr(variants, "serve_prepare_params", mutant)
    try:
        rec = templates.check_equivalence("serve_forward", "int8",
                                          force=True, device="cpu")
        assert rec["status"] == "fail"
        assert "not equal" in rec["error"].lower() \
            or "mismatch" in rec["error"].lower(), rec
    finally:
        monkeypatch.undo()
        assert templates.check_equivalence(
            "serve_forward", "int8", force=True,
            device="cpu")["status"] == "pass"


def test_wire_without_passing_record_is_refused_unserved(jparams):
    key = ("serve_forward", "bf16")
    prev = templates._LEDGER.get(key)
    templates._LEDGER[key] = {"status": "fail", "error": "forced"}
    try:
        with pytest.raises(ValueError, match="refused unserved"):
            InferenceServer(_port_wf(jparams), ring_slots=RING,
                            device="cpu", quantize="bf16")
    finally:
        if prev is None:
            templates._LEDGER.pop(key, None)
        else:
            templates._LEDGER[key] = prev


def test_constructor_refusals(jparams):
    wf = _port_wf(jparams)
    with pytest.raises(ValueError, match="quantize"):
        InferenceServer(wf, device="cpu", quantize="int4")
    with pytest.raises(ValueError, match="dispatch"):
        InferenceServer(wf, device="cpu", dispatch="bogus")
    with pytest.raises(ValueError, match="ring"):
        InferenceServer(wf, device="cpu", dispatch="merge",
                        quantize="int8")
    with pytest.raises(ValueError, match="ring_slots"):
        InferenceServer(wf, device="cpu", dispatch="merge", ring_slots=8)
    with pytest.raises(ValueError, match="ring_slots"):
        InferenceServer(wf, device="cpu", ring_slots=0)
    with pytest.raises(ValueError, match="whole max_batch"):
        InferenceServer(wf, device="cpu", ring_slots=4, max_batch=8)


# -- served outputs against the JAX server ----------------------------------


@pytest.mark.parametrize("wire", WIRES)
def test_served_wire_matches_jax_server(wire, jax_servers, port_servers):
    jsrv, psrv = jax_servers[wire], port_servers[wire]
    x = _x(5)
    want, got = jsrv.predict(x), psrv.predict(x)
    atol = BF16_ATOL if wire == "bf16" else 1e-5
    np.testing.assert_allclose(np.asarray(got["outputs"]),
                               np.asarray(want["outputs"]), rtol=0,
                               atol=atol)
    assert np.asarray(got["outputs"]).shape == (5, N_CLASSES)
    info, jinfo = psrv.model_info(), jsrv.model_info()
    assert info["quantize"] == jinfo["quantize"] == wire
    assert info["param_bytes"] == jinfo["param_bytes"]
    if wire != "f32":
        assert info["param_bytes"]["wire"] < info["param_bytes"]["f32"]
        # and within the serving tolerance of the port's f32 wire
        f32 = np.asarray(port_servers["f32"].predict(x)["outputs"])
        assert np.abs(np.asarray(got["outputs"]) - f32).max() < 0.05
    assert psrv.generation()["digest"] == params_digest(
        _jax_params(jsrv.workflow))


def test_bf16_wire_computes_in_bf16(port_servers, monkeypatch):
    """The bf16 wire hands the forward bf16 params and a bf16 input, and
    the LRN -> pool pair gets them as they are (no f32 cast around it)."""
    psrv = port_servers["bf16"]
    seen = []
    pair = psrv._fwd.pairs[0][2]
    inner = pair.apply

    def spy(x, **kw):
        seen.append(x.dtype)
        return inner(x, **kw)

    monkeypatch.setattr(psrv._fwd, "_plan", [
        (k, j, types.SimpleNamespace(apply=spy, name=v.name)
         if k == "pair" else v) for k, j, v in psrv._fwd._plan])
    psrv.predict(_x(2))
    assert seen == [torch.bfloat16]
    assert all(t.dtype == torch.bfloat16
               for layer in psrv._gens.params for t in layer.values())


# -- the merge core ---------------------------------------------------------


def test_merge_buckets_as_jax():
    for cap in (1, 6, 8, 64):
        ns = types.SimpleNamespace(max_batch=cap)
        for n in range(1, 70):
            assert InferenceServer._bucket(ns, n) \
                == JaxServer._bucket(ns, n), (cap, n)


def test_merge_serves_as_the_ring(jparams, port_servers):
    srv = InferenceServer(_port_wf(jparams), max_batch=RING,
                          dispatch="merge", device="cpu")
    assert srv.ring_slots is None and srv.health()["dispatch"] == "merge"
    for n in (1, 3, 8):
        x = _x(n, seed=n)
        before = srv.n_dispatches
        got = np.asarray(srv.predict(x)["outputs"])
        assert srv.n_dispatches == before + 1
        want = np.asarray(port_servers["f32"].predict(x)["outputs"])
        np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-7)
    with pytest.raises(ValueError, match="rows"):
        srv.predict(_x(RING + 1))
    assert "param_bytes" not in srv.model_info()


def test_merge_coalesces_queued_requests(jparams):
    """While one merged round runs, three requests queue; the next round
    takes them together: one dispatch, padded to bucket 8 for 7 rows."""
    srv = InferenceServer(_port_wf(jparams), max_batch=RING,
                          dispatch="merge", batch_window_ms=50,
                          device="cpu").start()
    gate, entered = threading.Event(), threading.Event()
    inner = srv._forward_now
    shapes = []

    def held(x):
        shapes.append(len(x))
        if len(shapes) == 1:
            entered.set()
            gate.wait(30)
        return inner(x)

    srv._forward_now = held
    results = {}

    def call(name, n):
        results[name] = srv.predict(_x(n, seed=n))

    try:
        first = threading.Thread(target=call, args=("first", 1))
        first.start()
        assert entered.wait(30)
        before = srv.n_dispatches
        queued = [threading.Thread(target=call, args=(f"q{n}", n))
                  for n in (1, 2, 4)]
        for t in queued:
            t.start()
        deadline = time.time() + 30
        while len(srv._pending) < 3 and time.time() < deadline:
            time.sleep(0.01)
        assert len(srv._pending) == 3
        gate.set()
        for t in [first] + queued:
            t.join(30)
            assert not t.is_alive()
        assert srv.n_dispatches == before + 1
        assert shapes == [1, 8]
        for n in (1, 2, 4):
            assert np.asarray(results[f"q{n}"]["outputs"]).shape \
                == (n, N_CLASSES)
    finally:
        gate.set()
        srv.stop()


# -- the launcher -----------------------------------------------------------

#: (JAX Launcher keywords, the port's argv after `wf.py --serve 0`, or
#: None for a knob given without --serve)
REFUSALS = [
    ({"serve_batch": 8}, ["--serve-batch", "8"], False),
    ({"serve_dispatch": "merge"}, ["--serve-dispatch", "merge"], False),
    ({"serve_quantize": "int8"}, ["--serve-quantize", "int8"], False),
    ({"serve_ring": 64}, ["--serve-ring", "64"], False),
    ({"serve_watch_mirror": "m"}, ["--serve-watch-mirror", "m"], False),
    ({"serve": 0, "serve_ring": 0}, ["--serve-ring", "0"], True),
    ({"serve": 0, "serve_batch": 0}, ["--serve-batch", "0"], True),
    ({"serve": 0, "serve_ring": 32, "serve_batch": 64},
     ["--serve-ring", "32", "--serve-batch", "64"], True),
    ({"serve": 0, "serve_ring": 128, "serve_dispatch": "merge"},
     ["--serve-ring", "128", "--serve-dispatch", "merge"], True),
    ({"serve": 0, "serve_dispatch": "merge", "serve_quantize": "int8"},
     ["--serve-dispatch", "merge", "--serve-quantize", "int8"], True),
    ({"serve": 0, "serve_dispatch": "merge", "serve_watch_mirror": "m"},
     ["--serve-dispatch", "merge", "--serve-watch-mirror", "m"], True),
]


@pytest.mark.parametrize("jax_kw,argv,serving", REFUSALS)
def test_launcher_refusals_exit_as_jax(jax_kw, argv, serving):
    with pytest.raises(SystemExit):
        JaxLauncher(**jax_kw)
    head = ["wf.py", "--serve", "0"] if serving else ["wf.py"]
    with pytest.raises(SystemExit) as e:
        launcher.parse_args(head + argv)
    assert e.value.code == 2


def test_launcher_accepts_the_knobs():
    ln = JaxLauncher(serve=0, serve_ring=128, serve_dispatch="ring",
                     serve_quantize="bf16", serve_batch=32,
                     serve_watch_mirror="m")
    args = launcher.parse_args(
        ["wf.py", "--serve", "0", "--serve-ring", "128", "--serve-dispatch",
         "ring", "--serve-quantize", "bf16", "--serve-batch", "32",
         "--serve-watch-mirror", "m"])
    assert (args.serve_ring, args.serve_quantize, args.serve_batch,
            args.serve_watch_mirror) == (ln.serve_ring, ln.serve_quantize,
                                         ln.serve_batch,
                                         ln.serve_watch_mirror)
    assert JaxLauncher(serve=0, serve_dispatch="merge").serve_dispatch \
        == launcher.parse_args(["wf.py", "--serve", "0", "--serve-dispatch",
                                "merge"]).serve_dispatch == "merge"
    with pytest.raises(SystemExit):
        launcher.parse_args(["wf.py", "--serve", "0", "--serve-dispatch",
                             "bogus"])
    # the trainer's --mirror: refused with --serve, kept for training
    with pytest.raises(SystemExit):
        launcher.parse_args(["wf.py", "--serve", "0", "--mirror", "m"])
    assert launcher.parse_args(["wf.py", "--fused", "--mirror",
                                "m"]).mirror == "m"


def test_cli_serves_an_int8_wire_under_a_request_cap(tmp_path):
    """`--serve 0 --serve-quantize int8 --serve-batch 4` through
    launcher.serve on the toy AlexNet: the cap and the ring from the
    flags, the int8 wire's bytes in /info."""
    from veles_tpu_torch.config import root
    from veles_tpu_torch.samples import alexnet
    saved = root.alexnet.to_dict()
    try:
        srv = launcher.serve([alexnet.__file__, "--serve", "0", "--device",
                              "cpu", "-r", "3", "--serve-batch", "4",
                              "--serve-quantize", "int8",
                              "root.alexnet.loader.input_hw=67",
                              "root.alexnet.width_mult=0.125",
                              "root.alexnet.fc_width=64",
                              "root.alexnet.n_classes=16",
                              "root.alexnet.loader.n_train=8",
                              "root.alexnet.loader.n_validation=4"])
    finally:
        root.alexnet = saved
    try:
        info = srv.model_info()
        assert (info["ring_slots"], info["max_batch"], info["quantize"]) \
            == (4, 4, "int8")
        assert info["param_bytes"]["wire"] < info["param_bytes"]["f32"]
        out = np.asarray(srv.predict(
            np.zeros((4, 67, 67, 3), np.float32))["outputs"])
        assert out.shape == (4, 16) and np.isfinite(out).all()
    finally:
        srv.stop()
