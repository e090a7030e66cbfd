"""The port's serialized serving program on the CPU: `serving_aot.py`'s
signature, key and cache, the server's `aot_cache=`, the K2 / K4
operators it calls, and `export.export_program`.

The net is tests/test_torch_serve_wires.py's (27x27x3 -> conv 5x5/2 of
8 -> LRN -> 3x3/2 max pool -> FC 96 -> softmax 10; its FC weight is the
int8 wire's one coded leaf), the parameters the JAX workflow's seeded
ones. A program is exported at the ring's shape (8 rows) for each wire
and must give the eager ring's answers bit for bit, exported and loaded
alike (the same aten operators on the same tensors; K4's plain version
through its operator on the CPU). The signature is held to the JAX
function's on the same workflow, field for field, but for the framework
version ("jax" / "torch") and the port's device kind. The cache's
refusals — a stale signature, a flipped blob byte, a corrupt index —
each log ONE warning and export anew.
"""

import contextlib
import json
import os
import types

import numpy as np
import pytest
import torch

from veles_tpu import prng as jprng
from veles_tpu import serving_aot as jaot
from veles_tpu.loader.synthetic import \
    SyntheticClassifierLoader as JaxLoader
from veles_tpu.znicz.standard_workflow import \
    StandardWorkflow as JaxWorkflow
from veles_tpu_torch import prng, serving_aot
from veles_tpu_torch.convert import params_from_jax
from veles_tpu_torch.export import export_program
from veles_tpu_torch.loader.synthetic import SyntheticClassifierLoader
from veles_tpu_torch.ops import kernels, variants
from veles_tpu_torch.serving import InferenceServer
from veles_tpu_torch.serving_aot import ServingAotCache
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
WIRES = ("f32", "bf16", "int8")


def _loader_kw():
    return dict(n_classes=N_CLASSES, sample_shape=(HW, HW, 3),
                n_validation=8, n_train=16, minibatch_size=8, noise=0.5)


@pytest.fixture(scope="module")
def jwf():
    saved = jprng._base_seed
    jprng._generators.clear()
    jprng.seed_all(5)
    wf = JaxWorkflow(layers=LAYERS, loader=JaxLoader(**_loader_kw()),
                     loss="softmax", n_classes=N_CLASSES, name="AotWF")
    wf.initialize(device=None)
    yield wf
    wf._stop_units()
    jprng._base_seed = saved


@pytest.fixture(scope="module")
def jparams(jwf):
    return tuple({k: np.asarray(a.mem) for k, a in u.param_arrays().items()}
                 for u in jwf.forwards)


def _port_wf(jparams, scale=1.0):
    saved = prng._base_seed
    wf = StandardWorkflow(
        layers=LAYERS, loader=SyntheticClassifierLoader(**_loader_kw()),
        loss="softmax", n_classes=N_CLASSES, name="AotWF")
    wf.initialize("cpu")
    params_from_jax(tuple({k: v * np.float32(scale) for k, v in p.items()}
                          for p in jparams), "cpu", wf)
    prng._base_seed = saved
    return wf


@pytest.fixture
def rows():
    return np.random.RandomState(3).randn(RING, HW, HW, 3).astype(
        np.float32)


@pytest.fixture
def warnings(monkeypatch):
    """The cache's warnings, recorded (the port's loggers may not
    propagate to the root logger)."""
    seen = []
    monkeypatch.setattr(ServingAotCache, "warning",
                        lambda self, msg, *a: seen.append(msg % a))
    return seen


def _server(wf, wire, cache=None):
    return InferenceServer(wf, ring_slots=RING, quantize=wire,
                           device="cpu", aot_cache=cache)


def _ring(srv, x):
    return srv._forward_ring(torch.from_numpy(x))[0].numpy()


def test_signature_and_key_equal_the_jax_functions(jwf, jparams):
    wf = _port_wf(jparams)
    sel = {"lrn_maxpool": "fused", "serve_forward": "int8"}
    mine = serving_aot.serve_signature(wf, None, RING, "int8", True,
                                       (HW, HW, 3), variants=sel)
    theirs = jaot.serve_signature(jwf, None, RING, "int8", True,
                                  (HW, HW, 3), variants=sel)
    assert mine.pop("torch") == torch.__version__
    assert mine.pop("device_kind") == "cpu"
    assert theirs.pop("jax")
    assert mine == theirs
    assert serving_aot.model_signature(wf) == jaot.model_signature(jwf)
    assert ServingAotCache.key(mine) == jaot.ServingAotCache.key(theirs)
    assert ServingAotCache.key(mine).startswith("local|serve|")
    assert serving_aot.AOT_CACHE_ENV == jaot.AOT_CACHE_ENV


def test_default_path_follows_the_environment(monkeypatch, tmp_path):
    monkeypatch.setenv(serving_aot.AOT_CACHE_ENV, str(tmp_path / "i.json"))
    assert serving_aot.default_aot_path() == str(tmp_path / "i.json")
    monkeypatch.delenv(serving_aot.AOT_CACHE_ENV)
    assert serving_aot.default_aot_path().endswith(
        os.path.join(".cache", "veles_tpu_torch", "serving_aot.json"))


@pytest.mark.parametrize("wire", WIRES)
def test_cold_then_warm_start_serve_the_eager_ring_bits(jparams, rows, wire,
                                                        tmp_path, warnings):
    cache = str(tmp_path / "aot.json")
    eager = _server(_port_wf(jparams), wire)
    assert eager.aot_source is None and eager._program is None
    want = _ring(eager, rows)
    cold = _server(_port_wf(jparams), wire, cache)
    assert (cold.aot_source, cold.aot_compiles) == ("export", 1)
    warm = _server(_port_wf(jparams), wire, cache)
    assert (warm.aot_source, warm.aot_compiles) == ("cache", 0)
    assert warm.health()["aot"] == {"source": "cache", "compiles": 0}
    assert warm.model_info()["aot"] == {"source": "cache", "compiles": 0}
    for srv in (cold, warm):
        np.testing.assert_array_equal(_ring(srv, rows), want)
    entry = ServingAotCache(cache).entry(warm._aot_signature)
    assert entry["bytes"] == os.path.getsize(entry["file"])
    assert entry["signature"]["quantize"] == wire
    assert not warnings


def test_a_program_per_wire_under_one_index(jparams, tmp_path, warnings):
    cache = str(tmp_path / "aot.json")
    for wire in ("f32", "int8"):
        _server(_port_wf(jparams), wire, cache)
    with open(cache) as f:
        index = json.load(f)
    assert index["schema"] == "veles-serving-aot" and index["version"] == 1
    assert sorted(e["signature"]["quantize"]
                  for e in index["entries"].values()) == ["f32", "int8"]
    assert _server(_port_wf(jparams), "int8", cache).aot_source == "cache"
    assert not warnings


def _stale(cache, sig):
    with open(cache) as f:
        raw = json.load(f)
    for e in raw["entries"].values():
        e["signature"]["ring_slots"] = 999
    with open(cache, "w") as f:
        json.dump(raw, f)


def _flip(cache, sig):
    path = ServingAotCache(cache).entry(sig)["file"]
    blob = bytearray(open(path, "rb").read())
    blob[len(blob) // 2] ^= 0x01
    with open(path, "wb") as f:
        f.write(bytes(blob))


def _corrupt_index(cache, sig):
    with open(cache, "w") as f:
        f.write("{not json")


def _version_skew(cache, sig):
    with open(cache) as f:
        raw = json.load(f)
    raw["version"] = 99
    with open(cache, "w") as f:
        json.dump(raw, f)


@pytest.mark.parametrize("spoil,says", [
    (_stale, "refusing stale artifact"),
    (_flip, "sha256 mismatch"),
    (_corrupt_index, "unreadable"),
    (_version_skew, "schema/version skew"),
])
def test_a_spoiled_cache_warns_once_and_exports_anew(jparams, rows, spoil,
                                                     says, tmp_path,
                                                     warnings):
    cache = str(tmp_path / "aot.json")
    first = _server(_port_wf(jparams), "f32", cache)
    want = _ring(first, rows)
    spoil(cache, first._aot_signature)
    again = _server(_port_wf(jparams), "f32", cache)
    assert len(warnings) == 1 and says in warnings[0], warnings
    assert (again.aot_source, again.aot_compiles) == ("export", 1)
    np.testing.assert_array_equal(_ring(again, rows), want)
    # the rebuild was stored: the next start loads it, silently
    assert _server(_port_wf(jparams), "f32", cache).aot_source == "cache"
    assert len(warnings) == 1


def test_a_program_of_another_argument_structure_is_refused(jparams,
                                                            tmp_path,
                                                            warnings):
    cache = str(tmp_path / "aot.json")
    srv = _server(_port_wf(jparams), "f32", cache)
    sig = srv._aot_signature
    x = torch.zeros((RING, HW, HW, 3))
    other = serving_aot.call_trees((x, ({},)))[0]
    assert ServingAotCache(cache).load(sig, other) is None
    assert len(warnings) == 1 and "argument structure" in warnings[0]
    assert ServingAotCache(cache).load(
        sig, serving_aot.call_trees((x, srv._gens.params))[0]) is not None


@pytest.mark.parametrize("wire", ["f32", "int8"])
def test_swap_and_rollback_on_a_loaded_program(jparams, rows, wire,
                                               tmp_path):
    cache = str(tmp_path / "aot.json")
    _server(_port_wf(jparams), wire, cache)
    srv = _server(_port_wf(jparams), wire, cache)
    assert srv.aot_source == "cache"
    before = _ring(srv, rows)
    cand = _port_wf(jparams, scale=1.5)
    srv.swap_params(cand, source="test")
    want = _ring(_server(_port_wf(jparams, scale=1.5), wire), rows)
    np.testing.assert_array_equal(_ring(srv, rows), want)
    assert not np.array_equal(want, before)
    srv.rollback()
    np.testing.assert_array_equal(_ring(srv, rows), before)
    assert srv.aot_compiles == 0


@pytest.mark.parametrize("setting,op", [("fused", "lrn_maxpool_forward"),
                                        ("composed", "lrn_forward")])
def test_the_program_calls_the_kernels_through_their_operators(
        jparams, tmp_path, setting, op):
    prev = variants.selected("lrn_maxpool")
    variants.select("lrn_maxpool", setting)
    try:
        srv = _server(_port_wf(jparams), "f32", str(tmp_path / "a.json"))
    finally:
        if prev is None:
            variants.clear_selection("lrn_maxpool")
        else:
            variants.select("lrn_maxpool", prev)
    targets = [str(n.target) for n in srv._program.graph.nodes
               if n.op == "call_function"]
    assert f"veles.{op}.default" in targets
    other = {"lrn_maxpool_forward": "lrn_forward",
             "lrn_forward": "lrn_maxpool_forward"}[op]
    assert f"veles.{other}.default" not in targets


def test_operators_give_the_plain_versions_and_fake_shapes(monkeypatch):
    x = torch.randn(2, 9, 11, 8)
    np.testing.assert_array_equal(
        torch.ops.veles.lrn_forward(x, 2.0, 1e-4, 0.75, 5, 0).numpy(),
        kernels.lrn_forward_plain(x).numpy())
    np.testing.assert_array_equal(
        torch.ops.veles.lrn_maxpool_forward(
            x, 2.0, 1e-4, 0.75, 5, [3, 3], [2, 2], 0, 0).numpy(),
        kernels.lrn_maxpool_forward_plain(x).numpy())
    from torch._subclasses.fake_tensor import FakeTensorMode
    with FakeTensorMode() as mode:
        fx = mode.from_tensor(x)
        assert torch.ops.veles.lrn_maxpool_forward(
            fx, 2.0, 1e-4, 0.75, 5, [3, 3], [2, 2], 0, 0).shape \
            == (2, 4, 5, 8)
        assert torch.ops.veles.lrn_forward(
            fx.to(torch.bfloat16), 2.0, 1e-4, 0.75, 5, 0).dtype \
            == torch.bfloat16
    # the training functions: the wrappers in eager code, the operators
    # while a program is traced; the same bits either way
    calls = []
    for name in ("lrn_forward_op", "lrn_maxpool_forward_op"):
        def counted(*args, _op=getattr(kernels, name), _name=name):
            calls.append(_name)
            return _op(*args)
        monkeypatch.setattr(kernels, name, counted)
    g = torch.randn(2, 4, 5, 8)
    for traced in (False, True):
        calls.clear()
        xr = x.clone().requires_grad_(True)
        with kernels.operators_traced() if traced \
                else contextlib.nullcontext():
            y = kernels.LRNMaxPoolFunction.apply(xr, 2.0, 1e-4, 0.75, 5,
                                                 (3, 3), (2, 2))
            z = kernels.LRNFunction.apply(x, 2.0, 1e-4, 0.75, 5)
        assert calls == (["lrn_maxpool_forward_op", "lrn_forward_op"]
                         if traced else [])
        np.testing.assert_array_equal(y.detach().numpy(),
                                      kernels.lrn_maxpool_forward_plain(x))
        np.testing.assert_array_equal(z.numpy(),
                                      kernels.lrn_forward_plain(x).numpy())
        y.backward(g)
        np.testing.assert_array_equal(
            xr.grad.numpy(),
            kernels.lrn_maxpool_backward_plain(x, g).numpy())


def test_export_program_gives_the_fused_forward(jparams, tmp_path):
    wf = _port_wf(jparams)
    path = export_program(wf, str(tmp_path / "fwd.pt2"), batch=4)
    program = torch.export.load(path)
    fwd = wf.build_forward()
    params = tuple({k: t.detach() for k, t in p.items()}
                   for p in fwd.params())
    x = torch.from_numpy(np.random.RandomState(9).randn(
        4, HW, HW, 3).astype(np.float32))
    got = program.module()(x, params)
    want = fwd._forward(fwd.params(), x)
    assert got.shape == (4, N_CLASSES)
    np.testing.assert_array_equal(got.numpy(), want.numpy())
    assert any("veles.lrn_maxpool_forward" in str(n.target)
               for n in program.graph.nodes)


def test_the_cli_serves_the_program_where_the_cache_is_named(
        jparams, monkeypatch, tmp_path):
    from veles_tpu_torch import launcher
    made = []

    class Recorder:
        def __init__(self, wf, **kw):
            made.append(kw["aot_cache"])

        def start(self):
            return self

        def model_info(self):
            return {"dispatch": "ring", "ring_slots": RING, "max_batch": 8,
                    "quantize": "f32", "param_bytes": {}}

    monkeypatch.setattr("veles_tpu_torch.serving.InferenceServer", Recorder)
    wf_file = tmp_path / "wf.py"
    wf_file.write_text(
        "def run(load, main):\n"
        "    load(lambda: None)\n"
        "    main()\n")
    monkeypatch.setattr(launcher, "_run",
                        lambda args, main_fn: main_fn(types.SimpleNamespace(
                            place=lambda device: None)))
    monkeypatch.delenv(serving_aot.AOT_CACHE_ENV, raising=False)
    argv = [str(wf_file), "--serve", "0", "--device", "cpu"]
    launcher.serve(argv)
    monkeypatch.setenv(serving_aot.AOT_CACHE_ENV, str(tmp_path / "i.json"))
    launcher.serve(argv)
    assert made == [None, "auto"]
