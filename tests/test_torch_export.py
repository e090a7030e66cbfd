"""The port's native export and engine on the CPU, held against the JAX
package's (`veles_tpu/export.py`, `veles_tpu/native_engine.py`).

Four models of tests/test_native_engine.py — the FC stack, the conv /
pool / LRN stack, the reduced AlexNet (input 67, width 1/8, fc 32, 8
classes; dropout exported as identity) and the char-transformer stack
(embed 16, 2 heads, ffn 24, seq_len 12) — are built in both packages
from one seed, the JAX parameters carried into the port by
`convert.params_from_jax`, and exported by both exporters:

- the port's `topology.json` and `weights.bin` equal the JAX files byte
  for byte;
- the port's `NativeEngine` gives the JAX `NativeEngine`'s bits on the
  same package (each engine built from its own copy of the source);
- the engine lies within rtol 3e-4, atol 3e-5 of the port's forward (the
  JAX test's tolerance: the engine sums its products in another order);
- a corrupt manifest is refused, and so is a unit with no exporter.
"""

import contextlib
import json
import os
import shutil
import subprocess
from pathlib import Path

import numpy as np
import pytest
import torch

import veles_tpu.native_engine as jnative
from veles_tpu import prng as jprng
from veles_tpu.backends import NumpyDevice
from veles_tpu.config import root as jroot
from veles_tpu.export import export_workflow as jexport
from veles_tpu.loader.synthetic import \
    SyntheticClassifierLoader as JSynthetic
from veles_tpu.samples import alexnet as jalexnet
from veles_tpu.samples import char_transformer as jct
from veles_tpu.znicz.standard_workflow import \
    StandardWorkflow as JStandardWorkflow
from veles_tpu_torch import convert, prng
from veles_tpu_torch.config import root
from veles_tpu_torch.export import export_workflow
from veles_tpu_torch.loader.synthetic import SyntheticClassifierLoader
from veles_tpu_torch.native_engine import NativeEngine
from veles_tpu_torch.samples import alexnet
from veles_tpu_torch.samples import char_transformer as ct
from veles_tpu_torch.znicz.standard_workflow import StandardWorkflow

pytestmark = pytest.mark.skipif(shutil.which("g++") is None,
                                reason="no C++ toolchain")

REPO = Path(__file__).resolve().parent.parent
RTOL, ATOL = 3e-4, 3e-5
SEED = 1234

FC = [{"type": "all2all_tanh", "output_sample_shape": 16,
       "weights_stddev": 0.05},
      {"type": "softmax", "output_sample_shape": 5, "weights_stddev": 0.05}]
CONV = [{"type": "conv_strictrelu", "n_kernels": 6, "kx": 3, "ky": 3,
         "padding": (1, 1), "weights_stddev": 0.05},
        {"type": "max_pooling", "ksize": (2, 2)},
        {"type": "lrn"},
        {"type": "conv_tanh", "n_kernels": 4, "kx": 3, "ky": 3,
         "stride": (2, 2), "weights_stddev": 0.05},
        {"type": "avg_pooling", "ksize": (2, 2)},
        {"type": "all2all_relu", "output_sample_shape": 12,
         "weights_stddev": 0.05},
        {"type": "softmax", "output_sample_shape": 5,
         "weights_stddev": 0.05}]
CT = {"loader.minibatch_size": 8, "loader.seq_len": 12, "embed": 16,
      "n_heads": 2, "ffn": 24, "moe_experts": 0, "parallel_mode": "local"}
ALEXNET = dict(minibatch_size=8, input_hw=67, width_mult=0.125, fc_width=32,
               n_train=32, n_validation=16, n_classes=8, init="scaled")


@pytest.fixture(autouse=True)
def _restore_base_seeds():
    saved = jprng._base_seed, prng._base_seed
    yield
    jprng._base_seed, prng._base_seed = saved


@contextlib.contextmanager
def _config(node, overrides):
    """Config overrides for a block, restored after it (the config trees
    are process-global)."""
    saved = node.to_dict()
    for dotted, value in overrides.items():
        node.override(dotted, value)
    try:
        yield
    finally:
        node.update(saved)


def _seeded(seed):
    jprng._generators.clear()
    jprng.seed_all(seed)
    prng._generators.clear()
    prng.seed_all(seed)


def _stack(layers, sample_shape):
    """The layer list in both packages, over the JAX test's loader."""
    _seeded(SEED)
    kw = dict(n_classes=5, sample_shape=sample_shape, n_validation=50,
              n_train=100, minibatch_size=25, noise=0.5)
    wf_kw = dict(layers=layers, loss="softmax", n_classes=5,
                 decision_config={"max_epochs": 1, "fail_iterations": 50},
                 gd_config={"learning_rate": 0.1}, name="NativeTest")
    jwf = JStandardWorkflow(loader=JSynthetic(**kw), **wf_kw)
    jwf.initialize(device=NumpyDevice())
    pwf = StandardWorkflow(loader=SyntheticClassifierLoader(**kw), **wf_kw)
    pwf.initialize("cpu")
    return jwf, pwf


def _alexnet():
    _seeded(SEED)
    jwf = jalexnet.create_workflow(**ALEXNET)
    jwf.initialize(device=NumpyDevice())
    pwf = alexnet.create_workflow(**ALEXNET)
    pwf.initialize("cpu")
    return jwf, pwf


def _transformer():
    _seeded(SEED)
    with _config(jroot.char_transformer, CT):
        jwf = jct.create_workflow()
    with _config(root.char_transformer, CT):
        pwf = ct.create_workflow()
    jwf.initialize(device=NumpyDevice())
    pwf.initialize("cpu")
    return jwf, pwf


MODELS = {"fc": lambda: _stack(FC, (6, 6)),
          "conv": lambda: _stack(CONV, (12, 12, 3)),
          "alexnet": _alexnet,
          "transformer": _transformer}


def _inputs(name, pwf):
    rs = np.random.RandomState(5)
    if name == "transformer":
        return np.asarray(pwf.loader.data[:4], np.float32)
    return rs.randn(4, *pwf.loader.sample_shape).astype(np.float32)


def _port_forward(pwf, x):
    """The port's forward of the workflow's params, softmax per row (per
    position for the transformer's head), flattened per sample."""
    fwd = pwf.build_forward()
    with torch.no_grad():
        z = fwd._forward(fwd.params(), torch.from_numpy(x))
        return torch.softmax(z, dim=-1).reshape(len(x), -1).numpy()


@pytest.fixture(scope="module")
def jax_engine(tmp_path_factory):
    """The JAX package's NativeEngine over a library built here from the
    JAX package's own source (its Makefile's build directory is shared
    with other tests, which may build it at the same time)."""
    lib = tmp_path_factory.mktemp("jax_engine") / "libznicz.so"
    subprocess.run(["g++", "-O2", "-std=c++17", "-fPIC", "-shared", "-o",
                    str(lib), str(REPO / "native" / "znicz_engine.cpp")],
                   check=True, capture_output=True)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jnative, "_LIB_PATH", str(lib))
        mp.setattr(jnative, "_lib", None)
        yield jnative.NativeEngine


@pytest.fixture(scope="module")
def packages(tmp_path_factory):
    """Per model: the port workflow, the JAX package and the port's."""
    out = {}
    for name, build in MODELS.items():
        jwf, pwf = build()
        jparams = tuple({k: np.asarray(a.mem)
                         for k, a in u.param_arrays().items()}
                        for u in jwf.forwards)
        convert.params_from_jax(jparams, "cpu", workflow=pwf)
        d = tmp_path_factory.mktemp(name)
        out[name] = (pwf, jexport(jwf, str(d / "jax")),
                     export_workflow(pwf, str(d / "port")))
    return out


@pytest.mark.parametrize("name", sorted(MODELS))
def test_export_equals_the_jax_export_byte_for_byte(name, packages):
    _, jpkg, ppkg = packages[name]
    for f in ("topology.json", "weights.bin"):
        with open(os.path.join(jpkg, f), "rb") as a, \
                open(os.path.join(ppkg, f), "rb") as b:
            assert a.read() == b.read(), f
    topo = json.load(open(os.path.join(ppkg, "topology.json")))
    assert topo["format"] == "veles_tpu-package-v1"


@pytest.mark.parametrize("name", sorted(MODELS))
def test_engine_gives_the_jax_engines_bits(name, packages, jax_engine):
    pwf, _, ppkg = packages[name]
    x = _inputs(name, pwf)
    with NativeEngine(ppkg) as eng, jax_engine(ppkg) as jeng:
        assert eng.input_size == jeng.input_size == x[0].size
        got, want = eng.infer(x), jeng.infer(x)
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("name", sorted(MODELS))
def test_engine_matches_the_port_forward(name, packages):
    pwf, _, ppkg = packages[name]
    x = _inputs(name, pwf)
    want = _port_forward(pwf, x)
    with NativeEngine(ppkg) as eng:
        got = eng.infer(x)
        assert eng.output_size == want.shape[1]
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)
    # softmax rows (per position) sum to 1
    rows = got.reshape(-1, pwf.n_classes if name != "transformer"
                       else pwf.loader.n_vocab)
    np.testing.assert_allclose(rows.sum(1), 1.0, rtol=1e-5)


def test_export_reads_the_given_params(packages, tmp_path):
    """`params=` exports a served generation's weights instead of the
    workflow's: a perturbed tree gives other blobs of the same layout."""
    pwf, _, ppkg = packages["fc"]
    scaled = tuple({k: v * 2 for k, v in layer.items()}
                   for layer in pwf.params_host())
    pkg = export_workflow(pwf, str(tmp_path / "scaled"), params=scaled)
    a = np.fromfile(os.path.join(ppkg, "weights.bin"), "<f4")
    b = np.fromfile(os.path.join(pkg, "weights.bin"), "<f4")
    np.testing.assert_array_equal(b, a * 2)
    assert open(os.path.join(pkg, "topology.json")).read() \
        == open(os.path.join(ppkg, "topology.json")).read()


def test_corrupt_manifest_rejected(packages, tmp_path):
    """A tampered package (negative offset, an offset past the weights,
    an oversized shape) fails with a clean error, not an out-of-bounds
    read."""
    _, _, ppkg = packages["fc"]
    pkg = tmp_path / "pkg"
    shutil.copytree(ppkg, pkg)
    topo_path = pkg / "topology.json"
    topo_orig = json.loads(topo_path.read_text())

    def corrupt(mutate):
        topo = json.loads(json.dumps(topo_orig))
        mutate(topo)
        topo_path.write_text(json.dumps(topo))
        with pytest.raises(RuntimeError):
            NativeEngine(str(pkg))

    corrupt(lambda t: t["layers"][0]["arrays"][0].__setitem__("offset", -8))
    corrupt(lambda t: t["layers"][0]["arrays"][0].__setitem__(
        "offset", 10 ** 12))
    corrupt(lambda t: t["layers"][0]["arrays"][0].__setitem__(
        "shape", [2 ** 31, 2 ** 31]))
    corrupt(lambda t: t.__setitem__("format", "other"))


def test_unit_without_an_exporter_is_refused(tmp_path):
    _, pwf = _stack([{"type": "stochastic_pooling", "ksize": (2, 2)},
                     {"type": "softmax", "output_sample_shape": 5,
                      "weights_stddev": 0.05}], (6, 6, 2))
    with pytest.raises(ValueError, match="StochasticPooling"):
        export_workflow(pwf, str(tmp_path / "pkg"))
    assert not (tmp_path / "pkg").exists()
