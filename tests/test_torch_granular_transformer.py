"""The char-transformer's granular units and graph on the CPU, against the
JAX package's.

- Each unit pair — SeqLinear with `pos`, the causal residual attention
  (`use_flash="on"` in both packages: the port's kernel wrapper takes its
  plain version on the CPU, the JAX Pallas kernel is interpreted), SeqFFN
  and the SeqSoftmax head (probabilities flattened to (N·S, V), the
  error reshaped back) — starts from the JAX unit's parameters and
  takes two forward / vjp / update rounds with momentum and weight
  decay, on the torch backend against `XLADevice` and on the numpy
  backend against `NumpyDevice`. `learning_rate_bias` is 3 and must NOT
  reach the update: the JAX VJP twin's SGDConfig keeps its default bias
  multiplier, 2, on every 1-D leaf. Outputs, err_input, every parameter
  and every velocity (the JAX twin's `vel_<leaf>`) agree to rtol 1e-4,
  atol 1e-6, the attention to rtol 2e-4, atol 2e-5 (the JAX package's
  flash-vs-golden tolerance). The numpy backend has no numpy golden for
  these backwards: JAX runs `jax.vjp` on the host, the port torch
  autograd on CPU tensors over the einsum path, so the two are held to
  these tolerances, not to bits.
- The toy char-transformer (embed 16, 2 heads of 8, ffn 24, seq_len 32,
  the sample's minibatch 32) trains 2 granular epochs in both packages
  from one seed on each backend: the Decision's history (per-token error
  counts) equal, the loss within rtol 1e-5, parameters and velocities
  within rtol 1e-4, atol 1e-6 (74 updates); the validation error is
  below 0.7 of chance, as tests/test_transformer_sp.py:38 asks of the
  JAX graph.
- `-b numpy` through the command line trains the toy transformer; the
  loader's text is the JAX package's, character for character.
- A JAX granular run carried into the port (`convert.granular_from_jax`,
  whose VJP twins keep `vel_weights` and `vel_bias`) holds the JAX
  velocities under the port's names, and the port's fused step starts
  from them: one fused step against the JAX fused step from the JAX
  granular state, rtol 1e-4, atol 1e-7 per leaf. The port's own fused
  run after its granular one starts from the granular velocities.
- On the torch backend the firings call the kernel wrappers as the unit
  graph predicts: the flash forward once per attention forward firing
  and once more in each update's vjp, the flash backward once per
  update, the SGD update once per leaf per update.
"""

import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import veles_tpu.workflow as jworkflow
from veles_tpu import prng as jprng
from veles_tpu.backends import NumpyDevice as JNumpyDevice
from veles_tpu.backends import XLADevice
from veles_tpu.config import root as jroot
from veles_tpu.samples import char_transformer as jct
from veles_tpu.znicz import attention as jattention
from veles_tpu.znicz import transformer as jtransformer
from veles_tpu.znicz.nn_units import gd_for as jgd_for
from veles_tpu_torch import convert, prng
from veles_tpu_torch import workflow as pworkflow
from veles_tpu_torch.backends import NumpyDevice, TorchDevice
from veles_tpu_torch.config import root
from veles_tpu_torch.ops import kernels
from veles_tpu_torch.samples import char_transformer as ct
from veles_tpu_torch.znicz import attention, transformer
from veles_tpu_torch.znicz.nn_units import GradientDescentVJP, gd_for, \
    unit_for

REPO = Path(__file__).resolve().parent.parent
RTOL, ATOL = 1e-4, 1e-6
FLASH_RTOL, FLASH_ATOL = 2e-4, 2e-5
LOSS_RTOL = 1e-5
GD_KW = dict(learning_rate=0.05, gradient_moment=0.9, weights_decay=5e-4,
             learning_rate_bias=3.0)
TOY = {"embed": 16, "n_heads": 2, "ffn": 24}
BACKENDS = {"torch": (XLADevice, lambda: TorchDevice("cpu")),
            "numpy": (JNumpyDevice, NumpyDevice)}


@pytest.fixture(autouse=True)
def _restore():
    saved = (jprng._base_seed, prng._base_seed,
             jroot.char_transformer.to_dict(),
             root.char_transformer.to_dict())
    yield
    (jprng._base_seed, prng._base_seed, jroot.char_transformer,
     root.char_transformer) = saved


def _close(want, got, what, rtol, atol):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want),
                               rtol=rtol, atol=atol, err_msg=what)


class VJPPair:
    """One layer as the JAX forward + VJP twin and as the port's layer,
    node and gradient unit on `backend`; the port starts from the JAX
    parameters."""

    def __init__(self, backend, jcls, pcls, x, rtol=RTOL, atol=ATOL, **kw):
        jdev, pdev = BACKENDS[backend]
        self.jdev, self.pdev = jdev(), pdev()
        self.rtol, self.atol = rtol, atol
        jprng.seed_all(3)
        self.jwf = jworkflow.Workflow(name="j")
        self.jf = jcls(self.jwf, **kw)
        self.jf.input.reset(x)
        self.jf.initialize(device=self.jdev)
        self.pwf = pworkflow.Workflow(name="p")
        layer = pcls(**kw)
        self.pf = unit_for(pcls)(self.pwf, layer=layer)
        self.pf.input.reset(x)
        self.pf.input_sample_shape = x.shape[1:]
        self.pf.initialize(device=self.pdev)
        with torch.no_grad():
            for k, t in layer.param_arrays().items():
                t.copy_(torch.from_numpy(np.array(getattr(self.jf, k).mem)))
        self.jg = jgd_for(jcls)(self.jwf, **GD_KW)
        self.jg.link_forward(self.jf)
        self.pg = gd_for(pcls)(self.pwf, **GD_KW)
        self.pg.link_forward(self.pf)
        assert isinstance(self.pg, GradientDescentVJP)

    def close(self, want, got, what):
        _close(want, got, what, self.rtol, self.atol)

    def forward(self):
        self.jf.run()
        self.pf.run()
        self.close(self.jf.output.mem, self.pf.output.mem, "output")

    def backward(self, err):
        for g, dev in ((self.jg, self.jdev), (self.pg, self.pdev)):
            g.err_output.reset(err)
            if not g.is_initialized:
                assert g.initialize(device=dev) is not False
            g.run()
        self.close(self.jg.err_input.mem, self.pg.err_input.mem,
                   "err_input")
        for k in self.pg._pnames:
            self.close(getattr(self.jg, k).mem, getattr(self.pg, k).mem, k)
            self.close(getattr(self.jg, f"vel_{k}").mem,
                       self.pg.velocity(k).detach().numpy(), f"vel {k}")

    def rounds(self, n=2, seed=11):
        rng = np.random.RandomState(seed)
        for _ in range(n):
            self.forward()
            self.backward(rng.randn(*self.jf.output.shape)
                          .astype(np.float32) * 0.1)


def _x(shape, seed=5):
    return np.random.RandomState(seed).randn(*shape).astype(np.float32)


@pytest.mark.parametrize("backend", sorted(BACKENDS))
def test_seq_linear_with_positions(backend):
    VJPPair(backend, jtransformer.SeqLinear, transformer.SeqLinear,
            _x((2, 32, 8)), output_features=12, pos_embed=True,
            weights_stddev=0.1).rounds()


@pytest.mark.parametrize("backend", sorted(BACKENDS))
def test_causal_residual_attention(backend):
    p = VJPPair(backend, jattention.MultiHeadAttention,
                attention.MultiHeadAttention, _x((2, 32, 16)),
                rtol=FLASH_RTOL, atol=FLASH_ATOL, n_heads=2, causal=True,
                residual=True, use_flash="on", weights_stddev=0.1)
    assert p.pf.layer._flash_ok(32)
    p.rounds()


@pytest.mark.parametrize("backend", sorted(BACKENDS))
def test_seq_ffn(backend):
    VJPPair(backend, jtransformer.SeqFFN, transformer.SeqFFN,
            _x((2, 32, 16)), hidden=24, activation="tanh",
            weights_stddev=0.1).rounds()


@pytest.mark.parametrize("backend", sorted(BACKENDS))
def test_seq_softmax_head_flattens_and_reshapes(backend):
    p = VJPPair(backend, jtransformer.SeqSoftmax, transformer.SeqSoftmax,
                _x((2, 32, 16)), output_features=10, weights_stddev=0.1)
    p.forward()
    assert p.pf.output.shape == (64, 10)
    np.testing.assert_allclose(p.pf.output.mem.sum(axis=1), 1.0, rtol=1e-6)
    p.backward(_x((64, 10), seed=7) * 0.1)
    p.rounds(1)


def test_the_bias_multiplier_is_the_jax_twins_default():
    g = transformer.GDSeqLinear(None, learning_rate=0.1,
                                learning_rate_bias=3.0)
    cfg = g.sgd_config()
    assert cfg.lr_bias_mult == 2.0 and cfg.lr == 0.1


def test_synthetic_text_keeps_the_jax_text():
    """The port's text generator keeps a running length (the JAX
    package's re-sums its word list at every draw): the same text at the
    sample's default length."""
    from veles_tpu.loader.text import synthetic_text as jsynthetic_text
    from veles_tpu_torch.loader.text import synthetic_text
    assert synthetic_text() == jsynthetic_text()


# -- the toy char-transformer's granular run ----------------------------------

def _toy(pkg_root, pkg_prng, create, epochs=2):
    pkg_prng.seed_all(4321)
    cfg = pkg_root.char_transformer
    for k, v in TOY.items():
        setattr(cfg, k, v)
    cfg.loader.seq_len = 32
    cfg.decision.max_epochs = epochs
    return create()


def _assert_same_run(jwf, pwf):
    assert pwf.decision.history == jwf.decision.history
    np.testing.assert_allclose(pwf.evaluator.loss, jwf.evaluator.loss,
                               rtol=LOSS_RTOL)
    n = len(pwf.forwards)
    for i, (ju, pu) in enumerate(zip(jwf.forwards, pwf.forwards)):
        jg, pg = jwf.gds[n - 1 - i], pwf.gds[n - 1 - i]
        for k, t in pu.param_arrays().items():
            _close(getattr(ju, k).mem, t.detach().numpy(), f"unit {i} {k}",
                   RTOL, ATOL)
            _close(getattr(jg, f"vel_{k}").mem, pg.velocity(k).numpy(),
                   f"unit {i} velocity {k}", RTOL, ATOL)


@pytest.mark.parametrize("backend", sorted(BACKENDS))
def test_toy_transformer_granular_run_tracks_the_jax_run(backend):
    jdev, pdev = BACKENDS[backend]
    jwf = _toy(jroot, jprng, jct.create_workflow)
    jwf.initialize(device=jdev())
    jwf.run()
    pwf = _toy(root, prng, ct.create_workflow)
    pwf.initialize(device=pdev())
    pwf.run()
    _assert_same_run(jwf, pwf)
    assert [g.run_count for g in pwf.gds] == [g.run_count for g in jwf.gds]
    # the JAX graph test's bar (tests/test_transformer_sp.py:38)
    mb = pwf.loader.minibatch_size
    n_tokens = -(-40 // mb) * mb * pwf.loader.seq_len
    chance = n_tokens * (1 - 1.0 / pwf.loader.n_vocab)
    assert pwf.decision.best_validation_err < 0.7 * chance


def test_torch_backend_calls_the_wrappers_as_the_firings_predict(
        monkeypatch):
    """At S = 32 with use_flash forced on: the flash forward per attention
    forward firing plus one per vjp, the flash backward per update, the
    SGD update per leaf per update. On the CPU each wrapper takes its
    plain version, which these counts read (on the card the wrappers'
    launch counts, chip_smoke.py's GRANULAR transformer phase)."""
    calls = {}
    for name in ("flash_attention_forward_plain",
                 "flash_attention_backward_plain", "sgd_update_plain"):
        inner = getattr(kernels, name)

        def spy(*a, _inner=inner, _name=name, **kw):
            calls[_name] = calls.get(_name, 0) + 1
            return _inner(*a, **kw)
        monkeypatch.setattr(kernels, name, spy)
    pwf = _toy(root, prng, ct.create_workflow, epochs=1)
    att = next(u for u in pwf.forwards
               if isinstance(u, attention.MultiHeadAttention))
    att.use_flash = "on"
    pwf.initialize(device="cpu")
    pwf.run()
    fwd = next(u for u in pwf.fwd_units if u.layer is att)
    gd = next(g for g in pwf.gds
              if isinstance(g, attention.GDMultiHeadAttention))
    assert gd.run_count > 0
    assert calls == {
        "flash_attention_forward_plain": fwd.run_count + gd.run_count,
        "flash_attention_backward_plain": gd.run_count,
        "sgd_update_plain": sum(len(g._pnames) * g.run_count
                                for g in pwf.gds)}
    assert sum(len(g._pnames) for g in pwf.gds) == 13


def test_cli_trains_the_toy_transformer_on_the_numpy_backend():
    cmd = [sys.executable, "-m", "veles_tpu_torch",
           "veles_tpu_torch/samples/char_transformer.py", "-b", "numpy",
           "--device", "cpu", "-r", "1",
           *(f"root.char_transformer.{k}={v}" for k, v in TOY.items()),
           "root.char_transformer.loader.seq_len=32",
           "root.char_transformer.decision.max_epochs=1"]
    env = dict(os.environ, PYTHONPATH=str(REPO))
    r = subprocess.run(cmd, cwd=REPO, env=env, capture_output=True,
                       text=True, timeout=300)
    assert r.returncode == 0, r.stderr[-2000:]
    line = r.stdout.strip().splitlines()[-1]
    assert line.startswith("TRAINED 1 epochs: loss "), line
    assert "'epoch': 1" in line and "'valid_err'" in line


# -- velocities across packages and modes -------------------------------------

def test_jax_granular_state_continues_in_the_port_fused_step():
    from veles_tpu.ops import variants as jvariants
    jwf = _toy(jroot, jprng, jct.create_workflow, epochs=1)
    jwf.initialize(device=XLADevice())
    jwf.run()
    pwf = _toy(root, prng, ct.create_workflow, epochs=1)
    pwf.initialize(device="cpu")
    convert.granular_from_jax(jwf, pwf)
    n = len(pwf.forwards)
    for i in range(n):
        jg, pg = jwf.gds[n - 1 - i], pwf.gds[n - 1 - i]
        for k in pg._pnames:
            np.testing.assert_array_equal(
                pg.velocity(k).numpy(), np.asarray(getattr(jg, f"vel_{k}")
                                                   .mem))
            assert np.abs(pg.velocity(k).numpy()).max() > 0, (i, k)
    loader = pwf.loader
    x = loader.data[loader._indices_per_class[2][:32]]
    y = loader.labels[loader._indices_per_class[2][:32]].reshape(-1)
    with jvariants.pallas_interpret():
        jstep = jwf.build_fused_step()
        jstate, (jloss, _) = jstep.train(jstep.init_state(), x, y)
    pstep = pwf.build_fused_step()
    pstate = pstep.init_state()
    for g, v in zip(pstep.gd_units, pstate["vel"]):
        for k, t in v.items():
            assert torch.equal(t, g.velocity(k))
    pstate, (ploss, _) = pstep.train(pstate, x, y)
    np.testing.assert_allclose(float(ploss), float(jloss), rtol=LOSS_RTOL)
    for i, (jp, pp, jv, pv) in enumerate(zip(
            jstate["params"], pstate["params"], jstate["vel"],
            pstate["vel"])):
        for k in pp:
            _close(jp[k], pp[k].detach().numpy(), f"unit {i} {k}", RTOL,
                   1e-7)
            _close(jv[k], pv[k].numpy(), f"unit {i} velocity {k}", RTOL,
                   1e-7)


def test_a_fused_run_continues_from_the_granular_velocities():
    pwf = _toy(root, prng, ct.create_workflow, epochs=1)
    pwf.initialize(device="cpu")
    pwf.run()
    granular = [{k: g.velocity(k).clone() for k in g._pnames}
                for g in pwf.gds]
    step = pwf.build_fused_step()
    state = step.init_state()
    by_unit = {id(g): v for g, v in zip(step.gd_units, state["vel"])}
    for g, want in zip(pwf.gds, granular):
        for k, t in want.items():
            assert torch.equal(by_unit[id(g)][k], t)
            assert t.abs().max() > 0
    pwf.decision.complete = False
    pwf.run_fused(epochs=2, device="cpu")
    assert pwf.decision.epoch_number == 2
    assert len(pwf.decision.history) == 2
