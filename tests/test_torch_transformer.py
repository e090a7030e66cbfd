"""The attention slice as a whole on the CPU: the char-transformer in the
port and in the JAX package, from one seed.

- The loader: the same vocabulary, windows and minibatch sequence.
- The units: bit-identical parameter fills; each unit's forward against
  the JAX unit's `_apply` on the same parameters (the attention with its
  flash gate forced on, the JAX kernel interpreted, and forced off); the
  flash gate of both packages agreeing at S = 32, 4096 and 4160; at
  S = 4096 every head width takes the kernel (none goes to `mha`), and
  2 heads of 32 match the JAX unit there.
- The fused step: 3 steps of the toy transformer (embed 16, 2 heads of
  8, ffn 24, seq_len 256, minibatch 4, `use_flash="on"` on both sides,
  the JAX Pallas kernels in interpret mode) against the JAX
  `FusedTrainStep`, started from `convert.state_from_jax`, one minibatch
  with pad-mask rows; then `evaluate` of a padded validation batch.
- `run_fused` for two epochs at the sample's own widths and seq_len 32
  (the einsum path in both packages): an equal Decision history, loss,
  parameters and velocities.
- The CLI trains the toy settings; the sequence-parallel modes are
  refused, with the MoE FFN too (tests/test_torch_moe.py trains it).

Tolerances: loss rtol 1e-5; params and velocities rtol 1e-4, atol 1e-7
per leaf; n_err equal; unit forwards rtol 2e-4, atol 2e-5 (the JAX
package's flash-vs-golden tolerance; without the kernel both sides run
the same f32 products, which agree far closer). XLA and PyTorch sum
their matrix products in other orders, and the blocked attention sums
its softmax in another order than the einsum.
"""

import contextlib
import os
import subprocess
import sys
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from veles_tpu import prng as jprng
from veles_tpu.config import root as jroot
from veles_tpu.loader import text as jtext
from veles_tpu.ops import variants as jvariants
from veles_tpu.parallel import fused as jfused
from veles_tpu.samples import char_transformer as jct
from veles_tpu_torch import convert, prng
from veles_tpu_torch.config import root
from veles_tpu_torch.loader import text
from veles_tpu_torch.ops import kernels, variants
from veles_tpu_torch.samples import char_transformer as ct
from veles_tpu_torch.znicz.attention import MultiHeadAttention
from veles_tpu_torch.znicz.standard_workflow import StandardWorkflow

REPO = Path(__file__).resolve().parent.parent
TOY = {"embed": 16, "n_heads": 2, "ffn": 24, "loader.seq_len": 256,
       "loader.minibatch_size": 4, "loader.n_validation": 4}
SEED = 13
LOSS_RTOL = 1e-5
RTOL, ATOL = 1e-4, 1e-7
FWD_RTOL, FWD_ATOL = 2e-4, 2e-5


@pytest.fixture(autouse=True, scope="module")
def _own_autotune_cache(tmp_path_factory):
    """A plain `--fused` run applies the autotune cache's winners: this
    module's runs read a cache of their own, not one under HOME."""
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("VELES_AUTOTUNE_CACHE",
                  str(tmp_path_factory.mktemp("autotune") / "autotune.json"))
        yield


@pytest.fixture(autouse=True)
def _restore_base_seeds():
    saved = jprng._base_seed, prng._base_seed
    yield
    jprng._base_seed, prng._base_seed = saved


@contextlib.contextmanager
def _config(node, overrides):
    """`root.char_transformer` overrides for a block, restored after it
    (the config trees are process-global)."""
    saved = node.to_dict()
    for dotted, value in overrides.items():
        node.override(dotted, value)
    try:
        yield
    finally:
        node.update(saved)


def _workflows(overrides=None, use_flash=None, text_=None):
    overrides = overrides or {}
    jprng._generators.clear()
    jprng.seed_all(SEED)
    with _config(jroot.char_transformer, overrides):
        jwf = jct.create_workflow(text_)
    prng._generators.clear()
    prng.seed_all(SEED)
    with _config(root.char_transformer, overrides):
        pwf = ct.create_workflow(text_)
    if use_flash is not None:
        jwf.forwards[1].use_flash = use_flash
        pwf.forwards[1].use_flash = use_flash
    jwf.initialize(device=None)
    pwf.initialize("cpu")
    return jwf, pwf


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


def test_synthetic_text_and_loader_minibatches_equal_jax():
    assert text.synthetic_text(5000, 3) == jtext.synthetic_text(5000, 3)
    jwf, pwf = _workflows()
    jl, pl = jwf.loader, pwf.loader
    assert pl.vocab == jl.vocab and pl.n_vocab == jl.n_vocab == 18
    assert pl.class_lengths == list(jl.class_lengths) == [0, 40, 584]
    np.testing.assert_array_equal(pl.data, np.asarray(jl.data.mem))
    np.testing.assert_array_equal(pl.labels, np.asarray(jl.labels.mem))
    for _ in range(4):      # both validation batches, then into train
        jl.run()
        pl.run()
        for name in ("minibatch_data", "minibatch_labels",
                     "minibatch_indices", "minibatch_valid"):
            np.testing.assert_array_equal(
                np.asarray(getattr(jl, name).mem), getattr(pl, name),
                err_msg=name)
        assert int(jl.minibatch_class) == pl.minibatch_class
        assert pl.minibatch_labels.shape == (32 * 32,)
    jwf._stop_units()


def test_parameter_fills_are_bit_identical_and_carry_across():
    jwf, pwf = _workflows(TOY)
    names = [sorted(u.param_arrays()) for u in pwf.forwards]
    assert names == [["bias", "pos", "weights"], ["wk", "wo", "wq", "wv"],
                     ["b2", "bias", "w2", "weights"], ["bias", "weights"]]
    assert sum(len(n) for n in names) == 13
    jparams = tuple({k: np.asarray(a.mem) for k, a in u.param_arrays().items()}
                    for u in jwf.forwards)
    for a, b in zip(jparams, pwf.params_host()):
        assert sorted(a) == sorted(b)
        for k in a:
            np.testing.assert_array_equal(a[k], b[k], err_msg=k)
    prng._generators.clear()
    prng.seed_all(SEED + 1)
    with _config(root.char_transformer, TOY):
        other = ct.create_workflow()
    other.initialize("cpu")
    assert not np.array_equal(other.params_host()[1]["wq"], jparams[1]["wq"])
    convert.params_from_jax(jparams, "cpu", other)
    for a, b in zip(jparams, other.params_host()):
        for k in a:
            np.testing.assert_array_equal(a[k], b[k])
    jwf._stop_units()


@pytest.mark.parametrize("use_flash", ["on", "off"])
def test_unit_forwards_match_the_jax_units(use_flash):
    jwf, pwf = _workflows(TOY, use_flash=use_flash)
    n, s = 2, 256
    x = np.eye(18, dtype=np.float32)[
        np.random.RandomState(1).randint(0, 18, (n, s))]
    with jvariants.pallas_interpret():
        for i, (ju, pu) in enumerate(zip(jwf.forwards, pwf.forwards)):
            jp = {k: jnp.asarray(a.mem) for k, a in ju.param_arrays().items()}
            want = np.asarray(ju._apply(jp, x))
            got = pu.fused_apply(pu.param_arrays(), torch.tensor(x))
            np.testing.assert_allclose(got.detach().numpy(), want,
                                       rtol=FWD_RTOL, atol=FWD_ATOL,
                                       err_msg=type(pu).__name__)
            x = want
    assert pwf.forwards[1].variant_effective() == \
        {"on": "kernel", "off": "mha"}[use_flash]
    jwf._stop_units()


@pytest.mark.parametrize("s", [32, 4096, 4160])
@pytest.mark.parametrize("use_flash", ["auto", "on", "off"])
def test_flash_gate_agrees_with_the_jax_unit(s, use_flash):
    from veles_tpu.znicz.attention import MultiHeadAttention as JMHA
    ju = JMHA(None, n_heads=4, use_flash=use_flash)
    pu = MultiHeadAttention(n_heads=4, use_flash=use_flash)
    with jvariants.pallas_interpret():
        assert pu._flash_ok(s) == ju._flash_ok(s)
    assert pu._flash_ok(s) == (use_flash == "on" or (
        use_flash == "auto" and s == 4096))


@pytest.mark.parametrize("use_flash", ["auto", "on"])
@pytest.mark.parametrize("n_heads", [1, 2, 4])
def test_flash_gate_sends_head_widths_the_kernels_lack_to_mha(n_heads,
                                                              use_flash):
    """No head width goes to `mha` for want of a kernel: at S = 4096 the
    gate takes the kernel at 4 heads of 16, 2 of 32 and 1 of 64 alike,
    under "auto" and "on". K6/K7 are compiled for 16, 32 and 64; on the
    card their wrappers refuse any other width (no fallback). The gate
    reads the shape only, so the CPU sees the card's routing."""
    unit = MultiHeadAttention(n_heads=n_heads, use_flash=use_flash)
    unit.initialize((4096, 64), "cpu")
    assert unit._flash_ok(4096)
    assert unit.head_dim in kernels.FLASH_HEAD_DIMS
    assert unit.variant_effective() == "kernel"


def test_attention_at_a_head_width_the_kernels_lack_matches_the_jax_unit(
        monkeypatch):
    """2 heads of 32 at S = 4096 under "auto" (the width the kernels
    lacked before K6/K7 were compiled for it): the port's unit calls the
    flash kernel's wrapper (its plain version on the CPU) and matches the
    JAX unit, which runs its einsum off the TPU."""
    jwf, pwf = _workflows({"n_heads": 2, "loader.seq_len": 4096,
                           "loader.n_validation": 1})
    ju, pu = jwf.forwards[1], pwf.forwards[1]
    assert pu.head_dim == 32 and pu.variant_effective() == "kernel"
    widths = []
    inner = kernels.flash_attention_forward

    def traced(q, *args, **kwargs):
        widths.append(q.shape[-1])
        return inner(q, *args, **kwargs)
    monkeypatch.setattr(kernels, "flash_attention_forward", traced)
    x = np.random.RandomState(2).randn(1, 4096, 64).astype(np.float32)
    jp = {k: jnp.asarray(a.mem) for k, a in ju.param_arrays().items()}
    want = np.asarray(ju._apply(jp, x))
    got = pu.fused_apply(pu.param_arrays(), torch.tensor(x))
    assert widths == [32]
    np.testing.assert_allclose(got.detach().numpy(), want, rtol=FWD_RTOL,
                               atol=FWD_ATOL)
    jwf._stop_units()


def _batch(wf, seed, pad=0):
    """A minibatch of distinct train windows, flat labels, `pad` padded
    rows at the end."""
    data, labels = wf.loader.data, wf.loader.labels
    mb = wf.loader.minibatch_size
    n_valid = wf.loader.class_lengths[1]
    idx = n_valid + np.random.RandomState(seed).choice(
        len(data) - n_valid, mb, replace=False)
    w = np.ones(mb, np.float32)
    if pad:
        w[-pad:] = 0.0
    return data[idx], labels[idx].reshape(-1), w


def _compare_states(jstate, pstate, what):
    host = convert.state_to_numpy(pstate)
    for slot in ("params", "vel"):
        for i, (a, b) in enumerate(zip(jstate[slot], host[slot])):
            assert sorted(a) == sorted(b)
            for k in a:
                np.testing.assert_allclose(
                    b[k], np.asarray(a[k]), rtol=RTOL, atol=ATOL,
                    err_msg=f"{what}: {slot} unit {i} {k}")


def test_train_steps_track_the_jax_step():
    jwf, pwf = _workflows(TOY, use_flash="on")
    with jvariants.pallas_interpret(), \
            _Selected(jvariants, sgd_update="pallas_rows[rt=8]"), \
            _Selected(variants, sgd_update="kernel"):
        jstep = jwf.build_fused_step()
        pstep = pwf.build_fused_step()
        assert jstep.variant_table() == {"flash_attn": "pallas",
                                         "sgd_update": "pallas_rows[rt=8]"}
        assert pstep.variant_table() == {"flash_attn": "kernel",
                                         "sgd_update": "kernel"}
        jstate = jstep.init_state()
        pstate = convert.state_from_jax(jstate, "cpu", pstep)
        _compare_states(jstate, pstate, "initial state")
        for i in range(3):
            x, y, w = _batch(pwf, 20 + i, pad=1 if i == 1 else 0)
            jstate, (jloss, jerr) = jstep.train(jstate, x, y, w)
            pstate, (ploss, perr) = pstep.train(pstate, x, y, w)
            np.testing.assert_allclose(float(ploss), float(jloss),
                                       rtol=LOSS_RTOL, err_msg=f"step {i}")
            assert int(perr) == int(jerr), i
            _compare_states(jstate, pstate, f"after step {i}")
        data, labels = pwf.loader.data, pwf.loader.labels
        xv, yv = data[:4], labels[:4].reshape(-1)
        wv = np.array([1, 1, 1, 0], np.float32)
        jloss, jerr = jstep.evaluate(jstate, xv, yv, wv)
        ploss, perr = pstep.evaluate(pstate, xv, yv, wv)
        np.testing.assert_allclose(float(ploss), float(jloss),
                                   rtol=LOSS_RTOL)
        assert int(perr) == int(jerr)
    jwf._stop_units()


def test_two_epochs_of_run_fused_track_the_jax_package():
    """The sample's widths at seq_len 32 on a 3,000-character text (85
    train windows, 8 validation): 3 train and 1 validation minibatches an
    epoch, each class pass ending in a wrapped minibatch. (On the default
    text's 19 train steps an epoch, the trajectories stay within the
    tolerance but for one near-zero bias element, which drifts to 1.7e-7
    absolute after 38 steps at lr 0.2 with momentum 0.9; the Decision
    history is equal there too.)"""
    jwf, pwf = _workflows({"loader.n_validation": 8},
                          text_=text.synthetic_text(3000))
    jwf.run_fused(epochs=2, uint8_wire=False)
    pwf.run_fused(epochs=2, device="cpu")
    assert len(pwf.decision.history) == 2
    assert pwf.decision.history == jwf.decision.history
    assert pwf.decision.best_validation_err \
        == jwf.decision.best_validation_err
    np.testing.assert_allclose(pwf.evaluator.loss, float(jwf.evaluator.loss),
                               rtol=LOSS_RTOL)
    n = len(pwf.forwards)
    for i, (ju, pu) in enumerate(zip(jwf.forwards, pwf.forwards)):
        jg, pg = jwf.gds[n - 1 - i], pwf.gds[n - 1 - i]
        for k, a in ju.param_arrays().items():
            np.testing.assert_allclose(
                pu.param_arrays()[k].detach().numpy(), np.asarray(a.mem),
                rtol=RTOL, atol=ATOL, err_msg=f"unit {i} {k}")
            jname = jfused._vel_attr(jg, k)
            np.testing.assert_allclose(
                pg.velocity(k).numpy(), np.asarray(getattr(jg, jname).mem),
                rtol=RTOL, atol=ATOL, err_msg=f"unit {i} velocity {k}")
    jwf._stop_units()


def test_velocities_are_named_as_the_jax_package_names_them():
    _, pwf = _workflows(TOY)
    step = pwf.build_fused_step()
    state = step.init_state()
    step.write_back(state)
    want = [["vel_b", "vel_pos", "vel_w"], ["vel_wk", "vel_wo", "vel_wq",
                                            "vel_wv"],
            ["vel_b", "vel_b2", "vel_w", "vel_w2"], ["vel_b", "vel_w"]]
    n = len(pwf.forwards)
    for i, u in enumerate(pwf.forwards):
        g = pwf.gds[n - 1 - i]
        assert sorted(g.vel_attr(k) for k in u.param_arrays()) == want[i]
        for k in u.param_arrays():
            assert getattr(g, g.vel_attr(k)) is g.velocity(k)


def test_fused_step_needs_a_logits_head():
    loader = text.CharSequenceLoader(text=text.synthetic_text(400),
                                     seq_len=8, n_validation=2,
                                     minibatch_size=4)
    wf = StandardWorkflow(layers=[{"type": "seq_linear",
                                   "output_features": 6}],
                          loader=loader, n_classes=6)
    wf.initialize("cpu")
    with pytest.raises(ValueError, match="emits logits"):
        wf.build_fused_step()


def test_cli_trains_the_toy_transformer():
    cmd = [sys.executable, "-m", "veles_tpu_torch",
           "veles_tpu_torch/samples/char_transformer.py", "--fused",
           "--device", "cpu", "-r", "1",
           *(f"root.char_transformer.{k}={v}" for k, v in TOY.items()),
           "root.char_transformer.decision.max_epochs=1"]
    env = dict(os.environ, PYTHONPATH=str(REPO))
    r = subprocess.run(cmd, cwd=REPO, env=env, capture_output=True,
                       text=True, timeout=300)
    assert r.returncode == 0, r.stderr[-2000:]
    line = r.stdout.strip().splitlines()[-1]
    assert line.startswith("TRAINED 1 epochs: loss "), line
    assert "'epoch': 1" in line and "'valid_err'" in line


@pytest.mark.parametrize("override,match", [
    ({"moe_experts": 2, "parallel_mode": "ring"}, "many-GPU slice"),
    ({"parallel_mode": "ring"}, "many-GPU slice"),
    ({"parallel_mode": "ulysses"}, "many-GPU slice")])
def test_multi_card_options_are_refused(override, match):
    with _config(root.char_transformer, override):
        with pytest.raises(NotImplementedError, match=match):
            ct.create_workflow()


def test_entry_points_ask_for_the_card(monkeypatch):
    from veles_tpu_torch import launcher
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with _config(root.char_transformer, TOY):
        wf = ct.create_workflow()
    with pytest.raises(RuntimeError, match="CUDA"):
        wf.initialize()
    saved = root.char_transformer.to_dict()
    try:
        with pytest.raises(RuntimeError, match="CUDA"):
            launcher.train([str(REPO / "veles_tpu_torch" / "samples"
                                / "char_transformer.py"), "--fused",
                            *(f"root.char_transformer.{k}={v}"
                              for k, v in TOY.items())])
    finally:
        root.char_transformer.update(saved)
    assert not wf.is_initialized
