"""The port's fused train step on the CPU, held against the JAX package's
`FusedTrainStep` (local mode, f32, Pallas kernels in interpret mode).

Toy geometry of `__graft_entry__.py` (input_hw 67, width_mult 0.125,
fc_width 64, 16 classes, batch 8, init "scaled"). One seed gives both
packages bit-identical initial parameters; the port's step starts from
`convert.state_from_jax(jax_step.init_state())`. Under both
`lrn_maxpool` settings — the port's `composed` against JAX's
`lrn=pallas_one_pass` + `lrn_maxpool=composed`, the port's `fused`
against JAX's `fused[rt=2,io=native,fuse=1]` — and with K1's counterpart
`sgd_update=pallas_rows[rt=8]` against the port's `kernel`, both take
three steps on the same batches (one with pad-mask rows) at dropout 0,
then evaluate a validation batch; one step at dropout 0.5 runs with the
JAX step's own masks, rebuilt from its key and handed to the port through
`dropout.make_mask`.

Tolerance: loss rtol 1e-5; params and velocities rtol 1e-4, atol 1e-7
per leaf; n_err equal. Both sides compute in f32 (the test conftest pins
JAX matmuls to "highest"), but XLA and PyTorch sum their convolutions and
products in other orders (the JAX stem is also the space-to-depth
rewrite), so the gradients agree to f32 rounding, not bit for bit. The
batches have no pooling window whose two largest values lie within that
rounding of each other: the two packages may route such a window's
gradient to different taps (batch seed 100's second batch has one, two
conv1 outputs 2.8122964 and 2.8122926 in overlapping windows, which moves
one window's gradient to the neighbouring pixel and conv1's weight
gradient by 0.004). That is the max's discontinuity, not a fault of
either package; the routing rule itself is held exactly by
tests/test_torch_backward_kernels.py.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from veles_tpu import prng as jprng
from veles_tpu.ops import variants as jvariants
from veles_tpu.samples import alexnet as jalexnet
from veles_tpu_torch import convert, prng
from veles_tpu_torch.ops import variants
from veles_tpu_torch.samples import alexnet
from veles_tpu_torch.znicz import dropout as pdropout

TOY = dict(minibatch_size=8, width_mult=0.125, fc_width=64, n_train=8,
           n_validation=4, n_classes=16, input_hw=67, init="scaled")
JAX_SEL = {
    "composed": {"lrn": "pallas_one_pass", "lrn_maxpool": "composed",
                 "sgd_update": "pallas_rows[rt=8]"},
    "fused": {"lrn_maxpool": "fused[rt=2,io=native,fuse=1]",
              "sgd_update": "pallas_rows[rt=8]"},
}
LOSS_RTOL = 1e-5
RTOL, ATOL = 1e-4, 1e-7
SEED = 7


@pytest.fixture(autouse=True)
def _restore_base_seeds():
    saved = jprng._base_seed, prng._base_seed
    yield
    jprng._base_seed, prng._base_seed = saved


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


def _set_dropout(wf, ratio):
    for u in wf.forwards:
        if hasattr(u, "dropout_ratio"):
            u.dropout_ratio = ratio


def _workflows(ratio):
    jprng._generators.clear()
    jprng.seed_all(SEED)
    jwf = jalexnet.create_workflow(**TOY)
    _set_dropout(jwf, ratio)
    jwf.initialize(device=None)
    prng._generators.clear()
    prng.seed_all(SEED)
    pwf = alexnet.create_workflow(**TOY)
    _set_dropout(pwf, ratio)
    pwf.initialize("cpu")
    return jwf, pwf


def _batch(seed, pad=0):
    rs = np.random.RandomState(seed)
    x = rs.randn(8, 67, 67, 3).astype(np.float32)
    y = rs.randint(0, 16, 8).astype(np.int32)
    w = np.ones(8, np.float32)
    if pad:
        w[-pad:] = 0.0
    return x, y, w


def _compare_states(jstate, pstate, what):
    host = convert.state_to_numpy(pstate)
    for slot in ("params", "vel"):
        for i, (a, b) in enumerate(zip(jstate[slot], host[slot])):
            assert sorted(a) == sorted(b)
            for k in a:
                np.testing.assert_allclose(
                    b[k], np.asarray(a[k]), rtol=RTOL, atol=ATOL,
                    err_msg=f"{what}: {slot} unit {i} {k}")


@pytest.mark.parametrize("setting", ["composed", "fused"])
def test_train_steps_track_the_jax_step(setting):
    jwf, pwf = _workflows(0.0)
    with jvariants.pallas_interpret(), \
            _Selected(jvariants, **JAX_SEL[setting]), \
            _Selected(variants, lrn_maxpool=setting, sgd_update="kernel"):
        jstep = jwf.build_fused_step()
        pstep = pwf.build_fused_step()
        jtable, ptable = jstep.variant_table(), pstep.variant_table()
        assert jtable["sgd_update"] == "pallas_rows[rt=8]"
        assert ptable["sgd_update"] == "kernel"
        if setting == "fused":
            assert len(pstep.fusion_pairs()) == 2
            assert jtable["lrn_maxpool"] == JAX_SEL["fused"]["lrn_maxpool"]
            assert ptable["lrn_maxpool"] == "fused"
        else:
            assert pstep.fusion_pairs() == []
            assert jtable["lrn"] == "pallas_one_pass"
            assert ptable == {"conv_stem": "direct", "lrn": "kernel",
                              "maxpool": "reduce_window",
                              "sgd_update": "kernel"}
        jstate = jstep.init_state()
        pstate = convert.state_from_jax(jstate, "cpu", pstep)
        _compare_states(jstate, pstate, "initial state")
        for i in range(3):
            x, y, w = _batch(130 + i, pad=3 if i == 1 else 0)
            jstate, (jloss, jerr) = jstep.train(jstate, x, y, w)
            pstate, (ploss, perr) = pstep.train(pstate, x, y, w)
            assert ploss.dim() == 0 and perr.dim() == 0
            np.testing.assert_allclose(float(ploss), float(jloss),
                                       rtol=LOSS_RTOL, err_msg=f"step {i}")
            assert int(perr) == int(jerr), i
            _compare_states(jstate, pstate, f"after step {i}")
        xv, yv, wv = _batch(200, pad=2)
        jloss, jerr = jstep.evaluate(jstate, xv, yv, wv)
        ploss, perr = pstep.evaluate(pstate, xv, yv, wv)
        np.testing.assert_allclose(float(ploss), float(jloss),
                                   rtol=LOSS_RTOL)
        assert int(perr) == int(jerr)
    jwf._stop_units()


def test_dropout_step_with_the_jax_masks_tracks_the_jax_step(monkeypatch):
    jwf, pwf = _workflows(0.5)
    drop_idx = [i for i, u in enumerate(jwf.forwards)
                if getattr(u, "fused_needs_key", False)]
    assert len(drop_idx) == 2
    with jvariants.pallas_interpret(), \
            _Selected(jvariants, **JAX_SEL["fused"]), \
            _Selected(variants, lrn_maxpool="fused"):
        jstep = jwf.build_fused_step()
        pstep = pwf.build_fused_step()
        jstate = jstep.init_state()
        pstate = convert.state_from_jax(jstate, "cpu", pstep)
        # the JAX step folds its state key with each dropout unit's index
        # (fused.py:732); rebuild those masks before the step donates it
        masks = [np.asarray(jvariants.resolve("dropout", unit=jwf.forwards[i])
                            .apply(jax.random.fold_in(jstate["key"], i),
                                   (8, 64), 0.5, jnp.float32))
                 for i in drop_idx]
        assert 0.3 < float((masks[0] > 0).mean()) < 0.7
        handed = list(masks)
        calls = []

        def jax_mask(shape, drop_prob, generator, device,
                     dtype=torch.float32):
            calls.append((tuple(shape), drop_prob, dtype))
            return torch.tensor(handed.pop(0), device=device)

        monkeypatch.setattr(pdropout, "make_mask", jax_mask)
        x, y, w = _batch(300)
        jstate, (jloss, jerr) = jstep.train(jstate, x, y, w)
        pstate, (ploss, perr) = pstep.train(pstate, x, y, w)
        assert calls == [((8, 64), 0.5, torch.float32)] * 2 and not handed
        np.testing.assert_allclose(float(ploss), float(jloss),
                                   rtol=LOSS_RTOL)
        assert int(perr) == int(jerr)
        _compare_states(jstate, pstate, "dropout step")
    jwf._stop_units()


def test_state_from_jax_checks_and_write_back_seeds_the_next_state():
    _, pwf = _workflows(0.0)
    step = pwf.build_fused_step()
    state = step.init_state()
    host = convert.state_to_numpy(state)
    assert host["lr_scale"] == 1.0
    assert all(not np.any(v) for layer in host["vel"] for v in layer.values())
    back = convert.state_from_jax(host, "cpu", step)
    assert all(t.requires_grad for layer in back["params"]
               for t in layer.values())
    bad = {"params": tuple(dict(p) for p in host["params"]),
           "vel": host["vel"], "lr_scale": 1.0}
    bad["params"][0]["weights"] = bad["params"][0]["weights"][:-1]
    with pytest.raises(ValueError, match="params.*shape"):
        convert.state_from_jax(bad, "cpu", step)
    bad = {"params": host["params"], "vel": host["vel"][:-1],
           "lr_scale": 1.0}
    with pytest.raises(ValueError, match="vel.*forward units"):
        convert.state_from_jax(bad, "cpu", step)
    # a trained state lands in the units and the gradient twins, and the
    # next state starts from there
    x, y, w = _batch(400)
    state, _ = step.train(state, x, y, w)
    step.write_back(state)
    trained = convert.state_to_numpy(state)
    for u, g, p, v in zip(step.forwards, step.gd_units, trained["params"],
                          trained["vel"]):
        for k, t in u.param_arrays().items():
            np.testing.assert_array_equal(t.detach().numpy(), p[k])
            vel = g.vel_w if k == "weights" else g.vel_b
            np.testing.assert_array_equal(vel.numpy(), v[k])
    again = convert.state_to_numpy(step.init_state())
    for slot in ("params", "vel"):
        for a, b in zip(trained[slot], again[slot]):
            for k in a:
                np.testing.assert_array_equal(a[k], b[k])
