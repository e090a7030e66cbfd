"""The port's Adam (ops/optim.py and the fused step) on the CPU, held
against the JAX package's.

- `adam_step_factors` and `adam_update` against the JAX functions on
  random leaves over several `t`, with and without L2 weight decay: the
  same bits (both compute the same f32 operations in the same order; the
  bias corrections `1 - b ** t` in f32 from the int32 `t`).
- The fused step with `optimizer="adam"`, 5 steps from the JAX step's
  state carried across by `convert.state_from_jax`, on the JAX test's FC
  workflow (`tests/test_parallel_fused.py::test_fused_adam_trains`: a
  scaled-tanh layer of 32 and a softmax of 10 on 8x8 synthetic samples)
  and on the toy AlexNet (`__graft_entry__.py`'s geometry, dropout 0, lr
  1e-4, Pallas interpreted on the JAX side). Tolerances: the port's
  train-step ones, loss rtol 1e-5, leaves and moments rtol 1e-4, atol
  1e-7, with one allowance, the Adam sign trap: Adam moves an element by
  lr·m̂/(√v̂ + eps), about ±lr whatever the gradient's size, so the
  relative f32 error of a small gradient (a residue of cancelling sums,
  which two summation orders give differently) becomes an error of the
  same relative size in a step of ~lr, and up to 2·lr where the residue
  is at the level of eps or changes sign. At most 4 parameter elements
  of a comparison may use it, each within 2·lr·steps of the JAX value.
  The toy AlexNet's batches give exactly 1, 1, 1, 2, 2 over its 5 steps
  (a conv weight whose first gradient is 3e-9 in the JAX step and 2e-10
  in the port's, 2.1e-5 apart after it; from the fourth step another
  whose gradient, ~1e-6, differs by 0.2%: 2.6e-7 apart); the FC
  workflow has none. The moments are all within the tolerance.
- `gd_config={"optimizer": "adam"}` and the CLI override
  `root.alexnet.gd.optimizer=adam` reach the gradient twins and the step.
"""

from pathlib import Path

import numpy as np
import pytest
import torch

import jax.numpy as jnp
from veles_tpu import prng as jprng
from veles_tpu.loader.synthetic import \
    SyntheticClassifierLoader as JSyntheticLoader
from veles_tpu.ops import optim as joptim
from veles_tpu.ops import variants as jvariants
from veles_tpu.znicz.standard_workflow import \
    StandardWorkflow as JStandardWorkflow
from veles_tpu_torch import convert, launcher, prng, root
from veles_tpu_torch.loader.synthetic import SyntheticClassifierLoader
from veles_tpu_torch.ops import optim, variants
from veles_tpu_torch.parallel.fused import pair_gd_configs
from veles_tpu_torch.znicz.standard_workflow import StandardWorkflow
from tests.test_torch_train_step import JAX_SEL, _batch, _Selected, \
    _workflows

ALEXNET = str(Path(__file__).resolve().parent.parent / "veles_tpu_torch"
              / "samples" / "alexnet.py")
LOSS_RTOL = 1e-5
RTOL, ATOL = 1e-4, 1e-7
#: the Adam sign trap's allowance (compare_adam): at most 4 parameter
#: elements of a comparison, each within 2·lr a step
TRAP_MAX = 4
FC_LAYERS = [
    {"type": "all2all_tanh", "output_sample_shape": 32,
     "weights_stddev": 0.05},
    {"type": "softmax", "output_sample_shape": 10, "weights_stddev": 0.05},
]


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


def fc_workflows(seed=99, minibatch_size=48, max_epochs=2,
                 gd_config=None, n_train=240, n_validation=48):
    """The JAX fused-step tests' FC workflow, built in both packages from
    one seed (bit-identical parameters and loader draws), uninitialized."""
    gd_config = gd_config or {"learning_rate": 3e-3, "optimizer": "adam"}
    kw = dict(n_classes=10, sample_shape=(8, 8), n_validation=n_validation,
              n_train=n_train, minibatch_size=minibatch_size, noise=0.6)
    wf_kw = dict(layers=FC_LAYERS, loss="softmax", n_classes=10,
                 decision_config={"max_epochs": max_epochs,
                                  "fail_iterations": 50},
                 gd_config=gd_config)
    jprng._generators.clear()
    jprng.seed_all(seed)
    jwf = JStandardWorkflow(loader=JSyntheticLoader(**kw), **wf_kw)
    prng._generators.clear()
    prng.seed_all(seed)
    pwf = StandardWorkflow(loader=SyntheticClassifierLoader(**kw), **wf_kw)
    return jwf, pwf


def fc_batch(seed, n=48, pad=0):
    rs = np.random.RandomState(seed)
    x = rs.randn(n, 8, 8).astype(np.float32)
    y = rs.randint(0, 10, n).astype(np.int32)
    w = np.ones(n, np.float32)
    if pad:
        w[-pad:] = 0.0
    return x, y, w


def compare_states(jstate, pstate, what, rtol=RTOL, atol=ATOL,
                   slots=("params", "vel")):
    """Every leaf, velocity, moment and `t` of the port's state against
    the JAX state's."""
    host = convert.state_to_numpy(pstate)
    for slot in slots:
        for i, (a, b) in enumerate(zip(jstate[slot], host[slot])):
            assert sorted(a) == sorted(b), (what, slot, i)
            for k in a:
                if k == "t":
                    assert int(b[k]) == int(a[k]), (what, i)
                    continue
                sub = (a[k].items() if isinstance(a[k], dict)
                       else [(None, a[k])])
                for name, arr in sub:
                    got = b[k][name] if name is not None else b[k]
                    np.testing.assert_allclose(
                        got, np.asarray(arr), rtol=rtol, atol=atol,
                        err_msg=f"{what}: {slot} unit {i} {k} {name}")


def compare_adam(jstate, pstate, what, lr, steps):
    """`compare_states` for an Adam state, with the allowance of the Adam
    sign trap in units of lr: at most TRAP_MAX parameter elements may lie
    outside the tolerance, each within 2·lr·steps of the JAX value; every
    other element, and every moment, within the tolerance. Returns how
    many used the allowance."""
    host = convert.state_to_numpy(pstate)
    trapped = 0
    for i, (ja, pa) in enumerate(zip(jstate["params"], host["params"])):
        for k in ja:
            want = np.asarray(ja[k])
            off = ~np.isclose(pa[k], want, rtol=RTOL, atol=ATOL)
            assert np.all(np.abs(pa[k] - want)[off] <= 2 * lr * steps), \
                f"{what}: params unit {i} {k}"
            trapped += int(off.sum())
    assert trapped <= TRAP_MAX, f"{what}: {trapped} elements beyond " \
        f"rtol {RTOL}, atol {ATOL}"
    compare_states(jstate, pstate, what, slots=("vel",))
    return trapped


@pytest.mark.parametrize("weight_decay", [0.0, 5e-4])
def test_adam_update_gives_the_jax_functions_bits(weight_decay):
    rs = np.random.RandomState(5)
    shapes = {"weights": (3, 3, 4, 8), "bias": (8,)}
    p = {k: rs.randn(*s).astype(np.float32) for k, s in shapes.items()}
    cfg = dict(lr=3e-3, weight_decay=weight_decay)
    jp = {k: jnp.asarray(a) for k, a in p.items()}
    js = joptim.adam_init(jp)
    pp = {k: torch.tensor(a) for k, a in p.items()}
    ps = optim.adam_init(pp, torch.device("cpu"))
    assert ps["t"].dtype == torch.int32 and ps["t"].shape == ()
    for t in range(1, 8):
        g = {k: (rs.randn(*s) * 10.0 ** rs.randint(-6, 0)).astype(
            np.float32) for k, s in shapes.items()}
        jp, js = joptim.adam_update(jp, {k: jnp.asarray(a)
                                         for k, a in g.items()},
                                    js, joptim.AdamConfig(**cfg),
                                    lr_scale=jnp.float32(1.0))
        optim.adam_update(pp, {k: torch.tensor(a) for k, a in g.items()},
                          ps, optim.AdamConfig(**cfg))
        assert int(ps["t"]) == int(js["t"]) == t
        for k in shapes:
            np.testing.assert_array_equal(pp[k].numpy(), np.asarray(jp[k]))
            np.testing.assert_array_equal(ps["m"][k].numpy(),
                                          np.asarray(js["m"][k]))
            np.testing.assert_array_equal(ps["v"][k].numpy(),
                                          np.asarray(js["v"][k]))


def test_adam_step_factors_give_the_jax_bits_over_t():
    for b1, b2 in ((0.9, 0.999), (0.5, 0.95)):
        ts = list(range(1, 300)) + [1000, 4321, 10000, 99999]
        jcfg, pcfg = joptim.AdamConfig(b1=b1, b2=b2), \
            optim.AdamConfig(b1=b1, b2=b2)
        for t in ts:
            j = joptim.adam_step_factors(jcfg, jnp.int32(t))
            p = optim.adam_step_factors(pcfg, torch.tensor(t,
                                                           dtype=torch.int32))
            for a, b in zip(j, p):
                assert b.dtype == torch.float32
                assert np.float32(np.asarray(a)) == b.numpy(), (b1, t)


def test_fc_adam_step_tracks_the_jax_step():
    jwf, pwf = fc_workflows()
    jwf.initialize(device=None)
    pwf.initialize("cpu")
    jstep = jwf.build_fused_step()
    pstep = pwf.build_fused_step()
    assert all(isinstance(c, optim.AdamConfig) for c in pstep.cfgs)
    assert "sgd_update" not in pstep.variant_table()
    assert "sgd_update" not in jstep.variant_table()
    jstate = jstep.init_state()
    pstate = convert.state_from_jax(jstate, "cpu", pstep)
    assert set(pstate["vel"][0]) == {"m", "v", "t"}
    losses = []
    for i in range(5):
        x, y, w = fc_batch(40 + i, pad=5 if i == 2 else 0)
        jstate, (jloss, jerr) = jstep.train(jstate, x, y, w)
        pstate, (ploss, perr) = pstep.train(pstate, x, y, w)
        np.testing.assert_allclose(float(ploss), float(jloss),
                                   rtol=LOSS_RTOL, err_msg=f"step {i}")
        assert int(perr) == int(jerr), i
        assert compare_adam(jstate, pstate, f"after step {i}", 3e-3,
                            i + 1) == 0
        losses.append(float(ploss))
    assert all(int(v["t"]) == 5 for v in pstate["vel"])
    assert pstate["vel"][0]["t"].dtype == torch.int32
    # the moments stay in the state: write_back leaves the twins' unset
    pstep.write_back(pstate)
    for g in pwf.gds:
        assert g.vel_w is None and g.vel_b is None
    for u, p in zip(pwf.forwards, pstate["params"]):
        for k, t in u.param_arrays().items():
            assert torch.equal(t, p[k].detach())
    jwf._stop_units()


def test_toy_alexnet_adam_steps_track_the_jax_step():
    jwf, pwf = _workflows(0.0)
    for wf in (jwf, pwf):
        for g in wf.gds:
            g.optimizer = "adam"       # read when the step is built
            g.learning_rate = 1e-4
    with jvariants.pallas_interpret(), \
            _Selected(jvariants, **JAX_SEL["fused"]), \
            _Selected(variants, lrn_maxpool="fused"):
        jstep = jwf.build_fused_step()
        pstep = pwf.build_fused_step()
        table = pstep.variant_table()
        assert table["lrn_maxpool"] == "fused" and "sgd_update" not in table
        jstate = jstep.init_state()
        pstate = convert.state_from_jax(jstate, "cpu", pstep)
        trapped = []
        for i in range(5):
            x, y, w = _batch(150 + i, pad=2 if i == 3 else 0)
            jstate, (jloss, jerr) = jstep.train(jstate, x, y, w)
            pstate, (ploss, perr) = pstep.train(pstate, x, y, w)
            np.testing.assert_allclose(float(ploss), float(jloss),
                                       rtol=LOSS_RTOL, err_msg=f"step {i}")
            assert int(perr) == int(jerr), i
            trapped.append(compare_adam(jstate, pstate, f"after step {i}",
                                        1e-4, i + 1))
    # this seed's batches give one such element from the first step on,
    # and a second from the fourth
    assert trapped == [1, 1, 1, 2, 2]
    # parameterless layers keep empty moments and t = 0
    for p, v in zip(pstate["params"], pstate["vel"]):
        assert set(v) == {"m", "v", "t"}
        assert int(v["t"]) == (5 if p else 0)
        assert sorted(v["m"]) == sorted(p) == sorted(v["v"])
    jwf._stop_units()


def test_state_from_jax_refuses_the_other_update_rule():
    jwf, pwf = fc_workflows()
    jwf.initialize(device=None)
    pwf.initialize("cpu")
    jstate = jwf.build_fused_step().init_state()
    for g in pwf.gds:
        g.optimizer = "sgd"
    with pytest.raises(ValueError, match="unit 0: the step updates this "
                                         "layer with SGD"):
        convert.state_from_jax(jstate, "cpu", pwf.build_fused_step())
    jwf._stop_units()


def test_gd_config_and_the_cli_override_reach_the_gradient_twins():
    _, pwf = fc_workflows(gd_config={"optimizer": "adam", "adam_beta1": 0.8,
                                     "adam_beta2": 0.99, "adam_eps": 1e-6,
                                     "learning_rate": 2e-3,
                                     "weights_decay": 1e-4})
    pwf.initialize("cpu")
    g = pwf.gds[0]
    assert (g.optimizer, g.adam_beta1, g.adam_beta2, g.adam_eps) == \
        ("adam", 0.8, 0.99, 1e-6)
    _, cfgs = pair_gd_configs(pwf)
    assert cfgs == [optim.AdamConfig(lr=2e-3, b1=0.8, b2=0.99, eps=1e-6,
                                     weight_decay=1e-4)] * 2
    for g in pwf.gds:
        g.optimizer = "adamw"
    with pytest.raises(ValueError, match="optimizer 'adamw'"):
        pair_gd_configs(pwf)

    # the CLI: `root.alexnet.gd.optimizer=adam` through the sample's
    # gd_config; three toy steps on the CPU, t counting them
    seen = []
    from veles_tpu_torch.parallel.fused import FusedTrainStep
    inner = FusedTrainStep.train

    def spy(self, state, *a, **kw):
        out = inner(self, state, *a, **kw)
        seen.append([int(v["t"]) for v, p in zip(out[0]["vel"],
                                                 out[0]["params"]) if p])
        return out

    saved = root.alexnet.to_dict()
    prng._generators.clear()
    try:
        FusedTrainStep.train = spy
        wf = launcher.train([
            ALEXNET, "--fused", "--device",
            "cpu", "-r", "3", "root.alexnet.gd.optimizer=adam",
            "root.alexnet.gd.learning_rate=0.0001",
            "root.alexnet.loader.input_hw=67", "root.alexnet.width_mult=0.125",
            "root.alexnet.fc_width=64", "root.alexnet.n_classes=16",
            "root.alexnet.loader.minibatch_size=8",
            "root.alexnet.loader.n_train=24",
            "root.alexnet.loader.n_validation=8",
            "root.alexnet.decision.max_epochs=1"])
    finally:
        FusedTrainStep.train = inner
        root.alexnet = saved
    assert {g.optimizer for g in wf.gds} == {"adam"}
    assert {g.learning_rate for g in wf.gds} == {1e-4}
    assert seen == [[1] * 8, [2] * 8, [3] * 8]
    assert np.isfinite(wf.evaluator.loss)
