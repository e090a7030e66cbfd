"""The GPipe pipeline on the CPU (parallel/pipeline.py), held against the
JAX package's (`veles_tpu/parallel/pipeline.py` on 4 virtual devices)
and against the port's local fused step.

- `pipeline_apply` / `make_pipeline` over 4 stage devices against the
  sequential golden and the JAX `make_pipeline` (rtol 1e-5, atol 1e-6),
  and its gradients against the sequential model's autograd and
  `jax.grad` of the JAX pipeline (rtol 1e-5, atol 1e-6).
- `PipelineTrainStep` on 4 stages (the JAX test's heterogeneous FC chain
  12 -> 24 -> 20 -> 16 -> 4, 4 microbatches of 8) for 6 steps: the
  losses, n_err and every parameter against the port's local fused step
  (rtol 1e-5, atol 1e-6: the same arithmetic but for the microbatched
  products and their summed gradients) and against the JAX
  `PipelineTrainStep` (rtol 1e-4, atol 1e-6: XLA sums its products in
  another order); n_err equal; the stage rows each hold one stage; the
  pad-mask evaluate; a per-token head (the toy char-transformer) against
  the local step.
- `split_stages` gives the JAX split on the JAX test's units, on real
  workflows and with explicit boundaries, and its refusals.
- `run_pipelined` end to end (the JAX test's bar), and 4 stages against
  the JAX `run_pipelined`'s Decision history.
- The refusals (dropout, Adam, a batch the microbatches do not divide)
  and the CLI: `--pp` trains, and its exclusions exit as the JAX
  launcher's.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh

from veles_tpu import prng as jprng
from veles_tpu.backends import XLADevice
from veles_tpu.config import root as jroot
from veles_tpu.loader.synthetic import SyntheticClassifierLoader as JLoader
from veles_tpu.parallel import pipeline as jpipe
from veles_tpu.znicz.standard_workflow import \
    StandardWorkflow as JWorkflow
from veles_tpu_torch import convert, launcher, prng
from veles_tpu_torch.config import root
from veles_tpu_torch.loader.synthetic import SyntheticClassifierLoader
from veles_tpu_torch.parallel import pipeline as pipe
from veles_tpu_torch.samples import char_transformer as ct
from veles_tpu_torch.znicz.standard_workflow import StandardWorkflow

RTOL, ATOL = 1e-5, 1e-6
JAX_STEP_RTOL = 1e-4
CPU4 = ["cpu"] * 4
PP_LAYERS = [
    {"type": "all2all_tanh", "output_sample_shape": 24,
     "weights_stddev": 0.1},
    {"type": "all2all_tanh", "output_sample_shape": 20,
     "weights_stddev": 0.1},
    {"type": "all2all_tanh", "output_sample_shape": 16,
     "weights_stddev": 0.1},
    {"type": "softmax", "output_sample_shape": 4, "weights_stddev": 0.05}]


@pytest.fixture(autouse=True)
def _restore():
    saved = (jprng._base_seed, prng._base_seed,
             jroot.char_transformer.to_dict(),
             root.char_transformer.to_dict())
    yield
    (jprng._base_seed, prng._base_seed, jroot.char_transformer,
     root.char_transformer) = saved


# -- the homogeneous primitive ------------------------------------------------

def _stage_params(s=4, d=8, seed=3):
    rng = np.random.RandomState(seed)
    return {"w": (rng.randn(s, d, d) * 0.5).astype(np.float32),
            "b": (rng.randn(s, d) * 0.1).astype(np.float32)}


def _torch_stage(p, x):
    return torch.tanh(x @ p["w"] + p["b"])


def _jax_stage(p, x):
    return jnp.tanh(x @ p["w"] + p["b"])


def test_pipeline_matches_sequential_and_jax(eight_devices):
    s, d, m, mb = 4, 8, 6, 5
    params = _stage_params(s, d)
    xs = np.random.RandomState(4).randn(m, mb, d).astype(np.float32)
    gold = xs
    for si in range(s):
        gold = np.tanh(gold @ params["w"][si] + params["b"][si])
    run = pipe.make_pipeline(CPU4, _torch_stage)
    got = run({k: torch.from_numpy(v) for k, v in params.items()},
              torch.from_numpy(xs)).numpy()
    np.testing.assert_allclose(got, gold, rtol=RTOL, atol=ATOL)
    jrun = jpipe.make_pipeline(Mesh(np.asarray(eight_devices[:s]),
                                    ("stage",)), _jax_stage)
    np.testing.assert_allclose(got, np.asarray(jrun(params, xs)),
                               rtol=RTOL, atol=ATOL)


def test_pipeline_differentiable(eight_devices):
    s, d, m, mb = 4, 8, 4, 3
    params = _stage_params(s, d, seed=5)
    xs = np.random.RandomState(6).randn(m, mb, d).astype(np.float32)
    tp = {k: torch.from_numpy(v).requires_grad_(True)
          for k, v in params.items()}
    run = pipe.make_pipeline(CPU4, _torch_stage)
    (run(tp, torch.from_numpy(xs)) ** 2).sum().backward()
    sq = {k: torch.from_numpy(v).requires_grad_(True)
          for k, v in params.items()}
    y = torch.from_numpy(xs)
    for si in range(s):
        y = _torch_stage({"w": sq["w"][si], "b": sq["b"][si]}, y)
    (y ** 2).sum().backward()
    jrun = jpipe.make_pipeline(Mesh(np.asarray(eight_devices[:s]),
                                    ("stage",)), _jax_stage)
    jg = jax.grad(lambda p: (jrun(p, xs) ** 2).sum())(params)
    for k in params:
        np.testing.assert_allclose(tp[k].grad.numpy(), sq[k].grad.numpy(),
                                   rtol=RTOL, atol=ATOL, err_msg=k)
        np.testing.assert_allclose(tp[k].grad.numpy(), np.asarray(jg[k]),
                                   rtol=RTOL, atol=ATOL, err_msg=k)


def test_stage_mesh_resolves_devices():
    assert pipe.make_stage_mesh(["cpu", "cpu"]) == [torch.device("cpu")] * 2


# -- the workflow step --------------------------------------------------------

def _pp_kw():
    return dict(n_classes=4, sample_shape=(12,), n_validation=32,
                n_train=128, minibatch_size=32, noise=0.3)


def _wf_kw(layers=PP_LAYERS, gd=None):
    return dict(layers=layers, loss="softmax", n_classes=4,
                decision_config={"max_epochs": 3, "fail_iterations": 50},
                gd_config=gd or {"learning_rate": 0.1,
                                 "gradient_moment": 0.9},
                name="PPWF")


def _port_wf(seed=4242, **kw):
    prng._generators.clear()
    prng.seed_all(seed)
    wf = StandardWorkflow(loader=SyntheticClassifierLoader(**_pp_kw()),
                          **_wf_kw(**kw))
    wf.initialize("cpu")
    return wf


def _jax_wf(seed=4242):
    jprng._generators.clear()
    jprng.seed_all(seed)
    wf = JWorkflow(loader=JLoader(**_pp_kw()), **_wf_kw())
    wf.initialize(device=XLADevice())
    return wf


def _host(state):
    return tuple({k: t.detach().numpy() for k, t in p.items()}
                 for p in state["params"])


def _close_layers(got, want, rtol, atol):
    for i, (g, w) in enumerate(zip(got, want)):
        for k in w:
            np.testing.assert_allclose(g[k], np.asarray(w[k]), rtol=rtol,
                                       atol=atol, err_msg=f"unit {i} {k}")


def test_pipeline_step_matches_the_local_step_and_jax(eight_devices):
    jwf = _jax_wf()
    jpp = jwf.build_pipeline_step(jpipe.make_stage_mesh(eight_devices[:4]),
                                  n_microbatches=4)
    js = jpp.init_state()
    lwf, pwf = _port_wf(), _port_wf()
    jinit = tuple({k: np.asarray(a.mem) for k, a in u.param_arrays().items()}
                  for u in jwf.forwards)
    for wf in (lwf, pwf):
        convert.params_from_jax(jinit, "cpu", workflow=wf)
    local = lwf.build_fused_step()
    sl = local.init_state()
    pp = pwf.build_pipeline_step(CPU4, n_microbatches=4)
    assert [len(st) for st in pp.stages] == [1, 1, 1, 1]
    sp = pp.init_state()
    rng = np.random.RandomState(9)
    for i in range(6):
        x = rng.randn(32, 12).astype(np.float32)
        y = rng.randint(0, 4, 32)
        sl, (ll, el) = local.train(sl, x, y)
        sp, (lp, ep) = pp.train(sp, x, y)
        js, (lj, ej) = jpp.train(js, x, y)
        np.testing.assert_allclose(float(lp), float(ll), rtol=RTOL)
        np.testing.assert_allclose(float(lp), float(lj), rtol=RTOL)
        assert int(ep) == int(el) == int(ej), i
    got = pp.params_dicts(sp)
    _close_layers(got, _host(sl), RTOL, ATOL)
    _close_layers(got, jpp.params_dicts(js), JAX_STEP_RTOL, ATOL)
    # stage-resident rows: one a stage, none the whole model
    total = sum(t.numel() for u in pwf.forwards
                for t in u.param_arrays().values())
    assert [r.numel() for r in sp["params"]] == \
        [sum(t.numel() for t in st[0].param_arrays().values())
         for st in pp.stages]
    assert max(r.numel() for r in sp["params"]) < total / 2
    # the pad mask: a wrapped minibatch drops its filler rows
    x = rng.randn(32, 12).astype(np.float32)
    y = rng.randint(0, 4, 32)
    w = (np.arange(32) < 24).astype(np.float32)
    le, ee = local.evaluate(sl, x, y, w)
    pe, eep = pp.evaluate(sp, x, y, w)
    je, eej = jpp.evaluate(js, x, y, w)
    np.testing.assert_allclose(float(pe), float(le), rtol=RTOL)
    np.testing.assert_allclose(float(pe), float(je), rtol=RTOL)
    assert int(eep) == int(ee) == int(eej)
    # write_back puts the rows into the units
    pp.write_back(sp)
    _close_layers(tuple({k: t.detach().numpy() for k, t in
                         u.param_arrays().items()} for u in pwf.forwards),
                  got, 0, 0)


def test_per_token_head_matches_the_local_step():
    """The toy char-transformer (seq_len 32: the loss over (N, S, V)
    logits and flat per-token labels) in 4 stages of one unit each."""
    over = {"embed": 16, "n_heads": 2, "ffn": 24, "loader.seq_len": 32,
            "loader.minibatch_size": 8}
    wfs = []
    for _ in range(2):
        prng._generators.clear()
        prng.seed_all(31)
        node = root.char_transformer
        saved = node.to_dict()
        for k, v in over.items():
            node.override(k, v)
        try:
            wf = ct.create_workflow()
        finally:
            node.update(saved)
        wf.initialize("cpu")
        wfs.append(wf)
    local = wfs[0].build_fused_step()
    pp = wfs[1].build_pipeline_step(CPU4, n_microbatches=2)
    sl, sp = local.init_state(), pp.init_state()
    loader = wfs[0].loader
    idx = loader._indices_per_class[2]
    for i in range(2):
        rows = idx[i * 8:(i + 1) * 8]
        x, y = loader.data[rows], loader.labels[rows].reshape(-1)
        sl, (ll, el) = local.train(sl, x, y)
        sp, (lp, ep) = pp.train(sp, x, y)
        np.testing.assert_allclose(float(lp), float(ll), rtol=RTOL)
        assert int(ep) == int(el)
    _close_layers(pp.params_dicts(sp), _host(sl), RTOL, ATOL)


def test_bf16_pipeline_keeps_f32_rows():
    wf = _port_wf()
    pp = wf.build_pipeline_step(["cpu"] * 2, n_microbatches=2,
                                compute_dtype="bfloat16")
    s = pp.init_state()
    x = np.random.RandomState(2).randn(32, 12).astype(np.float32)
    s, (loss, n_err) = pp.train(s, x, np.arange(32) % 4)
    assert np.isfinite(float(loss))
    assert all(r.dtype == torch.float32 for r in s["params"] + s["vel"])


def test_pipeline_refusals():
    drop = [dict(PP_LAYERS[0]), {"type": "dropout", "dropout_ratio": 0.5},
            PP_LAYERS[3]]
    with pytest.raises(ValueError, match="per-step random numbers"):
        _port_wf(layers=drop).build_pipeline_step(["cpu"], 2)
    with pytest.raises(ValueError, match="SGD family only"):
        _port_wf(gd={"learning_rate": 1e-3, "optimizer": "adam"}) \
            .build_pipeline_step(["cpu"], 2)
    pp = _port_wf().build_pipeline_step(["cpu"], 5)
    with pytest.raises(ValueError, match="not divisible into 5"):
        pp.train(pp.init_state(), np.zeros((32, 12), np.float32),
                 np.zeros(32, np.int64))


# -- split_stages -------------------------------------------------------------

class _FakeArray:
    def __init__(self, n):
        self.shape = (n,)

    def __bool__(self):
        return True


class _FakeUnit:
    def __init__(self, n):
        self._a = _FakeArray(n)

    def param_arrays(self):
        return {"w": self._a}


@pytest.mark.parametrize("sizes,n", [((100, 100, 100, 100), 2),
                                     ((10, 10, 300, 10), 2),
                                     ((5, 50, 500, 5, 50), 3),
                                     ((1, 1, 1, 1), 4)])
def test_split_stages_matches_jax(sizes, n):
    units = [_FakeUnit(s) for s in sizes]
    want = [len(st) for st in jpipe.split_stages(units, n)]
    assert [len(st) for st in pipe.split_stages(units, n)] == want


def test_split_stages_on_workflows_and_boundaries():
    jwf, pwf = _jax_wf(), _port_wf()
    for n in (1, 2, 3, 4):
        assert [len(s) for s in pipe.split_stages(pwf.forwards, n)] == \
            [len(s) for s in jpipe.split_stages(jwf.forwards, n)]
    assert [len(s) for s in pipe.split_stages(
        pwf.forwards, 2, boundaries=[3])] == [3, 1]
    with pytest.raises(ValueError, match="only 4 units"):
        pipe.split_stages(pwf.forwards, 5)
    with pytest.raises(ValueError, match="strictly increasing"):
        pipe.split_stages(pwf.forwards, 3, boundaries=[2, 2])


# -- run_pipelined ------------------------------------------------------------

def test_run_pipelined_end_to_end():
    """The JAX test's bar: 6 epochs, the best validation error under 12
    of 32, the weights written back."""
    wf = _port_wf(seed=515)
    wf.decision.max_epochs = 6
    wf.run_pipelined(n_microbatches=4, device="cpu")
    assert wf.decision.epoch_number == 6
    assert wf.decision.best_validation_err < 12, \
        wf.decision.best_validation_err
    assert wf.forwards[0].weights.detach().std() > 0


def test_four_stages_track_the_jax_run_pipelined():
    jwf = _jax_wf(seed=515)
    jwf.run_pipelined(n_microbatches=4)     # 4 of 8 virtual devices
    pwf = _port_wf(seed=515)
    pwf.run_pipelined(devices=CPU4, n_microbatches=4)
    assert pwf.decision.history == jwf.decision.history


# -- the CLI ------------------------------------------------------------------

MOE_SAMPLE = str(pipe.__file__).replace("parallel/pipeline.py",
                                        "samples/moe.py")
SMALL = ["root.moe.loader.n_train=256", "root.moe.loader.n_validation=64",
         "root.moe.decision.max_epochs=1"]


def test_cli_trains_with_pp():
    saved = root.moe.to_dict()
    try:
        wf = launcher.train([MOE_SAMPLE, "--pp", "2", "--device", "cpu",
                             "-r", "3", *SMALL])
    finally:
        root.moe = saved
    assert wf.decision.epoch_number == 1
    assert np.isfinite(wf.evaluator.loss)


@pytest.mark.parametrize("extra,match", [
    (["--pp", "0"], "--pp needs a microbatch count >= 1"),
    (["--pp", "2", "--fused"], "mutually exclusive"),
    (["--pp", "2", "--accum", "2"], "--pp already microbatches"),
    (["--pp", "2", "--serve", "0"], "serve-only mode"),
    (["--pp", "2", "--ep"], "exclusive with --tp/--sp/--ep"),
    (["--pp", "2", "-l", "127.0.0.1:1"], "one process over the local"),
    (["--ep"], "combine with -l/-m"),
    (["--ep", "--fused"], "combine with -l/-m")])
def test_cli_refusals(extra, match):
    with pytest.raises(SystemExit, match=match):
        launcher.parse_args([MOE_SAMPLE, *extra])


@pytest.mark.parametrize("extra", [["--feed-ahead", "2"], ["--autotune"],
                                   ["--nonfinite-guard"],
                                   ["--zero-sharding", "off"]])
def test_cli_pp_takes_the_fused_knobs(extra):
    args = launcher.parse_args([MOE_SAMPLE, "--pp", "2", *extra])
    assert args.pp == 2


def test_cli_backend_is_the_granular_graphs():
    with pytest.raises(SystemExit):
        launcher.parse_args([MOE_SAMPLE, "--pp", "2", "-b", "numpy"])
