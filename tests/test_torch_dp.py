"""The port's data-parallel fused step (mode "dp") on the CPU: gloo
process groups of 2 and 4 ranks, held against the JAX package's LOCAL
`FusedTrainStep` on the global batch.

The JAX dp mode does not run under this jax (its shard_map `out_specs`
check, veles_tpu/parallel/fused.py:1360), so the port is held to the
property the JAX test states (tests/test_parallel_fused.py:105-106):
sharded equals local on the same global batch, rtol 1e-5, atol 1e-6 —
here against the JAX local step itself, which runs. Two workflows: a
narrow AlexNet-like net (conv 5x5/2 of 8 -> LRN -> 3x3/2 max pool -> FC
24 -> dropout -> softmax 10 on 27x27x3; the port's fused LRN -> pool
pair, K4/K5's plain versions, against the JAX package's XLA defaults)
and MNIST's FC (784 -> 100 tanh -> softmax 10). Both packages start from
the JAX workflow's seeded parameters (`convert.params_from_jax`), train
3 steps of 8 rows (the third with two pad-mask rows) at dropout 0, and
evaluate a validation batch.

Each world is one set of processes per module (`python WORKER RANK
WORLD PORT DIR`, a free port, OMP_NUM_THREADS=1, a time limit), running
every scenario in turn: ZeRO off (the replicated all-reduce update), and
ZeRO on under each named grad_reduce point (f32, bf16, int8_block,
int8_ef, hier2; the world of 4 runs hier2 as 2 hosts x 2 ranks through
VELES_GRAD_REDUCE_LOCAL=2, the world of 2 as its flat degenerate), Adam
under ZeRO, a group of one rank against the port's local step, the
ranks' dropout streams, and a snapshot and a checkpoint written at 2
ranks and restored at 4.

Tolerances:
- f32 and hier2, ZeRO on and off, and Adam: rtol 1e-5, atol 1e-6 per
  leaf on the parameters and velocities (moments), the losses rtol 1e-5,
  n_err equal (the ranks' partial sums and XLA's single sum differ in
  order only);
- bf16 and int8 wires: the gradient is rounded on the wire, so the
  trained parameters move off the exact ones by a share of the update:
  |p - p_jax| <= LOSSY_TOL[wire] * |p_jax - p_init| over all leaves
  (bf16 2^-7: 8 mantissa bits, one rounding per rank's partial and one
  of the sum; int8 2^-5: a block's codes carry its absmax / 127, so an
  element's error reaches 1/254 of the block's largest, and small
  elements of a block with a large one lose most of their bits; error
  feedback gives the lost part back at the next step. Measured over both
  worlds and workflows: bf16 2.1e-3 to 3.1e-3, int8_block 5.1e-3 to
  8.8e-3, int8_ef 2.6e-3 to 4.0e-3), the losses within 1e-3 relative.
"""

import os
import pickle
import socket
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

from veles_tpu import prng as jprng
from veles_tpu.loader.synthetic import \
    SyntheticClassifierLoader as JaxLoader
from veles_tpu.znicz.standard_workflow import \
    StandardWorkflow as JaxWorkflow
from veles_tpu_torch import launcher, prng
from veles_tpu_torch.loader.synthetic import SyntheticClassifierLoader
from veles_tpu_torch.parallel.fused import FusedTrainStep
from veles_tpu_torch.parallel.mesh import (DATA_AXIS, Mesh, is_multihost,
                                           mesh_shape)
from veles_tpu_torch.znicz.standard_workflow import StandardWorkflow

REPO = Path(__file__).resolve().parent.parent
SEED, K = 7, 3
RTOL, ATOL = 1e-5, 1e-6
WIRES = ("f32", "bf16", "int8_block", "int8_ef", "hier2")
LOSSY_TOL = {"bf16": 2.0 ** -7, "int8_block": 2.0 ** -5,
             "int8_ef": 2.0 ** -5}
WORLD_TIMEOUT_S = 240
GD = {"learning_rate": 0.05, "gradient_moment": 0.9,
      "weights_decay": 5e-4}
HW = 27
NETS = {
    "alex": dict(
        layers=[
            {"type": "conv_strictrelu", "n_kernels": 8, "kx": 5, "ky": 5,
             "stride": (2, 2), "padding": (0, 0), "weights_stddev": 0.1},
            {"type": "norm", "k": 2.0, "alpha": 1e-4, "beta": 0.75,
             "n": 5},
            {"type": "max_pooling", "ksize": (3, 3), "stride": (2, 2)},
            {"type": "all2all_strictrelu", "output_sample_shape": 24,
             "weights_stddev": 0.05},
            {"type": "dropout", "dropout_ratio": 0.0},
            {"type": "softmax", "output_sample_shape": 10,
             "weights_stddev": 0.1}],
        shape=(HW, HW, 3)),
    "fc": dict(
        layers=[
            {"type": "all2all_tanh", "output_sample_shape": 100,
             "weights_stddev": 0.05},
            {"type": "softmax", "output_sample_shape": 10,
             "weights_stddev": 0.05}],
        shape=(784,)),
}


def _loader_kw(name):
    return dict(n_classes=10, sample_shape=NETS[name]["shape"],
                n_validation=8, n_train=16, minibatch_size=8, noise=0.5)


def _batches(name):
    """K train batches of 8 rows (the last with 2 pad rows) and one
    validation batch, from a seed."""
    rs = np.random.RandomState(100 + len(name))
    shape = NETS[name]["shape"]
    out = []
    for i in range(K + 1):
        x = rs.randn(8, *shape).astype(np.float32)
        y = rs.randint(0, 10, 8).astype(np.int32)
        w = np.ones(8, np.float32)
        if i == K - 1:
            w[-2:] = 0.0
        out.append((x, y, w))
    return out[:K], out[K]


def _gd(adam):
    return dict(GD, optimizer="adam", learning_rate=1e-3) if adam else GD


def _jax_wf(name, adam=False):
    jprng._generators.clear()
    jprng.seed_all(SEED)
    wf = JaxWorkflow(layers=NETS[name]["layers"],
                     loader=JaxLoader(**_loader_kw(name)),
                     loss="softmax", n_classes=10, name=f"DP{name}",
                     gd_config=_gd(adam))
    wf.initialize(device=None)
    return wf


def _jax_reference(name, adam=False):
    """The JAX local step on the global batches: initial params, the
    state after K steps, the losses and n_err, the validation metrics."""
    wf = _jax_wf(name, adam)
    init = tuple({k: np.asarray(a.mem) for k, a in u.param_arrays().items()}
                 for u in wf.forwards)
    step = wf.build_fused_step()
    state = step.init_state()
    train, valid = _batches(name)
    losses, errs = [], []
    for x, y, w in train:
        state, (loss, n_err) = step.train(state, x, y, w)
        losses.append(float(loss))
        errs.append(int(n_err))
    ev = step.evaluate(state, *valid)

    def host(layer):
        if isinstance(layer, dict) and set(layer) == {"m", "v", "t"}:
            return {"m": {k: np.asarray(v) for k, v in layer["m"].items()},
                    "v": {k: np.asarray(v) for k, v in layer["v"].items()}}
        return {k: np.asarray(v) for k, v in layer.items()}
    wf._stop_units()
    return {"init": init,
            "params": tuple(host(p) for p in state["params"]),
            "vel": tuple(host(v) for v in state["vel"]),
            "losses": losses, "errs": errs,
            "eval": (float(ev[0]), int(ev[1]))}


WORKER = r'''
import os, pickle, sys
import numpy as np
import torch
import torch.distributed as dist

rank, world, port, out = (int(sys.argv[1]), int(sys.argv[2]), sys.argv[3],
                          sys.argv[4])
torch.set_num_threads(1)
with open(os.path.join(out, "cfg.pkl"), "rb") as f:
    cfg = pickle.load(f)

from veles_tpu_torch import prng
from veles_tpu_torch.convert import params_from_jax
from veles_tpu_torch.loader.synthetic import SyntheticClassifierLoader
from veles_tpu_torch.ops import variants
from veles_tpu_torch.parallel import checkpoint, distributed
from veles_tpu_torch.parallel import mesh as M
from veles_tpu_torch.snapshotter import Snapshotter
from veles_tpu_torch.znicz.standard_workflow import StandardWorkflow

distributed.initialize_distributed(f"127.0.0.1:{port}", rank, world,
                                   backend="gloo", timeout_s=120)
mesh = M.make_mesh(device="cpu")


def make(name, adam=False, dropout=0.0):
    prng._generators.clear()
    prng.seed_all(cfg["seed"])
    net = cfg["nets"][name]
    layers = [dict(l, dropout_ratio=dropout) if l["type"] == "dropout"
              else l for l in net["layers"]]
    wf = StandardWorkflow(
        layers=layers, loader=SyntheticClassifierLoader(**cfg["loader"][name]),
        loss="softmax", n_classes=10, name="DP" + name,
        gd_config=cfg["gd_adam"] if adam else cfg["gd"])
    wf.initialize("cpu")
    params_from_jax(cfg["init"][(name, adam)], "cpu", wf)
    return wf


def host(step, st):
    st = step.gather_state(st)

    def layer(d):
        if isinstance(d, dict) and set(d) == {"m", "v", "t"}:
            return {"m": {k: t.detach().numpy().copy()
                          for k, t in d["m"].items()},
                    "v": {k: t.detach().numpy().copy()
                          for k, t in d["v"].items()}}
        return {k: t.detach().numpy().copy() for k, t in d.items()}
    return {"params": tuple(layer(p) for p in st["params"]),
            "vel": tuple(layer(v) for v in st["vel"])}


def run(name, m, zs, wire, adam=False, batches=None, wf=None, st=None):
    variants.select("grad_reduce", wire)
    wf = wf or make(name, adam)
    step = wf.build_fused_step(mesh=m, zero_sharding=zs)
    st = st if st is not None else step.init_state()
    losses, errs = [], []
    train, valid = cfg["batches"][name]
    for x, y, w in (batches or train):
        st, (loss, n_err) = step.train(st, x, y, w)
        losses.append(float(loss))
        errs.append(int(n_err))
    ev = step.evaluate(st, *valid)
    out = {"state": host(step, st), "losses": losses, "errs": errs,
           "eval": (float(ev[0]), int(ev[1])),
           "opt_bytes": sum(step.optimizer_state_bytes(st).values()),
           "table": step.variant_table(), "zero": step.zero_active,
           "ef": (float(sum(t.abs().sum() for layer in st["ef"]
                            for t in layer.values()))
                  if "ef" in st else None)}
    return out


res = {}
for name in ("alex", "fc"):
    res[(name, "off", "f32")] = run(name, mesh, "off", "f32")
    for wire in cfg["wires"]:
        res[(name, "on", wire)] = run(name, mesh, "on", wire)
res[("fc", "on", "f32", "adam")] = run("fc", mesh, "on", "f32", adam=True)

# one rank in a group of its own against the port's local step
solo = [dist.new_group([r]) for r in range(world)]
if rank == 0:
    m1 = M.make_mesh(device="cpu", group=solo[0])
    for name in ("alex", "fc"):
        res[("local", name)] = run(name, None, "auto", "f32")
        for zs in ("off", "on"):
            res[("solo", name, zs)] = run(name, m1, zs, "f32")

# the rest of the step's surface under dp, against the port's local step
def surface(m):
    variants.select("grad_reduce", "f32")
    wf = make("fc")
    step = wf.build_fused_step(mesh=m, zero_sharding="on" if m else "auto")
    st = step.init_state()
    (x0, y0, w0), (x1, y1, w1), (x2, y2, w2) = cfg["batches"]["fc"][0]
    st, acc = step.train_accum(st, x0, y0, 2, w0)
    st, rep = step.train_repeat(st, x1, y1, 2, w1)
    st, many = step.train_many(st, np.stack([x2, x0]), np.stack([y2, y0]),
                               np.stack([w2, w0]))
    conf = step.confusion(st, *cfg["batches"]["fc"][1][:2], 10)
    return {"state": host(step, st),
            "metrics": [float(acc[0]), int(acc[1])]
            + [float(v) for v in rep[0]] + [float(v) for v in many[0]],
            "confusion": conf.numpy().copy()}


res["surface"] = surface(mesh)
if rank == 0:
    res["surface_local"] = surface(None)
res["scaling"] = distributed.scaling_efficiency(make("fc"), mesh=mesh,
                                                batch_per_chip=4, warmup=1,
                                                steps=2)

# the ranks' dropout streams: each rank's step, built after a fresh seed
variants.select("grad_reduce", "f32")
wf = make("alex", dropout=0.5)
step = wf.build_fused_step(mesh=mesh)
draw = torch.rand(4096, generator=step.gen).numpy()
draws = [None] * world
dist.all_gather_object(draws, draw)
res["draws"] = draws
wf = make("alex", dropout=0.5)
res["local_draw"] = torch.rand(
    4096, generator=wf.build_fused_step().gen).numpy()
res["dropout_step"] = run("alex", mesh, "auto", "f32",
                          wf=make("alex", dropout=0.5))["losses"]

# a snapshot and a checkpoint across world sizes
snap = os.path.join(cfg["snap_dir"], "dp_snapshot.pickle.gz")
ckpt = os.path.join(cfg["snap_dir"], "ckpt")
train = cfg["batches"]["fc"][0]
if cfg["write_snapshot"]:
    variants.select("grad_reduce", "f32")
    wf = make("fc")
    step = wf.build_fused_step(mesh=mesh, zero_sharding="on")
    st = step.init_state()
    for x, y, w in train[:2]:
        st, _ = step.train(st, x, y, w)
    checkpoint.save_state(st, ckpt, step)
    step.write_back(st)
    if rank == 0:
        path = Snapshotter(wf, prefix="dp", directory=cfg["snap_dir"],
                           compression="gz").export()
        os.replace(path, snap)
else:
    wf = Snapshotter.import_(snap)
    wf.place("cpu")
    res["snap"] = run("fc", mesh, "on", "f32", batches=train[2:], wf=wf)
    wf = make("fc")
    step = wf.build_fused_step(mesh=mesh, zero_sharding="on")
    st = checkpoint.restore_state(step, ckpt)
    res["ckpt"] = run("fc", mesh, "on", "f32", batches=train[2:], wf=wf,
                      st=st)

if rank == 0:
    with open(os.path.join(out, "result.pkl"), "wb") as f:
        pickle.dump(res, f)
distributed.shutdown_distributed()
'''


def _free_port():
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _run_world(n, out: Path, cfg, env_extra=None):
    """Run WORKER in `n` processes of one gloo group; returns rank 0's
    results."""
    out.mkdir(parents=True, exist_ok=True)
    with open(out / "cfg.pkl", "wb") as f:
        pickle.dump(cfg, f)
    worker = out / "worker.py"
    worker.write_text(WORKER)
    port = str(_free_port())
    env = dict(os.environ, PYTHONPATH=str(REPO), OMP_NUM_THREADS="1",
               VELES_AUTOTUNE_CACHE=str(out / "autotune.json"))
    env.update(env_extra or {})
    procs = [subprocess.Popen(
        [sys.executable, str(worker), str(r), str(n), port, str(out)],
        env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
        text=True) for r in range(n)]
    logs = []
    try:
        for p in procs:
            logs.append(p.communicate(timeout=WORLD_TIMEOUT_S)[0])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
    bad = [(r, p.returncode) for r, p in enumerate(procs) if p.returncode]
    assert not bad, f"ranks failed {bad}:\n" + "\n".join(
        log[-3000:] for log in logs)
    with open(out / "result.pkl", "rb") as f:
        return pickle.load(f)


@pytest.fixture(scope="module")
def refs():
    out = {}
    for name in NETS:
        out[(name, False)] = _jax_reference(name)
    out[("fc", True)] = _jax_reference("fc", adam=True)
    return out


@pytest.fixture(scope="module")
def cfg(refs, tmp_path_factory):
    snap_dir = tmp_path_factory.mktemp("dp_snap")
    return {"seed": SEED, "nets": NETS, "gd": GD, "gd_adam": _gd(True),
            "loader": {n: _loader_kw(n) for n in NETS},
            "batches": {n: _batches(n) for n in NETS},
            "init": {k: v["init"] for k, v in refs.items()},
            "wires": WIRES, "snap_dir": str(snap_dir)}


@pytest.fixture(scope="module")
def world2(cfg, tmp_path_factory):
    return _run_world(2, tmp_path_factory.mktemp("world2"),
                      dict(cfg, write_snapshot=True),
                      {"VELES_GRAD_REDUCE_LOCAL": "1"})


@pytest.fixture(scope="module")
def world4(cfg, world2, tmp_path_factory):
    return _run_world(4, tmp_path_factory.mktemp("world4"),
                      dict(cfg, write_snapshot=False),
                      {"VELES_GRAD_REDUCE_LOCAL": "2"})


@pytest.fixture
def worlds(world2, world4):
    return {2: world2, 4: world4}


def _leaves(tree):
    for i, layer in enumerate(tree):
        if set(layer) == {"m", "v"}:
            for slot in ("m", "v"):
                for k, a in layer[slot].items():
                    yield f"{i}/{slot}/{k}", a
        else:
            for k, a in layer.items():
                yield f"{i}/{k}", a


def _assert_state_close(got, ref, rtol=RTOL, atol=ATOL):
    for slot in ("params", "vel"):
        want = dict(_leaves(ref[slot]))
        have = dict(_leaves(got[slot]))
        assert sorted(have) == sorted(want), slot
        for k in want:
            np.testing.assert_allclose(have[k], want[k], rtol=rtol,
                                       atol=atol, err_msg=f"{slot} {k}")


@pytest.mark.parametrize("n", [2, 4])
@pytest.mark.parametrize("name", ["alex", "fc"])
@pytest.mark.parametrize("zero,wire", [("off", "f32"), ("on", "f32"),
                                       ("on", "hier2")])
def test_dp_step_matches_the_jax_local_step(worlds, refs, n, name, zero,
                                            wire):
    got = worlds[n][(name, zero, wire)]
    ref = refs[(name, False)]
    assert got["zero"] == (zero == "on")
    _assert_state_close(got["state"], ref)
    np.testing.assert_allclose(got["losses"], ref["losses"], rtol=RTOL)
    assert got["errs"] == ref["errs"]
    np.testing.assert_allclose(got["eval"][0], ref["eval"][0], rtol=RTOL)
    assert got["eval"][1] == ref["eval"][1]


@pytest.mark.parametrize("n", [2, 4])
@pytest.mark.parametrize("name", ["alex", "fc"])
@pytest.mark.parametrize("wire", ["bf16", "int8_block", "int8_ef"])
def test_lossy_wires_stay_within_their_share_of_the_update(worlds, refs, n,
                                                           name, wire):
    got = worlds[n][(name, "on", wire)]
    ref = refs[(name, False)]
    init = dict(_leaves(ref["init"]))
    want = dict(_leaves(ref["params"]))
    have = dict(_leaves(got["state"]["params"]))
    err = np.sqrt(sum(float(np.sum((have[k] - want[k]) ** 2))
                      for k in want))
    moved = np.sqrt(sum(float(np.sum((want[k] - init[k]) ** 2))
                        for k in want))
    assert err <= LOSSY_TOL[wire] * moved, (err, moved)
    np.testing.assert_allclose(got["losses"], ref["losses"], rtol=1e-3)
    assert got["table"]["grad_reduce"] == wire
    # error feedback carries a residual; the stateless points carry none
    assert (got["ef"] is not None and got["ef"] > 0) == (wire == "int8_ef")


@pytest.mark.parametrize("n", [2, 4])
def test_zero_adam_matches_the_jax_local_step(worlds, refs, n):
    """Adam's moments within the tolerance; its parameters too, with
    tests/test_torch_adam.py's allowance for the Adam sign trap (Adam
    moves an element by ~lr whatever its gradient's size, so a gradient
    at f32 noise, summed in another order, moves it elsewhere): at most
    4 elements beyond it, each within 2·lr·steps."""
    got = worlds[n][("fc", "on", "f32", "adam")]
    ref = refs[("fc", True)]
    want = dict(_leaves(ref["params"]))
    have = dict(_leaves(got["state"]["params"]))
    lr = _gd(True)["learning_rate"]
    trapped = 0
    for k in want:
        off = ~np.isclose(have[k], want[k], rtol=RTOL, atol=ATOL)
        assert np.all(np.abs(have[k] - want[k])[off] <= 2 * lr * K), k
        trapped += int(off.sum())
    assert trapped <= 4, trapped
    _assert_state_close({"params": (), "vel": got["state"]["vel"]},
                        {"params": (), "vel": ref["vel"]})
    np.testing.assert_allclose(got["losses"], ref["losses"], rtol=RTOL)


@pytest.mark.parametrize("name", ["alex", "fc"])
@pytest.mark.parametrize("zero", ["off", "on"])
def test_one_rank_is_the_local_step_bit_for_bit(world2, name, zero):
    local, solo = world2[("local", name)], world2[("solo", name, zero)]
    assert solo["zero"] == (zero == "on") and not local["zero"]
    for slot in ("params", "vel"):
        want = dict(_leaves(local["state"][slot]))
        have = dict(_leaves(solo["state"][slot]))
        for k in want:
            np.testing.assert_array_equal(have[k], want[k], err_msg=k)
    assert solo["losses"] == local["losses"]
    assert solo["eval"] == local["eval"]


@pytest.mark.parametrize("n", [2, 4])
def test_zero_divides_the_optimizer_state(worlds, n):
    for name in ("alex", "fc"):
        off = worlds[n][(name, "off", "f32")]["opt_bytes"]
        on = worlds[n][(name, "on", "f32")]["opt_bytes"]
        # each leaf's slice is ceil(size / n): at most one element of pad
        # per leaf and rank
        n_leaves = len(dict(_leaves(worlds[n][(name, "on", "f32")]
                                    ["state"]["vel"])))
        assert off / n <= on <= off / n + 4 * n_leaves, (name, off, on)


@pytest.mark.parametrize("n", [2, 4])
def test_rank_dropout_streams_are_independent(worlds, world2, n):
    draws = worlds[n]["draws"]
    assert len(draws) == n
    # shard 0 draws the registry's stream, as the local step does
    np.testing.assert_array_equal(draws[0], world2["local_draw"])
    for i in range(n):
        for j in range(i + 1, n):
            assert not np.array_equal(draws[i], draws[j])
            corr = np.corrcoef(draws[i], draws[j])[0, 1]
            assert abs(corr) < 0.1, (i, j, corr)
    assert all(np.isfinite(worlds[n]["dropout_step"]))


@pytest.mark.parametrize("n", [2, 4])
def test_accum_repeat_many_and_confusion_under_dp(worlds, world2, n):
    """train_accum (each microbatch split over the ranks, as the JAX step
    shards it), train_repeat, train_many and confusion under ZeRO give
    the port's local step's numbers (itself held to the JAX step by
    test_torch_accum.py and test_torch_train_repeat.py)."""
    got, want = worlds[n]["surface"], world2["surface_local"]
    _assert_state_close(got["state"], want["state"])
    np.testing.assert_allclose(got["metrics"], want["metrics"], rtol=RTOL)
    np.testing.assert_array_equal(got["confusion"], want["confusion"])


@pytest.mark.parametrize("n", [2, 4])
def test_scaling_efficiency_reports_the_world(worlds, n):
    rec = worlds[n]["scaling"]
    assert rec["chips"] == rec["measured_chips"] == n
    assert not rec["trivial"]
    assert rec["samples_per_sec_per_chip_1"] > 0
    assert rec["samples_per_sec_per_chip_n"] > 0
    assert rec["scaling_efficiency"] == pytest.approx(
        rec["samples_per_sec_per_chip_n"] / rec["samples_per_sec_per_chip_1"])


def test_snapshot_and_checkpoint_restore_at_another_world_size(world4,
                                                               cfg):
    from veles_tpu_torch.parallel import checkpoint
    from veles_tpu_torch.snapshotter import Snapshotter
    snap = os.path.join(cfg["snap_dir"], "dp_snapshot.pickle.gz")
    train = cfg["batches"]["fc"][0]
    wf = Snapshotter.import_(snap, restore_prng=False)
    wf.place("cpu")
    step = wf.build_fused_step()
    st = step.init_state()
    for x, y, w in train[2:]:
        st, _ = step.train(st, x, y, w)

    def host(st):
        return {slot: tuple({k: t.detach().numpy() for k, t in layer.items()}
                            for layer in st[slot])
                for slot in ("params", "vel")}
    want = host(st)
    _assert_state_close(world4["snap"]["state"], want)
    # the checkpoint (the gathered ZeRO state) into a local step
    prng._generators.clear()
    prng.seed_all(SEED)
    wf2 = StandardWorkflow(layers=NETS["fc"]["layers"],
                           loader=SyntheticClassifierLoader(
                               **_loader_kw("fc")),
                           loss="softmax", n_classes=10, name="DPfc",
                           gd_config=GD)
    wf2.initialize("cpu")
    step2 = wf2.build_fused_step()
    st2 = checkpoint.restore_state(step2, os.path.join(cfg["snap_dir"],
                                                       "ckpt"))
    for x, y, w in train[2:]:
        st2, _ = step2.train(st2, x, y, w)
    _assert_state_close(world4["ckpt"]["state"], host(st2))
    _assert_state_close(world4["ckpt"]["state"], want)


def _port_wf(name="fc"):
    prng._generators.clear()
    prng.seed_all(SEED)
    wf = StandardWorkflow(layers=NETS[name]["layers"],
                          loader=SyntheticClassifierLoader(**_loader_kw(name)),
                          loss="softmax", n_classes=10, name="DP" + name,
                          gd_config=GD)
    wf.initialize("cpu")
    return wf


def test_step_local_rows_are_the_rank_block():
    wf = _port_wf()
    for rank in range(4):
        step = FusedTrainStep(wf, mesh=Mesh(mesh_shape(4), rank, "cpu"),
                              zero_sharding="off")
        mask = step.local_rows(8)
        assert mask.tolist() == [rank * 2 <= i < rank * 2 + 2
                                 for i in range(8)]
        # a batch the data axis does not divide: every row (JAX :558)
        assert step.local_rows(6).all()
        with pytest.raises(ValueError, match="not divisible"):
            step._check_batch(6)
    assert FusedTrainStep(wf).local_rows(8).all()


def _row_loaders():
    """A prefetching loader of each package whose row i is (i, i, i),
    label i % 10."""
    from veles_tpu.loader.base import PrefetchingLoader as JaxPrefetching
    from veles_tpu_torch.loader.base import PrefetchingLoader

    def produce(self, idx):
        return (np.repeat(idx[:, None], 3, axis=1).astype(np.float32),
                (idx % 10).astype(np.int32))
    jl = type("JRows", (JaxPrefetching,), {"_produce_batch": produce})(
        minibatch_size=8)
    pl = type("PRows", (PrefetchingLoader,), {"_produce_batch": produce})(
        minibatch_size=8)
    return jl, pl


def test_loader_local_rows_mask_matches_the_jax_loader():
    jl, pl = _row_loaders()
    np.testing.assert_array_equal(pl.local_rows_mask(8),
                                  jl.local_rows_mask(8))
    wf = _port_wf()
    step = FusedTrainStep(wf, mesh=Mesh(mesh_shape(4), 1, "cpu"),
                          zero_sharding="off")
    for ld in (jl, pl):
        ld.local_rows_fn = step.local_rows
    np.testing.assert_array_equal(pl.local_rows_mask(8),
                                  jl.local_rows_mask(8))
    idx = np.arange(8, 16)
    jx, jy = jl._produce(idx)
    px, py = pl._produce(idx)
    np.testing.assert_array_equal(px, jx)
    np.testing.assert_array_equal(py, jy)
    mask = step.local_rows(8)
    assert not px[~mask].any() and (px[mask] == idx[mask, None]).all()
    assert pl.rows_decoded == jl.rows_decoded == 2


def test_modes_outside_this_slice_are_refused():
    wf = _port_wf()
    # a model axis is the gspmd mode (tensor parallelism), ported since
    assert FusedTrainStep(wf, mesh=Mesh(mesh_shape(4, model=2), 0,
                                        "cpu")).mode == "gspmd"
    with pytest.raises(NotImplementedError, match="next many-GPU slice"):
        FusedTrainStep(wf, mesh=Mesh(mesh_shape(4, seq=4), 0, "cpu"))
    with pytest.raises(ValueError, match="requires a mesh"):
        FusedTrainStep(wf, mode="dp")
    with pytest.raises(ValueError, match="zero_sharding"):
        FusedTrainStep(wf, mesh=Mesh(mesh_shape(2), 0, "cpu"),
                       zero_sharding="sometimes")
    step = FusedTrainStep(wf, mesh=Mesh(mesh_shape(2), 1, "cpu"))
    assert step.mode == "dp" and step.zero_active
    assert step.mesh.shape[DATA_AXIS] == 2
    assert not FusedTrainStep(wf, mesh=Mesh(mesh_shape(1), 0, "cpu")) \
        .zero_active
    assert not is_multihost(None)
    assert not is_multihost(Mesh(mesh_shape(2), 0, "cpu"))
    assert is_multihost(Mesh(mesh_shape(2), 0, "cpu", n_hosts=2))
    assert FusedTrainStep(wf, mesh=Mesh(mesh_shape(1), 0, "cpu"),
                          zero_sharding="on").zero_active


def test_hier2_geometry_follows_the_mesh_hosts(monkeypatch):
    """Without an explicit request, hier2's (hosts x local) geometry is
    the mesh's: 4 ranks on the 2 hosts `make_mesh` counted run two
    levels and cross the network, the ZeRO EF slot of the cross leg
    sized to match; $VELES_GRAD_REDUCE_LOCAL still overrides it."""
    from veles_tpu_torch.ops import variants
    monkeypatch.delenv("VELES_GRAD_REDUCE_LOCAL", raising=False)
    monkeypatch.delenv("LOCAL_WORLD_SIZE", raising=False)
    wf = _port_wf()
    with variants.selection_kept():
        variants.select("grad_reduce", "hier2")
        for hosts, want in ((2, (2, 2)), (1, (1, 4)), (4, (4, 1))):
            step = FusedTrainStep(wf, mesh=Mesh(mesh_shape(4), 0, "cpu",
                                                n_hosts=hosts))
            acct = step.collective_accounting()
            assert (acct["geometry"]["hosts"],
                    acct["geometry"]["local"]) == want
            assert (acct["dcn_bytes"] > 0) == (hosts > 1)
        monkeypatch.setenv("VELES_GRAD_REDUCE_LOCAL", "4")
        step = FusedTrainStep(wf, mesh=Mesh(mesh_shape(4), 0, "cpu",
                                            n_hosts=2))
        assert step.collective_accounting()["geometry"] == \
            {"hosts": 1, "local": 4}
        monkeypatch.delenv("VELES_GRAD_REDUCE_LOCAL")
        variants.select("grad_reduce", "int8_ef")
        step = FusedTrainStep(wf, mesh=Mesh(mesh_shape(4), 0, "cpu",
                                            n_hosts=2))
        for plan, lens in zip(step.zero_plans(), step.ef_lens()):
            assert lens == {k: lp.padded for k, lp in plan.items()}


def test_replicated_update_reduces_contiguous_gradients(monkeypatch):
    """NCCL takes contiguous tensors only (gloo takes others): a
    gradient in a channels-last layout, as cuDNN returns a convolution's
    weight gradient, reaches the all-reduce contiguous, and the update
    reads the reduced one."""
    import torch
    import torch.distributed as dist
    wf = _port_wf("alex")
    step = FusedTrainStep(wf, mesh=Mesh(mesh_shape(1), 0, "cpu"),
                          zero_sharding="off")
    seen = []

    def all_reduce(t, group=None):
        if not t.is_contiguous():
            raise ValueError("Tensors must be contiguous")
        seen.append(t)
        t.mul_(2.0)     # a second rank's equal partial

    monkeypatch.setattr(dist, "all_reduce", all_reduce)
    w = torch.randn(8, 3, 5, 5).permute(2, 3, 1, 0)   # non-contiguous
    assert not w.is_contiguous()
    out = step._reduce_grads(({"weights": w, "bias": torch.ones(8)},))
    assert len(seen) == 2 and all(t.is_contiguous() for t in seen)
    assert torch.equal(out[0]["weights"], 2.0 * w)
    assert torch.equal(out[0]["bias"], torch.full((8,), 2.0))


@pytest.mark.parametrize("argv,msg", [
    (["--serve", "0", "-l", "127.0.0.1:1"], "conflict with --serve"),
    (["--fused", "--autotune", "-m", "127.0.0.1:1"], "conflicts with a"),
    (["-l", "127.0.0.1:1", "-m", "127.0.0.1:1"], "give one"),
    (["--supervise", "-l", "127.0.0.1:1"], "supervises one process"),
    (["-l", "127.0.0.1:1", "--process-id", "1", "--n-processes", "2"],
     "is --process-id 0"),
    (["-m", "127.0.0.1:1", "--process-id", "2", "--n-processes", "2"],
     "not a rank"),
])
def test_cli_refuses_what_a_distributed_run_cannot_do(argv, msg, capsys):
    with pytest.raises(SystemExit) as e:
        launcher.parse_args(["wf.py", *argv])
    assert e.value.code == 2
    assert msg in capsys.readouterr().err


def test_cli_zero_sharding_needs_the_fused_step():
    with pytest.raises(SystemExit, match="gates the fused dp update"):
        launcher.parse_args(["wf.py", "--zero-sharding", "on"])
    args = launcher.parse_args(["wf.py", "-m", "127.0.0.1:1",
                                "--process-id", "1", "--n-processes", "2",
                                "--zero-sharding"])
    assert args.fused and args.zero_sharding == "on"


def test_cli_distributed_run_asks_for_the_card(monkeypatch):
    """`-l` without --device cpu asks for a card: with none it is refused
    as every other entry point refuses, before any process group."""
    import torch
    import torch.distributed as dist
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="--device cpu"):
        launcher.train(["veles_tpu_torch/samples/mnist.py", "-l",
                        f"127.0.0.1:{_free_port()}", "--process-id", "0",
                        "--n-processes", "1"])
    assert not dist.is_initialized()


def test_cli_two_processes_train_as_one(tmp_path):
    """`-l`/`-m` in two gloo processes on MNIST's FC: both ranks print the
    fused local run's TRAINED line (its losses within 1e-5)."""
    argv = [sys.executable, "-m", "veles_tpu_torch",
            "veles_tpu_torch/samples/mnist.py", "--device", "cpu", "-r",
            "3", "root.mnist.decision.max_epochs=1",
            "root.mnist.loader.n_train=200",
            "root.mnist.loader.n_validation=100"]
    env = dict(os.environ, PYTHONPATH=str(REPO), OMP_NUM_THREADS="1",
               VELES_AUTOTUNE_CACHE=str(tmp_path / "at.json"))
    addr = f"127.0.0.1:{_free_port()}"
    procs = [subprocess.Popen(
        argv + (["-l", addr] if r == 0 else ["-m", addr])
        + ["--process-id", str(r), "--n-processes", "2"],
        cwd=REPO, env=env, stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True) for r in range(2)]
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(timeout=WORLD_TIMEOUT_S)[0])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
    local = subprocess.run(argv + ["--fused"], cwd=REPO, env=env,
                           capture_output=True, text=True,
                           timeout=WORLD_TIMEOUT_S)
    assert local.returncode == 0, local.stderr[-2000:]

    def trained(text):
        line = [ln for ln in text.splitlines()
                if ln.startswith("TRAINED")][-1]
        head, hist = line.split(" history ")
        return float(head.split("loss ")[1].split()[0]), hist
    want_loss, want_hist = trained(local.stdout)
    for p, out in zip(procs, outs):
        assert p.returncode == 0, out[-2000:]
        loss, hist = trained(out)
        assert hist == want_hist
        np.testing.assert_allclose(loss, want_loss, rtol=1e-5)
