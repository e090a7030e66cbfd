"""Expert parallelism on the CPU: the port's dp step with `ep=True` in
gloo process groups of 2 and 4 ranks, held against the JAX package.

Each world is one set of processes per module (`python WORKER RANK
WORLD PORT DIR`, as tests/test_torch_dp.py spawns them), running every
scenario in turn:

- the ep step on two MoE workflows against the JAX LOCAL dense step on
  the global batches (as JAX `test_moe_ep_trains_matches_dense` and
  `test_transformer_moe_block_trains`): the MoE classifier (12 -> MoE(4
  experts, hidden 16) -> softmax 4, 6 steps of 32 rows) and the
  attention + residual token-MoE block (4 steps of 32 samples of (4,
  8)), both at capacity factor 4 = the expert count, so that no token
  drops in either form; both packages start from the JAX workflow's
  seeded parameters. Losses rtol 1e-5; the gathered parameters and
  velocities rtol 1e-5, atol 1e-6 (the classifier; the ranks' partial
  sums and XLA's single sum differ in order only) and rtol 1e-4, atol
  1e-6 (the block: the attention's products too);
- the expert leaves really split: w1 (E/R, D, H) on each rank, the
  router whole; `optimizer_state_bytes` below the local step's;
  `collective_accounting` four exchanges a step;
- `moe_forward_ep` (each rank its N/R tokens and E/R experts) against
  the JAX `moe_forward_ep` under shard_map on R virtual devices at a
  binding capacity, rtol 1e-5, atol 1e-6;
- the refusals: ep outside dp, no unit with `ep_params`, an expert count
  the ranks do not divide (the JAX messages);
- `write_back` gives the units the full experts; a checkpoint saved at 2
  ranks restores at 4 (`parallel/checkpoint.py`: gathered before the
  save, sharded on restore) to the saved values;
- the CLI `-l/-m --ep` trains the MoE sample one epoch in the world.
"""

import os
import pickle
import socket
import subprocess
import sys
from pathlib import Path

import jax
import numpy as np
import pytest
from jax.sharding import Mesh
from jax.sharding import PartitionSpec as P

from veles_tpu import prng as jprng
from veles_tpu._compat import shard_map
from veles_tpu.loader.synthetic import \
    SyntheticClassifierLoader as JaxLoader
from veles_tpu.ops import moe as jmoe
from veles_tpu.znicz import moe as _jmoe  # noqa: F401 (registers "moe")
from veles_tpu.znicz.standard_workflow import \
    StandardWorkflow as JaxWorkflow

REPO = Path(__file__).resolve().parent.parent
SEED = 1234
RTOL, ATOL = 1e-5, 1e-6
BLOCK_RTOL = 1e-4
WORLD_TIMEOUT_S = 240
GD = {"learning_rate": 0.1, "gradient_moment": 0.9}
NETS = {
    "fc": dict(
        layers=[{"type": "moe", "n_experts": 4, "hidden": 16,
                 "capacity_factor": 4.0, "weights_stddev": 0.2},
                {"type": "softmax", "output_sample_shape": 4,
                 "weights_stddev": 0.05}],
        shape=(12,), steps=6, gd=GD),
    "block": dict(
        layers=[{"type": "attention", "n_heads": 2, "residual": True,
                 "weights_stddev": 0.15},
                {"type": "moe", "n_experts": 4, "hidden": 16,
                 "capacity_factor": 4.0, "residual": True,
                 "weights_stddev": 0.15},
                {"type": "softmax", "output_sample_shape": 4,
                 "weights_stddev": 0.05}],
        shape=(4, 8), steps=4, gd={"learning_rate": 0.05,
                                   "gradient_moment": 0.9}),
}
#: moe_forward_ep's case: N tokens of D, E experts of H, a binding
#: capacity per source rank
EPF = dict(n=32, d=8, e=4, h=16, capacity=2)


def _loader_kw(name):
    return dict(n_classes=4, sample_shape=NETS[name]["shape"],
                n_validation=32, n_train=128, minibatch_size=32, noise=0.3)


def _batches(name):
    rs = np.random.RandomState(7 + len(name))
    shape = NETS[name]["shape"]
    return [(rs.randn(32, *shape).astype(np.float32),
             rs.randint(0, 4, 32).astype(np.int32))
            for _ in range(NETS[name]["steps"])]


def _jax_reference(name):
    """The JAX local dense step on the global batches: the initial
    parameters, the losses, and the parameters and velocities after."""
    jprng._generators.clear()
    jprng.seed_all(SEED)
    net = NETS[name]
    wf = JaxWorkflow(layers=net["layers"], loader=JaxLoader(**_loader_kw(name)),
                     loss="softmax", n_classes=4, name=f"EP{name}",
                     gd_config=net["gd"])
    wf.initialize(device=None)
    init = tuple({k: np.asarray(a.mem) for k, a in u.param_arrays().items()}
                 for u in wf.forwards)
    step = wf.build_fused_step()
    state = step.init_state()
    losses = []
    for x, y in _batches(name):
        state, (loss, _) = step.train(state, x, y)
        losses.append(float(loss))
    wf._stop_units()
    return {"init": init, "losses": losses,
            "params": tuple({k: np.asarray(v) for k, v in p.items()}
                            for p in state["params"]),
            "vel": tuple({k: np.asarray(v) for k, v in p.items()}
                         for p in state["vel"])}


def _epf_arrays():
    rs = np.random.RandomState(3)
    c = EPF
    return (rs.randn(c["n"], c["d"]).astype(np.float32),
            (rs.randn(c["d"], c["e"]) * 0.3).astype(np.float32),
            (rs.randn(c["e"], c["d"], c["h"]) * 0.3).astype(np.float32),
            (rs.randn(c["e"], c["h"]) * 0.1).astype(np.float32),
            (rs.randn(c["e"], c["h"], c["d"]) * 0.3).astype(np.float32),
            (rs.randn(c["e"], c["d"]) * 0.1).astype(np.float32))


def _jax_forward_ep(devices):
    """JAX moe_forward_ep under shard_map over `devices` at the binding
    capacity."""
    mesh = Mesh(np.asarray(devices), ("expert",))
    f = jax.jit(shard_map(
        lambda x_, wr_, w1_, b1_, w2_, b2_: jmoe.moe_forward_ep(
            x_, wr_, w1_, b1_, w2_, b2_, "expert",
            capacity=EPF["capacity"]),
        mesh=mesh,
        in_specs=(P("expert"), P(), P("expert"), P("expert"),
                  P("expert"), P("expert")),
        out_specs=P("expert")))
    return np.asarray(f(*_epf_arrays()))


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

from veles_tpu_torch import launcher, prng
from veles_tpu_torch.convert import params_from_jax
from veles_tpu_torch.loader.synthetic import SyntheticClassifierLoader
from veles_tpu_torch.ops import moe as om
from veles_tpu_torch.parallel import checkpoint, distributed
from veles_tpu_torch.parallel import mesh as M
from veles_tpu_torch.znicz.standard_workflow import StandardWorkflow

distributed.initialize_distributed(f"127.0.0.1:{port}", rank, world,
                                   backend="gloo", timeout_s=120)
mesh = M.make_mesh(device="cpu")


def make(name, layers=None):
    prng._generators.clear()
    prng.seed_all(cfg["seed"])
    net = cfg["nets"][name]
    wf = StandardWorkflow(
        layers=layers or net["layers"],
        loader=SyntheticClassifierLoader(**cfg["loader"][name]),
        loss="softmax", n_classes=4, name="EP" + name, gd_config=net["gd"])
    wf.initialize("cpu")
    return wf


def host(layers):
    return tuple({k: t.detach().numpy().copy() for k, t in l.items()}
                 for l in layers)


res = {}
for name in cfg["nets"]:
    wf = make(name)
    params_from_jax(cfg["init"][name], "cpu", workflow=wf)
    ep = wf.build_fused_step(mesh=mesh, ep=True)
    local = wf.build_fused_step()
    state = ep.init_state()
    moe_i = [i for i, u in enumerate(wf.forwards)
             if getattr(u, "ep_params", ())][0]
    losses = []
    for x, y in cfg["batches"][name]:
        state, (loss, _) = ep.train(state, x, y)
        losses.append(float(loss))
    full = ep.gather_state(state)
    r = {"losses": losses, "params": host(full["params"]),
         "vel": host(full["vel"]),
         "w1_local": tuple(state["params"][moe_i]["w1"].shape),
         "wr_local": tuple(state["params"][moe_i]["wr"].shape),
         "opt_bytes": ep.optimizer_state_bytes(state),
         "local_opt_bytes": local.optimizer_state_bytes(local.init_state()),
         "acct": ep.collective_accounting(), "zero": ep.zero_reason}
    ep.write_back(state)
    r["written_w1"] = wf.forwards[moe_i].w1.detach().numpy().copy()
    if name == "fc":
        if world == 2:
            checkpoint.save_state(state, cfg["ckpt"], step=ep)
        dist.barrier()
        if world == 4:
            back = ep.gather_state(checkpoint.restore_state(ep, cfg["ckpt"]))
            r["restored"] = {"params": host(back["params"]),
                             "vel": host(back["vel"]),
                             "w1_local": tuple(checkpoint.restore_state(
                                 ep, cfg["ckpt"])["params"][moe_i]["w1"]
                                 .shape)}
    res[name] = r

# moe_forward_ep: this rank's tokens and experts
x, wr, w1, b1, w2, b2 = (torch.from_numpy(a) for a in cfg["epf"])
n, e = x.shape[0] // world, w1.shape[0] // world
sl = slice(rank * n, (rank + 1) * n)
se = slice(rank * e, (rank + 1) * e)
y = om.moe_forward_ep(x[sl], wr, w1[se], b1[se], w2[se], b2[se],
                      capacity=cfg["epf_capacity"])
ys = [None] * world
dist.all_gather_object(ys, y.numpy())
res["epf"] = np.concatenate(ys)

# the refusals (no collective runs before they raise)
errs = {}
for what, build in (
        ("local", lambda: make("fc").build_fused_step(ep=True)),
        ("no_ep_params", lambda: make("fc", [
            {"type": "all2all_tanh", "output_sample_shape": 8},
            {"type": "softmax", "output_sample_shape": 4}]).build_fused_step(
                mesh=mesh, ep=True)),
        ("indivisible", lambda: make("fc", [
            dict(cfg["nets"]["fc"]["layers"][0], n_experts=world + 1),
            cfg["nets"]["fc"]["layers"][1]]).build_fused_step(
                mesh=mesh, ep=True))):
    try:
        build()
        errs[what] = None
    except ValueError as e:
        errs[what] = str(e)
res["refusals"] = errs

if rank == 0:
    with open(os.path.join(out, "result.pkl"), "wb") as f:
        pickle.dump(res, f)
dist.barrier()

# last: the CLI leaves the process group when it ends
sample = os.path.join(cfg["repo"], "veles_tpu_torch", "samples", "moe.py")
flag = ["-l"] if rank == 0 else ["-m"]
wf = launcher.train([sample, "--device", "cpu", "-r", "5", *flag,
                     f"127.0.0.1:{port}", "--process-id", str(rank),
                     "--n-processes", str(world), "--ep",
                     "root.moe.loader.n_train=256",
                     "root.moe.loader.n_validation=64",
                     "root.moe.decision.max_epochs=1"])
if rank == 0:
    with open(os.path.join(out, "cli.pkl"), "wb") as f:
        pickle.dump({"history": wf.decision.history,
                     "w1": tuple(wf.forwards[1].w1.shape)}, f)
'''


def _free_port():
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _run_world(n, out: Path, cfg):
    """Run WORKER in `n` processes of one gloo group; returns rank 0's
    results and its CLI record."""
    out.mkdir(parents=True, exist_ok=True)
    with open(out / "cfg.pkl", "wb") as f:
        pickle.dump(cfg, f)
    worker = out / "worker.py"
    worker.write_text(WORKER)
    port = str(_free_port())
    env = dict(os.environ, PYTHONPATH=str(REPO), OMP_NUM_THREADS="1",
               VELES_AUTOTUNE_CACHE=str(out / "autotune.json"))
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
        res = pickle.load(f)
    with open(out / "cli.pkl", "rb") as f:
        res["cli"] = pickle.load(f)
    return res


@pytest.fixture(scope="module")
def refs():
    return {name: _jax_reference(name) for name in NETS}


@pytest.fixture(scope="module")
def cfg(refs, tmp_path_factory):
    return {"seed": SEED, "nets": NETS, "repo": str(REPO),
            "loader": {n: _loader_kw(n) for n in NETS},
            "batches": {n: _batches(n) for n in NETS},
            "init": {n: refs[n]["init"] for n in NETS},
            "epf": _epf_arrays(), "epf_capacity": EPF["capacity"],
            "ckpt": str(tmp_path_factory.mktemp("ep_ckpt"))}


@pytest.fixture(scope="module")
def world2(cfg, tmp_path_factory):
    return _run_world(2, tmp_path_factory.mktemp("world2"), cfg)


@pytest.fixture(scope="module")
def world4(cfg, world2, tmp_path_factory):
    # after world2: it restores world2's checkpoint
    return _run_world(4, tmp_path_factory.mktemp("world4"), cfg)


@pytest.fixture(scope="module")
def worlds(world2, world4):
    return {2: world2, 4: world4}


def _assert_close(got, want, rtol, atol, what):
    for i, (g, w) in enumerate(zip(got, want)):
        assert set(g) == set(w), (what, i)
        for k in w:
            np.testing.assert_allclose(g[k], w[k], rtol=rtol, atol=atol,
                                       err_msg=f"{what} unit {i} {k}")


@pytest.mark.parametrize("n", [2, 4])
@pytest.mark.parametrize("name", sorted(NETS))
def test_ep_step_matches_the_jax_dense_local_step(worlds, refs, n, name):
    got, ref = worlds[n][name], refs[name]
    np.testing.assert_allclose(got["losses"], ref["losses"], rtol=RTOL)
    rtol = RTOL if name == "fc" else BLOCK_RTOL
    _assert_close(got["params"], ref["params"], rtol, ATOL, "params")
    _assert_close(got["vel"], ref["vel"], rtol, ATOL, "velocities")


@pytest.mark.parametrize("n", [2, 4])
@pytest.mark.parametrize("name", sorted(NETS))
def test_expert_leaves_split_over_the_ranks(worlds, n, name):
    got = worlds[n][name]
    assert got["w1_local"] == (4 // n, NETS[name]["shape"][-1], 16)
    assert got["wr_local"] == (NETS[name]["shape"][-1], 4)
    opt = sum(got["opt_bytes"].values())
    assert opt < sum(got["local_opt_bytes"].values())
    acct = got["acct"]
    assert acct["op"] == "moe_all_to_all" and acct["exchanges"] == 4
    assert acct["n_shards"] == n and acct["egress_bytes"] > 0
    assert "ep=True already shards" in got["zero"]
    np.testing.assert_array_equal(got["written_w1"], got["params"][
        [i for i, p in enumerate(got["params"]) if "w1" in p][0]]["w1"])


@pytest.mark.parametrize("n", [2, 4])
def test_moe_forward_ep_matches_jax_at_a_binding_capacity(worlds,
                                                           eight_devices, n):
    want = _jax_forward_ep(eight_devices[:n])
    dense = np.asarray(jmoe.moe_forward(*_epf_arrays(),
                                        capacity=EPF["capacity"] * n))
    assert not np.allclose(want, dense)     # the capacity binds per rank
    np.testing.assert_allclose(worlds[n]["epf"], want, rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("n", [2, 4])
def test_ep_refusals(worlds, n):
    errs = worlds[n]["refusals"]
    assert "ep=True needs the explicit shard_map 'dp' mode" in errs["local"]
    assert "no forward unit declares ep_params" in errs["no_ep_params"]
    assert f"{n + 1} experts not divisible by the data axis ({n})" \
        in errs["indivisible"]


def test_checkpoint_saved_at_2_ranks_restores_at_4(world2, world4):
    saved, back = world2["fc"], world4["fc"]["restored"]
    assert back["w1_local"] == (1, 12, 16)
    for a, b in ((saved["params"], back["params"]),
                 (saved["vel"], back["vel"])):
        for la, lb in zip(a, b):
            for k in la:
                np.testing.assert_array_equal(la[k], lb[k], err_msg=k)


@pytest.mark.parametrize("n", [2, 4])
def test_the_cli_trains_expert_parallel(worlds, n):
    cli = worlds[n]["cli"]
    assert cli["w1"] == (8, 64, 128)        # written back whole
    assert len(cli["history"]) == 1
    assert 0 <= cli["history"][0]["valid_err"] <= 64
