"""The port's tensor-parallel fused step (mode "gspmd", parallel/tp.py) on
the CPU: gloo process groups of 2 ranks (data 1 x model 2) and 4 ranks
(data 2 x model 2, then data 1 x model 4), held against the JAX package's
gspmd `FusedTrainStep` on the same mesh shape (an 8-device virtual CPU,
tests/conftest.py) and against its local step.

Nets: the JAX gspmd test's FC net (8x8 -> tanh 32 -> softmax 10,
tests/test_parallel_fused.py), a narrow AlexNet (`alexnet_layers(10,
1/16, 64)` on 67x67x3, dropout 0: conv1's 6 kernels do not divide at
model 4), a small conv net whose FC layer flattens a channel-sharded 5x5
pool output (a row-parallel FC over a flatten, the rank's JAX row block
no channel slice), the other units without parameters on a
channel-sharded activation (stochastic, average and max-abs pooling, an
activation, dropout 0.5; against the port's local step, whose draws
they share), and MNIST's FC (784 -> tanh 100 -> softmax 10) for the
plan. Every run starts from the JAX workflow's seeded parameters
(`convert.params_from_jax`) and trains 3 steps of 8 rows, the third with
two pad rows, then evaluates a validation batch.

Tolerances: f32 rtol 1e-5, atol 1e-6 per leaf on the parameters and
velocities, the losses rtol 1e-5, n_err equal (the ranks' partial sums
and XLA's single sum differ in order only). bf16: the update within 2^-7
of its norm (8 mantissa bits), as tests/test_torch_bf16.py holds the
local bf16 step; the losses within 1e-3 relative, as test_torch_dp.py
holds its bf16 wire.

Each world is one set of processes (`python WORKER RANK WORLD PORT DIR`,
a free port, OMP_NUM_THREADS=1, a time limit) running every scenario in
turn, started before the JAX references are computed so that both run at
once.
"""

import contextlib
import os
import pickle
import socket
import subprocess
import sys
from pathlib import Path

import jax
import numpy as np
import pytest

from veles_tpu import prng as jprng
from veles_tpu.loader.synthetic import \
    SyntheticClassifierLoader as JaxLoader
from veles_tpu.parallel import make_mesh as jax_make_mesh
from veles_tpu.samples.alexnet import alexnet_layers as jax_alexnet_layers
from veles_tpu.znicz.standard_workflow import \
    StandardWorkflow as JaxWorkflow
from veles_tpu_torch import launcher, prng
from veles_tpu_torch.convert import params_from_jax, state_from_jax
from veles_tpu_torch.loader.synthetic import SyntheticClassifierLoader
from veles_tpu_torch.ops import variants
from veles_tpu_torch.parallel.fused import FusedTrainStep
from veles_tpu_torch.parallel.mesh import MODEL_AXIS, Mesh, mesh_shape
from veles_tpu_torch.parallel.tp import leaf_part
from veles_tpu_torch.znicz.standard_workflow import StandardWorkflow

REPO = Path(__file__).resolve().parent.parent
SEED, K = 7, 3
RTOL, ATOL = 1e-5, 1e-6
BF16_TOL = 2.0 ** -7
WORLD_TIMEOUT_S = 240
GD = {"learning_rate": 0.05, "gradient_moment": 0.9,
      "weights_decay": 5e-4}
ADAM = dict(GD, optimizer="adam", learning_rate=1e-3)
STEM_EPI = "gen[pack=s2d,acc=native,epi=lrn]"
#: (data, model) meshes of each world
MESHES = {2: ((1, 2),), 4: ((2, 2), (1, 4))}
NETS = {
    "fc": dict(layers=[
        {"type": "all2all_tanh", "output_sample_shape": 32,
         "weights_stddev": 0.05},
        {"type": "softmax", "output_sample_shape": 10,
         "weights_stddev": 0.05}], shape=(8, 8)),
    "alex": dict(layers=[
        dict(layer, dropout_ratio=0.0) if layer["type"] == "dropout"
        else layer for layer in jax_alexnet_layers(10, 1 / 16, 64)],
        shape=(67, 67, 3)),
    "conv": dict(layers=[
        {"type": "conv_strictrelu", "n_kernels": 8, "kx": 5, "ky": 5,
         "stride": (2, 2), "padding": (0, 0), "weights_stddev": 0.1},
        {"type": "norm", "k": 2.0, "alpha": 1e-4, "beta": 0.75, "n": 5},
        {"type": "max_pooling", "ksize": (3, 3), "stride": (2, 2)},
        {"type": "all2all_strictrelu", "output_sample_shape": 24,
         "weights_stddev": 0.05},
        {"type": "dropout", "dropout_ratio": 0.0},
        {"type": "softmax", "output_sample_shape": 10,
         "weights_stddev": 0.1}], shape=(27, 27, 3)),
    "flavors": dict(layers=[
        {"type": "conv_strictrelu", "n_kernels": 8, "kx": 3, "ky": 3,
         "weights_stddev": 0.2},
        {"type": "stochastic_pooling", "ksize": (2, 2)},
        {"type": "activation_tanh"},
        {"type": "avg_pooling", "ksize": (2, 2)},
        {"type": "maxabs_pooling", "ksize": (2, 2), "stride": (1, 1)},
        {"type": "dropout", "dropout_ratio": 0.0},
        {"type": "all2all_tanh", "output_sample_shape": 16,
         "weights_stddev": 0.1},
        {"type": "softmax", "output_sample_shape": 10,
         "weights_stddev": 0.1}], shape=(14, 14, 3)),
    "mnist": dict(layers=[
        {"type": "all2all_tanh", "output_sample_shape": 100,
         "weights_stddev": 0.05},
        {"type": "softmax", "output_sample_shape": 10,
         "weights_stddev": 0.05}], shape=(784,)),
}


def _loader_kw(name):
    return dict(n_classes=10, sample_shape=NETS[name]["shape"],
                n_validation=8, n_train=16, minibatch_size=8, noise=0.5)


def _batches(name):
    """K train batches of 8 rows (the last with 2 pad rows) and one
    validation batch, from a seed."""
    rs = np.random.RandomState(200 + len(name))
    out = []
    for i in range(K + 1):
        x = rs.randn(8, *NETS[name]["shape"]).astype(np.float32)
        y = rs.randint(0, 10, 8).astype(np.int32)
        w = np.ones(8, np.float32)
        if i == K - 1:
            w[-2:] = 0.0
        out.append((x, y, w))
    return out[:K], out[K]


def _layers(name, dropout=0.0):
    return [dict(layer, dropout_ratio=dropout) if layer["type"] == "dropout"
            else layer for layer in NETS[name]["layers"]]


def _jax_wf(name, adam=False):
    jprng._generators.clear()
    jprng.seed_all(SEED)
    wf = JaxWorkflow(layers=_layers(name),
                     loader=JaxLoader(**_loader_kw(name)),
                     loss="softmax", n_classes=10, name=f"TP{name}",
                     gd_config=ADAM if adam else GD)
    wf.initialize(device=None)
    return wf


def _host(layer):
    if isinstance(layer, dict) and set(layer) == {"m", "v", "t"}:
        return {"m": _host(layer["m"]), "v": _host(layer["v"])}
    return {k: np.asarray(v) for k, v in layer.items()}


def _jax_run(name, mesh=None, compute_dtype=None):
    """The JAX step (local, or gspmd over the first d*m virtual devices
    as data d x model m) on the batches: the state after K steps, the
    losses and n_err, the validation metrics, and per leaf the shapes of
    its shards by device (= rank)."""
    wf = _jax_wf(name)
    if mesh is None:
        step = wf.build_fused_step(compute_dtype=compute_dtype)
    else:
        d, m = mesh
        step = wf.build_fused_step(
            mesh=jax_make_mesh(jax.devices()[:d * m], model=m, data=d),
            mode="gspmd", compute_dtype=compute_dtype)
    state = step.init_state()
    train, valid = _batches(name)
    losses, errs = [], []
    for x, y, w in train:
        state, (loss, n_err) = step.train(state, x, y, w)
        losses.append(float(loss))
        errs.append(int(n_err))
    ev = step.evaluate(state, *valid)
    shards = {}
    if mesh is not None:
        for slot in ("params", "vel"):
            for i, layer in enumerate(state[slot]):
                for k, a in layer.items():
                    shards[f"{slot}/{i}/{k}"] = {
                        s.device.id: tuple(s.data.shape)
                        for s in a.addressable_shards}
    out = {"params": tuple(_host(p) for p in state["params"]),
           "vel": tuple(_host(v) for v in state["vel"]),
           "losses": losses, "errs": errs,
           "eval": (float(ev[0]), int(ev[1])), "shards": shards,
           "state": state if mesh is not None and mesh[0] == 1 else None}
    wf._stop_units()
    return out


WORKER = r'''
import contextlib, os, pickle, sys
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


def make(name, adam=False, dropout=0.0):
    prng._generators.clear()
    prng.seed_all(cfg["seed"])
    layers = [dict(l, dropout_ratio=dropout) if l["type"] == "dropout"
              else l for l in cfg["nets"][name]["layers"]]
    wf = StandardWorkflow(
        layers=layers, loader=SyntheticClassifierLoader(**cfg["loader"][name]),
        loss="softmax", n_classes=10, name="TP" + name,
        gd_config=cfg["adam"] if adam else cfg["gd"])
    wf.initialize("cpu")
    params_from_jax(cfg["init"][(name, adam)], "cpu", wf)
    return wf


def host(step, st):
    st = step.gather_state(st)

    def layer(d):
        if isinstance(d, dict) and set(d) == {"m", "v", "t"}:
            return {"m": layer(d["m"]), "v": layer(d["v"])}
        return {k: t.detach().float().numpy().copy() for k, t in d.items()}
    return {"params": tuple(layer(p) for p in st["params"]),
            "vel": tuple(layer(v) for v in st["vel"])}


def flat(layer, prefix):
    if set(layer) == {"m", "v", "t"}:
        for sub in ("m", "v"):
            yield from flat(layer[sub], f"{prefix}/{sub}")
    else:
        for k, t in layer.items():
            yield f"{prefix}/{k}", tuple(t.shape)


def shapes(st):
    out = {}
    for slot in ("params", "vel"):
        for i, layer in enumerate(st[slot]):
            out.update(flat(layer, f"{slot}/{i}"))
    every = [None] * world
    dist.all_gather_object(every, out)
    return every


def run(name, mesh, adam=False, dropout=0.0, dtype=None, batches=None,
        wf=None, st=None):
    wf = wf or make(name, adam, dropout)
    step = wf.build_fused_step(mesh=mesh, mode="gspmd", compute_dtype=dtype)
    st = st if st is not None else step.init_state()
    losses, errs = [], []
    train, valid = cfg["batches"][name]
    for x, y, w in (batches or train):
        st, (loss, n_err) = step.train(st, x, y, w)
        losses.append(float(loss))
        errs.append(int(n_err))
    ev = step.evaluate(st, *valid)
    plan, flags = step._tp_plan()
    opt = [None] * world
    dist.all_gather_object(opt, sum(step.optimizer_state_bytes(st).values()))
    return {"state": host(step, st), "losses": losses, "errs": errs,
            "eval": (float(ev[0]), int(ev[1])), "shapes": shapes(st),
            "plan": plan, "flags": flags, "roles": step.fwd.tp.roles,
            "opt_bytes": opt, "table": step.variant_table(),
            "zero": (step.zero_active, step.zero_reason)}


def surface(mesh):
    wf = make("fc")
    step = wf.build_fused_step(mesh=mesh, mode="gspmd")
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


def toy_transformer(mesh):
    """The toy char-transformer, 2 steps in gspmd at model 2 and in the
    local step from one seed: the largest parameter difference."""
    from veles_tpu_torch.config import root
    from veles_tpu_torch.samples import char_transformer as ct
    steps = []
    for kw in ({"mesh": mesh, "mode": "gspmd"}, {}):
        saved = root.char_transformer.to_dict()
        try:
            for k, v in cfg["ct_toy"].items():
                root.char_transformer.override(k, v)
            prng._generators.clear()
            prng.seed_all(cfg["seed"])
            wf = ct.create_workflow()
        finally:
            root.char_transformer.update(saved)
        wf.initialize("cpu")
        step = wf.build_fused_step(**kw)
        st = step.init_state()
        for x, y in cfg["ct_batches"]:
            st, _ = step.train(st, x, y)
        steps.append((step, step.gather_state(st)))
    (tp, got), (_, want) = steps
    err = max(float((a - b).abs().max())
              for la, lb in zip(got["params"], want["params"])
              for a, b in zip(la.values(), lb.values()))
    return {"roles": tp.fwd.tp.roles, "err": err}


snap = os.path.join(cfg["snap_dir"], "tp_snapshot.pickle")
ckpt = os.path.join(cfg["snap_dir"], "ckpt")
train = cfg["batches"]["fc"][0]
res = {}
for d, m in cfg["meshes"]:
    mesh = M.make_mesh(model=m, device="cpu")
    key = (d, m)
    if cfg["restore"] and m == 2:
        # a checkpoint and a snapshot written at model 2 after 2 steps
        wf = make("fc")
        step = wf.build_fused_step(mesh=mesh, mode="gspmd")
        st = step.init_state()
        for x, y, w in train[:2]:
            st, _ = step.train(st, x, y, w)
        checkpoint.save_state(st, ckpt, step)
        step.write_back(st)
        res["written_back"] = {
            i: {k: t.detach().numpy().copy()
                for k, t in u.param_arrays().items()}
            for i, u in enumerate(wf.forwards)}
        if rank == 0:
            path = Snapshotter(wf, prefix="tp", directory=cfg["snap_dir"],
                               compression="").export()
            os.replace(path, snap)
        dist.barrier()
        res["ckpt_files"] = sorted(os.listdir(ckpt))
    elif cfg["restore"]:
        # ... restored at model 4, step 3 taken
        wf = Snapshotter.import_(snap)
        wf.place("cpu")
        res["snap"] = run("fc", mesh, batches=train[2:], wf=wf)
        wf = make("fc")
        step = wf.build_fused_step(mesh=mesh, mode="gspmd")
        st = checkpoint.restore_state(step, ckpt)
        res["ckpt"] = run("fc", mesh, batches=train[2:], wf=wf, st=st)
    for name in ("fc", "alex", "conv"):
        res[key, name] = run(name, mesh)
    res[key, "flavors"] = run("flavors", mesh, dropout=0.5)
    res[key, "alex", "bf16"] = run("alex", mesh, dtype="bfloat16")
    res[key, "alex", "dropout"] = run("alex", mesh, dropout=0.5)
    with variants.selection_kept():
        variants.select("lrn_maxpool", "composed")
        res[key, "alex", "composed"] = run("alex", mesh)
    with variants.selection_kept():
        variants.select("conv_stem", cfg["stem_epi"])
        res[key, "alex", "stem_epi"] = run("alex", mesh)
    res[key, "fc", "adam"] = run("fc", mesh, adam=True)
    res[key, "surface"] = surface(mesh)
    # the ranks' dropout streams: every rank draws the registry's
    step = make("alex", dropout=0.5).build_fused_step(mesh=mesh,
                                                      mode="gspmd")
    draws = [None] * world
    dist.all_gather_object(draws, torch.rand(64, generator=step.gen).numpy())
    res[key, "draws"] = draws
    res[key, "mesh"] = (mesh.data_index, mesh.model_index)
    if m == 2 and d == 1:
        res[key, "ct"] = toy_transformer(mesh)

if rank == 0:
    with open(os.path.join(out, "result.pkl"), "wb") as f:
        pickle.dump(res, f)
distributed.shutdown_distributed()
'''


def _free_port():
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _start_world(n, out: Path, cfg):
    """Start WORKER in `n` processes of one gloo group."""
    out.mkdir(parents=True, exist_ok=True)
    with open(out / "cfg.pkl", "wb") as f:
        pickle.dump(cfg, f)
    worker = out / "worker.py"
    worker.write_text(WORKER)
    port = str(_free_port())
    env = dict(os.environ, PYTHONPATH=str(REPO), OMP_NUM_THREADS="1",
               VELES_AUTOTUNE_CACHE=str(out / "autotune.json"))
    return [subprocess.Popen(
        [sys.executable, str(worker), str(r), str(n), port, str(out)],
        env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
        text=True) for r in range(n)]


def _finish_world(procs, out: Path):
    """Wait for a world's ranks; returns rank 0's results."""
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


def _port_wf(name, adam=False, dropout=0.0, init=None):
    prng._generators.clear()
    prng.seed_all(SEED)
    wf = StandardWorkflow(layers=_layers(name, dropout),
                          loader=SyntheticClassifierLoader(**_loader_kw(name)),
                          loss="softmax", n_classes=10, name="TP" + name,
                          gd_config=ADAM if adam else GD)
    wf.initialize("cpu")
    if init is not None:
        params_from_jax(init, "cpu", wf)
    return wf


def _port_local(init, name, adam=False, dropout=0.0):
    """The port's local step on the batches from the JAX init."""
    wf = _port_wf(name, adam, dropout, init)
    step = wf.build_fused_step()
    st = step.init_state()
    losses = []
    for x, y, w in _batches(name)[0]:
        st, (loss, _) = step.train(st, x, y, w)
        losses.append(float(loss))

    def layer(d):
        if isinstance(d, dict) and set(d) == {"m", "v", "t"}:
            return {"m": layer(d["m"]), "v": layer(d["v"])}
        return {k: t.detach().numpy().copy() for k, t in d.items()}
    return {"state": {"params": tuple(layer(p) for p in st["params"]),
                      "vel": tuple(layer(v) for v in st["vel"])},
            "losses": losses, "table": step.variant_table()}


def _port_surface(init):
    wf = _port_wf("fc", init=init)
    step = wf.build_fused_step()
    st = step.init_state()
    (x0, y0, w0), (x1, y1, w1), (x2, y2, w2) = _batches("fc")[0]
    st, acc = step.train_accum(st, x0, y0, 2, w0)
    st, rep = step.train_repeat(st, x1, y1, 2, w1)
    st, many = step.train_many(st, np.stack([x2, x0]), np.stack([y2, y0]),
                               np.stack([w2, w0]))
    conf = step.confusion(st, *_batches("fc")[1][:2], 10)
    return {"state": {slot: tuple({k: t.detach().numpy().copy()
                                   for k, t in layer.items()}
                                  for layer in st[slot])
                      for slot in ("params", "vel")},
            "metrics": [float(acc[0]), int(acc[1])]
            + [float(v) for v in rep[0]] + [float(v) for v in many[0]],
            "confusion": conf.numpy().copy()}


@contextlib.contextmanager
def _selected(op, name):
    with variants.selection_kept():
        variants.select(op, name)
        yield


@pytest.fixture(scope="module")
def everything(tmp_path_factory):
    """The JAX inits, the worlds (started first, so that the JAX and the
    port's local references are computed while they run), the JAX
    references and the port's local references."""
    init = {}
    for name in ("fc", "alex", "conv", "flavors"):
        wf = _jax_wf(name)
        init[(name, False)] = tuple(
            {k: np.asarray(a.mem) for k, a in u.param_arrays().items()}
            for u in wf.forwards)
        wf._stop_units()
    wf = _jax_wf("fc", adam=True)
    init[("fc", True)] = tuple(
        {k: np.asarray(a.mem) for k, a in u.param_arrays().items()}
        for u in wf.forwards)
    wf._stop_units()
    snap_dir = tmp_path_factory.mktemp("tp_snap")
    rs = np.random.RandomState(17)
    cfg = {"seed": SEED, "nets": NETS, "gd": GD, "adam": ADAM,
           "loader": {n: _loader_kw(n) for n in NETS},
           "batches": {n: _batches(n) for n in NETS},
           "init": init, "stem_epi": STEM_EPI, "snap_dir": str(snap_dir),
           "ct_toy": CT_TOY,
           "ct_batches": [(np.eye(18, dtype=np.float32)[
               rs.randint(0, 18, (4, 32))],
               rs.randint(0, 18, (4, 32)).astype(np.int32))
               for _ in range(2)]}
    outs = {n: tmp_path_factory.mktemp(f"world{n}") for n in MESHES}
    procs = {n: _start_world(n, outs[n], dict(cfg, meshes=MESHES[n],
                                              restore=n == 4))
             for n in MESHES}
    worlds = {}
    try:
        jax_refs = {}
        for name in ("fc", "alex"):
            jax_refs[name, None] = _jax_run(name)
            for mesh in MESHES[2] + MESHES[4]:
                jax_refs[name, mesh] = _jax_run(name, mesh)
        jax_refs["conv", None] = _jax_run("conv")
        jax_refs["alex", "bf16"] = _jax_run("alex",
                                            compute_dtype="bfloat16")
        port = {"dropout": _port_local(init[("alex", False)], "alex",
                                       dropout=0.5),
                "flavors": _port_local(init[("flavors", False)], "flavors",
                                       dropout=0.5),
                "adam": _port_local(init[("fc", True)], "fc", adam=True),
                "surface": _port_surface(init[("fc", False)])}
        with _selected("lrn_maxpool", "composed"):
            port["composed"] = _port_local(init[("alex", False)], "alex")
        with _selected("conv_stem", STEM_EPI):
            port["stem_epi"] = _port_local(init[("alex", False)], "alex")
        wf = _port_wf("alex", dropout=0.5)
        port["draw"] = __import__("torch").rand(
            64, generator=wf.build_fused_step().gen).numpy()
    finally:
        for n in MESHES:
            worlds[n] = _finish_world(procs[n], outs[n])
    return {"init": init, "jax": jax_refs, "port": port, "snap_dir": snap_dir,
            "worlds": worlds}


def _world(everything, mesh):
    return everything["worlds"][2 if mesh == (1, 2) else 4]


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


ALL_MESHES = MESHES[2] + MESHES[4]


def _jax_plan(name, m):
    wf = _jax_wf(name)
    step = wf.build_fused_step(
        mesh=jax_make_mesh(jax.devices()[:m], model=m), mode="gspmd")
    plan, flags = step._tp_plan()
    wf._stop_units()
    return ([{k: tuple(spec) for k, spec in layer.items()} for layer in plan],
            list(flags))


def _port_step(name, m, rank=0):
    """The port's gspmd step at data 1 x model m as rank `rank` sees it
    (no collective runs until it trains)."""
    return FusedTrainStep(_port_wf(name), mesh=Mesh(mesh_shape(m, model=m),
                                                    rank, "cpu"),
                          mode="gspmd")


@pytest.mark.parametrize("m", [2, 4])
@pytest.mark.parametrize("name", ["fc", "alex", "mnist", "conv"])
def test_plan_is_the_jax_megatron_plan(name, m):
    plan, flags = _port_step(name, m)._tp_plan()
    want_plan, want_flags = _jax_plan(name, m)
    assert [dict(layer) for layer in plan] == want_plan
    assert flags == want_flags


def test_plan_of_the_narrow_alexnet_at_model_2_and_4():
    """The issue's reading of the JAX plan at model 2, and conv1's 6
    kernels replicated at model 4 (they do not divide)."""
    step = _port_step("alex", 2)
    names = ["conv1", "lrn1", "pool1", "conv2", "lrn2", "pool2", "conv3",
             "conv4", "conv5", "pool5", "fc6", "dropout6", "fc7",
             "dropout7", "head"]
    sharded = {n for n, f in zip(names, step._tp_plan()[1]) if f}
    assert sharded == {"conv1", "lrn1", "pool1", "conv3", "conv5", "pool5",
                       "fc7", "dropout7"}
    assert step.fwd.tp.roles[:4] == ["column", "free", "free", "row"]
    plan4 = _port_step("alex", 4)._tp_plan()[0]
    assert plan4[0] == {"weights": (), "bias": ()}
    assert plan4[3] == {"weights": (None, None, None, MODEL_AXIS),
                        "bias": (MODEL_AXIS,)}


@pytest.mark.parametrize("mesh", ALL_MESHES)
@pytest.mark.parametrize("name", ["fc", "alex"])
@pytest.mark.parametrize("ref", ["gspmd", "local"])
def test_gspmd_step_matches_the_jax_step(everything, name, mesh, ref):
    got = _world(everything, mesh)[mesh, name]
    want = everything["jax"][name, mesh if ref == "gspmd" else None]
    _assert_state_close(got["state"], want)
    np.testing.assert_allclose(got["losses"], want["losses"], rtol=RTOL)
    assert got["errs"] == want["errs"]
    np.testing.assert_allclose(got["eval"][0], want["eval"][0], rtol=RTOL)
    assert got["eval"][1] == want["eval"][1]


@pytest.mark.parametrize("mesh", ALL_MESHES)
def test_flatten_into_a_row_parallel_fc_matches_the_jax_local_step(
        everything, mesh):
    got = _world(everything, mesh)[mesh, "conv"]
    want = everything["jax"]["conv", None]
    if mesh[1] == 2:
        # the FC layer (200 rows = 5x5 pixels x 8 channels) is row-parallel
        # on the flatten of the channel-sharded pool output
        assert got["roles"][:4] == ["column", "free", "free", "row"]
    _assert_state_close(got["state"], want)
    np.testing.assert_allclose(got["losses"], want["losses"], rtol=RTOL)
    assert got["errs"] == want["errs"]
    assert got["eval"][1] == want["eval"][1]


@pytest.mark.parametrize("mesh", ALL_MESHES)
@pytest.mark.parametrize("name", ["fc", "alex"])
def test_rank_shards_have_the_jax_shard_shapes(everything, name, mesh):
    """The counterpart of test_gspmd_tp_actually_partitions: each rank's
    parameters and velocities have the shapes of the JAX state's shard
    on the device of its index, and a sharded leaf holds 1/model of it."""
    got = _world(everything, mesh)[mesh, name]
    want = everything["jax"][name, mesh]["shards"]
    for rank, shapes in enumerate(got["shapes"]):
        assert set(shapes) == set(want)
        for path, by_device in want.items():
            assert shapes[path] == by_device[rank], (rank, path)
    m = mesh[1]
    full = {f"{slot}/{i}/{k}": a.shape
            for slot in ("params", "vel")
            for i, layer in enumerate(got["state"][slot])
            for k, a in layer.items()}
    n_sharded = 0
    for path, shape in got["shapes"][0].items():
        if shape != full[path]:
            n_sharded += 1
            assert int(np.prod(shape)) * m == int(np.prod(full[path]))
    assert n_sharded > 0
    assert got["zero"] == (False, "zero-sharding inactive: mode 'gspmd' "
                           "(covered: the explicit shard_map 'dp' update; "
                           "gspmd relies on the partitioner, local has one "
                           "replica)")


@pytest.mark.parametrize("m", [2, 4])
@pytest.mark.parametrize("name", ["fc", "alex"])
def test_shard_state_of_carried_params_is_the_jax_shard_contents(
        everything, name, m):
    """`convert.state_from_jax` carries the JAX gspmd state across; the
    port step's `shard_state` gives, rank by rank, the JAX shards' data."""
    jstate = everything["jax"][name, (1, m)]["state"]
    carried = state_from_jax(jstate, "cpu")
    for rank in range(m):
        mine = _port_step(name, m, rank).shard_state(carried)
        for slot in ("params", "vel"):
            for i, layer in enumerate(jstate[slot]):
                for k, a in layer.items():
                    data = {s.device.id: np.asarray(s.data)
                            for s in a.addressable_shards}[rank]
                    np.testing.assert_array_equal(
                        mine[slot][i][k].detach().numpy(), data,
                        err_msg=f"rank {rank} {slot}/{i}/{k}")


@pytest.mark.parametrize("mesh", ALL_MESHES)
def test_bf16_step_within_its_share_of_the_update(everything, mesh):
    got = _world(everything, mesh)[mesh, "alex", "bf16"]
    ref = everything["jax"]["alex", "bf16"]
    init = dict(_leaves(everything["init"][("alex", False)]))
    want = dict(_leaves(ref["params"]))
    have = dict(_leaves(got["state"]["params"]))
    err = np.sqrt(sum(float(np.sum((have[k] - want[k]) ** 2))
                      for k in want))
    moved = np.sqrt(sum(float(np.sum((want[k] - init[k]) ** 2))
                        for k in want))
    assert 0 < err <= BF16_TOL * moved, (err, moved)
    np.testing.assert_allclose(got["losses"], ref["losses"], rtol=1e-3)


@pytest.mark.parametrize("mesh", ALL_MESHES)
@pytest.mark.parametrize("setting", ["composed", "stem_epi"])
def test_lrn_on_sharded_channels(everything, mesh, setting):
    """The LRN after a column-parallel conv1 all-gathers the channels
    (K2/K3 under `composed`, K4/K5 under `fused`); an auto stem's
    `epi=lrn` pair is not claimed under a column-parallel stem (model 2:
    the LRN joins the pool instead) and is where conv1 is replicated
    (model 4). Each against the port's local step of the setting."""
    got = _world(everything, mesh)[mesh, "alex", setting]
    want = everything["port"][setting]
    _assert_state_close(got["state"], want["state"])
    np.testing.assert_allclose(got["losses"], want["losses"], rtol=RTOL)
    table = got["table"]
    if setting == "composed":
        assert "lrn_maxpool" not in table and table == want["table"]
    elif mesh[1] == 2:
        assert got["roles"][0] == "column"
        assert table["conv_stem"] == "gen[pack=s2d,acc=native,epi=none]"
        assert table["lrn_maxpool"] == "fused"
        assert want["table"]["lrn"] == f"conv_stem/{STEM_EPI}"
    else:
        assert table["lrn"] == f"conv_stem/{STEM_EPI}" == \
            want["table"]["lrn"]


@pytest.mark.parametrize("mesh", ALL_MESHES)
def test_dropout_draws_one_mask_per_model_group(everything, mesh):
    world = _world(everything, mesh)
    draws = world[mesh, "draws"]
    for d in draws:
        np.testing.assert_array_equal(d, everything["port"]["draw"])
    got = world[mesh, "alex", "dropout"]
    want = everything["port"]["dropout"]
    _assert_state_close(got["state"], want["state"])
    np.testing.assert_allclose(got["losses"], want["losses"], rtol=RTOL)


@pytest.mark.parametrize("mesh", ALL_MESHES)
def test_units_without_parameters_on_sharded_channels(everything, mesh):
    """Stochastic pooling (its noise drawn for the global batch and every
    channel, the rank's block kept), an activation, average and max-abs
    pooling and dropout run on the rank's channels after a
    column-parallel conv, the FC layer after them gathers the flatten,
    and at model 2 the softmax head is column-parallel (its logits
    gathered for the loss): the port's local step's numbers."""
    got = _world(everything, mesh)[mesh, "flavors"]
    want = everything["port"]["flavors"]
    if mesh[1] == 2:
        assert got["flags"] == [True] * 6 + [False, True]
        assert got["roles"][-2:] == ["row", "column"]
    _assert_state_close(got["state"], want["state"])
    np.testing.assert_allclose(got["losses"], want["losses"], rtol=RTOL)


@pytest.mark.parametrize("mesh", ALL_MESHES)
def test_adam_matches_the_local_step(everything, mesh):
    got = _world(everything, mesh)[mesh, "fc", "adam"]
    want = everything["port"]["adam"]
    _assert_state_close(got["state"], want["state"])
    np.testing.assert_allclose(got["losses"], want["losses"], rtol=RTOL)
    # a rank holds its blocks of the moments
    full = sum(a.size * 4 for _, a in _leaves(got["state"]["vel"]))
    assert all(b < full for b in got["opt_bytes"])


@pytest.mark.parametrize("mesh", ALL_MESHES)
def test_accum_repeat_many_and_confusion_under_gspmd(everything, mesh):
    got = _world(everything, mesh)[mesh, "surface"]
    want = everything["port"]["surface"]
    _assert_state_close(got["state"], want["state"])
    np.testing.assert_allclose(got["metrics"], want["metrics"], rtol=RTOL)
    np.testing.assert_array_equal(got["confusion"], want["confusion"])


def test_train_many_is_sequential_trains():
    """`train_many` over K stacked batches is K `train` calls (JAX
    test_train_many_sharded_matches_sequential), at one data shard of
    the gspmd step (no collective: model 1)."""
    a = FusedTrainStep(_port_wf("fc"), mesh=Mesh(mesh_shape(1), 0, "cpu"),
                       mode="gspmd")
    b = FusedTrainStep(_port_wf("fc"), mesh=Mesh(mesh_shape(1), 0, "cpu"),
                       mode="gspmd")
    train = _batches("fc")[0]
    sa, sb = a.init_state(), b.init_state()
    sa, (la, _) = a.train_many(sa, np.stack([x for x, _, _ in train]),
                               np.stack([y for _, y, _ in train]),
                               np.stack([w for _, _, w in train]))
    lb = []
    for x, y, w in train:
        sb, (loss, _) = b.train(sb, x, y, w)
        lb.append(float(loss))
    assert [float(v) for v in la] == lb
    for pa, pb in zip(sa["params"], sb["params"]):
        for k in pa:
            assert np.array_equal(pa[k].detach().numpy(),
                                  pb[k].detach().numpy())


@pytest.mark.parametrize("mesh", ALL_MESHES)
def test_rank_holds_half_or_a_quarter_of_the_sharded_bytes(everything,
                                                           mesh):
    got = _world(everything, mesh)[mesh, "alex"]
    plan = got["plan"]
    full = 4 * sum(a.size for _, a in _leaves(got["state"]["vel"]))
    shard = 4 * sum(a.size // (mesh[1] if plan[int(p.split("/")[0])][
        p.split("/")[1]] else 1) for p, a in _leaves(got["state"]["vel"]))
    assert got["opt_bytes"] == [shard] * (mesh[0] * mesh[1])
    assert shard < full


def test_checkpoint_and_snapshot_restore_at_another_model_size(everything):
    """A checkpoint and a snapshot written at model 2 (data 2 x model 2,
    after 2 steps) restore at model 4 and in local mode; step 3 gives the
    uninterrupted run's state (the JAX local step's)."""
    from veles_tpu_torch.parallel import checkpoint
    w4 = everything["worlds"][4]
    want = everything["jax"]["fc", None]
    assert w4["ckpt_files"] == ["state.pt"]
    # write_back gathered the blocks into the units
    for i, layer in w4["written_back"].items():
        for k, a in layer.items():
            assert a.shape == everything["init"][("fc", False)][i][k].shape
    _assert_state_close(w4["ckpt"]["state"], want)
    _assert_state_close(w4["snap"]["state"], want)
    assert w4["ckpt"]["shapes"][1]["params/0/weights"] == (64, 8)
    # the checkpoint into a local step
    wf = _port_wf("fc")
    step = wf.build_fused_step()
    st = checkpoint.restore_state(step, os.path.join(
        everything["snap_dir"], "ckpt"))
    for x, y, w in _batches("fc")[0][2:]:
        st, _ = step.train(st, x, y, w)
    _assert_state_close(
        {slot: tuple({k: t.detach().numpy() for k, t in layer.items()}
                     for layer in st[slot]) for slot in ("params", "vel")},
        want)


def test_model_ranks_of_a_data_shard_train_the_same_rows(everything):
    """At data 2 x model 2 the ranks are laid out data-outermost (rank =
    d*2 + m, the JAX layout), and `local_rows` keys on the data index
    alone."""
    world = everything["worlds"][4]
    assert world[(2, 2), "mesh"] == (0, 0)
    for rank in range(4):
        mesh = Mesh(mesh_shape(4, model=2), rank, "cpu")
        assert (mesh.data_index, mesh.model_index) == divmod(rank, 2)
        step = FusedTrainStep(_port_wf("fc"), mesh=mesh, mode="gspmd")
        d = rank // 2
        assert step.local_rows(8).tolist() == [d * 4 <= i < d * 4 + 4
                                               for i in range(8)]
        assert step.n_data == 2 and step.n_model == 2


def test_leaf_part_takes_the_rank_block():
    import torch
    t = torch.arange(24.0).reshape(2, 3, 4)
    spec = (None, None, MODEL_AXIS)
    assert leaf_part(t, spec, 1, 2).tolist() == t[:, :, 2:].tolist()
    assert leaf_part(t, (), 1, 2) is t


def test_refusals():
    wf = _port_wf("fc")
    with pytest.raises(NotImplementedError, match=r"Queue 1 item 1\(b\)"):
        FusedTrainStep(wf, mesh=Mesh(mesh_shape(2, seq=2), 0, "cpu"))
    with pytest.raises(ValueError, match="needs the explicit shard_map"):
        FusedTrainStep(wf, mesh=Mesh(mesh_shape(2, model=2), 0, "cpu"),
                       mode="gspmd", ep=True)
    with pytest.raises(ValueError, match="requires a mesh"):
        FusedTrainStep(wf, mode="gspmd")
    step = FusedTrainStep(wf, mesh=Mesh(mesh_shape(2, model=2), 0, "cpu"))
    assert step.mode == "gspmd" and not step.zero_active
    assert step.zero_reason.startswith("zero-sharding inactive: mode "
                                       "'gspmd' (covered:")
    # at model 1 every leaf is replicated and any workflow runs
    assert all(spec == () for layer in FusedTrainStep(
        wf, mesh=Mesh(mesh_shape(1), 0, "cpu"), mode="gspmd")._tp_plan()[0]
        for spec in layer.values())


CT_TOY = {"embed": 16, "n_heads": 2, "ffn": 24, "loader.seq_len": 32,
          "loader.minibatch_size": 4, "loader.n_validation": 4}


def test_attention_at_model_2_trains(everything):
    """The toy char-transformer trains at model 2 through gloo: 2 steps
    within 1e-6 of the local step's parameters (the JAX comparisons are
    tests/test_torch_tp_seq.py's); at model 1 every leaf is
    replicated."""
    got = everything["worlds"][2][(1, 2), "ct"]
    assert got["roles"] == ["column", "lastdim", "row", "column"]
    assert got["err"] <= 1e-6
    from veles_tpu_torch.config import root
    from veles_tpu_torch.samples import char_transformer as ct
    saved = root.char_transformer.to_dict()
    try:
        for k, v in CT_TOY.items():
            root.char_transformer.override(k, v)
        prng._generators.clear()
        prng.seed_all(SEED)
        wf = ct.create_workflow()
    finally:
        root.char_transformer.update(saved)
    wf.initialize("cpu")
    step = FusedTrainStep(wf, mesh=Mesh(mesh_shape(1), 0, "cpu"),
                          mode="gspmd")
    assert step.n_model == 1
    assert all(spec == () for layer in step._tp_plan()[0]
               for spec in layer.values())


@pytest.mark.parametrize("argv,msg", [
    (["--tp", "0"], "--tp needs K >= 1"),
    (["--tp", "2"], "combine with -l/-m"),
    (["--tp", "2", "--ep", "-l", "127.0.0.1:1"], "exclusive with --tp/--sp"),
    (["--tp", "2", "--pp", "2", "-l", "127.0.0.1:1"],
     "--pp is its own partitioning"),
    (["--sp", "2", "-l", "127.0.0.1:1"], r"Queue 1 item 1(b)"),
])
def test_cli_tp_refusals(argv, msg):
    with pytest.raises(SystemExit) as e:
        launcher.parse_args(["wf.py", *argv])
    assert msg in str(e.value)


def test_cli_tp_accepts_one_without_a_group():
    args = launcher.parse_args(["wf.py", "--fused", "--tp", "1"])
    assert args.tp == 1


def test_cli_two_processes_train_with_tp_2(tmp_path):
    """`-l`/`-m --tp 2` in two gloo processes on MNIST's FC (the gspmd
    step, data 1 x model 2): both ranks print the fused local run's
    TRAINED line (its losses within 1e-5)."""
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
        + ["--process-id", str(r), "--n-processes", "2", "--tp", "2",
           "-v"],
        cwd=REPO, env=env, stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True) for r in range(2)]
    local = subprocess.run(argv + ["--fused"], cwd=REPO, env=env,
                           capture_output=True, text=True,
                           timeout=WORLD_TIMEOUT_S)
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(timeout=WORLD_TIMEOUT_S)[0])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
    assert local.returncode == 0, local.stderr[-2000:]

    def trained(text):
        line = [ln for ln in text.splitlines()
                if ln.startswith("TRAINED")][-1]
        head, hist = line.split(" history ")
        return float(head.split("loss ")[1].split()[0]), hist
    want_loss, want_hist = trained(local.stdout)
    for p, out in zip(procs, outs):
        assert p.returncode == 0, out[-2000:]
        assert "'model': 2" in out
        loss, hist = trained(out)
        assert hist == want_hist
        np.testing.assert_allclose(loss, want_loss, rtol=1e-5)
