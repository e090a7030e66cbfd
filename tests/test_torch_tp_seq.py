"""The port's tensor-parallel fused step (mode "gspmd", parallel/tp.py) on
the multi-matrix families, on the CPU: the sequence layers under the JAX
plan's single-weight rule (`pos`, `w2`, `b2` replicated), attention and
MoE under its last-dim rule. Gloo process groups of 2 ranks (data 1 x
model 2) and 4 ranks (data 1 x model 4, then data 2 x model 2), held
against the JAX package's gspmd `FusedTrainStep` on the same mesh shape
(an 8-device virtual CPU, tests/conftest.py) and against its local step.

Nets, at embed 16, FFN 24, seq 32, minibatch 8, on one-hot characters of
the text loader's vocabulary: the char-transformer (SeqLinear embed with
`pos`, causal attention of 2 heads, SeqFFN, SeqSoftmax), its MoE form (4
experts of hidden 24 at capacity factor 1.0, which drops tokens, so that
the routing of the global batch shows at data 2), its form with one head
of 16 (a head straddling the ranks), a stack with a second SeqFFN (a
column-parallel FFN, its output reduce-scattered, and a row-parallel
head), and `samples/moe.py` (All2AllTanh 64 -> MoE 8 x 128 -> Softmax 8,
the 2-D token input). Every run starts from the JAX workflow's seeded
parameters and trains 3 steps, the third with two pad rows, then
evaluates a validation batch.

Tolerances: f32 rtol 1e-5, atol 1e-6 per leaf on the parameters and
velocities, the losses rtol 1e-5, n_err equal; bf16 the update within
2^-7 of its norm, the losses within 1e-3 relative (tests/test_torch_tp.py's),
the bias vectors against the JAX f32 step and the other leaves against
the JAX bf16 step (tests/test_torch_bf16_transformer.py's split).

Each world is one set of processes running every scenario in turn; the
JAX references are computed in JAX_PROCESSES processes beside them.
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
from veles_tpu.config import root as jroot
from veles_tpu.loader.text import CharSequenceLoader as JaxTextLoader
from veles_tpu.parallel import make_mesh as jax_make_mesh
from veles_tpu.samples import char_transformer as jct  # noqa: F401
from veles_tpu.samples import moe as jsample
from veles_tpu.znicz.standard_workflow import \
    StandardWorkflow as JaxWorkflow
from veles_tpu_torch import prng
from veles_tpu_torch.config import root
from veles_tpu_torch.convert import params_from_jax, state_from_jax
from veles_tpu_torch.loader.text import CharSequenceLoader
from veles_tpu_torch.parallel.fused import FusedTrainStep
from veles_tpu_torch.parallel.mesh import MODEL_AXIS, Mesh, mesh_shape
from veles_tpu_torch.samples import char_transformer as ct
from veles_tpu_torch.samples import moe as sample
from veles_tpu_torch.znicz.nn_units import Forward
from veles_tpu_torch.znicz.standard_workflow import StandardWorkflow

REPO = Path(__file__).resolve().parent.parent
SEED, K = 7, 3
RTOL, ATOL = 1e-5, 1e-6
BF16_TOL = 2.0 ** -7
WORLD_TIMEOUT_S = 240
GD = {"learning_rate": 0.2, "gradient_moment": 0.9,
      "weights_decay": 5e-4}
ADAM = dict(GD, optimizer="adam", learning_rate=1e-3)
SEQ, MB = 32, 8
#: (data, model) meshes of each world
MESHES = {2: ((1, 2),), 4: ((1, 4), (2, 2))}
ALL_MESHES = MESHES[2] + MESHES[4]
#: the char-transformer's forms: (heads, experts, a second FFN)
TRANSFORMERS = {"dense": (2, 0, False), "moe": (2, 4, False),
                "one": (1, 0, False), "stack": (2, 0, True)}
SAMPLE = {"loader.minibatch_size": MB, "loader.n_train": 16,
          "loader.n_validation": 8}


def _layers(name, flash="auto", n_vocab=None):
    heads, experts, stack = TRANSFORMERS[name]
    if experts:
        ffn = {"type": "moe", "n_experts": experts, "hidden": 24,
               "residual": True, "capacity_factor": 1.0,
               "weights_stddev": 0.05}
    else:
        ffn = {"type": "seq_ffn", "hidden": 24, "activation": "tanh",
               "weights_stddev": 0.05}
    attention = {"type": "attention", "n_heads": heads, "causal": True,
                 "residual": True, "weights_stddev": 0.05}
    if flash != "auto":
        attention["use_flash"] = flash
    layers = [{"type": "seq_linear", "output_features": 16,
               "pos_embed": True, "weights_stddev": 0.05}, attention, ffn]
    if stack:
        layers.append({"type": "seq_ffn", "hidden": 24,
                       "activation": "tanh", "weights_stddev": 0.05})
    return layers + [{"type": "seq_softmax", "output_features": n_vocab,
                      "weights_stddev": 0.05}]


def _net(name, loader_cls, wf_cls, gd, flash="auto"):
    loader = loader_cls(seq_len=SEQ, n_validation=MB, minibatch_size=MB)
    return wf_cls(layers=_layers(name, flash, loader.n_vocab),
                  loader=loader, loss="softmax", n_classes=loader.n_vocab,
                  name=f"TPSeq{name}", gd_config=gd)


@contextlib.contextmanager
def _config(node, overrides):
    saved = node.to_dict()
    for dotted, value in overrides.items():
        node.override(dotted, value)
    try:
        yield
    finally:
        node.update(saved)


def _jax_wf(name, adam=False):
    jprng._generators.clear()
    jprng.seed_all(SEED)
    if name == "sample":
        with _config(jroot.moe, SAMPLE):
            wf = jsample.create_workflow()
    else:
        wf = _net(name, JaxTextLoader, JaxWorkflow, ADAM if adam else GD)
    wf.initialize(device=None)
    return wf


def _port_wf(name, adam=False, flash="auto", init=None):
    """The port's workflow of `name` from the seed (the worker's `make`
    builds the same), its parameters `init` where given."""
    prng._generators.clear()
    prng.seed_all(SEED)
    if name == "sample":
        with _config(root.moe, SAMPLE):
            wf = sample.create_workflow()
    else:
        wf = _net(name, CharSequenceLoader, StandardWorkflow,
                  ADAM if adam else GD, flash)
    wf.initialize("cpu")
    if init is not None:
        params_from_jax(init, "cpu", wf)
    return wf


def _batches(name):
    """K train batches of MB rows (the last with 2 pad rows) and one
    validation batch, from a seed: one-hot characters and per-token
    labels, or the MoE sample's features and classes."""
    rs = np.random.RandomState(300 + len(name))
    n_vocab = CharSequenceLoader(seq_len=SEQ).n_vocab
    out = []
    for i in range(K + 1):
        if name == "sample":
            x = rs.randn(MB, 32).astype(np.float32)
            y = rs.randint(0, 8, MB).astype(np.int32)
        else:
            x = np.eye(n_vocab, dtype=np.float32)[
                rs.randint(0, n_vocab, (MB, SEQ))]
            y = rs.randint(0, n_vocab, (MB, SEQ)).astype(np.int32)
        w = np.ones(MB, np.float32)
        if i == K - 1:
            w[-2:] = 0.0
        out.append((x, y, w))
    return out[:K], out[K]


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
                        s.device.id: np.asarray(s.data)
                        for s in a.addressable_shards}
    out = {"params": tuple(_host(p) for p in state["params"]),
           "vel": tuple(_host(v) for v in state["vel"]),
           "lr_scale": np.asarray(state["lr_scale"]),
           "losses": losses, "errs": errs,
           "eval": (float(ev[0]), int(ev[1])), "shards": shards}
    wf._stop_units()
    return out


#: the JAX references, each process of JAX_WORKER computing its share
JAX_JOBS = [(name, mesh, None) for name in ("dense", "moe", "one")
            for mesh in (None,) + ALL_MESHES] + [
    ("stack", None, None), ("sample", None, None),
    ("dense", None, "bfloat16")]
JAX_PROCESSES = 3
JAX_WORKER = r'''
import pickle, sys
import jax
jax.config.update("jax_platforms", "cpu")
jax.config.update("jax_default_matmul_precision", "highest")
sys.path.insert(0, sys.argv[1])
import test_torch_tp_seq as T
jobs = T.JAX_JOBS[int(sys.argv[2])::T.JAX_PROCESSES]
with open(sys.argv[3], "wb") as f:
    pickle.dump({job: T._jax_run(*job) for job in jobs}, f)
'''


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
from veles_tpu_torch.config import root
from veles_tpu_torch.convert import params_from_jax
from veles_tpu_torch.loader.text import CharSequenceLoader
from veles_tpu_torch.parallel import checkpoint, distributed
from veles_tpu_torch.parallel import mesh as M
from veles_tpu_torch.samples import moe as sample
from veles_tpu_torch.snapshotter import Snapshotter
from veles_tpu_torch.znicz.standard_workflow import StandardWorkflow

distributed.initialize_distributed(f"127.0.0.1:{port}", rank, world,
                                   backend="gloo", timeout_s=120)


def make(name, adam=False, flash="auto"):
    prng._generators.clear()
    prng.seed_all(cfg["seed"])
    if name == "sample":
        saved = root.moe.to_dict()
        for k, v in cfg["sample"].items():
            root.moe.override(k, v)
        try:
            wf = sample.create_workflow()
        finally:
            root.moe.update(saved)
    else:
        loader = CharSequenceLoader(seq_len=cfg["seq"],
                                    n_validation=cfg["mb"],
                                    minibatch_size=cfg["mb"])
        layers = cfg["layers"][name, flash]
        wf = StandardWorkflow(
            layers=layers, loader=loader, loss="softmax",
            n_classes=loader.n_vocab, name="TPSeq" + name,
            gd_config=cfg["adam"] if adam else cfg["gd"])
    wf.initialize("cpu")
    params_from_jax(cfg["init"][(name, adam)], "cpu", wf)
    return wf


# the sequence layers' types register with their sample's import
from veles_tpu_torch.samples import char_transformer  # noqa: E402,F401


def host(step, st):
    st = step.gather_state(st)

    def layer(d):
        if isinstance(d, dict) and set(d) == {"m", "v", "t"}:
            return {"m": layer(d["m"]), "v": layer(d["v"])}
        return {k: t.detach().float().numpy().copy() for k, t in d.items()}
    return {"params": tuple(layer(p) for p in st["params"]),
            "vel": tuple(layer(v) for v in st["vel"])}


def everyone(obj):
    every = [None] * world
    dist.all_gather_object(every, obj)
    return every


def mine(step, st):
    """This rank's leaves: their shapes, and the replicated ones' values
    (which every rank must update alike)."""
    plan = step._tp_plan()[0]
    shapes, kept = {}, {}
    for slot in ("params", "vel"):
        for i, layer in enumerate(st[slot]):
            if set(layer) == {"m", "v", "t"}:
                layer = {f"{s}/{k}": t for s in ("m", "v")
                         for k, t in layer[s].items()}
            for k, t in layer.items():
                shapes[f"{slot}/{i}/{k}"] = tuple(t.shape)
                if plan[i][k.split("/")[-1]] == ():
                    kept[f"{slot}/{i}/{k}"] = t.detach().numpy().copy()
    return shapes, kept


def run(name, mesh, adam=False, dtype=None, flash="auto", batches=None,
        wf=None, st=None):
    wf = wf or make(name, adam, flash)
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
    shapes, kept = mine(step, st)
    return {"state": host(step, st), "losses": losses, "errs": errs,
            "eval": (float(ev[0]), int(ev[1])),
            "shapes": everyone(shapes), "kept": everyone(kept),
            "plan": plan, "flags": flags, "roles": step.fwd.tp.roles,
            "opt_bytes": everyone(sum(
                step.optimizer_state_bytes(st).values())),
            "table": step.variant_table()}


def surface(mesh):
    wf = make("dense")
    step = wf.build_fused_step(mesh=mesh, mode="gspmd")
    st = step.init_state()
    (x0, y0, w0), (x1, y1, w1), (x2, y2, w2) = cfg["batches"]["dense"][0]
    st, acc = step.train_accum(st, x0, y0, 2, w0)
    st, rep = step.train_repeat(st, x1, y1, 2, w1)
    st, many = step.train_many(st, np.stack([x2, x0]), np.stack([y2, y0]),
                               np.stack([w2, w0]))
    # the confusion matrix of a head of one label per sample: the MoE
    # sample's (its softmax row-parallel after MoE)
    cstep = make("sample").build_fused_step(mesh=mesh, mode="gspmd")
    conf = cstep.confusion(cstep.init_state(),
                           *cfg["batches"]["sample"][1][:2], 8)
    return {"state": host(step, st),
            "metrics": [float(acc[0]), int(acc[1])]
            + [float(v) for v in rep[0]] + [float(v) for v in many[0]],
            "confusion": conf.numpy().copy()}


snap = os.path.join(cfg["snap_dir"], "tp_seq_snapshot.pickle")
ckpt = os.path.join(cfg["snap_dir"], "ckpt")
train = cfg["batches"]["dense"][0]
res = {}
for d, m in cfg["meshes"]:
    mesh = M.make_mesh(model=m, device="cpu")
    key = (d, m)
    res[key, "mesh"] = (mesh.data_index, mesh.model_index)
    for name in ("dense", "moe", "one", "stack", "sample"):
        res[key, name] = run(name, mesh)
    res[key, "bf16"] = run("dense", mesh, dtype="bfloat16")
    res[key, "adam"] = run("dense", mesh, adam=True)
    res[key, "flash"] = run("dense", mesh, flash="on")
    res[key, "surface"] = surface(mesh)
    if cfg["restore"] and m == 2:
        # a checkpoint and a snapshot written at model 2 after 2 steps
        wf = make("dense")
        step = wf.build_fused_step(mesh=mesh, mode="gspmd")
        st = step.init_state()
        for x, y, w in train[:2]:
            st, _ = step.train(st, x, y, w)
        checkpoint.save_state(st, ckpt, step)
        step.write_back(st)
        if rank == 0:
            path = Snapshotter(wf, prefix="tp_seq",
                               directory=cfg["snap_dir"],
                               compression="").export()
            os.replace(path, snap)
        dist.barrier()
if cfg["restore"]:
    # ... restored at model 4, step 3 taken
    mesh = M.make_mesh(model=4, device="cpu")
    wf = Snapshotter.import_(snap)
    wf.place("cpu")
    res["snap"] = run("dense", mesh, batches=train[2:], wf=wf)
    wf = make("dense")
    step = wf.build_fused_step(mesh=mesh, mode="gspmd")
    st = checkpoint.restore_state(step, ckpt)
    res["ckpt"] = run("dense", mesh, batches=train[2:], wf=wf, st=st)

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


def _state(st):
    def layer(d):
        if isinstance(d, dict) and set(d) == {"m", "v", "t"}:
            return {"m": layer(d["m"]), "v": layer(d["v"])}
        return {k: t.detach().numpy().copy() for k, t in d.items()}
    return {slot: tuple(layer(p) for p in st[slot])
            for slot in ("params", "vel")}


def _port_local(init, name, adam=False, flash="auto"):
    """The port's local step on the batches from the JAX init."""
    step = _port_wf(name, adam, flash, init).build_fused_step()
    st = step.init_state()
    losses = []
    for x, y, w in _batches(name)[0]:
        st, (loss, _) = step.train(st, x, y, w)
        losses.append(float(loss))
    return {"state": _state(st), "losses": losses,
            "table": step.variant_table()}


def _port_surface(init, sample_init):
    step = _port_wf("dense", init=init).build_fused_step()
    st = step.init_state()
    (x0, y0, w0), (x1, y1, w1), (x2, y2, w2) = _batches("dense")[0]
    st, acc = step.train_accum(st, x0, y0, 2, w0)
    st, rep = step.train_repeat(st, x1, y1, 2, w1)
    st, many = step.train_many(st, np.stack([x2, x0]), np.stack([y2, y0]),
                               np.stack([w2, w0]))
    cstep = _port_wf("sample", init=sample_init).build_fused_step()
    conf = cstep.confusion(cstep.init_state(), *_batches("sample")[1][:2],
                           8)
    return {"state": _state(st),
            "metrics": [float(acc[0]), int(acc[1])]
            + [float(v) for v in rep[0]] + [float(v) for v in many[0]],
            "confusion": conf.numpy().copy()}


def _init(name, adam=False):
    wf = _jax_wf(name, adam)
    out = tuple({k: np.asarray(a.mem) for k, a in u.param_arrays().items()}
                for u in wf.forwards)
    wf._stop_units()
    return out


@pytest.fixture(scope="module")
def everything(tmp_path_factory):
    """The JAX inits, the worlds and the JAX references (in processes of
    their own, started together), the port's local references computed
    meanwhile."""
    names = ("dense", "moe", "one", "stack", "sample")
    init = {(n, False): _init(n) for n in names}
    init[("dense", True)] = _init("dense", adam=True)
    vocab = CharSequenceLoader(seq_len=SEQ).n_vocab
    snap_dir = tmp_path_factory.mktemp("tp_seq_snap")
    cfg = {"init": init, "batches": {n: _batches(n) for n in names},
           "snap_dir": str(snap_dir), "vocab": vocab, "seed": SEED,
           "seq": SEQ, "mb": MB, "gd": GD, "adam": ADAM, "sample": SAMPLE,
           "layers": {(n, f): _layers(n, f, vocab)
                      for n in TRANSFORMERS for f in ("auto", "on")}}
    outs = {n: tmp_path_factory.mktemp(f"seq_world{n}") for n in MESHES}
    procs = {n: _start_world(n, outs[n], dict(cfg, meshes=MESHES[n],
                                              restore=n == 4))
             for n in MESHES}
    jax_dir = tmp_path_factory.mktemp("seq_jax")
    jax_procs = [subprocess.Popen(
        [sys.executable, "-c", JAX_WORKER, str(Path(__file__).parent),
         str(j), str(jax_dir / f"{j}.pkl")],
        env=dict(os.environ, PYTHONPATH=str(REPO)),
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for j in range(JAX_PROCESSES)]
    worlds, jax_refs = {}, {}
    try:
        port = {"adam": _port_local(init[("dense", True)], "dense",
                                    adam=True),
                "flash": _port_local(init[("dense", False)], "dense",
                                     flash="on"),
                "surface": _port_surface(init[("dense", False)],
                                         init[("sample", False)])}
    finally:
        for n in MESHES:
            worlds[n] = _finish_world(procs[n], outs[n])
        logs = [p.communicate(timeout=WORLD_TIMEOUT_S)[0]
                for p in jax_procs]
    for j, (p, log) in enumerate(zip(jax_procs, logs)):
        assert p.returncode == 0, log[-3000:]
        with open(jax_dir / f"{j}.pkl", "rb") as f:
            for (name, mesh, dtype), ref in pickle.load(f).items():
                jax_refs[name, "bf16" if dtype else mesh] = ref
    return {"init": init, "jax": jax_refs, "port": port,
            "snap_dir": snap_dir, "worlds": worlds}


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


def _jax_plan(name, m):
    wf = _jax_wf(name)
    step = wf.build_fused_step(
        mesh=jax_make_mesh(jax.devices()[:m], model=m), mode="gspmd")
    plan, flags = step._tp_plan()
    wf._stop_units()
    return ([{k: tuple(spec) for k, spec in layer.items()} for layer in plan],
            list(flags))


def _port_step(name, m, rank=0, wf=None):
    """The port's gspmd step at data 1 x model m as rank `rank` sees it
    (no collective runs until it trains)."""
    return FusedTrainStep(wf or _port_wf(name),
                          mesh=Mesh(mesh_shape(m, model=m), rank, "cpu"),
                          mode="gspmd")


# -- the plan -----------------------------------------------------------------

@pytest.mark.parametrize("m", [2, 4])
@pytest.mark.parametrize("name", ["dense", "moe", "one", "stack", "sample"])
def test_plan_is_the_jax_plan(name, m):
    plan, flags = _port_step(name, m)._tp_plan()
    want_plan, want_flags = _jax_plan(name, m)
    assert [dict(layer) for layer in plan] == want_plan
    assert flags == want_flags


@pytest.mark.parametrize("m", [2, 4])
def test_plan_of_the_char_transformer(m):
    """The char-transformer's plan, rule for rule: the embed column-
    parallel with `pos` replicated, attention on its last dims, the FFN
    row-parallel with w2 and b2 replicated, the head column-parallel at
    model 2 and replicated at 4 (18 does not divide); with MoE in place
    of the FFN, every MoE leaf on its last dim and a row-parallel
    head."""
    col, row, last = (None, MODEL_AXIS), (MODEL_AXIS, None), \
        (None, MODEL_AXIS)
    step = _port_step("dense", m)
    plan, flags = step._tp_plan()
    assert plan[0] == {"weights": col, "bias": (MODEL_AXIS,), "pos": ()}
    assert plan[1] == {k: last for k in ("wq", "wk", "wv", "wo")}
    assert plan[2] == {"weights": row, "bias": (), "w2": (), "b2": ()}
    assert plan[3] == ({"weights": col, "bias": (MODEL_AXIS,)} if m == 2
                       else {"weights": (), "bias": ()})
    assert flags == [True, True, False, m == 2]
    assert step.fwd.tp.roles == ["column", "lastdim", "row",
                                 "column" if m == 2 else "replicated"]
    step = _port_step("moe", m)
    plan, flags = step._tp_plan()
    assert plan[2] == {"wr": last, "w1": (None, None, MODEL_AXIS),
                       "b1": last, "w2": (None, None, MODEL_AXIS),
                       "b2": last}
    assert plan[3] == {"weights": row, "bias": ()}
    assert flags == [True, True, True, False]
    assert step.fwd.tp.roles == ["column", "lastdim", "lastdim", "row"]


@pytest.mark.parametrize("experts", [0, 8])
def test_full_width_rank_share(experts):
    """At the char-transformer's full width (vocab 18, embed 64, 4 heads,
    FFN 128, seq_len 4096; 8 experts of hidden 128) a rank of model 2
    holds 284,009 of the 297,490 elements (the replicated 4096 x 64
    `pos` table dominates), and with MoE 338,098 of 414,034."""
    from veles_tpu_torch.loader.text import synthetic_text
    over = {"loader.seq_len": 4096, "loader.n_validation": 1,
            "loader.minibatch_size": 2, "moe_experts": experts}
    prng._generators.clear()
    prng.seed_all(SEED)
    with _config(root.char_transformer, over):
        wf = ct.create_workflow(text=synthetic_text(3 * 4096 + 1))
    wf.initialize("cpu")
    plan = _port_step(None, 2, wf=wf)._tp_plan()[0]
    whole = mine = 0
    for layer, specs in zip(wf.forwards, plan):
        for k, t in layer.param_arrays().items():
            whole += t.numel()
            mine += t.numel() // (2 if specs[k] else 1)
    assert (mine, whole) == ((284009, 297490) if not experts
                             else (338098, 414034))


def test_unit_without_a_rank_program_is_refused():
    """A parameterised unit of a family without a rank program is refused
    at model > 1, naming the unit; at model 1 it runs."""
    import torch

    class Scale(Forward):
        def initialize(self, sample_shape, device):
            self.weights = self._param(np.ones(3, np.float32), device)
            self.bias = self._param(np.zeros(3, np.float32), device)
            return sample_shape

    from veles_tpu_torch.parallel.tp import RankForward
    u = Scale(name="scale3")
    u.initialize((3,), torch.device("cpu"))
    with pytest.raises(NotImplementedError,
                       match=r"scale3 \(Scale\).*no rank program"):
        RankForward([u], Mesh(mesh_shape(2, model=2), 0, "cpu"))
    assert RankForward([u], Mesh(mesh_shape(1), 0, "cpu")).roles == [
        "replicated"]


# -- the step -----------------------------------------------------------------

@pytest.mark.parametrize("mesh", ALL_MESHES)
@pytest.mark.parametrize("name", ["dense", "moe", "one"])
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
@pytest.mark.parametrize("name", ["stack", "sample"])
def test_other_roles_match_the_jax_local_step(everything, name, mesh):
    """The stack's second FFN column-parallel (its hidden's block times
    w2's rows, reduce-scattered over E) and its head row-parallel on an
    (N, S, E) input; the MoE sample's 2-D tokens (an All2All column
    before, a row-parallel softmax after)."""
    got = _world(everything, mesh)[mesh, name]
    want = everything["jax"][name, None]
    assert got["roles"] == (
        ["column", "lastdim", "row", "column", "row"] if name == "stack"
        else ["column", "lastdim", "row"])
    _assert_state_close(got["state"], want)
    np.testing.assert_allclose(got["losses"], want["losses"], rtol=RTOL)
    assert got["errs"] == want["errs"]
    assert got["eval"][1] == want["eval"][1]


def test_moe_capacity_binds():
    """The MoE form drops tokens at its capacity (so that data 2 x model
    2 holds the global routing: a shard's own capacity would drop
    others)."""
    from veles_tpu_torch.ops import moe as om
    step = _port_wf("moe", init=_init("moe")).build_fused_step()
    dropped = []
    inner = om.top1_route

    def route(probs, capacity):
        out = inner(probs, capacity)
        dropped.append(int((~out[2]).sum()))
        return out
    om.top1_route = route
    try:
        step.train(step.init_state(), *_batches("moe")[0][0])
    finally:
        om.top1_route = inner
    assert dropped and dropped[0] > 0


@pytest.mark.parametrize("mesh", ALL_MESHES)
@pytest.mark.parametrize("name", ["dense", "moe", "one"])
def test_rank_shards_have_the_jax_shard_shapes(everything, name, mesh):
    got = _world(everything, mesh)[mesh, name]
    want = everything["jax"][name, mesh]["shards"]
    for rank, shapes in enumerate(got["shapes"]):
        assert set(shapes) == set(want)
        for path, by_device in want.items():
            assert shapes[path] == by_device[rank].shape, (rank, path)


@pytest.mark.parametrize("m", [2, 4])
@pytest.mark.parametrize("name", ["dense", "moe", "one"])
def test_shard_state_of_carried_params_is_the_jax_shard_contents(
        everything, name, m):
    """`convert.state_from_jax` carries the JAX gspmd state across; the
    port step's `shard_state` gives, rank by rank, the JAX shards'
    data."""
    ref = everything["jax"][name, (1, m)]
    carried = state_from_jax(ref, "cpu")
    for rank in range(m):
        mine = _port_step(name, m, rank).shard_state(carried)
        for path, by_device in ref["shards"].items():
            slot, i, k = path.split("/")
            np.testing.assert_array_equal(
                mine[slot][int(i)][k].detach().numpy(), by_device[rank],
                err_msg=f"rank {rank} {path}")


@pytest.mark.parametrize("mesh", ALL_MESHES)
def test_replicated_leaves_stay_equal_on_every_rank(everything, mesh):
    """`pos` beside the column-parallel embed, `w2` and `b2` of the
    row-parallel FFN and of the stack's column-parallel one, and every
    other replicated leaf, equal on every rank after 3 steps."""
    for name in ("dense", "moe", "stack"):
        kept = _world(everything, mesh)[mesh, name]["kept"]
        assert "params/0/pos" in kept[0] and "vel/0/pos" in kept[0]
        if name == "stack":
            assert {"params/3/w2", "params/3/b2"} <= set(kept[0])
        for other in kept[1:]:
            assert set(other) == set(kept[0])
            for k, a in kept[0].items():
                np.testing.assert_array_equal(other[k], a, err_msg=k)


def _is_bias(path):
    return path.endswith(("bias", "b2"))


@pytest.mark.parametrize("mesh", ALL_MESHES)
@pytest.mark.parametrize("group", ["bias", "other"])
def test_bf16_step_within_its_share_of_the_update(everything, mesh, group):
    """The bias vectors held against the JAX f32 step, every other leaf
    against the JAX bf16 step: XLA on the CPU sums a bias gradient over
    the N·S tokens in bf16 less accurately than an f32 sum rounded once
    (tests/test_torch_bf16_transformer.py); the port's local bf16 step
    is the same distance from the JAX bf16 step's biases."""
    got = _world(everything, mesh)[mesh, "bf16"]
    ref = everything["jax"]["dense", "bf16" if group == "other" else None]
    init = dict(_leaves(everything["init"][("dense", False)]))
    want = {k: a for k, a in _leaves(ref["params"])
            if _is_bias(k) == (group == "bias")}
    have = dict(_leaves(got["state"]["params"]))
    err = np.sqrt(sum(float(np.sum((have[k] - want[k]) ** 2))
                      for k in want))
    moved = np.sqrt(sum(float(np.sum((want[k] - init[k]) ** 2))
                        for k in want))
    assert 0 < err <= BF16_TOL * moved, (err, moved)
    np.testing.assert_allclose(got["losses"], everything["jax"][
        "dense", "bf16"]["losses"], rtol=1e-3)


@pytest.mark.parametrize("mesh", ALL_MESHES)
def test_adam_matches_the_local_step(everything, mesh):
    got = _world(everything, mesh)[mesh, "adam"]
    want = everything["port"]["adam"]
    _assert_state_close(got["state"], want["state"])
    np.testing.assert_allclose(got["losses"], want["losses"], rtol=RTOL)
    full = sum(a.size * 4 for _, a in _leaves(got["state"]["vel"]))
    assert all(b < full for b in got["opt_bytes"])


@pytest.mark.parametrize("mesh", ALL_MESHES)
def test_accum_repeat_many_and_confusion_under_gspmd(everything, mesh):
    got = _world(everything, mesh)[mesh, "surface"]
    want = everything["port"]["surface"]
    _assert_state_close(got["state"], want["state"])
    np.testing.assert_allclose(got["metrics"], want["metrics"], rtol=RTOL)
    np.testing.assert_array_equal(got["confusion"], want["confusion"])


@pytest.mark.parametrize("mesh", ALL_MESHES)
def test_flash_on_each_ranks_heads(everything, mesh):
    """`use_flash="on"`: the flash lowering (its plain version on the
    CPU) on the rank's whole heads at model 2, on every head gathered at
    model 4 (2 heads straddle 4 ranks); the local step's numbers and
    variant table."""
    got = _world(everything, mesh)[mesh, "flash"]
    want = everything["port"]["flash"]
    _assert_state_close(got["state"], want["state"])
    np.testing.assert_allclose(got["losses"], want["losses"], rtol=RTOL)
    assert got["table"] == want["table"]
    assert got["table"]["flash_attn"] != "mha"


@pytest.mark.parametrize("mesh", ALL_MESHES)
def test_rank_bytes_follow_the_plan(everything, mesh):
    got = _world(everything, mesh)[mesh, "moe"]
    plan = got["plan"]
    shard = 4 * sum(a.size // (mesh[1] if plan[int(p.split("/")[0])][
        p.split("/")[1]] else 1) for p, a in _leaves(got["state"]["vel"]))
    assert got["opt_bytes"] == [shard] * (mesh[0] * mesh[1])


def test_checkpoint_and_snapshot_restore_at_another_model_size(everything):
    """A checkpoint and a snapshot written at model 2 (data 2 x model 2,
    after 2 steps) restore at model 4 and in local mode; step 3 gives the
    uninterrupted run's state (the JAX local step's)."""
    from veles_tpu_torch.parallel import checkpoint
    w4 = everything["worlds"][4]
    want = everything["jax"]["dense", None]
    _assert_state_close(w4["ckpt"]["state"], want)
    _assert_state_close(w4["snap"]["state"], want)
    assert w4["ckpt"]["shapes"][1]["params/1/wq"] == (16, 4)
    wf = _port_wf("dense")
    step = wf.build_fused_step()
    st = checkpoint.restore_state(step, os.path.join(
        everything["snap_dir"], "ckpt"))
    for x, y, w in _batches("dense")[0][2:]:
        st, _ = step.train(st, x, y, w)
    _assert_state_close(_state(st), want)


CLI = {"char_transformer": ["root.char_transformer.decision.max_epochs=1",
                            "root.char_transformer.embed=16",
                            "root.char_transformer.ffn=24",
                            "root.char_transformer.n_heads=2",
                            "root.char_transformer.loader.minibatch_size=8"],
       "moe": ["root.moe.decision.max_epochs=1",
               "root.moe.loader.n_train=128",
               "root.moe.loader.n_validation=64"]}


@pytest.mark.parametrize("name", sorted(CLI))
def test_cli_trains_with_tp_2(tmp_path, name):
    """`-l`/`-m --tp 2` in two gloo processes on the toy char-transformer
    and on the MoE sample (the gspmd step, data 1 x model 2): both ranks
    print the fused local run's TRAINED line (its losses within 1e-5)."""
    argv = [sys.executable, "-m", "veles_tpu_torch",
            f"veles_tpu_torch/samples/{name}.py", "--device", "cpu", "-r",
            "3"] + CLI[name]
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
