"""The port stands alone: it imports neither JAX nor the JAX package, and
its entry points ask for the card unless told otherwise."""

import ast
import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import veles_tpu_torch
from veles_tpu_torch import backends, launcher, prng, root
from veles_tpu_torch.samples import alexnet
from veles_tpu_torch.serving import InferenceServer

REPO = Path(__file__).resolve().parent.parent
PKG = Path(veles_tpu_torch.__file__).resolve().parent
TOY = ["root.alexnet.loader.input_hw=67", "root.alexnet.width_mult=0.125",
       "root.alexnet.fc_width=64", "root.alexnet.n_classes=16",
       "root.alexnet.loader.n_train=8", "root.alexnet.loader.n_validation=4"]


@pytest.fixture(autouse=True, scope="module")
def _own_autotune_cache(tmp_path_factory):
    """A plain `--fused` run applies the autotune cache's winners: this
    module's runs read a cache of their own, not one under HOME."""
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("VELES_AUTOTUNE_CACHE",
                  str(tmp_path_factory.mktemp("autotune") / "autotune.json"))
        yield


def _forbidden(module: str) -> bool:
    """An import of JAX or of the JAX package: the module `veles_tpu`
    itself or anything under `veles_tpu.` — never a plain prefix match,
    which would hit `veles_tpu_torch`."""
    return any(module == m or module.startswith(m + ".")
               for m in ("veles_tpu", "jax", "jaxlib"))


def _imports(path: Path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module or ""


def test_forbidden_matches_the_module_not_a_prefix():
    assert _forbidden("veles_tpu") and _forbidden("veles_tpu.ops.xla")
    assert _forbidden("jax") and _forbidden("jax.numpy")
    assert not _forbidden("veles_tpu_torch")
    assert not _forbidden("veles_tpu_torch.ops.kernels")
    assert not _forbidden("jaxtyping")


@pytest.mark.parametrize("path", sorted(
    [p.relative_to(REPO).as_posix() for p in PKG.rglob("*.py")]
    + ["chip_smoke.py"]))
def test_no_jax_or_jax_package_import(path):
    bad = [m for m in _imports(REPO / path) if _forbidden(m)]
    assert not bad, f"{path} imports {bad}"


def test_every_module_imports_with_jax_blocked():
    code = (
        "import sys, importlib, pkgutil\n"
        "sys.modules['jax'] = None\n"
        "sys.modules['veles_tpu'] = None\n"
        "import veles_tpu_torch\n"
        "names = [m.name for m in pkgutil.walk_packages("
        "veles_tpu_torch.__path__, 'veles_tpu_torch.')]\n"
        "for n in names: importlib.import_module(n)\n"
        "assert not any(k == 'jax' or k.startswith(('jax.', 'veles_tpu.'))"
        " for k, v in sys.modules.items() if v is not None)\n"
        "print(len(names))\n")
    env = dict(os.environ, PYTHONPATH=str(REPO))
    r = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                       capture_output=True, text=True, timeout=120)
    assert r.returncode == 0, r.stderr[-2000:]
    assert int(r.stdout.strip()) >= 15


def _module_name(path: Path) -> str:
    parts = path.relative_to(REPO).with_suffix("").parts
    return ".".join(parts[:-1] if parts[-1] == "__init__" else parts)


MODULES = sorted(_module_name(p) for p in PKG.rglob("*.py"))


@pytest.fixture(scope="module")
def imports_with_jax_blocked():
    """{module: None or the error} of importing every module of the port
    in one fresh interpreter where `jax` and `veles_tpu` cannot be
    imported, plus whether either got loaded anyway."""
    code = (
        "import importlib, json, sys\n"
        "sys.modules['jax'] = None\n"
        "sys.modules['veles_tpu'] = None\n"
        f"names = {MODULES!r}\n"
        "out = {}\n"
        "for n in names:\n"
        "    try:\n"
        "        importlib.import_module(n)\n"
        "        out[n] = None\n"
        "    except Exception as e:\n"
        "        out[n] = repr(e)\n"
        "out['<jax loaded>'] = any(k == 'jax' or k.startswith(('jax.', "
        "'veles_tpu.')) for k, v in sys.modules.items() if v is not None)\n"
        "print(json.dumps(out))\n")
    env = dict(os.environ, PYTHONPATH=str(REPO))
    r = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                       capture_output=True, text=True, timeout=120)
    assert r.returncode == 0, r.stderr[-2000:]
    return json.loads(r.stdout.strip().splitlines()[-1])


#: the modules the local fused step's Adam, accumulation and checkpoint
#: added or extended: each among those the two tests above walk
LOCAL_STEP_MODULES = ["veles_tpu_torch.parallel.checkpoint",
                      "veles_tpu_torch.parallel.fused",
                      "veles_tpu_torch.ops.optim", "veles_tpu_torch.convert"]


@pytest.mark.parametrize("module", LOCAL_STEP_MODULES)
def test_local_step_modules_stand_alone(module, imports_with_jax_blocked):
    assert module in MODULES
    path = REPO / (module.replace(".", "/") + ".py")
    assert not [m for m in _imports(path) if _forbidden(m)]
    assert imports_with_jax_blocked[module] is None, \
        imports_with_jax_blocked[module]


#: the modules the granular Unit/Workflow graph added or extended
GRANULAR_MODULES = ["veles_tpu_torch.mutable", "veles_tpu_torch.units",
                    "veles_tpu_torch.workflow",
                    "veles_tpu_torch.distributable",
                    "veles_tpu_torch.memory", "veles_tpu_torch.backends",
                    "veles_tpu_torch.accelerated_units",
                    "veles_tpu_torch.ops.reference",
                    "veles_tpu_torch.znicz.nn_units",
                    "veles_tpu_torch.znicz.gd",
                    "veles_tpu_torch.znicz.gd_conv",
                    "veles_tpu_torch.znicz.gd_pooling",
                    "veles_tpu_torch.znicz.lr_adjust",
                    "veles_tpu_torch.znicz.evaluator",
                    "veles_tpu_torch.znicz.decision",
                    "veles_tpu_torch.loader.base",
                    "veles_tpu_torch.znicz.standard_workflow"]


@pytest.mark.parametrize("module", GRANULAR_MODULES)
def test_granular_modules_stand_alone(module, imports_with_jax_blocked):
    assert module in MODULES
    path = REPO / (module.replace(".", "/") + ".py")
    assert not [m for m in _imports(path) if _forbidden(m)]
    assert imports_with_jax_blocked[module] is None, \
        imports_with_jax_blocked[module]


#: the modules the samples slice (MNIST, CIFAR-10 and the unit families
#: around them) added or extended
SAMPLES_MODULES = ["veles_tpu_torch.znicz.activation",
                   "veles_tpu_torch.znicz.pooling",
                   "veles_tpu_torch.znicz.gd_pooling",
                   "veles_tpu_torch.znicz.normalization",
                   "veles_tpu_torch.znicz.evaluator",
                   "veles_tpu_torch.ops.functional",
                   "veles_tpu_torch.parallel.fused",
                   "veles_tpu_torch.loader.fullbatch",
                   "veles_tpu_torch.loader.synthetic",
                   "veles_tpu_torch.samples.mnist",
                   "veles_tpu_torch.samples.mnist_simple",
                   "veles_tpu_torch.samples.wine",
                   "veles_tpu_torch.samples.cifar10"]


@pytest.mark.parametrize("module", SAMPLES_MODULES)
def test_samples_modules_stand_alone(module, imports_with_jax_blocked):
    assert module in MODULES
    path = REPO / (module.replace(".", "/") + ".py")
    assert not [m for m in _imports(path) if _forbidden(m)]
    assert imports_with_jax_blocked[module] is None, \
        imports_with_jax_blocked[module]


#: the modules the granular char-transformer, the granular snapshots and
#: resume, and the conv_stem lowering added or extended
GRANULAR_TRANSFORMER_MODULES = [
    "veles_tpu_torch.znicz.nn_units", "veles_tpu_torch.znicz.attention",
    "veles_tpu_torch.znicz.transformer", "veles_tpu_torch.znicz.conv",
    "veles_tpu_torch.znicz.evaluator",
    "veles_tpu_torch.znicz.standard_workflow",
    "veles_tpu_torch.ops.functional", "veles_tpu_torch.ops.variants",
    "veles_tpu_torch.loader.base", "veles_tpu_torch.loader.synthetic",
    "veles_tpu_torch.samples.char_transformer",
    "veles_tpu_torch.snapshotter", "veles_tpu_torch.launcher",
    "veles_tpu_torch.resilience.supervisor", "veles_tpu_torch.convert"]


@pytest.mark.parametrize("module", GRANULAR_TRANSFORMER_MODULES)
def test_granular_transformer_modules_stand_alone(module,
                                                  imports_with_jax_blocked):
    assert module in MODULES
    path = REPO / (module.replace(".", "/") + ".py")
    assert not [m for m in _imports(path) if _forbidden(m)]
    assert imports_with_jax_blocked[module] is None, \
        imports_with_jax_blocked[module]


@pytest.mark.parametrize("module", MODULES)
def test_module_imports_with_jax_blocked(module, imports_with_jax_blocked):
    assert imports_with_jax_blocked[module] is None, \
        imports_with_jax_blocked[module]
    assert imports_with_jax_blocked["<jax loaded>"] is False


def test_entry_points_ask_for_the_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        backends.make_device()
    assert backends.make_device("cpu") == torch.device("cpu")
    wf = alexnet.create_workflow(input_hw=67, width_mult=0.125, fc_width=8,
                                 n_classes=4, n_train=4, n_validation=2)
    with pytest.raises(RuntimeError, match="CUDA"):
        wf.initialize()
    with pytest.raises(RuntimeError, match="CUDA"):
        InferenceServer(wf)
    with pytest.raises(RuntimeError, match="CUDA"):
        wf.initialize(backend="torch")
    with pytest.raises(RuntimeError, match="CUDA"):
        wf.run_epochs(1)
    saved = root.alexnet.to_dict()
    try:
        with pytest.raises(RuntimeError, match="CUDA"):
            launcher.serve([str(PKG / "samples" / "alexnet.py"), "--serve",
                            "0", *TOY])
        # the granular graph's default backend is the card's
        with pytest.raises(RuntimeError, match="CUDA"):
            launcher.train([str(PKG / "samples" / "alexnet.py"), *TOY])
    finally:
        root.alexnet = saved    # the CLI's overrides stay in this test
    assert not wf.is_initialized


def test_the_kernel_search_asks_for_the_card(monkeypatch, tmp_path):
    """`--autotune`, the tool and the search run on the card unless the
    CPU is asked for."""
    from veles_tpu_torch.ops import autotune
    from veles_tpu_torch.tools import autotune as tool
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    monkeypatch.setenv("VELES_AUTOTUNE_CACHE", str(tmp_path / "c.json"))
    with pytest.raises(SystemExit) as e:
        tool.main(["--budget", "4"])
    assert e.value.code == 2
    with pytest.raises(RuntimeError, match="CUDA"):
        autotune.search_op("sgd_update", budget=2)
    saved = root.alexnet.to_dict()
    try:
        with pytest.raises(RuntimeError, match="CUDA"):
            launcher.train([str(PKG / "samples" / "alexnet.py"), "--fused",
                            "--autotune", *TOY])
    finally:
        root.alexnet = saved
    assert not (tmp_path / "c.json").exists()


#: the modules the kernel search added or extended
KERNEL_SEARCH_MODULES = ["veles_tpu_torch.analysis",
                         "veles_tpu_torch.analysis.findings",
                         "veles_tpu_torch.analysis.resources",
                         "veles_tpu_torch.ops.templates",
                         "veles_tpu_torch.ops.autotune",
                         "veles_tpu_torch.ops.variants",
                         "veles_tpu_torch.ops.kernels",
                         "veles_tpu_torch.ops.functional",
                         "veles_tpu_torch.tools",
                         "veles_tpu_torch.tools.autotune",
                         "veles_tpu_torch.parallel.fused",
                         "veles_tpu_torch.znicz.conv",
                         "veles_tpu_torch.znicz.pooling",
                         "veles_tpu_torch.znicz.normalization",
                         "veles_tpu_torch.znicz.attention",
                         "veles_tpu_torch.znicz.standard_workflow",
                         "veles_tpu_torch.launcher"]


@pytest.mark.parametrize("module", KERNEL_SEARCH_MODULES)
def test_kernel_search_modules_stand_alone(module, imports_with_jax_blocked):
    assert module in MODULES
    rel = module.replace(".", "/")
    path = REPO / (rel + ".py")
    if not path.exists():
        path = REPO / rel / "__init__.py"
    assert not [m for m in _imports(path) if _forbidden(m)]
    assert imports_with_jax_blocked[module] is None, \
        imports_with_jax_blocked[module]


#: the modules the serving slice (the bf16 and int8 wires, the merge core,
#: hot swap and rollback, the watcher over the snapshot mirror) added or
#: extended
SERVING_MODULES = ["veles_tpu_torch.serving",
                   "veles_tpu_torch.serving_gen",
                   "veles_tpu_torch.serving_aot",
                   "veles_tpu_torch.serving_watch",
                   "veles_tpu_torch.http_util",
                   "veles_tpu_torch.resilience.mirror",
                   "veles_tpu_torch.resilience.backoff",
                   "veles_tpu_torch.resilience.faults",
                   "veles_tpu_torch.resilience.supervisor",
                   "veles_tpu_torch.snapshotter",
                   "veles_tpu_torch.ops.variants",
                   "veles_tpu_torch.ops.templates",
                   "veles_tpu_torch.launcher"]


@pytest.mark.parametrize("module", SERVING_MODULES)
def test_serving_modules_stand_alone(module, imports_with_jax_blocked):
    assert module in MODULES
    path = REPO / (module.replace(".", "/") + ".py")
    assert not [m for m in _imports(path) if _forbidden(m)]
    assert imports_with_jax_blocked[module] is None, \
        imports_with_jax_blocked[module]


#: the modules the fleet and export slice (replicas, beacons, the router,
#: the native export and engine) added or extended
FLEET_MODULES = ["veles_tpu_torch.serving_router",
                 "veles_tpu_torch.export",
                 "veles_tpu_torch.native_engine",
                 "veles_tpu_torch.resilience.clock"]


@pytest.mark.parametrize("module", FLEET_MODULES)
def test_fleet_modules_stand_alone(module, imports_with_jax_blocked):
    assert module in MODULES
    path = REPO / (module.replace(".", "/") + ".py")
    assert not [m for m in _imports(path) if _forbidden(m)]
    assert imports_with_jax_blocked[module] is None, \
        imports_with_jax_blocked[module]


#: the modules the serialized serving program and the data-parallel
#: slice (the mesh, the process group, memory accounting, the
#: grad_reduce family, the dp step, the loaders' rows, the CLI) added or
#: extended
DP_AOT_MODULES = ["veles_tpu_torch.serving_aot",
                  "veles_tpu_torch.serving",
                  "veles_tpu_torch.export",
                  "veles_tpu_torch.ops.kernels",
                  "veles_tpu_torch.ops.variants",
                  "veles_tpu_torch.parallel.mesh",
                  "veles_tpu_torch.parallel.distributed",
                  "veles_tpu_torch.parallel.memstats",
                  "veles_tpu_torch.parallel.fused",
                  "veles_tpu_torch.parallel.checkpoint",
                  "veles_tpu_torch.loader.base",
                  "veles_tpu_torch.znicz.standard_workflow",
                  "veles_tpu_torch.launcher"]


@pytest.mark.parametrize("module", DP_AOT_MODULES)
def test_dp_and_aot_modules_stand_alone(module, imports_with_jax_blocked):
    assert module in MODULES
    path = REPO / (module.replace(".", "/") + ".py")
    assert not [m for m in _imports(path) if _forbidden(m)]
    assert imports_with_jax_blocked[module] is None, \
        imports_with_jax_blocked[module]


def test_dp_entry_points_ask_for_the_card(monkeypatch):
    """A rank's device is its card; without CUDA the rank's device and
    the default (NCCL) process group are refused, as every other entry
    point refuses, until the caller asks for the CPU. Memory statistics
    never initialize CUDA, and a process without a group is its own
    coordinator."""
    from veles_tpu_torch.parallel import distributed, memstats, mesh
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 2)
    monkeypatch.delenv("LOCAL_RANK", raising=False)
    assert mesh.default_device(3) == torch.device("cuda", 1)
    monkeypatch.setenv("LOCAL_RANK", "0")
    assert mesh.default_device(3) == torch.device("cuda", 0)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="--device cpu"):
        mesh.default_device(3)
    import torch.distributed as dist
    monkeypatch.setattr(dist, "is_initialized", lambda: False)

    def no_group(*args, **kwargs):
        raise AssertionError("a process group was started")

    monkeypatch.setattr(dist, "init_process_group", no_group)
    with pytest.raises(RuntimeError, match="--device cpu"):
        distributed.initialize_distributed("127.0.0.1:1", 0, 1)
    monkeypatch.setattr(torch.cuda, "is_initialized", lambda: False)
    assert memstats.device_memory_stats() is None
    assert memstats.device_memory_limits() is None
    assert memstats.bytes_per_device(
        [torch.zeros(3), torch.zeros(2, dtype=torch.float64), "x"]) \
        == {"cpu": 28}
    assert distributed.is_coordinator()
    with pytest.raises(RuntimeError, match="process group"):
        mesh.make_mesh()


def test_torch_generator_follows_the_seed(monkeypatch):
    monkeypatch.setattr(prng, "_generators", {})
    monkeypatch.setattr(prng, "_base_seed", None)
    prng.seed_all(11)
    a = torch.rand(4, generator=prng.get().torch_generator("cpu"))
    b = torch.rand(4, generator=prng.get().torch_generator("cpu"))
    np.testing.assert_array_equal(a.numpy(), b.numpy())
    assert prng.get("other").state.get_state()[1][0] \
        == np.random.RandomState(12).get_state()[1][0]


#: the supervisor's parent imports these: they must not import torch (so
#: the parent never initializes CUDA on the card its children use)
TORCH_FREE = ["veles_tpu_torch.launcher", "veles_tpu_torch.snapshotter",
              "veles_tpu_torch.resilience",
              "veles_tpu_torch.resilience.mirror",
              "veles_tpu_torch.http_util",
              "veles_tpu_torch.serving_gen",
              "veles_tpu_torch.serving_aot",
              "veles_tpu_torch.resilience.backoff",
              "veles_tpu_torch.resilience.clock",
              "veles_tpu_torch.resilience.faults",
              "veles_tpu_torch.resilience.hooks",
              "veles_tpu_torch.resilience.supervisor",
              "veles_tpu_torch.serving_router"]


@pytest.mark.parametrize("module", TORCH_FREE)
def test_supervisor_side_modules_import_without_torch(module):
    code = ("import importlib, sys\n"
            "sys.modules['torch'] = None\n"
            f"importlib.import_module({module!r})\n")
    env = dict(os.environ, PYTHONPATH=str(REPO))
    r = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                       capture_output=True, text=True, timeout=120)
    assert r.returncode == 0, r.stderr[-2000:]


#: the modules the experts and pipeline slice (the switch MoE, expert
#: parallelism in the dp step, the GPipe pipeline, --pp/--ep) added or
#: extended
MOE_PP_MODULES = ["veles_tpu_torch.ops.moe", "veles_tpu_torch.znicz.moe",
                  "veles_tpu_torch.samples.moe",
                  "veles_tpu_torch.samples.char_transformer",
                  "veles_tpu_torch.parallel.pipeline",
                  "veles_tpu_torch.parallel.fused",
                  "veles_tpu_torch.parallel.checkpoint",
                  "veles_tpu_torch.export", "veles_tpu_torch.convert",
                  "veles_tpu_torch.znicz.standard_workflow",
                  "veles_tpu_torch.launcher"]


@pytest.mark.parametrize("module", MOE_PP_MODULES)
def test_moe_and_pipeline_modules_stand_alone(module,
                                              imports_with_jax_blocked):
    assert module in MODULES
    path = REPO / (module.replace(".", "/") + ".py")
    assert not [m for m in _imports(path) if _forbidden(m)]
    assert imports_with_jax_blocked[module] is None, \
        imports_with_jax_blocked[module]


def test_moe_and_pipeline_entry_points_ask_for_the_card(monkeypatch):
    """`--pp`, `run_pipelined`, the stage list and `--ep` run on the card
    unless the CPU is asked for; nothing falls back to it, and no process
    group starts."""
    import torch.distributed as dist

    from veles_tpu_torch.parallel import pipeline
    from veles_tpu_torch.samples import moe
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)

    def no_group(*args, **kwargs):
        raise AssertionError("a process group was started")

    monkeypatch.setattr(dist, "init_process_group", no_group)
    with pytest.raises(RuntimeError, match="CUDA"):
        pipeline.make_stage_mesh()
    sample = str(PKG / "samples" / "moe.py")
    small = ["root.moe.loader.n_train=64", "root.moe.loader.n_validation=64"]
    saved = root.moe.to_dict()
    try:
        wf = moe.create_workflow()
        with pytest.raises(RuntimeError, match="CUDA"):
            wf.run_pipelined(n_microbatches=2)
        assert not wf.is_initialized
        with pytest.raises(RuntimeError, match="CUDA"):
            launcher.train([sample, "--pp", "2", *small])
        with pytest.raises(RuntimeError, match="--device cpu"):
            launcher.train([sample, "-l", "127.0.0.1:1", "--n-processes",
                            "1", "--ep", *small])
    finally:
        root.moe = saved


TP_MODULES = ["veles_tpu_torch.parallel.tp", "veles_tpu_torch.parallel.mesh",
              "veles_tpu_torch.parallel.fused",
              "veles_tpu_torch.parallel.checkpoint",
              "veles_tpu_torch.znicz.conv", "veles_tpu_torch.znicz.all2all",
              "veles_tpu_torch.znicz.dropout",
              "veles_tpu_torch.znicz.pooling",
              "veles_tpu_torch.znicz.activation",
              "veles_tpu_torch.znicz.standard_workflow",
              "veles_tpu_torch.launcher"]


@pytest.mark.parametrize("module", TP_MODULES)
def test_tp_modules_stand_alone(module, imports_with_jax_blocked):
    assert module in MODULES
    path = REPO / (module.replace(".", "/") + ".py")
    assert not [m for m in _imports(path) if _forbidden(m)]
    assert imports_with_jax_blocked[module] is None, \
        imports_with_jax_blocked[module]


def test_tp_entry_points_ask_for_the_card(monkeypatch):
    """`-l --tp 2` runs on the card unless the CPU is asked for: without
    CUDA it is refused before any process group starts, and the gspmd
    step's mesh asks for the card as every rank's does."""
    import torch.distributed as dist

    from veles_tpu_torch.parallel import mesh
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)

    def no_group(*args, **kwargs):
        raise AssertionError("a process group was started")

    monkeypatch.setattr(dist, "init_process_group", no_group)
    with pytest.raises(RuntimeError, match="--device cpu"):
        launcher.train(["veles_tpu_torch/samples/mnist.py", "-l",
                        "127.0.0.1:1", "--n-processes", "2", "--tp", "2"])
    with pytest.raises(RuntimeError, match="--device cpu"):
        mesh.default_device(1)
