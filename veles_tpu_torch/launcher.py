"""Command line of the port: build a sample workflow, or restore it from
a snapshot, then train or serve it, optionally under the supervisor.

`python -m veles_tpu_torch WORKFLOW.py [--fused | --pp M | --serve PORT]
[-b torch|numpy] [-s SNAPSHOT] [--device cpu] [-r SEED]
[--lrn-maxpool fused|composed] [--feed-ahead N] [--accum K]
[--autotune [--autotune-budget N]] [--nonfinite-guard] [--mirror SPEC]
[--serve-ring N] [--serve-batch N] [--serve-dispatch ring|merge]
[--serve-quantize f32|bf16|int8] [--serve-watch-mirror SPEC]
[--serve-replicas N] [--serve-announce SPEC] [root.x=y ...]`,
and in either training mode also `--supervise [--max-restarts N]
[--stall-timeout S] [--snapshot-dir DIR] [--snapshot-prefix P]
[--supervise-report PATH]` — the port's counterpart of
`veles_tpu/__main__.py` and of `veles_tpu/launcher.py`'s training and
serving branches. The workflow module keeps the reference's
`run(load, main)` convention: it registers its `root` defaults when
imported, the trailing overrides win over them, `load(create_workflow)`
builds the workflow (under `-s`, restores it from the snapshot instead
and returns `(workflow, True)`, JAX launcher.py:369-382), and `main()`
trains it through the fused step (`--fused`), starts the server on it
(`--serve`; a restored workflow serves the snapshot's weights), or,
with neither flag, trains it through the granular Unit/Workflow graph
(JAX launcher.py:908-918: `initialize(device)`, then `run()`), each unit
firing on its backend: `-b torch` (the default, the counterpart of the
JAX package's `xla`) runs each unit's `torch_run` on the card, or on the
CPU under `--device cpu`; `-b numpy` runs each unit's `numpy_run`, the
host goldens. `--nonfinite-guard`, `-s` and `--supervise` work in
either training mode: a workflow restored for the granular graph moves
to the backend's device and continues at the pulse after its
snapshot's. `--accum` and `--feed-ahead`, which tune the fused step and
its device feed, are refused without `--fused`.

The serving knobs (JAX launcher.py:104-160, __main__.py:140-176 there)
need `--serve`: `--serve-batch` caps a request's rows (the ring's rows
when not given: the JAX cap is 64 whatever the ring), `--serve-ring`
sizes the ring and must hold a whole `--serve-batch` request,
`--serve-dispatch merge` runs the bucketed pre-ring core (no ring, no
quantized wire, no watcher), `--serve-quantize bf16|int8` serves a
low-byte wire of the parameters (refused unserved without a passing
equivalence record or beyond 0.05 of the f32 forward), and
`--serve-watch-mirror SPEC` polls a snapshot mirror (a directory or an
http(s) URL) every $VELES_WATCH_POLL_S seconds (10) and hot-swaps each
new snapshot into the running ring (serving_watch.py). Where
$VELES_SERVING_AOT_CACHE names an index file, the ring serves its
serialized program from that cache, exported at the first start
(serving_aot.py; a program is code: trust the directory as the python
environment).

The fleet (JAX launcher.py:698-790): `--serve-replicas N` starts N
servers of one workflow build in this process (`--serve PORT` gives them
PORT..PORT+N-1, `--serve 0` lets each pick its own), each with its own
ring, generation ledger and watcher; a replica's id is `r{i}-{pid}`, or
`r{i}-{host}` under $VELES_SERVE_ADVERTISE, whose host also goes into
the URL its beacon advertises. `--serve-announce SPEC` publishes one
presence beacon per replica on that mirror bus (serving_router.py), for
a router to discover. SIGTERM and Ctrl-C stop a fleet by its drain
protocol: the beacons say "draining", the watchers stop, the servers
stop (finishing their in-flight rounds), the beacons say "gone". Two
modes take no workflow and never import torch (JAX __main__.py:521-571):
`--route SPEC [--route-port P]` runs the fleet's router over the beacons
on SPEC and prints `ROUTING http://127.0.0.1:P`; `--serve-rollback URL`
POSTs /rollback to a server or a router, prints the answer, and exits 0
when it applied, 1 on a refusal or a transport failure. Both read the
shared token from $VELES_WEB_TOKEN. `--mirror SPEC`
is the trainer's: every snapshot the run writes is pushed there, and
`--supervise` restarts restore from it when the snapshot directory
cannot satisfy them.

`--autotune` (with `--fused`) times the candidate lowerings of the
workflow's tunable ops on the card before training, trains with the
winners and caches them (ops/autotune.py; `--autotune-budget N` also
searches the generated kernel points); a plain `--fused` run applies the
cached winners without timing anything (`apply_cached`, JAX
launcher.py:787-813). The cache is $VELES_AUTOTUNE_CACHE, else
~/.cache/veles_tpu_torch/autotune.json.

Data-parallel training over several processes (JAX __main__.py:60-67,
:261; launcher.py:340-365, :874-888): `-l HOST:PORT` founds the process
group (the coordinator, `--process-id 0`) and `-m HOST:PORT` joins it,
each process with its `--process-id` and the group's `--n-processes`;
every process runs the same command, one card each (`LOCAL_RANK`, else
the process id modulo the host's cards; gloo on the CPU under `--device
cpu`), and trains the fused step in dp mode on the global minibatches
(parallel/fused.py; `--fused` is implied, as in the JAX launcher).
`--zero-sharding {on,off,auto}` gates its ZeRO update ("auto", the
default: on wherever the data axis has more than one rank; "on" shards it
on one rank too) and needs `--fused` or `-l`/`-m`. Snapshots are written
by the coordinator alone (`-s` restores on every rank: a snapshot holds
the gathered velocities, so it restores at any world size).
`--autotune`, `--serve` and `--supervise` refuse `-l`/`-m`. `--ep`
(with `-l`/`-m` only) shards the MoE layers' experts over the ranks
(the fused step's `ep=True`). `--tp K` (JAX __main__.py:242-245,
launcher.py:202-212) lays the ranks out as data x model=K
(`make_mesh(model=K)`: data outermost, model innermost, as in JAX: rank
= d*K + m), and the step's mode "auto" makes K > 1 its gspmd mode, the
megatron column/row plan (the last-dim rule for attention and MoE) over
each data shard's K ranks (parallel/tp.py): AlexNet, the
char-transformer, dense or MoE, and every sample train under it; K >= 1,
K > 1 only with `-l`/`-m`, and exclusive with `--ep` and `--pp`. `--sp` (sequence parallelism) is refused until the
slice that ports it.

`--pp M` trains the chain as a GPipe pipeline of M microbatches
(`StandardWorkflow.run_pipelined`, parallel/pipeline.py): one stage per
visible card, capped at the unit count, in this one process (one card:
one stage; `--device cpu`: one CPU stage). It is exclusive with
`--fused`, `--accum`, `--ep`, `--tp`, `--serve` and `-l`/`-m`, takes
`--autotune`, `--feed-ahead` and
`--nonfinite-guard` as `--fused` does, and `--zero-sharding on` only
with a warning (JAX launcher.py:184-236, :276-282).

`--supervise` makes this process the supervisor
(`resilience/supervisor.py`) of a child running the same command line
without the supervisor's flags: it is routed before torch is imported,
so the parent never touches the card. A training child writes the
heartbeat the supervisor reads (`VELES_HEARTBEAT_FILE`) at startup and
at each epoch, a fault plan (`VELES_FAULT_PLAN`) rides the same epoch
hooks, and a non-finite loss under `--nonfinite-guard` exits with
`EXIT_NONFINITE` (81), on which the supervisor rolls back one snapshot.

Import-light: torch and the workflow machinery are imported where a run
starts, not here (the supervisor's parent imports this module).
"""

from __future__ import annotations

import argparse
import importlib.util
import os
import signal
import sys
import threading
from typing import List, Optional

from veles_tpu_torch.config import parse_override, root
from veles_tpu_torch.serving_aot import AOT_CACHE_ENV
from veles_tpu_torch.logger import set_verbosity


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="veles_tpu_torch",
        description="Train or serve a workflow: veles_tpu_torch "
                    "workflow.py [--fused | --serve PORT] "
                    "[root.path.key=value ...]; without either flag it "
                    "trains through the granular unit graph",
        allow_abbrev=False)
    p.add_argument("workflow", nargs="?", default=None,
                   help="workflow module (.py) with run(load, main); none "
                        "under --route and --serve-rollback")
    p.add_argument("overrides", nargs="*", default=[],
                   help="trailing root.a.b=value overrides")
    p.add_argument("--fused", action="store_true",
                   help="train through the fused step until the workflow's "
                        "decision completes")
    p.add_argument("--pp", type=int, default=None, metavar="M",
                   help="train the chain as a GPipe pipeline of M "
                        "microbatches, one stage per visible card "
                        "(capped at the unit count)")
    p.add_argument("--serve", type=int, default=None, metavar="PORT",
                   help="serve the workflow's forward over HTTP on PORT "
                        "(0 picks a free port)")
    p.add_argument("-b", "--backend", default="torch",
                   choices=("torch", "numpy"),
                   help="backend of the granular graph's units (numpy = "
                        "the golden host path); without --fused and "
                        "--serve only")
    p.add_argument("-s", "--snapshot", default="",
                   help="restore the workflow from this snapshot file "
                        "instead of building it (resume a run, or serve "
                        "its weights)")
    p.add_argument("--device", default=None,
                   help="torch device (default: cuda; 'cpu' must be asked "
                        "for)")
    p.add_argument("-r", "--random-seed", type=int, default=None,
                   help="seed all PRNGs for a deterministic run")
    p.add_argument("--lrn-maxpool", choices=("fused", "composed"),
                   default=None,
                   help="lowering of adjacent LRN -> max pooling pairs "
                        "(default: the registry's, fused)")
    p.add_argument("--feed-ahead", type=int, default=None, metavar="N",
                   help="batches the device feed uploads ahead of the "
                        "step (default 1; 0 uploads each on demand); "
                        "--fused only")
    p.add_argument("--accum", type=int, default=None, metavar="K",
                   help="gradient accumulation: compute each minibatch's "
                        "gradient as K microbatches before its one "
                        "update (--fused; activation memory /K, the "
                        "full batch's gradient)")
    p.add_argument("--autotune", action="store_true",
                   help="before training, time the candidate lowerings of "
                        "the workflow's tunable ops (LRN, max pooling, "
                        "the stem convolution, the LRN->pool pair, the "
                        "SGD update, attention) in its fused step on the "
                        "card and train with the winners; decisions "
                        "persist in the autotune cache "
                        "($VELES_AUTOTUNE_CACHE), so a rerun times "
                        "nothing; --fused only")
    p.add_argument("--autotune-budget", type=int, default=None,
                   metavar="N",
                   help="with --autotune: spend up to N trials on a "
                        "coordinate-descent search over the generated "
                        "kernel points (K1-K4's launch shapes, K6/K7's "
                        "key order and dropout epilogue, the stem's and "
                        "the pool's lowerings), each gated by its "
                        "reference contract and the card's shared memory "
                        "before it is timed")
    p.add_argument("-l", "--listen", default="", metavar="HOST:PORT",
                   help="found the data-parallel process group at this "
                        "address (the coordinator, --process-id 0)")
    p.add_argument("-m", "--master", default="", metavar="HOST:PORT",
                   help="join the data-parallel process group at this "
                        "address")
    p.add_argument("--process-id", type=int, default=0,
                   help="this process's rank in the distributed job")
    p.add_argument("--n-processes", type=int, default=1,
                   help="total process count in the distributed job")
    p.add_argument("--zero-sharding", nargs="?", const="on",
                   default="auto", choices=("on", "off", "auto"),
                   metavar="{on,off,auto}",
                   help="ZeRO-sharded update of the fused dp step: "
                        "reduce-scatter the gradients, update this rank's "
                        "1/N slice of the parameters and optimizer state, "
                        "all-gather the parameters (default auto: on "
                        "wherever the data axis has more than one rank)")
    p.add_argument("--ep", action="store_true",
                   help="expert parallelism of a distributed -l/-m run: "
                        "shard the MoE layers' experts over the ranks, "
                        "tokens exchanged by all-to-all")
    p.add_argument("--tp", type=int, default=None, metavar="K",
                   help="tensor-parallel degree for distributed runs: "
                        "global mesh (data x model=K), megatron gspmd "
                        "step; combine with -l/-m")
    p.add_argument("--sp", type=int, default=None, metavar="K",
                   help="sequence-parallel degree (refused: ring and "
                        "Ulysses attention come with a later slice)")
    p.add_argument("--nonfinite-guard", action="store_true",
                   help="abort training with exit code 81 the moment the "
                        "loss goes NaN/inf (the supervisor then rolls "
                        "back one snapshot before retrying)")
    # the supervisor's own flags: one group, which supervisor_flags()
    # reads to strip them from the child's command line
    sup = p.add_argument_group("supervisor (--supervise)")
    p.supervisor_actions = [
        sup.add_argument("--supervise", action="store_true",
                         help="run under the supervisor: this process "
                              "becomes a light parent that spawns the "
                              "training run, watches its per-epoch "
                              "heartbeat, and on a crash or hang restarts "
                              "it from the newest VALID snapshot "
                              "(exponential backoff, bounded retries, "
                              "no-progress cutoff)"),
        sup.add_argument("--max-restarts", type=int, default=3,
                         metavar="N",
                         help="supervisor retry budget: give up after N "
                              "restarts (default 3)"),
        sup.add_argument("--stall-timeout", type=float, default=300.0,
                         metavar="SECONDS",
                         help="supervisor hang detection: kill and "
                              "restart the job when its heartbeat "
                              "(touched every epoch) goes stale this long "
                              "(default 300; 0 disables)"),
        sup.add_argument("--snapshot-dir", default=None, metavar="DIR",
                         help="where the supervisor looks for snapshots "
                              "to restart from (default: cwd)"),
        sup.add_argument("--snapshot-prefix", default="", metavar="PREFIX",
                         help="snapshot filename prefix filter for "
                              "--supervise restarts"),
        sup.add_argument("--supervise-report", default="", metavar="PATH",
                         help="write the supervisor's JSON exit report "
                              "(attempt log, outcome) to PATH"),
    ]
    p.add_argument("--mirror", default="", metavar="SPEC",
                   help="snapshot mirror of a training run: a second "
                        "directory or an http(s):// blob store; every "
                        "snapshot written is pushed there (sha256-verified, "
                        "idempotent) and --supervise restarts restore from "
                        "it when the snapshot directory cannot")
    p.add_argument("--serve-ring", type=int, default=None, metavar="N",
                   help="rows in the ring batch (default: --serve-batch, "
                        "else 64); --serve only")
    p.add_argument("--serve-batch", type=int, default=None, metavar="N",
                   help="most rows one request may send (default: the "
                        "ring's); --serve only")
    p.add_argument("--serve-dispatch", default=None,
                   choices=("ring", "merge"),
                   help="serving core: 'ring' (default) = the slot ring; "
                        "'merge' = the bucketed micro-batching baseline; "
                        "--serve only")
    p.add_argument("--serve-quantize", default=None,
                   choices=("f32", "bf16", "int8"),
                   help="wire format of the served parameters: bf16 halves "
                        "the model bytes, int8 (weight-only, blockwise) "
                        "quarters them; refused unserved without a passing "
                        "equivalence record; --serve only")
    p.add_argument("--serve-watch-mirror", default=None, metavar="SPEC",
                   help="poll this snapshot mirror (a directory or an "
                        "http(s) URL) for new snapshots and hot-swap each "
                        "into the running ring after it verifies (poll "
                        "every $VELES_WATCH_POLL_S s, 10); --serve only")
    p.add_argument("--serve-replicas", type=int, default=None, metavar="N",
                   help="run N serving replicas of one workflow build in "
                        "this process, each with its own ring, port "
                        "(--serve PORT -> PORT..PORT+N-1; 0 -> each its "
                        "own), generation ledger and watcher; --serve "
                        "only")
    p.add_argument("--serve-announce", default=None, metavar="SPEC",
                   help="announce each serving replica as a presence "
                        "beacon on this mirror bus (a directory or an "
                        "http(s) URL), for a --route router to discover; "
                        "--serve only")
    p.add_argument("--route", default=None, metavar="SPEC",
                   help="router mode (no workflow, no torch): discover the "
                        "replicas announced on this mirror bus and route "
                        "POST /predict across them by live capacity, with "
                        "bounded retry, a circuit breaker per replica, "
                        "hedging at the measured p99 and drain awareness; "
                        "POST /rollback fans out to every replica (token "
                        "from $VELES_WEB_TOKEN)")
    p.add_argument("--route-port", type=int, default=None, metavar="PORT",
                   help="listen port of --route (default: any free one)")
    p.add_argument("--serve-rollback", default=None, metavar="URL",
                   help="client mode (no workflow): POST /rollback to the "
                        "server or router at URL, print the answer and "
                        "exit 0 when it applied, 1 else (token from "
                        "$VELES_WEB_TOKEN)")
    p.add_argument("--serve-token", default=None,
                   help="shared token /predict requires in X-Veles-Token")
    p.add_argument("--serve-max-body", type=int, default=32 << 20,
                   metavar="BYTES",
                   help="largest /predict body a server (or a --route "
                        "router) accepts (413 above it); a full-size "
                        "227x227x3 row is ~1-3 MB of JSON")
    p.add_argument("-v", "--verbose", action="count", default=0,
                   help="-v info, -vv debug")
    return p


def parse_args(argv: Optional[List[str]] = None) -> argparse.Namespace:
    """Parse `argv`: at most one of --fused and --serve, and the flags
    each mode takes (exit 2 else)."""
    p = build_parser()
    args = p.parse_intermixed_args(argv)
    # the workflow-less modes and their refusals (JAX __main__.py:521-609
    # there, which exit 1 with these messages)
    if args.serve_rollback:
        if args.workflow:
            raise SystemExit("--serve-rollback is a client mode: it "
                             "takes no workflow argument")
        return args
    if args.route:
        if args.workflow:
            raise SystemExit("--route is a router mode: it takes no "
                             "workflow argument")
        return args
    if args.route_port is not None:
        raise SystemExit("--route-port configures the fleet router: "
                         "combine with --route")
    if not args.workflow:
        raise SystemExit("workflow module required (or --serve-rollback "
                         "URL / --route SPEC for workflow-less modes)")
    if args.fused and args.serve is not None:
        p.error("--fused trains and --serve serves: give one of them")
    # the tensor-parallel degree's refusals (JAX launcher.py:206-212,
    # :225-232 there)
    if args.tp is not None and args.tp < 1:
        raise SystemExit(f"--tp needs K >= 1 (got {args.tp})")
    if args.tp and args.tp > 1 and not (args.listen or args.master):
        raise SystemExit("--tp shards over the distributed global "
                         "mesh: combine with -l/-m (single-process "
                         "TP uses build_fused_step(mesh=...) directly)")
    if args.sp is not None:
        raise SystemExit("--sp: sequence parallelism (the fused step's "
                         "seq mode, ring and Ulysses attention) comes with "
                         "the next many-GPU slice (ROADMAP Queue 1 item "
                         "1(b))")
    if args.ep and args.tp and args.tp > 1:
        raise SystemExit("--ep composes with the data axis; it is "
                         "exclusive with --tp/--sp in this launcher")
    # the GPipe pipeline's refusals (JAX launcher.py:184-236 there)
    if args.pp is not None:
        if args.pp < 1:
            raise SystemExit(f"--pp needs a microbatch count >= 1 "
                             f"(got {args.pp})")
        if args.fused:
            raise SystemExit("--pp and --fused are mutually exclusive "
                             "execution modes")
        if args.serve is not None:
            raise SystemExit("--serve is a serve-only mode: it conflicts "
                             "with --pp/--fused and distributed -l/-m")
        if args.accum and args.accum > 1:
            raise SystemExit("--accum applies to the fused step, not the "
                             "GPipe pipeline (--pp already microbatches)")
        if args.ep or (args.tp and args.tp > 1):
            raise SystemExit("--pp is its own partitioning (one stage "
                             "per mesh device); it is exclusive with "
                             "--tp/--sp/--ep")
        if args.listen or args.master:
            raise SystemExit("--pp runs one process over the local cards: "
                             "it conflicts with a distributed -l/-m run")
    if args.ep and not (args.listen or args.master):
        raise SystemExit("--ep shards experts over the distributed global "
                         "mesh: combine with -l/-m (single-process EP uses "
                         "build_fused_step(ep=True) directly)")
    # the distributed run's refusals (JAX launcher.py:75-106, :275-291)
    distributed = bool(args.listen or args.master)
    if args.listen and args.master:
        p.error("-l founds the process group and -m joins it: give one")
    if distributed:
        if args.serve is not None:
            p.error("-l/-m run distributed training: they conflict with "
                    "--serve")
        if args.autotune:
            p.error("--autotune tunes on one process: it conflicts with "
                    "a distributed -l/-m run")
        if args.supervise:
            p.error("--supervise supervises one process: it conflicts "
                    "with a distributed -l/-m run")
        if args.n_processes < 1 or not \
                0 <= args.process_id < args.n_processes:
            p.error(f"--process-id {args.process_id} is not a rank of "
                    f"--n-processes {args.n_processes}")
        if args.listen and args.process_id != 0:
            p.error("-l founds the group: it is --process-id 0 (workers "
                    "join with -m)")
        args.fused = True
    if args.zero_sharding != "auto" and not (args.fused or args.pp):
        raise SystemExit("--zero-sharding gates the fused dp update: "
                         "combine with --fused, --pp or a distributed "
                         "-l/-m run")
    if args.zero_sharding == "on" and args.pp:
        import logging
        logging.getLogger("veles_torch.launcher").warning(
            "zero-sharding degrades for --pp: the GPipe pipeline step "
            "partitions by stage, not by data replica — the replicated "
            "update stays (ZeRO covers the fused dp path this build)")
    granular = not args.fused and not args.pp and args.serve is None
    if args.backend != "torch" and not granular:
        p.error("-b/--backend picks the granular graph's backend: give it "
                "without --fused and --serve")
    if args.feed_ahead is not None:
        if args.feed_ahead < 0:
            p.error(f"--feed-ahead needs N >= 0 (got {args.feed_ahead})")
        if not (args.fused or args.pp):
            # a knob nothing would read: refused rather than ignored
            p.error("--feed-ahead tunes the device feed of the fused "
                    "and pipelined training loops: combine it with "
                    "--fused or --pp")
    # the JAX launcher's refusals (launcher.py:193-197 there)
    if args.accum is not None and args.accum < 1:
        p.error(f"--accum needs K >= 1 (got {args.accum})")
    if args.accum and args.accum > 1 and not args.fused:
        p.error("--accum applies to the fused step: combine with --fused")
    # the JAX launcher's --autotune refusals (launcher.py:75-99 there;
    # with -l/-m, below)
    if args.autotune and args.serve is not None:
        p.error("--autotune tunes a training step; it conflicts with "
                "--serve")
    if args.autotune and not (args.fused or args.pp):
        p.error("--autotune tunes the fused-step lowerings: combine with "
                "--fused or --pp")
    if args.autotune_budget is not None and not args.autotune:
        p.error("--autotune-budget bounds the generated-candidate search "
                "of --autotune: combine with --autotune")
    if args.autotune_budget is not None and args.autotune_budget < 1:
        p.error("--autotune-budget must be >= 1")
    if args.supervise and args.serve is not None:
        p.error("--supervise supervises a training run: give it with "
                "--fused or without --serve")
    if args.nonfinite_guard and args.serve is not None:
        p.error("--nonfinite-guard guards a training run: give it with "
                "--fused or without --serve")
    if args.snapshot_dir is not None and args.serve is not None:
        p.error("--snapshot-dir is the supervisor's: give it with a "
                "training run")
    if args.mirror and args.serve is not None:
        p.error("--mirror pushes a training run's snapshots: give it with a "
                "training run (--serve-watch-mirror polls one)")
    _check_serve_knobs(p, args)
    return args


def _check_serve_knobs(p: argparse.ArgumentParser,
                       args: argparse.Namespace) -> None:
    """The JAX launcher's serving-knob refusals (launcher.py:104-160
    there): a knob without --serve, a count below 1, a ring that cannot
    hold a whole request, and the ring-only knobs under merge."""
    knobs = (args.serve_ring, args.serve_batch, args.serve_dispatch,
             args.serve_quantize, args.serve_watch_mirror,
             args.serve_replicas, args.serve_announce)
    if args.serve is None and any(v is not None for v in knobs):
        p.error("--serve-ring/--serve-batch/--serve-dispatch/"
                "--serve-quantize/--serve-watch-mirror/--serve-replicas/"
                "--serve-announce configure the serving tier: combine "
                "with --serve")
    if args.serve_ring is not None and args.serve_ring < 1:
        p.error(f"--serve-ring needs N >= 1 (got {args.serve_ring})")
    if args.serve_replicas is not None and args.serve_replicas < 1:
        p.error(f"--serve-replicas needs N >= 1 (got "
                f"{args.serve_replicas})")
    if args.serve_batch is not None and args.serve_batch < 1:
        p.error(f"--serve-batch needs N >= 1 (got {args.serve_batch})")
    if args.serve_ring is not None and args.serve_batch is not None \
            and args.serve_ring < args.serve_batch:
        p.error(f"--serve-ring ({args.serve_ring}) must hold a whole "
                f"--serve-batch request ({args.serve_batch}): raise "
                f"--serve-ring or lower --serve-batch")
    if args.serve_dispatch == "merge":
        if args.serve_ring is not None:
            p.error("--serve-ring sizes the ring core: it conflicts with "
                    "--serve-dispatch merge")
        if args.serve_watch_mirror is not None:
            p.error("--serve-watch-mirror hot-swaps into the ring core (the "
                    "merge baseline binds params at build time): drop "
                    "--serve-dispatch merge")
        if args.serve_quantize not in (None, "f32"):
            p.error("--serve-quantize rides the ring core (the merge "
                    "baseline serves f32): drop --serve-dispatch merge or "
                    "--serve-quantize")


def supervisor_flags() -> dict:
    """The supervisor's own flags, from build_parser's supervisor group:
    flag name -> whether it takes a value."""
    return {opt: action.nargs != 0
            for action in build_parser().supervisor_actions
            for opt in action.option_strings}


def supervise(args: argparse.Namespace, argv: List[str]) -> int:
    """--supervise: supervise `python -m veles_tpu_torch` on `argv`
    without the supervisor's flags, until it completes or the supervisor
    gives up. Imports nothing of torch."""
    from veles_tpu_torch.resilience.supervisor import Supervisor, \
        strip_flags
    cmd = [sys.executable, "-m", "veles_tpu_torch"] \
        + strip_flags(argv, supervisor_flags())
    return Supervisor(
        cmd, snapshot_dir=args.snapshot_dir or ".",
        snapshot_prefix=args.snapshot_prefix, mirror=args.mirror,
        max_restarts=args.max_restarts,
        stall_timeout=args.stall_timeout,
        report_path=args.supervise_report).run()


def _import_file(path: str, name: str):
    spec = importlib.util.spec_from_file_location(name, path)
    if spec is None or spec.loader is None:
        raise SystemExit(f"cannot import {path}")
    mod = importlib.util.module_from_spec(spec)
    sys.modules[name] = mod
    spec.loader.exec_module(mod)
    return mod


def _run(args: argparse.Namespace, main_fn) -> None:
    """Seed, select, import the workflow module, apply the overrides, and
    run its `run(load, main)` with `main_fn(workflow)` as `main`."""
    from veles_tpu_torch import prng
    from veles_tpu_torch.ops import variants

    set_verbosity(args.verbose)
    if args.random_seed is not None:
        prng.seed_all(args.random_seed)
    if args.lrn_maxpool is not None:
        variants.select("lrn_maxpool", args.lrn_maxpool)
    # the workflow module registers its root DEFAULTS when imported, so it
    # runs before the overrides, which win
    module = _import_file(os.path.abspath(args.workflow), "veles_workflow")
    if not hasattr(module, "run"):
        raise SystemExit(f"{args.workflow} has no run(load, main) entry")
    for arg in args.overrides:
        root.override(*parse_override(arg))
    built = {}

    def load(factory, **kwargs):
        if args.snapshot:
            from veles_tpu_torch.snapshotter import Snapshotter
            # the snapshot's PRNG registry replaces the seeded one: the
            # restored run continues its streams
            built["workflow"] = Snapshotter.import_(args.snapshot)
            return built["workflow"], True
        built["workflow"] = factory(**kwargs)
        return built["workflow"], False

    def main(**kwargs):
        main_fn(built["workflow"])
        built["ran"] = True

    module.run(load, main)
    if "ran" not in built:
        raise SystemExit(f"{args.workflow}'s run() never called main()")


def _install_run_hooks(wf) -> list:
    """The training child's epoch hooks: the supervisor's heartbeat
    (written now, then at every epoch, with the feed's counters) and
    the fault plan's kill/hang; heartbeat first, so a hang's last epoch
    is still reported. Returns the hooks for removal."""
    from veles_tpu_torch.resilience import faults, hooks
    installed = []
    hb_path = os.environ.get("VELES_HEARTBEAT_FILE", "")
    if hb_path:
        from veles_tpu_torch.resilience.supervisor import write_heartbeat
        write_heartbeat(hb_path, wf.decision.epoch_number)
        installed.append(hooks.add_epoch_hook(
            lambda epoch: write_heartbeat(hb_path, epoch,
                                          feed=wf.feed_stats)))
    plan = faults.active_plan()
    if plan is not None:
        installed.append(hooks.add_epoch_hook(plan.on_epoch))
    return installed


def _select_lowerings(wf, args: argparse.Namespace) -> None:
    """Before a fused run: under --autotune, tune on the run's device
    (the winners selected for the run; each op's report line printed,
    the report kept as `wf.autotune_report`); else apply the cache's
    winners for this workflow and device, timing nothing (JAX
    launcher.py:787-813; what was applied kept as `wf.autotune_applied`).
    An explicit --lrn-maxpool stands over a cached `lrn_maxpool`."""
    from veles_tpu_torch.ops import autotune, variants
    wf.place(args.device)
    if args.autotune:
        wf.autotune_report = wf.autotune(budget=args.autotune_budget)
        for line in autotune.report_lines(wf.autotune_report):
            print(line, flush=True)
        return
    pinned = variants.selected("lrn_maxpool") if args.lrn_maxpool else None
    wf.autotune_applied = autotune.apply_cached(wf, device=wf.device)
    if pinned is not None:
        variants.select("lrn_maxpool", pinned)
    if wf.autotune_applied:
        import logging
        logging.getLogger("veles_torch.launcher").info(
            "autotune cache applied: %s", wf.autotune_applied)


def _run_distributed(wf, args: argparse.Namespace) -> None:
    """The fused dp (or, under --tp K > 1, gspmd) run of one rank: join
    the process group (NCCL on a card, gloo under --device cpu), lay the
    mesh over it (data x model=K), train with the step's mode "auto",
    leave (JAX launcher.py:874-888)."""
    import logging

    from veles_tpu_torch.ops import variants
    from veles_tpu_torch.parallel import distributed
    from veles_tpu_torch.parallel.mesh import make_mesh
    cpu = args.device is not None and str(args.device).startswith("cpu")
    distributed.initialize_distributed(
        args.listen or args.master, process_id=args.process_id,
        n_processes=args.n_processes, backend="gloo" if cpu else None)
    try:
        # on a card this makes the rank's card the current device, which
        # the workflow is placed on below
        mesh = make_mesh(model=args.tp or 1, device="cpu" if cpu else None)
        logging.getLogger("veles_torch.launcher").info(
            "distributed %s: %d processes, mesh %s",
            "coordinator" if args.listen else "worker", args.n_processes,
            mesh)
        with variants.selection_kept():
            _select_lowerings(wf, args)
            wf.run_fused(mesh=mesh, feed_ahead=args.feed_ahead,
                         nonfinite_guard=args.nonfinite_guard,
                         accum_steps=args.accum, mode="auto",
                         zero_sharding=args.zero_sharding, ep=args.ep)
    finally:
        distributed.shutdown_distributed()


def train(argv: Optional[List[str]] = None):
    """Parse `argv` (which must not hold --serve), build the workflow
    through its module's `run(load, main)` (or restore it under -s) and
    train it until its decision completes: through the fused step with
    `run_fused` under --fused, as a GPipe pipeline with `run_pipelined`
    under --pp, else through the granular graph (`initialize` on the
    backend, then `run()`). Returns the trained
    workflow. The CLI and chip_smoke.py both come through here."""
    from veles_tpu_torch.ops import variants
    from veles_tpu_torch.resilience import hooks

    args = parse_args(argv)
    if args.serve is not None:
        raise SystemExit("train() trains: --serve is serve()'s")
    done = {}

    def main_fn(wf):
        if args.mirror and getattr(wf, "snapshotter", None) is not None:
            # every snapshot this run writes is pushed to the mirror
            wf.snapshotter.mirror = args.mirror
        installed = _install_run_hooks(wf)
        try:
            if args.listen or args.master:
                _run_distributed(wf, args)
            elif args.fused:
                # the run's winners stay its own: the process's selection
                # is restored when it returns
                with variants.selection_kept():
                    _select_lowerings(wf, args)
                    wf.run_fused(device=args.device,
                                 feed_ahead=args.feed_ahead,
                                 nonfinite_guard=args.nonfinite_guard,
                                 accum_steps=args.accum,
                                 zero_sharding=args.zero_sharding)
            elif args.pp:
                # the GPipe pipeline over the visible cards (or the CPU)
                with variants.selection_kept():
                    _select_lowerings(wf, args)
                    wf.run_pipelined(n_microbatches=args.pp,
                                     device=args.device,
                                     feed_ahead=args.feed_ahead,
                                     nonfinite_guard=args.nonfinite_guard)
            else:
                # the granular graph: the Decision raises at the
                # minibatch whose loss goes non-finite (JAX :909-916)
                wf.decision.nonfinite_guard = bool(args.nonfinite_guard)
                wf.initialize(device=args.device, backend=args.backend)
                wf.run()
        finally:
            for fn in installed:
                hooks.remove_epoch_hook(fn)
        done["workflow"] = wf

    _run(args, main_fn)
    return done["workflow"]


class Fleet:
    """The servers of one `serve()` beyond a lone one: its replicas (each
    with its watcher, `server.watcher`) and their beacons. The first
    server holds it (`server.fleet`) and stops it with itself."""

    def __init__(self) -> None:
        self.servers: list = []
        self.beacons: list = []

    def stop(self, drain_s: float = 5.0) -> None:
        """The drain protocol (JAX launcher.py:771-784): the beacons say
        "draining" (a router stops picking the replicas), the watchers
        stop (no swap lands in a stopping server), the servers stop
        (each finishing its in-flight rounds), the beacons say "gone"."""
        import logging
        log = logging.getLogger("veles_torch.launcher")
        for b in self.beacons:
            b.drain()
        log.info("fleet stop: beacons draining")
        for s in self.servers:
            if s.watcher is not None:
                s.watcher.stop()
                s.watcher = None
        log.info("fleet stop: watchers stopped")
        for s in self.servers:
            s.fleet = None
            s.stop(drain_s)
        log.info("fleet stop: servers stopped")
        for b in self.beacons:
            b.stop()
        log.info("fleet stop: beacons gone")


def serve(argv: Optional[List[str]] = None):
    """Parse `argv` (which must hold --serve PORT), build the workflow
    through its module's `run(load, main)` (or restore it under -s) and
    start its InferenceServer, with its WeightWatcher under
    --serve-watch-mirror (`server.watcher`, stopped with the server).
    Under --serve-replicas N and --serve-announce, N servers of the one
    build and a beacon each: the first server is returned, the others
    and the beacons in its `fleet` (a `Fleet`), stopped with it by the
    drain protocol; a replica that fails to start stops the ones before
    it and raises. Returns the started server; the caller stops it. The
    CLI and chip_smoke.py both come through here."""
    import logging

    from veles_tpu_torch.serving import InferenceServer

    args = parse_args(argv)
    if args.serve is None:
        raise SystemExit("serve() runs --serve PORT")
    done = {}

    def main_fn(wf):
        n = args.serve_replicas or 1
        fleet_mode = n > 1 or args.serve_announce is not None
        # the host other fleet members reach this process at: the
        # beacon URL's host and the rid suffix (pids collide across
        # containers, advertised hosts do not)
        adv = os.environ.get("VELES_SERVE_ADVERTISE", "").strip()
        suffix = adv.replace(":", "-") if adv else str(os.getpid())
        fleet = Fleet()
        try:
            for i in range(n):
                fleet.servers.append(InferenceServer(
                    wf, port=args.serve + i if args.serve else 0,
                    ring_slots=args.serve_ring, max_batch=args.serve_batch,
                    dispatch=args.serve_dispatch or "ring",
                    quantize=args.serve_quantize or "f32",
                    token=args.serve_token, max_body=args.serve_max_body,
                    device=args.device,
                    replica=f"r{i}-{suffix}" if fleet_mode else None,
                    # the serialized program where its cache is named
                    aot_cache="auto" if os.environ.get(AOT_CACHE_ENV)
                    else None
                ).start())
            srv = fleet.servers[0]
            info = srv.model_info()
            logging.getLogger("veles_torch.launcher").info(
                "serving: replicas=%d dispatch=%s ring=%s max_batch=%s "
                "quantize=%s params %s", n, info["dispatch"],
                info["ring_slots"], info["max_batch"], info["quantize"],
                info.get("param_bytes"))
            if args.serve_watch_mirror:
                from veles_tpu_torch.resilience.mirror import get_mirror
                from veles_tpu_torch.serving_watch import WeightWatcher
                try:
                    poll_s = float(os.environ.get("VELES_WATCH_POLL_S",
                                                  "10") or 10)
                except ValueError:
                    poll_s = 10.0
                for s in fleet.servers:
                    s.watcher = WeightWatcher(
                        s, get_mirror(args.serve_watch_mirror,
                                      token=s.token), poll_s=poll_s).start()
            if args.serve_announce:
                from veles_tpu_torch.resilience.mirror import get_mirror
                from veles_tpu_torch.serving_router import ReplicaBeacon
                bus = get_mirror(args.serve_announce, token=srv.token)
                for s in fleet.servers:
                    fleet.beacons.append(ReplicaBeacon(
                        bus, s.replica,
                        f"http://{adv or '127.0.0.1'}:{s.port}",
                        health=s.health).start())
        except BaseException:
            fleet.stop(drain_s=0)
            raise
        if fleet_mode:
            srv.fleet = fleet
        done["server"] = srv

    _run(args, main_fn)
    return done["server"]


def serve_rollback(url: str) -> int:
    """--serve-rollback: POST /rollback to the server (or the router) at
    `url` and print its JSON answer. 0 on an applied rollback, 1 on a
    refusal (409: no previous generation) or a transport failure (JAX
    __main__.py:521-553)."""
    import json
    import urllib.error
    import urllib.request
    url = url.rstrip("/")
    if not url.startswith(("http://", "https://")):
        url = "http://" + url
    req = urllib.request.Request(url + "/rollback", data=b"",
                                 method="POST")
    token = os.environ.get("VELES_WEB_TOKEN")
    if token:
        req.add_header("X-Veles-Token", token)
    try:
        with urllib.request.urlopen(req, timeout=30) as resp:
            payload = json.loads(resp.read())
    except urllib.error.HTTPError as e:
        try:
            payload = json.loads(e.read())
        except ValueError:
            payload = {"error": str(e)}
        print(json.dumps(payload), flush=True)
        return 1
    except (urllib.error.URLError, OSError) as e:
        print(json.dumps({"error": str(e)}), flush=True)
        return 1
    print(json.dumps(payload), flush=True)
    return 0


def _wait_for_stop() -> None:
    """Block until SIGTERM or Ctrl-C."""
    stop = threading.Event()
    # SIGTERM drains like Ctrl-C
    signal.signal(signal.SIGTERM, lambda *_: stop.set())
    try:
        while not stop.wait(3600):
            pass
    except KeyboardInterrupt:
        pass


def route(args: argparse.Namespace) -> int:
    """--route: the fleet's router over the beacons on the bus, until
    SIGTERM or Ctrl-C (JAX __main__.py:556-571). Imports no torch and no
    workflow: a router runs on a box that cannot build the model."""
    from veles_tpu_torch.resilience.mirror import get_mirror
    from veles_tpu_torch.serving_router import ServingRouter
    token = os.environ.get("VELES_WEB_TOKEN")
    # the body cap is --serve-max-body's (32 MiB by default; the JAX
    # router's 1 MiB refuses a single full-size 227x227x3 row of JSON)
    router = ServingRouter(get_mirror(args.route, token=token),
                           port=args.route_port or 0, token=token,
                           max_body=args.serve_max_body).start()
    print(f"ROUTING http://127.0.0.1:{router.port}", flush=True)
    _wait_for_stop()
    router.stop()
    return 0


def main(argv: Optional[List[str]] = None) -> int:
    argv = list(sys.argv[1:] if argv is None else argv)
    args = parse_args(argv)
    if args.serve_rollback:
        return serve_rollback(args.serve_rollback)
    if args.route:
        set_verbosity(args.verbose)
        return route(args)
    if args.supervise:
        set_verbosity(args.verbose)
        return supervise(args, argv)
    if args.serve is None:
        from veles_tpu_torch.resilience import EXIT_NONFINITE, \
            NonFiniteLossError
        try:
            wf = train(argv)
        except NonFiniteLossError as e:
            print(f"non-finite loss: {e}", file=sys.stderr, flush=True)
            return EXIT_NONFINITE
        dec = wf.decision
        print(f"TRAINED {dec.epoch_number} epochs: loss {wf.evaluator.loss} "
              f"best_err {dec.best_validation_err} history {dec.history}",
              flush=True)
        return 0
    srv = serve(argv)
    for s in (srv.fleet.servers if srv.fleet is not None else [srv]):
        print(f"SERVING http://127.0.0.1:{s.port}", flush=True)
    _wait_for_stop()
    srv.stop()
    return 0
