"""Command line of the port: build a sample workflow, then train or serve
it.

`python -m veles_tpu_torch WORKFLOW.py (--fused | --serve PORT)
[--device cpu] [-r SEED] [--lrn-maxpool fused|composed]
[--feed-ahead N] [--serve-ring N] [root.x=y ...]` — the port's
counterpart of `veles_tpu/__main__.py` and of
the `--fused` and `--serve` branches of `veles_tpu/launcher.py`
(launcher.py:898-907 there). The workflow module keeps the reference's
`run(load, main)` convention: it registers its `root` defaults when
imported, the trailing overrides win over them, `load(create_workflow)`
builds the workflow and `main()` initializes it on the device and trains
it through the fused step (`--fused`) or starts the server (`--serve`).
The granular Unit/Workflow graph, the JAX package's mode without either
flag, comes with a later slice.
"""

from __future__ import annotations

import argparse
import importlib.util
import os
import signal
import sys
import threading
from typing import List, Optional

from veles_tpu_torch import prng
from veles_tpu_torch.config import parse_override, root
from veles_tpu_torch.logger import set_verbosity
from veles_tpu_torch.ops import variants


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="veles_tpu_torch",
        description="Train or serve a workflow: veles_tpu_torch "
                    "workflow.py (--fused | --serve PORT) "
                    "[root.path.key=value ...]",
        allow_abbrev=False)
    p.add_argument("workflow", help="workflow module (.py) with "
                                    "run(load, main)")
    p.add_argument("overrides", nargs="*", default=[],
                   help="trailing root.a.b=value overrides")
    p.add_argument("--fused", action="store_true",
                   help="train through the fused step until the workflow's "
                        "decision completes")
    p.add_argument("--serve", type=int, default=None, metavar="PORT",
                   help="serve the workflow's forward over HTTP on PORT "
                        "(0 picks a free port)")
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
    p.add_argument("--serve-ring", type=int, default=64, metavar="N",
                   help="rows in the ring batch (and the per-request cap)")
    p.add_argument("--serve-token", default=None,
                   help="shared token /predict requires in X-Veles-Token")
    p.add_argument("--serve-max-body", type=int, default=32 << 20,
                   metavar="BYTES",
                   help="largest /predict body accepted (413 above it); "
                        "a full-size 227x227x3 row is ~1-3 MB of JSON")
    p.add_argument("-v", "--verbose", action="count", default=0,
                   help="-v info, -vv debug")
    return p


def parse_args(argv: Optional[List[str]] = None) -> argparse.Namespace:
    """Parse `argv`; exactly one of --fused and --serve (exit 2 else)."""
    p = build_parser()
    args = p.parse_intermixed_args(argv)
    if args.fused and args.serve is not None:
        p.error("--fused trains and --serve serves: give one of them")
    if not args.fused and args.serve is None:
        p.error("give --fused (train) or --serve PORT (serve); the "
                "granular Unit/Workflow graph, which runs without either, "
                "comes with a later slice of the port")
    if args.feed_ahead is not None:
        if args.feed_ahead < 0:
            p.error(f"--feed-ahead needs N >= 0 (got {args.feed_ahead})")
        if not args.fused:
            # a knob nothing would read: refused rather than ignored
            p.error("--feed-ahead tunes the device feed of the fused "
                    "training loop: combine it with --fused")
    return args


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
        built["workflow"] = factory(**kwargs)
        return built["workflow"], False

    def main(**kwargs):
        main_fn(built["workflow"])
        built["ran"] = True

    module.run(load, main)
    if "ran" not in built:
        raise SystemExit(f"{args.workflow}'s run() never called main()")


def train(argv: Optional[List[str]] = None):
    """Parse `argv` (which must hold --fused), build the workflow through
    its module's `run(load, main)` and train it with `run_fused` until its
    decision completes. Returns the trained workflow. The CLI and
    chip_smoke.py both come through here."""
    args = parse_args(argv)
    if not args.fused:
        raise SystemExit("train() runs --fused")
    done = {}

    def main_fn(wf):
        wf.run_fused(device=args.device, feed_ahead=args.feed_ahead)
        done["workflow"] = wf

    _run(args, main_fn)
    return done["workflow"]


def serve(argv: Optional[List[str]] = None):
    """Parse `argv` (which must hold --serve PORT), build the workflow
    through its module's `run(load, main)` and start its InferenceServer.
    Returns the started server; the caller stops it. The CLI and
    chip_smoke.py both come through here."""
    from veles_tpu_torch.serving import InferenceServer

    args = parse_args(argv)
    if args.serve is None:
        raise SystemExit("serve() runs --serve PORT")
    done = {}

    def main_fn(wf):
        done["server"] = InferenceServer(
            wf, port=args.serve, ring_slots=args.serve_ring,
            token=args.serve_token, max_body=args.serve_max_body,
            device=args.device).start()

    _run(args, main_fn)
    return done["server"]


def main(argv: Optional[List[str]] = None) -> int:
    if parse_args(argv).fused:
        wf = train(argv)
        dec = wf.decision
        print(f"TRAINED {dec.epoch_number} epochs: loss {wf.evaluator.loss} "
              f"best_err {dec.best_validation_err} history {dec.history}",
              flush=True)
        return 0
    srv = serve(argv)
    print(f"SERVING http://127.0.0.1:{srv.port}", flush=True)
    stop = threading.Event()
    # SIGTERM drains like Ctrl-C
    signal.signal(signal.SIGTERM, lambda *_: stop.set())
    try:
        while not stop.wait(3600):
            pass
    except KeyboardInterrupt:
        pass
    srv.stop()
    return 0
