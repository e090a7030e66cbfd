"""Tune the lowerings of the AlexNet step on the card and cache the winners.

`python -m veles_tpu_torch.tools.autotune [--budget N] [--batch B]
[--device cpu] [--cache PATH] [--ops OP,...] [--force]`

The port's counterpart of `tools/autotune.py`: the full-width AlexNet
(bf16 compute over f32 master weights, as the fused step trains it) is
built at batch B (default 256) and every tunable op of its step is timed
in the step on the card (ops/autotune.py): the flat tier of hand-written
candidates, or with `--budget N` the search over the generated kernel
points too (K1-K4's launch shapes, K6/K7's key order and dropout
epilogue, the stem's and the pool's lowerings), each gated by its
reference contract and the card's shared memory first. Winners stay in
the cache ($VELES_AUTOTUNE_CACHE, else
~/.cache/veles_tpu_torch/autotune.json), where a later `--fused` run of
the same AlexNet on the same card applies them; a second call finds them
all there and times nothing.

On the CPU (`--device cpu`) it tunes a toy AlexNet (width 0.125, 67x67,
batch 8, f32), at which a time says nothing of the card: a rehearsal.
Prints one `AUTOTUNE op: ...` line per op, and as its last line one JSON
object: the winner per op, the report, the registry's selection, the
device, the batch and the cache's path.
"""

from __future__ import annotations

import argparse
import json
import sys
from typing import List, Optional


def main(argv: Optional[List[str]] = None) -> int:
    p = argparse.ArgumentParser(
        prog="python -m veles_tpu_torch.tools.autotune",
        description=__doc__.splitlines()[0])
    p.add_argument("--budget", type=int, default=None, metavar="N",
                   help="trials of the search over the generated points "
                        "(default: the hand-written candidates only)")
    p.add_argument("--batch", type=int, default=None,
                   help="the step's batch (default 256 on the card, 8 on "
                        "the CPU); the cache keys leave it out")
    p.add_argument("--steps", type=int, default=4,
                   help="train_repeat steps a timed window")
    p.add_argument("--repeats", type=int, default=3,
                   help="timed windows (or bench calls) a candidate; the "
                        "fastest wins")
    p.add_argument("--device", default=None,
                   help="torch device (default: cuda; 'cpu' must be asked "
                        "for)")
    p.add_argument("--cache", default=None, metavar="PATH",
                   help="the decision cache (default: "
                        "$VELES_AUTOTUNE_CACHE or "
                        "~/.cache/veles_tpu_torch/autotune.json)")
    p.add_argument("--ops", default="", metavar="OP[,OP...]",
                   help="tune only these ops")
    p.add_argument("--force", action="store_true",
                   help="re-time ops whose winner is cached")
    p.add_argument("--profile-json", default=None, metavar="PATH",
                   help="per-op cost shares that order the search "
                        "(default: $VELES_LAYER_PROFILE_PATH or "
                        "LAYER_PROFILE.json; none: the given order)")
    p.add_argument("--smem-budget", type=int, default=None,
                   metavar="BYTES",
                   help="prune against this shared-memory budget instead "
                        "of the card's (also $VELES_SMEM_BUDGET)")
    p.add_argument("-r", "--random-seed", type=int, default=1234)
    args = p.parse_args(argv)
    if args.budget is not None and args.budget < 1:
        p.error("--budget must be >= 1")
    if args.profile_json and not args.budget:
        p.error("--profile-json orders the budgeted search: combine with "
                "--budget N")
    if args.smem_budget is not None and not args.budget:
        p.error("--smem-budget bounds the budgeted search's generated "
                "points: combine with --budget N")

    from veles_tpu_torch import prng
    from veles_tpu_torch.backends import make_device
    from veles_tpu_torch.ops import variants
    from veles_tpu_torch.ops.autotune import (AutotuneCache, device_name,
                                              report_lines)
    from veles_tpu_torch.samples.alexnet import create_workflow

    try:
        dev = make_device(args.device)
    except RuntimeError as e:
        p.error(str(e))
    on_card = dev.type == "cuda"
    batch = args.batch or (256 if on_card else 8)
    kw = {} if on_card else dict(width_mult=0.125, fc_width=64,
                                 input_hw=67, n_classes=16)
    prng.seed_all(args.random_seed)
    wf = create_workflow(minibatch_size=batch, n_train=2 * batch,
                         n_validation=batch, **kw)
    wf.initialize(device=dev)
    cache = AutotuneCache(args.cache)
    only = [o for o in args.ops.split(",") if o] or None
    report = wf.autotune(
        compute_dtype="bfloat16" if on_card else "float32",
        steps=args.steps, repeats=args.repeats, batch=batch, cache=cache,
        force=args.force, ops=only, budget=args.budget,
        profile_path=args.profile_json, smem_budget=args.smem_budget)
    for line in report_lines(report):
        print(line, flush=True)
    print(json.dumps({
        "winners": {op: r["variant"] for op, r in sorted(report.items())},
        "autotune": report,
        "variants": variants.selection_table(include_defaults=True),
        "device": device_name(dev), "batch": batch, "cache": cache.path,
    }, default=str), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
