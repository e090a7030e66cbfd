"""Exact resume on the CPU: a run snapshotted, restored in a fresh
workflow and trained on gives the uninterrupted run's bits.

- The toy AlexNet of tests/test_torch_run_fused.py (dropout 0), 2
  epochs, its newest snapshot (epoch 2's validation pass, after the
  first epoch's train steps) imported, 1 more epoch, in the port and in
  the JAX package (Pallas interpreted) from one seed: the Decision's history
  equal, the final loss within rtol 1e-5, the parameters and velocities
  within that file's rtol 1e-4, atol 1e-7.
- The port's resumed run against its uninterrupted run, the same bits
  (history, loss, every parameter and velocity, the epoch counter,
  best_validation_err) at dropout 0 and 0.5, from the synthetic loader
  and from a packed memmap (whose produce threads gathered rows ahead
  of the snapshot). The cut run's snapshot is taken after train steps:
  trained weights, non-zero velocities, a dropout stream past its
  seed's position.
- feed_ahead > 1 is clamped to 1 where a snapshotter runs.
- The dropout-stream fault: a step built from a fresh generator of the
  seed (the port before the fix) draws the previous run's masks again;
  the registry's device stream draws new ones.
"""

import logging
import os

import numpy as np
import pytest
import torch

from veles_tpu import prng as jprng
from veles_tpu.ops import variants as jvariants
from veles_tpu_torch import prng
from veles_tpu_torch.loader import memmap as mm
from veles_tpu_torch.loader.synthetic import SyntheticClassifierLoader
from veles_tpu_torch.ops import variants
from veles_tpu_torch.samples import alexnet
from veles_tpu_torch.snapshotter import Snapshotter
from veles_tpu_torch.znicz import dropout as pdropout
from veles_tpu_torch.znicz.standard_workflow import StandardWorkflow

SEED = 11
RTOL, ATOL = 1e-4, 1e-7
#: the toy AlexNet of tests/test_torch_run_fused.py
TOY_LAYERS = dict(n_classes=16, width_mult=0.125, fc_width=64,
                  init="scaled")
GD = {"learning_rate": 0.01, "gradient_moment": 0.9,
      "weights_decay": 0.0005}


@pytest.fixture(autouse=True)
def _fresh_generators(monkeypatch):
    monkeypatch.setattr(prng, "_generators", {})
    monkeypatch.setattr(prng, "_base_seed", None)
    saved = jprng._base_seed, dict(jprng._generators)
    yield
    jprng._base_seed = saved[0]
    jprng._generators.clear()
    jprng._generators.update(saved[1])


def _layers(layers_fn, dropout):
    out = layers_fn(**TOY_LAYERS)
    for spec in out:
        if spec["type"] == "dropout":
            spec["dropout_ratio"] = dropout
    return out


def _decision(max_epochs):
    return {"max_epochs": max_epochs, "fail_iterations": 100}


# -- the port against the JAX package -----------------------------------------

def _jax_resume(snap_dir):
    from veles_tpu.loader.synthetic import \
        SyntheticClassifierLoader as JLoader
    from veles_tpu.samples import alexnet as jalexnet
    from veles_tpu.snapshotter import Snapshotter as JSnapshotter
    from veles_tpu.znicz.standard_workflow import \
        StandardWorkflow as JWorkflow
    jprng._generators.clear()
    jprng.seed_all(SEED)
    loader = JLoader(n_classes=16, sample_shape=(67, 67, 3),
                     n_validation=0, n_train=12, minibatch_size=8,
                     noise=0.5)
    wf = JWorkflow(layers=_layers(jalexnet.alexnet_layers, 0.0),
                   loader=loader, loss="softmax", n_classes=16,
                   decision_config=_decision(2), gd_config=GD,
                   snapshot_config={"directory": str(snap_dir),
                                    "prefix": "jax"})
    prev = {op: jvariants.selected(op)
            for op in ("lrn_maxpool", "sgd_update")}
    jvariants.select("lrn_maxpool", "fused[rt=2,io=native,fuse=1]")
    jvariants.select("sgd_update", "pallas_rows[rt=8]")
    try:
        with jvariants.pallas_interpret():
            wf.run_fused(uint8_wire=False)
            wf._stop_units()
            wf = JSnapshotter.import_(
                JSnapshotter.latest(str(snap_dir), prefix="jax"))
            assert wf.decision.epoch_number >= 1
            wf.decision.max_epochs = 3
            wf.decision.complete <<= False
            wf.run_fused(uint8_wire=False)
    finally:
        for op, name in prev.items():
            if name is None:
                jvariants.clear_selection(op)
            else:
                jvariants.select(op, name)
    wf._stop_units()
    return wf


def _port_workflow(snap_dir, max_epochs, dropout=0.0, loader=None,
                   keep_last=0, n_validation=4):
    prng.seed_all(SEED)
    if loader is None:
        loader = SyntheticClassifierLoader(
            n_classes=16, sample_shape=(67, 67, 3),
            n_validation=n_validation, n_train=12, minibatch_size=8,
            noise=0.5)
    return StandardWorkflow(
        layers=_layers(alexnet.alexnet_layers, dropout), loader=loader,
        loss="softmax", n_classes=16, decision_config=_decision(max_epochs),
        gd_config=GD,
        snapshot_config={"directory": str(snap_dir), "prefix": "port",
                         "keep_last": keep_last})


def _resumed(wf, snap_dir, max_epochs, device="cpu", **run):
    """`wf` trained, its newest snapshot restored in a fresh workflow
    (the process's generators scrambled first) and trained on to
    `max_epochs`. The snapshot must be one taken after train steps: the
    epoch counter past 0, every velocity non-zero."""
    wf.run_fused(device=device, **run)
    path = Snapshotter.latest(str(snap_dir), prefix="port")
    assert path is not None
    prng.seed_all(12345)
    back = Snapshotter.import_(path)
    assert back.restored and not back.is_initialized
    assert back.decision.epoch_number >= 1
    for g in back.gds:
        assert all(bool(t.any()) for t in _velocities(g)), g
    back.decision.max_epochs = max_epochs
    back.decision.complete = False
    back.run_fused(device=device, **run)
    return back


def test_resumed_toy_alexnet_tracks_the_jax_packages(tmp_path):
    jwf = _jax_resume(tmp_path / "jax")
    prev = {op: variants.selected(op) for op in ("lrn_maxpool",
                                                 "sgd_update")}
    variants.select("lrn_maxpool", "fused")
    variants.select("sgd_update", "kernel")
    try:
        pwf = _resumed(_port_workflow(tmp_path / "port", 2,
                                      n_validation=0),
                       tmp_path / "port", 3)
    finally:
        for op, name in prev.items():
            if name is None:
                variants.clear_selection(op)
            else:
                variants.select(op, name)
    assert len(pwf.decision.history) == 3
    assert pwf.decision.history == jwf.decision.history
    assert pwf.decision.epoch_number == jwf.decision.epoch_number == 3
    np.testing.assert_allclose(pwf.evaluator.loss, float(jwf.evaluator.loss),
                               rtol=1e-5)
    for i, (ju, pu) in enumerate(zip(jwf.forwards, pwf.forwards)):
        for k, a in ju.param_arrays().items():
            np.testing.assert_allclose(
                pu.param_arrays()[k].detach().numpy(), np.asarray(a.mem),
                rtol=RTOL, atol=ATOL, err_msg=f"unit {i} {k}")
    n = len(pwf.forwards)
    for i in range(n):
        jg, pg = jwf.gds[n - 1 - i], pwf.gds[n - 1 - i]
        for name in ("vel_w", "vel_b"):
            jv = getattr(jg, name)
            if jv is None or not jv:
                continue
            np.testing.assert_allclose(
                getattr(pg, name).numpy(), np.asarray(jv.mem), rtol=RTOL,
                atol=ATOL, err_msg=f"unit {i} {name}")


# -- the port's resumed run against its uninterrupted run ---------------------

def _velocities(gd):
    return [getattr(gd, a) for a in sorted(vars(gd)) if a.startswith("vel_")
            and isinstance(getattr(gd, a), torch.Tensor)]


def _trained(wf):
    """Everything the gate compares, as host values."""
    tensors = [t.detach().clone() for u in wf.forwards
               for t in u.param_arrays().values()]
    tensors += [t.detach().clone() for g in wf.gds
                for t in _velocities(g)]
    dec = wf.decision
    return tensors, (dec.history, dec.epoch_number, dec.best_validation_err,
                     wf.evaluator.loss)


def _memmap_loader(tmp_path, split=(0, 8, 24)):
    rs = np.random.RandomState(7)
    data = rs.randint(0, 256, (sum(split), 67, 67, 3)).astype(np.uint8)
    labels = rs.randint(0, 16, sum(split)).astype(np.int64)
    out = str(tmp_path / "packed_{}_{}_{}".format(*split))
    if not os.path.exists(out):
        mm.pack_arrays(out, data, labels, split, shard_mb=0.05,
                       mean_image=data.mean(axis=0) / 127.5 - 1.0)
    return mm.MemmapImageLoader(data_path=out, minibatch_size=8,
                                prefetch=2, n_workers=2)


@pytest.mark.parametrize("source", ["synthetic", "memmap"])
@pytest.mark.parametrize("dropout", [0.0, 0.5])
def test_resumed_run_gives_the_uninterrupted_runs_bits(tmp_path, source,
                                                       dropout):
    """No validation set: each train pass is judged, so the first one's
    end always improves and snapshots, after its train steps (the toy
    does not learn enough for a validation pass to improve)."""
    def loader():
        return (_memmap_loader(tmp_path, (0, 0, 24))
                if source == "memmap" else None)

    whole = _port_workflow(tmp_path / "whole", 3, dropout, loader(),
                           n_validation=0)
    whole.run_fused(device="cpu")
    want, want_meta = _trained(whole)
    cut = _resumed(_port_workflow(tmp_path / "cut", 2, dropout, loader(),
                                  n_validation=0),
                   tmp_path / "cut", 3)
    got, got_meta = _trained(cut)
    assert got_meta == want_meta
    assert len(got) == len(want) == 32
    for i, (g, w) in enumerate(zip(got, want)):
        assert torch.equal(g, w), i
    if source == "memmap":
        # the restored loader reopened its maps, and its gather ran
        assert cut.loader.gather_used in ("native", "numpy")


def test_snapshot_holds_the_trained_batchs_cursor(tmp_path):
    """The snapshot taken after the validation pass pickles the cursor
    just past the validation batch, not that of the train rows the
    produce threads gathered ahead, and no lookahead or batch buffer."""
    wf = _port_workflow(tmp_path, 1, loader=_memmap_loader(tmp_path))
    wf.run_fused(device="cpu")
    back = Snapshotter.import_(Snapshotter.latest(str(tmp_path),
                                                  prefix="port"))
    ld = back.loader
    assert ld._cursor == 1 and ld.epoch_number == 0
    assert ld._pending == {} and ld._pool is None
    assert ld.minibatch_data is None and ld.out_alloc is None
    assert sum(len(m) for m in ld._maps) == 32      # maps reopened
    assert back.device_feed is None and back.feed_stats is None


def test_a_restored_workflow_is_moved_to_the_card_or_raises(tmp_path,
                                                           monkeypatch):
    """`place` moves a restored workflow (never refills it from the seed
    streams); asked for the card where CUDA is absent, it raises."""
    wf = _port_workflow(tmp_path, 1)
    wf.run_fused(device="cpu")
    back = Snapshotter.import_(Snapshotter.latest(str(tmp_path),
                                                  prefix="port"))
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        back.place()
    assert not back.is_initialized
    want = [t.clone() for t in back.forwards[0].param_arrays().values()]
    back.place("cpu")
    assert back.device == torch.device("cpu") and back.loader._cursor == 1
    for got, w in zip(back.forwards[0].param_arrays().values(), want):
        assert torch.equal(got, w)


@pytest.mark.parametrize("snapshots, ahead", [(True, 1), (False, 3)])
def test_feed_ahead_is_clamped_where_a_snapshotter_runs(tmp_path, caplog,
                                                        monkeypatch,
                                                        snapshots, ahead):
    # the console handler of an earlier CLI run in this process stops
    # propagation to the root logger, where caplog listens
    monkeypatch.setattr(logging.getLogger("veles_torch"), "propagate",
                        True)
    wf = _port_workflow(tmp_path, 1)
    if not snapshots:
        wf.snapshotter = None
    with caplog.at_level(logging.WARNING, logger="veles_torch"):
        wf.run_fused(device="cpu", feed_ahead=3)
    assert wf.feed_stats["ahead"] == ahead
    assert ("clamped to 1" in caplog.text) == snapshots


def test_two_runs_draw_new_dropout_masks(monkeypatch):
    """Before the fix the step made its generator afresh from the seed,
    so a second run_fused (and a resumed run) replayed the first run's
    masks from step 0. The registry's device stream advances: a second
    step draws new masks; a generator made from the seed (the old step's)
    draws the first step's again."""
    masks = []
    inner = pdropout.make_mask

    def spy(*args, **kwargs):
        out = inner(*args, **kwargs)
        masks.append(out.clone())
        return out

    monkeypatch.setattr(pdropout, "make_mask", spy)
    prng.seed_all(SEED)
    wf = alexnet.create_workflow(minibatch_size=4, input_hw=67,
                                 n_train=4, n_validation=0, **TOY_LAYERS)
    wf.initialize("cpu")
    x = np.random.RandomState(0).randn(4, 67, 67, 3).astype(np.float32)
    y = np.arange(4)

    def one_step(step):
        del masks[:]
        step.train(step.init_state(), x, y)
        return list(masks)

    first = one_step(wf.build_fused_step())
    second = one_step(wf.build_fused_step())
    old = wf.build_fused_step()
    old.gen = prng.get().torch_generator("cpu")     # the unfixed step
    replay = one_step(old)
    assert len(first) == len(second) == 2
    assert not any(torch.equal(a, b) for a, b in zip(first, second))
    assert all(torch.equal(a, b) for a, b in zip(first, replay))
