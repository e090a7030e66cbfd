"""The port's DeviceFeed and the fused loop that trains through it, on the
CPU, held against the JAX package's where both run.

- The feed's contract, as the JAX package's tests hold it: the upload of
  batch k+1 is issued before batch k's results are used; the lookahead
  depth is configurable (0 produces on demand); each batch carries, and
  replays onto the loader, the Decision metadata of the batch it holds,
  with the loader's cursor at the consumed batch + 1 between next() and
  prefetch(); the byte and device-sync counters; stop() releases the
  loader's produce threads.
- The uint8 wire: a memmap-fed run moves exactly a quarter of the f32
  wire's image bytes, tracks the f32 wire's trajectory within the JAX
  test's tolerance (rtol 1e-4, atol 1e-5 on the head weights), and
  `uint8_wire=False` pins float emission on a loader built to emit uint8.
- Two epochs of `run_fused` of the toy AlexNet from one packed memmap on
  the uint8 wire in both packages (the JAX package's local fused step
  with its own DeviceFeed and input_normalize prologue, its Pallas
  kernels in interpret mode, as tests/test_torch_run_fused.py runs it):
  equal Decision history, the last pass's loss within rtol 1e-5, the
  parameters and velocities within rtol 1e-4, atol 1e-7. The JAX step's
  prologue is jitted, where XLA contracts `x * scale + offset` into a
  fused multiply-add (one rounding, the port's two): one ulp apart in
  some inputs, well inside those tolerances.
- `feed_ahead` 0 and 1 give the same bits in the port; `--feed-ahead`'s
  refusals on the command line; chip_smoke.py's reading of a profile's
  batch copies (stream, overlap, a copy that waited for queued compute
  work) on small made-up traces.
"""

import threading

import numpy as np
import pytest
import torch

from veles_tpu import prng as jprng
from veles_tpu_torch import launcher, prng
from veles_tpu_torch.loader import DeviceFeed
from veles_tpu_torch.loader import memmap as mm
from veles_tpu_torch.loader.base import TRAIN, VALIDATION
from veles_tpu_torch.loader.device_feed import make_batch_put
from veles_tpu_torch.loader.synthetic import SyntheticClassifierLoader
from veles_tpu_torch.znicz.standard_workflow import StandardWorkflow

TOY = dict(minibatch_size=8, width_mult=0.125, fc_width=64, n_classes=16,
           init="scaled")
SEED = 11
RTOL, ATOL = 1e-4, 1e-7


@pytest.fixture(autouse=True, scope="module")
def _own_autotune_cache(tmp_path_factory):
    """A plain `--fused` run applies the autotune cache's winners: this
    module's runs read a cache of their own, not one under HOME."""
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("VELES_AUTOTUNE_CACHE",
                  str(tmp_path_factory.mktemp("autotune") / "autotune.json"))
        yield


@pytest.fixture(autouse=True)
def _fresh_generators():
    saved = jprng._base_seed, prng._base_seed
    prng._generators.clear()
    yield
    prng._generators.clear()
    jprng._base_seed, prng._base_seed = saved


def make_loader(minibatch=10, n_validation=20, n_train=40):
    prng.seed_all(3)
    loader = SyntheticClassifierLoader(
        n_classes=4, sample_shape=(6,), n_validation=n_validation,
        n_train=n_train, minibatch_size=minibatch, shuffle_train=False)
    loader.initialize()
    return loader


class RecordingPut:
    """An upload stub: records every issued upload, hands the host arrays
    through."""

    def __init__(self):
        self.calls = []

    def __call__(self, arrays):
        self.calls.append(tuple(np.asarray(a).nbytes for a in arrays))
        return arrays


def test_lookahead_put_issued_before_consumption():
    loader = make_loader()
    put = RecordingPut()
    feed = DeviceFeed(loader, put=put, ahead=1)
    b0 = feed.next()
    assert len(put.calls) == 1
    assert b0.minibatch_class == VALIDATION
    feed.prefetch()                 # "step 0" runs; batch 1 uploads
    assert len(put.calls) == 2
    b1 = feed.next()
    assert len(put.calls) == 2      # popped the pending one
    assert b1.minibatch_class == VALIDATION and b1.last_minibatch
    feed.prefetch()
    assert len(put.calls) == 3
    assert feed.stats()["on_demand"] == 1


@pytest.mark.parametrize("ahead, uploads", [(3, 4), (0, 1)])
def test_lookahead_depth_configurable(ahead, uploads):
    loader = make_loader()
    put = RecordingPut()
    feed = DeviceFeed(loader, put=put, ahead=ahead)
    feed.next()
    feed.prefetch()
    assert len(put.calls) == uploads
    assert feed.stats()["ahead"] == ahead


def test_metadata_alignment_through_full_epoch():
    loader = make_loader(minibatch=10, n_validation=20, n_train=40)
    feed = DeviceFeed(loader, put=None, ahead=1)
    expected = [(VALIDATION, False), (VALIDATION, True),
                (TRAIN, False), (TRAIN, False), (TRAIN, False),
                (TRAIN, True)]
    for i, (cls, last) in enumerate(expected):
        b = feed.next()
        assert (b.minibatch_class, b.last_minibatch) == (cls, last), i
        assert b.epoch_ended == (i == len(expected) - 1)
        assert loader.minibatch_class == cls
        assert loader.last_minibatch == last
        assert loader.epoch_ended == b.epoch_ended
        np.testing.assert_array_equal(loader.minibatch_valid, b.w_host)
        # between next() and prefetch() the cursor is at consumed + 1
        assert loader._cursor == (i + 1) % len(expected)
        feed.prefetch()
        assert loader._cursor in ((i + 2) % len(expected), i + 2)
    st = feed.stats()
    assert st["epochs"] == 1
    assert st["epoch_log"][0]["batches"] == len(expected)


def test_w_host_is_the_valid_mask():
    loader = make_loader(minibatch=15, n_validation=20, n_train=40)
    feed = DeviceFeed(loader, put=None, ahead=1)
    assert feed.next().w_host.sum() == 15
    b = feed.next()     # the wrapped last validation batch
    assert b.last_minibatch and b.w_host.sum() == 5


def test_byte_counter_and_device_sync():
    loader = make_loader()
    feed = DeviceFeed(loader, put=None, ahead=1)
    b = feed.next()
    per_batch = b.x.nbytes + b.y.nbytes + b.w_host.nbytes
    st = feed.stats()
    assert st["bytes_per_batch"] == per_batch == b.bytes_h2d
    assert st["bytes_h2d"] == per_batch
    feed.prefetch()
    assert feed.stats()["bytes_h2d"] == 2 * per_batch
    feed.note_device_sync(0.25)
    assert feed.stats()["device_sync_s"] == pytest.approx(0.25)
    assert set(st) >= {"bytes_per_batch", "uint8_wire", "loader_block_s",
                       "put_block_s", "device_sync_s", "on_demand",
                       "epoch_log"}


def test_cpu_put_makes_tensors_on_the_steps_device():
    class Step:
        device = torch.device("cpu")

    put = make_batch_put(Step())
    x = np.arange(12, dtype=np.uint8).reshape(3, 4)
    tx, ty = put((x, np.arange(3)))
    assert isinstance(tx, torch.Tensor) and tx.dtype == torch.uint8
    np.testing.assert_array_equal(tx.numpy(), x)


def _memmap_dir(tmp_path, sub="wire", n=96, hw=6, split=(0, 24, 72),
                seed=2):
    rng = np.random.RandomState(seed)
    labels = (np.arange(n) % 3).astype(np.int64)
    protos = rng.randint(60, 200, (3, hw, hw, 3)).astype(np.float32)
    data = np.clip(protos[labels] + rng.randn(n, hw, hw, 3) * 10,
                   0, 255).astype(np.uint8)
    perm = rng.permutation(n)
    mean = data.astype(np.float64).mean(0) / 127.5 - 1.0
    return mm.pack_arrays(str(tmp_path / sub), data[perm], labels[perm],
                          list(split), shard_mb=0.01,
                          mean_image=mean.astype(np.float32))


def _memmap_workflow(out, uint8_wire="auto", feed_ahead=None, max_epochs=3):
    prng._generators.clear()
    prng.seed_all(21)
    loader = mm.MemmapImageLoader(data_path=out, minibatch_size=24)
    wf = StandardWorkflow(
        layers=[{"type": "all2all_strictrelu", "output_sample_shape": 16,
                 "weights_stddev": 0.1},
                {"type": "softmax", "output_sample_shape": 3,
                 "weights_stddev": 0.05}],
        loader=loader, loss="softmax", n_classes=3,
        decision_config={"max_epochs": max_epochs, "fail_iterations": 50},
        gd_config={"learning_rate": 0.05, "gradient_moment": 0.9},
        name="Wire")
    wf.run_fused(device="cpu", uint8_wire=uint8_wire, feed_ahead=feed_ahead)
    return wf


def test_uint8_wire_quarters_h2d_bytes(tmp_path):
    out = _memmap_dir(tmp_path)
    wf_u8 = _memmap_workflow(out, "auto", max_epochs=1)
    wf_f32 = _memmap_workflow(out, False, max_epochs=1)
    overhead = 24 * 8 + 24 * 4          # int64 labels + f32 pad mask
    x_u8 = wf_u8.feed_stats["bytes_per_batch"] - overhead
    x_f32 = wf_f32.feed_stats["bytes_per_batch"] - overhead
    assert x_u8 == 24 * 6 * 6 * 3
    assert x_f32 == 4 * x_u8
    assert wf_u8.feed_stats["uint8_wire"] is True
    assert wf_f32.feed_stats["uint8_wire"] is False
    # the negotiation is the run's: the loader leaves as it came
    assert wf_u8.loader.emit == "float32"
    assert wf_u8.device_feed.stats()["on_demand"] == 1


def test_uint8_wire_tracks_the_float_wire(tmp_path):
    """The prologue on the device applies `_normalize`'s affine (with a
    multiplication where the host divides), so the two wires train the
    same trajectory within the JAX test's tolerance."""
    out = _memmap_dir(tmp_path)
    wf_u8 = _memmap_workflow(out, "auto")
    wf_f32 = _memmap_workflow(out, False)
    assert wf_u8.feed_stats["uint8_wire"] and \
        not wf_f32.feed_stats["uint8_wire"]
    assert wf_u8.decision.history == wf_f32.decision.history
    np.testing.assert_allclose(
        wf_u8.forwards[-1].weights.detach().numpy(),
        wf_f32.forwards[-1].weights.detach().numpy(), rtol=1e-4, atol=1e-5)


def test_feed_ahead_one_and_zero_give_the_same_bits(tmp_path):
    out = _memmap_dir(tmp_path)
    runs = [_memmap_workflow(out, "auto", feed_ahead=a) for a in (1, 0)]
    assert [wf.device_feed.ahead for wf in runs] == [1, 0]
    assert runs[0].feed_stats["on_demand"] == 1
    assert runs[1].feed_stats["on_demand"] == runs[1].feed_stats["batches"]
    assert runs[0].decision.history == runs[1].decision.history
    assert runs[0].evaluator.loss == runs[1].evaluator.loss
    for ua, ub, ga, gb in zip(runs[0].forwards, runs[1].forwards,
                              runs[0].gds[::-1], runs[1].gds[::-1]):
        for k, t in ua.param_arrays().items():
            assert torch.equal(t, ub.param_arrays()[k]), k
        for name in ("vel_w", "vel_b"):
            assert torch.equal(getattr(ga, name), getattr(gb, name))


def test_uint8_wire_false_pins_float_emission(tmp_path):
    out = _memmap_dir(tmp_path, n=48, hw=4, split=(0, 16, 32))
    prng.seed_all(51)
    loader = mm.MemmapImageLoader(data_path=out, minibatch_size=16,
                                  emit="uint8", mean_normalize=False)
    wf = StandardWorkflow(
        layers=[{"type": "softmax", "output_sample_shape": 3,
                 "weights_stddev": 0.1}],
        loader=loader, loss="softmax", n_classes=3,
        decision_config={"max_epochs": 1}, name="Pin")
    assert wf._wire_spec(False) == {"emit": "float32", "normalize": None}
    wf.run_fused(device="cpu", uint8_wire=False)
    assert wf.feed_stats["uint8_wire"] is False
    assert wf.loader.emit == "uint8"


def test_synthetic_loader_keeps_the_float_wire():
    loader = make_loader()
    wf = StandardWorkflow(
        layers=[{"type": "softmax", "output_sample_shape": 4,
                 "weights_stddev": 0.1}],
        loader=loader, loss="softmax", n_classes=4,
        decision_config={"max_epochs": 2}, name="Synthetic")
    assert wf._wire_spec("auto") is None
    wf.run_fused(device="cpu")
    st = wf.feed_stats
    assert st["uint8_wire"] is False and st["epochs"] == 2
    assert st["batches"] == 12 and st["on_demand"] == 1


def test_clean_stop_releases_produce_threads(tmp_path):
    out = _memmap_dir(tmp_path, n=64, hw=4, split=(0, 0, 64))
    prng.seed_all(17)
    loader = mm.MemmapImageLoader(data_path=out, minibatch_size=16,
                                  n_workers=2, prefetch=2)
    loader.initialize()
    feed = DeviceFeed(loader, put=None, ahead=2)
    feed.next()
    feed.prefetch()
    assert any("-produce" in t.name for t in threading.enumerate())
    feed.stop()
    assert loader._pool is None
    assert loader.feed_stats["batches"] >= 3
    stats = mm.loader_throughput(loader, n_batches=2)
    assert stats["feed"]["batches"] >= 3
    loader.stop()


def _jax_run(out):
    from veles_tpu.config import root as jroot
    from veles_tpu.ops import variants as jvariants
    from veles_tpu.samples import alexnet as jalexnet
    from tests.test_torch_run_fused import _no_dropout, _restore, _select

    saved = jroot.alexnet.loader.get("data_path")
    jroot.alexnet.loader.data_path = out
    jprng._generators.clear()
    jprng.seed_all(SEED)
    try:
        jwf = jalexnet.create_workflow(**TOY)
    finally:
        jroot.alexnet.loader.data_path = saved
    _no_dropout(jwf)
    prev = _select(jvariants, lrn_maxpool="fused[rt=2,io=native,fuse=1]",
                   sgd_update="pallas_rows[rt=8]")
    try:
        with jvariants.pallas_interpret():
            jwf.run_fused(epochs=2)
    finally:
        _restore(jvariants, prev)
        jwf._stop_units()
    return jwf


def _port_run(out, feed_ahead=None):
    from veles_tpu_torch import root
    from veles_tpu_torch.ops import variants
    from veles_tpu_torch.samples import alexnet
    from tests.test_torch_run_fused import _no_dropout, _restore, _select

    saved = root.alexnet.loader.data_path
    root.alexnet.loader.data_path = out
    prng._generators.clear()
    prng.seed_all(SEED)
    try:
        pwf = alexnet.create_workflow(**TOY)
    finally:
        root.alexnet.loader.data_path = saved
    _no_dropout(pwf)
    prev = _select(variants, lrn_maxpool="fused", sgd_update="kernel")
    try:
        pwf.run_fused(epochs=2, device="cpu", feed_ahead=feed_ahead)
    finally:
        _restore(variants, prev)
    return pwf


def test_toy_alexnet_from_a_memmap_tracks_the_jax_package(tmp_path):
    """Two epochs from one packed directory (12 train and 4 validation
    images of 67x67x3 made from a numpy seed, with a mean image) on the
    uint8 wire in both packages."""
    out = _memmap_dir(tmp_path, "alexnet", n=16, hw=67, split=(0, 4, 12),
                      seed=4)
    jwf = _jax_run(out)
    pwf = _port_run(out)
    assert jwf.feed_stats["uint8_wire"] and pwf.feed_stats["uint8_wire"]
    assert pwf.feed_stats["bytes_per_batch"] \
        == jwf.feed_stats["bytes_per_batch"] == 8 * (67 * 67 * 3 + 8 + 4)
    assert len(pwf.decision.history) == 2
    assert pwf.decision.history == jwf.decision.history
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
                assert getattr(pg, name) is None, (i, name)
                continue
            np.testing.assert_allclose(
                getattr(pg, name).numpy(), np.asarray(jv.mem), rtol=RTOL,
                atol=ATOL, err_msg=f"unit {i} {name}")


@pytest.mark.parametrize("argv, ok", [
    (["--fused", "--feed-ahead", "2"], True),
    (["--fused", "--feed-ahead", "0"], True),
    (["--fused", "--feed-ahead", "-1"], False),
    (["--serve", "0", "--feed-ahead", "1"], False),
])
def test_feed_ahead_cli_refusals(argv, ok):
    args = ["veles_tpu_torch/samples/alexnet.py", *argv]
    if ok:
        assert launcher.parse_args(args).feed_ahead == int(argv[-1])
    else:
        with pytest.raises(SystemExit):
            launcher.parse_args(args)


def _trace(copy_start, kernels=((0, 10), (10, 20)), copy_stream=13,
           name="Memcpy HtoD (Pinned -> Device)", call_dur=1):
    """A chrome trace: kernels (start, end) in µs on stream 7, issued at 0
    and 1, and one 19.8 MB copy whose runtime call starts at 5 and lasts
    call_dur µs, that runs from copy_start for 4 µs."""
    ev = []
    for i, (a, b) in enumerate(kernels):
        ev.append({"ph": "X", "cat": "kernel", "name": f"k{i}", "ts": a,
                   "dur": b - a, "args": {"stream": 7, "correlation": i}})
        ev.append({"ph": "X", "cat": "cuda_runtime", "name":
                   "cudaLaunchKernel", "ts": i, "dur": 1,
                   "args": {"correlation": i}})
    ev.append({"ph": "X", "cat": "gpu_memcpy", "name": name,
               "ts": copy_start, "dur": 4,
               "args": {"stream": copy_stream, "correlation": 99,
                        "bytes": 19787136}})
    ev.append({"ph": "X", "cat": "cuda_runtime", "name": "cudaMemcpyAsync",
               "ts": 5, "dur": call_dur, "args": {"correlation": 99}})
    return ev


@pytest.mark.parametrize("copy_start, stream, waited, overlap", [
    (6, 13, 0, 0.004),      # runs under the step's second kernel
    (20, 13, 1, 0.0),       # waited for the work queued before it
    (6, 7, 0, 0.004),       # on the compute stream itself
])
def test_chip_smokes_overlap_reading_of_a_trace(copy_start, stream, waited,
                                                overlap):
    """chip_smoke's FEED profile reads a copy that started only after the
    compute work queued when it was issued as one that waited, and one on
    the kernels' stream as on the compute stream."""
    import chip_smoke

    s, _ = chip_smoke.feed_overlap(_trace(copy_start, copy_stream=stream))
    assert s["batch_copies"] == 1 and s["batch_copies_pinned"]
    assert s["batch_copies_issued_with_work_pending"] == 1
    assert s["batch_copies_that_waited_for_compute"] == waited
    assert s["batch_copies_on_compute_stream"] == (stream == 7)
    assert s["batch_overlap_ms"] == pytest.approx(overlap)


@pytest.mark.parametrize("call_dur, pending, waited", [
    (16, 0, 0),     # the step's last kernel ended before the call returned
    (10, 1, 1),     # it ran past the call's return, and the copy after it
])
def test_chip_smoke_judges_pending_work_when_the_copy_is_queued(
        call_dur, pending, waited):
    """A copy is queued when its runtime call returns: compute work that
    ended inside the call was not pending, and a copy that began after it
    did not wait for it; work that outlasted the call still counts."""
    import chip_smoke

    s, _ = chip_smoke.feed_overlap(_trace(22, call_dur=call_dur))
    assert s["batch_copies_issued_with_work_pending"] == pending
    assert s["batch_copies_that_waited_for_compute"] == waited
    row = s["batch_copy_rows"][0]
    assert row["pending_at_call_start"] == 2
    assert row["issue_call_ms"] == pytest.approx(call_dur / 1e3)
    assert row["start_after_issue_ms"] == pytest.approx(0.017)


@pytest.mark.parametrize("copy_start, overlap", [
    (110, 0.004),       # ran under the spin queued before it
    (1100, 0.0),        # waited for the spin to end
])
def test_chip_smoke_reads_the_queued_upload_apart(copy_start, overlap):
    """The queued upload (a spin kernel on the compute stream, then one
    batch copy) after the profiled window is read apart from the
    training loop's copies: its copy against the spin alone."""
    import chip_smoke

    ev = _trace(6)
    ev.append({"ph": "X", "cat": "kernel", "ts": 100, "dur": 1000,
               "name": "at::cuda::(anonymous namespace)::spin_kernel(long)",
               "args": {"stream": 7, "correlation": 200}})
    ev.append({"ph": "X", "cat": "cuda_runtime", "name": "cudaLaunchKernel",
               "ts": 98, "dur": 1, "args": {"correlation": 200}})
    ev.append({"ph": "X", "cat": "gpu_memcpy",
               "name": "Memcpy HtoD (Pinned -> Device)", "ts": copy_start,
               "dur": 4, "args": {"stream": 17, "correlation": 201,
                                  "bytes": 19787136}})
    ev.append({"ph": "X", "cat": "cuda_runtime", "name": "cudaMemcpyAsync",
               "ts": 105, "dur": 1, "args": {"correlation": 201}})
    s, gpu = chip_smoke.feed_overlap(ev)
    assert s["batch_copies"] == 1 and s["htod_copies"] == 1
    assert s["kernel_streams"] == {7: 2} and len(gpu) == 3
    assert s["batch_overlap_ms"] == pytest.approx(0.004)
    q = s["queued_upload"]
    assert q["spin_ms"] == pytest.approx(1.0)
    assert (q["stream"], q["spin_stream"]) == (17, 7)
    assert q["start_after_spin_start_ms"] == pytest.approx(
        (copy_start - 100) / 1e3)
    assert q["overlap_ms"] == pytest.approx(overlap)
