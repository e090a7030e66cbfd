"""`parallel/checkpoint.py` of the port on the CPU: `save_state`,
`restore_state` and `CheckpointGeometryError`, held to the properties the
JAX package's tests state (tests/test_sharded_checkpoint.py
`test_local_state_roundtrip`, `test_geometry_mismatch_raises_clear_error`,
`test_roundtrip_nondefault_prng_impl_and_adam`). The JAX functions
themselves cannot run as a reference here: under this machine's orbax
their save writes an empty tree.

- A state saved after a train step and restored into a step built from
  another seed gives the same bits in every leaf, velocity, moment and
  `t`, and training continues with the same bits (loss and state) from
  the restored state as from the saved one, at dropout 0 and 0.5 (the
  dropout stream's position rides in the file).
- A step of another geometry, or of another update rule, refuses the
  checkpoint with CheckpointGeometryError, naming each leaf; a file cut
  short is refused; neither loads anything or moves the stream.
"""

import os

import numpy as np
import pytest
import torch

from veles_tpu import prng as jprng
from veles_tpu_torch import prng
from veles_tpu_torch.loader.synthetic import SyntheticClassifierLoader
from veles_tpu_torch.parallel.checkpoint import CheckpointGeometryError, \
    restore_state, save_state
from veles_tpu_torch.samples import alexnet
from veles_tpu_torch.znicz.standard_workflow import StandardWorkflow
from tests.test_torch_adam import FC_LAYERS, fc_batch
from tests.test_torch_train_repeat import _same_bits
from tests.test_torch_train_step import TOY


@pytest.fixture(autouse=True)
def _restore_base_seeds():
    saved = jprng._base_seed, prng._base_seed
    yield
    jprng._base_seed, prng._base_seed = saved


def _toy_step(seed, ratio, optimizer="sgd", **over):
    prng._generators.clear()
    prng.seed_all(seed)
    wf = alexnet.create_workflow(**dict(TOY, **over))
    for u in wf.forwards:
        if hasattr(u, "dropout_ratio"):
            u.dropout_ratio = ratio
    for g in wf.gds:
        g.optimizer = optimizer
        if optimizer == "adam":
            g.learning_rate = 1e-4
    wf.initialize("cpu")
    return wf.build_fused_step()


def _fc_step(seed, width=32, optimizer="adam"):
    prng._generators.clear()
    prng.seed_all(seed)
    layers = [dict(FC_LAYERS[0], output_sample_shape=width), FC_LAYERS[1]]
    wf = StandardWorkflow(
        layers=layers, loader=SyntheticClassifierLoader(
            n_classes=10, sample_shape=(8, 8), n_validation=48,
            n_train=240, minibatch_size=48, noise=0.6),
        loss="softmax", n_classes=10,
        gd_config={"learning_rate": 3e-3, "optimizer": optimizer})
    wf.initialize("cpu")
    return wf.build_fused_step()


def _batch(seed):
    rs = np.random.RandomState(seed)
    return (rs.randn(8, 67, 67, 3).astype(np.float32),
            rs.randint(0, 16, 8), np.ones(8, np.float32))


@pytest.mark.parametrize("optimizer", ["sgd", "adam"])
@pytest.mark.parametrize("ratio", [0.0, 0.5])
def test_round_trip_into_another_seeds_step_trains_on_identically(
        tmp_path, ratio, optimizer):
    step = _toy_step(7, ratio, optimizer)
    state = step.init_state()
    for i in range(2):
        state, _ = step.train(state, *_batch(60 + i))
    path = save_state(state, str(tmp_path))
    assert path == os.path.join(str(tmp_path), "state.pt")
    assert os.listdir(tmp_path) == ["state.pt"]     # no temporary left
    # the continuation from the saved state, on the saved stream position
    want_state, (want_loss, want_err) = step.train(state, *_batch(62))
    want_stream = step.gen.get_state()

    other = _toy_step(999, ratio, optimizer)     # another init, stream
    assert not torch.equal(other.init_state()["params"][0]["weights"],
                           state["params"][0]["weights"])
    restored = restore_state(other, str(tmp_path))
    assert restored["lr_scale"] == 1.0
    assert all(t.requires_grad and t.is_leaf
               for layer in restored["params"] for t in layer.values())
    if optimizer == "adam":
        assert {int(v["t"]) for v, p in zip(restored["vel"],
                                            restored["params"]) if p} == {2}
        assert restored["vel"][0]["t"].dtype == torch.int32
    got_state, (got_loss, got_err) = other.train(restored, *_batch(62))
    assert float(got_loss) == float(want_loss)
    assert int(got_err) == int(want_err)
    assert _same_bits(got_state, want_state)
    assert torch.equal(other.gen.get_state(), want_stream)


def test_the_restored_tensors_are_the_saved_bits(tmp_path):
    step = _fc_step(1234)
    state = step.init_state()
    x, y, w = fc_batch(0)
    state, _ = step.train(state, x, y, w)
    save_state(state, str(tmp_path))
    restored = restore_state(_fc_step(999), str(tmp_path))
    assert _same_bits(restored, state)
    assert set(restored["vel"][0]) == {"m", "v", "t"}
    assert int(restored["vel"][1]["t"]) == 1


def test_a_mismatched_step_raises_the_geometry_error(tmp_path):
    step = _fc_step(1234)
    save_state(step.init_state(), str(tmp_path))
    narrow = _fc_step(55, width=16)
    stream = narrow.gen.get_state()
    with pytest.raises(CheckpointGeometryError) as exc:
        restore_state(narrow, str(tmp_path))
    msg = str(exc.value)
    assert "mismatched leaves" in msg and "params/0/weights" in msg
    assert "params/0/weights: saved (64, 32)/float32 != target " \
           "(64, 16)/float32" in exc.value.mismatches
    assert "vel/0/m/bias: saved (32,)/float32 != target (16,)/float32" \
        in exc.value.mismatches
    # the first layer's weights and bias, the softmax's weights, each as
    # a leaf and two moments
    assert len(exc.value.mismatches) == 9
    assert torch.equal(narrow.gen.get_state(), stream)
    # another update rule: the SGD velocities are not the Adam state
    sgd = _fc_step(55, optimizer="sgd")
    with pytest.raises(CheckpointGeometryError) as exc:
        restore_state(sgd, str(tmp_path))
    assert "vel/0/t: in checkpoint only (saved ()/int32)" \
        in exc.value.mismatches
    assert "vel/0/weights: in restore target only (want (64, 32)/float32)" \
        in exc.value.mismatches


def test_a_toy_alexnet_of_other_widths_refuses_the_checkpoint(tmp_path):
    step = _toy_step(7, 0.0)
    save_state(step.init_state(), str(tmp_path))
    wide = _toy_step(7, 0.0, fc_width=32)
    with pytest.raises(CheckpointGeometryError) as exc:
        restore_state(wide, str(tmp_path))
    assert exc.value.mismatches
    assert all("fc" not in m and ("/10/" in m or "/12/" in m
                                  or "/14/" in m)
               for m in exc.value.mismatches)


def test_a_file_cut_short_is_refused_and_nothing_moves(tmp_path):
    step = _toy_step(7, 0.5)
    state = step.init_state()
    state, _ = step.train(state, *_batch(3))
    path = save_state(state, str(tmp_path))
    size = os.path.getsize(path)
    with open(path, "r+b") as f:
        f.truncate(size // 2)
    stream = step.gen.get_state()
    with pytest.raises(RuntimeError, match="unreadable"):
        restore_state(step, str(tmp_path))
    assert torch.equal(step.gen.get_state(), stream)
    for junk in (b"not a checkpoint", b""):
        with open(path, "wb") as f:
            f.write(junk)
        with pytest.raises(RuntimeError, match="unreadable"):
            restore_state(step, str(tmp_path))
    torch.save({"format": "something else"}, path)
    with pytest.raises(RuntimeError, match="is not a .* checkpoint"):
        restore_state(step, str(tmp_path))
    os.remove(path)
    with pytest.raises(FileNotFoundError):
        restore_state(step, str(tmp_path))
