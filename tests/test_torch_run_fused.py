"""The training slice as a whole on the CPU: `run_fused` of the toy AlexNet
in the port and in the JAX package, from one seed.

Both packages build the same workflow (toy geometry of
`__graft_entry__.py`, init "scaled", dropout 0, 12 train and 4 validation
samples in minibatches of 8, so both class passes end in a wrapped
minibatch with pad-mask rows), the same loader sequence and bit-identical
initial parameters, and train two epochs through their fused steps: the
JAX package with `lrn_maxpool=fused[rt=2,io=native,fuse=1]` and
`sgd_update=pallas_rows[rt=8]` (Pallas in interpret mode, the float32
wire), the port with `fused` and `kernel`. The Decision's `history` (the
per-class error counts of each epoch) must be equal; the final pass's
loss must agree within rtol 1e-5, and the written-back parameters and
velocities within rtol 1e-4, atol 1e-7 (f32 sums in other orders, as in
tests/test_torch_train_step.py; this seed's minibatches have no pooling
window whose two largest values tie within that rounding).
"""

import numpy as np
import pytest

from veles_tpu import prng as jprng
from veles_tpu.ops import variants as jvariants
from veles_tpu.samples import alexnet as jalexnet
from veles_tpu_torch import prng
from veles_tpu_torch.ops import variants
from veles_tpu_torch.samples import alexnet

TOY = dict(minibatch_size=8, width_mult=0.125, fc_width=64, n_train=12,
           n_validation=4, n_classes=16, input_hw=67, init="scaled")
SEED = 11
RTOL, ATOL = 1e-4, 1e-7


@pytest.fixture(autouse=True)
def _restore_base_seeds():
    saved = jprng._base_seed, prng._base_seed
    yield
    jprng._base_seed, prng._base_seed = saved


def _no_dropout(wf):
    for u in wf.forwards:
        if hasattr(u, "dropout_ratio"):
            u.dropout_ratio = 0.0


def _select(registry, **sel):
    prev = {op: registry.selected(op) for op in sel}
    for op, name in sel.items():
        registry.select(op, name)
    return prev


def _restore(registry, prev):
    for op, name in prev.items():
        if name is None:
            registry.clear_selection(op)
        else:
            registry.select(op, name)


def test_two_epochs_of_run_fused_track_the_jax_package():
    jprng._generators.clear()
    jprng.seed_all(SEED)
    jwf = jalexnet.create_workflow(**TOY)
    _no_dropout(jwf)
    prev = _select(jvariants, lrn_maxpool="fused[rt=2,io=native,fuse=1]",
                   sgd_update="pallas_rows[rt=8]")
    try:
        with jvariants.pallas_interpret():
            jwf.run_fused(epochs=2, uint8_wire=False)
    finally:
        _restore(jvariants, prev)

    prng._generators.clear()
    prng.seed_all(SEED)
    pwf = alexnet.create_workflow(**TOY)
    _no_dropout(pwf)
    prev = _select(variants, lrn_maxpool="fused", sgd_update="kernel")
    try:
        pwf.run_fused(epochs=2, device="cpu")
    finally:
        _restore(variants, prev)

    assert len(pwf.decision.history) == 2
    assert pwf.decision.history == jwf.decision.history
    assert pwf.decision.complete and bool(jwf.decision.complete)
    assert pwf.decision.best_validation_err \
        == jwf.decision.best_validation_err
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
    jwf._stop_units()
