"""The port's grad_reduce family and ZeRO plan on the CPU, held against
the JAX package's pure functions and the numpy goldens.

- `q8_encode` against `ops/reference.quantize_blockwise` (the port's and
  the JAX package's) and the JAX `q8_encode`: codes and scales bit for
  bit, a zero block, a partial last block and one huge element included;
- the byte model, the (hosts x local) geometry, the residual lengths and
  the configs against the JAX functions under the same
  VELES_GRAD_REDUCE_LOCAL (both read it);
- `zero_leaf`, `zero_plan`, `zero_plan_local_elems`, `zero_ef_plan` and
  `mesh_shape` against the JAX mesh module's;
- every named point run in a gloo group of 4 processes (flat, and the
  hierarchy as 2 hosts x 2 ranks) on seeded partials: f32 and hier2
  within 1e-6 of the numpy sum, bf16 within the bf16 rounding of each
  partial and of the sum, int8_block and int8_ef the golden's decoded
  codes summed (within f32 rounding of the summation order), and the EF
  residual its rule bit for bit: x + resid - decode(code(x + resid)).
"""

import os
import pickle
import socket
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from veles_tpu.ops import reference as jreference
from veles_tpu.ops import variants as jvariants
from veles_tpu.parallel import mesh as jmesh
from veles_tpu_torch.ops import reference, variants
from veles_tpu_torch.parallel import mesh

REPO = Path(__file__).resolve().parent.parent
NAMES = ("f32", "bf16", "int8_block", "int8_ef", "hier2")
WORLD, LOCAL, PADDED, BLK = 4, 2, 1040, 256


def _golden_codes(x, blk):
    pad = (-x.shape[1]) % blk
    xp = np.pad(x, ((0, 0), (0, pad)))
    return reference.quantize_blockwise(xp, blk), \
        jreference.quantize_blockwise(xp, blk)


@pytest.mark.parametrize("cols", [256, 300, 1040])
def test_q8_encode_is_the_golden_bit_for_bit(cols):
    rs = np.random.RandomState(cols)
    x = rs.randn(4, cols).astype(np.float32) * 1e-3
    x[1, :256] = 0.0                      # an all-zero block: scale 1
    x[2, 7] = 3e4                         # one huge element
    q, s = variants.q8_encode(torch.from_numpy(x), BLK)
    (gq, gs), (jq, js) = _golden_codes(x, BLK)
    np.testing.assert_array_equal(q.numpy(), gq)
    np.testing.assert_array_equal(s.numpy(), gs)
    np.testing.assert_array_equal(gq, jq)
    np.testing.assert_array_equal(gs, js)
    import jax.numpy as jnp
    jq2, js2 = jvariants.q8_encode(jnp.asarray(x), BLK)
    np.testing.assert_array_equal(q.numpy(), np.asarray(jq2))
    np.testing.assert_array_equal(s.numpy(), np.asarray(js2))
    # decode is the golden's dequantize
    np.testing.assert_array_equal(
        variants.q8_decode(q, s, BLK).numpy(),
        reference.dequantize_blockwise(gq, gs, BLK))


@pytest.mark.parametrize("local", ["1", "2", "3", "4", "8"])
@pytest.mark.parametrize("n", [1, 2, 4, 6])
def test_byte_model_and_geometry_equal_the_jax_functions(monkeypatch, n,
                                                         local):
    monkeypatch.setenv("VELES_GRAD_REDUCE_LOCAL", local)
    assert variants.grad_reduce_geometry(n) \
        == jvariants.grad_reduce_geometry(n)
    for name in NAMES:
        assert variants.grad_reduce_config(name) \
            == jvariants.grad_reduce_config(name)
        assert variants.grad_reduce_bytes(name, 123457, n) \
            == jvariants.grad_reduce_bytes(name, 123457, n)
        for padded in (8, 1040, 4096):
            assert variants.grad_reduce_resid_len(name, padded, n) \
                == jvariants.grad_reduce_resid_len(name, padded, n)
    assert variants.grad_reduce_config("wire[dt=int8]") is None


@pytest.mark.parametrize("n,hosts,want", [(4, 2, (2, 2)), (8, 2, (2, 4)),
                                           (4, 1, (1, 4)), (6, 4, (6, 1))])
def test_geometry_follows_the_mesh_hosts(monkeypatch, n, hosts, want):
    """Given the hosts the mesh counted, the geometry is the mesh's (a
    count that does not tile the ranks clamps as a request does), over
    $LOCAL_WORLD_SIZE; an explicit $VELES_GRAD_REDUCE_LOCAL overrides
    both, and without hosts the JAX function's rule holds."""
    monkeypatch.delenv("VELES_GRAD_REDUCE_LOCAL", raising=False)
    monkeypatch.setenv("LOCAL_WORLD_SIZE", "1")
    assert variants.grad_reduce_geometry(n, hosts) == want
    assert variants.grad_reduce_bytes("hier2", 123457, n, hosts)[
        "geometry"] == {"hosts": want[0], "local": want[1]}
    assert variants.grad_reduce_geometry(n) == (n, 1)
    monkeypatch.setenv("VELES_GRAD_REDUCE_LOCAL", str(n))
    assert variants.grad_reduce_geometry(n, hosts) == (1, n)
    assert variants.grad_reduce_geometry(n) \
        == jvariants.grad_reduce_geometry(n)


SHAPES = [(5, 5, 3, 8), (8,), (1000,), (4096, 10), (), (7, 3)]


@pytest.mark.parametrize("n", [1, 2, 3, 4, 8])
def test_zero_plan_equals_the_jax_plan(n):
    tree = {f"p{i}": np.zeros(s, np.float32) for i, s in enumerate(SHAPES)}
    mine = mesh.zero_plan({k: torch.from_numpy(v) for k, v in tree.items()},
                          n)
    theirs = jmesh.zero_plan(tree, n)
    for k in tree:
        a, b = mine[k], theirs[k]
        assert (a.shape, a.size, a.padded, a.local, a.ndim) \
            == (b.shape, b.size, b.padded, b.local, b.ndim)
        assert mesh.zero_leaf(a.shape, n) == a
    assert mesh.zero_plan_local_elems(mine) \
        == jmesh.zero_plan_local_elems(theirs)
    ef_mine = mesh.zero_ef_plan(mine, lambda p: p // 2)
    ef_theirs = jmesh.zero_ef_plan(theirs, lambda p: p // 2)
    assert ef_mine == ef_theirs
    for k, v in tree.items():
        t = torch.arange(v.size, dtype=torch.float32).reshape(v.shape)
        flat = mesh.zero_flatten(t, mine[k])
        assert flat.shape == (mine[k].padded,)
        assert not flat[mine[k].size:].any()
        assert torch.equal(mesh.zero_unflatten(flat, mine[k]), t)
    for m, s in ((1, 1), (2, 1), (1, 2), (2, 2)):
        if n % (m * s) == 0:
            assert mesh.mesh_shape(n, model=m, seq=s) \
                == jmesh.mesh_shape(n, model=m, seq=s)
    with pytest.raises(ValueError):
        mesh.zero_leaf((3,), 0)
    with pytest.raises(ValueError):
        mesh.mesh_shape(6, model=4)


WORKER = r'''
import os, pickle, sys
import numpy as np
import torch

rank, world, port, out = (int(sys.argv[1]), int(sys.argv[2]), sys.argv[3],
                          sys.argv[4])
torch.set_num_threads(1)
from veles_tpu_torch.ops import variants
from veles_tpu_torch.parallel import distributed, mesh as M

distributed.initialize_distributed(f"127.0.0.1:{port}", rank, world,
                                   backend="gloo", timeout_s=120)
m = M.make_mesh(device="cpu")
with open(os.path.join(out, "inputs.pkl"), "rb") as f:
    inp = pickle.load(f)
res = {}
for local in ("4", "2"):
    os.environ["VELES_GRAD_REDUCE_LOCAL"] = local
    for name in inp["names"]:
        apply = variants.get("grad_reduce", name).apply
        flat = torch.from_numpy(inp["partials"][rank])
        if apply.gr_config["ef"]:
            n_res = variants.grad_reduce_resid_len(name, flat.numel(),
                                                   world)
            resid = torch.from_numpy(inp["resid"][rank][:n_res])
            got, new = apply(flat, m, resid)
            res[(local, name)] = (got.numpy(), new.numpy())
        else:
            res[(local, name)] = (apply(flat, m).numpy(), None)
with open(os.path.join(out, f"rank{rank}.pkl"), "wb") as f:
    pickle.dump(res, f)
distributed.shutdown_distributed()
'''


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    out = tmp_path_factory.mktemp("grad_reduce")
    rs = np.random.RandomState(5)
    partials = [rs.randn(PADDED).astype(np.float32) * 1e-2
                for _ in range(WORLD)]
    for p in partials:
        p[-40:] = 0.0                     # a leaf's zero pad
    resid = [rs.randn(PADDED).astype(np.float32) * 1e-5
             for _ in range(WORLD)]
    inputs = {"names": NAMES, "partials": partials, "resid": resid}
    with open(out / "inputs.pkl", "wb") as f:
        pickle.dump(inputs, f)
    worker = out / "worker.py"
    worker.write_text(WORKER)
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = str(s.getsockname()[1])
    env = dict(os.environ, PYTHONPATH=str(REPO), OMP_NUM_THREADS="1")
    procs = [subprocess.Popen(
        [sys.executable, str(worker), str(r), str(WORLD), port, str(out)],
        env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
        text=True) for r in range(WORLD)]
    logs = []
    try:
        for p in procs:
            logs.append(p.communicate(timeout=180)[0])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
    assert all(p.returncode == 0 for p in procs), "\n".join(
        log[-3000:] for log in logs)
    ranks = []
    for r in range(WORLD):
        with open(out / f"rank{r}.pkl", "rb") as f:
            ranks.append(pickle.load(f))
    return inputs, ranks


def _slice(a, r):
    n = PADDED // WORLD
    return a[r * n:(r + 1) * n]


@pytest.mark.parametrize("local", ["4", "2"])
@pytest.mark.parametrize("name", ["f32", "hier2"])
def test_exact_points_give_the_sum(world, local, name):
    inputs, ranks = world
    total = np.sum(np.stack(inputs["partials"]).astype(np.float64), axis=0)
    for r in range(WORLD):
        got, resid = ranks[r][(local, name)]
        assert resid is None
        # f32 sums of 4 partials of ~1e-2: a few f32 ulps of the terms
        np.testing.assert_allclose(got, _slice(total, r), rtol=1e-6,
                                   atol=1e-8)
    # the leaf's zero pad sums to zero
    assert not ranks[WORLD - 1][(local, name)][0][-40:].any()


@pytest.mark.parametrize("local", ["4", "2"])
def test_bf16_point_rounds_the_partials_and_the_sum(world, local):
    inputs, ranks = world
    parts = np.stack(inputs["partials"])
    bf = torch.from_numpy(parts).to(torch.bfloat16).to(torch.float64)
    total = bf.sum(0).numpy()
    # each partial rounded to bf16, the sum rounded once per addition
    ulp = 2.0 ** -8 * np.abs(parts).sum(0) * WORLD
    for r in range(WORLD):
        got, _ = ranks[r][(local, "bf16")]
        assert np.all(np.abs(got - _slice(total, r))
                      <= _slice(ulp, r) + 1e-12)


def _int8_golden(inputs, r, with_resid, n_hosts=1):
    """The flat int8 exchange's answer for rank r: every rank codes its
    (n, local) partial (+ residual) by the golden, rank r sums the
    decoded rows bound for it."""
    n = PADDED // WORLD
    rows = []
    resids = []
    for j in range(WORLD):
        x = inputs["partials"][j].reshape(WORLD, n).copy()
        if with_resid:
            x = x + inputs["resid"][j].reshape(WORLD, n)
        pad = (-n) % BLK
        q, s = reference.quantize_blockwise(
            np.pad(x, ((0, 0), (0, pad))), BLK)
        dec = reference.dequantize_blockwise(q, s, BLK)[:, :n]
        rows.append(dec[r])
        resids.append((x - dec).reshape(-1))
    return np.sum(np.stack(rows).astype(np.float64), axis=0), resids[r]


@pytest.mark.parametrize("name", ["int8_block", "int8_ef"])
def test_int8_points_sum_the_golden_codes(world, name):
    inputs, ranks = world
    ef = name == "int8_ef"
    for r in range(WORLD):
        got, resid = ranks[r][("4", name)]
        want, want_resid = _int8_golden(inputs, r, ef)
        np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-8)
        if ef:
            # the residual rule, bit for bit
            np.testing.assert_array_equal(resid, want_resid)
        else:
            assert resid is None


def test_flat_points_ignore_the_host_geometry(world):
    """Only hier2 decomposes over (hosts x local): under local 2 every
    other point runs its flat exchange, the same bits as under local 4."""
    inputs, ranks = world
    for r in range(WORLD):
        for name in ("f32", "bf16", "int8_block", "int8_ef"):
            a, ra = ranks[r][("4", name)]
            b, rb = ranks[r][("2", name)]
            np.testing.assert_array_equal(a, b)
            if ra is not None:
                assert ra.shape == (PADDED,)
                np.testing.assert_array_equal(ra, rb)
