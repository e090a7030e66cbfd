"""The port's autotune cache, its CLI and what a selected winner changes
in the fused step, on the CPU, held against the JAX package's.

- The cache (after tests/test_variants_autotune.py:191-335): a round
  trip across instances, a corrupt file and a version skew read as empty
  and are rewritten, the keys leave the batch out (winners tuned at
  batch 4 apply at 8), `apply_cached` refuses a winner whose kernel no
  longer fits ($VELES_SMEM_BUDGET), and a JAX cache at the same path is
  neither a crash nor clobbered (its keys carry its own device names).
- End to end: `--fused --autotune --autotune-budget 8 --device cpu` on the
  toy AlexNet tunes (timing calls counted by `autotune.TIMINGS`), a
  second run times nothing and picks the same winners, a plain `--fused`
  run applies them, `veles_tpu_torch.tools.autotune` prints its JSON.
- Under the same selection by name (the stem's `gen[pack=s2d,...]`,
  `lrn_maxpool` fused or composed, `maxpool` slices, and the stem's LRN
  epilogue), one fused step tracks the JAX `FusedTrainStep` within the
  TRAIN tolerance of tests/test_torch_train_step.py (loss rtol 1e-5,
  params and velocities rtol 1e-4, atol 1e-7, n_err equal), and the
  variant table follows the JAX table's fusion precedence
  (tests/test_kernel_search.py:726, :880-955).
- The launcher refuses what the JAX launcher refuses, with its wording
  (veles_tpu/launcher.py:75-99; the port has no listen/master mode).
"""

import json
import logging

import numpy as np
import pytest
import torch

from tests.test_torch_train_step import (JAX_SEL, LOSS_RTOL, _batch,
                                         _compare_states, _Selected,
                                         _workflows)
from veles_tpu.launcher import Launcher
from veles_tpu.ops import autotune as jat
from veles_tpu.ops import variants as jvariants
from veles_tpu_torch import convert, launcher, prng
from veles_tpu_torch.ops import autotune as at
from veles_tpu_torch.ops import templates, variants
from veles_tpu_torch.samples import alexnet

TOY_ARGS = ["--device", "cpu", "-r", "3",
            "root.alexnet.loader.input_hw=67", "root.alexnet.width_mult=0.125",
            "root.alexnet.fc_width=64", "root.alexnet.n_classes=16",
            "root.alexnet.loader.n_train=8",
            "root.alexnet.loader.n_validation=4",
            "root.alexnet.loader.minibatch_size=4",
            "root.alexnet.decision.max_epochs=1"]
TOY = dict(width_mult=0.125, fc_width=64, n_classes=16, input_hw=67,
           n_train=8, n_validation=4)


@pytest.fixture(autouse=True)
def _isolated(monkeypatch, tmp_path):
    """A cache of the test's own, and the registries' selections and the
    ledger restored (process-wide state)."""
    monkeypatch.setenv("VELES_AUTOTUNE_CACHE", str(tmp_path / "at.json"))
    monkeypatch.delenv("VELES_SMEM_BUDGET", raising=False)
    # the port's log records reach caplog (the CLI's logging setup stops
    # them at "veles_torch" once a test in this process has run it)
    monkeypatch.setattr(logging.getLogger("veles_torch"), "propagate", True)
    snaps = variants.selection_table(), jvariants.selection_table()
    yield
    for reg, snap in zip((variants, jvariants), snaps):
        reg.clear_selection()
        for op, name in snap.items():
            reg.select(op, name)
    templates.clear_ledger()


def _toy_wf(batch=4):
    prng.seed_all(3)
    wf = alexnet.create_workflow(minibatch_size=batch, **TOY)
    wf.initialize("cpu")
    return wf


# ---------------------------------------------------------------------------
# 1. the cache
# ---------------------------------------------------------------------------


def test_cache_round_trip(tmp_path):
    path = str(tmp_path / "c.json")
    at.AutotuneCache(path).put("k1", {"variant": "kernel", "timings_s": {}})
    c2 = at.AutotuneCache(path)
    assert c2.get("k1")["variant"] == "kernel"
    c2.put("k2", {"variant": "tree"})
    raw = json.loads(open(path).read())
    assert raw["schema"] == "veles-autotune" and raw["version"] == 2
    assert set(raw["entries"]) == {"k1", "k2"}
    assert at.AutotuneCache(path).get("missing") is None


@pytest.mark.parametrize("content", [
    "{not json", json.dumps({"schema": "veles-autotune", "version": 1,
                             "entries": {"k": {"variant": "x"}}}),
    json.dumps({"schema": "other", "version": 2, "entries": {}}),
    json.dumps({"schema": "veles-autotune", "version": 2,
                "entries": ["k"]})])
def test_corrupt_or_skewed_cache_reads_empty_and_retunes(tmp_path, caplog,
                                                         content):
    path = tmp_path / "c.json"
    path.write_text(content)
    cache = at.AutotuneCache(str(path))
    with caplog.at_level(logging.WARNING, logger="veles_torch.autotune"):
        assert cache.get("k") is None
        assert cache.get("k") is None
    assert len([r for r in caplog.records
                if "unreadable" in r.getMessage()]) == 1
    cache.put("k", {"variant": "kernel"})
    assert at.AutotuneCache(str(path)).get("k")["variant"] == "kernel"


def test_a_jax_cache_at_the_same_path_is_kept(tmp_path):
    """The two packages share the schema: the port reads a JAX file
    without a crash, applies nothing of it (its keys name other devices),
    and keeps its entries when it writes."""
    path = str(tmp_path / "shared.json")
    jkey = jat.op_cache_key("cpu", "lrn", [{"sample_shape": [55, 55, 96]}])
    jat.AutotuneCache(path).put(jkey, {"variant": "banded_matmul"})
    wf = _toy_wf()
    assert at.apply_cached(wf, cache_path=path, device="cpu") == {}
    rep = at.search_op("sgd_update", budget=3,
                       cache=at.AutotuneCache(path), device="cpu")
    assert rep["source"] == "searched"
    assert jat.AutotuneCache(path).get(jkey)["variant"] == "banded_matmul"
    assert at.AutotuneCache(path).get(rep["key"])["variant"] \
        == rep["variant"]
    assert at.device_name("cpu") != "cpu"


def test_keys_leave_the_batch_out():
    small, large = _toy_wf(4), _toy_wf(8)
    assert at.discover_tunables(small) == at.discover_tunables(large)
    assert at.discover_fusions(small) == at.discover_fusions(large)
    found = at.discover_tunables(small)
    assert set(found) == {"conv_stem", "lrn", "maxpool"}
    assert [s["sample_shape"] for s in found["lrn"]] == [[15, 15, 12],
                                                        [7, 7, 32]]
    assert len(at.discover_fusions(small)["lrn_maxpool"]) == 2


def test_winners_tuned_at_one_batch_apply_at_another(tmp_path):
    cache = at.AutotuneCache(str(tmp_path / "b.json"))
    rep = at.autotune_workflow(_toy_wf(4), budget=8, cache=cache,
                               device="cpu", steps=1, repeats=1,
                               ops=["lrn", "maxpool"])
    variants.clear_selection()
    applied = at.apply_cached(_toy_wf(8), cache=at.AutotuneCache(
        cache.path), device="cpu")
    for op in ("lrn", "maxpool"):
        assert applied[op] == rep[op]["variant"]
        assert variants.effective(op) == rep[op]["variant"]


def test_apply_cached_refuses_a_winner_that_no_longer_fits(monkeypatch,
                                                           caplog):
    wf = _toy_wf()
    sigs = at.discover_fusions(wf)["lrn_maxpool"]
    key = at.op_cache_key(at.device_name("cpu"), "lrn_maxpool",
                          sigs + templates.space_signature("lrn_maxpool"))
    name = "fused[rb=4,cb=32,io=native,fuse=1]"
    at.AutotuneCache().put(key, {"variant": name})
    monkeypatch.setenv("VELES_SMEM_BUDGET", "1000")
    with caplog.at_level(logging.WARNING, logger="veles_torch.autotune"):
        applied = at.apply_cached(wf, device="cpu")
    assert "lrn_maxpool" not in applied
    assert variants.selected("lrn_maxpool") is None
    assert any("refusing lrn_maxpool winner" in r.getMessage()
               for r in caplog.records)
    monkeypatch.delenv("VELES_SMEM_BUDGET")
    assert at.apply_cached(wf, device="cpu")["lrn_maxpool"] == name


# ---------------------------------------------------------------------------
# 2. end to end on the CPU
# ---------------------------------------------------------------------------


def _timings():
    return sum(at.TIMINGS.values())


def test_cli_tunes_then_hits_the_cache_then_applies(capsys):
    """`--fused --autotune --autotune-budget 8`: tunes; again: no timing
    call and the same winners; plain `--fused`: the winners selected."""
    before = _timings()
    wf = launcher.train(["veles_tpu_torch/samples/alexnet.py", "--fused",
                         "--autotune", "--autotune-budget", "8",
                         *TOY_ARGS])
    first = wf.autotune_report
    assert _timings() > before
    searched = {op for op, r in first.items() if r["source"] == "searched"}
    assert {"conv_stem", "lrn"} <= searched
    for op in searched:
        assert first[op]["trials"] <= first[op]["budget"]
        assert all(templates.passed(op, t["variant"])
                   for t in first[op]["trace"] if t["outcome"] == "timed")
    out = capsys.readouterr().out
    assert all(f"AUTOTUNE {op}: " in out for op in first)
    winners = {op: r["variant"] for op, r in first.items()}

    variants.clear_selection()
    templates.clear_ledger()
    before = _timings()
    wf = launcher.train(["veles_tpu_torch/samples/alexnet.py", "--fused",
                         "--autotune", "--autotune-budget", "8",
                         *TOY_ARGS])
    assert _timings() == before
    again = wf.autotune_report
    assert {op: r["variant"] for op, r in again.items()} == winners
    assert all(again[op]["source"] == "cache" for op in searched)

    variants.clear_selection()
    wf = launcher.train(["veles_tpu_torch/samples/alexnet.py", "--fused",
                         *TOY_ARGS])
    assert _timings() == before
    for op in searched:
        assert wf.autotune_applied[op] == winners[op]
    # the run's winners were the run's: the process's selection is back
    assert variants.selection_table() == {}


def test_tool_prints_its_record_and_reruns_from_the_cache(tmp_path, capsys):
    from veles_tpu_torch.tools import autotune as tool
    path = str(tmp_path / "tool.json")
    args = ["--device", "cpu", "--budget", "6", "--cache", path,
            "--ops", "lrn,sgd_update", "--steps", "1", "--repeats", "1"]
    assert tool.main(args) == 0
    rec = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert set(rec["winners"]) == {"lrn", "sgd_update"}
    assert rec["device"] == "cpu (torch)" and rec["cache"] == path
    before = _timings()
    assert tool.main(args) == 0
    again = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert again["winners"] == rec["winners"]
    assert _timings() == before


# ---------------------------------------------------------------------------
# 3. a selected winner in the fused step, against the JAX step
# ---------------------------------------------------------------------------

STEM = "gen[pack=s2d,acc=native,epi=none]"
STEM_EPI = "gen[pack=s2d,acc=native,epi=lrn]"
#: selections by name: (JAX's, the port's); the JAX composed LRN is
#: its Pallas one-pass kernel, K2/K3's counterpart
SELECTIONS = {
    "fused": ({**JAX_SEL["fused"], "conv_stem": STEM, "maxpool": "slices"},
              {"lrn_maxpool": "fused[rb=3,cb=16,io=native,fuse=1]",
               "conv_stem": STEM, "maxpool": "slices",
               "sgd_update": "kernel"}),
    "composed": ({**JAX_SEL["composed"], "conv_stem": STEM,
                  "maxpool": "gen[algo=slices,fold=tree]"},
                 {"lrn_maxpool": "composed", "conv_stem": STEM,
                  "maxpool": "gen[algo=slices,fold=tree]",
                  "sgd_update": "cuda_rows[threads=512]"}),
    "stem epilogue": ({**JAX_SEL["fused"], "conv_stem": STEM_EPI},
                      {"lrn_maxpool": "fused", "conv_stem": STEM_EPI,
                       "sgd_update": "kernel"}),
}


@pytest.mark.parametrize("setting", list(SELECTIONS))
def test_selected_step_tracks_the_jax_step(setting):
    jsel, psel = SELECTIONS[setting]
    jwf, pwf = _workflows(0.0)
    with jvariants.pallas_interpret(), _Selected(jvariants, **jsel), \
            _Selected(variants, **psel):
        jstep = jwf.build_fused_step()
        pstep = pwf.build_fused_step()
        jpairs = [(i, j) for i, j, _ in jstep.fusion_pairs()]
        assert [(i, j) for i, j, _ in pstep.fusion_pairs()] == jpairs
        jstate = jstep.init_state()
        pstate = convert.state_from_jax(jstate, "cpu", pstep)
        x, y, w = _batch(130, pad=2)
        jstate, (jloss, jerr) = jstep.train(jstate, x, y, w)
        pstate, (ploss, perr) = pstep.train(pstate, x, y, w)
    np.testing.assert_allclose(float(ploss), float(jloss), rtol=LOSS_RTOL)
    assert int(perr) == int(jerr)
    _compare_states(jstate, pstate, f"{setting}: after one step")
    jwf._stop_units()


def test_variant_table_follows_the_jax_precedence():
    """The stem's epilogue and the LRN->pool point both want LRN 1: the
    stem takes it (pairs left to right), LRN 2 keeps its pool; the table
    names exactly what runs, as the JAX table does."""
    jwf, pwf = _workflows(0.0)
    jname = JAX_SEL["fused"]["lrn_maxpool"]
    pname = "fused[rb=2,cb=8,io=f32,fuse=1]"
    with jvariants.pallas_interpret(), \
            _Selected(jvariants, conv_stem=STEM_EPI, lrn_maxpool=jname), \
            _Selected(variants, conv_stem=STEM_EPI, lrn_maxpool=pname):
        jtable = jwf.build_fused_step().variant_table()
        pstep = pwf.build_fused_step()
        ptable = pstep.variant_table()
        assert [(i, j) for i, j, _ in pstep.fusion_pairs()] == [(0, 1),
                                                               (4, 5)]
    assert jtable["conv_stem"] == ptable["conv_stem"] == STEM_EPI
    assert jtable["lrn"] == ptable["lrn"] == f"conv_stem/{STEM_EPI}"
    assert (jtable["lrn_maxpool"], ptable["lrn_maxpool"]) == (jname, pname)
    # the pool after LRN 1 runs alone, as does the one after conv5
    assert ptable["maxpool"] == "reduce_window"
    assert jtable["maxpool"] == jvariants.effective("maxpool")
    assert set(ptable) == set(jtable) - {"dropout"}
    jwf._stop_units()


def test_unclaimed_stem_and_attention_report_their_unfused_twins():
    from veles_tpu_torch.znicz.attention import MultiHeadAttention
    wf = _toy_wf()
    conv = wf.forwards[0]
    variants.select("conv_stem", "gen[pack=s2d,acc=f32,epi=lrn]")
    assert conv.variant_effective() == "gen[pack=s2d,acc=f32,epi=none]"
    variants.select("conv_stem", "s2d")
    assert conv.variant_effective() == "s2d"
    unit = MultiHeadAttention(n_heads=2, use_flash="on")
    unit.initialize((4096, 16), torch.device("cpu"))
    variants.select("flash_attn", "cuda[blk_q=64,blk_k=64,kv_order=rev,"
                                  "drop=1]")
    assert unit.variant_effective() \
        == "cuda[blk_q=64,blk_k=64,kv_order=rev,drop=0]"
    assert unit.variant_signature((4096, 16)) == {
        "sample_shape": [4096, 16], "heads": 2, "head_dim": 8,
        "causal": True}


def test_default_run_launches_what_it_launched_before():
    """No --autotune and no cache hit: the defaults (K4/K5 pairs, K2/K3
    elsewhere, K1, the direct stem, the reduce_window pool) run."""
    wf = _toy_wf()
    assert at.apply_cached(wf, device="cpu") == {}
    table = wf.build_fused_step().variant_table()
    assert table == {"conv_stem": "direct", "maxpool": "reduce_window",
                     "lrn_maxpool": "fused", "lrn": "lrn_maxpool/fused",
                     "sgd_update": "kernel"}


# ---------------------------------------------------------------------------
# 4. the launcher's refusals
# ---------------------------------------------------------------------------

REFUSALS = (
    (["--fused", "--autotune-budget", "8"],
     dict(fused=True, autotune=False, autotune_budget=8)),
    (["--fused", "--autotune", "--autotune-budget", "0"],
     dict(fused=True, autotune=True, autotune_budget=0)),
    (["--serve", "0", "--autotune"], dict(autotune=True, serve=0)),
    (["--autotune"], dict(autotune=True)))


@pytest.mark.parametrize("argv,jkw", REFUSALS)
def test_launcher_refusals_match_the_jax_launcher(capsys, argv, jkw):
    with pytest.raises(SystemExit) as jerr:
        Launcher(**jkw)
    with pytest.raises(SystemExit) as perr:
        launcher.parse_args(["wf.py", *argv])
    assert perr.value.code == 2
    assert str(jerr.value).split(":")[0] in capsys.readouterr().err


@pytest.mark.parametrize("op", ["lrn", "maxpool"])
def test_member_ops_time_unclaimed(op):
    """While `lrn` or `maxpool` candidates time, the pair op stands down
    to its unfused incumbent (the port's default is the fused point,
    where the JAX default is composed: clearing the selection would keep
    both pairs claimed and every LRN candidate would time the same), and
    the selection comes back after."""
    wf = _toy_wf()
    for prev in (None, "fused[rb=2,cb=8,io=native,fuse=1]"):
        if prev is None:
            variants.clear_selection("lrn_maxpool")
        else:
            variants.select("lrn_maxpool", prev)
        with at._suspend_fusions(op):
            assert wf.build_fused_step().fusion_pairs() == []
            assert variants.effective("lrn_maxpool") == "composed"
        assert variants.selected("lrn_maxpool") == prev
    with at._suspend_fusions("conv_stem"):
        assert variants.selected("lrn_maxpool") == prev
