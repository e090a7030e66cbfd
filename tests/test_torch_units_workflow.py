"""The port's Unit/Workflow graph against the JAX package's: each case
builds the same graph in both packages (veles_tpu_torch.units /
workflow / mutable against veles_tpu's) and compares what it observes —
firing order, gates, attribute aliasing, the initialize-retry order, the
timing table and the pickle round trip — exactly, and against the value
the JAX package's own test (tests/test_units_workflow.py) expects."""

import pickle
from types import SimpleNamespace

import pytest

import veles_tpu.mutable as jmutable
import veles_tpu.units as junits
import veles_tpu.workflow as jworkflow
import veles_tpu_torch.mutable as pmutable
import veles_tpu_torch.units as punits
import veles_tpu_torch.workflow as pworkflow


class JaxRecorder(junits.Unit):
    """Appends its name to the workflow-level trace each firing."""

    def run(self):
        self.workflow.trace.append(self.name)


class PortRecorder(punits.Unit):
    """The port's twin of JaxRecorder."""

    def run(self):
        self.workflow.trace.append(self.name)


class Flags(punits.Unit):
    done = pmutable.BoolField()


PACKAGES = {
    "jax": SimpleNamespace(units=junits, workflow=jworkflow,
                           Bool=jmutable.Bool, Recorder=JaxRecorder),
    "port": SimpleNamespace(units=punits, workflow=pworkflow,
                            Bool=pmutable.Bool, Recorder=PortRecorder),
}


def _recorder(pkg):
    return pkg.Recorder


def _wf(pkg):
    wf = pkg.workflow.Workflow(name="wf")
    wf.trace = []
    return wf


def linear_chain(pkg):
    wf, Rec = _wf(pkg), _recorder(pkg)
    a, b = Rec(wf, name="a"), Rec(wf, name="b")
    a.link_from(wf.start_point)
    b.link_from(a)
    wf.end_point.link_from(b)
    wf.initialize()
    wf.run()
    return wf.trace


def and_gate(pkg):
    wf, Rec = _wf(pkg), _recorder(pkg)
    a, b, j = Rec(wf, name="a"), Rec(wf, name="b"), Rec(wf, name="join")
    a.link_from(wf.start_point)
    b.link_from(wf.start_point)
    j.link_from(a, b)
    wf.end_point.link_from(j)
    wf.initialize()
    wf.run()
    return wf.trace


def block_and_skip(pkg):
    wf, Rec = _wf(pkg), _recorder(pkg)
    a, b, c = Rec(wf, name="a"), Rec(wf, name="b"), Rec(wf, name="c")
    a.link_from(wf.start_point)
    b.link_from(a)
    c.link_from(b)
    wf.end_point.link_from(c)
    b.gate_skip <<= True
    wf.initialize()
    wf.run()
    wf2, Rec2 = _wf(pkg), _recorder(pkg)
    a2, b2 = Rec2(wf2, name="a"), Rec2(wf2, name="b")
    a2.link_from(wf2.start_point)
    b2.link_from(a2)
    wf2.end_point.link_from(b2)
    b2.gate_block <<= True
    wf2.initialize()
    wf2.run()
    return (wf.trace, wf2.trace, wf.end_point.run_count,
            wf2.end_point.run_count)


def repeater_loop(pkg):
    wf, Rec = _wf(pkg), _recorder(pkg)
    rep = pkg.workflow.Repeater(wf)
    work = Rec(wf, name="work")

    class Decision(pkg.units.Unit):
        def __init__(self, *a, **kw):
            super().__init__(*a, **kw)
            self.complete = pkg.Bool(False)
            self.iterations = 0

        def run(self):
            self.iterations += 1
            if self.iterations >= 5:
                self.complete <<= True

    dec = Decision(wf, name="decision")
    rep.link_from(wf.start_point)
    work.link_from(rep)
    dec.link_from(work)
    rep.link_from(dec)               # loop back (repeater = OR gate)
    rep.gate_block = dec.complete    # stop looping when complete
    wf.end_point.link_from(dec)
    wf.end_point.gate_block = ~dec.complete
    wf.initialize()
    wf.run()
    return (wf.trace, dec.iterations, rep.run_count,
            bool(wf.end_point.gate_block), wf.end_point.run_count)


def live_aliasing(pkg):
    wf = _wf(pkg)
    src = pkg.units.TrivialUnit(wf, name="src")
    dst = pkg.units.TrivialUnit(wf, name="dst")
    src.output = 41
    dst.link_attrs(src, ("input", "output"))
    seen = [dst.input]
    src.output = 42
    seen.append(dst.input)
    dst.input = 7          # writes through
    seen.append(src.output)
    with pytest.raises(pkg.units.LinkError):
        dst.link_attrs(src, ("x", "missing"))
    dst.link_attrs(src, ("y", "late_attr"), late=True)
    src.late_attr = 3
    seen.append(dst.y)
    return seen


def retry_order(pkg):
    wf = _wf(pkg)
    order = []

    class Dependent(pkg.units.Unit):
        def __init__(self, *a, **kw):
            super().__init__(*a, **kw)
            self.tries = 0

        def initialize(self, **kw):
            self.tries += 1
            order.append(("dep", self.tries))
            if not getattr(self.workflow, "provider_ready", False):
                return False
            return super().initialize(**kw)

    class Provider(pkg.units.Unit):
        def initialize(self, **kw):
            order.append(("prov", 1))
            self.workflow.provider_ready = True
            return super().initialize(**kw)

    d = Dependent(wf, name="dep")   # added before provider on purpose
    Provider(wf, name="prov")
    wf.initialize()
    return d.tries, d.is_initialized, order


def timing_stats(pkg):
    wf, Rec = _wf(pkg), _recorder(pkg)
    a = Rec(wf, name="a")
    a.link_from(wf.start_point)
    wf.end_point.link_from(a)
    wf.initialize()
    wf.run()
    table = wf.print_stats()
    return ("a" in table, "TOTAL" in table, a.run_count,
            a.run_time >= 0, table.splitlines()[0])


def pickle_round_trip(pkg):
    wf, Rec = _wf(pkg), _recorder(pkg)
    a = Rec(wf, name="a")
    a.link_from(wf.start_point)
    wf.end_point.link_from(a)
    # a derived gate (True: `a` is skipped) freezes to its value
    a.gate_skip = ~wf.end_point.gate_block
    a._fn_cache = object()                    # `_fn*` is dropped
    wf.initialize()
    wf.run()
    wf2 = pickle.loads(pickle.dumps(wf))
    a2 = wf2.units[2]
    return ([u.name for u in wf2.units], a2.is_initialized,
            bool(a2.gate_skip), a2.gate_skip._expr is None,
            hasattr(a2, "_fn_cache"), wf2.trace, a2.run_count)


#: case -> what the JAX package's test expects of it
CASES = {
    "linear_chain": (linear_chain, ["a", "b"]),
    "and_gate": (and_gate, ["a", "b", "join"]),
    "block_and_skip": (block_and_skip, (["a", "c"], ["a"], 1, 0)),
    "repeater_loop": (repeater_loop, (["work"] * 5, 5, 5, False, 1)),
    "live_aliasing": (live_aliasing, [41, 42, 7, 3]),
    "retry_order": (retry_order,
                    (2, True, [("dep", 1), ("prov", 1), ("dep", 2)])),
    "timing_stats": (timing_stats,
                     (True, True, 1, True,
                      f"{'unit':<32} {'runs':>8} {'time':>10} {'%':>6}")),
    "pickle_round_trip": (pickle_round_trip,
                          (["StartPoint", "EndPoint", "a"], False, True,
                           True, False, [], 0)),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_graph_case_matches_the_jax_package(case):
    fn, want = CASES[case]
    got = {name: fn(pkg) for name, pkg in PACKAGES.items()}
    assert got["jax"] == want, got["jax"]
    assert got["port"] == got["jax"], got


def test_bool_field_keeps_gates_live_through_plain_assignments():
    f = Flags(name="f")
    f.done = False
    gate = ~f.done
    b = f.done
    f.done = True            # a plain assignment sets the same Bool
    assert f.done is b and bool(f.done) and not bool(gate)
    f.done <<= False
    assert f.done is b and bool(gate)
    assert f.done == False and f.done != True   # noqa: E712
    g = pickle.loads(pickle.dumps(f))
    assert isinstance(g.done, pmutable.Bool) and not g.done
