"""Unit base classes: the nodes of a workflow graph.

The port's copy of `veles_tpu/units.py` (parity: reference
`veles/units.py`: `Unit`, `IUnit`, `TrivialUnit`, `Container`) — a Unit
has *control links* (`b.link_from(a)`: b receives a pulse when a
finishes; the pulse is dropped while `gate_block` holds and
forwarded-without-running while `gate_skip` holds) and *data links*
(`b.link_attrs(a, "x", ("own", "remote"))`: live attribute aliasing,
reads and writes pass through to the source unit).

Pulse semantics: a unit fires when ALL of its control in-links have pulsed
since its last firing (AND-gate). `Repeater` (see workflow.py) is an OR-gate
merge point used to close training loops, exactly like the reference's
repeater unit in znicz workflows.
"""

from __future__ import annotations

import time
from typing import Any, Dict, Optional, Tuple, Union

from veles_tpu_torch.logger import Logger
from veles_tpu_torch.mutable import Bool


class LinkError(AttributeError):
    """A `link_attrs` alias whose target attribute does not exist on the
    source unit AT LINK TIME. Subclasses AttributeError so existing
    handlers keep working — but it fires at the wiring site, naming both
    units, instead of as a bare AttributeError at first read inside
    run()."""


class Unit(Logger):
    """Base of everything that lives inside a Workflow."""

    #: OR-gate: fire on any single incoming pulse (Repeater semantics).
    or_gate = False

    def __init__(self, workflow: Optional["Unit"] = None,
                 name: Optional[str] = None, **kwargs: Any) -> None:
        d = object.__getattribute__(self, "__dict__")
        d["_links_from"] = {}   # src Unit -> pulsed flag (bool)
        d["_links_to"] = {}     # dst Unit -> True
        d["_linked_attrs"] = {}  # own attr name -> (src object, src attr name)
        d["_late_attrs"] = set()  # own names linked with late=True
        self.name = name or type(self).__name__
        self.gate_block = Bool(False, name=f"{self.name}.gate_block")
        self.gate_skip = Bool(False, name=f"{self.name}.gate_skip")
        self.workflow = workflow
        self._initialized = False
        self.run_count = 0
        self.run_time = 0.0
        if workflow is not None:
            workflow.add_unit(self)

    # -- data links (attribute aliasing) ------------------------------------

    def link_attrs(self, other: "Unit",
                   *names: Union[str, Tuple[str, str]],
                   late: bool = False) -> None:
        """Alias attributes from `other`: `"x"` links self.x -> other.x;
        `("own", "remote")` links self.own -> other.remote.

        Validates EAGERLY: a remote attribute that does not exist at
        link time raises `LinkError` naming both units here, at the
        wiring site, instead of a bare AttributeError at first read
        inside run(). Pass `late=True` for intentionally late-bound
        attributes (created by the source's initialize())."""
        for entry in names:
            own, remote = (entry, entry) if isinstance(entry, str) else entry
            if not late:
                try:
                    exists = hasattr(other, remote)
                except Exception:   # noqa: BLE001 — alias chains may cycle
                    exists = False
                if not exists:
                    raise LinkError(
                        f"cannot link {self!r}.{own} -> {other!r}."
                        f"{remote}: {type(other).__name__} has no "
                        f"attribute {remote!r} at link time (pass "
                        "late=True for intentionally late-bound "
                        "attributes)")
            self.__dict__.pop(own, None)  # linked name must not shadow
            self._linked_attrs[own] = (other, remote)
            if late:
                # remembered so the graph verifier downgrades a
                # not-yet-materialized late alias to a warning
                # (setdefault: units unpickled from pre-late snapshots)
                self.__dict__.setdefault("_late_attrs", set()).add(own)

    def unlink_attrs(self, *names: str) -> None:
        for n in names:
            self._linked_attrs.pop(n, None)
            self.__dict__.get("_late_attrs", set()).discard(n)

    def __getattr__(self, name: str) -> Any:
        # Called only when normal lookup fails: resolve data links.
        if name.startswith("_"):
            raise AttributeError(name)
        links = self.__dict__.get("_linked_attrs")
        if links and name in links:
            src, remote = links[name]
            return getattr(src, remote)
        raise AttributeError(f"{type(self).__name__}.{name}")

    def __setattr__(self, name: str, value: Any) -> None:
        links = self.__dict__.get("_linked_attrs")
        if links and name in links:
            src, remote = links[name]
            setattr(src, remote, value)
        else:
            # object.__setattr__ writes the instance dict as the JAX unit
            # does, and also honors data descriptors (mutable.BoolField)
            object.__setattr__(self, name, value)

    # -- control links -------------------------------------------------------

    def link_from(self, *sources: "Unit") -> "Unit":
        for src in sources:
            self._links_from[src] = False
            src._links_to[self] = True
        return self

    def unlink_from(self, *sources: "Unit") -> None:
        for src in sources:
            self._links_from.pop(src, None)
            src._links_to.pop(self, None)

    def unlink_all(self) -> None:
        for src in list(self._links_from):
            self.unlink_from(src)
        for dst in list(self._links_to):
            dst.unlink_from(self)

    def open_gate(self, src: "Unit") -> bool:
        """Register a pulse from `src`; True when the unit should fire."""
        if src in self._links_from:
            self._links_from[src] = True
        if self.or_gate:
            for s in self._links_from:
                self._links_from[s] = False
            return True
        if not all(self._links_from.values()):
            return False
        for s in self._links_from:
            self._links_from[s] = False
        return True

    # -- lifecycle -----------------------------------------------------------

    def initialize(self, **kwargs: Any) -> Optional[bool]:
        """Allocate/prepare. Return False to request a retry after the rest
        of the workflow initialized (for units whose data links are not yet
        populated)."""
        self._initialized = True
        return None

    def run(self) -> None:
        """The unit's work for one firing. Override."""

    def stop(self) -> None:
        """Called on workflow stop for cleanup. Override as needed."""

    def fire(self) -> None:
        """Run (honoring gates) and propagate the pulse. Called by the
        workflow scheduler."""
        if bool(self.gate_block):
            return
        if not bool(self.gate_skip):
            t0 = time.perf_counter()
            self.run()
            self.run_time += time.perf_counter() - t0
            self.run_count += 1
        wf = self.workflow
        for dst in self._links_to:
            if dst.open_gate(self) and wf is not None:
                wf.schedule(dst)

    @property
    def is_initialized(self) -> bool:
        return self._initialized

    # -- pickling (whole-workflow snapshots, parity: reference Snapshotter
    # pickled the entire unit graph; SURVEY.md §5.4) ------------------------

    def __getstate__(self):
        """Drop transient state: attributes prefixed `_fn` hold built
        callables (rebuilt by initialize()); `_initialized` is reset so a
        restored workflow re-initializes (re-acquires its device).
        `_logger` is recreated lazily (Logger mixin); dropping it also
        keeps a unit's pickled bytes identical whether or not it has
        logged yet."""
        d = {k: v for k, v in self.__dict__.items()
             if not k.startswith("_fn") and k != "_logger"}
        d["_initialized"] = False
        return d

    def __setstate__(self, state):
        self.__dict__.update(state)

    def __repr__(self) -> str:
        return f"<{type(self).__name__} {self.name!r}>"


class TrivialUnit(Unit):
    """A unit that does nothing when run (pure graph plumbing)."""


class Container(Unit):
    """A unit that owns child units (Workflow derives from this)."""

    def __init__(self, workflow: Optional[Unit] = None, **kwargs: Any) -> None:
        object.__getattribute__(self, "__dict__")["units"] = []
        super().__init__(workflow, **kwargs)

    def add_unit(self, unit: Unit) -> None:
        self.units.append(unit)

    def remove_unit(self, unit: Unit) -> None:
        self.units.remove(unit)

    def __iter__(self):
        return iter(self.units)

    def index_of(self, unit: Unit) -> int:
        return self.units.index(unit)
