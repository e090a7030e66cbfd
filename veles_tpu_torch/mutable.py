"""Linkable mutable values used for workflow control flow.

The port's copy of `veles_tpu/mutable.py` (parity: reference
`veles/mutable.py`, `Bool`): a shared, composable boolean used for unit
gates (`gate_block`, `gate_skip`). Units link to the same Bool object, so
a Decision flipping its `complete` flag is visible at once to every gate
composed from it; `&`, `|` and `~` build derived Bools that evaluate
their operands on every `bool()`.

Two additions the port needs: `Bool == x` compares truth values (the
loader's and the Decision's flags are Bools here, and their readers
compare them with plain bools), and `BoolField`, a class attribute that
keeps one live Bool per instance and turns a plain assignment into a
`set`, so a loop that writes `loader.last_minibatch = False` keeps the
gates composed from that flag live.
"""

from __future__ import annotations

from typing import Callable, List, Optional


class Bool:
    """A mutable, shareable, composable boolean.

    - `b <<= True` (or `b.set(True)`) assigns; callbacks registered with
      `on_change` fire when the effective value flips.
    - `a & b`, `a | b`, `~a` return *derived* Bools that re-evaluate their
      operands on every `bool()` — so gates stay live views.
    """

    __slots__ = ("_value", "_expr", "_callbacks", "name")

    def __init__(self, value: bool = False, name: str = "",
                 _expr: Optional[Callable[[], bool]] = None) -> None:
        self._value = bool(value)
        self._expr = _expr
        self._callbacks: List[Callable[[bool], None]] = []
        self.name = name

    # -- evaluation ----------------------------------------------------------

    def __bool__(self) -> bool:
        if self._expr is not None:
            return self._expr()
        return self._value

    def __eq__(self, other) -> bool:
        return bool(self) == bool(other)

    # identity, as before __eq__ was defined: gates may key dicts
    __hash__ = object.__hash__

    # -- assignment ----------------------------------------------------------

    def set(self, value) -> "Bool":
        if self._expr is not None:
            raise ValueError(f"Bool {self.name!r} is derived; cannot assign")
        old = self._value
        self._value = bool(value)
        if old != self._value:
            for cb in self._callbacks:
                cb(self._value)
        return self

    def __ilshift__(self, value) -> "Bool":  # b <<= True
        return self.set(value)

    def on_change(self, callback: Callable[[bool], None]) -> None:
        self._callbacks.append(callback)

    # -- composition ---------------------------------------------------------

    def __and__(self, other) -> "Bool":
        return Bool(_expr=lambda: bool(self) and bool(other),
                    name=f"({self.name} & {_name(other)})")

    def __or__(self, other) -> "Bool":
        return Bool(_expr=lambda: bool(self) or bool(other),
                    name=f"({self.name} | {_name(other)})")

    def __invert__(self) -> "Bool":
        return Bool(_expr=lambda: not bool(self), name=f"~{self.name}")

    def __repr__(self) -> str:
        kind = "derived" if self._expr is not None else "plain"
        return f"Bool({bool(self)}, {kind}{', ' + self.name if self.name else ''})"

    # Derived Bools close over other objects; snapshots only need the value.
    def __getstate__(self):
        return {"_value": bool(self), "name": self.name}

    def __setstate__(self, state):
        self._value = state["_value"]
        self._expr = None
        self._callbacks = []
        self.name = state.get("name", "")


def _name(x) -> str:
    return getattr(x, "name", "") or repr(bool(x))


class BoolField:
    """A class attribute holding one live `Bool` per instance, under
    `_<name>` in the instance's `__dict__`. Reading gives the Bool; an
    assignment of the Bool itself (what `x.flag <<= v` does) keeps it, and
    any other value is `set` into it, so gates composed from the flag
    stay live whatever the writer assigns. An instance pickled before the
    flag was a Bool (a plain value under `name`) gets one on first read."""

    def __set_name__(self, owner, name: str) -> None:
        self.name = name
        self.slot = f"_{name}"

    def _bool(self, obj) -> Bool:
        d = obj.__dict__
        b = d.get(self.slot)
        if b is None:
            b = d[self.slot] = Bool(d.pop(self.name, False),
                                    name=f"{getattr(obj, 'name', '')}."
                                         f"{self.name}")
        return b

    def __get__(self, obj, owner=None):
        if obj is None:
            return self
        return self._bool(obj)

    def __set__(self, obj, value) -> None:
        b = self._bool(obj)
        if value is not b:
            b.set(bool(value))
