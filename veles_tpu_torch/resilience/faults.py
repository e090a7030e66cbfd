"""Deterministic fault injection: make every recovery path testable.

The port's copy of `veles_tpu/resilience/faults.py`, single-host
actions only.

A fault plan comes from the ``VELES_FAULT_PLAN`` environment variable
(or is installed programmatically via :func:`install_plan` in tests).
Two equivalent grammars:

compact   ``kill@epoch=2``, ``hang@epoch=3``, ``nan@step=10``,
          ``corrupt_snapshot@write=2`` (bare ``corrupt_snapshot`` means
          ``write=1``) — several entries joined with ``;``
JSON      ``[{"action": "kill", "epoch": 2}, {"action": "nan",
          "step": 10}]`` (text starting with ``[``)

Actions:

- ``kill``  — at the end of epoch K the process SIGKILLs itself (a hard
  preemption: no atexit, no flushes — exactly what a preempted machine
  looks like to the supervisor).
- ``hang``  — at the end of epoch K the process stops making progress
  (and stops heartbeating) forever: the supervisor's stall detector is
  the only way out.
- ``nan``   — the fused training loop replaces the K-th train step's
  loss with NaN (a numeric divergence for the non-finite guard).
- ``corrupt_snapshot`` — the K-th snapshot file this process writes is
  torn post-write (garbage bytes mid-file), simulating a half-written
  checkpoint that the sha256 sidecar must catch.
- ``mirror_corrupt`` — the K-th successful mirror push
  (``mirror_corrupt@push=K``) is followed by tearing the MIRRORED copy
  (the local one stays intact): a restore or a serving watcher must
  refuse it.

The cluster-scale actions of the JAX package (``host_loss``,
``partition``, ``stale_local_dir``, ``coord_loss``) come with the port's
cluster.

Each entry fires AT MOST ONCE. When ``VELES_FAULT_STATE`` names a file
(the Supervisor sets it), fired entries are recorded there BEFORE the
fault executes, so a restarted process — whose restored epoch counter
may re-cross the trigger epoch — does not re-fire the same fault and
trap the job in a kill loop. Without a state file the fired set is
in-process only.

Zero-cost when disabled: `active_plan()` is a cached None and every
call site guards on it; no plan means no per-step or per-epoch work.
"""

from __future__ import annotations

import json
import logging
import os
import signal
import time
from typing import Any, List, Optional

_log = logging.getLogger("veles_torch.FaultPlan")

_ACTIONS = {"kill": "epoch", "hang": "epoch", "nan": "step",
            "corrupt_snapshot": "write", "mirror_corrupt": "push"}

#: sentinel distinguishing "not looked up yet" from "looked up: no plan"
_UNSET = object()
_ACTIVE: Any = _UNSET


class FaultEntry:
    """One parsed plan entry: an action and the counter value it keys on."""

    def __init__(self, action: str, at: int) -> None:
        if action not in _ACTIONS:
            raise ValueError(
                f"unknown fault action {action!r}; one of {sorted(_ACTIONS)}")
        if at < 1:
            raise ValueError(f"fault trigger must be >= 1 (got {at})")
        self.action = action
        self.at = int(at)

    @property
    def key(self) -> str:
        return f"{self.action}@{_ACTIONS[self.action]}={self.at}"

    def __repr__(self) -> str:
        return f"<FaultEntry {self.key}>"


class FaultPlan:
    """A set of fault entries plus the fired-entry persistence."""

    def __init__(self, entries: List[FaultEntry],
                 state_path: str = "") -> None:
        self.entries = list(entries)
        self.state_path = state_path or os.environ.get(
            "VELES_FAULT_STATE", "")
        self._fired = set(self._load_state())
        self._train_steps = 0      # counted by the fused loop
        self._snapshot_writes = 0  # counted by the snapshotter hook
        self._mirror_pushes = 0    # counted by Mirror.push

    # -- parsing -------------------------------------------------------------

    @classmethod
    def parse(cls, text: str, state_path: str = "") -> "FaultPlan":
        text = text.strip()
        if not text:
            raise ValueError("empty fault plan")
        if text.startswith("["):
            raw = json.loads(text)
            entries = []
            for item in raw:
                action = item["action"]
                counter = _ACTIONS.get(action)
                if counter is None:
                    raise ValueError(f"unknown fault action {action!r}")
                entries.append(FaultEntry(action, int(item.get(counter, 1))))
            return cls(entries, state_path)
        entries = []
        for part in text.split(";"):
            part = part.strip()
            if not part:
                continue
            action, _, cond = part.partition("@")
            if not cond:
                entries.append(FaultEntry(action, 1))
                continue
            counter, _, value = cond.partition("=")
            expected = _ACTIONS.get(action)
            if expected is None:
                raise ValueError(f"unknown fault action {action!r}")
            if counter != expected:
                raise ValueError(
                    f"{action!r} keys on {expected!r}, not {counter!r} "
                    f"(in {part!r})")
            if not value.isdigit():
                raise ValueError(f"bad fault trigger in {part!r}")
            entries.append(FaultEntry(action, int(value)))
        if not entries:
            raise ValueError(f"no entries in fault plan {text!r}")
        return cls(entries, state_path)

    # -- fired-state persistence ---------------------------------------------

    def _load_state(self) -> List[str]:
        if not self.state_path or not os.path.exists(self.state_path):
            return []
        try:
            with open(self.state_path) as f:
                return list(json.load(f))
        except (OSError, ValueError):
            return []

    def _mark_fired(self, entry: FaultEntry) -> None:
        """Record BEFORE executing: kill/hang never get a second chance
        to write, and a re-fired kill would loop the supervisor."""
        self._fired.add(entry.key)
        if self.state_path and (not os.path.exists(self.state_path)
                                or os.path.isfile(self.state_path)):
            # the isfile guard keeps os.replace from clobbering a
            # non-regular target (e.g. a device node used to discard
            # state on purpose — then persistence is simply off)
            tmp = self.state_path + ".tmp"
            with open(tmp, "w") as f:
                json.dump(sorted(self._fired), f)
            os.replace(tmp, self.state_path)

    def _take(self, action: str, value: int) -> Optional[FaultEntry]:
        """The matching un-fired entry for (action, counter value)."""
        for e in self.entries:
            if e.action == action and e.at == value \
                    and e.key not in self._fired:
                return e
        return None

    # -- injection points -----------------------------------------------------

    def on_epoch(self, epoch: int) -> None:
        """Epoch-boundary hook (registered on the hooks registry by the
        launcher): executes kill/hang entries keyed on this epoch."""
        e = self._take("kill", epoch)
        if e is not None:
            self._mark_fired(e)
            _log.warning("FAULT INJECTION: %s -> SIGKILL self", e.key)
            logging.shutdown()
            os.kill(os.getpid(), signal.SIGKILL)
        e = self._take("hang", epoch)
        if e is not None:
            self._mark_fired(e)
            _log.warning("FAULT INJECTION: %s -> hanging forever", e.key)
            # a real OS sleep, so the supervisor's stall detector has
            # something true to detect
            while True:                      # pragma: no cover — killed
                time.sleep(3600)

    def nan_at_step(self, step: Optional[int] = None) -> bool:
        """True when the current (or given) train step's loss should be
        replaced with NaN. Counts steps internally when `step` is None."""
        if step is None:
            self._train_steps += 1
            step = self._train_steps
        e = self._take("nan", step)
        if e is None:
            return False
        self._mark_fired(e)
        _log.warning("FAULT INJECTION: %s -> loss := NaN", e.key)
        return True

    def maybe_corrupt_snapshot(self, path: str) -> bool:
        """Called by the Snapshotter after each successful export; tears
        the file when a corrupt_snapshot entry keys on this write."""
        self._snapshot_writes += 1
        e = self._take("corrupt_snapshot", self._snapshot_writes)
        if e is None:
            return False
        self._mark_fired(e)
        corrupt_file(path)
        _log.warning("FAULT INJECTION: %s -> tore %s", e.key, path)
        return True

    def mirror_corrupt_at_push(self) -> bool:
        """True when the current mirror push (counted here) is to be
        followed by tearing the mirrored copy. Called by Mirror.push
        after a verified upload."""
        self._mirror_pushes += 1
        e = self._take("mirror_corrupt", self._mirror_pushes)
        if e is None:
            return False
        self._mark_fired(e)
        _log.warning("FAULT INJECTION: %s", e.key)
        return True

    def __repr__(self) -> str:
        return f"<FaultPlan {[e.key for e in self.entries]}>"


def corrupt_file(path: str) -> None:
    """Overwrite a span in the middle of `path` with garbage — size
    kept, checksum broken: the bit-rot/torn-write mode that only an
    integrity check catches (a truncation would also be caught by
    streaming the compression codec, which is a weaker test)."""
    size = os.path.getsize(path)
    with open(path, "r+b") as f:
        f.seek(max(0, size // 2 - 8))
        f.write(b"\xde\xad\xbe\xef" * 8)


def active_plan() -> Optional[FaultPlan]:
    """The process's fault plan, parsed once from VELES_FAULT_PLAN (None
    when unset — the common, zero-cost case)."""
    global _ACTIVE
    if _ACTIVE is _UNSET:
        text = os.environ.get("VELES_FAULT_PLAN", "")
        _ACTIVE = FaultPlan.parse(text) if text else None
    return _ACTIVE


def install_plan(plan: Optional[FaultPlan]) -> None:
    """Set (or clear, with None) the active plan programmatically —
    in-process tests use this instead of the environment variable."""
    global _ACTIVE
    _ACTIVE = plan


def reset() -> None:
    """Forget the cached plan so the next active_plan() re-reads the
    environment (test isolation)."""
    global _ACTIVE
    _ACTIVE = _UNSET
