"""WeightWatcher: the train-to-serve hot-swap loop.

The port's copy of `veles_tpu/serving_watch.py`. The trainer's
Snapshotter pushes digest-addressed snapshots to a mirror
(resilience/mirror.py, `--mirror`); this watcher closes the loop on the
serving side: poll the mirror for a snapshot newer than the live
generation, fetch and sha256-verify it, import the workflow WITHOUT
touching the process's PRNG registry (`import_(restore_prng=False)`),
and hand it to ``InferenceServer.swap_params``, which checks it and
commits it between ring rounds. No restart, no drain.

Any failure at any stage keeps the current generation serving:

- mirror unreachable or empty: nothing to do this poll; a streak of
  failed polls stretches the next one by `backoff_delay` (and
  ``HttpMirror`` retries transients within a budget below the poll
  interval);
- fetch failed (a torn or corrupt copy, a digest mismatch): counted as
  ``fetch_failed`` and retried on a later poll — the trainer may still
  be pushing;
- verify, import, geometry, wire, equivalence and non-finite failures
  depend only on the snapshot's (verified) bytes: counted once, and the
  digest is remembered so that the watcher never loops on a poisoned
  snapshot; a new digest clears the path.

A digest the operator rolled back from is skipped until a newer one is
pushed. The watcher never raises out of its thread and owns no serving
state: stopping it leaves the server as it was.
"""

from __future__ import annotations

import os
import tempfile
import threading
from typing import Any, Dict, Optional, Set

from veles_tpu_torch.logger import Logger
from veles_tpu_torch.resilience.backoff import backoff_delay

__all__ = ["WeightWatcher", "DETERMINISTIC_REFUSALS"]

#: refusal reasons that are a pure function of the snapshot CONTENT
#: (verified bytes): re-trying the same digest can never succeed, so
#: the watcher remembers it instead of re-refusing every poll
DETERMINISTIC_REFUSALS = frozenset({
    "verify_failed", "import_failed", "geometry", "wire_transform",
    "equivalence", "nonfinite"})


class WeightWatcher(Logger):
    """Poll `mirror` for new digest-addressed snapshots and hot-swap
    them into `server`. ``start()`` spawns the daemon poll thread;
    ``poll_once()`` is one poll, synchronous (what the tests drive)."""

    def __init__(self, server, mirror, prefix: str = "",
                 poll_s: float = 10.0, backoff_cap: float = 120.0,
                 tmp_dir: Optional[str] = None) -> None:
        self._server = server
        self._mirror = mirror
        self._prefix = prefix
        self.poll_s = float(poll_s)
        self.backoff_cap = float(backoff_cap)
        self._tmp_dir = tmp_dir or tempfile.mkdtemp(
            prefix="veles_watch_")
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None
        self._lock = threading.Lock()
        # bookkeeping (guarded by _lock; status() snapshots it)
        self.n_polls = 0
        self.n_applied = 0
        self.n_refused = 0
        self._streak = 0            # consecutive failed polls
        self._last_error: Optional[str] = None
        self._refused_digests: Set[str] = set()

    # -- lifecycle ------------------------------------------------------------

    def start(self) -> "WeightWatcher":
        if self._thread is not None and self._thread.is_alive():
            return self
        self._stop.clear()
        self._thread = threading.Thread(target=self._loop, daemon=True,
                                        name="weight-watcher")
        self._thread.start()
        self.info("weight watcher polling %s every %.1fs (prefix %r)",
                  getattr(self._mirror, "spec", "<mirror>"),
                  self.poll_s, self._prefix)
        return self

    def stop(self) -> None:
        self._stop.set()
        t = self._thread
        if t is not None:
            t.join(timeout=5)
        self._thread = None

    def _loop(self) -> None:
        # first poll promptly (a replica that starts after the trainer
        # pushed should converge now, not one interval later), then on
        # the configured cadence — stretched by the shared backoff
        # policy while polls fail, so a down mirror costs a bounded,
        # decorrelated retry pattern instead of a tight error loop
        delay = min(self.poll_s, 0.05)
        while not self._stop.wait(delay):
            try:
                self.poll_once()
            except Exception as e:  # noqa: BLE001 — the watcher
                # thread must never die; serving does not depend on it
                self._note_error(f"poll crashed: {e}")
            with self._lock:
                if self._streak > 0:
                    delay = backoff_delay(self._streak - 1,
                                          base=self.poll_s,
                                          cap=self.backoff_cap)
                else:
                    delay = self.poll_s

    # -- the poll unit --------------------------------------------------------

    def poll_once(self) -> Optional[Dict[str, Any]]:
        """One poll: returns the applied generation dict, or None
        (nothing new / refused / mirror trouble — all non-fatal)."""
        with self._lock:
            self.n_polls += 1
        try:
            entries = [e for e in self._mirror.entries()
                       if str(e.get("name", "")).startswith(
                           self._prefix)]
        except Exception as e:  # noqa: BLE001 — DirMirror can raise
            # on a vanished directory; treat exactly like unreachable
            self._note_error(f"mirror listing failed: {e}")
            return None
        if not entries:
            # empty AND unreachable look alike through entries() (the
            # HttpMirror already burned its bounded internal retries on
            # a transient): nothing actionable, keep the NORMAL cadence
            # — an empty mirror is what a fresh deploy looks like, and
            # the first real push deserves a prompt pickup
            self._clear_streak()
            return None
        # newest-first scan for the first actionable candidate: stop at
        # the live digest (everything older is history), skip digests
        # refused deterministically (poisoned content never changes)
        # and digests the operator ROLLED BACK from (a rollback pins
        # serving until a NEW digest is pushed — re-applying the
        # generation that was just rolled back would defeat it)
        entries.sort(key=lambda e: (float(e.get("mtime", 0.0)),
                                    str(e.get("name", ""))),
                     reverse=True)
        live = self._server.generation()["digest"]
        pinned = getattr(self._server, "rolled_back", set())
        with self._lock:
            known_bad = set(self._refused_digests)
        for e in entries:
            digest = str(e["digest"])
            if digest == live:
                break
            if digest in known_bad or digest in pinned:
                continue
            return self._try_swap(str(e["name"]), digest)
        self._clear_streak()
        return None

    def _obtain(self, name: str, digest: str) -> Optional[Any]:
        """Fetch + sha256-verify + import one candidate snapshot —
        the host-side half of a swap attempt. Returns the imported
        workflow, or None after recording the refusal."""
        from veles_tpu_torch.snapshotter import Snapshotter
        path = None
        try:
            path = self._mirror.fetch(name, self._tmp_dir)
        except Exception as e:  # noqa: BLE001
            self._refuse("fetch_failed", digest,
                         f"fetch of {name} raised: {e}")
            return None
        if path is None:
            # unreachable, torn, or digest-mismatched copy — the
            # trainer may be mid-push, so this digest stays retryable
            self._refuse("fetch_failed", digest,
                         f"mirror could not deliver a verified copy "
                         f"of {name}")
            return None
        try:
            if not Snapshotter.verify(path):
                self._refuse("verify_failed", digest,
                             f"sidecar verification of {name} failed")
                return None
            # restore_prng=False: a serving-side import must not
            # clobber the process-wide RNG streams
            return Snapshotter.import_(path, restore_prng=False)
        except Exception as e:  # noqa: BLE001 — a truncated/garbage
            # pickle lands here, not in the server
            self._refuse("import_failed", digest,
                         f"snapshot import of {name} failed: {e}")
            return None
        finally:
            for victim in (path, (path or "") + ".sha256"):
                try:
                    if victim:
                        os.remove(victim)
                except OSError:
                    pass

    def _try_swap(self, name: str,
                  digest: str) -> Optional[Dict[str, Any]]:
        from veles_tpu_torch.serving import SwapRefused
        wf = self._obtain(name, digest)
        if wf is None:
            return None
        try:
            gen = self._server.swap_params(wf, digest=digest,
                                           source="watcher")
        except SwapRefused as e:
            self._refuse(e.reason, digest, str(e), counted=False)
            return None
        with self._lock:
            self.n_applied += 1
        self._clear_streak()
        self.info("watcher applied generation %s (%s)", digest[:12],
                  name)
        return gen

    # -- bookkeeping ----------------------------------------------------------

    def _refuse(self, reason: str, digest: str, msg: str,
                counted: bool = True) -> None:
        """Record one refusal. `counted=False` when swap_params already
        counted it (the watcher only adds its own bookkeeping and the
        remembered-digest rule)."""
        if counted:
            self._server.note_swap_refused(reason, msg)
        with self._lock:
            self.n_refused += 1
            self._streak += 1
            self._last_error = f"{reason}: {msg}"[:300]
            if reason in DETERMINISTIC_REFUSALS:
                self._refused_digests.add(digest)

    def _note_error(self, msg: str, quiet: bool = False) -> None:
        with self._lock:
            self._streak += 1
            self._last_error = msg[:300]
        if not quiet:
            self.warning("weight watcher: %s", msg)

    def _clear_streak(self) -> None:
        with self._lock:
            self._streak = 0

    def status(self) -> Dict[str, Any]:
        with self._lock:
            return {
                "running": bool(self._thread is not None
                                and self._thread.is_alive()),
                "mirror": getattr(self._mirror, "spec", None),
                "prefix": self._prefix,
                "poll_s": self.poll_s,
                "n_polls": self.n_polls,
                "n_applied": self.n_applied,
                "n_refused": self.n_refused,
                "streak": self._streak,
                "last_error": self._last_error,
                "refused_digests": sorted(
                    d[:12] for d in self._refused_digests),
            }
