"""Training supervisor: automated crash and hang recovery from snapshots.

The port's copy of `veles_tpu/resilience/supervisor.py`, for one host.
`python -m veles_tpu_torch WORKFLOW.py [--fused] --supervise …` makes
this process a light parent that spawns the training run (its own
command line without the supervisor's flags), through the fused step
or the granular graph, and restarts it:

    spawn ──▶ monitor ──▶ the child exits 0 ──▶ report, exit 0
                │
                ├─ child died (crash / preemption / nonzero exit)
                ├─ heartbeat stale > stall_timeout  ──▶ kill the child
                ▼
          budget left AND epoch progress?
                │yes                         │no
                ▼                            ▼
          backoff (exp + jitter)       report, exit EXIT_GIVEUP
          pick newest VALID snapshot
          (roll back one on EXIT_NONFINITE)
          re-spawn with -s <snapshot> ──▶ monitor …

Liveness is a heartbeat FILE (`VELES_HEARTBEAT_FILE`): the
launcher writes it at startup and at every epoch boundary (an atomic
JSON write carrying the epoch counter and, in a fused run, the device
feed's counters),
so the supervisor detects both "process is gone" and "process is alive
but stuck", and tells "restarted but not advancing" from progress. A
fault fired in one attempt is recorded in `VELES_FAULT_STATE` and does
not fire again in the next.

Import-light on purpose (the standard library and the port's jax-free,
torch-free modules): the parent never imports torch, so it never
initializes CUDA or holds the card its children train on. With
`mirror` (the launcher's `--mirror`) a restart whose snapshot directory
cannot satisfy it restores from the snapshot mirror
(`Snapshotter.latest(mirror=...)`). The JAX package's telemetry, memory
and analysis sections of the report and the cluster member come with
later slices.
"""

from __future__ import annotations

import json
import os
import shutil
import signal
import subprocess
import sys
import tempfile
import time
from typing import Any, Dict, List, Optional, Sequence

from veles_tpu_torch.logger import Logger
from veles_tpu_torch.resilience import EXIT_GIVEUP, EXIT_NONFINITE, \
    EXIT_STALLED
from veles_tpu_torch.resilience.backoff import backoff_delay
from veles_tpu_torch.resilience.clock import SYSTEM_CLOCK, Clock
from veles_tpu_torch.snapshotter import Snapshotter


# -- heartbeat protocol (the writer is the launcher) -------------------------

def write_heartbeat(path: str, epoch: int,
                    feed: Optional[Dict[str, Any]] = None) -> None:
    """Atomically publish liveness and the epoch counter: the file's
    mtime is the liveness signal, the payload the progress signal.
    `feed` is the child's device-feed counters (`DeviceFeed.stats()`),
    which the supervisor's JSON report carries."""
    tmp = f"{path}.{os.getpid()}.tmp"
    payload: Dict[str, Any] = {"epoch": int(epoch), "ts": time.time()}
    if feed:
        # the per-epoch rows stay out: only the totals matter here
        payload["feed"] = {k: v for k, v in feed.items()
                           if k != "epoch_log"}
    with open(tmp, "w") as f:
        json.dump(payload, f)
    os.replace(tmp, path)


def read_heartbeat(path: str) -> Dict[str, Any]:
    """Parse a heartbeat file; `{"epoch": -1}` when missing or torn."""
    try:
        with open(path) as f:
            data = json.load(f)
        out = {"epoch": int(data.get("epoch", -1)),
               "ts": float(data.get("ts", 0.0))}
        if isinstance(data.get("feed"), dict):
            out["feed"] = data["feed"]
        return out
    except (OSError, ValueError):
        return {"epoch": -1, "ts": 0.0}


def strip_flags(argv: Sequence[str],
                flags: Dict[str, bool]) -> List[str]:
    """Remove flag occurrences from a command line. `flags` maps flag
    name -> whether it takes a value; both `--flag value` and
    `--flag=value` forms are dropped."""
    out: List[str] = []
    skip = False
    for a in argv:
        if skip:
            skip = False
            continue
        if a in flags:
            skip = flags[a]
            continue
        if any(a.startswith(f + "=")
               for f, takes in flags.items() if takes):
            continue
        out.append(a)
    return out


def _with_snapshot(argv: Sequence[str], snapshot: str) -> List[str]:
    """Rewrite a child command line to resume from `snapshot`: any
    existing -s/--snapshot (both `-s X` and `--snapshot=X` forms) is
    dropped, the new one appended."""
    return strip_flags(argv, {"-s": True, "--snapshot": True}) \
        + ["-s", snapshot]


#: restart waits: min(BACKOFF_BASE * 2^k, BACKOFF_MAX) seconds before
#: restart k + 1, scaled by [1, 1 + BACKOFF_JITTER)
BACKOFF_BASE, BACKOFF_MAX, BACKOFF_JITTER = 1.0, 30.0, 0.25
#: consecutive failed attempts with NO epoch advance before giving up (a
#: crash loop that always dies in the same place)
NO_PROGRESS_LIMIT = 2
#: seconds between polls of the child, and from its SIGTERM to SIGKILL
POLL_INTERVAL, TERM_GRACE = 0.2, 5.0


def kill_proc(proc: subprocess.Popen) -> None:
    """TERM, TERM_GRACE, then KILL; idempotent."""
    if proc.poll() is not None:
        return
    try:
        proc.terminate()
    except OSError:
        pass
    try:
        proc.wait(timeout=TERM_GRACE)
    except subprocess.TimeoutExpired:
        try:
            proc.send_signal(signal.SIGKILL)
        except OSError:
            pass
        proc.wait()


class Supervisor(Logger):
    """Spawn, watch and restart a training job until it finishes or the
    retry budget / progress cutoff says stop. `clock` is what the loop
    reads and sleeps by (tests hand it one that skips the waits)."""

    def __init__(self, argv: Sequence[str], *, snapshot_dir: str = ".",
                 snapshot_prefix: str = "", max_restarts: int = 3,
                 stall_timeout: float = 0.0, report_path: str = "",
                 mirror: str = "", clock: Clock = SYSTEM_CLOCK) -> None:
        self.argv = list(argv)
        if not self.argv:
            raise ValueError("Supervisor needs a command")
        self.snapshot_dir = snapshot_dir
        self.snapshot_prefix = snapshot_prefix
        #: a resilience/mirror.py spec restarts restore from when the
        #: snapshot directory cannot satisfy them ('' = none)
        self.mirror = mirror
        self.max_restarts = max_restarts
        #: 0 disables stall detection (death-only supervision)
        self.stall_timeout = stall_timeout
        #: optional JSON exit report (attempt log, outcome, final code)
        self.report_path = report_path
        self._clock = clock
        self.env = dict(os.environ)
        self.attempts: List[Dict[str, Any]] = []
        self._proc: Optional[subprocess.Popen] = None

    # -- lifecycle ------------------------------------------------------------

    def run(self) -> int:
        """Supervise to completion; returns the job's final exit code
        (0 on success, EXIT_GIVEUP when abandoning, 130 when the
        supervisor itself is interrupted or terminated — the child is
        killed and the exit report still lands)."""
        run_dir = tempfile.mkdtemp(prefix="veles_supervisor_")

        # SIGTERM of the supervisor must not orphan the child: it takes
        # Ctrl-C's teardown path for the duration of the run
        def _to_interrupt(*_):
            raise KeyboardInterrupt

        try:        # signal handlers are main-thread-only
            prev_term = signal.signal(signal.SIGTERM, _to_interrupt)
        except ValueError:
            prev_term = None
        try:
            return self._run(run_dir)
        except KeyboardInterrupt:
            code = None
            if self._proc is not None:
                kill_proc(self._proc)
                code = self._proc.returncode
            self.attempts.append({
                "attempt": len(self.attempts) + 1,
                "reason": "supervisor terminated", "exit_codes": [code],
                "epoch_reached": -1, "snapshot": None})
            return self._finish(130, "terminated by signal")
        finally:
            if prev_term is not None:
                signal.signal(signal.SIGTERM, prev_term)
            shutil.rmtree(run_dir, ignore_errors=True)

    def _run(self, run_dir: str) -> int:
        restarts = 0
        best_epoch = -1
        stagnant = 0
        snapshot: Optional[str] = None
        # one shared fault state file: a fault that fired in attempt N
        # must not re-fire in attempt N+1 (see faults.py)
        self.env.setdefault("VELES_FAULT_STATE",
                            os.path.join(run_dir, "fault_state.json"))
        while True:
            attempt_no = len(self.attempts) + 1
            hb_path = os.path.join(run_dir, f"hb_{attempt_no}.json")
            self.info("attempt %d/%d%s", attempt_no, self.max_restarts + 1,
                      f" (resume from {snapshot})" if snapshot else "")
            self._proc = self._spawn(snapshot, hb_path)
            reason, code = self._monitor(self._proc, hb_path)
            hb = read_heartbeat(hb_path)
            epoch = hb["epoch"]
            attempt = {
                "attempt": attempt_no, "reason": reason,
                "exit_codes": [code], "epoch_reached": epoch,
                "snapshot": snapshot}
            # the device feed's counters from the child's last heartbeat
            if hb.get("feed"):
                attempt["feed"] = hb["feed"]
            self.attempts.append(attempt)
            if reason == "ok":
                return self._finish(0, "completed")
            self.warning("attempt %d failed: %s (exit code %s, epoch "
                         "reached %d)", attempt_no, reason, code, epoch)
            if epoch > best_epoch:
                best_epoch = epoch
                stagnant = 0
            else:
                stagnant += 1
            if restarts >= self.max_restarts:
                return self._finish(
                    EXIT_GIVEUP,
                    f"retry budget exhausted ({self.max_restarts} "
                    f"restarts)")
            if stagnant >= NO_PROGRESS_LIMIT:
                return self._finish(
                    EXIT_GIVEUP,
                    f"no epoch progress across {stagnant} consecutive "
                    f"failures (stuck at epoch {best_epoch})")
            restarts += 1
            delay = backoff_delay(restarts - 1, base=BACKOFF_BASE,
                                  cap=BACKOFF_MAX, jitter=BACKOFF_JITTER)
            self.info("backing off %.2fs before restart %d", delay,
                      restarts)
            self._clock.sleep(delay)
            # EXIT_NONFINITE: the newest snapshot may already embed the
            # divergence (it was written before the guard tripped) —
            # roll back one valid snapshot.
            skip = 1 if code == EXIT_NONFINITE else 0
            snapshot = Snapshotter.latest(self.snapshot_dir,
                                          prefix=self.snapshot_prefix,
                                          skip=skip, mirror=self.mirror)
            if snapshot is None:
                self.warning("no valid snapshot in %s — restarting from "
                             "scratch", self.snapshot_dir)
            else:
                self.info("restart %d will resume from %s", restarts,
                          snapshot)

    # -- internals ------------------------------------------------------------

    def _spawn(self, snapshot: Optional[str],
               hb_path: str) -> subprocess.Popen:
        argv = _with_snapshot(self.argv, snapshot) if snapshot \
            else self.argv
        return subprocess.Popen(argv, env=dict(
            self.env, VELES_HEARTBEAT_FILE=hb_path))

    def _monitor(self, proc: subprocess.Popen, hb_path: str):
        """Watch one attempt. Returns (reason, exit_code): reason "ok"
        (exited 0), "died" (exited nonzero), or "stall" (the heartbeat
        went stale; the child was killed)."""
        # wall time: staleness compares against the heartbeat's mtime
        start = self._clock.time()
        while True:
            code = proc.poll()
            if code is not None:
                return ("ok" if code == 0 else "died"), code
            if self.stall_timeout > 0:
                try:
                    last = os.path.getmtime(hb_path)
                except OSError:
                    last = start     # not yet written: startup grace
                stale = self._clock.time() - max(last, start)
                if stale > self.stall_timeout:
                    self.warning(
                        "heartbeat %s stale for %.1fs (> %.1fs) — "
                        "declaring the job hung", hb_path, stale,
                        self.stall_timeout)
                    kill_proc(proc)
                    # the child just killed reports the signal; the
                    # report says why it died
                    return "stall", (EXIT_STALLED if proc.returncode < 0
                                     else proc.returncode)
            self._clock.sleep(POLL_INTERVAL)

    def _finish(self, code: int, outcome: str) -> int:
        """Log the exit report (and write it as JSON when report_path is
        set); returns `code`."""
        lines = [f"supervisor: {outcome} after {len(self.attempts)} "
                 f"attempt(s)"]
        for a in self.attempts:
            lines.append(
                f"  attempt {a['attempt']}: {a['reason']}, exit codes "
                f"{a['exit_codes']}, epoch reached {a['epoch_reached']}, "
                f"snapshot {a['snapshot'] or '<fresh>'}")
        if code != 0:
            latest = Snapshotter.latest(self.snapshot_dir,
                                        prefix=self.snapshot_prefix)
            lines.append(
                f"  resume manually with: -s {latest}" if latest else
                f"  no valid snapshot found in {self.snapshot_dir!r}")
        report = "\n".join(lines)
        (self.info if code == 0 else self.error)("%s", report)
        print(report, file=sys.stderr, flush=True)
        if self.report_path:
            report_obj: Dict[str, Any] = {
                "outcome": outcome, "exit_code": code,
                "attempts": self.attempts}
            # the newest device-feed counters, promoted to the top level
            # with the attempt they come from
            for a in reversed(self.attempts):
                if a.get("feed"):
                    report_obj["feed"] = dict(a["feed"],
                                              from_attempt=a["attempt"])
                    break
            with open(self.report_path, "w") as f:
                json.dump(report_obj, f, indent=2)
        return code
