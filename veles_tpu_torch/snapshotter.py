"""Snapshotter: checkpoint and resume of a whole workflow.

The port's counterpart of `veles_tpu/snapshotter.py`, in its own format:
a JAX snapshot holds JAX arrays, which cannot be read without JAX. The
contract is the JAX package's:

- the Snapshotter pickles the ENTIRE workflow (layers, weights, the
  momentum velocities, the loader's cursor and shuffle, the Decision's
  counters) together with the global PRNG registry (`prng.py`), whose
  numpy streams shuffle the loader and whose device stream draws the
  dropout masks; restoring both replays the uninterrupted run;
- names `{prefix}_{stamp}.pickle{ext}`, the stamp the best validation
  error (`link_decision`), else the time;
- the codecs gz (the default), bz2, xz and none, sniffed by their magic
  bytes on import, gzip with `mtime=0` so that one state writes one
  file;
- a write to `.tmp`, fsync and an atomic rename, then the `.sha256`
  sidecar the same way; `verify` checks the sidecar (or, without one,
  streams the codec to its end), and `latest(directory, prefix, verify,
  skip)` returns the newest valid file, skipping torn files and garbage
  or truncated sidecars (`skip=1`: the supervisor's roll back one);
- `interval` (every N-th call), `time_interval` (seconds between
  writes), `keep_last` (older files and sidecars deleted), `dry_run`
  (bookkeeping only, no file);
- `mirror` (or the older `upload_url`): after each export the file and
  its sidecar are pushed to a second store (resilience/mirror.py: a
  directory or an http(s) blob store), verified there, skipped where the
  mirror already holds that digest; a failed push only warns (the local
  file is what a resume reads first), and `keep_last` prunes the mirror
  too. `latest(..., mirror=SPEC)` re-populates a local directory that
  cannot satisfy the request from the mirror's verified copies, and the
  serving tier's WeightWatcher polls the mirror (serving_watch.py);
- `import_(path, restore_prng=True)`.

The Snapshotter is a unit (JAX standard_workflow.py:125-156): in the
granular graph StandardWorkflow links it after the Decision, at the end
of the pulse's gradient chain, and `link_decision` gates it on the
Decision's `improved` (`gate_skip`, re-derived on restore as the other
gates are), so it pickles a pulse whose updates have all run, the
loader's cursor at the next minibatch; the fused loop calls `run()`
itself where the Decision marks an improvement.

Every torch tensor leaves as host bytes (`_SnapshotPickler`), whatever
device it lay on, and comes back as a CPU tensor of the same dtype,
shape and bits, so a snapshot written on the card loads in a process
without CUDA; the workflow drops its device feed and is moved to the
card by its entry point (`StandardWorkflow.place`). The JAX package's
`VELES_SNAPSHOT_DRY_RUN` (its non-writing hosts) comes with the
cluster.

TRUST MODEL: snapshots are pickles, and `pickle.load` runs arbitrary
code: point `import_` and `latest` only at snapshots you wrote.

Import-light (the standard library at import; torch only where a tensor
is pickled or unpickled): the supervisor reads `latest` without torch.
"""

from __future__ import annotations

import bz2
import gzip
import hashlib
import logging
import lzma
import os
import pickle
import sys
import time
from typing import Any, List, Optional

from veles_tpu_torch.units import Unit

#: the format marker of the port's snapshots
FORMAT = "__veles_torch_snapshot__"

#: compression name -> (module opener, filename suffix)
_CODECS = {
    "": (open, ""),
    "gz": (gzip.open, ".gz"),
    "bz2": (bz2.open, ".bz2"),
    "xz": (lzma.open, ".xz"),
}


def _open_codec(compression: str):
    try:
        return _CODECS[compression]
    except KeyError:
        raise ValueError(
            f"unknown compression {compression!r}; one of {sorted(_CODECS)}")


def _opener_for_magic(head: bytes):
    """Codec opener sniffed from a file's first bytes (renamed files
    still load; shared by import_ and integrity verification)."""
    if head[:2] == b"\x1f\x8b":
        return gzip.open
    if head[:3] == b"BZh":
        return bz2.open
    if head[:6] == b"\xfd7zXZ\x00":
        return lzma.open
    return open


def _fsync_path(path: str) -> None:
    fd = os.open(path, os.O_RDONLY)
    try:
        os.fsync(fd)
    finally:
        os.close(fd)


def _sha256_file(path: str, chunk: int = 1 << 20) -> str:
    h = hashlib.sha256()
    with open(path, "rb") as f:
        while True:
            block = f.read(chunk)
            if not block:
                return h.hexdigest()
            h.update(block)


def _rebuild_tensor(data, dtype: str, shape, parameter: bool,
                    requires_grad: bool):
    """A CPU tensor from a snapshot's host bytes (see _SnapshotPickler)."""
    import torch
    t = torch.from_numpy(data).view(getattr(torch, dtype)).reshape(shape)
    if parameter:
        return torch.nn.Parameter(t, requires_grad=requires_grad)
    return t.requires_grad_(requires_grad) if requires_grad else t


class _SnapshotPickler(pickle.Pickler):
    """A pickler that writes every torch tensor as its bytes, copied to
    the host: a tensor on the card leaves the snapshot free of CUDA, and
    every dtype (bfloat16 included) keeps its bits. A tensor referenced
    twice is written once (pickle's memo)."""

    def reducer_override(self, obj):
        torch = sys.modules.get("torch")
        if torch is None or not isinstance(obj, torch.Tensor):
            return NotImplemented
        host = obj.detach().cpu().contiguous()
        data = host.reshape(-1).view(torch.uint8).numpy()
        return _rebuild_tensor, (data, str(host.dtype).split(".")[-1],
                                 tuple(host.shape),
                                 isinstance(obj, torch.nn.Parameter),
                                 obj.requires_grad)


class Snapshotter(Unit):
    """Pickle the owning workflow (compressed) with the global PRNG
    registry: a unit of the granular graph, gated on the Decision's
    improvement; the fused loop calls `run()` where the Decision marks
    one."""

    def __init__(self, workflow=None, prefix: str = "wf",
                 directory: str = ".", compression: str = "gz",
                 interval: int = 1, time_interval: float = 0.0,
                 keep_last: int = 0, upload_url: str = "",
                 mirror: str = "") -> None:
        _open_codec(compression)
        super().__init__(None, name="snapshotter")
        # any object may be pickled; a workflow also adopts the unit
        self.workflow = workflow
        if hasattr(workflow, "add_unit"):
            workflow.add_unit(self)
        self.prefix = prefix
        self.directory = directory
        self.compression = compression
        #: the older name of an http(s) `mirror` (kept for old configs)
        self.upload_url = upload_url
        #: a resilience/mirror.py spec (a directory or an http(s) URL)
        #: each export is pushed to, verified, best effort
        self.mirror = mirror
        #: bookkeeping only, no file (the JAX package's worker processes)
        self.dry_run = False
        #: fire every `interval`-th run (epoch), like the reference's skip
        self.interval = interval
        #: minimum seconds between snapshots (0 = no rate limit)
        self.time_interval = time_interval
        #: keep only the newest N snapshot files (0 = keep all)
        self.keep_last = keep_last
        self.suffix = ""            # metric stamp, set by the decision link
        self.destination = ""       # last written path
        self._skipped = 0
        self._last_time = 0.0
        self._written: list = []
        self._decision = None

    # -- metric stamp --------------------------------------------------------

    def stamp(self) -> str:
        """Filename fragment embedding current metrics (reference behavior:
        snapshot names carry the validation error)."""
        return self.suffix or time.strftime("%Y%m%d_%H%M%S")

    def link_decision(self, decision) -> "Snapshotter":
        """Gate on `decision`'s `improved` and stamp filenames with its
        best validation error."""
        self.gate_skip = ~decision.improved
        self._decision = decision
        return self

    # -- lifecycle -----------------------------------------------------------

    def initialize(self, **kwargs: Any) -> None:
        os.makedirs(self.directory, exist_ok=True)
        return super().initialize(**kwargs)

    def run(self) -> None:
        self._skipped += 1
        if self._skipped < self.interval:
            return
        now = time.time()
        if self.time_interval and now - self._last_time < self.time_interval:
            return
        self._skipped = 0
        self._last_time = now
        dec = self._decision
        if dec is not None and dec.best_validation_err is not None:
            err = dec.best_validation_err
            self.suffix = (f"{err:.6g}" if isinstance(err, float)
                           else str(err))
        if self.dry_run:
            return
        self.destination = self.export()
        self.info("snapshot -> %s", self.destination)
        from veles_tpu_torch.resilience.faults import active_plan
        plan = active_plan()
        if plan is not None:    # deterministic torn-write injection
            plan.maybe_corrupt_snapshot(self.destination)
        # getattr: a Snapshotter restored from an older snapshot has none
        spec = getattr(self, "mirror", "") or getattr(self, "upload_url", "")
        if spec:
            self._push(spec)
        self._written.append(self.destination)
        if self.keep_last:
            while len(self._written) > self.keep_last:
                stale = self._written.pop(0)
                for victim in (stale, stale + ".sha256"):
                    try:
                        os.remove(victim)
                    except OSError:
                        pass
                if spec:
                    # the mirror follows the local retention policy
                    try:
                        from veles_tpu_torch.resilience.mirror import \
                            get_mirror
                        get_mirror(spec).delete(os.path.basename(stale))
                    except Exception:  # noqa: BLE001 — best effort
                        pass

    def _push(self, spec: str) -> None:
        """Push the last export to the mirror `spec`; a failure warns and
        leaves the local file as the one copy."""
        try:
            from veles_tpu_torch.resilience.mirror import get_mirror
            if get_mirror(spec).push(self.destination):
                self.info("snapshot mirrored -> %s", spec)
            else:
                self.warning("snapshot mirror to %s did not verify", spec)
        except Exception as e:  # noqa: BLE001 — the mirror is best effort
            self.warning("snapshot mirror to %s failed: %s", spec, e)

    def __getstate__(self):
        d = super().__getstate__()
        # re-linked by the workflow on restore
        d["_decision"] = None
        # runtime bookkeeping is process-local (paths, rate-limit
        # clocks): dropping it also makes one state write one file
        d["destination"] = ""
        d["_written"] = []
        d["_skipped"] = 0
        d["_last_time"] = 0.0
        return d

    # -- the file ------------------------------------------------------------

    def export(self) -> str:
        """Write the workflow and the PRNG registry to a new snapshot
        file (`.tmp`, fsync, rename, then the sidecar); returns its
        path."""
        from veles_tpu_torch import prng
        opener, ext = _open_codec(self.compression)
        if self.compression == "gz":
            # deterministic gzip: pin the header mtime (gzip stamps "now"
            # by default), so identical state pickles to identical bytes
            def opener(p, mode):  # noqa: F811 — deliberate shadow
                return gzip.GzipFile(p, mode, mtime=0)
        path = os.path.join(self.directory,
                            f"{self.prefix}_{self.stamp()}.pickle{ext}")
        # every crash window leaves either no new file, or intact data
        # without a sidecar (verify() then streams the codec): never a
        # fresh digest beside stale data or the reverse. A sidecar of the
        # same stamp from an earlier run is removed first for that reason.
        tmp = path + ".tmp"
        with opener(tmp, "wb") as f:
            _SnapshotPickler(f, protocol=pickle.HIGHEST_PROTOCOL).dump(
                {FORMAT: 1, "workflow": self.workflow,
                 "prng": prng.snapshot_registry()})
        digest = _sha256_file(tmp)
        _fsync_path(tmp)
        try:
            os.remove(path + ".sha256")
        except OSError:
            pass
        os.replace(tmp, path)
        sidecar_tmp = path + ".sha256.tmp"
        with open(sidecar_tmp, "w") as f:
            f.write(f"{digest}  {os.path.basename(path)}\n")
        _fsync_path(sidecar_tmp)
        os.replace(sidecar_tmp, path + ".sha256")
        # rename durability: fsync the directory or a power cut can
        # resurrect the pre-rename state
        try:
            _fsync_path(self.directory or ".")
        except OSError:
            pass    # non-fsyncable directory (network fs): best effort
        return path

    @staticmethod
    def verify(path: str) -> bool:
        """Integrity check of one snapshot file: its digest against the
        `.sha256` sidecar; without a sidecar, the codec streamed to its
        end (a truncated gz/bz2/xz file fails; an uncompressed one
        passes)."""
        sidecar = path + ".sha256"
        if os.path.exists(sidecar):
            try:
                with open(sidecar) as f:
                    expected = f.read().split()[0]
            except (OSError, IndexError):
                return False
            try:
                return _sha256_file(path) == expected
            except OSError:
                return False
        try:
            with open(path, "rb") as f:
                head = f.read(6)
            opener = _opener_for_magic(head)
            if opener is open:
                return True     # uncompressed: no cheap check
            with opener(path, "rb") as f:
                while f.read(1 << 20):
                    pass
            return True
        except Exception:       # noqa: BLE001 — any decode error = bad
            return False

    @staticmethod
    def latest(directory: str, prefix: str = "", verify: bool = True,
               skip: int = 0, mirror: str = "") -> Optional[str]:
        """Newest VALID snapshot file in `directory` whose name starts
        with `prefix`. Corrupt or partial files (a bad sha256, a
        truncated stream) and in-flight `.tmp` files are skipped with a
        warning naming the fallback. `skip=N` returns the (N+1)-th newest
        valid snapshot (the supervisor's roll back one after a
        non-finite abort). With `mirror` (a resilience/mirror.py spec), a
        directory that cannot satisfy the request (missing, emptied, all
        candidates corrupt) is re-populated from the mirror's verified
        copies before giving up."""
        result = Snapshotter._latest_local(directory, prefix, verify, skip)
        if result is None and mirror:
            from veles_tpu_torch.resilience.mirror import restore_missing
            log = logging.getLogger("veles_torch.Snapshotter")
            try:
                restored = restore_missing(mirror, directory, prefix)
            except Exception as e:  # noqa: BLE001 — degrade, not die
                log.warning("mirror restore from %s failed: %s", mirror, e)
                restored = []
            if restored:
                log.warning("local snapshot dir %s could not satisfy the "
                            "restore: re-populated %d file(s) from mirror "
                            "%s", directory, len(restored), mirror)
                result = Snapshotter._latest_local(directory, prefix,
                                                   verify, skip)
        return result

    @staticmethod
    def _latest_local(directory: str, prefix: str, verify: bool,
                      skip: int) -> Optional[str]:
        log = logging.getLogger("veles_torch.Snapshotter")
        try:
            names = [n for n in os.listdir(directory)
                     if ".pickle" in n and n.startswith(prefix)
                     and not n.endswith(".tmp")
                     and not n.endswith(".sha256")]
        except FileNotFoundError:
            return None
        paths = sorted((os.path.join(directory, n) for n in names),
                       key=os.path.getmtime, reverse=True)
        valid: List[str] = []
        rejected = None
        for p in paths:
            if verify and not Snapshotter.verify(p):
                log.warning("snapshot %s failed integrity check — "
                            "skipping", p)
                rejected = rejected or p
                continue
            valid.append(p)
            if len(valid) > skip:
                break
        if len(valid) <= skip:
            return None
        if rejected is not None or skip:
            log.warning("falling back to %s", valid[skip])
        return valid[skip]

    @staticmethod
    def import_(path: str, restore_prng: bool = True) -> Any:
        """Restore a workflow from a snapshot file (any codec, sniffed
        by magic bytes). Its tensors come back on the CPU.
        `restore_prng=False` leaves the process's PRNG registry as it is
        (a reader that only wants the weights)."""
        with open(path, "rb") as f:
            head = f.read(6)
        opener = _opener_for_magic(head)
        with opener(path, "rb") as f:
            obj = pickle.load(f)
        if not isinstance(obj, dict) or FORMAT not in obj:
            raise ValueError(f"{path} is not a snapshot of this package "
                             f"(no {FORMAT!r} marker)")
        if restore_prng:
            from veles_tpu_torch import prng
            prng.restore_registry(obj["prng"])
        return obj["workflow"]
