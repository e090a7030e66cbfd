"""Snapshot durability backend: mirror snapshots to a second store.

The port's copy of `veles_tpu/resilience/mirror.py`, with its on-disk
and on-wire format: after every atomic local write the Snapshotter
pushes the snapshot AND its sha256 sidecar to a mirror — a second
directory (`DirMirror`: an attached volume) or an HTTP blob store
(`HttpMirror`, the `upload_url` PUT contract, which `MirrorServer` below
speaks) — verifies the mirrored bytes against the sidecar digest, and
skips the upload when the mirror already holds a verified copy (one
state, one file: the push is idempotent). `Snapshotter.latest(mirror=
...)` restores from it when the local directory is missing, truncated
or corrupt (`restore_missing`), and the serving tier's `WeightWatcher`
(serving_watch.py) polls it for new digests to hot-swap. Entries are
flat files plus `.sha256` sidecars, and tiny JSON meta records beside
them (no ".pickle" in their names), exactly as the JAX package writes
them, so either package's mirror reads the other's.

TRUST MODEL: mirrored snapshots are the SAME pickles the local
directory holds — code on unpickle — so a mirror must live inside the
same trust boundary as the local snapshot dir (your volume, your
loopback/token-authenticated store). `MirrorServer` below enforces the
usual loopback-testable hardening (shared token, bounded bodies,
sanitized names) but it does not make foreign pickles safe; never point
a restore at a mirror you do not own.

Import-light on purpose (the standard library only): the supervisor's
parent process uses this and must never initialize CUDA.
"""

from __future__ import annotations

import hashlib
import json
import logging
import os
import shutil
import threading
import urllib.error
import urllib.request
from typing import Dict, List, Optional

_log = logging.getLogger("veles_torch.Mirror")


def _tmp_name(path: str) -> str:
    """A per-writer temp name next to `path` (still `.tmp`-suffixed so
    listings skip it). Concurrent pushes/fetches of the SAME entry —
    a respawned child re-exporting while the old push is still in
    flight, two handler threads serving the same upload — must each
    write their own temp file: a shared `path + ".tmp"` let one
    writer's atomic replace steal (or tear) another's bytes."""
    return f"{path}.{os.getpid()}.{threading.get_ident()}.tmp"

#: mirrored snapshot bodies above this are refused by MirrorServer
#: (a snapshot is a compressed workflow pickle: even flagship runs sit
#: far below this; anything bigger is a bug or an attack)
MAX_SNAPSHOT_BODY = 1 << 30


def _sha256_file(path: str, chunk: int = 1 << 20) -> str:
    h = hashlib.sha256()
    with open(path, "rb") as f:
        while True:
            block = f.read(chunk)
            if not block:
                return h.hexdigest()
            h.update(block)


def _read_sidecar(path: str) -> Optional[str]:
    """Digest recorded in `path`'s .sha256 sidecar (None when absent or
    unreadable)."""
    try:
        with open(path + ".sha256") as f:
            return f.read().split()[0]
    except (OSError, IndexError):
        return None


def _safe_name(name: str) -> str:
    """Mirror entries are FLAT: reject anything that is not a plain
    basename (path traversal through a snapshot name must be impossible
    on both client and server side)."""
    base = os.path.basename(name)
    if not base or base != name or base.startswith(".") or "/" in name \
            or "\\" in name:
        raise ValueError(f"illegal mirror entry name {name!r}")
    return base


class Mirror:
    """One mirrored snapshot store. Entries are (name, digest, mtime)
    triples; `push` is idempotent on (name, digest)."""

    #: for logs/reports
    spec = ""

    def entries(self) -> List[Dict[str, object]]:
        """[{"name", "digest", "mtime"}] for every mirrored snapshot
        (digest from the mirrored sidecar; empty on an unreachable
        mirror — visibility is best-effort, restores re-verify)."""
        raise NotImplementedError

    def has(self, name: str, digest: str) -> bool:
        raise NotImplementedError

    def push(self, path: str) -> bool:
        """Mirror `path` + its sidecar; verify the mirrored bytes
        against the sidecar digest. Returns True when the mirror holds a
        verified copy afterwards (including the no-op case where it
        already did)."""
        raise NotImplementedError

    def fetch(self, name: str, dest_dir: str) -> Optional[str]:
        """Restore one snapshot (+ sidecar) into `dest_dir`, verifying
        the digest; returns the local path or None (missing/corrupt)."""
        raise NotImplementedError

    def delete(self, name: str) -> None:
        """Best-effort removal (keep_last pruning follows the local
        retention policy so the mirror cannot grow without bound)."""
        raise NotImplementedError

    # -- control-plane meta records -------------------------------------------
    # Tiny mutable JSON records living NEXT TO the snapshot blobs: in the
    # JAX package the cluster's rendezvous state and the serving fleet's
    # presence beacons (the port's cluster and router come with later
    # slices; the records and their format are here so that both
    # packages read one mirror). Last-writer-wins by design. Meta names
    # never contain ".pickle", so they are invisible to `entries()` and
    # exempt from keep_last pruning.

    def put_meta(self, name: str, record: Dict[str, object]) -> bool:
        """Atomically publish `record` under `name` (overwrites)."""
        raise NotImplementedError

    def get_meta(self, name: str) -> Optional[Dict[str, object]]:
        """The record under `name`, or None (absent/unreadable/not a
        JSON object)."""
        raise NotImplementedError

    def meta_names(self, prefix: str = "") -> List[str]:
        """Names of the meta records currently published, filtered by
        `prefix`, sorted. Empty on an unreachable mirror (discovery is
        best-effort — readers treat a missing listing like an empty
        one and re-poll): how a serving-fleet router discovers replicas
        it was never told about."""
        raise NotImplementedError

    def _corrupt(self, name: str) -> None:
        """Deterministic bit-rot injection hook (mirror_corrupt fault):
        tear the MIRRORED copy while the local one stays intact."""
        raise NotImplementedError

    def _maybe_inject_corruption(self, name: str) -> None:
        from veles_tpu_torch.resilience.faults import active_plan
        plan = active_plan()
        if plan is not None and plan.mirror_corrupt_at_push():
            self._corrupt(name)
            _log.warning("FAULT INJECTION: tore mirrored copy of %s",
                         name)


class DirMirror(Mirror):
    """Second-directory mirror (attached volume, NFS mount)."""

    def __init__(self, root: str, clock=None) -> None:
        from veles_tpu_torch.resilience.clock import SYSTEM_CLOCK
        self.root = root
        self.spec = root
        self._clock = clock or SYSTEM_CLOCK

    def _path(self, name: str) -> str:
        return os.path.join(self.root, _safe_name(name))

    def entries(self) -> List[Dict[str, object]]:
        try:
            names = [n for n in os.listdir(self.root)
                     if ".pickle" in n and not n.endswith(".sha256")
                     and not n.endswith(".tmp")]
        except OSError:
            return []
        out = []
        for n in names:
            digest = _read_sidecar(self._path(n))
            if digest is None:
                continue     # sidecar-less mirror entry: not trustable
            try:
                mtime = os.path.getmtime(self._path(n))
            except OSError:
                continue
            out.append({"name": n, "digest": digest, "mtime": mtime})
        return out

    def has(self, name: str, digest: str) -> bool:
        return _read_sidecar(self._path(name)) == digest

    def push(self, path: str) -> bool:
        name = os.path.basename(path)
        digest = _read_sidecar(path) or _sha256_file(path)
        os.makedirs(self.root, exist_ok=True)
        if self.has(name, digest):
            _log.debug("mirror already holds %s (digest match): no-op",
                       name)
            return True
        dst = self._path(name)
        tmp = _tmp_name(dst)
        shutil.copyfile(path, tmp)
        if _sha256_file(tmp) != digest:      # torn read of a live file
            os.remove(tmp)
            _log.warning("mirror push of %s read back a different "
                         "digest: not published", name)
            return False
        os.replace(tmp, dst)
        side_tmp = _tmp_name(dst + ".sha256")
        with open(side_tmp, "w") as f:
            f.write(f"{digest}  {name}\n")
        os.replace(side_tmp, dst + ".sha256")
        self._maybe_inject_corruption(name)
        return True

    def fetch(self, name: str, dest_dir: str) -> Optional[str]:
        src = self._path(name)
        digest = _read_sidecar(src)
        if digest is None or not os.path.exists(src):
            return None
        if _sha256_file(src) != digest:
            _log.warning("mirror copy of %s is corrupt (digest "
                         "mismatch) — not restoring it", name)
            return None
        os.makedirs(dest_dir, exist_ok=True)
        dst = os.path.join(dest_dir, name)
        tmp = _tmp_name(dst)
        shutil.copyfile(src, tmp)
        if _sha256_file(tmp) != digest:
            os.remove(tmp)
            return None
        os.replace(tmp, dst)
        side_tmp = _tmp_name(dst + ".sha256")
        with open(side_tmp, "w") as f:
            f.write(f"{digest}  {name}\n")
        os.replace(side_tmp, dst + ".sha256")
        return dst

    def delete(self, name: str) -> None:
        for victim in (self._path(name), self._path(name) + ".sha256"):
            try:
                os.remove(victim)
            except OSError:
                pass

    def put_meta(self, name: str, record: Dict[str, object]) -> bool:
        dst = self._path(name)
        os.makedirs(self.root, exist_ok=True)
        # per-process tmp name: two hosts publishing the same record
        # concurrently must each tear nothing (last replace wins)
        tmp = _tmp_name(dst)
        try:
            with open(tmp, "w") as f:
                json.dump(record, f)
                f.flush()
                os.fsync(f.fileno())
            os.replace(tmp, dst)
        except OSError:
            try:
                os.remove(tmp)
            except OSError:
                pass
            return False
        return True

    #: torn-read retries in get_meta: put_meta's tmp+fsync+replace makes
    #: a mid-replace read impossible on POSIX-local stores, but the
    #: DirMirror contract includes NFS/network mounts where a reader can
    #: still observe partial bytes — retry briefly, then degrade to None
    META_READ_RETRIES = 2
    META_READ_RETRY_S = 0.02

    def get_meta(self, name: str) -> Optional[Dict[str, object]]:
        for attempt in range(self.META_READ_RETRIES + 1):
            try:
                with open(self._path(name)) as f:
                    data = json.load(f)
            except OSError:
                # absent (or unreadable) record: nothing a retry fixes
                return None
            except ValueError:
                # torn/partial JSON mid-replace: the complete record
                # lands with the writer's atomic rename — give it a
                # beat, then degrade to None (callers already treat
                # None as "no record yet" and re-poll)
                if attempt < self.META_READ_RETRIES:
                    self._clock.sleep(self.META_READ_RETRY_S)
                    continue
                _log.warning("meta record %s unparseable after %d "
                             "re-reads (torn write?) — treating as "
                             "absent", name, attempt + 1)
                return None
            return data if isinstance(data, dict) else None
        return None

    def meta_names(self, prefix: str = "") -> List[str]:
        # meta records are exactly the non-snapshot files: no ".pickle"
        # in the name (the entries() invisibility rule), no sidecars,
        # no in-flight per-writer tmp files
        try:
            names = os.listdir(self.root)
        except OSError:
            return []
        return sorted(
            n for n in names
            if ".pickle" not in n and not n.endswith((".sha256", ".tmp"))
            and n.startswith(prefix))

    def _corrupt(self, name: str) -> None:
        from veles_tpu_torch.resilience.faults import corrupt_file
        corrupt_file(self._path(name))


class HttpMirror(Mirror):
    """HTTP blob-store mirror: PUT `{base}/{name}` (the `upload_url`
    contract) plus the sidecar, GET to verify/restore,
    `GET {base}/?index=1` for the entry listing (MirrorServer speaks
    all of these; a dumb PUT-only store still receives verified-size
    uploads, it just cannot serve restores)."""

    def __init__(self, base_url: str, token: Optional[str] = None,
                 timeout: float = 60.0, retries: int = 3,
                 retry_base: float = 0.2, retry_cap: float = 2.0,
                 retry_total: float = 8.0) -> None:
        self.base_url = base_url.rstrip("/")
        self.token = token if token is not None \
            else os.environ.get("VELES_WEB_TOKEN") or None
        self.timeout = timeout
        # bounded jittered-exponential retries on TRANSIENT failures
        # (connection refused/reset, 5xx, torn response) — a mirror that
        # blips for a second must not fail a push or a watcher poll. The
        # `retry_total` wall-clock budget is deliberately BELOW the
        # default WeightWatcher poll interval (10 s): a down mirror
        # costs at most one bounded stall per poll, never a pile-up.
        self.retries = max(int(retries), 1)
        self.retry_base = float(retry_base)
        self.retry_cap = float(retry_cap)
        self.retry_total = float(retry_total)
        self.spec = self.base_url

    # -- plumbing -------------------------------------------------------------

    def _request(self, method: str, name_or_query: str,
                 data: Optional[bytes] = None):
        req = urllib.request.Request(
            f"{self.base_url}/{name_or_query}", data=data, method=method)
        if self.token:
            req.add_header("X-Veles-Token", self.token)
        if data is not None:
            req.add_header("Content-Type", "application/octet-stream")
        return urllib.request.urlopen(req, timeout=self.timeout)

    def _retry(self, fn):
        """Run `fn` under the shared bounded-backoff policy
        (resilience/backoff.py). Transient = connection-level errors +
        torn responses + HTTP 5xx; a 4xx is PERMANENT (retrying a 404
        three times would stall every `has()` probe of a not-yet-pushed
        name) and must be handled inside `fn`. Exhaustion re-raises the
        last transient error — soft-fail callers catch it."""
        import http.client
        from veles_tpu_torch.resilience.backoff import call_with_backoff
        return call_with_backoff(
            fn, attempts=self.retries, base=self.retry_base,
            cap=self.retry_cap, total=self.retry_total,
            retry_on=(urllib.error.URLError, OSError, ValueError,
                      http.client.HTTPException))

    def _get_bytes(self, name_or_query: str) -> Optional[bytes]:
        import http.client

        def attempt() -> Optional[bytes]:
            try:
                with self._request("GET", name_or_query) as resp:
                    return resp.read()
            except urllib.error.HTTPError as e:
                if e.code < 500:
                    return None   # permanent (404 et al.): no retry
                raise
        try:
            return self._retry(attempt)
        except (urllib.error.URLError, OSError, ValueError,
                http.client.HTTPException):
            # HTTPException covers a TORN response (IncompleteRead from
            # a blob replaced mid-stream): best-effort visibility, the
            # caller retries or degrades exactly like "unreachable"
            return None

    def _get_to_file(self, name: str, dst: str) -> Optional[str]:
        """Stream a GET into `dst`, returning the sha256 hex digest."""
        import http.client

        def attempt() -> Optional[str]:
            h = hashlib.sha256()
            try:
                # "wb" truncates: a retried attempt restarts the stream
                # from byte 0, never appends to a torn prior try
                with self._request("GET", name) as resp, \
                        open(dst, "wb") as f:
                    while True:
                        block = resp.read(1 << 20)
                        if not block:
                            break
                        h.update(block)
                        f.write(block)
            except urllib.error.HTTPError as e:
                if e.code < 500:
                    return None
                raise
            return h.hexdigest()
        try:
            got = self._retry(attempt)
        except (urllib.error.URLError, OSError, ValueError,
                http.client.HTTPException):
            got = None
        if got is None:
            try:
                os.remove(dst)
            except OSError:
                pass
        return got

    # -- Mirror API -----------------------------------------------------------

    def entries(self) -> List[Dict[str, object]]:
        raw = self._get_bytes("?index=1")
        if raw is None:
            return []
        try:
            items = json.loads(raw)
            return [{"name": _safe_name(str(i["name"])),
                     "digest": str(i["digest"]),
                     "mtime": float(i.get("mtime", 0.0))}
                    for i in items]
        except (ValueError, KeyError, TypeError):
            return []

    def has(self, name: str, digest: str) -> bool:
        raw = self._get_bytes(_safe_name(name) + ".sha256")
        if raw is None:
            return False
        try:
            return raw.decode().split()[0] == digest
        except (UnicodeDecodeError, IndexError):
            return False

    def push(self, path: str) -> bool:
        from veles_tpu_torch.http_util import http_put_file
        name = _safe_name(os.path.basename(path))
        digest = _read_sidecar(path) or _sha256_file(path)
        if self.has(name, digest):
            _log.debug("mirror already holds %s (digest match): no-op",
                       name)
            return True
        headers = {"X-Veles-Token": self.token} if self.token else None
        self._retry(lambda: http_put_file(
            f"{self.base_url}/{name}", path,
            timeout=self.timeout, headers=headers))
        # verify-on-upload BEFORE publishing the sidecar: the sidecar
        # is what `has()`/`entries()` trust, so it must only ever sit
        # next to bytes that verified — publishing it first would turn
        # a corrupted-in-transit upload into a permanently "already
        # mirrored" poisoned entry. A PUT-only store (no GET) is
        # tolerated with a warning — that upload happened, it just
        # cannot be independently verified (nor serve restores).
        tmp = _tmp_name(path + ".mirror_verify")
        got = self._get_to_file(name, tmp)
        try:
            os.remove(tmp)
        except OSError:
            pass
        if got is not None and got != digest:
            _log.warning("mirror copy of %s failed verify-on-upload "
                         "(digest mismatch): unpublishing it", name)
            self.delete(name)
            return False
        sidecar = path + ".sha256"
        if os.path.exists(sidecar):
            self._retry(lambda: http_put_file(
                f"{self.base_url}/{name}.sha256", sidecar,
                timeout=self.timeout, headers=headers))
        else:
            def _put_sidecar() -> None:
                with self._request(
                        "PUT", name + ".sha256",
                        data=f"{digest}  {name}\n".encode()) as resp:
                    resp.read()
            self._retry(_put_sidecar)
        if got is None:
            _log.warning("mirror %s does not serve GET: upload of %s "
                         "is unverified", self.base_url, name)
        self._maybe_inject_corruption(name)
        return True

    def fetch(self, name: str, dest_dir: str) -> Optional[str]:
        name = _safe_name(name)
        raw = self._get_bytes(name + ".sha256")
        if raw is None:
            return None
        try:
            digest = raw.decode().split()[0]
        except (UnicodeDecodeError, IndexError):
            return None
        os.makedirs(dest_dir, exist_ok=True)
        dst = os.path.join(dest_dir, name)
        tmp = _tmp_name(dst)
        got = self._get_to_file(name, tmp)
        if got != digest:
            _log.warning("mirror copy of %s is corrupt (digest "
                         "mismatch) — not restoring it", name)
            try:
                os.remove(tmp)
            except OSError:
                pass
            return None
        os.replace(tmp, dst)
        side_tmp = _tmp_name(dst + ".sha256")
        with open(side_tmp, "w") as f:
            f.write(f"{digest}  {name}\n")
        os.replace(side_tmp, dst + ".sha256")
        return dst

    def delete(self, name: str) -> None:
        for victim in (_safe_name(name), _safe_name(name) + ".sha256"):
            try:
                with self._request("DELETE", victim) as resp:
                    resp.read()
            except (urllib.error.URLError, OSError, ValueError):
                pass

    def put_meta(self, name: str, record: Dict[str, object]) -> bool:
        try:
            with self._request("PUT", _safe_name(name),
                               data=json.dumps(record).encode()) as resp:
                resp.read()
                return resp.status == 200
        except (urllib.error.URLError, OSError, ValueError):
            return False

    def get_meta(self, name: str) -> Optional[Dict[str, object]]:
        raw = self._get_bytes(_safe_name(name))
        if raw is None:
            return None
        try:
            data = json.loads(raw)
        except (ValueError, UnicodeDecodeError):
            return None
        return data if isinstance(data, dict) else None

    def meta_names(self, prefix: str = "") -> List[str]:
        raw = self._get_bytes("?metas=1")
        if raw is None:
            return []
        try:
            names = json.loads(raw)
        except (ValueError, UnicodeDecodeError):
            return []
        if not isinstance(names, list):
            return []
        out = []
        for n in names:
            try:
                n = _safe_name(str(n))
            except ValueError:
                continue        # a hostile listing cannot smuggle paths
            if n.startswith(prefix):
                out.append(n)
        return sorted(out)

    def _corrupt(self, name: str) -> None:
        """Re-PUT a torn copy over the mirrored file (the server keeps
        whatever bytes the last PUT sent — exactly how real bit rot
        looks to a digest check). Local file and sidecar stay intact."""
        import tempfile

        from veles_tpu_torch.http_util import http_put_file
        from veles_tpu_torch.resilience.faults import corrupt_file
        fd, tmp = tempfile.mkstemp(prefix="mirror_corrupt_")
        os.close(fd)
        try:
            if self._get_to_file(name, tmp) is None:
                return
            corrupt_file(tmp)
            headers = {"X-Veles-Token": self.token} if self.token \
                else None
            http_put_file(f"{self.base_url}/{name}", tmp,
                          timeout=self.timeout, headers=headers)
        finally:
            try:
                os.remove(tmp)
            except OSError:
                pass


def get_mirror(spec: str, token: Optional[str] = None) -> Mirror:
    """`http(s)://...` -> HttpMirror; anything else -> DirMirror."""
    if spec.startswith(("http://", "https://")):
        return HttpMirror(spec, token=token)
    return DirMirror(spec)


def restore_missing(mirror: "Mirror | str", directory: str,
                    prefix: str = "") -> List[str]:
    """Fetch every verified mirror entry matching `prefix` that the
    local `directory` is missing (or holds corrupt) — the re-placed
    host's rejoin path. Returns the restored local paths, newest
    first."""
    if isinstance(mirror, str):
        mirror = get_mirror(mirror)
    restored: List[str] = []
    entries = sorted(mirror.entries(),
                     key=lambda e: float(e["mtime"]), reverse=True)
    for e in entries:
        name = str(e["name"])
        if prefix and not name.startswith(prefix):
            continue
        local = os.path.join(directory, name)
        if os.path.exists(local) \
                and _read_sidecar(local) == e["digest"] \
                and _sha256_file(local) == e["digest"]:
            continue        # local copy already valid
        got = mirror.fetch(name, directory)
        if got is not None:
            # preserve the mirror's ordering hint: latest() sorts by
            # mtime, and a fetched batch would otherwise all carry "now"
            try:
                os.utime(got, (float(e["mtime"]), float(e["mtime"])))
            except OSError:
                pass
            _log.warning("restored %s from mirror %s", name,
                         mirror.spec)
            restored.append(got)
    return restored


# -- loopback-testable HTTP mirror store --------------------------------------

class MirrorServer:
    """Tiny blob store speaking the HttpMirror protocol: PUT/GET/DELETE
    `/{name}` plus `GET /?index=1` (snapshot listing) and
    `GET /?metas=1` (meta-record listing). Hardened like the other control
    planes (task_queue/web_status): optional shared token via
    `X-Veles-Token` (constant-time compare), bounded bodies (413),
    sanitized flat names (400). Runs on a thread; `port=0` auto-picks —
    the loopback chaos/CI store, and a real single-box durable store
    when pointed at a separate volume."""

    def __init__(self, root: str, host: str = "127.0.0.1",
                 port: int = 0, token: Optional[str] = None,
                 max_body: int = MAX_SNAPSHOT_BODY) -> None:
        self.root = root
        self.host = host
        self.port = port
        self.token = token
        self.max_body = max_body
        self._httpd = None
        self._thread = None

    @property
    def url(self) -> str:
        return f"http://{self.host}:{self.port}"

    def start(self) -> "MirrorServer":
        import threading
        from http.server import (BaseHTTPRequestHandler,
                                 ThreadingHTTPServer)

        from veles_tpu_torch.http_util import check_shared_token
        os.makedirs(self.root, exist_ok=True)
        outer = self
        token = self.token

        class Handler(BaseHTTPRequestHandler):
            def _name(self):
                name = self.path.lstrip("/").split("?")[0]
                try:
                    return _safe_name(name) if name else None
                except ValueError:
                    return None

            def _deny(self, code: int) -> None:
                self.send_response(code)
                self.end_headers()

            def do_PUT(self):  # noqa: N802 (http.server API)
                if not check_shared_token(self, token):
                    return
                name = self._name()
                if name is None:
                    return self._deny(400)
                try:
                    length = int(self.headers.get("Content-Length", "0"))
                except ValueError:
                    return self._deny(400)
                if length > outer.max_body:
                    return self._deny(413)
                dst = os.path.join(outer.root, name)
                tmp = _tmp_name(dst)
                remaining = length
                with open(tmp, "wb") as f:
                    while remaining > 0:
                        block = self.rfile.read(min(1 << 20, remaining))
                        if not block:
                            break
                        f.write(block)
                        remaining -= len(block)
                if remaining:
                    os.remove(tmp)      # short body: do not publish
                    return self._deny(400)
                os.replace(tmp, dst)
                self._deny(200)

            def do_GET(self):  # noqa: N802
                if not check_shared_token(self, token):
                    return
                if "metas=1" in self.path:
                    # meta-record listing (the serving-fleet beacon
                    # discovery path): every non-snapshot file, the
                    # same rule DirMirror.meta_names applies locally
                    out = sorted(
                        n for n in os.listdir(outer.root)
                        if ".pickle" not in n
                        and not n.endswith((".sha256", ".tmp")))
                    body = json.dumps(out).encode()
                    self.send_response(200)
                    self.send_header("Content-Type", "application/json")
                    self.send_header("Content-Length", str(len(body)))
                    self.end_headers()
                    self.wfile.write(body)
                    return
                if "index=1" in self.path:
                    out = []
                    for n in sorted(os.listdir(outer.root)):
                        if n.endswith((".sha256", ".tmp")):
                            continue
                        digest = _read_sidecar(
                            os.path.join(outer.root, n))
                        if digest is None:
                            continue
                        out.append({
                            "name": n, "digest": digest,
                            "mtime": os.path.getmtime(
                                os.path.join(outer.root, n))})
                    body = json.dumps(out).encode()
                    self.send_response(200)
                    self.send_header("Content-Type", "application/json")
                    self.send_header("Content-Length", str(len(body)))
                    self.end_headers()
                    self.wfile.write(body)
                    return
                name = self._name()
                if name is None:
                    return self._deny(400)
                src = os.path.join(outer.root, name)
                if not os.path.isfile(src):
                    return self._deny(404)
                self.send_response(200)
                self.send_header("Content-Type",
                                 "application/octet-stream")
                self.send_header("Content-Length",
                                 str(os.path.getsize(src)))
                self.end_headers()
                with open(src, "rb") as f:
                    shutil.copyfileobj(f, self.wfile)

            def do_DELETE(self):  # noqa: N802
                if not check_shared_token(self, token):
                    return
                name = self._name()
                if name is None:
                    return self._deny(400)
                try:
                    os.remove(os.path.join(outer.root, name))
                except OSError:
                    return self._deny(404)
                self._deny(200)

            def log_message(self, *args):
                pass

        self._httpd = ThreadingHTTPServer((self.host, self.port),
                                          Handler)
        self.port = self._httpd.server_address[1]
        self._thread = threading.Thread(
            target=lambda: self._httpd.serve_forever(poll_interval=0.05),
            daemon=True, name="mirror-server")
        self._thread.start()
        return self

    def stop(self) -> None:
        if self._httpd is not None:
            self._httpd.shutdown()
            self._httpd.server_close()
            self._httpd = None


def _main(argv=None) -> int:
    """`python -m veles_tpu_torch.resilience.mirror --root DIR [--host H]
    [--port P]` — run the blob store standalone (token from
    VELES_WEB_TOKEN)."""
    import argparse
    import signal
    import threading as _threading
    ap = argparse.ArgumentParser(
        description="veles snapshot mirror store (PUT/GET/DELETE "
                    "/{name}, GET /?index=1)")
    ap.add_argument("--root", required=True,
                    help="directory holding the mirrored blobs")
    ap.add_argument("--host", default="0.0.0.0")
    ap.add_argument("--port", type=int, default=8080)
    args = ap.parse_args(argv)
    token = os.environ.get("VELES_WEB_TOKEN") or None
    if not token and args.host not in ("127.0.0.1", "localhost", "::1"):
        ap.error("a non-loopback mirror store needs a shared secret: "
                 "set VELES_WEB_TOKEN (mirrored snapshots are pickles "
                 "— see the trust model in this module's docstring)")
    srv = MirrorServer(args.root, host=args.host, port=args.port,
                       token=token).start()
    print(f"mirror store on {srv.url} (root {args.root})", flush=True)
    done = _threading.Event()
    for sig in (signal.SIGTERM, signal.SIGINT):
        signal.signal(sig, lambda *_: done.set())
    done.wait()
    srv.stop()
    return 0


if __name__ == "__main__":          # pragma: no cover — thin wrapper
    raise SystemExit(_main())
