"""The port's snapshot mirror against the JAX package's, on the CPU.

The on-disk format (flat files, `.sha256` sidecars, JSON meta records)
and the HTTP protocol (PUT/GET/DELETE `/{name}`, `GET /?index=1`,
`GET /?metas=1`) are the JAX package's: a file pushed by either
package's DirMirror is listed and fetched by the other's, and either
package's HttpMirror talks to the other's MirrorServer. A torn or
corrupt mirrored copy gives None; `restore_missing` and
`Snapshotter.latest(mirror=...)` re-populate a lost snapshot directory;
the Snapshotter pushes each export (and prunes the mirror with
`keep_last`); the trainer's `--mirror` reaches it; `mirror_corrupt@push=K`
tears the K-th mirrored copy.
"""

import os
import socket
import urllib.error
import urllib.request

import pytest

from veles_tpu.resilience import mirror as jmirror
from veles_tpu_torch import launcher
from veles_tpu_torch.resilience import faults
from veles_tpu_torch.resilience import mirror as pmirror
from veles_tpu_torch.snapshotter import Snapshotter

PACKAGES = {"jax": jmirror, "port": pmirror}


def _snapshot_file(d, name="wf_0.5.pickle.gz", payload=b"snapshot bytes"):
    """A snapshot-named file and its sidecar, as an export leaves them."""
    os.makedirs(d, exist_ok=True)
    path = os.path.join(d, name)
    with open(path, "wb") as f:
        f.write(payload * 64)
    with open(path + ".sha256", "w") as f:
        f.write(f"{pmirror._sha256_file(path)}  {name}\n")
    return path


@pytest.mark.parametrize("writer,reader", [("jax", "port"),
                                           ("port", "jax")])
def test_dir_mirror_reads_the_other_package(tmp_path, writer, reader):
    src = _snapshot_file(str(tmp_path / "local"))
    root = str(tmp_path / "mirror")
    w, r = PACKAGES[writer].DirMirror(root), PACKAGES[reader].DirMirror(root)
    assert w.push(src)
    assert w.put_meta("beacon-r0", {"url": "http://x", "n": 1})
    entries = r.entries()
    assert [e["name"] for e in entries] == [os.path.basename(src)]
    assert entries[0]["digest"] == pmirror._read_sidecar(src)
    assert r.has(os.path.basename(src), entries[0]["digest"])
    got = r.fetch(os.path.basename(src), str(tmp_path / "restored"))
    assert open(got, "rb").read() == open(src, "rb").read()
    assert r.get_meta("beacon-r0") == {"url": "http://x", "n": 1}
    assert r.meta_names("beacon") == ["beacon-r0"]
    # idempotent: the reader's push of the same file is a no-op
    assert r.push(src)
    assert sorted(os.listdir(root)) == sorted(
        [os.path.basename(src), os.path.basename(src) + ".sha256",
         "beacon-r0"])


@pytest.mark.parametrize("server,client", [("port", "port"),
                                           ("port", "jax"),
                                           ("jax", "port")])
def test_http_mirror_against_mirror_server(tmp_path, server, client):
    srv = PACKAGES[server].MirrorServer(str(tmp_path / "store"),
                                        token="tok").start()
    try:
        src = _snapshot_file(str(tmp_path / "local"))
        name = os.path.basename(src)
        m = PACKAGES[client].HttpMirror(srv.url, token="tok", retries=1)
        assert m.push(src)
        [e] = m.entries()
        assert (e["name"], e["digest"]) == (name,
                                            pmirror._read_sidecar(src))
        got = m.fetch(name, str(tmp_path / "restored"))
        assert open(got, "rb").read() == open(src, "rb").read()
        assert m.put_meta("meta-a", {"k": 2}) and m.get_meta("meta-a") \
            == {"k": 2}
        assert m.meta_names() == ["meta-a"]
        m.delete(name)
        assert m.entries() == []
        # the token guards every verb
        bad = PACKAGES[client].HttpMirror(srv.url, token="wrong",
                                          retries=1)
        assert bad.entries() == []
        with pytest.raises(urllib.error.HTTPError) as e:
            urllib.request.urlopen(srv.url + "/?index=1", timeout=10)
        assert e.value.code == 403
    finally:
        srv.stop()


def test_torn_or_corrupt_copies_give_none(tmp_path):
    src = _snapshot_file(str(tmp_path / "local"))
    name = os.path.basename(src)
    d = pmirror.DirMirror(str(tmp_path / "mirror"))
    d.push(src)
    d._corrupt(name)
    assert d.fetch(name, str(tmp_path / "out")) is None
    srv = pmirror.MirrorServer(str(tmp_path / "store")).start()
    try:
        h = pmirror.HttpMirror(srv.url, retries=1)
        h.push(src)
        h._corrupt(name)
        assert h.fetch(name, str(tmp_path / "out2")) is None
        # a truncated upload (a body short of its length) is never
        # published
        with socket.create_connection(("127.0.0.1", srv.port),
                                      timeout=30) as sock:
            sock.sendall(b"PUT /torn.pickle HTTP/1.1\r\nHost: t\r\n"
                         b"Content-Length: 10\r\n\r\nab")
            sock.shutdown(socket.SHUT_WR)
            assert sock.makefile("rb").readline().split()[1] == b"400"
        assert not os.path.exists(str(tmp_path / "store" / "torn.pickle"))
    finally:
        srv.stop()
    with pytest.raises(ValueError):
        pmirror.DirMirror(str(tmp_path)).fetch("../x", str(tmp_path))


def test_restore_missing_and_latest_from_the_mirror(tmp_path):
    local = str(tmp_path / "snaps")
    old = _snapshot_file(local, "wf_0.7.pickle.gz", b"old")
    new = _snapshot_file(local, "wf_0.5.pickle.gz", b"new")
    os.utime(old, (1000, 1000))
    os.utime(new, (2000, 2000))
    spec = str(tmp_path / "mirror")
    m = pmirror.get_mirror(spec)
    assert isinstance(m, pmirror.DirMirror)
    assert isinstance(pmirror.get_mirror("http://127.0.0.1:1"),
                      pmirror.HttpMirror)
    for p in (old, new):
        m.push(p)
    os.utime(os.path.join(spec, "wf_0.7.pickle.gz"), (1000, 1000))
    os.utime(os.path.join(spec, "wf_0.5.pickle.gz"), (2000, 2000))
    # the local directory is lost
    for n in os.listdir(local):
        os.remove(os.path.join(local, n))
    assert Snapshotter.latest(local, prefix="wf") is None
    got = Snapshotter.latest(local, prefix="wf", mirror=spec)
    assert got == new and Snapshotter.verify(got)
    assert os.path.getmtime(got) == 2000
    # a local copy that verifies is kept; a corrupt one is replaced
    with open(old, "r+b") as f:
        f.write(b"XX")
    assert pmirror.restore_missing(spec, local, "wf") == [old]
    assert pmirror.restore_missing(m, local, "wf") == []


def test_snapshotter_pushes_each_export_and_prunes(tmp_path):
    spec = str(tmp_path / "mirror")
    snap = Snapshotter(workflow={"state": 1}, prefix="p",
                       directory=str(tmp_path / "local"), keep_last=1,
                       mirror=spec)
    snap.initialize()
    for tag in ("0.9", "0.8"):
        snap.suffix = tag
        snap.run()
    names = sorted(e["name"] for e in pmirror.DirMirror(spec).entries())
    assert names == ["p_0.8.pickle.gz"]
    assert sorted(os.listdir(str(tmp_path / "local"))) \
        == ["p_0.8.pickle.gz", "p_0.8.pickle.gz.sha256"]
    # a failing mirror only warns: the local export stands
    snap.mirror = str(tmp_path / "local" / "p_0.8.pickle.gz")
    snap.suffix = "0.7"
    snap.run()
    assert os.path.exists(str(tmp_path / "local" / "p_0.7.pickle.gz"))


def test_mirror_corrupt_fault_tears_the_kth_push(tmp_path):
    faults.install_plan(faults.FaultPlan.parse("mirror_corrupt@push=2"))
    try:
        m = pmirror.DirMirror(str(tmp_path / "mirror"))
        a = _snapshot_file(str(tmp_path / "l"), "a.pickle", b"a")
        b = _snapshot_file(str(tmp_path / "l"), "b.pickle", b"b")
        assert m.push(a) and m.push(b)
        assert m.fetch("a.pickle", str(tmp_path / "o")) is not None
        assert m.fetch("b.pickle", str(tmp_path / "o")) is None
    finally:
        faults.install_plan(None)
        faults.reset()


WORKFLOW_SRC = '''
from veles_tpu_torch.config import root
from veles_tpu_torch.loader.synthetic import SyntheticClassifierLoader
from veles_tpu_torch.znicz.standard_workflow import StandardWorkflow

root.mirwf.snapshot_dir = "."

def create_workflow():
    loader = SyntheticClassifierLoader(
        n_classes=4, sample_shape=(10,), n_validation=40, n_train=80,
        minibatch_size=40, noise=0.4)
    return StandardWorkflow(
        layers=[{"type": "all2all_tanh", "output_sample_shape": 16},
                {"type": "softmax", "output_sample_shape": 4}],
        loader=loader, loss="softmax", n_classes=4,
        decision_config={"max_epochs": 2, "fail_iterations": 100000},
        gd_config={"learning_rate": 0.05, "gradient_moment": 0.9},
        snapshot_config={"directory": root.mirwf.snapshot_dir,
                         "prefix": "mirwf"},
        name="MirWF")

def run(load, main):
    load(create_workflow)
    main()
'''


def test_trainer_mirror_flag_pushes_snapshots(tmp_path):
    wf_file = tmp_path / "mirwf.py"
    wf_file.write_text(WORKFLOW_SRC)
    spec = str(tmp_path / "mirror")
    local = str(tmp_path / "snaps")
    wf = launcher.train([str(wf_file), "--fused", "--device", "cpu", "-r",
                         "7", "--mirror", spec,
                         f"root.mirwf.snapshot_dir={local}"])
    assert wf.snapshotter.mirror == spec
    pushed = {e["name"]: e["digest"]
              for e in pmirror.DirMirror(spec).entries()}
    written = sorted(n for n in os.listdir(local)
                     if not n.endswith(".sha256"))
    assert written and sorted(pushed) == written
    for n in written:
        assert pushed[n] == pmirror._read_sidecar(os.path.join(local, n))


def test_supervisor_restores_from_the_mirror(monkeypatch):
    """`--supervise --mirror SPEC`: the supervisor's restarts resolve
    their snapshot with the mirror; the child keeps --mirror and pushes."""
    from veles_tpu_torch.resilience import supervisor
    seen = {}

    class Recorder:
        def __init__(self, cmd, **kw):
            seen.update(kw, cmd=cmd)

        def run(self):
            return 0

    monkeypatch.setattr(supervisor, "Supervisor", Recorder)
    argv = ["wf.py", "--fused", "--supervise", "--mirror", "M"]
    assert launcher.supervise(launcher.parse_args(argv), argv) == 0
    assert seen["mirror"] == "M" and "--mirror" in seen["cmd"]
