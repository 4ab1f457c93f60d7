"""The port's data lake (``repro_torch.core``) against the reference's
(``repro.core``): the same operations write the same files, each package
reads and continues the other's lake on one root, an upload session that is
never committed leaves no version in either, and the port's provenance
graph (plain dicts) answers every query as the reference's networkx graph
does, in the same order."""
import dataclasses
import json
import tempfile
import time
from pathlib import Path

import pytest

torch = pytest.importorskip("torch")

from hypothesis import HealthCheck, example, given, settings  # noqa: E402
from hypothesis import strategies as st  # noqa: E402

from repro.core import acai as ref_acai  # noqa: E402
from repro.core.datalake import fileset as ref_fileset  # noqa: E402
from repro.core.datalake import metadata as ref_metadata  # noqa: E402
from repro.core.datalake import provenance as ref_provenance  # noqa: E402
from repro.core.datalake import storage as ref_storage  # noqa: E402
from repro.data import pipeline as ref_pipeline  # noqa: E402
from repro_torch.core import acai as port_acai  # noqa: E402
from repro_torch.core.datalake import fileset as port_fileset  # noqa: E402
from repro_torch.core.datalake import metadata as port_metadata  # noqa: E402
from repro_torch.core.datalake import provenance as port_provenance  # noqa: E402
from repro_torch.core.datalake import storage as port_storage  # noqa: E402
from repro_torch.data import pipeline as port_pipeline  # noqa: E402

PACKAGES = {
    "repro": dict(acai=ref_acai, storage=ref_storage, fileset=ref_fileset,
                  metadata=ref_metadata, provenance=ref_provenance,
                  pipeline=ref_pipeline),
    "repro_torch": dict(acai=port_acai, storage=port_storage,
                        fileset=port_fileset, metadata=port_metadata,
                        provenance=port_provenance, pipeline=port_pipeline),
}
OTHER = {"repro": "repro_torch", "repro_torch": "repro"}


def _write_lake(pkg, root):
    """Files, versions, sessions (committed, aborted and one left pending),
    filesets (merge, update, subset), metadata, tags and provenance edges
    through one package's ``AcaiProject``."""
    m = PACKAGES[pkg]
    proj = m["acai"].AcaiProject("p", root)
    s = proj.storage
    proj.upload("/data/train.json", b"t1", creator="ann")
    proj.upload("/data/train.json", b"t2", creator="ann")
    proj.upload("/data/dev.json", b"d1")
    proj.upload("/validation/val.json", b"v1")
    sid = s.begin_session(["/batch/a", "/batch/b"], creator="bob")
    s.session_put(sid, "/batch/a", b"A" * 1000)
    s.session_put(sid, "/batch/b", memoryview(b"B" * 10))
    s.commit_session(sid)
    aborted = s.begin_session(["/gone"])
    s.session_put(aborted, "/gone", b"x")
    s.abort_session(aborted)
    pending = s.begin_session(["/later"])
    s.session_put(pending, "/later", b"not yet")
    proj.create_file_set("Hot", ["/data/train.json@1",
                                 "/validation/val.json"], creator="ann")
    proj.create_file_set("Cold", ["/data/dev.json"])
    proj.filesets.merge("Merged", ["Hot", "Cold"])
    proj.filesets.update("Hot", ["/data/train.json"])
    proj.filesets.subset("Val", "Hot:1", "/validation/")
    proj.metadata.register("job-1", kind="job", creator="ann", model="BERT",
                           precision=0.7)
    proj.metadata.register("job-2", kind="job", creator="bob", model="GPT",
                           precision=0.4)
    proj.metadata.put("job-1", training_loss=0.25)
    proj.metadata.tag("job-1", "best")
    proj.provenance.add_job_edge(src="Hot:2", dst="model:1", job_id="job-1",
                                 creator="ann")
    proj.provenance.add_job_edge(src=None, dst="orphan:1", job_id="job-0")
    proj.provenance.add_dependency_edge(src_job="job-1", dst_job="job-2",
                                        pipeline="pipe",
                                        src_fileset="model:1")
    return proj, pending


def _lake_files(root: Path) -> dict:
    return {str(p.relative_to(root)): p.read_bytes()
            for p in sorted(root.rglob("*")) if p.is_file()}


def _view(proj, pending):
    """Everything a reader sees of a lake, as plain data."""
    s, fs = proj.storage, proj.filesets
    files = {p: [dataclasses.asdict(s.resolve(p, v)) for v in s.versions(p)]
             for p in s.list_files()}
    meta = proj.metadata
    prov = proj.provenance
    return {
        "files": files,
        "payloads": {p: s.download(f"{p}@{v}") for p in files
                     for v in s.versions(p)},
        "sessions": [s.session_state(f"session-{i}") for i in range(1, 8)],
        "pending": s.session_state(pending),
        "sets": {n: [dataclasses.asdict(fs.resolve(f"{n}:{v.version}"))
                     for v in fs._sets[n]] for n in fs.list_sets()},
        "docs": {aid: meta.get(aid) for aid in meta.find()},
        "queries": [meta.find(creator="ann", precision=(">", 0.5)),
                    meta.find(tags=["best"]), meta.find_max("precision"),
                    meta.find_min("precision", kind="job"),
                    meta.find(precision=("range", 0.3, 0.8))],
        "graph": prov.whole_graph(),
        "backward": prov.backward("Val:1"),
        "lineage": prov.lineage_jobs("model:1"),
        "replay": prov.replay_order("model:1"),
        "deps": prov.dependency_edges("pipe"),
    }


def test_same_operations_write_the_same_files(tmp_path, monkeypatch):
    """With the clock held still, both packages write byte-identical lakes:
    catalog, blobs, filesets, metadata and provenance."""
    monkeypatch.setattr(time, "time", lambda: 1.7e9)
    for pkg in PACKAGES:
        _write_lake(pkg, tmp_path / pkg)
    want = _lake_files(tmp_path / "repro")
    got = _lake_files(tmp_path / "repro_torch")
    assert list(got) == list(want)
    for name in want:
        assert got[name] == want[name], name


@pytest.mark.parametrize("writer", sorted(PACKAGES))
def test_lake_reads_and_continues_across_packages(tmp_path, writer):
    """One package writes a lake; the other opens it and sees the same
    files, versions, sessions, filesets, metadata and provenance, then
    commits the pending session and adds versions, which the writer's
    package reads back."""
    reader = OTHER[writer]
    proj, pending = _write_lake(writer, tmp_path)
    want = _view(proj, pending)
    other = PACKAGES[reader]["acai"].AcaiProject("p", tmp_path)
    assert _view(other, pending) == want

    fvs = other.storage.commit_session(pending)
    assert [(f.path, f.version) for f in fvs] == [("/later", 1)]
    other.upload("/data/train.json", b"t3")
    other.filesets.update("Hot", ["/data/train.json"])
    out = other.filesets.materialize("Hot", tmp_path / "job")
    assert sorted(Path(p).read_bytes() for p in out) == [b"t3", b"v1"]

    again = PACKAGES[writer]["acai"].AcaiProject("p", tmp_path)
    assert _view(again, pending) == _view(other, pending)
    assert again.storage.download("/later") == b"not yet"
    assert again.filesets.resolve("Hot").files == {
        "/data/train.json": 3, "/validation/val.json": 1}
    assert again.provenance.backward("Hot:3") == [
        ("Hot:2", {"action": "fileset_creation", "creator": ""})]


@pytest.mark.parametrize("reader", sorted(PACKAGES))
@pytest.mark.parametrize("writer", sorted(PACKAGES))
def test_uncommitted_session_leaves_no_version(tmp_path, writer, reader):
    """A session whose files are all put but which is never committed
    (a crashed save) occupies no version number in either package."""
    w = PACKAGES[writer]["storage"].Storage(tmp_path)
    w.upload("/ckpt/state.npz", b"v1")
    sid = w.begin_session(["/ckpt/state.npz", "/ckpt/new"])
    w.session_put(sid, "/ckpt/state.npz", b"v2")
    w.session_put(sid, "/ckpt/new", b"n")
    r = PACKAGES[reader]["storage"].Storage(tmp_path)
    assert r.session_state(sid) == "pending"
    assert r.versions("/ckpt/state.npz") == [1]
    assert r.download("/ckpt/state.npz") == b"v1"
    assert not r.exists("/ckpt/new")
    assert r.list_files() == ["/ckpt/state.npz"]
    with pytest.raises(PACKAGES[reader]["storage"].DataLakeError):
        r.resolve("/ckpt/state.npz", 2)


def test_port_blob_takes_a_memoryview(tmp_path):
    """``session_put`` of a memoryview of a large buffer stores the bytes
    and size that ``bytes`` would."""
    data = bytes(range(256)) * 4096
    s = port_storage.Storage(tmp_path)
    a = s.upload("/a", data)
    sid = s.begin_session(["/b"])
    buf = bytearray(data)
    with memoryview(buf) as view:
        s.session_put(sid, "/b", view)
    b = s.commit_session(sid)[0]
    assert (a.blob, a.size) == (b.blob, b.size) == (a.blob, len(data))
    assert s.download("/b") == data


def test_pipeline_registers_in_either_project_alike(tmp_path, monkeypatch):
    """The port's ``TokenPipeline.register`` against the port's
    ``AcaiProject`` writes what the reference's pair writes."""
    monkeypatch.setattr(time, "time", lambda: 1.7e9)
    refs = {}
    for pkg, m in PACKAGES.items():
        pipe = m["pipeline"].TokenPipeline(m["pipeline"].DataConfig(seed=3))
        refs[pkg] = pipe.register(m["acai"].AcaiProject("p", tmp_path / pkg),
                                  "olmo-1b-data", creator="trainer")
    assert refs["repro_torch"] == refs["repro"] == "olmo-1b-data:1"
    assert _lake_files(tmp_path / "repro_torch") == \
        _lake_files(tmp_path / "repro")


# -- the reference's data-lake behaviour, in both packages ------------------


@pytest.fixture(params=sorted(PACKAGES))
def lake(request, tmp_path):
    m = PACKAGES[request.param]
    storage = m["storage"].Storage(tmp_path)
    prov = m["provenance"].ProvenanceGraph(tmp_path)
    return (storage, m["fileset"].FileSetManager(storage, prov), prov,
            m["metadata"].MetadataStore(tmp_path), m)


def test_versioning_and_transactional_sessions(lake):
    storage, *_, m = lake
    for i in range(3):
        assert storage.upload("/d", f"v{i}".encode()).version == i + 1
    assert storage.download("/d@1") == b"v0" and storage.download("/d") == b"v2"
    sid = storage.begin_session(["/x", "/y"])
    storage.session_put(sid, "/x", b"1")
    with pytest.raises(m["storage"].DataLakeError):
        storage.commit_session(sid)
    assert storage.versions("/x") == []
    storage.session_put(sid, "/y", b"2")
    assert [f.version for f in storage.commit_session(sid)] == [1, 1]
    with pytest.raises(m["storage"].DataLakeError):
        storage.session_put(sid, "/x", b"late")
    with pytest.raises(m["storage"].DataLakeError):
        storage.session_put(storage.begin_session(["/z"]), "/w", b"undeclared")


def test_fileset_specs(lake):
    storage, fs, prov, _, m = lake
    storage.upload("/data/train.json", b"t1")
    storage.upload("/validation/val.json", b"v1")
    fs.create("S", ["/data/train.json", "/validation/val.json"])
    storage.upload("/data/train.json", b"t2")
    assert fs._expand_spec("/data/train.json@S:1")[0] == {
        "/data/train.json": 1}
    assert fs.create("T", ["/data/train.json@1",
                           "/data/train.json@2"]).files == {
        "/data/train.json": 2}
    assert set(fs.subset("V", "S:1", "/validation/").files) == {
        "/validation/val.json"}
    with pytest.raises(m["storage"].DataLakeError):
        fs.subset("W", "S:1", "/nothing/")
    assert prov.backward("V:1") == [
        ("S:1", {"action": "fileset_creation", "creator": ""})]


def test_provenance_traversal(lake):
    _, _, prov, _, _ = lake
    prov.add_fileset("raw:1")
    prov.add_job_edge(src="raw:1", dst="features:1", job_id="job-etl")
    prov.add_job_edge(src="features:1", dst="model:1", job_id="job-train")
    assert prov.forward("raw:1")[0][0] == "features:1"
    assert prov.ancestors("model:1") == ["features:1", "raw:1"]
    assert prov.descendants("raw:1") == ["features:1", "model:1"]
    assert prov.lineage_jobs("model:1") == ["job-etl", "job-train"]
    assert prov.replay_order("model:1") == ["raw:1", "features:1", "model:1"]
    assert prov.is_dag()
    prov.add_creation_edge(src="model:1", dst="raw:1")
    assert not prov.is_dag()


# -- provenance: the port's dicts against networkx ---------------------------

NAMES = [f"fs{i}:1" for i in range(9)]
_edge = st.tuples(st.sampled_from(["job", "creation", "dep", "node"]),
                  st.integers(0, len(NAMES) - 1),
                  st.integers(0, len(NAMES) - 1),
                  st.integers(0, 3))
# fs0 feeds every other node, so a query on fs1 walks an ancestor set of 2
# through a node of 8 successors (networkx then iterates its filter's set)
HUB = [("job", 0, j, j % 4) for j in range(1, 9)] + [("dep", 1, 2, 0),
                                                       ("job", 1, 2, 1)]


def _apply(prov, ops, dag):
    for kind, a, b, x in ops:
        if dag and a >= b and kind != "node":
            a, b = min(a, b), max(a, b) + (a == b)
            if b >= len(NAMES):
                continue
        u, v = NAMES[a], NAMES[b]
        if kind == "job":
            prov.add_job_edge(src=None if x == 3 else u, dst=v,
                              job_id=f"job-{x}", creator=f"c{x % 2}")
        elif kind == "creation":
            prov.add_creation_edge(src=u, dst=v, creator=f"c{x}")
        elif kind == "dep":
            prov.add_dependency_edge(src_job=u, dst_job=v,
                                     pipeline=f"p{x % 2}",
                                     src_fileset=None if x else u)
        else:
            prov.add_fileset(u)


def _answers(prov):
    out = {"graph": prov.whole_graph(), "is_dag": prov.is_dag(),
           "deps": [prov.dependency_edges(p) for p in (None, "p0", "p1")]}
    for n in NAMES:
        out[n] = (prov.forward(n), prov.backward(n))
        if n not in out["graph"]["nodes"]:
            continue
        out[n] += (prov.ancestors(n), prov.descendants(n),
                   prov.lineage_jobs(n))
        try:
            out[n] += (prov.replay_order(n),)
        except Exception as exc:    # noqa: BLE001 (a cycle: both must raise)
            out[n] += ("cycle" if "cycle" in str(exc) else repr(exc),)
    return json.loads(json.dumps(out))


@settings(max_examples=120, deadline=None, derandomize=True, database=None,
          suppress_health_check=[HealthCheck.too_slow])
@given(ops=st.lists(_edge, min_size=1, max_size=30), dag=st.booleans())
@example(ops=HUB, dag=True)
@example(ops=HUB + [("creation", 2, 0, 0)], dag=False)
def test_provenance_queries_match_networkx(ops, dag):
    """Random insertions (parallel edges, job edges without a source,
    dependency edges; acyclic or not): every query of the port equals the
    reference's, order included, both write the same ``provenance.json``,
    and each package answers the same from the other's file."""
    with tempfile.TemporaryDirectory() as tmp:
        ref = ref_provenance.ProvenanceGraph(Path(tmp) / "ref")
        (Path(tmp) / "ref").mkdir()
        (Path(tmp) / "port").mkdir()
        port = port_provenance.ProvenanceGraph(Path(tmp) / "port")
        _apply(ref, ops, dag)
        _apply(port, ops, dag)
        want = _answers(ref)
        assert _answers(port) == want
        assert (Path(tmp) / "port/provenance.json").read_bytes() == \
            (Path(tmp) / "ref/provenance.json").read_bytes()
        # a reloaded graph lists each node's in-edges by source, so the
        # reloads are held against the reference's own reload
        reloaded = _answers(ref_provenance.ProvenanceGraph(Path(tmp) / "ref"))
        for pkg, where in (("port", "ref"), ("ref", "port"), ("port", "port")):
            graph = (port_provenance if pkg == "port" else ref_provenance) \
                .ProvenanceGraph(Path(tmp) / where)
            assert _answers(graph) == reloaded, (pkg, where)


def test_provenance_unknown_node_raises_in_both(tmp_path):
    for pkg, m in PACKAGES.items():
        prov = m["provenance"].ProvenanceGraph(tmp_path)
        prov.add_fileset("a:1")
        assert prov.forward("zz:1") == [] and prov.backward("zz:1") == []
        for query in (prov.ancestors, prov.descendants, prov.lineage_jobs,
                      prov.replay_order):
            with pytest.raises(Exception, match="zz:1"):
                query("zz:1")
