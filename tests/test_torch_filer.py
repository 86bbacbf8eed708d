"""The port's filer core (seaweedfs_tpu_torch/filer/, server/filer_server.py,
notification/) against seaweedfs_tpu's, on the CPU.

tests/test_filer.py ported, each case on both packages with the same
inputs:

  * the chunk algebra: every table case of TestIntervalMerging,
    TestChunksReading and TestCompact, and TestChunkAlgebraProperty's
    seeded model check; the two packages' visible intervals, views,
    compacted lists and ETags are equal;
  * the stores: one seeded sequence of insert, update, delete, find and
    list operations (numpy-drawn) into both packages' stores of every
    kind, the outside-service kinds against tests/cloud_fakes.py; the
    answers and the serialized Entry protobufs are equal, and the lsm
    and sortedlog files on disk are byte-identical (they hold no clock
    value). TestLsmStore's persistence, WAL-tear, compaction and
    concurrency cases, TestAbstractSql, TestSqliteTransactions and
    TestTikvStore run on the port;
  * the filer core: TestFilerCore's cases, and one seeded operation
    sequence through both packages' Filers with equal events and equal
    pending chunk deletions;
  * the filer server: a master, a volume server and a FilerServer of
    each package in this process; POST, GET, ranges, auto-chunking, the
    HTML browser, the gRPC surface, chunk GC after delete and /metrics.
    Bodies are byte-identical; listings are equal apart from fids and
    mtimes;
  * the slice end to end: a tree written through each package's filer
    into three volume servers, EC-encoded and balanced through each
    package's shell; on the port one shard holder is then stopped and
    every file read back degraded through the filer (the volume servers
    run the kernels' plain versions, device="cpu"). The bytes equal the
    originals and what the reference's cluster returns;
  * off the card: the filer's modules and commands import no torch.

The tolerance everywhere is exact equality.
"""

import importlib
import io
import json
import os
import re
import socket
import subprocess
import sys
import threading
import time
import types
import urllib.error
import urllib.request

import numpy as np
import pytest

import tests.test_filer as ref_cases
from seaweedfs_tpu_torch.util.availability import free_port

SIDES = ("ref", "port")
PKG = {"ref": "seaweedfs_tpu", "port": "seaweedfs_tpu_torch"}
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def mod(side, name):
    return importlib.import_module(f"{PKG[side]}.{name}")


def fc(side):
    return mod(side, "filer.filechunks")


def _rows(chunks):
    return [(c.offset, c.size, c.fid, c.mtime) for c in chunks]


def _chunks(side, rows):
    return [fc(side).make_chunk(fid, off, size, mtime) for off, size, fid, mtime in rows]


def _both(fn):
    got = {side: fn(side) for side in SIDES}
    assert got["port"] == got["ref"]
    return got["port"]


# --- the chunk algebra ------------------------------------------------------------


@pytest.mark.parametrize("case", range(len(ref_cases.TestIntervalMerging.CASES)))
def test_interval_merging(case):
    chunks, expected = ref_cases.TestIntervalMerging.CASES[case]
    rows = _rows(chunks)
    got = _both(lambda s: [(v.start, v.stop, v.fid, v.mtime, v.is_full_chunk)
                           for v in fc(s).non_overlapping_visible_intervals(_chunks(s, rows))])
    assert [g[:3] for g in got] == expected


@pytest.mark.parametrize("case", range(len(ref_cases.TestChunksReading.CASES)))
def test_chunks_reading(case):
    chunks, offset, size, expected = ref_cases.TestChunksReading.CASES[case]
    rows = _rows(chunks)
    got = _both(lambda s: [(v.offset, v.size, v.fid, v.logic_offset, v.is_full_chunk)
                           for v in fc(s).view_from_chunks(_chunks(s, rows), offset, size)])
    assert [g[:4] for g in got] == expected


def _compact(side, rows):
    compacted, garbage = fc(side).compact_file_chunks(_chunks(side, rows))
    return _rows(compacted), _rows(garbage)


def test_compact_file_chunks():
    rows = [(10, 100, "abc", 50), (100, 100, "def", 100), (200, 100, "ghi", 200),
            (110, 200, "jkl", 300)]
    compacted, garbage = _both(lambda s: _compact(s, rows))
    assert len(compacted) == 3 and len(garbage) == 1


def test_compact_file_chunks2():
    rows = [(0, 100, "abc", 50), (100, 100, "def", 100), (200, 100, "ghi", 200),
            (0, 100, "abcf", 300), (50, 100, "fhfh", 400), (100, 100, "yuyu", 500)]
    for n in range(3):
        rows.append((n * 100, 100, f"fileId{n}", n))
        rows.append((n * 50, 100, f"fileId{n + 3}", n + 3))
    compacted, garbage = _both(lambda s: _compact(s, rows))
    assert len(compacted) == 4 and len(garbage) == 8


def test_minus_chunks():
    got = _both(lambda s: _rows(fc(s).minus_chunks(
        _chunks(s, [(0, 100, "abc", 1), (100, 100, "def", 2)]), _chunks(s, [(0, 100, "abc", 1)]))))
    assert [r[2] for r in got] == ["def"]


def test_total_size_and_etag():
    def run(s):
        chunks = _chunks(s, [(0, 100, "a", 1), (50, 100, "b", 2)])
        only = [fc(s).make_chunk("x", 0, 10, 1, e_tag="deadbeef")]
        tagged = [fc(s).make_chunk(f"f{i}", i * 10, 10, i, e_tag=f"{i:08x}") for i in range(5)]
        return fc(s).total_size(chunks), fc(s).etag(only), fc(s).etag(chunks), fc(s).etag(tagged)
    total, one, combined, five = _both(run)
    assert total == 150 and one == "deadbeef" and combined and five


@pytest.mark.parametrize("seed", range(8))
def test_chunk_algebra_property(seed):
    """TestChunkAlgebraProperty's model check, its chunks drawn with
    numpy: later mtime wins per byte; the intervals and the contiguous
    read views match the simulation on both packages, and the packages'
    views, compactions and ETags are equal."""
    rng = np.random.default_rng(seed)
    file_len = int(rng.integers(50, 401))
    n_chunks = int(rng.integers(1, 13))
    mtimes = [int(m) + 1 for m in rng.choice(9_999, n_chunks, replace=False)]
    rows = []
    for i in range(n_chunks):
        off = int(rng.integers(0, file_len))
        size = int(rng.integers(1, file_len - off + 1))
        rows.append((off, size, f"fid{i}", mtimes[i]))
    owner = [None] * file_len
    for off, size, fid, mtime in rows:
        for p in range(off, min(off + size, file_len)):
            if owner[p] is None or mtime > owner[p][0]:
                owner[p] = (mtime, fid)
    spans = [(int(o), int(rng.integers(1, file_len - o + 1)))
             for o in rng.integers(0, file_len, 10)]

    def run(s):
        chunks = _chunks(s, rows)
        visible = fc(s).non_overlapping_visible_intervals(chunks)
        views = [[(v.fid, v.offset, v.size, v.logic_offset, v.is_full_chunk)
                  for v in fc(s).view_from_chunks(chunks, off, size)] for off, size in spans]
        return ([(v.start, v.stop, v.fid, v.mtime, v.is_full_chunk) for v in visible],
                views, _compact(s, rows), fc(s).etag(chunks))

    visible, views, _, _ = _both(run)
    prev_stop, covered = -1, [None] * file_len
    for start, stop, fid, _, _ in visible:
        assert start >= prev_stop
        prev_stop = stop
        for p in range(start, stop):
            assert owner[p] is not None and owner[p][1] == fid
            covered[p] = fid
    assert covered == [o and o[1] for o in owner]
    for (off, size), got in zip(spans, views):
        seen = {v[3] + j: v[0] for v in got for j in range(v[2])}
        expect, p = {}, off
        while p < off + size and owner[p] is not None:
            expect[p] = owner[p][1]
            p += 1
        assert seen == expect, (off, size)


# --- the stores -------------------------------------------------------------------


def _fake(name, **kw):
    import tests.cloud_fakes as fakes

    f = getattr(fakes, name)(**kw)
    f.start()
    return f


STORE_KINDS = ("memory", "sqlite", "sortedlog", "lsm", "sql", "redis", "cassandra",
               "etcd", "postgres", "mysql", "tikv")


def _open_store(side, kind, tmp, fakes):
    """A store of `kind` for `side`; an outside-service kind gets a fake
    of its own (kept in `fakes` for the caller to stop)."""
    fs = mod(side, "filer.filerstore")
    d = tmp / side
    d.mkdir(exist_ok=True)
    if kind == "memory":
        return fs.MemoryStore()
    if kind == "sqlite":
        return fs.SqliteStore(str(d / "filer.db"))
    if kind == "sortedlog":
        return fs.SortedLogStore(str(d / "filer.log"))
    if kind == "lsm":
        return mod(side, "filer.lsm").LsmStore(str(d / "lsm"), memtable_bytes=2048,
                                               compact_at=3)
    if kind == "sql":
        return mod(side, "filer.abstract_sql").new_sqlite_sql_store(str(d / "filer.sql.db"))
    if kind in ("postgres", "mysql"):
        f = _fake("FakePostgres" if kind == "postgres" else "FakeMysql", password="pw")
        fakes.append(f)
        return fs.new_store(kind, f"{f.address}/seaweedfs?user=seaweedfs&password=pw")
    f = _fake({"redis": "FakeRedis", "cassandra": "FakeCassandra", "etcd": "FakeEtcd",
               "tikv": "FakeTikv"}[kind])
    fakes.append(f)
    return fs.new_store(kind, f.endpoint if kind == "etcd" else f.address)


def _pb(entry):
    return entry.to_pb().SerializeToString(deterministic=True)


def _op_sequence(seed, n):
    """(op, path, mtime, chunk rows) drawn with numpy: inserts, updates,
    deletes, finds, lists and folder-children deletes over 4 dirs."""
    rng = np.random.default_rng(seed)
    dirs = ["/a", "/a/b", "/c", "/"]
    ops = []
    for i in range(n):
        op = ["insert", "insert", "update", "delete", "find", "list", "list_from"][
            int(rng.integers(0, 7))]
        if i == n // 2:
            op = "delete_children"
        d = dirs[int(rng.integers(0, len(dirs)))]
        name = f"f{int(rng.integers(0, 12)):02d}"
        path = f"{d.rstrip('/')}/{name}"
        rows = [(int(o), int(rng.integers(1, 5000)), f"{int(rng.integers(1, 9))},{i:04x}{k}", i * 10 + k)
                for k, o in enumerate(rng.integers(0, 10000, int(rng.integers(0, 4))))]
        ops.append((op, path if op not in ("list", "list_from", "delete_children") else d,
                    name, 1_700_000_000 + i, rows))
    return ops


def _drive(side, store, ops):
    entry_mod = mod(side, "filer.entry")
    fs = mod(side, "filer.filerstore")
    out = []
    for op, path, name, mtime, rows in ops:
        try:
            if op in ("insert", "update"):
                e = entry_mod.Entry(path, attr=entry_mod.Attr(mtime=mtime, crtime=mtime,
                                                              mime="application/x-test",
                                                              file_size=mtime % 7),
                                    chunks=_chunks(side, rows), extended={"k": name.encode()})
                if op == "insert":
                    store.insert_entry(e)
                else:
                    store.find_entry(path)
                    store.update_entry(e)
                out.append((op, path))
            elif op == "delete":
                store.find_entry(path)
                store.delete_entry(path)
                out.append((op, path))
            elif op == "find":
                out.append((op, _pb(store.find_entry(path))))
            elif op == "delete_children":
                store.delete_folder_children(path)
                out.append((op, path))
            else:
                listed = store.list_directory_entries(path, name if op == "list_from" else "",
                                                      op == "list", 5)
                out.append((op, [(e.full_path, _pb(e)) for e in listed]))
        except fs.EntryNotFound:
            out.append((op, "not found"))
    listed = {d: [(e.full_path, _pb(e)) for e in store.list_directory_entries(d, "", True, 1000)]
              for d in ("/a", "/a/b", "/c", "/")}
    return out, listed


def _tree_bytes(root):
    got = {}
    for dirpath, _, files in os.walk(root):
        for f in files:
            p = os.path.join(dirpath, f)
            with open(p, "rb") as fh:
                got[os.path.relpath(p, root)] = fh.read()
    return got


@pytest.mark.parametrize("kind", STORE_KINDS)
def test_store_sequence_equals_the_references(kind, tmp_path):
    ops = _op_sequence(11, 100)
    got, fakes = {}, []
    try:
        for side in SIDES:
            store = _open_store(side, kind, tmp_path, fakes)
            try:
                got[side] = _drive(side, store, ops)
            finally:
                store.close()
    finally:
        for f in fakes:
            f.stop()
    assert got["port"] == got["ref"]
    answers, listed = got["port"]
    assert sum(1 for op, r in answers if op == "find" and r != "not found") >= 3
    assert sum(1 for _, r in answers if r != "not found") > 60
    assert sum(len(v) for v in listed.values()) > 5
    if kind in ("lsm", "sortedlog"):
        files = {side: _tree_bytes(tmp_path / side) for side in SIDES}
        assert files["port"] == files["ref"] and files["port"]
    if kind == "lsm":
        # reopen: the same entries from the files alone
        store = _open_store("port", kind, tmp_path, [])
        again = {d: [(e.full_path, _pb(e)) for e in store.list_directory_entries(d, "", True, 1000)]
                 for d in listed}
        store.close()
        assert again == listed


def test_new_store_gates_name_their_guidance():
    """TestAbstractSql's gated kinds: unreachable services raise with
    the reference's guidance, in the reference's words."""
    def errors(side):
        new_store = mod(side, "filer.filerstore").new_store
        out = []
        for kind, path in (("mysql", "127.0.0.1:1"), ("redis", "127.0.0.1:1"),
                           ("cassandra", "127.0.0.1:1"), ("etcd", "127.0.0.1:1"),
                           ("postgres", "127.0.0.1:1"), ("tikv", "127.0.0.1:1"),
                           ("no-such-store", ""), ("lsm", ""), ("sortedlog", "")):
            try:
                new_store(kind, path)
                out.append((kind, None))
            except Exception as e:  # noqa: BLE001 — the class and text are compared
                out.append((kind, type(e).__name__, str(e)))
        return out

    got = _both(errors)
    assert all(g[1] in ("RuntimeError", "ValueError") for g in got)
    assert "cannot reach PD" in dict((g[0], g[2]) for g in got)["tikv"]


@pytest.mark.parametrize("kind", ["postgres", "mysql"])
def test_wrong_password_is_an_auth_error(kind):
    f = _fake("FakePostgres" if kind == "postgres" else "FakeMysql", password="right")
    try:
        msgs = {}
        for side in SIDES:
            with pytest.raises(Exception) as ei:
                mod(side, "filer.filerstore").new_store(
                    kind, f"{f.address}/seaweedfs?user=seaweedfs&password=nope")
            msgs[side] = (type(ei.value).__name__, str(ei.value))
    finally:
        f.stop()
    assert msgs["port"] == msgs["ref"]
    assert ("authentication" if kind == "postgres" else "Access denied") in msgs["port"][1]


def test_abstract_sql_dialects_and_dirhash():
    def run(s):
        asql = mod(s, "filer.abstract_sql")
        return ([asql.hash_string_to_long(p) for p in ("/home/user", "/", "", "/a/b/c")],
                vars(asql.MYSQL_DIALECT), vars(asql.POSTGRES_DIALECT))
    hashes, my, pg = _both(run)
    assert hashes[:3] == [1669289113769266586, 7378810950367401542, -3162216497309240828]
    assert my["insert"] == "INSERT INTO filemeta (dirhash,name,directory,meta) VALUES(%s,%s,%s,%s)"
    assert "name>$2" in pg["list_exclusive"]


def test_mysql_packet_framing_splits_at_16mib():
    """A >=16 MiB logical packet is split into max-size frames on send
    and reassembled on read, the frames equal to the reference's."""
    def run(s):
        conn_cls = mod(s, "filer.mysql_driver").MysqlConnection
        conn = conn_cls.__new__(conn_cls)
        out = []
        for size in (0xFFFFFF - 1, 0xFFFFFF, 0xFFFFFF + 7):
            sent = []
            conn.sock = types.SimpleNamespace(sendall=lambda b: sent.append(bytes(b)))
            payload = (b"0123456789abcdef" * ((size // 16) + 1))[:size]
            conn._seq = 0
            conn._send_packet(payload)
            wire = b"".join(sent)
            conn.rfile = io.BytesIO(wire)
            assert conn._read_packet() == payload
            out.append(hash(wire))
        return out
    _both(run)


@pytest.mark.parametrize("kind", ["sql", "postgres"])
def test_transaction_rollback_restores_state(kind, tmp_path):
    """Both packages' SQL stores roll a batch back, the duplicate insert
    inside the transaction degrading to an update first."""
    def run(side):
        fakes = []
        ent = mod(side, "filer.entry")
        s = _open_store(side, kind, tmp_path, fakes)
        try:
            s.insert_entry(ent.Entry("/t/keep", attr=ent.Attr(mtime=1)))
            s.begin_transaction()
            s.insert_entry(ent.Entry("/t/tmp", attr=ent.Attr(mtime=2)))
            s.insert_entry(ent.Entry("/t/keep", attr=ent.Attr(mtime=5)))
            s.delete_entry("/t/keep") if kind == "sql" else None
            s.rollback_transaction()
            keep = s.find_entry("/t/keep").attr.mtime
            try:
                s.find_entry("/t/tmp")
                tmp = "found"
            except mod(side, "filer.filerstore").EntryNotFound:
                tmp = "not found"
            s.insert_entry(ent.Entry("/t/keep", attr=ent.Attr(mtime=9)))
            return keep, tmp, s.find_entry("/t/keep").attr.mtime
        finally:
            s.close()
            for f in fakes:
                f.stop()
    assert _both(run) == (1, "not found", 9)


def test_sqlite_transactions():
    def run(side):
        ent, fs = mod(side, "filer.entry"), mod(side, "filer.filerstore")
        store = fs.SqliteStore(":memory:")
        store.insert_entry(ent.Entry(full_path="/keep", attr=ent.Attr(mtime=1)))
        store.begin_transaction()
        store.insert_entry(ent.Entry(full_path="/tx-new", attr=ent.Attr(mtime=2)))
        store.delete_entry("/keep")
        store.rollback_transaction()
        out = [store.find_entry("/keep").full_path]
        with pytest.raises(fs.EntryNotFound):
            store.find_entry("/tx-new")
        store.begin_transaction()
        store.insert_entry(ent.Entry(full_path="/tx", attr=ent.Attr(mtime=1)))
        store.commit_transaction()
        out.append(store.find_entry("/tx").full_path)
        return out
    assert _both(run) == ["/keep", "/tx"]


def test_sortedlog_replay_after_reopen(tmp_path):
    def run(side):
        ent, fs = mod(side, "filer.entry"), mod(side, "filer.filerstore")
        path = str(tmp_path / f"{side}.log")
        s = fs.SortedLogStore(path)
        s.insert_entry(ent.Entry("/a/b", attr=ent.Attr(mtime=1)))
        s.insert_entry(ent.Entry("/a/c", attr=ent.Attr(mtime=2)))
        s.delete_entry("/a/b")
        s.close()
        s2 = fs.SortedLogStore(path)
        with pytest.raises(fs.EntryNotFound):
            s2.find_entry("/a/b")
        mtime = s2.find_entry("/a/c").attr.mtime
        s2.close()
        with open(path, "rb") as f:
            return mtime, f.read()
    assert _both(run)[0] == 2


class TestTikvStore:
    """TestTikvStore on both packages against FakeTikv: epoch retries,
    multi-batch scans and the md5(dir)+name key scheme."""

    def test_region_error_scan_batches_and_keys(self):
        import hashlib

        def run(side):
            ts = mod(side, "filer.tikv_store")
            ent = mod(side, "filer.entry")
            f = _fake("FakeTikv")
            old = ts.SCAN_BATCH
            try:
                s = ts.TikvStore(f.address)
                s.insert_entry(ent.Entry("/d/one", attr=ent.Attr(mtime=1)))
                f.fail_next_with_region_error = 1
                out = [s.find_entry("/d/one").attr.mtime]
                f.fail_next_with_region_error = 1
                s.insert_entry(ent.Entry("/d/two", attr=ent.Attr(mtime=2)))
                out.append(s.find_entry("/d/two").attr.mtime)
                ts.SCAN_BATCH = 7
                names = [f"f{i:03d}" for i in range(25)]
                for n in names:
                    s.insert_entry(ent.Entry(f"/big/{n}", attr=ent.Attr(mtime=1)))
                out.append([e.name for e in s.list_directory_entries("/big", "", True, 100)])
                out.append([e.name for e in s.list_directory_entries("/big", "f009", False, 100)])
                s.delete_folder_children("/big")
                out.append(s.list_directory_entries("/big", "", True, 100))
                s.insert_entry(ent.Entry("/pre/x", attr=ent.Attr(mtime=1)))
                s.insert_entry(ent.Entry("/prefix/y", attr=ent.Attr(mtime=2)))
                out.append([e.name for e in s.list_directory_entries("/pre", "", True, 10)])
                out.append(ts._gen_key("/home/user", "a.txt"))
                s.close()
                return out
            finally:
                ts.SCAN_BATCH = old
                f.stop()

        got = _both(run)
        assert got[0:2] == [1, 2] and got[2] == [f"f{i:03d}" for i in range(25)]
        assert got[3] == got[2][10:] and got[4] == [] and got[5] == ["x"]
        assert got[6] == hashlib.md5(b"/home/user").digest() + b"a.txt"


# --- the embedded LSM store (TestLsmStore) ------------------------------------------


def _lsm(side, path, **kw):
    return mod(side, "filer.lsm").LsmStore(str(path), **kw)


def _e(side, i, mtime=None, d="/d"):
    ent = mod(side, "filer.entry")
    return ent.Entry(f"{d}/f{i:04d}", attr=ent.Attr(mtime=i if mtime is None else mtime,
                                                    crtime=i))


def _names(store, d="/d", start="", inclusive=True, limit=1000):
    return [e.name for e in store.list_directory_entries(d, start, inclusive, limit)]


def _lsm_both(tmp_path, case):
    """case(side, dir) on both packages in their own directories; the
    answers and the files left behind are equal."""
    got = {}
    for side in SIDES:
        d = tmp_path / side / "lsm"
        got[side] = (case(side, d), _tree_bytes(d))
    assert got["port"] == got["ref"]
    return got["port"][0]


class TestLsmStore:
    def test_persistence_across_reopen_via_wal(self, tmp_path):
        def case(side, d):
            s = _lsm(side, d)
            for i in range(5):
                s.insert_entry(_e(side, i))
            s.delete_entry("/d/f0003")
            s2 = _lsm(side, d)  # no close(): the WAL alone is replayed
            out = (s2.find_entry("/d/f0001").attr.mtime, _names(s2))
            with pytest.raises(mod(side, "filer.filerstore").EntryNotFound):
                s2.find_entry("/d/f0003")
            s2.close()
            s.close()
            return out
        assert _lsm_both(tmp_path, case) == (1, ["f0000", "f0001", "f0002", "f0004"])

    def test_flush_creates_sstable_and_survives(self, tmp_path):
        def case(side, d):
            s = _lsm(side, d, memtable_bytes=512)
            for i in range(40):
                s.insert_entry(_e(side, i))
            tables = len(s._tables)
            s.close()
            s2 = _lsm(side, d, memtable_bytes=512)
            out = [s2.find_entry(f"/d/f{i:04d}").attr.mtime for i in range(40)]
            s2.close()
            return tables, out
        tables, mtimes = _lsm_both(tmp_path, case)
        assert tables > 0 and mtimes == list(range(40))

    def test_compaction_merges_and_drops_tombstones(self, tmp_path):
        def case(side, d):
            s = _lsm(side, d, memtable_bytes=256, compact_at=3)
            for i in range(60):
                s.insert_entry(_e(side, i))
                if i % 2:
                    s.delete_entry(f"/d/f{i:04d}")
            s.flush()
            tables, live = len(s._tables), _names(s)
            s.close()
            s2 = _lsm(side, d)
            again, mem = _names(s2), bool(s2._mem)
            with pytest.raises(mod(side, "filer.filerstore").EntryNotFound):
                s2.find_entry("/d/f0001")
            ssts = sorted(f for f in os.listdir(d) if f.endswith(".sst"))
            n = len(s2._tables)
            s2.close()
            return tables, live, again, mem, len(ssts) == n
        tables, live, again, mem, tidy = _lsm_both(tmp_path, case)
        assert tables < 3 and live == again == [f"f{i:04d}" for i in range(0, 60, 2)]
        assert not mem and tidy

    def test_torn_wal_tail_recovered(self, tmp_path):
        def case(side, d):
            s = _lsm(side, d)
            for i in range(4):
                s.insert_entry(_e(side, i))
            wal = d / "wal.log"
            wal.write_bytes(wal.read_bytes()[:-3])
            s2 = _lsm(side, d)
            out = [s2.find_entry(f"/d/f{i:04d}").attr.mtime for i in range(3)]
            with pytest.raises(mod(side, "filer.filerstore").EntryNotFound):
                s2.find_entry("/d/f0003")
            s2.insert_entry(_e(side, 99))
            out.append(s2.find_entry("/d/f0099").attr.mtime)
            s2.close()
            s.close()
            return out
        assert _lsm_both(tmp_path, case) == [0, 1, 2, 99]

    def test_wal_mid_file_corruption_cut(self, tmp_path):
        def case(side, d):
            s = _lsm(side, d)
            for i in range(5):
                s.insert_entry(_e(side, i))
            wal = d / "wal.log"
            raw = bytearray(wal.read_bytes())
            raw[len(raw) // 2] ^= 0xFF
            wal.write_bytes(bytes(raw))
            s2 = _lsm(side, d)
            names = _names(s2)
            mtimes = [s2.find_entry(f"/d/{n}").attr.mtime for n in names]
            s2.close()
            s.close()
            return names, mtimes
        names, mtimes = _lsm_both(tmp_path, case)
        assert names == [f"f{i:04d}" for i in range(len(names))] and len(names) < 5
        assert mtimes == list(range(len(names)))

    def test_newest_wins_and_pagination_across_tables(self, tmp_path):
        def case(side, d):
            s = _lsm(side, d, memtable_bytes=100000, compact_at=100)
            for round_ in range(3):
                for i in range(10):
                    s.insert_entry(_e(side, i, mtime=round_ * 100 + i))
                s.flush()
            out = [len(s._tables), [s.find_entry(f"/d/f{i:04d}").attr.mtime for i in range(10)]]
            for i in range(10, 30, 2):
                s.insert_entry(_e(side, i))
            s.flush()
            for i in range(11, 30, 2):
                s.insert_entry(_e(side, i))  # stays in the memtable
            page1 = _names(s, limit=7)
            out += [page1, _names(s, start=page1[-1], inclusive=False, limit=7)]
            s.insert_entry(_e(side, 1, d="/d2"))
            out.append(_names(s, d="/d2"))
            s.delete_entry("/d/f0001")
            s.flush()
            out.append(_names(s, limit=3))
            s.insert_entry(_e(side, 1))
            s.flush()
            out.append(_names(s, limit=3))
            s.close()
            return out
        got = _lsm_both(tmp_path, case)
        assert got[0] == 3 and got[1] == [200 + i for i in range(10)]
        assert got[2] == [f"f{i:04d}" for i in range(7)]
        assert got[3] == [f"f{i:04d}" for i in range(7, 14)] and got[4] == ["f0001"]
        assert got[5] == ["f0000", "f0002", "f0003"] and got[6] == ["f0000", "f0001", "f0002"]

    def test_concurrent_writers_listers_under_compaction(self, tmp_path):
        """Writers and listers on threads while tiny thresholds force
        flushes and compactions; every surviving key reads back, and the
        survivors equal the reference's under the same schedule."""
        def case(side, d):
            s = _lsm(side, d, memtable_bytes=2048, compact_at=3)
            errors, survivors = [], {}

            def writer(wid):
                mine = {}
                try:
                    for i in range(120):
                        s.insert_entry(_e(side, i, mtime=wid * 1000 + i, d=f"/w{wid}"))
                        mine[i] = wid * 1000 + i
                        if i % 7 == 3:
                            s.delete_entry(f"/w{wid}/f{i:04d}")
                            del mine[i]
                except Exception as e:  # noqa: BLE001 — reported below
                    errors.append(e)
                survivors[wid] = mine

            def lister():
                try:
                    for _ in range(60):
                        for wid in range(4):
                            for e in s.list_directory_entries(f"/w{wid}", "", True, 50):
                                assert e.name.startswith("f")
                except Exception as e:  # noqa: BLE001 — reported below
                    errors.append(e)

            threads = [threading.Thread(target=writer, args=(w,)) for w in range(4)]
            threads += [threading.Thread(target=lister) for _ in range(2)]
            for t in threads:
                t.start()
            for t in threads:
                t.join()
            assert not errors, errors[:3]
            out = {}
            for wid, mine in sorted(survivors.items()):
                assert set(_names(s, d=f"/w{wid}")) == {f"f{i:04d}" for i in mine}
                out[wid] = sorted((i, s.find_entry(f"/w{wid}/f{i:04d}").attr.mtime)
                                  for i in mine)
            s.close()
            return out
        got = {side: case(side, tmp_path / side / "lsm") for side in SIDES}
        assert got["port"] == got["ref"] and len(got["port"]) == 4


# --- the filer core ------------------------------------------------------------------


@pytest.fixture
def pinned_dirs(monkeypatch):
    """new_directory_entry's clock pinned in both packages."""
    for side in SIDES:
        monkeypatch.setattr(mod(side, "filer.entry"), "time",
                            types.SimpleNamespace(time=lambda: 1_700_000_000))


def _filer(side, **kw):
    return mod(side, "filer.filer").Filer(mod(side, "filer.filerstore").MemoryStore(), **kw)


class TestFilerCore:
    def test_create_overwrite_delete_rename(self, pinned_dirs):
        def run(side):
            ent, fs = mod(side, "filer.entry"), mod(side, "filer.filerstore")
            f = _filer(side)
            f.create_entry(ent.Entry("/a/b/c/file.txt", attr=ent.Attr(mtime=1)))
            out = [f.find_entry(p).is_directory for p in ("/a", "/a/b", "/a/b/c", "/a/b/c/file.txt")]
            f.create_entry(ent.Entry("/f", chunks=_chunks(side, [(0, 10, "1,aa", 1)])))
            f.create_entry(ent.Entry("/f", chunks=_chunks(side, [(0, 10, "1,bb", 2)])))
            out.append(list(f._pending_chunk_deletions))
            f.create_entry(ent.Entry("/d/x", chunks=_chunks(side, [(0, 10, "1,cc", 1)])))
            f.create_entry(ent.Entry("/d/sub/y", chunks=_chunks(side, [(0, 10, "1,dd", 1)])))
            with pytest.raises(ValueError):
                f.delete_entry("/d", is_recursive=False)
            out.append(sorted(f.delete_entry("/d", is_recursive=True)))
            with pytest.raises(fs.EntryNotFound):
                f.find_entry("/d/x")
            f.create_entry(ent.Entry("/olddir/f1", chunks=_chunks(side, [(0, 10, "1,ee", 1)])))
            f.create_entry(ent.Entry("/olddir/sub/f2", attr=ent.Attr(mtime=3)))
            f.atomic_rename("/olddir", "/newdir")
            out += [f.find_entry("/newdir/f1").chunks[0].fid,
                    f.find_entry("/newdir/sub/f2").attr.mtime]
            with pytest.raises(fs.EntryNotFound):
                f.find_entry("/olddir")
            return out
        assert _both(run) == [True, True, True, False, ["1,aa"], ["1,cc", "1,dd"], "1,ee", 3]

    def test_seeded_sequence_events_and_deletions_equal(self, pinned_dirs):
        """One numpy-drawn sequence of creates, overwrites, updates,
        recursive deletes and renames through both Filers: the events
        (old, new, delete_chunks) and the pending chunk deletions are
        equal."""
        rng = np.random.default_rng(5)
        ops = []
        for i in range(120):
            kind = ["create", "create", "update", "delete", "rename"][int(rng.integers(0, 5))]
            d = ["/x", "/x/y", "/z"][int(rng.integers(0, 3))]
            ops.append((kind, f"{d}/n{int(rng.integers(0, 6))}",
                        f"{['/x', '/z', '/w'][int(rng.integers(0, 3))]}/m{i}", i,
                        [(int(o), int(rng.integers(1, 900)), f"3,{i:03x}{k}", i * 4 + k)
                         for k, o in enumerate(rng.integers(0, 4000, int(rng.integers(1, 3))))]))

        def run(side):
            ent, fs = mod(side, "filer.entry"), mod(side, "filer.filerstore")
            events = []

            def on_event(old, new, delete_chunks):
                events.append((old and _pb(old), new and _pb(new), delete_chunks))

            f = _filer(side, on_event=on_event)
            for kind, path, dest, i, rows in ops:
                try:
                    if kind == "create":
                        f.create_entry(ent.Entry(path, attr=ent.Attr(mtime=i, crtime=i),
                                                 chunks=_chunks(side, rows)))
                    elif kind == "update":
                        old = f.find_entry(path)
                        f.update_entry(ent.Entry(path, attr=ent.Attr(mtime=i),
                                                 chunks=list(old.chunks) + _chunks(side, rows)))
                    elif kind == "delete":
                        f.delete_entry(path.rsplit("/", 1)[0] if i % 4 == 0 else path,
                                       is_recursive=True)
                    else:
                        f.atomic_rename(path, dest)
                except (fs.EntryNotFound, ValueError) as e:
                    events.append(("error", type(e).__name__))
            return events, list(f._pending_chunk_deletions)

        events, pending = _both(run)
        assert len(events) > 100 and len(pending) > 10


# --- the filer server ---------------------------------------------------------------


def wait_for(cond, timeout=30.0):
    deadline = time.time() + timeout
    while time.time() < deadline:
        if cond():
            return True
        time.sleep(0.05)
    return False


class Trio:
    """A master, one volume server and a FilerServer of one package."""

    def __init__(self, side, root, store="memory", store_path="", max_mb=1, n_volumes=1,
                 collection=""):
        master_cls = mod(side, "server.master_server").MasterServer
        vs_cls = mod(side, "server.volume_server").VolumeServer
        self.side, self.started = side, []
        self.master = master_cls(port=free_port(), volume_size_limit_mb=64)
        self.master.start()
        self.started.append(self.master)
        self.servers = []
        try:
            for i in range(n_volumes):
                d = os.path.join(root, f"{side}-vs{i}")
                os.makedirs(d, exist_ok=True)
                kw = dict(ec_codec="cpu") if side == "ref" else dict(ec_codec="cuda",
                                                                      device="cpu")
                vs = vs_cls([d], port=free_port(), master=f"127.0.0.1:{self.master.port}",
                            rack=f"rack{i % 2}", heartbeat_interval=0.2,
                            max_volume_counts=[100], scrub_interval=0, **kw)
                vs.start()
                self.servers.append(vs)
                self.started.append(vs)
                assert wait_for(lambda: len(self.master.topology.data_nodes()) == i + 1)
            self.start_filer(store, store_path, max_mb, collection)
        except BaseException:
            self.stop()
            raise

    def start_filer(self, store="memory", store_path="", max_mb=1, collection="", port=0):
        fs_cls = mod(self.side, "server.filer_server").FilerServer
        self.filer = fs_cls([f"127.0.0.1:{self.master.port}"], port=port or free_port(),
                            store=store,
                            store_path=store_path, max_mb=max_mb, collection=collection)
        self.filer.start()
        self.started.append(self.filer)

    def stop_filer(self):
        self.filer.stop()
        self.started.remove(self.filer)

    def stop_server(self, vs):
        vs.stop()
        self.started.remove(vs)

    def stop(self):
        for s in reversed(self.started):
            s.stop()
        self.started = []

    def url(self, path):
        return f"http://127.0.0.1:{self.filer.port}{path}"


def http(url, data=None, method=None, headers=None, timeout=30):
    """(status, headers, body) without raising on an error status."""
    req = urllib.request.Request(url, data=data, headers=headers or {},
                                 method=method or ("POST" if data is not None else "GET"))
    try:
        with urllib.request.urlopen(req, timeout=timeout) as r:
            return r.status, r.headers, r.read()
    except urllib.error.HTTPError as e:
        return e.code, e.headers, e.read()


@pytest.fixture(scope="module")
def trios(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("filer-trios"))
    out = {}
    try:
        for side in SIDES:
            out[side] = Trio(side, root)
        yield out
    finally:
        for t in out.values():
            t.stop()


def _listing(body):
    d = json.loads(body)
    for e in d["Entries"]:
        e.pop("Mtime")
    return d


def _each(trios, fn):
    got = {side: fn(trios[side]) for side in SIDES}
    assert got["port"] == got["ref"]
    return got["port"]


class TestFilerServer:
    def test_post_get_range_list_delete(self, trios):
        body = b"filer http roundtrip " * 10

        def run(t):
            out = [http(t.url("/docs/hello.txt"), body, headers={"Content-Type": "text/plain"})[::2]]
            st, h, got = http(t.url("/docs/hello.txt"))
            out.append((st, h["Content-Type"], h["Content-Length"], h["Accept-Ranges"], got))
            st, h, got = http(t.url("/docs/hello.txt"), headers={"Range": "bytes=5-24"})
            out.append((st, h["Content-Range"], got))
            out.append(http(t.url("/docs/hello.txt"), headers={"Range": "bytes=999-"})[0])
            out.append(http(t.url("/docs/hello.txt"), method="HEAD")[0])
            st, _, listing = http(t.url("/docs"))
            out.append((st, _listing(listing)))
            out.append(http(t.url("/docs"), method="DELETE")[::2])
            out.append(http(t.url("/docs/hello.txt"), method="DELETE")[0])
            out.append(http(t.url("/docs/hello.txt"))[::2])
            out.append(http(t.url("/nodir/"), b"")[::2])
            return out
        got = _each(trios, run)
        assert got[1][-1] == body and got[2][0] == 206 and got[-3] == 204

    def test_html_directory_browser(self, trios):
        def run(t):
            for name in ("ua.txt", "ub.txt", "uc.txt"):
                http(t.url(f"/ui/{name}"), b"x")
            pages = []
            for q in ("", "?limit=2"):
                st, h, page = http(t.url(f"/ui/{q}"), headers={"Accept": "text/html"})
                # the rows' modified times are the one field that differs
                pages.append((st, h["Content-Type"],
                              re.sub(rb"\d{4}-\d\d-\d\d \d\d:\d\d:\d\d", b"T", page)))
            d = json.loads(http(t.url("/ui/?limit=2"))[2])
            return pages, d["ShouldDisplayLoadMore"], d["LastFileName"]
        pages, more, last = _each(trios, run)
        assert b"ua.txt" in pages[0][2] and b"load more" in pages[1][2]
        assert more is True and last == "ub.txt"

    def test_autochunk_large_file(self, trios):
        body = bytes(range(256)) * 10240  # 2.5 MiB at max_mb=1: three chunks

        def run(t):
            st = http(t.url("/big/blob.bin"), body)[0]
            entry = t.filer.filer.find_entry("/big/blob.bin")
            got = http(t.url("/big/blob.bin"))[2]
            part = http(t.url("/big/blob.bin"), headers={"Range": "bytes=1048000-2097999"})
            return (st, [(c.offset, c.size) for c in entry.chunks], got == body,
                    part[0], part[2] == body[1048000:2098000])
        assert _each(trios, run) == (201, [(0, 1 << 20), (1 << 20, 1 << 20),
                                           (2 << 20, 512 << 10)], True, 206, True)

    def test_grpc_surface(self, trios):
        import grpc

        def run(t):
            fpb, rpc = mod(t.side, "pb.filer_pb2"), mod(t.side, "pb.rpc")
            out = []
            with grpc.insecure_channel(f"127.0.0.1:{t.filer.grpc_port}") as ch:
                stub = rpc.filer_stub(ch)
                stub.CreateEntry(fpb.CreateEntryRequest(
                    directory="/grpc", entry=fpb.Entry(
                        name="f1", attributes=fpb.Attributes(mtime=11, file_mode=0o660))))
                out.append(stub.LookupDirectoryEntry(fpb.LookupDirectoryEntryRequest(
                    directory="/grpc", name="f1")).SerializeToString(deterministic=True))
                out.append([r.entry.SerializeToString(deterministic=True)
                            for r in stub.ListEntries(fpb.ListEntriesRequest(directory="/grpc"))])
                stub.AtomicRenameEntry(fpb.AtomicRenameEntryRequest(
                    old_directory="/grpc", old_name="f1", new_directory="/grpc2", new_name="f2"))
                out.append(stub.LookupDirectoryEntry(fpb.LookupDirectoryEntryRequest(
                    directory="/grpc2", name="f2")).entry.name)
                ar = stub.AssignVolume(fpb.AssignVolumeRequest(count=1))
                out.append(("," in ar.fid, bool(ar.url), ar.count))
                cfg = stub.GetFilerConfiguration(fpb.GetFilerConfigurationRequest())
                out.append((cfg.max_mb, cfg.collection, cfg.replication))
                vid = ar.fid.split(",")[0]
                locs = stub.LookupVolume(fpb.LookupVolumeRequest(volume_ids=[vid])).locations_map
                out.append((list(locs) == [vid], [len(locs[vid].locations)]))
                stub.DeleteEntry(fpb.DeleteEntryRequest(directory="/grpc2", name="f2",
                                                        is_delete_data=True))
                with pytest.raises(grpc.RpcError) as ei:
                    stub.LookupDirectoryEntry(fpb.LookupDirectoryEntryRequest(
                        directory="/grpc2", name="f2"))
                out.append(ei.value.code())
                stub.CreateEntry(fpb.CreateEntryRequest(directory="/", entry=fpb.Entry(
                    name="empty.txt", attributes=fpb.Attributes(file_mode=0o644))))
            out.append(http(t.url("/empty.txt"))[::2])
            return out
        got = _each(trios, run)
        assert got[2] == "f2" and got[4] == (1, "", "") and got[-1] == (200, b"")

    def test_chunk_gc_after_delete(self, trios):
        body = b"gc me " * 1000

        def run(t):
            http(t.url("/gc/target.bin"), body)
            fid = t.filer.filer.find_entry("/gc/target.bin").chunks[0].fid
            vs = t.servers[0]
            before = http(f"http://127.0.0.1:{vs.port}/{fid}")[::2]
            http(t.url("/gc/target.bin"), method="DELETE")
            t.filer.filer.flush_chunk_deletions()
            assert wait_for(lambda: http(f"http://127.0.0.1:{vs.port}/{fid}")[0] == 404)
            return before, http(f"http://127.0.0.1:{vs.port}/{fid}")[0]
        assert _each(trios, run) == ((200, body), 404)

    def test_stale_lookup_is_looked_up_again(self, trios):
        """A chunk whose cached lookup names only a dead server (a holder
        lost, a volume moved by ec.encode) reads back on the port: the
        filer drops the entry and asks the master again. (The
        reference keeps the stale entry for its 10 minutes.)"""
        from seaweedfs_tpu_torch.client import operation as op

        t = trios["port"]
        body = b"looked up again " * 500
        http(t.url("/stale/file.bin"), body)
        fid = t.filer.filer.find_entry("/stale/file.bin").chunks[0].fid
        vid, master = fid.split(",")[0], f"127.0.0.1:{t.master.port}"
        dead = f"127.0.0.1:{free_port()}"
        with op._lookup_lock:
            op._lookup_cache[(master, vid)] = op._CacheEntry(
                op.LookupResult(vid=vid, locations=[{"url": dead, "publicUrl": dead}]), 600)
        assert http(t.url("/stale/file.bin"))[::2] == (200, body)
        assert op.lookup(master, vid).locations[0]["url"] != dead

    def test_metrics_and_announce(self, trios):
        """/metrics answers on the filer's listener, and the filer
        registers with the master as a scrape target of kind filer."""
        t = trios["port"]
        st, h, text = http(t.url("/metrics"))
        assert st == 200 and b"weed_http_request_total" in text
        addr = f"127.0.0.1:{t.filer.port}"
        assert wait_for(lambda: t.master.gateway_registrations().get(addr, {}).get("kind")
                        == "filer", 15)


# ----------------------------------------------------------------------
# the filer's master hop: with_master_failover against the reference's


def _failover_case(case, up, down, side_calls):
    """(masters, start_idx, fn) of one failover case; fn records the
    masters it was called with in side_calls."""
    def connect(m):
        side_calls.append(m)
        host, port = m.rsplit(":", 1)
        socket.create_connection((host, int(port)), timeout=5).close()
        return f"answered by {m}"

    def leaderless(m):
        side_calls.append(m)
        if len(side_calls) <= 2:
            raise RuntimeError("no leader yet")
        return f"answered by {m}"

    def in_band(m):
        side_calls.append(m)
        raise RuntimeError("no free volumes left")

    return {"one_down": ([down[0], up], 0, connect),
            "one_down_from_the_live_one": ([down[0], up], 1, connect),
            "all_down": (down, 0, connect),
            "leaderless_round": ([down[0], up], 1, leaderless),
            "in_band_error": ([up, down[0]], 0, in_band)}[case]


@pytest.mark.parametrize("case", ["one_down", "one_down_from_the_live_one", "all_down",
                                  "leaderless_round", "in_band_error"])
def test_master_failover_equals_the_references(case, monkeypatch):
    """The same masters, one or all of them down (a closed port), give
    the same answer, the same error and the same sequence of masters
    tried through both packages' with_master_failover. The retry
    budget's gate is off so that neither package's budget, drained by
    earlier tests in this process, cuts the rounds short."""
    monkeypatch.setenv("WEED_RETRY_BUDGET_RATIO", "0")
    listener = socket.create_server(("127.0.0.1", 0))
    try:
        up = f"127.0.0.1:{listener.getsockname()[1]}"
        down = [f"127.0.0.1:{free_port()}", f"127.0.0.1:{free_port()}"]
        got = {}
        for side in SIDES:
            calls: list = []
            masters, start, fn = _failover_case(case, up, down, calls)
            try:
                out = ("ok", mod(side, "client.operation").with_master_failover(
                    masters, fn, start))
            except (OSError, RuntimeError) as e:
                out = ("raised", type(e).__name__, str(e))
            got[side] = (out, calls)
    finally:
        listener.close()
    assert got["port"] == got["ref"]
    if case == "all_down":
        assert got["port"][0][1] == "ConnectionRefusedError"
        assert len(got["port"][1]) == 4 * len(down)


def test_filer_stop_ends_every_thread_it_started(tmp_path):
    """The port's FilerServer.stop() joins what start() began: the HTTP
    listener, the announce loop, the gRPC workers and the deletion loop."""
    t = Trio("port", str(tmp_path))
    try:
        t.stop_filer()
        before = set(threading.enumerate())
        t.start_filer()
        http(t.url("/x/y.txt"), b"threads")
        assert http(t.url("/x/y.txt"))[2] == b"threads"
        t.stop_filer()

        def left():
            # the master's and the volume server's gRPC pools grow while
            # they serve the filer; those workers are theirs
            theirs = set(t.master._grpc_pool._threads) | set(t.servers[0]._grpc_pool._threads)
            return set(threading.enumerate()) - before - theirs

        assert wait_for(lambda: not left(), 10), [th.name for th in left()]
    finally:
        t.stop()


# --- the slice end to end ------------------------------------------------------------


def _tree(seed, n_files):
    """{path: bytes}: nested directories of 1 KiB - 64 KiB files drawn
    with numpy, plus one file of 2.5 MiB that a 1 MB -maxMB cuts in three."""
    rng = np.random.default_rng(seed)
    out = {}
    for i in range(n_files):
        depth = int(rng.integers(1, 4))
        d = "/".join(f"d{int(rng.integers(0, 3))}" for _ in range(depth))
        size = int(rng.integers(1 << 10, 64 << 10))
        out[f"/tree/{d}/f{i:03d}.bin"] = rng.bytes(size)
    out["/tree/big.bin"] = rng.bytes(5 << 19)
    return out


def _run_shell(side, trio, lines):
    sh = mod(side, "shell")
    env = sh.CommandEnv([f"127.0.0.1:{trio.master.port}"])
    buf = io.StringIO()
    for line in lines:
        sh.run_command(env, line, buf)
    return buf.getvalue()


def _read_all(trio, tree):
    return {p: http(trio.url(p))[::2] for p in tree}


def _shards(vs):
    return {vid: ev.shard_ids() for loc in vs.store.locations
            for vid, ev in loc.ec_volumes.items()}


def _victim(servers):
    """The holder to lose: of those whose loss leaves every volume ten
    shards (RS(10,4) tolerates four lost), the one holding the most
    volumes' shard 0 (a volume under 1 MiB keeps all its bytes in its
    first 1 MiB block, which is shard 0), so that reads decode."""
    held = {vs: _shards(vs) for vs in servers}
    safe = [vs for vs in servers if max(len(s) for s in held[vs].values()) <= 4]
    victim = max(safe, key=lambda vs: sum(0 in s for s in held[vs].values()))
    assert any(0 in s for s in held[victim].values()), held
    return victim


def test_slice_end_to_end_degraded_reads_equal_the_reference(tmp_path):
    tree = _tree(3, 24)
    reads = {}
    for side in SIDES:
        t = Trio(side, str(tmp_path), store="lsm", store_path=str(tmp_path / f"{side}-lsm"),
                 n_volumes=3, collection="filer")
        try:
            for p, data in tree.items():
                assert http(t.url(p), data)[0] == 201
            healthy = _read_all(t, tree)
            out = _run_shell(side, t, ["ec.encode -collection filer -fullPercent 0",
                                       "ec.balance -force"])
            assert out.count("ec encoded volume") == 7
            reads[side] = _read_all(t, tree)
            assert reads[side] == healthy
            if side == "port":
                # files deleted through the filer: their chunks' fids
                # answer 404 on every holder of the EC volumes
                deleted = sorted(tree)[::8]
                fids = [c.fid for p in deleted for c in t.filer.filer.find_entry(p).chunks]
                for p in deleted:
                    assert http(t.url(p), method="DELETE")[0] == 204
                t.filer.filer.flush_chunk_deletions()
                assert {http(f"http://127.0.0.1:{vs.port}/{fid}")[0]
                        for vs in t.servers for fid in fids} == {404}
                # stop a holder whose loss the code tolerates, then read
                # every live file back through the filer: degraded decodes
                from seaweedfs_tpu_torch.stats.metrics import EC_DEGRADED_READS

                t.stop_server(_victim(t.servers))
                decoded = EC_DEGRADED_READS.value()
                live = {p: d for p, d in tree.items() if p not in deleted}
                reads["degraded"] = _read_all(t, live)
                assert EC_DEGRADED_READS.value() > decoded
                assert {http(t.url(p))[0] for p in deleted} == {404}
        finally:
            t.stop()
    want = {p: (200, data) for p, data in tree.items()}
    assert reads["port"] == want and reads["port"] == reads["ref"]
    assert reads["degraded"] == {p: want[p] for p in reads["degraded"]}


def test_lsm_namespace_survives_a_filer_restart(tmp_path):
    t = Trio("port", str(tmp_path), store="lsm", store_path=str(tmp_path / "lsm"))
    try:
        tree = _tree(8, 6)
        for p, data in tree.items():
            http(t.url(p), data)
        before = _run_shell("port", t, [f"fs.cd http://127.0.0.1:{t.filer.port}/tree",
                                        "fs.ls -l", "fs.du"])
        port = t.filer.port
        t.stop_filer()
        t.start_filer(store="lsm", store_path=str(tmp_path / "lsm"), port=port)
        after = _run_shell("port", t, [f"fs.cd http://127.0.0.1:{t.filer.port}/tree",
                                       "fs.ls -l", "fs.du"])
        assert after == before and "files" in after
        assert _read_all(t, tree) == {p: (200, d) for p, d in tree.items()}
    finally:
        t.stop()


@pytest.mark.parametrize("kind", ["memory", "none", "kafka", "aws_sqs", "google_pub_sub"])
def test_notification_configure_builds_each_queue(kind):
    """`configure` builds the process queue that notification.toml
    enables: the in-process core, nothing, or each broker backend against
    its fake (the kafka_fake broker, tests/cloud_fakes.py's FakeSqs and
    FakePubSub), and the queue it built delivers one event there."""
    from seaweedfs_tpu_torch import notification
    from seaweedfs_tpu_torch.notification.cloud_queues import PubSubQueue, SqsQueue
    from seaweedfs_tpu_torch.notification.kafka import KafkaQueue
    from seaweedfs_tpu_torch.notification.kafka_fake import FakeKafkaBroker
    from seaweedfs_tpu_torch.pb import filer_pb2 as fpb
    from seaweedfs_tpu_torch.util.config import Configuration
    from tests.cloud_fakes import FakePubSub, FakeSqs

    fake, section, cls = None, {}, type(None)
    if kind == "memory":
        section, cls = {"memory": {"enabled": True}}, notification.MemoryQueue
    elif kind == "kafka":
        fake = FakeKafkaBroker(partitions=3)
        section, cls = {"kafka": {"enabled": True, "hosts": f"{fake.host}:{fake.port}"}}, KafkaQueue
    elif kind == "aws_sqs":
        fake = FakeSqs("AK", "SK", "us-east-1", "q")
        section, cls = {"aws_sqs": {"enabled": True, "aws_access_key_id": "AK",
                                    "aws_secret_access_key": "SK", "sqs_queue_name": "q"}}, SqsQueue
    elif kind == "google_pub_sub":
        fake = FakePubSub("p", "t")
        section, cls = {"google_pub_sub": {"enabled": True, "project_id": "p", "topic": "t",
                                           "token": "tok"}}, PubSubQueue
    if fake is not None:
        fake.start()
        if kind != "kafka":
            section[kind]["endpoint"] = fake.endpoint
    try:
        q = notification.configure(Configuration({"notification": section}))
        assert type(q) is cls and notification.queue is q
        if q is None:
            return
        q.send_message("/k/v.bin", fpb.EventNotification(new_entry=fpb.Entry(name="v.bin")))
        if kind == "memory":
            assert q.receive(timeout=1)[0] == "/k/v.bin"
        elif kind == "kafka":
            assert [len(v) for v in fake.logs.values()] == [1]
            q.close()
        else:
            assert [k for k, _ in fake.messages] == ["/k/v.bin"]
    finally:
        notification.queue = None
        if fake is not None:
            fake.stop()


def test_filer_modules_and_commands_import_no_torch():
    code = ("import sys\n"
            "import seaweedfs_tpu_torch.server.filer_server, seaweedfs_tpu_torch.filer\n"
            "import seaweedfs_tpu_torch.filer.lsm, seaweedfs_tpu_torch.filer.stream\n"
            "import seaweedfs_tpu_torch.shell.fs_commands, seaweedfs_tpu_torch.util.etcd\n"
            "import seaweedfs_tpu_torch.command.filer_tools, seaweedfs_tpu_torch.command.servers\n"
            "from seaweedfs_tpu_torch.command import COMMANDS\n"
            "assert {'filer', 'filer.copy'} <= set(COMMANDS)\n"
            "print(sorted(m for m in sys.modules if m.split('.')[0] in ('torch', 'jax')))\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True,
                         text=True, timeout=120)
    assert out.returncode == 0, out.stderr[-2000:]
    assert out.stdout.strip() == "[]"


def test_flush_returns_after_the_loops_in_flight_deletions(monkeypatch):
    """flush_chunk_deletions() returns only once every chunk deletion
    queued before it was sent, including a batch the deletion loop took
    and is still sending: a test (or stop()) that flushes and then reads
    the holders sees the chunks gone. The reference's flush returns at
    once with an empty batch there."""
    from seaweedfs_tpu_torch.client import operation as op
    from seaweedfs_tpu_torch.filer.filer import Filer
    from seaweedfs_tpu_torch.filer.filerstore import new_store

    sent, entered, gate = [], threading.Event(), threading.Event()

    def slow_delete(master, fids):
        entered.set()
        assert gate.wait(30)
        sent.extend(fids)
        return []

    monkeypatch.setattr(op, "delete_files", slow_delete)
    f = Filer(new_store("memory"), masters=["127.0.0.1:1"])
    f.delete_chunks_async(["3,01637037d6"])
    looping = threading.Thread(target=f.flush_chunk_deletions)
    looping.start()
    assert entered.wait(30)
    flushed = threading.Event()
    flusher = threading.Thread(target=lambda: (f.flush_chunk_deletions(), flushed.set()))
    flusher.start()
    assert not flushed.wait(0.5), "the flush returned while a batch was still in flight"
    gate.set()
    looping.join(30)
    flusher.join(30)
    assert flushed.is_set() and not looping.is_alive() and sent == ["3,01637037d6"]
