"""The port's master tier and volume servers against seaweedfs_tpu's, as
clusters, on the CPU.

Each scenario runs on a reference cluster (MasterServer + VolumeServers
of seaweedfs_tpu, ec_codec="cpu") and on a port cluster (those of
seaweedfs_tpu_torch, ec_codec="cuda" on device="cpu": the kernels' plain
versions), both in this process: the same requests in the same order,
with the global `random` re-seeded before each side's call (assign's
cookies, volume growth's placement and the pick all draw from it) and
the volume clock pinned in both packages (the reference's POSTs on its
Python arm, the one the port has) and the health plane's verdicts off
(`WEED_HEALTH=0`: a heartbeat late on a loaded host would make a node
suspect on one side only; tests/test_torch_health_plane.py holds the
two planes equal). Servers register one at a
time, so both topologies hold their nodes in the same order, and both
masters assign with the "random" policy (the p2c policy weighs
heartbeat-reported in-flight counts, which depend on timing; it is
held equal in tests/test_torch_topology.py). Replies are compared with
each cluster's addresses replaced by role names; the tolerance is
equality: JSON replies, bodies, statuses, and EC shard files byte for
byte. tests/test_cluster.py's cases ported: TestAssignWriteRead,
TestGrpcPlane, TestEcLifecycle, TestDegradedParallelRead,
TestNodeLiveness, TestUrlAddressingForms, TestMasterRedirectAndVolStatus;
then the three-server spread of chip_smoke.py's cluster phase at a few
MiB (healthy and lost-server GETs with the tile cache on and off, and
the rack-gather rebuild), replica fan-out failing on a stopped peer, and
each package's volume server heartbeating to the other's master.
Every wait has a deadline; servers run in-process.
"""

import gzip
import hashlib
import itertools
import json
import os
import random
import time
import types
import urllib.error
import urllib.request

import numpy as np
import pytest

import seaweedfs_tpu.server.write_path as ref_write_path
import seaweedfs_tpu.storage.volume as ref_volume
import seaweedfs_tpu_torch.storage.volume as port_volume
from seaweedfs_tpu.server.master_server import MasterServer as RefMaster
from seaweedfs_tpu.server.volume_server import VolumeServer as RefVolume
from seaweedfs_tpu_torch.pb import master_pb2, rpc, volume_pb2 as pb
from seaweedfs_tpu_torch.server.master_server import MasterServer as PortMaster
from seaweedfs_tpu_torch.server.volume_server import VolumeServer as PortVolume
from seaweedfs_tpu_torch.util.availability import free_port

SIDES = ("ref", "port")
TS = "1700000000"  # pinned last-modified stamp for POSTs whose bytes are compared


def wait_for(cond, timeout=45.0, interval=0.05):
    deadline = time.time() + timeout
    while time.time() < deadline:
        if cond():
            return True
        time.sleep(interval)
    return False


@pytest.fixture(scope="module")
def pinned_clock():
    """Both packages' volume clocks pinned to one counter each; the
    reference's C POST path off (it reads the clock before it may
    decline a body, a compressible one, to the Python path, which reads
    it again, so the two packages' stamps would drift apart); and the
    health plane's verdicts off (`WEED_HEALTH=0`): on a loaded host a
    late heartbeat makes a node suspect on one side only, and the pick
    then skips its volumes there."""
    mp = pytest.MonkeyPatch()
    mp.setattr(ref_write_path, "NATIVE_POST_ENABLED", False)
    mp.setenv("WEED_HEALTH", "0")
    for mod in (ref_volume, port_volume):
        counter = itertools.count(1_700_000_000_000_000_000, 1000)
        mp.setattr(mod.Volume, "_now_ns", lambda self, c=counter: next(c))
    yield
    mp.undo()


def _volume(side, directory, master_port, rack, **kw):
    common = dict(port=free_port(), master=f"127.0.0.1:{master_port}", rack=rack,
                  heartbeat_interval=0.2, max_volume_counts=[100], scrub_interval=0)
    common.update(kw)
    if side == "ref":
        return RefVolume([directory], ec_codec="cpu", **common)
    return PortVolume([directory], ec_codec="cuda", device="cpu", **common)


class Cluster:
    """One master and its volume servers, started one at a time (each
    registered before the next starts)."""

    def __init__(self, side, root, racks=("rack0", "rack1", "rack0"), master_cls=None,
                 volume_side=None, **master_kw):
        master_cls = master_cls or (RefMaster if side == "ref" else PortMaster)
        self.side = side
        self.master = master_cls(port=free_port(), volume_size_limit_mb=64,
                                 assign_policy="random", **master_kw)
        self.master.start()
        self.servers = []
        try:
            for i, rack in enumerate(racks):
                self.add(os.path.join(root, f"{side}-vs{i}"), rack,
                         volume_side=volume_side)
        except BaseException:
            self.stop()
            raise

    def add(self, directory, rack, volume_side=None, **kw):
        os.makedirs(directory, exist_ok=True)
        vs = _volume(volume_side or self.side, directory, self.master.port, rack, **kw)
        vs.start()
        self.servers.append(vs)
        want = sum(1 for s in self.servers if not getattr(s, "_stopped", False))
        assert wait_for(lambda: len(self.master.topology.data_nodes()) == want), \
            f"{self.side}: server {vs.port} did not register"
        return vs

    def stop_server(self, vs):
        vs.stop()
        vs._stopped = True

    def stop(self):
        for vs in self.servers:
            if not getattr(vs, "_stopped", False):
                vs.stop()
        self.master.stop()

    @property
    def m(self):
        return f"http://127.0.0.1:{self.master.port}"

    def url(self, i):
        return f"127.0.0.1:{self.servers[i].port}"

    def index_of(self, url):
        return next(i for i, vs in enumerate(self.servers) if f"127.0.0.1:{vs.port}" == url)

    def norm(self, obj):
        """obj as JSON with this cluster's addresses named by role."""
        text = json.dumps(obj, sort_keys=True)
        for i, vs in enumerate(self.servers):
            text = text.replace(f"127.0.0.1:{vs.port}", f"vs{i}")
        return text.replace(f"127.0.0.1:{self.master.port}", "master")

    def grpc(self, i):
        return rpc.dial(f"127.0.0.1:{self.servers[i].grpc_port}")


def http(url, data=None, method=None, headers=None, timeout=20):
    """(status, headers, body) without raising on 4xx/5xx."""
    req = urllib.request.Request(url, data=data, method=method or ("POST" if data is not None else "GET"),
                                 headers=headers or {})
    try:
        with urllib.request.urlopen(req, timeout=timeout) as r:
            return r.status, r.headers, r.read()
    except urllib.error.HTTPError as e:
        return e.code, e.headers, e.read()


def hjson(url, **kw):
    status, _, body = http(url, **kw)
    return status, json.loads(body) if body else None


@pytest.fixture(scope="module")
def pair(tmp_path_factory, pinned_clock):
    root = str(tmp_path_factory.mktemp("clusters"))
    clusters = {}
    try:
        for side in SIDES:
            clusters[side] = Cluster(side, root)
        yield clusters
    finally:
        for c in clusters.values():
            c.stop()


def both(clusters, fn, seed=0):
    """fn(cluster) on each side with the global RNG seeded alike;
    returns {side: result}."""
    out = {}
    for side in SIDES:
        random.seed(seed)
        out[side] = fn(clusters[side])
    return out


def same(clusters, got):
    a, b = (clusters[s].norm(got[s]) for s in SIDES)
    assert a == b
    return got["port"]


def _assign(c, q=""):
    status, a = hjson(f"{c.m}/dir/assign{q}")
    assert status == 200, a
    return a


def _post(c, a, data, suffix="", q=f"?ts={TS}", headers=None):
    status, _, body = http(f"http://{a['url']}/{a['fid']}{suffix}{q}", data=data,
                           headers=headers or {"Content-Type": "application/octet-stream"})
    return status, body.decode()


# --- TestAssignWriteRead -----------------------------------------------------


def test_full_cycle(pair):
    blob = b"the quick brown fox" * 100

    def run(c):
        a = _assign(c)
        up = _post(c, a, blob, q=f"?filename=fox.txt&ts={TS}",
                   headers={"Content-Type": "text/plain"})
        got = http(f"http://{a['url']}/{a['fid']}")
        vid = a["fid"].split(",")[0]
        return [a, up, got[0], got[2] == blob, hjson(f"{c.m}/dir/lookup?volumeId={vid}")]

    got = same(pair, both(pair, run, seed=1))
    assert got[1][0] == 201 and got[2] == 200 and got[3]


def test_etag_304_wrong_cookie_and_delete(pair):
    def run(c):
        a = _assign(c)
        status, reply = _post(c, a, b"etag me")
        etag = json.loads(reply)["eTag"]
        url = f"http://{a['url']}/{a['fid']}"
        cond = http(url, headers={"If-None-Match": f'"{etag}"'})[0]
        vid, key_cookie = a["fid"].split(",")
        forged = http(f"http://{a['url']}/{vid},{key_cookie[:-8]}{'0' * 8}")[0]
        deleted = http(url, method="DELETE")
        return [status, cond, forged, deleted[0], deleted[2].decode(), http(url)[0]]

    assert same(pair, both(pair, run, seed=2)) == [201, 304, 404, 202, '{"size": 17}', 404]


def test_replicated_write_readable_from_all_copies(pair):
    def run(c):
        a = _assign(c, "?replication=001&collection=rep")
        up = _post(c, a, b"replicated!")
        vid = int(a["fid"].split(",")[0])
        assert wait_for(lambda: len(c.master.topology.lookup("rep", vid)) == 2)
        nodes = sorted(dn.url for dn in c.master.topology.lookup("rep", vid))
        return [up, [(u, http(f"http://{u}/{a['fid']}")[2].decode()) for u in nodes],
                sorted([a["url"]])]

    got = same(pair, both(pair, run, seed=3))
    assert got[0][0] == 201 and all(body == "replicated!" for _, body in got[1])


# --- TestGrpcPlane -----------------------------------------------------------


def test_lookup_and_statistics(pair):
    def run(c):
        a = _assign(c)
        vid = a["fid"].split(",")[0]
        with rpc.dial(f"127.0.0.1:{c.master.grpc_port}") as ch:
            stub = rpc.master_stub(ch)
            look = stub.LookupVolume(master_pb2.LookupVolumeRequest(vids=[vid, "x", "999"]))
            stats = stub.Statistics(master_pb2.StatisticsRequest())
            cols = stub.CollectionList(master_pb2.CollectionListRequest())
            conf = stub.GetMasterConfiguration(master_pb2.GetMasterConfigurationRequest())
        return [str(look), stats.total_size, list(cols.collections), str(conf)]

    got = same(pair, both(pair, run, seed=4))
    assert got[1] > 0 and "error" in got[0]


def test_vacuum_via_grpc(pair):
    def run(c):
        a = _assign(c, "?collection=vac")
        url = f"http://{a['url']}/{a['fid']}"
        _post(c, a, b"x" * 5000)
        http(url, method="DELETE")
        vid = int(a["fid"].split(",")[0])
        with c.grpc(c.index_of(a["url"])) as ch:
            stub = rpc.volume_stub(ch)
            before = stub.VacuumVolumeCheck(pb.VacuumVolumeCheckRequest(volume_id=vid))
            stub.VacuumVolumeCompact(pb.VacuumVolumeCompactRequest(volume_id=vid))
            stub.VacuumVolumeCommit(pb.VacuumVolumeCommitRequest(volume_id=vid))
            after = stub.VacuumVolumeCheck(pb.VacuumVolumeCheckRequest(volume_id=vid))
        return [before.garbage_ratio > 0, after.garbage_ratio]

    assert same(pair, both(pair, run, seed=5)) == [True, 0]


def test_submit_http(pair):
    payload = b"one-liner upload " * 100
    boundary = "testsubmitboundary"
    form = (f"--{boundary}\r\nContent-Disposition: form-data; name=\"file\"; "
            f"filename=\"hello.txt\"\r\nContent-Type: text/plain\r\n\r\n").encode() \
        + payload + f"\r\n--{boundary}--\r\n".encode()

    def run(c):
        out = []
        for body, headers in ((form, {"Content-Type": f"multipart/form-data; boundary={boundary}"}),
                              (b"rawbytes", {})):
            status, res = hjson(f"{c.m}/submit?collection=sub", data=body, headers=headers)
            out.append([status, res, http(f"http://{res['fileUrl']}")[2].decode()])
        return out

    got = same(pair, both(pair, run, seed=6))
    assert got[0][1]["size"] == len(payload) and got[0][2] == payload.decode()
    assert got[1][2] == "rawbytes"


def test_vol_vacuum_http(pair):
    def run(c):
        dead = _assign(c, "?collection=vh")
        _post(c, dead, b"g" * 50_000)
        keep = _assign(c, "?collection=vh")
        _post(c, keep, b"live")
        http(f"http://{dead['url']}/{dead['fid']}", method="DELETE")
        status, res = hjson(f"{c.m}/vol/vacuum?garbageThreshold=0.001")
        return [status, res["vacuumed"] >= 1, "Topology" in res,
                http(f"http://{keep['url']}/{keep['fid']}")[2].decode(),
                http(f"http://{dead['url']}/{dead['fid']}")[0]]

    assert same(pair, both(pair, run, seed=7)) == [200, True, True, "live", 404]


def test_batch_delete(pair):
    def run(c):
        by_server: dict = {}
        for _ in range(3):
            a = _assign(c, "?collection=bd")
            _post(c, a, b"bulk")
            by_server.setdefault(a["url"], []).append(a["fid"])
        out = []
        for url, fids in sorted(by_server.items()):
            with c.grpc(c.index_of(url)) as ch:
                resp = rpc.volume_stub(ch).BatchDelete(pb.BatchDeleteRequest(file_ids=fids))
            out.append([url, str(resp)])
        return out

    got = same(pair, both(pair, run, seed=8))
    assert all("status: 202" in r for _, r in got)


# --- TestEcLifecycle and TestDegradedParallelRead ----------------------------


def _wait_ec(c, vid, want=range(14)):
    def ready():
        locs = c.master.topology.lookup_ec_shards(vid)
        return locs is not None and all(locs.locations[i] for i in want)

    assert wait_for(ready), f"{c.side}: ec volume {vid} shards never all registered"


def _ec_files(vs, vid, collection):
    base = os.path.join(vs.store.locations[0].directory, f"{collection}_{vid}")
    return {ext: open(base + ext, "rb").read()
            for ext in [f".ec{i:02d}" for i in range(14)] + [".ecx"]
            if os.path.exists(base + ext)}


def test_encode_spread_degraded_read(pair):
    """Seal, generate, copy 7-13 to a peer, delete them and the volume at
    the source, then read through both servers (each gathers the other's
    shards); EC DELETE enforces the cookie. Shard files byte-equal."""
    payload = b"erasure coded payload " * 500

    def run(c):
        a = _assign(c, "?collection=ecc")
        _post(c, a, payload)
        vid = int(a["fid"].split(",")[0])
        src = c.index_of(a["url"])
        peer = next(i for i in range(3) if i != src)
        with c.grpc(src) as ch:
            stub = rpc.volume_stub(ch)
            stub.VolumeMarkReadonly(pb.VolumeMarkReadonlyRequest(volume_id=vid))
            stub.VolumeEcShardsGenerate(pb.VolumeEcShardsGenerateRequest(
                volume_id=vid, collection="ecc"))
        files = _ec_files(c.servers[src], vid, "ecc")
        with c.grpc(peer) as ch:
            rpc.volume_stub(ch).VolumeEcShardsCopy(pb.VolumeEcShardsCopyRequest(
                volume_id=vid, collection="ecc", shard_ids=list(range(7, 14)),
                copy_ecx_file=True, source_data_node=c.url(src)))
            rpc.volume_stub(ch).VolumeEcShardsMount(pb.VolumeEcShardsMountRequest(
                volume_id=vid, collection="ecc", shard_ids=list(range(7, 14))))
        copied = _ec_files(c.servers[peer], vid, "ecc")
        with c.grpc(src) as ch:
            stub = rpc.volume_stub(ch)
            stub.VolumeEcShardsDelete(pb.VolumeEcShardsDeleteRequest(
                volume_id=vid, collection="ecc", shard_ids=list(range(7, 14))))
            stub.VolumeEcShardsMount(pb.VolumeEcShardsMountRequest(
                volume_id=vid, collection="ecc", shard_ids=list(range(0, 7))))
            stub.VolumeDelete(pb.VolumeDeleteRequest(volume_id=vid))
        _wait_ec(c, vid)
        reads = [http(f"http://{c.url(i)}/{a['fid']}") for i in (src, peer)]
        vid_s, key_cookie = a["fid"].split(",")
        forged = http(f"http://{c.url(src)}/{vid_s},{key_cookie[:-8]}{'f' * 8}",
                      method="DELETE")[0]
        again = http(f"http://{c.url(src)}/{a['fid']}")
        digest = {k: hashlib.sha256(v).hexdigest() for k, v in files.items()}
        return [digest, sorted(copied), [[r[0], r[2] == payload] for r in reads], forged,
                again[0], again[2] == payload]

    got = same(pair, both(pair, run, seed=9))
    assert got[2] == [[200, True], [200, True]] and got[3] == 409 and got[4:] == [200, True]
    assert len(got[0]) == 15


def test_read_after_losing_shard_holder(pair, tmp_path_factory):
    """Shard 0 only on a sacrificial fourth server: healthy reads fetch
    it remotely; with that server stopped the read reconstructs shard
    0's interval from 13 survivors, and the dead location is forgotten."""
    payload = b"degraded parallel read " * 700
    root = str(tmp_path_factory.mktemp("sacrifice"))

    def run(c):
        a = _assign(c, "?collection=ecd")
        _post(c, a, payload)
        vid = int(a["fid"].split(",")[0])
        src = c.index_of(a["url"])
        peer = next(i for i in range(3) if i != src)
        extra = c.add(os.path.join(root, c.side), "rack0")
        x = len(c.servers) - 1
        with c.grpc(src) as ch:
            stub = rpc.volume_stub(ch)
            stub.VolumeMarkReadonly(pb.VolumeMarkReadonlyRequest(volume_id=vid))
            stub.VolumeEcShardsGenerate(pb.VolumeEcShardsGenerateRequest(
                volume_id=vid, collection="ecd"))
        for target, sids in ((x, [0]), (peer, list(range(10, 14)))):
            with c.grpc(target) as ch:
                rpc.volume_stub(ch).VolumeEcShardsCopy(pb.VolumeEcShardsCopyRequest(
                    volume_id=vid, collection="ecd", shard_ids=sids, copy_ecx_file=True,
                    source_data_node=c.url(src)))
                rpc.volume_stub(ch).VolumeEcShardsMount(pb.VolumeEcShardsMountRequest(
                    volume_id=vid, collection="ecd", shard_ids=sids))
        with c.grpc(src) as ch:
            stub = rpc.volume_stub(ch)
            stub.VolumeEcShardsDelete(pb.VolumeEcShardsDeleteRequest(
                volume_id=vid, collection="ecd", shard_ids=[0] + list(range(10, 14))))
            stub.VolumeEcShardsMount(pb.VolumeEcShardsMountRequest(
                volume_id=vid, collection="ecd", shard_ids=list(range(1, 10))))
            stub.VolumeDelete(pb.VolumeDeleteRequest(volume_id=vid))
        _wait_ec(c, vid)
        healthy = http(f"http://{c.url(src)}/{a['fid']}")
        ev = c.servers[src].store.find_ec_volume(vid)
        dead_url = c.url(x)
        with ev.shard_locations_lock:
            cached = any(dead_url in urls for urls in ev.shard_locations.values())
        c.stop_server(extra)
        degraded = http(f"http://{c.url(src)}/{a['fid']}")
        with ev.shard_locations_lock:
            forgotten = not any(dead_url in urls for urls in ev.shard_locations.values())
        return [healthy[0], healthy[2] == payload, cached, degraded[0],
                degraded[2] == payload, forgotten]

    assert same(pair, both(pair, run, seed=10)) == [200, True, True, 200, True, True]


# --- TestUrlAddressingForms --------------------------------------------------


def test_slash_extension_delta_and_conditional_forms(pair):
    def run(c):
        a = _assign(c)
        _post(c, a, b"formful payload")
        vid, fid = a["fid"].split(",")
        base = f"http://{a['url']}"
        out = [http(f"{base}/{p}")[::2] for p in (
            f"{vid},{fid}.txt", f"{vid}/{fid}", f"{vid}/{fid}.txt")]
        st, h, body = http(f"{base}/{vid}/{fid}/pretty%20name.txt")
        out.append([st, h.get("Content-Disposition"), h.get("Content-Type"), body])
        out.append(http(f"{base}/{vid}/{fid}/x.txt?dl=true")[1]["Content-Disposition"])
        lm = http(f"{base}/{vid},{fid}")[1]["Last-Modified"]
        out.append(http(f"{base}/{vid},{fid}", headers={"If-Modified-Since": lm})[0])
        out.append(http(f"{base}/{vid},{fid}", headers={
            "If-Modified-Since": "Mon, 01 Jan 2001 00:00:00 GMT"})[2])
        out.append(http(f"{base}/{vid},{fid}", headers={"ETag-MD5": "True"})[1]["ETag"])
        d = _assign(c, "?count=3")
        dvid, dfid = d["fid"].split(",")
        for i, body in enumerate([b"chunk zero", b"chunk one", b"chunk two"]):
            suffix = "" if i == 0 else f"_{i}"
            http(f"http://{d['url']}/{dvid},{dfid}{suffix}?ts={TS}", data=body)
        out.append([http(f"http://{d['url']}/{dvid},{dfid}{'' if i == 0 else f'_{i}'}")[2]
                    for i in range(3)])
        return [[x.decode("latin-1") if isinstance(x, bytes) else x for x in row]
                if isinstance(row, (list, tuple)) else
                (row.decode("latin-1") if isinstance(row, bytes) else row) for row in out]

    got = same(pair, both(pair, run, seed=11))
    assert got[0] == [200, "formful payload"] and got[5] == 304
    assert got[8] == ["chunk zero", "chunk one", "chunk two"]


def test_pairs_gzip_and_compression_round_trips(pair):
    plain = b"gzip me please " * 50
    packed = gzip.compress(plain, mtime=0)

    def run(c):
        a = _assign(c)
        st = _post(c, a, packed, headers={"Content-Type": "text/plain",
                                          "Content-Encoding": "gzip",
                                          "Seaweed-Origin": "unit-test"})
        url = f"http://{a['url']}/{a['fid']}"
        plain_get = http(url)
        gz_get = http(url, headers={"Accept-Encoding": "gzip"})
        b = _assign(c)
        text = b"compress me, I repeat myself " * 100
        st2 = _post(c, b, text, q=f"?filename=notes.txt&ts={TS}",
                    headers={"Content-Type": "text/plain"})
        p = _assign(c)
        st3 = _post(c, p, bytes(range(256)), headers={
            "Content-Type": "application/octet-stream", "Seaweed-Origin": "unit-test",
            "Seaweed-Tag": "42"})
        paired = http(f"http://{p['url']}/{p['fid']}")[1]
        return [st, plain_get[2] == plain, gz_get[1].get("Content-Encoding"),
                gz_get[2] == packed, st2, http(f"http://{b['url']}/{b['fid']}")[2] == text,
                st3, paired.get("Origin"), paired.get("Tag")]

    got = same(pair, both(pair, run, seed=12))
    assert got[1] and got[2] == "gzip" and got[3] and got[5]
    assert got[7:] == ["unit-test", "42"]


# --- TestMasterRedirectAndVolStatus and the UI -------------------------------


def test_fid_redirect_vol_status_and_ui(pair):
    def run(c):
        a = _assign(c)
        _post(c, a, bytes(range(256)))
        followed = http(f"{c.m}/{a['fid']}")
        missing = http(f"{c.m}/999,0123456789")[0]
        other = next(i for i in range(3) if c.url(i) != a["url"])
        opener = urllib.request.build_opener(type("NoRedirect", (urllib.request.HTTPRedirectHandler,), {
            "redirect_request": lambda *args, **kw: None}))
        try:
            opener.open(f"http://{c.url(other)}/{a['fid']}", timeout=10)
            redirected = None
        except urllib.error.HTTPError as e:
            redirected = [e.code, e.headers["Location"]]
        _, vols = hjson(f"{c.m}/vol/status")
        v = vols["Volumes"]
        rack = next(iter(next(iter(v["DataCenters"].values())).values()))
        node_vols = next(iter(rack.values()))
        ui = http(f"{c.m}/")[2].decode()
        return [followed[0], followed[2] == bytes(range(256)), missing, redirected,
                v["Max"] > 0, sorted(node_vols[0]) if node_vols else [],
                c.url(0) in ui and "Topology" in ui,
                "Volume Server" in http(f"http://{c.url(0)}/ui/index.html")[2].decode(),
                hjson(f"{c.m}/cluster/status")[1], sorted(hjson(f"{c.m}/cluster/health")[1]),
                hjson(f"{c.m}/repair/queue")[1]["Disabled"],
                hjson(f"{c.m}/cluster/tier")[1], hjson(f"{c.m}/cluster/alerts")[1]]

    got = same(pair, both(pair, run, seed=13))
    assert got[:3] == [200, True, 404] and got[3][0] == 302 and got[4] and got[6] and got[7]


# --- TestNodeLiveness --------------------------------------------------------


@pytest.mark.parametrize("side", SIDES)
def test_silent_node_swept_and_locations_dropped(side):
    cls, store = (RefMaster, ref_volume) if side == "ref" else (PortMaster, port_volume)
    master = cls(port=free_port(), volume_size_limit_mb=64, node_timeout=0.6)
    master.start()
    try:
        dn = master.topology.register_data_node(ip="127.0.0.1", port=65000, max_volumes=10)
        info_cls = (__import__("seaweedfs_tpu.storage.store", fromlist=["VolumeInfo"])
                    if side == "ref" else
                    __import__("seaweedfs_tpu_torch.storage.store", fromlist=["VolumeInfo"]))
        master.topology.sync_volumes(dn, [info_cls.VolumeInfo(
            id=5, size=0, collection="", file_count=1, delete_count=0,
            deleted_byte_count=0, read_only=False, replica_placement=0, version=3, ttl=0)])
        assert master.topology.lookup("", 5)
        dn.last_seen = time.time() - 10
        assert wait_for(lambda: not master.topology.data_nodes(), timeout=10)
        assert not master.topology.lookup("", 5)
    finally:
        master.stop()


def test_swept_node_reregisters_on_next_beat(tmp_path):
    master = PortMaster(port=free_port(), volume_size_limit_mb=64, node_timeout=0)
    master.start()
    try:
        dn = master.topology.register_data_node(ip="127.0.0.1", port=65001, max_volumes=10)
        master.topology.unregister_data_node(dn)
        assert dn.parent is None
        vs = _volume("port", str(tmp_path), master.port, "", heartbeat_interval=0.1,
                     max_volume_counts=[10])
        vs.start()
        try:
            assert wait_for(lambda: any(n.port == vs.port and n.parent is not None
                                        for n in master.topology.data_nodes()), timeout=15)
        finally:
            vs.stop()
        # the stream's end unregisters it
        assert wait_for(lambda: not master.topology.data_nodes(), timeout=15)
    finally:
        master.stop()


# --- the cluster phase's three-server spread, at a few MiB -------------------


def _payload(seed, nid, size):
    return np.random.default_rng((seed, nid)).bytes(size)


@pytest.fixture
def spread_pair(tmp_path, pinned_clock):
    clusters = {}
    try:
        for side in SIDES:
            clusters[side] = Cluster(side, str(tmp_path))
        yield clusters
    finally:
        for c in clusters.values():
            c.stop()


def test_three_server_spread_serve_and_rack_gather_rebuild(spread_pair, monkeypatch):
    """chip_smoke.py's cluster phase at 3 MiB: one volume grown on A
    through the master and filled through /dir/assign; generated on A;
    4-8 copied to B and 9-13 to C (with .ecx), mounted, and dropped with
    the volume at A; every needle read through B healthy, then with A
    stopped with the tile cache on and off (survivors from B and C);
    then B rebuilds 0-3 reading 9-13 off C. Bodies equal their payloads,
    B's rebuilt shards equal A's generated ones and the .ecc CRCs, and
    every shard file is byte-identical across the two packages."""
    sizes = [int(np.exp(np.random.default_rng(5).uniform(np.log(1024), np.log(256 << 10))))
             for _ in range(24)]

    def run(c):
        st, grown = hjson(f"{c.m}/vol/grow?collection=ec&count=1")
        a = next(i for i, vs in enumerate(c.servers) if vs.store.find_volume(1) is not None)
        b, cc = [i for i in range(3) if i != a]
        fids = []
        for nid, size in enumerate(sizes):
            asg = _assign(c, "?collection=ec")
            status, _ = _post(c, asg, _payload(5, nid, size))
            assert status == 201 and asg["url"] == c.url(a)
            fids.append(asg["fid"])
        vid = int(fids[0].split(",")[0])
        assert {int(f.split(",")[0]) for f in fids} == {vid}
        with c.grpc(a) as ch:
            stub = rpc.volume_stub(ch)
            stub.VolumeMarkReadonly(pb.VolumeMarkReadonlyRequest(volume_id=vid))
            stub.VolumeEcShardsGenerate(pb.VolumeEcShardsGenerateRequest(
                volume_id=vid, collection="ec"))
        generated = _ec_files(c.servers[a], vid, "ec")
        for target, sids in ((b, list(range(4, 9))), (cc, list(range(9, 14)))):
            with c.grpc(target) as ch:
                rpc.volume_stub(ch).VolumeEcShardsCopy(pb.VolumeEcShardsCopyRequest(
                    volume_id=vid, collection="ec", shard_ids=sids, copy_ecx_file=True,
                    source_data_node=c.url(a)))
                rpc.volume_stub(ch).VolumeEcShardsMount(pb.VolumeEcShardsMountRequest(
                    volume_id=vid, collection="ec", shard_ids=sids))
        with c.grpc(a) as ch:
            stub = rpc.volume_stub(ch)
            stub.VolumeEcShardsDelete(pb.VolumeEcShardsDeleteRequest(
                volume_id=vid, collection="ec", shard_ids=list(range(4, 14))))
            stub.VolumeEcShardsMount(pb.VolumeEcShardsMountRequest(
                volume_id=vid, collection="ec", shard_ids=list(range(0, 4))))
            stub.VolumeDelete(pb.VolumeDeleteRequest(volume_id=vid))
        _wait_ec(c, vid)

        def read_all():
            return [hashlib.sha256(http(f"http://{c.url(b)}/{f}")[2]).hexdigest() == hashlib.sha256(
                _payload(5, nid, sizes[nid])).hexdigest() for nid, f in enumerate(fids)]

        healthy = read_all()
        c.stop_server(c.servers[a])
        locs = lambda: c.master.topology.lookup_ec_shards(vid)  # noqa: E731
        assert wait_for(lambda: not any(locs().locations[i] for i in range(4)))
        cached = read_all()
        monkeypatch.setenv("WEED_EC_TILE_CACHE", "0")
        with c.grpc(b) as ch:
            stub = rpc.volume_stub(ch)
            stub.VolumeEcShardsUnmount(pb.VolumeEcShardsUnmountRequest(
                volume_id=vid, shard_ids=list(range(4, 9))))
            stub.VolumeEcShardsMount(pb.VolumeEcShardsMountRequest(
                volume_id=vid, collection="ec", shard_ids=list(range(4, 9))))
        exact = read_all()
        monkeypatch.delenv("WEED_EC_TILE_CACHE")
        with c.grpc(b) as ch:
            rebuilt = rpc.volume_stub(ch).VolumeEcShardsRebuild(
                pb.VolumeEcShardsRebuildRequest(volume_id=vid, collection="ec"))
        on_b = _ec_files(c.servers[b], vid, "ec")
        base_a = os.path.join(c.servers[a].store.locations[0].directory, f"ec_{vid}")
        with open(base_a + ".ecc", "rb") as f:
            ecc = f.read()
        return [st, grown, healthy, cached, exact, list(rebuilt.rebuilt_shard_ids),
                {k: hashlib.sha256(v).hexdigest() for k, v in generated.items()},
                {k: hashlib.sha256(v).hexdigest() for k, v in on_b.items()},
                all(on_b[f".ec{i:02d}"] == generated[f".ec{i:02d}"] for i in range(9)),
                hashlib.sha256(ecc).hexdigest()]

    got = same(spread_pair, both(spread_pair, run, seed=14))
    n = len(sizes)
    assert got[0] == 200 and got[2] == got[3] == got[4] == [True] * n
    assert got[5] == [0, 1, 2, 3] and got[8]
    from seaweedfs_tpu_torch.ec import ecc_sidecar
    from seaweedfs_tpu_torch.util.crc import crc32c

    # the rebuilt shards' CRCs equal the .ecc A's generate published
    c = spread_pair["port"]
    a = next(i for i, vs in enumerate(c.servers) if getattr(vs, "_stopped", False))
    b = next(i for i, vs in enumerate(c.servers) if not getattr(vs, "_stopped", False))
    shards = ecc_sidecar.load_sidecar(
        os.path.join(c.servers[a].store.locations[0].directory, "ec_1"))["shards"]
    for i in range(4):
        with open(os.path.join(c.servers[b].store.locations[0].directory,
                               f"ec_1.ec{i:02d}"), "rb") as f:
            assert shards[str(i)]["crc"] == crc32c(f.read()), i


# --- replica fan-out, all-or-error ------------------------------------------


def test_replica_failure_fails_the_write(tmp_path, pinned_clock, monkeypatch):
    """replication=001 with WEED_HANDOFF=0 on both packages. A write
    reaches both copies. With the peer stopped while the primary still
    has it among the volume's locations, the next write to that volume
    is answered 500 on both, never 201. Once the master has dropped the
    peer and the primary's location cache is gone, the reference's
    server acknowledges a write with the one copy left; the port answers
    500, as SeaweedFS's store_replicate.go does."""
    monkeypatch.setenv("WEED_HANDOFF", "0")
    clusters = {}
    try:
        for side in SIDES:
            clusters[side] = Cluster(side, str(tmp_path), racks=("rack0", "rack0"))

        def run(c):
            a = _assign(c, "?replication=001&collection=r")
            ok = _post(c, a, b"two copies")
            vid, key_cookie = a["fid"].split(",")
            assert wait_for(lambda: len(c.master.topology.lookup("r", int(vid))) == 2)
            primary = c.index_of(a["url"])
            c.stop_server(c.servers[1 - primary])
            second = dict(a, fid=f"{vid},{int(key_cookie[:-8], 16) + 1:x}{key_cookie[-8:]}")
            failed = _post(c, second, b"one copy is not enough")
            assert wait_for(lambda: len(c.master.topology.lookup("r", int(vid))) == 1)
            c.servers[primary]._location_cache.clear()
            third = dict(a, fid=f"{vid},{int(key_cookie[:-8], 16) + 2:x}{key_cookie[-8:]}")
            after_drop = _post(c, third, b"one copy is not enough")
            return [ok, failed[0], json.loads(failed[1])["error"].split(" ")[:2], after_drop]

        got = both(clusters, run, seed=15)
        for side in SIDES:
            assert got[side][0][0] == 201 and got[side][1] == 500, (side, got[side])
            assert got[side][2][0] == "replica", (side, got[side])
        assert clusters["ref"].norm(got["ref"][:3]) == clusters["port"].norm(got["port"][:3])
        assert got["ref"][3][0] == 201  # the reference's quirk
        assert got["port"][3][0] == 500 and "copy count [2]" in got["port"][3][1]
    finally:
        for c in clusters.values():
            c.stop()


# --- wire compatibility ------------------------------------------------------


@pytest.mark.parametrize("master_side,volume_side", [("ref", "port"), ("port", "ref")])
def test_volume_server_heartbeats_to_the_other_packages_master(
        master_side, volume_side, tmp_path, pinned_clock):
    """The pb2 modules are byte copies: a volume server of one package
    registers with the other package's master, gets a volume grown on
    it, takes a write, and both lookups find it."""
    c = Cluster(master_side, str(tmp_path), racks=("rack0",), volume_side=volume_side)
    try:
        assert type(c.servers[0]).__module__.startswith(
            "seaweedfs_tpu_torch" if volume_side == "port" else "seaweedfs_tpu.")
        a = _assign(c, "?collection=wire")
        assert a["url"] == c.url(0)
        assert _post(c, a, b"across packages")[0] == 201
        assert http(f"http://{a['url']}/{a['fid']}")[2] == b"across packages"
        vid = a["fid"].split(",")[0]
        status, look = hjson(f"{c.m}/dir/lookup?volumeId={vid}")
        assert status == 200 and look["locations"][0]["url"] == c.url(0)
        with rpc.dial(f"127.0.0.1:{c.master.grpc_port}") as ch:
            resp = rpc.master_stub(ch).LookupVolume(master_pb2.LookupVolumeRequest(vids=[vid]))
        assert resp.vid_locations[0].locations[0].url == c.url(0)
        assert wait_for(lambda: c.master.topology.data_nodes()[0].volumes)
    finally:
        c.stop()


@pytest.mark.parametrize("kw, item", [({"repair_interval": 60.0}, None),
                                      ({"tier_interval": 60.0}, None),
                                      ({"telemetry_interval": 15.0}, "ROADMAP item 13")],
                         ids=["repair", "tier", "telemetry"])
def test_unported_master_planes_raise(kw, item):
    """The master's planes that wait refuse up front, naming their item
    (the reference starts them); off, the master comes up. The repair
    and tier schedulers are ported (ROADMAP item 9): on, the master
    builds them as the reference's does."""
    if item is None:
        (name, value), = kw.items()
        plane = "repair" if name == "repair_interval" else "tier"
        port, ref = PortMaster(port=free_port(), **kw), RefMaster(port=free_port(), **kw)
        assert getattr(port, plane).interval == getattr(ref, plane).interval == value
        assert type(getattr(port, plane)).__name__ == type(getattr(ref, plane)).__name__
    else:
        with pytest.raises(NotImplementedError, match=item):
            PortMaster(port=free_port(), **kw)
    PortMaster(port=free_port(), **{k: 0.0 for k in kw})
