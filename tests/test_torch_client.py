"""The port's master client and vid map against seaweedfs_tpu's, on the CPU.

tests/test_client.py::TestMasterClient ported: each package's
MasterClient against a port cluster (a master and two volume servers,
ec_codec="cuda" on device="cpu"), following the KeepConnected stream
into its VidMap and falling back to the unary LookupVolume; the two
clients must map the same volume to the same locations. The VidMap
cases feed both packages' maps the same seeded sequence of adds and
deletes and the same breaker failures, and require equal lookups. The
tolerance is equality.
"""

import time
import urllib.request

import numpy as np
import pytest

from seaweedfs_tpu.client import masterclient as ref_mc
from seaweedfs_tpu.client import vid_map as ref_vm
from seaweedfs_tpu_torch.client import masterclient as port_mc
from seaweedfs_tpu_torch.client import operation as op
from seaweedfs_tpu_torch.client import vid_map as port_vm
from seaweedfs_tpu_torch.server.master_server import MasterServer
from seaweedfs_tpu_torch.server.volume_server import VolumeServer
from seaweedfs_tpu_torch.util.availability import free_port

CLIENTS = {"ref": ref_mc.MasterClient, "port": port_mc.MasterClient}


def _wait(cond, timeout=30.0):
    deadline = time.time() + timeout
    while time.time() < deadline:
        if cond():
            return True
        time.sleep(0.05)
    return False


@pytest.fixture(scope="module")
def cluster(tmp_path_factory):
    master = MasterServer(port=free_port(), volume_size_limit_mb=64)
    master.start()
    servers = []
    try:
        for i in range(2):
            vs = VolumeServer([str(tmp_path_factory.mktemp(f"mcvs{i}"))], port=free_port(),
                              master=f"127.0.0.1:{master.port}", heartbeat_interval=0.2,
                              max_volume_counts=[100], ec_codec="cuda", device="cpu",
                              scrub_interval=0)
            vs.start()
            servers.append(vs)
        assert _wait(lambda: len(master.topology.data_nodes()) == 2)
        yield master
    finally:
        for vs in servers:
            vs.stop()
        master.stop()


def _write(master, data: bytes):
    ar = op.assign(f"127.0.0.1:{master.port}")
    assert not op.upload(f"{ar.url}/{ar.fid}", data).error
    return ar


def _get(url: str) -> bytes:
    with urllib.request.urlopen(url, timeout=10) as r:
        return r.read()


def test_keepconnected_map_and_lookup(cluster):
    ar = _write(cluster, b"mc")
    vid = int(ar.fid.split(",")[0])
    found = {}
    for side, cls in CLIENTS.items():
        mc = cls(f"test-client-{side}", [f"127.0.0.1:{cluster.port}"])
        mc.start()
        try:
            assert mc.wait_until_connected(10), side
            assert _wait(lambda: mc.vid_map.lookup(vid)), side
            urls = mc.lookup_file_id(ar.fid)
            assert urls and _get(urls[0]) == b"mc", side
            found[side] = sorted((l.url, l.public_url) for l in mc.vid_map.lookup(vid))
        finally:
            mc.stop()
    assert found["ref"] == found["port"]


def test_stop_ends_the_port_clients_thread(cluster):
    mc = port_mc.MasterClient("stopper", [f"127.0.0.1:{cluster.port}"])
    mc.start()
    assert mc.wait_until_connected(10)
    mc.stop()
    assert not mc._thread.is_alive()


def test_unary_refresh_fallback(cluster):
    ar = _write(cluster, b"rf")
    got = {}
    for side, cls in CLIENTS.items():
        mc = cls(f"lazy-client-{side}", [f"127.0.0.1:{cluster.port}"])
        # no start(): the stream never connects, so the lookup must fall
        # back to the unary LookupVolume
        mc.current_master = f"127.0.0.1:{cluster.port}"
        urls = mc.lookup_file_id(ar.fid)
        assert urls and _get(urls[0]) == b"rf", side
        got[side] = sorted(u.partition("://")[2] for u in urls)
    assert got["ref"] == got["port"]


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_vid_map_follows_the_same_deltas(seed):
    """Seeded add/delete/delete_server sequences; after each step both
    maps hold the same locations, and lookups rotate the same way."""
    rng = np.random.default_rng(seed)
    maps = {"ref": (ref_vm, ref_vm.VidMap()), "port": (port_vm, port_vm.VidMap())}
    urls = [f"10.0.0.{i}:8080" for i in range(5)]
    for _ in range(200):
        op_kind = int(rng.integers(0, 10))
        vid = int(rng.integers(1, 8))
        url = urls[int(rng.integers(0, len(urls)))]
        for mod, m in maps.values():
            if op_kind < 6:
                m.add_location(vid, mod.Location(url, "pub-" + url))
            elif op_kind < 9:
                m.delete_location(vid, url)
            else:
                m.delete_server(url)
        views = {}
        for side, (mod, m) in maps.items():
            views[side] = (len(m), [[(l.url, l.public_url) for l in m.lookup(v)]
                                    for v in range(1, 8)])
        assert views["ref"] == views["port"]
    for v in range(1, 8):
        fid = f"{v},0a0b0c0d0e"
        got = {}
        for side, (_, m) in maps.items():
            try:
                got[side] = [m.lookup_file_id(fid) for _ in range(3)]
            except KeyError:
                got[side] = "missing"
        assert got["ref"] == got["port"], v
    for _, m in maps.values():
        with pytest.raises(ValueError):
            m.lookup_file_id("not-a-fid")


def test_breaker_demotes_a_failed_replica_in_both(monkeypatch):
    now = time.time()
    orders = {}
    for side, mod in (("ref", ref_vm), ("port", port_vm)):
        monkeypatch.setattr(mod, "_broken_until", {})
        m = mod.VidMap()
        m.add_location(7, mod.Location("h1:80", "h1:80"))
        m.add_location(7, mod.Location("h2:80", "h2:80"))
        mod.note_failure("h1:80", now=now)
        firsts = [m.lookup_file_id("7,00000007")[0] for _ in range(4)]
        assert firsts == ["http://h2:80/7,00000007"] * 4, side
        mod.note_failure("h2:80", now=now)
        # every candidate penalized: the original order stands
        order = mod.order_by_health(["h1:80/7,x", "h2:80/7,x"])
        mod.note_success("h1:80")
        orders[side] = (order, mod.penalized("h1:80"), mod.penalized("h2:80"))
    assert orders["ref"] == orders["port"] == (
        ["h1:80/7,x", "h2:80/7,x"], False, True)
