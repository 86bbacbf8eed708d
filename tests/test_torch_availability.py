"""Read availability through an EC cutover, on a reference cluster and on
a port cluster, on the CPU.

tests/test_migration.py's harness ported: each package's
`util/availability` boots its own cluster (`start_cluster`: a master and
three volume servers, racks rack0, rack1, rack0), writes a keyset with
replication=001 (`write_keyset`) and hammers it with `HammerReader`s
(`run_with_readers`) while the volume is erasure-coded underneath. The
pipeline runs over gRPC in the order the ec.encode shell command uses
(mark read-only on every replica, generate on the source, copy and mount
the shards, delete the moved ones, wait for the master to list all 14,
then delete the volume), and reads stay green on both packages; the same
steps with the volume deleted before any shard is mounted break reads on
both, so the harness can see an ordering fault. The tolerance is
equality of outcome: every body a reader gets equals what was written,
and both packages fail or pass alike.
"""

import time
import urllib.request

import pytest

import seaweedfs_tpu.util.availability as ref_availability
import seaweedfs_tpu_torch.util.availability as port_availability
from seaweedfs_tpu_torch.pb import master_pb2, rpc, volume_pb2 as pb

SIDES = ("ref", "port")
HELPERS = {"ref": ref_availability, "port": port_availability}


@pytest.fixture(scope="module")
def clusters(tmp_path_factory):
    out = {}
    try:
        for side in SIDES:
            dirs = [str(tmp_path_factory.mktemp(f"{side}-avail{i}")) for i in range(3)]
            kw = (dict(ec_codec="cpu") if side == "ref"
                  else dict(ec_codec="cuda", device="cpu"))
            out[side] = HELPERS[side].start_cluster(dirs, scrub_interval=0, **kw)
        yield out
    finally:
        for master, servers in out.values():
            for vs in servers:
                vs.stop()
            master.stop()


def _stub(vs):
    return rpc.dial(f"127.0.0.1:{vs.grpc_port}")


def _replicas(master, vid):
    with rpc.dial(f"127.0.0.1:{master.grpc_port}") as ch:
        resp = rpc.master_stub(ch).LookupVolume(master_pb2.LookupVolumeRequest(vids=[str(vid)]))
    return [loc.url for e in resp.vid_locations for loc in e.locations]


def _ec_shards_listed(master, vid) -> int:
    locs = master.topology.lookup_ec_shards(vid)
    return 0 if locs is None else sum(1 for loc in locs.locations if loc)


def _by_url(servers, url):
    return next(vs for vs in servers if f"127.0.0.1:{vs.port}" == url)


@pytest.mark.parametrize("side", SIDES)
def test_zero_failed_reads_through_encode_and_spread(clusters, side):
    """Reads through the master and straight at the source stay green
    while the volume is generated, spread over the three servers (the
    source keeps 0-4, the others get 5-9 and 10-13) and deleted once
    the master lists every shard; afterwards the EC shards alone serve."""
    master, servers = clusters[side]
    helpers = HELPERS[side]
    collection = f"mig-{side}"
    vid, keys, source_url = helpers.write_keyset(master.port, collection)
    replicas = _replicas(master, vid)
    source = _by_url(servers, source_url)
    others = [vs for vs in servers if vs is not source]
    plan = [(source, list(range(0, 5))), (others[0], list(range(5, 10))),
            (others[1], list(range(10, 14)))]

    def encode():
        for url in replicas:
            with _stub(_by_url(servers, url)) as ch:
                rpc.volume_stub(ch).VolumeMarkReadonly(
                    pb.VolumeMarkReadonlyRequest(volume_id=vid))
        with _stub(source) as ch:
            rpc.volume_stub(ch).VolumeEcShardsGenerate(
                pb.VolumeEcShardsGenerateRequest(volume_id=vid, collection=collection))
        for vs, sids in plan:
            with _stub(vs) as ch:
                stub = rpc.volume_stub(ch)
                if vs is not source:
                    stub.VolumeEcShardsCopy(pb.VolumeEcShardsCopyRequest(
                        volume_id=vid, collection=collection, shard_ids=sids,
                        copy_ecx_file=True, source_data_node=source_url))
                stub.VolumeEcShardsMount(pb.VolumeEcShardsMountRequest(
                    volume_id=vid, collection=collection, shard_ids=sids))
        with _stub(source) as ch:
            rpc.volume_stub(ch).VolumeEcShardsDelete(pb.VolumeEcShardsDeleteRequest(
                volume_id=vid, collection=collection, shard_ids=list(range(5, 14))))
        deadline = time.time() + 30
        while _ec_shards_listed(master, vid) < 14:
            assert time.time() < deadline, "the master never listed all 14 shards"
            time.sleep(0.05)
        for url in replicas:
            with _stub(_by_url(servers, url)) as ch:
                rpc.volume_stub(ch).VolumeDelete(pb.VolumeDeleteRequest(volume_id=vid))

    readers = [
        helpers.HammerReader(f"http://127.0.0.1:{master.port}", keys, "via-master"),
        helpers.HammerReader(f"http://{source_url}", keys, "direct-source"),
    ]
    helpers.run_with_readers(readers, encode)

    failures = [f for r in readers for f in r.failures]
    assert failures == [], failures[:10]
    for r in readers:
        assert r.reads >= 2 * len(keys), (r.label, r.reads)
    assert len(replicas) == 2
    assert all(vs.store.find_volume(vid) is None for vs in servers)
    assert _ec_shards_listed(master, vid) == 14


@pytest.mark.parametrize("side", SIDES)
def test_misordered_pipeline_breaks_reads(clusters, side):
    """Delete-before-mount must surface as reader failures on both
    packages (else the zero-failure test above proves nothing), and
    reads recover once the shards are mounted."""
    master, servers = clusters[side]
    helpers = HELPERS[side]
    collection = f"mis-{side}"
    vid, keys, source_url = helpers.write_keyset(master.port, collection, n=20)
    source = _by_url(servers, source_url)

    def misordered():
        with _stub(source) as ch:
            stub = rpc.volume_stub(ch)
            stub.VolumeMarkReadonly(pb.VolumeMarkReadonlyRequest(volume_id=vid))
            stub.VolumeEcShardsGenerate(
                pb.VolumeEcShardsGenerateRequest(volume_id=vid, collection=collection))
        # wrong: drop the volume from every replica before any shard is mounted
        for vs in servers:
            with _stub(vs) as ch:
                rpc.volume_stub(ch).VolumeDelete(pb.VolumeDeleteRequest(volume_id=vid))
        time.sleep(1.0)  # the unavailability window the readers see
        with _stub(source) as ch:
            rpc.volume_stub(ch).VolumeEcShardsMount(pb.VolumeEcShardsMountRequest(
                volume_id=vid, collection=collection, shard_ids=list(range(14))))

    readers = [helpers.HammerReader(f"http://127.0.0.1:{master.port}", keys, "via-master")]
    helpers.run_with_readers(readers, misordered, settle=1.0)

    assert readers[0].failures, "the misordered pipeline produced no read failures"
    fid, want = next(iter(keys.items()))
    with urllib.request.urlopen(f"http://127.0.0.1:{master.port}/{fid}", timeout=10) as r:
        assert r.status == 200 and r.read() == want
