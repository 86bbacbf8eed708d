"""The port's master control plane against seaweedfs_tpu's, on the CPU.

tests/test_topology.py's cases run on both packages (the `pkg` fixture),
and the same seeded heartbeat sequence goes into a reference and a port
`Topology`: after every step the tree and volume maps (JSON identity),
lookups, EC shard maps and writable lists must be equal, and so must
`pick_for_write` picks and growth placements drawn with the same seed
(`random` is one global RNG for both packages, so it is re-seeded
before each call on each side). The sequencers hand out the same ids.
Tolerance: equality of the results, as node urls and ints.
"""

import json
import random
import types

import pytest

import seaweedfs_tpu.sequence as ref_sequence
import seaweedfs_tpu.storage.replica_placement as ref_rp
import seaweedfs_tpu.storage.store as ref_store
import seaweedfs_tpu.topology as ref_topology
import seaweedfs_tpu.topology.volume_growth as ref_growth
import seaweedfs_tpu_torch.sequence as port_sequence
import seaweedfs_tpu_torch.storage.replica_placement as port_rp
import seaweedfs_tpu_torch.storage.store as port_store
import seaweedfs_tpu_torch.topology as port_topology
import seaweedfs_tpu_torch.topology.volume_growth as port_growth
from seaweedfs_tpu.cluster.health import HealthPlane as RefHealth
from seaweedfs_tpu_torch.cluster.health import HealthPlane as PortHealth

PKGS = {
    "ref": types.SimpleNamespace(
        Topology=ref_topology.Topology, VolumeInfo=ref_store.VolumeInfo,
        EcShardInfo=ref_store.EcShardInfo, ReplicaPlacement=ref_rp.ReplicaPlacement,
        MemorySequencer=ref_sequence.MemorySequencer,
        FileSequencer=ref_sequence.FileSequencer,
        find_empty_slots_for_one_volume=ref_growth.find_empty_slots_for_one_volume,
        find_volume_count=ref_growth.find_volume_count, HealthPlane=RefHealth),
    "port": types.SimpleNamespace(
        Topology=port_topology.Topology, VolumeInfo=port_store.VolumeInfo,
        EcShardInfo=port_store.EcShardInfo, ReplicaPlacement=port_rp.ReplicaPlacement,
        MemorySequencer=port_sequence.MemorySequencer,
        FileSequencer=port_sequence.FileSequencer,
        find_empty_slots_for_one_volume=port_growth.find_empty_slots_for_one_volume,
        find_volume_count=port_growth.find_volume_count, HealthPlane=PortHealth),
}


@pytest.fixture(params=["ref", "port"])
def pkg(request):
    return PKGS[request.param]


def make_volume_info(p, vid, collection="", size=1000, rp=0, read_only=False, ttl=0):
    return p.VolumeInfo(
        id=vid, size=size, collection=collection, file_count=1, delete_count=0,
        deleted_byte_count=0, read_only=read_only, replica_placement=rp,
        version=3, ttl=ttl,
    )


def build_topology(p, n_dcs=2, racks_per_dc=2, nodes_per_rack=3, max_volumes=8):
    topo = p.Topology(volume_size_limit=10_000)
    for d in range(n_dcs):
        for r in range(racks_per_dc):
            for n in range(nodes_per_rack):
                topo.register_data_node(
                    ip=f"10.{d}.{r}.{n}", port=8080, data_center=f"dc{d}",
                    rack=f"rack{d}-{r}", max_volumes=max_volumes,
                )
    return topo


# --- tests/test_topology.py, on both packages ------------------------------


class TestTree:
    def test_counts_aggregate(self, pkg):
        topo = build_topology(pkg)
        assert topo.max_volume_count() == 2 * 2 * 3 * 8
        assert topo.volume_count() == 0
        assert topo.free_space() == 96
        dn = topo.data_nodes()[0]
        topo.sync_volumes(dn, [make_volume_info(pkg, 1), make_volume_info(pkg, 2)])
        assert topo.volume_count() == 2
        assert topo.free_space() == 94

    def test_heartbeat_sync_add_remove(self, pkg):
        topo = build_topology(pkg)
        dn = topo.data_nodes()[0]
        new, deleted = topo.sync_volumes(dn, [make_volume_info(pkg, 1)])
        assert [v.id for v in new] == [1]
        new, deleted = topo.sync_volumes(dn, [make_volume_info(pkg, 2)])
        assert [v.id for v in new] == [2]
        assert [v.id for v in deleted] == [1]
        assert topo.lookup("", 2) == [dn]
        assert topo.lookup("", 1) == []

    def test_unregister_node_drops_volumes(self, pkg):
        topo = build_topology(pkg)
        dn = topo.data_nodes()[0]
        topo.sync_volumes(dn, [make_volume_info(pkg, 1)])
        topo.unregister_data_node(dn)
        assert topo.lookup("", 1) == []
        assert dn.id not in [n.id for n in topo.data_nodes()]


class TestLayout:
    def test_pick_for_write_and_lookup(self, pkg):
        topo = build_topology(pkg)
        nodes = topo.data_nodes()
        topo.sync_volumes(nodes[0], [make_volume_info(pkg, 1)])
        topo.sync_volumes(nodes[1], [make_volume_info(pkg, 1)])
        vid, count, locations = topo.pick_for_write("", "000", "", 1)
        assert vid == 1
        assert len(locations) == 2
        assert set(topo.lookup("", 1)) == {nodes[0], nodes[1]}

    def test_readonly_not_writable(self, pkg):
        topo = build_topology(pkg)
        dn = topo.data_nodes()[0]
        topo.sync_volumes(dn, [make_volume_info(pkg, 1, read_only=True)])
        with pytest.raises(ValueError, match="no writable"):
            topo.pick_for_write("", "000", "", 1)

    def test_oversized_not_writable(self, pkg):
        topo = build_topology(pkg)
        dn = topo.data_nodes()[0]
        topo.sync_volumes(dn, [make_volume_info(pkg, 1, size=20_000)])
        with pytest.raises(ValueError, match="no writable"):
            topo.pick_for_write("", "000", "", 1)

    def test_dc_affinity(self, pkg):
        topo = build_topology(pkg)
        nodes_dc0 = [n for n in topo.data_nodes() if n.get_data_center().id == "dc0"]
        nodes_dc1 = [n for n in topo.data_nodes() if n.get_data_center().id == "dc1"]
        topo.sync_volumes(nodes_dc0[0], [make_volume_info(pkg, 1)])
        topo.sync_volumes(nodes_dc1[0], [make_volume_info(pkg, 2)])
        for _ in range(10):
            vid, _, _ = topo.pick_for_write("", "000", "", 1, data_center="dc1")
            assert vid == 2

    def test_collections_isolated(self, pkg):
        topo = build_topology(pkg)
        dn = topo.data_nodes()[0]
        topo.sync_volumes(dn, [make_volume_info(pkg, 1, collection="a")])
        assert topo.lookup("a", 1) == [dn]
        assert topo.lookup("b", 1) == []
        assert "a" in topo.collections()


class TestGrowth:
    def test_find_volume_count(self, pkg):
        assert [pkg.find_volume_count(n) for n in (1, 2, 3, 4)] == [7, 6, 3, 1]

    @pytest.mark.parametrize("rp_str,expect_n", [("000", 1), ("001", 2), ("010", 2),
                                                 ("100", 2), ("012", 4), ("112", 5)])
    def test_placement_satisfies_rp(self, pkg, rp_str, expect_n):
        topo = build_topology(pkg, n_dcs=3, racks_per_dc=3, nodes_per_rack=4)
        rp = pkg.ReplicaPlacement.parse(rp_str)
        rng = random.Random(0)
        for _ in range(20):
            servers = pkg.find_empty_slots_for_one_volume(topo, rp, rng=rng)
            assert len(servers) == expect_n == rp.copy_count
            dcs = {s.get_data_center().id for s in servers}
            racks = {(s.get_data_center().id, s.get_rack().id) for s in servers}
            assert len(dcs) == rp.diff_data_center_count + 1
            assert len(racks) == rp.diff_data_center_count + rp.diff_rack_count + 1
            assert len(set(s.id for s in servers)) == len(servers)

    def test_placement_fails_when_impossible(self, pkg):
        topo = build_topology(pkg, n_dcs=1, racks_per_dc=1, nodes_per_rack=2)
        with pytest.raises(ValueError):
            pkg.find_empty_slots_for_one_volume(topo, pkg.ReplicaPlacement.parse("100"))

    def test_placement_respects_capacity(self, pkg):
        topo = build_topology(pkg, n_dcs=1, racks_per_dc=1, nodes_per_rack=4, max_volumes=1)
        dn = topo.data_nodes()[0]
        topo.sync_volumes(dn, [make_volume_info(pkg, 1)])  # node full
        rp = pkg.ReplicaPlacement.parse("002")
        rng = random.Random(3)
        for _ in range(10):
            assert dn not in pkg.find_empty_slots_for_one_volume(topo, rp, rng=rng)


class TestEcRegistry:
    def test_register_lookup_unregister(self, pkg):
        topo = build_topology(pkg)
        dn0, dn1 = topo.data_nodes()[:2]
        topo.sync_ec_shards(dn0, [pkg.EcShardInfo(5, "", 0b0000000001111111)])
        topo.sync_ec_shards(dn1, [pkg.EcShardInfo(5, "", 0b0011111110000000)])
        locs = topo.lookup_ec_shards(5)
        assert locs.locations[0] == [dn0]
        assert locs.locations[13] == [dn1]
        assert set(topo.lookup("", 5)) == {dn0, dn1}
        topo.sync_ec_shards(dn0, [])
        assert topo.lookup_ec_shards(5).locations[0] == []

    def test_shard_bits_shrink_removes_stale_locations(self, pkg):
        topo = build_topology(pkg)
        dn = topo.data_nodes()[0]
        topo.sync_ec_shards(dn, [pkg.EcShardInfo(5, "", 0b11)])
        topo.sync_ec_shards(dn, [pkg.EcShardInfo(5, "", 0b01)])
        locs = topo.lookup_ec_shards(5)
        assert locs.locations[0] == [dn]
        assert locs.locations[1] == []

    def test_ec_counts_in_free_space(self, pkg):
        topo = build_topology(pkg, n_dcs=1, racks_per_dc=1, nodes_per_rack=1, max_volumes=10)
        dn = topo.data_nodes()[0]
        before = topo.free_space()
        topo.sync_ec_shards(dn, [pkg.EcShardInfo(5, "", (1 << 14) - 1)])
        assert topo.free_space() == before - 1


class TestSequencer:
    def test_ranges(self, pkg):
        seq = pkg.MemorySequencer()
        assert [seq.next_file_id(1), seq.next_file_id(5), seq.next_file_id(1)] == [1, 2, 7]

    def test_set_max_equal_advances(self, pkg):
        seq = pkg.MemorySequencer()
        assert seq.peek() == 1
        seq.set_max(1)
        assert seq.next_file_id(1) == 2

    def test_set_max(self, pkg):
        seq = pkg.MemorySequencer()
        seq.set_max(100)
        assert seq.next_file_id(1) == 101
        seq.set_max(50)
        assert seq.next_file_id(1) == 102

    def test_id_generator_adjusts_from_heartbeat(self, pkg):
        topo = pkg.Topology()
        dn = topo.register_data_node("1.1.1.1", 80)
        topo.sync_volumes(dn, [make_volume_info(pkg, 41)])
        assert topo.next_volume_id() == 42


# --- the same inputs through both packages ---------------------------------


def _urls(nodes) -> list[str]:
    return [dn.url for dn in nodes]


def _state(topo) -> dict:
    """Everything a master answers from its Topology, as plain data."""
    layouts = {
        "|".join(k): {"writables": list(lay.writables),
                      "locations": {v: _urls(n) for v, n in sorted(lay.vid2location.items())}}
        for k, lay in sorted(topo._layouts.items())
    }
    ec = {vid: [_urls(n) for n in locs.locations]
          for vid, locs in sorted(topo.ec_shard_map.items())}
    return {"map": json.dumps(topo.to_map(), sort_keys=True),
            "volume_map": json.dumps(topo.to_volume_map(), sort_keys=True),
            "layouts": layouts, "ec": ec, "free": topo.free_space(),
            "max_vid": topo.id_gen.peek(), "collections": sorted(topo.collections())}


def _heartbeats(seed: int, steps: int = 120):
    """A seeded sequence of heartbeat events over 12 nodes on 2 DCs x 2
    racks: full syncs, delta syncs, EC shard syncs and node departures."""
    rng = random.Random(seed)
    nodes = [(f"10.{d}.{r}.{n}", 8080 + n, f"dc{d}", f"rack{d}-{r}")
             for d in range(2) for r in range(2) for n in range(3)]
    for _ in range(steps):
        node = rng.choice(nodes)
        kind = rng.choice(("full", "full", "delta", "ec", "leave"))
        vols = [(rng.randrange(1, 30), rng.choice(("", "a", "b")),
                 rng.choice((500, 5000, 20_000)), rng.choice((0, 0, 1, 10)),
                 rng.random() < 0.15) for _ in range(rng.randrange(0, 5))]
        ec = [(rng.randrange(30, 36), rng.randrange(1, 1 << 14))
              for _ in range(rng.randrange(0, 3))]
        yield node, kind, vols, ec


def _apply(p, topo, event) -> None:
    (ip, port, dc, rack), kind, vols, ec = event
    dn = topo.register_data_node(ip=ip, port=port, data_center=dc, rack=rack,
                                 max_volumes=10)
    infos = [p.VolumeInfo(id=v, size=size, collection=c, file_count=1, delete_count=0,
                          deleted_byte_count=0, read_only=ro, replica_placement=rp,
                          version=3, ttl=0)
             for v, c, size, rp, ro in vols]
    if kind == "full":
        topo.sync_volumes(dn, infos)
    elif kind == "delta":
        topo.delta_sync_volumes(dn, infos, infos[:1] if len(infos) > 2 else [])
    elif kind == "ec":
        topo.sync_ec_shards(dn, [p.EcShardInfo(v, "", bits) for v, bits in ec])
    else:
        topo.unregister_data_node(dn)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_same_heartbeats_same_topology(seed):
    """Every step of the sequence leaves both topologies answering alike."""
    topos = {k: PKGS[k].Topology(volume_size_limit=10_000) for k in PKGS}
    for step, event in enumerate(_heartbeats(seed)):
        for k, topo in topos.items():
            _apply(PKGS[k], topo, event)
        a, b = _state(topos["ref"]), _state(topos["port"])
        assert a == b, (seed, step)
        for vid in range(1, 36):
            for c in ("", "a", "b"):
                assert _urls(topos["ref"].lookup(c, vid)) == _urls(
                    topos["port"].lookup(c, vid)), (seed, step, c, vid)


@pytest.mark.parametrize("policy", ["p2c", "random"])
@pytest.mark.parametrize("data_center", ["", "dc1"])
def test_same_picks_under_one_seed(policy, data_center):
    """pick_for_write over equal topologies, with the global RNG seeded
    alike before each side's call, picks the same volume and nodes; so
    does the health-aware pick with one node's state made suspect."""
    topos = {k: PKGS[k].Topology(volume_size_limit=10_000) for k in PKGS}
    for event in _heartbeats(7, steps=80):
        for k, topo in topos.items():
            _apply(PKGS[k], topo, event)
    health = {k: PKGS[k].HealthPlane() for k in PKGS}
    for k in PKGS:
        health[k].request_drain(topos[k].data_nodes()[0].url)
    for rp in ("000", "001", "010", "100"):
        for c in ("", "a", "b"):
            for draw in range(12):
                got = {}
                for k, topo in topos.items():
                    random.seed((draw, rp, c).__hash__() & 0xFFFF)
                    try:
                        vid, count, nodes = topo.pick_for_write(
                            c, rp, "", 1, data_center=data_center, policy=policy,
                            health=health[k] if draw % 2 else None)
                        got[k] = (vid, count, _urls(nodes))
                    except ValueError as e:
                        got[k] = str(e)
                assert got["ref"] == got["port"], (rp, c, draw)


@pytest.mark.parametrize("rp_str", ["000", "001", "010", "100", "011", "002"])
def test_same_growth_placements_under_one_seed(rp_str):
    """find_empty_slots_for_one_volume with equal Random seeds places a
    volume on the same nodes in both packages, and both refuse alike."""
    topos = {k: build_topology(PKGS[k], n_dcs=2, racks_per_dc=2, nodes_per_rack=3,
                               max_volumes=3) for k in PKGS}
    for k, topo in topos.items():
        for i, dn in enumerate(topo.data_nodes()[:5]):
            topo.sync_volumes(dn, [make_volume_info(PKGS[k], v) for v in range(i)])
    for seed in range(20):
        got = {}
        for k, topo in topos.items():
            rp = PKGS[k].ReplicaPlacement.parse(rp_str)
            try:
                got[k] = _urls(PKGS[k].find_empty_slots_for_one_volume(
                    topo, rp, rng=random.Random(seed)))
            except ValueError as e:
                got[k] = str(e)
            random.seed(seed)
            try:
                got[k + "_dc"] = _urls(topo.find_empty_slots(rp, data_center="dc0"))
            except ValueError as e:
                got[k + "_dc"] = str(e)
        assert got["ref"] == got["port"] and got["ref_dc"] == got["port_dc"], seed


def test_sequencers_hand_out_the_same_ids(tmp_path):
    """Memory and file-backed sequencers, the same calls on both sides,
    the file one reopened after a restart; and the etcd sequencer, with
    no etcd answering, raises the reference's guidance on both sides
    (its ids are held against the reference's in tests/test_torch_etcd.py)."""
    for kind in ("MemorySequencer", "FileSequencer"):
        seqs, got = {}, {}
        for k in PKGS:
            args = (str(tmp_path / f"{k}-{kind}.txt"),) if kind == "FileSequencer" else ()
            seqs[k] = getattr(PKGS[k], kind)(*args)
            got[k] = []
            for step in range(50):
                if step % 7 == 3:
                    seqs[k].set_max(step * 40)
                got[k].append(seqs[k].next_file_id(step % 5 + 1))
            if kind == "FileSequencer":
                got[k].append(getattr(PKGS[k], kind)(*args).next_file_id())
            got[k].append(seqs[k].peek())
        assert got["ref"] == got["port"], kind
    from seaweedfs_tpu_torch.util.availability import free_port

    dead = f"127.0.0.1:{free_port()}"
    errors = {}
    for k, seq_mod in (("ref", ref_sequence), ("port", port_sequence)):
        with pytest.raises(RuntimeError, match="cannot reach") as ei:
            seq_mod.EtcdSequencer(dead)
        errors[k] = str(ei.value)
    assert errors["ref"] == errors["port"]
