"""The port's admin shell against seaweedfs_tpu's, on the CPU.

tests/test_shell.py ported. The planner classes run on in-memory EcNode
and TopologyDump state with apply=False, the same state given to both
packages' planners, which must give the same plan and leave the same
state (plus seeded random states). TestShellPipeline and TestEcBatchVerb
drive a port cluster (a master and three volume servers on two racks,
ec_codec="cuda" on device="cpu": the kernels' plain versions) through
the port's shell: ec.encode, ec.rebuild, ec.balance, ec.batch and
ec.rebuild.batch, the volume and collection verbs and the maintenance
runner. Shard bytes must equal the reference encoder's
(`ec_files.write_ec_files`, `new_encoder(backend="cpu")`) on a snapshot
of each .dat. One mixed case runs the reference's shell against a port
cluster and the port's shell against a reference cluster, with the same
writes on both, and requires the same shard bytes. The tolerance is
equality. TestEcVerify runs the port's ec.verify (K1's plain version)
and the reference's on the same shards of a port cluster, clean and
with a flipped parity or data byte, and requires the same counts and
the same report. TestFsCommands waits for the filer (ROADMAP item 11);
its verbs are held to raise naming that item.
"""

import io
import json
import os
import random
import shutil
import time
import urllib.request

import numpy as np
import pytest

from seaweedfs_tpu.ec import ec_files as ref_files
from seaweedfs_tpu.ec.codec import new_encoder as ref_new_encoder
from seaweedfs_tpu.shell import COMMANDS as REF_COMMANDS
from seaweedfs_tpu.shell import command_env as ref_env
from seaweedfs_tpu.shell import commands as ref_commands
from seaweedfs_tpu.shell import ec_common as ref_ec
from seaweedfs_tpu_torch.server.master_server import MasterServer
from seaweedfs_tpu_torch.server.volume_server import VolumeServer
from seaweedfs_tpu_torch.shell import COMMANDS, CommandEnv, run_command
from seaweedfs_tpu_torch.shell import command_env as port_env
from seaweedfs_tpu_torch.shell import commands as port_commands
from seaweedfs_tpu_torch.shell import ec_common as port_ec
from seaweedfs_tpu_torch.util.availability import free_port
from tests.test_torch_cluster import Cluster, pinned_clock  # noqa: F401 (fixture)

PKGS = {
    "ref": (ref_ec, ref_commands, ref_env),
    "port": (port_ec, port_commands, port_env),
}
SHARD_EXTS = [f".ec{i:02d}" for i in range(14)]


# --- planners -----------------------------------------------------------------


def _ec_nodes(ec, spec):
    """spec: [(url, rack, free, {vid: [sid, ...]})]"""
    nodes = []
    for url, rack, free, shards in spec:
        n = ec.EcNode(url=url, dc="dc1", rack=rack, free_ec_slot=free)
        for vid, sids in shards.items():
            n.ec_shards[vid] = ("", ec.ids_to_shard_bits(sids))
            n.free_ec_slot -= len(sids)
        nodes.append(n)
    return nodes


def _state(nodes):
    return [(n.url, n.rack, n.free_ec_slot, sorted(n.ec_shards.items())) for n in nodes]


def _plan_both(spec, plan):
    """plan(ec, commands, env, nodes) on each package's nodes; the
    results and the nodes' states afterwards, which must agree."""
    got = {}
    for side, (ec, cmds, env_mod) in PKGS.items():
        nodes = _ec_nodes(ec, spec)
        env = env_mod.CommandEnv(["127.0.0.1:0"])  # apply=False never dials
        got[side] = (plan(ec, cmds, env, nodes), _state(nodes))
    assert got["ref"] == got["port"]
    return got["port"]


class TestEcPlanners:
    @pytest.mark.parametrize("ids", [[0, 3, 13], [], list(range(14)), [5]])
    def test_shard_bits_roundtrip(self, ids):
        for ec, _, _ in PKGS.values():
            assert ec.shard_bits_to_ids(ec.ids_to_shard_bits(ids)) == ids
        assert port_ec.ids_to_shard_bits(ids) == ref_ec.ids_to_shard_bits(ids)

    def test_balanced_distribution_prefers_free(self):
        spec = [("a:1", "r1", 100, {}), ("b:1", "r1", 10, {}), ("c:1", "r2", 1, {})]
        picked, _ = _plan_both(
            spec, lambda ec, c, e, nodes: [n.url for n in ec.balanced_ec_distribution(nodes)])
        assert len(picked) == 14
        counts = {u: picked.count(u) for u in ("a:1", "b:1", "c:1")}
        assert counts["a:1"] >= counts["b:1"] >= counts["c:1"]

    def test_balanced_distribution_insufficient_slots(self):
        picked, _ = _plan_both([("a:1", "r1", 5, {})],
                               lambda ec, c, e, nodes: ec.balanced_ec_distribution(nodes))
        assert picked == []

    def test_dedup_removes_extra_copies(self):
        spec = [("a:1", "r1", 100, {5: [0, 1]}), ("b:1", "r1", 100, {5: [1, 2]})]
        removed, state = _plan_both(
            spec, lambda ec, c, e, nodes: ec.dedup_ec_shards(e, nodes, 5, apply=False))
        assert removed == 1
        holders = [s for s in state if any(
            vid == 5 and bits & 2 for vid, (_, bits) in s[3])]
        assert len(holders) == 1

    def test_balance_across_racks(self):
        spec = [("a:1", "r1", 100, {7: list(range(14))}), ("b:1", "r2", 100, {})]
        moves, state = _plan_both(
            spec, lambda ec, c, e, nodes: ec.balance_across_racks(e, nodes, 7, apply=False))
        assert moves == 7
        assert bin(dict(state[1][3])[7][1]).count("1") == 7

    def test_balance_within_racks(self):
        spec = [("a:1", "r1", 100, {9: list(range(10))}), ("b:1", "r1", 100, {})]
        moves, state = _plan_both(
            spec, lambda ec, c, e, nodes: ec.balance_within_racks(e, nodes, 9, apply=False))
        assert moves > 0
        assert [bin(dict(s[3])[9][1]).count("1") for s in state] == [5, 5]

    def test_balance_ec_rack_totals(self):
        spec = [("a:1", "r1", 100, {1: list(range(8)), 2: list(range(6))}),
                ("b:1", "r1", 100, {})]
        moves, state = _plan_both(
            spec, lambda ec, c, e, nodes: ec.balance_ec_rack(e, nodes, apply=False))
        assert moves == 2
        assert sorted(dict(state[1][3])) == [1, 2]

    def test_full_balance_pass(self):
        spec = [("a:1", "r1", 100, {3: list(range(14))}), ("b:1", "r1", 100, {}),
                ("c:1", "r2", 100, {}), ("d:1", "r2", 100, {})]
        stats, state = _plan_both(
            spec, lambda ec, c, e, nodes: ec.balance_ec_volumes(e, nodes, apply=False))
        assert stats["across_racks"] > 0
        per_rack = {}
        for url, rack, _, shards in state:
            per_rack[rack] = per_rack.get(rack, 0) + sum(
                bin(bits).count("1") for _, (_, bits) in shards)
        assert per_rack == {"r1": 7, "r2": 7}

    def test_find_missing_shards(self):
        spec = [("a:1", "r1", 100, {4: [0, 1, 2]}),
                ("b:1", "r1", 100, {4: list(range(3, 13))})]
        missing, _ = _plan_both(
            spec, lambda ec, c, e, nodes: c.find_missing_shards(nodes, 4))
        assert missing == [13]

    @pytest.mark.parametrize("seed", range(6))
    def test_seeded_cluster_states_plan_alike(self, seed):
        """Random racks, capacities and shard sets (duplicates included):
        the full ec.balance pass, the spread and the missing-shard scan
        agree."""
        rng = np.random.default_rng(seed)
        spec = []
        for i in range(int(rng.integers(2, 7))):
            shards = {}
            for vid in range(1, 5):
                if rng.random() < 0.6:
                    sids = sorted(set(rng.integers(0, 14, int(rng.integers(1, 9))).tolist()))
                    shards[vid] = sids
            spec.append((f"n{i}:80", f"r{int(rng.integers(0, 3))}",
                         int(rng.integers(20, 80)), shards))

        def plan(ec, c, e, nodes):
            spread = [n.url for n in ec.balanced_ec_distribution(nodes)]
            missing = [c.find_missing_shards(nodes, v) for v in range(1, 5)]
            return spread, missing, ec.balance_ec_volumes(e, nodes, apply=False)

        _plan_both(spec, plan)


def _dump(env_mod, spec, limit_mb=30 * 1024):
    """spec: {url: (rack, max, [vid...])}"""
    nodes = []
    for url, (rack, mx, vids) in spec.items():
        nodes.append(env_mod.TopologyNodeInfo(
            url=url, public_url=url, dc="dc1", rack=rack, max_volumes=mx,
            volumes=[{"Id": vid, "Collection": "", "Size": 100, "FileCount": 1,
                      "DeleteCount": 0, "DeletedByteCount": 0, "ReadOnly": False,
                      "ReplicaPlacement": 0, "Ttl": 0} for vid in vids]))
    return env_mod.TopologyDump(volume_size_limit_mb=limit_mb, nodes=nodes)


def _volume_plan_both(spec, plan, edit=lambda dump: None):
    got = {}
    for side, (_, cmds, env_mod) in PKGS.items():
        dump = _dump(env_mod, spec)
        edit(dump)
        got[side] = plan(cmds, dump)
    assert got["ref"] == got["port"]
    return got["port"]


class TestVolumePlanners:
    def test_balance_moves_from_loaded_to_empty(self):
        moves = _volume_plan_both({"a:1": ("r1", 10, [1, 2, 3, 4]), "b:1": ("r1", 10, [])},
                                  lambda c, d: c.plan_volume_balance(d))
        assert moves and all(m["from"] == "a:1" and m["to"] == "b:1" for m in moves)
        assert abs(4 - 2 * len(moves)) <= 1

    def test_balance_noop_when_even(self):
        assert _volume_plan_both({"a:1": ("r1", 10, [1, 2]), "b:1": ("r1", 10, [3, 4])},
                                 lambda c, d: c.plan_volume_balance(d)) == []

    def test_fix_replication_prefers_other_rack(self):
        def edit(dump):
            dump.nodes[0].volumes[0]["ReplicaPlacement"] = 10  # "010"

        plans = _volume_plan_both(
            {"a:1": ("r1", 10, [1]), "b:1": ("r1", 10, []), "c:1": ("r2", 10, [])},
            lambda c, d: c.plan_fix_replication(d), edit)
        assert plans == [{"vid": 1, "collection": "", "from": "a:1", "to": "c:1"}]

    def test_fix_replication_noop_when_satisfied(self):
        def edit(dump):
            for n in dump.nodes:
                n.volumes[0]["ReplicaPlacement"] = 1  # "001"

        assert _volume_plan_both({"a:1": ("r1", 10, [1]), "b:1": ("r1", 10, [1])},
                                 lambda c, d: c.plan_fix_replication(d), edit) == []

    def test_collect_volume_ids_for_ec_encode(self):
        def edit(dump):
            dump.volume_size_limit_mb = 1
            dump.nodes[0].volumes[0]["Size"] = 2 * 1024 * 1024
            for v in dump.nodes[0].volumes:
                v["Collection"] = "x"

        vids = _volume_plan_both(
            {"a:1": ("r1", 10, [1, 2])},
            lambda c, d: c.collect_volume_ids_for_ec_encode(d, "x", 60, 95), edit)
        assert vids == [1]

    @pytest.mark.parametrize("seed", range(4))
    def test_seeded_topologies_plan_alike(self, seed):
        rng = np.random.default_rng(100 + seed)
        spec = {}
        for i in range(int(rng.integers(2, 6))):
            vids = sorted(set(rng.integers(1, 12, int(rng.integers(0, 8))).tolist()))
            spec[f"n{i}:80"] = (f"r{int(rng.integers(0, 2))}", int(rng.integers(5, 20)), vids)
        placements = [0, 1, 10, 100, 2]

        def edit(dump):
            for n in dump.nodes:
                for v in n.volumes:
                    v["ReplicaPlacement"] = placements[v["Id"] % len(placements)]
                    v["Size"] = v["Id"] * 100_000

        def plan(c, d):
            return (c.plan_volume_balance(d), c.plan_fix_replication(d),
                    c.collect_volume_ids_for_ec_encode(d, "", 60, 50))

        _volume_plan_both(spec, plan, edit)


# --- the command table ------------------------------------------------------------


def test_command_names_equal_the_references():
    assert sorted(COMMANDS) == sorted(REF_COMMANDS)
    assert len([n for n in COMMANDS if n.startswith("fs.")]) == 11
    # the integrity plane's verbs run (ROADMAP item 9); the filer's,
    # the capsules' and replication's still wait
    assert sorted(port_commands.WAITING) == sorted(
        [n for n in COMMANDS if n.startswith("fs.")]
        + ["capsule.capture", "capsule.collect", "replication.lag"])
    for name, cmd in COMMANDS.items():
        assert cmd.name == name and cmd.help == REF_COMMANDS[name].help, name


@pytest.mark.parametrize("name", sorted(port_commands.WAITING))
def test_waiting_verbs_raise_naming_their_item(name):
    item = port_commands.WAITING[name][0]
    with pytest.raises(NotImplementedError, match=rf"ROADMAP item {item}\)"):
        run_command(CommandEnv(["127.0.0.1:0"]), f"{name} -volumeId 1")


def test_help_lists_every_verb():
    out = run_command(CommandEnv(["127.0.0.1:0"]), "help")
    assert [line.split()[0] for line in out.splitlines()] == sorted(REF_COMMANDS)


# --- a port cluster through the port's shell ---------------------------------------


def wait_for(predicate, timeout=30.0):
    deadline = time.time() + timeout
    while time.time() < deadline:
        if predicate():
            return True
        time.sleep(0.1)
    return False


def http_get(url):
    try:
        with urllib.request.urlopen(url, timeout=10) as r:
            return r.status, r.read()
    except urllib.error.HTTPError as e:
        return e.code, e.read()


def http_json(url):
    import json

    with urllib.request.urlopen(url, timeout=10) as r:
        return r.status, json.loads(r.read())


def post(url, data):
    urllib.request.urlopen(urllib.request.Request(url, data=data, method="POST"),
                           timeout=10).close()


@pytest.fixture(scope="module")
def cluster(tmp_path_factory):
    master = MasterServer(port=free_port(), volume_size_limit_mb=64)
    master.start()
    servers = []
    try:
        for i in range(3):
            vs = VolumeServer([str(tmp_path_factory.mktemp(f"shvs{i}"))], port=free_port(),
                              master=f"127.0.0.1:{master.port}", rack=f"rack{i % 2}",
                              heartbeat_interval=0.2, max_volume_counts=[100],
                              ec_codec="cuda", device="cpu", scrub_interval=0)
            vs.start()
            servers.append(vs)
        assert wait_for(lambda: len(master.topology.data_nodes()) == 3)
        yield master, servers
    finally:
        for vs in servers:
            vs.stop()
        master.stop()


def _registered(master, vid, n=14):
    locs = master.topology.lookup_ec_shards(vid)
    return locs is not None and sum(1 for l in locs.locations if l) == n


class TestShellPipeline:
    def test_ec_encode_rebuild_balance_end_to_end(self, cluster):
        master, servers = cluster
        env = CommandEnv([f"127.0.0.1:{master.port}"])
        _, assign = http_json(f"http://127.0.0.1:{master.port}/dir/assign?collection=shellec")
        payload = b"shell pipeline payload " * 1000
        post(f"http://{assign['url']}/{assign['fid']}", payload)
        vid = int(assign["fid"].split(",")[0])

        out = io.StringIO()
        run_command(env, f"ec.encode -collection shellec -volumeId {vid}", out)
        assert f"ec encoded volume {vid}" in out.getvalue()
        assert wait_for(lambda: _registered(master, vid))
        assert http_get(f"http://{assign['url']}/{assign['fid']}") == (200, payload)

        # drop one shard somewhere, then ec.rebuild restores it
        victim = next(vs for vs in servers
                      if (ev := vs.store.find_ec_volume(vid)) is not None and ev.shard_ids())
        lost = victim.store.find_ec_volume(vid).shard_ids()[0]
        path = os.path.join(victim.store.locations[0].directory, f"shellec_{vid}.ec{lost:02d}")
        want = open(path, "rb").read()
        victim.store.unmount_ec_shards(vid, [lost])
        os.remove(path)
        assert wait_for(lambda: not master.topology.lookup_ec_shards(vid).locations[lost])

        out = io.StringIO()
        run_command(env, f"ec.rebuild -volumeId {vid} -force", out)
        assert "rebuilt shards" in out.getvalue()
        assert wait_for(lambda: _registered(master, vid))
        rebuilt = [vs for vs in servers if (ev := vs.store.find_ec_volume(vid)) is not None
                   and lost in ev.shard_ids()]
        assert len(rebuilt) == 1
        with open(os.path.join(rebuilt[0].store.locations[0].directory,
                               f"shellec_{vid}.ec{lost:02d}"), "rb") as f:
            assert f.read() == want

        out = io.StringIO()
        run_command(env, "ec.balance -force", out)
        assert "applied=True" in out.getvalue()
        assert http_get(f"http://{assign['url']}/{assign['fid']}") == (200, payload)

    def test_volume_list_and_collection_list(self, cluster):
        master, _ = cluster
        env = CommandEnv([f"127.0.0.1:{master.port}"])
        http_json(f"http://127.0.0.1:{master.port}/dir/assign?collection=listed")
        out = io.StringIO()
        run_command(env, "volume.list", out)
        assert out.getvalue().count("node 127.0.0.1:") == 3
        out = io.StringIO()
        run_command(env, "collection.list", out)
        assert "collection:listed" in out.getvalue()

    def test_volume_vacuum_command(self, cluster):
        master, _ = cluster
        env = CommandEnv([f"127.0.0.1:{master.port}"])
        _, assign = http_json(f"http://127.0.0.1:{master.port}/dir/assign?collection=vac")
        url = f"http://{assign['url']}/{assign['fid']}"
        post(url, b"garbage" * 1000)
        urllib.request.urlopen(urllib.request.Request(url, method="DELETE"), timeout=10).close()
        out = io.StringIO()
        run_command(env, "volume.vacuum -garbageThreshold 0.0001", out)
        assert "vacuumed volume" in out.getvalue()

    def test_volume_move_and_collection_delete(self, cluster):
        master, servers = cluster
        env = CommandEnv([f"127.0.0.1:{master.port}"])
        _, assign = http_json(f"http://127.0.0.1:{master.port}/dir/assign?collection=mv")
        payload = b"moved payload " * 300
        post(f"http://{assign['url']}/{assign['fid']}", payload)
        vid = int(assign["fid"].split(",")[0])
        src = next(vs for vs in servers if vs.store.find_volume(vid) is not None)
        dst = next(vs for vs in servers if vs.store.find_volume(vid) is None)
        dat = open(src.store.find_volume(vid).base_name + ".dat", "rb").read()
        out = io.StringIO()
        run_command(env, f"volume.move -from 127.0.0.1:{src.port} -to 127.0.0.1:{dst.port} "
                         f"-volumeId {vid}", out)
        assert f"volume {vid} moved" in out.getvalue()
        assert src.store.find_volume(vid) is None
        moved = dst.store.find_volume(vid)
        assert open(moved.base_name + ".dat", "rb").read() == dat
        assert http_get(f"http://127.0.0.1:{dst.port}/{assign['fid']}") == (200, payload)
        out = io.StringIO()
        run_command(env, "collection.delete mv", out)
        assert "collection mv is deleted" in out.getvalue()
        assert wait_for(lambda: dst.store.find_volume(vid) is None)

    def test_operator_verbs_read_the_port_servers_routes(self, cluster):
        master, _ = cluster
        env = CommandEnv([f"127.0.0.1:{master.port}"])
        for line, want in (("trace.status", "tracing"), ("cluster.health", "disabled"),
                           ("cluster.alerts", "disabled"), ("cluster.top", "disabled"),
                           ("cluster.slo", "disabled"), ("repair.queue", "disabled"),
                           ("profile.capture -seconds 0.2", "sample(s)"),
                           ("trace.dump -n 4", "")):
            out = run_command(env, line)
            assert want in out, (line, out)
            assert "unreachable" not in out, (line, out)
        out = run_command(env, "node.drain -node 127.0.0.1:1")
        assert "not registered" in out
        run_command(env, "node.drain -node 127.0.0.1:1 -stop")

    def test_maintenance_runner_once(self, cluster):
        master, _ = cluster
        from seaweedfs_tpu_torch.shell.shell_runner import MaintenanceRunner

        runner = MaintenanceRunner([f"127.0.0.1:{master.port}"],
                                   scripts=["volume.fix.replication -n", "ec.balance"],
                                   period_s=3600)
        outputs = runner.run_once()
        assert len(outputs) == 2
        assert all("unknown command" not in o for o in outputs)
        assert "planned" in outputs[0] and "applied=False" in outputs[1]


def test_run_shell_reads_piped_commands(cluster):
    """The REPL on piped input: each line's output, an error line for a
    failing verb (the REPL keeps running), and `exit`; the maintenance
    runner's thread ends at stop()."""
    from seaweedfs_tpu_torch.shell.shell_runner import MaintenanceRunner, run_shell

    master, _ = cluster
    out = io.StringIO()
    run_shell([f"127.0.0.1:{master.port}"],
              stdin=io.StringIO("help\nvolume.list\nfs.ls /\nexit\nhelp\n"), stdout=out)
    text = out.getvalue()
    # one listing: the `help` after `exit` is never read
    assert text.count("ec.rebuild.batch [-volumeIds") == 1 and "node 127.0.0.1:" in text
    assert "error: fs.ls needs the filer, not ported yet (ROADMAP item 11)" in text
    runner = MaintenanceRunner([f"127.0.0.1:{master.port}"], scripts=["ec.balance"],
                               period_s=0.05)
    runner.start()
    assert wait_for(lambda: runner.last_output)
    runner.stop()
    assert not runner._thread.is_alive()
    assert "applied=False" in runner.last_output[0]


def _snapshot_encodes(tmp, servers, vids):
    """Each volume's .dat copied aside and encoded there by the
    reference's host encoder: {vid: (server, base, {ext: bytes})}."""
    refs = {}
    for vs in servers:
        for loc in vs.store.locations:
            for vid, vol in loc.volumes.items():
                if vid in vids:
                    ref_base = os.path.join(tmp, f"ref{vid}")
                    shutil.copyfile(vol.base_name + ".dat", ref_base + ".dat")
                    refs[vid] = (vs, vol.base_name, ref_base)
    assert set(refs) == set(vids)
    out = {}
    for vid, (vs, base, ref_base) in refs.items():
        ref_files.write_ec_files(ref_base, rs=ref_new_encoder(backend="cpu"))
        out[vid] = (vs, base, {e: open(ref_base + e, "rb").read() for e in SHARD_EXTS})
    return out


class TestEcBatchVerb:
    def test_batch_encode_then_batch_rebuild(self, cluster, tmp_path):
        """ec.batch: four sealed volumes encoded per server through one
        mesh round per tile (VolumeEcShardsBatchGenerate) and served
        from EC, shard bytes equal to the reference's per-volume encode;
        then ec.rebuild.batch over two damage signatures, (3,) on odd
        volumes and (0, 5, 10, 13) on even ones."""
        master, servers = cluster
        env = CommandEnv([f"127.0.0.1:{master.port}"])
        rng = np.random.default_rng(9)
        writes = {}
        for i in range(4):  # distinct collections => distinct volumes
            _, assign = http_json(f"http://127.0.0.1:{master.port}/dir/assign?collection=ecb{i}")
            payload = rng.integers(0, 256, int(rng.integers(20_000, 90_000)),
                                   dtype=np.uint8).tobytes()
            post(f"http://{assign['url']}/{assign['fid']}", payload)
            writes[int(assign["fid"].split(",")[0])] = (assign["url"], assign["fid"], payload)
        want = _snapshot_encodes(str(tmp_path), servers, set(writes))

        vids = ",".join(str(v) for v in sorted(writes))
        out = run_command(env, f"ec.batch -volumeIds {vids}")
        assert "one mesh program" in out
        for vid, (vs, base, files) in want.items():
            for ext, data in files.items():
                assert open(base + ext, "rb").read() == data, (vid, ext)
        for vid, (url, fid, payload) in writes.items():
            assert http_get(f"http://{url}/{fid}") == (200, payload), vid
            vs = want[vid][0]
            assert vs.store.find_volume(vid) is None and vs.store.find_ec_volume(vid)

        for vid, (vs, base, _) in want.items():
            lost = (3,) if vid % 2 else (0, 5, 10, 13)
            assert wait_for(lambda: _registered(master, vid))
            vs.store.unmount_ec_shards(vid, list(lost))
            for sid in lost:
                os.remove(base + SHARD_EXTS[sid])
            assert wait_for(lambda: _registered(master, vid, 14 - len(lost)))
        out = run_command(env, f"ec.rebuild.batch -volumeIds {vids} -force")
        assert "batch-rebuilt" in out  # 4 volumes on 3 servers: one holds two
        for vid, (_, base, files) in want.items():
            assert wait_for(lambda: _registered(master, vid))
            # a volume alone on its server takes the single-volume
            # rebuild, which may rebuild on another server
            for sid, ext in enumerate(SHARD_EXTS):
                holder = next(vs for vs in servers if (ev := vs.store.find_ec_volume(vid))
                              is not None and sid in ev.shard_ids())
                path = os.path.join(holder.store.locations[0].directory,
                                    os.path.basename(base) + ext)
                assert open(path, "rb").read() == files[ext], (vid, ext)
        for vid, (url, fid, payload) in writes.items():
            assert http_get(f"http://{url}/{fid}") == (200, payload), vid

    def test_ec_decode_back_to_a_volume(self, cluster):
        master, servers = cluster
        env = CommandEnv([f"127.0.0.1:{master.port}"])
        _, assign = http_json(f"http://127.0.0.1:{master.port}/dir/assign?collection=dec")
        payload = b"decoded back " * 700
        post(f"http://{assign['url']}/{assign['fid']}", payload)
        vid = int(assign["fid"].split(",")[0])
        run_command(env, f"ec.encode -volumeId {vid}")
        assert wait_for(lambda: _registered(master, vid))
        out = run_command(env, f"ec.decode -volumeId {vid}")
        assert f"decoded ec volume {vid}" in out
        holder = [vs for vs in servers if vs.store.find_volume(vid) is not None]
        assert len(holder) == 1
        assert not any(vs.store.find_ec_volume(vid) for vs in servers)
        assert http_get(f"http://127.0.0.1:{holder[0].port}/{assign['fid']}") == (200, payload)


# --- each package's shell on the other's cluster -------------------------------------


@pytest.fixture
def mixed(tmp_path, pinned_clock):  # noqa: F811 (the imported fixture)
    clusters = {}
    try:
        for side in ("ref", "port"):
            clusters[side] = Cluster(side, str(tmp_path))
        yield clusters
    finally:
        for c in clusters.values():
            c.stop()


def test_each_shell_encodes_on_the_other_packages_cluster(mixed, tmp_path):
    """The reference's shell runs ec.encode on the port cluster and the
    port's shell on the reference cluster; the same writes on both give
    the same shard bytes, equal to the reference's host encode."""
    payload = np.random.default_rng(21).bytes(150_000)
    shells = {"port": (ref_commands.run_command, ref_env.CommandEnv),
              "ref": (port_commands.run_command, port_env.CommandEnv)}
    shards = {}
    for side, c in mixed.items():
        random.seed(5)
        _, a = http_json(f"{c.m}/dir/assign?collection=mix")
        post(f"http://{a['url']}/{a['fid']}?ts=1700000000", payload)
        vid = int(a["fid"].split(",")[0])
        snap = str(tmp_path / f"snap-{side}")
        os.makedirs(snap)
        want = _snapshot_encodes(snap, c.servers, {vid})[vid][2]
        run, env_cls = shells[side]
        out = run(env_cls([f"127.0.0.1:{c.master.port}"]), f"ec.encode -volumeId {vid}")
        assert f"ec encoded volume {vid}" in out, (side, out)
        assert wait_for(lambda: _registered(c.master, vid)), side
        got = {}
        for vs in c.servers:
            base = os.path.join(vs.store.locations[0].directory, f"mix_{vid}")
            for ext in SHARD_EXTS:
                if os.path.exists(base + ext):
                    got[ext] = open(base + ext, "rb").read()
        assert got == want, side
        assert http_get(f"http://{a['url']}/{a['fid']}") == (200, payload), side
        shards[side] = got
    assert shards["ref"] == shards["port"]


class TestEcVerify:
    """ec.verify on a port cluster: clean volumes verify 0 mismatches; a
    flipped byte in a PARITY shard shows only in its own row, a flipped
    byte in a DATA shard disagrees with every parity row. The reference's
    do_ec_verify on the same shards gives the same counts and text."""

    def test_verify_clean_then_corrupt(self, cluster):
        from seaweedfs_tpu_torch.ec.codec import new_encoder

        master, volume_servers = cluster
        env = CommandEnv([f"127.0.0.1:{master.port}"])
        _, assign = http_json(f"http://127.0.0.1:{master.port}/dir/assign?collection=scrub")
        post(f"http://{assign['url']}/{assign['fid']}", b"scrub me " * 4096)
        vid = int(assign["fid"].split(",")[0])
        run_command(env, f"ec.encode -collection scrub -volumeId {vid}")
        assert wait_for(lambda: _registered(master, vid))

        def verify():
            got = {}
            for side, cmds, env_mod in (("port", port_commands, port_env),
                                        ("ref", ref_commands, ref_env)):
                out = io.StringIO()
                kw = {"rs": new_encoder(backend="cuda", device="cpu")} if side == "port" else {}
                mism = cmds.do_ec_verify(env_mod.CommandEnv([f"127.0.0.1:{master.port}"]),
                                         vid, out, **kw)
                got[side] = (mism, out.getvalue())
            assert got["port"] == got["ref"]
            return got["port"]

        def shard_path(sid):
            for vs in volume_servers:
                for loc in vs.store.locations:
                    p = os.path.join(loc.directory, f"scrub_{vid}.ec{sid:02d}")
                    if os.path.exists(p):
                        return p
            return None

        def flip(sid, off, xor):
            with open(shard_path(sid), "r+b") as f:
                f.seek(off)
                b = f.read(1)
                f.seek(off)
                f.write(bytes([b[0] ^ xor]))

        mism, text = verify()
        assert mism == [0, 0, 0, 0] and "verified clean" in text
        flip(12, 100, 0x5A)
        mism, text = verify()
        assert mism[2] > 0 and mism[0] == mism[1] == mism[3] == 0
        assert "parity shard(s) corrupt" in text and "culprit shard(s) [12]" in text
        flip(12, 100, 0x5A)
        flip(3, 200, 0x77)
        mism, text = verify()
        assert all(m > 0 for m in mism) and "data shard corruption" in text
        flip(3, 200, 0x77)
        assert verify()[0] == [0, 0, 0, 0]
        out = run_command(env, f"ec.verify -volumeId {vid} -json")
        assert json.loads(out)["corrupt"] is False
