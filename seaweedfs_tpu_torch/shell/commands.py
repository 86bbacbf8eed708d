"""Admin shell commands.

Behavioral match of weed/shell/ (the reference's REPL command set); the
port of seaweedfs_tpu/shell/commands.py. Implemented here:
  ec.encode  ec.batch  ec.rebuild  ec.rebuild.batch  ec.balance  ec.decode
  volume.list  volume.delete  volume.mount  volume.unmount  volume.copy
  volume.move  volume.vacuum  volume.balance  volume.fix.replication
  collection.list  collection.delete  node.drain  help
  trace.status  trace.dump  cluster.health  cluster.alerts  cluster.top
  cluster.slo  capsule.capture  capsule.collect  profile.capture
  repair.queue  scrub.status  scrub.trigger
  ec.verify  volume.tier.upload  volume.tier.download  tier.status
  tier.move  replication.lag
The 11 fs.* commands (cd/pwd/ls/du/cat/tree/mv/meta.cat/meta.save/
meta.load/meta.notify) live in shell/fs_commands.py, registered on
import by shell/__init__.py.
The EC verbs run on the volume servers' codec: on a card server,
ec.encode and ec.rebuild launch K1 with K4, ec.batch K2 with K4 and
ec.rebuild.batch K2. ec.verify runs in the shell's own process: it
gathers every shard over VolumeEcShardRead and re-encodes each 4 MiB
tile with new_encoder() (K1 on the card). Every verb of the reference
is registered under its own name and help, so `help` lists the
reference's names.

Each command is `run(env, args, out) -> None`, printing human output to
`out` (an io.TextIOBase). Planners accept -force/-apply the same way the
reference threads applyBalancing (command_ec_common.go:18).
"""


from __future__ import annotations

import io
import shlex
import time

import grpc

from seaweedfs_tpu_torch.pb import master_pb2, rpc, volume_pb2
from seaweedfs_tpu_torch.shell import ec_common
from seaweedfs_tpu_torch.shell.command_env import CommandEnv, TopologyDump

COMMANDS: dict[str, "Command"] = {}


class Command:
    name = ""
    help = ""

    def run(self, env: CommandEnv, args: list[str], out: io.TextIOBase) -> None:
        raise NotImplementedError


def register(cls):
    COMMANDS[cls.name] = cls()
    return cls


def run_command(env: CommandEnv, line: str, out: io.TextIOBase | None = None) -> str:
    """Parse + run one command line; returns captured output."""
    buf = io.StringIO()
    parts = shlex.split(line)
    if not parts:
        return ""
    cmd = COMMANDS.get(parts[0])
    if cmd is None:
        raise ValueError(f"unknown command {parts[0]!r}; try `help`")
    cmd.run(env, parts[1:], out or buf)
    return buf.getvalue()


def _flag(args: list[str], name: str, default: str = "") -> str:
    """-name=value or -name value."""
    for i, a in enumerate(args):
        if a == f"-{name}" and i + 1 < len(args):
            return args[i + 1]
        if a.startswith(f"-{name}="):
            return a.split("=", 1)[1]
    return default


def _has_flag(args: list[str], name: str) -> bool:
    return any(a == f"-{name}" or a.startswith(f"-{name}=") for a in args)



def _lookup_collection(env: CommandEnv, vid: int) -> str:
    for n in env.collect_topology().nodes:
        for v in n.volumes:
            if v["Id"] == vid:
                return v["Collection"]
    return ""


def _copy_volume(env: CommandEnv, vid: int, collection: str, src: str, dst: str) -> None:
    with env.volume_channel(dst) as ch:
        rpc.volume_stub(ch).VolumeCopy(
            volume_pb2.VolumeCopyRequest(
                volume_id=vid, collection=collection, source_data_node=src
            )
        )


def _move_volume(env: CommandEnv, vid: int, collection: str, src: str, dst: str) -> None:
    """copy + delete with a readonly guard on the source so no write
    lands between the copy and the delete (the reference tails instead,
    command_volume_move.go; readonly-then-move trades brief write
    unavailability of this volume for the same safety)."""
    with env.volume_channel(src) as ch:
        rpc.volume_stub(ch).VolumeMarkReadonly(
            volume_pb2.VolumeMarkReadonlyRequest(volume_id=vid)
        )
    try:
        _copy_volume(env, vid, collection, src, dst)
    except Exception:
        # copy failed: revert the readonly mark so the source volume
        # keeps serving writes instead of staying wedged
        with env.volume_channel(src) as ch:
            rpc.volume_stub(ch).VolumeMarkWritable(
                volume_pb2.VolumeMarkWritableRequest(volume_id=vid)
            )
        raise
    with env.volume_channel(src) as ch:
        rpc.volume_stub(ch).VolumeDelete(volume_pb2.VolumeDeleteRequest(volume_id=vid))


# ----------------------------------------------------------------------
# collection / volume info


@register
class CollectionList(Command):
    name = "collection.list"
    help = "list all collections"

    def run(self, env, args, out):
        with env.master_channel() as ch:
            resp = rpc.master_stub(ch).CollectionList(
                master_pb2.CollectionListRequest(
                    include_normal_volumes=True, include_ec_volumes=True
                )
            )
        for c in resp.collections:
            print(f"collection:{c}", file=out)


@register
class CollectionDelete(Command):
    name = "collection.delete"
    help = "collection.delete <collection>"

    def run(self, env, args, out):
        if not args:
            raise ValueError("usage: collection.delete <collection>")
        with env.master_channel() as ch:
            rpc.master_stub(ch).CollectionDelete(
                master_pb2.CollectionDeleteRequest(name=args[0])
            )
        print(f"collection {args[0]} is deleted", file=out)


@register
class VolumeList(Command):
    name = "volume.list"
    help = "list all volumes"

    def run(self, env, args, out):
        dump = env.collect_topology()
        for n in dump.nodes:
            print(f"node {n.url} dc:{n.dc} rack:{n.rack}", file=out)
            for v in sorted(n.volumes, key=lambda v: v["Id"]):
                print(
                    f"  volume id:{v['Id']} size:{v['Size']} "
                    f"collection:{v['Collection']!r} file_count:{v['FileCount']} "
                    f"delete_count:{v['DeleteCount']} read_only:{v['ReadOnly']}",
                    file=out,
                )
            for s in sorted(n.ec_shards, key=lambda s: s["Id"]):
                sids = ec_common.shard_bits_to_ids(s["EcIndexBits"])
                print(f"  ec volume id:{s['Id']} shards:{sids}", file=out)


# ----------------------------------------------------------------------
# volume admin


@register
class VolumeDelete(Command):
    name = "volume.delete"
    help = "volume.delete -node <host:port> -volumeId <vid>"

    def run(self, env, args, out):
        node = _flag(args, "node")
        vid = int(_flag(args, "volumeId"))
        with env.volume_channel(node) as ch:
            rpc.volume_stub(ch).VolumeDelete(
                volume_pb2.VolumeDeleteRequest(volume_id=vid)
            )
        print(f"volume {vid} deleted from {node}", file=out)


@register
class VolumeMount(Command):
    name = "volume.mount"
    help = "volume.mount -node <host:port> -volumeId <vid>"

    def run(self, env, args, out):
        node = _flag(args, "node")
        vid = int(_flag(args, "volumeId"))
        with env.volume_channel(node) as ch:
            rpc.volume_stub(ch).VolumeMount(volume_pb2.VolumeMountRequest(volume_id=vid))
        print(f"volume {vid} mounted on {node}", file=out)


@register
class VolumeUnmount(Command):
    name = "volume.unmount"
    help = "volume.unmount -node <host:port> -volumeId <vid>"

    def run(self, env, args, out):
        node = _flag(args, "node")
        vid = int(_flag(args, "volumeId"))
        with env.volume_channel(node) as ch:
            rpc.volume_stub(ch).VolumeUnmount(
                volume_pb2.VolumeUnmountRequest(volume_id=vid)
            )
        print(f"volume {vid} unmounted on {node}", file=out)


@register
class VolumeCopy(Command):
    name = "volume.copy"
    help = "volume.copy -from <host:port> -to <host:port> -volumeId <vid>"

    def run(self, env, args, out):
        src = _flag(args, "from")
        dst = _flag(args, "to")
        vid = int(_flag(args, "volumeId"))
        _copy_volume(env, vid, _lookup_collection(env, vid), src, dst)
        print(f"volume {vid} copied {src} => {dst}", file=out)


@register
class VolumeMove(Command):
    name = "volume.move"
    help = "volume.move -from <host:port> -to <host:port> -volumeId <vid>"

    def run(self, env, args, out):
        src = _flag(args, "from")
        dst = _flag(args, "to")
        vid = int(_flag(args, "volumeId"))
        _move_volume(env, vid, _lookup_collection(env, vid), src, dst)
        print(f"volume {vid} moved {src} => {dst}", file=out)


@register
class VolumeVacuum(Command):
    name = "volume.vacuum"
    help = "volume.vacuum [-garbageThreshold 0.3] — run the 4-phase vacuum across the cluster"

    def run(self, env, args, out):
        threshold = float(_flag(args, "garbageThreshold", "0.3"))
        dump = env.collect_topology()
        compacted = 0
        for n in dump.nodes:
            for v in n.volumes:
                if v["ReadOnly"]:
                    continue
                with env.volume_channel(n.url) as ch:
                    stub = rpc.volume_stub(ch)
                    check = stub.VacuumVolumeCheck(
                        volume_pb2.VacuumVolumeCheckRequest(volume_id=v["Id"])
                    )
                    if check.garbage_ratio <= threshold:
                        continue
                    stub.VacuumVolumeCompact(
                        volume_pb2.VacuumVolumeCompactRequest(volume_id=v["Id"])
                    )
                    stub.VacuumVolumeCommit(
                        volume_pb2.VacuumVolumeCommitRequest(volume_id=v["Id"])
                    )
                    stub.VacuumVolumeCleanup(
                        volume_pb2.VacuumVolumeCleanupRequest(volume_id=v["Id"])
                    )
                compacted += 1
                print(f"vacuumed volume {v['Id']} on {n.url}", file=out)
        print(f"vacuumed {compacted} volumes", file=out)


# ----------------------------------------------------------------------
# volume.balance (command_volume_balance.go)


def plan_volume_balance(dump: TopologyDump, collection: str | None = None) -> list[dict]:
    """Plan moves so every node holds ≈ its share of volumes. Returns
    [{vid, from, to}] without applying."""
    nodes = dump.nodes
    if not nodes:
        return []
    counts = {
        n.url: len([v for v in n.volumes if collection is None or v["Collection"] == collection])
        for n in nodes
    }
    caps = {n.url: max(n.max_volumes, 1) for n in nodes}
    total = sum(counts.values())
    cap_total = sum(caps.values())
    moves = []
    vols_by_node = {
        n.url: [v for v in n.volumes if collection is None or v["Collection"] == collection]
        for n in nodes
    }
    # target share per node proportional to capacity (reference balances
    # by ratio of volume count to max count)
    def ratio(url):
        return counts[url] / caps[url]

    urls = [n.url for n in nodes]
    for _ in range(total):  # each volume moves at most once
        urls.sort(key=ratio)
        low, high = urls[0], urls[-1]
        # move only while the donor's ratio stays above the receiver's
        # even after giving one away (integer cross-multiply, no float)
        if (counts[high] - 1) * caps[low] <= counts[low] * caps[high]:
            break
        candidates = [
            v
            for v in vols_by_node[high]
            if v["Id"] not in {x["Id"] for x in vols_by_node[low]}
        ]
        if not candidates:
            break
        v = candidates[0]
        moves.append({"vid": v["Id"], "collection": v["Collection"], "from": high, "to": low})
        vols_by_node[high].remove(v)
        vols_by_node[low].append(v)
        counts[high] -= 1
        counts[low] += 1
    return moves


@register
class VolumeBalance(Command):
    name = "volume.balance"
    help = "volume.balance [-collection name] [-force]"

    def run(self, env, args, out):
        apply = _has_flag(args, "force")
        collection = _flag(args, "collection") or None
        dump = env.collect_topology()
        moves = plan_volume_balance(dump, collection)
        for m in moves:
            print(f"moving volume {m['vid']} {m['from']} => {m['to']}", file=out)
            if apply:
                _move_volume(env, m["vid"], m["collection"], m["from"], m["to"])
        print(f"planned {len(moves)} moves, applied={apply}", file=out)


# ----------------------------------------------------------------------
# volume.fix.replication (command_volume_fix_replication.go)


def plan_fix_replication(dump: TopologyDump) -> list[dict]:
    """Find under-replicated volumes; plan [{vid, from, to}] copies.
    Placement-aware: prefers a different rack when the placement's
    diff_rack_count calls for it."""
    from seaweedfs_tpu_torch.storage.replica_placement import ReplicaPlacement

    locations: dict[int, list] = {}
    info: dict[int, dict] = {}
    for n in dump.nodes:
        for v in n.volumes:
            locations.setdefault(v["Id"], []).append(n)
            info[v["Id"]] = v
    plans = []
    for vid, nodes_with in locations.items():
        v = info[vid]
        rp = ReplicaPlacement.from_byte(v["ReplicaPlacement"])
        want = rp.copy_count
        have = len(nodes_with)
        if have >= want:
            continue
        present = {n.url for n in nodes_with}
        present_racks = {(n.dc, n.rack) for n in nodes_with}
        candidates = [n for n in dump.nodes if n.url not in present]
        # prefer rack diversity when required
        if rp.diff_rack_count > 0:
            preferred = [n for n in candidates if (n.dc, n.rack) not in present_racks]
            candidates = preferred or candidates
        candidates.sort(key=lambda n: len(n.volumes))
        for target in candidates[: want - have]:
            plans.append(
                {
                    "vid": vid,
                    "collection": v["Collection"],
                    "from": nodes_with[0].url,
                    "to": target.url,
                }
            )
    return plans


@register
class VolumeFixReplication(Command):
    name = "volume.fix.replication"
    help = "volume.fix.replication [-n dry-run]"

    def run(self, env, args, out):
        dry = _has_flag(args, "n")
        dump = env.collect_topology()
        plans = plan_fix_replication(dump)
        for p in plans:
            print(f"replicating volume {p['vid']} {p['from']} => {p['to']}", file=out)
            if not dry:
                _copy_volume(env, p["vid"], p["collection"], p["from"], p["to"])
        print(f"fixed {0 if dry else len(plans)} volumes (planned {len(plans)})", file=out)


# ----------------------------------------------------------------------
# ec.* (command_ec_encode.go / _rebuild.go / _balance.go / _decode.go)


def collect_volume_ids_for_ec_encode(
    dump: TopologyDump, collection: str, quiet_period_s: float, full_percent: float
) -> list[int]:
    """Quiet + full volumes (collectVolumeIdsForEcEncode:258): volumes
    of the collection whose size exceeds full_percent% of the limit.
    (Our heartbeat rows don't carry modified-at; quiet filtering happens
    server-side at generate time.)"""
    limit = dump.volume_size_limit_mb * 1024 * 1024
    vids = []
    for n in dump.nodes:
        for v in n.volumes:
            if v["Collection"] != collection:
                continue
            if v["Size"] >= limit * full_percent / 100.0:
                vids.append(v["Id"])
    return sorted(set(vids))


def do_ec_encode(env: CommandEnv, vid: int, collection: str, out) -> None:
    """The 6-step encode pipeline (volume_grpc_erasure_coding.go:25-36 +
    command_ec_encode.go doEcEncode): mark readonly on all replicas →
    generate on one → spread by balanced distribution → mount → delete
    source shards it no longer owns → confirm all 14 shards registered
    at the master → delete the original volume."""
    with env.master_channel() as ch:
        resp = rpc.master_stub(ch).LookupVolume(
            master_pb2.LookupVolumeRequest(vids=[str(vid)])
        )
    locs = [l.url for e in resp.vid_locations for l in e.locations]
    if not locs:
        raise ValueError(f"volume {vid} not found")
    source = locs[0]

    # 1. mark readonly everywhere (markVolumeReadonly :119)
    for url in locs:
        with env.volume_channel(url) as ch:
            rpc.volume_stub(ch).VolumeMarkReadonly(
                volume_pb2.VolumeMarkReadonlyRequest(volume_id=vid)
            )
    # 2. generate EC shards on the source
    with env.volume_channel(source) as ch:
        rpc.volume_stub(ch).VolumeEcShardsGenerate(
            volume_pb2.VolumeEcShardsGenerateRequest(volume_id=vid, collection=collection)
        )
    print(f"generated ec shards for volume {vid} on {source}", file=out)

    # 3. spread (spreadEcShards :153 + balancedEcDistribution :240)
    nodes = ec_common.collect_ec_nodes(env)
    allocation = ec_common.balanced_ec_distribution(nodes)
    if len(allocation) < ec_common.TOTAL_SHARDS_COUNT:
        raise RuntimeError(
            f"not enough free ec shard slots to spread volume {vid}; "
            "the generated shards remain on the source, volume untouched"
        )
    per_node: dict[str, list[int]] = {}
    node_by_url = {n.url: n for n in nodes}
    for sid, node in enumerate(allocation):
        per_node.setdefault(node.url, []).append(sid)
    for url, shard_ids in per_node.items():
        ec_common.copy_and_mount_shards(
            env, node_by_url[url], vid, collection, shard_ids, source, apply=True
        )
        print(f"spread ec shards {vid}.{shard_ids} => {url}", file=out)
    # 4. delete shards from the source that moved elsewhere
    moved = [sid for url, sids in per_node.items() if url != source for sid in sids]
    if moved:
        with env.volume_channel(source) as ch:
            rpc.volume_stub(ch).VolumeEcShardsDelete(
                volume_pb2.VolumeEcShardsDeleteRequest(
                    volume_id=vid, collection=collection, shard_ids=moved
                )
            )
    # 5. confirm the master has REGISTERED every mounted shard before
    # any replica drops the volume. The mount beats ride each holder's
    # own heartbeat stream (immediate on mount via Store.notify_change,
    # but a stream mid-reconnect can delay one), so timing alone is not
    # ordering — this poll is what turns mount-before-delete into
    # registered-before-delete, the property that keeps reads available
    # through the cutover (BASELINE config 5;
    # volume_grpc_erasure_coding.go:25-36 ordering).
    deadline = time.time() + 30
    with env.master_channel() as ch:
        stub = rpc.master_stub(ch)
        while True:
            try:
                ec_resp = stub.LookupEcVolume(
                    master_pb2.LookupEcVolumeRequest(volume_id=vid), timeout=5
                )
                seen = {e.shard_id for e in ec_resp.shard_id_locations if e.locations}
            except grpc.RpcError:
                seen = set()
            if len(seen) >= ec_common.TOTAL_SHARDS_COUNT:
                break
            if time.time() > deadline:
                raise RuntimeError(
                    f"volume {vid}: only shards {sorted(seen)} registered with "
                    "the master after 30s; refusing to delete the source volume "
                    "(reads would go dark for the missing shards)"
                )
            time.sleep(0.05)
    # 6. delete the original volume on every replica
    for url in locs:
        with env.volume_channel(url) as ch:
            rpc.volume_stub(ch).VolumeDelete(volume_pb2.VolumeDeleteRequest(volume_id=vid))
    print(f"ec encoded volume {vid}", file=out)


@register
class EcEncode(Command):
    name = "ec.encode"
    help = "ec.encode [-collection name] [-volumeId vid] [-fullPercent 95]"

    def run(self, env, args, out):
        collection = _flag(args, "collection")
        vid_flag = _flag(args, "volumeId")
        dump = env.collect_topology()
        if vid_flag:
            vids = [int(vid_flag)]
            if not _has_flag(args, "collection"):
                # resolve the volume's real collection so copy/mount
                # address the right base name
                for n in dump.nodes:
                    for v in n.volumes:
                        if v["Id"] == vids[0]:
                            collection = v["Collection"]
        else:
            vids = collect_volume_ids_for_ec_encode(
                dump, collection, 60.0, float(_flag(args, "fullPercent", "95"))
            )
        for vid in vids:
            do_ec_encode(env, vid, collection, out)


@register
class EcBatch(Command):
    name = "ec.batch"
    help = (
        "ec.batch -volumeIds 1,2,3 — encode N sealed volumes per server "
        "in ONE mesh program (volume-parallel SPMD batch over the device "
        "mesh), then mount their shards in place (collections resolved "
        "from topology)"
    )

    def run(self, env, args, out):
        vid_flag = _flag(args, "volumeIds")
        if not vid_flag:
            raise ValueError("ec.batch needs -volumeIds vid,vid,...")
        # dedupe: a repeated id would open two write handles onto the
        # same shard files and interleave-corrupt them before the
        # originals get deleted
        vids = sorted({int(x) for x in vid_flag.split(",") if x})
        # each volume's real collection names its base files; resolve
        # from topology (same as ec.encode's -volumeId path)
        dump = env.collect_topology()
        collections = {
            v["Id"]: v["Collection"] for n in dump.nodes for v in n.volumes
        }

        # group by the server holding each volume: batching is local to
        # a node's device mesh (each node encodes its own batch)
        with env.master_channel() as ch:
            resp = rpc.master_stub(ch).LookupVolume(
                master_pb2.LookupVolumeRequest(vids=[str(v) for v in vids])
            )
        by_server: dict[str, list[int]] = {}
        replicas: dict[int, list[str]] = {}
        for entry in resp.vid_locations:
            if not entry.locations:
                raise ValueError(f"volume {entry.vid} not found")
            vid = int(entry.vid)
            replicas[vid] = [l.url for l in entry.locations]
            by_server.setdefault(entry.locations[0].url, []).append(vid)

        for url, server_vids in sorted(by_server.items()):
            # readonly on EVERY replica (markVolumeReadonly, like
            # do_ec_encode): a replica left writable would diverge from
            # the EC set the moment a write lands on it
            for vid in server_vids:
                for rurl in replicas[vid]:
                    with env.volume_channel(rurl) as ch:
                        rpc.volume_stub(ch).VolumeMarkReadonly(
                            volume_pb2.VolumeMarkReadonlyRequest(volume_id=vid)
                        )
            with env.volume_channel(url) as ch:
                rpc.volume_stub(ch).VolumeEcShardsBatchGenerate(
                    volume_pb2.VolumeEcShardsBatchGenerateRequest(
                        volume_ids=server_vids
                    ),
                    timeout=600,
                )
            print(
                f"batch-generated ec shards for volumes {server_vids} "
                f"on {url} (one mesh program)",
                file=out,
            )
            # serve from EC in place: mount all 14 shards, drop the
            # originals (spreading stays ec.encode/ec.balance's job)
            for vid in server_vids:
                with env.volume_channel(url) as ch:
                    stub = rpc.volume_stub(ch)
                    stub.VolumeEcShardsMount(
                        volume_pb2.VolumeEcShardsMountRequest(
                            volume_id=vid,
                            collection=collections.get(vid, ""),
                            shard_ids=list(range(ec_common.TOTAL_SHARDS_COUNT)),
                        )
                    )
                # drop EVERY replica of the original volume, not just
                # the encoding server's copy
                for rurl in replicas[vid]:
                    with env.volume_channel(rurl) as ch:
                        rpc.volume_stub(ch).VolumeDelete(
                            volume_pb2.VolumeDeleteRequest(volume_id=vid)
                        )
                print(f"volume {vid} now serves from ec shards", file=out)


def find_missing_shards(nodes: list[ec_common.EcNode], vid: int) -> list[int]:
    present = 0
    for n in nodes:
        entry = n.ec_shards.get(vid)
        if entry:
            present |= entry[1]
    return [i for i in range(ec_common.TOTAL_SHARDS_COUNT) if not present & (1 << i)]


def do_ec_rebuild(env: CommandEnv, vid: int, out, apply: bool = True) -> list[int]:
    """Rebuild missing shards on one rebuilder node
    (command_ec_rebuild.go rebuildOneEcVolume), rack-gather style:
    survivors STAY on their holders — VolumeEcShardsRebuild's pipeline
    streams their tiles off the holders in parallel with the
    reconstruction, so the rebuild is not serialized behind a full
    cluster copy. Only the .ecx index (plus one seed survivor when the
    rebuilder holds no shard of the volume — a local file fixes the
    shard size for the tile walk) is copied up front. If the streaming
    verb fails (holder unreachable, no master route) the classic
    copy-every-survivor flow runs as the fallback. Rebuilt shards are
    mounted on the rebuilder; the master learns via heartbeat."""
    import grpc as _grpc

    nodes = ec_common.collect_ec_nodes(env)
    missing = find_missing_shards(nodes, vid)
    if not missing:
        print(f"volume {vid}: no missing shards", file=out)
        return []
    holders = [n for n in nodes if vid in n.ec_shards]
    if not holders:
        raise ValueError(f"no ec shards for volume {vid}")
    collection = holders[0].ec_shards[vid][0]
    # rebuilder = node with most free slots
    rebuilder = max(nodes, key=lambda n: n.free_ec_slot)
    if not apply:
        return missing
    original_local = set(rebuilder.local_shard_ids(vid))
    local = set(original_local)
    if not local:
        donor = next(n for n in holders if n.url != rebuilder.url)
        seed = donor.local_shard_ids(vid)[0]
        with env.volume_channel(rebuilder.url) as ch:
            rpc.volume_stub(ch).VolumeEcShardsCopy(
                volume_pb2.VolumeEcShardsCopyRequest(
                    volume_id=vid,
                    collection=collection,
                    shard_ids=[seed],
                    copy_ecx_file=True,
                    source_data_node=donor.url,
                )
            )
        local.add(seed)

    def rebuild_now() -> list[int]:
        with env.volume_channel(rebuilder.url) as ch:
            resp = rpc.volume_stub(ch).VolumeEcShardsRebuild(
                volume_pb2.VolumeEcShardsRebuildRequest(
                    volume_id=vid, collection=collection
                ),
                timeout=600,
            )
        return list(resp.rebuilt_shard_ids)

    _FALLBACK_CODES = (
        _grpc.StatusCode.FAILED_PRECONDITION,  # verb lacked survivors
        _grpc.StatusCode.UNAVAILABLE,  # holder/master unreachable
        _grpc.StatusCode.UNKNOWN,  # server-side exception surfaced
    )
    try:
        rebuilt = rebuild_now()
    except _grpc.RpcError as e:
        if e.code() not in _FALLBACK_CODES:
            # DEADLINE_EXCEEDED etc: the server-side streaming rebuild
            # may still be RUNNING — a blind retry would race its
            # preallocated target files and misread them as present
            raise
        # fallback: pull every surviving shard the rebuilder lacks,
        # then rebuild from purely local files
        for n in holders:
            if n.url == rebuilder.url:
                continue
            need = [s for s in n.local_shard_ids(vid) if s not in local]
            if not need:
                continue
            with env.volume_channel(rebuilder.url) as ch:
                rpc.volume_stub(ch).VolumeEcShardsCopy(
                    volume_pb2.VolumeEcShardsCopyRequest(
                        volume_id=vid,
                        collection=collection,
                        shard_ids=need,
                        copy_ecx_file=True,
                        source_data_node=n.url,
                    )
                )
            local.update(need)
        rebuilt = rebuild_now()
    with env.volume_channel(rebuilder.url) as ch:
        rpc.volume_stub(ch).VolumeEcShardsMount(
            volume_pb2.VolumeEcShardsMountRequest(
                volume_id=vid, collection=collection, shard_ids=rebuilt
            )
        )
        # drop the borrowed survivor copies (they stay mounted on their
        # original owners); keep only what this node now contributes
        borrowed = [s for s in local if s not in original_local and s not in rebuilt]
        if borrowed:
            rpc.volume_stub(ch).VolumeEcShardsDelete(
                volume_pb2.VolumeEcShardsDeleteRequest(
                    volume_id=vid, collection=collection, shard_ids=borrowed
                )
            )
    print(f"rebuilt shards {rebuilt} for volume {vid} on {rebuilder.url}", file=out)
    return rebuilt


def do_ec_rebuild_batch(
    env: CommandEnv, vids: list[int], out, apply: bool = True
) -> dict[int, list[int]]:
    """Rebuild missing shards for many volumes, batching volumes that
    can rebuild from purely local survivors on the same node through
    ONE VolumeEcShardsBatchRebuild verb (the mesh-batched decode —
    the RepairScheduler's node-loss fan-in). Volumes that need a
    rack-gather, have no >=10-local-shard holder, or whose batch verb
    fails take the single-volume do_ec_rebuild path, so the result is
    never worse than calling it in a loop. Returns {vid: rebuilt ids}."""
    import grpc as _grpc

    nodes = ec_common.collect_ec_nodes(env)
    results: dict[int, list[int]] = {}
    by_server: dict[str, list[tuple[int, str, list[int]]]] = {}
    leftovers: list[int] = []
    for vid in sorted({int(v) for v in vids}):
        missing = find_missing_shards(nodes, vid)
        if not missing:
            results[vid] = []
            continue
        if not apply:
            results[vid] = missing
            continue
        # the batch arm needs one node already holding >= 10 shards of
        # the volume (all survivors local, no seed copy)
        cands = [
            n
            for n in nodes
            if vid in n.ec_shards
            and len(n.local_shard_ids(vid)) >= ec_common.DATA_SHARDS
        ]
        if not cands:
            leftovers.append(vid)
            continue
        rebuilder = max(cands, key=lambda n: n.free_ec_slot)
        collection = rebuilder.ec_shards[vid][0]
        by_server.setdefault(rebuilder.url, []).append(
            (vid, collection, missing)
        )
    if not apply:
        return results

    for url, entries in sorted(by_server.items()):
        if len(entries) < 2:
            # nothing to amortize: the single-volume verb's remote-
            # survivor handling and fallbacks are strictly richer
            leftovers.extend(vid for vid, _, _ in entries)
            continue
        server_vids = [vid for vid, _, _ in entries]
        try:
            with env.volume_channel(url) as ch:
                rpc.volume_stub(ch).VolumeEcShardsBatchRebuild(
                    volume_pb2.VolumeEcShardsBatchGenerateRequest(
                        volume_ids=server_vids
                    ),
                    timeout=600,
                )
        except _grpc.RpcError as e:
            print(
                f"batch rebuild of volumes {server_vids} on {url} "
                f"failed ({e.code()}); falling back per volume",
                file=out,
            )
            leftovers.extend(server_vids)
            continue
        print(
            f"batch-rebuilt ec shards for volumes {server_vids} on "
            f"{url} (one mesh program per damage signature)",
            file=out,
        )
        for vid, collection, missing in entries:
            with env.volume_channel(url) as ch:
                rpc.volume_stub(ch).VolumeEcShardsMount(
                    volume_pb2.VolumeEcShardsMountRequest(
                        volume_id=vid,
                        collection=collection,
                        shard_ids=missing,
                    )
                )
            results[vid] = missing
    for vid in leftovers:
        results[vid] = do_ec_rebuild(env, vid, out, apply)
    return results


@register
class EcRebuildBatch(Command):
    name = "ec.rebuild.batch"
    help = (
        "ec.rebuild.batch [-volumeIds 1,2,3] [-force] — rebuild many "
        "EC volumes, batching same-node local-survivor rebuilds "
        "through one mesh decode program per damage signature"
    )

    def run(self, env, args, out):
        vid_flag = _flag(args, "volumeIds")
        apply = _has_flag(args, "force")
        nodes = ec_common.collect_ec_nodes(env)
        vids = (
            [int(x) for x in vid_flag.split(",") if x]
            if vid_flag
            else sorted({vid for n in nodes for vid in n.ec_shards})
        )
        results = do_ec_rebuild_batch(env, vids, out, apply)
        if not apply:
            for vid, missing in sorted(results.items()):
                if missing:
                    print(
                        f"volume {vid}: missing shards {missing} "
                        f"(dry run; -force to rebuild)",
                        file=out,
                    )


@register
class EcRebuild(Command):
    name = "ec.rebuild"
    help = "ec.rebuild [-volumeId vid] [-force]"

    def run(self, env, args, out):
        vid_flag = _flag(args, "volumeId")
        apply = _has_flag(args, "force")
        nodes = ec_common.collect_ec_nodes(env)
        vids = (
            [int(vid_flag)]
            if vid_flag
            else sorted({vid for n in nodes for vid in n.ec_shards})
        )
        for vid in vids:
            missing = do_ec_rebuild(env, vid, out, apply)
            if not apply and missing:
                print(
                    f"volume {vid}: missing shards {missing} (dry run; -force to rebuild)",
                    file=out,
                )



def do_ec_verify(
    env: CommandEnv,
    vid: int,
    out,
    tile_bytes: int = 4 * 1024 * 1024,
    rate_mb_s: float = 0.0,
    as_json: bool = False,
    rs=None,
) -> list[int]:
    """Scrub one EC volume: stream all 14 shards from their holders,
    recompute the parity from the data shards with `rs` (default
    new_encoder(): K1 on the card unless WEED_EC_CODEC names a host
    codec — the same selection as the serving path), and compare.
    Returns the per-parity-row mismatched-byte counts [4].

    Runs through the scrub engine's verify core
    (scrub/verify.verify_parity_stream — the same code path the
    background sweeper exercises), which
    adds `-rate` token-bucket limiting (MB/s; 0 = full speed) so an
    operator can scrub a live volume without flattening foreground
    p99, plus corrupt-shard localization and `-json` machine-readable
    output. A corrupt DATA shard shows as mismatches in ALL four
    parity rows; a corrupt PARITY shard only in its own row."""
    import json as _json

    from seaweedfs_tpu_torch.scrub.ratelimit import TokenBucket
    from seaweedfs_tpu_torch.scrub.verify import verify_parity_stream

    with env.master_channel() as ch:
        resp = rpc.master_stub(ch).LookupEcVolume(
            master_pb2.LookupEcVolumeRequest(volume_id=vid), timeout=10
        )
    holders: dict[int, list[str]] = {
        e.shard_id: [l.url for l in e.locations]
        for e in resp.shard_id_locations
        if e.locations
    }
    missing = [i for i in range(ec_common.TOTAL_SHARDS_COUNT) if i not in holders]
    if missing:
        raise RuntimeError(
            f"volume {vid}: shards {missing} have no registered holder; "
            "run ec.rebuild first"
        )

    def make_reader(sid: int):
        def read_span(offset: int, size: int) -> bytes:
            last_err = None
            for url in holders[sid]:
                try:
                    with env.volume_channel(url) as ch:
                        chunks = [
                            r.data
                            for r in rpc.volume_stub(ch).VolumeEcShardRead(
                                volume_pb2.VolumeEcShardReadRequest(
                                    volume_id=vid,
                                    shard_id=sid,
                                    offset=offset,
                                    size=size,
                                ),
                                timeout=30,
                            )
                        ]
                    return b"".join(chunks)
                except Exception as e:  # noqa: BLE001 - try the next holder
                    last_err = e
            raise RuntimeError(f"shard {vid}.{sid} unreadable: {last_err}")

        return read_span

    limiter = (
        TokenBucket(rate_mb_s * 1024 * 1024) if rate_mb_s > 0 else None
    )
    try:
        res = verify_parity_stream(
            [make_reader(sid) for sid in range(ec_common.TOTAL_SHARDS_COUNT)],
            rs=rs,
            tile_bytes=tile_bytes,
            limiter=limiter,
        )
    except RuntimeError as e:
        raise RuntimeError(f"volume {vid}: {e}") from None
    mismatch, total = res.mismatch, res.bytes_per_shard
    if as_json:
        print(
            _json.dumps(
                {
                    "volumeId": vid,
                    "corrupt": res.corrupt,
                    "mismatchPerParityRow": mismatch,
                    "bytesPerShard": total,
                    "badTiles": res.bad_tiles,
                    "culpritShards": sorted(res.culprits),
                    "unlocalizedTiles": res.unlocalized,
                    "rateMBs": rate_mb_s,
                }
            ),
            file=out,
        )
        return mismatch
    if any(mismatch):
        rows = [p for p, m in enumerate(mismatch) if m]
        kind = (
            "parity shard(s) corrupt"
            if len(rows) < ec_common.PARITY_SHARDS
            else "data shard corruption (all parity rows disagree)"
        )
        print(
            f"volume {vid}: CORRUPT — mismatched bytes per parity row "
            f"{mismatch} over {total} B/shard: {kind}"
            + (
                f"; culprit shard(s) {sorted(res.culprits)}"
                if res.culprits
                else ""
            ),
            file=out,
        )
    else:
        print(
            f"volume {vid}: verified clean ({total} bytes/shard x 14 shards)",
            file=out,
        )
    return mismatch


@register
class EcVerify(Command):
    name = "ec.verify"
    help = (
        "ec.verify [-volumeId vid] [-rate MB/s] [-json] — scrub: stream "
        "shards, recompute + compare parity (rate-limited via the scrub "
        "engine's token bucket)"
    )

    def run(self, env, args, out):
        vid_flag = _flag(args, "volumeId")
        rate = float(_flag(args, "rate") or 0)
        as_json = _has_flag(args, "json")
        nodes = ec_common.collect_ec_nodes(env)
        vids = (
            [int(vid_flag)]
            if vid_flag
            else sorted({vid for n in nodes for vid in n.ec_shards})
        )
        if not vids:
            print("no ec volumes found", file=out)
            return
        for vid in vids:
            do_ec_verify(env, vid, out, rate_mb_s=rate, as_json=as_json)


@register
class EcBalance(Command):
    name = "ec.balance"
    help = "ec.balance [-collection name] [-force]"

    def run(self, env, args, out):
        apply = _has_flag(args, "force")
        collection = _flag(args, "collection") or None
        nodes = ec_common.collect_ec_nodes(env)
        stats = ec_common.balance_ec_volumes(env, nodes, collection, apply)
        print(
            f"ec.balance dedup:{stats['dedup']} across_racks:{stats['across_racks']} "
            f"within_racks:{stats['within_racks']} rack_total:{stats['rack_total']} "
            f"applied={apply}",
            file=out,
        )


@register
class EcDecode(Command):
    name = "ec.decode"
    help = "ec.decode -volumeId vid [-collection name] — EC shards back to a normal volume"

    def run(self, env, args, out):
        vid = int(_flag(args, "volumeId"))
        collection = _flag(args, "collection")
        nodes = ec_common.collect_ec_nodes(env)
        holders = [n for n in nodes if vid in n.ec_shards]
        if not holders:
            raise ValueError(f"no ec shards for volume {vid}")
        if not collection:
            collection = holders[0].ec_shards[vid][0]
        # collect every shard onto one node, then decode there
        # (command_ec_decode.go collectEcShards + generateNormalVolume)
        target = max(holders, key=lambda n: len(n.local_shard_ids(vid)))
        have = set(target.local_shard_ids(vid))
        for n in holders:
            if n.url == target.url:
                continue
            need = [s for s in n.local_shard_ids(vid) if s not in have]
            if not need:
                continue
            with env.volume_channel(target.url) as ch:
                rpc.volume_stub(ch).VolumeEcShardsCopy(
                    volume_pb2.VolumeEcShardsCopyRequest(
                        volume_id=vid,
                        collection=collection,
                        shard_ids=need,
                        copy_ecx_file=True,
                        source_data_node=n.url,
                    )
                )
            have.update(need)
        with env.volume_channel(target.url) as ch:
            rpc.volume_stub(ch).VolumeEcShardsToVolume(
                volume_pb2.VolumeEcShardsToVolumeRequest(
                    volume_id=vid, collection=collection
                )
            )
        # drop the ec shards everywhere now that the volume is back
        for n in holders:
            sids = n.local_shard_ids(vid)
            with env.volume_channel(n.url) as ch:
                stub = rpc.volume_stub(ch)
                stub.VolumeEcShardsUnmount(
                    volume_pb2.VolumeEcShardsUnmountRequest(volume_id=vid, shard_ids=sids)
                )
                stub.VolumeEcShardsDelete(
                    volume_pb2.VolumeEcShardsDeleteRequest(
                        volume_id=vid, collection=collection, shard_ids=sids
                    )
                )
        print(f"decoded ec volume {vid} back to a normal volume on {target.url}", file=out)


@register
class Help(Command):
    name = "help"
    help = "list commands"

    def run(self, env, args, out):
        for name in sorted(COMMANDS):
            print(f"{name:28s} {COMMANDS[name].help}", file=out)

# ----------------------------------------------------------------------
# tiered storage (command_volume_tier_upload.go / _download.go)


def _find_volume_node(env: CommandEnv, vid: int) -> str:
    for n in env.collect_topology().nodes:
        for v in n.volumes:
            if v["Id"] == vid:
                return n.url
    raise ValueError(f"volume {vid} not found on any node")


@register
class VolumeTierUpload(Command):
    name = "volume.tier.upload"
    help = (
        "volume.tier.upload -volumeId <vid> -dest <backendName> "
        "[-keepLocalDatFile] — move a sealed volume's .dat to a remote tier"
    )

    def run(self, env, args, out):
        vid = int(_flag(args, "volumeId"))
        dest = _flag(args, "dest")
        if not dest:
            raise ValueError("-dest <backendName> required (e.g. s3.default)")
        node = _flag(args, "node") or _find_volume_node(env, vid)
        collection = _flag(args, "collection") or _lookup_collection(env, vid)
        with env.volume_channel(node) as ch:
            for resp in rpc.volume_stub(ch).VolumeTierMoveDatToRemote(
                volume_pb2.VolumeTierMoveDatToRemoteRequest(
                    volume_id=vid,
                    collection=collection,
                    destination_backend_name=dest,
                    keep_local_dat_file=_has_flag(args, "keepLocalDatFile"),
                )
            ):
                print(
                    f"uploaded {resp.processed} bytes "
                    f"({resp.processed_percentage:.0f}%)",
                    file=out,
                )
        print(f"volume {vid} dat moved to {dest}", file=out)


@register
class VolumeTierDownload(Command):
    name = "volume.tier.download"
    help = (
        "volume.tier.download -volumeId <vid> [-keepRemoteDatFile] — "
        "bring a tiered volume's .dat back to local disk"
    )

    def run(self, env, args, out):
        vid = int(_flag(args, "volumeId"))
        node = _flag(args, "node") or _find_volume_node(env, vid)
        collection = _flag(args, "collection") or _lookup_collection(env, vid)
        with env.volume_channel(node) as ch:
            for resp in rpc.volume_stub(ch).VolumeTierMoveDatFromRemote(
                volume_pb2.VolumeTierMoveDatFromRemoteRequest(
                    volume_id=vid,
                    collection=collection,
                    keep_remote_dat_file=_has_flag(args, "keepRemoteDatFile"),
                )
            ):
                print(
                    f"downloaded {resp.processed} bytes "
                    f"({resp.processed_percentage:.0f}%)",
                    file=out,
                )
        print(f"volume {vid} dat restored locally", file=out)


# ----------------------------------------------------------------------
# operator surfaces over the master's and the servers' HTTP routes


def _http_json(url: str, timeout: float = 10.0) -> dict:
    import json as _json
    import urllib.request

    with urllib.request.urlopen(url, timeout=timeout) as r:
        return _json.loads(r.read())


@register
class ScrubStatus(Command):
    name = "scrub.status"
    help = (
        "scrub.status [-json] — per-node background-scrub health: sweep "
        "progress, corruption counts, quarantined shards"
    )

    def run(self, env, args, out):
        import json as _json

        dump = env.collect_topology()
        report = {}
        for n in dump.nodes:
            try:
                report[n.url] = _http_json(f"http://{n.url}/status")
            except OSError as e:
                report[n.url] = {"error": str(e)}
        if _has_flag(args, "json"):
            print(
                _json.dumps(
                    {
                        url: {
                            "Scrub": st.get("Scrub"),
                            "QuarantinedShards": st.get("QuarantinedShards"),
                            "error": st.get("error"),
                        }
                        for url, st in report.items()
                    }
                ),
                file=out,
            )
            return
        for url, st in sorted(report.items()):
            if "error" in st and "Scrub" not in st:
                print(f"{url}: unreachable ({st['error']})", file=out)
                continue
            scrub = st.get("Scrub") or {}
            quarantined = st.get("QuarantinedShards") or {}
            if scrub.get("Disabled"):
                print(f"{url}: scrub disabled", file=out)
            else:
                vols = scrub.get("Volumes") or []
                corrupt = sum(v.get("corruptions_found", 0) for v in vols)
                scanned = sum(v.get("scanned_bytes", 0) for v in vols)
                print(
                    f"{url}: sweeps {scrub.get('SweepsCompleted', 0)}"
                    f"{' (running)' if scrub.get('SweepRunning') else ''}, "
                    f"{len(vols)} volume(s) tracked, "
                    f"{scanned >> 20} MiB verified, "
                    f"{corrupt} corruption(s)",
                    file=out,
                )
                for v in vols:
                    if v.get("last_error"):
                        print(
                            f"  vid {v['volume_id']}"
                            f"{' (ec)' if v.get('is_ec') else ''}: "
                            f"{v['last_error']}",
                            file=out,
                        )
            for vid, sids in sorted(quarantined.items()):
                print(f"  vid {vid}: quarantined shards {sids}", file=out)


@register
class ScrubTrigger(Command):
    name = "scrub.trigger"
    help = (
        "scrub.trigger [-volumeId vid] [-node host:port] — start a sweep "
        "now (all nodes, or one node; with -volumeId that volume first)"
    )

    def run(self, env, args, out):
        vid = _flag(args, "volumeId")
        node = _flag(args, "node")
        dump = env.collect_topology()
        urls = [node] if node else [n.url for n in dump.nodes]
        qs = f"?volumeId={int(vid)}" if vid else ""
        for url in urls:
            try:
                _http_json(f"http://{url}/scrub/trigger{qs}")
                print(f"{url}: sweep triggered", file=out)
            except OSError as e:
                print(f"{url}: trigger failed: {e}", file=out)


@register
class RepairQueue(Command):
    name = "repair.queue"
    help = (
        "repair.queue [-json] — the master repair scheduler's tracked "
        "damage, backoff state, and recent repair history"
    )

    def run(self, env, args, out):
        import json as _json

        snap = _http_json(f"http://{env.master}/repair/queue")
        if _has_flag(args, "json"):
            print(_json.dumps(snap), file=out)
            return
        if snap.get("Disabled"):
            print(
                "repair scheduler disabled on this master "
                "(-repairInterval 0); repair is manual "
                "(ec.rebuild / volume.fix.replication)",
                file=out,
            )
        else:
            cfg = snap.get("Config", {})
            print(
                f"scheduler: every {cfg.get('Interval')}s, "
                f"concurrency {cfg.get('Concurrency')}, "
                f"grace {cfg.get('GraceSeconds')}s, "
                f"active {snap.get('Active', 0)}",
                file=out,
            )
            tasks = snap.get("Tasks", [])
            if not tasks:
                print("no damage tracked", file=out)
            for task in tasks:
                state = (
                    "running"
                    if task["InFlight"]
                    else f"attempt {task['Attempts']}, next try "
                    f"{max(0, task['NextTry'] - time.time()):.0f}s"
                )
                print(
                    f"  {task['Kind']} vid {task['VolumeId']}: "
                    f"{task['Detail']} [{state}]"
                    + (
                        f" last error: {task['LastError']}"
                        if task["LastError"]
                        else ""
                    ),
                    file=out,
                )
            for h in snap.get("History", [])[-10:]:
                print(
                    f"  done: {h['Kind']} vid {h['VolumeId']} "
                    f"in {h['RepairSeconds']}s "
                    f"(time-to-repair {h['TimeToRepairSeconds']}s)",
                    file=out,
                )
        scrub = snap.get("Scrub") or {}
        for url, s in sorted(scrub.items()):
            print(
                f"  scrub@{url}: {s['Volumes']} vol(s), "
                f"{s['Corruptions']} corruption(s), "
                f"{s['QuarantinedShards']} quarantined shard(s)",
                file=out,
            )


@register
class NodeDrain(Command):
    name = "node.drain"
    help = (
        "node.drain -node host:port [-wait seconds] [-stop] [-json] — "
        "weedguard decommission (docs/HEALTH.md): mark the node "
        "draining (excluded from write assignment at once) and have "
        "the master RepairScheduler move its volumes and EC shards "
        "off; -wait polls until the node is empty, printing repair-"
        "queue evidence. -stop cancels a drain."
    )

    def run(self, env, args, out):
        import json as _json

        node = _flag(args, "node")
        if not node:
            raise ValueError("node.drain needs -node host:port")
        stop = _has_flag(args, "stop")
        try:
            wait_s = float(_flag(args, "wait", "0") or "0")
        except ValueError:
            wait_s = 0.0
        url = f"http://{env.master}/node/drain?node={node}"
        if stop:
            url += "&stop=1"
        snap = _http_json(url)
        if _has_flag(args, "json"):
            print(_json.dumps(snap), file=out)
            return
        if snap.get("error"):
            raise ValueError(snap["error"])
        if stop:
            print(f"drain of {node} cancelled", file=out)
            return
        if not snap.get("registered"):
            # an unregistered address drains vacuously — most likely a
            # typo; claiming "empty, safe to stop" here would invite
            # SIGTERMing the wrong (undrained) process
            print(
                f"WARNING: {node} is not registered with this master — "
                "check the address (the drain mark was recorded; "
                "-stop clears it)",
                file=out,
            )
            return
        if not snap.get("repairScheduler"):
            print(
                "WARNING: repair scheduler disabled on this master "
                "(-repairInterval 0) — the drain mark excludes the "
                "node from assignment but nothing will move its data",
                file=out,
            )
        print(
            f"draining {node}: {snap.get('volumes', 0)} volume(s), "
            f"{snap.get('ecShards', 0)} ec shard(s) to move",
            file=out,
        )
        deadline = time.time() + wait_s
        moved_evidence: list[str] = []
        while wait_s > 0:
            snap = _http_json(url + "&status=1")  # read-only poll form
            if snap.get("volumes", 0) == 0 and snap.get("ecShards", 0) == 0:
                break
            if time.time() >= deadline:
                print(
                    f"  still holding {snap.get('volumes', 0)} volume(s) "
                    f"/ {snap.get('ecShards', 0)} shard(s) after "
                    f"{wait_s:.0f}s — drain continues in the background",
                    file=out,
                )
                # name WHY it is stuck (a blocked drain usually means
                # no eligible target: add capacity)
                rq = _http_json(f"http://{env.master}/repair/queue")
                for t in rq.get("Tasks", []):
                    if t["Kind"].startswith("drain") and t.get("LastError"):
                        print(
                            f"  blocked: {t['Kind']} vid {t['VolumeId']}: "
                            f"{t['LastError']}",
                            file=out,
                        )
                return
            time.sleep(0.5)
        # repair-queue evidence: the drain tasks that moved the data
        rq = _http_json(f"http://{env.master}/repair/queue")
        for h in rq.get("History", []):
            if h["Kind"].startswith("drain"):
                moved_evidence.append(
                    f"  moved: {h['Kind']} vid {h['VolumeId']} "
                    f"in {h['RepairSeconds']}s"
                )
        for line in moved_evidence[-20:]:
            print(line, file=out)
        if wait_s > 0:
            print(
                f"{node} is empty — safe to stop the process "
                "(SIGTERM finishes in-flight work and deregisters)",
                file=out,
            )


# ----------------------------------------------------------------------
# tracing plane (docs/TRACING.md)


def _trace_nodes(env: CommandEnv) -> list[str]:
    """master + every volume server — the daemons the shell can reach
    from topology alone (gateways aren't registered there; query their
    /debug/traces directly)."""
    urls = [env.master]
    for n in env.collect_topology().nodes:
        urls.append(n.url)
    return urls


@register
class TraceStatus(Command):
    name = "trace.status"
    help = (
        "trace.status [-json] — per-node tracer health: enabled flag, "
        "ring occupancy, slow-trace threshold, in-flight requests"
    )

    def run(self, env, args, out):
        import json as _json

        report = {}
        for url in _trace_nodes(env):
            try:
                report[url] = _http_json(f"http://{url}/debug/traces?n=0")
            except (OSError, ValueError) as e:
                report[url] = {"error": str(e)}
        if _has_flag(args, "json"):
            print(_json.dumps(report), file=out)
            return
        for url, st in sorted(report.items()):
            if "error" in st:
                print(f"{url}: unreachable ({st['error']})", file=out)
                continue
            print(
                f"{url}: tracing {'on' if st.get('enabled') else 'OFF'}, "
                f"{st.get('recorded', 0)} span(s) recorded "
                f"(ring {st.get('ring_size')}, dropped {st.get('dropped', 0)}), "
                f"{st.get('inflight', 0)} in flight, "
                f"slow threshold {st.get('slow_ms', 0)}ms",
                file=out,
            )


@register
class TraceDump(Command):
    name = "trace.dump"
    help = (
        "trace.dump [-traceId <id>] [-n <spans-per-node>] [-slow] — "
        "merge /debug/traces from every node and print span trees "
        "(-slow prints each node's slowest-N instead of recent)"
    )

    def run(self, env, args, out):
        n = int(_flag(args, "n", "64") or 64)
        want = _flag(args, "traceId", "")
        use_slow = _has_flag(args, "slow")
        spans: list[dict] = []
        for url in _trace_nodes(env):
            try:
                payload = _http_json(f"http://{url}/debug/traces?n={n}")
            except (OSError, ValueError) as e:
                print(f"{url}: unreachable ({e})", file=out)
                continue
            spans.extend(payload.get("slowest" if use_slow else "recent", []))
        if want:
            spans = [s for s in spans if s.get("trace") == want]
        if not spans:
            print("no spans", file=out)
            return
        # group by trace, dedupe by (node, span) — a span can appear in
        # both a node's recent and slowest lists, but span ids from
        # DIFFERENT daemons must never overwrite each other — and order
        # trees by start time
        by_trace: dict[str, dict[tuple, dict]] = {}
        for s in spans:
            key = (s.get("node", ""), s["span"])
            by_trace.setdefault(s["trace"], {})[key] = s
        for trace_id in sorted(
            by_trace, key=lambda t: min(s["start"] for s in by_trace[t].values())
        ):
            tree = by_trace[trace_id]
            print(f"trace {trace_id}:", file=out)
            ids = {s["span"] for s in tree.values()}
            children: dict[str, list[dict]] = {}
            roots = []
            for s in sorted(tree.values(), key=lambda s: s["start"]):
                parent = s.get("parent") or ""
                # parent == own id only on a (residual) cross-process
                # id collision; treat as a root instead of a cycle
                if parent and parent != s["span"] and parent in ids:
                    children.setdefault(parent, []).append(s)
                else:
                    roots.append(s)

            def walk(s, depth):
                stages = s.get("stages_ms")
                stage_txt = (
                    " stages(ms)=" + ",".join(
                        f"{k}:{v}" for k, v in stages.items()
                    )
                    if stages
                    else ""
                )
                print(
                    "  " * (depth + 1)
                    + f"{s['name']} [{s['node']}] {s['dur_ms']}ms "
                    f"status={s['status']} bytes={s['bytes']} "
                    f"plane={s['plane']}{stage_txt}",
                    file=out,
                )
                for c in children.get(s["span"], []):
                    walk(c, depth + 1)

            for r in roots:
                walk(r, 0)


# ----------------------------------------------------------------------
# cluster telemetry plane (docs/TELEMETRY.md)


@register
class ClusterHealth(Command):
    name = "cluster.health"
    help = (
        "cluster.health [-json] — per-node weedguard health scores/"
        "states (docs/HEALTH.md) plus the leader collector's view: "
        "per-target scrape health (staleness, last error), alert "
        "counts, push-loop status"
    )

    def run(self, env, args, out):
        import json as _json

        snap = _http_json(f"http://{env.master}/cluster/health")
        if _has_flag(args, "json"):
            print(_json.dumps(snap), file=out)
            return
        nh = snap.get("NodeHealth") or {}
        if nh:
            if not nh.get("Enabled", True):
                print("health plane disabled (WEED_HEALTH=0)", file=out)
            for url, row in sorted((nh.get("Nodes") or {}).items()):
                flags = [
                    f
                    for f, on in (
                        ("lame-duck", row.get("LameDuck")),
                        ("draining", row.get("Draining")),
                        ("scrub-flagged", row.get("ScrubFlagged")),
                    )
                    if on
                ]
                line = (
                    f"  {url}: {row.get('State')} "
                    f"(score {row.get('Score')}, phi {row.get('Phi')}, "
                    f"err_ewma {row.get('ErrEwma')})"
                )
                if flags:
                    line += " [" + ", ".join(flags) + "]"
                if row.get("Reasons"):
                    line += " — " + ", ".join(row["Reasons"])
                print(line, file=out)
        if snap.get("Disabled"):
            print(
                "telemetry collector disabled on this master "
                "(-telemetryInterval 0)",
                file=out,
            )
            return
        print(
            f"collector: every {snap.get('IntervalSeconds')}s, "
            f"{snap.get('Cycles', 0)} cycle(s), window "
            f"{snap.get('WindowSeconds')}s, "
            f"{snap.get('FiringAlerts', 0)} firing / "
            f"{snap.get('PendingAlerts', 0)} pending alert(s)",
            file=out,
        )
        for url, row in sorted((snap.get("Targets") or {}).items()):
            state = "up" if row.get("Up") else "DOWN"
            line = (
                f"  {url} [{row.get('Kind')}]: {state}, "
                f"stale {row.get('StalenessSeconds', 0):.1f}s, "
                f"{row.get('Series', 0)} series, "
                f"{row.get('Scrapes', 0)} scrape(s)"
            )
            if row.get("LastError"):
                line += f" last error: {row['LastError']}"
            print(line, file=out)
        for job, push in sorted((snap.get("Push") or {}).items()):
            line = f"  push@{job}: last success {push.get('last_success_unix', 0)}"
            if push.get("last_error"):
                line += f" last error: {push['last_error']}"
            print(line, file=out)


@register
class ClusterAlerts(Command):
    name = "cluster.alerts"
    help = (
        "cluster.alerts [-json] — firing/pending alerts and recent "
        "resolved history from the master rule engine"
    )

    def run(self, env, args, out):
        import json as _json

        snap = _http_json(f"http://{env.master}/cluster/alerts")
        if _has_flag(args, "json"):
            print(_json.dumps(snap), file=out)
            return
        if snap.get("Disabled"):
            print(
                "telemetry collector disabled on this master "
                "(-telemetryInterval 0)",
                file=out,
            )
            return
        firing = snap.get("Firing") or []
        pending = snap.get("Pending") or []
        if not firing and not pending:
            print("no active alerts", file=out)
        for a in firing:
            print(
                f"FIRING [{a['Severity']}] {a['Alert']} @ {a['Target']}: "
                f"{a['Detail']}",
                file=out,
            )
        for a in pending:
            print(
                f"pending [{a['Severity']}] {a['Alert']} @ {a['Target']}: "
                f"{a['Detail']}",
                file=out,
            )
        for a in (snap.get("History") or [])[-10:]:
            print(
                f"  resolved {a['Alert']} @ {a['Target']} "
                f"(fired {a.get('FiredAtUnix', 0)}, "
                f"resolved {a.get('ResolvedAtUnix', 0)})",
                file=out,
            )


@register
class ClusterTop(Command):
    name = "cluster.top"
    help = (
        "cluster.top [-n 10] [-json] — busiest nodes by req/s (with "
        "5xx rate, http p99, and heartbeat-reported in-flight/write-"
        "queue depth) and biggest volumes by size"
    )

    def run(self, env, args, out):
        import json as _json

        n = int(_flag(args, "n", "10") or 10)
        snap = _http_json(f"http://{env.master}/cluster/top?n={n}")
        if _has_flag(args, "json"):
            print(_json.dumps(snap), file=out)
            return
        if snap.get("Disabled"):
            print(
                "telemetry collector disabled on this master "
                "(-telemetryInterval 0)",
                file=out,
            )
            return
        print("busiest nodes:", file=out)
        for row in snap.get("Nodes") or []:
            p99 = row.get("P99Ms")
            load = ""
            if row.get("InFlight") is not None:
                # QoS columns (volume servers only): the heartbeat load
                # signal queue-depth-aware assignment weighs
                load = (
                    f", inflight {row['InFlight']}, "
                    f"wqueue {row['WriteQueueDepth']}"
                )
            print(
                f"  {row['Url']} [{row['Kind']}]: "
                f"{row['ReqPerSec']:.2f} req/s, "
                f"{row['ErrPerSec']:.2f} err/s, "
                f"p99 {'-' if p99 is None else f'{p99:.1f}ms'}"
                + load,
                file=out,
            )
        print("biggest volumes:", file=out)
        for row in snap.get("Volumes") or []:
            print(
                f"  vid {row['VolumeId']} @ {row['Node']}: "
                f"{row['SizeBytes'] >> 20} MiB, "
                f"{row['FileCount']} file(s)"
                + (
                    f" [{row['Collection']}]" if row.get("Collection") else ""
                ),
                file=out,
            )


@register
class ClusterSlo(Command):
    name = "cluster.slo"
    help = (
        "cluster.slo [-json] — weedscope SLO engine: per-objective "
        "burn rates over the fast/slow windows, error-budget "
        "remaining, and the soak scorecard (availability, accepted "
        "p99.9, retry amplification, MTTR)"
    )

    def run(self, env, args, out):
        import json as _json

        snap = _http_json(f"http://{env.master}/cluster/slo")
        if _has_flag(args, "json"):
            print(_json.dumps(snap), file=out)
            return
        if snap.get("Disabled"):
            print(
                "telemetry collector disabled on this master "
                "(-telemetryInterval 0)",
                file=out,
            )
            return
        if not snap.get("Enabled", True):
            print("SLO engine disabled (WEED_SLO=0)", file=out)
            return
        print(
            f"windows: fast {snap.get('FastWindowSeconds')}s / "
            f"slow {snap.get('SlowWindowSeconds')}s, "
            f"burn threshold {snap.get('BurnThreshold')}x"
            + (
                f", BREACHING: {', '.join(snap['Breaching'])}"
                if snap.get("Breaching")
                else ""
            ),
            file=out,
        )
        for row in snap.get("Objectives") or []:
            thr = row.get("ThresholdSeconds")
            goal = (
                f"{row['Target']:.4%} non-5xx"
                if row.get("Kind") == "availability"
                else f"{row['Target']:.2%} of {row.get('Plane')} "
                f"under {thr * 1000.0:.0f}ms"
            )
            print(
                f"  {row['Verdict'].upper():8s} {row['Objective']}: {goal} "
                f"— burn fast {row['BurnFast']:.2f}x / "
                f"slow {row['BurnSlow']:.2f}x, "
                f"budget {row['BudgetRemaining']:.2%}",
                file=out,
            )
        card = snap.get("Scorecard") or {}
        if card:
            p999 = card.get("AcceptedP999Ms")
            mttr = card.get("MTTRSeconds")
            print(
                f"scorecard ({card.get('WindowSeconds')}s): "
                f"{card.get('Requests', 0):.0f} request(s), "
                f"availability {card.get('AvailabilityPct', 100.0):.4f}%, "
                f"p99.9 {'-' if p999 is None else f'{p999:.1f}ms'}, "
                f"retry x{card.get('RetryAmplification', 1.0):.3f}, "
                f"MTTR {'-' if mttr is None else f'{mttr:.1f}s'}",
                file=out,
            )


@register
class CapsuleCapture(Command):
    name = "capsule.capture"
    help = (
        "capsule.capture [-node host:port] [-reason R] [-json] — "
        "snapshot an incident capsule (blackbox ring, traces, folded "
        "stacks, metrics; TSDB window + verdicts on the master) NOW "
        "on every reachable node (or just -node)"
    )

    def run(self, env, args, out):
        import json as _json
        from urllib.parse import quote

        node = _flag(args, "node")
        reason = _flag(args, "reason", "shell")
        urls = [node] if node else _trace_nodes(env)
        rows = []
        for url in urls:
            try:
                manifest = _http_json(
                    f"http://{url}/capsule/capture?reason={quote(reason)}",
                    timeout=30.0,
                )
            except (OSError, ValueError) as e:
                rows.append({"Node": url, "Error": str(e)})
                continue
            manifest["Node"] = manifest.get("Node") or url
            rows.append(manifest)
        if _has_flag(args, "json"):
            print(_json.dumps({"Capsules": rows}), file=out)
            return
        for row in rows:
            if row.get("Error"):
                print(f"{row['Node']}: unreachable ({row['Error']})", file=out)
                continue
            ok = [f["Name"] for f in row.get("Files") or [] if f.get("Ok")]
            failed = [
                f["Name"] for f in row.get("Files") or [] if not f.get("Ok")
            ]
            line = f"{row['Node']}: captured {row['Id']} ({', '.join(ok)})"
            if failed:
                line += f" FAILED: {', '.join(failed)}"
            print(line, file=out)


@register
class CapsuleCollect(Command):
    name = "capsule.collect"
    help = (
        "capsule.collect [-reason R] [-n 5] [-json] — gather each "
        "node's newest capsule (optionally matching -reason) and merge "
        "their blackbox wide-events by trace id into one cross-node "
        "incident view"
    )

    def run(self, env, args, out):
        import json as _json

        reason = _flag(args, "reason")
        n = int(_flag(args, "n", "5") or 5)
        summary: list[dict] = []
        merged: dict[str, list[dict]] = {}
        for url in _trace_nodes(env):
            try:
                caps = (
                    _http_json(f"http://{url}/capsule/list").get("Capsules")
                    or []
                )
            except (OSError, ValueError) as e:
                summary.append({"Node": url, "Error": str(e)})
                continue
            if reason:
                caps = [c for c in caps if reason in c.get("Reason", "")]
            if not caps:
                summary.append({"Node": url, "Capsule": None})
                continue
            cap = caps[-1]  # list_capsules returns oldest first
            summary.append({
                "Node": url,
                "Capsule": cap.get("Id"),
                "Reason": cap.get("Reason"),
                "Trigger": cap.get("Trigger"),
                "CapturedAtUnix": cap.get("CapturedAtUnix"),
            })
            try:
                bb = _http_json(
                    f"http://{url}/capsule/get"
                    f"?id={cap['Id']}&file=blackbox.json"
                )
            except (OSError, ValueError):
                continue
            for rec in (bb.get("tail") or []) + (bb.get("ok") or []):
                tid = rec.get("trace") or ""
                if not tid:
                    continue
                rec = dict(rec)
                rec["node"] = url
                merged.setdefault(tid, []).append(rec)
        for evs in merged.values():
            evs.sort(key=lambda r: r.get("t", 0))
        if _has_flag(args, "json"):
            print(
                _json.dumps({"Nodes": summary, "Traces": merged}), file=out
            )
            return
        for row in summary:
            if row.get("Error"):
                print(f"{row['Node']}: unreachable ({row['Error']})", file=out)
            elif row.get("Capsule") is None:
                print(f"{row['Node']}: no matching capsule", file=out)
            else:
                print(
                    f"{row['Node']}: {row['Capsule']} "
                    f"({row['Trigger']}: {row['Reason']})",
                    file=out,
                )
        # widest traces first: the cross-node stories are the point
        ranked = sorted(
            merged.items(),
            key=lambda kv: (-len({e['node'] for e in kv[1]}), -len(kv[1])),
        )
        print(f"{len(merged)} trace(s) across capsules", file=out)
        for tid, evs in ranked[:n]:
            nodes = len({e["node"] for e in evs})
            print(f"  trace {tid} ({len(evs)} event(s), {nodes} node(s)):",
                  file=out)
            for e in evs:
                flags = f" [{','.join(e['flags'])}]" if e.get("flags") else ""
                print(
                    f"    {e['node']} {e['name']} {e['status']} "
                    f"{e['dur_ms']:.1f}ms{flags}",
                    file=out,
                )


@register
class ProfileCapture(Command):
    name = "profile.capture"
    help = (
        "profile.capture [-node host:port] [-seconds 2] [-top 15] "
        "[-folded] — capture folded stacks from a node's continuous "
        "sampling profiler (default: every node, ranked)"
    )

    def run(self, env, args, out):
        node = _flag(args, "node")
        seconds = float(_flag(args, "seconds", "2") or 2)
        top = int(_flag(args, "top", "15") or 15)
        urls = [node] if node else _trace_nodes(env)
        for url in urls:
            try:
                payload = _http_json(
                    f"http://{url}/debug/profile?seconds={seconds}",
                    timeout=seconds + 15.0,
                )
            except (OSError, ValueError) as e:
                print(f"{url}: unreachable ({e})", file=out)
                continue
            stacks = payload.get("stacks") or {}
            print(
                f"{url}: {payload.get('samples', 0)} sample(s) over "
                f"{payload.get('seconds')}s "
                f"(interval {payload.get('interval_ms')}ms, "
                f"{'running' if payload.get('running') else 'PAUSED'})",
                file=out,
            )
            ranked = sorted(stacks.items(), key=lambda kv: -kv[1])
            if _has_flag(args, "folded"):
                for stack, count in ranked:
                    print(f"{stack} {count}", file=out)
                continue
            for stack, count in ranked[:top]:
                # print the innermost frames; full stacks via -folded
                leaf = ";".join(stack.split(";")[-3:])
                print(f"  {count:6d}  {leaf}", file=out)


# ----------------------------------------------------------------------
# tiering plane operator surface (docs/TIERING.md)


def _http_json_post(url: str, timeout: float = 10.0) -> dict:
    import json as _json
    import urllib.request

    req = urllib.request.Request(url, method="POST", data=b"")
    with urllib.request.urlopen(req, timeout=timeout) as r:
        return _json.loads(r.read())


@register
class TierStatus(Command):
    name = "tier.status"
    help = (
        "tier.status [-json] — scheduler rules + recent moves from the "
        "master, and per-node tiered-volume state from every holder"
    )

    def run(self, env, args, out):
        import json as _json

        try:
            sched = _http_json(f"http://{env.master}/cluster/tier")
        except (OSError, ValueError) as e:
            sched = {"error": str(e)}
        nodes = {}
        dump = env.collect_topology()
        for n in dump.nodes:
            try:
                nodes[n.url] = _http_json(f"http://{n.url}/tier/status")
            except (OSError, ValueError) as e:
                nodes[n.url] = {"error": str(e)}
        if _has_flag(args, "json"):
            print(_json.dumps({"Scheduler": sched, "Nodes": nodes}), file=out)
            return
        if sched.get("Disabled"):
            print(
                "tier scheduler disabled on this master (-tierInterval 0); "
                "tiering is manual (tier.move)",
                file=out,
            )
        elif "error" in sched:
            print(f"master unreachable: {sched['error']}", file=out)
        else:
            rules = sched.get("Rules") or {}
            print(
                f"scheduler: every {sched.get('IntervalSeconds')}s, "
                f"backend '{rules.get('Backend', '')}', "
                f"min age {rules.get('MinAgeSeconds')}s, "
                f"cold <= {rules.get('ColdReadsPerSec')}/s, "
                f"hot > {rules.get('HotReadsPerSec')}/s, "
                f"active {sched.get('Active', 0)}, "
                f"started {sched.get('MovesStarted', 0)}, "
                f"failed {sched.get('MovesFailed', 0)}",
                file=out,
            )
            for h in (sched.get("History") or [])[-10:]:
                print(
                    f"  {h['Direction']} vid {h['VolumeId']} @ {h['Holder']} "
                    f"in {h['Seconds']}s"
                    + (f" ERROR: {h['Error']}" if h.get("Error") else ""),
                    file=out,
                )
        for url, st in sorted(nodes.items()):
            if "error" in st:
                print(f"{url}: unreachable ({st['error']})", file=out)
                continue
            rows = [
                (int(vid), row) for vid, row in st.items()
                if isinstance(row, dict)
            ]
            if not rows:
                continue
            print(f"{url}:", file=out)
            for vid, row in sorted(rows):
                if row.get("Tiered"):
                    print(
                        f"  vid {vid}: TIERED -> {row.get('Backend')} "
                        f"(remote {row.get('RemoteShards')}, "
                        f"local {row.get('LocalShards')})",
                        file=out,
                    )
                else:
                    print(
                        f"  vid {vid}: local shards {row.get('LocalShards')}",
                        file=out,
                    )


@register
class TierMove(Command):
    name = "tier.move"
    help = (
        "tier.move -volumeId vid -dest backend.name [-in] "
        "[-node host:port] — move an EC volume's shards out to the "
        "backend (or back in with -in) on every holder"
    )

    def run(self, env, args, out):
        import json as _json

        vid = _flag(args, "volumeId")
        if not vid:
            print("tier.move: -volumeId required", file=out)
            return
        direction = "in" if _has_flag(args, "in") else "out"
        dest = _flag(args, "dest")
        if direction == "out" and not dest:
            print("tier.move: -dest backend.name required for tier-out", file=out)
            return
        node = _flag(args, "node")
        if node:
            urls = [node]
        else:
            # every node that holds shards of this volume (tier-out is
            # per-holder: each node streams its OWN shards out)
            urls = []
            dump = env.collect_topology()
            for n in dump.nodes:
                try:
                    st = _http_json(f"http://{n.url}/tier/status")
                except (OSError, ValueError):
                    continue
                if vid in st:
                    urls.append(n.url)
        if not urls:
            print(f"tier.move: no holder found for vid {vid}", file=out)
            return
        qs = f"volumeId={vid}&direction={direction}"
        if direction == "out":
            qs += f"&destination={dest}"
        for url in urls:
            try:
                result = _http_json_post(
                    f"http://{url}/tier/move?{qs}", timeout=600.0
                )
            except (OSError, ValueError) as e:
                print(f"{url}: FAILED ({e})", file=out)
                continue
            print(f"{url}: {_json.dumps(result)}", file=out)


def _http_text(url: str, timeout: float = 10.0) -> str:
    import urllib.request

    with urllib.request.urlopen(url, timeout=timeout) as r:
        return r.read().decode("utf-8", "replace")


@register
class ReplicationLag(Command):
    name = "replication.lag"
    help = (
        "replication.lag [-json] — cross-cluster replication consumer "
        "lag as seen by the leader's telemetry rings (filer-exposed "
        "weed_replication_lag_events), plus any firing lag alerts"
    )

    def run(self, env, args, out):
        import json as _json

        try:
            alerts = _http_json(f"http://{env.master}/cluster/alerts")
        except (OSError, ValueError) as e:
            alerts = {"error": str(e)}
        rows = {}
        # scrape the registered filer gateways directly: the producer
        # side's view of queue depth is authoritative for lag
        try:
            health = _http_json(f"http://{env.master}/cluster/health")
        except (OSError, ValueError):
            health = {}
        for url, row in (health.get("Targets") or {}).items():
            if row.get("Kind") != "filer":
                continue
            try:
                text = _http_text(f"http://{url}/metrics")
            except (OSError, ValueError) as e:
                rows[url] = {"error": str(e)}
                continue
            lag = None
            for line in text.splitlines():
                if line.startswith("weed_replication_lag_events"):
                    try:
                        lag = float(line.rsplit(None, 1)[1])
                    except (IndexError, ValueError):
                        pass
            rows[url] = {"LagEvents": lag}
        firing = [
            a for a in (alerts.get("Firing") or [])
            if a.get("Alert") == "replication_lag"
        ]
        if _has_flag(args, "json"):
            print(_json.dumps({"Filers": rows, "Alerts": firing}), file=out)
            return
        if not rows:
            print(
                "no filer gateways registered with the master "
                "(is telemetry on, and did the filer announce?)",
                file=out,
            )
        for url, row in sorted(rows.items()):
            if "error" in row:
                print(f"{url}: unreachable ({row['error']})", file=out)
            elif row["LagEvents"] is None:
                print(
                    f"{url}: no lag metric (no notification queue "
                    f"configured on this filer)",
                    file=out,
                )
            else:
                print(f"{url}: {row['LagEvents']:.0f} event(s) behind", file=out)
        for a in firing:
            print(
                f"ALERT {a.get('Severity')}: {a.get('Target')} "
                f"{a.get('Detail')}",
                file=out,
            )
