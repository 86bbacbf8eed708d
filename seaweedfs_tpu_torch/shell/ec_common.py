"""EC admin planners — pure functions over in-memory EcNode state.

Behavioral match of weed/shell/command_ec_common.go and
command_ec_balance.go. Every planner takes `apply` (the reference's
applyBalancing flag, threaded through command_ec_common.go:18) so tests
can run the full plan without a cluster; when apply=True the plan step
issues the copy/mount/unmount/delete gRPC verbs.

The port of seaweedfs_tpu/shell/ec_common.py.
"""

from __future__ import annotations

from dataclasses import dataclass, field

from seaweedfs_tpu_torch.ec.ec_files import DATA_SHARDS, PARITY_SHARDS
from seaweedfs_tpu_torch.pb import rpc, volume_pb2
from seaweedfs_tpu_torch.shell.command_env import CommandEnv, TopologyNodeInfo

TOTAL_SHARDS_COUNT = DATA_SHARDS + PARITY_SHARDS


def shard_bits_to_ids(bits: int) -> list[int]:
    return [i for i in range(TOTAL_SHARDS_COUNT) if bits & (1 << i)]


def ids_to_shard_bits(ids) -> int:
    bits = 0
    for i in ids:
        bits |= 1 << i
    return bits


@dataclass
class EcNode:
    """Planner view of one volume server (command_ec_common.go EcNode)."""

    url: str
    dc: str
    rack: str
    free_ec_slot: int
    # vid -> (collection, shard-bit mask)
    ec_shards: dict[int, tuple[str, int]] = field(default_factory=dict)

    def shard_count(self) -> int:
        return sum(bin(bits).count("1") for _, bits in self.ec_shards.values())

    def local_shard_ids(self, vid: int) -> list[int]:
        entry = self.ec_shards.get(vid)
        return shard_bits_to_ids(entry[1]) if entry else []

    def add_shards(self, vid: int, collection: str, shard_ids) -> None:
        col, bits = self.ec_shards.get(vid, (collection, 0))
        self.ec_shards[vid] = (col, bits | ids_to_shard_bits(shard_ids))
        self.free_ec_slot -= len(list(shard_ids))

    def delete_shards(self, vid: int, shard_ids) -> None:
        entry = self.ec_shards.get(vid)
        if not entry:
            return
        col, bits = entry
        bits &= ~ids_to_shard_bits(shard_ids)
        if bits:
            self.ec_shards[vid] = (col, bits)
        else:
            del self.ec_shards[vid]
        self.free_ec_slot += len(list(shard_ids))


def collect_ec_nodes(env: CommandEnv, selected_dc: str = "") -> list[EcNode]:
    """Build planner state from one VolumeList call
    (command_ec_common.go collectEcNodes)."""
    dump = env.collect_topology()
    return ec_nodes_from_topology(dump.nodes, selected_dc)


def ec_nodes_from_topology(
    nodes: list[TopologyNodeInfo], selected_dc: str = ""
) -> list[EcNode]:
    out = []
    for n in nodes:
        if selected_dc and n.dc != selected_dc:
            continue
        # free slots in shard units: each volume slot holds a full
        # 14-shard set (command_ec_common.go countFreeShardSlots)
        used = len(n.volumes)
        free = max(0, (n.max_volumes - used)) * TOTAL_SHARDS_COUNT
        en = EcNode(url=n.url, dc=n.dc, rack=n.rack, free_ec_slot=free)
        for s in n.ec_shards:
            en.ec_shards[s["Id"]] = (s.get("Collection", ""), s["EcIndexBits"])
            en.free_ec_slot -= bin(s["EcIndexBits"]).count("1")
        out.append(en)
    return out


def balanced_ec_distribution(nodes: list[EcNode], shard_count: int = TOTAL_SHARDS_COUNT) -> list[EcNode]:
    """Assign `shard_count` shards round-robin over nodes sorted by
    free slots, skipping full nodes (command_ec_encode.go:240
    balancedEcDistribution after sortEcNodesByFreeslotsDecending)."""
    if not nodes:
        return []
    order = sorted(nodes, key=lambda n: -n.free_ec_slot)
    # spreadEcShards errors upfront when totalFreeEcSlots < TotalShardsCount;
    # same here — callers treat [] as "no capacity"
    if sum(max(n.free_ec_slot, 0) for n in order) < shard_count:
        return []
    assigned = {n.url: 0 for n in order}
    picked: list[EcNode] = []
    i = 0
    while len(picked) < shard_count:
        n = order[i % len(order)]
        if n.free_ec_slot - assigned[n.url] > 0:
            picked.append(n)
            assigned[n.url] += 1
        i += 1
    return picked


# ----------------------------------------------------------------------
# gRPC move primitives (no-ops when apply=False)


def copy_and_mount_shards(
    env: CommandEnv,
    target: EcNode,
    vid: int,
    collection: str,
    shard_ids: list[int],
    source_url: str,
    apply: bool = True,
) -> None:
    """Copy shards from source to target then mount them
    (oneServerCopyAndMountEcShardsFromSource)."""
    if apply:
        with env.volume_channel(target.url) as ch:
            stub = rpc.volume_stub(ch)
            if target.url != source_url:
                stub.VolumeEcShardsCopy(
                    volume_pb2.VolumeEcShardsCopyRequest(
                        volume_id=vid,
                        collection=collection,
                        shard_ids=shard_ids,
                        copy_ecx_file=True,
                        source_data_node=source_url,
                    )
                )
            stub.VolumeEcShardsMount(
                volume_pb2.VolumeEcShardsMountRequest(
                    volume_id=vid, collection=collection, shard_ids=shard_ids
                )
            )


def unmount_and_delete_shards(
    env: CommandEnv,
    source_url: str,
    vid: int,
    collection: str,
    shard_ids: list[int],
    apply: bool = True,
) -> None:
    if apply:
        with env.volume_channel(source_url) as ch:
            stub = rpc.volume_stub(ch)
            stub.VolumeEcShardsUnmount(
                volume_pb2.VolumeEcShardsUnmountRequest(volume_id=vid, shard_ids=shard_ids)
            )
            stub.VolumeEcShardsDelete(
                volume_pb2.VolumeEcShardsDeleteRequest(
                    volume_id=vid, collection=collection, shard_ids=shard_ids
                )
            )


def move_mounted_shard(
    env: CommandEnv,
    source: EcNode,
    dest: EcNode,
    vid: int,
    shard_id: int,
    apply: bool = True,
) -> None:
    """Move one mounted shard source→dest, updating planner state
    (moveMountedShardToEcNode)."""
    collection = source.ec_shards.get(vid, ("", 0))[0]
    copy_and_mount_shards(env, dest, vid, collection, [shard_id], source.url, apply)
    unmount_and_delete_shards(env, source.url, vid, collection, [shard_id], apply)
    dest.add_shards(vid, collection, [shard_id])
    source.delete_shards(vid, [shard_id])


# ----------------------------------------------------------------------
# balance planners (command_ec_balance.go)


def dedup_ec_shards(env: CommandEnv, nodes: list[EcNode], vid: int, apply: bool = True) -> int:
    """Drop duplicate copies of a shard, keeping the copy on the node
    with the fewest shards removed last (doDeduplicateEcShards)."""
    holders: dict[int, list[EcNode]] = {}
    for n in nodes:
        for sid in n.local_shard_ids(vid):
            holders.setdefault(sid, []).append(n)
    removed = 0
    for sid, owners in holders.items():
        if len(owners) <= 1:
            continue
        owners.sort(key=lambda n: n.shard_count(), reverse=True)
        for extra in owners[:-1]:  # keep the least-loaded owner
            collection = extra.ec_shards.get(vid, ("", 0))[0]
            unmount_and_delete_shards(env, extra.url, vid, collection, [sid], apply)
            extra.delete_shards(vid, [sid])
            removed += 1
    return removed


def balance_across_racks(env: CommandEnv, nodes: list[EcNode], vid: int, apply: bool = True) -> int:
    """Spread one volume's shards so no rack holds more than
    ceil(total/racks) (doBalanceEcShardsAcrossRacks)."""
    racks: dict[str, list[EcNode]] = {}
    for n in nodes:
        racks.setdefault(n.rack, []).append(n)
    shards_per_rack: dict[str, list[tuple[EcNode, int]]] = {r: [] for r in racks}
    total = 0
    for n in nodes:
        for sid in n.local_shard_ids(vid):
            shards_per_rack[n.rack].append((n, sid))
            total += 1
    if total == 0 or len(racks) <= 1:
        return 0
    average = -(-total // len(racks))  # ceil
    moves = 0
    overflow: list[tuple[EcNode, int]] = []
    for rack, entries in shards_per_rack.items():
        while len(entries) > average:
            overflow.append(entries.pop())
    for source, sid in overflow:
        # pick the rack with the fewest shards of this vid, then the
        # freest node on it
        dest_rack = min(shards_per_rack, key=lambda r: len(shards_per_rack[r]))
        candidates = [n for n in racks[dest_rack] if n.free_ec_slot > 0 and n is not source]
        if not candidates:
            continue
        dest = max(candidates, key=lambda n: n.free_ec_slot)
        move_mounted_shard(env, source, dest, vid, sid, apply)
        shards_per_rack[dest_rack].append((dest, sid))
        moves += 1
    return moves


def balance_within_racks(env: CommandEnv, nodes: list[EcNode], vid: int, apply: bool = True) -> int:
    """Within each rack, spread one volume's shards evenly over its
    nodes (doBalanceEcShardsWithinRacks)."""
    racks: dict[str, list[EcNode]] = {}
    for n in nodes:
        racks.setdefault(n.rack, []).append(n)
    moves = 0
    for rack_nodes in racks.values():
        owned: list[tuple[EcNode, int]] = []
        for n in rack_nodes:
            for sid in n.local_shard_ids(vid):
                owned.append((n, sid))
        if not owned or len(rack_nodes) <= 1:
            continue
        average = -(-len(owned) // len(rack_nodes))
        counts = {n.url: len(n.local_shard_ids(vid)) for n in rack_nodes}
        for source, sid in owned:
            if counts[source.url] <= average:
                continue
            candidates = [
                n
                for n in rack_nodes
                if counts[n.url] < average and n.free_ec_slot > 0 and n is not source
            ]
            if not candidates:
                continue
            dest = max(candidates, key=lambda n: n.free_ec_slot)
            move_mounted_shard(env, source, dest, vid, sid, apply)
            counts[source.url] -= 1
            counts[dest.url] += 1
            moves += 1
    return moves


def balance_ec_rack(env: CommandEnv, rack_nodes: list[EcNode], apply: bool = True) -> int:
    """Even out *total* shard counts inside one rack without stacking
    the same volume (balanceEcRack)."""
    if len(rack_nodes) <= 1:
        return 0
    total = sum(n.shard_count() for n in rack_nodes)
    average = total / len(rack_nodes)
    moves = 0
    moved = True
    while moved:
        moved = False
        nodes = sorted(rack_nodes, key=lambda n: n.shard_count())
        low, high = nodes[0], nodes[-1]
        if high.shard_count() > average and low.shard_count() + 1 <= average:
            for vid in list(high.ec_shards):
                if vid in low.ec_shards:
                    continue
                sids = high.local_shard_ids(vid)
                if not sids:
                    continue
                move_mounted_shard(env, high, low, vid, sids[0], apply)
                moves += 1
                moved = True
                break
    return moves


def balance_ec_volumes(
    env: CommandEnv,
    nodes: list[EcNode],
    collection: str | None = None,
    apply: bool = True,
) -> dict:
    """Full ec.balance pass: dedup → across racks → within racks →
    per-rack totals (balanceEcVolumes + balanceEcRack)."""
    vids = sorted(
        {
            vid
            for n in nodes
            for vid, (col, _) in n.ec_shards.items()
            if collection is None or col == collection
        }
    )
    stats = {"dedup": 0, "across_racks": 0, "within_racks": 0, "rack_total": 0}
    for vid in vids:
        stats["dedup"] += dedup_ec_shards(env, nodes, vid, apply)
    for vid in vids:
        stats["across_racks"] += balance_across_racks(env, nodes, vid, apply)
    for vid in vids:
        stats["within_racks"] += balance_within_racks(env, nodes, vid, apply)
    racks: dict[str, list[EcNode]] = {}
    for n in nodes:
        racks.setdefault(n.rack, []).append(n)
    for rack_nodes in racks.values():
        stats["rack_total"] += balance_ec_rack(env, rack_nodes, apply)
    return stats
