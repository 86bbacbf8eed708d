"""VolumeLayout: writable-volume tracking per (collection, rp, ttl).

Behavioral match of reference weed/topology/volume_layout.go: vid →
location list, a writable set excluding readonly/oversized volumes,
random pick-for-write with optional DC/rack/node affinity, and
registration driven by heartbeats.
"""

from __future__ import annotations

import random
import threading
from typing import Optional

from seaweedfs_tpu_torch.storage.store import VolumeInfo
from seaweedfs_tpu_torch.topology.node import DataNode


class VolumeLayout:
    def __init__(self, rp_string: str, ttl_string: str, volume_size_limit: int):
        self.rp = rp_string
        self.ttl = ttl_string
        self.volume_size_limit = volume_size_limit
        self.vid2location: dict[int, list[DataNode]] = {}
        self.writables: list[int] = []
        self.readonly_vids: set[int] = set()
        self.oversized_vids: set[int] = set()
        self._lock = threading.RLock()

    def register_volume(self, v: VolumeInfo, dn: DataNode) -> None:
        with self._lock:
            nodes = self.vid2location.setdefault(v.id, [])
            if dn not in nodes:
                nodes.append(dn)
            # both directions: a vacuumed volume shrinking below the
            # limit or a readonly→writable flip must restore
            # writability (StartRefreshWritableVolumes role), not just
            # the degrading transitions
            if v.read_only:
                self.readonly_vids.add(v.id)
            else:
                self.readonly_vids.discard(v.id)
            if self._is_oversized(v):
                self.oversized_vids.add(v.id)
            else:
                self.oversized_vids.discard(v.id)
            self._refresh_writable(v.id)

    def unregister_volume(self, vid: int, dn: DataNode) -> None:
        with self._lock:
            nodes = self.vid2location.get(vid)
            if nodes and dn in nodes:
                nodes.remove(dn)
            if not nodes:
                self.vid2location.pop(vid, None)
                self._set_unwritable(vid)
                self.readonly_vids.discard(vid)
                self.oversized_vids.discard(vid)
            else:
                self._refresh_writable(vid)

    def _is_oversized(self, v: VolumeInfo) -> bool:
        return v.size >= self.volume_size_limit

    def _refresh_writable(self, vid: int) -> None:
        writable = (
            vid in self.vid2location
            and len(self.vid2location[vid]) > 0
            and vid not in self.readonly_vids
            and vid not in self.oversized_vids
        )
        if writable and vid not in self.writables:
            self.writables.append(vid)
        elif not writable:
            self._set_unwritable(vid)

    def _set_unwritable(self, vid: int) -> None:
        if vid in self.writables:
            self.writables.remove(vid)

    def set_oversized(self, vid: int) -> None:
        with self._lock:
            self.oversized_vids.add(vid)
            self._set_unwritable(vid)

    def set_readonly(self, vid: int, readonly: bool = True) -> None:
        with self._lock:
            if readonly:
                self.readonly_vids.add(vid)
            else:
                self.readonly_vids.discard(vid)
            self._refresh_writable(vid)

    def lookup(self, vid: int) -> list[DataNode]:
        with self._lock:
            return list(self.vid2location.get(vid, []))

    def active_volume_count(self) -> int:
        return len(self.writables)

    @staticmethod
    def _volume_load(nodes: list[DataNode]) -> int:
        """Cost of writing one volume: a write lands on EVERY replica
        (fan-out), so the slowest — most loaded — replica bounds it."""
        return max((dn.queue_load() for dn in nodes), default=0)

    def _health_filtered(self, health) -> list[int]:
        """Writable vids whose replicas are ALL assignable per the
        health plane (docs/HEALTH.md). Empty (or health None/disabled)
        → the caller falls back to the full writable set: availability
        beats precision when every volume touches a suspect node (the
        write may still succeed — hinted handoff covers the sick
        replica).

        The verdict is memoized per NODE for this pick: volumes number
        in the thousands while nodes number in the dozens, and each
        assignable() call walks a phi ring + env knobs — evaluating it
        per replica per vid under the layout lock would make assign
        latency scale with the volume count."""
        if health is None:
            return self.writables
        memo: dict[str, bool] = {}
        assignable = health.assignable

        def ok(dn) -> bool:
            v = memo.get(dn.url)
            if v is None:
                v = memo[dn.url] = assignable(dn.url)
            return v

        clean = [
            vid
            for vid in self.writables
            if all(ok(dn) for dn in self.vid2location.get(vid, ()))
        ]
        return clean or self.writables

    def pick_for_write(
        self,
        data_center: str = "",
        rack: str = "",
        data_node: str = "",
        rng: random.Random | None = None,
        policy: str = "p2c",
        health=None,
    ) -> tuple[int, list[DataNode]]:
        """Writable vid pick, optionally affine to a DC/rack/node
        (volume_layout.go:165 PickForWrite — reservoir sampling over
        matching replica locations when affinity is requested).

        `policy` (QoS plane, docs/QOS.md): "p2c" (default) runs
        power-of-two-choices over the writable set, weighted by the
        replica nodes' heartbeat-reported in-flight + write-queue
        depth — near-random load balance at random-pick cost, without
        the herd-to-the-idlest stampede a full argmin causes on stale
        signals. "random" is the pre-QoS pure-random pick
        (`-assignPolicy random`, and what WEED_QOS=0 restores).
        Affinity-constrained picks keep the reservoir path (the
        candidate set is already narrow).

        `health` (docs/HEALTH.md): the master's HealthPlane — volumes
        with a suspect/lame-duck/draining replica are excluded while a
        clean alternative exists, under BOTH policies (WEED_HEALTH=0
        makes every verdict healthy, restoring the old pool)."""
        rng = rng or random
        with self._lock:
            if not self.writables:
                raise ValueError("no writable volumes")
            candidates = self._health_filtered(health)
            if not data_center:
                if policy == "p2c" and len(candidates) > 1:
                    a, b = rng.sample(candidates, 2)
                    la = self._volume_load(self.vid2location[a])
                    lb = self._volume_load(self.vid2location[b])
                    if la == lb:
                        vid = a if rng.random() < 0.5 else b
                    else:
                        vid = a if la < lb else b
                    # least-loaded replica leads: callers route the
                    # first hop at locations[0]
                    nodes = sorted(
                        self.vid2location[vid],
                        key=lambda dn: dn.queue_load(),
                    )
                    return vid, nodes
                vid = rng.choice(candidates)
                return vid, list(self.vid2location[vid])
            chosen: Optional[tuple[int, DataNode]] = None
            # two passes at most: the health-filtered pool first, the
            # full writable set if the filter emptied THIS affinity
            # slice (availability beats precision, as above)
            for pool in (set(candidates), set(self.writables)):
                counter = 0
                for vid in self.writables:
                    if vid not in pool:
                        continue
                    for dn in self.vid2location.get(vid, []):
                        if dn.get_data_center().id != data_center:
                            continue
                        if rack and dn.get_rack().id != rack:
                            continue
                        if data_node and dn.id != data_node:
                            continue
                        counter += 1
                        if rng.randrange(counter) < 1:
                            chosen = (vid, dn)
                if chosen is not None:
                    break
            if chosen is None:
                raise ValueError(
                    f"no writable volumes in dc={data_center} rack={rack}"
                )
            # the affinity-matched node leads the location list, so
            # callers using locations[0] honor the requested placement
            vid, matched = chosen
            others = [d for d in self.vid2location[vid] if d is not matched]
            return vid, [matched, *others]
