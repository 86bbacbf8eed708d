"""Long-lived master client.

Behavioral match of weed/wdclient/masterclient.go: a background thread
holds a KeepConnected bidirectional stream to the current master
leader, folds the pushed VolumeLocationDelta messages into a VidMap,
and fails over to the next seed master (or the pushed leader hint) when
the stream breaks (masterclient.go:44-117).

The port of seaweedfs_tpu/client/masterclient.py. stop() cancels the
open stream and joins the thread start() made.
"""

from __future__ import annotations

import queue
import threading
import time

import grpc

from seaweedfs_tpu_torch.client.vid_map import Location, VidMap
from seaweedfs_tpu_torch.pb import master_pb2, rpc
from seaweedfs_tpu_torch.pb.rpc import grpc_address as master_grpc_address


class MasterClient:
    """vid→location cache fed by the master's KeepConnected stream."""

    def __init__(self, name: str, masters: list[str]):
        self.name = name
        self.masters = list(masters)
        self.vid_map = VidMap()
        self.current_master: str = ""
        self._stop = threading.Event()
        self._connected = threading.Event()
        self._thread: threading.Thread | None = None
        self._call = None  # the open KeepConnected stream, cancelled by stop()

    # ------------------------------------------------------------------
    def start(self) -> None:
        self._thread = threading.Thread(
            target=self._keep_connected_loop, daemon=True, name=f"mc-{self.name}"
        )
        self._thread.start()

    def stop(self) -> None:
        self._stop.set()
        call = self._call
        if call is not None:
            call.cancel()
        if self._thread is not None:
            self._thread.join(timeout=10)

    def wait_until_connected(self, timeout: float = 10.0) -> bool:
        return self._connected.wait(timeout)

    # ------------------------------------------------------------------
    def lookup_file_id(self, fid: str) -> list[str]:
        try:
            return self.vid_map.lookup_file_id(fid)
        except KeyError:
            self._refresh(fid.split(",")[0])
            return self.vid_map.lookup_file_id(fid)

    def lookup_volume(self, vid: int) -> list[Location]:
        locs = self.vid_map.lookup(vid)
        if not locs:
            self._refresh(str(vid))
            locs = self.vid_map.lookup(vid)
        return locs

    def _refresh(self, vid_str: str) -> None:
        """Fallback unary LookupVolume when the push stream hasn't
        caught up yet (wdclient falls back the same way via
        LookupVolumeId)."""
        master = self.current_master or self.masters[0]
        with rpc.dial(master_grpc_address(master)) as ch:
            resp = rpc.master_stub(ch).LookupVolume(
                master_pb2.LookupVolumeRequest(vids=[vid_str])
            )
        for entry in resp.vid_locations:
            if entry.error:
                continue
            for loc in entry.locations:
                self.vid_map.add_location(
                    int(entry.vid), Location(loc.url, loc.public_url)
                )

    # ------------------------------------------------------------------
    def _keep_connected_loop(self) -> None:
        idx = 0
        while not self._stop.is_set():
            master = self.masters[idx % len(self.masters)]
            idx += 1
            leader = self._try_connect(master)
            if self._stop.is_set():
                return
            if leader and leader in self.masters:
                # follow the leader hint instead of round-robin
                idx = self.masters.index(leader)
            time.sleep(0.2)

    def _try_connect(self, master: str) -> str | None:
        """Run one KeepConnected stream until it breaks. Returns the
        leader hint if the master redirected us."""
        hello = queue.Queue()
        hello.put(master_pb2.ClientHello(name=self.name))

        def requests():
            while not self._stop.is_set():
                try:
                    yield hello.get(timeout=0.5)
                except queue.Empty:
                    continue

        try:
            with rpc.dial(master_grpc_address(master)) as ch:
                stream = self._call = rpc.master_stub(ch).KeepConnected(requests())
                if self._stop.is_set():  # stop() ran before the call was kept
                    stream.cancel()
                for delta in stream:
                    if self._stop.is_set():
                        return None
                    if (
                        delta.leader
                        and delta.leader != master
                        and delta.leader in self.masters
                    ):
                        # genuine redirect to another seed; a leader
                        # self-identity that merely spells the address
                        # differently (localhost vs 127.0.0.1) is not one
                        return delta.leader
                    self.current_master = master
                    self._connected.set()
                    loc = delta.location
                    if loc.url:
                        for vid in loc.new_vids:
                            self.vid_map.add_location(
                                vid, Location(loc.url, loc.public_url)
                            )
                        for vid in loc.deleted_vids:
                            self.vid_map.delete_location(vid, loc.url)
        except grpc.RpcError:
            pass
        self._connected.clear()
        return None
