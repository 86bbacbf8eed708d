"""Replication source: reads chunk bytes out of the source cluster.

Behavioral match of weed/replication/source/filer_source.go: given a
chunk fid, look its volume up through the source filer's LookupVolume
and fetch the blob from a volume server.

The port of seaweedfs_tpu/replication/source.py. It tries every location
the lookup returns, in its order, where the reference tries the first
alone: after a shard holder of an EC volume is lost, the master lists it
until its heartbeat lapses, and a survivor serves the chunk (decoding
the lost shards' bytes)."""

from __future__ import annotations

import grpc

from seaweedfs_tpu_torch.client import operation as op
from seaweedfs_tpu_torch.pb import filer_pb2 as fpb, rpc


class FilerSource:
    def __init__(self, grpc_address: str, directory: str = "/"):
        # grpc_address is "host:httpPort" — the +10000 convention applies
        self.filer = grpc_address
        self.dir = directory.rstrip("/") or "/"
        self._channel: grpc.Channel | None = None

    def _stub(self):
        if self._channel is None:
            self._channel = rpc.dial(rpc.grpc_address(self.filer))
        return rpc.filer_stub(self._channel)

    def lookup_file_urls(self, fid: str) -> list[str]:
        vid = fid.split(",")[0]
        resp = self._stub().LookupVolume(fpb.LookupVolumeRequest(volume_ids=[vid]))
        locs = resp.locations_map.get(vid)
        if locs is None or not locs.locations:
            raise RuntimeError(f"volume {vid} not found via filer {self.filer}")
        return [f"{loc.url}/{fid}" for loc in locs.locations]

    def read_chunk(self, fid: str) -> bytes:
        error = None
        for url in self.lookup_file_urls(fid):
            try:
                return op.download(url)[0]
            except OSError as e:
                error = e
        raise error

    def close(self) -> None:
        if self._channel is not None:
            self._channel.close()
