"""Client operations: assign, upload, lookup, delete and submit over the
master's and the volume servers' HTTP and gRPC surfaces (operation.py),
with the unified retry policy (retry.py), and the master client: a
vid -> locations map (vid_map.py) fed by the master's KeepConnected
stream (masterclient.py)."""
from seaweedfs_tpu_torch.client.masterclient import MasterClient
from seaweedfs_tpu_torch.client.vid_map import Location, VidMap

__all__ = ["MasterClient", "Location", "VidMap"]
