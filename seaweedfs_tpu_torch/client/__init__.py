"""Client operations: assign, upload, lookup, delete and submit over the
master's and the volume servers' HTTP and gRPC surfaces (operation.py),
with the unified retry policy (retry.py). The master's /submit and its
leader proxy use them. The master client with its vid map
(masterclient.py, vid_map.py) waits for ROADMAP item 10."""
