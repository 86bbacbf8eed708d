"""The node-health pieces the volume server builds: the disk watchdog
that flips a node into lame-duck mode, and the gray-failure detector
state it reports (health.py). The raft master tier of
seaweedfs_tpu/cluster/ is not part of the port yet (ROADMAP item 7)."""
