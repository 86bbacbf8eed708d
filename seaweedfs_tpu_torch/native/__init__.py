"""Host C shims of the port (the counterpart of seaweedfs_tpu/native)."""
