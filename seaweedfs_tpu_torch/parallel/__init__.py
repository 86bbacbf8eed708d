"""Batched EC over a mesh of devices (see parallel/mesh_codec.py)."""

from seaweedfs_tpu_torch.parallel.mesh_codec import (
    STRIPE_AXIS,
    VOL_AXIS,
    Mesh,
    MeshCodec,
    Sharded,
    make_mesh,
)

__all__ = ["Mesh", "MeshCodec", "STRIPE_AXIS", "Sharded", "VOL_AXIS", "make_mesh"]
