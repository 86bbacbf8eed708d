""""native" EC codec backend: the SIMD C shim (csrc/gf256.c).

The counterpart of the reference's klauspost/reedsolomon AVX2 path
(ec_encoder.go:13), byte-identical to the numpy "cpu" backend. It runs
only when it is named (backend="native" or WEED_EC_CODEC=native): it
is the host codec the card is judged against, never a stand-in for a
missing card. codec.py registers it on first use.
"""

from seaweedfs_tpu_torch.ec.codec import register_backend
from seaweedfs_tpu_torch.native.gf import apply_matrix as native_apply_matrix

register_backend("native", native_apply_matrix)
