from seaweedfs_tpu_torch.security.jwt import (
    decode_jwt,
    gen_jwt,
    jwt_from_headers,
    JwtError,
)
from seaweedfs_tpu_torch.security.guard import Guard, UnauthorizedError

__all__ = [
    "Guard",
    "UnauthorizedError",
    "JwtError",
    "decode_jwt",
    "gen_jwt",
    "jwt_from_headers",
]
