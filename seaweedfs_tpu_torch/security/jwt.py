"""HS256 JSON Web Tokens carrying a file-id claim, stdlib-only.

Behavioral match of the reference's weed/security/jwt.go: tokens sign
the claim set {"fid": <file id>} with optional "exp"/"nbf" Unix-seconds
claims (jwt.go:20-41); empty signing key means security is off and
gen_jwt returns "" (jwt.go:22-24). Verification rejects non-HMAC algs
(jwt.go:60-65), bad signatures, and expired / not-yet-valid tokens.
The token travels as `?jwt=` query param or `Authorization: BEARER`
header (jwt.go:43-57).
"""

from __future__ import annotations

import base64
import hashlib
import hmac
import json
import time


class JwtError(Exception):
    pass


def _b64url(data: bytes) -> str:
    return base64.urlsafe_b64encode(data).rstrip(b"=").decode("ascii")


def _b64url_decode(data: str) -> bytes:
    pad = "=" * (-len(data) % 4)
    return base64.urlsafe_b64decode(data + pad)


def gen_jwt(signing_key: bytes | str, expires_after_sec: int, file_id: str) -> str:
    """Sign {"fid": file_id} with HS256; "" when no key is configured."""
    if not signing_key:
        return ""
    if isinstance(signing_key, str):
        signing_key = signing_key.encode()
    claims: dict = {"fid": file_id}
    if expires_after_sec > 0:
        claims["exp"] = int(time.time()) + expires_after_sec
    header = _b64url(json.dumps({"alg": "HS256", "typ": "JWT"}).encode())
    payload = _b64url(json.dumps(claims, separators=(",", ":")).encode())
    signing_input = f"{header}.{payload}".encode()
    sig = hmac.new(signing_key, signing_input, hashlib.sha256).digest()
    return f"{header}.{payload}.{_b64url(sig)}"


def decode_jwt(signing_key: bytes | str, token: str) -> dict:
    """Verify signature + exp/nbf; returns the claims dict or raises JwtError."""
    if isinstance(signing_key, str):
        signing_key = signing_key.encode()
    parts = token.split(".")
    if len(parts) != 3:
        raise JwtError("malformed token")
    header_b64, payload_b64, sig_b64 = parts
    try:
        header = json.loads(_b64url_decode(header_b64))
        claims = json.loads(_b64url_decode(payload_b64))
        sig = _b64url_decode(sig_b64)
    except (ValueError, json.JSONDecodeError) as e:
        raise JwtError(f"undecodable token: {e}") from e
    if header.get("alg") != "HS256":
        raise JwtError("unknown token method")
    expect = hmac.new(
        signing_key, f"{header_b64}.{payload_b64}".encode(), hashlib.sha256
    ).digest()
    if not hmac.compare_digest(sig, expect):
        raise JwtError("bad signature")
    now = time.time()
    if "exp" in claims and now > float(claims["exp"]):
        raise JwtError("token expired")
    if "nbf" in claims and now < float(claims["nbf"]):
        raise JwtError("token not yet valid")
    return claims


def jwt_from_headers(query: dict, headers) -> str:
    """Extract the token the way the reference's GetJwt does: `?jwt=`
    first, then `Authorization: BEARER <t>` (jwt.go:43-57)."""
    vals = query.get("jwt")
    if vals:
        return vals[0] if isinstance(vals, list) else vals
    bearer = headers.get("Authorization", "") if headers is not None else ""
    if len(bearer) > 7 and bearer[:6].upper() == "BEARER":
        return bearer[7:]
    return ""
