"""AWS Signature Version 4 verification.

The reference's weed/s3api/s3api_auth.go only *classifies* requests
(V4 / V2 / presigned / anonymous / JWT) — the v0 snapshot performs no
credential checking. This build implements real verification as a
strict superset: when identities are configured the gateway recomputes
the V4 signature (canonical request → string-to-sign → derived signing
key, per the AWS SigV4 spec) for both header auth and presigned URLs;
with no identities configured every request is allowed, matching the
reference's effective open behavior.

The port of seaweedfs_tpu/s3api/auth.py. `sigv4_sign` stays public:
every AWS-protocol client of the port signs with it.
"""

from __future__ import annotations

import datetime
import hashlib
import hmac
import urllib.parse

from seaweedfs_tpu_torch.s3api.errors import s3_error

SIGN_V4_ALGORITHM = "AWS4-HMAC-SHA256"
UNSIGNED_PAYLOAD = "UNSIGNED-PAYLOAD"
STREAMING_PAYLOAD = "STREAMING-AWS4-HMAC-SHA256-PAYLOAD"
MAX_CLOCK_SKEW_SEC = 15 * 60
MAX_PRESIGNED_EXPIRES_SEC = 7 * 24 * 3600


def _hmac(key: bytes, msg: str) -> bytes:
    return hmac.new(key, msg.encode(), hashlib.sha256).digest()


def _sha256_hex(data: bytes) -> str:
    return hashlib.sha256(data).hexdigest()


def derive_signing_key(secret: str, date: str, region: str, service: str) -> bytes:
    k = _hmac(("AWS4" + secret).encode(), date)
    k = _hmac(k, region)
    k = _hmac(k, service)
    return _hmac(k, "aws4_request")


def sigv4_sign(
    method: str,
    path: str,
    query_string: str,
    headers: dict,
    payload_hash: str,
    access_key: str,
    secret_key: str,
    region: str,
    service: str,
    amz_date: str,
) -> str:
    """The client-side SigV4 Authorization header value — the single
    home of the canonical-request → string-to-sign → signature chain
    for every AWS-protocol client in the repo (S3 data plane, SQS
    notifications). `headers` must already include host and x-amz-date;
    values are trimmed per the spec."""
    date = amz_date[:8]
    signed = sorted(k.lower() for k in headers)
    lower = {k.lower(): str(v).strip() for k, v in headers.items()}
    canonical = "\n".join(
        [
            method,
            path,
            query_string,
            "".join(f"{k}:{lower[k]}\n" for k in signed),
            ";".join(signed),
            payload_hash,
        ]
    )
    scope = f"{date}/{region}/{service}/aws4_request"
    string_to_sign = "\n".join(
        [
            "AWS4-HMAC-SHA256",
            amz_date,
            scope,
            hashlib.sha256(canonical.encode()).hexdigest(),
        ]
    )
    signature = hmac.new(
        derive_signing_key(secret_key, date, region, service),
        string_to_sign.encode(),
        hashlib.sha256,
    ).hexdigest()
    return (
        f"AWS4-HMAC-SHA256 Credential={access_key}/{scope}, "
        f"SignedHeaders={';'.join(signed)}, Signature={signature}"
    )


def uri_encode(value: str, encode_slash: bool = True) -> str:
    safe = "-_.~" + ("" if encode_slash else "/")
    return urllib.parse.quote(value, safe=safe)


def canonical_query_string(query: dict[str, list[str]], skip: tuple[str, ...] = ()) -> str:
    pairs = []
    for k in sorted(query):
        if k in skip:
            continue
        for v in sorted(query[k]):
            pairs.append(f"{uri_encode(k)}={uri_encode(v)}")
    return "&".join(pairs)


def canonical_request(
    method: str,
    path: str,
    query: dict[str, list[str]],
    headers,
    signed_headers: list[str],
    payload_hash: str,
    skip_query: tuple[str, ...] = (),
) -> str:
    canon_headers = "".join(
        f"{h}:{' '.join(str(headers.get(h, '')).split())}\n" for h in signed_headers
    )
    return "\n".join(
        [
            method,
            uri_encode(path, encode_slash=False) or "/",
            canonical_query_string(query, skip=skip_query),
            canon_headers,
            ";".join(signed_headers),
            payload_hash,
        ]
    )


def string_to_sign(amz_date: str, scope: str, canon_req: str) -> str:
    return "\n".join(
        [SIGN_V4_ALGORITHM, amz_date, scope, _sha256_hex(canon_req.encode())]
    )


class Identity:
    def __init__(self, name: str, access_key: str, secret_key: str, actions=("Admin",)):
        self.name = name
        self.access_key = access_key
        self.secret_key = secret_key
        self.actions = tuple(actions)


class IdentityAccessManagement:
    """access-key registry + V4 verifier. No identities = open gateway."""

    def __init__(self, identities: list[Identity] | None = None):
        self._by_access_key = {i.access_key: i for i in (identities or [])}

    @property
    def is_enabled(self) -> bool:
        return bool(self._by_access_key)

    def lookup(self, access_key: str) -> Identity:
        ident = self._by_access_key.get(access_key)
        if ident is None:
            raise s3_error("InvalidAccessKeyId")
        return ident

    # ------------------------------------------------------------------
    def authenticate(self, method: str, path: str, query: dict, headers, body: bytes | None):
        """Verify the request; returns the Identity (or None when open /
        anonymous). Raises S3Error on failure.

        `body` may be None for streaming payloads (the seed signature is
        checked against STREAMING-AWS4-HMAC-SHA256-PAYLOAD; per-chunk
        signatures are the chunked reader's job)."""
        if not self.is_enabled:
            return None
        auth_header = headers.get("Authorization", "")
        if auth_header.startswith(SIGN_V4_ALGORITHM):
            return self._verify_header_v4(method, path, query, headers, body, auth_header)
        if "X-Amz-Credential" in query:
            return self._verify_presigned_v4(method, path, query, headers)
        raise s3_error("AccessDenied")

    def seed_signature(self, method: str, path: str, query: dict, headers) -> tuple[bytes, str, str, str]:
        """For aws-chunked uploads: (signing_key, seed_signature,
        amz_date, scope) the chunked reader chains from."""
        auth_header = headers.get("Authorization", "")
        credential, signed_headers, signature = _parse_auth_header(auth_header)
        access_key, date, region, service = _parse_credential(credential)
        ident = self.lookup(access_key)
        key = derive_signing_key(ident.secret_key, date, region, service)
        scope = f"{date}/{region}/{service}/aws4_request"
        return key, signature, headers.get("x-amz-date", ""), scope

    # ------------------------------------------------------------------
    def _verify_header_v4(self, method, path, query, headers, body, auth_header):
        credential, signed_headers, signature = _parse_auth_header(auth_header)
        access_key, date, region, service = _parse_credential(credential)
        ident = self.lookup(access_key)
        amz_date = headers.get("x-amz-date") or headers.get("X-Amz-Date", "")
        _check_skew(amz_date)
        payload_hash = headers.get("x-amz-content-sha256", UNSIGNED_PAYLOAD)
        if payload_hash not in (UNSIGNED_PAYLOAD, STREAMING_PAYLOAD) and body is not None:
            if _sha256_hex(body) != payload_hash:
                raise s3_error("SignatureDoesNotMatch")
        canon = canonical_request(
            method, path, query, _LowerHeaders(headers), signed_headers, payload_hash
        )
        scope = f"{date}/{region}/{service}/aws4_request"
        sts = string_to_sign(amz_date, scope, canon)
        key = derive_signing_key(ident.secret_key, date, region, service)
        expect = hmac.new(key, sts.encode(), hashlib.sha256).hexdigest()
        if not hmac.compare_digest(expect, signature):
            raise s3_error("SignatureDoesNotMatch")
        return ident

    def _verify_presigned_v4(self, method, path, query, headers):
        try:
            credential = query["X-Amz-Credential"][0]
            amz_date = query["X-Amz-Date"][0]
            signed_headers = query["X-Amz-SignedHeaders"][0].split(";")
            signature = query["X-Amz-Signature"][0]
        except (KeyError, IndexError):
            raise s3_error("MissingFields") from None
        access_key, date, region, service = _parse_credential(credential)
        ident = self.lookup(access_key)
        # Presigned URLs are bounded by their own expiry window, not the
        # 15-minute header-auth skew check (X-Amz-Expires may validly be
        # up to 7 days).
        try:
            expires = int(query.get("X-Amz-Expires", ["900"])[0])
        except ValueError:
            raise s3_error("AuthorizationQueryParametersError") from None
        if not 1 <= expires <= MAX_PRESIGNED_EXPIRES_SEC:
            raise s3_error("AuthorizationQueryParametersError")
        try:
            t = datetime.datetime.strptime(amz_date, "%Y%m%dT%H%M%SZ").replace(
                tzinfo=datetime.timezone.utc
            )
        except ValueError:
            raise s3_error("AuthorizationHeaderMalformed") from None
        now = datetime.datetime.now(datetime.timezone.utc)
        if now > t + datetime.timedelta(seconds=expires):
            raise s3_error("AccessDenied")
        canon = canonical_request(
            method,
            path,
            query,
            _LowerHeaders(headers),
            signed_headers,
            UNSIGNED_PAYLOAD,
            skip_query=("X-Amz-Signature",),
        )
        scope = f"{date}/{region}/{service}/aws4_request"
        sts = string_to_sign(amz_date, scope, canon)
        key = derive_signing_key(ident.secret_key, date, region, service)
        expect = hmac.new(key, sts.encode(), hashlib.sha256).hexdigest()
        if not hmac.compare_digest(expect, signature):
            raise s3_error("SignatureDoesNotMatch")
        return ident


class _LowerHeaders:
    """case-insensitive header view with lower-case canonical keys."""

    def __init__(self, headers):
        self._h = {str(k).lower(): v for k, v in dict(headers).items()}

    def get(self, key, default=""):
        return self._h.get(key.lower(), default)


def _parse_auth_header(auth_header: str) -> tuple[str, list[str], str]:
    rest = auth_header[len(SIGN_V4_ALGORITHM):].strip()
    parts = {}
    for piece in rest.split(","):
        k, _, v = piece.strip().partition("=")
        parts[k] = v
    try:
        credential = parts["Credential"]
        signed_headers = parts["SignedHeaders"].split(";")
        signature = parts["Signature"]
    except KeyError:
        raise s3_error("AuthorizationHeaderMalformed") from None
    return credential, signed_headers, signature


def _parse_credential(credential: str) -> tuple[str, str, str, str]:
    bits = credential.split("/")
    if len(bits) != 5 or bits[4] != "aws4_request":
        raise s3_error("AuthorizationHeaderMalformed")
    return bits[0], bits[1], bits[2], bits[3]


def _check_skew(amz_date: str) -> None:
    if not amz_date:
        raise s3_error("MissingFields")
    try:
        t = datetime.datetime.strptime(amz_date, "%Y%m%dT%H%M%SZ").replace(
            tzinfo=datetime.timezone.utc
        )
    except ValueError:
        raise s3_error("AuthorizationHeaderMalformed") from None
    now = datetime.datetime.now(datetime.timezone.utc)
    if abs((now - t).total_seconds()) > MAX_CLOCK_SKEW_SEC:
        raise s3_error("RequestTimeTooSkewed")


def sign_request_v4(
    method: str,
    path: str,
    query: dict[str, list[str]],
    headers: dict[str, str],
    payload: bytes,
    access_key: str,
    secret_key: str,
    region: str = "us-east-1",
    service: str = "s3",
    now: datetime.datetime | None = None,
) -> dict[str, str]:
    """Client-side signer (test harness + replication sinks): returns
    the headers to add (Authorization, x-amz-date, x-amz-content-sha256)."""
    now = now or datetime.datetime.now(datetime.timezone.utc)
    amz_date = now.strftime("%Y%m%dT%H%M%SZ")
    date = now.strftime("%Y%m%d")
    payload_hash = _sha256_hex(payload)
    all_headers = dict(headers)
    all_headers["x-amz-date"] = amz_date
    all_headers["x-amz-content-sha256"] = payload_hash
    signed = sorted(
        k.lower()
        for k in all_headers
        if k.lower() in ("host", "content-type") or k.lower().startswith("x-amz-")
    )
    canon = canonical_request(
        method, path, query, _LowerHeaders(all_headers), signed, payload_hash
    )
    scope = f"{date}/{region}/{service}/aws4_request"
    sts = string_to_sign(amz_date, scope, canon)
    key = derive_signing_key(secret_key, date, region, service)
    signature = hmac.new(key, sts.encode(), hashlib.sha256).hexdigest()
    return {
        "x-amz-date": amz_date,
        "x-amz-content-sha256": payload_hash,
        "Authorization": (
            f"{SIGN_V4_ALGORITHM} Credential={access_key}/{scope}, "
            f"SignedHeaders={';'.join(signed)}, Signature={signature}"
        ),
    }
