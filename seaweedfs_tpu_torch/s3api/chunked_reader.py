"""AWS streaming-SigV4 ("aws-chunked") payload decoder.

Behavioral match of weed/s3api/chunked_reader_v4.go: the body is a
sequence of

    <hex-size>;chunk-signature=<sig>\r\n<data>\r\n

frames ending with a zero-length chunk. The reference decodes the
framing and records each chunk signature; this build additionally
*verifies* the per-chunk signature chain when a signing key is supplied
(the full AWS spec the reference's minio-derived code stubs out):

    sig_n = HMAC(key, "AWS4-HMAC-SHA256-PAYLOAD\n{date}\n{scope}\n
                       {sig_{n-1}}\nSHA256("")\nSHA256(chunk_data)")

The port of seaweedfs_tpu/s3api/chunked_reader.py.
"""

from __future__ import annotations

import hashlib
import hmac
import io

from seaweedfs_tpu_torch.s3api.errors import s3_error

MAX_LINE_LENGTH = 4096
EMPTY_SHA256 = hashlib.sha256(b"").hexdigest()


class ChunkSignatureMismatch(Exception):
    pass


def decode_chunked_payload(
    stream: io.BufferedIOBase,
    signing_key: bytes | None = None,
    seed_signature: str = "",
    amz_date: str = "",
    scope: str = "",
) -> bytes:
    """Decode (and optionally verify) an aws-chunked body; returns the
    raw payload bytes."""
    out = bytearray()
    prev_sig = seed_signature
    while True:
        line = _read_line(stream)
        if not line:
            raise s3_error("MalformedXML")
        size_hex, _, token = line.partition(";")
        try:
            size = int(size_hex, 16)
        except ValueError:
            raise s3_error("MalformedXML") from None
        chunk_sig = ""
        if token.startswith("chunk-signature="):
            chunk_sig = token[len("chunk-signature="):]
        data = stream.read(size)
        if len(data) != size:
            raise s3_error("MalformedXML")
        crlf = stream.read(2)
        if crlf != b"\r\n":
            raise s3_error("MalformedXML")
        if signing_key is not None:
            expect = _chunk_signature(
                signing_key, amz_date, scope, prev_sig, bytes(data)
            )
            if not hmac.compare_digest(expect, chunk_sig):
                raise ChunkSignatureMismatch(
                    f"chunk signature mismatch at offset {len(out)}"
                )
            prev_sig = chunk_sig
        if size == 0:
            return bytes(out)
        out.extend(data)


def _read_line(stream) -> str:
    buf = bytearray()
    while len(buf) < MAX_LINE_LENGTH:
        c = stream.read(1)
        if not c:
            break
        if c == b"\n":
            if buf and buf[-1:] == b"\r":
                del buf[-1]
            return buf.decode("ascii", "replace")
        buf.extend(c)
    return buf.decode("ascii", "replace")


def _chunk_signature(
    key: bytes, amz_date: str, scope: str, prev_sig: str, data: bytes
) -> str:
    sts = "\n".join(
        [
            "AWS4-HMAC-SHA256-PAYLOAD",
            amz_date,
            scope,
            prev_sig,
            EMPTY_SHA256,
            hashlib.sha256(data).hexdigest(),
        ]
    )
    return hmac.new(key, sts.encode(), hashlib.sha256).hexdigest()


def encode_chunked_payload(
    data: bytes,
    chunk_size: int,
    signing_key: bytes | None = None,
    seed_signature: str = "",
    amz_date: str = "",
    scope: str = "",
) -> bytes:
    """Client-side encoder (test harness): frame `data` as aws-chunked."""
    out = bytearray()
    prev = seed_signature
    pieces = [data[i:i + chunk_size] for i in range(0, len(data), chunk_size)]
    pieces.append(b"")
    for piece in pieces:
        if signing_key is not None:
            sig = _chunk_signature(signing_key, amz_date, scope, prev, piece)
            prev = sig
            out.extend(f"{len(piece):x};chunk-signature={sig}\r\n".encode())
        else:
            out.extend(f"{len(piece):x}\r\n".encode())
        out.extend(piece)
        out.extend(b"\r\n")
    return bytes(out)
