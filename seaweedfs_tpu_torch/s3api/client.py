"""Minimal SigV4 S3 client: PUT/GET(range)/DELETE objects.

Role match: the aws-sdk calls inside the reference's S3 tier backend
(weed/storage/backend/s3_backend/) and
replication S3 sink — a tiny header-auth V4 client over urllib,
path-style addressing, suitable for any S3-compatible endpoint
including this repo's own gateway (tests use exactly that).

The port of seaweedfs_tpu/s3api/client.py."""

from __future__ import annotations

import datetime
import hashlib
import urllib.error
import urllib.parse
import urllib.request



class _ProgressReader:
    """File-like wrapper reporting read progress to a callback."""

    def __init__(self, f, total: int, progress):
        self._f = f
        self._total = total
        self._done = 0
        self._progress = progress

    def read(self, n: int = -1) -> bytes:
        chunk = self._f.read(n)
        if chunk:
            self._done += len(chunk)
            pct = 100.0 * self._done / self._total if self._total else 0.0
            self._progress(self._done, pct)
        return chunk


class S3ClientError(IOError):
    def __init__(self, status: int, body: bytes = b""):
        super().__init__(f"s3 request failed: HTTP {status} {body[:200]!r}")
        self.status = status


class S3Client:
    def __init__(
        self,
        endpoint: str,  # "host:port"
        access_key: str,
        secret_key: str,
        region: str = "us-east-1",
        timeout: float = 60.0,
    ):
        self.endpoint = endpoint
        self.access_key = access_key
        self.secret_key = secret_key
        self.region = region
        self.timeout = timeout

    # ------------------------------------------------------------------
    def _request(
        self,
        method: str,
        bucket: str,
        key: str,
        data=None,  # bytes or file-like (file-like => unsigned payload)
        extra_headers: dict | None = None,
        payload_hash: str | None = None,
        query: dict | None = None,
    ):
        path = "/" + bucket + ("/" + key.lstrip("/") if key else "")
        query_string = "&".join(
            f"{urllib.parse.quote(k, safe='')}={urllib.parse.quote(v, safe='')}"
            for k, v in sorted((query or {}).items())
        )
        now = datetime.datetime.now(datetime.timezone.utc)
        amz_date = now.strftime("%Y%m%dT%H%M%SZ")
        date = now.strftime("%Y%m%d")
        if payload_hash is None:
            if data is None or isinstance(data, (bytes, bytearray)):
                payload_hash = hashlib.sha256(data or b"").hexdigest()
            else:
                # streaming body: don't buffer the payload to hash it
                payload_hash = "UNSIGNED-PAYLOAD"

        headers = {
            "host": self.endpoint,
            "x-amz-date": amz_date,
            "x-amz-content-sha256": payload_hash,
        }
        if extra_headers:
            headers.update({k.lower(): v for k, v in extra_headers.items()})

        from seaweedfs_tpu_torch.s3api.auth import sigv4_sign

        auth = sigv4_sign(
            method,
            urllib.parse.quote(path),
            query_string,
            headers,
            payload_hash,
            self.access_key,
            self.secret_key,
            self.region,
            "s3",
            amz_date,
        )

        url = f"http://{self.endpoint}{urllib.parse.quote(path)}"
        if query_string:
            url += "?" + query_string
        req = urllib.request.Request(url, data=data, method=method)
        for k, v in headers.items():
            if k != "host":
                req.add_header(k, v)
        req.add_header("Authorization", auth)
        try:
            return urllib.request.urlopen(req, timeout=self.timeout)
        except urllib.error.HTTPError as e:
            raise S3ClientError(e.code, e.read()) from e

    # ------------------------------------------------------------------
    def put_object(self, bucket: str, key: str, data: bytes) -> None:
        with self._request("PUT", bucket, key, data=data):
            pass

    def put_object_stream(
        self, bucket: str, key: str, file_obj, length: int, progress=None
    ) -> None:
        """Streamed PUT (unsigned payload): the body never lives in
        memory as one buffer. progress(done, pct) per read chunk."""
        src = file_obj
        if progress is not None:
            src = _ProgressReader(file_obj, length, progress)
        with self._request(
            "PUT",
            bucket,
            key,
            data=src,
            extra_headers={"content-length": str(length)},
        ):
            pass

    def get_object(
        self, bucket: str, key: str, offset: int = 0, length: int | None = None
    ) -> bytes:
        headers = {}
        if offset or length is not None:
            end = "" if length is None else str(offset + length - 1)
            headers["range"] = f"bytes={offset}-{end}"
        with self._request("GET", bucket, key, extra_headers=headers) as r:
            return r.read()

    def get_object_to_file(
        self, bucket: str, key: str, local_path: str, progress=None
    ) -> int:
        """Streamed GET: chunked reads straight to disk."""
        done = 0
        with self._request("GET", bucket, key) as r:
            total = int(r.headers.get("Content-Length", 0) or 0)
            with open(local_path, "wb") as out:
                while True:
                    chunk = r.read(8 * 1024 * 1024)
                    if not chunk:
                        break
                    out.write(chunk)
                    done += len(chunk)
                    if progress is not None:
                        pct = 100.0 * done / total if total else 0.0
                        progress(done, pct)
        return done

    def list_objects(self, bucket: str, prefix: str = "") -> list[str]:
        """Object keys under a prefix (ListObjects V1 XML)."""
        import xml.etree.ElementTree as ET

        query = {"prefix": prefix} if prefix else None
        with self._request("GET", bucket, "", query=query) as r:
            tree = ET.fromstring(r.read())
        ns = ""
        if tree.tag.startswith("{"):
            ns = tree.tag.split("}")[0] + "}"
        return [
            c.findtext(f"{ns}Key")
            for c in tree.findall(f"{ns}Contents")
            if c.findtext(f"{ns}Key")
        ]

    def head_object(self, bucket: str, key: str) -> dict:
        with self._request("HEAD", bucket, key) as r:
            return dict(r.headers)

    def delete_object(self, bucket: str, key: str) -> None:
        try:
            with self._request("DELETE", bucket, key):
                pass
        except S3ClientError as e:
            if e.status != 404:
                raise

    def create_bucket(self, bucket: str) -> None:
        try:
            with self._request("PUT", bucket, ""):
                pass
        except S3ClientError as e:
            if e.status != 409:  # already exists
                raise
