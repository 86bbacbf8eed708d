"""Cloud replication sinks speaking the providers' REST protocols.

Behavioral match of the reference's SDK-backed sinks — each file entry
becomes one object (chunks fetched from the source cluster and
assembled through the visible-interval algebra), directories are
implicit in keys, recursive deletes sweep the replicated prefix:

  GcsSink    weed/replication/sink/gcssink/gcs_sink.go — the GCS JSON
             API (upload?uploadType=media, objects list/delete) with a
             Bearer token
  AzureSink  weed/replication/sink/azuresink/azure_sink.go — Azure Blob
             REST (Put/Delete Blob, List Blobs) with SharedKey request
             signing (the wire protocol the Azure SDK implements)
  B2Sink     weed/replication/sink/b2sink/b2_sink.go — Backblaze B2
             native API (authorize_account, get_upload_url, upload,
             list_file_names, delete_file_version)

The reference needs the providers' SDKs; these sinks speak the wire
protocols directly over urllib (https-capable), so the only gate is
credentials/endpoint config — and they are testable offline against
the in-repo protocol fakes (tests/cloud_fakes.py).

The port of seaweedfs_tpu/replication/cloud_sinks.py: each sink is the
port's AssemblingObjectSink (replication/sink.py) over its provider's
_put/_delete/_list."""

from __future__ import annotations

import base64
import hashlib
import hmac
import json
import time
import urllib.error
import urllib.parse
import urllib.request
from email.utils import formatdate

from seaweedfs_tpu_torch.replication.sink import AssemblingObjectSink


def _request(
    method: str,
    url: str,
    body: bytes | None = None,
    headers: dict | None = None,
    timeout: float = 30.0,
) -> tuple[int, dict, bytes]:
    req = urllib.request.Request(
        url, data=body, method=method, headers=headers or {}
    )
    try:
        with urllib.request.urlopen(req, timeout=timeout) as r:
            return r.status, dict(r.getheaders()), r.read()
    except urllib.error.HTTPError as e:
        return e.code, dict(e.headers), e.read()


class GcsSink(AssemblingObjectSink):
    """GCS over the JSON API (storage/v1). `token` is an OAuth bearer
    token (how the SDK authenticates after its token dance); the fake
    accepts any."""

    name = "gcs"

    def __init__(
        self,
        bucket: str,
        token: str = "",
        directory: str = "",
        endpoint: str = "https://storage.googleapis.com",
    ):
        super().__init__(directory)
        self.bucket = bucket
        self.endpoint = endpoint.rstrip("/")
        self._headers = {"Authorization": f"Bearer {token}"} if token else {}

    def _put(self, name: str, data: bytes) -> None:
        q = urllib.parse.urlencode({"uploadType": "media", "name": name})
        status, _, body = _request(
            "POST",
            f"{self.endpoint}/upload/storage/v1/b/{self.bucket}/o?{q}",
            body=data,
            headers={**self._headers, "Content-Type": "application/octet-stream"},
        )
        if status != 200:
            raise RuntimeError(f"gcs put {name}: http {status} {body[:200]!r}")

    def _delete(self, name: str) -> None:
        enc = urllib.parse.quote(name, safe="")
        status, _, body = _request(
            "DELETE",
            f"{self.endpoint}/storage/v1/b/{self.bucket}/o/{enc}",
            headers=self._headers,
        )
        if status not in (200, 204, 404):
            raise RuntimeError(f"gcs delete {name}: http {status}")

    def _list(self, prefix: str) -> list[str]:
        names: list[str] = []
        token = ""
        while True:
            params = {"prefix": prefix}
            if token:
                params["pageToken"] = token
            q = urllib.parse.urlencode(params)
            status, _, body = _request(
                "GET",
                f"{self.endpoint}/storage/v1/b/{self.bucket}/o?{q}",
                headers=self._headers,
            )
            if status != 200:
                raise RuntimeError(f"gcs list {prefix}: http {status}")
            resp = json.loads(body)
            names.extend(item["name"] for item in resp.get("items", []))
            token = resp.get("nextPageToken", "")
            if not token:
                return names


class AzureSink(AssemblingObjectSink):
    """Azure Blob storage over its REST API with SharedKey signing —
    the exact scheme the Azure SDK computes (Put Blob / Delete Blob /
    List Blobs, x-ms-version 2020-10-02)."""

    name = "azure"
    _VERSION = "2020-10-02"

    def __init__(
        self,
        account: str,
        account_key: str,
        container: str,
        directory: str = "",
        endpoint: str = "",  # default https://{account}.blob.core.windows.net
    ):
        super().__init__(directory)
        self.account = account
        self.key = base64.b64decode(account_key) if account_key else b""
        self.container = container
        self.endpoint = (
            endpoint.rstrip("/")
            or f"https://{account}.blob.core.windows.net"
        )

    def _signed_headers(
        self, method: str, path: str, query: dict, body: bytes | None,
        extra: dict,
    ) -> dict:
        headers = {
            "x-ms-date": formatdate(time.time(), usegmt=True),
            "x-ms-version": self._VERSION,
            **extra,
        }
        # canonicalized x-ms-* headers, sorted
        canon_headers = "".join(
            f"{k.lower()}:{v}\n"
            for k, v in sorted(headers.items())
            if k.lower().startswith("x-ms-")
        )
        canon_resource = f"/{self.account}{path}"
        for k in sorted(query):
            canon_resource += f"\n{k.lower()}:{query[k]}"
        length = str(len(body)) if body else ""
        string_to_sign = "\n".join(
            [
                method,
                "",  # Content-Encoding
                "",  # Content-Language
                length,  # Content-Length ("" when 0)
                "",  # Content-MD5
                extra.get("Content-Type", ""),
                "",  # Date (x-ms-date is used)
                "",  # If-Modified-Since
                "",  # If-Match
                "",  # If-None-Match
                "",  # If-Unmodified-Since
                "",  # Range
            ]
        ) + "\n" + canon_headers + canon_resource
        sig = base64.b64encode(
            hmac.new(self.key, string_to_sign.encode(), hashlib.sha256).digest()
        ).decode()
        headers["Authorization"] = f"SharedKey {self.account}:{sig}"
        return headers

    def _url(self, path: str, query: dict) -> str:
        q = urllib.parse.urlencode(query)
        return f"{self.endpoint}{path}" + (f"?{q}" if q else "")

    def _put(self, name: str, data: bytes) -> None:
        # sign the ENCODED path — Azure canonicalizes the URI path as
        # sent, so signing the decoded form 403s any name that
        # percent-encoding alters (spaces, '#', non-ASCII)
        path = f"/{self.container}/{urllib.parse.quote(name)}"
        headers = self._signed_headers(
            "PUT", path, {}, data,
            {
                "x-ms-blob-type": "BlockBlob",
                "Content-Type": "application/octet-stream",
            },
        )
        status, _, body = _request("PUT", self._url(path, {}), data, headers)
        if status not in (200, 201):
            raise RuntimeError(f"azure put {name}: http {status} {body[:200]!r}")

    def _delete(self, name: str) -> None:
        path = f"/{self.container}/{urllib.parse.quote(name)}"
        headers = self._signed_headers("DELETE", path, {}, None, {})
        status, _, _ = _request("DELETE", self._url(path, {}), None, headers)
        if status not in (200, 202, 404):
            raise RuntimeError(f"azure delete {name}: http {status}")

    def _list(self, prefix: str) -> list[str]:
        import re

        names: list[str] = []
        marker = ""
        while True:
            query = {"restype": "container", "comp": "list", "prefix": prefix}
            if marker:
                query["marker"] = marker
            headers = self._signed_headers(
                "GET", f"/{self.container}", query, None, {}
            )
            status, _, body = _request(
                "GET", self._url(f"/{self.container}", query), None, headers
            )
            if status != 200:
                raise RuntimeError(f"azure list {prefix}: http {status}")
            from xml.sax.saxutils import unescape

            text = body.decode()
            # XML-unescape: a blob named "a&b.bin" lists as a&amp;b.bin,
            # and sweeping the escaped name would 404 and strand the blob
            names.extend(
                unescape(n) for n in re.findall(r"<Name>([^<]+)</Name>", text)
            )
            m = re.search(r"<NextMarker>([^<]+)</NextMarker>", text)
            if not m:
                return names
            marker = unescape(m.group(1))


class B2Sink(AssemblingObjectSink):
    """Backblaze B2 over the native API: authorize_account once, then
    get_upload_url/upload_file per object (b2_sink.go's SDK flow)."""

    name = "backblaze"

    def __init__(
        self,
        key_id: str,
        application_key: str,
        bucket: str,
        directory: str = "",
        endpoint: str = "https://api.backblazeb2.com",
    ):
        super().__init__(directory)
        self.bucket_name = bucket
        basic = base64.b64encode(f"{key_id}:{application_key}".encode()).decode()
        status, _, body = _request(
            "GET",
            f"{endpoint.rstrip('/')}/b2api/v2/b2_authorize_account",
            headers={"Authorization": f"Basic {basic}"},
        )
        if status != 200:
            raise RuntimeError(f"b2 authorize: http {status} {body[:200]!r}")
        auth = json.loads(body)
        self.api_url = auth["apiUrl"].rstrip("/")
        self.token = auth["authorizationToken"]
        self.bucket_id = self._bucket_id()

    def _api(self, op: str, payload: dict) -> dict:
        status, _, body = _request(
            "POST",
            f"{self.api_url}/b2api/v2/{op}",
            body=json.dumps(payload).encode(),
            headers={"Authorization": self.token},
        )
        if status != 200:
            raise RuntimeError(f"b2 {op}: http {status} {body[:200]!r}")
        return json.loads(body)

    def _bucket_id(self) -> str:
        resp = self._api("b2_list_buckets", {"bucketName": self.bucket_name})
        for b in resp.get("buckets", []):
            if b["bucketName"] == self.bucket_name:
                return b["bucketId"]
        raise RuntimeError(f"b2: bucket {self.bucket_name!r} not found")

    _upload: tuple[str, str] | None = None  # cached (uploadUrl, token)

    def _put(self, name: str, data: bytes) -> None:
        # B2 lets an upload URL/token be reused until it errors; the
        # SDK flow caches it and re-fetches on failure — one extra API
        # round-trip per bulk sync instead of one per object
        for attempt in (0, 1):
            if self._upload is None:
                up = self._api("b2_get_upload_url", {"bucketId": self.bucket_id})
                self._upload = (up["uploadUrl"], up["authorizationToken"])
            url, token = self._upload
            status, _, body = _request(
                "POST",
                url,
                body=data,
                headers={
                    "Authorization": token,
                    "X-Bz-File-Name": urllib.parse.quote(name),
                    "Content-Type": "b2/x-auto",
                    "X-Bz-Content-Sha1": hashlib.sha1(data).hexdigest(),
                },
            )
            if status == 200:
                return
            self._upload = None  # expired/rotated: fetch a fresh one
            if attempt:
                raise RuntimeError(
                    f"b2 upload {name}: http {status} {body[:200]!r}"
                )

    def _delete(self, name: str) -> None:
        # B2 keeps every uploaded version of a name: deleting only the
        # newest would resurface the previous one. Walk
        # b2_list_file_versions and delete them ALL.
        start_name, start_id = name, None
        while True:
            payload = {
                "bucketId": self.bucket_id,
                "startFileName": start_name,
                "prefix": name,
                "maxFileCount": 100,
            }
            if start_id:
                payload["startFileId"] = start_id
            resp = self._api("b2_list_file_versions", payload)
            for f in resp.get("files", []):
                if f["fileName"] == name:
                    self._api(
                        "b2_delete_file_version",
                        {"fileName": name, "fileId": f["fileId"]},
                    )
            nxt = resp.get("nextFileName")
            if not nxt or nxt != name:
                return
            start_name, start_id = nxt, resp.get("nextFileId")

    def _list(self, prefix: str) -> list[str]:
        names: list[str] = []
        start = None
        while True:
            payload = {
                "bucketId": self.bucket_id,
                "prefix": prefix,
                "maxFileCount": 1000,
            }
            if start:
                payload["startFileName"] = start
            resp = self._api("b2_list_file_names", payload)
            names.extend(f["fileName"] for f in resp.get("files", []))
            start = resp.get("nextFileName")
            if not start:
                return names
