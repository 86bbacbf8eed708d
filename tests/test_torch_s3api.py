"""The port's S3 gateway (seaweedfs_tpu_torch/s3api/) against
seaweedfs_tpu's, on the CPU.

tests/test_s3api.py ported, each case on both packages with the same
inputs:

  * the units: SigV4 (round trip, wrong secret, unknown key, body hash,
    anonymous, open gateway, clock skew, presigned URLs) and AWS's
    published known-answer vector; `sigv4_sign`, `sign_request_v4`,
    `canonical_request` and `derive_signing_key` give identical results
    in both packages on numpy-drawn inputs; the aws-chunked reader,
    signed, unsigned, tampered and empty;
  * the live stack: a master, a volume server, an lsm filer and two
    gateways (open, and with one identity) of each package in this
    process, module-scoped (the port's volume server runs the kernels'
    plain versions, device="cpu"). Each case sends the same requests,
    bodies drawn with numpy, to both stacks: the statuses, error codes,
    bodies, ETags (the multipart ETag included) and XML are equal once
    upload ids, timestamps and the filer's address are masked;
  * the lifecycle: S3ApiServer.start() raises when the C serving loop
    cannot arm, and stop() leaves no thread of its own alive;
  * off the card: the gateway's modules import no torch.

The tolerance everywhere is exact equality.
"""

import datetime
import hashlib
import hmac
import importlib
import io
import os
import re
import subprocess
import sys
import threading
import time
import urllib.error
import urllib.parse
import urllib.request
import xml.etree.ElementTree as ET
from http.client import RemoteDisconnected

import numpy as np
import pytest

from seaweedfs_tpu_torch.util.availability import free_port

SIDES = ("ref", "port")
PKG = {"ref": "seaweedfs_tpu", "port": "seaweedfs_tpu_torch"}
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ACCESS, SECRET = "AKID1", "topsecret"


def mod(side, name):
    return importlib.import_module(f"{PKG[side]}.{name}")


def auth(side):
    return mod(side, "s3api.auth")


def chunked(side):
    return mod(side, "s3api.chunked_reader")


def _both(fn):
    got = {side: fn(side) for side in SIDES}
    assert got["port"] == got["ref"]
    return got["port"]


def _now():
    return datetime.datetime.now(datetime.timezone.utc).replace(microsecond=0)


# --- the units ----------------------------------------------------------------------


def _sign(side, method="GET", path="/bucket/key", body=b"", key="AKIDEXAMPLE",
          secret="secret123", now=None, host="s3.local:8333"):
    headers = {"Host": host}
    headers.update(auth(side).sign_request_v4(method, path, {}, headers, body, key, secret,
                                              now=now or _now()))
    return headers


def _authenticate(side, method, path, query, headers, body, identities=True):
    a = auth(side)
    iam = a.IdentityAccessManagement(
        [a.Identity("admin", "AKIDEXAMPLE", "secret123")] if identities else None)
    try:
        ident = iam.authenticate(method, path, query, headers, body)
        return "ok", ident and ident.name
    except mod(side, "s3api.errors").S3Error as e:
        return "error", e.code, e.status, e.message


class TestSigV4:
    def test_round_trip(self):
        now = _now()
        _both(lambda s: _sign(s, now=now))  # the same signed headers in both packages
        assert _both(lambda s: _authenticate(s, "GET", "/bucket/key", {}, _sign(s, now=now),
                                             b"")) == ("ok", "admin")

    def test_wrong_secret_rejected(self):
        got = _both(lambda s: _authenticate(s, "GET", "/bucket/key", {},
                                            _sign(s, secret="wrong"), b""))
        assert got[:3] == ("error", "SignatureDoesNotMatch", 403)

    def test_unknown_access_key(self):
        got = _both(lambda s: _authenticate(s, "GET", "/k", {}, _sign(s, "GET", "/k", key="NOPE"),
                                            b""))
        assert got[:3] == ("error", "InvalidAccessKeyId", 403)

    def test_body_hash_checked(self):
        body = np.random.default_rng(1).bytes(513)
        got = _both(lambda s: _authenticate(s, "PUT", "/bucket/key", {},
                                            _sign(s, "PUT", body=body), body[:-1] + b"!"))
        assert got[:3] == ("error", "SignatureDoesNotMatch", 403)
        assert _both(lambda s: _authenticate(s, "PUT", "/bucket/key", {},
                                             _sign(s, "PUT", body=body), body)) == ("ok", "admin")

    def test_anonymous_rejected_when_enabled(self):
        got = _both(lambda s: _authenticate(s, "GET", "/bucket/key", {}, {}, b""))
        assert got[:3] == ("error", "AccessDenied", 403)

    def test_open_gateway_allows_all(self):
        assert _both(lambda s: _authenticate(s, "GET", "/x", {}, {}, b"",
                                             identities=False)) == ("ok", None)

    def test_skewed_date_rejected(self):
        old = _now() - datetime.timedelta(hours=2)
        got = _both(lambda s: _authenticate(s, "GET", "/k", {},
                                            _sign(s, "GET", "/k", now=old), b""))
        assert got[:3] == ("error", "RequestTimeTooSkewed", 403)

    @pytest.mark.parametrize("case", ["valid", "expired", "expires-zero", "expires-nan",
                                      "missing-signature", "tampered", "other-path"])
    def test_presigned_url(self, case):
        """A query-string (presigned) V4 URL: accepted within X-Amz-Expires,
        each fault answered with the reference's error."""
        now = _now() - datetime.timedelta(hours=2) if case == "expired" else _now()
        expires = {"expires-zero": "0", "expires-nan": "soon"}.get(case, "3600")

        def run(side):
            query = _presign(side, "GET", "/bucket/key", "s3.local:8333", "AKIDEXAMPLE",
                             "secret123", now, expires)
            path = "/bucket/other" if case == "other-path" else "/bucket/key"
            if case == "missing-signature":
                del query["X-Amz-Signature"]
            elif case == "tampered":
                query["X-Amz-Signature"] = [query["X-Amz-Signature"][0][::-1]]
            return query, _authenticate(side, "GET", path, query,
                                        {"Host": "s3.local:8333"}, None)

        query, got = _both(run)
        want = {"valid": ("ok", "admin"), "expired": "AccessDenied",
                "expires-zero": "AuthorizationQueryParametersError",
                "expires-nan": "AuthorizationQueryParametersError",
                "missing-signature": "MissingFields", "tampered": "SignatureDoesNotMatch",
                "other-path": "SignatureDoesNotMatch"}[case]
        assert got == want if case == "valid" else got[1] == want


def _presign(side, method, path, host, key, secret, now, expires="3600"):
    """The query of a presigned V4 URL for `path`, signing the host header."""
    a = auth(side)
    amz_date, date = now.strftime("%Y%m%dT%H%M%SZ"), now.strftime("%Y%m%d")
    scope = f"{date}/us-east-1/s3/aws4_request"
    query = {"X-Amz-Algorithm": [a.SIGN_V4_ALGORITHM], "X-Amz-Credential": [f"{key}/{scope}"],
             "X-Amz-Date": [amz_date], "X-Amz-Expires": [expires],
             "X-Amz-SignedHeaders": ["host"]}
    canon = a.canonical_request(method, path, query, a._LowerHeaders({"host": host}), ["host"],
                                a.UNSIGNED_PAYLOAD)
    sts = a.string_to_sign(amz_date, scope, canon)
    query["X-Amz-Signature"] = [hmac.new(a.derive_signing_key(secret, date, "us-east-1", "s3"),
                                         sts.encode(), hashlib.sha256).hexdigest()]
    return query


@pytest.mark.parametrize("seed", range(4))
def test_sigv4_sign_identical_in_both_packages(seed):
    """sigv4_sign (the client-side signer every AWS-protocol client uses),
    sign_request_v4, canonical_request and derive_signing_key give the
    same strings in both packages on the same numpy-drawn inputs."""
    rng = np.random.default_rng(seed)
    alphabet = np.array(list("abcXYZ019-_.~/ %+=&"))
    for _ in range(25):
        word = lambda n: "".join(rng.choice(alphabet, int(n)))  # noqa: E731
        method = ["GET", "PUT", "POST", "DELETE", "HEAD"][int(rng.integers(0, 5))]
        path = "/" + "/".join(word(rng.integers(1, 9)) for _ in range(int(rng.integers(1, 4))))
        query = {word(rng.integers(1, 6)): [word(rng.integers(0, 6))]
                 for _ in range(int(rng.integers(0, 4)))}
        headers = {"Host": f"h{int(rng.integers(0, 99))}:8333",
                   "x-amz-meta-a": "  " + word(rng.integers(0, 12)) + " ",
                   "Content-Type": word(rng.integers(1, 10))}
        body = rng.bytes(int(rng.integers(0, 300)))
        secret, key = word(rng.integers(8, 20)), word(rng.integers(4, 12))
        now = datetime.datetime(2026, 1, 1, tzinfo=datetime.timezone.utc) + datetime.timedelta(
            seconds=int(rng.integers(0, 10 ** 8)))
        amz_date = now.strftime("%Y%m%dT%H%M%SZ")
        qs = "&".join(f"{k}={v[0]}" for k, v in sorted(query.items()))

        def run(side):
            a = auth(side)
            return (
                a.sigv4_sign(method, path, qs, dict(headers, **{"x-amz-date": amz_date}),
                             hashlib.sha256(body).hexdigest(), key, secret, "us-east-1", "s3",
                             amz_date),
                a.sign_request_v4(method, path, query, headers, body, key, secret, now=now),
                a.canonical_request(method, path, query, a._LowerHeaders(headers),
                                    sorted(k.lower() for k in headers), "UNSIGNED-PAYLOAD"),
                a.derive_signing_key(secret, amz_date[:8], "eu-west-1", "sqs"),
            )
        _both(run)


class TestSigV4KnownAnswer:
    """AWS's published SigV4 example (AWS General Reference, 'Signature
    Version 4 signing process') through both packages."""

    def test_aws_documented_vector(self):
        class H(dict):
            def get(self, k, d=None):
                return super().get(k.lower(), d)

        def run(side):
            a = auth(side)
            headers = H({"content-type": "application/x-www-form-urlencoded; charset=utf-8",
                         "host": "iam.amazonaws.com", "x-amz-date": "20150830T123600Z"})
            canon = a.canonical_request("GET", "/", {"Action": ["ListUsers"],
                                                     "Version": ["2010-05-08"]},
                                        headers, ["content-type", "host", "x-amz-date"],
                                        hashlib.sha256(b"").hexdigest())
            sts = a.string_to_sign("20150830T123600Z", "20150830/us-east-1/iam/aws4_request",
                                   canon)
            key = a.derive_signing_key("wJalrXUtnFEMI/K7MDENG+bPxRfiCYEXAMPLEKEY", "20150830",
                                       "us-east-1", "iam")
            return (hashlib.sha256(canon.encode()).hexdigest(),
                    hmac.new(key, sts.encode(), hashlib.sha256).hexdigest())

        assert _both(run) == (
            "f536975d06c0309214f805bb90ccff089219ecd68b2577efef23edd43b7e1a59",
            "5d672d79c15b13162d9279b0855cfba6789a8edb4c82c400e06b5924a6f2b5d7")


class TestChunkedReader:
    def _round_trip(self, data, chunk, **sig):
        def run(side):
            c = chunked(side)
            framed = c.encode_chunked_payload(data, chunk, **sig)
            return framed, c.decode_chunked_payload(io.BytesIO(framed), **sig)
        framed, got = _both(run)
        assert got == data
        return framed

    def test_unsigned_round_trip(self):
        self._round_trip(np.random.default_rng(2).bytes(100000), 8192)

    def test_signed_round_trip(self):
        self._round_trip(np.random.default_rng(3).bytes(150000), 16384,
                         signing_key=b"signing-key-material", seed_signature="seed",
                         amz_date="20260729T000000Z",
                         scope="20260729/us-east-1/s3/aws4_request")

    def test_tampered_chunk_rejected(self):
        sig = dict(signing_key=b"signing-key-material", seed_signature="seed", amz_date="d",
                   scope="s")
        data = np.random.default_rng(4).bytes(13000)

        def run(side):
            c = chunked(side)
            framed = bytearray(c.encode_chunked_payload(data, 4096, **sig))
            framed[framed.index(b"\r\n") + 2 + 100] ^= 0xFF
            with pytest.raises(c.ChunkSignatureMismatch) as e:
                c.decode_chunked_payload(io.BytesIO(bytes(framed)), **sig)
            return str(e.value)
        assert _both(run) == "chunk signature mismatch at offset 0"

    def test_empty_payload(self):
        assert self._round_trip(b"", 8192) == b"0\r\n\r\n"


# --- the live stack -----------------------------------------------------------------


def wait_for(cond, timeout=30.0):
    deadline = time.time() + timeout
    while time.time() < deadline:
        if cond():
            return True
        time.sleep(0.05)
    return False


class Resp:
    """One reply: status, headers, raw body, and the view both packages
    must agree on (upload ids, timestamps and the filer's address masked)."""

    KEEP = ("ETag", "Content-Type", "Content-Range", "Location", "Accept-Ranges",
            "Content-Length-Hint")
    MASKS = ((rb"<(LastModified|CreationDate)>[^<]*</", rb"<\1>T</"),
             (rb"[0-9a-f]{8}-[0-9a-f]{4}-[0-9a-f]{4}-[0-9a-f]{4}-[0-9a-f]{12}", b"UPLOAD-ID"),
             (rb"<Location>http://127\.0\.0\.1:\d+/", b"<Location>http://FILER/"))

    def __init__(self, status, headers, body):
        self.status, self.headers, self.body = status, headers, body

    def xml(self):
        root = ET.fromstring(self.body)
        for el in root.iter():
            if "}" in el.tag:
                el.tag = el.tag.split("}", 1)[1]
        return root

    def code(self):
        return self.xml().findtext("Code")

    def view(self):
        body = self.body
        for pat, rep in self.MASKS:
            body = re.sub(pat, rep, body)
        return (self.status, {k: self.headers[k] for k in self.KEEP if self.headers.get(k)},
                body)


class Stack:
    """A master, one volume server, an lsm filer, an open gateway and a
    gateway with one identity, all of one package."""

    def __init__(self, side, root):
        self.side, self.started = side, []
        try:
            master = mod(side, "server.master_server").MasterServer(
                port=free_port(), volume_size_limit_mb=64)
            self._start(master)
            kw = dict(ec_codec="cpu") if side == "ref" else dict(ec_codec="cuda", device="cpu")
            vol_dir = os.path.join(root, f"{side}-vol")
            os.makedirs(vol_dir)
            self.volume = mod(side, "server.volume_server").VolumeServer(
                [vol_dir], port=free_port(), master=f"127.0.0.1:{master.port}",
                heartbeat_interval=0.2, max_volume_counts=[50], scrub_interval=0, **kw)
            self._start(self.volume)
            assert wait_for(lambda: master.topology.data_nodes())
            self.filer = mod(side, "server.filer_server").FilerServer(
                [f"127.0.0.1:{master.port}"], port=free_port(), store="lsm",
                store_path=os.path.join(root, f"{side}-lsm"), max_mb=1)
            self._start(self.filer)
            s3 = mod(side, "s3api.s3api_server").S3ApiServer
            a = auth(side)
            self.open = s3(filer=f"127.0.0.1:{self.filer.port}", port=free_port())
            self._start(self.open)
            self.secured = s3(filer=f"127.0.0.1:{self.filer.port}", port=free_port(),
                              iam=a.IdentityAccessManagement([a.Identity("admin", ACCESS,
                                                                         SECRET)]))
            self._start(self.secured)
            self.master = master
        except BaseException:
            self.stop()
            raise

    def _start(self, daemon):
        daemon.start()
        self.started.append(daemon)

    def stop(self):
        for d in reversed(self.started):
            d.stop()
        self.started = []

    def req(self, path, method="GET", data=None, headers=None, secured=False):
        port = (self.secured if secured else self.open).port
        return http(f"http://127.0.0.1:{port}{path}", method, data, headers)

    def signed(self, path, method="GET", body=b"", secret=SECRET, access=ACCESS):
        """A request to the secured gateway, signed just before it is sent."""
        url = urllib.parse.urlparse(path)
        headers = {"Host": f"127.0.0.1:{self.secured.port}"}
        headers.update(auth(self.side).sign_request_v4(
            method, url.path, urllib.parse.parse_qs(url.query, keep_blank_values=True),
            headers, body, access, secret))
        return self.req(path, method, body or None, headers, secured=True)


def http(url, method="GET", data=None, headers=None) -> Resp:
    """One request, never raising on an error status; one retry on a
    transport-level drop, as S3 clients retry these."""
    req = urllib.request.Request(url, data=data, method=method)
    for k, v in (headers or {}).items():
        req.add_header(k, v)
    for attempt in (0, 1):
        try:
            with urllib.request.urlopen(req, timeout=30) as r:
                return Resp(r.status, r.headers, r.read())
        except urllib.error.HTTPError as e:
            return Resp(e.code, e.headers, e.read())
        except (RemoteDisconnected, ConnectionResetError, urllib.error.URLError):
            if attempt:
                raise


@pytest.fixture(scope="module")
def stacks(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("s3-stacks"))
    out = {}
    try:
        for side in SIDES:
            out[side] = Stack(side, root)
        yield out
    finally:
        for st in out.values():
            st.stop()


def _each(stacks, fn):
    got = {side: fn(stacks[side]) for side in SIDES}
    assert got["port"] == got["ref"]
    return got["port"]


def _bytes(seed, n):
    return np.random.default_rng(seed).bytes(n)


def _tags(root, tag, child):
    return [el.findtext(child) for el in root.iter(tag)]


class TestS3EndToEnd:
    def test_bucket_lifecycle(self, stacks):
        def run(st):
            out = [st.req("/bucket1", "PUT").view(), st.req("/bucket1", "HEAD").view(),
                   st.req("/bucket1", "PUT").view()]
            listing = st.req("/")
            out += [listing.view(), _tags(listing.xml(), "Bucket", "Name"),
                    st.req("/nosuch", "HEAD").view(), st.req("/Bad_Name", "PUT").view()]
            return out
        got = _each(stacks, run)
        assert [g[0] for g in got[:3]] == [200, 200, 409]
        assert "bucket1" in got[4] and got[5][0] == 404 and got[6][0] == 400

    def test_object_put_get_head_delete(self, stacks):
        body = _bytes(10, 14000)

        def run(st):
            st.req("/objb", "PUT")
            put = st.req("/objb/dir/hello.txt", "PUT", body, {"Content-Type": "text/plain"})
            get = st.req("/objb/dir/hello.txt")
            rng = st.req("/objb/dir/hello.txt", headers={"Range": "bytes=100-2099"})
            bad = st.req("/objb/dir/hello.txt", headers={"Range": "bytes=99999-"})
            head = st.req("/objb/dir/hello.txt", "HEAD")
            return [put.view(), get.view(), rng.view(), bad.view(),
                    (head.view()[:2], head.headers["Last-Modified"][-3:]),
                    st.req("/objb/dir/hello.txt", "DELETE").view(),
                    st.req("/objb/dir/hello.txt").view(),
                    st.req("/objb/dir/hello.txt", "HEAD").view()]
        got = _each(stacks, run)
        etag = f'"{hashlib.md5(body).hexdigest()}"'
        assert got[0][0] == 200 and got[0][1]["ETag"] == etag
        assert got[1][2] == body and got[1][1]["Content-Type"] == "text/plain"
        assert got[1][1]["ETag"] == etag
        assert got[2][0] == 206 and got[2][2] == body[100:2100]
        assert got[3][0] == 416 and got[4][0][0] == 200
        assert got[5][0] == 204 and got[6][0] == 404 and b"NoSuchKey" in got[6][2]

    def test_copy_object(self, stacks):
        data = _bytes(11, 777)

        def run(st):
            st.req("/copyb", "PUT")
            st.req("/copyb/src.bin", "PUT", data)
            copy = st.req("/copyb/dst.bin", "PUT", b"", {"X-Amz-Copy-Source": "/copyb/src.bin"})
            missing = st.req("/copyb/dst2.bin", "PUT", b"",
                             {"X-Amz-Copy-Source": "/copyb/nope.bin"})
            return [copy.view(), copy.xml().tag, st.req("/copyb/dst.bin").view(),
                    missing.view()]
        got = _each(stacks, run)
        assert got[1] == "CopyObjectResult" and got[2][2] == data
        assert f'"{hashlib.md5(data).hexdigest()}"'.encode() in got[0][2]
        assert got[3][0] == 404

    def test_list_objects_v1_v2(self, stacks):
        def run(st):
            st.req("/listb", "PUT")
            for i, name in enumerate(("a.txt", "b.txt", "c.txt", "sub/nested.txt")):
                st.req(f"/listb/{name}", "PUT", _bytes(20 + i, 1 + 37 * i))
            out = []
            for q in ("", "?delimiter=/", "?list-type=2&prefix=sub/", "?max-keys=2",
                      "?max-keys=2&marker=b.txt", "?list-type=2&max-keys=1&delimiter=/",
                      "?list-type=2&continuation-token=a.txt&delimiter=/", "?prefix=s",
                      "?max-keys=-1", "?max-keys=x", "?delimiter=%2C"):
                r = st.req(f"/listb{q}")
                out.append(r.view())
                if r.status == 200:
                    root = r.xml()
                    out.append((_tags(root, "Contents", "Key"), _tags(root, "Contents", "Size"),
                                _tags(root, "CommonPrefixes", "Prefix"),
                                root.findtext("IsTruncated"), root.findtext("KeyCount")))
            out.append(st.req("/nobucket").view())
            return out
        got = _each(stacks, run)
        assert got[1][0] == ["a.txt", "b.txt", "c.txt", "sub/nested.txt"] and got[1][2] == []
        assert got[3][0] == ["a.txt", "b.txt", "c.txt"] and got[3][2] == ["sub/"]
        assert got[5][0] == ["sub/nested.txt"] and got[5][4] == "1"
        assert got[7][3] == "true" and len(got[7][0]) == 2
        assert "c.txt" in got[9][0]
        assert got[-1][0] == 404

    def test_delete_multiple(self, stacks):
        def run(st):
            st.req("/delb", "PUT")
            for name in ("x1", "x2", "x3"):
                st.req(f"/delb/{name}", "PUT", _bytes(30, 40))
            body = (b'<Delete xmlns="http://s3.amazonaws.com/doc/2006-03-01/">'
                    b'<Object><Key>x1</Key></Object><Object><Key>x2</Key></Object>'
                    b'<Object><Key></Key></Object></Delete>')
            deleted = st.req("/delb?delete=", "POST", body)
            left = st.req("/delb")
            return [deleted.view(), sorted(_tags(deleted.xml(), "Deleted", "Key")), left.view(),
                    _tags(left.xml(), "Contents", "Key"),
                    st.req("/delb?delete=", "POST", b"<notxml").view(),
                    st.req("/delb", "POST", b"").view()]
        got = _each(stacks, run)
        assert got[1] == ["x1", "x2"] and got[3] == ["x3"]
        assert got[4][0] == 400 and b"MalformedXML" in got[4][2]
        assert got[5][0] == 501

    def test_multipart_upload(self, stacks):
        part1, part2 = _bytes(40, 2 * 1024 * 1024), _bytes(41, 1024 * 1024)

        def run(st):
            st.req("/mpb", "PUT")
            init = st.req("/mpb/big.bin?uploads=", "POST", b"")
            uid = init.xml().findtext("UploadId")
            out = [init.view()]
            for n, part in ((1, part1), (2, part2)):
                out.append(st.req(f"/mpb/big.bin?partNumber={n}&uploadId={uid}", "PUT",
                                  part).view())
            out.append(st.req("/mpb?uploads=").view())
            parts = st.req(f"/mpb/big.bin?uploadId={uid}")
            out += [parts.view(), _tags(parts.xml(), "Part", "PartNumber")]
            done = st.req(f"/mpb/big.bin?uploadId={uid}", "POST", b"<x/>")
            out += [done.view(), done.xml().tag, done.xml().findtext("ETag")]
            got = st.req("/mpb/big.bin")
            out += [got.status, got.body == part1 + part2, got.headers["ETag"]]
            uploads = st.req("/mpb?uploads=")
            out += [uploads.view(), list(uploads.xml().iter("Upload"))]
            for q in ("partNumber=0", "partNumber=x", "partNumber=10001"):
                out.append(st.req(f"/mpb/big.bin?{q}&uploadId={uid}", "PUT", b"p").view())
            return out
        got = _each(stacks, run)
        assert got[5] == ["1", "2"] and got[7] == "CompleteMultipartUploadResult"
        assert re.fullmatch(r'"[0-9a-f]{32}-\d+"', got[8]), got[8]  # <hex>-<chunks>
        assert got[9:11] == [200, True]
        assert got[11] == f'"{hashlib.md5(part1 + part2).hexdigest()}"'
        assert got[13] == [] and {g[0] for g in got[14:]} == {400}

    def test_multipart_abort(self, stacks):
        def run(st):
            st.req("/abortb", "PUT")
            uid = st.req("/abortb/f?uploads=", "POST", b"").xml().findtext("UploadId")
            st.req(f"/abortb/f?partNumber=1&uploadId={uid}", "PUT", b"z")
            return [st.req(f"/abortb/f?uploadId={uid}", "DELETE").view(),
                    st.req(f"/abortb/f?uploadId={uid}").view(),
                    st.req(f"/abortb/f?partNumber=2&uploadId={uid}", "PUT", b"y").view()]
        got = _each(stacks, run)
        assert [g[0] for g in got] == [204, 404, 404]
        assert b"NoSuchUpload" in got[1][2] and b"NoSuchUpload" in got[2][2]

    def test_streaming_chunked_put(self, stacks):
        data = _bytes(50, 70000)

        def run(st):
            st.req("/chunkb", "PUT")
            framed = chunked(st.side).encode_chunked_payload(data, 65536)
            put = st.req("/chunkb/streamed.bin", "PUT", framed,
                         {"x-amz-content-sha256": auth(st.side).STREAMING_PAYLOAD})
            bad = st.req("/chunkb/bad.bin", "PUT", framed[:-7],
                         {"x-amz-content-sha256": auth(st.side).STREAMING_PAYLOAD})
            return [put.view(), st.req("/chunkb/streamed.bin").view(), bad.view()]
        got = _each(stacks, run)
        assert got[0][0] == 200 and got[1][2] == data
        assert got[0][1]["ETag"] == f'"{hashlib.md5(data).hexdigest()}"'
        assert got[2][0] == 400

    def test_delete_bucket(self, stacks):
        def run(st):
            st.req("/gone", "PUT")
            st.req("/gone/f.txt", "PUT", _bytes(60, 10))
            return [st.req("/gone", "DELETE").view(), st.req("/gone", "HEAD").view(),
                    st.req("/gone", "DELETE").view()]
        got = _each(stacks, run)
        assert [g[0] for g in got] == [204, 404, 404]


class TestMultipartHardening:
    """Typed multipart errors (filer_multipart.go semantics): abort is
    NoSuchUpload for unknown ids and reclaims staged chunks; complete
    validates the client manifest — ascending order, staged parts,
    matching ETags — instead of silently splicing whatever exists."""

    @staticmethod
    def _initiate(st, bucket, key):
        st.req(f"/{bucket}", "PUT")
        return st.req(f"/{bucket}/{key}?uploads=", "POST", b"").xml().findtext("UploadId")

    @staticmethod
    def _put_part(st, bucket, key, uid, num, data):
        return st.req(f"/{bucket}/{key}?partNumber={num}&uploadId={uid}", "PUT",
                      data).headers["ETag"]

    @staticmethod
    def _manifest(parts) -> bytes:
        root = ET.Element("CompleteMultipartUpload")
        for num, etag in parts:
            p = ET.SubElement(root, "Part")
            ET.SubElement(p, "PartNumber").text = str(num)
            ET.SubElement(p, "ETag").text = etag
        return ET.tostring(root)

    def test_abort_unknown_upload_is_nosuchupload(self, stacks):
        def run(st):
            st.req("/mph0", "PUT")
            r = st.req("/mph0/f?uploadId=deadbeef", "DELETE")
            return r.view(), r.code()
        got = _each(stacks, run)
        assert got[0][0] == 404 and got[1] == "NoSuchUpload"

    def test_abort_cleans_staged_parts(self, stacks):
        def run(st):
            uid = self._initiate(st, "mph1", "f.bin")
            self._put_part(st, "mph1", "f.bin", uid, 1, _bytes(70, 6000))
            out = [st.req(f"/mph1/f.bin?uploadId={uid}", "DELETE").view()]
            uploads = st.req("/mph1?uploads=")
            out += [uploads.view(), list(uploads.xml().iter("Upload"))]
            for method in ("GET", "DELETE"):
                r = st.req(f"/mph1/f.bin?uploadId={uid}", method)
                out.append((r.view(), r.code()))
            return out
        got = _each(stacks, run)
        assert got[0][0] == 204 and got[2] == []
        assert [g[1] for g in got[3:]] == ["NoSuchUpload", "NoSuchUpload"]

    def test_complete_manifest_happy_path(self, stacks):
        p1, p2 = _bytes(71, 2048), _bytes(72, 1024)

        def run(st):
            uid = self._initiate(st, "mph2", "ok.bin")
            e1 = self._put_part(st, "mph2", "ok.bin", uid, 1, p1)
            e2 = self._put_part(st, "mph2", "ok.bin", uid, 2, p2)
            done = st.req(f"/mph2/ok.bin?uploadId={uid}", "POST",
                          self._manifest([(1, e1), (2, e2)]))
            return e1, done.view(), done.xml().tag, st.req("/mph2/ok.bin").view()
        e1, _, tag, got = _each(stacks, run)
        assert e1 == f'"{hashlib.md5(p1).hexdigest()}"'
        assert tag == "CompleteMultipartUploadResult" and got[2] == p1 + p2

    def _rejected(self, stacks, bucket, key, parts, manifest):
        def run(st):
            uid = self._initiate(st, bucket, key)
            etags = [self._put_part(st, bucket, key, uid, n, _bytes(73 + n, 100))
                     for n in range(1, parts + 1)]
            r = st.req(f"/{bucket}/{key}?uploadId={uid}", "POST", manifest(etags))
            return r.view(), r.code()
        return _each(stacks, run)

    def test_complete_out_of_order_manifest_rejected(self, stacks):
        got = self._rejected(stacks, "mph3", "ooo.bin", 2,
                             lambda e: self._manifest([(2, e[1]), (1, e[0])]))
        assert got[0][0] == 400 and got[1] == "InvalidPartOrder"

    def test_complete_missing_part_rejected(self, stacks):
        got = self._rejected(stacks, "mph4", "gap.bin", 1,
                             lambda e: self._manifest([(1, e[0]), (7, '"feedface"')]))
        assert got[1] == "InvalidPart"

    def test_complete_wrong_etag_rejected(self, stacks):
        wrong = f'"{hashlib.md5(b"other bytes").hexdigest()}"'
        got = self._rejected(stacks, "mph5", "etag.bin", 1,
                             lambda e: self._manifest([(1, wrong)]))
        assert got[1] == "InvalidPart"

    def test_complete_malformed_xml_rejected(self, stacks):
        def run(st):
            uid = self._initiate(st, "mph6", "bad.bin")
            self._put_part(st, "mph6", "bad.bin", uid, 1, _bytes(80, 100))
            out = []
            for body in (b"<CompleteMultipartUpload><Part>", b"\x00\x01notxml",
                         b"<CompleteMultipartUpload><Part><PartNumber>one</PartNumber>"
                         b"</Part></CompleteMultipartUpload>"):
                r = st.req(f"/mph6/bad.bin?uploadId={uid}", "POST", body)
                out.append((r.view(), r.code()))
            return out
        got = _each(stacks, run)
        assert [(g[0][0], g[1]) for g in got] == [(400, "MalformedXML")] * 3


class TestS3Auth:
    def test_unsigned_rejected(self, stacks):
        def run(st):
            r = st.req("/private", "PUT", secured=True)
            return r.view(), r.code()
        got = _each(stacks, run)
        assert got[0][0] == 403 and got[1] == "AccessDenied"

    def test_signed_accepted(self, stacks):
        body = _bytes(90, 3000)

        def run(st):
            return [st.signed("/private", "PUT").view(),
                    st.signed("/private/obj", "PUT", body).view(),
                    st.signed("/private/obj").view(),
                    st.signed("/private?list-type=2&prefix=o").view()]
        got = _each(stacks, run)
        assert [g[0] for g in got] == [200, 200, 200, 200] and got[2][2] == body

    @pytest.mark.parametrize("fault", ["wrong-secret", "unknown-key", "body-hash"])
    def test_bad_signature_rejected_on_the_wire(self, stacks, fault):
        def run(st):
            st.signed("/private2", "PUT")
            if fault == "body-hash":
                url, headers = "/private2/obj", {"Host": f"127.0.0.1:{st.secured.port}"}
                headers.update(auth(st.side).sign_request_v4("PUT", url, {}, headers, b"one",
                                                             ACCESS, SECRET))
                r = st.req(url, "PUT", b"two", headers, secured=True)
            else:
                r = st.signed("/private2/obj", "PUT", b"x",
                              **({"secret": "wrong"} if fault == "wrong-secret"
                                 else {"access": "NOPE"}))
            return r.view(), r.code()
        got = _each(stacks, run)
        assert got[0][0] == 403 and got[1] == {"unknown-key": "InvalidAccessKeyId"}.get(
            fault, "SignatureDoesNotMatch")

    def test_signed_streaming_put_and_copy(self, stacks):
        """A signed aws-chunked PUT (the header signature over the
        STREAMING sentinel seeds the chunk chain), the same body with one
        byte flipped, and a CopyObject whose source header is signed."""
        data = _bytes(92, 200000)

        def streaming(st, key, flip):
            a, c = auth(st.side), chunked(st.side)
            now = _now()
            amz_date, date = now.strftime("%Y%m%dT%H%M%SZ"), now.strftime("%Y%m%d")
            headers = {"host": f"127.0.0.1:{st.secured.port}", "x-amz-date": amz_date,
                       "x-amz-content-sha256": a.STREAMING_PAYLOAD,
                       "x-amz-decoded-content-length": str(len(data))}
            headers["authorization"] = a.sigv4_sign("PUT", key, "", headers,
                                                    a.STREAMING_PAYLOAD, ACCESS, SECRET,
                                                    "us-east-1", "s3", amz_date)
            framed = bytearray(c.encode_chunked_payload(
                data, 65536, a.derive_signing_key(SECRET, date, "us-east-1", "s3"),
                headers["authorization"].rsplit("Signature=", 1)[1], amz_date,
                f"{date}/us-east-1/s3/aws4_request"))
            if flip:
                framed[-100] ^= 1
            return st.req(key, "PUT", bytes(framed), headers, secured=True)

        def run(st):
            st.signed("/streamb", "PUT")
            ok, bad = streaming(st, "/streamb/s.bin", False), streaming(st, "/streamb/t.bin", True)
            url, headers = "/streamb/copy.bin", {"Host": f"127.0.0.1:{st.secured.port}",
                                                 "x-amz-copy-source": "/streamb/s.bin"}
            headers.update(auth(st.side).sign_request_v4("PUT", url, {}, headers, b"", ACCESS,
                                                         SECRET))
            copy = st.req(url, "PUT", b"", headers, secured=True)
            return [ok.view(), (bad.view(), bad.code()), copy.view(),
                    st.signed("/streamb/s.bin").view(), st.signed("/streamb/copy.bin").view(),
                    st.signed("/streamb/t.bin").status]
        got = _each(stacks, run)
        assert got[0][0] == 200 and got[0][1]["ETag"] == f'"{hashlib.md5(data).hexdigest()}"'
        assert got[1][0][0] == 403 and got[1][1] == "SignatureDoesNotMatch"
        assert got[2][0] == 200 and got[3][2] == data and got[4][2] == data and got[5] == 404

    def test_presigned_get_on_the_wire(self, stacks):
        body = _bytes(91, 999)

        def run(st):
            st.signed("/presigned", "PUT")
            st.signed("/presigned/obj", "PUT", body)
            host = f"127.0.0.1:{st.secured.port}"
            out = []
            for key, secret in ((ACCESS, SECRET), (ACCESS, "wrong")):
                query = _presign(st.side, "GET", "/presigned/obj", host, key, secret, _now())
                qs = urllib.parse.urlencode({k: v[0] for k, v in query.items()},
                                            quote_via=urllib.parse.quote)
                r = st.req(f"/presigned/obj?{qs}", secured=True)
                out.append((r.status, r.body if r.status == 200 else r.code()))
            return out
        assert _each(stacks, lambda st: run(st)) == [(200, body), (403, "SignatureDoesNotMatch")]


# --- the lifecycle ------------------------------------------------------------------


def test_build_failure_makes_s3_start_raise(monkeypatch):
    """The gateway's listener arms before S3ApiServer.start() returns,
    as the filer's and the volume server's do."""
    from seaweedfs_tpu_torch.s3api import S3ApiServer
    from seaweedfs_tpu_torch.util import native_serve

    def broken():
        raise RuntimeError("kernel build failed\nserve_ext.c: error: planted")

    monkeypatch.setattr(native_serve, "_ext", broken)
    gw = S3ApiServer(filer=f"127.0.0.1:{free_port()}", port=free_port())
    try:
        with pytest.raises(RuntimeError, match="planted"):
            gw.start()
    finally:
        gw.stop()


# threads of the process, not of a daemon: the tracing plane's span drainer
PROCESS_THREADS = ("trace-drain",)


def test_s3_stop_ends_every_thread_it_started(stacks):
    """stop() joins what start() began: the HTTP listener, the announce
    loop and its hold on the sampling profiler. Threads that outlive it
    are waited for up to 10 s (a connection thread ends when its client
    has gone), then listed by name."""
    from seaweedfs_tpu_torch.s3api import S3ApiServer
    from seaweedfs_tpu_torch.telemetry import profiler

    st = stacks["port"]
    before, users = set(threading.enumerate()), profiler._users
    gw = S3ApiServer(filer=f"127.0.0.1:{st.filer.port}", port=free_port(),
                     masters=[f"127.0.0.1:{st.master.port}"], announce_interval=0.2)
    gw.start()
    try:
        body = _bytes(95, 5000)
        base = f"http://127.0.0.1:{gw.port}"
        assert http(f"{base}/threadb", "PUT").status == 200
        assert http(f"{base}/threadb/o", "PUT", body).status == 200
        assert http(f"{base}/threadb/o").body == body
        started = {t.name for t in set(threading.enumerate()) - before}
        assert {"s3-http", "announce-s3"} <= started, started
    finally:
        gw.stop()

    def left():
        theirs = (set(st.master._grpc_pool._threads) | set(st.volume._grpc_pool._threads)
                  | set(st.filer._grpc_pool._threads))
        return [t for t in set(threading.enumerate()) - before - theirs
                if t.name not in PROCESS_THREADS]

    wait_for(lambda: not left(), 10)
    assert sorted(t.name for t in left()) == []
    assert profiler._users == users


def test_s3_modules_import_no_torch():
    code = ("import sys\n"
            "import seaweedfs_tpu_torch.s3api, seaweedfs_tpu_torch.s3api.client\n"
            "import seaweedfs_tpu_torch.s3api.chunked_reader, seaweedfs_tpu_torch.command.servers\n"
            "from seaweedfs_tpu_torch.command import COMMANDS\n"
            "assert 's3' in COMMANDS\n"
            "print(sorted(m for m in sys.modules if m.split('.')[0] in ('torch', 'jax')))\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True,
                         text=True, timeout=120)
    assert out.returncode == 0, out.stderr[-2000:]
    assert out.stdout.strip() == "[]"
