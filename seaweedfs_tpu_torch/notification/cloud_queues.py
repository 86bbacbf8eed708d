"""AWS SQS + Google Pub/Sub notification queues over their wire APIs.

Behavioral match of the reference's SDK-backed queues, speaking the
service protocols directly so the gate is credentials/connectivity,
not a library (the notification/kafka.py convention):

  SqsQueue     weed/notification/aws_sqs/aws_sqs_pub.go — the AWS
               Query protocol (GetQueueUrl at init, then SendMessage
               with MessageBody = the event's text-proto form and a
               `key` message attribute, DelaySeconds 10) signed with
               SigV4 (service "sqs", the same derivation the s3api
               gateway implements)
  PubSubQueue  weed/notification/google_pub_sub/google_pub_sub.go —
               the Pub/Sub REST publish endpoint
               (projects/{p}/topics/{t}:publish) with Data = the
               serialized proto and a `key` attribute, Bearer auth

Both are testable offline against tests/cloud_fakes.py
(FakeSqs / FakePubSub) via their endpoint overrides.

The port of seaweedfs_tpu/notification/cloud_queues.py; SQS requests
are signed by the port's s3api/auth.sigv4_sign.
"""

from __future__ import annotations

import base64
import datetime
import hashlib
import json
import urllib.error
import urllib.parse
import urllib.request

from seaweedfs_tpu_torch.pb import filer_pb2 as fpb


def _post(url: str, body: bytes, headers: dict, timeout: float = 30.0):
    req = urllib.request.Request(url, data=body, method="POST", headers=headers)
    try:
        with urllib.request.urlopen(req, timeout=timeout) as r:
            return r.status, r.read()
    except urllib.error.HTTPError as e:
        return e.code, e.read()


class SqsQueue:
    """notification.aws_sqs over the Query protocol + SigV4."""

    name = "aws_sqs"

    def __init__(
        self,
        access_key: str,
        secret_key: str,
        region: str,
        queue_name: str,
        endpoint: str = "",  # default https://sqs.{region}.amazonaws.com
    ):
        self.access_key = access_key
        self.secret_key = secret_key
        self.region = region or "us-east-1"
        self.endpoint = (
            endpoint.rstrip("/")
            or f"https://sqs.{self.region}.amazonaws.com"
        )
        # GetQueueUrl first, like the reference's initialize()
        try:
            status, body = self._call(
                {"Action": "GetQueueUrl", "QueueName": queue_name}
            )
        except OSError as e:  # DNS / refused / timeout, not an HTTP reply
            raise RuntimeError(
                f"notification queue 'aws_sqs' cannot reach {self.endpoint} "
                f"({e}); check the endpoint/network, or use the embedded "
                "[notification.logqueue]"
            ) from e
        if status != 200:
            raise RuntimeError(
                f"notification queue 'aws_sqs' cannot resolve queue "
                f"{queue_name!r} at {self.endpoint} (http {status} "
                f"{body[:200]!r}); check credentials/region, or use the "
                "embedded [notification.logqueue]"
            )
        import re

        m = re.search(rb"<QueueUrl>([^<]+)</QueueUrl>", body)
        if not m:
            raise RuntimeError(f"aws_sqs: no QueueUrl in {body[:200]!r}")
        self.queue_url = m.group(1).decode()

    def _call(self, params: dict) -> tuple[int, bytes]:
        """One signed Query-protocol POST to the endpoint root."""
        from seaweedfs_tpu_torch.s3api.auth import sigv4_sign

        params = {"Version": "2012-11-05", **params}
        body = urllib.parse.urlencode(sorted(params.items())).encode()
        host = urllib.parse.urlparse(self.endpoint).netloc
        amz_date = datetime.datetime.now(datetime.timezone.utc).strftime(
            "%Y%m%dT%H%M%SZ"
        )
        headers = {
            "host": host,
            "x-amz-date": amz_date,
            "content-type": "application/x-www-form-urlencoded",
        }
        headers["Authorization"] = sigv4_sign(
            "POST",
            "/",
            "",
            headers,
            hashlib.sha256(body).hexdigest(),
            self.access_key,
            self.secret_key,
            self.region,
            "sqs",
            amz_date,
        )
        del headers["host"]  # urllib sets it
        return _post(f"{self.endpoint}/", body, headers)

    def send_message(self, key: str, message: fpb.EventNotification) -> None:
        from google.protobuf import text_format

        status, body = self._call(
            {
                "Action": "SendMessage",
                "QueueUrl": self.queue_url,
                "MessageBody": text_format.MessageToString(message),
                "DelaySeconds": "10",
                "MessageAttribute.1.Name": "key",
                "MessageAttribute.1.Value.DataType": "String",
                "MessageAttribute.1.Value.StringValue": key,
            }
        )
        if status != 200:
            raise RuntimeError(f"aws_sqs send {key}: http {status} {body[:200]!r}")


class PubSubQueue:
    """notification.google_pub_sub over the REST publish endpoint."""

    name = "google_pub_sub"

    def __init__(
        self,
        project_id: str,
        topic: str,
        token: str = "",
        token_file: str = "",
        endpoint: str = "https://pubsub.googleapis.com",
    ):
        self.endpoint = endpoint.rstrip("/")
        self.path = f"/v1/projects/{project_id}/topics/{topic}"
        # token_file is re-read per request so an external refresher
        # (e.g. a cron running `gcloud auth print-access-token`) keeps
        # publishes working past the ~1 h OAuth token lifetime — the
        # role the reference's SDK credential auto-refresh plays
        self._token_file = token_file
        self._token = token
        if not token and not token_file and "googleapis.com" in self.endpoint:
            raise RuntimeError(
                "notification queue 'google_pub_sub' needs an OAuth bearer "
                "`token` or a `token_file` (or a custom `endpoint` for an "
                "emulator); or use the embedded [notification.logqueue]"
            )
        # existence probe, the role of the reference's topic.Exists →
        # CreateTopic flow: GET the topic; 404 → try to create it;
        # 403 → proceed (publisher-only credentials can publish but not
        # get/create — hard-failing would reject a valid config)
        status, body = self._get_topic()
        if status == 404:
            status, body = self._request(
                "PUT", self.path, json.dumps({}).encode()
            )
            if status not in (200, 409):
                raise RuntimeError(
                    f"google_pub_sub: topic missing and create failed "
                    f"(http {status} {body[:200]!r})"
                )
        elif status == 403:
            from seaweedfs_tpu_torch.util import wlog

            wlog.warning(
                "google_pub_sub: cannot GET topic %s (403; publisher-only "
                "credentials?) — proceeding, publishes will tell",
                self.path,
            )
        elif status != 200:
            raise RuntimeError(
                f"google_pub_sub: topic at {self.endpoint}{self.path} not "
                f"usable (http {status} {body[:200]!r})"
            )

    def _headers_now(self) -> dict:
        headers = {"Content-Type": "application/json"}
        token = self._token
        if self._token_file:
            try:
                with open(self._token_file) as f:
                    token = f.read().strip()
            except OSError:
                pass  # fall back to the static token, if any
        if token:
            headers["Authorization"] = f"Bearer {token}"
        return headers

    def _request(self, method: str, path: str, body: bytes | None):
        headers = self._headers_now()
        if body is None:
            headers.pop("Content-Type", None)
        req = urllib.request.Request(
            f"{self.endpoint}{path}", data=body, method=method, headers=headers
        )
        try:
            with urllib.request.urlopen(req, timeout=30) as r:
                return r.status, r.read()
        except urllib.error.HTTPError as e:
            return e.code, e.read()
        except OSError as e:
            raise RuntimeError(
                f"notification queue 'google_pub_sub' cannot reach "
                f"{self.endpoint} ({e}); check the endpoint/network, or "
                "use the embedded [notification.logqueue]"
            ) from e

    def _get_topic(self):
        return self._request("GET", self.path, None)

    def send_message(self, key: str, message: fpb.EventNotification) -> None:
        payload = {
            "messages": [
                {
                    "data": base64.b64encode(
                        message.SerializeToString()
                    ).decode(),
                    "attributes": {"key": key},
                }
            ]
        }
        status, body = self._request(
            "POST", f"{self.path}:publish", json.dumps(payload).encode()
        )
        if status != 200:
            raise RuntimeError(
                f"google_pub_sub publish {key}: http {status} {body[:200]!r}"
            )
