"""gRPC TLS/mTLS for cluster services.

Behavioral match of reference weed/security/tls.go: per-service
certificate config from security.toml —

    [grpc]
    ca = "/etc/ssl/ca.crt"

    [grpc.volume]   # also grpc.master / grpc.filer / grpc.client
    cert = "..."
    key  = "..."

A configured CA makes servers require client certificates (mTLS, the
reference's tls.RequireAndVerifyClientCert) and makes clients verify
servers against it. The process-wide dial/serve helpers in pb/rpc.py
consult this module so every channel and listening port honors one
config."""

from __future__ import annotations

from dataclasses import dataclass

import grpc


@dataclass
class TlsConfig:
    ca_pem: bytes | None = None
    cert_pem: bytes | None = None
    key_pem: bytes | None = None

    @property
    def is_enabled(self) -> bool:
        return bool(self.cert_pem and self.key_pem)


def _read(path: str) -> bytes | None:
    if not path:
        return None
    with open(path, "rb") as f:
        return f.read()


def load_tls_config(cfg, component: str) -> TlsConfig | None:
    """security.toml [grpc] + [grpc.<component>] → TlsConfig
    (LoadServerTLS/LoadClientTLS, tls.go)."""
    cert = cfg.get_string(f"grpc.{component}.cert") or cfg.get_string("grpc.cert")
    key = cfg.get_string(f"grpc.{component}.key") or cfg.get_string("grpc.key")
    ca = cfg.get_string("grpc.ca")
    if not cert and not key and not ca:
        return None
    if not cert or not key:
        # a partial config silently downgrading to plaintext would be a
        # security misconfiguration; refuse to start instead
        raise ValueError(
            f"incomplete gRPC TLS config for {component!r}: both cert and "
            f"key are required (got cert={bool(cert)}, key={bool(key)}, "
            f"ca={bool(ca)})"
        )
    return TlsConfig(
        ca_pem=_read(ca), cert_pem=_read(cert), key_pem=_read(key)
    )


def server_credentials(tls: TlsConfig) -> grpc.ServerCredentials:
    return grpc.ssl_server_credentials(
        [(tls.key_pem, tls.cert_pem)],
        root_certificates=tls.ca_pem,
        require_client_auth=tls.ca_pem is not None,
    )


def client_credentials(tls: TlsConfig) -> grpc.ChannelCredentials:
    return grpc.ssl_channel_credentials(
        root_certificates=tls.ca_pem,
        private_key=tls.key_pem,
        certificate_chain=tls.cert_pem,
    )
