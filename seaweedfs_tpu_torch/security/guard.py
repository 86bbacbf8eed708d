"""Access guard: IP white list first, then JWT.

Behavioral match of weed/security/guard.go: a Guard holds a white list
(IPs or CIDRs), a write signing key and a read signing key; security is
inactive (everything passes) when neither white list nor key is set
(guard.go:62, 70-72). The white list is checked before the JWT because
it is cheap (guard.go:28). CIDR entries match by network containment;
"*" matches anything (reference uses exact-IP match only; CIDR is a
strict superset kept for operator convenience).
"""

from __future__ import annotations

import ipaddress

from seaweedfs_tpu_torch.security import jwt as jwt_mod


class UnauthorizedError(Exception):
    pass


class Guard:
    def __init__(
        self,
        white_list: list[str] | None = None,
        signing_key: str = "",
        expires_after_sec: int = 10,
        read_signing_key: str = "",
        read_expires_after_sec: int = 60,
    ):
        self.white_list = list(white_list or [])
        self.signing_key = signing_key
        self.expires_after_sec = expires_after_sec
        self.read_signing_key = read_signing_key
        self.read_expires_after_sec = read_expires_after_sec
        self._networks = []
        for entry in self.white_list:
            if entry == "*":
                self._networks.append(None)
                continue
            try:
                self._networks.append(ipaddress.ip_network(entry, strict=False))
            except ValueError:
                self._networks.append(entry)  # hostname literal, exact match

    @property
    def is_write_active(self) -> bool:
        return bool(self.white_list) or bool(self.signing_key)

    @property
    def is_read_active(self) -> bool:
        return bool(self.read_signing_key)

    def white_list_ok(self, remote_ip: str) -> bool:
        if not self.white_list:
            return False
        try:
            addr = ipaddress.ip_address(remote_ip)
        except ValueError:
            return remote_ip in self.white_list
        for net in self._networks:
            if net is None:
                return True
            if isinstance(net, str):
                if net == remote_ip:
                    return True
            elif addr in net:
                return True
        return False

    def sign_write(self, file_id: str) -> str:
        return jwt_mod.gen_jwt(self.signing_key, self.expires_after_sec, file_id)

    def sign_read(self, file_id: str) -> str:
        return jwt_mod.gen_jwt(
            self.read_signing_key, self.read_expires_after_sec, file_id
        )

    def check_write(self, remote_ip: str, token: str, file_id: str = "") -> None:
        """Raise UnauthorizedError unless the request may write.
        White list passes outright; otherwise the JWT must verify and,
        when it carries a fid claim, match the target file id."""
        self._check(remote_ip, token, file_id, self.signing_key, self.is_write_active)

    def check_read(self, remote_ip: str, token: str, file_id: str = "") -> None:
        self._check(
            remote_ip, token, file_id, self.read_signing_key, self.is_read_active
        )

    def _check(
        self, remote_ip: str, token: str, file_id: str, key: str, active: bool
    ) -> None:
        if not active:
            return
        if self.white_list_ok(remote_ip):
            return
        if not key:
            raise UnauthorizedError(f"ip {remote_ip} not in white list")
        if not token:
            raise UnauthorizedError("no jwt token")
        try:
            claims = jwt_mod.decode_jwt(key, token)
        except jwt_mod.JwtError as e:
            raise UnauthorizedError(str(e)) from e
        claimed = claims.get("fid", "")
        if file_id and claimed and claimed != file_id:
            raise UnauthorizedError(f"jwt is for {claimed}, not {file_id}")
