"""TOML configuration with env-var override, the viper idiom.

Behavioral match of weed/util/config.go:19-50: `load_config("filer")`
searches `./filer.toml`, `~/.seaweedfs_tpu/filer.toml`,
`/etc/seaweedfs_tpu/filer.toml` in order; any key can be overridden by
an environment variable `WEED_SECTION_SUB_KEY` (dots → underscores,
upper-cased, `WEED_` prefix — config.go:45-50). Missing files are fine
unless required=True (config.go:31-39).

Template configs (the reference generates these with `weed scaffold`,
command/scaffold.go:33-45) live in SCAFFOLD_TEMPLATES for the CLI.

The port of seaweedfs_tpu/util/config.py. It reads the same files from
the same places as the reference, so one security.toml serves both
packages' daemons; Python 3.11+'s tomllib parses them.
"""

from __future__ import annotations

import os

import tomllib

CONFIG_SEARCH_DIRS = (".", "~/.seaweedfs_tpu", "/etc/seaweedfs_tpu")
ENV_PREFIX = "WEED_"


class Configuration:
    """Dotted-key view over a parsed TOML tree with env override."""

    def __init__(self, tree: dict, env: dict | None = None):
        self._tree = tree
        self._env = os.environ if env is None else env

    def _env_key(self, key: str) -> str:
        return ENV_PREFIX + key.replace(".", "_").upper()

    def get(self, key: str, default=None):
        env_val = self._env.get(self._env_key(key))
        if env_val is not None:
            return env_val
        node = self._tree
        for part in key.split("."):
            if not isinstance(node, dict) or part not in node:
                return default
            node = node[part]
        return node

    def get_bool(self, key: str, default: bool = False) -> bool:
        val = self.get(key, default)
        if isinstance(val, str):
            return val.strip().lower() in ("1", "true", "yes", "on")
        return bool(val)

    def get_int(self, key: str, default: int = 0) -> int:
        val = self.get(key, default)
        return int(val)

    def get_string(self, key: str, default: str = "") -> str:
        val = self.get(key, default)
        return str(val)

    def sub(self, prefix: str) -> dict:
        """The raw subtree under a dotted prefix ({} if absent)."""
        node = self._tree
        for part in prefix.split("."):
            if not isinstance(node, dict) or part not in node:
                return {}
            node = node[part]
        return node if isinstance(node, dict) else {}


def load_config(
    name: str,
    required: bool = False,
    search_dirs: tuple[str, ...] = CONFIG_SEARCH_DIRS,
    env: dict | None = None,
) -> Configuration:
    for d in search_dirs:
        path = os.path.join(os.path.expanduser(d), f"{name}.toml")
        if os.path.isfile(path):
            with open(path, "rb") as f:
                return Configuration(tomllib.load(f), env=env)
    if required:
        raise FileNotFoundError(
            f"no {name}.toml found in {', '.join(search_dirs)}"
        )
    return Configuration({}, env=env)


SCAFFOLD_TEMPLATES = {
    "security": """\
# security.toml — put in ./, ~/.seaweedfs_tpu/, or /etc/seaweedfs_tpu/
# Any key can be overridden by env var WEED_<SECTION>_<KEY>.

[jwt.signing]
key = ""
expires_after_seconds = 10

[jwt.signing.read]
key = ""
expires_after_seconds = 60

[access]
# ui = false
white_list = []

[grpc]
ca = ""

[grpc.volume]
cert = ""
key = ""

[grpc.master]
cert = ""
key = ""

[grpc.filer]
cert = ""
key = ""

[grpc.client]
cert = ""
key = ""
""",
    "filer": """\
# filer.toml — filer metadata store selection.
# Exactly one store should be enabled.

[memory]
enabled = false

[sqlite]
enabled = true
dbfile = "./filer.db"

[appendlog]
enabled = false
dir = "./filerlog"
""",
    "notification": """\
# notification.toml — filer update-event queue.

[notification.log]
enabled = false

[notification.memory]
enabled = false

[notification.dirqueue]
enabled = false
dir = "./notifications"
""",
    "replication": """\
# replication.toml — weed filer.replicate source and sink.

[source.filer]
enabled = true
grpcAddress = "localhost:18888"
directory = "/buckets"

[sink.filer]
enabled = false
grpcAddress = "localhost:18888"
directory = "/backup"
replication = ""
collection = ""
ttlSec = 0

[sink.local]
enabled = false
directory = "/tmp/backup"
""",
    "master": """\
# master.toml — master maintenance scripts (run by the leader on a cron).

[master.maintenance]
scripts = \"\"\"
  lock
  ec.encode -fullPercent=95 -quietFor=1h
  ec.rebuild -force
  ec.balance -force
  volume.balance -force
  unlock
\"\"\"
sleep_minutes = 17

[master.sequencer]
type = "memory"
""",
}
