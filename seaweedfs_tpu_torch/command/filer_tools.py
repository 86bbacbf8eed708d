"""filer.copy and filer.replicate subcommands
(weed/command/filer_copy.go, filer_replicate.go); the port of
seaweedfs_tpu/command/filer_tools.py. Both are registered with the
reference's flags and help and exit 2: filer.copy needs the filer
(ROADMAP item 11), filer.replicate replication/ (item 12)."""

from __future__ import annotations

import argparse

from seaweedfs_tpu_torch.command import Waiting, register


@register
class FilerCopyCommand(Waiting):
    name = "filer.copy"
    help = "copy local files/directories into the filer namespace"
    item = 11

    def add_arguments(self, p: argparse.ArgumentParser) -> None:
        p.add_argument("sources", nargs="+", help="local files or directories")
        p.add_argument("dest", help="filer destination like http://filer:8888/path/")
        p.add_argument("-collection", default="", help="collection for uploaded chunks")
        p.add_argument("-replication", default="", help="replication policy like 001")
        p.add_argument("-ttl", default="", help="time-to-live like 3m/4h/5d")


@register
class FilerReplicateCommand(Waiting):
    name = "filer.replicate"
    help = "consume filer update events from the notification queue and replicate to a sink"
    item = 12

    def add_arguments(self, p: argparse.ArgumentParser) -> None:
        p.add_argument("-config", default="", help="replication toml (default: search replication.toml)")
