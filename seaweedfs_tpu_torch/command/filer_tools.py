"""filer.copy and filer.replicate subcommands
(weed/command/filer_copy.go, filer_replicate.go); the port of
seaweedfs_tpu/command/filer_tools.py. filer.copy POSTs each local file
to the filer, which holds no codec. filer.replicate consumes the
notification queue into a sink (replication/replicate_runner.py); SIGTERM
or SIGINT ends it with exit code 0 once what it applied is committed,
where the reference's dies on the signal."""

from __future__ import annotations

import argparse
import os
import signal
import threading
import urllib.request

from seaweedfs_tpu_torch.command import Command, register


@register
class FilerCopyCommand(Command):
    name = "filer.copy"
    help = "copy local files/directories into the filer namespace"

    def add_arguments(self, p: argparse.ArgumentParser) -> None:
        p.add_argument("sources", nargs="+", help="local files or directories")
        p.add_argument("dest", help="filer destination like http://filer:8888/path/")
        p.add_argument("-collection", default="", help="collection for uploaded chunks")
        p.add_argument("-replication", default="", help="replication policy like 001")
        p.add_argument("-ttl", default="", help="time-to-live like 3m/4h/5d")

    def run(self, args) -> int:
        dest = args.dest
        if not dest.startswith("http://"):
            dest = "http://" + dest
        if not dest.endswith("/"):
            dest += "/"
        copied = 0
        for src in args.sources:
            if os.path.isdir(src):
                base = os.path.dirname(os.path.abspath(src).rstrip("/"))
                for root, _, files in os.walk(src):
                    for fname in files:
                        local = os.path.join(root, fname)
                        rel = os.path.relpath(local, base)
                        copied += self._put(dest + rel, local, args)
            else:
                copied += self._put(dest + os.path.basename(src), src, args)
        print(f"copied {copied} files")
        return 0

    def _put(self, url: str, local: str, args) -> int:
        with open(local, "rb") as f:
            data = f.read()
        params = []
        if args.collection:
            params.append(f"collection={args.collection}")
        if args.replication:
            params.append(f"replication={args.replication}")
        if args.ttl:
            params.append(f"ttl={args.ttl}")
        if params:
            url += "?" + "&".join(params)
        req = urllib.request.Request(url, data=data, method="POST")
        with urllib.request.urlopen(req, timeout=60) as r:
            return 1 if r.status < 300 else 0


@register
class FilerReplicateCommand(Command):
    name = "filer.replicate"
    help = "consume filer update events from the notification queue and replicate to a sink"

    def add_arguments(self, p: argparse.ArgumentParser) -> None:
        p.add_argument("-config", default="", help="replication toml (default: search replication.toml)")

    def run(self, args) -> int:
        from seaweedfs_tpu_torch.replication.replicate_runner import run_replicate

        stop = threading.Event()

        def on_signal(signum, frame):
            stop.set()

        signal.signal(signal.SIGINT, on_signal)
        signal.signal(signal.SIGTERM, on_signal)
        return run_replicate(config_path=args.config, stop=stop)
