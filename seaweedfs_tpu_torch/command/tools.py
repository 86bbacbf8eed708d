"""Offline/utility subcommands: version, scaffold, upload, download,
backup, compact, fix, export — the tool half of the reference CLI
(weed/command/{upload,download,backup,compact,fix,export,scaffold,
version}.go); the port of seaweedfs_tpu/command/tools.py. `weedload`
waits for the telemetry plane (ROADMAP item 13) and exits 2."""

from __future__ import annotations

import argparse
import json
import os
import sys

from seaweedfs_tpu_torch.command import Command, Waiting, register

VERSION = "seaweedfs_tpu_torch 0.1 (PyTorch + CUDA build)"


@register
class VersionCommand(Command):
    name = "version"
    help = "print version"

    def run(self, args) -> int:
        print(VERSION)
        return 0


@register
class ScaffoldCommand(Command):
    name = "scaffold"
    help = "generate template toml config files"

    def add_arguments(self, p: argparse.ArgumentParser) -> None:
        p.add_argument(
            "-config",
            default="security",
            help="security | filer | notification | replication | master",
        )
        p.add_argument("-output", default="", help="write <name>.toml to this dir ('' = stdout)")

    def run(self, args) -> int:
        from seaweedfs_tpu_torch.util.config import SCAFFOLD_TEMPLATES

        text = SCAFFOLD_TEMPLATES.get(args.config)
        if text is None:
            print(f"unknown config {args.config}; have {sorted(SCAFFOLD_TEMPLATES)}")
            return 1
        if args.output:
            path = os.path.join(args.output, f"{args.config}.toml")
            with open(path, "w") as f:
                f.write(text)
            print(f"wrote {path}")
        else:
            print(text)
        return 0


@register
class UploadCommand(Command):
    name = "upload"
    help = "upload local files to the cluster (assign + upload; big files chunked)"

    def add_arguments(self, p: argparse.ArgumentParser) -> None:
        p.add_argument("files", nargs="*")
        p.add_argument(
            "-master", default="127.0.0.1:9333",
            help="master address host:port",
        )
        p.add_argument("-collection", default="", help="collection to upload into")
        p.add_argument("-replication", default="", help="replication policy like 001")
        p.add_argument("-ttl", default="", help="time-to-live like 3m/4h/5d")
        p.add_argument(
            "-maxMB", type=int, default=32,
            help="split uploads into chunks of this many MB",
        )
        p.add_argument(
            "-dir",
            default="",
            help="upload the whole folder recursively (upload.go:41)",
        )
        p.add_argument(
            "-include",
            default="",
            help="glob for files to include under -dir, e.g. *.pdf "
            "(upload.go:42; empty = everything)",
        )

    def run(self, args) -> int:
        import dataclasses
        import fnmatch

        from seaweedfs_tpu_torch.client import operation as op

        paths = list(args.files)
        if args.dir:
            # recursive directory walk, alphabetical like the reference
            for root, dirs, names in os.walk(args.dir):
                dirs.sort()
                for name in sorted(names):
                    if args.include and not fnmatch.fnmatch(
                        name, args.include
                    ):
                        continue
                    paths.append(os.path.join(root, name))
        if not paths:
            print(
                "usage: upload [files...] or upload -dir <folder> "
                "[-include '*.ext']",
                file=sys.stderr,
            )
            return 2
        results = []
        for path in paths:
            with open(path, "rb") as f:
                data = f.read()
            r = op.submit_file(
                args.master,
                os.path.basename(path),
                data,
                collection=args.collection,
                replication=args.replication,
                ttl=args.ttl,
                max_mb=args.maxMB,
            )
            results.append(dataclasses.asdict(r))
        print(json.dumps(results, indent=2))
        return 0


@register
class DownloadCommand(Command):
    name = "download"
    help = "download files by fid"

    def add_arguments(self, p: argparse.ArgumentParser) -> None:
        p.add_argument("fids", nargs="+")
        p.add_argument("-server", default="127.0.0.1:9333", help="master")
        p.add_argument("-dir", default=".", help="output directory for downloads")

    def run(self, args) -> int:
        from seaweedfs_tpu_torch.client import operation as op

        for fid in args.fids:
            url = op.lookup_file_id(args.server, fid)
            data, headers = op.download(url)
            name = headers.get("X-File-Name") or fid.replace(",", "_")
            out = os.path.join(args.dir, name)
            with open(out, "wb") as f:
                f.write(data)
            print(f"{fid} -> {out} ({len(data)} bytes)")
        return 0


@register
class BackupCommand(Command):
    name = "backup"
    help = "incrementally back up one volume from the cluster to local files"

    def add_arguments(self, p: argparse.ArgumentParser) -> None:
        p.add_argument(
            "-master", default="127.0.0.1:9333",
            help="master address host:port",
        )
        p.add_argument("-volumeId", type=int, required=True, help="volume to back up")
        p.add_argument("-dir", default=".", help="local directory for the backup copy")
        p.add_argument(
            "-collection", default="",
            help="collection the volume belongs to",
        )
        p.add_argument(
            "-ttl",
            default="",
            help="backup volume's TTL when created fresh (backup.go:34; "
            "default: no TTL)",
        )
        p.add_argument(
            "-replication",
            default="",
            help="backup volume's replication setting when created "
            "fresh (backup.go:42)",
        )

    def run(self, args) -> int:
        """Locate the volume, then VolumeIncrementalCopy since our local
        tail, appending raw records and rebuilding the index
        (command/backup.go runBackup semantics)."""
        import grpc

        from seaweedfs_tpu_torch.client import operation as op
        from seaweedfs_tpu_torch.pb import rpc, volume_pb2
        from seaweedfs_tpu_torch.storage.replica_placement import ReplicaPlacement
        from seaweedfs_tpu_torch.storage.ttl import TTL
        from seaweedfs_tpu_torch.storage.volume import Volume, volume_base_name

        result = op.lookup(args.master, str(args.volumeId))
        if result.error or not result.locations:
            print(f"volume {args.volumeId} not found: {result.error}")
            return 1
        vol = Volume(
            args.dir,
            args.volumeId,
            args.collection,
            replica_placement=(
                ReplicaPlacement.parse(args.replication)
                if args.replication
                else None
            ),
            ttl=TTL.parse(args.ttl) if args.ttl else None,
        )
        since = vol.last_append_at_ns
        vol.close()
        base = volume_base_name(args.dir, args.collection, args.volumeId)
        url = result.locations[0]["url"]
        appended = 0
        with rpc.dial(rpc.grpc_address(url)) as ch:
            stub = rpc.volume_stub(ch)
            with open(base + ".dat", "ab") as dat:
                for resp in stub.VolumeIncrementalCopy(
                    volume_pb2.VolumeIncrementalCopyRequest(
                        volume_id=args.volumeId, since_ns=since
                    )
                ):
                    dat.write(resp.file_content)
                    appended += len(resp.file_content)
        if appended:
            _rebuild_idx(base)
        print(f"backed up {appended} new bytes into {base}.dat")
        return 0


@register
class CompactCommand(Command):
    name = "compact"
    help = "offline-compact a local volume (drop deleted needles)"

    def add_arguments(self, p: argparse.ArgumentParser) -> None:
        p.add_argument("-dir", default=".", help="directory holding the volume files")
        p.add_argument("-volumeId", type=int, required=True, help="volume to compact")
        p.add_argument(
            "-collection", default="",
            help="collection the volume belongs to",
        )

    def run(self, args) -> int:
        from seaweedfs_tpu_torch.storage.volume import Volume

        vol = Volume(args.dir, args.volumeId, args.collection)
        before = vol.data_file_size()
        vol.compact()
        vol.commit_compact()
        after = vol.data_file_size()
        vol.close()
        print(f"compacted volume {args.volumeId}: {before} -> {after} bytes")
        return 0


@register
class FixCommand(Command):
    name = "fix"
    help = "rebuild a volume's .idx by scanning its .dat"

    def add_arguments(self, p: argparse.ArgumentParser) -> None:
        p.add_argument("-dir", default=".", help="directory holding the volume files")
        p.add_argument("-volumeId", type=int, required=True, help="volume to fix")
        p.add_argument(
            "-collection", default="",
            help="collection the volume belongs to",
        )

    def run(self, args) -> int:
        from seaweedfs_tpu_torch.storage.volume import volume_base_name

        base = volume_base_name(args.dir, args.collection, args.volumeId)
        count = _rebuild_idx(base)
        print(f"rebuilt {base}.idx with {count} entries")
        return 0


def _rebuild_idx(base: str) -> int:
    """Scan <base>.dat and rewrite <base>.idx; a record with size==0 is
    the deletion tombstone delete_needle appends (weed/command/fix.go)."""
    from seaweedfs_tpu_torch.storage import idx as idx_mod, types as t
    from seaweedfs_tpu_torch.storage.volume import scan_volume_file

    entries: dict[int, tuple[int, int]] = {}
    order: list[int] = []
    for needle, offset in scan_volume_file(base + ".dat"):
        if needle.size == 0:
            entries.pop(needle.id, None)
        else:
            if needle.id not in entries:
                order.append(needle.id)
            entries[needle.id] = (t.offset_to_units(offset), needle.size)
    with open(base + ".idx", "wb") as f:
        for key in order:
            if key in entries:
                off_units, size = entries[key]
                f.write(idx_mod.pack_entry(key, off_units, size))
    return len(entries)


@register
class ExportCommand(Command):
    name = "export"
    help = (
        "list needles in a local volume, or export them to a dir / a "
        ".tar (command/export.go)"
    )

    # export.go:44 default tar member name template
    DEFAULT_NAME_FORMAT = "{{.Mime}}/{{.Id}}:{{.Name}}"

    def add_arguments(self, p: argparse.ArgumentParser) -> None:
        p.add_argument("-dir", default=".", help="directory holding the volume files")
        p.add_argument("-volumeId", type=int, required=True, help="volume to export")
        p.add_argument(
            "-collection", default="",
            help="collection the volume belongs to",
        )
        p.add_argument(
            "-o",
            dest="output",
            default="",
            help="a directory to extract into, a .tar file name, or "
            "'-' for a tar stream on stdout (export.go:57)",
        )
        p.add_argument(
            "-fileNameFormat",
            default=self.DEFAULT_NAME_FORMAT,
            help="tar member name template; fields {{.Name}} {{.Id}} "
            "{{.Mime}} {{.Key}} (export.go:44)",
        )
        p.add_argument(
            "-newer",
            default="",
            help="export only files newer than this RFC3339 time "
            "without timezone, e.g. 2006-01-02T15:04:05 (export.go:59)",
        )

    @classmethod
    def _member_name(cls, fmt: str, needle, vid: int) -> str:
        name = (needle.name or b"").decode("utf-8", "replace")
        mime = (needle.mime or b"").decode("utf-8", "replace")
        return (
            fmt.replace("{{.Name}}", name or f"{needle.id:x}")
            .replace("{{.Id}}", f"{needle.id:x}")
            .replace("{{.Key}}", f"{needle.id:x}")
            .replace("{{.Mime}}", mime or "application/octet-stream")
        )

    def run(self, args) -> int:
        import datetime
        import tarfile

        from seaweedfs_tpu_torch.storage.volume import scan_volume_file, volume_base_name

        newer_than = None
        if args.newer:
            try:
                dt = datetime.datetime.fromisoformat(args.newer)
            except ValueError:
                print(f"cannot parse -newer {args.newer!r}", file=sys.stderr)
                return 2
            if dt.tzinfo is not None:
                # the flag is defined as RFC3339 WITHOUT timezone
                # (export.go:59) — reinterpreting an explicit offset
                # as UTC would silently shift the cutoff
                print(
                    f"-newer {args.newer!r} must not carry a timezone",
                    file=sys.stderr,
                )
                return 2
            newer_than = int(
                dt.replace(tzinfo=datetime.timezone.utc).timestamp()
            )

        base = volume_base_name(args.dir, args.collection, args.volumeId)
        # two passes: resolve final liveness first (later records —
        # overwrites and size==0 tombstones — supersede earlier ones),
        # then emit only each id's surviving record
        final_offset: dict[int, int] = {}
        for needle, off in scan_volume_file(base + ".dat"):
            if needle.size == 0:
                final_offset.pop(needle.id, None)
            else:
                final_offset[needle.id] = off

        tar = None
        to_tar = args.output == "-" or args.output.endswith(".tar")
        if to_tar:
            if args.output == "-":
                tar = tarfile.open(fileobj=sys.stdout.buffer, mode="w|")
            else:
                tar = tarfile.open(args.output, mode="w")
        count = 0
        try:
            for needle, offset in scan_volume_file(base + ".dat"):
                if needle.size == 0 or final_offset.get(needle.id) != offset:
                    continue
                if newer_than is not None and needle.last_modified < newer_than:
                    continue
                name = (needle.name or b"").decode("utf-8", "replace")
                if not to_tar or args.output != "-":
                    print(
                        f"key={needle.id:x} cookie={needle.cookie:08x} "
                        f"size={needle.size} name={name!r} "
                        f"mime={(needle.mime or b'').decode('utf-8', 'replace')!r}"
                    )
                if tar is not None:
                    member = self._member_name(
                        args.fileNameFormat, needle, args.volumeId
                    )
                    if needle.is_gzipped() and not member.endswith(".gz"):
                        # exported bytes stay as stored; the name says
                        # so (export.go:243)
                        member += ".gz"
                    info = tarfile.TarInfo(name=member)
                    info.size = len(needle.data)
                    info.mtime = needle.last_modified or 0
                    import io as _io

                    tar.addfile(info, _io.BytesIO(bytes(needle.data)))
                elif args.output:
                    out = os.path.join(
                        args.output, name or f"{args.volumeId}_{needle.id:x}"
                    )
                    if needle.is_gzipped() and not out.endswith(".gz"):
                        out += ".gz"
                    with open(out, "wb") as f:
                        f.write(needle.data)
                count += 1
        finally:
            if tar is not None:
                tar.close()
        print(f"{count} needles", file=sys.stderr)
        return 0


@register
class WeedloadCommand(Waiting):
    name = "weedload"
    help = (
        "multi-process closed-loop load harness: assign+PUT / "
        "lookup+GET workers, coordinated-omission-safe histograms, "
        "p50/p99/p99.9 report (telemetry plane, docs/TELEMETRY.md)"
    )
    item = 13

    def add_arguments(self, p: argparse.ArgumentParser) -> None:
        p.add_argument(
            "-master", default="127.0.0.1:9333",
            help="master address host:port",
        )
        p.add_argument("-duration", type=float, default=10.0, help="seconds")
        p.add_argument("-writers", type=int, default=2, help="PUT worker processes")
        p.add_argument("-readers", type=int, default=2, help="GET worker processes")
        p.add_argument("-size", type=int, default=1024, help="payload bytes")
        p.add_argument(
            "-rate",
            type=float,
            default=0.0,
            help="per-worker target req/s; >0 paces against a schedule "
            "and measures latency from the SCHEDULED start "
            "(coordinated-omission safe); 0 = unpaced closed loop",
        )
        p.add_argument("-seed", type=int, default=64, help="keys pre-written for GET workers")

