"""fs.* shell commands — filer namespace operations from the admin
shell (reference weed/shell/command_fs_*.go, 11 commands).

Context model matches commands.go CommandEnv: `fs.cd
http://<filer>:<port>/dir` selects the filer + working directory;
later relative paths resolve against it. Absolute http:// paths work
on any command without a prior cd.

The port of seaweedfs_tpu/shell/fs_commands.py.
"""

from __future__ import annotations


import posixpath
import struct

from seaweedfs_tpu_torch.pb import filer_pb2 as fpb
from seaweedfs_tpu_torch.pb import rpc
from seaweedfs_tpu_torch.shell.commands import Command, CommandEnv, _flag, _has_flag, register


def _stub(env: CommandEnv, filer: str):
    return env.filer_channel(filer)


def _lookup(stub, directory: str, name: str) -> fpb.Entry | None:
    import grpc

    try:
        resp = stub.LookupDirectoryEntry(
            fpb.LookupDirectoryEntryRequest(directory=directory, name=name)
        )
    except grpc.RpcError as e:
        # only "no such entry" maps to None; a down/unreachable filer
        # must surface as the infrastructure error it is
        if e.code() == grpc.StatusCode.NOT_FOUND:
            return None
        raise
    return resp.entry if resp.entry.name else None


_PAGE = 1024


def _list(stub, directory: str) -> list[fpb.Entry]:
    """Full listing with pagination — the filer caps one ListEntries
    page (fs.meta.save is a backup tool; silent truncation of big
    directories would be data loss)."""
    out: list[fpb.Entry] = []
    start = ""
    while True:
        page = [
            r.entry
            for r in stub.ListEntries(
                fpb.ListEntriesRequest(
                    directory=directory,
                    start_from_file_name=start,
                    inclusive_start_from=False,
                    limit=_PAGE,
                )
            )
        ]
        out.extend(page)
        if len(page) < _PAGE:
            return out
        start = page[-1].name


def _is_dir(stub, path: str) -> bool:
    if path == "/":
        return True
    d, name = posixpath.split(path)
    e = _lookup(stub, d or "/", name)
    return e is not None and e.is_directory


def _entry_size(e: fpb.Entry) -> int:
    return e.attributes.file_size or sum(c.size for c in e.chunks)


def _walk(stub, directory: str):
    """Yield (directory, entry) depth-first (filer_pb TraverseBfs role)."""
    for e in _list(stub, directory):
        yield directory, e
        if e.is_directory:
            child = f"{directory.rstrip('/')}/{e.name}"
            yield from _walk(stub, child)


def _walk_path(stub, path: str):
    """_walk that also accepts a single-file path (a backup tool must
    not silently save 0 entries for an existing file)."""
    if _is_dir(stub, path):
        yield from _walk(stub, path)
        return
    d, name = posixpath.split(path)
    e = _lookup(stub, d or "/", name)
    if e is None:
        raise ValueError(f"{path} not found")
    yield d or "/", e


@register
class FsCd(Command):
    name = "fs.cd"
    help = "fs.cd http://<filer>:<port>/dir | fs.cd <dir> — change working directory"

    def run(self, env, args, out):
        if not args:
            env.cwd = "/"
            return
        filer, path = env.parse_fs_path(args[0])
        with _stub(env, filer) as ch:
            if not _is_dir(rpc.filer_stub(ch), path):
                raise ValueError(f"{path} is not a directory")
        env.filer = filer
        env.cwd = path
        print(f"{filer}{path}", file=out)


@register
class FsPwd(Command):
    name = "fs.pwd"
    help = "fs.pwd — print the current filer working directory"

    def run(self, env, args, out):
        if not env.filer:
            print("(no filer selected; fs.cd http://<filer>:<port>/)", file=out)
            return
        print(f"http://{env.filer}{env.cwd}", file=out)


@register
class FsLs(Command):
    name = "fs.ls"
    help = "fs.ls [-l] [-a] [path] — list directory entries"

    def run(self, env, args, out):
        paths = [a for a in args if not a.startswith("-")]
        filer, path = env.parse_fs_path(paths[0] if paths else ".")
        long_fmt = _has_flag(args, "l")
        show_all = _has_flag(args, "a")
        with _stub(env, filer) as ch:
            stub = rpc.filer_stub(ch)
            entries = _list(stub, path)
        shown = 0
        for e in sorted(entries, key=lambda x: x.name):
            if not show_all and e.name.startswith("."):
                continue
            shown += 1
            if long_fmt:
                a = e.attributes
                kind = "d" if e.is_directory else "-"
                print(
                    f"{kind}{a.file_mode & 0o777:03o} {a.uid:>4} {a.gid:>4} "
                    f"{_entry_size(e):>12} {e.name}{'/' if e.is_directory else ''}",
                    file=out,
                )
            else:
                print(f"{e.name}{'/' if e.is_directory else ''}", file=out)
        if long_fmt:
            print(f"total {shown}", file=out)


@register
class FsDu(Command):
    name = "fs.du"
    help = "fs.du [path] — recursive disk usage (bytes, files, dirs)"

    def run(self, env, args, out):
        filer, path = env.parse_fs_path(args[0] if args else ".")
        with _stub(env, filer) as ch:
            stub = rpc.filer_stub(ch)
            size = files = dirs = 0
            if not _is_dir(stub, path):
                d, name = posixpath.split(path)
                e = _lookup(stub, d or "/", name)
                if e is None:
                    raise ValueError(f"{path} not found")
                size, files = _entry_size(e), 1
            else:
                for _, e in _walk(stub, path):
                    if e.is_directory:
                        dirs += 1
                    else:
                        files += 1
                        size += _entry_size(e)
        print(f"{size}\t{files} files\t{dirs} dirs\t{path}", file=out)


@register
class FsCat(Command):
    name = "fs.cat"
    help = "fs.cat <path> — print a file's content"

    def run(self, env, args, out):
        if not args:
            raise ValueError("fs.cat <path>")
        filer, path = env.parse_fs_path(args[0])
        import urllib.parse
        import urllib.request

        with urllib.request.urlopen(
            f"http://{filer}{urllib.parse.quote(path)}", timeout=30
        ) as r:
            data = r.read()
        try:
            print(data.decode(), end="", file=out)
        except UnicodeDecodeError:
            print(f"<binary: {len(data)} bytes>", file=out)


@register
class FsTree(Command):
    name = "fs.tree"
    help = "fs.tree [path] — tree view of the namespace"

    def run(self, env, args, out):
        filer, path = env.parse_fs_path(args[0] if args else ".")
        with _stub(env, filer) as ch:
            stub = rpc.filer_stub(ch)
            print(path, file=out)
            files, dirs = self._tree(stub, path, "", out)
        print(f"\n{dirs} directories, {files} files", file=out)

    def _tree(self, stub, directory: str, prefix: str, out) -> tuple[int, int]:
        entries = sorted(_list(stub, directory), key=lambda e: e.name)
        files = dirs = 0
        for i, e in enumerate(entries):
            last = i == len(entries) - 1
            tee = "└── " if last else "├── "
            print(f"{prefix}{tee}{e.name}", file=out)
            if e.is_directory:
                dirs += 1
                ext = "    " if last else "│   "
                f2, d2 = self._tree(
                    stub, f"{directory.rstrip('/')}/{e.name}", prefix + ext, out
                )
                files += f2
                dirs += d2
            else:
                files += 1
        return files, dirs


@register
class FsMv(Command):
    name = "fs.mv"
    help = "fs.mv <src> <dst> — move/rename (atomic; into dst if dst is a dir)"

    def run(self, env, args, out):
        if len(args) != 2:
            raise ValueError("fs.mv <src> <dst>")
        filer, src = env.parse_fs_path(args[0])
        filer2_, dst = env.parse_fs_path(args[1])
        if filer2_ != filer:
            raise ValueError("cannot move across filers")
        sd, sn = posixpath.split(src)
        with _stub(env, filer) as ch:
            stub = rpc.filer_stub(ch)
            if _is_dir(stub, dst):
                dd, dn = dst, sn
            else:
                dd, dn = posixpath.split(dst)
            stub.AtomicRenameEntry(
                fpb.AtomicRenameEntryRequest(
                    old_directory=sd or "/",
                    old_name=sn,
                    new_directory=dd or "/",
                    new_name=dn,
                )
            )
        print(f"moved {src} -> {dd.rstrip('/')}/{dn}", file=out)


@register
class FsMetaCat(Command):
    name = "fs.meta.cat"
    help = "fs.meta.cat <path> — print an entry's metadata"

    def run(self, env, args, out):
        if not args:
            raise ValueError("fs.meta.cat <path>")
        filer, path = env.parse_fs_path(args[0])
        d, name = posixpath.split(path)
        with _stub(env, filer) as ch:
            e = _lookup(rpc.filer_stub(ch), d or "/", name)
        if e is None:
            raise ValueError(f"{path} not found")
        print(str(e), file=out)


_META_MAGIC = b"SWMETA01"


@register
class FsMetaSave(Command):
    name = "fs.meta.save"
    help = "fs.meta.save [-o <file>] [path] — save metadata tree to a local file"

    def run(self, env, args, out):
        paths = [
            a
            for i, a in enumerate(args)
            if not a.startswith("-") and (i == 0 or args[i - 1] != "-o")
        ]
        filer, path = env.parse_fs_path(paths[0] if paths else ".")
        out_file = _flag(args, "o") or f"meta{path.replace('/', '-')}.meta"
        count = 0
        with _stub(env, filer) as ch, open(out_file, "wb") as f:
            stub = rpc.filer_stub(ch)
            f.write(_META_MAGIC)
            for directory, e in _walk_path(stub, path):
                blob = fpb.FullEntry(dir=directory, entry=e).SerializeToString()
                f.write(struct.pack(">I", len(blob)))
                f.write(blob)
                count += 1
        print(f"saved {count} entries to {out_file}", file=out)


@register
class FsMetaLoad(Command):
    name = "fs.meta.load"
    help = "fs.meta.load <file> — restore metadata saved by fs.meta.save"

    def run(self, env, args, out):
        if not args:
            raise ValueError("fs.meta.load <file>")
        if not env.filer:
            raise ValueError("fs.cd to the destination filer first")
        count = 0
        with open(args[0], "rb") as f, _stub(env, env.filer) as ch:
            stub = rpc.filer_stub(ch)
            if f.read(len(_META_MAGIC)) != _META_MAGIC:
                raise ValueError(f"{args[0]} is not an fs.meta.save file")
            while True:
                hdr = f.read(4)
                if len(hdr) < 4:
                    break
                (n,) = struct.unpack(">I", hdr)
                fe = fpb.FullEntry()
                fe.ParseFromString(f.read(n))
                stub.CreateEntry(
                    fpb.CreateEntryRequest(directory=fe.dir, entry=fe.entry)
                )
                count += 1
        print(f"loaded {count} entries", file=out)


@register
class FsMetaNotify(Command):
    name = "fs.meta.notify"
    help = "fs.meta.notify [path] — publish create events for the tree to the notification queue"

    def run(self, env, args, out):
        from seaweedfs_tpu_torch import notification

        filer, path = env.parse_fs_path(args[0] if args else ".")
        queue = notification.queue
        if queue is None:
            raise ValueError(
                "no notification queue configured (notification.toml)"
            )
        count = 0
        with _stub(env, filer) as ch:
            stub = rpc.filer_stub(ch)
            for directory, e in _walk_path(stub, path):
                queue.send_message(
                    f"{directory.rstrip('/')}/{e.name}",
                    fpb.EventNotification(new_entry=e),
                )
                count += 1
        print(f"notified {count} entries", file=out)
