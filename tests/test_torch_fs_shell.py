"""The port's fs.* verbs (seaweedfs_tpu_torch/shell/fs_commands.py and the
fs.* context of shell/command_env.py) against seaweedfs_tpu's, on the CPU.

tests/test_shell.py's TestFsCommands ported: a master, a volume server
and a filer of each package (tests/test_torch_filer.Trio) hold the same
small namespace, and every verb runs through both packages' shells
against both packages' filers, four ways. The four outputs are equal
once the filer's address, the chunks' fids and the clocks are masked;
the original assertions hold on the port's shell against the port's
filer. fs.meta.notify publishes to each package's memory queue. The
tolerance is equality.
"""

import importlib
import io
import re
import urllib.request

import pytest

from tests.test_torch_filer import Trio, http

SIDES = ("ref", "port")
PKG = {"ref": "seaweedfs_tpu", "port": "seaweedfs_tpu_torch"}
WAYS = [(shell, filer) for shell in SIDES for filer in SIDES]
SEED = [("/docs/a.txt", b"alpha"), ("/docs/b.txt", b"beta beta"),
        ("/docs/sub/c.txt", b"gamma!"), ("/top.txt", b"root file")]


def mod(side, name):
    return importlib.import_module(f"{PKG[side]}.{name}")


@pytest.fixture(scope="module")
def filers(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("fs-shell"))
    out = {}
    try:
        for side in SIDES:
            t = out[side] = Trio(side, root, max_mb=32)
            for path, data in SEED:
                req = urllib.request.Request(t.url(path), data=data, method="POST")
                urllib.request.urlopen(req, timeout=10).close()
        yield out
    finally:
        for t in out.values():
            t.stop()


def _mask(text, trio):
    text = text.replace(f"127.0.0.1:{trio.filer.port}", "FILER")
    text = re.sub(r'fid: "\d+,[0-9a-f]+"', 'fid: "FID"', text)
    text = re.sub(r"\b(mtime|crtime): \d+", r"\1: T", text)
    return text


class Shell:
    """One package's shell pointed at one trio's master."""

    def __init__(self, side, trio):
        self.side, self.trio = side, trio
        self.env = mod(side, "shell").CommandEnv([f"127.0.0.1:{trio.master.port}"])

    def __call__(self, line):
        out = io.StringIO()
        mod(self.side, "shell").run_command(self.env, line, out)
        return out.getvalue()

    def cd(self, path="/"):
        return self(f"fs.cd http://127.0.0.1:{self.trio.filer.port}{path}")


def four_ways(filers, fn):
    """fn(shell) through every (shell package, filer package) pair; the
    masked outputs are equal. Returns the port-on-port output."""
    got = {}
    for shell_side, filer_side in WAYS:
        sh = Shell(shell_side, filers[filer_side])
        got[(shell_side, filer_side)] = _mask(fn(sh), filers[filer_side])
    assert len(set(got.values())) == 1, got
    return got[("port", "port")]


def test_cd_pwd_ls(filers):
    def run(sh):
        out = sh.cd("/docs")
        assert sh.env.filer == f"127.0.0.1:{sh.trio.filer.port}" and sh.env.cwd == "/docs"
        return out + sh("fs.pwd") + sh("fs.ls") + sh("fs.ls -l") + sh("fs.ls -l -a /")
    out = four_ways(filers, run)
    assert "/docs" in out and "a.txt" in out and "sub/" in out and "total" in out


def test_du_and_tree(filers):
    def run(sh):
        sh.cd()
        return sh("fs.du /docs") + sh("fs.du /docs/a.txt") + sh("fs.tree /docs") + sh("fs.tree")
    out = four_ways(filers, run)
    assert "3 files" in out and "c.txt" in out and ("└──" in out or "├──" in out)


def test_cat(filers):
    out = four_ways(filers, lambda sh: (sh.cd(), sh("fs.cat /docs/a.txt"))[1])
    assert out == "alpha"


def test_mv(filers):
    """Each way moves its own file (so /docs stays as seeded): a rename,
    and a move into a directory."""
    ways = iter(range(len(WAYS)))

    def run(sh):
        tag = f"way{next(ways)}"
        http(sh.trio.url(f"/mv{tag}/top.txt"), b"root file")
        sh.cd()
        out = sh(f"fs.mv /mv{tag}/top.txt /mv{tag}/renamed.txt")
        out += sh(f"fs.ls /mv{tag}") + sh(f"fs.cat /mv{tag}/renamed.txt")
        sh(f"fs.mv /mv{tag}/renamed.txt /docs/sub")
        out += sh("fs.ls /docs/sub")
        sh(f"fs.mv /docs/sub/renamed.txt /mv{tag}/top.txt")
        return out.replace(tag, "TAG")
    out = four_ways(filers, run)
    assert "renamed.txt" in out and "root file" in out


def test_meta_cat_save_load(filers, tmp_path):
    def run(sh):
        import grpc

        sh.cd()
        out = sh("fs.meta.cat /docs/a.txt")
        out_file = tmp_path / f"{sh.side}-{sh.trio.side}.meta"
        out += sh(f"fs.meta.save -o {out_file} /docs").replace(str(out_file), "F")
        fpb = mod(sh.trio.side, "pb.filer_pb2")
        with grpc.insecure_channel(f"127.0.0.1:{sh.trio.filer.grpc_port}") as ch:
            mod(sh.trio.side, "pb.rpc").filer_stub(ch).DeleteEntry(fpb.DeleteEntryRequest(
                directory="/docs", name="a.txt", is_delete_data=False))
        out += sh("fs.ls /docs")
        out += sh(f"fs.meta.load {out_file}") + sh("fs.ls /docs") + sh("fs.cat /docs/a.txt")
        return out
    out = four_ways(filers, run)
    assert 'name: "a.txt"' in out and "saved 4 entries" in out and "loaded 4 entries" in out
    assert out.endswith("alpha")


def test_meta_notify_publishes_to_the_memory_queue(filers, monkeypatch):
    def run(sh):
        notification = mod(sh.side, "notification")
        monkeypatch.setattr(notification, "queue", notification.MemoryQueue())
        sh.cd()
        out = sh("fs.meta.notify /docs")
        keys = []
        while len(notification.queue):
            key, msg = notification.queue.receive(timeout=0)
            keys.append(f"{key} {msg.new_entry.name}")
        return out + "\n".join(sorted(keys))
    out = four_ways(filers, run)
    assert "notified 4 entries" in out and "/docs/sub/c.txt c.txt" in out


def test_errors_name_what_is_missing(filers):
    """No filer selected, a missing path and a move across filers fail
    with the reference's messages on both shells."""
    got = {}
    for side in SIDES:
        sh = Shell(side, filers[side])
        errs = []
        for line in ("fs.ls /", "fs.cat", "fs.mv a", "fs.meta.load"):
            with pytest.raises(ValueError) as ei:
                sh(line)
            errs.append(str(ei.value))
        sh.cd()
        for line in ("fs.du /nope", "fs.cd /docs/a.txt",
                     "fs.mv http://127.0.0.1:1/a http://127.0.0.1:2/b"):
            with pytest.raises(ValueError) as ei:
                sh(line)
            errs.append(str(ei.value))
        got[side] = errs
    assert got["port"] == got["ref"]
    assert got["port"][0].startswith("no filer selected")
