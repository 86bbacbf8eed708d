"""The port's command line (`python -m seaweedfs_tpu_torch`) against
seaweedfs_tpu's, on the CPU.

tests/test_cli.py ported, each case on both packages where both can run
it. The offline tools run on one volume written once by the reference
(the volume clock pinned) and copied for each package: `fix`'s .idx,
`compact`'s .dat, `export`'s listing, directory and tar must be byte
for byte the same. `help` lists the reference's command names. The
cluster tools (upload, download, a small benchmark, a shell script and
the incremental backup) run against each package's own in-process
cluster, the port's on the cuda backend with device="cpu" (the kernels'
plain versions). The subprocess cases start the port's daemons with
`-ec.codec cpu`, as the repo conftest's WEED_EC_CODEC=cpu does for the
reference's, and the master with its telemetry collector on at the
reference's default interval: the all-in-one `server`, a SIGKILLed
volume server restarted on its directory, and the master's liveness
sweep of a SIGSTOPped volume server; each subprocess case keeps the time
limits the reference's gives it. The telemetry plane's commands run as
the reference's do: `weedload` against each package's in-process
cluster exits 0 with the reference's report keys, and `master
-telemetryInterval 10` answers /cluster/alerts. `filer.replicate` drains a
logqueue into a local sink as a subprocess, ends with exit code 0 on
SIGTERM and resumes from its cursor. The commands whose
planes the port does not have exit 2 naming their ROADMAP item, and a
`volume` with neither a card nor `-ec.codec` fails naming CUDA. The
filer plane's commands run: `filer -store lsm` as a subprocess that
`filer.copy` fills (its report equal to the reference's against the
reference's filer), restarted on its -storePath with the namespace
intact, and the all-in-one `server -filer`; SIGTERM ends each with exit
code 0 (`master -sequencer.etcd` is in tests/test_torch_etcd.py). The S3
gateway's commands run: `s3 -config` with one identity and the
all-in-one `server -filer -s3` answer a signed ListBuckets equal to the
reference's gateway's over the same buckets, `s3 -serveProcs 2` puts two
listeners on one port, and SIGTERM ends each with exit code 0. The
WebDAV gateway's commands run: `webdav` and the all-in-one `server
-webdav` answer OPTIONS with the reference gateway's DAV headers, the
all-in-one one stores and reads back a file, and SIGTERM ends each with
exit code 0. The tolerance is equality.
"""

import contextlib
import io
import json
import os
import pathlib
import re
import shutil
import signal
import subprocess
import sys
import tarfile
import time
import urllib.error
import urllib.request

import pytest

import seaweedfs_tpu.storage.needle as ref_needle
import seaweedfs_tpu.storage.volume as ref_volume
import seaweedfs_tpu_torch.storage.volume as port_volume
from seaweedfs_tpu.command import main as ref_main
from seaweedfs_tpu_torch.command import main as port_main
from seaweedfs_tpu_torch.util.availability import free_port

SIDES = ("ref", "port")
MAIN = {"ref": ref_main, "port": port_main}
REPO = pathlib.Path(__file__).resolve().parent.parent


def run(side, argv):
    """(rc, stdout, stderr) of one in-process CLI call."""
    out, err = io.StringIO(), io.StringIO()
    with contextlib.redirect_stdout(out), contextlib.redirect_stderr(err):
        try:
            rc = MAIN[side](argv)
        except SystemExit as e:  # argparse's -h
            rc = e.code
    return rc, out.getvalue(), err.getvalue()


@pytest.fixture
def pinned_clock(monkeypatch):
    for mod in (ref_volume, port_volume):
        counter = iter(range(1_700_000_000_000_000_000, 1_800_000_000_000_000_000, 1000))
        monkeypatch.setattr(mod.Volume, "_now_ns", lambda self, c=counter: next(c))


def _make_volume(directory, vid=7):
    vol = ref_volume.Volume(directory, vid)
    for i in range(1, 21):
        n = ref_needle.Needle(cookie=0x1234, id=i, data=f"needle-{i}".encode() * 10)
        n.name = f"file{i}.txt".encode()
        n.set_has_name()
        if i % 3 == 0:
            n.mime = b"text/plain"
            n.set_has_mime()
        vol.write_needle(n)
    for i in (3, 7):
        vol.delete_needle(ref_needle.Needle(cookie=0x1234, id=i))
    vol.close()
    return vid


@pytest.fixture
def volumes(tmp_path, pinned_clock):
    """One volume written by the reference, copied per side."""
    src = tmp_path / "src"
    src.mkdir()
    vid = _make_volume(str(src))
    dirs = {}
    for side in SIDES:
        dirs[side] = tmp_path / side
        shutil.copytree(src, dirs[side])
    return vid, dirs


def _files(d):
    return {p.name: p.read_bytes() for p in sorted(pathlib.Path(d).iterdir()) if p.is_file()}


class TestOfflineTools:
    def test_version(self):
        rc, out, _ = run("port", ["version"])
        assert rc == 0 and out.startswith("seaweedfs_tpu_torch ")

    @pytest.mark.parametrize("config", ["security", "filer", "notification",
                                        "replication", "master"])
    def test_scaffold_equal(self, config, tmp_path):
        got = {side: run(side, ["scaffold", "-config", config]) for side in SIDES}
        assert got["ref"] == got["port"] and got["port"][0] == 0
        for side in SIDES:
            (tmp_path / side).mkdir()
            assert run(side, ["scaffold", "-config", config, "-output",
                              str(tmp_path / side)])[0] == 0
        assert _files(tmp_path / "ref") == _files(tmp_path / "port")

    def test_scaffold_unknown(self):
        assert run("port", ["scaffold", "-config", "nope"])[0] == 1

    def test_fix_rebuilds_idx(self, volumes):
        vid, dirs = volumes
        original = (dirs["ref"] / f"{vid}.idx").read_bytes()
        got = {}
        for side in SIDES:
            (dirs[side] / f"{vid}.idx").unlink()
            rc, out, _ = run(side, ["fix", "-dir", str(dirs[side]), "-volumeId", str(vid)])
            assert rc == 0
            got[side] = ((dirs[side] / f"{vid}.idx").read_bytes(),
                         out.replace(str(dirs[side]), "D"))
        assert got["ref"] == got["port"]
        assert len(got["port"][0]) == 18 * 16 and len(original) > 0
        vol = port_volume.Volume(str(dirs["port"]), vid)
        assert vol.read_needle(5).data == b"needle-5" * 10
        assert not vol.has_needle(3)
        vol.close()

    def test_compact(self, volumes):
        vid, dirs = volumes
        before = (dirs["ref"] / f"{vid}.dat").stat().st_size
        outs = {}
        for side in SIDES:
            rc, outs[side], _ = run(side, ["compact", "-dir", str(dirs[side]),
                                           "-volumeId", str(vid)])
            assert rc == 0
        assert outs["ref"] == outs["port"]
        assert _files(dirs["ref"]) == _files(dirs["port"])
        assert (dirs["port"] / f"{vid}.dat").stat().st_size < before
        vol = port_volume.Volume(str(dirs["port"]), vid)
        assert vol.read_needle(5).data == b"needle-5" * 10 and not vol.has_needle(3)
        vol.close()

    def test_export_lists_and_extracts(self, volumes):
        vid, dirs = volumes
        got = {}
        for side in SIDES:
            listing = run(side, ["export", "-dir", str(dirs[side]), "-volumeId", str(vid)])
            out_dir = dirs[side] / "exported"
            out_dir.mkdir()
            extract = run(side, ["export", "-dir", str(dirs[side]), "-volumeId", str(vid),
                                 "-o", str(out_dir)])
            got[side] = (listing, extract, _files(out_dir))
        assert got["ref"] == got["port"]
        assert "file5.txt" in got["port"][0][1] and len(got["port"][2]) == 18
        assert "file3.txt" not in got["port"][2]

    @pytest.mark.parametrize("fmt", [None, "{{.Id}}-{{.Name}}", "{{.Key}}/{{.Mime}}"])
    def test_export_to_tar(self, volumes, fmt):
        vid, dirs = volumes
        tars = {}
        for side in SIDES:
            tar_path = dirs[side] / "vol.tar"
            argv = ["export", "-dir", str(dirs[side]), "-volumeId", str(vid),
                    "-o", str(tar_path)]
            if fmt:
                argv += ["-fileNameFormat", fmt]
            rc, out, err = run(side, argv)
            assert rc == 0
            tars[side] = (tar_path.read_bytes(), out, err)
        assert tars["ref"] == tars["port"]
        with tarfile.open(dirs["port"] / "vol.tar") as t:
            assert len(t.getnames()) == 18

    def test_export_newer_filter(self, tmp_path, pinned_clock):
        now = int(time.time())
        src = tmp_path / "src"
        src.mkdir()
        vol = ref_volume.Volume(str(src), 42)
        for i in range(4):
            n = ref_needle.Needle(cookie=1, id=i + 1, data=b"ts")
            n.last_modified = now if i < 3 else now - 10 * 24 * 3600
            n.set_has_last_modified_date()
            vol.write_needle(n)
        vol.close()
        import datetime as _dt

        cutoff = _dt.datetime.fromtimestamp(now - 3600, _dt.timezone.utc).strftime(
            "%Y-%m-%dT%H:%M:%S")
        got = {}
        for side in SIDES:
            d = tmp_path / side
            shutil.copytree(src, d)
            got[side] = [run(side, ["export", "-dir", str(d), "-volumeId", "42",
                                    "-newer", newer])
                         for newer in ("2099-01-01T00:00:00", cutoff,
                                       "2020-01-01T00:00:00+02:00", "garbage")]
        assert got["ref"] == got["port"]
        assert "0 needles" in got["port"][0][2] and "3 needles" in got["port"][1][2]
        assert got["port"][2][0] == 2 and got["port"][3][0] == 2


def _commands(help_text):
    m = re.search(r"\{([a-z.,0-9]+)\}", help_text)
    return m.group(1).split(",")


def test_help_lists_the_references_commands():
    rc, out, _ = run("port", ["help"])
    assert rc == 0
    ref_rc, ref_out, _ = run("ref", ["-h"])
    assert ref_rc == 0
    assert _commands(out) == _commands(ref_out)
    assert run("port", [])[0] == run("ref", [])[0] == 2
    for name in _commands(out):
        assert f"    {name}" in out


@pytest.mark.parametrize("argv,item", [
    (["mount"], "11d"),
])
def test_unported_planes_exit_2_naming_their_item(argv, item):
    rc, _out, err = run("port", argv)
    assert rc == 2
    assert f"ROADMAP item {item})" in err


def test_filer_replicate_drains_a_logqueue_and_resumes_after_sigterm(tmp_path):
    """`filer.replicate -config` as a process of its own, with
    notification.toml (a logqueue) in its working directory and a local
    sink: it replicates what a port filer published, SIGTERM ends it with
    exit code 0, and restarted it resumes from the committed cursor: only
    the file written meanwhile is applied, the others are not written
    again."""
    from seaweedfs_tpu_torch import notification
    from seaweedfs_tpu_torch.notification.logqueue import PartitionedLogQueue
    from tests.test_torch_replication import PortCluster, post, wait_for

    qdir, mirror = tmp_path / "lq", tmp_path / "mirror"
    (tmp_path / "notification.toml").write_text(
        f'[notification.logqueue]\nenabled = true\ndir = "{qdir}"\npartitions = 4\n')
    lq = PartitionedLogQueue(str(qdir), partitions=4)
    notification.queue = lq
    cluster, proc = None, None
    try:
        cluster = PortCluster(str(tmp_path / "src"))
        (tmp_path / "replication.toml").write_text(
            f'[source.filer]\nenabled = true\ngrpcAddress = "{cluster.filer_addr}"\n'
            f'directory = "/buckets"\n[sink.local]\nenabled = true\n'
            f'directory = "{mirror}"\n')
        files = {f"/d{i % 3}/f{i}.bin": os.urandom(1000 + 997 * i) for i in range(6)}
        for path, data in files.items():
            post(cluster.filer_addr, "/buckets" + path, data)

        def spawn():
            return subprocess.Popen(
                [sys.executable, "-m", "seaweedfs_tpu_torch", "filer.replicate", "-config",
                 str(tmp_path / "replication.toml")], cwd=str(tmp_path),
                env=dict(os.environ, PYTHONPATH=str(REPO)), stdout=subprocess.PIPE,
                stderr=subprocess.STDOUT)

        def mirrored() -> bool:
            assert proc.poll() is None, proc.stdout.read().decode()[-3000:]
            return lq.depth("replicate") == 0 and all(
                (mirror / p.lstrip("/")).is_file()
                and (mirror / p.lstrip("/")).read_bytes() == d for p, d in files.items())

        proc = spawn()
        assert wait_for(mirrored, 60), sorted(str(p) for p in mirror.rglob("*"))
        stamps = {p: os.stat(mirror / p.lstrip("/")).st_ino for p in files}
        proc.send_signal(signal.SIGTERM)
        assert proc.wait(30) == 0
        files["/late.bin"] = b"written while the runner was down"
        post(cluster.filer_addr, "/buckets/late.bin", files["/late.bin"])
        assert lq.depth("replicate") >= 1
        proc = spawn()
        assert wait_for(mirrored, 60), sorted(str(p) for p in mirror.rglob("*"))
        assert {p: os.stat(mirror / p.lstrip("/")).st_ino for p in stamps} == stamps
        proc.send_signal(signal.SIGTERM)
        assert proc.wait(30) == 0
    finally:
        notification.queue = None
        if proc is not None and proc.poll() is None:
            proc.kill()
            proc.wait(10)
        if cluster is not None:
            cluster.stop()
        lq.close()


def _report_keys(report: dict) -> dict:
    return {k: sorted(v) if isinstance(v, dict) else None for k, v in report.items()}


@pytest.mark.parametrize("argv", [["weedload"], ["master", "-telemetryInterval", "10"]],
                         ids=["weedload", "master-telemetry"])
def test_telemetry_plane_commands_run_as_the_references(argv, tmp_path):
    """The telemetry plane's commands (ROADMAP item 13) run as the
    reference's: `weedload` against each package's in-process cluster
    exits 0 and prints a report with the reference's keys, its PUTs and
    GETs all answered; `master -telemetryInterval 10` comes up with its
    collector on, /cluster/alerts answering without "Disabled", and
    SIGTERM ends it with exit code 0."""
    if argv[0] == "weedload":
        import seaweedfs_tpu.util.availability as ref_availability
        import seaweedfs_tpu_torch.util.availability as port_availability

        helpers = {"ref": ref_availability, "port": port_availability}
        reports = {}
        for side in SIDES:
            kw = dict(ec_codec="cpu") if side == "ref" else dict(ec_codec="cuda", device="cpu")
            (tmp_path / side).mkdir()
            master, servers = helpers[side].start_cluster([str(tmp_path / side)],
                                                          scrub_interval=0, **kw)
            try:
                rc, out, err = run(side, argv + [
                    "-master", f"127.0.0.1:{master.port}", "-duration", "1",
                    "-writers", "1", "-readers", "1", "-size", "256", "-seed", "4"])
            finally:
                for vs in servers:
                    vs.stop()
                master.stop()
            assert rc == 0, err[-2000:]
            reports[side] = json.loads(out)
        assert _report_keys(reports["port"]) == _report_keys(reports["ref"])
        for mode in ("put", "get"):
            row = reports["port"][mode]
            assert row["ops"] > 0 and row["errors"] == 0, reports["port"]
        assert reports["port"]["config"]["processes"] == 2
        return
    mport = free_port()
    proc = spawn_cli(*argv, "-port", str(mport), stdout=subprocess.PIPE)
    try:
        alerts = None
        deadline = time.time() + 30
        while time.time() < deadline:
            try:
                alerts = http_json(f"http://127.0.0.1:{mport}/cluster/alerts")
                break
            except OSError:
                time.sleep(0.2)
        assert alerts is not None and "Disabled" not in alerts, alerts
        assert sorted(alerts) == ["Firing", "History", "Pending"]
        health = http_json(f"http://127.0.0.1:{mport}/cluster/health")
        assert health["IntervalSeconds"] == 10.0 and "Disabled" not in health

        def handles_sigterm() -> bool:  # installed after start(); SigCgt in /proc
            with open(f"/proc/{proc.pid}/status") as f:
                mask = next(line for line in f if line.startswith("SigCgt:")).split()[1]
            return bool(int(mask, 16) & (1 << (signal.SIGTERM - 1)))

        wait_until(handles_sigterm, "the master's SIGTERM handler")
    finally:
        proc.send_signal(signal.SIGTERM)
        try:
            out, _ = proc.communicate(timeout=20)
        except subprocess.TimeoutExpired:
            proc.kill()
            raise
    assert proc.returncode == 0, out[-2000:]


def test_flag_sets_equal_the_references():
    """Every subcommand takes the reference's flags with the reference's
    defaults; only -ec.codec's choices and help name the port's codecs."""
    import argparse

    from seaweedfs_tpu.command import COMMANDS as REF
    from seaweedfs_tpu_torch.command import COMMANDS as PORT

    assert sorted(REF) == sorted(PORT)
    for name in REF:
        flags = {}
        for side, cmds in (("ref", REF), ("port", PORT)):
            p = argparse.ArgumentParser()
            cmds[name].add_arguments(p)
            flags[side] = {a.dest: (tuple(a.option_strings), a.default, a.required)
                           for a in p._actions}
            if name in ("volume", "server"):
                (a,) = [a for a in p._actions if a.dest == "ec_codec"]
                assert a.choices == (("", "cpu", "native", "tpu") if side == "ref"
                                     else ("", "cpu", "native", "cuda"))
        assert flags["ref"] == flags["port"], name
        assert REF[name].help == PORT[name].help, name


# ---------------------------------------------------------------------------
@pytest.fixture(scope="module", params=SIDES)
def mini_cluster(request, tmp_path_factory):
    from seaweedfs_tpu.server.master_server import MasterServer as RefMaster
    from seaweedfs_tpu.server.volume_server import VolumeServer as RefVolume
    from seaweedfs_tpu_torch.server.master_server import MasterServer as PortMaster
    from seaweedfs_tpu_torch.server.volume_server import VolumeServer as PortVolume

    side = request.param
    Master, Volume = (RefMaster, RefVolume) if side == "ref" else (PortMaster, PortVolume)
    codec = dict(ec_codec="cpu") if side == "ref" else dict(ec_codec="cuda", device="cpu")
    mport = free_port()
    master = Master(port=mport, volume_size_limit_mb=64)
    master.start()
    vs = Volume([str(tmp_path_factory.mktemp(f"{side}-clivol"))], port=free_port(),
                master=f"127.0.0.1:{mport}", heartbeat_interval=0.2,
                max_volume_counts=[50], scrub_interval=0, **codec)
    vs.start()
    deadline = time.time() + 10
    while time.time() < deadline and not master.topology.data_nodes():
        time.sleep(0.05)
    yield side, f"127.0.0.1:{mport}"
    vs.stop()
    master.stop()


def _needle_payload(n) -> bytes:
    import gzip

    data = bytes(n.data)
    return gzip.decompress(data) if n.is_gzipped() else data


class TestClusterTools:
    def test_upload_download(self, mini_cluster, tmp_path):
        side, master = mini_cluster
        src = tmp_path / "hello.txt"
        src.write_bytes(b"cli upload payload")
        rc, out, _ = run(side, ["upload", str(src), "-master", master])
        assert rc == 0
        result = json.loads(out)
        assert result[0]["error"] == "" and result[0]["file_name"] == "hello.txt"
        out_dir = tmp_path / "dl"
        out_dir.mkdir()
        rc, out, _ = run(side, ["download", result[0]["fid"], "-server", master,
                                "-dir", str(out_dir)])
        assert rc == 0 and f"({len(b'cli upload payload')} bytes)" in out
        files = list(out_dir.iterdir())
        assert len(files) == 1 and files[0].read_bytes() == b"cli upload payload"

    def test_upload_dir_include(self, mini_cluster, tmp_path):
        side, master = mini_cluster
        (tmp_path / "tree" / "sub").mkdir(parents=True)
        for name, body in (("a.pdf", b"A"), ("b.txt", b"B"), ("sub/c.pdf", b"C")):
            (tmp_path / "tree" / name).write_bytes(body * 100)
        rc, out, _ = run(side, ["upload", "-dir", str(tmp_path / "tree"), "-include",
                                "*.pdf", "-master", master])
        assert rc == 0
        assert [r["file_name"] for r in json.loads(out)] == ["a.pdf", "c.pdf"]
        assert run(side, ["upload"])[0] == 2

    def test_benchmark_small(self, mini_cluster):
        side, master = mini_cluster
        if side == "ref":
            from seaweedfs_tpu.command.benchmark import run_benchmark
        else:
            from seaweedfs_tpu_torch.command.benchmark import run_benchmark
        results, fids = run_benchmark(master, concurrency=4, num=40, size=512)
        assert len(fids) == 40
        titles = [t for t, _ in results]
        assert titles == ["Writing Benchmark (40 x 512B)", "Random Read Benchmark (40 reads)"]
        for _, stats in results:
            assert stats.failed == 0 and stats.completed == 40
            report = stats.report("x", 4)
            assert "Requests per second" in report and "99%" in report

    def test_benchmark_command(self, mini_cluster):
        side, master = mini_cluster
        rc, out, _ = run(side, ["benchmark", "-master", master, "-c", "2", "-n", "12",
                                "-size", "100", "-collection", "cli", "-read=false"])
        assert rc == 0
        assert "Writing Benchmark (12 x 100B)" in out and "Complete requests:      12" in out
        assert "Random Read" not in out

    def test_shell_script(self, mini_cluster):
        side, master = mini_cluster
        rc, out, _ = run(side, ["shell", "-master", master, "-c",
                                "volume.list; collection.list"])
        assert rc == 0
        assert "DataCenter" in out or "volume" in out.lower()

    def test_incremental_backup_roundtrip(self, mini_cluster, tmp_path):
        side, master = mini_cluster
        from seaweedfs_tpu_torch.client import operation as op
        from seaweedfs_tpu_torch.storage.file_id import FileId

        ar = op.assign(master, collection="bak")
        payload1 = b"first backup payload " * 40
        assert not op.upload(f"{ar.url}/{ar.fid}", payload1, jwt=ar.auth).error
        vid = int(ar.fid.split(",")[0])
        argv = ["backup", "-master", master, "-volumeId", str(vid), "-collection", "bak",
                "-dir", str(tmp_path)]
        assert run(side, argv)[0] == 0
        fid1 = FileId.parse(ar.fid)
        v = port_volume.Volume(str(tmp_path), vid, "bak", create=False)
        assert _needle_payload(v.read_needle(fid1.key, cookie=fid1.cookie)) == payload1
        first_size = v.data_file_size()
        v.close()
        payload2 = b"second incremental blob"
        for _ in range(300):
            ar2 = op.assign(master, collection="bak")
            if int(ar2.fid.split(",")[0]) == vid:
                break
        else:
            pytest.fail("assign never landed on the backed-up volume")
        assert not op.upload(f"{ar2.url}/{ar2.fid}", payload2, jwt=ar2.auth).error
        rc, out, _ = run(side, argv)
        assert rc == 0 and "backed up" in out
        fid2 = FileId.parse(ar2.fid)
        v = port_volume.Volume(str(tmp_path), vid, "bak", create=False)
        assert _needle_payload(v.read_needle(fid1.key, cookie=fid1.cookie)) == payload1
        assert _needle_payload(v.read_needle(fid2.key, cookie=fid2.cookie)) == payload2
        assert v.data_file_size() > first_size
        v.close()


# ---------------------------------------------------------------------------
# the port's daemons as real subprocesses


def spawn_cli(*args, env=None, stdout=subprocess.DEVNULL):
    """A real `python -m seaweedfs_tpu_torch ...` subprocess."""
    return subprocess.Popen(
        [sys.executable, "-m", "seaweedfs_tpu_torch", *args],
        env=dict(os.environ, WEED_EC_CODEC="cpu") if env is None else env,
        cwd=str(REPO), stdout=stdout, stderr=subprocess.STDOUT)


def wait_until(pred, what, deadline_s=40):
    t0 = time.time()
    while time.time() - t0 < deadline_s:
        try:
            if pred():
                return time.time() - t0
        except Exception:
            pass
        time.sleep(0.2)
    raise RuntimeError(f"timed out waiting for {what}")


def reap(procs):
    for p in procs:
        with contextlib.suppress(OSError):
            p.send_signal(signal.SIGCONT)
        with contextlib.suppress(OSError, subprocess.TimeoutExpired):
            p.kill()
            p.wait(timeout=10)


def http(url, data=None, method="GET", timeout=5):
    req = urllib.request.Request(url, data=data, method=method)
    with urllib.request.urlopen(req, timeout=timeout) as r:
        return r.read()


def http_json(url, timeout=2):
    return json.loads(http(url, timeout=timeout))


class TestServerDaemon:
    def test_all_in_one_smoke(self, tmp_path):
        """The all-in-one `server` as a subprocess: assign, POST, GET,
        then SIGTERM ends it with exit code 0."""
        mport, vport = free_port(), free_port()
        proc = spawn_cli("server", "-dir", str(tmp_path), "-master.port", str(mport),
                         "-volume.port", str(vport), "-ec.codec", "cpu",
                         stdout=subprocess.PIPE)
        try:
            assign = None
            deadline = time.time() + 30
            while time.time() < deadline:
                try:
                    assign = http_json(f"http://127.0.0.1:{mport}/dir/assign")
                    if "fid" in assign:
                        break
                except OSError:
                    time.sleep(0.2)
            assert assign and "fid" in assign, f"daemon never served: {assign}"
            blob = b"all-in-one daemon smoke"
            http(f"http://{assign['url']}/{assign['fid']}", data=blob, method="POST")
            assert http(f"http://{assign['url']}/{assign['fid']}") == blob
            st = http_json(f"http://127.0.0.1:{vport}/status")
            assert st["Scrub"]["Interval"] == 600.0  # the reference's default
            assert http_json(f"http://127.0.0.1:{mport}/repair/queue")["Config"][
                "Interval"] == 30.0
        finally:
            proc.send_signal(signal.SIGTERM)
            try:
                out, _ = proc.communicate(timeout=20)
            except subprocess.TimeoutExpired:
                proc.kill()
                raise
        assert proc.returncode == 0, out[-2000:]

    def test_volume_without_card_or_codec_names_cuda(self, tmp_path):
        env = {k: v for k, v in os.environ.items() if k != "WEED_EC_CODEC"}
        proc = spawn_cli("volume", "-port", str(free_port()), "-dir", str(tmp_path),
                         "-mserver", f"127.0.0.1:{free_port()}", env=env,
                         stdout=subprocess.PIPE)
        out, _ = proc.communicate(timeout=60)
        assert proc.returncode != 0
        assert b"CUDA" in out


class TestCrashRecovery:
    """SIGKILL a volume-server subprocess and restart it on the same
    directory: every acknowledged write survives and the node rejoins."""

    def test_sigkill_volume_server_and_restart(self, tmp_path):
        def assign():
            a = http_json(f"http://127.0.0.1:{mport}/dir/assign", timeout=5)
            return None if a.get("error") else a

        mport, vport = free_port(), free_port()
        vol_dir = tmp_path / "vol"
        vol_dir.mkdir()
        procs = [spawn_cli("master", "-port", str(mport))]
        try:
            wait_until(lambda: http(f"http://127.0.0.1:{mport}/cluster/status"), "master")
            volume = spawn_cli("volume", "-port", str(vport), "-dir", str(vol_dir),
                               "-mserver", f"127.0.0.1:{mport}", "-ec.codec", "cpu")
            procs.append(volume)
            wait_until(assign, "cluster writable")
            blobs = {}
            for i in range(20):
                wait_until(assign, "assign")
                a = assign()
                payload = f"crash-survivor-{i:03d}".encode() * 10
                http(f"http://{a['url']}/{a['fid']}", data=payload, method="POST")
                blobs[a["fid"]] = payload
            known_fid = next(iter(blobs))
            volume.send_signal(signal.SIGKILL)
            volume.wait(timeout=10)
            procs.append(spawn_cli("volume", "-port", str(vport), "-dir", str(vol_dir),
                                   "-mserver", f"127.0.0.1:{mport}", "-ec.codec", "cpu"))
            wait_until(lambda: http(f"http://127.0.0.1:{vport}/{known_fid}"),
                       "restarted volume serving reads")
            for fid, payload in blobs.items():
                assert http(f"http://127.0.0.1:{vport}/{fid}") == payload, fid
            wait_until(assign, "post-restart assign")
            a = assign()
            http(f"http://{a['url']}/{a['fid']}", data=b"post-crash", method="POST")
            assert http(f"http://127.0.0.1:{vport}/{a['fid']}") == b"post-crash"
        finally:
            reap(procs)


class TestLivenessSweep:
    """SIGSTOP a volume-server subprocess: the master sweeps it and drops
    its locations; SIGCONT: it re-registers within a few beats."""

    def test_sigstop_sweep_sigcont_recover(self, tmp_path):
        mport, vport = free_port(), free_port()
        vol_dir = tmp_path / "vol"
        vol_dir.mkdir()
        procs = [spawn_cli("master", "-port", str(mport), "-nodeTimeout", "3")]
        try:
            wait_until(lambda: http_json(f"http://127.0.0.1:{mport}/cluster/status"),
                       "master")
            volume = spawn_cli("volume", "-port", str(vport), "-dir", str(vol_dir),
                               "-mserver", f"127.0.0.1:{mport}", "-ec.codec", "cpu")
            procs.append(volume)

            def assign():
                a = http_json(f"http://127.0.0.1:{mport}/dir/assign")
                return None if a.get("error") else a

            wait_until(assign, "writable")
            a = assign()
            vid = a["fid"].split(",")[0]
            http(f"http://{a['url']}/{a['fid']}", data=b"sweep-me", method="POST")

            def located():
                try:
                    out = http_json(f"http://127.0.0.1:{mport}/dir/lookup?volumeId={vid}")
                except urllib.error.HTTPError:
                    return False
                return bool(out.get("locations"))

            assert located()
            volume.send_signal(signal.SIGSTOP)
            wait_until(lambda: not located(), "volume swept", 30)
            volume.send_signal(signal.SIGCONT)
            dt = wait_until(located, "volume re-announced", 30)
            assert dt < 15, "re-announcement took a full-cycle wait"
            assert http(f"http://127.0.0.1:{vport}/{a['fid']}") == b"sweep-me"
        finally:
            reap(procs)


# ---------------------------------------------------------------------------
# the filer plane's commands


def _local_tree(root, seed=6):
    """Nested local files drawn with numpy: {relative path: bytes}."""
    import numpy as np

    rng = np.random.default_rng(seed)
    files = {}
    for i in range(9):
        rel = os.path.join(f"d{i % 3}", f"s{i % 2}", f"f{i}.bin")
        data = rng.bytes(int(rng.integers(1, 40_000)))
        path = root / "tree" / rel
        path.parent.mkdir(parents=True, exist_ok=True)
        path.write_bytes(data)
        files[rel] = data
    return files


def _handles_sigterm(pid) -> bool:
    """Whether `pid` has installed its SIGTERM handler (SigCgt in /proc)."""
    with open(f"/proc/{pid}/status") as f:
        mask = next(line for line in f if line.startswith("SigCgt:")).split()[1]
    return bool(int(mask, 16) & (1 << (signal.SIGTERM - 1)))


def _sigterm(proc):
    # a daemon serves a moment before its SIGTERM handler is in place (the
    # handler comes once start() returns); signalled in between, it would
    # die of the default action, so the signal waits for the handler
    with contextlib.suppress(RuntimeError):
        wait_until(lambda: proc.poll() is not None or _handles_sigterm(proc.pid),
                   "the daemon's SIGTERM handler")
    proc.send_signal(signal.SIGTERM)
    try:
        out, _ = proc.communicate(timeout=30)
    except subprocess.TimeoutExpired:
        proc.kill()
        raise
    return proc.returncode, out


class TestFilerPlane:
    def test_filer_daemon_filled_by_filer_copy_and_restarted(self, tmp_path):
        """`filer -store lsm` as a subprocess over an in-process port
        cluster; `filer.copy` of a local tree reports what the
        reference's reports against the reference's filer and every file
        reads back; a restart on the same -storePath lists the same
        namespace; SIGTERM ends the filer with exit code 0."""
        import seaweedfs_tpu.util.availability as ref_availability
        import seaweedfs_tpu.server.filer_server as ref_filer_server
        import seaweedfs_tpu_torch.util.availability as port_availability

        files = _local_tree(tmp_path)
        reports = {}
        (tmp_path / "ref").mkdir()
        master, servers = ref_availability.start_cluster([str(tmp_path / "ref")],
                                                         scrub_interval=0, ec_codec="cpu")
        filer = ref_filer_server.FilerServer([f"127.0.0.1:{master.port}"], port=free_port(),
                                             store="memory")
        filer.start()
        try:
            reports["ref"] = run("ref", ["filer.copy", str(tmp_path / "tree"),
                                         f"http://127.0.0.1:{filer.port}/in/"])
        finally:
            filer.stop()
            for vs in servers:
                vs.stop()
            master.stop()
        (tmp_path / "port").mkdir()
        master, servers = port_availability.start_cluster(
            [str(tmp_path / "port")], scrub_interval=0, ec_codec="cuda", device="cpu")
        fport = free_port()
        argv = ("filer", "-port", str(fport), "-master", f"127.0.0.1:{master.port}",
                "-store", "lsm", "-storePath", str(tmp_path / "lsm"))
        procs = []
        try:
            procs.append(spawn_cli(*argv, stdout=subprocess.PIPE))
            wait_until(lambda: http(f"http://127.0.0.1:{fport}/") is not None, "the filer")
            reports["port"] = run("port", ["filer.copy", str(tmp_path / "tree"),
                                           f"http://127.0.0.1:{fport}/in/"])
            for rel, data in files.items():
                assert http(f"http://127.0.0.1:{fport}/in/tree/{rel}") == data
            listing = http(f"http://127.0.0.1:{fport}/in/tree/d0/s0")
            rc, out = _sigterm(procs.pop())
            assert rc == 0, out[-2000:]
            procs.append(spawn_cli(*argv, stdout=subprocess.PIPE))
            wait_until(lambda: http(f"http://127.0.0.1:{fport}/") is not None, "the filer")
            assert http(f"http://127.0.0.1:{fport}/in/tree/d0/s0") == listing
            rc, out = _sigterm(procs.pop())
            assert rc == 0, out[-2000:]
        finally:
            reap(procs)
            for vs in servers:
                vs.stop()
            master.stop()
        assert reports["port"] == reports["ref"] == (0, f"copied {len(files)} files\n", "")

    def test_all_in_one_server_with_filer(self, tmp_path):
        """`server -filer` as a subprocess: a file POSTed through its
        filer reads back, and SIGTERM ends it with exit code 0."""
        mport, vport, fport = free_port(), free_port(), free_port()
        proc = spawn_cli("server", "-dir", str(tmp_path), "-master.port", str(mport),
                         "-volume.port", str(vport), "-filer", "-filer.port", str(fport),
                         "-ec.codec", "cpu", stdout=subprocess.PIPE)
        try:
            blob = b"all-in-one filer smoke " * 100
            wait_until(lambda: http(f"http://127.0.0.1:{fport}/a/b.txt", data=blob,
                                    method="POST") is not None, "a filer POST", 60)
            assert http(f"http://127.0.0.1:{fport}/a/b.txt") == blob
            names = [e["FullPath"] for e in http_json(f"http://127.0.0.1:{fport}/a")["Entries"]]
            assert names == ["/a/b.txt"]
        finally:
            rc, out = _sigterm(proc)
        assert rc == 0, out[-2000:]



# --- the S3 gateway's commands -----------------------------------------------------

S3_ACCESS, S3_SECRET = "AKIDCLI", "cli-secret"


def _listeners(port):
    """TCP sockets listening on `port` (each SO_REUSEPORT sibling one)."""
    with open("/proc/net/tcp") as f:
        rows = [line.split() for line in f.readlines()[1:]]
    return sum(1 for r in rows if r[3] == "0A" and int(r[1].rsplit(":", 1)[1], 16) == port)


def _s3_call(port, method, path, identity=True):
    """(status, body with creation dates masked) of one request to the
    gateway at `port`, SigV4-signed just before it is sent."""
    from seaweedfs_tpu_torch.s3api.auth import sign_request_v4

    headers = {"Host": f"127.0.0.1:{port}"}
    if identity:
        headers.update(sign_request_v4(method, path, {}, headers, b"", S3_ACCESS, S3_SECRET))
    req = urllib.request.Request(f"http://127.0.0.1:{port}{path}", method=method,
                                 headers=headers, data=b"" if method == "PUT" else None)
    try:
        with urllib.request.urlopen(req, timeout=30) as r:
            status, body = r.status, r.read()
    except urllib.error.HTTPError as e:
        status, body = e.code, e.read()
    return status, re.sub(rb"<CreationDate>[^<]*<", b"<CreationDate>T<", body)


def _s3_calls(port, buckets=("alpha", "beta")):
    """The buckets made, then ListBuckets; an unsigned ListBuckets."""
    out = [_s3_call(port, "PUT", f"/{b}") for b in buckets]
    out.append(_s3_call(port, "GET", "/"))
    out.append(_s3_call(port, "GET", "/", identity=False)[0])
    return out


@contextlib.contextmanager
def _ref_s3(root, secured):
    """The reference's master, volume server, filer and S3 gateway (with
    the one identity when `secured`) in this process; yields its port."""
    import seaweedfs_tpu.server.filer_server as ref_filer_server
    import seaweedfs_tpu.util.availability as ref_availability
    from seaweedfs_tpu.s3api import S3ApiServer
    from seaweedfs_tpu.s3api.auth import Identity, IdentityAccessManagement

    root.mkdir()
    master, servers = ref_availability.start_cluster([str(root)], scrub_interval=0,
                                                     ec_codec="cpu")
    filer = ref_filer_server.FilerServer([f"127.0.0.1:{master.port}"], port=free_port(),
                                         store="memory")
    iam = IdentityAccessManagement([Identity("cli", S3_ACCESS, S3_SECRET)]) if secured else None
    gw = S3ApiServer(filer=f"127.0.0.1:{filer.port}", port=free_port(), iam=iam)
    filer.start()
    try:
        gw.start()
        yield gw.port
    finally:
        gw.stop()
        filer.stop()
        for vs in servers:
            vs.stop()
        master.stop()


class TestS3Plane:
    def test_s3_daemon_with_identities(self, tmp_path):
        """`s3 -filer F -config identities.toml -master M` as a subprocess
        in front of an in-process port filer: a signed ListBuckets equals
        the reference gateway's over the same buckets, an unsigned request
        is refused as the reference's refuses it, the gateway announces
        itself to the master, and SIGTERM ends it with exit code 0."""
        import seaweedfs_tpu_torch.util.availability as port_availability
        from seaweedfs_tpu_torch.server.filer_server import FilerServer

        with _ref_s3(tmp_path / "ref", secured=True) as ref_port:
            want = _s3_calls(ref_port)
        (tmp_path / "port").mkdir()
        master, servers = port_availability.start_cluster(
            [str(tmp_path / "port")], scrub_interval=0, ec_codec="cuda", device="cpu")
        filer = FilerServer([f"127.0.0.1:{master.port}"], port=free_port(), store="memory")
        filer.start()
        config = tmp_path / "identities.toml"
        config.write_text(f'[[identities]]\nname = "cli"\naccess_key = "{S3_ACCESS}"\n'
                          f'secret_key = "{S3_SECRET}"\nactions = ["Admin"]\n')
        port = free_port()
        proc = spawn_cli("s3", "-port", str(port), "-filer", f"127.0.0.1:{filer.port}",
                         "-config", str(config), "-master", f"127.0.0.1:{master.port}",
                         stdout=subprocess.PIPE)
        try:
            wait_until(lambda: _s3_call(port, "GET", "/")[0] == 200, "the s3 gateway", 60)
            got = _s3_calls(port)
            wait_until(lambda: master._gateways[f"127.0.0.1:{port}"]["kind"] == "s3",
                       "the gateway's announcement to the master")
        finally:
            rc, out = _sigterm(proc)
            filer.stop()
            for vs in servers:
                vs.stop()
            master.stop()
        assert rc == 0, out[-2000:]
        assert got == want
        assert [g[0] for g in got[:3]] == [200, 200, 200] and got[3] == 403
        assert b"<Name>alpha</Name>" in got[2][1] and b"<Name>beta</Name>" in got[2][1]

    def test_all_in_one_server_with_s3(self, tmp_path):
        """`server -filer -s3` as a subprocess: its open gateway answers a
        signed ListBuckets equal to the reference's open gateway's, an
        object PUT through it reads back, and SIGTERM ends it with 0."""
        with _ref_s3(tmp_path / "ref", secured=False) as ref_port:
            want = _s3_calls(ref_port)
        mport, vport, fport, sport = free_port(), free_port(), free_port(), free_port()
        (tmp_path / "port").mkdir()
        proc = spawn_cli("server", "-dir", str(tmp_path / "port"), "-master.port", str(mport),
                         "-volume.port", str(vport), "-filer", "-filer.port", str(fport),
                         "-s3", "-s3.port", str(sport), "-ec.codec", "cpu",
                         stdout=subprocess.PIPE)
        try:
            wait_until(lambda: _s3_call(sport, "GET", "/")[0] == 200, "the s3 gateway", 60)
            got = _s3_calls(sport)
            blob = b"all-in-one s3 smoke " * 100
            wait_until(lambda: http(f"http://127.0.0.1:{sport}/alpha/o.txt", data=blob,
                                    method="PUT") is not None, "an object PUT", 60)
            back = http(f"http://127.0.0.1:{sport}/alpha/o.txt")
        finally:
            rc, out = _sigterm(proc)
        assert rc == 0, out[-2000:]
        assert got == want and got[3] == 200
        assert back == blob

    def test_serve_procs_share_one_port(self, tmp_path):
        """`s3 -serveProcs 2`: the lead spawns one sibling that binds the
        same port with SO_REUSEPORT, both answer, and SIGTERM to the lead
        ends the sibling too, the lead's exit code 0."""
        port = free_port()
        proc = spawn_cli("s3", "-port", str(port), "-filer", f"127.0.0.1:{free_port()}",
                         "-serveProcs", "2", stdout=subprocess.PIPE)
        def siblings() -> list:
            out = []
            for name in os.listdir("/proc"):
                with contextlib.suppress(OSError):
                    if name.isdigit() and int(pathlib.Path(f"/proc/{name}/stat").read_text()
                                              .rsplit(")", 1)[1].split()[1]) == proc.pid:
                        out.append(int(name))
            return out

        try:
            wait_until(lambda: _listeners(port) == 2, "two listeners on the port", 60)
            wait_until(lambda: len(siblings()) == 1 and all(
                map(_handles_sigterm, [proc.pid] + siblings())), "both SIGTERM handlers")
            # a too-short bucket name is refused before any filer access
            assert {_s3_call(port, "PUT", "/x", identity=False)[0] for _ in range(8)} == {400}
        finally:
            rc, out = _sigterm(proc)
        assert rc == 0, out[-2000:]
        assert _listeners(port) == 0


# --- the WebDAV gateway's commands -------------------------------------------------

DAV_HEADERS = ("DAV", "MS-Author-Via", "Allow")


def _dav_call(port, method, path, body=None):
    """(status, the DAV headers, body) of one request to the gateway."""
    import http.client

    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=15)
    try:
        conn.request(method, path, body=body)
        r = conn.getresponse()
        return r.status, {k: r.getheader(k) for k in DAV_HEADERS if r.getheader(k)}, r.read()
    finally:
        conn.close()


@pytest.mark.parametrize("argv", [["webdav"], ["server", "-webdav"]],
                         ids=["webdav", "server-webdav"])
def test_webdav_commands_answer_options_and_end_on_sigterm(argv, tmp_path):
    """`webdav` (in front of a filer that is not there: OPTIONS rules
    before any filer access) and the all-in-one `server -webdav` as
    subprocesses answer OPTIONS with the reference gateway's status and
    DAV headers; through the all-in-one one a file PUT reads back; SIGTERM
    ends each with exit code 0."""
    from seaweedfs_tpu.webdav.webdav_server import WebDavServer as RefWebDav

    ref = RefWebDav(filer=f"127.0.0.1:{free_port()}", port=free_port())
    ref.start()
    try:
        want = _dav_call(ref.port, "OPTIONS", "/")
    finally:
        ref.stop()
    dport = free_port()
    if argv == ["webdav"]:
        proc = spawn_cli("webdav", "-port", str(dport), "-filer", f"127.0.0.1:{free_port()}",
                         stdout=subprocess.PIPE)
    else:
        (tmp_path / "port").mkdir()
        proc = spawn_cli("server", "-dir", str(tmp_path / "port"), "-master.port",
                         str(free_port()), "-volume.port", str(free_port()), "-filer.port",
                         str(free_port()), "-webdav", "-webdav.port", str(dport),
                         "-ec.codec", "cpu", stdout=subprocess.PIPE)
    back = None
    try:
        wait_until(lambda: _dav_call(dport, "OPTIONS", "/")[0] == 200, "the webdav gateway", 60)
        got = _dav_call(dport, "OPTIONS", "/")
        if argv != ["webdav"]:
            blob = b"all-in-one webdav smoke " * 100
            wait_until(lambda: _dav_call(dport, "PUT", "/w/o.txt", blob)[0] == 201,
                       "a webdav PUT", 60)
            back = _dav_call(dport, "GET", "/w/o.txt")
    finally:
        rc, out = _sigterm(proc)
    assert rc == 0, out[-2000:]
    assert got == want and want[0] == 200 and want[1]["DAV"] == "1,2"
    if back is not None:
        assert back[0] == 200 and back[2] == blob


@pytest.mark.parametrize("wait", ["_wait_forever", "_wait_with_drain"])
def test_daemon_wait_ends_on_a_signal_another_thread_takes(wait):
    """A daemon's main thread sleeps in its wait while other threads run
    (the C serving loop's among them). When the kernel hands SIGTERM to
    one of those, only a flag reaches the main thread: the wait must wake
    on its own to run the handler. Here the main thread blocks SIGTERM so
    that a helper thread must take it; the process then ends with 0."""
    code = (
        "import signal, sys, threading, time\n"
        "from seaweedfs_tpu_torch.command import servers\n"
        "threading.Thread(target=time.sleep, args=(3600,), daemon=True).start()\n"
        "signal.pthread_sigmask(signal.SIG_BLOCK, {signal.SIGTERM})\n"
        f"out = servers.{wait}()\n"
        "print(out, flush=True)\n"
    )
    proc = subprocess.Popen([sys.executable, "-c", code], cwd=str(REPO),
                            stdout=subprocess.PIPE, stderr=subprocess.STDOUT)
    try:
        wait_until(lambda: _handles_sigterm(proc.pid), "the SIGTERM handler")
        proc.send_signal(signal.SIGTERM)
        out, _ = proc.communicate(timeout=30)
    finally:
        reap([proc])
    assert proc.returncode == 0, out[-2000:]
    assert out.strip().splitlines()[-1] == {"_wait_forever": b"0",
                                            "_wait_with_drain": b"(0, True)"}[wait]
