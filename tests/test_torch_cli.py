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
reference's, and `-telemetryInterval 0`, since the telemetry collector
waits for ROADMAP item 13: the all-in-one `server`, a SIGKILLed volume
server restarted on its directory, and the master's liveness sweep of a
SIGSTOPped volume server; each subprocess case keeps the time limits
the reference's gives it. The commands whose planes the port does not
have exit 2 naming their ROADMAP item, and a `volume` with neither a
card nor `-ec.codec` fails naming CUDA. The tolerance is equality.
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
    (["filer"], 11), (["s3"], 11), (["webdav"], 11), (["mount"], 11),
    (["filer.copy", "a", "http://127.0.0.1:1/x/"], 11), (["filer.replicate"], 12),
    (["volume.worker", "-port", "1", "-dir", ".", "-lead", "x"], 8),
    (["weedload"], 13), (["volume", "-workers", "2"], 8),
    (["master", "-telemetryInterval", "10"], 13),
    (["master", "-telemetryInterval", "0", "-sequencer.etcd", "127.0.0.1:1"], 5),
    (["server", "-filer"], 11), (["server", "-s3"], 11), (["server", "-webdav"], 11),
])
def test_unported_planes_exit_2_naming_their_item(argv, item):
    rc, _out, err = run("port", argv)
    assert rc == 2
    assert f"ROADMAP item {item})" in err


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
                         "-telemetryInterval", "0", stdout=subprocess.PIPE)
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
        procs = [spawn_cli("master", "-port", str(mport), "-telemetryInterval", "0")]
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
        procs = [spawn_cli("master", "-port", str(mport), "-nodeTimeout", "3",
                           "-telemetryInterval", "0")]
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
