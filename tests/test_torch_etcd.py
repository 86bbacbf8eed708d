"""The port's etcd client (seaweedfs_tpu_torch/util/etcd.py) and its two
users, the EtcdSequencer and the etcd filer store, against
seaweedfs_tpu's, on the CPU, each package against a FakeEtcd of its own
(tests/cloud_fakes.py, the etcd v3 gateway REST subset).

The same numpy-drawn sequence of puts, ranges, txns and deletes through
both packages' `EtcdKv` gives the same answers and leaves the same
keys; both packages' sequencers hand out the same ids from the same
start, under the same set_max lifts, across a restart and after the key
is deleted behind them (tests/test_smallgaps.py's TestEtcdSequencer
ported); two port sequencers on one etcd never overlap; an unreachable
endpoint raises the reference's guidance; and `master -sequencer.etcd`
comes up on the port and hands out ids from etcd. The tolerance is
equality.
"""

import base64
import importlib
import json
import os
import signal
import subprocess
import sys
import time
import urllib.request

import numpy as np
import pytest

from seaweedfs_tpu_torch.util.availability import free_port
from tests.cloud_fakes import FakeEtcd

SIDES = ("ref", "port")
PKG = {"ref": "seaweedfs_tpu", "port": "seaweedfs_tpu_torch"}
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def mod(side, name):
    return importlib.import_module(f"{PKG[side]}.{name}")


@pytest.fixture
def fakes():
    out = {side: FakeEtcd() for side in SIDES}
    for f in out.values():
        f.start()
    yield out
    for f in out.values():
        f.stop()


def b64(s):
    return base64.b64encode(s.encode()).decode()


def _kv_ops(seed, n):
    rng = np.random.default_rng(seed)
    ops = []
    for i in range(n):
        key = b64(f"/k/{int(rng.integers(0, 8))}")
        kind = int(rng.integers(0, 4))
        if kind == 0:
            ops.append(("put", {"key": key, "value": b64(f"v{i}")}))
        elif kind == 1:
            ops.append(("range", {"key": key}))
        elif kind == 2:
            ops.append(("txn", {
                "compare": [{"key": key, "target": "CREATE", "createRevision": "0"}],
                "success": [{"requestPut": {"key": key, "value": b64(f"c{i}")}}]}))
        else:
            ops.append(("deleterange", {"key": key}))
    return ops


def _answer(op, resp):
    """The parts of an answer that do not depend on the fake's revision
    counter's history beyond the operations themselves."""
    if op == "range":
        return sorted((kv["key"], kv["value"]) for kv in resp.get("kvs", []))
    if op == "txn":
        return bool(resp.get("succeeded"))
    return sorted(k for k in resp if k != "header")


def test_kv_sequence_equals_the_references(fakes):
    ops = _kv_ops(2, 120)
    got = {}
    for side in SIDES:
        kv = mod(side, "util.etcd").EtcdKv(fakes[side].endpoint)
        got[side] = ([_answer(op, kv.call(op, payload)) for op, payload in ops],
                     dict(fakes[side].kv))
    assert got["port"] == got["ref"]
    assert got["port"][1] and any(got["port"][0])


def test_kv_fails_over_to_a_live_endpoint_and_names_http_errors(fakes):
    dead = f"127.0.0.1:{free_port()}"
    for side in SIDES:
        etcd = mod(side, "util.etcd")
        kv = etcd.EtcdKv(f"{dead},{fakes[side].endpoint}")
        kv.call("put", {"key": b64("/x"), "value": b64("1")})
        assert kv._endpoints[0] == fakes[side].endpoint  # the live one moved first
        with pytest.raises(etcd.EtcdHttpError):
            kv.call("no-such-op", {})
        with pytest.raises(ValueError):
            etcd.EtcdKv(" , ")


def _sequence(side, endpoint):
    seq_mod = mod(side, "sequence")
    s = seq_mod.EtcdSequencer(endpoint, step=10)
    out = [s.next_file_id(1), s.next_file_id(10), s.next_file_id(1)]
    for step in range(30):
        if step % 9 == 4:
            s.set_max(out[-1] + step * 7)
        out.append(s.next_file_id(step % 4 + 1))
    out.append(s.peek())
    s2 = seq_mod.EtcdSequencer(endpoint, step=10)  # a restart: no id reused
    fresh = [s2.next_file_id(1) for _ in range(12)]
    assert not set(fresh) & set(out[:-1])
    s2._kv.call("deleterange", {"key": s2._key_b64})  # key gone behind its back
    again = [s2.next_file_id(1) for _ in range(25)]
    assert len(set(again)) == 25 and min(again) > max(fresh)
    return out, fresh, again


def test_sequencers_hand_out_the_same_ids(fakes):
    got = {side: _sequence(side, fakes[side].endpoint) for side in SIDES}
    assert got["port"] == got["ref"]
    out = got["port"][0]
    assert 1 <= out[0] < out[1] and out[2] == out[1] + 10


def test_two_port_sequencers_never_overlap(fakes):
    seq_mod = mod("port", "sequence")
    s1 = seq_mod.EtcdSequencer(fakes["port"].endpoint, step=20)
    s2 = seq_mod.EtcdSequencer(fakes["port"].endpoint, step=20)
    got1 = {s1.next_file_id(1) for _ in range(60)}
    got2 = {s2.next_file_id(1) for _ in range(60)}
    assert not got1 & got2 and len(got1) == len(got2) == 60


def test_unreachable_etcd_raises_the_references_guidance():
    dead = f"127.0.0.1:{free_port()}"
    msgs = {}
    for side in SIDES:
        with pytest.raises(RuntimeError) as ei:
            mod(side, "sequence").EtcdSequencer(dead)
        msgs[side] = str(ei.value)
    assert msgs["port"] == msgs["ref"] and "cannot reach" in msgs["port"]


def test_master_sequencer_etcd_starts_and_assigns_from_etcd(tmp_path):
    """`master -sequencer.etcd` (the port's CLI) comes up, a volume
    server registers, /dir/assign hands out file ids whose keys come
    from etcd, and SIGTERM ends both with exit code 0."""
    etcd = FakeEtcd()
    etcd.start()
    mport, vport = free_port(), free_port()
    env = dict(os.environ, WEED_EC_CODEC="cpu")
    procs = []
    try:
        procs.append(subprocess.Popen(
            [sys.executable, "-m", "seaweedfs_tpu_torch", "master", "-port", str(mport),
             "-telemetryInterval", "0", "-repairInterval", "0",
             "-sequencer.etcd", etcd.endpoint],
            cwd=REPO, env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT))
        procs.append(subprocess.Popen(
            [sys.executable, "-m", "seaweedfs_tpu_torch", "volume", "-port", str(vport),
             "-dir", str(tmp_path), "-mserver", f"127.0.0.1:{mport}", "-ec.codec", "cpu",
             "-scrubInterval", "0"],
            cwd=REPO, env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT))
        assign, deadline = None, time.time() + 60
        while time.time() < deadline:
            try:
                with urllib.request.urlopen(
                        f"http://127.0.0.1:{mport}/dir/assign", timeout=5) as r:
                    assign = json.loads(r.read())
                if "fid" in assign:
                    break
            except OSError:
                pass
            time.sleep(0.2)
        assert assign and "fid" in assign, assign
        stored = etcd.kv.get(b64(mod("port", "sequence").EtcdSequencer.KEY))
        assert stored is not None
        key = int(assign["fid"].split(",")[1][:-8], 16)
        assert 1 <= key <= int(base64.b64decode(stored))
    finally:
        outs = []
        for p in reversed(procs):
            p.send_signal(signal.SIGTERM)
            try:
                outs.append((p.wait(timeout=30), p.stdout.read()[-2000:]))
            except subprocess.TimeoutExpired:
                p.kill()
                p.wait()
                outs.append((-9, b""))
            p.stdout.close()
        etcd.stop()
    assert [rc for rc, _ in outs] == [0, 0], outs
