"""The port's raft and HA masters against seaweedfs_tpu's, on the CPU.

tests/test_raft.py ported: the handler-level cases (log repair, stale
leaders, votes) run on both packages' RaftNode, and every reply and
every persisted state file must be equal (protobuf bytes, JSON); the
election and failover cases run on the port, one of them in a cluster
of two port nodes and one reference node (the raft pb2 modules are
byte copies, so both speak one wire); the HA-master cases run three
port MasterServers with a port VolumeServer (`device="cpu"`). Waits
have deadlines; no fixed sleeps.
"""

import json
import os
import time
import urllib.request
from concurrent import futures

import grpc
import pytest

import seaweedfs_tpu.cluster.raft as ref_raft
import seaweedfs_tpu_torch.cluster.raft as port_raft
from seaweedfs_tpu_torch.pb import raft_pb2 as rpb
from seaweedfs_tpu_torch.pb import rpc
from seaweedfs_tpu_torch.util.availability import free_port

RAFTS = {"ref": ref_raft, "port": port_raft}


def wait_for(cond, timeout=45.0, interval=0.05):
    deadline = time.time() + timeout
    while time.time() < deadline:
        if cond():
            return True
        time.sleep(interval)
    return False


# --- handler level, both packages ------------------------------------------


def _node(kind, tmp_path, n_peers=2):
    addrs = [f"127.0.0.1:{19333 + i}" for i in range(n_peers)]
    d = tmp_path / kind
    d.mkdir(exist_ok=True)
    return RAFTS[kind].RaftNode(addrs[0], addrs, lambda cmd: None, data_dir=str(d))


def _entry(term, index, cmd="{}"):
    return rpb.LogEntry(term=term, index=index, command=cmd)


def _persisted(node) -> dict:
    with open(node._state_path()) as f:
        return json.load(f)


def _conflicting_suffix(n):
    n.current_term = 1
    n.log = [_entry(1, 1), _entry(1, 2), _entry(1, 3)]
    req = rpb.AppendEntriesRequest(term=2, leader_id="127.0.0.1:19334",
                                   prev_log_index=1, prev_log_term=1, leader_commit=1)
    req.entries.add(term=2, index=2, command='{"name":"Noop"}')
    resp = n.AppendEntries(req)
    assert resp.success
    assert [(e.term, e.index) for e in n.log] == [(1, 1), (2, 2)]
    assert resp.match_index == 2
    return [resp]


def _gap(n):
    n.current_term = 1
    n.log = [_entry(1, 1)]
    resp = n.AppendEntries(rpb.AppendEntriesRequest(
        term=1, leader_id="127.0.0.1:19334", prev_log_index=5, prev_log_term=1))
    assert not resp.success
    return [resp]


def _heartbeat_match(n):
    n.current_term = 3
    n.log = [_entry(2, 1), _entry(2, 2), _entry(1, 3), _entry(1, 4)]
    resp = n.AppendEntries(rpb.AppendEntriesRequest(
        term=3, leader_id="127.0.0.1:19334", prev_log_index=2, prev_log_term=2,
        leader_commit=0))
    assert resp.success and resp.match_index == 2  # NOT 4
    return [resp]


def _stale_term(n):
    n.current_term = 5
    resp = n.AppendEntries(rpb.AppendEntriesRequest(term=3, leader_id="x",
                                                    prev_log_index=0))
    assert not resp.success and resp.term == 5
    return [resp]


def _vote_stale_log(n):
    n.current_term = 2
    n.log = [_entry(2, 1)]
    a = n.RequestVote(rpb.RequestVoteRequest(term=3, candidate_id="127.0.0.1:19334",
                                             last_log_index=5, last_log_term=1))
    assert not a.vote_granted
    b = n.RequestVote(rpb.RequestVoteRequest(term=3, candidate_id="127.0.0.1:19334",
                                             last_log_index=1, last_log_term=2))
    assert b.vote_granted
    return [a, b]


def _steps_down_append(n):
    n.current_term = 2
    n.role = port_raft.LEADER
    resp = n.AppendEntries(rpb.AppendEntriesRequest(
        term=3, leader_id="127.0.0.1:19334", prev_log_index=0, prev_log_term=0))
    assert resp.success
    assert (n.role, n.current_term, n.leader_id) == ("follower", 3, "127.0.0.1:19334")
    return [resp]


def _steps_down_vote(n):
    n.current_term = 2
    n.role = port_raft.LEADER
    resp = n.RequestVote(rpb.RequestVoteRequest(
        term=3, candidate_id="127.0.0.1:19335", last_log_index=0, last_log_term=0))
    assert (n.role, n.current_term) == ("follower", 3)
    assert resp.vote_granted  # our log is empty too: candidate is current
    return [resp]


def _stale_candidate(n):
    n.current_term = 5
    resp = n.RequestVote(rpb.RequestVoteRequest(
        term=3, candidate_id="127.0.0.1:19334", last_log_index=9, last_log_term=3))
    assert not resp.vote_granted and resp.term == 5
    return [resp]


CASES = {
    "conflicting_suffix_truncated": (_conflicting_suffix, 2),
    "gap_rejected": (_gap, 2),
    "heartbeat_does_not_overstate_match": (_heartbeat_match, 2),
    "stale_term_rejected_with_current_term": (_stale_term, 2),
    "vote_denied_to_stale_log": (_vote_stale_log, 2),
    "leader_steps_down_on_higher_term_append": (_steps_down_append, 3),
    "leader_steps_down_on_higher_term_vote": (_steps_down_vote, 3),
    "stale_candidate_cannot_disrupt_newer_term": (_stale_candidate, 3),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_handler_case_on_both_packages(case, tmp_path):
    """Each §5 handler case holds on both RaftNodes, with byte-equal
    replies, equal in-memory state and equal persisted state files."""
    fn, n_peers = CASES[case]
    got = {}
    for kind in RAFTS:
        n = _node(kind, tmp_path, n_peers)
        replies = fn(n)
        got[kind] = {
            "replies": [r.SerializeToString() for r in replies],
            "state": (n.role, n.current_term, n.voted_for, n.leader_id,
                      n.commit_index, [(e.term, e.index, e.command) for e in n.log]),
            "persisted": _persisted(n) if os.path.exists(n._state_path()) else None,
        }
    assert got["ref"] == got["port"]


# --- elections and failover on the wire ------------------------------------


def _mk_cluster(kinds, tmp_path):
    addrs = [f"127.0.0.1:{free_port()}" for _ in kinds]
    nodes, servers, pools = [], [], []
    for kind, addr in zip(kinds, addrs):
        d = tmp_path / f"{kind}-{addr.rsplit(':', 1)[1]}"
        d.mkdir()
        node = RAFTS[kind].RaftNode(addr, addrs, lambda cmd: None, data_dir=str(d))
        pool = futures.ThreadPoolExecutor(max_workers=8)
        server = grpc.server(pool)
        server.add_generic_rpc_handlers(
            (rpc.servicer_handler(rpc.RAFT_SERVICE, rpc.RAFT_METHODS, node),))
        server.add_insecure_port(rpc.grpc_address(addr))
        server.start()
        nodes.append(node)
        servers.append(server)
        pools.append(pool)
    for node in nodes:
        node.start()
    return nodes, servers, pools


def _teardown(nodes, servers, pools):
    for node in nodes:
        node.stop()
    for server, pool in zip(servers, pools):
        server.stop(grace=0).wait()
        pool.shutdown(wait=True)


def _applied(node) -> list[dict]:
    out = []
    for i in range(1, node.last_applied + 1):
        e = node._entry_at(i)
        if e is not None and e.command:
            out.append(json.loads(e.command))
    return out


@pytest.mark.parametrize("kinds", [("port", "port", "port"), ("port", "port", "ref")],
                         ids=["port", "mixed"])
def test_elects_single_leader_and_replicates(kinds, tmp_path):
    """Three nodes elect one leader and replicate a MaxVolumeId entry to
    all; a follower refuses a proposal with the leader hint. The mixed
    cluster holds a reference node: the two packages speak one wire."""
    nodes, servers, pools = _mk_cluster(kinds, tmp_path)
    try:
        assert wait_for(lambda: sum(1 for n in nodes if n.is_leader) == 1), \
            "no single leader elected"
        leader = next(n for n in nodes if n.is_leader)
        leader.propose({"name": "MaxVolumeId", "maxVolumeId": 7})
        assert wait_for(lambda: all(
            any(c.get("maxVolumeId") == 7 for c in _applied(n)) for n in nodes))
        follower = next(n for n in nodes if not n.is_leader)
        with pytest.raises((port_raft.NotLeader, ref_raft.NotLeader)):
            follower.propose({"name": "MaxVolumeId", "maxVolumeId": 8})
    finally:
        _teardown(nodes, servers, pools)


def test_leader_failover(tmp_path):
    nodes, servers, pools = _mk_cluster(("port", "port", "port"), tmp_path)
    try:
        assert wait_for(lambda: sum(1 for n in nodes if n.is_leader) == 1)
        leader = next(n for n in nodes if n.is_leader)
        leader.propose({"name": "MaxVolumeId", "maxVolumeId": 3})
        idx = nodes.index(leader)
        leader.stop()
        servers[idx].stop(grace=0).wait()
        rest = [n for i, n in enumerate(nodes) if i != idx]
        assert wait_for(lambda: sum(1 for n in rest if n.is_leader) == 1), \
            "no new leader after failover"
        new_leader = next(n for n in rest if n.is_leader)
        assert new_leader.last_applied >= 1
        new_leader.propose({"name": "MaxVolumeId", "maxVolumeId": 4})
    finally:
        _teardown(nodes, servers, pools)


# --- HA masters ------------------------------------------------------------


@pytest.fixture()
def ha_cluster(tmp_path_factory):
    from seaweedfs_tpu_torch.server.master_server import MasterServer
    from seaweedfs_tpu_torch.server.volume_server import VolumeServer

    ports = [free_port() for _ in range(3)]
    peers = ",".join(f"127.0.0.1:{p}" for p in ports)
    masters = [
        MasterServer(port=p, volume_size_limit_mb=64, peers=peers,
                     raft_dir=str(tmp_path_factory.mktemp(f"raft{p}")))
        for p in ports
    ]
    for m in masters:
        m.start()
    vs = None
    try:
        assert wait_for(lambda: sum(1 for m in masters if m.is_leader) == 1), \
            "no leader among masters"
        vs = VolumeServer([str(tmp_path_factory.mktemp("havs"))], port=free_port(),
                          master=peers, heartbeat_interval=0.2, max_volume_counts=[100],
                          ec_codec="cuda", device="cpu", scrub_interval=0)
        vs.start()
        _leader_with_server(masters)
        yield masters, vs
    finally:
        if vs is not None:
            vs.stop()
        for m in masters:
            m.stop()


def _leader_with_server(masters):
    """The master that leads and holds the volume server, waited for: a
    loaded host may re-elect before the server's first beat lands."""
    assert wait_for(lambda: any(m.is_leader and len(m.topology.data_nodes()) == 1
                                for m in masters)), \
        "volume server did not register with a leader"
    return next(m for m in masters if m.is_leader)


def _http_json(url, data=None, timeout=30):
    req = urllib.request.Request(url, data=data, method="POST" if data else "GET")
    with urllib.request.urlopen(req, timeout=timeout) as r:
        return json.loads(r.read())


def test_assign_via_any_master_and_failover(ha_cluster):
    """Assign through a follower (proxied to the leader), kill the
    leader, and the volume server follows the new one; assigns keep
    working and volume ids are never reused after the failover."""
    masters, vs = ha_cluster
    leader = _leader_with_server(masters)
    followers = [m for m in masters if m is not leader]
    ar1 = _http_json(f"http://127.0.0.1:{followers[0].port}/dir/assign")
    assert ar1.get("fid"), ar1
    vid1 = int(ar1["fid"].split(",")[0])
    urllib.request.urlopen(urllib.request.Request(
        f"http://{ar1['url']}/{ar1['fid']}", data=b"ha payload", method="POST"),
        timeout=10).close()

    leader.stop()
    rest = [m for m in masters if m is not leader]
    new_leader = _leader_with_server(rest)
    max_before = max(vid1, new_leader.topology.id_gen.peek())
    ar3 = _http_json(f"http://127.0.0.1:{new_leader.port}/dir/assign"
                     f"?collection=post_failover")
    vid3 = int(ar3["fid"].split(",")[0])
    assert vid3 > max(vid1, 0) and new_leader.topology.id_gen.peek() >= max_before
    urllib.request.urlopen(urllib.request.Request(
        f"http://{ar3['url']}/{ar3['fid']}", data=b"post failover", method="POST"),
        timeout=10).close()
    with urllib.request.urlopen(f"http://{ar1['url']}/{ar1['fid']}", timeout=10) as r:
        assert r.read() == b"ha payload"


def test_submit_and_vacuum_proxied_through_follower(ha_cluster):
    """/submit works via any master (assign proxies to the leader) and
    /vol/vacuum on a follower is HTTP-proxied to the leader."""
    masters, vs = ha_cluster
    leader = _leader_with_server(masters)
    follower = next(m for m in masters if m is not leader)
    res = _http_json(f"http://127.0.0.1:{follower.port}/submit", data=b"via follower")
    assert res.get("fid"), res
    with urllib.request.urlopen(f"http://{res['fileUrl']}", timeout=10) as r:
        assert r.read() == b"via follower"
    res = _http_json(f"http://127.0.0.1:{follower.port}/vol/vacuum", timeout=60)
    assert "vacuumed" in res and "Topology" in res, res
    status = _http_json(f"http://127.0.0.1:{follower.port}/cluster/status")
    assert status["IsLeader"] is False and status["Leader"] != f"127.0.0.1:{follower.port}"
