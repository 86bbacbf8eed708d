"""Compact Raft for the HA master tier.

Role match of reference weed/server/raft_server.go:28-88 (which embeds
chrislusf/raft over a gRPC transport): leader election + a replicated
command log whose only production command is MaxVolumeId
(weed/topology/cluster_commands.go). The log is tiny — one entry per
volume-id allocation — so no snapshotting/compaction is needed; the
whole persistent state (term, vote, log) lives in one JSON file per
node, rewritten atomically on change.

Safety properties implemented per the Raft paper (§5.1-5.4):
  * one vote per term, persisted before replying
  * election restriction: candidates must have an up-to-date log
  * append consistency check on (prev_log_index, prev_log_term) with
    conflict truncation
  * commit only log entries of the current term via majority match
    (older entries commit transitively)

Threading model: a single ticker thread drives election timeouts and
leader heartbeats; RPC handlers run on gRPC server threads; all state
transitions hold one lock. propose() blocks until the entry commits
(applying is done in commit order under the same lock discipline).
stop() joins the ticker and the leader's replicator threads.

The port of seaweedfs_tpu/cluster/raft.py. One departure: the reference
fsyncs the state file while it holds the node's lock, so on a busy disk
(a persist of 0.1-1 s) a leader stops heartbeating and a follower's
timer fires while its own write runs, and a leader steps down in the
middle of a proposal. Here the state is snapshotted under the lock and
written outside it before the node answers or acts on it; an older
snapshot never overwrites a newer one, and a leader counts itself
toward a commit only for entries on its own disk.
"""

from __future__ import annotations

import contextlib
import json
import os
import random
import threading
import time
from typing import Callable

import grpc

from seaweedfs_tpu_torch.pb import raft_pb2 as rpb
from seaweedfs_tpu_torch.pb import rpc
from seaweedfs_tpu_torch.util import durable

FOLLOWER = "follower"
CANDIDATE = "candidate"
LEADER = "leader"


class NotLeader(Exception):
    def __init__(self, leader: str):
        super().__init__(f"not the leader; leader={leader or 'unknown'}")
        self.leader = leader


class RaftNode:
    def __init__(
        self,
        self_addr: str,
        peers: list[str],
        apply_fn: Callable[[dict], None],
        data_dir: str | None = None,
        election_timeout: tuple[float, float] = (0.4, 0.8),
        heartbeat_interval: float = 0.1,
    ):
        """self_addr/peers are master HTTP addresses ("host:port");
        the raft RPCs ride each master's gRPC port (+10000).
        apply_fn(command_dict) is invoked in log order on every node
        as entries commit. Election timeouts are 4-8x the heartbeat
        interval so GIL/CPU starvation in crowded test hosts does not
        read as leader death and churn elections."""
        self.self_addr = self_addr
        self.peers = [p for p in peers if p != self_addr]
        self.apply_fn = apply_fn
        self.data_dir = data_dir
        self.election_timeout = election_timeout
        self.heartbeat_interval = heartbeat_interval

        self._lock = threading.Lock()
        self._commit_cv = threading.Condition(self._lock)
        self.role = FOLLOWER
        self.current_term = 0
        self.voted_for = ""
        self.log: list[rpb.LogEntry] = []  # 1-based indexing via entry.index
        self.commit_index = 0
        self.last_applied = 0
        self.leader_id = ""
        self._deadline = time.monotonic() + self._rand_timeout()
        self._next_index: dict[str, int] = {}
        self._match_index: dict[str, int] = {}
        self._stop = threading.Event()
        self._ticker: threading.Thread | None = None
        self._channels: dict[str, grpc.Channel] = {}
        # leader-side per-peer replicator threads + wakeup events
        self._repl_threads: list[threading.Thread] = []
        self._repl_events: dict[str, threading.Event] = {}
        # persistence: snapshots are taken under _lock and written under
        # _persist_lock alone (see _persist and _flush)
        self._persist_lock = threading.Lock()
        self._snapshots = 0  # snapshots taken
        self._snapshot: tuple | None = None  # the newest: (number, state, last index)
        self._written = 0  # the newest snapshot number on disk
        self._durable_index = 0  # the last log index on this node's disk

        self._load_state()

    # ------------------------------------------------------------------
    # persistence (raft paper: persist term/vote/log before replying)
    def _state_path(self) -> str | None:
        if not self.data_dir:
            return None
        return os.path.join(
            self.data_dir, f"raft-{self.self_addr.replace(':', '_')}.json"
        )

    def _load_state(self) -> None:
        path = self._state_path()
        if not path or not os.path.exists(path):
            return
        with open(path) as f:
            st = json.load(f)
        self.current_term = st.get("term", 0)
        self.voted_for = st.get("voted_for", "")
        self.log = [
            rpb.LogEntry(term=e["term"], index=e["index"], command=e["command"])
            for e in st.get("log", [])
        ]
        self._durable_index = self._last_log_index()

    def _persist(self) -> None:
        """Snapshot the persistent state (term, vote, log); called under
        the lock. The calling thread writes it with _flush() once it has
        released the lock, before it answers an RPC or acts on the new
        state: the fsync never holds the lock, so a slow disk stalls
        neither the leader's heartbeats nor a follower's timer."""
        if not self._state_path():
            self._durable_index = self._last_log_index()
            return
        self._snapshots += 1
        self._snapshot = (self._snapshots, {
            "term": self.current_term,
            "voted_for": self.voted_for,
            "log": [
                {"term": e.term, "index": e.index, "command": e.command}
                for e in self.log
            ],
        }, self._last_log_index())

    @contextlib.contextmanager
    def _locked(self):
        """The node's lock; once it is released, the state snapshotted
        under it is written (_flush) before the caller goes on."""
        try:
            with self._lock:
                yield
        finally:
            self._flush()

    def _flush(self) -> None:
        """Write the newest snapshot to disk unless it is there; called
        without the lock. An older snapshot never overwrites a newer."""
        if self._snapshots <= self._written:
            return
        with self._persist_lock:
            with self._lock:
                seq, state, last = self._snapshot
            if seq <= self._written:
                return
            path = self._state_path()
            os.makedirs(self.data_dir, exist_ok=True)
            tmp = path + ".tmp"
            with open(tmp, "w") as f:
                json.dump(state, f)
            # durable publish: a vote or term bump that does not survive
            # the crash lets this node vote twice in one term — the one
            # thing Raft's safety argument forbids
            durable.publish(tmp, path)
            self._written = seq
            with self._lock:
                self._durable_index = last

    # ------------------------------------------------------------------
    def start(self) -> None:
        self._ticker = threading.Thread(target=self._tick_loop, daemon=True)
        self._ticker.start()

    def stop(self) -> None:
        self._stop.set()
        for ev in self._repl_events.values():
            ev.set()
        if self._ticker:
            self._ticker.join(timeout=2)
        for t in self._repl_threads:
            t.join(timeout=2)
        for ch in self._channels.values():
            ch.close()
        self._channels.clear()

    @property
    def is_leader(self) -> bool:
        return self.role == LEADER

    def leader(self) -> str:
        if self.role == LEADER:
            return self.self_addr
        return self.leader_id

    # ------------------------------------------------------------------
    # log helpers (under lock)
    def _last_log_index(self) -> int:
        return self.log[-1].index if self.log else 0

    def _last_log_term(self) -> int:
        return self.log[-1].term if self.log else 0

    def _entry_at(self, index: int) -> rpb.LogEntry | None:
        if index <= 0 or index > len(self.log):
            return None
        return self.log[index - 1]

    def _rand_timeout(self) -> float:
        return random.uniform(*self.election_timeout)

    def _become_follower(self, term: int) -> None:
        self.role = FOLLOWER
        self.current_term = term
        self.voted_for = ""
        self.leader_id = ""  # unknown for the new term until a leader speaks
        self._deadline = time.monotonic() + self._rand_timeout()
        self._persist()

    # ------------------------------------------------------------------
    # RPC handlers (bound into the master's gRPC server)
    def RequestVote(self, req: rpb.RequestVoteRequest, context=None):
        with self._locked():  # the vote is on disk before it is granted
            if req.term > self.current_term:
                self._become_follower(req.term)
            granted = False
            if req.term == self.current_term and self.voted_for in (
                "",
                req.candidate_id,
            ):
                # election restriction (§5.4.1): candidate's log must be
                # at least as up-to-date as ours
                up_to_date = req.last_log_term > self._last_log_term() or (
                    req.last_log_term == self._last_log_term()
                    and req.last_log_index >= self._last_log_index()
                )
                if up_to_date:
                    granted = True
                    self.voted_for = req.candidate_id
                    self._deadline = time.monotonic() + self._rand_timeout()
                    self._persist()
            return rpb.RequestVoteResponse(
                term=self.current_term, vote_granted=granted
            )

    def AppendEntries(self, req: rpb.AppendEntriesRequest, context=None):
        with self._locked():  # new entries are on disk before they are acknowledged
            if req.term > self.current_term:
                self._become_follower(req.term)
            if req.term < self.current_term:
                return rpb.AppendEntriesResponse(
                    term=self.current_term, success=False
                )
            # valid leader for this term
            self.role = FOLLOWER
            self.leader_id = req.leader_id
            self._deadline = time.monotonic() + self._rand_timeout()

            # consistency check
            if req.prev_log_index > 0:
                prev = self._entry_at(req.prev_log_index)
                if prev is None or prev.term != req.prev_log_term:
                    return rpb.AppendEntriesResponse(
                        term=self.current_term, success=False
                    )
            # append, truncating conflicts
            changed = False
            for e in req.entries:
                existing = self._entry_at(e.index)
                if existing is not None and existing.term != e.term:
                    del self.log[e.index - 1 :]
                    existing = None
                    changed = True
                if existing is None:
                    self.log.append(
                        rpb.LogEntry(term=e.term, index=e.index, command=e.command)
                    )
                    changed = True
            if changed:
                self._persist()
            if req.leader_commit > self.commit_index:
                self.commit_index = min(req.leader_commit, self._last_log_index())
                self._apply_committed_locked()
            return rpb.AppendEntriesResponse(
                term=self.current_term,
                success=True,
                # only what THIS request proved replicated: stale
                # entries past prev+entries may conflict with the
                # leader's log and must not count toward commit
                match_index=req.prev_log_index + len(req.entries),
            )

    # ------------------------------------------------------------------
    # ticker: elections + leader heartbeats
    def _tick_loop(self) -> None:
        while not self._stop.is_set():
            with self._lock:
                role = self.role
                deadline = self._deadline
            now = time.monotonic()
            if role == LEADER:
                # per-peer replicator threads carry heartbeats; one
                # slow/dead peer must not gate the others' cadence
                self._stop.wait(self.heartbeat_interval)
            elif now >= deadline:
                self._run_election()
            else:
                self._stop.wait(min(0.02, deadline - now))

    def _run_election(self) -> None:
        with self._locked():  # the term and the self-vote are on disk before asking
            self.role = CANDIDATE
            self.current_term += 1
            self.voted_for = self.self_addr
            term = self.current_term
            self._deadline = time.monotonic() + self._rand_timeout()
            self._persist()
            req = rpb.RequestVoteRequest(
                term=term,
                candidate_id=self.self_addr,
                last_log_index=self._last_log_index(),
                last_log_term=self._last_log_term(),
            )
        votes = 1  # self
        needed = (len(self.peers) + 1) // 2 + 1
        results: list[rpb.RequestVoteResponse] = []
        lock = threading.Lock()
        done = threading.Event()

        def ask(peer: str) -> None:
            nonlocal votes
            resp = self._call(peer, "RequestVote", req, timeout=0.2)
            if resp is None:
                return
            with lock:
                results.append(resp)
                if resp.vote_granted:
                    votes += 1
                    if votes >= needed:
                        done.set()

        threads = [
            threading.Thread(target=ask, args=(p,), daemon=True)
            for p in self.peers
        ]
        for t in threads:
            t.start()
        done.wait(timeout=0.3)
        with self._lock:
            stepped_down = False
            for resp in results:
                if resp.term > self.current_term:
                    self._become_follower(resp.term)
                    stepped_down = True
                    break
            if (not stepped_down and self.role == CANDIDATE
                    and self.current_term == term and votes >= needed):
                self.role = LEADER
                self.leader_id = self.self_addr
                nxt = self._last_log_index() + 1
                self._next_index = {p: nxt for p in self.peers}
                self._match_index = {p: 0 for p in self.peers}
                # commit a current-term no-op immediately so entries
                # from prior terms become committable (§5.4.2 — a new
                # leader may never commit old-term entries directly)
                self.log.append(
                    rpb.LogEntry(
                        term=self.current_term,
                        index=nxt,
                        command=json.dumps({"name": "Noop"}),
                    )
                )
                self._persist()
        if self.is_leader:
            # heartbeats first: the no-op's write runs beside them, and
            # this node counts toward its commit once it is on disk
            self._start_replicators()
        self._flush()
        if self.is_leader:
            # single-node cluster: commit advances with no peers to wait on
            self._advance_commit()

    def _start_replicators(self) -> None:
        """One long-lived replicator thread per peer: sends
        AppendEntries immediately when woken (new entries) and at the
        heartbeat interval otherwise. A dead peer blocks only its own
        thread, never the other peers' heartbeat cadence."""
        with self._lock:
            term = self.current_term
        self._repl_events = {p: threading.Event() for p in self.peers}

        def run(peer: str) -> None:
            ev = self._repl_events[peer]
            while not self._stop.is_set():
                with self._lock:
                    if self.role != LEADER or self.current_term != term:
                        return
                self._replicate_to(peer)
                ev.wait(timeout=self.heartbeat_interval)
                ev.clear()

        self._repl_threads = [
            threading.Thread(target=run, args=(p,), daemon=True)
            for p in self.peers
        ]
        for t in self._repl_threads:
            t.start()

    def _wake_replicators(self) -> None:
        for ev in self._repl_events.values():
            ev.set()

    def _replicate_to(self, peer: str) -> None:
        with self._lock:
            if self.role != LEADER:
                return
            nxt = self._next_index.get(peer, self._last_log_index() + 1)
            prev_index = nxt - 1
            prev = self._entry_at(prev_index)
            req = rpb.AppendEntriesRequest(
                term=self.current_term,
                leader_id=self.self_addr,
                prev_log_index=prev_index,
                prev_log_term=prev.term if prev else 0,
                leader_commit=self.commit_index,
            )
            for e in self.log[nxt - 1 :]:
                req.entries.add(term=e.term, index=e.index, command=e.command)
        resp = self._call(peer, "AppendEntries", req, timeout=0.2)
        if resp is None:
            return
        with self._locked():
            if resp.term > self.current_term:
                self._become_follower(resp.term)
                return
            if self.role != LEADER:
                return
            if resp.success:
                self._match_index[peer] = resp.match_index
                self._next_index[peer] = resp.match_index + 1
            else:
                # back off and retry next round
                self._next_index[peer] = max(1, self._next_index.get(peer, 1) - 1)
        if resp.success:
            self._advance_commit()

    def _advance_commit(self) -> None:
        with self._lock:
            if self.role != LEADER:
                return
            majority = (len(self.peers) + 1) // 2 + 1
            for idx in range(self._last_log_index(), self.commit_index, -1):
                entry = self._entry_at(idx)
                if entry is None or entry.term != self.current_term:
                    continue  # §5.4.2: only current-term entries directly
                # this node counts only for entries on its own disk
                count = (idx <= self._durable_index) + sum(
                    1 for p in self.peers if self._match_index.get(p, 0) >= idx
                )
                if count >= majority:
                    self.commit_index = idx
                    self._apply_committed_locked()
                    break

    def _apply_committed_locked(self) -> None:
        while self.last_applied < self.commit_index:
            self.last_applied += 1
            entry = self._entry_at(self.last_applied)
            if entry is not None and entry.command:
                try:
                    self.apply_fn(json.loads(entry.command))
                except Exception:  # noqa: BLE001 - state machine must not kill raft
                    pass
        self._commit_cv.notify_all()

    # ------------------------------------------------------------------
    def propose(self, command: dict, timeout: float = 5.0) -> None:
        """Leader-only: append `command`, replicate, block until it
        commits (and is applied locally). Raises NotLeader elsewhere."""
        with self._lock:
            if self.role != LEADER:
                raise NotLeader(self.leader())
            index = self._last_log_index() + 1
            self.log.append(
                rpb.LogEntry(
                    term=self.current_term, index=index, command=json.dumps(command)
                )
            )
            self._persist()
        self._wake_replicators()
        self._flush()  # beside the followers' writes
        self._advance_commit()  # single-node clusters commit immediately
        deadline = time.monotonic() + timeout
        with self._commit_cv:
            while self.last_applied < index:
                remaining = deadline - time.monotonic()
                if remaining <= 0 or self._stop.is_set():
                    raise TimeoutError(f"command at index {index} did not commit")
                if self.role != LEADER:
                    raise NotLeader(self.leader())
                self._commit_cv.wait(timeout=min(remaining, 0.05))

    def barrier(self, timeout: float = 5.0) -> None:
        """Leader-only: block until every entry currently in the log is
        applied locally. A freshly elected leader may hold committed-
        but-unapplied entries from prior terms (its no-op commits
        them); reading state-machine values (max volume id) before the
        backlog applies would hand out stale answers."""
        deadline = time.monotonic() + timeout
        with self._commit_cv:
            if self.role != LEADER:
                raise NotLeader(self.leader())
            target = self._last_log_index()
            while self.last_applied < target:
                if self.role != LEADER:
                    raise NotLeader(self.leader())
                remaining = deadline - time.monotonic()
                if remaining <= 0 or self._stop.is_set():
                    raise TimeoutError("raft apply backlog did not drain")
                self._commit_cv.wait(timeout=min(remaining, 0.05))

    # ------------------------------------------------------------------
    def _channel(self, peer: str) -> grpc.Channel:
        ch = self._channels.get(peer)
        if ch is None:
            ch = rpc.dial(rpc.grpc_address(peer))
            self._channels[peer] = ch
        return ch

    def _call(self, peer: str, method: str, req, timeout: float):
        try:
            stub = rpc.raft_stub(self._channel(peer))
            return getattr(stub, method)(req, timeout=timeout)
        except grpc.RpcError:
            return None
