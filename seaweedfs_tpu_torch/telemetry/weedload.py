"""weedload: multi-PROCESS closed-loop load harness.

An in-process http load generator shares the GIL with the servers it
measures — it cannot see cross-process tail latency, which is exactly
where tail-latency work lives. weedload runs every worker as its own OS process against a real
cluster over real sockets and reports p50/p99/p99.9 from log-bucketed
histograms, so it is the measurement substrate for hedging/admission
experiments.

Coordinated-omission safety: each worker is closed-loop (next request
issues only after the previous completes) but paces against a fixed
schedule when `rate` is set — latency is measured from the request's
SCHEDULED start, not its actual send. A server stall therefore charges
every request queued behind it with the stall time, instead of the
classic closed-loop lie where a 1 s freeze records one slow request
and silently omits the 999 that never got sent. `rate=0` degrades to
plain closed-loop (latency = send→reply) for max-throughput probes.

Workloads: `put` workers drive the full user write path (master
/dir/assign + volume POST per op); `get` workers read a pre-seeded
keyset (volume GET per op, round-robin). Histograms are log-bucketed
(~19% bucket growth from 50 µs to ~100 s) and merged in the parent;
quantiles come from the shared stats/quantile estimator so weedload,
the telemetry rings, and bench agree about tails by construction.

The port of seaweedfs_tpu/telemetry/weedload.py. A worker only speaks
HTTP: its process imports neither torch nor a card library (this module
and what it imports lazily, qos/hedge.py for hedged GETs, import none),
so a spawned worker starts in well under a second and never holds the
card. `verify_bytes` against an EC volume with lost shards drives
degraded GETs that each reconstruct on a serving server's card.
"""

from __future__ import annotations

import bisect
import http.client
import json
import multiprocessing
import time
import urllib.error
import urllib.request

from seaweedfs_tpu_torch.stats.quantile import histogram_quantile

# ~4 buckets per octave: 50 us .. ~104 s in 89 bounds (+1 overflow)
_BOUNDS = tuple(5e-5 * 2 ** (i / 4) for i in range(85))


class LogHistogram:
    """Fixed log-bucketed latency histogram; cheap to record, merge,
    and ship over a multiprocessing queue as a plain list."""

    __slots__ = ("counts", "total", "sum", "max")

    def __init__(self, counts: list[int] | None = None):
        self.counts = counts or [0] * (len(_BOUNDS) + 1)
        self.total = sum(self.counts)
        self.sum = 0.0
        self.max = 0.0

    def record(self, seconds: float) -> None:
        self.counts[bisect.bisect_left(_BOUNDS, seconds)] += 1
        self.total += 1
        self.sum += seconds
        if seconds > self.max:
            self.max = seconds

    def merge(self, other: "LogHistogram") -> None:
        for i, c in enumerate(other.counts):
            self.counts[i] += c
        self.total += other.total
        self.sum += other.sum
        if other.max > self.max:
            self.max = other.max

    def quantile(self, q: float) -> float:
        if self.total == 0:
            return 0.0
        est = histogram_quantile(list(_BOUNDS), self.counts, q)
        # bucket interpolation can overshoot the true extreme by up to
        # one bucket width; the recorded max is a hard ceiling
        return min(est, self.max) if self.max > 0 else est

    def to_row(self) -> dict:
        return {
            "counts": self.counts,
            "sum": self.sum,
            "max": self.max,
        }

    @classmethod
    def from_row(cls, row: dict) -> "LogHistogram":
        h = cls(list(row["counts"]))
        h.sum = row["sum"]
        h.max = row["max"]
        return h


# ----------------------------------------------------------------------
# worker process


def _http(conns: dict, netloc: str, method: str, path: str,
          body: bytes | None = None, timeout: float = 30.0):
    """One request over a cached keep-alive connection; one fresh-dial
    retry on a torn connection (server restart, idle close)."""
    for attempt in (0, 1):
        conn = conns.get(netloc)
        if conn is None:
            conn = conns[netloc] = http.client.HTTPConnection(
                netloc, timeout=timeout
            )
        try:
            conn.request(method, path, body=body)
            resp = conn.getresponse()
            data = resp.read()
            return resp.status, data
        except (OSError, http.client.HTTPException):
            conn.close()
            conns.pop(netloc, None)
            if attempt:
                raise
    raise RuntimeError("unreachable")


class _Shed(Exception):
    """A 503 from admission control: counted separately from errors —
    the request was deliberately refused, not failed."""


def _worker(spec: dict, out_q, barrier=None) -> None:
    """One load worker (runs in its own process). `spec`:
    mode ('put' | 'get' | 'mixed'), master, duration_s, payload, rate,
    keys, index, hedge. `barrier` (shared with the parent and every
    sibling) gates the measured loop until ALL workers finish their
    process bootstrap — a sibling still importing heavyweight modules
    pins the CPU and would charge multi-hundred-ms stalls to the
    server under test.

    `mixed` alternates one PUT then one GET per scheduled slot (the
    multi-tenant contention shape: writers and readers fight for the
    same disks). `hedge` (with keys entries carrying a replica url
    LIST) routes GETs through the qos hedged-read driver and reports
    fired/won/cancelled counts. A 503 reply counts as `shed`, not an
    error, and its latency lands in a separate histogram so the
    accepted-request quantiles stay honest under admission control."""
    mode = spec["mode"]
    master = spec["master"]
    payload = spec["payload"]
    rate = spec["rate"]
    keys = spec.get("keys") or []
    # degraded-GET worker knob (docs/SCRUB.md): a degraded read that
    # "succeeds" with truncated or zero-filled bytes is the worst
    # failure mode a latency number can hide — verify_bytes makes a
    # wrong-length body an ERROR, so the degraded A/B's `errors: 0`
    # actually certifies reconstruction, not just status codes
    verify_bytes = int(spec.get("verify_bytes") or 0)
    use_hedge = bool(spec.get("hedge"))
    hedge_stats: dict = {}
    if use_hedge:
        from seaweedfs_tpu_torch.qos import hedge as _hedge
    if barrier is not None:
        barrier.wait(120)
    conns: dict[str, http.client.HTTPConnection] = {}
    hist = LogHistogram()
    shed_hist = LogHistogram()
    ops = 0
    errors = 0
    shed = 0
    err_samples: list[str] = []
    nbytes = 0
    interval = (1.0 / rate) if rate > 0 else 0.0
    start = time.perf_counter()
    deadline = start + spec["duration_s"]
    scheduled = start
    ki = spec.get("index", 0)  # stagger the round-robin start per worker

    def one_put():
        nonlocal nbytes
        status, data = _http(conns, master, "GET", "/dir/assign", timeout=30.0)
        if status != 200:
            raise RuntimeError(f"assign HTTP {status}")
        a = json.loads(data)
        if "error" in a:
            raise RuntimeError(f"assign: {a['error']}")
        status, data = _http(conns, a["url"], "POST", f"/{a['fid']}", payload)
        if status == 503:
            raise _Shed()
        if status not in (200, 201):
            raise RuntimeError(f"put HTTP {status}")
        nbytes += len(payload)

    def one_get():
        nonlocal nbytes, ki
        fid, loc = keys[ki % len(keys)]
        ki += 1
        urls = [loc] if isinstance(loc, str) else list(loc)
        if use_hedge and len(urls) > 1:
            # rotate the primary across replicas so the hedged arm's
            # first attempt hits the slow replica as often as the
            # unhedged arm does — the A/B measures hedging, not luck
            r = ki % len(urls)
            cand = [f"{urls[(r + j) % len(urls)]}/{fid}" for j in range(len(urls))]
            data, _ = _hedge.download(
                cand, key=fid.partition(",")[0], stats=hedge_stats
            )
            nbytes += len(data)
            return
        url = urls[ki % len(urls)]
        status, data = _http(conns, url, "GET", f"/{fid}")
        if status == 503:
            raise _Shed()
        if status != 200:
            raise RuntimeError(f"get {fid} HTTP {status}")
        if verify_bytes and len(data) != verify_bytes:
            raise RuntimeError(
                f"get {fid}: {len(data)} bytes, expected {verify_bytes} "
                f"(degraded reconstruction served wrong-length body)"
            )
        nbytes += len(data)

    n_slot = 0
    while True:
        now = time.perf_counter()
        if interval:
            if scheduled > now:
                time.sleep(scheduled - now)
            t_ref = scheduled  # CO correction: charge from the schedule
            scheduled += interval
        else:
            t_ref = now
        if t_ref >= deadline or now >= deadline:
            break
        n_slot += 1
        try:
            if mode == "put" or (mode == "mixed" and n_slot % 2):
                one_put()
            else:
                one_get()
        except _Shed:
            shed += 1
            shed_hist.record(time.perf_counter() - t_ref)
            continue
        except Exception as e:  # noqa: BLE001 — counted, not fatal
            errors += 1
            if len(err_samples) < 5:
                err_samples.append(repr(e)[:200])
            hist.record(time.perf_counter() - t_ref)
            continue
        hist.record(time.perf_counter() - t_ref)
        ops += 1
    for c in conns.values():
        c.close()
    out_q.put({
        "mode": mode,
        "ops": ops,
        "errors": errors,
        "shed": shed,
        "err_samples": err_samples,
        "bytes": nbytes,
        "hist": hist.to_row(),
        "shed_hist": shed_hist.to_row(),
        "hedge": hedge_stats,
        "wall_s": time.perf_counter() - start,
    })


# ----------------------------------------------------------------------
# parent


def seed_keys(
    master: str,
    n: int,
    payload: bytes,
    etags: dict | None = None,
    content_type: str = "application/octet-stream",
) -> list[tuple[str, str]]:
    """Write n blobs for the GET workers to hammer; returns (fid, url).
    Pass `etags` (a dict) to also capture each upload's ETag — the
    validators the conditional-GET mix revalidates against. The default
    octet-stream content type stores no mime flag (urllib's implicit
    x-www-form-urlencoded would); pass e.g. "image/png" to seed
    FLAGGED needles for the pre-rendered-header fast-path mix. Beware
    text/* and json/xml types: the write path gzips those uploads
    transparently, and gzipped needles sit OFF the C fast path."""
    keys: list[tuple[str, str]] = []
    for _ in range(n):
        with urllib.request.urlopen(
            f"http://{master}/dir/assign", timeout=10
        ) as r:
            a = json.loads(r.read())
        if "error" in a:
            raise RuntimeError(f"seed assign: {a['error']}")
        req = urllib.request.Request(
            f"http://{a['url']}/{a['fid']}", data=payload, method="POST",
            headers={"Content-Type": content_type},
        )
        # an admission-armed server sheds seed writes once the cold
        # burst drains — honor its Retry-After instead of dying
        for attempt in range(20):
            try:
                with urllib.request.urlopen(req, timeout=10) as r:
                    if etags is not None:
                        etags[a["fid"]] = json.loads(r.read()).get(
                            "eTag", ""
                        )
                break
            except urllib.error.HTTPError as e:
                if e.code != 503 or attempt == 19:
                    raise
                try:
                    delay = float(e.headers.get("Retry-After", "0.5"))
                except (TypeError, ValueError):
                    delay = 0.5
                time.sleep(min(max(delay, 0.05), 2.0))
        keys.append((a["fid"], a["url"]))
    return keys


def seed_keys_replicated(
    master: str, n: int, payload: bytes, replication: str = "010"
) -> list[tuple[str, list[str]]]:
    """Seed n blobs onto REPLICATED volumes and return every replica:
    (fid, [url, ...]) rows — the keyset shape the hedged-GET workers
    (and the slow-replica A/B) need. The POST fans out to the replicas
    server-side; /dir/lookup reports where the copies live."""
    keys: list[tuple[str, list[str]]] = []
    for _ in range(n):
        with urllib.request.urlopen(
            f"http://{master}/dir/assign?replication={replication}",
            timeout=10,
        ) as r:
            a = json.loads(r.read())
        if "error" in a:
            raise RuntimeError(f"seed assign: {a['error']}")
        urllib.request.urlopen(
            urllib.request.Request(
                f"http://{a['url']}/{a['fid']}", data=payload, method="POST",
                headers={"Content-Type": "application/octet-stream"},
            ),
            timeout=10,
        ).close()
        vid = a["fid"].partition(",")[0]
        with urllib.request.urlopen(
            f"http://{master}/dir/lookup?volumeId={vid}", timeout=10
        ) as r:
            lk = json.loads(r.read())
        urls = [loc["url"] for loc in lk.get("locations", [])] or [a["url"]]
        keys.append((a["fid"], urls))
    return keys


def _get_fan_worker(spec: dict, out_q, barrier=None) -> None:
    """One GET *fan* worker: K nonblocking keep-alive connections
    driven by a single selector loop in this process — the client-side
    shape for connection-scale serving benches (256+ concurrent
    connections across a few processes, where thread-per-connection
    clients would measure their own scheduler instead of the server).

    Each connection is closed-loop (next GET only after the previous
    response drains). With `rate` set, each connection paces against
    its own fixed schedule and latency is charged from the SCHEDULED
    send — the same coordinated-omission discipline as `_worker`. A
    `range_every` of N makes every Nth request on a connection carry a
    Range header cycling through `ranges` (mixed 200/206 traffic).

    A 503 (admission-control shed, docs/QOS.md) is counted as `shed`
    and the connection HONORS the server's Retry-After before its next
    attempt — the same contract op.http_call implements — so the
    admission A/B measures the designed backpressure loop, not a
    client that spams the server it was just refused by.

    A `cond_every` of N makes every Nth request on a connection carry
    an If-None-Match with the blob's real ETag (from `etags`): the
    conditional-GET mix, where the server revalidates with a 304 out
    of the C fast path instead of moving the body. 304s count as
    successful ops and separately as `not_modified`.

    spec: mode='get_fan', duration_s, keys, conns, rate, index,
    range_every, ranges, cond_every, etags."""
    import selectors
    import socket as _socket

    if barrier is not None:
        barrier.wait(120)

    keys = spec["keys"]
    duration = spec["duration_s"]
    rate = spec["rate"]
    nconns = spec["conns"]
    range_every = spec.get("range_every", 0)
    ranges = spec.get("ranges") or ["bytes=0-127"]
    cond_every = spec.get("cond_every", 0)
    etags = spec.get("etags") or {}
    interval = (1.0 / rate) if rate > 0 else 0.0
    hist = LogHistogram()
    shed_hist = LogHistogram()
    ops = errors = nbytes = shed = not_modified = 0
    err_samples: list[str] = []
    sel = selectors.DefaultSelector()
    start = time.perf_counter()
    deadline = start + duration

    class _Conn:
        __slots__ = ("sock", "buf", "need", "t_ref", "scheduled", "ki",
                     "nreq", "netloc", "inflight", "resume")

    def _dial(netloc: str):
        host, _, port = netloc.partition(":")
        s = _socket.create_connection((host, int(port)), timeout=30)
        s.setsockopt(_socket.IPPROTO_TCP, _socket.TCP_NODELAY, True)
        s.setblocking(False)
        return s

    def _send(c, now: float) -> None:
        fid, url = keys[c.ki % len(keys)]
        c.ki += nconns  # stride: fan the keyset across the conns
        c.nreq += 1
        hdr = b""
        if range_every and c.nreq % range_every == 0:
            hdr = b"Range: " + ranges[c.nreq % len(ranges)].encode() + b"\r\n"
        if cond_every and c.nreq % cond_every == 0:
            etag = etags.get(fid, "")
            if etag:
                hdr += (
                    b'If-None-Match: "' + etag.encode() + b'"\r\n'
                )
        req = b"GET /" + fid.encode() + b" HTTP/1.1\r\n" + hdr + b"\r\n"
        c.t_ref = c.scheduled if interval else now
        c.buf = b""
        c.need = -1
        c.inflight = True
        try:
            # a ~60B request always fits an empty send buffer, and the
            # closed loop guarantees the buffer IS empty here
            c.sock.sendall(req)
        except OSError:
            pass  # the read side sees the teardown and redials

    def _complete(c, now: float) -> bool:
        """True once the buffered bytes hold one whole response."""
        if c.need < 0:
            end = c.buf.find(b"\r\n\r\n")
            if end < 0:
                return False
            cl = 0
            for line in c.buf[:end].split(b"\r\n")[1:]:
                k, _, v = line.partition(b":")
                if k.strip().lower() == b"content-length":
                    cl = int(v.strip())
            c.need = end + 4 + cl
        return len(c.buf) >= c.need

    conns: list = []
    try:
        for i in range(nconns):
            c = _Conn()
            c.netloc = keys[(spec.get("index", 0) + i) % len(keys)][1]
            c.sock = _dial(c.netloc)
            c.ki = spec.get("index", 0) + i
            c.nreq = i  # desync the Range cadence across conns
            c.buf = b""
            c.need = -1
            c.inflight = False
            c.resume = 0.0
            # stagger schedules so paced conns don't phase-lock
            c.scheduled = start + (interval * i / nconns if interval else 0.0)
            sel.register(c.sock, selectors.EVENT_READ, c)
            conns.append(c)
        now = time.perf_counter()
        for c in conns:
            if not interval or c.scheduled <= now:
                _send(c, now)
        while True:
            now = time.perf_counter()
            if now >= deadline:
                break
            events = sel.select(timeout=0.05)
            now = time.perf_counter()
            for key, _mask in events:
                c = key.data
                try:
                    chunk = c.sock.recv(1 << 18)
                except (BlockingIOError, InterruptedError):
                    continue
                except OSError as e:
                    chunk = b""
                    if len(err_samples) < 5:
                        err_samples.append(repr(e)[:200])
                if not chunk:
                    # torn connection: count the in-flight op lost,
                    # then redial so concurrency holds
                    if c.inflight:
                        errors += 1
                        hist.record(now - c.t_ref)
                    sel.unregister(c.sock)
                    c.sock.close()
                    try:
                        c.sock = _dial(c.netloc)
                    except OSError:
                        continue  # server gone: this conn retires
                    sel.register(c.sock, selectors.EVENT_READ, c)
                    c.inflight = False
                    c.buf = b""
                    c.need = -1
                    if not interval:
                        _send(c, now)
                    continue
                c.buf += chunk
                if c.inflight and _complete(c, now):
                    status = c.buf[9:12]
                    if status in (b"200", b"206", b"304"):
                        ops += 1
                        nbytes += c.need
                        if status == b"304":
                            not_modified += 1
                        hist.record(now - c.t_ref)
                    elif status == b"503":
                        # admission-control shed (docs/QOS.md): refused
                        # by design, histogrammed apart so accepted-
                        # request quantiles stay honest; honor the
                        # server's Retry-After before this connection's
                        # next attempt
                        shed += 1
                        shed_hist.record(now - c.t_ref)
                        head = c.buf[: c.need].lower()
                        backoff = 0.5
                        idx = head.find(b"retry-after:")
                        if idx >= 0:
                            tok = head[idx + 12 : idx + 28].split(b"\r", 1)[0]
                            try:
                                backoff = float(tok.strip())
                            except ValueError:
                                pass
                        c.resume = now + min(max(backoff, 0.05), 1.0)
                    else:
                        errors += 1
                        if len(err_samples) < 5:
                            err_samples.append(
                                c.buf[:80].decode("latin-1", "replace")
                            )
                        hist.record(now - c.t_ref)
                    c.buf = c.buf[c.need :]
                    c.need = -1
                    c.inflight = False
                    if interval:
                        c.scheduled += interval
                        if c.scheduled <= now and c.resume <= now:
                            _send(c, now)  # behind schedule: CO charge
                    elif c.resume <= now:
                        _send(c, now)
            if interval:
                for c in conns:
                    if (
                        not c.inflight
                        and c.scheduled <= now
                        and c.resume <= now
                    ):
                        _send(c, now)
            else:
                # shed-backoff wakeups: a connection honoring a
                # Retry-After re-enters the closed loop here
                for c in conns:
                    if not c.inflight and c.resume and c.resume <= now:
                        c.resume = 0.0
                        _send(c, now)
    finally:
        for c in conns:
            try:
                c.sock.close()
            except OSError:
                pass
        sel.close()
    out_q.put({
        "mode": "get",
        "ops": ops,
        "errors": errors,
        "shed": shed,
        "not_modified": not_modified,
        "err_samples": err_samples,
        "bytes": nbytes,
        "hist": hist.to_row(),
        "shed_hist": shed_hist.to_row(),
        "wall_s": time.perf_counter() - start,
    })


def _scrape_serve_stats(urls: set[str]) -> dict:
    """Sum the C fast-path counters (/status ServeStats) across the
    distinct volume servers in `urls`; {} when none answer."""
    total: dict = {}
    for url in urls:
        try:
            with urllib.request.urlopen(f"http://{url}/status", timeout=5) as r:
                stats = json.loads(r.read()).get("ServeStats") or {}
        except (OSError, ValueError):
            continue
        for k, v in stats.items():
            if isinstance(v, (int, float)):
                total[k] = total.get(k, 0) + v
    return total


def run_get_fan(
    master: str,
    duration_s: float = 10.0,
    processes: int = 4,
    conns_per_proc: int = 64,
    payload_bytes: int = 1024,
    rate: float = 0.0,
    seed_n: int = 64,
    range_every: int = 0,
    ranges: list[str] | None = None,
    cond_every: int = 0,
    keys: list[tuple[str, str]] | None = None,
    etags: dict | None = None,
    mp_start: str = "spawn",
) -> dict:
    """GET-heavy connection-scale load: `processes` × `conns_per_proc`
    keep-alive connections in closed loop against the cluster at
    `master`. `rate` is per-CONNECTION req/s (0 = unpaced
    max-throughput probe; >0 = coordinated-omission-safe pacing).
    `cond_every` = N sends every Nth request per connection as a
    conditional GET (If-None-Match with the seeded ETag → 304).
    Returns the same report shape as run_load (mode 'get'), plus
    `ratio_304` and a `fast_path` block (the served/handoff counter
    deltas scraped from each volume server's /status ServeStats)."""
    payload = (b"weedload\x00\xff" * ((payload_bytes // 10) + 1))[:payload_bytes]
    if keys is None:
        etags = {} if etags is None else etags
        keys = seed_keys(master, seed_n, payload, etags=etags)
    ctx = multiprocessing.get_context(mp_start)
    out_q = ctx.Queue()
    barrier = ctx.Barrier(processes)
    vol_urls = {url for _, url in keys}
    stats_before = _scrape_serve_stats(vol_urls)
    procs = []
    for i in range(processes):
        spec = {
            "mode": "get_fan",
            "duration_s": duration_s,
            "keys": keys,
            "conns": conns_per_proc,
            "rate": rate,
            "index": i * 13,
            "range_every": range_every,
            "ranges": ranges or [],
            "cond_every": cond_every,
            "etags": etags or {},
        }
        p = ctx.Process(
            target=_get_fan_worker, args=(spec, out_q, barrier), daemon=True
        )
        p.start()
        procs.append(p)
    import queue as _queue

    rows = []
    join_deadline = time.time() + duration_s + 90.0
    while len(rows) < len(procs) and time.time() < join_deadline:
        try:
            rows.append(out_q.get(timeout=1.0))
        except _queue.Empty:
            if any(not p.is_alive() and p.exitcode != 0 for p in procs):
                break
    for p in procs:
        p.join(timeout=10)
        if p.is_alive():
            p.terminate()
    if len(rows) < len(procs):
        raise RuntimeError(
            f"weedload get_fan: only {len(rows)}/{len(procs)} workers "
            f"reported (exit codes {[p.exitcode for p in procs]})"
        )
    hist = LogHistogram()
    shed_hist = LogHistogram()
    ops = errors = nbytes = shed = not_modified = 0
    samples: list[str] = []
    for r in rows:
        hist.merge(LogHistogram.from_row(r["hist"]))
        if r.get("shed_hist"):
            shed_hist.merge(LogHistogram.from_row(r["shed_hist"]))
        ops += r["ops"]
        errors += r["errors"]
        shed += r.get("shed", 0)
        not_modified += r.get("not_modified", 0)
        nbytes += r["bytes"]
        samples.extend(r["err_samples"])
    wall = max(r["wall_s"] for r in rows)
    report = _summarize(hist, ops, errors, nbytes, wall)
    report["shed"] = shed
    if shed:
        report["shed_p99_ms"] = round(shed_hist.quantile(0.99) * 1e3, 3)
    report["not_modified"] = not_modified
    report["ratio_304"] = round(not_modified / ops, 4) if ops else 0.0
    # C fast-path accounting over the run: served/handoffs deltas from
    # every volume server the keyset touches (hit ratio = the fraction
    # of requests that never left the C loop)
    stats_after = _scrape_serve_stats(vol_urls)
    if stats_after:
        delta = {
            k: stats_after.get(k, 0) - stats_before.get(k, 0)
            for k in ("served", "not_modified", "cache_hits", "handoffs")
        }
        denom = delta["served"] + delta["handoffs"]
        delta["hit_ratio"] = (
            round(delta["served"] / denom, 4) if denom else 0.0
        )
        report["fast_path"] = delta
    report["err_samples"] = samples[:5]
    report["config"] = {
        "master": master,
        "duration_s": duration_s,
        "processes": processes,
        "conns_per_proc": conns_per_proc,
        "connections": processes * conns_per_proc,
        "payload_bytes": payload_bytes,
        "rate_per_conn": rate,
        "range_every": range_every,
        "cond_every": cond_every,
        "coordinated_omission_safe": rate > 0,
    }
    return report


def _summarize(hist: LogHistogram, ops: int, errors: int, nbytes: int,
               wall_s: float) -> dict:
    return {
        "ops": ops,
        "errors": errors,
        "req_per_sec": round(ops / wall_s, 2) if wall_s > 0 else 0.0,
        "mb_per_sec": round(nbytes / wall_s / 1e6, 3) if wall_s > 0 else 0.0,
        "p50_ms": round(hist.quantile(0.50) * 1e3, 3),
        "p99_ms": round(hist.quantile(0.99) * 1e3, 3),
        "p999_ms": round(hist.quantile(0.999) * 1e3, 3),
        "max_ms": round(hist.max * 1e3, 3),
        "mean_ms": round(hist.sum / hist.total * 1e3, 3) if hist.total else 0.0,
    }


def run_load(
    master: str,
    duration_s: float = 10.0,
    writers: int = 2,
    readers: int = 2,
    payload_bytes: int = 1024,
    rate: float = 0.0,
    seed_n: int = 64,
    mp_start: str = "spawn",
    mixed: int = 0,
    hedge: bool = False,
    keys: list | None = None,
    verify_bytes: int = 0,
) -> dict:
    """Drive writers+readers(+mixed) worker PROCESSES against the
    cluster at `master`; returns the merged report. `rate` is
    per-worker target req/s (0 = unpaced closed loop). `mp_start` picks
    the multiprocessing start method — spawn (default) never inherits
    the parent's threads/locks, which matters when the caller embeds
    in-process servers.

    QoS knobs (docs/QOS.md): `mixed` adds workers alternating PUT and
    GET (cross-plane contention in one closed loop); `hedge` routes
    GETs through the hedged-read driver — pass `keys` rows shaped
    (fid, [replica_url, ...]) (seed_keys_replicated builds them; a
    caller injecting a slow replica rewrites one url to its proxy).
    The report carries hedge fired/won/cancelled counts and `shed`
    (503-refused requests, histogrammed apart from accepted ones).

    `verify_bytes` (the degraded-GET worker, docs/SCRUB.md): GET bodies
    whose length differs are counted as errors — drives real degraded
    traffic against an EC volume with a DeadShard and certifies the
    reconstruction, not just the status code."""
    if writers <= 0 and readers <= 0 and mixed <= 0:
        raise ValueError("need at least one worker")
    # \x00\xff keeps the body ungzippable so the write path stays honest
    payload = (b"weedload\x00\xff" * ((payload_bytes // 10) + 1))[:payload_bytes]
    if keys is None:
        keys = (
            seed_keys(master, seed_n, payload)
            if readers > 0 or mixed > 0
            else []
        )
    ctx = multiprocessing.get_context(mp_start)
    out_q = ctx.Queue()
    n_workers = writers + readers + mixed
    barrier = ctx.Barrier(n_workers)
    procs = []
    for i in range(n_workers):
        spec = {
            "mode": (
                "put" if i < writers
                else "get" if i < writers + readers
                else "mixed"
            ),
            "master": master,
            "duration_s": duration_s,
            "payload": payload,
            "rate": rate,
            "keys": keys,
            "index": i * 7,
            "hedge": hedge,
            "verify_bytes": verify_bytes,
        }
        p = ctx.Process(
            target=_worker, args=(spec, out_q, barrier), daemon=True
        )
        p.start()
        procs.append(p)
    import queue as _queue

    rows = []
    join_deadline = time.time() + duration_s + 60.0
    while len(rows) < len(procs) and time.time() < join_deadline:
        try:
            rows.append(out_q.get(timeout=1.0))
        except _queue.Empty:
            # a worker that died before posting (OOM kill, spawn
            # bootstrap failure) must surface as a named error, not a
            # 60s hang ending in a raw queue.Empty
            dead = [
                p for p in procs if not p.is_alive() and p.exitcode != 0
            ]
            if dead and len(rows) + sum(1 for p in procs if p.is_alive()) < len(procs):
                break
    for p in procs:
        p.join(timeout=10)
        if p.is_alive():
            p.terminate()
    if len(rows) < len(procs):
        codes = [p.exitcode for p in procs]
        raise RuntimeError(
            f"weedload: only {len(rows)}/{len(procs)} workers reported "
            f"(exit codes {codes}) — a worker died before posting results"
        )
    report: dict = {
        "config": {
            "master": master,
            "duration_s": duration_s,
            "writers": writers,
            "readers": readers,
            "mixed": mixed,
            "hedge": hedge,
            "payload_bytes": payload_bytes,
            "rate_per_worker": rate,
            "coordinated_omission_safe": rate > 0,
            "processes": len(procs),
        },
    }
    for mode in ("put", "get", "mixed"):
        mode_rows = [r for r in rows if r["mode"] == mode]
        if not mode_rows:
            continue
        hist = LogHistogram()
        shed_hist = LogHistogram()
        ops = errors = nbytes = shed = 0
        hedge_fired = hedge_won = hedge_cancelled = 0
        wall = 0.0
        samples: list[str] = []
        for r in mode_rows:
            hist.merge(LogHistogram.from_row(r["hist"]))
            if r.get("shed_hist"):
                shed_hist.merge(LogHistogram.from_row(r["shed_hist"]))
            ops += r["ops"]
            errors += r["errors"]
            shed += r.get("shed", 0)
            nbytes += r["bytes"]
            wall = max(wall, r["wall_s"])
            samples.extend(r["err_samples"])
            hstats = r.get("hedge") or {}
            hedge_fired += hstats.get("fired", 0)
            hedge_won += hstats.get("won", 0)
            hedge_cancelled += hstats.get("cancelled", 0)
        report[mode] = _summarize(hist, ops, errors, nbytes, wall)
        report[mode]["shed"] = shed
        if shed:
            report[mode]["shed_p99_ms"] = round(
                shed_hist.quantile(0.99) * 1e3, 3
            )
        if hedge:
            report[mode]["hedge_fired"] = hedge_fired
            report[mode]["hedge_won"] = hedge_won
            report[mode]["hedge_cancelled"] = hedge_cancelled
        if samples:
            report[mode]["err_samples"] = samples[:5]
    return report
