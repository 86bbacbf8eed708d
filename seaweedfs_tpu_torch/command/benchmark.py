"""`benchmark` — concurrent write/read load generator with latency
histograms, the reference's perf-testing product feature
(weed/command/benchmark.go:53-66 flags, :377-514 stats printer); the
port of seaweedfs_tpu/command/benchmark.py.
"""

from __future__ import annotations

import argparse
import random
import threading
import time

from seaweedfs_tpu_torch.command import Command, register

PERCENTAGES = (50, 66, 75, 80, 90, 95, 98, 99, 100)


class LatencyStats:
    """Fixed-bucket latency collector mirroring the reference's
    benchmark stats: req/s, MB/s, percentile table, distribution."""

    def __init__(self):
        self._lock = threading.Lock()
        self.latencies_ms: list[float] = []
        self.bytes = 0
        self.completed = 0
        self.failed = 0
        self.start = time.perf_counter()
        # run_benchmark stamps phase end after the worker joins so
        # programmatic callers can compute req/s from
        # the phase wall, not report() time
        self.ended: float | None = None

    def add(self, latency_sec: float, nbytes: int, ok: bool = True) -> None:
        with self._lock:
            if ok:
                self.completed += 1
                self.bytes += nbytes
                self.latencies_ms.append(latency_sec * 1000.0)
            else:
                self.failed += 1

    def local(self) -> "_LocalStats":
        """Per-worker accumulator: the hot loop records without touching
        the shared lock (the reference streams per-request stats over a
        channel to one aggregator goroutine, benchmark.go:377 — same
        idea: no cross-thread contention per request)."""
        return _LocalStats(self)

    def report(self, title: str, concurrency: int) -> str:
        elapsed = time.perf_counter() - self.start
        lat = sorted(self.latencies_ms)
        n = len(lat)
        lines = [
            f"\n------------ {title} ----------",
            f"Concurrency Level:      {concurrency}",
            f"Time taken for tests:   {elapsed:.3f} seconds",
            f"Complete requests:      {self.completed}",
            f"Failed requests:        {self.failed}",
            f"Total transferred:      {self.bytes} bytes",
            f"Requests per second:    {self.completed / elapsed:.2f} [#/sec]",
            f"Transfer rate:          {self.bytes / 1024.0 / elapsed:.2f} [Kbytes/sec]",
        ]
        if n:
            avg = sum(lat) / n
            std = (sum((x - avg) ** 2 for x in lat) / n) ** 0.5
            lines += [
                "\nConnection Times (ms)",
                "              min      avg        max      std",
                f"Total:        {lat[0]:.1f}      {avg:.1f}       {lat[-1]:.1f}      {std:.1f}",
                "\nPercentage of the requests served within a certain time (ms)",
            ]
            for p in PERCENTAGES:
                idx = min(n - 1, max(0, int(n * p / 100) - 1))
                lines.append(f"   {p}% {lat[idx]:>9.1f} ms")
        return "\n".join(lines)


class _LocalStats:
    __slots__ = ("_parent", "latencies_ms", "bytes", "completed", "failed")

    def __init__(self, parent: LatencyStats):
        self._parent = parent
        self.latencies_ms: list[float] = []
        self.bytes = 0
        self.completed = 0
        self.failed = 0

    def add(self, latency_sec: float, nbytes: int, ok: bool = True) -> None:
        if ok:
            self.completed += 1
            self.bytes += nbytes
            self.latencies_ms.append(latency_sec * 1000.0)
        else:
            self.failed += 1

    def merge(self) -> None:
        p = self._parent
        with p._lock:
            p.completed += self.completed
            p.bytes += self.bytes
            p.failed += self.failed
            p.latencies_ms.extend(self.latencies_ms)


@register
class BenchmarkCommand(Command):
    name = "benchmark"
    help = "load-test the cluster: concurrent writes then random reads"

    def add_arguments(self, p: argparse.ArgumentParser) -> None:
        p.add_argument(
            "-master", default="127.0.0.1:9333",
            help="master address host:port",
        )
        p.add_argument(
            "-c", dest="concurrency", type=int, default=16,
            help="concurrent worker threads",
        )
        p.add_argument(
            "-n", dest="num", type=int, default=1024 * 1024,
            help="total files to write/read",
        )
        p.add_argument("-size", type=int, default=1024, help="payload bytes per file")
        p.add_argument(
            "-collection", default="benchmark",
            help="collection to write into",
        )
        p.add_argument(
            "-replication", default="000",
            help="replication policy like 001",
        )
        # the reference's -write=true/-read=false spelling: single-dash
        # flags get no --no- negative form from BooleanOptionalAction,
        # so write-only / read-only runs need the =bool style
        def _bool(v: str) -> bool:
            return v.lower() not in ("false", "0", "no")

        p.add_argument(
            "-write", type=_bool, nargs="?", const=True, default=True,
            help="=false skips the write phase (read-only run)",
        )
        p.add_argument(
            "-read", type=_bool, nargs="?", const=True, default=True,
            help="=false skips the read phase (write-only run)",
        )
        p.add_argument(
            "-deletePercent", type=int, default=0,
            help="percentage of written files to delete during reads",
        )
        p.add_argument(
            "-cpuprofile", default="", help="dump pstats profile here on exit"
        )

    def run(self, args) -> int:
        from seaweedfs_tpu_torch.command.servers import _tune_gc
        from seaweedfs_tpu_torch.util.profiling import CpuProfile

        _tune_gc()  # the load generator is as hot as the daemons
        with CpuProfile(args.cpuprofile):
            return self._run(args)

    def _run(self, args) -> int:
        stats, fids = run_benchmark(
            master=args.master,
            concurrency=args.concurrency,
            num=args.num,
            size=args.size,
            collection=args.collection,
            replication=args.replication,
            do_write=args.write,
            do_read=args.read,
            delete_percent=args.deletePercent,
        )
        for title, s in stats:
            print(s.report(title, args.concurrency))
        return 0


def run_benchmark(
    master: str,
    concurrency: int = 4,
    num: int = 1024,
    size: int = 1024,
    collection: str = "benchmark",
    replication: str = "000",
    do_write: bool = True,
    do_read: bool = True,
    delete_percent: int = 0,
):
    """Programmatic entry (also used by tests); returns
    ([(title, LatencyStats)], written_fids)."""
    from seaweedfs_tpu_torch.client import operation as op

    results = []
    fids: list[str] = []
    fid_lock = threading.Lock()

    if do_write:
        stats = LatencyStats()
        counter = iter(range(num))
        counter_lock = threading.Lock()
        rng = random.Random(1)
        payload = bytes(rng.randrange(256) for _ in range(size))

        def writer():
            local = stats.local()
            local_fids = []
            while True:
                with counter_lock:
                    try:
                        next(counter)
                    except StopIteration:
                        break
                t0 = time.perf_counter()
                try:
                    ar = op.assign(
                        master, collection=collection, replication=replication
                    )
                    ur = op.upload(
                        f"{ar.url}/{ar.fid}", payload, filename="bench.bin", jwt=ar.auth
                    )
                    ok = not ur.error
                    if ok:
                        if delete_percent and random.randrange(100) < delete_percent:
                            op.delete_files(master, [ar.fid])
                        else:
                            # deleted fids stay out of the read pool so
                            # the read phase doesn't report their 404s
                            # as failures
                            local_fids.append(ar.fid)
                except Exception:
                    ok = False
                local.add(time.perf_counter() - t0, size, ok)
            local.merge()
            with fid_lock:
                fids.extend(local_fids)

        threads = [threading.Thread(target=writer) for _ in range(concurrency)]
        for t in threads:
            t.start()
        for t in threads:
            t.join()
        stats.ended = time.perf_counter()
        results.append((f"Writing Benchmark ({num} x {size}B)", stats))

    if do_read and fids:
        stats = LatencyStats()
        counter = iter(range(num))
        counter_lock = threading.Lock()

        def reader():
            rng = random.Random(threading.get_ident())
            local = stats.local()
            while True:
                with counter_lock:
                    try:
                        next(counter)
                    except StopIteration:
                        break
                fid = rng.choice(fids)
                t0 = time.perf_counter()
                try:
                    url = op.lookup_file_id(master, fid)
                    data, _ = op.download(url)
                    local.add(time.perf_counter() - t0, len(data), True)
                except Exception:
                    local.add(time.perf_counter() - t0, 0, False)
            local.merge()

        threads = [threading.Thread(target=reader) for _ in range(concurrency)]
        for t in threads:
            t.start()
        for t in threads:
            t.join()
        stats.ended = time.perf_counter()
        results.append((f"Random Read Benchmark ({num} reads)", stats))

    return results, fids
