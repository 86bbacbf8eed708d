"""-cpuprofile support (reference command/benchmark.go:64,
master.go:74, server.go:66 pprof.StartCPUProfile): profile the run and
dump pstats to the given path on shutdown; the file loads with
`python -m pstats <path>` (the pprof-viewer role).

Profilers attach per thread, so enabling one on the main thread alone
would miss all real work (gRPC executors, benchmark workers). A
threading.setprofile trampoline bootstraps a profiler in every thread
created inside the context; stats from threads that finished by dump
time are aggregated with the main thread's (threads still running at
exit are skipped — a profiler cannot be safely disabled cross-thread).
The main thread gets the fast C profiler; worker threads get the
pure-Python `profile.Profile`, because CPython 3.12 registers the C
profiler as a process-exclusive sys.monitoring tool — only one
instance may be active at a time."""

from __future__ import annotations

import threading


class CpuProfile:
    def __init__(self, path: str):
        self.path = path
        self._main = None
        self._thread_profiles: list = []
        self._lock = threading.Lock()
        self._prev_hook = None
        self._stopped = False

    def __enter__(self):
        if not self.path:
            return self
        import cProfile
        import sys

        outer = self

        import profile as pyprofile

        def bootstrap(frame, event, arg):
            # first profile event in a new thread: replace this
            # trampoline with a per-thread pure-Python profiler (the C
            # profiler is process-exclusive under 3.12 sys.monitoring)
            sys.setprofile(None)
            prof = pyprofile.Profile()
            with outer._lock:
                outer._thread_profiles.append(
                    (threading.current_thread(), prof)
                )

            def tolerant(fr, ev, a):
                # installed mid-stack: frames below the install point
                # unwind at thread exit without matching call events;
                # stop profiling this thread at that boundary — and as
                # soon as the context exits (long-lived threads must
                # not keep paying profiler overhead forever)
                if outer._stopped:
                    sys.setprofile(None)
                    return
                try:
                    return prof.dispatcher(fr, ev, a)
                except AssertionError:
                    sys.setprofile(None)

            sys.setprofile(tolerant)

        self._prev_hook = getattr(threading, "_profile_hook", None)
        threading.setprofile(bootstrap)
        self._main = cProfile.Profile()
        self._main.enable()
        return self

    def __exit__(self, *exc):
        if self._main is None:
            return
        import pstats

        self._stopped = True
        self._main.disable()
        threading.setprofile(self._prev_hook)
        stats = pstats.Stats(self._main)
        skipped = 0
        with self._lock:
            for thread, prof in self._thread_profiles:
                if thread.is_alive():
                    # cannot disable another thread's profiler — its
                    # samples never reach the dump
                    skipped += 1
                    continue
                try:
                    stats.add(prof)
                except Exception:  # noqa: BLE001 - partial stats are fine
                    pass
        if skipped:
            from seaweedfs_tpu_torch.util import wlog

            wlog.warning(
                "cpuprofile %s: %d thread(s) still running at exit; "
                "their samples were skipped (the continuous sampler at "
                "/debug/profile covers long-lived threads)",
                self.path,
                skipped,
            )
        stats.dump_stats(self.path)
