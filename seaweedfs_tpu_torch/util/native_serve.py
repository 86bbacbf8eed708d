"""Driver for the event-driven serving core (csrc/serve.c).

The port of seaweedfs_tpu/util/native_serve.py.

`WeedHTTPServer.serve_forever` lands here first: unless
`WEED_NATIVE_SERVE` is 0, the server's accept/
read/dispatch edge runs as ONE C epoll loop instead of a thread per
connection —

  * fast-path GET/HEAD requests (the owning daemon installed a
    `server.fast_resolver`) are answered without leaving the loop:
    the resolver maps the request to a pre-formatted response prefix
    plus either small in-memory bytes or a (fd, offset, count)
    sendfile plan, and the loop writes it zero-copy;
  * every other request HANDS THE CONNECTION OFF: the loop transfers
    the fd and its unconsumed buffer here, and the connection finishes
    its life in a `serve_connection` thread — the same threaded mini
    loop the kill switch falls back to, driving the same do_* handler
    methods, so slow paths have exactly one implementation;
  * per-response completion callbacks keep the tracing plane and the
    /metrics counters identical to the threaded path: a span per
    traced request (named `<role>.get`/`<role>.head`), stage timings
    parse/resolve/send attached the way the C POST span attaches
    parse/assemble/crc/pwrite/reply, and the
    weed_http_request_* counter/histogram labeled as ever.

The `_serve_ext` extension (csrc/serve_ext.c over serve.c) is built
the first time a loop starts, an admission bucket is attached, or the
serving counters are read. A build that fails, or a loop that cannot
arm, raises RuntimeError: the threaded path is chosen only by a switch,
never as a quiet fallback. The switches: WEED_NATIVE_SERVE=0 restores
the pure-Python threaded path wholesale, and a server whose
`native_serve` attribute is False runs it alone.
"""

from __future__ import annotations

import os
import socket
import threading

from seaweedfs_tpu_torch import _build
from seaweedfs_tpu_torch.native.ext import serve_ext as _ext


def _loaded():
    """The serving-core module if this process has loaded it, else
    None: no loop, plan cache or bucket exists before it is loaded."""
    return _build._exts.get("serve_ext.c")


NATIVE_SERVE_ENABLED = os.environ.get("WEED_NATIVE_SERVE", "1") != "0"
# C-side plan cache (fd/offset/prefix keyed by path). Independent kill
# switch: WEED_SERVE_CACHE=0 forces every plan non-cacheable so each
# request re-resolves, while the rest of the fast path stays native.
SERVE_CACHE_ENABLED = os.environ.get("WEED_SERVE_CACHE", "1") != "0"

# Stage names attached to a fast-path GET span — the serving-loop
# counterpart of write_path.WRITE_STAGES (docs/TRACING.md): parse is
# the C head parse, resolve the Python needle lookup, send the
# header write + sendfile drain.
SERVE_STAGES = ("parse", "resolve", "send")


def available() -> bool:
    """True when servers run the epoll serving core (the default; it is
    built when the first loop starts)."""
    return NATIVE_SERVE_ENABLED


def bump_generation() -> int:
    """Advance the plan-cache generation counter (process-global).

    The storage layer calls this on ANY mutation that could invalidate
    a cached (fd, offset, size, headers) plan: needle write, delete,
    vacuum fd-swap, remount.  Cheap (one relaxed atomic add); before
    the extension is loaded no plan is cached, so there is nothing to
    invalidate and nothing is built."""
    ext = _loaded()
    if ext is None:
        return 0
    return ext.gen_bump()


def generation() -> int:
    """Current plan-cache generation (0 before the extension is loaded)."""
    ext = _loaded()
    if ext is None:
        return 0
    return ext.gen_get()


def serve_stats() -> dict:
    """Process-wide C fast-path counters; empty before the extension is
    loaded (no C loop has run in this process, so there is nothing to
    count, and the threaded arm never builds it)."""
    ext = _loaded()
    if ext is None:
        return {}
    return ext.serve_stats()


def admission_shm_attach(
    path: str,
    rate: float,
    burst: float,
    retry_floor: float = 0.0,
    nslots: int = 1024,
) -> bool:
    """Map the shared admission token-bucket file (creating it when
    first).  Process-global and idempotent; True once attached (the
    extension is built on first use, and a failed build raises)."""
    _ext().shm_attach(path, float(rate), float(burst),
                      float(retry_floor), int(nslots))
    return True


def admission_shm_admit(key: str) -> float:
    """Charge one request against the shared bucket for `key`.

    0.0 = admitted; positive = rejected, value is the suggested
    Retry-After in seconds.  Raises RuntimeError when not attached."""
    ext = _loaded()
    if ext is None:
        raise RuntimeError("admission shm not attached")
    return ext.shm_admit(key)


def admission_shm_detach() -> None:
    ext = _loaded()
    if ext is not None:
        ext.shm_detach()


def try_serve_forever(server) -> bool:
    """Run `server`'s accept loop on the C epoll core. False = the
    caller runs the threaded socketserver path, which happens only when
    a switch asks for it (WEED_NATIVE_SERVE=0, or the server's
    `native_serve` attribute False).

    Arming: `server._serve_native` is set True just before the loop is
    entered, and stays True for the server's lifetime. When the
    extension cannot be built or the loop cannot start, it is set False
    with the error in `server._serve_error`, and the error is raised:
    `WeedHTTPServer.wait_armed` (which a daemon's start() calls) raises
    it to the caller instead of leaving a server that answers nothing."""
    # per-server opt-out: embedders (and the threaded control arm of
    # the identity tests) can pin one server to the threaded path while
    # the process default stays native
    if not available() or not getattr(server, "native_serve", True):
        return False
    try:
        ext = _ext()
        wake_r, wake_w = os.pipe()
    except (RuntimeError, OSError) as e:
        _fail(server, e)
        raise
    os.set_blocking(wake_r, False)
    done = threading.Event()
    resolve, handoff, complete = _callbacks(server)
    # C-side shared-bucket admission: only when this listener is gated
    # by a SHARED controller (internal listeners have no admission and
    # must never be charged; a per-process bucket stays in Python)
    adm = getattr(server, "admission", None)
    use_adm = 0
    if adm is not None and getattr(adm, "shared", False):
        from seaweedfs_tpu_torch import qos as _qos

        # kill-switch parity: WEED_QOS_ADMISSION=0 set at start keeps
        # the C loop from shedding, like the Python gate (the Python
        # side re-reads the env per request; the native loop latches
        # it here — flipping it mid-run needs a restart)
        use_adm = 1 if _qos.enabled("admission") else 0
    # _serve_native stays True for the server's LIFETIME (not just
    # while the loop runs): a second shutdown() — double stop()s are
    # normal in teardown paths — must be a no-op here, never fall
    # through to socketserver.shutdown(), which would wait forever on
    # an __is_shut_down event the stdlib loop (which never ran) will
    # never set
    server._serve_wake_w = wake_w
    server._serve_done = done
    server._serve_native = True
    try:
        ext.loop(
            server.socket.fileno(),
            wake_r,
            resolve,
            handoff,
            complete,
            int(getattr(server, "serve_idle_ms", 0) or 0),
            int(getattr(server, "serve_max_reqs", 0) or 0),
            use_adm,
        )
    except (OSError, ValueError) as e:
        # loop setup failed (epoll exhausted, listen fd gone): the
        # server answers nothing, so say so loudly
        server._serve_wake_w = None
        _fail(server, e)
        done.set()
        try:
            os.close(wake_w)
        finally:
            os.close(wake_r)
        raise RuntimeError(f"the C serving loop could not start: {e}") from e
    done.set()
    os.close(wake_r)
    # wake_w stays open until shutdown() (a shutdown racing loop exit
    # must still have a valid fd to write); server_close is too late
    # only for the exotic never-shutdown case, which leaks one pipe fd
    # per server object.
    return True


def _fail(server, err: BaseException) -> None:
    """Mark `server` as a serve loop that could not arm (the False
    marker ends shutdown()'s and wait_armed()'s arming waits)."""
    server._serve_error = err
    server._serve_native = False


def shutdown(server) -> bool:
    """Stop a native serve loop. False = this server never ran the
    native loop (caller should run the stdlib shutdown). Idempotent:
    a repeated shutdown of a native server returns True and does
    nothing."""
    if getattr(server, "_serve_error", None) is not None:
        return True  # the loop never armed: nothing runs to stop
    if not getattr(server, "_serve_native", False):
        return False
    wake_w = getattr(server, "_serve_wake_w", None)
    if wake_w is None:
        return True  # already shut down (or the loop already exited)
    try:
        os.write(wake_w, b"x")
    except OSError:
        pass  # loop already gone
    server._serve_done.wait(5.0)
    server._serve_wake_w = None
    try:
        os.close(wake_w)
    except OSError:
        pass
    return True


def _callbacks(server):
    """Build the (resolve, handoff, complete) trio around `server`.
    Everything the per-request path touches is hoisted into closure
    locals — the loop thread should read its own warm frame, not
    chase module attributes (the docs/TRACING.md cold-line rule)."""
    from seaweedfs_tpu_torch import trace as _trace
    from seaweedfs_tpu_torch.stats.metrics import (
        HTTP_REQUEST_COUNTER,
        HTTP_REQUEST_HISTOGRAM,
    )
    from seaweedfs_tpu_torch.trace import blackbox as _blackbox
    from seaweedfs_tpu_torch.util.httpd import serve_connection

    handler_cls = server.RequestHandlerClass
    trace_label = getattr(server, "trace_name", "")
    trace_node = getattr(server, "trace_node", "")
    # QoS plane (docs/QOS.md): fast-path GETs never enter the Python
    # dispatch funnel, so without this the heartbeat in_flight signal
    # under-reports a node saturated by zero-copy reads. resolve()
    # enters, complete() exits — the C loop fires complete() exactly
    # once per resolved response, including connection-lost teardowns
    # (weed_conn_release_resp runs on every destroy path).
    load_tracker = getattr(server, "load_tracker", None)
    open_span, close_span, sample_hit = _trace.loop_tracer(trace_node)
    trace_enabled = _trace.enabled
    hist_observe = HTTP_REQUEST_HISTOGRAM.observe
    put_exemplar = HTTP_REQUEST_HISTOGRAM.put_exemplar
    counter_labels = HTTP_REQUEST_COUNTER.labels
    # weedscope flight recorder: fast-path completions record the SAME
    # wide-event the threaded funnel records — stage names and status
    # identity across arms is tested (tests/test_native_serve.py)
    bb_record = _blackbox.recorder(trace_label, trace_node)
    get_name = f"{trace_label or 'http'}.get"
    head_name = f"{trace_label or 'http'}.head"
    import time as _time

    clock = _time.perf_counter

    cache_on = SERVE_CACHE_ENABLED

    def resolve(path, rng, head_only, trace_hdr, inm):
        # `fast_resolver` is re-read per request: the volume server
        # installs it before serve_forever, but a daemon that never
        # does simply declines everything (gateways)
        fr = server.fast_resolver
        if fr is None:
            return None
        plan = fr(path, rng, head_only)
        if plan is None:
            return None
        if len(plan) == 6:
            # legacy plan: carries no validator, so a conditional GET
            # must fall through to the threaded arm for the 304 check
            if inm is not None:
                return None
            status, prefix, body, fd, off, count = plan
            etag = prefix304 = None
            gen = cacheable = 0
        else:
            (status, prefix, body, fd, off, count,
             etag, prefix304, gen, cacheable) = plan
            if not cache_on:
                cacheable = 0
        sp = None
        if trace_enabled() and (trace_hdr or sample_hit()):
            sp = open_span(
                head_name if head_only else get_name,
                trace_hdr or None,
                0,
                clock(),
            )
        if load_tracker is not None:
            load_tracker.enter()  # exited in complete(); nothing can
            # raise between here and the loop owning the token
        return (
            status,
            prefix,
            body,
            fd,
            off,
            count,
            fd >= 0,  # the loop closes the per-request dup'd fd
            (sp, "HEAD" if head_only else "GET"),
            etag,
            prefix304,
            gen,
            1 if cacheable else 0,
        )

    def handoff(fd, pending, ip, port, nreqs):
        # once socket() succeeds the fd has an owner whose destructor
        # closes it — from that point NOTHING may propagate to the C
        # glue, whose error path close(fd) would double-close a number
        # a concurrent thread may already have reused (a raise BEFORE
        # ownership is fine: the glue's close is then the only one)
        sock = socket.socket(fileno=fd)
        try:
            sock.setblocking(True)
            threading.Thread(
                target=_drive_handoff,
                args=(sock, (ip, port), server, handler_cls, pending, nreqs),
                daemon=True,
                name="weed-serve-handoff",
            ).start()
        except Exception as e:  # thread exhaustion under extreme load
            from seaweedfs_tpu_torch.util import wlog

            wlog.warning("serve handoff dropped %s:%s: %s", ip, port, e)
            try:
                sock.close()
            except OSError:
                pass

    def _drive_handoff(sock, addr, srv, cls, pending, nreqs):
        try:
            # initial_reqs: responses the C loop already served on this
            # connection — -serveMaxReqs keeps counting, not restarts
            serve_connection(
                sock, addr, srv, cls, initial=pending, initial_reqs=nreqs
            )
        finally:
            try:
                sock.shutdown(socket.SHUT_WR)
            except OSError:
                pass
            sock.close()

    def complete(ctx, status, nbytes, t_parse, t_resolve, t_send, ok):
        if load_tracker is not None:
            load_tracker.exit()
        sp, cmd = ctx
        stages = {"parse": t_parse, "resolve": t_resolve, "send": t_send}
        if sp is not None:
            sp.add_stages(stages)  # adopts the dict; blackbox shares it
            if not ok and not sp.error:
                sp.error = "connection lost mid-response"
            close_span(sp, status)
        dur = sp.duration if sp is not None else t_parse + t_resolve + t_send
        if trace_label:
            hist_observe(dur, trace_label, cmd)
            counter_labels(trace_label, cmd, str(status)).inc()
            if sp is not None:
                put_exemplar(dur, sp.trace_id, trace_label, cmd)
        bb_record(
            cmd,
            sp.trace_id if sp is not None else "",
            sp.plane if sp is not None else "serve",
            status,
            dur,
            nbytes,
            "",  # the C loop doesn't surface the peer address here
            _blackbox.FLAG_SHED if status == 503
            else _blackbox.FLAG_DEADLINE if status == 504 else 0,
            stages,
        )

    return resolve, handoff, complete
