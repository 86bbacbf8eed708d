"""Leveled verbose logging, the glog idiom on top of stdlib logging.

Behavioral match of the reference's vendored glog (weed/glog/glog.go:204
`V(n)` guards, per-module overrides via `-vmodule=pattern=N`
glog.go:1000+, severity files with rotation): messages carry a verbosity
level 0-4; `V(n)` is cheap and returns a no-op logger unless enabled
either globally (`set_verbosity`) or for the calling module
(`set_vmodule`). Severity logging (info/warning/error/fatal) is always
on. Output goes to stderr and optionally to size-rotated files in
`log_dir`, mirroring `weed -logdir`.
"""

from __future__ import annotations

import contextvars
import fnmatch
import inspect
import logging
import logging.handlers
import os
import sys
import threading

# Current request (trace) ID: every V(n)/severity line emitted inside
# a traced request is automatically prefixed `[<trace_id>]`, so
# grepping a log for one request ID yields its full cross-module
# story. Two sources, checked per LOG LINE (never per request — log
# lines are rare, requests are not): the `request_id` contextvar for
# explicit stamping by non-traced code, then a provider callback the
# tracing plane registers to expose its current span's trace id
# (the tracing plane keeps that in a thread-local; pulling it lazily
# here keeps the request hot path free of per-span contextvar writes).
request_id: contextvars.ContextVar[str] = contextvars.ContextVar(
    "weed_request_id", default=""
)

_rid_provider = None


def set_request_id_provider(fn) -> None:
    """Register a zero-arg callable returning the current request
    (trace) ID or "" — consulted when the contextvar is unset."""
    global _rid_provider
    _rid_provider = fn


def _rid_prefix(msg: str) -> str:
    rid = request_id.get()
    if not rid and _rid_provider is not None:
        rid = _rid_provider()
    if not rid:
        return msg
    # rid lands inside a %-format string handed to logging with args;
    # ids are hex-validated at the trust boundary, but escape anyway so
    # an exotic provider value can never corrupt the format
    if "%" in rid:
        rid = rid.replace("%", "%%")
    return f"[{rid}] {msg}"


_lock = threading.Lock()
_verbosity = 0
_vmodule: list[tuple[str, int]] = []  # (module-name glob, level)
_logger = logging.getLogger("seaweedfs_tpu_torch")
_configured = False

MAX_LOG_FILE_BYTES = 1 << 26  # rotate like glog's MaxSize
FATAL_EXIT_CODE = 255


def _ensure_configured() -> None:
    global _configured
    if _configured:
        return
    with _lock:
        if _configured:
            return
        handler = logging.StreamHandler(sys.stderr)
        handler.setFormatter(
            logging.Formatter(
                "%(levelname).1s%(asctime)s %(module)s:%(lineno)d] %(message)s",
                datefmt="%m%d %H:%M:%S",
            )
        )
        _logger.addHandler(handler)
        _logger.setLevel(logging.INFO)
        _logger.propagate = False
        _configured = True


def set_log_dir(log_dir: str, program: str = "weed") -> None:
    """Also write rotating log files under log_dir (glog file output)."""
    _ensure_configured()
    os.makedirs(log_dir, exist_ok=True)
    handler = logging.handlers.RotatingFileHandler(
        os.path.join(log_dir, f"{program}.log"),
        maxBytes=MAX_LOG_FILE_BYTES,
        backupCount=5,
    )
    handler.setFormatter(
        logging.Formatter(
            "%(levelname).1s%(asctime)s %(module)s:%(lineno)d] %(message)s",
            datefmt="%m%d %H:%M:%S",
        )
    )
    with _lock:
        _logger.addHandler(handler)


def set_verbosity(level: int) -> None:
    """Global -v level; V(n) logs iff n <= level (or a vmodule match)."""
    global _verbosity
    _verbosity = int(level)


def set_vmodule(spec: str) -> None:
    """-vmodule="volume*=2,master_server=3" per-module verbosity."""
    global _vmodule
    pats = []
    for part in spec.split(","):
        part = part.strip()
        if not part:
            continue
        name, _, lvl = part.partition("=")
        pats.append((name, int(lvl or 0)))
    with _lock:
        _vmodule = pats


def _caller_module(depth: int = 2) -> str:
    frame = inspect.stack()[depth]
    mod = os.path.basename(frame.filename)
    return mod[:-3] if mod.endswith(".py") else mod


class _Verbose:
    """Result of V(n): .info/.infof log only when the guard passed."""

    __slots__ = ("enabled",)

    def __init__(self, enabled: bool):
        self.enabled = enabled

    def __bool__(self) -> bool:
        return self.enabled

    def info(self, msg: str, *args) -> None:
        if self.enabled:
            _ensure_configured()
            _logger.info(_rid_prefix(msg), *args, stacklevel=2)

    infof = info


def V(level: int) -> _Verbose:  # noqa: N802 - glog's exported name
    if level <= _verbosity:
        return _Verbose(True)
    if _vmodule:
        mod = _caller_module()
        for pat, lvl in _vmodule:
            if fnmatch.fnmatch(mod, pat):
                return _Verbose(level <= lvl)
    return _Verbose(False)


def info(msg: str, *args) -> None:
    _ensure_configured()
    _logger.info(_rid_prefix(msg), *args, stacklevel=2)


def warning(msg: str, *args) -> None:
    _ensure_configured()
    _logger.warning(_rid_prefix(msg), *args, stacklevel=2)


def error(msg: str, *args) -> None:
    _ensure_configured()
    _logger.error(_rid_prefix(msg), *args, stacklevel=2)


def fatal(msg: str, *args) -> None:
    """Log at FATAL severity and exit (glog.Fatalf)."""
    _ensure_configured()
    _logger.critical(_rid_prefix(msg), *args, stacklevel=2)
    sys.exit(FATAL_EXIT_CODE)
