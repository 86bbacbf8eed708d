"""The port's sampling profiler (seaweedfs_tpu_torch/telemetry/profiler.py):
it keeps no thread's frame between samples, and its thread ends with the
last daemon that started it."""

import sys
import threading
import time
import weakref

import pytest

from seaweedfs_tpu_torch.telemetry import profiler


@pytest.fixture
def sampler(monkeypatch):
    """The sampler at a 0.2 s period, enabled, with no daemon on it. The
    reference's sampler, if a reference server in this process started
    it, is paused: it keeps the last frame it walked between samples."""
    ref = sys.modules.get("seaweedfs_tpu.telemetry.profiler")
    if ref is not None:
        monkeypatch.setattr(ref, "_paused", True)
        time.sleep(2 * ref._INTERVAL_S)  # a tick in flight ends
    monkeypatch.setattr(profiler, "_ENABLED", True)
    monkeypatch.setattr(profiler, "_INTERVAL_S", 0.2)
    assert not profiler._started and profiler._users == 0, _held_by()
    yield profiler
    while profiler._users:
        profiler.release()


def _held_by() -> str:
    """What holds the sampler: its users and the process's live threads."""
    return (f"sampler held: _started={profiler._started} _users={profiler._users}; "
            f"live threads: {sorted(t.name for t in threading.enumerate())}")


class _Box:
    pass


def _hold_across_samples(n: int) -> weakref.ref:
    """Keep a local alive in this frame while the sampler takes n
    samples; return a weak reference to it."""
    box = _Box()
    ref = weakref.ref(box)
    start = profiler._samples
    deadline = time.monotonic() + 10.0
    while profiler._samples < start + n:
        assert time.monotonic() < deadline, "the sampler took no samples"
        time.sleep(0.005)
    return ref


def test_sampler_keeps_no_frame_between_samples(sampler):
    """A frame the sampler walked is not kept through its sleep: the
    frame's locals die on their own thread when it returns, not on the
    sampler's thread at its next sample."""
    assert sampler.ensure_started()
    ref = _hold_across_samples(2)
    assert ref() is None
    snapshot = sampler.snapshot()[1]
    assert any(stack and stack[-1].endswith("_hold_across_samples") for stack in snapshot)


def test_sampler_thread_ends_with_its_last_user(sampler):
    assert sampler.ensure_started()
    thread = sampler._thread
    assert sampler.ensure_started() and sampler._thread is thread
    assert sampler._users == 2 and thread.is_alive()
    sampler.release()
    assert sampler.running() and thread.is_alive()
    sampler.release()
    assert not sampler.running() and not thread.is_alive() and sampler._thread is None
    sampler.release()  # one more release is a no-op
    assert sampler._users == 0
    assert sampler.ensure_started() and sampler._thread.is_alive()


def _sampler_threads() -> list:
    """The port's live sampler threads (the reference's share the name)."""
    return [t for t in threading.enumerate()
            if t.is_alive() and getattr(t, "_target", None) is profiler._sample_loop]


@pytest.mark.parametrize("seconds", [0.3, 0.0])
def test_capture_leaves_no_ownerless_sampler(sampler, seconds):
    """capture() with no daemon on the sampler: a window takes a user for
    its span and releases it; the since-start aggregate starts nothing
    and is empty. Either way no sampler thread is left that no daemon's
    stop() could end."""
    payload = sampler.capture(seconds)
    assert sorted(payload) == ["enabled", "interval_ms", "running", "samples", "seconds",
                               "stacks"]
    if seconds:
        assert payload["samples"] >= 1
    else:
        assert payload["samples"] == 0 and payload["stacks"] == {}
        assert payload["seconds"] == 0.0
    assert not sampler._started and sampler._users == 0, _held_by()
    assert sampler._thread is None and not _sampler_threads(), _held_by()


def test_capture_window_keeps_a_daemons_sampler(sampler):
    """A window taken while a daemon holds the sampler leaves the
    daemon's hold, and its thread, as they were."""
    assert sampler.ensure_started()
    thread = sampler._thread
    sampler.capture(0.3)
    assert sampler._users == 1 and sampler._thread is thread and thread.is_alive()
    assert sampler.capture(0.0)["samples"] >= 1
    sampler.release()
    assert not thread.is_alive() and not _sampler_threads()
