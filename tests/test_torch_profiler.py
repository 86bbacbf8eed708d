"""The port's sampling profiler (seaweedfs_tpu_torch/telemetry/profiler.py):
it keeps no thread's frame between samples, and its thread ends with the
last daemon that started it."""

import sys
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
    assert not profiler._started and profiler._users == 0
    yield profiler
    while profiler._users:
        profiler.release()


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
