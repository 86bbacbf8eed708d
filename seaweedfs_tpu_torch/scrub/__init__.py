"""The scrub plane's process-wide bandwidth arbiter (arbiter.py), which
the rebuild and handoff paths take tokens from. The scrub engine, its
rate limiter and the repair scheduler of seaweedfs_tpu/scrub/ are not
part of the port yet (ROADMAP item 9)."""
