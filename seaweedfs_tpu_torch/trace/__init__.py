"""Spans around the EC drivers (see trace/tracer.py)."""

from seaweedfs_tpu_torch.trace.tracer import recent, span, totals

__all__ = ["recent", "span", "totals"]
