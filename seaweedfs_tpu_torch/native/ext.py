"""The port's CPython extensions, built from csrc/ at first use.

  needle_ext  the needle record codec (`encode`, `decode`) and the
              one-pass POST (`post`): csrc/needle_ext.c over needle.c,
              post.c and crc32c.c
  serve_ext   the epoll serving core with its zero-copy GET fast path,
              plan cache, fast-path counters and shared admission
              bucket: csrc/serve_ext.c over serve.c

Nothing is built when this module is imported. The first call builds
the extension with the system C compiler against the running
interpreter's headers and imports it; a failed build or import raises
RuntimeError carrying the compiler's message (there is no quiet
pure-Python fallback). Neither extension touches the card, so a
process that only serves from disk loads them without torch.
"""

from __future__ import annotations

from seaweedfs_tpu_torch import _build


def needle_ext():
    """The built needle codec module (built on first use)."""
    return _build.load_ext("needle_ext.c")


def serve_ext():
    """The built serving-core module (built on first use)."""
    return _build.load_ext("serve_ext.c")
