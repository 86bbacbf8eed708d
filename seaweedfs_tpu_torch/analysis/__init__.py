"""Test drivers of the port: `fuzz_serve`, the byte-identity fuzzer of
the C epoll serving loop against the threaded mini loop (the port of
seaweedfs_tpu/analysis/fuzz_serve.py)."""

import os

REPO_ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
