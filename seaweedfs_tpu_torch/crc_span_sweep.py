"""Time K4 (csrc/crc32c_rows.cu) at each shape the paths launch it with,
for every span the host could choose, beside the span it does choose.

    python -m seaweedfs_tpu_torch.crc_span_sweep

For each of SHAPES ([1, 4, 14, 224] rows of 1 MiB) it holds the kernel
byte-exact against the plain version at every span and times it as a
CUDA graph of launches over distinct inputs sliced from one 256 MiB
tensor, so the host's per-launch cost stays out of the kernel's time.
It overrides crc_kernel.geometry for the sweep only; the result says
whether the host's rule (crc_kernel.geometry) picks the fastest span.
Needs a card.
"""

from __future__ import annotations

import subprocess
import sys

LANES = 262144  # u32 words of a 1 MiB row
SHAPES = (1, 4, 14, 224)  # rows of LANES
POOL_WORDS = 64 << 20  # 256 MiB of lanes the timed inputs are sliced from


def _card_line() -> str:
    """The card's name and power limit, as nvidia-smi reports them."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    )
    return out.stdout.strip().splitlines()[0]


def _graph_ms(fn, iters: int, replays: int = 5) -> float:
    """Mean device ms per call of fn(i): `iters` calls captured in one
    CUDA graph and replayed. The warm-up call runs on the capture
    stream, outside the capture."""
    import torch

    stream = torch.cuda.Stream()
    stream.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(stream):
        fn(0)
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph, stream=stream):
        for i in range(iters):
            fn(i)
    graph.replay()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(replays):
        graph.replay()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / (iters * replays)


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("crc_span_sweep: no CUDA device", file=sys.stderr)
        return 1
    from seaweedfs_tpu_torch.ec import crc_kernel as k

    print(_card_line(), flush=True)
    g = torch.Generator(device="cuda").manual_seed(5)
    pool = torch.randint(-(2**31), 2**31 - 1, (POOL_WORDS,), dtype=torch.int32,
                         device="cuda", generator=g)
    rule = k.geometry
    try:
        for rows in SHAPES:
            per = rows * LANES
            xs = [pool[i * per:(i + 1) * per].view(rows, LANES)
                  for i in range(POOL_WORDS // per)]
            iters = min(256, max(16, len(xs)))
            want = k.crc32c_rows_plain(xs[0])
            times = []
            for span in k.SPANS:
                nchunks = -(-4 * LANES // (256 * span))
                run = 1
                while 256 * run < nchunks:
                    run *= 2
                k.geometry = lambda r, n, sms=0, _g=(span, nchunks, run): _g
                if not torch.equal(k.crc32c_rows(xs[0]), want):
                    raise AssertionError(f"K4 [{rows},{LANES}] span {span}: wrong CRCs")
                ms = _graph_ms(lambda i: k.crc32c_rows(xs[i % len(xs)]), iters=iters)
                times.append(f"{span} B {ms:.4f} ms")
            k.geometry = rule
            chosen = rule(rows, LANES, torch.cuda.get_device_properties(0).multi_processor_count)
            print(f"K4 [{rows},{LANES}]: the rule picks {chosen[0]} B; " + ", ".join(times),
                  flush=True)
    finally:
        k.geometry = rule
    return 0


if __name__ == "__main__":
    sys.exit(main())
