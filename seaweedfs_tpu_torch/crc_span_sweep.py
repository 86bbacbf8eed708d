"""Time K4 (csrc/crc32c_rows.cu) at each shape the paths launch it with,
for every span the host could choose, beside the span it does choose.

    python -m seaweedfs_tpu_torch.crc_span_sweep      (from the repo root)

For each of chip_smoke.CRC_SHAPES ([1, 4, 14, 224] rows of 1 MiB) it
holds the kernel byte-exact against the plain version at every span and
times it the way chip_smoke.check_crc does (a CUDA graph of launches
over distinct inputs sliced from one 256 MiB tensor). It overrides
crc_kernel.geometry for the sweep only; the result says whether the
host's rule (crc_kernel.geometry) picks the fastest span. Needs a card.
"""

from __future__ import annotations

import sys


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("crc_span_sweep: no CUDA device", file=sys.stderr)
        return 1
    import chip_smoke as smoke

    from seaweedfs_tpu_torch.ec import crc_kernel as k

    print(smoke.gpu_line(), flush=True)
    lanes = smoke.LANES
    g = torch.Generator(device="cuda").manual_seed(5)
    pool = torch.randint(-(2**31), 2**31 - 1, (smoke.CRC_POOL_WORDS,), dtype=torch.int32,
                         device="cuda", generator=g)
    rule = k.geometry
    try:
        for _, rows in smoke.CRC_SHAPES:
            per = rows * lanes
            xs = [pool[i * per:(i + 1) * per].view(rows, lanes)
                  for i in range(smoke.CRC_POOL_WORDS // per)]
            iters = min(256, max(16, len(xs)))
            want = k.crc32c_rows_plain(xs[0])
            times = []
            for span in k.SPANS:
                nchunks = -(-4 * lanes // (256 * span))
                run = 1
                while 256 * run < nchunks:
                    run *= 2
                k.geometry = lambda r, n, sms=0, _g=(span, nchunks, run): _g
                if not torch.equal(k.crc32c_rows(xs[0]), want):
                    raise AssertionError(f"K4 [{rows},{lanes}] span {span}: wrong CRCs")
                ms = smoke._kernel_ms(lambda i: k.crc32c_rows(xs[i % len(xs)]), iters=iters)
                times.append(f"{span} B {ms:.4f} ms")
            k.geometry = rule
            chosen = rule(rows, lanes, torch.cuda.get_device_properties(0).multi_processor_count)
            print(f"K4 [{rows},{lanes}]: the rule picks {chosen[0]} B; " + ", ".join(times),
                  flush=True)
    finally:
        k.geometry = rule
    return 0


if __name__ == "__main__":
    sys.exit(main())
