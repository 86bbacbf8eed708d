#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (seaweedfs_tpu_torch) on one card.

    python3 chip_smoke.py [--seed N] [--volume-mib MIB]

Phases, each of which raises on a fault (the script then exits nonzero):
  1. the device: torch's name and count, nvidia-smi's name and power limit;
  2. the kernels: build every CUDA source (all nvcc processes at once)
     and log each GF kernel instantiation's registers and spills, run
     each kernel at the main path's shapes (K1 with the encode, 4-shard
     and 1-shard decode matrices, and the degraded read's 1-row decode
     at one tile and one 32-tile run; K4 at the encode's [14, 262144]
     tile), hold it byte-exact against its plain PyTorch version on the
     card, time both with CUDA events, and
     compute its bound on this card; then, untimed, hold K1, K2 and K3
     against their plain versions over random (k, rows) matrices, and K4
     over random row counts and ragged, unaligned rows;
  3. the single-volume path: write one sealed volume (default 1 GiB)
     with the port's storage code, EC-encode it through
     ec_files.write_ec_files on the cuda backend (fused shard CRCs,
     durable), publish .ecx and .ecc, check the CRCs against the host
     shim, parity on sampled rows against the numpy codec, and 64
     needles read back through the striping; then delete shard 3 and
     rebuild it, delete shards {0, 5, 10, 13} and rebuild them, each
     byte-identical; the kernels' launch counters must grow in every
     one of the three runs;
 3b. degraded reads on that volume (run_degraded_phase): delete shards
     {0, 5, 10, 13}, read every needle through EcVolume (K1 decodes on
     the card, no K4), each equal to its .dat record; a warm pass that
     must not decode resident tiles again; 8 threads reading the same
     cold needles on shard 0 (at most one K1 launch a decode run of
     cold tiles); then rebuild shards 0 and 5 through
     stream_rebuild_ec_files with a repair session seeded from the tile
     cache while a thread keeps serving (donated bytes used, survivor
     reads cut by them; that thread's own launches are booked to the
     degraded path, not the rebuild), and shards 10 and 13 after it,
     all byte-identical with the encode's CRCs;
 3c. the volume store (run_store_phase), in its own directory: write a
     1 GiB volume (BASELINE.json config 1) of needles log-uniform over
     1 KiB-4 MiB from the seed through Store.write_needle, delete every
     16th, rewrite every 64th under its own id, vacuum (compact,
     commit_compact) and seal it, every live needle read back equal and
     every deleted one NeedleNotFound; encode it with ec_files on the
     cuda backend (K1 + K4) and with the native host codec into a second
     directory, shards, .ecx and .ecc byte-identical and CRCs equal the
     host shim's, both walls printed beside the card's name and power
     limit, the host's CPU, its core count and the codec's SIMD path;
     the same for a rebuild of shards {0, 5, 10, 13}; mount all 14
     shards in the Store, unmount and delete those four and read every
     live needle through its EcVolume (K1 on the card); then upload
     shards 1 and 2 to a `dir` backend, attach them (the .evf sidecar),
     delete them locally, reload through a fresh Store (DiskLocation
     loads the remote half) and read 64 needles on shards 0, 1 and 2
     (K1 decoding with remote survivors, ranged backend reads counted);
  4. the batch path (BASELINE.json config 3, "batched ec.encode over
     256 sealed volumes"): write 256 volumes of about 4 MiB, encode them
     through ec_files.write_ec_files_batch (WEED_EC_PIPELINE_BATCH=16,
     fused CRCs, durable) and check CRCs, parity and needles; encode the
     same volumes through write_ec_files in a loop, timed beside the
     batch, every volume's CRCs equal to the batch's and 4 volumes
     byte-identical to the single-volume path; rebuild shard 3
     of the odd volumes and shards {0, 5, 10, 13} of the even ones in
     one rebuild_ec_files_batch call (two signature groups); the batch
     host arm (_HostBatchCodec over the native codec) encodes the same
     volumes and rebuilds the same damage, byte-identical to the K2 runs
     with equal CRCs, both walls printed; verify 16
     volumes with MeshCodec.verify_batch_u32, clean and with planted
     faults; the batch kernels' counters must grow in each run;
  5. the report: K1 and K4 at every launch signature the paths (the
     store's included) gave
     them (the wrappers' tallies: shape, and K1's matrix), each
     byte-exact against its plain version, timed, bounded, and priced
     as launches x (ms - bound); K1 at the degraded read's shapes
     ([10, 65536] and [10, 2097152] lanes, one decode row) and
     cuda_apply_matrix's wall a call there; a `kernels` JSON line, then
     the final status line.

Without a CUDA device it prints the reason and exits 1 before any result.
"""

from __future__ import annotations

import argparse
import filecmp
import json
import os
import re
import shutil
import subprocess
import sys
import tempfile
import threading
import time

import numpy as np

# H100 SXM (NVIDIA data sheet): HBM3 rate. Both kernels do integer work
# only, for which the data sheet's peak table gives no rate, so each bound
# is the bytes the function must move over this rate.
HBM_BYTES_PER_S = 3.35e12

K1_SOURCE = "seaweedfs_tpu_torch/csrc/gf_apply.cu"
K3_SOURCE = "seaweedfs_tpu_torch/csrc/gf_verify.cu"
K4_SOURCE = "seaweedfs_tpu_torch/csrc/crc32c_rows.cu"
K1_REPLACES = "seaweedfs_tpu/ec/codec_tpu.py:204 swar_apply_u32"
K2_REPLACES = "seaweedfs_tpu/ec/codec_tpu.py:236 swar_apply_u32_batch"
K3_REPLACES = "seaweedfs_tpu/ec/codec_tpu.py:321 swar_verify_u32_batch"
K4_REPLACES = "seaweedfs_tpu/ec/crc_kernel.py:133 crc32c_rows"

LANES = 262144  # 1 MiB of stream per row: the pipelined tile of the main path
BATCH = 16  # volumes per round of the batch phase (WEED_EC_PIPELINE_BATCH)
# BASELINE.json config 3: 256 sealed volumes, here of ~4 MiB of .dat each
BATCH_VOLUMES = 256
BATCH_VOLUME_BYTES = 4 << 20
CRC_POOL_WORDS = 64 << 20  # 256 MiB of lanes K4's timed inputs are sliced from
# every launch signature of K1 and K4 on the paths is timed over inputs
# sliced from a pool of at least this many bytes (beyond the 50 MB L2),
# at most SIG_MAX_INPUTS distinct ones
SIG_POOL_BYTES = 128 << 20
SIG_MAX_INPUTS = 1024
# K1's shapes on the degraded read: one 256 KiB tile (tile_cache's default)
# and a run of 32 tiles (8 MiB a row)
DEG_TILE_LANES = 65536
DEG_RUN_LANES = 2097152
STORE_BYTES = 1 << 30  # the store phase's volume: BASELINE.json config 1


def log(msg: str) -> None:
    print(msg, flush=True)


def gpu_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    )
    return out.stdout.strip().splitlines()[0]


# --- phase 2: kernels against their plain versions -------------------------


def _time_ms(fn, iters: int, warm: int = 3) -> float:
    """Mean ms per call of fn(i), eager launches, CUDA events."""
    import torch

    for _ in range(warm):
        fn(0)
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for i in range(iters):
        fn(i)
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def _kernel_ms(fn, iters: int = 64, replays: int = 5) -> float:
    """Mean device ms per kernel call: `iters` calls of fn(i) captured
    in one CUDA graph and replayed, so the host's per-launch cost
    (Python checks, ctypes) stays out of the kernel's time. The warm-up
    call runs on the capture stream: a stream's first K4 call makes its
    ticket buffer, which no capture may do."""
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


def _max_abs_err(a, b) -> int:
    return int((a.long() - b.long()).abs().max().item())


def check_gf(name: str, rows, seed: int, card: str, lanes: int = LANES) -> dict:
    """K1 with coefficient rows `rows` over [k, lanes] int32 lanes:
    byte-exact against its plain version, then timed over distinct
    input sets of at least 128 MiB in all (beyond the 50 MB L2)."""
    import torch

    from seaweedfs_tpu_torch.ec import codec_cuda

    k, r = rows.shape[1], rows.shape[0]
    g = torch.Generator(device="cuda").manual_seed(seed)
    sets = max(8, (128 << 20) // (k * 4 * lanes))
    xs = [
        torch.randint(-(2**31), 2**31 - 1, (k, lanes), dtype=torch.int32,
                      device="cuda", generator=g)
        for _ in range(sets)
    ]
    outs = [torch.empty((r, lanes), dtype=torch.int32, device="cuda") for _ in xs]
    terms = codec_cuda.gf_terms(rows)
    got = codec_cuda.gf_apply_u32(rows, xs[0], terms)
    want = codec_cuda.gf_apply_plain(rows, xs[0])
    torch.cuda.synchronize()
    err = _max_abs_err(got, want)
    if err or not torch.equal(got, want):
        raise AssertionError(f"K1 {name}: kernel disagrees with its plain version")
    del got, want
    iters = max(64, sets)
    ms = _kernel_ms(lambda i: codec_cuda.gf_apply_u32(rows, xs[i % sets], terms,
                                                      outs[i % sets]), iters=iters)
    eager_ms = _time_ms(lambda i: codec_cuda.gf_apply_u32(rows, xs[i % sets], terms,
                                                          outs[i % sets]), 200)
    plain_ms = _time_ms(lambda i: codec_cuda.gf_apply_plain(rows, xs[i % sets]), 3, warm=1)
    nbytes = (k + r) * 4 * lanes
    bound = nbytes / HBM_BYTES_PER_S * 1e3
    log(
        f"K1 gf_apply {name} [{k},{lanes}]->[{r},{lanes}] on {card}: "
        f"byte-exact vs plain (max_abs_err 0); kernel {ms:.4f} ms over {sets} distinct "
        f"inputs ({nbytes / ms / 1e6:.1f} GB/s; {eager_ms:.4f} ms a call launched "
        f"eagerly from Python), plain {plain_ms:.3f} ms, bound {bound:.5f} ms "
        f"(bytes; {bound / ms:.3f} of it)"
    )
    del xs, outs
    return {
        "ms": ms, "plain_ms": plain_ms, "bound_ms": bound, "bound_by": "bytes",
        "max_abs_err": err, "eager_ms": eager_ms,
    }


def time_apply_matrix(rows, lanes: int, seed: int, card: str, reps: int = 20) -> dict:
    """One degraded decode as EcVolume makes it: codec_cuda.cuda_apply_matrix
    on a numpy [k, 4 * lanes] survivor stack, against the numpy codec's
    bytes; host wall a call, then the same four steps timed one by one
    (numpy pad, pageable H2D, K1, D2H into numpy), each ended by a
    synchronize."""
    import torch

    from seaweedfs_tpu_torch.ec import codec_cuda
    from seaweedfs_tpu_torch.ec.codec import cpu_apply_matrix

    rng = np.random.default_rng(seed)
    stacked = rng.integers(0, 256, (rows.shape[1], 4 * lanes), dtype=np.uint8)
    got = codec_cuda.cuda_apply_matrix(rows, stacked)
    if not np.array_equal(got, cpu_apply_matrix(rows, stacked)):
        raise AssertionError(f"cuda_apply_matrix at {lanes} lanes disagrees with numpy")
    t0 = time.perf_counter()
    for _ in range(reps):
        codec_cuda.cuda_apply_matrix(rows, stacked)
    ms = (time.perf_counter() - t0) / reps * 1e3
    steps = {"pad": 0.0, "h2d": 0.0, "k1": 0.0, "d2h": 0.0}
    n = stacked.shape[1]
    for _ in range(reps):
        t0 = time.perf_counter()
        padded = np.zeros((stacked.shape[0], codec_cuda._bucket_len(n)), dtype=np.uint8)
        padded[:, :n] = stacked
        t1 = time.perf_counter()
        x = torch.from_numpy(padded.view(np.int32)).to("cuda")
        torch.cuda.synchronize()
        t2 = time.perf_counter()
        out = codec_cuda.gf_apply_u32(rows, x)
        torch.cuda.synchronize()
        t3 = time.perf_counter()
        out.cpu().numpy().view(np.uint8)[:, :n]
        t4 = time.perf_counter()
        for key, dt in zip(steps, (t1 - t0, t2 - t1, t3 - t2, t4 - t3)):
            steps[key] += dt * 1e3 / reps
    log(f"cuda_apply_matrix [{rows.shape[0]}x{rows.shape[1]}] over [{rows.shape[1]},"
        f"{4 * lanes}] bytes on {card}: {ms:.4f} ms a call, equal to the numpy codec's; "
        f"its steps one by one (ms): " + json.dumps({k: round(v, 4) for k, v in steps.items()}))
    return {"ms": ms, "steps_ms": steps}


def sweep_gf(seed: int, draws: int = 48) -> int:
    """Untimed exactness sweep of K1, K2 and K3 against their plain
    versions over random matrices: k runs through 1..16 three times,
    rows are drawn from 1..16, lane counts are ragged, and every draw
    takes the vector variant (aligned rows) or the scalar one (rows one
    lane off), K2 and K3 with a volume stride. Returns the calls checked."""
    import torch

    from seaweedfs_tpu_torch.ec import codec_cuda

    rng = np.random.default_rng(seed)
    g = torch.Generator(device="cuda").manual_seed(seed)

    def lanes(n):
        return torch.randint(-(2**31), 2**31 - 1, (n,), dtype=torch.int32,
                             device="cuda", generator=g)

    checked = 0
    for i in range(draws):
        k, r = i % 16 + 1, int(rng.integers(1, 17))
        rows = rng.integers(0, 256, (r, k), dtype=np.uint8)
        rows[rng.random((r, k)) < 0.25] = 0
        rows[0] &= (1 << int(rng.integers(1, 9))) - 1  # Horner starts below bit 7
        vec = i % 2 == 0
        n32 = int(rng.integers(1, 3000)) * (4 if vec else 1)
        off = 0 if vec else 1
        x = lanes(k * n32 + off)[off:].view(k, n32)
        if not torch.equal(codec_cuda.gf_apply_u32(rows, x), codec_cuda.gf_apply_plain(rows, x)):
            raise AssertionError(f"K1 disagrees with its plain version at k {k}, rows {r}, "
                                 f"n32 {n32}, {'vector' if vec else 'scalar'}")
        pad = 4 if vec else 1
        xb = lanes(3 * (k * n32 + pad)).view(3, k * n32 + pad)[:, :k * n32].view(3, k, n32)
        want = codec_cuda.gf_apply_batch_plain(rows, xb)
        if not torch.equal(codec_cuda.gf_apply_u32_batch(rows, xb), want):
            raise AssertionError(f"K2 disagrees with its plain version at k {k}, rows {r}, "
                                 f"n32 {n32}, {'vector' if vec else 'scalar'}")
        par = lanes(3 * (r * n32 + pad)).view(3, r * n32 + pad)[:, :r * n32].view(3, r, n32)
        par.copy_(want)
        par[1, r - 1, n32 - 1] ^= 0x10
        counts = codec_cuda.gf_verify_u32_batch(rows, xb, par)
        if counts.tolist() != [0, 1, 0] or not torch.equal(
                counts, codec_cuda.gf_verify_batch_plain(rows, xb, par)):
            raise AssertionError(f"K3 counts {counts.tolist()} at k {k}, rows {r}, n32 {n32}")
        checked += 3
    torch.cuda.synchronize()
    return checked


def ptxas_summary(logs: dict) -> list[str]:
    """One line per kernel template and variant: registers for K = 1..16
    and the largest spill, from the build's ptxas output."""
    from seaweedfs_tpu_torch.sass_report import ptxas_regs

    lines = []
    for src, log in sorted(logs.items()):
        by: dict = {}
        for name, (regs, st, ld) in ptxas_regs(log).items():
            m = re.search(r"(gf_\w+?_kernel)ILi(\d+)ELb([01])E", name)
            key = (m.group(1), "vector" if m.group(3) == "1" else "scalar") if m else (name, "")
            by.setdefault(key, []).append((int(m.group(2)) if m else 0, regs, max(st, ld)))
        for (kern, variant), rows in sorted(by.items()):
            rows.sort()
            regs = " ".join(f"{k}:{n}" for k, n, _ in rows)
            lines.append(f"{src} {kern} {variant}: registers by K {regs}; "
                         f"largest spill {max(s for _, _, s in rows)} B")
    return lines


def check_crc(seed: int, card: str) -> dict:
    """K4 at the single-volume encode's tile [14, LANES]: byte-exact
    against its plain version and the host shim (final and raw forms),
    timed over distinct inputs sliced from one 256 MiB tensor (beyond
    the 50 MB L2), eagerly, and its plain version. Every shape the
    paths launch it with is checked and timed after them
    (check_signatures)."""
    import torch

    from seaweedfs_tpu_torch.ec import crc_kernel
    from seaweedfs_tpu_torch.util.crc import crc32c

    g = torch.Generator(device="cuda").manual_seed(seed)
    pool = torch.randint(-(2**31), 2**31 - 1, (CRC_POOL_WORDS,), dtype=torch.int32,
                         device="cuda", generator=g)
    rows = 14
    per = rows * LANES
    xs = [pool[i * per:(i + 1) * per].view(rows, LANES) for i in range(CRC_POOL_WORDS // per)]
    got = crc_kernel.crc32c_rows(xs[0])
    want = crc_kernel.crc32c_rows_plain(xs[0])
    raw = crc_kernel.crc_lin_rows(xs[0])
    torch.cuda.synchronize()
    err = _max_abs_err(got, want)
    if err or not torch.equal(got, want):
        raise AssertionError(f"K4 crc32c_rows [{rows},{LANES}]: kernel disagrees with its "
                             f"plain version")
    if not torch.equal(crc_kernel.finalize_rows(raw, 4 * LANES), got):
        raise AssertionError(f"K4 crc_lin_rows [{rows},{LANES}]: raw form disagrees")
    host = xs[0].cpu().numpy()
    if [crc32c(host[i]) for i in range(rows)] != [
            int(v) for v in got.cpu().numpy().view(np.uint32)]:
        raise AssertionError(f"K4 crc32c_rows [{rows},{LANES}] disagrees with the host CRC-32C")
    ms = _kernel_ms(lambda i: crc_kernel.crc32c_rows(xs[i % len(xs)]), iters=len(xs))
    eager_ms = _time_ms(lambda i: crc_kernel.crc32c_rows(xs[i % 4]), 200)
    plain_ms = _time_ms(lambda i: crc_kernel.crc32c_rows_plain(xs[i % 4]), 2, warm=1)
    nbytes = rows * 4 * LANES + rows * 4
    bound = nbytes / HBM_BYTES_PER_S * 1e3
    log(f"K4 crc32c_rows [{rows},{LANES}] on {card}: byte-exact vs plain, host shim and raw "
        f"form (max_abs_err 0); kernel {ms:.4f} ms over {len(xs)} distinct inputs "
        f"({nbytes / ms / 1e6:.1f} GB/s; {eager_ms:.4f} ms a call launched eagerly from "
        f"Python), plain {plain_ms:.3f} ms, bound {bound:.4f} ms (bytes; {bound / ms:.3f} "
        f"of it)")
    del pool, xs
    return {"ms": ms, "plain_ms": plain_ms, "bound_ms": bound, "bound_by": "bytes",
            "max_abs_err": err, "eager_ms": eager_ms}


def _sig_inputs(pool, rows: int, n32: int) -> list:
    """Distinct [rows, n32] views sliced from `pool`, at most SIG_MAX_INPUTS."""
    per = rows * n32
    return [pool[i * per:(i + 1) * per].view(rows, n32)
            for i in range(min(SIG_MAX_INPUTS, pool.numel() // per))]


def check_signatures(runs: dict, paths, names: dict, seed: int, card: str) -> dict:
    """K1 and K4 at every signature `paths` launched them with (the
    wrappers' tallies: K1's rows, k, lanes and matrix, K4's rows and
    lanes). At each: byte-exact against its plain version (K4 also the
    host shim and its raw form), then timed over distinct inputs sliced
    from one pool of at least SIG_POOL_BYTES, with its bound from the
    bytes, and priced: launches x (ms - bound). `names` labels known
    matrices by their bytes. Returns {kernel: {"shapes", "loss_ms",
    "launches"}}."""
    import torch

    from seaweedfs_tpu_torch.ec import codec_cuda, crc_kernel
    from seaweedfs_tpu_torch.util.crc import crc32c

    g = torch.Generator(device="cuda").manual_seed(seed)
    result = {}
    for kname in SIG_KERNELS:
        by_sig: dict = {}
        for path in paths:
            for sig, n in runs[path].get("sigs", {}).get(kname, {}).items():
                by_sig.setdefault(sig, {})[path] = n
        k1 = kname == "gf_apply"
        in_words = [(sig[1] if k1 else sig[0]) * sig[2 if k1 else 1] for sig in by_sig]
        words = max([SIG_POOL_BYTES // 4] + in_words)
        pool = torch.randint(-(2**31), 2**31 - 1, (words,), dtype=torch.int32,
                             device="cuda", generator=g)
        shapes, loss = [], 0.0
        for sig in sorted(by_sig, key=lambda sg: (sg[0], sg[2 if k1 else 1], str(sg))):
            if k1:
                r, k, n32, mat = sig
                rows = np.frombuffer(mat, dtype=np.uint8).reshape(r, k)
                xs = _sig_inputs(pool, k, n32)
                outs = torch.empty((len(xs), r, n32), dtype=torch.int32, device="cuda")
                terms = codec_cuda.gf_terms(rows)
                label = names.get(mat, "rows " + mat.hex())
                if not torch.equal(codec_cuda.gf_apply_u32(rows, xs[0], terms),
                                   codec_cuda.gf_apply_plain(rows, xs[0])):
                    raise AssertionError(f"K1 [{k},{n32}] ({label}): kernel disagrees with "
                                         f"its plain version")
                ms = _kernel_ms(lambda i: codec_cuda.gf_apply_u32(
                    rows, xs[i % len(xs)], terms, outs[i % len(xs)]),
                    iters=min(SIG_MAX_INPUTS, max(64, len(xs))))
                nbytes = (k + r) * 4 * n32
                shape = f"[{k},{n32}]->[{r},{n32}] ({label})"
                del outs
            else:
                r, n32 = sig
                xs = _sig_inputs(pool, r, n32)
                got = crc_kernel.crc32c_rows(xs[0])
                host = xs[0].cpu().numpy()
                if not torch.equal(got, crc_kernel.crc32c_rows_plain(xs[0])) or not (
                        torch.equal(crc_kernel.finalize_rows(crc_kernel.crc_lin_rows(xs[0]),
                                                             4 * n32), got)) or [
                        crc32c(host[i]) for i in range(r)] != [
                        int(v) for v in got.cpu().numpy().view(np.uint32)]:
                    raise AssertionError(f"K4 [{r},{n32}]: kernel disagrees with its plain "
                                         f"version, raw form or the host shim")
                ms = _kernel_ms(lambda i: crc_kernel.crc32c_rows(xs[i % len(xs)]),
                                iters=min(SIG_MAX_INPUTS, max(64, len(xs))))
                nbytes = r * 4 * n32 + r * 4
                shape = f"[{r},{n32}]"
            bound = nbytes / HBM_BYTES_PER_S * 1e3
            n = sum(by_sig[sig].values())
            loss += n * (ms - bound)
            shapes.append({"shape": shape, "launches": by_sig[sig], "ms": ms,
                           "bound_ms": bound, "inputs": len(xs)})
            log(f"{kname} {shape} on {card}: byte-exact vs plain; {ms:.4f} ms over "
                f"{len(xs)} distinct inputs, bound {bound:.5f} ms (bytes; share "
                f"{bound / ms:.3f}), launches {by_sig[sig]}, launches x (ms - bound) "
                f"{n * (ms - bound):.3f} ms")
        del pool
        total = sum(sum(v.values()) for v in by_sig.values())
        log(f"{kname} over its {len(by_sig)} launch signatures on the paths on {card}: "
            f"{total} launches, launches x (ms - bound) {loss:.3f} ms")
        result[kname] = {"shapes": shapes, "loss_ms": loss, "launches": total}
    return result


def sweep_crc(seed: int, draws: int = 40) -> int:
    """Untimed exactness sweep of K4 against its plain version and the
    host shim, final and raw forms: rows drawn from 1..300, ragged lane
    counts (1, 5, 4095, 4097 and 2^21 + 3, whose row fold takes runs of
    several chunks, then random ones), aligned rows (the vector variant)
    and rows one lane off (the scalar one). Returns the calls checked."""
    import torch

    from seaweedfs_tpu_torch.ec import crc_kernel
    from seaweedfs_tpu_torch.util.crc import crc32c

    rng = np.random.default_rng(seed)
    g = torch.Generator(device="cuda").manual_seed(seed)
    cases = [(n, False) for n in (1, 5, 4095, 4097, (1 << 21) + 3)]
    cases += [(4096, True), ((1 << 21) + 4, True)]
    for i in range(draws):
        vec = i % 2 == 0
        cases.append((int(rng.integers(1, 20000)) * (4 if vec else 1), vec))
    checked = 0
    for n32, vec in cases:
        # at most 16 MiB a draw: the plain version works in int64 columns
        rows = min(int(rng.integers(1, 301)), max(1, (4 << 20) // n32))
        off = 0 if vec else 1
        x = torch.randint(-(2**31), 2**31 - 1, (rows * n32 + off,), dtype=torch.int32,
                          device="cuda", generator=g)[off:].view(rows, n32)
        got, raw = crc_kernel.crc32c_rows(x), crc_kernel.crc_lin_rows(x)
        host = x.cpu().numpy()
        what = f"rows {rows}, n32 {n32}, {'vector' if vec else 'scalar'}"
        if not torch.equal(got, crc_kernel.crc32c_rows_plain(x)):
            raise AssertionError(f"K4 disagrees with its plain version at {what}")
        if not torch.equal(crc_kernel.finalize_rows(raw, 4 * n32), got):
            raise AssertionError(f"K4 raw form disagrees with the final one at {what}")
        if [crc32c(host[i]) for i in range(rows)] != [
                int(v) for v in got.cpu().numpy().view(np.uint32)]:
            raise AssertionError(f"K4 disagrees with the host CRC-32C at {what}")
        checked += 2
    torch.cuda.synchronize()
    return checked


def check_gf_batch(name: str, rows, seed: int, card: str) -> dict:
    """K2 at [16, 10, 262144] lanes (a batch round of the batch phase)."""
    import torch

    from seaweedfs_tpu_torch.ec import codec_cuda

    k, r = rows.shape[1], rows.shape[0]
    g = torch.Generator(device="cuda").manual_seed(seed)
    # 160 MiB of input, beyond the 50 MB L2: timing sees HBM
    x = torch.randint(-(2**31), 2**31 - 1, (BATCH, k, LANES), dtype=torch.int32,
                      device="cuda", generator=g)
    out = torch.empty((BATCH, r, LANES), dtype=torch.int32, device="cuda")
    terms = codec_cuda.gf_terms(rows)
    got = codec_cuda.gf_apply_u32_batch(rows, x, terms)
    want = codec_cuda.gf_apply_batch_plain(rows, x)
    torch.cuda.synchronize()
    err = _max_abs_err(got, want)
    if err or not torch.equal(got, want):
        raise AssertionError(f"K2 {name}: kernel disagrees with its plain version")
    del got, want
    ms = _kernel_ms(lambda i: codec_cuda.gf_apply_u32_batch(rows, x, terms, out), iters=16)
    plain_ms = _time_ms(lambda i: codec_cuda.gf_apply_batch_plain(rows, x), 2, warm=1)
    nbytes = BATCH * (k + r) * 4 * LANES
    bound = nbytes / HBM_BYTES_PER_S * 1e3
    log(
        f"K2 gf_apply_batch {name} [{BATCH},{k},{LANES}]->[{BATCH},{r},{LANES}] on "
        f"{card}: byte-exact vs plain (max_abs_err 0); kernel {ms:.4f} ms "
        f"({nbytes / ms / 1e6:.1f} GB/s), plain {plain_ms:.3f} ms, bound "
        f"{bound:.4f} ms (bytes; {bound / ms:.3f} of it)"
    )
    return {
        "ms": ms, "plain_ms": plain_ms, "bound_ms": bound, "bound_by": "bytes",
        "max_abs_err": err,
    }


def check_verify(rows, seed: int, card: str) -> dict:
    """K3 at [16, 10, 262144] + [16, 4, 262144] lanes, with mismatches
    planted in several volumes; timed with its counts' memset."""
    import torch

    from seaweedfs_tpu_torch.ec import codec_cuda

    k, r = rows.shape[1], rows.shape[0]
    g = torch.Generator(device="cuda").manual_seed(seed)
    x = torch.randint(-(2**31), 2**31 - 1, (BATCH, k, LANES), dtype=torch.int32,
                      device="cuda", generator=g)
    parity = codec_cuda.gf_apply_batch_plain(rows, x)
    terms = codec_cuda.gf_terms(rows)
    clean = codec_cuda.gf_verify_u32_batch(rows, x, parity, terms)
    if clean.tolist() != [0] * BATCH:
        raise AssertionError(f"K3 flags clean parity: {clean.tolist()}")
    for v, n in ((1, 1), (6, 3), (15, 1000)):
        lanes = torch.randperm(LANES, device="cuda", generator=g)[:n]
        parity[v, v % r, lanes] ^= 0x01000100
    got = codec_cuda.gf_verify_u32_batch(rows, x, parity, terms)
    want = codec_cuda.gf_verify_batch_plain(rows, x, parity)
    torch.cuda.synchronize()
    err = _max_abs_err(got, want)
    if err or got.tolist() != [1000 if v == 15 else 3 if v == 6 else int(v == 1)
                               for v in range(BATCH)]:
        raise AssertionError(f"K3: counts {got.tolist()}, plain {want.tolist()}")
    ms = _kernel_ms(lambda i: codec_cuda.gf_verify_u32_batch(rows, x, parity, terms),
                    iters=16)
    plain_ms = _time_ms(lambda i: codec_cuda.gf_verify_batch_plain(rows, x, parity), 2,
                        warm=1)
    nbytes = BATCH * (k + r) * 4 * LANES + 4 * BATCH
    bound = nbytes / HBM_BYTES_PER_S * 1e3
    log(
        f"K3 gf_verify_batch [{BATCH},{k},{LANES}]+[{BATCH},{r},{LANES}] on {card}: "
        f"planted counts equal the plain version's (max_abs_err 0); kernel "
        f"{ms:.4f} ms with its memset ({nbytes / ms / 1e6:.1f} GB/s), plain "
        f"{plain_ms:.3f} ms, bound {bound:.4f} ms (bytes; {bound / ms:.3f} of it)"
    )
    return {
        "ms": ms, "plain_ms": plain_ms, "bound_ms": bound, "bound_by": "bytes",
        "max_abs_err": err,
    }


# --- phase 3: the single-volume path ----------------------------------------


def _file_crc(path: str) -> int:
    from seaweedfs_tpu_torch.util.crc import crc32c

    c = 0
    with open(path, "rb") as f:
        while True:
            b = f.read(16 << 20)
            if not b:
                return c
            c = crc32c(b, c)


def _counts() -> dict:
    from seaweedfs_tpu_torch.ec import codec_cuda, crc_kernel

    return {
        "gf_apply": codec_cuda.LAUNCHES,
        "gf_apply_batch": codec_cuda.BATCH_LAUNCHES,
        "gf_verify_batch": codec_cuda.VERIFY_LAUNCHES,
        "crc32c_rows": crc_kernel.LAUNCHES,
    }


def _reset_counts() -> None:
    for c in _counts().values():
        c.reset()


def _read_counts() -> dict:
    return {name: c.value for name, c in _counts().items()}


SIG_KERNELS = ("gf_apply", "crc32c_rows")  # the wrappers that tally signatures


def _read_sigs() -> dict:
    """{kernel: {signature: launches}} since the last reset, for the
    kernels whose wrappers tally their launch signatures: K1 (rows, k,
    n32, matrix bytes) and K4 (rows, n32)."""
    counts = _counts()
    return {name: counts[name].by_signature() for name in SIG_KERNELS}


def _add_sigs(*tallies, sign: int = 1) -> dict:
    """The sum of {kernel: {signature: n}} tallies; sign=-1 subtracts
    every tally after the first."""
    out = {name: dict(tallies[0].get(name, {})) for name in SIG_KERNELS}
    for tally in tallies[1:]:
        for name in SIG_KERNELS:
            for sig, n in tally.get(name, {}).items():
                out[name][sig] = out[name].get(sig, 0) + sign * n
    return {name: {sig: n for sig, n in by.items() if n} for name, by in out.items()}


def _must_launch(label: str, launches: dict, names) -> None:
    for kname in names:
        if launches[kname] <= 0:
            raise AssertionError(f"{label}: kernel {kname} was never launched")


def profile_encode(encode, workdir: str, card: str, label: str = "encode") -> dict:
    """Run encode() once more under torch.profiler and read the device
    timeline: busy = the union of kernel, copy and memset intervals on
    the card; idle share = 1 - busy / wall."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        encode()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    path = os.path.join(workdir, "trace.json")
    prof.export_chrome_trace(path)
    with open(path) as f:
        events = json.load(f)["traceEvents"]
    spans, by_cat = [], {}
    for e in events:
        cat = e.get("cat", "")
        if cat in ("kernel", "gpu_memcpy", "gpu_memset") and "dur" in e:
            spans.append((float(e["ts"]), float(e["ts"]) + float(e["dur"])))
            key = e["name"] if cat == "kernel" else cat
            by_cat[key] = by_cat.get(key, 0.0) + float(e["dur"]) / 1e3
    if not spans:
        raise AssertionError("the profiled encode recorded no device activity")
    busy, end = 0.0, float("-inf")
    for a, b in sorted(spans):
        if b > end:
            busy += b - max(a, end)
            end = b
    busy_ms = busy / 1e3
    out = {"wall_ms": wall * 1e3, "device_busy_ms": busy_ms,
           "idle_share": 1.0 - busy_ms / (wall * 1e3),
           "device_ms_by_name": {k: round(v, 4) for k, v in sorted(by_cat.items())}}
    os.remove(path)
    log(f"profiled {label} on {card}: " + json.dumps(out))
    return out


def run_main_path(workdir: str, volume_bytes: int, seed: int, device=None,
                  card: str = "") -> dict:
    """Encode one volume and rebuild 1 and 4 lost shards on `device`
    (None: the card), then run the degraded phase on it
    (run_degraded_phase). Returns per-run stats and kernel launches."""
    from seaweedfs_tpu_torch.ec import ec_files, ecc_sidecar
    from seaweedfs_tpu_torch.ec.codec import new_encoder
    from seaweedfs_tpu_torch.storage.needle import Needle
    from seaweedfs_tpu_torch.storage.super_block import VERSION3
    from seaweedfs_tpu_torch.storage.synthetic import write_volume

    base = os.path.join(workdir, "1")
    t0 = time.perf_counter()
    dat_size, entries = write_volume(base, volume_bytes, seed)
    log(f"volume: {dat_size} bytes, {len(entries)} needles, written in "
        f"{time.perf_counter() - t0:.3f} s")

    rs = new_encoder(backend="cuda", device=device)
    enc: dict = {}
    _reset_counts()
    t0 = time.perf_counter()
    ec_files.write_ec_files(base, rs=rs, want_crcs=True, durable=True, stats=enc)
    enc_wall = time.perf_counter() - t0
    enc_launch, enc_sigs = _read_counts(), _read_sigs()
    ec_files.write_sorted_file_from_idx(base, durable=True)
    if ecc_sidecar.write_sidecar(base, enc["shard_crcs"]) is None:
        raise AssertionError("the .ecc sidecar was not written")
    log(f"encode on {card}: {dat_size / enc_wall / 1e9:.3f} GB/s of .dat, wall "
        f"{enc_wall:.4f} s, launches {enc_launch}, stages "
        + json.dumps({k: enc[k] for k in ("read_s", "stage_s", "device_s",
                                           "writeback_s", "compute_s", "write_s",
                                           "flush_s", "loop_s", "overlap_s",
                                           "host_crc_rows")}))

    shard_paths = [base + ec_files.to_ext(i) for i in range(14)]
    host_crcs = [_file_crc(p) for p in shard_paths]
    if host_crcs != enc["shard_crcs"]:
        raise AssertionError(f"fused shard CRCs {enc['shard_crcs']} != host {host_crcs}")
    log("shard CRCs: 14 fused device CRCs equal the host shim's")

    # parity on sampled rows against the port's numpy codec
    rng = np.random.default_rng(seed + 1)
    cpu = new_encoder(backend="cpu")
    size = os.path.getsize(shard_paths[0])
    span = min(65536, size)
    handles = [open(p, "rb") for p in shard_paths]
    try:
        for off in rng.integers(0, size - span + 1, 8):
            rows = []
            for f in handles:
                f.seek(int(off))
                rows.append(np.frombuffer(f.read(span), dtype=np.uint8))
            want = cpu.encode(rows[:10] + [None] * 4)[10:]
            if not all(np.array_equal(a, b) for a, b in zip(want, rows[10:])):
                raise AssertionError(f"parity differs from the numpy codec at {off}")
    finally:
        for f in handles:
            f.close()
    log("parity: 8 sampled 64 KiB spans equal the numpy codec's")

    with open(base + ".dat", "rb") as dat:
        for j in rng.choice(len(entries), min(64, len(entries)), replace=False):
            nid, off, nsize = entries[int(j)]
            rec_len = 16 + nsize + 4 + 8
            blob = ec_files.read_shard_intervals(base, off, rec_len, dat_size)
            n = Needle.from_bytes(blob, VERSION3, nsize)  # verifies the CRC
            dat.seek(off)
            if n.id != nid or blob != dat.read(rec_len):
                raise AssertionError(f"needle {nid} read back wrong")
    log(f"needles: {min(64, len(entries))} read back through the striping, CRCs ok")

    originals = os.path.join(workdir, "orig")
    os.mkdir(originals)
    for p in shard_paths:
        shutil.copyfile(p, os.path.join(originals, os.path.basename(p)))
    runs = {"encode": {"wall_s": enc_wall, "launches": enc_launch, "sigs": enc_sigs,
                       "stats": enc}}
    for label, lost in (("rebuild1", (3,)), ("rebuild4", (0, 5, 10, 13))):
        for i in lost:
            os.remove(shard_paths[i])
        st: dict = {}
        _reset_counts()
        t0 = time.perf_counter()
        got = ec_files.rebuild_ec_files(base, rs=rs, want_crcs=True, durable=True, stats=st)
        wall = time.perf_counter() - t0
        launches, sigs = _read_counts(), _read_sigs()
        if tuple(got) != lost:
            raise AssertionError(f"{label}: rebuilt {got}, expected {lost}")
        for i in lost:
            if not filecmp.cmp(shard_paths[i], os.path.join(
                    originals, os.path.basename(shard_paths[i])), shallow=False):
                raise AssertionError(f"{label}: shard {i} is not byte-identical")
            if st["shard_crcs"][i] != enc["shard_crcs"][i]:
                raise AssertionError(f"{label}: shard {i} CRC differs")
        ecc_sidecar.write_sidecar(base, st["shard_crcs"])
        log(f"{label} {lost} on {card}: byte-identical, "
            f"{len(lost) * size / wall / 1e9:.3f} GB/s rebuilt, wall {wall:.4f} s, "
            f"launches {launches}, stages "
            + json.dumps({k: st[k] for k in ("read_s", "device_s", "writeback_s",
                                              "compute_s", "write_s", "loop_s",
                                              "host_crc_rows")}))
        runs[label] = {"wall_s": wall, "launches": launches, "sigs": sigs, "stats": st}
    if device is None:  # on the card every run must have gone through K1 and K4
        for label, run in runs.items():
            _must_launch(label, run["launches"], ("gf_apply", "crc32c_rows"))
    runs.update(run_degraded_phase(workdir, entries, originals, enc["shard_crcs"], device,
                                   card))
    if device is None:
        runs["profiled_encode"] = profile_encode(
            lambda: ec_files.write_ec_files(base, rs=rs, want_crcs=True), workdir, card)
    return runs


# --- phase 3b: degraded reads and the piggybacked rebuild --------------------

LOST = (0, 5, 10, 13)  # two data shards, two parity: all RS(10,4) tolerates
SF_THREADS, SF_NEEDLES, WARM_NEEDLES = 8, 16, 64


def _pct(xs, q: float) -> float:
    return float(np.percentile(np.asarray(xs), q)) * 1e3 if xs else float("nan")


def _lost_intervals(ev, off: int, size: int) -> list:
    """(shard, shard offset, length) of a .dat span's intervals that lie
    on a lost shard."""
    from seaweedfs_tpu_torch.ec import locate

    out = []
    for iv in locate.locate_data(locate.LARGE_BLOCK_SIZE, locate.SMALL_BLOCK_SIZE,
                                 ev.dat_file_size(), off, size):
        sid, soff = iv.to_shard_id_and_offset()
        if sid in LOST:
            out.append((sid, soff, iv.size))
    return out


def _span_delta(name: str, before: dict) -> dict:
    """What the spans named `name` added since the totals `before`
    (trace.totals): count, seconds, bytes and stage seconds."""
    from seaweedfs_tpu_torch import trace

    now = trace.totals(name)
    return {"count": now["count"] - before["count"],
            "seconds": now["seconds"] - before["seconds"],
            "bytes": now["bytes"] - before["bytes"],
            "stages": {k: v - before["stages"].get(k, 0.0)
                       for k, v in now["stages"].items()}}


def _thread_launches() -> tuple[dict, dict]:
    """The calling thread's own launches of every kernel, and its
    signature tallies (LaunchCounter.mine)."""
    counts = _counts()
    mine = {name: c.mine() for name, c in counts.items()}
    return ({name: n for name, (n, _) in mine.items()},
            {name: mine[name][1] for name in SIG_KERNELS})


def run_degraded_phase(workdir: str, entries: list, originals: str, enc_crcs: list,
                       device=None, card: str = "") -> dict:
    """The degraded-read side of the main path on volume 1 of `workdir`
    (whole, its shards saved in `originals`): lose shards LOST, read every
    needle through EcVolume (K1 decodes on `device`, None: the card), a
    warm pass, a singleflight check under SF_THREADS threads, then the
    piggybacked rebuild of the lost data shards while a thread keeps
    serving, and a plain rebuild of the lost parity. Raises on any fault;
    returns per-run stats, launches and signature tallies ("degraded",
    with the serving thread's reads during the rebuild; "repair_piggyback",
    the rebuild's own; "repair_parity"). The decode and gather times come
    from the "ec.degraded" spans' stages (trace.totals)."""
    from seaweedfs_tpu_torch import trace
    from seaweedfs_tpu_torch.ec import ec_files, ec_stream, repair_session
    from seaweedfs_tpu_torch.ec.codec import new_encoder
    from seaweedfs_tpu_torch.ec.ec_volume import _DECODE_RUN_TILES, EcVolume
    from seaweedfs_tpu_torch.stats.metrics import (
        EC_DEGRADED_READS, EC_REPAIR_BYTES_READ, EC_TILE_CACHE)
    from seaweedfs_tpu_torch.storage.needle import get_actual_size
    from seaweedfs_tpu_torch.storage.super_block import VERSION3

    on_card = device is None
    base = os.path.join(workdir, "1")
    paths = {i: base + ec_files.to_ext(i) for i in range(14)}
    for i in LOST:
        os.remove(paths[i])
    ev = EcVolume.load(workdir, 1, backend="cuda", device=device)
    tile = ev.tile_cache.tile_bytes
    runs: dict = {}

    def counters():
        return (EC_DEGRADED_READS.value(), EC_TILE_CACHE.value("hit"),
                EC_TILE_CACHE.value("miss"))

    dat_fd = os.open(base + ".dat", os.O_RDONLY)
    try:
        def check(n, off, size):
            rec = os.pread(dat_fd, get_actual_size(size, VERSION3), off)
            if n.to_bytes(VERSION3) != rec:
                raise AssertionError(f"needle {n.id}: bytes differ from the .dat record")

        lost_of = {nid: _lost_intervals(ev, off, get_actual_size(size, VERSION3))
                   for nid, off, size in entries}
        # --- cold pass: every needle ---
        _reset_counts()
        c0, s0 = counters(), trace.totals("ec.degraded")
        lat = {True: [], False: []}
        served = 0
        t0 = time.perf_counter()
        for nid, off, size in entries:
            t1 = time.perf_counter()
            n = ev.read_needle(nid)  # Needle.from_bytes checks the CRC
            lat[bool(lost_of[nid])].append(time.perf_counter() - t1)
            check(n, off, size)
            served += get_actual_size(size, VERSION3)
        wall = time.perf_counter() - t0
        read_s = {lost: sum(v) for lost, v in lat.items()}
        launches, sigs = _read_counts(), _read_sigs()
        c1, spans = counters(), _span_delta("ec.degraded", s0)
        cold = {
            "wall_s": wall, "needles": len(entries), "bytes": served,
            "degraded_needles": len(lat[True]),
            "read_s_lost": read_s[True], "read_s_healthy": read_s[False],
            "check_s": wall - read_s[True] - read_s[False],
            "degraded_reads": c1[0] - c0[0], "tile_hits": c1[1] - c0[1],
            "tile_misses": c1[2] - c0[2],
            "p50_ms_lost": _pct(lat[True], 50), "p99_ms_lost": _pct(lat[True], 99),
            "p50_ms_healthy": _pct(lat[False], 50), "p99_ms_healthy": _pct(lat[False], 99),
            "apply_s": spans["stages"].get("decode", 0.0), "apply_calls": spans["count"],
            "apply_mib": spans["bytes"] / 2**20,
            "gather_s": spans["stages"].get("gather", 0.0),
        }
        if not lat[True] or cold["degraded_reads"] <= 0:
            raise AssertionError("the cold pass served no needle from a lost shard")
        if on_card:
            _must_launch("degraded cold pass", launches, ("gf_apply",))
            if launches["crc32c_rows"]:
                raise AssertionError("the degraded read launched K4")
            if launches["gf_apply"] != spans["count"]:
                raise AssertionError(f"cold pass: {launches['gf_apply']} K1 launches for "
                                     f"{spans['count']} decodes")
        log(f"degraded cold pass on {card}: shards {LOST} lost, {len(entries)} needles "
            f"({cold['degraded_needles']} on a lost shard), {served} bytes, each equal to "
            f"its .dat record, CRC ok; wall {wall:.4f} s, launches {launches}, "
            + json.dumps({k: v for k, v in cold.items()
                          if k not in ("wall_s", "needles", "bytes", "degraded_needles")}))

        # --- warm pass: the last lost-shard needles again ---
        lost_ids = [e for e in entries if lost_of[e[0]]]
        warm_set = lost_ids[-WARM_NEEDLES:]
        resident = 0
        h0 = EC_TILE_CACHE.value("hit")
        _reset_counts()
        for nid, off, size in warm_set:
            before = _read_counts()["gf_apply"]
            covered = all(ev.tile_cache.covers(*iv) for iv in lost_of[nid])
            check(ev.read_needle(nid), off, size)
            if covered:
                resident += 1
                if _read_counts()["gf_apply"] != before:
                    raise AssertionError(f"warm needle {nid}: resident tiles decoded again")
        hits = EC_TILE_CACHE.value("hit") - h0
        warm_launches, warm_sigs = _read_counts(), _read_sigs()
        log(f"degraded warm pass on {card}: {len(warm_set)} lost-shard needles, "
            f"{resident} with every tile resident (no K1 launch for them), tile-cache "
            f"hits {hits}, launches {warm_launches}")

        # --- singleflight: 8 threads, the same 16 cold needles on shard 0 ---
        # Up to half of the needles span two or three tiles, so that a
        # decode run covers several; all their tiles fit the probation
        # segment, so none is evicted before its readers hit it. Every
        # thread reads them in one order, and a thread passes a needle
        # only once its tiles are cached, so the decodes are those of one
        # reader: a run of contiguous cold tiles of an interval, at most
        # ec_volume's _DECODE_RUN_TILES, is one K1 launch.
        ev.tile_cache.invalidate()  # every tile cold

        def tile_spans(nid):  # (first tile offset, tiles) of each lost interval
            return [(o // tile * tile, (o % tile + ln - 1) // tile + 1)
                    for _, o, ln in lost_of[nid]]

        on0 = [e for e in entries
               if lost_of[e[0]] and {iv[0] for iv in lost_of[e[0]]} == {0}]
        ntiles = {e[0]: sum(n for _, n in tile_spans(e[0])) for e in on0}
        multi = sorted((e for e in on0 if 2 <= ntiles[e[0]] <= 3),
                       key=lambda e: (ntiles[e[0]], e[2]))
        single = sorted((e for e in on0 if ntiles[e[0]] == 1), key=lambda e: e[2])
        budget = ev.tile_cache.probation_bytes_cap * 3 // 4 // tile
        order = [e for pair in zip(multi[:SF_NEEDLES // 2], single) for e in pair]
        order += [e for e in single + multi if e not in order]
        picked, tiles, decode_runs = [], set(), 0
        for e in order:
            mine = {o + j * tile for o, n in tile_spans(e[0]) for j in range(n)}
            if len(tiles | mine) > budget:
                continue
            picked.append(e)
            for o, n in tile_spans(e[0]):  # one reader's decode runs
                run = 0
                for j in range(n):
                    if o + j * tile in tiles:
                        run = 0  # a cached tile ends a run
                        continue
                    decode_runs += run % _DECODE_RUN_TILES == 0
                    run += 1
                    tiles.add(o + j * tile)
            if len(picked) == SF_NEEDLES:
                break
        if len(picked) < min(SF_NEEDLES, 4):
            raise AssertionError(f"only {len(picked)} cold needles on shard 0")
        barrier = threading.Barrier(SF_THREADS)
        got: list = [None] * SF_THREADS
        errors: list = []

        def sf_reader(t):
            try:
                barrier.wait(30)
                got[t] = [ev.read_needle(nid).to_bytes(VERSION3) for nid, _, _ in picked]
            except Exception as e:  # noqa: BLE001 — re-raised below
                errors.append(e)

        _reset_counts()
        c0 = counters()
        threads = [threading.Thread(target=sf_reader, args=(t,)) for t in range(SF_THREADS)]
        t0 = time.perf_counter()
        for th in threads:
            th.start()
        for th in threads:
            th.join(120)
        sf_wall = time.perf_counter() - t0
        if errors:
            raise errors[0]
        sf_launches, sf_sigs = _read_counts(), _read_sigs()
        c1 = counters()
        for t in range(1, SF_THREADS):
            if got[t] != got[0]:
                raise AssertionError(f"singleflight: thread {t} read other bytes")
        for (nid, off, size), rec in zip(picked, got[0]):
            if rec != os.pread(dat_fd, get_actual_size(size, VERSION3), off):
                raise AssertionError(f"singleflight: needle {nid} differs from the .dat")
        decodes = c1[2] - c0[2]
        if on_card and not 0 < sf_launches["gf_apply"] <= decode_runs:
            raise AssertionError(f"singleflight: {sf_launches['gf_apply']} K1 launches for "
                                 f"{decode_runs} decode runs ({len(tiles)} tiles)")
        log(f"singleflight on {card}: {SF_THREADS} threads x {len(picked)} cold needles on "
            f"shard 0 ({len(tiles)} distinct tiles in {decode_runs} decode runs), identical "
            f"bytes, wall {sf_wall:.4f} s, launches {sf_launches}, tile-cache misses "
            f"{decodes}")
        runs["degraded"] = {
            "wall_s": wall, "cold": cold,
            "launches": {k: launches[k] + warm_launches[k] + sf_launches[k]
                         for k in launches},
            "sigs": _add_sigs(sigs, warm_sigs, sf_sigs),
            "warm": {"needles": len(warm_set), "resident": resident, "hits": hits},
            "singleflight": {"needles": len(picked), "tiles": len(tiles),
                             "decode_runs": decode_runs,
                             "launches": sf_launches["gf_apply"], "wall_s": sf_wall},
        }

        # --- piggyback: rebuild shards 0 and 5 while serving them ---
        # A session consumes only ranges every one of its targets has
        # donated, and needle reads decode data shards only, so the
        # session names the data shards; the parity shards count as held
        # elsewhere (remote_readers, never read: ten local survivors) and
        # are rebuilt after.
        data_lost = tuple(i for i in LOST if i < 10)
        parity_lost = tuple(i for i in LOST if i >= 10)
        row = (os.path.getsize(paths[1]) // (2 * ec_files.SMALL_BLOCK_SIZE))
        lo, hi = row * ec_files.SMALL_BLOCK_SIZE, (row + 1) * ec_files.SMALL_BLOCK_SIZE
        for nid, off, size in entries:  # one whole block of each data target
            if any(sid in data_lost and lo <= soff < hi for sid, soff, _ in lost_of[nid]):
                ev.read_needle(nid)
        sess = repair_session.open_session(1, data_lost)
        seeded = ev.donate_cached_tiles(sess)
        serve_ids = [e[0] for e in entries
                     if {iv[0] for iv in lost_of[e[0]]} & set(data_lost)]
        stop = threading.Event()
        serving = {"needles": 0}

        def serve():
            # the serving thread's own launches are booked to the
            # degraded path, apart from the rebuild's
            n0, g0 = _thread_launches()
            try:
                while not stop.is_set():
                    for nid in serve_ids:
                        if stop.is_set():
                            break
                        ev.read_needle(nid)
                        serving["needles"] += 1
            except Exception as e:  # noqa: BLE001
                errors.append(e)
            finally:
                n1, g1 = _thread_launches()
                serving["launches"] = {k: n1[k] - n0[k] for k in n1}
                serving["sigs"] = _add_sigs(g1, g0, sign=-1)

        remote = {i: (lambda off, size, p=os.path.join(originals, os.path.basename(paths[i])):
                      _pread_file(p, off, size)) for i in parity_lost}
        r0 = EC_REPAIR_BYTES_READ.value("local") + EC_REPAIR_BYTES_READ.value("remote")
        st: dict = {}
        _reset_counts()
        server = threading.Thread(target=serve)
        server.start()
        t0 = time.perf_counter()
        try:
            got_ids = ec_stream.stream_rebuild_ec_files(
                base, tile_bytes=ec_stream.DEFAULT_TILE_BYTES // 2, stats=st,
                remote_readers=remote, session=sess, want_crcs=True, durable=True,
                device=device)
        finally:
            pig_wall = time.perf_counter() - t0
            stop.set()
            server.join(120)
            repair_session.close_session(sess)
        if errors:
            raise errors[0]
        window, window_sigs = _read_counts(), _read_sigs()
        pig_launches = {k: window[k] - serving["launches"][k] for k in window}
        pig_sigs = _add_sigs(window_sigs, serving["sigs"], sign=-1)
        read = EC_REPAIR_BYTES_READ.value("local") + EC_REPAIR_BYTES_READ.value("remote") - r0
        shard_len = os.path.getsize(paths[data_lost[0]])
        if tuple(got_ids) != data_lost:
            raise AssertionError(f"piggyback rebuilt {got_ids}, expected {data_lost}")
        used = st["used_donated_bytes"]
        if used <= 0:
            raise AssertionError("the piggybacked rebuild used no donated bytes")
        if read != 10 * (shard_len - used // len(data_lost)):
            raise AssertionError(f"piggyback read {read} survivor bytes, expected "
                                 f"{10 * (shard_len - used // len(data_lost))}")
        if serving["launches"]["crc32c_rows"]:
            raise AssertionError("the degraded reads during the rebuild launched K4")
        if on_card:
            _must_launch("piggybacked rebuild", pig_launches, ("gf_apply", "crc32c_rows"))
        log(f"piggybacked rebuild {data_lost} on {card} (session seeded with {seeded} tiles, "
            f"{serving['needles']} needles served meanwhile by a thread whose own launches "
            f"were {serving['launches']}): wall {pig_wall:.4f} s, donated "
            f"{st['donated_bytes']} bytes, used {used}, survivor bytes read {int(read)} "
            f"(naive {10 * shard_len}), serve_yields {st['serve_yields']}, the rebuild's "
            f"launches {pig_launches}, stages "
            + _stage_line(st, ("read_s", "device_s", "writeback_s", "compute_s", "write_s",
                               "loop_s", "host_crc_rows")))
        deg = runs["degraded"]
        deg["launches"] = {k: deg["launches"][k] + serving["launches"][k]
                           for k in deg["launches"]}
        deg["sigs"] = _add_sigs(deg["sigs"], serving["sigs"])
        deg["serve_during_repair"] = {"needles": serving["needles"],
                                      "launches": serving["launches"]}
        runs["repair_piggyback"] = {"wall_s": pig_wall, "launches": pig_launches,
                                    "sigs": pig_sigs, "stats": st, "read_bytes": read}
        st2: dict = {}
        _reset_counts()
        t0 = time.perf_counter()
        got_ids = ec_files.rebuild_ec_files(base, rs=new_encoder(backend="cuda", device=device),
                                            want_crcs=True, durable=True, stats=st2)
        wall2 = time.perf_counter() - t0
        runs["repair_parity"] = {"wall_s": wall2, "launches": _read_counts(),
                                 "sigs": _read_sigs(), "stats": st2}
        if tuple(got_ids) != parity_lost:
            raise AssertionError(f"parity rebuild returned {got_ids}")
        crcs = {**st["shard_crcs"], **st2["shard_crcs"]}
        for i in LOST:
            if not filecmp.cmp(paths[i], os.path.join(originals, os.path.basename(paths[i])),
                               shallow=False):
                raise AssertionError(f"degraded phase: shard {i} is not byte-identical")
            if crcs[i] != enc_crcs[i]:
                raise AssertionError(f"degraded phase: shard {i} CRC differs")
        log(f"parity rebuild {parity_lost} on {card}: wall {wall2:.4f} s, launches "
            f"{runs['repair_parity']['launches']}; shards {LOST} byte-identical to the "
            f"encode's, CRCs equal")
    finally:
        os.close(dat_fd)
        ev.close()
    return runs


def _pread_file(path: str, off: int, size: int) -> bytes:
    fd = os.open(path, os.O_RDONLY)
    try:
        return os.pread(fd, size, off)
    finally:
        os.close(fd)


# --- phase 3c: the volume store ---------------------------------------------

STORE_VID = 9
STORE_ROOM = 5 << 30  # the store phase's peak in its directory (about 4.3 GiB)
TIER_SHARDS = (1, 2)  # uploaded to the `dir` backend and attached
TIER_READS = 64


def _store_payload(seed: int, nid: int, version: int, size: int) -> bytes:
    """Needle nid's payload (rewrites bump `version`), made anew from the
    seed whenever it is checked, so the phase holds no copy of the GiB."""
    return np.random.default_rng((seed, nid, version)).bytes(size)


def _cpu_model() -> str:
    """The CPU's model: /proc/cpuinfo's "model name", else lscpu's
    "Model name", else the vendor, family and model numbers (a virtual
    machine may report its model name as "unknown")."""
    fields: dict = {}
    try:
        with open("/proc/cpuinfo") as f:
            for line in f:
                key, _, value = line.partition(":")
                key = key.strip()
                if not key and fields:
                    break  # the first processor's block is enough
                fields.setdefault(key, value.strip())
    except OSError:
        pass
    if fields.get("model name", "unknown") != "unknown":
        return fields["model name"]
    try:
        out = subprocess.run(["lscpu"], capture_output=True, text=True, timeout=30).stdout
        for line in out.splitlines():
            if line.startswith("Model name:") and "unknown" not in line:
                return line.split(":", 1)[1].strip()
    except (OSError, subprocess.SubprocessError):
        pass
    parts = [f"{k} {fields[k]}" for k in ("vendor_id", "cpu family", "model", "stepping")
             if k in fields]
    return "model name unknown (" + (", ".join(parts) or "nothing else reported") + ")"


def host_line() -> str:
    """The host's CPU model, core count and the native codec's SIMD path."""
    from seaweedfs_tpu_torch.native import gf

    return f"{_cpu_model()}, os.cpu_count() {os.cpu_count()}, native SIMD path {gf.caps()}"


def time_native_apply(rows, nbytes: int, seed: int, reps: int = 20) -> float:
    """Median ms of one native apply_matrix call (one thread) of `rows`
    over a [k, nbytes] tile: the host codec's counterpart of a K1 launch."""
    from seaweedfs_tpu_torch.native import gf

    x = np.random.default_rng(seed).integers(0, 256, (rows.shape[1], nbytes), dtype=np.uint8)
    gf.apply_matrix(rows, x)
    times = []
    for _ in range(reps):
        t0 = time.perf_counter()
        gf.apply_matrix(rows, x)
        times.append(time.perf_counter() - t0)
    return float(np.median(times)) * 1e3


def _same_files(a: str, b: str, exts) -> None:
    for ext in exts:
        if not filecmp.cmp(a + ext, b + ext, shallow=False):
            raise AssertionError(f"{a}{ext} and {b}{ext} differ")


def _timed(fn) -> tuple[float, object]:
    t0 = time.perf_counter()
    out = fn()
    return time.perf_counter() - t0, out


def run_store_phase(workdir: str, volume_bytes: int, seed: int, device=None,
                    card: str = "", smi: str = "") -> dict:
    """The port's storage path on `device` (None: the card), through a
    Store over one DiskLocation in `workdir`: write a volume of about
    `volume_bytes` through Store.write_needle, delete every 16th needle,
    rewrite every 64th (ids 5, 69, ...) under its own id, vacuum, seal;
    encode it on the cuda backend and with the native host codec (byte-
    identical, CRCs equal the host shim's), rebuild shards LOST both ways;
    serve every live needle through the Store's EcVolume with LOST gone
    (K1), then tier shards TIER_SHARDS to a `dir` backend, reload through
    a fresh Store and read TIER_READS needles on shards 0, 1 and 2 (K1
    decoding with remote survivors). Returns per-run stats, launches
    and signature tallies: store_encode, store_rebuild4, store_serve,
    store_tier."""
    from seaweedfs_tpu_torch.ec import ec_files, ecc_sidecar, locate
    from seaweedfs_tpu_torch.ec.codec import new_encoder
    from seaweedfs_tpu_torch.ec.ec_volume import RemoteEcAttachment
    from seaweedfs_tpu_torch.stats.metrics import TIER_REMOTE_READS
    from seaweedfs_tpu_torch.storage import backend
    from seaweedfs_tpu_torch.storage.needle import Needle, get_actual_size
    from seaweedfs_tpu_torch.storage.store import Store
    from seaweedfs_tpu_torch.storage.volume import NeedleNotFound

    _check_room(workdir, STORE_ROOM if volume_bytes >= 1 << 30 else 6 * volume_bytes,
                "the store phase")
    on_card = device is None
    vdir = os.path.join(workdir, "store")
    store = Store([vdir], device=device)
    vol = store.add_volume(STORE_VID)
    rng = np.random.default_rng(seed + 31)
    sizes, written, nid = {}, 0, 0
    t0 = time.perf_counter()
    while written < volume_bytes:
        nid += 1
        size = int(np.exp(rng.uniform(np.log(1024), np.log(4 << 20))))
        sizes[nid] = size
        store.write_needle(STORE_VID, Needle(cookie=nid, id=nid,
                                             data=_store_payload(seed, nid, 0, size)))
        written = vol.data_file_size()
    write_s = time.perf_counter() - t0
    version = dict.fromkeys(sizes, 0)
    deleted = {i for i in sizes if i % 16 == 0}
    rewritten = [i for i in sizes if i % 64 == 5]
    for i in sorted(deleted):
        store.delete_needle(STORE_VID, Needle(cookie=i, id=i))
    for i in rewritten:
        version[i] = 1
        store.write_needle(STORE_VID, Needle(cookie=i, id=i,
                                             data=_store_payload(seed, i, 1, sizes[i])))
    garbage = vol.garbage_level()
    before = vol.data_file_size()
    vacuum_s, _ = _timed(lambda: (vol.compact(), vol.commit_compact()))
    if not store.mark_volume_readonly(STORE_VID) or vol.garbage_level() != 0.0:
        raise AssertionError("the vacuumed volume did not seal clean")
    live = sorted(set(sizes) - deleted)

    def check_reads(read, label, ids=live):
        for i in ids:
            if bytes(read(i).data) != _store_payload(seed, i, version[i], sizes[i]):
                raise AssertionError(f"{label}: needle {i} read back wrong")

    read_s, _ = _timed(lambda: check_reads(lambda i: store.read_needle(STORE_VID, i, i),
                                           "store"))
    for i in deleted:
        try:
            store.read_needle(STORE_VID, i)
        except NeedleNotFound:
            continue
        raise AssertionError(f"deleted needle {i} still reads")
    dat_size = vol.data_file_size()
    log(f"store write on {card}: {len(sizes)} needles, {written} bytes through "
        f"Store.write_needle in {write_s:.4f} s ({written / write_s / 1e9:.3f} GB/s); "
        f"{len(deleted)} deleted, {len(rewritten)} rewritten, garbage {garbage:.4f}; "
        f"vacuum {before} -> {dat_size} bytes in {vacuum_s:.4f} s; sealed; "
        f"{len(live)} live needles read back equal in {read_s:.4f} s, "
        f"{len(deleted)} deleted raise NeedleNotFound")

    # --- encode: the card against the native host codec ---
    base = vol.base_name
    host_dir = os.path.join(workdir, "native")
    os.mkdir(host_dir)
    host = os.path.join(host_dir, os.path.basename(base))
    for ext in (".dat", ".idx"):
        os.symlink(base + ext, host + ext)
    runs: dict = {}
    gs, ns = {}, {}
    rs = new_encoder(backend="cuda", device=device)
    nat = new_encoder(backend="native")
    _reset_counts()
    card_s, _ = _timed(lambda: ec_files.write_ec_files(base, rs=rs, want_crcs=True,
                                                       durable=True, stats=gs))
    runs["store_encode"] = {"wall_s": card_s, "launches": _read_counts(),
                            "sigs": _read_sigs(), "stats": gs}
    host_s, _ = _timed(lambda: ec_files.write_ec_files(host, rs=nat, want_crcs=True,
                                                       durable=True, stats=ns))
    for b in (base, host):
        ec_files.write_sorted_file_from_idx(b, durable=True)
    ecc_sidecar.write_sidecar(base, gs["shard_crcs"])
    ecc_sidecar.write_sidecar(host, ns["shard_crcs"])
    shards = [ec_files.to_ext(i) for i in range(14)]
    _same_files(base, host, shards + [".ecx", ".ecc"])
    if gs["shard_crcs"] != ns["shard_crcs"] or gs["shard_crcs"] != [
            _file_crc(base + ext) for ext in shards]:
        raise AssertionError("store encode: shard CRCs differ (card, native, host shim)")
    runs["store_encode"]["native_wall_s"] = host_s
    apply_ms = time_native_apply(rs.parity_rows, 4 * LANES, seed + 32)
    runs["store_encode"]["native_apply_ms"] = apply_ms
    log(f"native apply_matrix, one thread, encode rows over one [10, {4 * LANES}] byte "
        f"tile (K1's [10, {LANES}] lanes): {apply_ms:.4f} ms a call "
        f"({10 * 4 * LANES / apply_ms / 1e6:.3f} GB/s of input); host {host_line()}")
    log(f"store encode of {dat_size} bytes: card {card_s:.4f} s "
        f"({dat_size / card_s / 1e9:.3f} GB/s) vs native {host_s:.4f} s "
        f"({dat_size / host_s / 1e9:.3f} GB/s), shards, .ecx and .ecc byte-identical, "
        f"CRCs equal the host shim's; card {smi}; host {host_line()}; launches "
        f"{runs['store_encode']['launches']}")

    # --- rebuild LOST: the card against the native host codec ---
    originals = os.path.join(workdir, "store_orig")
    os.mkdir(originals)
    for i in LOST:
        os.replace(base + shards[i], os.path.join(originals, shards[i]))
        os.remove(host + shards[i])
    rc, rn = {}, {}
    _reset_counts()
    card_s, got = _timed(lambda: ec_files.rebuild_ec_files(
        base, rs=rs, want_crcs=True, durable=True, stats=rc))
    runs["store_rebuild4"] = {"wall_s": card_s, "launches": _read_counts(),
                              "sigs": _read_sigs(), "stats": rc}
    host_s, got_n = _timed(lambda: ec_files.rebuild_ec_files(
        host, rs=nat, want_crcs=True, durable=True, stats=rn))
    if tuple(got) != LOST or tuple(got_n) != LOST:
        raise AssertionError(f"store rebuild: rebuilt {got} / {got_n}, expected {LOST}")
    for i in LOST:
        _same_files(base, host, [shards[i]])
        if not filecmp.cmp(base + shards[i], os.path.join(originals, shards[i]),
                           shallow=False):
            raise AssertionError(f"store rebuild: shard {i} is not byte-identical")
        if rc["shard_crcs"][i] != gs["shard_crcs"][i] or rn["shard_crcs"][i] != gs[
                "shard_crcs"][i]:
            raise AssertionError(f"store rebuild: shard {i} CRC differs")
    shutil.rmtree(originals)
    shutil.rmtree(host_dir)
    shard_len = os.path.getsize(base + shards[0])
    runs["store_rebuild4"]["native_wall_s"] = host_s
    log(f"store rebuild4 {LOST} of {len(LOST) * shard_len} bytes: card {card_s:.4f} s "
        f"({len(LOST) * shard_len / card_s / 1e9:.3f} GB/s) vs native {host_s:.4f} s "
        f"({len(LOST) * shard_len / host_s / 1e9:.3f} GB/s), byte-identical, CRCs equal "
        f"the encode's; card {smi}; host {host_line()}; launches "
        f"{runs['store_rebuild4']['launches']}")

    # --- serve through the store with LOST gone ---
    ev = store.mount_ec_shards(STORE_VID, "", list(range(14)))
    store.unmount_ec_shards(STORE_VID, list(LOST))
    for i in LOST:
        os.remove(base + shards[i])
    _reset_counts()
    serve_s, _ = _timed(lambda: check_reads(
        lambda i: store.find_ec_volume(STORE_VID).read_needle(i), "store serve"))
    runs["store_serve"] = {"wall_s": serve_s, "launches": _read_counts(),
                           "sigs": _read_sigs()}
    if on_card:
        _must_launch("store serve", runs["store_serve"]["launches"], ("gf_apply",))
    log(f"store serve on {card}: {len(live)} live needles through the Store's EcVolume "
        f"with shards {LOST} lost, each equal to its payload, wall {serve_s:.4f} s, "
        f"launches {runs['store_serve']['launches']}")

    # --- tier shards TIER_SHARDS to a `dir` backend, reload, read ---
    backend.ensure_builtin_factories()
    backend.load_backend_config(
        {"dir": {"smoke": {"enabled": True, "dir": os.path.join(workdir, "remote")}}})
    storage = backend.get_backend("dir.smoke")
    remote = {}
    for i in TIER_SHARDS:
        key, size = storage.copy_file(base + shards[i], {"volumeId": str(STORE_VID),
                                                        "ext": shards[i]})
        remote[i] = {"key": key, "size": size}
    ev.attach_remote(RemoteEcAttachment(storage.name, shard_len, remote))
    store.unmount_ec_shards(STORE_VID, list(TIER_SHARDS))
    for i in TIER_SHARDS:
        os.remove(base + shards[i])
    store.close()
    store = Store([vdir], device=device)  # DiskLocation._load_ec_shards -> load_remote
    try:
        ev = store.find_ec_volume(STORE_VID)
        if ev is None or ev.remote is None or sorted(ev.remote.shards) != list(TIER_SHARDS):
            raise AssertionError("the reloaded store did not attach the tiered shards")
        picked, on = [], {0: 0, 1: 0, 2: 0}
        for i in live:
            off, size = ev.locate_needle(i)
            ids = {iv.to_shard_id_and_offset()[0] for iv in locate.locate_data(
                locate.LARGE_BLOCK_SIZE, locate.SMALL_BLOCK_SIZE, ev.dat_file_size(),
                off, get_actual_size(size, ev.version))}
            hit = ids & {0, *TIER_SHARDS}
            # an even share of needles on shard 0 (decoded) and on 1 and 2
            if hit and (0 not in hit or on[0] < TIER_READS // 2):
                picked.append(i)
                for s in hit:
                    on[s] += 1
            if len(picked) == TIER_READS:
                break
        reads0 = TIER_REMOTE_READS.value()
        _reset_counts()
        tier_s, _ = _timed(lambda: check_reads(ev.read_needle, "store tier", picked))
        runs["store_tier"] = {"wall_s": tier_s, "launches": _read_counts(),
                              "sigs": _read_sigs(), "needles": len(picked),
                              "remote_reads": int(TIER_REMOTE_READS.value() - reads0)}
    finally:
        store.close()
        backend.BACKEND_STORAGES.pop("dir.smoke", None)
    if runs["store_tier"]["remote_reads"] <= 0 or on[0] == 0:
        raise AssertionError(f"store tier: {runs['store_tier']['remote_reads']} remote "
                             f"reads, {on[0]} needles on shard 0")
    if on_card:
        _must_launch("store tier", runs["store_tier"]["launches"], ("gf_apply",))
    log(f"store tier on {card}: shards {TIER_SHARDS} in a `dir` backend, reloaded "
        f"through a fresh Store; {len(picked)} needles (on shard 0: {on[0]}, 1: {on[1]}, "
        f"2: {on[2]}) equal to their payloads, {runs['store_tier']['remote_reads']} "
        f"ranged backend reads, wall {tier_s:.4f} s, launches "
        f"{runs['store_tier']['launches']}")
    return runs


# --- phase 4: the batch path ------------------------------------------------


def _stage_line(st: dict, keys) -> str:
    return json.dumps({k: st[k] for k in keys if k in st})


def _check_room(workdir: str, need: int, what: str = "the batch phase") -> None:
    free = shutil.disk_usage(workdir).free
    if free < need:
        raise AssertionError(
            f"{what} needs {need / 2**30:.2f} GiB free in {workdir}, "
            f"which has {free / 2**30:.2f} GiB"
        )


def run_batch_phase(workdir: str, volumes: int, volume_bytes: int, seed: int,
                    devices=None, card: str = "") -> dict:
    """Encode `volumes` sealed volumes through ec_files.write_ec_files_batch,
    rebuild two damage signatures in one rebuild_ec_files_batch call, and
    verify 16 of them with MeshCodec.verify_batch_u32. devices=None runs
    on the card through codec=None, as a user calls it; a list of devices
    (["cpu"]) runs the same checks on an explicit mesh."""
    import torch

    from seaweedfs_tpu_torch.ec import codec_cuda, ec_files, ec_stream, ecc_sidecar
    from seaweedfs_tpu_torch.ec.codec import new_encoder
    from seaweedfs_tpu_torch.parallel import MeshCodec, make_mesh
    from seaweedfs_tpu_torch.storage.needle import Needle
    from seaweedfs_tpu_torch.storage.super_block import VERSION3
    from seaweedfs_tpu_torch.storage.synthetic import write_volume

    shard_bytes = 1 << 20  # one small row per volume: 14 x 1 MiB
    odd, even = (3,), (0, 5, 10, 13)
    # the volumes, their shards, a second shard set from the host route,
    # the rebuild's saved originals
    need = volumes * (volume_bytes + 2 * 14 * shard_bytes) + (
        (volumes // 2) * (len(odd) + len(even)) + 4 * 14) * shard_bytes
    _check_room(workdir, int(need * 1.1))
    codec = None if devices is None else MeshCodec(make_mesh(devices))
    card_only = devices is None

    t0 = time.perf_counter()
    bases, entries, dat_bytes = [], [], 0
    for v in range(volumes):
        base = os.path.join(workdir, str(v + 1))
        size, ents = write_volume(base, volume_bytes, seed * 100003 + v, max_payload=1 << 20)
        bases.append(base)
        entries.append(ents)
        dat_bytes += size
    log(f"batch volumes: {volumes} x ~{volume_bytes / 2**20:.2f} MiB, {dat_bytes} bytes of "
        f".dat, {sum(map(len, entries))} needles, written in "
        f"{time.perf_counter() - t0:.3f} s")

    runs: dict = {}
    old_limit = os.environ.get("WEED_EC_PIPELINE_BATCH")
    os.environ["WEED_EC_PIPELINE_BATCH"] = str(BATCH)
    try:
        # --- encode ---
        enc: dict = {}
        _reset_counts()
        t0 = time.perf_counter()
        ec_files.write_ec_files_batch(bases, codec=codec, want_crcs=True, durable=True,
                                      stats=enc)
        if card_only:
            torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches, sigs = _read_counts(), _read_sigs()
        for base, crcs in zip(bases, enc["shard_crcs"]):
            ec_files.write_sorted_file_from_idx(base, durable=True)
            if ecc_sidecar.write_sidecar(base, crcs) is None:
                raise AssertionError(f"{base}: the .ecc sidecar was not written")
        log(f"batch encode of {volumes} volumes on {card}: {dat_bytes / wall / 1e9:.3f} "
            f"GB/s of .dat, wall {wall:.4f} s, launches {launches}, ring "
            f"{enc['ring_bytes']} bytes, pinned {enc['ring_pinned']}, mesh {enc['mesh']}, "
            f"stages " + _stage_line(enc, ("read_s", "device_s", "writeback_s",
                                            "compute_s", "write_s", "flush_s", "loop_s",
                                            "overlap_s", "host_crc_rows")))
        runs["batch_encode"] = {"wall_s": wall, "launches": launches, "sigs": sigs,
                                "stats": enc}
        if card_only:
            _must_launch("batch encode", launches, ("gf_apply_batch", "crc32c_rows"))
            # once more under the profiler, into copies of the first chunk
            prof_dir = os.path.join(workdir, "profiled")
            os.mkdir(prof_dir)
            copies = []
            for base in bases[:BATCH]:
                copies.append(os.path.join(prof_dir, os.path.basename(base)))
                shutil.copyfile(base + ".dat", copies[-1] + ".dat")
            runs["profiled_batch_encode"] = profile_encode(
                lambda: ec_files.write_ec_files_batch(copies, want_crcs=True),
                workdir, card, f"batch encode of {len(copies)} volumes (one chunk)")
            shutil.rmtree(prof_dir)

        host = [[_file_crc(b + ec_files.to_ext(i)) for i in range(14)] for b in bases]
        if host != enc["shard_crcs"]:
            bad = [v for v in range(volumes) if host[v] != enc["shard_crcs"][v]]
            raise AssertionError(f"batch shard CRCs differ from the host shim's: {bad[:8]}")
        log(f"batch shard CRCs: all {volumes * 14} fused device CRCs equal the host shim's")

        rng = np.random.default_rng(seed + 7)
        cpu = new_encoder(backend="cpu")
        for v in rng.choice(volumes, 8, replace=False):
            off, span = int(rng.integers(0, shard_bytes - 65536)), 65536
            rows = []
            for i in range(14):
                with open(bases[v] + ec_files.to_ext(i), "rb") as f:
                    f.seek(off)
                    rows.append(np.frombuffer(f.read(span), dtype=np.uint8))
            want = cpu.encode(rows[:10] + [None] * 4)[10:]
            if not all(np.array_equal(a, b) for a, b in zip(want, rows[10:])):
                raise AssertionError(f"volume {v + 1}: parity differs from the numpy codec")
        log("batch parity: 8 volumes' sampled 64 KiB spans equal the numpy codec's")

        for _ in range(16):
            v = int(rng.integers(volumes))
            nid, off, nsize = entries[v][int(rng.integers(len(entries[v])))]
            rec_len = 16 + nsize + 4 + 8
            size = os.path.getsize(bases[v] + ".dat")
            blob = ec_files.read_shard_intervals(bases[v], off, rec_len, size)
            n = Needle.from_bytes(blob, VERSION3, nsize)  # verifies the CRC
            with open(bases[v] + ".dat", "rb") as dat:
                dat.seek(off)
                if n.id != nid or blob != dat.read(rec_len):
                    raise AssertionError(f"volume {v + 1} needle {nid} read back wrong")
        log("batch needles: 16 read back through the striping, CRCs ok")

        # the simple alternative to the batch arm: write_ec_files (K1) in a
        # loop over the same volumes, with the same options, timed call by
        # call; its CRCs must equal the batch's, and 4 volumes' shard
        # files are compared byte for byte
        single_dir = os.path.join(workdir, "single")
        os.mkdir(single_dir)
        rs = new_encoder(backend="cuda", device=None if card_only else "cpu")
        compare = {int(v) for v in rng.choice(volumes, 4, replace=False)}
        loop_s, loop_stats = 0.0, {}
        for v in range(volumes):
            one = os.path.join(single_dir, str(v + 1))
            os.symlink(bases[v] + ".dat", one + ".dat")
            st1: dict = {}
            t0 = time.perf_counter()
            ec_files.write_ec_files(one, rs=rs, want_crcs=True, durable=True, stats=st1)
            loop_s += time.perf_counter() - t0
            for k in ("read_s", "device_s", "writeback_s", "write_s", "loop_s"):
                loop_stats[k] = loop_stats.get(k, 0.0) + st1[k]
            if st1["shard_crcs"] != enc["shard_crcs"][v]:
                raise AssertionError(f"volume {v + 1}: single-volume CRCs != batch CRCs")
            for i in range(14):
                ext = ec_files.to_ext(i)
                if v in compare and not filecmp.cmp(one + ext, bases[v] + ext,
                                                    shallow=False):
                    raise AssertionError(f"volume {v + 1} shard {i}: batch != single-volume")
                os.remove(one + ext)
            os.remove(one + ".dat")
        shutil.rmtree(single_dir)
        log(f"write_ec_files loop over the same {volumes} volumes on {card}: "
            f"{dat_bytes / loop_s / 1e9:.3f} GB/s of .dat, {loop_s:.4f} s in the calls "
            f"(batch encode wall {wall:.4f} s, {loop_s / wall:.3f}x of it), summed stages "
            + json.dumps({k: round(t, 4) for k, t in loop_stats.items()})
            + f"; every volume's 14 CRCs equal the batch's, 4 volumes' shard files "
            f"byte-identical (K2 against K1)")
        runs["batch_encode"]["loop_s"] = loop_s

        # the batch encode's host route: the native codec, volume by
        # volume through the pipelined driver, against the K2 run
        host_codec = ec_stream._HostBatchCodec(new_encoder(backend="native"))
        host_dir = os.path.join(workdir, "host")
        os.mkdir(host_dir)
        hosts = []
        for base in bases:
            hosts.append(os.path.join(host_dir, os.path.basename(base)))
            os.symlink(base + ".dat", hosts[-1] + ".dat")
        hs: dict = {}
        t0 = time.perf_counter()
        ec_files.write_ec_files_batch(hosts, codec=host_codec, want_crcs=True, durable=True,
                                      stats=hs)
        host_wall = time.perf_counter() - t0
        if hs["shard_crcs"] != enc["shard_crcs"] or hs.get("codec_arm") != "host":
            raise AssertionError("batch encode: the host route's CRCs differ from K2's")
        for base, hbase in zip(bases, hosts):
            _same_files(base, hbase, [ec_files.to_ext(i) for i in range(14)])
        shutil.rmtree(host_dir)
        runs["batch_encode"]["native_wall_s"] = host_wall
        log(f"batch encode of {volumes} volumes: card (K2) {wall:.4f} s "
            f"({dat_bytes / wall / 1e9:.3f} GB/s) vs native host route {host_wall:.4f} s "
            f"({dat_bytes / host_wall / 1e9:.3f} GB/s); all {volumes * 14} shard files "
            f"byte-identical, CRCs equal; card {gpu_line() if card_only else card}; "
            f"host {host_line()}")

        # --- rebuild: two signature groups in one call ---
        originals = os.path.join(workdir, "orig")
        os.mkdir(originals)
        lost = [odd if v % 2 else even for v in range(volumes)]
        for base, ls in zip(bases, lost):
            for i in ls:
                p = base + ec_files.to_ext(i)
                os.replace(p, os.path.join(originals, os.path.basename(p)))
        st: dict = {}
        _reset_counts()
        t0 = time.perf_counter()
        got = ec_files.rebuild_ec_files_batch(bases, codec=codec, want_crcs=True,
                                              durable=True, stats=st)
        if card_only:
            torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches, sigs = _read_counts(), _read_sigs()
        if got != [list(ls) for ls in lost] or st["batch_groups"] != 2:
            raise AssertionError(f"batch rebuild returned {got[:4]}..., groups "
                                 f"{st['batch_groups']}")
        rebuilt = 0
        for v, (base, ls) in enumerate(zip(bases, lost)):
            for i in ls:
                p = base + ec_files.to_ext(i)
                if not filecmp.cmp(p, os.path.join(originals, os.path.basename(p)),
                                   shallow=False):
                    raise AssertionError(f"volume {v + 1} shard {i} is not byte-identical")
                if st["shard_crcs"][v][i] != enc["shard_crcs"][v][i]:
                    raise AssertionError(f"volume {v + 1} shard {i}: rebuilt CRC differs")
                rebuilt += os.path.getsize(p)
        # the same damage through the batch host arm (native codec)
        for base, ls in zip(bases, lost):
            for i in ls:
                os.remove(base + ec_files.to_ext(i))
        hst: dict = {}
        t0 = time.perf_counter()
        got_h = ec_files.rebuild_ec_files_batch(bases, codec=host_codec, want_crcs=True,
                                                durable=True, stats=hst)
        host_rebuild = time.perf_counter() - t0
        if got_h != got or hst["shard_crcs"] != st["shard_crcs"]:
            raise AssertionError("batch rebuild: the host arm differs from K2's")
        for v, (base, ls) in enumerate(zip(bases, lost)):
            for i in ls:
                p = base + ec_files.to_ext(i)
                if not filecmp.cmp(p, os.path.join(originals, os.path.basename(p)),
                                   shallow=False):
                    raise AssertionError(f"host arm: volume {v + 1} shard {i} differs")
        shutil.rmtree(originals)
        log(f"batch rebuild (two groups: {odd} x {volumes - volumes // 2}, {even} x "
            f"{volumes // 2}) on {card}: byte-identical, CRCs equal the encode's, "
            f"{rebuilt / wall / 1e9:.3f} GB/s rebuilt, wall {wall:.4f} s, launches "
            f"{launches}, stages " + _stage_line(st, ("read_s", "device_s", "writeback_s",
                                                      "compute_s", "write_s", "loop_s",
                                                      "host_crc_rows")))
        log(f"batch rebuild of the same damage: card (K2) {wall:.4f} s vs native host "
            f"arm {host_rebuild:.4f} s ({rebuilt / host_rebuild / 1e9:.3f} GB/s), "
            f"byte-identical, CRCs equal; card {gpu_line() if card_only else card}; "
            f"host {host_line()}")
        runs["batch_rebuild"] = {"wall_s": wall, "launches": launches, "sigs": sigs,
                                 "stats": st, "native_wall_s": host_rebuild}
        if card_only:
            _must_launch("batch rebuild", launches, ("gf_apply_batch",))
    finally:
        if old_limit is None:
            os.environ.pop("WEED_EC_PIPELINE_BATCH", None)
        else:
            os.environ["WEED_EC_PIPELINE_BATCH"] = old_limit

    # --- verify: 16 volumes, clean and with planted faults ---
    nv = min(BATCH, volumes)
    data = np.empty((nv, 10, shard_bytes), dtype=np.uint8)
    parity = np.empty((nv, 4, shard_bytes), dtype=np.uint8)
    for v in range(nv):
        for i in range(14):
            with open(bases[v] + ec_files.to_ext(i), "rb") as f:
                (data[v, i] if i < 10 else parity[v, i - 10])[:] = np.frombuffer(
                    f.read(), dtype=np.uint8)
    vcodec = codec or MeshCodec(make_mesh())
    _reset_counts()
    t0 = time.perf_counter()
    counts = [np.asarray(vcodec.verify_batch_u32(
        vcodec.shard_volumes(data.view(np.uint32)),
        vcodec.shard_volumes(parity.view(np.uint32)))).tolist()]
    wall = time.perf_counter() - t0
    parity[5, 2, 12345] ^= 0x20  # parity shard 12 of volume 5
    counts.append(np.asarray(vcodec.verify_batch_u32(
        vcodec.shard_volumes(data.view(np.uint32)),
        vcodec.shard_volumes(parity.view(np.uint32)))).tolist())
    data[9, 4, 777] ^= 0x01  # one data byte of volume 9
    counts.append(np.asarray(vcodec.verify_batch_u32(
        vcodec.shard_volumes(data.view(np.uint32)),
        vcodec.shard_volumes(parity.view(np.uint32)))).tolist())
    launches, sigs = _read_counts(), _read_sigs()
    dev = vcodec.devices[0]
    plain = codec_cuda.gf_verify_batch_plain(
        vcodec.matrix[10:], torch.from_numpy(data.view(np.int32)).to(dev),
        torch.from_numpy(parity.view(np.int32)).to(dev)).tolist()
    want = [[0] * nv, [int(v == 5) for v in range(nv)]]
    if counts[:2] != want or counts[2] != plain or counts[2][9] == 0:
        raise AssertionError(f"verify counts {counts}, plain {plain}")
    log(f"batch verify of {nv} volumes on {card}: clean {counts[0]}, parity byte "
        f"flipped in volume 5 {counts[1]}, data byte flipped in volume 9 {counts[2]} "
        f"(= the plain version's); first call wall {wall:.4f} s, launches {launches}")
    runs["batch_verify"] = {"wall_s": wall, "launches": launches, "sigs": sigs,
                            "counts": counts}
    if card_only:
        _must_launch("batch verify", launches, ("gf_verify_batch",))
    return runs


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--volume-mib", type=int, default=1024)
    args = ap.parse_args()

    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; nothing was run", file=sys.stderr)
        return 1
    from seaweedfs_tpu_torch import _build

    name = torch.cuda.get_device_name(0)
    count = torch.cuda.device_count()
    smi = gpu_line()
    card = f"{smi} ({name})"
    log(f"device: {name}, count {count}, nvidia-smi: {smi}")
    log(f"torch {torch.__version__}, CUDA {torch.version.cuda}, python {sys.version.split()[0]}")

    t0 = time.perf_counter()
    _build.build(_build.CUDA_SOURCES + ("crc32c.c", "gf256.c"))
    log(f"built {_build.CUDA_SOURCES}, the host CRC shim and the native GF(2^8) codec in "
        f"{time.perf_counter() - t0:.2f} s; host {host_line()}")
    for line in ptxas_summary(_build.build_logs) or ["none: every library was already built"]:
        log(f"  ptxas {line}")

    from seaweedfs_tpu_torch.ec import gf256

    matrix = gf256.build_code_matrix(10, 14)
    k1_enc = check_gf("encode", matrix[10:], args.seed, card)
    lost = LOST
    survivors = tuple(i for i in range(14) if i not in lost)
    k1_dec = check_gf("decode4", gf256.decode_rows(matrix, survivors, lost),
                      args.seed + 1, card)
    # the single-shard rebuild's matrix: shard 3 from the first 10 survivors
    k1_dec1 = check_gf("decode1", gf256.decode_rows(
        matrix, tuple(i for i in range(14) if i != 3)[:10], (3,)), args.seed + 6, card)
    # the degraded read's decode: shard 0 from the survivors of LOST, one
    # 256 KiB tile and one 32-tile run (ec_volume._DECODE_RUN_TILES)
    deg_rows = gf256.decode_rows(matrix, survivors, (0,))
    k1_tile = check_gf("degraded_tile", deg_rows, args.seed + 9, card, lanes=DEG_TILE_LANES)
    k1_run = check_gf("degraded_run", deg_rows, args.seed + 10, card, lanes=DEG_RUN_LANES)
    apply_tile = time_apply_matrix(deg_rows, DEG_TILE_LANES, args.seed + 11, card)
    apply_run = time_apply_matrix(deg_rows, DEG_RUN_LANES, args.seed + 12, card, reps=5)
    k4 = check_crc(args.seed + 2, card)
    k2_enc = check_gf_batch("encode", matrix[10:], args.seed + 3, card)
    k2_dec = check_gf_batch("decode4", gf256.decode_rows(matrix, survivors, lost),
                            args.seed + 4, card)
    k3 = check_verify(matrix[10:], args.seed + 5, card)
    t0 = time.perf_counter()
    swept = sweep_gf(args.seed + 7)
    log(f"K1/K2/K3 sweep over random (k, rows), k 1..16, rows 1..16, vector and scalar "
        f"variants: {swept} calls byte-exact vs plain ({time.perf_counter() - t0:.2f} s)")
    t0 = time.perf_counter()
    swept = sweep_crc(args.seed + 8)
    log(f"K4 sweep over rows 1..300, ragged lane counts, vector and scalar variants, "
        f"final and raw forms: {swept} calls byte-exact vs plain and the host shim "
        f"({time.perf_counter() - t0:.2f} s)")

    root = "/dev/shm" if os.path.isdir("/dev/shm") else None
    workdir = tempfile.mkdtemp(prefix="chip_smoke_", dir=root)
    try:
        runs = run_main_path(workdir, args.volume_mib << 20, args.seed, None, card)
    finally:
        shutil.rmtree(workdir, ignore_errors=True)
    workdir = tempfile.mkdtemp(prefix="chip_smoke_store_", dir=root)
    try:
        runs.update(run_store_phase(workdir, STORE_BYTES, args.seed, None, card, smi))
    finally:
        shutil.rmtree(workdir, ignore_errors=True)
    workdir = tempfile.mkdtemp(prefix="chip_smoke_batch_", dir=root)
    try:
        runs.update(run_batch_phase(workdir, BATCH_VOLUMES, BATCH_VOLUME_BYTES, args.seed,
                                    None, card))
    finally:
        shutil.rmtree(workdir, ignore_errors=True)

    paths = ("encode", "rebuild1", "rebuild4", "degraded", "repair_piggyback",
             "repair_parity", "store_encode", "store_rebuild4", "store_serve", "store_tier",
             "batch_encode", "batch_rebuild", "batch_verify")
    total = {kn: sum(runs[r]["launches"][kn] for r in paths) for kn in _counts()}
    log(f"launches over every path (single-volume encode and rebuilds, degraded reads, "
        f"piggybacked and parity rebuilds, the store's encode, rebuild, serve and tier "
        f"reads, batch encode, rebuild and verify) on {card}: "
        f"{total}; K1 decode4 {k1_dec['ms']:.4f} ms, K1 decode1 {k1_dec1['ms']:.4f} ms, "
        f"K2 decode4 {k2_dec['ms']:.4f} ms")
    deg = runs["degraded"]
    log(f"K1 on the degraded read on {card}: [1x10] rows, tile [10,{DEG_TILE_LANES}] "
        f"{k1_tile['ms']:.4f} ms (bound {k1_tile['bound_ms']:.5f}), run [10,{DEG_RUN_LANES}] "
        f"{k1_run['ms']:.4f} ms (bound {k1_run['bound_ms']:.5f}); cuda_apply_matrix a call "
        f"{apply_tile['ms']:.4f} / {apply_run['ms']:.4f} ms; launches on the degraded path "
        f"{deg['launches']['gf_apply']} (cold pass {deg['cold']['apply_calls']} decodes, "
        f"{deg['cold']['apply_mib']:.1f} MiB a row)")
    # every K1 and K4 signature the paths launched, checked, timed and priced
    first10 = tuple(i for i in range(14) if i != 3)[:10]
    names = {gf256.decode_rows(matrix, srv, tg).astype(np.uint8).tobytes(): label
             for label, srv, tg in (
                 ("decode (3,)", first10, (3,)),
                 ("decode (0, 5, 10, 13)", survivors, lost),
                 ("decode (0,)", survivors, (0,)),
                 ("decode (5,)", survivors, (5,)),
                 ("decode (0, 5)", survivors, (0, 5)),
                 ("decode (10, 13)", tuple(range(10)), (10, 13)))}
    names[np.ascontiguousarray(matrix[10:], dtype=np.uint8).tobytes()] = "encode"
    t0 = time.perf_counter()
    sigs = check_signatures(runs, paths, names, args.seed + 13, card)
    log(f"launch signatures checked and timed in {time.perf_counter() - t0:.2f} s")
    log(smi)

    def row(name, source, replaces, *checks):
        first = checks[0]
        return {"name": name, "route": "cuda", "source": source, "replaces": replaces,
                "launches": total[name],
                # every signature check raised unless it was byte-exact (0)
                "max_abs_err": max(c["max_abs_err"] for c in checks),
                "ms": first["ms"], "plain_ms": first["plain_ms"],
                "bound_ms": first["bound_ms"], "bound_by": first["bound_by"],
                "library_ms": None}

    kernels = [
        row("gf_apply", K1_SOURCE, K1_REPLACES, k1_enc, k1_dec, k1_dec1, k1_tile, k1_run),
        row("gf_apply_batch", K1_SOURCE, K2_REPLACES, k2_enc, k2_dec),
        row("gf_verify_batch", K3_SOURCE, K3_REPLACES, k3),
        row("crc32c_rows", K4_SOURCE, K4_REPLACES, k4),
    ]
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": name,
                                             "count": count}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
