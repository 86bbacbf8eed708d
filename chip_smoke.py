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
     tile; K5 with the degraded read's 1-row decode at the 32 KiB, 4 KiB
     and 1 KiB buckets of an exact interval and a 4-row decode at 32 KiB),
     hold it byte-exact against its plain PyTorch version on the card,
     time both with CUDA events, and compute its bound on this card; K5's
     tensor-core kernel is timed in turns with the ALU kernel it replaced
     (old, new, new, old) beside the harness's own floor (a one-element
     fill_ in the same CUDA-graph harness); then, untimed, hold K1, K2
     and K3 against their plain versions over random (k, rows) matrices,
     K4 over random row counts and ragged, unaligned rows, and K5 over
     random (C, R) on both arms of its dispatch;
  3. the single-volume path: write one sealed volume (default 1 GiB)
     with the port's storage code, EC-encode it through
     ec_files.write_ec_files on the cuda backend (fused shard CRCs,
     durable), publish .ecx and .ecc, check the CRCs against the host
     shim, parity on sampled rows against the numpy codec, and 64
     needles read back through the striping; then delete shard 3 and
     rebuild it, delete shards {0, 5, 10, 13} and rebuild them, each
     byte-identical; the kernels' launch counters must grow in every
     one of the three runs; the encode once more under torch.profiler,
     in a process of its own (profile_encode), for the card's idle share;
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
 3d. the volume server (run_server_phase), in its own directory: start the
     port's VolumeServer standalone (ec_codec="cuda", scrub_interval=0)
     and drive it as a user does, over HTTP and gRPC, with the HTTP
     load from 8 keep-alive connections of a load generator in a
     process of its own (this script with --http-client): POST a 1 GiB
     volume of needles log-uniform over 1 KiB-4 MiB, DELETE every 16th,
     GET every live needle back equal to its payload's SHA-256
     (conditional GETs 304, deleted ones 404); VolumeMarkReadonly and
     VolumeEcShardsGenerate (K1 + K4), byte-identical to a native encode
     of the same .dat; lose shards {0, 5, 10, 13} and
     VolumeEcShardsRebuild them (K1 + K4), byte-identical; mount the
     shards, drop the .dat volume, lose the four again and GET every
     live needle (tile-cache decodes: K1), then again with
     WEED_EC_TILE_CACHE=0 (exact intervals: K5 under 64 KiB, K1 above,
     both must launch, and every K5 launch on K5's tensor-core arm); last,
     two VolumeEcShardsGenerate calls at once
     on two 64 MiB volumes, equal to the same encodes run one after the
     other; after stop() no thread the server started may be left. The
     server runs the C epoll loop and the C POST: /status's ServeStats
     are printed around each pass, every plain-volume GET must be
     answered from C and both EC passes handed off to threads; the POST
     and plain-volume GET passes are repeated on a second server over a
     fresh directory on the threaded arm (native_serve=False, the Python
     POST) and both arms printed side by side;
 3e. the cluster (run_cluster_phase): a master and three volume servers
     booted by availability.start_cluster on the card in this process;
     one volume grown through the master on server A and filled with
     256 MiB (CUT_BYTES) through /dir/assign; VolumeEcShardsGenerate on A (K1 + K4),
     spread as ec.balance would (A 0-3, B 4-8, C 9-13, by
     VolumeEcShardsCopy); every needle GET through B healthy, then with
     A stopped, tile cache on (K1) and off (K5, on its tensor-core arm,
     and K1), each body equal to its payload's SHA-256; B rebuilds 0-3
     reading 9-13 off C (K1 + K4), byte-identical to A's shards, CRCs equal to the .ecc; after
     stop() no thread may be left, and grpc's grace thread must be seen;
 3f. the admin plane (run_admin_phase), driven through the port's shell
     (shell.run_command on a CommandEnv) against a master and three
     volume servers on the card, 256 sealed 4 MiB volumes written into
     the first one's directory before it boots: ec.encode of a 256 MiB
     volume filled through /dir/assign (K1 + K4; shards byte-identical to
     the native codec's encode of its snapshot, CRCs equal to the .ecc,
     the source deleted, every needle read back), ec.balance, four shards
     lost on their holders and ec.rebuild (K1 + K4, rack-gathered,
     byte-identical to saved copies), ec.batch of the 256 volumes (K2 +
     K4, byte-identical to native, each serving from EC) and
     ec.rebuild.batch of two damage signatures over them (K2), a
     VolumeTailReceiver following appends and volume.move (VolumeCopy,
     .dat and .idx equal); each step's launches must include its
     kernels; after stop() no thread may be left;
 3g. the command line and the integrity plane (run_cli_phase): a master
     (its telemetry collector scraping every second) and three volume
     servers started as `python -m seaweedfs_tpu_torch master|volume`
     processes, every server on the card (no -ec.codec), data in
     /dev/shm; the collector scrapes all four; one volume filled with 256 MiB by `python -m
     seaweedfs_tpu_torch benchmark`; ec.encode and ec.balance through a
     `shell` process (no server holds all 14 shards); bytes flipped in a
     4 MiB tile of a data shard and of a parity shard on two servers;
     this process runs the scrub's verify core over the shard files on
     the card and on K1's plain version (equal mismatch counts and
     culprits, one K1 launch a codec call of the plain run); then
     scrub.trigger on each culprit's holder in turn: its sweep finds and
     localizes the culprit with K1 and quarantines it (.bad), the
     master's /repair/queue shows the volume and its RepairScheduler
     rebuilds the shard on a server's card (K1 + K4); after each round
     /cluster/alerts shows scrub_corruptions firing for the culprit's
     holder, which holds an incident capsule with trigger=alert (its
     /capsule/list, and capsule.collect through the shell); cluster.slo
     through the shell counts samples in the scrub and repair planes;
     ec.verify through
     the shell (K1 in the shell's process) reports the volume clean, the
     rebuilt shards equal the saved copies and the .ecc, every holder
     completes a clean pass (its scanned-EC-bytes counter rising by the
     volume), every needle reads back with its payload's SHA-256, the
     volume servers' and the shell's processes appear in nvidia-smi's
     compute apps and the master's does not (nor does it map libcuda),
     the verify core runs clean after the repair (one K1
     launch a tile) and SIGTERM ends every process with exit code 0;
     each server's launches are read off its /metrics;
 3h. the serving edge from the command line (run_edge_phase): a master
     (-telemetryInterval 0) and one `volume` process on the card, data in
     /dev/shm, three arms in turn over fresh directories: the threaded
     arm (WEED_NATIVE_SERVE=0 WEED_NATIVE_POST=0), the C loop, and the C
     loop with -workers 4; each loaded by the port's `benchmark -c 16 -n
     16384 -size 1024` (upstream's -n 1048576 cut 64x), its write and read
     req/s, p50 and p99 and the lead's ServeStats printed, and on the
     workers arm the connections and CPU seconds of each pid; then
     ec.encode through a `shell` process, shards {0, 5, 10, 13}
     unmounted and deleted, and every needle GET through the shared port
     equal to its payload's SHA-256: the workers proxy those reads to the
     lead, whose K1 launches rise on its /metrics, while no worker maps
     libcuda or torch and nvidia-smi lists exactly one more compute app;
     SIGTERM ends every process with exit code 0;
 3i. the cluster telemetry plane (run_telemetry_phase): a master
     (-telemetryInterval 1, -repairInterval 0) and three `volume`
     processes on the card, data in /dev/shm, each process with its own
     capsule directory; one volume filled with 256 MiB (CUT_BYTES) of
     1 MiB files by `benchmark`, ec.encode and ec.balance -force through
     a `shell` process; `weedload -duration 10 -writers 2 -readers 2
     -size 1024` against the healthy cluster (its put and get p50, p99,
     p99.9 and req/s printed); one shard holder SIGKILLed, then
     weedload.run_load(readers=4, verify_bytes=1 MiB, duration_s=10) on
     the needles that touch its shards, routed to the surviving holder
     with the most shards: every GET reconstructs on that server's card
     (its K1 launches rise on its /metrics) and is byte-verified, 0
     errors; meanwhile scrape_staleness fires for the killed holder
     within stale_after plus two cycles, the master captures an alert
     capsule with its tsdb and cluster sections, and capsule.capture
     through the shell captures one on every live server; the holder
     restarted on its directory, the alert resolves; /cluster/top and the
     master's TSDB window rank the surviving servers by the degraded
     traffic; no weedload worker (of either run) and not the master maps
     libcuda or torch; SIGTERM ends every process with exit code 0; each
     step's wall printed beside the card's name and power limit;
 3j. the filer core (run_filer_phase): a master (-telemetryInterval 1,
     -repairInterval 0, -volumeSizeLimitMB 1152), three `volume`
     processes on the card and a `filer -store lsm -collection filer`
     process (-maxMB 32), data in /dev/shm; `filer.copy` of a local tree
     of 256 MiB (CUT_BYTES: files log-uniform over 1 KiB-4 MiB from the
     seed, two of 40 MiB cut into two chunks each); fs.cd, fs.ls -l,
     fs.du, fs.tree, fs.cat, fs.mv, fs.meta.save and fs.meta.load through
     a `shell` process, each checked against the local tree; every file
     read back through the filer, byte for byte, and the filer an up
     scrape target of kind filer; ec.encode of the collection's volumes
     (K1 + K4 on the servers' cards) and ec.balance -force, every file
     read back; every 10th file deleted through the filer, its chunks'
     fids then 404 on every holder and fs.du lower by their bytes; the
     holder with the second most shards SIGKILLed and every live file
     read back degraded through the filer (K1 on the survivors' cards,
     off their /metrics), 0 errors; the filer restarted on its store,
     fs.ls -l and fs.du as before; neither the filer nor filer.copy maps
     libcuda or torch; SIGTERM ends every process with exit code 0; each
     step's wall printed beside the card's name and power limit;
 3k. the S3 gateway (run_s3_phase): the cluster of 3j, a `filer -store
     lsm -collection s3` and an `s3 -config` process with one identity;
     signed requests from 4 threads put 128 MiB (S3_BYTES) of objects
     log-uniform over 1 KiB-4 MiB under nested keys, two 40 MiB objects
     by multipart upload (a part uploaded twice, an upload aborted), an
     8 MiB signed aws-chunked PUT and a CopyObject; ListObjectsV2 (pages
     of 100, prefixes and delimiter) and v1 list exactly what was put;
     a wrong secret, an unknown key and an unsigned request get the
     reference's 403s; the gateway an up scrape target of kind s3; every
     object read back (SHA-256, ETag the MD5), after ec.encode and
     ec.balance -force (K1 + K4 on the servers' cards), every 10th one
     deleted by DeleteObjects (NoSuchKey, chunks 404 on every holder),
     and with the holder of the second most shards SIGKILLed (K1 on
     each survivor's card), 0 errors; the gateway maps neither libcuda
     nor torch; SIGTERM ends every process with exit code 0; a fault
     names 3k and its step;
 3l. WebDAV, the Query verb and the s3 tier backend
     (run_webdav_tier_phase): the cluster of 3j, every process in a
     directory of its own, the volume servers' master.toml naming
     `s3.default` (bucket volume-tier on an `s3 -config` gateway of the
     same cluster), a `filer -store lsm -collection webdav` and a
     `webdav` process; MKCOL of a tree 1-3 levels deep, PUTs from 4
     threads of 128 MiB (WEBDAV_BYTES) of files log-uniform over 1 KiB-4
     MiB and one of 40 MiB, a directory MOVE and a directory's files
     COPYed (a collection COPY answers 501, as the reference's), PROPFIND
     Depth 0/1 of every collection equal to the tree; every file read
     back (SHA-256), after ec.encode and ec.balance -force (K1 + K4) and
     with the holder of the second most shards SIGKILLed (K1 rising on
     each survivor that holds shards of a touched volume), every 10th
     file DELETEd (404, chunks 404 on the live holders); the Query verb
     over JSON-lines needles equal to the plain reading; a sealed 32 MiB
     .dat through volume.tier.upload / volume.tier.download (needles
     read over ranged GETs, the .dat back byte-identical); a 32 MiB
     volume encoded (K1 + K4) and tier.move'd to the bucket, the objects
     of shards {0, 5, 10, 13} deleted, every needle read back decoded
     from the remote survivors (K1 and weed_tier_remote_read_total
     rising on the serving holder); neither gateway maps libcuda or
     torch; SIGTERM ends every process with exit code 0; a fault names
     3l and its step;
 3m. filer-to-filer replication (run_replication_phase): cluster A as
     3j's (master -telemetryInterval 1, three volume servers on racks
     0/1/0) with a `filer -collection repl -maxMB 32` publishing to a
     4-partition logqueue (notification.toml), and cluster B (master,
     volume server, filer); 128 MiB (REPL_BYTES) of files log-uniform
     over 1 KiB-1 MiB, nested, and one of 40 MiB (two chunks) POSTed to
     filer A, whose weed_replication_lag_events equals the queue's
     events; ec.encode and ec.balance -force on A (K1 + K4), a holder of
     at most 4 shards of every volume SIGKILLed; `filer.replicate
     -config` (sink.filer at B) drains the queue: A's lag gauge to 0,
     `replication.lag -json` 0 and no firing alert; every file read
     back from B (SHA-256), 0 errors, K1 rising on A's survivors; a
     directory deleted on A gone from B; the runner SIGTERMed (exit 0)
     and restarted: it resumes from its cursor, rewrites nothing on B,
     and carries a later file over; neither filer nor the runner maps
     libcuda or torch; a fault names 3m and its step;
 3n. the event stream leaving the cluster (run_cloud_phase): a
     kafka_fake broker process (4 partitions), cluster A as 3m's with a
     `filer -collection cloud -maxMB 32` publishing to [notification.kafka]
     and two more filers publishing to [notification.aws_sqs] and
     [notification.google_pub_sub] at FakeSqs and FakePubSub
     (tests/cloud_fakes.py, in this process, as FakeGcs, FakeAzure and
     FakeB2 are); 64 MiB (CLOUD_BYTES) of 3m's file mix and one 40 MiB
     file POSTed, the broker's high watermarks equal to the filer's
     events; ec.encode and ec.balance -force (K1 + K4), a holder of at
     most 4 shards of every volume SIGKILLed; three `filer.replicate
     -config` processes read the topic into sink.gcs, sink.azure and
     sink.backblaze: every object SHA-256 equal, K1 rising on the
     survivors; 32 files POSTed to each queue filer meanwhile, each fake
     accepting 32 signed messages naming them; a directory deleted from
     all three clouds (no B2 version left); the GCS runner SIGTERMed
     (exit 0) and restarted from its offsets uploading only a later
     file; no filer, runner or the broker maps libcuda or torch; a fault
     names 3n and its step;
  4. the batch path (BASELINE.json config 3, "batched ec.encode over
     256 sealed volumes"): write 256 volumes of about 4 MiB, encode them
     through ec_files.write_ec_files_batch (WEED_EC_PIPELINE_BATCH=16,
     fused CRCs, durable) and check CRCs, parity and needles; encode the
     same volumes through write_ec_files in a loop, timed beside the
     batch, every volume's CRCs equal to the batch's and 4 volumes
     byte-identical to the single-volume path, and one round of 16
     under torch.profiler as in phase 3; rebuild shard 3
     of the odd volumes and shards {0, 5, 10, 13} of the even ones in
     one rebuild_ec_files_batch call (two signature groups); the batch
     host arm (_HostBatchCodec over the native codec) encodes the same
     volumes and rebuilds the same damage, byte-identical to the K2 runs
     with equal CRCs, both walls printed; verify 16
     volumes with MeshCodec.verify_batch_u32, clean and with planted
     faults; the batch kernels' counters must grow in each run;
  5. the report: K1, K4 and K5 at every launch signature the paths (the
     store's and the server's included) gave
     them (the wrappers' tallies: shape, and K1's and K5's matrix), each
     byte-exact against its plain version, timed, bounded, and priced
     as launches x (ms - bound); K1 at the degraded read's shapes
     ([10, 65536] and [10, 2097152] lanes, one decode row), at the
     scrub's 4 MiB tile ([10, 1048576] lanes, the 4 parity rows) and
     cuda_apply_matrix's wall a call there; a `kernels` JSON line, then
     the final status line.

Without a CUDA device it prints the reason and exits 1 before any result.
"""

from __future__ import annotations

import argparse
import contextlib
import filecmp
import http.client
import json
import os
import re
import shutil
import subprocess
import sys
import tempfile
import threading
import time
import urllib.error
import urllib.request

import numpy as np

# H100 SXM (NVIDIA data sheet): HBM3 rate. Both kernels do integer work
# only, for which the data sheet's peak table gives no rate, so each bound
# is the bytes the function must move over this rate.
HBM_BYTES_PER_S = 3.35e12

K1_SOURCE = "seaweedfs_tpu_torch/csrc/gf_apply.cu"
K3_SOURCE = "seaweedfs_tpu_torch/csrc/gf_verify.cu"
K4_SOURCE = "seaweedfs_tpu_torch/csrc/crc32c_rows.cu"
K5_SOURCE = "seaweedfs_tpu_torch/csrc/gf_bits.cu"
K1_REPLACES = "seaweedfs_tpu/ec/codec_tpu.py:204 swar_apply_u32"
K2_REPLACES = "seaweedfs_tpu/ec/codec_tpu.py:236 swar_apply_u32_batch"
K3_REPLACES = "seaweedfs_tpu/ec/codec_tpu.py:321 swar_verify_u32_batch"
K4_REPLACES = "seaweedfs_tpu/ec/crc_kernel.py:133 crc32c_rows"
K5_REPLACES = "seaweedfs_tpu/ec/codec_tpu.py:78 apply_matrix_bits"

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
# the cluster, admin and cli phases' volume: config 1's 1 GiB cut 4x, so
# that the smoke, grown by the serving-edge phase, stays near half of its
# 1200 s time limit (those phases' sizes are depth, not width)
CUT_BYTES = 256 << 20


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
    call runs on the capture stream, outside the capture, and builds and
    caches what the wrapper keeps. A captured K4 call takes ticket
    counters of its own, zero-filled in the graph ahead of the kernel:
    _k4_ms takes that fill out."""
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


def _k4_ms(xs: list, iters: int) -> tuple[float, float]:
    """(K4's device ms a call as the paths launch it, the captured ms):
    `iters` captured calls over the [rows, n32] tiles `xs`, less the
    [rows] ticket-counter fill each captured call adds ahead of its
    kernel (an uncaptured call reuses its stream's counters), timed
    alone in a graph of `iters` such fills."""
    import torch

    from seaweedfs_tpu_torch.ec import crc_kernel

    rows, dev = xs[0].shape[0], xs[0].device
    captured = _kernel_ms(lambda i: crc_kernel.crc32c_rows(xs[i % len(xs)]), iters=iters)
    fill = _kernel_ms(lambda i: torch.zeros(rows, dtype=torch.int32, device=dev),
                      iters=iters)
    return captured - fill, captured


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


def k5_shapes() -> list:
    """(label, GF rows, bytes) of K5's timed shapes: the degraded read's
    1-row decode (shard 0 from the survivors of LOST) at the largest
    exact-interval bucket under 64 KiB, at 4 KiB and at 1 KiB, and the
    4-row decode of LOST at 32 KiB."""
    from seaweedfs_tpu_torch.ec import gf256

    matrix = gf256.build_code_matrix(10, 14)
    survivors = tuple(i for i in range(14) if i not in LOST)
    one = gf256.decode_rows(matrix, survivors, (0,))
    return [("degraded_32k", one, 32768), ("degraded_4k", one, 4096),
            ("degraded_1k", one, 1024),
            ("decode4_32k", gf256.decode_rows(matrix, survivors, LOST), 32768)]


def k5_pool(k: int, n: int, seed: int) -> tuple[list, int]:
    """Distinct [1, k, n] uint8 inputs of at least 128 MiB in all (beyond
    the 50 MB L2), and the launches a timing graph takes over them."""
    import torch

    g = torch.Generator(device="cuda").manual_seed(seed)
    sets = max(8, (128 << 20) // (k * n))
    pool = torch.randint(0, 256, (sets, 1, k, n), dtype=torch.uint8, device="cuda",
                         generator=g)
    return list(pool), max(64, min(sets, 1024))


def k5_alu(a_bits, x, args):
    """K5's ALU kernel (the first design, gf_bits_apply) on [B, C, n] x,
    called past the wrapper, which takes it only for the shapes the
    tensor-core kernel cannot: the old design timed beside the new one.
    No launch counter moves."""
    import torch

    from seaweedfs_tpu_torch import _build
    from seaweedfs_tpu_torch.ec import codec_cuda

    b, c, n = x.shape
    r = a_bits.shape[0] // 8
    out = torch.empty((b, r, n), dtype=torch.uint8, device=x.device)
    err = codec_cuda._kernel("gf_bits.cu").gf_bits_apply(
        x.data_ptr(), out.data_ptr(), b, c, r, n, c * n, r * n, args.masks.ctypes.data,
        torch.cuda.current_stream(x.device).cuda_stream)
    _build.check(err, "gf_bits (ALU kernel) launch")
    return out


def floor_ms(iters: int) -> float:
    """_kernel_ms's own per-launch floor: a one-element fill_ captured and
    timed by the same harness, `iters` launches a graph."""
    import torch

    one = torch.zeros(1, device="cuda")
    return _kernel_ms(lambda i: one.fill_(1.0), iters=iters)


def check_k5(name: str, rows, n: int, seed: int, card: str) -> dict:
    """K5 with GF rows `rows` over a [k, n] uint8 stream (one bucket of an
    exact-interval decode): byte-exact against its plain version on the
    tensor-core arm, then timed over distinct inputs of at least 128 MiB
    in all in turns with the ALU kernel it replaced (old, new, new, old),
    beside the harness floor and the library yardstick: the same GF(2)
    product as one float32 torch.matmul of the bit-matrix with the
    input's bit-planes (exact: a sum is at most k * 8), the unpack and
    the pack excluded."""
    import torch

    from seaweedfs_tpu_torch.ec import codec_cuda

    k, r = rows.shape[1], rows.shape[0]
    a_bits = codec_cuda.gf_matrix_to_bits(rows)
    args = codec_cuda.bit_args(a_bits)
    xs, iters = k5_pool(k, n, seed)
    arm0 = codec_cuda.BITS_MMA_LAUNCHES.value
    got = codec_cuda.apply_matrix_bits_batch(a_bits, xs[0], args)
    want = codec_cuda.gf_bits_plain(a_bits, xs[0])
    torch.cuda.synchronize()
    if codec_cuda.BITS_MMA_LAUNCHES.value != arm0 + 1:
        raise AssertionError(f"K5 {name}: the call did not take the tensor-core arm")
    err = _max_abs_err(got, want)
    if err or not torch.equal(got, want) or not torch.equal(k5_alu(a_bits, xs[0], args),
                                                             want):
        raise AssertionError(f"K5 {name}: a kernel disagrees with its plain version")
    sets = len(xs)
    turns = {"old": [], "new": []}
    for which in ("old", "new", "new", "old"):
        fn = (codec_cuda.apply_matrix_bits_batch if which == "new" else k5_alu)
        turns[which].append(_kernel_ms(lambda i: fn(a_bits, xs[i % sets], args),
                                       iters=iters))
    ms, old_ms = sum(turns["new"]) / 2, sum(turns["old"]) / 2
    floor = floor_ms(iters)
    plain_ms = _time_ms(lambda i: codec_cuda.gf_bits_plain(a_bits, xs[i % sets]), 20)
    a = torch.from_numpy(a_bits.astype(np.float32)).cuda()
    planes = [((xs[i][0][:, None, :] >> torch.arange(8, dtype=torch.uint8, device="cuda")
                [None, :, None]) & 1).reshape(k * 8, n).float() for i in range(8)]
    library_ms = _time_ms(lambda i: torch.matmul(a, planes[i % 8]), 200)
    nbytes = (k + r) * n
    bound = nbytes / HBM_BYTES_PER_S * 1e3
    log(
        f"K5 gf_bits {name} [{k},{n}]->[{r},{n}] bytes on {card}: byte-exact vs plain "
        f"(max_abs_err 0), both designs; in turns over {sets} distinct inputs, old (ALU) "
        f"{turns['old'][0]:.5f}, new (tensor cores) {turns['new'][0]:.5f} / "
        f"{turns['new'][1]:.5f}, old {turns['old'][1]:.5f} ms; the harness floor (a "
        f"one-element fill_, {iters} launches a graph) {floor:.5f} ms; plain "
        f"{plain_ms:.4f} ms, library (float32 matmul of the bit-planes, unpack and pack "
        f"excluded) {library_ms:.4f} ms, bound {bound:.6f} ms (bytes; {bound / ms:.4f} "
        f"of it)"
    )
    del xs, planes
    return {
        "ms": ms, "plain_ms": plain_ms, "bound_ms": bound, "bound_by": "bytes",
        "max_abs_err": err, "library_ms": library_ms, "old_ms": old_ms,
        "floor_ms": floor, "turns": turns,
    }


def sweep_k5(seed: int, draws: int = 24) -> int:
    """Untimed exactness sweep of K5 against its plain version: C and R
    drawn from 1..16, ragged and unaligned byte counts (the ALU arm's
    scalar variant) and multiples of 4 (the tensor-core arm), batches of
    1..3. Returns the calls checked."""
    import torch

    from seaweedfs_tpu_torch.ec import codec_cuda

    rng = np.random.default_rng(seed)
    g = torch.Generator(device="cuda").manual_seed(seed)
    for i in range(draws):
        c, r, b = int(rng.integers(1, 17)), int(rng.integers(1, 17)), int(rng.integers(1, 4))
        vec = i % 2 == 0
        n = int(rng.integers(1, 9000)) * (4 if vec else 1)
        a_bits = codec_cuda.gf_matrix_to_bits(rng.integers(0, 256, (r, c), dtype=np.uint8))
        off = 0 if vec else 1
        x = torch.randint(0, 256, (b * c * n + off,), dtype=torch.uint8, device="cuda",
                          generator=g)[off:].view(b, c, n)
        if not torch.equal(codec_cuda.apply_matrix_bits_batch(a_bits, x),
                           codec_cuda.gf_bits_plain(a_bits, x)):
            raise AssertionError(f"K5 disagrees with its plain version at C {c}, R {r}, "
                                 f"n {n}, B {b}, {'vector' if vec else 'scalar'}")
    torch.cuda.synchronize()
    return draws


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
    ms, captured_ms = _k4_ms(xs, len(xs))
    eager_ms = _time_ms(lambda i: crc_kernel.crc32c_rows(xs[i % 4]), 200)
    plain_ms = _time_ms(lambda i: crc_kernel.crc32c_rows_plain(xs[i % 4]), 2, warm=1)
    nbytes = rows * 4 * LANES + rows * 4
    bound = nbytes / HBM_BYTES_PER_S * 1e3
    log(f"K4 crc32c_rows [{rows},{LANES}] on {card}: byte-exact vs plain, host shim and raw "
        f"form (max_abs_err 0); kernel {ms:.4f} ms over {len(xs)} distinct inputs "
        f"({nbytes / ms / 1e6:.1f} GB/s; {captured_ms:.4f} ms captured with its counters' "
        f"fill; {eager_ms:.4f} ms a call launched eagerly from Python), plain "
        f"{plain_ms:.3f} ms, bound {bound:.4f} ms (bytes; {bound / ms:.3f} of it)")
    del pool, xs
    return {"ms": ms, "plain_ms": plain_ms, "bound_ms": bound, "bound_by": "bytes",
            "max_abs_err": err, "eager_ms": eager_ms, "captured_ms": captured_ms}


def check_k4_graph_streams(seed: int, card: str, rounds: int = 8) -> dict:
    """K4 captured in CUDA graphs and replayed beside other launches
    (tests/test_torch_cuda.py holds the same check): two graphs of 8
    launches each on [14, 65536] tiles, both captured on one stream,
    replayed at once on two other streams while 8 uncaptured launches
    run on the capture stream, `rounds` times with the inputs rewritten.
    Each captured launch owns its ticket counters, so every result must
    equal the plain version."""
    import torch

    from seaweedfs_tpu_torch.ec import crc_kernel

    g = torch.Generator(device="cuda").manual_seed(seed)
    shape = (3, 8, 14, 65536)
    xs = torch.randint(-(2**31), 2**31 - 1, shape, dtype=torch.int32, device="cuda",
                       generator=g)
    crc_kernel.crc32c_rows(xs[0, 0])  # the geometry's tables, outside any capture
    cap = torch.cuda.Stream()
    cap.wait_stream(torch.cuda.current_stream())
    graphs, outs = [], []
    for j in range(2):
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph, stream=cap):
            outs.append([crc_kernel.crc32c_rows(xs[j, i]) for i in range(8)])
        graphs.append(graph)
    replay = [torch.cuda.Stream(), torch.cuda.Stream()]
    err = 0
    for rnd in range(rounds):
        xs.copy_(torch.randint(-(2**31), 2**31 - 1, shape, dtype=torch.int32, device="cuda",
                               generator=g))
        for st in replay + [cap]:
            st.wait_stream(torch.cuda.current_stream())
        for graph, st in zip(graphs, replay):
            with torch.cuda.stream(st):
                graph.replay()
        with torch.cuda.stream(cap):
            direct = [crc_kernel.crc32c_rows(xs[2, i]) for i in range(8)]
        torch.cuda.synchronize()
        for j, got in enumerate(outs + [direct]):
            for i in range(8):
                want = crc_kernel.crc32c_rows_plain(xs[j, i])
                err = max(err, _max_abs_err(got[i], want))
                if not torch.equal(got[i], want):
                    raise AssertionError(f"K4 graph replay round {rnd}: graph {j} launch "
                                         f"{i} disagrees with its plain version")
    log(f"K4 in CUDA graphs on {card}: two graphs of 8 launches captured on one stream, "
        f"replayed at once on two streams beside 8 uncaptured launches on the capture "
        f"stream, {rounds} rounds: byte-exact vs plain (max_abs_err {err})")
    return {"max_abs_err": err, "rounds": rounds}


def _sig_inputs(pool, rows: int, n32: int) -> list:
    """Distinct [rows, n32] views sliced from `pool`, at most SIG_MAX_INPUTS."""
    per = rows * n32
    return [pool[i * per:(i + 1) * per].view(rows, n32)
            for i in range(min(SIG_MAX_INPUTS, pool.numel() // per))]


def check_signatures(runs: dict, paths, names: dict, seed: int, card: str) -> dict:
    """K1, K4 and K5 at every signature `paths` launched them with (the
    wrappers' tallies: K1's rows, k, lanes and matrix, K4's rows and
    lanes, K5's rows, columns, bytes, batch and bit-matrix). At each:
    byte-exact against its plain version (K4 also the
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
        k1, k5 = kname == "gf_apply", kname == "gf_bits"
        in_words = [sig[1] * sig[2] * sig[3] // 4 + 1 if k5 else
                    (sig[1] if k1 else sig[0]) * sig[2 if k1 else 1] for sig in by_sig]
        words = max([SIG_POOL_BYTES // 4] + in_words)
        pool = torch.randint(-(2**31), 2**31 - 1, (words,), dtype=torch.int32,
                             device="cuda", generator=g)
        shapes, loss = [], 0.0
        for sig in sorted(by_sig, key=lambda sg: (sg[0], sg[2 if k1 or k5 else 1], str(sg))):
            if k5:
                r, c, n, b, mat = sig
                a_bits = np.frombuffer(mat, dtype=np.int8).reshape(r * 8, c * 8)
                k5_args = codec_cuda.bit_args(a_bits)
                flat = pool.view(torch.uint8)
                per = b * c * n
                xs = [flat[i * per:(i + 1) * per].view(b, c, n)
                      for i in range(min(SIG_MAX_INPUTS, flat.numel() // per))]
                label = names.get(mat, f"{r}x{c} bit-matrix")
                if not torch.equal(codec_cuda.apply_matrix_bits_batch(a_bits, xs[0], k5_args),
                                   codec_cuda.gf_bits_plain(a_bits, xs[0])):
                    raise AssertionError(f"K5 [{b},{c},{n}] ({label}): kernel disagrees "
                                         f"with its plain version")
                iters = min(SIG_MAX_INPUTS, max(64, len(xs)))
                ms = _kernel_ms(lambda i: codec_cuda.apply_matrix_bits_batch(
                    a_bits, xs[i % len(xs)], k5_args), iters=iters)
                nbytes = (c + r) * n * b
                shape = (f"[{b},{c},{n}]->[{b},{r},{n}] bytes ({label}; the harness floor "
                         f"{floor_ms(iters):.5f} ms)")
            elif k1:
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
                ms, _ = _k4_ms(xs, min(SIG_MAX_INPUTS, max(64, len(xs))))
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
        "gf_bits": codec_cuda.BITS_LAUNCHES,
        "gf_bits_mma": codec_cuda.BITS_MMA_LAUNCHES,  # K5's arms, each counted
        "gf_bits_alu": codec_cuda.BITS_ALU_LAUNCHES,  # beside gf_bits's total
    }


def _reset_counts() -> None:
    for c in _counts().values():
        c.reset()


def _read_counts() -> dict:
    return {name: c.value for name, c in _counts().items()}


SIG_KERNELS = ("gf_apply", "crc32c_rows", "gf_bits")  # the wrappers that tally signatures


def _read_sigs() -> dict:
    """{kernel: {signature: launches}} since the last reset, for the
    kernels whose wrappers tally their launch signatures: K1 (rows, k,
    n32, matrix bytes), K4 (rows, n32) and K5 (rows, columns, bytes,
    batch, bit-matrix bytes)."""
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


def _must_take_mma(label: str, launches: dict) -> None:
    """Every K5 launch of a serving pass took the tensor-core arm: its
    buckets are powers of two on fresh allocations."""
    if launches["gf_bits_mma"] != launches["gf_bits"] or launches["gf_bits_alu"]:
        raise AssertionError(f"{label}: K5 launches {launches['gf_bits']}, of them "
                             f"{launches['gf_bits_mma']} on the tensor-core arm and "
                             f"{launches['gf_bits_alu']} on the ALU arm")


def profile_encode(kind: str, bases: list, workdir: str, card: str,
                   label: str = "encode") -> dict:
    """Encode `bases` once more under torch.profiler and read the device
    timeline: busy = the union of kernel, copy and memset intervals on
    the card; idle share = 1 - busy / wall. `kind` "single" is
    write_ec_files of bases[0] on the card, "batch" write_ec_files_batch
    of them all. It runs in a process of its own (this script with
    --profile-encode), after one unprofiled warm-up encode of the same
    files there: on the card machine a process's profiler records fewer
    of its device events the older the process is, none after about two
    minutes (PERF.md section 7). Raises unless every kernel launch, copy
    and memset the trace shows on the host has its device event."""
    job = os.path.join(workdir, "profile_job.json")
    out_path = os.path.join(workdir, "profile_out.json")
    with open(job, "w") as f:
        json.dump({"kind": kind, "bases": bases}, f)
    proc = subprocess.run(
        [sys.executable, os.path.abspath(__file__), "--profile-encode", job, out_path],
        capture_output=True, text=True, timeout=600,
    )
    if proc.returncode:
        raise AssertionError(f"the profiled {label} failed (rc {proc.returncode}): "
                             f"{proc.stderr[-3000:]}")
    with open(out_path) as f:
        out = json.load(f)
    os.remove(job)
    os.remove(out_path)
    log(f"profiled {label} on {card}: " + json.dumps(out))
    return out


def profiled_encode(job_path: str, out_path: str) -> int:
    """The process of profile_encode: warm up, profile one encode, check
    the trace for lost device events and write the timeline's summary
    to `out_path`."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from seaweedfs_tpu_torch.ec import ec_files
    from seaweedfs_tpu_torch.ec.codec import new_encoder

    with open(job_path) as f:
        job = json.load(f)
    bases = job["bases"]
    if job["kind"] == "single":
        rs = new_encoder(backend="cuda")

        def encode():
            ec_files.write_ec_files(bases[0], rs=rs, want_crcs=True)
    else:
        def encode():
            ec_files.write_ec_files_batch(bases, want_crcs=True)
    encode()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        encode()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    path = out_path + ".trace.json"
    prof.export_chrome_trace(path)
    with open(path) as f:
        events = json.load(f)["traceEvents"]
    os.remove(path)
    spans, by_cat, on_device = [], {}, set()
    host_calls: dict = {}
    for e in events:
        cat = e.get("cat", "")
        corr = e.get("args", {}).get("correlation")
        if cat in ("kernel", "gpu_memcpy", "gpu_memset") and "dur" in e:
            spans.append((float(e["ts"]), float(e["ts"]) + float(e["dur"])))
            key = e["name"] if cat == "kernel" else cat
            by_cat[key] = by_cat.get(key, 0.0) + float(e["dur"]) / 1e3
            on_device.add(corr)
        elif cat == "cuda_runtime" and re.search("LaunchKernel|Memcpy|Memset", e["name"]):
            host_calls[corr] = e["name"]
    lost = [name for corr, name in host_calls.items() if corr not in on_device]
    if not spans or lost:
        by_name: dict = {}
        for name in lost:
            by_name[name] = by_name.get(name, 0) + 1
        raise AssertionError(f"the profiled encode's trace lacks the device events of "
                             f"{len(lost)} of {len(host_calls)} host calls: {by_name}")
    busy, end = 0.0, float("-inf")
    for a, b in sorted(spans):
        if b > end:
            busy += b - max(a, end)
            end = b
    busy_ms = busy / 1e3
    out = {"wall_ms": wall * 1e3, "device_busy_ms": busy_ms,
           "idle_share": 1.0 - busy_ms / (wall * 1e3), "device_calls": len(host_calls),
           "device_ms_by_name": {k: round(v, 4) for k, v in sorted(by_cat.items())}}
    with open(out_path, "w") as f:
        json.dump(out, f)
    return 0


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
        runs["profiled_encode"] = profile_encode("single", [base], workdir, card)
    return runs


# --- phase 3b: degraded reads and the piggybacked rebuild --------------------

LOST = (0, 5, 10, 13)  # two data shards, two parity: all RS(10,4) tolerates
SF_THREADS, SF_NEEDLES, WARM_NEEDLES = 8, 16, 64


def _pct(xs, q: float) -> float:
    return float(np.percentile(np.asarray(xs), q)) * 1e3 if xs else float("nan")


def _lost_intervals(ev, off: int, size: int, lost=LOST) -> list:
    """(shard, shard offset, length) of a .dat span's intervals that lie
    on a shard of `lost`."""
    from seaweedfs_tpu_torch.ec import locate

    out = []
    for iv in locate.locate_data(locate.LARGE_BLOCK_SIZE, locate.SMALL_BLOCK_SIZE,
                                 ev.dat_file_size(), off, size):
        sid, soff = iv.to_shard_id_and_offset()
        if sid in lost:
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
            if launches["gf_apply"] + launches["gf_bits"] != spans["count"]:
                raise AssertionError(f"cold pass: {launches['gf_apply']} K1 and "
                                     f"{launches['gf_bits']} K5 launches for "
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
            before = _read_counts()
            covered = all(ev.tile_cache.covers(*iv) for iv in lost_of[nid])
            check(ev.read_needle(nid), off, size)
            if covered:
                resident += 1
                after = _read_counts()
                if (after["gf_apply"], after["gf_bits"]) != (before["gf_apply"],
                                                             before["gf_bits"]):
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


# --- phase 3d: the volume server ---------------------------------------------

SERVER_VID = 11
SERVER_ROOM = 5 << 30  # the server phase's peak in its directory (about 4.2 GiB)
SERVER_THREADS = 8  # keep-alive client threads
CONC_BYTES = 64 << 20  # each of the two volumes encoded at once
COND_GETS = 16  # conditional GETs that must answer 304


def _free_port() -> int:
    """A port p with p and p + 10000 (the server's gRPC port) both free."""
    import random
    import socket

    rng = random.Random(os.getpid() ^ time.monotonic_ns())
    for _ in range(200):
        p = rng.randrange(20000, 50000)
        try:
            for q in (p, p + 10000):
                with socket.socket() as s:
                    s.bind(("127.0.0.1", q))
        except OSError:
            continue
        return p
    raise RuntimeError("no free port pair for the volume server")


def _fan(port: int, n_threads: int, items: list, work) -> list:
    """work(conn, item) over `items` from n_threads keep-alive HTTP
    clients of 127.0.0.1:`port` (item i on thread i % n_threads); returns
    the results in item order. The first error is raised after every
    thread joined."""
    out: list = [None] * len(items)
    errors: list = []

    def run(t):
        import http.client

        conn = None
        try:
            for i in range(t, len(items), n_threads):
                if conn is None:
                    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=120)
                out[i] = work(conn, items[i])
        except Exception as e:  # noqa: BLE001 — re-raised below
            errors.append(e)
        finally:
            if conn is not None:
                conn.close()

    threads = [threading.Thread(target=run, args=(t,)) for t in range(n_threads)]
    for th in threads:
        th.start()
    for th in threads:
        th.join(600)
    if errors:
        raise errors[0]
    if any(th.is_alive() for th in threads):
        raise AssertionError("a client thread did not finish")
    return out


def _http(conn, method: str, path: str, body: bytes | None = None, headers=None):
    conn.request(method, path, body=body, headers=headers or {})
    resp = conn.getresponse()
    return resp.status, dict(resp.getheaders()), resp.read()


def _load_client(port: int, op: str, items: list, workdir: str, query: str = "") -> dict:
    """Run `op` over `items`, [fid, seed, nid, size] each, from
    SERVER_THREADS keep-alive connections of a load generator in a
    process of its own (this script with --http-client), so that the
    client's work (payloads, digests, HTTP parsing) does not share the
    servers' interpreter lock. "post" and "get" address a volume server
    at `port`; "assign" asks the master at `port` for a fid
    (/dir/assign?`query`) and POSTs the payload to the server it names,
    `fid` then only keys the payload. Returns its {"wall_s", "results":
    [[fid, seconds, eTag or None(, url)], ...]} in item order: an
    assign's fid and url are the master's."""
    job = os.path.join(workdir, "client_job.json")
    out = os.path.join(workdir, "client_out.json")
    with open(job, "w") as f:
        json.dump({"port": port, "op": op, "threads": SERVER_THREADS, "items": items,
                   "query": query}, f)
    proc = subprocess.run(
        [sys.executable, os.path.abspath(__file__), "--http-client", job, out],
        capture_output=True, text=True, timeout=900,
    )
    if proc.returncode:
        raise AssertionError(f"the {op} load generator failed (rc {proc.returncode}): "
                             f"{proc.stderr[-2000:]}")
    with open(out) as f:
        got = json.load(f)
    os.remove(job)
    os.remove(out)
    return got


def http_client(job_path: str, out_path: str) -> int:
    """The load generator of _load_client: make every payload (POST) or
    its SHA-256 (GET) first, then time each request from its send to
    the last byte of its reply; a GET's body must hash to its payload's
    digest. Writes {"wall_s", "results"} to `out_path`."""
    import hashlib

    with open(job_path) as f:
        job = json.load(f)
    op = job["op"]
    items = [tuple(x) for x in job["items"]]
    if op in ("post", "assign"):
        made = {fid: _store_payload(s, nid, 0, size) for fid, s, nid, size in items}
    else:
        made = {fid: hashlib.sha256(_store_payload(s, nid, 0, size)).digest()
                for fid, s, nid, size in items}
    # "assign": `port` is a master; each thread keeps a keep-alive
    # connection to every volume server its assigns name
    local = threading.local()
    opened: list = []

    def volume_conn(url: str):
        import http.client

        conns = getattr(local, "conns", None)
        if conns is None:
            conns = local.conns = {}
        if url not in conns:
            host, _, port = url.partition(":")
            conns[url] = http.client.HTTPConnection(host, int(port), timeout=120)
            opened.append(conns[url])
        return conns[url]

    def work(conn, item):
        fid = item[0]
        t0 = time.perf_counter()
        if op == "assign":
            status, _, body = _http(conn, "GET", f"/dir/assign?{job['query']}")
            if status != 200:
                raise AssertionError(f"assign: {status} {body[:200]!r}")
            a = json.loads(body)
            status, _, body = _http(volume_conn(a["url"]), "POST", f"/{a['fid']}", made[fid])
            dt = time.perf_counter() - t0
            if status != 201:
                raise AssertionError(f"POST {a['fid']}: {status} {body[:200]!r}")
            return [a["fid"], dt, json.loads(body)["eTag"], a["url"]]
        if op == "post":
            status, _, body = _http(conn, "POST", f"/{fid}", made[fid])
            dt = time.perf_counter() - t0
            if status != 201:
                raise AssertionError(f"POST {fid}: {status} {body[:200]!r}")
            return [fid, dt, json.loads(body)["eTag"]]
        status, _, body = _http(conn, "GET", f"/{fid}")
        dt = time.perf_counter() - t0
        if status != 200 or hashlib.sha256(body).digest() != made[fid]:
            raise AssertionError(f"GET {fid}: status {status}, {len(body)} bytes "
                                 f"differ from its payload")
        return [fid, dt, None]

    t0 = time.perf_counter()
    try:
        results = _fan(job["port"], job["threads"], items, work)
    finally:
        for c in opened:
            c.close()
    wall = time.perf_counter() - t0
    with open(out_path, "w") as f:
        json.dump({"wall_s": wall, "results": results}, f)
    return 0


# threads of the process, not of a server: the tracing plane's span
# drainer, started by the first span the process records, folds spans
# into a histogram every 0.25 s and touches no device
PROCESS_THREADS = ("trace-drain",)


def _pinned_live() -> dict:
    """Page-locked host memory that live tensors hold: the distinct
    storages of the CPU tensors the collector sees that are pinned. (The
    pinned allocator's own counters cannot say this: a freed block stays
    "active" until the allocator processes its events, and a cached
    block is reusable, not held.)"""
    import gc

    import torch

    held = {}
    for obj in gc.get_objects():
        if (issubclass(type(obj), torch.Tensor) and obj.device.type == "cpu"
                and obj.is_pinned()):
            storage = obj.untyped_storage()
            held[storage.data_ptr()] = storage.nbytes()
    return {"storages": len(held), "bytes": sum(held.values())}


@contextlib.contextmanager
def _threads_started(names: list):
    """Append to `names` the name of every thread started in the block."""
    start = threading.Thread.start

    def record(t):
        names.append(t.name)
        return start(t)

    threading.Thread.start = record
    try:
        yield names
    finally:
        threading.Thread.start = start


def _server_leftovers(before: set, pinned_start: dict | None) -> dict:
    """After VolumeServer.stop(): the threads that outlived it (waited
    for up to 10 s: a connection thread ends when its client has gone),
    and on the card (`pinned_start` the phase's first reading) the
    pinned memory live tensors still hold, before and after a full
    collection, with the objects it found."""
    import gc

    def new_threads() -> list:
        return [t for t in threading.enumerate()
                if t not in before and t.name not in PROCESS_THREADS]

    deadline = time.monotonic() + 10.0
    left = new_threads()
    while left and time.monotonic() < deadline:
        time.sleep(0.05)
        left = new_threads()
    out: dict = {"threads_left": sorted(t.name for t in left)}
    if pinned_start is not None:
        out["pinned_at_start"] = pinned_start
        out["pinned_before_gc"] = _pinned_live()
        out["gc_found"] = gc.collect()
        out["pinned_after_gc"] = _pinned_live()
    return out


def _serve_stats(port: int) -> dict:
    """The C serving core's counters off a server's /status (ServeStats:
    responses the C loop wrote, connections handed off to Python threads,
    304s, plan-cache hits; process-wide, so a -workers lead's own)."""
    with urllib.request.urlopen(f"http://127.0.0.1:{port}/status", timeout=30) as r:
        return json.loads(r.read())["ServeStats"]


def _stats_delta(a: dict, b: dict, probe: int = 1) -> dict:
    """Counters between two _serve_stats readings `a` and `b`. A /status
    request is itself handed off by a C loop, so `b` counts its own
    probe's handoff: `probe` (1) is taken off, 0 where no C loop served
    the probe."""
    out = {k: b.get(k, 0) - a.get(k, 0) for k in ("served", "handoffs", "not_modified",
                                                   "cache_hits", "shed")}
    out["handoffs"] -= probe
    return out


def _threaded_arm(workdir: str, fids: dict, live: list, seed: int, device, card: str) -> dict:
    """Phase 3d's POST and plain-volume GET passes on the threaded arm: a
    second VolumeServer over a fresh directory with native_serve=False
    (the threaded mini loop) and the C POST declined as WEED_NATIVE_POST=0
    declines it, driven by the same load generator with the same
    payloads. Its GETs must not move the C loop's counters."""
    from seaweedfs_tpu_torch.pb import rpc
    from seaweedfs_tpu_torch.pb import volume_pb2 as pb
    from seaweedfs_tpu_torch.server import write_path
    from seaweedfs_tpu_torch.server.volume_server import VolumeServer

    vdir = os.path.join(workdir, "server_threaded")
    os.mkdir(vdir)
    port = _free_port()
    vs = VolumeServer([vdir], port=port, ec_codec="cuda", device=device, scrub_interval=0,
                      max_volume_counts=[8], native_serve=False)
    vs.start()
    vid = SERVER_VID
    items = lambda which: [[fid, seed + vid, *fids[fid]] for fid in which]  # noqa: E731
    try:
        with rpc.dial(f"127.0.0.1:{vs.grpc_port}") as ch:
            rpc.volume_stub(ch).AllocateVolume(pb.AllocateVolumeRequest(volume_id=vid),
                                               timeout=60)
        write_path.NATIVE_POST_ENABLED = False
        try:
            post = _load_client(port, "post", items(fids), workdir)
        finally:
            write_path.NATIVE_POST_ENABLED = True
        st0 = _serve_stats(port)
        got = _load_client(port, "get", items(live), workdir)
        st1 = _serve_stats(port)
        if any(_stats_delta(st0, st1, probe=0).values()):
            raise AssertionError(f"server threaded arm: the C loop served its GETs "
                                 f"({st0} -> {st1})")
        lat = [dt for _, dt, _ in got["results"]]
        posted = sum(size for _, size in fids.values())
        run = {"post_s": post["wall_s"], "get_s": got["wall_s"], "bytes": posted,
               "get_p50_ms": _pct(lat, 50), "get_p99_ms": _pct(lat, 99)}
        log(f"server threaded arm on {card}: {len(fids)} needles POSTed on the Python path "
            f"in {run['post_s']:.4f} s ({posted / run['post_s'] / 1e9:.4f} GB/s, "
            f"{len(fids) / run['post_s']:.1f} req/s); {len(live)} GETs on the threaded mini "
            f"loop in {run['get_s']:.4f} s ({len(live) / run['get_s']:.1f} req/s), p50 "
            f"{run['get_p50_ms']:.3f} ms, p99 {run['get_p99_ms']:.3f} ms; ServeStats "
            f"unmoved {st1}")
        return run
    finally:
        vs.stop()
        shutil.rmtree(vdir, ignore_errors=True)


def run_server_phase(workdir: str, volume_bytes: int, seed: int, device=None,
                     card: str = "", smi: str = "", conc_bytes: int = CONC_BYTES) -> dict:
    """The port's VolumeServer on `device` (None: the card), standalone
    in `workdir`, driven over HTTP and gRPC as its users drive it: write
    a volume of about `volume_bytes` by POST, delete, read back; encode
    and rebuild through its verbs against a native encode; serve every
    needle with four shards lost, through the tile cache and then
    exact-interval decodes (K5); two generates at once. Raises on any
    fault; returns per-run stats, launches and signature tallies:
    server_encode, server_rebuild4, server_serve, server_k5,
    server_concurrent."""
    from seaweedfs_tpu_torch import trace
    from seaweedfs_tpu_torch.ec import ec_files, ecc_sidecar
    from seaweedfs_tpu_torch.ec.codec import new_encoder
    from seaweedfs_tpu_torch.pb import rpc
    from seaweedfs_tpu_torch.pb import volume_pb2 as pb
    from seaweedfs_tpu_torch.server.volume_server import VolumeServer
    from seaweedfs_tpu_torch.storage.needle import get_actual_size

    _check_room(workdir, SERVER_ROOM if volume_bytes >= 1 << 30 else 6 * volume_bytes,
                "the server phase")
    on_card = device is None
    vdir = os.path.join(workdir, "server")
    os.mkdir(vdir)
    port = _free_port()
    before = set(threading.enumerate())
    pinned_start = _pinned_live() if on_card else None
    vs = VolumeServer([vdir], port=port, ec_codec="cuda", device=device,
                      scrub_interval=0, max_volume_counts=[8])
    vs.start()
    runs: dict = {}
    ch = rpc.dial(f"127.0.0.1:{vs.grpc_port}")
    try:
        stub = rpc.volume_stub(ch)
        vid = SERVER_VID

        def needles_of(v: int, nbytes: int, salt: int) -> dict:
            rng = np.random.default_rng((seed, salt))
            sizes, total, nid = {}, 0, 0
            while total < nbytes:
                nid += 1
                sizes[nid] = int(np.exp(rng.uniform(np.log(1024), np.log(4 << 20))))
                total += sizes[nid]
            return {f"{v},{nid:x}{nid * 2654435761 % 2**32:08x}": (nid, size)
                    for nid, size in sizes.items()}

        def items(v: int, fids: dict, which) -> list:
            return [[fid, seed + v, *fids[fid]] for fid in which]

        def post_all(v: int, fids: dict) -> tuple:
            """POST every needle of `fids`: (wall seconds, {fid: eTag})."""
            got = _load_client(port, "post", items(v, fids, fids), workdir)
            return got["wall_s"], {fid: etag for fid, _, etag in got["results"]}

        def get_all(v: int, fids: dict, live) -> tuple:
            """GET each live fid, equal to its payload: (wall seconds,
            [(fid, seconds), ...])."""
            got = _load_client(port, "get", items(v, fids, live), workdir)
            return got["wall_s"], [(fid, dt) for fid, dt, _ in got["results"]]

        # --- write a volume over HTTP: the C loop hands each connection's
        # POSTs off to a thread, which takes the one-pass C POST ---
        stub.AllocateVolume(pb.AllocateVolumeRequest(volume_id=vid), timeout=60)
        fids = needles_of(vid, volume_bytes, 1)
        st0 = _serve_stats(port)
        post_s, etags = post_all(vid, fids)
        st1 = _serve_stats(port)
        log(f"server ServeStats around the POST pass: before {st0}, after {st1}")
        posted = sum(size for _, size in fids.values())
        deleted = [fid for fid, (nid, _) in fids.items() if nid % 16 == 0]
        dels = _fan(port, SERVER_THREADS, deleted,
                    lambda c, f: _http(c, "DELETE", f"/{f}")[0])
        if set(dels) != {202}:
            raise AssertionError(f"DELETE statuses {set(dels)}")
        live = [fid for fid in fids if fid not in set(deleted)]
        st0 = _serve_stats(port)
        get_s, got = get_all(vid, fids, live)
        st1 = _serve_stats(port)
        get_stats = _stats_delta(st0, st1)
        log(f"server ServeStats around the plain-volume GET pass: before {st0}, after {st1}")
        if get_stats["served"] < len(live) or get_stats["handoffs"]:
            raise AssertionError(f"server: the plain-volume GETs were not answered from C: "
                                 f"{get_stats} for {len(live)} GETs")
        lat = [dt for _, dt in got]
        cond = live[:COND_GETS]
        got = _fan(port, 4, cond, lambda c, f: _http(c, "GET", f"/{f}", headers={
            "If-None-Match": f'"{etags[f]}"'})[0])
        gone = _fan(port, 4, deleted, lambda c, f: _http(c, "GET", f"/{f}")[0])
        if set(got) != {304} or set(gone) != {404}:
            raise AssertionError(f"conditional GETs {set(got)}, deleted GETs {set(gone)}")
        runs["server_write"] = {"post_s": post_s, "bytes": posted, "needles": len(fids),
                                "get_s": get_s, "deleted": len(deleted),
                                "get_p50_ms": _pct(lat, 50), "get_p99_ms": _pct(lat, 99),
                                "get_stats": get_stats}
        log(f"server write on {card}: {len(fids)} needles, {posted} bytes POSTed from "
            f"{SERVER_THREADS} keep-alive threads in {post_s:.4f} s "
            f"({posted / post_s / 1e9:.4f} GB/s, {len(fids) / post_s:.1f} req/s); "
            f"{len(deleted)} DELETEd (202), then 404; {len(live)} live GETs equal in "
            f"{get_s:.4f} s ({len(live) / get_s:.1f} req/s), p50 {_pct(lat, 50):.3f} ms, "
            f"p99 {_pct(lat, 99):.3f} ms; {len(cond)} conditional GETs 304")
        runs["server_threaded"] = _threaded_arm(workdir, fids, live, seed, device, card)
        c_arm, t_arm = runs["server_write"], runs["server_threaded"]
        log(f"server arms side by side on {card} (same payloads, same load generator): "
            f"POST GB/s C loop + C POST {posted / c_arm['post_s'] / 1e9:.4f} vs threaded + "
            f"Python POST {posted / t_arm['post_s'] / 1e9:.4f}; POST req/s "
            f"{len(fids) / c_arm['post_s']:.1f} vs {len(fids) / t_arm['post_s']:.1f}; GET "
            f"req/s {len(live) / c_arm['get_s']:.1f} vs {len(live) / t_arm['get_s']:.1f}; GET "
            f"p50 {c_arm['get_p50_ms']:.3f} vs {t_arm['get_p50_ms']:.3f} ms, p99 "
            f"{c_arm['get_p99_ms']:.3f} vs {t_arm['get_p99_ms']:.3f} ms")

        # --- encode through the verbs, against a native encode ---
        base = vs.store.find_volume(vid).base_name
        stub.VolumeMarkReadonly(pb.VolumeMarkReadonlyRequest(volume_id=vid), timeout=60)
        _reset_counts()
        enc_s, _ = _timed(lambda: stub.VolumeEcShardsGenerate(
            pb.VolumeEcShardsGenerateRequest(volume_id=vid), timeout=600))
        runs["server_encode"] = {"wall_s": enc_s, "launches": _read_counts(),
                                 "sigs": _read_sigs()}
        host_dir = os.path.join(workdir, "server_native")
        os.mkdir(host_dir)
        host = os.path.join(host_dir, os.path.basename(base))
        for ext in (".dat", ".idx"):
            shutil.copyfile(base + ext, host + ext)
        ns: dict = {}
        nat_s, _ = _timed(lambda: ec_files.write_ec_files(
            host, rs=new_encoder(backend="native"), want_crcs=True, durable=True,
            stats=ns))
        ec_files.write_sorted_file_from_idx(host, durable=True)
        ecc_sidecar.write_sidecar(host, ns["shard_crcs"])
        shards = [ec_files.to_ext(i) for i in range(14)]
        _same_files(base, host, shards + [".ecx", ".ecc"])
        if ns["shard_crcs"] != [_file_crc(base + ext) for ext in shards]:
            raise AssertionError("server encode: shard CRCs differ from the host shim's")
        os.remove(host + ".dat")
        dat_size = os.path.getsize(base + ".dat")
        runs["server_encode"]["native_wall_s"] = nat_s
        log(f"server encode (VolumeEcShardsGenerate) of {dat_size} bytes on {card}: "
            f"{enc_s:.4f} s ({dat_size / enc_s / 1e9:.3f} GB/s) vs native "
            f"write_ec_files {nat_s:.4f} s; shards, .ecx and .ecc byte-identical, CRCs "
            f"equal the host shim's; launches {runs['server_encode']['launches']}")

        # --- rebuild through the verb ---
        for i in LOST:
            os.remove(base + shards[i])
        _reset_counts()
        reb_s, got = _timed(lambda: stub.VolumeEcShardsRebuild(
            pb.VolumeEcShardsRebuildRequest(volume_id=vid), timeout=600))
        runs["server_rebuild4"] = {"wall_s": reb_s, "launches": _read_counts(),
                                   "sigs": _read_sigs()}
        if tuple(got.rebuilt_shard_ids) != LOST:
            raise AssertionError(f"server rebuild: rebuilt {list(got.rebuilt_shard_ids)}")
        _same_files(base, host, [shards[i] for i in LOST] + [".ecc"])
        shutil.rmtree(host_dir)
        shard_len = os.path.getsize(base + shards[0])
        log(f"server rebuild4 (VolumeEcShardsRebuild) {LOST} of {len(LOST) * shard_len} "
            f"bytes on {card}: {reb_s:.4f} s, byte-identical to the native encode's "
            f"shards, .ecc equal; launches {runs['server_rebuild4']['launches']}")

        # --- degraded serving: the .dat gone, LOST lost ---
        stub.VolumeEcShardsMount(pb.VolumeEcShardsMountRequest(
            volume_id=vid, shard_ids=list(range(14))), timeout=60)
        stub.VolumeDelete(pb.VolumeDeleteRequest(volume_id=vid), timeout=60)
        stub.VolumeEcShardsUnmount(pb.VolumeEcShardsUnmountRequest(
            volume_id=vid, shard_ids=list(LOST)), timeout=60)
        for i in LOST:
            os.remove(base + shards[i])
        ev = vs.store.find_ec_volume(vid)
        on_lost = set()
        for fid in live:
            off, size = ev.locate_needle(fids[fid][0])
            if _lost_intervals(ev, off, get_actual_size(size, ev.version)):
                on_lost.add(fid)

        def serve(label: str) -> dict:
            _reset_counts()
            s0 = trace.totals("ec.degraded")
            st0 = _serve_stats(port)
            wall, got = get_all(vid, fids, live)
            st1 = _serve_stats(port)
            spans = _span_delta("ec.degraded", s0)
            log(f"server ServeStats around the {label}: before {st0}, after {st1}")
            if not _stats_delta(st0, st1)["handoffs"]:
                raise AssertionError(f"server {label}: no connection was handed off")
            lost_lat = [dt for fid, dt in got if fid in on_lost]
            ok_lat = [dt for fid, dt in got if fid not in on_lost]
            run = {"wall_s": wall, "launches": _read_counts(), "sigs": _read_sigs(),
                   "needles": len(live), "on_lost": len(lost_lat),
                   "p50_ms_lost": _pct(lost_lat, 50), "p99_ms_lost": _pct(lost_lat, 99),
                   "p50_ms_healthy": _pct(ok_lat, 50), "p99_ms_healthy": _pct(ok_lat, 99),
                   "lost_get_s": sum(lost_lat), "decodes": spans["count"],
                   "decode_s": spans["stages"].get("decode", 0.0),
                   "gather_s": spans["stages"].get("gather", 0.0),
                   "serve_stats": _stats_delta(st0, st1)}
            log(f"server {label} on {card}: shards {LOST} lost, {len(live)} live needles "
                f"GET from {SERVER_THREADS} threads, each equal to its payload, wall "
                f"{wall:.4f} s; on a lost shard ({len(lost_lat)}) p50 "
                f"{run['p50_ms_lost']:.3f} / p99 {run['p99_ms_lost']:.3f} ms, healthy "
                f"p50 {run['p50_ms_healthy']:.3f} / p99 {run['p99_ms_healthy']:.3f} ms; "
                f"the server's ec.degraded spans: {run['decodes']} decodes, decode "
                f"{run['decode_s']:.4f} s, gather {run['gather_s']:.4f} s, against "
                f"{run['lost_get_s']:.4f} s summed over the lost-shard GETs; "
                f"launches by the serving threads {run['launches']}")
            return run

        runs["server_serve"] = serve("degraded GETs (tile cache on)")
        if not on_lost:
            raise AssertionError("no live needle lies on a lost shard")
        # --- the K5 pass: exact intervals (the cache reads the switch when
        # the EC volume is made, so remount) ---
        keep = [i for i in range(14) if i not in LOST]
        os.environ["WEED_EC_TILE_CACHE"] = "0"
        try:
            stub.VolumeEcShardsUnmount(pb.VolumeEcShardsUnmountRequest(
                volume_id=vid, shard_ids=keep), timeout=60)
            stub.VolumeEcShardsMount(pb.VolumeEcShardsMountRequest(
                volume_id=vid, shard_ids=keep), timeout=60)
            if vs.store.find_ec_volume(vid).tile_cache.capacity_bytes != 0:
                raise AssertionError("the remounted EC volume still caches tiles")
            runs["server_k5"] = serve("degraded GETs (WEED_EC_TILE_CACHE=0)")
        finally:
            os.environ.pop("WEED_EC_TILE_CACHE", None)
        k5_runs = runs["server_k5"]["launches"]
        log(f"server K5 pass on {card}: K5 launches {k5_runs['gf_bits']} (decodes under "
            f"64 KiB; tensor-core arm {k5_runs['gf_bits_mma']}, ALU arm "
            f"{k5_runs['gf_bits_alu']}), K1 launches {k5_runs['gf_apply']} (64 KiB and up)")
        if on_card:
            _must_launch("server encode", runs["server_encode"]["launches"],
                         ("gf_apply", "crc32c_rows"))
            _must_launch("server rebuild4", runs["server_rebuild4"]["launches"],
                         ("gf_apply", "crc32c_rows"))
            _must_launch("server serve", runs["server_serve"]["launches"], ("gf_apply",))
            _must_launch("server K5 pass", k5_runs, ("gf_bits", "gf_apply"))
            _must_take_mma("server K5 pass", k5_runs)

        # --- two generates at once, against the same encodes one by one ---
        conc = {}
        for j, v in enumerate((vid + 1, vid + 2)):
            stub.AllocateVolume(pb.AllocateVolumeRequest(volume_id=v), timeout=60)
            conc[v] = needles_of(v, conc_bytes, 2 + j)
            post_all(v, conc[v])
            stub.VolumeMarkReadonly(pb.VolumeMarkReadonlyRequest(volume_id=v), timeout=60)
        serial_dir = os.path.join(workdir, "server_serial")
        os.mkdir(serial_dir)
        bases = {v: vs.store.find_volume(v).base_name for v in conc}
        for b in bases.values():
            for ext in (".dat", ".idx"):
                shutil.copyfile(b + ext, os.path.join(serial_dir, os.path.basename(b) + ext))
        errors: list = []

        def generate(v):
            try:
                stub.VolumeEcShardsGenerate(pb.VolumeEcShardsGenerateRequest(volume_id=v),
                                            timeout=600)
            except Exception as e:  # noqa: BLE001 — re-raised below
                errors.append(e)

        _reset_counts()
        threads = [threading.Thread(target=generate, args=(v,)) for v in conc]
        t0 = time.perf_counter()
        for th in threads:
            th.start()
        for th in threads:
            th.join(600)
        conc_s = time.perf_counter() - t0
        runs["server_concurrent"] = {"wall_s": conc_s, "launches": _read_counts(),
                                     "sigs": _read_sigs()}
        if errors:
            raise errors[0]
        if any(th.is_alive() for th in threads):
            raise AssertionError("a concurrent generate did not finish")
        rs = new_encoder(backend="cuda", device=device)
        serial_s = 0.0
        for v, b in bases.items():
            copy = os.path.join(serial_dir, os.path.basename(b))
            st: dict = {}
            dt, _ = _timed(lambda: ec_files.write_ec_files(copy, rs=rs, want_crcs=True,
                                                           durable=True, stats=st))
            serial_s += dt
            ecc_sidecar.write_sidecar(copy, st["shard_crcs"])
            _same_files(b, copy, shards + [".ecc"])
        shutil.rmtree(serial_dir)
        if on_card:
            _must_launch("server concurrent generates", runs["server_concurrent"]["launches"],
                         ("gf_apply", "crc32c_rows"))
        log(f"server concurrency on {card}: two VolumeEcShardsGenerate at once on "
            f"volumes of {conc_bytes} bytes in {conc_s:.4f} s, shards and .ecc "
            f"byte-identical to the same encodes one after the other ({serial_s:.4f} s); "
            f"launches {runs['server_concurrent']['launches']}")
    finally:
        ch.close()
        vs.stop()
    left = _server_leftovers(before, pinned_start)
    runs["server_stop"] = left
    log(f"server stop: threads left {left['threads_left']}"
        + (f"; pinned host memory held by live tensors at the phase's start "
           f"{left['pinned_at_start']}, after stop() {left['pinned_before_gc']}, a full "
           f"collection then found {left['gc_found']} objects, held after it "
           f"{left['pinned_after_gc']}" if on_card else ""))
    if left["threads_left"]:
        raise AssertionError(f"threads outlived VolumeServer.stop(): {left['threads_left']}")
    return runs


# --- phase 3e: the cluster ---------------------------------------------------

CLUSTER_ROOM = 5 << 30  # the cluster phase's peak in its directory (about 3.6 GiB)
# SeaweedFS's default -volumeSizeLimitMB (30 GiB) cut to the least round
# size that holds the phase's 1 GiB volume with its needle headers
CLUSTER_LIMIT_MB = 1152
CLUSTER_B = tuple(range(4, 9))  # B's shards; A keeps 0-3, C gets 9-13
CLUSTER_C = tuple(range(9, 14))
CLUSTER_A = tuple(range(4))


def run_cluster_phase(workdir: str, volume_bytes: int, seed: int, device=None,
                      card: str = "", smi: str = "") -> dict:
    """The port's master tier and three volume servers on `device` (None:
    the card), all in this process, booted by availability.start_cluster
    on two racks (rack0, rack1, rack0), heartbeating every 0.2 s: one
    volume grown through the master and filled with about `volume_bytes`
    through /dir/assign from a load generator in a process of its own;
    its server is A, B the other rack's (or the first other when A holds
    rack1) and C the third; generated on A (K1 + K4) and spread as
    ec.balance would (A keeps 0-3, B gets 4-8 and C 9-13 by
    VolumeEcShardsCopy with the .ecx); every needle read through B,
    healthy (0-3 from A, 9 from C); A stopped, its shards dropped by
    the master, every needle read through B with the tile cache on (K1)
    and off (K5 under 64 KiB, K1 above), each lost interval decoded
    from B's 5 shards and 5 pulled from C; then B rebuilds 0-3 reading
    9-13 off C (K1 + K4), byte-identical to A's generated shards, CRCs
    equal to the .ecc. Raises on any fault; returns per-run stats,
    launches and signature tallies: cluster_encode, cluster_healthy,
    cluster_serve, cluster_k5, cluster_rebuild."""
    from seaweedfs_tpu_torch import trace
    from seaweedfs_tpu_torch.ec import ec_files, ecc_sidecar
    from seaweedfs_tpu_torch.pb import master_pb2, rpc
    from seaweedfs_tpu_torch.pb import volume_pb2 as pb
    from seaweedfs_tpu_torch.storage.needle import get_actual_size
    from seaweedfs_tpu_torch.util.availability import start_cluster

    _check_room(workdir, CLUSTER_ROOM if volume_bytes >= 1 << 30 else 5 * volume_bytes,
                "the cluster phase")
    on_card = device is None
    before = set(threading.enumerate())
    pinned_start = _pinned_live() if on_card else None
    dirs = [os.path.join(workdir, f"vs{i}") for i in range(3)]
    for d in dirs:
        os.mkdir(d)
    master, servers = start_cluster(dirs, volume_size_limit_mb=CLUSTER_LIMIT_MB,
                                    ec_codec="cuda", device=device, scrub_interval=0)
    stopped: list = []
    started: list = []  # names of the threads the teardown starts
    runs: dict = {}
    channels: list = []

    def wait(cond, what: str, timeout: float = 60.0) -> float:
        t0 = time.monotonic()
        while not cond():
            if time.monotonic() - t0 > timeout:
                raise AssertionError(f"cluster: {what} not seen within {timeout} s")
            time.sleep(0.02)
        return time.monotonic() - t0

    def stub(i: int):
        ch = rpc.dial(f"127.0.0.1:{servers[i].grpc_port}")
        channels.append(ch)
        return rpc.volume_stub(ch)

    def ec_locations(vid: int) -> dict:
        ch = rpc.dial(f"127.0.0.1:{master.grpc_port}")
        try:
            resp = rpc.master_stub(ch).LookupEcVolume(
                master_pb2.LookupEcVolumeRequest(volume_id=vid), timeout=10)
        finally:
            ch.close()
        return {e.shard_id: [loc.url for loc in e.locations] for e in resp.shard_id_locations}

    try:
        # --- write: one volume grown through the master, filled through /dir/assign ---
        with urllib.request.urlopen(f"http://127.0.0.1:{master.port}/vol/grow"
                                    f"?collection=ec&count=1", timeout=60) as r:
            grown = json.loads(r.read())
        if grown.get("count") != 1:
            raise AssertionError(f"cluster: /vol/grow answered {grown}")
        rng = np.random.default_rng((seed, 7))
        sizes, total = [], 0
        while total < volume_bytes:
            sizes.append(int(np.exp(rng.uniform(np.log(1024), np.log(4 << 20)))))
            total += sizes[-1]
        keys = [[f"n{nid}", seed + 7, nid, size] for nid, size in enumerate(sizes, 1)]
        got = _load_client(master.port, "assign", keys, workdir, query="collection=ec")
        post_s = got["wall_s"]
        fids = [fid for fid, _, _, _ in got["results"]]
        urls = {url for _, _, _, url in got["results"]}
        vids = {int(fid.split(",")[0]) for fid in fids}
        if len(urls) != 1 or len(vids) != 1:
            raise AssertionError(f"cluster: assigns landed on {urls}, volumes {vids}")
        vid = vids.pop()
        a = next(i for i, vs in enumerate(servers) if f"127.0.0.1:{vs.port}" in urls)
        b = 1 if a != 1 else 0
        servers[:] = [servers[a], servers[b], servers[3 - a - b]]
        a_url, b_url, c_url = (f"127.0.0.1:{vs.port}" for vs in servers)
        racks = tuple(vs.rack for vs in servers)
        runs["cluster_write"] = {"post_s": post_s, "bytes": total, "needles": len(fids)}
        log(f"cluster write on {card}: {len(fids)} needles, {total} bytes, each through "
            f"/dir/assign on the master and POSTed to the server it named (all to volume "
            f"{vid} on A; A, B, C on {racks}) from {SERVER_THREADS} keep-alive threads in "
            f"{post_s:.4f} s "
            f"({total / post_s / 1e9:.4f} GB/s, {len(fids) / post_s:.1f} req/s)")

        # --- encode on A, spread as ec.balance would ---
        sa, sb, sc = stub(0), stub(1), stub(2)
        sa.VolumeMarkReadonly(pb.VolumeMarkReadonlyRequest(volume_id=vid), timeout=60)
        _reset_counts()
        enc_s, _ = _timed(lambda: sa.VolumeEcShardsGenerate(
            pb.VolumeEcShardsGenerateRequest(volume_id=vid, collection="ec"), timeout=600))
        runs["cluster_encode"] = {"wall_s": enc_s, "launches": _read_counts(),
                                  "sigs": _read_sigs()}
        base_a = servers[0].store.find_volume(vid).base_name
        dat_size = os.path.getsize(base_a + ".dat")
        t0 = time.perf_counter()
        for s_, sids in ((sb, CLUSTER_B), (sc, CLUSTER_C)):
            s_.VolumeEcShardsCopy(pb.VolumeEcShardsCopyRequest(
                volume_id=vid, collection="ec", shard_ids=list(sids), copy_ecx_file=True,
                source_data_node=a_url), timeout=600)
            s_.VolumeEcShardsMount(pb.VolumeEcShardsMountRequest(
                volume_id=vid, collection="ec", shard_ids=list(sids)), timeout=60)
        sa.VolumeEcShardsDelete(pb.VolumeEcShardsDeleteRequest(
            volume_id=vid, collection="ec", shard_ids=list(CLUSTER_B + CLUSTER_C)), timeout=60)
        sa.VolumeEcShardsMount(pb.VolumeEcShardsMountRequest(
            volume_id=vid, collection="ec", shard_ids=list(CLUSTER_A)), timeout=60)
        sa.VolumeDelete(pb.VolumeDeleteRequest(volume_id=vid), timeout=60)
        spread_s = time.perf_counter() - t0
        seen_s = wait(lambda: len(ec_locations(vid)) == 14,
                      "LookupEcVolume with all 14 shards")
        locs = ec_locations(vid)
        want = {**{i: [a_url] for i in CLUSTER_A}, **{i: [b_url] for i in CLUSTER_B},
                **{i: [c_url] for i in CLUSTER_C}}
        if locs != want:
            raise AssertionError(f"cluster: the master's shard map {locs}")
        shard_len = os.path.getsize(base_a + ec_files.to_ext(0))
        runs["cluster_encode"].update(spread_s=spread_s, dat_bytes=dat_size)
        log(f"cluster encode on {card}: VolumeEcShardsGenerate on A of {dat_size} bytes "
            f"{enc_s:.4f} s ({dat_size / enc_s / 1e9:.3f} GB/s); spread (VolumeEcShardsCopy "
            f"of {len(CLUSTER_B)} shards of {shard_len} bytes and the .ecx to B and to C, "
            f"mounts, A's deletes) {spread_s:.4f} s; the master's LookupEcVolume showed the "
            f"14 shards on A {CLUSTER_A}, B {CLUSTER_B}, C {CLUSTER_C} {seen_s:.2f} s later; "
            f"launches {runs['cluster_encode']['launches']}")

        # --- GETs through B: healthy, then with A lost ---
        ev = servers[1].store.find_ec_volume(vid)
        items = [[fid, seed + 7, nid, size] for fid, (_, _, nid, size) in zip(fids, keys)]
        on_a, remote = set(), set()
        for fid, _, nid, _ in items:
            off, size = ev.locate_needle(int(fid.split(",")[1][:-8], 16))
            span = get_actual_size(size, ev.version)
            if _lost_intervals(ev, off, span, CLUSTER_A):
                on_a.add(fid)
            if _lost_intervals(ev, off, span, CLUSTER_A + CLUSTER_C):
                remote.add(fid)

        def serve(label: str, lost: bool) -> dict:
            _reset_counts()
            s0 = trace.totals("ec.degraded")
            r0 = trace.totals("volume.ec_shard_read")
            got = _load_client(servers[1].port, "get", items, workdir)
            spans = _span_delta("ec.degraded", s0)
            reads = _span_delta("volume.ec_shard_read", r0)
            mark = on_a if lost else remote
            hit = [dt for fid, dt, _ in got["results"] if fid in mark]
            rest = [dt for fid, dt, _ in got["results"] if fid not in mark]
            run = {"wall_s": got["wall_s"], "launches": _read_counts(), "sigs": _read_sigs(),
                   "needles": len(items), "marked": len(hit),
                   "p50_ms_marked": _pct(hit, 50), "p99_ms_marked": _pct(hit, 99),
                   "p50_ms_rest": _pct(rest, 50), "p99_ms_rest": _pct(rest, 99),
                   "marked_get_s": sum(hit), "decodes": spans["count"],
                   "decode_s": spans["stages"].get("decode", 0.0),
                   "gather_s": spans["stages"].get("gather", 0.0),
                   "shard_reads": reads["count"], "shard_read_bytes": reads["bytes"]}
            kind = "on a lost shard (0-3)" if lost else "with a remote interval (0-3, 9-13)"
            log(f"cluster {label} on {card}: {len(items)} needles GET through B from "
                f"{SERVER_THREADS} threads, each equal to its payload, wall "
                f"{got['wall_s']:.4f} s; {kind} ({len(hit)}) p50 {run['p50_ms_marked']:.3f} / "
                f"p99 {run['p99_ms_marked']:.3f} ms, the rest p50 {run['p50_ms_rest']:.3f} / "
                f"p99 {run['p99_ms_rest']:.3f} ms; B's ec.degraded spans: {run['decodes']} "
                f"decodes, gather {run['gather_s']:.4f} s, decode {run['decode_s']:.4f} s, "
                f"against {run['marked_get_s']:.4f} s summed over those GETs; "
                f"VolumeEcShardRead served {run['shard_reads']} reads of "
                f"{run['shard_read_bytes']} bytes by A and C; launches {run['launches']}")
            return run

        runs["cluster_healthy"] = serve("healthy GETs (0-3 from A, 9 from C)", lost=False)
        if runs["cluster_healthy"]["decodes"]:
            raise AssertionError("cluster: a healthy GET decoded")
        servers[0].stop()
        stopped.append(servers[0])
        gone_s = wait(lambda: not any(i in ec_locations(vid) for i in CLUSTER_A),
                      "the master dropping A's shards")
        log(f"cluster: A stopped; its heartbeat stream's end dropped shards {CLUSTER_A} "
            f"from the master's map in {gone_s:.2f} s")
        runs["cluster_serve"] = serve("lost-server GETs (tile cache on)", lost=True)
        os.environ["WEED_EC_TILE_CACHE"] = "0"
        try:
            sb.VolumeEcShardsUnmount(pb.VolumeEcShardsUnmountRequest(
                volume_id=vid, shard_ids=list(CLUSTER_B)), timeout=60)
            sb.VolumeEcShardsMount(pb.VolumeEcShardsMountRequest(
                volume_id=vid, collection="ec", shard_ids=list(CLUSTER_B)), timeout=60)
            if servers[1].store.find_ec_volume(vid).tile_cache.capacity_bytes != 0:
                raise AssertionError("cluster: the remounted EC volume still caches tiles")
            runs["cluster_k5"] = serve("lost-server GETs (WEED_EC_TILE_CACHE=0)", lost=True)
        finally:
            os.environ.pop("WEED_EC_TILE_CACHE", None)
        if not on_a:
            raise AssertionError("cluster: no needle lies on shards 0-3")

        # --- rack-gather rebuild on B ---
        _reset_counts()
        reb_s, got = _timed(lambda: sb.VolumeEcShardsRebuild(pb.VolumeEcShardsRebuildRequest(
            volume_id=vid, collection="ec"), timeout=600))
        runs["cluster_rebuild"] = {"wall_s": reb_s, "launches": _read_counts(),
                                   "sigs": _read_sigs(), "bytes": len(CLUSTER_A) * shard_len}
        if tuple(got.rebuilt_shard_ids) != CLUSTER_A:
            raise AssertionError(f"cluster rebuild: rebuilt {list(got.rebuilt_shard_ids)}")
        base_b = servers[1].store.find_ec_volume(vid).base_name
        sidecar = ecc_sidecar.load_sidecar(base_a)["shards"]
        for i in CLUSTER_A:
            ext = ec_files.to_ext(i)
            if not filecmp.cmp(base_a + ext, base_b + ext, shallow=False):
                raise AssertionError(f"cluster rebuild: B's {ext} differs from A's generate")
            if _file_crc(base_b + ext) != sidecar[str(i)]["crc"]:
                raise AssertionError(f"cluster rebuild: B's {ext} CRC differs from the .ecc")
        log(f"cluster rebuild on {card}: VolumeEcShardsRebuild on B of {CLUSTER_A}, "
            f"{len(CLUSTER_A) * shard_len} bytes, survivors {CLUSTER_B} local and "
            f"{CLUSTER_C} read off C through remote_readers, {reb_s:.4f} s "
            f"({len(CLUSTER_A) * shard_len / reb_s / 1e9:.3f} GB/s rebuilt); byte-identical "
            f"to A's generated shards, CRCs equal to A's .ecc; launches "
            f"{runs['cluster_rebuild']['launches']}")
        if on_card:
            _must_launch("cluster encode", runs["cluster_encode"]["launches"],
                         ("gf_apply", "crc32c_rows"))
            _must_launch("cluster serve", runs["cluster_serve"]["launches"], ("gf_apply",))
            _must_launch("cluster K5 pass", runs["cluster_k5"]["launches"],
                         ("gf_bits", "gf_apply"))
            _must_take_mma("cluster K5 pass", runs["cluster_k5"]["launches"])
            _must_launch("cluster rebuild", runs["cluster_rebuild"]["launches"],
                         ("gf_apply", "crc32c_rows"))
        phase = {k: sum(runs[r]["launches"][k] for r in
                        ("cluster_encode", "cluster_healthy", "cluster_serve", "cluster_k5",
                         "cluster_rebuild"))
                 for k in ("gf_apply", "crc32c_rows", "gf_bits")}
        log(f"cluster launches on {card}: {phase} (K1 gf_apply, K4 crc32c_rows, "
            f"K5 gf_bits)")
    finally:
        for ch in channels:
            ch.close()
        with _threads_started(started):
            for vs in servers:
                if vs not in stopped:
                    vs.stop()
            master.stop()
    if not any(rpc.GRACE_THREAD in n for n in started):
        raise AssertionError(f"cluster stop: grpc started no {rpc.GRACE_THREAD} thread "
                             f"(started {started}), so stop_server joined none")
    left = _server_leftovers(before, pinned_start)
    runs["cluster_stop"] = left
    log(f"cluster stop: threads left {left['threads_left']}"
        + (f"; pinned host memory held by live tensors at the phase's start "
           f"{left['pinned_at_start']}, after stop() {left['pinned_before_gc']}, after a "
           f"full collection {left['pinned_after_gc']}" if on_card else ""))
    if left["threads_left"]:
        raise AssertionError(f"threads outlived the cluster's stop(): {left['threads_left']}")
    return runs


# --- phase 3f: the admin plane, through the shell ---------------------------


ADMIN_ROOM = 7 << 30  # steps 1-3's peak in the admin phase's directory (about 6.2 GiB)
ADMIN_BATCH_VID0 = 1001  # the batch volumes' ids, written before the servers boot
ADMIN_MOVE_NEEDLES = 48


def run_admin_phase(workdir: str, volume_bytes: int, batch_volumes: int,
                    batch_volume_bytes: int, seed: int, device=None, card: str = "",
                    smi: str = "") -> dict:
    """The admin plane on `device` (None: the card): a master and three
    volume servers booted by availability.start_cluster on two racks,
    with `batch_volumes` sealed volumes of about `batch_volume_bytes`
    written by storage/synthetic.write_volume into the first server's
    directory before it boots; every step then goes through the port's
    shell (seaweedfs_tpu_torch.shell.run_command with a CommandEnv on
    the master), as an operator runs it:
      1. ec.encode -volumeId V of one volume grown through /vol/grow and
         filled with about `volume_bytes` through /dir/assign by the load
         generator (BASELINE.json config 1): the 14 shards, wherever the
         spread put them, byte-identical to the native host codec's
         encode of a snapshot of the .dat, each file's CRC equal to the
         generator's .ecc, the source volume gone from every server and
         every needle read back over HTTP (K1 + K4);
      2. ec.balance -force, then shards (0, 5, 10, 13) unmounted and
         deleted on their holders, copies saved first (no server is
         stopped: one of three may hold five shards);
      3. ec.rebuild -volumeId V -force (BASELINE.json config 4): the
         rebuilder gathers survivors off the other holders; the rebuilt
         shards equal the saved copies and the generator's .ecc, every
         needle reads back (K1 + K4);
      4. ec.batch over the sealed volumes (BASELINE.json config 3,
         WEED_EC_PIPELINE_BATCH as the batch phase's): every volume's
         shards equal the native codec's encode of its snapshot, CRCs
         equal each .ecc, the volume serves from EC (a needle of each
         read over HTTP) (K2 + K4);
      5. ec.rebuild.batch over them after losing (3,) on odd volumes and
         (0, 5, 10, 13) on even ones: byte-identical (K2);
      6. a VolumeTailReceiver on a second server following appends to a
         small volume on its source (every needle read back equal), then
         volume.move of that volume to the third server (VolumeCopy):
         .dat and .idx equal the source's.
    Raises on any fault; returns per-step walls, launches and signature
    tallies: admin_encode, admin_rebuild, admin_batch,
    admin_rebuild_batch."""
    from seaweedfs_tpu_torch import trace
    from seaweedfs_tpu_torch.ec import ec_files, ecc_sidecar
    from seaweedfs_tpu_torch.ec.codec import new_encoder
    from seaweedfs_tpu_torch.pb import rpc
    from seaweedfs_tpu_torch.pb import volume_pb2 as pb
    from seaweedfs_tpu_torch.shell import CommandEnv, run_command
    from seaweedfs_tpu_torch.storage.needle import Needle
    from seaweedfs_tpu_torch.storage.super_block import VERSION3
    from seaweedfs_tpu_torch.storage.synthetic import write_volume
    from seaweedfs_tpu_torch.util.availability import start_cluster

    _check_room(workdir, ADMIN_ROOM if volume_bytes >= 1 << 30 else 8 * volume_bytes
                + 5 * batch_volumes * batch_volume_bytes, "the admin phase")
    on_card = device is None
    shard_exts = [ec_files.to_ext(i) for i in range(14)]
    native = new_encoder(backend="native")
    before = set(threading.enumerate())
    pinned_start = _pinned_live() if on_card else None
    dirs = [os.path.join(workdir, f"vs{i}") for i in range(3)]
    for d in dirs:
        os.mkdir(d)
    t0 = time.perf_counter()
    batch_vids = list(range(ADMIN_BATCH_VID0, ADMIN_BATCH_VID0 + batch_volumes))
    batch_entries = {}
    for vid in batch_vids:
        _, batch_entries[vid] = write_volume(os.path.join(dirs[0], str(vid)),
                                             batch_volume_bytes, seed * 100003 + vid,
                                             max_payload=1 << 20)
    log(f"admin: {batch_volumes} sealed volumes of ~{batch_volume_bytes / 2**20:.2f} MiB "
        f"written by storage/synthetic.write_volume into the first server's directory "
        f"before it boots, in {time.perf_counter() - t0:.3f} s")
    old_limit = os.environ.get("WEED_EC_PIPELINE_BATCH")
    os.environ["WEED_EC_PIPELINE_BATCH"] = str(BATCH)
    master, servers = start_cluster(dirs, volume_size_limit_mb=CLUSTER_LIMIT_MB,
                                    ec_codec="cuda", device=device, scrub_interval=0)
    env = CommandEnv([f"127.0.0.1:{master.port}"])
    url_of = {f"127.0.0.1:{vs.port}": vs for vs in servers}
    started: list = []
    runs: dict = {}

    def wait(cond, what: str, timeout: float = 60.0) -> float:
        t0 = time.monotonic()
        while not cond():
            if time.monotonic() - t0 > timeout:
                raise AssertionError(f"admin: {what} not seen within {timeout} s")
            time.sleep(0.02)
        return time.monotonic() - t0

    def shell(step: str, line: str, *kernels) -> dict:
        """`line` through the shell: its wall, the launches it made and
        the seconds of the EC pipelines' spans inside it (the verbs'
        device paths)."""
        pipelines = ("ec_stream.encode", "ec_stream.rebuild", "ec_stream.encode_batch",
                     "ec_stream.rebuild_batch")
        spans0 = {name: trace.totals(name) for name in pipelines}
        _reset_counts()
        t0 = time.perf_counter()
        out = run_command(env, line)
        wall = time.perf_counter() - t0
        span_s = {name: _span_delta(name, spans0[name])["seconds"] for name in pipelines}
        run = {"wall_s": wall, "launches": _read_counts(), "sigs": _read_sigs(),
               "command": line, "pipeline_s": {k: v for k, v in span_s.items() if v}}
        if on_card:
            _must_launch(f"admin {step}", run["launches"], kernels)
        tail = " | ".join(out.strip().splitlines()[-3:])
        log(f"admin {step} on {card}: `{line}` {wall:.4f} s, of it in the EC pipelines' "
            f"spans {run['pipeline_s']}; launches {run['launches']}; shell: {tail}")
        return run

    def registered(vid: int) -> set:
        locs = master.topology.lookup_ec_shards(vid)
        return set() if locs is None else {i for i, l in enumerate(locs.locations) if l}

    def holders(vid: int) -> dict:
        """{shard id: server} of the mounted shards of `vid`."""
        out = {}
        for vs in servers:
            ev = vs.store.find_ec_volume(vid)
            for sid in (ev.shard_ids() if ev is not None else ()):
                if sid in out:
                    raise AssertionError(f"admin: shard {sid} of {vid} mounted twice")
                out[sid] = vs
        return out

    def shard_file(vs, vid: int, collection: str, sid: int) -> str:
        name = f"{collection}_{vid}" if collection else str(vid)
        return os.path.join(vs.store.locations[0].directory, name + ec_files.to_ext(sid))

    def check_ecc(vid: int, collection: str, gen, where: dict, what: str) -> None:
        """Each shard's CRC (read back from its holder's file) equals the
        .ecc the generating server published."""
        name = f"{collection}_{vid}" if collection else str(vid)
        sidecar = ecc_sidecar.load_sidecar(
            os.path.join(gen.store.locations[0].directory, name))["shards"]
        for sid, vs in where.items():
            if _file_crc(shard_file(vs, vid, collection, sid)) != sidecar[str(sid)]["crc"]:
                raise AssertionError(f"admin {what}: shard {sid} of {vid} differs from its "
                                     f".ecc")

    try:
        # --- 1. ec.encode of one ~1 GiB volume ---
        with urllib.request.urlopen(f"http://127.0.0.1:{master.port}/vol/grow"
                                    f"?collection=admin&count=1", timeout=60) as r:
            grown = json.loads(r.read())
        if grown.get("count") != 1:
            raise AssertionError(f"admin: /vol/grow answered {grown}")
        rng = np.random.default_rng((seed, 11))
        sizes, total = [], 0
        while total < volume_bytes:
            sizes.append(int(np.exp(rng.uniform(np.log(1024), np.log(4 << 20)))))
            total += sizes[-1]
        keys = [[f"a{nid}", seed + 11, nid, size] for nid, size in enumerate(sizes, 1)]
        got = _load_client(master.port, "assign", keys, workdir, query="collection=admin")
        fids = [fid for fid, _, _, _ in got["results"]]
        vids = {int(fid.split(",")[0]) for fid in fids}
        if len(vids) != 1:
            raise AssertionError(f"admin: assigns landed on volumes {vids}")
        vid = vids.pop()
        src = next(vs for vs in servers if vs.store.find_volume(vid) is not None)
        base = src.store.find_volume(vid).base_name
        snap = os.path.join(workdir, "snap")
        os.mkdir(snap)
        shutil.copyfile(base + ".dat", os.path.join(snap, "v.dat"))
        t0 = time.perf_counter()
        ec_files.write_ec_files(os.path.join(snap, "v"), rs=native)
        native_s = time.perf_counter() - t0
        log(f"admin write on {card}: {len(fids)} needles, {total} bytes into volume {vid} "
            f"through /dir/assign in {got['wall_s']:.4f} s; .dat snapshot encoded by the "
            f"native host codec in {native_s:.4f} s")
        items = [[fid, seed + 11, nid, size] for fid, (_, _, nid, size) in zip(fids, keys)]
        dat_bytes = os.path.getsize(base + ".dat")
        runs["admin_encode"] = shell("ec.encode", f"ec.encode -volumeId {vid}",
                                     "gf_apply", "crc32c_rows")
        runs["admin_encode"].update(dat_bytes=dat_bytes, native_s=native_s)
        seen_s = wait(lambda: len(registered(vid)) == 14, "the 14 shards registered")
        if any(vs.store.find_volume(vid) is not None for vs in servers):
            raise AssertionError(f"admin ec.encode: volume {vid} still on a server")
        where = holders(vid)
        if sorted(where) != list(range(14)):
            raise AssertionError(f"admin ec.encode: mounted shards {sorted(where)}")
        for sid, vs in where.items():
            if not filecmp.cmp(shard_file(vs, vid, "admin", sid),
                               os.path.join(snap, "v" + shard_exts[sid]), shallow=False):
                raise AssertionError(f"admin ec.encode: shard {sid} differs from native's")
        check_ecc(vid, "admin", src, where, "ec.encode")
        reader = max(servers, key=lambda vs: sum(1 for s in where.values() if s is vs))
        read = _load_client(reader.port, "get", items, workdir)
        spread = {f"127.0.0.1:{vs.port}": sorted(s for s, h in where.items() if h is vs)
                  for vs in servers}
        log(f"admin ec.encode: shards {spread} registered {seen_s:.2f} s after the verb, "
            f"byte-identical to the native codec's, CRCs equal to the .ecc; every one of "
            f"{len(items)} needles read back through {reader.port} in "
            f"{read['wall_s']:.4f} s")

        # --- 2. ec.balance, then lose four shards ---
        runs["admin_balance"] = shell("ec.balance", "ec.balance -force")
        wait(lambda: len(registered(vid)) == 14 and len(holders(vid)) == 14,
             "the balanced shards registered")
        where = holders(vid)
        saved = os.path.join(workdir, "saved")
        os.mkdir(saved)
        for sid in LOST:
            vs = where[sid]
            shutil.copyfile(shard_file(vs, vid, "admin", sid),
                            os.path.join(saved, shard_exts[sid]))
            with rpc.dial(f"127.0.0.1:{vs.grpc_port}") as ch:
                stub = rpc.volume_stub(ch)
                stub.VolumeEcShardsUnmount(pb.VolumeEcShardsUnmountRequest(
                    volume_id=vid, shard_ids=[sid]), timeout=60)
                stub.VolumeEcShardsDelete(pb.VolumeEcShardsDeleteRequest(
                    volume_id=vid, collection="admin", shard_ids=[sid]), timeout=60)
        wait(lambda: not registered(vid) & set(LOST), "the master dropping the lost shards")
        log(f"admin: after ec.balance shards {LOST} were on "
            f"{[where[s].port for s in LOST]}; saved, unmounted and deleted there")

        # --- 3. ec.rebuild ---
        runs["admin_rebuild"] = shell("ec.rebuild", f"ec.rebuild -volumeId {vid} -force",
                                      "gf_apply", "crc32c_rows")
        wait(lambda: len(registered(vid)) == 14, "the rebuilt shards registered")
        where = holders(vid)
        rebuilder = where[LOST[0]]
        for sid in LOST:
            if where[sid] is not rebuilder or not filecmp.cmp(
                    shard_file(rebuilder, vid, "admin", sid),
                    os.path.join(saved, shard_exts[sid]), shallow=False):
                raise AssertionError(f"admin ec.rebuild: shard {sid} differs from the saved")
        check_ecc(vid, "admin", src, {s: where[s] for s in LOST}, "ec.rebuild")
        read = _load_client(rebuilder.port, "get", items, workdir)
        runs["admin_rebuild"]["bytes"] = len(LOST) * os.path.getsize(
            os.path.join(saved, shard_exts[0]))
        log(f"admin ec.rebuild: {LOST} rebuilt on {rebuilder.port} byte-identical to the "
            f"saved copies, CRCs equal to the generator's .ecc; every needle read back in "
            f"{read['wall_s']:.4f} s")
        shutil.rmtree(snap)
        shutil.rmtree(saved)

        # --- 4. ec.batch over the sealed volumes ---
        # the native encodes, the servers' shards (3.5x the .dat each) and
        # the rebuild's saved copies
        _check_room(workdir, 8 * batch_volumes * batch_volume_bytes,
                    "the admin phase's batch steps")
        host = servers[0]
        snap = os.path.join(workdir, "batch_snap")
        os.mkdir(snap)
        t0 = time.perf_counter()
        probes = {}  # vid -> (fid, payload) of its middle needle
        for v in batch_vids:
            dat = os.path.join(snap, f"{v}.dat")
            shutil.copyfile(os.path.join(dirs[0], f"{v}.dat"), dat)
            nid, off, nsize = batch_entries[v][len(batch_entries[v]) // 2]
            with open(dat, "rb") as f:
                f.seek(off)
                n = Needle.from_bytes(f.read(16 + nsize + 4 + 8), VERSION3, nsize)
            probes[v] = (f"{v},{nid:x}{n.cookie:08x}", n.data)
            ec_files.write_ec_files(os.path.join(snap, str(v)), rs=native)
            os.remove(dat)
        log(f"admin: the {batch_volumes} volumes' snapshots encoded by the native codec "
            f"in {time.perf_counter() - t0:.3f} s")
        runs["admin_batch"] = shell(
            "ec.batch", "ec.batch -volumeIds " + ",".join(map(str, batch_vids)),
            "gf_apply_batch", "crc32c_rows")
        runs["admin_batch"]["dat_bytes"] = batch_volumes * batch_volume_bytes
        for v in batch_vids:
            b = os.path.join(dirs[0], str(v))
            for ext in shard_exts:
                if not filecmp.cmp(b + ext, os.path.join(snap, str(v) + ext), shallow=False):
                    raise AssertionError(f"admin ec.batch: volume {v} {ext} differs")
            if host.store.find_volume(v) is not None or host.store.find_ec_volume(v) is None:
                raise AssertionError(f"admin ec.batch: volume {v} does not serve from EC")
        for v in batch_vids:
            check_ecc(v, "", host, {s: host for s in range(14)}, "ec.batch")
        conn = http.client.HTTPConnection("127.0.0.1", host.port, timeout=60)
        try:
            for v, (fid, data) in probes.items():
                status, _, body = _http(conn, "GET", f"/{fid}")
                if status != 200 or body != data:
                    raise AssertionError(f"admin ec.batch: GET of {fid}: {status}")
        finally:
            conn.close()
        log(f"admin ec.batch: {batch_volumes} volumes x 14 shards byte-identical to the "
            f"native codec's, CRCs equal to each .ecc, each volume serving from EC (one "
            f"needle of each read over HTTP)")

        # --- 5. ec.rebuild.batch over two damage signatures ---
        saved = os.path.join(workdir, "batch_saved")
        os.mkdir(saved)
        for v in batch_vids:
            lost = (3,) if v % 2 else LOST
            with rpc.dial(f"127.0.0.1:{host.grpc_port}") as ch:
                rpc.volume_stub(ch).VolumeEcShardsUnmount(pb.VolumeEcShardsUnmountRequest(
                    volume_id=v, shard_ids=list(lost)), timeout=60)
            for sid in lost:
                p = os.path.join(dirs[0], str(v) + shard_exts[sid])
                os.replace(p, os.path.join(saved, os.path.basename(p)))
        wait(lambda: all(len(registered(v)) == (13 if v % 2 else 10) for v in batch_vids),
             "the master dropping the batch volumes' lost shards")
        runs["admin_rebuild_batch"] = shell(
            "ec.rebuild.batch",
            "ec.rebuild.batch -force -volumeIds " + ",".join(map(str, batch_vids)),
            "gf_apply_batch")
        for name in os.listdir(saved):
            if not filecmp.cmp(os.path.join(dirs[0], name), os.path.join(saved, name),
                               shallow=False):
                raise AssertionError(f"admin ec.rebuild.batch: {name} differs")
        wait(lambda: all(len(registered(v)) == 14 for v in batch_vids),
             "the rebuilt batch shards registered")
        for v in batch_vids:
            lost = (3,) if v % 2 else LOST
            check_ecc(v, "", host, {s: host for s in lost}, "ec.rebuild.batch")
        runs["admin_rebuild_batch"]["bytes"] = sum(
            os.path.getsize(os.path.join(saved, n)) for n in os.listdir(saved))
        log(f"admin ec.rebuild.batch: {len(os.listdir(saved))} shard files of "
            f"{batch_volumes} volumes byte-identical to the saved, CRCs equal to each .ecc")
        shutil.rmtree(snap)
        shutil.rmtree(saved)

        # --- 6. a tail receiver, then volume.move ---
        with urllib.request.urlopen(f"http://127.0.0.1:{master.port}/vol/grow"
                                    f"?collection=move&count=1", timeout=60) as r:
            if json.loads(r.read()).get("count") != 1:
                raise AssertionError("admin: /vol/grow of the move volume failed")
        mkeys = [[f"m{nid}", seed + 12, nid, 4096 + 997 * nid]
                 for nid in range(1, ADMIN_MOVE_NEEDLES + 1)]
        half = ADMIN_MOVE_NEEDLES // 2
        got = _load_client(master.port, "assign", mkeys[:half], workdir,
                           query="collection=move")
        mvid = int(got["results"][0][0].split(",")[0])
        msrc = url_of[got["results"][0][3]]
        tailer, dest = [vs for vs in servers if vs is not msrc]
        with rpc.dial(f"127.0.0.1:{tailer.grpc_port}") as ch:
            rpc.volume_stub(ch).AllocateVolume(pb.AllocateVolumeRequest(
                volume_id=mvid, collection="move"), timeout=60)
        tail_err: list = []

        def follow():
            try:
                with rpc.dial(f"127.0.0.1:{tailer.grpc_port}") as ch:
                    rpc.volume_stub(ch).VolumeTailReceiver(pb.VolumeTailReceiverRequest(
                        volume_id=mvid, since_ns=0, idle_timeout_seconds=3,
                        source_volume_server=f"127.0.0.1:{msrc.port}"), timeout=120)
            except Exception as e:  # noqa: BLE001 — raised below
                tail_err.append(e)

        th = threading.Thread(target=follow)
        th.start()
        more = _load_client(master.port, "assign", mkeys[half:], workdir,
                            query="collection=move")
        th.join(120)
        if th.is_alive() or tail_err:
            raise AssertionError(f"admin tail: receiver {'hung' if th.is_alive() else tail_err}")
        mresults = got["results"] + more["results"]
        if {int(r[0].split(",")[0]) for r in mresults} != {mvid}:
            raise AssertionError("admin tail: the move volume's assigns spread")
        mitems = [[fid, seed + 12, nid, size]
                  for (fid, _, _, _), (_, _, nid, size) in zip(mresults, mkeys)]
        _load_client(tailer.port, "get", mitems, workdir)
        log(f"admin tail: VolumeTailReceiver on {tailer.port} followed volume {mvid} on "
            f"{msrc.port} while {ADMIN_MOVE_NEEDLES - half} of {ADMIN_MOVE_NEEDLES} needles "
            f"were appended; every needle read back from the receiver equal")
        mbase = msrc.store.find_volume(mvid).base_name
        want = {ext: open(mbase + ext, "rb").read() for ext in (".dat", ".idx")}
        runs["admin_move"] = shell(
            "volume.move", f"volume.move -from 127.0.0.1:{msrc.port} "
            f"-to 127.0.0.1:{dest.port} -volumeId {mvid}")
        moved = dest.store.find_volume(mvid)
        if moved is None or msrc.store.find_volume(mvid) is not None:
            raise AssertionError(f"admin volume.move: volume {mvid} did not move")
        for ext, data in want.items():
            with open(moved.base_name + ext, "rb") as f:
                if f.read() != data:
                    raise AssertionError(f"admin volume.move: {ext} differs from the source")
        _load_client(dest.port, "get", mitems, workdir)
        log(f"admin volume.move: volume {mvid} moved {msrc.port} => {dest.port}, .dat and "
            f".idx equal to the source's, every needle read back from {dest.port}")
        total = {k: sum(runs[r]["launches"][k] for r in ADMIN_PATHS)
                 for k in ("gf_apply", "gf_apply_batch", "crc32c_rows")}
        log(f"admin launches on {card}: {total} (K1 gf_apply, K2 gf_apply_batch, K4 "
            f"crc32c_rows; each wrapper counts only its kernel's launches on the card, "
            f"never a plain version's run); {smi}")
    finally:
        if old_limit is None:
            os.environ.pop("WEED_EC_PIPELINE_BATCH", None)
        else:
            os.environ["WEED_EC_PIPELINE_BATCH"] = old_limit
        with _threads_started(started):
            for vs in servers:
                vs.stop()
            master.stop()
    left = _server_leftovers(before, pinned_start)
    runs["admin_stop"] = left
    log(f"admin stop: threads left {left['threads_left']}")
    if left["threads_left"]:
        raise AssertionError(f"threads outlived the admin cluster's stop(): "
                             f"{left['threads_left']}")
    return runs


ADMIN_PATHS = ("admin_encode", "admin_balance", "admin_rebuild", "admin_batch",
               "admin_rebuild_batch", "admin_move")


# --- phase 3g: the command line and the integrity plane ---------------------

CLI_ROOM = 4 << 30  # the cli phase's peak in its directory (about 3.2 GiB)
CLI_FILE_BYTES = 1 << 20  # the benchmark's -size
CLI_TILE = 4 << 20  # the scrub's tile (scrub/verify.DEFAULT_TILE_BYTES)
CLI_BAD_TILES = (1, 2)  # the data and the parity culprit's corrupt tile
CLI_REPAIR_GRACE = 8.0  # -repairGrace: both quarantines land inside it


def _cli_metrics(port: int) -> dict:
    """{(family, labels): value} off a server's /metrics."""
    with urllib.request.urlopen(f"http://127.0.0.1:{port}/metrics", timeout=30) as r:
        text = r.read().decode()
    out = {}
    for line in text.splitlines():
        if line.startswith("#") or not line.strip():
            continue
        name_labels, _, value = line.rpartition(" ")
        out[name_labels] = float(value)
    return out


def _cli_launches(metrics: dict) -> dict:
    return {k: int(metrics.get(f'weed_kernel_launches{{kernel="{k}"}}', 0))
            for k in ("gf_apply", "gf_apply_batch", "gf_verify_batch", "crc32c_rows",
                      "gf_bits", "gf_bits_mma", "gf_bits_alu")}


def _repo_on_path(env: dict) -> dict:
    """`env` with this repo first on PYTHONPATH, for a process that runs
    in a directory of its own."""
    here = os.path.dirname(os.path.abspath(__file__))
    return dict(env, PYTHONPATH=os.pathsep.join(
        [here] + [p for p in [env.get("PYTHONPATH")] if p]))


class _CliShell:
    """`python -m seaweedfs_tpu_torch shell` as an operator runs it, one
    process kept open: each command is written to its stdin, and its
    output is read up to a marker line (an unknown command's error,
    which the shell prints and flushes with its next prompt)."""

    def __init__(self, argv: list, env: dict, log_path: str, cwd: str | None = None):
        import queue

        self.proc = subprocess.Popen(argv, stdin=subprocess.PIPE, stdout=subprocess.PIPE,
                                     stderr=open(log_path, "w"), text=True,
                                     env=env if cwd is None else _repo_on_path(env),
                                     cwd=cwd or os.path.dirname(os.path.abspath(__file__)))
        self.lines: "queue.Queue" = queue.Queue()
        self._n = 0
        threading.Thread(target=self._pump, daemon=True, name="cli-shell-reader").start()

    def _pump(self) -> None:
        for line in self.proc.stdout:
            self.lines.put(line)
        self.lines.put(None)

    def run(self, line: str, timeout: float = 600.0) -> tuple[float, str]:
        import queue

        self._n += 1
        marker = f"cli-smoke-mark-{self._n}"
        t0 = time.perf_counter()
        self.proc.stdin.write(f"{line}\n{marker}\n")
        self.proc.stdin.flush()
        out = []
        deadline = time.monotonic() + timeout
        while True:
            try:
                got = self.lines.get(timeout=max(0.1, deadline - time.monotonic()))
            except queue.Empty:
                raise AssertionError(f"cli shell: `{line}` gave no answer in {timeout} s")
            if got is None:
                raise AssertionError(f"cli shell exited during `{line}`: {''.join(out)}")
            if marker in got:
                wall = time.perf_counter() - t0
                text = "".join(out).replace("> ", "")
                if "error:" in text:
                    raise AssertionError(f"cli shell: `{line}` failed: {text}")
                return wall, text
            out.append(got)

    def exit(self, timeout: float = 60.0) -> int:
        self.proc.stdin.write("exit\n")
        self.proc.stdin.flush()
        return self.proc.wait(timeout)


def _cli_verify(paths: dict, tile: int, rs):
    """verify_parity_stream over shard files {sid: path} (pread readers)."""
    from seaweedfs_tpu_torch.scrub.verify import verify_parity_stream

    fds = {sid: os.open(p, os.O_RDONLY) for sid, p in paths.items()}
    try:
        readers = [lambda off, size, fd=fds[sid]: os.pread(fd, size, off)
                   for sid in range(14)]
        return verify_parity_stream(readers, rs=rs, tile_bytes=tile)
    finally:
        for fd in fds.values():
            os.close(fd)


def _cli_verify_both(paths: dict, tile: int, device, what: str, card: str) -> dict:
    """The scrub's verify core in this process over the shards' files: on
    `device` (None: the card; K1, and K5 on a short last tile) and on
    K1's plain version, whose codec calls are counted. Both runs must
    give the same mismatch counts, bad tiles and culprits, and the card
    run must launch one kernel a codec call of the plain run: one
    re-encode a tile, and each localization hypothesis's decodes and
    re-encode."""
    from seaweedfs_tpu_torch.ec.codec import new_encoder

    rs_card = new_encoder(backend="cuda", device=device)
    _reset_counts()
    wall, res = _timed(lambda: _cli_verify(paths, tile, rs_card))
    launches = _read_counts()
    rs_plain = new_encoder(backend="cuda", device="cpu")
    calls = [0]
    apply = rs_plain._apply

    def counted(matrix, inputs):
        calls[0] += 1
        return apply(matrix, inputs)

    rs_plain._apply = counted
    plain_s, ref = _timed(lambda: _cli_verify(paths, tile, rs_plain))
    got = (res.mismatch, res.bad_tiles, res.culprits, res.unlocalized, res.bytes_per_shard)
    want = (ref.mismatch, ref.bad_tiles, ref.culprits, ref.unlocalized, ref.bytes_per_shard)
    if got != want:
        raise AssertionError(f"cli {what}: the card's verify {got} differs from the plain "
                             f"version's {want}")
    tiles = -(-res.bytes_per_shard // tile)
    if device is None and launches["gf_apply"] + launches["gf_bits"] != calls[0]:
        raise AssertionError(f"cli {what}: {launches['gf_apply']} K1 + {launches['gf_bits']} "
                             f"K5 launches for {calls[0]} codec calls")
    nbytes = 14 * res.bytes_per_shard
    log(f"cli {what} in this process on {card}: {tiles} tiles of {tile >> 20} MiB x 14 "
        f"shards, mismatch per parity row {res.mismatch}, bad tiles {res.bad_tiles}, "
        f"culprits {res.culprits}, unlocalized {res.unlocalized}; equal to K1's plain "
        f"version's run ({plain_s:.3f} s, {calls[0]} codec calls); card {wall:.4f} s "
        f"({nbytes / wall / 1e9:.3f} shard-GB/s), launches {launches} "
        f"({calls[0] - tiles} of them localization hypotheses' decodes and re-encodes)")
    return {"wall_s": wall, "launches": launches, "sigs": _read_sigs(), "tiles": tiles,
            "calls": calls[0], "mismatch": res.mismatch, "culprits": res.culprits,
            "bad_tiles": res.bad_tiles}


def _scraped(master: str, targets: list) -> bool:
    """True once the master's collector has scraped every one of
    `targets` (host:port) and holds each up."""
    with urllib.request.urlopen(f"http://{master}/cluster/health", timeout=10) as r:
        rows = json.loads(r.read()).get("Targets", {})
    return all(rows.get(t, {}).get("Up") for t in targets)


def _alerts(master: str) -> dict:
    with urllib.request.urlopen(f"http://{master}/cluster/alerts", timeout=10) as r:
        return json.loads(r.read())


def _firing(master: str, rule: str, target: str) -> bool:
    return any(a["Alert"] == rule and a["Target"] == target
               for a in _alerts(master)["Firing"])


def _alert_capsule(node: str, rule: str) -> dict:
    """The newest capsule on `node` that an alert of `rule` triggered
    ({} while there is none), read through the node's /capsule/list."""
    with urllib.request.urlopen(f"http://{node}/capsule/list", timeout=10) as r:
        caps = json.loads(r.read())["Capsules"]
    caps = [c for c in caps if c["Trigger"] == "alert" and rule in c["Reason"]]
    return caps[-1] if caps else {}


def _cli_telemetry(shell, holders: list, wait, card: str) -> dict:
    """The telemetry plane's view of the cli phase through the shell
    process: capsule.collect finds each culprit holder's alert capsule,
    and cluster.slo counts samples (TotalSlow) in the scrub and repair
    planes, from the sweeps and the scheduled rebuilds."""
    _, out = shell.run("capsule.collect -reason scrub_corruptions -json")
    rows = {n["Node"]: n for n in json.loads(out.strip().splitlines()[-1])["Nodes"]}
    for node in holders:
        row = rows.get(node) or {}
        if row.get("Trigger") != "alert" or not row.get("Capsule"):
            raise AssertionError(f"cli capsule.collect: no alert capsule on {node}: {rows}")
    planes: dict = {}

    def sampled() -> bool:
        _, text = shell.run("cluster.slo -json")
        snap = json.loads(text.strip().splitlines()[-1])
        planes.update({o["Plane"]: o["TotalSlow"] for o in snap["Objectives"]
                       if o["Kind"] == "latency"})
        return planes.get("scrub", 0) > 0 and planes.get("repair", 0) > 0

    slo_s = wait(sampled, "cluster.slo samples in the scrub and repair planes", 90)
    log(f"cli telemetry on {card}: capsule.collect through the shell finds the alert capsules "
        f"{ {n: rows[n]['Capsule'] for n in holders} }; cluster.slo samples by plane over "
        f"its slow window {planes} ({slo_s:.3f} s to show both planes)")
    return {"capsules": {n: rows[n]["Capsule"] for n in holders}, "slo_samples": planes}


def run_cli_phase(workdir: str, volume_bytes: int, seed: int, device=None, card: str = "",
                  smi: str = "") -> dict:
    """The port started from the command line, on `device` (None: the
    card; "cpu" runs the servers with -ec.codec cpu and this process's
    verifies on K1's plain version, a rehearsal), its integrity plane
    driven as users drive it:
      1. `python -m seaweedfs_tpu_torch master` (-repairInterval 1,
         -repairGrace CLI_REPAIR_GRACE, -telemetryInterval 1) and three
         `volume` servers on two racks, each a process of its own with a
         capsule directory of its own, with no -ec.codec (the card),
         -scrubInterval a day (only scrub.trigger sweeps) and -scrubRate
         0; data in `workdir` (/dev/shm); the master's collector scrapes
         itself and the three servers;
      2. one volume grown through /vol/grow and filled with about
         `volume_bytes` by `python -m seaweedfs_tpu_torch benchmark`
         (-size CLI_FILE_BYTES, -n to fill, -read=false): upstream's
         documented -n 1048576 -size 1024 makes the same 1 GiB of ten
         times the requests;
      3. `python -m seaweedfs_tpu_torch shell`, one process kept open:
         ec.encode -volumeId V (K1 + K4 on the volume's server) and
         ec.balance -force; no server may hold all 14 shards, so every
         sweep takes the parity re-verify, not the .ecc CRC arm;
      4. a data shard and a parity shard on two different servers saved,
         then bytes flipped in one 4 MiB tile of each (CLI_BAD_TILES);
         this process runs the scrub's verify core over the shard files
         on the card and on K1's plain version (_cli_verify_both); then
         scrub.trigger -volumeId V through the shell: each holder's sweep
         re-encodes every tile with K1 and localizes the culprits by
         decodes; each culprit's holder quarantines it (.bad); the
         master's /repair/queue shows the volume, its RepairScheduler
         rebuilds both shards on a server's card (K1 + K4), and
         ec.verify -volumeId V through the shell (K1 in the shell's
         process) reports them clean; after each round the collector's
         scrub_corruptions alert fires for the culprit's holder and the
         master's capsule coordinator leaves a capsule with
         trigger=alert there (_cli_telemetry); cluster.slo counts
         samples in the scrub and repair planes;
      5. the rebuilt shards equal the saved copies and their CRCs the
         .ecc; every needle reads back over HTTP with its payload's
         SHA-256; every volume server's process and the shell's appear
         in nvidia-smi's compute apps and the master's does not; each
         holder's scrub counter of
         scanned EC bytes rose; the verify core once more in this
         process after the repair, clean, one K1 launch a tile; SIGTERM
         ends every process with exit code 0.
    Each volume server's kernel launches are read off its /metrics
    (weed_kernel_launches, the wrappers' counters, 0 when its process
    starts) before and after each step. Raises on any fault; returns
    cli_encode, cli_scrub, cli_repair, cli_verify_before and
    cli_verify_after with walls and launches."""
    import hashlib
    import signal

    from seaweedfs_tpu_torch.ec import ec_files, ecc_sidecar
    from seaweedfs_tpu_torch.pb import master_pb2, rpc
    from seaweedfs_tpu_torch.shell import CommandEnv
    from seaweedfs_tpu_torch.storage.volume import scan_volume_file

    _check_room(workdir, CLI_ROOM if volume_bytes >= 1 << 30 else 3 * volume_bytes + (1 << 28),
                "the cli phase")
    on_card = device is None
    here = os.path.dirname(os.path.abspath(__file__))
    env = {k: v for k, v in os.environ.items() if k != "WEED_EC_CODEC"}
    if not on_card:
        env["WEED_EC_CODEC"] = "cpu"  # the shell's ec.verify on the host codec
    codec_args = [] if on_card else ["-ec.codec", "cpu"]
    cli = [sys.executable, "-m", "seaweedfs_tpu_torch"]
    logs = os.path.join(workdir, "logs")
    os.mkdir(logs)
    procs: dict = {}

    def spawn(name: str, args: list) -> subprocess.Popen:
        # each daemon keeps its incident capsules apart, as on hosts of their own
        penv = dict(env, WEED_CAPSULE_DIR=os.path.join(workdir, "capsules", name))
        procs[name] = subprocess.Popen(cli + args, cwd=here, env=penv,
                                       stdout=open(os.path.join(logs, name + ".log"), "w"),
                                       stderr=subprocess.STDOUT)
        return procs[name]

    def wait(cond, what: str, timeout: float = 120.0) -> float:
        t0 = time.monotonic()
        while True:
            try:
                if cond():
                    return time.monotonic() - t0
            except (OSError, ValueError, KeyError):
                pass
            for name, p in procs.items():
                if p.poll() is not None:
                    raise AssertionError(f"cli: {name} exited ({p.returncode}) while waiting "
                                         f"for {what}: {_tail(name)}")
            if time.monotonic() - t0 > timeout:
                raise AssertionError(f"cli: {what} not seen within {timeout} s")
            time.sleep(0.05)

    def _tail(name: str) -> str:
        with open(os.path.join(logs, name + ".log"), errors="replace") as f:
            return f.read()[-3000:]

    phase_t0 = time.perf_counter()
    mport = _free_port()
    ports = [_free_port() for _ in range(3)]
    dirs = [os.path.join(workdir, f"vs{i}") for i in range(3)]
    master_addr = f"127.0.0.1:{mport}"
    runs: dict = {}
    shell = None
    try:
        t0 = time.perf_counter()
        spawn("master", ["master", "-ip", "127.0.0.1", "-port", str(mport),
                         "-volumeSizeLimitMB", str(CLUSTER_LIMIT_MB), "-repairInterval", "1",
                         "-repairGrace", str(CLI_REPAIR_GRACE), "-telemetryInterval", "1"])
        wait(lambda: urllib.request.urlopen(f"http://{master_addr}/cluster/status",
                                            timeout=2).close() is None, "the master")
        for i, (port, d) in enumerate(zip(ports, dirs)):
            os.mkdir(d)
            spawn(f"volume{i}", ["volume", "-ip", "127.0.0.1", "-port", str(port), "-dir", d,
                                 "-max", "100", "-mserver", master_addr, "-rack", f"rack{i % 2}",
                                 "-scrubInterval", "86400", "-scrubRate", "0"] + codec_args)
        cenv = CommandEnv([master_addr])
        wait(lambda: len(cenv.collect_topology().nodes) == 3, "three volume servers")
        log(f"cli: master and three volume servers up as `python -m seaweedfs_tpu_torch` "
            f"processes (pids {[p.pid for p in procs.values()]}) in "
            f"{time.perf_counter() - t0:.3f} s")
        nodes = [f"127.0.0.1:{p}" for p in ports]
        scraped_s = wait(lambda: _scraped(master_addr, [master_addr] + nodes),
                         "the collector scraping the master and three servers", 60)
        log(f"cli: the master's collector scrapes the master and the three volume servers "
            f"(all up, kinds master and volume) {scraped_s:.3f} s after they registered, on "
            f"{card}")

        # --- 2. fill one volume with the benchmark ---
        with urllib.request.urlopen(f"http://{master_addr}/vol/grow?collection=cli&count=1",
                                    timeout=60) as r:
            if json.loads(r.read()).get("count") != 1:
                raise AssertionError("cli: /vol/grow of the benchmark's volume failed")
        n = max(1, volume_bytes // CLI_FILE_BYTES)
        bench = subprocess.run(cli + ["benchmark", "-master", master_addr, "-c", "16",
                                      "-n", str(n), "-size", str(CLI_FILE_BYTES),
                                      "-collection", "cli", "-replication", "000",
                                      "-read=false"],
                               cwd=here, env=env, capture_output=True, text=True, timeout=900)
        if bench.returncode or "Failed requests:        0" not in bench.stdout:
            raise AssertionError(f"cli benchmark failed (rc {bench.returncode}): "
                                 f"{bench.stdout[-2000:]} {bench.stderr[-2000:]}")
        took = float(re.search(r"Time taken for tests:\s+([0-9.]+)", bench.stdout).group(1))
        moved = int(re.search(r"Total transferred:\s+(\d+)", bench.stdout).group(1))
        dats = [os.path.join(d, f) for d in dirs for f in os.listdir(d)
                if f.startswith("cli_") and f.endswith(".dat")]
        if len(dats) != 1:
            raise AssertionError(f"cli: the benchmark filled {dats}, not one volume")
        vid = int(os.path.basename(dats[0])[4:-4])
        needles = [(nd.id, nd.cookie) for nd, _ in scan_volume_file(dats[0])]
        if len(needles) != n:
            raise AssertionError(f"cli: volume {vid} holds {len(needles)} needles, not {n}")
        import random as _random

        rng = _random.Random(1)  # the benchmark's one payload, as it makes it
        random_payload = bytes(rng.randrange(256) for _ in range(CLI_FILE_BYTES))
        want_sha = hashlib.sha256(random_payload).hexdigest()
        runs["cli_fill"] = {"wall_s": took, "bytes": moved}
        log(f"cli benchmark on {card}: {n} x {CLI_FILE_BYTES} B into volume {vid} in "
            f"{took:.3f} s, {moved / took / 1e9:.4f} GB/s (its own report); {smi}")

        # --- 3. ec.encode and ec.balance through the shell process ---
        shell = _CliShell(cli + ["shell", "-master", master_addr], env,
                          os.path.join(logs, "shell.log"))
        procs["shell"] = shell.proc
        before = [_cli_launches(_cli_metrics(p)) for p in ports]
        enc_s, out = shell.run(f"ec.encode -volumeId {vid}")
        bal_s, _ = shell.run("ec.balance -force")

        def registered() -> dict:
            with rpc.dial(f"127.0.0.1:{mport + 10000}") as ch:
                resp = rpc.master_stub(ch).LookupEcVolume(
                    master_pb2.LookupEcVolumeRequest(volume_id=vid), timeout=10)
            return {e.shard_id: [loc.url for loc in e.locations]
                    for e in resp.shard_id_locations if e.locations}

        wait(lambda: len(registered()) == 14, "14 registered shards", 60)
        after = [_cli_launches(_cli_metrics(p)) for p in ports]
        enc = {k: sum(a[k] - b[k] for a, b in zip(after, before)) for k in after[0]}
        if on_card:
            _must_launch("cli ec.encode", enc, ("gf_apply", "crc32c_rows"))
        runs["cli_encode"] = {"wall_s": enc_s, "launches": enc, "sigs": {}}
        name = f"cli_{vid}"

        def shard_paths() -> dict:
            out = {}
            for d in dirs:
                for sid in range(14):
                    p = os.path.join(d, name + ec_files.to_ext(sid))
                    if os.path.exists(p):
                        if sid in out:
                            raise AssertionError(f"cli: shard {sid} on two servers")
                        out[sid] = p
            return out

        held = {}
        for sid, p in shard_paths().items():
            held.setdefault(os.path.dirname(p), []).append(sid)
        if len(shard_paths()) != 14 or max(len(v) for v in held.values()) >= 14:
            raise AssertionError(f"cli: after ec.balance the shards lie {held}")
        shard_len = os.path.getsize(shard_paths()[0])
        log(f"cli ec.encode -volumeId {vid} through the shell process on {card}: "
            f"{enc_s:.4f} s ({14 * shard_len / enc_s / 1e9:.3f} shard-GB/s), ec.balance "
            f"-force {bal_s:.4f} s; shards per server "
            f"{ {os.path.basename(d): sorted(v) for d, v in held.items()} }; server "
            f"launches {enc}")

        # --- 4. bit rot in a data and a parity shard on two servers ---
        paths = shard_paths()
        # the parity culprit is not shard 10: the data culprit's rebuild
        # decodes from the first ten survivors, data shards and 10
        ds = min(s for s in paths if s < 10)
        ps = min(s for s in paths if s > 10 and os.path.dirname(paths[s])
                 != os.path.dirname(paths[ds]))
        saved = os.path.join(workdir, "saved")
        os.mkdir(saved)
        for sid, tile in zip((ds, ps), CLI_BAD_TILES):
            shutil.copyfile(paths[sid], os.path.join(saved, str(sid)))
            off = tile * CLI_TILE
            if off + CLI_TILE > shard_len:
                raise AssertionError(f"cli: shard {sid} has no tile {tile}")
            with open(paths[sid], "r+b") as f:
                for j in range(0, CLI_TILE, CLI_TILE // 16):
                    f.seek(off + j)
                    b = f.read(1)
                    f.seek(off + j)
                    f.write(bytes([b[0] ^ 0x5A]))
        log(f"cli: 16 bytes flipped in tile {CLI_BAD_TILES[0]} of data shard {ds} "
            f"({os.path.basename(os.path.dirname(paths[ds]))}) and tile {CLI_BAD_TILES[1]} "
            f"of parity shard {ps} ({os.path.basename(os.path.dirname(paths[ps]))})")
        runs["cli_verify_before"] = _cli_verify_both(paths, CLI_TILE, device,
                                                     "verify core before the repair", card)
        if sorted(runs["cli_verify_before"]["culprits"]) != sorted((ds, ps)):
            raise AssertionError(f"cli: the verify core localized "
                                 f"{runs['cli_verify_before']['culprits']}, not {ds} and {ps}")

        before = [_cli_launches(_cli_metrics(p)) for p in ports]
        seen_queue: list = []

        def queue() -> dict:
            with urllib.request.urlopen(f"http://{master_addr}/repair/queue",
                                        timeout=10) as r:
                q = json.loads(r.read())
            if any(t["VolumeId"] == vid for t in q.get("Tasks", [])):
                seen_queue.append(q)
            return q

        def rebuilds() -> int:
            return sum(1 for h in queue().get("History", [])
                       if h["Kind"] == "ec_rebuild" and h["VolumeId"] == vid)

        # One holder at a time, the data culprit's first. A sweep stops its
        # pass over the volume when a shard it reads remotely has been
        # quarantined meanwhile, and it quarantines only its own culprits
        # (remote ones go to the master as a count on the heartbeat), as
        # the reference's does; and the rebuild decodes from the first
        # ten survivors whatever the sweeps reported. Triggered on every
        # holder at once, the holder that finishes its first segment
        # first quarantines its culprit and the others' passes stop; if
        # that is the parity culprit, its rebuild decodes from the
        # corrupt data shard and the volume never heals (ROADMAP Queue 3).
        pending = {ds, ps}
        rounds = []
        scrub = {k: 0 for k in before[0]}
        repair = dict(scrub)
        for rnd, sid in enumerate((ds, ps), 1):
            node = f"127.0.0.1:{ports[dirs.index(os.path.dirname(paths[sid]))]}"
            done0 = rebuilds()
            t_trigger = time.perf_counter()
            shell.run(f"scrub.trigger -volumeId {vid} -node {node}")
            wait(lambda: os.path.exists(paths[sid] + ".bad") and sid not in shard_paths(),
                 f"shard {sid} quarantined", 300)
            t_quarantine = time.perf_counter()
            mid = [_cli_launches(_cli_metrics(p)) for p in ports]

            def rebuilt() -> bool:
                return (rebuilds() > done0 and sid in shard_paths()
                        and len(registered()) == 14)

            wait(rebuilt, f"the RepairScheduler's rebuild of shard {sid}", 300)
            t_rebuilt = time.perf_counter()
            end = [_cli_launches(_cli_metrics(p)) for p in ports]
            for k in scrub:
                scrub[k] += sum(a[k] - b[k] for a, b in zip(mid, before))
                repair[k] += sum(a[k] - b[k] for a, b in zip(end, mid))
            before = end
            # the alert stays firing over the collector's window (120 s), so
            # it is read after the round's timing, not in its way
            fired_s = wait(lambda: _firing(master_addr, "scrub_corruptions", node),
                           f"scrub_corruptions firing for {node}", 60)
            capsule = {}
            wait(lambda: capsule.update(_alert_capsule(node, "scrub_corruptions")) or capsule,
                 f"an alert capsule on {node}", 60)
            rounds.append({"round": rnd, "quarantined": sid, "holder": node,
                           "trigger_to_quarantine_s": t_quarantine - t_trigger,
                           "quarantine_to_rebuilt_s": t_rebuilt - t_quarantine})
            log(f"cli round {rnd} on {card}: /cluster/alerts shows scrub_corruptions firing for "
                f"{node} ({fired_s:.3f} s after the rebuild was seen); its capsule {capsule['Id']} "
                f"(trigger {capsule['Trigger']}, files "
                f"{[(f['Name'], f['Ok']) for f in capsule['Files']]})")
            log(f"cli round {rnd} on {card}: scrub.trigger -volumeId {vid} -node {node} to "
                f"shard {sid} quarantined (.bad) {t_quarantine - t_trigger:.3f} s; quarantine "
                f"to rebuilt and mounted by the master's RepairScheduler "
                f"{t_rebuilt - t_quarantine:.3f} s (a volume repaired within the "
                f"scheduler's 60 s post-success cool-down waits it out)")
            pending.discard(sid)
        if pending:
            raise AssertionError(f"cli: shards {sorted(pending)} never quarantined")
        if not seen_queue:
            raise AssertionError("cli: /repair/queue never showed the damaged volume")
        if on_card:
            _must_launch("cli scrub", scrub, ("gf_apply",))
            _must_launch("cli repair", repair, ("gf_apply", "crc32c_rows"))
        runs["cli_scrub"] = {"wall_s": sum(r["trigger_to_quarantine_s"] for r in rounds),
                             "launches": scrub, "sigs": {}, "rounds": rounds}
        runs["cli_repair"] = {"wall_s": sum(r["quarantine_to_rebuilt_s"] for r in rounds),
                              "launches": repair, "sigs": {}}
        history = [h for h in queue().get("History", []) if h["VolumeId"] == vid]
        log(f"cli scrub and repair on {card}: {len(rounds)} round(s) {rounds}; server "
            f"launches in the sweeps {scrub}, in the rebuilds {repair}; /repair/queue "
            f"showed the volume in {len(seen_queue)} polls; its history {history}")
        runs["cli_telemetry"] = _cli_telemetry(shell, [r["holder"] for r in rounds], wait, card)

        # --- 5. what the phase holds ---
        now = shard_paths()
        sidecar = None
        for d in dirs:
            if os.path.exists(os.path.join(d, name + ".ecc")):
                sidecar = ecc_sidecar.load_sidecar(os.path.join(d, name))["shards"]
                break
        if sidecar is None:
            raise AssertionError("cli: no server holds the volume's .ecc")
        for sid in (ds, ps):
            if not filecmp.cmp(now[sid], os.path.join(saved, str(sid)), shallow=False):
                raise AssertionError(f"cli: rebuilt shard {sid} differs from the saved copy")
            if _file_crc(now[sid]) != sidecar[str(sid)]["crc"]:
                raise AssertionError(f"cli: rebuilt shard {sid}'s CRC differs from the .ecc")
        vfy_s, out = shell.run(f"ec.verify -volumeId {vid}")
        if "verified clean" not in out:
            raise AssertionError(f"cli ec.verify: {out}")
        runs["cli_ec_verify"] = {"wall_s": vfy_s}
        log(f"cli ec.verify -volumeId {vid} through the shell process on {card}: "
            f"{vfy_s:.4f} s, {14 * shard_len / vfy_s / 1e9:.3f} shard-GB/s: "
            f"{out.strip()}")
        # a last sweep of the repaired volume on every holder: each must
        # complete a clean pass, and its scanned-EC-bytes counter rise by
        # at least the whole volume. A pass stopped before the repair
        # resumes at its cursor and completes with the damage it had
        # found, so a holder whose completed pass is not clean is
        # triggered again, as an operator would, for one from offset 0.
        key = 'weed_scrub_scanned_bytes_total{{kind="ec",server="127.0.0.1:{}"}}'

        def status(p) -> dict:
            with urllib.request.urlopen(f"http://127.0.0.1:{p}/scrub/status",
                                        timeout=10) as r:
                st = json.loads(r.read())
            rows = [v for v in st["Volumes"] if v["volume_id"] == vid and v["is_ec"]]
            return {"running": st["SweepRunning"], "done": st["SweepsCompleted"],
                    "row": rows[0] if rows else {}}

        start = [_cli_metrics(p).get(key.format(p), 0) for p in ports]
        sweep0 = [_cli_launches(_cli_metrics(p)) for p in ports]
        passes0 = [status(p)["row"].get("sweeps", 0) for p in ports]
        walls, triggers = {}, {i: 0 for i in range(3)}
        for attempt in range(4):
            need = [i for i in range(3) if i not in walls]
            if not need:
                break
            t0 = time.time()  # the rows stamp a completed pass with the wall clock
            done0 = {i: status(ports[i])["done"] for i in need}
            for i in need:
                shell.run(f"scrub.trigger -volumeId {vid} -node 127.0.0.1:{ports[i]}")
                triggers[i] += 1
            wait(lambda: all(status(ports[i])["done"] > done0[i] for i in need),
                 f"the holders' sweeps (attempt {attempt + 1})", 300)
            for i in need:
                row = status(ports[i])["row"]
                log(f"cli clean-pass attempt {attempt + 1}, volume{i}: pass "
                    f"{row.get('sweeps')}, cursor {row.get('cursor')}, damage "
                    f"{row.get('sweep_corruptions')}, error {row.get('last_error')!r}")
                if row.get("sweeps", 0) > passes0[i]:
                    if not (row["sweep_corruptions"] or row["last_error"]):
                        walls[i] = row["last_sweep_unix"] - t0
                    # else the pass began before the repair (a stopped
                    # pass resumes at its cursor): the next starts at 0
                    passes0[i] = row["sweeps"]
        if len(walls) != 3:
            raise AssertionError(f"cli: holders {sorted(set(range(3)) - set(walls))} never "
                                 f"completed a clean pass of volume {vid}: "
                                 f"{[status(p)['row'] for p in ports]}")
        clean = [_cli_launches(_cli_metrics(p)) for p in ports]
        for i, p in enumerate(ports):
            scanned = _cli_metrics(p).get(key.format(p), 0) - start[i]
            if scanned < 14 * shard_len:
                raise AssertionError(f"cli: volume{i}'s scrub counter of EC bytes rose by "
                                     f"{scanned}, under the volume's {14 * shard_len}")
            k1 = clean[i]["gf_apply"] - sweep0[i]["gf_apply"]
            log(f"cli volume{i} clean pass over volume {vid} on {card}: {walls[i]:.3f} s "
                f"after its last of {triggers[i]} trigger(s), "
                f"{14 * shard_len / walls[i] / 1e9:.3f} shard-GB/s "
                f"({len(held.get(dirs[i], []))} of 14 shards local, the rest over "
                f"VolumeEcShardRead); scanned-EC-bytes counter +{scanned / 1e9:.3f} GB; K1 "
                f"launches {k1}")
            if on_card and k1 < -(-shard_len // CLI_TILE):
                raise AssertionError(f"cli: volume{i}'s clean pass launched K1 {k1} times")
        runs["cli_sweep"] = {"wall_s": max(walls.values()), "sigs": {}, "launches": {
            k: sum(c[k] - b[k] for c, b in zip(clean, sweep0)) for k in clean[0]}}

        # every volume server has launched kernels by now (each swept) and
        # the shell has (ec.verify): each holds a context on the card.
        # nvidia-smi in a container may list every app under its own pid
        # namespace's numbers (all 1 where they run in another pid namespace); then the apps
        # listed must be at least these processes and this one, each of
        # them mapping the CUDA driver
        apps = subprocess.run(["nvidia-smi", "--query-compute-apps=pid,used_memory",
                               "--format=csv,noheader"], capture_output=True, text=True,
                              timeout=60).stdout if on_card else ""
        listed = [line.strip() for line in apps.splitlines() if line.strip()]
        need = {n: p.pid for n, p in procs.items() if n.startswith("volume") or n == "shell"}
        mapped = {}
        for n, pid in need.items():
            with open(f"/proc/{pid}/maps") as f:
                mapped[n] = "libcuda.so" in f.read()
        pids = {int(line.split(",")[0]) for line in listed}
        master_maps = _maps_has(procs["master"].pid, "libcuda", "libtorch")
        log(f"cli nvidia-smi compute apps: {listed}; processes {need}, each mapping "
            f"libcuda.so: {mapped}; the master (pid {procs['master'].pid}) maps "
            f"{master_maps}")
        if procs["master"].pid in pids or master_maps["libcuda"]:
            raise AssertionError(f"cli: the master holds the card: nvidia-smi lists {listed}, "
                                 f"its maps {master_maps}")
        served = [sum(_cli_launches(_cli_metrics(p)).values()) for p in ports]
        if on_card and (not all(served) or not (
                set(need.values()) <= pids
                or (len(listed) >= len(need) + 1 and all(mapped.values())))):
            raise AssertionError(f"cli: nvidia-smi lists {listed} for the processes {need} "
                                 f"(libcuda.so mapped: {mapped}; launches a server "
                                 f"{served})")

        def get(conn, item):
            fid = f"{vid},{item[0]:x}{item[1]:08x}"
            status, _, body = _http(conn, "GET", f"/{fid}")
            if status != 200 or hashlib.sha256(body).hexdigest() != want_sha:
                raise AssertionError(f"cli: GET {fid} answered {status} with another body")

        reader = max(range(3), key=lambda i: len(held.get(dirs[i], [])))
        t0 = time.perf_counter()
        _fan(ports[reader], 8, needles, get)
        get_s = time.perf_counter() - t0
        log(f"cli: every needle ({len(needles)}) read back over HTTP from volume{reader} "
            f"with its payload's SHA-256 in {get_s:.3f} s")
        runs["cli_verify_after"] = _cli_verify_both(now, CLI_TILE, device,
                                                    "verify core after the repair", card)
        after_run = runs["cli_verify_after"]
        if any(after_run["mismatch"]) or (on_card and after_run["launches"]["gf_apply"]
                                          + after_run["launches"]["gf_bits"]
                                          != after_run["tiles"]):
            raise AssertionError(f"cli: after the repair the verify core gave {after_run}")
        rc = shell.exit()
        if rc:
            raise AssertionError(f"cli: the shell exited {rc}")
    finally:
        if shell is not None and shell.proc.poll() is None:
            shell.proc.kill()
        for name, p in procs.items():
            if p.poll() is None:
                p.send_signal(signal.SIGTERM)
        rcs = {}
        for name, p in procs.items():
            try:
                rcs[name] = p.wait(60)
            except subprocess.TimeoutExpired:
                p.kill()
                rcs[name] = p.wait(10)
    left = {n: rc for n, rc in rcs.items() if rc != 0}
    log(f"cli: SIGTERM, exit codes {rcs}; the phase took "
        f"{time.perf_counter() - phase_t0:.1f} s")
    if left:
        raise AssertionError(f"cli: processes exited non-zero {left}: "
                             f"{ {n: _tail(n) for n in left} }")
    return runs


CLI_PATHS = ("cli_encode", "cli_verify_before", "cli_scrub", "cli_repair", "cli_sweep",
             "cli_verify_after")


# --- phase 3h: the serving edge from the command line -----------------------

EDGE_FILES = 16384  # benchmark -n: upstream's documented -n 1048576 cut 64x, for time
EDGE_SIZE = 1024  # benchmark -size, upstream's documented run
EDGE_CONC = 16  # benchmark -c, its default
EDGE_WORKERS = 4  # volume -workers
# (arm, environment, volume flags): the threaded arm is what the
# switches select, the C loop the default, then the C loop with workers
EDGE_ARMS = (
    ("threaded", {"WEED_NATIVE_SERVE": "0", "WEED_NATIVE_POST": "0"}, []),
    ("c_loop", {}, []),
    ("workers", {}, ["-workers", str(EDGE_WORKERS)]),
)


def _edge_port() -> int:
    """A port p below the kernel's ephemeral range with p + 10000 (gRPC)
    free (availability.free_port), odd, and with the -workers internal
    port p + 20000 free too, probed as the servers bind (SO_REUSEADDR).
    Odd, because a busy host's closed client connections (TIME_WAIT) sit
    on even ephemeral ports, where the internal port lands."""
    import socket

    from seaweedfs_tpu_torch.util.availability import free_port

    for _ in range(400):
        p = free_port()
        if p % 2 == 0:
            continue
        try:
            with socket.socket() as s:
                s.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
                s.bind(("127.0.0.1", p + 20000))
        except OSError:
            continue
        return p
    raise RuntimeError("no free port triple for the volume server")


def _listeners(port: int) -> int:
    """TCP sockets listening on `port` (each SO_REUSEPORT sibling one)."""
    with open("/proc/net/tcp") as f:
        rows = [line.split() for line in f.readlines()[1:]]
    return sum(1 for r in rows if r[3] == "0A" and int(r[1].rsplit(":", 1)[1], 16) == port)


def _children(pid: int) -> list:
    """The pids whose parent is `pid`."""
    out = []
    for name in os.listdir("/proc"):
        if name.isdigit():
            try:
                with open(f"/proc/{name}/stat") as f:
                    fields = f.read().rsplit(")", 1)[1].split()
            except OSError:
                continue
            if int(fields[1]) == pid:
                out.append(int(name))
    return sorted(out)


def _cpu_s(pid: int) -> float:
    """A process's CPU seconds (user + system), from /proc."""
    with open(f"/proc/{pid}/stat") as f:
        fields = f.read().rsplit(")", 1)[1].split()
    return (int(fields[11]) + int(fields[12])) / os.sysconf("SC_CLK_TCK")


class _AcceptSampler:
    """Which process holds each connection accepted on `port`: the
    kernel's table of established sockets (/proc/net/tcp) joined with
    each pid's socket fds, sampled every 50 ms on a thread while the
    block runs. `seen` maps pid -> the set of client endpoints."""

    def __init__(self, port: int, pids: list):
        self.port, self.pids = port, pids
        self.seen = {pid: set() for pid in pids}
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._run, daemon=True, name="edge-accepts")

    def _sample(self) -> None:
        with open("/proc/net/tcp") as f:
            rows = [line.split() for line in f.readlines()[1:]]
        by_inode = {r[9]: r[2] for r in rows
                    if r[3] == "01" and int(r[1].rsplit(":", 1)[1], 16) == self.port}
        for pid in self.pids:
            try:
                fds = os.listdir(f"/proc/{pid}/fd")
            except OSError:
                continue
            for fd in fds:
                try:
                    link = os.readlink(f"/proc/{pid}/fd/{fd}")
                except OSError:
                    continue
                if link.startswith("socket:[") and link[8:-1] in by_inode:
                    self.seen[pid].add(by_inode[link[8:-1]])

    def _run(self) -> None:
        while not self._stop.is_set():
            self._sample()
            self._stop.wait(0.05)

    def __enter__(self):
        self._thread.start()
        return self

    def __exit__(self, *exc):
        self._stop.set()
        self._thread.join(10)


def _maps_has(pid: int, *names) -> dict:
    with open(f"/proc/{pid}/maps") as f:
        text = f.read()
    return {n: n in text for n in names}


def _compute_apps() -> list:
    out = subprocess.run(["nvidia-smi", "--query-compute-apps=pid,used_memory",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         timeout=60).stdout
    return [line.strip() for line in out.splitlines() if line.strip()]


def _bench_report(text: str) -> dict:
    """{"write"|"read": {completed, failed, req_s, p50_ms, p99_ms}} off
    the port's `benchmark` report (the reference's stats printer)."""
    out = {}
    for key, title in (("write", "Writing Benchmark"), ("read", "Random Read Benchmark")):
        i = text.find(title)
        if i < 0:
            raise AssertionError(f"edge: the benchmark printed no {title!r} report")
        sec = text[i:].split("\n------------ ", 1)[0]

        def num(pattern):
            return float(re.search(pattern, sec, re.M).group(1))

        out[key] = {"completed": int(num(r"Complete requests:\s+(\d+)")),
                    "failed": int(num(r"Failed requests:\s+(\d+)")),
                    "wall_s": num(r"Time taken for tests:\s+([0-9.]+)"),
                    "req_s": num(r"Requests per second:\s+([0-9.]+)"),
                    "p50_ms": num(r"^\s+50%\s+([0-9.]+) ms"),
                    "p99_ms": num(r"^\s+99%\s+([0-9.]+) ms")}
    return out


def run_edge_phase(workdir: str, seed: int, device=None, card: str = "", smi: str = "",
                   files: int = EDGE_FILES) -> dict:
    """The serving edge as users start it: every process `python -m
    seaweedfs_tpu_torch`, data in `workdir` (/dev/shm). For each arm of
    EDGE_ARMS in turn, over a fresh directory: a master (-telemetryInterval
    0) and one `volume` process on `device` (None: the card; "cpu" runs
    it with -ec.codec cpu, a rehearsal), one volume grown, and the port's
    `benchmark -c EDGE_CONC -n files -size EDGE_SIZE` writing and then
    reading; each arm's write and read req/s, p50 and p99 and the lead's
    ServeStats are printed (the threaded arm must not load the C loop;
    the others must answer GETs from it), and in the workers arm the CPU
    seconds and bytes written of the lead and each worker pid. Then, on
    the workers arm: ec.encode of the volume through a `shell` process,
    shards LOST unmounted and deleted on the server, and every needle
    GET through the shared port, each equal to its payload's SHA-256.
    The workers proxy those reads to the lead, whose decodes run on the
    card: K1 launches rise on the lead's /metrics, the workers map
    neither libcuda nor torch, nvidia-smi lists exactly one more compute
    app than before the arm started, and the lead handed connections off
    to threads. SIGTERM ends every process with exit code 0 (a lead's
    code covers its workers). Raises on any fault; returns edge_<arm>
    rows and edge_ec."""
    import hashlib
    import random as _random
    import signal

    from seaweedfs_tpu_torch.pb import master_pb2, rpc
    from seaweedfs_tpu_torch.pb import volume_pb2 as pb
    from seaweedfs_tpu_torch.storage.volume import scan_volume_file

    on_card = device is None
    here = os.path.dirname(os.path.abspath(__file__))
    switches = ("WEED_EC_CODEC", "WEED_NATIVE_SERVE", "WEED_NATIVE_POST", "WEED_SERVE_CACHE")
    base_env = {k: v for k, v in os.environ.items() if k not in switches}
    if not on_card:
        base_env["WEED_EC_CODEC"] = "cpu"
    codec_args = [] if on_card else ["-ec.codec", "cpu"]
    cli = [sys.executable, "-m", "seaweedfs_tpu_torch"]
    logs = os.path.join(workdir, "logs")
    os.mkdir(logs)
    procs: dict = {}
    rcs: dict = {}

    def _tail(name: str) -> str:
        with open(os.path.join(logs, name + ".log"), errors="replace") as f:
            return f.read()[-3000:]

    def spawn(name: str, args: list, env: dict) -> subprocess.Popen:
        procs[name] = subprocess.Popen(cli + args, cwd=here, env=env,
                                       stdout=open(os.path.join(logs, name + ".log"), "w"),
                                       stderr=subprocess.STDOUT)
        return procs[name]

    def wait(cond, what: str, timeout: float = 120.0) -> float:
        t0 = time.monotonic()
        while True:
            try:
                if cond():
                    return time.monotonic() - t0
            except (OSError, ValueError, KeyError):
                pass
            for name, p in procs.items():
                if name not in rcs and p.poll() is not None:
                    raise AssertionError(f"edge: {name} exited ({p.returncode}) while "
                                         f"waiting for {what}: {_tail(name)}")
            if time.monotonic() - t0 > timeout:
                raise AssertionError(f"edge: {what} not seen within {timeout} s")
            time.sleep(0.05)

    def stop(names) -> None:
        """SIGTERM, then every exit code must be 0."""
        for n in names:
            if procs[n].poll() is None:
                procs[n].send_signal(signal.SIGTERM)
        for n in names:
            try:
                rcs[n] = procs[n].wait(120)
            except subprocess.TimeoutExpired:
                procs[n].kill()
                rcs[n] = procs[n].wait(10)
        bad = {n: rcs[n] for n in names if rcs[n] != 0}
        if bad:
            raise AssertionError(f"edge: processes exited non-zero {bad}: "
                                 f"{ {n: _tail(n) for n in bad} }")

    rng = _random.Random(1)  # the benchmark's one payload, as it makes it
    want_sha = hashlib.sha256(bytes(rng.randrange(256) for _ in range(EDGE_SIZE))).hexdigest()
    phase_t0 = time.perf_counter()
    runs: dict = {}
    shell = None
    try:
        for arm, arm_env, arm_args in EDGE_ARMS:
            env = dict(base_env, **arm_env)
            d = os.path.join(workdir, arm)
            os.mkdir(d)
            mport, vport = _edge_port(), _edge_port()
            maddr = f"127.0.0.1:{mport}"
            apps0 = _compute_apps() if on_card else []
            t0 = time.perf_counter()
            spawn(f"{arm}-master", ["master", "-ip", "127.0.0.1", "-port", str(mport),
                                    "-telemetryInterval", "0"], env)
            wait(lambda: urllib.request.urlopen(f"http://{maddr}/cluster/status",
                                                timeout=2).close() is None, "the master")
            lead = spawn(f"{arm}-volume", ["volume", "-ip", "127.0.0.1", "-port", str(vport),
                                           "-dir", d, "-max", "8", "-mserver", maddr,
                                           "-scrubInterval", "0"] + codec_args + arm_args, env)

            def grown() -> bool:
                with urllib.request.urlopen(
                        f"http://{maddr}/vol/grow?collection=edge&count=1", timeout=60) as r:
                    return json.loads(r.read()).get("count") == 1

            wait(grown, "the benchmark's volume grown on the volume server")
            group = [lead.pid]
            if arm_args:
                wait(lambda: _listeners(vport) == EDGE_WORKERS,
                     f"{EDGE_WORKERS} listeners on the shared port")
                group += _children(lead.pid)
                if len(group) != EDGE_WORKERS:
                    raise AssertionError(f"edge: the lead runs {group[1:]} as workers")
            up_s = time.perf_counter() - t0
            st0 = _serve_stats(vport)
            cpu0 = {pid: _cpu_s(pid) for pid in group}
            with _AcceptSampler(vport, group) as accepts:
                bench = subprocess.run(cli + ["benchmark", "-master", maddr, "-c",
                                              str(EDGE_CONC), "-n", str(files), "-size",
                                              str(EDGE_SIZE), "-collection", "edge"],
                                       cwd=here, env=env, capture_output=True, text=True,
                                       timeout=900)
            cpu1 = {pid: _cpu_s(pid) for pid in group}
            st1 = _serve_stats(vport)
            if bench.returncode:
                raise AssertionError(f"edge {arm}: the benchmark failed (rc "
                                     f"{bench.returncode}): {bench.stderr[-2000:]}")
            rep = _bench_report(bench.stdout)
            if rep["write"]["failed"] or rep["read"]["failed"] or (
                    rep["write"]["completed"] != files or rep["read"]["completed"] != files):
                raise AssertionError(f"edge {arm}: the benchmark reported {rep}")
            delta = _stats_delta(st0, st1) if st1 else {}
            if arm == "threaded" and (st0 or st1):
                raise AssertionError(f"edge threaded arm: the C loop ran ({st0} -> {st1})")
            # alone, the lead answers most reads from C; with workers, its
            # SO_REUSEPORT share (each worker's loop counts in its own process)
            if arm != "threaded" and delta["served"] < (1 if arm_args else files // 2):
                raise AssertionError(f"edge {arm}: the C loop answered {delta} of {files} "
                                     f"GETs from C")
            spread = {pid: {"cpu_s": cpu1[pid] - cpu0[pid],
                            "connections": len(accepts.seen[pid])} for pid in group}
            runs[f"edge_{arm}"] = {"bench": rep, "serve_stats": delta, "spread": spread,
                                   "up_s": up_s}
            log(f"edge {arm} on {card}: {files} x {EDGE_SIZE} B, -c {EDGE_CONC}; servers up "
                f"in {up_s:.3f} s; write {rep['write']['req_s']:.2f} req/s, p50 "
                f"{rep['write']['p50_ms']:.1f} ms, p99 {rep['write']['p99_ms']:.1f} ms; read "
                f"{rep['read']['req_s']:.2f} req/s, p50 {rep['read']['p50_ms']:.1f} ms, p99 "
                f"{rep['read']['p99_ms']:.1f} ms (the benchmark's own report); lead ServeStats "
                f"before {st0}, after {st1}; {smi}")
            if arm_args:
                total = sum(u["cpu_s"] for u in spread.values()) or 1.0
                log(f"edge {arm}: spread over the benchmark, by pid (lead first): "
                    + "; ".join(f"{pid} accepted {u['connections']} connection(s), cpu "
                                f"{u['cpu_s']:.2f} s ({u['cpu_s'] / total:.0%})"
                                for pid, u in spread.items()))
            if arm != "workers":
                stop([f"{arm}-volume", f"{arm}-master"])
                continue

            # --- the workers arm: EC reads proxied to the lead, decoded on the card ---
            dats = [f for f in os.listdir(d) if f.startswith("edge_") and f.endswith(".dat")]
            if len(dats) != 1:
                raise AssertionError(f"edge: the benchmark filled {dats}, not one volume")
            vid = int(dats[0][5:-4])
            needles = [(nd.id, nd.cookie) for nd, _ in scan_volume_file(os.path.join(d, dats[0]))]
            if len(needles) != files:
                raise AssertionError(f"edge: volume {vid} holds {len(needles)} needles")
            shell = _CliShell(cli + ["shell", "-master", maddr], env,
                              os.path.join(logs, "shell.log"))
            procs["shell"] = shell.proc
            enc_s, _ = shell.run(f"ec.encode -volumeId {vid}")

            def registered() -> int:
                with rpc.dial(f"127.0.0.1:{mport + 10000}") as ch:
                    resp = rpc.master_stub(ch).LookupEcVolume(
                        master_pb2.LookupEcVolumeRequest(volume_id=vid), timeout=10)
                return sum(1 for e in resp.shard_id_locations if e.locations)

            wait(lambda: registered() == 14, "14 registered shards", 60)
            rcs["shell"] = shell.exit()
            if rcs["shell"]:
                raise AssertionError(f"edge: the shell exited {rcs['shell']}")
            with rpc.dial(f"127.0.0.1:{vport + 10000}") as ch:
                rpc.volume_stub(ch).VolumeEcShardsUnmount(pb.VolumeEcShardsUnmountRequest(
                    volume_id=vid, shard_ids=list(LOST)), timeout=60)
            for i in LOST:
                os.remove(os.path.join(d, f"edge_{vid}.ec{i:02d}"))
            k0 = _cli_launches(_cli_metrics(vport))
            st0 = _serve_stats(vport)
            cpu0 = {pid: _cpu_s(pid) for pid in group}

            def get(conn, item):
                fid = f"{vid},{item[0]:x}{item[1]:08x}"
                status, _, body = _http(conn, "GET", f"/{fid}")
                if status != 200 or hashlib.sha256(body).hexdigest() != want_sha:
                    raise AssertionError(f"edge: GET {fid} answered {status} with another "
                                         f"body")

            t0 = time.perf_counter()
            with _AcceptSampler(vport, group) as accepts:
                _fan(vport, 2 * EDGE_WORKERS, needles, get)
            get_s = time.perf_counter() - t0
            cpu1 = {pid: _cpu_s(pid) for pid in group}
            k1 = _cli_launches(_cli_metrics(vport))
            st1 = _serve_stats(vport)
            launches = {k: k1[k] - k0[k] for k in k1}
            delta = _stats_delta(st0, st1)
            apps1 = _compute_apps() if on_card else []
            maps = {pid: _maps_has(pid, "libcuda", "libtorch") for pid in group}
            log(f"edge EC GETs on {card}: ec.encode -volumeId {vid} through the shell "
                f"{enc_s:.3f} s; shards {LOST} unmounted and deleted; {len(needles)} needles "
                f"GET through the shared port from {2 * EDGE_WORKERS} keep-alive connections, "
                f"each equal to its payload's SHA-256, in {get_s:.3f} s "
                f"({len(needles) / get_s:.1f} req/s); the lead's launches {launches}, its "
                f"ServeStats {st0} -> {st1}; connections accepted and CPU seconds by pid "
                f"(lead first) { {p: (len(accepts.seen[p]), round(cpu1[p] - cpu0[p], 2)) for p in group} }; "
                f"libcuda/libtorch mapped by pid {maps}; nvidia-smi compute apps before the "
                f"arm {apps0}, now {apps1}")
            if any(any(m.values()) for pid, m in maps.items() if pid != lead.pid):
                raise AssertionError(f"edge: a worker process maps the card's libraries {maps}")
            if not delta["handoffs"]:
                raise AssertionError(f"edge: the lead handed no connection off ({delta})")
            if on_card:
                _must_launch("edge EC GETs", launches, ("gf_apply",))
                if len(apps1) != len(apps0) + 1:
                    raise AssertionError(f"edge: nvidia-smi lists {apps1} after the EC GETs, "
                                         f"{apps0} before the serving group started")
            runs["edge_ec"] = {"wall_s": get_s, "launches": launches, "sigs": {},
                               "encode_s": enc_s, "serve_stats": delta,
                               "needles": len(needles)}
            stop([f"{arm}-volume", f"{arm}-master"])
    finally:
        if shell is not None and shell.proc.poll() is None:
            shell.proc.kill()
        for name, p in procs.items():
            if p.poll() is None:
                p.send_signal(signal.SIGTERM)
        for name, p in procs.items():
            if name not in rcs:
                try:
                    rcs[name] = p.wait(60)
                except subprocess.TimeoutExpired:
                    p.kill()
                    rcs[name] = p.wait(10)
    arms = [runs[f"edge_{a}"]["bench"] for a, _, _ in EDGE_ARMS]
    log(f"edge arms side by side on {card} (threaded / C loop / C loop with {EDGE_WORKERS} "
        f"workers): write req/s " + " / ".join(f"{a['write']['req_s']:.2f}" for a in arms)
        + "; write p50/p99 ms " + " / ".join(f"{a['write']['p50_ms']:.1f}/"
                                             f"{a['write']['p99_ms']:.1f}" for a in arms)
        + "; read req/s " + " / ".join(f"{a['read']['req_s']:.2f}" for a in arms)
        + "; read p50/p99 ms " + " / ".join(f"{a['read']['p50_ms']:.1f}/"
                                            f"{a['read']['p99_ms']:.1f}" for a in arms)
        + f"; SIGTERM exit codes {rcs}; the phase took "
        f"{time.perf_counter() - phase_t0:.1f} s")
    return runs


# --- phase 3i: the cluster telemetry plane -----------------------------------

TELE_ROOM = 2 << 30  # the telemetry phase's peak in its directory (about 0.9 GiB)
TELE_INTERVAL = 1  # the master's -telemetryInterval
TELE_LOAD_S = 10.0  # each weedload run's -duration
TELE_READERS = 4  # the degraded run's reader processes


def _tsdb_gets(window: dict, t0: float, t1: float) -> dict:
    """{target: GET requests it served from its last scrape at or before
    t0 to its first at or after t1} off a capsule's tsdb section (the
    master's ring TSDB): positive adjacent deltas of its
    weed_http_request_total{method="GET"} series, as the ring's own
    increase() counts them."""
    out = {}
    for url, series in window["Targets"].items():
        total = 0.0
        for key, pts in series.items():
            if not key.startswith("weed_http_request_total{") or 'method="GET"' not in key:
                continue
            lo = max([i for i, (t, _) in enumerate(pts) if t <= t0] or [0])
            hi = min([i for i, (t, _) in enumerate(pts) if t >= t1] or [len(pts) - 1])
            pts = pts[lo:hi + 1]
            total += sum(max(0.0, b[1] - a[1]) for a, b in zip(pts, pts[1:]))
        out[url] = total
    return out


def run_telemetry_phase(workdir: str, volume_bytes: int, seed: int, device=None,
                        card: str = "", smi: str = "") -> dict:
    """The cluster telemetry plane watching a cluster that serves degraded
    GETs on the card, every process `python -m seaweedfs_tpu_torch`, data
    in `workdir` (/dev/shm), on `device` (None: the card; "cpu" runs the
    servers with -ec.codec cpu, a rehearsal):
      1. a master (-telemetryInterval TELE_INTERVAL, -repairInterval 0:
         nothing rebuilds behind the load) and three `volume` servers,
         each with a capsule directory of its own; the collector scrapes
         all four;
      2. one volume filled with about `volume_bytes` of 1 MiB files by
         `benchmark`; ec.encode and ec.balance -force through a `shell`
         process, so that no server holds all 14 shards;
      3. `weedload -duration TELE_LOAD_S -writers 2 -readers 2 -size
         1024` against the healthy cluster: its put and get p50, p99,
         p99.9 and req/s; its exit code 0; its worker processes map
         neither libcuda nor torch;
      4. the holder of the most shards but one SIGKILLed; then
         weedload.run_load(readers=TELE_READERS, verify_bytes=1 MiB) on
         every needle with bytes on its shards, routed to the surviving
         holder of the most shards: every GET reconstructs there, on the
         card (its K1 launches rise on its /metrics), errors 0, and every
         needle reads back afterwards with its payload's SHA-256;
         meanwhile scrape_staleness fires for the killed holder within
         stale_after plus two cycles and the master captures a capsule
         with trigger=alert holding its tsdb and cluster sections;
         capsule.capture through the shell captures one on every live
         server; no run_load worker maps libcuda or torch;
      5. the holder restarted on its directory: the alert resolves;
         /cluster/top lists the surviving servers in order of req/s and
         the master's TSDB window (a capsule's tsdb section) ranks the
         serving holder first by the GETs of the degraded run;
      6. the master maps no card library; SIGTERM ends every process
         with exit code 0 (the killed holder aside).
    Raises on any fault; returns tele_degraded with the serving holder's
    launches, and the phase's walls and latencies."""
    import hashlib
    import multiprocessing
    import random as _random
    import signal

    from seaweedfs_tpu_torch.ec import locate
    from seaweedfs_tpu_torch.pb import master_pb2, rpc
    from seaweedfs_tpu_torch.shell import CommandEnv
    from seaweedfs_tpu_torch.storage.volume import scan_volume_file
    from seaweedfs_tpu_torch.telemetry import weedload

    _check_room(workdir, TELE_ROOM if volume_bytes >= 1 << 28 else 4 * volume_bytes + (1 << 27),
                "the telemetry phase")
    on_card = device is None
    here = os.path.dirname(os.path.abspath(__file__))
    env = {k: v for k, v in os.environ.items() if k != "WEED_EC_CODEC"}
    if not on_card:
        env["WEED_EC_CODEC"] = "cpu"
    codec_args = [] if on_card else ["-ec.codec", "cpu"]
    cli = [sys.executable, "-m", "seaweedfs_tpu_torch"]
    logs = os.path.join(workdir, "logs")
    os.mkdir(logs)
    procs: dict = {}
    rcs: dict = {}

    def _tail(name: str) -> str:
        with open(os.path.join(logs, name + ".log"), errors="replace") as f:
            return f.read()[-3000:]

    def spawn(name: str, args: list, node: str) -> subprocess.Popen:
        penv = dict(env, WEED_CAPSULE_DIR=os.path.join(workdir, "capsules", node))
        procs[name] = subprocess.Popen(cli + args, cwd=here, env=penv,
                                       stdout=open(os.path.join(logs, name + ".log"), "w"),
                                       stderr=subprocess.STDOUT)
        return procs[name]

    def wait(cond, what: str, timeout: float = 120.0) -> float:
        t0 = time.monotonic()
        while True:
            try:
                if cond():
                    return time.monotonic() - t0
            except (OSError, ValueError, KeyError):
                pass
            for name, p in procs.items():
                if name not in rcs and p.poll() is not None:
                    raise AssertionError(f"telemetry: {name} exited ({p.returncode}) while "
                                         f"waiting for {what}: {_tail(name)}")
            if time.monotonic() - t0 > timeout:
                raise AssertionError(f"telemetry: {what} not seen within {timeout} s")
            time.sleep(0.05)

    def worker_maps(pids) -> dict:
        out = {}
        for pid in pids:
            try:
                out[pid] = _maps_has(pid, "libcuda", "libtorch")
            except OSError:
                continue
        return out

    phase_t0 = time.perf_counter()
    walls: dict = {}
    runs: dict = {}
    shell = None
    victim = None
    # below the ephemeral range, so that the killed holder's port is
    # still free for its restart
    from seaweedfs_tpu_torch.util.availability import free_port

    mport = free_port()
    ports = [free_port() for _ in range(3)]
    dirs = [os.path.join(workdir, f"vs{i}") for i in range(3)]
    maddr = f"127.0.0.1:{mport}"
    nodes = [f"127.0.0.1:{p}" for p in ports]

    def volume_args(i: int) -> list:
        return ["volume", "-ip", "127.0.0.1", "-port", str(ports[i]), "-dir", dirs[i],
                "-max", "100", "-mserver", maddr, "-rack", f"rack{i % 2}",
                "-scrubInterval", "0"] + codec_args

    try:
        # --- 1. the cluster, its collector on ---
        t0 = time.perf_counter()
        spawn("master", ["master", "-ip", "127.0.0.1", "-port", str(mport),
                         "-volumeSizeLimitMB", str(CLUSTER_LIMIT_MB), "-repairInterval", "0",
                         "-telemetryInterval", str(TELE_INTERVAL)], "master")
        wait(lambda: urllib.request.urlopen(f"http://{maddr}/cluster/status",
                                            timeout=2).close() is None, "the master")
        for i, d in enumerate(dirs):
            os.mkdir(d)
            spawn(f"volume{i}", volume_args(i), f"volume{i}")
        cenv = CommandEnv([maddr])
        wait(lambda: len(cenv.collect_topology().nodes) == 3, "three volume servers")
        wait(lambda: _scraped(maddr, [maddr] + nodes), "the collector scraping all four", 60)
        with urllib.request.urlopen(f"http://{maddr}/cluster/health", timeout=10) as r:
            health = json.loads(r.read())
        stale_after, interval = health["StaleAfterSeconds"], health["IntervalSeconds"]
        walls["up"] = time.perf_counter() - t0
        log(f"telemetry: master (-telemetryInterval {TELE_INTERVAL}, stale_after "
            f"{stale_after} s, window {health['WindowSeconds']} s) and three volume servers "
            f"up and scraped in {walls['up']:.3f} s on {card}")

        # --- 2. fill, encode, spread ---
        t0 = time.perf_counter()
        with urllib.request.urlopen(f"http://{maddr}/vol/grow?collection=tele&count=1",
                                    timeout=60) as r:
            if json.loads(r.read()).get("count") != 1:
                raise AssertionError("telemetry: /vol/grow of the benchmark's volume failed")
        n = max(1, volume_bytes // CLI_FILE_BYTES)
        bench = subprocess.run(cli + ["benchmark", "-master", maddr, "-c", "16", "-n", str(n),
                                      "-size", str(CLI_FILE_BYTES), "-collection", "tele",
                                      "-replication", "000", "-read=false"],
                               cwd=here, env=env, capture_output=True, text=True, timeout=900)
        if bench.returncode or "Failed requests:        0" not in bench.stdout:
            raise AssertionError(f"telemetry benchmark failed (rc {bench.returncode}): "
                                 f"{bench.stdout[-2000:]} {bench.stderr[-2000:]}")
        dats = [os.path.join(d, f) for d in dirs for f in os.listdir(d)
                if f.startswith("tele_") and f.endswith(".dat")]
        if len(dats) != 1:
            raise AssertionError(f"telemetry: the benchmark filled {dats}, not one volume")
        vid = int(os.path.basename(dats[0])[5:-4])
        dat_size = os.path.getsize(dats[0])
        needles = [(nd.id, nd.cookie, off, nd.size) for nd, off in scan_volume_file(dats[0])]
        if len(needles) != n:
            raise AssertionError(f"telemetry: volume {vid} holds {len(needles)} needles")
        walls["fill"] = time.perf_counter() - t0
        shell = _CliShell(cli + ["shell", "-master", maddr], env,
                          os.path.join(logs, "shell.log"))
        procs["shell"] = shell.proc
        t0 = time.perf_counter()
        shell.run(f"ec.encode -volumeId {vid}")
        shell.run("ec.balance -force")

        def registered() -> dict:
            with rpc.dial(f"127.0.0.1:{mport + 10000}") as ch:
                resp = rpc.master_stub(ch).LookupEcVolume(
                    master_pb2.LookupEcVolumeRequest(volume_id=vid), timeout=10)
            return {e.shard_id: [loc.url for loc in e.locations]
                    for e in resp.shard_id_locations if e.locations}

        wait(lambda: len(registered()) == 14, "14 registered shards", 60)
        held = {i: sorted(int(f[-2:]) for f in os.listdir(d)
                          if f.startswith(f"tele_{vid}.ec") and f[-2:].isdigit())
                for i, d in enumerate(dirs)}
        if sorted(s for v in held.values() for s in v) != list(range(14)) or max(
                len(v) for v in held.values()) >= 14:
            raise AssertionError(f"telemetry: after ec.balance the shards lie {held}")
        walls["encode_balance"] = time.perf_counter() - t0
        log(f"telemetry: {n} x {CLI_FILE_BYTES} B into volume {vid} by the benchmark in "
            f"{walls['fill']:.3f} s; ec.encode and ec.balance -force through the shell "
            f"{walls['encode_balance']:.3f} s; shards by server {held}; {smi}")

        # --- 3. weedload against the healthy cluster ---
        t0 = time.perf_counter()
        wl = subprocess.Popen(cli + ["weedload", "-master", maddr, "-duration",
                                     str(int(TELE_LOAD_S)), "-writers", "2", "-readers", "2",
                                     "-size", "1024"], cwd=here, env=env,
                              stdout=subprocess.PIPE, stderr=open(
                                  os.path.join(logs, "weedload.log"), "w"), text=True)
        healthy_maps: dict = {}
        while wl.poll() is None:
            healthy_maps.update(worker_maps(_children(wl.pid)))
            time.sleep(0.2)
        out, _ = wl.communicate(timeout=60)
        walls["weedload_healthy"] = time.perf_counter() - t0
        if wl.returncode:
            raise AssertionError(f"telemetry: weedload exited {wl.returncode}: "
                                 f"{out[-2000:]} {_tail('weedload')}")
        healthy = json.loads(out)
        for mode in ("put", "get"):
            if healthy[mode]["errors"] or not healthy[mode]["ops"]:
                raise AssertionError(f"telemetry: healthy weedload {mode}: {healthy[mode]}")
        if not healthy_maps or any(any(m.values()) for m in healthy_maps.values()):
            raise AssertionError(f"telemetry: weedload's workers map {healthy_maps}")
        log(f"telemetry weedload, healthy cluster, on {card}: -duration {TELE_LOAD_S:g} "
            f"-writers 2 -readers 2 -size 1024: " + "; ".join(
                f"{m} {healthy[m]['req_per_sec']} req/s, p50 {healthy[m]['p50_ms']} ms, p99 "
                f"{healthy[m]['p99_ms']} ms, p99.9 {healthy[m]['p999_ms']} ms ({healthy[m]['ops']}"
                f" ops, {healthy[m]['errors']} errors)" for m in ("put", "get"))
            + f"; {len(healthy_maps)} worker processes, libcuda/libtorch mapped "
            f"{healthy_maps}; wall {walls['weedload_healthy']:.3f} s; {smi}")

        # --- 4. a holder killed, degraded GETs on a survivor's card ---
        # two collector cycles first, so that the TSDB's samples around
        # the kill hold none of the healthy run's requests
        def cycles() -> tuple:
            with urllib.request.urlopen(f"http://{maddr}/cluster/health", timeout=10) as r:
                h = json.loads(r.read())
            return h["Cycles"], h["LastCycleUnix"]

        c0 = cycles()[0]
        wait(lambda: cycles()[0] >= c0 + 2, "two collector cycles after the healthy run", 30)
        order = sorted(held, key=lambda i: -len(held[i]))
        serving, victim = order[0], order[1]
        lost = set(held[victim])
        serve_node, victim_node = nodes[serving], nodes[victim]
        rng = _random.Random(1)  # the benchmark's one payload, as it makes it
        want_sha = hashlib.sha256(bytes(rng.randrange(256)
                                        for _ in range(CLI_FILE_BYTES))).hexdigest()
        keys = []
        for nid, cookie, off, size in needles:
            shards = {iv.to_shard_id_and_offset()[0] for iv in locate.locate_data(
                locate.LARGE_BLOCK_SIZE, locate.SMALL_BLOCK_SIZE, dat_size, off,
                16 + size + 4 + 8)}
            if shards & lost:
                keys.append((f"{vid},{nid:x}{cookie:08x}", serve_node))
        if not keys:
            raise AssertionError(f"telemetry: no needle has bytes on shards {sorted(lost)}")
        k0 = _cli_launches(_cli_metrics(ports[serving]))
        events: dict = {}
        load_maps: dict = {}
        stop_poll = threading.Event()

        def poll() -> None:
            while not stop_poll.is_set():
                try:
                    if "fired" not in events and _firing(maddr, "scrape_staleness",
                                                         victim_node):
                        events["fired"] = time.perf_counter()
                except (OSError, ValueError):
                    pass
                load_maps.update(worker_maps(
                    [p.pid for p in multiprocessing.active_children()]))
                stop_poll.wait(0.05)

        poller = threading.Thread(target=poll, daemon=True, name="tele-poll")
        poller.start()
        at_kill = cycles()
        procs[f"volume{victim}"].send_signal(signal.SIGKILL)
        t_kill = time.perf_counter()
        t_kill_unix = time.time()
        rcs[f"volume{victim}"] = procs[f"volume{victim}"].wait(30)
        try:
            degraded = weedload.run_load(maddr, duration_s=TELE_LOAD_S, writers=0,
                                         readers=TELE_READERS, keys=keys,
                                         verify_bytes=CLI_FILE_BYTES)
            t_load_unix = time.time()
            walls["weedload_degraded"] = time.perf_counter() - t_kill
            wait(lambda: "fired" in events, "scrape_staleness firing for the killed holder",
                 60)
        finally:
            stop_poll.set()
            poller.join(10)
        k1 = _cli_launches(_cli_metrics(ports[serving]))
        launches = {k: k1[k] - k0[k] for k in k1}
        row = degraded["get"]
        if row["errors"] or not row["ops"]:
            raise AssertionError(f"telemetry: degraded weedload {row}")
        if on_card:
            _must_launch("telemetry degraded GETs", launches, ("gf_apply",))
        if not load_maps or any(any(m.values()) for m in load_maps.values()):
            raise AssertionError(f"telemetry: run_load's workers map {load_maps}")
        fire_s = events["fired"] - t_kill
        # a cycle as the collector ran them meanwhile: -telemetryInterval
        # apart, or longer where a wave of scrapes outlasted it
        now_cycles = cycles()
        cycle_s = max(interval, (now_cycles[1] - at_kill[1]) / max(1, now_cycles[0] - at_kill[0]))
        if fire_s > stale_after + 2 * cycle_s:
            raise AssertionError(f"telemetry: scrape_staleness fired {fire_s:.3f} s after the "
                                 f"kill, past stale_after {stale_after} s + two cycles of "
                                 f"{cycle_s:.3f} s")
        capsule = {}
        wait(lambda: capsule.update(_alert_capsule(maddr, "scrape_staleness")) or capsule,
             "the master's alert capsule", 60)
        sections = {f["Name"]: f["Ok"] for f in capsule["Files"]}
        if not (sections.get("tsdb.json") and sections.get("cluster.json")):
            raise AssertionError(f"telemetry: the master's capsule holds {sections}")
        _, text = shell.run("capsule.capture -reason degraded")
        live = [nodes[i] for i in range(3) if i != victim]
        for node in live:
            with urllib.request.urlopen(f"http://{node}/capsule/list", timeout=10) as r:
                mine = [c for c in json.loads(r.read())["Capsules"] if c["Reason"] == "degraded"]
            if not mine or mine[-1]["Node"] != node:
                raise AssertionError(f"telemetry: no capsule on {node}: {text}")

        def get(conn, item):
            status, _, body = _http(conn, "GET", f"/{item[0]}")
            if status != 200 or hashlib.sha256(body).hexdigest() != want_sha:
                raise AssertionError(f"telemetry: GET {item[0]} answered {status} with "
                                     f"another body")

        t0 = time.perf_counter()
        _fan(ports[serving], 8, keys, get)
        sha_s = time.perf_counter() - t0
        runs["tele_degraded"] = {"wall_s": walls["weedload_degraded"], "launches": launches,
                                 "sigs": {}, "report": row, "keys": len(keys)}
        log(f"telemetry degraded GETs on {card}: volume{victim} ({victim_node}, shards "
            f"{sorted(lost)}) SIGKILLed; run_load(readers={TELE_READERS}, verify_bytes="
            f"{CLI_FILE_BYTES}) over the {len(keys)} needles with bytes on them, routed to "
            f"volume{serving} ({serve_node}, shards {held[serving]}): {row['req_per_sec']} "
            f"req/s, p50 {row['p50_ms']} ms, p99 {row['p99_ms']} ms, p99.9 {row['p999_ms']} ms "
            f"({row['ops']} ops, {row['errors']} errors, {row['mb_per_sec']} MB/s); the serving "
            f"holder's launches {launches}; every needle then read back with its payload's "
            f"SHA-256 in {sha_s:.3f} s; scrape_staleness fired {fire_s:.3f} s after the kill "
            f"(stale_after {stale_after} s, cycles {cycle_s:.3f} s apart); the master's alert capsule "
            f"{capsule['Id']} sections {sections}; capsule.capture on every live server; "
            f"run_load workers' libcuda/libtorch {load_maps}; {smi}")

        # --- 5. the holder back: the alert resolves; the ranking ---
        t0 = time.perf_counter()
        spawn(f"volume{victim}-restarted", volume_args(victim), f"volume{victim}")

        def resolved() -> bool:
            return (not _firing(maddr, "scrape_staleness", victim_node)
                    and _scraped(maddr, [victim_node]))

        wait(resolved, "scrape_staleness resolved after the restart", 120)
        resolve_s = time.perf_counter() - t0
        history = [a for a in _alerts(maddr)["History"]
                   if a["Alert"] == "scrape_staleness" and a["Target"] == victim_node]
        if not history:
            raise AssertionError("telemetry: the resolved alert is not in the history")
        with urllib.request.urlopen(f"http://{maddr}/cluster/top?n=10", timeout=10) as r:
            top = json.loads(r.read())
        rates = [r["ReqPerSec"] for r in top["Nodes"]]
        listed = [r["Url"] for r in top["Nodes"]]
        if rates != sorted(rates, reverse=True) or not set(live) <= set(listed):
            raise AssertionError(f"telemetry: /cluster/top lists {top['Nodes']}")
        _, text = shell.run(f"capsule.capture -node {maddr} -reason ranking")
        with urllib.request.urlopen(f"http://{maddr}/capsule/list", timeout=10) as r:
            cap = [c for c in json.loads(r.read())["Capsules"] if c["Reason"] == "ranking"][-1]
        with urllib.request.urlopen(f"http://{maddr}/capsule/get?id={cap['Id']}&file=tsdb.json",
                                    timeout=30) as r:
            gets = _tsdb_gets(json.loads(r.read()), t_kill_unix, t_load_unix)
        ranked = sorted(live, key=lambda u: -gets.get(u, 0.0))
        if ranked[0] != serve_node or gets.get(serve_node, 0.0) < row["ops"]:
            raise AssertionError(f"telemetry: the TSDB counts GETs {gets} over the degraded "
                                 f"run ({row['ops']} ops to {serve_node})")
        walls["restart_resolve"] = resolve_s
        runs["tele"] = {"walls": walls, "healthy": {m: healthy[m] for m in ("put", "get")},
                        "degraded": row, "fire_s": fire_s, "resolve_s": resolve_s,
                        "stale_after": stale_after, "cycle_s": cycle_s}
        log(f"telemetry on {card}: volume{victim} restarted on its directory; "
            f"scrape_staleness resolved {resolve_s:.3f} s after the restart began; /cluster/top "
            f"{[(r['Url'], r['Kind'], r['ReqPerSec'], r['P99Ms']) for r in top['Nodes']]} (req/s "
            f"over its {health['WindowSeconds']} s window, the healthy run inside it); GETs "
            f"over the degraded run in the master's TSDB by target "
            f"{ {u: round(v) for u, v in gets.items()} }")
        maps = _maps_has(procs["master"].pid, "libcuda", "libtorch")
        if maps["libcuda"]:
            raise AssertionError(f"telemetry: the master maps {maps}")
        rcs["shell"] = shell.exit()
        if rcs["shell"]:
            raise AssertionError(f"telemetry: the shell exited {rcs['shell']}")
    finally:
        if shell is not None and shell.proc.poll() is None:
            shell.proc.kill()
        for name, p in procs.items():
            if name not in rcs and p.poll() is None:
                p.send_signal(signal.SIGTERM)
        for name, p in procs.items():
            if name not in rcs:
                try:
                    rcs[name] = p.wait(60)
                except subprocess.TimeoutExpired:
                    p.kill()
                    rcs[name] = p.wait(10)
    bad = {n: rc for n, rc in rcs.items() if rc != 0 and n != f"volume{victim}"}
    walls["phase"] = time.perf_counter() - phase_t0
    log(f"telemetry: SIGTERM, exit codes {rcs} (the SIGKILLed holder aside, each must be 0); "
        f"step walls (s) { {k: round(v, 3) for k, v in walls.items()} } on {card}")
    if bad:
        raise AssertionError(f"telemetry: processes exited non-zero {bad}: "
                             f"{ {n: _tail(n) for n in bad} }")
    return runs


# --- phase 3j: the filer ---------------------------------------------------


class _PhaseProcs:
    """The `python -m seaweedfs_tpu_torch` processes of one phase, each
    logging to workdir/logs/<name>.log: wait() polls a condition and
    raises with a process's log tail if one exits meanwhile; finish()
    SIGTERMs every process still running and collects each exit code."""

    def __init__(self, phase: str, workdir: str, env: dict):
        self.phase, self.env = phase, env
        self.cli = [sys.executable, "-m", "seaweedfs_tpu_torch"]
        self.here = os.path.dirname(os.path.abspath(__file__))
        self.logs = os.path.join(workdir, "logs")
        os.mkdir(self.logs)
        self.procs: dict = {}
        self.rcs: dict = {}

    def tail(self, name: str) -> str:
        with open(os.path.join(self.logs, name + ".log"), errors="replace") as f:
            return f.read()[-3000:]

    def spawn(self, name: str, args: list, cwd: str | None = None,
              module: str = "seaweedfs_tpu_torch") -> subprocess.Popen:
        """`python -m module args` in a process of its own; with `cwd`, run
        there (where its config files lie), the repo on its PYTHONPATH."""
        with open(os.path.join(self.logs, name + ".log"), "w") as log_file:
            self.procs[name] = subprocess.Popen(
                self.cli[:-1] + [module] + args, cwd=cwd or self.here, stdout=log_file,
                env=self.env if cwd is None else _repo_on_path(self.env),
                stderr=subprocess.STDOUT)
        return self.procs[name]

    def wait(self, cond, what: str, timeout: float = 120.0) -> float:
        t0 = time.monotonic()
        while True:
            try:
                if cond():
                    return time.monotonic() - t0
            except (OSError, ValueError, KeyError, http.client.HTTPException):
                pass
            for name, p in self.procs.items():
                if name not in self.rcs and p.poll() is not None:
                    raise AssertionError(f"{self.phase}: {name} exited ({p.returncode}) while "
                                         f"waiting for {what}: {self.tail(name)}")
            if time.monotonic() - t0 > timeout:
                raise AssertionError(f"{self.phase}: {what} not seen within {timeout} s")
            time.sleep(0.05)

    def finish(self) -> dict:
        import signal

        for name, p in self.procs.items():
            if name not in self.rcs and p.poll() is None:
                p.send_signal(signal.SIGTERM)
        for name, p in self.procs.items():
            if name not in self.rcs:
                try:
                    self.rcs[name] = p.wait(60)
                except subprocess.TimeoutExpired:
                    p.kill()
                    self.rcs[name] = p.wait(10)
        return self.rcs


FILER_ROOM = 2 << 30  # the filer phase's peak in its directory (about 0.8 GiB)
FILER_BIG_FILES = 2  # files of FILER_BIG_BYTES: two chunks each at the filer's -maxMB 32
FILER_BIG_BYTES = 40 << 20
FILER_DELETE_EVERY = 10  # every 10th file deleted through the filer


def _filer_tree(root: str, total: int, seed: int) -> dict:
    """A local tree of about `total` bytes under root/tree: nested
    directories of files log-uniform over 1 KiB-4 MiB (BASELINE.json
    config 1's size mix) drawn from `seed`, FILER_BIG_FILES files of
    FILER_BIG_BYTES, and one ASCII README.txt for fs.cat. Returns
    {filer path: bytes}."""
    rng = np.random.default_rng(seed)
    files = {"/tree/README.txt": "".join(
        rng.bytes(32).hex() + "\n" for _ in range(16)).encode()}
    for i in range(FILER_BIG_FILES):
        files[f"/tree/d{i}/big{i}.bin"] = rng.bytes(FILER_BIG_BYTES)
    left, i = total - sum(len(b) for b in files.values()), 0
    while left > 0:
        size = min(left, int(np.exp(rng.uniform(np.log(1024), np.log(4 << 20)))))
        depth = int(rng.integers(1, 4))
        d = "/".join(f"d{int(rng.integers(0, 4))}" for _ in range(depth))
        files[f"/tree/{d}/f{i:04d}.bin"] = rng.bytes(size)
        left -= size
        i += 1
    for path, data in files.items():
        local = os.path.join(root, path.lstrip("/"))
        os.makedirs(os.path.dirname(local), exist_ok=True)
        with open(local, "wb") as f:
            f.write(data)
    return files


def _du_line(files: dict, top: str) -> str:
    """fs.du's line for `top` over {path: bytes}: bytes, files, the
    directories below `top`."""
    under = {p: b for p, b in files.items() if p.startswith(top + "/")}
    dirs = {p[:i] for p in under for i in range(len(top) + 1, len(p))
            if p[i] == "/"}
    return (f"{sum(len(b) for b in under.values())}\t{len(under)} files\t"
            f"{len(dirs)} dirs\t{top}")


def run_filer_phase(workdir: str, volume_bytes: int, seed: int, device=None,
                    card: str = "", smi: str = "") -> dict:
    """The filer core (ROADMAP item 11a) over a cluster whose volume
    servers hold its chunks EC-encoded on the card, every process
    `python -m seaweedfs_tpu_torch`, data in `workdir` (/dev/shm), on
    `device` (None: the card; "cpu" runs the volume servers with
    -ec.codec cpu, a rehearsal):
      1. a master (-telemetryInterval 1, -repairInterval 0,
         -volumeSizeLimitMB 1152), three `volume` servers and a `filer`
         (-store lsm -storePath in workdir -collection filer, the default
         -maxMB 32);
      2. `filer.copy` of a local tree of about `volume_bytes` (files
         log-uniform over 1 KiB-4 MiB from the seed, two of 40 MiB that
         the filer cuts into two chunks each) into the filer;
      3. through a `shell` process: fs.cd, fs.ls -l, fs.du, fs.tree and
         fs.cat of the README, each equal to what the local tree says;
         fs.mv of one directory; fs.meta.save of a subtree, one of its
         entries deleted, fs.meta.load bringing it back;
      4. every file read back through the filer's HTTP GET, byte for
         byte; the filer an up scrape target of kind filer on the
         master's collector;
      5. ec.encode -collection filer -fullPercent 0 and ec.balance
         -force through the shell (K1 + K4 on the servers' cards); every
         file read back again;
      6. every FILER_DELETE_EVERY-th file deleted through the filer: its
         chunk deletion loop deletes the chunks on the EC volumes (each
         holder's BatchDelete, VolumeEcBlobDelete to the others); a GET
         of each deleted chunk's fid answers 404 on every holder, and
         fs.du drops by the deleted bytes;
      7. the holder with the second most shards SIGKILLed; every live
         file read back through the filer, byte for byte, 0 errors; each
         survivor's K1 launches rise on its /metrics (one the filer sent
         no degraded read is asked for a file on the lost shards
         directly);
      8. the filer restarted on its -storePath: fs.ls -l and fs.du give
         what they gave before;
      9. neither the filer nor filer.copy maps libcuda or torch; SIGTERM
         ends every process with exit code 0 (the killed holder aside);
     10. each step's wall printed beside the card's name and power limit.
    Raises on any fault; returns filer_encode and filer_degraded with
    the volume servers' launches."""
    import signal

    from seaweedfs_tpu_torch.ec import locate
    from seaweedfs_tpu_torch.pb import filer_pb2 as fpb
    from seaweedfs_tpu_torch.pb import master_pb2, rpc
    from seaweedfs_tpu_torch.shell import CommandEnv
    from seaweedfs_tpu_torch.storage.volume import scan_volume_file
    from seaweedfs_tpu_torch.util.availability import free_port

    _check_room(workdir, FILER_ROOM if volume_bytes >= 1 << 28 else 4 * volume_bytes
                + (1 << 27), "the filer phase")
    on_card = device is None
    env = {k: v for k, v in os.environ.items() if k != "WEED_EC_CODEC"}
    if not on_card:
        env["WEED_EC_CODEC"] = "cpu"
    codec_args = [] if on_card else ["-ec.codec", "cpu"]
    run = _PhaseProcs("filer", workdir, env)
    cli, here, logs, procs, rcs = run.cli, run.here, run.logs, run.procs, run.rcs
    _tail, spawn, wait = run.tail, run.spawn, run.wait

    def maps(pid: int) -> dict:
        return _maps_has(pid, "libcuda", "libtorch")

    phase_t0 = time.perf_counter()
    walls: dict = {}
    runs: dict = {}
    shell = None
    victim = None
    mport, fport = free_port(), free_port()
    ports = [free_port() for _ in range(3)]
    dirs = [os.path.join(workdir, f"vs{i}") for i in range(3)]
    maddr, faddr = f"127.0.0.1:{mport}", f"127.0.0.1:{fport}"
    filer_args = ["filer", "-ip", "127.0.0.1", "-port", str(fport), "-master", maddr,
                  "-store", "lsm", "-storePath", os.path.join(workdir, "filer-lsm"),
                  "-collection", "filer"]

    def filer_up() -> bool:
        with urllib.request.urlopen(f"http://{faddr}/", timeout=5) as r:
            return r.status == 200

    def server_launches() -> dict:
        """Each live volume server's kernel launches, and under
        "degraded" the EC intervals it served by reconstruction."""
        out = {}
        for i in range(3):
            if f"volume{i}" not in rcs:
                m = _cli_metrics(ports[i])
                out[i] = dict(_cli_launches(m),
                              degraded=int(m.get("weed_ec_degraded_read_total", 0)))
        return out

    def launch_delta(before: dict, after: dict) -> dict:
        return {k: sum(after[i][k] - before[i][k] for i in after) for k in _counts()}

    def read_all(paths: list, label: str) -> float:
        def get(conn, path):
            status, _, body = _http(conn, "GET", path)
            if status != 200 or body != files[path]:
                raise AssertionError(f"filer {label}: GET {path} answered {status} with "
                                     f"{len(body)} B, want {len(files[path])} B")

        t0 = time.perf_counter()
        _fan(fport, 8, paths, get)
        return time.perf_counter() - t0

    try:
        # --- 1. the cluster and the filer ---
        t0 = time.perf_counter()
        spawn("master", ["master", "-ip", "127.0.0.1", "-port", str(mport),
                         "-volumeSizeLimitMB", str(CLUSTER_LIMIT_MB), "-repairInterval", "0",
                         "-telemetryInterval", "1"])
        wait(lambda: urllib.request.urlopen(f"http://{maddr}/cluster/status",
                                            timeout=2).close() is None, "the master")
        for i, d in enumerate(dirs):
            os.mkdir(d)
            spawn(f"volume{i}", ["volume", "-ip", "127.0.0.1", "-port", str(ports[i]),
                                 "-dir", d, "-max", "100", "-mserver", maddr,
                                 "-rack", f"rack{i % 2}", "-scrubInterval", "0"] + codec_args)
        spawn("filer", filer_args)
        cenv = CommandEnv([maddr])
        wait(lambda: len(cenv.collect_topology().nodes) == 3, "three volume servers")
        wait(filer_up, "the filer")
        walls["up"] = time.perf_counter() - t0

        # --- 2. filer.copy of a local tree ---
        t0 = time.perf_counter()
        files = _filer_tree(workdir, volume_bytes, seed + 160)
        tree_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        copy = subprocess.Popen(cli + ["filer.copy", os.path.join(workdir, "tree"),
                                       f"http://{faddr}/"], cwd=here, env=env,
                                stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        copy_maps: list = []
        while copy.poll() is None:
            with contextlib.suppress(OSError):
                copy_maps.append(maps(copy.pid))
            time.sleep(0.1)
        out, _ = copy.communicate(timeout=60)
        walls["fill"] = time.perf_counter() - t0
        if copy.returncode or out.strip().splitlines()[-1:] != [f"copied {len(files)} files"]:
            raise AssertionError(f"filer.copy exited {copy.returncode}: {out[-2000:]}")
        if not copy_maps or any(any(m.values()) for m in copy_maps):
            raise AssertionError(f"filer.copy's process maps {copy_maps[-1:]}")
        with rpc.dial(f"127.0.0.1:{fport + 10000}") as ch:
            stub = rpc.filer_stub(ch)

            def chunk_fids(path: str) -> list:
                d, _, name = path.rpartition("/")
                resp = stub.LookupDirectoryEntry(
                    fpb.LookupDirectoryEntryRequest(directory=d, name=name), timeout=30)
                return [c.fid for c in resp.entry.chunks]

            fids = {p: chunk_fids(p) for p in files}
        big = {p: len(f) for p, f in fids.items() if len(files[p]) == FILER_BIG_BYTES}
        if len(big) != FILER_BIG_FILES or set(big.values()) != {2}:
            raise AssertionError(f"filer: the {FILER_BIG_BYTES} B files hold chunks {big}")
        total = sum(len(b) for b in files.values())
        log(f"filer: master, three volume servers and `filer -store lsm` up in "
            f"{walls['up']:.3f} s; filer.copy of {len(files)} files, {total} B (a tree made in "
            f"{tree_s:.3f} s) in {walls['fill']:.3f} s ({total / walls['fill'] / 1e6:.1f} "
            f"MB/s), {sum(len(f) for f in fids.values())} chunks, each {FILER_BIG_BYTES} B "
            f"file in 2; {smi}")

        # --- 3. the namespace through the shell ---
        t0 = time.perf_counter()
        shell = _CliShell(cli + ["shell", "-master", maddr], env,
                          os.path.join(logs, "shell.log"))
        procs["shell"] = shell.proc
        _, text = shell.run(f"fs.cd http://{faddr}/tree")
        if text.strip().splitlines()[-1] != f"{faddr}/tree":
            raise AssertionError(f"filer fs.cd: {text}")

        def ls_rows(top: str) -> list:
            names = sorted({p[len(top) + 1:].split("/")[0] for p in files
                            if p.startswith(top + "/")})
            rows = []
            for n in names:
                path = f"{top}/{n}"
                kind, size = ("-", len(files[path])) if path in files else ("d", 0)
                rows.append((kind, size, n + ("/" if kind == "d" else "")))
            return rows

        def check_ls(text: str, top: str) -> None:
            got = []
            for line in text.strip().splitlines()[:-1]:
                col = line.split()
                got.append((col[0][0], int(col[3]), col[4]))
            want = ls_rows(top)
            if got != want or text.strip().splitlines()[-1] != f"total {len(want)}":
                raise AssertionError(f"filer fs.ls -l {top}: {text} != {want}")

        _, text = shell.run("fs.ls -l")
        check_ls(text, "/tree")
        _, du = shell.run("fs.du")
        if du.strip() != _du_line(files, "/tree"):
            raise AssertionError(f"filer fs.du: {du} != {_du_line(files, '/tree')}")
        _, text = shell.run("fs.tree")
        n_dirs = int(_du_line(files, "/tree").split("\t")[2].split()[0])
        if text.strip().splitlines()[-1] != f"{n_dirs} directories, {len(files)} files":
            raise AssertionError(f"filer fs.tree: {text[-300:]}")
        _, text = shell.run("fs.cat README.txt")
        if text != files["/tree/README.txt"].decode():
            raise AssertionError(f"filer fs.cat: {text[:200]}")
        tops = sorted({p.split("/")[2] for p in files if p.count("/") > 2} - {"d0", "d1", "d2"})
        moved = f"/tree/{tops[-1]}"
        _, text = shell.run(f"fs.mv {moved} /moved")
        files = {("/moved" + p[len(moved):] if p.startswith(moved + "/") else p): b
                 for p, b in files.items()}
        fids = {("/moved" + p[len(moved):] if p.startswith(moved + "/") else p): f
                for p, f in fids.items()}
        _, text = shell.run("fs.ls -l /moved")
        check_ls(text, "/moved")
        sub = "/tree/d2"
        save = os.path.join(workdir, "d2.meta")
        under = [p for p in files if p.startswith(sub + "/")]
        subdirs = _du_line(files, sub).split("\t")[2].split()[0]
        _, text = shell.run(f"fs.meta.save -o {save} {sub}")
        if text.strip() != f"saved {len(under) + int(subdirs)} entries to {save}":
            raise AssertionError(f"filer fs.meta.save: {text}")
        gone = sorted(under)[0]
        gone_dir, _, name = gone.rpartition("/")
        with rpc.dial(f"127.0.0.1:{fport + 10000}") as ch:
            rpc.filer_stub(ch).DeleteEntry(fpb.DeleteEntryRequest(
                directory=gone_dir, name=name, is_delete_data=False), timeout=30)
        with urllib.request.urlopen(f"http://{faddr}{gone_dir}", timeout=30) as r:
            if gone in {e["FullPath"] for e in json.loads(r.read())["Entries"]}:
                raise AssertionError(f"filer: {gone} still listed after DeleteEntry")
        _, text = shell.run(f"fs.meta.load {save}")
        if text.strip() != f"loaded {len(under) + int(subdirs)} entries":
            raise AssertionError(f"filer fs.meta.load: {text}")
        _, text = shell.run(f"fs.ls -l {gone_dir}")
        check_ls(text, gone_dir)
        walls["namespace"] = time.perf_counter() - t0

        # --- 4. every file back through the filer, healthy ---
        paths = sorted(files)
        walls["read_healthy"] = read_all(paths, "healthy read")
        health: dict = {}

        def filer_target() -> bool:
            with urllib.request.urlopen(f"http://{maddr}/cluster/health", timeout=10) as r:
                health.update(json.loads(r.read())["Targets"].get(faddr, {}))
            return bool(health.get("Up")) and health.get("Kind") == "filer"

        scraped_s = wait(filer_target, "the filer as an up scrape target of kind filer", 60)
        log(f"filer namespace through the shell: fs.cd, fs.ls -l, fs.du ({du.strip()!r}), "
            f"fs.tree, fs.cat, fs.mv {moved} /moved, fs.meta.save/-load of {sub} "
            f"({len(under)} files) in {walls['namespace']:.3f} s; {len(paths)} files read "
            f"back healthy in {walls['read_healthy']:.3f} s ({total / walls['read_healthy'] / 1e6:.1f}"
            f" MB/s); the filer an up scrape target of kind {health.get('Kind')} "
            f"({scraped_s:.3f} s later); {smi}")

        # --- 5. ec.encode and ec.balance, every file back ---
        vols = {}
        for i, d in enumerate(dirs):
            for f in os.listdir(d):
                if f.startswith("filer_") and f.endswith(".dat"):
                    path = os.path.join(d, f)
                    vols[int(f[6:-4])] = (os.path.getsize(path), {
                        nd.id: (off, nd.size) for nd, off in scan_volume_file(path)})
        k0 = server_launches()
        t0 = time.perf_counter()
        _, text = shell.run("ec.encode -collection filer -fullPercent 0")
        if text.count("ec encoded volume") != len(vols):
            raise AssertionError(f"filer ec.encode: {text[-2000:]} over volumes {sorted(vols)}")
        shell.run("ec.balance -force")
        walls["encode_balance"] = time.perf_counter() - t0
        k1 = server_launches()
        encode_launches = launch_delta(k0, k1)
        if on_card:
            _must_launch("filer ec.encode", encode_launches, ("gf_apply", "crc32c_rows"))
        held: dict = {i: {} for i in range(3)}
        for i, d in enumerate(dirs):
            for f in os.listdir(d):
                if f.startswith("filer_") and ".ec" in f and f[-2:].isdigit():
                    held[i].setdefault(int(f[6:].split(".")[0]), []).append(int(f[-2:]))
        runs["filer_encode"] = {"wall_s": walls["encode_balance"], "launches": encode_launches,
                                "sigs": {}}
        walls["read_encoded"] = read_all(paths, "read after ec.encode")
        log(f"filer ec.encode -collection filer of {len(vols)} volumes and ec.balance -force "
            f"through the shell in {walls['encode_balance']:.3f} s, the servers' launches "
            f"{encode_launches}; shards by server { {i: sum(map(len, h.values())) for i, h in held.items()} }; "
            f"{len(paths)} files read back in {walls['read_encoded']:.3f} s; {smi}")

        # --- 6. deletes through the filer reach the EC volumes ---
        t0 = time.perf_counter()
        deleted = paths[::FILER_DELETE_EVERY]
        for path in deleted:
            req = urllib.request.Request(f"http://{faddr}{path}", method="DELETE")
            with urllib.request.urlopen(req, timeout=30) as r:
                if r.status != 204:
                    raise AssertionError(f"filer DELETE {path}: {r.status}")
        gone_fids = [f for p in deleted for f in fids[p]]

        def chunks_gone() -> bool:
            for fid in gone_fids:
                for port in ports:
                    try:
                        urllib.request.urlopen(f"http://127.0.0.1:{port}/{fid}",
                                               timeout=30).close()
                        return False
                    except urllib.error.HTTPError as e:
                        if e.code != 404:
                            return False
            return True

        wait(chunks_gone, "404 for every deleted chunk on every holder", 120)
        files = {p: b for p, b in files.items() if p not in deleted}
        _, du = shell.run("fs.du /")
        got_bytes = int(du.split("\t")[0])
        if got_bytes != sum(len(b) for b in files.values()):
            raise AssertionError(f"filer fs.du / after the deletes: {du}")
        walls["delete"] = time.perf_counter() - t0
        log(f"filer: {len(deleted)} files ({total - got_bytes} B, {len(gone_fids)} chunks) "
            f"deleted through the filer; every chunk's fid answers 404 on all three holders "
            f"and fs.du / drops to {got_bytes} B, in {walls['delete']:.3f} s")

        # --- 7. a holder killed, degraded reads through the filer ---
        order = sorted(held, key=lambda i: -sum(map(len, held[i].values())))
        victim = order[1]
        lost = {vid: set(s) for vid, s in held[victim].items()}
        touched, touched_fids = [], []
        for path in sorted(files):
            for fid in fids[path]:
                vid_s, rest = fid.split(",")
                vid, nid = int(vid_s), int(rest[:-8], 16)
                dat_size, needles = vols[vid]
                off, size = needles[nid]
                shards = {iv.to_shard_id_and_offset()[0] for iv in locate.locate_data(
                    locate.LARGE_BLOCK_SIZE, locate.SMALL_BLOCK_SIZE, dat_size, off,
                    16 + size + 4 + 8)}
                if shards & lost.get(vid, set()):
                    touched.append(path)
                    if len(fids[path]) == 1:
                        touched_fids.append((path, fid))
                    break
        if not touched_fids:
            raise AssertionError(f"filer: no live one-chunk file has bytes on shards {lost}")
        _, ls_before = shell.run("fs.ls -l")
        _, du_before = shell.run("fs.du")
        procs[f"volume{victim}"].send_signal(signal.SIGKILL)
        rcs[f"volume{victim}"] = procs[f"volume{victim}"].wait(30)
        k0 = server_launches()
        walls["read_degraded"] = read_all(sorted(files), "degraded read")
        k1 = server_launches()
        degraded = launch_delta(k0, k1)
        if on_card:
            _must_launch("filer degraded reads", degraded, ("gf_apply",))
        # every survivor holds shards of the touched volumes, and its K1
        # launches must rise. One that served no degraded interval
        # through the filer (the filer picked the other holder) is asked
        # for a one-chunk file with bytes on the lost shards directly.
        direct = {}
        for i in sorted(k1):
            served = k1[i]["degraded"] - k0[i]["degraded"]
            if served == 0:
                path, fid = touched_fids[len(direct) % len(touched_fids)]
                with urllib.request.urlopen(f"http://127.0.0.1:{ports[i]}/{fid}",
                                            timeout=60) as r:
                    body = r.read()
                if body != files[path]:
                    raise AssertionError(f"filer: volume{i}'s GET of {fid} ({path}) gave "
                                         f"{len(body)} B, want {len(files[path])} B")
                direct[i] = fid
                k1[i] = server_launches()[i]
                served = k1[i]["degraded"] - k0[i]["degraded"]
            if served == 0:
                raise AssertionError(f"filer: volume{i} served no degraded interval, even "
                                     f"asked for {direct.get(i)} directly")
            if on_card and k1[i]["gf_apply"] <= k0[i]["gf_apply"]:
                raise AssertionError(f"filer: volume{i} served {served} degraded intervals "
                                     f"but its K1 launches did not rise "
                                     f"({k0[i]['gf_apply']} -> {k1[i]['gf_apply']})")
        runs["filer_degraded"] = {"wall_s": walls["read_degraded"], "launches": degraded,
                                  "sigs": {}, "files": len(files), "touched": len(touched)}
        log(f"filer degraded reads on {card}: volume{victim} (shards "
            f"{ {v: sorted(s) for v, s in lost.items()} }) SIGKILLed; {len(files)} live files "
            f"read back through the filer, {len(touched)} of them with bytes on its shards, "
            f"byte for byte, 0 errors, in {walls['read_degraded']:.3f} s; the survivors' "
            f"launches {degraded} ({ {i: k1[i]['gf_apply'] - k0[i]['gf_apply'] for i in k1} } "
            f"K1 and { {i: k1[i]['degraded'] - k0[i]['degraded'] for i in k1} } degraded "
            f"intervals by server, each rising; asked directly: {direct}); {smi}")

        # --- 8. the filer restarted on its store ---
        t0 = time.perf_counter()
        filer_maps = [maps(procs["filer"].pid)]
        procs["filer"].send_signal(signal.SIGTERM)
        rcs["filer"] = procs["filer"].wait(60)
        if rcs["filer"]:
            raise AssertionError(f"filer: SIGTERM ended it with {rcs['filer']}: "
                                 f"{_tail('filer')}")
        spawn("filer-restarted", filer_args)
        wait(filer_up, "the restarted filer")
        filer_maps.append(maps(procs["filer-restarted"].pid))
        _, ls_after = shell.run("fs.ls -l")
        _, du_after = shell.run("fs.du")
        if (ls_after, du_after) != (ls_before, du_before):
            raise AssertionError(f"filer restart: fs.ls -l / fs.du {ls_after!r} {du_after!r} "
                                 f"!= {ls_before!r} {du_before!r}")
        walls["restart"] = time.perf_counter() - t0
        if any(any(m.values()) for m in filer_maps):
            raise AssertionError(f"filer: the filer process maps {filer_maps}")
        rcs["shell"] = shell.exit()
        if rcs["shell"]:
            raise AssertionError(f"filer: the shell exited {rcs['shell']}")
        log(f"filer restarted on its -storePath in {walls['restart']:.3f} s: fs.ls -l and "
            f"fs.du as before ({du_after.strip()!r}); libcuda/libtorch mapped by the filer "
            f"{filer_maps}, by filer.copy {copy_maps[-1]} ({len(copy_maps)} samples)")
        runs["filer"] = {"walls": walls, "files": len(files), "deleted": len(deleted),
                         "touched": len(touched)}
    finally:
        if shell is not None and shell.proc.poll() is None:
            shell.proc.kill()
        run.finish()
    bad = {n: rc for n, rc in rcs.items() if rc != 0 and n != f"volume{victim}"}
    walls["phase"] = time.perf_counter() - phase_t0
    log(f"filer: SIGTERM, exit codes {rcs} (the SIGKILLed holder aside, each must be 0); "
        f"step walls (s) { {k: round(v, 3) for k, v in walls.items()} } on {card}; {smi}")
    if bad:
        raise AssertionError(f"filer: processes exited non-zero {bad}: "
                             f"{ {n: _tail(n) for n in bad} }")
    return runs


# --- phase 3k: the S3 gateway ----------------------------------------------


S3_ROOM = 2 << 30  # the S3 phase's peak in its directory (about 1.2 GiB)
S3_BYTES = 128 << 20  # 3k's objects besides the multipart, streamed and copied ones: CUT_BYTES
# halved, for time
S3_BUCKET = "smoke"
S3_ACCESS, S3_SECRET = "AKIDSMOKE", "smoke-secret-key"  # the one identity of -config
S3_CLIENTS = 4  # client threads of the fill and of every read pass
S3_MULTIPART = 2  # objects uploaded in parts
S3_PARTS, S3_PART_BYTES = 5, 8 << 20  # 40 MiB each, one chunk a part at -maxMB 32
S3_STREAM_BYTES, S3_STREAM_CHUNK = 8 << 20, 64 << 10  # the aws-chunked PUT
S3_PAGE = 100  # ListObjectsV2's max-keys
S3_DELETE_EVERY = 10  # every 10th object deleted by DeleteObjects


def _s3_request(conn, method: str, path: str, query: dict | None = None, body=b"",
                headers: dict | None = None, access: str = S3_ACCESS,
                secret: str = S3_SECRET, sign: bool = True,
                payload_hash: str | None = None) -> tuple[int, dict, bytes]:
    """One request on the keep-alive http.client connection `conn`,
    SigV4-signed (as S3Client signs: host, x-amz-date, the payload's
    SHA-256 and every header given) just before it is sent, so that no
    signature outlives a slow step. Returns (status, headers, body)."""
    import datetime
    import hashlib
    import urllib.parse

    from seaweedfs_tpu_torch.s3api.auth import sigv4_sign

    qs = "&".join(f"{urllib.parse.quote(k, safe='')}={urllib.parse.quote(v, safe='')}"
                  for k, v in sorted((query or {}).items()))
    quoted = urllib.parse.quote(path)
    out = {k.lower(): v for k, v in (headers or {}).items()}
    if sign:
        amz_date = datetime.datetime.now(datetime.timezone.utc).strftime("%Y%m%dT%H%M%SZ")
        payload_hash = payload_hash or hashlib.sha256(body or b"").hexdigest()
        out.update({"host": f"{conn.host}:{conn.port}", "x-amz-date": amz_date,
                    "x-amz-content-sha256": payload_hash})
        out["authorization"] = sigv4_sign(method, quoted, qs, out, payload_hash, access,
                                          secret, "us-east-1", "s3", amz_date)
    conn.request(method, quoted + (f"?{qs}" if qs else ""), body=body or None, headers=out)
    resp = conn.getresponse()
    return resp.status, dict(resp.getheaders()), resp.read()


def _s3_streaming_put(conn, path: str, data: bytes) -> tuple[int, dict, bytes]:
    """A signed aws-chunked PUT: the header signature over the STREAMING
    sentinel seeds the chain each 64 KiB chunk's signature extends."""
    import datetime
    import urllib.parse

    from seaweedfs_tpu_torch.s3api import auth, chunked_reader

    now = datetime.datetime.now(datetime.timezone.utc)
    amz_date, date = now.strftime("%Y%m%dT%H%M%SZ"), now.strftime("%Y%m%d")
    headers = {"host": f"{conn.host}:{conn.port}", "x-amz-date": amz_date,
               "x-amz-content-sha256": auth.STREAMING_PAYLOAD,
               "x-amz-decoded-content-length": str(len(data)),
               "content-encoding": "aws-chunked"}
    quoted = urllib.parse.quote(path)
    headers["authorization"] = auth.sigv4_sign("PUT", quoted, "", headers,
                                               auth.STREAMING_PAYLOAD, S3_ACCESS, S3_SECRET,
                                               "us-east-1", "s3", amz_date)
    seed = headers["authorization"].rsplit("Signature=", 1)[1]
    framed = chunked_reader.encode_chunked_payload(
        data, S3_STREAM_CHUNK, auth.derive_signing_key(S3_SECRET, date, "us-east-1", "s3"),
        seed, amz_date, f"{date}/us-east-1/s3/aws4_request")
    conn.request("PUT", quoted, body=framed, headers=headers)
    resp = conn.getresponse()
    return resp.status, dict(resp.getheaders()), resp.read()


def _s3_xml(body: bytes):
    """The XML document with its namespace taken off every tag."""
    import xml.etree.ElementTree as ET

    root = ET.fromstring(body)
    for el in root.iter():
        el.tag = el.tag.split("}", 1)[-1]
    return root


def _s3_objects(total: int, seed: int) -> dict:
    """{key: bytes} of about `total` bytes: objects log-uniform over
    1 KiB-4 MiB (BASELINE.json config 1's size mix) drawn from `seed`,
    under keys nested 1-3 directories deep (d0-d3 at each level)."""
    rng = np.random.default_rng(seed)
    out, left, i = {}, total, 0
    while left > 0:
        size = min(left, int(np.exp(rng.uniform(np.log(1024), np.log(4 << 20)))))
        depth = int(rng.integers(1, 4))
        d = "/".join(f"d{int(rng.integers(0, 4))}" for _ in range(depth))
        out[f"{d}/f{i:04d}.bin"] = rng.bytes(size)
        left -= size
        i += 1
    return out


def run_s3_phase(workdir: str, volume_bytes: int, seed: int, device=None,
                 card: str = "", smi: str = "") -> dict:
    """The S3 gateway (ROADMAP item 11b) in front of the filer, over a
    cluster whose volume servers hold its chunks EC-encoded on the card,
    every process `python -m seaweedfs_tpu_torch`, data in `workdir`
    (/dev/shm), on `device` (None: the card; "cpu" runs the volume
    servers with -ec.codec cpu, a rehearsal):
      1. a master (-telemetryInterval 1, -repairInterval 0,
         -volumeSizeLimitMB 1152), three `volume` servers (racks 0/1/0),
         a `filer -store lsm -collection s3` (the default -maxMB 32) and
         an `s3 -filer -master -config` with one identity, from an
         identities file written into `workdir`;
      2. signed requests fill one bucket from S3_CLIENTS threads:
         `volume_bytes` of objects log-uniform over 1 KiB-4 MiB from the
         seed under keys 1-3 directories deep; S3_MULTIPART objects of
         S3_PARTS parts of 8 MiB by multipart upload (a part of the first
         uploaded twice, the second bytes kept); one upload aborted and
         gone from ListMultipartUploads; one 8 MiB object by a signed
         aws-chunked PUT; one CopyObject;
      3. ListObjectsV2 (S3_PAGE keys a page, flat, and with each top
         directory as prefix and "/" as delimiter) and ListObjects v1
         give exactly the keys and sizes put; a wrong secret gets 403
         SignatureDoesNotMatch, an unknown access key 403
         InvalidAccessKeyId, an unsigned request 403 AccessDenied; the
         gateway an up scrape target of kind s3 on the master's collector;
      4. every object read back through the gateway: its SHA-256 equal
         to the payload's, its ETag the MD5 of the body;
      5. ec.encode -collection s3 -fullPercent 0 and ec.balance -force
         through a `shell` process (K1 + K4 on the servers' cards, off
         their /metrics); every object read back again;
      6. every S3_DELETE_EVERY-th object deleted by one DeleteObjects:
         each then answers 404 NoSuchKey, and its chunks' fids 404 on
         every holder;
      7. the holder with the second most shards SIGKILLed; every live
         object read back through the gateway, byte for byte, 0 errors;
         each survivor's K1 launches rise on its /metrics (one the filer
         sent no degraded read is asked for an object on the lost shards
         directly);
      8. the gateway maps neither libcuda nor torch; SIGTERM ends every
         process with exit code 0 (the killed holder aside);
      9. each step's wall, the fill and read MB/s, the objects touched
         and the K1/K4 launches by server printed beside the card's name
         and power limit.
    Raises naming 3k and the step on any fault; returns s3_encode and
    s3_degraded with the volume servers' launches."""
    import hashlib
    import signal

    from seaweedfs_tpu_torch.ec import locate
    from seaweedfs_tpu_torch.pb import filer_pb2 as fpb
    from seaweedfs_tpu_torch.pb import rpc
    from seaweedfs_tpu_torch.s3api.client import S3Client
    from seaweedfs_tpu_torch.shell import CommandEnv
    from seaweedfs_tpu_torch.storage.volume import scan_volume_file
    from seaweedfs_tpu_torch.util.availability import free_port

    extra = S3_MULTIPART * S3_PARTS * S3_PART_BYTES + S3_STREAM_BYTES
    _check_room(workdir, S3_ROOM if volume_bytes >= 1 << 28
                else 4 * (volume_bytes + extra) + (1 << 27), "phase 3k")
    on_card = device is None
    env = {k: v for k, v in os.environ.items() if k != "WEED_EC_CODEC"}
    if not on_card:
        env["WEED_EC_CODEC"] = "cpu"
    codec_args = [] if on_card else ["-ec.codec", "cpu"]
    run = _PhaseProcs("3k s3", workdir, env)
    step = "1 start"

    def fail(msg: str):
        raise AssertionError(f"3k s3, step {step}: {msg}")

    phase_t0 = time.perf_counter()
    walls: dict = {}
    runs: dict = {}
    shell = None
    victim = None
    maps_seen: list = []
    mport, fport, gport = free_port(), free_port(), free_port()
    ports = [free_port() for _ in range(3)]
    dirs = [os.path.join(workdir, f"vs{i}") for i in range(3)]
    maddr, faddr, gaddr = (f"127.0.0.1:{p}" for p in (mport, fport, gport))
    prefix = f"/buckets/{S3_BUCKET}"

    def conn():
        return http.client.HTTPConnection("127.0.0.1", gport, timeout=120)

    def one(method: str, path: str, **kw) -> tuple[int, dict, bytes]:
        c = conn()
        try:
            return _s3_request(c, method, path, **kw)
        finally:
            c.close()

    def server_launches() -> dict:
        """Each live volume server's kernel launches, and under
        "degraded" the EC intervals it served by reconstruction."""
        out = {}
        for i in range(3):
            if f"volume{i}" not in run.rcs:
                m = _cli_metrics(ports[i])
                out[i] = dict(_cli_launches(m),
                              degraded=int(m.get("weed_ec_degraded_read_total", 0)))
        return out

    def launch_delta(before: dict, after: dict) -> dict:
        return {k: sum(after[i][k] - before[i][k] for i in after) for k in _counts()}

    def read_all(keys: list, label: str) -> float:
        def get(c, key):
            status, headers, body = _s3_request(c, "GET", f"/{S3_BUCKET}/{key}")
            if status != 200 or hashlib.sha256(body).digest() != digests[key]:
                fail(f"{label}: GET {key} answered {status} with {len(body)} B, want "
                     f"{sizes[key]} B of SHA-256 {digests[key].hex()}: {body[:200]!r}")
            if headers.get("ETag") != f'"{hashlib.md5(body).hexdigest()}"':
                fail(f"{label}: GET {key}'s ETag {headers.get('ETag')} is not the MD5 of "
                     f"its body")

        t0 = time.perf_counter()
        _fan(gport, S3_CLIENTS, keys, get)
        return time.perf_counter() - t0

    def gateway_maps() -> dict:
        return _maps_has(run.procs["s3"].pid, "libcuda", "libtorch")

    try:
        # --- 1. the cluster, the filer and the gateway ---
        t0 = time.perf_counter()
        identities = os.path.join(workdir, "identities.toml")
        with open(identities, "w") as f:
            f.write(f'[[identities]]\nname = "smoke"\naccess_key = "{S3_ACCESS}"\n'
                    f'secret_key = "{S3_SECRET}"\nactions = ["Admin"]\n')
        run.spawn("master", ["master", "-ip", "127.0.0.1", "-port", str(mport),
                             "-volumeSizeLimitMB", str(CLUSTER_LIMIT_MB), "-repairInterval",
                             "0", "-telemetryInterval", "1"])
        run.wait(lambda: urllib.request.urlopen(f"http://{maddr}/cluster/status",
                                                timeout=2).close() is None, "the master")
        for i, d in enumerate(dirs):
            os.mkdir(d)
            run.spawn(f"volume{i}", ["volume", "-ip", "127.0.0.1", "-port", str(ports[i]),
                                     "-dir", d, "-max", "100", "-mserver", maddr,
                                     "-rack", f"rack{i % 2}", "-scrubInterval", "0"]
                      + codec_args)
        run.spawn("filer", ["filer", "-ip", "127.0.0.1", "-port", str(fport), "-master",
                            maddr, "-store", "lsm", "-storePath",
                            os.path.join(workdir, "filer-lsm"), "-collection", "s3"])
        run.spawn("s3", ["s3", "-ip", "127.0.0.1", "-port", str(gport), "-filer", faddr,
                         "-master", maddr, "-config", identities])
        cenv = CommandEnv([maddr])
        run.wait(lambda: len(cenv.collect_topology().nodes) == 3, "three volume servers")
        def filer_up() -> bool:
            with urllib.request.urlopen(f"http://{faddr}/", timeout=5) as r:
                return r.status == 200

        run.wait(filer_up, "the filer")
        run.wait(lambda: one("GET", "/")[0] == 200, "a signed ListBuckets from the gateway")
        walls["up"] = time.perf_counter() - t0

        # --- 2. the fill, by signed requests ---
        step = "2 fill"
        t0 = time.perf_counter()
        objects = _s3_objects(volume_bytes, seed + 180)
        plain_total = sum(map(len, objects.values()))
        rng = np.random.default_rng(seed + 181)
        parts = {f"mp/big{j}.bin": [rng.bytes(S3_PART_BYTES) for _ in range(S3_PARTS)]
                 for j in range(S3_MULTIPART)}
        redo = rng.bytes(S3_PART_BYTES)  # the first object's part 2, uploaded again
        streamed = rng.bytes(S3_STREAM_BYTES)
        make_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        client = S3Client(gaddr, S3_ACCESS, S3_SECRET)
        client.create_bucket(S3_BUCKET)

        def put(c, key):
            status, headers, body = _s3_request(c, "PUT", f"/{S3_BUCKET}/{key}",
                                                body=objects[key])
            if status != 200 or headers.get("ETag") != (
                    f'"{hashlib.md5(objects[key]).hexdigest()}"'):
                fail(f"PUT {key}: {status} {headers.get('ETag')} {body[:300]!r}")

        _fan(gport, S3_CLIENTS, sorted(objects), put)
        walls["fill_objects"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        c = conn()
        try:
            def upload_id(key: str) -> str:
                status, _, body = _s3_request(c, "POST", f"/{S3_BUCKET}/{key}",
                                              query={"uploads": ""})
                if status != 200:
                    fail(f"CreateMultipartUpload {key}: {status} {body[:300]!r}")
                return _s3_xml(body).findtext("UploadId")

            def put_part(key: str, uid: str, n: int, data: bytes) -> str:
                status, headers, body = _s3_request(
                    c, "PUT", f"/{S3_BUCKET}/{key}",
                    query={"partNumber": str(n), "uploadId": uid}, body=data)
                if status != 200 or headers.get("ETag") != (
                        f'"{hashlib.md5(data).hexdigest()}"'):
                    fail(f"UploadPart {key} {n}: {status} {headers.get('ETag')} "
                         f"{body[:300]!r}")
                return headers["ETag"]

            def uploads() -> list:
                status, _, body = _s3_request(c, "GET", f"/{S3_BUCKET}",
                                              query={"uploads": ""})
                if status != 200:
                    fail(f"ListMultipartUploads: {status} {body[:300]!r}")
                return [u.findtext("UploadId") for u in _s3_xml(body).iter("Upload")]

            mp_etags = {}
            for j, (key, pieces) in enumerate(sorted(parts.items())):
                uid = upload_id(key)
                etags = [put_part(key, uid, n + 1, p) for n, p in enumerate(pieces)]
                if j == 0:
                    pieces[1] = redo
                    etags[1] = put_part(key, uid, 2, redo)
                manifest = "".join(f"<Part><PartNumber>{n + 1}</PartNumber><ETag>{e}</ETag>"
                                   f"</Part>" for n, e in enumerate(etags))
                status, _, body = _s3_request(
                    c, "POST", f"/{S3_BUCKET}/{key}", query={"uploadId": uid},
                    body=f"<CompleteMultipartUpload>{manifest}</CompleteMultipartUpload>"
                    .encode())
                if status != 200:
                    fail(f"CompleteMultipartUpload {key}: {status} {body[:300]!r}")
                mp_etags[key] = _s3_xml(body).findtext("ETag")
                if not re.fullmatch(rf'"[0-9a-f]{{32}}-{S3_PARTS}"', mp_etags[key] or ""):
                    fail(f"CompleteMultipartUpload {key}: ETag {mp_etags[key]} is not "
                         f"<hex>-{S3_PARTS}")
                objects[key] = b"".join(pieces)
            aborted_key = "mp/aborted.bin"
            uid = upload_id(aborted_key)
            put_part(aborted_key, uid, 1, rng.bytes(1 << 20))
            listed = uploads()
            status, _, body = _s3_request(c, "DELETE", f"/{S3_BUCKET}/{aborted_key}",
                                          query={"uploadId": uid})
            after = uploads()
            if listed != [uid] or status != 204 or after:
                fail(f"AbortMultipartUpload: listed {listed} before, {status} "
                     f"{body[:200]!r}, listed {after} after")
            status, headers, body = _s3_streaming_put(c, f"/{S3_BUCKET}/stream/streamed.bin",
                                                      streamed)
            if status != 200 or headers.get("ETag") != (
                    f'"{hashlib.md5(streamed).hexdigest()}"'):
                fail(f"aws-chunked PUT: {status} {headers.get('ETag')} {body[:300]!r}")
            objects["stream/streamed.bin"] = streamed
            source = sorted(k for k in objects if k.startswith("d"))[0]
            status, _, body = _s3_request(c, "PUT", f"/{S3_BUCKET}/copy/copied.bin",
                                          headers={"x-amz-copy-source":
                                                   f"/{S3_BUCKET}/{source}"})
            if status != 200 or _s3_xml(body).findtext("ETag") != (
                    f'"{hashlib.md5(objects[source]).hexdigest()}"'):
                fail(f"CopyObject of {source}: {status} {body[:300]!r}")
            objects["copy/copied.bin"] = objects[source]
        finally:
            c.close()
        walls["fill_multipart_stream_copy"] = time.perf_counter() - t0
        walls["fill"] = walls["fill_objects"] + walls["fill_multipart_stream_copy"]
        sizes = {k: len(b) for k, b in objects.items()}
        digests = {k: hashlib.sha256(b).digest() for k, b in objects.items()}
        total = sum(sizes.values())
        with rpc.dial(f"127.0.0.1:{fport + 10000}") as ch:
            stub = rpc.filer_stub(ch)

            def chunk_fids(key: str) -> list:
                d, _, name = f"{prefix}/{key}".rpartition("/")
                resp = stub.LookupDirectoryEntry(
                    fpb.LookupDirectoryEntryRequest(directory=d, name=name), timeout=30)
                return [chunk.fid for chunk in resp.entry.chunks]

            fids = {k: chunk_fids(k) for k in objects}
        if {len(fids[k]) for k in parts} != {S3_PARTS}:
            fail(f"the multipart objects hold chunks { {k: len(fids[k]) for k in parts} }")
        maps_seen.append(gateway_maps())
        log(f"3k s3: master, three volume servers, `filer -store lsm -collection s3` and "
            f"`s3 -config` up in {walls['up']:.3f} s; {len(objects)} objects, {total} B "
            f"(payloads made in {make_s:.3f} s) put by signed requests in "
            f"{walls['fill']:.3f} s ({total / walls['fill'] / 1e6:.1f} MB/s): "
            f"{len(objects) - S3_MULTIPART - 2} objects ({plain_total} B) from {S3_CLIENTS} "
            f"threads in {walls['fill_objects']:.3f} s "
            f"({plain_total / walls['fill_objects'] / 1e6:.1f} MB/s), {S3_MULTIPART} multipart objects of {S3_PARTS} x {S3_PART_BYTES} B "
            f"(ETags {sorted(mp_etags.values())}; part 2 of the first uploaded twice; one "
            f"upload aborted and gone from ListMultipartUploads), one {S3_STREAM_BYTES} B "
            f"aws-chunked PUT and one CopyObject in {walls['fill_multipart_stream_copy']:.3f} "
            f"s; {sum(map(len, fids.values()))} chunks; {smi}")

        # --- 3. the namespace and the auth checks ---
        step = "3 namespace"
        t0 = time.perf_counter()

        def listing(query: dict, v2: bool = True) -> tuple[list, list]:
            """Every (key, size) and common prefix, page by page."""
            keys, common, token = [], [], ""
            c = conn()
            try:
                while True:
                    q = dict(query)
                    if v2:
                        q.update({"list-type": "2", "max-keys": str(S3_PAGE)})
                        if token:
                            q["continuation-token"] = token
                    elif token:
                        q["marker"] = token
                    status, _, body = _s3_request(c, "GET", f"/{S3_BUCKET}", query=q)
                    if status != 200:
                        fail(f"ListObjects {q}: {status} {body[:300]!r}")
                    root = _s3_xml(body)
                    keys += [(el.findtext("Key"), int(el.findtext("Size")))
                             for el in root.iter("Contents")]
                    common += [el.findtext("Prefix") for el in root.iter("CommonPrefixes")]
                    if root.findtext("IsTruncated") != "true":
                        return keys, common
                    token = root.findtext("NextContinuationToken" if v2 else "NextMarker")
            finally:
                c.close()

        want = sorted(sizes.items())
        got, common = listing({})
        if got != want or common:
            fail(f"ListObjectsV2 by {S3_PAGE}: {len(got)} keys, {common[:5]} prefixes; want "
                 f"{len(want)} keys; first difference "
                 f"{next((a, b) for a, b in zip(got + [None] * len(want), want) if a != b)}")
        tops = sorted({k.split("/")[0] for k in sizes})
        for top in tops:
            under = {k[len(top) + 1:]: n for k, n in sizes.items() if k.startswith(top + "/")}
            got, common = listing({"prefix": f"{top}/", "delimiter": "/"})
            want_keys = sorted((f"{top}/{k}", n) for k, n in under.items() if "/" not in k)
            want_common = sorted({f"{top}/{k.split('/')[0]}/" for k in under if "/" in k})
            if got != want_keys or sorted(common) != want_common:
                fail(f"ListObjectsV2 prefix {top}/ delimiter /: {got[:5]} {common} != "
                     f"{want_keys[:5]} {want_common}")
        got, common = listing({"max-keys": "1000"}, v2=False)
        if got != want or common:
            fail(f"ListObjects v1: {len(got)} keys, want {len(want)}")
        if client.list_objects(S3_BUCKET) != [k for k, _ in want]:
            fail("S3Client.list_objects does not list the keys put")
        refused = {}
        for label, kw, code in (("wrong secret", {"secret": "not-the-secret"},
                                 "SignatureDoesNotMatch"),
                                ("unknown access key", {"access": "AKIDNOBODY"},
                                 "InvalidAccessKeyId"),
                                ("unsigned", {"sign": False}, "AccessDenied")):
            status, _, body = one("GET", f"/{S3_BUCKET}/{source}", **kw)
            refused[label] = (status, _s3_xml(body).findtext("Code"))
            if refused[label] != (403, code):
                fail(f"a request with {label}: {status} {body[:300]!r}, want 403 {code}")
        health: dict = {}

        def gateway_target() -> bool:
            with urllib.request.urlopen(f"http://{maddr}/cluster/health", timeout=10) as r:
                health.update(json.loads(r.read())["Targets"].get(gaddr, {}))
            return bool(health.get("Up")) and health.get("Kind") == "s3"

        scraped_s = run.wait(gateway_target, "the gateway as an up scrape target of kind s3",
                             60)
        walls["namespace"] = time.perf_counter() - t0

        # --- 4. every object back, healthy ---
        step = "4 healthy read"
        keys = sorted(objects)
        walls["read_healthy"] = read_all(keys, "healthy read")
        log(f"3k s3 namespace: ListObjectsV2 by {S3_PAGE} (flat, and with prefixes {tops} "
            f"and delimiter /) and ListObjects v1 list the {len(keys)} keys and sizes put; "
            f"refused {refused}; the gateway an up scrape target of kind "
            f"{health.get('Kind')} ({scraped_s:.3f} s after the checks began), in "
            f"{walls['namespace']:.3f} s; {len(keys)} objects read back healthy (SHA-256 and "
            f"ETag) in {walls['read_healthy']:.3f} s ({total / walls['read_healthy'] / 1e6:.1f}"
            f" MB/s); {smi}")

        # --- 5. ec.encode and ec.balance, every object back ---
        step = "5 encode"
        vols = {}
        for d in dirs:
            for f in os.listdir(d):
                if f.startswith("s3_") and f.endswith(".dat"):
                    path = os.path.join(d, f)
                    vols[int(f[3:-4])] = (os.path.getsize(path), {
                        nd.id: (off, nd.size) for nd, off in scan_volume_file(path)})
        shell = _CliShell(run.cli + ["shell", "-master", maddr], env,
                          os.path.join(run.logs, "shell.log"))
        run.procs["shell"] = shell.proc
        k0 = server_launches()
        t0 = time.perf_counter()
        _, text = shell.run("ec.encode -collection s3 -fullPercent 0")
        if text.count("ec encoded volume") != len(vols):
            fail(f"ec.encode: {text[-2000:]} over volumes {sorted(vols)}")
        shell.run("ec.balance -force")
        walls["encode_balance"] = time.perf_counter() - t0
        k1 = server_launches()
        encode_launches = launch_delta(k0, k1)
        if on_card:
            _must_launch("3k s3 ec.encode", encode_launches, ("gf_apply", "crc32c_rows"))
        held: dict = {i: {} for i in range(3)}
        for i, d in enumerate(dirs):
            for f in os.listdir(d):
                if f.startswith("s3_") and ".ec" in f and f[-2:].isdigit():
                    held[i].setdefault(int(f[3:].split(".")[0]), []).append(int(f[-2:]))
        runs["s3_encode"] = {"wall_s": walls["encode_balance"], "launches": encode_launches,
                             "sigs": {}}
        walls["read_encoded"] = read_all(keys, "read after ec.encode")
        log(f"3k s3 ec.encode -collection s3 of {len(vols)} volumes and ec.balance -force "
            f"through the shell in {walls['encode_balance']:.3f} s, the servers' launches "
            f"{encode_launches} ({ {i: (k1[i]['gf_apply'] - k0[i]['gf_apply'], k1[i]['crc32c_rows'] - k0[i]['crc32c_rows']) for i in k1} } "
            f"K1/K4 by server); shards by server "
            f"{ {i: sum(map(len, h.values())) for i, h in held.items()} }; {len(keys)} objects "
            f"read back in {walls['read_encoded']:.3f} s "
            f"({total / walls['read_encoded'] / 1e6:.1f} MB/s); {smi}")

        # --- 6. DeleteObjects reaches the EC volumes ---
        step = "6 delete"
        t0 = time.perf_counter()
        deleted = keys[::S3_DELETE_EVERY]
        doc = "".join(f"<Object><Key>{k}</Key></Object>" for k in deleted)
        status, _, body = one("POST", f"/{S3_BUCKET}", query={"delete": ""},
                              body=f"<Delete>{doc}</Delete>".encode())
        said = sorted(el.findtext("Key") for el in _s3_xml(body).iter("Deleted")) \
            if status == 200 else []
        if said != deleted:
            fail(f"DeleteObjects of {len(deleted)} keys: {status}, {len(said)} deleted "
                 f"{body[:300]!r}")

        def no_such_key(c, key):
            status, _, body = _s3_request(c, "GET", f"/{S3_BUCKET}/{key}")
            if status != 404 or _s3_xml(body).findtext("Code") != "NoSuchKey":
                fail(f"GET of the deleted {key}: {status} {body[:300]!r}")

        _fan(gport, S3_CLIENTS, deleted, no_such_key)
        gone_fids = [f for k in deleted for f in fids[k]]

        def chunks_gone() -> bool:
            for fid in gone_fids:
                for port in ports:
                    try:
                        urllib.request.urlopen(f"http://127.0.0.1:{port}/{fid}",
                                               timeout=30).close()
                        return False
                    except urllib.error.HTTPError as e:
                        if e.code != 404:
                            return False
            return True

        run.wait(chunks_gone, "3k step 6: 404 for every deleted chunk on every holder", 120)
        live = [k for k in keys if k not in set(deleted)]
        walls["delete"] = time.perf_counter() - t0
        log(f"3k s3: {len(deleted)} objects ({sum(sizes[k] for k in deleted)} B, "
            f"{len(gone_fids)} chunks) deleted by one DeleteObjects; each answers 404 "
            f"NoSuchKey and every chunk's fid 404 on all three holders, in "
            f"{walls['delete']:.3f} s")

        # --- 7. a holder killed, degraded reads through the gateway ---
        step = "7 degraded read"
        order = sorted(held, key=lambda i: -sum(map(len, held[i].values())))
        victim = order[1]
        lost = {vid: set(s) for vid, s in held[victim].items()}
        touched, touched_fids = [], []
        for key in live:
            for fid in fids[key]:
                vid_s, rest = fid.split(",")
                vid, nid = int(vid_s), int(rest[:-8], 16)
                dat_size, needles = vols[vid]
                off, size = needles[nid]
                shards = {iv.to_shard_id_and_offset()[0] for iv in locate.locate_data(
                    locate.LARGE_BLOCK_SIZE, locate.SMALL_BLOCK_SIZE, dat_size, off,
                    16 + size + 4 + 8)}
                if shards & lost.get(vid, set()):
                    touched.append(key)
                    if len(fids[key]) == 1:
                        touched_fids.append((key, fid))
                    break
        if not touched_fids:
            fail(f"no live one-chunk object has bytes on shards {lost}")
        run.procs[f"volume{victim}"].send_signal(signal.SIGKILL)
        run.rcs[f"volume{victim}"] = run.procs[f"volume{victim}"].wait(30)
        k0 = server_launches()
        walls["read_degraded"] = read_all(live, "degraded read")
        k1 = server_launches()
        degraded = launch_delta(k0, k1)
        if on_card:
            _must_launch("3k s3 degraded reads", degraded, ("gf_apply",))
        # every survivor holds shards of the touched volumes, and its K1
        # launches must rise. One that served no degraded interval
        # through the filer (the filer picked the other holder) is asked
        # for a one-chunk object with bytes on the lost shards directly.
        direct = {}
        for i in sorted(k1):
            served = k1[i]["degraded"] - k0[i]["degraded"]
            if served == 0:
                key, fid = touched_fids[len(direct) % len(touched_fids)]
                with urllib.request.urlopen(f"http://127.0.0.1:{ports[i]}/{fid}",
                                            timeout=60) as r:
                    body = r.read()
                if body != objects[key]:
                    fail(f"volume{i}'s GET of {fid} ({key}) gave {len(body)} B, want "
                         f"{sizes[key]} B")
                direct[i] = fid
                k1[i] = server_launches()[i]
                served = k1[i]["degraded"] - k0[i]["degraded"]
            if served == 0:
                fail(f"volume{i} served no degraded interval, even asked for "
                     f"{direct.get(i)} directly")
            if on_card and k1[i]["gf_apply"] <= k0[i]["gf_apply"]:
                fail(f"volume{i} served {served} degraded intervals but its K1 launches did "
                     f"not rise ({k0[i]['gf_apply']} -> {k1[i]['gf_apply']})")
        live_bytes = sum(sizes[k] for k in live)
        runs["s3_degraded"] = {"wall_s": walls["read_degraded"], "launches": degraded,
                               "sigs": {}, "objects": len(live), "touched": len(touched)}
        maps_seen.append(gateway_maps())
        log(f"3k s3 degraded reads on {card}: volume{victim} (shards "
            f"{ {v: sorted(s) for v, s in lost.items()} }) SIGKILLed; {len(live)} live objects "
            f"({live_bytes} B) read back through the gateway, {len(touched)} of them with "
            f"bytes on its shards, byte for byte, 0 errors, in {walls['read_degraded']:.3f} s "
            f"({live_bytes / walls['read_degraded'] / 1e6:.1f} MB/s); the survivors' "
            f"launches {degraded} ({ {i: k1[i]['gf_apply'] - k0[i]['gf_apply'] for i in k1} } "
            f"K1 and { {i: k1[i]['degraded'] - k0[i]['degraded'] for i in k1} } degraded "
            f"intervals by server, each rising; asked directly: {direct}); {smi}")

        # --- 8. the gateway's process, then SIGTERM ---
        step = "8 processes"
        if any(any(m.values()) for m in maps_seen):
            fail(f"the gateway process maps {maps_seen}")
        run.rcs["shell"] = shell.exit()
        if run.rcs["shell"]:
            fail(f"the shell exited {run.rcs['shell']}")
        runs["s3"] = {"walls": walls, "objects": len(objects), "deleted": len(deleted),
                      "touched": len(touched), "bytes": total}
    finally:
        if shell is not None and shell.proc.poll() is None:
            shell.proc.kill()
        rcs = run.finish()
    bad = {n: rc for n, rc in rcs.items() if rc != 0 and n != f"volume{victim}"}
    walls["phase"] = time.perf_counter() - phase_t0
    log(f"3k s3: SIGTERM, exit codes {rcs} (the SIGKILLed holder aside, each must be 0); "
        f"libcuda/libtorch mapped by the gateway {maps_seen}; "
        f"step walls (s) { {k: round(v, 3) for k, v in walls.items()} } on {card}; {smi}")
    if bad:
        raise AssertionError(f"3k s3, step 8 processes: processes exited non-zero {bad}: "
                             f"{ {n: run.tail(n) for n in bad if n != 'shell'} }")
    return runs


WEBDAV_ROOM = 2 << 30  # the WebDAV/tier phase's peak in its directory (about 1.3 GiB)
WEBDAV_BYTES = 128 << 20  # 3l's files besides the big one, as 3k's S3_BYTES
WEBDAV_BIG_BYTES = 40 << 20  # one file the filer cuts into two chunks at -maxMB 32
WEBDAV_CLIENTS = 4  # client threads of the fill and of every read pass
WEBDAV_DELETE_EVERY = 10  # every 10th live file deleted through WebDAV
TIER_BUCKET = "volume-tier"  # the bucket `s3.default` names in master.toml
TIER_ACCESS, TIER_SECRET = "AKIDTIER", "tier-secret-key"  # the gateway's one identity
TIER_DAT_BYTES = 32 << 20  # the sealed plain volume step d moves to the bucket
TIER_EC_BYTES = 32 << 20  # the volume step e encodes and tiers
QUERY_NEEDLES = 256  # step c's needles, two JSON lines each
QUERY_FILTERS = (("name", "=", "alice"), ("n", ">", "9"), ("name", "%", "a*"),
                 ("f", ">", "1.5"), ("n", "=", "5"))
QUERY_SELECT = ("name", "n", "tag.k")


def _dav(conn, method: str, path: str, body: bytes | None = None,
         headers: dict | None = None) -> tuple[int, dict, bytes]:
    """One WebDAV request on the keep-alive connection `conn`, the path
    quoted as the gateway's hrefs are."""
    import urllib.parse

    return _http(conn, method, urllib.parse.quote(path), body, headers)


def _query_needles(seed: int, n: int) -> list:
    """n needles of two JSON lines each, drawn from `seed`: a string, an
    int, a float and, in about half the lines, a nested field. Each is at
    most 128 B, so the volume server stores it as it is (a text body over
    128 B is gzipped on write, and Query reads a needle's stored bytes)."""
    rng = np.random.default_rng(seed)
    names = ("ann", "bob", "alice", "al", "cat", "dan")
    out = []
    for _ in range(n):
        lines = []
        for _ in range(2):
            row = {"name": names[int(rng.integers(0, len(names)))],
                   "n": int(rng.integers(0, 20)), "f": float(np.round(rng.uniform(-5, 5), 2))}
            if rng.integers(0, 2):
                row["tag"] = {"k": str(int(rng.integers(0, 4)))}
            lines.append(json.dumps(row, separators=(",", ":")))
        out.append("\n".join(lines).encode())
    return out


def _plain_query(line: str, flt: tuple, select) -> list | None:
    """The plain reading of one JSON line: None unless it passes the
    filter (field, op, value) with op one of =, > (a string field
    compared as a string, a number as a number) or % (a glob on a string
    field), else the values of the dotted paths in `select` (None where
    absent)."""
    import fnmatch

    doc = json.loads(line)

    def pick(path: str):
        cur = doc
        for seg in path.split("."):
            if not isinstance(cur, dict) or seg not in cur:
                return None
            cur = cur[seg]
        return cur

    field, op, value = flt
    v = pick(field)
    if isinstance(v, str):
        passed = {"=": v == value, ">": v > value, "%": fnmatch.fnmatchcase(v, value)}[op]
    elif isinstance(v, (int, float)):
        passed = {"=": v == float(value), ">": v > float(value)}.get(op, False)
    else:
        passed = False
    return [pick(p) for p in select] if passed else None


def _own_fids(vid: int, n: int, seed: int) -> list:
    """n file ids on volume `vid`, keys from 2^36 up (above what the
    master's sequencer hands out in this phase), cookies from `seed`."""
    from seaweedfs_tpu_torch.storage.file_id import format_needle_id_cookie

    rng = np.random.default_rng(seed)
    return [f"{vid},{format_needle_id_cookie((1 << 36) + i, int(rng.integers(1, 1 << 32)))}"
            for i in range(n)]


def run_webdav_tier_phase(workdir: str, volume_bytes: int, seed: int, device=None,
                          card: str = "", smi: str = "", big_bytes: int = WEBDAV_BIG_BYTES,
                          dat_bytes: int = TIER_DAT_BYTES,
                          ec_bytes: int = TIER_EC_BYTES) -> dict:
    """WebDAV, the Query verb and the s3 tier backend (ROADMAP item 11c)
    over a cluster whose volume servers decode on the card, every process
    `python -m seaweedfs_tpu_torch` in a directory of its own under
    `workdir` (/dev/shm), on `device` (None: the card; "cpu" runs the
    volume servers with -ec.codec cpu, a rehearsal):
      a. a master (-telemetryInterval 1, -repairInterval 0,
         -volumeSizeLimitMB 1152), three `volume` servers (racks 0/1/0)
         whose master.toml names `s3.default` (bucket TIER_BUCKET on the
         gateway below), a `filer -store lsm -collection webdav` (-maxMB
         32), an `s3 -config` gateway with one identity (the tier target)
         and a `webdav -filer -master`; MKCOL a tree 1-3 levels deep and
         PUT into it from WEBDAV_CLIENTS threads `volume_bytes` of files
         log-uniform over 1 KiB-4 MiB from the seed and one of
         `big_bytes`; MOVE a directory; COPY of a directory answers 501
         (the reference's gateway copies files only), so its files are
         copied one by one; PROPFIND Depth 0 and 1 of every directory
         list exactly the tree; every file GET back, SHA-256 equal; the
         gateway an up scrape target of kind webdav;
      b. ec.encode -collection webdav -fullPercent 0 and ec.balance
         -force through a `shell` process (K1 + K4 on the servers'
         cards, off their /metrics); every file GET again; the holder
         with the second most shards SIGKILLed and every live file GET
         degraded, 0 errors; each survivor that holds shards of a touched
         volume shows K1 rising (one the filer sent no degraded read is
         asked for a file on the lost shards directly); then every
         WEBDAV_DELETE_EVERY-th live file DELETEd: each GET 404 through
         WebDAV, its chunks 404 on every live holder;
      c. QUERY_NEEDLES needles of JSON lines POSTed into one plain volume
         and the Query verb over gRPC for each of QUERY_FILTERS with the
         projection QUERY_SELECT: the stripes equal the plain reading of
         the same lines;
      d. a sealed plain volume of `dat_bytes` (config 1's mix) moved to
         the bucket by volume.tier.upload -dest s3.default: every needle
         GET equal over ranged GETs against the gateway; volume.tier.download
         brings the .dat back byte-identical to a copy saved first;
      e. one more volume of `ec_bytes` encoded by ec.encode -volumeId
         (K1 + K4) and its shards moved to the bucket by tier.move -dest
         s3.default on every holder; every needle GET through the holder
         with the most shards, healthy; the objects of shards LOST deleted
         through the S3 API; every needle GET again, equal, decoded from
         the remote survivors: that holder's K1 launches and
         weed_tier_remote_read_total rise on its /metrics;
      f. neither gateway maps libcuda or torch; SIGTERM ends every process
         with exit code 0 (the killed holder aside); each step's wall and
         MB/s printed beside the card's name and power limit.
    Raises naming 3l and the step on any fault; returns webdav_encode,
    webdav_degraded, tier_encode and tier_degraded with the volume
    servers' launches."""
    import hashlib
    import signal
    import urllib.parse

    from seaweedfs_tpu_torch.ec import locate
    from seaweedfs_tpu_torch.pb import filer_pb2 as fpb
    from seaweedfs_tpu_torch.pb import rpc
    from seaweedfs_tpu_torch.pb import volume_pb2 as vpb
    from seaweedfs_tpu_torch.s3api.client import S3Client, S3ClientError
    from seaweedfs_tpu_torch.shell import CommandEnv
    from seaweedfs_tpu_torch.storage.volume import scan_volume_file
    from seaweedfs_tpu_torch.util.availability import free_port

    _check_room(workdir, WEBDAV_ROOM if volume_bytes >= 1 << 27
                else 4 * (volume_bytes + big_bytes + dat_bytes + ec_bytes) + (1 << 27),
                "phase 3l")
    on_card = device is None
    env = {k: v for k, v in os.environ.items() if k != "WEED_EC_CODEC"}
    if not on_card:
        env["WEED_EC_CODEC"] = "cpu"
    codec_args = [] if on_card else ["-ec.codec", "cpu"]
    run = _PhaseProcs("3l webdav/tier", workdir, env)
    step = "a start"

    def fail(msg: str):
        raise AssertionError(f"3l webdav/tier, step {step}: {msg}")

    phase_t0 = time.perf_counter()
    walls: dict = {}
    runs: dict = {}
    shell = None
    victim = None
    failed = None
    maps_seen: list = []
    mport, fport, gport, dport = free_port(), free_port(), free_port(), free_port()
    ports = [free_port() for _ in range(3)]
    dirs = [os.path.join(workdir, f"vs{i}") for i in range(3)]
    maddr, faddr, gaddr, daddr = (f"127.0.0.1:{p}" for p in (mport, fport, gport, dport))

    def home(name: str) -> str:
        d = os.path.join(workdir, "run", name)
        os.makedirs(d)
        return d

    def server_launches() -> dict:
        """Each live volume server's kernel launches, with "degraded" the
        EC intervals it served by reconstruction and "remote" its ranged
        tier reads."""
        out = {}
        for i in range(3):
            if f"volume{i}" not in run.rcs:
                m = _cli_metrics(ports[i])
                out[i] = dict(_cli_launches(m),
                              degraded=int(m.get("weed_ec_degraded_read_total", 0)),
                              remote=int(m.get("weed_tier_remote_read_total", 0)))
        return out

    def launch_delta(before: dict, after: dict) -> dict:
        return {k: sum(after[i][k] - before[i][k] for i in after) for k in _counts()}

    def gateway_maps() -> dict:
        return {name: _maps_has(run.procs[name].pid, "libcuda", "libtorch")
                for name in ("webdav", "s3")}

    def read_files(paths: list, label: str) -> float:
        def get(c, path):
            status, _, body = _dav(c, "GET", path)
            if status != 200 or hashlib.sha256(body).digest() != digests[path]:
                fail(f"{label}: GET {path} answered {status} with {len(body)} B, want "
                     f"{len(files[path])} B of SHA-256 {digests[path].hex()}")

        t0 = time.perf_counter()
        _fan(dport, WEBDAV_CLIENTS, paths, get)
        return time.perf_counter() - t0

    def post_needles(url: str, fids: list, bodies: list) -> float:
        host, _, port = url.rpartition(":")

        def post(c, item):
            fid, body = item
            status, _, reply = _http(c, "POST", f"/{fid}", body)
            if status != 201:
                fail(f"POST {fid} to {url}: {status} {reply[:300]!r}")

        t0 = time.perf_counter()
        _fan(int(port), WEBDAV_CLIENTS, list(zip(fids, bodies)), post)
        return time.perf_counter() - t0

    def read_needles(port: int, fids: list, bodies: list, label: str) -> float:
        digest = {fid: hashlib.sha256(b).digest() for fid, b in zip(fids, bodies)}

        def get(c, fid):
            status, _, body = _http(c, "GET", f"/{fid}")
            if status != 200 or hashlib.sha256(body).digest() != digest[fid]:
                fail(f"{label}: GET {fid} on :{port} answered {status} with {len(body)} B")

        t0 = time.perf_counter()
        _fan(port, WEBDAV_CLIENTS, fids, get)
        return time.perf_counter() - t0

    def assign(collection: str) -> tuple[int, str]:
        with urllib.request.urlopen(f"http://{maddr}/dir/assign?collection={collection}",
                                    timeout=60) as r:
            got = json.loads(r.read())
        if not got.get("fid"):
            fail(f"assign in {collection}: {got}")
        return int(got["fid"].split(",")[0]), got["url"]

    try:
        # --- a. the cluster, the gateways and the WebDAV fill ---
        t0 = time.perf_counter()
        s3_home = home("s3")
        identities = os.path.join(s3_home, "identities.toml")
        with open(identities, "w") as f:
            f.write(f'[[identities]]\nname = "tier"\naccess_key = "{TIER_ACCESS}"\n'
                    f'secret_key = "{TIER_SECRET}"\nactions = ["Admin"]\n')
        run.spawn("master", ["master", "-ip", "127.0.0.1", "-port", str(mport),
                             "-volumeSizeLimitMB", str(CLUSTER_LIMIT_MB), "-repairInterval",
                             "0", "-telemetryInterval", "1"], cwd=home("master"))
        run.wait(lambda: urllib.request.urlopen(f"http://{maddr}/cluster/status",
                                                timeout=2).close() is None, "the master")
        for i, d in enumerate(dirs):
            os.mkdir(d)
            cwd = home(f"volume{i}")
            with open(os.path.join(cwd, "master.toml"), "w") as f:
                f.write(f'[storage.backend.s3.default]\nenabled = true\n'
                        f'endpoint = "{gaddr}"\nbucket = "{TIER_BUCKET}"\n'
                        f'aws_access_key_id = "{TIER_ACCESS}"\n'
                        f'aws_secret_access_key = "{TIER_SECRET}"\n')
            run.spawn(f"volume{i}", ["volume", "-ip", "127.0.0.1", "-port", str(ports[i]),
                                     "-dir", d, "-max", "100", "-mserver", maddr,
                                     "-rack", f"rack{i % 2}", "-scrubInterval", "0"]
                      + codec_args, cwd=cwd)
        run.spawn("filer", ["filer", "-ip", "127.0.0.1", "-port", str(fport), "-master",
                            maddr, "-store", "lsm", "-storePath",
                            os.path.join(workdir, "filer-lsm"), "-collection", "webdav"],
                  cwd=home("filer"))
        run.spawn("s3", ["s3", "-ip", "127.0.0.1", "-port", str(gport), "-filer", faddr,
                         "-master", maddr, "-config", identities], cwd=s3_home)
        run.spawn("webdav", ["webdav", "-ip", "127.0.0.1", "-port", str(dport), "-filer",
                             faddr, "-master", maddr], cwd=home("webdav"))
        cenv = CommandEnv([maddr])
        run.wait(lambda: len(cenv.collect_topology().nodes) == 3, "three volume servers")

        def filer_up() -> bool:
            with urllib.request.urlopen(f"http://{faddr}/", timeout=5) as r:
                return r.status == 200

        def dav_up() -> bool:
            c = http.client.HTTPConnection("127.0.0.1", dport, timeout=10)
            try:
                status, headers, _ = _dav(c, "OPTIONS", "/")
            finally:
                c.close()
            return status == 200 and headers.get("DAV") == "1,2"

        run.wait(filer_up, "the filer")
        run.wait(dav_up, "OPTIONS with DAV 1,2 from the webdav gateway")
        tier = S3Client(gaddr, TIER_ACCESS, TIER_SECRET)
        run.wait(lambda: tier.create_bucket(TIER_BUCKET) is None,
                 f"the tier bucket {TIER_BUCKET} on the s3 gateway")
        walls["up"] = time.perf_counter() - t0

        step = "a fill"
        t0 = time.perf_counter()
        files = {f"/dav/{k}": b for k, b in _s3_objects(volume_bytes, seed + 190).items()}
        files["/dav/big/big.bin"] = np.random.default_rng(seed + 191).bytes(big_bytes)
        make_s = time.perf_counter() - t0

        def tree_dirs() -> list:
            out = {p[:i] for p in files for i in range(len("/dav"), len(p)) if p[i] == "/"}
            return sorted(out, key=lambda d: (d.count("/"), d))

        t0 = time.perf_counter()
        c = http.client.HTTPConnection("127.0.0.1", dport, timeout=120)
        try:
            for d in tree_dirs():
                status, _, body = _dav(c, "MKCOL", d)
                if status != 201:
                    fail(f"MKCOL {d}: {status} {body[:200]!r}")
            status, _, _ = _dav(c, "MKCOL", "/dav")
            if status != 405:
                fail(f"MKCOL of the existing /dav: {status}, want 405")
        finally:
            c.close()
        walls["mkcol"] = time.perf_counter() - t0

        def put(c, path):
            status, _, body = _dav(c, "PUT", path, files[path])
            if status != 201:
                fail(f"PUT {path}: {status} {body[:300]!r}")

        t0 = time.perf_counter()
        _fan(dport, WEBDAV_CLIENTS, sorted(files), put)
        walls["fill"] = time.perf_counter() - t0
        total = sum(map(len, files.values()))

        step = "a move and copy"
        t0 = time.perf_counter()
        tops = sorted({p.split("/")[2] for p in files if p.count("/") > 2})
        moved_from, moved_to = f"/dav/{tops[-1]}", "/dav/moved"
        c = http.client.HTTPConnection("127.0.0.1", dport, timeout=120)
        try:
            status, _, body = _dav(c, "MOVE", moved_from,
                                   headers={"Destination": f"http://{daddr}{moved_to}"})
            if status != 201:
                fail(f"MOVE {moved_from} -> {moved_to}: {status} {body[:200]!r}")
            files = {(moved_to + p[len(moved_from):] if p.startswith(moved_from + "/")
                      else p): b for p, b in files.items()}
            status, _, _ = _dav(c, "GET", moved_from)
            if status != 404:
                fail(f"GET of the moved {moved_from}: {status}, want 404")
            leaves = {}
            for p, b in files.items():
                leaves.setdefault(p.rpartition("/")[0], []).append(p)
            copied_from = min((d for d in leaves if d != "/dav/big"),
                              key=lambda d: sum(len(files[p]) for p in leaves[d]))
            copied_to = "/dav/copied"
            status, _, _ = _dav(c, "COPY", copied_from,
                                headers={"Destination": f"http://{daddr}{copied_to}"})
            if status != 501:
                fail(f"COPY of the directory {copied_from}: {status}, want 501 (the "
                     f"reference's gateway copies files only)")
            status, _, _ = _dav(c, "MKCOL", copied_to)
            if status != 201:
                fail(f"MKCOL {copied_to}: {status}")
            for p in sorted(leaves[copied_from]):
                dst = copied_to + p[len(copied_from):]
                status, _, body = _dav(c, "COPY", p,
                                       headers={"Destination": f"http://{daddr}{dst}"})
                if status != 201:
                    fail(f"COPY {p} -> {dst}: {status} {body[:200]!r}")
                files[dst] = files[p]
        finally:
            c.close()
        walls["move_copy"] = time.perf_counter() - t0

        step = "a propfind"
        t0 = time.perf_counter()
        sizes = {p: len(b) for p, b in files.items()}
        digests = {p: hashlib.sha256(b).digest() for p, b in files.items()}
        all_dirs = tree_dirs()

        def listing(c, d: str, depth: str) -> list:
            status, _, body = _dav(c, "PROPFIND", d, headers={"Depth": depth})
            if status != 207:
                fail(f"PROPFIND {d} Depth {depth}: {status} {body[:200]!r}")
            out = []
            for r in _s3_xml(body).iter("response"):
                prop = r.find("propstat/prop")
                coll = prop.find("resourcetype/collection") is not None
                size = prop.findtext("getcontentlength")
                out.append((urllib.parse.unquote(r.findtext("href")), coll,
                            None if size is None else int(size)))
            return out

        def check_dir(c, d: str) -> None:
            kids = {p[len(d) + 1:].split("/")[0] for p in files if p.startswith(d + "/")}
            want = [(d + "/", True, None)] + sorted(
                (f"{d}/{k}/", True, None) if f"{d}/{k}" in set(all_dirs)
                else (f"{d}/{k}", False, sizes[f"{d}/{k}"]) for k in kids)
            got = listing(c, d, "1")
            if got[:1] + sorted(got[1:]) != want:
                fail(f"PROPFIND {d} Depth 1 lists {got[:6]}..., want {want[:6]}...")
            if listing(c, d, "0") != [(d + "/", True, None)]:
                fail(f"PROPFIND {d} Depth 0 is not the collection alone")

        _fan(dport, WEBDAV_CLIENTS, all_dirs, check_dir)
        health: dict = {}

        def gateway_target() -> bool:
            with urllib.request.urlopen(f"http://{maddr}/cluster/health", timeout=10) as r:
                health.update(json.loads(r.read())["Targets"].get(daddr, {}))
            return bool(health.get("Up")) and health.get("Kind") == "webdav"

        scraped_s = run.wait(gateway_target,
                             "the webdav gateway as an up scrape target of kind webdav", 60)
        walls["propfind"] = time.perf_counter() - t0

        step = "a healthy read"
        paths = sorted(files)
        walls["read_healthy"] = read_files(paths, "healthy read")
        total = sum(sizes.values())
        with rpc.dial(f"127.0.0.1:{fport + 10000}") as ch:
            stub = rpc.filer_stub(ch)

            def chunk_fids(path: str) -> list:
                d, _, name = path.rpartition("/")
                resp = stub.LookupDirectoryEntry(
                    fpb.LookupDirectoryEntryRequest(directory=d, name=name), timeout=30)
                return [chunk.fid for chunk in resp.entry.chunks]

            fids = {p: chunk_fids(p) for p in paths}
        if len(fids["/dav/big/big.bin"]) != -(-big_bytes // (32 << 20)):
            fail(f"the big file holds {len(fids['/dav/big/big.bin'])} chunks")
        maps_seen.append(gateway_maps())
        log(f"3l webdav/tier: master, three volume servers (s3.default in their "
            f"master.toml), `filer -store lsm -collection webdav`, `s3 -config` and "
            f"`webdav` up in {walls['up']:.3f} s; {len(all_dirs)} collections by MKCOL in "
            f"{walls['mkcol']:.3f} s; {len(paths) - len(leaves[copied_from])} files, "
            f"{total - sum(sizes[p] for p in paths if p.startswith('/dav/copied/'))} B "
            f"(payloads made in {make_s:.3f} s) PUT from {WEBDAV_CLIENTS} threads in "
            f"{walls['fill']:.3f} s ({(total - sum(sizes[p] for p in paths if p.startswith('/dav/copied/'))) / walls['fill'] / 1e6:.1f} MB/s); "
            f"MOVE {moved_from} -> {moved_to}, COPY of {copied_from} 501 and its "
            f"{len(leaves[copied_from])} files copied one by one to {copied_to} in "
            f"{walls['move_copy']:.3f} s; PROPFIND Depth 1 and 0 of {len(all_dirs)} "
            f"collections equal to the tree and the gateway an up scrape target of kind "
            f"{health.get('Kind')} ({scraped_s:.3f} s) in {walls['propfind']:.3f} s; "
            f"{len(paths)} files ({total} B, {sum(map(len, fids.values()))} chunks) read "
            f"back healthy (SHA-256) in {walls['read_healthy']:.3f} s "
            f"({total / walls['read_healthy'] / 1e6:.1f} MB/s); {smi}")

        # --- b. ec.encode and ec.balance, a holder lost, deletes ---
        step = "b encode"
        vols = {}
        for d in dirs:
            for f in os.listdir(d):
                if f.startswith("webdav_") and f.endswith(".dat"):
                    path = os.path.join(d, f)
                    vols[int(f[7:-4])] = (os.path.getsize(path), {
                        nd.id: (off, nd.size) for nd, off in scan_volume_file(path)})
        shell = _CliShell(run.cli + ["shell", "-master", maddr], env,
                          os.path.join(run.logs, "shell.log"), cwd=home("shell"))
        run.procs["shell"] = shell.proc
        k0 = server_launches()
        t0 = time.perf_counter()
        _, text = shell.run("ec.encode -collection webdav -fullPercent 0")
        if text.count("ec encoded volume") != len(vols):
            fail(f"ec.encode: {text[-2000:]} over volumes {sorted(vols)}")
        shell.run("ec.balance -force")
        walls["encode_balance"] = time.perf_counter() - t0
        k1 = server_launches()
        encode_launches = launch_delta(k0, k1)
        if on_card:
            _must_launch("3l webdav/tier, step b ec.encode", encode_launches,
                         ("gf_apply", "crc32c_rows"))
        held: dict = {i: {} for i in range(3)}
        for i, d in enumerate(dirs):
            for f in os.listdir(d):
                if f.startswith("webdav_") and ".ec" in f and f[-2:].isdigit():
                    held[i].setdefault(int(f[7:].split(".")[0]), []).append(int(f[-2:]))
        runs["webdav_encode"] = {"wall_s": walls["encode_balance"],
                                 "launches": encode_launches, "sigs": {}}
        walls["read_encoded"] = read_files(paths, "read after ec.encode")
        log(f"3l webdav/tier ec.encode -collection webdav of {len(vols)} volumes and "
            f"ec.balance -force through the shell in {walls['encode_balance']:.3f} s, the "
            f"servers' launches {encode_launches} "
            f"({ {i: (k1[i]['gf_apply'] - k0[i]['gf_apply'], k1[i]['crc32c_rows'] - k0[i]['crc32c_rows']) for i in k1} } "
            f"K1/K4 by server); shards by server "
            f"{ {i: sum(map(len, h.values())) for i, h in held.items()} }; {len(paths)} files "
            f"read back in {walls['read_encoded']:.3f} s "
            f"({total / walls['read_encoded'] / 1e6:.1f} MB/s); {smi}")

        step = "b degraded read"
        order = sorted(held, key=lambda i: -sum(map(len, held[i].values())))
        victim = order[1]
        lost = {vid: set(s) for vid, s in held[victim].items()}
        touched, touched_fids = [], []
        for path in paths:
            for fid in fids[path]:
                vid_s, rest = fid.split(",")
                vid, nid = int(vid_s), int(rest[:-8], 16)
                dat_size, needles = vols[vid]
                off, size = needles[nid]
                shards = {iv.to_shard_id_and_offset()[0] for iv in locate.locate_data(
                    locate.LARGE_BLOCK_SIZE, locate.SMALL_BLOCK_SIZE, dat_size, off,
                    16 + size + 4 + 8)}
                if shards & lost.get(vid, set()):
                    touched.append(path)
                    if len(fids[path]) == 1:
                        touched_fids.append((path, fid))
                    break
        if not touched_fids:
            fail(f"no one-chunk file has bytes on shards {lost}")
        touched_vids = {int(fid.split(",")[0]) for _, fid in touched_fids}
        run.procs[f"volume{victim}"].send_signal(signal.SIGKILL)
        run.rcs[f"volume{victim}"] = run.procs[f"volume{victim}"].wait(30)
        k0 = server_launches()
        walls["read_degraded"] = read_files(paths, "degraded read")
        k1 = server_launches()
        degraded = launch_delta(k0, k1)
        if on_card:
            _must_launch("3l webdav/tier, step b degraded reads", degraded, ("gf_apply",))
        # every survivor holding shards of a touched volume must decode on
        # its card; one the filer sent no degraded read is asked directly
        # for a one-chunk file of such a volume with bytes on the lost shards
        direct = {}
        for i in sorted(k1):
            mine = [(p, fid) for p, fid in touched_fids
                    if int(fid.split(",")[0]) in held[i]]
            if not mine:
                continue
            served = k1[i]["degraded"] - k0[i]["degraded"]
            if served == 0:
                path, fid = mine[0]
                with urllib.request.urlopen(f"http://127.0.0.1:{ports[i]}/{fid}",
                                            timeout=60) as r:
                    body = r.read()
                if body != files[path]:
                    fail(f"volume{i}'s GET of {fid} ({path}) gave {len(body)} B, want "
                         f"{sizes[path]} B")
                direct[i] = fid
                k1[i] = server_launches()[i]
                served = k1[i]["degraded"] - k0[i]["degraded"]
            if served == 0:
                fail(f"volume{i} served no degraded interval, even asked for "
                     f"{direct.get(i)} directly")
            if on_card and k1[i]["gf_apply"] <= k0[i]["gf_apply"]:
                fail(f"volume{i} served {served} degraded intervals but its K1 launches did "
                     f"not rise ({k0[i]['gf_apply']} -> {k1[i]['gf_apply']})")
        runs["webdav_degraded"] = {"wall_s": walls["read_degraded"], "launches": degraded,
                                   "sigs": {}, "files": len(paths), "touched": len(touched)}
        log(f"3l webdav/tier degraded reads on {card}: volume{victim} (shards "
            f"{ {v: sorted(s) for v, s in lost.items()} }) SIGKILLed; {len(paths)} files "
            f"({total} B) read back through WebDAV, {len(touched)} of them with bytes on its "
            f"shards (volumes {sorted(touched_vids)}), byte for byte, 0 errors, in "
            f"{walls['read_degraded']:.3f} s ({total / walls['read_degraded'] / 1e6:.1f} "
            f"MB/s); the survivors' launches {degraded} "
            f"({ {i: k1[i]['gf_apply'] - k0[i]['gf_apply'] for i in k1} } K1 and "
            f"{ {i: k1[i]['degraded'] - k0[i]['degraded'] for i in k1} } degraded intervals "
            f"by server; asked directly: {direct}); {smi}")

        step = "b delete"
        t0 = time.perf_counter()
        deleted = paths[::WEBDAV_DELETE_EVERY]

        def delete(c, path):
            status, _, body = _dav(c, "DELETE", path)
            if status != 204:
                fail(f"DELETE {path}: {status} {body[:200]!r}")
            status, _, _ = _dav(c, "GET", path)
            if status != 404:
                fail(f"GET of the deleted {path}: {status}, want 404")

        _fan(dport, WEBDAV_CLIENTS, deleted, delete)
        gone_fids = [f for p in deleted for f in fids[p]]
        live_ports = [ports[i] for i in range(3) if i != victim]

        def chunks_gone() -> bool:
            for fid in gone_fids:
                for port in live_ports:
                    try:
                        urllib.request.urlopen(f"http://127.0.0.1:{port}/{fid}",
                                               timeout=30).close()
                        return False
                    except urllib.error.HTTPError as e:
                        if e.code != 404:
                            return False
            return True

        run.wait(chunks_gone, "404 for every deleted chunk on every live holder", 120)
        walls["delete"] = time.perf_counter() - t0
        log(f"3l webdav/tier: {len(deleted)} files ({sum(sizes[p] for p in deleted)} B, "
            f"{len(gone_fids)} chunks) DELETEd through WebDAV, each GET 404 and every "
            f"chunk's fid 404 on both live holders, in {walls['delete']:.3f} s")

        # --- c. the Query verb over JSON-lines needles ---
        step = "c query"
        t0 = time.perf_counter()
        qvid, qurl = assign("query")
        qbodies = _query_needles(seed + 192, QUERY_NEEDLES)
        if max(map(len, qbodies)) > 128:
            fail(f"a query needle is {max(map(len, qbodies))} B (over 128 B it is gzipped)")
        qfids = _own_fids(qvid, len(qbodies), seed + 193)
        post_needles(qurl, qfids, qbodies)
        answers = {}
        with rpc.dial(rpc.grpc_address(qurl)) as ch:
            vstub = rpc.volume_stub(ch)
            for flt in QUERY_FILTERS:
                stripes = [s.records for s in vstub.Query(vpb.QueryRequest(
                    selections=list(QUERY_SELECT), from_file_ids=qfids,
                    filter=vpb.QueryRequest.Filter(field=flt[0], operand=flt[1],
                                                   value=flt[2])), timeout=60)]
                want = []
                for body in qbodies:
                    rows = [r for r in (_plain_query(line, flt, QUERY_SELECT)
                                        for line in body.decode().splitlines())
                            if r is not None]
                    if rows:
                        want.append(("\n".join(map(json.dumps, rows)) + "\n").encode())
                if stripes != want or not want:
                    fail(f"Query {flt}: {len(stripes)} stripes {stripes[:2]}, want "
                         f"{len(want)} {want[:2]}")
                answers["".join(flt)] = sum(s.count(b"\n") for s in stripes)
        walls["query"] = time.perf_counter() - t0
        log(f"3l webdav/tier Query: {len(qbodies)} needles of two JSON lines POSTed into "
            f"plain volume {qvid} on {qurl}; the Query verb over gRPC with the projection "
            f"{list(QUERY_SELECT)}: rows {answers} by filter, every stripe equal to the plain "
            f"reading of the lines, in {walls['query']:.3f} s")

        # --- d. a sealed .dat moved to the bucket and back ---
        step = "d dat tier"
        t0 = time.perf_counter()
        dvid, durl = assign("tierdat")
        dbodies = list(_s3_objects(dat_bytes, seed + 194).values())
        dfids = _own_fids(dvid, len(dbodies), seed + 195)
        post_needles(durl, dfids, dbodies)
        dport_v = int(durl.rpartition(":")[2])
        dat = os.path.join(dirs[ports.index(dport_v)], f"tierdat_{dvid}.dat")
        saved = os.path.join(workdir, "tierdat.saved")
        shutil.copyfile(dat, saved)
        dat_size = os.path.getsize(saved)
        walls["dat_fill"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        _, text = shell.run(f"volume.tier.upload -volumeId {dvid} -dest s3.default")
        walls["dat_upload"] = time.perf_counter() - t0
        if f"volume {dvid} dat moved to s3.default" not in text or os.path.exists(dat) \
                or not os.path.exists(dat[:-4] + ".vif"):
            fail(f"volume.tier.upload: {text[-1000:]}; .dat there {os.path.exists(dat)}")
        walls["dat_read_remote"] = read_needles(dport_v, dfids, dbodies,
                                                "read of the tiered .dat")
        t0 = time.perf_counter()
        _, text = shell.run(f"volume.tier.download -volumeId {dvid}")
        walls["dat_download"] = time.perf_counter() - t0
        if f"volume {dvid} dat restored locally" not in text or not filecmp.cmp(
                saved, dat, shallow=False):
            fail(f"volume.tier.download: {text[-1000:]}; the .dat is not byte-identical to "
                 f"the copy saved before the upload")
        log(f"3l webdav/tier .dat tier: volume {dvid} ({len(dbodies)} needles, {dat_size} B "
            f"of .dat) on {durl} moved to s3.default (bucket {TIER_BUCKET} on the gateway) "
            f"by volume.tier.upload in {walls['dat_upload']:.3f} s "
            f"({dat_size / walls['dat_upload'] / 1e6:.1f} MB/s); every needle read over "
            f"ranged GETs in {walls['dat_read_remote']:.3f} s; volume.tier.download in "
            f"{walls['dat_download']:.3f} s, the .dat byte-identical to the saved copy")

        # --- e. an EC volume's shards in the bucket, four objects lost ---
        step = "e ec tier"
        t0 = time.perf_counter()
        evid, eurl = assign("tierec")
        ebodies = list(_s3_objects(ec_bytes, seed + 196).values())
        efids = _own_fids(evid, len(ebodies), seed + 197)
        post_needles(eurl, efids, ebodies)
        walls["ec_fill"] = time.perf_counter() - t0
        k0 = server_launches()
        t0 = time.perf_counter()
        _, text = shell.run(f"ec.encode -volumeId {evid}")
        walls["ec_encode"] = time.perf_counter() - t0
        if "ec encoded volume" not in text:
            fail(f"ec.encode -volumeId {evid}: {text[-1000:]}")
        k1 = server_launches()
        tier_encode = launch_delta(k0, k1)
        if on_card:
            _must_launch("3l webdav/tier, step e ec.encode", tier_encode,
                         ("gf_apply", "crc32c_rows"))
        runs["tier_encode"] = {"wall_s": walls["ec_encode"], "launches": tier_encode,
                               "sigs": {}}
        eheld = {}
        for i, d in enumerate(dirs):
            got = sorted(int(f[-2:]) for f in os.listdir(d)
                         if f.startswith(f"tierec_{evid}.ec") and f[-2:].isdigit())
            if got:
                eheld[i] = got
        if sorted(s for got in eheld.values() for s in got) != list(range(14)):
            fail(f"the encoded volume's shards are {eheld}")
        t0 = time.perf_counter()
        _, text = shell.run(f"tier.move -volumeId {evid} -dest s3.default")
        walls["tier_move"] = time.perf_counter() - t0
        keys = {}
        for i in eheld:
            base = os.path.join(dirs[i], f"tierec_{evid}")
            left = [f for f in os.listdir(dirs[i])
                    if f.startswith(f"tierec_{evid}.ec") and f[-2:].isdigit()]
            if left or not os.path.exists(base + ".evf"):
                fail(f"tier.move: volume{i} keeps {left}: {text[-1000:]}")
            with open(base + ".evf") as f:
                doc = json.load(f)
            if doc["backend"] != "s3.default" or sorted(map(int, doc["shards"])) != eheld[i]:
                fail(f"volume{i}'s .evf {doc}")
            keys.update({int(sid): info["key"] for sid, info in doc["shards"].items()})
        serving = max(eheld, key=lambda i: len(eheld[i]))
        sport = ports[serving]
        walls["ec_read_healthy"] = read_needles(sport, efids, ebodies,
                                                "healthy read of the tiered EC volume")
        t0 = time.perf_counter()
        for sid in LOST:
            tier.delete_object(TIER_BUCKET, keys[sid])
            try:
                tier.get_object(TIER_BUCKET, keys[sid], 0, 1)
                fail(f"shard {sid}'s object {keys[sid]} still answers after its DELETE")
            except S3ClientError as e:
                if e.status != 404:
                    fail(f"GET of shard {sid}'s deleted object: {e}")
        walls["objects_delete"] = time.perf_counter() - t0
        k0 = server_launches()
        walls["ec_read_degraded"] = read_needles(sport, efids, ebodies,
                                                 "degraded read of the tiered EC volume")
        k1 = server_launches()
        tier_degraded = launch_delta(k0, k1)
        rise = {k: k1[serving][k] - k0[serving][k] for k in ("gf_apply", "remote",
                                                               "degraded")}
        if rise["remote"] <= 0 or rise["degraded"] <= 0:
            fail(f"volume{serving} served the lost shards' bytes without remote reads or "
                 f"decodes: {rise}")
        if on_card and rise["gf_apply"] <= 0:
            fail(f"volume{serving} decoded {rise['degraded']} intervals but its K1 launches "
                 f"did not rise")
        runs["tier_degraded"] = {"wall_s": walls["ec_read_degraded"],
                                 "launches": tier_degraded, "sigs": {},
                                 "needles": len(efids)}
        ebytes = sum(map(len, ebodies))
        log(f"3l webdav/tier EC tier on {card}: volume {evid} ({len(ebodies)} needles, "
            f"{ebytes} B) encoded by ec.encode -volumeId in {walls['ec_encode']:.3f} s "
            f"(launches {tier_encode}), its shards {eheld} by holder moved to s3.default by "
            f"tier.move in {walls['tier_move']:.3f} s; every needle read through volume"
            f"{serving} healthy in {walls['ec_read_healthy']:.3f} s "
            f"({ebytes / walls['ec_read_healthy'] / 1e6:.1f} MB/s); the objects of shards "
            f"{list(LOST)} deleted through the S3 API; every needle read again, byte for "
            f"byte, in {walls['ec_read_degraded']:.3f} s "
            f"({ebytes / walls['ec_read_degraded'] / 1e6:.1f} MB/s): volume{serving}'s K1 "
            f"+{rise['gf_apply']}, decoded intervals +{rise['degraded']}, "
            f"weed_tier_remote_read_total +{rise['remote']}; {smi}")

        # --- f. the gateways' processes, then SIGTERM ---
        step = "f processes"
        maps_seen.append(gateway_maps())
        if any(any(m.values()) for ms in maps_seen for m in ms.values()):
            fail(f"a gateway process maps {maps_seen}")
        run.rcs["shell"] = shell.exit()
        if run.rcs["shell"]:
            fail(f"the shell exited {run.rcs['shell']}")
        runs["webdav"] = {"walls": walls, "files": len(paths), "deleted": len(deleted),
                          "touched": len(touched), "bytes": total}
    except Exception as e:  # noqa: BLE001 — re-raised below, named by its step
        failed = e
    finally:
        if shell is not None and shell.proc.poll() is None:
            shell.proc.kill()
        rcs = run.finish()
    if failed is not None:
        for name in run.procs:
            if name != "shell":
                log(f"3l webdav/tier: {name} exited {rcs.get(name)}; its log ends: "
                    f"{run.tail(name)[-1500:]!r}")
        if str(failed).startswith("3l webdav/tier, step"):
            raise failed
        raise AssertionError(f"3l webdav/tier, step {step}: {type(failed).__name__}: "
                             f"{failed}") from failed
    bad = {n: rc for n, rc in rcs.items() if rc != 0 and n != f"volume{victim}"}
    walls["phase"] = time.perf_counter() - phase_t0
    log(f"3l webdav/tier: SIGTERM, exit codes {rcs} (the SIGKILLed holder aside, each must "
        f"be 0); libcuda/libtorch mapped by the gateways {maps_seen}; step walls (s) "
        f"{ {k: round(v, 3) for k, v in walls.items()} } on {card}; {smi}")
    if bad:
        raise AssertionError(f"3l webdav/tier, step f processes: processes exited non-zero "
                             f"{bad}: { {n: run.tail(n) for n in bad if n != 'shell'} }")
    return runs


REPL_ROOM = 2 << 30  # the replication phase's peak in its directory (about 0.9 GiB)
REPL_BYTES = CUT_BYTES // 2  # 3m's files besides the big one, the cut 3k and 3l take
REPL_BIG_BYTES = 40 << 20  # one file the filer cuts into two chunks at -maxMB 32
REPL_CLIENTS = 4  # client threads of the fill and of the read back
REPL_PARTITIONS = 4  # the logqueue's partitions


def _repl_files(total: int, seed: int) -> dict:
    """{filer path: bytes} of about `total` bytes under /repl: files
    log-uniform over 1 KiB-1 MiB drawn from `seed`, nested 1-3
    directories deep (d0-d3 at each level)."""
    rng = np.random.default_rng(seed)
    out, left, i = {}, total, 0
    while left > 0:
        size = min(left, int(np.exp(rng.uniform(np.log(1024), np.log(1 << 20)))))
        depth = int(rng.integers(1, 4))
        d = "/".join(f"d{int(rng.integers(0, 4))}" for _ in range(depth))
        out[f"/repl/{d}/f{i:04d}.bin"] = rng.bytes(size)
        left -= size
        i += 1
    return out


def run_replication_phase(workdir: str, volume_bytes: int, seed: int, device=None,
                          card: str = "", smi: str = "",
                          big_bytes: int = REPL_BIG_BYTES) -> dict:
    """Filer-to-filer replication (ROADMAP item 12a) from a cluster whose
    volume servers decode on the card to a second cluster, every process
    `python -m seaweedfs_tpu_torch` in a directory of its own under
    `workdir` (/dev/shm), on `device` (None: the card; "cpu" runs the
    volume servers with -ec.codec cpu, a rehearsal):
      a. cluster A: a master (-telemetryInterval 1, -repairInterval 0,
         -volumeSizeLimitMB 1152), three `volume` servers (racks 0/1/0)
         and a `filer -store lsm -collection repl -maxMB 32` whose
         notification.toml enables the logqueue (REPL_PARTITIONS
         partitions); cluster B: a master, one `volume` server and a
         `filer -store lsm`;
      b. `volume_bytes` of files log-uniform over 1 KiB-1 MiB under /repl,
         1-3 directories deep, and one of `big_bytes` (two chunks), POSTed
         to filer A from REPL_CLIENTS threads; filer A's /metrics shows
         weed_replication_lag_events{group="replicate"} equal to the
         events the queue holds, at least one a file;
      c. ec.encode -collection repl -fullPercent 0 and ec.balance -force
         through a `shell` process (K1 + K4 on A's cards);
      d. the holder with the most shards among those holding at most 4 of
         every volume SIGKILLed;
      e. `filer.replicate -config` (sink.filer at filer B, /repl to
         /backup) as a process; filer A's lag gauge falls to 0 within a
         deadline; `replication.lag -json` on A's master reports filer A
         0 events behind and no firing replication_lag alert;
      f. every file read back from filer B, SHA-256 equal, 0 errors; the
         K1 launches of A's survivors rose (a survivor that holds shards
         of a volume the lost holder had and served no degraded interval
         is asked directly for a file on the lost shards); K1 and K5
         deltas printed;
      g. one top directory DELETEd recursively on A: every file under it
         answers 404 on B within a deadline;
      h. SIGTERM ends the runner with exit code 0; started again, it
         polls from the committed cursor: the lag stays 0 and no entry on
         B changes (its chunks' file ids are as they were), then one file
         written on A meanwhile reaches B; SIGTERM ends it with 0 again;
         neither the runner nor a filer maps libcuda or torch; SIGTERM
         ends every process with exit code 0 (the killed holder aside).
    Raises naming 3m and the step on any fault; returns repl_encode and
    repl_degraded with A's volume servers' launches."""
    import hashlib
    import signal
    import urllib.parse

    from seaweedfs_tpu_torch.ec import locate
    from seaweedfs_tpu_torch.notification.logqueue import PartitionedLogQueue
    from seaweedfs_tpu_torch.pb import filer_pb2 as fpb
    from seaweedfs_tpu_torch.pb import rpc
    from seaweedfs_tpu_torch.shell import CommandEnv
    from seaweedfs_tpu_torch.storage.volume import scan_volume_file
    from seaweedfs_tpu_torch.util.availability import free_port

    _check_room(workdir, REPL_ROOM if volume_bytes >= 1 << 27
                else 6 * (volume_bytes + big_bytes) + (1 << 27), "phase 3m")
    on_card = device is None
    env = {k: v for k, v in os.environ.items() if k != "WEED_EC_CODEC"}
    if not on_card:
        env["WEED_EC_CODEC"] = "cpu"
    codec_args = [] if on_card else ["-ec.codec", "cpu"]
    run = _PhaseProcs("3m replication", workdir, env)
    step = "a start"

    def fail(msg: str):
        raise AssertionError(f"3m replication, step {step}: {msg}")

    phase_t0 = time.perf_counter()
    walls: dict = {}
    runs: dict = {}
    shell = None
    victim = None
    failed = None
    maps_seen: list = []
    mport, fport, mport_b, fport_b = free_port(), free_port(), free_port(), free_port()
    ports = [free_port() for _ in range(3)]
    port_b = free_port()
    dirs = [os.path.join(workdir, f"vs{i}") for i in range(3)]
    maddr, faddr, maddr_b, faddr_b = (f"127.0.0.1:{p}" for p in (mport, fport, mport_b,
                                                                   fport_b))
    qdir = os.path.join(workdir, "logqueue")
    notification_toml = (f'[notification.logqueue]\nenabled = true\ndir = "{qdir}"\n'
                         f"partitions = {REPL_PARTITIONS}\n")

    def home(name: str) -> str:
        d = os.path.join(workdir, "run", name)
        os.makedirs(d)
        return d

    def server_launches() -> dict:
        """Each live volume server of A's kernel launches, with "degraded"
        the EC intervals it served by reconstruction."""
        out = {}
        for i in range(3):
            if f"volume{i}" not in run.rcs:
                m = _cli_metrics(ports[i])
                out[i] = dict(_cli_launches(m),
                              degraded=int(m.get("weed_ec_degraded_read_total", 0)))
        return out

    def launch_delta(before: dict, after: dict) -> dict:
        return {k: sum(after[i][k] - before[i][k] for i in after) for k in _counts()}

    def lag_gauge() -> float:
        return _cli_metrics(fport)['weed_replication_lag_events{group="replicate"}']

    def queue_events() -> tuple[int, int]:
        """(records the producer wrote, of which the "replicate" group has
        not committed past) from the queue's files."""
        q = PartitionedLogQueue(qdir, partitions=REPL_PARTITIONS)
        try:
            return (sum(p.refreshed_next_offset() for p in q.partitions),
                    q.depth("replicate"))
        finally:
            q.close()

    def spawn_runner(name: str) -> float:
        run.spawn(name, ["filer.replicate", "-config", repl_toml], cwd=runner_home)
        return time.time()

    def read_b(paths: list, label: str) -> float:
        def get(c, path):
            status, _, body = _http(c, "GET", urllib.parse.quote("/backup" + path[5:]))
            if status != 200 or hashlib.sha256(body).digest() != digests[path]:
                fail(f"{label}: GET {path} from filer B answered {status} with {len(body)} "
                     f"B, want {len(files[path])} B of SHA-256 {digests[path].hex()}")

        t0 = time.perf_counter()
        _fan(fport_b, REPL_CLIENTS, paths, get)
        return time.perf_counter() - t0

    def b_chunks() -> dict:
        """{path: chunk file ids} of every file on filer B under /backup."""
        out = {}
        with rpc.dial(f"127.0.0.1:{fport_b + 10000}") as ch:
            stub = rpc.filer_stub(ch)
            todo = ["/backup"]
            while todo:
                d = todo.pop()
                for r in stub.ListEntries(fpb.ListEntriesRequest(directory=d, limit=100000),
                                          timeout=60):
                    p = f"{d}/{r.entry.name}"
                    if r.entry.is_directory:
                        todo.append(p)
                    else:
                        out[p] = [c.fid for c in r.entry.chunks]
        return out

    def lag_report(shell_) -> dict:
        _, text = shell_.run("replication.lag -json")
        return json.loads(text.strip().splitlines()[-1])

    try:
        # --- a. the two clusters ---
        t0 = time.perf_counter()
        run.spawn("master", ["master", "-ip", "127.0.0.1", "-port", str(mport),
                             "-volumeSizeLimitMB", str(CLUSTER_LIMIT_MB), "-repairInterval",
                             "0", "-telemetryInterval", "1"], cwd=home("master"))
        run.spawn("master_b", ["master", "-ip", "127.0.0.1", "-port", str(mport_b),
                               "-volumeSizeLimitMB", str(CLUSTER_LIMIT_MB)],
                  cwd=home("master_b"))
        for m in (maddr, maddr_b):
            run.wait(lambda m=m: urllib.request.urlopen(f"http://{m}/cluster/status",
                                                        timeout=2).close() is None,
                     f"the master {m}")
        for i, d in enumerate(dirs):
            os.mkdir(d)
            run.spawn(f"volume{i}", ["volume", "-ip", "127.0.0.1", "-port", str(ports[i]),
                                     "-dir", d, "-max", "100", "-mserver", maddr,
                                     "-rack", f"rack{i % 2}", "-scrubInterval", "0"]
                      + codec_args, cwd=home(f"volume{i}"))
        os.mkdir(os.path.join(workdir, "vs_b"))
        run.spawn("volume_b", ["volume", "-ip", "127.0.0.1", "-port", str(port_b), "-dir",
                               os.path.join(workdir, "vs_b"), "-max", "100", "-mserver",
                               maddr_b, "-scrubInterval", "0"] + codec_args,
                  cwd=home("volume_b"))
        filer_home = home("filer")
        with open(os.path.join(filer_home, "notification.toml"), "w") as f:
            f.write(notification_toml)
        run.spawn("filer", ["filer", "-ip", "127.0.0.1", "-port", str(fport), "-master",
                            maddr, "-store", "lsm", "-storePath",
                            os.path.join(workdir, "filer-lsm"), "-collection", "repl",
                            "-maxMB", "32"], cwd=filer_home)
        run.spawn("filer_b", ["filer", "-ip", "127.0.0.1", "-port", str(fport_b), "-master",
                              maddr_b, "-store", "lsm", "-storePath",
                              os.path.join(workdir, "filer-b-lsm")], cwd=home("filer_b"))
        cenv, cenv_b = CommandEnv([maddr]), CommandEnv([maddr_b])
        run.wait(lambda: len(cenv.collect_topology().nodes) == 3, "A's three volume servers")
        run.wait(lambda: len(cenv_b.collect_topology().nodes) == 1, "B's volume server")
        for f_addr in (faddr, faddr_b):
            run.wait(lambda f_addr=f_addr: urllib.request.urlopen(
                f"http://{f_addr}/", timeout=5).status == 200, f"the filer {f_addr}")
        walls["a_up"] = time.perf_counter() - t0

        # --- b. the tree through filer A, the producer's lag gauge ---
        step = "b fill"
        t0 = time.perf_counter()
        files = _repl_files(volume_bytes, seed + 220)
        files["/repl/big/big.bin"] = np.random.default_rng(seed + 221).bytes(big_bytes)
        digests = {p: hashlib.sha256(b).digest() for p, b in files.items()}
        make_s = time.perf_counter() - t0

        def post(c, path):
            status, _, body = _http(c, "POST", urllib.parse.quote(path), files[path])
            if status != 201:
                fail(f"POST {path} to filer A: {status} {body[:300]!r}")

        t0 = time.perf_counter()
        _fan(fport, REPL_CLIENTS, sorted(files), post)
        walls["b_fill"] = time.perf_counter() - t0
        paths = sorted(files)
        total = sum(map(len, files.values()))
        written, pending = queue_events()
        gauge = lag_gauge()
        if not written == pending == gauge or written < len(files):
            fail(f"filer A's lag gauge reads {gauge}, the queue holds {written} events with "
                 f"{pending} pending, for {len(files)} files")
        with rpc.dial(f"127.0.0.1:{fport + 10000}") as ch:
            stub = rpc.filer_stub(ch)

            def chunk_fids(path: str) -> list:
                d, _, name = path.rpartition("/")
                resp = stub.LookupDirectoryEntry(
                    fpb.LookupDirectoryEntryRequest(directory=d, name=name), timeout=30)
                return [chunk.fid for chunk in resp.entry.chunks]

            fids = {p: chunk_fids(p) for p in paths}
        if len(fids["/repl/big/big.bin"]) != -(-big_bytes // (32 << 20)):
            fail(f"the big file holds {len(fids['/repl/big/big.bin'])} chunks")
        maps_seen.append({n: _maps_has(run.procs[n].pid, "libcuda", "libtorch")
                          for n in ("filer", "filer_b")})
        log(f"3m replication: cluster A (master -telemetryInterval 1, three volume servers, "
            f"`filer -store lsm -collection repl -maxMB 32` publishing to a "
            f"{REPL_PARTITIONS}-partition logqueue) and cluster B (master, volume server, "
            f"`filer -store lsm`) up in {walls['a_up']:.3f} s; {len(paths)} files "
            f"({total} B, {sum(map(len, fids.values()))} chunks; payloads made in "
            f"{make_s:.3f} s) POSTed to filer A from {REPL_CLIENTS} threads in "
            f"{walls['b_fill']:.3f} s ({total / walls['b_fill'] / 1e6:.1f} MB/s); the queue "
            f"holds {written} events and filer A's weed_replication_lag_events reads "
            f"{gauge:.0f}; {smi}")

        # --- c. ec.encode and ec.balance on A ---
        step = "c encode"
        vols = {}
        for d in dirs:
            for f in os.listdir(d):
                if f.startswith("repl_") and f.endswith(".dat"):
                    path = os.path.join(d, f)
                    vols[int(f[5:-4])] = (os.path.getsize(path), {
                        nd.id: (off, nd.size) for nd, off in scan_volume_file(path)})
        shell = _CliShell(run.cli + ["shell", "-master", maddr], env,
                          os.path.join(run.logs, "shell.log"), cwd=home("shell"))
        run.procs["shell"] = shell.proc
        k0 = server_launches()
        t0 = time.perf_counter()
        _, text = shell.run("ec.encode -collection repl -fullPercent 0")
        if text.count("ec encoded volume") != len(vols):
            fail(f"ec.encode: {text[-2000:]} over volumes {sorted(vols)}")
        shell.run("ec.balance -force")
        walls["c_encode_balance"] = time.perf_counter() - t0
        k1 = server_launches()
        encode_launches = launch_delta(k0, k1)
        if on_card:
            _must_launch("3m replication, step c ec.encode", encode_launches,
                         ("gf_apply", "crc32c_rows"))
        held: dict = {i: {} for i in range(3)}
        for i, d in enumerate(dirs):
            for f in os.listdir(d):
                if f.startswith("repl_") and ".ec" in f and f[-2:].isdigit():
                    held[i].setdefault(int(f[5:].split(".")[0]), []).append(int(f[-2:]))
        runs["repl_encode"] = {"wall_s": walls["c_encode_balance"],
                               "launches": encode_launches, "sigs": {}}
        log(f"3m replication ec.encode -collection repl of {len(vols)} volumes and "
            f"ec.balance -force through the shell in {walls['c_encode_balance']:.3f} s, A's "
            f"launches {encode_launches} "
            f"({ {i: (k1[i]['gf_apply'] - k0[i]['gf_apply'], k1[i]['crc32c_rows'] - k0[i]['crc32c_rows']) for i in k1} } "
            f"K1/K4 by server); shards by server "
            f"{ {i: sum(map(len, h.values())) for i, h in held.items()} }; {smi}")

        # --- d. a shard holder of A lost ---
        step = "d kill"
        can_lose = [i for i in held if held[i] and max(map(len, held[i].values())) <= 4]
        if not can_lose:
            fail(f"no holder holds at most 4 shards of every volume: {held}")
        victim = max(can_lose, key=lambda i: sum(map(len, held[i].values())))
        lost = {vid: set(s) for vid, s in held[victim].items()}
        touched, touched_fids = [], []
        for path in paths:
            for fid in fids[path]:
                vid_s, rest = fid.split(",")
                vid, nid = int(vid_s), int(rest[:-8], 16)
                dat_size, needles = vols[vid]
                off, size = needles[nid]
                shards = {iv.to_shard_id_and_offset()[0] for iv in locate.locate_data(
                    locate.LARGE_BLOCK_SIZE, locate.SMALL_BLOCK_SIZE, dat_size, off,
                    16 + size + 4 + 8)}
                if shards & lost.get(vid, set()):
                    touched.append(path)
                    if len(fids[path]) == 1:
                        touched_fids.append((path, fid))
                    break
        if not touched_fids:
            fail(f"no one-chunk file has bytes on shards {lost}")
        run.procs[f"volume{victim}"].send_signal(signal.SIGKILL)
        run.rcs[f"volume{victim}"] = run.procs[f"volume{victim}"].wait(30)
        log(f"3m replication: volume{victim} (shards "
            f"{ {v: sorted(s) for v, s in lost.items()} }) SIGKILLed; {len(touched)} files "
            f"have bytes on its shards")

        # --- e. the runner drains the queue into filer B ---
        step = "e replicate"
        runner_home = home("replicate")
        with open(os.path.join(runner_home, "notification.toml"), "w") as f:
            f.write(notification_toml)
        repl_toml = os.path.join(runner_home, "replication.toml")
        with open(repl_toml, "w") as f:
            f.write(f'[source.filer]\nenabled = true\ngrpcAddress = "{faddr}"\n'
                    f'directory = "/repl"\n\n[sink.filer]\nenabled = true\n'
                    f'grpcAddress = "{faddr_b}"\ndirectory = "/backup"\n')
        k0 = server_launches()
        t0 = time.perf_counter()
        spawn_runner("replicate")
        run.wait(lambda: lag_gauge() == 0, "filer A's lag gauge at 0", 600)
        walls["e_drain"] = time.perf_counter() - t0
        k1 = server_launches()
        maps_seen.append({"replicate": _maps_has(run.procs["replicate"].pid, "libcuda",
                                                 "libtorch")})
        if queue_events()[1]:
            fail(f"the queue still holds {queue_events()[1]} events past the cursor")

        def lag_settled() -> bool:
            rep = lag_report(shell)
            return rep["Filers"].get(faddr) == {"LagEvents": 0.0} and rep["Alerts"] == []

        settled_s = run.wait(lag_settled, "replication.lag -json with filer A 0 events "
                             "behind and no firing alert", 60)
        report = lag_report(shell)

        # --- f. every file read back from filer B ---
        step = "f read back"
        walls["f_read_b"] = read_b(paths, "read back from B")
        degraded = launch_delta(k0, k1)
        if on_card:
            _must_launch("3m replication, step f the consumer's reads", degraded,
                         ("gf_apply",))
        direct = {}
        for i in sorted(k1):
            mine = [(p, fid) for p, fid in touched_fids if int(fid.split(",")[0]) in held[i]]
            if not mine:
                continue
            served = k1[i]["degraded"] - k0[i]["degraded"]
            if served == 0:
                path, fid = mine[0]
                with urllib.request.urlopen(f"http://127.0.0.1:{ports[i]}/{fid}",
                                            timeout=60) as r:
                    body = r.read()
                if body != files[path]:
                    fail(f"volume{i}'s GET of {fid} ({path}) gave {len(body)} B, want "
                         f"{len(files[path])} B")
                direct[i] = fid
                k1[i] = server_launches()[i]
                served = k1[i]["degraded"] - k0[i]["degraded"]
            if served == 0:
                fail(f"volume{i} served no degraded interval, even asked for "
                     f"{direct.get(i)} directly")
            if on_card and k1[i]["gf_apply"] <= k0[i]["gf_apply"]:
                fail(f"volume{i} served {served} degraded intervals but its K1 launches did "
                     f"not rise ({k0[i]['gf_apply']} -> {k1[i]['gf_apply']})")
        runs["repl_degraded"] = {"wall_s": walls["e_drain"], "launches": degraded,
                                 "sigs": {}, "files": len(paths), "touched": len(touched)}
        log(f"3m replication on {card}: `filer.replicate` drained {written} events into "
            f"filer B in {walls['e_drain']:.3f} s ({total / walls['e_drain'] / 1e6:.1f} "
            f"MB/s of file bytes, {written / walls['e_drain']:.1f} events/s), reading every "
            f"chunk from A with volume{victim} lost; replication.lag -json {report} "
            f"({settled_s:.3f} s after the gauge fell to 0); {len(paths)} files ({total} B) "
            f"read back from filer B, SHA-256 equal, 0 errors, in {walls['f_read_b']:.3f} s "
            f"({total / walls['f_read_b'] / 1e6:.1f} MB/s); A's survivors' launches while "
            f"the runner read {degraded} (K1 "
            f"{ {i: k1[i]['gf_apply'] - k0[i]['gf_apply'] for i in k1} }, K5 "
            f"{ {i: k1[i]['gf_bits'] - k0[i]['gf_bits'] for i in k1} }, degraded intervals "
            f"{ {i: k1[i]['degraded'] - k0[i]['degraded'] for i in k1} } by server"
            f"{'; asked directly: ' + str(direct) if direct else ''}); {smi}")

        # --- g. a directory deleted on A ---
        step = "g delete"
        top = max({p.split("/")[2] for p in paths if p.count("/") > 3},
                  key=lambda t: sum(p.startswith(f"/repl/{t}/") for p in paths))
        gone = [p for p in paths if p.startswith(f"/repl/{top}/")]
        t0 = time.perf_counter()
        c = http.client.HTTPConnection("127.0.0.1", fport, timeout=120)
        try:
            status, _, body = _http(c, "DELETE", f"/repl/{top}?recursive=true")
        finally:
            c.close()
        if status not in (200, 202, 204):
            fail(f"DELETE /repl/{top}?recursive=true on filer A: {status} {body[:200]!r}")

        def gone_on_b() -> bool:
            c = http.client.HTTPConnection("127.0.0.1", fport_b, timeout=30)
            try:
                return all(_http(c, "GET", "/backup" + p[5:])[0] == 404 for p in gone)
            finally:
                c.close()

        run.wait(gone_on_b, f"the {len(gone)} files under /repl/{top} gone from filer B", 120)
        walls["g_delete"] = time.perf_counter() - t0
        paths = [p for p in paths if p not in set(gone)]
        log(f"3m replication: /repl/{top} ({len(gone)} files) deleted on A and gone from B "
            f"in {walls['g_delete']:.3f} s")

        # --- h. SIGTERM, restart, resume from the cursor ---
        step = "h restart"
        run.wait(lambda: lag_gauge() == 0 and queue_events()[1] == 0,
                 "the lag at 0 after the delete", 60)
        run.procs["replicate"].send_signal(signal.SIGTERM)
        run.rcs["replicate"] = run.procs["replicate"].wait(60)
        if run.rcs["replicate"] != 0:
            fail(f"the runner exited {run.rcs['replicate']} on SIGTERM: "
                 f"{run.tail('replicate')}")
        before = b_chunks()
        if sorted(before) != sorted("/backup" + p[5:] for p in paths):
            fail(f"filer B holds {len(before)} files, want {len(paths)}")
        offsets = [os.path.join(qdir, f"p{i:03d}", "offsets", "replicate")
                   for i in range(REPL_PARTITIONS)]
        t0 = time.perf_counter()
        started = spawn_runner("replicate2")
        run.wait(lambda: min(os.stat(o).st_mtime for o in offsets) > started,
                 "the restarted runner's first poll of every partition", 60)
        walls["h_resume"] = time.perf_counter() - t0
        if lag_gauge() != 0 or queue_events()[1] != 0:
            fail(f"after the restart the lag reads {lag_gauge()} (queue "
                 f"{queue_events()[1]})")
        late = "/repl/late/after-restart.bin"
        files[late] = np.random.default_rng(seed + 222).bytes(300_000)
        digests[late] = hashlib.sha256(files[late]).digest()
        c = http.client.HTTPConnection("127.0.0.1", fport, timeout=120)
        try:
            post(c, late)
        finally:
            c.close()
        run.wait(lambda: lag_gauge() == 0 and queue_events()[1] == 0
                 and "/backup/late/after-restart.bin" in b_chunks(),
                 "the file written after the restart on filer B", 60)
        read_b([late], "the file written after the restart")
        after = b_chunks()
        changed = sorted(p for p in before if after.get(p) != before[p])
        if changed or set(after) != set(before) | {"/backup/late/after-restart.bin"}:
            fail(f"the restarted runner rewrote {len(changed)} entries on B (first "
                 f"{changed[:5]}), or B lists {len(after)} files for {len(before) + 1}")
        maps_seen.append({"replicate2": _maps_has(run.procs["replicate2"].pid, "libcuda",
                                                  "libtorch")})
        run.procs["replicate2"].send_signal(signal.SIGTERM)
        run.rcs["replicate2"] = run.procs["replicate2"].wait(60)
        if run.rcs["replicate2"] != 0:
            fail(f"the restarted runner exited {run.rcs['replicate2']} on SIGTERM")
        log(f"3m replication: SIGTERM ended the runner with 0; restarted, it polled every "
            f"partition from its cursor in {walls['h_resume']:.3f} s with the lag at 0 and "
            f"none of B's {len(before)} entries rewritten; a file written on A afterwards "
            f"reached B; SIGTERM ended it with 0")
        maps_seen.append({n: _maps_has(run.procs[n].pid, "libcuda", "libtorch")
                          for n in ("filer", "filer_b")})
        if any(any(m.values()) for ms in maps_seen for m in ms.values()):
            fail(f"a filer or the runner maps {maps_seen}")
        run.rcs["shell"] = shell.exit()
        if run.rcs["shell"]:
            fail(f"the shell exited {run.rcs['shell']}")
        runs["replication"] = {"walls": walls, "files": len(files), "events": written,
                               "touched": len(touched), "bytes": total}
    except Exception as e:  # noqa: BLE001 — re-raised below, named by its step
        failed = e
    finally:
        if shell is not None and shell.proc.poll() is None:
            shell.proc.kill()
        rcs = run.finish()
    if failed is not None:
        for name in run.procs:
            if name != "shell":
                log(f"3m replication: {name} exited {rcs.get(name)}; its log ends: "
                    f"{run.tail(name)[-1500:]!r}")
        if str(failed).startswith("3m replication, step"):
            raise failed
        raise AssertionError(f"3m replication, step {step}: {type(failed).__name__}: "
                             f"{failed}") from failed
    bad = {n: rc for n, rc in rcs.items() if rc != 0 and n != f"volume{victim}"}
    walls["phase"] = time.perf_counter() - phase_t0
    log(f"3m replication: SIGTERM, exit codes {rcs} (the SIGKILLed holder aside, each must "
        f"be 0); libcuda/libtorch mapped by the filers and the runner {maps_seen}; step "
        f"walls (s) { {k: round(v, 3) for k, v in walls.items()} } on {card}; {smi}")
    if bad:
        raise AssertionError(f"3m replication, step h processes: processes exited non-zero "
                             f"{bad}: { {n: run.tail(n) for n in bad if n != 'shell'} }")
    return runs


CLOUD_BYTES = CUT_BYTES // 4  # 3n's files besides the big one: 3m's 128 MiB cut 2x
CLOUD_SINKS = ("gcs", "azure", "backblaze")  # one filer.replicate runner a sink
CLOUD_QUEUE_FILES = 32  # files POSTed to each of the SQS and Pub/Sub filers


class _CountingObjects(dict):
    """A cloud fake's object map that counts its stores (uploads)."""

    puts = 0

    def __setitem__(self, key, value):
        self.puts += 1
        super().__setitem__(key, value)


def _cloud_fakes(seed: int) -> dict:
    """tests/cloud_fakes.py's GCS, Azure, B2, SQS and Pub/Sub fakes as 3n
    serves them in this process, with their credentials: the Azure
    account key is 32 bytes from `seed`; FakeSqs checks SigV4 with the
    port's key derivation (its own imports the reference's), FakePubSub
    answers 401 to a publish without the Bearer token; the sinks' object
    maps count their uploads."""
    import base64
    import hashlib
    import hmac
    import importlib.util

    # by its path: a `tests` package elsewhere on sys.path would shadow the repo's
    spec = importlib.util.spec_from_file_location("cloud_fakes", os.path.join(
        os.path.dirname(os.path.abspath(__file__)), "tests", "cloud_fakes.py"))
    cloud_fakes = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cloud_fakes)
    FakeAzure, FakeB2, FakeGcs = cloud_fakes.FakeAzure, cloud_fakes.FakeB2, cloud_fakes.FakeGcs
    FakePubSub, FakeSqs = cloud_fakes.FakePubSub, cloud_fakes.FakeSqs

    class Sqs(FakeSqs):
        def _check_sig(self, handler, body: bytes) -> bool:
            from seaweedfs_tpu_torch.s3api.auth import derive_signing_key

            auth = handler.headers.get("Authorization", "")
            if f"Credential={self.access_key}/" not in auth:
                return False
            amz_date = handler.headers.get("x-amz-date", "")
            headers = {"content-type": handler.headers.get("Content-Type", ""),
                       "host": handler.headers.get("Host", ""), "x-amz-date": amz_date}
            signed = sorted(headers)
            canonical = "\n".join(["POST", "/", "", "".join(f"{k}:{headers[k]}\n" for k in signed),
                                   ";".join(signed), hashlib.sha256(body).hexdigest()])
            scope = f"{amz_date[:8]}/{self.region}/sqs/aws4_request"
            sts = "\n".join(["AWS4-HMAC-SHA256", amz_date, scope,
                             hashlib.sha256(canonical.encode()).hexdigest()])
            want = hmac.new(derive_signing_key(self.secret_key, amz_date[:8], self.region, "sqs"),
                            sts.encode(), hashlib.sha256).hexdigest()
            return f"Signature={want}" in auth

    class PubSub(FakePubSub):
        token = "smoke-bearer-token"

        def _handler_class(self):
            base, fake = super()._handler_class(), self

            class H(base):
                def do_POST(self):
                    if self.headers.get("Authorization") != f"Bearer {fake.token}":
                        n = int(self.headers.get("Content-Length", "0"))
                        self.rfile.read(n)
                        return self._json({"error": {"code": 401}}, 401)
                    base.do_POST(self)

            return H

    key = base64.b64encode(np.random.default_rng(seed).bytes(32)).decode()
    fakes = {"gcs": FakeGcs(), "azure": FakeAzure("weedacct", key, "weed"),
             "backblaze": FakeB2("weedkeyid", "weedappkey", "weedbucket"),
             "sqs": Sqs("AKIDWEEDSMOKE", "weed-smoke-secret", "us-east-1", "weedq"),
             "pubsub": PubSub("weedproj", "weedtopic")}
    for kind in CLOUD_SINKS:
        fakes[kind].objects = _CountingObjects()
    fakes["azure"].account_key = key
    return fakes


def _creation_events_fault(published: list, entries: dict) -> str | None:
    """What is wrong with `published`, the [(key, EventNotification)] a
    filer sent while a fresh tree was written into it, against `entries`,
    {path: is_directory} of that tree; None when each event creates the
    entry its key names and each entry is created: a file once, a
    directory once or more, since two writers that find it missing both
    create it and both announce it (filer/filer.py `_ensure_dirs`)."""
    counts: dict = {}
    for key, ev in published:
        parent = ev.new_parent_path.rstrip("/")
        if ev.HasField("old_entry") or f"{parent}/{ev.new_entry.name}" != key:
            return f"the event under key {key} is not the creation of that entry: {ev}"
        counts[key] = counts.get(key, 0) + 1
    if set(counts) != set(entries):
        return (f"the topic's keys and the filer's entries differ: "
                f"{sorted(set(entries) - set(counts))[:5]} have no event, "
                f"{sorted(set(counts) - set(entries))[:5]} are no entry")
    twice = {k: n for k, n in counts.items() if n > 1 and not entries[k]}
    if twice:
        return f"files announced more than once: {twice}"
    return None


def run_cloud_phase(workdir: str, volume_bytes: int, seed: int, device=None,
                    card: str = "", smi: str = "", big_bytes: int = REPL_BIG_BYTES) -> dict:
    """The filer's event stream leaving the cluster (ROADMAP item 12b):
    Kafka, SQS and Pub/Sub, and replication into GCS, Azure and B2, from
    a cluster whose volume servers decode on the card; every process
    `python -m seaweedfs_tpu_torch` (the broker `python -m
    seaweedfs_tpu_torch.notification.kafka_fake`) in a directory of its
    own under `workdir`, the cloud fakes of tests/cloud_fakes.py in this
    process; on `device` (None: the card; "cpu" runs the volume servers
    with -ec.codec cpu, a rehearsal):
      a. a kafka_fake broker (REPL_PARTITIONS partitions), a master
         (-telemetryInterval 1, -repairInterval 0), three `volume` servers
         (racks 0/1/0), a `filer -store lsm -collection cloud -maxMB 32`
         whose notification.toml enables [notification.kafka] at the
         broker, and two more filers on the master, one publishing to
         [notification.aws_sqs] at FakeSqs, one to
         [notification.google_pub_sub] at FakePubSub (a token set);
      b. `volume_bytes` of files log-uniform over 1 KiB-1 MiB under
         /cloud, 1-3 directories deep, and one of `big_bytes` (two
         chunks), POSTed from REPL_CLIENTS threads; the broker's high
         watermarks sum to the filer's events: a creation of each entry
         (files, directories, /cloud), a file's once, a directory's more
         than once where concurrent writers both created it;
      c. ec.encode -collection cloud -fullPercent 0 and ec.balance -force
         through a `shell` process (K1 + K4 on the cards);
      d. the holder with the most shards among those holding at most 4 of
         every volume SIGKILLed;
      e. three `filer.replicate -config` processes read the one topic,
         each with its own offset_dir and sink (sink.gcs, sink.azure,
         sink.backblaze at the fakes): within a deadline each fake holds
         exactly the files under /cloud (the sink's directory joined to
         the path), every object SHA-256 equal to its file; the K1
         launches of the survivors rose (a survivor that served no
         degraded interval is asked directly for a file on the lost
         shards); K1 and K5 deltas printed; meanwhile
      h. CLOUD_QUEUE_FILES files are POSTed to each of the SQS and Pub/Sub
         filers: each fake accepts that many messages (SigV4-signed, with
         the Bearer token), each an EventNotification naming its file;
      f. a top directory DELETEd recursively on the filer is gone from all
         three fakes, B2 keeping no version of its files;
      g. SIGTERM ends the GCS runner with 0, its offset files at the
         broker's high watermarks; started again it uploads nothing until
         a file written meanwhile reaches GCS, then SIGTERM ends it with 0;
      i. no filer, runner or the broker maps libcuda or torch; SIGTERM
         ends every process with exit code 0 (the killed holder aside).
    Raises naming 3n and the step on any fault; returns cloud_encode and
    cloud_degraded with the volume servers' launches."""
    import hashlib
    import signal
    import urllib.parse

    from google.protobuf import text_format

    from seaweedfs_tpu_torch.ec import locate
    from seaweedfs_tpu_torch.notification.kafka import KafkaClient
    from seaweedfs_tpu_torch.pb import filer_pb2 as fpb
    from seaweedfs_tpu_torch.pb import rpc
    from seaweedfs_tpu_torch.shell import CommandEnv
    from seaweedfs_tpu_torch.storage.volume import scan_volume_file
    from seaweedfs_tpu_torch.util.availability import free_port

    _check_room(workdir, REPL_ROOM if volume_bytes >= 1 << 26
                else 6 * (volume_bytes + big_bytes) + (1 << 27), "phase 3n")
    on_card = device is None
    env = {k: v for k, v in os.environ.items() if k != "WEED_EC_CODEC"}
    if not on_card:
        env["WEED_EC_CODEC"] = "cpu"
    codec_args = [] if on_card else ["-ec.codec", "cpu"]
    run = _PhaseProcs("3n cloud", workdir, env)
    step = "a start"

    def fail(msg: str):
        raise AssertionError(f"3n cloud, step {step}: {msg}")

    phase_t0 = time.perf_counter()
    walls: dict = {}
    runs: dict = {}
    shell = None
    victim = None
    failed = None
    maps_seen: dict = {}
    fakes = _cloud_fakes(seed + 230)
    mport, fport, kport = free_port(), free_port(), free_port()
    qports = {"sqs": free_port(), "pubsub": free_port()}
    ports = [free_port() for _ in range(3)]
    dirs = [os.path.join(workdir, f"vs{i}") for i in range(3)]
    maddr, khosts, topic = f"127.0.0.1:{mport}", f"127.0.0.1:{kport}", "seaweedfs_filer"
    mirrors = {"gcs": "gcs-mirror", "azure": "azure-mirror", "backblaze": "b2-mirror"}
    sinks = {
        "gcs": f'[sink.gcs]\nenabled = true\nbucket = "weed"\ntoken = "smoke-gcs-token"\n'
               f'endpoint = "{fakes["gcs"].endpoint}"\n',
        "azure": f'[sink.azure]\nenabled = true\naccount_name = "weedacct"\n'
                 f'account_key = "{fakes["azure"].account_key}"\ncontainer = "weed"\n'
                 f'endpoint = "{fakes["azure"].endpoint}"\n',
        "backblaze": f'[sink.backblaze]\nenabled = true\nb2_account_id = "weedkeyid"\n'
                     f'b2_master_application_key = "weedappkey"\nbucket = "weedbucket"\n'
                     f'endpoint = "{fakes["backblaze"].endpoint}"\n'}
    queue_tomls = {
        "sqs": f'[notification.aws_sqs]\nenabled = true\naws_access_key_id = "AKIDWEEDSMOKE"\n'
               f'aws_secret_access_key = "weed-smoke-secret"\nregion = "us-east-1"\n'
               f'sqs_queue_name = "weedq"\nendpoint = "{fakes["sqs"].endpoint}"\n',
        "pubsub": f'[notification.google_pub_sub]\nenabled = true\nproject_id = "weedproj"\n'
                  f'topic = "weedtopic"\ntoken = "{fakes["pubsub"].token}"\n'
                  f'endpoint = "{fakes["pubsub"].endpoint}"\n'}

    def home(name: str) -> str:
        d = os.path.join(workdir, "run", name)
        os.makedirs(d)
        return d

    def server_launches() -> dict:
        out = {}
        for i in range(3):
            if f"volume{i}" not in run.rcs:
                m = _cli_metrics(ports[i])
                out[i] = dict(_cli_launches(m),
                              degraded=int(m.get("weed_ec_degraded_read_total", 0)))
        return out

    def launch_delta(before: dict, after: dict) -> dict:
        return {k: sum(after[i][k] - before[i][k] for i in after) for k in _counts()}

    def highs() -> dict:
        c = KafkaClient(khosts)
        try:
            return {p: c.fetch(topic, p, 0)[1] for p in c.metadata(topic)}
        finally:
            c.close()

    def filer_entries(root: str) -> dict:
        """{path: is_directory} of the entries at and below `root` on the filer."""
        out = {root: True}
        with rpc.dial(f"127.0.0.1:{fport + 10000}") as ch:
            stub = rpc.filer_stub(ch)
            todo = [root]
            while todo:
                d = todo.pop()
                for r in stub.ListEntries(fpb.ListEntriesRequest(directory=d, limit=100000),
                                          timeout=60):
                    out[f"{d}/{r.entry.name}"] = r.entry.is_directory
                    if r.entry.is_directory:
                        todo.append(f"{d}/{r.entry.name}")
        return out

    def topic_events() -> list:
        """[(key, EventNotification)] of every record on the topic."""
        c = KafkaClient(khosts)
        try:
            out = []
            for p in c.metadata(topic):
                offset, high = 0, 1
                while offset < high:
                    records, high = c.fetch(topic, p, offset)
                    if not records:
                        break
                    for _off, key, value in records:
                        ev = fpb.EventNotification()
                        ev.ParseFromString(value)
                        out.append(((key or b"").decode(), ev))
                    offset = records[-1][0] + 1
            return out
        finally:
            c.close()

    def cloud_keys(kind: str) -> set:
        return set(fakes[kind].objects.copy())

    def want_keys(kind: str) -> set:
        return {mirrors[kind] + p[len("/cloud"):] for p in files}

    def spawn_runner(name: str, kind: str) -> None:
        run.spawn(name, ["filer.replicate", "-config", "replication.toml"],
                  cwd=runner_homes[kind])

    def post(c, item):
        port_path, body = item
        status, _, reply = _http(c, "POST", urllib.parse.quote(port_path), body)
        if status != 201:
            fail(f"POST {port_path}: {status} {reply[:300]!r}")

    started = []
    try:
        for f in fakes.values():
            f.start()
            started.append(f)
        # --- a. the broker, cluster A and the three filers ---
        t0 = time.perf_counter()
        run.spawn("broker", [str(kport), str(REPL_PARTITIONS)], cwd=home("broker"),
                  module="seaweedfs_tpu_torch.notification.kafka_fake")
        run.spawn("master", ["master", "-ip", "127.0.0.1", "-port", str(mport),
                             "-volumeSizeLimitMB", str(CLUSTER_LIMIT_MB), "-repairInterval",
                             "0", "-telemetryInterval", "1"], cwd=home("master"))
        run.wait(lambda: urllib.request.urlopen(f"http://{maddr}/cluster/status",
                                                timeout=2).close() is None, "the master")
        for i, d in enumerate(dirs):
            os.mkdir(d)
            run.spawn(f"volume{i}", ["volume", "-ip", "127.0.0.1", "-port", str(ports[i]),
                                     "-dir", d, "-max", "100", "-mserver", maddr,
                                     "-rack", f"rack{i % 2}", "-scrubInterval", "0"]
                      + codec_args, cwd=home(f"volume{i}"))
        run.wait(lambda: len(highs()) == REPL_PARTITIONS, "the kafka_fake broker")
        filer_homes = {"filer": home("filer"), "sqs": home("filer_sqs"),
                       "pubsub": home("filer_pubsub")}
        with open(os.path.join(filer_homes["filer"], "notification.toml"), "w") as f:
            f.write(f'[notification.kafka]\nenabled = true\nhosts = "{khosts}"\n'
                    f'topic = "{topic}"\n')
        for kind, text in queue_tomls.items():
            with open(os.path.join(filer_homes[kind], "notification.toml"), "w") as f:
                f.write(text)
        for name, port, collection in (("filer", fport, "cloud"), ("sqs", qports["sqs"], "sqs"),
                                       ("pubsub", qports["pubsub"], "pubsub")):
            run.spawn(name if name == "filer" else f"filer_{name}",
                      ["filer", "-ip", "127.0.0.1", "-port", str(port), "-master", maddr,
                       "-store", "lsm", "-storePath", os.path.join(workdir, f"{name}-lsm"),
                       "-collection", collection, "-maxMB", "32"], cwd=filer_homes[name])
        cenv = CommandEnv([maddr])
        run.wait(lambda: len(cenv.collect_topology().nodes) == 3, "three volume servers")
        for port in (fport, *qports.values()):
            run.wait(lambda port=port: urllib.request.urlopen(
                f"http://127.0.0.1:{port}/", timeout=5).status == 200, f"the filer on {port}")
        walls["a_up"] = time.perf_counter() - t0

        # --- b. the tree through the filer, onto the topic ---
        step = "b fill"
        t0 = time.perf_counter()
        files = {"/cloud" + p[len("/repl"):]: b
                 for p, b in _repl_files(volume_bytes, seed + 231).items()}
        files["/cloud/big/big.bin"] = np.random.default_rng(seed + 232).bytes(big_bytes)
        digests = {p: hashlib.sha256(b).digest() for p, b in files.items()}
        rng = np.random.default_rng(seed + 233)
        qfiles = {kind: {f"/{kind}-{i:02d}.bin": rng.bytes(int(rng.integers(1024, 65536)))
                         for i in range(CLOUD_QUEUE_FILES)} for kind in qports}
        make_s = time.perf_counter() - t0
        paths = sorted(files)
        total = sum(map(len, files.values()))
        t0 = time.perf_counter()
        _fan(fport, REPL_CLIENTS, [(p, files[p]) for p in paths], post)
        walls["b_fill"] = time.perf_counter() - t0
        entries = filer_entries("/cloud")
        run.wait(lambda: sum(highs().values()) >= len(entries), "the topic holding an event "
                 f"for each of the filer's {len(entries)} entries", 30)
        high = highs()
        published = topic_events()
        events = len(published)
        if sum(high.values()) != events:
            fail(f"the broker's high watermarks {high} sum to {sum(high.values())}, a fetch "
                 f"of every partition read {events} events")
        fault = _creation_events_fault(published, entries)
        if fault:
            fail(fault)
        with rpc.dial(f"127.0.0.1:{fport + 10000}") as ch:
            stub = rpc.filer_stub(ch)

            def chunk_fids(path: str) -> list:
                d, _, name = path.rpartition("/")
                resp = stub.LookupDirectoryEntry(
                    fpb.LookupDirectoryEntryRequest(directory=d, name=name), timeout=30)
                return [chunk.fid for chunk in resp.entry.chunks]

            fids = {p: chunk_fids(p) for p in paths}
        if len(fids["/cloud/big/big.bin"]) != -(-big_bytes // (32 << 20)):
            fail(f"the big file holds {len(fids['/cloud/big/big.bin'])} chunks")

        # --- c. ec.encode and ec.balance ---
        step = "c encode"
        vols = {}
        for d in dirs:
            for f in os.listdir(d):
                if f.startswith("cloud_") and f.endswith(".dat"):
                    path = os.path.join(d, f)
                    vols[int(f[6:-4])] = (os.path.getsize(path), {
                        nd.id: (off, nd.size) for nd, off in scan_volume_file(path)})
        shell = _CliShell(run.cli + ["shell", "-master", maddr], env,
                          os.path.join(run.logs, "shell.log"), cwd=home("shell"))
        run.procs["shell"] = shell.proc
        k0 = server_launches()
        t0 = time.perf_counter()
        _, text = shell.run("ec.encode -collection cloud -fullPercent 0")
        if text.count("ec encoded volume") != len(vols):
            fail(f"ec.encode: {text[-2000:]} over volumes {sorted(vols)}")
        shell.run("ec.balance -force")
        walls["c_encode_balance"] = time.perf_counter() - t0
        k1 = server_launches()
        encode_launches = launch_delta(k0, k1)
        if on_card:
            _must_launch("3n cloud, step c ec.encode", encode_launches,
                         ("gf_apply", "crc32c_rows"))
        held: dict = {i: {} for i in range(3)}
        for i, d in enumerate(dirs):
            for f in os.listdir(d):
                if f.startswith("cloud_") and ".ec" in f and f[-2:].isdigit():
                    held[i].setdefault(int(f[6:].split(".")[0]), []).append(int(f[-2:]))
        runs["cloud_encode"] = {"wall_s": walls["c_encode_balance"],
                                "launches": encode_launches, "sigs": {}}

        # --- d. a shard holder lost ---
        step = "d kill"
        can_lose = [i for i in held if held[i] and max(map(len, held[i].values())) <= 4]
        if not can_lose:
            fail(f"no holder holds at most 4 shards of every volume: {held}")
        victim = max(can_lose, key=lambda i: sum(map(len, held[i].values())))
        lost = {vid: set(s) for vid, s in held[victim].items()}
        touched, touched_fids = [], []
        for path in paths:
            for fid in fids[path]:
                vid_s, rest = fid.split(",")
                vid, nid = int(vid_s), int(rest[:-8], 16)
                dat_size, needles = vols[vid]
                off, size = needles[nid]
                shards = {iv.to_shard_id_and_offset()[0] for iv in locate.locate_data(
                    locate.LARGE_BLOCK_SIZE, locate.SMALL_BLOCK_SIZE, dat_size, off,
                    16 + size + 4 + 8)}
                if shards & lost.get(vid, set()):
                    touched.append(path)
                    if len(fids[path]) == 1:
                        touched_fids.append((path, fid))
                    break
        if not touched_fids:
            fail(f"no one-chunk file has bytes on shards {lost}")
        run.procs[f"volume{victim}"].send_signal(signal.SIGKILL)
        run.rcs[f"volume{victim}"] = run.procs[f"volume{victim}"].wait(30)
        run.wait(lambda: len(cenv.collect_topology().nodes) == 2, "the master dropping the "
                 "killed holder", 30)
        log(f"3n cloud: broker (kafka_fake, {REPL_PARTITIONS} partitions), master, three "
            f"volume servers and three filers (kafka, aws_sqs, google_pub_sub) up in "
            f"{walls['a_up']:.3f} s; {len(paths)} files ({total} B, "
            f"{sum(map(len, fids.values()))} chunks; made in {make_s:.3f} s) POSTed in "
            f"{walls['b_fill']:.3f} s ({total / walls['b_fill'] / 1e6:.1f} MB/s), the topic's "
            f"high watermarks {high} = the filer's {events} events ({len(entries)} entries, "
            f"{events - len(entries)} repeated directory creations); ec.encode + ec.balance of "
            f"{len(vols)} volumes {walls['c_encode_balance']:.3f} s, launches "
            f"{ {k: v for k, v in encode_launches.items() if v} }; volume{victim} (shards "
            f"{ {v: sorted(s) for v, s in lost.items()} }) SIGKILLed, {len(touched)} files on "
            f"its shards")

        # --- e. three runners drain the topic into three clouds; h. the queues meanwhile ---
        step = "e replicate"
        runner_homes = {}
        for kind in CLOUD_SINKS:
            runner_homes[kind] = home(f"runner_{kind}")
            with open(os.path.join(runner_homes[kind], "notification.toml"), "w") as f:
                f.write(f'[notification.kafka]\nenabled = true\nhosts = "{khosts}"\n'
                        f'topic = "{topic}"\n'
                        f'offset_dir = "{os.path.join(runner_homes[kind], "offsets")}"\n')
            with open(os.path.join(runner_homes[kind], "replication.toml"), "w") as f:
                f.write(f'[source.filer]\nenabled = true\ngrpcAddress = "127.0.0.1:{fport}"\n'
                        f'directory = "/cloud"\n\n{sinks[kind]}directory = "{mirrors[kind]}"\n')
        k0 = server_launches()
        t0 = time.perf_counter()
        for kind in CLOUD_SINKS:
            spawn_runner(kind, kind)
        queue_errors: list = []

        def post_queues():
            try:
                th0 = time.perf_counter()
                for kind, qf in qfiles.items():
                    _fan(qports[kind], 2, sorted(qf.items()), post)
                walls["h_queues"] = time.perf_counter() - th0
            except Exception as e:  # noqa: BLE001 — raised in step h
                queue_errors.append(e)

        poster = threading.Thread(target=post_queues)
        poster.start()
        drained = {}

        def all_drained() -> bool:
            for kind in CLOUD_SINKS:
                if kind not in drained and cloud_keys(kind) == want_keys(kind):
                    drained[kind] = time.perf_counter() - t0
            return len(drained) == len(CLOUD_SINKS)

        run.wait(all_drained, "GCS, Azure and B2 each holding every file under /cloud", 600)
        walls["e_drain"] = time.perf_counter() - t0
        k1 = server_launches()
        for kind in CLOUD_SINKS:
            objects = fakes[kind].objects.copy()
            bad = [p for p in paths if hashlib.sha256(
                objects[mirrors[kind] + p[len("/cloud"):]]).digest() != digests[p]]
            if bad:
                fail(f"{len(bad)} objects in {kind} differ from their files (first {bad[:3]})")
        degraded = launch_delta(k0, k1)
        if on_card:
            _must_launch("3n cloud, step e the runners' reads", degraded, ("gf_apply",))
        direct = {}
        for i in sorted(k1):
            mine = [(p, fid) for p, fid in touched_fids if int(fid.split(",")[0]) in held[i]]
            if not mine:
                continue
            served = k1[i]["degraded"] - k0[i]["degraded"]
            if served == 0:
                path, fid = mine[0]
                with urllib.request.urlopen(f"http://127.0.0.1:{ports[i]}/{fid}",
                                            timeout=60) as r:
                    body = r.read()
                if body != files[path]:
                    fail(f"volume{i}'s GET of {fid} ({path}) gave {len(body)} B")
                direct[i] = fid
                k1[i] = server_launches()[i]
                served = k1[i]["degraded"] - k0[i]["degraded"]
            if served == 0:
                fail(f"volume{i} served no degraded interval, even asked for "
                     f"{direct.get(i)} directly")
            if on_card and k1[i]["gf_apply"] <= k0[i]["gf_apply"]:
                fail(f"volume{i} served {served} degraded intervals but its K1 launches did "
                     f"not rise ({k0[i]['gf_apply']} -> {k1[i]['gf_apply']})")
        maps_seen = {n: _maps_has(run.procs[n].pid, "libcuda", "libtorch")
                     for n in ("broker", "filer", "filer_sqs", "filer_pubsub") + CLOUD_SINKS}
        runs["cloud_degraded"] = {"wall_s": walls["e_drain"], "launches": degraded,
                                  "sigs": {}, "files": len(paths), "touched": len(touched)}
        log(f"3n cloud on {card}: three `filer.replicate` runners drained {events} events "
            f"each into GCS / Azure / B2 in "
            f"{' / '.join(f'{drained[k]:.3f}' for k in CLOUD_SINKS)} s "
            f"({3 * total / walls['e_drain'] / 1e6:.1f} MB/s of objects in all) with "
            f"volume{victim} lost; {3 * len(paths)} objects SHA-256 equal; the survivors' "
            f"launches {degraded['gf_apply']} K1, {degraded['gf_bits']} K5 (K1 "
            f"{ {i: k1[i]['gf_apply'] - k0[i]['gf_apply'] for i in k1} }, K5 "
            f"{ {i: k1[i]['gf_bits'] - k0[i]['gf_bits'] for i in k1} }, degraded intervals "
            f"{ {i: k1[i]['degraded'] - k0[i]['degraded'] for i in k1} } by server"
            f"{'; asked directly: ' + str(direct) if direct else ''}); {smi}")

        # --- h. SQS and Pub/Sub ---
        step = "h queues"
        poster.join(300)
        if queue_errors or poster.is_alive():
            fail(f"POSTs to the queue filers: {queue_errors or 'still running'}")
        run.wait(lambda: all(len(fakes[k].messages) >= CLOUD_QUEUE_FILES for k in qports),
                 "the SQS and Pub/Sub fakes' messages", 60)
        got = {"sqs": sorted((k, text_format.Parse(b, fpb.EventNotification()).new_entry.name)
                             for k, b in fakes["sqs"].messages),
               "pubsub": sorted((k, fpb.EventNotification.FromString(d).new_entry.name)
                                for k, d in fakes["pubsub"].messages)}
        for kind in qports:
            want = sorted((p, p[1:]) for p in qfiles[kind])
            if got[kind] != want:
                fail(f"{kind} accepted {len(got[kind])} messages naming "
                     f"{got[kind][:3]}..., want {want[:3]}... ({len(want)})")

        # --- f. a directory deleted ---
        step = "f delete"
        top = max({p.split("/")[2] for p in paths if p.count("/") > 3},
                  key=lambda t: sum(p.startswith(f"/cloud/{t}/") for p in paths))
        gone = [p for p in paths if p.startswith(f"/cloud/{top}/")]
        t0 = time.perf_counter()
        c = http.client.HTTPConnection("127.0.0.1", fport, timeout=120)
        try:
            status, _, body = _http(c, "DELETE", f"/cloud/{top}?recursive=true")
        finally:
            c.close()
        if status not in (200, 202, 204):
            fail(f"DELETE /cloud/{top}?recursive=true: {status} {body[:200]!r}")

        def swept() -> bool:
            return all(not any(k.startswith(f"{mirrors[kind]}/{top}/") for k in cloud_keys(kind))
                       for kind in CLOUD_SINKS) and not any(
                k.startswith(f"{mirrors['backblaze']}/{top}/")
                for k in list(fakes["backblaze"].versions))

        run.wait(swept, f"the {len(gone)} files under /cloud/{top} gone from every cloud", 120)
        walls["f_delete"] = time.perf_counter() - t0
        files = {p: b for p, b in files.items() if p not in set(gone)}
        for kind in CLOUD_SINKS:
            if cloud_keys(kind) != want_keys(kind):
                fail(f"{kind} holds {len(cloud_keys(kind))} objects after the delete, want "
                     f"{len(files)}")

        # --- g. the GCS runner restarted ---
        step = "g restart"
        offsets = os.path.join(runner_homes["gcs"], "offsets")

        def committed() -> dict:
            return {p: int(open(os.path.join(offsets, f"p{p:03d}")).read())
                    for p in range(REPL_PARTITIONS)
                    if os.path.exists(os.path.join(offsets, f"p{p:03d}"))}

        high = highs()
        run.wait(lambda: committed() == {p: h for p, h in high.items() if h},
                 f"the GCS runner's offsets at the high watermarks {high}", 60)
        t0 = time.perf_counter()
        run.procs["gcs"].send_signal(signal.SIGTERM)
        run.rcs["gcs"] = run.procs["gcs"].wait(60)
        if run.rcs["gcs"] != 0:
            fail(f"the GCS runner exited {run.rcs['gcs']} on SIGTERM: {run.tail('gcs')}")
        puts = fakes["gcs"].objects.puts
        spawn_runner("gcs2", "gcs")
        run.wait(lambda: "consuming kafka" in run.tail("gcs2"), "the restarted runner", 60)
        time.sleep(2.5)  # more than two of its polls
        if fakes["gcs"].objects.puts != puts:
            fail(f"the restarted runner uploaded {fakes['gcs'].objects.puts - puts} objects "
                 f"from its offsets {committed()}")
        late = "/cloud/late/after-restart.bin"
        files[late] = np.random.default_rng(seed + 234).bytes(300_000)
        c = http.client.HTTPConnection("127.0.0.1", fport, timeout=120)
        try:
            post(c, (late, files[late]))
        finally:
            c.close()
        run.wait(lambda: f"{mirrors['gcs']}/late/after-restart.bin" in cloud_keys("gcs"),
                 "the file written after the restart in GCS", 60)
        if fakes["gcs"].objects.puts != puts + 1 or hashlib.sha256(
                fakes["gcs"].objects[f"{mirrors['gcs']}/late/after-restart.bin"]).digest() != \
                hashlib.sha256(files[late]).digest():
            fail(f"GCS took {fakes['gcs'].objects.puts - puts} uploads for the late file")
        walls["g_restart"] = time.perf_counter() - t0

        # --- i. the processes ---
        step = "i processes"
        maps_seen["gcs2"] = _maps_has(run.procs["gcs2"].pid, "libcuda", "libtorch")
        run.procs["gcs2"].send_signal(signal.SIGTERM)
        run.rcs["gcs2"] = run.procs["gcs2"].wait(60)
        if run.rcs["gcs2"] != 0:
            fail(f"the restarted GCS runner exited {run.rcs['gcs2']} on SIGTERM")
        if any(any(m.values()) for m in maps_seen.values()):
            fail(f"a filer, runner or the broker maps {maps_seen}")
        run.rcs["shell"] = shell.exit()
        if run.rcs["shell"]:
            fail(f"the shell exited {run.rcs['shell']}")
        runs["cloud"] = {"walls": walls, "files": len(paths), "events": events,
                         "touched": len(touched), "bytes": total,
                         "queues": {k: len(fakes[k].messages) for k in qports}}
    except Exception as e:  # noqa: BLE001 — re-raised below, named by its step
        failed = e
    finally:
        if shell is not None and shell.proc.poll() is None:
            shell.proc.kill()
        rcs = run.finish()
        for f in started:
            f.stop()
    if failed is not None:
        for name in run.procs:
            if name != "shell":
                log(f"3n cloud: {name} exited {rcs.get(name)}; its log ends: "
                    f"{run.tail(name)[-1500:]!r}")
        if str(failed).startswith("3n cloud, step"):
            raise failed
        raise AssertionError(f"3n cloud, step {step}: {type(failed).__name__}: "
                             f"{failed}") from failed
    bad = {n: rc for n, rc in rcs.items() if rc != 0 and n != f"volume{victim}"}
    if bad:
        raise AssertionError(f"3n cloud, step i processes: processes exited non-zero "
                             f"{bad}: { {n: run.tail(n) for n in bad if n != 'shell'} }")
    walls["phase"] = time.perf_counter() - phase_t0
    log(f"3n cloud: SQS and Pub/Sub accepted {CLOUD_QUEUE_FILES} messages each (SigV4, Bearer) "
        f"in {walls.get('h_queues', 0):.3f} s; /cloud/{top} ({len(gone)} files) gone from the "
        f"three clouds in {walls['f_delete']:.3f} s; the GCS runner SIGTERMed (0), restarted "
        f"from its offsets with no upload, the late file over, SIGTERMed (0) in "
        f"{walls['g_restart']:.3f} s; {len(rcs) - 1} processes exited 0 (volume{victim} "
        f"killed), none of the {len(maps_seen)} filers, runners and the broker mapping libcuda "
        f"or libtorch; walls (s) { {k: round(v, 3) for k, v in walls.items()} }")
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
                "batch", copies, workdir, card,
                f"batch encode of {len(copies)} volumes (one chunk)")
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
    # the server phase's load generator and the profiled encodes run this
    # script in processes of their own (_load_client, profile_encode)
    ap.add_argument("--http-client", nargs=2, metavar=("JOB", "OUT"), help=argparse.SUPPRESS)
    ap.add_argument("--profile-encode", nargs=2, metavar=("JOB", "OUT"),
                    help=argparse.SUPPRESS)
    args = ap.parse_args()
    if args.http_client:
        return http_client(*args.http_client)
    if args.profile_encode:
        return profiled_encode(*args.profile_encode)

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

    smoke_t0 = t0 = time.perf_counter()
    _build.build(_build.CUDA_SOURCES + ("crc32c.c", "gf256.c") + tuple(_build.EXT_MODULES))
    log(f"built {_build.CUDA_SOURCES}, the host CRC shim, the native GF(2^8) codec and the "
        f"CPython extensions {tuple(_build.EXT_MODULES)} (the needle codec with the one-pass "
        f"POST, the epoll serving core) in {time.perf_counter() - t0:.2f} s; host "
        f"{host_line()}")
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
    # the scrub's parity re-verify: one 4 MiB tile of each data shard
    k1_scrub = check_gf("scrub_tile", matrix[10:], args.seed + 20, card,
                        lanes=CLI_TILE // 4)
    apply_tile = time_apply_matrix(deg_rows, DEG_TILE_LANES, args.seed + 11, card)
    apply_run = time_apply_matrix(deg_rows, DEG_RUN_LANES, args.seed + 12, card, reps=5)
    # K5 at the degraded read's exact-interval buckets under 64 KiB (the
    # largest, 4 KiB and 1 KiB) and a 4-row decode, old and new design in turns
    k5 = [check_k5(label, rows, n, args.seed + seed, card)
          for (label, rows, n), seed in zip(k5_shapes(), (14, 15, 18, 19))]
    k4 = check_crc(args.seed + 2, card)
    k4_graphs = check_k4_graph_streams(args.seed + 17, card)
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
    t0 = time.perf_counter()
    swept = sweep_k5(args.seed + 16)
    log(f"K5 sweep over random (C, R) in 1..16, ragged and unaligned byte counts, "
        f"batches of 1..3: {swept} calls byte-exact vs plain "
        f"({time.perf_counter() - t0:.2f} s)")

    root = "/dev/shm" if os.path.isdir("/dev/shm") else None
    # phases 3-4, each in a fresh directory of its own, timed
    phases = (
        ("3 main path", lambda w: run_main_path(w, args.volume_mib << 20, args.seed, None, card)),
        ("3c store", lambda w: run_store_phase(w, STORE_BYTES, args.seed, None, card, smi)),
        ("3d server", lambda w: run_server_phase(w, STORE_BYTES, args.seed, None, card, smi)),
        ("3e cluster", lambda w: run_cluster_phase(w, CUT_BYTES, args.seed, None, card, smi)),
        ("3f admin", lambda w: run_admin_phase(w, CUT_BYTES, BATCH_VOLUMES, BATCH_VOLUME_BYTES,
                                               args.seed, None, card, smi)),
        ("3g cli", lambda w: run_cli_phase(w, CUT_BYTES, args.seed, None, card, smi)),
        ("3h edge", lambda w: run_edge_phase(w, args.seed, None, card, smi)),
        ("3i telemetry", lambda w: run_telemetry_phase(w, CUT_BYTES, args.seed, None, card,
                                                       smi)),
        ("3j filer", lambda w: run_filer_phase(w, CUT_BYTES, args.seed, None, card, smi)),
        ("3k s3", lambda w: run_s3_phase(w, S3_BYTES, args.seed, None, card, smi)),
        ("3l webdav/tier", lambda w: run_webdav_tier_phase(w, WEBDAV_BYTES, args.seed, None,
                                                           card, smi)),
        ("3m replication", lambda w: run_replication_phase(w, REPL_BYTES, args.seed, None,
                                                           card, smi)),
        ("3n cloud", lambda w: run_cloud_phase(w, CLOUD_BYTES, args.seed, None, card, smi)),
        ("4 batch", lambda w: run_batch_phase(w, BATCH_VOLUMES, BATCH_VOLUME_BYTES, args.seed,
                                              None, card)),
    )
    runs: dict = {}
    walls = {"1-2 device and kernels": time.perf_counter() - smoke_t0}
    for phase, run_phase in phases:
        workdir = tempfile.mkdtemp(prefix="chip_smoke_", dir=root)
        t0 = time.perf_counter()
        try:
            runs.update(run_phase(workdir))
        finally:
            shutil.rmtree(workdir, ignore_errors=True)
        walls[phase] = time.perf_counter() - t0
    log(f"phase walls (s) on {card}: { {k: round(v, 1) for k, v in walls.items()} }")
    log(f"encode and rebuild walls on {card}: through the server's verbs "
        f"{runs['server_encode']['wall_s']:.4f} / {runs['server_rebuild4']['wall_s']:.4f} s, "
        f"direct ec_files calls of the store phase {runs['store_encode']['wall_s']:.4f} / "
        f"{runs['store_rebuild4']['wall_s']:.4f} s (volumes of the same size mix); through "
        f"the shell's ec.encode / ec.rebuild {runs['admin_encode']['wall_s']:.4f} / "
        f"{runs['admin_rebuild']['wall_s']:.4f} s (the cluster's rack-gather rebuild "
        f"{runs['cluster_rebuild']['wall_s']:.4f} s); ec.batch / ec.rebuild.batch of "
        f"{BATCH_VOLUMES} volumes {runs['admin_batch']['wall_s']:.4f} / "
        f"{runs['admin_rebuild_batch']['wall_s']:.4f} s against the batch phase's direct "
        f"calls {runs['batch_encode']['wall_s']:.4f} / "
        f"{runs['batch_rebuild']['wall_s']:.4f} s")

    paths = ("encode", "rebuild1", "rebuild4", "degraded", "repair_piggyback",
             "repair_parity", "store_encode", "store_rebuild4", "store_serve", "store_tier",
             "server_encode", "server_rebuild4", "server_serve", "server_k5",
             "server_concurrent", "cluster_encode", "cluster_healthy", "cluster_serve",
             "cluster_k5", "cluster_rebuild") + ADMIN_PATHS + CLI_PATHS + (
             "edge_ec", "tele_degraded", "filer_encode", "filer_degraded", "s3_encode",
             "s3_degraded", "webdav_encode", "webdav_degraded", "tier_encode",
             "tier_degraded", "repl_encode", "repl_degraded", "cloud_encode",
             "cloud_degraded", "batch_encode",
             "batch_rebuild", "batch_verify")
    total = {kn: sum(runs[r]["launches"][kn] for r in paths) for kn in _counts()}
    log(f"launches over every path (single-volume encode and rebuilds, degraded reads, "
        f"piggybacked and parity rebuilds, the store's encode, rebuild, serve and tier "
        f"reads, the server's encode, rebuild, degraded GETs with and without the tile "
        f"cache and concurrent encodes, the cluster's encode, healthy and lost-server GETs "
        f"with and without the tile cache and rack-gather rebuild, the shell's ec.encode, "
        f"ec.balance, ec.rebuild, ec.batch, ec.rebuild.batch and volume.move, the command "
        f"line's ec.encode, scrub sweeps and scheduled repair in the servers' processes "
        f"and the verify core in this one, the serving edge's EC GETs on a -workers lead, "
        f"the telemetry phase's degraded weedload GETs, the filer phase's ec.encode and "
        f"degraded reads through the filer, the S3 phase's ec.encode and degraded reads "
        f"through the gateway, the WebDAV/tier phase's two ec.encode runs, degraded reads "
        f"through WebDAV and reads of an EC volume tiered to the S3 gateway with four shard "
        f"objects lost, the replication phase's ec.encode and the consumer's degraded chunk "
        f"reads, the cloud phase's ec.encode and its three runners' degraded chunk reads, "
        f"batch encode, rebuild and verify) "
        f"on {card}: "
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
    from seaweedfs_tpu_torch.ec import codec_cuda

    for label, srv, tg in (("decode (0,)", survivors, (0,)), ("decode (5,)", survivors, (5,))):
        names[codec_cuda.gf_matrix_to_bits(gf256.decode_rows(matrix, srv, tg)).tobytes()] = (
            label)
    # the cluster phase: shards 0-3 from the survivors 4-13
    cluster_srv = CLUSTER_B + CLUSTER_C
    for tg in [(i,) for i in CLUSTER_A] + [CLUSTER_A]:
        rows = gf256.decode_rows(matrix, cluster_srv, tg)
        names[rows.astype(np.uint8).tobytes()] = f"cluster decode {tg}"
        if len(tg) == 1:
            names[codec_cuda.gf_matrix_to_bits(rows).tobytes()] = f"cluster decode {tg}"
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
                "library_ms": first.get("library_ms")}

    kernels = [
        row("gf_apply", K1_SOURCE, K1_REPLACES, k1_enc, k1_dec, k1_dec1, k1_tile, k1_run,
            k1_scrub),
        row("gf_apply_batch", K1_SOURCE, K2_REPLACES, k2_enc, k2_dec),
        row("gf_verify_batch", K3_SOURCE, K3_REPLACES, k3),
        row("crc32c_rows", K4_SOURCE, K4_REPLACES, k4, k4_graphs),
        row("gf_bits", K5_SOURCE, K5_REPLACES, *k5),
    ]
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": name,
                                             "count": count}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
