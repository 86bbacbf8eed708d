"""Batched RS(k, p) over a mesh of devices (the counterpart of
seaweedfs_tpu/parallel/mesh_codec.py).

A mesh is a [vol, stripe] grid of torch devices: the cards of one host,
or CPU devices for the tests. A batch is laid out over it as the
reference's shardings are:

  volumes  [B, k, N]  split along B by 'vol' and along N by 'stripe'
  parity   [B, p, N]  the same
  crcs     [B, k+p]   split by 'vol' (whole-row CRCs, after the stripe fold)
  counts   [B]        split by 'vol' (summed over 'stripe')

Per device the work is one kernel on its [B/vol, k, N/stripe] block: K2
(codec_cuda.gf_apply_u32_batch) for encode and reconstruct, K3
(gf_verify_u32_batch) for verify, K4 for the fused CRCs. In place of the
reference's collectives over the stripe axis (all_gather + Z-shift fold
of raw CRCs, psum of counts), the few words per volume are combined with
plain torch ops on the first device of each 'vol' row. On one card the
mesh is 1x1 and there is nothing to combine. On CPU devices every kernel
runs its plain version.

Kernels are enqueued on each device's current stream; results stay on
the devices until `Sharded.fetch` copies them home.

Role: the batched encode fan-out of the reference's shell
command_ec_encode.go:153 + ec_encoder.go:173, and the batched
degraded-read rebuild of store_ec.go:344-373 (SURVEY §2.6.5).
"""

from __future__ import annotations

import contextlib

import numpy as np
import torch

from seaweedfs_tpu_torch.ec import crc_kernel
from seaweedfs_tpu_torch.ec.codec_cuda import CudaCodecKernels

VOL_AXIS = "vol"
STRIPE_AXIS = "stripe"


class Mesh:
    """A [vol, stripe] grid of torch devices (`devices` is an object
    ndarray of that shape, as jax.sharding.Mesh.devices is)."""

    axis_names = (VOL_AXIS, STRIPE_AXIS)

    def __init__(self, devices: np.ndarray):
        self.devices = devices

    @property
    def shape(self) -> dict[str, int]:
        vol, stripe = self.devices.shape
        return {VOL_AXIS: vol, STRIPE_AXIS: stripe}

    def distinct_devices(self) -> list[torch.device]:
        return list(dict.fromkeys(self.devices.flat))


def cuda_devices() -> list[torch.device]:
    """Every card of this host; raises when there is none."""
    if not torch.cuda.is_available():
        raise RuntimeError(
            "the batch EC arm needs a CUDA device; pass a mesh of "
            "torch.device('cpu') to run its plain versions on the host"
        )
    return [torch.device("cuda", i) for i in range(torch.cuda.device_count())]


def make_mesh(devices: list | None = None, stripe: int | None = None) -> Mesh:
    """A (vol x stripe) mesh over `devices` (default: every card; raises
    without one). stripe=None picks 2 when the device count is even,
    else 1, as the reference does."""
    devs = [torch.device(d) for d in (devices if devices is not None else cuda_devices())]
    n = len(devs)
    if not n:
        raise ValueError("a mesh needs at least one device")
    for d in devs:
        if d.type not in ("cuda", "cpu"):
            raise ValueError(f"unsupported mesh device {d}")
    if stripe is None:
        stripe = 2 if n % 2 == 0 else 1
    if stripe < 1 or n % stripe:
        raise ValueError(f"{n} devices do not split into stripe={stripe}")
    grid = np.empty(n, dtype=object)
    grid[:] = devs
    return Mesh(grid.reshape(n // stripe, stripe))


def _on(device: torch.device):
    """Make `device` current for a ctypes launch (multi-card meshes)."""
    if device.type == "cuda":
        return torch.cuda.device(device)
    return contextlib.nullcontext()


class HostFetch:
    """Blocks on their way to the host: `wait()` returns the whole batch
    as one CPU tensor once every device's copies have landed."""

    def __init__(self, host: list[list[torch.Tensor]], events: list, keep):
        self._host = host
        self._events = events
        self._keep = keep  # device blocks stay referenced until wait()

    def wait(self) -> torch.Tensor:
        for ev in self._events:
            ev.synchronize()
        self._keep = None
        if len(self._host) == 1 and len(self._host[0]) == 1:
            return self._host[0][0]
        return torch.cat([torch.cat(row, dim=-1) for row in self._host], dim=0)


class Sharded:
    """A batch laid out over a mesh: blocks[i][j] is the block on
    mesh.devices[i, j]. Results that are whole per volume (CRCs,
    counts) hold one block per 'vol' row. `tiles`, when set, holds per
    device the batch tile (CudaCodecKernels.batch_tile_parts) whose data
    part is the block, with room for the parity after it."""

    def __init__(self, blocks: list[list[torch.Tensor]], tiles=None):
        self.blocks = blocks
        self.tiles = tiles

    @property
    def shape(self) -> tuple[int, ...]:
        first = self.blocks[0][0]
        b = sum(row[0].shape[0] for row in self.blocks)
        if first.dim() == 1:
            return (b,)
        return (b, *first.shape[1:-1], sum(blk.shape[-1] for blk in self.blocks[0]))

    def fetch(self) -> HostFetch:
        """Start the copies home: each CUDA block into pinned memory,
        non_blocking on its device's current stream, one event per
        device. CPU blocks are handed over as they are."""
        host, events, devices = [], [], {}
        for row in self.blocks:
            hrow = []
            for blk in row:
                if blk.is_cuda:
                    h = torch.empty(blk.shape, dtype=blk.dtype, pin_memory=True)
                    h.copy_(blk, non_blocking=True)
                    devices[blk.device] = None
                else:
                    h = blk
                hrow.append(h)
            host.append(hrow)
        for dev in devices:
            ev = torch.cuda.Event()
            ev.record(torch.cuda.current_stream(dev))
            events.append(ev)
        return HostFetch(host, events, self)

    def cpu(self) -> torch.Tensor:
        return self.fetch().wait()

    def __array__(self, dtype=None, copy=None):
        out = self.cpu().numpy()
        return out if dtype is None else out.astype(dtype)


def _as_tensor(host) -> torch.Tensor:
    """numpy or torch batch -> torch; u32 lanes ride as int32."""
    if isinstance(host, torch.Tensor):
        return host
    host = np.asarray(host)
    if host.dtype == np.uint32:
        host = host.view(np.int32)
    return torch.from_numpy(np.ascontiguousarray(host))


def _lanes(blk: torch.Tensor) -> torch.Tensor:
    """[Bb, C, Nb] uint8 -> [Bb, C, ceil(Nb/4)] int32 lanes, zero-padded
    (GF math is positionwise: padding never changes the first Nb bytes).
    A byte view is free on the card, unlike the TPU's tiled relayout."""
    nb = blk.shape[-1]
    if nb % 4 or not blk.is_contiguous():
        padded = torch.zeros(
            (*blk.shape[:-1], -(-nb // 4) * 4), dtype=torch.uint8, device=blk.device
        )
        padded[..., :nb] = blk
        blk = padded
    return blk.view(torch.int32)


def _bytes(lanes: torch.Tensor, nb: int) -> torch.Tensor:
    out = lanes.view(torch.uint8)
    return out if out.shape[-1] == nb else out[..., :nb].contiguous()


class MeshCodec:
    """RS(k, p) batched encode / rebuild / verify over a Mesh. `matrix`
    (an [n, k] systematic code matrix, e.g. the reference MeshCodec's)
    defaults to the reference construction."""

    def __init__(
        self,
        mesh: Mesh,
        data_shards: int = 10,
        parity_shards: int = 4,
        matrix: np.ndarray | None = None,
    ):
        self.mesh = mesh
        self.data_shards = data_shards
        self.parity_shards = parity_shards
        self.total_shards = data_shards + parity_shards
        self._kerns = {
            dev: CudaCodecKernels(data_shards, parity_shards, device=dev, matrix=matrix)
            for dev in mesh.distinct_devices()
        }
        self.matrix = next(iter(self._kerns.values())).matrix

    @property
    def devices(self) -> list[torch.device]:
        return self.mesh.distinct_devices()

    def _grid(self):
        """(i, j, device, kernels) over the mesh."""
        vol, stripe = self.mesh.devices.shape
        for i in range(vol):
            for j in range(stripe):
                dev = self.mesh.devices[i, j]
                yield i, j, dev, self._kerns[dev]

    def _map(self, fn, *batches: Sharded) -> Sharded:
        """Sharded result of fn(kernels, *blocks) on every device."""
        vol, stripe = self.mesh.devices.shape
        out = [[None] * stripe for _ in range(vol)]
        for i, j, dev, kern in self._grid():
            with _on(dev):
                out[i][j] = fn(kern, *(b.blocks[i][j] for b in batches))
        return Sharded(out)

    # --- sharding helpers ---
    def shard_volumes(
        self, host_volumes, parity_room: bool = False, non_blocking: bool = False
    ) -> Sharded:
        """[B, C, N] host batch (numpy or torch; u32 lanes as int32) ->
        Sharded blocks [B/vol, C, N/stripe], each contiguous on its
        device. parity_room=True (C = k) allocates each block as the data
        part of a batch tile, kept in Sharded.tiles, so a fused encode
        writes the parity beside it (encode_batch_u32_crc). non_blocking
        copies from pinned memory without waiting."""
        host = _as_tensor(host_volumes)
        b, c, n = host.shape
        vol, stripe = self.mesh.devices.shape
        if b % vol:
            raise ValueError(f"batch {b} does not shard {vol}-way")
        if n % stripe:
            raise ValueError(f"stream {n} does not stripe {stripe}-way")
        if parity_room and c != self.data_shards:
            raise ValueError(f"parity room is for [B, {self.data_shards}, N] data")
        bb, nb = b // vol, n // stripe
        blocks = [[None] * stripe for _ in range(vol)]
        tiles = [[None] * stripe for _ in range(vol)] if parity_room else None
        for i, j, dev, kern in self._grid():
            src = host[i * bb : (i + 1) * bb, :, j * nb : (j + 1) * nb]
            if parity_room:
                tiles[i][j] = torch.empty(
                    (bb * self.total_shards, nb), dtype=host.dtype, device=dev
                )
                blk = kern.batch_tile_parts(tiles[i][j])[0]
            else:
                blk = torch.empty((bb, c, nb), dtype=host.dtype, device=dev)
            blk.copy_(src, non_blocking=non_blocking)
            blocks[i][j] = blk
        return Sharded(blocks, tiles)

    # --- contracts the drivers and the MULTICHIP dryrun read ---
    def crc_supported(self, n_bytes: int) -> bool:
        """True when the fused CRC pass serves streams of n_bytes: whole
        u32 lanes per device, power-of-two lane count."""
        stripe = self.mesh.shape[STRIPE_AXIS]
        if n_bytes % stripe:
            return False
        return crc_kernel.crc_supported(n_bytes // stripe)

    def batch_layout(self, batch: int, n_bytes: int) -> dict:
        """Per-device work split for a [batch, k, n_bytes] encode:
        volumes per device along 'vol', stream bytes per device along
        'stripe'."""
        vol = self.mesh.shape[VOL_AXIS]
        stripe = self.mesh.shape[STRIPE_AXIS]
        if batch % vol:
            raise ValueError(f"batch {batch} does not shard {vol}-way")
        if n_bytes % stripe:
            raise ValueError(f"stream {n_bytes} does not stripe {stripe}-way")
        return {
            "vol": vol,
            "stripe": stripe,
            "devices": vol * stripe,
            "per_device_volumes": batch // vol,
            "per_device_bytes": n_bytes // stripe,
        }

    # --- u32-lane APIs (the drivers' path) ---
    def encode_batch_u32(self, volumes_u32: Sharded) -> Sharded:
        """volumes [B, k, N32] lanes -> parity [B, p, N32] lanes: one K2
        launch per device."""
        return self._map(lambda kern, blk: kern.encode_batch_u32(blk), volumes_u32)

    def encode_batch_u32_crc(self, volumes_u32: Sharded) -> tuple[Sharded, Sharded]:
        """Fused batch encode + CRC: [B, k, N32] lanes -> (parity
        [B, p, N32], crcs [B, k+p] int32: the standard CRC-32C of every
        shard row's whole N32*4-byte stream). Per device one K2 and one
        K4 launch over a batch tile (the blocks' own when they came from
        shard_volumes(..., parity_room=True), else a new one the data is
        copied into); with stripe > 1 the devices' raw CRCs are folded by
        Z shifts. Requires crc_supported(N32 * 4)."""
        n32 = volumes_u32.shape[-1]
        if not self.crc_supported(n32 * 4):
            raise ValueError(
                f"stream of {n32} lanes unsupported by the fused CRC pass "
                f"(per-device lanes must be a power of two)"
            )
        vol, stripe = self.mesh.devices.shape
        parity = [[None] * stripe for _ in range(vol)]
        segs = [[None] * stripe for _ in range(vol)]
        for i, j, dev, kern in self._grid():
            blk = volumes_u32.blocks[i][j]
            with _on(dev):
                if volumes_u32.tiles is not None:
                    tile = volumes_u32.tiles[i][j]
                else:
                    bb, _, nb = blk.shape
                    tile = torch.empty(
                        (bb * self.total_shards, nb), dtype=blk.dtype, device=blk.device
                    )
                    kern.batch_tile_parts(tile)[0].copy_(blk)
                segs[i][j] = kern.encode_batch_tile_crc(tile, raw=stripe > 1)
                parity[i][j] = kern.batch_tile_parts(tile)[1]
        if stripe > 1:
            seg_bytes = n32 * 4 // stripe
            crcs = [[crc_kernel.combine_segments(row, seg_bytes)] for row in segs]
        else:
            crcs = [[row[0]] for row in segs]
        return Sharded(parity), Sharded(crcs)

    def reconstruct_batch_u32(
        self,
        survivors: tuple[int, ...],
        targets: tuple[int, ...],
        shard_data_u32: Sharded,
    ) -> Sharded:
        """Survivor blocks [B, k, N32] lanes (in `survivors` order) ->
        rebuilt [B, len(targets), N32] lanes: one K2 launch per device."""
        s, t = tuple(survivors), tuple(targets)
        return self._map(
            lambda kern, blk: kern.reconstruct_batch_u32(s, t, blk), shard_data_u32
        )

    def verify_batch_u32(self, volumes_u32: Sharded, parity_u32: Sharded) -> Sharded:
        """[B] int32 counts of mismatched (parity row, u32 lane) pairs, 0 =
        verified: one K3 launch per device, the counts summed over the
        stripe axis."""
        counts = self._map(
            lambda kern, d, p: kern.verify_batch_u32(d, p), volumes_u32, parity_u32
        )
        return _sum_over_stripe(counts)

    # --- byte-layout APIs ---
    def encode_batch(self, volumes: Sharded) -> Sharded:
        """volumes [B, k, N] uint8 -> parity [B, p, N] uint8 (K2 on free
        byte<->lane views, zero-padded to whole lanes)."""
        return self._map(
            lambda kern, blk: _bytes(kern.encode_batch_u32(_lanes(blk)), blk.shape[-1]),
            volumes,
        )

    def reconstruct_batch(
        self,
        survivors: tuple[int, ...],
        targets: tuple[int, ...],
        shard_data: Sharded,
    ) -> Sharded:
        """shard_data [B, k, N] uint8 survivor blocks (in `survivors`
        order) -> [B, len(targets), N] uint8 rebuilt blocks."""
        s, t = tuple(survivors), tuple(targets)
        return self._map(
            lambda kern, blk: _bytes(
                kern.reconstruct_batch_u32(s, t, _lanes(blk)), blk.shape[-1]
            ),
            shard_data,
        )

    def verify_batch(self, volumes: Sharded, parity: Sharded) -> Sharded:
        """Per-volume count of mismatched BYTES between recomputed and
        given parity: [B] int32, 0 = verified. The recompute is K2; the
        compare-and-sum is plain torch, as the reference leaves it to
        XLA. (verify_batch_u32 counts mismatched lanes instead.)"""

        def per_device(kern, blk, par):
            recomputed = _bytes(kern.encode_batch_u32(_lanes(blk)), blk.shape[-1])
            return (recomputed != par).sum(dim=(1, 2)).to(torch.int32)

        return _sum_over_stripe(self._map(per_device, volumes, parity))


def _sum_over_stripe(per_device: Sharded) -> Sharded:
    """Per-device [Bb] counts -> one [Bb] block per 'vol' row, summed on
    the row's first device (the reference's psum over 'stripe')."""
    rows = []
    for row in per_device.blocks:
        acc = row[0]
        for c in row[1:]:
            acc = acc + c.to(acc.device)
        rows.append([acc])
    return Sharded(rows)
