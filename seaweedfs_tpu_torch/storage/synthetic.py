"""Sealed volumes of random needles made from a seed: the input that
chip_smoke.py and the port's tests encode, read and rebuild."""

from __future__ import annotations

import numpy as np

from seaweedfs_tpu_torch.storage import idx as idx_codec
from seaweedfs_tpu_torch.storage import types as t
from seaweedfs_tpu_torch.storage.needle import Needle
from seaweedfs_tpu_torch.storage.super_block import VERSION3, SuperBlock


def write_volume(base: str, nbytes: int, seed: int,
                 max_payload: int = 4 << 20) -> tuple[int, list]:
    """A sealed v3 volume of about `nbytes` at `base`: superblock,
    needles with random payloads of log-uniform size over
    1 KiB-`max_payload`, and .idx. Returns (dat size, [(id, offset,
    size)])."""
    rng = np.random.default_rng(seed)
    entries = []
    with open(base + ".dat", "wb") as dat, open(base + ".idx", "wb") as idx:
        dat.write(SuperBlock(version=VERSION3).to_bytes())
        off = dat.tell()
        nid = 1
        while off < nbytes:
            size = int(np.exp(rng.uniform(np.log(1024), np.log(max_payload))))
            n = Needle(cookie=int(rng.integers(1 << 32)), id=nid,
                       data=rng.bytes(size), append_at_ns=nid)
            rec = n.to_bytes(VERSION3)
            dat.write(rec)
            idx.write(idx_codec.pack_entry(nid, t.offset_to_units(off), n.size))
            entries.append((nid, off, n.size))
            off += len(rec)
            nid += 1
    return off, entries
