"""Volume naming and the not-found error shared by the read paths: the
part of seaweedfs_tpu/storage/volume.py an EC volume needs. The Volume
class itself comes with the rest of storage/."""

from __future__ import annotations

import os


class NeedleNotFound(KeyError):
    pass


def volume_base_name(directory: str, collection: str, vid: int) -> str:
    if collection:
        return os.path.join(directory, f"{collection}_{vid}")
    return os.path.join(directory, str(vid))
