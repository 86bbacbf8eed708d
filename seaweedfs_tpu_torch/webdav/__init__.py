from seaweedfs_tpu_torch.webdav.webdav_server import WebDavServer

__all__ = ["WebDavServer"]
