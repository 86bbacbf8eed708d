from seaweedfs_tpu_torch.s3api.s3api_server import S3ApiServer

__all__ = ["S3ApiServer"]
