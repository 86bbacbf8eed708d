"""Experimental select-from-files query engine (reference weed/query/)."""

from seaweedfs_tpu_torch.query.json_query import Query, query_json  # noqa: F401
