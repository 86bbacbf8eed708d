"""The volume server's data plane: HTTP blob path, gRPC admin and EC
verbs (volume_server.py) and its write path (write_path.py)."""
