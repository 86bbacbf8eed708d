"""Wire-protocol definitions: protobuf messages + gRPC method tables.

master.proto / volume.proto are compiled with `protoc --python_out`
(make_pb.sh). The environment ships grpc but not grpc_tools, so the
service layer (stubs + servicer registration) is built from the method
tables in rpc.py via grpc's generic-handler API instead of generated
*_pb2_grpc modules.
"""
