# -*- coding: utf-8 -*-
# Generated by the protocol buffer compiler.  DO NOT EDIT!
# source: seaweedfs_tpu/pb/tikv.proto
"""Generated protocol buffer code."""
from google.protobuf.internal import builder as _builder
from google.protobuf import descriptor as _descriptor
from google.protobuf import descriptor_pool as _descriptor_pool
from google.protobuf import symbol_database as _symbol_database
# @@protoc_insertion_point(imports)

_sym_db = _symbol_database.Default()




DESCRIPTOR = _descriptor_pool.Default().AddSerializedFile(b'\n\x1bseaweedfs_tpu/pb/tikv.proto\x12\x12seaweedfs_tpu.tikv\"0\n\x0bRegionEpoch\x12\x10\n\x08\x63onf_ver\x18\x01 \x01(\x04\x12\x0f\n\x07version\x18\x02 \x01(\x04\"$\n\x04Peer\x12\n\n\x02id\x18\x01 \x01(\x04\x12\x10\n\x08store_id\x18\x02 \x01(\x04\"\x98\x01\n\x06Region\x12\n\n\x02id\x18\x01 \x01(\x04\x12\x11\n\tstart_key\x18\x02 \x01(\x0c\x12\x0f\n\x07\x65nd_key\x18\x03 \x01(\x0c\x12\x35\n\x0cregion_epoch\x18\x04 \x01(\x0b\x32\x1f.seaweedfs_tpu.tikv.RegionEpoch\x12\'\n\x05peers\x18\x05 \x03(\x0b\x32\x18.seaweedfs_tpu.tikv.Peer\"$\n\x05Store\x12\n\n\x02id\x18\x01 \x01(\x04\x12\x0f\n\x07\x61\x64\x64ress\x18\x02 \x01(\t\"\x1e\n\x0bRegionError\x12\x0f\n\x07message\x18\x01 \x01(\t\"{\n\x07\x43ontext\x12\x11\n\tregion_id\x18\x01 \x01(\x04\x12\x35\n\x0cregion_epoch\x18\x02 \x01(\x0b\x32\x1f.seaweedfs_tpu.tikv.RegionEpoch\x12&\n\x04peer\x18\x03 \x01(\x0b\x32\x18.seaweedfs_tpu.tikv.Peer\"V\n\rRawGetRequest\x12,\n\x07\x63ontext\x18\x01 \x01(\x0b\x32\x1b.seaweedfs_tpu.tikv.Context\x12\x0b\n\x03key\x18\x02 \x01(\x0c\x12\n\n\x02\x63\x66\x18\x03 \x01(\t\"x\n\x0eRawGetResponse\x12\x35\n\x0cregion_error\x18\x01 \x01(\x0b\x32\x1f.seaweedfs_tpu.tikv.RegionError\x12\r\n\x05\x65rror\x18\x02 \x01(\t\x12\r\n\x05value\x18\x03 \x01(\x0c\x12\x11\n\tnot_found\x18\x04 \x01(\x08\"e\n\rRawPutRequest\x12,\n\x07\x63ontext\x18\x01 \x01(\x0b\x32\x1b.seaweedfs_tpu.tikv.Context\x12\x0b\n\x03key\x18\x02 \x01(\x0c\x12\r\n\x05value\x18\x03 \x01(\x0c\x12\n\n\x02\x63\x66\x18\x04 \x01(\t\"V\n\x0eRawPutResponse\x12\x35\n\x0cregion_error\x18\x01 \x01(\x0b\x32\x1f.seaweedfs_tpu.tikv.RegionError\x12\r\n\x05\x65rror\x18\x02 \x01(\t\"Y\n\x10RawDeleteRequest\x12,\n\x07\x63ontext\x18\x01 \x01(\x0b\x32\x1b.seaweedfs_tpu.tikv.Context\x12\x0b\n\x03key\x18\x02 \x01(\x0c\x12\n\n\x02\x63\x66\x18\x03 \x01(\t\"Y\n\x11RawDeleteResponse\x12\x35\n\x0cregion_error\x18\x01 \x01(\x0b\x32\x1f.seaweedfs_tpu.tikv.RegionError\x12\r\n\x05\x65rror\x18\x02 \x01(\t\"u\n\x15RawDeleteRangeRequest\x12,\n\x07\x63ontext\x18\x01 \x01(\x0b\x32\x1b.seaweedfs_tpu.tikv.Context\x12\x11\n\tstart_key\x18\x02 \x01(\x0c\x12\x0f\n\x07\x65nd_key\x18\x03 \x01(\x0c\x12\n\n\x02\x63\x66\x18\x04 \x01(\t\"^\n\x16RawDeleteRangeResponse\x12\x35\n\x0cregion_error\x18\x01 \x01(\x0b\x32\x1f.seaweedfs_tpu.tikv.RegionError\x12\r\n\x05\x65rror\x18\x02 \x01(\t\"3\n\x06KvPair\x12\r\n\x05\x65rror\x18\x01 \x01(\t\x12\x0b\n\x03key\x18\x02 \x01(\x0c\x12\r\n\x05value\x18\x03 \x01(\x0c\"\xa0\x01\n\x0eRawScanRequest\x12,\n\x07\x63ontext\x18\x01 \x01(\x0b\x32\x1b.seaweedfs_tpu.tikv.Context\x12\x11\n\tstart_key\x18\x02 \x01(\x0c\x12\r\n\x05limit\x18\x03 \x01(\r\x12\x10\n\x08key_only\x18\x04 \x01(\x08\x12\n\n\x02\x63\x66\x18\x05 \x01(\t\x12\x0f\n\x07reverse\x18\x06 \x01(\x08\x12\x0f\n\x07\x65nd_key\x18\x07 \x01(\x0c\"q\n\x0fRawScanResponse\x12\x35\n\x0cregion_error\x18\x01 \x01(\x0b\x32\x1f.seaweedfs_tpu.tikv.RegionError\x12\'\n\x03kvs\x18\x02 \x03(\x0b\x32\x1a.seaweedfs_tpu.tikv.KvPair\"#\n\rRequestHeader\x12\x12\n\ncluster_id\x18\x01 \x01(\x04\"(\n\x07PdError\x12\x0c\n\x04type\x18\x01 \x01(\x05\x12\x0f\n\x07message\x18\x02 \x01(\t\"P\n\x0eResponseHeader\x12\x12\n\ncluster_id\x18\x01 \x01(\x04\x12*\n\x05\x65rror\x18\x02 \x01(\x0b\x32\x1b.seaweedfs_tpu.tikv.PdError\"Q\n\x06Member\x12\x0c\n\x04name\x18\x01 \x01(\t\x12\x11\n\tmember_id\x18\x02 \x01(\x04\x12\x11\n\tpeer_urls\x18\x03 \x03(\t\x12\x13\n\x0b\x63lient_urls\x18\x04 \x03(\t\"F\n\x11GetMembersRequest\x12\x31\n\x06header\x18\x01 \x01(\x0b\x32!.seaweedfs_tpu.tikv.RequestHeader\"\xa1\x01\n\x12GetMembersResponse\x12\x32\n\x06header\x18\x01 \x01(\x0b\x32\".seaweedfs_tpu.tikv.ResponseHeader\x12+\n\x07members\x18\x02 \x03(\x0b\x32\x1a.seaweedfs_tpu.tikv.Member\x12*\n\x06leader\x18\x03 \x01(\x0b\x32\x1a.seaweedfs_tpu.tikv.Member\"Y\n\x10GetRegionRequest\x12\x31\n\x06header\x18\x01 \x01(\x0b\x32!.seaweedfs_tpu.tikv.RequestHeader\x12\x12\n\nregion_key\x18\x02 \x01(\x0c\"\x9d\x01\n\x11GetRegionResponse\x12\x32\n\x06header\x18\x01 \x01(\x0b\x32\".seaweedfs_tpu.tikv.ResponseHeader\x12*\n\x06region\x18\x02 \x01(\x0b\x32\x1a.seaweedfs_tpu.tikv.Region\x12(\n\x06leader\x18\x03 \x01(\x0b\x32\x18.seaweedfs_tpu.tikv.Peer\"V\n\x0fGetStoreRequest\x12\x31\n\x06header\x18\x01 \x01(\x0b\x32!.seaweedfs_tpu.tikv.RequestHeader\x12\x10\n\x08store_id\x18\x02 \x01(\x04\"p\n\x10GetStoreResponse\x12\x32\n\x06header\x18\x01 \x01(\x0b\x32\".seaweedfs_tpu.tikv.ResponseHeader\x12(\n\x05store\x18\x02 \x01(\x0b\x32\x19.seaweedfs_tpu.tikv.Storeb\x06proto3')

_builder.BuildMessageAndEnumDescriptors(DESCRIPTOR, globals())
_builder.BuildTopDescriptorsAndMessages(DESCRIPTOR, 'seaweedfs_tpu.pb.tikv_pb2', globals())
if _descriptor._USE_C_DESCRIPTORS == False:

  DESCRIPTOR._options = None
  _REGIONEPOCH._serialized_start=51
  _REGIONEPOCH._serialized_end=99
  _PEER._serialized_start=101
  _PEER._serialized_end=137
  _REGION._serialized_start=140
  _REGION._serialized_end=292
  _STORE._serialized_start=294
  _STORE._serialized_end=330
  _REGIONERROR._serialized_start=332
  _REGIONERROR._serialized_end=362
  _CONTEXT._serialized_start=364
  _CONTEXT._serialized_end=487
  _RAWGETREQUEST._serialized_start=489
  _RAWGETREQUEST._serialized_end=575
  _RAWGETRESPONSE._serialized_start=577
  _RAWGETRESPONSE._serialized_end=697
  _RAWPUTREQUEST._serialized_start=699
  _RAWPUTREQUEST._serialized_end=800
  _RAWPUTRESPONSE._serialized_start=802
  _RAWPUTRESPONSE._serialized_end=888
  _RAWDELETEREQUEST._serialized_start=890
  _RAWDELETEREQUEST._serialized_end=979
  _RAWDELETERESPONSE._serialized_start=981
  _RAWDELETERESPONSE._serialized_end=1070
  _RAWDELETERANGEREQUEST._serialized_start=1072
  _RAWDELETERANGEREQUEST._serialized_end=1189
  _RAWDELETERANGERESPONSE._serialized_start=1191
  _RAWDELETERANGERESPONSE._serialized_end=1285
  _KVPAIR._serialized_start=1287
  _KVPAIR._serialized_end=1338
  _RAWSCANREQUEST._serialized_start=1341
  _RAWSCANREQUEST._serialized_end=1501
  _RAWSCANRESPONSE._serialized_start=1503
  _RAWSCANRESPONSE._serialized_end=1616
  _REQUESTHEADER._serialized_start=1618
  _REQUESTHEADER._serialized_end=1653
  _PDERROR._serialized_start=1655
  _PDERROR._serialized_end=1695
  _RESPONSEHEADER._serialized_start=1697
  _RESPONSEHEADER._serialized_end=1777
  _MEMBER._serialized_start=1779
  _MEMBER._serialized_end=1860
  _GETMEMBERSREQUEST._serialized_start=1862
  _GETMEMBERSREQUEST._serialized_end=1932
  _GETMEMBERSRESPONSE._serialized_start=1935
  _GETMEMBERSRESPONSE._serialized_end=2096
  _GETREGIONREQUEST._serialized_start=2098
  _GETREGIONREQUEST._serialized_end=2187
  _GETREGIONRESPONSE._serialized_start=2190
  _GETREGIONRESPONSE._serialized_end=2347
  _GETSTOREREQUEST._serialized_start=2349
  _GETSTOREREQUEST._serialized_end=2435
  _GETSTORERESPONSE._serialized_start=2437
  _GETSTORERESPONSE._serialized_end=2549
# @@protoc_insertion_point(module_scope)
