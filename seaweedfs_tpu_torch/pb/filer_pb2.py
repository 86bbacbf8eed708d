# -*- coding: utf-8 -*-
# Generated by the protocol buffer compiler.  DO NOT EDIT!
# source: seaweedfs_tpu/pb/filer.proto
"""Generated protocol buffer code."""
from google.protobuf.internal import builder as _builder
from google.protobuf import descriptor as _descriptor
from google.protobuf import descriptor_pool as _descriptor_pool
from google.protobuf import symbol_database as _symbol_database
# @@protoc_insertion_point(imports)

_sym_db = _symbol_database.Default()




DESCRIPTOR = _descriptor_pool.Default().AddSerializedFile(b'\n\x1cseaweedfs_tpu/pb/filer.proto\x12\x13seaweedfs_tpu.filer\"h\n\tFileChunk\x12\x0b\n\x03\x66id\x18\x01 \x01(\t\x12\x0e\n\x06offset\x18\x02 \x01(\x03\x12\x0c\n\x04size\x18\x03 \x01(\x04\x12\r\n\x05mtime\x18\x04 \x01(\x03\x12\r\n\x05\x65_tag\x18\x05 \x01(\t\x12\x12\n\nsource_fid\x18\x06 \x01(\t\"\xcb\x01\n\nAttributes\x12\x11\n\tfile_size\x18\x01 \x01(\x04\x12\r\n\x05mtime\x18\x02 \x01(\x03\x12\x11\n\tfile_mode\x18\x03 \x01(\r\x12\x0b\n\x03uid\x18\x04 \x01(\r\x12\x0b\n\x03gid\x18\x05 \x01(\r\x12\x0e\n\x06\x63rtime\x18\x06 \x01(\x03\x12\x0c\n\x04mime\x18\x07 \x01(\t\x12\x13\n\x0breplication\x18\x08 \x01(\t\x12\x12\n\ncollection\x18\t \x01(\t\x12\x0f\n\x07ttl_sec\x18\n \x01(\x05\x12\x16\n\x0esymlink_target\x18\x0b \x01(\t\"\xfd\x01\n\x05\x45ntry\x12\x0c\n\x04name\x18\x01 \x01(\t\x12\x14\n\x0cis_directory\x18\x02 \x01(\x08\x12.\n\x06\x63hunks\x18\x03 \x03(\x0b\x32\x1e.seaweedfs_tpu.filer.FileChunk\x12\x33\n\nattributes\x18\x04 \x01(\x0b\x32\x1f.seaweedfs_tpu.filer.Attributes\x12:\n\x08\x65xtended\x18\x05 \x03(\x0b\x32(.seaweedfs_tpu.filer.Entry.ExtendedEntry\x1a/\n\rExtendedEntry\x12\x0b\n\x03key\x18\x01 \x01(\t\x12\r\n\x05value\x18\x02 \x01(\x0c:\x02\x38\x01\"C\n\tFullEntry\x12\x0b\n\x03\x64ir\x18\x01 \x01(\t\x12)\n\x05\x65ntry\x18\x02 \x01(\x0b\x32\x1a.seaweedfs_tpu.filer.Entry\"\xa1\x01\n\x11\x45ventNotification\x12-\n\told_entry\x18\x01 \x01(\x0b\x32\x1a.seaweedfs_tpu.filer.Entry\x12-\n\tnew_entry\x18\x02 \x01(\x0b\x32\x1a.seaweedfs_tpu.filer.Entry\x12\x15\n\rdelete_chunks\x18\x03 \x01(\x08\x12\x17\n\x0fnew_parent_path\x18\x04 \x01(\t\">\n\x1bLookupDirectoryEntryRequest\x12\x11\n\tdirectory\x18\x01 \x01(\t\x12\x0c\n\x04name\x18\x02 \x01(\t\"I\n\x1cLookupDirectoryEntryResponse\x12)\n\x05\x65ntry\x18\x01 \x01(\x0b\x32\x1a.seaweedfs_tpu.filer.Entry\"\x82\x01\n\x12ListEntriesRequest\x12\x11\n\tdirectory\x18\x01 \x01(\t\x12\x0e\n\x06prefix\x18\x02 \x01(\t\x12\x1c\n\x14start_from_file_name\x18\x03 \x01(\t\x12\x1c\n\x14inclusive_start_from\x18\x04 \x01(\x08\x12\r\n\x05limit\x18\x05 \x01(\r\"@\n\x13ListEntriesResponse\x12)\n\x05\x65ntry\x18\x01 \x01(\x0b\x32\x1a.seaweedfs_tpu.filer.Entry\"R\n\x12\x43reateEntryRequest\x12\x11\n\tdirectory\x18\x01 \x01(\t\x12)\n\x05\x65ntry\x18\x02 \x01(\x0b\x32\x1a.seaweedfs_tpu.filer.Entry\"\x15\n\x13\x43reateEntryResponse\"R\n\x12UpdateEntryRequest\x12\x11\n\tdirectory\x18\x01 \x01(\t\x12)\n\x05\x65ntry\x18\x02 \x01(\x0b\x32\x1a.seaweedfs_tpu.filer.Entry\"\x15\n\x13UpdateEntryResponse\"c\n\x12\x44\x65leteEntryRequest\x12\x11\n\tdirectory\x18\x01 \x01(\t\x12\x0c\n\x04name\x18\x02 \x01(\t\x12\x16\n\x0eis_delete_data\x18\x03 \x01(\x08\x12\x14\n\x0cis_recursive\x18\x04 \x01(\x08\"\x15\n\x13\x44\x65leteEntryResponse\"l\n\x18\x41tomicRenameEntryRequest\x12\x15\n\rold_directory\x18\x01 \x01(\t\x12\x10\n\x08old_name\x18\x02 \x01(\t\x12\x15\n\rnew_directory\x18\x03 \x01(\t\x12\x10\n\x08new_name\x18\x04 \x01(\t\"\x1b\n\x19\x41tomicRenameEntryResponse\"s\n\x13\x41ssignVolumeRequest\x12\r\n\x05\x63ount\x18\x01 \x01(\x05\x12\x12\n\ncollection\x18\x02 \x01(\t\x12\x13\n\x0breplication\x18\x03 \x01(\t\x12\x0f\n\x07ttl_sec\x18\x04 \x01(\x05\x12\x13\n\x0b\x64\x61ta_center\x18\x05 \x01(\t\"a\n\x14\x41ssignVolumeResponse\x12\x0b\n\x03\x66id\x18\x01 \x01(\t\x12\x0b\n\x03url\x18\x02 \x01(\t\x12\x12\n\npublic_url\x18\x03 \x01(\t\x12\r\n\x05\x63ount\x18\x04 \x01(\x05\x12\x0c\n\x04\x61uth\x18\x05 \x01(\t\")\n\x13LookupVolumeRequest\x12\x12\n\nvolume_ids\x18\x01 \x03(\t\"=\n\tLocations\x12\x30\n\tlocations\x18\x01 \x03(\x0b\x32\x1d.seaweedfs_tpu.filer.Location\"+\n\x08Location\x12\x0b\n\x03url\x18\x01 \x01(\t\x12\x12\n\npublic_url\x18\x02 \x01(\t\"\xbf\x01\n\x14LookupVolumeResponse\x12R\n\rlocations_map\x18\x01 \x03(\x0b\x32;.seaweedfs_tpu.filer.LookupVolumeResponse.LocationsMapEntry\x1aS\n\x11LocationsMapEntry\x12\x0b\n\x03key\x18\x01 \x01(\t\x12-\n\x05value\x18\x02 \x01(\x0b\x32\x1e.seaweedfs_tpu.filer.Locations:\x02\x38\x01\"-\n\x17\x44\x65leteCollectionRequest\x12\x12\n\ncollection\x18\x01 \x01(\t\"\x1a\n\x18\x44\x65leteCollectionResponse\"I\n\x11StatisticsRequest\x12\x13\n\x0breplication\x18\x01 \x01(\t\x12\x12\n\ncollection\x18\x02 \x01(\t\x12\x0b\n\x03ttl\x18\x03 \x01(\t\"O\n\x12StatisticsResponse\x12\x12\n\ntotal_size\x18\x01 \x01(\x04\x12\x11\n\tused_size\x18\x02 \x01(\x04\x12\x12\n\nfile_count\x18\x03 \x01(\x04\"\x1e\n\x1cGetFilerConfigurationRequest\"i\n\x1dGetFilerConfigurationResponse\x12\x0f\n\x07masters\x18\x01 \x03(\t\x12\x13\n\x0breplication\x18\x02 \x01(\t\x12\x12\n\ncollection\x18\x03 \x01(\t\x12\x0e\n\x06max_mb\x18\x04 \x01(\r2\x9c\t\n\x05\x46iler\x12{\n\x14LookupDirectoryEntry\x12\x30.seaweedfs_tpu.filer.LookupDirectoryEntryRequest\x1a\x31.seaweedfs_tpu.filer.LookupDirectoryEntryResponse\x12\x62\n\x0bListEntries\x12\'.seaweedfs_tpu.filer.ListEntriesRequest\x1a(.seaweedfs_tpu.filer.ListEntriesResponse0\x01\x12`\n\x0b\x43reateEntry\x12\'.seaweedfs_tpu.filer.CreateEntryRequest\x1a(.seaweedfs_tpu.filer.CreateEntryResponse\x12`\n\x0bUpdateEntry\x12\'.seaweedfs_tpu.filer.UpdateEntryRequest\x1a(.seaweedfs_tpu.filer.UpdateEntryResponse\x12`\n\x0b\x44\x65leteEntry\x12\'.seaweedfs_tpu.filer.DeleteEntryRequest\x1a(.seaweedfs_tpu.filer.DeleteEntryResponse\x12r\n\x11\x41tomicRenameEntry\x12-.seaweedfs_tpu.filer.AtomicRenameEntryRequest\x1a..seaweedfs_tpu.filer.AtomicRenameEntryResponse\x12\x63\n\x0c\x41ssignVolume\x12(.seaweedfs_tpu.filer.AssignVolumeRequest\x1a).seaweedfs_tpu.filer.AssignVolumeResponse\x12\x63\n\x0cLookupVolume\x12(.seaweedfs_tpu.filer.LookupVolumeRequest\x1a).seaweedfs_tpu.filer.LookupVolumeResponse\x12o\n\x10\x44\x65leteCollection\x12,.seaweedfs_tpu.filer.DeleteCollectionRequest\x1a-.seaweedfs_tpu.filer.DeleteCollectionResponse\x12]\n\nStatistics\x12&.seaweedfs_tpu.filer.StatisticsRequest\x1a\'.seaweedfs_tpu.filer.StatisticsResponse\x12~\n\x15GetFilerConfiguration\x12\x31.seaweedfs_tpu.filer.GetFilerConfigurationRequest\x1a\x32.seaweedfs_tpu.filer.GetFilerConfigurationResponseb\x06proto3')

_builder.BuildMessageAndEnumDescriptors(DESCRIPTOR, globals())
_builder.BuildTopDescriptorsAndMessages(DESCRIPTOR, 'seaweedfs_tpu.pb.filer_pb2', globals())
if _descriptor._USE_C_DESCRIPTORS == False:

  DESCRIPTOR._options = None
  _ENTRY_EXTENDEDENTRY._options = None
  _ENTRY_EXTENDEDENTRY._serialized_options = b'8\001'
  _LOOKUPVOLUMERESPONSE_LOCATIONSMAPENTRY._options = None
  _LOOKUPVOLUMERESPONSE_LOCATIONSMAPENTRY._serialized_options = b'8\001'
  _FILECHUNK._serialized_start=53
  _FILECHUNK._serialized_end=157
  _ATTRIBUTES._serialized_start=160
  _ATTRIBUTES._serialized_end=363
  _ENTRY._serialized_start=366
  _ENTRY._serialized_end=619
  _ENTRY_EXTENDEDENTRY._serialized_start=572
  _ENTRY_EXTENDEDENTRY._serialized_end=619
  _FULLENTRY._serialized_start=621
  _FULLENTRY._serialized_end=688
  _EVENTNOTIFICATION._serialized_start=691
  _EVENTNOTIFICATION._serialized_end=852
  _LOOKUPDIRECTORYENTRYREQUEST._serialized_start=854
  _LOOKUPDIRECTORYENTRYREQUEST._serialized_end=916
  _LOOKUPDIRECTORYENTRYRESPONSE._serialized_start=918
  _LOOKUPDIRECTORYENTRYRESPONSE._serialized_end=991
  _LISTENTRIESREQUEST._serialized_start=994
  _LISTENTRIESREQUEST._serialized_end=1124
  _LISTENTRIESRESPONSE._serialized_start=1126
  _LISTENTRIESRESPONSE._serialized_end=1190
  _CREATEENTRYREQUEST._serialized_start=1192
  _CREATEENTRYREQUEST._serialized_end=1274
  _CREATEENTRYRESPONSE._serialized_start=1276
  _CREATEENTRYRESPONSE._serialized_end=1297
  _UPDATEENTRYREQUEST._serialized_start=1299
  _UPDATEENTRYREQUEST._serialized_end=1381
  _UPDATEENTRYRESPONSE._serialized_start=1383
  _UPDATEENTRYRESPONSE._serialized_end=1404
  _DELETEENTRYREQUEST._serialized_start=1406
  _DELETEENTRYREQUEST._serialized_end=1505
  _DELETEENTRYRESPONSE._serialized_start=1507
  _DELETEENTRYRESPONSE._serialized_end=1528
  _ATOMICRENAMEENTRYREQUEST._serialized_start=1530
  _ATOMICRENAMEENTRYREQUEST._serialized_end=1638
  _ATOMICRENAMEENTRYRESPONSE._serialized_start=1640
  _ATOMICRENAMEENTRYRESPONSE._serialized_end=1667
  _ASSIGNVOLUMEREQUEST._serialized_start=1669
  _ASSIGNVOLUMEREQUEST._serialized_end=1784
  _ASSIGNVOLUMERESPONSE._serialized_start=1786
  _ASSIGNVOLUMERESPONSE._serialized_end=1883
  _LOOKUPVOLUMEREQUEST._serialized_start=1885
  _LOOKUPVOLUMEREQUEST._serialized_end=1926
  _LOCATIONS._serialized_start=1928
  _LOCATIONS._serialized_end=1989
  _LOCATION._serialized_start=1991
  _LOCATION._serialized_end=2034
  _LOOKUPVOLUMERESPONSE._serialized_start=2037
  _LOOKUPVOLUMERESPONSE._serialized_end=2228
  _LOOKUPVOLUMERESPONSE_LOCATIONSMAPENTRY._serialized_start=2145
  _LOOKUPVOLUMERESPONSE_LOCATIONSMAPENTRY._serialized_end=2228
  _DELETECOLLECTIONREQUEST._serialized_start=2230
  _DELETECOLLECTIONREQUEST._serialized_end=2275
  _DELETECOLLECTIONRESPONSE._serialized_start=2277
  _DELETECOLLECTIONRESPONSE._serialized_end=2303
  _STATISTICSREQUEST._serialized_start=2305
  _STATISTICSREQUEST._serialized_end=2378
  _STATISTICSRESPONSE._serialized_start=2380
  _STATISTICSRESPONSE._serialized_end=2459
  _GETFILERCONFIGURATIONREQUEST._serialized_start=2461
  _GETFILERCONFIGURATIONREQUEST._serialized_end=2491
  _GETFILERCONFIGURATIONRESPONSE._serialized_start=2493
  _GETFILERCONFIGURATIONRESPONSE._serialized_end=2598
  _FILER._serialized_start=2601
  _FILER._serialized_end=3781
# @@protoc_insertion_point(module_scope)
