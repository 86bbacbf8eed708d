# -*- coding: utf-8 -*-
# Generated by the protocol buffer compiler.  DO NOT EDIT!
# source: seaweedfs_tpu/pb/volume.proto
"""Generated protocol buffer code."""
from google.protobuf.internal import builder as _builder
from google.protobuf import descriptor as _descriptor
from google.protobuf import descriptor_pool as _descriptor_pool
from google.protobuf import symbol_database as _symbol_database
# @@protoc_insertion_point(imports)

_sym_db = _symbol_database.Default()




DESCRIPTOR = _descriptor_pool.Default().AddSerializedFile(b'\n\x1dseaweedfs_tpu/pb/volume.proto\x12\x14seaweedfs_tpu.volume\"&\n\x12\x42\x61tchDeleteRequest\x12\x10\n\x08\x66ile_ids\x18\x01 \x03(\t\"L\n\x0c\x44\x65leteResult\x12\x0f\n\x07\x66ile_id\x18\x01 \x01(\t\x12\x0e\n\x06status\x18\x02 \x01(\x05\x12\r\n\x05\x65rror\x18\x03 \x01(\t\x12\x0c\n\x04size\x18\x04 \x01(\r\"J\n\x13\x42\x61tchDeleteResponse\x12\x33\n\x07results\x18\x01 \x03(\x0b\x32\".seaweedfs_tpu.volume.DeleteResult\"-\n\x18VacuumVolumeCheckRequest\x12\x11\n\tvolume_id\x18\x01 \x01(\r\"2\n\x19VacuumVolumeCheckResponse\x12\x15\n\rgarbage_ratio\x18\x01 \x01(\x01\"D\n\x1aVacuumVolumeCompactRequest\x12\x11\n\tvolume_id\x18\x01 \x01(\r\x12\x13\n\x0bpreallocate\x18\x02 \x01(\x03\"\x1d\n\x1bVacuumVolumeCompactResponse\".\n\x19VacuumVolumeCommitRequest\x12\x11\n\tvolume_id\x18\x01 \x01(\r\"\x1c\n\x1aVacuumVolumeCommitResponse\"/\n\x1aVacuumVolumeCleanupRequest\x12\x11\n\tvolume_id\x18\x01 \x01(\r\"\x1d\n\x1bVacuumVolumeCleanupResponse\"u\n\x15\x41llocateVolumeRequest\x12\x11\n\tvolume_id\x18\x01 \x01(\r\x12\x12\n\ncollection\x18\x02 \x01(\t\x12\x13\n\x0breplication\x18\x03 \x01(\t\x12\x0b\n\x03ttl\x18\x04 \x01(\t\x12\x13\n\x0bpreallocate\x18\x05 \x01(\x03\"\x18\n\x16\x41llocateVolumeResponse\"-\n\x17\x44\x65leteCollectionRequest\x12\x12\n\ncollection\x18\x01 \x01(\t\"\x1a\n\x18\x44\x65leteCollectionResponse\"(\n\x13VolumeDeleteRequest\x12\x11\n\tvolume_id\x18\x01 \x01(\r\"\x16\n\x14VolumeDeleteResponse\"\'\n\x12VolumeMountRequest\x12\x11\n\tvolume_id\x18\x01 \x01(\r\"\x15\n\x13VolumeMountResponse\")\n\x14VolumeUnmountRequest\x12\x11\n\tvolume_id\x18\x01 \x01(\r\"\x17\n\x15VolumeUnmountResponse\".\n\x19VolumeMarkReadonlyRequest\x12\x11\n\tvolume_id\x18\x01 \x01(\r\"\x1c\n\x1aVolumeMarkReadonlyResponse\".\n\x19VolumeMarkWritableRequest\x12\x11\n\tvolume_id\x18\x01 \x01(\r\"\x1c\n\x1aVolumeMarkWritableResponse\",\n\x17VolumeSyncStatusRequest\x12\x11\n\tvolume_id\x18\x01 \x01(\r\"\xa9\x01\n\x18VolumeSyncStatusResponse\x12\x11\n\tvolume_id\x18\x01 \x01(\r\x12\x12\n\ncollection\x18\x02 \x01(\t\x12\x13\n\x0breplication\x18\x03 \x01(\t\x12\x0b\n\x03ttl\x18\x04 \x01(\t\x12\x13\n\x0btail_offset\x18\x05 \x01(\x04\x12\x18\n\x10\x63ompact_revision\x18\x06 \x01(\r\x12\x15\n\ridx_file_size\x18\x07 \x01(\x04\"\\\n\x17VolumeTailSenderRequest\x12\x11\n\tvolume_id\x18\x01 \x01(\r\x12\x10\n\x08since_ns\x18\x02 \x01(\x04\x12\x1c\n\x14idle_timeout_seconds\x18\x03 \x01(\r\"]\n\x18VolumeTailSenderResponse\x12\x15\n\rneedle_header\x18\x01 \x01(\x0c\x12\x13\n\x0bneedle_body\x18\x02 \x01(\x0c\x12\x15\n\ris_last_chunk\x18\x03 \x01(\x08\"|\n\x19VolumeTailReceiverRequest\x12\x11\n\tvolume_id\x18\x01 \x01(\r\x12\x10\n\x08since_ns\x18\x02 \x01(\x04\x12\x1c\n\x14idle_timeout_seconds\x18\x03 \x01(\r\x12\x1c\n\x14source_volume_server\x18\x04 \x01(\t\"\x1c\n\x1aVolumeTailReceiverResponse\"\xad\x01\n\x0cQueryRequest\x12\x12\n\nselections\x18\x01 \x03(\t\x12\x15\n\rfrom_file_ids\x18\x02 \x03(\t\x12\x39\n\x06\x66ilter\x18\x03 \x01(\x0b\x32).seaweedfs_tpu.volume.QueryRequest.Filter\x1a\x37\n\x06\x46ilter\x12\r\n\x05\x66ield\x18\x01 \x01(\t\x12\x0f\n\x07operand\x18\x02 \x01(\t\x12\r\n\x05value\x18\x03 \x01(\t\" \n\rQueriedStripe\x12\x0f\n\x07records\x18\x01 \x01(\x0c\"\x88\x01\n VolumeTierMoveDatToRemoteRequest\x12\x11\n\tvolume_id\x18\x01 \x01(\r\x12\x12\n\ncollection\x18\x02 \x01(\t\x12 \n\x18\x64\x65stination_backend_name\x18\x03 \x01(\t\x12\x1b\n\x13keep_local_dat_file\x18\x04 \x01(\x08\"T\n!VolumeTierMoveDatToRemoteResponse\x12\x11\n\tprocessed\x18\x01 \x01(\x03\x12\x1c\n\x14processed_percentage\x18\x02 \x01(\x02\"i\n\"VolumeTierMoveDatFromRemoteRequest\x12\x11\n\tvolume_id\x18\x01 \x01(\r\x12\x12\n\ncollection\x18\x02 \x01(\t\x12\x1c\n\x14keep_remote_dat_file\x18\x03 \x01(\x08\"V\n#VolumeTierMoveDatFromRemoteResponse\x12\x11\n\tprocessed\x18\x01 \x01(\x03\x12\x1c\n\x14processed_percentage\x18\x02 \x01(\x02\"v\n\x11VolumeCopyRequest\x12\x11\n\tvolume_id\x18\x01 \x01(\r\x12\x12\n\ncollection\x18\x02 \x01(\t\x12\x13\n\x0breplication\x18\x03 \x01(\t\x12\x0b\n\x03ttl\x18\x04 \x01(\t\x12\x18\n\x10source_data_node\x18\x05 \x01(\t\"/\n\x12VolumeCopyResponse\x12\x19\n\x11last_append_at_ns\x18\x01 \x01(\x04\"\x8d\x01\n\x0f\x43opyFileRequest\x12\x11\n\tvolume_id\x18\x01 \x01(\r\x12\x0b\n\x03\x65xt\x18\x02 \x01(\t\x12\x1b\n\x13\x63ompaction_revision\x18\x03 \x01(\r\x12\x13\n\x0bstop_offset\x18\x04 \x01(\x04\x12\x12\n\ncollection\x18\x05 \x01(\t\x12\x14\n\x0cis_ec_volume\x18\x06 \x01(\x08\"(\n\x10\x43opyFileResponse\x12\x14\n\x0c\x66ile_content\x18\x01 \x01(\x0c\"C\n\x1cVolumeIncrementalCopyRequest\x12\x11\n\tvolume_id\x18\x01 \x01(\r\x12\x10\n\x08since_ns\x18\x02 \x01(\x04\"5\n\x1dVolumeIncrementalCopyResponse\x12\x14\n\x0c\x66ile_content\x18\x01 \x01(\x0c\"F\n\x1dVolumeEcShardsGenerateRequest\x12\x11\n\tvolume_id\x18\x01 \x01(\r\x12\x12\n\ncollection\x18\x02 \x01(\t\" \n\x1eVolumeEcShardsGenerateResponse\"8\n\"VolumeEcShardsBatchGenerateRequest\x12\x12\n\nvolume_ids\x18\x01 \x03(\r\"%\n#VolumeEcShardsBatchGenerateResponse\"E\n\x1cVolumeEcShardsRebuildRequest\x12\x11\n\tvolume_id\x18\x01 \x01(\r\x12\x12\n\ncollection\x18\x02 \x01(\t\":\n\x1dVolumeEcShardsRebuildResponse\x12\x19\n\x11rebuilt_shard_ids\x18\x01 \x03(\r\"\x86\x01\n\x19VolumeEcShardsCopyRequest\x12\x11\n\tvolume_id\x18\x01 \x01(\r\x12\x12\n\ncollection\x18\x02 \x01(\t\x12\x11\n\tshard_ids\x18\x03 \x03(\r\x12\x15\n\rcopy_ecx_file\x18\x04 \x01(\x08\x12\x18\n\x10source_data_node\x18\x05 \x01(\t\"\x1c\n\x1aVolumeEcShardsCopyResponse\"W\n\x1bVolumeEcShardsDeleteRequest\x12\x11\n\tvolume_id\x18\x01 \x01(\r\x12\x12\n\ncollection\x18\x02 \x01(\t\x12\x11\n\tshard_ids\x18\x03 \x03(\r\"\x1e\n\x1cVolumeEcShardsDeleteResponse\"V\n\x1aVolumeEcShardsMountRequest\x12\x11\n\tvolume_id\x18\x01 \x01(\r\x12\x12\n\ncollection\x18\x02 \x01(\t\x12\x11\n\tshard_ids\x18\x03 \x03(\r\"\x1d\n\x1bVolumeEcShardsMountResponse\"D\n\x1cVolumeEcShardsUnmountRequest\x12\x11\n\tvolume_id\x18\x01 \x01(\r\x12\x11\n\tshard_ids\x18\x02 \x03(\r\"\x1f\n\x1dVolumeEcShardsUnmountResponse\"o\n\x18VolumeEcShardReadRequest\x12\x11\n\tvolume_id\x18\x01 \x01(\r\x12\x10\n\x08shard_id\x18\x02 \x01(\r\x12\x0e\n\x06offset\x18\x03 \x01(\x03\x12\x0c\n\x04size\x18\x04 \x01(\x03\x12\x10\n\x08\x66ile_key\x18\x05 \x01(\x04\"=\n\x19VolumeEcShardReadResponse\x12\x0c\n\x04\x64\x61ta\x18\x01 \x01(\x0c\x12\x12\n\nis_deleted\x18\x02 \x01(\x08\"e\n\x19VolumeEcBlobDeleteRequest\x12\x11\n\tvolume_id\x18\x01 \x01(\r\x12\x12\n\ncollection\x18\x02 \x01(\t\x12\x10\n\x08\x66ile_key\x18\x03 \x01(\x04\x12\x0f\n\x07version\x18\x04 \x01(\r\"\x1c\n\x1aVolumeEcBlobDeleteResponse\"F\n\x1dVolumeEcShardsToVolumeRequest\x12\x11\n\tvolume_id\x18\x01 \x01(\r\x12\x12\n\ncollection\x18\x02 \x01(\t\" \n\x1eVolumeEcShardsToVolumeResponse2\xa2\x18\n\x0cVolumeServer\x12\x62\n\x0b\x42\x61tchDelete\x12(.seaweedfs_tpu.volume.BatchDeleteRequest\x1a).seaweedfs_tpu.volume.BatchDeleteResponse\x12t\n\x11VacuumVolumeCheck\x12..seaweedfs_tpu.volume.VacuumVolumeCheckRequest\x1a/.seaweedfs_tpu.volume.VacuumVolumeCheckResponse\x12z\n\x13VacuumVolumeCompact\x12\x30.seaweedfs_tpu.volume.VacuumVolumeCompactRequest\x1a\x31.seaweedfs_tpu.volume.VacuumVolumeCompactResponse\x12w\n\x12VacuumVolumeCommit\x12/.seaweedfs_tpu.volume.VacuumVolumeCommitRequest\x1a\x30.seaweedfs_tpu.volume.VacuumVolumeCommitResponse\x12z\n\x13VacuumVolumeCleanup\x12\x30.seaweedfs_tpu.volume.VacuumVolumeCleanupRequest\x1a\x31.seaweedfs_tpu.volume.VacuumVolumeCleanupResponse\x12k\n\x0e\x41llocateVolume\x12+.seaweedfs_tpu.volume.AllocateVolumeRequest\x1a,.seaweedfs_tpu.volume.AllocateVolumeResponse\x12q\n\x10\x44\x65leteCollection\x12-.seaweedfs_tpu.volume.DeleteCollectionRequest\x1a..seaweedfs_tpu.volume.DeleteCollectionResponse\x12\x65\n\x0cVolumeDelete\x12).seaweedfs_tpu.volume.VolumeDeleteRequest\x1a*.seaweedfs_tpu.volume.VolumeDeleteResponse\x12w\n\x12VolumeMarkReadonly\x12/.seaweedfs_tpu.volume.VolumeMarkReadonlyRequest\x1a\x30.seaweedfs_tpu.volume.VolumeMarkReadonlyResponse\x12w\n\x12VolumeMarkWritable\x12/.seaweedfs_tpu.volume.VolumeMarkWritableRequest\x1a\x30.seaweedfs_tpu.volume.VolumeMarkWritableResponse\x12q\n\x10VolumeSyncStatus\x12-.seaweedfs_tpu.volume.VolumeSyncStatusRequest\x1a..seaweedfs_tpu.volume.VolumeSyncStatusResponse\x12\x62\n\x0bVolumeMount\x12(.seaweedfs_tpu.volume.VolumeMountRequest\x1a).seaweedfs_tpu.volume.VolumeMountResponse\x12h\n\rVolumeUnmount\x12*.seaweedfs_tpu.volume.VolumeUnmountRequest\x1a+.seaweedfs_tpu.volume.VolumeUnmountResponse\x12_\n\nVolumeCopy\x12\'.seaweedfs_tpu.volume.VolumeCopyRequest\x1a(.seaweedfs_tpu.volume.VolumeCopyResponse\x12[\n\x08\x43opyFile\x12%.seaweedfs_tpu.volume.CopyFileRequest\x1a&.seaweedfs_tpu.volume.CopyFileResponse0\x01\x12\x82\x01\n\x15VolumeIncrementalCopy\x12\x32.seaweedfs_tpu.volume.VolumeIncrementalCopyRequest\x1a\x33.seaweedfs_tpu.volume.VolumeIncrementalCopyResponse0\x01\x12\x83\x01\n\x16VolumeEcShardsGenerate\x12\x33.seaweedfs_tpu.volume.VolumeEcShardsGenerateRequest\x1a\x34.seaweedfs_tpu.volume.VolumeEcShardsGenerateResponse\x12\x92\x01\n\x1bVolumeEcShardsBatchGenerate\x12\x38.seaweedfs_tpu.volume.VolumeEcShardsBatchGenerateRequest\x1a\x39.seaweedfs_tpu.volume.VolumeEcShardsBatchGenerateResponse\x12\x80\x01\n\x15VolumeEcShardsRebuild\x12\x32.seaweedfs_tpu.volume.VolumeEcShardsRebuildRequest\x1a\x33.seaweedfs_tpu.volume.VolumeEcShardsRebuildResponse\x12w\n\x12VolumeEcShardsCopy\x12/.seaweedfs_tpu.volume.VolumeEcShardsCopyRequest\x1a\x30.seaweedfs_tpu.volume.VolumeEcShardsCopyResponse\x12}\n\x14VolumeEcShardsDelete\x12\x31.seaweedfs_tpu.volume.VolumeEcShardsDeleteRequest\x1a\x32.seaweedfs_tpu.volume.VolumeEcShardsDeleteResponse\x12z\n\x13VolumeEcShardsMount\x12\x30.seaweedfs_tpu.volume.VolumeEcShardsMountRequest\x1a\x31.seaweedfs_tpu.volume.VolumeEcShardsMountResponse\x12\x80\x01\n\x15VolumeEcShardsUnmount\x12\x32.seaweedfs_tpu.volume.VolumeEcShardsUnmountRequest\x1a\x33.seaweedfs_tpu.volume.VolumeEcShardsUnmountResponse\x12v\n\x11VolumeEcShardRead\x12..seaweedfs_tpu.volume.VolumeEcShardReadRequest\x1a/.seaweedfs_tpu.volume.VolumeEcShardReadResponse0\x01\x12w\n\x12VolumeEcBlobDelete\x12/.seaweedfs_tpu.volume.VolumeEcBlobDeleteRequest\x1a\x30.seaweedfs_tpu.volume.VolumeEcBlobDeleteResponse\x12\x83\x01\n\x16VolumeEcShardsToVolume\x12\x33.seaweedfs_tpu.volume.VolumeEcShardsToVolumeRequest\x1a\x34.seaweedfs_tpu.volume.VolumeEcShardsToVolumeResponseb\x06proto3')

_builder.BuildMessageAndEnumDescriptors(DESCRIPTOR, globals())
_builder.BuildTopDescriptorsAndMessages(DESCRIPTOR, 'seaweedfs_tpu.pb.volume_pb2', globals())
if _descriptor._USE_C_DESCRIPTORS == False:

  DESCRIPTOR._options = None
  _BATCHDELETEREQUEST._serialized_start=55
  _BATCHDELETEREQUEST._serialized_end=93
  _DELETERESULT._serialized_start=95
  _DELETERESULT._serialized_end=171
  _BATCHDELETERESPONSE._serialized_start=173
  _BATCHDELETERESPONSE._serialized_end=247
  _VACUUMVOLUMECHECKREQUEST._serialized_start=249
  _VACUUMVOLUMECHECKREQUEST._serialized_end=294
  _VACUUMVOLUMECHECKRESPONSE._serialized_start=296
  _VACUUMVOLUMECHECKRESPONSE._serialized_end=346
  _VACUUMVOLUMECOMPACTREQUEST._serialized_start=348
  _VACUUMVOLUMECOMPACTREQUEST._serialized_end=416
  _VACUUMVOLUMECOMPACTRESPONSE._serialized_start=418
  _VACUUMVOLUMECOMPACTRESPONSE._serialized_end=447
  _VACUUMVOLUMECOMMITREQUEST._serialized_start=449
  _VACUUMVOLUMECOMMITREQUEST._serialized_end=495
  _VACUUMVOLUMECOMMITRESPONSE._serialized_start=497
  _VACUUMVOLUMECOMMITRESPONSE._serialized_end=525
  _VACUUMVOLUMECLEANUPREQUEST._serialized_start=527
  _VACUUMVOLUMECLEANUPREQUEST._serialized_end=574
  _VACUUMVOLUMECLEANUPRESPONSE._serialized_start=576
  _VACUUMVOLUMECLEANUPRESPONSE._serialized_end=605
  _ALLOCATEVOLUMEREQUEST._serialized_start=607
  _ALLOCATEVOLUMEREQUEST._serialized_end=724
  _ALLOCATEVOLUMERESPONSE._serialized_start=726
  _ALLOCATEVOLUMERESPONSE._serialized_end=750
  _DELETECOLLECTIONREQUEST._serialized_start=752
  _DELETECOLLECTIONREQUEST._serialized_end=797
  _DELETECOLLECTIONRESPONSE._serialized_start=799
  _DELETECOLLECTIONRESPONSE._serialized_end=825
  _VOLUMEDELETEREQUEST._serialized_start=827
  _VOLUMEDELETEREQUEST._serialized_end=867
  _VOLUMEDELETERESPONSE._serialized_start=869
  _VOLUMEDELETERESPONSE._serialized_end=891
  _VOLUMEMOUNTREQUEST._serialized_start=893
  _VOLUMEMOUNTREQUEST._serialized_end=932
  _VOLUMEMOUNTRESPONSE._serialized_start=934
  _VOLUMEMOUNTRESPONSE._serialized_end=955
  _VOLUMEUNMOUNTREQUEST._serialized_start=957
  _VOLUMEUNMOUNTREQUEST._serialized_end=998
  _VOLUMEUNMOUNTRESPONSE._serialized_start=1000
  _VOLUMEUNMOUNTRESPONSE._serialized_end=1023
  _VOLUMEMARKREADONLYREQUEST._serialized_start=1025
  _VOLUMEMARKREADONLYREQUEST._serialized_end=1071
  _VOLUMEMARKREADONLYRESPONSE._serialized_start=1073
  _VOLUMEMARKREADONLYRESPONSE._serialized_end=1101
  _VOLUMEMARKWRITABLEREQUEST._serialized_start=1103
  _VOLUMEMARKWRITABLEREQUEST._serialized_end=1149
  _VOLUMEMARKWRITABLERESPONSE._serialized_start=1151
  _VOLUMEMARKWRITABLERESPONSE._serialized_end=1179
  _VOLUMESYNCSTATUSREQUEST._serialized_start=1181
  _VOLUMESYNCSTATUSREQUEST._serialized_end=1225
  _VOLUMESYNCSTATUSRESPONSE._serialized_start=1228
  _VOLUMESYNCSTATUSRESPONSE._serialized_end=1397
  _VOLUMETAILSENDERREQUEST._serialized_start=1399
  _VOLUMETAILSENDERREQUEST._serialized_end=1491
  _VOLUMETAILSENDERRESPONSE._serialized_start=1493
  _VOLUMETAILSENDERRESPONSE._serialized_end=1586
  _VOLUMETAILRECEIVERREQUEST._serialized_start=1588
  _VOLUMETAILRECEIVERREQUEST._serialized_end=1712
  _VOLUMETAILRECEIVERRESPONSE._serialized_start=1714
  _VOLUMETAILRECEIVERRESPONSE._serialized_end=1742
  _QUERYREQUEST._serialized_start=1745
  _QUERYREQUEST._serialized_end=1918
  _QUERYREQUEST_FILTER._serialized_start=1863
  _QUERYREQUEST_FILTER._serialized_end=1918
  _QUERIEDSTRIPE._serialized_start=1920
  _QUERIEDSTRIPE._serialized_end=1952
  _VOLUMETIERMOVEDATTOREMOTEREQUEST._serialized_start=1955
  _VOLUMETIERMOVEDATTOREMOTEREQUEST._serialized_end=2091
  _VOLUMETIERMOVEDATTOREMOTERESPONSE._serialized_start=2093
  _VOLUMETIERMOVEDATTOREMOTERESPONSE._serialized_end=2177
  _VOLUMETIERMOVEDATFROMREMOTEREQUEST._serialized_start=2179
  _VOLUMETIERMOVEDATFROMREMOTEREQUEST._serialized_end=2284
  _VOLUMETIERMOVEDATFROMREMOTERESPONSE._serialized_start=2286
  _VOLUMETIERMOVEDATFROMREMOTERESPONSE._serialized_end=2372
  _VOLUMECOPYREQUEST._serialized_start=2374
  _VOLUMECOPYREQUEST._serialized_end=2492
  _VOLUMECOPYRESPONSE._serialized_start=2494
  _VOLUMECOPYRESPONSE._serialized_end=2541
  _COPYFILEREQUEST._serialized_start=2544
  _COPYFILEREQUEST._serialized_end=2685
  _COPYFILERESPONSE._serialized_start=2687
  _COPYFILERESPONSE._serialized_end=2727
  _VOLUMEINCREMENTALCOPYREQUEST._serialized_start=2729
  _VOLUMEINCREMENTALCOPYREQUEST._serialized_end=2796
  _VOLUMEINCREMENTALCOPYRESPONSE._serialized_start=2798
  _VOLUMEINCREMENTALCOPYRESPONSE._serialized_end=2851
  _VOLUMEECSHARDSGENERATEREQUEST._serialized_start=2853
  _VOLUMEECSHARDSGENERATEREQUEST._serialized_end=2923
  _VOLUMEECSHARDSGENERATERESPONSE._serialized_start=2925
  _VOLUMEECSHARDSGENERATERESPONSE._serialized_end=2957
  _VOLUMEECSHARDSBATCHGENERATEREQUEST._serialized_start=2959
  _VOLUMEECSHARDSBATCHGENERATEREQUEST._serialized_end=3015
  _VOLUMEECSHARDSBATCHGENERATERESPONSE._serialized_start=3017
  _VOLUMEECSHARDSBATCHGENERATERESPONSE._serialized_end=3054
  _VOLUMEECSHARDSREBUILDREQUEST._serialized_start=3056
  _VOLUMEECSHARDSREBUILDREQUEST._serialized_end=3125
  _VOLUMEECSHARDSREBUILDRESPONSE._serialized_start=3127
  _VOLUMEECSHARDSREBUILDRESPONSE._serialized_end=3185
  _VOLUMEECSHARDSCOPYREQUEST._serialized_start=3188
  _VOLUMEECSHARDSCOPYREQUEST._serialized_end=3322
  _VOLUMEECSHARDSCOPYRESPONSE._serialized_start=3324
  _VOLUMEECSHARDSCOPYRESPONSE._serialized_end=3352
  _VOLUMEECSHARDSDELETEREQUEST._serialized_start=3354
  _VOLUMEECSHARDSDELETEREQUEST._serialized_end=3441
  _VOLUMEECSHARDSDELETERESPONSE._serialized_start=3443
  _VOLUMEECSHARDSDELETERESPONSE._serialized_end=3473
  _VOLUMEECSHARDSMOUNTREQUEST._serialized_start=3475
  _VOLUMEECSHARDSMOUNTREQUEST._serialized_end=3561
  _VOLUMEECSHARDSMOUNTRESPONSE._serialized_start=3563
  _VOLUMEECSHARDSMOUNTRESPONSE._serialized_end=3592
  _VOLUMEECSHARDSUNMOUNTREQUEST._serialized_start=3594
  _VOLUMEECSHARDSUNMOUNTREQUEST._serialized_end=3662
  _VOLUMEECSHARDSUNMOUNTRESPONSE._serialized_start=3664
  _VOLUMEECSHARDSUNMOUNTRESPONSE._serialized_end=3695
  _VOLUMEECSHARDREADREQUEST._serialized_start=3697
  _VOLUMEECSHARDREADREQUEST._serialized_end=3808
  _VOLUMEECSHARDREADRESPONSE._serialized_start=3810
  _VOLUMEECSHARDREADRESPONSE._serialized_end=3871
  _VOLUMEECBLOBDELETEREQUEST._serialized_start=3873
  _VOLUMEECBLOBDELETEREQUEST._serialized_end=3974
  _VOLUMEECBLOBDELETERESPONSE._serialized_start=3976
  _VOLUMEECBLOBDELETERESPONSE._serialized_end=4004
  _VOLUMEECSHARDSTOVOLUMEREQUEST._serialized_start=4006
  _VOLUMEECSHARDSTOVOLUMEREQUEST._serialized_end=4076
  _VOLUMEECSHARDSTOVOLUMERESPONSE._serialized_start=4078
  _VOLUMEECSHARDSTOVOLUMERESPONSE._serialized_end=4110
  _VOLUMESERVER._serialized_start=4113
  _VOLUMESERVER._serialized_end=7219
# @@protoc_insertion_point(module_scope)
