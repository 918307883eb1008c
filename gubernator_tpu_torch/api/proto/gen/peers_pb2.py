# -*- coding: utf-8 -*-
# Generated by scripts/gen_peers_pb2.py (protoc stand-in;
# see that script's docstring).  DO NOT EDIT!
# source: peers.proto
"""Generated protocol buffer code."""
from google.protobuf.internal import builder as _builder
from google.protobuf import descriptor as _descriptor
from google.protobuf import descriptor_pool as _descriptor_pool
from google.protobuf import symbol_database as _symbol_database
# @@protoc_insertion_point(imports)

_sym_db = _symbol_database.Default()


from gubernator_tpu_torch.api.proto.gen import gubernator_pb2 as gubernator__pb2


DESCRIPTOR = _descriptor_pool.Default().AddSerializedFile(b'\n\x0bpeers.proto\x12\rpb.gubernator\x1a\x10gubernator.proto"E\n\x14GetPeerRateLimitsReq\x12-\n\x08requests\x18\x01 \x03(\x0b2\x1b.pb.gubernator.RateLimitReq"J\n\x15GetPeerRateLimitsResp\x121\n\x0brate_limits\x18\x01 \x03(\x0b2\x1c.pb.gubernator.RateLimitResp"H\n\x14UpdatePeerGlobalsReq\x120\n\x07globals\x18\x01 \x03(\x0b2\x1f.pb.gubernator.UpdatePeerGlobal"M\n\x10UpdatePeerGlobal\x12\x0b\n\x03key\x18\x01 \x01(\t\x12,\n\x06status\x18\x02 \x01(\x0b2\x1c.pb.gubernator.RateLimitResp"\x17\n\x15UpdatePeerGlobalsResp"\x9d\x01\n\x0eBucketSnapshot\x12\x0b\n\x03key\x18\x01 \x01(\t\x12\x11\n\talgorithm\x18\x02 \x01(\x05\x12\r\n\x05limit\x18\x03 \x01(\x03\x12\x10\n\x08duration\x18\x04 \x01(\x03\x12\x11\n\tremaining\x18\x05 \x01(\x03\x12\x12\n\nreset_time\x18\x06 \x01(\x03\x12\x0e\n\x06status\x18\x07 \x01(\x05\x12\x13\n\x0bsnapshot_ms\x18\x08 \x01(\x03"T\n\x13ReplicateBucketsReq\x12\r\n\x05owner\x18\x01 \x01(\t\x12.\n\x07buckets\x18\x02 \x03(\x0b2\x1d.pb.gubernator.BucketSnapshot"\x16\n\x14ReplicateBucketsResp2\xa6\x02\n\x07PeersV1\x12^\n\x11GetPeerRateLimits\x12#.pb.gubernator.GetPeerRateLimitsReq\x1a$.pb.gubernator.GetPeerRateLimitsResp\x12^\n\x11UpdatePeerGlobals\x12#.pb.gubernator.UpdatePeerGlobalsReq\x1a$.pb.gubernator.UpdatePeerGlobalsResp\x12[\n\x10ReplicateBuckets\x12".pb.gubernator.ReplicateBucketsReq\x1a#.pb.gubernator.ReplicateBucketsRespB\x03\x80\x01\x01b\x06proto3')

_builder.BuildMessageAndEnumDescriptors(DESCRIPTOR, globals())
_builder.BuildTopDescriptorsAndMessages(DESCRIPTOR, 'gubernator_tpu_torch.api.proto.gen.peers_pb2', globals())
if _descriptor._USE_C_DESCRIPTORS == False:

  DESCRIPTOR._options = None
  DESCRIPTOR._serialized_options = b'\200\001\001'
  _GETPEERRATELIMITSREQ._serialized_start=48
  _GETPEERRATELIMITSREQ._serialized_end=117
  _GETPEERRATELIMITSRESP._serialized_start=119
  _GETPEERRATELIMITSRESP._serialized_end=193
  _UPDATEPEERGLOBALSREQ._serialized_start=195
  _UPDATEPEERGLOBALSREQ._serialized_end=267
  _UPDATEPEERGLOBAL._serialized_start=269
  _UPDATEPEERGLOBAL._serialized_end=346
  _UPDATEPEERGLOBALSRESP._serialized_start=348
  _UPDATEPEERGLOBALSRESP._serialized_end=371
  _BUCKETSNAPSHOT._serialized_start=374
  _BUCKETSNAPSHOT._serialized_end=531
  _REPLICATEBUCKETSREQ._serialized_start=533
  _REPLICATEBUCKETSREQ._serialized_end=617
  _REPLICATEBUCKETSRESP._serialized_start=619
  _REPLICATEBUCKETSRESP._serialized_end=641
  _PEERSV1._serialized_start=644
  _PEERSV1._serialized_end=938
# @@protoc_insertion_point(module_scope)
