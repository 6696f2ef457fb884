# -*- coding: utf-8 -*-
# Generated by the protocol buffer compiler.  DO NOT EDIT!
# source: caption_service.proto
"""Generated protocol buffer code."""
from google.protobuf.internal import builder as _builder
from google.protobuf import descriptor as _descriptor
from google.protobuf import descriptor_pool as _descriptor_pool
from google.protobuf import symbol_database as _symbol_database
# @@protoc_insertion_point(imports)

_sym_db = _symbol_database.Default()




DESCRIPTOR = _descriptor_pool.Default().AddSerializedFile(b'\n\x15\x63\x61ption_service.proto\x12\x08lrpic.v1\"\x0f\n\rHealthRequest\"\x19\n\x0bHealthReply\x12\n\n\x02ok\x18\x01 \x01(\x08\"\x0e\n\x0cStatsRequest\" \n\nStatsReply\x12\x12\n\nstats_json\x18\x01 \x01(\t\"D\n\nImageBatch\x12\t\n\x01n\x18\x01 \x01(\r\x12\x0e\n\x06height\x18\x02 \x01(\r\x12\r\n\x05width\x18\x03 \x01(\r\x12\x0c\n\x04\x64\x61ta\x18\x04 \x01(\x0c\"6\n\x0e\x43\x61ptionRequest\x12$\n\x06images\x18\x01 \x01(\x0b\x32\x14.lrpic.v1.ImageBatch\" \n\x0c\x43\x61ptionReply\x12\x10\n\x08\x63\x61ptions\x18\x01 \x03(\t\"F\n\x0e\x45xplainRequest\x12$\n\x06images\x18\x01 \x01(\x0b\x32\x14.lrpic.v1.ImageBatch\x12\x0e\n\x06method\x18\x02 \x01(\t\"\x9b\x01\n\x0b\x45xplanation\x12\x0f\n\x07\x63\x61ption\x18\x01 \x01(\t\x12\r\n\x05words\x18\x02 \x03(\t\x12\x16\n\x0erelevance_maps\x18\x03 \x01(\x0c\x12\x1c\n\x14relevance_maps_shape\x18\x04 \x03(\r\x12\x17\n\x0fword_relevances\x18\x05 \x01(\x0c\x12\x1d\n\x15word_relevances_shape\x18\x06 \x03(\r\";\n\x0c\x45xplainReply\x12+\n\x0c\x65xplanations\x18\x01 \x03(\x0b\x32\x15.lrpic.v1.Explanation2\xfb\x01\n\x0e\x43\x61ptionService\x12\x38\n\x06Health\x12\x17.lrpic.v1.HealthRequest\x1a\x15.lrpic.v1.HealthReply\x12\x35\n\x05Stats\x12\x16.lrpic.v1.StatsRequest\x1a\x14.lrpic.v1.StatsReply\x12;\n\x07\x43\x61ption\x12\x18.lrpic.v1.CaptionRequest\x1a\x16.lrpic.v1.CaptionReply\x12;\n\x07\x45xplain\x12\x18.lrpic.v1.ExplainRequest\x1a\x16.lrpic.v1.ExplainReplyb\x06proto3')

_builder.BuildMessageAndEnumDescriptors(DESCRIPTOR, globals())
_builder.BuildTopDescriptorsAndMessages(DESCRIPTOR, 'caption_service_pb2', globals())
if _descriptor._USE_C_DESCRIPTORS == False:

  DESCRIPTOR._options = None
  _HEALTHREQUEST._serialized_start=35
  _HEALTHREQUEST._serialized_end=50
  _HEALTHREPLY._serialized_start=52
  _HEALTHREPLY._serialized_end=77
  _STATSREQUEST._serialized_start=79
  _STATSREQUEST._serialized_end=93
  _STATSREPLY._serialized_start=95
  _STATSREPLY._serialized_end=127
  _IMAGEBATCH._serialized_start=129
  _IMAGEBATCH._serialized_end=197
  _CAPTIONREQUEST._serialized_start=199
  _CAPTIONREQUEST._serialized_end=253
  _CAPTIONREPLY._serialized_start=255
  _CAPTIONREPLY._serialized_end=287
  _EXPLAINREQUEST._serialized_start=289
  _EXPLAINREQUEST._serialized_end=359
  _EXPLANATION._serialized_start=362
  _EXPLANATION._serialized_end=517
  _EXPLAINREPLY._serialized_start=519
  _EXPLAINREPLY._serialized_end=578
  _CAPTIONSERVICE._serialized_start=581
  _CAPTIONSERVICE._serialized_end=832
# @@protoc_insertion_point(module_scope)
