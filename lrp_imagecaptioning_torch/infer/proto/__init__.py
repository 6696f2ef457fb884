"""The serving surface's wire contract: caption_service.proto and its
pre-generated Python stubs (see the .proto header for regeneration), the
port's own copy of the JAX package's, byte for byte the same contract."""

from . import caption_service_pb2, caption_service_pb2_grpc  # noqa: F401
