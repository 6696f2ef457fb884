# gRPC binding for caption_service.proto in the layout the grpc Python
# plugin emits (Stub / Servicer / add_..._to_server), written by hand: it
# holds exactly what the plugin would emit for the four unary-unary methods,
# minus the experimental one-shot API.
"""Client and server classes corresponding to protobuf-defined services."""
import grpc

from . import caption_service_pb2 as caption__service__pb2

_SERVICE = "lrpic.v1.CaptionService"


class CaptionServiceStub:
    """Typed client stub for the lrpic.v1.CaptionService wire contract."""

    def __init__(self, channel):
        """Constructor.

        Args:
            channel: A grpc.Channel.
        """
        self.Health = channel.unary_unary(
            f"/{_SERVICE}/Health",
            request_serializer=caption__service__pb2.HealthRequest.SerializeToString,
            response_deserializer=caption__service__pb2.HealthReply.FromString,
        )
        self.Stats = channel.unary_unary(
            f"/{_SERVICE}/Stats",
            request_serializer=caption__service__pb2.StatsRequest.SerializeToString,
            response_deserializer=caption__service__pb2.StatsReply.FromString,
        )
        self.Caption = channel.unary_unary(
            f"/{_SERVICE}/Caption",
            request_serializer=caption__service__pb2.CaptionRequest.SerializeToString,
            response_deserializer=caption__service__pb2.CaptionReply.FromString,
        )
        self.Explain = channel.unary_unary(
            f"/{_SERVICE}/Explain",
            request_serializer=caption__service__pb2.ExplainRequest.SerializeToString,
            response_deserializer=caption__service__pb2.ExplainReply.FromString,
        )


class CaptionServiceServicer:
    """Service interface; override the methods in a subclass."""

    def Health(self, request, context):
        context.set_code(grpc.StatusCode.UNIMPLEMENTED)
        context.set_details("Method not implemented!")
        raise NotImplementedError("Method not implemented!")

    def Stats(self, request, context):
        context.set_code(grpc.StatusCode.UNIMPLEMENTED)
        context.set_details("Method not implemented!")
        raise NotImplementedError("Method not implemented!")

    def Caption(self, request, context):
        context.set_code(grpc.StatusCode.UNIMPLEMENTED)
        context.set_details("Method not implemented!")
        raise NotImplementedError("Method not implemented!")

    def Explain(self, request, context):
        context.set_code(grpc.StatusCode.UNIMPLEMENTED)
        context.set_details("Method not implemented!")
        raise NotImplementedError("Method not implemented!")


def add_CaptionServiceServicer_to_server(servicer, server):
    rpc_method_handlers = {
        "Health": grpc.unary_unary_rpc_method_handler(
            servicer.Health,
            request_deserializer=caption__service__pb2.HealthRequest.FromString,
            response_serializer=caption__service__pb2.HealthReply.SerializeToString,
        ),
        "Stats": grpc.unary_unary_rpc_method_handler(
            servicer.Stats,
            request_deserializer=caption__service__pb2.StatsRequest.FromString,
            response_serializer=caption__service__pb2.StatsReply.SerializeToString,
        ),
        "Caption": grpc.unary_unary_rpc_method_handler(
            servicer.Caption,
            request_deserializer=caption__service__pb2.CaptionRequest.FromString,
            response_serializer=caption__service__pb2.CaptionReply.SerializeToString,
        ),
        "Explain": grpc.unary_unary_rpc_method_handler(
            servicer.Explain,
            request_deserializer=caption__service__pb2.ExplainRequest.FromString,
            response_serializer=caption__service__pb2.ExplainReply.SerializeToString,
        ),
    }
    generic_handler = grpc.method_handlers_generic_handler(_SERVICE, rpc_method_handlers)
    server.add_generic_rpc_handlers((generic_handler,))
