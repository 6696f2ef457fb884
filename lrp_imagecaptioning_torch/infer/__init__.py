"""Caption decoding, the inference API and serving."""

from .. import lazy_exports

# the JAX package's exports, loaded on first use
_EXPORTS = {
    "greedy_decode": ".greedy",
    "beam_search": ".beam",
    "BasicInference": ".api",
    "BeamSearchInference": ".api",
    "CaptionService": ".serving",
    "CaptionHTTPServer": ".http_server",
    "CaptionGrpcServer": ".grpc_server",
    "CaptionGrpcClient": ".grpc_server",
    "CaptionGrpcTypedClient": ".grpc_server",
}

__getattr__, __dir__ = lazy_exports(__name__, _EXPORTS)
