"""gRPC front-end over ``CaptionService``: the port of the JAX package's
``infer/grpc_server.py``, speaking its wire contract unchanged, so either
package's clients talk to either package's server.

Two services on one server:

* ``lrpic.v1.CaptionService``: the typed contract of the committed
  ``infer/proto/caption_service.proto`` with its vendored stubs, registered
  whenever the stubs import;
* ``lrpic.CaptionService``: the raw-bytes service (generic method handlers,
  identity serializers, ``.npy`` / ``.npz`` / JSON payloads):

  * ``/lrpic.CaptionService/Health``  -> JSON ``{"ok": true}``;
  * ``/lrpic.CaptionService/Stats``   -> JSON request/image/latency counters;
  * ``/lrpic.CaptionService/Caption`` -> request: ``.npy`` bytes (detected
    by the NUMPY magic) or JSON ``{"images": [...]}`` of (N,H,W,3) float
    images; response: JSON ``{"captions": [...]}``;
  * ``/lrpic.CaptionService/Explain`` -> the same request formats, plus a
    JSON ``"method"`` field or the ``lrpic-method`` invocation-metadata key
    selecting the analyzer. Response: ``.npz`` bytes with, per image ``i``,
    ``caption_i``, ``words_i``, ``relevance_maps_i`` (float16) and
    ``word_relevances_i``: the HTTP ``/explain`` payload's layout.

Requests go through the service's micro-batching queue when it is running,
else directly. Malformed requests abort with INVALID_ARGUMENT, dispatch
failures with INTERNAL. ``grpcio`` is imported only when a server or client
is built, so the module imports without it.
"""

from __future__ import annotations

import io
import json
from concurrent import futures as _futures

import numpy as np

from .http_server import npz_payload

try:  # vendored typed stubs; raw-bytes generic service is the fallback
    from .proto import caption_service_pb2 as _pb2
    from .proto import caption_service_pb2_grpc as _pb2_grpc
except Exception:  # pragma: no cover - protobuf runtime incompatibility only
    _pb2 = _pb2_grpc = None

_NPY_MAGIC = b"\x93NUMPY"


def _parse_request(body: bytes):
    """-> (images float32 (N,H,W,3), method_or_None). Mirrors http_server."""
    method = None
    if body[:6] == _NPY_MAGIC:
        arr = np.load(io.BytesIO(body), allow_pickle=False)
    else:
        obj = json.loads(body)
        arr = np.asarray(obj["images"], dtype=np.float32)
        method = obj.get("method")
    if arr.ndim == 3:
        arr = arr[None]
    if arr.ndim != 4 or arr.shape[-1] != 3:
        raise ValueError(f"expected (N, H, W, 3) images, got {arr.shape}")
    return arr.astype(np.float32), method


def _batch_to_array(batch) -> np.ndarray:
    """lrpic.v1.ImageBatch -> float32 (N,H,W,3) array, shape-validated."""
    n, h, w = int(batch.n), int(batch.height), int(batch.width)
    if min(n, h, w) <= 0:
        raise ValueError(f"invalid ImageBatch dims n={n} h={h} w={w}")
    want = n * h * w * 3 * 4
    if len(batch.data) != want:
        raise ValueError(
            f"ImageBatch data carries {len(batch.data)} bytes, expected "
            f"{want} for float32 ({n},{h},{w},3)")
    return np.frombuffer(batch.data, dtype="<f4").reshape(n, h, w, 3)


def _array_to_batch(images: np.ndarray):
    images = np.ascontiguousarray(np.asarray(images, dtype="<f4"))
    if images.ndim == 3:
        images = images[None]
    if images.ndim != 4 or images.shape[-1] != 3:
        raise ValueError(f"expected (N, H, W, 3) images, got {images.shape}")
    n, h, w, _ = images.shape
    return _pb2.ImageBatch(n=n, height=h, width=w, data=images.tobytes())


class _TypedServicer(_pb2_grpc.CaptionServiceServicer if _pb2_grpc else object):
    """lrpic.v1.CaptionService handlers delegating to the byte-level ones
    (same validation, same dispatch path, typed envelopes)."""

    def __init__(self, server: "CaptionGrpcServer"):
        self._s = server

    def Health(self, request, context):
        return _pb2.HealthReply(ok=True)

    def Stats(self, request, context):
        return _pb2.StatsReply(stats_json=json.dumps(dict(self._s.service.stats)))

    def _images(self, batch, context):
        try:
            images = _batch_to_array(batch)
            expected = getattr(self._s.service, "expected_hw", None)
            if expected is not None and tuple(images.shape[1:3]) != tuple(expected):
                raise ValueError(
                    f"images must be {tuple(expected)} (service resolution), "
                    f"got {tuple(images.shape[1:3])}")
            return images
        except Exception as e:
            context.abort(self._s._grpc.StatusCode.INVALID_ARGUMENT, str(e))

    def Caption(self, request, context):
        images = self._images(request.images, context)
        try:
            captions = self._s.service.dispatch(images)
        except Exception as e:
            context.abort(self._s._grpc.StatusCode.INTERNAL,
                          f"{type(e).__name__}: {e}")
        return _pb2.CaptionReply(captions=captions)

    def Explain(self, request, context):
        images = self._images(request.images, context)
        method = request.method or None
        try:
            exps = self._s.service.dispatch(images, explain=True, method=method)
        except Exception as e:
            context.abort(self._s._grpc.StatusCode.INTERNAL,
                          f"{type(e).__name__}: {e}")
        out = []
        for e in exps:
            maps = np.asarray(e.relevance_maps, dtype="<f2")
            wrel = np.asarray(e.word_relevances, dtype="<f2")
            out.append(_pb2.Explanation(
                caption=str(e.caption),
                words=[str(w) for w in e.words],
                relevance_maps=np.ascontiguousarray(maps).tobytes(),
                relevance_maps_shape=list(maps.shape),
                word_relevances=np.ascontiguousarray(wrel).tobytes(),
                word_relevances_shape=list(wrel.shape),
            ))
        return _pb2.ExplainReply(explanations=out)


class CaptionGrpcServer:
    """gRPC wrapper around a (warmed) ``CaptionService``.

    ``port=0`` binds an ephemeral port (read it back from ``.port``).
    ``max_workers`` bounds concurrent handler threads; device work still
    serializes through the service (and coalesces when its micro-batching
    queue is running)."""

    SERVICE = "lrpic.CaptionService"

    def __init__(self, service, host: str = "127.0.0.1", port: int = 0,
                 max_workers: int = 8, max_message_bytes: int = 256 << 20):
        import grpc

        self.service = service
        self._grpc = grpc
        # grpc's 4 MB default receive limit rejects realistic image batches
        # (8 x 224x224x3 float32 .npy is ~4.8 MB) that the HTTP front-end
        # accepts; raise both directions to the same cap the HTTP server uses
        self._server = grpc.server(
            _futures.ThreadPoolExecutor(max_workers=max_workers),
            options=[
                ("grpc.max_receive_message_length", int(max_message_bytes)),
                ("grpc.max_send_message_length", int(max_message_bytes)),
            ])
        handlers = {
            "Health": grpc.unary_unary_rpc_method_handler(self._health),
            "Stats": grpc.unary_unary_rpc_method_handler(self._stats),
            "Caption": grpc.unary_unary_rpc_method_handler(self._caption),
            "Explain": grpc.unary_unary_rpc_method_handler(self._explain),
        }
        self._server.add_generic_rpc_handlers(
            (grpc.method_handlers_generic_handler(self.SERVICE, handlers),))
        # the typed lrpic.v1 contract rides the same server whenever the
        # vendored stubs import (i.e. always, barring a protobuf runtime
        # incompatibility — then the raw-bytes service above still serves)
        self.typed = _pb2_grpc is not None
        if self.typed:
            _pb2_grpc.add_CaptionServiceServicer_to_server(
                _TypedServicer(self), self._server)
        self.port = self._server.add_insecure_port(f"{host}:{port}")

    # -- handlers (bytes in -> bytes out) --------------------------------
    def _health(self, request: bytes, context) -> bytes:
        return b'{"ok": true}'

    def _stats(self, request: bytes, context) -> bytes:
        return json.dumps(dict(self.service.stats)).encode()

    def _images(self, request: bytes, context):
        try:
            images, method = _parse_request(request)
            expected = getattr(self.service, "expected_hw", None)
            if expected is not None and tuple(images.shape[1:3]) != tuple(expected):
                raise ValueError(
                    f"images must be {tuple(expected)} (service resolution), "
                    f"got {tuple(images.shape[1:3])}")
            return images, method
        except Exception as e:
            context.abort(self._grpc.StatusCode.INVALID_ARGUMENT, str(e))

    def _caption(self, request: bytes, context) -> bytes:
        images, _ = self._images(request, context)
        try:
            captions = self.service.dispatch(images)
        except Exception as e:
            context.abort(self._grpc.StatusCode.INTERNAL,
                          f"{type(e).__name__}: {e}")
        return json.dumps({"captions": captions}).encode()

    def _explain(self, request: bytes, context) -> bytes:
        images, method = self._images(request, context)
        for key, value in context.invocation_metadata():
            if key == "lrpic-method":
                method = value
        try:
            # method=None -> the service's default analyzer (for exported
            # artifacts: whatever method the artifact carries)
            exps = self.service.dispatch(images, explain=True, method=method)
        except Exception as e:
            context.abort(self._grpc.StatusCode.INTERNAL,
                          f"{type(e).__name__}: {e}")
        return npz_payload(exps)

    # -- lifecycle -------------------------------------------------------
    def start(self):
        self._server.start()
        return self

    def stop(self, grace: float = 1.0):
        self._server.stop(grace).wait()


class CaptionGrpcClient:
    """Minimal client for ``CaptionGrpcServer`` (identity serializers).

    >>> client = CaptionGrpcClient("127.0.0.1:50051")
    >>> client.caption(images)          # -> list[str]
    >>> client.explain(images, "lrp")   # -> dict of numpy arrays
    """

    def __init__(self, target: str, max_message_bytes: int = 256 << 20):
        import grpc

        # multi-image Explain responses (W x H x W x 3 float16 maps per
        # image) blow through the 4 MB channel default
        self._channel = grpc.insecure_channel(target, options=[
            ("grpc.max_receive_message_length", int(max_message_bytes)),
            ("grpc.max_send_message_length", int(max_message_bytes)),
        ])
        svc = CaptionGrpcServer.SERVICE

        def method(name):
            return self._channel.unary_unary(f"/{svc}/{name}")

        self._health = method("Health")
        self._stats = method("Stats")
        self._caption = method("Caption")
        self._explain = method("Explain")

    @staticmethod
    def _npy(images: np.ndarray) -> bytes:
        buf = io.BytesIO()
        np.save(buf, np.asarray(images, dtype=np.float32), allow_pickle=False)
        return buf.getvalue()

    def health(self) -> bool:
        return json.loads(self._health(b""))["ok"]

    def stats(self) -> dict:
        return json.loads(self._stats(b""))

    def caption(self, images: np.ndarray) -> list:
        return json.loads(self._caption(self._npy(images)))["captions"]

    def explain(self, images: np.ndarray, method: str = "lrp") -> dict:
        body = self._explain(self._npy(images),
                             metadata=(("lrpic-method", method),))
        with np.load(io.BytesIO(body), allow_pickle=False) as z:
            return {k: z[k] for k in z.files}

    def close(self):
        self._channel.close()


class CaptionGrpcTypedClient:
    """Client for the typed ``lrpic.v1.CaptionService`` contract (the
    vendored stubs — what a non-Python client would generate from the
    committed .proto).

    >>> client = CaptionGrpcTypedClient("127.0.0.1:50051")
    >>> client.caption(images)          # -> list[str]
    >>> client.explain(images, "lrp")   # -> [{"caption", "words",
    ...                                 #      "relevance_maps",
    ...                                 #      "word_relevances"}, ...]
    """

    def __init__(self, target: str, max_message_bytes: int = 256 << 20):
        import grpc

        if _pb2_grpc is None:  # pragma: no cover - protobuf runtime only
            raise RuntimeError("vendored caption_service stubs failed to import")
        self._channel = grpc.insecure_channel(target, options=[
            ("grpc.max_receive_message_length", int(max_message_bytes)),
            ("grpc.max_send_message_length", int(max_message_bytes)),
        ])
        self._stub = _pb2_grpc.CaptionServiceStub(self._channel)

    def health(self) -> bool:
        return self._stub.Health(_pb2.HealthRequest()).ok

    def stats(self) -> dict:
        return json.loads(self._stub.Stats(_pb2.StatsRequest()).stats_json)

    def caption(self, images: np.ndarray) -> list:
        reply = self._stub.Caption(
            _pb2.CaptionRequest(images=_array_to_batch(images)))
        return list(reply.captions)

    def explain(self, images: np.ndarray, method: str = "") -> list:
        reply = self._stub.Explain(_pb2.ExplainRequest(
            images=_array_to_batch(images), method=method))
        out = []
        for e in reply.explanations:
            out.append({
                "caption": e.caption,
                "words": list(e.words),
                "relevance_maps": np.frombuffer(
                    e.relevance_maps, dtype="<f2").reshape(tuple(e.relevance_maps_shape)),
                "word_relevances": np.frombuffer(
                    e.word_relevances, dtype="<f2").reshape(tuple(e.word_relevances_shape)),
            })
        return out

    def close(self):
        self._channel.close()
