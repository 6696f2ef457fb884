"""Minimal stdlib HTTP front-end over ``CaptionService``: the port of the
JAX package's ``infer/http_server.py``, with the same routes, limits and
payloads, byte for byte.

Endpoints
---------
* ``GET /healthz``  -> ``{"ok": true}`` once warmed.
* ``GET /stats``    -> the service's request/image/latency counters.
* ``POST /caption`` -> captions. Body is either JSON ``{"images": [...]}``
  (nested lists, (N,H,W,3)) or raw ``.npy`` bytes
  (``Content-Type: application/x-npy``). Response: ``{"captions": [...]}``.
* ``POST /explain`` -> captions + heatmaps. Same request formats; add
  ``?method=lrp|gradient|...`` to pick the analyzer. Response is an ``.npz``
  payload with, per image ``i``: ``caption_i`` (unicode), ``words_i``,
  ``relevance_maps_i`` (W, H, W, 3 float16), ``word_relevances_i``.

Errors: 413 for a declared body over the limit (before a byte is read), 400
for a malformed body or a resolution other than the service's, 404 for an
unknown path, 500 for a dispatch that raised.

Requests go through the service's micro-batching queue when it is running
(concurrent HTTP callers then share device dispatches); otherwise they
dispatch directly, each on its handler's thread (the service serializes the
device work).
"""

from __future__ import annotations

import io
import json
import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

import numpy as np


class _BodyTooLarge(Exception):
    pass


def npz_payload(explanations) -> bytes:
    """The ``/explain`` answer (and the gRPC raw service's): per image ``i``,
    ``caption_i``, ``words_i``, ``relevance_maps_i`` and ``word_relevances_i``
    (float16), compressed."""
    out = {}
    for i, e in enumerate(explanations):
        out[f"caption_{i}"] = np.asarray(e.caption)
        out[f"words_{i}"] = np.asarray(e.words)
        out[f"relevance_maps_{i}"] = e.relevance_maps.astype(np.float16)
        out[f"word_relevances_{i}"] = e.word_relevances.astype(np.float16)
    buf = io.BytesIO()
    np.savez_compressed(buf, **out)
    return buf.getvalue()


def _parse_images(handler: BaseHTTPRequestHandler, max_bytes: int,
                  expected_hw=None) -> np.ndarray:
    length = int(handler.headers.get("Content-Length", 0))
    if length > max_bytes:
        # reject on the DECLARED length before buffering anything — an
        # unbounded read here is a one-request memory-DoS
        raise _BodyTooLarge(f"body {length} bytes > limit {max_bytes}")
    body = handler.rfile.read(length)
    ctype = handler.headers.get("Content-Type", "application/json")
    if "npy" in ctype or "octet-stream" in ctype:
        arr = np.load(io.BytesIO(body), allow_pickle=False)
    else:
        arr = np.asarray(json.loads(body)["images"], dtype=np.float32)
    if arr.ndim == 3:
        arr = arr[None]
    if arr.ndim != 4 or arr.shape[-1] != 3:
        raise ValueError(f"expected (N, H, W, 3) images, got {arr.shape}")
    if expected_hw is not None and tuple(arr.shape[1:3]) != tuple(expected_hw):
        # the service is warmed for ONE resolution (its graphs, or an
        # exported program's fixed shapes): reject others as a client error
        raise ValueError(
            f"images must be {tuple(expected_hw)} (service resolution), "
            f"got {tuple(arr.shape[1:3])}")
    return arr.astype(np.float32)


class _Handler(BaseHTTPRequestHandler):
    # the server instance injects .service
    def log_message(self, *args):  # silence per-request stderr lines
        pass

    def _json(self, code: int, obj):
        payload = json.dumps(obj).encode()
        self.send_response(code)
        self.send_header("Content-Type", "application/json")
        self.send_header("Content-Length", str(len(payload)))
        self.end_headers()
        self.wfile.write(payload)

    def do_GET(self):
        if self.path == "/healthz":
            self._json(200, {"ok": True})
        elif self.path == "/stats":
            self._json(200, dict(self.server.service.stats))
        else:
            self._json(404, {"error": f"unknown path {self.path}"})

    def do_POST(self):
        path, _, query = self.path.partition("?")
        svc = self.server.service
        try:
            images = _parse_images(self, self.server.max_body_bytes,
                                   getattr(svc, "expected_hw", None))
        except _BodyTooLarge as e:
            return self._json(413, {"error": str(e)})
        except Exception as e:
            return self._json(400, {"error": str(e)})
        try:
            if path == "/caption":
                captions = svc.dispatch(images)
                return self._json(200, {"captions": captions})
            if path == "/explain":
                # None = the service's default analyzer (for an exported
                # artifact: the method it was exported with)
                method = None
                for kv in query.split("&"):
                    if kv.startswith("method="):
                        method = kv.split("=", 1)[1]
                exps = svc.dispatch(images, explain=True, method=method)
                payload = npz_payload(exps)
                self.send_response(200)
                self.send_header("Content-Type", "application/x-npz")
                self.send_header("Content-Length", str(len(payload)))
                self.end_headers()
                self.wfile.write(payload)
                return
            self._json(404, {"error": f"unknown path {path}"})
        except Exception as e:  # surface dispatch failures as 500s
            self._json(500, {"error": f"{type(e).__name__}: {e}"})


class _Server(ThreadingHTTPServer):
    # the stdlib's listen backlog of 5 resets connections when more clients
    # connect at once (16 concurrent clients did); a micro-batching service
    # expects bursts
    request_queue_size = 128


class CaptionHTTPServer:
    """Threaded HTTP wrapper around a (warmed) CaptionService.

    ``port=0`` binds an ephemeral port (read it back from ``.port`` after
    ``start()``). ``ThreadingHTTPServer`` gives one thread per connection;
    actual device work still serializes through the service (and coalesces
    when its micro-batching queue is running)."""

    def __init__(self, service, host: str = "127.0.0.1", port: int = 8000,
                 max_body_bytes: int = 256 << 20):
        self.service = service
        self._httpd = _Server((host, port), _Handler)
        self._httpd.service = service
        self._httpd.max_body_bytes = int(max_body_bytes)
        self._thread = None

    @property
    def port(self) -> int:
        return self._httpd.server_address[1]

    def start(self):
        self._thread = threading.Thread(target=self._httpd.serve_forever, daemon=True)
        self._thread.start()
        return self

    def stop(self):
        self._httpd.shutdown()
        self._httpd.server_close()
        if self._thread is not None:
            self._thread.join()
            self._thread = None
