"""PyTorch port: the HTTP and gRPC front-ends (``infer/http_server.py``,
``infer/grpc_server.py``) against the JAX package's, on the same params
(``params_from_jax``) at the serving tests' small size
(tests/test_torch_serving.py).

The JAX package's own clients (urllib for HTTP; ``CaptionGrpcClient`` and
``CaptionGrpcTypedClient``) talk to the port's servers, and each decoded
payload must equal the JAX server's on the same request: captions and words
equal, the float16 maps within 1e-4 of their scale beyond one float16
spacing at the value (a rounding the f32 difference flipped): the
Explainer's bound (tests/test_torch_explainer.py) carried through the
payload's dtype. The error statuses (400, 404, 413,
500; INVALID_ARGUMENT, INTERNAL) and the CLI's ``serve`` are held as the
JAX tests hold them. gRPC tests skip where grpcio is absent.
"""

import http.client
import io
import json
import socket
import threading
import time
import urllib.error
import urllib.request

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax  # noqa: E402

from lrp_imagecaptioning_tpu.config import FlickrConfig as JConfig  # noqa: E402
from lrp_imagecaptioning_tpu.infer.http_server import CaptionHTTPServer as JHTTP  # noqa: E402
from lrp_imagecaptioning_tpu.infer.serving import CaptionService as JService  # noqa: E402
from lrp_imagecaptioning_tpu.models.captioner import build_captioner as j_build  # noqa: E402
from lrp_imagecaptioning_torch import cli  # noqa: E402
from lrp_imagecaptioning_torch.config import FlickrConfig as TConfig  # noqa: E402
from lrp_imagecaptioning_torch.infer.http_server import CaptionHTTPServer  # noqa: E402
from lrp_imagecaptioning_torch.infer.serving import CaptionService  # noqa: E402
from lrp_imagecaptioning_torch.models.captioner import build_captioner as t_build  # noqa: E402
from lrp_imagecaptioning_torch.weights import params_from_jax  # noqa: E402

torch.set_num_threads(2)

SMALL = dict(embedding_dim=16, hidden_dim=16, layer_name="block2_conv1", img_feature_length=16,
             img_feature_dim=128, sentence_length=5, image_size=(8, 8))
VOCAB = 16
MAP_RTOL = 1e-4


class FakePP:
    SOS_TOKEN = "szeros"
    EOS_TOKEN = "zeros"
    SOS_TOKEN_LABEL_ENCODED = 1
    EOS_TOKEN_LABEL_ENCODED = 2
    word_of = {i: f"w{i}" for i in range(1, VOCAB + 1)}
    word_of[1], word_of[2] = "szeros", "zeros"


@pytest.fixture(scope="module")
def services():
    """(JAX service, port service), both warmed, at batch 2, beam 2."""
    jcap = j_build("adaptiveattention", JConfig(drop_rate=0.0, **SMALL), VOCAB)
    pj = jcap.init_params(jax.random.PRNGKey(3))
    tcap = t_build("adaptiveattention", TConfig(**SMALL), VOCAB)
    jsvc = JService(jcap, pj, FakePP(), batch_size=2, beam_size=2).warmup(explain=True)
    tsvc = CaptionService(tcap, params_from_jax(pj, "cpu"), FakePP(), batch_size=2, beam_size=2,
                          device="cpu").warmup(explain=True)
    return jsvc, tsvc


@pytest.fixture(scope="module")
def servers(services):
    """HTTP servers over the JAX and the port service: their base URLs."""
    jsrv = JHTTP(services[0], port=0).start()
    tsrv = CaptionHTTPServer(services[1], port=0).start()
    yield f"http://127.0.0.1:{jsrv.port}", f"http://127.0.0.1:{tsrv.port}"
    jsrv.stop()
    tsrv.stop()


def _images(n, seed=0):
    return (np.random.default_rng(seed).normal(size=(n, 8, 8, 3)) * 40).astype(np.float32)


def _npy(images):
    buf = io.BytesIO()
    np.save(buf, images)
    return buf.getvalue()


def _post(url, body, ctype):
    req = urllib.request.Request(url, data=body, headers={"Content-Type": ctype})
    with urllib.request.urlopen(req, timeout=120) as r:
        return r.headers["Content-Type"], r.read()


def _status(url, body, ctype="application/json"):
    try:
        _post(url, body, ctype)
    except urllib.error.HTTPError as e:
        return e.code, e.read().decode()
    return 200, ""


def _assert_same_npz(got: dict, ref: dict):
    assert sorted(got) == sorted(ref)
    for key, want in ref.items():
        have = got[key]
        assert have.dtype == want.dtype and have.shape == want.shape, key
        if key.startswith(("relevance_maps_", "word_relevances_")):
            a, b = have.astype(np.float32), want.astype(np.float32)
            spacing = np.spacing(np.abs(want)).astype(np.float32)
            excess = float(np.maximum(np.abs(a - b) - spacing, 0.0).max())
            assert excess <= MAP_RTOL * (float(np.abs(b).max()) or 1.0), (key, excess)
        else:
            np.testing.assert_array_equal(have, want)


def _npz(body):
    with np.load(io.BytesIO(body), allow_pickle=False) as z:
        return {k: z[k] for k in z.files}


def test_http_payloads_equal_the_jax_servers(servers):
    """/caption (JSON and .npy bodies), /explain's npz, /healthz, /stats:
    the port's answers decode to the JAX server's."""
    jbase, tbase = servers
    images = _images(2, seed=1)
    for body, ctype in ((json.dumps({"images": images.tolist()}).encode(), "application/json"),
                        (_npy(images), "application/x-npy")):
        answers = [json.loads(_post(f"{base}/caption", body, ctype)[1]) for base in servers]
        assert answers[1] == answers[0] and len(answers[1]["captions"]) == 2
    (jtype, jbody), (ttype, tbody) = (_post(f"{base}/explain?method=lrp", _npy(images),
                                            "application/x-npy") for base in servers)
    assert ttype == jtype == "application/x-npz"
    _assert_same_npz(_npz(tbody), _npz(jbody))
    for path in ("/healthz", "/stats"):
        with urllib.request.urlopen(f"{tbase}{path}") as r:
            got = json.load(r)
        with urllib.request.urlopen(f"{jbase}{path}") as r:
            want = json.load(r)
        assert sorted(got) == sorted(want)
    assert got["images"] >= 6


def test_http_errors_match_the_jax_servers(servers):
    """400 for a malformed body and a wrong resolution, 404 for an unknown
    path, 413 for an over-limit declared length, 500 for a dispatch that
    raises (an unknown analyzer)."""
    jbase, tbase = servers
    wrong = json.dumps({"images": _images(1)[:, :4, :4].tolist()}).encode()
    cases = [("/caption", b"{}"), ("/caption", wrong), ("/nowhere", _npy(_images(1))),
             ("/explain?method=nosuch", _npy(_images(1)))]
    for path, body in cases:
        (jcode, _), (tcode, ttext) = (_status(f"{base}{path}", body, "application/x-npy"
                                              if body[:1] == b"\x93" else "application/json")
                                      for base in servers)
        assert tcode == jcode, path
    assert _status(f"{tbase}/caption", wrong)[0] == 400
    assert "resolution" in _status(f"{tbase}/caption", wrong)[1]
    assert _status(f"{tbase}/explain?method=nosuch", _npy(_images(1)), "application/x-npy")[0] \
        == 500
    port = int(tbase.rsplit(":", 1)[1])
    conn = http.client.HTTPConnection("127.0.0.1", port)
    try:
        conn.putrequest("POST", "/caption")
        conn.putheader("Content-Type", "application/json")
        conn.putheader("Content-Length", str(1 << 40))
        conn.endheaders()
        assert conn.getresponse().status == 413
    finally:
        conn.close()


def test_http_sixteen_concurrent_clients_share_dispatches(services, servers):
    """16 clients at once, one image each, through the queue: every caption
    equals its image's direct one, and the queue coalesced them (fewer
    dispatches than requests; no connection refused or reset)."""
    tsvc, base = services[1], servers[1]
    images = _images(16, seed=7)
    want = [tsvc.caption(images[i:i + 1])[0] for i in range(16)]
    got, errors = [None] * 16, []
    gate = threading.Barrier(17)

    def client(i):
        gate.wait()
        try:
            body = json.dumps({"images": images[i:i + 1].tolist()}).encode()
            got[i] = json.loads(_post(f"{base}/caption", body, "application/json")[1])
        except Exception as e:  # noqa: BLE001 — asserted below
            errors.append(e)

    tsvc.start_queue(linger_ms=20.0)
    try:
        requests = tsvc.stats["requests"]
        threads = [threading.Thread(target=client, args=(i,)) for i in range(16)]
        for t in threads:
            t.start()
        gate.wait()
        for t in threads:
            t.join(timeout=120)
        assert not any(t.is_alive() for t in threads) and not errors
        assert tsvc.stats["requests"] - requests < 16
    finally:
        tsvc.stop_queue()
    assert [g["captions"][0] for g in got] == want


def test_grpc_jax_clients_talk_to_the_port_server(services):
    """The JAX package's raw and typed gRPC clients against the port's
    server, each answer equal to the JAX server's; malformed requests abort
    with INVALID_ARGUMENT, a dispatch that raises with INTERNAL."""
    grpc = pytest.importorskip("grpc")
    from lrp_imagecaptioning_tpu.infer.grpc_server import (CaptionGrpcClient,
                                                           CaptionGrpcServer as JGrpc,
                                                           CaptionGrpcTypedClient)
    from lrp_imagecaptioning_tpu.infer.proto import caption_service_pb2 as pb2
    from lrp_imagecaptioning_torch.infer.grpc_server import CaptionGrpcServer

    jsrv = JGrpc(services[0], port=0).start()
    tsrv = CaptionGrpcServer(services[1], port=0).start()
    assert tsrv.typed
    clients = {name: (CaptionGrpcClient(f"127.0.0.1:{s.port}"),
                      CaptionGrpcTypedClient(f"127.0.0.1:{s.port}"))
               for name, s in (("jax", jsrv), ("port", tsrv))}
    try:
        images = _images(2, seed=2)
        (jraw, jtyped), (traw, ttyped) = clients["jax"], clients["port"]
        assert traw.health() is True and ttyped.health() is True
        assert traw.caption(images) == ttyped.caption(images) == jraw.caption(images)
        body = json.dumps({"images": images.tolist()}).encode()
        assert json.loads(traw._caption(body))["captions"] == jraw.caption(images)
        _assert_same_npz(traw.explain(images, "lrp"), jraw.explain(images, "lrp"))
        for got, want in zip(ttyped.explain(images, "lrp"), jtyped.explain(images, "lrp")):
            assert got["caption"] == want["caption"] and got["words"] == want["words"]
            _assert_same_npz({f"relevance_maps_0": got["relevance_maps"],
                              f"word_relevances_0": got["word_relevances"]},
                             {f"relevance_maps_0": want["relevance_maps"],
                              f"word_relevances_0": want["word_relevances"]})
        assert sorted(ttyped.stats()) == sorted(jtyped.stats())

        bad = pb2.CaptionRequest(images=pb2.ImageBatch(n=2, height=8, width=8, data=b"\0" * 7))
        with pytest.raises(grpc.RpcError) as err:
            ttyped._stub.Caption(bad)
        assert err.value.code() == grpc.StatusCode.INVALID_ARGUMENT
        with pytest.raises(grpc.RpcError) as err:
            traw._caption(b"{}")
        assert err.value.code() == grpc.StatusCode.INVALID_ARGUMENT
        with pytest.raises(grpc.RpcError) as err:
            traw.explain(images[:1], "nosuch")
        assert err.value.code() == grpc.StatusCode.INTERNAL
    finally:
        for raw, typed in clients.values():
            raw.close()
            typed.close()
        jsrv.stop()
        tsrv.stop()


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _wait_healthy(base, seconds=120):
    deadline = time.time() + seconds
    while time.time() < deadline:
        try:
            with urllib.request.urlopen(f"{base}/healthz", timeout=2) as r:
                if json.load(r)["ok"]:
                    return
        except OSError:
            time.sleep(0.2)
    raise TimeoutError(base)


def test_cli_serve_answers_on_the_mini_fixture(tmp_path, monkeypatch):
    """``serve --with-explain`` on the mini-Flickr30k fixture at a small
    size: it warms, answers one /explain over HTTP through its queue, and
    exits after --serve-seconds."""
    from lrp_imagecaptioning_torch.data.minifixture import write_mini_flickr30k

    monkeypatch.chdir(tmp_path)
    write_mini_flickr30k("mini")
    port = _free_port()
    argv = ["serve", "--dataset-root", "mini", "--batch-size", "2", "--device", "cpu",
            "--port", str(port), "--serve-seconds", "4", "--with-explain"]
    for kv in ("image_size=8,8", "layer_name=block2_conv1", "img_feature_length=16",
               "img_feature_dim=128", "embedding_dim=16", "hidden_dim=16", "sentence_length=5",
               "words_min_occur=1", "rare_words_handling=nothing"):
        argv += ["--set", kv]
    server = threading.Thread(target=cli.main, args=(argv,))
    server.start()
    try:
        _wait_healthy(f"http://127.0.0.1:{port}")
        _, body = _post(f"http://127.0.0.1:{port}/explain", _npy(_images(1)), "application/x-npy")
        z = _npz(body)
        assert z["relevance_maps_0"].shape == (len(z["words_0"]), 8, 8, 3)
        assert str(z["caption_0"]).endswith("zeros")
    finally:
        server.join(timeout=60)
    assert not server.is_alive()


@pytest.mark.parametrize("flag", [["--mesh", "2"], ["--shard-words"]])
def test_cli_serve_several_cards_raise_naming_a13b(flag, tmp_path):
    """The JAX CLI's up-front errors: ``--exported DIR --mesh N`` with more
    devices than there are (on a CPU-only host the card has none), and
    ``--shard-words`` without a mesh."""
    if flag[0] == "--mesh":
        (tmp_path / "meta.json").write_text('{"method": null, "batch_size": 2, "beam_size": 3}')
        with pytest.raises(SystemExit, match="available"):
            cli.main(["serve", "--exported", str(tmp_path), *flag])
        return
    with pytest.raises(ValueError, match="requires a mesh"):
        cli.main(["serve", "--device", "cpu", *flag])
