"""PyTorch port: LSTM cell, VGG forward and the adaptive decoder against the
JAX package, with params carried across by ``params_from_jax``.

Tolerances: everything goes through f32 matmuls/convs summed in another
order than XLA's, at O(1) values: rtol 1e-5 / atol 1e-5 (1e-4 for the VGG
activations, which grow through the ReLU stack).
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from lrp_imagecaptioning_tpu.config import FlickrConfig as JConfig  # noqa: E402
from lrp_imagecaptioning_tpu.models import adaptive as jad  # noqa: E402
from lrp_imagecaptioning_tpu.models import cells as jcells  # noqa: E402
from lrp_imagecaptioning_tpu.models import vgg as jvgg  # noqa: E402
from lrp_imagecaptioning_tpu.train.checkpoint import save_params_npz  # noqa: E402
from lrp_imagecaptioning_torch.models import adaptive as tad  # noqa: E402
from lrp_imagecaptioning_torch.models import cells as tcells  # noqa: E402
from lrp_imagecaptioning_torch.models import vgg as tvgg  # noqa: E402
from lrp_imagecaptioning_torch.weights import load_params_npz, params_from_jax  # noqa: E402

torch.set_num_threads(2)

E, H, D, L, V = 8, 12, 16, 9, 20


def _close(got, ref, rtol=1e-5, atol=1e-5):
    np.testing.assert_allclose(got.detach().cpu().numpy(), np.asarray(ref), rtol=rtol, atol=atol)


@pytest.fixture(scope="module")
def decoder():
    cfg = JConfig(embedding_dim=E, hidden_dim=H, img_feature_dim=D, img_feature_length=L)
    pj = jad.init_params(jax.random.PRNGKey(3), V, cfg)
    return pj, params_from_jax(pj, "cpu")


def test_lstm_step_matches_jax():
    rng = np.random.default_rng(30)
    pj = jcells.lstm_init(jax.random.PRNGKey(0), 10, 16)
    pt = params_from_jax(pj, "cpu")
    x, h, c = (rng.normal(size=s).astype(np.float32) for s in [(4, 10), (4, 16), (4, 16)])
    sj, cj = jcells.lstm_step(pj, jnp.asarray(x), jcells.LSTMState(jnp.asarray(h), jnp.asarray(c)))
    st, ct = tcells.lstm_step(pt, torch.from_numpy(x),
                              tcells.LSTMState(torch.from_numpy(h), torch.from_numpy(c)))
    _close(st.h, sj.h)
    _close(st.c, sj.c)
    _close(ct.z_pre, cj.z_pre)


def test_vgg_apply_with_acts_truncated_matches_jax():
    rng = np.random.default_rng(31)
    pj = jvgg.init_vgg_params(jax.random.PRNGKey(1), "vgg16", "block2_conv1")
    pt = params_from_jax(pj, "cpu")
    x = rng.normal(size=(2, 16, 16, 3)).astype(np.float32)
    fj, ij = jvgg.vgg_apply_with_acts(pj, jnp.asarray(x), "vgg16", "block2_conv1")
    ft, it = tvgg.vgg_apply_with_acts(pt, torch.from_numpy(x), until="block2_conv1")
    assert ft.shape == (2, 8, 8, 128) and len(it) == len(ij) == 4
    _close(ft, fj, rtol=1e-4, atol=1e-4)
    for a, b in zip(it, ij):
        _close(a, b, rtol=1e-4, atol=1e-4)
    _close(tvgg.vgg_apply(pt, torch.from_numpy(x), until="block2_conv1"), fj, rtol=1e-4, atol=1e-4)


def test_adaptive_step_and_cached_forward_match_jax(decoder):
    pj, pt = decoder
    rng = np.random.default_rng(32)
    feat = rng.normal(size=(3, L, D)).astype(np.float32)
    tokens = rng.integers(0, V, size=(3, 5))
    cj = jad.prepare_consts(pj, jnp.asarray(feat))
    ct = tad.prepare_consts(pt, torch.from_numpy(feat))
    for f in cj._fields:
        _close(getattr(ct, f), getattr(cj, f))

    emb = rng.normal(size=(3, E)).astype(np.float32)
    h0, c0 = (rng.normal(size=(3, H)).astype(np.float32) for _ in range(2))
    sj, kj = jad.step(pj, cj, jcells.LSTMState(jnp.asarray(h0), jnp.asarray(c0)), jnp.asarray(emb))
    st, kt = tad.step(pt, ct, tcells.LSTMState(torch.from_numpy(h0), torch.from_numpy(c0)),
                      torch.from_numpy(emb))
    _close(st.h, sj.h)
    _close(st.c, sj.c)
    for f in kj._fields:
        _close(getattr(kt, f), getattr(kj, f))

    cache_j = jad.forward_cached_from_inputs(pj, cj, jnp.asarray(tokens), H)
    cache_t = tad.forward_cached_from_inputs(pt, ct, torch.from_numpy(tokens), H)
    assert len(cache_t._fields) == 12 and cache_t._fields == cache_j._fields
    for f in cache_j._fields:
        assert getattr(cache_t, f).shape == getattr(cache_j, f).shape, f
        _close(getattr(cache_t, f), getattr(cache_j, f))


def test_npz_round_trip_from_jax_writer(decoder, tmp_path):
    pj, pt = decoder
    tree = {"decoder": pj, "blocks": [pj["attn"]["V"], (pj["lstm"]["b"],)], "empty": {}}
    path = str(tmp_path / "params.npz")
    save_params_npz(path, tree)
    back = load_params_npz(path, device="cpu")
    assert isinstance(back["blocks"], list) and isinstance(back["blocks"][1], tuple)
    assert back["empty"] == {}
    torch.testing.assert_close(back["blocks"][1][0], pt["lstm"]["b"], rtol=0, atol=0)

    def check(a, b):
        if isinstance(b, dict):
            assert a.keys() == b.keys()
            for k in b:
                check(a[k], b[k])
        else:
            assert a.dtype == torch.float32 and a.is_contiguous()
            torch.testing.assert_close(a, b, rtol=0, atol=0)

    check(back["decoder"], pt)


def test_entry_points_raise_without_cuda(decoder):
    if torch.cuda.is_available():
        pytest.skip("a card is present: device='cuda' is valid here")
    with pytest.raises(RuntimeError, match="cuda"):
        params_from_jax(decoder[0])
