"""Import reference Keras HDF5 checkpoints (the ``save_weights`` format of
the reference's train.py:79-88) into the port's params tree.

The port's own copy of the JAX package's ``models/weights_io.py`` readers
for vgg16 with adaptive attention or grid-TD. Keras layer/weight naming
(model.py):

* ``image_features`` / ``global_img_feature`` / ``output``: Dense
  kernel/bias (model.py:446-466);
* ``embedding_*``: the embedding table (model.py:80-93);
* adaptive wrapper ``external_attention_rnn_wrapper_local_attention_v3_*``:
  the wrapped LSTM's kernel/recurrent_kernel/bias and the attention weights
  suffixed ``_Wv, _Wg, _V, _Wx, _Wh, _Ws`` (model.py:555-571);
* grid-TD wrapper ``external_bottom_up_attention_adaptive_*``: the language
  LSTM's kernel/recurrent_kernel/bias, the TD-LSTM weights
  ``_top_down_lstm_weight_i/_h/_bias`` and the attention weights
  ``_W_va, _W_ha, _W_a, _W_x, _W_h, _W_s`` (model.py:702-743);
* VGG16 conv layers under their keras.applications block names.

Keras's LSTM gate order [i, f, c(g), o] is the port's, and conv kernels are
HWIO on both sides: nothing is permuted. h5py is imported inside the
readers only.
"""

from __future__ import annotations

import numpy as np

from ..weights import params_from_jax
from .vgg import vgg_layers


def _collect_datasets(group, out, prefix=""):
    import h5py

    for k, v in group.items():
        name = f"{prefix}/{k}" if prefix else k
        if isinstance(v, h5py.Group):
            _collect_datasets(v, out, name)
        else:
            out[name] = np.asarray(v)


def _layer_weights(root, match: str) -> dict:
    """All datasets under the first layer group whose name contains
    ``match`` -> {full_weight_name: array}."""
    for layer_name in root:
        if match in layer_name:
            out: dict = {}
            _collect_datasets(root[layer_name], out)
            return out
    raise KeyError(f"no layer matching {match!r} in checkpoint")


def _pick(weights: dict, *substrings, exclude=()):
    for name, arr in sorted(weights.items()):
        if all(s in name for s in substrings) and not any(e in name for e in exclude):
            return arr
    raise KeyError(f"no weight matching {substrings} (have {list(weights)})")


def _pick_any(weights: dict, *alternatives, exclude=()):
    """First alternative substring-set that matches any weight."""
    for alt in alternatives:
        try:
            return _pick(weights, *alt, exclude=exclude)
        except KeyError:
            continue
    raise KeyError(f"no weight matching any of {alternatives} (have {list(weights)})")


def _dense(weights: dict) -> dict:
    return {"kernel": _pick(weights, "kernel"), "bias": _pick(weights, "bias")}


def _root(f):
    return f["model_weights"] if "model_weights" in f else f


def load_reference_decoder_h5(path: str, model_type: str) -> dict:
    """Decoder params (numpy) from a reference checkpoint."""
    import h5py

    with h5py.File(path, "r") as f:
        root = _root(f)
        params: dict = {
            "embedding": _pick(_layer_weights(root, "embedding"), "embedding"),
            "image_features": _dense(_layer_weights(root, "image_features")),
            "global_img_feature": _dense(_layer_weights(root, "global_img_feature")),
            "output": _dense(_layer_weights(root, "output")),
        }
        if model_type == "adaptiveattention":
            w = _layer_weights(root, "external_attention_rnn_wrapper_local_attention_v3")
            params["lstm"] = {
                "wi": _pick(w, "kernel", exclude=("recurrent",)),
                "wh": _pick(w, "recurrent_kernel"),
                "b": _pick(w, "bias", exclude=("_Wv", "_Wg", "_Wx", "_Wh", "_Ws")),
            }
            params["attn"] = {
                "Wv": _pick(w, "_Wv"), "Wg": _pick(w, "_Wg"), "Wx": _pick(w, "_Wx"),
                "Wh": _pick(w, "_Wh"), "Ws": _pick(w, "_Ws"), "V": _pick(w, "_V", exclude=("_Wv",)),
            }
        elif model_type == "gridTD":
            w = _layer_weights(root, "external_bottom_up_attention_adaptive")
            params["lang_lstm"] = {
                "wi": _pick(w, "kernel", exclude=("recurrent", "top_down")),
                "wh": _pick(w, "recurrent_kernel"),
                "b": _pick(w, "bias", exclude=("top_down", "_W")),
            }
            params["td_lstm"] = {
                "wi": _pick(w, "top_down_lstm_weight_i"),
                "wh": _pick(w, "top_down_lstm_weight_h"),
                # the reference names it '{layer}_top_down_lstm_weight_bias'
                # (model.py:724); the short spelling is accepted too
                "b": _pick_any(w, ("top_down_lstm_weight_bias",), ("top_down_lstm_bias",)),
            }
            params["attn"] = {
                "W_va": _pick(w, "_W_va"), "W_ha": _pick(w, "_W_ha"),
                "W_a": _pick(w, "_W_a", exclude=("_W_va", "_W_ha")),
                "W_x": _pick(w, "_W_x"), "W_h": _pick(w, "_W_h", exclude=("_W_ha",)),
                "W_s": _pick(w, "_W_s"),
            }
        else:
            raise NotImplementedError(f"the port reads adaptiveattention | gridTD checkpoints; "
                                      f"got {model_type!r} (AOA is ROADMAP A11)")
    return params


def load_keras_vgg_h5(path: str, until: str = "block5_conv3") -> dict:
    """VGG16 conv params (numpy) from a Keras HDF5 file: keras.applications
    weight files (``f[name][name + '_W_1:0']``) and reference checkpoints
    (``f['model_weights'][name][...]``) alike."""
    import h5py

    params = {}
    with h5py.File(path, "r") as f:
        root = _root(f)

        def find_layer(name):
            if name in root:
                return root[name]
            for k in root:  # nested (e.g. model_1/block1_conv1)
                g = root[k]
                if isinstance(g, h5py.Group) and name in g:
                    return g[name]
            return None

        for op in vgg_layers(until):
            if op[0] != "conv":
                continue
            name = op[1]
            g = find_layer(name)
            if g is None:
                raise KeyError(f"layer {name} not found in {path}")
            while isinstance(g, h5py.Group) and name in g:  # name/name/kernel:0
                g = g[name]
            found: dict = {}

            def walk(group):
                for k, v in group.items():
                    if isinstance(v, h5py.Group):
                        walk(v)
                        continue
                    # 'kernel:0' / 'bias:0' (checkpoints) or '<layer>_W_1:0' /
                    # '<layer>_b_1:0' (keras.applications): match underscore tokens
                    toks = k.split(":")[0].split("_")
                    if "kernel" in toks or "W" in toks:
                        found["kernel"] = np.asarray(v)
                    elif "bias" in toks or "b" in toks:
                        found["bias"] = np.asarray(v)

            if isinstance(g, h5py.Group):
                walk(g)
            if set(found) != {"kernel", "bias"}:
                raise KeyError(f"kernel/bias not found under layer {name}")
            params[name] = found
    return params


def load_reference_checkpoint_h5(path: str, model_type: str, arch: str = "vgg16",
                                 until: str = "block5_conv3", device="cuda") -> dict:
    """Full captioner params ({'vgg', 'decoder'}) from a reference HDF5, as
    float32 tensors on ``device``."""
    if arch != "vgg16":
        raise NotImplementedError(f"the port reads vgg16 checkpoints; got {arch!r} "
                                  "(the other encoders are ROADMAP A11)")
    tree = {"vgg": load_keras_vgg_h5(path, until),
            "decoder": load_reference_decoder_h5(path, model_type)}
    return params_from_jax(tree, device)


def infer_h5_dims(path: str) -> dict:
    """Model dimensions from a reference checkpoint, so that ``cli parity``
    needs no restated config: vocab_size from the ``output`` Dense bias,
    hidden_dim from its kernel's input side, embedding_dim from the
    embedding table's second axis."""
    import h5py

    with h5py.File(path, "r") as f:
        root = _root(f)
        out = _dense(_layer_weights(root, "output"))
        emb = _pick(_layer_weights(root, "embedding"), "embedding")
    return {
        "vocab_size": int(out["bias"].shape[0]),
        "hidden_dim": int(out["kernel"].shape[0]),
        "embedding_dim": int(emb.shape[1]),
    }
