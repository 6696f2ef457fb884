"""Import reference Keras HDF5 checkpoints (the ``save_weights`` format of
the reference's train.py:79-88) into the port's params tree.

The port's own copy of the JAX package's ``models/weights_io.py`` readers
for every encoder and decoder. Keras layer/weight naming (model.py):

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
* AOA (the JAX package's own layout; the reference's model is dead code):
  ``feature_layer_norm`` gamma/beta and the wrapper ``aoa_decoder_*``: the
  LSTM's kernel/recurrent_kernel/bias, ``_{k,v,q}_proj_kernel/_bias``,
  ``_glu_{Wpq,Wph,bp,Wgq,Wgh,bg}``, and the refinement blocks
  ``multi_head_encoder_{i}``; it has no ``global_img_feature``;
* VGG16 / VGG19 conv layers under their keras.applications block names,
  ResNet's ``res*`` / ``bn*`` layers and InceptionV3's numbered
  ``conv2d_N`` / ``batch_normalization_N`` (``models/resnet.py``,
  ``models/inception.py``).

Keras's LSTM gate order [i, f, c(g), o] is the port's, and conv kernels are
HWIO on both sides: nothing is permuted. ``save_reference_checkpoint_h5``
writes that layout from a params tree. h5py is imported inside the reader
and the writer only.
"""

from __future__ import annotations

import numpy as np
import torch

from ..weights import params_from_jax
from .inception import CONV_ORDER, load_keras_inception_v3_h5
from .resnet import conv_names, load_keras_resnet50_h5
from .vgg import load_keras_vgg_h5, vgg_layers


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
            "output": _dense(_layer_weights(root, "output")),
        }
        if model_type != "aoa":   # AOA has no global image feature head
            params["global_img_feature"] = _dense(_layer_weights(root, "global_img_feature"))
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
        elif model_type == "aoa":
            w = _layer_weights(root, "aoa_decoder")
            fl = _layer_weights(root, "feature_layer_norm")
            params["feat_ln"] = {"scale": _pick(fl, "gamma"), "bias": _pick(fl, "beta")}
            params["lstm"] = {"wi": _pick(w, "kernel", exclude=("recurrent", "_proj")),
                              "wh": _pick(w, "recurrent_kernel"),
                              "b": _pick(w, "bias", exclude=("_proj", "_glu"))}
            for proj in ("k_proj", "v_proj", "q_proj"):
                params[proj] = {"kernel": _pick(w, f"_{proj}_kernel"),
                                "bias": _pick(w, f"_{proj}_bias")}
            params["glu"] = _glu(w)
            params["refine"] = []
            while any(f"multi_head_encoder_{len(params['refine'])}" in ln for ln in root):
                rw = _layer_weights(root, f"multi_head_encoder_{len(params['refine'])}")
                params["refine"].append({
                    **{k: {"kernel": _pick(rw, f"{k}_kernel"), "bias": _pick(rw, f"{k}_bias")}
                       for k in ("q", "k", "v")},
                    "glu": _glu(rw),
                    "ln": {"scale": _pick(rw, "ln_gamma"), "bias": _pick(rw, "ln_beta")}})
        else:
            raise ValueError(f"unknown model_type {model_type!r}")
    return params


def _glu(weights: dict) -> dict:
    return {k: _pick(weights, f"glu_{k}:") for k in ("Wpq", "Wph", "bp", "Wgq", "Wgh", "bg")}


# Keras-layout HDF5 export (the inverse of the importers above), the JAX
# package's writer.

_ADAPTIVE_WRAPPER = "external_attention_rnn_wrapper_local_attention_v3_1"
_GRIDTD_WRAPPER = "external_bottom_up_attention_adaptive_1"
_AOA_WRAPPER = "aoa_decoder_1"  # reference AOA is dead code; naming is ours


def _numpy(a) -> np.ndarray:
    return a.detach().cpu().numpy() if isinstance(a, torch.Tensor) else np.asarray(a)


def _decoder_layer_list(decoder: dict, model_type: str):
    """[(layer_name, [(weight_name, array), ...]), ...] in Keras naming.

    Names reproduce the reference model's Keras weight names exactly for
    adaptiveattention / gridTD (model.py:555-571 / 702-743, Dense layers
    model.py:446-466, default Embedding 'embedding_1'); the AOA layout is this
    framework's own (the reference AOA model is commented out, model.py:
    828-1250) but follows the same conventions.
    """
    d = decoder
    layers = [
        ("embedding_1", [("embedding_1/embeddings:0", d["embedding"])]),
        ("image_features", [("image_features/kernel:0", d["image_features"]["kernel"]),
                            ("image_features/bias:0", d["image_features"]["bias"])]),
    ]
    if "global_img_feature" in d:
        layers.append(("global_img_feature",
                       [("global_img_feature/kernel:0", d["global_img_feature"]["kernel"]),
                        ("global_img_feature/bias:0", d["global_img_feature"]["bias"])]))
    if model_type == "adaptiveattention":
        W = _ADAPTIVE_WRAPPER
        a = d["attn"]
        layers.append((W, [
            ("lstm_1/kernel:0", d["lstm"]["wi"]),
            ("lstm_1/recurrent_kernel:0", d["lstm"]["wh"]),
            ("lstm_1/bias:0", d["lstm"]["b"]),
            (f"{W}_Wv:0", a["Wv"]), (f"{W}_Wg:0", a["Wg"]), (f"{W}_Wx:0", a["Wx"]),
            (f"{W}_Wh:0", a["Wh"]), (f"{W}_Ws:0", a["Ws"]), (f"{W}_V:0", a["V"]),
        ]))
    elif model_type == "gridTD":
        W = _GRIDTD_WRAPPER
        a = d["attn"]
        layers.append((W, [
            ("lstm_1/kernel:0", d["lang_lstm"]["wi"]),
            ("lstm_1/recurrent_kernel:0", d["lang_lstm"]["wh"]),
            ("lstm_1/bias:0", d["lang_lstm"]["b"]),
            (f"{W}_top_down_lstm_weight_i:0", d["td_lstm"]["wi"]),
            (f"{W}_top_down_lstm_weight_h:0", d["td_lstm"]["wh"]),
            (f"{W}_top_down_lstm_weight_bias:0", d["td_lstm"]["b"]),
            (f"{W}_W_va:0", a["W_va"]), (f"{W}_W_ha:0", a["W_ha"]),
            (f"{W}_W_a:0", a["W_a"]), (f"{W}_W_x:0", a["W_x"]),
            (f"{W}_W_h:0", a["W_h"]), (f"{W}_W_s:0", a["W_s"]),
        ]))
    elif model_type == "aoa":
        W = _AOA_WRAPPER
        g = d["glu"]
        layers.append(("feature_layer_norm",
                       [("feature_layer_norm/gamma:0", d["feat_ln"]["scale"]),
                        ("feature_layer_norm/beta:0", d["feat_ln"]["bias"])]))
        layers.append((W, [
            ("lstm_1/kernel:0", d["lstm"]["wi"]),
            ("lstm_1/recurrent_kernel:0", d["lstm"]["wh"]),
            ("lstm_1/bias:0", d["lstm"]["b"]),
            *((f"{W}_{p}_proj_{leaf}:0", d[f"{p}_proj"][leaf]) for p in ("k", "v", "q")
              for leaf in ("kernel", "bias")),
            (f"{W}_glu_Wpq:0", g["Wpq"]), (f"{W}_glu_Wph:0", g["Wph"]), (f"{W}_glu_bp:0", g["bp"]),
            (f"{W}_glu_Wgq:0", g["Wgq"]), (f"{W}_glu_Wgh:0", g["Wgh"]), (f"{W}_glu_bg:0", g["bg"]),
        ]))
        for i, blk in enumerate(d.get("refine", [])):
            name = f"multi_head_encoder_{i}"
            bg = blk["glu"]
            layers.append((name, [
                (f"{name}/q_kernel:0", blk["q"]["kernel"]), (f"{name}/q_bias:0", blk["q"]["bias"]),
                (f"{name}/k_kernel:0", blk["k"]["kernel"]), (f"{name}/k_bias:0", blk["k"]["bias"]),
                (f"{name}/v_kernel:0", blk["v"]["kernel"]), (f"{name}/v_bias:0", blk["v"]["bias"]),
                (f"{name}/glu_Wpq:0", bg["Wpq"]), (f"{name}/glu_Wph:0", bg["Wph"]),
                (f"{name}/glu_bp:0", bg["bp"]), (f"{name}/glu_Wgq:0", bg["Wgq"]),
                (f"{name}/glu_Wgh:0", bg["Wgh"]), (f"{name}/glu_bg:0", bg["bg"]),
                (f"{name}/ln_gamma:0", blk["ln"]["scale"]),
                (f"{name}/ln_beta:0", blk["ln"]["bias"]),
            ]))
    else:
        raise ValueError(f"unknown model_type {model_type!r}")
    layers.append(("output", [("output/kernel:0", d["output"]["kernel"]),
                              ("output/bias:0", d["output"]["bias"])]))
    return layers


def _encoder_layer_list(enc: dict, arch: str, until: str):
    """[(layer_name, [(weight_name, array), ...]), ...] for the encoder, in
    the Keras naming each importer reads back:

    * vgg16/19 — keras.applications block names, ``kernel:0``/``bias:0``
      (vgg.py::load_keras_vgg_h5)
    * resnet50/101 — ``res{S}{b}_branch*`` conv layers (kernel only — the
      importer ignores conv bias; the apply has none) + ``bn*`` BatchNorm
      layers with gamma/beta/moving_mean/moving_variance
      (resnet.py::load_keras_resnet50_h5)
    * inception_v3 — creation-order-numbered ``conv2d_N`` /
      ``batch_normalization_N`` (inception.py::load_keras_inception_v3_h5)
    """
    if arch.startswith("vgg"):
        layers = []
        for op in vgg_layers(arch, until):
            if op[0] != "conv":
                continue
            name = op[1]
            p = enc[name]
            layers.append((name, [(f"{name}/kernel:0", p["kernel"]),
                                  (f"{name}/bias:0", p["bias"])]))
        return layers
    if arch in ("resnet50", "resnet101"):
        layers = []
        for conv_name, bn_name, _, _ in conv_names(arch):
            layers.append((conv_name,
                           [(f"{conv_name}/kernel:0", enc[conv_name]["kernel"])]))
            bp = enc[bn_name]
            layers.append((bn_name, [
                (f"{bn_name}/gamma:0", bp["gamma"]),
                (f"{bn_name}/beta:0", bp["beta"]),
                (f"{bn_name}/moving_mean:0", bp["moving_mean"]),
                (f"{bn_name}/moving_variance:0", bp["moving_var"]),
            ]))
        return layers
    if arch == "inception_v3":
        layers = []
        for idx, name in enumerate(CONV_ORDER, start=1):
            p = enc[name]
            layers.append((f"conv2d_{idx}",
                           [(f"conv2d_{idx}/kernel:0", p["kernel"])]))
            bn = f"batch_normalization_{idx}"
            layers.append((bn, [
                (f"{bn}/gamma:0", p["bn_gamma"]),
                (f"{bn}/beta:0", p["bn_beta"]),
                (f"{bn}/moving_mean:0", p["bn_mean"]),
                (f"{bn}/moving_variance:0", p["bn_var"]),
            ]))
        return layers
    raise ValueError(f"unknown encoder arch {arch!r}")


def save_reference_checkpoint_h5(path: str, params: dict, model_type: str,
                                 arch: str = "vgg16", until: str = "block5_conv3") -> None:
    """Write a Keras-2.2.4 ``save_weights`` HDF5 (the reference checkpoint
    format, train.py:79-88) from a captioner params pytree.

    Layout matches keras/engine/saving.py::save_weights_to_hdf5_group: root
    attrs ``layer_names`` / ``backend`` / ``keras_version``, one group per
    layer with a ``weight_names`` attr, datasets at ``<weight name>:0`` paths.
    A Keras-2.2.4 environment, the JAX package's importers or this one's can
    load the result; tensors are written as their numpy arrays.
    """
    import h5py

    layers = []
    if "vgg" in params:
        layers += _encoder_layer_list(params["vgg"], arch, until)
    layers += _decoder_layer_list(params["decoder"], model_type)

    with h5py.File(path, "w") as f:
        f.attrs["layer_names"] = np.array([n.encode("utf8") for n, _ in layers])
        f.attrs["backend"] = b"tensorflow"
        f.attrs["keras_version"] = b"2.2.4"
        for name, weights in layers:
            g = f.create_group(name)
            g.attrs["weight_names"] = np.array([wn.encode("utf8") for wn, _ in weights])
            for wn, arr in weights:
                g.create_dataset(wn, data=_numpy(arr))


def load_reference_checkpoint_h5(path: str, model_type: str, arch: str = "vgg16",
                                 until: str = "block5_conv3", *, device="cuda") -> dict:
    """Full captioner params ({'vgg', 'decoder'}) from a reference HDF5, as
    float32 tensors on ``device``; ``arch`` is the encoder (``until`` its
    tap, read by VGG only)."""
    if arch in ("resnet50", "resnet101"):
        enc = load_keras_resnet50_h5(path, arch)
    elif arch == "inception_v3":
        enc = load_keras_inception_v3_h5(path)
    else:
        enc = load_keras_vgg_h5(path, arch, until)
    tree = {"vgg": enc, "decoder": load_reference_decoder_h5(path, model_type)}
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
