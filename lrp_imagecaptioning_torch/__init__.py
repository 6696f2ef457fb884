"""PyTorch/CUDA port of lrp_imagecaptioning_tpu for one NVIDIA H100.

The JAX package stays the reference; this package imports torch and never
jax, and nothing of the JAX package. Entry points (``pipeline.build``,
``Captioner.init_params``, ``weights.*``) take ``device=`` (keyword-only) and
default to ``"cuda"``; only an explicit ``device="cpu"`` runs the plain CPU
versions. The package's names are the JAX package's (``from
lrp_imagecaptioning_torch import Explainer``), loaded on first use;
docs/API_torch.md says where the two APIs differ.
"""

__version__ = "0.1.0"

import importlib
import sys


def lazy_exports(package: str, exports: dict[str, str]):
    """-> (__getattr__, __dir__) for ``package`` (PEP 562): ``exports`` maps
    each name to the module, relative to the package, that defines it; the
    module is imported on the name's first use, so that importing a package
    imports none of its modules (no model code where only the serving
    loader is wanted, no grpcio, h5py or matplotlib where they are unused)."""
    def __getattr__(name):
        if name not in exports:
            raise AttributeError(f"module {package!r} has no attribute {name!r}")
        value = getattr(importlib.import_module(exports[name], package), name)
        setattr(sys.modules[package], name, value)
        return value

    def __dir__():
        return sorted(set(vars(sys.modules[package])) | set(exports))

    return __getattr__, __dir__


# the JAX package's exports, loaded on first use
_EXPORTS = {
    "build_captioner": ".models.captioner",
    "Captioner": ".models.captioner",
    "Explainer": ".explain.engine",
    "Trainer": ".train.trainer",
    "LRPFinetuner": ".train.lrp_finetune",
    "CaptionService": ".infer.serving",
    "DatasetProvider": ".data.provider",
    "FlickrConfig": ".config",
    "COCOConfig": ".config",
    "COCO2014Config": ".config",
    "make_mesh": ".parallel.mesh",
}

__getattr__, __dir__ = lazy_exports(__name__, _EXPORTS)
