"""PyTorch/CUDA port of lrp_imagecaptioning_tpu for one NVIDIA H100.

The JAX package stays the reference; this package imports torch and never
jax, and nothing of the JAX package. Entry points (``pipeline.build``,
``Captioner.init_params``, ``weights.*``) take ``device=`` and default to
``"cuda"``; only an explicit ``device="cpu"`` runs the plain CPU versions.
"""

__version__ = "0.1.0"
