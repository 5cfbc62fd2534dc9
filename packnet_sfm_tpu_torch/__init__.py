"""packnet-sfm on PyTorch and CUDA: a port of ``packnet_sfm_tpu``.

The JAX package beside this one is the reference; each module here mirrors
the JAX module of the same path and public names. The port imports torch and
numpy only, never ``jax`` or ``packnet_sfm_tpu``. Public functions keep the
JAX layouts (NHWC images); convolutions run NCHW inside the networks.

Entry points default to ``device="cuda"`` and raise without a CUDA device
unless the caller asks for ``device="cpu"`` (see ``device.resolve_device``).
"""

__version__ = "0.1.0"
