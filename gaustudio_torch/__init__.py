"""gaustudio_torch — the PyTorch / CUDA port of gaustudio_tpu for NVIDIA Hopper.

The JAX package ``gaustudio_tpu`` is the reference; this package keeps its
module names so each counterpart is easy to find. It imports ``torch`` and
never ``jax``. The forward render path (preprocess -> binning -> tile
compositing) runs through hand-written CUDA kernels on a CUDA device and
through their plain PyTorch versions on the CPU.

Submodules are imported on use: ``from gaustudio_torch import models,
renderers``.
"""

__version__ = "0.1.0"
