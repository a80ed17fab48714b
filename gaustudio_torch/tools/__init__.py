"""The repo's capture and training tools, on the port (counterparts of the
JAX package's ``tools/``, under the same module names).

Each runs as ``python -m gaustudio_torch.tools.<name>``, on the card unless
``--device cpu`` is given, and writes under ``gaustudio_torch/build/`` by
default:

- ``make_fixture``: the mini_scene golden fixture (textured mesh scene,
  10 views at 128 px, a 250-iteration Gaussian refit, mesh extraction);
- ``train_at_scale``: full 3DGS training with densification, opacity
  resets and the SH warm-up from a sparse init on a procedural capture,
  with held-out PSNR and the JAX runs' quality bars;
- ``make_atscale_capture``: the at-scale captures, cached as ``.npz``;
- ``train_scaffold``: the same kind of run through the ScaffoldTrainer;
- ``demo_e2e``: train, evaluate and extract a mesh of a Gaussian object.

The numpy scene generators are copies of the JAX tools' (held equal to
them by the CPU tests); nothing here imports the JAX package.
"""

import os

BUILD_DIR = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "build")


def build_path(*parts: str) -> str:
    """A path under ``gaustudio_torch/build/``, where the tools write by default."""
    return os.path.join(BUILD_DIR, *parts)
