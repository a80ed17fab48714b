"""Build (and cache) an at-scale multi-view capture on the port
(counterpart of the JAX package's ``tools/make_atscale_capture.py``).

Renders the procedural mesh of ``train_at_scale`` from its orbit rings
(per-pixel texture for ``--rich`` and ``--bench``) and stores the images as
``.npz`` under ``gaustudio_torch/build/``, where ``train_at_scale`` looks for
them before rendering its own.

    python -m gaustudio_torch.tools.make_atscale_capture [--size 512]
        [--views 64] [--rich | --bench] [--device cpu]
"""

from __future__ import annotations

import argparse
import os
import time

import numpy as np
import torch

from gaustudio_torch.tools import build_path
from gaustudio_torch.utils.misc import resolve_device

TAGS = {"large": "", "rich": "_rich", "bench": "_bench2"}  # bench2: the 67-freq octave


def cache_path(size, views, rich=False, kind=None) -> str:
    kind = kind or ("rich" if rich else "large")
    return build_path(f"atscale_capture_{size}_{views}{TAGS[kind]}.npz")


def load_capture(size, views, rich=False, kind=None, device=None):
    """The orbit cameras of a cached capture with their images set (on
    ``device``), or None where the cache does not exist."""
    from gaustudio_torch.tools.make_fixture import set_images
    from gaustudio_torch.tools.train_at_scale import ORBITS, orbit_rings

    kind = kind or ("rich" if rich else "large")
    path = cache_path(size, views, kind=kind)
    if not os.path.exists(path):
        return None
    device = resolve_device(device)
    with np.load(path) as data:
        cams = orbit_rings(size, views, device=device, **ORBITS[kind])
        set_images(cams, [data[f"img{i}"] for i in range(len(cams))])
    return cams


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--size", type=int, default=512)
    ap.add_argument("--views", type=int, default=64)
    ap.add_argument("--rich", action="store_true")
    ap.add_argument("--bench", action="store_true")
    ap.add_argument("--device", default=None, choices=["cuda", "cpu"],
                    help="default: the current CUDA device")
    args = ap.parse_args(argv)
    kind = "bench" if args.bench else ("rich" if args.rich else "large")

    from gaustudio_torch.tools.train_at_scale import COLORS, MESHES, ORBITS, orbit_rings, render_gt

    device = resolve_device(args.device)
    t0 = time.perf_counter()
    verts, faces = MESHES[kind]()
    cams = orbit_rings(args.size, args.views, device=device, **ORBITS[kind])
    images = render_gt(verts, faces, cams, col_fn=COLORS[kind], per_pixel=kind != "large",
                       device=device)
    path = cache_path(args.size, args.views, kind=kind)
    os.makedirs(os.path.dirname(path), exist_ok=True)
    np.savez(path, size=args.size, views=args.views,
             **{f"img{i}": im.cpu().numpy() for i, im in enumerate(images)})
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    print(f"capture: {len(cams)} views {args.size}px -> {path} "
          f"({time.perf_counter() - t0:.1f}s)", flush=True)


if __name__ == "__main__":
    main()
