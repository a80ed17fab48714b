"""gs-from-mesh: a triangle mesh -> a Gaussian checkpoint
(port of gaustudio_tpu/scripts/mesh2gs.py).

    python -m gaustudio_torch.scripts.mesh2gs -m mesh.ply -o gaussians.ply \
        [-n 1|3|4|6] [--device cuda|cpu]

SuGaR-style placement (the ``mesh`` initializer): n flat Gaussians a
triangle in an SH-degree-1 ``vanilla_pcd`` on ``--device cuda`` (card
``--gpu``) unless ``--device cpu`` is asked for, coloured by the vertex
colours or a uniform 0.5, exported in the Inria PLY layout.
"""

from __future__ import annotations

import argparse

import numpy as np

from gaustudio_torch.scripts.render import _device


def main(argv=None):
    parser = argparse.ArgumentParser()
    parser.add_argument("--mesh", "-m", required=True, help="input mesh (.ply)")
    parser.add_argument("--output_path", "-o", required=True)
    parser.add_argument("--n_per_triangle", "-n", default=3, type=int, choices=[1, 3, 4, 6])
    parser.add_argument("--gpu", default="0", help="index of the card with --device cuda")
    parser.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    args = parser.parse_args(argv)

    from gaustudio_torch import models
    from gaustudio_torch.pipelines import initializers
    from gaustudio_torch.utils.ply import read_ply

    device = _device(args)
    data = read_ply(args.mesh)
    v = data["vertex"]
    vertices = np.stack([v["x"], v["y"], v["z"]], 1).astype(np.float32)
    faces = np.asarray(data["face"]["vertex_indices"], np.int64)
    if "red" in v:
        colors = np.stack([v["red"], v["green"], v["blue"]], 1).astype(np.float32)
        if colors.max() > 1.0:
            colors /= 255.0
    else:
        print("No vertex colors found. Using a uniform color.")
        colors = np.full((len(vertices), 3), 0.5, np.float32)

    gaussians = models.make({"name": "vanilla_pcd", "sh_degree": 1}, device=device)
    init = initializers.make({"name": "mesh", "n_gaussians_per_triangle": args.n_per_triangle})
    init(gaussians, mesh=(vertices, faces, colors))
    gaussians.export(args.output_path)
    print(f"Gaussians exported to {args.output_path}")
    return args.output_path


if __name__ == "__main__":
    main()
