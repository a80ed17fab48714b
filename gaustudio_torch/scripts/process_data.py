"""gs-process-data: run an initializer over a dataset (port of
gaustudio_tpu/scripts/process_data.py, same flags and defaults).

    python -m gaustudio_torch.scripts.process_data -s <capture> -o <workspace> \
        [--dataset nerfstudio|colmap|polycam|scannet|...] \
        [--init colmap|hloc|loftr|dust3r|depth|gaussiansky|...] [--device cuda|cpu]

Runs on ``--device cuda`` (card ``--gpu``) unless ``--device cpu`` is asked
for. What the initializer caches lands in ``-o`` (the ``depth``
initializer's ``fused.ply`` and ``scales.bin``; the SfM initializers'
``images/``, ``model/`` and ``sparse/0``). Returns the initialized model.
"""

from __future__ import annotations

import argparse

from gaustudio_torch.scripts.render import _device


def main(argv=None):
    parser = argparse.ArgumentParser()
    parser.add_argument("--dataset", "-d", default="colmap",
                        help="dataset name (polycam, mvsnet, nerf, scannet, waymo, ...)")
    parser.add_argument("--source_path", "-s", required=True)
    parser.add_argument("--output_dir", "-o", required=True)
    parser.add_argument("--init", default="colmap",
                        help="initializer name (colmap, loftr, dust3r, depth, ...)")
    parser.add_argument("--overwrite", action="store_true")
    parser.add_argument("--w_mask", "-w", action="store_true")
    parser.add_argument("--resolution", "-r", default=1, type=int)
    parser.add_argument("--gpu", default="0", help="index of the card with --device cuda")
    parser.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    args = parser.parse_args(argv)

    from gaustudio_torch import datasets, models
    from gaustudio_torch.pipelines import initializers

    device = _device(args)
    dataset = datasets.make({"name": args.dataset, "source_path": args.source_path,
                             "w_mask": args.w_mask, "camera_number": 1})
    if args.resolution > 1:
        dataset.downsample_scale(args.resolution)
    pcd = models.make("general_pcd", device=device)
    init = initializers.make({"name": args.init, "workspace_dir": args.output_dir},
                             device=device)
    return init(pcd, dataset, overwrite=args.overwrite)


if __name__ == "__main__":
    main()
