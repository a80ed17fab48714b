"""gs-render: render a trained model from the cameras of a cameras.json or a
COLMAP scene.

Port of gaustudio_tpu/scripts/render.py. Run as
``python -m gaustudio_torch.scripts.render -m <model> [-s <cameras.json |
COLMAP dir>] [--config vanilla|2dgs|mip|gsplat|pcd|scaffold]``: the config
names the model and the renderer (2DGS surfels, Mip-Splatting, gsplat's
antialiased mode, a plain RGB point cloud, Scaffold-GS anchors).
Renders on ``--device cuda`` (card ``--gpu``) unless ``--device cpu`` is
asked for. Writes one PNG per camera to ``<output>/images`` on background
threads, and ``<output>/render.mp4`` through imageio where it has a video
backend. ``--flythrough`` first validates, keyframes, smooths and resamples
the camera path (cameras/camera_paths.py, in the JAX package's order); its
frames are named by their 8-digit index.
"""

from __future__ import annotations

import argparse
import json
import os

import torch


def _device(args) -> torch.device:
    if args.device == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError('--device cuda: no CUDA device is available (use --device cpu; '
                               'device="cpu" in Python)')
        device = torch.device(f"cuda:{int(args.gpu)}")
        torch.cuda.set_device(device)  # the kernels launch on the current device
        return device
    return torch.device(args.device)


def frame_pixels(out: dict) -> torch.Tensor:
    """The frame gs-render writes of a render: its colour where the final
    opacity is at least 0.5, black elsewhere, quantised as save_image
    quantises (x 255, clipped, truncated) on the render's device: uint8
    [H, W, 3]."""
    rgb = out["render"].permute(1, 2, 0)
    rgb = torch.where(out["rendered_final_opacity"][0][..., None] >= 0.5, rgb, 0.0)
    return torch.clamp(rgb * 255.0, 0, 255).to(torch.uint8)


def main(argv=None):
    parser = argparse.ArgumentParser()
    parser.add_argument("--config", default="vanilla")
    parser.add_argument("--gpu", default="0", help="index of the card with --device cuda")
    parser.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    parser.add_argument("--model", "-m", default=None, help="path to the model")
    parser.add_argument("--source_path", "-s", default=None)
    parser.add_argument("--output-dir", "-o", default=None)
    parser.add_argument("--load_iteration", default=-1, type=int)
    parser.add_argument("--resolution", default=1, type=int)
    parser.add_argument("--sh", default=0, type=int)
    parser.add_argument("--white_background", action="store_true")
    parser.add_argument("--flythrough", action="store_true",
                        help="smooth/resample the camera path before rendering")
    parser.add_argument("--fps", default=30, type=int)
    args, extras = parser.parse_known_args(argv)

    from gaustudio_torch import datasets, models, renderers
    from gaustudio_torch.config import builtin_config_path, load_config
    from gaustudio_torch.datasets.utils import JSON_to_camera
    from gaustudio_torch.utils.image import BackgroundWriter, write_png
    from gaustudio_torch.utils.misc import searchForMaxIteration

    device = _device(args)
    config_path = args.config if os.path.exists(args.config) else builtin_config_path(args.config)
    config = load_config(config_path, cli_args=extras)
    if args.white_background:
        config["renderer"]["white_background"] = True

    pcd = models.make(config["model"]["pointcloud"], device=device)
    renderer = renderers.make(config["renderer"], device=device)
    pcd.active_sh_degree = args.sh

    model_path = args.model
    if model_path is None:
        raise ValueError("--model/-m is required")
    if os.path.isdir(model_path):
        loaded_iter = (searchForMaxIteration(os.path.join(model_path, "point_cloud"))
                       if args.load_iteration == -1 else args.load_iteration)
        work_dir = args.output_dir or os.path.join(
            model_path, "renders", f"iteration_{loaded_iter}")
        pcd.load(os.path.join(model_path, "point_cloud", f"iteration_{loaded_iter}",
                              "point_cloud.ply"))
    else:
        work_dir = args.output_dir or os.path.join(
            os.path.dirname(model_path), os.path.basename(model_path)[:-4])
        pcd.load(model_path)

    if args.source_path is None:
        args.source_path = os.path.join(
            model_path if os.path.isdir(model_path) else os.path.dirname(model_path),
            "cameras.json")
    if args.source_path.endswith(".json"):
        with open(args.source_path) as f:
            cameras = [JSON_to_camera(cj, device=device) for cj in json.load(f)]
    else:
        cameras = datasets.make({"name": "colmap", "source_path": args.source_path}).all_cameras

    if args.flythrough:
        from gaustudio_torch.cameras.camera_paths import (
            downsample_cameras, smoothen_cameras, upsample_cameras_velocity, validate_paths)

        cameras = validate_paths(cameras)
        cameras = downsample_cameras(cameras)
        cameras = smoothen_cameras(cameras)
        cameras = upsample_cameras_velocity(cameras)

    try:  # the frames are kept for the video only where imageio imports
        import imageio.v2 as imageio
        video_error = None
    except ImportError as e:
        video_error = e
    render_path = os.path.join(work_dir, "images")
    os.makedirs(render_path, exist_ok=True)
    frames = []
    with BackgroundWriter() as writer:
        for i, camera in enumerate(cameras):
            if args.resolution > 1:
                camera = camera.downsample_scale(args.resolution)
            frame = frame_pixels(renderer.render(camera, pcd)).cpu().numpy()
            name = camera.image_name or f"frame_{i:05d}"
            if name.lower().endswith((".png", ".jpg", ".jpeg")):
                name = os.path.splitext(name)[0]
            writer.submit(write_png, os.path.join(render_path, f"{name}.png"), frame)
            if video_error is None:
                frames.append(frame)

    if video_error is None:
        try:
            imageio.mimwrite(os.path.join(work_dir, "render.mp4"), frames, fps=args.fps)
        except Exception as e:  # imageio raises whatever its missing backend raises
            video_error = e
    if video_error is not None:
        print(f"Skipping video export: {video_error}")
    print(f"Rendered {len(cameras)} views to {render_path}")
    return render_path


if __name__ == "__main__":
    main()
