"""COLMAP dataset (port of gaustudio_tpu/datasets/colmap.py).

Reads a COLMAP model (``sparse/0`` or ``sparse``; binary, else text) with
PINHOLE, SIMPLE_PINHOLE or OPENCV cameras (OPENCV's distortion is dropped
with a warning), the images, and per image an optional mask
(``masks/<stem>.png|jpg``) and 16-bit depth PNG in millimetres
(``depths/<name without its 4-character extension>.png``). Images decode
through the port's utils/image.py where the JAX package uses OpenCV: the
colour image with its alpha dropped, the mask as grey. The cameras, with
their pixels, stay on the host (``device="cpu"``): the trainer and the
renderer move what they read.
"""

from __future__ import annotations

import os
import warnings
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path
from typing import Dict

import numpy as np
import torch

from gaustudio_torch import datasets
from gaustudio_torch.cameras import Camera, focal2fov
from gaustudio_torch.datasets.base import CameraDataset
from gaustudio_torch.datasets.utils import (
    qvec2rotmat,
    read_extrinsics_binary,
    read_extrinsics_text,
    read_intrinsics_binary,
    read_intrinsics_text,
)
from gaustudio_torch.utils.image import load_grey8, load_rgb8, load_samples, resize_linear_u8


def _tensor(a):
    return None if a is None else torch.from_numpy(np.ascontiguousarray(a))


@datasets.register("colmap")
class ColmapDataset(CameraDataset):
    def __init__(self, config: Dict):
        if "source_path" not in config:
            raise ValueError("Config must contain 'source_path' key")
        self.path = Path(config["source_path"])
        self.white_background = config.get("white_background", False)
        self.images_dir = self.path / config.get("images", "images")
        self.sparse_dir = self.path / config.get("sparse", "sparse")
        self.depths_dir = self.path / config.get("depths", "depths")
        self.resolution = config.get("resolution", 1)
        if config.get("masks") is not None:
            self.masks_dir = self.path / config["masks"]
            self.w_mask = True
        else:
            self.masks_dir = None
            self.w_mask = config.get("w_mask", False)
        self.eval = config.get("eval", False)
        self._initialize()

    def _initialize(self):
        scene_dir = os.path.join(self.path, "sparse", "0")
        if not os.path.exists(scene_dir):
            scene_dir = os.path.join(self.path, self.sparse_dir)
        try:
            cam_extrinsics = read_extrinsics_binary(os.path.join(scene_dir, "images.bin"))
            cam_intrinsics = read_intrinsics_binary(os.path.join(scene_dir, "cameras.bin"))
        except OSError:
            cam_extrinsics = read_extrinsics_text(os.path.join(scene_dir, "images.txt"))
            cam_intrinsics = read_intrinsics_text(os.path.join(scene_dir, "cameras.txt"))

        def process_camera(key):
            extr = cam_extrinsics[key]
            intr = cam_intrinsics[extr.camera_id]
            height, width = intr.height, intr.width
            R = np.transpose(qvec2rotmat(extr.qvec))
            T = np.array(extr.tvec)
            if intr.model == "SIMPLE_PINHOLE":
                fx = fy = intr.params[0]
                cx, cy = intr.params[1], intr.params[2]
            elif intr.model in ("PINHOLE", "OPENCV"):
                if intr.model == "OPENCV":
                    warnings.warn(
                        "OpenCV camera model detected; distortion parameters "
                        "are discarded — undistort your images first.", UserWarning)
                fx, fy = intr.params[0], intr.params[1]
                cx, cy = intr.params[2], intr.params[3]
            else:
                raise AssertionError(
                    "Colmap camera model not handled: only undistorted datasets "
                    "(PINHOLE or SIMPLE_PINHOLE cameras) supported!")
            FoVx = focal2fov(fx, width)
            FoVy = focal2fov(fy, height)

            name = os.path.basename(extr.name)
            image_path = self.images_dir / name
            if not image_path.exists():
                return None
            rgb = load_rgb8(str(image_path))
            height, width = rgb.shape[:2]

            depth = None
            depth_path = self.depths_dir / (name[:-4] + ".png")
            if depth_path.exists():
                depth = load_samples(str(depth_path)).astype(np.float32) / 1000.0

            mask = bg_image = None
            if self.w_mask and self.masks_dir is not None:
                stem = name.split(".")[0]
                for ext in (".png", ".jpg"):
                    mp = self.masks_dir / (stem + ext)
                    if mp.exists():
                        m = np.where(load_grey8(str(mp)) > 1, 255, 0).astype(np.uint8)
                        if m.shape != (height, width):
                            m = resize_linear_u8(m, width, height)
                        mask = m.astype(np.float32) / 255.0
                        # the image where the mask is not full, else black
                        bg_image = np.where((m < 255)[..., None], rgb, 0).astype(np.float32) / 255.0
                        break
            if mask is None:
                mask = np.ones((height, width), np.float32)
                bg_image = np.full((height, width, 3), 1.0 if self.white_background else 0.0,
                                   np.float32)

            cam = Camera(
                R=R, T=T, FoVx=FoVx, FoVy=FoVy, image_name=name,
                image_width=width, image_height=height,
                principal_point_ndc=(cx / width, cy / height),
                image=_tensor(rgb.astype(np.float32) / 255.0), bg_image=_tensor(bg_image),
                mask=_tensor(mask), depth=_tensor(depth), device="cpu")
            if self.resolution > 1:
                cam.downsample_scale(self.resolution)
            return cam

        with ThreadPoolExecutor(max_workers=os.cpu_count()) as ex:
            cams = [c for c in ex.map(process_camera, cam_extrinsics) if c is not None]
        self.all_cameras = cams
        self.finalize()
