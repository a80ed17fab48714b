"""NeRF-synthetic (Blender transforms_*.json) dataset
(port of gaustudio_tpu/datasets/nerf.py).

Keeps the OpenGL -> COLMAP axis flip ``c2w[:, 1:3] *= -1`` and composites
RGBA images over the training background (white with
``white_background``, else black).
"""

from __future__ import annotations

import json
import math
from pathlib import Path
from typing import Dict

import numpy as np

from gaustudio_torch import datasets
from gaustudio_torch.cameras import Camera, focal2fov
from gaustudio_torch.datasets.base import CameraDataset


@datasets.register("nerf")
class NerfDataset(CameraDataset):
    def __init__(self, config: Dict):
        self.source_path = Path(config["source_path"])
        self.split = config.get("split", "train")
        self.load_images = config.get("load_images", True)
        self.white_background = config.get("white_background", False)
        self.ply_path = None
        with open(self.source_path / f"transforms_{self.split}.json") as f:
            meta = json.load(f)
        if "w" in meta and "h" in meta:
            width, height = int(meta["w"]), int(meta["h"])
        else:
            width, height = 800, 800
        focal = 0.5 * width / math.tan(0.5 * meta["camera_angle_x"])
        FoVy = focal2fov(focal, height)
        FoVx = focal2fov(focal, width)

        cams = []
        for frame in meta["frames"]:
            image_name = f"{frame['file_path']}.png"
            image_path = self.source_path / image_name
            c2w = np.array(frame["transform_matrix"])
            c2w[:, 1:3] *= -1
            extr = np.linalg.inv(c2w)
            cam = Camera(R=np.transpose(extr[:3, :3]), T=extr[:3, 3], FoVx=FoVx, FoVy=FoVy,
                         image_name=image_name, image_width=width, image_height=height,
                         device="cpu")  # host tensors: the trainer moves each view
            if self.load_images and image_path.exists():
                bg = np.ones(3, np.float32) if self.white_background else None
                cam.load_image(str(image_path), bg_color=bg)
                cam._setup()
            cams.append(cam)
        self.all_cameras = cams
        self.finalize()
