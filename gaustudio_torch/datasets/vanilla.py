"""Vanilla dataset: a 3DGS ``cameras.json`` + ``images/``
(port of gaustudio_tpu/datasets/vanilla.py)."""

from __future__ import annotations

import json
from pathlib import Path
from typing import Dict

from gaustudio_torch import datasets
from gaustudio_torch.datasets.base import CameraDataset
from gaustudio_torch.datasets.utils import JSON_to_camera


@datasets.register("vanilla")
class VanillaDataset(CameraDataset):
    def __init__(self, config: Dict):
        self.source_path = Path(config["source_path"])
        self.image_path = self.source_path / "images"
        self.load_images = config.get("load_images", True)
        self.ply_path = None
        with open(self.source_path / "cameras.json") as f:
            camera_data = json.load(f)
        all_cameras = []
        for cam_dict in camera_data:
            # host tensors: the trainer moves each view to its own device
            cam = JSON_to_camera(cam_dict, device="cpu")
            img = self.image_path / cam_dict["img_name"]
            if self.load_images and img.exists():
                cam.load_image(str(img))
                cam._setup()
            all_cameras.append(cam)
        self.all_cameras = all_cameras
        self.finalize()
