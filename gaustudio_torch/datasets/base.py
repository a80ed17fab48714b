"""Dataset base class: a sequence of Cameras + scene normalisation
(port of gaustudio_tpu/datasets/base.py)."""

from __future__ import annotations

import json
from typing import List

from gaustudio_torch.cameras import Camera
from gaustudio_torch.datasets.utils import camera_to_JSON, getNerfppNorm


class CameraDataset:
    all_cameras: List[Camera]

    def __len__(self):
        return len(self.all_cameras)

    def __getitem__(self, index):
        return self.all_cameras[index]

    def __iter__(self):
        return iter(self.all_cameras)

    def finalize(self):
        """Sort by image name and compute the nerf++ normalisation."""
        self.all_cameras = sorted(self.all_cameras, key=lambda x: x.image_name or "")
        self.nerf_normalization = getNerfppNorm(self.all_cameras)
        self.cameras_extent = self.nerf_normalization["radius"]
        self.cameras_center = self.nerf_normalization["translate"]
        self.cameras_min_extent = self.nerf_normalization["min_radius"]

    def downsample_scale(self, resolution_scale):
        self.all_cameras = [c.downsample_scale(resolution_scale) for c in self.all_cameras]
        return self

    def export(self, save_path):
        """Write cameras.json."""
        json_cams = [camera_to_JSON(i, cam) for i, cam in enumerate(self.all_cameras)]
        with open(save_path, "w") as f:
            json.dump(json_cams, f)
