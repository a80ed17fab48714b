"""MipPointCloud — Mip-Splatting's vanilla model with its 3D smoothing filter
(port of gaustudio_tpu/models/mip.py).

Each point gets a 3D low-pass filter scale from its smallest depth over the
training cameras that see it, divided by the largest focal length; the
renderer reads the filtered scaling and opacity.
"""

from __future__ import annotations

import torch

from gaustudio_torch import models
from gaustudio_torch.models.vanilla import VanillaPointCloud


@models.register("mip_pcd")
class MipPointCloud(VanillaPointCloud):
    def __init__(self, config=None, device=None) -> None:
        super().__init__(config, device)
        self.filter_3D = None

    @property
    def get_scaling_with_3D_filter(self) -> torch.Tensor:
        """sqrt(s^2 + f^2)."""
        scales = self.get_attribute("scale")
        return torch.sqrt(torch.square(scales) + torch.square(self.filter_3D))

    @property
    def get_opacity_with_3D_filter(self) -> torch.Tensor:
        """opacity * sqrt(det(s^2) / det(s^2 + f^2))."""
        opacity = self.get_attribute("opacity")
        s2 = torch.square(self.get_attribute("scale"))
        det1 = s2[:, 0] * s2[:, 1] * s2[:, 2]
        s2f = s2 + torch.square(self.filter_3D)
        det2 = s2f[:, 0] * s2f[:, 1] * s2f[:, 2]
        return opacity * torch.sqrt(det1 / det2)[..., None]

    @torch.no_grad()
    def compute_3D_filter(self, cameras) -> torch.Tensor:
        """[N, 1] filter scales: each point's least depth over the cameras
        that see it (depth > 0.2, inside the image widened by 15 % a side),
        points no camera sees at the largest such depth, over the largest
        focal length, times sqrt(0.2)."""
        xyz = self._xyz
        distance = torch.full((xyz.shape[0],), 100000.0, device=self.device)
        valid_points = torch.zeros(xyz.shape[0], dtype=torch.bool, device=self.device)
        focal_length = 0.0
        for camera in cameras:
            # R is stored transposed: the camera-space point is xyz @ R + T
            R = torch.as_tensor(camera.R, dtype=torch.float32, device=self.device)
            T = torch.as_tensor(camera.T, dtype=torch.float32, device=self.device)
            xyz_cam = torch.stack([xyz[:, 0] * R[0, i] + xyz[:, 1] * R[1, i]
                                   + xyz[:, 2] * R[2, i] for i in range(3)], -1) + T[None, :]
            valid_depth = xyz_cam[:, 2] > 0.2
            z = torch.clamp_min(xyz_cam[:, 2], 0.001)
            K = camera.intrinsics
            fx, fy = float(K[0, 0]), float(K[1, 1])
            W, H = camera.image_width, camera.image_height
            x = xyz_cam[:, 0] / z * fx + W / 2.0
            y = xyz_cam[:, 1] / z * fy + H / 2.0
            in_screen = (x >= -0.15 * W) & (x <= 1.15 * W) & (y >= -0.15 * H) & (y <= 1.15 * H)
            valid = valid_depth & in_screen
            distance = torch.where(valid, torch.minimum(distance, z), distance)
            valid_points |= valid
            focal_length = max(focal_length, fx)
        if valid_points.any():
            distance = torch.where(valid_points, distance, distance[valid_points].max())
        self.filter_3D = (distance / focal_length * (0.2 ** 0.5))[..., None]
        return self.filter_3D
