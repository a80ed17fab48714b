"""Camera model — the torch counterpart of gaustudio_tpu/cameras/__init__.py.

Matrix conventions are the reference's: ``world_view_transform`` and
``full_proj_transform`` are *transposed* (row-vector) matrices built by
getWorld2View2 / getProjectionMatrix, with an OpenGL-style z in [0, 1]
projection and principal-point shift support. The matrices are computed in
float64 numpy, exactly as the JAX package does, and stored as float32 torch
tensors on ``device``: the current CUDA device unless the caller names one.
Cameras are small; a caller may keep them on the CPU (``device="cpu"``), and
the renderer and the trainer move what they read to their own device.

Camera paths, depth2point and depth2normal belong to later slices.
"""

from __future__ import annotations

import dataclasses
import math
import os
from typing import Optional

import numpy as np
import torch

from gaustudio_torch.utils.misc import resolve_device


def getWorld2View2(R, t, translate=np.array([0.0, 0.0, 0.0]), scale=1.0):
    """W2V with recentred / rescaled camera centre (float32 numpy)."""
    Rt = np.zeros((4, 4))
    Rt[:3, :3] = np.asarray(R).transpose()
    Rt[:3, 3] = t
    Rt[3, 3] = 1.0
    C2W = np.linalg.inv(Rt)
    cam_center = C2W[:3, 3]
    cam_center = (cam_center + translate) * scale
    C2W[:3, 3] = cam_center
    Rt = np.linalg.inv(C2W)
    return np.float32(Rt)


def getProjectionMatrix(znear, zfar, fovX, fovY, width=None, height=None,
                        principal_point_ndc=None):
    """OpenGL projection with z in [0, 1] and optional principal-point shift."""
    tanHalfFovY = math.tan(fovY / 2)
    tanHalfFovX = math.tan(fovX / 2)
    top = tanHalfFovY * znear
    bottom = -top
    right = tanHalfFovX * znear
    left = -right

    if principal_point_ndc is not None and width is not None:
        cx = width * principal_point_ndc[0]
        cy = height * principal_point_ndc[1]
        focal_x = width / (2.0 * tanHalfFovX)
        focal_y = height / (2.0 * tanHalfFovY)
        offset_x = (cx - width / 2) / focal_x * znear
        offset_y = (cy - height / 2) / focal_y * znear
        top += offset_y
        bottom += offset_y
        left += offset_x
        right += offset_x

    P = np.zeros((4, 4), np.float32)
    P[0, 0] = 2.0 * znear / (right - left)
    P[1, 1] = 2.0 * znear / (top - bottom)
    P[0, 2] = (right + left) / (right - left)
    P[1, 2] = (top + bottom) / (top - bottom)
    P[3, 2] = 1.0
    P[2, 2] = zfar / (zfar - znear)
    P[2, 3] = -(zfar * znear) / (zfar - znear)
    return P


def focal2fov(focal, pixels):
    return 2 * math.atan(pixels / (2 * focal))


def fov2focal(fov, pixels):
    return pixels / (2 * math.tan(fov / 2))


@dataclasses.dataclass
class Camera:
    """Pinhole camera with the reference's transposed-matrix conventions."""

    R: np.ndarray = None
    T: np.ndarray = None
    FoVx: float = None
    FoVy: float = None
    image_width: int = None
    image_height: int = None
    znear: float = 0.1
    zfar: float = 100.0
    trans: tuple = (0.0, 0.0, 0.0)
    scale: float = 1.0
    principal_point_ndc: tuple = (0.5, 0.5)
    image_path: Optional[str] = None
    image_name: Optional[str] = None
    image: Optional[torch.Tensor] = None  # [H, W, 3] float32 in [0, 1]
    mask: Optional[torch.Tensor] = None  # [H, W] alpha of an RGBA image
    device: Optional[torch.device] = None  # None: the current CUDA device
    world_view_transform: torch.Tensor = None
    projection_matrix: torch.Tensor = None
    full_proj_transform: torch.Tensor = None
    camera_center: torch.Tensor = None

    def __post_init__(self):
        self.device = resolve_device(self.device)
        if self.R is not None and self.world_view_transform is None:
            self._setup()

    def _setup(self):
        self.trans = tuple(np.asarray(self.trans, np.float64).tolist())
        if self.principal_point_ndc is None:
            self.principal_point_ndc = (0.5, 0.5)
        self.principal_point_ndc = tuple(np.asarray(self.principal_point_ndc).tolist())

        if self.image_path is not None and self.image is None:
            self.load_image(self.image_path)

        wv = getWorld2View2(self.R, self.T, np.asarray(self.trans), self.scale).T
        wv = wv.astype(np.float32)
        proj = getProjectionMatrix(
            znear=self.znear, zfar=self.zfar, fovX=self.FoVx, fovY=self.FoVy,
            width=self.image_width, height=self.image_height,
            principal_point_ndc=self.principal_point_ndc,
        ).T.astype(np.float32)
        full = (wv @ proj).astype(np.float32)
        center = np.linalg.inv(wv)[3][:3].astype(np.float32)
        as_t = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(self.device)
        self.world_view_transform = as_t(wv)
        self.projection_matrix = as_t(proj)
        self.full_proj_transform = as_t(full)
        self.camera_center = as_t(center)

    def load_image(self, image_path, bg_color=None):
        """Read a PNG (RGBA is composited over ``bg_color``, default black)."""
        from gaustudio_torch.utils.image import load_image

        img, mask = load_image(str(image_path), bg_color)
        self.image = torch.from_numpy(img).to(self.device)
        self.mask = None if mask is None else torch.from_numpy(mask).to(self.device)
        self.image_path = image_path
        self.image_name = os.path.basename(str(image_path)).split(".")[0]
        self.image_height, self.image_width = img.shape[:2]

    @property
    def tanfovx(self):
        return math.tan(self.FoVx * 0.5)

    @property
    def tanfovy(self):
        return math.tan(self.FoVy * 0.5)

    @property
    def intrinsics(self) -> torch.Tensor:
        focal_x = fov2focal(self.FoVx, self.image_width)
        focal_y = fov2focal(self.FoVy, self.image_height)
        K = np.array(
            [
                [focal_x, 0, self.image_width * self.principal_point_ndc[0]],
                [0, focal_y, self.image_height * self.principal_point_ndc[1]],
                [0, 0, 1],
            ],
            np.float32,
        )
        return torch.from_numpy(K).to(self.device)

    def downsample_scale(self, scale):
        resolution = round(self.image_width / scale), round(self.image_height / scale)
        return self.downsample(resolution)

    def downsample(self, resolution):
        """Resize to ``(w, h)``; images are resampled bilinearly."""
        w, h = resolution
        if self.image is not None:
            img = self.image.permute(2, 0, 1)[None]
            img = torch.nn.functional.interpolate(
                img, size=(h, w), mode="bilinear", antialias=True, align_corners=False)
            self.image = img[0].permute(1, 2, 0).clamp(0.0, 1.0)
        if self.mask is not None:
            m = torch.nn.functional.interpolate(
                self.mask[None, None], size=(h, w), mode="bilinear",
                antialias=True, align_corners=False)
            self.mask = m[0, 0].clamp(0.0, 1.0)
        self.image_width, self.image_height = w, h
        self._setup()
        return self
