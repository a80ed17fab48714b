"""Camera model — the torch counterpart of gaustudio_tpu/cameras/__init__.py.

Matrix conventions are the reference's: ``world_view_transform`` and
``full_proj_transform`` are *transposed* (row-vector) matrices built by
getWorld2View2 / getProjectionMatrix, with an OpenGL-style z in [0, 1]
projection and principal-point shift support. The matrices are computed in
float64 numpy, exactly as the JAX package does, and stored as float32 torch
tensors on ``device``: the current CUDA device unless the caller names one.
Cameras are small; a caller may keep them on the CPU (``device="cpu"``), and
the renderer and the trainer move what they read to their own device.

The orbit paths are in ``cameras/camera_paths.py``; the rest of the JAX
package's camera-path tools belong to a later slice.
"""

from __future__ import annotations

import dataclasses
import math
import os
from typing import Optional

import numpy as np
import torch

from gaustudio_torch.ops.gaussian import transform_dirs
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
    bg_image: Optional[torch.Tensor] = None  # [H, W, 3] background of a masked view
    normal: Optional[torch.Tensor] = None  # [H, W, 3]
    depth: Optional[torch.Tensor] = None  # [H, W] metric depth
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
        """Read an image (RGBA is composited over ``bg_color``, default black,
        and its alpha becomes the mask; any other image leaves the mask as it
        was, as the JAX package does)."""
        from gaustudio_torch.utils.image import load_image

        img, mask = load_image(str(image_path), bg_color)
        self.image = torch.from_numpy(img).to(self.device)
        if mask is not None:
            self.mask = torch.from_numpy(mask).to(self.device)
        self.image_path = image_path
        self.image_name = os.path.basename(str(image_path)).split(".")[0]
        self.image_height, self.image_width = img.shape[:2]

    @property
    def fx(self) -> torch.Tensor:
        return self.intrinsics[0, 0]

    @property
    def fy(self) -> torch.Tensor:
        return self.intrinsics[1, 1]

    @property
    def tanfovx(self):
        return math.tan(self.FoVx * 0.5)

    @property
    def tanfovy(self):
        return math.tan(self.FoVy * 0.5)

    @property
    def extrinsics(self) -> torch.Tensor:
        """The world -> view matrix in math convention (float32 [4, 4]): the
        transpose of ``world_view_transform``."""
        return self.world_view_transform.T

    @extrinsics.setter
    def extrinsics(self, extrinsics):
        extrinsics = _host(extrinsics)
        self.R = np.transpose(extrinsics[:3, :3])
        self.T = extrinsics[:3, 3]
        self._setup()

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

    def update_intrinsics(self, intrinsics, image_width, image_height):
        """Set the field of view from a pinhole K's focal lengths and the size."""
        K = _host(intrinsics)
        self.FoVx = 2.0 * np.arctan(image_width / (2.0 * K[0, 0]))
        self.FoVy = 2.0 * np.arctan(image_height / (2.0 * K[1, 1]))
        self.image_width = int(image_width)
        self.image_height = int(image_height)
        self._setup()

    def downsample_scale(self, scale):
        resolution = round(self.image_width / scale), round(self.image_height / scale)
        return self.downsample(resolution)

    def downsample(self, resolution):
        """Resize to ``(w, h)`` as the JAX package's ``resize_color`` does:
        the image, background, mask and normal map are quantised to uint8
        (x 255 where their maximum is at most 1, then truncated) and resampled
        with an antialiased bicubic filter, PIL's default for ``resize``; the
        uint8 result is divided by 255. The depth map is resampled by nearest
        neighbour at pixel centres, as PIL's ``NEAREST`` does. The resampling
        runs on the host."""
        w, h = resolution

        def resize_color(x: torch.Tensor) -> torch.Tensor:
            x = x.detach().cpu()
            if float(x.max()) <= 1.0:
                x = x * 255.0
            q = x.to(torch.uint8).reshape(x.shape[0], x.shape[1], -1).permute(2, 0, 1)[None]
            out = torch.nn.functional.interpolate(
                q, size=(h, w), mode="bicubic", antialias=True, align_corners=False)
            out = out[0].permute(1, 2, 0).float() / 255.0
            return out.reshape((h, w) + tuple(x.shape[2:])).clamp(0.0, 1.0).to(self.device)

        if self.image is not None:
            self.image = resize_color(self.image)[..., :3]
        if self.bg_image is not None:
            self.bg_image = resize_color(self.bg_image)[..., :3]
        if self.mask is not None:
            self.mask = resize_color(self.mask)
        if self.normal is not None:
            self.normal = resize_color(self.normal)
        if self.depth is not None:
            d = self.depth.detach().cpu().float()[None, None]
            d = torch.nn.functional.interpolate(d, size=(h, w), mode="nearest-exact")
            self.depth = d[0, 0].to(self.device)
        self.image_width, self.image_height = w, h
        self._setup()
        return self

    def to(self, device) -> "Camera":
        """Move the pixels and matrices to ``device``; returns self. A shallow
        copy (``copy.copy``) moved so leaves the original's tensors where
        they are."""
        self.device = torch.device(device)
        for field in ("image", "mask", "bg_image", "normal", "depth"):
            value = getattr(self, field)
            if value is not None:
                setattr(self, field, value.to(self.device))
        self._setup()
        return self

    # -- geometry -------------------------------------------------------------
    def insideView(self, world_xyz, mask=None) -> torch.Tensor:
        """[N] bool: the points in front of the camera, inside its frustum, on
        a pixel where ``mask`` (default: all ones) exceeds 0.5."""
        world_xyz = torch.as_tensor(world_xyz, dtype=torch.float32, device=self.device)
        if mask is None:
            mask = torch.ones((self.image_height, self.image_width), device=self.device)
        mask = torch.as_tensor(mask, device=self.device)
        if mask.ndim == 3:
            mask = mask[..., 0]
        P = self.full_proj_transform
        clip = transform_dirs(world_xyz, P[:3]) + P[3]
        ndc = clip[:, :3] / clip[:, 3:4]
        px = (ndc[:, 0] + 1) * 0.5 * self.image_width
        py = (1 + ndc[:, 1]) * 0.5 * self.image_height
        inside = (ndc[:, 0] >= -1) & (ndc[:, 0] <= 1) & (ndc[:, 1] >= -1) & (ndc[:, 1] <= 1)
        valid = (clip[:, 2] > 0) & inside
        ix = torch.clamp(px.to(torch.int32), 0, self.image_width - 1).long()
        iy = torch.clamp(py.to(torch.int32), 0, self.image_height - 1).long()
        return valid & (mask[iy, ix] > 0.5)

    def depth2point(self, depth=None, coordinate="camera") -> torch.Tensor:
        """[H, W, 3] points of a depth map, in ``ndc``, ``camera`` or ``world``
        coordinates. The JAX package's convention is kept: pixel (i, j) maps to
        (j / (W - 1), i / (H - 1)), scaled back by (W - 1, H - 1) and the
        depth, through the inverse intrinsics."""
        depth = self._map(depth, self.depth, "Depth")
        h, w = depth.shape
        vx = torch.arange(w, dtype=torch.float32, device=depth.device) / (w - 1)
        vy = torch.arange(h, dtype=torch.float32, device=depth.device) / (h - 1)
        gy, gx = torch.meshgrid(vy, vx, indexing="ij")
        ndc_xyz = torch.stack([gx, gy, depth], dim=-1)
        if coordinate == "ndc":
            return ndc_xyz
        inv_scale = torch.tensor([w - 1, h - 1], dtype=torch.float32, device=depth.device)
        cam_z = ndc_xyz[..., 2:3]
        cam_xyz = torch.cat([ndc_xyz[..., :2] * inv_scale * cam_z, cam_z], dim=-1)
        K = self.intrinsics.to(depth.device)
        cam_xyz = transform_dirs(cam_xyz, torch.linalg.inv(K.T))
        if coordinate == "camera":
            return cam_xyz
        if coordinate == "world":
            c2w = torch.linalg.inv(self.extrinsics.to(depth.device))
            return transform_dirs(cam_xyz, c2w[:3, :3].T) + c2w[:3, 3]
        raise ValueError("Invalid coordinate system.")

    def depth2normal(self, depth=None, k: int = 3, d_min: float = 1e-3,
                     d_max: float = 100000.0, coordinate="camera") -> torch.Tensor:
        """[H, W, 3] normals from the cross product of the depth points'
        vertical and horizontal differences; -1 where any of the five points
        has a depth outside (d_min, d_max)."""
        depth = self._map(depth, self.depth, "Depth")
        pts = self.depth2point(depth, coordinate="camera")
        h, w, _ = pts.shape
        kk = (k - 1) // 2
        pad = torch.nn.functional.pad(pts, (0, 0, kk, kk, kk, kk))
        valid_pad = (pad[..., 2] > d_min) & (pad[..., 2] < d_max)
        vec_vert = pad[:h, kk:kk + w] - pad[2 * kk:2 * kk + h, kk:kk + w]
        vec_hori = pad[kk:kk + h, :w] - pad[kk:kk + h, 2 * kk:2 * kk + w]
        valid = (valid_pad[kk:kk + h, kk:kk + w] & valid_pad[:h, kk:kk + w]
                 & valid_pad[2 * kk:2 * kk + h, kk:kk + w] & valid_pad[kk:kk + h, :w]
                 & valid_pad[kk:kk + h, 2 * kk:2 * kk + w])
        cross = -torch.linalg.cross(vec_vert, vec_hori, dim=-1)
        normal = cross / torch.clamp_min(torch.linalg.norm(cross, dim=-1, keepdim=True), 1e-12)
        if coordinate == "world":
            normal = self.normal2worldnormal(normal)
        return torch.where(valid[..., None], normal, -1.0)

    def normal2worldnormal(self, normal=None) -> torch.Tensor:
        """View-space normals [..., 3] -> world space."""
        normal = self._map(normal, self.normal, "Normal")
        Rwc_inv = torch.linalg.inv(self.extrinsics.to(normal.device)[:3, :3])
        return transform_dirs(normal, Rwc_inv.T)

    def worldnormal2normal(self, normal) -> torch.Tensor:
        """World-space normals [..., 3] -> view space."""
        if normal is None:
            raise ValueError("Normal is not available.")
        normal = torch.as_tensor(normal, dtype=torch.float32, device=self.device)
        return transform_dirs(normal, self.extrinsics.to(normal.device)[:3, :3].T)

    def _map(self, given, own, what: str) -> torch.Tensor:
        x = own if given is None else given
        if x is None:
            raise ValueError(f"{what} is not available.")
        return torch.as_tensor(x, dtype=torch.float32, device=self.device)


def _host(m) -> np.ndarray:
    """A matrix given as a tensor or an array -> numpy on the host."""
    if isinstance(m, torch.Tensor):
        return m.detach().cpu().numpy()
    return np.asarray(m)
