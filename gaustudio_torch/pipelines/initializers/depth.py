"""Depth-unprojection initializer (port of
gaustudio_tpu/pipelines/initializers/depth.py): each view's depth map,
downsampled, unprojected to world points on ``device``, fused into
``fused.ply`` with SplaTAM per-point scales in ``scales.bin`` (float16).

As in the JAX package: the scale is the depth over the mean focal length of
the *downsampled* intrinsics; colours are ``(rgb * 255)`` truncated to
uint8; a ``fused.ply`` already in the workspace is reused unless
``overwrite``; the model gets the log-scale on all three axes and opacity
inverse_sigmoid(0.5).
"""

from __future__ import annotations

import copy
import os
import tempfile

import numpy as np
import torch

from gaustudio_torch.pipelines import initializers
from gaustudio_torch.pipelines.initializers.base import BaseInitializer, inverse_sigmoid_np
from gaustudio_torch.utils.misc import resolve_device
from gaustudio_torch.utils.ply import fetch_ply, store_ply


@initializers.register("depth")
class DepthInitializer(BaseInitializer):
    def __init__(self, initializer_config, device=None):
        super().__init__(initializer_config, resolve_device(device))
        self.ws_dir = self.initializer_config.get("workspace_dir")
        if self.ws_dir is None:
            self.ws_dir = tempfile.mkdtemp()
            print(f"No workspace directory provided. Using temporary directory: {self.ws_dir}")
        os.makedirs(self.ws_dir, exist_ok=True)
        self.downsample = int(self.initializer_config.get("downsample", 4))

    def __call__(self, model, dataset, overwrite=False):
        if not os.path.exists(f"{self.ws_dir}/fused.ply") or overwrite:
            self.cache_dataset(dataset)
            self.process_dataset()
        return self.build_model(model)

    def cache_dataset(self, dataset):
        print("Caching point cloud...")
        self._points, self._colors, self._scales = [], [], []
        for camera in dataset:
            camera = copy.deepcopy(camera).downsample_scale(self.downsample)
            if camera.depth is None:
                continue
            camera.to(self.device)
            depth = camera.depth
            world = camera.depth2point(depth, "world").reshape(-1, 3)
            K = camera.intrinsics
            scale = depth / ((K[0, 0] + K[1, 1]) / 2.0)  # SplaTAM: depth / mean focal
            valid = depth.reshape(-1) > 0
            self._points.append(world[valid])
            self._colors.append(camera.image.reshape(-1, 3)[valid])
            self._scales.append(scale.reshape(-1)[valid])

    def process_dataset(self):
        if not self._points:
            print("No point clouds to process.")
            return
        host = lambda parts: torch.cat(parts).cpu().numpy()  # noqa: E731
        pts = host(self._points).astype(np.float32)
        rgb = host(self._colors)
        scales = host(self._scales).astype(np.float16)
        store_ply(os.path.join(self.ws_dir, "fused.ply"), pts, (rgb * 255).astype(np.uint8))
        scales.tofile(os.path.join(self.ws_dir, "scales.bin"))
        print(f"Fused point cloud saved to {self.ws_dir}/fused.ply")

    def build_model(self, model):
        print("Building point cloud...")
        xyz, rgb, _ = fetch_ply(os.path.join(self.ws_dir, "fused.ply"))
        scales_path = os.path.join(self.ws_dir, "scales.bin")
        log_scales = None
        if os.path.exists(scales_path):
            scales = np.fromfile(scales_path, dtype=np.float16).astype(np.float32)
            log_scales = np.repeat(np.log(np.maximum(scales, 1e-7))[:, None], 3, axis=1)
        opacity = inverse_sigmoid_np(0.5 * np.ones((xyz.shape[0], 1), np.float32))
        model.create_from_attribute(xyz=xyz, rgb=rgb, opacity=opacity, scale=log_scales)
        return model
