"""Point-cloud file initializer (port of
gaustudio_tpu/pipelines/initializers/pcd.py): the points, colours and
normals of a PLY, each normal turned into the rotation whose local z it is,
opacity inverse_sigmoid(0.1). Host numpy; the model keeps the attributes on
its device."""

from __future__ import annotations

import os

import numpy as np

from gaustudio_torch.pipelines import initializers
from gaustudio_torch.pipelines.initializers.base import (
    BaseInitializer,
    inverse_sigmoid_np,
    normal2rotation,
)
from gaustudio_torch.utils.ply import fetch_ply


@initializers.register("pcd")
class PcdInitializer(BaseInitializer):
    def __init__(self, initializer_config, device=None):
        super().__init__(initializer_config, device)
        self.model_path = self.initializer_config.get("model_path", None)

    def __call__(self, model, dataset=None, overwrite=False):
        if self.model_path is None:
            raise FileNotFoundError("pcd initializer needs model_path")
        return self.build_model(model)

    def build_model(self, model):
        if not os.path.exists(self.model_path):
            raise FileNotFoundError(f"PCD file not found: {self.model_path}")
        xyz, rgb, normals = fetch_ply(self.model_path)
        rotations = normal2rotation(normals) if normals is not None else None
        opacity = inverse_sigmoid_np(0.1 * np.ones((xyz.shape[0], 1), np.float32))
        model.create_from_attribute(xyz=xyz, rgb=rgb, scale=None, opacity=opacity,
                                    rot=rotations)
        return model
