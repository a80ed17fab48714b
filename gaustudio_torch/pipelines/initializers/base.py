"""Initializer protocol and the geometry helpers the initializers share
(port of gaustudio_tpu/pipelines/initializers/base.py; numpy on the host).
"""

from __future__ import annotations

from abc import ABC, abstractmethod

import numpy as np


def inverse_sigmoid_np(x):
    return np.log(x / (1 - x))


def normal2rotation(n: np.ndarray) -> np.ndarray:
    """Normals [N, 3] -> quaternions [N, 4] (w, x, y, z) whose local z axis
    is the normal."""
    n = np.asarray(n, np.float64)
    n = n / np.maximum(np.linalg.norm(n, axis=-1, keepdims=True), 1e-12)
    w0 = np.broadcast_to(np.array([1.0, 0.0, 0.0]), n.shape)
    R0 = w0 - np.sum(w0 * n, -1, keepdims=True) * n
    R0 = R0 * np.sign(R0[:, :1] + 1e-12)
    R0 = R0 / np.maximum(np.linalg.norm(R0, axis=-1, keepdims=True), 1e-12)
    R1 = np.cross(n, R0)
    R1 = R1 * np.sign(R1[:, 1:2] + 1e-12) * np.sign(n[:, 2:] + 1e-12)
    R = np.stack([R0, R1, n], -1)
    return rotmat2quaternion(R)


def rotmat2quaternion(R: np.ndarray, normalize: bool = False) -> np.ndarray:
    """Rotation matrices [N, 3, 3] -> float32 quaternions [N, 4] (w, x, y, z)."""
    tr = R[:, 0, 0] + R[:, 1, 1] + R[:, 2, 2] + 1e-6
    r = np.sqrt(np.maximum(1 + tr, 1e-12)) / 2
    q = np.stack([
        r,
        (R[:, 2, 1] - R[:, 1, 2]) / (4 * r),
        (R[:, 0, 2] - R[:, 2, 0]) / (4 * r),
        (R[:, 1, 0] - R[:, 0, 1]) / (4 * r),
    ], -1)
    if normalize:
        q = q / np.maximum(np.linalg.norm(q, axis=-1, keepdims=True), 1e-12)
    return q.astype(np.float32)


class BaseInitializer(ABC):
    """cache_dataset -> process_dataset -> build_model, unless
    ``should_skip`` says the cache is already there. ``device`` is where an
    initializer that computes on the card does so (None: the current CUDA
    device); the others compute on the host and ignore it."""

    def __init__(self, initializer_config, device=None):
        self.initializer_config = initializer_config or {}
        self.device = device

    def setup(self):
        pass

    def cache_dataset(self, dataset=None):
        pass

    def process_dataset(self):
        pass

    @abstractmethod
    def build_model(self, model):
        ...

    def should_skip(self):
        return False

    def __call__(self, model, dataset=None, overwrite=False):
        if overwrite or not self.should_skip():
            self.cache_dataset(dataset)
            self.process_dataset()
        return self.build_model(model)
