"""BasePointCloud — config-driven attribute store (port of gaustudio_tpu/models/base.py).

Raw attributes live as float32 tensors ``_<name>`` on ``device`` (the
current CUDA device unless the caller names one); PLY IO
goes through gaustudio_torch.utils.ply.
"""

from __future__ import annotations

from typing import Dict

import numpy as np
import torch

from gaustudio_torch.utils import ply as plyio
from gaustudio_torch.utils.misc import resolve_device


class BasePointCloud:
    default_conf: Dict = {"attributes": {}}

    def __init__(self, config=None, device=None) -> None:
        """``device``: None is the current CUDA device (see
        utils.misc.resolve_device)."""
        self.config = {**self.default_conf, **dict(config or {})}
        self.device = resolve_device(device)
        self.setup()

    def __repr__(self):
        return (f"{self.__class__.__name__}(num_points={self.num_points}, "
                f"properties={list(self.config['attributes'])})")

    def setup(self, num_points: int = 0):
        self.num_points = num_points
        for elem, dim in self.config["attributes"].items():
            setattr(self, "_" + elem,
                    torch.zeros((num_points, dim), dtype=torch.float32, device=self.device))

    def _as_tensor(self, arr) -> torch.Tensor:
        if isinstance(arr, torch.Tensor):
            return arr.detach().to(device=self.device, dtype=torch.float32)
        return torch.as_tensor(np.asarray(arr, np.float32), device=self.device)

    def update(self, **attrs):
        """Replace the given attributes (arrays or tensors, one row per point)."""
        for elem in self.config["attributes"]:
            if elem in attrs:
                setattr(self, "_" + elem, self._as_tensor(attrs[elem]))
        self.num_points = int(self._xyz.shape[0])

    def create_from_attribute(self, **attrs):
        """Set each given attribute; the model's attributes become those given."""
        given = {k: self._as_tensor(v) for k, v in attrs.items() if v is not None}
        for elem, value in given.items():
            setattr(self, "_" + elem, value.reshape(value.shape[0], -1))
            self.num_points = int(value.shape[0])
        self.config["attributes"] = {k: getattr(self, "_" + k).shape[1] for k in given}

    def load(self, ply_path: str):
        """Inria-format checkpoint loader: xyz, opacity and prefix-numbered
        fields (f_dc_0.., scale_0..)."""
        data = plyio.read_ply(ply_path)["vertex"]
        names = list(data.keys())
        self.num_points = len(data[names[0]])
        for elem in self.config["attributes"]:
            if elem == "xyz":
                arr = np.stack([data["x"], data["y"], data["z"]], axis=1)
            elif elem == "opacity":
                arr = np.asarray(data["opacity"])[:, None]
            else:
                matching = sorted((n for n in names if n.startswith(elem)),
                                  key=lambda n: int(n.split("_")[-1]))
                if not matching:
                    continue
                arr = np.stack([data[n] for n in matching], axis=1)
            setattr(self, "_" + elem, self._as_tensor(arr))
        print(f"Loaded {self.num_points} points from {ply_path}")

    def get_attribute(self, attribute):
        return getattr(self, "_" + attribute)
