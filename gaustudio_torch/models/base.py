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

    @property
    def get_center_and_size(self):
        """Centre and size of the 5 / 95-percentile box of the points (numpy)."""
        xyz = self._xyz.detach().cpu().numpy()
        lower = np.percentile(xyz, 5, axis=0)
        upper = np.percentile(xyz, 95, axis=0)
        return (lower + upper) / 2, upper - lower

    @property
    def get_center(self):
        """Centre of the points' bounding box (numpy)."""
        xyz = self._xyz.detach().cpu().numpy()
        return (xyz.min(0) + xyz.max(0)) / 2

    def params(self) -> Dict[str, torch.Tensor]:
        """The raw attributes by name."""
        return {elem: getattr(self, "_" + elem) for elem in self.config["attributes"]}

    def __add__(self, other):
        """A model of both models' points: each attribute concatenated, zeros
        for the rows of an attribute ``other`` lacks."""
        if not isinstance(other, BasePointCloud):
            raise TypeError(f"Unsupported operand type for +: '{type(self).__name__}' and "
                            f"'{type(other).__name__}'")
        result = self.__class__(self.config, self.device)
        for attr in self.config["attributes"]:
            mine = getattr(self, f"_{attr}")
            theirs = getattr(other, f"_{attr}", None)
            if theirs is None or not len(theirs):
                theirs = mine.new_zeros((other.num_points,) + tuple(mine.shape[1:]))
            setattr(result, f"_{attr}", torch.cat([mine, self._as_tensor(theirs)], 0))
        result.num_points = self.num_points + other.num_points
        return result

    def load(self, ply_path: str):
        """Inria-format checkpoint loader: xyz, opacity, rgb (uint8 red,
        green, blue / 255) and prefix-numbered fields (f_dc_0.., scale_0..)."""
        data = plyio.read_ply(ply_path)["vertex"]
        names = list(data.keys())
        self.num_points = len(data[names[0]])
        for elem in self.config["attributes"]:
            if elem == "xyz":
                arr = np.stack([data["x"], data["y"], data["z"]], axis=1)
            elif elem == "opacity":
                arr = np.asarray(data["opacity"])[:, None]
            elif elem == "rgb":
                arr = np.stack([data["red"], data["green"], data["blue"]], 1).astype(
                    np.float32) / 255.0
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
