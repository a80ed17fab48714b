"""ScaffoldPointCloud — Scaffold-GS anchors with neural heads (port of
gaustudio_tpu/models/scaffold.py).

Each anchor carries ``offset`` [N, 3k], ``anchor_feat`` [N, F], ``scale``
[N, 6] ([:3] scale the offsets, [3:] are the Gaussians' base scale) and
``rot``; per view, MLP heads decode k offset Gaussians an anchor from its
feature, view direction and distance. The heads are ``nn.Sequential``
Linear(F + 4, F) -> ReLU -> Linear(F, out) modules: opacity (k, tanh), cov
(7k), colour (3k, sigmoid) and, with ``use_feat_bank``, feature_bank (3 from
the view direction and distance, softmax).

The JAX model keeps each layer as ``{"w": [n_in, n_out], "b"}`` and computes
``x @ w + b``; an ``nn.Linear.weight`` is [n_out, n_in], so
``from_jax_params`` and the ``<ply>.mlps.npz`` sidecar transpose ``w``.
"""

from __future__ import annotations

import os
from typing import Dict

import numpy as np
import torch
from torch import nn

from gaustudio_torch import models
from gaustudio_torch.models.base import BasePointCloud
from gaustudio_torch.models.utils import get_activation
from gaustudio_torch.utils import ply as plyio

_ELEMS = ("anchor", "offset", "anchor_feat", "opacity", "scale", "rot")
_FINAL = {"opacity": nn.Tanh, "cov": None, "color": nn.Sigmoid,
          "feature_bank": lambda: nn.Softmax(dim=1)}


def make_head(name: str, n_in: int, hidden: int, n_out: int) -> nn.Sequential:
    """Linear(n_in, hidden) -> ReLU -> Linear(hidden, n_out) -> the head's
    final activation (indices 0 and 2 hold the two layers)."""
    layers = [nn.Linear(n_in, hidden), nn.ReLU(), nn.Linear(hidden, n_out)]
    if _FINAL[name] is not None:
        layers.append(_FINAL[name]())
    return nn.Sequential(*layers)


def head_shapes(feat_dim: int, k: int, use_feat_bank: bool) -> Dict[str, tuple]:
    shapes = {"opacity": (feat_dim + 4, feat_dim, k), "cov": (feat_dim + 4, feat_dim, 7 * k),
              "color": (feat_dim + 4, feat_dim, 3 * k)}
    if use_feat_bank:
        shapes["feature_bank"] = (4, feat_dim, 3)
    return shapes


def heads_from_layers(layers: Dict[str, list], device) -> nn.ModuleDict:
    """The heads of JAX-layout layers {head: [{"w": [n_in, n_out], "b"}, x2]}."""
    heads = nn.ModuleDict()
    for name, (l0, l1) in layers.items():
        w0, w1 = (np.asarray(layer["w"], np.float32) for layer in (l0, l1))
        head = make_head(name, *w0.shape, w1.shape[1])
        with torch.no_grad():
            for idx, w, layer in ((0, w0, l0), (2, w1, l1)):
                head[idx].weight.copy_(torch.tensor(w.T))
                head[idx].bias.copy_(torch.tensor(np.asarray(layer["b"], np.float32)))
        heads[name] = head
    return heads.to(device)


def heads_to_layers(heads: nn.ModuleDict) -> Dict[str, list]:
    """{head: [{"w": [n_in, n_out], "b"}, x2]} numpy, the JAX layout."""
    host = lambda t: t.detach().cpu().numpy().astype(np.float32)  # noqa: E731
    return {name: [{"w": host(head[i].weight).T.copy(), "b": host(head[i].bias)} for i in (0, 2)]
            for name, head in heads.items()}


@models.register("scaffold_pcd")
class ScaffoldPointCloud(BasePointCloud):
    default_conf = {
        "sh_degree": 3,
        "attributes": {
            "anchor": 3,
            "offset": 3,  # times n_offsets (stored flat [N, 3k])
            "anchor_feat": 32,
            "opacity": 1,
            "scale": 6,  # [:3] offset scaling, [3:] gaussian scale base
            "rot": 4,
        },
        "activations": {"scale": "exp", "opacity": "sigmoid", "rot": "normalize"},
        "n_offsets": 10,
        "voxel_size": 0.001,
        "update_depth": 3,
        "update_init_factor": 16,
        "update_hierachy_factor": 4,
        "use_feat_bank": False,
    }

    def __init__(self, config=None, device=None) -> None:
        super().__init__(config, device)
        self.active_sh_degree = 0
        self.max_sh_degree = self.config["sh_degree"]
        self.feat_dim = self.config["attributes"]["anchor_feat"]
        self.n_offsets = self.config["n_offsets"]
        self.voxel_size = self.config["voxel_size"]
        self.update_depth = self.config["update_depth"]
        self.update_init_factor = self.config["update_init_factor"]
        self.update_hierachy_factor = self.config["update_hierachy_factor"]
        self.use_feat_bank = self.config["use_feat_bank"]

        # U(-1/sqrt(n_in), 1/sqrt(n_in)) weights and zero biases, drawn from
        # a generator seeded by the config's ``seed``
        gen = torch.Generator().manual_seed(int(self.config.get("seed", 0)))
        self.mlp = nn.ModuleDict()
        for name, (n_in, hidden, n_out) in head_shapes(
                self.feat_dim, self.n_offsets, self.use_feat_bank).items():
            head = make_head(name, n_in, hidden, n_out)
            with torch.no_grad():
                for idx in (0, 2):
                    bound = 1.0 / np.sqrt(head[idx].in_features)
                    head[idx].weight.uniform_(-bound, bound, generator=gen)
                    head[idx].bias.zero_()
            self.mlp[name] = head
        self.mlp.to(self.device)

        resume_path = self.config.get("resume_path", None)
        if resume_path is not None:
            self.load(resume_path)

    @classmethod
    def from_jax_params(cls, params: Dict, device=None, config=None) -> "ScaffoldPointCloud":
        """Build the model from the JAX model's anchors and heads.

        ``params`` maps each of anchor, offset, anchor_feat, opacity, scale,
        rot to ``np.asarray(getattr(jax_pcd, "_" + elem))`` and ``mlps`` to
        ``jax_pcd.mlp_params`` ({head: [{"w": [n_in, n_out], "b"}, x2]}).
        """
        pcd = cls(config, device)
        for elem in _ELEMS:
            arr = np.asarray(params[elem], np.float32)
            setattr(pcd, "_" + elem, pcd._as_tensor(arr.reshape(arr.shape[0], -1)))
        pcd.num_points = int(pcd._anchor.shape[0])
        pcd.mlp = heads_from_layers(params["mlps"], pcd.device)
        return pcd

    def get_attribute(self, attribute):
        """Activated attribute."""
        raw = getattr(self, "_" + attribute)
        if attribute in self.config.get("activations", {}):
            return get_activation(self.config["activations"][attribute])(raw)
        return raw

    def mlp_opacity(self, x):
        return self.mlp["opacity"](x)

    def mlp_cov(self, x):
        return self.mlp["cov"](x)

    def mlp_color(self, x):
        return self.mlp["color"](x)

    def mlp_feature_bank(self, x):
        return self.mlp["feature_bank"](x)

    def voxelize_sample(self, points, voxel_size=None) -> np.ndarray:
        """Points -> voxel centres, one per occupied voxel, in the order of
        each voxel's first point."""
        vs = voxel_size or self.voxel_size
        pts = points.detach().cpu().numpy() if isinstance(points, torch.Tensor) else np.asarray(
            points)
        keys = np.round(pts / vs).astype(np.int64)
        _, idx = np.unique(keys, axis=0, return_index=True)
        return (keys[np.sort(idx)] * vs).astype(np.float32)

    def create_from_attribute(self, xyz, rgb=None, **kwargs):
        """Anchors at the voxel centres of ``xyz``: zero offsets, features and
        opacity, scales log(voxel_size), identity rotations."""
        anchors = self.voxelize_sample(xyz)
        n, k = len(anchors), self.n_offsets
        rot = np.zeros((n, 4), np.float32)
        rot[:, 0] = 1.0
        self._anchor = self._as_tensor(anchors)
        self._offset = self._as_tensor(np.zeros((n, 3 * k), np.float32))
        self._anchor_feat = self._as_tensor(np.zeros((n, self.feat_dim), np.float32))
        self._opacity = self._as_tensor(np.zeros((n, 1), np.float32))
        self._scale = self._as_tensor(np.full((n, 6), np.log(max(self.voxel_size, 1e-4)),
                                              np.float32))
        self._rot = self._as_tensor(rot)
        self.num_points = n

    def export(self, path):
        """The anchor PLY (x, y, z, nx, ny, nz, offset_*, anchor_feat_*,
        opacity, scale_*, rot_*) and the heads in ``<path>.mlps.npz``
        (``<head>/<layer>/w`` [n_in, n_out] and ``<head>/<layer>/b``)."""
        n = self.num_points
        host = lambda t: t.detach().cpu().numpy().astype(np.float32).reshape(n, -1)  # noqa: E731
        anchor = host(self._anchor)
        props = {"x": anchor[:, 0], "y": anchor[:, 1], "z": anchor[:, 2],
                 "nx": np.zeros(n, np.float32), "ny": np.zeros(n, np.float32),
                 "nz": np.zeros(n, np.float32)}
        for name in ("offset", "anchor_feat"):
            arr = host(getattr(self, "_" + name))
            props.update({f"{name}_{i}": arr[:, i] for i in range(arr.shape[1])})
        props["opacity"] = host(self._opacity)[:, 0]
        for name in ("scale", "rot"):
            arr = host(getattr(self, "_" + name))
            props.update({f"{name}_{i}": arr[:, i] for i in range(arr.shape[1])})
        plyio.write_ply(path, props)
        flat = {f"{head}/{li}/{pname}": arr
                for head, layers in heads_to_layers(self.mlp).items()
                for li, layer in enumerate(layers) for pname, arr in layer.items()}
        np.savez(str(path) + ".mlps.npz", **flat)
        print(f"Exported {n} anchors to {path}")

    def load(self, ply_path: str):
        """The anchor PLY of :meth:`export`, and its heads where the
        ``.mlps.npz`` sidecar exists."""
        data = plyio.read_ply(ply_path)["vertex"]
        names = list(data.keys())
        self.num_points = len(data["x"])
        self._anchor = self._as_tensor(np.stack([data["x"], data["y"], data["z"]], 1))
        self._opacity = self._as_tensor(np.asarray(data["opacity"])[:, None])
        for elem in ("offset", "anchor_feat", "scale", "rot"):
            matching = sorted((nm for nm in names if nm.startswith(elem)),
                              key=lambda nm: int(nm.split("_")[-1]))
            arr = np.zeros((self.num_points, len(matching)), np.float32)
            for i, nm in enumerate(matching):
                arr[:, i] = data[nm]
            setattr(self, "_" + elem, self._as_tensor(arr))
        sidecar = str(ply_path) + ".mlps.npz"
        if os.path.exists(sidecar):
            flat = np.load(sidecar)
            layers: Dict[str, dict] = {}
            for key in flat.files:
                head, li, pname = key.split("/")
                layers.setdefault(head, {}).setdefault(int(li), {})[pname] = flat[key]
            self.mlp = heads_from_layers(
                {head: [d[li] for li in sorted(d)] for head, d in layers.items()}, self.device)
        print(f"Loaded {self.num_points} anchors from {ply_path}")
