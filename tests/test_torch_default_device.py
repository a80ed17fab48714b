"""The device rule of the port's entry points: they run on the current CUDA
device unless the caller names one. Where torch sees no CUDA device, an
entry point called without ``device`` raises and says to pass
``device="cpu"``; it never falls back to the CPU. With ``device="cpu"`` its
tensors lie on the CPU.

The raising half hides the card with a monkeypatched
``torch.cuda.is_available``, so both halves run on any machine.
"""

from types import SimpleNamespace
from unittest import mock

import numpy as np
import pytest
import torch

from gaustudio_torch import models, renderers
from gaustudio_torch.cameras import Camera
from gaustudio_torch.cameras.camera_paths import get_path_from_orbit
from gaustudio_torch.datasets.utils import JSON_to_camera
from gaustudio_torch.models.base import BasePointCloud
from gaustudio_torch.models.mip import MipPointCloud
from gaustudio_torch.models.sap import ShapeAsPoints
from gaustudio_torch.models.scaffold import ScaffoldPointCloud
from gaustudio_torch.models.vanilla import VanillaPointCloud
from gaustudio_torch.ops import tsdf as t_tsdf
from gaustudio_torch.pipelines import initializers
from gaustudio_torch.pipelines import mesh_extraction as t_mesh_extraction
from gaustudio_torch.pipelines import pcd_extraction as t_pcd_extraction
from gaustudio_torch.pipelines import train as t_train
from gaustudio_torch.pipelines import train_scaffold as t_train_scaffold
from gaustudio_torch.pipelines import train_surfel as t_train_surfel

CAM_JSON = {"id": 0, "img_name": "v0", "width": 8, "height": 6, "position": [0.0, 0.0, -3.0],
            "rotation": np.eye(3).tolist(), "fx": 10.0, "fy": 10.0}


def _params(n=5, scale_dim=3):
    rng = np.random.default_rng(0)
    f = lambda *shape: rng.normal(size=shape).astype(np.float32)  # noqa: E731
    return {"xyz": f(n, 3), "opacity": f(n, 1), "f_dc": f(n, 3), "f_rest": f(n, 45),
            "scale": f(n, scale_dim), "rot": f(n, 4)}


def _scaffold_params(n=4, k=2, feat=8):
    """The raw anchors and JAX-layout heads that from_jax_params reads."""
    rng = np.random.default_rng(1)
    f = lambda *shape: rng.normal(size=shape).astype(np.float32)  # noqa: E731
    layer = lambda n_in, n_out: {"w": f(n_in, n_out), "b": f(n_out)}  # noqa: E731
    return {"anchor": f(n, 3), "offset": f(n, 3 * k), "anchor_feat": f(n, feat),
            "opacity": f(n, 1), "scale": f(n, 6), "rot": f(n, 4),
            "mlps": {"opacity": [layer(feat + 4, feat), layer(feat, k)],
                     "cov": [layer(feat + 4, feat), layer(feat, 7 * k)],
                     "color": [layer(feat + 4, feat), layer(feat, 3 * k)]}}


SCAFFOLD_CONFIG = {"n_offsets": 2, "attributes": {"anchor": 3, "offset": 3, "anchor_feat": 8,
                                                  "opacity": 1, "scale": 6, "rot": 4}}


def _cpu_views():
    cam = JSON_to_camera(CAM_JSON, device="cpu")
    cam.image = torch.zeros((6, 8, 3))
    return [cam]


def _jax_like_state(n=5):
    """A stand-in with the fields state_from_jax reads from a JAX
    GaussianTrainState, as numpy arrays."""
    params = _params(n)
    zeros = {k: np.zeros_like(v) for k, v in params.items()}
    return SimpleNamespace(
        valid=np.ones(n, bool), params=params,
        opt=SimpleNamespace(mu=zeros, nu=zeros, count={k: np.zeros(n, np.int32) for k in params}),
        step=np.int32(3), xyz_grad_accum=np.zeros(n, np.float32), denom=np.zeros(n, np.float32),
        max_radii2d=np.zeros(n, np.float32), active_sh_degree=np.int32(1))


def _checkpoint(tmp_path):
    pcd = VanillaPointCloud.from_jax_params(_params(), device="cpu")
    path = str(tmp_path / "step_1.pt")
    t_train.save_checkpoint(path, t_train.init_state(pcd))
    return path


def _state_tensors(state):
    return list(state.params.values()) + [state.xyz_grad_accum, state.opt.mu["xyz"]]


def _extract_mesh_volume(tmp, **kw):
    """extract_mesh on host cameras and model; its TSDF grid."""
    grids = []
    integrate = t_tsdf.integrate

    def spy(vol, *args):
        grids.append(vol.tsdf)
        return integrate(vol, *args)

    pcd = VanillaPointCloud.from_jax_params(_params(), device="cpu")
    renderer = renderers.make({"name": "vanilla_renderer"}, device="cpu")
    with mock.patch.object(t_tsdf, "integrate", spy):
        t_mesh_extraction.extract_mesh(pcd, renderer, _cpu_views(), stride=1, downsample=1,
                                       voxel_size=0.1, **kw)
    return grids


def _oriented_points(n=200):
    rng = np.random.default_rng(2)
    d = rng.normal(size=(n, 3)).astype(np.float32)
    return d / np.linalg.norm(d, axis=1, keepdims=True)


TETRAHEDRON = (np.array([[0, 0, 0], [1, 0, 0], [0, 1, 0], [0, 0, 1]], np.float32),
               np.array([[0, 2, 1], [0, 1, 3], [0, 3, 2], [1, 2, 3]]))


def _mesh_sap_grid(tmp, **kw):
    """mesh_sap's indicator grid, caught as it is solved."""
    grids = []
    solve = ShapeAsPoints.psr_grid

    def spy(self):
        grids.append(solve(self))
        return grids[-1]

    with mock.patch.object(ShapeAsPoints, "psr_grid", spy):
        t_pcd_extraction.mesh_sap(_oriented_points(), _oriented_points(), grid_res=16, **kw)
    return grids


def _tsdf_initializer_volume(tmp, **kw):
    """The TSDF grid the tsdf initializer fuses a host camera's depth into."""
    grids = []
    integrate = t_tsdf.integrate

    def spy(vol, *args):
        grids.append(vol.tsdf)
        return integrate(vol, *args)

    cam = _cpu_views()[0]
    cam.depth = torch.full((6, 8), 3.0)
    with mock.patch.object(t_tsdf, "integrate", spy):
        initializers.make({"name": "tsdf"}, **kw).cache_dataset([cam])
    return grids


def _depth_initializer_points(tmp, **kw):
    """The world points the depth initializer unprojects a host camera's
    depth map to."""
    cam = _cpu_views()[0]
    cam.depth = torch.full((6, 8), 3.0)
    init = initializers.make({"name": "depth", "workspace_dir": str(tmp), "downsample": 1}, **kw)
    init.cache_dataset([cam])
    return init._points + init._scales


def _visual_hull_field(tmp, **kw):
    """The carved field the VisualHull initializer hands to marching
    tetrahedra, from two host cameras."""
    from gaustudio_torch.ops import mcubes

    fields = []
    march = mcubes.marching_tetrahedra

    def spy(field, *args, **kwargs):
        fields.append(field)
        return march(field, *args, **kwargs)

    cams = get_path_from_orbit(np.zeros(3), 2.0, num_cam=2, image_size=8, device="cpu")
    with mock.patch.object(mcubes, "marching_tetrahedra", spy):
        initializers.make({"name": "VisualHull", "resolution": 8}, **kw).cache_dataset(cams)
    return fields


def _in_group_of_one(fn):
    """fn() in the process group of one that make_mesh joins without
    torchrun, left before returning so that no later test finds it."""
    import torch.distributed as dist

    try:
        return fn()
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()


def _mesh_tensors(tmp, **kw):
    from gaustudio_torch.parallel import make_mesh
    from gaustudio_torch.parallel.mesh import Collectives

    return _in_group_of_one(lambda: [torch.zeros(1, device=Collectives(make_mesh(**kw)).device)])


def _dp_trainer_tensors(tmp, **kw):
    from gaustudio_torch.parallel.train_dp import DPTrainer

    return _in_group_of_one(lambda: _state_tensors(DPTrainer(
        VanillaPointCloud.from_jax_params(_params(), device="cpu"), _cpu_views(),
        **kw).state.shard))


# entry point -> fn(tmp_path, **device kwargs) -> the tensors it made
ENTRY_POINTS = {
    "renderers.make vanilla_renderer": lambda tmp, **kw: [
        renderers.make({"name": "vanilla_renderer"}, **kw).bg_color],
    "renderers.make surfel_renderer": lambda tmp, **kw: [
        renderers.make({"name": "surfel_renderer"}, **kw).bg_color],
    **{f"renderers.make {name}": (lambda name: lambda tmp, **kw: [
        renderers.make({"name": name}, **kw).bg_color])(name)
       for name in ("mip_renderer", "gsplat_renderer", "pcd_renderer", "scaffold_renderer")},
    "MipPointCloud": lambda tmp, **kw: [MipPointCloud(None, **kw)._xyz],
    "ScaffoldPointCloud.from_jax_params": lambda tmp, **kw: (lambda pcd: [
        pcd._offset, *pcd.mlp.parameters()])(ScaffoldPointCloud.from_jax_params(
            _scaffold_params(), config=SCAFFOLD_CONFIG, **kw)),
    "ScaffoldTrainer": lambda tmp, **kw: list(t_train_scaffold.ScaffoldTrainer(
        ScaffoldPointCloud.from_jax_params(_scaffold_params(), device="cpu",
                                           config=SCAFFOLD_CONFIG), _cpu_views(),
        **kw).state.params.values()),
    "models.make vanilla_pcd": lambda tmp, **kw: [
        models.make({"name": "vanilla_pcd"}, **kw)._xyz],
    "BasePointCloud": lambda tmp, **kw: [
        BasePointCloud({"attributes": {"xyz": 3}}, **kw)._xyz],
    "VanillaPointCloud.from_jax_params": lambda tmp, **kw: [
        VanillaPointCloud.from_jax_params(_params(), **kw)._f_rest],
    "Trainer": lambda tmp, **kw: _state_tensors(t_train.Trainer(
        VanillaPointCloud.from_jax_params(_params(), device="cpu"), _cpu_views(), **kw).state),
    "SurfelTrainer": lambda tmp, **kw: _state_tensors(t_train_surfel.SurfelTrainer(
        VanillaPointCloud.from_jax_params(_params(scale_dim=2), device="cpu"), _cpu_views(),
        **kw).state),
    "JSON_to_camera": lambda tmp, **kw: [JSON_to_camera(CAM_JSON, **kw).full_proj_transform],
    "Camera": lambda tmp, **kw: [Camera(R=np.eye(3), T=np.array([0.0, 0.0, 3.0]), FoVx=1.0,
                                        FoVy=1.0, image_width=8, image_height=6,
                                        **kw).world_view_transform],
    "state_from_jax": lambda tmp, **kw: _state_tensors(
        t_train.state_from_jax(_jax_like_state(), **kw)),
    "load_checkpoint": lambda tmp, **kw: _state_tensors(
        t_train.load_checkpoint(_checkpoint(tmp), **kw)),
    "get_path_from_orbit": lambda tmp, **kw: [
        get_path_from_orbit(np.zeros(3), 2.0, num_cam=2, image_size=8, **kw)[1].extrinsics],
    "create_volume": lambda tmp, **kw: [t_tsdf.create_volume(np.zeros(3), (4, 4, 4), 0.1, 0.4,
                                                             **kw).weight],
    "volume_from_bounds": lambda tmp, **kw: [t_tsdf.volume_from_bounds(
        np.zeros(3), np.ones(3), 0.25, 1.0, **kw).tsdf],
    "TSDFVolume.from_numpy": lambda tmp, **kw: [t_tsdf.TSDFVolume.from_numpy(
        np.ones((2, 2, 2)), np.zeros((2, 2, 2)), np.zeros(3), 0.1, 0.4, **kw).origin],
    "extract_mesh": _extract_mesh_volume,
    "models.make sap_pcd": lambda tmp, **kw: [models.make({"name": "sap_pcd"}, **kw)._xyz],
    "ShapeAsPoints.from_pointcloud": lambda tmp, **kw: (lambda sap: [sap._xyz, sap._normal])(
        ShapeAsPoints.from_pointcloud(_oriented_points(), _oriented_points(), **kw)),
    "ShapeAsPoints.from_mesh": lambda tmp, **kw: [ShapeAsPoints.from_mesh(
        *TETRAHEDRON, n_samples=50, **kw).unit_points],
    "mesh_sap": _mesh_sap_grid,
    "TsdfInitializer": _tsdf_initializer_volume,
    "DepthInitializer": _depth_initializer_points,
    "VisualHullInitializer": _visual_hull_field,
    "make_mesh": _mesh_tensors,
    "DPTrainer": _dp_trainer_tensors,
}


@pytest.mark.parametrize("name", list(ENTRY_POINTS))
def test_entry_point_without_a_device_raises_where_there_is_no_card(name, tmp_path, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match='device="cpu"'):
        ENTRY_POINTS[name](tmp_path)


@pytest.mark.parametrize("name", list(ENTRY_POINTS))
def test_entry_point_with_the_cpu_named_puts_its_tensors_there(name, tmp_path):
    tensors = ENTRY_POINTS[name](tmp_path, device="cpu")
    assert tensors and all(t.device.type == "cpu" for t in tensors), name


CLI_ARGV = {
    "extract_pcd": ["-m", "model.ply"],
    "render_mesh": ["-m", "mesh.ply", "-o", "out"],
    "texture_mesh": ["-m", "mesh.ply", "-o", "out.ply"],
    "mesh2gs": ["-m", "mesh.ply", "-o", "out.ply"],
    "initialize": ["-s", "capture", "-o", "out"],
    "process_data": ["-s", "capture", "-o", "out"],
}


@pytest.mark.parametrize("cli", list(CLI_ARGV))
def test_cli_without_a_card_raises_unless_given_the_cpu(cli, monkeypatch):
    """The CLIs of slices 6 and 7 default to --device cuda and refuse to run
    without a card, naming the CPU route."""
    import importlib

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    main = importlib.import_module(f"gaustudio_torch.scripts.{cli}").main
    with pytest.raises(RuntimeError, match='device="cpu"'):
        main(CLI_ARGV[cli])


def test_dust3r_initializer_runs_its_model_on_the_named_device(tmp_path, monkeypatch):
    """The dust3r initializer resolves its device as it is made: without a
    card it raises unless given the CPU, and its external model is then run
    on the device named."""
    from gaustudio_torch.pipelines.initializers import dust3r

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match='device="cpu"'):
        initializers.make({"name": "dust3r"})
    init = initializers.make({"name": "dust3r", "workspace_dir": str(tmp_path)}, device="cpu")
    assert init._run_dust3r.func is dust3r._run_mini_dust3r
    assert init._run_dust3r.keywords == {"device": torch.device("cpu")}
