"""Port parity of the camera-parallel render and TSDF fusion
(gaustudio_torch/parallel/render_dp.py, the renderers' dp_render_closure,
pipelines/mesh_extraction._fuse_views_dp) against
gaustudio_tpu/parallel/render_dp.py at dp = 2, on tests/test_parallel.py's
scene (32 px, 64 Gaussians, 8 orbit cameras), and the multi-rank dry run.

One gloo group of 4 CPU ranks runs every case of this file (the module
fixture); each JAX sharded program compiles once, on a mesh over 2 of
conftest's 8 virtual devices. Each test then asserts one thing.
"""

import math
import os

import numpy as np
import pytest

import jax
import jax.numpy as jnp
from jax.sharding import Mesh

from gaustudio_torch import renderers as t_renderers
from gaustudio_torch.models.vanilla import VanillaPointCloud
from gaustudio_torch.ops import tsdf as t_tsdf
from gaustudio_torch.parallel import dryrun, make_mesh, render_dp as t_render_dp
from gaustudio_torch.parallel.mesh import Collectives
from gaustudio_torch.pipelines import mesh_extraction as t_mesh_extraction
from gaustudio_tpu import models as j_models
from gaustudio_tpu import renderers as j_renderers
from gaustudio_tpu.cameras import camera_paths as j_camera_paths
from gaustudio_tpu.ops import rasterize as j_rast
from gaustudio_tpu.ops import rasterize_surfel as j_rast_surfel
from gaustudio_tpu.ops import tsdf as j_tsdf
from gaustudio_tpu.ops.rasterize import RasterizeSettings as JSettings
from gaustudio_tpu.parallel import render_dp as j_render_dp
from tests.test_torch_parallel_train import ELEMS, N_CAMS, SIZE, _gt_params, _perturbed, \
    _port_cameras

BOUNDS = ([-1.0, -1.0, -1.0], [1.0, 1.0, 1.0])
VOXEL, TRUNC = 0.05, 0.2


def _port_model(params):
    return VanillaPointCloud.from_jax_params({**params, "active_sh_degree": 0}, device="cpu")


def _volume():
    return t_tsdf.volume_from_bounds(*BOUNDS, VOXEL, TRUNC, device="cpu")


def _rank_cases(params, work_dir):
    """Every case of this file on one rank of the 4-rank group."""
    pcd, cams = _port_model(params), _port_cameras()
    views = t_render_dp.stack_cameras(cams, device="cpu")
    comm = Collectives(make_mesh(dp=2, gs=2, device="cpu"))
    out = {"dp_rank": comm.dp_rank}
    for name in ("vanilla_renderer", "surfel_renderer"):
        settings, render_fn = t_renderers.make({"name": name}, device="cpu") \
            .dp_render_closure(cams, pcd)
        block = t_render_dp.make_dp_render_fn(comm, settings, render_fn)(views)
        out[name] = {k: v.numpy() for k, v in block.items()}
        if name == "vanilla_renderer":
            fused = t_render_dp.make_dp_fuse_fn(comm, settings, render_fn)(
                _volume(), views)
            out["fused"] = (fused.tsdf.numpy(), fused.weight.numpy())

    renderer = t_renderers.make({"name": "vanilla_renderer"}, device="cpu")
    vol = t_mesh_extraction._fuse_views_dp(renderer, pcd, cams, _volume(), work_dir,
                                           make_mesh(dp=4, gs=1, device="cpu"))
    out["work_dir_volume"] = (vol.tsdf.numpy(), vol.weight.numpy())
    mesh = t_mesh_extraction.extract_mesh(pcd, renderer, cams, stride=1, downsample=1,
                                          voxel_size=VOXEL, sdf_trunc=TRUNC, min_weight=1.0,
                                          device="cpu")
    out["mesh_faces"] = None if mesh is None else len(mesh[1])
    out["dryrun"] = dryrun.dryrun_rank("cpu")
    return out


def _jax_runs(params):
    """The JAX package's dp = 2 render (vanilla, surfel) and fuse of the 8 views."""
    pcd = j_models.make({"name": "vanilla_pcd"})
    pcd.create_from_attribute(xyz=params["xyz"])
    for k in ELEMS:
        setattr(pcd, "_" + k, params[k])
    pcd.active_sh_degree = 0
    cams = j_camera_paths.get_path_from_orbit(np.zeros(3), 2.0, num_cam=N_CAMS, image_size=SIZE,
                                              fov_deg=50)
    xyz, shs, _, opacity, scales, rotations, _ = j_renderers.make(
        {"name": "vanilla_renderer"}).get_gaussians_properties(cams[0], pcd)
    settings = JSettings(image_height=SIZE, image_width=SIZE,
                         tanfovx=math.tan(cams[0].FoVx / 2), tanfovy=math.tan(cams[0].FoVy / 2),
                         bg=jnp.zeros(3), num_entries=1 << 12, chunk=512)
    mesh = Mesh(np.asarray(jax.devices()[:2]).reshape(2, 1), ("dp", "gs"))
    rc = j_render_dp.stack_cameras(cams)

    def vanilla(s):
        return j_rast.rasterize(xyz, opacity, s, shs=shs, scales=scales, rotations=rotations,
                                active_sh_degree=0)

    def surfel(s):
        out = dict(j_rast_surfel.rasterize_surfels(xyz, opacity, s, scales=scales[:, :2],
                                                   rotations=rotations, shs=shs,
                                                   active_sh_degree=0))
        out["rendered_final_opacity"] = out["rendered_alpha"]
        return out

    got = {name: jax.tree.map(np.asarray, j_render_dp.make_dp_render_fn(mesh, s, fn)(rc))
           for name, fn, s in (("vanilla_renderer", vanilla, settings),
                               ("surfel_renderer", surfel, settings._replace(need_grads=False)))}
    vol = j_render_dp.make_dp_fuse_fn(mesh, settings, vanilla)(
        j_tsdf.volume_from_bounds(*BOUNDS, VOXEL, TRUNC), rc)
    got["fused"] = (np.asarray(vol.tsdf), np.asarray(vol.weight))
    return got


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    params = _perturbed(_gt_params())
    work_dir = str(tmp_path_factory.mktemp("dp_files"))
    ranks = dryrun.run_ranks(4, _rank_cases, params, work_dir, device="cpu", threads=1,
                             timeout=600)

    # the single-device fusion with files, in this process
    single_dir = str(tmp_path_factory.mktemp("single_files"))
    vol = _volume()
    for camera, depth in t_mesh_extraction.iter_fused_depths(
            t_renderers.make({"name": "vanilla_renderer"}, device="cpu"), _port_model(params),
            _port_cameras(), single_dir):
        t_tsdf.integrate(vol, depth, camera.intrinsics, camera.extrinsics)
    return {"ranks": ranks, "jax": _jax_runs(params), "work_dir": work_dir,
            "single_dir": single_dir, "single_volume": (vol.tsdf.numpy(), vol.weight.numpy())}


def _stack_over_dp(ranks, name):
    """The whole stack of views from the dp ranks' blocks (gs rank 0 of each)."""
    blocks = {r["dp_rank"]: r[name] for r in ranks}
    return {k: np.concatenate([blocks[d][k] for d in sorted(blocks)]) for k in blocks[0]}


@pytest.mark.parametrize("name", ["vanilla_renderer", "surfel_renderer"])
def test_dp_render_matches_jax(runs, name):
    got, want = _stack_over_dp(runs["ranks"], name), runs["jax"][name]
    assert set(got) == set(want)
    for k, v in got.items():
        np.testing.assert_allclose(v, want[k], rtol=0, atol=1e-5, err_msg=k)


def test_dp_fuse_weights_match_jax(runs):
    np.testing.assert_array_equal(runs["ranks"][0]["fused"][1], runs["jax"]["fused"][1])


def test_dp_fuse_tsdf_matches_jax(runs):
    (tsdf, weight), (want, _) = runs["ranks"][0]["fused"], runs["jax"]["fused"]
    assert (weight > 0).sum() > 1000
    np.testing.assert_allclose(tsdf[weight > 0], want[weight > 0], rtol=0, atol=1e-5)


def test_fuse_views_dp_writes_the_single_device_file_names(runs):
    names = lambda d: sorted(os.path.relpath(os.path.join(r, f), d)  # noqa: E731
                             for r, _, fs in os.walk(d) for f in fs)
    assert names(runs["work_dir"]) == names(runs["single_dir"])
    assert len(names(runs["work_dir"])) == 3 * N_CAMS


def test_fuse_views_dp_with_files_matches_the_single_device_volume(runs):
    (tsdf, weight), (want, want_w) = runs["ranks"][0]["work_dir_volume"], runs["single_volume"]
    np.testing.assert_array_equal(weight, want_w)
    np.testing.assert_allclose(tsdf[weight > 0], want[weight > 0], rtol=0, atol=1e-5)


def test_extract_mesh_marches_on_rank_0_only(runs):
    faces = [r["mesh_faces"] for r in runs["ranks"]]
    assert faces[0] > 0 and faces[1:] == [None, None, None]


def test_dryrun_runs_every_path(runs):
    """dryrun_rank on the 4 ranks: the step on every (dp, gs) split with gs
    in {1, 2, 4}, the DPTrainer's schedule through a densify, the
    camera-parallel render, fusion and surfel render."""
    report = runs["ranks"][0]["dryrun"]
    assert sorted(report["train_step"]) == ["1x4", "2x2", "4x1"]
    assert np.isfinite([x for v in report["train_step"].values() for x in v]).all()
    assert report["schedule"][-1] > report["schedule"][0]
    assert report["render_shape"] == (1, 3, 32, 32) and report["fused_weight"] > 0
