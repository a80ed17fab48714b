"""gs-process-data and gs-init through both packages' ``main()`` on the CPU
(the port with ``--device cpu``), on a small nerfstudio capture written by
chip_smoke.write_capture: twelve 64x48 views of a sphere in three orbit
rings, with 16-bit depths, masks and sparse/0/points3D.bin. The files the
CLIs write (fused.ply and scales.bin; points3D.ply and cameras.json) are
compared, and the pose chain's end without points3D.bin."""

import json
import os
import shutil
import sys

import numpy as np
import pytest
import torch

import chip_smoke
from gaustudio_torch.ops import mesh_raster as t_mesh_raster
from gaustudio_torch.scripts import initialize as t_initialize
from gaustudio_torch.scripts import process_data as t_process_data
from gaustudio_torch.utils.ply import read_ply
from gaustudio_tpu.models.general import GeneralPointCloud as JGeneralPointCloud
from gaustudio_tpu.ops import mcubes as j_mcubes
from gaustudio_tpu.scripts import initialize as j_initialize
from gaustudio_tpu.scripts import process_data as j_process_data

W, H = 64, 48


def _sphere_views(cams):
    """(rgb, depth, opacity) of a unit sphere's mesh in each view: a seeded
    image, the rasterized depth and its silhouette."""
    lin = np.linspace(-1.5, 1.5, 24, dtype=np.float32)
    x, y, z = np.meshgrid(lin, lin, lin, indexing="ij")
    verts, faces = j_mcubes.marching_tetrahedra(np.sqrt(x * x + y * y + z * z) - 1.0, 0.0,
                                                origin=np.full(3, -1.5), voxel_size=lin[1] - lin[0])
    rng = np.random.default_rng(0)
    for cam in cams:
        depth = t_mesh_raster.rasterize_mesh(
            torch.from_numpy(verts), torch.from_numpy(faces.astype(np.int64)),
            cam.world_view_transform, cam.full_proj_transform, W, H).depth.numpy()
        yield rng.uniform(size=(H, W, 3)).astype(np.float32), depth, (depth > 0).astype(np.float32)


@pytest.fixture(scope="module")
def capture(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("capture") / "capture")
    cams = chip_smoke.capture_cameras(W, H, "cpu", per_ring=4)
    rng = np.random.default_rng(1)
    xyz = rng.normal(size=(300, 3)).astype(np.float32)
    xyz /= np.linalg.norm(xyz, axis=1, keepdims=True)
    chip_smoke.write_capture(root, cams, _sphere_views(cams), xyz,
                             rng.integers(0, 256, size=(300, 3)).astype(np.uint8))
    return root


def _copy(capture, tmp_path, name):
    dst = str(tmp_path / name)
    shutil.copytree(capture, dst)
    return dst


def _jax_main(main, argv, monkeypatch):
    monkeypatch.setattr(sys, "argv", ["prog"] + argv)
    return main()


def _columns(path):
    return {k: np.asarray(v) for k, v in read_ply(path)["vertex"].items()}


def _assert_clouds_match(t_path, j_path, colour_steps=0, colour_share=0.0):
    """Points within 1e-6, normals equal, colours within ``colour_steps``
    uint8 steps on at most ``colour_share`` of the points."""
    t, j = _columns(t_path), _columns(j_path)
    assert len(t["x"]) == len(j["x"]) > 100
    for k in ("x", "y", "z"):
        np.testing.assert_allclose(t[k], j[k], rtol=0, atol=1e-6, err_msg=k)
    for k in ("nx", "ny", "nz"):
        if k in j:
            np.testing.assert_array_equal(t[k], j[k])
    rgb_t, rgb_j = (np.stack([c[k] for k in ("red", "green", "blue")], 1).astype(int)
                    for c in (t, j))
    assert np.abs(rgb_t - rgb_j).max() <= colour_steps
    assert (rgb_t != rgb_j).any(1).mean() <= colour_share


def _assert_cameras_json_match(t_path, j_path):
    with open(t_path) as f:
        t = json.load(f)
    with open(j_path) as f:
        j = json.load(f)
    assert len(t) == len(j) == 12
    for a, b in zip(t, j):
        assert a.keys() == b.keys()
        for k in a:
            if isinstance(a[k], str):
                assert a[k] == b[k]
            else:
                np.testing.assert_allclose(a[k], b[k], rtol=0, atol=1e-6, err_msg=k)


# The JAX colour resize is PIL's bicubic, the port's torch's antialiased
# bicubic: at the depth initializer's downsample of 4 a colour may land one
# uint8 step apart, on at most this share of the points.
COLOUR_SHARE = 0.3


def test_process_data_depth_matches_jax(capture, tmp_path, monkeypatch):
    argv = ["--dataset", "nerfstudio", "-s", capture, "--init", "depth"]
    t_model = t_process_data.main(argv + ["-o", str(tmp_path / "t"), "--device", "cpu"])
    _jax_main(j_process_data.main, argv + ["-o", str(tmp_path / "j")], monkeypatch)
    _assert_clouds_match(tmp_path / "t" / "fused.ply", tmp_path / "j" / "fused.ply", 1,
                         COLOUR_SHARE)
    assert ((tmp_path / "t" / "scales.bin").read_bytes()
            == (tmp_path / "j" / "scales.bin").read_bytes())
    # one point a pixel of positive depth after the 4x nearest-exact downsample
    assert t_model.num_points == chip_smoke.downsampled_valid(_capture_depths(capture))
    assert t_model._xyz.device.type == "cpu"


def _capture_depths(capture):
    from gaustudio_torch.utils.image import load_samples

    with open(os.path.join(capture, "transforms.json")) as f:
        frames = json.load(f)["frames"]
    return [load_samples(os.path.join(capture, fr["depth_file_path"])) for fr in frames]


def test_process_data_gaussiansky_builds_the_default_shell(capture, tmp_path):
    model = t_process_data.main(["--dataset", "nerfstudio", "-s", capture, "-o", str(tmp_path),
                                 "--init", "gaussiansky", "--device", "cpu"])
    assert model.num_points == 100 ** 2 and model._xyz.device.type == "cpu"


def test_gs_init_depth_matches_jax(capture, tmp_path, monkeypatch):
    t_root, j_root = _copy(capture, tmp_path, "t"), _copy(capture, tmp_path, "j")
    argv = ["--dataset", "nerfstudio", "--initializer", "depth"]
    out = t_initialize.main(argv + ["-s", t_root, "-o", t_root, "--device", "cpu"])
    _jax_main(j_initialize.main, argv + ["-s", j_root, "-o", j_root], monkeypatch)
    assert out == os.path.join(t_root, "sparse", "0", "points3D.ply")
    _assert_clouds_match(out, os.path.join(j_root, "sparse", "0", "points3D.ply"), 1,
                         COLOUR_SHARE)
    _assert_cameras_json_match(os.path.join(t_root, "cameras.json"),
                               os.path.join(j_root, "cameras.json"))


def test_gs_init_visual_hull_matches_jax(capture, tmp_path, monkeypatch):
    """The JAX export raises for a cloud without colours, which the mesh
    initializer the hull goes through builds; the port writes white, so the
    JAX side is run again with its export given white colours."""
    t_root, j_root = _copy(capture, tmp_path, "t"), _copy(capture, tmp_path, "j")
    config = tmp_path / "hull.json"  # JSON is YAML for the JAX loader
    config.write_text(json.dumps({"geometry_initializer": {"resolution": 32}}))
    argv = ["--dataset", "nerfstudio", "-w", "--initializer", "VisualHull", "--config",
            str(config)]
    out = t_initialize.main(argv + ["-s", t_root, "-o", t_root, "--device", "cpu"])
    with pytest.raises(ValueError, match="cannot reshape array of size 0"):
        _jax_main(j_initialize.main, argv + ["-s", j_root, "-o", j_root], monkeypatch)

    export = JGeneralPointCloud.export

    def white_export(self, path):
        if not len(np.asarray(self._rgb)):
            self._rgb = np.ones_like(np.asarray(self._xyz))
        return export(self, path)

    monkeypatch.setattr(JGeneralPointCloud, "export", white_export)
    _jax_main(j_initialize.main, argv + ["-s", j_root, "-o", j_root], monkeypatch)
    _assert_clouds_match(out, os.path.join(j_root, "sparse", "0", "points3D.ply"))
    assert (_columns(out)["red"] == 255).all()
    _assert_cameras_json_match(os.path.join(t_root, "cameras.json"),
                               os.path.join(j_root, "cameras.json"))


def test_gs_init_without_points3d_ends_as_jax(capture, tmp_path, monkeypatch, capsys):
    """Without sparse/0/points3D.bin the pose chain runs SfM: hloc, then
    colmap, each failing and printed. On a nerfstudio capture both fail
    already in the cache, whose image names hold a directory ("images/...")
    that the workspace's images/ does not; both packages end in the same
    SystemExit."""
    t_root, j_root = _copy(capture, tmp_path, "t"), _copy(capture, tmp_path, "j")
    for root in (t_root, j_root):
        os.remove(os.path.join(root, "sparse", "0", "points3D.bin"))
    argv = ["--dataset", "nerfstudio", "--initializer", "VisualHull"]
    printed = []
    for run in (lambda: t_initialize.main(argv + ["-s", t_root, "-o", t_root, "--device", "cpu"]),
                lambda: _jax_main(j_initialize.main, argv + ["-s", j_root, "-o", j_root],
                                  monkeypatch)):
        with pytest.raises(SystemExit, match="All pose initializers failed"):
            run()
        printed.append([line.split(":")[0] for line in capsys.readouterr().out.splitlines()
                        if line.startswith("Error with")])
    assert printed[0] == printed[1] == ["Error with hloc pose initializer",
                                        "Error with colmap pose initializer"]
