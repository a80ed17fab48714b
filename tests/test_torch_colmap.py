"""COLMAP scenes in the port on the CPU, against the JAX package: the model
readers (binary and text), ColmapDataset's cameras, pixels, masks and depth
maps, and gs-train / gs-render through a COLMAP scene."""

import os
import warnings

import numpy as np
import pytest
import torch
from PIL import Image

from gaustudio_torch import datasets as t_datasets
from gaustudio_torch.datasets import utils as t_dsu
from gaustudio_torch.scripts import render as t_render_cli
from gaustudio_torch.scripts import train as t_train_cli
from gaustudio_tpu import datasets as j_datasets
from gaustudio_tpu.datasets import utils as j_dsu

W, H = 32, 24


def _rand_pose(rng):
    q, _ = np.linalg.qr(rng.normal(size=(3, 3)))
    if np.linalg.det(q) < 0:
        q[:, 0] *= -1
    return j_dsu.rotmat2qvec(q), rng.normal(size=3)


def _write_image(path, seed, w=W, h=H):
    rng = np.random.default_rng(seed)
    Image.fromarray((rng.uniform(size=(h, w, 3)) * 255).astype(np.uint8)).save(path)


def _scene(root, model="PINHOLE", params=(30.0, 31.0, 16.0, 12.0), n=3):
    """tests/test_datasets.py's COLMAP scene, written by the JAX writers."""
    rng = np.random.default_rng(0)
    sparse = root / "sparse" / "0"
    sparse.mkdir(parents=True)
    (root / "images").mkdir()
    j_dsu.write_intrinsics_binary(
        {1: j_dsu.ColmapCamera(1, model, W, H, np.array(params))}, sparse / "cameras.bin")
    ims = {}
    for i in range(n):
        qvec, tvec = _rand_pose(rng)
        name = f"im_{i:03d}.png"
        ims[i + 1] = j_dsu.ColmapImage(i + 1, qvec, tvec, 1, name,
                                       np.array([[1.0, 2.0], [3.0, 4.0]]),
                                       np.array([7, -1], np.int64))
        _write_image(root / "images" / name, seed=i)
    j_dsu.write_extrinsics_binary(ims, sparse / "images.bin")
    xyz = rng.normal(size=(20, 3)) * 0.3
    rgb = rng.integers(0, 255, size=(20, 3))
    j_dsu.write_points3D_binary(xyz, rgb, sparse / "points3D.bin")
    return root


@pytest.fixture
def colmap_scene(tmp_path):
    return _scene(tmp_path / "scene")


def test_binary_readers_match_jax(colmap_scene):
    sparse = colmap_scene / "sparse" / "0"
    for t_fn, j_fn, path in ((t_dsu.read_intrinsics_binary, j_dsu.read_intrinsics_binary,
                              "cameras.bin"),
                             (t_dsu.read_extrinsics_binary, j_dsu.read_extrinsics_binary,
                              "images.bin")):
        got, want = t_fn(sparse / path), j_fn(sparse / path)
        assert got.keys() == want.keys()
        for k in want:
            for g, w in zip(got[k], want[k]):
                np.testing.assert_array_equal(g, w)
    for g, w in zip(t_dsu.read_points3D_binary(sparse / "points3D.bin"),
                    j_dsu.read_points3D_binary(sparse / "points3D.bin")):
        np.testing.assert_array_equal(g, w)


def test_writers_match_jax(colmap_scene, tmp_path):
    sparse = colmap_scene / "sparse" / "0"
    cams = j_dsu.read_intrinsics_binary(sparse / "cameras.bin")
    ims = j_dsu.read_extrinsics_binary(sparse / "images.bin")
    xyz, rgb, _ = j_dsu.read_points3D_binary(sparse / "points3D.bin")
    t_dsu.write_intrinsics_binary(cams, tmp_path / "cameras.bin")
    t_dsu.write_extrinsics_binary(ims, tmp_path / "images.bin")
    t_dsu.write_points3D_binary(xyz, rgb, tmp_path / "points3D.bin")
    for name in ("cameras.bin", "images.bin", "points3D.bin"):
        assert (tmp_path / name).read_bytes() == (sparse / name).read_bytes(), name


def test_text_readers_match_jax(tmp_path):
    (tmp_path / "cameras.txt").write_text(
        "# comment\n1 SIMPLE_PINHOLE 64 48 50.0 32.0 24.0\n2 PINHOLE 64 48 50 51 32 24\n")
    (tmp_path / "images.txt").write_text(
        "# hdr\n1 1 0 0 0 0.5 0.5 0.5 1 a.png\n1.0 2.0 7 3.0 4.0 -1\n"
        "2 0.5 0.5 0.5 0.5 0 0 1 2 b.png\n\n")
    (tmp_path / "points3D.txt").write_text(
        "# hdr\n1 0.1 0.2 0.3 10 20 30 0.5 1 0\n2 1 2 3 4 5 6 0.25\n")
    for t_fn, j_fn, name in ((t_dsu.read_intrinsics_text, j_dsu.read_intrinsics_text,
                              "cameras.txt"),
                             (t_dsu.read_extrinsics_text, j_dsu.read_extrinsics_text,
                              "images.txt")):
        got, want = t_fn(tmp_path / name), j_fn(tmp_path / name)
        assert got.keys() == want.keys() and len(want) == 2
        for k in want:
            for g, w in zip(got[k], want[k]):
                np.testing.assert_array_equal(g, w)
    for g, w in zip(t_dsu.read_points3D_text(tmp_path / "points3D.txt"),
                    j_dsu.read_points3D_text(tmp_path / "points3D.txt")):
        np.testing.assert_array_equal(g, w)


def test_qvec_conversions_match_jax():
    rng = np.random.default_rng(2)
    for _ in range(10):
        q, _ = _rand_pose(rng)
        np.testing.assert_array_equal(t_dsu.qvec2rotmat(q), j_dsu.qvec2rotmat(q))
        R = j_dsu.qvec2rotmat(q)
        np.testing.assert_allclose(t_dsu.rotmat2qvec(R), j_dsu.rotmat2qvec(R), atol=1e-12)


def _assert_cameras_match(tds, jds, pixel_atol=0.0):
    assert len(tds) == len(jds)
    for t, j in zip(tds, jds):
        assert t.image_name == j.image_name
        assert (t.image_width, t.image_height) == (j.image_width, j.image_height)
        np.testing.assert_allclose(t.R, j.R, atol=1e-6)
        np.testing.assert_allclose(t.T, j.T, atol=1e-6)
        assert abs(t.FoVx - j.FoVx) < 1e-6 and abs(t.FoVy - j.FoVy) < 1e-6
        np.testing.assert_allclose(t.principal_point_ndc, j.principal_point_ndc, atol=1e-6)
        for field in ("world_view_transform", "full_proj_transform"):
            np.testing.assert_allclose(getattr(t, field).numpy(), getattr(j, field), atol=1e-6)
        assert t.image.device.type == "cpu"
        for field in ("image", "bg_image", "mask"):
            np.testing.assert_allclose(getattr(t, field).numpy(), getattr(j, field),
                                       atol=pixel_atol, rtol=0, err_msg=field)
    assert tds.cameras_extent == pytest.approx(jds.cameras_extent, abs=1e-9)


@pytest.mark.parametrize("model, params", [
    ("PINHOLE", (30.0, 31.0, 16.0, 12.0)),
    ("SIMPLE_PINHOLE", (30.0, 15.0, 13.0)),
    ("OPENCV", (30.0, 31.0, 16.0, 12.0, 0.1, 0.01, 0.0, 0.0)),
])
@pytest.mark.parametrize("white", [False, True], ids=["black", "white"])
def test_dataset_cameras_and_pixels_match_jax(model, params, white, tmp_path):
    root = _scene(tmp_path / "scene", model, params)
    conf = {"name": "colmap", "source_path": str(root), "white_background": white}
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        tds = t_datasets.make(conf)
    assert any("OpenCV camera model" in str(w.message) for w in caught) == (model == "OPENCV")
    jds = j_datasets.make(conf)
    _assert_cameras_match(tds, jds)


def test_dataset_resolution_matches_jax(colmap_scene):
    conf = {"name": "colmap", "source_path": str(colmap_scene), "resolution": 2}
    tds, jds = t_datasets.make(conf), j_datasets.make(conf)
    assert tds[0].image_width == W // 2
    # C1's tolerance: the antialiased bicubic resize against PIL's
    _assert_cameras_match(tds, jds, pixel_atol=1 / 255 + 1e-6)


@pytest.mark.parametrize("mask_size", [(W, H), (W // 2, H // 2)], ids=["same", "resized"])
def test_dataset_masks_and_depths_match_jax(colmap_scene, mask_size):
    """Masks (grey PNGs, thresholded at > 1) and 16-bit depth PNGs in
    millimetres. A mask of another size is resized bilinearly to the
    image's: the port rounds where OpenCV's fixed-point arithmetic may land
    one level apart, so the resized mask is held within 1/255 and its
    background image on all but 2% of the pixels."""
    rng = np.random.default_rng(5)
    (colmap_scene / "masks").mkdir()
    (colmap_scene / "depths").mkdir()
    for i in range(3):
        m = rng.integers(0, 4, size=mask_size[::-1]).astype(np.uint8) * 85
        m[0, :4] = [0, 1, 2, 3]  # the threshold keeps values above 1
        Image.fromarray(m).save(colmap_scene / "masks" / f"im_{i:03d}.png")
        d = rng.integers(0, 65535, size=(H, W)).astype(np.uint16)
        Image.fromarray(d).save(colmap_scene / "depths" / f"im_{i:03d}.png")
    conf = {"name": "colmap", "source_path": str(colmap_scene), "masks": "masks"}
    tds, jds = t_datasets.make(conf), j_datasets.make(conf)
    for t, j in zip(tds, jds):
        np.testing.assert_array_equal(t.image.numpy(), j.image)
        np.testing.assert_array_equal(t.depth.numpy(), j.depth)
        assert t.depth.max() > 60.0  # uint16 millimetres, not 8-bit samples
        if mask_size == (W, H):
            np.testing.assert_array_equal(t.mask.numpy(), j.mask)
            np.testing.assert_array_equal(t.bg_image.numpy(), j.bg_image)
            assert set(np.unique(j.mask)) == {0.0, 1.0}
            assert (t.mask[0, :4] == torch.tensor([0.0, 0.0, 1.0, 1.0])).all()
        else:
            np.testing.assert_allclose(t.mask.numpy(), j.mask, atol=1 / 255 + 1e-6, rtol=0)
            assert (t.bg_image.numpy() != j.bg_image).any(-1).mean() <= 0.02


def test_text_model_scene_matches_jax(colmap_scene):
    """A scene whose model is text only: cameras.txt and images.txt."""
    sparse = colmap_scene / "sparse" / "0"
    cam = j_dsu.read_intrinsics_binary(sparse / "cameras.bin")[1]
    ims = j_dsu.read_extrinsics_binary(sparse / "images.bin")
    (sparse / "cameras.txt").write_text(
        f"1 {cam.model} {cam.width} {cam.height} " + " ".join(repr(float(p)) for p in cam.params)
        + "\n")
    (sparse / "images.txt").write_text("".join(
        f"{im.id} " + " ".join(repr(float(x)) for x in [*im.qvec, *im.tvec]) + f" 1 {im.name}\n\n"
        for im in ims.values()))
    for name in ("cameras.bin", "images.bin"):
        os.remove(sparse / name)
    conf = {"name": "colmap", "source_path": str(colmap_scene)}
    _assert_cameras_match(t_datasets.make(conf), j_datasets.make(conf))


def test_gs_train_from_colmap_points(colmap_scene, tmp_path):
    """gs-train --dataset colmap starts from sparse/0/points3D.bin and
    trains a few iterations on the CPU."""
    out = tmp_path / "out"
    history = t_train_cli.main(["-s", str(colmap_scene), "-o", str(out), "--dataset", "colmap",
                                "--iterations", "4", "--save_every", "4", "--device", "cpu"])
    assert np.isfinite(history[-1]["loss"]) and history[-1]["iter"] == 4
    from gaustudio_torch.utils.ply import read_ply

    v = read_ply(str(out / "point_cloud" / "iteration_4" / "point_cloud.ply"))["vertex"]
    xyz, _, _ = j_dsu.read_points3D_binary(colmap_scene / "sparse" / "0" / "points3D.bin")
    assert len(v["x"]) == len(xyz) == 20
    assert (out / "cameras.json").exists()


def test_gs_render_from_a_colmap_scene(colmap_scene, tmp_path):
    """gs-render -s <COLMAP dir> renders one PNG per COLMAP image."""
    from gaustudio_torch import models

    pcd = models.make({"name": "vanilla_pcd"}, device="cpu")
    xyz, rgb, _ = t_dsu.read_points3D_binary(colmap_scene / "sparse" / "0" / "points3D.bin")
    pcd.create_from_attribute(xyz=xyz.astype(np.float32), rgb=(rgb / 255.0).astype(np.float32))
    ply = str(tmp_path / "model.ply")
    pcd.export(ply)
    path = t_render_cli.main(["-m", ply, "-s", str(colmap_scene), "-o", str(tmp_path / "r"),
                              "--device", "cpu"])
    assert sorted(os.listdir(path)) == ["im_000.png", "im_001.png", "im_002.png"]
