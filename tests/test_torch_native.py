"""gaustudio_torch.utils.native (the port's own gsio.cpp, built with g++ into
gaustudio_torch/build/) against the JAX package's native and Python COLMAP
readers: the same arrays, colours as int64; native/ is left as it was."""

import os

import numpy as np
import pytest

from gaustudio_torch.datasets import utils as t_dsu
from gaustudio_torch.utils import native as t_native
from gaustudio_tpu.datasets import utils as j_dsu
from gaustudio_tpu.utils import native as j_native

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _model(tmp_path, n_points=50, n_images=4):
    rng = np.random.default_rng(0)
    xyz = rng.normal(size=(n_points, 3))
    rgb = rng.integers(0, 256, (n_points, 3))
    t_dsu.write_points3D_binary(xyz, rgb, tmp_path / "points3D.bin",
                                errors=rng.uniform(0, 2, n_points))
    ims = {}
    for i in range(n_images):
        q = rng.normal(size=4)
        q /= np.linalg.norm(q)
        ims[i + 1] = t_dsu.ColmapImage(
            i + 1, q, rng.normal(size=3), 1 + i % 2, f"img_{i:03d}.png",
            rng.normal(size=(i * 3, 2)), rng.integers(-1, 100, i * 3).astype(np.int64))
    t_dsu.write_extrinsics_binary(ims, tmp_path / "images.bin")
    return xyz, rgb, ims


def _listing(path):
    return sorted((e.name, e.stat().st_mtime_ns) for e in os.scandir(path))


def test_native_builds_into_the_ports_build_dir_and_leaves_native_alone(tmp_path, monkeypatch):
    """A fresh build goes into the port's build directory, from the port's
    copy of gsio.cpp; native/ (the JAX package's, with the library its
    loader builds there) keeps its listing and mtimes."""
    assert j_native.available()  # the JAX package's own build, before the listing
    before = _listing(os.path.join(REPO, "native"))
    build = tmp_path / "build"
    monkeypatch.setattr(t_native, "BUILD_DIR", str(build))
    monkeypatch.setattr(t_native, "_lib", None)
    monkeypatch.setattr(t_native, "_tried", False)
    assert t_native.available(), t_native.build_error
    assert os.path.dirname(t_native.library_path()) == str(build)
    assert os.listdir(build) == [os.path.basename(t_native.library_path())]
    assert t_native.SOURCE == os.path.join(REPO, "gaustudio_torch", "native", "gsio.cpp")
    assert _listing(os.path.join(REPO, "native")) == before


def test_native_readers_match_jax_native_and_python(tmp_path):
    xyz, rgb, ims = _model(tmp_path)
    assert t_native.available(), t_native.build_error
    got = t_native.read_points3d_binary(str(tmp_path / "points3D.bin"))
    py = t_dsu.read_points3D_binary_python(tmp_path / "points3D.bin")
    for want in (j_native.read_points3d_binary(str(tmp_path / "points3D.bin")),
                 j_dsu.read_points3D_binary(tmp_path / "points3D.bin"), py):
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g, w)
    # one dtype on both port paths: float64 points and errors, int64 colours
    # (the JAX native reader's colours are float64, its Python reader's int64)
    for g, p in zip(got, py):
        assert g.dtype == p.dtype and g.shape == p.shape
    assert [a.dtype for a in got] == [np.float64, np.int64, np.float64]
    np.testing.assert_array_equal(got[0], xyz)
    np.testing.assert_array_equal(got[1], rgb)

    got = t_native.read_images_binary(str(tmp_path / "images.bin"))
    want_native = j_native.read_images_binary(str(tmp_path / "images.bin"))
    py = t_dsu.read_extrinsics_binary_python(tmp_path / "images.bin")
    assert sorted(got) == sorted(want_native) == sorted(py) == sorted(ims)
    for k, (q, t, cid, name, xys, pids) in got.items():
        for g, w in zip((q, t, cid, name, xys, pids), want_native[k]):
            np.testing.assert_array_equal(g, w)
        for g, w in zip((k, q, t, cid, name, xys, pids), py[k]):
            np.testing.assert_array_equal(g, w)
            assert np.asarray(g).dtype == np.asarray(w).dtype
        assert xys.shape == (3 * (k - 1), 2) and pids.dtype == np.int64


def test_dataset_readers_take_the_native_path_and_fall_back(tmp_path, monkeypatch):
    """read_points3D_binary and read_extrinsics_binary go through the native
    readers where the library is built; without a compiler the readers
    return None, build_error holds why, and the Python paths give the same
    arrays."""
    _model(tmp_path)
    calls = []
    read = t_native.read_points3d_binary
    monkeypatch.setattr(t_native, "read_points3d_binary",
                        lambda path: calls.append(path) or read(path))
    native_pts = t_dsu.read_points3D_binary(tmp_path / "points3D.bin")
    native_ims = t_dsu.read_extrinsics_binary(tmp_path / "images.bin")
    assert calls == [tmp_path / "points3D.bin"]
    monkeypatch.undo()

    monkeypatch.setattr(t_native, "BUILD_DIR", str(tmp_path / "build"))
    monkeypatch.setattr(t_native, "_lib", None)
    monkeypatch.setattr(t_native, "_tried", False)
    monkeypatch.setenv("CXX", str(tmp_path / "no-such-compiler"))
    assert not t_native.available()
    assert "no-such-compiler" in t_native.build_error
    assert t_native.read_points3d_binary(str(tmp_path / "points3D.bin")) is None
    assert t_native.read_images_binary(str(tmp_path / "images.bin")) is None
    for g, w in zip(t_dsu.read_points3D_binary(tmp_path / "points3D.bin"), native_pts):
        np.testing.assert_array_equal(g, w)
        assert g.dtype == w.dtype
    py_ims = t_dsu.read_extrinsics_binary(tmp_path / "images.bin")
    assert sorted(py_ims) == sorted(native_ims)
    for k in py_ims:
        for g, w in zip(py_ims[k], native_ims[k]):
            np.testing.assert_array_equal(g, w)


@pytest.mark.parametrize("what", ["points3D.bin", "images.bin"])
def test_native_readers_raise_on_a_truncated_file(tmp_path, what):
    _model(tmp_path)
    data = (tmp_path / what).read_bytes()
    (tmp_path / what).write_bytes(data[:len(data) // 2])
    reader = (t_native.read_points3d_binary if what == "points3D.bin"
              else t_native.read_images_binary)
    with pytest.raises(IOError):
        reader(str(tmp_path / what))


def test_empty_points3d_reads_as_int64_colours(tmp_path):
    t_dsu.write_points3D_binary(np.zeros((0, 3)), np.zeros((0, 3)), tmp_path / "points3D.bin")
    for reader in (t_dsu.read_points3D_binary, t_dsu.read_points3D_binary_python):
        xyz, rgb, err = reader(tmp_path / "points3D.bin")
        assert xyz.shape == (0, 3) and rgb.shape == (0, 3) and err.shape == (0, 1)
        assert rgb.dtype == np.int64
