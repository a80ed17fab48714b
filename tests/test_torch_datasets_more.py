"""The sixteen other dataset formats through the port on the CPU against the
JAX package: the registry, and each loader on a small synthetic layout (the
fixtures of tests/test_datasets_more.py, with masks and 16-bit depths where
the format has them, plus nerfstudio, nsvf, deepvoxels and scannet) read by
both packages. Per camera: pose, field of view, principal point, name, size,
image, mask, background and depth; per dataset: the extent and centre.

The JAX loaders decode through OpenCV and the port through its own decoders
(PIL where it imports): PNGs decode equal. A mask resized by OpenCV's
fixed-point bilinear filter may land one uint8 step from the port's rounded
float filter; a JPEG decoded by OpenCV's libjpeg and by PIL's may differ by a
few steps. Both tolerances are stated where they are used. Also here:
``decompose_projection_matrix`` against ``cv2.decomposeProjectionMatrix``,
and 16-bit PNGs written by ``write_png`` and read by OpenCV and by
``load_samples``.
"""

import json
import os
import pickle

import numpy as np
import pytest
import torch

from gaustudio_torch import datasets as t_datasets
from gaustudio_torch.datasets import more_formats as t_more
from gaustudio_torch.utils.image import load_samples, write_png
from gaustudio_tpu import datasets as j_datasets
from gaustudio_tpu.datasets import more_formats as j_more

cv2 = pytest.importorskip("cv2")

W, H = 32, 24
STEP = 1 / 255 + 1e-6  # one uint8 step
MASK_STEP_SHARE = 0.05  # of a resized mask's pixels, at most, may be one step off


def _rot(seed):
    rng = np.random.default_rng(seed)
    Q, _ = np.linalg.qr(rng.normal(size=(3, 3)))
    if np.linalg.det(Q) < 0:
        Q[:, 0] *= -1
    return Q


def _write_png(path, w=W, h=H, seed=0):
    rng = np.random.default_rng(seed)
    img = (rng.uniform(size=(h, w, 3)) * 255).astype(np.uint8)
    assert cv2.imwrite(str(path), img)


def _write_mask(path, w=W, h=H, seed=0):
    """A grey mask with every level the threshold tells apart (0, 1, 2, 255)
    and smooth blobs, at (w, h)."""
    rng = np.random.default_rng(100 + seed)
    yy, xx = np.mgrid[0:h, 0:w]
    m = np.where((xx - w * rng.uniform(0.3, 0.7)) ** 2 + (yy - h * rng.uniform(0.3, 0.7)) ** 2
                 < (0.3 * min(w, h)) ** 2, 255, 0).astype(np.uint8)
    m[0, :4] = [0, 1, 2, 255]
    assert cv2.imwrite(str(path), m)


def _write_depth(path, w=W, h=H, seed=0):
    rng = np.random.default_rng(200 + seed)
    write_png(str(path), rng.integers(0, 65535, size=(h, w)).astype(np.uint16))


def _c2w(seed, t):
    c2w = np.eye(4)
    c2w[:3, :3] = _rot(seed)
    c2w[:3, 3] = t
    return c2w


# --- fixtures: one function a format, writing its layout under root ---------

def _nerfstudio(root, transform="transforms.json", masks=True, depths=True):
    (root / "images").mkdir()
    (root / "masks").mkdir()
    (root / "depths").mkdir()
    frames = []
    for i in range(3):
        name = f"images/frame_{i:05d}.png"
        _write_png(root / name, seed=i)
        frame = {"file_path": name, "w": W, "h": H, "fl_x": 30.0 + i, "fl_y": 31.0,
                 "cx": 16.5, "cy": 11.0 + i, "transform_matrix": _c2w(i, [i * 0.4, 0.1, 1.5]).tolist()}
        if masks:
            # the masks at another size (not a whole ratio), resized by the loader
            _write_mask(root / f"masks/frame_{i:05d}.png", 19, 13, seed=i)
            frame["mask_path"] = f"masks/frame_{i:05d}.png"
        if depths:
            _write_depth(root / f"depths/frame_{i:05d}.png", seed=i)
            frame["depth_file_path"] = f"depths/frame_{i:05d}.png"
        frames.append(frame)
    (root / transform).write_text(json.dumps({"frames": frames}))
    return {"w_mask": True}


def _mushroom(root):
    return _nerfstudio(root, "transformations_colmap.json", masks=False)


def _neus(root):
    (root / "image").mkdir()
    (root / "mask").mkdir()
    K = np.array([[50.0, 0, 16.0], [0, 50.0, 12.0], [0, 0, 1.0]])
    npz = {}
    for i in range(3):
        R_wc = _rot(i)
        C = np.array([0.2 * i, -0.1, 2.0 + i])
        world_mat = np.eye(4)
        world_mat[:3, :4] = K @ np.hstack([R_wc, (-R_wc @ C)[:, None]])
        scale_mat = np.diag([1.5, 1.5, 1.5, 1.0])
        scale_mat[:3, 3] = [0.1, -0.2, 0.3]
        npz[f"world_mat_{i}"] = world_mat
        npz[f"scale_mat_{i}"] = scale_mat
        _write_png(root / "image" / f"{i:06d}.png", seed=i)
        _write_mask(root / "mask" / f"{i:03d}.png", W * 2, H * 2, seed=i)
    np.savez(root / "cameras_sphere.npz", **npz)
    return {"w_mask": True}


def _nisr(root):
    (root / "images").mkdir()
    (root / "mask").mkdir()
    lines = []
    for i in range(2):
        c2w = _c2w(i + 10, [0.1 * i, 0.0, 1.5])
        lines += [str(i), "50.0 51.0 16.0 12.0", "0 0"]
        lines += [" ".join(str(v) for v in c2w[r]) for r in range(4)]
        _write_png(root / "images" / f"{i}.png", seed=i)
        _write_mask(root / "mask" / f"{i}.png", seed=i)
    (root / "camera.log").write_text("\n".join(lines) + "\n")
    return {"w_mask": True}


def _nero(root):
    for i in range(2):
        R_wc = _rot(i + 20)
        C = np.array([0.0, 0.3 * i, 2.0])
        w2c = np.hstack([R_wc, (-R_wc @ C)[:, None]]).astype(np.float32)
        K = np.array([[40.0, 0, 16], [0, 41.0, 12], [0, 0, 1]], np.float32)
        with open(root / f"{i}-camera.pkl", "wb") as f:
            pickle.dump((w2c, K), f)
        _write_png(root / f"{i}.png", seed=i)
    return {}


def _mvsnet(root):
    (root / "blended_images").mkdir()
    (root / "cams").mkdir()
    for i in range(2):
        R_wc = _rot(i + 30)
        w2c = np.eye(4)
        w2c[:3, :3] = R_wc
        w2c[:3, 3] = -R_wc @ np.array([0.5, 0.0, 1.0 + i])
        K = np.array([[45.0, 0, 16], [0, 45.0, 12], [0, 0, 1]])
        txt = ["extrinsic"] + [" ".join(str(v) for v in row) for row in w2c]
        txt += ["intrinsic"] + [" ".join(str(v) for v in row) for row in K]
        (root / "cams" / f"{i:08d}_cam.txt").write_text("\n".join(txt) + "\n")
        _write_png(root / "blended_images" / f"{i}.png", seed=i)
    return {}


def _mobilebrick(root):
    """JPEG images (OpenCV's encoder), as tests/test_datasets_more.py writes
    them: the JAX loader decodes them through OpenCV, the port through PIL."""
    for sub in ["image", "mask", "pose", "intrinsic"]:
        (root / sub).mkdir()
    K = np.array([[55.0, 0, 16], [0, 55.0, 12], [0, 0, 1]])
    for i in range(2):
        name = f"{i:06d}"
        _write_png(root / "image" / f"{name}.jpg", seed=i)
        _write_mask(root / "mask" / f"{name}.png", seed=i)
        np.savetxt(root / "pose" / f"{name}.txt", _c2w(i + 40, [0, 0.2, 1.0 + i]))
        np.savetxt(root / "intrinsic" / f"{name}.txt", K)
    return {"w_mask": True}


def _polycam(root):
    img_dir = root / "keyframes" / "corrected_images"
    cam_dir = root / "keyframes" / "corrected_cameras"
    img_dir.mkdir(parents=True)
    cam_dir.mkdir(parents=True)
    for i in range(2):
        flip = _c2w(i + 50, [0.1, 0.2, 1.0 + i])
        flip[..., 1] *= -1
        flip[..., 2] *= -1
        rows = {"t_0%d" % j: flip[1, j] for j in range(4)}
        rows.update({"t_1%d" % j: flip[2, j] for j in range(4)})
        rows.update({"t_2%d" % j: flip[0, j] for j in range(4)})
        meta = {"width": W, "height": H, "fx": 50.0, "fy": 50.0, "cx": 16.0, "cy": 12.0, **rows}
        (cam_dir / f"{i}.json").write_text(json.dumps(meta))
        _write_png(img_dir / f"{i}.jpg", seed=i)
    return {}


def _kiri(root):
    (root / "images").mkdir()
    (root / "depth").mkdir()
    frames = []
    for i in range(2):
        name = f"images/k_{i}.png"
        _write_png(root / name, seed=i)
        _write_depth(root / f"depth/k_{i}.png", seed=i)
        frames.append({"file_path": "./" + name, "w": W, "h": H, "fl_x": 48.0, "fl_y": 48.0,
                       "cx": 16.0, "cy": 12.0, "depth_file_path": f"./depth/k_{i}.png",
                       "transform_matrix": _c2w(i + 60, [0, 0, 2.0 + i]).tolist()})
    (root / "transforms.json").write_text(json.dumps({"frames": frames}))
    return {}


def _navi(root):
    for sub in ("images", "masks", "depth"):
        (root / sub).mkdir()
    annos = []
    for i in range(2):
        name = f"n_{i}.jpg"
        _write_png(root / "images" / name, seed=i)
        if i == 0:  # the second view has neither: both stay None
            _write_mask(root / "masks" / f"n_{i}.png", seed=i)
            _write_depth(root / "depth" / f"n_{i}.png", seed=i)
        annos.append({"filename": name, "image_size": [W, H],
                      "camera": {"focal_length": 52.0, "q": [0.9, 0.1, -0.3, 0.2],
                                 "t": [0.0, 0.1 * i, 1.0]}})
    (root / "annotations.json").write_text(json.dumps(annos))
    return {}


def _waymo(root):
    intr = np.array([[60.0, 0, 16.5], [0, 61.0, 12], [0, 0, 1]])
    data = {"hw": [], "intr": [], "c2w": []}
    (root / "images" / "camera_FRONT").mkdir(parents=True)
    for i in range(3):
        data["hw"].append((H, W))
        data["intr"].append(intr)
        data["c2w"].append(_c2w(i + 70, [i * 1.0, 0, 0]))
        if i < 2:  # the third frame has no image file
            _write_png(root / "images" / "camera_FRONT" / f"{i:08d}.jpg", seed=i)
    with open(root / "scenario.pt", "wb") as f:
        pickle.dump({"observers": {"camera_FRONT": {"data": data, "n_frames": 3}}}, f)
    return {}


def _pose_dir(root, names):
    (root / "rgb").mkdir()
    (root / "pose").mkdir()
    (root / "intrinsics.txt").write_text("40.0 16.0 12.0 0.\n0. 0. 0.\n")
    for i, name in enumerate(names):
        _write_png(root / "rgb" / f"{name}.png", seed=i)
        np.savetxt(root / "pose" / f"{name}.txt", _c2w(i + 90, [0.3 * i, 0, 2.0]))
    return {}


def _nsvf(root):
    # 0_train is kept; 1_val is left out by the loader's split filter
    return _pose_dir(root, ["0_train_0002", "0_train_0000", "0_train_0001", "1_val_0000"])


def _deepvoxels(root):
    return _pose_dir(root, ["000002", "000000", "000001"])


def _scannet(root):
    """Colour at 32x24, depth at 16x12 (ScanNet's depth is smaller than its
    colour); frames named 0, 2 and 10 so a name sort would differ."""
    for sub in ("color", "depth", "pose", "intrinsic"):
        (root / sub).mkdir()
    np.savetxt(root / "intrinsic" / "intrinsic_color.txt",
               np.array([[30.0, 0, 16.0, 0], [0, 31.0, 12.0, 0], [0, 0, 1, 0], [0, 0, 0, 1]]))
    for k, i in enumerate((10, 0, 2)):
        _write_png(root / "color" / f"{i}.jpg", seed=k)
        _write_depth(root / "depth" / f"{i}.png", W // 2, H // 2, seed=k)
        np.savetxt(root / "pose" / f"{i}.txt", _c2w(k + 95, [0.2 * k, 0.1, 2.0]))
    return {}


def _rtmv(root):
    for i in range(2):
        stem = str(root / f"{i:05d}")
        cd = {"camera_data": {"width": W, "height": H,
                              "intrinsics": {"fx": 35.0, "fy": 36.0, "cx": 16.0, "cy": 12.5},
                              "cam2world": _c2w(i + 80, [0, 0, 3.0]).T.tolist()}}
        with open(stem + ".json", "w") as f:
            json.dump(cd, f)
    frames = [{"file_path": str(root / f"{i:05d}")} for i in range(2)]
    (root / "transforms_train.json").write_text(json.dumps({"frames": frames}))
    return {}


def _trellis(root):
    frames = []
    for i in range(2):
        name = f"r_{i}.png"
        _write_png(root / name, seed=i)
        frames.append({"file_path": name, "transform_matrix": _c2w(i + 85, [0.5 * i, 0, 2.5]).tolist()})
    (root / "transforms.json").write_text(json.dumps({"camera_angle_x": 0.8, "frames": frames}))
    return {}


FORMATS = {
    "nerfstudio": (_nerfstudio, 3), "mushroom": (_mushroom, 3), "neus": (_neus, 3),
    "nisr": (_nisr, 2), "nero": (_nero, 2), "mvsnet": (_mvsnet, 2),
    "mobilebrick": (_mobilebrick, 2), "polycam": (_polycam, 2), "kiri": (_kiri, 2),
    "navi": (_navi, 2), "waymo": (_waymo, 3), "nsvf": (_nsvf, 3),
    "deepvoxels": (_deepvoxels, 3), "scannet": (_scannet, 3), "rtmv": (_rtmv, 2),
    "trellis": (_trellis, 2),
}
# JPEG images decoded by OpenCV (JAX) and by PIL (the port): at most this
# many uint8 steps apart on a pixel
JPEG_STEPS = {"mobilebrick": 1}
RESIZED_MASKS = ("nerfstudio", "neus")


def _fake_exr_imread(real_imread):
    """rtmv's EXR frames (OpenCV reads EXR only with its codec enabled):
    seeded linear RGB and a segmentation whose top rows are background."""
    rgb = np.random.default_rng(3).uniform(0, 1, (H, W, 3)).astype(np.float32)
    seg = np.zeros((H, W, 3), np.float32)
    seg[:12, :, 0] = 2e6

    def imread(path, flags=None):
        p = str(path)
        if p.endswith(".seg.exr"):
            return seg
        if p.endswith(".exr"):
            return rgb
        return real_imread(p, flags) if flags is not None else real_imread(p)

    return imread


def _np(x):
    return None if x is None else (x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x))


def _assert_cameras_match(tc, jc, fmt):
    assert tc.image_name == jc.image_name
    assert (tc.image_width, tc.image_height) == (jc.image_width, jc.image_height)
    np.testing.assert_allclose(tc.R, jc.R, rtol=0, atol=1e-6)
    np.testing.assert_allclose(tc.T, jc.T, rtol=0, atol=1e-6)
    assert abs(tc.FoVx - jc.FoVx) < 1e-6 and abs(tc.FoVy - jc.FoVy) < 1e-6
    np.testing.assert_allclose(tc.principal_point_ndc, jc.principal_point_ndc, rtol=0, atol=1e-6)
    for field in ("world_view_transform", "full_proj_transform"):
        np.testing.assert_allclose(_np(getattr(tc, field)), _np(getattr(jc, field)), rtol=0,
                                   atol=1e-6, err_msg=field)
    for field in ("image", "bg_image", "mask", "depth"):
        t, j = _np(getattr(tc, field)), _np(getattr(jc, field))
        assert (t is None) == (j is None), field
        if t is None:
            continue
        assert t.shape == j.shape and t.dtype == np.float32, field
        if fmt in JPEG_STEPS and field == "image":
            np.testing.assert_allclose(t, j, rtol=0, atol=JPEG_STEPS[fmt] / 255 + 1e-6)
        elif fmt in RESIZED_MASKS and field in ("mask", "bg_image", "image"):
            np.testing.assert_allclose(t, j, rtol=0, atol=STEP, err_msg=field)
            assert (np.abs(t - j) > 1e-6).mean() <= MASK_STEP_SHARE, field
        else:
            np.testing.assert_array_equal(t, j, err_msg=field)
    if tc.image is not None:
        assert tc.image.device.type == "cpu"


def test_registry_has_the_jax_packages_names():
    assert sorted(t_datasets.keys()) == sorted(j_datasets.keys())
    assert len(t_datasets.keys()) == 19


@pytest.mark.parametrize("fmt", list(FORMATS))
def test_loader_matches_jax(fmt, tmp_path, monkeypatch):
    make, n = FORMATS[fmt]
    if fmt == "rtmv":
        monkeypatch.setattr(cv2, "imread", _fake_exr_imread(cv2.imread))
    conf = {"name": fmt, "source_path": str(tmp_path), **make(tmp_path)}
    tds, jds = t_datasets.make(conf), j_datasets.make(conf)
    assert len(tds) == len(jds) == n
    for tc, jc in zip(tds, jds):
        _assert_cameras_match(tc, jc, fmt)
    assert tds.cameras_extent == pytest.approx(jds.cameras_extent, abs=1e-6)
    np.testing.assert_allclose(tds.cameras_center, jds.cameras_center, rtol=0, atol=1e-6)
    assert tds.cameras_min_extent == pytest.approx(jds.cameras_min_extent, abs=1e-6)


def test_scannet_keeps_its_small_depth_and_numeric_order(tmp_path):
    tds = t_datasets.make({"name": "scannet", "source_path": str(tmp_path), **_scannet(tmp_path)})
    assert [c.image_name for c in tds] == ["0.jpg", "2.jpg", "10.jpg"]
    assert tds[0].depth.shape == (H // 2, W // 2) and tds[0].image.shape == (H, W, 3)
    assert tds[0].depth.max() > 60.0  # 16-bit millimetres, not 8-bit samples


def test_nerfstudio_masks_resize_within_one_step_of_opencv(tmp_path):
    """The mask path on its own: threshold at > 1, bilinear resize to the
    image's size. The share of pixels one step off is printed."""
    _nerfstudio(tmp_path)
    off = []
    for i in range(3):
        path = tmp_path / f"masks/frame_{i:05d}.png"
        got = t_more._read_mask(path, W, H)
        want = j_more._read_mask(path, W, H)
        np.testing.assert_allclose(got, want, rtol=0, atol=STEP)
        off.append((np.abs(got - want) > 1e-6).mean())
        assert got[0, 0] == 0.0 and set(np.unique(got)) >= {0.0, 1.0}
    print(f"resized masks: {max(off):.4f} of the pixels one uint8 step from OpenCV's")
    assert max(off) <= MASK_STEP_SHARE


@pytest.mark.parametrize("sign", [1.0, -1.0], ids=["positive", "negative"])
def test_decompose_projection_matrix_matches_opencv(sign):
    rng = np.random.default_rng(7 if sign > 0 else 8)
    for _ in range(25):
        K = np.array([[rng.uniform(20, 900), rng.uniform(-2, 2), rng.uniform(10, 500)],
                      [0, rng.uniform(20, 900), rng.uniform(10, 500)], [0, 0, 1]])
        t = rng.normal(size=3) * 3
        P = sign * rng.uniform(0.1, 10) * K @ np.hstack([_rot(int(rng.integers(1 << 30))), t[:, None]])
        Kc, Rc, Cc = cv2.decomposeProjectionMatrix(P)[:3]
        Kp, Rp, Cp = t_more.decompose_projection_matrix(P)
        np.testing.assert_allclose(Kp, Kc, rtol=1e-10, atol=1e-9 * np.abs(Kc).max())
        np.testing.assert_allclose(Rp, Rc, rtol=0, atol=1e-10)
        np.testing.assert_allclose(Cp[:3] / Cp[3], Cc[:3] / Cc[3], rtol=0, atol=1e-9)
        assert Kp[0, 0] > 0 and Kp[1, 1] > 0 and np.linalg.det(Rp) > 0
        for g, w in zip(t_more.load_K_Rt_from_P(P), j_more.load_K_Rt_from_P(P)):
            np.testing.assert_allclose(g, w, rtol=0, atol=1e-6)


def test_write_png_writes_16_bit_grey_as_opencv_reads_it(tmp_path):
    rng = np.random.default_rng(9)
    d = rng.integers(0, 65536, size=(7, 11)).astype(np.uint16)
    d[0, :3] = [0, 255, 65535]
    path = str(tmp_path / "d.png")
    write_png(path, d)
    read = cv2.imread(path, cv2.IMREAD_UNCHANGED)
    assert read.dtype == np.uint16
    np.testing.assert_array_equal(read, d)
    np.testing.assert_array_equal(load_samples(path), d)


def test_exr_formats_name_cv2_where_it_does_not_import(tmp_path, monkeypatch):
    import builtins

    real_import = builtins.__import__

    def no_cv2(name, *args, **kw):
        if name == "cv2":
            raise ImportError("No module named 'cv2'")
        return real_import(name, *args, **kw)

    monkeypatch.setattr(builtins, "__import__", no_cv2)
    for fmt in ("rtmv", "trellis"):
        with pytest.raises(ImportError, match=r"OpenCV \(cv2\)"):
            t_datasets.make({"name": fmt, "source_path": str(tmp_path)})
