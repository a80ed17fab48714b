"""The other sixteen dataset formats (port of
gaustudio_tpu/datasets/more_formats.py): nerfstudio, mushroom, neus, nsvf,
deepvoxels, scannet, polycam, kiri, navi, mobilebrick, mvsnet, nero, nisr,
waymo, rtmv and trellis. Each parses its layout into host cameras
(``device="cpu"``; the trainer and the renderer move what they read) and
ends in the nerf++ normalisation, as the JAX loaders do.

The JAX loaders read through OpenCV; here the port's decoders stand in:
``cv2.imread`` + BGR -> RGB is ``utils/image.load_rgb8``, a 16-bit depth
PNG read unchanged is ``load_samples``, a mask is ``load_grey8`` thresholded
at > 1 and resized by ``resize_linear_u8`` (OpenCV's ``INTER_LINEAR``), and
``cv2.decomposeProjectionMatrix`` is an RQ decomposition in numpy
(:func:`decompose_projection_matrix`). Without PIL the decoders read PNGs
only. rtmv and trellis read EXR frames through ``cv2`` with
``OPENCV_IO_ENABLE_OPENEXR``, as the JAX package does, and raise where
``cv2`` does not import.
"""

from __future__ import annotations

import json
import math
import os
import pickle
from pathlib import Path
from typing import Dict

import numpy as np
import torch

from gaustudio_torch import datasets
from gaustudio_torch.cameras import Camera, focal2fov
from gaustudio_torch.datasets.base import CameraDataset
from gaustudio_torch.datasets.utils import getNerfppNorm
from gaustudio_torch.utils.image import load_grey8, load_rgb8, load_samples, resize_linear_u8


def _tensor(a):
    return None if a is None else torch.from_numpy(np.ascontiguousarray(a, np.float32))


def _camera(R, T, fx, fy, width, height, cx=None, cy=None, image=None, **kw) -> Camera:
    """A host camera of a pinhole (fx, fy, cx, cy); the principal point at
    the centre where cx is None."""
    ppn = (0.5, 0.5) if cx is None else (cx / width, cy / height)
    kw = {k: _tensor(v) if isinstance(v, np.ndarray) else v for k, v in kw.items()}
    return Camera(R=R, T=T, FoVx=focal2fov(fx, width), FoVy=focal2fov(fy, height),
                  image_width=width, image_height=height, principal_point_ndc=ppn,
                  image=_tensor(image), device="cpu", **kw)


def _imread_rgb(path):
    """float32 [H, W, 3] in [0, 1]."""
    return load_rgb8(str(path)).astype(np.float32) / 255.0


def _read_depth_mm(path):
    """A 16-bit depth PNG in millimetres -> float32 metres."""
    return load_samples(str(path)).astype(np.float32) / 1000.0


def _read_mask(path, width, height):
    """A grey mask thresholded at > 1 and resized to (width, height):
    float32 in [0, 1]."""
    mask = np.where(load_grey8(str(path)) > 1, 255, 0).astype(np.uint8)
    if mask.shape != (height, width):
        mask = resize_linear_u8(mask, width, height)
    return mask.astype(np.float32) / 255.0


def _c2w_to_rt(c2w):
    extr = np.linalg.inv(c2w)
    return np.transpose(extr[:3, :3]), extr[:3, 3]


def _import_cv2_for_exr(fmt: str):
    os.environ["OPENCV_IO_ENABLE_OPENEXR"] = "1"
    try:
        import cv2
    except ImportError as e:
        raise ImportError(f"the {fmt} loader reads EXR frames through OpenCV (cv2), which "
                          "does not import") from e
    return cv2


@datasets.register("nerfstudio")
class NerfStudioDataset(CameraDataset):
    """transforms.json with per-frame intrinsics, optional masks
    (``mask_path``, with ``w_mask``) and 16-bit depths (``depth_file_path``)."""

    transform_path = "transforms.json"

    def __init__(self, config: Dict):
        self.source_path = Path(config["source_path"])
        self.image_path = self.source_path
        self.masks_dir = self.source_path
        self.white_background = config.get("white_background", False)
        self.w_mask = config.get("w_mask", False)
        self._initialize()

    def _initialize(self):
        with open(self.source_path / self.transform_path) as f:
            meta = json.load(f)
        cams = []
        for frame in meta["frames"]:
            width, height = int(frame["w"]), int(frame["h"])
            image = _imread_rgb(self.image_path / frame["file_path"])

            mask = bg_image = None
            if self.w_mask and "mask_path" in frame:
                mp = self.masks_dir / frame["mask_path"]
                if mp.exists():
                    mask = _read_mask(mp, width, height)
                    bg_image = image * (1.0 - mask[..., None])
            if bg_image is None:
                bg_image = np.full((height, width, 3), 1.0 if self.white_background else 0.0,
                                   np.float32)

            depth = None
            if "depth_file_path" in frame:
                dp = self.image_path / frame["depth_file_path"]
                if dp.exists():
                    depth = _read_depth_mm(dp)

            c2w = np.array(frame["transform_matrix"])
            c2w[:, 1:3] *= -1
            R, T = _c2w_to_rt(c2w)
            cams.append(_camera(R, T, frame["fl_x"], frame["fl_y"], width, height, frame["cx"],
                                frame["cy"], image=image, image_name=frame["file_path"],
                                bg_image=bg_image, mask=mask, depth=depth))
        self.all_cameras = cams
        self.finalize()


@datasets.register("mushroom")
class MuSHRoomDataset(NerfStudioDataset):
    """MuSHRoom: nerfstudio frames in transformations_colmap.json."""

    transform_path = "transformations_colmap.json"


def decompose_projection_matrix(P: np.ndarray):
    """A 3x4 projection matrix -> (K, R, C) as OpenCV's
    ``decomposeProjectionMatrix`` gives them: P[:, :3] = K R by an RQ
    decomposition with K's first two diagonal entries positive and
    K[2, 2] of the sign the decomposition leaves (OpenCV does not normalise
    it), and C [4, 1] the homogeneous camera centre, P's null vector
    (unnormalised; the caller divides by C[3])."""
    P = np.asarray(P, np.float64)
    M = P[:, :3]
    # RQ of M via QR of the row-reversed transpose
    flip = np.eye(3)[::-1]
    q, r = np.linalg.qr((flip @ M).T)
    K = flip @ r.T @ flip
    R = flip @ q.T
    # K's diagonal positive, as OpenCV's Givens-rotation RQ leaves it
    signs = np.diag(np.sign(np.where(np.diag(K) == 0, 1.0, np.diag(K))))
    K, R = K @ signs, signs @ R
    if np.linalg.det(R) < 0:  # OpenCV returns a proper rotation: the sign moves to K[2, 2]
        K[:, 2] *= -1
        R[2] *= -1
    _, _, vt = np.linalg.svd(P)
    C = vt[-1][:, None]
    return K, R, C


def load_K_Rt_from_P(P):
    """NeuS's ``load_K_Rt_from_P``: intrinsics [4, 4] (K / K[2, 2]) and the
    camera-to-world pose [4, 4] float32 of a 3x4 projection matrix."""
    K, R, t = decompose_projection_matrix(P)
    K = K / K[2, 2]
    intrinsics = np.eye(4)
    intrinsics[:3, :3] = K
    pose = np.eye(4, dtype=np.float32)
    pose[:3, :3] = R.transpose()
    pose[:3, 3] = (t[:3] / t[3])[:, 0]
    return intrinsics, pose


@datasets.register("neus")
class NeusDataset(CameraDataset):
    """NeuS: image/, mask/ and cameras_sphere.npz (world and scale
    matrices)."""

    def __init__(self, config: Dict):
        self.source_path = Path(config["source_path"])
        self.image_path = self.source_path / "image"
        self.mask_path = self.source_path / "mask"
        self.cams_path = self.source_path / "cameras_sphere.npz"
        self.w_mask = config.get("w_mask", False)
        self._initialize()

    def _initialize(self):
        cams_npz = np.load(self.cams_path)
        n_images = max(int(k.split("_")[-1]) for k in cams_npz.keys()) + 1
        cams = []
        for i in range(n_images):
            image_name = f"{i:06d}.png"
            image = _imread_rgb(self.image_path / image_name)
            height, width = image.shape[:2]
            mask = None
            mp = self.mask_path / f"{i:03d}.png"
            if self.w_mask and mp.exists():
                mask = _read_mask(mp, width, height)
                image = image * mask[..., None]
            P = (cams_npz[f"world_mat_{i}"] @ cams_npz[f"scale_mat_{i}"])[:3, :4]
            K, c2w = load_K_Rt_from_P(P)
            R, T = _c2w_to_rt(c2w)
            cams.append(_camera(R, T, K[0, 0], K[1, 1], width, height, K[0, 2], K[1, 2],
                                image=image, mask=mask, image_name=image_name))
        self.all_cameras = cams
        self.finalize()


class _PoseDirDataset(CameraDataset):
    """nsvf and deepvoxels: rgb/, pose/<id>.txt and intrinsics.txt."""

    image_subdir = "rgb"
    name_filter = None

    def __init__(self, config: Dict):
        self.source_path = Path(config["source_path"])
        self.image_dir = self.source_path / self.image_subdir
        self.pose_dir = self.source_path / "pose"
        self.intrinsic_path = self.source_path / "intrinsics.txt"
        files = os.listdir(self.image_dir)
        if self.name_filter:
            files = [f for f in files if f.startswith(self.name_filter)]
        self.image_filenames = sorted([self.image_dir / f for f in files],
                                      key=lambda fn: str(fn.stem).split("_")[-1])
        self._initialize()

    def _initialize(self):
        with open(self.intrinsic_path) as f:
            vals = f.readline().split()
            fx = fy = float(vals[0])
            cx, cy = float(vals[1]), float(vals[2])
        cams = []
        for image_path in self.image_filenames:
            image = _imread_rgb(image_path)
            height, width = image.shape[:2]
            c2w = np.loadtxt(self.pose_dir / f"{image_path.stem}.txt").reshape(4, 4)
            R, T = _c2w_to_rt(c2w)
            cams.append(_camera(R, T, fx, fy, width, height, cx, cy, image=image,
                                image_name=image_path.name))
        self.all_cameras = cams
        self.finalize()


@datasets.register("nsvf")
class NSVFDataset(_PoseDirDataset):
    """NSVF's 0_train split."""

    name_filter = "0_train"


@datasets.register("deepvoxels")
class DeepVoxelsDataset(_PoseDirDataset):
    """DeepVoxels."""

    name_filter = None


@datasets.register("scannet")
class ScannetDataset(CameraDataset):
    """ScanNet: color/, depth/<id>.png (16-bit millimetres, often smaller
    than the colour image), pose/ and intrinsic/intrinsic_color.txt. Sorted
    by the frame number, not by name; the normalisation is set here."""

    def __init__(self, config: Dict):
        self.source_path = Path(config["source_path"])
        image_dir = self.source_path / "color"
        pose_dir = self.source_path / "pose"
        depth_dir = self.source_path / "depth"
        intr = np.loadtxt(self.source_path / "intrinsic" / "intrinsic_color.txt")
        fx, fy, cx, cy = intr[0, 0], intr[1, 1], intr[0, 2], intr[1, 2]
        files = sorted(os.listdir(image_dir), key=lambda fn: int(Path(fn).stem))
        cams = []
        for fname in files:
            _id = int(Path(fname).stem)
            image = _imread_rgb(image_dir / fname)
            height, width = image.shape[:2]
            depth = _read_depth_mm(depth_dir / f"{_id}.png")
            R, T = _c2w_to_rt(np.loadtxt(pose_dir / f"{_id}.txt"))
            cams.append(_camera(R, T, fx, fy, width, height, cx, cy, image=image, depth=depth,
                                image_name=fname))
        self.all_cameras = cams
        self.all_cameras.sort(key=lambda c: int(Path(c.image_name).stem))
        self.nerf_normalization = getNerfppNorm(self.all_cameras)
        self.cameras_extent = self.nerf_normalization["radius"]
        self.cameras_center = self.nerf_normalization["translate"]
        self.cameras_min_extent = self.nerf_normalization["min_radius"]


@datasets.register("polycam")
class PolycamDataset(CameraDataset):
    """Polycam: keyframes/corrected_images and corrected_cameras/<id>.json
    (the pose's rows stored permuted, ARKit's axes)."""

    def __init__(self, config: Dict):
        self.source_path = Path(config["source_path"])
        image_dir = self.source_path / "keyframes" / "corrected_images"
        cameras_dir = self.source_path / "keyframes" / "corrected_cameras"
        files = sorted(os.listdir(image_dir), key=lambda fn: int(Path(fn).stem))
        cams = []
        for fname in files:
            with open(cameras_dir / f"{int(Path(fname).stem)}.json") as f:
                fj = json.load(f)
            c2w = np.array([
                [fj["t_20"], fj["t_21"], fj["t_22"], fj["t_23"]],
                [fj["t_00"], fj["t_01"], fj["t_02"], fj["t_03"]],
                [fj["t_10"], fj["t_11"], fj["t_12"], fj["t_13"]],
                [0, 0, 0, 1],
            ], dtype=np.float32)
            c2w[..., 2] *= -1
            c2w[..., 1] *= -1
            R, T = _c2w_to_rt(c2w)
            cams.append(_camera(R, T, fj["fx"], fj["fy"], fj["width"], fj["height"], fj["cx"],
                                fj["cy"], image_path=str(image_dir / fname), image_name=fname))
        self.all_cameras = cams
        self.finalize()


@datasets.register("kiri")
class KiriDataset(CameraDataset):
    """KIRI Engine's transforms.json, with optional 16-bit depths."""

    def __init__(self, config: Dict):
        self.source_path = Path(config["source_path"])
        with open(self.source_path / "transforms.json") as f:
            meta = json.load(f)
        cams = []
        for frame in meta["frames"]:
            image_name = frame["file_path"].lstrip("./")
            c2w = np.array(frame["transform_matrix"])
            c2w[:, 1:3] *= -1
            R, T = _c2w_to_rt(c2w)
            depth = None
            if "depth_file_path" in frame:
                dp = self.source_path / frame["depth_file_path"].lstrip("./")
                if dp.exists():
                    depth = _read_depth_mm(dp)
            cams.append(_camera(R, T, frame["fl_x"], frame["fl_y"], int(frame["w"]),
                                int(frame["h"]), frame["cx"], frame["cy"],
                                image_path=str(self.source_path / image_name),
                                image_name=image_name, depth=depth))
        self.all_cameras = cams
        self.finalize()


def _quat_to_rotmat_wxyz(q):
    w, x, y, z = q
    return np.array([
        [1 - 2 * y * y - 2 * z * z, 2 * x * y - 2 * w * z, 2 * x * z + 2 * w * y],
        [2 * x * y + 2 * w * z, 1 - 2 * x * x - 2 * z * z, 2 * y * z - 2 * w * x],
        [2 * x * z - 2 * w * y, 2 * y * z + 2 * w * x, 1 - 2 * x * x - 2 * y * y],
    ])


@datasets.register("navi")
class NAVIDataset(CameraDataset):
    """NAVI: annotations.json (quaternion poses), images/, and masks/ and
    depth/ PNGs read as stored (samples / 255 and millimetres)."""

    def __init__(self, config: Dict):
        self.source_path = Path(config["source_path"])
        image_dir = self.source_path / "images"
        with open(self.source_path / "annotations.json") as f:
            annotations = json.load(f)
        cams = []
        for anno in annotations:
            image_name = anno["filename"]
            png = image_name.replace(".jpg", ".png")
            mask_path = self.source_path / "masks" / png
            depth_path = self.source_path / "depth" / png
            mask = (load_samples(str(mask_path)).astype(np.float32) / 255.0
                    if mask_path.exists() else None)
            depth = _read_depth_mm(depth_path) if depth_path.exists() else None
            focal = anno["camera"]["focal_length"]
            width, height = anno["image_size"]
            c2w = np.eye(4)
            c2w[:3, :3] = _quat_to_rotmat_wxyz(np.array(anno["camera"]["q"]))
            c2w[:3, 3] = np.array(anno["camera"]["t"])
            R, T = _c2w_to_rt(c2w)
            cams.append(_camera(R, T, focal, focal, width, height,
                                image_path=str(image_dir / image_name), image_name=image_name,
                                mask=mask, depth=depth))
        self.all_cameras = cams
        self.finalize()


@datasets.register("mobilebrick")
class MobileBrickDataset(CameraDataset):
    """MobileBrick: image/, mask/, and per-frame pose/ and intrinsic/ txt."""

    def __init__(self, config: Dict):
        self.source_path = Path(config["source_path"])
        image_dir = self.source_path / "image"
        mask_dir = self.source_path / "mask"
        pose_dir = self.source_path / "pose"
        intr_dir = self.source_path / "intrinsic"
        self.w_mask = config.get("w_mask", False)
        files = sorted(os.listdir(image_dir), key=lambda fn: int(Path(fn).stem))
        cams = []
        for fname in files:
            _id = Path(fname).stem
            image = _imread_rgb(image_dir / fname)
            height, width = image.shape[:2]
            intr = np.loadtxt(intr_dir / f"{_id}.txt")
            R, T = _c2w_to_rt(np.loadtxt(pose_dir / f"{_id}.txt"))
            mask = None
            mp = mask_dir / f"{_id}.png"
            if self.w_mask and mp.exists():
                mask = _read_mask(mp, width, height)
                image = image * mask[..., None]
            cams.append(_camera(R, T, intr[0, 0], intr[1, 1], width, height, intr[0, 2],
                                intr[1, 2], image=image, mask=mask, image_name=fname))
        self.all_cameras = cams
        self.finalize()


def load_cam_mvsnet(file, max_d=256, interval_scale=1):
    """An MVSNet cam.txt -> (extrinsic [4, 4], intrinsic [3, 3])."""
    with open(file) as f:
        words = f.read().split()
    extrinsic = np.array([float(words[4 * i + j + 1]) for i in range(4)
                          for j in range(4)]).reshape(4, 4)
    intrinsic = np.array([float(words[3 * i + j + 18]) for i in range(3)
                          for j in range(3)]).reshape(3, 3)
    return extrinsic, intrinsic


@datasets.register("mvsnet")
class MvsnetDataset(CameraDataset):
    """MVSNet / BlendedMVS: blended_images/ (else images/) and
    cams/<id:08d>_cam.txt."""

    def __init__(self, config: Dict):
        self.source_path = Path(config["source_path"])
        image_dir = self.source_path / "blended_images"
        if not image_dir.exists():
            image_dir = self.source_path / "images"
        if not image_dir.exists():
            raise ValueError("No image directory found")
        cam_dir = self.source_path / "cams"
        files = sorted(os.listdir(image_dir), key=lambda fn: int(Path(fn).stem))
        cams = []
        for fname in files:
            image = _imread_rgb(image_dir / fname)
            height, width = image.shape[:2]
            w2c, K = load_cam_mvsnet(cam_dir / f"{int(Path(fname).stem):08d}_cam.txt")
            cams.append(_camera(np.transpose(w2c[:3, :3]), w2c[:3, 3], K[0, 0], K[1, 1], width,
                                height, K[0, 2], K[1, 2], image=image, image_name=fname))
        self.all_cameras = cams
        self.finalize()


@datasets.register("nero")
class NeRODataset(CameraDataset):
    """NeRO: <id>.png and <id>-camera.pkl (w2c [3, 4], K)."""

    def __init__(self, config: Dict):
        self.source_path = Path(config["source_path"])
        ids = sorted(int(f.stem.split("-")[0]) for f in self.source_path.glob("*-camera.pkl"))
        cams = []
        for _id in ids:
            with open(self.source_path / f"{_id}-camera.pkl", "rb") as f:
                cam = pickle.load(f)
            image = _imread_rgb(self.source_path / f"{_id}.png")
            height, width = image.shape[:2]
            extr = np.eye(4)
            extr[:3, :] = cam[0].astype(np.float32)
            K = cam[1].astype(np.float32)
            cams.append(_camera(np.transpose(extr[:3, :3]), extr[:3, 3], K[0, 0], K[1, 1], width,
                                height, K[0, 2], K[1, 2], image=image, image_name=f"{_id}.png"))
        self.all_cameras = cams
        self.finalize()


def load_from_log(file_path):
    """camera.log blocks of 7 lines: id, fx fy cx cy, a separator, the 4x4
    camera-to-world pose."""
    with open(file_path) as f:
        content = f.readlines()
    image_ids, intrinsics, extrinsics = [], [], []
    for line in range(0, len(content), 7):
        image_ids.append(int(content[line]))
        intrinsics.append([float(v) for v in content[line + 1].split()])
        extrinsics.append([[float(v) for v in content[line + 3 + r].split()] for r in range(4)])
    return image_ids, intrinsics, extrinsics


@datasets.register("nisr")
class NisrDataset(CameraDataset):
    """NISR: images/, mask/ and camera.log."""

    def __init__(self, config: Dict):
        self.source_path = Path(config["source_path"])
        image_path = self.source_path / "images"
        mask_path = self.source_path / "mask"
        self.w_mask = config.get("w_mask", False)
        cams = []
        for _id, K, c2w in zip(*load_from_log(self.source_path / "camera.log")):
            image_name = f"{_id}.png"
            image = _imread_rgb(image_path / image_name)
            height, width = image.shape[:2]
            mask = None
            mp = mask_path / image_name
            if self.w_mask and mp.exists():
                mask = _read_mask(mp, width, height)
                image = image * mask[..., None]
            R, T = _c2w_to_rt(np.array(c2w))
            cams.append(_camera(R, T, K[0], K[1], width, height, K[2], K[3], image=image,
                                mask=mask, image_name=image_name))
        self.all_cameras = cams
        self.finalize()


@datasets.register("waymo")
class WaymoDataset(CameraDataset):
    """Waymo: scenario.pt (a pickle of per-camera frames) and
    images/<camera>/<idx:08d>.jpg, the first ``camera_number`` cameras."""

    CAMERAS = ["camera_FRONT", "camera_FRONT_LEFT", "camera_FRONT_RIGHT",
               "camera_SIDE_LEFT", "camera_SIDE_RIGHT"]

    def __init__(self, config: Dict):
        self.path = Path(config["source_path"])
        self.camera_number = config.get("camera_number", 1)
        self.eval = config.get("eval", False)
        with open(self.path / "scenario.pt", "rb") as f:
            scenario_data = pickle.load(f)
        cams = []
        for camera_id in self.CAMERAS[: self.camera_number]:
            camera_data = scenario_data["observers"][camera_id]
            frames = camera_data["data"]
            for idx in range(camera_data["n_frames"]):
                image_path = self.path / "images" / camera_id / f"{idx:08d}.jpg"
                height, width = frames["hw"][idx]
                intr = frames["intr"][idx]
                R, T = _c2w_to_rt(np.asarray(frames["c2w"][idx]))
                cams.append(_camera(R, T, intr[0, 0], intr[1, 1], int(width), int(height),
                                    intr[0, 2], intr[1, 2],
                                    image_path=str(image_path) if image_path.exists() else None,
                                    image_name=f"{camera_id}/{idx:08d}.jpg"))
        self.all_cameras = cams
        self.finalize()


def _linear_to_srgb(img):
    out = np.where(img > 0.0031308, 1.055 * np.clip(img, 1e-8, None) ** (1 / 2.4) - 0.055,
                   12.92 * img)
    return np.clip(out, 0, 1)


@datasets.register("rtmv")
class RTMVDataset(CameraDataset):
    """RTMV: EXR renders (linear, shown as sRGB), .seg.exr masks and a
    camera json a frame, read through cv2."""

    def __init__(self, config: Dict):
        cv2 = _import_cv2_for_exr("rtmv")
        self.source_path = Path(config["source_path"])
        split_json = self.source_path / f"transforms_{config.get('split', 'train')}.json"
        if split_json.exists():
            with open(split_json) as f:
                frames = json.load(f)["frames"]
        else:
            frames = [{"file_path": str(p).split(".")[0]}
                      for p in self.source_path.glob("*.depth.exr")]
        cams = []
        for frame in frames:
            stem = frame["file_path"]
            image = cv2.imread(f"{stem}.exr", -1)
            if image is None:
                continue
            image = _linear_to_srgb(cv2.cvtColor(image, cv2.COLOR_BGR2RGB))
            seg = cv2.imread(f"{stem}.seg.exr", -1)
            mask = (seg[..., 0] < 1e6).astype(np.float32) if seg is not None else None
            with open(f"{stem}.json") as f:
                cd = json.load(f)["camera_data"]
            ci = cd["intrinsics"]
            c2w = np.array(cd["cam2world"]).T
            c2w[:, 1:3] *= -1
            R, T = _c2w_to_rt(c2w)
            cams.append(_camera(R, T, ci["fx"], ci["fy"], cd["width"], cd["height"], ci["cx"],
                                ci["cy"], image=image, mask=mask,
                                image_name=os.path.basename(stem)))
        self.all_cameras = cams
        self.finalize()


@datasets.register("trellis")
class TrellisDataset(CameraDataset):
    """TRELLIS renders: transforms.json and EXR (linear, shown as sRGB) or
    8-bit frames, read through cv2."""

    def __init__(self, config: Dict):
        cv2 = _import_cv2_for_exr("trellis")
        self.source_path = Path(config["source_path"])
        with open(self.source_path / "transforms.json") as f:
            meta = json.load(f)
        cams = []
        for frame in meta["frames"]:
            image = cv2.imread(str(self.source_path / frame["file_path"]), -1)
            if image is None:
                continue
            if image.dtype != np.uint8:
                image = _linear_to_srgb(image)
            else:
                image = image.astype(np.float32) / 255.0
            image = cv2.cvtColor(image[..., :3].astype(np.float32), cv2.COLOR_BGR2RGB)
            height, width = image.shape[:2]
            if "camera_angle_x" in meta:
                fx = fy = 0.5 * width / math.tan(0.5 * meta["camera_angle_x"])
            else:
                fx, fy = frame["fl_x"], frame["fl_y"]
            c2w = np.array(frame["transform_matrix"])
            c2w[:, 1:3] *= -1
            R, T = _c2w_to_rt(c2w)
            cams.append(_camera(R, T, fx, fy, width, height, image=image,
                                image_name=frame["file_path"]))
        self.all_cameras = cams
        self.finalize()
