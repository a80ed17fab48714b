"""COLMAP model IO, cameras.json interop and scene normalisation (port of
gaustudio_tpu/datasets/utils.py).

The binary COLMAP readers of images.bin and points3D.bin take the native
parser (utils/native.py) where it is built, and the JAX package's
pure-Python paths otherwise; both give the same arrays, the colours of
points3D as int64.
"""

from __future__ import annotations

import collections
import struct
from typing import Dict

import numpy as np

from gaustudio_torch.cameras import Camera, focal2fov, fov2focal, getWorld2View2
from gaustudio_torch.utils import native


CameraModel = collections.namedtuple("CameraModel", ["model_id", "model_name", "num_params"])
ColmapCamera = collections.namedtuple("ColmapCamera", ["id", "model", "width", "height", "params"])
ColmapImage = collections.namedtuple(
    "ColmapImage", ["id", "qvec", "tvec", "camera_id", "name", "xys", "point3D_ids"])

CAMERA_MODELS = [
    CameraModel(0, "SIMPLE_PINHOLE", 3),
    CameraModel(1, "PINHOLE", 4),
    CameraModel(2, "SIMPLE_RADIAL", 4),
    CameraModel(3, "RADIAL", 5),
    CameraModel(4, "OPENCV", 8),
    CameraModel(5, "OPENCV_FISHEYE", 8),
    CameraModel(6, "FULL_OPENCV", 12),
    CameraModel(7, "FOV", 5),
    CameraModel(8, "SIMPLE_RADIAL_FISHEYE", 4),
    CameraModel(9, "RADIAL_FISHEYE", 5),
    CameraModel(10, "THIN_PRISM_FISHEYE", 12),
]
CAMERA_MODEL_IDS = {m.model_id: m for m in CAMERA_MODELS}
CAMERA_MODEL_NAMES = {m.model_name: m for m in CAMERA_MODELS}


def qvec2rotmat(qvec):
    """COLMAP quaternion (w, x, y, z) -> rotation matrix."""
    w, x, y, z = qvec
    return np.array(
        [
            [1 - 2 * y * y - 2 * z * z, 2 * x * y - 2 * w * z, 2 * z * x + 2 * w * y],
            [2 * x * y + 2 * w * z, 1 - 2 * x * x - 2 * z * z, 2 * y * z - 2 * w * x],
            [2 * z * x - 2 * w * y, 2 * y * z + 2 * w * x, 1 - 2 * x * x - 2 * y * y],
        ]
    )


def rotmat2qvec(R):
    """Rotation matrix -> COLMAP quaternion (w >= 0), by the eigenvector method."""
    Rxx, Ryx, Rzx, Rxy, Ryy, Rzy, Rxz, Ryz, Rzz = np.asarray(R).flat
    K = np.array(
        [
            [Rxx - Ryy - Rzz, 0, 0, 0],
            [Ryx + Rxy, Ryy - Rxx - Rzz, 0, 0],
            [Rzx + Rxz, Rzy + Ryz, Rzz - Rxx - Ryy, 0],
            [Ryz - Rzy, Rzx - Rxz, Rxy - Ryx, Rxx + Ryy + Rzz],
        ]
    ) / 3.0
    eigvals, eigvecs = np.linalg.eigh(K)
    qvec = eigvecs[[3, 0, 1, 2], np.argmax(eigvals)]
    if qvec[0] < 0:
        qvec *= -1
    return qvec


def _read_bytes(fid, nbytes, fmt, endian="<"):
    return struct.unpack(endian + fmt, fid.read(nbytes))


def read_intrinsics_binary(path) -> Dict[int, ColmapCamera]:
    """cameras.bin -> {camera id: ColmapCamera}."""
    cameras = {}
    with open(path, "rb") as fid:
        (num_cameras,) = _read_bytes(fid, 8, "Q")
        for _ in range(num_cameras):
            cid, model_id, width, height = _read_bytes(fid, 24, "iiQQ")
            model = CAMERA_MODEL_IDS[model_id]
            params = np.array(_read_bytes(fid, 8 * model.num_params, "d" * model.num_params))
            cameras[cid] = ColmapCamera(cid, model.model_name, width, height, params)
    return cameras


def write_intrinsics_binary(cameras: Dict[int, ColmapCamera], path) -> None:
    with open(path, "wb") as fid:
        fid.write(struct.pack("<Q", len(cameras)))
        for cam in cameras.values():
            model = CAMERA_MODEL_NAMES[cam.model]
            fid.write(struct.pack("<iiQQ", cam.id, model.model_id, cam.width, cam.height))
            fid.write(struct.pack("<" + "d" * len(cam.params), *cam.params))


def read_extrinsics_binary(path) -> Dict[int, ColmapImage]:
    """images.bin -> {image id: ColmapImage}, through the native parser
    where it is built."""
    try:
        raw = native.read_images_binary(path)
    except IOError:
        raw = None
    if raw is not None:
        return {iid: ColmapImage(iid, q, t, cid, name, xys, pids)
                for iid, (q, t, cid, name, xys, pids) in raw.items()}
    return read_extrinsics_binary_python(path)


def read_extrinsics_binary_python(path) -> Dict[int, ColmapImage]:
    """images.bin -> {image id: ColmapImage}, parsed in Python."""
    images = {}
    with open(path, "rb") as fid:
        (num_images,) = _read_bytes(fid, 8, "Q")
        for _ in range(num_images):
            props = _read_bytes(fid, 64, "idddddddi")
            image_id = props[0]
            qvec = np.array(props[1:5])
            tvec = np.array(props[5:8])
            camera_id = props[8]
            name_chars = []
            while True:
                c = fid.read(1)
                if c == b"\x00":
                    break
                name_chars.append(c)
            name = b"".join(name_chars).decode("utf-8")
            (n2d,) = _read_bytes(fid, 8, "Q")
            raw = np.frombuffer(fid.read(24 * n2d),
                                dtype=[("x", "<f8"), ("y", "<f8"), ("id", "<i8")])
            xys = np.stack([raw["x"], raw["y"]], axis=1) if n2d else np.zeros((0, 2))
            images[image_id] = ColmapImage(image_id, qvec, tvec, camera_id, name, xys,
                                           raw["id"].copy())
    return images


def write_extrinsics_binary(images: Dict[int, ColmapImage], path) -> None:
    with open(path, "wb") as fid:
        fid.write(struct.pack("<Q", len(images)))
        for im in images.values():
            fid.write(struct.pack("<idddddddi", im.id, *im.qvec, *im.tvec, im.camera_id))
            fid.write(im.name.encode("utf-8") + b"\x00")
            n = len(im.xys)
            fid.write(struct.pack("<Q", n))
            buf = np.empty((n, 3), "<f8")
            buf[:, :2] = im.xys
            buf[:, 2] = np.asarray(im.point3D_ids, "<i8").view("<f8")
            fid.write(buf.tobytes())


def read_intrinsics_text(path) -> Dict[int, ColmapCamera]:
    """cameras.txt -> {camera id: ColmapCamera}."""
    cameras = {}
    with open(path) as fid:
        for line in fid:
            line = line.strip()
            if not line or line.startswith("#"):
                continue
            elems = line.split()
            cid = int(elems[0])
            cameras[cid] = ColmapCamera(cid, elems[1], int(elems[2]), int(elems[3]),
                                        np.array(list(map(float, elems[4:]))))
    return cameras


def read_extrinsics_text(path) -> Dict[int, ColmapImage]:
    """images.txt -> {image id: ColmapImage}: each image's header line is
    paired with the line of its 2D points, which may be empty."""
    with open(path) as fid:
        lines = [ln.strip() for ln in fid]
    content = []
    pending_header = None
    for ln in lines:
        if ln.startswith("#"):
            continue
        if pending_header is None:
            if not ln:
                continue
            pending_header = ln
        else:
            content.extend([pending_header, ln])
            pending_header = None
    if pending_header is not None:
        content.extend([pending_header, ""])
    images = {}
    for i in range(0, len(content), 2):
        elems = content[i].split()
        image_id = int(elems[0])
        pts = content[i + 1].split()
        xys = np.array([[float(pts[j]), float(pts[j + 1])]
                        for j in range(0, len(pts), 3)]).reshape(-1, 2)
        ids = np.array([int(pts[j + 2]) for j in range(0, len(pts), 3)], np.int64)
        images[image_id] = ColmapImage(
            image_id, np.array(list(map(float, elems[1:5]))),
            np.array(list(map(float, elems[5:8]))), int(elems[8]), elems[9], xys, ids)
    return images


def read_points3D_binary(path):
    """points3D.bin -> (xyz [N, 3] float64, rgb [N, 3] int64, error [N, 1]
    float64), through the native parser where it is built."""
    try:
        result = native.read_points3d_binary(path)
    except IOError:
        result = None
    if result is not None:
        return result
    return read_points3D_binary_python(path)


def read_points3D_binary_python(path):
    """points3D.bin -> (xyz, rgb int64, error), parsed in Python."""
    xyzs, rgbs, errors = [], [], []
    with open(path, "rb") as fid:
        (num_points,) = _read_bytes(fid, 8, "Q")
        for _ in range(num_points):
            props = _read_bytes(fid, 43, "QdddBBBd")
            xyzs.append(props[1:4])
            rgbs.append(props[4:7])
            errors.append(props[7])
            (track_len,) = _read_bytes(fid, 8, "Q")
            fid.seek(8 * track_len, 1)
    return (np.array(xyzs).reshape(-1, 3), np.array(rgbs, np.int64).reshape(-1, 3),
            np.array(errors).reshape(-1, 1))


def write_points3D_binary(xyz, rgb, path, errors=None) -> None:
    """points3D.bin with empty tracks."""
    xyz = np.asarray(xyz, np.float64)
    rgb = np.asarray(rgb)
    if errors is None:
        errors = np.zeros(len(xyz))
    with open(path, "wb") as fid:
        fid.write(struct.pack("<Q", len(xyz)))
        for i in range(len(xyz)):
            fid.write(struct.pack("<QdddBBBd", i + 1, *xyz[i], int(rgb[i][0]), int(rgb[i][1]),
                                  int(rgb[i][2]), float(errors[i])))
            fid.write(struct.pack("<Q", 0))


def read_points3D_text(path):
    """points3D.txt -> (xyz [N, 3], rgb [N, 3], error [N, 1])."""
    xyzs, rgbs, errors = [], [], []
    with open(path) as fid:
        for line in fid:
            line = line.strip()
            if not line or line.startswith("#"):
                continue
            elems = line.split()
            xyzs.append(list(map(float, elems[1:4])))
            rgbs.append(list(map(int, elems[4:7])))
            errors.append(float(elems[7]))
    return (np.array(xyzs).reshape(-1, 3), np.array(rgbs).reshape(-1, 3),
            np.array(errors).reshape(-1, 1))


def JSON_to_camera(camera_json, device=None) -> Camera:
    """One entry of a 3DGS ``cameras.json`` -> Camera on ``device`` (None:
    the current CUDA device).

    ``rotation`` and ``position`` are the camera-to-world rotation and the
    camera centre.
    """
    width = camera_json["width"]
    height = camera_json["height"]
    C2W = np.eye(4)
    C2W[:3, :3] = np.array(camera_json["rotation"])
    C2W[:3, 3] = np.array(camera_json["position"])
    Rt = np.linalg.inv(C2W)
    kwargs = {}
    if "cx" in camera_json and "cy" in camera_json:
        kwargs["principal_point_ndc"] = (
            camera_json["cx"] / width,
            camera_json["cy"] / height,
        )
    return Camera(
        image_name=camera_json["img_name"],
        image_width=width,
        image_height=height,
        R=Rt[:3, :3].transpose(),
        T=Rt[:3, 3],
        FoVx=focal2fov(camera_json["fx"], width),
        FoVy=focal2fov(camera_json["fy"], height),
        device=device,
        **kwargs,
    )


def camera_to_JSON(id, camera: Camera) -> dict:
    """Camera -> one entry of a 3DGS ``cameras.json``."""
    Rt = np.zeros((4, 4))
    Rt[:3, :3] = np.asarray(camera.R).transpose()
    Rt[:3, 3] = camera.T
    Rt[3, 3] = 1.0
    C2W = np.linalg.inv(Rt)
    return {
        "id": id,
        "img_name": camera.image_name,
        "width": int(camera.image_width),
        "height": int(camera.image_height),
        "position": C2W[:3, 3].tolist(),
        "rotation": [x.tolist() for x in C2W[:3, :3]],
        "fy": fov2focal(camera.FoVy, camera.image_height),
        "fx": fov2focal(camera.FoVx, camera.image_width),
        "cy": camera.image_height * camera.principal_point_ndc[1],
        "cx": camera.image_width * camera.principal_point_ndc[0],
    }


def getNerfppNorm(cameras) -> dict:
    """Scene centre and 1.1 x the largest camera-centre distance from it."""
    centers = []
    for cam in cameras:
        C2W = np.linalg.inv(getWorld2View2(cam.R, cam.T))
        centers.append(C2W[:3, 3:4])
    centers = np.hstack(centers)
    center = np.mean(centers, axis=1, keepdims=True)
    dist = np.linalg.norm(centers - center, axis=0)
    return {
        "translate": -center.flatten(),
        "radius": float(np.max(dist) * 1.1),
        "min_radius": float(np.min(dist) * 1.5),
    }
