"""COLMAP database and known-pose model files (port of
gaustudio_tpu/utils/colmap_db.py).

The sqlite ``COLMAPDatabase`` (the schema, add_camera / add_image /
add_keypoints / add_descriptors / add_matches / add_two_view_geometry), the
pair-id and blob helpers, and the known-pose model writers
``create_cameras_and_points_bin``, ``create_images_bin``,
``create_images_txt`` and ``create_images_from_pose_dict``, built on the
binary writers of gaustudio_torch.datasets.utils. Host code: numpy and
sqlite3.
"""

from __future__ import annotations

import os
import sqlite3

import numpy as np

from gaustudio_torch.datasets.utils import (
    ColmapCamera,
    ColmapImage,
    rotmat2qvec,
    write_extrinsics_binary,
    write_intrinsics_binary,
    write_points3D_binary,
)

MAX_IMAGE_ID = 2**31 - 1

_CREATE_CAMERAS = """CREATE TABLE IF NOT EXISTS cameras (
    camera_id INTEGER PRIMARY KEY AUTOINCREMENT NOT NULL,
    model INTEGER NOT NULL,
    width INTEGER NOT NULL,
    height INTEGER NOT NULL,
    params BLOB,
    prior_focal_length INTEGER NOT NULL)"""

_CREATE_IMAGES = f"""CREATE TABLE IF NOT EXISTS images (
    image_id INTEGER PRIMARY KEY AUTOINCREMENT NOT NULL,
    name TEXT NOT NULL UNIQUE,
    camera_id INTEGER NOT NULL,
    prior_qw REAL, prior_qx REAL, prior_qy REAL, prior_qz REAL,
    prior_tx REAL, prior_ty REAL, prior_tz REAL,
    CONSTRAINT image_id_check CHECK(image_id >= 0 and image_id < {MAX_IMAGE_ID}),
    FOREIGN KEY(camera_id) REFERENCES cameras(camera_id))"""

_CREATE_KEYPOINTS = """CREATE TABLE IF NOT EXISTS keypoints (
    image_id INTEGER PRIMARY KEY NOT NULL,
    rows INTEGER NOT NULL, cols INTEGER NOT NULL, data BLOB,
    FOREIGN KEY(image_id) REFERENCES images(image_id) ON DELETE CASCADE)"""

_CREATE_DESCRIPTORS = """CREATE TABLE IF NOT EXISTS descriptors (
    image_id INTEGER PRIMARY KEY NOT NULL,
    rows INTEGER NOT NULL, cols INTEGER NOT NULL, data BLOB,
    FOREIGN KEY(image_id) REFERENCES images(image_id) ON DELETE CASCADE)"""

_CREATE_MATCHES = """CREATE TABLE IF NOT EXISTS matches (
    pair_id INTEGER PRIMARY KEY NOT NULL,
    rows INTEGER NOT NULL, cols INTEGER NOT NULL, data BLOB)"""

_CREATE_TWO_VIEW = """CREATE TABLE IF NOT EXISTS two_view_geometries (
    pair_id INTEGER PRIMARY KEY NOT NULL,
    rows INTEGER NOT NULL, cols INTEGER NOT NULL, data BLOB,
    config INTEGER NOT NULL,
    F BLOB, E BLOB, H BLOB, qvec BLOB, tvec BLOB)"""

_CREATE_NAME_INDEX = "CREATE UNIQUE INDEX IF NOT EXISTS index_name ON images(name)"

_CAMERA_MODEL_IDS = {
    "SIMPLE_PINHOLE": 0, "PINHOLE": 1, "SIMPLE_RADIAL": 2, "RADIAL": 3,
    "OPENCV": 4, "OPENCV_FISHEYE": 5, "FULL_OPENCV": 6, "FOV": 7,
    "SIMPLE_RADIAL_FISHEYE": 8, "RADIAL_FISHEYE": 9, "THIN_PRISM_FISHEYE": 10,
}


def image_ids_to_pair_id(image_id1: int, image_id2: int) -> int:
    """colmap_utils.py pair id convention."""
    if image_id1 > image_id2:
        image_id1, image_id2 = image_id2, image_id1
    return image_id1 * MAX_IMAGE_ID + image_id2


def pair_id_to_image_ids(pair_id: int):
    image_id2 = pair_id % MAX_IMAGE_ID
    image_id1 = (pair_id - image_id2) // MAX_IMAGE_ID
    return image_id1, image_id2


def array_to_blob(array: np.ndarray) -> bytes:
    return np.asarray(array).tobytes()


def blob_to_array(blob, dtype, shape=(-1,)):
    return np.frombuffer(blob, dtype=dtype).reshape(*shape)


class COLMAPDatabase(sqlite3.Connection):
    """colmap_utils.py:204-297."""

    @staticmethod
    def connect(database_path) -> "COLMAPDatabase":
        return sqlite3.connect(database_path, factory=COLMAPDatabase)

    def __init__(self, *args, **kwargs):
        super().__init__(*args, **kwargs)
        self.create_tables = lambda: self.executescript(
            ";\n".join(
                [
                    _CREATE_CAMERAS, _CREATE_IMAGES, _CREATE_KEYPOINTS,
                    _CREATE_DESCRIPTORS, _CREATE_MATCHES, _CREATE_TWO_VIEW,
                    _CREATE_NAME_INDEX,
                ]
            )
        )

    def add_camera(self, model, width, height, params, prior_focal_length=False,
                   camera_id=None):
        if isinstance(model, str):
            model = _CAMERA_MODEL_IDS[model]
        params = np.asarray(params, np.float64)
        cursor = self.execute(
            "INSERT INTO cameras VALUES (?, ?, ?, ?, ?, ?)",
            (camera_id, model, width, height, array_to_blob(params),
             int(prior_focal_length)),
        )
        return cursor.lastrowid

    def add_image(self, name, camera_id, prior_q=None, prior_t=None, image_id=None):
        prior_q = np.full(4, np.nan) if prior_q is None else np.asarray(prior_q)
        prior_t = np.full(3, np.nan) if prior_t is None else np.asarray(prior_t)
        cursor = self.execute(
            "INSERT INTO images VALUES (?, ?, ?, ?, ?, ?, ?, ?, ?, ?)",
            (image_id, name, camera_id, *prior_q.tolist(), *prior_t.tolist()),
        )
        return cursor.lastrowid

    def add_keypoints(self, image_id, keypoints):
        keypoints = np.asarray(keypoints, np.float32)
        self.execute(
            "INSERT INTO keypoints VALUES (?, ?, ?, ?)",
            (image_id,) + keypoints.shape + (array_to_blob(keypoints),),
        )

    def add_descriptors(self, image_id, descriptors):
        descriptors = np.ascontiguousarray(descriptors, np.uint8)
        self.execute(
            "INSERT INTO descriptors VALUES (?, ?, ?, ?)",
            (image_id,) + descriptors.shape + (array_to_blob(descriptors),),
        )

    def add_matches(self, image_id1, image_id2, matches):
        if image_id1 > image_id2:
            matches = matches[:, ::-1]
        pair_id = image_ids_to_pair_id(image_id1, image_id2)
        matches = np.asarray(matches, np.uint32)
        self.execute(
            "INSERT INTO matches VALUES (?, ?, ?, ?)",
            (pair_id,) + matches.shape + (array_to_blob(matches),),
        )

    def add_two_view_geometry(self, image_id1, image_id2, matches, F=None, E=None,
                              H=None, config=2):
        if image_id1 > image_id2:
            matches = matches[:, ::-1]
        pair_id = image_ids_to_pair_id(image_id1, image_id2)
        matches = np.asarray(matches, np.uint32)
        F = np.eye(3) if F is None else np.asarray(F)
        E = np.eye(3) if E is None else np.asarray(E)
        H = np.eye(3) if H is None else np.asarray(H)
        self.execute(
            "INSERT INTO two_view_geometries VALUES (?, ?, ?, ?, ?, ?, ?, ?, ?, ?)",
            (pair_id,) + matches.shape
            + (array_to_blob(matches), config, array_to_blob(F.astype(np.float64)),
               array_to_blob(E.astype(np.float64)), array_to_blob(H.astype(np.float64)),
               array_to_blob(np.zeros(4)), array_to_blob(np.zeros(3))),
        )


def create_cameras_and_points_bin(model_dir, intrinsics_by_id):
    """colmap_utils.py:39-47: write cameras.bin with PINHOLE intrinsics +
    an empty points3D.bin for known-pose triangulation."""
    os.makedirs(model_dir, exist_ok=True)
    cams = {}
    for cid, intr in intrinsics_by_id.items():
        cams[cid] = ColmapCamera(
            cid, "PINHOLE", int(intr["width"]), int(intr["height"]),
            np.array([intr["fx"], intr["fy"], intr["cx"], intr["cy"]]),
        )
    write_intrinsics_binary(cams, os.path.join(model_dir, "cameras.bin"))
    write_points3D_binary(np.zeros((0, 3)), np.zeros((0, 3)),
                          os.path.join(model_dir, "points3D.bin"))


def create_images_from_pose_dict(model_dir, pose_dict, camera_id: int = 1):
    """colmap_utils.py:811-827: known W2C poses keyed by image name."""
    ims = {}
    for i, (name, w2c) in enumerate(sorted(pose_dict.items()), start=1):
        w2c = np.asarray(w2c)
        ims[i] = ColmapImage(
            i, rotmat2qvec(w2c[:3, :3]), w2c[:3, 3], camera_id, name,
            np.zeros((0, 2)), np.zeros(0, np.int64),
        )
    create_images_bin(model_dir, ims)
    create_images_txt(model_dir, ims)


def create_images_bin(model_dir, images):
    """colmap_utils.py:48-66."""
    os.makedirs(model_dir, exist_ok=True)
    write_extrinsics_binary(images, os.path.join(model_dir, "images.bin"))


def create_images_txt(model_dir, images):
    """colmap_utils.py:68-88."""
    os.makedirs(model_dir, exist_ok=True)
    with open(os.path.join(model_dir, "images.txt"), "w") as f:
        f.write("# Image list with two lines of data per image\n")
        for im in images.values():
            q = " ".join(str(v) for v in im.qvec)
            t = " ".join(str(v) for v in im.tvec)
            f.write(f"{im.id} {q} {t} {im.camera_id} {im.name}\n\n")
