"""gaustudio_torch.utils.colmap_db against gaustudio_tpu.utils.colmap_db: the
same calls give databases with equal rows in every table, and known-pose
model files equal byte for byte; the port reads them back."""

import numpy as np
import pytest

from gaustudio_torch.datasets import utils as t_dsu
from gaustudio_torch.utils import colmap_db as tdb
from gaustudio_tpu.utils import colmap_db as jdb

TABLES = ("cameras", "images", "keypoints", "descriptors", "matches", "two_view_geometries")


def _fill(module, path, seed=0):
    rng = np.random.default_rng(seed)
    db = module.COLMAPDatabase.connect(str(path))
    db.create_tables()
    cams = [db.add_camera("PINHOLE", 64, 48, [50.0, 51.0, 32.0, 24.0]),
            db.add_camera(2, 80, 60, [60.0, 40.0, 30.0, 0.01], prior_focal_length=True),
            db.add_camera("OPENCV", 32, 32, rng.uniform(0, 1, 8), camera_id=7)]
    images = [db.add_image(f"im_{i}.png", cams[i % 3]) for i in range(4)]
    images.append(db.add_image("posed.png", cams[0], prior_q=[1, 0, 0, 0], prior_t=[1, 2, 3],
                               image_id=11))
    for iid in images:
        db.add_keypoints(iid, rng.uniform(0, 64, (20, 2)))
        db.add_descriptors(iid, rng.integers(0, 256, (20, 128)))
    for a, b in [(images[0], images[1]), (images[2], images[1]), (images[4], images[3])]:
        m = rng.integers(0, 20, (9, 2))
        db.add_matches(a, b, m)
        db.add_two_view_geometry(a, b, m, F=rng.normal(size=(3, 3)), config=3)
    db.add_two_view_geometry(images[0], images[4], rng.integers(0, 20, (5, 2)))
    db.commit()
    return db


def test_database_rows_match_jax(tmp_path):
    t, j = _fill(tdb, tmp_path / "port.db"), _fill(jdb, tmp_path / "jax.db")
    try:
        for table in TABLES:
            got = t.execute(f"SELECT * FROM {table} ORDER BY 1").fetchall()
            want = j.execute(f"SELECT * FROM {table} ORDER BY 1").fetchall()
            assert len(got) > 0 and got == [tuple(r) for r in want], table
        schema = "SELECT name, sql FROM sqlite_master ORDER BY name"
        assert t.execute(schema).fetchall() == j.execute(schema).fetchall()
        # matches are stored under the ordered pair, columns swapped to match
        pair_id, rows, cols, blob = t.execute(
            "SELECT pair_id, rows, cols, data FROM matches ORDER BY pair_id").fetchall()[1]
        assert tdb.pair_id_to_image_ids(pair_id) == (2, 3)
        assert tdb.blob_to_array(blob, np.uint32, (rows, cols)).shape == (9, 2)
    finally:
        t.close()
        j.close()


@pytest.mark.parametrize("pair", [(1, 2), (2, 1), (5, 2 ** 31 - 2), (0, 7)])
def test_pair_ids_match_jax(pair):
    pid = tdb.image_ids_to_pair_id(*pair)
    assert pid == jdb.image_ids_to_pair_id(*pair)
    assert tdb.pair_id_to_image_ids(pid) == jdb.pair_id_to_image_ids(pid) == tuple(sorted(pair))


def test_known_pose_model_files_match_jax_byte_for_byte(tmp_path):
    rng = np.random.default_rng(1)
    poses = {}
    for i in range(5):
        q = rng.normal(size=4)
        q /= np.linalg.norm(q)
        w2c = np.eye(4)
        w2c[:3, :3] = t_dsu.qvec2rotmat(q)
        w2c[:3, 3] = rng.normal(size=3)
        poses[f"frame_{4 - i:02d}.png"] = w2c
    intr = {1: {"width": 64, "height": 48, "fx": 50, "fy": 51, "cx": 32, "cy": 24},
            2: {"width": 80, "height": 60, "fx": 70.5, "fy": 70.5, "cx": 40, "cy": 30}}
    for module, d in ((tdb, tmp_path / "port"), (jdb, tmp_path / "jax")):
        module.create_cameras_and_points_bin(str(d), intr)
        module.create_images_from_pose_dict(str(d), poses, camera_id=2)
    for name in ("cameras.bin", "points3D.bin", "images.bin", "images.txt"):
        assert (tmp_path / "port" / name).read_bytes() == (tmp_path / "jax" / name).read_bytes(), name

    port = tmp_path / "port"
    cams = t_dsu.read_intrinsics_binary(port / "cameras.bin")
    assert cams[2].model == "PINHOLE" and list(cams[2].params) == [70.5, 70.5, 40, 30]
    for images in (t_dsu.read_extrinsics_binary(port / "images.bin"),
                   t_dsu.read_extrinsics_text(port / "images.txt")):
        assert [im.name for im in images.values()] == sorted(poses)
        for im in images.values():
            np.testing.assert_allclose(t_dsu.qvec2rotmat(im.qvec), poses[im.name][:3, :3],
                                       atol=1e-12)
            np.testing.assert_allclose(im.tvec, poses[im.name][:3, 3], atol=1e-12)
            assert im.camera_id == 2
    xyz, rgb, _ = t_dsu.read_points3D_binary(port / "points3D.bin")
    assert xyz.shape == (0, 3) and rgb.dtype == np.int64


def test_images_bin_with_points_matches_jax(tmp_path):
    rng = np.random.default_rng(2)
    ims = {i: t_dsu.ColmapImage(i, np.array([1.0, 0, 0, 0]), rng.normal(size=3), 1,
                                f"{i}.png", rng.normal(size=(i, 2)),
                                rng.integers(-1, 9, i).astype(np.int64)) for i in (1, 2, 3)}
    tdb.create_images_bin(str(tmp_path / "port"), ims)
    tdb.create_images_txt(str(tmp_path / "port"), ims)
    jdb.create_images_bin(str(tmp_path / "jax"), ims)
    jdb.create_images_txt(str(tmp_path / "jax"), ims)
    for name in ("images.bin", "images.txt"):
        assert (tmp_path / "port" / name).read_bytes() == (tmp_path / "jax" / name).read_bytes()
