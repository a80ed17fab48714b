"""COLMAP SfM initializers (port of
gaustudio_tpu/pipelines/initializers/colmap.py): ``colmap``, ``hloc`` and
``loftr``.

``cache_dataset`` writes the images (JAX's names, ``{i:06d}.jpg`` by
default) and the known intrinsics and poses as a COLMAP model
(``model/cameras.bin``, ``images.bin`` and an empty ``points3D.bin``,
byte for byte the JAX package's). Feature extraction, matching and
triangulation are external CPU tools (``pycolmap``; ``hloc``), imported
where they run and raising the JAX package's ImportError where they are
absent; ``hloc`` and ``loftr`` write ``pairs-sfm.txt`` (``sfm_pairs``)
before they do. ``should_skip`` holds while ``sparse/0/points3D.bin``
exists; ``build_model`` reads it, else ``model/points3D.bin``.
"""

from __future__ import annotations

import os
import tempfile

import numpy as np

from gaustudio_torch.datasets import utils as dsu
from gaustudio_torch.pipelines import initializers
from gaustudio_torch.pipelines.initializers.base import BaseInitializer
from gaustudio_torch.utils.image import save_rgb8


@initializers.register("colmap")
class ColmapInitializer(BaseInitializer):
    def __init__(self, initializer_config, device=None):
        super().__init__(initializer_config, device)
        self.ws_dir = self.initializer_config.get("workspace_dir")
        if self.ws_dir is None:
            self.ws_dir = tempfile.mkdtemp()
            print(f"No workspace directory provided. Using: {self.ws_dir}")
        os.makedirs(os.path.join(self.ws_dir, "images"), exist_ok=True)
        os.makedirs(os.path.join(self.ws_dir, "model"), exist_ok=True)

    def should_skip(self):
        return os.path.exists(os.path.join(self.ws_dir, "sparse", "0", "points3D.bin"))

    def cache_dataset(self, dataset):
        """The images and the known intrinsics and poses as a COLMAP model."""
        cams, ims = {}, {}
        for i, camera in enumerate(dataset):
            name = camera.image_name or f"{i:06d}.jpg"
            if not name.lower().endswith((".jpg", ".png", ".jpeg")):
                name += ".jpg"
            if camera.image is not None:
                img = np.clip(camera.image.cpu().numpy() * 255, 0, 255).astype(np.uint8)
                save_rgb8(os.path.join(self.ws_dir, "images", name), img)
            K = camera.intrinsics.cpu().numpy()
            cams[i + 1] = dsu.ColmapCamera(
                i + 1, "PINHOLE", int(camera.image_width), int(camera.image_height),
                np.array([K[0, 0], K[1, 1], K[0, 2], K[1, 2]]))
            W2C = camera.extrinsics.cpu().numpy()
            ims[i + 1] = dsu.ColmapImage(i + 1, dsu.rotmat2qvec(W2C[:3, :3]), W2C[:3, 3], i + 1,
                                         name, np.zeros((0, 2)), np.zeros(0, np.int64))
        model_dir = os.path.join(self.ws_dir, "model")
        dsu.write_intrinsics_binary(cams, os.path.join(model_dir, "cameras.bin"))
        dsu.write_extrinsics_binary(ims, os.path.join(model_dir, "images.bin"))
        dsu.write_points3D_binary(np.zeros((0, 3)), np.zeros((0, 3)),
                                  os.path.join(model_dir, "points3D.bin"))

    def process_dataset(self):
        """pycolmap's feature extraction, exhaustive matching and
        triangulation at the known poses."""
        try:
            import pycolmap
        except ImportError as e:
            raise ImportError(
                "The colmap initializer needs the external `pycolmap` package "
                "for feature extraction/triangulation (CPU SfM). Install it or "
                "use the 'pcd'/'depth'/'mesh' initializers."
            ) from e
        db = os.path.join(self.ws_dir, "database.db")
        images = os.path.join(self.ws_dir, "images")
        pycolmap.extract_features(db, images)
        pycolmap.match_exhaustive(db)
        out = os.path.join(self.ws_dir, "sparse", "0")
        os.makedirs(out, exist_ok=True)
        pycolmap.triangulate_points(
            pycolmap.Reconstruction(os.path.join(self.ws_dir, "model")), db, images, out)

    def build_model(self, model):
        pts_path = os.path.join(self.ws_dir, "sparse", "0", "points3D.bin")
        if not os.path.exists(pts_path):
            pts_path = os.path.join(self.ws_dir, "model", "points3D.bin")
        xyz, rgb, _ = dsu.read_points3D_binary(pts_path)
        if len(xyz) == 0:
            raise ValueError("colmap initializer produced no 3D points")
        model.create_from_attribute(xyz=xyz.astype(np.float32), rgb=rgb / 255.0)
        return model


@initializers.register("hloc")
class HlocInitializer(ColmapInitializer):
    """SuperPoint + LightGlue matching by the external ``hloc`` package over
    the pairs ``sfm_pairs.pairs_from_poses`` selects."""

    pairs_overlap = 5

    def select_pairs(self):
        from gaustudio_torch.pipelines.initializers import sfm_pairs

        return sfm_pairs.pairs_from_model(os.path.join(self.ws_dir, "model"),
                                          os.path.join(self.ws_dir, "pairs-sfm.txt"),
                                          overlap=self.pairs_overlap)

    def process_dataset(self):
        pairs = self.select_pairs()
        print(f"hloc initializer: {len(pairs)} match pairs")
        try:
            from hloc import extract_features, match_features, triangulation
            import pycolmap  # noqa: F401  (hloc's triangulation needs it)
        except ImportError as e:
            raise ImportError(
                "The 'hloc' initializer delegates feature matching to the "
                "external `hloc` package (superpoint+lightglue), which is "
                "not bundled. Pairs were written to pairs-sfm.txt; install "
                "hloc or use the 'colmap' initializer."
            ) from e
        from pathlib import Path

        ws = Path(self.ws_dir)
        feats = extract_features.main(
            extract_features.confs["superpoint_aachen"], ws / "images",
            feature_path=ws / "model" / "features.h5", as_half=False)
        matches = match_features.main(
            match_features.confs["superpoint+lightglue"], ws / "pairs-sfm.txt",
            features=ws / "model" / "features.h5", matches=ws / "model" / "matches.h5")
        out = ws / "sparse" / "0"
        os.makedirs(out, exist_ok=True)
        triangulation.main(out, ws / "model", ws / "images", ws / "pairs-sfm.txt", feats,
                           matches, skip_geometric_verification=True)


@initializers.register("loftr")
class LoftrInitializer(HlocInitializer):
    """Dense LoFTR matching by the external ``hloc`` package."""

    def process_dataset(self):
        pairs = self.select_pairs()
        print(f"loftr initializer: {len(pairs)} match pairs")
        try:
            from hloc import match_dense, triangulation
            import pycolmap  # noqa: F401
        except ImportError as e:
            raise ImportError(
                "The 'loftr' initializer delegates dense matching to the "
                "external `hloc` package, which is not bundled. Pairs were "
                "written to pairs-sfm.txt; install hloc or use the "
                "'colmap' initializer."
            ) from e
        from pathlib import Path

        ws = Path(self.ws_dir)
        feats, matches = match_dense.main(match_dense.confs["loftr"], ws / "pairs-sfm.txt",
                                          ws / "images", self.ws_dir, max_kps=8192)
        out = ws / "sparse" / "0"
        os.makedirs(out, exist_ok=True)
        triangulation.main(out, ws / "model", ws / "images", ws / "pairs-sfm.txt", feats,
                           matches)
