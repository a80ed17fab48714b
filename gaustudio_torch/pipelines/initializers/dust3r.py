"""DUSt3R initializer (port of gaustudio_tpu/pipelines/initializers/dust3r.py):
the pre- and post-processing around an external model.

At most 20 views chosen at an even interval, each cropped about its
principal point and resized to multiples of 16 with its intrinsics adjusted
(PIL's LANCZOS for the image, NEAREST for the mask, an integer crop box),
then the learned two-view model with global alignment at the known poses,
then the confident points fused into ``fused.ply`` and built as the ``pcd``
initializer builds a PLY. The model is the external ``mini_dust3r``
package's, imported where it runs and raising the JAX package's ImportError
where it is absent; it runs on ``device``. The step is injectable
(``run_dust3r=``) so the rest runs without it.
"""

from __future__ import annotations

import functools
import os
import tempfile

import numpy as np

from gaustudio_torch.pipelines import initializers
from gaustudio_torch.pipelines.initializers.base import BaseInitializer
from gaustudio_torch.pipelines.initializers.pcd import PcdInitializer
from gaustudio_torch.utils.misc import resolve_device
from gaustudio_torch.utils.ply import store_ply


def select_view_indices(n_views: int, max_images: int = 20):
    """Every ``n_views // max_images``-th view, at most ``max_images``."""
    if n_views <= max_images:
        return list(range(n_views))
    interval = n_views // max_images
    return list(range(0, n_views, interval))[:max_images]


def prepare_view(image: np.ndarray, intrinsics: np.ndarray, mask: np.ndarray | None = None,
                 image_size: int = 512, square_ok: bool = False):
    """Crop about the principal point and resize to multiples of 16.

    The crop is symmetric about (cx, cy), so the principal point lands at
    the centre; the resize makes the long edge ~``image_size`` (the short
    edge for 224), scaled from the size before the crop, both sides rounded
    to multiples of 16, one shrunk where the result would be square.
    Returns (img_u8 [H, W, 3], mask_u8 [H, W] | None, K' [3, 3]).
    """
    try:
        import PIL.Image
    except ImportError as e:
        raise ImportError("prepare_view requires pillow") from e

    arr = np.asarray(image)
    if arr.dtype != np.uint8:
        arr = (np.clip(arr, 0.0, 1.0) * 255).astype(np.uint8)
    img = PIL.Image.fromarray(arr)
    pil_mask = None
    if mask is not None:
        m = np.asarray(mask)
        if m.dtype != np.uint8:
            m = (np.clip(m, 0.0, 1.0) * 255).astype(np.uint8)
        pil_mask = PIL.Image.fromarray(m)

    original_W, original_H = img.size
    fx, fy = float(intrinsics[0, 0]), float(intrinsics[1, 1])
    cx, cy = float(intrinsics[0, 2]), float(intrinsics[1, 2])

    min_margin_x = min(cx, original_W - cx)
    min_margin_y = min(cy, original_H - cy)
    # an integer box, as PIL crops; the principal point moves by the same integers
    left = int(max(0, cx - min_margin_x))
    top = int(max(0, cy - min_margin_y))
    right = int(min(original_W, cx + min_margin_x))
    bottom = int(min(original_H, cy + min_margin_y))
    img = img.crop((left, top, right, bottom))
    if pil_mask is not None:
        pil_mask = pil_mask.crop((left, top, right, bottom))
    cx -= left
    cy -= top

    if image_size == 224:
        scale = image_size / min(original_W, original_H)
    else:
        scale = image_size / max(original_W, original_H)
    new_W = round(original_W * scale / 16) * 16
    new_H = round(original_H * scale / 16) * 16
    if not square_ok and new_W == new_H:
        new_H = round(new_H * 0.75 / 16) * 16

    crop_W, crop_H = img.size
    scale_W = new_W / crop_W
    scale_H = new_H / crop_H
    img = img.resize((new_W, new_H), PIL.Image.LANCZOS)
    if pil_mask is not None:
        pil_mask = pil_mask.resize((new_W, new_H), PIL.Image.NEAREST)

    K = np.array([[fx * scale_W, 0.0, cx * scale_W],
                  [0.0, fy * scale_H, cy * scale_H],
                  [0.0, 0.0, 1.0]], np.float64)
    out_mask = None if pil_mask is None else np.asarray(pil_mask)
    return np.asarray(img), out_mask, K


def fuse_point_clouds(pts_list, color_list, conf_masks, fg_masks=None,
                      prune_background: bool = False, max_points: int = 500_000):
    """Per-view (points, colours, confidence mask) -> one cloud, thinned to
    every k-th point past ``max_points``: (xyz [M, 3] f32, rgb [M, 3] f32 in
    [0, 1])."""
    all_xyz, all_rgb = [], []
    for i, (pts, img, mask) in enumerate(zip(pts_list, color_list, conf_masks)):
        mask = np.asarray(mask, bool)
        if mask.mean() == 0:
            continue
        if prune_background and fg_masks is not None:
            mask = np.logical_and(mask, np.asarray(fg_masks[i], bool))
        img = np.asarray(img, np.float32)
        if img.max() > 1.5:
            img = img / 255.0
        all_xyz.append(np.asarray(pts, np.float32)[mask].reshape(-1, 3))
        all_rgb.append(img[mask].reshape(-1, 3))
    if not all_xyz:
        return np.zeros((0, 3), np.float32), np.zeros((0, 3), np.float32)
    xyz = np.concatenate(all_xyz, 0)
    rgb = np.concatenate(all_rgb, 0)
    if len(xyz) > max_points:
        every_k = len(xyz) // max_points
        xyz, rgb = xyz[::every_k], rgb[::every_k]
    return xyz, rgb


def _run_mini_dust3r(views, poses_c2w, intrinsics, device=None):
    """The external step: mini_dust3r's pairwise inference and global
    alignment at the preset known poses, on ``device`` (None: the current
    CUDA device). ``views``: dicts of img_u8 [H, W, 3] and mask_u8 or None.
    Returns (pts3d_list, conf_mask_list), one entry a view."""
    try:
        import torch
        from mini_dust3r.model import AsymmetricCroCo3DStereo
        from mini_dust3r.inference import inference
        from mini_dust3r.image_pairs import make_pairs
        from mini_dust3r.cloud_opt import GlobalAlignerMode, global_aligner
        from mini_dust3r.utils.image import ImgNorm
    except ImportError as e:
        raise ImportError(
            "The 'dust3r' initializer delegates the learned model to the "
            "external `mini_dust3r` package, which is not bundled. Install "
            "it on the host, or use the 'colmap'/'hloc' initializers."
        ) from e
    from PIL import Image

    device = resolve_device(device)
    imgs = [dict(img=ImgNorm(Image.fromarray(v["img_u8"]))[None],
                 true_shape=np.int32([v["img_u8"].shape[:2]]), idx=i, instance=str(i))
            for i, v in enumerate(views)]
    model = AsymmetricCroCo3DStereo.from_pretrained(
        "nielsr/DUSt3R_ViTLarge_BaseDecoder_512_dpt").to(device)
    pairs = make_pairs(imgs, scene_graph="complete", prefilter=None, symmetrize=True)
    output = inference(pairs, model, device, batch_size=16)
    scene = global_aligner(dust3r_output=output, device=device,
                           mode=GlobalAlignerMode.PointCloudOptimizer)
    scene.preset_pose(torch.as_tensor(np.stack(poses_c2w)))
    scene.preset_focal([float(K[0, 0] + K[1, 1]) / 2 for K in intrinsics])
    scene.preset_principal_point([K[:2, 2] for K in intrinsics])
    scene.compute_global_alignment(init="known_poses", niter=500, schedule="cosine", lr=0.01)
    pts3d = [p.numpy(force=True) for p in scene.get_pts3d()]
    masks = [m.numpy(force=True) for m in scene.get_masks()]
    return pts3d, masks


@initializers.register("dust3r")
class Dust3rInitializer(PcdInitializer):
    """At most 20 views through DUSt3R -> fused.ply -> the pcd build."""

    def __init__(self, initializer_config, run_dust3r=None, device=None):
        BaseInitializer.__init__(self, initializer_config, resolve_device(device))
        ws = self.initializer_config.get("workspace_dir")
        if ws is None:
            ws = tempfile.mkdtemp()
            print(f"No workspace directory provided. Using temporary directory: {ws}")
        os.makedirs(ws, exist_ok=True)
        self.ws_dir = ws
        self.model_path = os.path.join(ws, "fused.ply")
        self.prune_background = self.initializer_config.get("prune_bg", False)
        self.image_size = 512
        self.max_images = 20
        self._run_dust3r = run_dust3r or functools.partial(_run_mini_dust3r, device=self.device)
        self._views, self._poses, self._intrinsics = [], [], []

    def __call__(self, model, dataset=None, overwrite=False):
        if not os.path.exists(self.model_path) or overwrite:
            self.cache_dataset(dataset)
            self.process_dataset()
        return self.build_model(model)

    def cache_dataset(self, dataset=None):
        # a re-run (overwrite=True) starts from no views
        self._views, self._poses, self._intrinsics = [], [], []
        for i in select_view_indices(len(dataset), self.max_images):
            camera = dataset[i]
            mask = None if camera.mask is None else camera.mask.cpu().numpy()
            img_u8, mask_u8, K = prepare_view(camera.image.cpu().numpy(),
                                              camera.intrinsics.cpu().numpy(), mask=mask,
                                              image_size=self.image_size)
            self._views.append(dict(img_u8=img_u8, mask_u8=mask_u8))
            self._poses.append(np.linalg.inv(camera.extrinsics.cpu().numpy()))  # camera to world
            self._intrinsics.append(K)

    def process_dataset(self):
        pts3d, conf_masks = self._run_dust3r(self._views, self._poses, self._intrinsics)
        fg = [v["mask_u8"] is not None and v["mask_u8"] > 127 for v in self._views]
        fg = fg if all(m is not False for m in fg) else None
        xyz, rgb = fuse_point_clouds(pts3d, [v["img_u8"] for v in self._views], conf_masks,
                                     fg_masks=fg if self.prune_background else None,
                                     prune_background=self.prune_background)
        store_ply(self.model_path, xyz, (rgb * 255).astype(np.uint8))
