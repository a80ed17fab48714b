"""Port parity of the 2DGS surfel set-up: ``transform_dirs``,
``preprocess_surfel`` and K1 without the tile cull against the JAX package,
and the model's config-driven scale width.

The scene helpers here are shared by the other surfel port tests: the same
numpy-seeded surfels go to both packages.
"""

import math

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from gaustudio_torch import models as t_models
from gaustudio_torch.ops import binning as t_binning
from gaustudio_torch.ops import gaussian as t_gaussian
from gaustudio_torch.ops import rasterize_surfel as t_surfel
from gaustudio_torch.ops.rasterize import RasterizeSettings as TSettings
from gaustudio_tpu import models as j_models
from gaustudio_tpu.cameras import Camera
from gaustudio_tpu.ops import binning as j_binning
from gaustudio_tpu.ops import gaussian as j_gaussian
from gaustudio_tpu.ops import rasterize_surfel as j_surfel
from gaustudio_tpu.ops.rasterize import RasterizeSettings as JSettings

SURFEL_ATTRS = {"xyz": 3, "opacity": 1, "f_dc": 3, "f_rest": 45, "scale": 2, "rot": 4}


def surfel_scene(n=60, seed=11, w=64, h=48, sh_degree=None, opac_max=0.9):
    """Surfels in front of tests/test_surfel.py's camera (opacity <= 0.9, so
    op * G stays below the 0.99 clamp) with precomputed colours, or SH
    coefficients of ``sh_degree``."""
    rng = np.random.default_rng(seed)
    xyz = rng.normal(size=(n, 3)).astype(np.float32) * 0.35
    xyz[:, 2] += 2.4
    scene = dict(
        xyz=xyz,
        scales=np.abs(rng.normal(size=(n, 2)).astype(np.float32)) * 0.12 + 0.03,
        quats=rng.normal(size=(n, 4)).astype(np.float32),
        opac=rng.uniform(0.3, opac_max, n).astype(np.float32),
        colors=rng.uniform(0.1, 0.9, (n, 3)).astype(np.float32),
        w=w, h=h, cam=Camera(R=np.eye(3), T=np.array([0.0, 0.0, 3.0]), FoVx=1.0, FoVy=1.0,
                              image_width=w, image_height=h))
    if sh_degree is not None:
        k = (sh_degree + 1) ** 2
        scene["shs"] = (rng.normal(size=(n, k, 3)) * 0.3).astype(np.float32)
    return scene


def settings(scene):
    """(JAX settings with the XLA golden compositor, the port's settings)."""
    cam = scene["cam"]
    mats = (cam.world_view_transform, cam.full_proj_transform, cam.camera_center)
    common = dict(image_height=scene["h"], image_width=scene["w"],
                  tanfovx=math.tan(cam.FoVx / 2), tanfovy=math.tan(cam.FoVy / 2))
    js = JSettings(**common, bg=jnp.zeros(3), viewmatrix=jnp.asarray(mats[0]),
                   projmatrix=jnp.asarray(mats[1]), campos=jnp.asarray(mats[2]),
                   num_entries=1 << 13, chunk=256, backend="xla")
    ts = TSettings(**common, bg=None, viewmatrix=torch.tensor(np.asarray(mats[0])),
                   projmatrix=torch.tensor(np.asarray(mats[1])),
                   campos=torch.tensor(np.asarray(mats[2])))
    return js, ts


def jax_preprocess(scene, **kw):
    js, _ = settings(scene)
    color = ({"shs": jnp.asarray(scene["shs"])} if "shs" in scene
             else {"colors_precomp": jnp.asarray(scene["colors"])})
    return j_surfel.preprocess_surfel(
        jnp.asarray(scene["xyz"]), jnp.asarray(scene["opac"]), js.viewmatrix, js.projmatrix,
        js.campos, scene["w"], scene["h"], scales=jnp.asarray(scene["scales"]),
        rotations=jnp.asarray(scene["quats"]), **color, **kw)


def torch_preprocess(scene, **kw):
    _, ts = settings(scene)
    t = torch.from_numpy
    color = {"shs": t(scene["shs"])} if "shs" in scene else {"colors_precomp": t(scene["colors"])}
    return t_surfel.preprocess_surfel(
        t(scene["xyz"]), t(scene["opac"]), ts.viewmatrix, ts.projmatrix, ts.campos,
        scene["w"], scene["h"], scales=t(scene["scales"]), rotations=t(scene["quats"]),
        **color, **kw)


def test_transform_dirs_matches_jax():
    rng = np.random.default_rng(0)
    dirs = rng.normal(size=(5, 7, 3)).astype(np.float32)
    mat = rng.normal(size=(3, 4)).astype(np.float32)
    got = t_gaussian.transform_dirs(torch.from_numpy(dirs), torch.from_numpy(mat))
    want = j_gaussian.transform_dirs(jnp.asarray(dirs), jnp.asarray(mat))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("sh_degree,offset", [(None, False), (3, True)],
                         ids=["precomp", "sh3-offset"])
def test_preprocess_surfel_matches_jax(sh_degree, offset):
    scene = surfel_scene(n=80, seed=3, sh_degree=sh_degree)
    scene["xyz"][:5, 2] = -4.0  # behind the camera
    kw = {}
    if offset:
        off = np.random.default_rng(1).normal(size=(80, 2)).astype(np.float32)
        kw = dict(means2d_offset=off)
    want = jax_preprocess(scene, **{k: jnp.asarray(v) for k, v in kw.items()})
    got = torch_preprocess(scene, **{k: torch.from_numpy(v) for k, v in kw.items()})
    assert got._fields == want._fields
    for name, a, b in zip(got._fields, got, want):
        a, b = a.numpy(), np.asarray(b)
        assert a.dtype == b.dtype, name
        if a.dtype.kind == "f":
            np.testing.assert_allclose(a, b, rtol=1e-5, atol=1e-5, err_msg=name)
        else:
            np.testing.assert_array_equal(a, b, err_msg=name)
    assert got.valid.any() and not got.valid[:5].any()


def test_k1_without_cull_matches_golden_binning():
    """K1's plain version with ``cull=False``: every tile of each rect, in
    the golden binning.bin_gaussians's per-tile order."""
    scene = surfel_scene(n=80, seed=5, w=80, h=48)
    gx, gy = (80 + 15) // 16, (48 + 15) // 16
    jpre = jax_preprocess(scene)
    ref = j_binning.bin_gaussians(j_gaussian.Preprocessed(
        valid=jpre.valid, depths=jpre.depths, means2d=jpre.mean2d,
        conic=jnp.zeros_like(jpre.mean2d[:, :1]), opacities=jpre.opacities,
        colors=jpre.colors, radii=jpre.radii, rect_min=jpre.rect_min, rect_max=jpre.rect_max,
        tiles_touched=jpre.tiles_touched), gx, gy, 4096)
    pre = torch_preprocess(scene)
    got = t_binning.bin_gaussians(t_surfel.binning_input(pre), gx, gy, cull=False)
    assert got.num_rendered == int(ref.num_rendered) == int(pre.tiles_touched.sum())
    gid, start, count = (np.asarray(x) for x in (ref.gauss_id, ref.tile_start, ref.tile_count))
    pl = got.point_list.numpy()
    for t, (s, e) in enumerate(got.ranges.numpy()):
        assert list(pl[s:e]) == list(gid[start[t]:start[t] + count[t]]), t


def test_k1_vanilla_mode_keeps_the_cull():
    """``cull=True`` is the default, the vanilla K1: on the same rects, its
    entries are the no-cull entries that pass tile_max_alpha_keep."""
    from tests.test_rasterize import _make_scene

    s = _make_scene(n=120, seed=2, w=80, h=48)
    st = s["settings"]
    pre = t_gaussian.Preprocessed(*(torch.tensor(np.asarray(x)) for x in j_gaussian.preprocess(
        jnp.asarray(s["means"]), jnp.asarray(s["opac"]), st.viewmatrix, st.projmatrix,
        st.campos, 80, 48, st.tanfovx, st.tanfovy, colors_precomp=jnp.asarray(s["colors"]),
        scales=jnp.asarray(s["scales"]), rotations=jnp.asarray(s["quats"]))))
    keys, gids = t_binning.duplicate_with_keys_plain(pre, 5)
    keys_c, gids_c = t_binning.duplicate_with_keys_plain(pre, 5, cull=True)
    all_keys, all_gids = t_binning.duplicate_with_keys_plain(pre, 5, cull=False)
    assert torch.equal(keys, keys_c) and torch.equal(gids, gids_c)
    assert all_keys.shape[0] == int(pre.tiles_touched.sum()) > keys.shape[0]
    tile = all_keys >> 32
    g = all_gids.long()
    keep = t_binning.tile_max_alpha_keep(
        pre.means2d[g, 0], pre.means2d[g, 1], pre.conic[g, 0], pre.conic[g, 1],
        pre.conic[g, 2], pre.opacities[g], tile % 5, tile // 5)
    assert torch.equal(all_keys[keep], keys) and torch.equal(all_gids[keep], gids)


def test_two_column_scale_model_matches_jax(tmp_path):
    """A ``scale: 2`` config gives 2-column log-scales from create_from_attribute
    and writes only scale_0 and scale_1."""
    rng = np.random.default_rng(0)
    xyz = rng.normal(size=(40, 3)).astype(np.float32)
    rgb = rng.uniform(size=(40, 3)).astype(np.float32)
    t_pcd = t_models.make({"name": "vanilla_pcd", "attributes": SURFEL_ATTRS}, device="cpu")
    j_pcd = j_models.make({"name": "vanilla_pcd", "attributes": SURFEL_ATTRS})
    t_pcd.create_from_attribute(xyz=xyz, rgb=rgb)
    j_pcd.create_from_attribute(xyz=xyz, rgb=rgb)
    assert t_pcd._scale.shape == (40, 2)
    for k in ("xyz", "f_dc", "f_rest", "opacity", "scale", "rot"):
        np.testing.assert_allclose(getattr(t_pcd, "_" + k).numpy(),
                                   np.asarray(getattr(j_pcd, "_" + k)), rtol=1e-6, err_msg=k)
    ply = str(tmp_path / "surfels.ply")
    t_pcd.export(ply)
    from gaustudio_torch.utils.ply import read_ply

    assert sorted(k for k in read_ply(ply)["vertex"] if k.startswith("scale")) == [
        "scale_0", "scale_1"]
    back = j_models.make({"name": "vanilla_pcd", "attributes": SURFEL_ATTRS})
    back.load(ply)
    np.testing.assert_allclose(np.asarray(back._scale), t_pcd._scale.numpy(), rtol=0)
