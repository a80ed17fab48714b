"""Port parity: the plain compositor (K3's plain version) and the whole
gaustudio_torch rasterize() against the JAX golden rasterize(backend="xla"),
with the tolerances of tests/test_pallas.py. The port culls entries whose
max alpha over a tile is below 1/255, the golden does not, so n_contrib can
only shrink and keeps the golden's zero pattern."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from gaustudio_torch.ops import binning as t_binning
from gaustudio_torch.ops import composite as t_composite
from gaustudio_torch.ops import rasterize as t_rasterize
from gaustudio_torch.ops.gaussian import Preprocessed as TPre
from gaustudio_tpu.ops import binning as j_binning
from gaustudio_tpu.ops import gaussian as j_gaussian
from gaustudio_tpu.ops import rasterize as j_rasterize
from gaustudio_tpu.ops import rasterize_ref
from tests.test_rasterize import _make_scene

SCENES = [(4, 60, 48, 32), (1, 200, 80, 48)]
SCENE_IDS = ["48x32", "80x48"]


def _t(a):
    return torch.tensor(np.asarray(a))


def assert_outputs_match(got, want):
    """got / want: dicts of numpy arrays with the rasterize() output keys."""
    tol = {
        "render": dict(rtol=2e-4, atol=2e-5),
        "rendered_final_opacity": dict(rtol=2e-4, atol=2e-5),
        "rendered_depth": dict(rtol=2e-4, atol=2e-4),
        "rendered_median_depth": dict(rtol=1e-4, atol=1e-4),
        "rendered_median_weight": dict(rtol=2e-4, atol=1e-5),
    }
    for key, kw in tol.items():
        assert got[key].shape == want[key].shape, key
        np.testing.assert_allclose(got[key], want[key], err_msg=key, **kw)
    np.testing.assert_array_equal(got["rendered_median_id"], want["rendered_median_id"])
    assert got["rendered_median_id"].dtype == np.int32
    nc, ref_nc = got["n_contrib"], want["n_contrib"]
    assert nc.shape == ref_nc.shape
    assert (nc <= ref_nc).all()
    np.testing.assert_array_equal(nc == 0, ref_nc == 0)


@pytest.mark.parametrize("seed,n,w,h,opaque", [s + (False,) for s in SCENES] + [
    (2, 300, 50, 37, True)], ids=SCENE_IDS + ["50x37-opaque"])
def test_plain_compositor_matches_jax_golden(seed, n, w, h, opaque):
    scene = _make_scene(n=n, seed=seed, w=w, h=h)
    if opaque:  # dense, nearly opaque splats: pixels stop early at T < 1e-4
        rng = np.random.default_rng(seed)
        scene["opac"] = rng.uniform(0.9, 0.999, n).astype(np.float32)
        scene["scales"] = scene["scales"] * 2.0
    st = scene["settings"]
    gx, gy = (w + 15) // 16, (h + 15) // 16
    pre = j_gaussian.preprocess(
        jnp.asarray(scene["means"]), jnp.asarray(scene["opac"]),
        st.viewmatrix, st.projmatrix, st.campos, w, h, st.tanfovx, st.tanfovy,
        colors_precomp=jnp.asarray(scene["colors"]),
        scales=jnp.asarray(scene["scales"]), rotations=jnp.asarray(scene["quats"]))
    ref_bin = j_binning.bin_gaussians(pre, gx, gy, 4096)
    ref = rasterize_ref.composite(
        gx, gy, 256, pre.means2d, pre.conic, pre.colors, pre.depths,
        pre.opacities, jnp.zeros(3), ref_bin.gauss_id, ref_bin.tile_id,
        ref_bin.entry_valid, ref_bin.tile_start)
    img = lambda x: np.asarray(rasterize_ref.tiles_to_image(x, gx, gy, h, w))
    want = {
        "render": np.moveaxis(img(ref.color), -1, 0),
        "rendered_depth": img(ref.depth)[None],
        "rendered_median_depth": img(ref.median_depth)[None],
        "rendered_median_weight": img(ref.median_weight)[None],
        "rendered_median_id": img(ref.median_id)[None].astype(np.int32),
        "rendered_final_opacity": 1.0 - img(ref.final_T)[None],
        "n_contrib": img(ref.n_contrib),
    }

    tp = TPre(*(_t(x) for x in pre))
    binned = t_binning.bin_gaussians(tp, gx, gy)
    out = t_composite.render_tiles(binned.ranges, binned.point_list, tp.means2d, tp.conic,
                                   tp.opacities, tp.colors, tp.depths, gx, gy, w, h)
    got = {
        "render": out.color.numpy(),
        "rendered_depth": out.depth.numpy(),
        "rendered_median_depth": out.median_depth.numpy(),
        "rendered_median_weight": out.median_weight.numpy(),
        "rendered_median_id": out.median_id.numpy(),
        "rendered_final_opacity": 1.0 - out.final_T.numpy()[None],
        "n_contrib": out.n_contrib.numpy(),
    }
    assert_outputs_match(got, want)
    assert (want["rendered_final_opacity"] > 0.5).mean() > 0.1  # not an empty scene
    if opaque:
        assert (want["rendered_final_opacity"] > 1.0 - 1e-3).mean() > 0.3  # the walk ended early


def _settings_both(scene, sh_degree=3):
    st = scene["settings"]
    ts = t_rasterize.RasterizeSettings(
        image_height=st.image_height, image_width=st.image_width,
        tanfovx=st.tanfovx, tanfovy=st.tanfovy, bg=torch.zeros(3),
        viewmatrix=_t(st.viewmatrix), projmatrix=_t(st.projmatrix),
        sh_degree=sh_degree, campos=_t(st.campos))
    return st._replace(backend="xla", sh_degree=sh_degree), ts


@pytest.mark.parametrize("use_sh", [False, True], ids=["colors", "sh3"])
@pytest.mark.parametrize("seed,n,w,h", SCENES, ids=SCENE_IDS)
def test_rasterize_matches_jax_xla(seed, n, w, h, use_sh):
    scene = _make_scene(n=n, seed=seed, w=w, h=h)
    js, ts = _settings_both(scene)
    if use_sh:
        rng = np.random.default_rng(seed + 100)
        shs = (rng.normal(size=(n, 16, 3)) * 0.3).astype(np.float32)
        jkw, tkw = dict(shs=jnp.asarray(shs)), dict(shs=torch.from_numpy(shs))
    else:
        jkw = dict(colors_precomp=jnp.asarray(scene["colors"]))
        tkw = dict(colors_precomp=torch.from_numpy(scene["colors"]))
    jout = j_rasterize.rasterize(
        jnp.asarray(scene["means"]), jnp.asarray(scene["opac"]), js,
        scales=jnp.asarray(scene["scales"]), rotations=jnp.asarray(scene["quats"]), **jkw)
    tout = t_rasterize.rasterize(
        torch.from_numpy(scene["means"]), torch.from_numpy(scene["opac"]), ts,
        scales=torch.from_numpy(scene["scales"]), rotations=torch.from_numpy(scene["quats"]),
        **tkw)
    keys = ("render", "rendered_depth", "rendered_median_depth", "rendered_median_weight",
            "rendered_median_id", "rendered_final_opacity", "n_contrib")
    assert_outputs_match({k: tout[k].numpy() for k in keys},
                         {k: np.asarray(jout[k]) for k in keys})
    np.testing.assert_array_equal(tout["radii"].numpy(), np.asarray(jout["radii"]))
    assert 0 < tout["num_rendered"] <= int(jout["num_rendered"])


def test_plain_backend_equals_auto_on_cpu():
    scene = _make_scene(n=60, seed=4)
    _, ts = _settings_both(scene)
    args = (torch.from_numpy(scene["means"]), torch.from_numpy(scene["opac"]))
    kw = dict(colors_precomp=torch.from_numpy(scene["colors"]),
              scales=torch.from_numpy(scene["scales"]),
              rotations=torch.from_numpy(scene["quats"]))
    a = t_rasterize.rasterize(*args, ts, **kw)
    b = t_rasterize.rasterize(*args, ts._replace(backend="plain"), **kw)
    for k in ("render", "rendered_depth", "rendered_median_id", "n_contrib"):
        assert torch.equal(a[k], b[k]), k
    with pytest.raises(ValueError):
        t_rasterize.rasterize(*args, ts._replace(backend="pallas"), **kw)


def test_empty_view_renders_background():
    """Every Gaussian behind the camera: no entries, zero colour, default median."""
    scene = _make_scene(n=20, seed=0)
    scene["means"][:, 2] = -2.0
    _, ts = _settings_both(scene)
    out = t_rasterize.rasterize(
        torch.from_numpy(scene["means"]), torch.from_numpy(scene["opac"]), ts,
        colors_precomp=torch.from_numpy(scene["colors"]),
        scales=torch.from_numpy(scene["scales"]), rotations=torch.from_numpy(scene["quats"]))
    assert out["num_rendered"] == 0
    assert float(out["render"].abs().max()) == 0.0
    assert torch.all(out["rendered_median_depth"] == 15.0)
    assert torch.all(out["rendered_final_opacity"] == 0.0)
