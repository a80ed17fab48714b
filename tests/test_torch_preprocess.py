"""Port parity: gaustudio_torch.ops.gaussian.preprocess against the JAX
preprocess, on the scene of tests/test_rasterize.py, with precomputed
colours and with seeded degree-3 SH coefficients in their place."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from gaustudio_torch.ops import gaussian as t_gaussian
from gaustudio_torch.ops import rasterize as t_rasterize
from gaustudio_tpu.ops import gaussian as j_gaussian
from tests.test_rasterize import _make_scene

FLOAT_FIELDS = ("depths", "means2d", "conic", "opacities", "colors")
EXACT_FIELDS = ("valid", "radii", "rect_min", "rect_max", "tiles_touched")


def _t(a):
    return torch.tensor(np.asarray(a))


def _inputs(scene, use_sh: bool):
    n = scene["means"].shape[0]
    if use_sh:
        rng = np.random.default_rng(11)
        shs = (rng.normal(size=(n, 16, 3)) * 0.3).astype(np.float32)
        return dict(shs=shs, sh_degree=3)
    return dict(colors_precomp=scene["colors"])


def run_both(scene, use_sh: bool):
    """(JAX Preprocessed, torch Preprocessed) of one scene."""
    st = scene["settings"]
    extra = _inputs(scene, use_sh)
    arrays = {k: v for k, v in extra.items() if isinstance(v, np.ndarray)}
    scalars = {k: v for k, v in extra.items() if not isinstance(v, np.ndarray)}
    j = j_gaussian.preprocess(
        jnp.asarray(scene["means"]), jnp.asarray(scene["opac"]),
        st.viewmatrix, st.projmatrix, st.campos, st.image_width, st.image_height,
        st.tanfovx, st.tanfovy, scales=jnp.asarray(scene["scales"]),
        rotations=jnp.asarray(scene["quats"]),
        **{k: jnp.asarray(v) for k, v in arrays.items()}, **scalars)
    t = t_gaussian.preprocess(
        torch.from_numpy(scene["means"]), torch.from_numpy(scene["opac"]),
        _t(st.viewmatrix), _t(st.projmatrix),
        _t(st.campos), st.image_width, st.image_height,
        st.tanfovx, st.tanfovy, scales=torch.from_numpy(scene["scales"]),
        rotations=torch.from_numpy(scene["quats"]),
        **{k: torch.from_numpy(v) for k, v in arrays.items()}, **scalars)
    return j, t


@pytest.mark.parametrize("use_sh", [False, True], ids=["colors", "sh3"])
@pytest.mark.parametrize("seed,n", [(0, 40), (4, 60)])
def test_preprocess_matches_jax(seed, n, use_sh):
    scene = _make_scene(n=n, seed=seed)
    j, t = run_both(scene, use_sh)
    assert int(t.valid.sum()) > n // 2
    for f in FLOAT_FIELDS:
        want = np.asarray(getattr(j, f))
        got = getattr(t, f).numpy()
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6, err_msg=f)
    for f in EXACT_FIELDS:
        np.testing.assert_array_equal(getattr(t, f).numpy(), np.asarray(getattr(j, f)),
                                      err_msg=f)


def test_mark_visible_matches_jax():
    scene = _make_scene(n=40, seed=2)
    scene["means"][:5, 2] = -1.0  # behind the camera
    st = scene["settings"]
    want = np.asarray(j_gaussian.mark_visible(jnp.asarray(scene["means"]), st.viewmatrix))
    got = t_rasterize.mark_visible(torch.from_numpy(scene["means"]),
                                   _t(st.viewmatrix), None)
    np.testing.assert_array_equal(got.numpy(), want)
    assert not want[:5].any()
