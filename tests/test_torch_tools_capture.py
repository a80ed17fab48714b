"""The capture half of gaustudio_torch/tools against the JAX package's
tools/: the numpy mesh and colour generators (equal, dtypes too), the orbit
rings, the torch colour fields against the numpy ones, render_gt and
make_fixture's capture at 32 px, the JAX capture rasterizer's fault that
the port does not copy, the .npz capture cache, and the subpackage's
imports."""

import ast
import glob
import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import tools.make_atscale_capture as j_cap
import tools.make_fixture as j_fix
import tools.train_at_scale as j_tas
from gaustudio_torch.ops import mesh_raster as t_mr
from gaustudio_torch.tools import make_atscale_capture as t_cap
from gaustudio_torch.tools import make_fixture as t_fix
from gaustudio_torch.tools import train_at_scale as t_tas
from gaustudio_torch.utils.mesh import sample_mesh_surface
from gaustudio_tpu.cameras import camera_paths
from gaustudio_tpu.datasets.utils import camera_to_JSON as j_camera_to_json
from gaustudio_tpu.ops import mesh_raster as j_mr
from tests.test_torch_mesh_raster import _is_tie

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SIZE = 32
VIEWS = 4

# name -> (port call, JAX call): each returns an array or a tuple of arrays
_PTS = np.random.default_rng(0).uniform(-3.5, 3.5, (4000, 3)).astype(np.float32)
GENERATORS = {
    "icosphere": (lambda: t_fix.icosphere(3, radius=0.8), lambda: j_fix.icosphere(3, radius=0.8)),
    "icosphere_5": (lambda: t_fix.icosphere(5, 0.34), lambda: j_fix.icosphere(5, 0.34)),
    "box": (lambda: t_fix.box([0.85, -0.35, 0.15], [0.3, 0.3, 0.3]),
            lambda: j_fix.box([0.85, -0.35, 0.15], [0.3, 0.3, 0.3])),
    "scene_mesh": (t_fix.scene_mesh, j_fix.scene_mesh),
    "grid_plane": (lambda: t_tas.grid_plane([0.1, 0.0, -0.2], 1.3, -1.11, cells=17),
                   lambda: j_tas.grid_plane([0.1, 0.0, -0.2], 1.3, -1.11, cells=17)),
    "scene_mesh_large": (t_tas.scene_mesh_large, j_tas.scene_mesh_large),
    "scene_mesh_rich": (t_tas.scene_mesh_rich, j_tas.scene_mesh_rich),
    "scene_mesh_bench": (t_tas.scene_mesh_bench, j_tas.scene_mesh_bench),
    "color_fn": (lambda: t_fix.color_fn(_PTS), lambda: j_fix.color_fn(_PTS)),
    "color_fn_rich": (lambda: t_tas.color_fn_rich(_PTS), lambda: j_tas.color_fn_rich(_PTS)),
    "color_fn_bench": (lambda: t_tas.color_fn_bench(_PTS), lambda: j_tas.color_fn_bench(_PTS)),
}


@pytest.mark.parametrize("name", list(GENERATORS))
def test_generator_equals_the_jax_tools(name):
    got, want = (f() for f in GENERATORS[name])
    got, want = (x if isinstance(x, tuple) else (x,) for x in (got, want))
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert g.dtype == w.dtype and g.shape == w.shape
        np.testing.assert_array_equal(g, w)


def _host(t):
    return t.cpu().numpy() if isinstance(t, torch.Tensor) else np.asarray(t)


@pytest.mark.parametrize("kind", ["large", "rich", "bench"])
def test_orbit_rings_match_jax(kind):
    size, views = (512, 64) if kind == "large" else (800, 144)
    got = t_tas.orbit_rings(size, views, device="cpu", **t_tas.ORBITS[kind])
    want = j_tas.orbit_rings(size, views, **j_tas.ORBITS[kind])
    # get_path_from_orbit steps 360 // n degrees: 64 views at 512 px are 2 x 33
    assert t_tas.ORBITS == j_tas.ORBITS and len(got) == len(want) >= views
    for g, w in zip(got, want):
        for attr in ("world_view_transform", "full_proj_transform", "camera_center"):
            np.testing.assert_allclose(_host(getattr(g, attr)), _host(getattr(w, attr)),
                                       rtol=0, atol=1e-6, err_msg=attr)
        np.testing.assert_allclose(g.R, w.R, atol=1e-6)
        np.testing.assert_allclose(g.T, w.T, atol=1e-6)
        assert (g.FoVx, g.FoVy, g.image_width, g.image_height, g.image_name) == (
            w.FoVx, w.FoVy, w.image_width, w.image_height, w.image_name)


@pytest.mark.parametrize("kind", ["rich", "bench"])
def test_torch_color_field_matches_numpy(kind):
    """The per-pixel field in torch float32 against the numpy function on
    surface samples of the scene it textures, on the CPU, twice. Tolerance:
    abs 1e-6 + rel 1e-6; the finest octave's argument reaches ~200 rad,
    where one float32 ulp of it (1.5e-5) times the octave's amplitude (0.04)
    is 6e-7, so a sin that rounds differently in the inner octave moves a
    colour by ~1e-6."""
    verts, faces = t_tas.MESHES[kind]()
    pts = sample_mesh_surface(verts, faces, 100_000, seed=1)
    want = t_tas.COLORS[kind](pts)
    for _ in range(2):
        got = t_tas.TORCH_FIELDS[t_tas.COLORS[kind]](torch.from_numpy(pts))
        assert got.dtype == torch.float32
        np.testing.assert_allclose(got.numpy(), want, rtol=1e-6, atol=1e-6)


def _entries(verts, faces, cam) -> int:
    """A JAX entry buffer (a multiple of its 2048-entry chunk) that holds
    every (face, 16 px tile) entry of the view."""
    total = int(t_tas.jax_tiles_touched(torch.from_numpy(verts),
                                        torch.from_numpy(faces.astype(np.int64)), cam).sum())
    return max(2048, -(-total // 2048) * 2048)


def _fragments(verts, faces, cam, entries, jax_faces=None):
    """(JAX tri ids, port fragments) of one camera; the JAX rasterizer with
    ``entries`` entries."""
    jf = j_mr.rasterize_mesh(jnp.asarray(verts), jnp.asarray(faces if jax_faces is None
                                                              else jax_faces),
                             jnp.asarray(cam.world_view_transform),
                             jnp.asarray(cam.full_proj_transform), SIZE, SIZE,
                             num_entries=entries, chunk=2048)
    tf = t_mr.rasterize_mesh(torch.from_numpy(verts), torch.from_numpy(faces.astype(np.int64)),
                             torch.from_numpy(np.asarray(cam.world_view_transform)),
                             torch.from_numpy(np.asarray(cam.full_proj_transform)), SIZE, SIZE)
    return np.asarray(jf.tri_id), tf


@pytest.fixture(scope="module")
def plain_scene():
    """The plain capture's mesh at 32 px: its JAX and port cameras and each
    view's (JAX tri ids, port fragments)."""
    verts, faces = t_tas.scene_mesh_large()
    jcams = j_tas.orbit_rings(SIZE, VIEWS, **j_tas.ORBITS["large"])
    tcams = t_tas.orbit_rings(SIZE, VIEWS, device="cpu", **t_tas.ORBITS["large"])
    entries = max(_entries(verts, faces, t) for t in tcams)  # one compile for every view
    return verts, faces, jcams, tcams, [_fragments(verts, faces, j, entries) for j in jcams]


@pytest.mark.parametrize("per_pixel", [False, True], ids=["vertex_colour", "per_pixel"])
def test_render_gt_matches_jax(plain_scene, per_pixel):
    """The plain capture's mesh (every face on screen: see the next test)
    with vertex colours and with the bench's per-pixel field: triangle ids
    equal but at ties (a pixel centre within 1e-3 px of an edge of either
    triangle); colours within 1e-4 elsewhere (the two rasterizers'
    barycentrics differ by < 1e-4)."""
    verts, faces, jcams, tcams, frags = plain_scene
    j_col, t_col = ((j_tas.color_fn_bench, t_tas.color_fn_bench) if per_pixel
                    else (j_fix.color_fn, t_fix.color_fn))
    want = j_tas.render_gt(verts, faces, jcams, col_fn=j_col, per_pixel=per_pixel)
    got = t_tas.render_gt(verts, faces, tcams, col_fn=t_col, per_pixel=per_pixel, device="cpu")
    ties = 0
    for cam, g, w, (jt, tf) in zip(jcams, got, want, frags):
        tt = tf.tri_id.numpy()
        differ = np.argwhere(jt != tt)
        for y, x in differ:
            assert _is_tie(verts, faces, cam, y, x, (tt[y, x], jt[y, x])), (y, x)
        ties += len(differ)
        same = jt == tt
        assert g.dtype == torch.float32 and g.shape == (SIZE, SIZE, 3)
        np.testing.assert_allclose(g.numpy()[same], w[same], rtol=0, atol=1e-4)
    assert ties <= 0.01 * VIEWS * SIZE * SIZE


def test_jax_capture_rasterizer_misassigns_faces_after_one_off_screen():
    """The JAX rasterize_mesh maps an entry to the rank of its face among the
    faces that touch a tile, so after a face that touches none every face
    is drawn with another face's entries: on the rich capture's first view
    it draws most of the ground slab wrong. Given only the faces that touch
    a tile (rank = index), it draws what the port draws; jax_capture_faults
    counts the faces it misassigns."""
    verts, faces = t_tas.scene_mesh_rich()
    jcam = j_tas.orbit_rings(SIZE, 2, **j_tas.ORBITS["rich"])[0]
    tcam = t_tas.orbit_rings(SIZE, 2, device="cpu", **t_tas.ORBITS["rich"])[0]
    jt, tf = _fragments(verts, faces, jcam, _entries(verts, faces, tcam))
    wrong = int((jt != tf.tri_id.numpy()).sum())
    v = torch.from_numpy(verts)
    f = torch.from_numpy(faces.astype(np.int64))
    dropped, misassigned = t_tas.jax_capture_faults(v, f, tcam)
    assert dropped == 0 and misassigned > 1000 and wrong > 50
    # the faces that touch a 16 px tile, in order
    kept = torch.nonzero(t_tas.jax_tiles_touched(v, f, tcam) > 0).squeeze(1).numpy()
    jt_kept, _ = _fragments(verts, faces, jcam, _entries(verts, faces[kept], tcam),
                            jax_faces=faces[kept])
    jt_kept = np.where(jt_kept >= 0, kept[np.maximum(jt_kept, 0)], -1)
    np.testing.assert_array_equal(jt_kept, tf.tri_id.numpy())
    assert t_tas.jax_capture_faults(v, f[kept], tcam) == (0, 0)
    # the plain capture's mesh is all on screen at this size
    verts, faces = t_tas.scene_mesh_large()
    for cam in t_tas.orbit_rings(SIZE, VIEWS, device="cpu", **t_tas.ORBITS["large"]):
        assert t_tas.jax_capture_faults(torch.from_numpy(verts),
                                        torch.from_numpy(faces.astype(np.int64)), cam) == (0, 0)


def test_make_fixture_capture_matches_jax():
    """make_fixture's cameras.json entries within 1e-6 and its quantised
    images equal to the JAX tool's as uint8, one view of each ring (the
    fixture's mesh is all on screen)."""
    verts, faces = t_fix.scene_mesh()
    tcams = t_fix.fixture_cameras(2, SIZE, device="cpu")
    jcams = camera_paths.get_path_from_orbit(np.zeros(3), 3.0, elevation=-30, num_cam=1,
                                             image_size=SIZE, fov_deg=50)
    jcams += camera_paths.get_path_from_orbit(np.zeros(3), 3.0, elevation=28, num_cam=1,
                                              image_size=SIZE, fov_deg=50)
    from gaustudio_torch.datasets.utils import camera_to_JSON

    for i, (t, j) in enumerate(zip(tcams, jcams)):
        j.image_name = f"{i:05d}.png"
        got, want = camera_to_JSON(i, t), j_camera_to_json(i, j)
        assert got.keys() == want.keys() and got["img_name"] == want["img_name"]
        for k in ("position", "rotation", "fx", "fy", "cx", "cy", "width", "height"):
            np.testing.assert_allclose(got[k], want[k], rtol=0, atol=1e-6, err_msg=k)
    got = t_fix.render_mesh_views(verts, faces, tcams, device="cpu")
    want = j_fix.render_mesh_views(verts, faces, jcams)
    for g, w in zip(got, want):
        assert g.dtype == np.float32
        np.testing.assert_array_equal((g * 255).astype(np.uint8), (w * 255).astype(np.uint8))


def test_capture_cache_round_trip(tmp_path, monkeypatch):
    """make_atscale_capture writes the capture train_at_scale's render_gt
    renders; load_capture gives it back on the orbit cameras."""
    monkeypatch.setattr(t_cap, "build_path", lambda name: str(tmp_path / name))
    assert t_cap.cache_path(SIZE, VIEWS, kind="bench") == str(
        tmp_path / f"atscale_capture_{SIZE}_{VIEWS}_bench2.npz")
    assert os.path.basename(j_cap.cache_path(SIZE, VIEWS, kind="bench")) == os.path.basename(
        t_cap.cache_path(SIZE, VIEWS, kind="bench"))
    assert t_cap.load_capture(SIZE, 2, kind="bench", device="cpu") is None
    t_cap.main(["--size", str(SIZE), "--views", "2", "--bench", "--device", "cpu"])
    cams = t_cap.load_capture(SIZE, 2, kind="bench", device="cpu")
    verts, faces = t_tas.scene_mesh_bench()
    want = t_tas.render_gt(verts, faces, t_tas.orbit_rings(SIZE, 2, device="cpu",
                                                           **t_tas.ORBITS["bench"]),
                           col_fn=t_tas.color_fn_bench, per_pixel=True, device="cpu")
    assert len(cams) == 2
    for cam, w in zip(cams, want):
        assert cam.image.dtype == torch.float32
        torch.testing.assert_close(cam.image, w, rtol=0, atol=0)


def test_tools_import_neither_jax_nor_the_jax_package():
    """No import statement of gaustudio_torch/tools names jax, gaustudio_tpu
    or the repo's tools package, and importing every module in a fresh
    interpreter loads none of them."""
    sources = sorted(glob.glob(os.path.join(REPO, "gaustudio_torch", "tools", "*.py")))
    names = []
    for path in sources:
        with open(path) as f:
            tree = ast.parse(f.read())
        for node in ast.walk(tree):
            if isinstance(node, ast.Import):
                names += [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom):
                names.append(node.module or "")
    assert names and not [n for n in names if n.split(".")[0] in ("jax", "gaustudio_tpu", "tools")]
    mods = [os.path.splitext(os.path.basename(p))[0] for p in sources]
    code = ("import importlib, json, sys\n"
            + "".join(f"importlib.import_module('gaustudio_torch.tools.{m}')\n" for m in mods
                      if m != "__init__")
            + "print(json.dumps(sorted({k.split('.')[0] for k in sys.modules})))")
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True, text=True,
                         check=True, env={**os.environ, "PYTHONPATH": REPO})
    loaded = json.loads(out.stdout.strip().splitlines()[-1])
    assert "gaustudio_torch" in loaded
    assert not {"jax", "gaustudio_tpu", "tools"} & set(loaded)
