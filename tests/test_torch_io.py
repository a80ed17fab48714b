"""Port parity of image decoding and PLY IO (gaustudio_torch against
gaustudio_tpu, both on the CPU): ``utils/image.load_image`` against the JAX
``Camera.load_image`` on generated files, through PIL and through the stdlib
PNG reader with PIL's import blocked; ``utils/ply.read_ply`` against the JAX
reader on binary and ASCII PLYs with and without a face list; grey and
16-bit PNGs read back as written."""

import sys

import numpy as np
import pytest
from PIL import Image

from gaustudio_torch.utils import image as t_image
from gaustudio_torch.utils import ply as t_ply
from gaustudio_tpu.utils import ply as j_ply

PNG_MODES = ("grey", "grey_1bit", "grey_alpha", "palette", "palette_4bit",
             "palette_transparency", "rgb", "rgba")


def _write_image(kind: str, path: str) -> None:
    """A seeded 13x9 image of ``kind``: a PNG mode, or a JPEG with an EXIF
    orientation that transposes it."""
    rng = np.random.default_rng(len(kind))
    rgba = rng.integers(0, 256, (13, 9, 4), dtype=np.uint8)
    rgb = Image.fromarray(rgba[..., :3])
    if kind == "grey":
        rgb.convert("L").save(path)
    elif kind == "grey_1bit":
        rgb.convert("1").save(path)
    elif kind == "grey_alpha":
        Image.fromarray(rgba[..., 2:], "LA").save(path)
    elif kind == "palette":
        rgb.convert("P", palette=Image.ADAPTIVE, colors=256).save(path, bits=8)
    elif kind == "palette_4bit":
        rgb.convert("P", palette=Image.ADAPTIVE, colors=16).save(path)
    elif kind == "palette_transparency":
        rgb.convert("P", palette=Image.ADAPTIVE, colors=16).save(path, transparency=3)
    elif kind == "rgb":
        rgb.save(path)
    elif kind == "rgba":
        Image.fromarray(rgba, "RGBA").save(path)
    elif kind == "jpeg":
        exif = Image.Exif()
        exif[0x0112] = 6  # orientation: rotated 90 degrees
        rgb.save(path, exif=exif, quality=90)
    else:
        raise ValueError(kind)


def _jax_load(path: str, bg):
    from gaustudio_tpu.cameras import Camera

    cam = Camera()
    cam.load_image(path, bg_color=bg)
    return cam.image, cam.mask


def _assert_same(got, want):
    np.testing.assert_array_equal(got[0], np.asarray(want[0]))
    assert (got[1] is None) == (want[1] is None)
    if want[1] is not None:
        np.testing.assert_array_equal(got[1], np.asarray(want[1]))


@pytest.mark.parametrize("kind", PNG_MODES + ("jpeg",))
def test_load_image_matches_jax(kind, tmp_path):
    """Through PIL, as the JAX package decodes; the JPEG's EXIF orientation
    is applied by both."""
    path = str(tmp_path / ("im.jpg" if kind == "jpeg" else "im.png"))
    _write_image(kind, path)
    bg = (0.2, 0.5, 1.0)
    got, want = t_image.load_image(path, bg), _jax_load(path, bg)
    _assert_same(got, want)
    if kind == "jpeg":
        assert got[0].shape == (9, 13, 3)


@pytest.mark.parametrize("kind", PNG_MODES)
def test_load_image_without_pil_matches_jax(kind, tmp_path, monkeypatch):
    """The stdlib PNG reader, with PIL's import blocked, decodes PNGs of
    8-bit samples, and grey and palette ones of 1 or 4 bits, bit for bit as
    the JAX package does through PIL."""
    path = str(tmp_path / "im.png")
    _write_image(kind, path)
    want = _jax_load(path, None)
    monkeypatch.setitem(sys.modules, "PIL", None)
    with pytest.raises(ImportError):
        from PIL import Image  # noqa: F401
    _assert_same(t_image.load_image(path), want)


@pytest.mark.parametrize("kind", ["jpeg", "grey16"])
def test_load_image_without_pil_names_pil_for_other_files(kind, tmp_path, monkeypatch):
    path = str(tmp_path / ("im.jpg" if kind == "jpeg" else "im.png"))
    if kind == "jpeg":
        _write_image(kind, path)
    else:
        Image.fromarray(np.arange(117, dtype=np.uint16).reshape(13, 9) * 500).save(path)
    monkeypatch.setitem(sys.modules, "PIL", None)
    with pytest.raises(ValueError, match="PIL"):
        t_image.load_image(path)


@pytest.mark.parametrize("pil", [True, False], ids=["pil", "stdlib"])
def test_grey_png_reads_back(pil, tmp_path, monkeypatch):
    """write_png's grey PNGs (the masks of gs-extract-mesh) read back as
    written, through PIL (mode L, as the JAX package writes them) and
    through the stdlib reader; a 16-bit grey PNG (a depth map) reads back
    as its uint16 samples."""
    rng = np.random.default_rng(0)
    grey = rng.integers(0, 256, (13, 9), dtype=np.uint8)
    depth = rng.integers(0, 65536, (13, 9), dtype=np.uint16)
    t_image.write_png(str(tmp_path / "g.png"), grey)
    Image.fromarray(depth).save(tmp_path / "d.png")
    with Image.open(tmp_path / "g.png") as img:
        assert img.mode == "L"
        np.testing.assert_array_equal(np.asarray(img), grey)
    if not pil:
        monkeypatch.setitem(sys.modules, "PIL", None)
    np.testing.assert_array_equal(t_image.load_grey8(str(tmp_path / "g.png")), grey)
    np.testing.assert_array_equal(t_image.load_rgb8(str(tmp_path / "g.png")),
                                  np.repeat(grey[..., None], 3, axis=2))
    got = t_image.load_samples(str(tmp_path / "d.png"))
    assert got.dtype == np.uint16
    np.testing.assert_array_equal(got, depth)


def _faces(n_vertices: int, n_faces: int, seed: int) -> np.ndarray:
    return np.random.default_rng(seed).integers(0, n_vertices, (n_faces, 3)).astype(np.int32)


def _vertices(n: int, seed: int) -> dict:
    rng = np.random.default_rng(seed)
    return {"x": rng.normal(size=n).astype(np.float32), "y": rng.normal(size=n).astype(np.float32),
            "z": rng.normal(size=n).astype(np.float32),
            "red": rng.integers(0, 256, n).astype(np.uint8),
            "quality": rng.normal(size=n).astype(np.float64)}


def _big_endian_by_hand(path: str) -> None:
    """A big-endian PLY whose face element holds a scalar before its list."""
    v = _vertices(5, 7)
    faces = _faces(5, 4, 7)
    header = ("ply\nformat binary_big_endian 1.0\ncomment written by hand\n"
              "element vertex 5\nproperty float x\nproperty float y\nproperty float z\n"
              "property uchar red\nproperty double quality\n"
              "element face 4\nproperty uchar flag\nproperty list uchar int vertex_indices\n"
              "end_header\n")
    vrec = np.empty(5, [("x", ">f4"), ("y", ">f4"), ("z", ">f4"), ("red", "u1"),
                        ("quality", ">f8")])
    for k in v:
        vrec[k] = v[k]
    frec = np.empty(4, [("flag", "u1"), ("n", "u1"), ("v", ">i4", (3,))])
    frec["flag"] = np.arange(4)
    frec["n"] = 3
    frec["v"] = faces
    with open(path, "wb") as f:
        f.write(header.encode("ascii") + vrec.tobytes() + frec.tobytes())


@pytest.mark.parametrize("case", ["binary_faces", "ascii_faces", "ascii", "port_binary_faces",
                                  "big_endian_by_hand"])
def test_read_ply_matches_jax(case, tmp_path):
    """Both readers on one file give the same elements, properties and
    values; the faces of a written mesh come back as written."""
    path = str(tmp_path / "m.ply")
    v, faces = _vertices(40, 1), _faces(40, 25, 1)
    if case == "binary_faces":
        j_ply.write_ply(path, v, faces=faces)
    elif case == "ascii_faces":
        j_ply.write_ply(path, v, faces=faces, ascii_format=True)
    elif case == "ascii":
        faces = None
        j_ply.write_ply(path, v, ascii_format=True)
    elif case == "port_binary_faces":
        t_ply.write_ply(path, v, faces=faces)
    else:
        _big_endian_by_hand(path)
        faces = None
    got, want = t_ply.read_ply(path), j_ply.read_ply(path)
    assert {k: list(p) for k, p in got.items()} == {k: list(p) for k, p in want.items()}
    for elem, props in want.items():
        for name, arr in props.items():
            np.testing.assert_array_equal(got[elem][name], arr, err_msg=f"{elem}.{name}")
    if faces is not None:
        np.testing.assert_array_equal(got["face"]["vertex_indices"], faces)
        assert got["face"]["vertex_indices"].dtype == np.int32
    if case in ("binary_faces", "port_binary_faces"):
        for k in v:
            np.testing.assert_array_equal(got["vertex"][k], v[k])


def test_read_ply_ragged_face_list(tmp_path):
    """Faces of mixed length (a quad beside a triangle) come back as an
    object array of rows; the JAX reader stacks rows and cannot take them."""
    path = str(tmp_path / "q.ply")
    with open(path, "w") as f:
        f.write("ply\nformat ascii 1.0\nelement vertex 4\nproperty float x\nproperty float y\n"
                "property float z\nelement face 2\nproperty list uchar int vertex_indices\n"
                "end_header\n0 0 0\n1 0 0\n1 1 0\n0 1 0\n4 0 1 2 3\n3 0 2 3\n")
    faces = t_ply.read_ply(path)["face"]["vertex_indices"]
    assert faces.dtype == object and [r.tolist() for r in faces] == [[0, 1, 2, 3], [0, 2, 3]]
