"""PLY reader/writer for Inria-layout Gaussian checkpoints, point clouds and
triangle meshes (numpy only).

Port of gaustudio_tpu/utils/ply.py: binary (either byte order) and ascii
bodies; scalar properties, and list properties such as a mesh's
``face`` ``vertex_indices``. ``point_cloud.ply`` files hold one ``vertex``
element of float properties (x, y, z, nx, ny, nz, f_dc_*, f_rest_*,
opacity, scale_*, rot_*).
"""

from __future__ import annotations

import io
from typing import Dict, Optional

import numpy as np

_PLY_TO_NP = {
    "char": "i1", "int8": "i1",
    "uchar": "u1", "uint8": "u1",
    "short": "i2", "int16": "i2",
    "ushort": "u2", "uint16": "u2",
    "int": "i4", "int32": "i4",
    "uint": "u4", "uint32": "u4",
    "float": "f4", "float32": "f4",
    "double": "f8", "float64": "f8",
}
_NP_TO_PLY = {
    "int8": "char", "uint8": "uchar", "int16": "short", "uint16": "ushort",
    "int32": "int", "uint32": "uint", "float32": "float", "float64": "double",
}


def _list_column(rows: list, dtype: str) -> np.ndarray:
    """A list property's rows: [count, length] when every row has one length
    (a triangle mesh's faces), else an object array of rows."""
    if rows and all(len(r) == len(rows[0]) for r in rows):
        return np.asarray(rows, dtype).reshape(len(rows), len(rows[0]))
    out = np.empty(len(rows), object)
    out[:] = [np.asarray(r, dtype) for r in rows]
    return out


def _read_ascii(body: bytes, elements: list) -> Dict[str, Dict[str, np.ndarray]]:
    lines = iter(body.decode("ascii").splitlines())
    out = {}
    for name, count, props in elements:
        cols = {p[-1]: [] for p in props}
        for _ in range(count):
            vals = next(lines).split()
            i = 0
            for p in props:
                if p[0] == "scalar":
                    cols[p[2]].append(float(vals[i]))
                    i += 1
                else:
                    n = int(vals[i])
                    cols[p[3]].append([float(v) for v in vals[i + 1:i + 1 + n]])
                    i += 1 + n
        out[name] = {p[-1]: (np.asarray(cols[p[2]], p[1]) if p[0] == "scalar"
                             else _list_column(cols[p[3]], p[2])) for p in props}
    return out


def _read_binary(body: bytes, elements: list, endian: str) -> Dict[str, Dict[str, np.ndarray]]:
    out = {}
    offset = 0
    for name, count, props in elements:
        if all(p[0] == "scalar" for p in props):
            dtype = np.dtype([(p[2], endian + p[1]) for p in props])
            arr = np.frombuffer(body, dtype=dtype, count=count, offset=offset)
            offset += dtype.itemsize * count
            out[name] = {p[2]: np.ascontiguousarray(arr[p[2]]).astype(p[1]) for p in props}
            continue
        cols = {p[-1]: [] for p in props}
        for _ in range(count):
            for p in props:
                if p[0] == "scalar":
                    cols[p[2]].append(np.frombuffer(body, endian + p[1], 1, offset)[0])
                    offset += np.dtype(p[1]).itemsize
                else:
                    n = int(np.frombuffer(body, endian + p[1], 1, offset)[0])
                    offset += np.dtype(p[1]).itemsize
                    cols[p[3]].append(np.frombuffer(body, endian + p[2], n, offset))
                    offset += np.dtype(p[2]).itemsize * n
        out[name] = {p[-1]: (np.asarray(cols[p[2]], p[1]) if p[0] == "scalar"
                             else _list_column(cols[p[3]], p[2])) for p in props}
    return out


def read_ply(path: str) -> Dict[str, Dict[str, np.ndarray]]:
    """Read a PLY into {element_name: {property_name: array}}.

    A list property (a face's ``vertex_indices``) comes back as a
    [count, length] array of its declared type when every row has one
    length, else as an object array of rows.
    """
    with open(path, "rb") as f:
        data = f.read()

    marker = b"end_header\n"
    header_end = data.find(marker)
    if header_end < 0 or not data.startswith(b"ply"):
        raise ValueError(f"not a PLY file: {path}")
    header = data[:header_end].decode("ascii", "replace").splitlines()
    body = data[header_end + len(marker):]

    fmt = None
    elements = []  # (name, count, [("scalar", type, name) | ("list", count type, type, name)])
    for line in header[1:]:
        parts = line.strip().split()
        if not parts or parts[0] == "comment":
            continue
        if parts[0] == "format":
            fmt = parts[1]
        elif parts[0] == "element":
            elements.append((parts[1], int(parts[2]), []))
        elif parts[0] == "property":
            if parts[1] == "list":
                elements[-1][2].append(("list", _PLY_TO_NP[parts[2]], _PLY_TO_NP[parts[3]],
                                        parts[4]))
            else:
                elements[-1][2].append(("scalar", _PLY_TO_NP[parts[1]], parts[2]))

    if fmt == "ascii":
        return _read_ascii(body, elements)
    if fmt not in ("binary_little_endian", "binary_big_endian"):
        raise ValueError(f"{path}: unsupported PLY format {fmt}")
    return _read_binary(body, elements, "<" if fmt == "binary_little_endian" else ">")


def write_ply(path: str, vertex_props: Dict[str, np.ndarray],
              faces: Optional[np.ndarray] = None) -> None:
    """Write a binary little-endian PLY with one ``vertex`` element and, with
    ``faces`` [F, 3], a triangle ``face`` element (``vertex_indices``, a
    uchar count and int indices, as the JAX writer lays it out).

    ``vertex_props`` is an ordered {name: 1D array}; all arrays share length.
    """
    names = list(vertex_props.keys())
    n = len(next(iter(vertex_props.values())))
    arrs = {k: np.asarray(v).reshape(n) for k, v in vertex_props.items()}

    header = io.StringIO()
    header.write("ply\nformat binary_little_endian 1.0\n")
    header.write(f"element vertex {n}\n")
    for k in names:
        header.write(f"property {_NP_TO_PLY[arrs[k].dtype.name]} {k}\n")
    if faces is not None:
        header.write(f"element face {len(faces)}\n")
        header.write("property list uchar int vertex_indices\n")
    header.write("end_header\n")

    rec = np.empty(n, dtype=[(k, "<" + arrs[k].dtype.str[1:]) for k in names])
    for k in names:
        rec[k] = arrs[k]
    with open(path, "wb") as f:
        f.write(header.getvalue().encode("ascii"))
        f.write(rec.tobytes())
        if faces is not None:
            fc = np.asarray(faces, np.int32).reshape(-1, 3)
            frec = np.empty(len(fc), dtype=[("n", "u1"), ("v", "<i4", (3,))])
            frec["n"] = 3
            frec["v"] = fc
            f.write(frec.tobytes())


def fetch_ply(path: str):
    """A point cloud PLY -> (xyz [N, 3], rgb in [0, 1] or None, normals or None)."""
    v = read_ply(path)["vertex"]
    xyz = np.stack([v["x"], v["y"], v["z"]], axis=1).astype(np.float32)
    rgb = None
    if "red" in v:
        rgb = np.stack([v["red"], v["green"], v["blue"]], axis=1).astype(np.float32)
        if rgb.max() > 1.0:
            rgb = rgb / 255.0
    normals = None
    if "nx" in v:
        normals = np.stack([v["nx"], v["ny"], v["nz"]], axis=1).astype(np.float32)
    return xyz, rgb, normals
