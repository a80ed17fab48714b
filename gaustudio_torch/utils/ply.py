"""Binary PLY reader/writer for Inria-layout Gaussian checkpoints (numpy only).

Port of the binary, scalar-property part of gaustudio_tpu/utils/ply.py:
``point_cloud.ply`` files hold one ``vertex`` element of float properties
(x, y, z, nx, ny, nz, f_dc_*, f_rest_*, opacity, scale_*, rot_*).
"""

from __future__ import annotations

import io
from typing import Dict

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


def read_ply(path: str) -> Dict[str, Dict[str, np.ndarray]]:
    """Read a binary PLY into {element_name: {property_name: array}}.

    Only scalar properties are supported; a list property (mesh faces) or an
    ascii body raises ``ValueError``.
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
    elements = []  # (name, count, [(name, np type)])
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
                raise ValueError(f"{path}: list properties are not supported")
            elements[-1][2].append((parts[2], _PLY_TO_NP[parts[1]]))

    if fmt not in ("binary_little_endian", "binary_big_endian"):
        raise ValueError(f"{path}: unsupported PLY format {fmt}")
    endian = "<" if fmt == "binary_little_endian" else ">"

    out: Dict[str, Dict[str, np.ndarray]] = {}
    offset = 0
    for name, count, props in elements:
        dtype = np.dtype([(p, endian + t) for p, t in props])
        arr = np.frombuffer(body, dtype=dtype, count=count, offset=offset)
        offset += dtype.itemsize * count
        out[name] = {p: np.ascontiguousarray(arr[p]).astype(t) for p, t in props}
    return out


def write_ply(path: str, vertex_props: Dict[str, np.ndarray]) -> None:
    """Write a binary little-endian PLY with one ``vertex`` element.

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
    header.write("end_header\n")

    rec = np.empty(n, dtype=[(k, "<" + arrs[k].dtype.str[1:]) for k in names])
    for k in names:
        rec[k] = arrs[k]
    with open(path, "wb") as f:
        f.write(header.getvalue().encode("ascii"))
        f.write(rec.tobytes())
