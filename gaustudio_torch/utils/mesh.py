"""Mesh helpers on the host: PLY IO, surface sampling, the mesh F1 score and
the connected-component cleanup (port of gaustudio_tpu/utils/mesh.py).

Components are labelled with ``scipy.sparse.csgraph`` instead of the JAX
package's Python union-find; the faces and vertices that
``clean_mesh_components`` keeps, and their order, are the same.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np

from gaustudio_torch.utils.ply import read_ply, write_ply


def save_mesh(path: str, vertices: np.ndarray, faces: np.ndarray,
              vertex_colors=None) -> None:
    props = {
        "x": vertices[:, 0].astype(np.float32),
        "y": vertices[:, 1].astype(np.float32),
        "z": vertices[:, 2].astype(np.float32),
    }
    if vertex_colors is not None:
        c = np.asarray(vertex_colors)
        if c.dtype != np.uint8:
            c = np.clip(c * 255.0, 0, 255).astype(np.uint8)
        props["red"], props["green"], props["blue"] = c[:, 0], c[:, 1], c[:, 2]
    write_ply(path, props, faces=np.asarray(faces, np.int32))


def load_mesh(path: str) -> Tuple[np.ndarray, np.ndarray]:
    data = read_ply(path)
    v = data["vertex"]
    verts = np.stack([v["x"], v["y"], v["z"]], 1).astype(np.float32)
    faces = np.asarray(data["face"]["vertex_indices"], np.int32)
    return verts, faces


def vertex_normals(vertices: np.ndarray, faces: np.ndarray) -> np.ndarray:
    """Unit vertex normals: the sum of the adjacent faces' cross products."""
    v0, v1, v2 = (vertices[faces[:, i]] for i in range(3))
    fn = np.cross(v1 - v0, v2 - v0)
    vn = np.zeros_like(vertices)
    for i in range(3):
        np.add.at(vn, faces[:, i], fn)
    return vn / np.maximum(np.linalg.norm(vn, axis=1, keepdims=True), 1e-12)


def sample_mesh_surface(vertices, faces, n_samples: int, seed: int = 0) -> np.ndarray:
    """Area-weighted uniform surface samples [n_samples, 3]."""
    v = np.asarray(vertices, np.float64)
    f = np.asarray(faces, np.int64)
    a, b, c = v[f[:, 0]], v[f[:, 1]], v[f[:, 2]]
    areas = 0.5 * np.linalg.norm(np.cross(b - a, c - a), axis=1)
    total = areas.sum()
    if total <= 0:
        raise ValueError("degenerate mesh: zero total surface area")
    rng = np.random.default_rng(seed)
    fid = rng.choice(len(f), size=n_samples, p=areas / total)
    r1 = np.sqrt(rng.uniform(size=(n_samples, 1)))
    r2 = rng.uniform(size=(n_samples, 1))
    pts = a[fid] * (1 - r1) + b[fid] * (r1 * (1 - r2)) + c[fid] * (r1 * r2)
    return pts.astype(np.float32)


def mesh_f1_score(verts_a, faces_a, verts_b, faces_b, tau: float,
                  n_samples: int = 20000, seed: int = 0) -> dict:
    """Symmetric mesh F1 at threshold ``tau``: precision is the share of
    A's samples within tau of B's, recall the share of B's within tau of A's."""
    from scipy.spatial import cKDTree

    sa = sample_mesh_surface(verts_a, faces_a, n_samples, seed)
    sb = sample_mesh_surface(verts_b, faces_b, n_samples, seed + 1)
    d_ab = cKDTree(sb).query(sa, k=1)[0]
    d_ba = cKDTree(sa).query(sb, k=1)[0]
    precision = float((d_ab < tau).mean())
    recall = float((d_ba < tau).mean())
    f1 = 2 * precision * recall / (precision + recall) if precision + recall > 0 else 0.0
    return {"precision": precision, "recall": recall, "f1": f1,
            "chamfer": float(d_ab.mean() + d_ba.mean()) / 2}


def connected_components(faces: np.ndarray, num_vertices: int) -> np.ndarray:
    """Label each face by its vertex-connected component."""
    from scipy.sparse import coo_matrix
    from scipy.sparse.csgraph import connected_components as label

    f = np.asarray(faces, np.int64)
    rows = np.concatenate([f[:, 0], f[:, 0]])
    cols = np.concatenate([f[:, 1], f[:, 2]])
    graph = coo_matrix((np.ones(len(rows), np.int8), (rows, cols)),
                       shape=(num_vertices, num_vertices))
    _, labels = label(graph, directed=False)
    return labels[f[:, 0]]


def clean_mesh_components(vertices, faces, ratio_threshold: float = 0.5):
    """Keep the components with more than ratio x the largest one's triangles,
    and the vertices they use, in their order."""
    faces = np.asarray(faces)
    if len(faces) == 0:
        return np.asarray(vertices), faces
    labels = connected_components(faces, len(vertices))
    counts = np.bincount(labels)
    keep = np.isin(labels, np.where(counts > ratio_threshold * counts.max())[0])
    faces = faces[keep]
    used = np.unique(faces)
    remap = -np.ones(len(vertices), np.int64)
    remap[used] = np.arange(len(used))
    return np.asarray(vertices)[used], remap[faces].astype(np.int32)
