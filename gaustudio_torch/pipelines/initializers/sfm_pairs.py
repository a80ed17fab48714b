"""Pose-based image-pair selection for SfM matching (port of
gaustudio_tpu/pipelines/initializers/sfm_pairs.py, numpy on the host).

Given known camera-to-world poses, propose match pairs as (a) a sequential
window over the id ordering plus (b) loop-closure candidates found by pose
proximity, dropping pairs whose views are so close in both rotation and
translation that matching them adds nothing. The poses are float32, as in
the JAX package, and candidates are ordered by ``np.lexsort((dR, dt))``, so
the pair list is the JAX package's, ties included.
"""

from __future__ import annotations

import os
from typing import Dict, List, Sequence, Tuple

import numpy as np

from gaustudio_torch.datasets import utils as dsu


def _pairwise_pose_distances(R_c2w: np.ndarray, t_c2w: np.ndarray):
    """(dR_deg, dt) [N, N]: relative rotation angle in degrees and
    camera-centre distance."""
    sq = np.einsum("ij,ij->i", t_c2w, t_c2w)
    dt = t_c2w @ t_c2w.T
    dt *= -2.0
    dt += sq[:, None]
    dt += sq[None]
    np.clip(dt, 0.0, None, out=dt)
    np.sqrt(dt, out=dt)

    # the angle of R_i^T R_j from its trace
    trace = np.einsum("nji,mji->nm", R_c2w, R_c2w)
    cos = np.clip((trace - 1.0) / 2.0, -1.0, 1.0)
    dR = np.degrees(np.abs(np.arccos(cos)))
    return dR, dt


def pairs_from_poses(
    images: Dict[int, "dsu.ColmapImage"],
    overlap: int = 5,
    loop_rt_max: Tuple[float, float] = (30.0, 2.0),
    near_rt_min: Tuple[float, float] = (1.0, 0.05),
    max_loops_per_image: int = 5,
) -> List[Tuple[str, str]]:
    """(name_i, name_j) match pairs of a COLMAP images dict:

    - sequential: each image with the next ``overlap`` images in id order;
    - loop closure: beyond the window, up to ``max_loops_per_image``
      candidates within ``loop_rt_max`` (degrees, translation) of the query,
      nearest translations first;
    - pairs closer than ``near_rt_min`` in BOTH rotation and translation are
      dropped (near-duplicate views).

    The translation thresholds are absolute scene units.
    """
    ordered = sorted(images.items(), key=lambda kv: kv[0])
    names = [im.name for _, im in ordered]
    n = len(names)
    if n < 2:
        return []

    R_w2c = np.stack([dsu.qvec2rotmat(im.qvec) for _, im in ordered], 0)
    t_w2c = np.stack([np.asarray(im.tvec, np.float32) for _, im in ordered], 0)
    R_c2w = R_w2c.transpose(0, 2, 1).astype(np.float32)
    t_c2w = -np.einsum("nij,nj->ni", R_c2w, t_w2c).astype(np.float32)

    dR, dt = _pairwise_pose_distances(R_c2w, t_c2w)
    r_loop, t_loop = loop_rt_max
    r_near, t_near = near_rt_min

    pairs: List[Tuple[str, str]] = []
    seen = set()

    def add(i: int, j: int) -> None:
        if (i, j) not in seen:
            seen.add((i, j))
            pairs.append((names[i], names[j]))

    for i in range(n - 1):
        for j in range(i + 1, min(i + overlap + 1, n)):
            if dR[i, j] < r_near and dt[i, j] < t_near:
                continue
            add(i, j)

    for i in range(n):
        cand = np.arange(i + overlap + 1, n)
        if cand.size == 0:
            continue
        ok = (dR[i, cand] < r_loop) & (dt[i, cand] < t_loop)
        ok &= ~((dR[i, cand] < r_near) & (dt[i, cand] < t_near))
        cand = cand[ok]
        if cand.size == 0:
            continue
        order = np.lexsort((dR[i, cand], dt[i, cand]))
        for j in cand[order][:max_loops_per_image]:
            add(i, int(j))

    return pairs


def write_pairs(pairs: Sequence[Tuple[str, str]], path) -> None:
    """Write pairs in the ``pairs-sfm.txt`` format hloc's tools read."""
    with open(path, "w") as f:
        f.write("\n".join(f"{a} {b}" for a, b in pairs))


def pairs_from_model(model_dir, output, overlap: int = 5) -> List[Tuple[str, str]]:
    """Read ``<model_dir>/images.bin``, select pairs, write them to ``output``."""
    images = dsu.read_extrinsics_binary(os.path.join(str(model_dir), "images.bin"))
    pairs = pairs_from_poses(images, overlap=overlap)
    write_pairs(pairs, output)
    return pairs
