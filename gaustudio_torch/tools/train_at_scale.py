"""At-scale training on the port (counterpart of the JAX package's
``tools/train_at_scale.py``).

Builds a textured-mesh multi-view capture (the mini_scene family scaled
up: finer tessellation, more views, 512 px), renders its ground truth with
the port's mesh rasterizer, trains 3DGS from a sparse surface init with
full densification (clone / split / prune, opacity resets, the SH warm-up
to degree 3) and evaluates PSNR on held-out views the trainer never saw.

    python -m gaustudio_torch.tools.train_at_scale [--size 512] [--views 64]
        [--iters 7000] [--rich | --bench] [--out DIR] [--device cpu]

Writes ``metrics.jsonl`` (every 50 iterations; a densify call adds its
clone, split and prune counts and ``num_points_after``) and
``summary.json`` into ``--out`` (default
``gaustudio_torch/build/train_at_scale``), then asserts the JAX runs' bars:
at least max(15,000, 6 x the init) points and held-out PSNR >= 26 dB for
the plain capture; at least 100,000 points and >= 24 dB for ``--rich`` and
``--bench``.
"""

from __future__ import annotations

import argparse
import json
import os
import time

import numpy as np
import torch

from gaustudio_torch.pipelines import train as T
from gaustudio_torch.tools import build_path
from gaustudio_torch.tools.make_fixture import (
    CaptureList,
    box,
    color_fn,
    icosphere,
    mesh_shading,
    set_images,
)
from gaustudio_torch.utils.misc import resolve_device


def grid_plane(center, half, y, cells=24):
    """Tessellated horizontal plane: real per-vertex texture detail (a
    4-corner quad interpolates color_fn's checker away entirely)."""
    xs = np.linspace(center[0] - half, center[0] + half, cells + 1)
    zs = np.linspace(center[2] - half, center[2] + half, cells + 1)
    gx, gz = np.meshgrid(xs, zs, indexing="ij")
    verts = np.stack([gx, np.full_like(gx, y), gz], -1).reshape(-1, 3)
    faces = []
    for i in range(cells):
        for j in range(cells):
            a = i * (cells + 1) + j
            b = a + 1
            c = a + (cells + 1)
            d = c + 1
            faces += [[a, c, b], [b, c, d]]
    return verts.astype(np.float32), np.asarray(faces, np.int32)


def _join(parts):
    verts, faces, off = [], [], 0
    for v, f in parts:
        verts.append(v)
        faces.append(f + off)
        off += len(v)
    return (np.concatenate(verts).astype(np.float32),
            np.concatenate(faces).astype(np.int32))


def scene_mesh_large():
    """Richer variant of make_fixture.scene_mesh: finer sphere, two boxes,
    and a tessellated ground plane so views contain occlusion + large flat
    regions that carry real vertex-color texture detail."""
    sv, sf = icosphere(4, radius=0.8)
    r = 1.0 + 0.12 * np.sin(3.1 * sv[:, 0]) * np.cos(2.7 * sv[:, 1])
    sv = sv * r[:, None]
    parts = [(sv, sf)]
    parts.append(box([0.85, -0.35, 0.15], [0.3, 0.3, 0.3]))
    parts.append(box([-0.75, 0.45, -0.3], [0.22, 0.22, 0.22]))
    parts.append(grid_plane([0.0, 0.0, 0.0], 0.8, -1.11, cells=24))
    return _join(parts)


def color_fn_rich(p):
    """Multi-octave high-frequency procedural texture: every surface patch
    carries detail near the 800px pixel scale, so densification keeps
    firing instead of saturating at ~15k points."""
    p = np.asarray(p, np.float32)
    c = 0.5 + 0.28 * np.stack([
        np.sin(4.0 * p[:, 0]) * np.cos(3.0 * p[:, 1]),
        np.sin(5.0 * p[:, 1] + 1.3),
        np.cos(4.0 * p[:, 2] + 0.7),
    ], axis=1)
    for freq, amp, phase in ((11.0, 0.16, 0.0), (23.0, 0.10, 1.1),
                             (47.0, 0.07, 2.3), (101.0, 0.05, 0.6)):
        c = c + amp * np.stack([
            np.sin(freq * p[:, 0] + 2.1 * np.sin(freq * 0.37 * p[:, 2]) + phase),
            np.sin(freq * p[:, 1] + 2.1 * np.sin(freq * 0.41 * p[:, 0]) + phase),
            np.sin(freq * p[:, 2] + 2.1 * np.sin(freq * 0.43 * p[:, 1]) + phase),
        ], axis=1)
    checker = ((np.floor(p[:, 0] * 9) + np.floor(p[:, 1] * 9)
                + np.floor(p[:, 2] * 9)) % 2).astype(np.float32)
    return np.clip(c * (0.75 + 0.25 * checker[:, None]), 0.03, 0.97)


def scene_mesh_rich():
    """Benchmark-scale variant: displaced fine sphere + torus-like ring of
    boxes + finely tessellated ground, all carrying color_fn_rich texture."""
    sv, sf = icosphere(5, radius=0.8)
    r = (1.0 + 0.12 * np.sin(3.1 * sv[:, 0]) * np.cos(2.7 * sv[:, 1])
         + 0.035 * np.sin(11.0 * sv[:, 1]) * np.cos(9.0 * sv[:, 2]))
    sv = sv * r[:, None]
    parts = [(sv, sf)]
    sv2, sf2 = icosphere(4, radius=0.34)
    parts.append((sv2 + np.array([0.95, 0.55, -0.45], np.float32), sf2))
    for k in range(6):  # ring of boxes on the ground plane (y is up)
        ang = 2 * np.pi * k / 6
        parts.append(box([1.05 * np.cos(ang), -0.75, 1.05 * np.sin(ang)],
                         [0.18, 0.22, 0.18]))
    parts.append(grid_plane([0.0, 0.0, 0.0], 1.0, -1.11, cells=96))
    return _join(parts)


def scene_mesh_bench():
    """Wide benchmark-scale scene: a 3x3 field of displaced spheres of
    varied radii + a box ring + a finely tessellated 6x6 ground slab, all
    with per-pixel multi-octave texture. Viewed from far, its splats stay
    under the 20 px screen-size prune bound, so a population of >= 100k
    points is a stable equilibrium rather than a transient peak."""
    rng_r = [0.55, 0.72, 0.48, 0.66, 0.8, 0.52, 0.6, 0.74, 0.58]
    parts = []
    k = 0
    for gx in (-1.9, 0.0, 1.9):
        for gz in (-1.9, 0.0, 1.9):
            r0 = rng_r[k]
            k += 1
            sv, sf = icosphere(4, radius=r0)
            r = (1.0 + 0.12 * np.sin(3.1 * sv[:, 0] + k)
                 * np.cos(2.7 * sv[:, 1])
                 + 0.04 * np.sin(11.0 * sv[:, 1]) * np.cos(9.0 * sv[:, 2]))
            sv = sv * r[:, None]
            parts.append((sv + np.array([gx, r0 - 1.05, gz], np.float32), sf))
    for j in range(10):  # box ring between the spheres
        ang = 2 * np.pi * j / 10 + 0.3
        parts.append(box([2.7 * np.cos(ang), -0.85, 2.7 * np.sin(ang)],
                         [0.2, 0.26, 0.2]))
    parts.append(grid_plane([0.0, 0.0, 0.0], 3.0, -1.11, cells=160))
    return _join(parts)


def color_fn_bench(p):
    """color_fn_rich with the 101-frequency octave softened to 67 (~11 px
    at the bench orbit distance): still demands texture-scale splats
    (>= 100k) while being representable."""
    p = np.asarray(p, np.float32)
    c = 0.5 + 0.28 * np.stack([
        np.sin(4.0 * p[:, 0]) * np.cos(3.0 * p[:, 1]),
        np.sin(5.0 * p[:, 1] + 1.3),
        np.cos(4.0 * p[:, 2] + 0.7),
    ], axis=1)
    for freq, amp, phase in ((11.0, 0.16, 0.0), (23.0, 0.10, 1.1),
                             (47.0, 0.07, 2.3), (67.0, 0.04, 0.6)):
        c = c + amp * np.stack([
            np.sin(freq * p[:, 0] + 2.1 * np.sin(freq * 0.37 * p[:, 2]) + phase),
            np.sin(freq * p[:, 1] + 2.1 * np.sin(freq * 0.41 * p[:, 0]) + phase),
            np.sin(freq * p[:, 2] + 2.1 * np.sin(freq * 0.43 * p[:, 1]) + phase),
        ], axis=1)
    checker = ((np.floor(p[:, 0] * 9) + np.floor(p[:, 1] * 9)
                + np.floor(p[:, 2] * 9)) % 2).astype(np.float32)
    return np.clip(c * (0.75 + 0.25 * checker[:, None]), 0.03, 0.97)


def _sin(a: torch.Tensor) -> torch.Tensor:
    """sin of float32 arguments rounded from float64: the arguments reach
    ~300 rad, where a float32 sin kernel may lose digits in its range
    reduction (torch's CPU kernel does, now and then)."""
    return torch.sin(a.double()).to(a.dtype)


def _cos(a: torch.Tensor) -> torch.Tensor:
    return torch.cos(a.double()).to(a.dtype)


def _octave_texture(p: torch.Tensor, top: tuple) -> torch.Tensor:
    """The multi-octave field of color_fn_rich / color_fn_bench in torch
    (float32 arithmetic, on p's device); ``top`` is the finest octave's
    (freq, amp)."""
    x, y, z = p[:, 0], p[:, 1], p[:, 2]
    c = 0.5 + 0.28 * torch.stack([
        _sin(4.0 * x) * _cos(3.0 * y),
        _sin(5.0 * y + 1.3),
        _cos(4.0 * z + 0.7),
    ], dim=1)
    for freq, amp, phase in ((11.0, 0.16, 0.0), (23.0, 0.10, 1.1), (47.0, 0.07, 2.3),
                             top + (0.6,)):
        c = c + amp * torch.stack([
            _sin(freq * x + 2.1 * _sin(freq * 0.37 * z) + phase),
            _sin(freq * y + 2.1 * _sin(freq * 0.41 * x) + phase),
            _sin(freq * z + 2.1 * _sin(freq * 0.43 * y) + phase),
        ], dim=1)
    checker = (torch.floor(x * 9) + torch.floor(y * 9) + torch.floor(z * 9)) % 2
    return torch.clamp(c * (0.75 + 0.25 * checker[:, None]), 0.03, 0.97)


# the torch twin of each per-pixel colour field, evaluated on the device
TORCH_FIELDS = {
    color_fn_rich: lambda p: _octave_texture(p, (101.0, 0.05)),
    color_fn_bench: lambda p: _octave_texture(p, (67.0, 0.04)),
}


def orbit_rings(size, views, radius=3.2, fov_deg=55, elevations=(18, 42), device=None):
    """Two constant-elevation orbit rings, both above the ground plane."""
    from gaustudio_torch.cameras import camera_paths

    per = views // 2
    cams = camera_paths.get_path_from_orbit(
        np.zeros(3), radius, elevation=elevations[0], num_cam=per,
        image_size=size, fov_deg=fov_deg, device=device,
    )
    cams += camera_paths.get_path_from_orbit(
        np.zeros(3), radius, elevation=elevations[1], num_cam=views - per,
        image_size=size, fov_deg=fov_deg, device=device,
    )
    return cams


# camera geometry per scene kind: the bench scene is ~4x the footprint,
# viewed from ~2.2x the distance with a slightly tighter fov; its low ring
# sits higher (26 vs 18), away from grazing views of the slab
ORBITS = {
    "large": dict(radius=3.2, fov_deg=55),
    "rich": dict(radius=3.2, fov_deg=55),
    "bench": dict(radius=7.0, fov_deg=52, elevations=(26, 44)),
}
MESHES = {"large": scene_mesh_large, "rich": scene_mesh_rich, "bench": scene_mesh_bench}
COLORS = {"large": color_fn, "rich": color_fn_rich, "bench": color_fn_bench}
SCENES = {
    "large": "procedural textured mesh (icosphere+boxes+slab)",
    "rich": "rich procedural mesh (displaced spheres + box ring + fine slab, "
            "multi-octave texture)",
    "bench": "wide benchmark field (3x3 displaced spheres + box ring + 6x6 fine slab, "
             "multi-octave texture)",
}


def jax_capture_capacity(width: int) -> int:
    """The (triangle, 16x16 tile) entries the JAX render_gt keeps a view."""
    return max(1 << 19, 1 << 21 if width > 600 else 0)


def jax_tiles_touched(verts: torch.Tensor, faces: torch.Tensor, cam) -> torch.Tensor:
    """The 16x16 tiles of each face's screen rectangle in the JAX capture's
    rasterizer, [F] (0 for a face with a vertex behind the camera)."""
    from gaustudio_torch.ops.gaussian import ndc2pix, transform_points

    W, H = int(cam.image_width), int(cam.image_height)
    hom = transform_points(verts, cam.full_proj_transform.to(verts.device))
    ndc = hom[:, :3] / (hom[:, 3:4] + 1e-9)
    px, py = ndc2pix(ndc[:, 0], W)[faces], ndc2pix(ndc[:, 1], H)[faces]
    z = transform_points(verts, cam.world_view_transform.to(verts.device))[:, 2][faces]
    span = lambda lo, hi, n: (torch.clamp(torch.floor(hi / 16) + 1, 0, n)  # noqa: E731
                              - torch.clamp(torch.floor(lo / 16), 0, n))
    touched = span(px.min(1).values, px.max(1).values, (W + 15) // 16) * span(
        py.min(1).values, py.max(1).values, (H + 15) // 16)
    return torch.where((z > 1e-3).all(dim=1), touched, 0).long()


def jax_capture_faults(verts: torch.Tensor, faces: torch.Tensor, cam) -> tuple:
    """What the JAX render_gt's rasterizer gets wrong in one view, which the
    port's does not: (the (triangle, tile) entries past its capacity, which
    it drops; the faces whose entries it gives to another face). The JAX
    expansion maps an entry to the rank of its face among the faces that
    touch a tile, so every face after one that touches none (off-screen or
    behind the camera) is drawn with another face's entries."""
    touched = jax_tiles_touched(verts, faces, cam)
    dropped = max(0, int(touched.sum()) - jax_capture_capacity(int(cam.image_width)))
    none = torch.nonzero(touched == 0)
    misassigned = int((touched[int(none[0]):] > 0).sum()) if len(none) else 0
    return dropped, misassigned


def render_gt(verts, faces, cams, col_fn=color_fn, per_pixel=False, device=None):
    """Ground-truth images ([H, W, 3] float32 tensors on ``device``) of a
    mesh through the port's mesh rasterizer, Lambert shaded. Per-vertex
    colours ``col_fn(verts)`` are interpolated; with ``per_pixel`` the
    surface position is interpolated and ``col_fn``'s torch twin
    (``TORCH_FIELDS``) is evaluated at every pixel on the device: vertex
    interpolation would low-pass any texture finer than the tessellation."""
    from gaustudio_torch.ops import mesh_raster as MR

    device = resolve_device(device)
    v = torch.from_numpy(np.asarray(verts, np.float32)).to(device)
    f = torch.from_numpy(np.asarray(faces, np.int64)).to(device)
    lam = mesh_shading(v, f)
    vcol = None if per_pixel else torch.from_numpy(col_fn(verts)).to(device)
    images = []
    for cam in cams:
        frag = MR.rasterize_mesh(v, f, cam.world_view_transform, cam.full_proj_transform,
                                 int(cam.image_width), int(cam.image_height))
        shade = torch.where(frag.mask, lam[torch.clamp_min(frag.tri_id, 0)], 0.0)
        if per_pixel:
            pos = MR.interpolate_attribute(frag, f, v)
            col = TORCH_FIELDS[col_fn](pos.reshape(-1, 3)).reshape(pos.shape)
        else:
            col = MR.interpolate_attribute(frag, f, vcol)
        images.append(torch.clamp(col * shade[..., None], 0, 1))
    return images


def scene_kind(args) -> str:
    return "bench" if args.bench else ("rich" if args.rich else "large")


def holdout_split(cams, every: int):
    """(train cameras, held-out cameras): every ``every``-th is held out."""
    hold = set(range(0, len(cams), every))
    return ([c for i, c in enumerate(cams) if i not in hold],
            [c for i, c in enumerate(cams) if i in hold])


def init_cloud(verts, faces, n: int, col_fn, device=None):
    """The sparse init: surface samples + 0.01 noise, opacity 0.1, SH 0."""
    from gaustudio_torch import models
    from gaustudio_torch.models.utils import inverse_sigmoid
    from gaustudio_torch.utils.mesh import sample_mesh_surface

    xyz = sample_mesh_surface(verts, faces, n, seed=3)
    xyz = xyz + np.random.default_rng(5).normal(size=xyz.shape).astype(np.float32) * 0.01
    pcd = models.make({"name": "vanilla_pcd"}, device=device)
    pcd.create_from_attribute(
        xyz=xyz, rgb=col_fn(xyz),
        opacity=inverse_sigmoid(np.full((n, 1), 0.1, np.float32)))
    pcd.active_sh_degree = 0
    return pcd


def scene_extent(kind: str) -> float:
    """getNerfppNorm-style extent, 1.1 x the orbit radius (it scales the xyz
    lr, the percent_dense split bound and the 0.1 x extent world prune)."""
    return 1.1 * ORBITS[kind]["radius"]


def train_config(args, kind: str):
    """The JAX tool's TrainConfig: densify 500 .. 0.8 x iters every 100
    (threshold 2e-4, 7e-5 for the textured captures), opacity resets every
    3000, the SH degree up every 1000 to 3, the xyz lr scaled by the extent."""

    extent = scene_extent(kind)
    grad_thr = args.densify_grad_threshold
    if grad_thr is None:
        grad_thr = 7e-5 if kind in ("rich", "bench") else 2e-4
    return T.TrainConfig(
        iterations=args.iters,
        densify_from_iter=500,
        densify_until_iter=int(args.iters * 0.8),
        densification_interval=100,
        densify_grad_threshold=grad_thr,
        opacity_reset_interval=3000,
        sh_increase_interval=1000,
        max_sh_degree=args.max_sh_degree if args.max_sh_degree is not None else 3,
        lr_xyz_init=0.00016 * extent,
        lr_xyz_final=0.0000016 * extent,
        lr_xyz_max_steps=args.iters,
    )


@torch.no_grad()
def eval_holdout(trainer, cams):
    """(mean held-out PSNR, per-view PSNRs rounded to 0.01) of the trainer's
    current state over ``cams``, on a black background."""
    from gaustudio_torch.ops import ssim as ssim_ops

    settings = trainer.settings()
    vals = []
    for cam in cams:
        batch = trainer.batch(cam)
        s = settings._replace(viewmatrix=batch.viewmatrix, projmatrix=batch.projmatrix,
                              campos=batch.campos, bg=torch.zeros(3, device=trainer.device))
        out = T.render_from_params(trainer.state.params, trainer.state.active_sh_degree, s)
        vals.append(float(ssim_ops.psnr(out["render"], batch.gt_image)))
    return float(np.mean(vals)), [round(v, 2) for v in vals]


def capture(args, kind: str, device):
    """(mesh vertices, faces, cameras with their images). A textured capture
    comes from make_atscale_capture's cache where one exists."""
    from gaustudio_torch.tools.make_atscale_capture import load_capture

    verts, faces = MESHES[kind]()
    textured = kind in ("rich", "bench")
    cams = load_capture(args.size, args.views, kind=kind, device=device) if textured else None
    if cams is None:
        cams = orbit_rings(args.size, args.views, device=device, **ORBITS[kind])
        set_images(cams, render_gt(verts, faces, cams, col_fn=COLORS[kind],
                                   per_pixel=textured, device=device))
    return verts, faces, cams


def jax_faults(verts, faces, cams) -> dict:
    """jax_capture_faults summed over the capture's views."""
    v = torch.from_numpy(np.asarray(verts, np.float32)).to(cams[0].device)
    f = torch.from_numpy(np.asarray(faces, np.int64)).to(v.device)
    per_view = [jax_capture_faults(v, f, cam) for cam in cams]
    return {"jax_dropped_entries": sum(d for d, _ in per_view),
            "jax_misassigned_faces": sum(m for _, m in per_view),
            "jax_views_with_misassigned_faces": sum(m > 0 for _, m in per_view)}


def make_trainer(args, kind: str, verts, faces, train_cams, device):
    """The Trainer of the sparse init on the training cameras."""
    pcd = init_cloud(verts, faces, args.init_points, COLORS[kind], device)
    return T.Trainer(pcd, CaptureList(train_cams, scene_extent(kind)),
                     train_config(args, kind), device=device)


def train_and_evaluate(args):
    """Capture, train and evaluate; writes metrics.jsonl and summary.json
    into ``args.out``. Returns (the summary, the trainer)."""
    device = resolve_device(args.device)
    os.makedirs(args.out, exist_ok=True)
    print(f"device: {device}"
          + (f" ({torch.cuda.get_device_name(device)})" if device.type == "cuda" else ""),
          flush=True)
    kind = scene_kind(args)
    t0 = time.perf_counter()
    verts, faces, cams = capture(args, kind, device)
    capture_s = time.perf_counter() - t0
    faults = jax_faults(verts, faces, cams)
    print(f"capture: {len(cams)} views {args.size}px, mesh "
          f"{len(verts)}v/{len(faces)}f ({capture_s:.1f}s); the JAX capture's rasterizer "
          f"would drop {faults['jax_dropped_entries']} entries past its capacity and draw "
          f"{faults['jax_misassigned_faces']} faces with another face's entries "
          f"({faults['jax_views_with_misassigned_faces']} views)", flush=True)

    train_cams, test_cams = holdout_split(cams, args.holdout_every)
    print(f"split: {len(train_cams)} train / {len(test_cams)} held-out", flush=True)
    trainer = make_trainer(args, kind, verts, faces, train_cams, device)

    psnr0, _ = eval_holdout(trainer, test_cams)
    print(f"held-out PSNR before: {psnr0:.2f}", flush=True)

    # the first step loads the kernels: outside the timed run
    t0 = time.perf_counter()
    trainer.train(iterations=trainer.state.step + 1, log_every=1)
    print(f"warmup: {time.perf_counter() - t0:.1f}s", flush=True)

    def cb(m):
        if args.iters <= 2000 or m["iter"] % 500 == 0:
            print(f"  iter {m['iter']:5d} loss {m['loss']:.4f} psnr {m['psnr']:.2f} "
                  f"pts {int(m['num_points'])}", flush=True)

    t0 = time.perf_counter()
    trainer.train(iterations=args.iters, log_every=50,
                  metrics_path=os.path.join(args.out, "metrics.jsonl"), callback=cb)
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    train_s = time.perf_counter() - t0
    ms_it = train_s / max(args.iters - 1, 1) * 1e3

    psnr1, per_view = eval_holdout(trainer, test_cams)
    final_pts = trainer.state.num_points
    print(f"held-out PSNR after: {psnr1:.2f}  points {final_pts}  "
          f"({ms_it:.1f} ms/it incl. densify)", flush=True)

    summary = {
        "scene": SCENES[kind],
        "views_train": len(train_cams), "views_heldout": len(test_cams),
        "size": args.size, "iters": args.iters,
        "init_points": args.init_points, "final_points": final_pts,
        "psnr_heldout_before": round(psnr0, 2),
        "psnr_heldout_after": round(psnr1, 2),
        "psnr_heldout_per_view": per_view,
        "train_wall_s": round(train_s, 1),
        "train_ms_per_iter": round(ms_it, 2),
        "capture_s": round(capture_s, 1),
        **faults,
        "nonfinite_rows": int((~T.finite_rows(trainer.state.params)).sum()),
        "platform": device.type,
        "device_name": torch.cuda.get_device_name(device) if device.type == "cuda" else "cpu",
    }
    with open(os.path.join(args.out, "summary.json"), "w") as f:
        json.dump(summary, f, indent=1)
    print(json.dumps(summary), flush=True)
    return summary, trainer


def run(args) -> dict:
    """train_and_evaluate's summary."""
    return train_and_evaluate(args)[0]


def check_bars(summary: dict, args) -> None:
    """The JAX tool's pass bars, less its capacity-growth count (the port has
    no capacity buckets): a real densify ramp and held-out quality in the
    healthy range, with no non-finite parameter left."""
    final_pts, psnr1 = summary["final_points"], summary["psnr_heldout_after"]
    if summary["nonfinite_rows"]:
        raise AssertionError(f"{summary['nonfinite_rows']} rows with a non-finite parameter")
    if scene_kind(args) in ("rich", "bench"):
        if final_pts < 100_000:
            raise AssertionError(f"densification stalled: {final_pts} pts < 100k (rich bar)")
        if psnr1 < 24.0:
            raise AssertionError(f"held-out PSNR {psnr1} < 24")
    else:
        if final_pts < max(15_000, 6 * args.init_points):
            raise AssertionError(f"densification stalled: {final_pts} pts")
        if psnr1 < 26.0:
            raise AssertionError(f"held-out PSNR {psnr1} < 26")


def parse_args(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--size", type=int, default=512)
    ap.add_argument("--views", type=int, default=64)
    ap.add_argument("--holdout_every", type=int, default=8)
    ap.add_argument("--iters", type=int, default=7000)
    ap.add_argument("--init_points", type=int, default=2000)
    ap.add_argument("--rich", action="store_true",
                    help="benchmark-scale capture: rich mesh + multi-octave texture")
    ap.add_argument("--densify_grad_threshold", type=float, default=None,
                    help="the clone/split grad threshold. Default: 2e-4 (the reference's "
                         "vanilla value) for the plain capture; 7e-5 for --rich and --bench, "
                         "whose viewspace-gradient scale is ~3x smaller")
    ap.add_argument("--max_sh_degree", type=int, default=None,
                    help="cap the SH warm-up (default 3)")
    ap.add_argument("--bench", action="store_true",
                    help="wide benchmark scene (scene_mesh_bench) at a far orbit")
    ap.add_argument("--out", default=build_path("train_at_scale"))
    ap.add_argument("--device", default=None, choices=["cuda", "cpu"],
                    help="default: the current CUDA device")
    return ap.parse_args(argv)


def main(argv=None):
    args = parse_args(argv)
    check_bars(run(args), args)
    print("AT-SCALE TRAIN OK", flush=True)


if __name__ == "__main__":
    main()
