"""gs-extract-mesh as users run it: a closed loop of whole
``pipelines.mesh_extraction.extract_mesh`` calls through the surfel renderer
at the CLI's defaults, each writing its per-view files and
``fused_mesh.ply`` into a fresh directory under the run's ``TMPDIR``,
deleted after it.

``extract_mesh_device_ms`` is the device's busy time (the union of its
activity intervals, ``torch.profiler`` over the device alone) over the
extractions completed in the window. The profiler is stopped and read
after every ``profiled_extractions`` of them, between two extractions, so
that no run ends with a million events to read. The host sets the pace of an
extraction and a shared host's speed swings the wall by more than any
bound holds, so the wall (``extract_mesh_wall_s``: a closed loop's wall
over its extractions, no profiler) is read in the traced run, with no
bound. The last extraction's mesh is compared with the reference's.
"""

from __future__ import annotations

import copy
import shutil
import tempfile
import time

import numpy as np
import torch

from gsbench import generate
from gsbench.util import sync


class Run:
    kind = "mesh"

    def __init__(self, cfg: dict, traffic: dict, seed: int, device):
        self.cfg, self.traffic, self.seed, self.device = cfg, traffic, seed, device
        t = traffic
        self.kw = {"voxel_size": t["voxel_size"], "sdf_trunc": t["sdf_trunc"],
                   "min_weight": t["min_weight"], "stride": int(t["stride"]),
                   "downsample": int(t["downsample"]), "max_dim": int(t["max_dim"])}

    def setup(self) -> dict:
        from gaustudio_torch import renderers
        from gaustudio_torch.datasets.utils import JSON_to_camera
        from gaustudio_torch.models.vanilla import VanillaPointCloud

        cfg, dev = self.cfg, self.device
        self.cams = generate.cameras(cfg)
        self.cameras = [JSON_to_camera(c, device=dev) for c in self.cams]
        params = generate.scene(cfg, self.seed, dev)
        self.pcd = VanillaPointCloud.from_jax_params(
            {**params, "active_sh_degree": 3}, device=dev,
            config={"name": "vanilla_pcd", "attributes": {
                "xyz": 3, "opacity": 1, "f_dc": 3, "f_rest": 45, "scale": 2, "rot": 4}})
        del params
        self.renderer = renderers.make({"name": "surfel_renderer"}, device=dev)
        for _ in range(int(self.traffic["warmup"])):
            self._extract()
        return {"surfels": self.pcd.num_points, "views": len(self.cameras),
                "vertices": len(self.mesh[0]), "faces": len(self.mesh[1])}

    def _extract(self):
        from gaustudio_torch.pipelines.mesh_extraction import extract_mesh

        work = tempfile.mkdtemp(prefix="gsbench_mesh_")
        try:
            # extract_mesh downsamples the cameras it is given in place
            self.mesh = extract_mesh(self.pcd, self.renderer,
                                     [copy.copy(c) for c in self.cameras], work_dir=work,
                                     device=self.device, **self.kw)
        finally:
            shutil.rmtree(work, ignore_errors=True)

    def window(self, seconds: float) -> dict:
        from gsbench import trace

        with trace.Window(host=False):
            pass  # the profiler's first start takes seconds: before the window
        k = int(self.traffic["profiled_extractions"])
        n, busy_s = 0, 0.0
        t0 = time.perf_counter()
        while time.perf_counter() - t0 < seconds:
            with trace.Window(host=False) as win:
                for _ in range(k):
                    self._extract()
                    n += 1
                    if time.perf_counter() - t0 >= seconds:
                        break
            busy_s += win.busy_s()
        self.attempted = n
        return {"extract_mesh_device_ms": 1e3 * busy_s / n}

    def traced(self) -> dict:
        from gsbench import trace

        k = int(self.traffic["wall_extractions"])
        sync(self.device)
        t0 = time.perf_counter()
        for _ in range(k):
            self._extract()
        sync(self.device)
        wall_s = (time.perf_counter() - t0) / k
        with trace.Window() as win:
            self._extract()
        self.attempted = k + 1
        cfg, seed, dev, kw = self.cfg, self.seed, self.device, self.kw
        return {"model": cfg["model"], "kind": self.kind, "profile": win.reduce(), "steps": 1,
                "params": lambda: generate.scene(cfg, seed, dev),
                "views": [(c, kw["downsample"]) for c in self.cams[::kw["stride"]]],
                "mesh_stages": self._stages(), "extract_wall_s": wall_s}

    def _stages(self) -> dict:
        """One extraction's stages, host clock fenced by ``synchronize()``,
        by the benchmark's own calls into the pipeline's parts in
        extract_mesh's order."""
        import os

        from gaustudio_torch.ops import mcubes, tsdf
        from gaustudio_torch.pipelines.mesh_extraction import iter_fused_depths
        from gaustudio_torch.utils import mesh as meshu

        kw = self.kw
        work = tempfile.mkdtemp(prefix="gsbench_mesh_")
        try:
            sync(self.device)
            t0 = time.perf_counter()
            cams = [copy.copy(c).downsample_scale(kw["downsample"])
                    for c in self.cameras[::kw["stride"]]]
            lo, hi = tsdf.integrate_points_bounds(self.pcd.get_attribute("xyz"))
            vol = tsdf.volume_from_bounds(lo, hi, kw["voxel_size"], kw["sdf_trunc"],
                                          max_dim=kw["max_dim"], device=self.device)
            for cam, depth in iter_fused_depths(self.renderer, self.pcd, cams, work):
                tsdf.integrate(vol, depth, cam.intrinsics, cam.extrinsics)
            sync(self.device)
            t1 = time.perf_counter()
            verts, faces = mcubes.marching_tetrahedra(
                vol.tsdf, iso=0.0, weight=vol.weight, min_weight=kw["min_weight"],
                origin=vol.origin.cpu().numpy(), voxel_size=float(vol.voxel_size), slab=4)
            meshu.save_mesh(os.path.join(work, "fused_mesh.ply"), verts, faces)
            t2 = time.perf_counter()
        finally:
            shutil.rmtree(work, ignore_errors=True)
        return {"render_integrate": t1 - t0, "march": t2 - t1}

    def release(self):
        del self.pcd, self.renderer

    def reference(self, compute=torch.float32) -> dict:
        """The reference's mesh of the same surfels and views."""
        from gsbench.reference import mesh as M
        from gsbench.reference import raster

        kw = self.kw
        scene = generate.scene(self.cfg, self.seed, self.device)
        xyz = scene["xyz"].cpu().numpy()
        params = {k: v.to(compute) for k, v in scene.items()}
        views, depths = [], []
        for cam in self.cams[::kw["stride"]]:
            v = raster.view(cam, self.device, scale=kw["downsample"], dtype=compute)
            sp = raster.project_2dgs(params, v)
            e = raster.bin_entries(sp, v.W, v.H)
            out = raster.render("2dgs", sp, e, v.W, v.H, median=True)
            depths.append(torch.where(1.0 - out["T"] < 0.5, 0.0, out["median"]))
            views.append(v)
            del sp, e, out
        origin, voxel, trunc, dims = M.grid(xyz, kw["voxel_size"], kw["sdf_trunc"],
                                            kw["max_dim"])
        t, w = M.fuse(depths, views, origin, voxel, trunc, dims, self.device)
        verts, faces = M.march(t, w, kw["min_weight"], origin, voxel)
        return {"verts": verts, "faces": faces, "voxel": float(voxel)}

    def adopt(self, readings: dict) -> None:
        """Put a reference's mesh in the program's place."""
        self.mesh = (readings["verts"], range(readings["faces"]))

    def compare(self, ref: dict) -> dict:
        """{"vertices", "faces": relative gaps of the counts; "far": the
        larger share of either mesh's vertices with none of the other's
        within a tenth of a voxel}."""
        from scipy.spatial import cKDTree

        pv, pf = np.asarray(self.mesh[0], np.float64), len(self.mesh[1])
        rv, rf = ref["verts"], ref["faces"]
        tol = 0.1 * ref["voxel"]
        far_p = float((cKDTree(rv).query(pv)[0] > tol).mean()) if len(pv) and len(rv) else 1.0
        far_r = float((cKDTree(pv).query(rv)[0] > tol).mean()) if len(pv) and len(rv) else 1.0
        return {"vertices": abs(len(pv) - len(rv)) / max(len(rv), 1),
                "faces": abs(pf - rf) / max(rf, 1), "far": max(far_p, far_r)}
