"""Frames as gs-render and viewers make them: a closed loop through the
registered renderer over the held-out views in order, each frame read back
to the host as uint8 (``scripts.render.frame_pixels``, what gs-render hands
its writer).

Each frame is timed from its start to the host holding its pixels. The
window runs until ``--seconds`` have passed and finishes the frame under
way; ``render_fps`` is the frames over the window, ``render_p95_ms`` the
95th percentile of every frame's time. The last frame of a sample of views
drawn from the seed is kept for the comparison.
"""

from __future__ import annotations

import time

import numpy as np
import torch

from gsbench import generate
from gsbench.util import sync


class Run:
    kind = "render"

    def __init__(self, cfg: dict, traffic: dict, seed: int, device):
        self.cfg, self.traffic, self.seed, self.device = cfg, traffic, seed, device

    def setup(self) -> dict:
        from gaustudio_torch import renderers
        from gaustudio_torch.datasets.utils import JSON_to_camera
        from gaustudio_torch.models.vanilla import VanillaPointCloud

        cfg, dev = self.cfg, self.device
        _, self.test_cams = generate.split(cfg, generate.cameras(cfg))
        self.cameras = [JSON_to_camera(c, device=dev) for c in self.test_cams]
        params = generate.scene(cfg, self.seed, dev)
        self.pcd = VanillaPointCloud.from_jax_params({**params, "active_sh_degree": 3}, device=dev)
        del params
        self.renderer = renderers.make({"name": "vanilla_renderer"}, device=dev)
        rng = np.random.default_rng(self.seed)
        self.sample = sorted(rng.choice(len(self.cameras), int(self.traffic["check_views"]),
                                        replace=False).tolist())
        self.kept = {}
        for _ in range(int(self.traffic["warmup_cycles"])):
            for i in range(len(self.cameras)):
                self._frame(i)
        out = self.renderer.render(self.cameras[0], self.pcd)
        W, H = int(cfg["width"]), int(cfg["height"])
        return {"gaussians": self.pcd.num_points, "views": len(self.cameras),
                "entries_per_pixel": round(out["num_rendered"] / (W * H), 3),
                "lit": round(float((out["render"].sum(0) > 0).float().mean()), 4)}

    def _frame(self, i: int) -> np.ndarray:
        from gaustudio_torch.scripts.render import frame_pixels

        frame = frame_pixels(self.renderer.render(self.cameras[i], self.pcd)).cpu().numpy()
        if i in self.sample:
            self.kept[i] = frame
        return frame

    def window(self, seconds: float) -> dict:
        times = []
        sync(self.device)
        t0 = time.perf_counter()
        i = 0
        while time.perf_counter() - t0 < seconds:
            f0 = time.perf_counter()
            self._frame(i % len(self.cameras))
            times.append(time.perf_counter() - f0)
            i += 1
        wall = time.perf_counter() - t0
        self.attempted = len(times)
        return {"render_fps": len(times) / wall,
                "render_p95_ms": float(np.percentile(np.array(times) * 1e3, 95))}

    def traced(self) -> dict:
        from gsbench import trace

        k = int(self.traffic["traced_frames"])
        with trace.Window() as win:
            for i in range(k):
                self._frame(i % len(self.cameras))
        self.attempted = k
        cfg, seed, dev = self.cfg, self.seed, self.device
        return {"model": cfg["model"], "kind": self.kind, "profile": win.reduce(), "steps": k,
                "params": lambda: generate.scene(cfg, seed, dev),
                "views": [(self.test_cams[i % len(self.cameras)], 1) for i in range(k)]}

    def release(self):
        del self.pcd, self.renderer

    def reference(self, compute=torch.float32) -> dict:
        """The reference's uint8 frames of the sampled views."""
        from gsbench.reference import raster

        params = generate.scene(self.cfg, self.seed, self.device)
        frames = {}
        for i in self.sample:
            v = raster.view(self.test_cams[i], self.device, dtype=compute)
            sp = raster.project_3dgs({k: p.to(compute) for k, p in params.items()}, v)
            e = raster.bin_entries(sp, v.W, v.H)
            out = raster.render("3dgs", sp, e, v.W, v.H)
            # gs-render's frame: black where the final opacity is under 0.5
            rgb = torch.where((1.0 - out["T"].float())[..., None] >= 0.5, out["colour"].float(),
                              0.0)
            frames[i] = torch.clamp(rgb * 255.0, 0, 255).to(torch.uint8).cpu().numpy()
            del sp, e
        return {"frames": frames}

    def adopt(self, readings: dict) -> None:
        """Put a reference's frames in the program's place."""
        self.kept = readings["frames"]

    def compare(self, ref: dict) -> dict:
        """{"differ": share of the sampled frames' channel values that differ
        from the reference's at all (a level's truncation flips on rounding),
        "off2": share that differ by 2 levels or more}."""
        diffs = [np.abs(self.kept[i].astype(np.int16) - ref["frames"][i].astype(np.int16))
                 for i in self.sample]
        return {"differ": float(np.mean([(d > 0).mean() for d in diffs])),
                "off2": float(np.mean([(d >= 2).mean() for d in diffs]))}
