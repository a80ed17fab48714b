"""The training loop as users run it: 3DGS's ``Trainer.train``, from a state
past densification, with the trainer's own loader drawing the training
views.

Set-up builds one trainer from the seed and drives it through its first
``check_steps`` iterations in one ``train`` call: those iterations are the
ones the reference follows (their losses, the first gradient as Adam's
first moment holds it, the parameters' change). Further warm-up iterations
go through the same call. The window is one more ``train`` call of as many
iterations as the warm-up's rate fits into ``--seconds``; its metric is the
window's wall over those iterations.
"""

from __future__ import annotations

import statistics
import time

import numpy as np
import torch

from gsbench import generate
from gsbench.util import sync

B1 = 0.9  # Adam's first-moment decay: after one step from zero, mu = (1 - B1) g


class _Views(list):
    cameras_extent = 1.0


def _extent(cams) -> float:
    """1.1 x the largest camera-centre distance from their mean (nerf++)."""
    c = np.array([cam["position"] for cam in cams], np.float64)
    return float(np.linalg.norm(c - c.mean(0), axis=1).max() * 1.1)


def leaf_norms(tensors: dict) -> dict:
    return {k: float(torch.linalg.vector_norm(v.double())) for k, v in tensors.items()}


class Run:
    kind = "train"

    def __init__(self, cfg: dict, traffic: dict, seed: int, device):
        if cfg["model"] != "3dgs":
            raise ValueError(f"the train driver runs 3DGS's Trainer, not {cfg['model']!r}")
        self.cfg, self.traffic, self.seed, self.device = cfg, traffic, seed, device

    # --- set-up ------------------------------------------------------------

    def setup(self) -> dict:
        from gaustudio_torch.datasets.utils import JSON_to_camera
        from gaustudio_torch.models.vanilla import VanillaPointCloud
        from gaustudio_torch.pipelines import train as T

        cfg, dev = self.cfg, self.device
        cams = generate.cameras(cfg)
        self.train_cams, _ = generate.split(cfg, cams)
        gt = generate.images(cfg, self.train_cams, self.seed, dev)
        # the dataset holds its images on the host, as a capture's loader does
        gt_host = gt.cpu()
        del gt
        views = _Views()
        for c, img in zip(self.train_cams, gt_host):
            cam = JSON_to_camera(c, device="cpu")
            cam.image = img
            views.append(cam)
        views.cameras_extent = _extent(self.train_cams)
        params = generate.scene(cfg, self.seed, dev)
        pcd = VanillaPointCloud.from_jax_params(params, device=dev)
        del params
        self.tcfg = T.TrainConfig(lambda_dssim=cfg["train"]["lambda_dssim"],
                                  white_background=False)
        self.trainer = T.Trainer(pcd, views, self.tcfg, device=dev)
        del pcd
        start = int(self.traffic["start_step"])
        self.trainer.state = self.trainer.state._replace(step=start, active_sh_degree=3)
        self.start = start
        self._drive_check_steps()
        self._warm_up()
        return {"gaussians": self.trainer.state.num_points, "views": len(views),
                **self._coverage()}

    @torch.no_grad()
    def _coverage(self) -> dict:
        """Entries per pixel and lit share (colour > 0) of the first training
        view: the scene is not empty."""
        from gaustudio_torch.pipelines import train as T

        tr = self.trainer
        b, st = tr.batch(tr.cameras[0]), tr.settings()
        s = st._replace(viewmatrix=b.viewmatrix, projmatrix=b.projmatrix, campos=b.campos,
                        bg=torch.zeros(3, device=self.device))
        out = T.render_from_params(tr.state.params, 3, s)
        lit = out["render"].sum(0) > 0
        return {"entries_per_pixel": round(out["num_rendered"] / (st.image_width
                                                                  * st.image_height), 3),
                "lit": round(float(lit.float().mean()), 4)}

    def _recording(self):
        """Route the trainer's step through a recorder of each batch's view
        (its viewmatrix); returns the list it fills."""
        seen, inner = [], self.trainer.step

        def step(batch, settings):
            seen.append(batch.viewmatrix)
            return inner(batch, settings)

        self.trainer.step = step
        return seen

    def _view_index(self, viewmatrix) -> int:
        vm = viewmatrix.cpu()
        errs = [float((cam_vm - vm).abs().max()) for cam_vm in self._train_vms()]
        return int(np.argmin(errs))

    def _train_vms(self):
        from gaustudio_torch.datasets.utils import JSON_to_camera

        if not hasattr(self, "_vms"):
            self._vms = [JSON_to_camera(c, device="cpu").world_view_transform
                         for c in self.train_cams]
        return self._vms

    def _drive_check_steps(self):
        """The first ``check_steps`` iterations, through one ``train`` call;
        keeps what the reference compares."""
        n = int(self.traffic["check_steps"])
        tr = self.trainer
        p0 = {k: v.clone() for k, v in tr.state.params.items()}
        first = {}

        def after_step(m):
            if m["iter"] == self.start + 1:
                first.update(leaf_norms({k: v / (1.0 - B1) for k, v in tr.state.opt.mu.items()}))

        seen = self._recording()
        hist = tr.train(iterations=self.start + n, log_every=1, callback=after_step)
        del tr.step
        self.prog = {
            "losses": [h["loss"] for h in hist],
            "grad_norms": first,
            "update_norms": leaf_norms({k: tr.state.params[k] - p0[k] for k in p0}),
            "views": [self._view_index(vm) for vm in seen[:n]],
        }
        del p0

    def _warm_up(self):
        """Warm-up iterations through ``train``; the last ones, timed, give
        the rate that sizes the window."""
        tr = self.trainer
        tr.train(iterations=tr.state.step + int(self.traffic["warmup_steps"]))
        k = int(self.traffic["rate_steps"])
        sync(self.device)
        t0 = time.perf_counter()
        tr.train(iterations=tr.state.step + k)
        sync(self.device)
        self.rate_s = (time.perf_counter() - t0) / k

    # --- the window ------------------------------------------------------------

    def window(self, seconds: float) -> dict:
        tr = self.trainer
        n = max(1, int(round(seconds / self.rate_s)))
        sync(self.device)
        t0 = time.perf_counter()
        tr.train(iterations=tr.state.step + n)
        sync(self.device)
        wall = time.perf_counter() - t0
        self.attempted = n
        return {"train_ms_per_it": wall / n * 1e3}

    # --- the traced run ---------------------------------------------------------

    def traced(self) -> dict:
        from gsbench import trace

        tr = self.trainer
        k = int(self.traffic["traced_steps"])
        seen = self._recording()
        with trace.Window() as win:
            tr.train(iterations=tr.state.step + k)
        del tr.step
        prof = win.reduce()
        settings = tr.settings()
        index = [self._view_index(vm) for vm in seen[:k]]
        stages = [self._stage_ms(tr.batch(tr.cameras[index[i % k]]), settings)
                  for i in range(5)]
        # the attributes as the window leaves them, on the host until a
        # reader counts the window's work
        state = {n: v.detach().cpu() for n, v in tr.state.params.items()}
        dev = self.device
        self.attempted = k
        return {"model": self.cfg["model"], "kind": self.kind, "profile": prof, "steps": k,
                "params": lambda: {n: v.to(dev) for n, v in state.items()},
                "views": [(self.train_cams[i], 1) for i in index],
                "stage_ms": {n: statistics.median(s[n] for s in stages) for n in stages[0]}}

    def _stage_ms(self, batch, settings) -> dict:
        """One step's stages between CUDA events, on the trainer's state
        (not advanced): chip_smoke.py's ``step_breakdown``, frozen here."""
        from gaustudio_torch.ops import ssim
        from gaustudio_torch.pipelines import train as T
        from gaustudio_torch.pipelines.optimizers.general import adam_update

        state, dev = self.trainer.state, self.device
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(5)]
        s = settings._replace(viewmatrix=batch.viewmatrix, projmatrix=batch.projmatrix,
                              campos=batch.campos, bg=torch.zeros(3, device=dev))
        zero_bg = torch.zeros(3, device=dev)
        ev[0].record()
        params = {k: v.detach().requires_grad_(True) for k, v in state.params.items()}
        offset = torch.zeros((state.num_points, 2), device=dev, requires_grad=True)
        out = T.render_from_params(params, 3, s, means2d_offset=offset)
        ev[1].record()
        loss = ssim.rgb_loss(out["render"] + zero_bg[:, None, None]
                             * (1.0 - out["rendered_final_opacity"][0]), batch.gt_image,
                             self.tcfg.lambda_dssim)
        ev[2].record()
        grads = torch.autograd.grad(loss, [params[k] for k in T.PARAMS] + [offset])
        ev[3].record()
        with torch.no_grad():
            visible = out["radii"] > 0
            _ = (state.xyz_grad_accum + torch.where(visible, grads[-1].norm(dim=-1), 0.0),
                 state.denom + visible.float(),
                 torch.maximum(state.max_radii2d, out["radii"].float()))
            adam_update(dict(zip(T.PARAMS, grads[:-1])), state.opt, state.params,
                        T.learning_rates(self.tcfg, state.step))
        ev[4].record()
        sync(dev)
        return {n: ev[i].elapsed_time(ev[i + 1])
                for i, n in enumerate(("forward", "loss", "backward", "adam"))}

    def release(self):
        del self.trainer

    # --- the comparison -----------------------------------------------------------

    def reference(self, compute=torch.float32) -> dict:
        """The reference's readings of the check steps, from the seed, its
        render and gradients computed in ``compute``."""
        from gsbench.reference import train as R

        cfg, dev = self.cfg, self.device
        params = generate.scene(cfg, self.seed, dev)
        opt = R.adam_init(params)
        views = self.prog["views"]
        losses, first, p0 = [], None, {k: v.clone() for k, v in params.items()}
        for i, vi in enumerate(views):
            cam = self.train_cams[vi]
            gt = generate.images(cfg, [cam], self.seed, dev)[0]
            loss, grads, params, opt = R.step(params, opt, cam, gt, cfg["train"], self.start + i,
                                              compute)
            losses.append(loss)
            if i == 0:
                first = leaf_norms(grads)
        return {"losses": losses, "grad_norms": first,
                "update_norms": leaf_norms({k: params[k] - p0[k] for k in p0})}

    def adopt(self, readings: dict) -> None:
        """Put a reference's readings (a control's, a fault's) in the
        program's place."""
        self.prog = {**readings, "views": self.prog["views"]}

    def compare(self, ref: dict) -> dict:
        """{number: reading}: the worst relative loss gap over the steps, and,
        by the worst leaf, the gap between the program's and the reference's
        norm of the first gradient and of the three steps' change, each over
        the larger of the reference's norm of that leaf and of the median
        leaf. Leaves whose reference gradient is under a thousandth of the
        median leaf's are left out (they move by round-off alone)."""
        prog = self.prog
        loss = max(abs(a - b) / abs(b) for a, b in zip(prog["losses"], ref["losses"]))
        g_med = statistics.median(ref["grad_norms"].values())
        leaves = [k for k, v in ref["grad_norms"].items() if v >= 1e-3 * g_med]

        def worst(key):
            med = statistics.median(ref[key][k] for k in leaves)
            return max(abs(prog[key][k] - ref[key][k]) / max(ref[key][k], med) for k in leaves)

        return {"loss": loss, "grad": worst("grad_norms"), "update": worst("update_norms")}
