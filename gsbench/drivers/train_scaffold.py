"""The Scaffold-GS training loop as users run it: ``ScaffoldTrainer.train``
(what ``gs-train --config scaffold`` calls) from a state past anchor growing,
with the trainer's own loader drawing the training views.

The state is ``generate_scaffold``'s anchors and heads at step 15,000, past
``update_until``, so the anchor count stays fixed as in the second half of
every 30k run. ``ScaffoldTrainer.train`` counts its iterations from 1 in
every call, so a call of more than ``update_from`` iterations would grow
anchors: the window is cut into calls of at most that many.

Set-up drives the trainer through its first ``check_steps`` iterations in
one ``train`` call: those iterations are the ones the reference
(``gsbench/reference/scaffold.py``) follows (their losses, the first
gradient as Adam's first moment holds it, the parameters' change, the MLP
weights included). Further warm-up iterations go through the same call. The
window is one more ``train`` call of as many iterations as the warm-up's
rate fits into ``--seconds``; its metric is the window's wall over those
iterations. The comparison is the 3DGS train driver's.
"""

from __future__ import annotations

import time

import torch

from gsbench import generate, generate_scaffold
from gsbench.drivers import train as base
from gsbench.util import sync


def train_config(cfg: dict):
    """The trainer's configuration of the benchmark's configuration."""
    from gaustudio_torch.pipelines import train_scaffold as TS

    t, lr = cfg["train"], cfg["train"]["lr"]
    return TS.ScaffoldTrainConfig(
        iterations=t["iterations"], lambda_dssim=t["lambda_dssim"], lambda_vol=t["lambda_vol"],
        lr_anchor=lr["anchor"], lr_offset_init=lr["offset_init"],
        lr_offset_final=lr["offset_final"], lr_offset_max_steps=lr["offset_max_steps"],
        lr_feat=lr["anchor_feat"], lr_scale=lr["scale"], lr_rot=lr["rot"],
        lr_mlp_opacity=lr["mlp_opacity"], lr_mlp_cov=lr["mlp_cov"],
        lr_mlp_color=lr["mlp_color"], update_from=t["update_from"],
        update_interval=t["update_interval"], update_until=t["update_until"],
        white_background=cfg["white_background"])


def model(cfg: dict, state: dict, device):
    """A ScaffoldPointCloud of ``generate_scaffold``'s state."""
    from gaustudio_torch.models.scaffold import ScaffoldPointCloud

    host = {key: v.cpu() for key, v in state.items()}
    n = host["anchor"].shape[0]
    layers = {head: [{"w": host[f"mlp.{head}.{i}.weight"].T, "b": host[f"mlp.{head}.{i}.bias"]}
                     for i in (0, 2)] for head in cfg["heads"]}
    params = {key: host[key] for key in ("anchor", "offset", "anchor_feat", "scale", "rot")}
    params.update(opacity=torch.zeros((n, 1)), mlps=layers)
    return ScaffoldPointCloud.from_jax_params(params, device=device, config={
        "n_offsets": cfg["n_offsets"], "voxel_size": cfg["voxel_size"],
        "use_feat_bank": cfg["use_feat_bank"],
        "attributes": {"anchor": 3, "offset": 3, "anchor_feat": cfg["feat_dim"], "opacity": 1,
                       "scale": 6, "rot": 4}})


class Run(base.Run):
    kind = "train_scaffold"

    def __init__(self, cfg: dict, traffic: dict, seed: int, device):
        if cfg["model"] != "scaffold":
            raise ValueError(f"the train_scaffold driver runs ScaffoldTrainer, not "
                             f"{cfg['model']!r}")
        self.cfg, self.traffic, self.seed, self.device = cfg, traffic, seed, device

    # --- set-up ------------------------------------------------------------

    def setup(self) -> dict:
        from gaustudio_torch.datasets.utils import JSON_to_camera
        from gaustudio_torch.pipelines import train_scaffold as TS

        cfg, dev = self.cfg, self.device
        cams = generate.cameras(cfg)
        self.train_cams, _ = generate.split(cfg, cams)
        gt = generate.images(cfg, self.train_cams, self.seed, dev)
        # the dataset holds its images on the host, as a capture's loader does
        gt_host = gt.cpu()
        del gt
        views = base._Views()
        for c, img in zip(self.train_cams, gt_host):
            cam = JSON_to_camera(c, device="cpu")
            cam.image = img
            views.append(cam)
        views.cameras_extent = base._extent(self.train_cams)
        pcd = model(cfg, generate_scaffold.scene(cfg, self.seed, dev), dev)
        self.tcfg = train_config(cfg)
        self.trainer = TS.ScaffoldTrainer(pcd, views, self.tcfg, device=dev)
        del pcd
        self.start = int(self.traffic["start_step"])
        self.trainer.state = self.trainer.state._replace(step=self.start)
        self._drive_check_steps()
        self._warm_up()
        n = self.trainer.state.num_anchors
        return {"anchors": n, "rows": n * int(self.cfg["n_offsets"]), "views": len(views),
                **self._coverage()}

    @torch.no_grad()
    def _coverage(self) -> dict:
        """Entries per pixel, lit share (colour > 0) and the share of decoded
        rows with positive opacity of the first training view."""
        from gaustudio_torch.ops import rasterize as rast
        from gaustudio_torch.pipelines import train_scaffold as TS

        tr = self.trainer
        b, st = tr.batch(tr.cameras[0]), tr.settings()
        s = st._replace(viewmatrix=b.viewmatrix, projmatrix=b.projmatrix, campos=b.campos,
                        bg=torch.zeros(3, device=self.device))
        xyz, color, opacity, scales, rots, _ = TS.decode_scaffold(
            tr.state.params, tr.pcd.mlp, b.campos, int(self.cfg["n_offsets"]))
        live = opacity > 0.0
        out = rast.rasterize(xyz[live], opacity[live], s, colors_precomp=color[live],
                             scales=scales[live], rotations=rots[live])
        lit = out["render"].sum(0) > 0
        return {"entries_per_pixel": round(out["num_rendered"] / (st.image_width
                                                                  * st.image_height), 3),
                "lit": round(float(lit.float().mean()), 4),
                "live_share": round(float(live.float().mean()), 4)}

    def _drive_check_steps(self):
        """The first ``check_steps`` iterations, through one ``train`` call;
        keeps what the reference compares."""
        n = int(self.traffic["check_steps"])
        tr = self.trainer
        p0 = {k: v.clone() for k, v in tr.state.params.items()}
        first = {}

        def after_step(m):
            if m["iter"] == 1:
                first.update(base.leaf_norms({k: v / (1.0 - base.B1)
                                              for k, v in tr.state.mu.items()}))

        seen = self._recording()
        hist = tr.train(iterations=n, log_every=1, callback=after_step)
        del tr.step
        self.prog = {
            "losses": [h["loss"] for h in hist],
            "grad_norms": first,
            "update_norms": base.leaf_norms({k: tr.state.params[k] - p0[k] for k in p0}),
            "views": [self._view_index(vm) for vm in seen[:n]],
        }
        del p0

    def _train(self, iterations: int) -> None:
        """``iterations`` more iterations, in calls that stay under
        ``update_from`` (each call counts from 1)."""
        left = iterations
        while left > 0:
            now = min(left, self.tcfg.update_from)
            self.trainer.train(iterations=now)
            left -= now

    def _warm_up(self):
        """Warm-up iterations through ``train``; the last ones, timed, give
        the rate that sizes the window."""
        self._train(int(self.traffic["warmup_steps"]))
        k = int(self.traffic["rate_steps"])
        sync(self.device)
        t0 = time.perf_counter()
        self._train(k)
        sync(self.device)
        self.rate_s = (time.perf_counter() - t0) / k

    # --- the window ------------------------------------------------------------

    def window(self, seconds: float) -> dict:
        n = max(1, int(round(seconds / self.rate_s)))
        sync(self.device)
        t0 = time.perf_counter()
        self._train(n)
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
            self._train(k)
        del tr.step
        prof = win.reduce()
        index = [self._view_index(vm) for vm in seen[:k]]
        # the anchors and heads as the window leaves them, on the host until
        # a reader counts the window's work
        state = {n: v.detach().cpu() for n, v in tr.state.params.items()}
        dev = self.device
        self.attempted = k
        return {"model": self.cfg["model"], "kind": self.kind, "profile": prof, "steps": k,
                "params": lambda: {n: v.to(dev) for n, v in state.items()},
                "views": [(self.train_cams[i], 1) for i in index]}

    # --- the comparison -----------------------------------------------------------

    def reference(self) -> dict:
        """The reference's readings of the check steps, from the seed."""
        from gsbench.reference import scaffold as R

        cfg, dev = self.cfg, self.device
        k = int(cfg["n_offsets"])
        params = generate_scaffold.scene(cfg, self.seed, dev)
        opt = R.adam_init(params)
        losses, first, p0 = [], None, {key: v.clone() for key, v in params.items()}
        for i, vi in enumerate(self.prog["views"]):
            cam = self.train_cams[vi]
            gt = generate.images(cfg, [cam], self.seed, dev)[0]
            loss, grads, params, opt, _ = R.step(params, opt, cam, gt, cfg["train"],
                                                 self.start + i, k)
            losses.append(loss)
            if i == 0:
                first = base.leaf_norms(grads)
            del grads
        return {"losses": losses, "grad_norms": first,
                "update_norms": base.leaf_norms({key: params[key] - p0[key] for key in p0})}

