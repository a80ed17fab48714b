"""Launch n ranks, and the multi-rank dry run of every parallel path (the
counterpart of the JAX package's ``__graft_entry__.py:dryrun_multichip``).

``run_ranks(n, fn, *args, device=...)`` spawns n processes with torchrun's
environment (``RANK``, ``WORLD_SIZE``, ``LOCAL_RANK``, ``LOCAL_WORLD_SIZE``,
``MASTER_ADDR``, ``MASTER_PORT`` on 127.0.0.1), joins each to the process
group (gloo on the CPU; on the card by the backend rule of ``mesh``), calls
``fn(*args)`` and returns each rank's result. A rank that fails fails the
call: its traceback and every exit code are in the error, and the ranks
left waiting on it are stopped.

``dryrun_multichip(n)`` runs, on a tiny scene, the train step on every
(dp, gs) split of n with gs in {1, 2, 4}, the DPTrainer's schedule through
a densify, the camera-parallel render with TSDF fusion, and the
camera-parallel surfel render::

    python -m gaustudio_torch.parallel.dryrun 4 --device cpu
"""

from __future__ import annotations

import argparse
import math
import os
import queue
import socket
import time
import traceback

import numpy as np
import torch
import torch.distributed as dist
import torch.multiprocessing as mp

from gaustudio_torch.parallel.mesh import init_distributed, make_mesh


def free_port() -> int:
    """A TCP port on 127.0.0.1 that nothing listens on now."""
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _rank_main(rank, world, port, device, threads, fn, args, results):
    os.environ.update(RANK=str(rank), WORLD_SIZE=str(world), LOCAL_RANK=str(rank),
                      LOCAL_WORLD_SIZE=str(world), MASTER_ADDR="127.0.0.1",
                      MASTER_PORT=str(port))
    if threads:
        torch.set_num_threads(threads)
    try:
        init_distributed(device)
        results.put((rank, True, fn(*args)))
    except BaseException:
        results.put((rank, False, traceback.format_exc()))
        raise
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()


def run_ranks(n: int, fn, *args, device=None, timeout: float = 1800.0, threads: int = 0):
    """Run ``fn(*args)`` on n spawned ranks; returns the list of their
    results by rank (``fn`` and its arguments and results are pickled).

    ``device``: each rank's, as ``mesh.rank_device`` reads it (None: the
    card of its local rank). ``threads``: torch's CPU threads a rank (0:
    torch's default)."""
    ctx = mp.get_context("spawn")
    results = ctx.Queue()
    port = free_port()
    procs = [ctx.Process(target=_rank_main, args=(r, n, port, device, threads, fn, args, results))
             for r in range(n)]
    for p in procs:
        p.start()
    got, errors = {}, {}
    deadline = time.monotonic() + timeout
    try:
        # drain the queue before joining; after a failure the others may wait
        # on the failed rank in a collective, so give them a short grace
        while len(got) + len(errors) < n:
            left = deadline - time.monotonic()
            if errors:
                left = min(left, 20.0)
            try:
                rank, ok, value = results.get(timeout=max(left, 0.1))
            except queue.Empty:
                break
            (got if ok else errors)[rank] = value
            if not ok:
                deadline = min(deadline, time.monotonic() + 20.0)
    finally:
        for p in procs:
            p.join(timeout=max(1.0, min(60.0, deadline - time.monotonic())))
        for p in procs:
            if p.is_alive():
                p.kill()
                p.join(timeout=10.0)
    codes = [p.exitcode for p in procs]
    if errors or len(got) < n or any(c != 0 for c in codes):
        lines = [f"run_ranks({n}): exit codes {codes}; results from ranks {sorted(got)}"]
        lines += [f"rank {r} failed:\n{errors[r]}" for r in sorted(errors)]
        raise RuntimeError("\n".join(lines))
    return [got[r] for r in range(n)]


def _scene(device, n: int = 64, size: int = 32, n_cams: int = 4):
    """A tiny vanilla model (SH 0) and orbit cameras with their renders as
    ground truth."""
    from gaustudio_torch import models, renderers
    from gaustudio_torch.cameras import camera_paths

    rng = np.random.default_rng(0)
    pcd = models.make({"name": "vanilla_pcd"}, device=device)
    pcd.create_from_attribute(xyz=rng.normal(size=(n, 3)).astype(np.float32) * 0.4,
                              rgb=rng.uniform(0.1, 0.9, (n, 3)).astype(np.float32))
    pcd.active_sh_degree = 0
    cams = camera_paths.get_path_from_orbit(
        np.zeros(3), 2.0, num_cam=n_cams, image_size=size,
        fov_deg=2 * math.degrees(math.atan(0.7)), device=device)
    renderer = renderers.make({"name": "vanilla_renderer"}, device=device)
    for cam in cams:
        cam.image = renderer.render(cam, pcd)["render"].permute(1, 2, 0).clone()
    return pcd, cams


def dryrun_rank(device=None) -> dict:
    """One rank's dry run of every parallel path (see the module's doc);
    returns what it checked."""
    from gaustudio_torch import renderers
    from gaustudio_torch.ops import tsdf
    from gaustudio_torch.parallel import render_dp, train_dp
    from gaustudio_torch.pipelines import train as T

    device = init_distributed(device)
    world, rank = dist.get_world_size(), dist.get_rank()
    pcd, cams = _scene(device, n_cams=max(4, world))
    pcd._f_dc = torch.zeros_like(pcd._f_dc)  # away from the ground truth
    report = {"train_step": {}}

    # 1. the sharded step over every (dp, gs) split with gs in {1, 2, 4}
    cfg = T.TrainConfig()
    single = T.Trainer(pcd, cams, cfg, device=device)
    for gs in (1, 2, 4):
        if world % gs:
            continue
        mesh = make_mesh(dp=world // gs, gs=gs, device=device)
        step = train_dp.make_dp_train_step(mesh, single.settings(), cfg)
        state = train_dp.shard_state(step.comm, T.init_state(pcd, device))
        losses = []
        for _ in range(2):
            state, metrics = step(state, single.batch(cams[step.comm.dp_rank]))
            losses.append(float(metrics["loss"]))
        if not np.isfinite(losses).all():
            raise FloatingPointError(f"non-finite loss on mesh dp={world // gs} gs={gs}")
        report["train_step"][f"{world // gs}x{gs}"] = losses
        if rank == 0:
            print(f"dryrun train step OK: mesh dp={world // gs} gs={gs}, loss {losses}", flush=True)

    # 2. the DPTrainer's schedule through a densify and an opacity reset
    gs = 2 if world % 2 == 0 else 1
    dcfg = cfg._replace(densify_from_iter=0, densify_until_iter=100, densification_interval=2,
                        densify_grad_threshold=1e-7, opacity_reset_interval=6, iterations=6)
    dpt = train_dp.DPTrainer(pcd, cams, dcfg, mesh=make_mesh(dp=world // gs, gs=gs, device=device))
    hist = dpt.train(iterations=6, log_every=1)
    grown = sum(m.get("n_clone", 0) + m.get("n_split", 0) for m in hist)
    if not (np.isfinite([m["loss"] for m in hist]).all() and grown > 0):
        raise RuntimeError(f"DPTrainer schedule: losses {[m['loss'] for m in hist]}, grown {grown}")
    report["schedule"] = [m["num_points"] for m in hist]
    if rank == 0:
        print(f"dryrun DPTrainer schedule OK: dp={world // gs} gs={gs}, points "
              f"{report['schedule']}", flush=True)

    # 3. camera-parallel render and TSDF fusion, and the surfel render
    mesh = make_mesh(dp=world, gs=1, device=device)
    views = render_dp.stack_cameras(cams, pad_to=world, device=device)
    settings, render_fn = renderers.make({"name": "vanilla_renderer"}, device=device) \
        .dp_render_closure(cams, pcd)
    out = render_dp.make_dp_render_fn(mesh, settings, render_fn)(views)
    vol = render_dp.make_dp_fuse_fn(mesh, settings, render_fn)(
        tsdf.volume_from_bounds([-1, -1, -1], [1, 1, 1], 0.1, 0.3, device=device), views)
    surfel = renderers.make({"name": "surfel_renderer"}, device=device)
    s_settings, s_fn = surfel.dp_render_closure(cams, pcd)
    s_out = render_dp.make_dp_render_fn(mesh, s_settings, s_fn)(views)
    finite = all(bool(torch.isfinite(t).all()) for t in
                 [out["render"], vol.tsdf, s_out["render"], s_out["rendered_depth_sum"],
                  s_out["rendered_normal_view"]])
    if not finite:
        raise FloatingPointError("non-finite camera-parallel render or fusion")
    report["render_shape"] = tuple(out["render"].shape)
    report["fused_weight"] = float(vol.weight.sum())
    if rank == 0:
        print(f"dryrun DP render OK: {views.viewmatrix.shape[0]} views, this rank's block "
              f"{tuple(out['render'].shape)}; TSDF fuse total weight {report['fused_weight']:.1f}; "
              f"surfel render OK", flush=True)
    return report


def dryrun_multichip(n: int, device=None) -> list:
    """The dry run on n spawned ranks; returns each rank's report."""
    reports = run_ranks(n, dryrun_rank, device, device=device,
                        threads=1 if device is not None and torch.device(device).type == "cpu" else 0)
    print(f"dryrun_multichip OK: {n} ranks, train meshes {sorted(reports[0]['train_step'])}, "
          f"DP render + TSDF fuse + surfel render", flush=True)
    return reports


def main(argv=None):
    parser = argparse.ArgumentParser(description="multi-rank dry run of the parallel paths")
    parser.add_argument("n", type=int, nargs="?", default=4, help="ranks to spawn")
    parser.add_argument("--device", default=None, choices=["cuda", "cpu"],
                        help="default: each rank on the card of its local rank")
    args = parser.parse_args(argv)
    dryrun_multichip(args.n, None if args.device == "cuda" else args.device)


if __name__ == "__main__":
    main()
