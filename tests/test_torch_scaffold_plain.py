"""Scaffold-GS's training step against the plain float32 reference
(gsbench/reference/scaffold.py, which imports nothing of the port), its
live-row compaction against rendering every decoded row, and its spans and
counters, on the CPU at 300 anchors x k = 4 and 48 px. On a card
(``python3 -m pytest --noconftest tests/test_torch_scaffold_plain.py``), the
CUDA-graphed photometric loss against the plain one.

The state is the benchmark's own seeded anchors and heads
(gsbench/generate_scaffold.py) in the layout of the ``scaffold-m360``
configuration, cut to this size: the same widths, four offsets an anchor.
"""

import copy
import json
import math
import os

import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from gaustudio_torch.datasets.utils import JSON_to_camera
from gaustudio_torch.ops import rasterize as rast
from gaustudio_torch.ops import ssim as ssim_ops
from gaustudio_torch.pipelines import train as T
from gaustudio_torch.pipelines import train_scaffold as TS
from gaustudio_torch.utils import observability as obs
from gsbench import generate, generate_scaffold
from gsbench.drivers import train_scaffold as driver
from gsbench.reference import scaffold as R

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CPU = torch.device("cpu")
N, K, SIZE, SEED = 300, 4, 48, 2**31 + 20
STEPS = 3  # camera indices 0, 5, 10 of the training ring
STATS = ("offset_grad_accum", "offset_denom", "opacity_accum", "anchor_denom")


def _config() -> dict:
    with open(os.path.join(ROOT, "gsbench", "configs", "scaffold-m360.json")) as f:
        cfg = json.load(f)
    cfg.update(width=SIZE, height=SIZE, views=24, anchors=N, n_offsets=K,
               heads={"opacity": K, "cov": 7 * K, "color": 3 * K})
    # anchors near the rig, so a 48 px view holds a few hundred rows
    cfg["scene"].update(object_share=0.8, ground_share=0.2, object_sigma=0.05,
                        ground_sigma=0.1)
    return cfg


@pytest.fixture(scope="module")
def setup():
    cfg = _config()
    cams = generate.split(cfg, generate.cameras(cfg))[0][:STEPS * 5:5]
    gts = generate.images(cfg, cams, SEED, CPU)
    pcd = driver.model(cfg, generate_scaffold.scene(cfg, SEED, CPU), CPU)
    cam0 = JSON_to_camera(cams[0], device=CPU)
    settings = rast.RasterizeSettings(image_height=SIZE, image_width=SIZE,
                                      tanfovx=math.tan(cam0.FoVx * 0.5),
                                      tanfovy=math.tan(cam0.FoVy * 0.5), bg=None, sh_degree=0)
    batches = []
    for c, gt in zip(cams, gts):
        cam = JSON_to_camera(c, device=CPU)
        batches.append(T.CameraBatch(cam.world_view_transform, cam.full_proj_transform,
                                     cam.camera_center, gt.permute(2, 0, 1).contiguous()))
    return cfg, cams, gts, pcd, settings, batches


def _uncompacted_step(state, batch, settings, cfg, heads, k):
    """The step with every decoded row through rasterize(): dead rows carry
    zero opacity, so binning culls them."""
    n = state.num_anchors
    s = settings._replace(viewmatrix=batch.viewmatrix, projmatrix=batch.projmatrix,
                          campos=batch.campos, bg=torch.zeros(3))
    params = {key: v.detach().requires_grad_(True) for key, v in state.params.items()}
    offset2d = torch.zeros((n * k, 2), requires_grad=True)
    xyz, color, opacity, scales, rots, neural_op = TS.decode_scaffold(params, heads, s.campos, k)
    out = rast.rasterize(xyz, opacity, s, colors_precomp=color, scales=scales, rotations=rots,
                         means2D_offset=offset2d)
    loss = TS.scaffold_loss(out, opacity, scales, batch.gt_image, cfg)
    leaves = list(params.values()) + [offset2d]
    grads = [torch.zeros_like(x) if g is None else g
             for x, g in zip(leaves, torch.autograd.grad(loss, leaves, allow_unused=True))]
    vs = grads.pop()
    with torch.no_grad():
        live = (out["radii"] > 0) & (opacity > 0.0)
        vs_norm = torch.sqrt(torch.sum(vs * vs, dim=-1) + 1e-24)
        op_anchor = torch.sum(torch.clamp(neural_op, 0.0, 1.0).reshape(n, k), dim=1)
        seen = live.reshape(n, k).any(dim=1)
        new_p, mu, nu, count = TS.shared_adam_update(
            dict(zip(params, grads)), state.mu, state.nu, state.opt_count, state.params,
            TS.learning_rates(state.params, state.step, cfg))
    return state._replace(
        params=new_p, mu=mu, nu=nu, opt_count=count, step=state.step + 1,
        offset_grad_accum=state.offset_grad_accum + torch.where(live, vs_norm, 0.0),
        offset_denom=state.offset_denom + live.float(),
        opacity_accum=state.opacity_accum + torch.where(seen, op_anchor / k, 0.0),
        anchor_denom=state.anchor_denom + seen.float()), {"loss": loss.detach()}


def _run(step_fn, setup):
    """STEPS steps of ``step_fn`` from step 15,000 -> [(loss, state)]."""
    cfg, _, _, pcd, settings, batches = setup
    tcfg = driver.train_config(cfg)
    state = TS.init_scaffold_state(pcd, CPU)._replace(step=15000)
    out = []
    for b in batches:
        state, m = step_fn(state, b, settings, tcfg, pcd.mlp, K)
        out.append((float(m["loss"]), state))
    return out


@pytest.fixture(scope="module")
def program(setup):
    return _run(TS.train_step_scaffold, setup)


@pytest.fixture(scope="module")
def reference(setup):
    """Each step's (loss, grads, params, statistics' sums) of the reference."""
    cfg, cams, gts, _, _, _ = setup
    params = generate_scaffold.scene(cfg, SEED, CPU)
    opt = R.adam_init(params)
    sums = {key: None for key in ("offset_grad", "offset_seen", "opacity", "anchor_seen")}
    out = []
    for i, (cam, gt) in enumerate(zip(cams, gts)):
        loss, grads, params, opt, stats = R.step(params, opt, cam, gt, cfg["train"], 15000 + i, K)
        sums = {key: stats[key] if v is None else v + stats[key] for key, v in sums.items()}
        out.append((loss, grads, params, dict(sums)))
    return out


def test_the_state_is_lit_with_live_and_dead_rows(program):
    state = program[0][1]
    live = float(state.offset_denom.sum())
    assert 0.2 * N * K < live < 0.9 * N * K  # a few hundred rows seen, some dead
    assert program[0][0] > 0.0


@pytest.mark.parametrize("step", range(STEPS))
def test_steps_match_the_plain_reference(program, reference, step):
    """Loss within 5e-7 relative (read: 2e-8 to 4e-8): float32 sums over
    2,304 pixels and ~500 rows in two orders. The first step's gradient of
    each leaf (as Adam's first moment holds it: mu = 0.1 g) within 2e-5 of
    the leaf's largest value (read: 1.9e-6): a gradient sums over every entry
    of a row and every row of a weight, in other orders. Each parameter and
    MLP weight after every step within 1e-4 of the leaf's largest value
    (read: 2e-7, 3e-6, 2e-5 after steps 1-3): Adam divides by sqrt(v), which
    magnifies the gradients' round-off where they are small. The statistics:
    the seen counts exactly; the viewspace gradient norms and the opacity
    sums within 2e-5 of their largest value (read: 1.3e-6), sums again."""
    loss, state = program[step]
    r_loss, r_grads, r_params, r_stats = reference[step]
    assert abs(loss - r_loss) <= 5e-7 * abs(r_loss)
    if step == 0:
        for key, g in r_grads.items():
            got = state.mu[key] / 0.1
            assert torch.allclose(got, g, rtol=0, atol=2e-5 * float(g.abs().max()) + 1e-12), key
    for key, p in r_params.items():
        assert torch.allclose(state.params[key], p, rtol=0,
                              atol=1e-4 * float(p.abs().max()) + 1e-12), key
    assert torch.equal(state.offset_denom, r_stats["offset_seen"])
    assert torch.equal(state.anchor_denom, r_stats["anchor_seen"])
    for got, want in ((state.offset_grad_accum, r_stats["offset_grad"]),
                      (state.opacity_accum, r_stats["opacity"])):
        assert torch.allclose(got, want, rtol=0, atol=2e-5 * float(want.abs().max()))


def test_compaction_changes_nothing(setup, program):
    """Every decoded row through rasterize() against the live rows alone: the
    same loss, moments, parameters and statistics. The plain path bins,
    sorts and blends the same Gaussians in the same order either way, and a
    dead row takes no entry and no gradient (the two read bit for bit
    alike); the tolerance, a few ulps of each tensor's largest value (1e-6),
    leaves room for a float32 sum of the shared heads' and anchors' gradients
    taken in another order."""
    full = _run(_uncompacted_step, setup)
    for (loss, state), (f_loss, f_state) in zip(program, full):
        assert abs(loss - f_loss) <= 1e-6 * abs(f_loss)
        for group in ("params", "mu", "nu"):
            for key, want in getattr(f_state, group).items():
                got = getattr(state, group)[key]
                assert torch.allclose(got, want, rtol=0,
                                      atol=1e-6 * float(want.abs().max()) + 1e-30), (group, key)
        for name in STATS:
            want = getattr(f_state, name)
            assert torch.allclose(getattr(state, name), want, rtol=0,
                                  atol=1e-6 * float(want.abs().max()) + 1e-30), name


def test_profiled_scaffold_window_records_spans_and_counters(setup):
    """Two steps of ScaffoldTrainer.train under a host-only profiler."""
    cfg, cams, gts, pcd, _, _ = setup
    views = []
    for c, gt in zip(cams, gts):
        cam = JSON_to_camera(c, device=CPU)
        cam.image = gt
        views.append(cam)
    trainer = TS.ScaffoldTrainer(copy.deepcopy(pcd), views, driver.train_config(cfg),
                                 device=CPU)
    with profile(activities=[ProfilerActivity.CPU]):
        trainer.train(iterations=2, log_every=1)
    rep = obs.report()
    spans, counters = rep["spans"], rep["counters"]
    for name, parent in (("gs.step", None), ("gs.loader_wait", "gs.step"),
                         ("gs.scaffold.decode", "gs.step"), ("gs.loss", "gs.step"),
                         ("gs.backward", "gs.step"), ("gs.adam", "gs.step"),
                         ("gs.preprocess", "gs.step")):
        assert spans[name]["calls"] == 2 and spans[name]["parent"] == parent, name
        assert spans[name]["device_ms"] is None  # no CUDA events on the CPU
    assert "gs.scaffold.adjust" not in spans  # no adjustment in two steps
    assert counters["gs.scaffold.anchors"] == 2 * N
    assert counters["gs.scaffold.rows"] == 2 * N * K
    assert 0 < counters["gs.scaffold.live"] <= counters["gs.scaffold.rows"]


@pytest.mark.cuda
def test_graphed_rgb_loss_matches_the_plain_loss():
    """The graphed loss replays the plain loss's kernels, call after call, on
    inputs that autograd reaches through other operations: the value within
    1e-6 relative and the gradient within 1e-6 of its largest value. Not bit
    for bit: the graph's buffers lie at other addresses, and a reduction
    may then take another vector width and sum in another order."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device; run this file with --noconftest on the card")
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(3)
    loss = TS.graphed_rgb_loss((3, 40, 56), 0.2, dev)
    for _ in range(3):
        leaf = torch.rand((3, 40, 56), generator=gen, device=dev, requires_grad=True)
        gt = torch.rand((3, 40, 56), generator=gen, device=dev)
        got = loss(leaf * 0.9, gt)
        want = ssim_ops.rgb_loss(leaf * 0.9, gt, 0.2)
        assert abs(float(got) - float(want)) <= 1e-6 * abs(float(want))
        g_got, g_want = (torch.autograd.grad(x, leaf)[0] for x in (got, want))
        assert torch.allclose(g_got, g_want, rtol=0, atol=1e-6 * float(g_want.abs().max()))
