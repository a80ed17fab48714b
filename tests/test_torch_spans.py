"""The port's spans and counters (utils/observability.py annotate / count /
report) on the CPU at tiny sizes: off with no profiler, and under one the
gs.* spans of a training step, a render and an extraction, with their
parents, calls and counts, and the report file that trace() writes."""

import copy
import json
import os

import pytest
import torch
from torch.profiler import ProfilerActivity, profile

import chip_smoke
from gaustudio_torch import models, renderers
from gaustudio_torch.datasets.utils import JSON_to_camera
from gaustudio_torch.ops import binning
from gaustudio_torch.pipelines import train as T
from gaustudio_torch.pipelines.mesh_extraction import extract_mesh
from gaustudio_torch.utils import observability as obs

CPU = torch.device("cpu")
W, H, N = 32, 24, 300
RENDER_SPANS = {"gs.render": None, "gs.features": "gs.render", "gs.preprocess": "gs.render",
                "gs.bin": "gs.render", "gs.composite": "gs.render"}


@pytest.fixture(scope="module")
def scene(tmp_path_factory):
    out = tmp_path_factory.mktemp("scene")
    ply, cams = chip_smoke.write_full_scene(str(out), n=N, W=W, H=H)
    with open(cams) as f:
        cams = json.load(f)
    pcd = models.make({"name": "vanilla_pcd"}, device=CPU)
    pcd.load(ply)
    pcd.active_sh_degree = 3
    return pcd, [JSON_to_camera(c, device=CPU) for c in cams[:4]]


def _cpu_profile():
    return profile(activities=[ProfilerActivity.CPU])


def _host_names(prof):
    cpu = torch.autograd.DeviceType.CPU
    return [e.name() for e in prof.profiler.kineto_results.events() if e.device_type() == cpu]


def _spans(names):
    rep = obs.report()["spans"]
    return {n: rep[n] for n in names}


def test_no_profiler_no_record_function(scene, tmp_path, monkeypatch):
    pcd, cams = scene
    with obs.trace(str(tmp_path), "empty", device="cpu"):
        pass  # starts an empty record
    assert obs.report() == {"spans": {}, "counters": {}}

    def refuse(*args, **kwargs):
        raise AssertionError("a profiler region entered with no profiler")

    monkeypatch.setattr(torch.autograd.profiler, "record_function", refuse)
    monkeypatch.setattr(torch._C._profiler, "_RecordFunctionFast", refuse)
    monkeypatch.setattr(torch.cuda, "Event", refuse)
    renderers.make({"name": "vanilla_renderer"}, device=CPU).render(cams[0], pcd)
    with obs.annotate("gs.outside", torch.zeros(1)):
        obs.count("gs.outside", 3)
    assert obs.report() == {"spans": {}, "counters": {}}


def test_training_step_spans(scene):
    pcd, cams = scene
    views = []
    for i, cam in enumerate(cams):
        cam = copy.copy(cam)
        cam.image = torch.rand((H, W, 3), generator=torch.Generator().manual_seed(i))
        views.append(cam)
    trainer = T.Trainer(pcd, views, T.TrainConfig(), device=CPU)
    obs.report()  # closes any earlier window
    with _cpu_profile() as prof:
        trainer.train(iterations=2)
    want = {"gs.step": None, "gs.loader_wait": "gs.step", **RENDER_SPANS,
            "gs.render": "gs.step", "gs.loss": "gs.step", "gs.backward": "gs.step",
            "gs.composite_bwd": "gs.backward", "gs.adam": "gs.step"}
    got = _spans(want)
    assert {n: s["parent"] for n, s in got.items()} == want
    assert {n: s["calls"] for n, s in got.items()} == {n: 2 for n in want}
    assert all(s["device_ms"] is None for s in got.values())  # no CUDA events on the CPU
    host = _host_names(prof)
    assert {n: host.count(n) for n in want} == {n: 2 for n in want}


def test_render_counters_match_the_binning(scene, monkeypatch):
    pcd, cams = scene
    seen = []
    inner = binning.bin_gaussians

    def bin_gaussians(pre, *args, **kwargs):
        out = inner(pre, *args, **kwargs)
        seen.append((int(pre.valid.sum()), int(pre.tiles_touched.sum()), out.num_rendered))
        return out

    monkeypatch.setattr(binning, "bin_gaussians", bin_gaussians)
    renderer = renderers.make({"name": "vanilla_renderer"}, device=CPU)
    obs.report()
    with _cpu_profile() as prof:
        outs = [renderer.render(cam, pcd) for cam in cams]
    rep = obs.report()
    assert {n: s["parent"] for n, s in _spans(RENDER_SPANS).items()} == RENDER_SPANS
    assert {n: s["calls"] for n, s in _spans(RENDER_SPANS).items()} == {
        n: len(cams) for n in RENDER_SPANS}
    assert _host_names(prof).count("gs.render") == len(cams)
    assert rep["counters"] == {
        "gs.frustum": sum(v for v, _, _ in seen), "gs.rect_tiles": sum(t for _, t, _ in seen),
        "gs.entries": sum(o["num_rendered"] for o in outs), "gs.pixels": len(cams) * W * H,
        "gs.preprocess.calls": len(cams), "gs.preprocess.kernel": 0}  # K7 runs on a card only
    assert rep["counters"]["gs.entries"] == sum(e for _, _, e in seen)
    assert 0 < rep["counters"]["gs.entries"] <= rep["counters"]["gs.rect_tiles"]


def test_extract_mesh_spans(scene, tmp_path):
    pcd, cams = scene
    renderer = renderers.make({"name": "vanilla_renderer"}, device=CPU)
    obs.report()
    with _cpu_profile() as prof:
        verts, faces = extract_mesh(pcd, renderer, [copy.copy(c) for c in cams],
                                    work_dir=str(tmp_path), stride=1, downsample=1,
                                    voxel_size=0.05, sdf_trunc=0.2, min_weight=1, max_dim=48,
                                    device=CPU)
    assert len(verts) and len(faces)
    want = {"gs.extract_mesh": None, "gs.mesh.views": "gs.extract_mesh",
            "gs.render": "gs.mesh.views", "gs.mesh.view_files": "gs.mesh.views",
            "gs.mesh.integrate": "gs.mesh.views", "gs.mesh.writer_wait": "gs.mesh.views",
            "gs.mesh.march": "gs.extract_mesh", "gs.mesh.dedup": "gs.extract_mesh",
            "gs.mesh.ply": "gs.extract_mesh"}
    got = _spans(want)
    assert {n: s["parent"] for n, s in got.items()} == want
    for n in ("gs.render", "gs.mesh.view_files", "gs.mesh.integrate"):
        assert got[n]["calls"] == len(cams), n
    for n in ("gs.extract_mesh", "gs.mesh.views", "gs.mesh.march", "gs.mesh.dedup",
              "gs.mesh.ply"):
        assert got[n]["calls"] == 1, n
    counters = obs.report()["counters"]
    assert counters["gs.mesh.vertices"] == len(verts)
    assert counters["gs.mesh.triangles"] >= len(faces)
    host = _host_names(prof)
    assert host.count("gs.mesh.march") == 1 and host.count("gs.mesh.integrate") == len(cams)


def test_trace_writes_the_report_beside_the_trace(scene, tmp_path):
    pcd, cams = scene
    renderer = renderers.make({"name": "vanilla_renderer"}, device=CPU)
    with obs.trace(str(tmp_path), "frames", device="cpu") as path:
        for cam in cams[:2]:
            renderer.render(cam, pcd)
    with open(obs.report_path(path)) as f:
        written = json.load(f)
    assert os.path.dirname(obs.report_path(path)) == os.path.dirname(path)
    assert written == obs.report()
    assert written["spans"]["gs.render"] == {"calls": 2, "parent": None, "device_ms": None}
    assert written["counters"]["gs.pixels"] == 2 * W * H


def test_counter_tensors_fold_to_the_same_total():
    obs.report()
    with _cpu_profile():
        for i in range(3 * obs._Record.FOLD + 5):
            obs.count("gs.test", torch.full((4,), i))
        obs.count("gs.test", 7)
    total = 4 * sum(range(3 * obs._Record.FOLD + 5)) + 7
    assert obs.report()["counters"] == {"gs.test": total}
