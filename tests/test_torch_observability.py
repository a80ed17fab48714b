"""gaustudio_torch.utils.observability: trace / annotate on the CPU, and the
rasterizer's debug snapshot (a renderer config's "debug": true) against the
JAX package's on the same scene: a NaN input writes the snapshot, naming
the same bad leaves, and a finite one writes none."""

import json
import os
import pickle

import numpy as np
import pytest
import torch

import chip_smoke
from gaustudio_torch import models, renderers
from gaustudio_torch.datasets.utils import JSON_to_camera
from gaustudio_torch.utils import observability as obs
from gaustudio_tpu import models as j_models
from gaustudio_tpu import renderers as j_renderers
from gaustudio_tpu.datasets.utils import JSON_to_camera as j_json_to_camera
from gaustudio_tpu.utils import observability as j_obs

CPU = torch.device("cpu")
W, H, N = 32, 24, 300


@pytest.fixture(scope="module")
def scene(tmp_path_factory):
    out = tmp_path_factory.mktemp("scene")
    ply, cams = chip_smoke.write_full_scene(str(out), n=N, W=W, H=H)
    with open(cams) as f:
        return ply, json.load(f)[1]


def _port(ply):
    pcd = models.make({"name": "vanilla_pcd"}, device=CPU)
    pcd.load(ply)
    pcd.active_sh_degree = 3
    return pcd


def test_trace_writes_one_file_with_the_annotated_regions(tmp_path, scene):
    ply, cj = scene
    pcd, cam = _port(ply), JSON_to_camera(cj, device=CPU)
    renderer = renderers.make({"name": "vanilla_renderer"}, device=CPU)
    log_dir = str(tmp_path / "trace")
    with obs.trace(log_dir, "fly", device="cpu") as path:
        for _ in range(2):
            with obs.annotate("frame"):
                renderer.render(cam, pcd)
    # the trace and, beside it, the block's span report
    assert sorted(os.listdir(log_dir)) == sorted(
        [os.path.basename(path), os.path.basename(obs.report_path(path))])
    assert path.endswith(".pt.trace.json") and os.path.basename(path).startswith("fly.")
    with open(path) as f:
        names = [e.get("name") for e in json.load(f)["traceEvents"]]
    assert names.count("frame") == 2 and names.count("fly") == 1
    with obs.annotate("outside a trace"):  # a region without a profiler is a no-op
        pass


def test_trace_on_the_default_device_raises_without_a_card(tmp_path, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match='device="cpu"'):
        with obs.trace(str(tmp_path / "t")):
            pass
    assert not os.path.exists(tmp_path / "t")


def _jax_snapshot(ply, cj, nan_index, dump):
    pcd = j_models.make({"name": "vanilla_pcd"})
    pcd.load(ply)
    pcd.active_sh_degree = 3
    if nan_index is not None:
        opacity = np.array(pcd._opacity)
        opacity[nan_index] = np.nan
        pcd._opacity = opacity
    renderer = j_renderers.make({"name": "vanilla_renderer", "debug": True})
    np.asarray(renderer.render(j_json_to_camera(cj), pcd)["render"])  # waits for the callback
    if not os.path.exists(dump):
        return None
    with open(dump, "rb") as f:
        return pickle.load(f)


@pytest.mark.parametrize("nan_index", [None, 7], ids=["finite", "nan_opacity"])
def test_debug_snapshot_matches_jax(tmp_path, scene, monkeypatch, nan_index):
    ply, cj = scene
    pcd, cam = _port(ply), JSON_to_camera(cj, device=CPU)
    if nan_index is not None:
        pcd._opacity[nan_index] = float("nan")
    dump = str(tmp_path / "port.dump")
    monkeypatch.setenv("GS_DEBUG_SNAPSHOT", dump)
    renderers.make({"name": "vanilla_renderer", "debug": False}, device=CPU).render(cam, pcd)
    assert not os.path.exists(dump)  # debug off: nothing is tested, nothing written
    renderers.make({"name": "vanilla_renderer", "debug": True}, device=CPU).render(cam, pcd)
    if nan_index is None:  # a finite frame: no snapshot, as the JAX package writes none
        assert not os.path.exists(dump)
        return
    jdump = str(tmp_path / "jax.dump")
    monkeypatch.setenv("GS_DEBUG_SNAPSHOT", jdump)
    want = _jax_snapshot(ply, cj, nan_index, jdump)
    got = torch.load(dump)
    assert "['inputs']['opacities']" in got["bad_leaves"]
    assert got["bad_leaves"] == want["bad_leaves"]
    assert got["context"] == want["context"] == "rasterize forward (debug=True)"
    assert set(got["tree"]) == set(want["tree"]) == {"inputs", "outputs"}
    assert set(got["tree"]["outputs"]) == set(want["tree"]["outputs"])
    assert set(got["tree"]["inputs"]) == set(want["tree"]["inputs"])
    for key, leaf in want["tree"]["inputs"].items():
        if leaf is None:
            assert got["tree"]["inputs"][key] is None, key
        else:
            np.testing.assert_allclose(got["tree"]["inputs"][key].numpy(), leaf, rtol=1e-6,
                                       atol=1e-6, err_msg=key)
    for key in ("render", "depth", "final_T"):
        assert got["tree"]["outputs"][key].shape == want["tree"]["outputs"][key].shape, key
    opac = got["tree"]["inputs"]["opacities"].numpy()
    assert np.isnan(opac[nan_index]) and np.isfinite(np.delete(opac, nan_index)).all()


def test_snapshot_names_each_bad_leaf_as_jax_does(tmp_path):
    tree = {"a": torch.ones(3), "b": {"c": torch.tensor([1.0, float("inf")]),
                                      "d": torch.arange(3), "e": None},
            "f": [torch.zeros(2), torch.tensor([float("nan")])]}
    dump = str(tmp_path / "t.dump")
    assert obs.snapshot_on_nonfinite(tree, dump, context="unit")
    bad = torch.load(dump)["bad_leaves"]
    jdump = str(tmp_path / "j.dump")
    jtree = {"a": np.ones(3), "b": {"c": np.array([1.0, np.inf]), "d": np.arange(3), "e": None},
             "f": [np.zeros(2), np.array([np.nan])]}
    assert j_obs.snapshot_on_nonfinite(jtree, jdump, context="unit")
    with open(jdump, "rb") as f:
        assert bad == pickle.load(f)["bad_leaves"] == ["['b']['c']", "['f'][1]"]
    os.remove(dump)
    assert not obs.snapshot_on_nonfinite({"a": torch.ones(2), "b": [torch.arange(2)]}, dump)
    assert not os.path.exists(dump)
