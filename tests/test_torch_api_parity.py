"""The public accessors of the reference's model API, called on the same
inputs in both packages: VanillaPointCloud's get_* properties,
BasePointCloud's get_center_and_size, get_center, params and __add__,
Registry's ``in`` and ``[]``, GeneralOptimizer's torch-style setup / step /
zero_grad, utils.misc.get_rank, cameras.getWorld2View and Camera's repr."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from gaustudio_torch import cameras as t_cameras
from gaustudio_torch import models as t_models
from gaustudio_torch.pipelines import optimizers as t_optimizers
from gaustudio_torch.pipelines.optimizers import general as t_general
from gaustudio_torch.utils import misc as t_misc
from gaustudio_tpu import cameras as j_cameras
from gaustudio_tpu import models as j_models
from gaustudio_tpu.pipelines import optimizers as j_optimizers
from gaustudio_tpu.pipelines.optimizers import general as j_general
from gaustudio_tpu.utils import misc as j_misc


def _attrs(n, seed):
    rng = np.random.default_rng(seed)
    quats = rng.normal(size=(n, 4)).astype(np.float32)
    return dict(
        xyz=rng.normal(size=(n, 3)).astype(np.float32),
        rgb=rng.uniform(0.1, 0.9, (n, 3)).astype(np.float32),
        scale=np.log(rng.uniform(0.01, 0.2, (n, 3))).astype(np.float32),
        rot=quats / np.linalg.norm(quats, axis=1, keepdims=True),
        opacity=rng.normal(size=(n, 1)).astype(np.float32))


def _both(n=40, seed=0, f_rest=True):
    """The same vanilla model in both packages, with random SH bands."""
    attrs = _attrs(n, seed)
    rest = np.random.default_rng(seed + 100).normal(size=(n, 45)).astype(np.float32)
    j = j_models.make({"name": "vanilla_pcd"})
    j.create_from_attribute(**attrs)
    t = t_models.make({"name": "vanilla_pcd"}, device="cpu")
    t.create_from_attribute(**attrs)
    if f_rest:
        j._f_rest, t._f_rest = rest, torch.from_numpy(rest)
    else:  # an attribute the other model lacks: no rows
        j._f_rest, t._f_rest = np.zeros((0, 45), np.float32), torch.zeros((0, 45))
    return j, t


def _same(got, want, exact=False):
    got = got.numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    want = np.asarray(want)
    assert got.shape == want.shape
    if exact:
        np.testing.assert_array_equal(got, want)
    else:
        np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-7)


def _case_vanilla_accessors(_):
    j, t = _both()
    for name in ("get_opacity", "get_scaling", "get_rotation", "get_xyz", "get_features_dc",
                 "get_features_rest"):
        _same(getattr(t, name), getattr(j, name))
    assert t.get_num_points == j.get_num_points == 40


def _case_center_and_size(_):
    j, t = _both()
    for got, want in zip(t.get_center_and_size, j.get_center_and_size):
        _same(got, want, exact=True)
    _same(t.get_center, j.get_center, exact=True)


def _case_params(_):
    j, t = _both()
    got, want = t.params(), j.params()
    assert list(got) == list(want)
    for k in want:
        _same(got[k], want[k], exact=True)


def _case_add(f_rest):
    ja, ta = _both(30, seed=1)
    jb, tb = _both(20, seed=2, f_rest=f_rest)
    j, t = ja + jb, ta + tb
    assert type(t) is type(ta) and t.num_points == j.num_points == 50
    for attr in ta.config["attributes"]:
        _same(getattr(t, "_" + attr), getattr(j, "_" + attr), exact=True)
    with pytest.raises(TypeError):
        ta + 1  # noqa: B018


def _case_registry(_):
    for t_reg, j_reg in ((t_models._registry, j_models._registry),
                         (t_optimizers._registry, j_optimizers._registry)):
        for name in list(j_reg.keys()) + ["no_such_name"]:
            assert (name in t_reg) == (name in j_reg)
        for name in j_reg.keys():
            assert t_reg[name].__name__ == j_reg[name].__name__
        with pytest.raises(KeyError):
            t_reg["no_such_name"]


def _case_optimizer(_):
    rng = np.random.default_rng(3)
    conf = {"params": {"xyz": {"lr": 0.01}, "f_dc": {"lr": 0.002}}}
    params = {k: rng.normal(size=(8, 3)).astype(np.float32) for k in ("xyz", "f_dc")}
    grads = [{k: rng.normal(size=(8, 3)).astype(np.float32) for k in params} for _ in range(3)]
    t_opt = t_general.GeneralOptimizer(conf)
    j_opt = j_general.GeneralOptimizer(conf)
    t_opt.setup({k: torch.from_numpy(v) for k, v in params.items()})
    j_opt.setup({k: jnp.asarray(v) for k, v in params.items()})
    t_ref = {k: torch.from_numpy(v) for k, v in params.items()}
    t_state = t_general.adam_init(t_ref)
    for g in grads:
        t_opt.zero_grad()
        j_opt.zero_grad()
        got = t_opt.step({k: torch.from_numpy(v) for k, v in g.items()})
        want = j_opt.step({k: jnp.asarray(v) for k, v in g.items()})
        # step after setup equals update
        t_ref, t_state = t_opt.update({k: torch.from_numpy(v) for k, v in g.items()}, t_state,
                                      t_ref)
        for k in params:
            _same(got[k], t_ref[k], exact=True)
            _same(got[k], want[k])
    for k in params:
        np.testing.assert_array_equal(t_opt.state.count[k].numpy(),
                                      np.asarray(j_opt.state.count[k]))


def _case_get_rank(monkeypatch):
    for key in ("RANK", "LOCAL_RANK", "SLURM_PROCID", "JSM_NAMESPACE_RANK"):
        monkeypatch.delenv(key, raising=False)
    assert t_misc.get_rank() == j_misc.get_rank() == 0
    monkeypatch.setenv("SLURM_PROCID", "5")
    assert t_misc.get_rank() == j_misc.get_rank() == 5
    monkeypatch.setenv("RANK", "3")
    assert t_misc.get_rank() == j_misc.get_rank() == 3


def _case_cameras(_):
    rng = np.random.default_rng(4)
    q, _r = np.linalg.qr(rng.normal(size=(3, 3)))
    t = rng.normal(size=3)
    _same(t_cameras.getWorld2View(q, t), j_cameras.getWorld2View(q, t), exact=True)
    assert t_cameras.getWorld2View(q, t).dtype == np.float32
    kw = dict(R=q, T=t, FoVx=0.9, FoVy=0.7, image_width=40, image_height=30)
    assert repr(t_cameras.Camera(**kw, device="cpu")) == repr(j_cameras.Camera(**kw))


CASES = {
    "vanilla_accessors": _case_vanilla_accessors,
    "center_and_size": _case_center_and_size,
    "params": _case_params,
    "add": lambda _: _case_add(True),
    "add_missing_attribute": lambda _: _case_add(False),
    "registry": _case_registry,
    "optimizer": _case_optimizer,
    "get_rank": _case_get_rank,
    "cameras": _case_cameras,
}


@pytest.mark.parametrize("case", list(CASES))
def test_api_counterpart_matches_jax(case, monkeypatch):
    CASES[case](monkeypatch)
