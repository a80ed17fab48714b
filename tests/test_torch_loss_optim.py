"""Port parity of the training loss and optimizer: ssim / rgb_loss / psnr
values and gradients, the functional Adam with per-row step counts, and the
learning-rate schedule, against gaustudio_tpu on the same numpy inputs."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from gaustudio_torch.ops import ssim as t_ssim
from gaustudio_torch.pipelines import optimizers as t_optimizers
from gaustudio_torch.pipelines.optimizers import general as t_opt
from gaustudio_tpu.ops import ssim as j_ssim
from gaustudio_tpu.pipelines.optimizers import general as j_opt


def _images(seed, shape=(3, 24, 31)):
    rng = np.random.default_rng(seed)
    a = rng.uniform(size=shape).astype(np.float32)
    b = np.clip(a + rng.normal(size=shape).astype(np.float32) * 0.1, 0, 1).astype(np.float32)
    return a, b


@pytest.mark.parametrize("name", ["ssim", "rgb_loss", "psnr", "l1_loss"])
def test_loss_values_and_gradients_match_jax(name):
    a, b = _images(0)
    t_fn, j_fn = getattr(t_ssim, name), getattr(j_ssim, name)
    ta = torch.tensor(a, requires_grad=True)
    t_val = t_fn(ta, torch.tensor(b))
    (t_grad,) = torch.autograd.grad(t_val, ta)
    j_val, j_grad = jax.value_and_grad(lambda x: j_fn(x, jnp.asarray(b)))(jnp.asarray(a))
    np.testing.assert_allclose(float(t_val.detach()), float(j_val), rtol=1e-5)
    scale = np.abs(np.asarray(j_grad)).max()
    np.testing.assert_allclose(t_grad.numpy() / scale, np.asarray(j_grad) / scale,
                               rtol=1e-5, atol=1e-6)


def test_ssim_pads_by_replication():
    """A constant image blurred with edge padding stays constant; Inria's
    zero padding would darken its border."""
    img = torch.full((3, 12, 12), 0.7)
    blurred = t_ssim._blur(img, t_ssim._gaussian_kernel())
    torch.testing.assert_close(blurred, img, rtol=1e-6, atol=1e-6)
    assert float(t_ssim.ssim(img, img)) == pytest.approx(1.0, abs=1e-6)


def _adam_inputs(seed=0):
    rng = np.random.default_rng(seed)
    shapes = {"xyz": (7, 3), "opacity": (7, 1), "f_rest": (7, 45)}
    params = {k: rng.normal(size=s).astype(np.float32) for k, s in shapes.items()}
    grads = {k: (rng.normal(size=s) * 1e-3).astype(np.float32) for k, s in shapes.items()}
    mu = {k: (rng.normal(size=s) * 1e-3).astype(np.float32) for k, s in shapes.items()}
    nu = {k: (rng.uniform(size=s) * 1e-6).astype(np.float32) for k, s in shapes.items()}
    # rows 2 and 5 were just densified: zero moments and a restarted count
    count = {k: rng.integers(1, 50, size=7).astype(np.int32) for k in shapes}
    for k in shapes:
        mu[k][[2, 5]] = 0.0
        nu[k][[2, 5]] = 0.0
        count[k][[2, 5]] = 0
    lrs = {"xyz": 1.6e-4, "opacity": 0.05, "f_rest": 1.25e-4}
    return params, grads, (mu, nu, count), lrs


def test_adam_update_matches_jax_with_restarted_rows():
    params, grads, (mu, nu, count), lrs = _adam_inputs()
    t = lambda d: {k: torch.tensor(v) for k, v in d.items()}
    j = lambda d: {k: jnp.asarray(v) for k, v in d.items()}
    t_params, t_state = t_opt.adam_update(
        t(grads), t_opt.AdamState(t(mu), t(nu), t(count)), t(params), lrs)
    j_params, j_state = j_opt.adam_update(
        j(grads), j_opt.AdamState(j(mu), j(nu), j(count)), j(params), lrs)
    for k in params:
        np.testing.assert_allclose(t_params[k].numpy(), np.asarray(j_params[k]),
                                   rtol=1e-6, atol=1e-7, err_msg=k)
        np.testing.assert_allclose(t_state.mu[k].numpy(), np.asarray(j_state.mu[k]),
                                   rtol=1e-6, err_msg=k)
        np.testing.assert_allclose(t_state.nu[k].numpy(), np.asarray(j_state.nu[k]),
                                   rtol=1e-6, err_msg=k)
        np.testing.assert_array_equal(t_state.count[k].numpy(), np.asarray(j_state.count[k]))
        # a restarted row's first step is lr * sign(g): bias correction per
        # row (up to the float32 rounding of p - step)
        step = params[k][[2, 5]] - t_params[k][[2, 5]].numpy()
        np.testing.assert_allclose(step, lrs[k] * np.sign(grads[k][[2, 5]]), rtol=1e-4,
                                   atol=1e-6)


def test_adam_init_and_registry_wrapper():
    params, grads, _, lrs = _adam_inputs(1)
    t = lambda d: {k: torch.tensor(v) for k, v in d.items()}
    opt = t_optimizers.make({"name": "general",
                             "params": {k: {"lr": v} for k, v in lrs.items()}})
    state = opt.init(t(params))
    assert all(int(c.abs().sum()) == 0 and c.dtype == torch.int32 for c in state.count.values())
    new_params, new_state = opt.update(t(grads), state, t(params))
    want, _ = t_opt.adam_update(t(grads), t_opt.adam_init(t(params)), t(params), lrs, eps=1e-15)
    for k in params:
        torch.testing.assert_close(new_params[k], want[k], rtol=0, atol=0)
        assert int(new_state.count[k].min()) == 1


@pytest.mark.parametrize("step", [0, 1, 777, 15000, 29999, 30000, 45000])
def test_exp_lr_schedule_matches_jax(step):
    t_sched = t_opt.exp_lr_schedule(1.6e-4, 1.6e-6, 30000)
    j_sched = j_opt.exp_lr_schedule(1.6e-4, 1.6e-6, 30000)
    np.testing.assert_allclose(t_sched(step), float(j_sched(jnp.asarray(step, jnp.int32))),
                               rtol=1e-6)
