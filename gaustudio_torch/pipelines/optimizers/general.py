"""General optimizer: per-attribute Adam with per-row step counts
(port of gaustudio_tpu/pipelines/optimizers/general.py).

A functional Adam over plain ``{name: tensor}`` dicts rather than
``torch.optim.Adam``, whose step count is one per tensor: densification
clones, splits and prunes rows, and each new or changed row must restart
its bias correction on its own. Moments and counts are plain tensors that
the trainer gathers, concatenates and zeroes row by row. eps is 1e-15, and
there is no weight decay (the canonical 3DGS recipe).
"""

from __future__ import annotations

from typing import Callable, Dict, NamedTuple

import torch

from gaustudio_torch.pipelines import optimizers


class AdamState(NamedTuple):
    mu: Dict[str, torch.Tensor]
    nu: Dict[str, torch.Tensor]
    # per-row, per-attribute step counts {name: [rows] int32}. Row surgery
    # zeroes a row's moments and its count, so its bias correction restarts;
    # with one count for the whole tensor, fresh rows would step at
    # (1 - b1^k) / sqrt(1 - b2^k), 3-6.5x the intended lr, for ~100 steps.
    count: Dict[str, torch.Tensor]


def adam_init(params: Dict[str, torch.Tensor]) -> AdamState:
    return AdamState(
        mu={k: torch.zeros_like(v) for k, v in params.items()},
        nu={k: torch.zeros_like(v) for k, v in params.items()},
        count={k: torch.zeros(v.shape[0], dtype=torch.int32, device=v.device)
               for k, v in params.items()},
    )


def adam_update(grads: Dict[str, torch.Tensor], state: AdamState,
                params: Dict[str, torch.Tensor], lrs: Dict[str, float], *,
                b1: float = 0.9, b2: float = 0.999, eps: float = 1e-15):
    """One Adam step with per-attribute learning rates -> (params, state)."""
    new_params, new_mu, new_nu, new_count = {}, {}, {}, {}
    for k, p in params.items():
        g = grads[k]
        mu = b1 * state.mu[k] + (1 - b1) * g
        nu = b2 * state.nu[k] + (1 - b2) * g * g
        cnt = state.count[k] + 1
        cf = cnt.to(torch.float32).reshape((-1,) + (1,) * (p.dim() - 1))
        c1 = torch.clamp_min(1.0 - b1 ** cf, 1e-8)
        c2 = torch.clamp_min(1.0 - b2 ** cf, 1e-8)
        update = lrs.get(k, 0.0) * (mu / c1) / (torch.sqrt(nu / c2) + eps)
        new_params[k] = p - update
        new_mu[k] = mu
        new_nu[k] = nu
        new_count[k] = cnt
    return new_params, AdamState(mu=new_mu, nu=new_nu, count=new_count)


def exp_lr_schedule(lr_init: float, lr_final: float, max_steps: int) -> Callable[[int], float]:
    """Inria's log-linear learning-rate decay, evaluated in float32."""
    log_init = torch.log(torch.tensor(max(lr_init, 1e-12), dtype=torch.float32))
    log_final = torch.log(torch.tensor(max(lr_final, 1e-12), dtype=torch.float32))

    def schedule(step: int) -> float:
        t = torch.clamp(torch.tensor(step, dtype=torch.float32) / max_steps, 0.0, 1.0)
        return float(torch.exp((1 - t) * log_init + t * log_final))

    return schedule


@optimizers.register("general")
class GeneralOptimizer:
    """Registry-facing wrapper with the reference's config shape: a
    per-attribute lr dict plus optimizer args (eps)."""

    default_conf = {
        "optimizer_name": "adam",
        "args": {"lr": 0.0, "eps": 1e-15},
        "params": {},
    }

    def __init__(self, config=None):
        self.config = {**self.default_conf, **(config or {})}
        self.eps = float(self.config.get("args", {}).get("eps", 1e-15))
        self.lrs = {k: float(v.get("lr", 0.0))
                    for k, v in self.config.get("params", {}).items()}
        self.state = None
        self._params = None

    def init(self, params) -> AdamState:
        self.state = adam_init(params)
        return self.state

    def update(self, grads, state, params, lr_overrides=None):
        lrs = {**self.lrs, **(lr_overrides or {})}
        return adam_update(grads, state, params, lrs, eps=self.eps)

    # the reference's torch-style API: the optimizer holds the parameters
    def setup(self, params):
        self._params = dict(params)
        self.init(self._params)

    def step(self, grads):
        """One ``update`` of the held parameters; returns them."""
        self._params, self.state = self.update(grads, self.state, self._params)
        return self._params

    def zero_grad(self):
        """Nothing to clear: gradients are arguments of ``step``."""
