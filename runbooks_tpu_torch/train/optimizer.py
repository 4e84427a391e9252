"""AdamW with linear warmup, cosine/linear decay and global-norm clipping,
as plain tensor arithmetic that matches the reference's optax chain
(``runbooks_tpu.train.optimizer``: ``clip_by_global_norm`` then
``adamw``), not ``torch.optim``:

- the schedule's count starts at 0, so the first warmup step has lr 0;
- clipping scales by ``max_norm / norm`` only when ``norm >= max_norm``,
  with no epsilon;
- ``update = mu_hat / (sqrt(nu_hat) + eps)`` with bias correction, then
  ``+ weight_decay * param``, then ``* -lr``;
- ``mu_dtype`` stores the first moment in that dtype (the update uses the
  unrounded value, as optax does).

Params and gradients are nested dicts of tensors. The optimizer is
functional: ``update`` returns new parameters and a new state and writes
nothing in place, so a caller can keep the old ones (the train step's
non-finite guard does).
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Dict, Optional, Tuple

import torch

from runbooks_tpu_torch.models.config import torch_dtype
from runbooks_tpu_torch.utils.tree import tree_leaves, tree_map

Tree = Any


@dataclasses.dataclass(frozen=True)
class OptimizerConfig:
    learning_rate: float = 2e-5
    warmup_steps: int = 100
    total_steps: int = 1000
    schedule: str = "cosine"          # "cosine" | "linear" | "constant"
    min_lr_ratio: float = 0.1
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.0
    grad_clip_norm: Optional[float] = 1.0
    mu_dtype: Optional[str] = None


def global_norm(tree: Tree) -> torch.Tensor:
    """sqrt of the sum of squares of every leaf, in f32."""
    return torch.sqrt(sum(torch.sum(t.float() ** 2)
                          for t in tree_leaves(tree)))


def _f32(x) -> torch.Tensor:
    return torch.tensor(x, dtype=torch.float32)


def _linear(count: torch.Tensor, init: float, end: float,
            steps: int) -> torch.Tensor:
    # optax.linear_schedule: count clipped to [0, steps].
    c = torch.clamp(count, 0, steps).float()
    frac = 1 - c / steps
    return _f32(init - end) * frac + _f32(end)


def learning_rate(cfg: OptimizerConfig, count: int) -> torch.Tensor:
    """The schedule at ``count`` (f32), as ``make_schedule`` joins it:
    linear warmup from 0 over warmup_steps, then the decay from
    warmup_steps on."""
    count_t = torch.tensor(count, dtype=torch.int32)
    if count < cfg.warmup_steps:
        return _linear(count_t, 0.0, cfg.learning_rate,
                       max(cfg.warmup_steps, 1))
    t = count_t - cfg.warmup_steps
    decay_steps = max(cfg.total_steps - cfg.warmup_steps, 1)
    if cfg.schedule == "cosine":
        c = torch.minimum(t.float(), _f32(float(decay_steps)))
        cos = 0.5 * (1 + torch.cos(_f32(math.pi) * c / decay_steps))
        return _f32(cfg.learning_rate) * (
            (1 - cfg.min_lr_ratio) * cos + cfg.min_lr_ratio)
    if cfg.schedule == "linear":
        return _linear(t, cfg.learning_rate,
                       cfg.learning_rate * cfg.min_lr_ratio, decay_steps)
    return _f32(cfg.learning_rate)


class AdamW:
    """The optimizer of ``make_optimizer``. State: {"count": adam steps
    taken, "mu", "nu": trees like the params}; the schedule's count is the
    same number (optax keeps two counts that advance together)."""

    def __init__(self, cfg: OptimizerConfig):
        if cfg.schedule not in ("cosine", "linear", "constant"):
            raise ValueError(f"unknown schedule {cfg.schedule!r}; expected "
                             "cosine|linear|constant")
        self.cfg = cfg
        self.mu_dtype = (torch_dtype(cfg.mu_dtype) if cfg.mu_dtype
                         else None)

    def init(self, params: Tree) -> Dict[str, Any]:
        return {
            "count": 0,
            "mu": tree_map(lambda p: torch.zeros_like(
                p, dtype=self.mu_dtype or p.dtype), params),
            "nu": tree_map(torch.zeros_like, params),
        }

    def update(self, grads: Tree, state: Dict[str, Any], params: Tree
               ) -> Tuple[Tree, Dict[str, Any]]:
        """(new params, new state) for gradients ``grads``."""
        cfg = self.cfg
        if cfg.grad_clip_norm is not None:
            norm = global_norm(grads)
            clip = norm >= cfg.grad_clip_norm
            grads = tree_map(lambda g: torch.where(
                clip, g / norm.to(g.dtype) * cfg.grad_clip_norm, g), grads)
        count = state["count"] + 1
        bc1 = 1 - _f32(cfg.b1) ** count
        bc2 = 1 - _f32(cfg.b2) ** count
        lr = learning_rate(cfg, state["count"])

        def step(p, g, mu, nu):
            # (1 - b1) g + b1 mu, with b1 rounded to mu's dtype and b1 mu
            # computed in it, as optax's weakly typed scalar is.
            mu = (1 - cfg.b1) * g + torch.tensor(cfg.b1, dtype=mu.dtype) * mu
            nu = (1 - cfg.b2) * g * g + cfg.b2 * nu
            mu_hat = mu / bc1.to(mu.dtype)
            nu_hat = nu / bc2.to(nu.dtype)
            u = mu_hat / (torch.sqrt(nu_hat) + cfg.eps)
            u = u + cfg.weight_decay * p
            u = (-lr).to(u.dtype) * u
            return ((p + u).to(p.dtype),
                    mu.to(self.mu_dtype) if self.mu_dtype else mu, nu)

        out = tree_map(step, params, grads, state["mu"], state["nu"])
        new_params = tree_map(lambda o: o[0], out)
        new_mu = tree_map(lambda o: o[1], out)
        new_nu = tree_map(lambda o: o[2], out)
        return new_params, {"count": count, "mu": new_mu, "nu": new_nu}


def make_optimizer(cfg: OptimizerConfig) -> AdamW:
    return AdamW(cfg)
