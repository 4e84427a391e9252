"""LoRA fine-tuning (the port of ``runbooks_tpu.train.lora``).

For each target matrix W [L, in, out] the adapter learns A [L, in, r] and
B [L, r, out]; the effective weight is W + (alpha / r) A @ B, merged in f32
and cast back to W's dtype. Training merges inside each layer's block
(``models.transformer.LoraDeltas``), so gradients reach only A and B, the
base stays frozen, and no merged copy of all layers outlives its block.
``merge`` folds the deltas into the base for serving or export.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, Optional, Sequence

import torch

from runbooks_tpu_torch.models.config import ModelConfig
from runbooks_tpu_torch.models.transformer import LoraDeltas
from runbooks_tpu_torch.train.optimizer import AdamW
from runbooks_tpu_torch.train.step import (
    TrainState,
    apply_step,
    make_ce_terms,
    moe_aux_coef,
    trainable_copy,
    value_and_grad,
)
from runbooks_tpu_torch.utils.tree import tree_leaves

Params = Any

# Matrices eligible for LoRA, by their path inside params["layers"]
# ("mlp.wi" is the plain MLP's input matrix; "wi_gate"/"wi_up" the gated
# one's). Targets a model lacks are skipped: an MoE model has no "mlp"
# group (its experts are "moe"), so only its attention takes adapters, as
# in the reference.
DEFAULT_TARGETS = ("attn.wq", "attn.wk", "attn.wv", "attn.wo")
ALL_TARGETS = DEFAULT_TARGETS + ("mlp.wi_gate", "mlp.wi_up", "mlp.wi",
                                 "mlp.wo")


@dataclasses.dataclass(frozen=True)
class LoraConfig:
    rank: int = 8
    alpha: float = 16.0
    targets: Sequence[str] = DEFAULT_TARGETS

    @property
    def scale(self) -> float:
        return self.alpha / self.rank


def _get(tree: Params, dotted: str):
    node = tree
    for part in dotted.split("."):
        if part not in node:
            return None
        node = node[part]
    return node


def init_lora(params: Params, cfg: LoraConfig,
              generator: Optional[torch.Generator],
              device: Optional[torch.device] = None,
              cut: Optional[Callable[[torch.Tensor, tuple],
                                     torch.Tensor]] = None) -> Params:
    """{target: {"a": [L, in, r], "b": [L, r, out]}} on ``device`` (default:
    the base's): A ~ N(0, 1/in), B = 0, so the delta starts at zero.
    ``params`` gives the base's full shapes (it may live on the meta
    device). ``cut(leaf, logical_axes)`` (an FSDP rank's
    parallel/sharding.FsdpPlan.cut_by_axes) is applied to each factor as
    it is drawn; the draws are the same with it or without it."""
    lora: Dict[str, Dict[str, torch.Tensor]] = {}
    for target in cfg.targets:
        w = _get(params["layers"], target)
        if w is None:
            continue
        L, d_in, d_out = w.shape
        dev = w.device if device is None else device
        a = torch.randn((L, d_in, cfg.rank), generator=generator,
                        device=dev, dtype=torch.float32) * d_in ** -0.5
        lora[target] = {
            "a": a.to(w.dtype),
            "b": torch.zeros((L, cfg.rank, d_out), dtype=w.dtype,
                             device=dev),
        }
        if cut is not None:
            axes = _factor_axes(target)
            lora[target] = {k: cut(f, axes[k])
                            for k, f in lora[target].items()}
    if not lora:
        raise ValueError(f"no LoRA targets matched: {cfg.targets}")
    return lora


# The (in, out) logical axes of each target's base matrix.
_BASE_AXES = {
    "attn.wq": ("embed", "heads"), "attn.wk": ("embed", "kv_heads"),
    "attn.wv": ("embed", "kv_heads"), "attn.wo": ("heads", "embed"),
    "mlp.wi_gate": ("embed", "mlp"), "mlp.wi_up": ("embed", "mlp"),
    "mlp.wi": ("embed", "mlp"), "mlp.wo": ("mlp", "embed"),
}


def _factor_axes(target: str) -> Dict[str, tuple]:
    in_ax, out_ax = _BASE_AXES.get(target, (None, None))
    return {"a": (None, in_ax, None), "b": (None, None, out_ax)}


def lora_logical_axes(cfg: LoraConfig, params: Params) -> Params:
    """Logical axes of a LoRA tree (the reference's): the layer and rank
    axes replicated, A's input and B's output axis those of the base
    matrix (so under FSDP a target whose base shards "embed" shards it
    too)."""
    return {target: _factor_axes(target) for target in params}


def deltas(lora: Params, cfg: LoraConfig) -> LoraDeltas:
    return LoraDeltas(lora, cfg.scale)


def apply_lora(params: Params, lora: Params, cfg: LoraConfig) -> Params:
    """Base params with every layer's deltas folded in (new tensors)."""
    d = deltas(lora, cfg)
    layers = {}
    for group, mats in params["layers"].items():
        layers[group] = {}
        for name, w in mats.items():
            path = f"{group}.{name}"
            layers[group][name] = (
                torch.stack([d.weight(path, w, li)
                             for li in range(w.shape[0])])
                if path in lora else w)
    return {**params, "layers": layers}


merge = apply_lora


def trainable_param_count(lora: Params) -> int:
    return sum(t.numel() for t in tree_leaves(lora))


def create_lora_train_state(lora_cfg: LoraConfig, base_params: Params,
                            optimizer: AdamW,
                            generator: torch.Generator,
                            device: Optional[torch.device] = None,
                            cut=None) -> TrainState:
    """TrainState whose params are the LoRA tree only (``device`` and
    ``cut`` as ``init_lora``'s: an FSDP rank passes the base's full shapes
    and keeps its pieces)."""
    lora = init_lora(base_params, lora_cfg, generator, device=device,
                     cut=cut)
    return TrainState(step=0, params=lora, opt_state=optimizer.init(lora))


def make_lora_train_step(model_cfg: ModelConfig, lora_cfg: LoraConfig,
                         optimizer: AdamW, remat: bool = True,
                         accumulate_steps: int = 1, loss_chunk: int = 0,
                         fsdp=None):
    """(state, base_params, batch) -> (state, metrics); gradients reach
    only the LoRA tree. accumulate_steps, loss_chunk and fsdp as in
    ``make_train_step`` (the base, too, holds the rank's pieces; it is
    gathered without gradient traffic). An MoE model's objective is full
    fine-tuning's, the load-balance term included (the reference's: it
    keeps the routing balanced while adapting; its gradient reaches the
    adapters through the router's inputs)."""
    k = int(accumulate_steps)
    if k < 1:
        raise ValueError(f"accumulate_steps must be >= 1, got {k}")
    ce_terms = make_ce_terms(model_cfg, remat, int(loss_chunk), fsdp)
    coef = moe_aux_coef(model_cfg)

    def step_fn(state: TrainState, base_params: Params, batch):
        def loss_fn(lora, micro):
            return ce_terms(base_params, micro, deltas(lora, lora_cfg))

        (loss, total), grads = value_and_grad(
            loss_fn, trainable_copy(state.params), batch, k, fsdp, coef)
        return apply_step(optimizer, state, loss, total, grads, fsdp)

    return step_fn
