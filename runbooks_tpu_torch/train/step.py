"""Train state and train step (the port of ``runbooks_tpu.train.step`` on
one device: no mesh, shardings or pipeline schedule).

A step is forward, backward and the optimizer over the whole global batch,
optionally in k microbatches whose gradients sum into an f32 accumulator,
each microbatch's loss scaled by the global 1 / total weight so the sum is
exactly the full-batch loss and gradient. A non-finite loss or gradient
norm skips the update: params and optimizer state stay bitwise as they were
and the step counter still advances.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, Optional, Tuple

import torch
from torch.utils.checkpoint import checkpoint

from runbooks_tpu_torch.models.config import ModelConfig
from runbooks_tpu_torch.models.transformer import forward, lm_head
from runbooks_tpu_torch.train.optimizer import AdamW, global_norm
from runbooks_tpu_torch.utils.tree import tree_leaves, tree_map

Batch = Dict[str, torch.Tensor]


@dataclasses.dataclass
class TrainState:
    step: int
    params: Any
    opt_state: Any


def cross_entropy_loss(logits: torch.Tensor, targets: torch.Tensor,
                       weights: Optional[torch.Tensor] = None
                       ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(mean loss over weighted tokens, total weight) from [b, s, v] f32
    logits: the reference loss, over fully materialized logits."""
    logp = torch.log_softmax(logits.float(), dim=-1)
    nll = -torch.gather(logp, -1, targets[..., None].long())[..., 0]
    if weights is None:
        weights = torch.ones_like(nll)
    weights = weights.float()
    total = torch.clamp(weights.sum(), min=1.0)
    return (nll * weights).sum() / total, total


def chunked_cross_entropy(acts: torch.Tensor, head: torch.Tensor,
                          targets: torch.Tensor,
                          weights: Optional[torch.Tensor] = None,
                          chunk_size: int = 256,
                          compute_dtype: torch.dtype = torch.bfloat16
                          ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(mean loss, total weight) equal to ``cross_entropy_loss(acts @
    head)`` without the [b, s, v] f32 logits: the sequence goes in chunks
    of ``chunk_size`` tokens, each chunk's logits formed from
    compute_dtype operands (f32 products, as ``lm_head``), reduced to its
    weighted NLL sum, and re-formed in the backward (one checkpoint per
    chunk)."""
    b, s, _ = acts.shape
    if weights is None:
        weights = torch.ones((b, s), dtype=torch.float32, device=acts.device)
    weights = weights.float()
    total = torch.clamp(weights.sum(), min=1.0)
    head_c = head.to(compute_dtype)

    def chunk_nll(a_c, t_c, w_c):
        logits = torch.matmul(a_c.to(compute_dtype).float(), head_c.float())
        lse = torch.logsumexp(logits, dim=-1)
        tgt = torch.gather(logits, -1, t_c[..., None].long())[..., 0]
        return ((lse - tgt) * w_c).sum()

    c = max(1, min(int(chunk_size), s))
    nll_sum = torch.zeros((), dtype=torch.float32, device=acts.device)
    for i in range(0, s, c):
        nll_sum = nll_sum + checkpoint(
            chunk_nll, acts[:, i:i + c], targets[:, i:i + c],
            weights[:, i:i + c], use_reentrant=False)
    return nll_sum / total, total


def make_ce_terms(cfg: ModelConfig, remat: bool, loss_chunk: int):
    """(params, batch, lora=None) -> (mean CE loss, total weight).
    loss_chunk > 0 takes the chunked loss over the post-norm activations;
    0 the full logits and ``cross_entropy_loss``."""

    def ce_terms(params, batch: Batch, lora=None):
        out, _ = forward(cfg, params, batch["tokens"],
                         positions=batch.get("positions"),
                         segment_ids=batch.get("segment_ids"), remat=remat,
                         return_activations=True, lora=lora)
        if loss_chunk:
            return chunked_cross_entropy(
                out, params["head"], batch["targets"],
                batch.get("loss_mask"), chunk_size=loss_chunk,
                compute_dtype=cfg.activation_dtype)
        return cross_entropy_loss(lm_head(cfg, params, out),
                                  batch["targets"], batch.get("loss_mask"))

    return ce_terms


def value_and_grad(loss_fn: Callable[[Any, Batch], Tuple[torch.Tensor,
                                                          torch.Tensor]],
                   trainable: Any, batch: Batch, k: int = 1):
    """((loss, total weight), grads) of ``loss_fn(trainable, batch)`` over
    k microbatches of the batch's leading axis. Each microbatch's mean loss
    is rescaled to its share of the global mean (loss * its weight / total
    weight of the whole batch), and its gradients sum into an f32
    accumulator, cast back to each leaf's dtype at the end."""
    b = batch["tokens"].shape[0]
    if b % k:
        raise ValueError(f"accumulate_steps={k} must divide batch size {b}")
    lm = batch.get("loss_mask")
    full_w = (lm.float().sum() if lm is not None else torch.tensor(
        float(b * batch["tokens"].shape[1]), device=batch["tokens"].device))
    total_weight = torch.clamp(full_w, min=1.0)
    leaves = list(tree_leaves(trainable))
    acc = [torch.zeros_like(t, dtype=torch.float32) for t in leaves]
    loss_sum = torch.zeros((), dtype=torch.float32,
                           device=batch["tokens"].device)
    m = b // k
    for i in range(k):
        micro = {key: val[i * m:(i + 1) * m] for key, val in batch.items()}
        loss, total = loss_fn(trainable, micro)
        if k > 1:
            loss = loss * total / total_weight
        grads = torch.autograd.grad(loss, leaves)
        for a, g in zip(acc, grads):
            a.add_(g.float())
        loss_sum = loss_sum + loss.detach()
    it = iter(a.to(t.dtype) for a, t in zip(acc, leaves))
    grads = tree_map(lambda _: next(it), trainable)
    return (loss_sum, total_weight if k > 1 else total.detach()), grads


def trainable_copy(tree: Any) -> Any:
    """The leaves as new autograd leaves that share their storage, for
    one step's gradients."""
    return tree_map(lambda p: p.detach().requires_grad_(True), tree)


def apply_step(optimizer: AdamW, state: TrainState, loss: torch.Tensor,
               total_weight: torch.Tensor, grads: Any
               ) -> Tuple[TrainState, Dict[str, torch.Tensor]]:
    """The optimizer update behind the non-finite guard: when the loss or
    the gradient norm is not finite the old params and optimizer state are
    kept as they are (bitwise) and the step still advances."""
    with torch.no_grad():
        grad_norm = global_norm(grads)
        ok = bool(torch.isfinite(loss) & torch.isfinite(grad_norm))
        params, opt_state = state.params, state.opt_state
        if ok:
            params, opt_state = optimizer.update(grads, opt_state, params)
    metrics = {"loss": loss, "grad_norm": grad_norm,
               "weight_tokens": total_weight, "nonfinite": int(not ok)}
    return TrainState(step=state.step + 1, params=params,
                      opt_state=opt_state), metrics


def create_train_state(params: Any, optimizer: AdamW) -> TrainState:
    return TrainState(step=0, params=params, opt_state=optimizer.init(params))


def make_train_step(cfg: ModelConfig, optimizer: AdamW, remat: bool = True,
                    accumulate_steps: int = 1, loss_chunk: int = 0):
    """(state, batch) -> (state, metrics) for full fine-tuning. Batch keys:
    tokens and targets [b, s], optional loss_mask, segment_ids and
    positions [b, s], tensors on the params' device. Metrics: loss,
    grad_norm, weight_tokens, nonfinite (0 or 1)."""
    k = int(accumulate_steps)
    if k < 1:
        raise ValueError(f"accumulate_steps must be >= 1, got {k}")
    ce_terms = make_ce_terms(cfg, remat, int(loss_chunk))

    def step_fn(state: TrainState, batch: Batch):
        (loss, total), grads = value_and_grad(
            ce_terms, trainable_copy(state.params), batch, k)
        return apply_step(optimizer, state, loss, total, grads)

    return step_fn
