"""Train state and train step (the port of ``runbooks_tpu.train.step``:
one device, or data x fsdp ranks; no pipeline schedule).

A step is forward, backward and the optimizer over the whole global batch,
optionally in k microbatches whose gradients sum into an f32 accumulator,
each microbatch's loss scaled by the global 1 / total weight so the sum is
exactly the full-batch loss and gradient. A non-finite loss or gradient
norm skips the update: params and optimizer state stay bitwise as they were
and the step counter still advances.

Over a data x fsdp mesh (``fsdp=``, a parallel/sharding.Fsdp) each rank
holds its pieces of the params and of the optimizer state
(``infer_state_shardings``) and its rows of the batch (``shard_batch``,
as ``batch_shardings`` splits them). The loss is the global one: each
rank's weighted NLL sum over the global total weight (both sums
all-reduced), so ranks that hold different counts of loss-masked tokens
weigh them right; gradients of sharded leaves come back reduce-scattered
from the forward's gathers and are summed over the data ranks, those of
replicated leaves over every rank; the gradient norm counts each element
once. Every rank therefore takes the one-process step, up to the order of
its f32 sums, and skips a non-finite step together with the others. An
MoE model's microbatch routes over every rank's rows (models/moe.py), as
the reference's does.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, Optional, Tuple

import numpy as np
import torch
from torch.utils.checkpoint import checkpoint

from runbooks_tpu_torch.models.config import ModelConfig
from runbooks_tpu_torch.models.transformer import (
    forward,
    head_weight,
    lm_head,
)
from runbooks_tpu_torch.obs import device as obs_device
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


def moe_aux_coef(cfg: ModelConfig) -> float:
    """The weight of the router's load-balance loss in the objective:
    ``cfg.moe_aux_coef`` for an MoE config, 0 (no term) for a dense one."""
    return float(cfg.moe_aux_coef) if cfg.moe_num_experts else 0.0


def make_ce_terms(cfg: ModelConfig, remat: bool, loss_chunk: int,
                  fsdp=None):
    """(params, batch, lora=None) -> (mean CE loss, total weight, MoE aux),
    as the reference's: aux is the layers' summed load-balance loss (0
    for a dense model), which the train steps weigh by ``moe_aux_coef``.
    loss_chunk > 0 takes the chunked loss over the post-norm activations;
    0 the full logits and ``cross_entropy_loss``. A tied head is
    ``embed.T`` (its gradient reaches the embedding), as the
    reference's. Under ``fsdp`` the params are the rank's pieces: the
    leaves outside the layers are gathered here (``Fsdp.outer``), the
    layers' inside the forward's blocks."""

    def ce_terms(params, batch: Batch, lora=None):
        if fsdp is not None:
            params = fsdp.outer(params)
        out, _, aux = forward(cfg, params, batch["tokens"],
                              positions=batch.get("positions"),
                              segment_ids=batch.get("segment_ids"),
                              remat=remat, with_aux=True,
                              return_activations=True, lora=lora, fsdp=fsdp)
        if loss_chunk:
            loss, total = chunked_cross_entropy(
                out, head_weight(cfg, params), batch["targets"],
                batch.get("loss_mask"), chunk_size=loss_chunk,
                compute_dtype=cfg.activation_dtype)
        else:
            loss, total = cross_entropy_loss(
                lm_head(cfg, params, out), batch["targets"],
                batch.get("loss_mask"))
        return loss, total, aux

    return ce_terms


def value_and_grad(loss_fn: Callable[[Any, Batch],
                                     Tuple[torch.Tensor, torch.Tensor,
                                           torch.Tensor]],
                   trainable: Any, batch: Batch, k: int = 1, fsdp=None,
                   aux_coef: float = 0.0):
    """((loss, total weight), grads) of ``loss_fn(trainable, batch)``
    (make_ce_terms' triple) over k microbatches of the batch's leading
    axis. Each microbatch's mean loss is rescaled to its share of the
    global mean (loss * its weight / total weight of the whole batch),
    and then, as the reference's objective, ``aux_coef * aux / k`` is
    added: each microbatch routes its own tokens and the aux term is
    their mean (with one microbatch and no FSDP, ``loss + aux_coef *
    aux``). The gradients sum into an f32 accumulator, cast back to each
    leaf's dtype at the end; the loss returned includes the aux term.
    Under ``fsdp`` the batch is the rank's rows (``shard_batch``): the
    total weight and the loss are summed over every rank, and the
    gradients as ``Fsdp.reduce_grads`` says. Each microbatch then routes
    over the global microbatch, as the reference's sharded step does (it
    accumulates global microbatches), and each rank's ``aux`` is its
    share of the global aux (models/moe.route): the sums over the ranks
    count the aux term once, in the loss and in the gradients."""
    b = batch["tokens"].shape[0]
    if b % k:
        raise ValueError(f"accumulate_steps={k} must divide batch size {b}")
    lm = batch.get("loss_mask")
    full_w = (lm.float().sum() if lm is not None else torch.tensor(
        float(b * batch["tokens"].shape[1]), device=batch["tokens"].device))
    if fsdp is not None:
        full_w = fsdp.all_reduce(full_w.reshape(1))[0]
    total_weight = torch.clamp(full_w, min=1.0)
    leaves = list(tree_leaves(trainable))
    acc = [torch.zeros_like(t, dtype=torch.float32) for t in leaves]
    loss_sum = torch.zeros((), dtype=torch.float32,
                           device=batch["tokens"].device)
    rescale = k > 1 or fsdp is not None
    m = b // k
    for i in range(k):
        micro = {key: val[i * m:(i + 1) * m] for key, val in batch.items()}
        loss, total, aux = loss_fn(trainable, micro)
        if rescale:
            loss = loss * total / total_weight
        if aux_coef:
            loss = loss + aux_coef * aux / k
        grads = torch.autograd.grad(loss, leaves)
        for a, g in zip(acc, grads):
            a.add_(g.float())
        loss_sum = loss_sum + loss.detach()
    if fsdp is not None:
        loss_sum = fsdp.all_reduce(loss_sum.reshape(1))[0]
        fsdp.reduce_grads(acc)
    it = iter(a.to(t.dtype) for a, t in zip(acc, leaves))
    grads = tree_map(lambda _: next(it), trainable)
    return (loss_sum, total_weight if rescale else total.detach()), grads


def trainable_copy(tree: Any) -> Any:
    """The leaves as new autograd leaves that share their storage, for
    one step's gradients."""
    return tree_map(lambda p: p.detach().requires_grad_(True), tree)


def apply_step(optimizer: AdamW, state: TrainState, loss: torch.Tensor,
               total_weight: torch.Tensor, grads: Any, fsdp=None
               ) -> Tuple[TrainState, Dict[str, torch.Tensor]]:
    """The optimizer update behind the non-finite guard: when the loss or
    the gradient norm is not finite the old params and optimizer state are
    kept as they are (bitwise) and the step still advances. Under ``fsdp``
    the norm is the global one (``Fsdp.global_norm``), which clipping
    uses too, and the loss is already global: every rank decides alike."""
    with torch.no_grad():
        grad_norm = (global_norm(grads) if fsdp is None
                     else fsdp.global_norm(grads))
        ok = bool(torch.isfinite(loss) & torch.isfinite(grad_norm))
        params, opt_state = state.params, state.opt_state
        if ok:
            params, opt_state = optimizer.update(grads, opt_state, params,
                                                 grad_norm=grad_norm)
    metrics = {"loss": loss, "grad_norm": grad_norm,
               "weight_tokens": total_weight, "nonfinite": int(not ok)}
    return TrainState(step=state.step + 1, params=params,
                      opt_state=opt_state), metrics


def first_step(step_fn, state: TrainState, batch: Batch, shape_sig: str,
               component: str = "train", name: str = "train_step"):
    """``step_fn(state, batch)`` for a run's first step: its kernel builds
    are the expected ones (obs/device.SENTINEL), and it is the step
    program's first dispatch at this shape, so it runs under the counting
    mode that records the program's FLOPs (the backward's attention
    included: K2 and K3 are operators with flop formulas) and bytes
    (obs/device.program_cost). Returns (state, metrics, cost or None)."""
    with obs_device.SENTINEL.expected():
        state, metrics = obs_device.program_cost(
            component, name, shape_sig, step_fn, state, batch)
    census = obs_device.PROGRAMS.census(component)
    costs = next((e["costs"] for e in census if e["name"] == name), {})
    return state, metrics, costs.get(shape_sig)


def create_train_state(params: Any, optimizer: AdamW) -> TrainState:
    return TrainState(step=0, params=params, opt_state=optimizer.init(params))


def make_train_step(cfg: ModelConfig, optimizer: AdamW, remat: bool = True,
                    accumulate_steps: int = 1, loss_chunk: int = 0,
                    fsdp=None):
    """(state, batch) -> (state, metrics) for full fine-tuning. Batch keys:
    tokens and targets [b, s], optional loss_mask, segment_ids and
    positions [b, s], tensors on the params' device. Metrics: loss (with
    an MoE config's ``moe_aux_coef`` x aux term, as the reference's),
    grad_norm, weight_tokens, nonfinite (0 or 1). Under ``fsdp`` (a
    parallel/sharding.Fsdp) the state holds the rank's pieces and the
    batch its rows (``shard_batch``); the metrics are the global ones."""
    k = int(accumulate_steps)
    if k < 1:
        raise ValueError(f"accumulate_steps must be >= 1, got {k}")
    ce_terms = make_ce_terms(cfg, remat, int(loss_chunk), fsdp)
    coef = moe_aux_coef(cfg)

    def step_fn(state: TrainState, batch: Batch):
        (loss, total), grads = value_and_grad(
            ce_terms, trainable_copy(state.params), batch, k, fsdp, coef)
        return apply_step(optimizer, state, loss, total, grads, fsdp)

    return step_fn


# ---------------------------------------------------------------------------
# Shardings over a data x fsdp mesh (the reference's, as pure specs)
# ---------------------------------------------------------------------------

def infer_state_shardings(axes: Any, state: TrainState, mesh
                          ) -> Dict[str, Any]:
    """Specs (parallel/sharding.spec_for_array) for a whole TrainState
    given the params' logical-axes tree, as the reference's: each state
    leaf takes the axes of the params leaf whose key path is the longest
    suffix of its own (AdamW's mu and nu those of their parameter), the
    others (the step, the count) replicate. Returns {"step", "params",
    "opt_state"} like the state."""
    from runbooks_tpu_torch.parallel.sharding import _is_axes, spec_for_array

    flat: Dict[Tuple[str, ...], tuple] = {}

    def record(tree, path):
        if isinstance(tree, dict):
            for k in tree:
                record(tree[k], path + (k,))
        elif _is_axes(tree):
            flat[path] = tree

    record(axes, ())

    def assign(tree, path):
        if isinstance(tree, dict):
            return {k: assign(tree[k], path + (k,)) for k in tree}
        shape = tuple(getattr(tree, "shape", ()))
        for i in range(len(path) + 1):
            logical = flat.get(path[i:])
            if logical is not None and len(logical) <= len(shape):
                return spec_for_array(shape, logical, mesh)
        return ()

    return assign({"step": state.step, "params": state.params,
                   "opt_state": state.opt_state}, ())


def batch_shardings(mesh, batch_shapes: Any) -> Any:
    """The batch's specs, as the reference's: ("batch", "seq") for [b, s]
    leaves, ("batch",) for [b]; "batch" maps to ("data", "fsdp") and
    degrades (trailing axes dropped) where their product does not divide
    the rows."""
    from runbooks_tpu_torch.parallel.sharding import spec_for_array

    def one(x):
        logical = ("batch", "seq") if len(x.shape) == 2 else ("batch",)
        return spec_for_array(x.shape, logical, mesh)

    return tree_map(one, batch_shapes)


def fsdp_plan(cfg: ModelConfig, mesh, lora_cfg=None):
    """The parallel/sharding.FsdpPlan of ``cfg`` (and of its LoRA tree
    under ``lora_cfg``) over ``mesh`` (a resolved MeshConfig, a DeviceMesh
    or a mapping): each leaf's dimension over ``fsdp`` in the spec that
    ``infer_state_shardings`` gives it (None where fsdp does not divide
    the dimension), as the reference shards its train state."""
    from runbooks_tpu_torch.models.transformer import (
        init_params,
        param_logical_axes,
    )
    from runbooks_tpu_torch.parallel.sharding import (
        FsdpPlan,
        fsdp_dim,
        mesh_shape,
    )
    from runbooks_tpu_torch.train.lora import init_lora, lora_logical_axes

    sizes = {a: int(n) for a, n in mesh_shape(mesh).items()}

    def dims(axes, shapes):
        specs = infer_state_shardings(axes, TrainState(0, shapes, None),
                                      sizes)["params"]
        return tree_map(fsdp_dim, specs)

    meta = torch.device("meta")
    shapes = init_params(cfg, None, meta)
    lora = None
    if lora_cfg is not None:
        lshapes = init_lora(shapes, lora_cfg, None, device=meta)
        lora = dims(lora_logical_axes(lora_cfg, lshapes), lshapes)
    return FsdpPlan(mesh=sizes,
                    params=dims(param_logical_axes(cfg), shapes), lora=lora)


def batch_rows(plan, batch: int, k: int, rank: int
               ) -> Tuple[list, bool]:
    """(the global rows ``rank`` takes of a ``batch``-row batch in ``k``
    microbatches, whether it owns them) under an FsdpPlan. Each
    microbatch splits over the mesh axes that ``batch_shardings``' spec
    keeps for it (trailing axes dropped while their product does not
    divide it, as the reference's spec degrades; ``FsdpPlan.block``); a
    dropped axis holds copies, which only its index 0 owns
    (``shard_batch`` weighs the others' rows 0, so every row counts
    once)."""
    m = batch // k
    block, blocks, owner = plan.block(m, rank)
    n = m // blocks
    return [i * m + block * n + j for i in range(k) for j in range(n)], owner


def shard_batch(batch: Dict[str, np.ndarray], fsdp, k: int = 1
                ) -> Dict[str, np.ndarray]:
    """Rank ``fsdp.rank``'s rows of a global numpy batch, in microbatch
    order (``batch_rows``: each of the k microbatches splits over the axes
    its spec keeps). A loss mask is always present, ones where the batch
    had none, and zeros on a rank that holds a copy of another's rows, so
    that the global sums count every row once. Records the global
    microbatch's rows in ``fsdp.micro_rows``, from which an MoE forward
    knows the rank's block of it (``Fsdp.routing``)."""
    b = batch["tokens"].shape[0]
    if b % k:
        raise ValueError(f"accumulate_steps={k} must divide batch size {b}")
    fsdp.micro_rows = b // k
    rows, owner = batch_rows(fsdp.plan, b, k, fsdp.rank)
    out = {key: v[rows] for key, v in batch.items()}
    mask = out.get("loss_mask")
    if mask is None:
        mask = np.ones(out["tokens"].shape, np.float32)
    out["loss_mask"] = mask if owner else mask * 0
    return out
