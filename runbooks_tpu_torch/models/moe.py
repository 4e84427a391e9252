"""Mixture-of-Experts FFN (the port of ``runbooks_tpu.models.moe``):
top-k routed gated experts over a static per-expert capacity.

The reference expresses routing as dense one-hot dispatch and combine
tensors [T, E, C] contracted by einsums. This module computes the same
function without them:

- the router in f32 (full precision: TF32 must stay off for it on CUDA),
  top-k with ties going to the lower expert index (``lax.top_k``'s rule,
  here a stable descending sort), the gates renormalised by
  ``max(sum, 1e-9)``;
- each assignment's slot in its expert from a choice-major count (every
  token's first choice before any second choice), and the reference's
  ``keep = slot < capacity``: assignments past an expert's capacity are
  dropped;
- dispatch writes the kept assignments' token rows into [E, C, h]
  (zeros in the unfilled slots), the experts are three batched products
  with f32 accumulation, each cast to the activation dtype, and combine
  gathers each assignment's expert output and sums ``weight · out_e``
  over the token's k choices, the weights first rounded to the
  activation dtype, as the reference's ``combine.astype(ad)``. The
  combine's products and sums are taken in f64 and rounded to f32 once:
  a token's result is then the same whatever order its k terms arrive
  in. In bf16 the products are exact in f32 and this is the reference's
  f32 sum bit for bit; in f32 it is the correctly rounded sum, within an
  f32 rounding of the reference's.

The backward is autograd's, and it is exact and deterministic on CUDA
without a hand-written ``autograd.Function``. Assignments are laid out
choice-major (index j·T + t), so the token side of dispatch is the rows
repeated k times and the combine's sum a sum over that leading axis of
k: their backwards are a sum and a broadcast, with no atomic adds. The
two gathers by slot take a gradient that is a gather (dispatch) and an
accumulating ``index_put_`` (combine), which CUDA runs sorted by index;
the only indices they repeat are the trash row and the last slot that
dropped assignments point at, and those carry exact zeros (``keep``),
as the reference's ``combine`` gives a dropped assignment none. The
gradient reaches x, the router (through the renormalised gates and, in
the aux, through the mean probabilities ``me``) and the three expert
weights; the first-choice fractions ``ce`` are counts and carry none, as
in the reference.

Served over a mesh of ``expert`` x ``tensor`` ranks (``moe_block``'s
``tp``, a parallel/sharding.TensorParallel), each rank holds its experts
(``tp.experts``: E / expert of them, or all where ``expert`` does not
divide E) on its MLP columns (m / tensor), and the router whole. Every
rank routes all T tokens of the dispatch, so capacity, slots and drops
are one device's; it dispatches only the kept assignments to experts it
holds, runs them, and sums its own terms in f64; one all-reduce of that
[T, h] partial sum over the serving group (every rank) completes the
combine, rounded to f32 and the activation dtype once, as one device
rounds it. Under ``expert`` alone and k = 2 that all-reduce adds to a
rank's own sum either zeros or the other expert's term, the two terms
one device adds: the result is one device's bit for bit (given the same
bits from each expert's batched products). Under ``tensor`` each
rank's ``wo`` product over its MLP columns is rounded to the activation
dtype before the sum, as the dense MLP's partial products are. A side
that replicates (``expert`` not dividing E, or ``tensor`` not dividing
m) is summed from its first index only (``tp.moe_owner``), so each
(expert, column) piece counts once; ``aux`` comes from the whole
``probs`` every rank holds and is not reduced.

Routing is the same on every rank because its input is: the residual
stream is the same function of the same bits on each rank. The
attention's all-reduce runs in each expert row's own tensor group, and
groups of one size given the same inputs return the same sums: with two
ranks the sum is one correctly rounded addition, whose result does not
depend on the order; with more, gloo's ring and NCCL's algorithm (chosen
per group size on one host whose GPUs are joined all to all) add in the
same order in every group. tests/test_torch_ep_serve.py holds every
rank's routing equal, layer by layer.

Trained over data x fsdp ranks (``moe_block``'s ``group``, a
parallel/sharding.RoutingGroup), each rank holds its block of the
global microbatch, which the reference's sharded step routes as one:
capacity from the global T, slots from a choice-major count over every
rank's tokens, the aux's means over the global batch. ``route`` gets
there from counts alone: one all-gather of each rank's [k, E]
assignments per (choice, expert) per layer and pass (the recompute
gathers again), no [T, E] tensor crossing ranks. Each rank's ``aux`` is
its share (the global aux is linear in ``me`` once ``ce`` is fixed, and
``ce`` carries no gradient), so the train step's sum over ranks counts
it once. Each rank holds the experts whole (the FSDP gather) and runs
them on its own kept assignments. With one rank there is no group, and
the block is one device's.

``moe_block_dense`` is the reference's one-hot formulation written out
literally, the plain version the tests and chip_smoke.py hold
``moe_block`` to. Capacity counts every token of the dispatch (T = b·s),
padding rows included, so a token's output depends on what else is in
its dispatch, as the reference's does.
"""

from __future__ import annotations

import math
from typing import Dict, NamedTuple, Tuple

import torch
import torch.nn.functional as F

Params = Dict[str, torch.Tensor]


def moe_capacity(cfg, n_tokens: int) -> int:
    """Static per-expert token capacity: ceil(k·T/E·cf), at least 1."""
    cap = math.ceil(cfg.moe_top_k * n_tokens / cfg.moe_num_experts
                    * cfg.moe_capacity_factor)
    return max(int(cap), 1)


class Routing(NamedTuple):
    """Top-k routing of T tokens, one entry per assignment in choice-major
    order (index j·T + t is token t's j-th choice): its expert, its slot
    in that expert, whether the slot is within capacity, and its gate
    (f32, renormalised over the token's k choices); ``capacity`` C and the
    load-balance ``aux`` (f32 scalar)."""
    expert: torch.Tensor   # [k·T] int64
    slot: torch.Tensor     # [k·T] int64
    keep: torch.Tensor     # [k·T] bool
    gate: torch.Tensor     # [k·T] f32
    capacity: int
    aux: torch.Tensor


def _top_k(probs: torch.Tensor, k: int):
    """(values, indices) of the k largest per row, ties to the lower
    index: torch.topk leaves the order among ties unspecified."""
    vals, idx = torch.sort(probs, dim=-1, descending=True, stable=True)
    return vals[:, :k], idx[:, :k]


def route(cfg, probs: torch.Tensor, group=None) -> Routing:
    """Routing of router probabilities ``probs`` [T, E] (f32), as the
    reference's ``_dispatch_combine`` decides it.

    ``group`` (a parallel/sharding.RoutingGroup): ``probs`` are this
    rank's block of a global microbatch that the group's ranks hold
    block by block, and the routing is the one ``route`` gives the whole
    microbatch on one device, for this rank's assignments. It takes
    counts, not probabilities, from the other ranks: each rank's
    assignments per (choice, expert), [k, E], gathered in block order.
    T is the global microbatch's; an assignment (j, t) to expert e takes
    the slot after every block's choices j' < j to e, the earlier blocks'
    choice-j assignments to e and its own block's before it. The gates
    stay local. ``aux`` is the rank's share of the global aux (its
    tokens' probabilities over the global T, times the global
    first-choice fractions; a copy's share is 0): the shares sum to the
    global aux, in value and in gradient, since ``ce`` carries none."""
    T, E = probs.shape
    k = cfg.moe_top_k
    T_all = T if group is None else T * group.blocks
    C = moe_capacity(cfg, T_all)
    gate_vals, gate_idx = _top_k(probs, k)                  # [T, k]
    gate_vals = gate_vals / torch.clamp(
        gate_vals.sum(-1, keepdim=True), min=1e-9)
    expert = gate_idx.T.reshape(k * T)                      # choice-major
    onehot = F.one_hot(expert, E)                           # [kT, E]
    # Assignments to the same expert before this one, in choice-major
    # order.
    before = torch.cumsum(onehot, dim=0) - onehot
    slot = before.gather(1, expert[:, None])[:, 0]
    if group is None:
        # Switch load balance: E · Σ_e mean_prob_e · first-choice
        # fraction_e.
        me = probs.mean(dim=0)
        ce = F.one_hot(gate_idx[:, 0], E).to(probs.dtype).mean(dim=0)
    else:
        counts = onehot.reshape(k, T, E).sum(1)             # [k, E]
        every = group.gather(counts)                        # [blocks, k, E]
        total = every.sum(0)
        # Per (j, e): the assignments before this block's choice j, less
        # this block's own choices j' < j, which ``before`` counts.
        offset = ((torch.cumsum(total, 0) - total)
                  + every[:group.block].sum(0)
                  - (torch.cumsum(counts, 0) - counts))
        choice = torch.arange(k, device=probs.device).repeat_interleave(T)
        slot = slot + offset[choice, expert]
        # A copy's share is 0: its owner counts these tokens.
        me = probs.sum(dim=0) / T_all * float(group.owner)
        ce = total[0].to(probs.dtype) / T_all
    keep = slot < C
    aux = (E * (me * ce).sum()).float()
    return Routing(expert, slot, keep, gate_vals.T.reshape(k * T), C, aux)


def router_probs(p: Params, xt: torch.Tensor) -> torch.Tensor:
    """Softmax of the f32 router logits of tokens ``xt`` [T, h]."""
    logits = torch.matmul(xt.float(), p["router"].float())
    return torch.softmax(logits, dim=-1)


def _experts(cfg, p: Params, expert_in: torch.Tensor) -> torch.Tensor:
    """The gated experts on [E, C, h] in the activation dtype."""
    from runbooks_tpu_torch.models.transformer import _activation

    ad = cfg.activation_dtype
    gate = torch.bmm(expert_in, p["wi_gate"].to(ad))
    up = torch.bmm(expert_in, p["wi_up"].to(ad))
    hidden = _activation(cfg, gate) * up
    return torch.bmm(hidden, p["wo"].to(ad))


def moe_block(cfg, p: Params, x: torch.Tensor, tp=None, group=None
              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """MoE FFN over x [b, s, h] with one layer's ``p`` (router [h, E],
    wi_gate / wi_up [E, h, m], wo [E, m, h]) -> (out [b, s, h], aux).
    Shapes stay static (no host sync): a dropped assignment writes its
    token to a trash row past the E·C slots and combines with weight 0
    (and so takes no gradient). ``tp``: one serving rank's view, its
    experts and MLP columns in ``p`` (see the module docstring).

    ``group``: a training rank's block of the global microbatch (see
    ``route``; ``aux`` is then the rank's share). The experts run on this
    rank's kept assignments only, each at its place among them, in a
    buffer of min(C, T) rows per expert (a token takes an expert at most
    once): the global C would cost each of W ranks W times its share of
    the experts' work."""
    ad = cfg.activation_dtype
    b, s, h = x.shape
    T, k = b * s, cfg.moe_top_k
    xt = x.reshape(T, h)
    r = route(cfg, router_probs(p, xt), group)
    first, E = 0, cfg.moe_num_experts
    held, cap, place = r.keep, r.capacity, r.slot
    if group is not None:
        cap = min(cap, T)
        kept = F.one_hot(r.expert, E) * held[:, None]
        place = (torch.cumsum(kept, 0) - kept).gather(
            1, r.expert[:, None])[:, 0]
    if tp is not None:
        first, E = tp.experts.start, len(tp.experts)
        held = held & (r.expert >= first) & (r.expert < first + E)
        if not tp.moe_owner:
            held = torch.zeros_like(held)
    EC = E * cap
    row = torch.where(held, (r.expert - first) * cap + place, EC)
    # Assignment j·T + t carries token t: the rows repeated k times.
    expert_in = torch.zeros((EC + 1, h), dtype=ad, device=x.device
                            ).index_put((row,), xt.to(ad).repeat(k, 1))
    out_e = _experts(cfg, p, expert_in[:EC].reshape(E, cap, h))
    picked = out_e.reshape(EC, h)[row.clamp(max=EC - 1)].double()
    weight = r.gate.to(ad).double()
    contrib = torch.where(held[:, None], weight[:, None] * picked, 0.0)
    out = contrib.reshape(k, T, h).sum(0)
    if tp is not None:
        out = tp.combine(out)
    return out.float().to(ad).reshape(b, s, h), r.aux


def dispatch_combine_dense(cfg, probs: torch.Tensor):
    """The reference's ``_dispatch_combine`` as it is written: (dispatch
    [T, E, C], combine [T, E, C], aux) of router probabilities [T, E],
    with each slot counted by a cumulative sum over one-hot rows."""
    T, E = probs.shape
    k = cfg.moe_top_k
    C = moe_capacity(cfg, T)
    gate_vals, gate_idx = _top_k(probs, k)
    gate_vals = gate_vals / torch.clamp(
        gate_vals.sum(-1, keepdim=True), min=1e-9)
    onehot = F.one_hot(gate_idx, E).to(probs.dtype)         # [T, k, E]
    flat = onehot.transpose(0, 1).reshape(k * T, E)         # choice-major
    pos_in_expert = torch.cumsum(flat, dim=0) - flat
    pos = (pos_in_expert * flat).sum(-1).to(torch.int64)
    keep = (pos < C).to(probs.dtype)
    # jax.nn.one_hot of a position past C is all zeros.
    slot = F.one_hot(pos.clamp(max=C), C + 1)[:, :C].to(probs.dtype)
    disp_flat = flat[:, :, None] * slot[:, None, :] * keep[:, None, None]
    dispatch = disp_flat.reshape(k, T, E, C).sum(0)
    weights = gate_vals.transpose(0, 1).reshape(k * T)
    combine = (disp_flat * weights[:, None, None]).reshape(k, T, E, C).sum(0)
    me = probs.mean(dim=0)
    ce = F.one_hot(gate_idx[:, 0], E).to(probs.dtype).mean(dim=0)
    aux = (E * (me * ce).sum()).float()
    return dispatch, combine, aux


def routing_dispatch(r: Routing, n_tokens: int, n_experts: int
                     ) -> torch.Tensor:
    """The dense dispatch [T, E, C] (f32 0/1) that a Routing stands for:
    the kept assignments' (token, expert, slot)."""
    out = torch.zeros((n_tokens, n_experts, r.capacity),
                      dtype=torch.float32, device=r.expert.device)
    kept = torch.nonzero(r.keep)[:, 0]
    out[kept % n_tokens, r.expert[kept], r.slot[kept]] = 1.0
    return out


def moe_block_dense(cfg, p: Params, x: torch.Tensor, tp=None, group=None
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The reference's moe_block as it is written: dense one-hot dispatch
    and combine [T, E, C] (dispatch_combine_dense) and the einsums over
    them (f32 accumulation, each product cast to the activation dtype;
    the combine's in f64, rounded to f32 once, as moe_block's). O(T·E·C)
    memory: the plain version for tests and the card's check, not for
    serving. It runs on one device (``tp`` and ``group`` None: it takes
    moe_block's arguments, so that a forward can run either)."""
    if tp is not None or group is not None:
        raise NotImplementedError(
            "moe_block_dense is the single-device plain version; a "
            "serving or training rank's experts run through moe_block")
    ad = cfg.activation_dtype
    b, s, h = x.shape
    xt = x.reshape(b * s, h)
    dispatch, combine, aux = dispatch_combine_dense(cfg, router_probs(p, xt))
    expert_in = torch.einsum("tec,th->ech", dispatch.to(ad).float(),
                             xt.to(ad).float()).to(ad)
    out_e = _experts(cfg, p, expert_in)
    # The combine's sum in f64, rounded to f32 once (as moe_block's).
    out = torch.einsum("tec,ech->th", combine.to(ad).double(),
                       out_e.double()).float().to(ad)
    return out.reshape(b, s, h), aux


def moe_logical_axes():
    """Logical axes for the stacked [L, ...] MoE params."""
    return {
        "router": ("layers", "embed", "experts"),
        "wi_gate": ("layers", "experts", "embed", "mlp"),
        "wi_up": ("layers", "experts", "embed", "mlp"),
        "wo": ("layers", "experts", "mlp", "embed"),
    }
