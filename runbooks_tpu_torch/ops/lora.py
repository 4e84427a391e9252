"""Grouped per-row LoRA adapter deltas for multi-tenant batched serving (the
port of ``runbooks_tpu.ops.lora``).

One set of base weights plus a bounded pool of LoRA adapters stays on the
device as stacked tensors, and rows of one batch that use different
adapters (or none) share one forward dispatch:

- ``grouped_lora_delta``: each row gathers ITS adapter's A/B from the
  stacked ``[lanes, ...]`` pool by an int lane index, and ``(x @ A) @ B``
  adds to the base projection's output. A batch mixing four tenants and
  base-only rows is still one forward.
- **Trash lane**: lane ``lanes - 1`` is all-zero and never written with a
  real adapter; rows with lane -1 (base-only) map there, so their delta is
  exactly zero.
- **Rank bucket**: every lane has the same rank R. Adapters trained at
  r < R zero-pad A's and B's rank axis (padding contributes exactly 0).
  Each adapter's alpha/rank scale is folded into its B at load
  (serve/lora_pool.load_adapter_tree), so the delta takes no per-row
  scale.
- **In-place lane writes**: ``write_lane`` copies one adapter into one
  lane of the existing pool tensors; the pool is never rebuilt.
- **One gather per forward**: the lanes of a dispatch are the same in
  every layer, so ``gather_lanes`` gathers a forward's ``[L, rows, ...]``
  operands once and ``lane_delta`` runs the per-layer products on them;
  it is ``grouped_lora_delta`` on that layer, op for op.
- **Quantized bases**: the delta adds to the base projection's output, so
  it composes with weight-only int8/int4 base params (QuantizedArray,
  ops/quantization.py) unchanged; base-only rows get the no-pool
  quantized engine's outputs bit for bit.

- **Under a serving mesh** each rank holds its shard of every lane, by
  ``adapter_pool_logical_axes`` (the reference's): a column-parallel
  target keeps ``a`` whole and ``b`` cut to the rank's output columns, a
  row-parallel one (``wo``) keeps ``a`` cut to the rank's input rows and
  ``b`` whole, the cuts parallel/sharding.shard_leaf gives the base
  matrix. A row-parallel delta is then the rank's partial sum and rides
  the sublayer's one all-reduce (models/transformer.py).
"""

from __future__ import annotations

from typing import Any, Dict, Sequence, Tuple

import torch

Params = Any

# Matrices eligible for serving-time adapter injection, by their dotted
# path inside params["layers"]: train/lora.py's target vocabulary.
ADAPTER_TARGETS = ("attn.wq", "attn.wk", "attn.wv", "attn.wo",
                   "mlp.wi_gate", "mlp.wi_up", "mlp.wi", "mlp.wo")


def target_dims(cfg, target: str) -> Tuple[int, int]:
    """(d_in, d_out) of a LoRA target matrix under ``cfg``. Raises for
    targets the architecture does not have (``mlp.wi`` on a gated model),
    so a misconfigured pool fails at construction, not at the first
    admission."""
    h = cfg.hidden_size
    dims = {
        "attn.wq": (h, cfg.q_dim), "attn.wk": (h, cfg.kv_dim),
        "attn.wv": (h, cfg.kv_dim), "attn.wo": (cfg.q_dim, h),
    }
    if cfg.moe_num_experts == 0:
        m = cfg.intermediate_size
        if cfg.gated_mlp:
            dims.update({"mlp.wi_gate": (h, m), "mlp.wi_up": (h, m),
                         "mlp.wo": (m, h)})
        else:
            dims.update({"mlp.wi": (h, m), "mlp.wo": (m, h)})
    if target not in dims:
        raise ValueError(
            f"LoRA target {target!r} does not exist on model "
            f"{cfg.name!r} (moe={bool(cfg.moe_num_experts)}, "
            f"gated_mlp={cfg.gated_mlp}); available: {sorted(dims)}")
    return dims[target]


def nest_targets(flat: Dict[str, Any]) -> Params:
    """{"attn.wq": v} -> {"attn": {"wq": v}}: the pool mirrors the
    params["layers"] nesting, so each block looks up its own targets."""
    out: Dict[str, Dict[str, Any]] = {}
    for dotted, v in flat.items():
        group, name = dotted.split(".", 1)
        out.setdefault(group, {})[name] = v
    return out


def init_adapter_pool(cfg, pool_size: int, rank: int,
                      targets: Sequence[str],
                      device: torch.device, cut=None) -> Params:
    """All-zero stacked adapter pool on ``device``: per target
    {"a": [L, pool_size + 1, d_in, rank], "b": [L, pool_size + 1, rank,
    d_out]} in the activation dtype. Lane ``pool_size`` is the trash lane,
    never written, so base-only rows gather exact zeros. ``cut(leaf,
    axes)`` (a serving rank's parallel/sharding.shard_leaf) gives each
    leaf its shape on that rank, by ``adapter_pool_logical_axes``."""
    if pool_size < 1:
        raise ValueError(f"adapter pool_size must be >= 1, got {pool_size}")
    if rank < 1:
        raise ValueError(f"lora_rank must be >= 1, got {rank}")
    L, ad = cfg.num_layers, cfg.activation_dtype

    def zeros(shape, axes):
        if cut is not None:
            shape = cut(torch.empty(shape, device="meta"), axes).shape
        return torch.zeros(shape, dtype=ad, device=device)

    flat = {}
    for t in targets:
        d_in, d_out = target_dims(cfg, t)
        in_ax, out_ax = _BASE_AXES[t]
        flat[t] = {
            "a": zeros((L, pool_size + 1, d_in, rank),
                       (None, None, in_ax, None)),
            "b": zeros((L, pool_size + 1, rank, d_out),
                       (None, None, None, out_ax)),
        }
    return nest_targets(flat)


def _leaves(pool: Params):
    for sub in pool.values():
        for ab in sub.values():
            yield ab["a"]
            yield ab["b"]


def pool_lanes(pool: Params) -> int:
    """Lane count (pool_size + 1, trash included) of a pool: the lane axis
    of the full [L, lanes, ...] leaves, or of a per-layer [lanes, ...]
    slice."""
    leaf = next(_leaves(pool))
    return leaf.shape[1] if leaf.dim() == 4 else leaf.shape[0]


def map_lane_indices(idx: torch.Tensor, lanes: int) -> torch.Tensor:
    """Per-row lane indices with -1 (base-only) mapped to the trash lane
    (lanes - 1) and everything clipped into range."""
    idx = idx.to(torch.int64)
    return torch.where(idx < 0, lanes - 1, idx).clamp(0, lanes - 1)


def grouped_lora_delta(x: torch.Tensor, ab: Dict[str, torch.Tensor],
                       idx: torch.Tensor, compute_dtype) -> torch.Tensor:
    """Per-row adapter delta ``(x @ A[idx]) @ B[idx]`` for one target.

    x:   [rows, s, d_in] activations feeding the base projection
    ab:  {"a": [lanes, d_in, r], "b": [lanes, r, d_out]} (one layer's pool
         slice; each adapter's scale already folded into b)
    idx: [rows] lane indices, already trash-mapped (map_lane_indices)

    Returns [rows, s, d_out] in compute_dtype: both products accumulate in
    f32 (the batched GEMM's accumulator for bf16 operands) and round to
    compute_dtype, ``t`` between them as the reference casts it."""
    a_sel = ab["a"].index_select(0, idx)          # [rows, d_in, r]
    b_sel = ab["b"].index_select(0, idx)          # [rows, r, d_out]
    return lane_delta(x, a_sel, b_sel, compute_dtype)


def lane_delta(x: torch.Tensor, a_sel: torch.Tensor, b_sel: torch.Tensor,
               compute_dtype) -> torch.Tensor:
    """The delta's two products on one layer's gathered per-row operands
    (a_sel [rows, d_in, r], b_sel [rows, r, d_out])."""
    t = torch.bmm(x.to(compute_dtype), a_sel.to(compute_dtype))
    return torch.bmm(t.to(compute_dtype), b_sel.to(compute_dtype)).to(
        compute_dtype)


def gather_lanes(pool: Params, idx: torch.Tensor) -> Params:
    """A forward's per-row operands, gathered once for every layer:
    {group: {name: (a [L, rows, d_in, r], b [L, rows, r, d_out])}} for
    trash-mapped lanes ``idx`` [rows]."""
    return {group: {name: (ab["a"].index_select(1, idx),
                           ab["b"].index_select(1, idx))
                    for name, ab in sub.items()}
            for group, sub in pool.items()}


def write_lane(pool: Params, adapter: Params, lane: int) -> None:
    """Copy one adapter ({group: {name: {"a": [L, d_in, r], "b": [L, r,
    d_out]}}}, any dtype and device, typically f32 on the host) into pool
    lane ``lane`` in place, casting to the pool's dtype. The pool tensors
    keep their storage; a functional update would copy the whole pool."""
    lanes = pool_lanes(pool)
    if not 0 <= lane < lanes - 1:
        raise ValueError(f"lane {lane} is not a writable lane of a pool of "
                         f"{lanes - 1} (lane {lanes - 1} is the trash lane)")
    pairs = [(ab[k][:, lane], adapter[group][name][k], f"{group}.{name}.{k}")
             for group, sub in pool.items() for name, ab in sub.items()
             for k in ("a", "b")]
    # Every shape is checked before the first copy: a refused write leaves
    # the lane as it was.
    for dst, src, where in pairs:
        if tuple(src.shape) != tuple(dst.shape):
            raise ValueError(
                f"adapter {where} of shape {tuple(src.shape)} does not fit "
                f"lane shape {tuple(dst.shape)}")
    for dst, src, _ in pairs:
        dst.copy_(src)


# Each target's (input, output) logical axes: its base matrix's.
_BASE_AXES = {
    "attn.wq": ("embed", "heads"), "attn.wk": ("embed", "kv_heads"),
    "attn.wv": ("embed", "kv_heads"), "attn.wo": ("heads", "embed"),
    "mlp.wi_gate": ("embed", "mlp"), "mlp.wi_up": ("embed", "mlp"),
    "mlp.wi": ("embed", "mlp"), "mlp.wo": ("mlp", "embed"),
}


def adapter_pool_logical_axes(pool: Params) -> Params:
    """Logical axes for the pool under a serving mesh (the reference's):
    the lane and rank axes replicated, the in/out axes following the base
    matrix's."""
    axes: Dict[str, Dict[str, dict]] = {}
    for group, sub in pool.items():
        axes[group] = {}
        for name in sub:
            in_ax, out_ax = _BASE_AXES.get(f"{group}.{name}", (None, None))
            axes[group][name] = {"a": (None, None, in_ax, None),
                                 "b": (None, None, None, out_ax)}
    return axes


def adapter_tree_logical_axes(target: str) -> Dict[str, tuple]:
    """One adapter's {"a": [L, d_in, r], "b": [L, r, d_out]} axes for
    ``target`` (serve/lora_pool.load_adapter_tree's layout): a lane's."""
    in_ax, out_ax = _BASE_AXES[target]
    return {"a": (None, in_ax, None), "b": (None, None, out_ax)}
