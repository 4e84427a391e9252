"""Decoder-only transformer over a params dict (the port of
``runbooks_tpu.models.transformer``: the dense Llama, Falcon, OPT, GPT-2
and Gemma families, and Mixtral's routed experts).

- Params keep the reference's layout: {"embed", "final_norm", "head",
  "layers": {...stacked [L, ...] tensors...}}; the forward loops over the
  leading layer axis where the reference scans it. The optional leaves
  follow the config as the reference's: norm biases under layernorm,
  attention and MLP biases, a plain (ungated) MLP ``mlp.wi``, learned
  positions ``pos_embed``, no ``head`` under a tied head (the logits use
  ``embed.T``), no ``ln2`` under a parallel block with one shared norm.
  Gemma's embedding is scaled by sqrt(hidden_size) (``embed_scale``); its
  RMSNorm's (1 + w) is folded into the scales by the converter. An MoE
  config (``moe_num_experts``) holds a ``moe`` group in place of ``mlp``
  and its FFN is models/moe.moe_block; ``forward(with_aux=True)`` also
  returns the summed per-layer load-balance loss.
- f32 norms, softmax and logits; matmuls in the activation dtype.
- One forward serves the no-cache path and the KV-cache path. The cache
  path writes in place (the reference's donated buffers): the KVCache's
  tensors are updated and a KVCache with the new index is returned.
- Attention: the hand-written flash kernels (ops/flash_attention.py) on
  CUDA for the no-cache path (forward and backward) and for cached prefill
  of >= 16 query rows; decode (one query row) and the CPU use the plain
  dot_product_attention, as the reference routes them.
- Training: packed rows (``segment_ids``), per-block activation
  checkpointing (``remat``), and LoRA deltas merged into each layer's
  weights inside its block (``lora``), so no merged copy of all layers
  lives across a step.
- Serving many LoRA tenants on one base (``adapters``): each row adds its
  own adapter's delta, gathered from a stacked pool by lane
  (ops/lora.py), to the projections the pool targets.
- Weight-only quantized layers (ops/quantization.QuantizedArray) take
  ``quantized_matmul``; an int8 KV cache (``KVCache.create(...,
  quantize_kv=True)``) quantizes K/V on write and dequantizes the read
  view to the activation dtype before attention.
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Any, Callable, Dict, Optional, Tuple

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from runbooks_tpu_torch.models.config import ModelConfig
from runbooks_tpu_torch.models.moe import moe_block, moe_logical_axes
from runbooks_tpu_torch.ops.attention import (
    dot_product_attention,
    make_attention_mask,
)
from runbooks_tpu_torch.ops.flash_attention import flash_attention
from runbooks_tpu_torch.ops.lora import (
    gather_lanes,
    lane_delta,
    map_lane_indices,
    pool_lanes,
)
from runbooks_tpu_torch.ops.norms import layer_norm, rms_norm
from runbooks_tpu_torch.ops.quantization import (
    QuantizedArray,
    dequantize_kv,
    quantize_kv,
    quantized_matmul,
)
from runbooks_tpu_torch.ops.rotary import apply_rope

Params = Dict[str, Any]

# Flash cached-prefill pays off once the query block is at least one tile;
# below this the plain path's mask build is noise anyway.
FLASH_CACHED_PREFILL_MIN_Q = 16


def check_supported(cfg: ModelConfig) -> None:
    """Reject a config that needs a feature the port's forward does not
    implement yet, naming it (the dense Llama, Falcon, OPT, GPT-2 and
    Gemma features and Mixtral's MoE are ported; qk-norm, softcap and
    ALiBi wait for later slices, see ROADMAP.md)."""
    missing = []
    if cfg.qk_norm:
        missing.append("qk_norm")
    if cfg.logit_softcap is not None:
        missing.append(f"logit_softcap={cfg.logit_softcap}")
    if cfg.position_type == "alibi":
        missing.append("position_type='alibi'")
    if missing:
        raise NotImplementedError(
            f"config {cfg.name!r} needs {', '.join(missing)}, which the "
            f"PyTorch port does not implement yet")


# ---------------------------------------------------------------------------
# Initialization
# ---------------------------------------------------------------------------

def init_params(cfg: ModelConfig, generator: Optional[torch.Generator],
                device: torch.device,
                cut: Optional[Callable[[torch.Tensor, tuple],
                                       torch.Tensor]] = None) -> Params:
    """Random-init parameters (stacked layers) on ``device`` from a seeded
    generator on that device. Same leaves, shapes, scales and layout as
    the reference's init_params; the numbers differ (another RNG), so tests
    carry the reference's weights over with models/bridge.py.

    ``cut(leaf, logical_axes)`` (a tensor-parallel rank's
    parallel/sharding.shard_leaf) is applied to each leaf as it is drawn,
    so one full leaf at a time is held; the draws are the same with it or
    without it (in the tree's order)."""
    check_supported(cfg)
    h, v, L = cfg.hidden_size, cfg.vocab_size, cfg.num_layers
    m = cfg.intermediate_size
    pd = cfg.parameter_dtype

    def normal(shape, scale):
        # Drawn in tree order by ``draw`` below.
        return lambda: torch.randn(shape, generator=generator, device=device,
                                   dtype=pd).mul_(scale)

    def ones(shape):
        return torch.ones(shape, dtype=pd, device=device)

    def zeros(shape):
        return torch.zeros(shape, dtype=pd, device=device)

    def norm(prefix=()):
        if cfg.norm_type == "rmsnorm":
            return {"scale": ones((*prefix, h))}
        return {"scale": ones((*prefix, h)), "bias": zeros((*prefix, h))}

    params: Params = {"embed": normal((v, h), h ** -0.5),
                      "final_norm": norm()}
    if cfg.position_type == "learned":
        params["pos_embed"] = normal((cfg.max_seq_len, h), 0.02)
    if not cfg.tie_embeddings:
        params["head"] = normal((h, v), h ** -0.5)
    attn = {
        "wq": normal((L, h, cfg.q_dim), h ** -0.5),
        "wk": normal((L, h, cfg.kv_dim), h ** -0.5),
        "wv": normal((L, h, cfg.kv_dim), h ** -0.5),
        "wo": normal((L, cfg.q_dim, h), cfg.q_dim ** -0.5),
    }
    if cfg.attn_bias:
        attn.update(bq=zeros((L, cfg.q_dim)), bk=zeros((L, cfg.kv_dim)),
                    bv=zeros((L, cfg.kv_dim)), bo=zeros((L, h)))
    layers = {"attn": attn, "ln1": norm((L,))}
    if cfg.moe_num_experts:
        if not cfg.gated_mlp:
            raise ValueError("MoE experts are gated (mixtral-style): set "
                             "gated_mlp")
        E = cfg.moe_num_experts
        layers["moe"] = {"router": normal((L, h, E), h ** -0.5),
                         "wi_gate": normal((L, E, h, m), h ** -0.5),
                         "wi_up": normal((L, E, h, m), h ** -0.5),
                         "wo": normal((L, E, m, h), m ** -0.5)}
    else:
        if cfg.gated_mlp:
            mlp = {"wi_gate": normal((L, h, m), h ** -0.5),
                   "wi_up": normal((L, h, m), h ** -0.5)}
        else:
            mlp = {"wi": normal((L, h, m), h ** -0.5)}
        mlp["wo"] = normal((L, m, h), m ** -0.5)
        if cfg.mlp_bias:
            for k in [k for k in mlp if k.startswith("wi")]:
                mlp["b" + k[1:]] = zeros((L, m))
            mlp["bo"] = zeros((L, h))
        layers["mlp"] = mlp
    if not (cfg.parallel_block and cfg.shared_layer_norm):
        layers["ln2"] = norm((L,))
    params["layers"] = layers

    def draw(p, axes):
        if isinstance(p, dict):
            return {k: draw(p[k], axes[k]) for k in p}
        leaf = p() if callable(p) else p
        return leaf if cut is None else cut(leaf, axes)

    return draw(params, param_logical_axes(cfg))


def param_logical_axes(cfg: ModelConfig) -> Params:
    """A tree matching init_params with logical axis names per dimension
    (the reference's; parallel/sharding.py maps them to mesh axes), for
    the configs the port runs (check_supported names the others)."""
    check_supported(cfg)
    norm1 = lambda pre: {k: pre + ("norm",) for k in  # noqa: E731
                         (("scale", "bias") if cfg.norm_type == "layernorm"
                          else ("scale",))}
    axes: Params = {
        "embed": ("vocab", "embed"),
        "final_norm": norm1(()),
    }
    if cfg.position_type == "learned":
        axes["pos_embed"] = ("pos", "embed")
    if not cfg.tie_embeddings:
        axes["head"] = ("embed", "vocab")
    # The stacked-layer leading dim carries "layers" (the stage axis).
    attn = {
        "wq": ("layers", "embed", "heads"),
        "wk": ("layers", "embed", "kv_heads"),
        "wv": ("layers", "embed", "kv_heads"),
        "wo": ("layers", "heads", "embed"),
    }
    if cfg.attn_bias:
        attn.update({"bq": ("layers", "heads"),
                     "bk": ("layers", "kv_heads"),
                     "bv": ("layers", "kv_heads"),
                     "bo": ("layers", "norm")})
    layers = {"attn": attn, "ln1": norm1(("layers",))}
    if cfg.moe_num_experts:
        layers["moe"] = moe_logical_axes()
    else:
        mlp = {"wo": ("layers", "mlp", "embed")}
        if cfg.gated_mlp:
            mlp.update({"wi_gate": ("layers", "embed", "mlp"),
                        "wi_up": ("layers", "embed", "mlp")})
        else:
            mlp["wi"] = ("layers", "embed", "mlp")
        if cfg.mlp_bias:
            for k in list(mlp):
                if k.startswith("wi"):
                    mlp["b" + k[1:]] = ("layers", "mlp")
            mlp["bo"] = ("layers", "norm")
        layers["mlp"] = mlp
    if not (cfg.parallel_block and cfg.shared_layer_norm):
        layers["ln2"] = norm1(("layers",))
    axes["layers"] = layers
    return axes


# ---------------------------------------------------------------------------
# KV cache
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class KVCache:
    """Per-model KV cache, layers stacked on the leading axis.

    k, v: [num_layers, batch, cache_len, num_kv_heads, head_dim]
    index: tokens already written (the same for the whole batch).
    k_scale, v_scale: with ``quantize_kv`` k/v are int8 and these hold one
    f32 scale per (layer, row, slot, kv head), [num_layers, batch,
    cache_len, num_kv_heads]; None otherwise. ``forward`` quantizes on
    write and dequantizes on read. Two write modes in ``forward``:

    - scalar-index mode (positions omitted): tokens append at ``index``.
    - position-scatter mode (positions given): token j of row b writes to
      slot ``positions[b, j]`` (clipped to cache_len-1); rows advance
      independently, as slot-based continuous batching needs. Allocate with
      ``trash_slot=True`` (cache_len = max_len+1) and park padding at slot
      max_len, which no real query ever attends.
    """

    k: torch.Tensor
    v: torch.Tensor
    index: int = 0
    k_scale: Optional[torch.Tensor] = None
    v_scale: Optional[torch.Tensor] = None

    @classmethod
    def create(cls, cfg: ModelConfig, batch: int, max_len: int,
               device: torch.device, trash_slot: bool = False,
               quantize_kv: bool = False,
               kv_heads: Optional[int] = None) -> "KVCache":
        """``kv_heads``: the kv heads this cache holds (default all of
        them; a tensor-parallel rank holds its own, TensorPlan
        .kv_head_ids)."""
        cache_len = max_len + 1 if trash_slot else max_len
        shape = (cfg.num_layers, batch, cache_len,
                 cfg.num_kv_heads if kv_heads is None else kv_heads,
                 cfg.head_dim)
        if quantize_kv:
            return cls(
                k=torch.zeros(shape, dtype=torch.int8, device=device),
                v=torch.zeros(shape, dtype=torch.int8, device=device),
                k_scale=torch.zeros(shape[:-1], dtype=torch.float32,
                                    device=device),
                v_scale=torch.zeros(shape[:-1], dtype=torch.float32,
                                    device=device))
        return cls(
            k=torch.zeros(shape, dtype=cfg.activation_dtype, device=device),
            v=torch.zeros(shape, dtype=cfg.activation_dtype, device=device),
            index=0)

    @property
    def quantized(self) -> bool:
        return self.k.dtype == torch.int8

    @property
    def nbytes(self) -> int:
        """Bytes of the values and, when quantized, the scales."""
        return sum(t.numel() * t.element_size()
                   for t in (self.k, self.v, self.k_scale, self.v_scale)
                   if t is not None)


# ---------------------------------------------------------------------------
# Attention routing
# ---------------------------------------------------------------------------

def resolve_attention_impl(cfg: ModelConfig, device: torch.device) -> str:
    """The concrete attention of the no-cache path: "flash" or "xla"
    (the plain path). "auto" picks the kernel on CUDA."""
    impl = cfg.attention_impl
    if impl not in ("auto", "xla", "flash"):
        raise ValueError(f"unknown attention_impl {impl!r}; expected "
                         "auto|xla|flash")
    if impl == "auto":
        impl = "flash" if torch.device(device).type == "cuda" else "xla"
    return impl


def use_flash_cached_prefill(cfg: ModelConfig, q_len: int,
                             device: torch.device) -> bool:
    """Route a prefill-with-cache through the flash kernel? True when the
    query block is at least one tile and the config asks for flash (or
    "auto" on CUDA). Decode (q_len=1) always stays on the plain path.
    The kernel masks from absolute positions, which for a cache (slot i
    holds position i) is exactly the plain path's mask."""
    if q_len < FLASH_CACHED_PREFILL_MIN_Q:
        return False
    return resolve_attention_impl(cfg, device) == "flash"


# ---------------------------------------------------------------------------
# Blocks
# ---------------------------------------------------------------------------

def _norm(cfg: ModelConfig, p: Params, x: torch.Tensor,
          layer_idx: Optional[int] = None) -> torch.Tensor:
    """The config's norm with p's scale (and bias), of layer ``layer_idx``
    of a stacked group when given."""
    pick = (lambda t: t) if layer_idx is None else (lambda t: t[layer_idx])
    if cfg.norm_type == "rmsnorm":
        return rms_norm(x, pick(p["scale"]), cfg.norm_eps)
    return layer_norm(x, pick(p["scale"]), pick(p["bias"]), cfg.norm_eps)


def _activation(cfg: ModelConfig, x: torch.Tensor) -> torch.Tensor:
    """silu, gelu or relu. gelu is the tanh form for every family, as the
    reference's (``jax.nn.gelu(approximate=True)``)."""
    if cfg.activation == "silu":
        return F.silu(x)
    if cfg.activation == "gelu":
        return F.gelu(x, approximate="tanh")
    return F.relu(x)


def _add_bias(p, name: str, layer_idx: int, y: torch.Tensor, ad):
    """y plus layer ``layer_idx``'s bias ``name`` when the params hold
    it (after any LoRA or adapter delta, as the reference)."""
    if name not in p:
        return y
    return y + p[name][layer_idx].to(ad)


def _matmul(x: torch.Tensor, w, ad: torch.dtype):
    if isinstance(w, QuantizedArray):
        return quantized_matmul(x, w, ad).to(ad)
    return torch.matmul(x, w.to(ad))


# Remat policies (the reference's _remat_policy) as torch's selective
# activation checkpointing, which decides per operator: the projections
# (and the LoRA factors' products) dispatch to aten.mm, the plain
# attention's products to aten.bmm, and K1 (or its plain version) is the
# one operator rbt::flash_fwd.
_NO_BATCH_DOTS = (torch.ops.aten.mm.default, torch.ops.aten.addmm.default)
_BATCH_DOTS = (torch.ops.aten.bmm.default, torch.ops.aten.baddbmm.default)
REMAT_POLICIES = {
    # Only the block's input is kept.
    "nothing_saveable": (),
    # The outputs of products without batch dimensions.
    "dots_with_no_batch_dims_saveable": _NO_BATCH_DOTS,
    # Every product's output.
    "dots_saveable": _NO_BATCH_DOTS + _BATCH_DOTS,
    # The post-wo attention output ("attn_out") and K1's (out, lse): the
    # backward feeds K2 and K3 from them without running K1 again. On the
    # plain attention this is nothing_saveable plus the saved wo output,
    # as the reference says.
    "save_attn_out": ("attn_out", torch.ops.rbt.flash_fwd.default),
}


@torch.library.custom_op("rbt::checkpoint_name", mutates_args=())
def checkpoint_name(x: torch.Tensor, name: str) -> torch.Tensor:
    """A copy of ``x`` that a remat policy can save by ``name``, as the
    reference's ``jax.ad_checkpoint.checkpoint_name`` tags a value (an
    operator may not return its input, hence the copy)."""
    return x.clone()


@checkpoint_name.register_fake
def _checkpoint_name_fake(x, name):
    return torch.empty_like(x)


checkpoint_name.register_autograd(
    lambda ctx, grad: (grad, None),
    setup_context=lambda ctx, inputs, output: None)


def _check_remat_policy(name: str) -> None:
    if name != "none" and name not in REMAT_POLICIES:
        raise ValueError(f"unknown remat_policy {name!r}; expected none|"
                         f"{'|'.join(REMAT_POLICIES)}")


def _remat_context_fn(name: str):
    """The checkpoint's context_fn for policy ``name``: every operator the
    policy names (or every rbt::checkpoint_name call with a name it lists)
    is saved in the forward and handed back in the recompute; the rest is
    recomputed. None for nothing_saveable, which saves nothing."""
    saved = REMAT_POLICIES[name]
    if not saved:
        return None
    from torch.utils.checkpoint import (
        CheckpointPolicy,
        create_selective_checkpoint_contexts,
    )

    names = {x for x in saved if isinstance(x, str)}
    ops = {x for x in saved if not isinstance(x, str)}

    def policy(ctx, op, *args, **kwargs):
        if op in ops or (op is torch.ops.rbt.checkpoint_name.default
                         and args[1] in names):
            return CheckpointPolicy.MUST_SAVE
        return CheckpointPolicy.PREFER_RECOMPUTE

    return functools.partial(create_selective_checkpoint_contexts, policy)


class LoraDeltas:
    """LoRA factors to merge into the base weights, layer by layer:
    ``factors`` is {"attn.wq": {"a": [L, in, r], "b": [L, r, out]}, ...}
    and the merged weight of layer l is
    ``(W[l].f32 + scale * A[l] @ B[l]).to(W.dtype)``, as the reference's
    ``apply_lora``."""

    def __init__(self, factors: Dict[str, Dict[str, torch.Tensor]],
                 scale: float):
        self.factors = factors
        self.scale = scale

    def weight(self, path: str, w: torch.Tensor, layer_idx: int):
        f = self.factors.get(path)
        if f is None:
            return w[layer_idx]
        if isinstance(w, QuantizedArray):
            raise NotImplementedError(
                f"LoRA training over a quantized base ({path} is int"
                f"{w.bits}): the reference never trains one; train on the "
                "unquantized weights")
        ab = torch.matmul(f["a"][layer_idx].float(),
                          f["b"][layer_idx].float())
        return (w[layer_idx].float() + self.scale * ab).to(w.dtype)


def _weight(p, group, name, layer_idx, lora):
    w = p[name]
    if lora is None:
        return w[layer_idx]
    return lora.weight(f"{group}.{name}", w, layer_idx)


def _adapter_delta(adapter, name: str, layer_idx: int, x_in: torch.Tensor,
                   y: torch.Tensor, ad) -> torch.Tensor:
    """Add the grouped per-row LoRA delta of one target to the base
    projection's output (before any bias, as the reference). ``adapter``
    is None (off) or one block group's gathered operands {name: (a [L,
    rows, d_in, r], b [L, rows, r, d_out])} (ops/lora.gather_lanes).
    Targets absent from the pool pass through untouched."""
    if adapter is None or name not in adapter:
        return y
    a_sel, b_sel = adapter[name]
    return y + lane_delta(x_in, a_sel[layer_idx], b_sel[layer_idx], ad)


def _attention_block(cfg, p, layer_idx, x, positions, mask, layer_cache,
                     segment_ids=None, lora=None, adapter=None, tp=None,
                     partial=False):
    """The attention sublayer on the heads ``p`` holds (all of them, or a
    tensor-parallel rank's: the head counts come from the weights' widths).
    Under ``tp`` with sharded heads the rank's ``wo`` product is summed
    over the ranks before ``bo`` is added, once; ``partial`` returns it
    unsummed and without ``bo`` (the parallel block sums two sublayers'
    in one all-reduce)."""
    b, s, _ = x.shape
    ad = cfg.activation_dtype
    w = lambda name: _weight(p, "attn", name, layer_idx, lora)  # noqa: E731

    def proj(name):
        y = _adapter_delta(adapter, name, layer_idx, x,
                           _matmul(x, w(name), ad), ad)
        return _add_bias(p, "b" + name[1:], layer_idx, y, ad)

    q = proj("wq").reshape(b, s, -1, cfg.head_dim)
    k = proj("wk").reshape(b, s, -1, cfg.head_dim)
    v = proj("wv").reshape(b, s, -1, cfg.head_dim)
    if cfg.position_type == "rope":
        q = apply_rope(q, positions, cfg.rope_theta)
        k = apply_rope(k, positions, cfg.rope_theta)

    if layer_cache is not None:
        # [b, cache_len, kvh, d]; the scales [b, cache_len, kvh] or None.
        ck, cv, ck_s, cv_s, index, view = layer_cache
        cache_len = ck.shape[1]
        quantized = ck.dtype == torch.int8
        if quantized:
            # int8 KV: one f32 scale per (row, slot, kv head) beside the
            # int8 values; both are written with the same indices.
            k_w, k_s = quantize_kv(k)
            v_w, v_s = quantize_kv(v)
        else:
            k_w, v_w = k, v
        if index is None:
            # Position-scatter mode: row b token j -> slot positions[b, j].
            slot = positions.clamp(0, cache_len - 1).long()
            b_idx = torch.arange(b, device=x.device)[:, None]
            ck[b_idx, slot] = k_w
            cv[b_idx, slot] = v_w
            if quantized:
                ck_s[b_idx, slot] = k_s
                cv_s[b_idx, slot] = v_s
        else:
            # Append at index; like the reference's dynamic_update_slice,
            # a write that would run off the end is shifted back to fit.
            start = max(0, min(index, cache_len - s))
            ck[:, start:start + s] = k_w
            cv[:, start:start + s] = v_w
            if quantized:
                ck_s[:, start:start + s] = k_s
                cv_s[:, start:start + s] = v_s
        # Writes go to the full cache; attention reads only [0, view):
        # exact for any view > max query position, since slot s is
        # attended only by queries at positions >= s.
        k, v = (ck, cv) if view is None else (ck[:, :view], cv[:, :view])
        if quantized:
            # Dequantize the read view to the activation dtype; the plain
            # attention and K1 then read it as an unquantized cache.
            # (A view of None slices the whole cache.)
            k = dequantize_kv(k, ck_s[:, :view], ad)
            v = dequantize_kv(v, cv_s[:, :view], ad)
        k, v = _local_kv(tp, k, v)
        if mask is None:
            # Flash cached prefill: cache slot i holds position i, so the
            # kernel's causal-by-position masking is the plain mask. Block
            # skip stays off: query rows start mid-cache.
            kv_pos = torch.arange(k.shape[1], dtype=torch.int32,
                                  device=x.device)[None, :].expand(
                                      b, k.shape[1])
            out = flash_attention(q, k, v, positions, kv_pos,
                                  block_skip=False)
        else:
            out = dot_product_attention(q, k, v, mask=mask)
    elif mask is None:
        k, v = _local_kv(tp, k, v)
        out = flash_attention(q, k, v, positions, positions, segment_ids,
                              segment_ids)
    else:
        k, v = _local_kv(tp, k, v)
        out = dot_product_attention(q, k, v, mask=mask)
    out = out.reshape(b, s, -1)
    out = _adapter_delta(adapter, "wo", layer_idx, out,
                         _matmul(out, w("wo"), ad), ad)
    if tp is not None and tp.plan.heads:
        if partial:
            return out
        out = tp.all_reduce(out)
    return _add_bias(p, "bo", layer_idx, out, ad)


def _local_kv(tp, k: torch.Tensor, v: torch.Tensor):
    """A tensor-parallel rank whose q heads read its kv heads in a
    non-uniform map (q heads shard, kv heads replicate, and the count
    splits a kv head's group): the kv heads repeated, one per local q
    head, so the attention's (and K1's) uniform ``h // n_rep`` map holds
    with n_rep 1. Unchanged otherwise."""
    idx = None if tp is None else tp.kv_index(k.device)
    if idx is None:
        return k, v
    return k.index_select(2, idx), v.index_select(2, idx)


def _mlp_block(cfg, p, layer_idx, x, lora=None, adapter=None, tp=None,
               partial=False):
    """The gated MLP (act(x Wg + bg) * (x Wu + bu)) or the plain one
    (act(x Wi + bi)), then Wo + bo; each bias after its delta. Under
    ``tp`` with a sharded MLP the rank's Wo product is summed over the
    ranks before bo, as in _attention_block (``partial`` likewise)."""
    ad = cfg.activation_dtype
    w = lambda name: _weight(p, "mlp", name, layer_idx, lora)  # noqa: E731

    def proj(y, name):
        out = _adapter_delta(adapter, name, layer_idx, y,
                             _matmul(y, w(name), ad), ad)
        return _add_bias(p, "b" + name[1:], layer_idx, out, ad)

    if cfg.gated_mlp:
        hidden = _activation(cfg, proj(x, "wi_gate")) * proj(x, "wi_up")
    else:
        hidden = _activation(cfg, proj(x, "wi"))
    if tp is not None and tp.plan.mlp:
        out = _adapter_delta(adapter, "wo", layer_idx, hidden,
                             _matmul(hidden, w("wo"), ad), ad)
        if partial:
            return out
        return _add_bias(p, "bo", layer_idx, tp.all_reduce(out), ad)
    return proj(hidden, "wo")


def _ffn_block(cfg, layers, layer_idx, x, lora=None, adapter=None, tp=None,
               partial=False):
    """The dense MLP or, under ``moe_num_experts``, the routed experts of
    layer ``layer_idx`` (under ``tp`` combined over the serving group):
    (out, aux), aux None for the dense MLP."""
    if cfg.moe_num_experts:
        return moe_block(cfg, {k: w[layer_idx]
                               for k, w in layers["moe"].items()}, x, tp)
    return _mlp_block(cfg, layers["mlp"], layer_idx, x, lora, adapter, tp,
                      partial), None


def head_weight(cfg: ModelConfig, params: Params) -> torch.Tensor:
    """The [hidden, vocab] output projection: ``embed.T`` under a tied
    head (a view, so a gradient reaches the embedding), else ``head``."""
    return params["embed"].T if cfg.tie_embeddings else params["head"]


def lm_head(cfg: ModelConfig, params: Params, x: torch.Tensor,
            tp=None) -> torch.Tensor:
    """f32 logits from post-final-norm activations. The reference feeds
    activation-dtype operands to an f32-accumulating product and keeps the
    f32 result; here the operands (exactly representable) are widened to
    f32 so the logits are not rounded back to bf16. Under ``tp`` with a
    sharded vocabulary each rank's local logits are all-gathered."""
    ad = cfg.activation_dtype
    logits = torch.matmul(x.to(ad).float(),
                          head_weight(cfg, params).to(ad).float())
    if tp is not None and tp.plan.vocab:
        logits = tp.gather_vocab(logits)
    return logits


# ---------------------------------------------------------------------------
# Forward
# ---------------------------------------------------------------------------

def forward(
    cfg: ModelConfig,
    params: Params,
    tokens: torch.Tensor,                       # [b, s] int
    *,
    positions: Optional[torch.Tensor] = None,   # [b, s] absolute positions
    segment_ids: Optional[torch.Tensor] = None,  # [b, s] packed ids, 0 = pad
    cache: Optional[KVCache] = None,
    cache_view: Optional[int] = None,
    remat: bool = False,
    with_aux: bool = False,
    return_activations: bool = False,
    lora: Optional[LoraDeltas] = None,
    adapters: Optional[Tuple[Params, torch.Tensor]] = None,
    tp=None,
    fsdp=None,
) -> Tuple[torch.Tensor, Optional[KVCache]]:
    """Returns (logits [b, s, vocab] f32, updated cache or None), or with
    ``with_aux`` (logits, cache, aux): aux is the f32 sum of the layers'
    MoE load-balance losses (0.0 for a dense model).

    segment_ids (no-cache path only, as in the reference) keep packed
    documents apart: the flash kernels take them, the plain path builds
    them into its mask. remat=True recomputes each block in the backward
    and keeps what ``cfg.remat_policy`` saves (REMAT_POLICIES:
    "nothing_saveable" keeps only the block's input); "none" turns it
    off. lora merges LoRA deltas into each layer's
    weights inside its block.

    adapters (serving): (pool, lane_idx), an adapter pool
    (ops/lora.init_adapter_pool) and each row's lane [b] (-1: base only).
    Each projection the pool targets adds the row's grouped LoRA delta;
    the lanes are trash-mapped and the pool's operands gathered once per
    forward (the same lanes serve every layer).

    return_activations=True skips the head and returns the post-final-norm
    activations [b, s, hidden] in place of logits, so a caller that needs
    only a few positions (the serving prefill) applies ``lm_head`` to those
    alone instead of materializing [b, s, vocab] f32.

    With a cache: explicit positions select position-scatter writes;
    omitted positions append at cache.index. cache_view: attention reads
    only cache slots [0, cache_view); exact whenever every query position
    is < cache_view.

    tp (serving): a parallel/sharding.TensorParallel. ``params`` and the
    cache then hold one rank's shard (TensorPlan), the forward runs on
    local widths and its collectives make every rank's output the whole
    model's: hidden states all-reduced after each sharded sublayer,
    logits gathered over the vocabulary, an MoE layer's combine summed
    over the serving group (models/moe.py).

    fsdp (training): a parallel/sharding.Fsdp. ``params["layers"]`` (and
    the LoRA factors) then hold the rank's pieces, and every other leaf
    whole (``Fsdp.outer``, which the train step calls, so that the loss's
    head is the same gathered tensor). Each block gathers its layer's
    leaves first, inside its checkpoint: remat frees them and the
    recompute gathers them again; their gradients come back
    reduce-scattered."""
    check_supported(cfg)
    if cfg.moe_num_experts and fsdp is not None:
        raise NotImplementedError(
            f"config {cfg.name!r} (MoE: moe_num_experts="
            f"{cfg.moe_num_experts}) under an FSDP forward: the reference "
            "routes over the global batch, and MoE training under a mesh "
            "is not ported yet (ROADMAP.md §1 item 4)")
    if tp is not None and (lora is not None or remat):
        raise NotImplementedError(
            "a tensor-parallel forward serves: LoRA merges and remat are "
            "training paths, which run on one device")
    if fsdp is not None and (tp is not None or cache is not None
                             or adapters is not None):
        raise NotImplementedError(
            "an FSDP forward trains: tensor parallelism, a KV cache and an "
            "adapter pool are serving paths")
    if fsdp is not None and params["embed"].shape[-1] != cfg.hidden_size:
        raise ValueError("an FSDP forward takes the leaves outside the "
                         "layers whole: call Fsdp.outer(params) first")
    if cache is not None and segment_ids is not None:
        raise NotImplementedError(
            "packed sequences (segment_ids) are not supported together with "
            "a KV cache: the cache mask is positional-only")
    context_fn = None
    if remat:
        _check_remat_policy(cfg.remat_policy)
        remat = cfg.remat_policy != "none"
    if remat:
        context_fn = _remat_context_fn(cfg.remat_policy)
    name_attn_out = remat and cfg.remat_policy == "save_attn_out"
    b, s = tokens.shape
    ad = cfg.activation_dtype
    device = tokens.device
    scatter_mode = cache is not None and positions is not None
    if positions is None:
        start = cache.index if cache is not None else 0
        positions = (start + torch.arange(s, dtype=torch.int32,
                                          device=device))[None, :].expand(
                                              b, s)

    if tp is not None and tp.plan.vocab:
        x = tp.embed(params["embed"], tokens, ad)
    else:
        x = params["embed"].to(ad)[tokens]
    if cfg.embed_scale:
        # The reference multiplies by a Python float, which JAX rounds to
        # the activation dtype first; so does this.
        x = x * torch.tensor(cfg.hidden_size ** 0.5, dtype=ad)
    if cfg.position_type == "learned":
        # A JAX gather clamps an index past the table: padding parked at
        # the trash slot (max_seq_len) reads the last row, as the
        # reference's does. Positions are never negative.
        table = params["pos_embed"]
        x = x + table.to(ad)[positions.clamp(0, table.shape[0] - 1).long()]

    if cache is not None:
        max_kv = (cache_view if cache_view is not None
                  else cache.k.shape[2])
        if use_flash_cached_prefill(cfg, s, device):
            mask = None
        else:
            # Slots past a query's position are future or unwritten; the
            # causal comparison masks both.
            kv_positions = torch.arange(max_kv, dtype=torch.int32,
                                        device=device)[None, :].expand(
                                            b, max_kv)
            mask = make_attention_mask(positions, kv_positions, causal=True)
    elif resolve_attention_impl(cfg, device) == "flash":
        mask = None
    else:
        mask = make_attention_mask(positions, positions, segment_ids,
                                   segment_ids, causal=True)

    rows = {}
    if adapters is not None:
        pool, lane_idx = adapters
        rows = gather_lanes(pool, map_lane_indices(
            torch.as_tensor(lane_idx, device=device), pool_lanes(pool)))

    # A tensor-parallel parallel block whose two sublayers both shard sums
    # their partial products in one all-reduce.
    fused = (tp is not None and cfg.parallel_block and tp.plan.heads
             and tp.plan.mlp and not cfg.moe_num_experts)

    def block(x, li, layer_cache):
        layers, lora_l = params["layers"], lora
        if fsdp is not None:
            # This layer's leaves whole, as one-layer stacks.
            layers, lora_l = fsdp.layer(layers, lora, li)
            li = 0
        h1 = _norm(cfg, layers["ln1"], x, li)
        attn_out = _attention_block(cfg, layers["attn"], li, h1, positions,
                                    mask, layer_cache, segment_ids, lora_l,
                                    rows.get("attn"), tp, fused)
        if name_attn_out:
            attn_out = checkpoint_name(attn_out, "attn_out")
        if cfg.parallel_block:
            # Falcon: attention and MLP read the same input, through one
            # shared norm (7b) or their own (40b's ln_attn / ln_mlp).
            h2 = (h1 if cfg.shared_layer_norm
                  else _norm(cfg, layers["ln2"], x, li))
            mlp_out, aux = _ffn_block(cfg, layers, li, h2, lora_l,
                                      rows.get("mlp"), tp, fused)
            if fused:
                out = tp.all_reduce(attn_out + mlp_out)
                out = _add_bias(layers["attn"], "bo", li, out, ad)
                return x + _add_bias(layers["mlp"], "bo", li, out, ad), aux
            return x + attn_out + mlp_out, aux
        x = x + attn_out
        h2 = _norm(cfg, layers["ln2"], x, li)
        ffn_out, aux = _ffn_block(cfg, layers, li, h2, lora_l,
                                  rows.get("mlp"), tp)
        return x + ffn_out, aux

    aux_total = None
    for li in range(cfg.num_layers):
        layer_cache = None
        if cache is not None:
            scales = ((cache.k_scale[li], cache.v_scale[li])
                      if cache.quantized else (None, None))
            layer_cache = (cache.k[li], cache.v[li], *scales,
                           None if scatter_mode else cache.index, cache_view)
        if context_fn is not None:
            x, aux = checkpoint(block, x, li, layer_cache,
                                use_reentrant=False, context_fn=context_fn)
        elif remat:
            x, aux = checkpoint(block, x, li, layer_cache,
                                use_reentrant=False)
        else:
            x, aux = block(x, li, layer_cache)
        if aux is not None:
            aux_total = aux if aux_total is None else aux_total + aux

    new_cache = None
    if cache is not None:
        new_cache = KVCache(k=cache.k, v=cache.v,
                            index=cache.index if scatter_mode
                            else cache.index + s,
                            k_scale=cache.k_scale, v_scale=cache.v_scale)
    x = _norm(cfg, params["final_norm"], x)
    out = x if return_activations else lm_head(cfg, params, x, tp)
    if with_aux:
        if aux_total is None:
            aux_total = torch.zeros((), dtype=torch.float32, device=device)
        return out, new_cache, aux_total
    return out, new_cache
