"""Decoder-only transformer over a params dict (the port of
``runbooks_tpu.models.transformer``, dense Llama-family path).

- Params keep the reference's layout: {"embed", "final_norm", "head",
  "layers": {...stacked [L, ...] tensors...}}; the forward loops over the
  leading layer axis where the reference scans it.
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
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional, Tuple

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from runbooks_tpu_torch.models.config import ModelConfig
from runbooks_tpu_torch.ops.attention import (
    dot_product_attention,
    make_attention_mask,
)
from runbooks_tpu_torch.ops.flash_attention import flash_attention
from runbooks_tpu_torch.ops.norms import rms_norm
from runbooks_tpu_torch.ops.rotary import apply_rope

Params = Dict[str, Any]

# Flash cached-prefill pays off once the query block is at least one tile;
# below this the plain path's mask build is noise anyway.
FLASH_CACHED_PREFILL_MIN_Q = 16


def check_supported(cfg: ModelConfig) -> None:
    """Reject a config that needs a feature the port's forward does not
    implement yet (the dense Llama-family path is ported; the rest waits
    for later slices, see ROADMAP.md)."""
    wanted = {
        "norm_type": "rmsnorm", "gated_mlp": True, "activation": "silu",
        "mlp_bias": False, "moe_num_experts": 0, "attn_bias": False,
        "qk_norm": False, "logit_softcap": None, "position_type": "rope",
        "parallel_block": False, "tie_embeddings": False,
        "embed_scale": False, "quantize": "none",
    }
    bad = {k: getattr(cfg, k) for k, v in wanted.items()
           if getattr(cfg, k) != v}
    if bad:
        raise NotImplementedError(
            f"config {cfg.name!r} needs {bad}, which the PyTorch port does "
            f"not implement yet")


# ---------------------------------------------------------------------------
# Initialization
# ---------------------------------------------------------------------------

def init_params(cfg: ModelConfig, generator: torch.Generator,
                device: torch.device) -> Params:
    """Random-init parameters (stacked layers) on ``device`` from a seeded
    generator on that device. Same shapes, scales and layout as the
    reference's init_params; the numbers differ (another RNG), so tests
    carry the reference's weights over with models/bridge.py."""
    check_supported(cfg)
    h, v, L = cfg.hidden_size, cfg.vocab_size, cfg.num_layers
    m = cfg.intermediate_size
    pd = cfg.parameter_dtype

    def normal(shape, scale):
        x = torch.randn(shape, generator=generator, device=device, dtype=pd)
        return x.mul_(scale)

    def ones(shape):
        return torch.ones(shape, dtype=pd, device=device)

    return {
        "embed": normal((v, h), h ** -0.5),
        "final_norm": {"scale": ones((h,))},
        "head": normal((h, v), h ** -0.5),
        "layers": {
            "attn": {
                "wq": normal((L, h, cfg.q_dim), h ** -0.5),
                "wk": normal((L, h, cfg.kv_dim), h ** -0.5),
                "wv": normal((L, h, cfg.kv_dim), h ** -0.5),
                "wo": normal((L, cfg.q_dim, h), cfg.q_dim ** -0.5),
            },
            "ln1": {"scale": ones((L, h))},
            "mlp": {
                "wi_gate": normal((L, h, m), h ** -0.5),
                "wi_up": normal((L, h, m), h ** -0.5),
                "wo": normal((L, m, h), m ** -0.5),
            },
            "ln2": {"scale": ones((L, h))},
        },
    }


# ---------------------------------------------------------------------------
# KV cache
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class KVCache:
    """Per-model KV cache, layers stacked on the leading axis.

    k, v: [num_layers, batch, cache_len, num_kv_heads, head_dim]
    index: tokens already written (the same for the whole batch). Two write
    modes in ``forward``:

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

    @classmethod
    def create(cls, cfg: ModelConfig, batch: int, max_len: int,
               device: torch.device, trash_slot: bool = False) -> "KVCache":
        cache_len = max_len + 1 if trash_slot else max_len
        shape = (cfg.num_layers, batch, cache_len, cfg.num_kv_heads,
                 cfg.head_dim)
        return cls(
            k=torch.zeros(shape, dtype=cfg.activation_dtype, device=device),
            v=torch.zeros(shape, dtype=cfg.activation_dtype, device=device),
            index=0)


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

def _matmul(x: torch.Tensor, w: torch.Tensor, ad: torch.dtype):
    return torch.matmul(x, w.to(ad))


# Remat policies of the reference (models/transformer.py:_remat_policy)
# that the port does not implement yet.
REMAT_POLICIES_TO_PORT = ("dots_saveable",
                          "dots_with_no_batch_dims_saveable",
                          "save_attn_out")


def _check_remat_policy(name: str) -> None:
    if name in REMAT_POLICIES_TO_PORT:
        raise NotImplementedError(
            f"remat_policy {name!r} is not ported yet; the port has "
            "'nothing_saveable' and 'none'")
    if name not in ("nothing_saveable", "none"):
        raise ValueError(f"unknown remat_policy {name!r}; expected none|"
                         f"nothing_saveable|{'|'.join(REMAT_POLICIES_TO_PORT)}")


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
        ab = torch.matmul(f["a"][layer_idx].float(),
                          f["b"][layer_idx].float())
        return (w[layer_idx].float() + self.scale * ab).to(w.dtype)


def _weight(p, group, name, layer_idx, lora):
    w = p[name]
    if lora is None:
        return w[layer_idx]
    return lora.weight(f"{group}.{name}", w, layer_idx)


def _attention_block(cfg, p, layer_idx, x, positions, mask, layer_cache,
                     segment_ids=None, lora=None):
    b, s, _ = x.shape
    ad = cfg.activation_dtype
    w = lambda name: _weight(p, "attn", name, layer_idx, lora)  # noqa: E731
    q = _matmul(x, w("wq"), ad).reshape(b, s, cfg.num_heads, cfg.head_dim)
    k = _matmul(x, w("wk"), ad).reshape(b, s, cfg.num_kv_heads, cfg.head_dim)
    v = _matmul(x, w("wv"), ad).reshape(b, s, cfg.num_kv_heads, cfg.head_dim)
    q = apply_rope(q, positions, cfg.rope_theta)
    k = apply_rope(k, positions, cfg.rope_theta)

    if layer_cache is not None:
        ck, cv, index, view = layer_cache      # [b, cache_len, kvh, d]
        cache_len = ck.shape[1]
        if index is None:
            # Position-scatter mode: row b token j -> slot positions[b, j].
            slot = positions.clamp(0, cache_len - 1).long()
            b_idx = torch.arange(b, device=x.device)[:, None]
            ck[b_idx, slot] = k
            cv[b_idx, slot] = v
        else:
            # Append at index; like the reference's dynamic_update_slice,
            # a write that would run off the end is shifted back to fit.
            start = max(0, min(index, cache_len - s))
            ck[:, start:start + s] = k
            cv[:, start:start + s] = v
        # Writes go to the full cache; attention reads only [0, view):
        # exact for any view > max query position, since slot s is
        # attended only by queries at positions >= s.
        k, v = (ck, cv) if view is None else (ck[:, :view], cv[:, :view])
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
        out = flash_attention(q, k, v, positions, positions, segment_ids,
                              segment_ids)
    else:
        out = dot_product_attention(q, k, v, mask=mask)
    out = out.reshape(b, s, cfg.q_dim)
    return _matmul(out, w("wo"), ad)


def _mlp_block(cfg, p, layer_idx, x, lora=None):
    ad = cfg.activation_dtype
    w = lambda name: _weight(p, "mlp", name, layer_idx, lora)  # noqa: E731
    gate = _matmul(x, w("wi_gate"), ad)
    up = _matmul(x, w("wi_up"), ad)
    return _matmul(F.silu(gate) * up, w("wo"), ad)


def lm_head(cfg: ModelConfig, params: Params,
            x: torch.Tensor) -> torch.Tensor:
    """f32 logits from post-final-norm activations. The reference feeds
    activation-dtype operands to an f32-accumulating product and keeps the
    f32 result; here the operands (exactly representable) are widened to
    f32 so the logits are not rounded back to bf16."""
    ad = cfg.activation_dtype
    return torch.matmul(x.to(ad).float(), params["head"].to(ad).float())


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
    return_activations: bool = False,
    lora: Optional[LoraDeltas] = None,
) -> Tuple[torch.Tensor, Optional[KVCache]]:
    """Returns (logits [b, s, vocab] f32, updated cache or None).

    segment_ids (no-cache path only, as in the reference) keep packed
    documents apart: the flash kernels take them, the plain path builds
    them into its mask. remat=True recomputes each block in the backward
    (``cfg.remat_policy`` "nothing_saveable": only the block's input is
    kept); "none" turns it off. lora merges LoRA deltas into each layer's
    weights inside its block.

    return_activations=True skips the head and returns the post-final-norm
    activations [b, s, hidden] in place of logits, so a caller that needs
    only a few positions (the serving prefill) applies ``lm_head`` to those
    alone instead of materializing [b, s, vocab] f32.

    With a cache: explicit positions select position-scatter writes;
    omitted positions append at cache.index. cache_view: attention reads
    only cache slots [0, cache_view); exact whenever every query position
    is < cache_view."""
    check_supported(cfg)
    if cache is not None and segment_ids is not None:
        raise NotImplementedError(
            "packed sequences (segment_ids) are not supported together with "
            "a KV cache: the cache mask is positional-only")
    if remat:
        _check_remat_policy(cfg.remat_policy)
        remat = cfg.remat_policy != "none"
    b, s = tokens.shape
    ad = cfg.activation_dtype
    device = tokens.device
    scatter_mode = cache is not None and positions is not None
    if positions is None:
        start = cache.index if cache is not None else 0
        positions = (start + torch.arange(s, dtype=torch.int32,
                                          device=device))[None, :].expand(
                                              b, s)

    x = params["embed"].to(ad)[tokens]

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

    layers = params["layers"]

    def block(x, li, layer_cache):
        h1 = rms_norm(x, layers["ln1"]["scale"][li], cfg.norm_eps)
        x = x + _attention_block(cfg, layers["attn"], li, h1, positions,
                                 mask, layer_cache, segment_ids, lora)
        h2 = rms_norm(x, layers["ln2"]["scale"][li], cfg.norm_eps)
        return x + _mlp_block(cfg, layers["mlp"], li, h2, lora)

    for li in range(cfg.num_layers):
        layer_cache = None
        if cache is not None:
            layer_cache = (cache.k[li], cache.v[li],
                           None if scatter_mode else cache.index, cache_view)
        if remat:
            x = checkpoint(block, x, li, layer_cache, use_reentrant=False)
        else:
            x = block(x, li, layer_cache)

    new_cache = None
    if cache is not None:
        new_cache = KVCache(k=cache.k, v=cache.v,
                            index=cache.index if scatter_mode
                            else cache.index + s)
    x = rms_norm(x, params["final_norm"]["scale"], cfg.norm_eps)
    if return_activations:
        return x, new_cache
    return lm_head(cfg, params, x), new_cache
