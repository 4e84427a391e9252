"""Model architecture configs (the port's own copy of
``runbooks_tpu.models.config``).

Same ``ModelConfig`` fields and the same ``CONFIGS`` registry, so a config
name or override means the same model in both packages. Dtype strings map
to torch dtypes. Fields this slice of the port does not act on (MoE,
quantization, the LoRA pool, mesh and training knobs) stay as inert
fields; ``models.transformer.check_supported`` rejects a config that
needs an architecture feature the port's forward does not implement yet.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch

_DTYPES = {
    "float32": torch.float32,
    "bfloat16": torch.bfloat16,
    "float16": torch.float16,
}


def torch_dtype(name: str) -> torch.dtype:
    if name not in _DTYPES:
        raise ValueError(f"unknown dtype {name!r}; expected one of "
                         f"{sorted(_DTYPES)}")
    return _DTYPES[name]


# Speculative decoding on the serving decode path (serve/engine.py): "off"
# or "ngram" (prompt-lookup drafting and one batched verify forward).
SPECULATIVE_MODES = ("off", "ngram")


def check_speculative(mode: str) -> str:
    """Validate a speculative mode string (the engine's one error message
    for a mode it does not know)."""
    mode = str(mode)
    if mode not in SPECULATIVE_MODES:
        raise ValueError(
            f"unknown speculative {mode!r}; expected "
            f"{'|'.join(SPECULATIVE_MODES)}")
    return mode


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    """Architecture hyperparameters for a decoder-only transformer."""

    name: str = "custom"
    vocab_size: int = 32000
    hidden_size: int = 4096
    intermediate_size: int = 11008
    num_layers: int = 32
    num_heads: int = 32
    num_kv_heads: int = 32            # < num_heads => GQA; == 1 => MQA
    head_dim: int = 128
    max_seq_len: int = 4096

    # Normalization
    norm_type: str = "rmsnorm"        # "rmsnorm" | "layernorm"
    norm_eps: float = 1e-5

    # MLP
    gated_mlp: bool = True
    activation: str = "silu"          # "silu" | "gelu" | "relu"
    mlp_bias: bool = False

    # Mixture of Experts (not ported yet)
    moe_num_experts: int = 0
    moe_top_k: int = 2
    moe_capacity_factor: float = 1.25
    moe_aux_coef: float = 0.01

    # Attention
    attn_bias: bool = False
    qk_norm: bool = False
    logit_softcap: Optional[float] = None

    # Positional encoding
    position_type: str = "rope"       # "rope" | "alibi" | "learned"
    rope_theta: float = 10000.0

    # Block structure
    parallel_block: bool = False
    shared_layer_norm: bool = True

    # Embeddings / head
    tie_embeddings: bool = False
    embed_scale: bool = False

    # "auto" picks the hand-written flash kernel on CUDA and the plain
    # attention elsewhere; "xla" (the reference's name for the plain path)
    # and "flash" force one. "ring" needs a mesh, which is not ported.
    attention_impl: str = "auto"
    # Tile hints of the TPU kernel, kept inert: the Hopper kernel and its
    # plain version use their own tiles (ops/flash_attention.py).
    flash_block_q: int = 512
    flash_block_k: int = 1024

    ring_flash_inner: Optional[bool] = None
    collective_matmul: str = "off"
    collective_matmul_bidirectional: bool = True
    embed_one_hot: Optional[bool] = None

    # Dtypes
    dtype: str = "bfloat16"           # activation dtype
    param_dtype: str = "float32"      # master param dtype

    quantize: str = "none"
    quantize_kv: Optional[bool] = None
    speculative: str = "off"
    draft_tokens: Optional[int] = None
    ngram_max: int = 3
    ngram_min: int = 1
    adapter_pool: int = 0
    lora_rank: int = 8
    lora_targets: tuple = ("attn.wq", "attn.wk", "attn.wv", "attn.wo")
    remat_policy: str = "nothing_saveable"
    pipeline_microbatches: int = 0
    pipeline_schedule: str = "1f1b"

    @property
    def activation_dtype(self) -> torch.dtype:
        return torch_dtype(self.dtype)

    @property
    def parameter_dtype(self) -> torch.dtype:
        return torch_dtype(self.param_dtype)

    @property
    def q_dim(self) -> int:
        return self.num_heads * self.head_dim

    @property
    def kv_dim(self) -> int:
        return self.num_kv_heads * self.head_dim

    @property
    def num_params(self) -> int:
        """Parameter count (embedding included once if tied)."""
        h, v = self.hidden_size, self.vocab_size
        embed = v * h
        head = 0 if self.tie_embeddings else v * h
        pos = self.max_seq_len * h if self.position_type == "learned" else 0
        attn = h * self.q_dim + 2 * h * self.kv_dim + self.q_dim * h
        if self.attn_bias:
            attn += self.q_dim + 2 * self.kv_dim + h
        mlp_mats = (2 if self.gated_mlp else 1) * h * self.intermediate_size
        mlp_mats += self.intermediate_size * h
        if self.mlp_bias:
            mlp_mats += ((2 if self.gated_mlp else 1) * self.intermediate_size
                         + h)
        if self.moe_num_experts:
            mlp_mats = (self.moe_num_experts * mlp_mats
                        + h * self.moe_num_experts)
        norms_per_layer = (h if (self.parallel_block
                                 and self.shared_layer_norm) else 2 * h)
        if self.norm_type == "layernorm":
            norms_per_layer *= 2
        per_layer = attn + mlp_mats + norms_per_layer
        final_norm = h * (2 if self.norm_type == "layernorm" else 1)
        return embed + head + pos + self.num_layers * per_layer + final_norm

    def flops_per_token(self, seq_len: Optional[int] = None) -> float:
        """Forward-pass matmul FLOPs per token (2*N plus the attention
        quadratic); a training step counts 3x this for MFU."""
        s = seq_len or self.max_seq_len
        h = self.hidden_size
        attn_proj = 2 * (h * self.q_dim + 2 * h * self.kv_dim
                         + self.q_dim * h)
        attn_scores = 2 * 2 * s * self.q_dim
        mlp = 2 * ((2 if self.gated_mlp else 1) * h * self.intermediate_size
                   + self.intermediate_size * h)
        if self.moe_num_experts:
            mlp = mlp * self.moe_top_k + 2 * h * self.moe_num_experts
        per_layer = attn_proj + attn_scores + mlp
        return float(self.num_layers * per_layer + 2 * h * self.vocab_size)


def _llama(name, v=32000, h=4096, i=11008, l=32, q=32, kv=32, d=128, s=4096,
           theta=10000.0):
    return ModelConfig(
        name=name, vocab_size=v, hidden_size=h, intermediate_size=i,
        num_layers=l, num_heads=q, num_kv_heads=kv, head_dim=d, max_seq_len=s,
        norm_type="rmsnorm", norm_eps=1e-5, gated_mlp=True, activation="silu",
        position_type="rope", rope_theta=theta,
    )


def _falcon(name, v=65024, h=4544, l=32, q=71, kv=71, s=2048):
    return ModelConfig(
        name=name, vocab_size=v, hidden_size=h, intermediate_size=4 * h,
        num_layers=l, num_heads=q, num_kv_heads=kv, head_dim=h // q,
        max_seq_len=s, norm_type="layernorm", norm_eps=1e-5, gated_mlp=False,
        activation="gelu", position_type="rope", parallel_block=True,
        tie_embeddings=True,
    )


def _opt(name, v=50272, h=768, i=3072, l=12, q=12, s=2048):
    return ModelConfig(
        name=name, vocab_size=v, hidden_size=h, intermediate_size=i,
        num_layers=l, num_heads=q, num_kv_heads=q, head_dim=h // q,
        max_seq_len=s, norm_type="layernorm", norm_eps=1e-5, gated_mlp=False,
        activation="relu", position_type="learned", attn_bias=True,
        mlp_bias=True, tie_embeddings=True,
    )


def _gemma(name, v=256000, h=2048, i=16384, l=18, q=8, kv=1, d=256, s=8192):
    return ModelConfig(
        name=name, vocab_size=v, hidden_size=h, intermediate_size=i,
        num_layers=l, num_heads=q, num_kv_heads=kv, head_dim=d,
        max_seq_len=s, norm_type="rmsnorm", norm_eps=1e-6, gated_mlp=True,
        activation="gelu", position_type="rope", tie_embeddings=True,
        embed_scale=True,
    )


def _gpt2(name, v=50257, h=768, i=3072, l=12, q=12, s=1024):
    return ModelConfig(
        name=name, vocab_size=v, hidden_size=h, intermediate_size=i,
        num_layers=l, num_heads=q, num_kv_heads=q, head_dim=h // q,
        max_seq_len=s, norm_type="layernorm", norm_eps=1e-5, gated_mlp=False,
        activation="gelu", position_type="learned", attn_bias=True,
        mlp_bias=True, tie_embeddings=True,
    )


# The same registry as runbooks_tpu.models.config.CONFIGS.
CONFIGS = {
    "llama2-7b": _llama("llama2-7b"),
    "llama2-13b": _llama("llama2-13b", h=5120, i=13824, l=40, q=40, kv=40,
                         d=128),
    "llama2-70b": _llama("llama2-70b", h=8192, i=28672, l=80, q=64, kv=8,
                         d=128),
    "llama3-8b": _llama("llama3-8b", v=128256, h=4096, i=14336, l=32, q=32,
                        kv=8, d=128, s=8192, theta=500000.0),
    "falcon-7b": _falcon("falcon-7b", kv=1),
    "falcon-40b": dataclasses.replace(
        _falcon("falcon-40b", h=8192, l=60, q=128, kv=8),
        shared_layer_norm=False),
    "opt-125m": _opt("opt-125m"),
    "opt-1.3b": _opt("opt-1.3b", h=2048, i=8192, l=24, q=32),
    "mixtral-8x7b": dataclasses.replace(
        _llama("mixtral-8x7b", v=32000, h=4096, i=14336, l=32, q=32, kv=8,
               d=128, s=32768, theta=1e6),
        moe_num_experts=8, moe_top_k=2),
    "gemma-2b": _gemma("gemma-2b"),
    "gemma-7b": _gemma("gemma-7b", h=3072, i=24576, l=28, q=16, kv=16),
    "gpt2": _gpt2("gpt2"),
    "gpt2-xl": _gpt2("gpt2-xl", h=1600, i=6400, l=48, q=25),
    "debug": _llama("debug", v=512, h=128, i=384, l=2, q=4, kv=2, d=32, s=256),
    "bench-1b": _llama("bench-1b", h=2048, i=5632, l=22, q=16, kv=16, d=128,
                       s=2048),
    "bench-410m": _llama("bench-410m", h=1024, i=2816, l=24, q=16, kv=16,
                         d=64, s=2048),
    "bench-410m-d128": _llama("bench-410m-d128", h=1024, i=2816, l=24, q=8,
                              kv=8, d=128, s=2048),
}


def get_config(name: str, **overrides) -> ModelConfig:
    if name not in CONFIGS:
        raise KeyError(
            f"unknown model config {name!r}; known: {sorted(CONFIGS)}")
    cfg = CONFIGS[name]
    return dataclasses.replace(cfg, **overrides) if overrides else cfg
