"""HF checkpoint conversion: state dict -> the port's param tree (the port
of ``runbooks_tpu.models.convert``: the llama, falcon, opt and gpt2
families).

HF keeps each linear layer as ``[out, in]`` per layer (GPT-2's Conv1D as
``[in, out]``); the port keeps the reference's stacked ``[L, in, out]``
layout (models/bridge.py ``expected_shapes``). HF's rotate_half RoPE is
the port's split-half RoPE, so the weights transpose directly. Falcon's
fused ``query_key_value`` is unfused as ``[nkv, rep + 2, d, h]`` (the 7b
multi-query layout and the 40b grouped one alike); OPT's learned
positions drop HF's first 2 rows; GPT-2's fused ``c_attn`` splits three
ways by columns. Each stacked tensor is allocated once in ``dtype`` and
filled layer by layer, so an import never holds a list of per-layer
copies beside the stack (at 8B in f32 a list plus its stack is twice the
model). A cast here rounds as numpy's ``astype`` does (to nearest, ties to
even), so the result equals the reference's bit for bit. With
``quantize`` int8/int4 the attention and MLP matrices go straight into
their packed form layer by layer (ops/quantization.quantize_stack): each
layer is cast to ``dtype`` and quantized as the reference's
quantize-after-convert does, so the codes and scales equal its, and the
import never holds the full-precision stack of a quantized weight.
Biases, norms, embeddings and positions stay in ``dtype``.
"""

from __future__ import annotations

from typing import Callable, Dict, Mapping, Optional

import torch

from runbooks_tpu_torch.models.config import ModelConfig, torch_dtype
from runbooks_tpu_torch.ops.quantization import (
    QUANTIZE_MODES,
    mode_bits,
    quantize_stack,
)

StateDict = Mapping[str, torch.Tensor]
Layer = Callable[[int], torch.Tensor]

# The reference's converter families, in its lookup order (mixtral and
# gemma before llama: their names and keys extend llama's). mixtral and
# gemma wait for their forward features (MoE; head_dim 256 and the
# embedding scale).
FAMILIES = ("mixtral", "gemma", "gpt2", "llama", "falcon", "opt")
NOT_PORTED = {"mixtral": "MoE (models/moe.py)",
              "gemma": "head_dim 256 in the kernels and embed_scale"}


class _Stacker:
    """Casts and stacks into ``dtype``; ``matrix`` stacks quantize when
    the import asks for it."""

    def __init__(self, cfg: ModelConfig, dtype: torch.dtype, quantize: str):
        self.L = cfg.num_layers
        self.dtype = dtype
        self.quantize = quantize

    def cast(self, w: torch.Tensor) -> torch.Tensor:
        return torch.empty(w.shape, dtype=self.dtype).copy_(w)

    def stack(self, layer: Layer) -> torch.Tensor:
        """[L, ...] of layer(i), preallocated once."""
        first = layer(0)
        out = torch.empty((self.L, *first.shape), dtype=self.dtype)
        out[0].copy_(first)
        for i in range(1, self.L):
            out[i].copy_(layer(i))
        return out

    def matrix(self, layer: Layer):
        """A quantizable [L, in, out] stack: packed layer by layer when
        quantizing, else as ``stack``."""
        if self.quantize != "none":
            return quantize_stack(lambda i: self.cast(layer(i)), self.L,
                                  mode_bits(self.quantize))
        return self.stack(layer)

    def norm(self, scale: Layer, bias: Layer) -> Dict:
        return {"scale": self.stack(scale), "bias": self.stack(bias)}


def convert_llama(cfg: ModelConfig, sd: StateDict, dtype: torch.dtype,
                  quantize: str = "none") -> Dict:
    st = _Stacker(cfg, dtype, quantize)
    g = lambda name: lambda i: sd[f"model.layers.{i}.{name}"]  # noqa: E731
    t = lambda name: lambda i: sd[f"model.layers.{i}.{name}"].T  # noqa: E731

    params = {
        "embed": st.cast(sd["model.embed_tokens.weight"]),
        "final_norm": {"scale": st.cast(sd["model.norm.weight"])},
        "layers": {
            "attn": {
                "wq": st.matrix(t("self_attn.q_proj.weight")),
                "wk": st.matrix(t("self_attn.k_proj.weight")),
                "wv": st.matrix(t("self_attn.v_proj.weight")),
                "wo": st.matrix(t("self_attn.o_proj.weight")),
            },
            "mlp": {
                "wi_gate": st.matrix(t("mlp.gate_proj.weight")),
                "wi_up": st.matrix(t("mlp.up_proj.weight")),
                "wo": st.matrix(t("mlp.down_proj.weight")),
            },
            "ln1": {"scale": st.stack(g("input_layernorm.weight"))},
            "ln2": {"scale": st.stack(g("post_attention_layernorm.weight"))},
        },
    }
    if not cfg.tie_embeddings:
        head = sd.get("lm_head.weight")
        params["head"] = st.cast((head if head is not None
                                  else sd["model.embed_tokens.weight"]).T)
    return params


def convert_falcon(cfg: ModelConfig, sd: StateDict, dtype: torch.dtype,
                   quantize: str = "none") -> Dict:
    """Falcon: the fused query_key_value [(nkv (rep + 2)) d, h] holds, per
    kv head, its rep query heads, then its key, then its value; a parallel
    block with one shared input_layernorm (7b) or ln_attn / ln_mlp
    (40b); a tied head and no biases."""
    st = _Stacker(cfg, dtype, quantize)
    h, d = cfg.hidden_size, cfg.head_dim
    nq, nkv = cfg.num_heads, cfg.num_kv_heads
    rep = nq // nkv
    g = lambda name: lambda i: sd[f"transformer.h.{i}.{name}"]  # noqa: E731
    t = lambda name: lambda i: sd[f"transformer.h.{i}.{name}"].T  # noqa: E731

    def qkv(i, part):
        w = sd[f"transformer.h.{i}.self_attention.query_key_value.weight"]
        w = w.reshape(nkv, rep + 2, d, h)
        if part == "q":
            return w[:, :rep].reshape(nq * d, h).T
        return w[:, rep if part == "k" else rep + 1].reshape(nkv * d, h).T

    layers: Dict = {
        "attn": {
            "wq": st.matrix(lambda i: qkv(i, "q")),
            "wk": st.matrix(lambda i: qkv(i, "k")),
            "wv": st.matrix(lambda i: qkv(i, "v")),
            "wo": st.matrix(t("self_attention.dense.weight")),
        },
        "mlp": {
            "wi": st.matrix(t("mlp.dense_h_to_4h.weight")),
            "wo": st.matrix(t("mlp.dense_4h_to_h.weight")),
        },
    }
    if cfg.shared_layer_norm:
        layers["ln1"] = st.norm(g("input_layernorm.weight"),
                                g("input_layernorm.bias"))
    else:
        layers["ln1"] = st.norm(g("ln_attn.weight"), g("ln_attn.bias"))
        layers["ln2"] = st.norm(g("ln_mlp.weight"), g("ln_mlp.bias"))
    return {
        "embed": st.cast(sd["transformer.word_embeddings.weight"]),
        "final_norm": {"scale": st.cast(sd["transformer.ln_f.weight"]),
                       "bias": st.cast(sd["transformer.ln_f.bias"])},
        "layers": layers,
    }


def convert_opt(cfg: ModelConfig, sd: StateDict, dtype: torch.dtype,
                quantize: str = "none") -> Dict:
    """OPT (pre-LN): learned positions with HF's 2-row offset dropped,
    biases everywhere, a relu MLP (fc1, fc2), a tied head."""
    st = _Stacker(cfg, dtype, quantize)
    pre = "model.decoder"
    g = lambda name: lambda i: sd[f"{pre}.layers.{i}.{name}"]  # noqa: E731
    t = lambda name: lambda i: sd[f"{pre}.layers.{i}.{name}"].T  # noqa: E731
    return {
        "embed": st.cast(sd[f"{pre}.embed_tokens.weight"]),
        "pos_embed": st.cast(sd[f"{pre}.embed_positions.weight"][2:]),
        "final_norm": {"scale": st.cast(sd[f"{pre}.final_layer_norm.weight"]),
                       "bias": st.cast(sd[f"{pre}.final_layer_norm.bias"])},
        "layers": {
            "attn": {
                "wq": st.matrix(t("self_attn.q_proj.weight")),
                "wk": st.matrix(t("self_attn.k_proj.weight")),
                "wv": st.matrix(t("self_attn.v_proj.weight")),
                "wo": st.matrix(t("self_attn.out_proj.weight")),
                "bq": st.stack(g("self_attn.q_proj.bias")),
                "bk": st.stack(g("self_attn.k_proj.bias")),
                "bv": st.stack(g("self_attn.v_proj.bias")),
                "bo": st.stack(g("self_attn.out_proj.bias")),
            },
            "mlp": {
                "wi": st.matrix(t("fc1.weight")),
                "bi": st.stack(g("fc1.bias")),
                "wo": st.matrix(t("fc2.weight")),
                "bo": st.stack(g("fc2.bias")),
            },
            "ln1": st.norm(g("self_attn_layer_norm.weight"),
                           g("self_attn_layer_norm.bias")),
            "ln2": st.norm(g("final_layer_norm.weight"),
                           g("final_layer_norm.bias")),
        },
    }


def convert_gpt2(cfg: ModelConfig, sd: StateDict, dtype: torch.dtype,
                 quantize: str = "none") -> Dict:
    """GPT-2: Conv1D weights are already [in, out] (no transpose), the
    fused c_attn [h, 3h] (and its bias) splits by columns into q, k, v,
    and the learned positions have no row offset."""
    st = _Stacker(cfg, dtype, quantize)
    h = cfg.hidden_size
    g = lambda name: lambda i: sd[f"transformer.h.{i}.{name}"]  # noqa: E731

    def split(name, j):
        return lambda i: sd[f"transformer.h.{i}.attn.c_attn.{name}"][
            ..., j * h:(j + 1) * h]

    return {
        "embed": st.cast(sd["transformer.wte.weight"]),
        "pos_embed": st.cast(sd["transformer.wpe.weight"]),
        "final_norm": {"scale": st.cast(sd["transformer.ln_f.weight"]),
                       "bias": st.cast(sd["transformer.ln_f.bias"])},
        "layers": {
            "attn": {
                "wq": st.matrix(split("weight", 0)),
                "wk": st.matrix(split("weight", 1)),
                "wv": st.matrix(split("weight", 2)),
                "bq": st.stack(split("bias", 0)),
                "bk": st.stack(split("bias", 1)),
                "bv": st.stack(split("bias", 2)),
                "wo": st.matrix(g("attn.c_proj.weight")),
                "bo": st.stack(g("attn.c_proj.bias")),
            },
            "mlp": {
                "wi": st.matrix(g("mlp.c_fc.weight")),
                "bi": st.stack(g("mlp.c_fc.bias")),
                "wo": st.matrix(g("mlp.c_proj.weight")),
                "bo": st.stack(g("mlp.c_proj.bias")),
            },
            "ln1": st.norm(g("ln_1.weight"), g("ln_1.bias")),
            "ln2": st.norm(g("ln_2.weight"), g("ln_2.bias")),
        },
    }


CONVERTERS = {
    "gpt2": convert_gpt2,
    "llama": convert_llama,
    "falcon": convert_falcon,
    "opt": convert_opt,
}


def family_of(cfg: ModelConfig) -> str:
    name = cfg.name.lower()
    for fam in FAMILIES:
        if fam in name:
            return fam
    # Structural fallback
    if cfg.moe_num_experts:
        return "mixtral"
    if cfg.parallel_block:
        return "falcon"
    if cfg.position_type == "learned":
        return "opt"
    return "llama"


def convert(cfg: ModelConfig, state_dict: StateDict,
            dtype: Optional[str] = "float32",
            quantize: str = "none") -> Dict:
    """HF state dict -> param tree on the host, every leaf in ``dtype``;
    ``quantize`` int8/int4 packs the attention and MLP matrices
    (QuantizedArray leaves). Raises NotImplementedError, by name, for a
    family whose converter is not ported."""
    if quantize not in QUANTIZE_MODES:
        raise ValueError(f"unknown quantize mode {quantize!r}; expected one "
                         f"of {'|'.join(QUANTIZE_MODES)}")
    family = family_of(cfg)
    if family in NOT_PORTED:
        raise NotImplementedError(
            f"the {family} converter is not ported yet (config "
            f"{cfg.name!r}: its forward needs {NOT_PORTED[family]}); the "
            f"PyTorch port imports the {', '.join(CONVERTERS)} families")
    return CONVERTERS[family](cfg, state_dict, torch_dtype(dtype), quantize)
