"""HF checkpoint conversion: state dict -> the port's param tree (the port
of ``runbooks_tpu.models.convert``, llama family).

HF keeps each linear layer as ``[out, in]`` per layer; the port keeps the
reference's stacked ``[L, in, out]`` layout (models/bridge.py
``expected_shapes``). HF's rotate_half RoPE is the port's split-half RoPE,
so the weights transpose directly. Each stacked tensor is allocated once
in ``dtype`` and filled layer by layer, so an import never holds a list of
per-layer copies beside the stack (at 8B in f32 a list plus its stack is
twice the model). A cast here rounds as numpy's ``astype`` does (to
nearest, ties to even), so the result equals the reference's bit for bit.
With ``quantize`` int8/int4 the attention and MLP matrices go straight
into their packed form layer by layer (ops/quantization.quantize_stack):
each layer is cast to ``dtype`` and quantized as the reference's
quantize-after-convert does, so the codes and scales equal its, and the
import never holds the full-precision stack of a quantized weight.
"""

from __future__ import annotations

from typing import Dict, Mapping, Optional

import torch

from runbooks_tpu_torch.models.config import ModelConfig, torch_dtype
from runbooks_tpu_torch.ops.quantization import (
    QUANTIZE_MODES,
    mode_bits,
    quantize_stack,
)

StateDict = Mapping[str, torch.Tensor]

# The reference's converter families, in its lookup order (mixtral and
# gemma before llama: their names and keys extend llama's). Only llama's
# converter is ported; the others land with their forward features.
FAMILIES = ("mixtral", "gemma", "gpt2", "llama", "falcon", "opt")


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


def convert_llama(cfg: ModelConfig, sd: StateDict, dtype: torch.dtype,
                  quantize: str = "none") -> Dict:
    L = cfg.num_layers

    def cast(w, transpose=False):
        w = w.T if transpose else w
        return torch.empty(w.shape, dtype=dtype).copy_(w)

    def stacked(name, transpose=True):
        if quantize != "none" and transpose:
            # Every transposed stack is one of the quantizable matrices.
            return quantize_stack(
                lambda i: cast(sd[f"model.layers.{i}.{name}"], True), L,
                mode_bits(quantize))
        first = sd[f"model.layers.0.{name}"]
        shape = first.T.shape if transpose else first.shape
        out = torch.empty((L, *shape), dtype=dtype)
        for i in range(L):
            w = sd[f"model.layers.{i}.{name}"]
            out[i].copy_(w.T if transpose else w)
        return out

    params = {
        "embed": cast(sd["model.embed_tokens.weight"]),
        "final_norm": {"scale": cast(sd["model.norm.weight"])},
        "layers": {
            "attn": {
                "wq": stacked("self_attn.q_proj.weight"),
                "wk": stacked("self_attn.k_proj.weight"),
                "wv": stacked("self_attn.v_proj.weight"),
                "wo": stacked("self_attn.o_proj.weight"),
            },
            "mlp": {
                "wi_gate": stacked("mlp.gate_proj.weight"),
                "wi_up": stacked("mlp.up_proj.weight"),
                "wo": stacked("mlp.down_proj.weight"),
            },
            "ln1": {"scale": stacked("input_layernorm.weight", False)},
            "ln2": {"scale": stacked("post_attention_layernorm.weight",
                                     False)},
        },
    }
    if not cfg.tie_embeddings:
        head = sd.get("lm_head.weight")
        params["head"] = cast(head if head is not None
                              else sd["model.embed_tokens.weight"],
                              transpose=True)
    return params


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
    if family != "llama":
        raise NotImplementedError(
            f"the {family} converter is not ported yet (config "
            f"{cfg.name!r}); the PyTorch port imports the llama family")
    return convert_llama(cfg, state_dict, torch_dtype(dtype), quantize)
