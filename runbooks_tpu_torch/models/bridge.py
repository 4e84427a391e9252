"""Carry a parameter tree between the reference's layout and the port's.

The reference keeps parameters as a nested dict of arrays (stacked [L, ...]
layers, ``init_params`` in runbooks_tpu.models.transformer); the port keeps
the same nesting with torch tensors. Crossing goes through numpy, so
neither side imports the other: a caller turns the reference's arrays into
numpy (``jax.tree.map(np.asarray, params)``) and hands that tree here.
"""

from __future__ import annotations

from typing import Any, Mapping, Optional

import numpy as np
import torch

from runbooks_tpu_torch.models.config import ModelConfig
from runbooks_tpu_torch.models.transformer import Params, check_supported


def _map(tree, fn):
    if isinstance(tree, Mapping):
        return {k: _map(v, fn) for k, v in tree.items()}
    return fn(tree)


def _shapes(tree, prefix=""):
    if isinstance(tree, Mapping):
        out = {}
        for k, v in tree.items():
            out.update(_shapes(v, f"{prefix}{k}."))
        return out
    return {prefix[:-1]: tuple(tree.shape)}


def expected_shapes(cfg: ModelConfig) -> dict:
    """Dotted leaf name -> shape, for the layout init_params builds."""
    h, v, L = cfg.hidden_size, cfg.vocab_size, cfg.num_layers
    m = cfg.intermediate_size
    return {
        "embed": (v, h), "final_norm.scale": (h,), "head": (h, v),
        "layers.attn.wq": (L, h, cfg.q_dim),
        "layers.attn.wk": (L, h, cfg.kv_dim),
        "layers.attn.wv": (L, h, cfg.kv_dim),
        "layers.attn.wo": (L, cfg.q_dim, h),
        "layers.ln1.scale": (L, h), "layers.ln2.scale": (L, h),
        "layers.mlp.wi_gate": (L, h, m), "layers.mlp.wi_up": (L, h, m),
        "layers.mlp.wo": (L, m, h),
    }


def from_jax_numpy(cfg: ModelConfig, tree: Mapping[str, Any],
                   device: Optional[torch.device] = None) -> Params:
    """The reference's parameter tree (leaves as numpy arrays) as the
    port's params on ``device`` (default: the CPU). Raises when the tree's
    leaves or shapes differ from the layout the config implies."""
    check_supported(cfg)
    got, want = _shapes(tree), expected_shapes(cfg)
    if got != want:
        raise ValueError(f"parameter tree does not match config "
                         f"{cfg.name!r}: got {got}, expected {want}")
    device = torch.device("cpu") if device is None else device

    def leaf(a):
        a = np.asarray(a)
        if a.dtype.name == "bfloat16":   # numpy's bfloat16 extension type
            return torch.from_numpy(a.astype(np.float32)).to(
                device, torch.bfloat16)
        return torch.from_numpy(np.array(a, copy=True)).to(device)

    return _map(tree, leaf)


def to_numpy(params: Params) -> dict:
    """The port's params as a nested dict of numpy arrays (the reference's
    layout). bfloat16 leaves widen to float32, which numpy can hold."""
    def leaf(t: torch.Tensor):
        t = t.detach().cpu()
        if t.dtype == torch.bfloat16:
            t = t.float()
        return t.numpy()

    return _map(params, leaf)
