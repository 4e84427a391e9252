"""Carry parameter trees and training state between the reference's
layout and the port's.

The reference keeps parameters as a nested dict of arrays (stacked [L, ...]
layers, ``init_params`` in runbooks_tpu.models.transformer), a LoRA tree
as {target: {"a", "b"}}, and its optimizer state as optax's chain of
states; the port keeps the same nesting with torch tensors and its own
Adam state. Crossing goes through numpy, so neither side imports the
other: a caller turns the reference's arrays into numpy
(``jax.tree.map(np.asarray, tree)``) and hands that tree here.
"""

from __future__ import annotations

from typing import Any, Mapping, Optional

import numpy as np
import torch

from runbooks_tpu_torch.models.config import ModelConfig
from runbooks_tpu_torch.models.transformer import Params, check_supported
from runbooks_tpu_torch.utils.tree import tree_map


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
    return tree_from_numpy(tree, device)


def _leaf_to_torch(a, device: torch.device) -> torch.Tensor:
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":   # numpy's bfloat16 extension type
        return torch.from_numpy(a.astype(np.float32)).to(device,
                                                         torch.bfloat16)
    return torch.from_numpy(np.array(a, copy=True)).to(device)


def tree_from_numpy(tree: Mapping[str, Any],
                    device: Optional[torch.device] = None) -> dict:
    """Any nested dict of numpy arrays (a LoRA tree {target: {"a", "b"}},
    Adam moments) as torch tensors on ``device`` (default: the CPU)."""
    device = torch.device("cpu") if device is None else device
    return tree_map(lambda a: _leaf_to_torch(a, device), tree)


def adam_state_from_optax_numpy(opt_state: Any,
                                device: Optional[torch.device] = None
                                ) -> dict:
    """The port's AdamW state from the reference's optax state with numpy
    leaves (``jax.tree.map(np.asarray, state.opt_state)``): the chain's
    Adam entry (the one with ``mu``, ``nu`` and ``count``) gives the count
    and the moments. The schedule's count advances with Adam's, so it is
    not carried separately."""
    def find(node):
        if all(hasattr(node, f) for f in ("mu", "nu", "count")):
            return node
        if isinstance(node, (tuple, list)):
            for child in node:
                found = find(child)
                if found is not None:
                    return found
        return None

    adam = find(opt_state)
    if adam is None:
        raise ValueError("no Adam state (mu, nu, count) in the optimizer "
                         "state")
    return {"count": int(np.asarray(adam.count)),
            "mu": tree_from_numpy(adam.mu, device),
            "nu": tree_from_numpy(adam.nu, device)}


def to_numpy(params: Params) -> dict:
    """The port's params as a nested dict of numpy arrays (the reference's
    layout). bfloat16 leaves widen to float32, which numpy can hold."""
    def leaf(t: torch.Tensor):
        t = t.detach().cpu()
        if t.dtype == torch.bfloat16:
            t = t.float()
        return t.numpy()

    return tree_map(leaf, params)
