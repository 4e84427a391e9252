"""LoRA adapter artifacts for serving: the load-time fold (the port of
``runbooks_tpu.serve.lora_pool``'s single-adapter path).

An adapter artifact is exactly what a LoRA training run leaves behind
(train/trainer.py): a directory with ``checkpoints/`` holding the train
state whose params are the LoRA tree ({target: {"a": [L, in, r], "b": [L,
r, out]}}) and ``lora.json`` carrying {rank, alpha, targets}.
``load_merge_adapter`` folds one such adapter into the base weights at
load time, so one tenant is served with no per-token overhead. The
multi-tenant pool (``AdapterPool``) is not ported yet.
"""

from __future__ import annotations

import json
import os
from typing import Optional

import torch

from runbooks_tpu_torch.models.config import ModelConfig
from runbooks_tpu_torch.train.checkpoint import CheckpointManager
from runbooks_tpu_torch.train.lora import LoraConfig, apply_lora

ADAPTER_META = "lora.json"


class AdapterLoadError(ValueError):
    """An adapter artifact cannot be loaded (missing checkpoint, target or
    shape mismatch)."""


def save_adapter(path: str, lora_tree, rank: int, alpha: float,
                 targets=None) -> None:
    """Write a serving-loadable adapter artifact (the trainer's layout:
    checkpoints/ + lora.json), for tests and tools."""
    os.makedirs(path, exist_ok=True)
    CheckpointManager(path).save(0, {"params": lora_tree}, force=True)
    meta = {"rank": int(rank), "alpha": float(alpha)}
    if targets is not None:
        meta["targets"] = list(targets)
    with open(os.path.join(path, ADAPTER_META), "w") as f:
        json.dump(meta, f)


def read_adapter_meta(path: str) -> dict:
    """lora.json contents ({} when absent: rank then comes from the
    checkpoint's shapes and alpha defaults to train/lora.py's 16.0)."""
    meta_path = os.path.join(path, ADAPTER_META)
    if not os.path.exists(meta_path):
        return {}
    try:
        with open(meta_path) as f:
            return dict(json.load(f))
    except (OSError, ValueError) as exc:
        raise AdapterLoadError(
            f"adapter {path!r}: unreadable {ADAPTER_META}: {exc}") from exc


def adapter_artifact_ok(path: str) -> Optional[str]:
    """None when ``path`` looks like a loadable adapter directory, else the
    reason it is not. Existence only; shapes are checked at load."""
    if not os.path.isdir(path):
        return f"adapter {path!r}: no such directory"
    if not os.path.isdir(os.path.join(path, "checkpoints")):
        return (f"adapter {path!r}: no checkpoints/ directory (expected "
                "a LoRA training artifact — train/trainer.py layout)")
    return None


def load_merge_adapter(path: str, cfg: ModelConfig, base_params):
    """Base params with one adapter artifact folded in (train/lora.py
    apply_lora: what the trainer's merge would produce), on the base's
    device. Raises AdapterLoadError when the artifact does not fit."""
    err = adapter_artifact_ok(path)
    if err is not None:
        raise AdapterLoadError(err)
    try:
        full, _, _ = CheckpointManager(path).restore_with_cursor(
            device=torch.device("cpu"), mmap=True)
    except (FileNotFoundError, RuntimeError) as exc:
        raise AdapterLoadError(
            f"adapter {path!r}: checkpoint restore failed: {exc}") from exc
    lora = full.get("params") if isinstance(full, dict) else None
    if not isinstance(lora, dict) or not lora:
        raise AdapterLoadError(
            f"adapter {path!r}: checkpoint holds no LoRA params tree")
    layers = base_params["layers"]
    for target, ab in lora.items():
        group, _, name = target.partition(".")
        w = layers.get(group, {}).get(name)
        if w is None or not (isinstance(ab, dict) and "a" in ab
                             and "b" in ab):
            raise AdapterLoadError(
                f"adapter {path!r}: target {target!r} is not an {{a, b}} "
                f"pair on a weight of model {cfg.name!r}")
        a, b = ab["a"], ab["b"]
        if (a.ndim != 3 or b.ndim != 3 or tuple(a.shape[:2]) != w.shape[:2]
                or b.shape[0] != w.shape[0] or b.shape[2] != w.shape[2]
                or a.shape[2] != b.shape[1]):
            raise AdapterLoadError(
                f"adapter {path!r}: target {target} shapes "
                f"a{tuple(a.shape)}/b{tuple(b.shape)} do not fit the "
                f"weight {tuple(w.shape)} of model {cfg.name!r}")
    dev = base_params["embed"].device
    lora = {t: {k: v.to(dev) for k, v in ab.items()}
            for t, ab in lora.items()}
    meta = read_adapter_meta(path)
    rank = int(meta.get("rank", next(iter(lora.values()))["a"].shape[-1]))
    lcfg = LoraConfig(rank=rank, alpha=float(meta.get("alpha", 16.0)),
                      targets=tuple(lora))
    return apply_lora(base_params, lora, lcfg)
