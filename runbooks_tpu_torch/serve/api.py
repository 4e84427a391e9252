"""Model loading for serving (the port of ``runbooks_tpu.serve.api``'s
``load_model``; the HTTP front end is a later slice).

A named config plus ``model_overrides``, and weights random-initialized on
the device from ``seed`` (the reference's behaviour when no checkpoint is
present). Reading a checkpoint and weight quantization are not ported yet
and are refused rather than ignored.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Optional, Tuple, Union

import torch

from runbooks_tpu_torch.models.config import ModelConfig, get_config
from runbooks_tpu_torch.models.transformer import check_supported, init_params
from runbooks_tpu_torch.utils.hw import resolve_device


def load_model(params: dict,
               device: Optional[Union[str, torch.device]] = None
               ) -> Tuple[ModelConfig, Any]:
    """(cfg, model params) from a params.json-style dict:
    ``{"model": name, "model_overrides": {...}, "seed": int}``. Runs on
    CUDA unless ``device`` names another; raises when no device is named
    and no GPU exists."""
    dev = resolve_device(device)
    if params.get("checkpoint"):
        raise NotImplementedError(
            "loading a checkpoint is not ported yet; omit `checkpoint` to "
            "serve seeded random weights")
    quantize = params.get("quantize", "none")
    if quantize not in (None, "none"):
        raise NotImplementedError(
            f"weight quantization ({quantize!r}) is not ported yet")
    cfg = get_config(params.get("model", "debug"),
                     **params.get("model_overrides", {}))
    cfg = dataclasses.replace(cfg, quantize="none")
    check_supported(cfg)
    gen = torch.Generator(device=dev)
    gen.manual_seed(int(params.get("seed", 0)))
    return cfg, init_params(cfg, gen, dev)
