"""Model-loader workload: import weights into the artifact store (the port
of ``runbooks_tpu.models.loader``). Runs under the container contract:

  params.json: {"model": "<config name>", "model_overrides": {...},
                "source": "huggingface" | "dir" | "random",
                "hf_name": "meta-llama/Meta-Llama-3-8B",  # huggingface
                "dir": "/content/model",                  # dir
                "seed": 0}                                # random

Writes the port's checkpoint ``{"params": ...}`` at step 0 under
``/content/artifacts`` (train/checkpoint.py) plus ``model.json``, which
``serve.api.load_model`` and the trainer restore from the model mount.
``quantize: int8|int4`` (params, else the config's field) writes the
packed checkpoint (ops/quantization.pack_for_checkpoint): an HF source is
quantized layer by layer as it converts, a random init after it is drawn.

Run: ``python -m runbooks_tpu_torch.models.loader``. It runs on CUDA
unless the caller names another device and raises when no GPU exists; a
random init is drawn on that device, an HF checkpoint is converted on the
host. Before the reference's ``{"done": true, ...}`` line it prints one
``{"spans": ...}`` line: each stage's seconds and the process's resident
and peak resident host memory at its end (start: before the import;
read: map the source files;
convert: page the source in and cast it into the stacks; save: write the
checkpoint).
"""

from __future__ import annotations

import dataclasses
import json
import os
import resource
import time
from typing import Any, Optional, Tuple, Union

import torch

from runbooks_tpu_torch.models.config import ModelConfig, get_config
from runbooks_tpu_torch.models.convert import convert
from runbooks_tpu_torch.models.safetensors_io import load_state_dict
from runbooks_tpu_torch.models.transformer import init_params
from runbooks_tpu_torch.ops.quantization import (
    pack_for_checkpoint,
    quantize_params,
    resolve_quantize_mode,
    tree_weight_bytes,
)
from runbooks_tpu_torch.train.checkpoint import CheckpointManager
from runbooks_tpu_torch.utils import contract
from runbooks_tpu_torch.utils.hw import resolve_device
from runbooks_tpu_torch.utils.tree import tree_leaves

# What an HF snapshot needs for an import (the reference's patterns).
HF_PATTERNS = ["*.safetensors", "*.bin", "*.json", "tokenizer*"]


def _rss_gb() -> Tuple[float, float]:
    """(resident, peak resident) host memory of this process, GB."""
    try:
        with open("/proc/self/statm") as f:
            rss = int(f.read().split()[1]) * os.sysconf("SC_PAGE_SIZE")
    except OSError:
        rss = 0
    peak = resource.getrusage(resource.RUSAGE_SELF).ru_maxrss * 1024
    return rss / 1e9, peak / 1e9


def _mark(spans: Optional[dict], name: str, t0: float) -> float:
    """Record span ``name`` (seconds since t0, memory now); returns now."""
    now = time.perf_counter()
    if spans is not None:
        rss, peak = _rss_gb()
        spans[name] = {"s": now - t0, "rss_gb": rss, "peak_rss_gb": peak}
    return now


def load_weights(params_cfg: dict,
                 device: Optional[Union[str, torch.device]] = None,
                 spans: Optional[dict] = None
                 ) -> Tuple[ModelConfig, Any]:
    """(cfg, params) of the import ``params_cfg`` describes, quantized
    to the resolved ``quantize`` mode. ``spans``, when given, receives
    the read and convert stages."""
    dev = resolve_device(device)
    cfg = get_config(params_cfg.get("model", "debug"),
                     **params_cfg.get("model_overrides", {}))
    quantize = resolve_quantize_mode(params_cfg, cfg)
    # The resolved mode wins over an override (model.json reports it).
    cfg = dataclasses.replace(cfg, quantize=quantize)
    source = params_cfg.get("source", "random")
    t0 = time.perf_counter()
    if source == "huggingface":
        hf_name = params_cfg["hf_name"]
        try:
            from huggingface_hub import snapshot_download
        except ImportError as exc:
            raise RuntimeError(
                "source: huggingface needs the huggingface_hub package, "
                "which is not installed; download the checkpoint and use "
                "source: dir") from exc
        local_dir = snapshot_download(hf_name, allow_patterns=HF_PATTERNS)
        sd = load_state_dict(local_dir)
        t0 = _mark(spans, "read", t0)
        weights = convert(cfg, sd, cfg.param_dtype, quantize)
        _mark(spans, "convert", t0)
    elif source == "dir":
        sd = load_state_dict(params_cfg.get("dir", contract.model_dir()))
        t0 = _mark(spans, "read", t0)
        weights = convert(cfg, sd, cfg.param_dtype, quantize)
        _mark(spans, "convert", t0)
    elif source == "random":
        gen = torch.Generator(device=dev)
        gen.manual_seed(int(params_cfg.get("seed", 0)))
        weights = quantize_params(init_params(cfg, gen, dev), quantize)
    else:
        raise ValueError(f"unknown source {source!r}")
    return cfg, weights


def main(device: Optional[Union[str, torch.device]] = None) -> int:
    params_cfg = contract.load_params()
    spans: dict = {}
    _mark(spans, "start", time.perf_counter())
    cfg, weights = load_weights(params_cfg, device, spans)
    artifacts = params_cfg.get("artifacts_dir") or contract.artifacts_dir()
    os.makedirs(artifacts, exist_ok=True)
    t0 = time.perf_counter()
    # Packed leaves save as plain dicts of tensors; restore_params
    # rebuilds them.
    CheckpointManager(artifacts).save(
        0, {"params": pack_for_checkpoint(weights)}, force=True)
    _mark(spans, "save", t0)
    meta = {"model": cfg.name,
            # A QuantizedArray counts its logical (pre-packing) params.
            "num_params": sum(t.numel() for t in tree_leaves(weights)),
            "vocab_size": cfg.vocab_size,
            "quantize": cfg.quantize,
            "weight_bytes": tree_weight_bytes(weights),
            "source": params_cfg.get("source", "random")}
    with open(os.path.join(artifacts, "model.json"), "w") as f:
        json.dump(meta, f, indent=2)
    print(json.dumps({"spans": spans}), flush=True)
    print(json.dumps({"done": True, **meta}), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
