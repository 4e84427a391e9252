"""Convert a training step of the JAX trainer (an orbax checkpoint under
``<artifacts>/checkpoints/<step>/``) into the PyTorch port's layout
(``<step>/state.pt`` with its ``rbt-intact.json`` marker), so that the
port's trainer resumes the run and its server loads the weights.

Runs where orbax is installed (the port's machine need not have it; the
port never imports this script). The step's train state is restored as
saved: the parameters (a full fine-tune's model, checked against the
model config's layout, or a LoRA tree {target: {"a", "b"}}), the step
counter and the optax AdamW state, whose count and moments become the
port's Adam state. The data cursor is copied from the reference's marker,
so the port resumes on the batch the reference would have seen next.
``lora.json`` is copied beside the checkpoints when the source has one.

Usage:
    python tools/orbax_to_torch.py SRC_ARTIFACTS DST_ARTIFACTS
        [--step N] [--model NAME] [--model-overrides JSON]

SRC_ARTIFACTS holds the reference's ``checkpoints/``; the newest intact
step (marker present) is taken unless --step names one. --model defaults
to the "model" of SRC_ARTIFACTS/metrics.json; it only checks a full
fine-tune's parameter shapes.
"""

from __future__ import annotations

import argparse
import json
import os
import shutil
import sys
import types
from typing import Any, Optional

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

from runbooks_tpu_torch.models import bridge  # noqa: E402
from runbooks_tpu_torch.models.config import get_config  # noqa: E402
from runbooks_tpu_torch.train.checkpoint import (  # noqa: E402
    CheckpointManager,
)
from runbooks_tpu_torch.utils.tree import tree_leaves  # noqa: E402

MARKER = CheckpointManager.MARKER


def _numpy(tree: Any) -> Any:
    """The restored tree with numpy leaves; optax's states (restored as
    dicts) become objects with their fields as attributes, as the bridge
    reads them."""
    if isinstance(tree, dict):
        out = {k: _numpy(v) for k, v in tree.items()}
        if {"count", "mu", "nu"} <= set(out):
            return types.SimpleNamespace(**out)
        return out
    if isinstance(tree, (list, tuple)):
        return [_numpy(v) for v in tree]
    return None if tree is None else np.asarray(tree)


def _is_lora(params: dict) -> bool:
    return bool(params) and all(
        isinstance(v, dict) and set(v) == {"a", "b"}
        for v in params.values())


def intact_steps(src: str) -> list:
    ckpt = os.path.join(src, "checkpoints")
    return sorted(int(n) for n in os.listdir(ckpt)
                  if n.isdigit() and os.path.exists(
                      os.path.join(ckpt, n, MARKER)))


def convert(src: str, dst: str, step: Optional[int] = None,
            model: Optional[str] = None,
            model_overrides: Optional[dict] = None) -> dict:
    """Write step ``step`` (default: the newest intact one) of the
    reference's ``src`` artifacts as the port's checkpoint under ``dst``.
    Returns {"step", "cursor", "lora", "leaves"}."""
    import orbax.checkpoint as ocp

    steps = intact_steps(src)
    if step is None:
        if not steps:
            raise FileNotFoundError(
                f"no intact step under {src}/checkpoints")
        step = steps[-1]
    elif step not in steps:
        raise FileNotFoundError(
            f"step {step} under {src}/checkpoints is not intact "
            f"(intact: {steps})")
    ckpt_dir = os.path.join(os.path.abspath(src), "checkpoints")
    mgr = ocp.CheckpointManager(ckpt_dir)
    try:
        restored = mgr.restore(step, args=ocp.args.StandardRestore())
    finally:
        mgr.close()
    state = _numpy(dict(restored))
    with open(os.path.join(ckpt_dir, str(step), MARKER)) as f:
        cursor = dict(json.load(f).get("cursor") or {})

    lora = _is_lora(state["params"])
    if lora:
        params = bridge.tree_from_numpy(state["params"])
    else:
        if model is None:
            with open(os.path.join(src, "metrics.json")) as f:
                model = json.load(f)["model"]
        params = bridge.from_jax_numpy(
            get_config(model, **(model_overrides or {})), state["params"])
    opt_state = bridge.adam_state_from_optax_numpy(state["opt_state"])
    saved_step = int(np.asarray(state["step"]))
    if saved_step != step:
        raise ValueError(f"step directory {step} holds a state at step "
                         f"{saved_step}")
    CheckpointManager(dst).save(
        step, {"step": saved_step, "params": params, "opt_state": opt_state},
        force=True, cursor=cursor)
    if os.path.exists(os.path.join(src, "lora.json")):
        shutil.copyfile(os.path.join(src, "lora.json"),
                        os.path.join(dst, "lora.json"))
    return {"step": step, "cursor": cursor, "lora": lora,
            "leaves": len(list(tree_leaves(params)))}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("src", help="the reference's artifacts directory")
    ap.add_argument("dst", help="the port's artifacts directory")
    ap.add_argument("--step", type=int, default=None)
    ap.add_argument("--model", default=None)
    ap.add_argument("--model-overrides", default="{}",
                    help="JSON object of ModelConfig overrides")
    args = ap.parse_args(argv)
    info = convert(args.src, args.dst, args.step, args.model,
                   json.loads(args.model_overrides))
    print(json.dumps(info))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
