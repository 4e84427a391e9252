"""The trainer workload on one GPU: config -> data -> steps -> checkpoints
(the port of ``runbooks_tpu.train.trainer``).

It honours the container contract (params.json and PARAM_* in,
``{artifacts}`` out): ``python -m runbooks_tpu_torch.train.trainer`` reads
the params, or ``run_training(TrainJobConfig(...))`` runs a job from code.
Full fine-tuning and LoRA (frozen base, only the adapters trained).

Fault tolerance as in the reference: periodic and last-step checkpoints
carry the data cursor, a restarted job resumes from the newest intact one
and sees the batch it would have seen; SIGTERM/SIGINT stop the loop at the
next step boundary with an emergency checkpoint (``exit_code_for`` then
gives EXIT_PREEMPTED); ``max_bad_steps`` consecutive non-finite steps (each
skipped by the step's guard) abort the run.

Not ported yet (ROADMAP.md): the observability planes (spans, metrics
registry, goodput, compile sentinel, profiler capture, cost analysis), the
RBT_FAULT_INJECT hook, the GCE maintenance poller, the background
prefetcher and the compile cache; mesh and collective-matmul keys of
params.json are ignored, as unknown keys are.
"""

from __future__ import annotations

import dataclasses
import json
import os
import signal
import threading
import time
from typing import Any, Dict, Iterator, Optional, Union

import torch

from runbooks_tpu_torch.models.config import ModelConfig, get_config
from runbooks_tpu_torch.models.transformer import init_params
from runbooks_tpu_torch.train import data as data_mod
from runbooks_tpu_torch.train.checkpoint import CheckpointManager
from runbooks_tpu_torch.train.lora import (
    LoraConfig,
    create_lora_train_state,
    make_lora_train_step,
)
from runbooks_tpu_torch.train.optimizer import OptimizerConfig, make_optimizer
from runbooks_tpu_torch.train.step import (
    TrainState,
    create_train_state,
    make_train_step,
)
from runbooks_tpu_torch.utils import contract
from runbooks_tpu_torch.utils.contract import EXIT_PREEMPTED
from runbooks_tpu_torch.utils.hw import chip_peak_flops, resolve_device
from runbooks_tpu_torch.utils.tree import tree_map


@dataclasses.dataclass(frozen=True)
class TrainJobConfig:
    model: str = "debug"
    model_overrides: Dict[str, Any] = dataclasses.field(default_factory=dict)
    optimizer: OptimizerConfig = OptimizerConfig()
    lora: Optional[LoraConfig] = None

    batch_size: int = 8           # global batch
    seq_len: int = 512
    steps: int = 100
    # accumulate_steps=k runs k microbatches of batch_size/k per optimizer
    # step; loss_chunk=c computes the loss in c-token chunks without the
    # [b, s, vocab] logits; 0 = off.
    accumulate_steps: int = 1
    loss_chunk: int = 0
    data_path: Optional[str] = None       # default: contract data dir
    tokenizer: Optional[str] = None
    text_key: str = "text"
    prompt_template: Optional[str] = None
    seed: int = 0

    checkpoint_every: int = 50
    artifacts_dir: Optional[str] = None   # default: contract artifacts dir
    log_every: int = 10
    resume: bool = True
    max_bad_steps: int = 3

    @classmethod
    def from_params(cls, params: Dict[str, Any]) -> "TrainJobConfig":
        """From a flat params.json dict, as the reference reads it: the
        camelCase spellings of accumulate_steps and max_bad_steps, quoted
        integers, optimizer keys at the top level, ``lora`` as a dict (or
        true for the defaults); unknown keys are ignored."""
        kwargs: Dict[str, Any] = {}
        params = dict(params)
        for alias in ("accumulateSteps", "accumulatesteps"):
            if alias in params:
                params.setdefault("accumulate_steps", params.pop(alias))
        for alias in ("maxBadSteps", "maxbadsteps"):
            if alias in params:
                params.setdefault("max_bad_steps", params.pop(alias))
        simple = {f.name for f in dataclasses.fields(cls)
                  if f.name not in ("optimizer", "lora", "model_overrides")}
        kwargs.update({k: v for k, v in params.items() if k in simple})
        for key in ("accumulate_steps", "loss_chunk", "batch_size",
                    "seq_len", "steps", "max_bad_steps"):
            if key in kwargs:
                kwargs[key] = int(kwargs[key])
        opt_keys = {f.name for f in dataclasses.fields(OptimizerConfig)}
        opt_args = {k: v for k, v in params.items() if k in opt_keys}
        if opt_args:
            kwargs["optimizer"] = OptimizerConfig(**opt_args)
        if params.get("lora"):
            lora = params["lora"]
            kwargs["lora"] = (LoraConfig(**lora) if isinstance(lora, dict)
                              else LoraConfig())
        if params.get("model_overrides"):
            kwargs["model_overrides"] = dict(params["model_overrides"])
        return cls(**kwargs)


def _batches(job: TrainJobConfig, model_cfg: ModelConfig,
             skip: int = 0) -> Iterator[dict]:
    path = job.data_path or contract.data_dir()
    if path and os.path.exists(path):
        tok = data_mod.load_tokenizer(job.tokenizer)
        if tok.vocab_size > model_cfg.vocab_size:
            raise ValueError(f"tokenizer vocab {tok.vocab_size} exceeds "
                             f"model vocab {model_cfg.vocab_size}")
        it = data_mod.dataset(path, job.seq_len, job.batch_size,
                              tokenizer=tok, epochs=None,
                              text_key=job.text_key,
                              prompt_template=job.prompt_template)
    else:
        it = data_mod.synthetic_batches(model_cfg.vocab_size, job.seq_len,
                                        job.batch_size, job.seed)
    if skip:
        print(f"data: advancing to batch cursor {skip} (step-exact resume)",
              flush=True)
        it = data_mod.skip_batches(it, skip)
    return it


def _write_json(path: str, obj: Any) -> None:
    """Atomic: readers see the old file or the new one, never a torn one."""
    with open(path + ".tmp", "w") as f:
        json.dump(obj, f, indent=2)
    os.replace(path + ".tmp", path)


def run_training(job: TrainJobConfig, base_params=None,
                 device: Optional[Union[str, torch.device]] = None
                 ) -> Dict[str, Any]:
    """Run the job; returns the summary (also {artifacts}/metrics.json).

    Runs on CUDA unless ``device`` names another; raises when no device is
    named and no GPU exists. ``base_params`` (the port's params layout, on
    any device) are the frozen base in LoRA mode and the starting weights
    in full mode; by default both come from a random init seeded by
    ``job.seed``."""
    dev = resolve_device(device)
    model_cfg = get_config(job.model, **job.model_overrides)
    if job.accumulate_steps < 1:
        raise ValueError(
            f"accumulate_steps must be >= 1, got {job.accumulate_steps}")
    if job.batch_size % job.accumulate_steps:
        raise ValueError(f"accumulate_steps={job.accumulate_steps} must "
                         f"divide batch_size={job.batch_size}")
    optimizer = make_optimizer(job.optimizer)
    artifacts = job.artifacts_dir or contract.artifacts_dir()
    os.makedirs(artifacts, exist_ok=True)
    ckpt = CheckpointManager(artifacts)

    gen = torch.Generator(device=dev)
    gen.manual_seed(job.seed)
    if base_params is None:
        base_params = init_params(model_cfg, gen, dev)
    else:
        base_params = tree_map(lambda t: t.to(dev), base_params)
    lora_mode = job.lora is not None
    if lora_mode:
        state = create_lora_train_state(job.lora, base_params, optimizer, gen)
        lora_step = make_lora_train_step(
            model_cfg, job.lora, optimizer,
            accumulate_steps=job.accumulate_steps, loss_chunk=job.loss_chunk)
        step_fn = lambda s, b: lora_step(s, base_params, b)  # noqa: E731
    else:
        state = create_train_state(base_params, optimizer)
        del base_params
        step_fn = make_train_step(model_cfg, optimizer,
                                  accumulate_steps=job.accumulate_steps,
                                  loss_chunk=job.loss_chunk)

    on_cuda = dev.type == "cuda"
    tokens_per_step = job.batch_size * job.seq_len
    flops_per_token = 3.0 * model_cfg.flops_per_token(job.seq_len)
    peak_flops = chip_peak_flops(dev)
    start_step = consumed = 0
    last_saved = -1
    restored_step = restore_time_s = first_step_s = None
    exit_reason = None
    bad_streak = nonfinite_steps = 0
    history = []
    stop = {"reason": None}
    restore_sigs = []
    win = {"data": 0.0, "step": 0.0, "steps": 0}

    def summary_dict(in_progress: bool = False) -> Dict[str, Any]:
        s = {
            "final_loss": history[-1]["loss"] if history else None,
            "steps": job.steps,
            "tokens_per_sec": (history[-1]["tokens_per_sec"]
                               if history else None),
            "first_step_s": first_step_s,
            "restored_step": restored_step,
            "restore_time_s": restore_time_s,
            "accumulate_steps": job.accumulate_steps,
            "model": job.model,
            "lora": lora_mode,
            "device": str(dev),
            "exit_reason": exit_reason,
            "nonfinite_steps": nonfinite_steps,
            "batches_consumed": consumed,
            "peak_memory_bytes": (torch.cuda.max_memory_allocated(dev)
                                  if on_cuda else None),
            "history": history,
        }
        if in_progress:
            s["in_progress"] = True
        return s

    def save(step: int, force: bool = False) -> None:
        ckpt.save(step, {"step": state.step, "params": state.params,
                         "opt_state": state.opt_state},
                  cursor={"batches_consumed": consumed}, force=force)

    try:
        if job.resume and ckpt.latest_intact_step() is not None:
            t_restore = time.perf_counter()
            saved, cursor, _ = ckpt.restore_with_cursor(device=dev)
            state = TrainState(step=int(saved["step"]),
                               params=saved["params"],
                               opt_state=saved["opt_state"])
            restore_time_s = time.perf_counter() - t_restore
            start_step = last_saved = restored_step = state.step
            consumed = int(cursor.get("batches_consumed", start_step))
            print(json.dumps({"restored_step": start_step,
                              "batches_consumed": consumed}), flush=True)

        if threading.current_thread() is threading.main_thread():
            def on_signal(signum, frame):
                if stop["reason"] is None:
                    stop["reason"] = ("sigint" if signum == signal.SIGINT
                                      else "sigterm")
                    print(f"trainer: caught {signal.Signals(signum).name}; "
                          "emergency checkpoint at the next step boundary",
                          flush=True)
            for sig in (signal.SIGTERM, signal.SIGINT):
                restore_sigs.append((sig, signal.signal(sig, on_signal)))

        batches = _batches(job, model_cfg, skip=consumed)
        t_start = time.perf_counter()
        tokens_done = 0
        for i in range(start_step, job.steps):
            if stop["reason"]:
                exit_reason = stop["reason"]
                break
            t_data = time.perf_counter()
            batch = {k: torch.from_numpy(v).to(dev)
                     for k, v in next(batches).items()}
            consumed += 1
            data_wait_s = time.perf_counter() - t_data
            t_step = time.perf_counter()
            state, metrics = step_fn(state, batch)
            loss = float(metrics["loss"])
            if on_cuda:
                torch.cuda.synchronize(dev)
            step_s = time.perf_counter() - t_step
            if metrics["nonfinite"]:
                bad_streak += 1
                nonfinite_steps += 1
                print(json.dumps({"step": i + 1, "nonfinite": True,
                                  "consecutive_bad": bad_streak}),
                      flush=True)
                if bad_streak >= max(1, job.max_bad_steps):
                    raise RuntimeError(
                        f"aborting: {bad_streak} consecutive non-finite "
                        f"loss/grad steps (last at step {i + 1}); every bad "
                        "step left the params unchanged; resume from the "
                        "last checkpoint after fixing the data or the "
                        "learning rate")
            else:
                bad_streak = 0
            if i == start_step:
                # The first step carries the one-off costs (allocator
                # growth, the kernels' first load): reported apart, and
                # the throughput window starts after it.
                first_step_s = step_s
                t_start = time.perf_counter()
            else:
                tokens_done += tokens_per_step
                win["data"] += data_wait_s
                win["step"] += step_s
                win["steps"] += 1
            if (i + 1) % job.log_every == 0 or i + 1 == job.steps:
                dt = time.perf_counter() - t_start
                tps = (tokens_done / max(dt, 1e-9) if tokens_done
                       else tokens_per_step / max(first_step_s, 1e-9))
                entry = {"step": i + 1, "loss": loss,
                         "tokens_per_sec": tps,
                         "tflops_per_sec": tps * flops_per_token / 1e12}
                if peak_flops:
                    entry["mfu"] = tps * flops_per_token / peak_flops
                if not history:
                    entry["first_step_s"] = first_step_s
                if win["steps"]:
                    entry["step_s"] = win["step"] / win["steps"]
                    entry["data_wait_s"] = win["data"] / win["steps"]
                else:
                    entry["step_s"] = step_s
                    entry["data_wait_s"] = data_wait_s
                win = {"data": 0.0, "step": 0.0, "steps": 0}
                history.append(entry)
                print(json.dumps(entry), flush=True)
                _write_json(os.path.join(artifacts, "metrics.json"),
                            summary_dict(in_progress=True))
            if (i + 1) % job.checkpoint_every == 0 or i + 1 == job.steps:
                save(i + 1)
                last_saved = i + 1
        if exit_reason is not None:
            if state.step != last_saved:
                save(state.step, force=True)
            print(json.dumps({"preempted": exit_reason,
                              "emergency_checkpoint_step": state.step}),
                  flush=True)
    finally:
        for sig, old in restore_sigs:
            signal.signal(sig, old)

    summary = summary_dict()
    _write_json(os.path.join(artifacts, "metrics.json"), summary)
    if lora_mode:
        note = {"note": "merged weights = base + lora; see checkpoints"}
        with open(os.path.join(artifacts, "lora.json"), "w") as f:
            json.dump(dataclasses.asdict(job.lora) | note, f)
    return summary


def exit_code_for(summary: Dict[str, Any]) -> int:
    """EXIT_PREEMPTED (42) for a run stopped by SIGTERM/SIGINT after its
    emergency checkpoint, 0 otherwise."""
    if summary.get("exit_reason") in ("sigterm", "sigint"):
        return EXIT_PREEMPTED
    return 0


def main() -> int:
    job = TrainJobConfig.from_params(contract.load_params())
    summary = run_training(job)
    print(json.dumps({"done": True, **{k: v for k, v in summary.items()
                                       if k != "history"}}), flush=True)
    return exit_code_for(summary)


if __name__ == "__main__":
    raise SystemExit(main())
