"""The trainer workload on one GPU: config -> data -> steps -> checkpoints
(the port of ``runbooks_tpu.train.trainer``).

It honours the container contract (params.json and PARAM_* in,
``{artifacts}`` out): ``python -m runbooks_tpu_torch.train.trainer`` reads
the params, or ``run_training(TrainJobConfig(...))`` runs a job from code.
Full fine-tuning and LoRA (frozen base, only the adapters trained).

Fault tolerance as in the reference: periodic and last-step checkpoints
carry the data cursor, a restarted job resumes from the newest intact one
and sees the batch it would have seen; SIGTERM/SIGINT, and a pending GCE
maintenance event when ``maintenance_poll_s`` > 0 (``main`` turns it on
when it finds the GCE metadata server), stop the loop at the next step
boundary with an emergency checkpoint (``exit_code_for`` then gives
EXIT_PREEMPTED); ``max_bad_steps`` consecutive non-finite steps (each
skipped by the step's guard) abort the run. RBT_FAULT_INJECT
(``kill:K``, ``sigterm:K``, ``nonfinite:K[+]``) injects each fault at a
chosen step, deterministically.

``prefetch_depth`` > 0 (default 2) reads, tokenizes and packs ahead on a
background thread (``data.Prefetcher``) into pinned host memory; the loop
copies each batch to the device asynchronously on its own stream.

``main`` builds the kernels into ``<artifacts>/kernel_cache``
(utils/cuda_build.py), so a restarted Job loads them without ``nvcc``.
A collective matmul other than "off" is refused by name.

Data parallelism and FSDP (ZeRO-3): the ``mesh_*`` keys of params.json
form a MeshConfig, as the reference's; ``mesh_data`` and ``mesh_fsdp``
train over that many ranks, and the other axes above 1 are refused by
name (parallel/mesh.check_training_mesh), as is a multi-host env, and so
is gemma under any mesh (parallel/mesh.check_mesh_model). An MoE config
(mixtral) trains with the router's load-balance term in its objective
(train/step.value_and_grad), in one process or over data x fsdp ranks,
each routing its rows as the reference routes the global microbatch
(models/moe.py): params that name no mesh get the reference's fsdp -1,
one rank per GPU. The fine-tune example's mesh_expert x mesh_tensor is
refused by name. ``main``
resolves the mesh against the GPUs it sees (a -1 axis fills with them; a
mesh that needs more raises naming ``torch.cuda.device_count()``) and
runs one rank per GPU over NCCL: it is rank 0 and spawns the others.
``run_training(..., mesh=)`` is one rank's run: its pieces of the params
and of the optimizer state (init draws each full leaf and keeps the
rank's piece, so the run starts where one process would), its rows of
the global batch stream (one data cursor), the global loss and norm
(train/step.py). Rank 0 decides SIGTERM, SIGINT and maintenance stops
and broadcasts its decision at every step boundary, so every rank stops
at the same step, takes part in one emergency checkpoint and exits
EXIT_PREEMPTED; RBT_FAULT_INJECT acts on every rank. Checkpoints keep the
one-process format: rank 0 gathers one leaf at a time and writes, and
every rank restores its pieces, so a run resumes in any layout. Rank 0
alone writes the summary, metrics, spans, checkpoints and profiles;
tokens/s, MFU and the first step's FLOPs count the global batch.

Observability (runbooks_tpu_torch/obs), as the reference's: spans
(restore, data_wait, step, checkpoint, emergency_save; the ``preempted``
instant) into the flight ring and, under RBT_TRACE=1,
``{artifacts}/trace.jsonl``; goodput (productive step time over wall
clock, restore and the first step's one-off costs excluded) in
``metrics.json`` and each log line; the ``train_*`` families in the
registry, which ``main`` serves on RBT_METRICS_PORT; the first step's
program cost (FLOPs and bytes, the analytic MFU beside the wall-clock
one) and the build sentinel's steady mark after it; an incident bundle on
the ``max_bad_steps`` abort; torch.profiler captures of the
``profile_start``/``profile_stop`` window (``{artifacts}/profile``) and of
RBT_PROFILE_AT_STEP=n[:k] (``{artifacts}/profiles/step<n>``).
"""

from __future__ import annotations

import dataclasses
import functools
import json
import math
import os
import shutil
import signal
import threading
import time
from typing import Any, Dict, Iterator, Optional, Union

import torch

from runbooks_tpu_torch.models.config import ModelConfig, get_config
from runbooks_tpu_torch.models.transformer import (
    init_params,
    resolve_attention_impl,
)
from runbooks_tpu_torch.obs import device as obs_device
from runbooks_tpu_torch.obs import flight as obs_flight
from runbooks_tpu_torch.obs import trace as obs_trace
from runbooks_tpu_torch.obs.goodput import GoodputTracker
from runbooks_tpu_torch.obs.metrics import REGISTRY
from runbooks_tpu_torch.obs.profile import PROFILER, parse_profile_at_step
from runbooks_tpu_torch.obs.trace import span
from runbooks_tpu_torch.parallel import distributed
from runbooks_tpu_torch.ops.flash_attention import BWD_HEAD_DIMS
from runbooks_tpu_torch.parallel.mesh import (
    MeshConfig,
    check_mesh_model,
    check_training_mesh,
    make_mesh,
    mesh_config_of,
)
from runbooks_tpu_torch.parallel.sharding import Fsdp
from runbooks_tpu_torch.train import data as data_mod
from runbooks_tpu_torch.train.checkpoint import CheckpointManager
from runbooks_tpu_torch.train.lora import (
    LoraConfig,
    create_lora_train_state,
    init_lora,
    make_lora_train_step,
)
from runbooks_tpu_torch.train.optimizer import OptimizerConfig, make_optimizer
from runbooks_tpu_torch.train.step import (
    TrainState,
    batch_rows,
    create_train_state,
    first_step,
    fsdp_plan,
    make_train_step,
    shard_batch,
)
from runbooks_tpu_torch.utils import contract, cuda_build
from runbooks_tpu_torch.utils.contract import EXIT_PREEMPTED
from runbooks_tpu_torch.utils.hw import chip_peak_flops, resolve_device
from runbooks_tpu_torch.utils.tree import tree_leaves, tree_map

COLLECTIVE_MATMUL_PARAM_KEYS = ("collective_matmul", "collectiveMatmul",
                                "collectivematmul")


class SimulatedFault(RuntimeError):
    """Raised by RBT_FAULT_INJECT's ``kill`` mode: a deterministic stand-in
    for an abrupt process death (no emergency checkpoint, no cleanup beyond
    ``finally``), to prove step-exact resume."""


def _parse_fault_inject() -> Optional[dict]:
    """RBT_FAULT_INJECT=<mode>:<step>[+], the reference's deterministic
    fault hook:

      kill:K       raise SimulatedFault at the top of step K
      sigterm:K    send this process SIGTERM at the top of step K (the real
                   handler: emergency checkpoint, preempted exit)
      nonfinite:K  poison step K's batch with NaN (the non-finite guard);
                   ``K+`` poisons every step from K on (the abort after
                   max_bad_steps)
    """
    spec = os.environ.get("RBT_FAULT_INJECT", "")
    if not spec:
        return None
    mode, _, step = spec.partition(":")
    if mode not in ("kill", "sigterm", "nonfinite") or not step:
        raise ValueError(
            f"RBT_FAULT_INJECT={spec!r}: expected kill:K|sigterm:K|"
            "nonfinite:K[+]")
    return {"mode": mode, "step": int(step.rstrip("+")),
            "repeat": step.endswith("+")}


def _refuse_unported(params: Dict[str, Any]) -> None:
    """Keys of params.json that the reference honours and this port cannot
    (the collective matmul), refused by name rather than dropped."""
    for key in COLLECTIVE_MATMUL_PARAM_KEYS:
        value = params.get(key)
        if value is not None and str(value).lower() != "off":
            raise NotImplementedError(
                f"{key}={value!r}: the collective matmul "
                "(ops/collective_matmul.py) is not ported yet (ROADMAP.md "
                "§1, multi-device); use off")


@dataclasses.dataclass(frozen=True)
class TrainJobConfig:
    model: str = "debug"
    model_overrides: Dict[str, Any] = dataclasses.field(default_factory=dict)
    mesh: MeshConfig = MeshConfig()
    optimizer: OptimizerConfig = OptimizerConfig()
    lora: Optional[LoraConfig] = None

    batch_size: int = 8           # global batch
    seq_len: int = 512
    steps: int = 100
    # accumulate_steps=k runs k microbatches of batch_size/k per optimizer
    # step; loss_chunk=c computes the loss in c-token chunks without the
    # [b, s, vocab] logits; 0 = off. prefetch_depth=d > 0 tokenizes and
    # packs up to d batches ahead on a background thread.
    accumulate_steps: int = 1
    loss_chunk: int = 0
    prefetch_depth: int = 2
    data_path: Optional[str] = None       # default: contract data dir
    tokenizer: Optional[str] = None
    text_key: str = "text"
    prompt_template: Optional[str] = None
    seed: int = 0

    checkpoint_every: int = 50
    artifacts_dir: Optional[str] = None   # default: contract artifacts dir
    log_every: int = 10
    resume: bool = True
    # Abort after this many consecutive non-finite steps. maintenance_poll_s
    # > 0 polls the GCE metadata server for a pending maintenance event
    # and treats one like SIGTERM.
    max_bad_steps: int = 3
    maintenance_poll_s: float = 0.0
    # A torch.profiler capture of steps [profile_start, profile_stop) into
    # {artifacts}/profile (off while profile_stop <= profile_start).
    profile_start: int = 0
    profile_stop: int = 0

    @classmethod
    def from_params(cls, params: Dict[str, Any]) -> "TrainJobConfig":
        """From a flat params.json dict, as the reference reads it: the
        camelCase spellings of accumulate_steps and max_bad_steps, quoted
        numbers, optimizer keys at the top level, ``mesh_<axis>`` keys as
        a MeshConfig, ``lora`` as a dict (or true for the defaults);
        unknown keys are ignored, and keys the port cannot honour (a
        training axis other than data and fsdp above 1) are refused by
        name."""
        kwargs: Dict[str, Any] = {}
        params = dict(params)
        _refuse_unported(params)
        for alias in ("accumulateSteps", "accumulatesteps"):
            if alias in params:
                params.setdefault("accumulate_steps", params.pop(alias))
        for alias in ("maxBadSteps", "maxbadsteps"):
            if alias in params:
                params.setdefault("max_bad_steps", params.pop(alias))
        simple = {f.name for f in dataclasses.fields(cls)
                  if f.name not in ("mesh", "optimizer", "lora",
                                    "model_overrides")}
        kwargs.update({k: v for k, v in params.items() if k in simple})
        for key in ("accumulate_steps", "loss_chunk", "prefetch_depth",
                    "batch_size", "seq_len", "steps", "max_bad_steps",
                    "profile_start", "profile_stop"):
            if key in kwargs:
                kwargs[key] = int(kwargs[key])
        if "maintenance_poll_s" in kwargs:
            kwargs["maintenance_poll_s"] = float(kwargs["maintenance_poll_s"])
        mesh_keys = {f.name for f in dataclasses.fields(MeshConfig)}
        mesh_args = {k[len("mesh_"):]: int(v) for k, v in params.items()
                     if k.startswith("mesh_") and k[len("mesh_"):] in mesh_keys}
        if mesh_args:
            kwargs["mesh"] = check_training_mesh(MeshConfig(**mesh_args))
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
        # vocab_size as the reference reads it: an HF tokenizer's excludes
        # its added tokens.
        vocab = getattr(tok, "vocab_size", model_cfg.vocab_size)
        if vocab > model_cfg.vocab_size:
            raise ValueError(f"tokenizer vocab {vocab} exceeds "
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


def refuse_multi_host() -> None:
    """A multi-host env (the operator's JAX_* fan-out) is refused: this
    port's ranks are the processes of one host."""
    info = distributed.env_process_info()
    if info is not None and info["num_processes"] > 1:
        raise NotImplementedError(
            f"a training mesh over {info['num_processes']} hosts "
            "(JAX_NUM_PROCESSES): the PyTorch port trains on the GPUs of "
            "one host, one process per GPU; multi-host training is not "
            "ported yet (ROADMAP.md §1)")


def refuse_unported_attention(model_cfg: ModelConfig,
                              dev: torch.device) -> None:
    """On CUDA the step's flash attention is K1 forward and K2/K3
    backward: a head_dim the backward kernels are not built for
    (ops/flash_attention.BWD_HEAD_DIMS: 64, 128 and gemma's 256; the
    ``debug`` config's 32, say) is refused by name before any work,
    rather than in the first backward. The CPU takes the plain versions
    at any head_dim, and the plain attention ("xla") any head_dim on
    either device."""
    if (dev.type == "cuda" and model_cfg.head_dim not in BWD_HEAD_DIMS
            and resolve_attention_impl(model_cfg, dev) == "flash"):
        raise NotImplementedError(
            f"config {model_cfg.name!r} has head_dim {model_cfg.head_dim}: "
            f"the backward flash kernels take {BWD_HEAD_DIMS}, so the "
            f"PyTorch port does not fine-tune it on the card with "
            f"attention_impl 'flash' (set attention_impl 'xla' for the "
            f"plain attention)")


def run_training(job: TrainJobConfig, base_params=None,
                 device: Optional[Union[str, torch.device]] = None,
                 mesh=None) -> Dict[str, Any]:
    """Run the job; returns the summary (also {artifacts}/metrics.json).

    Runs on CUDA unless ``device`` names another; raises when no device is
    named and no GPU exists. ``base_params`` (the port's params layout, on
    any device) are the frozen base in LoRA mode and the starting weights
    in full mode; by default both come from a random init seeded by
    ``job.seed``.

    ``mesh``: this rank's DeviceMesh (parallel/mesh.make_mesh over the
    default process group) for a data x fsdp run; every rank calls
    run_training with the same job. Without it ``job.mesh`` must resolve
    to one process (a larger one raises: ``main`` starts the ranks)."""
    dev = resolve_device(device)
    refuse_multi_host()
    if mesh is None:
        mesh_cfg = check_training_mesh(job.mesh, 1)
    else:
        mesh_cfg = check_training_mesh(mesh_config_of(mesh))
    world = mesh_cfg.data * mesh_cfg.fsdp
    model_cfg = get_config(job.model, **job.model_overrides)
    check_mesh_model(model_cfg, mesh_cfg)
    refuse_unported_attention(model_cfg, dev)
    if job.accumulate_steps < 1:
        raise ValueError(
            f"accumulate_steps must be >= 1, got {job.accumulate_steps}")
    if job.batch_size % job.accumulate_steps:
        raise ValueError(f"accumulate_steps={job.accumulate_steps} must "
                         f"divide batch_size={job.batch_size}")
    # May raise on a malformed value: before any state needing cleanup.
    fault = _parse_fault_inject()
    profile_at = parse_profile_at_step()
    optimizer = make_optimizer(job.optimizer)
    artifacts = job.artifacts_dir or contract.artifacts_dir()
    fsdp = rank = None
    if world > 1:
        import torch.distributed as dist

        rank = dist.get_rank()
        fsdp = Fsdp(fsdp_plan(model_cfg, mesh_cfg, job.lora), rank, mesh, dev,
                    compute_dtype=model_cfg.activation_dtype)
    primary = rank in (None, 0)
    os.makedirs(artifacts, exist_ok=True)
    # This run's events label as the training tier, and its trace file is
    # the run's (RBT_TRACE=1 writes live spans there; tail sampling and
    # incidents need the same destination with it off); rank 0's alone.
    obs_flight.set_component("train")
    obs_trace.configure(os.path.join(artifacts, "trace.jsonl") if primary
                        else os.devnull)
    ckpt = CheckpointManager(artifacts)

    gen = torch.Generator(device=dev)
    gen.manual_seed(job.seed)
    lora_mode = job.lora is not None
    cut = shapes = None
    meta = torch.device("meta")
    if fsdp is not None:
        # Each full leaf is drawn (in tree order, as one process draws it)
        # and cut to this rank's piece.
        cut = functools.partial(fsdp.plan.cut_by_axes, rank=rank)
        shapes = init_params(model_cfg, None, meta)
    if base_params is None:
        base_params = init_params(model_cfg, gen, dev, cut=cut)
    else:
        if fsdp is not None:
            base_params = fsdp.plan.shard(base_params, fsdp.plan.params,
                                          rank)
        base_params = tree_map(lambda t: t.to(dev), base_params)
    step_kw = dict(accumulate_steps=job.accumulate_steps,
                   loss_chunk=job.loss_chunk, fsdp=fsdp)
    if lora_mode:
        state = create_lora_train_state(
            job.lora, base_params if shapes is None else shapes, optimizer,
            gen, device=dev, cut=cut)
        lora_step = make_lora_train_step(model_cfg, job.lora, optimizer,
                                         **step_kw)
        step_fn = lambda s, b: lora_step(s, base_params, b)  # noqa: E731
    else:
        state = create_train_state(base_params, optimizer)
        del base_params
        step_fn = make_train_step(model_cfg, optimizer, **step_kw)
    state_dims = None
    if fsdp is not None:
        dims = fsdp.plan.trainable
        state_dims = {"step": None, "params": dims,
                      "opt_state": {"count": None, "mu": dims, "nu": dims}}
        # The rank's rows of each global batch; a copy of another rank's
        # rows (a batch the degree does not divide) weighs 0.
        owner = batch_rows(fsdp.plan, job.batch_size,
                           job.accumulate_steps, rank)[1]
        # The parameter bytes this rank holds, and the plan's count of
        # them from the full shapes alone.
        held = [state.params] + ([base_params] if lora_mode else [])
        planned = fsdp.plan.local_bytes(shapes, fsdp.plan.params)
        if lora_mode:
            planned += fsdp.plan.local_bytes(
                init_lora(shapes, job.lora, None, device=meta),
                fsdp.plan.lora)
        param_bytes = {"held": sum(t.numel() * t.element_size()
                                   for tree in held
                                   for t in tree_leaves(tree)),
                       "plan": planned}
    # After the first step, a kernel build in the loop is a stall the
    # sentinel flags (xla_unexpected_compiles_total).
    obs_device.SENTINEL.install()
    obs_device.PROGRAMS.register("train", "train_step", step_fn)

    on_cuda = dev.type == "cuda"
    # The global batch's tokens; MFU against every rank's peak.
    tokens_per_step = job.batch_size * job.seq_len
    flops_per_token = 3.0 * model_cfg.flops_per_token(job.seq_len)
    peak_flops = chip_peak_flops(dev)
    if peak_flops:
        peak_flops *= world
    start_step = consumed = 0
    last_saved = -1
    restored_step = restore_time_s = first_step_s = compile_time_s = None
    exit_reason = None
    bad_streak = nonfinite_steps = 0
    history = []
    stop = {"reason": None}
    restore_sigs = []
    poller_stop = None
    prefetcher = None
    win = {"data": 0.0, "step": 0.0, "ckpt": 0.0, "steps": 0}
    profiling = profiling_at = False
    device_cost = None          # the step program's first-dispatch cost
    compiles_before = obs_device.SENTINEL.total
    unexpected_before = obs_device.SENTINEL.unexpected
    hbm_peak_bytes = 0
    # Goodput: productive step time over wall clock, the restore and the
    # first step's one-off costs excluded. The clock starts before the
    # restore, so the restore lands inside the wall it is excluded from.
    goodput = GoodputTracker()

    def fault_due(i: int, mode: str) -> bool:
        return (fault is not None and fault["mode"] == mode
                and (i == fault["step"]
                     or (fault["repeat"] and i >= fault["step"])))

    def summary_dict(in_progress: bool = False) -> Dict[str, Any]:
        s = {
            "final_loss": history[-1]["loss"] if history else None,
            "steps": job.steps,
            "tokens_per_sec": (history[-1]["tokens_per_sec"]
                               if history else None),
            "first_step_s": first_step_s,
            # The reference's name for the first step's window (its XLA
            # compile); here the one-off costs of the first step.
            "compile_time_s": compile_time_s,
            "restored_step": restored_step,
            "restore_time_s": restore_time_s,
            "accumulate_steps": job.accumulate_steps,
            "model": job.model,
            "lora": lora_mode,
            "device": str(dev),
            "mesh": {"data": mesh_cfg.data, "fsdp": mesh_cfg.fsdp,
                     "rank": rank or 0,
                     **({} if fsdp is None else
                        {"plan": fsdp.plan.describe(),
                         "param_bytes": param_bytes,
                         "collectives": dict(fsdp.counts)})},
            "exit_reason": exit_reason,
            "nonfinite_steps": nonfinite_steps,
            "batches_consumed": consumed,
            "peak_memory_bytes": (torch.cuda.max_memory_allocated(dev)
                                  if on_cuda else None),
            "goodput": goodput.ratio() if goodput.steps else None,
            "goodput_detail": goodput.snapshot(),
            "device_obs": {
                # The analytic cross-check of the wall-clock MFU: the step
                # program's FLOPs and bytes at its first dispatch, with
                # the roofline classification.
                "cost": device_cost,
                "formula_flops_per_step": flops_per_token * tokens_per_step,
                "compiles": obs_device.SENTINEL.total - compiles_before,
                "unexpected_compiles":
                    obs_device.SENTINEL.unexpected - unexpected_before,
                "hbm_peak_bytes": hbm_peak_bytes or None,
            },
            "history": history,
        }
        if in_progress:
            s["in_progress"] = True
        return s

    def save(step: int, force: bool = False) -> None:
        whole = {"step": state.step, "params": state.params,
                 "opt_state": state.opt_state}
        if fsdp is not None:
            # The one-process format: rank 0 gathers a leaf at a time.
            whole = fsdp.gather_full(whole, state_dims)
        if primary:
            ckpt.save(step, whole, cursor={"batches_consumed": consumed},
                      force=force)
        if fsdp is not None:
            fsdp.barrier()

    def log(obj) -> None:
        if primary:
            print(json.dumps(obj), flush=True)

    try:
        if job.resume and ckpt.latest_intact_step() is not None:
            t_restore = time.perf_counter()
            with span("restore"):
                if fsdp is None:
                    saved, cursor, _ = ckpt.restore_with_cursor(device=dev)
                else:
                    # The saved state is one process's: each rank maps it
                    # and keeps its pieces.
                    saved, cursor, _ = ckpt.restore_with_cursor(
                        device=torch.device("cpu"), mmap=True)
                    saved = tree_map(
                        lambda t: t.to(dev) if torch.is_tensor(t) else t,
                        fsdp.plan.shard(saved, state_dims, rank))
            state = TrainState(step=int(saved["step"]),
                               params=saved["params"],
                               opt_state=saved["opt_state"])
            restore_time_s = time.perf_counter() - t_restore
            goodput.exclude(restore_time_s, "restore")
            start_step = last_saved = restored_step = state.step
            consumed = int(cursor.get("batches_consumed", start_step))
            log({"restored_step": start_step, "batches_consumed": consumed})

        if threading.current_thread() is threading.main_thread():
            def on_signal(signum, frame):
                if not primary:
                    print(f"trainer: rank {rank} caught "
                          f"{signal.Signals(signum).name}; rank 0 decides "
                          "the stop", flush=True)
                elif stop["reason"] is None:
                    stop["reason"] = ("sigint" if signum == signal.SIGINT
                                      else "sigterm")
                    print(f"trainer: caught {signal.Signals(signum).name}; "
                          "emergency checkpoint at the next step boundary",
                          flush=True)
            for sig in (signal.SIGTERM, signal.SIGINT):
                restore_sigs.append((sig, signal.signal(sig, on_signal)))
        if job.maintenance_poll_s > 0 and primary:
            poller_stop = threading.Event()
            threading.Thread(target=_poll_maintenance,
                             args=(job.maintenance_poll_s, poller_stop, stop),
                             name="rbt-maintenance", daemon=True).start()

        batches = _batches(job, model_cfg, skip=consumed)
        if fsdp is not None:
            batches = map(functools.partial(
                shard_batch, fsdp=fsdp, k=job.accumulate_steps), batches)
        if job.prefetch_depth > 0:
            batches = prefetcher = data_mod.Prefetcher(
                batches, depth=job.prefetch_depth,
                place=data_mod.pinned_placer(on_cuda))
        t_start = time.perf_counter()
        tokens_done = 0
        for i in range(start_step, job.steps):
            if fault_due(i, "kill"):
                raise SimulatedFault(
                    f"RBT_FAULT_INJECT: simulated death at step {i}")
            if fault_due(i, "sigterm"):
                os.kill(os.getpid(), signal.SIGTERM)
            if fsdp is not None:
                stop["reason"] = fsdp.broadcast_stop(stop["reason"])
            if stop["reason"]:
                exit_reason = stop["reason"]
                break
            if job.profile_stop > job.profile_start and primary \
                    and i == job.profile_start and not profiling_at:
                PROFILER.start(os.path.join(artifacts, "profile"))
                profiling = True
            if profile_at is not None and i == profile_at[0] and primary \
                    and not (profiling or profiling_at):
                PROFILER.start(os.path.join(artifacts, "profiles",
                                            f"step{profile_at[0]}"))
                profiling_at = True
            t_data = time.perf_counter()
            with span("data_wait", step=i):
                batch = {k: torch.as_tensor(v).to(dev, non_blocking=True)
                         for k, v in next(batches).items()}
            consumed += 1
            data_wait_s = time.perf_counter() - t_data
            if fault_due(i, "nonfinite"):
                batch["loss_mask"] = batch["loss_mask"] * float("nan")
            t_step = time.perf_counter()
            with span("step", step=i):
                if i == start_step:
                    state, metrics, device_cost = first_step(
                        step_fn, state, batch,
                        f"b{job.batch_size}s{job.seq_len}")
                    if fsdp is not None and device_cost:
                        # The global batch's FLOPs: the rows' owners' sum.
                        device_cost = dict(device_cost, flops=float(
                            fsdp.all_reduce(torch.tensor(
                                [device_cost["flops"] * owner],
                                dtype=torch.float64, device=dev))[0]))
                else:
                    state, metrics = step_fn(state, batch)
                loss = float(metrics["loss"])
                if on_cuda:
                    torch.cuda.synchronize(dev)
            step_s = time.perf_counter() - t_step
            if metrics["nonfinite"]:
                bad_streak += 1
                nonfinite_steps += 1
                log({"step": i + 1, "nonfinite": True,
                     "consecutive_bad": bad_streak})
                if bad_streak >= max(1, job.max_bad_steps):
                    # The abort is an incident: the flight ring, metrics
                    # and memory/program census go beside the artifacts
                    # before raising (debounced; capture never raises).
                    from runbooks_tpu_torch.obs import incident

                    if primary:
                        incident.capture(
                            "train_max_bad_steps", artifacts=artifacts,
                            component="train",
                            extra={"step": i + 1, "bad_streak": bad_streak,
                                   "nonfinite_steps": nonfinite_steps})
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
                # growth, the kernels' first load, the program's cost
                # count): reported apart, excluded from goodput, and the
                # throughput window starts after it.
                first_step_s = step_s
                compile_time_s = time.perf_counter() - t_start
                goodput.exclude(compile_time_s, "compile")
                obs_device.SENTINEL.mark_steady("train")
                t_start = time.perf_counter()
            else:
                tokens_done += tokens_per_step
            if profiling and i + 1 == job.profile_stop:
                PROFILER.stop()
                profiling = False
            if profiling_at and i + 1 == profile_at[0] + profile_at[1]:
                PROFILER.stop()
                profiling_at = False
            ckpt_s = 0.0
            if (i + 1) % job.checkpoint_every == 0 or i + 1 == job.steps:
                t_ckpt = time.perf_counter()
                with span("checkpoint", step=i + 1):
                    save(i + 1)
                ckpt_s = time.perf_counter() - t_ckpt
                last_saved = i + 1
            if i != start_step:
                goodput.step(step_s, data_wait_s, ckpt_s)
                REGISTRY.observe(
                    "train_step_seconds", step_s,
                    help_text="Per-step compute wall time (dispatch "
                              "+ device sync share).")
                REGISTRY.observe(
                    "train_data_wait_seconds", data_wait_s,
                    help_text="Per-step input-pipeline wait.")
                if ckpt_s:
                    REGISTRY.observe(
                        "train_checkpoint_seconds", ckpt_s,
                        help_text="Blocking checkpoint save time.")
                win["data"] += data_wait_s
                win["step"] += step_s
                win["ckpt"] += ckpt_s
                win["steps"] += 1
            if (i + 1) % job.log_every == 0 or i + 1 == job.steps:
                dt = time.perf_counter() - t_start
                tps = (tokens_done / max(dt, 1e-9) if tokens_done
                       else tokens_per_step / max(first_step_s, 1e-9))
                entry = {"step": i + 1, "loss": loss,
                         "grad_norm": float(metrics["grad_norm"]),
                         "tokens_per_sec": tps,
                         "tflops_per_sec": tps * flops_per_token / 1e12}
                if peak_flops:
                    entry["mfu"] = tps * flops_per_token / peak_flops
                if not history:
                    entry["first_step_s"] = first_step_s
                if win["steps"]:
                    entry["step_s"] = win["step"] / win["steps"]
                    entry["data_wait_s"] = win["data"] / win["steps"]
                    if win["ckpt"]:
                        entry["ckpt_s"] = win["ckpt"] / win["steps"]
                    entry["goodput"] = round(goodput.ratio(), 4)
                    REGISTRY.set_gauge(
                        "train_goodput_ratio", entry["goodput"],
                        help_text="Productive step time / wall clock "
                                  "(restart overhead excluded).")
                else:
                    entry["step_s"] = step_s
                    entry["data_wait_s"] = data_wait_s
                REGISTRY.set_gauge("train_step", i + 1,
                                   help_text="Last completed training step.")
                REGISTRY.set_gauge("train_loss", round(loss, 6),
                                   help_text="Loss at the last logged step.")
                hbm_now = max((m.get("bytes_in_use", 0) for m in
                               obs_device.set_memory_gauges()), default=0)
                if hbm_now:
                    entry["hbm_used_bytes"] = hbm_now
                    hbm_peak_bytes = max(hbm_peak_bytes, hbm_now)
                if device_cost and win["steps"] and peak_flops:
                    entry["analytic_mfu"] = (device_cost["flops"] / (
                        win["step"] / win["steps"]) / peak_flops)
                    REGISTRY.set_gauge(
                        "train_analytic_mfu", round(entry["analytic_mfu"], 4),
                        help_text="Counted FLOPs of the step program / "
                                  "measured step time / peak: the "
                                  "analytic cross-check of the wall-clock "
                                  "MFU.")
                obs_device.PROGRAMS.set_gauges(component="train")
                win = {"data": 0.0, "step": 0.0, "ckpt": 0.0, "steps": 0}
                history.append(entry)
                log(entry)
                if primary:
                    _write_json(os.path.join(artifacts, "metrics.json"),
                                summary_dict(in_progress=True))
        if exit_reason is not None:
            if state.step != last_saved:
                with span("emergency_save", step=state.step,
                          reason=exit_reason):
                    save(state.step, force=True)
            obs_trace.instant("preempted", reason=exit_reason,
                              step=state.step)
            log({"preempted": exit_reason,
                 "emergency_checkpoint_step": state.step})
    finally:
        if profiling or profiling_at:   # the window ran past the run's end
            PROFILER.stop()
        if prefetcher is not None:
            prefetcher.close()
        if poller_stop is not None:
            poller_stop.set()
        for sig, old in restore_sigs:
            signal.signal(sig, old)
        # This run's steady claim dies with it: a later run in the process
        # builds legitimately.
        obs_device.SENTINEL.clear_steady("train")
        obs_trace.close()

    summary = summary_dict()
    if not primary:
        return summary
    _write_json(os.path.join(artifacts, "metrics.json"), summary)
    if lora_mode:
        note = {"note": "merged weights = base + lora; see checkpoints"}
        with open(os.path.join(artifacts, "lora.json"), "w") as f:
            json.dump(dataclasses.asdict(job.lora) | note, f)
    return summary


def _poll_maintenance(every_s: float, done: threading.Event,
                      stop: Dict[str, Any]) -> None:
    """Every ``every_s`` seconds until ``done``: a pending GCE maintenance
    event sets the stop reason "maintenance" (once; a failed poll is a
    flake, not a stop)."""
    from runbooks_tpu_torch.cloud import metadata

    while not done.wait(every_s):
        try:
            event = metadata.maintenance_event()
        except Exception:  # noqa: BLE001 - a flaky poll is not a stop
            continue
        if event and stop["reason"] is None:
            stop["reason"] = "maintenance"
            print(f"trainer: GCE maintenance event {event!r}; emergency "
                  "checkpoint at the next step boundary", flush=True)
            return


def exit_code_for(summary: Dict[str, Any]) -> int:
    """EXIT_PREEMPTED (42) for a run stopped by SIGTERM, SIGINT or a GCE
    maintenance event after its emergency checkpoint, 0 otherwise."""
    if summary.get("exit_reason") in ("sigterm", "sigint", "maintenance"):
        return EXIT_PREEMPTED
    return 0


# The training group's timeout: a collective that a dead rank never
# joins fails within it (gloo fails at once on a closed connection).
TRAIN_TIMEOUT_S = 600


def training_world(mesh: MeshConfig, backend: str) -> MeshConfig:
    """``mesh`` resolved for ``main``: under NCCL against the GPUs this
    process sees (one rank per GPU; a -1 axis fills with them), under gloo
    (the CPU, for tests) against its fixed axes (a -1 axis fills to 1).
    A mesh that needs another count raises naming the device count."""
    if backend == "gloo":
        fixed = math.prod(s for s in dataclasses.astuple(mesh) if s != -1)
        return check_training_mesh(mesh, fixed)
    n = torch.cuda.device_count()
    try:
        return check_training_mesh(mesh, max(n, 1))
    except ValueError as exc:
        raise ValueError(
            f"{exc}: the trainer runs one rank per GPU, and "
            f"torch.cuda.device_count() is {n}") from None


def _train_rank(job: TrainJobConfig, rank: int, world: int, store_path: str,
                backend: str) -> Dict[str, Any]:
    """Join the training group as ``rank`` (cuda:rank under NCCL, the CPU
    under gloo) and run the job on its DeviceMesh."""
    import torch.distributed as dist

    dev = (torch.device("cuda", rank) if backend == "nccl"
           else torch.device("cpu"))
    distributed.initialize(TRAIN_TIMEOUT_S, backend=backend, rank=rank,
                           world_size=world, device=dev,
                           store=dist.FileStore(store_path, world))
    try:
        mesh = make_mesh(job.mesh, device_type=dev.type)
        return run_training(job, device=dev, mesh=mesh)
    finally:
        distributed.shutdown()


def _follower_main(job: TrainJobConfig, rank: int, world: int,
                   store_path: str, backend: str) -> None:
    """A rank other than 0 of ``main``'s run (a spawned process): signals
    are rank 0's to decide. Exits with the run's exit code."""
    signal.signal(signal.SIGTERM, signal.SIG_IGN)
    signal.signal(signal.SIGINT, signal.SIG_IGN)
    cuda_build.use_kernel_cache(cuda_build.kernel_cache_dir(
        job.artifacts_dir or contract.artifacts_dir()))
    summary = _train_rank(job, rank, world, store_path, backend)
    raise SystemExit(exit_code_for(summary))


def _watch_ranks(procs: list, done: threading.Event, rendezvous: str
                 ) -> None:
    """Rank 0's guard: a rank that dies (any exit but the run's own 0 or
    EXIT_PREEMPTED) before rank 0's run ended ends the whole run at once
    with exit 1, after killing the others (rank 0's next collective would
    fail within the group's timeout anyway)."""
    from multiprocessing.connection import wait

    live = list(procs)
    while live and not done.is_set():
        for sentinel in wait([p.sentinel for p in live], timeout=0.2):
            p = next(q for q in live if q.sentinel == sentinel)
            live.remove(p)
            p.join(5)
            if done.is_set() or p.exitcode in (0, EXIT_PREEMPTED):
                # A rank that ended its run (rank 0 joins it).
                continue
            print(f"trainer: {p.name} exited with code {p.exitcode} "
                  "before the run ended; stopping every rank", flush=True)
            for q in procs:
                if q.is_alive():
                    q.kill()
            shutil.rmtree(rendezvous, ignore_errors=True)
            os._exit(1)


def _main_ranks(job: TrainJobConfig, world: int, backend: str) -> int:
    """Rank 0 of a data x fsdp run: spawn ranks 1..world-1, run, join them.
    Exits with the run's code (EXIT_PREEMPTED after a stop) when every
    rank agrees, 1 otherwise."""
    import tempfile

    import torch.multiprocessing as mp

    rendezvous = tempfile.mkdtemp(prefix="rbt-train-")
    store_path = os.path.join(rendezvous, "store")
    ctx = mp.get_context("spawn")
    procs = [ctx.Process(target=_follower_main,
                         args=(job, r, world, store_path, backend),
                         name=f"rank {r}", daemon=True)
             for r in range(1, world)]
    for p in procs:
        p.start()
    print(json.dumps({"ranks": world, "backend": backend,
                      "mesh": dataclasses.asdict(job.mesh),
                      "pids": [os.getpid()] + [p.pid for p in procs]}),
          flush=True)
    done = threading.Event()
    guard = threading.Thread(target=_watch_ranks,
                             args=(procs, done, rendezvous),
                             name="train-watch", daemon=True)
    guard.start()
    try:
        summary = _train_rank(job, 0, world, store_path, backend)
        done.set()
        code = exit_code_for(summary)
        for p in procs:
            p.join(TRAIN_TIMEOUT_S)
        codes = [p.exitcode for p in procs]
        print(json.dumps({"done": True, "ranks": world,
                          **{k: v for k, v in summary.items()
                             if k != "history"},
                          "rank_exit_codes": [code] + codes}), flush=True)
        return code if all(c == code for c in codes) else 1
    finally:
        done.set()
        for p in procs:
            if p.is_alive():
                p.kill()
                p.join(5)
        shutil.rmtree(rendezvous, ignore_errors=True)


def main(backend: Optional[str] = None) -> int:
    """The training container's entry point. ``mesh_data`` x ``mesh_fsdp``
    above 1 runs that many ranks, one per GPU over NCCL: this process is
    rank 0 and spawns the others. ``backend="gloo"`` runs them on the CPU
    (the tests). A mesh the GPUs cannot form raises; no GPU at all raises
    too (nothing carries on on the CPU)."""
    params = contract.load_params()
    job = TrainJobConfig.from_params(params)
    refuse_multi_host()
    backend = backend or "nccl"
    if backend not in ("nccl", "gloo"):
        raise ValueError(f"backend must be 'nccl' or 'gloo', got {backend!r}")
    mesh = training_world(job.mesh, backend)
    check_mesh_model(get_config(job.model, **job.model_overrides), mesh)
    world = mesh.data * mesh.fsdp
    job = dataclasses.replace(job, mesh=mesh)
    # The registry for the controller's fleet scraper (train_step,
    # train_loss, goodput, the step histograms) on GET /metrics, when the
    # Job's template sets RBT_METRICS_PORT; library callers of
    # run_training never bind a port.
    metrics_port = int(os.environ.get("RBT_METRICS_PORT", "0") or 0)
    if metrics_port:
        from runbooks_tpu_torch.obs.metrics import serve_metrics

        serve_metrics(metrics_port)
    if job.maintenance_poll_s == 0 and "maintenance_poll_s" not in params:
        # On GCE, watch for maintenance events by default (one quick
        # probe: an off-GCE box must not stall on a dead address).
        from runbooks_tpu_torch.cloud import metadata

        if metadata.on_gce(timeout=0.5, attempts=1):
            job = dataclasses.replace(job, maintenance_poll_s=5.0)
    kernels = cuda_build.use_kernel_cache(cuda_build.kernel_cache_dir(
        job.artifacts_dir or contract.artifacts_dir()))
    if torch.cuda.is_available():
        # Every kernel of the training path at once (one nvcc each, in
        # parallel), or none over a warm cache: the expected builds. The
        # other ranks load them from the cache.
        with obs_device.SENTINEL.expected():
            cuda_build.build(cuda_build.SOURCES)
    if world > 1:
        return _main_ranks(job, world, backend)
    summary = run_training(job)
    print(json.dumps({"done": True,
                      **{k: v for k, v in summary.items() if k != "history"},
                      "kernel_cache": {"dir": str(kernels),
                                       **cuda_build.stats}}), flush=True)
    return exit_code_for(summary)


if __name__ == "__main__":
    raise SystemExit(main())
