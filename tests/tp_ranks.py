"""Rank bodies for the multi-rank tests of the PyTorch port (tensor-parallel
serving, FSDP and data-parallel training).

Imports torch and the port only, never JAX: spawned ranks import this
module (not the test modules, which import the reference). ``run_ranks``
starts ``world`` processes over gloo with a FileStore under the test's
tmp_path (so concurrent test workers never share a port), joins each
with a time limit of its own and kills every rank past it. Each rank
forms a DeviceMesh (over the tensor axis unless the test names another)
and runs one body of this module;
the bodies' results come back pickled, one per rank.

``python tests/tp_ranks.py serve`` runs the port's serving entry point
(``serve/api.main``) over gloo on the CPU, as a server subprocess, and
``python tests/tp_ranks.py train`` its training entry point
(``train/trainer.main``).
"""

from __future__ import annotations

import os
import pickle
import sys
import time
import traceback
from pathlib import Path

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

import torch  # noqa: E402

RANK_TIMEOUT_S = 90.0


def run_ranks(body, world: int, tmp_path, *args,
              timeout_s: float = RANK_TIMEOUT_S,
              mesh: dict = None) -> list:
    """``body(rank, mesh, *args)`` on ``world`` spawned ranks; returns the
    list of their results. ``mesh``: the MeshConfig's sizes (default
    ``tensor=world``). A rank that raises, exits non-zero or outlives
    ``timeout_s`` fails the call (the others are killed)."""
    return start_ranks(body, world, tmp_path, *args, timeout_s=timeout_s,
                       mesh=mesh).results()


class Ranks:
    """Ranks started by ``start_ranks``: ``results()`` joins them."""

    def __init__(self, procs, out: Path, timeout_s: float):
        self.procs, self.out = procs, out
        self.deadline = time.monotonic() + timeout_s
        self.timeout_s = timeout_s

    def results(self) -> list:
        procs = self.procs
        try:
            for p in procs:
                p.join(max(0.0, self.deadline - time.monotonic()))
            late = [r for r, p in enumerate(procs) if p.is_alive()]
            if late:
                raise TimeoutError(f"ranks {late} still running after "
                                   f"{self.timeout_s}s")
        finally:
            for p in procs:
                if p.is_alive():
                    p.kill()
                    p.join(5)
        results = []
        for rank, p in enumerate(procs):
            f = self.out / f"rank{rank}.pkl"
            if not f.exists():
                raise RuntimeError(f"rank {rank} exited {p.exitcode} with "
                                   f"no result")
            ok, value = pickle.loads(f.read_bytes())
            if not ok:
                raise RuntimeError(f"rank {rank} failed:\n{value}")
            results.append(value)
        return results


def start_ranks(body, world: int, tmp_path, *args,
                timeout_s: float = RANK_TIMEOUT_S, mesh: dict = None
                ) -> Ranks:
    """``run_ranks`` without the wait: the ranks run while the caller
    computes (the reference side of a test); ``.results()`` joins them."""
    import torch.multiprocessing as mp

    ctx = mp.get_context("spawn")
    out = Path(tmp_path) / f"ranks_{body.__name__}_{time.monotonic_ns()}"
    out.mkdir(parents=True)
    mesh = mesh or {"fsdp": 1, "tensor": world}
    procs = [ctx.Process(target=_rank_main,
                         args=(body.__name__, rank, world, str(out), args,
                               mesh),
                         daemon=True)
             for rank in range(world)]
    for p in procs:
        p.start()
    return Ranks(procs, out, timeout_s)


def _rank_main(name: str, rank: int, world: int, out: str, args,
               mesh: dict) -> None:
    torch.set_num_threads(1)
    import torch.distributed as dist

    from runbooks_tpu_torch.parallel import distributed
    from runbooks_tpu_torch.parallel.mesh import MeshConfig, make_mesh

    try:
        distributed.initialize(
            60, backend="gloo", rank=rank, world_size=world,
            store=dist.FileStore(os.path.join(out, "store"), world))
        mesh = make_mesh(MeshConfig(**mesh))
        result = (True, globals()[name](rank, mesh, *args))
    except BaseException:  # noqa: BLE001 - reported to the parent
        result = (False, traceback.format_exc())
    Path(out, f"rank{rank}.pkl").write_bytes(pickle.dumps(result))
    distributed.shutdown()


# ---------------------------------------------------------------------------
# Bodies
# ---------------------------------------------------------------------------

def _model(spec: dict):
    from runbooks_tpu_torch.models.config import get_config

    cfg = get_config(spec["model"], **spec["overrides"])
    params = torch.load(spec["params"], weights_only=True)
    return cfg, params


def record_routing(records: list):
    """Wrap models.moe.route to append each call's Routing (expert, slot,
    keep, gate as numpy) to ``records``; returns the restore function."""
    from runbooks_tpu_torch.models import moe

    route = moe.route

    def recording(cfg, probs):
        r = route(cfg, probs)
        records.append({k: getattr(r, k).numpy()
                        for k in ("expert", "slot", "keep", "gate")})
        return r

    moe.route = recording

    def restore():
        moe.route = route

    return restore


def forward_logits(rank, mesh, spec: dict, tokens):
    """The sharded forward (no cache) of every rank on the same tokens:
    each rank's logits, its local parameter bytes and the plan's analytic
    ones, one forward's collectives (by kind and by group) and, for an
    MoE model, each layer's Routing."""
    import torch.distributed as dist

    from runbooks_tpu_torch.models.transformer import forward
    from runbooks_tpu_torch.parallel.sharding import (
        TensorParallel,
        serve_plan,
        shard_params,
    )
    from runbooks_tpu_torch.utils.tree import tree_leaves

    cfg, params = _model(spec)
    size = lambda a: mesh.size(mesh.mesh_dim_names.index(a))  # noqa: E731
    plan = serve_plan(cfg, size("tensor"), size("expert"))
    local = shard_params(params, plan, rank)
    tp = TensorParallel(plan, rank, mesh.get_group("tensor"),
                        dist.group.WORLD)
    routing = []
    restore = record_routing(routing)
    try:
        with torch.no_grad():
            logits, _ = forward(cfg, local, torch.as_tensor(tokens), tp=tp)
    finally:
        restore()
    return {"logits": logits.numpy(), "plan": plan.describe(),
            "kv_map": tp.kv_map,
            "local_bytes": sum(t.numel() * t.element_size()
                               for t in tree_leaves(local)),
            "plan_bytes": plan.local_param_bytes(params, rank),
            "local_shapes": {k: tuple(v.shape) for k, v in
                             local["layers"].get("moe", {}).items()},
            "counts": dict(tp.counts),
            "group_counts": {g: dict(c) for g, c in tp.group_counts.items()},
            "routing": routing}


def make_engine(cfg, params, case: dict, mesh=None):
    """The case's engine (paged or dense, its "engine" arguments; its
    "config" replaces fields of ``cfg``)."""
    import dataclasses

    from runbooks_tpu_torch.serve.engine import InferenceEngine
    from runbooks_tpu_torch.serve.paging import PagedInferenceEngine

    cfg = dataclasses.replace(cfg, **case.get("config", {}))
    cls = PagedInferenceEngine if case["paged"] else InferenceEngine
    return cls(cfg, params, mesh=mesh, **case.get("engine", {}))


def drive(engine, case: dict) -> dict:
    """One case on a driving engine (rank 0, or one process): prefix
    registration, chat turns, then one generate of the case's greedy
    requests. Its output ids, kv_occupancy, counters, the
    collective_matmul the engine resolved and the f32 logits of every
    prefill dispatch."""
    from runbooks_tpu_torch.serve.engine import Request

    prefill_logits = []
    prefill = engine._prefill

    def recording(*args, **kw):
        got = prefill(*args, **kw)
        prefill_logits.append(got[2].numpy())
        return got

    engine._prefill = recording
    for prefix in case.get("prefixes", []):
        engine.register_prefix(prefix)
    for turn in case.get("turns", []):
        # A chat turn: its prompt's K/V lifted from the slot (no
        # forward), as the worker does under auto_prefix.
        done = engine.generate([Request(
            prompt_tokens=list(turn), max_tokens=case["max_tokens"],
            temperature=0.0)])[0]
        engine.register_prefix_from_slot(done._slot, turn)
    reqs = [Request(prompt_tokens=list(p), max_tokens=case["max_tokens"],
                    temperature=0.0) for p in case["prompts"]]
    engine.generate(reqs)
    return {"ids": [r.output_tokens for r in reqs],
            "occupancy": engine.kv_occupancy(),
            "spec_drafted": engine.spec_drafted,
            "prefix_tokens_reused": engine.prefix_tokens_reused,
            "kv_heads": int(engine.cache.k.shape[-2]),
            "counts": None if engine.tp is None else dict(engine.tp.counts),
            "collective_matmul": engine.collective_matmul,
            "prefill_logits": prefill_logits}


def serve(rank, mesh, spec: dict, cases: list, tokens=None):
    """Each case through an engine built on every rank with the mesh:
    rank 0 drives it (``drive``) and the followers replay. Returns
    {"cases": rank 0's ``drive`` result per case (None on a follower),
    "forward": forward_logits' result on ``tokens``, if given}."""
    out = {"forward": (None if tokens is None
                       else forward_logits(rank, mesh, spec, tokens))}
    base_cfg, params = _model(spec)
    results = out["cases"] = []
    for case in cases:
        engine = make_engine(base_cfg, params, case, mesh)
        if rank:
            engine.serve_follower()
            results.append(None)
            continue
        try:
            results.append(drive(engine, case))
        finally:
            engine.stop_followers()
    return out


def serve_specs(rank, mesh, runs: list, refusal_spec: dict = None):
    """``serve`` of each (spec, cases, tokens) in turn (one spawn for
    several models); then, with ``refusal_spec``, ``refusals`` on that
    model (its own host tier) as the last entry."""
    out = [serve(rank, mesh, *run) for run in runs]
    if refusal_spec is not None:
        out.append(refusals(rank, mesh, refusal_spec, own_host_tier=True))
    return out


def refusals(rank, mesh, spec: dict, own_host_tier: bool = False) -> dict:
    """What a mesh engine refuses, by message: the paged geometry check
    and each feature out of the slice's scope under a mesh of more than
    one rank. The host tier is tried on a debug model whose kv heads
    shard, or (``own_host_tier``) on the spec's model."""
    import dataclasses

    from runbooks_tpu_torch.models.config import get_config
    from runbooks_tpu_torch.models.transformer import init_params
    from runbooks_tpu_torch.ops.quantization import quantize_params
    from runbooks_tpu_torch.serve.engine import InferenceEngine
    from runbooks_tpu_torch.serve.paging import PagedInferenceEngine

    cfg, params = _model(spec)
    debug = get_config("debug", num_layers=1)
    debug_params = init_params(debug, torch.Generator().manual_seed(0),
                               torch.device("cpu"))
    tries = {
        "paged": lambda: PagedInferenceEngine(cfg, params, mesh=mesh,
                                              max_slots=2),
        "quantized": lambda: InferenceEngine(
            cfg, quantize_params(dict(params), "int8"), mesh=mesh),
        "quantize_kv": lambda: InferenceEngine(cfg, params, mesh=mesh,
                                               quantize_kv=True),
        "adapter_pool": lambda: InferenceEngine(cfg, params, mesh=mesh,
                                                adapter_pool=2),
        # On a geometry whose kv heads shard, so the tier is what fails.
        "host_tier": lambda: PagedInferenceEngine(
            *((cfg, params) if own_host_tier else (debug, debug_params)),
            mesh=mesh, kv_host_pages=4),
        "preemption": lambda: InferenceEngine(cfg, params, mesh=mesh,
                                              preemption="swap"),
        "collective_matmul": lambda: InferenceEngine(
            dataclasses.replace(cfg, collective_matmul="ring"), params,
            mesh=mesh),
        "not_a_mesh": lambda: InferenceEngine(cfg, params, mesh=object()),
    }
    out = {}
    for name, make in tries.items():
        try:
            make()
            out[name] = None
        except (ValueError, NotImplementedError) as exc:
            out[name] = f"{type(exc).__name__}: {exc}"
    return out


def _fsdp_setup(rank, mesh, case: dict):
    """(cfg, the Fsdp runtime, the rank's base pieces, the LoRA config or
    None, the trainable tree's pieces) of an FSDP case: the full trees
    come from the case's files, each rank keeps its pieces."""
    from runbooks_tpu_torch.parallel.sharding import Fsdp
    from runbooks_tpu_torch.train.lora import LoraConfig
    from runbooks_tpu_torch.train.step import fsdp_plan

    cfg, params = _model(case)
    lora_cfg = (LoraConfig(**case["lora"]["config"]) if case.get("lora")
                else None)
    plan = fsdp_plan(cfg, mesh, lora_cfg)
    fsdp = Fsdp(plan, rank, mesh, torch.device("cpu"),
                compute_dtype=cfg.activation_dtype)
    base = plan.shard(params, plan.params, rank)
    trainable = base
    if lora_cfg is not None:
        full = torch.load(case["lora"]["init"], weights_only=True)
        trainable = plan.shard(full, plan.lora, rank)
    return cfg, fsdp, base, lora_cfg, trainable


def fsdp_cases(rank, mesh, cases: list) -> list:
    """``fsdp_steps`` of each case, in turn (one spawn for a file's
    cases)."""
    return [fsdp_steps(rank, mesh, case) for case in cases]


def fsdp_steps(rank, mesh, case: dict) -> dict:
    """The case's steps (full fine-tune, or LoRA over a frozen base) on
    this rank's pieces and rows: per step the loss, gradient norm and
    non-finite flag; the whole trainable tree after them (rank 0); each
    leaf's local shape, the rank's parameter bytes and the plan's; the
    collectives by kind, and the plan."""
    from runbooks_tpu_torch.train.lora import make_lora_train_step
    from runbooks_tpu_torch.train.optimizer import (
        OptimizerConfig,
        make_optimizer,
    )
    from runbooks_tpu_torch.train.step import (
        batch_rows,
        create_train_state,
        make_train_step,
        shard_batch,
    )
    from runbooks_tpu_torch.utils.tree import tree_leaves, tree_map

    cfg, fsdp, base, lora_cfg, trainable = _fsdp_setup(rank, mesh, case)
    if case.get("by_all_reduce"):
        # The branch gloo takes on CUDA tensors, here on the CPU's.
        fsdp._scatters = lambda t: False
    opt = make_optimizer(OptimizerConfig(**case["opt"]))
    state = create_train_state(trainable, opt)
    k = case.get("k", 1)
    kw = dict(accumulate_steps=k, loss_chunk=case.get("loss_chunk", 0),
              fsdp=fsdp)
    if lora_cfg is None:
        step = make_train_step(cfg, opt, **kw)
    else:
        lstep = make_lora_train_step(cfg, lora_cfg, opt, **kw)
        step = lambda s, b: lstep(s, base, b)  # noqa: E731
    history = []
    for batch in case["batches"]:
        local = {key: torch.from_numpy(v)
                 for key, v in shard_batch(batch, fsdp, k).items()}
        state, m = step(state, local)
        history.append({"loss": float(m["loss"]),
                        "grad_norm": float(m["grad_norm"]),
                        "weight_tokens": float(m["weight_tokens"]),
                        "nonfinite": int(m["nonfinite"])})
    plan = fsdp.plan
    full = fsdp.gather_full(state.params, plan.trainable)
    nbytes = lambda t: sum(x.numel() * x.element_size()  # noqa: E731
                           for x in tree_leaves(t))
    shapes_of = lambda t: tree_map(lambda x: tuple(x.shape), t)  # noqa: E731
    from runbooks_tpu_torch.models.transformer import init_params

    meta = init_params(cfg, None, torch.device("meta"))
    return {"history": history,
            "trainable": None if full is None else tree_map(
                lambda t: t.numpy(), full),
            "base_shapes": shapes_of(base),
            "trainable_shapes": shapes_of(state.params),
            "local_bytes": nbytes(base),
            "plan_bytes": plan.local_bytes(meta, plan.params),
            "rows": batch_rows(plan, case["batches"][0]["tokens"].shape[0],
                               k, rank),
            "counts": dict(fsdp.counts), "plan": plan.describe(),
            "scatters": fsdp._scatters(torch.zeros(1))}


def train_jobs(rank, mesh, jobs: list) -> list:
    """``run_training`` of each job on this rank's mesh, in turn (one
    spawn for several runs): a job is {"job": TrainJobConfig keyword
    arguments, "env": {name: value} set for this run on every rank,
    "rank0_env": the same on rank 0 only}. Returns each run's summary
    and exit code."""
    from runbooks_tpu_torch.train.optimizer import OptimizerConfig
    from runbooks_tpu_torch.train import trainer
    from runbooks_tpu_torch.train.lora import LoraConfig

    out = []
    for spec in jobs:
        kw = dict(spec["job"])
        kw["optimizer"] = OptimizerConfig(**kw.get("optimizer", {}))
        if kw.get("lora") is not None:
            kw["lora"] = LoraConfig(**kw["lora"])
        env = dict(spec.get("env", {}), **(spec.get("rank0_env", {})
                                           if rank == 0 else {}))
        old = {k: os.environ.get(k) for k in env}
        os.environ.update(env)
        try:
            summary = trainer.run_training(trainer.TrainJobConfig(**kw),
                                           device="cpu", mesh=mesh)
        finally:
            for k, v in old.items():
                if v is None:
                    os.environ.pop(k, None)
                else:
                    os.environ[k] = v
        out.append({"summary": summary,
                    "exit": trainer.exit_code_for(summary)})
    return out


def train_main() -> int:
    """The port's training entry point over gloo on the CPU (the trainer
    subprocess of the FSDP tests)."""
    torch.set_num_threads(1)
    from runbooks_tpu_torch.train import trainer

    return trainer.main(backend="gloo")


def serve_main() -> int:
    """The port's serving entry point over gloo on the CPU (the server
    subprocess of the HTTP tests)."""
    torch.set_num_threads(1)
    from runbooks_tpu_torch.serve import api

    return api.main(backend="gloo")


if __name__ == "__main__":
    if sys.argv[1:] == ["serve"]:
        raise SystemExit(serve_main())
    if sys.argv[1:] == ["train"]:
        raise SystemExit(train_main())
    raise SystemExit(f"usage: {sys.argv[0]} serve|train")
