"""Rank bodies for the tensor-parallel tests of the PyTorch port.

Imports torch and the port only, never JAX: spawned ranks import this
module (not the test modules, which import the reference). ``run_ranks``
starts ``world`` processes over gloo with a FileStore under the test's
tmp_path (so concurrent test workers never share a port), joins each
with a time limit of its own and kills every rank past it. Each rank
forms a DeviceMesh over the tensor axis and runs one body of this module;
the bodies' results come back pickled, one per rank.

``python tests/tp_ranks.py serve`` runs the port's serving entry point
(``serve/api.main``) over gloo on the CPU, as a server subprocess.
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
              timeout_s: float = RANK_TIMEOUT_S) -> list:
    """``body(rank, mesh, *args)`` on ``world`` spawned ranks; returns the
    list of their results. A rank that raises, exits non-zero or outlives
    ``timeout_s`` fails the call (the others are killed)."""
    import torch.multiprocessing as mp

    ctx = mp.get_context("spawn")
    out = Path(tmp_path) / f"ranks_{body.__name__}_{time.monotonic_ns()}"
    out.mkdir(parents=True)
    procs = [ctx.Process(target=_rank_main,
                         args=(body.__name__, rank, world, str(out), args),
                         daemon=True)
             for rank in range(world)]
    for p in procs:
        p.start()
    deadline = time.monotonic() + timeout_s
    try:
        for p in procs:
            p.join(max(0.0, deadline - time.monotonic()))
        late = [r for r, p in enumerate(procs) if p.is_alive()]
        if late:
            raise TimeoutError(f"ranks {late} still running after "
                               f"{timeout_s}s")
    finally:
        for p in procs:
            if p.is_alive():
                p.kill()
                p.join(5)
    results = []
    for rank, p in enumerate(procs):
        f = out / f"rank{rank}.pkl"
        if not f.exists():
            raise RuntimeError(f"rank {rank} exited {p.exitcode} with no "
                               f"result")
        ok, value = pickle.loads(f.read_bytes())
        if not ok:
            raise RuntimeError(f"rank {rank} failed:\n{value}")
        results.append(value)
    return results


def _rank_main(name: str, rank: int, world: int, out: str, args) -> None:
    torch.set_num_threads(1)
    import torch.distributed as dist

    from runbooks_tpu_torch.parallel import distributed
    from runbooks_tpu_torch.parallel.mesh import MeshConfig, make_mesh

    try:
        distributed.initialize(
            60, backend="gloo", rank=rank, world_size=world,
            store=dist.FileStore(os.path.join(out, "store"), world))
        mesh = make_mesh(MeshConfig(fsdp=1, tensor=world))
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


def forward_logits(rank, mesh, spec: dict, tokens):
    """The tensor-parallel forward (no cache) of every rank on the same
    tokens: each rank's logits, its local parameter bytes and the plan's
    analytic ones."""
    from runbooks_tpu_torch.models.transformer import forward
    from runbooks_tpu_torch.parallel.sharding import (
        TensorParallel,
        serve_plan,
        shard_params,
    )
    from runbooks_tpu_torch.utils.tree import tree_leaves

    cfg, params = _model(spec)
    plan = serve_plan(cfg, mesh.size(mesh.mesh_dim_names.index("tensor")))
    local = shard_params(params, plan, rank)
    tp = TensorParallel(plan, rank, mesh.get_group("tensor"))
    with torch.no_grad():
        logits, _ = forward(cfg, local, torch.as_tensor(tokens), tp=tp)
    return {"logits": logits.numpy(), "plan": plan.describe(),
            "kv_map": tp.kv_map,
            "local_bytes": sum(t.numel() * t.element_size()
                               for t in tree_leaves(local)),
            "plan_bytes": plan.local_param_bytes(params, rank),
            "counts": dict(tp.counts)}


def serve(rank, mesh, spec: dict, cases: list, tokens=None):
    """Each case through an engine built on every rank with the mesh:
    rank 0 drives it (prefix registration, then one generate of the
    case's greedy requests) and the followers replay. Returns {"cases":
    rank 0's output ids, kv_occupancy and counters per case (None on a
    follower), "forward": forward_logits' result on ``tokens``, if
    given}."""
    from runbooks_tpu_torch.serve.engine import InferenceEngine, Request
    from runbooks_tpu_torch.serve.paging import PagedInferenceEngine

    out = {"forward": (None if tokens is None
                       else forward_logits(rank, mesh, spec, tokens))}
    cfg, params = _model(spec)
    results = out["cases"] = []
    for case in cases:
        kw = dict(case.get("engine", {}))
        if case["paged"]:
            engine = PagedInferenceEngine(cfg, params, mesh=mesh, **kw)
        else:
            engine = InferenceEngine(cfg, params, mesh=mesh, **kw)
        if rank:
            engine.serve_follower()
            results.append(None)
            continue
        try:
            for prefix in case.get("prefixes", []):
                engine.register_prefix(prefix)
            for turn in case.get("turns", []):
                # A chat turn: its prompt's K/V lifted from the slot
                # (no forward), as the worker does under auto_prefix.
                done = engine.generate([Request(
                    prompt_tokens=list(turn), max_tokens=case["max_tokens"],
                    temperature=0.0)])[0]
                engine.register_prefix_from_slot(done._slot, turn)
            reqs = [Request(prompt_tokens=list(p),
                            max_tokens=case["max_tokens"], temperature=0.0)
                    for p in case["prompts"]]
            engine.generate(reqs)
            results.append({
                "ids": [r.output_tokens for r in reqs],
                "occupancy": engine.kv_occupancy(),
                "spec_drafted": engine.spec_drafted,
                "prefix_tokens_reused": engine.prefix_tokens_reused,
                "kv_heads": int(engine.cache.k.shape[-2]),
                "counts": dict(engine.tp.counts)})
        finally:
            engine.stop_followers()
    return out


def refusals(rank, mesh, spec: dict) -> dict:
    """What a mesh engine refuses, by message: the paged geometry check
    and each feature out of the slice's scope under tensor > 1."""
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
            debug, debug_params, mesh=mesh, kv_host_pages=4),
        "preemption": lambda: InferenceEngine(cfg, params, mesh=mesh,
                                              preemption="swap"),
        "collective_matmul": lambda: InferenceEngine(
            dataclasses.replace(cfg, collective_matmul="auto"), params,
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


def serve_main() -> int:
    """The port's serving entry point over gloo on the CPU (the server
    subprocess of the HTTP tests)."""
    torch.set_num_threads(1)
    from runbooks_tpu_torch.serve import api

    return api.main(backend="gloo")


if __name__ == "__main__":
    if sys.argv[1:] == ["serve"]:
        raise SystemExit(serve_main())
    raise SystemExit(f"usage: {sys.argv[0]} serve")
