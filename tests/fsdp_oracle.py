"""The reference side of the FSDP train-step tests
(tests/test_torch_fsdp_train*.py): the geometries, the cases' batches,
the reference's sharded step under a MeshConfig on the conftest's
virtual CPU devices, its initial trees carried to the port's layout and
saved where the ranks (tests/tp_ranks.fsdp_cases) load them, and the
checks.

Imported by the test modules only; the spawned ranks import
tests/tp_ranks.py, which never imports JAX.
"""

from __future__ import annotations

import zlib

import jax
import jax.numpy as jnp
import numpy as np
import torch

from runbooks_tpu.models.config import get_config as jax_get_config
from runbooks_tpu.models.transformer import param_logical_axes
from runbooks_tpu.parallel.mesh import MeshConfig, make_mesh
from runbooks_tpu.parallel.sharding import tree_shardings
from runbooks_tpu.train import lora as jax_lora
from runbooks_tpu.train import optimizer as jax_opt
from runbooks_tpu.train import step as jax_step
from runbooks_tpu_torch.models import bridge
from runbooks_tpu_torch.models.config import get_config
from runbooks_tpu_torch.train import data
from runbooks_tpu_torch.utils.tree import tree_leaves
from tests import tp_ranks

TOL = 1e-5
OPT = dict(learning_rate=1e-3, warmup_steps=0, total_steps=10, eps=1e-3)
STEPS = 2
_BASE = dict(vocab_size=128, intermediate_size=128, num_layers=2,
             head_dim=16, max_seq_len=64, dtype="float32")
GEOMETRIES = {
    "llama": ("llama2-7b", dict(_BASE, hidden_size=64, num_heads=4,
                                num_kv_heads=2)),
    "falcon": ("falcon-7b", dict(_BASE, hidden_size=48, num_heads=3,
                                 num_kv_heads=1)),
    "gpt2": ("gpt2", dict(_BASE, hidden_size=64, num_heads=4,
                          num_kv_heads=4)),
    # The reference's sharded step routes the global microbatch.
    "mixtral": ("mixtral-8x7b", dict(_BASE, hidden_size=64, num_heads=4,
                                     num_kv_heads=2, moe_num_experts=4,
                                     moe_top_k=2,
                                     moe_capacity_factor=1.25)),
}
LORA = dict(rank=4, alpha=8.0)


def batches(seed, rows, uneven):
    """STEPS packed batches; ``uneven`` zeroes the loss mask of the first
    half of the first batch's rows (a rank with no weighted token) and of
    one row of the second."""
    rng = np.random.default_rng(seed)
    docs = [rng.integers(1, 128, int(rng.integers(5, 40))).tolist()
            for _ in range(60 * STEPS)]
    it = data.batch_rows(data.pack_documents(docs, 32), rows)
    out = [next(it) for _ in range(STEPS)]
    if uneven:
        out[0]["loss_mask"][:max(1, rows // 2)] = 0
        out[1]["loss_mask"][-1] = 0
    return out


def reference(name, spec, mesh_cfg, tmp_path):
    """The rank case of ``spec`` (geometry, LoRA targets or None, rows,
    accumulate_steps, uneven masks, and optionally True to reduce-scatter
    by all-reduce as gloo does on CUDA tensors), its initial trees saved
    in the port's layout, and the reference's prepared step under
    ``mesh_cfg``."""
    geometry, targets, rows, k, uneven, *by_all_reduce = spec
    family, over = GEOMETRIES[geometry]
    jcfg = jax_get_config(family, **over)
    n = mesh_cfg.data * mesh_cfg.fsdp
    mesh = make_mesh(mesh_cfg, devices=jax.devices()[:n])
    jo = jax_opt.make_optimizer(jax_opt.OptimizerConfig(**OPT))
    steps = batches(zlib.crc32(name.encode()), rows, uneven)
    case = {"model": family, "overrides": over, "opt": OPT,
            "batches": steps, "k": k, "params": str(tmp_path / f"{name}.pt"),
            "by_all_reduce": bool(by_all_reduce and by_all_reduce[0])}
    state, sh = jax_step.create_train_state(jcfg, jo, mesh,
                                            jax.random.key(0))
    base = state.params
    if targets is not None:
        base_sh = tree_shardings(jax.eval_shape(lambda: base),
                                 param_logical_axes(jcfg), mesh)
        jl = jax_lora.LoraConfig(targets=targets, **LORA)
        state, sh = jax_lora.create_lora_train_state(
            jcfg, jl, base, jo, mesh, jax.random.key(1))
        # A non-zero B: the first step's gradients reach A too.
        state.params = jax.tree.map(lambda x: x + 0.01, state.params)
        lstep = jax_lora.make_lora_train_step(jcfg, jl, jo, mesh, sh,
                                              base_sh, accumulate_steps=k)
        step = lambda s, b: lstep(s, base, b)  # noqa: E731
        lora_path = tmp_path / f"{name}.lora.pt"
        torch.save(bridge.tree_from_numpy(
            jax.tree.map(np.asarray, state.params)), lora_path)
        case["lora"] = {"config": dict(LORA, targets=tuple(targets)),
                        "init": str(lora_path)}
    else:
        step = jax_step.make_train_step(jcfg, jo, mesh, sh,
                                        accumulate_steps=k)
    torch.save(bridge.from_jax_numpy(get_config(family, **over),
                                     jax.tree.map(np.asarray, base)),
               case["params"])
    return case, (step, state, mesh, steps)


def run_reference(prepared):
    step, state, mesh, steps = prepared
    history = []
    with jax.set_mesh(mesh):
        for b in steps:
            state, m = step(state, {k: jnp.asarray(v) for k, v in b.items()})
            history.append({"loss": float(m["loss"]),
                            "grad_norm": float(m["grad_norm"])})
    return history, jax.tree.map(np.asarray, state.params)


def run_cases(specs, mesh, tmp_path):
    """Every case's inputs, the ranks started on all of them in one spawn,
    the reference's steps while they run: {name: (reference, ranks')}."""
    mesh_cfg = MeshConfig(sequence=1, tensor=1, **mesh)
    prepared = {name: reference(name, spec, mesh_cfg, tmp_path)
                for name, spec in specs.items()}
    ranks = tp_ranks.start_ranks(
        tp_ranks.fsdp_cases, mesh_cfg.data * mesh_cfg.fsdp, tmp_path,
        [case for case, _ in prepared.values()], mesh=mesh,
        timeout_s=240)
    want = {name: run_reference(p) for name, (_, p) in prepared.items()}
    got = ranks.results()
    return {name: (want[name], [r[i] for r in got])
            for i, name in enumerate(specs)}


def check(result):
    """Each rank's per-step loss and gradient norm against the
    reference's (TOL relative), its parameter bytes against the plan's,
    and rank 0's whole trainable tree after the steps (TOL absolute)."""
    (want_hist, want_params), ranks = result
    for r in ranks:
        assert len(r["history"]) == STEPS
        for h, w in zip(r["history"], want_hist):
            np.testing.assert_allclose(h["loss"], w["loss"], rtol=TOL)
            np.testing.assert_allclose(h["grad_norm"], w["grad_norm"],
                                       rtol=TOL)
            assert h["nonfinite"] == 0
        assert r["local_bytes"] == r["plan_bytes"]
    got = ranks[0]["trainable"]
    assert all(r["trainable"] is None for r in ranks[1:])
    for a, b in zip(jax.tree.leaves(want_params), tree_leaves(got),
                    strict=True):
        np.testing.assert_allclose(b, a, atol=TOL)
    return ranks
