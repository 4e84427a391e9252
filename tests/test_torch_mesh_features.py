"""Sharded serving's features on the port's mesh engines: the adapter
pool, the host KV tier with preemption, quantized weights (int8, int4)
and the int8 KV cache, under ``mesh_tensor`` 2 and ``mesh_expert`` 2 x
``mesh_tensor`` 2.

Each mesh kind spawns one rank set (gloo ranks from tests/tp_ranks.py,
started while the reference computes) that runs every case of the
module, and one reference oracle per module-scoped fixture: the
reference's engines under the same mesh over the conftest's 8 virtual
CPU devices (tests/tp_oracle.ref_mesh / ref_ep_mesh). f32 weights from
the reference's init_params through models/bridge.py, at
tests/tp_oracle's "feat" (llama-shaped, 4/2 heads of 64, MLP 256) and
"moefeat" (the debug MoE with heads of 64) geometries, where the
row-parallel wo and mlp wo cut their contraction rows on a quantization
block of 128. Four rank-4 adapters from seeded numpy, written once per
side by each side's ``save_adapter``.

- Greedy ids of the port's sharded engine equal both the reference's
  mesh engine's and the port's one-process engine's: the pool (dense and
  paged), the host tier with preemption (the reference test's scenario:
  pages swapped out >= 2, swapped in >= 2, one preemption and one
  resume, no unexpected build after warmup on any rank), int8 and int4
  weights, the int8 KV cache.
- Each rank's pool and quantized leaves have the plan's shapes, and its
  pool and weight bytes the plan's share.
- Rank 1's ``b`` of a column target (attn.wq) taken from the other
  tensor rank's columns moves the pooled forward's logits far past the
  tolerance the correct shards keep (LOGITS_ATOL).
- Quantize-then-cut equals cut-then-quantize bit for bit (the engine's
  cut of a whole quantized tree and load_model's quantized shard), and a
  cut off the blocks is refused by name.
"""

import dataclasses
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from runbooks_tpu.serve import lora_pool as jax_lora_pool
from runbooks_tpu_torch.models.config import get_config
from runbooks_tpu_torch.models.transformer import forward
from runbooks_tpu_torch.ops.lora import adapter_tree_logical_axes, target_dims
from runbooks_tpu_torch.ops.quantization import (
    QuantizedArray,
    quantize_params,
)
from runbooks_tpu_torch.parallel.sharding import (
    check_quantized_cuts,
    serve_plan,
    shard_leaf,
    shard_params,
)
from runbooks_tpu_torch.serve import api, lora_pool
from runbooks_tpu_torch.utils.tree import tree_map
from tests import tp_oracle, tp_ranks

LOGITS_ATOL = tp_oracle.LOGITS_ATOL
PROMPTS = tp_oracle.PROMPTS
TENANTS = [f"tenant{i}" for i in range(4)]
POOL = {"adapter_pool": 4, "lora_rank": 8}
# The tensor mesh's pool targets the MLP too: the row-parallel mlp.wo's
# delta rides the MLP's all-reduce (MoE pools target attention only).
DENSE_TARGETS = ("attn.wq", "attn.wk", "attn.wv", "attn.wo", "mlp.wi_gate",
                 "mlp.wi_up", "mlp.wo")
FUSED_TARGETS = ("attn.wq", "attn.wk", "attn.wv", "attn.wo", "mlp.wi",
                 "mlp.wo")
SHARED = list(range(1, 33))              # two pages of 16
FAULT_TOKENS = np.random.default_rng(5).integers(0, 128, (4, 12))


def _cases(moe: bool) -> list:
    """Every case of one mesh kind, in the order the ranks run them.
    ``mesh_tensor`` 2 runs each feature: the pool on both engines, the
    host tier with preemption, int8 weights (with the int8 KV cache) and
    int4. ``mesh_expert`` 2 x ``mesh_tensor`` 2, whose attention is cut
    as the tensor mesh's, runs phase 25's mix (the paged pool with the
    int8 KV cache), the host tier and int4 (the reference's ep-mesh
    engines compile for ~8 s each)."""
    targets = {} if moe else {"config": {"lora_targets": DENSE_TARGETS}}
    pool_dense = {"name": "pool_dense", "paged": False,
                  "engine": dict(max_slots=4, **POOL), "prompts": PROMPTS,
                  "adapters": TENANTS, "max_tokens": 8, **targets}
    pool_paged = {"name": "pool_paged", "paged": True,
                  "engine": dict(max_slots=4, page_size=16,
                                 quantize_kv=moe, **POOL),
                  "prompts": PROMPTS, "adapters": TENANTS, "max_tokens": 8,
                  **targets}
    host_tier = {"name": "host_tier", "paged": True, "scenario": "host_tier",
                 "shared": SHARED,
                 "engine": dict(max_slots=1, page_size=16, num_pages=5,
                                kv_host_pages=8, preemption="swap",
                                decode_chunk=2)}
    int8 = {"name": "int8", "paged": True, "quantize": "int8",
            "engine": dict(max_slots=4, page_size=16, quantize_kv=True),
            "prompts": PROMPTS, "max_tokens": 8}
    int4 = {"name": "int4", "paged": False, "quantize": "int4",
            "engine": dict(max_slots=4), "prompts": PROMPTS,
            "max_tokens": 8}
    if moe:
        return [pool_paged, host_tier, int4]
    return [pool_dense, pool_paged, host_tier, int8, int4]


# (mesh kind, case) pairs of each check.
POOL_CASES = [("tensor2", "pool_dense"), ("tensor2", "pool_paged"),
              ("expert2", "pool_paged")]
QUANTIZED_CASES = [("tensor2", "int8"), ("tensor2", "int4"),
                   ("expert2", "int4")]
KV8_CASES = [("tensor2", "int8"), ("expert2", "pool_paged")]


def _adapters(cfg, root: str, targets, jax_side: bool = True) -> dict:
    """Four rank-4 adapters (alpha 8) of ``targets`` from seeded numpy,
    written by each side's save_adapter under root/jax and root/torch
    (the port's alone without ``jax_side``)."""
    for i, name in enumerate(TENANTS):
        rng = np.random.default_rng(10 + i)
        tree = {}
        for t in targets:
            d_in, d_out = target_dims(cfg, t)
            tree[t] = {
                "a": (rng.standard_normal((cfg.num_layers, d_in, 4))
                      * d_in ** -0.5).astype(np.float32),
                "b": (0.05 * rng.standard_normal(
                    (cfg.num_layers, 4, d_out))).astype(np.float32)}
        if jax_side:
            jax_lora_pool.save_adapter(
                os.path.join(root, "jax", name),
                {t: {k: jnp.asarray(v) for k, v in ab.items()}
                 for t, ab in tree.items()}, rank=4, alpha=8.0)
        lora_pool.save_adapter(
            os.path.join(root, "torch", name),
            {t: {k: torch.from_numpy(v) for k, v in ab.items()}
             for t, ab in tree.items()}, rank=4, alpha=8.0)
    return {"jax": os.path.join(root, "jax"),
            "torch": os.path.join(root, "torch")}


def _one_process_pool_logits(cfg, params, root: str) -> np.ndarray:
    """The one-process pooled forward's logits on FAULT_TOKENS, tenant i
    on lane i (the lanes the sharded run's admissions fill)."""
    pool = lora_pool.AdapterPool(cfg, pool_size=4, rank=8, root=root,
                                 device="cpu")
    assert pool.targets == tuple(cfg.lora_targets)
    assert [pool.acquire(n) for n in TENANTS] == [0, 1, 2, 3]
    with torch.no_grad():
        logits, _ = forward(cfg, params, torch.as_tensor(FAULT_TOKENS),
                            adapters=(pool.tree, torch.arange(4)))
    return logits.numpy()


def _world(tmp_path_factory, geometry: str, world: int, mesh: dict,
           ref_mesh) -> dict:
    """One mesh kind: its ranks (every case, the planted fault and, on
    the tensor mesh, the fused block's pooled forward), started first;
    the reference's mesh engines; the port's one-process engines and
    pooled logits."""
    tmp = tmp_path_factory.mktemp(geometry)
    jcfg, jparams, spec = tp_oracle.model(geometry, tmp)
    cfg, params = tp_ranks._model(spec)
    moe = bool(cfg.moe_num_experts)
    targets = cfg.lora_targets if moe else DENSE_TARGETS
    cfg = dataclasses.replace(cfg, lora_targets=targets)
    roots = _adapters(cfg, str(tmp / "adapters"), targets)
    forwards, fused = [], None
    if not moe:
        _, _, fspec = tp_oracle.model("fused", tmp)
        fspec["config"] = {"lora_targets": FUSED_TARGETS}
        fcfg, fparams = tp_ranks._model(fspec)
        fcfg = dataclasses.replace(fcfg, lora_targets=FUSED_TARGETS)
        froot = _adapters(fcfg, str(tmp / "fused_adapters"), FUSED_TARGETS,
                          jax_side=False)["torch"]
        forwards = [(fspec, froot, TENANTS, FAULT_TOKENS)]
        fused = _one_process_pool_logits(fcfg, fparams, froot)
    cases = _cases(moe)
    ranks = tp_ranks.start_ranks(
        tp_ranks.mesh_features, world, tmp, spec, cases, roots["torch"],
        {"case": 0, "tokens": FAULT_TOKENS, "lanes": [0, 1, 2, 3]},
        forwards, mesh=mesh, timeout_s=240)
    want = {c["name"]: tp_oracle.ref_features(jcfg, jparams, c, ref_mesh,
                                              roots["jax"])
            for c in cases}
    single = {c["name"]: tp_ranks.drive_features(
        tp_ranks.feature_engine(cfg, params, c, None, roots["torch"]), c)
        for c in cases}
    return {"cfg": cfg, "params": params, "cases": cases, "want": want,
            "single": single, "ranks": ranks.results(),
            "pool_logits": _one_process_pool_logits(cfg, params,
                                                    roots["torch"]),
            "fused_logits": fused}


@pytest.fixture(scope="module")
def tensor2(tmp_path_factory):
    return _world(tmp_path_factory, "feat", 2,
                  {"fsdp": 1, "tensor": 2}, tp_oracle.ref_mesh())


@pytest.fixture(scope="module")
def expert2(tmp_path_factory):
    return _world(tmp_path_factory, "moefeat", 4,
                  {"expert": 2, "fsdp": 1, "tensor": 2},
                  tp_oracle.ref_ep_mesh())


@pytest.fixture(params=["tensor2", "expert2"])
def world(request):
    """A mesh kind's results (indirectly parametrized by its name)."""
    return request.getfixturevalue(request.param)


def _got(world, name):
    i = next(i for i, c in enumerate(world["cases"]) if c["name"] == name)
    return (world["ranks"][0]["cases"][i], [r["cases"][i]
                                            for r in world["ranks"][1:]],
            world["want"][name], world["single"][name])


# ---------------------------------------------------------------------------
# Greedy ids against the reference's mesh engine and one process
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("world,case", POOL_CASES, indirect=["world"])
def test_adapter_pool_matches_reference_and_one_process(world, case):
    got, _, want, single = _got(world, case)
    assert got["ids"] == want["ids"] == single["ids"]
    # The leader's residency: tenant i paged into lane i.
    lanes = {os.path.basename(k): v for k, v in got["lanes"].items()}
    assert lanes == {n: i for i, n in enumerate(TENANTS)}


def test_host_tier_and_preemption_match_with_no_unexpected_builds(world):
    got, followers, want, single = _got(world, "host_tier")
    assert got["ids"] == want["ids"] == single["ids"]
    assert got["evicted"] == 2
    assert got["swapped_out"] >= 2 and got["swapped_in"] >= 2
    assert got["preemptions"] == 1 == got["resumed"]
    for key in ("evicted", "swapped_out", "swapped_in", "preemptions",
                "resumed"):
        assert got[key] == want[key], key
    # No unexpected first dispatch after warmup, on any rank.
    assert got["unexpected"] == 0
    assert all(f["unexpected"] == 0 for f in followers)


@pytest.mark.parametrize("world,case", QUANTIZED_CASES,
                         indirect=["world"])
def test_quantized_weights_match_reference_and_one_process(world, case):
    got, _, want, single = _got(world, case)
    assert got["ids"] == want["ids"] == single["ids"]


@pytest.mark.parametrize("world,case", KV8_CASES, indirect=["world"])
def test_int8_kv_cache_matches_reference_and_one_process(world, case):
    spec = next(c for c in world["cases"] if c["name"] == case)
    assert spec["engine"]["quantize_kv"]
    got, _, want, single = _got(world, case)
    assert got["ids"] == want["ids"] == single["ids"]


# ---------------------------------------------------------------------------
# Each rank's pieces are the plan's
# ---------------------------------------------------------------------------

def test_each_ranks_pool_and_quantized_leaves_are_the_plans(world):
    cfg, params = world["cfg"], world["params"]
    mc = {"tensor": 2, "expert": 1 if not cfg.moe_num_experts else 2}
    plan = serve_plan(cfg, mc["tensor"], mc["expert"])
    L, d = cfg.num_layers, cfg.head_dim
    q, kv = cfg.num_heads // 2, cfg.num_kv_heads // 2
    h = cfg.hidden_size
    pool_shapes = {"attn.wq.a": (L, 5, h, 8), "attn.wq.b": (L, 5, 8, q * d),
                   "attn.wk.a": (L, 5, h, 8), "attn.wk.b": (L, 5, 8, kv * d),
                   "attn.wv.a": (L, 5, h, 8), "attn.wv.b": (L, 5, 8, kv * d),
                   "attn.wo.a": (L, 5, q * d, 8), "attn.wo.b": (L, 5, 8, h)}
    if not cfg.moe_num_experts:
        m = cfg.intermediate_size // 2
        pool_shapes.update({
            "mlp.wi_gate.a": (L, 5, h, 8), "mlp.wi_gate.b": (L, 5, 8, m),
            "mlp.wi_up.a": (L, 5, h, 8), "mlp.wi_up.b": (L, 5, 8, m),
            "mlp.wo.a": (L, 5, m, 8), "mlp.wo.b": (L, 5, 8, h)})
    names = [c["name"] for c in world["cases"]]
    for rank, r in enumerate(world["ranks"]):
        shapes = dict(zip(names, r["shapes"]))
        pooled = shapes["pool_paged"]
        assert pooled["pool"] == pool_shapes
        # The plan's share: each lane leaf cut by its logical axes.
        share = 0
        for t in cfg.lora_targets:
            (d_in, d_out), axes = target_dims(cfg, t), \
                adapter_tree_logical_axes(t)
            for k, shape in (("a", (L, 5, d_in, 8)), ("b", (L, 5, 8, d_out))):
                share += 4 * int(np.prod(plan.local_shape(
                    shape, (None,) + axes[k], rank)))
        assert pooled["pool_bytes"] == share
        for mode in ("int8", "int4"):
            if mode not in shapes:
                continue
            quantized = quantize_params(tree_map(lambda t: t, params), mode)
            local = shard_params(quantized, plan, rank)
            assert shapes[mode]["quantized"] == {
                f"{g}.{n}": (tuple(w.values.shape), tuple(w.scales.shape))
                for g in ("attn", "mlp")
                for n, w in local["layers"].get(g, {}).items()
                if isinstance(w, QuantizedArray)}
            assert shapes[mode]["weight_bytes"] == \
                plan.local_param_bytes(quantized, rank)
        kv8 = [c for w, c in KV8_CASES
               if c in shapes and w == ("expert2" if cfg.moe_num_experts
                                        else "tensor2")]
        assert kv8 and all(shapes[c]["kv_dtype"] == "torch.int8"
                           and shapes[c]["kv_heads"] == kv for c in kv8)
        assert shapes["host_tier"]["kv_dtype"] == "torch.float32"
    # The experts are not quantized under mesh_expert.
    if cfg.moe_num_experts:
        assert set(world["ranks"][0]["shapes"][names.index("int4")][
            "quantized"]) == {"attn.wq", "attn.wk", "attn.wv", "attn.wo"}


def test_planted_column_fault_in_rank_1s_pool_is_caught(world):
    want = world["pool_logits"]
    for r in world["ranks"]:
        np.testing.assert_allclose(r["fault"]["logits"], want,
                                   atol=LOGITS_ATOL, rtol=0)
    gaps = [float(np.abs(r["fault"]["planted"] - want).max())
            for r in world["ranks"]]
    assert min(gaps) > 100 * LOGITS_ATOL, gaps


def test_fused_parallel_block_counts_row_parallel_deltas_once(tensor2):
    """Falcon's parallel block under tensor 2 sums attention's and the
    MLP's partial products in one all-reduce: the pooled wo and mlp.wo
    deltas (each rank's partial sums) enter it once, so every rank's
    logits are one process's pooled forward's."""
    for r in tensor2["ranks"]:
        np.testing.assert_allclose(r["pool_forwards"][0],
                                   tensor2["fused_logits"],
                                   atol=LOGITS_ATOL, rtol=0)


# ---------------------------------------------------------------------------
# Quantize and cut commute; an off-boundary cut is refused
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("mode", ["int8", "int4"])
@pytest.mark.parametrize("geometry,tensor,expert", [
    ("feat", 2, 1), ("moefeat", 2, 2), ("feat", 4, 1)])
def test_quantize_then_cut_equals_cut_then_quantize(tmp_path, monkeypatch,
                                                    geometry, tensor,
                                                    expert, mode):
    """The engine's cut of the whole quantized tree (shard_leaf by whole
    blocks) and load_model's shard quantized on the whole tree's blocks
    are the same tensors, bit for bit, on every rank; llama3-8b's wo and
    mlp wo cut on blocks at tensor 2, 4 and 8."""
    family, over = tp_oracle.GEOMETRIES[geometry]
    if tensor == 4:
        over = dict(over, num_heads=8, num_kv_heads=4, intermediate_size=512)
    cfg = get_config(family, **over)
    params = {"model": family, "model_overrides": over, "seed": 3,
              "quantize": mode}
    monkeypatch.setenv("RBT_CONTENT_DIR", str(tmp_path))
    _, full = api.load_model(dict(params, quantize="none"), device="cpu")
    whole = quantize_params(tree_map(lambda t: t, full), mode)
    plan = serve_plan(cfg, tensor, expert)
    for rank in range(plan.world):
        cut = shard_params(whole, plan, rank)
        _, loaded = api.load_model(params, device="cpu",
                                   shard=(tensor, rank, expert))
        for a, b in zip(jax.tree.leaves(tree_map(_parts, cut)),
                        jax.tree.leaves(tree_map(_parts, loaded)),
                        strict=True):
            assert a.dtype == b.dtype and torch.equal(a, b)
    llama = get_config("llama3-8b")
    for t in (2, 4, 8):
        check_quantized_cuts(serve_plan(llama, t), mode)


def _parts(leaf):
    if isinstance(leaf, QuantizedArray):
        return {"values": leaf.values, "scales": leaf.scales,
                "meta": torch.tensor([leaf.bits, leaf.block_size])}
    return leaf


def test_off_boundary_quantized_cut_is_refused_by_name(tmp_path,
                                                       monkeypatch):
    """The debug MoE's heads of 8 (q_dim 32) quantize in one block of 32
    rows; tensor 2 would cut wo's rows at 16. The engine's cut, the
    sharded load and main's parse each refuse it by name."""
    family, over = tp_oracle.GEOMETRIES["moe4"]
    cfg = get_config(family, **over)
    plan = serve_plan(cfg, 2, 2)
    with pytest.raises(NotImplementedError,
                       match=r"attn\.wo quantized int8 .*off-boundary"):
        check_quantized_cuts(plan, "int8", 1)
    _, full = api.load_model({"model": family, "model_overrides": over},
                             device="cpu")
    whole = quantize_params(full, "int8")
    with pytest.raises(NotImplementedError,
                       match=r"attn\.wo quantized int8 .*rank 1's rows "
                             r"16:32"):
        shard_leaf(whole["layers"]["attn"]["wo"], ("layers", "heads",
                                                   "embed"),
                   plan, 1, "attn.wo")
    monkeypatch.setenv("RBT_CONTENT_DIR", str(tmp_path))
    p = {"model": family, "model_overrides": over, "quantize": "int8",
         "mesh_expert": 2, "mesh_tensor": 2}
    with pytest.raises(NotImplementedError, match="off-boundary"):
        api.refuse_unported(p)
    with pytest.raises(NotImplementedError, match="off-boundary"):
        api.load_model(p, device="cpu", shard=(2, 1, 2))
    # Column cuts and whole blocks are served: wq, and wo at tensor 1.
    shard_leaf(whole["layers"]["attn"]["wq"], ("layers", "embed", "heads"),
               plan, 1)
    check_quantized_cuts(serve_plan(cfg, 1, 2), "int8")
