"""Expert-parallel serving of the port: an MoE model over ``mesh_expert``
x ``mesh_tensor`` ranks (parallel/sharding.serve_plan's expert axis,
models/moe.moe_block's combine over the serving group, the engines'
leader and replay over every rank).

The model is tests/test_torch_mixtral.py's debug MoE (4 experts, top 2,
f32, 2 layers; tests/tp_oracle.MOE), weights from the reference's
``init_params`` through models/bridge.py.

- The plan (no ranks): expert ranges and cut shapes, ``local_param_bytes``
  against the cut tree, the experts replicated where ``expert`` does not
  divide them (3 on 2), the router whole.
- World 4 (expert 2 x tensor 2, gloo ranks from tests/tp_ranks.py):
  every rank's forward logits within LOGITS_ATOL of the reference's
  forward sharded over ``MeshConfig(data=1, expert=2, fsdp=2, tensor=2)``
  on the conftest's 8 virtual CPU devices, every rank's routing equal
  layer by layer, the collectives of one forward by group, and the dense
  and paged engines' greedy ids equal to the reference's engines under
  that mesh (tests/test_moe.py serves MoE so), their prefill logits
  within LOGITS_ATOL of the port's single-process engines'. The f32
  all-reduces sum the tensor ranks' partial products in another order
  than one device's matmul: LOGITS_ATOL is tp_oracle's 1e-4.
- World 2 (expert 2 x tensor 1): no tensor rounding is left, and for
  k = 2 the f64 combine adds to a rank's own sum either zeros or the
  other expert's term, so the forward logits, the engines' prefill logits
  and ids are bit-equal to one process's. With 3 experts (replicated)
  rank 0 alone sums the experts (``moe_owner``): bit-equal as well.
  The same ranks refuse collective_matmul "ring" by name, and build
  what sharded serving takes: quantized weights (tensor 1 cuts no
  contraction rows), the int8 KV cache, the adapter pool, the host tier
  and preemption (served: tests/test_torch_mesh_features.py).
"""

import dataclasses

import numpy as np
import pytest
import torch

from runbooks_tpu_torch.models.config import get_config
from runbooks_tpu_torch.models.transformer import (
    forward,
    init_params,
    param_logical_axes,
)
from runbooks_tpu_torch.parallel.sharding import serve_plan, shard_params
from runbooks_tpu_torch.utils.tree import tree_leaves
from tests import tp_oracle, tp_ranks

LOGITS_ATOL = tp_oracle.LOGITS_ATOL
PROMPTS = [[5, 9, 17], list(range(1, 11)), [7, 30, 2, 2, 9, 41, 5],
           [11, 12, 13]]
SHARED = list(range(20, 36))          # two pages of 8
DENSE = {"paged": False,
         "engine": {"max_slots": 4, "max_seq_len": 32, "decode_chunk": 4},
         "prompts": PROMPTS, "max_tokens": 6}
PAGED = {"paged": True,
         "engine": {"max_slots": 4, "max_seq_len": 32, "page_size": 8},
         "prefixes": [SHARED],
         "prompts": [SHARED + [3], PROMPTS[0], SHARED + [40, 41, 9],
                     PROMPTS[3]],
         "max_tokens": 6}
TOKENS = np.random.default_rng(3).integers(0, 64, (2, 20))
EP4 = {"expert": 2, "fsdp": 1, "tensor": 2}
EP2 = {"expert": 2, "fsdp": 1, "tensor": 1}


def _cfg(experts=4):
    return get_config("debug", **dict(tp_oracle.MOE,
                                      moe_num_experts=experts))


# ---------------------------------------------------------------------------
# The plan
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("tensor,expert", [(2, 2), (1, 2), (2, 1), (1, 4)])
def test_serve_plan_expert_ranges_and_cut_shapes(tensor, expert):
    cfg = _cfg()
    plan = serve_plan(cfg, tensor, expert)
    assert plan.world == tensor * expert
    assert plan.experts == (expert > 1)
    L, E, h, m = cfg.num_layers, 4, cfg.hidden_size, cfg.intermediate_size
    params = init_params(cfg, None, torch.device("meta"))
    for rank in range(plan.world):
        e, t = plan.coords(rank)
        # expert outer, tensor inner (MESH_AXES order).
        assert rank == e * tensor + t
        n = E // expert
        assert plan.expert_range(rank) == range(e * n, (e + 1) * n)
        assert plan.mlp_range(rank) == plan.mlp_range(t)
        assert plan.q_heads(rank) == serve_plan(cfg, tensor).q_heads(t)
        moe = shard_params(params, plan, rank)["layers"]["moe"]
        assert moe["router"].shape == (L, h, E)      # whole
        assert moe["wi_gate"].shape == (L, n, h, m // tensor)
        assert moe["wi_up"].shape == (L, n, h, m // tensor)
        assert moe["wo"].shape == (L, n, m // tensor, h)
        assert plan.moe_owner(rank)


@pytest.mark.parametrize("tensor,expert", [(2, 2), (1, 2)])
def test_local_param_bytes_equal_the_cut_tree(tensor, expert):
    cfg = dataclasses.replace(_cfg(), param_dtype="bfloat16")
    full = init_params(cfg, torch.Generator().manual_seed(0),
                       torch.device("cpu"))
    plan = serve_plan(cfg, tensor, expert)
    total = sum(t.numel() * t.element_size() for t in tree_leaves(full))
    expert_bytes = sum(full["layers"]["moe"][k].numel() * 2
                       for k in ("wi_gate", "wi_up", "wo"))
    for rank in range(plan.world):
        local = shard_params(full, plan, rank)
        got = sum(t.numel() * t.element_size() for t in tree_leaves(local))
        assert got == plan.local_param_bytes(full, rank)
        # The experts are cut by expert x tensor, the rest by tensor.
        local_experts = sum(local["layers"]["moe"][k].numel() * 2
                            for k in ("wi_gate", "wi_up", "wo"))
        assert local_experts * plan.world == expert_bytes
        assert got < total or plan.world == 1
    # The cut leaves are the full leaves' pieces.
    local = shard_params(full, plan, plan.world - 1)
    e0 = plan.expert_range(plan.world - 1).start
    m0 = plan.mlp_range(plan.world - 1)
    want = full["layers"]["moe"]["wo"][:, e0:e0 + 4 // expert,
                                       m0.start:m0.stop]
    assert torch.equal(local["layers"]["moe"]["wo"], want)


def test_experts_replicate_when_expert_does_not_divide_them():
    """3 experts on 2 expert ranks: the reference drops the axis (the
    experts replicate), so each rank holds all three, and only expert
    index 0 enters the combine's sum (each piece counted once)."""
    cfg = _cfg(3)
    for tensor in (1, 2):
        plan = serve_plan(cfg, tensor, 2)
        assert not plan.experts
        assert plan.describe()["experts"] is False
        assert [plan.expert_range(r) for r in range(plan.world)] == \
            [range(3)] * plan.world
        assert [plan.moe_owner(r) for r in range(plan.world)] == \
            [e == 0 for e in range(2) for _ in range(tensor)]
    axes = param_logical_axes(cfg)["layers"]["moe"]
    assert axes["router"][-1] == axes["wo"][1] == "experts"
    params = init_params(cfg, None, torch.device("meta"))
    moe = shard_params(params, serve_plan(cfg, 1, 2), 1)["layers"]["moe"]
    assert moe["wi_gate"].shape == params["layers"]["moe"]["wi_gate"].shape


# ---------------------------------------------------------------------------
# World 4: expert 2 x tensor 2 against the reference's mesh engine
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def world4(tmp_path_factory):
    """The four ranks' forward and both engines (started first, while the
    reference's mesh engine and forward compute here), the reference's
    results and the port's single-process engines'."""
    tmp = tmp_path_factory.mktemp("ep4")
    jcfg, jparams, spec = tp_oracle.model("moe4", tmp)
    ranks = tp_ranks.start_ranks(tp_ranks.serve, 4, tmp, spec,
                                 [DENSE, PAGED], TOKENS, mesh=EP4,
                                 timeout_s=180)
    mesh = tp_oracle.ref_ep_mesh()
    want = {"logits": tp_oracle.ref_logits(jcfg, jparams, TOKENS, mesh),
            "dense": tp_oracle.ref_serve(jcfg, jparams, DENSE, mesh),
            "paged": tp_oracle.ref_serve(jcfg, jparams, PAGED, mesh)}
    cfg, params = tp_ranks._model(spec)
    single = {name: tp_ranks.drive(tp_ranks.make_engine(cfg, params, case),
                                   case)
              for name, case in (("dense", DENSE), ("paged", PAGED))}
    return cfg, ranks.results(), want, single


def test_four_ranks_forward_matches_reference_and_routes_alike(world4):
    cfg, ranks, want, _ = world4
    fwd = [r["forward"] for r in ranks]
    for r in fwd:
        np.testing.assert_allclose(r["logits"], want["logits"],
                                   atol=LOGITS_ATOL, rtol=0)
        assert r["local_bytes"] == r["plan_bytes"]
        assert r["plan"] == {"tensor": 2, "heads": True, "kv_heads": True,
                             "mlp": True, "vocab": True, "expert": 2,
                             "experts": True}
        assert r["local_shapes"]["wi_gate"] == (2, 2, 32, 24)
        assert r["local_shapes"]["router"] == (2, 32, 4)
    # Every rank routes every token alike, layer by layer: the same
    # experts, slots, drops and gates, bit for bit.
    assert [len(r["routing"]) for r in fwd] == [cfg.num_layers] * 4
    for r in fwd[1:]:
        for layer, ref in zip(r["routing"], fwd[0]["routing"]):
            for key in ("expert", "slot", "keep", "gate"):
                assert np.array_equal(layer[key], ref[key]), key
    assert 0 < fwd[0]["routing"][0]["keep"].mean() < 1   # capacity drops
    # One forward: on the tensor group the embedding's reduce, one
    # attention reduce a layer, one logit gather; on the serving group
    # one combine a layer.
    assert fwd[0]["group_counts"] == {
        "tensor": {"all_reduce": 1 + cfg.num_layers, "all_gather": 1,
                   "broadcast": 0},
        "serve": {"all_reduce": cfg.num_layers, "all_gather": 0,
                  "broadcast": 0}}


@pytest.mark.parametrize("kind", ["dense", "paged"])
def test_four_ranks_engines_match_reference_mesh_engine(world4, kind):
    _, ranks, want, single = world4
    got = ranks[0]["cases"][0 if kind == "dense" else 1]
    assert all(r["cases"] == [None, None] for r in ranks[1:])
    assert got["ids"] == want[kind]["ids"] == single[kind]["ids"]
    assert got["collective_matmul"] == "all_reduce"
    assert got["prefix_tokens_reused"] == want[kind][
        "prefix_tokens_reused"] == (16 * 2 if kind == "paged" else 0)
    assert len(got["prefill_logits"]) == len(single[kind]["prefill_logits"])
    for a, b in zip(got["prefill_logits"], single[kind]["prefill_logits"]):
        np.testing.assert_allclose(a, b, atol=LOGITS_ATOL, rtol=0)
    # Sampled ids went out over the serving group each decode step.
    assert got["counts"]["broadcast"] > 0


# ---------------------------------------------------------------------------
# World 2: expert 2 alone, bit-equal to one process
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def world2(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("ep2")
    runs, specs = [], {}
    for name in ("moe4", "moe3"):
        _, _, spec = tp_oracle.model(name, tmp)
        specs[name] = spec
        runs.append((spec, [DENSE, PAGED], TOKENS))
    ranks = tp_ranks.start_ranks(tp_ranks.serve_specs, 2, tmp, runs,
                                 specs["moe4"], mesh=EP2, timeout_s=180)
    single = {}
    for name, spec in specs.items():
        cfg, params = tp_ranks._model(spec)
        with torch.no_grad():
            logits, _ = forward(cfg, params, torch.as_tensor(TOKENS))
        single[name] = {"logits": logits.numpy(), "cases": [
            tp_ranks.drive(tp_ranks.make_engine(cfg, params, case), case)
            for case in (DENSE, PAGED)]}
    got = ranks.results()
    out = {name: ([r[i] for r in got], single[name])
           for i, name in enumerate(specs)}
    out["refusals"] = [r[-1] for r in got]
    return out


@pytest.mark.parametrize("name", ["moe4", "moe3"])
def test_expert_ranks_alone_are_bit_equal_to_one_process(world2, name):
    ranks, single = world2[name]
    for r in ranks:
        fwd = r["forward"]
        assert np.array_equal(fwd["logits"], single["logits"])
        assert fwd["local_bytes"] == fwd["plan_bytes"]
        assert fwd["group_counts"]["tensor"] == {
            "all_reduce": 0, "all_gather": 0, "broadcast": 0}
        assert fwd["group_counts"]["serve"]["all_reduce"] == 2
    experts = {"moe4": (2, 32, 48), "moe3": (3, 32, 48)}[name]
    assert ranks[0]["forward"]["local_shapes"]["wi_gate"][1:] == experts
    for got, want in zip(ranks[0]["cases"], single["cases"]):
        assert got["ids"] == want["ids"]
        assert len(got["prefill_logits"]) == len(want["prefill_logits"])
        for a, b in zip(got["prefill_logits"], want["prefill_logits"]):
            assert np.array_equal(a, b)


def test_expert_ranks_refuse_what_the_sharded_engines_leave_out(world2):
    for r in world2["refusals"]:
        # Two kv heads on one tensor rank: the paged engine serves.
        assert r["paged"] is None
        assert "DeviceMesh" in r["not_a_mesh"]
        refused = r["collective_matmul"]
        assert refused.startswith("NotImplementedError"), refused
        assert "collective_matmul='ring'" in refused, refused
        assert "mesh_expert=2)" in refused, refused
        # Lifted: each is built on the expert ranks.
        for name in ("quantized", "quantized_on_blocks", "quantize_kv",
                     "adapter_pool", "host_tier", "preemption"):
            assert r[name] is None, (name, r[name])
