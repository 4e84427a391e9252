"""The reference side of the tensor- and expert-parallel tests: the
geometries, the reference's weights carried to a file the port's ranks
load, and the reference's mesh engine (``tensor=2`` over the conftest's 8
virtual CPU devices, as tests/test_mesh_serving.py builds it; ``expert=2``
x ``tensor=2`` for an MoE model, as tests/test_moe.py serves one) as the
oracle.

Imported by the test modules only; the spawned ranks import
tests/tp_ranks.py, which never imports JAX.
"""

from __future__ import annotations

import jax
import numpy as np
import torch

from runbooks_tpu.models.config import get_config as jax_get_config
from runbooks_tpu.models.transformer import forward as jax_forward
from runbooks_tpu.models.transformer import init_params as jax_init
from runbooks_tpu.models.transformer import param_logical_axes
from runbooks_tpu.parallel.mesh import MeshConfig, make_mesh
from runbooks_tpu.parallel.sharding import tree_shardings
from runbooks_tpu.serve.engine import InferenceEngine, Request
from runbooks_tpu.serve.paging import PagedInferenceEngine
from runbooks_tpu_torch.models import bridge
from runbooks_tpu_torch.models.config import get_config
from tests import tp_ranks

_BASE = dict(vocab_size=128, intermediate_size=128, num_layers=2,
             head_dim=16, max_seq_len=64, dtype="float32")

# name -> (config, overrides): both sides shard (llama's 4 on 2); q heads
# shard over replicated kv heads with a non-uniform map (6 on 3); heads
# replicate while the MLP and the vocabulary shard (falcon's parallel
# block, 3 on 1, as falcon-7b's 71 heads at tp 2 or 4); a tied head with
# learned positions (gpt2).
GEOMETRIES = {
    "4on2": ("llama2-7b", dict(_BASE, hidden_size=64, num_heads=4,
                               num_kv_heads=2)),
    "6on3": ("llama2-7b", dict(_BASE, hidden_size=96, num_heads=6,
                               num_kv_heads=3)),
    "3on1": ("falcon-7b", dict(_BASE, hidden_size=48, num_heads=3,
                               num_kv_heads=1)),
    "tied": ("gpt2", dict(_BASE, hidden_size=64, num_heads=4,
                          num_kv_heads=4)),
}

# tests/test_torch_mixtral.py's debug MoE (tests/test_moe.py's size: 4
# experts, top 2, f32, 2 layers), and the same with 3 experts, which 2
# expert ranks do not divide (the experts replicate).
MOE = dict(vocab_size=64, hidden_size=32, intermediate_size=48,
           num_layers=2, num_heads=4, num_kv_heads=2, head_dim=8,
           max_seq_len=32, dtype="float32", moe_num_experts=4,
           moe_top_k=2, moe_capacity_factor=1.25)
GEOMETRIES["moe4"] = ("debug", MOE)
GEOMETRIES["moe3"] = ("debug", dict(MOE, moe_num_experts=3))

PROMPTS = [[5, 9, 17], [3, 4, 5, 6, 7], [40, 2], [8, 8, 8, 9]]
REP_PROMPT = [5, 6, 7, 8] * 5 + [5, 6]
SHARED = list(range(1, 33))

# f32 logits of the two-rank forward against the reference's: the
# all-reduce sums the two ranks' partial products in another order than
# one device's matmul.
LOGITS_ATOL = 1e-4


def ref_mesh():
    return make_mesh(MeshConfig(data=1, fsdp=4, tensor=2))


def ref_ep_mesh():
    """The reference's expert x tensor serving mesh over the 8 virtual
    devices (fsdp takes the remaining 2)."""
    return make_mesh(MeshConfig(data=1, expert=2, fsdp=2, tensor=2))


def model(name: str, tmp_path, seed: int = 0):
    """(reference cfg, reference params, the ranks' model spec): the
    reference's init_params, carried to the port's layout by the bridge
    and saved where the ranks load it."""
    family, over = GEOMETRIES[name]
    jcfg = jax_get_config(family, **over)
    jparams = jax_init(jcfg, jax.random.key(seed))
    tparams = bridge.from_jax_numpy(get_config(family, **over),
                                    jax.tree.map(np.asarray, jparams))
    path = str(tmp_path / f"{name}.pt")
    torch.save(tparams, path)
    return jcfg, jparams, {"model": family, "overrides": over,
                           "params": path}


def ref_logits(jcfg, jparams, tokens, mesh):
    """The reference's forward with its params sharded over ``mesh``."""
    specs = tree_shardings(jax.eval_shape(lambda: jparams),
                           param_logical_axes(jcfg), mesh)
    sharded = jax.device_put(jparams, specs)
    with jax.set_mesh(mesh):
        out = jax.jit(lambda p, t: jax_forward(jcfg, p, t)[0])(
            sharded, np.asarray(tokens, np.int32))
    return np.asarray(out)


def ref_serve(jcfg, jparams, case: dict, mesh) -> dict:
    """The reference mesh engine on a ``tp_ranks.serve`` case."""
    cls = PagedInferenceEngine if case["paged"] else InferenceEngine
    engine = cls(jcfg, jparams, mesh=mesh, **case.get("engine", {}))
    for prefix in case.get("prefixes", []):
        engine.register_prefix(prefix)
    for turn in case.get("turns", []):
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
            "prefix_tokens_reused": engine.prefix_tokens_reused}


TOKENS = np.random.default_rng(0).integers(0, 128, (2, 20))


def check_dense(tmp_path, geometry):
    """One two-rank session of the dense engine against the reference's
    mesh engine (tests/test_torch_tp_dense*.py): the rank-local forward's
    gathered logits on both ranks within LOGITS_ATOL of the reference's
    sharded forward, each rank's parameter bytes equal to the plan's, one
    forward's collectives, and the engine's greedy ids equal (where the
    heads shard: a registered shared prefix, requests that extend it and
    plain ones); at 4 on 2, the engine under collective_matmul "auto"
    gives the ids and prefill logits of "off" bit for bit."""
    jcfg, jparams, spec = model(geometry, tmp_path)
    mesh = ref_mesh()
    # The shared prefix where the heads shard (its splice reads the
    # rank's kv heads, repeated under the non-uniform map); the reference
    # compiles its prefix programs in ~7 s, so not at every geometry.
    prefix = geometry in ("4on2", "6on3")
    case = {"paged": False, "engine": {"max_slots": 2},
            "prefixes": [SHARED] if prefix else [],
            "prompts": ([SHARED + [40], PROMPTS[1], SHARED + [41, 3],
                         PROMPTS[3]] if prefix else PROMPTS),
            "max_tokens": 6}
    # collective_matmul "auto" resolves to the same all-reduces as "off"
    # (ROADMAP §1 item 1 step 1): its engine, one more case of the same
    # ranks at the 4-on-2 geometry, must give the same bits.
    cases = [case] + ([dict(case, config={"collective_matmul": "auto"})]
                      if geometry == "4on2" else [])
    want = ref_serve(jcfg, jparams, case, mesh)
    want_logits = ref_logits(jcfg, jparams, TOKENS, mesh)
    ranks = tp_ranks.run_ranks(tp_ranks.serve, 2, tmp_path, spec, cases,
                               TOKENS)
    got, fwd = ranks[0]["cases"], [r["forward"] for r in ranks]
    assert got[0]["collective_matmul"] == "all_reduce"
    for auto in got[1:]:
        assert auto["collective_matmul"] == "all_reduce"
        assert auto["ids"] == got[0]["ids"]
        assert len(auto["prefill_logits"]) == len(got[0]["prefill_logits"])
        for a, b in zip(auto["prefill_logits"], got[0]["prefill_logits"]):
            assert a.shape == b.shape and (a == b).all()
    for r in fwd:
        np.testing.assert_allclose(r["logits"], want_logits,
                                   atol=LOGITS_ATOL, rtol=0)
        assert r["local_bytes"] == r["plan_bytes"]
    assert got[0]["ids"] == want["ids"]
    assert got[0]["prefix_tokens_reused"] == want["prefix_tokens_reused"]
    assert (got[0]["prefix_tokens_reused"] > 0) == prefix
    plan = fwd[0]["plan"]
    sublayers = (1 if jcfg.parallel_block
                 else int(plan["heads"]) + int(plan["mlp"]))
    # One forward: the vocabulary-sharded embedding's reduce, one reduce
    # per sharded sublayer (one per parallel block), one logit gather.
    assert fwd[0]["counts"] == {
        "all_reduce": int(plan["vocab"]) + jcfg.num_layers * sublayers,
        "all_gather": int(plan["vocab"]), "broadcast": 0}
    return plan, fwd, got[0]


def check_speculative(tmp_path, geometry):
    """Speculative decoding on two ranks against the reference's mesh
    engine: the paged engine where the pool's kv heads shard, the dense
    one where they cannot; greedy ids equal and the verify ran."""
    jcfg, jparams, spec = model(geometry, tmp_path)
    paged = jcfg.num_kv_heads % 2 == 0
    engine = {"max_slots": 2, "speculative": "ngram", "draft_tokens": 4}
    if paged:
        engine["page_size"] = 16
    case = {"paged": paged, "engine": engine,
            "prompts": [REP_PROMPT, PROMPTS[1]], "max_tokens": 12}
    want = ref_serve(jcfg, jparams, case, ref_mesh())
    got = tp_ranks.run_ranks(tp_ranks.serve, 2, tmp_path, spec,
                             [case])[0]["cases"][0]
    assert got["ids"] == want["ids"]
    assert got["spec_drafted"] > 0 and want["spec_drafted"] > 0
    # Rank 0's verdicts drive the host; the decode chunks between verify
    # steps broadcast rank 0's sampled ids.
    assert got["counts"]["all_gather"] > 0
