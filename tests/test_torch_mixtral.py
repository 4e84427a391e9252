"""Mixtral serving in the port (the MoE FFN in ``forward``, both engines,
``convert_mixtral`` and the import) against the JAX package's.

The model is tests/test_moe.py's debug MoE size (4 experts, top 2) at the
default capacity factor 1.25, weights from the reference's
``init_params`` through models/bridge.py; both sides compute in f32 (JAX
matmuls at "highest", tests/conftest.py).

- ``forward(with_aux=True)``: logits within LOGIT_ATOL and the summed aux
  within AUX_ATOL of the reference's, without a cache and through a cache
  (a padded prefill bucket, then decode steps).
- The engines: capacity counts every row of a dispatch (padding rows,
  idle decode slots, suffix-only prefills), so a request's output depends
  on the batch it is served in; the mix below is one where the reference
  gives a request served alone other ids than the same request served in
  the batch. The port's dense engine, paged engine and a shared-prefix
  splice must each give the greedy ids of the reference's same engine,
  and so must speculative decoding (the verify dispatch).
  The adapter pool with attention targets serves it (base rows equal the
  pool-less engine's; mlp.* targets are refused).
- ``convert_mixtral`` bit-equal to the reference's (f32 and bf16, and
  under int8, which leaves the experts alone); HF ``MixtralForCausalLM``'s
  logits are in tests/test_torch_convert.py and the import of an HF
  directory in tests/test_torch_loader.py.
- Meshes: MoE trains under mesh_fsdp / mesh_data (an FSDP forward at
  world 1 gives one device's logits bit for bit; the ranks' routing is
  tests/test_torch_moe_fsdp.py's, their steps' parity with the
  reference's sharded step tests/test_torch_fsdp_train*.py's). Refused
  by name: MoE serving under mesh_fsdp / mesh_data, mesh_expert and
  mesh_tensor in training, and the fine-tune's example manifest
  (mesh_expert 8, mesh_tensor 2). Serving takes MoE under mesh_tensor
  and mesh_expert (the serving example's manifest passes the parse; the
  ranks' parity is tests/test_torch_ep_serve.py's), and a forward with
  ``tp=`` runs it. In one process the fine-tune trains through every
  entry point (its parity with the reference is
  tests/test_torch_moe_training.py's).
"""

import dataclasses
import json

import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from runbooks_tpu.models.config import get_config as jax_get_config
from runbooks_tpu.models.convert import convert as jax_convert
from runbooks_tpu.models.transformer import KVCache as JaxKVCache
from runbooks_tpu.models.transformer import forward as jax_forward
from runbooks_tpu.models.transformer import init_params as jax_init_params
from runbooks_tpu.serve.engine import InferenceEngine as JaxEngine
from runbooks_tpu.serve.engine import Request as JaxRequest
from runbooks_tpu.serve.paging import PagedInferenceEngine as JaxPaged

import chip_smoke
from runbooks_tpu_torch.models import bridge
from runbooks_tpu_torch.models.config import get_config
from runbooks_tpu_torch.models.convert import convert
from runbooks_tpu_torch.models.transformer import KVCache, forward
from runbooks_tpu_torch.ops.quantization import QuantizedArray
from runbooks_tpu_torch.parallel.mesh import (
    MeshConfig,
    check_mesh_model,
    check_serving_mesh,
    check_training_mesh,
)
from runbooks_tpu_torch.serve import api
from runbooks_tpu_torch.serve.engine import InferenceEngine, Request
from runbooks_tpu_torch.serve.paging import PagedInferenceEngine

torch.set_num_threads(2)

MOE = dict(vocab_size=64, hidden_size=32, intermediate_size=48,
           num_layers=2, num_heads=4, num_kv_heads=2, head_dim=8,
           max_seq_len=32, dtype="float32", moe_num_experts=4,
           moe_top_k=2, moe_capacity_factor=1.25)
LOGIT_ATOL = 1e-4
AUX_ATOL = 1e-5
PROMPTS = [[5, 9, 17], list(range(1, 11)), [7, 30, 2, 2, 9, 41, 5],
           [11, 12, 13]]
MAX_TOKENS = [8, 8, 10, 6]
SHARED = list(range(20, 36))          # two pages of 8


@pytest.fixture(scope="module")
def world():
    jcfg, tcfg = jax_get_config("debug", **MOE), get_config("debug", **MOE)
    np_params = jax.tree.map(np.asarray,
                             jax_init_params(jcfg, jax.random.key(0)))
    return (jcfg, tcfg, jax.tree.map(jnp.asarray, np_params),
            bridge.from_jax_numpy(tcfg, np_params))


def _t(a):
    return torch.from_numpy(np.asarray(a).copy())


# ---------------------------------------------------------------------------
# Forward
# ---------------------------------------------------------------------------

def test_forward_with_aux_matches_reference(world):
    jcfg, tcfg, jparams, tparams = world
    assert "moe" in tparams["layers"] and "mlp" not in tparams["layers"]
    tokens = np.random.default_rng(0).integers(0, 64, (4, 12)).astype(
        np.int32)
    want, _, want_aux = jax_forward(jcfg, jparams, jnp.asarray(tokens),
                                    with_aux=True)
    got, cache, aux = forward(tcfg, tparams, _t(tokens), with_aux=True)
    assert cache is None and aux.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(want),
                               atol=LOGIT_ATOL, rtol=0)
    np.testing.assert_allclose(float(aux), float(want_aux), atol=AUX_ATOL,
                               rtol=0)
    assert float(aux) >= tcfg.num_layers * 0.99   # E·Σ me·ce >= 1 a layer
    # Without with_aux: the same logits, two outputs.
    plain, _ = forward(tcfg, tparams, _t(tokens))
    assert torch.equal(plain, got)


def test_cached_forward_with_aux_matches_reference(world):
    """The engine's write mode: a padded prefill bucket (padding at the
    trash slot; its rows count in the capacity), then two decode steps
    over every row."""
    jcfg, tcfg, jparams, tparams = world
    max_len, bucket = tcfg.max_seq_len, 16
    rng = np.random.default_rng(5)
    tokens = rng.integers(0, 64, (3, bucket)).astype(np.int32)
    pos = np.full((3, bucket), max_len, np.int32)
    for row, n in enumerate((16, 9, 3)):
        pos[row, :n] = np.arange(n)
    jcache = JaxKVCache.create(jcfg, 3, max_len, trash_slot=True)
    tcache = KVCache.create(tcfg, 3, max_len, torch.device("cpu"),
                            trash_slot=True)
    want, jcache, want_aux = jax_forward(
        jcfg, jparams, jnp.asarray(tokens), positions=jnp.asarray(pos),
        cache=jcache, with_aux=True)
    got, tcache, aux = forward(tcfg, tparams, _t(tokens), positions=_t(pos),
                               cache=tcache, with_aux=True)
    np.testing.assert_allclose(got.numpy(), np.asarray(want),
                               atol=LOGIT_ATOL, rtol=0)
    np.testing.assert_allclose(float(aux), float(want_aux), atol=AUX_ATOL,
                               rtol=0)
    lengths = np.array([16, 9, 3], np.int32)
    for _ in range(2):
        step = rng.integers(0, 64, (3, 1)).astype(np.int32)
        dpos = lengths[:, None].copy()
        want, jcache, want_aux = jax_forward(
            jcfg, jparams, jnp.asarray(step), positions=jnp.asarray(dpos),
            cache=jcache, cache_view=24, with_aux=True)
        got, tcache, aux = forward(tcfg, tparams, _t(step),
                                   positions=_t(dpos), cache=tcache,
                                   cache_view=24, with_aux=True)
        np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                   atol=LOGIT_ATOL, rtol=0)
        np.testing.assert_allclose(float(aux), float(want_aux),
                                   atol=AUX_ATOL, rtol=0)
        lengths += 1


# ---------------------------------------------------------------------------
# Engines
# ---------------------------------------------------------------------------

def _drain(eng, cls, prompts=PROMPTS, max_tokens=MAX_TOKENS):
    reqs = [cls(prompt_tokens=list(p), max_tokens=m, temperature=0.0)
            for p, m in zip(prompts, max_tokens)]
    for r in reqs:
        eng.submit(r)
    while eng.has_work():
        eng.step()
    return [list(r.output_tokens) for r in reqs]


def test_dense_engine_matches_reference_on_a_coupled_mix(world):
    jcfg, tcfg, jparams, tparams = world
    kw = dict(max_slots=4, max_seq_len=32, decode_chunk=4)
    want = _drain(JaxEngine(jcfg, jparams, **kw), JaxRequest)
    assert _drain(InferenceEngine(tcfg, tparams, **kw), Request) == want
    # The mix is capacity-coupled: the reference serves the third request
    # alone to other ids.
    alone = _drain(JaxEngine(jcfg, jparams, **kw), JaxRequest,
                   PROMPTS[2:3], MAX_TOKENS[2:3])
    assert alone[0] != want[2]


def test_paged_engine_matches_reference(world):
    jcfg, tcfg, jparams, tparams = world
    kw = dict(max_slots=4, max_seq_len=32, page_size=8)
    want = _drain(JaxPaged(jcfg, jparams, **kw), JaxRequest)
    eng = PagedInferenceEngine(tcfg, tparams, **kw)
    assert _drain(eng, Request) == want


def test_prefix_splice_matches_reference(world):
    """A registered shared prefix: the prompts that extend it prefill
    only their suffix, a dispatch of other rows than a whole prefill."""
    jcfg, tcfg, jparams, tparams = world
    prompts = [SHARED + [3], PROMPTS[0], SHARED + [40, 41, 9]]
    max_tokens = [6, 6, 5]
    kw = dict(max_slots=4, max_seq_len=32, decode_chunk=4)
    jeng = JaxEngine(jcfg, jparams, **kw)
    jeng.register_prefix(SHARED, warmup=False)
    want = _drain(jeng, JaxRequest, prompts, max_tokens)
    eng = InferenceEngine(tcfg, tparams, **kw)
    eng.register_prefix(SHARED)
    assert _drain(eng, Request, prompts, max_tokens) == want
    assert eng.prefix_tokens_reused == jeng.prefix_tokens_reused > 0


def test_speculative_verify_matches_reference(world):
    """Prompt-lookup drafts of 4 tokens verified by one [B, K+1] forward:
    the verify dispatch's rows (drafts, padding) set the capacity, as the
    reference's; ids and the draft, accept and verify counters equal."""
    jcfg, tcfg, jparams, tparams = world
    prompts = [[9, 3, 9, 3, 9, 3, 1, 2, 9, 3] * 2, PROMPTS[1]]

    def run(cls, req_cls, cfg, params):
        eng = cls(cfg, params, max_slots=2, max_seq_len=32,
                  speculative="ngram", draft_tokens=4)
        return _drain(eng, req_cls, prompts, [8, 8]), eng

    want, jeng = run(JaxEngine, JaxRequest, jcfg, jparams)
    got, eng = run(InferenceEngine, Request, tcfg, tparams)
    assert got == want
    assert (eng.spec_drafted, eng.spec_accepted, eng.spec_verify_steps) \
        == (jeng.spec_drafted, jeng.spec_accepted, jeng.spec_verify_steps)
    assert eng.spec_verify_steps > 0


@pytest.mark.parametrize("paged", [False, True])
def test_adapter_pool_with_attention_targets_serves_moe(world, tmp_path,
                                                        paged):
    """The multi-tenant pool on an MoE model (attention targets, the
    default): base-only rows give the pool-less engine's ids bit for bit
    (the trash lane adds zero and the dispatch rows are the same), a
    tenant's row changes its own; targets on mlp.* are refused."""
    from runbooks_tpu_torch.ops.lora import target_dims
    from runbooks_tpu_torch.serve.lora_pool import AdapterPool, save_adapter

    _, tcfg, _, tparams = world
    g = torch.Generator().manual_seed(3)
    tree = {t: {"a": torch.randn((2, *target_dims(tcfg, t)[:1], 4),
                                 generator=g),
                "b": torch.randn((2, 4, target_dims(tcfg, t)[1]),
                                 generator=g)}
            for t in tcfg.lora_targets}
    save_adapter(str(tmp_path / "t0"), tree, rank=4, alpha=8.0)
    cls = PagedInferenceEngine if paged else InferenceEngine
    kw = dict(max_slots=4, max_seq_len=32)
    plain = _drain(cls(tcfg, tparams, **kw), Request)
    pooled = cls(tcfg, tparams, adapter_pool=2, lora_rank=4,
                 adapter_dir=str(tmp_path), **kw)
    reqs = [Request(prompt_tokens=list(p), max_tokens=m, temperature=0.0,
                    adapter="t0" if i == 1 else None)
            for i, (p, m) in enumerate(zip(PROMPTS, MAX_TOKENS))]
    pooled.generate(reqs)
    ids = [r.output_tokens for r in reqs]
    assert ids[1] != plain[1]
    assert pooled.adapter_stats()["loads"] == 1
    # Rows 0, 2 and 3 share their dispatches with the tenant's row, whose
    # new activations route differently: compare a base-only batch.
    base = cls(tcfg, tparams, adapter_pool=2, lora_rank=4,
               adapter_dir=str(tmp_path), **kw)
    assert _drain(base, Request) == plain
    with pytest.raises(ValueError, match="mlp targets on an MoE"):
        AdapterPool(dataclasses.replace(tcfg, lora_targets=(
            "attn.wq", "mlp.wi_gate")), pool_size=2, rank=4)


# ---------------------------------------------------------------------------
# Convert and import
# ---------------------------------------------------------------------------

def _hf_state_dict(cfg, seed):
    rng = np.random.default_rng(seed)
    sd = {}
    for name, shape in chip_smoke.hf_mixtral_names(cfg).items():
        scale = 1.0 if name.endswith("norm.weight") else shape[-1] ** -0.5
        sd[name] = (rng.standard_normal(shape) * scale).astype(np.float32)
    return sd


def _flat(tree, prefix=""):
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_flat(v, f"{prefix}{k}."))
        return out
    return {prefix[:-1]: tree}


@pytest.mark.parametrize("src_dtype", ["float32", "bfloat16"])
def test_convert_mixtral_equals_reference(src_dtype):
    tcfg, jcfg = get_config("debug", **MOE), jax_get_config("debug", **MOE)
    sd = _hf_state_dict(tcfg, 7)
    if src_dtype == "bfloat16":
        np_sd = {k: v.astype(ml_dtypes.bfloat16) for k, v in sd.items()}
        t_sd = {k: torch.from_numpy(v).bfloat16() for k, v in sd.items()}
    else:
        np_sd, t_sd = sd, {k: torch.from_numpy(v) for k, v in sd.items()}
    for dtype in ("float32", "bfloat16"):
        want = _flat(bridge.tree_from_numpy(jax_convert(jcfg, np_sd,
                                                        dtype=dtype)))
        got = _flat(convert(tcfg, t_sd, dtype))
        assert got.keys() == want.keys()
        for k, w in want.items():
            assert got[k].dtype == w.dtype and torch.equal(got[k], w), k
    # The layout the model takes.
    bridge.from_jax_numpy(tcfg, bridge.to_numpy(convert(tcfg, t_sd)))
    assert got["layers.moe.wi_gate"].shape == (2, 4, 32, 48)


def test_convert_mixtral_int8_leaves_the_experts_like_reference():
    tcfg, jcfg = get_config("debug", **MOE), jax_get_config("debug", **MOE)
    sd = _hf_state_dict(tcfg, 8)
    want = _flat(jax_convert(jcfg, sd, dtype="float32", quantize="int8"))
    got = _flat(convert(tcfg, {k: torch.from_numpy(v) for k, v in
                               sd.items()}, "float32", "int8"))
    assert got.keys() == want.keys()
    for k, w in want.items():
        if hasattr(w, "bits"):
            assert isinstance(got[k], QuantizedArray), k
            assert torch.equal(got[k].values, _t(w.values)), k
            assert torch.equal(got[k].scales, _t(w.scales)), k
        else:
            assert torch.equal(got[k], _t(w)), k
    assert all(isinstance(got[f"layers.attn.{n}"], QuantizedArray)
               for n in ("wq", "wk", "wv", "wo"))
    assert not any(isinstance(got[f"layers.moe.{n}"], QuantizedArray)
                   for n in ("router", "wi_gate", "wi_up", "wo"))


def test_load_model_serves_a_debug_moe_on_the_cpu():
    cfg, params = api.load_model({"model": "debug", "model_overrides": MOE,
                                  "seed": 1}, device="cpu")
    assert cfg.moe_num_experts == 4
    assert params["layers"]["moe"]["wi_gate"].shape == (2, 4, 32, 48)
    out = InferenceEngine(cfg, params, max_slots=2, max_seq_len=32).generate(
        [Request(prompt_tokens=[1, 2, 3], max_tokens=4)])
    assert len(out[0].output_tokens) == 4


# ---------------------------------------------------------------------------
# Refusals
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("axis", ["fsdp", "data"])
def test_moe_under_a_mesh_is_refused_by_name(axis):
    """MoE trains under mesh_fsdp and mesh_data (routed over the global
    microbatch) and is refused by name in serving there; in training
    the tensor and expert axes are refused."""
    cfg = get_config("mixtral-8x7b")
    mc = MeshConfig(**{"fsdp": 1, axis: 2})
    check_mesh_model(cfg, mc)
    check_mesh_model(cfg, check_training_mesh(mc))
    with pytest.raises(NotImplementedError,
                       match=rf"MoE: moe_num_experts=8\) under "
                             rf"mesh_{axis}=2 in serving"):
        check_mesh_model(cfg, mc, serving=True)
    for other in ("tensor", "expert"):
        with pytest.raises(NotImplementedError,
                           match=rf"mesh_{other}=2 in training"):
            check_mesh_model(cfg, MeshConfig(**{"fsdp": 1, other: 2}))
    check_mesh_model(cfg, MeshConfig(fsdp=1))


def test_moe_serves_under_mesh_tensor():
    """mesh_tensor passes every serving check for an MoE model (the
    reference shards its experts' MLP width over tensor), and a shard
    loads with the experts' MLP columns cut; training still refuses the
    tensor axis."""
    cfg = get_config("mixtral-8x7b")
    check_mesh_model(cfg, MeshConfig(fsdp=1, tensor=2), serving=True)
    api.refuse_unported({"model": "mixtral-8x7b", "mesh_tensor": 2})
    tcfg, shard = api.load_model({"model": "debug", "model_overrides": MOE},
                                 device="cpu", shard=(2, 1))
    assert shard["layers"]["moe"]["wi_up"].shape == (2, 4, 32, 24)
    assert shard["layers"]["attn"]["wq"].shape == (2, 32, 16)
    with pytest.raises(NotImplementedError, match="mesh_tensor=2"):
        check_training_mesh(MeshConfig(fsdp=1, tensor=2))


def test_mesh_expert_and_the_examples_manifest_are_refused():
    """In training: mesh_expert is refused by name (the fine-tune's
    manifest is in test_fine_tune_trains_and_the_examples_manifest_is_
    refused)."""
    with pytest.raises(NotImplementedError, match="mesh_expert=8"):
        check_training_mesh(MeshConfig(expert=8, fsdp=1))
    with pytest.raises(NotImplementedError, match="mesh_expert=2"):
        check_training_mesh(MeshConfig(expert=2, fsdp=1, tensor=2))


def test_mesh_expert_and_the_serving_examples_manifest_serve():
    check_serving_mesh(MeshConfig(expert=2, fsdp=1, tensor=2))
    check_mesh_model(get_config("mixtral-8x7b"),
                     MeshConfig(expert=2, fsdp=1, tensor=2), serving=True)
    # examples/mixtral-8x7b/server.yaml's params.
    api.refuse_unported({"model": "mixtral-8x7b", "mesh_expert": 2,
                         "mesh_tensor": 2})
    assert api.serve_mesh({"model": "mixtral-8x7b", "mesh_expert": 2,
                           "mesh_tensor": 2}) == MeshConfig(
        expert=2, fsdp=1, tensor=2)


def test_sharded_forwards_refuse_moe(world, tmp_path):
    """An FSDP forward of the MoE (one rank of a world-1 gloo group:
    no routing group, the layers gathered from the rank's pieces) gives
    one device's logits and aux bit for bit; a forward with both ``fsdp``
    and ``tp`` is still refused."""
    import torch.distributed as dist

    from runbooks_tpu_torch.parallel.mesh import make_mesh
    from runbooks_tpu_torch.parallel.sharding import Fsdp
    from runbooks_tpu_torch.train.step import fsdp_plan

    _, tcfg, _, tparams = world
    tokens = torch.as_tensor(np.random.default_rng(3).integers(0, 64,
                                                               (2, 9)))
    want, _, want_aux = forward(tcfg, tparams, tokens, with_aux=True)
    dist.init_process_group("gloo", rank=0, world_size=1,
                            store=dist.FileStore(str(tmp_path / "s"), 1))
    try:
        mesh = make_mesh(MeshConfig(fsdp=1))
        fsdp = Fsdp(fsdp_plan(tcfg, mesh), 0, mesh, torch.device("cpu"),
                    compute_dtype=tcfg.activation_dtype)
        assert fsdp.routing(2) is None
        got, _, aux = forward(tcfg, fsdp.outer(tparams), tokens,
                              with_aux=True, fsdp=fsdp)
        with pytest.raises(NotImplementedError, match="FSDP forward trains"):
            forward(tcfg, tparams, tokens, fsdp=fsdp, tp=object())
    finally:
        dist.destroy_process_group()
    assert torch.equal(got, want) and torch.equal(aux, want_aux)
    assert fsdp.counts["routing_all_gather"] == 0


def test_tensor_parallel_forward_runs_moe_at_world_one(world, tmp_path):
    """A forward with ``tp=`` (one rank of a world-1 gloo group, the
    experts combined over its serving group) gives one device's logits
    bit for bit: the combine's all-reduce returns its input."""
    import torch.distributed as dist

    from runbooks_tpu_torch.parallel.sharding import (
        TensorParallel,
        serve_plan,
    )

    _, tcfg, _, tparams = world
    tokens = torch.as_tensor(np.random.default_rng(2).integers(0, 64,
                                                               (2, 9)))
    want, _ = forward(tcfg, tparams, tokens)
    dist.init_process_group("gloo", rank=0, world_size=1,
                            store=dist.FileStore(str(tmp_path / "s"), 1))
    try:
        tp = TensorParallel(serve_plan(tcfg, 1, 1), 0, dist.group.WORLD,
                            dist.group.WORLD)
        got, _ = forward(tcfg, tparams, tokens, tp=tp)
    finally:
        dist.destroy_process_group()
    assert torch.equal(got, want)
    assert tp.group_counts["serve"]["all_reduce"] == tcfg.num_layers


def test_fine_tune_trains_and_the_examples_manifest_is_refused(
        tmp_path, monkeypatch):
    """make_train_step, make_lora_train_step, run_training and main each
    take a step of the debug MoE in one process; main refuses
    examples/mixtral-8x7b/finetuned-model.yaml's params by naming
    mesh_expert."""
    from runbooks_tpu_torch.train import trainer
    from runbooks_tpu_torch.train.lora import (
        LoraConfig,
        create_lora_train_state,
        make_lora_train_step,
    )
    from runbooks_tpu_torch.train.optimizer import AdamW, OptimizerConfig
    from runbooks_tpu_torch.train.step import (
        create_train_state,
        make_train_step,
    )

    moe = {**MOE, "vocab_size": 512}     # the trainer's byte tokenizer
    cfg = get_config("debug", **moe)
    params = api.load_model({"model": "debug", "model_overrides": moe,
                             "seed": 1}, device="cpu")[1]
    rng = np.random.default_rng(0)
    tokens = torch.from_numpy(rng.integers(1, 512, (2, 17)))
    batch = {"tokens": tokens[:, :-1], "targets": tokens[:, 1:]}
    opt = AdamW(OptimizerConfig())
    state, m = make_train_step(cfg, opt, accumulate_steps=2)(
        create_train_state(params, opt), batch)
    assert state.step == 1 and m["nonfinite"] == 0
    lcfg = LoraConfig(rank=4)
    state, m = make_lora_train_step(cfg, lcfg, opt)(
        create_lora_train_state(lcfg, params, opt,
                                torch.Generator().manual_seed(0)),
        params, batch)
    assert state.step == 1 and m["nonfinite"] == 0
    docs = tmp_path / "docs.jsonl"
    docs.write_text("".join(json.dumps({"text": "moe " * n}) + "\n"
                            for n in range(5, 60)))
    summary = trainer.run_training(trainer.TrainJobConfig(
        model="debug", model_overrides=moe, seq_len=16, batch_size=2,
        steps=1, data_path=str(docs),
        artifacts_dir=str(tmp_path / "run")), device="cpu")
    assert [e["step"] for e in summary["history"]] == [1]
    content = tmp_path / "content"
    (content / "data").mkdir(parents=True)
    (content / "data" / "docs.jsonl").write_text(docs.read_text())
    (content / "params.json").write_text(json.dumps({
        "model": "debug", "model_overrides": moe, "seq_len": 16,
        "batch_size": 2, "steps": 1, "maintenance_poll_s": 0}))
    monkeypatch.setenv("RBT_CONTENT_DIR", str(content))
    monkeypatch.setenv("GCE_METADATA_HOST", "127.0.0.1:9")
    monkeypatch.setattr(trainer, "resolve_device",
                        lambda device=None: torch.device("cpu"))
    assert trainer.main() == 0
    # examples/mixtral-8x7b/finetuned-model.yaml's params.
    (content / "params.json").write_text(json.dumps({
        "model": "mixtral-8x7b", "lora": {"rank": 16, "alpha": 32.0},
        "steps": 500, "batch_size": 8, "seq_len": 4096,
        "learning_rate": 1.0e-5, "mesh_expert": 8, "mesh_tensor": 2,
        "maintenance_poll_s": 0}))
    with pytest.raises(NotImplementedError, match="mesh_expert=8"):
        trainer.main(backend="gloo")
