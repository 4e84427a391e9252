"""The port's quantized serving tier against the JAX package's: weight-only
int8/int4 params and the int8 KV cache through the dense and paged
engines, the host tier, the adapter pool and the prefix cache.

A tiny llama config at float32 with the reference's weights (bridged),
quantized by the reference (``quantize_params``, block 32) and carried
over with their codes and scales, so both sides serve the same numbers.
Matmuls are f32 at "highest" precision (tests/conftest.py), so greedy ids
must be IDENTICAL to the JAX engines' (int8 weights + int8 KV, int4
weights, int8 KV alone; dense and paged). Also: the host tier's int8
round trip bit for bit, base-only rows of a pooled engine over an int8
base bit-identical to the no-pool int8 engine (first-token logits
included) with tenant rows equal to the JAX pooled engine's, the prefix
taken from an int8 slot dequantized to the activation dtype.
tests/test_torch_quantized_loading.py holds the loading paths. As in
tests/test_torch_paging.py, the reference's radix nodes get the port's
LRU tie-break (creation order, not memory address) in every test.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from runbooks_tpu.models.config import get_config as jax_get_config
from runbooks_tpu.models.transformer import init_params as jax_init_params
from runbooks_tpu.ops import quantization as jq
from runbooks_tpu.serve import lora_pool as jax_lora_pool
from runbooks_tpu.serve import paging as jax_paging
from runbooks_tpu.serve.engine import InferenceEngine as JaxEngine
from runbooks_tpu.serve.engine import Request as JaxRequest

from runbooks_tpu_torch.models import bridge
from runbooks_tpu_torch.models.config import get_config
from runbooks_tpu_torch.ops import quantization as tq
from runbooks_tpu_torch.ops.lora import target_dims
from runbooks_tpu_torch.serve import lora_pool, paging
from runbooks_tpu_torch.serve.engine import InferenceEngine, Request
from runbooks_tpu_torch.serve.paging import PagedInferenceEngine
from runbooks_tpu_torch.utils.tree import tree_map
from tests import tp_oracle

torch.set_num_threads(2)

TINY = dict(vocab_size=128, hidden_size=64, intermediate_size=128,
            num_layers=2, num_heads=4, num_kv_heads=2, head_dim=16,
            max_seq_len=64, dtype="float32")
BLOCK = 32
# Prompts across the 16, 32 and 64 prefill buckets.
PROMPTS = [[5, 9, 17], list(range(1, 21)), [3, 4, 5, 6, 7, 8, 9, 10],
           list(range(30, 70))]


@pytest.fixture(autouse=True)
def _stable_ties():
    with tp_oracle.stable_ties():
        yield


@pytest.fixture(scope="module")
def world():
    jcfg = dataclasses.replace(jax_get_config("llama2-7b"), **TINY)
    tcfg = dataclasses.replace(get_config("llama2-7b"), **TINY)
    jparams = jax_init_params(jcfg, jax.random.key(0))
    out = {"none": (jcfg, jparams, tcfg, bridge.from_jax_numpy(
        tcfg, jax.tree.map(np.asarray, jparams)))}
    for mode in ("int8", "int4"):
        jp = jq.quantize_params(jax.tree.map(lambda x: x, jparams), mode,
                                block_size=BLOCK)
        out[mode] = (dataclasses.replace(jcfg, quantize=mode), jp,
                     dataclasses.replace(tcfg, quantize=mode),
                     bridge.from_jax_numpy(tcfg, jax.tree.map(np.asarray,
                                                              jp)))
    return out


def _reqs(cls, prompts=PROMPTS, max_tokens=8, **kw):
    return [cls(prompt_tokens=list(p), max_tokens=max_tokens,
                temperature=0.0, **kw) for p in prompts]


def _drain(eng, reqs):
    for r in reqs:
        eng.submit(r)
    while eng.has_work():
        eng.step()
    return [list(r.output_tokens) for r in reqs]


# ---------------------------------------------------------------------------
# Dense and paged engines against the JAX engines
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("mode,quantize_kv", [
    ("int8", None), ("int4", None), ("none", True)],
    ids=["int8_weights_int8_kv", "int4_weights_int8_kv", "int8_kv_only"])
def test_dense_greedy_matches_jax_engine(world, mode, quantize_kv):
    jcfg, jparams, tcfg, tparams = world[mode]
    jeng = JaxEngine(jcfg, jparams, max_slots=4, max_seq_len=64,
                     quantize_kv=quantize_kv)
    eng = InferenceEngine(tcfg, tparams, max_slots=4, max_seq_len=64,
                          quantize_kv=quantize_kv)
    assert eng.cache.quantized and jeng.cache.quantized
    want = _drain(jeng, _reqs(JaxRequest))
    assert _drain(eng, _reqs(Request)) == want
    occ = eng.kv_occupancy()
    assert occ["kv_pool_bytes"] == eng.cache.nbytes == sum(
        int(np.asarray(a).nbytes) for a in (
            jeng.cache.k, jeng.cache.v, jeng.cache.k_scale,
            jeng.cache.v_scale))


def test_paged_int8_matches_jax_paged(world):
    """int8 pages under int8 weights: the JAX paged engine's ids and page
    accounting, and the port's dense engine's ids; the second round
    reuses the first's pages (gathered and dequantized into the prefill's
    scratch rows)."""
    jcfg, jparams, tcfg, tparams = world["int8"]
    outs = []
    for eng, cls in ((PagedInferenceEngine(tcfg, tparams, max_slots=4,
                                           page_size=8), Request),
                     (jax_paging.PagedInferenceEngine(
                         jcfg, jparams, max_slots=4, page_size=8),
                      JaxRequest)):
        assert eng.cache.quantized
        first = _drain(eng, _reqs(cls))
        again = _drain(eng, _reqs(cls, [p + [7] for p in PROMPTS]))
        outs.append((first, again, eng.pager.occupancy(),
                     eng.prefix_tokens_reused))
    assert outs[0] == outs[1]
    assert outs[0][3] > 0
    dense = InferenceEngine(tcfg, tparams, max_slots=4)
    assert _drain(dense, _reqs(Request)) == outs[0][0]


def test_host_tier_int8_round_trip(world):
    """An int8 page and its scales through the host tier come back bit for
    bit; a quantized tier refuses a page without scales; an engine that
    swaps int8 pages out and in gives the ids of one that recomputes
    them, and the JAX engine's."""
    _, _, tcfg, tparams = world["int8"]
    eng = PagedInferenceEngine(tcfg, tparams, max_slots=2, page_size=16,
                               num_pages=5, kv_host_pages=4)
    _drain(eng, _reqs(Request, [list(range(1, 40))], 4))
    pool, host = eng.cache, eng.host_pool
    assert host.quantized and host.k.dtype == torch.int8
    assert host.bytes_per_page == sum(
        t[0].numel() * t.element_size()
        for t in (host.k, host.v, host.k_scale, host.v_scale))
    h = host.alloc()
    out_fn = paging.make_kv_swap_out_fn()
    in_fn = paging.make_kv_swap_in_fn()
    host.store(h, *out_fn(pool, 0))
    in_fn(pool, 3, *host.load(h))
    for a, b in zip(pool.page(0), pool.page(3)):
        assert torch.equal(a, b)
    assert pool.k_scale[:, 0].abs().sum() > 0
    with pytest.raises(ValueError, match="scales"):
        host.store(h, pool.k[:, 0], pool.v[:, 0])
    host.free(h)

    jcfg, jparams, _, _ = world["int8"]
    shared = list(range(1, 33))
    outs = []
    for make, cls in (
            (lambda kw: PagedInferenceEngine(tcfg, tparams, **kw), Request),
            (lambda kw: jax_paging.PagedInferenceEngine(jcfg, jparams,
                                                        **kw), JaxRequest)):
        for host_pages in (4, 0):
            e = make(dict(max_slots=2, page_size=16, num_pages=5,
                          kv_host_pages=host_pages))
            e.register_prefix(shared)
            big = _drain(e, _reqs(cls, [list(range(90, 122))], 32))
            back = _drain(e, _reqs(cls, [shared + [50]], 5))
            occ = e.pager.occupancy()
            outs.append((big, back, occ.get("swap_in_pages_total", 0)))
    port_host, port_none, jax_host, jax_none = outs
    assert port_host == jax_host and port_none == jax_none
    assert port_host[:2] == port_none[:2]
    assert port_host[2] >= 1


def test_prefix_from_slot_dequantizes(world):
    """A finished request's int8 slot rows become a prefix in the
    activation dtype (the dequantized rows); the next turn reuses it and
    gives the JAX engine's ids."""
    jcfg, jparams, tcfg, tparams = world["int8"]
    prompt = list(range(1, 41))
    turn2 = prompt + [7, 8, 9]
    outs = []
    for eng, cls in ((InferenceEngine(tcfg, tparams, max_slots=2), Request),
                     (JaxEngine(jcfg, jparams, max_slots=2), JaxRequest)):
        first = _drain(eng, _reqs(cls, [prompt], 4))
        plen = eng.register_prefix_from_slot(0, prompt)
        if cls is Request:
            (pk, pv), = eng._prefix_cache.values()
            c = eng.cache
            assert pk.dtype == tcfg.activation_dtype
            assert torch.equal(pk, tq.dequantize_kv(
                c.k[:, 0, :plen], c.k_scale[:, 0, :plen],
                tcfg.activation_dtype))
            assert torch.equal(pv, tq.dequantize_kv(
                c.v[:, 0, :plen], c.v_scale[:, 0, :plen],
                tcfg.activation_dtype))
        second = _drain(eng, _reqs(cls, [turn2], 6))
        outs.append((plen, first, second, eng.prefix_hits,
                     eng.prefix_tokens_reused))
    assert outs[0] == outs[1]
    assert outs[0][0] == 32 and outs[0][3] == 1


# ---------------------------------------------------------------------------
# The adapter pool over an int8 base
# ---------------------------------------------------------------------------

def _adapter(cfg, seed, rank=4):
    rng = np.random.default_rng(seed)
    out = {}
    for t in cfg.lora_targets:
        d_in, d_out = target_dims(cfg, t)
        out[t] = {"a": (rng.standard_normal((cfg.num_layers, d_in, rank))
                        * d_in ** -0.5).astype(np.float32),
                  "b": (0.05 * rng.standard_normal(
                      (cfg.num_layers, rank, d_out))).astype(np.float32)}
    return out


def test_pooled_int8_base(world, tmp_path):
    """Base-only rows of a pooled engine over an int8 base: the no-pool
    int8 engine's ids and bit-identical first-token logits; tenant rows:
    the JAX pooled int8 engine's ids, different from the base's."""
    jcfg, jparams, tcfg, tparams = world["int8"]
    jpaths, tpaths = [], []
    for i in range(2):
        tree = _adapter(tcfg, 20 + i)
        jp, tp = str(tmp_path / "jax" / f"t{i}"), str(tmp_path / f"t{i}")
        jax_lora_pool.save_adapter(jp, jax.tree.map(jnp.asarray, tree),
                                   rank=4, alpha=8.0)
        lora_pool.save_adapter(tp, tree_map(torch.from_numpy, tree),
                               rank=4, alpha=8.0)
        jpaths.append(jp)
        tpaths.append(tp)
    mix = [0, None, 1, None]
    pooled = InferenceEngine(tcfg, tparams, max_slots=4, adapter_pool=2,
                             lora_rank=4)
    plain = InferenceEngine(tcfg, tparams, max_slots=4)
    jpooled = JaxEngine(jcfg, jparams, max_slots=4, adapter_pool=2,
                        lora_rank=4)
    assert pooled.cache.quantized and plain.cache.quantized
    logits = {}
    for name, eng in (("pooled", pooled), ("plain", plain)):
        fn = eng._prefill

        def recording(*a, _fn=fn, _name=name, **kw):
            first, pool, last = _fn(*a, **kw)
            logits.setdefault(_name, []).append(last.clone())
            return first, pool, last

        eng._prefill = recording
    prompts = [p[:16] for p in PROMPTS]
    got = _drain(pooled, [Request(prompt_tokens=list(p), max_tokens=8,
                                  temperature=0.0,
                                  adapter=None if t is None else tpaths[t])
                          for p, t in zip(prompts, mix)])
    base = _drain(plain, _reqs(Request, prompts))
    want = _drain(jpooled, [JaxRequest(
        prompt_tokens=list(p), max_tokens=8, temperature=0.0,
        adapter=None if t is None else jpaths[t])
        for p, t in zip(prompts, mix)])
    assert got == want
    for i, t in enumerate(mix):
        if t is None:
            assert got[i] == base[i]
            assert torch.equal(logits["pooled"][0][i], logits["plain"][0][i])
        else:
            assert got[i] != base[i]
