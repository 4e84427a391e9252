"""The port's paged KV engine (runbooks_tpu_torch/serve/paging.py) against
the JAX package's.

- Host structures: ``PageAllocator``, ``RadixTree``, ``HostPagePool`` and
  ``PagedKVManager`` driven by the same seeded operation sequence in both
  packages give equal results op for op: free lists, refcounts, matches,
  eviction victims, host-slot handouts, rolled-back admissions (exact:
  host code on ints).
- The bucket helpers are equal on a grid of sizes.
- The engine, on a tiny llama config at float32 with the reference's
  weights (models/bridge.py, matmul precision "highest"): greedy ids
  identical to the JAX ``PagedInferenceEngine``'s and to the port's dense
  engine's, with equal page accounting, for a plain mix, a shared prefix,
  copy-on-write divergence, page-pressure serialization and eviction then
  recompute.

The reference breaks LRU ties (nodes of one tick) by ``id(node)``, a
memory address, so its eviction victims vary from run to run; the port
breaks them by creation order (``paging._lru_key``). The ``_stable_ties``
fixture (tests/tp_oracle.stable_ties) gives the reference's nodes the
same order for these tests, without touching the reference's files.
"""

import dataclasses

import jax
import numpy as np
import pytest
import torch

from runbooks_tpu.models.config import get_config as jax_get_config
from runbooks_tpu.models.transformer import init_params as jax_init_params
from runbooks_tpu.serve import paging as jax_paging
from runbooks_tpu.serve.engine import Request as JaxRequest

from runbooks_tpu_torch.models import bridge
from runbooks_tpu_torch.models.config import get_config
from runbooks_tpu_torch.serve import paging
from runbooks_tpu_torch.serve.engine import (
    EngineOverloaded,
    InferenceEngine,
    Request,
)
from runbooks_tpu_torch.serve.paging import PagedInferenceEngine
from tests import tp_oracle

torch.set_num_threads(2)

TINY = dict(vocab_size=128, hidden_size=64, intermediate_size=128,
            num_layers=2, num_heads=4, num_kv_heads=2, head_dim=16,
            max_seq_len=64, dtype="float32")


@pytest.fixture(autouse=True)
def _stable_ties():
    with tp_oracle.stable_ties():
        yield


@pytest.fixture(scope="module")
def weights():
    jcfg = dataclasses.replace(jax_get_config("llama2-7b"), **TINY)
    tcfg = dataclasses.replace(get_config("llama2-7b"), **TINY)
    jparams = jax_init_params(jcfg, jax.random.key(0))
    tparams = bridge.from_jax_numpy(tcfg, jax.tree.map(np.asarray, jparams))
    return jcfg, jparams, tcfg, tparams


# ---------------------------------------------------------------------------
# Host structures, op for op
# ---------------------------------------------------------------------------

def _allocator_trace(mod, seed):
    rng = np.random.default_rng(seed)
    a = mod.PageAllocator(10)
    held, out = [], []
    for _ in range(300):
        op = rng.integers(0, 4)
        try:
            if op == 0:
                got = a.alloc(int(rng.integers(0, 5)))
                held.extend(got or [])
                out.append(("alloc", got))
            elif op == 1 and held:
                p = held[int(rng.integers(0, len(held)))]
                a.incref([p])
                held.append(p)
                out.append(("incref", p))
            elif op == 2 and held:
                p = held.pop(int(rng.integers(0, len(held))))
                out.append(("decref", a.decref([p])))
            else:
                # Misuse: a page nobody holds.
                p = int(rng.integers(0, 10))
                if p not in held:
                    a.decref([p])
                out.append(("probe", p))
        except RuntimeError as exc:
            out.append(("error", str(exc)))
        out.append((list(a._free), [a.refcount(p) for p in range(10)],
                    a.free_count, a.used_count))
    return out


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_allocator_matches_reference_op_for_op(seed):
    assert _allocator_trace(paging, seed) == \
        _allocator_trace(jax_paging, seed)
    for mod in (paging, jax_paging):
        with pytest.raises(ValueError, match="num_pages"):
            mod.PageAllocator(0)


def _manager_trace(mod, cfg, seed, host_pages):
    """A PagedKVManager with a host tier driven by seeded admissions,
    releases (adopting written tokens), evictions and host evictions; the
    swap callbacks fail on a fixed schedule. Returns every observable."""
    rng = np.random.default_rng(seed)
    ps, slots, per_slot = 2, 3, 6
    mgr = mod.PagedKVManager(14, ps, slots, per_slot)
    host = mod.HostPagePool(cfg, host_pages, ps)
    mgr.radix.host = host
    calls = {"n": 0}

    def fault():
        calls["n"] += 1
        return calls["n"] % 7 == 0

    def swap_out(page):
        if fault():
            return None
        h = host.alloc()
        if h is None:
            mgr.radix.evict_host(1)
            h = host.alloc()
        return h

    mgr.radix.swap_out = swap_out
    mgr.swap_in = lambda slot, page: not fault()
    histories = {}
    out = []
    for _ in range(250):
        op = int(rng.integers(0, 5))
        slot = int(rng.integers(0, slots))
        if op <= 1 and not mgr.slot_pages[slot]:
            n = int(rng.integers(1, 10))
            toks = [int(t) for t in rng.integers(0, 3, n)]
            shared, priv_n = mgr.plan(toks, int(rng.integers(1, 4)),
                                      per_slot * ps)
            out.append(("plan", [(nd.page, nd.host_slot) for nd in shared],
                        priv_n))
            priv = mgr.admit(slot, shared, priv_n)
            out.append(("admit", priv, mgr.page_table.tolist()))
            if priv is not None:
                histories[slot] = toks
        elif op <= 2 and mgr.slot_pages[slot]:
            toks = histories.pop(slot)
            extra = [int(t) for t in rng.integers(0, 3, rng.integers(0, 4))]
            mgr.release(slot, written_tokens=toks + extra)
            out.append(("release", slot))
        elif op == 3:
            out.append(("evict", mgr.radix.evict(int(rng.integers(1, 4)))))
        else:
            out.append(("evict_host",
                        mgr.radix.evict_host(int(rng.integers(0, 3)))))
        out.append((mgr.occupancy(), list(mgr.allocator._free),
                    [mgr.allocator.refcount(p) for p in range(14)],
                    list(host._free), host.used_count,
                    mgr.slot_shared.tolist()))
    return out


@pytest.mark.parametrize("seed", [0, 1, 2, 3])
def test_radix_manager_and_host_tier_match_reference_op_for_op(weights,
                                                               seed):
    jcfg, _, tcfg, _ = weights
    got = _manager_trace(paging, tcfg, seed, host_pages=3)
    want = _manager_trace(jax_paging, jcfg, seed, host_pages=3)
    assert got == want
    kinds = {o[0] for o in got if isinstance(o[0], str)}
    assert kinds == {"plan", "admit", "release", "evict", "evict_host"}
    occ = got[-1][0]
    # The schedule reaches every path: reuse, swaps both ways, drops.
    assert occ["pages_reused_total"] > 0
    assert occ["swap_out_pages_total"] > 0
    assert occ["swap_in_pages_total"] > 0
    assert occ["swap_dropped_pages_total"] > 0


def test_radix_match_insert_and_evict_like_reference():
    """The reference's own radix examples (tests/test_paging.py), run on
    both packages: partial pages never enter, LRU victims, pinning."""
    outs = []
    for mod in (paging, jax_paging):
        a = mod.PageAllocator(8)
        t = mod.RadixTree(4, a)
        toks = list(range(10))
        pages = a.alloc(3)
        out = [t.insert(toks, pages), t.nodes, t.match(toks),
               t.match(toks[:7]), t.match(toks[:3])]
        toks2 = toks[:4] + [99, 98, 97, 96]
        pages2 = a.alloc(2)
        out += [t.insert(toks2, pages2), t.match(toks2),
                a.refcount(pages2[0]), a.refcount(pages[0])]
        a.decref(pages)
        a.decref(pages2)
        t.match(toks2)
        out += [t.evict(1), t.match(toks), a.free_count]
        a.incref([pages[0]])
        out += [t.evict(10), a.refcount(pages[0]), t.match(toks2),
                t.pages_evicted, list(a._free)]
        outs.append(out)
    assert outs[0] == outs[1]
    assert outs[0][:5] == [2, 2, [0, 1], [0], []]


def test_host_pool_round_trip_and_handouts(weights):
    jcfg, _, tcfg, _ = weights
    page = (tcfg.num_layers, 16, tcfg.num_kv_heads, tcfg.head_dim)
    k = np.random.default_rng(0).standard_normal(page).astype(np.float32)
    v = np.random.default_rng(1).standard_normal(page).astype(np.float32)
    traces = []
    for mod, cfg, conv in ((paging, tcfg, torch.from_numpy),
                           (jax_paging, jcfg, lambda a: a)):
        pool = mod.HostPagePool(cfg, host_pages=3, page_size=16)
        out = [pool.free_count, pool.used_count, pool.nbytes,
               pool.bytes_per_page]
        a, b = pool.alloc(), pool.alloc()
        pool.store(b, conv(k), conv(v))
        lk, lv = pool.load(b)
        assert np.array_equal(np.asarray(lk), k)
        assert np.array_equal(np.asarray(lv), v)
        pool.free(a)
        out += [a, b, pool.alloc(), pool.alloc(), pool.alloc(),
                pool.free_count]
        for call in (lambda: pool.free(a), lambda: pool.load(a),
                     lambda: pool.store(a, conv(k), conv(v))):
            pool.free(a)
            with pytest.raises(RuntimeError) as err:
                call()
            out.append(str(err.value))
            pool.alloc()
        with pytest.raises(ValueError, match="kv_host_pages"):
            mod.HostPagePool(cfg, host_pages=0, page_size=16)
        traces.append(out)
    assert traces[0] == traces[1]
    # bf16, which numpy cannot hold: the port's buffers are torch tensors
    # of the pool's dtype, so the round trip stays bit-identical.
    bcfg = dataclasses.replace(tcfg, dtype="bfloat16")
    pool = paging.HostPagePool(bcfg, host_pages=1, page_size=16)
    kb = torch.from_numpy(k).to(torch.bfloat16)
    h = pool.alloc()
    pool.store(h, kb, -kb)
    lk, lv = pool.load(h)
    assert lk.dtype == torch.bfloat16 and torch.equal(lk, kb)
    assert torch.equal(lv, -kb)


def test_int8_kv_pages_match_jax_and_dense(weights):
    """quantize_kv on the paged engine (the reference's
    test_paged_int8_kv_matches_dense_int8, held to the JAX paged engine
    too): int8 pages with scales; greedy ids equal the JAX paged int8
    engine's and the port's dense int8 engine's, including a second
    request that shares the first one's pages (dequantized at gather)."""
    jcfg, jparams, tcfg, tparams = weights
    prompt = [7, 3, 11, 2, 9, 40, 41] + list(range(50, 70))
    outs = []
    for eng in _engines(weights, max_slots=2, page_size=16,
                        quantize_kv=True):
        assert eng.cache.quantized
        first = _drain(eng, _greedy(eng, [prompt], 8))
        again = _drain(eng, _greedy(eng, [prompt + [99]], 8))
        outs.append((first, again, eng.pager.occupancy()))
    assert outs[0] == outs[1]
    assert outs[0][2]["pages_reused_total"] >= 1
    dense = InferenceEngine(dataclasses.replace(tcfg, quantize_kv=True),
                            tparams, max_slots=2)
    assert dense.cache.quantized
    assert _drain(dense, _greedy(dense, [prompt], 8)) == outs[0][0]


def test_bucket_helpers_match_reference():
    for m in range(1, 70):
        assert paging.prefix_page_buckets(m) == \
            jax_paging.prefix_page_buckets(m)
        for n in range(0, m + 3):
            assert paging.page_bucket(n, m) == jax_paging.page_bucket(n, m)
    for seq in (16, 64, 128, 256, 1024, 2048, 4096):
        for ps in (1, 8, 16, 32):
            assert paging.view_page_buckets_for(seq, ps) == \
                jax_paging.view_page_buckets_for(seq, ps)
            buckets = [b for b in (16, 32, 64, 128, 256, 512, 1024, 2048)
                       if b < seq] + [seq]
            if seq % ps == 0:
                assert paging.paged_prefill_shapes(
                    buckets, seq // ps, ps, seq) == \
                    jax_paging.paged_prefill_shapes(buckets, seq // ps, ps,
                                                    seq)
    assert len(paging.paged_prefill_shapes([16, 32, 64], 4, 16, 64)) == 9


# ---------------------------------------------------------------------------
# The engine against the JAX engine and the port's dense engine
# ---------------------------------------------------------------------------

def _engines(weights, **kw):
    jcfg, jparams, tcfg, tparams = weights
    return (PagedInferenceEngine(tcfg, tparams, **kw),
            jax_paging.PagedInferenceEngine(jcfg, jparams, **kw))


def _greedy(eng, prompts, max_tokens):
    cls = Request if isinstance(eng, InferenceEngine) else JaxRequest
    return [cls(prompt_tokens=list(p), max_tokens=max_tokens,
                temperature=0.0) for p in prompts]


def _drain(eng, reqs):
    for r in reqs:
        eng.submit(r)
    while eng.has_work():
        eng.step()
    return [r.output_tokens for r in reqs]


def _dense(weights, prompts, max_tokens, max_slots=4):
    _, _, tcfg, tparams = weights
    eng = InferenceEngine(tcfg, tparams, max_slots=max_slots)
    return _drain(eng, _greedy(eng, prompts, max_tokens))


def _counters(eng):
    return (eng.pager.occupancy(), eng.prefix_tokens_reused,
            eng.prefix_hits, eng.prefix_lookups)


def test_plain_mix_equals_jax_and_dense(weights):
    prompts = [[5, 9, 17], list(range(3, 21)), [42], list(range(30, 63))]
    outs = []
    for eng in _engines(weights, max_slots=4, page_size=16):
        outs.append((_drain(eng, _greedy(eng, prompts, 8)), _counters(eng)))
    assert outs[0] == outs[1]
    assert outs[0][0] == _dense(weights, prompts, 8)
    occ = outs[0][1][0]
    # Every page released or adopted: nothing held by a dead slot.
    assert occ["pages_used"] == occ["pages_shared"] > 0


def test_shared_prefix_and_page_accounting_equal_jax(weights):
    shared = list(range(1, 34))      # 33 tokens: 2 full pages
    prompts = [shared + [50, 51]]
    outs = []
    for eng in _engines(weights, max_slots=4, page_size=16):
        reg = eng.register_prefix(shared)
        has = eng.has_prefix(shared + [99])
        after_reg = eng.pager.occupancy()["pages_shared"]
        ids = _drain(eng, _greedy(eng, prompts, 6))
        outs.append((reg, has, after_reg, ids, _counters(eng),
                     eng.register_prefix_from_slot(0, [1, 2, 3])))
    assert outs[0] == outs[1]
    reg, has, after_reg, ids, (occ, reused, hits, lookups), _ = outs[0]
    assert (reg, has, after_reg) == (32, True, 2)
    assert (occ["pages_reused_total"], reused, hits, lookups) == \
        (2, 32, 1, 2)
    assert ids == _dense(weights, prompts, 6)


def test_cow_divergence_mid_generation_equals_jax(weights):
    shared = list(range(1, 33))      # exactly 2 pages
    outs = []
    for eng in _engines(weights, max_slots=4, page_size=16):
        eng.register_prefix(shared)
        # Two concurrent requests share the prefix pages and diverge from
        # their first private token; a third reuses the pages afterwards.
        ab = _drain(eng, _greedy(eng, [shared + [50], shared + [60, 61]],
                                 8))
        c = _drain(eng, _greedy(eng, [shared + [70]], 6))
        outs.append((ab, c, _counters(eng)))
    assert outs[0] == outs[1]
    assert outs[0][2][0]["pages_reused_total"] >= 6
    assert outs[0][0] == _dense(weights, [shared + [50],
                                          shared + [60, 61]], 8)


def test_page_pressure_serializes_like_jax(weights):
    prompts = [list(range(1, 33)), list(range(40, 72)),
               list(range(60, 92))]
    outs = []
    for eng in _engines(weights, max_slots=4, page_size=16, num_pages=4,
                        max_queue=3):
        reqs = _greedy(eng, prompts, 32)   # 4 pages reserved each
        for r in reqs:
            eng.submit(r)
        eng.step()
        first = (int(eng.active.sum()), len(eng.queue))
        # A full pool backs the queue up; past max_queue, submit sheds.
        extra = _greedy(eng, [[1, 2]], 4)
        eng.submit(extra[0])
        with pytest.raises(Exception) as err:
            eng.submit(_greedy(eng, [[3, 4]], 4)[0])
        shed = type(err.value).__name__
        while eng.has_work():
            eng.step()
        outs.append((first, shed, [r.output_tokens for r in reqs + extra],
                     [r.finish_reason for r in reqs], _counters(eng)))
    assert outs[0] == outs[1]
    assert outs[0][:2] == ((1, 2), EngineOverloaded.__name__)
    assert outs[0][2][:3] == _dense(weights, prompts, 32, max_slots=1)


def test_eviction_then_recompute_equals_jax(weights):
    shared = list(range(1, 33))
    outs = []
    for eng in _engines(weights, max_slots=2, page_size=16, num_pages=5):
        eng.register_prefix(shared)
        big = _drain(eng, _greedy(eng, [list(range(90, 122))], 32))
        evicted = eng.pager.radix.pages_evicted
        r = _drain(eng, _greedy(eng, [shared + [50]], 5))
        outs.append((big, evicted, r, _counters(eng)))
    assert outs[0] == outs[1]
    assert outs[0][1] >= 1
    assert outs[0][2] == _dense(weights, [shared + [50]], 5)


def test_multi_turn_adoption_and_deadline_release_equal_jax(weights):
    prompt1 = list(range(1, 30))
    outs = []
    for eng in _engines(weights, max_slots=2, page_size=16):
        r1 = _greedy(eng, [prompt1], 8)[0]
        _drain(eng, [r1])
        shared_after = eng.pager.occupancy()["pages_shared"]
        r2 = _drain(eng, _greedy(eng, [prompt1 + r1.output_tokens + [77]],
                                 6))
        # An active request expiring mid-generation frees its pages.
        r3 = _greedy(eng, [list(range(1, 20))], 40)[0]
        r3.deadline_s = 30.0
        eng.submit(r3)
        eng.step()
        r3.deadline_s = 0.0
        eng.step()
        occ = eng.pager.occupancy()
        outs.append((r1.output_tokens, shared_after, r2,
                     r3.finish_reason, len(r3.output_tokens) > 0,
                     occ["pages_used"] == occ["pages_shared"],
                     _counters(eng)))
    assert outs[0] == outs[1]
    assert outs[0][1] == 2 and outs[0][3] == "deadline" and outs[0][5]


def test_geometry_and_knob_validation(weights):
    jcfg, jparams, tcfg, tparams = weights
    for cls, cfg, params in ((PagedInferenceEngine, tcfg, tparams),
                             (jax_paging.PagedInferenceEngine, jcfg,
                              jparams)):
        with pytest.raises(ValueError, match="must divide max_seq_len"):
            cls(cfg, params, max_slots=2, page_size=24)
        with pytest.raises(ValueError, match="one max-length"):
            cls(cfg, params, max_slots=2, page_size=16, num_pages=2)
        with pytest.raises(ValueError, match="kv_host_pages must be >= 0"):
            cls(cfg, params, max_slots=2, kv_host_pages=-1)
        with pytest.raises(ValueError, match="preemption must be"):
            cls(cfg, params, max_slots=2, preemption="maybe")
    # A serving mesh is a torch DeviceMesh (the reference's check names
    # jax.sharding.Mesh); tests/test_torch_tp_engine.py covers the rest
    # of the mesh's geometry. The adapter pool is ported: the paged
    # engine builds one.
    with pytest.raises(ValueError, match="DeviceMesh"):
        PagedInferenceEngine(tcfg, tparams, max_slots=2, mesh=object())
    pooled = PagedInferenceEngine(tcfg, tparams, max_slots=2, adapter_pool=2)
    assert pooled.adapters.pool_size == 2
    assert pooled.adapter_stats()["resident"] == []
    eng = PagedInferenceEngine(tcfg, tparams, max_slots=2, page_size=16)
    assert eng.cache.k.shape == (2, 9, 16, 2, 16)   # 8 pages + trash
    assert eng.kv_occupancy()["paged"] is True
    assert eng.device.type == "cpu"


def test_speculative_verify_over_pages_equals_jax_and_off(weights):
    """The paged verify forward: one [B, K+1] forward over the gathered
    view with every live position written back to its page. Greedy ids
    with n-gram drafts equal the JAX paged engine's (and its draft
    counters) and the port's without speculation."""
    prompts = [[5, 6, 7, 8] * 5 + [5, 6], [9, 3, 9, 3, 9, 3, 1, 2, 9, 3],
               list(range(20, 50))]
    outs = []
    for eng in _engines(weights, max_slots=4, page_size=16,
                        speculative="ngram", draft_tokens=4):
        ids = _drain(eng, _greedy(eng, prompts, 20))
        outs.append((ids, eng.spec_drafted, eng.spec_accepted,
                     eng.spec_verify_steps, _counters(eng)))
    assert outs[0] == outs[1]
    assert outs[0][1] > 0 and outs[0][2] > 0
    assert outs[0][0] == _dense(weights, prompts, 20)
