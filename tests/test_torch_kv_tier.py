"""The port's host swap tier and QoS preemption (serve/paging.py and the
dense engine's hooks) against the JAX package's.

On a tiny llama config at float32 with the reference's weights
(models/bridge.py, matmul precision "highest"), the port's
``PagedInferenceEngine`` gives greedy ids identical to the JAX one's and
to the port's dense engine's, with equal page, refcount, swap and
preemption counters, for a swap-out / swap-in round trip and a preemption
with loss-free resume; ``RBT_FAULT_INJECT=swapfail:K`` degrades to drop and
to recompute and leaks no page in either tier; the deadline expiry of a
preempted, queued request balances both tiers; the knobs raise the
reference's errors.

As in tests/test_torch_paging.py, the reference's nodes get the port's
LRU tie-break (creation order instead of memory address) for the length
of each test.
"""

import dataclasses

import jax
import numpy as np
import pytest
import torch

from runbooks_tpu.models.config import get_config as jax_get_config
from runbooks_tpu.models.transformer import init_params as jax_init_params
from runbooks_tpu.serve import paging as jax_paging
from runbooks_tpu.serve.engine import InferenceEngine as JaxEngine
from runbooks_tpu.serve.engine import Request as JaxRequest

from runbooks_tpu_torch.models import bridge
from runbooks_tpu_torch.models.config import get_config
from runbooks_tpu_torch.serve.engine import InferenceEngine, Request
from runbooks_tpu_torch.serve.paging import PagedInferenceEngine
from tests import tp_oracle

torch.set_num_threads(2)

TINY = dict(vocab_size=128, hidden_size=64, intermediate_size=128,
            num_layers=2, num_heads=4, num_kv_heads=2, head_dim=16,
            max_seq_len=64, dtype="float32")
SHARED = list(range(1, 33))          # two full pages of 16


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


def _engines(weights, **kw):
    jcfg, jparams, tcfg, tparams = weights
    return (PagedInferenceEngine(tcfg, tparams, **kw),
            jax_paging.PagedInferenceEngine(jcfg, jparams, **kw))


def _req(eng, prompt, max_tokens, **kw):
    cls = Request if isinstance(eng, InferenceEngine) else JaxRequest
    return cls(prompt_tokens=list(prompt), max_tokens=max_tokens,
               temperature=0.0, **kw)


def _drain(eng, reqs):
    for r in reqs:
        eng.submit(r)
    while eng.has_work():
        eng.step()
    return [r.output_tokens for r in reqs]


def _dense(weights, prompt, max_tokens):
    _, _, tcfg, tparams = weights
    eng = InferenceEngine(tcfg, tparams, max_slots=2)
    return _drain(eng, [_req(eng, prompt, max_tokens)])[0]


def _balance(eng):
    """Empty both tiers of the tree; every reference taken must be gone."""
    eng.pager.radix.evict(10 ** 6)
    eng.pager.radix.evict_host(10 ** 6)
    return eng.pager.allocator.used_count, eng.host_pool.used_count


def test_swap_out_and_in_round_trip_equals_jax(weights):
    outs = []
    for eng in _engines(weights, max_slots=2, page_size=16, num_pages=5,
                        kv_host_pages=4):
        eng.register_prefix(SHARED)
        # A non-matching max-reservation request evicts the idle prefix
        # pages, which copy to the host tier instead of dropping.
        big = _drain(eng, [_req(eng, range(90, 122), 32)])
        after_out = eng.pager.occupancy()
        # The returning session swaps its prefix back in.
        back = _drain(eng, [_req(eng, SHARED + [50], 5)])
        outs.append((big, after_out, back, eng.pager.occupancy(),
                     eng.prefix_tokens_reused))
    assert outs[0] == outs[1]
    _, after_out, back, occ, _ = outs[0]
    assert after_out["swap_out_pages_total"] >= 1
    assert after_out["host_pages_used"] >= 1
    assert occ["swap_in_pages_total"] >= 1
    assert back[0] == _dense(weights, SHARED + [50], 5)


def test_swapped_page_is_bit_identical(weights):
    _, _, tcfg, tparams = weights
    eng = PagedInferenceEngine(tcfg, tparams, max_slots=2, page_size=16,
                               num_pages=8, kv_host_pages=2)
    eng.register_prefix(SHARED)
    page = eng.pager.radix.match(SHARED)[0]
    k, v = eng.cache.k[:, page].clone(), eng.cache.v[:, page].clone()
    h = eng._kv_swap_out(page)
    dest = eng.pager.allocator.alloc(1)[0]
    assert eng._kv_swap_in(h, dest)
    assert torch.equal(eng.cache.k[:, dest], k)
    assert torch.equal(eng.cache.v[:, dest], v)
    assert len(eng.swap_seconds["out"]) == len(eng.swap_seconds["in"]) == 1


def _preempt_run(eng, deadline=None):
    batch = _req(eng, SHARED, 16, priority="batch", deadline_s=deadline)
    eng.submit(batch)
    for _ in range(3):                # admit, then decode a few tokens
        eng.step()
    mid = (bool(eng.active.any()), batch.finished, len(batch.output_tokens))
    inter = _req(eng, range(90, 106), 8, priority="interactive")
    eng.submit(inter)
    eng.step()
    return batch, inter, mid, (eng.preemptions, batch.finished)


def test_preemption_resumes_without_token_loss_like_jax(weights):
    outs = []
    for eng in _engines(weights, max_slots=1, page_size=16, num_pages=5,
                        kv_host_pages=8, preemption="swap",
                        decode_chunk=2):
        batch, inter, mid, at = _preempt_run(eng)
        while eng.has_work():
            eng.step()
        outs.append((mid, at, batch.output_tokens, batch.finish_reason,
                     inter.output_tokens, inter.finish_reason,
                     eng.preemptions, eng.preempted_resumed,
                     eng.pager.occupancy()))
    assert outs[0] == outs[1]
    mid, at, ids, reason, iids, _, n, resumed, _ = outs[0]
    assert mid[:2] == (True, False) and at == (1, False)
    assert (n, resumed, reason) == (1, 1, "length")
    # Loss-free: the preempted request's ids are those of an undisturbed
    # run, and so are the interactive request's.
    assert ids == _dense(weights, SHARED, 16)
    assert iids == _dense(weights, list(range(90, 106)), 8)


def test_preempted_deadline_expiry_balances_both_tiers_like_jax(weights):
    outs = []
    for eng in _engines(weights, max_slots=1, page_size=16, num_pages=5,
                        kv_host_pages=4, preemption="swap",
                        decode_chunk=2):
        batch, inter, _, at = _preempt_run(eng, deadline=30.0)
        # The preempted request's deadline expires while it is queued: it
        # finishes with what it has, and its adopted pages stay tree
        # state, not a dead request's.
        batch.deadline_s = 0.0
        eng.step()
        reason = batch.finish_reason
        while eng.has_work():
            eng.step()
        occ = eng.pager.occupancy()
        outs.append((at, reason, inter.finish_reason,
                     occ["pages_used"] == occ["pages_shared"], occ,
                     _balance(eng)))
    assert outs[0] == outs[1]
    assert outs[0][:4] == ((1, False), "deadline", "length", True)
    assert outs[0][5] == (0, 0)


def test_swapfail_degrades_swap_out_to_drop(weights, monkeypatch):
    monkeypatch.setenv("RBT_FAULT_INJECT", "swapfail:1")
    outs = []
    for eng in _engines(weights, max_slots=2, page_size=16, num_pages=5,
                        kv_host_pages=4):
        eng.register_prefix(SHARED)
        _drain(eng, [_req(eng, range(90, 122), 32)])   # 1st copy fails
        dropped = eng.pager.occupancy()["swap_dropped_pages_total"]
        back = _drain(eng, [_req(eng, SHARED + [50], 5)])
        outs.append((dropped, back, eng.pager.occupancy(), _balance(eng)))
    assert outs[0] == outs[1]
    assert outs[0][0] >= 1 and outs[0][3] == (0, 0)
    assert outs[0][1][0] == _dense(weights, SHARED + [50], 5)


def test_swapfail_degrades_swap_in_to_recompute(weights):
    outs = []
    for eng in _engines(weights, max_slots=2, page_size=16, num_pages=8,
                        kv_host_pages=4):
        eng.register_prefix(SHARED)
        evicted = eng.pager.radix.evict(2)       # both pages to host
        host_used = eng.pager.occupancy()["host_pages_used"]
        # The next copy is the returning session's swap-in: it fails, the
        # admission rolls back, and the prompt recomputes.
        eng._swap_fault = 1
        back = _drain(eng, [_req(eng, SHARED + [50], 5)])
        outs.append((evicted, host_used, back,
                     eng.pager.occupancy()["swap_in_pages_total"],
                     _balance(eng)))
    assert outs[0] == outs[1]
    assert outs[0][:2] == (2, 2) and outs[0][3:] == (0, (0, 0))
    assert outs[0][2][0] == _dense(weights, SHARED + [50], 5)


def test_swapfail_spec_and_preemption_knob_are_validated(weights,
                                                         monkeypatch):
    jcfg, jparams, tcfg, tparams = weights
    for cls, cfg, params in ((InferenceEngine, tcfg, tparams),
                             (JaxEngine, jcfg, jparams)):
        monkeypatch.setenv("RBT_FAULT_INJECT", "swapfail:0")
        with pytest.raises(ValueError, match="K must be >= 1"):
            cls(cfg, params, max_slots=1)
        monkeypatch.setenv("RBT_FAULT_INJECT", "swapfail:soon")
        with pytest.raises(ValueError, match="expected swapfail:K"):
            cls(cfg, params, max_slots=1)
        monkeypatch.delenv("RBT_FAULT_INJECT")
        # The dense engine has no pages to swap.
        with pytest.raises(ValueError, match="kv_paging: paged"):
            cls(cfg, params, max_slots=1, preemption="swap")
        with pytest.raises(ValueError, match="preemption must be"):
            cls(cfg, params, max_slots=1, preemption="maybe")
    eng = InferenceEngine(tcfg, tparams, max_slots=2)
    assert (eng.preemption, eng.preemptions, eng.preempted_resumed) == \
        ("off", 0, 0)
    occ = eng.kv_occupancy()
    assert occ["kv_capacity_tokens"] == 2 * 64 and occ["kv_tokens"] == 0


def test_host_tier_reset_keeps_buffers_and_empties_the_tree(weights):
    _, _, tcfg, tparams = weights
    eng = PagedInferenceEngine(tcfg, tparams, max_slots=2, page_size=16,
                               num_pages=8, kv_host_pages=2)
    buf = eng.host_pool.k
    eng.register_prefix(SHARED)
    eng.pager.radix.evict(2)
    assert eng.host_pool.used_count == 2
    eng.reset()
    assert eng.host_pool.k is buf and eng.host_pool.used_count == 0
    assert eng.pager.radix.host is eng.host_pool
    assert eng.pager.occupancy()["pages_used"] == 0
    # After the reset the tree is empty and serving is exact.
    assert _drain(eng, [_req(eng, SHARED + [50], 5)])[0] == \
        _dense(weights, SHARED + [50], 5)
