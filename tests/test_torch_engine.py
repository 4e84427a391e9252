"""The port's dense InferenceEngine against the JAX package's.

Both engines serve the ``debug`` config at float32 with the reference's
``init_params`` weights (carried over by models/bridge.py) and flash
attention (JAX: the Pallas kernel in interpret mode; the port: the plain
version on the CPU). Greedy outputs must be token-identical, for a batch
whose prompts span the 16/32/64 prefill buckets and arrive faster than the
prefill budget admits them, at decode_chunk 1 and 4.
"""

import time

import jax
import numpy as np
import pytest
import torch

from runbooks_tpu.models.config import get_config as jax_get_config
from runbooks_tpu.models.transformer import init_params as jax_init_params
from runbooks_tpu.serve.engine import InferenceEngine as JaxEngine
from runbooks_tpu.serve.engine import Request as JaxRequest

from runbooks_tpu_torch.models import bridge
from runbooks_tpu_torch.models.config import get_config
from runbooks_tpu_torch.serve.engine import (
    EngineOverloaded,
    InferenceEngine,
    Request,
    view_buckets_for,
)

torch.set_num_threads(2)

MAX_SEQ = 64
# (prompt length, max_tokens): buckets 16, 32, 64, 16 and a prompt that
# runs into the context window (finish by cache room, not budget).
SHAPES = [(5, 9), (20, 7), (40, 12), (12, 10), (58, 10)]


def _prompts():
    rng = np.random.default_rng(0)
    return [rng.integers(0, 512, n).tolist() for n, _ in SHAPES]


@pytest.fixture(scope="module")
def weights():
    jcfg = jax_get_config("debug", dtype="float32", attention_impl="flash")
    jparams = jax_init_params(jcfg, jax.random.key(0))
    tcfg = get_config("debug", dtype="float32", attention_impl="flash")
    tparams = bridge.from_jax_numpy(tcfg, jax.tree.map(np.asarray, jparams))
    return jcfg, jparams, tcfg, tparams


def _serve_torch(tcfg, tparams, chunk, **kw):
    eng = InferenceEngine(tcfg, tparams, max_slots=4, max_seq_len=MAX_SEQ,
                          decode_chunk=chunk, **kw)
    reqs = [Request(prompt_tokens=p, max_tokens=m)
            for p, (_, m) in zip(_prompts(), SHAPES)]
    eng.generate(reqs)
    return eng, reqs


@pytest.mark.parametrize("chunk", [1, 4])
def test_greedy_tokens_match_jax_engine(weights, chunk):
    jcfg, jparams, tcfg, tparams = weights
    jeng = JaxEngine(jcfg, jparams, max_slots=4, max_seq_len=MAX_SEQ,
                     decode_chunk=chunk)
    jreqs = [JaxRequest(prompt_tokens=p, max_tokens=m)
             for p, (_, m) in zip(_prompts(), SHAPES)]
    jeng.generate(jreqs)
    eng, reqs = _serve_torch(tcfg, tparams, chunk)
    for j, t in zip(jreqs, reqs):
        assert t.output_tokens == j.output_tokens
        assert (t.finish_reason, t.finished) == (j.finish_reason, j.finished)
    # The batch needed several admission ticks and more than one
    # prefill dispatch, and the 58-token prompt ran out of room.
    assert eng.prefill_dispatches >= 3
    # (the prefill's token, then one decode per free cache position).
    assert len(reqs[-1].output_tokens) == 1 + MAX_SEQ - 58


def test_sampled_requests_finish_with_their_budget(weights):
    _, _, tcfg, tparams = weights
    eng = InferenceEngine(tcfg, tparams, max_slots=4, max_seq_len=MAX_SEQ,
                          decode_chunk=4, seed=3)
    reqs = [Request(prompt_tokens=p, max_tokens=6, temperature=0.8,
                    top_p=0.9) for p in _prompts()[:4]]
    eng.generate(reqs)
    assert all(r.finished and len(r.output_tokens) == 6 for r in reqs)
    assert all(0 <= t < tcfg.vocab_size for r in reqs
               for t in r.output_tokens)


def test_eos_finishes_a_request(weights):
    _, _, tcfg, tparams = weights
    _, base = _serve_torch(tcfg, tparams, 1)
    eos = base[0].output_tokens[3]
    stop_at = base[0].output_tokens.index(eos) + 1
    for chunk in (1, 4):
        eng = InferenceEngine(tcfg, tparams, max_slots=4,
                              max_seq_len=MAX_SEQ, decode_chunk=chunk)
        req = Request(prompt_tokens=_prompts()[0], max_tokens=9, eos_id=eos)
        eng.generate([req])
        assert req.finish_reason == "stop"
        assert req.output_tokens == base[0].output_tokens[:stop_at]
        assert not eng.has_work()


def test_queue_bound_sheds_with_overloaded(weights):
    _, _, tcfg, tparams = weights
    eng = InferenceEngine(tcfg, tparams, max_slots=2, max_seq_len=MAX_SEQ,
                          max_queue=3)
    for _ in range(3):
        eng.submit(Request(prompt_tokens=[1, 2, 3], max_tokens=2))
    with pytest.raises(EngineOverloaded):
        eng.submit(Request(prompt_tokens=[1, 2, 3], max_tokens=2))
    with pytest.raises(ValueError):
        eng.submit(Request(prompt_tokens=list(range(MAX_SEQ))))
    with pytest.raises(ValueError):
        eng.submit(Request(prompt_tokens=[tcfg.vocab_size]))


def test_deadline_expires_queued_and_active(weights):
    _, _, tcfg, tparams = weights
    eng = InferenceEngine(tcfg, tparams, max_slots=1, max_seq_len=MAX_SEQ)
    live = Request(prompt_tokens=[1, 2, 3], max_tokens=50, deadline_s=0.0)
    eng.submit(live)
    eng._admit()
    queued = Request(prompt_tokens=[4, 5], max_tokens=5, deadline_s=0.0)
    eng.submit(queued)
    eng.step()
    assert live.finish_reason == "deadline" and len(live.output_tokens) == 1
    assert queued.finish_reason == "deadline" and not queued.output_tokens
    assert eng.deadline_expired == 2


def test_buckets_and_views_match_reference():
    from runbooks_tpu.serve import engine as jax_engine

    from runbooks_tpu_torch.serve import engine as torch_engine

    for n in (16, 64, 100, 2048):
        assert torch_engine._buckets(n) == jax_engine._buckets(n)
        assert view_buckets_for(n) == jax_engine.view_buckets_for(n)
    b = torch_engine._buckets(2048)
    for n in (1, 16, 17, 900, 2048, 5000):
        assert torch_engine.bucket_for(b, n) == jax_engine.bucket_for(b, n)


def test_dispatch_seconds_and_profiler_labels(weights):
    _, _, tcfg, tparams = weights
    eng = InferenceEngine(tcfg, tparams, max_slots=2, max_seq_len=MAX_SEQ,
                          decode_chunk=2)
    reqs = [Request(prompt_tokens=p, max_tokens=5) for p in _prompts()[:2]]
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        t0 = time.perf_counter()
        eng.generate(reqs)
        wall = time.perf_counter() - t0
    secs = eng.dispatch_seconds
    assert secs["prefill"] > 0 and secs["decode"] > 0
    assert secs["prefill"] + secs["decode"] <= wall
    counts = {e.key: e.count for e in prof.key_averages()}
    assert counts["prefill_dispatch"] == eng.prefill_dispatches
    assert counts["decode_dispatch"] == eng.steps


def test_engine_takes_params_device(weights):
    _, _, tcfg, tparams = weights
    eng = InferenceEngine(tcfg, tparams, max_slots=1, max_seq_len=MAX_SEQ)
    assert eng.device.type == "cpu" and eng.decode_chunk == 1
    assert eng.cache.k.device.type == "cpu"
