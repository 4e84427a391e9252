"""The port's speculative decoding against the JAX package's.

Parts, each held to the reference on the same inputs:

- ``NgramDraftIndex`` and ``legal_draft_prefix``: the same drafts on
  seeded token streams (exact: host code on ints).
- ``speculative_verify``: greedy ``accept``, ``resid`` and ``full`` equal
  to the JAX function's on the same logits (exact: argmax of the same f32
  values); ``p_draft`` equal to ``_filtered_draft_stats``' within 1e-6
  (f32 softmax of the same logits, summed in another order); temperature
  rows in distribution (the RNGs differ): the accept rate within 4 sigma
  of ``pi(draft)`` and the residual's marginal within 4 sigma of ``pi``
  with the draft taken out.
- The engine, on the ``debug`` config at float32 with the reference's
  weights (models/bridge.py): greedy outputs with ``speculative="ngram"``
  equal to the JAX speculative engine's and to the port's without
  speculation, with the same ``spec_drafted``/``spec_accepted``/
  ``spec_verify_steps`` (greedy drafting is deterministic); and, with an
  oracle draft source, the reference's batch semantics: variable accept
  lengths, draftless slots, the fallback to the decode chunk, the caps by
  budget and room, EOS inside an accepted draft.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from runbooks_tpu.models.config import get_config as jax_get_config
from runbooks_tpu.models.transformer import init_params as jax_init_params
from runbooks_tpu.ops.sampling import (
    _filtered_draft_stats as jax_filtered_draft_stats,
)
from runbooks_tpu.ops.sampling import (
    speculative_verify as jax_speculative_verify,
)
from runbooks_tpu.serve.engine import InferenceEngine as JaxEngine
from runbooks_tpu.serve.engine import Request as JaxRequest
from runbooks_tpu.serve.grammar import GrammarCache as JaxGrammarCache
from runbooks_tpu.serve.grammar import TokenVocab as JaxTokenVocab
from runbooks_tpu.serve.speculative import NgramDraftIndex as JaxIndex
from runbooks_tpu.serve.speculative import (
    legal_draft_prefix as jax_legal_draft_prefix,
)
from runbooks_tpu.train.data import ByteTokenizer as JaxByteTokenizer

from runbooks_tpu_torch.models import bridge
from runbooks_tpu_torch.models.config import (
    SPECULATIVE_MODES,
    check_speculative,
    get_config,
)
from runbooks_tpu_torch.ops.sampling import (
    _filtered_draft_stats,
    speculative_verify,
)
from runbooks_tpu_torch.serve.engine import InferenceEngine, Request
from runbooks_tpu_torch.serve.grammar import GrammarCache, TokenVocab
from runbooks_tpu_torch.serve.speculative import (
    NgramDraftIndex,
    legal_draft_prefix,
)
from runbooks_tpu_torch.train.data import ByteTokenizer
from runbooks_tpu_torch.utils.hw import backend_tuning

torch.set_num_threads(2)

MAX_SEQ = 64
# A prompt with internal repetition (the drafter fires from the first
# decode step) and a random one.
REP_PROMPT = [5, 6, 7, 8] * 5 + [5, 6]
RND_PROMPT = [int(t) for t in np.random.default_rng(7).integers(1, 128, 18)]
# Tolerance of p_draft: f32 softmax of the same logits, reduced in
# another order.
P_DRAFT_TOL = 1e-6


# ---------------------------------------------------------------------------
# Prompt-lookup index and the grammar cut of drafts
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("ngram_max,ngram_min", [(3, 1), (2, 2), (4, 1)])
def test_ngram_index_drafts_match_reference(ngram_max, ngram_min):
    rng = np.random.default_rng(ngram_max * 10 + ngram_min)
    port = NgramDraftIndex(2, ngram_max, ngram_min)
    ref = JaxIndex(2, ngram_max, ngram_min)
    for slot in (0, 1):
        # A small alphabet, so n-grams recur.
        prompt = rng.integers(0, 6, int(rng.integers(1, 30))).tolist()
        port.begin(slot, prompt)
        ref.begin(slot, prompt)
        for _ in range(40):
            for k in (0, 1, 3, 4):
                assert port.draft(slot, k) == ref.draft(slot, k)
            tok = int(rng.integers(0, 6))
            port.extend(slot, tok)
            ref.extend(slot, tok)
            assert port.context_len(slot) == ref.context_len(slot)
    port.clear(0)
    assert port.draft(0, 4) == [] and port.context_len(0) == 0
    port.reset()
    assert port.draft(1, 4) == []


def test_ngram_index_refuses_bad_sizes():
    for bad in ((2, 3), (0, 0)):
        with pytest.raises(ValueError, match="ngram"):
            NgramDraftIndex(1, *bad)
        with pytest.raises(ValueError, match="ngram"):
            JaxIndex(1, *bad)


def test_legal_draft_prefix_matches_reference():
    rfs = [{"type": "ebnf", "grammar": 'root ::= "ab"'},
           {"type": "ebnf", "grammar": 'root ::= "[" [0-9] ("," [0-9])* "]"'}]
    port = GrammarCache(TokenVocab.from_tokenizer(ByteTokenizer()), 258)
    ref = JaxGrammarCache(JaxTokenVocab.from_tokenizer(JaxByteTokenizer()),
                          258)
    rng = np.random.default_rng(0)
    alphabet = [ord(c) for c in "ab[],0123x"]
    for rf in rfs:
        pc, rc = port.cursor(rf), ref.cursor(rf)
        for _ in range(200):
            draft = [int(t) for t in rng.choice(alphabet,
                                                int(rng.integers(0, 6)))]
            assert legal_draft_prefix(pc, draft) == \
                jax_legal_draft_prefix(rc, draft)
            # Advance both cursors along a legal token now and then.
            legal = legal_draft_prefix(pc, draft)
            if legal and not pc.dfa.terminal[pc.walk(legal[:1])[0]]:
                assert pc.advance(legal[0]) and rc.advance(legal[0])
        assert pc.state == rc.state
    assert legal_draft_prefix(None, [1, 2, 3]) == [1, 2, 3]


# ---------------------------------------------------------------------------
# Verify math
# ---------------------------------------------------------------------------

def _jax_verify(logits, drafts, temps, top_ks, top_ps, gmask=None):
    out = jax_speculative_verify(
        jnp.asarray(logits), jnp.asarray(drafts), jax.random.key(0),
        jnp.asarray(temps), jnp.asarray(top_ks), jnp.asarray(top_ps),
        gmask=None if gmask is None else jnp.asarray(gmask))
    return [np.asarray(x) for x in out]


def _torch_verify(logits, drafts, temps, top_ks, top_ps, gmask=None,
                  seed=0):
    out = speculative_verify(
        torch.from_numpy(logits), torch.from_numpy(drafts),
        torch.Generator().manual_seed(seed), torch.from_numpy(temps),
        torch.from_numpy(top_ks), torch.from_numpy(top_ps),
        gmask=None if gmask is None else torch.from_numpy(gmask))
    return [x.numpy() for x in out]


@pytest.mark.parametrize("masked", [False, True], ids=["plain", "gmask"])
def test_verify_greedy_rows_equal_reference(masked):
    rng = np.random.default_rng(0)
    b, s, vocab = 4, 5, 64
    logits = rng.normal(size=(b, s, vocab)).astype(np.float32)
    gmask = None
    if masked:
        gmask = rng.random((b, s, vocab)) < 0.5
        gmask[..., 0] = True
    shown = np.where(gmask, logits, -np.inf) if masked else logits
    argmax = shown.argmax(-1)
    # Row 0 drafts the argmax chain, row 1 wrong tokens, rows 2 and 3 a
    # chain that breaks at position 2 and at position 0.
    drafts = argmax[:, :-1].astype(np.int32).copy()
    drafts[1] = (drafts[1] + 1) % vocab
    drafts[2, 2] = (drafts[2, 2] + 1) % vocab
    drafts[3, 0] = (drafts[3, 0] + 1) % vocab
    temps = np.zeros(b, np.float32)
    top_ks = np.array([0, 5, 0, 64], np.int32)
    top_ps = np.array([1.0, 1.0, 0.9, 1.0], np.float32)
    ref = _jax_verify(logits, drafts, temps, top_ks, top_ps, gmask)
    got = _torch_verify(logits, drafts, temps, top_ks, top_ps, gmask)
    for name, r, g in zip(("accept", "resid", "full"), ref, got):
        np.testing.assert_array_equal(g, r, err_msg=name)
    assert got[0][0].all() and not got[0][1].any()
    assert got[0][2].tolist() == [True, True, False, True]


@pytest.mark.parametrize("top_k,top_p", [(0, 1.0), (6, 1.0), (0, 0.8),
                                         (10, 0.9)])
def test_p_draft_matches_filtered_draft_stats(top_k, top_p):
    rng = np.random.default_rng(top_k)
    n, vocab = 64, 200
    logits = rng.normal(size=(n, vocab)).astype(np.float32) * 2
    order = np.argsort(-logits, axis=-1)
    # Drafts from the top of the distribution, the lane's edge and its
    # tail.
    draft = order[np.arange(n), rng.integers(0, 80, n)].astype(np.int32)
    temps = rng.uniform(0.3, 1.5, n).astype(np.float32)
    ks = np.full(n, top_k, np.int32)
    ps = np.full(n, top_p, np.float32)
    ref, _ = jax_filtered_draft_stats(
        jnp.asarray(logits), jnp.asarray(draft), jax.random.key(0),
        jnp.asarray(temps), jnp.asarray(ks), jnp.asarray(ps), 64)
    got, _ = _filtered_draft_stats(
        torch.from_numpy(logits), torch.from_numpy(draft).long(),
        torch.Generator().manual_seed(0), torch.from_numpy(temps),
        torch.from_numpy(ks), torch.from_numpy(ps), 64)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=0,
                               atol=P_DRAFT_TOL)


def _pi(row, temp, top_k, top_p, max_top_k=64):
    """The filtered distribution ``sample`` draws from, in float64."""
    scaled = row.astype(np.float64) / temp
    if top_k == 0 and top_p >= 1.0:
        p = np.exp(scaled - scaled.max())
        return p / p.sum()
    order = np.argsort(-scaled)[:max_top_k]
    k_eff = max_top_k if top_k <= 0 else min(top_k, max_top_k)
    vals = scaled[order]
    probs = np.exp(vals - vals.max())
    probs[k_eff:] = 0
    probs /= probs.sum()
    keep = (np.cumsum(probs) - probs) < top_p
    keep[k_eff:] = False
    keep[0] = True
    out = np.zeros_like(scaled)
    w = np.exp(vals[keep] - vals[keep].max())
    out[order[keep]] = w / w.sum()
    return out


@pytest.mark.parametrize("top_k,top_p", [(0, 1.0), (6, 1.0), (0, 0.9)])
def test_verify_temperature_rows_match_pi_in_distribution(top_k, top_p):
    """One verify call over n identical rows: the accept rate of a
    mid-probability draft within 4 sigma of pi(draft), and the residuals
    of the rejected rows within 4 sigma of pi with the draft taken out,
    token by token."""
    n, vocab, temp = 20000, 16, 0.8
    row = np.random.default_rng(4).normal(size=vocab).astype(np.float32)
    pi = _pi(row, temp, top_k, top_p)
    draft = int(np.argsort(pi)[-2])
    logits = np.broadcast_to(row, (n, 2, vocab)).copy()
    drafts = np.full((n, 1), draft, np.int32)
    accept, resid, _ = _torch_verify(
        logits, drafts, np.full(n, temp, np.float32),
        np.full(n, top_k, np.int32), np.full(n, top_p, np.float32), seed=5)
    p = pi[draft]
    rate = accept[:, 0].mean()
    assert abs(rate - p) < 4 * np.sqrt(p * (1 - p) / n), (rate, p)
    rejected = resid[~accept[:, 0], 0]
    m = len(rejected)
    assert draft not in set(rejected.tolist())
    want = pi.copy()
    want[draft] = 0
    want /= want.sum()
    got = np.bincount(rejected, minlength=vocab) / m
    sigma = np.sqrt(want * (1 - want) / m)
    assert (np.abs(got - want) <= 4 * sigma + 1e-12).all(), (got, want)


# ---------------------------------------------------------------------------
# The engine
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def weights():
    jcfg = jax_get_config("debug", dtype="float32")
    jparams = jax_init_params(jcfg, jax.random.key(0))
    tcfg = get_config("debug", dtype="float32")
    tparams = bridge.from_jax_numpy(tcfg, jax.tree.map(np.asarray, jparams))
    return jcfg, jparams, tcfg, tparams


def _greedy(cls, prompts, max_tokens=12, **kw):
    return [cls(prompt_tokens=list(p), max_tokens=max_tokens,
                temperature=0.0, **kw) for p in prompts]


def _run(eng, reqs, max_steps=800):
    for r in reqs:
        eng.submit(r)
    for _ in range(max_steps):
        eng.step()
        if all(r.finished for r in reqs):
            return reqs
    raise AssertionError("requests did not finish")


PARITY_PROMPTS = [REP_PROMPT, RND_PROMPT, [9, 3, 9, 3, 9, 3, 1, 2, 9, 3]]


@pytest.fixture(scope="module")
def jax_spec_run(weights):
    jcfg, jparams, _, _ = weights
    eng = JaxEngine(jcfg, jparams, max_slots=4, max_seq_len=MAX_SEQ,
                    speculative="ngram", draft_tokens=4)
    reqs = _run(eng, _greedy(JaxRequest, PARITY_PROMPTS, max_tokens=20))
    return ([r.output_tokens for r in reqs],
            (eng.spec_drafted, eng.spec_accepted, eng.spec_verify_steps))


def test_greedy_speculation_equals_jax_and_off(weights, jax_spec_run):
    _, _, tcfg, tparams = weights
    jax_out, jax_counts = jax_spec_run
    on = InferenceEngine(tcfg, tparams, max_slots=4, max_seq_len=MAX_SEQ,
                         speculative="ngram", draft_tokens=4)
    got = [r.output_tokens for r in _run(
        on, _greedy(Request, PARITY_PROMPTS, max_tokens=20))]
    off = InferenceEngine(tcfg, tparams, max_slots=4, max_seq_len=MAX_SEQ)
    plain = [r.output_tokens for r in _run(
        off, _greedy(Request, PARITY_PROMPTS, max_tokens=20))]
    assert got == jax_out
    assert got == plain
    assert (on.spec_drafted, on.spec_accepted,
            on.spec_verify_steps) == jax_counts
    assert on.spec_drafted > 0 and on.spec_accepted > 0
    assert off.spec_drafted == off.spec_verify_steps == 0
    stats = on.spec_stats()
    assert stats["drafted_total"] == on.spec_drafted
    assert stats["verify_steps"] == on.spec_verify_steps
    buckets = stats["tokens_per_sec_by_accept_rate"]
    assert set(buckets) == {"0-25%", "25-50%", "50-75%", "75-100%"}
    assert off.spec_stats() == {"mode": "off"}


class _OracleEngine(InferenceEngine):
    """The real verify path with controlled drafts: each request carries
    its future (the recorded output without speculation) and the index
    from which its drafts go wrong; a wrong token always differs from the
    truth, so accept lengths are known in advance."""

    def _draft_for(self, slot, max_tokens):
        req = self.slot_req[slot]
        done = len(req.output_tokens)
        out = []
        for j, t in enumerate(req._oracle[done:done + max_tokens]):
            wrong = req._wrong_at is not None and done + j >= req._wrong_at
            out.append((int(t) + 1) % self.cfg.vocab_size if wrong
                       else int(t))
        return out


def _truth(weights, prompts, max_tokens=12, **kw):
    _, _, tcfg, tparams = weights
    off = InferenceEngine(tcfg, tparams, max_slots=4, max_seq_len=MAX_SEQ)
    return [r.output_tokens for r in _run(
        off, _greedy(Request, prompts, max_tokens=max_tokens, **kw))]


def _oracle(weights, **kw):
    _, _, tcfg, tparams = weights
    return _OracleEngine(tcfg, tparams, max_seq_len=MAX_SEQ,
                         speculative="ngram", draft_tokens=4, **kw)


def test_variable_accept_lengths_in_one_batch(weights):
    prompts = [REP_PROMPT, RND_PROMPT, RND_PROMPT[::-1]]
    truth = _truth(weights, prompts)
    on = _oracle(weights, max_slots=4, prefill_budget=256)
    reqs = _greedy(Request, prompts)
    # Perfect drafts; right once then wrong; wrong at once: three accept
    # lengths in one verify forward.
    for r, t, wrong in zip(reqs, truth, (None, 2, 0)):
        r._oracle, r._wrong_at = t, wrong
    for r in reqs:
        on.submit(r)
    on.step()
    # The prefill's token, then accepted + 1.
    assert [len(r.output_tokens) for r in reqs] == [6, 3, 2]
    while not all(r.finished for r in reqs):
        on.step()
    assert [r.output_tokens for r in reqs] == truth
    assert 0 < on.spec_accepted < on.spec_drafted


def test_draftless_slots_ride_the_verify_batch(weights):
    truth = _truth(weights, [REP_PROMPT, RND_PROMPT])
    on = _oracle(weights, max_slots=4)
    reqs = _greedy(Request, [REP_PROMPT, RND_PROMPT])
    reqs[0]._oracle, reqs[0]._wrong_at = truth[0], None
    reqs[1]._oracle, reqs[1]._wrong_at = [], None
    for r in reqs:
        on.submit(r)
    on.step()
    assert on.spec_verify_steps == 1
    assert [len(r.output_tokens) for r in reqs] == [6, 2]
    while not all(r.finished for r in reqs):
        on.step()
    assert [r.output_tokens for r in reqs] == truth


def test_all_draftless_step_falls_back_to_the_decode_chunk(weights):
    truth = _truth(weights, [RND_PROMPT])
    on = _oracle(weights, max_slots=2, decode_chunk=4)
    reqs = _greedy(Request, [RND_PROMPT])
    reqs[0]._oracle, reqs[0]._wrong_at = [], None
    _run(on, reqs)
    assert on.spec_verify_steps == 0 and on.spec_drafted == 0
    # 1 prefill token, then chunks of 4: 11 tokens in 3 steps.
    assert on.steps == 3
    assert reqs[0].output_tokens == truth[0]


@pytest.mark.parametrize("case", ["budget", "room"])
def test_draft_caps_respect_budget_and_room(weights, case):
    if case == "budget":
        # After the prefill token 2 remain: a 1-token draft at most.
        prompts, max_tokens = [REP_PROMPT], 3
    else:
        # 61 prompt tokens in a 64-token window: the verify forward may
        # write positions up to 62, so the room caps the draft.
        prompts, max_tokens = [(REP_PROMPT * 3)[:61]], 12
    truth = _truth(weights, prompts, max_tokens=max_tokens)
    on = _oracle(weights, max_slots=2)
    drafted = []
    draft_for = on._draft_for

    def spy(slot, cap):
        drafted.append((int(on.lengths[slot]), cap))
        return draft_for(slot, cap)

    on._draft_for = spy
    reqs = _greedy(Request, prompts, max_tokens=max_tokens)
    reqs[0]._oracle, reqs[0]._wrong_at = truth[0], None
    _run(on, reqs)
    assert reqs[0].output_tokens == truth[0]
    if case == "budget":
        assert drafted == [(22, 1)]
        assert len(reqs[0].output_tokens) == 3
        assert reqs[0].finish_reason == "length"
    else:
        assert all(cap == min(4, MAX_SEQ - 1 - length)
                   for length, cap in drafted)
        assert drafted[0] == (61, 2)
        # Out of room: the prefill token and one per free position.
        assert len(reqs[0].output_tokens) == 1 + MAX_SEQ - 61


def test_eos_inside_an_accepted_draft(weights):
    probe = _truth(weights, [REP_PROMPT], max_tokens=12)[0]
    # An EOS whose first occurrence is at index >= 2, so the request is
    # still decoding when the draft carrying it is verified.
    eos = next(t for i, t in enumerate(probe)
               if i >= 2 and t not in probe[:i])
    stop_at = probe.index(eos) + 1
    off = _truth(weights, [REP_PROMPT], max_tokens=12, eos_id=eos)[0]
    assert off == probe[:stop_at]
    on = _oracle(weights, max_slots=2)
    reqs = _greedy(Request, [REP_PROMPT], max_tokens=12, eos_id=eos)
    reqs[0]._oracle, reqs[0]._wrong_at = probe, None
    _run(on, reqs)
    assert reqs[0].output_tokens == off
    assert reqs[0].finish_reason == "stop"
    assert on.spec_accepted > 0


def test_warmup_runs_the_verify_forward_at_every_view(weights):
    _, _, tcfg, tparams = weights
    eng = InferenceEngine(tcfg, tparams, max_slots=2, max_seq_len=MAX_SEQ,
                          speculative="ngram")
    eng.warmup()
    assert sorted(eng._verify_fns) == eng.view_buckets
    assert not eng.active.any() and eng.spec_verify_steps == 0


def test_speculation_settings_are_validated(weights):
    _, _, tcfg, tparams = weights
    assert SPECULATIVE_MODES == ("off", "ngram")
    assert check_speculative("ngram") == "ngram"
    assert backend_tuning(torch.device("cpu"))["draft_tokens"] == 4
    with pytest.raises(ValueError, match="speculative"):
        InferenceEngine(tcfg, tparams, max_slots=2, speculative="medusa")
    with pytest.raises(ValueError, match="draft_tokens"):
        InferenceEngine(tcfg, tparams, max_slots=2, speculative="ngram",
                        draft_tokens=0)
    with pytest.raises(ValueError, match="ngram"):
        InferenceEngine(tcfg, tparams, max_slots=2, speculative="ngram",
                        ngram_max=1, ngram_min=2)
    # None follows the config.
    import dataclasses

    cfg_on = dataclasses.replace(tcfg, speculative="ngram", draft_tokens=2)
    eng = InferenceEngine(cfg_on, tparams, max_slots=2)
    assert eng.speculative == "ngram" and eng.draft_tokens == 2
    assert eng._spec_index is not None
