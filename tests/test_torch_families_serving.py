"""Serving the non-Llama dense families (Falcon, OPT, GPT-2, Gemma): the
port's engines against the JAX package's.

Each family at debug width (tests/test_torch_families_forward.py's
configs and noisy weights) behind the engines with ``max_seq_len`` the
config's 64 positions, so prefill padding is parked at slot 64, one past
OPT's and GPT-2's learned-position tables (the clamped gather), and one
prompt runs out of room at the table's end. Greedy ids must equal the
JAX engine's exactly; the paged engine's (pages of 8; at kv heads 1 for
falcon-7b) the dense engine's. Speculation on these families is in
tests/test_torch_families_speculative.py, the adapter pool and int8
serving in tests/test_torch_families_adapters.py.
"""

import jax
import jax.numpy as jnp
import pytest
import torch

from runbooks_tpu.serve.engine import InferenceEngine as JaxEngine
from runbooks_tpu.serve.engine import Request as JaxRequest

from runbooks_tpu_torch.models import bridge
from runbooks_tpu_torch.serve.engine import InferenceEngine, Request
from runbooks_tpu_torch.serve.paging import PagedInferenceEngine
from tests.test_torch_families_forward import (
    FAMILIES,
    family_configs,
    family_params,
)

torch.set_num_threads(2)

MAX_SEQ = 64
PROMPTS = [[5, 9, 17], list(range(1, 21)), [7, 300, 2, 2, 9, 41, 5],
           list(range(100, 158))]
MAX_TOKENS = [8, 8, 12, 20]     # the 58-token prompt runs out of room


def make_world(name):
    jcfg, tcfg = family_configs(name, attention_impl="flash")
    np_params = family_params(jcfg)
    return dict(name=name, jcfg=jcfg, tcfg=tcfg, np_params=np_params,
                jparams=jax.tree.map(jnp.asarray, np_params),
                tparams=bridge.from_jax_numpy(tcfg, np_params))


# Gemma-2b-like (one kv head, the scaled embedding, the norms' scales)
# beside the other families.
@pytest.fixture(scope="module", params=sorted(FAMILIES) + ["gemma-2b"])
def world(request):
    return make_world(request.param)


def _reqs(cls, **kw):
    return [cls(prompt_tokens=list(p), max_tokens=m, temperature=0.0, **kw)
            for p, m in zip(PROMPTS, MAX_TOKENS)]


def _drain(eng, reqs):
    for r in reqs:
        eng.submit(r)
    while eng.has_work():
        eng.step()
    return [list(r.output_tokens) for r in reqs]


def test_dense_engine_matches_jax_engine(world):
    jeng = JaxEngine(world["jcfg"], world["jparams"], max_slots=4,
                     max_seq_len=MAX_SEQ, decode_chunk=4)
    want = _drain(jeng, _reqs(JaxRequest))
    eng = InferenceEngine(world["tcfg"], world["tparams"], max_slots=4,
                          max_seq_len=MAX_SEQ, decode_chunk=4)
    assert eng._pad_slot == MAX_SEQ == world["tcfg"].max_seq_len
    assert _drain(eng, _reqs(Request)) == want
    # The last prompt decoded up to the table's end.
    assert len(want[-1]) == 1 + MAX_SEQ - len(PROMPTS[-1])


def test_paged_engine_matches_dense(world):
    dense = _drain(InferenceEngine(world["tcfg"], world["tparams"],
                                   max_slots=4, max_seq_len=MAX_SEQ),
                   _reqs(Request))
    eng = PagedInferenceEngine(world["tcfg"], world["tparams"], max_slots=4,
                               max_seq_len=MAX_SEQ, page_size=8)
    # The pool [L, pages + 1, page, kv heads, d]: one kv head at 7b.
    assert tuple(eng.cache.k.shape) == (
        2, eng.num_pages + 1, 8, world["tcfg"].num_kv_heads,
        world["tcfg"].head_dim)
    assert _drain(eng, _reqs(Request)) == dense
    # A second round over the same prompts reuses their pages.
    again = _drain(eng, _reqs(Request))
    assert again == dense
    assert eng.kv_occupancy()["pages_reused_total"] > 0
