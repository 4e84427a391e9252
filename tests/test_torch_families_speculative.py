"""Speculative decoding on the non-Llama dense families, against the JAX
package's speculative engine.

tests/test_torch_families_serving.py's worlds (debug width, noisy
weights, the config's 64 positions): prompt-lookup drafts of 4 tokens
verified by one [B, K+1] forward through the biases, learned positions
and tied heads; greedy ids and the draft, accept and verify counters must
equal the reference's.
"""

import pytest
import torch

from runbooks_tpu.serve.engine import InferenceEngine as JaxEngine
from runbooks_tpu.serve.engine import Request as JaxRequest

from runbooks_tpu_torch.serve.engine import InferenceEngine, Request
from tests.test_torch_families_forward import FAMILIES
from tests.test_torch_families_serving import (
    MAX_SEQ,
    PROMPTS,
    _drain,
    make_world,
)

torch.set_num_threads(2)


@pytest.fixture(scope="module", params=sorted(FAMILIES))
def world(request):
    return make_world(request.param)


def test_speculative_verify_matches_jax(world):
    prompts = [[9, 3, 9, 3, 9, 3, 1, 2, 9, 3] * 2, PROMPTS[1]]

    def run(cls, req_cls, cfg, params):
        eng = cls(cfg, params, max_slots=2, max_seq_len=MAX_SEQ,
                  speculative="ngram", draft_tokens=4)
        reqs = [req_cls(prompt_tokens=list(p), max_tokens=16)
                for p in prompts]
        return _drain(eng, reqs), eng

    want, jeng = run(JaxEngine, JaxRequest, world["jcfg"], world["jparams"])
    got, eng = run(InferenceEngine, Request, world["tcfg"], world["tparams"])
    assert got == want
    assert (eng.spec_drafted, eng.spec_accepted, eng.spec_verify_steps) \
        == (jeng.spec_drafted, jeng.spec_accepted, jeng.spec_verify_steps)
    assert eng.spec_verify_steps > 0
