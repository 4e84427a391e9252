"""The adapter pool and int8 serving on the non-Llama dense families,
against the JAX package's engines.

tests/test_torch_families_serving.py's worlds (debug width, noisy
weights, engines at the config's 64 positions). A pooled adapter on the
attention and the plain MLP (``mlp.wi``, ``mlp.wo``) beside base-only
rows must give the JAX pooled engine's greedy ids, the folded weights'
for its rows and the base's for the others; int8 weights with an int8
cache (the reference's quantized tree, block 32) the JAX engine's.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from runbooks_tpu.ops import quantization as jq
from runbooks_tpu.serve import lora_pool as jax_lora_pool
from runbooks_tpu.serve.engine import InferenceEngine as JaxEngine
from runbooks_tpu.serve.engine import Request as JaxRequest

from runbooks_tpu_torch.models import bridge
from runbooks_tpu_torch.ops.lora import target_dims
from runbooks_tpu_torch.serve import lora_pool
from runbooks_tpu_torch.serve.engine import InferenceEngine, Request
from tests.test_torch_families_forward import FAMILIES
from tests.test_torch_families_serving import (
    MAX_SEQ,
    PROMPTS,
    _drain,
    _reqs,
    make_world,
)

torch.set_num_threads(2)


@pytest.fixture(scope="module", params=sorted(FAMILIES))
def world(request):
    return make_world(request.param)


TARGETS = ("attn.wq", "attn.wv", "mlp.wi", "mlp.wo")


def test_pooled_plain_mlp_adapter_matches_jax_and_fold(world, tmp_path):
    tcfg = dataclasses.replace(world["tcfg"], adapter_pool=2, lora_rank=4,
                               lora_targets=TARGETS)
    jcfg = dataclasses.replace(world["jcfg"], adapter_pool=2, lora_rank=4,
                               lora_targets=TARGETS)
    rng = np.random.default_rng(4)
    tree = {}
    for t in TARGETS:
        d_in, d_out = target_dims(tcfg, t)
        tree[t] = {"a": (rng.standard_normal((2, d_in, 4))
                         * d_in ** -0.5).astype(np.float32),
                   "b": (0.05 * rng.standard_normal((2, 4, d_out))).astype(
                       np.float32)}
    jpath, tpath = str(tmp_path / "jax"), str(tmp_path / "torch")
    jax_lora_pool.save_adapter(
        jpath, {t: {k: jnp.asarray(v) for k, v in ab.items()}
                for t, ab in tree.items()}, rank=4, alpha=8.0)
    lora_pool.save_adapter(
        tpath, {t: {k: torch.from_numpy(v) for k, v in ab.items()}
                for t, ab in tree.items()}, rank=4, alpha=8.0)
    lanes = [tpath, None, tpath, None]
    jlanes = [jpath if a else None for a in lanes]
    reqs = [Request(prompt_tokens=list(p), max_tokens=6, adapter=a)
            for p, a in zip(PROMPTS[:4], lanes)]
    got = _drain(InferenceEngine(tcfg, world["tparams"], max_slots=4,
                                 max_seq_len=MAX_SEQ), reqs)
    jreqs = [JaxRequest(prompt_tokens=list(p), max_tokens=6, adapter=a)
             for p, a in zip(PROMPTS[:4], jlanes)]
    want = _drain(JaxEngine(jcfg, world["jparams"], max_slots=4,
                            max_seq_len=MAX_SEQ), jreqs)
    assert got == want
    folded = lora_pool.load_merge_adapter(tpath, world["tcfg"],
                                          world["tparams"])
    fold_ids = _drain(InferenceEngine(world["tcfg"], folded, max_slots=2,
                                      max_seq_len=MAX_SEQ),
                      [Request(prompt_tokens=list(PROMPTS[i]), max_tokens=6)
                       for i in (0, 2)])
    assert [got[0], got[2]] == fold_ids
    base = _drain(InferenceEngine(world["tcfg"], world["tparams"],
                                  max_slots=2, max_seq_len=MAX_SEQ),
                  [Request(prompt_tokens=list(PROMPTS[i]), max_tokens=6)
                   for i in (1, 3)])
    assert [got[1], got[3]] == base


@pytest.mark.parametrize("name", ["falcon-7b", "opt-125m"])
def test_int8_weights_and_cache_match_jax(name):
    """One parallel-block and one sequential family."""
    world = make_world(name)
    jp = jq.quantize_params(jax.tree.map(lambda x: x, world["jparams"]),
                            "int8", block_size=32)
    jcfg = dataclasses.replace(world["jcfg"], quantize="int8")
    tcfg = dataclasses.replace(world["tcfg"], quantize="int8")
    tp = bridge.from_jax_numpy(tcfg, jax.tree.map(np.asarray, jp))
    want = _drain(JaxEngine(jcfg, jp, max_slots=4, max_seq_len=MAX_SEQ),
                  _reqs(JaxRequest))
    eng = InferenceEngine(tcfg, tp, max_slots=4, max_seq_len=MAX_SEQ)
    assert eng.cache.quantized
    assert _drain(eng, _reqs(Request)) == want
