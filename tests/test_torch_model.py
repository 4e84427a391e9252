"""The port's ops, model forward and sampler against the JAX package.

Both sides get the same numpy inputs; the model runs on the ``debug``
config at float32 with the reference's own ``init_params`` weights carried
over by ``models/bridge.py``. JAX matmuls run at "highest" precision
(tests/conftest.py), so both sides compute in f32: logits within 1e-4
absolute, elementwise ops within 1e-5. The flash path runs the JAX Pallas
kernel in interpret mode and the port's plain version. Greedy sampling is
the argmax and must agree exactly; random sampling is held to the exact
filtered distribution by total variation, since the two RNGs differ.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from runbooks_tpu.models.config import get_config as jax_get_config
from runbooks_tpu.models.transformer import KVCache as JaxKVCache
from runbooks_tpu.models.transformer import forward as jax_forward
from runbooks_tpu.models.transformer import init_params as jax_init_params
from runbooks_tpu.ops import attention as jax_attn
from runbooks_tpu.ops import norms as jax_norms
from runbooks_tpu.ops import rotary as jax_rotary
from runbooks_tpu.ops.sampling import sample as jax_sample

from runbooks_tpu_torch.models import bridge
from runbooks_tpu_torch.models.config import get_config
from runbooks_tpu_torch.models.transformer import KVCache, forward
from runbooks_tpu_torch.ops import attention, norms, rotary
from runbooks_tpu_torch.ops.sampling import sample

torch.set_num_threads(2)

LOGIT_ATOL = 1e-4
OP_ATOL = 1e-5


def _t(a):
    return torch.from_numpy(np.asarray(a).copy())


# ---------------------------------------------------------------------------
# Elementwise ops and plain attention
# ---------------------------------------------------------------------------

def test_norms_match():
    rng = np.random.default_rng(0)
    x = rng.standard_normal((3, 5, 64), dtype=np.float32) * 3
    s = rng.standard_normal(64, dtype=np.float32)
    bias = rng.standard_normal(64, dtype=np.float32)
    np.testing.assert_allclose(
        norms.rms_norm(_t(x), _t(s)).numpy(),
        np.asarray(jax_norms.rms_norm(jnp.asarray(x), jnp.asarray(s))),
        atol=OP_ATOL, rtol=1e-5)
    np.testing.assert_allclose(
        norms.layer_norm(_t(x), _t(s), _t(bias)).numpy(),
        np.asarray(jax_norms.layer_norm(jnp.asarray(x), jnp.asarray(s),
                                        jnp.asarray(bias))),
        atol=OP_ATOL, rtol=1e-5)


def test_rope_matches():
    rng = np.random.default_rng(1)
    x = rng.standard_normal((2, 7, 3, 32), dtype=np.float32)
    pos = rng.integers(0, 5000, (2, 7)).astype(np.int32)
    got = rotary.apply_rope(_t(x), _t(pos), 500000.0).numpy()
    want = np.asarray(jax_rotary.apply_rope(jnp.asarray(x), jnp.asarray(pos),
                                            500000.0))
    # Angles reach ~5e3 rad: f32 argument rounding differs by ~5e-4.
    np.testing.assert_allclose(got, want, atol=2e-3, rtol=0)
    small = pos % 64
    np.testing.assert_allclose(
        rotary.apply_rope(_t(x), _t(small)).numpy(),
        np.asarray(jax_rotary.apply_rope(jnp.asarray(x),
                                         jnp.asarray(small))),
        atol=OP_ATOL, rtol=0)


def test_mask_alibi_repeat_and_attention_match():
    rng = np.random.default_rng(2)
    b, sq, sk, h, kvh, d = 2, 6, 9, 4, 2, 16
    q_pos = rng.integers(0, 9, (b, sq)).astype(np.int32)
    kv_pos = np.broadcast_to(np.arange(sk, dtype=np.int32), (b, sk)).copy()
    q_seg = rng.integers(0, 3, (b, sq)).astype(np.int32)
    kv_seg = rng.integers(0, 3, (b, sk)).astype(np.int32)
    tm = attention.make_attention_mask(_t(q_pos), _t(kv_pos), _t(q_seg),
                                       _t(kv_seg))
    jm = jax_attn.make_attention_mask(jnp.asarray(q_pos),
                                      jnp.asarray(kv_pos),
                                      jnp.asarray(q_seg),
                                      jnp.asarray(kv_seg))
    np.testing.assert_array_equal(tm.numpy(), np.asarray(jm))
    for n in (8, 12):
        np.testing.assert_allclose(attention.alibi_slopes(n).numpy(),
                                   np.asarray(jax_attn.alibi_slopes(n)),
                                   rtol=1e-6)
    k = rng.standard_normal((b, sk, kvh, d), dtype=np.float32)
    np.testing.assert_array_equal(
        attention.repeat_kv(_t(k), 2).numpy(),
        np.asarray(jax_attn.repeat_kv(jnp.asarray(k), 2)))
    q = rng.standard_normal((b, sq, h, d), dtype=np.float32)
    v = rng.standard_normal((b, sk, kvh, d), dtype=np.float32)
    got = attention.dot_product_attention(_t(q), _t(k), _t(v), mask=tm)
    want = jax_attn.dot_product_attention(jnp.asarray(q), jnp.asarray(k),
                                          jnp.asarray(v), mask=jm)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=OP_ATOL,
                               rtol=0)


# ---------------------------------------------------------------------------
# Model forward on the debug config
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def model():
    jcfg = jax_get_config("debug", dtype="float32")
    jparams = jax_init_params(jcfg, jax.random.key(0))
    tparams = bridge.from_jax_numpy(get_config("debug", dtype="float32"),
                                    jax.tree.map(np.asarray, jparams))
    return jcfg, jparams, tparams


def _cfgs(jcfg, impl):
    return (dataclasses.replace(jcfg, attention_impl=impl),
            get_config("debug", dtype="float32", attention_impl=impl))


def test_bridge_round_trip(model):
    _, jparams, tparams = model
    back = bridge.to_numpy(tparams)
    for path, leaf in jax.tree_util.tree_leaves_with_path(jparams):
        keys = [p.key for p in path]
        node = back
        for k in keys:
            node = node[k]
        np.testing.assert_array_equal(node, np.asarray(leaf))
    with pytest.raises(ValueError):
        bridge.from_jax_numpy(get_config("debug", num_layers=3),
                              jax.tree.map(np.asarray, jparams))


@pytest.mark.parametrize("impl", ["xla", "flash"])
def test_forward_without_cache(model, impl):
    jcfg, jparams, tparams = model
    jc, tc = _cfgs(jcfg, impl)
    tokens = np.random.default_rng(3).integers(0, 512, (2, 24)).astype(
        np.int32)
    want, _ = jax_forward(jc, jparams, jnp.asarray(tokens))
    got, _ = forward(tc, tparams, _t(tokens))
    np.testing.assert_allclose(got.numpy(), np.asarray(want),
                               atol=LOGIT_ATOL, rtol=0)


@pytest.mark.parametrize("impl", ["xla", "flash"])
def test_forward_cache_scalar_index_mode(model, impl):
    """Prefill 20 tokens at index 0, then decode one token at index 20."""
    jcfg, jparams, tparams = model
    jc, tc = _cfgs(jcfg, impl)
    tokens = np.random.default_rng(4).integers(0, 512, (2, 21)).astype(
        np.int32)
    jcache = JaxKVCache.create(jc, 2, 48)
    tcache = KVCache.create(tc, 2, 48, torch.device("cpu"))
    for lo, hi in ((0, 20), (20, 21)):
        want, jcache = jax_forward(jc, jparams,
                                   jnp.asarray(tokens[:, lo:hi]),
                                   cache=jcache)
        got, tcache = forward(tc, tparams, _t(tokens[:, lo:hi]),
                              cache=tcache)
        np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                   atol=LOGIT_ATOL, rtol=0)
    assert tcache.index == int(jcache.index) == 21
    np.testing.assert_allclose(tcache.k.numpy(), np.asarray(jcache.k),
                               atol=OP_ATOL, rtol=0)


@pytest.mark.parametrize("impl", ["xla", "flash"])
def test_forward_cache_position_scatter_and_view(model, impl):
    """The serving engine's write mode: rows of different lengths, padding
    parked at the trash slot, then a one-token decode through a cache
    view narrower than the cache."""
    jcfg, jparams, tparams = model
    jc, tc = _cfgs(jcfg, impl)
    max_len, bucket = 40, 16
    rng = np.random.default_rng(5)
    tokens = rng.integers(0, 512, (2, bucket)).astype(np.int32)
    pos = np.full((2, bucket), max_len, np.int32)
    pos[0, :16] = np.arange(16)
    pos[1, :9] = np.arange(9)
    jcache = JaxKVCache.create(jc, 2, max_len, trash_slot=True)
    tcache = KVCache.create(tc, 2, max_len, torch.device("cpu"),
                            trash_slot=True)
    want, jcache = jax_forward(jc, jparams, jnp.asarray(tokens),
                               positions=jnp.asarray(pos), cache=jcache)
    got, tcache = forward(tc, tparams, _t(tokens), positions=_t(pos),
                          cache=tcache)
    real = pos < max_len
    np.testing.assert_allclose(got.numpy()[real], np.asarray(want)[real],
                               atol=LOGIT_ATOL, rtol=0)
    step = rng.integers(0, 512, (2, 1)).astype(np.int32)
    dpos = np.array([[16], [9]], np.int32)
    want, jcache = jax_forward(jc, jparams, jnp.asarray(step),
                               positions=jnp.asarray(dpos), cache=jcache,
                               cache_view=32)
    got, tcache = forward(tc, tparams, _t(step), positions=_t(dpos),
                          cache=tcache, cache_view=32)
    np.testing.assert_allclose(got.numpy(), np.asarray(want),
                               atol=LOGIT_ATOL, rtol=0)
    np.testing.assert_allclose(tcache.k.numpy()[:, :, :max_len],
                               np.asarray(jcache.k)[:, :, :max_len],
                               atol=OP_ATOL, rtol=0)


def test_return_activations_feeds_the_head(model):
    from runbooks_tpu_torch.models.transformer import lm_head

    jcfg, _, tparams = model
    _, tc = _cfgs(jcfg, "xla")
    tokens = _t(np.arange(10, dtype=np.int32)[None])
    logits, _ = forward(tc, tparams, tokens)
    x, _ = forward(tc, tparams, tokens, return_activations=True)
    # Same f32 products, summed in another blocking order.
    torch.testing.assert_close(lm_head(tc, tparams, x[:, -1]),
                               logits[:, -1], atol=OP_ATOL, rtol=0)


def test_config_registry_matches_reference():
    from runbooks_tpu.models.config import CONFIGS as JAX_CONFIGS

    from runbooks_tpu_torch.models.config import CONFIGS

    assert sorted(CONFIGS) == sorted(JAX_CONFIGS)
    for name, cfg in CONFIGS.items():
        assert dataclasses.asdict(cfg) == dataclasses.asdict(
            JAX_CONFIGS[name]), name
        assert cfg.q_dim == JAX_CONFIGS[name].q_dim
        assert cfg.kv_dim == JAX_CONFIGS[name].kv_dim
    assert get_config("debug", dtype="float32").activation_dtype \
        == torch.float32


def test_unsupported_config_is_refused():
    # qk-norm is not ported yet (gemma's, gpt2's and mixtral's features
    # are).
    with pytest.raises(NotImplementedError, match="qk_norm"):
        forward(get_config("llama3-8b", qk_norm=True), {},
                torch.zeros((1, 1), dtype=torch.long))


# ---------------------------------------------------------------------------
# Sampling
# ---------------------------------------------------------------------------

def test_greedy_sample_is_exact():
    logits = np.random.default_rng(6).standard_normal(
        (5, 300)).astype(np.float32)
    zeros = np.zeros(5, np.float32)
    want = jax_sample(jnp.asarray(logits), jax.random.key(0),
                      jnp.asarray(zeros), jnp.zeros(5, jnp.int32),
                      jnp.ones(5, jnp.float32))
    got = sample(_t(logits), torch.Generator().manual_seed(0), _t(zeros),
                 torch.zeros(5, dtype=torch.int32), torch.ones(5))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def _filtered_probs(logits, temp, top_k, top_p, max_top_k=64):
    """The exact distribution sample() draws from, in numpy."""
    z = logits.astype(np.float64) / temp
    if top_k == 0 and top_p >= 1.0:
        p = np.exp(z - z.max())
        return p / p.sum()
    order = np.argsort(-z, kind="stable")[:max_top_k]
    lane = z[order]
    k_eff = len(lane) if top_k <= 0 else min(top_k, len(lane))
    keep = np.arange(len(lane)) < k_eff
    probs = np.where(keep, np.exp(lane - lane.max()), 0.0)
    probs /= probs.sum()
    keep &= (np.cumsum(probs) - probs) < top_p
    keep[0] = True
    out = np.zeros_like(z)
    w = np.where(keep, np.exp(lane - lane.max()), 0.0)
    out[order] = w / w.sum()
    return out


@pytest.mark.parametrize("temp,top_k,top_p", [
    (0.8, 0, 1.0),      # full vocabulary
    (1.0, 5, 1.0),      # top-k lane
    (0.7, 0, 0.9),      # top-p lane
])
def test_random_sample_matches_distribution(temp, top_k, top_p):
    n, vocab = 20000, 100
    row = (np.random.default_rng(7).standard_normal(vocab) * 2).astype(
        np.float32)
    logits = np.broadcast_to(row, (n, vocab)).copy()
    exact = _filtered_probs(row, temp, top_k, top_p)
    got = sample(_t(logits), torch.Generator().manual_seed(1),
                 torch.full((n,), temp), torch.full((n,), top_k,
                                                    dtype=torch.int32),
                 torch.full((n,), top_p)).numpy()
    want = np.asarray(jax_sample(
        jnp.asarray(logits), jax.random.key(1), jnp.full((n,), temp),
        jnp.full((n,), top_k, jnp.int32), jnp.full((n,), top_p)))
    for draws in (got, want):
        emp = np.bincount(draws, minlength=vocab) / n
        assert np.all(emp[exact == 0] == 0)
        # E[TV] over 100 cells at n=20000 is ~0.02; 0.04 leaves margin.
        assert 0.5 * np.abs(emp - exact).sum() < 0.04


def test_sample_respects_gmask():
    logits = torch.from_numpy(np.random.default_rng(8).standard_normal(
        (4, 50)).astype(np.float32))
    gmask = torch.zeros((4, 50), dtype=torch.bool)
    gmask[:, 7] = True
    got = sample(logits, torch.Generator().manual_seed(0),
                 torch.tensor([0.0, 1.0, 1.0, 0.5]),
                 torch.tensor([0, 3, 0, 0], dtype=torch.int32),
                 torch.tensor([1.0, 1.0, 0.5, 1.0]), gmask=gmask)
    assert got.tolist() == [7, 7, 7, 7]
