"""The non-Llama dense families (Falcon, OPT, GPT-2, Gemma) through the
port's forward, against the JAX package's.

Each family runs at debug width (2 layers, hidden 128, 4 query heads of
32, vocab 512, 64 positions) from its own registry entry, so the name and
every structural feature stay the family's: falcon-7b-like (multi-query,
one shared layernorm, parallel block, gelu, tied head), falcon-40b-like
(2 kv heads, ln_attn / ln_mlp), opt-125m-like and gpt2-like (learned
positions, biases everywhere, relu / gelu MLP, tied head), gemma-2b-like
(one kv head) and gemma-7b-like (MHA; both with the embedding scaled by
sqrt(hidden), GeGLU, tied head), and one gemma case at head_dim 256, the
width K1-K3 take for gemma (hidden 512, 2 query heads on 1 kv head). The
reference's
``init_params`` weights cross through numpy by ``models/bridge.py``, with
the biases and norm parameters (zeros and ones at init) replaced by seeded
noise so that they count. Both sides compute in f32 (JAX matmuls at
"highest", tests/conftest.py): logits within 1e-4 absolute, as
tests/test_torch_model.py. The flash path runs the Pallas kernel in
interpret mode and the port's plain version of K1.
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
from runbooks_tpu.train.step import cross_entropy_loss as jax_ce

from runbooks_tpu_torch.models import bridge
from runbooks_tpu_torch.models.config import get_config
from runbooks_tpu_torch.models.transformer import (
    KVCache,
    check_supported,
    forward,
    head_weight,
    init_params,
    lm_head,
)
from runbooks_tpu_torch.train.step import (
    chunked_cross_entropy,
    cross_entropy_loss,
    make_ce_terms,
)

torch.set_num_threads(2)

LOGIT_ATOL = 1e-4
OP_ATOL = 1e-5

DEBUG_WIDTH = dict(vocab_size=512, hidden_size=128, intermediate_size=384,
                   num_layers=2, num_heads=4, head_dim=32, max_seq_len=64,
                   dtype="float32")
# One override set per family: its registry entry cut to debug width.
# FAMILIES also drive the serving, speculation, adapter and training files;
# gemma is held to the reference here, in
# tests/test_torch_families_serving.py and in
# tests/test_torch_families_training.py.
FAMILIES = {
    "falcon-7b": dict(num_kv_heads=1),
    "falcon-40b": dict(num_kv_heads=2),
    "opt-125m": dict(num_kv_heads=4),
    "gpt2": dict(num_kv_heads=4),
}
GEMMA = {
    "gemma-2b": dict(num_kv_heads=1),
    "gemma-7b": dict(num_kv_heads=4),
}
FORWARD_FAMILIES = sorted({**FAMILIES, **GEMMA})
# Gemma at its own head_dim (256), at the least width that holds it.
D256 = dict(hidden_size=512, intermediate_size=1024, num_heads=2,
            num_kv_heads=1, head_dim=256)
NOISY = ("scale", "bias", "bq", "bk", "bv", "bo", "bi")


def family_configs(name, **extra):
    """(JAX config, port config) of one family at debug width."""
    kw = {**DEBUG_WIDTH, **{**FAMILIES, **GEMMA}[name], **extra}
    return jax_get_config(name, **kw), get_config(name, **kw)


def family_params(jcfg, seed=0):
    """The reference's init_params as numpy, its biases and norm
    parameters replaced by seeded noise (scales around 1)."""
    tree = jax.tree.map(np.asarray, jax_init_params(jcfg, jax.random.key(
        seed)))
    rng = np.random.default_rng(seed + 100)

    def noisy(path, leaf):
        if path[-1].key not in NOISY:
            return leaf
        base = 1.0 if path[-1].key == "scale" else 0.0
        return (base + 0.1 * rng.standard_normal(leaf.shape)).astype(
            leaf.dtype)

    return jax.tree_util.tree_map_with_path(noisy, tree)


def carried(name, **extra):
    jcfg, tcfg = family_configs(name, **extra)
    np_params = family_params(jcfg)
    jparams = jax.tree.map(jnp.asarray, np_params)
    return jcfg, tcfg, jparams, bridge.from_jax_numpy(tcfg, np_params)


def _t(a):
    return torch.from_numpy(np.asarray(a).copy())


def _flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flat(v, f"{prefix}{k}."))
        else:
            out[prefix + k] = tuple(v.shape)
    return out


# ---------------------------------------------------------------------------
# Layout and refusals
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name", ["falcon-7b", "falcon-40b", "opt-125m",
                                  "opt-1.3b", "gpt2", "gpt2-xl", "gemma-2b",
                                  "gemma-7b", "mixtral-8x7b"])
def test_init_params_leaves_equal_the_references(name):
    """Full-size configs: the port's init on the meta device has exactly
    the reference's leaves and shapes (biases, plain MLP, positions, no
    head when tied, no ln2 under a shared-norm parallel block, mixtral's
    moe group in place of mlp)."""
    tcfg = get_config(name)
    check_supported(tcfg)
    got = _flat(init_params(tcfg, None, torch.device("meta")))
    want = _flat(jax.eval_shape(lambda: jax_init_params(
        jax_get_config(name), jax.random.key(0))))
    assert got == want
    assert got == bridge.expected_shapes(tcfg)
    assert ("head" in got) == (not tcfg.tie_embeddings)
    assert ("pos_embed" in got) == (tcfg.position_type == "learned")


@pytest.mark.parametrize("override,feature", [
    ({"qk_norm": True}, "qk_norm"),
    ({"logit_softcap": 30.0}, "logit_softcap"),
    ({"position_type": "alibi"}, "alibi")])
def test_each_unported_feature_is_named(override, feature):
    with pytest.raises(NotImplementedError, match=feature):
        check_supported(get_config("gpt2", **override))


# ---------------------------------------------------------------------------
# Forward
# ---------------------------------------------------------------------------

def packed_segments(b, s, rng):
    """Two or three documents per row and a padding tail (segment 0),
    positions restarting per document."""
    seg = np.zeros((b, s), np.int32)
    pos = np.zeros((b, s), np.int32)
    for r in range(b):
        at, sid = 0, 1
        while at < s - 4:
            n = int(rng.integers(5, 12))
            n = min(n, s - 4 - at)
            seg[r, at:at + n] = sid
            pos[r, at:at + n] = np.arange(n)
            at, sid = at + n, sid + 1
        pos[r, at:] = np.arange(s - at)
    return seg, pos


@pytest.mark.parametrize("impl", ["xla", "flash"])
@pytest.mark.parametrize("name", FORWARD_FAMILIES)
def test_forward_without_cache(name, impl):
    jcfg, tcfg, jparams, tparams = carried(name, attention_impl=impl)
    rng = np.random.default_rng(3)
    tokens = rng.integers(0, 512, (2, 24)).astype(np.int32)
    want, _ = jax_forward(jcfg, jparams, jnp.asarray(tokens))
    got, _ = forward(tcfg, tparams, _t(tokens))
    np.testing.assert_allclose(got.numpy(), np.asarray(want),
                               atol=LOGIT_ATOL, rtol=0)
    seg, pos = packed_segments(2, 24, rng)
    want, _ = jax_forward(jcfg, jparams, jnp.asarray(tokens),
                          positions=jnp.asarray(pos),
                          segment_ids=jnp.asarray(seg))
    got, _ = forward(tcfg, tparams, _t(tokens), positions=_t(pos),
                     segment_ids=_t(seg))
    real = seg > 0
    np.testing.assert_allclose(got.numpy()[real], np.asarray(want)[real],
                               atol=LOGIT_ATOL, rtol=0)


@pytest.mark.parametrize("name", FORWARD_FAMILIES)
def test_cached_prefill_with_padding_then_decode(name):
    """The engine's write mode with the engine's padding: rows of other
    lengths, padding parked at the trash slot max_seq_len (one past a
    learned table: the gather clamps, as the reference's), then two
    decode steps. Every row's logits, padding rows included, equal the
    reference's."""
    jcfg, tcfg, jparams, tparams = carried(name, attention_impl="flash")
    max_len, bucket = tcfg.max_seq_len, 16
    rng = np.random.default_rng(5)
    tokens = rng.integers(0, 512, (3, bucket)).astype(np.int32)
    pos = np.full((3, bucket), max_len, np.int32)
    pos[0, :16] = np.arange(16)
    pos[1, :9] = np.arange(9)
    pos[2, :3] = np.arange(3)
    jcache = JaxKVCache.create(jcfg, 3, max_len, trash_slot=True)
    tcache = KVCache.create(tcfg, 3, max_len, torch.device("cpu"),
                            trash_slot=True)
    want, jcache = jax_forward(jcfg, jparams, jnp.asarray(tokens),
                               positions=jnp.asarray(pos), cache=jcache)
    got, tcache = forward(tcfg, tparams, _t(tokens), positions=_t(pos),
                          cache=tcache)
    np.testing.assert_allclose(got.numpy(), np.asarray(want),
                               atol=LOGIT_ATOL, rtol=0)
    lengths = np.array([16, 9, 3], np.int32)
    for _ in range(2):
        step = rng.integers(0, 512, (3, 1)).astype(np.int32)
        dpos = lengths[:, None].copy()
        want, jcache = jax_forward(jcfg, jparams, jnp.asarray(step),
                                   positions=jnp.asarray(dpos),
                                   cache=jcache, cache_view=32)
        got, tcache = forward(tcfg, tparams, _t(step), positions=_t(dpos),
                              cache=tcache, cache_view=32)
        np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                   atol=LOGIT_ATOL, rtol=0)
        lengths += 1
    np.testing.assert_allclose(tcache.k.numpy(), np.asarray(jcache.k),
                               atol=OP_ATOL, rtol=0)


@pytest.mark.parametrize("impl", ["xla", "flash"])
def test_gemma_at_head_dim_256(impl):
    """Gemma at its own head_dim: the no-cache forward (under "flash" the
    Pallas kernel in interpret mode against the port's plain K1) and a
    cached prefill of an engine bucket with padding at the trash slot
    (under "flash" through K1's plain version on the port's side), logits
    within LOGIT_ATOL."""
    jcfg, tcfg, jparams, tparams = carried("gemma-2b", attention_impl=impl,
                                           **D256)
    assert tcfg.head_dim == 256 and tcfg.embed_scale
    rng = np.random.default_rng(13)
    tokens = rng.integers(0, 512, (2, 20)).astype(np.int32)
    want, _ = jax_forward(jcfg, jparams, jnp.asarray(tokens))
    got, _ = forward(tcfg, tparams, _t(tokens))
    np.testing.assert_allclose(got.numpy(), np.asarray(want),
                               atol=LOGIT_ATOL, rtol=0)
    pos = np.full((2, 16), tcfg.max_seq_len, np.int32)
    pos[0, :16] = np.arange(16)
    pos[1, :7] = np.arange(7)
    jcache = JaxKVCache.create(jcfg, 2, tcfg.max_seq_len, trash_slot=True)
    tcache = KVCache.create(tcfg, 2, tcfg.max_seq_len, torch.device("cpu"),
                            trash_slot=True)
    want, _ = jax_forward(jcfg, jparams, jnp.asarray(tokens[:, :16]),
                          positions=jnp.asarray(pos), cache=jcache)
    got, _ = forward(tcfg, tparams, _t(tokens[:, :16]), positions=_t(pos),
                     cache=tcache)
    np.testing.assert_allclose(got.numpy(), np.asarray(want),
                               atol=LOGIT_ATOL, rtol=0)


@pytest.mark.parametrize("name", ["opt-125m", "gpt2"])
def test_learned_positions_clamp_past_the_table(name):
    """A position at or past the table reads its last row (the
    reference's clamped gather), and never raises."""
    jcfg, tcfg, jparams, tparams = carried(name)
    tokens = np.array([[5, 6, 7]], np.int32)
    pos = np.array([[62, 63, 64]], np.int32)
    past = np.array([[62, 63, 1000]], np.int32)
    x, _ = forward(tcfg, tparams, _t(tokens), positions=_t(pos),
                   return_activations=True)
    y, _ = forward(tcfg, tparams, _t(tokens), positions=_t(past),
                   return_activations=True)
    assert torch.equal(x, y)
    want, _ = jax_forward(jcfg, jparams, jnp.asarray(tokens),
                          positions=jnp.asarray(past))
    np.testing.assert_allclose(lm_head(tcfg, tparams, y).numpy(),
                               np.asarray(want), atol=LOGIT_ATOL, rtol=0)


# ---------------------------------------------------------------------------
# The tied head in the loss
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name", FORWARD_FAMILIES)
def test_tied_head_chunked_ce_equals_dense(name):
    """The chunked loss over a tied head (embed.T) equals the dense loss
    over full logits, in value and in the full fine-tune's gradient of
    every leaf (the embedding's gets both the input and the head share);
    the dense loss equals the reference's."""
    jcfg, tcfg, jparams, tparams = carried(name)
    assert "head" not in tparams and tcfg.tie_embeddings
    rng = np.random.default_rng(9)
    tokens = rng.integers(0, 512, (2, 20)).astype(np.int32)
    targets = rng.integers(0, 512, (2, 20)).astype(np.int32)
    mask = (rng.random((2, 20)) > 0.2).astype(np.float32)
    batch = {"tokens": _t(tokens), "targets": _t(targets),
             "loss_mask": _t(mask)}

    def loss_grads(chunk):
        leaves = {k: v for k, v in _named(tparams).items()}
        for t in leaves.values():
            t.requires_grad_(True)
        loss, _ = make_ce_terms(tcfg, remat=False, loss_chunk=chunk)(
            tparams, batch)
        grads = torch.autograd.grad(loss, list(leaves.values()))
        for t in leaves.values():
            t.requires_grad_(False)
        return loss.item(), dict(zip(leaves, grads))

    dense_loss, dense = loss_grads(0)
    chunk_loss, chunked = loss_grads(8)
    np.testing.assert_allclose(chunk_loss, dense_loss, rtol=OP_ATOL)
    for k, g in dense.items():
        np.testing.assert_allclose(chunked[k].numpy(), g.numpy(),
                                   atol=OP_ATOL, rtol=0, err_msg=k)
    assert dense["embed"].abs().sum() > 0
    logits, _ = jax_forward(jcfg, jparams, jnp.asarray(tokens))
    want, _ = jax_ce(logits, jnp.asarray(targets), jnp.asarray(mask))
    np.testing.assert_allclose(dense_loss, float(want), rtol=OP_ATOL)
    # head_weight is a view of the embedding, not a copy.
    assert head_weight(tcfg, tparams).data_ptr() == \
        tparams["embed"].data_ptr()


def _named(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_named(v, f"{prefix}{k}."))
        else:
            out[prefix + k] = v
    return out


def test_chunked_ce_helper_takes_the_transposed_embedding():
    """chunked_cross_entropy over embed.T equals cross_entropy_loss over
    acts @ embed.T, and its gradient reaches the embedding."""
    rng = np.random.default_rng(11)
    acts = _t(rng.standard_normal((2, 10, 16)).astype(np.float32))
    embed = _t(rng.standard_normal((40, 16)).astype(np.float32))
    embed.requires_grad_(True)
    targets = _t(rng.integers(0, 40, (2, 10)))
    loss, _ = chunked_cross_entropy(acts, embed.T, targets, chunk_size=4,
                                    compute_dtype=torch.float32)
    (g,) = torch.autograd.grad(loss, embed)
    dense, _ = cross_entropy_loss(acts @ embed.T, targets)
    (gd,) = torch.autograd.grad(dense, embed)
    np.testing.assert_allclose(loss.item(), dense.item(), rtol=OP_ATOL)
    np.testing.assert_allclose(g.numpy(), gd.numpy(), atol=OP_ATOL)


def test_parallel_block_variants_differ_only_in_ln2():
    """falcon-40b's split norms with ln2 set equal to ln1 compute what
    falcon-7b's shared norm does."""
    _, t40, _, p40 = carried("falcon-40b")
    t7 = dataclasses.replace(t40, shared_layer_norm=True)
    p7 = {**p40, "layers": {k: v for k, v in p40["layers"].items()
                            if k != "ln2"}}
    p40 = {**p40, "layers": {**p40["layers"],
                             "ln2": dict(p40["layers"]["ln1"])}}
    tokens = _t(np.arange(12, dtype=np.int32)[None])
    a, _ = forward(t40, p40, tokens)
    b, _ = forward(t7, p7, tokens)
    assert torch.equal(a, b)
