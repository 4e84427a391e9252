"""The port's weight-only quantization and int8 KV helpers
(``runbooks_tpu_torch/ops/quantization.py``) against the JAX package's
``runbooks_tpu.ops.quantization``, and the forward over quantized weights
and an int8 KV cache against the JAX forward.

- The op functions on the same numpy inputs: int8/int4 codes, scales,
  packed bytes and dequantized weights are EQUAL (both round half to
  even, both divide in f32); ``quantized_matmul`` within the reference
  test's rtol/atol 1e-5 in f32, chunked or not; ``quantize_kv`` equal.
- ``quantize_params`` structure and ``tree_weight_bytes`` equal to the
  reference's; the packed checkpoint through ``torch.save`` and
  ``restore_params`` (memory-mapped, weights_only) comes back bit-equal.
- The bridge carries the reference's QuantizedArray leaves both ways.
- ``forward`` on the ``debug`` config at f32 with the reference's weights
  quantized by the reference (bridged), int8 and int4: logits within
  LOGIT_ATOL of the JAX forward's, with no cache and through an int8 KV
  cache (prefill, then decode through a view).
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
from runbooks_tpu.ops import quantization as jq

from runbooks_tpu_torch.models import bridge
from runbooks_tpu_torch.models.config import get_config
from runbooks_tpu_torch.models.transformer import (
    KVCache,
    LoraDeltas,
    forward,
)
from runbooks_tpu_torch.ops import quantization as tq
from runbooks_tpu_torch.train.checkpoint import (
    CheckpointManager,
    restore_params,
)
from runbooks_tpu_torch.utils.tree import tree_leaves, tree_map

torch.set_num_threads(2)

MATMUL_TOL = 1e-5      # the reference test's rtol/atol for the f32 matmul
LOGIT_ATOL = 1e-4      # f32 forward, as tests/test_torch_model.py
BLOCK = 32             # < the debug config's widths: several blocks each


def _t(a):
    return torch.from_numpy(np.asarray(a).copy())


def _jax_numpy(tree):
    return jax.tree.map(np.asarray, tree)


# ---------------------------------------------------------------------------
# Op functions
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("bits", [8, 4])
@pytest.mark.parametrize("shape,block", [((64, 24), 16), ((3, 96, 40), 32),
                                         ((2, 60, 8), 128), ((50, 6), 7)])
def test_codes_and_scales_equal_reference(bits, shape, block):
    w = np.random.default_rng(0).standard_normal(shape).astype(np.float32)
    w[..., 3, :] = 0.0          # a zero row: a block with amax 0 somewhere
    want = jq.quantize(w, bits, block)
    got = tq.quantize(_t(w), bits, block)
    assert (got.bits, got.block_size, got.in_dim) == (
        want.bits, want.block_size, want.in_dim)
    assert got.values.dtype == (torch.int8 if bits == 8 else torch.uint8)
    np.testing.assert_array_equal(got.values.numpy(), np.asarray(want.values))
    np.testing.assert_array_equal(got.scales.numpy(), np.asarray(want.scales))
    np.testing.assert_array_equal(tq.dequantize(got).numpy(),
                                  np.asarray(jq.dequantize(want)))
    assert got.nbytes == want.nbytes
    assert got.shape == w.shape


def test_block_size_resolution_matches_reference():
    for in_dim in range(1, 80):
        for block in (1, 7, 16, 128):
            for bits in (8, 4):
                if bits == 4 and in_dim % 2:
                    with pytest.raises(ValueError, match="even"):
                        tq.resolve_block_size(in_dim, block, bits)
                    continue
                assert tq.resolve_block_size(in_dim, block, bits) == \
                    jq.resolve_block_size(in_dim, block, bits)
    with pytest.raises(ValueError, match="bits"):
        tq.quantize(torch.zeros(4, 4), bits=3)


def test_int4_pack_unpack_exact():
    q = np.random.default_rng(1).integers(-7, 8, (6, 32, 10)).astype(np.int8)
    packed = tq.pack_int4(_t(q))
    np.testing.assert_array_equal(packed.numpy(),
                                  np.asarray(jq.pack_int4(jnp.asarray(q))))
    np.testing.assert_array_equal(tq.unpack_int4(packed).numpy(), q)


def test_int8_roundtrip_exact_on_grid():
    """Weights on a power-of-two-scale int8 grid survive quantize then
    dequantize bit for bit (the reference test's case)."""
    rng = np.random.default_rng(1)
    nb, bs, out = 3, 16, 8
    q = rng.integers(-127, 128, (nb, bs, out)).astype(np.float32)
    q[:, 0, :] = 127.0
    scales = 2.0 ** rng.integers(-8, 2, (nb, 1, out)).astype(np.float32)
    w = (q * scales).reshape(nb * bs, out)
    np.testing.assert_array_equal(
        tq.dequantize(tq.quantize(_t(w), bits=8, block_size=bs)).numpy(), w)


def test_int4_error_bounded_by_half_step():
    w = np.random.default_rng(2).standard_normal((64, 16)).astype(np.float32)
    err = np.abs(tq.dequantize(tq.quantize(_t(w), 4, 16)).numpy() - w)
    amax = np.abs(w.reshape(4, 16, 16)).max(axis=1, keepdims=True)
    step = np.broadcast_to(amax / 7.0, (4, 16, 16)).reshape(64, 16)
    assert (err <= step / 2 + 1e-6).all()


@pytest.mark.parametrize("bits", [8, 4])
def test_quantized_matmul_matches_reference(bits, monkeypatch):
    rng = np.random.default_rng(3)
    w = rng.standard_normal((64, 24)).astype(np.float32)
    x = rng.standard_normal((2, 5, 64)).astype(np.float32)
    ref_qa = jq.quantize(w, bits, 16)
    want = np.asarray(jq.quantized_matmul(jnp.asarray(x), ref_qa,
                                          jnp.float32))
    qa = tq.quantize(_t(w), bits, 16)
    got = tq.quantized_matmul(_t(x), qa, torch.float32)
    assert got.dtype == torch.float32 and got.shape == (2, 5, 24)
    np.testing.assert_allclose(got.numpy(), want, rtol=MATMUL_TOL,
                               atol=MATMUL_TOL)
    np.testing.assert_allclose(
        got.numpy(), x @ tq.dequantize(qa).numpy(), rtol=MATMUL_TOL,
        atol=MATMUL_TOL)
    # Row chunks (3 rows of partials at a time) compute the same sums (a
    # GEMM of other row counts may order its f32 additions otherwise).
    monkeypatch.setattr(tq, "PARTIAL_BYTES", 3 * 4 * 24 * 4)
    np.testing.assert_allclose(
        tq.quantized_matmul(_t(x), qa, torch.float32).numpy(), got.numpy(),
        rtol=MATMUL_TOL, atol=MATMUL_TOL)
    # A bf16 compute dtype rounds x first, as the reference's cast does
    # (its bf16 product with f32 output does not run on JAX's CPU
    # backend, so the oracle is x rounded to bf16 times the weight).
    x16 = _t(x).to(torch.bfloat16).float().numpy()
    want16 = x16 @ tq.dequantize(qa).numpy()
    np.testing.assert_allclose(
        tq.quantized_matmul(_t(x), qa, torch.bfloat16).numpy(), want16,
        rtol=MATMUL_TOL, atol=MATMUL_TOL)
    with pytest.raises(ValueError, match="per-layer"):
        tq.quantized_matmul(_t(x), tq.quantize(_t(w[None]), bits, 16))


def test_quantize_kv_matches_reference():
    x = (np.random.default_rng(4).standard_normal((3, 4, 5, 16))
         * 3).astype(np.float32)
    x[0, 0, 0] = 0.0
    jv, js = jq.quantize_kv(jnp.asarray(x))
    tv, ts = tq.quantize_kv(_t(x))
    assert tv.dtype == torch.int8 and ts.dtype == torch.float32
    np.testing.assert_array_equal(tv.numpy(), np.asarray(jv))
    np.testing.assert_array_equal(ts.numpy(), np.asarray(js))
    for dtype, jdt in ((torch.float32, jnp.float32),
                       (torch.bfloat16, jnp.bfloat16)):
        got = tq.dequantize_kv(tv, ts, dtype)
        assert got.dtype == dtype
        np.testing.assert_array_equal(
            got.float().numpy(),
            np.asarray(jq.dequantize_kv(jv, js, jdt)).astype(np.float32))


def test_resolve_quantize_mode_matches_reference():
    cfg = get_config("debug")
    for params, c in (({}, None), ({"quantize": "int4"}, cfg),
                      ({}, dataclasses.replace(cfg, quantize="int8")),
                      ({"quantize": None}, cfg)):
        assert tq.resolve_quantize_mode(params, c) == \
            jq.resolve_quantize_mode(params, c)
    with pytest.raises(ValueError) as want:
        jq.resolve_quantize_mode({"quantize": "int3"})
    with pytest.raises(ValueError) as got:
        tq.resolve_quantize_mode({"quantize": "int3"})
    assert str(got.value) == str(want.value)
    assert tq.QUANTIZE_MODES == jq.QUANTIZE_MODES
    assert tq.QUANTIZABLE_KEYS == jq.QUANTIZABLE_KEYS


# ---------------------------------------------------------------------------
# Param trees, checkpoints and the bridge
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def model():
    jcfg = jax_get_config("debug", dtype="float32")
    jparams = jax_init_params(jcfg, jax.random.key(0))
    tcfg = get_config("debug", dtype="float32")
    return jcfg, jparams, tcfg, bridge.from_jax_numpy(tcfg,
                                                      _jax_numpy(jparams))


@pytest.mark.parametrize("mode", ["int8", "int4"])
def test_quantize_params_matches_reference(model, mode):
    _, jparams, _, tparams = model
    want = jq.quantize_params(jax.tree.map(lambda x: x, jparams), mode,
                              block_size=BLOCK)
    got = tq.quantize_params(tree_map(lambda t: t, tparams), mode,
                             block_size=BLOCK)
    assert tq.tree_quantize_mode(got) == jq.tree_quantize_mode(want) == mode
    assert tq.tree_quantize_mode(tparams) == "none"
    assert tq.tree_weight_bytes(got) == jq.tree_weight_bytes(want)
    assert tq.tree_weight_bytes(tparams) == jq.tree_weight_bytes(jparams)
    for group, keys in tq.QUANTIZABLE_KEYS.items():
        for key in keys:
            if key not in got["layers"][group]:
                continue
            g, w = got["layers"][group][key], want["layers"][group][key]
            assert isinstance(g, tq.QuantizedArray), (group, key)
            assert (g.bits, g.block_size) == (w.bits, w.block_size)
            np.testing.assert_array_equal(g.values.numpy(),
                                          np.asarray(w.values))
            np.testing.assert_array_equal(g.scales.numpy(),
                                          np.asarray(w.scales))
    for name in ("embed", "head"):
        assert isinstance(got[name], torch.Tensor)
    assert isinstance(got["layers"]["ln1"]["scale"], torch.Tensor)
    # The source tree's leaves are untouched (the copy took the packing).
    assert isinstance(tparams["layers"]["attn"]["wq"], torch.Tensor)
    with pytest.raises(ValueError, match="int3"):
        tq.quantize_params(tparams, "int3")
    assert tq.quantize_params(tparams, "none") is tparams


def test_quantized_array_indexes_layers_and_moves(model):
    tparams = model[3]
    qa = tq.quantize(tparams["layers"]["mlp"]["wo"], 4, BLOCK)
    layer = qa[1]
    assert layer.shape == tuple(tparams["layers"]["mlp"]["wo"].shape[1:])
    assert torch.equal(layer.values, qa.values[1])
    assert torch.equal(layer.scales, qa.scales[1])
    moved = qa.to(torch.device("cpu"), copy=True)
    assert moved.values.data_ptr() != qa.values.data_ptr()
    assert torch.equal(moved.values, qa.values)
    assert qa.numel() == tparams["layers"]["mlp"]["wo"].numel()
    with pytest.raises(IndexError):
        layer[0]


@pytest.mark.parametrize("mode", ["int8", "int4"])
def test_packed_checkpoint_round_trip(model, tmp_path, mode):
    """pack_for_checkpoint -> torch.save -> restore_params (memory-mapped,
    weights_only: plain dicts of tensors, no custom class) rebuilds every
    leaf bit for bit; the packed leaf is {"__quantized__": {values,
    scales, meta int32 [bits, block_size]}} as the reference's."""
    tparams = model[3]
    params = tq.quantize_params(tree_map(lambda t: t, tparams), mode,
                                block_size=BLOCK)
    packed = tq.pack_for_checkpoint(params)
    node = packed["layers"]["attn"]["wq"]
    assert set(node) == {"__quantized__"}
    inner = node["__quantized__"]
    assert inner["meta"].dtype == torch.int32
    assert inner["meta"].tolist() == [8 if mode == "int8" else 4, BLOCK]
    assert tq.unpack_from_checkpoint(tparams) == tparams
    CheckpointManager(str(tmp_path)).save(0, {"params": packed}, force=True)
    restored, step = restore_params(str(tmp_path), torch.device("cpu"))
    assert step == 0
    flat_a = list(tree_leaves(params))
    flat_b = list(tree_leaves(restored))
    assert len(flat_a) == len(flat_b)
    for a, b in zip(flat_a, flat_b):
        assert type(a) is type(b)
        if isinstance(a, tq.QuantizedArray):
            assert (a.bits, a.block_size) == (b.bits, b.block_size)
            assert torch.equal(a.values, b.values)
            assert torch.equal(a.scales, b.scales)
        else:
            assert torch.equal(a, b)


def test_bridge_carries_quantized_leaves(model):
    _, jparams, tcfg, _ = model
    want = jq.quantize_params(jax.tree.map(lambda x: x, jparams), "int4",
                              block_size=BLOCK)
    got = bridge.from_jax_numpy(tcfg, _jax_numpy(want))
    wq = got["layers"]["attn"]["wq"]
    assert isinstance(wq, tq.QuantizedArray) and wq.bits == 4
    assert wq.values.dtype == torch.uint8
    back = bridge.to_numpy(got)["layers"]["attn"]["wq"]
    assert isinstance(back, tq.QuantizedArray)
    assert isinstance(back.values, np.ndarray)
    np.testing.assert_array_equal(back.values,
                                  np.asarray(want["layers"]["attn"]["wq"]
                                             .values))
    np.testing.assert_array_equal(back.scales,
                                  np.asarray(want["layers"]["attn"]["wq"]
                                             .scales))
    bad = jax.tree.map(lambda x: x, want)
    bad["layers"]["attn"]["wq"] = jq.quantize(
        np.zeros((2, 64, 128), np.float32), 4, BLOCK)
    with pytest.raises(ValueError, match="does not match"):
        bridge.from_jax_numpy(tcfg, _jax_numpy(bad))


# ---------------------------------------------------------------------------
# The forward over quantized weights and an int8 KV cache
# ---------------------------------------------------------------------------

def _quantized_pair(model, mode):
    jcfg, jparams, tcfg, _ = model
    want = jq.quantize_params(jax.tree.map(lambda x: x, jparams), mode,
                              block_size=BLOCK)
    return (dataclasses.replace(jcfg, quantize=mode), want,
            dataclasses.replace(tcfg, quantize=mode),
            bridge.from_jax_numpy(tcfg, _jax_numpy(want)))


@pytest.mark.parametrize("mode", ["int8", "int4"])
@pytest.mark.parametrize("impl", ["xla", "flash"])
def test_forward_logits_match_jax(model, mode, impl):
    jc, jp, tc, tp = _quantized_pair(model, mode)
    jc = dataclasses.replace(jc, attention_impl=impl)
    tc = dataclasses.replace(tc, attention_impl=impl)
    tokens = np.random.default_rng(6).integers(0, 512, (2, 24)).astype(
        np.int32)
    want, _ = jax_forward(jc, jp, jnp.asarray(tokens))
    got, _ = forward(tc, tp, _t(tokens))
    np.testing.assert_allclose(got.numpy(), np.asarray(want),
                               atol=LOGIT_ATOL, rtol=0)


@pytest.mark.parametrize("mode", ["none", "int8"])
def test_forward_int8_kv_cache_matches_jax(model, mode):
    """The serving write mode on an int8 cache: a 16-token prefill with
    padding parked at the trash slot (K1's route, the plain version here),
    then a one-token decode through a view; logits within LOGIT_ATOL and
    the cache's codes and scales as the reference's."""
    jc, jp, tc, tp = (model if mode == "none" else _quantized_pair(model,
                                                                   mode))
    jc = dataclasses.replace(jc, attention_impl="flash")
    tc = dataclasses.replace(tc, attention_impl="flash")
    max_len, bucket = 40, 16
    rng = np.random.default_rng(7)
    tokens = rng.integers(0, 512, (2, bucket)).astype(np.int32)
    pos = np.full((2, bucket), max_len, np.int32)
    pos[0, :16] = np.arange(16)
    pos[1, :9] = np.arange(9)
    jcache = JaxKVCache.create(jc, 2, max_len, trash_slot=True,
                               quantize_kv=True)
    tcache = KVCache.create(tc, 2, max_len, torch.device("cpu"),
                            trash_slot=True, quantize_kv=True)
    assert tcache.quantized and tcache.k_scale.shape == tcache.k.shape[:-1]
    want, jcache = jax_forward(jc, jp, jnp.asarray(tokens),
                               positions=jnp.asarray(pos), cache=jcache)
    got, tcache = forward(tc, tp, _t(tokens), positions=_t(pos),
                          cache=tcache)
    real = pos < max_len
    np.testing.assert_allclose(got.numpy()[real], np.asarray(want)[real],
                               atol=LOGIT_ATOL, rtol=0)
    step = rng.integers(0, 512, (2, 1)).astype(np.int32)
    dpos = np.array([[16], [9]], np.int32)
    want, jcache = jax_forward(jc, jp, jnp.asarray(step),
                               positions=jnp.asarray(dpos), cache=jcache,
                               cache_view=32)
    got, tcache = forward(tc, tp, _t(step), positions=_t(dpos),
                          cache=tcache, cache_view=32)
    np.testing.assert_allclose(got.numpy(), np.asarray(want),
                               atol=LOGIT_ATOL, rtol=0)
    written = np.zeros(tcache.k.shape[:3], bool)
    written[:, 0, :17] = written[:, 1, :10] = True
    codes = tcache.k.numpy()[written].astype(np.int32)
    want_codes = np.asarray(jcache.k)[written].astype(np.int32)
    # Codes may differ by one where an f32 rounding difference in k
    # straddles a rounding boundary; almost all are equal.
    assert np.abs(codes - want_codes).max() <= 1
    assert (codes == want_codes).mean() > 0.999
    np.testing.assert_allclose(tcache.k_scale.numpy()[written],
                               np.asarray(jcache.k_scale)[written],
                               rtol=1e-5, atol=1e-7)
    assert tcache.nbytes == sum(
        t.numel() * t.element_size()
        for t in (tcache.k, tcache.v, tcache.k_scale, tcache.v_scale))


def test_append_mode_int8_cache_matches_jax(model):
    """The scalar-index (append) write mode on an int8 cache."""
    jc, jp, tc, tp = model
    tokens = np.random.default_rng(8).integers(0, 512, (2, 21)).astype(
        np.int32)
    jcache = JaxKVCache.create(jc, 2, 48, quantize_kv=True)
    tcache = KVCache.create(tc, 2, 48, torch.device("cpu"), quantize_kv=True)
    for lo, hi in ((0, 20), (20, 21)):
        want, jcache = jax_forward(jc, jp, jnp.asarray(tokens[:, lo:hi]),
                                   cache=jcache)
        got, tcache = forward(tc, tp, _t(tokens[:, lo:hi]), cache=tcache)
        np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                   atol=LOGIT_ATOL, rtol=0)
    assert tcache.index == 21 and tcache.quantized


def test_lora_training_merge_refuses_quantized_base(model):
    tp = _quantized_pair(model, "int8")[3]
    lora = LoraDeltas({"attn.wq": {"a": torch.zeros(2, 128, 4),
                                   "b": torch.zeros(2, 4, 128)}}, 2.0)
    with pytest.raises(NotImplementedError, match="quantized base"):
        lora.weight("attn.wq", tp["layers"]["attn"]["wq"], 0)
    # Targets without factors pass the quantized layer through.
    assert isinstance(lora.weight("attn.wk", tp["layers"]["attn"]["wk"], 0),
                      tq.QuantizedArray)
