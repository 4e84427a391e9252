"""The port's MoE layer (runbooks_tpu_torch/models/moe.py) against the
reference's (runbooks_tpu/models/moe.py), on seeded numpy inputs.

- ``moe_capacity`` over a grid of token counts, experts, k and capacity
  factors: equal.
- The routing (which assignments are kept, in which slot, with which
  weight, and the aux loss) against the reference's
  ``_dispatch_combine``, at capacity factors 4.0 (no drops), 1.25 (the
  default) and 0.01 (capacity 1: nearly everything dropped), for top-1
  and top-2, with padding tokens (all-zero rows, whose router
  probabilities tie across every expert: the tie goes to the lower
  index) among the tokens: the dispatch equal, the combine and aux
  within 1e-6.
- ``moe_block`` against the reference's in f32 (within 1e-5, matmuls at
  "highest", tests/conftest.py) and in bf16 (within BF16_RTOL relative:
  both round each expert product to bf16, and one bf16 ulp of the
  activation is 2^-8 relative).
- ``moe_block`` against ``moe_block_dense``, the reference's one-hot
  formulation written out: bit-equal in f32 and in bf16.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from runbooks_tpu.models import moe as jax_moe
from runbooks_tpu.models.config import get_config as jax_get_config

from runbooks_tpu_torch.models import moe
from runbooks_tpu_torch.models.config import get_config

torch.set_num_threads(2)

# tests/test_moe.py's debug MoE size.
MOE = dict(vocab_size=64, hidden_size=32, intermediate_size=48,
           num_layers=2, num_heads=4, num_kv_heads=2, head_dim=8,
           max_seq_len=32, dtype="float32", moe_num_experts=4,
           moe_top_k=2, moe_capacity_factor=1.25)
F32_ATOL = 1e-5
ROUTE_ATOL = 1e-6
# Two bf16 ulps of the output, relative.
BF16_RTOL = 2 * 2.0 ** -8


def configs(**over):
    kw = dict(MOE, **over)
    return jax_get_config("debug", **kw), get_config("debug", **kw)


def layer_params(cfg, seed=0):
    rng = np.random.default_rng(seed)
    E, h, m = cfg.moe_num_experts, cfg.hidden_size, cfg.intermediate_size
    return {"router": rng.standard_normal((h, E)).astype(np.float32)
            * h ** -0.5,
            "wi_gate": rng.standard_normal((E, h, m)).astype(np.float32)
            * h ** -0.5,
            "wi_up": rng.standard_normal((E, h, m)).astype(np.float32)
            * h ** -0.5,
            "wo": rng.standard_normal((E, m, h)).astype(np.float32)
            * m ** -0.5}


def tokens_x(cfg, b=4, s=12, pad=5, seed=1):
    """[b, s, h] activations whose last ``pad`` rows of the last batch
    row are zeros (padding: every expert's logit 0, a full tie)."""
    x = np.random.default_rng(seed).standard_normal(
        (b, s, cfg.hidden_size)).astype(np.float32)
    x[-1, s - pad:] = 0.0
    return x


@pytest.mark.parametrize("T", [1, 7, 8, 100, 1024, 16384])
@pytest.mark.parametrize("E,k", [(4, 1), (4, 2), (8, 2)])
@pytest.mark.parametrize("cf", [0.01, 1.0, 1.25, 4.0])
def test_capacity_matches_reference(T, E, k, cf):
    jcfg, tcfg = configs(moe_num_experts=E, moe_top_k=k,
                         moe_capacity_factor=cf)
    assert moe.moe_capacity(tcfg, T) == jax_moe.moe_capacity(jcfg, T)


@pytest.mark.parametrize("k", [1, 2])
@pytest.mark.parametrize("cf", [4.0, 1.25, 0.01])
def test_routing_matches_reference(cf, k):
    jcfg, tcfg = configs(moe_capacity_factor=cf, moe_top_k=k)
    p = layer_params(tcfg)
    x = tokens_x(tcfg).reshape(-1, tcfg.hidden_size)
    T, E = x.shape[0], tcfg.moe_num_experts
    probs = moe.router_probs({"router": torch.from_numpy(p["router"])},
                             torch.from_numpy(x))
    want_d, want_c, want_aux = jax_moe._dispatch_combine(
        jcfg, jnp.asarray(probs.numpy()), T)
    want_d, want_c = np.asarray(want_d), np.asarray(want_c)
    r = moe.route(tcfg, probs)
    assert r.capacity == moe.moe_capacity(tcfg, T) == want_d.shape[-1]
    got_d = moe.routing_dispatch(r, T, E).numpy()
    np.testing.assert_array_equal(got_d, want_d)
    # The padding rows tie on every expert: the first choices go to the
    # lowest indices.
    np.testing.assert_array_equal(r.expert.reshape(k, T)[:, -1].numpy(),
                                  np.arange(k))
    got_c = np.zeros_like(want_c)
    kept = r.keep.numpy()
    tok = np.arange(k * T)[kept] % T
    got_c[tok, r.expert.numpy()[kept], r.slot.numpy()[kept]] = \
        r.gate.numpy()[kept]
    np.testing.assert_allclose(got_c, want_c, atol=ROUTE_ATOL, rtol=0)
    np.testing.assert_allclose(float(r.aux), float(want_aux),
                               atol=ROUTE_ATOL, rtol=0)
    # The dense formulation decides the same.
    d, c, aux = moe.dispatch_combine_dense(tcfg, probs)
    assert torch.equal(d, torch.from_numpy(got_d))
    np.testing.assert_allclose(c.numpy(), want_c, atol=ROUTE_ATOL, rtol=0)
    assert float(aux) == float(r.aux)
    # cf 0.01: capacity 1, one assignment kept per expert.
    if cf == 0.01:
        assert int(r.keep.sum()) == E


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("cf", [4.0, 1.25, 0.01])
def test_moe_block_matches_reference(dtype, cf):
    jcfg, tcfg = configs(moe_capacity_factor=cf, dtype=dtype)
    p = layer_params(tcfg, seed=2)
    x = tokens_x(tcfg, seed=3)
    want, want_aux = jax_moe.moe_block(
        jcfg, {k: jnp.asarray(v) for k, v in p.items()},
        jnp.asarray(x).astype(jcfg.activation_dtype))
    want = np.asarray(want.astype(jnp.float32))
    tp = {k: torch.from_numpy(v) for k, v in p.items()}
    got, aux = moe.moe_block(tcfg, tp,
                             torch.from_numpy(x).to(tcfg.activation_dtype))
    assert got.dtype == tcfg.activation_dtype and got.shape == x.shape
    got = got.float().numpy()
    if dtype == "float32":
        np.testing.assert_allclose(got, want, atol=F32_ATOL, rtol=0)
    else:
        np.testing.assert_allclose(got, want, atol=BF16_RTOL * np.abs(
            want).max(), rtol=BF16_RTOL)
    np.testing.assert_allclose(float(aux), float(want_aux), atol=ROUTE_ATOL,
                               rtol=0)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("k,cf", [(2, 4.0), (2, 1.25), (1, 1.25), (2, 0.01)])
def test_moe_block_equals_dense_formulation(dtype, k, cf):
    _, tcfg = configs(moe_capacity_factor=cf, moe_top_k=k, dtype=dtype,
                      moe_num_experts=8, hidden_size=64,
                      intermediate_size=96)
    tp = {n: torch.from_numpy(v)
          for n, v in layer_params(tcfg, seed=4).items()}
    x = torch.from_numpy(tokens_x(tcfg, b=3, s=17, seed=5)).to(
        tcfg.activation_dtype)
    got, aux = moe.moe_block(tcfg, tp, x)
    want, want_aux = moe.moe_block_dense(tcfg, tp, x)
    assert torch.equal(got, want)
    assert float(aux) == float(want_aux)


def test_layer_logical_axes_match_reference():
    assert moe.moe_logical_axes() == jax_moe.moe_logical_axes()
