"""The port's remat policies against the JAX package's.

``remat_policy`` picks what a checkpointed block keeps for its backward:
nothing_saveable (only the block input), dots_with_no_batch_dims_saveable
(the projections' outputs), dots_saveable (every product's output) and
save_attn_out (the post-wo attention output and K1's out and lse). The
port maps them onto torch's selective activation checkpointing
(models/transformer.REMAT_POLICIES). A policy moves memory and recompute,
never the math, so:

- the gradients under each policy equal the reference's under the same
  policy (the ``debug`` config at float32 with the reference's weights,
  both sides in f32; the flash path runs the Pallas kernels in interpret
  mode and the port's plain versions), within 1e-5 absolute, and equal the
  port's nothing_saveable gradients within the same;
- under save_attn_out the backward reuses K1's saved (out, lse): K1's
  plain version runs once per layer, against twice under
  nothing_saveable (the twin of tests/test_flash_attention.py's count of
  Pallas calls, 4 against 3);
- the bytes a forward leaves alive for its backward (the storages its
  operators created that are still held when it returns: autograd's saved
  tensors and the policy's saved outputs together) order none >
  dots_saveable >= dots_with_no_batch_dims_saveable > save_attn_out >
  nothing_saveable.
"""

import dataclasses
import gc

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.multiprocessing.reductions import StorageWeakRef
from torch.utils._python_dispatch import TorchDispatchMode

from runbooks_tpu.models.config import get_config as jax_get_config
from runbooks_tpu.models.transformer import forward as jax_forward
from runbooks_tpu.models.transformer import init_params as jax_init_params

from runbooks_tpu_torch.models import bridge
from runbooks_tpu_torch.models.config import get_config
from runbooks_tpu_torch.models.transformer import (
    REMAT_POLICIES,
    forward,
    init_params,
)
from runbooks_tpu_torch.ops import flash_attention as fa
from runbooks_tpu_torch.train.lora import (
    LoraConfig,
    create_lora_train_state,
    make_lora_train_step,
)
from runbooks_tpu_torch.train.optimizer import OptimizerConfig, make_optimizer
from runbooks_tpu_torch.utils.tree import tree_leaves, tree_map

torch.set_num_threads(2)

TOL = 1e-5
POLICIES = ("dots_with_no_batch_dims_saveable", "dots_saveable",
            "save_attn_out")


def _tokens(seed, rows=2, seq=64, vocab=512):
    return np.random.default_rng(seed).integers(
        0, vocab, (rows, seq)).astype(np.int32)


def _port_grads(cfg, params, tokens):
    p = tree_map(lambda t: t.detach().clone().requires_grad_(), params)
    logits, _ = forward(cfg, p, torch.from_numpy(tokens), remat=True)
    logits.square().mean().backward()
    return [t.grad for t in tree_leaves(p)]


@pytest.mark.parametrize("impl", ["xla", "flash"])
@pytest.mark.parametrize("policy", POLICIES)
def test_policy_gradients_match_reference(policy, impl):
    jcfg = jax_get_config("debug", dtype="float32", attention_impl=impl,
                          remat_policy=policy, flash_block_q=32,
                          flash_block_k=32)
    tcfg = get_config("debug", dtype="float32", attention_impl=impl,
                      remat_policy=policy)
    jparams = jax_init_params(jcfg, jax.random.key(0))
    tokens = _tokens(1, seq=32)

    def loss(p):
        logits, _ = jax_forward(jcfg, p, jnp.asarray(tokens), remat=True)
        return jnp.mean(jnp.square(logits))

    jgrads = jax.grad(loss)(jparams)
    params = bridge.from_jax_numpy(tcfg, jax.tree.map(np.asarray, jparams))
    got = _port_grads(tcfg, params, tokens)
    plain = _port_grads(dataclasses.replace(
        tcfg, remat_policy="nothing_saveable"), params, tokens)
    for a, b, c in zip(jax.tree.leaves(jgrads), got, plain):
        np.testing.assert_allclose(b.numpy(), np.asarray(a), atol=TOL)
        np.testing.assert_allclose(b.numpy(), c.numpy(), atol=TOL)


def test_save_attn_out_runs_k1_once_per_layer(monkeypatch):
    """K1's plain version (the CPU's K1) runs twice per layer under
    nothing_saveable (the forward and the recompute) and once under
    save_attn_out, whose recompute takes the saved (out, lse)."""
    calls = {"n": 0}
    plain = fa.flash_attention_reference

    def counted(*args, **kwargs):
        calls["n"] += 1
        return plain(*args, **kwargs)

    monkeypatch.setattr(fa, "flash_attention_reference", counted)
    base = get_config("debug", dtype="float32", attention_impl="flash")
    params = init_params(base, torch.Generator().manual_seed(0),
                         torch.device("cpu"))
    tokens = _tokens(2)
    counts = {}
    for policy in ("nothing_saveable", "save_attn_out"):
        calls["n"] = 0
        _port_grads(dataclasses.replace(base, remat_policy=policy), params,
                    tokens)
        counts[policy] = calls["n"] / base.num_layers
    assert counts == {"nothing_saveable": 2, "save_attn_out": 1}, counts


@pytest.mark.parametrize("policy", ("nothing_saveable", *POLICIES))
def test_gemma_at_head_dim_256_runs_k1_k3_under_every_policy(monkeypatch,
                                                             policy):
    """A 2-layer gemma-2b at its head_dim 256 (2 query heads on 1, the
    scaled embedding, the tied head) on the flash path, under each policy
    phase 17 runs: K1's plain version runs twice per layer (once under
    save_attn_out, which saves its out and lse as at d=128), K2's and
    K3's once, all at head_dim 256; every leaf's gradient, the
    embedding's (its scaled lookup and the tied head together) among
    them, equals nothing_saveable's."""
    calls = {"fwd": 0, "dq": 0, "dkv": 0}
    fwd, bwd = fa.flash_attention_reference, fa.flash_attention_bwd_reference

    def counted_fwd(q, *args, **kwargs):
        assert q.shape[-1] == 256
        calls["fwd"] += 1
        return fwd(q, *args, **kwargs)

    def counted_bwd(q, *args, which=None, **kwargs):
        assert q.shape[-1] == 256
        calls[which] += 1
        return bwd(q, *args, which=which, **kwargs)

    monkeypatch.setattr(fa, "flash_attention_reference", counted_fwd)
    monkeypatch.setattr(fa, "flash_attention_bwd_reference", counted_bwd)
    base = get_config("gemma-2b", dtype="float32", attention_impl="flash",
                      vocab_size=512, num_layers=2, hidden_size=512,
                      intermediate_size=1024, num_heads=2, num_kv_heads=1,
                      max_seq_len=64)
    assert base.head_dim == 256 and base.embed_scale and base.tie_embeddings
    params = init_params(base, torch.Generator().manual_seed(0),
                         torch.device("cpu"))
    tokens = _tokens(5, seq=32)
    grads = {}
    for name in dict.fromkeys(("nothing_saveable", policy)):
        calls.update(fwd=0, dq=0, dkv=0)
        grads[name] = _port_grads(dataclasses.replace(
            base, remat_policy=name), params, tokens)
        layers = base.num_layers
        assert calls == {"fwd": layers * (1 if name == "save_attn_out"
                                          else 2),
                         "dq": layers, "dkv": layers}, (name, calls)
    for a, b in zip(grads["nothing_saveable"], grads[policy]):
        np.testing.assert_allclose(b.numpy(), a.numpy(), atol=TOL)
    (embed,) = [i for i, t in enumerate(tree_leaves(params))
                if t is params["embed"]]
    assert torch.isfinite(grads[policy][embed]).all()
    assert (grads[policy][embed][np.unique(tokens)].abs().sum(-1) > 0).all()


class _LiveStorages(TorchDispatchMode):
    """Records every storage an operator creates under it."""

    def __init__(self):
        super().__init__()
        self.refs = {}

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        for t in out if isinstance(out, (tuple, list)) else (out,):
            if isinstance(t, torch.Tensor):
                storage = t.untyped_storage()
                ref = StorageWeakRef(storage)
                # A weak reference keeps the storage's record: cdata is
                # unique among the references held.
                self.refs.setdefault(ref.cdata, (ref, storage.nbytes()))
        return out

    def live_bytes(self):
        return sum(n for ref, n in self.refs.values() if not ref.expired())


@pytest.mark.parametrize("impl", ["xla", "flash"])
def test_saved_bytes_order(impl):
    base = get_config("debug", dtype="float32", attention_impl=impl)
    params = init_params(base, torch.Generator().manual_seed(0),
                         torch.device("cpu"))
    tokens = torch.from_numpy(_tokens(3))
    saved = {}
    for policy in ("none", "nothing_saveable", *POLICIES):
        cfg = dataclasses.replace(base, remat_policy=policy)
        p = tree_map(lambda t: t.detach().clone().requires_grad_(), params)
        mode = _LiveStorages()
        with mode:
            logits, _ = forward(cfg, p, tokens, remat=True)
            loss = logits.square().mean()
        del logits
        gc.collect()
        saved[policy] = mode.live_bytes()
        loss.backward()
    assert (saved["none"] > saved["dots_saveable"]
            >= saved["dots_with_no_batch_dims_saveable"]
            > saved["save_attn_out"] > saved["nothing_saveable"]), saved
    if impl == "xla":   # the plain attention's bmm outputs
        assert saved["dots_saveable"] > saved[
            "dots_with_no_batch_dims_saveable"], saved


@pytest.mark.parametrize("policy", POLICIES)
def test_lora_step_under_policy_equals_nothing_saveable(policy):
    """Two LoRA steps (the factors' products go through aten.mm too) on
    the flash path: every policy lands on nothing_saveable's factors."""
    opt = OptimizerConfig(learning_rate=1e-3, warmup_steps=0,
                          total_steps=10, eps=1e-3)
    lora_cfg = LoraConfig(rank=4, targets=("attn.wq", "attn.wv",
                                           "mlp.wi_up"))
    base_cfg = get_config("debug", dtype="float32", attention_impl="flash")
    base = init_params(base_cfg, torch.Generator().manual_seed(0),
                       torch.device("cpu"))
    rng = np.random.default_rng(4)
    batches = [{"tokens": torch.from_numpy(rng.integers(0, 512, (2, 32))),
                "targets": torch.from_numpy(rng.integers(0, 512, (2, 32))),
                "loss_mask": torch.ones(2, 32)} for _ in range(2)]
    finals = {}
    for name in ("nothing_saveable", policy):
        cfg = dataclasses.replace(base_cfg, remat_policy=name)
        optimizer = make_optimizer(opt)
        state = create_lora_train_state(
            lora_cfg, base, optimizer, torch.Generator().manual_seed(1))
        step = make_lora_train_step(cfg, lora_cfg, optimizer)
        for batch in batches:
            state, metrics = step(state, base, batch)
            assert metrics["nonfinite"] == 0
        finals[name] = list(tree_leaves(state.params))
    for a, b in zip(finals["nothing_saveable"], finals[policy]):
        np.testing.assert_allclose(b.numpy(), a.numpy(), atol=TOL)


def test_policy_names_and_unknown_refused():
    assert set(REMAT_POLICIES) == {"nothing_saveable", *POLICIES}
    cfg = get_config("debug", dtype="float32", remat_policy="dots_everything")
    params = init_params(cfg, torch.Generator().manual_seed(0),
                         torch.device("cpu"))
    with pytest.raises(ValueError, match="dots_everything"):
        forward(cfg, params, torch.zeros(1, 8, dtype=torch.long), remat=True)
