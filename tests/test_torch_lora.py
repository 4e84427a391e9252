"""The port's LoRA fine-tuning against the JAX package's.

The ``debug`` config in float32 with the reference's base weights and its
initial LoRA tree carried over by ``models/bridge.py`` (numpy in between);
JAX matmuls at "highest" precision (tests/conftest.py) and a one-device
CPU mesh. Three steps of the reference's ``make_lora_train_step`` against
the port's from that one starting state, on the same packed batches.

Tolerances: merged weights within 1e-6 absolute (one f32 product of
rank 4 and one add); losses within 1e-5 relative at every step; A and B
after three Adam steps within 1e-5 absolute (lr 1e-3, eps 1e-3 as in
tests/test_torch_train_step.py, so the comparison reads the gradients).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from runbooks_tpu.models.config import get_config as jax_get_config
from runbooks_tpu.models.transformer import init_params as jax_init_params
from runbooks_tpu.models.transformer import param_logical_axes
from runbooks_tpu.parallel.mesh import MeshConfig, make_mesh
from runbooks_tpu.parallel.sharding import tree_shardings
from runbooks_tpu.train import lora as jax_lora
from runbooks_tpu.train import optimizer as jax_opt

from runbooks_tpu_torch.models import bridge
from runbooks_tpu_torch.models.config import get_config
from runbooks_tpu_torch.train import data, lora
from runbooks_tpu_torch.train.optimizer import OptimizerConfig, make_optimizer
from runbooks_tpu_torch.train.step import TrainState
from runbooks_tpu_torch.utils.tree import tree_leaves

torch.set_num_threads(2)

TOL = 1e-5
OPT = dict(learning_rate=1e-3, warmup_steps=0, total_steps=10, eps=1e-3)


def _t(a):
    return torch.from_numpy(np.asarray(a).copy())


def packed_batches(seed, n, rows=4, seq=32, vocab=512):
    rng = np.random.default_rng(seed)
    docs = [rng.integers(1, vocab, int(rng.integers(5, 40))).tolist()
            for _ in range(40 * n)]
    it = data.batch_rows(data.pack_documents(docs, seq), rows)
    return [next(it) for _ in range(n)]


def _carried(impl="xla"):
    jcfg = jax_get_config("debug", dtype="float32", attention_impl=impl)
    tcfg = get_config("debug", dtype="float32", attention_impl=impl)
    base = jax_init_params(jcfg, jax.random.key(0))
    return jcfg, tcfg, base


def test_merge_matches_reference():
    jcfg, tcfg, base = _carried()
    lcfg = jax_lora.LoraConfig(rank=4, alpha=8.0)
    jl = jax_lora.init_lora(base, lcfg, jax.random.key(1))
    # A non-zero B, so the merge changes the weights.
    jl = {t: {"a": ab["a"], "b": ab["b"] + 0.1} for t, ab in jl.items()}
    merged = jax_lora.apply_lora(base, jl, lcfg)
    tbase = bridge.from_jax_numpy(tcfg, jax.tree.map(np.asarray, base))
    tl = bridge.tree_from_numpy(jax.tree.map(np.asarray, jl))
    tmerged = lora.merge(tbase, tl, lora.LoraConfig(rank=4, alpha=8.0))
    for a, b in zip(jax.tree.leaves(merged), tree_leaves(tmerged)):
        np.testing.assert_allclose(b.numpy(), np.asarray(a), atol=1e-6)
    assert lora.trainable_param_count(tl) == \
        jax_lora.trainable_param_count(jl)


def test_init_lora_layout_and_zero_delta():
    _, tcfg, base = _carried()
    tbase = bridge.from_jax_numpy(tcfg, jax.tree.map(np.asarray, base))
    cfg = lora.LoraConfig(rank=4, alpha=8.0, targets=lora.ALL_TARGETS)
    tl = lora.init_lora(tbase, cfg, torch.Generator().manual_seed(0))
    # "mlp.wi" (the ungated MLP) is absent from a gated model: skipped.
    assert sorted(tl) == sorted(t for t in lora.ALL_TARGETS
                                if t != "mlp.wi")
    wq = tbase["layers"]["attn"]["wq"]
    assert tl["attn.wq"]["a"].shape == (wq.shape[0], wq.shape[1], 4)
    assert tl["attn.wq"]["b"].shape == (wq.shape[0], 4, wq.shape[2])
    merged = lora.merge(tbase, tl, cfg)
    for a, b in zip(tree_leaves(tbase), tree_leaves(merged)):
        assert torch.equal(a, b)
    with pytest.raises(ValueError):
        lora.init_lora(tbase, lora.LoraConfig(targets=("attn.nope",)),
                       torch.Generator())


@pytest.mark.parametrize("impl,k", [("xla", 1), ("flash", 2)])
def test_three_lora_steps_match_reference(impl, k):
    jcfg, tcfg, base = _carried(impl)
    mesh = make_mesh(MeshConfig(fsdp=1), devices=jax.devices()[:1])
    base_sh = tree_shardings(jax.eval_shape(lambda: base),
                             param_logical_axes(jcfg), mesh)
    base = jax.device_put(base, base_sh)
    jlcfg = jax_lora.LoraConfig(rank=4, alpha=8.0)
    jo = jax_opt.make_optimizer(jax_opt.OptimizerConfig(**OPT))
    jstate, shardings = jax_lora.create_lora_train_state(
        jcfg, jlcfg, base, jo, mesh, jax.random.key(1))
    lora_np = jax.tree.map(np.asarray, jstate.params)
    jstep = jax_lora.make_lora_train_step(jcfg, jlcfg, jo, mesh, shardings,
                                          base_sh, accumulate_steps=k)

    tlcfg = lora.LoraConfig(rank=4, alpha=8.0)
    to = make_optimizer(OptimizerConfig(**OPT))
    tbase = bridge.from_jax_numpy(tcfg, jax.tree.map(np.asarray, base))
    tl = bridge.tree_from_numpy(lora_np)
    tstate = TrainState(step=0, params=tl, opt_state=to.init(tl))
    tstep = lora.make_lora_train_step(tcfg, tlcfg, to, accumulate_steps=k)

    for batch in packed_batches(7, 3):
        with jax.set_mesh(mesh):
            jstate, jm = jstep(jstate, base,
                               {key: jnp.asarray(v)
                                for key, v in batch.items()})
        tstate, tm = tstep(tstate, tbase,
                           {key: _t(v) for key, v in batch.items()})
        np.testing.assert_allclose(tm["loss"].item(), float(jm["loss"]),
                                   rtol=TOL)
    assert tstate.step == int(jstate.step) == 3
    for a, b in zip(jax.tree.leaves(jstate.params),
                    tree_leaves(tstate.params)):
        np.testing.assert_allclose(b.numpy(), np.asarray(a), atol=TOL)
    # The base is frozen.
    for a, b in zip(jax.tree.leaves(base), tree_leaves(tbase)):
        np.testing.assert_array_equal(b.numpy(), np.asarray(a))
