"""Training the non-Llama dense families: the port's LoRA and full
fine-tune steps against the JAX package's.

Each family at debug width (tests/test_torch_families_forward.py's
configs and noisy weights, carried across by ``models/bridge.py``; gemma-2b
at its head_dim 256, gemma-7b at debug width), on
packed batches (segments, restarting positions, a loss mask). The LoRA
step runs the flash path: the reference's Pallas kernels in interpret
mode (forward, dq, dk/dv) against the port's plain versions of K1-K3,
the targets including the MLP's ``mlp.wi`` (gated: ``mlp.wi_gate``) and
``mlp.wo``. The full
step runs the plain attention, so every leaf's gradient (the tied
embedding's with both its shares, the learned positions', the biases')
reaches the update. Both sides compute in f32 (JAX matmuls at
"highest"). Tolerances as tests/test_torch_lora.py and
tests/test_torch_train_step.py: losses and gradient norms within 1e-5
relative, parameters after the Adam steps within 1e-5 absolute (lr 1e-3,
eps 1e-3, so the comparison reads the gradients).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from runbooks_tpu.models.transformer import param_logical_axes
from runbooks_tpu.parallel.mesh import MeshConfig, make_mesh
from runbooks_tpu.parallel.sharding import tree_shardings
from runbooks_tpu.train import lora as jax_lora
from runbooks_tpu.train import optimizer as jax_opt
from runbooks_tpu.train import step as jax_step

from runbooks_tpu_torch.models import bridge
from runbooks_tpu_torch.train import data, lora
from runbooks_tpu_torch.train import step as t_step
from runbooks_tpu_torch.train.optimizer import OptimizerConfig, make_optimizer
from runbooks_tpu_torch.train.step import TrainState
from runbooks_tpu_torch.utils.tree import tree_leaves
from tests.test_torch_families_forward import (
    D256,
    FAMILIES,
    GEMMA,
    family_configs,
    family_params,
)

torch.set_num_threads(2)

TOL = 1e-5
OPT = dict(learning_rate=1e-3, warmup_steps=0, total_steps=10, eps=1e-3)
TARGETS = ("attn.wq", "attn.wv", "mlp.wi", "mlp.wo")
# The gated MLP's matrices in place of the plain one's mlp.wi.
GATED_TARGETS = ("attn.wq", "attn.wv", "mlp.wi_gate", "mlp.wo")
# Every family, gemma included: gemma-2b at its own head_dim 256 (2 query
# heads on 1, the least width that holds it), gemma-7b at debug width.
TRAINED = sorted(FAMILIES) + sorted(GEMMA)
WIDTH = {"gemma-2b": D256}


def _t(a):
    return torch.from_numpy(np.asarray(a).copy())


def packed_batches(seed, n, rows=4, seq=32, vocab=512):
    rng = np.random.default_rng(seed)
    docs = [rng.integers(1, vocab, int(rng.integers(5, 40))).tolist()
            for _ in range(40 * n)]
    it = data.batch_rows(data.pack_documents(docs, seq), rows)
    return [next(it) for _ in range(n)]


def one_device_mesh():
    return make_mesh(MeshConfig(fsdp=1), devices=jax.devices()[:1])


@pytest.mark.parametrize("name", TRAINED)
def test_lora_steps_match_reference(name):
    """Two LoRA steps in two microbatches through the flash path."""
    jcfg, tcfg = family_configs(name, attention_impl="flash",
                                **WIDTH.get(name, {}))
    targets = GATED_TARGETS if tcfg.gated_mlp else TARGETS
    np_base = family_params(jcfg)
    mesh = one_device_mesh()
    base_sh = tree_shardings(jax.eval_shape(lambda: np_base),
                             param_logical_axes(jcfg), mesh)
    base = jax.device_put(jax.tree.map(jnp.asarray, np_base), base_sh)
    jlcfg = jax_lora.LoraConfig(rank=4, alpha=8.0, targets=targets)
    jo = jax_opt.make_optimizer(jax_opt.OptimizerConfig(**OPT))
    jstate, shardings = jax_lora.create_lora_train_state(
        jcfg, jlcfg, base, jo, mesh, jax.random.key(1))
    jstep = jax_lora.make_lora_train_step(jcfg, jlcfg, jo, mesh, shardings,
                                          base_sh, accumulate_steps=2)

    tlcfg = lora.LoraConfig(rank=4, alpha=8.0, targets=targets)
    to = make_optimizer(OptimizerConfig(**OPT))
    tbase = bridge.from_jax_numpy(tcfg, np_base)
    tl = bridge.tree_from_numpy(jax.tree.map(np.asarray, jstate.params))
    assert sorted(tl) == sorted(targets)
    tstate = TrainState(step=0, params=tl, opt_state=to.init(tl))
    tstep = lora.make_lora_train_step(tcfg, tlcfg, to, accumulate_steps=2)

    for batch in packed_batches(7, 2):
        with jax.set_mesh(mesh):
            jstate, jm = jstep(jstate, base,
                               {k: jnp.asarray(v) for k, v in batch.items()})
        tstate, tm = tstep(tstate, tbase,
                           {k: _t(v) for k, v in batch.items()})
        np.testing.assert_allclose(tm["loss"].item(), float(jm["loss"]),
                                   rtol=TOL)
        np.testing.assert_allclose(tm["grad_norm"].item(),
                                   float(jm["grad_norm"]), rtol=TOL)
    assert tstate.step == int(jstate.step) == 2
    for a, b in zip(jax.tree.leaves(jstate.params),
                    tree_leaves(tstate.params)):
        np.testing.assert_allclose(b.numpy(), np.asarray(a), atol=TOL)
    # The base is frozen.
    for a, b in zip(jax.tree.leaves(np_base), tree_leaves(tbase)):
        np.testing.assert_array_equal(b.numpy(), np.asarray(a))


@pytest.mark.parametrize("name", TRAINED)
def test_full_step_matches_reference(name):
    """One full fine-tune step: every leaf, the tied embedding and the
    learned positions included (gemma's embedding through both its scaled
    lookup and its tied head)."""
    jcfg, tcfg = family_configs(name, attention_impl="xla",
                                **WIDTH.get(name, {}))
    jo = jax_opt.make_optimizer(jax_opt.OptimizerConfig(**OPT))
    mesh = one_device_mesh()
    state, shardings = jax_step.create_train_state(jcfg, jo, mesh,
                                                   jax.random.key(0))
    np_params = family_params(jcfg)
    state = dataclasses.replace(state, params=jax.device_put(
        jax.tree.map(jnp.asarray, np_params), shardings.params))
    (batch,) = packed_batches(3, 1)
    with jax.set_mesh(mesh):
        jstate, jm = jax_step.make_train_step(jcfg, jo, mesh, shardings)(
            state, {k: jnp.asarray(v) for k, v in batch.items()})
    to = make_optimizer(OptimizerConfig(**OPT))
    tstate = t_step.create_train_state(bridge.from_jax_numpy(tcfg,
                                                             np_params), to)
    tstate, tm = t_step.make_train_step(tcfg, to)(
        tstate, {k: _t(v) for k, v in batch.items()})
    np.testing.assert_allclose(tm["loss"].item(), float(jm["loss"]),
                               rtol=TOL)
    np.testing.assert_allclose(tm["grad_norm"].item(),
                               float(jm["grad_norm"]), rtol=TOL)
    moved = 0
    for a, b, before in zip(jax.tree.leaves(jstate.params),
                            tree_leaves(tstate.params),
                            jax.tree.leaves(np_params)):
        np.testing.assert_allclose(b.numpy(), np.asarray(a), atol=TOL)
        moved += int(not np.array_equal(np.asarray(a), before))
    assert moved == len(jax.tree.leaves(np_params))
