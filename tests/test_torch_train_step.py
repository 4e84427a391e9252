"""The port's losses, optimizer and full train step against the JAX
package's.

Inputs come from numpy with a seed; the model is the ``debug`` config in
float32 with the reference's ``init_params`` weights carried over by
``models/bridge.py``; JAX matmuls run at "highest" precision
(tests/conftest.py), so both sides compute in f32. The JAX step runs on a
one-device CPU mesh; its flash path runs the Pallas kernels in interpret
mode, the port's its plain versions. Chunked CE is held against the dense
CE (the reference's accumulate x chunked path fails its own tests here,
ROADMAP F2), and accumulation against one large batch.

Tolerances: losses and gradient norms within 1e-5 relative; gradients and
logits within 1e-5 absolute; parameters after an Adam step within 1e-5
absolute (lr 1e-3 and eps 1e-3, see OPT).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from runbooks_tpu.models.config import get_config as jax_get_config
from runbooks_tpu.parallel.mesh import MeshConfig, make_mesh
from runbooks_tpu.train import optimizer as jax_opt
from runbooks_tpu.train import step as jax_step

from runbooks_tpu_torch.models import bridge
from runbooks_tpu_torch.models.config import get_config
from runbooks_tpu_torch.train import data, step as t_step
from runbooks_tpu_torch.train.optimizer import OptimizerConfig, make_optimizer
from runbooks_tpu_torch.utils.tree import tree_leaves

torch.set_num_threads(2)

TOL = 1e-5
SEQ = 32


def _t(a):
    return torch.from_numpy(np.asarray(a).copy())


def packed_batch(seed, rows=4, seq=SEQ, vocab=512):
    """Rows packed from seeded token documents (segments, restarting
    positions, loss mask), as numpy."""
    rng = np.random.default_rng(seed)
    docs = [rng.integers(1, vocab, int(rng.integers(5, 40))).tolist()
            for _ in range(40)]
    return next(data.batch_rows(data.pack_documents(docs, seq), rows))


def jax_state(cfg, opt, seed=0):
    mesh = make_mesh(MeshConfig(fsdp=1), devices=jax.devices()[:1])
    state, shardings = jax_step.create_train_state(cfg, opt, mesh,
                                                   jax.random.key(seed))
    return mesh, state, shardings


# ---------------------------------------------------------------------------
# Losses
# ---------------------------------------------------------------------------

def test_cross_entropy_value_and_grad_match():
    rng = np.random.default_rng(0)
    logits = rng.standard_normal((2, 6, 50), dtype=np.float32) * 3
    targets = rng.integers(0, 50, (2, 6)).astype(np.int32)
    w = (rng.random((2, 6)) > 0.3).astype(np.float32)

    def jl(x):
        return jax_step.cross_entropy_loss(x, jnp.asarray(targets),
                                           jnp.asarray(w))[0]

    jv, jg = jax.value_and_grad(jl)(jnp.asarray(logits))
    tx = _t(logits).requires_grad_()
    tv, total = t_step.cross_entropy_loss(tx, _t(targets), _t(w))
    (tg,) = torch.autograd.grad(tv, tx)
    np.testing.assert_allclose(tv.item(), float(jv), rtol=TOL)
    np.testing.assert_allclose(tg.numpy(), np.asarray(jg), atol=TOL)
    assert total.item() == w.sum()


@pytest.mark.parametrize("chunk", [4, 7])      # 7: a ragged last chunk
def test_chunked_cross_entropy_matches_jax_and_dense(chunk):
    rng = np.random.default_rng(1)
    acts = rng.standard_normal((2, 20, 16), dtype=np.float32)
    head = rng.standard_normal((16, 40), dtype=np.float32)
    targets = rng.integers(0, 40, (2, 20)).astype(np.int32)
    w = (rng.random((2, 20)) > 0.2).astype(np.float32)

    def jl(a, h):
        return jax_step.chunked_cross_entropy(
            a, h, jnp.asarray(targets), jnp.asarray(w), chunk_size=chunk,
            compute_dtype=jnp.float32)[0]

    jv, (ja, jh) = jax.value_and_grad(jl, argnums=(0, 1))(
        jnp.asarray(acts), jnp.asarray(head))
    ta, th = _t(acts).requires_grad_(), _t(head).requires_grad_()
    tv, _ = t_step.chunked_cross_entropy(ta, th, _t(targets), _t(w),
                                         chunk_size=chunk,
                                         compute_dtype=torch.float32)
    ga, gh = torch.autograd.grad(tv, (ta, th))
    np.testing.assert_allclose(tv.item(), float(jv), rtol=TOL)
    np.testing.assert_allclose(ga.numpy(), np.asarray(ja), atol=TOL)
    np.testing.assert_allclose(gh.numpy(), np.asarray(jh), atol=TOL)
    # ... and the port's chunked loss against its dense loss.
    ta2, th2 = _t(acts).requires_grad_(), _t(head).requires_grad_()
    dv, _ = t_step.cross_entropy_loss(ta2 @ th2, _t(targets), _t(w))
    da, dh = torch.autograd.grad(dv, (ta2, th2))
    np.testing.assert_allclose(tv.item(), dv.item(), rtol=TOL)
    np.testing.assert_allclose(ga.numpy(), da.numpy(), atol=TOL)
    np.testing.assert_allclose(gh.numpy(), dh.numpy(), atol=TOL)


# ---------------------------------------------------------------------------
# Optimizer
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("kw", [
    dict(schedule="cosine", warmup_steps=2, grad_clip_norm=1.0),
    dict(schedule="linear", warmup_steps=0, grad_clip_norm=None,
         weight_decay=0.1),
    dict(schedule="constant", warmup_steps=3, grad_clip_norm=1e3),
    dict(schedule="cosine", warmup_steps=1, mu_dtype="bfloat16",
         weight_decay=0.01),
], ids=["cosine-warmup-clip", "linear-decay-noclip", "constant-clip-idle",
        "cosine-bf16-mu"])
def test_optimizer_matches_optax_over_six_steps(kw):
    """Both optimizers see the same params and the same 6 gradients
    (large enough that clipping at 1.0 triggers)."""
    kw = dict(learning_rate=1e-2, total_steps=6, **kw)
    jo = jax_opt.make_optimizer(jax_opt.OptimizerConfig(**kw))
    to = make_optimizer(OptimizerConfig(**kw))
    rng = np.random.default_rng(2)
    params = {"w": rng.standard_normal((4, 5), dtype=np.float32),
              "n": {"b": rng.standard_normal(7, dtype=np.float32)}}
    jp = jax.tree.map(jnp.asarray, params)
    js = jo.init(jp)
    tp = bridge.tree_from_numpy(params)
    ts = to.init(tp)
    for _ in range(6):
        g = jax.tree.map(lambda p: (rng.standard_normal(p.shape) * 3).astype(
            np.float32), params)
        u, js = jo.update(jax.tree.map(jnp.asarray, g), js, jp)
        jp = optax.apply_updates(jp, u)
        tp, ts = to.update(bridge.tree_from_numpy(g), ts, tp)
    for a, b in zip(jax.tree.leaves(jp), tree_leaves(tp)):
        np.testing.assert_allclose(b.numpy(), np.asarray(a), atol=TOL)
    carried = bridge.adam_state_from_optax_numpy(
        jax.tree.map(np.asarray, js))
    assert carried["count"] == ts["count"] == 6
    for a, b in zip(tree_leaves(carried["mu"]), tree_leaves(ts["mu"])):
        assert a.dtype == b.dtype
        np.testing.assert_allclose(b.float().numpy(), a.float().numpy(),
                                   atol=TOL)


# ---------------------------------------------------------------------------
# Full train step
# ---------------------------------------------------------------------------

# Adam's first update is g / (|g| + eps): with the default eps 1e-8 a
# 1e-9 difference in a gradient near zero (two f32 summation orders) moves
# its update by a sizeable fraction of lr. eps 1e-3 keeps the comparison
# about the gradients (an update moves by at most lr * dg / eps).
OPT = dict(learning_rate=1e-3, warmup_steps=0, total_steps=10, eps=1e-3)


@pytest.mark.parametrize("impl", ["xla", "flash"])
def test_full_step_matches_jax(impl):
    jcfg = jax_get_config("debug", dtype="float32", attention_impl=impl)
    tcfg = get_config("debug", dtype="float32", attention_impl=impl)
    jo = jax_opt.make_optimizer(jax_opt.OptimizerConfig(**OPT))
    mesh, state, shardings = jax_state(jcfg, jo)
    params_np = jax.tree.map(np.asarray, state.params)
    batch = packed_batch(3)
    jstep = jax_step.make_train_step(jcfg, jo, mesh, shardings)
    with jax.set_mesh(mesh):
        jstate, jm = jstep(state, {k: jnp.asarray(v)
                                   for k, v in batch.items()})
    to = make_optimizer(OptimizerConfig(**OPT))
    tstate = t_step.create_train_state(
        bridge.from_jax_numpy(tcfg, params_np), to)
    tstep = t_step.make_train_step(tcfg, to)
    tstate, tm = tstep(tstate, {k: _t(v) for k, v in batch.items()})
    np.testing.assert_allclose(tm["loss"].item(), float(jm["loss"]),
                               rtol=TOL)
    np.testing.assert_allclose(tm["grad_norm"].item(),
                               float(jm["grad_norm"]), rtol=TOL)
    assert tm["weight_tokens"].item() == float(jm["weight_tokens"])
    assert tstate.step == int(jstate.step) == 1
    for a, b in zip(jax.tree.leaves(jstate.params),
                    tree_leaves(tstate.params)):
        np.testing.assert_allclose(b.numpy(), np.asarray(a), atol=TOL)


def test_accumulation_equals_one_large_batch():
    """k=2 microbatches against the same batch in one piece: the port's
    loss, gradient norm and updated params, and the JAX single-batch
    step's loss."""
    tcfg = get_config("debug", dtype="float32")
    jcfg = jax_get_config("debug", dtype="float32")
    jo = jax_opt.make_optimizer(jax_opt.OptimizerConfig(**OPT))
    mesh, state, shardings = jax_state(jcfg, jo, seed=1)
    params_np = jax.tree.map(np.asarray, state.params)
    batch = packed_batch(4)
    with jax.set_mesh(mesh):
        _, jm = jax_step.make_train_step(jcfg, jo, mesh, shardings)(
            state, {k: jnp.asarray(v) for k, v in batch.items()})
    results = []
    for k in (1, 2):
        to = make_optimizer(OptimizerConfig(**OPT))
        st = t_step.create_train_state(
            bridge.from_jax_numpy(tcfg, params_np), to)
        st, m = t_step.make_train_step(tcfg, to, accumulate_steps=k)(
            st, {key: _t(v) for key, v in batch.items()})
        results.append((st, m))
    (s1, m1), (s2, m2) = results
    np.testing.assert_allclose(m2["loss"].item(), m1["loss"].item(),
                               rtol=TOL)
    np.testing.assert_allclose(m2["loss"].item(), float(jm["loss"]),
                               rtol=TOL)
    np.testing.assert_allclose(m2["grad_norm"].item(),
                               m1["grad_norm"].item(), rtol=TOL)
    assert m2["weight_tokens"].item() == m1["weight_tokens"].item()
    for a, b in zip(tree_leaves(s1.params), tree_leaves(s2.params)):
        np.testing.assert_allclose(b.numpy(), a.numpy(), atol=TOL)


def test_chunked_loss_step_matches_dense_step():
    tcfg = get_config("debug", dtype="float32")
    batch = {k: _t(v) for k, v in packed_batch(5).items()}
    out = []
    for chunk in (0, 8):
        to = make_optimizer(OptimizerConfig(**OPT))
        gen = torch.Generator().manual_seed(0)
        from runbooks_tpu_torch.models.transformer import init_params

        st = t_step.create_train_state(init_params(tcfg, gen, "cpu"), to)
        out.append(t_step.make_train_step(tcfg, to, loss_chunk=chunk)(
            st, batch))
    (s0, m0), (s1, m1) = out
    np.testing.assert_allclose(m1["loss"].item(), m0["loss"].item(),
                               rtol=TOL)
    for a, b in zip(tree_leaves(s0.params), tree_leaves(s1.params)):
        np.testing.assert_allclose(b.numpy(), a.numpy(), atol=TOL)


def test_nonfinite_guard_leaves_state_bitwise_and_advances():
    from runbooks_tpu_torch.models.transformer import init_params

    tcfg = get_config("debug", dtype="float32")
    to = make_optimizer(OptimizerConfig(**OPT))
    gen = torch.Generator().manual_seed(0)
    st = t_step.create_train_state(init_params(tcfg, gen, "cpu"), to)
    step = t_step.make_train_step(tcfg, to)
    batch = {k: _t(v) for k, v in packed_batch(6).items()}
    st, m = step(st, batch)                 # a good step: moments non-zero
    assert m["nonfinite"] == 0
    before = [t.clone() for t in tree_leaves(
        {"p": st.params, "mu": st.opt_state["mu"],
         "nu": st.opt_state["nu"]})]
    count = st.opt_state["count"]
    bad = dict(batch, loss_mask=batch["loss_mask"] * float("nan"))
    st2, m2 = step(st, bad)
    assert m2["nonfinite"] == 1 and st2.step == st.step + 1
    after = list(tree_leaves({"p": st2.params, "mu": st2.opt_state["mu"],
                              "nu": st2.opt_state["nu"]}))
    assert all(torch.equal(a, b) for a, b in zip(before, after))
    assert st2.opt_state["count"] == count


def test_forward_segments_remat_and_policies():
    """Packed rows through the no-cache forward with and without remat
    give the same logits and gradients; the reference's other remat
    policies are refused by name, and segment ids with a cache raise."""
    from runbooks_tpu_torch.models.transformer import (
        KVCache,
        forward,
        init_params,
    )

    tcfg = get_config("debug", dtype="float32")
    params = init_params(tcfg, torch.Generator().manual_seed(0), "cpu")
    b = {k: _t(v) for k, v in packed_batch(8).items()}
    outs = []
    for remat in (False, True):
        w = params["layers"]["attn"]["wq"].detach().requires_grad_()
        p = dict(params, layers=dict(params["layers"], attn=dict(
            params["layers"]["attn"], wq=w)))
        logits, _ = forward(tcfg, p, b["tokens"], positions=b["positions"],
                            segment_ids=b["segment_ids"], remat=remat)
        (g,) = torch.autograd.grad(logits.square().mean(), w)
        outs.append((logits.detach(), g))
    np.testing.assert_allclose(outs[1][0].numpy(), outs[0][0].numpy(),
                               atol=TOL)
    np.testing.assert_allclose(outs[1][1].numpy(), outs[0][1].numpy(),
                               atol=TOL)
    for policy in ("dots_saveable", "save_attn_out"):
        with pytest.raises(NotImplementedError, match=policy):
            forward(dataclasses.replace(tcfg, remat_policy=policy), params,
                    b["tokens"], remat=True)
    same, _ = forward(dataclasses.replace(tcfg, remat_policy="none"),
                      params, b["tokens"], positions=b["positions"],
                      segment_ids=b["segment_ids"], remat=True)
    assert torch.equal(same, outs[0][0])
    cache = KVCache.create(tcfg, 4, SEQ, torch.device("cpu"))
    with pytest.raises(NotImplementedError, match="segment_ids"):
        forward(tcfg, params, b["tokens"], segment_ids=b["segment_ids"],
                cache=cache)
