"""Mixtral's fine-tune in the port (the MoE backward, the load-balance
term in both train steps, remat, the trainer) against the JAX package's.

The model is tests/test_torch_mixtral.py's debug MoE (4 experts, top 2,
2 layers, f32) with the reference's ``init_params`` weights carried over
by models/bridge.py; JAX matmuls run at "highest" (tests/conftest.py), so
both sides compute in f32. Every JAX result comes from one module-scoped
oracle, which compiles each reference function once.

- ``moe_block``'s gradients (x, the router, wi_gate, wi_up, wo) of a
  loss that weighs its output and its aux are held to ``jax.grad`` of the
  reference's ``moe_block`` at capacity factor 1.25 (assignments dropped)
  and 4.0 (dropless), top 1 and 2, within GRAD_RTOL of each leaf's
  largest magnitude; and to the port's ``moe_block_dense`` (the
  reference's one-hot formulation) within DENSE_RTOL of it. A token whose every assignment is dropped takes no gradient
  through the experts: a loss on those tokens alone has exactly zero
  gradient everywhere.
- ``make_train_step`` and ``make_lora_train_step`` against the
  reference's on a one-device mesh, at k=1 and k=2 microbatches: the loss
  (with ``moe_aux_coef`` x aux, divided by k under accumulation), the
  gradient norm at each of 2 steps within TOL relative, and the params
  after them within TOL absolute (lr 1e-3 and eps 1e-3, as
  tests/test_torch_train_step.py, so the comparison reads the
  gradients). The loss equals the port's own CE plus the aux term.
  The chunked loss is held to the port's dense loss (the reference's
  chunked path under accumulation fails its own tests, ROADMAP F2).
- remat on against remat off under every policy: equal gradients within
  REMAT_ATOL, and each layer's recompute routes exactly as its forward
  did (experts, slots, kept set and gates equal).
- ``run_training`` on a debug MoE: a run stopped after 2 steps and
  resumed to 3 ends bitwise equal to an uninterrupted 3-step run. The
  trainer tokenizes bytes, so this case widens the vocabulary to 512.
"""

import functools
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from runbooks_tpu.models.config import get_config as jax_get_config
from runbooks_tpu.models.moe import moe_block as jax_moe_block
from runbooks_tpu.models.transformer import param_logical_axes
from runbooks_tpu.parallel.mesh import MeshConfig, make_mesh
from runbooks_tpu.parallel.sharding import tree_shardings
from runbooks_tpu.train import lora as jax_lora
from runbooks_tpu.train import optimizer as jax_opt
from runbooks_tpu.train import step as jax_step

from runbooks_tpu_torch.models import bridge, moe
from runbooks_tpu_torch.models.config import get_config
from runbooks_tpu_torch.models.transformer import REMAT_POLICIES
from runbooks_tpu_torch.train import data, lora, trainer
from runbooks_tpu_torch.train import step as t_step
from runbooks_tpu_torch.train.checkpoint import CheckpointManager
from runbooks_tpu_torch.train.optimizer import OptimizerConfig, make_optimizer
from runbooks_tpu_torch.utils.tree import tree_leaves

torch.set_num_threads(2)

MOE = dict(vocab_size=64, hidden_size=32, intermediate_size=48,
           num_layers=2, num_heads=4, num_kv_heads=2, head_dim=8,
           max_seq_len=32, dtype="float32", moe_num_experts=4,
           moe_top_k=2, moe_capacity_factor=1.25)
OPT = dict(learning_rate=1e-3, warmup_steps=0, total_steps=10, eps=1e-3)
# moe_block's gradients: f32 on both sides (the port's combine sums in
# f64, rounded once), so each leaf within GRAD_RTOL of its largest
# magnitude from the reference's, and within DENSE_RTOL of it from
# moe_block_dense's (the same products, summed in another order).
GRAD_RTOL = 1e-5
DENSE_RTOL = 1e-6
TOL = 1e-5
REMAT_ATOL = 1e-6
AUX_WEIGHT = 0.5          # the aux's weight in moe_block's test loss
LAYER_X = (2, 16)         # moe_block's test input: [2, 16, hidden]
STEPS = 2


def _t(a):
    return torch.from_numpy(np.asarray(a).copy())


def _cfgs(**kw):
    return (jax_get_config("debug", **{**MOE, **kw}),
            get_config("debug", **{**MOE, **kw}))


def layer_inputs(seed=2):
    """One layer's MoE params, an input x and the loss's cotangent, as
    numpy from the seed."""
    rng = np.random.default_rng(seed)
    h, m, E = MOE["hidden_size"], MOE["intermediate_size"], \
        MOE["moe_num_experts"]

    def normal(shape, fan_in):
        return (rng.standard_normal(shape) * fan_in ** -0.5).astype(
            np.float32)

    p = {"router": normal((h, E), 1), "wi_gate": normal((E, h, m), h),
         "wi_up": normal((E, h, m), h), "wo": normal((E, m, h), m)}
    # A direction every token shares skews the routing, so that capacity
    # 1.25 drops first and second choices.
    x = (rng.standard_normal(LAYER_X + (h,))
         + rng.standard_normal(h)).astype(np.float32)
    cot = rng.standard_normal(LAYER_X + (h,)).astype(np.float32)
    return p, x, cot


def packed_batches(seed, n, rows=4, seq=32, vocab=64):
    rng = np.random.default_rng(seed)
    docs = [rng.integers(1, vocab, int(rng.integers(5, 40))).tolist()
            for _ in range(40 * n)]
    it = data.batch_rows(data.pack_documents(docs, seq), rows)
    return [next(it) for _ in range(n)]


# ---------------------------------------------------------------------------
# The reference oracle
# ---------------------------------------------------------------------------

class Oracle:
    """The JAX package's results, each computed once for the module."""

    def __init__(self):
        self.mesh = make_mesh(MeshConfig(fsdp=1), devices=jax.devices()[:1])
        self.batches = packed_batches(7, STEPS)

    @functools.lru_cache(maxsize=None)
    def moe_grads(self, cf, k):
        """(out, aux, grads of x and of each param) of the reference's
        moe_block under the test loss."""
        jcfg, _ = _cfgs(moe_capacity_factor=cf, moe_top_k=k)
        p, x, cot = layer_inputs()

        def loss(x, p):
            out, aux = jax_moe_block(jcfg, p, x)
            return jnp.sum(out * cot) + AUX_WEIGHT * aux, (out, aux)

        (_, (out, aux)), (gx, gp) = jax.value_and_grad(
            loss, argnums=(0, 1), has_aux=True)(
                jnp.asarray(x), jax.tree.map(jnp.asarray, p))
        return (np.asarray(out), float(aux), np.asarray(gx),
                jax.tree.map(np.asarray, gp))

    @functools.lru_cache(maxsize=None)
    def full_steps(self, k):
        """(initial params, [metrics per step], params after STEPS) of the
        reference's make_train_step."""
        jcfg, _ = _cfgs()
        jo = jax_opt.make_optimizer(jax_opt.OptimizerConfig(**OPT))
        state, shardings = jax_step.create_train_state(
            jcfg, jo, self.mesh, jax.random.key(0))
        params0 = jax.tree.map(np.asarray, state.params)
        jstep = jax_step.make_train_step(jcfg, jo, self.mesh, shardings,
                                         accumulate_steps=k)
        metrics = []
        with jax.set_mesh(self.mesh):
            for batch in self.batches:
                state, m = jstep(state, {key: jnp.asarray(v)
                                         for key, v in batch.items()})
                metrics.append({n: float(v) for n, v in m.items()})
        return params0, metrics, jax.tree.map(np.asarray, state.params)

    @functools.lru_cache(maxsize=None)
    def lora_steps(self, k):
        """(base, initial LoRA tree, [metrics per step], LoRA tree after
        STEPS) of the reference's make_lora_train_step on ALL_TARGETS."""
        from runbooks_tpu.models.transformer import init_params

        jcfg, _ = _cfgs()
        base = init_params(jcfg, jax.random.key(0))
        base_sh = tree_shardings(jax.eval_shape(lambda: base),
                                 param_logical_axes(jcfg), self.mesh)
        base = jax.device_put(base, base_sh)
        lcfg = jax_lora.LoraConfig(rank=4, alpha=8.0,
                                   targets=jax_lora.ALL_TARGETS)
        jo = jax_opt.make_optimizer(jax_opt.OptimizerConfig(**OPT))
        state, shardings = jax_lora.create_lora_train_state(
            jcfg, lcfg, base, jo, self.mesh, jax.random.key(1))
        lora0 = jax.tree.map(np.asarray, state.params)
        jstep = jax_lora.make_lora_train_step(
            jcfg, lcfg, jo, self.mesh, shardings, base_sh,
            accumulate_steps=k)
        metrics = []
        with jax.set_mesh(self.mesh):
            for batch in self.batches:
                state, m = jstep(state, base, {key: jnp.asarray(v)
                                               for key, v in batch.items()})
                metrics.append({n: float(v) for n, v in m.items()})
        return (jax.tree.map(np.asarray, base), lora0, metrics,
                jax.tree.map(np.asarray, state.params))


@pytest.fixture(scope="module")
def oracle():
    return Oracle()


# ---------------------------------------------------------------------------
# moe_block's backward
# ---------------------------------------------------------------------------

def port_moe_grads(block, tcfg, p, x, cot):
    tp = {n: _t(v).requires_grad_() for n, v in p.items()}
    tx = _t(x).requires_grad_()
    out, aux = block(tcfg, tp, tx)
    loss = (out * _t(cot)).sum() + AUX_WEIGHT * aux
    grads = torch.autograd.grad(loss, [tx] + [tp[n] for n in sorted(tp)])
    return out.detach(), aux.detach(), grads[0], dict(zip(sorted(tp),
                                                          grads[1:]))


def close(got, want, rtol, name):
    np.testing.assert_allclose(got.numpy(), want, rtol=0, err_msg=name,
                               atol=rtol * float(np.abs(want).max()))


@pytest.mark.parametrize("k", [1, 2])
@pytest.mark.parametrize("cf", [1.25, 4.0])
def test_moe_block_grads_match_reference(oracle, cf, k):
    _, tcfg = _cfgs(moe_capacity_factor=cf, moe_top_k=k)
    p, x, cot = layer_inputs()
    r = moe.route(tcfg, moe.router_probs(
        {"router": _t(p["router"])}, _t(x).reshape(-1, x.shape[-1])))
    # cf 1.25 drops assignments; 4.0 >= E / k keeps every one.
    assert (int(r.keep.sum()) < r.keep.numel()) == (cf == 1.25)
    want_out, want_aux, want_gx, want_gp = oracle.moe_grads(cf, k)
    out, aux, gx, gp = port_moe_grads(moe.moe_block, tcfg, p, x, cot)
    np.testing.assert_allclose(out.numpy(), want_out, atol=1e-5, rtol=0)
    np.testing.assert_allclose(float(aux), want_aux, atol=1e-6, rtol=0)
    close(gx, want_gx, GRAD_RTOL, "x")
    for name in sorted(p):
        assert float(gp[name].abs().max()) > 0, name
        close(gp[name], want_gp[name], GRAD_RTOL, name)
    # ... and the port's one-hot formulation's.
    _, _, dgx, dgp = port_moe_grads(moe.moe_block_dense, tcfg, p, x, cot)
    close(gx, dgx.numpy(), DENSE_RTOL, "x")
    for name in sorted(p):
        close(gp[name], dgp[name].numpy(), DENSE_RTOL, name)


@pytest.mark.parametrize("k", [1, 2])
def test_dropped_tokens_take_no_gradient(k):
    """A loss over the tokens whose every assignment was dropped (their
    output is 0 whatever the gates and experts) has gradient exactly 0
    for x and every param, in moe_block and in moe_block_dense."""
    _, tcfg = _cfgs(moe_capacity_factor=0.5, moe_top_k=k)
    p, x, cot = layer_inputs()
    T, h = LAYER_X[0] * LAYER_X[1], x.shape[-1]
    r = moe.route(tcfg, moe.router_probs({"router": _t(p["router"])},
                                         _t(x).reshape(T, h)))
    dropped = ~r.keep.reshape(k, T).any(0)
    assert 0 < int(dropped.sum()) < T
    cot = cot * dropped.reshape(LAYER_X + (1,)).numpy()
    for block in (moe.moe_block, moe.moe_block_dense):
        tp = {n: _t(v).requires_grad_() for n, v in p.items()}
        tx = _t(x).requires_grad_()
        out, _ = block(tcfg, tp, tx)
        assert not out.reshape(T, h)[dropped].any()
        grads = torch.autograd.grad((out * _t(cot)).sum(),
                                    [tx] + list(tp.values()))
        assert all(not g.any() for g in grads)


# ---------------------------------------------------------------------------
# The train steps
# ---------------------------------------------------------------------------

def _batch(batch):
    return {key: _t(v) for key, v in batch.items()}


def _objective(tcfg, params, batch, k, lora_tree=None, lora_cfg=None):
    """The first step's objective by hand from make_ce_terms: each
    microbatch's CE x its weight / the batch's (k > 1), plus
    moe_aux_coef x its aux / k."""
    ce = t_step.make_ce_terms(tcfg, remat=False, loss_chunk=0)
    b = _batch(batch)
    total_w = b["loss_mask"].sum().clamp(min=1.0)
    m = b["tokens"].shape[0] // k
    d = None if lora_tree is None else lora.deltas(lora_tree, lora_cfg)
    value = 0.0
    with torch.no_grad():
        for i in range(k):
            micro = {n: v[i * m:(i + 1) * m] for n, v in b.items()}
            loss, total, aux = ce(params, micro, d)
            if k > 1:
                loss = loss * total / total_w
            assert float(aux) >= tcfg.num_layers * 0.99
            value += float(loss) + tcfg.moe_aux_coef * float(aux) / k
    return value


@pytest.mark.parametrize("k", [1, 2])
def test_full_step_matches_reference(oracle, k):
    params0, want, want_params = oracle.full_steps(k)
    _, tcfg = _cfgs()
    to = make_optimizer(OptimizerConfig(**OPT))
    state = t_step.create_train_state(bridge.from_jax_numpy(tcfg, params0),
                                      to)
    first = _objective(tcfg, bridge.from_jax_numpy(tcfg, params0),
                       oracle.batches[0], k)
    step = t_step.make_train_step(tcfg, to, accumulate_steps=k)
    got = []
    for batch in oracle.batches:
        state, m = step(state, _batch(batch))
        got.append(m)
    np.testing.assert_allclose(got[0]["loss"].item(), first, rtol=TOL)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g["loss"].item(), w["loss"], rtol=TOL)
        np.testing.assert_allclose(g["grad_norm"].item(), w["grad_norm"],
                                   rtol=TOL)
        assert g["weight_tokens"].item() == w["weight_tokens"]
        assert g["nonfinite"] == int(w["nonfinite"]) == 0
    assert state.step == STEPS
    for a, b in zip(jax.tree.leaves(want_params), tree_leaves(state.params)):
        np.testing.assert_allclose(b.numpy(), a, atol=TOL)


@pytest.mark.parametrize("k", [1, 2])
def test_lora_step_matches_reference(oracle, k):
    base_np, lora0, want, want_lora = oracle.lora_steps(k)
    _, tcfg = _cfgs()
    lcfg = lora.LoraConfig(rank=4, alpha=8.0, targets=lora.ALL_TARGETS)
    base = bridge.from_jax_numpy(tcfg, base_np)
    # mlp.* targets: an MoE model has no "mlp" group, on either side.
    fresh = lora.init_lora(base, lcfg, torch.Generator().manual_seed(0))
    assert sorted(fresh) == sorted(lora0) == sorted(lora.DEFAULT_TARGETS)
    for t in fresh:
        for n in ("a", "b"):
            assert tuple(fresh[t][n].shape) == lora0[t][n].shape
    tl = bridge.tree_from_numpy(lora0)
    to = make_optimizer(OptimizerConfig(**OPT))
    state = t_step.TrainState(step=0, params=tl, opt_state=to.init(tl))
    first = _objective(tcfg, base, oracle.batches[0], k, tl, lcfg)
    step = lora.make_lora_train_step(tcfg, lcfg, to, accumulate_steps=k)
    got = []
    for batch in oracle.batches:
        state, m = step(state, base, _batch(batch))
        got.append(m)
    np.testing.assert_allclose(got[0]["loss"].item(), first, rtol=TOL)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g["loss"].item(), w["loss"], rtol=TOL)
        np.testing.assert_allclose(g["grad_norm"].item(), w["grad_norm"],
                                   rtol=TOL)
    for a, b in zip(jax.tree.leaves(want_lora), tree_leaves(state.params)):
        np.testing.assert_allclose(b.numpy(), a, atol=TOL)
    # The base is frozen.
    for a, b in zip(jax.tree.leaves(base_np), tree_leaves(base)):
        np.testing.assert_array_equal(b.numpy(), a)


@pytest.mark.parametrize("mode,k", [("full", 1), ("full", 2), ("lora", 2)])
def test_chunked_loss_step_matches_dense_step(oracle, mode, k):
    _, tcfg = _cfgs()
    params0 = oracle.full_steps(1)[0]
    lcfg = lora.LoraConfig(rank=4, alpha=8.0)
    out = []
    for chunk in (0, 8):
        to = make_optimizer(OptimizerConfig(**OPT))
        base = bridge.from_jax_numpy(tcfg, params0)
        if mode == "full":
            state = t_step.create_train_state(base, to)
            full = t_step.make_train_step(tcfg, to, accumulate_steps=k,
                                          loss_chunk=chunk)

            def step(s, b):
                return full(s, b)
        else:
            state = lora.create_lora_train_state(
                lcfg, base, to, torch.Generator().manual_seed(1))
            adapt = lora.make_lora_train_step(
                tcfg, lcfg, to, accumulate_steps=k, loss_chunk=chunk)

            def step(s, b):
                return adapt(s, base, b)
        losses = []
        for batch in oracle.batches:
            state, m = step(state, _batch(batch))
            losses.append((m["loss"].item(), m["grad_norm"].item()))
        out.append((losses, tree_leaves(state.params)))
    (dense, pd), (chunked, pc) = out
    np.testing.assert_allclose(np.array(chunked), np.array(dense), rtol=TOL)
    for a, b in zip(pd, pc):
        np.testing.assert_allclose(b.numpy(), a.numpy(), atol=TOL)


# ---------------------------------------------------------------------------
# Remat
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("policy", ["none"] + list(REMAT_POLICIES))
def test_remat_policy_routes_as_the_forward(oracle, policy, monkeypatch):
    """Full-parameter gradients with remat under ``policy`` (the flash
    path's plain K1-K3, so save_attn_out keeps K1's outputs) equal remat
    off's, and every recompute routes as its layer's forward did."""
    _, tcfg = _cfgs(attention_impl="flash", remat_policy=policy)
    params0 = oracle.full_steps(1)[0]
    batch = _batch(oracle.batches[0])
    calls = []
    route = moe.route

    def recording(cfg, probs, group=None):
        r = route(cfg, probs, group)
        calls.append((r.expert.clone(), r.slot.clone(), r.keep.clone(),
                      r.gate.detach().clone()))
        return r

    monkeypatch.setattr(moe, "route", recording)

    def grads(remat):
        params = t_step.trainable_copy(bridge.from_jax_numpy(tcfg, params0))
        ce = t_step.make_ce_terms(tcfg, remat=remat, loss_chunk=0)
        (loss, _), g = t_step.value_and_grad(
            ce, params, batch, aux_coef=t_step.moe_aux_coef(tcfg))
        return loss.item(), tree_leaves(g)

    loss_off, off = grads(False)
    L = tcfg.num_layers
    assert len(calls) == L
    calls.clear()
    loss_on, on = grads(True)
    assert loss_on == loss_off
    for a, b in zip(off, on):
        np.testing.assert_allclose(b.numpy(), a.numpy(), atol=REMAT_ATOL)
    if policy == "none":
        assert len(calls) == L
        return
    # The forward's layers 0..L-1, then the backward's recomputes L-1..0.
    assert len(calls) == 2 * L
    for li in range(L):
        fwd, rec = calls[li], calls[2 * L - 1 - li]
        assert all(torch.equal(a, b) for a, b in zip(fwd, rec)), li


# ---------------------------------------------------------------------------
# The trainer
# ---------------------------------------------------------------------------

def test_run_training_resume_equals_uninterrupted(tmp_path):
    docs = tmp_path / "docs.jsonl"
    rng = np.random.default_rng(0)
    with open(docs, "w") as f:
        for _ in range(60):
            f.write(json.dumps({"text": "".join(rng.choice(
                list("abcdefgh \n"), int(rng.integers(5, 200))))}) + "\n")

    def job(name, steps):
        return trainer.TrainJobConfig(
            model="debug", model_overrides={**MOE, "vocab_size": 512},
            seq_len=32, batch_size=4, accumulate_steps=2, steps=steps,
            log_every=1, checkpoint_every=50, data_path=str(docs),
            artifacts_dir=str(tmp_path / name),
            lora=lora.LoraConfig(rank=4, alpha=8.0),
            optimizer=OptimizerConfig(learning_rate=1e-2, warmup_steps=1,
                                      total_steps=3))

    whole = trainer.run_training(job("whole", 3), device="cpu")
    trainer.run_training(job("cut", 2), device="cpu")
    resumed = trainer.run_training(job("cut", 3), device="cpu")
    assert resumed["restored_step"] == 2
    assert [e["step"] for e in resumed["history"]] == [3]
    assert resumed["history"][0]["loss"] == whole["history"][2]["loss"]
    a = CheckpointManager(str(tmp_path / "whole")).restore_with_cursor(3)
    b = CheckpointManager(str(tmp_path / "cut")).restore_with_cursor(3)
    la = list(tree_leaves({"p": a[0]["params"], "o": a[0]["opt_state"]}))
    lb = list(tree_leaves({"p": b[0]["params"], "o": b[0]["opt_state"]}))
    assert len(la) == len(lb) > 0
    assert all(torch.equal(x, y) for x, y in zip(la, lb)
               if isinstance(x, torch.Tensor))
    losses = [e["loss"] for e in whole["history"]]
    assert all(np.isfinite(losses)) and losses[-1] < losses[0]
