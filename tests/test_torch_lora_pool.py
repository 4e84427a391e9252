"""The port's adapter-pool modules (runbooks_tpu_torch/ops/lora.py and
serve/lora_pool.py's pool side) against the JAX package's.

- ``grouped_lora_delta``, ``map_lane_indices``, ``target_dims`` and
  ``init_adapter_pool`` on the same seeded numpy inputs (f32 within 1e-5;
  lanes include -1 and out-of-range ones), and the forward with a pool
  against the JAX forward with the same pool.
- The forward gathers a dispatch's operands once (``gather_lanes``); the
  per-layer products on them equal ``grouped_lora_delta`` bit for bit.
- ``write_lane`` writes one lane in place (storage unchanged) and refuses a
  misfit before writing anything.
- ``load_adapter_tree`` on artifacts written from the same numpy A/B by
  each side's own ``save_adapter``: padding, scale fold, zero untrained
  targets, and each typed error.
- ``AdapterPool`` op for op against the JAX ``AdapterPool`` over seeded
  acquire/release sequences: lanes, residency, counters and lane contents.
"""

import dataclasses
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from runbooks_tpu.models.config import get_config as jax_get_config
from runbooks_tpu.models.transformer import forward as jax_forward
from runbooks_tpu.models.transformer import init_params as jax_init_params
from runbooks_tpu.ops import lora as jax_lora
from runbooks_tpu.serve import lora_pool as jax_lora_pool

from runbooks_tpu_torch.models import bridge
from runbooks_tpu_torch.models.config import get_config
from runbooks_tpu_torch.models.transformer import forward
from runbooks_tpu_torch.ops import lora
from runbooks_tpu_torch.serve import lora_pool

torch.set_num_threads(2)

CPU = torch.device("cpu")
TINY = dict(vocab_size=128, hidden_size=64, intermediate_size=128,
            num_layers=2, num_heads=4, num_kv_heads=2, head_dim=16,
            max_seq_len=64, dtype="float32", param_dtype="float32",
            adapter_pool=4, lora_rank=8)


def _cfgs(**over):
    return (dataclasses.replace(jax_get_config("llama2-7b"), **TINY, **over),
            dataclasses.replace(get_config("llama2-7b"), **TINY, **over))


def _np_adapter(cfg, targets, rank, seed):
    """{target: {"a": [L, d_in, r], "b": [L, r, d_out]}} f32 numpy, B
    non-zero."""
    rng = np.random.default_rng(seed)
    out = {}
    for t in targets:
        d_in, d_out = lora.target_dims(cfg, t)
        out[t] = {
            "a": (rng.standard_normal((cfg.num_layers, d_in, rank))
                  * d_in ** -0.5).astype(np.float32),
            "b": (0.05 * rng.standard_normal(
                (cfg.num_layers, rank, d_out))).astype(np.float32)}
    return out


def _save_both(root, name, tree, rank, alpha):
    """The same numpy adapter as one artifact per side, each written by
    its own save_adapter. Returns (jax path, port path)."""
    jpath, tpath = os.path.join(root, "jax", name), os.path.join(
        root, "torch", name)
    jax_lora_pool.save_adapter(
        jpath, {t: {k: jnp.asarray(v) for k, v in ab.items()}
                for t, ab in tree.items()}, rank=rank, alpha=alpha)
    lora_pool.save_adapter(
        tpath, {t: {k: torch.from_numpy(v) for k, v in ab.items()}
                for t, ab in tree.items()}, rank=rank, alpha=alpha)
    return jpath, tpath


def _flat(tree):
    """Nested pool-layout tree -> {"attn.wq.a": numpy f32}."""
    return {f"{g}.{n}.{k}": (v.float().numpy() if torch.is_tensor(v)
                             else np.asarray(v, np.float32))
            for g, sub in tree.items() for n, ab in sub.items()
            for k, v in ab.items()}


# ---------------------------------------------------------------------------
# ops/lora.py
# ---------------------------------------------------------------------------

def test_target_dims_and_pool_shapes_match_jax():
    jcfg, tcfg = _cfgs()
    for t in ("attn.wq", "attn.wk", "attn.wv", "attn.wo", "mlp.wi_gate",
              "mlp.wi_up", "mlp.wo"):
        assert lora.target_dims(tcfg, t) == jax_lora.target_dims(jcfg, t)
    for mod, cfg in ((lora, tcfg), (jax_lora, jcfg)):
        with pytest.raises(ValueError, match="mlp.wi"):
            mod.target_dims(cfg, "mlp.wi")
    assert lora.ADAPTER_TARGETS == jax_lora.ADAPTER_TARGETS
    targets = ("attn.wq", "attn.wo", "mlp.wi_up")
    got = lora.init_adapter_pool(tcfg, 3, 8, targets, CPU)
    want = jax_lora.init_adapter_pool(jcfg, 3, 8, targets)
    assert {k: tuple(v.shape) for k, v in _flat(got).items()} == \
        {k: tuple(v.shape) for k, v in _flat(want).items()}
    assert all(not v.any() for v in _flat(got).values())
    assert next(iter(got["attn"].values()))["a"].dtype == torch.float32
    assert lora.pool_lanes(got) == jax_lora.pool_lanes(want) == 4
    assert lora.pool_lanes({"attn": {"wq": {
        "a": got["attn"]["wq"]["a"][0], "b": got["attn"]["wq"]["b"][0]}}}) \
        == 4
    for bad in ({"pool_size": 0}, {"rank": 0}):
        kw = {"pool_size": 2, "rank": 4, **bad}
        with pytest.raises(ValueError):
            lora.init_adapter_pool(tcfg, kw["pool_size"], kw["rank"],
                                   targets, CPU)


def test_map_lane_indices_matches_jax():
    idx = np.array([-1, 0, 3, 4, 7, -5, 2], np.int32)
    got = lora.map_lane_indices(torch.from_numpy(idx), 5)
    want = jax_lora.map_lane_indices(jnp.asarray(idx), 5)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert got.tolist() == [4, 0, 3, 4, 4, 4, 2]


@pytest.mark.parametrize("seq", [1, 5])
def test_grouped_lora_delta_matches_jax(seq):
    rng = np.random.default_rng(seq)
    lanes, d_in, r, d_out = 5, 48, 8, 40
    a = rng.standard_normal((lanes, d_in, r)).astype(np.float32)
    b = rng.standard_normal((lanes, r, d_out)).astype(np.float32)
    a[-1] = 0.0   # the trash lane
    b[-1] = 0.0
    x = rng.standard_normal((6, seq, d_in)).astype(np.float32)
    raw = np.array([2, -1, 0, 9, 3, -1], np.int32)
    want = jax_lora.grouped_lora_delta(
        jnp.asarray(x), {"a": jnp.asarray(a), "b": jnp.asarray(b)},
        jax_lora.map_lane_indices(jnp.asarray(raw), lanes), jnp.float32)
    got = lora.grouped_lora_delta(
        torch.from_numpy(x), {"a": torch.from_numpy(a),
                              "b": torch.from_numpy(b)},
        lora.map_lane_indices(torch.from_numpy(raw), lanes), torch.float32)
    assert got.shape == (6, seq, d_out) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-5)
    # Base-only rows (-1, and the clipped 9) gather the zero lane.
    assert not got[[1, 3, 5]].any()


def test_gathered_operands_equal_the_per_layer_form():
    """The forward's once-per-dispatch gather, then the per-layer
    products, is grouped_lora_delta on that layer's slice bit for bit, in
    f32 and bf16."""
    _, tcfg = _cfgs()
    g = torch.Generator().manual_seed(0)
    for dtype in (torch.float32, torch.bfloat16):
        pool = lora.init_adapter_pool(tcfg, 3, 8, ("attn.wq", "mlp.wo"), CPU)
        for sub in pool.values():
            for ab in sub.values():
                for k in ("a", "b"):
                    ab[k] = torch.randn(ab[k].shape, generator=g).to(dtype)
                    ab[k][:, -1] = 0
        idx = lora.map_lane_indices(torch.tensor([1, -1, 0, 2]), 4)
        rows = lora.gather_lanes(pool, idx)
        for group, name in (("attn", "wq"), ("mlp", "wo")):
            d_in = pool[group][name]["a"].shape[2]
            x = torch.randn((4, 3, d_in), generator=g).to(dtype)
            for li in range(tcfg.num_layers):
                a_sel, b_sel = rows[group][name]
                per_layer = lora.grouped_lora_delta(
                    x, {k: v[li] for k, v in pool[group][name].items()},
                    idx, dtype)
                assert torch.equal(
                    lora.lane_delta(x, a_sel[li], b_sel[li], dtype),
                    per_layer)


@pytest.fixture(scope="module")
def weights():
    jcfg, tcfg = _cfgs(lora_targets=("attn.wq", "attn.wk", "attn.wv",
                                     "attn.wo", "mlp.wi_gate", "mlp.wo"))
    jparams = jax_init_params(jcfg, jax.random.key(0))
    tparams = bridge.from_jax_numpy(tcfg, jax.tree.map(np.asarray, jparams))
    return jcfg, jparams, tcfg, tparams


def test_forward_with_adapters_matches_jax(weights):
    """The whole forward with a pool (attention and MLP targets, two
    adapters written into lanes 0 and 2, rows on lanes 2, -1, 0 and an
    out-of-range one) against the JAX forward, logits within 1e-4; the
    base-only rows equal the port's forward without a pool."""
    jcfg, jparams, tcfg, tparams = weights
    targets = tcfg.lora_targets
    jpool = jax_lora.init_adapter_pool(jcfg, 3, 8, targets)
    tpool = lora.init_adapter_pool(tcfg, 3, 8, targets, CPU)
    write = jax.jit(jax_lora.make_pool_write_fn())
    for lane, seed in ((0, 1), (2, 2)):
        ad = lora.nest_targets(_np_adapter(tcfg, targets, 8, seed))
        jpool = write(jpool, jax.tree.map(jnp.asarray, ad), jnp.int32(lane))
        lora.write_lane(tpool, jax.tree.map(torch.from_numpy, ad), lane)
    tokens = np.random.default_rng(3).integers(0, 128, (4, 7)).astype(
        np.int32)
    lanes = np.array([2, -1, 0, 11], np.int32)
    want, _ = jax_forward(jcfg, jparams, jnp.asarray(tokens),
                          adapters=(jpool, jnp.asarray(lanes)))
    got, _ = forward(tcfg, tparams, torch.from_numpy(tokens),
                     adapters=(tpool, torch.from_numpy(lanes)))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-4,
                               atol=1e-4)
    base, _ = forward(tcfg, tparams, torch.from_numpy(tokens))
    assert torch.equal(got[[1, 3]], base[[1, 3]])
    assert not torch.allclose(got[[0, 2]], base[[0, 2]], atol=1e-3)


def test_write_lane_is_in_place_and_refuses_misfits():
    _, tcfg = _cfgs()
    targets = ("attn.wq", "attn.wv")
    pool = lora.init_adapter_pool(
        dataclasses.replace(tcfg, dtype="bfloat16"), 2, 8, targets, CPU)
    ptrs = [v.data_ptr() for sub in pool.values() for ab in sub.values()
            for v in ab.values()]
    ad = {k: {n: {x: torch.from_numpy(t) for x, t in ab.items()}
              for n, ab in sub.items()}
          for k, sub in lora.nest_targets(
              _np_adapter(tcfg, targets, 8, 0)).items()}
    lora.write_lane(pool, ad, 1)
    assert [v.data_ptr() for sub in pool.values() for ab in sub.values()
            for v in ab.values()] == ptrs
    for name in ("wq", "wv"):
        for k in ("a", "b"):
            leaf = pool["attn"][name][k]
            assert leaf.dtype == torch.bfloat16
            assert torch.equal(leaf[:, 1], ad["attn"][name][k].to(
                torch.bfloat16))
            assert not leaf[:, 0].any() and not leaf[:, 2].any()
    before = {n: pool["attn"][n]["a"][:, 0].clone() for n in ("wq", "wv")}
    bad = {"attn": {"wq": ad["attn"]["wq"],
                    "wv": {"a": ad["attn"]["wv"]["a"],
                           "b": ad["attn"]["wv"]["b"][:, :4]}}}
    with pytest.raises(ValueError, match="does not fit"):
        lora.write_lane(pool, bad, 0)
    for n in ("wq", "wv"):       # nothing was written, wq included
        assert torch.equal(pool["attn"][n]["a"][:, 0], before[n])
    with pytest.raises(ValueError, match="trash lane"):
        lora.write_lane(pool, ad, 2)


# ---------------------------------------------------------------------------
# serve/lora_pool.py: load_adapter_tree
# ---------------------------------------------------------------------------

def test_load_adapter_tree_matches_jax(tmp_path):
    """A rank-4, alpha-8 adapter training two of three pool targets in a
    rank-8 pool: padded, scale folded into B, the untrained target zero,
    leaf for leaf the JAX loader's (exactly: a power-of-two scale)."""
    jcfg, tcfg = _cfgs()
    targets = ("attn.wq", "attn.wv", "attn.wo")
    tree = _np_adapter(tcfg, ("attn.wq", "attn.wo"), 4, 5)
    jpath, tpath = _save_both(str(tmp_path), "a", tree, rank=4, alpha=8.0)
    want = _flat(jax_lora_pool.load_adapter_tree(jpath, jcfg, targets, 8))
    got_tree = lora_pool.load_adapter_tree(tpath, tcfg, targets, 8)
    got = _flat(got_tree)
    assert sorted(got) == sorted(want)
    for k in want:
        assert got[k].shape == want[k].shape, k
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    assert all(v.dtype == torch.float32 and v.device == CPU
               for sub in got_tree.values() for ab in sub.values()
               for v in ab.values())
    np.testing.assert_array_equal(got["attn.wq.b"][:, :4],
                                  tree["attn.wq"]["b"] * 2.0)
    assert not got["attn.wq.a"][:, :, 4:].any()
    assert not got["attn.wv.a"].any() and not got["attn.wv.b"].any()


def _broken(root):
    from runbooks_tpu.train.checkpoint import CheckpointManager as JaxCkpt

    from runbooks_tpu_torch.train.checkpoint import CheckpointManager

    jpath, tpath = os.path.join(root, "jax"), os.path.join(root, "torch")
    mgr = JaxCkpt(jpath)
    try:
        mgr.save(0, {"params": {"attn.wq": np.zeros((2, 64, 4),
                                                    np.float32)}},
                 force=True)
        mgr.wait()
    finally:
        mgr.close()
    os.makedirs(tpath)
    CheckpointManager(tpath).save(
        0, {"params": {"attn.wq": torch.zeros(2, 64, 4)}}, force=True)
    return jpath, tpath


@pytest.mark.parametrize("case", [
    "missing", "no_checkpoints", "malformed", "extra_target",
    "meta_rank", "rank_above_bucket", "shape"])
def test_load_adapter_tree_errors_match_jax(tmp_path, case):
    jcfg, tcfg = _cfgs()
    targets = ("attn.wq", "attn.wv")
    root = str(tmp_path)
    match = {"missing": "no such directory",
             "no_checkpoints": "no checkpoints/",
             "malformed": "not an .a, b. LoRA",
             "extra_target": "does not inject",
             "meta_rank": "does not match checkpoint rank",
             "rank_above_bucket": "rank 16 exceeds",
             "shape": "do not match model"}[case]
    if case == "missing":
        jpath = tpath = os.path.join(root, "nope")
    elif case == "no_checkpoints":
        os.makedirs(os.path.join(root, "empty"))
        jpath = tpath = os.path.join(root, "empty")
    elif case == "malformed":
        jpath, tpath = _broken(root)
    else:
        rank = 16 if case == "rank_above_bucket" else 4
        tree = _np_adapter(tcfg, ("attn.wq",) + (
            ("attn.wo",) if case == "extra_target" else ()), rank, 0)
        if case == "shape":
            tree["attn.wq"]["a"] = tree["attn.wq"]["a"][:, :32]
        jpath, tpath = _save_both(root, "x", tree, rank=rank, alpha=8.0)
        if case == "meta_rank":
            for p in (jpath, tpath):
                with open(os.path.join(p, "lora.json"), "w") as f:
                    f.write('{"rank": 2, "alpha": 8.0}')
    with pytest.raises(jax_lora_pool.AdapterLoadError, match=match):
        jax_lora_pool.load_adapter_tree(jpath, jcfg, targets, 8)
    with pytest.raises(lora_pool.AdapterLoadError, match=match):
        lora_pool.load_adapter_tree(tpath, tcfg, targets, 8)


# ---------------------------------------------------------------------------
# serve/lora_pool.py: AdapterPool, op for op
# ---------------------------------------------------------------------------

NAMES = ["t0", "t1", "t2", "t3", "t4", "bad"]


def _pool_trace(mod, cfg, trees, seed, **kw):
    """A seeded acquire/release sequence over a 3-lane pool: each op's
    result, then residency, pins and counters."""
    def loader(path):
        name = os.path.basename(path)
        if name == "bad":
            raise mod.AdapterLoadError(f"adapter {path!r}: corrupt")
        return trees[name]

    pool = mod.AdapterPool(dataclasses.replace(cfg, adapter_pool=3),
                           root="/adapters", loader=loader, **kw)
    rng = np.random.default_rng(seed)
    held, out = [], []
    for _ in range(80):
        if rng.random() < 0.55 or not held:
            name = NAMES[int(rng.integers(0, len(NAMES)))]
            try:
                lane = pool.acquire(name)
                out.append(("acquire", name, lane))
                if lane is not None:
                    held.append(lane)
            except mod.AdapterLoadError as exc:
                out.append(("error", name, str(exc)))
        else:
            lane = held.pop(int(rng.integers(0, len(held))))
            pool.release(lane)
            out.append(("release", lane))
        out.append((pool.resident(), list(pool._lane_ref), pool.loads,
                    pool.evictions, pool.hits))
    for name in NAMES:
        pool.count_request(name)
    out.append(pool.stats())
    out.append((pool.resolve("t0"), pool.resolve("/abs/t0"),
                pool.can_resolve("t0" if "t0" in pool.resident() else
                                 "zz") is None))
    free = [lane for lane in range(3) if pool._lane_ref[lane] == 0]
    if free:
        with pytest.raises(RuntimeError, match="unpinned"):
            pool.release(free[0])
    pool.reset_refs()
    out.append(list(pool._lane_ref))
    return out, pool


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_adapter_pool_matches_jax_op_for_op(seed):
    """Same sequence, same lanes, residency, pins and counters; each
    lane's contents equal the JAX pool's (the resident adapter's padded
    tree) and the trash lane stays zero. A load failure evicts nothing."""
    jcfg, tcfg = _cfgs()
    flat = {n: _np_adapter(tcfg, tcfg.lora_targets, 8, i)
            for i, n in enumerate(NAMES[:-1])}
    ttrees = {n: lora.nest_targets({t: {k: torch.from_numpy(v)
                                        for k, v in ab.items()}
                                    for t, ab in f.items()})
              for n, f in flat.items()}
    jtrees = {n: jax_lora.nest_targets({t: {k: jnp.asarray(v)
                                            for k, v in ab.items()}
                                        for t, ab in f.items()})
              for n, f in flat.items()}
    got, tpool = _pool_trace(lora_pool, tcfg, ttrees, seed, device=CPU)
    want, jpool = _pool_trace(jax_lora_pool, jcfg, jtrees, seed)
    assert got == want
    assert tpool.loads > 3 and tpool.evictions > 0 and tpool.hits > 0
    assert any(op[0] == "error" for op in got if isinstance(op, tuple))
    assert tpool.pool_bytes() == jpool.pool_bytes()
    tflat, jflat = _flat(tpool.tree), _flat(jpool.tree)
    for k in jflat:
        np.testing.assert_array_equal(tflat[k], jflat[k], err_msg=k)
        assert not tflat[k][:, -1].any()
    for lane, name in enumerate(tpool._lane_name):
        if name is not None:
            np.testing.assert_array_equal(
                tflat["attn.wq.a"][:, lane], flat[name]["attn.wq"]["a"])


def test_adapter_pool_construction_errors():
    _, tcfg = _cfgs()
    with pytest.raises(ValueError, match="mlp.wi"):
        lora_pool.AdapterPool(dataclasses.replace(
            tcfg, lora_targets=("mlp.wi",)), device=CPU)
    with pytest.raises(ValueError, match="pool_size"):
        lora_pool.AdapterPool(tcfg, pool_size=0, device=CPU)
    pool = lora_pool.AdapterPool(tcfg, device=CPU)
    assert (pool.pool_size, pool.rank) == (4, 8)
    assert pool.pool_bytes() == sum(
        2 * 4 * 5 * 8 * sum(lora.target_dims(tcfg, t))
        for t in tcfg.lora_targets)
    # warm() writes zeros into the empty lane 0 and leaves the pool zero.
    pool.warm()
    assert all(not v.any() for v in _flat(pool.tree).values())
