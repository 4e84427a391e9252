"""The port's parallel/{distributed,mesh,sharding} against the reference's
runbooks_tpu.parallel, and the head-granular serving plan.

- logical_to_spec / spec_for_array / tree_shardings give the reference's
  PartitionSpecs (as plain tuples) over a table of shapes and meshes of the
  conftest's 8 virtual CPU devices, the divisibility degrade included;
- MeshConfig.resolve raises the reference's errors; env_process_info,
  process_index and is_primary read the operator's env as the reference's;
- param_logical_axes, quantized_logical_axes and adapter_pool_logical_axes
  equal the reference's;
- serve_plan never splits a head: a count the tensor axis does not divide
  replicates its side (falcon-7b at tp 2 and 4); the non-uniform q -> kv
  map of q heads sharded over replicated kv heads (6 on 3 at tp 2);
- shard_params' pieces put back together are the full tree, and where the
  reference's mesh cuts a leaf at head boundaries the port's rank shard is
  the reference's device shard; serve/api.load_model(shard=) materialises
  that shard alone (random init, checkpoint, adapter fold) and equals it.
"""

import dataclasses

import jax
import numpy as np
import pytest
import torch

from runbooks_tpu.models.config import get_config as jax_get_config
from runbooks_tpu.models.transformer import init_params as jax_init
from runbooks_tpu.models.transformer import \
    param_logical_axes as jax_param_axes
from runbooks_tpu.ops import lora as jax_lora
from runbooks_tpu.ops import quantization as jax_quant
from runbooks_tpu.parallel import distributed as jax_dist
from runbooks_tpu.parallel import mesh as jax_mesh
from runbooks_tpu.parallel import sharding as jax_sharding
from runbooks_tpu_torch.models import bridge
from runbooks_tpu_torch.models.config import get_config
from runbooks_tpu_torch.models.transformer import init_params
from runbooks_tpu_torch.models.transformer import param_logical_axes
from runbooks_tpu_torch.ops import lora as port_lora
from runbooks_tpu_torch.ops import quantization as port_quant
from runbooks_tpu_torch.parallel import distributed, mesh, sharding
from runbooks_tpu_torch.utils.tree import tree_leaves

MESHES = [dict(data=1, fsdp=4, tensor=2), dict(fsdp=8), dict(fsdp=2, tensor=4),
          dict(data=2, fsdp=2, tensor=2), dict(fsdp=1, tensor=8),
          dict(data=2, fsdp=1, sequence=2, tensor=2)]

SHAPES = [
    ((512, 128), ("vocab", "embed")),
    ((128, 512), ("embed", "vocab")),
    ((2, 128, 128), ("layers", "embed", "heads")),
    ((2, 128, 64), ("layers", "embed", "kv_heads")),
    ((2, 128, 96), ("layers", "embed", "heads")),     # 96 % 8: degrade
    ((2, 384, 128), ("layers", "mlp", "embed")),
    ((2, 4544, 4544), ("layers", "embed", "heads")),  # falcon-7b's wq
    ((6, 3), ("embed", None)),                        # nothing divides
    ((8, 16), ("batch", "seq")),
    ((2, 16), ("batch", "seq")),                      # tuple degrade
    ((4, 16), ("embed", None)),
    ((8, 16, 4, 32), ("batch", "seq", "act_heads", None)),
    ((8, 16), ("batch",)),                            # trailing None
    ((2, 8, 8), ("experts", "embed", "mlp")),
    ((16, 16), ("batch", "embed")),                   # fsdp used once
]


@pytest.fixture(scope="module")
def ref_meshes():
    return [jax_mesh.make_mesh(jax_mesh.MeshConfig(**m)) for m in MESHES]


@pytest.mark.parametrize("logical", sorted({lg for _, lg in SHAPES}, key=str))
def test_logical_to_spec_matches_reference(logical):
    assert sharding.logical_to_spec(logical) == \
        tuple(jax_sharding.logical_to_spec(logical))


@pytest.mark.parametrize("mi", range(len(MESHES)))
def test_spec_for_array_matches_reference(ref_meshes, mi):
    port_mesh = mesh.MeshConfig(**MESHES[mi]).resolve(8)
    for shape, logical in SHAPES:
        want = jax_sharding.spec_for_array(shape, logical, ref_meshes[mi])
        got = sharding.spec_for_array(shape, logical, port_mesh)
        assert got == tuple(want) + (None,) * (len(got) - len(want)), (
            shape, logical, MESHES[mi], got, want)
    # A mapping of axis sizes works as a mesh; absent axes drop.
    assert sharding.spec_for_array((8, 8), ("heads", "embed"),
                                   {"tensor": 2}) == ("tensor", None)


def _cfgs():
    base = dict(vocab_size=512, hidden_size=128, intermediate_size=384,
                num_layers=2, num_heads=4, num_kv_heads=2, head_dim=32,
                max_seq_len=64)
    return {"debug": ("debug", base),
            "falcon-7b": ("falcon-7b", dict(base, num_heads=4,
                                            num_kv_heads=1)),
            "gpt2": ("gpt2", dict(base, num_kv_heads=4)),
            "opt-125m": ("opt-125m", dict(base, num_kv_heads=4))}


@pytest.mark.parametrize("name", sorted(_cfgs()))
def test_param_logical_axes_and_tree_shardings_match_reference(
        ref_meshes, name):
    model, over = _cfgs()[name]
    jcfg = jax_get_config(model, **over)
    tcfg = get_config(model, **over)
    assert param_logical_axes(tcfg) == jax.tree.map(
        lambda x: x, jax_param_axes(jcfg),
        is_leaf=lambda x: isinstance(x, tuple))
    shapes = init_params(tcfg, None, torch.device("meta"))
    jshapes = jax.eval_shape(lambda: jax_init(jcfg, jax.random.key(0)))
    for mi in (0, 2, 4):
        want = jax_sharding.tree_shardings(jshapes, jax_param_axes(jcfg),
                                           ref_meshes[mi])
        got = sharding.tree_shardings(
            shapes, param_logical_axes(tcfg),
            mesh.MeshConfig(**MESHES[mi]).resolve(8))
        w = [tuple(s.spec) for s in jax.tree.leaves(want)]
        g = list(tree_leaves(got))
        assert [x + (None,) * (len(y) - len(x)) for x, y in zip(w, g)] == g


def test_quantized_and_adapter_pool_axes_match_reference(ref_meshes):
    model, over = _cfgs()["debug"]
    jcfg = jax_get_config(model, **over)
    tcfg = get_config(model, **over)
    jparams = jax_quant.quantize_params(
        jax_init(jcfg, jax.random.key(0)), "int8", block_size=32)
    tparams = port_quant.quantize_params(
        init_params(tcfg, torch.Generator().manual_seed(0),
                    torch.device("cpu")), "int8", block_size=32)
    want = jax_quant.quantized_logical_axes(jparams, jax_param_axes(jcfg))
    got = port_quant.quantized_logical_axes(tparams,
                                            param_logical_axes(tcfg))

    def flat(tree, quant):
        out = {}

        def walk(t, pre):
            if isinstance(t, dict):
                for k in t:
                    walk(t[k], pre + (k,))
            elif isinstance(t, quant):
                out[pre + ("values",)] = tuple(t.values)
                out[pre + ("scales",)] = tuple(t.scales)
            else:
                out[pre] = tuple(t)
        walk(tree, ())
        return out

    assert flat(got, port_quant.QuantizedArray) == \
        flat(want, jax_quant.QuantizedArray)
    # tree_shardings maps a QuantizedArray's values and scales apart.
    specs = sharding.tree_shardings(tparams, got,
                                    mesh.MeshConfig(**MESHES[0]).resolve(8))
    wq = specs["layers"]["attn"]["wq"]
    assert wq.values == ("stage", "fsdp", "tensor")
    assert wq.scales == ("stage", None, "tensor")

    targets = ("attn.wq", "attn.wv", "mlp.wi_up", "mlp.wo")
    jpool = jax_lora.init_adapter_pool(jcfg, 2, 4, targets)
    tpool = port_lora.init_adapter_pool(tcfg, 2, 4, targets,
                                        torch.device("cpu"))
    assert port_lora.adapter_pool_logical_axes(tpool) == \
        jax_lora.adapter_pool_logical_axes(jpool)


@pytest.mark.parametrize("axes,n,err", [
    (dict(fsdp=-1, data=-1), 8, "at most one -1 axis"),
    (dict(fsdp=-1, tensor=3), 8, "not divisible by fixed axes product 3"),
    (dict(fsdp=1, tensor=4), 8, "needs 4 devices but 8 available"),
    (dict(fsdp=2, tensor=2), 8, "needs 4 devices"),
])
def test_mesh_config_resolve_errors_match_reference(axes, n, err):
    with pytest.raises(ValueError, match=err) as port:
        mesh.MeshConfig(**axes).resolve(n)
    with pytest.raises(ValueError) as ref:
        jax_mesh.MeshConfig(**axes).resolve(n)
    assert str(port.value) == str(ref.value)


def test_mesh_config_resolve_matches_reference():
    for axes in (dict(), dict(tensor=2), dict(data=2, tensor=2),
                 dict(fsdp=1, tensor=8)):
        assert dataclasses.asdict(mesh.MeshConfig(**axes).resolve(8)) == \
            dataclasses.asdict(jax_mesh.MeshConfig(**axes).resolve(8))
    assert mesh.MESH_AXES == jax_mesh.MESH_AXES


@pytest.mark.parametrize("axis", ["data", "fsdp", "sequence"])
def test_serving_mesh_refuses_other_axes_by_name(axis):
    with pytest.raises(NotImplementedError, match=f"mesh_{axis}=2"):
        mesh.check_serving_mesh(
            mesh.MeshConfig(**{"fsdp": 1, axis: 2}).resolve(2))
    with pytest.raises(ValueError, match="pipeline \\(stage\\)"):
        mesh.check_serving_mesh(mesh.MeshConfig(fsdp=1, stage=2).resolve(2))
    mesh.check_serving_mesh(mesh.MeshConfig(fsdp=1, tensor=4).resolve(4))


def test_serving_mesh_takes_the_expert_axis():
    """mesh_expert serves (an MoE model's experts shard over it; a dense
    model replicates over it, as the reference drops an axis no
    dimension uses); training still refuses it by name."""
    for axes in (dict(expert=2), dict(expert=2, tensor=2),
                 dict(expert=8, tensor=2)):
        mc = mesh.MeshConfig(fsdp=1, **axes)
        mesh.check_serving_mesh(mc)
        mesh.check_mesh_model(get_config("llama3-8b"), mc, serving=True)
        mesh.check_mesh_model(get_config("mixtral-8x7b"), mc, serving=True)
        with pytest.raises(NotImplementedError, match="mesh_expert="):
            mesh.check_training_mesh(mc)
    plan = sharding.serve_plan(get_config("llama3-8b"), 2, 2)
    assert not plan.experts and plan.expert_range(3) == range(0)
    assert plan.q_heads(3) == plan.q_heads(1)


@pytest.mark.parametrize("name", ["gemma-2b", "gemma-7b"])
def test_gemma_under_a_serving_mesh_is_refused_by_name(name):
    """Gemma serves on one device only: mesh_tensor above 1 is refused by
    name where params.json is read (serve/api.refuse_unported, before
    any rank starts) and by the mesh check itself; one device and the
    other families pass."""
    from runbooks_tpu_torch.serve import api

    with pytest.raises(NotImplementedError,
                       match=r"mesh_tensor=2: .*gemma under a mesh"):
        api.refuse_unported({"model": name, "mesh_tensor": 2})
    with pytest.raises(NotImplementedError, match="gemma under a mesh"):
        mesh.check_mesh_model(get_config(name),
                              mesh.MeshConfig(fsdp=1, tensor=4))
    mesh.check_mesh_model(get_config(name), mesh.MeshConfig(fsdp=1))
    mesh.check_mesh_model(get_config("llama3-8b"),
                          mesh.MeshConfig(fsdp=1, tensor=4))
    api.refuse_unported({"model": name, "mesh_tensor": 1})


@pytest.mark.parametrize("env", [
    {},
    {"JAX_COORDINATOR_ADDRESS": "job-0.svc:8476", "JAX_NUM_PROCESSES": "4",
     "JAX_PROCESS_ID": "2"},
    {"JAX_COORDINATOR_ADDRESS": "h:1", "JAX_NUM_PROCESSES": "2",
     "JAX_PROCESS_ID": "0"},
    {"JAX_NUM_PROCESSES": "2", "JAX_PROCESS_ID": "1"},
])
def test_env_process_info_matches_reference(monkeypatch, env):
    for k in ("JAX_COORDINATOR_ADDRESS", "JAX_NUM_PROCESSES",
              "JAX_PROCESS_ID"):
        monkeypatch.delenv(k, raising=False)
    for k, v in env.items():
        monkeypatch.setenv(k, v)
    assert distributed.env_process_info() == jax_dist.env_process_info()
    assert distributed.process_index() == jax_dist.process_index()
    assert distributed.is_primary() == jax_dist.is_primary()


@pytest.mark.parametrize("model,over,tensor,want", [
    ("debug", dict(num_heads=4, num_kv_heads=2), 2, (True, True, True, True)),
    ("debug", dict(num_heads=6, num_kv_heads=3, hidden_size=192), 2,
     (True, False, True, True)),
    ("llama3-8b", {}, 2, (True, True, True, True)),
    ("llama3-8b", {}, 16, (True, False, True, True)),
    ("falcon-7b", {}, 2, (False, False, True, True)),
    ("falcon-7b", {}, 4, (False, False, True, True)),
    ("falcon-40b", {}, 4, (True, True, True, True)),
    ("llama2-7b", {}, 4, (True, True, True, True)),
    ("gpt2", {}, 4, (True, True, True, False)),
    ("debug", {}, 1, (False, False, False, False)),
])
def test_serve_plan_never_splits_a_head(model, over, tensor, want):
    cfg = get_config(model, **over)
    plan = sharding.serve_plan(cfg, tensor)
    assert (plan.heads, plan.kv_heads, plan.mlp, plan.vocab) == want
    for r in range(tensor):
        q = plan.q_heads(r)
        assert len(q) * (tensor if plan.heads else 1) == cfg.num_heads
        kv = plan.kv_head_ids(r)
        rep = cfg.num_heads // cfg.num_kv_heads
        # Every local q head's kv head is held locally.
        assert all(kv.start <= i // rep < kv.stop for i in q)
    if model == "falcon-7b":
        # 71 heads: the reference's spec shards wq's flattened 4544
        # columns (splitting a head at tp 2); the port replicates them.
        ref = jax_sharding.spec_for_array(
            (32, 4544, 4544), ("layers", "embed", "heads"),
            jax_mesh.make_mesh(jax_mesh.MeshConfig(fsdp=1, tensor=tensor),
                               jax.devices()[:tensor]))
        assert tuple(ref)[2] == "tensor" and not plan.heads


def test_non_uniform_kv_map():
    cfg = get_config("debug", num_heads=6, num_kv_heads=3, hidden_size=192)
    plan = sharding.serve_plan(cfg, 2)
    # q0-2 read kv 0, 0, 1; q3-5 read kv 1, 2, 2.
    assert [list(plan.kv_head_ids(r)) for r in (0, 1)] == [[0, 1], [1, 2]]
    assert [plan.kv_map(r) for r in (0, 1)] == [(0, 0, 1), (0, 1, 1)]
    # Uniform maps need no repeat: both sides shard, or each rank's q
    # heads read one kv head (32 on 8 at tp 16: two q heads per rank).
    assert sharding.serve_plan(get_config("debug"), 2).kv_map(1) is None
    p16 = sharding.serve_plan(get_config("llama3-8b"), 16)
    assert [list(p16.kv_head_ids(r)) for r in (0, 5)] == [[0], [2]]
    assert p16.kv_map(5) is None


@pytest.mark.parametrize("model,over,tensor", [
    ("debug", dict(num_heads=4, num_kv_heads=2, vocab_size=512), 2),
    ("debug", dict(num_heads=6, num_kv_heads=3, hidden_size=192), 2),
    ("falcon-7b", dict(num_layers=2, hidden_size=96, num_heads=3,
                       num_kv_heads=1, head_dim=32, intermediate_size=256,
                       vocab_size=512), 2),
    ("gpt2", dict(num_layers=2, hidden_size=128, num_heads=4,
                  num_kv_heads=4, head_dim=32, intermediate_size=256,
                  vocab_size=512, max_seq_len=64), 4),
])
def test_shard_params_cuts_whole_heads(model, over, tensor):
    jcfg = jax_get_config(model, **over)
    tcfg = get_config(model, **over)
    jparams = jax_init(jcfg, jax.random.key(0))
    full = bridge.from_jax_numpy(tcfg, jax.tree.map(np.asarray, jparams))
    plan = sharding.serve_plan(tcfg, tensor)
    shards = [sharding.shard_params(full, plan, r) for r in range(tensor)]
    axes = param_logical_axes(tcfg)
    leaves = list(tree_leaves(full))
    for r, sh in enumerate(shards):
        assert sum(t.numel() * t.element_size() for t in tree_leaves(sh)) \
            == plan.local_param_bytes(full, r)
    for i, (leaf, ax) in enumerate(zip(leaves, tree_leaves(axes))):
        parts = [list(tree_leaves(sh))[i] for sh in shards]
        cut = [d for d, name in enumerate(ax)
               if parts[0].shape[d] != leaf.shape[d]]
        if not cut:
            assert all(torch.equal(p, leaf) for p in parts)
            continue
        (d,) = cut
        name = ax[d]
        if name == "kv_heads" and not plan.kv_heads:
            continue    # overlapping kv heads (the non-uniform map)
        assert torch.equal(torch.cat(parts, d), leaf), (ax, name)
    if plan.heads and plan.kv_heads and tensor == 2:
        # Where the reference's mesh cuts at head boundaries, the port's
        # rank shard is the reference device's shard.
        ref_mesh = jax_mesh.make_mesh(
            jax_mesh.MeshConfig(data=1, fsdp=1, tensor=2),
            jax.devices()[:2])
        specs = jax_sharding.tree_shardings(
            jax.eval_shape(lambda: jparams), jax_param_axes(jcfg), ref_mesh)
        wq = jax.device_put(jparams["layers"]["attn"]["wq"],
                            specs["layers"]["attn"]["wq"])
        for shard in wq.addressable_shards:
            r = shard.index[2].start // (wq.shape[2] // 2)
            np.testing.assert_array_equal(
                np.asarray(shard.data),
                shards[r]["layers"]["attn"]["wq"].numpy())


def test_shard_params_refuses_quantized_weights():
    """Quantized weights a rank would cut off a block are refused by
    name: the debug config's wo quantizes its 128 rows in one block,
    which tensor 2 would cut at 64. (Cuts on blocks are served:
    tests/test_torch_mesh_features.py.)"""
    cfg = get_config("debug")
    params = port_quant.quantize_params(
        init_params(cfg, torch.Generator().manual_seed(0),
                    torch.device("cpu")), "int8")
    with pytest.raises(NotImplementedError,
                       match=r"attn\.wo quantized int8 in blocks of 128 "
                             r"rows .*off-boundary quantized cut"):
        sharding.shard_params(params, sharding.serve_plan(cfg, 2), 0)


ADAPTER_TARGETS = ("attn.wq", "attn.wk", "attn.wv", "attn.wo",
                   "mlp.wi_gate", "mlp.wi_up", "mlp.wo")


@pytest.mark.parametrize("source", ["init", "checkpoint", "adapter"])
@pytest.mark.parametrize("over", [
    dict(num_heads=4, num_kv_heads=2),
    dict(num_heads=6, num_kv_heads=3, hidden_size=192),
])
def test_load_model_shard_is_the_cut_of_the_full_tree(tmp_path, monkeypatch,
                                                      source, over):
    """load_model(shard=(2, r)) materialises rank r's shard alone (a
    random init cut leaf by leaf as it is drawn, a mapped checkpoint cut
    before its copy, an adapter's pairs cut before the fold): it equals
    shard_params of the full tree, and shard_params passes it through."""
    from runbooks_tpu_torch.serve import lora_pool
    from runbooks_tpu_torch.serve.api import load_model
    from runbooks_tpu_torch.train.checkpoint import CheckpointManager

    monkeypatch.setenv("RBT_CONTENT_DIR", str(tmp_path / "content"))
    cfg = get_config("debug", **over)
    params = {"model": "debug", "model_overrides": over, "seed": 5}
    if source != "init":
        base = init_params(cfg, torch.Generator().manual_seed(9),
                           torch.device("cpu"))
        CheckpointManager(str(tmp_path / "ckpt")).save(
            1, {"params": base}, force=True)
        params["checkpoint"] = str(tmp_path / "ckpt")
    if source == "adapter":
        gen = torch.Generator().manual_seed(11)
        lora = {}
        for t in ADAPTER_TARGETS:
            group, name = t.split(".")
            L, d_in, d_out = base["layers"][group][name].shape
            lora[t] = {"a": torch.randn((L, d_in, 4), generator=gen),
                       "b": torch.randn((L, 4, d_out), generator=gen)}
        lora_pool.save_adapter(str(tmp_path / "adapter"), lora, rank=4,
                               alpha=8.0, targets=ADAPTER_TARGETS)
        params["adapter"] = str(tmp_path / "adapter")
    full = load_model(params, device="cpu")[1]
    plan = sharding.serve_plan(cfg, 2)
    for r in range(2):
        got = load_model(params, device="cpu", shard=(2, r))[1]
        want = sharding.shard_params(full, plan, r)
        for a, b in zip(tree_leaves(got), tree_leaves(want), strict=True):
            assert a.shape == b.shape and a.dtype == b.dtype
            # The fold's products over a cut [in, r] x [r, out]: the same
            # sums, in whatever order the library blocks them.
            torch.testing.assert_close(
                a, b, rtol=0, atol=1e-5 if source == "adapter" else 0)
        again = sharding.shard_params(got, plan, r)
        assert all(a is b for a, b in zip(tree_leaves(again),
                                          tree_leaves(got)))


def test_shard_leaf_refuses_a_width_of_neither_tree():
    cfg = get_config("debug", num_heads=4, num_kv_heads=2)
    plan = sharding.serve_plan(cfg, 2)
    with pytest.raises(ValueError, match="'mlp' dimension"):
        sharding.shard_leaf(torch.zeros(2, cfg.hidden_size,
                                        cfg.intermediate_size + 2),
                            ("layers", "embed", "mlp"), plan, 0)
