"""The port's FSDP / data-parallel plan against the reference's shardings,
in one process (no ranks spawned).

For llama-, falcon- and gpt2-shaped configs at fsdp 2, 4 and 8 (hidden
widths 64, 36 and 44: falcon's and gpt2's "embed" does not divide by 8,
so their matrices replicate there, as the reference's specs degrade):

- ``lora_logical_axes`` equals the reference's;
- ``infer_state_shardings`` gives the reference's specs for the params
  and for AdamW's mu and nu (its optax state), and the step's and the
  count's replicate;
- ``batch_shardings`` gives the reference's specs, a batch the degree
  does not divide included, and ``batch_rows`` follows them;
- each rank's piece of every leaf (``FsdpPlan``) has the shape of the
  reference's ``addressable_shards`` on the conftest's virtual CPU
  devices, for the base and for the LoRA tree (placed under the
  reference's shardings; once after its ``create_train_state`` itself,
  its ``test_fsdp_actually_shards_params`` idiom);
- every refusal names what it refuses: training axes other than data and
  fsdp, a multi-host env, a mesh beyond the GPUs, a mesh that one process
  cannot form.
"""

import dataclasses
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from runbooks_tpu.models.config import get_config as jax_get_config
from runbooks_tpu.models.transformer import init_params as jax_init
from runbooks_tpu.models.transformer import (
    param_logical_axes as jax_param_axes,
)
from runbooks_tpu.parallel.mesh import MeshConfig as JaxMeshConfig
from runbooks_tpu.parallel.mesh import make_mesh as jax_make_mesh
from runbooks_tpu.train import lora as jax_lora
from runbooks_tpu.train import optimizer as jax_opt
from runbooks_tpu.train import step as jax_step

from runbooks_tpu_torch.models.config import get_config
from runbooks_tpu_torch.models.transformer import (
    forward,
    init_params,
    param_logical_axes,
)
from runbooks_tpu_torch.parallel.mesh import (
    MeshConfig,
    check_mesh_model,
    check_training_mesh,
)
from runbooks_tpu_torch.parallel.sharding import FsdpPlan
from runbooks_tpu_torch.train import lora, trainer
from runbooks_tpu_torch.train.optimizer import OptimizerConfig, make_optimizer
from runbooks_tpu_torch.train.step import (
    batch_rows,
    batch_shardings,
    create_train_state,
    fsdp_plan,
    infer_state_shardings,
)
from runbooks_tpu_torch.utils.tree import tree_leaves

torch.set_num_threads(2)

_BASE = dict(vocab_size=128, intermediate_size=96, num_layers=2,
             max_seq_len=64, dtype="float32")
CONFIGS = {
    "llama": ("llama2-7b", dict(_BASE, hidden_size=64, num_heads=4,
                                num_kv_heads=2, head_dim=16)),
    "falcon": ("falcon-7b", dict(_BASE, hidden_size=36, num_heads=3,
                                 num_kv_heads=1, head_dim=12)),
    "gpt2": ("gpt2", dict(_BASE, hidden_size=44, num_heads=4,
                          num_kv_heads=4, head_dim=11)),
}
LORA = dict(rank=4, alpha=8.0, targets=lora.ALL_TARGETS)


def _meshes(fsdp):
    mc = dict(data=1, fsdp=fsdp, sequence=1, tensor=1)
    return (jax_make_mesh(JaxMeshConfig(**mc), devices=jax.devices()[:fsdp]),
            MeshConfig(**mc))


def _spec_tree(shardings):
    return jax.tree.map(lambda s: tuple(s.spec), shardings)


def _leaves_by_path(tree):
    """{dict-key path: leaf} of a reference tree (optax's tuples skipped)."""
    out = {}

    def record(path, leaf):
        keys = tuple(k.key for k in path
                     if isinstance(k, jax.tree_util.DictKey))
        out[keys] = leaf
    jax.tree_util.tree_map_with_path(
        record, tree, is_leaf=lambda x: isinstance(x, tuple) and all(
            isinstance(e, (str, type(None), tuple)) for e in x))
    return out


def _jax_state(jcfg, jo):
    """The reference's initial TrainState (create_train_state's init_fn)."""
    params = jax_init(jcfg, jax.random.key(0))
    return jax_step.TrainState(step=jnp.zeros((), jnp.int32), params=params,
                               opt_state=jo.init(params))


def _placed(shapes, shardings):
    """Zeros of ``shapes`` placed under the reference's ``shardings``."""
    return jax.tree.map(lambda x, sh: jax.device_put(
        np.zeros(x.shape, x.dtype), sh), shapes, shardings)


def _flat(tree, prefix=()):
    if isinstance(tree, dict):
        out = {}
        for k in tree:
            out.update(_flat(tree[k], prefix + (k,)))
        return out
    return {prefix: tree}


@pytest.mark.parametrize("fsdp", [2, 4, 8])
@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_plan_matches_the_reference_shardings(name, fsdp):
    family, over = CONFIGS[name]
    jcfg, tcfg = jax_get_config(family, **over), get_config(family, **over)
    jmesh, mesh = _meshes(fsdp)
    jo = jax_opt.make_optimizer(jax_opt.OptimizerConfig())
    # The shardings create_train_state computes, the state placed under
    # them without compiling its init (test_pieces_after_the_references_
    # init runs the init itself).
    jshapes = jax.eval_shape(lambda: _jax_state(jcfg, jo))
    jsh = jax_step.infer_state_shardings(jax_param_axes(jcfg), jshapes,
                                         jmesh)
    jstate = _placed(jshapes, jsh)
    # State specs: the params', mu's and nu's as the reference's.
    shapes = init_params(tcfg, None, torch.device("meta"))
    tstate = create_train_state(shapes, make_optimizer(OptimizerConfig()))
    tsh = infer_state_shardings(param_logical_axes(tcfg), tstate, mesh)
    adam = jsh.opt_state[1][0]
    for ref, got in ((jsh.params, tsh["params"]),
                     (adam.mu, tsh["opt_state"]["mu"]),
                     (adam.nu, tsh["opt_state"]["nu"])):
        assert _flat(got) == _leaves_by_path(_spec_tree(ref))
    assert tsh["step"] == tsh["opt_state"]["count"] == tuple(
        jsh.step.spec) == ()
    # Each rank's piece has the reference's addressable shard shape.
    plan = fsdp_plan(tcfg, mesh, lora.LoraConfig(**LORA))
    want = {k: {s.data.shape for s in v.addressable_shards}
            for k, v in _leaves_by_path(jstate.params).items()}
    dims, leaves = _flat(plan.params), _flat(shapes)
    for path, leaf in leaves.items():
        assert want[path] == {plan.local_shape(leaf.shape, dims[path])}, path
    assert any(d is not None for d in dims.values()) == (
        over["hidden_size"] % fsdp == 0)
    # The LoRA tree: axes, specs and shard shapes.
    # (As create_lora_train_state shards it.)
    jl_cfg = jax_lora.LoraConfig(**LORA)
    lshapes = jax.eval_shape(lambda: jax_lora.init_lora(
        jstate.params, jl_cfg, jax.random.key(1)))
    laxes = jax_lora.lora_logical_axes(jl_cfg, lshapes)
    placed = _placed(lshapes, jax_step.infer_state_shardings(
        laxes, lshapes, jmesh))
    tl = lora.init_lora(shapes, lora.LoraConfig(**LORA), None,
                        device=torch.device("meta"))
    assert lora.lora_logical_axes(lora.LoraConfig(**LORA), tl) == laxes
    lwant = {k: {s.data.shape for s in v.addressable_shards}
             for k, v in _leaves_by_path(placed).items()}
    ldims = _flat(plan.lora)
    for path, leaf in _flat(tl).items():
        assert lwant[path] == {plan.local_shape(leaf.shape, ldims[path])}
    # The bytes a rank holds, from the plan alone.
    held = sum(int(np.prod(plan.local_shape(leaf.shape, dims[p])))
               * leaf.element_size() for p, leaf in leaves.items())
    assert plan.local_bytes(shapes, plan.params) == held


def test_pieces_after_the_references_init():
    """The reference's own idiom (test_fsdp_actually_shards_params):
    create_train_state at fsdp 8 and its wq's addressable shards, against
    the plan's piece of every leaf."""
    family, over = CONFIGS["llama"]
    jmesh, mesh = _meshes(8)
    jo = jax_opt.make_optimizer(jax_opt.OptimizerConfig())
    jstate, _ = jax_step.create_train_state(
        jax_get_config(family, **over), jo, jmesh, jax.random.key(0))
    tcfg = get_config(family, **over)
    plan = fsdp_plan(tcfg, mesh)
    dims = _flat(plan.params)
    for path, leaf in _flat(init_params(tcfg, None,
                                        torch.device("meta"))).items():
        ref = _leaves_by_path(jstate.params)[path]
        assert {x.data.shape for x in ref.addressable_shards} == {
            plan.local_shape(leaf.shape, dims[path])}, path
    assert plan.local_shape((2, 64, 64), dims[("layers", "attn", "wq")]) \
        == (2, 8, 64)


@pytest.mark.parametrize("rows,k,mesh", [
    (8, 1, dict(fsdp=4)),          # 2 rows a rank
    (8, 2, dict(fsdp=4)),          # 1 row of each microbatch a rank
    (6, 1, dict(fsdp=4)),          # 4 does not divide 6: every rank, all
    (6, 1, dict(data=2, fsdp=2)),  # rows over data only, fsdp copies
    (3, 1, dict(fsdp=2)),
], ids=["f4", "f4-k2", "f4-degrade", "d2f2-degrade", "f2-odd"])
def test_batch_rows_follow_the_reference_specs(rows, k, mesh):
    mc = dict(dict(data=1, sequence=1, tensor=1), **mesh)
    n = mc["data"] * mc["fsdp"]
    jmesh = jax_make_mesh(JaxMeshConfig(**mc), devices=jax.devices()[:n])
    shapes = {"tokens": jax.ShapeDtypeStruct((rows // k, 16), np.int32),
              "loss_mask": jax.ShapeDtypeStruct((rows // k, 16),
                                                np.float32)}
    want = _spec_tree(jax_step.batch_shardings(jmesh, shapes))
    got = batch_shardings(MeshConfig(**mc), {
        key: torch.empty(v.shape, device="meta") for key, v in
        shapes.items()})
    assert got == want
    plan = FsdpPlan(mesh=dataclasses.asdict(MeshConfig(**mc)), params={})
    taken = [batch_rows(plan, rows, k, r) for r in range(n)]
    owned = sorted(i for r, o in taken if o for i in r)
    # Every row is owned once; each rank holds rows // k // blocks of each
    # microbatch, blocks = the ranks the spec's axes split over.
    assert owned == list(range(rows))
    axes = want["tokens"][0]
    axes = () if axes is None else ((axes,) if isinstance(axes, str)
                                    else axes)
    blocks = int(np.prod([mc[a] for a in axes]))
    assert all(len(r) == rows // blocks for r, _ in taken)
    assert sum(o for _, o in taken) == blocks


@pytest.mark.parametrize("axis", ["tensor", "sequence", "stage", "expert"])
def test_training_axes_refused_by_name(axis):
    with pytest.raises(NotImplementedError, match=f"mesh_{axis}=2"):
        check_training_mesh(MeshConfig(fsdp=1, **{axis: 2}))
    with pytest.raises(NotImplementedError, match=f"mesh_{axis}=2"):
        trainer.TrainJobConfig.from_params({f"mesh_{axis}": 2})
    # data and fsdp parse into the job's MeshConfig, as the reference's.
    job = trainer.TrainJobConfig.from_params({"mesh_data": "2",
                                              "mesh_fsdp": 4})
    assert job.mesh == MeshConfig(data=2, fsdp=4)


def test_mesh_beyond_the_gpus_and_multi_host_are_refused(tmp_path,
                                                         monkeypatch):
    n = torch.cuda.device_count()
    with pytest.raises(ValueError,
                       match=rf"torch.cuda.device_count\(\) is {n}"):
        trainer.training_world(MeshConfig(fsdp=n + 8), "nccl")
    # main: mesh_fsdp 8 on this host refuses, naming the device count.
    (tmp_path / "params.json").write_text('{"mesh_fsdp": 8}')
    monkeypatch.setenv("RBT_CONTENT_DIR", str(tmp_path))
    with pytest.raises(ValueError, match=r"device_count\(\) is"):
        trainer.main()
    # Under gloo a -1 axis fills to 1 and fixed axes are the world.
    assert trainer.training_world(MeshConfig(), "gloo") == MeshConfig(fsdp=1)
    assert trainer.training_world(MeshConfig(data=2, fsdp=2),
                                  "gloo") == MeshConfig(data=2, fsdp=2)
    # One process cannot form a mesh of two: run_training raises.
    job = trainer.TrainJobConfig(mesh=MeshConfig(fsdp=2),
                                 artifacts_dir=str(tmp_path / "a"))
    with pytest.raises(ValueError, match="needs 2 devices but 1"):
        trainer.run_training(job, device="cpu")
    monkeypatch.setenv("JAX_COORDINATOR_ADDRESS", "10.0.0.1:1234")
    monkeypatch.setenv("JAX_NUM_PROCESSES", "2")
    monkeypatch.setenv("JAX_PROCESS_ID", "0")
    with pytest.raises(NotImplementedError, match="over 2 hosts"):
        trainer.run_training(trainer.TrainJobConfig(), device="cpu")
    with pytest.raises(NotImplementedError, match="over 2 hosts"):
        trainer.main(backend="gloo")


@pytest.mark.parametrize("axes", [{"mesh_fsdp": 2}, {"mesh_data": 2}])
def test_gemma_training_mesh_is_refused_by_name(tmp_path, monkeypatch,
                                                axes):
    """Gemma trains on one device only: ``main`` refuses mesh_fsdp or
    mesh_data above 1 by name once the mesh resolves, before any rank
    starts, and so does run_training on a rank."""
    (tmp_path / "params.json").write_text(json.dumps({"model": "gemma-2b",
                                                      **axes}))
    monkeypatch.setenv("RBT_CONTENT_DIR", str(tmp_path))
    with pytest.raises(NotImplementedError,
                       match=r"mesh_(fsdp|data)=2: .*gemma under a mesh"):
        trainer.main(backend="gloo")
    mc = MeshConfig(**{k[len("mesh_"):]: v for k, v in axes.items()})
    with pytest.raises(NotImplementedError, match="gemma under a mesh"):
        check_mesh_model(get_config("gemma-7b"), mc.resolve(2))
    check_mesh_model(get_config("falcon-7b"), mc.resolve(2))


def test_forward_refuses_fsdp_on_serving_paths_and_sharded_outer_leaves():
    cfg = get_config("debug", num_layers=1, dtype="float32")
    params = init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    plan = fsdp_plan(cfg, MeshConfig(fsdp=2))

    class Stub:          # a one-rank view: the checks come first
        pass
    stub = Stub()
    stub.plan = plan
    tokens = torch.zeros((1, 4), dtype=torch.long)
    with pytest.raises(NotImplementedError, match="FSDP forward trains"):
        forward(cfg, params, tokens, fsdp=stub, tp=object())
    half = plan.shard(params, plan.params, 0)
    with pytest.raises(ValueError, match="Fsdp.outer"):
        forward(cfg, half, tokens, fsdp=stub)
    # A rank's pieces are the full leaves' slices, and a sharded init
    # draws the same numbers as the one-process init.
    pieces = init_params(cfg, torch.Generator().manual_seed(0), "cpu",
                         cut=lambda leaf, axes: plan.cut_by_axes(leaf, axes,
                                                                 1))
    for a, b in zip(tree_leaves(plan.shard(params, plan.params, 1)),
                    tree_leaves(pieces)):
        assert torch.equal(a, b)
