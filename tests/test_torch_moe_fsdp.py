"""MoE routing over data x fsdp ranks (models/moe.route's ``group``, a
parallel/sharding.RoutingGroup) against one device's ``route`` of the
global microbatch, which is how the reference's sharded step routes it.

Four gloo ranks in one spawn (tests/tp_ranks.moe_fsdp_checks):

- Router probabilities of a global microbatch, made from a seed with a
  direction every token shares (so that capacity drops assignments), are
  cut into the blocks ``FsdpPlan.block`` gives each rank: two fsdp-2
  pairs ([0, 1] and [2, 3]), the four ranks at data 2 x fsdp 2, and
  microbatches of 6 and 3 rows, which 4 does not divide (the rows split
  over data alone, or not at all, and the other ranks hold copies). Each
  at capacity factor 0.5 and 1.25, where assignments drop, and at E / k,
  where none does.
- Each rank's expert, slot, keep, gate and capacity must equal the
  one-device routing of the owners' probabilities concatenated in block
  order, exactly; a copy routes as its owner. The aux shares must sum to
  the one-device aux within AUX_ATOL, and each owner's gradient of its
  share by its probabilities must equal the one-device gradient's rows
  within AUX_ATOL (a copy's is zero). Rank-local routing (``route``
  without a group) must differ from the global routing on every case of
  more than one block, so that the cases are not vacuous.
- The debug MoE's FSDP step at data 2 x fsdp 2 with remat off and on:
  each remat recompute routes exactly as its layer's forward did, and
  the gradients agree within REMAT_ATOL.

With one rank there is no group (``Fsdp.routing`` returns None), and a
world-1 group's gather returns its input: ``route`` with it gives one
device's integers. tests/test_torch_mixtral.py runs the world-1 FSDP
forward; the step's parity with the reference's sharded step is in
tests/test_torch_fsdp_train.py and tests/test_torch_fsdp_train_d2f2.py
(the mixtral geometry).
"""

import numpy as np
import pytest
import torch

from runbooks_tpu_torch.models import moe
from runbooks_tpu_torch.models.config import get_config
from runbooks_tpu_torch.parallel.sharding import FsdpPlan, RoutingGroup
from tests import tp_ranks

torch.set_num_threads(2)

E, K, SEQ = 4, 2, 8
AUX_ATOL = 1e-6
REMAT_ATOL = 1e-6
FACTORS = (0.5, 1.25, E / K)
# name -> ((data, fsdp), global microbatch rows)
MESHES = {"fsdp2": ((1, 2), 4), "d2f2": ((2, 2), 4),
          "d2f2-6-rows": ((2, 2), 6), "d2f2-3-rows": ((2, 2), 3)}
CASES = [(name, cf) for name in MESHES for cf in FACTORS]
MOE = dict(vocab_size=64, hidden_size=32, intermediate_size=48,
           num_layers=2, num_heads=4, num_kv_heads=2, head_dim=8,
           max_seq_len=32, dtype="float32", moe_num_experts=E,
           moe_top_k=K, moe_capacity_factor=1.25)


def _overrides(cf):
    return dict(MOE, moe_capacity_factor=cf)


def _probs(seed, rows):
    """Softmax of skewed router logits [rows, SEQ, E] (f32)."""
    rng = np.random.default_rng(seed)
    logits = (rng.standard_normal((rows, SEQ, E))
              + 1.5 * rng.standard_normal(E)).astype(np.float32)
    return torch.softmax(torch.from_numpy(logits), -1).numpy()


def _case(i):
    name, cf = CASES[i]
    mesh, rows = MESHES[name]
    return {"overrides": _overrides(cf), "mesh": mesh, "rows": rows,
            "probs": _probs(i, rows)}


def _remat_spec():
    rng = np.random.default_rng(3)
    tokens = rng.integers(1, 64, (4, 17))
    return {"overrides": dict(MOE, attention_impl="flash"),
            "batch": {"tokens": tokens[:, :-1], "targets": tokens[:, 1:]}}


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    return tp_ranks.run_ranks(
        tp_ranks.moe_fsdp_checks, 4, tmp_path_factory.mktemp("moe_fsdp"),
        [_case(i) for i in range(len(CASES))], _remat_spec(),
        mesh={"data": 2, "fsdp": 2})


def _one_device(case):
    """(Routing, d aux / d probs) of the whole microbatch on one device."""
    cfg = get_config("debug", **case["overrides"])
    probs = torch.from_numpy(case["probs"]).reshape(-1, E)
    probs.requires_grad_(True)
    r = moe.route(cfg, probs)
    grad, = torch.autograd.grad(r.aux, probs)
    return r, grad.numpy()


def _in_block(a, block, T, T_all):
    """The entries of a choice-major [K·T_all] array that a block of T
    tokens at ``block`` holds, in its own choice-major order."""
    return np.concatenate([a[j * T_all + block * T:j * T_all + (block + 1)
                             * T] for j in range(K)])


@pytest.mark.parametrize("i", range(len(CASES)),
                         ids=[f"{n}-cf{cf:g}" for n, cf in CASES])
def test_ranks_route_as_one_device_routes_the_global_microbatch(ranks, i):
    case = _case(i)
    want, want_grad = _one_device(case)
    got = [r["routing"][i] for r in ranks]
    (data, fsdp), rows = case["mesh"], case["rows"]
    world = data * fsdp
    # The ranks that share a routing group: all four, or the two pairs.
    groups = [got] if world == 4 else [got[:2], got[2:]]
    T_all = rows * SEQ
    assert want.capacity == moe.moe_capacity(
        get_config("debug", **case["overrides"]), T_all)
    local_differs = False
    for members in groups:
        blocks = members[0]["blocks"]
        assert sorted(m["block"] for m in members if m["owner"]) == list(
            range(blocks))
        T = T_all // blocks
        for m in members:
            assert m["capacity"] == want.capacity
            for f in ("expert", "slot", "keep", "gate"):
                np.testing.assert_array_equal(
                    m["routing"][f], _in_block(getattr(want, f).detach(
                    ).numpy(), m["block"], T, T_all), err_msg=f)
            assert m["gathers"] == 1
            rows_grad = want_grad.reshape(blocks, T, E)[m["block"]]
            if m["owner"]:
                np.testing.assert_allclose(m["grad"], rows_grad, rtol=0,
                                           atol=AUX_ATOL)
            else:
                assert not m["grad"].any()
            lo = m["local"]
            local_differs |= lo["capacity"] != want.capacity or any(
                not np.array_equal(lo[f], m["routing"][f])
                for f in ("slot", "keep"))
        np.testing.assert_allclose(sum(m["aux"] for m in members),
                                   float(want.aux.detach()), rtol=0,
                                   atol=AUX_ATOL)
    if blocks > 1:
        assert local_differs
    if case["overrides"]["moe_capacity_factor"] < E / K:
        assert not want.keep.all()          # assignments drop


def test_degraded_microbatches_split_as_the_batch_rows():
    """6 rows at data 2 x fsdp 2 split over data (fsdp index 1 holds
    copies of index 0's block); 3 rows do not split (rank 0 owns them);
    the owners' blocks come in block order."""
    plan = FsdpPlan(mesh={"data": 2, "fsdp": 2}, params={})
    six = [RoutingGroup.of(plan, 6, r) for r in range(4)]
    assert [(g.block, g.blocks, g.owner) for g in six] == [
        (0, 2, True), (0, 2, False), (1, 2, True), (1, 2, False)]
    assert six[0].order == (0, 2)
    three = [RoutingGroup.of(plan, 3, r) for r in range(4)]
    assert [(g.block, g.blocks, g.owner) for g in three] == [
        (0, 1, True), (0, 1, False), (0, 1, False), (0, 1, False)]
    four = [RoutingGroup.of(plan, 4, r) for r in range(4)]
    assert [g.block for g in four] == [0, 1, 2, 3]
    assert four[0].order == (0, 1, 2, 3) and all(g.owner for g in four)


def test_remat_under_fsdp_routes_as_the_forward(ranks):
    """Each rank's two MoE layers route once with remat off; with remat
    on, the backward's recomputes (layer L-1 first) route exactly as the
    forward's layers did; loss and gradients agree."""
    L = MOE["num_layers"]
    for r in ranks:
        off, on = r["remat"][False], r["remat"][True]
        assert len(off["routing"]) == L and len(on["routing"]) == 2 * L
        for li in range(L):
            for a, b, c in zip(off["routing"][li], on["routing"][li],
                               on["routing"][2 * L - 1 - li]):
                np.testing.assert_array_equal(a, b)
                np.testing.assert_array_equal(b, c)
        assert on["loss"] == off["loss"]
        for a, b in zip(off["grads"], on["grads"], strict=True):
            np.testing.assert_allclose(b, a, rtol=0, atol=REMAT_ATOL)
    # The global loss and gradients on every rank alike.
    assert len({r["remat"][True]["loss"] for r in ranks}) == 1


def test_world_one_group_routes_as_one_device(tmp_path):
    """A world-1 group's gather returns its input, and ``route`` with it
    gives one device's integers and capacity; ``Fsdp.routing`` has no
    group at world 1 (one device's routing, bit for bit)."""
    import torch.distributed as dist

    cfg = get_config("debug", **MOE)
    probs = torch.from_numpy(_probs(9, 2)).reshape(-1, E)
    want = moe.route(cfg, probs)
    plan = FsdpPlan(mesh={"data": 1, "fsdp": 1}, params={})
    counts = {"routing_all_gather": 0}
    dist.init_process_group("gloo", rank=0, world_size=1,
                            store=dist.FileStore(str(tmp_path / "s"), 1))
    try:
        group = RoutingGroup.of(plan, 2, 0, counts=counts)
        x = torch.arange(K * E).reshape(K, E)
        assert torch.equal(group.gather(x), x[None])
        got = moe.route(cfg, probs, group)
    finally:
        dist.destroy_process_group()
    for f in ("expert", "slot", "keep", "gate"):
        assert torch.equal(getattr(got, f), getattr(want, f)), f
    assert got.capacity == want.capacity and counts[
        "routing_all_gather"] == 2
    torch.testing.assert_close(got.aux, want.aux, rtol=0, atol=AUX_ATOL)
