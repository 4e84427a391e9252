"""Logical-axis sharding (the port of ``runbooks_tpu.parallel.sharding``)
and the head-granular tensor-parallel plan the serving engines run.

The rule table, ``logical_to_spec``, ``spec_for_array`` and
``tree_shardings`` are the reference's as pure functions: a spec is a
plain tuple with one entry per dimension (None, a mesh axis, or a tuple
of mesh axes), and a mesh is anything that names its axis sizes (a
mapping, a ``MeshConfig`` or a ``DeviceMesh``).

``serve_plan`` reads the same table for the serving engines, at the
granularity of whole heads: q heads, kv heads, the MLP width and the
vocabulary each shard over ``tensor`` or replicate. The reference shards
``wq`` over the flattened q_dim, so GSPMD may split a head; the port never
does. A head count that ``tensor`` does not divide replicates that side.
Where q heads shard and kv heads do not, each rank holds the kv heads its
q heads read. ``shard_params`` cuts one rank's tree by the plan (a
QuantizedArray by whole quantization blocks: a rank whose contraction
rows would start or end inside a block is refused by name,
``check_quantized_cuts``; elsewhere quantizing a shard equals cutting
the quantized whole), and
``TensorParallel`` carries the plan, the rank and the process group into
the forward (models/transformer.py), which runs on local widths:

- one all-reduce after ``wo`` and one after the MLP's ``wo`` (one for a
  parallel block); replicated leaves (norms, ``bo``, the MLP ``bo``) are
  added once, after the reduce;
- the embedding, when the vocabulary shards, is looked up with a mask and
  summed over ranks (exact: one rank holds each row);
- the head's local logits are all-gathered over the vocabulary.

Under ``expert`` as well (an MoE model served over ``mesh_expert`` x
``mesh_tensor``), ranks are numbered as the DeviceMesh orders them,
``expert`` outer and ``tensor`` inner: rank r sits at expert index r //
tensor and tensor index r % tensor. The experts shard over ``expert``
(the ``experts`` rule) and their MLP width over ``tensor``; attention,
the dense leaves and the vocabulary are cut by the tensor index alone,
so every expert row holds the same pieces of them. The MoE combine sums
over the serving group, every rank of the mesh (models/moe.py).

``FsdpPlan`` holds what each rank of a training mesh over ``data`` and
``fsdp`` (ZeRO-3) keeps: each leaf shards the dimension that the same
table gives ``fsdp`` (the reference's "embed" rule), or replicates where
``fsdp`` does not divide it (``train/step.fsdp_plan`` reads it from the
train state's specs, ``train/step.batch_rows`` the batch's rows from
its specs). ``Fsdp`` carries the plan, the rank and the mesh's groups
into the train step (train/step.py) and the forward, which gathers each
layer's leaves inside its block (an autograd Function whose backward
reduce-scatters the gradient into the rank's piece) and sums the rest of
the gradients over the ranks. An MoE layer routes the global microbatch
as the reference's sharded step does: each rank's ``RoutingGroup`` (its
block of the microbatch, from the same rule as the batch's rows:
``FsdpPlan.block``) all-gathers the ranks' per-expert counts, from which
models/moe.route takes the global capacity, slots and aux.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, List, Optional, Sequence, Tuple, Union

import torch

LogicalSpec = Tuple[Optional[str], ...]
MeshAssignment = Union[None, str, Tuple[str, ...]]

# logical axis -> mesh axis (or tuple of mesh axes, or None = replicated)
DEFAULT_RULES: Dict[str, MeshAssignment] = {
    # Activations
    "batch": ("data", "fsdp"),
    "seq": "sequence",
    "kv_seq": "sequence",
    "act_embed": None,
    "act_heads": "tensor",
    "act_mlp": "tensor",
    # Parameters
    "layers": "stage",
    "embed": "fsdp",
    "vocab": "tensor",
    "heads": "tensor",
    "kv_heads": "tensor",
    "head_dim": None,
    "mlp": "tensor",
    "norm": None,
    "pos": None,
    # MoE
    "experts": "expert",
    "act_experts": "expert",
}


def logical_to_spec(
    logical: LogicalSpec, rules: Optional[Dict[str, MeshAssignment]] = None
) -> tuple:
    rules = DEFAULT_RULES if rules is None else rules
    out = []
    used: set = set()
    for name in logical:
        if name is None:
            out.append(None)
            continue
        axes = rules.get(name)
        if axes is None:
            out.append(None)
            continue
        if isinstance(axes, str):
            axes = (axes,)
        # A mesh axis may appear at most once in a spec.
        axes = tuple(a for a in axes if a not in used)
        used.update(axes)
        if not axes:
            out.append(None)
        elif len(axes) == 1:
            out.append(axes[0])
        else:
            out.append(axes)
    return tuple(out)


def mesh_shape(mesh) -> Dict[str, int]:
    """{axis: size} of a mapping, a MeshConfig or a DeviceMesh."""
    if isinstance(mesh, dict):
        return mesh
    if dataclasses.is_dataclass(mesh):
        return dataclasses.asdict(mesh)
    names = mesh.mesh_dim_names
    return {a: mesh.size(i) for i, a in enumerate(names)}


def _divisible(dim: int, axes: MeshAssignment, shape: Dict[str, int]) -> bool:
    if axes is None:
        return True
    if isinstance(axes, str):
        axes = (axes,)
    size = 1
    for a in axes:
        size *= shape[a]
    return dim % size == 0


def spec_for_array(
    shape: Sequence[int],
    logical: LogicalSpec,
    mesh,
    rules: Optional[Dict[str, MeshAssignment]] = None,
) -> tuple:
    """The spec for a concrete shape: drops mesh axes absent from the mesh
    or that don't divide the dimension."""
    sizes = mesh_shape(mesh)
    base = logical_to_spec(logical, rules)
    out = []
    for dim, axes in zip(shape, tuple(base) + (None,) * (len(shape) - len(base))):
        if axes is not None:  # drop mesh axes this mesh doesn't have
            present = tuple(a for a in
                            ((axes,) if isinstance(axes, str) else axes)
                            if a in sizes)
            axes = (present[0] if len(present) == 1
                    else (present or None))
        if axes is not None and not _divisible(dim, axes, sizes):
            # Try dropping trailing axes of a tuple assignment first.
            if isinstance(axes, tuple):
                while axes and not _divisible(dim, axes, sizes):
                    axes = axes[:-1]
                axes = axes if axes else None
                if isinstance(axes, tuple) and len(axes) == 1:
                    axes = axes[0]
            else:
                axes = None
        out.append(axes)
    return tuple(out)


def _is_axes(x) -> bool:
    return isinstance(x, tuple) and all(
        isinstance(e, (str, type(None))) for e in x)


def tree_shardings(
    tree_shapes: Any,
    tree_logical: Any,
    mesh,
    rules: Optional[Dict[str, MeshAssignment]] = None,
) -> Any:
    """Map a tree of tensors (anything with ``.shape``) and the matching
    tree of LogicalSpecs to a tree of specs. A QuantizedArray leaf pairs
    with a QuantizedArray of axis tuples (ops/quantization
    .quantized_logical_axes): its values and scales map apart."""
    from runbooks_tpu_torch.ops.quantization import QuantizedArray

    if isinstance(tree_shapes, dict):
        return {k: tree_shardings(tree_shapes[k], tree_logical[k], mesh,
                                  rules) for k in sorted(tree_shapes)}
    if isinstance(tree_shapes, QuantizedArray):
        return dataclasses.replace(
            tree_logical,
            values=spec_for_array(tree_shapes.values.shape,
                                  tree_logical.values, mesh, rules),
            scales=spec_for_array(tree_shapes.scales.shape,
                                  tree_logical.scales, mesh, rules))
    if not _is_axes(tree_logical):
        raise TypeError(f"no logical axes for a leaf of shape "
                        f"{tuple(tree_shapes.shape)}: {tree_logical!r}")
    return spec_for_array(tree_shapes.shape, tree_logical, mesh, rules)


# ---------------------------------------------------------------------------
# The head-granular serving plan
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class TensorPlan:
    """What each rank of a serving mesh of ``expert`` x ``tensor`` ranks
    holds of one model: per side, shard (contiguous equal pieces) or
    replicate. A rank is its place in the mesh (``coords``); the tensor
    sides are cut by its tensor index, the experts by its expert index."""

    cfg: Any                 # the ModelConfig
    tensor: int
    heads: bool              # q heads: wq's columns, bq, wo's rows
    kv_heads: bool           # kv heads: wk/wv's columns, bk/bv, the cache
    mlp: bool                # the MLP width (the experts' too)
    vocab: bool              # the embedding's rows and the head's columns
    expert: int = 1
    experts: bool = False    # the MoE experts over ``expert``

    @property
    def world(self) -> int:
        return self.expert * self.tensor

    def coords(self, rank: int) -> Tuple[int, int]:
        """(expert index, tensor index) of serving rank ``rank``."""
        return divmod(int(rank), self.tensor)

    def q_heads(self, rank: int) -> range:
        h = self.cfg.num_heads
        if not self.heads:
            return range(h)
        n, t = h // self.tensor, self.coords(rank)[1]
        return range(t * n, (t + 1) * n)

    def kv_head_ids(self, rank: int) -> range:
        """The kv heads rank ``rank`` holds: its shard, or, where q heads
        shard alone, the (contiguous) kv heads its q heads read."""
        kvh = self.cfg.num_kv_heads
        if self.kv_heads:
            n, t = kvh // self.tensor, self.coords(rank)[1]
            return range(t * n, (t + 1) * n)
        if not self.heads:
            return range(kvh)
        rep = self.cfg.num_heads // kvh
        q = self.q_heads(rank)
        return range(q.start // rep, (q.stop - 1) // rep + 1)

    def kv_map(self, rank: int) -> Optional[Tuple[int, ...]]:
        """For each local q head, the local kv head it reads, when that
        map is not the uniform ``j // (hq / kvh)`` the flash kernel
        assumes; None when it is."""
        rep = self.cfg.num_heads // self.cfg.num_kv_heads
        q, kv = self.q_heads(rank), self.kv_head_ids(rank)
        local = tuple(i // rep - kv.start for i in q)
        if len(q) % len(kv) == 0:
            n = len(q) // len(kv)
            if local == tuple(j // n for j in range(len(q))):
                return None
        return local

    def vocab_range(self, rank: int) -> range:
        v = self.cfg.vocab_size
        if not self.vocab:
            return range(v)
        n, t = v // self.tensor, self.coords(rank)[1]
        return range(t * n, (t + 1) * n)

    def mlp_range(self, rank: int) -> range:
        m = self.cfg.intermediate_size
        if not self.mlp:
            return range(m)
        n, t = m // self.tensor, self.coords(rank)[1]
        return range(t * n, (t + 1) * n)

    def expert_range(self, rank: int) -> range:
        """The MoE experts rank ``rank`` holds (every one where they
        replicate; empty for a dense model)."""
        e = self.cfg.moe_num_experts or 0
        if not self.experts:
            return range(e)
        n, i = e // self.expert, self.coords(rank)[0]
        return range(i * n, (i + 1) * n)

    def moe_owner(self, rank: int) -> bool:
        """Whether rank ``rank``'s (experts, MLP columns) piece enters the
        MoE combine's sum over the serving group: a side that replicates
        is summed from its first index only, so each piece counts once."""
        e, t = self.coords(rank)
        return (self.experts or e == 0) and (self.mlp or t == 0)

    def _dim_range(self, name: Optional[str], rank: int) -> Optional[range]:
        """The columns of a dimension named ``name`` rank ``rank`` holds
        (None: all of them)."""
        d = self.cfg.head_dim
        if name == "heads" and self.heads:
            q = self.q_heads(rank)
            return range(q.start * d, q.stop * d)
        if name == "kv_heads" and (self.kv_heads or self.heads):
            kv = self.kv_head_ids(rank)
            if len(kv) == self.cfg.num_kv_heads:
                return None
            return range(kv.start * d, kv.stop * d)
        if name == "mlp" and self.mlp:
            return self.mlp_range(rank)
        if name == "vocab" and self.vocab:
            return self.vocab_range(rank)
        if name == "experts" and self.experts:
            return self.expert_range(rank)
        return None

    def local_shape(self, shape: Sequence[int], axes: LogicalSpec,
                    rank: int) -> Tuple[int, ...]:
        out = []
        for dim, name in zip(shape, _serving_axes(axes)):
            r = self._dim_range(name, rank)
            out.append(dim if r is None else len(r))
        return tuple(out)

    def local_param_bytes(self, params, rank: int) -> int:
        """The bytes rank ``rank``'s tree holds, from the full tree's
        shapes and dtypes and the plan alone (no slicing). A QuantizedArray
        counts its values and scales, each cut as ``shard_leaf`` cuts
        them."""
        from runbooks_tpu_torch.models.transformer import param_logical_axes
        from runbooks_tpu_torch.ops.quantization import QuantizedArray
        from runbooks_tpu_torch.utils.tree import tree_leaves

        def numel(shape):
            n = 1
            for s in shape:
                n *= s
            return n

        axes = list(tree_leaves(param_logical_axes(self.cfg)))
        total = 0
        for leaf, ax in zip(tree_leaves(params), axes, strict=True):
            if isinstance(leaf, QuantizedArray):
                logical = self.local_shape(leaf.shape, ax, rank)
                pack = 2 if leaf.bits == 4 else 1
                total += numel((*logical[:-2], logical[-2] // pack,
                                logical[-1])) * leaf.values.element_size()
                total += numel((*logical[:-2],
                                logical[-2] // leaf.block_size,
                                logical[-1])) * leaf.scales.element_size()
                continue
            total += numel(self.local_shape(leaf.shape, ax, rank)) \
                * leaf.element_size()
        return total

    def describe(self) -> dict:
        out = {"tensor": self.tensor, "heads": self.heads,
               "kv_heads": self.kv_heads, "mlp": self.mlp,
               "vocab": self.vocab}
        if self.expert > 1 or self.cfg.moe_num_experts:
            out.update(expert=self.expert, experts=self.experts)
        return out


def _serving_axes(axes: LogicalSpec) -> LogicalSpec:
    """A leaf's logical axes as the serving plan cuts them: the MoE
    router's ``experts`` column (the one leaf naming ``experts`` without
    ``mlp``) stays whole, since every rank routes every token."""
    if "experts" in axes and "mlp" not in axes:
        return tuple(None if a == "experts" else a for a in axes)
    return axes


def serve_plan(cfg, tensor: int, expert: int = 1) -> TensorPlan:
    """The plan of ``cfg`` over ``expert`` x ``tensor`` ranks, from
    DEFAULT_RULES at whole-head granularity: a side shards when the table
    maps its logical axis to ``tensor`` and ``tensor`` divides its count
    (heads, kv heads, the MLP width, the vocabulary), and the MoE experts
    when the table maps ``experts`` to ``expert`` and ``expert`` divides
    ``moe_num_experts`` (else they replicate, as the reference drops an
    axis that does not divide; a dense model replicates over ``expert``).
    kv heads shard only with the q heads (a q head never reads a kv head
    of another rank's)."""
    mesh = {"tensor": int(tensor), "expert": int(expert)}

    def shards(count: int, name: str, axis: str = "tensor") -> bool:
        return mesh[axis] > 1 and spec_for_array(
            (count,), (name,), mesh) == (axis,)

    heads = shards(cfg.num_heads, "heads")
    return TensorPlan(cfg=cfg, tensor=int(tensor), heads=heads,
                      kv_heads=heads and shards(cfg.num_kv_heads, "kv_heads"),
                      mlp=shards(cfg.intermediate_size, "mlp"),
                      vocab=shards(cfg.vocab_size, "vocab"),
                      expert=int(expert),
                      experts=bool(cfg.moe_num_experts) and shards(
                          cfg.moe_num_experts, "experts", "expert"))


def _full_dims(cfg) -> Dict[str, int]:
    return {"heads": cfg.q_dim, "kv_heads": cfg.kv_dim,
            "mlp": cfg.intermediate_size, "vocab": cfg.vocab_size,
            "experts": cfg.moe_num_experts}


def quantized_cut_refusal(plan: TensorPlan, rank: int, axis: Optional[str],
                          bits: int, block_size: int,
                          name: str = "a quantized weight") -> Optional[str]:
    """Why rank ``rank``'s cut of a quantized weight's contraction axis
    (logical ``axis``) cannot be served, or None. A rank's rows must start
    and end on a quantization block (``block_size`` rows of ``bits``-bit
    codes; for int4 the block is even, so a packed pair never straddles
    the cut): its values and scales are then the full weight's blocks, and
    quantizing its rows alone gives the same codes as cutting the
    quantized whole."""
    r = plan._dim_range(axis, rank)
    if r is None or (r.start % block_size == 0
                     and r.stop % block_size == 0):
        return None
    return (f"{name} quantized int{bits} in blocks of {block_size} rows is "
            f"cut off its blocks under {plan.describe()}: rank {rank}'s "
            f"rows {r.start}:{r.stop} of its {axis!r} axis do not start "
            f"and end on a block boundary (an off-boundary quantized cut); "
            f"pick a mesh_tensor whose cut lands on the blocks, or serve "
            f"it unquantized or on one device")


def _shard_quantized(qa, axes: LogicalSpec, plan: TensorPlan, rank: int,
                     name: str):
    """A QuantizedArray cut like a plain [..., in, out] weight: ``values``
    and ``scales`` narrow on the output axis by its columns, and on the
    contraction axis by whole blocks (an int4 value row holds a packed
    pair of rows; a scale row one block), so the rank holds exactly the
    full weight's blocks for its rows. A cut off the blocks raises."""
    from runbooks_tpu_torch.ops.quantization import QuantizedArray

    *_, in_ax, out_ax = _serving_axes(axes)
    full = _full_dims(plan.cfg)
    values, scales = qa.values, qa.scales
    r = plan._dim_range(out_ax, rank)
    if r is not None and values.shape[-1] != len(r):
        if values.shape[-1] != full[out_ax]:
            raise ValueError(
                f"{name}: a {out_ax!r} dimension of {values.shape[-1]} is "
                f"neither {plan.cfg.name!r}'s {full[out_ax]} nor rank "
                f"{rank}'s {len(r)}")
        values = values.narrow(-1, r.start, len(r))
        scales = scales.narrow(-1, r.start, len(r))
    r = plan._dim_range(in_ax, rank)
    if r is not None and qa.in_dim != len(r):
        if qa.in_dim != full[in_ax]:
            raise ValueError(
                f"{name}: a {in_ax!r} dimension of {qa.in_dim} is neither "
                f"{plan.cfg.name!r}'s {full[in_ax]} nor rank {rank}'s "
                f"{len(r)}")
        why = quantized_cut_refusal(plan, rank, in_ax, qa.bits,
                                    qa.block_size, name)
        if why is not None:
            raise NotImplementedError(why)
        pack = 2 if qa.bits == 4 else 1
        values = values.narrow(-2, r.start // pack, len(r) // pack)
        scales = scales.narrow(-2, r.start // qa.block_size,
                               len(r) // qa.block_size)
    if values is qa.values and scales is qa.scales:
        return qa
    return QuantizedArray(values=values.contiguous(),
                          scales=scales.contiguous(), bits=qa.bits,
                          block_size=qa.block_size)


def shard_leaf(leaf, axes: LogicalSpec, plan: TensorPlan, rank: int,
               name: str = "a leaf"):
    """One leaf (logical ``axes``) cut to the columns the plan gives rank
    ``rank``, a tensor of its own where it is cut. A dimension already at
    its local width is kept, so the rank's own shard passes through. A
    QuantizedArray is cut by whole blocks (``_shard_quantized``)."""
    from runbooks_tpu_torch.ops.quantization import QuantizedArray

    if isinstance(leaf, QuantizedArray):
        return _shard_quantized(leaf, axes, plan, rank, name)
    cfg = plan.cfg
    full = _full_dims(cfg)
    out = leaf
    for dim, ax in enumerate(_serving_axes(axes)):
        r = plan._dim_range(ax, rank)
        if r is None or out.shape[dim] == len(r):
            continue
        if out.shape[dim] != full[ax]:
            raise ValueError(
                f"a {ax!r} dimension of {out.shape[dim]} is neither "
                f"{cfg.name!r}'s {full[ax]} nor rank {rank}'s {len(r)}")
        out = out.narrow(dim, r.start, len(r))
    return out.contiguous() if out is not leaf else out


def check_quantized_cuts(plan: TensorPlan, mode: str,
                         rank: Optional[int] = None,
                         block_size: int = 128) -> None:
    """Raise NotImplementedError, naming the first leaf, where rank
    ``rank`` (every rank of the plan when None) would cut a weight
    quantized ``mode`` at ``block_size`` off its blocks. Where no rank
    does, quantizing a rank's shard on its own equals cutting the
    quantized whole: the plan cuts evenly, so a rank's contraction rows
    are the full dimension over ``tensor``, and the whole tree's block
    (the largest usable one that divides the full dimension) is then the
    largest that divides the rank's rows too."""
    from runbooks_tpu_torch.models.transformer import param_logical_axes
    from runbooks_tpu_torch.ops.quantization import (
        QUANTIZABLE_KEYS,
        mode_bits,
        resolve_block_size,
    )

    if mode == "none":
        return
    bits = mode_bits(mode)
    cfg = plan.cfg
    full = dict(_full_dims(cfg), embed=cfg.hidden_size)
    layers = param_logical_axes(cfg)["layers"]
    for r in range(plan.world) if rank is None else (rank,):
        for group, keys in QUANTIZABLE_KEYS.items():
            for key in keys:
                axes = layers.get(group, {}).get(key)
                if axes is None:
                    continue
                in_ax = axes[-2]
                bs = resolve_block_size(full[in_ax], block_size, bits)
                why = quantized_cut_refusal(plan, r, in_ax, bits, bs,
                                            f"{group}.{key}")
                if why is not None:
                    raise NotImplementedError(why)


def shard_params(params, plan: TensorPlan, rank: int):
    """Rank ``rank``'s local tree of a full port tree (as
    models/bridge.from_jax_numpy or load_model gives it), each leaf cut by
    shard_leaf; the rank's own tree comes back as it is."""
    from runbooks_tpu_torch.models.transformer import param_logical_axes

    def walk(p, a, path):
        if isinstance(p, dict):
            return {k: walk(p[k], a[k], f"{path}.{k}" if path else k)
                    for k in p}
        return shard_leaf(p, a, plan, rank, path.removeprefix("layers."))

    return walk(params, param_logical_axes(plan.cfg), "")


# ---------------------------------------------------------------------------
# The runtime side: plan + rank + process group
# ---------------------------------------------------------------------------

class TensorParallel:
    """One rank's view of a serving mesh: its plan, its rank in the mesh
    (``plan.coords``), its tensor group (None: the default group) and
    its serving group, every rank of the mesh (the tensor group when
    ``expert`` is 1). Attention, the dense MLP and the vocabulary run
    their collectives on the tensor group; the MoE combine and the
    sampled ids' broadcast (and the engine's program-call exchange) on
    the serving group. ``counts`` tallies the collectives by kind and
    ``group_counts`` by group and kind."""

    def __init__(self, plan: TensorPlan, rank: int, group=None,
                 serve_group=None):
        self.plan = plan
        self.rank = rank
        self.expert_rank, self.tensor_rank = plan.coords(rank)
        self.group = group
        self.serve_group = group if plan.expert == 1 else serve_group
        self.size = plan.tensor
        self.world = plan.world
        self.kv_map = plan.kv_map(rank)
        self.vocab_start = plan.vocab_range(rank).start
        self.experts = plan.expert_range(rank)
        self.moe_owner = plan.moe_owner(rank)
        self._kv_index: Dict[torch.device, torch.Tensor] = {}
        self.counts: Dict[str, int] = {"all_reduce": 0, "all_gather": 0,
                                       "broadcast": 0}
        self.group_counts: Dict[str, Dict[str, int]] = {
            "tensor": dict(self.counts), "serve": dict(self.counts)}

    def _tally(self, group: str, kind: str) -> None:
        self.counts[kind] += 1
        self.group_counts[group][kind] += 1

    @staticmethod
    def _src(group) -> int:
        """The global rank of ``group``'s rank 0."""
        import torch.distributed as dist

        return 0 if group is None else dist.get_global_rank(group, 0)

    def _leader(self) -> int:
        """The serving group's leader (global rank): rank 0 drives."""
        return self._src(self.serve_group)

    def all_reduce(self, x: torch.Tensor) -> torch.Tensor:
        import torch.distributed as dist

        x = x.contiguous()
        dist.all_reduce(x, group=self.group)
        self._tally("tensor", "all_reduce")
        return x

    def combine(self, x: torch.Tensor) -> torch.Tensor:
        """The MoE combine: every rank's partial sum (its experts' terms
        on its MLP columns) summed over the serving group."""
        import torch.distributed as dist

        x = x.contiguous()
        dist.all_reduce(x, group=self.serve_group)
        self._tally("serve", "all_reduce")
        return x

    def gather_vocab(self, x: torch.Tensor) -> torch.Tensor:
        """[..., V / T] local logits -> [..., V]."""
        import torch.distributed as dist

        x = x.contiguous()
        parts = [torch.empty_like(x) for _ in range(self.size)]
        dist.all_gather(parts, x, group=self.group)
        self._tally("tensor", "all_gather")
        return torch.cat(parts, dim=-1)

    def broadcast(self, x: torch.Tensor) -> torch.Tensor:
        """The serving group's rank 0's ``x`` on every rank (sampled ids:
        one stream decides)."""
        import torch.distributed as dist

        x = x.contiguous()
        dist.broadcast(x, src=self._leader(), group=self.serve_group)
        self._tally("serve", "broadcast")
        return x

    def embed(self, table: torch.Tensor, tokens: torch.Tensor,
              dtype: torch.dtype) -> torch.Tensor:
        """Rows of a vocabulary-sharded embedding: each rank looks up the
        ids it holds (zeros elsewhere) and the sum over ranks is exact."""
        local = tokens.long() - self.vocab_start
        held = (local >= 0) & (local < table.shape[0])
        x = table.to(dtype)[local.clamp(0, table.shape[0] - 1)]
        x = torch.where(held[..., None], x, torch.zeros((), dtype=dtype,
                                                         device=x.device))
        return self.all_reduce(x)

    def kv_index(self, device: torch.device) -> Optional[torch.Tensor]:
        """The non-uniform q -> kv map as an index tensor on ``device``
        (None when the map is uniform)."""
        if self.kv_map is None:
            return None
        if device not in self._kv_index:
            self._kv_index[device] = torch.tensor(self.kv_map,
                                                  device=device)
        return self._kv_index[device]


# ---------------------------------------------------------------------------
# FSDP (ZeRO-3) training over data x fsdp
# ---------------------------------------------------------------------------

def fsdp_dim(spec) -> Optional[int]:
    """The dimension a spec shards over ``fsdp`` (alone or in a tuple of
    mesh axes), or None."""
    for i, axes in enumerate(spec):
        if axes == "fsdp" or (isinstance(axes, tuple) and "fsdp" in axes):
            return i
    return None


@dataclasses.dataclass(frozen=True)
class FsdpPlan:
    """What each rank of a data x fsdp training mesh holds. ``params`` and
    ``lora`` are trees like the model's params and the LoRA tree (None in
    a full fine-tune); each leaf's entry is the dimension it shards over
    ``fsdp`` (fsdp index f holds the f-th of ``fsdp`` equal pieces) or
    None (replicated). Ranks are numbered data-major, as the DeviceMesh
    orders them: rank r sits at data index r // fsdp, fsdp index r %
    fsdp. Data replicas hold the same pieces."""

    mesh: Dict[str, int]
    params: Any
    lora: Any = None

    @property
    def data(self) -> int:
        return self.mesh["data"]

    @property
    def fsdp(self) -> int:
        return self.mesh["fsdp"]

    @property
    def world(self) -> int:
        return self.data * self.fsdp

    @property
    def trainable(self) -> Any:
        """The dims of the tree the optimizer updates."""
        return self.params if self.lora is None else self.lora

    def coords(self, rank: int) -> Tuple[int, int]:
        """(data index, fsdp index) of ``rank``."""
        return divmod(int(rank), self.fsdp)

    def block(self, rows: int, rank: int) -> Tuple[int, int, bool]:
        """(block index, blocks, owner) of ``rank`` in a microbatch of
        ``rows`` global rows: the microbatch splits into ``blocks`` equal
        blocks of consecutive rows over the mesh axes its spec keeps (the
        batch's ("data", "fsdp"), trailing axes dropped while their
        product does not divide it, as the reference's spec degrades),
        laid out data-major. A dropped axis holds copies of its index 0's
        block, which only that index owns."""
        axes = spec_for_array((rows,), ("batch",), self.mesh)[0]
        axes = () if axes is None else (
            (axes,) if isinstance(axes, str) else tuple(axes))
        d, f = self.coords(rank)
        index = {"data": d, "fsdp": f}
        block, blocks = 0, 1
        for a in axes:
            block = block * self.mesh[a] + index[a]
            blocks *= self.mesh[a]
        owner = all(index[a] == 0 for a in ("data", "fsdp") if a not in axes)
        return block, blocks, owner

    def local_shape(self, shape: Sequence[int], dim: Optional[int]
                    ) -> Tuple[int, ...]:
        out = list(shape)
        if dim is not None:
            out[dim] //= self.fsdp
        return tuple(out)

    def cut(self, leaf, dim: Optional[int], rank: int):
        """``rank``'s piece of the full ``leaf`` (the leaf itself where it
        is replicated)."""
        if dim is None:
            return leaf
        n = leaf.shape[dim] // self.fsdp
        return leaf.narrow(dim, self.coords(rank)[1] * n, n).contiguous()

    def cut_by_axes(self, leaf, axes: LogicalSpec, rank: int):
        """As ``cut``, the dimension read from the leaf's logical axes
        (``init_params(cut=)``: each leaf is cut as it is drawn)."""
        return self.cut(leaf, fsdp_dim(spec_for_array(leaf.shape, axes,
                                                      self.mesh)), rank)

    def shard(self, tree, dims, rank: int):
        """``rank``'s pieces of a full tree whose dims are ``dims``."""
        if isinstance(tree, dict):
            return {k: self.shard(tree[k], dims[k], rank) for k in tree}
        return self.cut(tree, dims, rank)

    def local_bytes(self, tree, dims) -> int:
        """The bytes one rank holds of a full tree (shapes and dtypes
        only; every rank holds as many)."""
        from runbooks_tpu_torch.utils.tree import tree_leaves

        total = 0
        for leaf, dim in zip(tree_leaves(tree), tree_leaves(dims),
                             strict=True):
            n = 1
            for s in self.local_shape(leaf.shape, dim):
                n *= s
            total += n * leaf.element_size()
        return total

    def describe(self) -> dict:
        from runbooks_tpu_torch.utils.tree import tree_leaves

        def count(dims):
            dims = list(tree_leaves(dims))
            return {"sharded": sum(d is not None for d in dims),
                    "replicated": sum(d is None for d in dims)}

        out = {"data": self.data, "fsdp": self.fsdp,
               "params": count(self.params)}
        if self.lora is not None:
            out["lora"] = count(self.lora)
        return out


class _GatherPiece(torch.autograd.Function):
    """The whole tensor from every fsdp rank's piece along ``dim``; its
    backward sums the gradient over the fsdp ranks and keeps this rank's
    piece (a reduce-scatter)."""

    @staticmethod
    def forward(ctx, piece, dim, fsdp):
        ctx.dim, ctx.fsdp = dim, fsdp
        return fsdp._all_gather(piece, dim)

    @staticmethod
    def backward(ctx, grad):
        return ctx.fsdp._reduce_scatter(grad, ctx.dim), None, None


@dataclasses.dataclass(frozen=True)
class RoutingGroup:
    """The batch ranks that route one global microbatch together, as the
    reference's sharded step routes it (models/moe.route's ``group``):
    this rank's ``block`` of the microbatch's ``blocks`` blocks of
    consecutive rows, whether it owns its rows (a copy routes as its
    owner does and counts nothing), and ``order``, the rank that owns
    each block; ``world`` ranks in ``process_group`` (None: the default
    group), whose gathers ``counts`` tallies."""

    block: int
    blocks: int
    owner: bool
    order: Tuple[int, ...]
    world: int
    process_group: Any = None
    counts: Optional[Dict[str, int]] = None

    @classmethod
    def of(cls, plan: "FsdpPlan", rows: int, rank: int,
           process_group=None, counts=None) -> "RoutingGroup":
        """``rank``'s group in a global microbatch of ``rows`` rows split
        as ``plan``'s batch is (``FsdpPlan.block``)."""
        block, blocks, owner = plan.block(rows, rank)
        order = [0] * blocks
        for r in range(plan.world):
            b, _, own = plan.block(rows, r)
            if own:
                order[b] = r
        return cls(block, blocks, owner, tuple(order), plan.world,
                   process_group, counts)

    def gather(self, counts: torch.Tensor) -> torch.Tensor:
        """Every owner's ``counts`` (integers) in block order, stacked:
        [blocks, *counts.shape] on ``counts``' device. One all-gather over
        the group; integers need no backward. Under gloo a CUDA tensor
        goes through the host."""
        import torch.distributed as dist

        x = counts.detach().contiguous()
        if (x.device.type != "cpu"
                and dist.get_backend(self.process_group) == "gloo"):
            x = x.cpu()
        parts = [torch.empty_like(x) for _ in range(self.world)]
        dist.all_gather(parts, x, group=self.process_group)
        if self.counts is not None:
            self.counts["routing_all_gather"] += 1
        return torch.stack([parts[r] for r in self.order]).to(counts.device)


# The stop decisions a trainer's rank 0 broadcasts at each step boundary.
STOP_REASONS = (None, "sigterm", "sigint", "maintenance")


class Fsdp:
    """One rank's view of a data x fsdp training group: its plan, its rank,
    the mesh's fsdp and data groups (the default group spans both) and the
    device of its collectives' small tensors. The train step and the
    forward call the collectives; ``counts`` tallies them by kind. An MoE
    forward routes each microbatch over every rank's rows (``routing``,
    one ``RoutingGroup.gather`` of [k, E] counts per layer and pass).

    A gradient is reduce-scattered (NCCL, and gloo on CPU tensors) or,
    where the backend has no reduce-scatter for the tensor (gloo on CUDA
    tensors), all-reduced with the rank's piece kept: the same sum."""

    def __init__(self, plan: FsdpPlan, rank: int, mesh, device,
                 compute_dtype: Optional[torch.dtype] = None):
        self.plan = plan
        self.rank = int(rank)
        # The dtype the forward reads frozen matrices in (the config's
        # activation dtype): such a leaf is cast before it is gathered.
        self.compute_dtype = compute_dtype
        self.data_index, self.fsdp_index = plan.coords(rank)
        self.device = torch.device(device)
        self.fsdp_group = mesh.get_group("fsdp")
        self.data_group = mesh.get_group("data")
        # The global rows of one microbatch (train/step.shard_batch sets
        # it): an MoE forward's block of the global microbatch.
        self.micro_rows: Optional[int] = None
        self.counts: Dict[str, int] = {"all_gather": 0, "reduce_scatter": 0,
                                       "all_reduce": 0, "broadcast": 0,
                                       "routing_all_gather": 0}

    # -- collectives ---------------------------------------------------------

    def _all_gather(self, piece: torch.Tensor, dim: int) -> torch.Tensor:
        import torch.distributed as dist

        piece = piece.contiguous()
        parts = [torch.empty_like(piece) for _ in range(self.plan.fsdp)]
        dist.all_gather(parts, piece, group=self.fsdp_group)
        self.counts["all_gather"] += 1
        return torch.cat(parts, dim=dim)

    def _scatters(self, t: torch.Tensor) -> bool:
        """Whether the fsdp group's backend reduce-scatters ``t`` (NCCL,
        and gloo on CPU tensors; gloo has none for CUDA tensors)."""
        import torch.distributed as dist

        return (dist.get_backend(self.fsdp_group) == "nccl"
                or t.device.type == "cpu")

    def _reduce_scatter(self, grad: torch.Tensor, dim: int) -> torch.Tensor:
        """This rank's piece of the gradient summed over the fsdp ranks,
        summed in f32 and returned in the gradient's dtype."""
        import torch.distributed as dist

        g = grad.float()
        n = g.shape[dim] // self.plan.fsdp
        if self._scatters(g):
            chunks = [c.contiguous() for c in g.chunk(self.plan.fsdp, dim)]
            out = torch.empty_like(chunks[0])
            dist.reduce_scatter(out, chunks, group=self.fsdp_group)
        else:
            # A copy: the incoming gradient is not ours to overwrite.
            g = g.clone(memory_format=torch.contiguous_format)
            dist.all_reduce(g, group=self.fsdp_group)
            out = g.narrow(dim, self.fsdp_index * n, n).contiguous()
        self.counts["reduce_scatter"] += 1
        return out.to(grad.dtype)

    def all_reduce(self, x: torch.Tensor, group=None) -> torch.Tensor:
        """``x`` summed over ``group`` (default: every rank), in place."""
        import torch.distributed as dist

        dist.all_reduce(x, group=group)
        self.counts["all_reduce"] += 1
        return x

    def _sum_flat(self, tensors: List[torch.Tensor], group,
                  size: int) -> None:
        """Each tensor summed over ``group`` in place, in one all-reduce."""
        if not tensors or size == 1:
            return
        flat = self.all_reduce(torch.cat([t.reshape(-1) for t in tensors]),
                               group)
        off = 0
        for t in tensors:
            t.copy_(flat[off:off + t.numel()].view_as(t))
            off += t.numel()

    def broadcast_stop(self, reason: Optional[str]) -> Optional[str]:
        """Rank 0's stop decision (STOP_REASONS) on every rank."""
        import torch.distributed as dist

        code = torch.tensor([STOP_REASONS.index(reason)], device=self.device)
        dist.broadcast(code, src=0)
        self.counts["broadcast"] += 1
        return STOP_REASONS[int(code.item())]

    def barrier(self) -> None:
        self.all_reduce(torch.zeros(1, device=self.device))

    def routing(self, rows: int) -> Optional["RoutingGroup"]:
        """The routing group of a microbatch of which this rank holds
        ``rows`` rows (None on one rank: it routes its whole microbatch
        alone). The global microbatch is ``micro_rows`` rows."""
        if self.plan.world == 1:
            return None
        if self.micro_rows is None:
            raise ValueError(
                "an MoE forward over data x fsdp ranks routes the global "
                "microbatch: cut the batch with train/step.shard_batch "
                "(it records the microbatch's global rows)")
        group = RoutingGroup.of(self.plan, self.micro_rows, self.rank,
                                counts=self.counts)
        if self.micro_rows // group.blocks != rows:
            raise ValueError(
                f"this rank holds {rows} rows of a microbatch, but its "
                f"block of the global microbatch ({self.micro_rows} rows "
                f"in {group.blocks} blocks) has "
                f"{self.micro_rows // group.blocks}")
        return group

    # -- the forward's gathers -------------------------------------------------

    def gather(self, piece: torch.Tensor, dim: Optional[int],
               cast: bool = False) -> torch.Tensor:
        """The whole tensor of a piece sharded along ``dim`` (``piece``
        itself when it is replicated). Where ``piece`` requires grad its
        gradient comes back reduce-scattered; a frozen piece (a LoRA
        job's base) sends no gradient traffic, and with ``cast`` (the
        forward reads it only in ``compute_dtype``) it is cast first: the
        same values at half the bytes for an f32 base."""
        if dim is None or self.plan.fsdp == 1:
            return piece
        if piece.requires_grad:
            return _GatherPiece.apply(piece, dim, self)
        if cast and self.compute_dtype is not None:
            piece = piece.to(self.compute_dtype)
        return self._all_gather(piece, dim)

    def outer(self, params: dict) -> dict:
        """``params`` with every leaf outside the stacked layers whole
        (the embedding, the head, learned positions, all read in the
        compute dtype): gathered once per forward, so a tied head's
        gradient and the embedding's meet in one reduce-scatter."""
        dims = self.plan.params
        return {k: (v if k == "layers" or not torch.is_tensor(v)
                    else self.gather(v, dims[k], cast=True))
                for k, v in params.items()}

    def layer(self, layers: dict, lora, li: int):
        """(layer ``li``'s leaves whole, as [1, ...] stacks; its LoRA
        factors likewise, or None): the forward's block reads them at
        layer 0. Called inside the checkpointed block, so remat frees the
        gathered leaves and the recompute gathers them again."""
        dims = self.plan.params["layers"]
        targets = () if lora is None else lora.factors

        def one(w, dim, cast=False):
            return self.gather(w[li], None if dim is None else dim - 1,
                               cast)[None]

        # A LoRA target is merged with its delta in f32 (LoraDeltas); the
        # other matrices are read in the compute dtype.
        out = {g: {n: one(w, dims[g][n], f"{g}.{n}" not in targets)
                   for n, w in mats.items()}
               for g, mats in layers.items()}
        if lora is None:
            return out, None
        ldims = self.plan.lora
        factors = {t: {k: one(f[k], ldims[t][k]) for k in f}
                   for t, f in lora.factors.items()}
        return out, type(lora)(factors, lora.scale)

    # -- the step's sums ---------------------------------------------------------

    def reduce_grads(self, grads: List[torch.Tensor]) -> None:
        """The trainable leaves' gradients (in tree_leaves order) summed in
        place: a sharded leaf's piece (already summed over fsdp by its
        gather's backward) over the data ranks, a replicated leaf's over
        every rank."""
        from runbooks_tpu_torch.utils.tree import tree_leaves

        dims = list(tree_leaves(self.plan.trainable))
        self._sum_flat([g for g, d in zip(grads, dims, strict=True)
                        if d is None], None, self.plan.world)
        self._sum_flat([g for g, d in zip(grads, dims) if d is not None],
                       self.data_group, self.plan.data)

    def global_norm(self, grads) -> torch.Tensor:
        """The global norm of the trainable tree's gradients: each sharded
        leaf's squares summed over the fsdp ranks once, each replicated
        leaf's counted once."""
        from runbooks_tpu_torch.utils.tree import tree_leaves

        dims = list(tree_leaves(self.plan.trainable))
        zero = torch.zeros((), dtype=torch.float32, device=self.device)
        sharded, replicated = zero, zero
        for g, d in zip(tree_leaves(grads), dims, strict=True):
            sq = torch.sum(g.float() ** 2)
            if d is None:
                replicated = replicated + sq
            else:
                sharded = sharded + sq
        if self.plan.fsdp > 1:
            sharded = self.all_reduce(sharded, self.fsdp_group)
        return torch.sqrt(sharded + replicated)

    # -- checkpoints -------------------------------------------------------------

    def gather_full(self, tree, dims):
        """The whole of a sharded tree on rank 0, on the CPU (None on the
        other ranks), gathered one leaf at a time over the fsdp ranks of
        data index 0. Leaves that are not tensors pass through."""
        def walk(t, d):
            if isinstance(t, dict):
                return {k: walk(t[k], d[k] if isinstance(d, dict) else None)
                        for k in t}
            if not torch.is_tensor(t):
                return t
            if d is not None and self.plan.fsdp > 1 and self.data_index == 0:
                t = self._all_gather(t, d)
            return t.cpu() if self.rank == 0 else None

        out = walk(tree, dims)
        return out if self.rank == 0 else None
