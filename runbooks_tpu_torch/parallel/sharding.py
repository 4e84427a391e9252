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
q heads read. ``shard_params`` cuts one rank's tree by the plan, and
``TensorParallel`` carries the plan, the rank and the process group into
the forward (models/transformer.py), which runs on local widths:

- one all-reduce after ``wo`` and one after the MLP's ``wo`` (one for a
  parallel block); replicated leaves (norms, ``bo``, the MLP ``bo``) are
  added once, after the reduce;
- the embedding, when the vocabulary shards, is looked up with a mask and
  summed over ranks (exact: one rank holds each row);
- the head's local logits are all-gathered over the vocabulary.
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
    """What each of ``tensor`` ranks holds of one model: per side, shard
    (contiguous equal pieces, rank r the r-th) or replicate."""

    cfg: Any                 # the ModelConfig
    tensor: int
    heads: bool              # q heads: wq's columns, bq, wo's rows
    kv_heads: bool           # kv heads: wk/wv's columns, bk/bv, the cache
    mlp: bool                # the MLP width
    vocab: bool              # the embedding's rows and the head's columns

    def q_heads(self, rank: int) -> range:
        h = self.cfg.num_heads
        if not self.heads:
            return range(h)
        n = h // self.tensor
        return range(rank * n, (rank + 1) * n)

    def kv_head_ids(self, rank: int) -> range:
        """The kv heads rank ``rank`` holds: its shard, or, where q heads
        shard alone, the (contiguous) kv heads its q heads read."""
        kvh = self.cfg.num_kv_heads
        if self.kv_heads:
            n = kvh // self.tensor
            return range(rank * n, (rank + 1) * n)
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
        n = v // self.tensor
        return range(rank * n, (rank + 1) * n)

    def mlp_range(self, rank: int) -> range:
        m = self.cfg.intermediate_size
        if not self.mlp:
            return range(m)
        n = m // self.tensor
        return range(rank * n, (rank + 1) * n)

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
        return None

    def local_shape(self, shape: Sequence[int], axes: LogicalSpec,
                    rank: int) -> Tuple[int, ...]:
        out = []
        for dim, name in zip(shape, axes):
            r = self._dim_range(name, rank)
            out.append(dim if r is None else len(r))
        return tuple(out)

    def local_param_bytes(self, params, rank: int) -> int:
        """The bytes rank ``rank``'s tree holds, from the full tree's
        shapes and dtypes and the plan alone (no slicing)."""
        from runbooks_tpu_torch.models.transformer import param_logical_axes
        from runbooks_tpu_torch.utils.tree import tree_leaves

        axes = list(tree_leaves(param_logical_axes(self.cfg)))
        total = 0
        for leaf, ax in zip(tree_leaves(params), axes, strict=True):
            n = 1
            for s in self.local_shape(leaf.shape, ax, rank):
                n *= s
            total += n * leaf.element_size()
        return total

    def describe(self) -> dict:
        return {"tensor": self.tensor, "heads": self.heads,
                "kv_heads": self.kv_heads, "mlp": self.mlp,
                "vocab": self.vocab}


def serve_plan(cfg, tensor: int) -> TensorPlan:
    """The plan of ``cfg`` over ``tensor`` ranks, from DEFAULT_RULES at
    whole-head granularity: a side shards when the table maps its logical
    axis to ``tensor`` and ``tensor`` divides its count (heads, kv heads,
    the MLP width, the vocabulary). kv heads shard only with the q heads
    (a q head never reads a kv head of another rank's)."""
    mesh = {"tensor": int(tensor)}

    def shards(count: int, name: str) -> bool:
        return int(tensor) > 1 and spec_for_array(
            (count,), (name,), mesh) == ("tensor",)

    heads = shards(cfg.num_heads, "heads")
    return TensorPlan(cfg=cfg, tensor=int(tensor), heads=heads,
                      kv_heads=heads and shards(cfg.num_kv_heads, "kv_heads"),
                      mlp=shards(cfg.intermediate_size, "mlp"),
                      vocab=shards(cfg.vocab_size, "vocab"))


def shard_leaf(leaf, axes: LogicalSpec, plan: TensorPlan, rank: int):
    """One leaf (logical ``axes``) cut to the columns the plan gives rank
    ``rank``, a tensor of its own where it is cut. A dimension already at
    its local width is kept, so the rank's own shard passes through."""
    from runbooks_tpu_torch.ops.quantization import QuantizedArray

    if isinstance(leaf, QuantizedArray):
        raise NotImplementedError(
            "quantized weights under a mesh (mesh_tensor > 1) are not "
            "ported yet (ROADMAP.md §1): serve them on one device")
    cfg = plan.cfg
    full = {"heads": cfg.q_dim, "kv_heads": cfg.kv_dim,
            "mlp": cfg.intermediate_size, "vocab": cfg.vocab_size}
    out = leaf
    for dim, name in enumerate(axes):
        r = plan._dim_range(name, rank)
        if r is None or out.shape[dim] == len(r):
            continue
        if out.shape[dim] != full[name]:
            raise ValueError(
                f"a {name!r} dimension of {out.shape[dim]} is neither "
                f"{cfg.name!r}'s {full[name]} nor rank {rank}'s {len(r)}")
        out = out.narrow(dim, r.start, len(r))
    return out.contiguous() if out is not leaf else out


def shard_params(params, plan: TensorPlan, rank: int):
    """Rank ``rank``'s local tree of a full port tree (as
    models/bridge.from_jax_numpy or load_model gives it), each leaf cut by
    shard_leaf; the rank's own tree comes back as it is."""
    from runbooks_tpu_torch.models.transformer import param_logical_axes

    def walk(p, a):
        if isinstance(p, dict):
            return {k: walk(p[k], a[k]) for k in p}
        return shard_leaf(p, a, plan, rank)

    return walk(params, param_logical_axes(plan.cfg))


# ---------------------------------------------------------------------------
# The runtime side: plan + rank + process group
# ---------------------------------------------------------------------------

class TensorParallel:
    """One rank's view of a tensor-parallel group: its plan, its rank in
    the group and the group (None: the default group). The forward calls
    the collectives; ``counts`` tallies them by kind."""

    def __init__(self, plan: TensorPlan, rank: int, group=None):
        self.plan = plan
        self.rank = rank
        self.group = group
        self.size = plan.tensor
        self.kv_map = plan.kv_map(rank)
        self.vocab_start = plan.vocab_range(rank).start
        self._kv_index: Dict[torch.device, torch.Tensor] = {}
        self.counts: Dict[str, int] = {"all_reduce": 0, "all_gather": 0,
                                       "broadcast": 0}

    def _leader(self) -> int:
        import torch.distributed as dist

        return dist.get_global_rank(self.group, 0) if self.group else 0

    def all_reduce(self, x: torch.Tensor) -> torch.Tensor:
        import torch.distributed as dist

        x = x.contiguous()
        dist.all_reduce(x, group=self.group)
        self.counts["all_reduce"] += 1
        return x

    def gather_vocab(self, x: torch.Tensor) -> torch.Tensor:
        """[..., V / T] local logits -> [..., V]."""
        import torch.distributed as dist

        x = x.contiguous()
        parts = [torch.empty_like(x) for _ in range(self.size)]
        dist.all_gather(parts, x, group=self.group)
        self.counts["all_gather"] += 1
        return torch.cat(parts, dim=-1)

    def broadcast(self, x: torch.Tensor) -> torch.Tensor:
        """Rank 0's ``x`` on every rank (sampled ids: one stream decides)."""
        import torch.distributed as dist

        x = x.contiguous()
        dist.broadcast(x, src=self._leader(), group=self.group)
        self.counts["broadcast"] += 1
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
