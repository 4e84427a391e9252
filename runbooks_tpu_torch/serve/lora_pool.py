"""LoRA adapters for serving (the port of ``runbooks_tpu.serve.lora_pool``):
the load-time fold of one adapter, and the device-resident pool that lets
many tenants share one base.

An adapter artifact is exactly what a LoRA training run leaves behind
(train/trainer.py): a directory with ``checkpoints/`` holding the train
state whose params are the LoRA tree ({target: {"a": [L, in, r], "b": [L,
r, out]}}) and ``lora.json`` carrying {rank, alpha, targets}.

- ``load_merge_adapter`` folds one adapter into the base weights at load
  time: one tenant served with no per-token overhead, and the parity
  oracle of the pooled path.
- ``AdapterPool`` keeps up to ``pool_size`` adapters resident on the
  device as stacked tensors (ops/lora.py; lane ``pool_size`` is the
  all-zero trash lane base-only rows gather), pages adapters in from
  artifact storage on demand and evicts by LRU among lanes no in-flight
  request pins. Like the paged engine's allocator, refcounts pin what live
  slots use and admission is the only backpressure point: a non-resident
  adapter with no evictable lane leaves its request queued, and the queue
  backs up until submit() sheds with a 429. Nothing is torn out from
  under a running request.
- ``load_adapter_tree`` turns one artifact into the pool's layout on the
  host in f32: rank zero-padded to the pool's bucket, alpha/rank folded
  into B, untrained targets zero. A lane write then copies each leaf to
  the device once, in place (ops/lora.write_lane).
- Under a serving mesh each rank's pool holds its shard of every lane
  (``cut``: the rank's parallel/sharding.shard_leaf). The leader's pool
  alone decides residency, loads, evictions and LRU; its lane writes go
  through ``write`` (the engine's), on which every follower reads the
  same artifact, cuts it to its shard and writes the same lane.
"""

from __future__ import annotations

import json
import os
import threading
from typing import Dict, List, Optional

import torch

from runbooks_tpu_torch.models.config import ModelConfig
from runbooks_tpu_torch.models.transformer import param_logical_axes
from runbooks_tpu_torch.ops.lora import (
    adapter_tree_logical_axes,
    init_adapter_pool,
    nest_targets,
    target_dims,
    write_lane,
)
from runbooks_tpu_torch.train.checkpoint import CheckpointManager
from runbooks_tpu_torch.train.lora import LoraConfig, apply_lora
from runbooks_tpu_torch.utils.hw import resolve_device

ADAPTER_META = "lora.json"


class AdapterLoadError(ValueError):
    """An adapter artifact cannot be loaded (missing checkpoint, rank above
    the pool's bucket, target or shape mismatch). The engine surfaces it
    per request (HTTP 400 at validation, finish_reason "error" when it
    only fails at admission); it never crashes the engine loop."""


def save_adapter(path: str, lora_tree, rank: int, alpha: float,
                 targets=None) -> None:
    """Write a serving-loadable adapter artifact (the trainer's layout:
    checkpoints/ + lora.json), for tests and tools."""
    os.makedirs(path, exist_ok=True)
    CheckpointManager(path).save(0, {"params": lora_tree}, force=True)
    meta = {"rank": int(rank), "alpha": float(alpha)}
    if targets is not None:
        meta["targets"] = list(targets)
    with open(os.path.join(path, ADAPTER_META), "w") as f:
        json.dump(meta, f)


def read_adapter_meta(path: str) -> dict:
    """lora.json contents ({} when absent: rank then comes from the
    checkpoint's shapes and alpha defaults to train/lora.py's 16.0)."""
    meta_path = os.path.join(path, ADAPTER_META)
    if not os.path.exists(meta_path):
        return {}
    try:
        with open(meta_path) as f:
            return dict(json.load(f))
    except (OSError, ValueError) as exc:
        raise AdapterLoadError(
            f"adapter {path!r}: unreadable {ADAPTER_META}: {exc}") from exc


def adapter_artifact_ok(path: str) -> Optional[str]:
    """None when ``path`` looks like a loadable adapter directory, else the
    reason it is not. Existence only; shapes are checked at load."""
    if not os.path.isdir(path):
        return f"adapter {path!r}: no such directory"
    if not os.path.isdir(os.path.join(path, "checkpoints")):
        return (f"adapter {path!r}: no checkpoints/ directory (expected "
                "a LoRA training artifact — train/trainer.py layout)")
    return None


def _restore_lora(path: str) -> dict:
    """The LoRA tree of an adapter artifact, on the host. Raises
    AdapterLoadError when the directory, its checkpoint or its tree is
    missing or unreadable."""
    err = adapter_artifact_ok(path)
    if err is not None:
        raise AdapterLoadError(err)
    try:
        full, _, _ = CheckpointManager(path).restore_with_cursor(
            device=torch.device("cpu"), mmap=True)
    except (FileNotFoundError, RuntimeError) as exc:
        raise AdapterLoadError(
            f"adapter {path!r}: checkpoint restore failed: {exc}") from exc
    lora = full.get("params") if isinstance(full, dict) else None
    if not isinstance(lora, dict) or not lora:
        raise AdapterLoadError(
            f"adapter {path!r}: checkpoint holds no LoRA params tree")
    return lora


def load_adapter_tree(path: str, cfg: ModelConfig, targets, rank: int,
                      cut=None):
    """One adapter artifact in the pool's layout: {"attn"/"mlp": {name:
    {"a": [L, d_in, rank], "b": [L, rank, d_out]}}} f32 tensors on the host
    covering EVERY pool target. Targets the adapter did not train are zero
    (a recycled lane must not keep the previous tenant's delta); trained
    ones are rank-padded with zeros and have alpha/rank folded into B.
    Raises AdapterLoadError on any mismatch, before anything is copied to
    the device. ``cut(leaf, axes)`` (a serving rank's
    parallel/sharding.shard_leaf) then cuts each pair to the rank's lane
    shape (ops/lora.adapter_tree_logical_axes)."""
    lora = _restore_lora(path)
    # Structure first, before any indexing: a malformed artifact raises
    # the typed error, never a KeyError that would escape the engine's
    # per-request handling.
    for t, ab in lora.items():
        if not (isinstance(ab, dict) and "a" in ab and "b" in ab
                and torch.is_tensor(ab["a"]) and torch.is_tensor(ab["b"])
                and ab["a"].dim() >= 2 and ab["b"].dim() >= 2):
            raise AdapterLoadError(
                f"adapter {path!r}: target {t} is not an {{a, b}} LoRA "
                "pair (expected the train/lora.py artifact layout)")
    meta = read_adapter_meta(path)
    extra = sorted(set(lora) - set(targets))
    if extra:
        raise AdapterLoadError(
            f"adapter {path!r} trains target(s) {extra} the pool does "
            f"not inject; serve with lora_targets covering them "
            f"(pool targets: {sorted(targets)})")
    first = next(iter(lora.values()))
    a_rank = int(first["a"].shape[-1])
    alpha = float(meta.get("alpha", 16.0))
    a_meta_rank = int(meta.get("rank", a_rank))
    if a_meta_rank != a_rank:
        raise AdapterLoadError(
            f"adapter {path!r}: {ADAPTER_META} rank {a_meta_rank} does "
            f"not match checkpoint rank {a_rank}")
    L = cfg.num_layers
    flat = {}
    for t in targets:
        d_in, d_out = target_dims(cfg, t)
        if t not in lora:
            flat[t] = {"a": torch.zeros((L, d_in, rank)),
                       "b": torch.zeros((L, rank, d_out))}
            continue
        a = lora[t]["a"].float()
        b = lora[t]["b"].float()
        want_a, want_b = (L, d_in, a_rank), (L, a_rank, d_out)
        if tuple(a.shape) != want_a or tuple(b.shape) != want_b:
            raise AdapterLoadError(
                f"adapter {path!r}: target {t} shapes "
                f"a{tuple(a.shape)}/b{tuple(b.shape)} do not match "
                f"model {cfg.name!r} (want a{want_a}/b{want_b})")
        if a_rank > rank:
            raise AdapterLoadError(
                f"adapter rank {a_rank} exceeds the pool's rank bucket "
                f"{rank}; raise lora_rank on the serving config (every "
                "lane has the bucket's shape)")
        pad_a = torch.zeros((L, d_in, rank))
        pad_a[:, :, :a_rank] = a
        pad_b = torch.zeros((L, rank, d_out))
        pad_b[:, :a_rank] = b * (alpha / float(a_rank))
        flat[t] = {"a": pad_a, "b": pad_b}
    if cut is not None:
        flat = {t: {k: cut(v, adapter_tree_logical_axes(t)[k])
                    for k, v in ab.items()} for t, ab in flat.items()}
    return nest_targets(flat)


def load_merge_adapter(path: str, cfg: ModelConfig, base_params, cut=None):
    """Base params with one adapter artifact folded in (train/lora.py
    apply_lora: what the trainer's merge would produce), on the base's
    device. The single-tenant path and the pooled path's parity oracle.
    Raises AdapterLoadError when the artifact does not fit. ``cut`` (a
    tensor-parallel rank's parallel/sharding.shard_leaf) when the base is
    that rank's shard: each pair is cut to its weight's local columns (a
    by the weight's input axis, b by its output axis), so the fold is the
    shard of the full fold."""
    lora = _restore_lora(path)
    if cut is not None:
        axes = param_logical_axes(cfg)["layers"]
        for target, ab in lora.items():
            group, _, name = target.partition(".")
            w_axes = axes.get(group, {}).get(name)
            if w_axes is not None and isinstance(ab, dict) and {
                    "a", "b"} <= set(ab):
                layers_ax, in_ax, out_ax = w_axes
                ab["a"] = cut(ab["a"], (layers_ax, in_ax, None))
                ab["b"] = cut(ab["b"], (layers_ax, None, out_ax))
    layers = base_params["layers"]
    for target, ab in lora.items():
        group, _, name = target.partition(".")
        w = layers.get(group, {}).get(name)
        if w is None or not (isinstance(ab, dict) and "a" in ab
                             and "b" in ab):
            raise AdapterLoadError(
                f"adapter {path!r}: target {target!r} is not an {{a, b}} "
                f"pair on a weight of model {cfg.name!r}")
        a, b = ab["a"], ab["b"]
        if (a.ndim != 3 or b.ndim != 3 or tuple(a.shape[:2]) != w.shape[:2]
                or b.shape[0] != w.shape[0] or b.shape[2] != w.shape[2]
                or a.shape[2] != b.shape[1]):
            raise AdapterLoadError(
                f"adapter {path!r}: target {target} shapes "
                f"a{tuple(a.shape)}/b{tuple(b.shape)} do not fit the "
                f"weight {tuple(w.shape)} of model {cfg.name!r}")
    dev = base_params["embed"].device
    lora = {t: {k: v.to(dev) for k, v in ab.items()}
            for t, ab in lora.items()}
    meta = read_adapter_meta(path)
    rank = int(meta.get("rank", next(iter(lora.values()))["a"].shape[-1]))
    lcfg = LoraConfig(rank=rank, alpha=float(meta.get("alpha", 16.0)),
                      targets=tuple(lora))
    return apply_lora(base_params, lora, lcfg)


class AdapterPool:
    """Host-side manager of the device-resident adapter pool. Driven from
    the engine's single thread, like the engine; the counters are plain
    ints. ``requests`` is also lock-guarded, because submit() (HTTP handler
    threads) counts into it while the engine thread swaps lanes.

    ``tree`` is the pool (ops/lora.init_adapter_pool) on ``device`` (the
    engine's; None: the current CUDA device, raising without one). ``cut``
    (a serving rank's parallel/sharding.shard_leaf): the pool and every
    loaded adapter hold the rank's shard. ``write(adapter, lane, path)``
    performs a lane write (default: ops/lora.write_lane into ``tree``; a
    sharded engine's leader has every rank write it)."""

    def __init__(self, cfg: ModelConfig, pool_size: Optional[int] = None,
                 rank: Optional[int] = None, root: Optional[str] = None,
                 loader=None, device=None, cut=None, write=None):
        self.cfg = cfg
        self.pool_size = int(pool_size if pool_size is not None
                             else cfg.adapter_pool)
        self.rank = int(rank if rank is not None else cfg.lora_rank)
        self.targets = tuple(cfg.lora_targets)
        if cfg.moe_num_experts and any(t.startswith("mlp.")
                                       for t in self.targets):
            raise ValueError(
                "adapter pools cannot inject mlp targets on an MoE "
                "model (the expert FFN has no single target matrix); "
                "restrict lora_targets to attention")
        # Fail at construction on targets the architecture lacks.
        for t in self.targets:
            target_dims(cfg, t)
        self.root = root
        self._loader = loader or (lambda path: load_adapter_tree(
            path, self.cfg, self.targets, self.rank, cut))
        self.device = resolve_device(device)
        self.tree = init_adapter_pool(cfg, self.pool_size, self.rank,
                                      self.targets, self.device, cut)
        self._write = write or (lambda adapter, lane, path: write_lane(
            self.tree, adapter, lane))
        self._lane_name: List[Optional[str]] = [None] * self.pool_size
        self._lane_ref = [0] * self.pool_size          # pinned by requests
        self._lane_used = [0] * self.pool_size         # LRU clock stamps
        self._clock = 0
        self._by_name: Dict[str, int] = {}
        self.loads = 0        # artifact reads -> lane writes
        self.evictions = 0    # resident adapters displaced
        self.hits = 0         # acquires served from residency
        self._req_lock = threading.Lock()
        self.requests: Dict[str, int] = {}   # guarded-by: _req_lock

    # -- observability -------------------------------------------------

    def resident(self) -> List[str]:
        return [n for n in self._lane_name if n is not None]

    def stats(self) -> dict:
        with self._req_lock:
            requests = dict(self.requests)
        return {"pool_size": self.pool_size, "rank": self.rank,
                "resident": self.resident(), "loads": self.loads,
                "evictions": self.evictions, "hits": self.hits,
                "requests": requests}

    def count_request(self, name: str) -> None:
        with self._req_lock:
            self.requests[name] = self.requests.get(name, 0) + 1

    def pool_bytes(self) -> int:
        return sum(ab[k].numel() * ab[k].element_size()
                   for sub in self.tree.values() for ab in sub.values()
                   for k in ("a", "b"))

    # -- name resolution -----------------------------------------------

    def resolve(self, name: str) -> str:
        """Adapter name -> artifact path: absolute paths pass through,
        relative names join the adapter root (``adapter_dir``)."""
        if os.path.isabs(name) or self.root is None:
            return name
        return os.path.join(self.root, name)

    def can_resolve(self, name: str) -> Optional[str]:
        """Submit-time check for 400s: None when the adapter is resident
        or its artifact looks loadable, else the reason."""
        if name in self._by_name:
            return None
        return adapter_artifact_ok(self.resolve(name))

    # -- residency -----------------------------------------------------

    def _touch(self, lane: int) -> None:
        self._clock += 1
        self._lane_used[lane] = self._clock

    def _victim_lane(self) -> Optional[int]:
        """Lane to (re)use: an empty lane first, else the LRU lane no
        in-flight request pins. None: every lane is pinned (the caller
        leaves the request queued)."""
        for lane, name in enumerate(self._lane_name):
            if name is None:
                return lane
        candidates = [lane for lane in range(self.pool_size)
                      if self._lane_ref[lane] == 0]
        if not candidates:
            return None
        return min(candidates, key=lambda lane: self._lane_used[lane])

    def acquire(self, name: str) -> Optional[int]:
        """Pin ``name``'s lane for one request, paging the adapter in from
        artifact storage when it is not resident. Returns the lane, or
        None when every lane is pinned. Raises AdapterLoadError when the
        artifact cannot load; the artifact is read before anything is
        evicted, so a bad one leaves the pool as it was."""
        lane = self._by_name.get(name)
        if lane is not None:
            self.hits += 1
            self._lane_ref[lane] += 1
            self._touch(lane)
            return lane
        lane = self._victim_lane()
        if lane is None:
            return None
        path = self.resolve(name)
        adapter = self._loader(path)
        old = self._lane_name[lane]
        # The lane is written in place: a write that raises leaves it
        # unnamed (its content is no longer the old adapter's).
        self._lane_name[lane] = None
        if old is not None:
            self.evictions += 1
            del self._by_name[old]
        self._write(adapter, lane, path)
        self._lane_name[lane] = name
        self._by_name[name] = lane
        self._lane_ref[lane] = 1
        self._touch(lane)
        self.loads += 1
        return lane

    def load(self, path: str):
        """An artifact in this pool's lane layout (its shard under a
        mesh), as ``acquire`` reads it."""
        return self._loader(path)

    def release(self, lane: int) -> None:
        if lane < 0:
            return
        if self._lane_ref[lane] <= 0:
            raise RuntimeError(f"release of unpinned adapter lane {lane}")
        self._lane_ref[lane] -= 1

    def reset_refs(self) -> None:
        """Recovery (engine.reset()): every in-flight request is gone, so
        no lane is pinned. Residency survives: no engine step writes the
        pool, so its lanes are intact after a failed step."""
        self._lane_ref = [0] * self.pool_size

    def warm(self) -> None:
        """The engine's warmup calls this: one lane write of zeros into
        lane 0 while it is empty (content unchanged), so the first load
        under traffic pays no first copy or cast. Eager PyTorch has no
        compile to warm; with an adapter resident in lane 0 this is a
        no-op."""
        if self._lane_name[0] is not None:
            return
        zero = {group: {name: {k: torch.zeros(
            (v.shape[0],) + tuple(v.shape[2:])) for k, v in ab.items()}
            for name, ab in sub.items()} for group, sub in self.tree.items()}
        write_lane(self.tree, zero, 0)
