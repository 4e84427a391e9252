"""Paged KV cache with radix-tree prefix sharing, a host swap tier and QoS
preemption for the serving engine (the port of
``runbooks_tpu.serve.paging``).

The dense engine (serve/engine.py) reserves a whole ``[max_seq_len+1]``
cache row per slot, so concurrency is fixed by the worst-case sequence
length and a shared system prompt is stored once per slot. This module
breaks the cache into fixed-size pages and shares physical pages between
requests:

- **Page pool** (``PagePool`` + ``PageAllocator``): K/V live in
  ``[layers, num_pages+1, page_size, kv_heads, head_dim]`` tensors on the
  engine's device (the last page is the trash page, the write target of
  padding and parked rows, never allocated). A host-side free list hands
  out pages; refcounts track how many owners (slots, the radix tree) hold
  each page.
- **Radix tree** (``RadixTree``): a host-side trie over token ids at page
  granularity. Each edge is exactly ``page_size`` tokens and each node
  owns the physical page holding that span's K/V. Admission matches the
  longest stored prefix and maps the slot's leading page-table entries to
  the same physical pages; finished requests adopt their fully written
  pages into the tree, so every served prompt seeds reuse for the next.
  Unreferenced pages evict LRU under page pressure.
- **Copy-on-write by construction**: shared pages hold only complete pages
  of an earlier request's written history, and a slot writes at positions
  at or past its own prompt length, in its private pages. Requests that
  share a prefix diverge without copying a page.
- **Host tier** (``HostPagePool``): with ``kv_host_pages`` > 0 an evicted
  page copies into a pinned host buffer instead of dropping; a later
  admission that matches it copies it back instead of recomputing.
- **Preemption** (``preemption="swap"``): a queue head of a better QoS
  class, blocked on slots or pages, displaces the worst-class active slot
  at a step boundary; the victim's written pages go into the tree and it
  resumes from a radix match on its own history.

Attention runs over a **gathered view**: decode gathers each slot's pages
once per chunk into a contiguous ``[slots, view + 1]`` view (the extra
position is the view's trash slot for parked rows), runs ``forward`` on
it, and writes each newly written token back to its page. Prefill runs the
normal cached ``forward`` on scratch rows (through K1, the flash kernel, on
CUDA) after gathering a shared prefix into them. Every write into the pool
is an in-place ``index_put_`` on a flat view of its storage.

int8 KV (``quantize_kv``) composes: pages hold int8 K/V plus one f32 scale
per (layer, page, token, kv head); the view, the write-back, the host tier
and the swaps carry the scales beside the values. A prefill dequantizes
the shared prefix pages it gathers and quantizes the suffix it scatters.

Under a serving mesh every rank's pool and host tier hold its own kv
heads of each page. The allocator, the radix tree, the page tables and
the host tier's free list are rank 0's: it decides every swap-out,
swap-in, drop and preemption, and each page copy is a program
(``kv_swap_out`` / ``kv_swap_in``) that every follower replays on its
shard, into the host slot rank 0 picked.
"""

from __future__ import annotations

import collections
import dataclasses
import heapq
import time
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from runbooks_tpu_torch.models.config import ModelConfig
from runbooks_tpu_torch.models.transformer import KVCache, forward, lm_head
from runbooks_tpu_torch.obs import device as obs_device
from runbooks_tpu_torch.obs import metrics as obs_metrics
from runbooks_tpu_torch.ops.quantization import dequantize_kv, quantize_kv
from runbooks_tpu_torch.ops.sampling import sample, speculative_verify
from runbooks_tpu_torch.serve.engine import (
    PRIORITY_RANK,
    EngineStepFailed,
    InferenceEngine,
    Params,
    Request,
    _scratch_rows,
    local_kv_heads,
    sample_ids,
    view_buckets_for,
)
from runbooks_tpu_torch.parallel.mesh import mesh_config_of
from runbooks_tpu_torch.utils import cuda_build

# ---------------------------------------------------------------------------
# Page pool
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class PagePool:
    """Device-side paged KV storage.

    k, v: [num_layers, num_pages + 1, page_size, num_kv_heads, head_dim]
    in the activation dtype, or int8 with ``quantize_kv``; then k_scale,
    v_scale [num_layers, num_pages + 1, page_size, num_kv_heads] f32 hold
    one scale per token and kv head (None otherwise). Page ``num_pages``
    is the TRASH page: the write target of padding rows and parked decode
    slots, never handed out by the allocator."""

    k: torch.Tensor
    v: torch.Tensor
    k_scale: Optional[torch.Tensor] = None
    v_scale: Optional[torch.Tensor] = None

    @classmethod
    def create(cls, cfg: ModelConfig, num_pages: int, page_size: int,
               device, quantize_kv: bool = False,
               kv_heads: Optional[int] = None) -> "PagePool":
        """``kv_heads``: the kv heads the pool holds (default all; a
        tensor-parallel rank holds its own)."""
        shape = (cfg.num_layers, num_pages + 1, page_size,
                 cfg.num_kv_heads if kv_heads is None else kv_heads,
                 cfg.head_dim)
        if quantize_kv:
            return cls(
                k=torch.zeros(shape, dtype=torch.int8, device=device),
                v=torch.zeros(shape, dtype=torch.int8, device=device),
                k_scale=torch.zeros(shape[:-1], dtype=torch.float32,
                                    device=device),
                v_scale=torch.zeros(shape[:-1], dtype=torch.float32,
                                    device=device))
        return cls(k=torch.zeros(shape, dtype=cfg.activation_dtype,
                                 device=device),
                   v=torch.zeros(shape, dtype=cfg.activation_dtype,
                                 device=device))

    @property
    def quantized(self) -> bool:
        return self.k.dtype == torch.int8

    @property
    def nbytes(self) -> int:
        return sum(t.numel() * t.element_size()
                   for t in (self.k, self.v, self.k_scale, self.v_scale)
                   if t is not None)

    def flat(self) -> Tuple[torch.Tensor, torch.Tensor]:
        """k and v as [L, (num_pages+1)*page_size, kvh, d] views of the same
        storage: a write through them is a write into the pool."""
        L, n, ps, kvh, d = self.k.shape
        return (self.k.view(L, n * ps, kvh, d),
                self.v.view(L, n * ps, kvh, d))

    def flat_scales(self) -> Tuple[Optional[torch.Tensor],
                                   Optional[torch.Tensor]]:
        """k_scale and v_scale as [L, (num_pages+1)*page_size, kvh] views
        of their storage ((None, None) for an unquantized pool)."""
        if not self.quantized:
            return None, None
        L, n, ps, kvh = self.k_scale.shape
        return (self.k_scale.view(L, n * ps, kvh),
                self.v_scale.view(L, n * ps, kvh))

    def page(self, page: int) -> tuple:
        """One page's payload, views of the pool: (k, v) [L, page_size,
        kvh, d], plus (k_scale, v_scale) [L, page_size, kvh] when
        quantized."""
        out = (self.k[:, page], self.v[:, page])
        if self.quantized:
            out += (self.k_scale[:, page], self.v_scale[:, page])
        return out


class PageAllocator:
    """Host-side free-list allocator with refcounts over a fixed page set.

    Page ids 0..num_pages-1 are allocatable. A freshly alloc'd page has
    refcount 1 (the caller's); incref/decref add and drop owners, and a
    page returns to the free list exactly when its count hits zero. All
    methods run on the engine's thread."""

    def __init__(self, num_pages: int):
        if num_pages < 1:
            raise ValueError(f"num_pages must be >= 1, got {num_pages}")
        self.num_pages = num_pages
        # pop() hands out ascending ids: deterministic tests.
        self._free = list(range(num_pages - 1, -1, -1))
        self._ref = np.zeros(num_pages, np.int64)

    @property
    def free_count(self) -> int:
        return len(self._free)

    @property
    def used_count(self) -> int:
        return self.num_pages - len(self._free)

    def refcount(self, page: int) -> int:
        return int(self._ref[page])

    def alloc(self, n: int) -> Optional[List[int]]:
        """n fresh pages (refcount 1 each), or None: all-or-nothing, so a
        half-admitted request can never hold pages it cannot use."""
        if n > len(self._free):
            return None
        pages = [self._free.pop() for _ in range(n)]
        for p in pages:
            self._ref[p] = 1
        return pages

    def incref(self, pages) -> None:
        for p in pages:
            if self._ref[p] <= 0:
                raise RuntimeError(f"incref of free page {p}")
            self._ref[p] += 1

    def decref(self, pages) -> List[int]:
        """Drop one reference per page; returns the pages actually freed
        (count hit zero)."""
        freed = []
        for p in pages:
            p = int(p)
            if self._ref[p] <= 0:
                raise RuntimeError(f"decref of free page {p}")
            self._ref[p] -= 1
            if self._ref[p] == 0:
                self._free.append(p)
                freed.append(p)
        return freed


# ---------------------------------------------------------------------------
# Host swap tier
# ---------------------------------------------------------------------------

class HostPagePool:
    """Host-RAM staging tier under the device page pool.

    When the radix tree must evict a device page, the page's K/V copies into
    one of these buffers instead of dropping: the node survives as
    host-resident, and a later admission that matches it copies the page
    back instead of recomputing the prefix. The buffers are CPU tensors of
    the device pool's dtype (int8 plus f32 scales with ``quantize_kv``),
    allocated once (pinned when the engine runs on CUDA, so copies in both
    directions are DMA transfers), so a round trip is bit-identical and
    steady swap traffic allocates nothing. Used on the engine's thread
    only."""

    def __init__(self, cfg: ModelConfig, host_pages: int, page_size: int,
                 pin_memory: bool = False, quantize_kv: bool = False,
                 kv_heads: Optional[int] = None):
        """``kv_heads``: the kv heads a page holds (default all of them; a
        serving rank holds its own, engine.local_kv_heads)."""
        if host_pages < 1:
            raise ValueError(
                f"kv_host_pages must be >= 1 to enable the host tier, "
                f"got {host_pages}")
        self.num_pages = int(host_pages)
        self.page_size = int(page_size)
        shape = (self.num_pages, cfg.num_layers, self.page_size,
                 cfg.num_kv_heads if kv_heads is None else kv_heads,
                 cfg.head_dim)
        self.quantized = bool(quantize_kv)
        dtype = torch.int8 if self.quantized else cfg.activation_dtype
        self.k = torch.zeros(shape, dtype=dtype, pin_memory=pin_memory)
        self.v = torch.zeros(shape, dtype=dtype, pin_memory=pin_memory)
        self.k_scale = self.v_scale = None
        if self.quantized:
            self.k_scale = torch.zeros(shape[:-1], dtype=torch.float32,
                                       pin_memory=pin_memory)
            self.v_scale = torch.zeros(shape[:-1], dtype=torch.float32,
                                       pin_memory=pin_memory)
        self.reset()

    def reset(self) -> None:
        """Every slot free again (the buffers stay): the copies belonged to
        the radix tree being discarded."""
        # pop() hands out ascending ids: deterministic tests.
        self._free = list(range(self.num_pages - 1, -1, -1))
        self._used = np.zeros(self.num_pages, bool)

    @property
    def free_count(self) -> int:
        return len(self._free)

    @property
    def used_count(self) -> int:
        return self.num_pages - len(self._free)

    @property
    def nbytes(self) -> int:
        return sum(t.numel() * t.element_size()
                   for t in (self.k, self.v, self.k_scale, self.v_scale)
                   if t is not None)

    @property
    def bytes_per_page(self) -> int:
        return self.nbytes // self.num_pages

    def alloc(self) -> Optional[int]:
        """One free host slot, or None: the caller decides whether to make
        room (RadixTree.evict_host) or degrade to dropping."""
        if not self._free:
            return None
        slot = self._free.pop()
        self._used[slot] = True
        return slot

    def free(self, slot: int) -> None:
        if not self._used[slot]:
            raise RuntimeError(f"free of unallocated host page {slot}")
        self._used[slot] = False
        self._free.append(slot)

    def store(self, slot: int, k: torch.Tensor, v: torch.Tensor,
              k_scale: Optional[torch.Tensor] = None,
              v_scale: Optional[torch.Tensor] = None,
              checked: bool = True) -> None:
        """Copy one page's K/V ([layers, page_size, kv_heads, head_dim], on
        any device; with the scales [layers, page_size, kv_heads] exactly
        when quantized) into the slot's buffers. The copy has completed
        when this returns (a device-to-host copy_ without non_blocking
        waits for it), so the device page may be freed and reused at
        once. ``checked=False`` skips the free list's check: a serving
        follower's tier, whose slots rank 0's tier allocates."""
        if checked and not self._used[slot]:
            raise RuntimeError(f"store to unallocated host page {slot}")
        if (k_scale is not None) != self.quantized:
            raise ValueError(
                "a quantized host tier stores int8 pages with their "
                "scales, an unquantized one pages without")
        self.k[slot].copy_(k)
        self.v[slot].copy_(v)
        if self.quantized:
            self.k_scale[slot].copy_(k_scale)
            self.v_scale[slot].copy_(v_scale)

    def load(self, slot: int, checked: bool = True) -> tuple:
        """The slot's page payload (views of the buffers), as the swap-in
        function takes it: (k, v), plus the scales when quantized.
        ``checked`` as in ``store``."""
        if checked and not self._used[slot]:
            raise RuntimeError(f"load of unallocated host page {slot}")
        out = (self.k[slot], self.v[slot])
        if self.quantized:
            out += (self.k_scale[slot], self.v_scale[slot])
        return out


# ---------------------------------------------------------------------------
# Radix tree over token prefixes (page granularity)
# ---------------------------------------------------------------------------

class _RadixNode:
    __slots__ = ("children", "page", "parent", "edge", "last_used",
                 "host_slot", "seq")

    def __init__(self, parent=None, edge=None, page: int = -1,
                 seq: int = 0):
        self.children: Dict[tuple, "_RadixNode"] = {}
        self.page = page
        self.parent = parent
        self.edge = edge
        self.last_used = 0
        # >= 0: the page's K/V live in the host tier (page is then -1). A
        # node owns exactly one residency: device page, host slot, or
        # neither (namespace stubs only).
        self.host_slot = -1
        # Creation order within the tree: the LRU tie-break (_lru_key).
        self.seq = seq


def _lru_key(n: _RadixNode) -> tuple:
    """Eviction order: least recently used first and, among nodes of one
    tick (a path matched or inserted at once), the most recently created
    first, so a descendant goes before its ancestor. The reference breaks
    such ties by ``id(node)``, a memory address, which makes its victims
    vary from run to run; this is one fixed order in its place."""
    return (n.last_used, -n.seq)


class RadixTree:
    """Trie over token-id sequences at page granularity.

    Each edge is a tuple of exactly ``page_size`` token ids; the child node
    owns the physical page holding that span's K/V. The tree holds one
    allocator reference per adopted page (a page shared by the tree and
    two slots has refcount 3); ``evict`` drops LRU candidates whose pages
    nobody but the tree references. Only complete pages are inserted: a
    prefix ending mid-page shares its full pages and recomputes the tail.
    """

    def __init__(self, page_size: int, allocator: PageAllocator):
        self.page_size = page_size
        self.allocator = allocator
        self._made = 0            # nodes created (their seq)
        self.root = self._node()
        self.nodes = 0            # device pages currently owned by the tree
        self.pages_evicted = 0    # cumulative device evictions
        self._clock = 0           # logical LRU clock (match/insert ticks)
        # The host swap tier, wired by the paged engine when kv_host_pages
        # > 0. None: eviction drops pages.
        self.host: Optional[HostPagePool] = None
        self.swap_out = None  # engine callback: page -> Optional[host slot]
        self.host_nodes = 0          # nodes resident only in the host tier
        self.pages_swapped_out = 0   # cumulative device -> host demotions
        self.pages_swap_dropped = 0  # evictions that found no host room
        self.host_pages_evicted = 0  # host-tier LRU drops (evict_host)

    def _tick(self) -> int:
        self._clock += 1
        return self._clock

    def _node(self, parent=None, edge=None, page: int = -1) -> _RadixNode:
        self._made += 1
        return _RadixNode(parent=parent, edge=edge, page=page,
                          seq=self._made)

    def _root_for(self, ns, create: bool = False):
        """Per-namespace subtree root. Namespaces isolate LoRA adapters:
        the same tokens give different K/V under different adapters. The
        namespace edge is an ("__adapter__", name) tuple; token edges are
        all-int tuples, so they cannot collide. Stub nodes own no page and
        are never eviction candidates."""
        if ns is None:
            return self.root
        key = ("__adapter__", ns)
        node = self.root.children.get(key)
        if node is None and create:
            node = self._node(parent=self.root, edge=key, page=-1)
            self.root.children[key] = node
        return node

    def match_nodes(self, tokens, ns=None) -> List["_RadixNode"]:
        """Nodes of the longest full-page prefix of ``tokens`` present in
        EITHER tier (device page >= 0 or host slot >= 0) within namespace
        ``ns``. Refreshes LRU recency along the matched path. Takes no
        references: PagedKVManager.admit pins and promotes."""
        ps = self.page_size
        node = self._root_for(ns)
        if node is None:
            return []
        out: List[_RadixNode] = []
        now = self._tick()
        for i in range(len(tokens) // ps):
            child = node.children.get(tuple(tokens[i * ps:(i + 1) * ps]))
            if child is None:
                break
            child.last_used = now
            out.append(child)
            node = child
        return out

    def match(self, tokens, ns=None) -> List[int]:
        """Per-node page ids of the longest matched prefix (host-resident
        nodes report -1)."""
        return [n.page for n in self.match_nodes(tokens, ns=ns)]

    def insert(self, tokens, pages, ns=None) -> int:
        """Adopt ``pages[i]`` as the shared page of the i-th full page of
        ``tokens`` wherever the tree has no node yet (the tree increfs
        it; an existing node keeps its page and the caller's duplicate
        stays private). A host-resident node takes the caller's device
        page instead and frees its host copy (same tokens, same bytes).
        Returns the number of pages adopted."""
        ps = self.page_size
        node = self._root_for(ns, create=True)
        adopted = 0
        now = self._tick()
        for i in range(min(len(tokens) // ps, len(pages))):
            edge = tuple(int(t) for t in tokens[i * ps:(i + 1) * ps])
            child = node.children.get(edge)
            if child is None:
                child = self._node(parent=node, edge=edge,
                                   page=int(pages[i]))
                node.children[edge] = child
                self.allocator.incref([child.page])
                self.nodes += 1
                adopted += 1
            elif child.page < 0 and child.host_slot >= 0:
                child.page = int(pages[i])
                self.allocator.incref([child.page])
                if self.host is not None:
                    self.host.free(child.host_slot)
                child.host_slot = -1
                self.host_nodes -= 1
                self.nodes += 1
                adopted += 1
            child.last_used = now
            node = child
        return adopted

    def _resident_flags(self):
        """(order, hbm_desc): every node parent-before-child, and per node
        whether any STRICT descendant holds a device page (such a node
        cannot leave the tree without orphaning those references)."""
        order: List[_RadixNode] = []
        stack = [self.root]
        while stack:
            n = stack.pop()
            order.append(n)
            stack.extend(n.children.values())
        hbm_desc: Dict[int, bool] = {}
        for n in reversed(order):   # children before parents
            hbm_desc[id(n)] = any(c.page >= 0 or hbm_desc[id(c)]
                                  for c in n.children.values())
        return order, hbm_desc

    def _has_hbm_descendant(self, node: _RadixNode) -> bool:
        stack = list(node.children.values())
        while stack:
            c = stack.pop()
            if c.page >= 0:
                return True
            stack.extend(c.children.values())
        return False

    def _drop_subtree(self, v: _RadixNode) -> int:
        """Unlink ``v`` and its subtree, dropping the tree's ownership of
        every page in it: device pages decref (a slot still sharing one
        keeps it alive), host slots free. Returns host slots freed."""
        del v.parent.children[v.edge]
        host_freed = 0
        stack = [v]
        while stack:
            n = stack.pop()
            stack.extend(n.children.values())
            n.children = {}
            if n.page >= 0:
                self.allocator.decref([n.page])
                self.nodes -= 1
                n.page = -1
            if n.host_slot >= 0:
                self.host.free(n.host_slot)
                n.host_slot = -1
                self.host_nodes -= 1
                host_freed += 1
        return host_freed

    def evict(self, want: int) -> int:
        """Free up to ``want`` device pages from LRU candidates: nodes whose
        page only the tree references (refcount 1) and with no
        device-resident strict descendant. With a host tier a victim's
        page copies to host through the engine's swap_out callback and the
        node survives as host-resident; without one, or when the copy
        fails or the host tier stays full, the node and its host-only
        subtree drop. A freed victim can expose its parent as the next
        candidate, which joins the same heap. Returns device pages freed."""
        order, hbm_desc = self._resident_flags()
        heap = [(*_lru_key(n), n) for n in order
                if n.page >= 0 and not hbm_desc[id(n)]
                and self.allocator.refcount(n.page) == 1]
        heapq.heapify(heap)
        freed = 0
        while heap and freed < want:
            v = heapq.heappop(heap)[-1]
            page = v.page
            slot = None
            if self.host is not None and self.swap_out is not None:
                slot = self.swap_out(page)
            if slot is not None:
                self.allocator.decref([page])
                self.nodes -= 1
                v.page = -1
                v.host_slot = int(slot)
                self.host_nodes += 1
                self.pages_swapped_out += 1
            else:
                if self.host is not None:
                    self.pages_swap_dropped += 1
                self._drop_subtree(v)
            freed += 1
            p = v.parent
            # Refcounts cannot move during eviction (one thread), so a
            # pinned parent is skipped for good. Namespace stubs (page <
            # 0) never enter the heap.
            if (p is not self.root and p.page >= 0
                    and self.allocator.refcount(p.page) == 1
                    and not self._has_hbm_descendant(p)):
                heapq.heappush(heap, (*_lru_key(p), p))
        self.pages_evicted += freed
        return freed

    def evict_host(self, want: int) -> int:
        """Make room in the HOST tier: drop up to ``want`` host slots from
        LRU host-resident nodes with no device-resident descendant (their
        subtrees are host-only, so dropping leaks nothing). Returns host
        slots freed."""
        if self.host is None or want < 1:
            return 0
        order, hbm_desc = self._resident_flags()
        heap = [(*_lru_key(n), n) for n in order
                if n.host_slot >= 0 and not hbm_desc[id(n)]]
        heapq.heapify(heap)
        freed = 0
        while heap and freed < want:
            v = heapq.heappop(heap)[-1]
            if v.host_slot < 0:
                continue   # freed by an earlier victim's subtree drop
            freed += self._drop_subtree(v)
        self.host_pages_evicted += freed
        return freed


# ---------------------------------------------------------------------------
# Bucketing helpers
# ---------------------------------------------------------------------------

def prefix_page_buckets(max_pages_per_slot: int) -> List[int]:
    """The prefix-page-count buckets: powers of two up to (and always
    including) max_pages_per_slot."""
    out, b = [], 1
    while b < max_pages_per_slot:
        out.append(b)
        b *= 2
    out.append(max_pages_per_slot)
    return out


def page_bucket(n_pages: int, max_pages_per_slot: int) -> int:
    """Smallest prefix-page bucket covering n_pages (0 stays 0)."""
    if n_pages <= 0:
        return 0
    for b in prefix_page_buckets(max_pages_per_slot):
        if n_pages <= b:
            return b
    return max_pages_per_slot


def view_page_buckets_for(max_seq_len: int, page_size: int) -> List[int]:
    """Decode view buckets in PAGES: the dense engine's token views rounded
    up to whole pages."""
    return sorted({-(-v // page_size)
                   for v in view_buckets_for(max_seq_len)})


def paged_prefill_shapes(prefill_buckets: List[int],
                         max_pages_per_slot: int, page_size: int,
                         max_seq_len: int) -> List[Tuple[int, int]]:
    """Every reachable (suffix bucket, prefix-page bucket) combination: one
    is reachable when the smallest shared-page count of the bucket leaves
    room in the context window for a suffix in the suffix bucket."""
    ppbs = prefix_page_buckets(max_pages_per_slot)
    shapes: List[Tuple[int, int]] = []
    for ppb in [0] + ppbs:
        if ppb == 0:
            m_min = 0
        else:
            idx = ppbs.index(ppb)
            m_min = 1 if idx == 0 else ppbs[idx - 1] + 1
        max_suffix = max_seq_len - m_min * page_size
        if max_suffix < 1:
            continue
        for i, b in enumerate(prefill_buckets):
            s_min = prefill_buckets[i - 1] + 1 if i else 1
            if s_min <= max_suffix:
                shapes.append((b, ppb))
    return shapes


# ---------------------------------------------------------------------------
# Device functions
# ---------------------------------------------------------------------------

def gather_view(pool: PagePool, page_tables: torch.Tensor,
                view_pages: int) -> KVCache:
    """Each row's first ``view_pages`` pages as a contiguous cache [L, B,
    V + 1, kvh, d], V = view_pages * page_size. Position V is the view's
    trash slot, where parked rows write: it is gathered from the trash
    page, whose content no live query attends. One index_select per
    tensor straight into the view (no second copy); an int8 pool's view
    is int8 with its scales gathered the same way."""
    L, n_pages, ps, kvh, d = pool.k.shape
    B = page_tables.shape[0]
    V = view_pages * ps
    dev = pool.k.device
    t = torch.arange(V, device=dev)
    fidx = torch.empty((B, V + 1), dtype=torch.long, device=dev)
    fidx[:, :V] = page_tables[:, t // ps].long() * ps + t % ps
    fidx[:, V] = (n_pages - 1) * ps
    out = []
    for flat in (*pool.flat(), *pool.flat_scales()):
        if flat is None:
            out.append(None)
            continue
        inner = tuple(flat.shape[2:])
        view = torch.empty((L, B, V + 1, *inner), dtype=flat.dtype,
                           device=dev)
        torch.index_select(flat, 1, fidx.view(-1),
                           out=view.view(L, B * (V + 1), *inner))
        out.append(view)
    return KVCache(k=out[0], v=out[1], k_scale=out[2], v_scale=out[3])


def write_back(pool: PagePool, view: KVCache, page_tables: torch.Tensor,
               pos: torch.Tensor, live: torch.Tensor) -> None:
    """Copy the view's K/V at ``pos`` ([B] or [B, n]) to the rows' pages in
    place; dead positions (``live`` False) go to the trash page. Many
    dead positions may name the trash page in one index_put_, and which
    write lands there does not matter: the trash page is never read as
    data."""
    ps = pool.k.shape[2]
    trash_flat = (pool.k.shape[1] - 1) * ps
    B = page_tables.shape[0]
    pos = pos.long()
    b_idx = torch.arange(B, device=pos.device)
    if pos.dim() == 2:
        b_idx = b_idx[:, None]
    page = page_tables[b_idx, (pos // ps).clamp(
        0, page_tables.shape[1] - 1)].long()
    fi = torch.where(live, page * ps + pos % ps, trash_flat)
    # K, V and, for an int8 pool, their scales.
    for flat, src in zip((*pool.flat(), *pool.flat_scales()),
                         (view.k, view.v, view.k_scale, view.v_scale)):
        if flat is not None:
            flat[:, fi] = src[:, b_idx, pos]


def make_paged_prefill_fn(cfg: ModelConfig, cache_len: int,
                          page_size: int, num_pages: int, tp=None):
    """Batched paged prefill + first-token sample, one dispatch per
    admission group. Rows prefill into fresh scratch rows (the dense
    prefill's discipline); a shared prefix is GATHERED from its pages into
    positions [0, prefix_len) of each scratch row first, and afterwards
    only the SUFFIX tokens' K/V are written to the row's private pages:
    shared pages are never written. Padding rows and pad tokens write to
    the trash page. The head runs on each row's last real position only.
    ``adapters`` (a pooled engine): (adapter pool, each row's lane).
    Returns (first tokens, pool, last-position logits [rows, vocab] f32).
    An int8 pool's prefix pages are dequantized into the scratch rows,
    which stay in the activation dtype (K1 runs as ever), and the suffix
    is quantized as it scatters. ``tp``: one tensor-parallel rank's
    program, on its kv heads."""
    trash_flat = num_pages * page_size      # token 0 of the trash page
    scratch_trash = cache_len - 1           # scratch rows' trash slot

    def paged_prefill_fn(params, pool: PagePool, tokens, positions,
                         dest_pages, last_pos, generator, temps, top_ks,
                         top_ps, prefix_pages=None, prefix_len=None,
                         gmask=None, adapters=None):
        rows = tokens.shape[0]
        dev = tokens.device
        ad = cfg.activation_dtype
        flat_k, flat_v = pool.flat()
        flat_ks, flat_vs = pool.flat_scales()
        scratch = _scratch_rows(cfg, rows, cache_len, dev, tp)
        r_idx = torch.arange(rows, device=dev)[:, None]
        if prefix_pages is not None and prefix_pages.shape[1] > 0:
            # Pages past a row's real prefix_len are trash-padded; their
            # gathered values land in the scratch trash slot, which no
            # real query attends.
            ppw = prefix_pages.shape[1] * page_size
            t = torch.arange(ppw, device=dev)
            fidx = (prefix_pages[:, t // page_size].long() * page_size
                    + t % page_size)                      # [rows, ppw]
            sp = torch.where(t[None, :] < prefix_len[:, None].long(),
                             t[None, :], scratch_trash)   # [rows, ppw]
            gk, gv = flat_k[:, fidx], flat_v[:, fidx]
            if pool.quantized:
                gk = dequantize_kv(gk, flat_ks[:, fidx], ad)
                gv = dequantize_kv(gv, flat_vs[:, fidx], ad)
            scratch.k[:, r_idx, sp] = gk
            scratch.v[:, r_idx, sp] = gv
        x, scratch = forward(cfg, params, tokens, positions=positions,
                             cache=scratch, return_activations=True,
                             adapters=adapters, tp=tp)
        # The suffix K/V to the rows' private pages, by the positions the
        # forward wrote them at; pad tokens sit at the scratch trash slot
        # and go to the trash page.
        wpos = positions.long().clamp(0, cache_len - 1)
        page = torch.gather(
            dest_pages.long(), 1,
            (wpos // page_size).clamp(0, dest_pages.shape[1] - 1))
        fi = torch.where(positions < scratch_trash,
                         page * page_size + wpos % page_size, trash_flat)
        sk, sv = scratch.k[:, r_idx, wpos], scratch.v[:, r_idx, wpos]
        if pool.quantized:
            sk, flat_ks[:, fi] = quantize_kv(sk)
            sv, flat_vs[:, fi] = quantize_kv(sv)
        flat_k[:, fi] = sk
        flat_v[:, fi] = sv
        last_logits = lm_head(cfg, params, x[r_idx[:, 0], last_pos.long()],
                              tp)
        first = sample(last_logits, generator, temps, top_ks, top_ps,
                       gmask=gmask)
        return first, pool, last_logits

    return paged_prefill_fn


def make_paged_decode_fn(cfg: ModelConfig, chunk: int, max_len: int,
                         page_size: int, view_pages: int, tp=None):
    """``chunk`` decode steps over paged KV. The slots' pages are gathered
    ONCE into a contiguous [slots, view_pages*page_size + 1] view; each
    step attends the view and writes the token it wrote there back to its
    page, so the pool is exact when the chunk returns. Liveness (EOS,
    budget, room) is tracked on the device exactly as the dense decode
    does, and dead rows park at the view's trash slot V. ``adapters`` and
    ``tp``: as the dense decode's."""
    V = view_pages * page_size

    def paged_decode_fn(params, pool: PagePool, page_tables, tokens,
                        positions, generator, temperature, top_k, top_p,
                        eos_ids, remaining, active, gmask=None,
                        adapters=None):
        view = gather_view(pool, page_tables, view_pages)
        tok, pos, alive = tokens, positions, active
        emitted = torch.zeros_like(remaining)
        toks, valid = [], []
        for _ in range(chunk):
            p = torch.where(alive, pos, V)
            logits, view = forward(cfg, params, tok[:, None],
                                   positions=p[:, None], cache=view,
                                   adapters=adapters, tp=tp)
            nxt = sample_ids(tp, logits[:, -1], generator, temperature,
                             top_k, top_p, gmask).to(tok.dtype)
            nxt = torch.where(alive, nxt, tok)
            # Live positions are >= the slot's prompt length, past every
            # shared page, so a write never lands in a shared page.
            write_back(pool, view, page_tables, p, alive)
            toks.append(nxt)
            valid.append(alive)
            emitted = emitted + alive.to(emitted.dtype)
            pos = pos + alive.to(pos.dtype)
            hit_eos = (eos_ids >= 0) & (nxt == eos_ids)
            alive = alive & ~hit_eos & (emitted < remaining) & (pos < max_len)
            tok = nxt
        return torch.stack(toks), torch.stack(valid), pool

    return paged_decode_fn


def make_paged_verify_fn(cfg: ModelConfig, draft_tokens: int,
                         page_size: int, view_pages: int, tp=None):
    """Speculative draft-verify over paged KV: one ``[B, K+1]`` forward
    (carry-in token + up to K drafts per slot) against the gathered view,
    with every live position's K/V written back to its page. The host
    rolls back rejected tokens by not advancing the slot's length; live
    positions are past every shared page, so rollback never touches one.
    The verdicts are the dense ``make_verify_fn``'s
    (ops/sampling.speculative_verify); ``adapters`` and ``tp`` as its."""
    K = draft_tokens
    V = view_pages * page_size

    def paged_verify_fn(params, pool: PagePool, page_tables, tokens,
                        positions, draft_len, generator, temperature, top_k,
                        top_p, active, gmask=None, adapters=None):
        view = gather_view(pool, page_tables, view_pages)
        offs = torch.arange(K + 1, dtype=positions.dtype,
                            device=positions.device)[None, :]
        live = active[:, None] & (offs <= draft_len[:, None])
        pos = torch.where(live, positions[:, None] + offs, V)
        logits, view = forward(cfg, params, tokens, positions=pos,
                               cache=view, adapters=adapters, tp=tp)
        write_back(pool, view, page_tables, pos, live)
        accept, resid, full = speculative_verify(
            logits, tokens[:, 1:], generator, temperature, top_k, top_p,
            gmask=gmask)
        return accept, resid, full, pool

    return paged_verify_fn


def make_kv_swap_out_fn():
    """One page, pool -> host: the page's K and V ([L, page_size, kvh, d]
    views of the pool, no copy), with its scales when the pool is int8;
    HostPagePool.store copies them out."""

    def kv_swap_out_fn(pool: PagePool, page: int):
        return pool.page(page)

    return kv_swap_out_fn


def make_kv_swap_in_fn():
    """One page, host -> pool: copy a host slot's K/V (and scales, for an
    int8 pool) into page ``page`` in place. From pinned memory the copy is
    asynchronous on the current stream; every later kernel that reads the
    page, and every later copy that writes the host slot, is queued behind
    it on that stream."""

    def kv_swap_in_fn(pool: PagePool, page: int, *payload):
        for dst, src in zip(pool.page(page), payload, strict=True):
            dst.copy_(src, non_blocking=True)
        return pool

    return kv_swap_in_fn


# ---------------------------------------------------------------------------
# Host-side paging state
# ---------------------------------------------------------------------------

class PagedKVManager:
    """Allocator + radix tree + per-slot page tables for one engine. Used
    on the engine's thread only."""

    def __init__(self, num_pages: int, page_size: int, max_slots: int,
                 max_pages_per_slot: int):
        self.num_pages = num_pages
        self.page_size = page_size
        self.max_slots = max_slots
        self.max_pages_per_slot = max_pages_per_slot
        self.allocator = PageAllocator(num_pages)
        self.radix = RadixTree(page_size, self.allocator)
        self.trash_page = num_pages
        self.page_table = np.full((max_slots, max_pages_per_slot),
                                  self.trash_page, np.int32)
        self.slot_pages: List[List[int]] = [[] for _ in range(max_slots)]
        self.slot_shared = np.zeros(max_slots, np.int32)  # leading shared
        self.pages_reused_total = 0   # radix hits, counted PER PAGE
        # Engine callback promoting host-resident matches at admission:
        # (host_slot, dest_page) -> bool. None until the host tier is wired.
        self.swap_in = None
        self.pages_swapped_in = 0     # cumulative host -> device promotions

    def plan(self, prompt_tokens, max_tokens: int,
             max_seq_len: int, ns=None) -> Tuple[List[_RadixNode], int]:
        """(shared_nodes, private_needed) for admitting this prompt. Shared
        is the tree's longest full-page match across both tiers, capped so
        at least one prompt token remains to prefill (sampling needs a
        real suffix logit). Private pages reserve the whole generation up
        front, ceil(min(prompt + max_tokens, max_seq_len) / page_size)
        minus the shared pages, so an admitted request never dies
        mid-generation for lack of pages."""
        ps = self.page_size
        n = len(prompt_tokens)
        shareable = ((n - 1) // ps) * ps
        shared = self.radix.match_nodes(prompt_tokens[:shareable], ns=ns)
        reserve = min(n + max_tokens, max_seq_len)
        total_pages = -(-reserve // ps)
        return shared, max(total_pages - len(shared), 0)

    def admit(self, slot: int, shared: List[_RadixNode],
              private_n: int) -> Optional[List[int]]:
        """Commit an admission: evict unreferenced pages if the free list
        is short, allocate the private pages, take references on the
        shared ones (swapping host-resident matches back into fresh device
        pages first), and build the slot's page table. Returns the private
        pages, or None when the pool cannot satisfy the plan (the caller
        leaves the request queued). A failed swap-in rolls the admission
        back reference for reference and drops the failed node, so the
        next plan's shorter match recomputes those tokens."""
        # Pin the device-resident matches BEFORE evicting: they may be
        # tree-only (refcount 1), legal victims of their own admission.
        hbm_pins = [nd.page for nd in shared if nd.page >= 0]
        self.allocator.incref(hbm_pins)
        n_promote = sum(1 for nd in shared if nd.page < 0)
        need = private_n + n_promote
        if need > self.allocator.free_count:
            self.radix.evict(need - self.allocator.free_count)
        fresh = self.allocator.alloc(need)
        if fresh is None or any(nd.page < 0 and nd.host_slot < 0
                                for nd in shared):
            # The pool cannot satisfy the plan, or eviction's host-tier LRU
            # pass dropped a matched host node: roll back, re-plan later.
            if fresh is not None:
                self.allocator.decref(fresh)
            self.allocator.decref(hbm_pins)
            return None
        pages: List[int] = []
        promoted: List[int] = []
        fi = 0
        failed: Optional[_RadixNode] = None
        for nd in shared:
            if nd.page >= 0:
                pages.append(nd.page)
                continue
            pg = fresh[fi]
            if self.swap_in is None or not self.swap_in(nd.host_slot, pg):
                failed = nd
                break
            # The fresh page's reference goes to the tree (which owned the
            # host copy); the slot's share reference goes on top.
            self.radix.host.free(nd.host_slot)
            nd.host_slot = -1
            nd.page = int(pg)
            self.radix.host_nodes -= 1
            self.radix.nodes += 1
            self.allocator.incref([pg])
            self.pages_swapped_in += 1
            promoted.append(pg)
            pages.append(pg)
            fi += 1
        if failed is not None:
            # Drop the failed node (device descendants only lose their tree
            # references; the pins hold them until the decref below), undo
            # the slot references taken so far (promoted nodes keep their
            # new device residency) and free the unused fresh pages.
            self.radix._drop_subtree(failed)
            self.allocator.decref(promoted)
            self.allocator.decref(fresh[fi:])
            self.allocator.decref(hbm_pins)
            return None
        priv = fresh[fi:]
        pages.extend(priv)
        self.slot_pages[slot] = pages
        self.slot_shared[slot] = len(shared)
        self.page_table[slot, :] = self.trash_page
        self.page_table[slot, :len(pages)] = pages
        self.pages_reused_total += len(shared)
        return priv

    def release(self, slot: int, written_tokens=None, ns=None) -> None:
        """Drop the slot's page references, first adopting the completed
        full pages of ``written_tokens`` (the tokens the cache actually
        holds) into the tree, so the next prompt that shares them, the
        next turn of the same chat included, reuses them."""
        pages = self.slot_pages[slot]
        if not pages:
            return
        if written_tokens is not None:
            self.radix.insert(written_tokens, pages, ns=ns)
        self.allocator.decref(pages)
        self.slot_pages[slot] = []
        self.slot_shared[slot] = 0
        self.page_table[slot, :] = self.trash_page

    def occupancy(self) -> dict:
        occ = {
            "pages_total": self.num_pages,
            "pages_free": self.allocator.free_count,
            "pages_used": self.allocator.used_count,
            "pages_shared": self.radix.nodes,
            "pages_reused_total": self.pages_reused_total,
            "pages_evicted_total": self.radix.pages_evicted,
        }
        host = self.radix.host
        if host is not None:
            occ.update({
                "host_pages_total": host.num_pages,
                "host_pages_used": host.used_count,
                "host_pages_free": host.free_count,
                "host_resident_pages": self.radix.host_nodes,
                "host_bytes": host.nbytes,
                "swap_out_pages_total": self.radix.pages_swapped_out,
                "swap_in_pages_total": self.pages_swapped_in,
                "swap_dropped_pages_total": self.radix.pages_swap_dropped,
                "host_pages_evicted_total": self.radix.host_pages_evicted,
            })
        return occ


# ---------------------------------------------------------------------------
# The paged engine
# ---------------------------------------------------------------------------

class PagedInferenceEngine(InferenceEngine):
    """InferenceEngine over a paged pool instead of dense slot rows.

    The request lifecycle, queueing, deadlines, speculation and grammar
    are the dense engine's; storage and admission change: slots hold page
    tables into a shared pool, admission gates on free pages (pages, not
    slots, are the scarce resource), and every finished request's written
    pages feed the radix tree. ``num_pages`` defaults to the dense
    engine's worst-case capacity (max_slots * max_seq_len / page_size);
    size it down to overcommit on sharing. ``kv_host_pages`` > 0 adds the
    host swap tier (pinned host buffers of that many pages);
    ``preemption="swap"`` lets a better-class queue head displace a
    worse-class slot. With an adapter pool (``adapter_pool``, as the
    dense engine's), radix matches are namespaced by adapter, so a
    tenant's pages only serve the same adapter's prompts. Runs on the
    device of ``params`` (CUDA unless the caller put them on the CPU)."""

    _supports_preemption = True

    def __init__(self, cfg: ModelConfig, params: Params, *,
                 page_size: int = 16, num_pages: Optional[int] = None,
                 kv_host_pages: int = 0, mesh=None, **kwargs):
        if mesh is not None:
            # The reference's geometry check: the pool shards its kv heads
            # over `tensor`; the page tables, the allocator and the radix
            # tree stay rank 0's host state.
            from torch.distributed.device_mesh import DeviceMesh

            if not isinstance(mesh, DeviceMesh):
                raise ValueError(
                    f"mesh must be a torch.distributed.device_mesh."
                    f"DeviceMesh, got {type(mesh).__name__}")
            tensor = mesh_config_of(mesh).tensor
            if tensor > 1 and cfg.num_kv_heads % tensor:
                raise ValueError(
                    f"kv-heads not divisible by mesh_tensor: the paged "
                    f"pool shards num_kv_heads={cfg.num_kv_heads} over "
                    f"tensor={tensor}; pick mesh_tensor dividing the "
                    f"kv-head count")
        self.page_size = int(page_size)
        self._num_pages_arg = num_pages
        if int(kv_host_pages) < 0:
            raise ValueError(
                f"kv_host_pages must be >= 0, got {kv_host_pages}")
        self._kv_host_pages_arg = int(kv_host_pages)
        self.host_pool: Optional[HostPagePool] = None
        self.pager: Optional[PagedKVManager] = None
        # Host seconds of each swap copy by direction (a swap-out ends in
        # its copy's completion; a swap-in in its enqueue).
        self.swap_seconds = {d: collections.deque(maxlen=4096)
                             for d in ("out", "in")}
        super().__init__(cfg, params, mesh=mesh, **kwargs)
        cache_len = self.max_seq_len + 1
        self._paged_prefill = make_paged_prefill_fn(
            cfg, cache_len, self.page_size, self.num_pages, self.tp)
        self.view_page_buckets = view_page_buckets_for(self.max_seq_len,
                                                       self.page_size)
        self._swap_out_fn = make_kv_swap_out_fn()
        self._swap_in_fn = make_kv_swap_in_fn()
        obs_device.PROGRAMS.register("serve", "paged_prefill",
                                     self._paged_prefill)
        if self._kv_host_pages_arg > 0:
            obs_device.PROGRAMS.register("serve", "kv_swap_out",
                                         self._swap_out_fn)
            obs_device.PROGRAMS.register("serve", "kv_swap_in",
                                         self._swap_in_fn)

    def _register_programs(self) -> None:
        """The paged entry points register in __init__, once they exist;
        decode and verify per view-page bucket as they are made."""

    # -- storage -------------------------------------------------------

    def _new_cache(self) -> PagePool:
        """The pool and every piece of paging state that lives with it (a
        fresh pager; the host tier emptied and wired to it), so reset()
        discards the radix tree with the pool its pages lived in."""
        ps = self.page_size
        if ps < 1:
            raise ValueError(f"page_size must be >= 1, got {ps}")
        if self.max_seq_len % ps:
            raise ValueError(
                f"page_size {ps} must divide max_seq_len "
                f"{self.max_seq_len} (static page tables assume whole "
                "pages per slot)")
        self.pages_per_slot = self.max_seq_len // ps
        self.num_pages = (int(self._num_pages_arg)
                          if self._num_pages_arg is not None
                          else self.max_slots * self.pages_per_slot)
        if self.num_pages < self.pages_per_slot:
            raise ValueError(
                f"num_pages {self.num_pages} cannot hold even one "
                f"max-length sequence ({self.pages_per_slot} pages)")
        self.pager = PagedKVManager(self.num_pages, ps, self.max_slots,
                                    self.pages_per_slot)
        if self._kv_host_pages_arg > 0:
            if self.host_pool is None:
                self.host_pool = HostPagePool(
                    self.cfg, self._kv_host_pages_arg, ps,
                    pin_memory=self.device.type == "cuda",
                    quantize_kv=self.quantize_kv,
                    kv_heads=local_kv_heads(self.cfg, self.tp))
            else:
                self.host_pool.reset()
            self.pager.radix.host = self.host_pool
            self.pager.radix.swap_out = self._kv_swap_out
            self.pager.swap_in = self._kv_swap_in
        return PagePool.create(self.cfg, self.num_pages, ps, self.device,
                               quantize_kv=self.quantize_kv,
                               kv_heads=local_kv_heads(self.cfg, self.tp))

    # -- host swap tier ------------------------------------------------

    def _kv_swap_out(self, page: int) -> Optional[int]:
        """RadixTree eviction callback: copy one device page into a host
        slot. Returns the slot, or None to degrade to dropping (host tier
        still full after its own LRU pass, or the injected swapfail)."""
        if self._swap_fault_hit():
            return None
        h = self.host_pool.alloc()
        if h is None:
            self.pager.radix.evict_host(1)
            h = self.host_pool.alloc()
            if h is None:
                return None
        t0 = time.perf_counter()
        self._program("kv_swap_out", page, h)
        self._observe_swap("out", time.perf_counter() - t0)
        return h

    def _p_kv_swap_out(self, page: int, h: int) -> None:
        """Copy device page ``page`` (this rank's kv heads) into host slot
        ``h``: rank 0's allocated slot, a follower's the same index. The
        copy has completed when this returns: only then may the caller
        free the device page for reuse."""
        self.host_pool.store(h, *self._swap_out_fn(self.cache, page),
                             checked=not self._follower)

    def _observe_swap(self, direction: str, seconds: float) -> None:
        self.swap_seconds[direction].append(seconds)
        obs_metrics.REGISTRY.observe(
            "serve_kv_swap_seconds", seconds, direction=direction,
            help_text="Host-tier page copy wall time (dispatch + host "
                      "sync), labeled by direction.")

    def _kv_swap_in(self, host_slot: int, page: int) -> bool:
        """PagedKVManager promotion callback: copy one host-resident page
        back into device page ``page``. False degrades to recompute (the
        injected swapfail): the manager rolls the admission back."""
        if self._swap_fault_hit():
            return False
        t0 = time.perf_counter()
        self._program("kv_swap_in", host_slot, page)
        self._observe_swap("in", time.perf_counter() - t0)
        return True

    def _p_kv_swap_in(self, host_slot: int, page: int) -> None:
        self.cache = self._swap_in_fn(
            self.cache, page,
            *self.host_pool.load(host_slot, checked=not self._follower))

    # -- programs ------------------------------------------------------

    def _decode_for(self, view_pages: int):
        if view_pages not in self._decode_fns:
            self._decode_fns[view_pages] = make_paged_decode_fn(
                self.cfg, self.decode_chunk, self.max_seq_len,
                self.page_size, view_pages, self.tp)
            obs_device.PROGRAMS.register("serve", f"decode_p{view_pages}",
                                         self._decode_fns[view_pages])
        return self._decode_fns[view_pages]

    def _verify_for(self, view_pages: int):
        if view_pages not in self._verify_fns:
            self._verify_fns[view_pages] = make_paged_verify_fn(
                self.cfg, self.draft_tokens, self.page_size, view_pages,
                self.tp)
            obs_device.PROGRAMS.register("serve", f"verify_p{view_pages}",
                                         self._verify_fns[view_pages])
        return self._verify_fns[view_pages]

    def _view_pages_for(self, max_pos: int) -> int:
        """Smallest view-page bucket whose token extent covers every
        position this dispatch can write."""
        for vp in self.view_page_buckets:
            if max_pos <= vp * self.page_size:
                return vp
        return self.view_page_buckets[-1]

    def _p_warmup(self) -> None:
        """Build the kernels, then run one prefill per bucket at both row
        counts (1 and max_slots), one decode chunk (and, with speculation
        on, one verify forward) per view-page bucket, and, with the host
        tier on, one swap each way (against the trash page) before
        traffic; the engine is reset afterwards.

        The reference compiles a program per (suffix bucket, prefix-page
        bucket, rows) shape and so walks that whole census. Eager PyTorch
        compiles nothing per shape: a prefix gather is an elementwise
        kernel at any width, and the prefill's matmuls and K1 launches
        have the shapes of the suffix bucket, which this covers."""
        t_warm, before = self._warmup_begin()
        cost = obs_device.program_cost
        trash = self.pager.trash_page
        with torch.no_grad(), obs_device.SENTINEL.expected():
            if self.device.type == "cuda":
                cuda_build.build(["flash_fwd"])
            if self.adapters is not None:
                self.adapters.warm()
            gen = torch.Generator(device=self.device)
            gen.manual_seed(0)
            t = self._tensor
            vocab = self.cfg.vocab_size
            rows_set = sorted({1, self.max_slots})
            for bucket in self.prefill_buckets:
                for rows in rows_set:
                    positions = np.full((rows, bucket), self._pad_slot,
                                        np.int32)
                    positions[:, :2] = [0, 1]
                    first, self.cache, _ = cost(
                        "serve", "paged_prefill", f"b{bucket}r{rows}",
                        self._paged_prefill, self.params, self.cache,
                        t(np.zeros((rows, bucket), np.int32)), t(positions),
                        t(np.full((rows, self.pages_per_slot), trash,
                                  np.int32)),
                        t(np.ones(rows, np.int64)), gen,
                        t(np.zeros(rows, np.float32)),
                        t(np.zeros(rows, np.int32)),
                        t(np.ones(rows, np.float32)),
                        **self._grammar_warm_kwargs((rows, vocab)),
                        **self._adapter_kwargs(np.full(rows, -1, np.int32)))
            n = self.max_slots
            idle = np.zeros(n, np.int32)
            tables = t(np.full((n, self.pages_per_slot), trash, np.int32))
            akw = self._adapter_kwargs(np.full(n, -1, np.int32))
            for vp in self.view_page_buckets:
                first, _, self.cache = cost(
                    "serve", f"decode_p{vp}", f"p{vp}", self._decode_for(vp),
                    self.params, self.cache, tables, t(idle), t(idle), gen,
                    t(np.zeros(n, np.float32)), t(idle),
                    t(np.ones(n, np.float32)), t(np.full(n, -1, np.int32)),
                    t(idle), t(np.zeros(n, bool)),
                    **self._grammar_warm_kwargs((n, vocab)), **akw)
                if self._spec_index is not None:
                    first, _, _, self.cache = cost(
                        "serve", f"verify_p{vp}", f"p{vp}",
                        self._verify_for(vp), self.params, self.cache,
                        tables,
                        t(np.zeros((n, self.draft_tokens + 1), np.int32)),
                        t(idle), t(idle), gen, t(np.zeros(n, np.float32)),
                        t(idle), t(np.ones(n, np.float32)),
                        t(np.zeros(n, bool)),
                        **self._grammar_warm_kwargs(
                            (n, self.draft_tokens + 1, vocab)), **akw)
            if self.host_pool is not None:
                h = self.host_pool.alloc()
                self.host_pool.store(h, *cost(
                    "serve", "kv_swap_out", "page", self._swap_out_fn,
                    self.cache, trash))
                self.cache = cost("serve", "kv_swap_in", "page",
                                  self._swap_in_fn, self.cache, trash,
                                  *self.host_pool.load(h))
                self.host_pool.free(h)
            first.cpu()
        self._warmup_end(t_warm, before, rows_set,
                         list(self.view_page_buckets),
                         page_size=self.page_size, num_pages=self.num_pages,
                         kv_host_pages=self._kv_host_pages_arg)
        self.reset()

    # -- prefix surface (radix-backed) ---------------------------------

    def _usable_prefix_len(self, tokens) -> int:
        """Full-page token count a registration or lookup can share,
        leaving at least one token inside the context window to prefill."""
        n = min(len(tokens), self.max_seq_len - 1)
        return (n // self.page_size) * self.page_size

    def register_prefix(self, tokens: List[int]) -> int:
        """Seed the radix tree with a prompt prefix (a deployment's system
        prompt) through the NORMAL admission path: a one-token greedy
        generation prefills the tokens into pages, and the finish hook
        adopts the full pages. Runs on the engine's thread and steps the
        engine (queued traffic is served meanwhile). Returns the shareable
        (full-page) length, 0 if too short or not admitted in time."""
        plen = self._usable_prefix_len(tokens)
        if plen < self.page_size:
            return 0
        toks = [int(t) for t in tokens[:self.max_seq_len - 1]]
        if len(self.pager.radix.match(toks[:plen])) * self.page_size \
                >= plen:
            return plen  # already resident
        req = Request(prompt_tokens=toks, max_tokens=1, temperature=0.0)
        self.validate(req)
        req._submitted = time.monotonic()
        # Engine-internal work: bypass submit()'s queue bounds, so a full
        # queue does not turn a registration into a 429.
        self.queue.append(req)
        try:
            for _ in range(self.max_seq_len * 4):
                if req.finished:
                    break
                self.step()
        except Exception as exc:  # noqa: BLE001 - re-raised typed
            # The pool may be half-written and page references
            # half-applied: the caller must reset the engine.
            raise EngineStepFailed(
                "engine step failed during paged prefix registration") \
                from exc
        if req.finished:
            return plen
        # Not served in time behind sustained traffic: withdraw it, so a
        # late completion cannot adopt pages after a reported failure.
        if req in self.queue:
            self.queue.remove(req)
        return 0

    def register_prefix_from_slot(self, slot: int,
                                  tokens: List[int]) -> int:
        """No-op: the finish hook already adopted the slot's written pages
        into the radix tree."""
        return 0

    def has_prefix(self, tokens: List[int]) -> bool:
        plen = self._usable_prefix_len(tokens)
        return (plen >= self.page_size
                and len(self.pager.radix.match(tokens[:plen]))
                * self.page_size >= plen)

    # -- admission -----------------------------------------------------

    def _admit(self, exclude_slots=()) -> None:
        blocked = self._admit_pass(exclude_slots)
        if (self.preemption == "swap" and blocked
                and self._maybe_preempt(exclude_slots)):
            # The victim's slot and pages freed at this step boundary: a
            # second pass admits the better-class head now.
            self._admit_pass(exclude_slots)

    def _admit_pass(self, exclude_slots=()) -> bool:
        """One admission sweep over the free slots. Returns True when the
        queue head is left blocked on CAPACITY (no free slot, or page
        exhaustion) rather than on this tick's prefill budget: the signal
        preemption keys on (a budget-blocked head admits next step)."""
        budget = self.prefill_budget
        admitted: List[tuple] = []
        budget_blocked = False
        for slot in self._free_slots(exclude_slots):
            if not self.queue:
                break
            head = self.queue[0]
            # Radix matches are namespaced by adapter: the same tokens
            # have other K/V under another adapter. A preempted head plans
            # against prompt + written outputs, so its own adopted pages
            # match and it resumes on the shared-prefix path.
            eff = self._admit_tokens(head)
            shared, private_n = self.pager.plan(
                eff, self._admit_budget(head), self.max_seq_len,
                ns=head.adapter)
            need = self._bucket_for(len(eff) - len(shared) * self.page_size)
            if admitted and need > budget:
                budget_blocked = True
                break
            if not self._acquire_adapter(head):
                # Every adapter lane is pinned: the same backpressure as
                # page exhaustion below.
                break
            if head.finished:       # its adapter failed to load
                self.queue.pop(0)
                continue
            if self.pager.admit(slot, shared, private_n) is None:
                # Page pressure even after eviction: the head waits (FIFO)
                # and the queue backs up until submit() sheds. Its adapter
                # lane stays pinned on the request for the next try.
                break
            req = self.queue.pop(0)
            self._observe_admission(req, slot)
            budget -= need
            admitted.append((slot, req, len(shared)))
        by_group: dict = {}
        for slot, req, nshared in admitted:
            b = self._bucket_for(len(self._admit_tokens(req))
                                 - nshared * self.page_size)
            ppb = page_bucket(nshared, self.pages_per_slot)
            by_group.setdefault((b, ppb), []).append((slot, req))
        for (bucket, ppb), group in by_group.items():
            with self._dispatch("prefill"):
                self._prefill_group_paged(bucket, ppb, group)
        return bool(self.queue) and not budget_blocked

    def _maybe_preempt(self, exclude_slots=()) -> bool:
        """Preempt ONE active slot whose class is strictly worse than the
        queue head's: worst class first, the most recently admitted within
        a class (the least work lost). One victim per step bounds churn.
        Returns True when a slot was preempted."""
        head_rank = PRIORITY_RANK[self.queue[0].priority]
        cands = [
            (PRIORITY_RANK[self.slot_req[s].priority],
             self.slot_req[s]._admitted, s)
            for s in range(self.max_slots)
            if self.active[s] and self.slot_req[s] is not None
            and s not in exclude_slots
            and PRIORITY_RANK[self.slot_req[s].priority] > head_rank]
        if not cands:
            return False
        _, _, victim = max(cands)
        self._preempt_slot(victim)
        return True

    def _preempt_slot(self, slot: int) -> None:
        """Displace one active slot at a step boundary. Its written extent
        (prompt + outputs[:-1]: the last sampled token is never written)
        goes into the radix tree as a finished request's would, and the
        request re-queues with its generated tokens, to resume later from
        a radix match on its own history with finish_reason unchanged. Its
        adapter lane stays pinned: releasing it could park the resume
        behind the very traffic that preempted it."""
        req = self.slot_req[slot]
        m = len(req.output_tokens)
        written = len(req.prompt_tokens) + max(0, m - 1)
        toks = (req.prompt_tokens + req.output_tokens)[:written]
        self.pager.release(slot, written_tokens=toks, ns=req.adapter)
        self.active[slot] = False
        self.slot_req[slot] = None
        self.adapter_slots[slot] = -1
        if self._spec_index is not None:
            self._spec_index.clear(slot)
        req._slot = -1
        req._preempted = True
        self.preemptions += 1
        # At the tail of its own class, past submit()'s bounds: shedding
        # a preempted request would lose its generated tokens.
        self._queue_insert(req)

    def _prefill_group_paged(self, bucket: int, ppb: int,
                             group: List[tuple]) -> None:
        """One batched paged prefill of same-(suffix bucket, prefix-page
        bucket) admissions. Rows may share different prefixes: each row's
        prefix pages and length ride its own operand row."""
        n = len(group)
        ps = self.page_size
        self.prefix_lookups += n
        rows = 1 if n == 1 else self.max_slots
        tokens = np.zeros((rows, bucket), np.int32)
        positions = np.full((rows, bucket), self._pad_slot, np.int32)
        trash = self.pager.trash_page
        dest_pages = np.full((rows, self.pages_per_slot), trash, np.int32)
        prefix_pages = (np.full((rows, ppb), trash, np.int32)
                        if ppb else None)
        prefix_len = np.zeros(rows, np.int32) if ppb else None
        last_pos = np.zeros(rows, np.int64)
        temps = np.zeros(rows, np.float32)
        top_ks = np.zeros(rows, np.int32)
        top_ps = np.ones(rows, np.float32)
        aslots = np.full(rows, -1, np.int32)     # padding: the trash lane
        for i, (slot, req) in enumerate(group):
            aslots[i] = req._adapter_lane
            nshared = int(self.pager.slot_shared[slot])
            plen = nshared * ps
            # A resumed row prefills its own written history past its
            # adopted pages (_admit_tokens); a fresh row its prompt.
            eff = self._admit_tokens(req)
            m = len(eff) - plen
            tokens[i, :m] = eff[plen:]
            positions[i, :m] = np.arange(plen, plen + m)
            dest_pages[i] = self.pager.page_table[slot]
            if ppb:
                prefix_pages[i, :nshared] = \
                    self.pager.slot_pages[slot][:nshared]
                prefix_len[i] = plen
            last_pos[i] = m - 1
            temps[i] = req.temperature
            top_ks[i] = req.top_k
            top_ps[i] = req.top_p
            if nshared:
                self.prefix_hits += 1
                self.prefix_tokens_reused += plen
        with self._prefill_span(bucket, rows, ppb * ps, group):
            first = self._program(
                "paged_prefill", tokens, positions, dest_pages, last_pos,
                temps, top_ks, top_ps, prefix_pages, prefix_len,
                aslots=aslots, **self._grammar_prefill_kwargs(group, rows))
        self.prefill_dispatches += 1
        for i, (slot, req) in enumerate(group):
            self._activate_slot(slot, req, int(first[i]))

    def _p_paged_prefill(self, tokens, positions, dest_pages, last_pos,
                         temps, top_ks, top_ps, prefix_pages=None,
                         prefix_len=None, gmask=None, aslots=None):
        t = self._tensor
        prefix = ({"prefix_pages": t(prefix_pages),
                   "prefix_len": t(prefix_len)}
                  if prefix_pages is not None else {})
        first, self.cache, _ = self._paged_prefill(
            self.params, self.cache, t(tokens), t(positions), t(dest_pages),
            t(last_pos), self.generator, t(temps), t(top_ks), t(top_ps),
            **prefix, **self._operand_kwargs(gmask, aslots))
        # The first tokens must reach the host to stream: the dispatch's
        # one sync.
        return first.cpu().numpy()

    # -- lifecycle -----------------------------------------------------

    def _on_slot_finished(self, slot: int, req: Request) -> None:
        """Adopt the finished request's fully written pages into the radix
        tree, then drop the slot's references. The written extent is
        prompt + outputs - 1 (the last sampled token is never written);
        adopting past it would share a page with a garbage tail."""
        m = len(req.output_tokens)
        written = len(req.prompt_tokens) + max(0, m - 1)
        toks = (req.prompt_tokens + req.output_tokens)[:written]
        self.pager.release(slot, written_tokens=toks, ns=req.adapter)
        super()._on_slot_finished(slot, req)

    # -- decode --------------------------------------------------------

    def _verify_dispatch(self, tokens, positions, draft_len, temps,
                         top_ks, top_ps, gkw: dict):
        """The verify forward over the gathered page view, sized to cover
        every position this step can write (L + K)."""
        vp = self._view_pages_for(int(self.lengths[self.active].max())
                                  + self.draft_tokens + 1)
        with self._step_span("verify", vp * self.page_size,
                             drafted=int(draft_len.sum())):
            return self._program("paged_verify", vp, self.pager.page_table,
                                 tokens, positions, draft_len, temps,
                                 top_ks, top_ps, self.active, **gkw,
                                 **self._lane_kwargs())

    def _p_paged_verify(self, vp, page_table, tokens, positions, draft_len,
                        temps, top_ks, top_ps, active, gmask=None,
                        aslots=None):
        t = self._tensor
        accept, resid, full, self.cache = self._verify_for(vp)(
            self.params, self.cache, t(page_table), t(tokens), t(positions),
            t(draft_len), self.generator, t(temps), t(top_ks), t(top_ps),
            t(active), **self._operand_kwargs(gmask, aslots))
        # One host sync per verify step.
        return (accept.cpu().numpy(), resid.cpu().numpy(),
                full.cpu().numpy())

    def _decode_chunk_step(self) -> int:
        # Inactive rows decode at position 0 and park at the view's trash
        # slot; free slots' page-table rows all name the trash page.
        positions = np.where(self.active, self.lengths, 0).astype(np.int32)
        temps, top_ks, top_ps, eos_ids, remaining = self._sampling_operands()
        vp = self._view_pages_for(int(self.lengths[self.active].max())
                                  + self.decode_chunk)
        with self._step_span("decode", vp * self.page_size):
            toks, valid = self._program(
                "paged_decode", vp, self.pager.page_table, self.last_token,
                positions, temps, top_ks, top_ps, eos_ids, remaining,
                self.active, **self._grammar_decode_kwargs(),
                **self._lane_kwargs())
        return self._replay_chunk(toks, valid)

    def _p_paged_decode(self, vp, page_table, last_token, positions, temps,
                        top_ks, top_ps, eos_ids, remaining, active,
                        gmask=None, aslots=None):
        t = self._tensor
        toks, valid, self.cache = self._decode_for(vp)(
            self.params, self.cache, t(page_table), t(last_token),
            t(positions), self.generator, t(temps), t(top_ks), t(top_ps),
            t(eos_ids), t(remaining), t(active),
            **self._operand_kwargs(gmask, aslots))
        # One host sync per chunk.
        return toks.cpu().numpy(), valid.cpu().numpy()

    # -- observability -------------------------------------------------

    def kv_occupancy(self) -> dict:
        """Page-level pool occupancy; occupancy_ratio is pages used over
        pages total, the pressure admission gates on."""
        ps = self.page_size
        occ = self.pager.occupancy()
        tokens = int(self.lengths[self.active].sum())
        local_bytes = self.cache.nbytes
        local_bpp = local_bytes // (self.num_pages + 1)
        pool_bytes = self._logical_kv_bytes(local_bytes)
        bpp = pool_bytes // (self.num_pages + 1)
        return {"slots_total": self.max_slots,
                "slots_active": int(self.active.sum()),
                "kv_tokens": tokens,
                "kv_capacity_tokens": self.num_pages * ps,
                "occupancy_ratio": (occ["pages_used"] / self.num_pages
                                    if self.num_pages else 0.0),
                "paged": True,
                "page_size": ps,
                "bytes_per_page": bpp,
                "kv_pool_bytes": pool_bytes,
                # This device's share: its kv heads under a mesh.
                "kv_pool_bytes_per_device": local_bytes,
                "bytes_per_page_per_device": local_bpp,
                "kv_bytes_shared": occ["pages_shared"] * bpp,
                "kv_bytes_private":
                    (occ["pages_used"] - occ["pages_shared"]) * bpp,
                **occ}
