"""Device-level observability on CUDA (the port of
``runbooks_tpu.obs.device``): what happens below the dispatch boundary.

- **Build sentinel** (:data:`SENTINEL`). The reference counts XLA compiles
  from ``jax.monitoring``. Eager PyTorch compiles no program per shape;
  what a serving process must never pay after warmup is a kernel build, so
  ``utils/cuda_build.build`` reports each ``nvcc`` run and its seconds
  here. Once a component declares itself *steady* (the serve engine after
  warmup, the trainer after its first step), a build outside an
  :meth:`CompileSentinel.expected` block is a stall: it counts into
  ``xla_unexpected_compiles_total``, prints a loud line and emits a trace
  instant. The metric families keep the reference's names (the fleet
  scraper and history read these prefixes); their help texts say what
  they count here.

- **Program census and roofline costs** (:data:`PROGRAMS`,
  :func:`program_cost`). The reference takes FLOPs and HBM bytes from the
  ``cost_analysis()`` of a lowering; eager PyTorch has none. The port
  measures the first dispatch of each (component, name, shape signature)
  under a ``TorchDispatchMode`` that counts FLOPs by
  ``torch.utils.flop_counter``'s formulas (the flash kernels' custom ops
  register theirs in ops/flash_attention.py) and bytes as the sum of each
  op's input and output tensor bytes, which is what an eager op reads from
  and writes to device memory (views move nothing and count nothing). The
  engine's warmup and the trainer's first step make these dispatches;
  steady-state serving and training run with no dispatch mode.
  ``classify_roofline`` puts each program left or right of the H100's
  ridge (utils/hw.device_peaks).

- **Memory**: ``device_memory_*`` gauges from ``torch.cuda.memory_stats``
  and ``torch.cuda.mem_get_info`` (absent on the CPU, as in the
  reference), and ``memory_snapshot(groups)``, which charges each storage
  of the caller's named tensor groups (weights, KV cache, optimizer state,
  the adapter pool) once; on CUDA, "other" is the allocator's bytes in use
  less the groups. Nothing here walks ``gc``.
"""

from __future__ import annotations

import contextlib
import dataclasses
import os
import threading
import time
import weakref
from typing import Any, Dict, Iterator, List, Optional, Tuple

import torch

from runbooks_tpu_torch.obs import metrics as obs_metrics
from runbooks_tpu_torch.obs import trace as obs_trace

# nvcc runs take seconds to minutes (a file that includes PyTorch's
# headers); the default latency buckets top out at 30 s.
_COMPILE_BUCKETS = (0.01, 0.025, 0.05, 0.1, 0.25, 0.5, 1.0, 2.5, 5.0,
                    10.0, 30.0, 60.0, 120.0, 300.0)

_HELP_COMPILES = "Kernel builds (nvcc runs) in this process."
_HELP_UNEXPECTED = ("Kernel builds after a component marked steady: each "
                    "one stalled live work for its duration.")
_HELP_COMPILE_SECONDS = "Wall time per kernel build (one nvcc run)."


# ---------------------------------------------------------------------------
# Build sentinel
# ---------------------------------------------------------------------------

class CompileSentinel:
    """Process-wide kernel-build tracker and post-warmup build alarm.

    ``record_build`` is the feed (utils/cuda_build.build calls it once per
    nvcc run). Components call ``mark_steady(name)`` when their build phase
    is over; from then on a build outside an ``expected()`` block increments
    ``xla_unexpected_compiles_total``, prints a loud line and emits a trace
    instant. ``expected()`` is thread-local: a build runs on the thread
    that asked for it."""

    def __init__(self):
        self._lock = threading.Lock()
        self._installed = False                 # guarded-by: _lock
        # component -> number of live claimants (two engines in one
        # process both mark "serve"; the first to stop must not blind the
        # sentinel for the other).
        self._steady: Dict[str, int] = {}       # guarded-by: _lock
        self._local = threading.local()
        self.total = 0                          # guarded-by: _lock
        self.unexpected = 0                     # guarded-by: _lock
        self.compile_seconds = 0.0              # guarded-by: _lock
        self.last_unexpected: List[dict] = []   # guarded-by: _lock

    def install(self) -> bool:
        """Zero-initialize both counters once, so an alert on their rate
        sees the series before the first onset. The feed needs no hook
        (cuda_build reports to it), so this always returns True."""
        with self._lock:
            if self._installed:
                return True
            self._installed = True
        reg = obs_metrics.REGISTRY
        reg.inc("xla_compilations_total", 0.0, help_text=_HELP_COMPILES)
        reg.inc("xla_unexpected_compiles_total", 0.0,
                help_text=_HELP_UNEXPECTED)
        return True

    def mark_steady(self, component: str) -> None:
        """Declare ``component``'s build phase over (refcounted: pairs with
        one clear_steady)."""
        with self._lock:
            self._steady[component] = self._steady.get(component, 0) + 1

    def clear_steady(self, component: Optional[str] = None) -> None:
        """Withdraw one steadiness claim; None clears every component
        (tests)."""
        with self._lock:
            if component is None:
                self._steady.clear()
            elif component in self._steady:
                self._steady[component] -= 1
                if self._steady[component] <= 0:
                    del self._steady[component]

    def steady_components(self) -> List[str]:
        with self._lock:
            return sorted(self._steady)

    def recent_unexpected(self) -> List[dict]:
        with self._lock:
            return [dict(r) for r in self.last_unexpected]

    @contextlib.contextmanager
    def expected(self):
        """Mark builds on THIS thread as intentional (warmup, the
        trainer's first step, an entry point's prebuild)."""
        depth = getattr(self._local, "depth", 0)
        self._local.depth = depth + 1
        try:
            yield
        finally:
            self._local.depth = depth

    def record_build(self, seconds: float, name: str = "") -> None:
        """One kernel build (one nvcc run) of ``seconds``."""
        self.install()
        reg = obs_metrics.REGISTRY
        with self._lock:
            self.total += 1
            self.compile_seconds += float(seconds)
            steady = sorted(self._steady)
        reg.inc("xla_compilations_total", help_text=_HELP_COMPILES)
        reg.observe("xla_compile_seconds", float(seconds),
                    buckets=_COMPILE_BUCKETS,
                    help_text=_HELP_COMPILE_SECONDS)
        if not steady or getattr(self._local, "depth", 0):
            return
        with self._lock:
            self.unexpected += 1
            self.last_unexpected.append(
                {"seconds": round(float(seconds), 3), "source": name,
                 "steady": steady, "time": time.time()})
            del self.last_unexpected[:-16]
        reg.inc("xla_unexpected_compiles_total", help_text=_HELP_UNEXPECTED)
        print(f"device-obs: UNEXPECTED KERNEL BUILD {name} "
              f"({seconds:.2f}s) after steady mark ({','.join(steady)}): a "
              "build here stalls every in-flight request/step for its "
              "duration (xla_unexpected_compiles_total)", flush=True)
        obs_trace.instant("unexpected_compile",
                          seconds=round(float(seconds), 3),
                          steady=",".join(steady))


SENTINEL = CompileSentinel()


# ---------------------------------------------------------------------------
# Program census and roofline costs
# ---------------------------------------------------------------------------

class ProgramTracker:
    """Census of the entry points each component dispatches, with the
    shape signatures measured at their first dispatch and each one's
    roofline cost. The registry view is the ``xla_programs`` /
    ``xla_program_*`` gauge families; /debug/programs renders the same
    data as a table."""

    def __init__(self):
        self._lock = threading.Lock()
        # (component, name) -> {"fn_ref": weakref | None, "costs": {sig: cost}}
        self._programs: Dict[Tuple[str, str], dict] = {}  # guarded-by: _lock
        # (registry id, component) -> names last exported there, so that
        # set_gauges drops a dead program's series.
        self._exported: Dict[Tuple[int, Optional[str]], set] = {}  # guarded-by: _lock

    @staticmethod
    def _make_ref(fn: Any):
        if fn is None:
            return None
        try:
            # Weak on purpose: an entry point's closure may pin its owner
            # (an engine with its weights and KV pool).
            return weakref.ref(fn)
        except TypeError:
            return lambda: fn

    def register(self, component: str, name: str, fn: Any) -> None:
        """(Re-)register an entry point; registration resets its costs (a
        rebuilt engine may carry another model behind the same name)."""
        with self._lock:
            self._programs[(component, name)] = {
                "fn_ref": self._make_ref(fn), "costs": {}}

    def record_cost(self, component: str, name: str, shape_sig: str,
                    cost: Optional[dict]) -> None:
        if cost is None:
            return
        with self._lock:
            entry = self._programs.setdefault(
                (component, name), {"fn_ref": None, "costs": {}})
            entry["costs"][shape_sig] = dict(cost)

    def has_cost(self, component: str, name: str, shape_sig: str) -> bool:
        with self._lock:
            entry = self._programs.get((component, name))
            return bool(entry and shape_sig in entry["costs"])

    def census(self, component: Optional[str] = None) -> List[dict]:
        """One row per live entry point: ``programs`` is the number of
        shape signatures measured (the eager counterpart of the
        reference's compiled variants), ``costs`` each one's cost."""
        out, doomed = [], []
        with self._lock:
            items = sorted(self._programs.items())
        for (comp, name), entry in items:
            ref = entry["fn_ref"]
            if ref is not None and ref() is None:
                doomed.append((comp, name))   # its owner was collected
                continue
            if component is not None and comp != component:
                continue
            out.append({"component": comp, "name": name,
                        "programs": len(entry["costs"]),
                        "costs": {k: dict(v)
                                  for k, v in entry["costs"].items()}})
        if doomed:
            with self._lock:
                for key in doomed:
                    entry = self._programs.get(key)
                    if entry is not None and entry["fn_ref"] is not None \
                            and entry["fn_ref"]() is None:
                        del self._programs[key]
        return out

    def set_gauges(self, registry: Optional[obs_metrics.Registry] = None,
                   component: Optional[str] = None) -> None:
        """Mirror the census into the registry (at scrape time); series of
        programs gone from the census are dropped."""
        reg = registry if registry is not None else obs_metrics.REGISTRY
        census = self.census(component)
        live = {(e["component"], e["name"]) for e in census}
        key = (id(reg), component)
        with self._lock:
            gone = self._exported.get(key, set()) - live
            self._exported[key] = live
        for comp, name in gone:
            reg.drop_series(component=comp, program=name)
        for entry in census:
            labels = {"component": entry["component"],
                      "program": entry["name"]}
            reg.drop_series(**labels)
            reg.set_gauge("xla_programs", entry["programs"],
                          help_text="Shape signatures per entry point, each "
                                    "measured at its first dispatch.",
                          **labels)
            costs = entry["costs"]
            if not costs:
                continue
            # The largest shape bounds memory and time.
            cost = max(costs.values(), key=lambda c: c.get("flops", 0.0))
            reg.set_gauge("xla_program_flops", cost.get("flops", 0.0),
                          help_text="FLOPs per invocation (counted at the "
                                    "first dispatch by the ops' flop "
                                    "formulas).", **labels)
            reg.set_gauge("xla_program_hbm_bytes",
                          cost.get("hbm_bytes", 0.0),
                          help_text="Bytes per invocation: the sum of each "
                                    "op's input and output tensor bytes.",
                          **labels)
            if cost.get("arithmetic_intensity") is not None:
                reg.set_gauge("xla_program_arithmetic_intensity",
                              cost["arithmetic_intensity"],
                              help_text="FLOPs per byte accessed.", **labels)
            if cost.get("bound"):
                reg.set_gauge("xla_program_bandwidth_bound",
                              int(cost["bound"] == "bandwidth"),
                              help_text="1 when the program sits left of "
                                        "the roofline ridge (HBM-bound).",
                              **labels)


PROGRAMS = ProgramTracker()


def _tensor_bytes(x) -> int:
    """The bytes of the tensors in an operator's argument or result (a
    tensor, or a list or tuple of them)."""
    if isinstance(x, torch.Tensor):
        return x.numel() * x.element_size()
    if isinstance(x, (list, tuple)):
        return sum(_tensor_bytes(y) for y in x)
    return 0


class CostMode(torch.utils._python_dispatch.TorchDispatchMode):
    """Counts the FLOPs (torch.utils.flop_counter's formulas, keyed by
    operator) and the bytes (each op's input and output tensor bytes) of
    every operator dispatched while it is active. Ops that only make views
    move no data and count nothing. A custom op is one operator: the ops
    its implementation runs are not seen."""

    def __init__(self):
        super().__init__()
        from torch.utils.flop_counter import flop_registry

        self._formulas = flop_registry
        self.flops = 0
        self.hbm_bytes = 0
        self.ops = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        self.ops += 1
        formula = self._formulas.get(func._overloadpacket)
        if formula is not None:
            self.flops += int(formula(*args, **kwargs, out_val=out))
        if not func.is_view:
            self.hbm_bytes += (_tensor_bytes(args) + _tensor_bytes(out)
                               + _tensor_bytes(list(kwargs.values())))
        return out


def costs_enabled() -> bool:
    """RBT_DEVICE_OBS=0 skips the first-dispatch counting (its host cost
    lands on warmup and on the trainer's first step)."""
    return os.environ.get("RBT_DEVICE_OBS", "1") != "0"


def program_cost(component: str, name: str, shape_sig: str, fn,
                 *args, **kwargs):
    """``fn(*args, **kwargs)``, returning its result. The first call for
    (component, name, shape_sig) runs under :class:`CostMode` and records
    the program's cost with its roofline classification; later calls (or
    any call with RBT_DEVICE_OBS=0) run plain."""
    if not costs_enabled() or PROGRAMS.has_cost(component, name, shape_sig):
        return fn(*args, **kwargs)
    mode = CostMode()
    with mode:
        out = fn(*args, **kwargs)
    cost = {"flops": float(mode.flops), "hbm_bytes": float(mode.hbm_bytes),
            "ops": mode.ops}
    cost.update(classify_roofline(cost["flops"], cost["hbm_bytes"]))
    PROGRAMS.record_cost(component, name, shape_sig, cost)
    return out


def classify_roofline(flops: float, hbm_bytes: float,
                      peak_flops: Optional[float] = None,
                      hbm_bytes_per_sec: Optional[float] = None) -> dict:
    """Arithmetic intensity (FLOPs/byte) against the ridge (peak FLOP/s
    over HBM bandwidth): left of it the program is **bandwidth**-bound,
    right of it compute-bound. Peaks default to the current device's
    (nominal fallbacks keep the classification meaningful on the CPU)."""
    if peak_flops is None or hbm_bytes_per_sec is None:
        from runbooks_tpu_torch.utils.hw import device_peaks

        d_peak, d_bw = device_peaks()
        peak_flops = peak_flops if peak_flops is not None else d_peak
        hbm_bytes_per_sec = (hbm_bytes_per_sec
                             if hbm_bytes_per_sec is not None else d_bw)
    ai = flops / hbm_bytes if hbm_bytes > 0 else float("inf")
    ridge = peak_flops / hbm_bytes_per_sec if hbm_bytes_per_sec else 0.0
    t_compute = flops / peak_flops if peak_flops else 0.0
    t_memory = hbm_bytes / hbm_bytes_per_sec if hbm_bytes_per_sec else 0.0
    return {"arithmetic_intensity": round(ai, 3),
            "ridge": round(ridge, 3),
            "bound": "bandwidth" if ai < ridge else "compute",
            "min_seconds": max(t_compute, t_memory)}


# ---------------------------------------------------------------------------
# Memory accounting
# ---------------------------------------------------------------------------

def device_memory_stats() -> List[dict]:
    """One entry per CUDA device: bytes in use, peak, limit and headroom
    from the caching allocator (``memory_stats``) and the driver
    (``mem_get_info``: the card's total is the limit). Without CUDA the
    list is empty, the reference's CPU degradation."""
    out: List[dict] = []
    if not torch.cuda.is_available():
        return out
    for i in range(torch.cuda.device_count()):
        entry: dict = {"device": str(i),
                       "kind": torch.cuda.get_device_name(i),
                       "platform": "gpu"}
        if torch.cuda.is_initialized():
            stats = torch.cuda.memory_stats(i)
            in_use = int(stats.get("allocated_bytes.all.current", 0))
            _, total = torch.cuda.mem_get_info(i)
            entry.update({
                "bytes_in_use": in_use,
                "peak_bytes_in_use":
                    int(stats.get("allocated_bytes.all.peak", 0)),
                "bytes_reserved":
                    int(stats.get("reserved_bytes.all.current", 0)),
                "bytes_limit": int(total),
                "headroom_bytes": int(total) - in_use})
        out.append(entry)
    return out


def set_memory_gauges(registry: Optional[obs_metrics.Registry] = None
                      ) -> List[dict]:
    """Mirror device_memory_stats() into the ``device_memory_*`` gauges
    (one labelset per device) and return the entries; a device without
    stats sets nothing (an absent series is the CPU signal)."""
    reg = registry if registry is not None else obs_metrics.REGISTRY
    entries = device_memory_stats()
    for e in entries:
        if "bytes_in_use" not in e:
            continue
        labels = {"device": e["device"]}
        reg.set_gauge("device_memory_bytes_in_use", e["bytes_in_use"],
                      help_text="Caching allocator bytes in use "
                                "(torch.cuda.memory_stats).", **labels)
        reg.set_gauge("device_memory_peak_bytes", e["peak_bytes_in_use"],
                      help_text="Caching allocator high-water mark.",
                      **labels)
        reg.set_gauge("device_memory_bytes_limit", e["bytes_limit"],
                      help_text="Device memory capacity "
                                "(torch.cuda.mem_get_info).", **labels)
        reg.set_gauge("device_memory_headroom_bytes", e["headroom_bytes"],
                      help_text="bytes_limit - bytes_in_use.", **labels)
    return entries


def tensor_leaves(tree: Any) -> Iterator[torch.Tensor]:
    """The tensors of a nested structure: dicts, lists, tuples and
    dataclasses (KVCache, QuantizedArray) are walked; other objects are
    leaves and only tensors are kept."""
    if isinstance(tree, torch.Tensor):
        yield tree
    elif isinstance(tree, dict):
        for v in tree.values():
            yield from tensor_leaves(v)
    elif isinstance(tree, (list, tuple)):
        for v in tree:
            yield from tensor_leaves(v)
    elif dataclasses.is_dataclass(tree) and not isinstance(tree, type):
        for f in dataclasses.fields(tree):
            yield from tensor_leaves(getattr(tree, f.name))


def _storage_key(t: torch.Tensor) -> Tuple[str, int]:
    s = t.untyped_storage()
    return (str(t.device), s.data_ptr())


def tensor_census(groups: Optional[Dict[str, Any]] = None) -> dict:
    """Bytes per caller-named group: every storage under a group's tensors
    is charged once (the first group that holds it wins), at the storage's
    size, so an aliased tensor or a view counts once. On CUDA ``other`` is
    the allocator's bytes in use less the groups (activations, scratch,
    what no group names); without CUDA there is no such total and
    ``other`` is absent."""
    seen: set = set()
    by_group: Dict[str, int] = {}
    counts: Dict[str, int] = {}
    for name, tree in (groups or {}).items():
        by_group[name] = counts[name] = 0
        for t in tensor_leaves(tree):
            key = _storage_key(t)
            if key in seen:
                continue
            seen.add(key)
            by_group[name] += t.untyped_storage().nbytes()
            counts[name] += 1
    out = {"by_category": by_group, "storage_counts": counts,
           "grouped_bytes": sum(by_group.values())}
    if torch.cuda.is_available() and torch.cuda.is_initialized():
        in_use = int(torch.cuda.memory_allocated())
        by_group["other"] = in_use - out["grouped_bytes"]
        out["total_bytes"] = in_use
    return out


def memory_snapshot(groups: Optional[Dict[str, Any]] = None) -> dict:
    """The allocator's stats and the group census: what GET /debug/memory
    returns and what a profile capture and an incident bundle keep."""
    return {"devices": device_memory_stats(),
            "tensors": tensor_census(groups)}
