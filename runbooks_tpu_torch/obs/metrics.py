"""Process-wide Prometheus-format metrics registry (the port's copy of
``runbooks_tpu.obs.metrics``; its exposition is the reference's byte for
byte for the same sequence of calls).

Counters, gauges, and fixed-bucket histograms with correct text-format
exposition (``# HELP``/``# TYPE`` lines, spec label escaping,
``_bucket``/``_sum``/``_count`` series with cumulative ``le`` buckets). No
third-party deps: the exposition format is stable and small, and the
serving path must not grow a client-library import.

Conventions (the reference's exposition lint, which the port's tests
apply too):
- counters end in ``_total``; gauges and histograms do not
- histogram families expose ``<name>_bucket{le=...}``, ``<name>_sum``,
  ``<name>_count``; the ``+Inf`` bucket equals ``_count``
- every ``# TYPE`` precedes its family's samples
"""

from __future__ import annotations

import bisect
import threading
import time
from collections import defaultdict
from http.server import BaseHTTPRequestHandler, HTTPServer
from typing import Dict, List, Optional, Sequence, Tuple

# The Prometheus text exposition content type. Bare "text/plain" makes some
# scrapers fall back to heuristic parsing; version + charset is what the
# official client libraries send.
CONTENT_TYPE = "text/plain; version=0.0.4; charset=utf-8"

# Default histogram buckets: latency-shaped (seconds), spanning sub-ms
# engine dispatches to multi-second cold compiles. 14 buckets keeps each
# labelset's exposition small; per-metric overrides via observe(buckets=).
DEFAULT_BUCKETS: Tuple[float, ...] = (
    0.001, 0.0025, 0.005, 0.01, 0.025, 0.05, 0.1, 0.25, 0.5,
    1.0, 2.5, 5.0, 10.0, 30.0)

LabelKey = Tuple[Tuple[str, str], ...]
MetricKey = Tuple[str, LabelKey]

# The metric catalog: every family the port's workloads (the server and
# the trainer) register at runtime, by name -> type. The names are the
# reference's, so the controller's fleet scraper and history read a port
# replica's exposition unchanged; the controller's and the gateway's own
# families live with those components.
CATALOG: Dict[str, str] = {
    # serve: the HTTP front end's and the engine's totals, mirrored at
    # scrape time, and the histograms the engine observes as it serves
    "serve_requests_total": "counter",
    "serve_requests_failed_total": "counter",
    "serve_requests_rejected_total": "counter",
    "serve_tokens_generated_total": "counter",
    "serve_decode_steps_total": "counter",
    "serve_deadline_expired_total": "counter",
    "serve_prefix_tokens_reused_total": "counter",
    "serve_active_slots": "gauge",
    "serve_queue_depth": "gauge",
    "serve_queue_limit": "gauge",
    "serve_draining": "gauge",
    "serve_queue_wait_seconds": "histogram",
    "serve_ttft_seconds": "histogram",
    "serve_inter_token_seconds": "histogram",
    "serve_request_duration_seconds": "histogram",
    "serve_prefill_dispatch_seconds": "histogram",
    "serve_decode_dispatch_seconds": "histogram",
    # speculative decoding: exported only when speculation is on
    "serve_spec_drafted_total": "counter",
    "serve_spec_accepted_total": "counter",
    "serve_spec_accept_len": "histogram",
    "serve_verify_dispatch_seconds": "histogram",
    # trainer
    "train_step_seconds": "histogram",
    "train_data_wait_seconds": "histogram",
    "train_checkpoint_seconds": "histogram",
    "train_goodput_ratio": "gauge",
    "train_step": "gauge",
    "train_loss": "gauge",
    "train_analytic_mfu": "gauge",
    # device level (obs/device.py): the build sentinel, the program
    # census with its roofline costs, the allocator's memory
    "xla_compilations_total": "counter",
    "xla_unexpected_compiles_total": "counter",
    "xla_compile_seconds": "histogram",
    "xla_programs": "gauge",
    "xla_program_flops": "gauge",
    "xla_program_hbm_bytes": "gauge",
    "xla_program_arithmetic_intensity": "gauge",
    "xla_program_bandwidth_bound": "gauge",
    "device_memory_bytes_in_use": "gauge",
    "device_memory_peak_bytes": "gauge",
    "device_memory_bytes_limit": "gauge",
    "device_memory_headroom_bytes": "gauge",
    # KV-cache occupancy and prefix reuse
    "serve_slots_total": "gauge",
    "serve_kv_cache_tokens": "gauge",
    "serve_kv_cache_capacity_tokens": "gauge",
    "serve_kv_occupancy_ratio": "gauge",
    "serve_kv_pool_bytes": "gauge",
    "serve_kv_pool_bytes_per_device": "gauge",
    "serve_prefix_lookups_total": "counter",
    "serve_prefix_hits_total": "counter",
    # paged KV pool: exported only by the paged engine; the host tier's
    # families only with kv_host_pages > 0
    "serve_kv_pages_free": "gauge",
    "serve_kv_pages_used": "gauge",
    "serve_kv_pages_shared": "gauge",
    "serve_prefix_pages_reused_total": "counter",
    "serve_kv_host_pages_used": "gauge",
    "serve_kv_host_pages_free": "gauge",
    "serve_kv_swap_out_pages_total": "counter",
    "serve_kv_swap_in_pages_total": "counter",
    "serve_kv_swap_dropped_pages_total": "counter",
    "serve_kv_swap_seconds": "histogram",
    "serve_preemptions_total": "counter",
    "serve_preempted_resumed_total": "counter",
    # multi-tenant LoRA pool: exported only by pooled engines
    "serve_adapter_loads_total": "counter",
    "serve_adapter_evictions_total": "counter",
    "serve_adapter_hits_total": "counter",
    "serve_adapter_requests_total": "counter",
    "serve_adapters_resident": "gauge",
    # grammar-constrained output: exported only with grammar on
    "serve_grammar_requests_total": "counter",
    "serve_grammar_cache_hits_total": "counter",
    "serve_grammar_cache_misses_total": "counter",
    "serve_grammar_draft_truncations_total": "counter",
    "serve_grammar_mask_build_seconds": "histogram",
    # flight recorder, tail sampling and incident bundles
    "flight_ring_events": "gauge",
    "serve_tail_samples_total": "counter",
    "serve_incidents_total": "counter",
    "serve_incident_age_seconds": "gauge",
    # process
    "process_uptime_seconds": "gauge",
}


def escape_label_value(value: str) -> str:
    """Escape a label value per the Prometheus text format: backslash,
    double-quote, and line-feed must be escaped or the line is unparseable
    (and a hostile value could inject fake samples)."""
    return (str(value).replace("\\", "\\\\").replace('"', '\\"')
            .replace("\n", "\\n"))


def escape_help(text: str) -> str:
    """# HELP lines escape backslash and line-feed only (spec)."""
    return str(text).replace("\\", "\\\\").replace("\n", "\\n")


def _fmt(name: str, labels: LabelKey, value) -> str:
    if labels:
        inner = ",".join(f'{k}="{escape_label_value(v)}"'
                         for k, v in labels)
        return f"{name}{{{inner}}} {value}"
    return f"{name} {value}"


def _key(name: str, labels: Dict[str, str]) -> MetricKey:
    return (name, tuple(sorted((k, str(v)) for k, v in labels.items())))


class _Histogram:
    """One histogram labelset: cumulative bucket counts + sum + count."""

    __slots__ = ("bounds", "counts", "sum", "count")

    def __init__(self, bounds: Sequence[float]):
        self.bounds = tuple(bounds)
        self.counts = [0] * len(self.bounds)   # per-bucket (non-cumulative)
        self.sum = 0.0
        self.count = 0

    def observe(self, value: float) -> None:
        i = bisect.bisect_left(self.bounds, value)
        if i < len(self.counts):
            self.counts[i] += 1
        # values above the top bound land only in +Inf (== count)
        self.sum += value
        self.count += 1

    def cumulative(self) -> List[int]:
        out, acc = [], 0
        for c in self.counts:
            acc += c
            out.append(acc)
        return out

    def quantile(self, q: float) -> float:
        """Estimate the q-quantile from the buckets (linear interpolation
        inside the containing bucket, like PromQL's histogram_quantile).
        Returns the top finite bound when the quantile lands in +Inf."""
        if self.count == 0:
            return float("nan")
        rank = q * self.count
        acc = 0
        lo = 0.0
        for bound, c in zip(self.bounds, self.counts):
            if acc + c >= rank and c > 0:
                frac = (rank - acc) / c
                return lo + (bound - lo) * min(max(frac, 0.0), 1.0)
            acc += c
            lo = bound
        return self.bounds[-1] if self.bounds else float("nan")


class Registry:
    """Thread-safe metrics registry rendering Prometheus text format.

    ``inc`` accumulates counters; ``set_counter`` mirrors an externally
    maintained monotonic count (e.g. the serve engine's own totals) as an
    absolute value at scrape time; ``set_gauge`` sets gauges; ``observe``
    records into a fixed-bucket histogram. ``help_text`` registered on
    first use (or via ``describe``) renders as ``# HELP``.
    """

    def __init__(self):
        self._lock = threading.Lock()
        self._counters: Dict[MetricKey, float] = defaultdict(float)  # guarded-by: _lock
        self._gauges: Dict[MetricKey, object] = {}                   # guarded-by: _lock
        self._hists: Dict[MetricKey, _Histogram] = {}                # guarded-by: _lock
        self._help: Dict[str, str] = {}                              # guarded-by: _lock
        self.started = time.time()

    # -- write side ----------------------------------------------------

    def describe(self, name: str, help_text: str) -> None:
        with self._lock:
            self._help[name] = help_text

    def inc(self, name: str, value: float = 1.0, /, *,
            help_text: Optional[str] = None, **labels: str) -> None:
        key = _key(name, labels)
        with self._lock:
            self._counters[key] += value
            if help_text:
                self._help.setdefault(name, help_text)

    def set_counter(self, name: str, value: float, /, *,
                    help_text: Optional[str] = None, **labels: str) -> None:
        """Absolute-value counter (for mirroring a count the source object
        maintains itself — e.g. engine.steps — at scrape time)."""
        key = _key(name, labels)
        with self._lock:
            self._counters[key] = float(value)
            if help_text:
                self._help.setdefault(name, help_text)

    def set_gauge(self, name: str, value, /, *,
                  help_text: Optional[str] = None, **labels: str) -> None:
        key = _key(name, labels)
        with self._lock:
            self._gauges[key] = value
            if help_text:
                self._help.setdefault(name, help_text)

    def observe(self, name: str, value: float, /, *,
                buckets: Optional[Sequence[float]] = None,
                help_text: Optional[str] = None, **labels: str) -> None:
        key = _key(name, labels)
        with self._lock:
            hist = self._hists.get(key)
            if hist is None:
                hist = self._hists[key] = _Histogram(
                    buckets if buckets is not None else DEFAULT_BUCKETS)
            hist.observe(float(value))
            if help_text:
                self._help.setdefault(name, help_text)

    def set_histogram(self, name: str, bounds: Sequence[float],
                      cumulative: Sequence[int], count: int, sum_: float,
                      /, *, help_text: Optional[str] = None,
                      **labels: str) -> None:
        """Mirror an externally scraped histogram labelset as absolute
        state (the fleet scraper re-exposing a replica's distribution).
        `cumulative` are the finite-bound bucket counts exactly as the
        exposition carries them; `count` is the +Inf/_count value."""
        hist = _Histogram(bounds)
        acc = 0
        for i, c in enumerate(cumulative):
            hist.counts[i] = int(c) - acc
            acc = int(c)
        hist.sum = float(sum_)
        hist.count = int(count)
        with self._lock:
            self._hists[_key(name, labels)] = hist
            if help_text:
                self._help.setdefault(name, help_text)

    def drop_series(self, **labels: str) -> int:
        """Remove every series whose labelset includes ALL the given
        label pairs (e.g. ``drop_series(replica=pod)`` when a scraped
        replica disappears — its mirrored absolute values would otherwise
        read as live forever). Returns the number of series dropped."""
        match = {(k, str(v)) for k, v in labels.items()}
        dropped = 0
        with self._lock:
            for store in (self._counters, self._gauges, self._hists):
                doomed = [k for k in store if match <= set(k[1])]
                for k in doomed:
                    del store[k]
                dropped += len(doomed)
        return dropped

    # -- read side -----------------------------------------------------

    def quantile(self, name: str, q: float, /, **labels: str) -> float:
        with self._lock:
            hist = self._hists.get(_key(name, labels))
            return hist.quantile(q) if hist is not None else float("nan")

    def counter_value(self, name: str, /, **labels: str) -> float:
        with self._lock:
            return self._counters.get(_key(name, labels), 0.0)

    def histogram_stats(self, name: str, /,
                        **labels: str) -> Optional[Tuple[int, float]]:
        """(count, sum) of one histogram labelset, or None — the mean
        dispatch time a roofline's analytic MFU divides by."""
        with self._lock:
            hist = self._hists.get(_key(name, labels))
            return (hist.count, hist.sum) if hist is not None else None

    def render(self) -> str:
        """Prometheus text format, grouped per family: ``# HELP`` and
        ``# TYPE`` precede every family's samples (required by the spec —
        fixing the old renderer, whose interleaved sorted dump had no type
        lines at all)."""
        lines: List[str] = []
        with self._lock:
            families: Dict[str, List[Tuple[str, LabelKey, object]]] = {}
            types: Dict[str, str] = {}
            for (name, labels), value in sorted(self._counters.items()):
                families.setdefault(name, []).append((name, labels, value))
                types[name] = "counter"
            for (name, labels), value in sorted(self._gauges.items()):
                families.setdefault(name, []).append((name, labels, value))
                types[name] = "gauge"
            uptime = time.time() - self.started
            families.setdefault("process_uptime_seconds", []).append(
                ("process_uptime_seconds", (), uptime))
            types["process_uptime_seconds"] = "gauge"
            self._help.setdefault("process_uptime_seconds",
                                  "Seconds since this registry was created.")
            for name in sorted(families):
                if name in self._help:
                    lines.append(
                        f"# HELP {name} {escape_help(self._help[name])}")
                lines.append(f"# TYPE {name} {types[name]}")
                for sample_name, labels, value in families[name]:
                    lines.append(_fmt(sample_name, labels, value))
            hist_names = sorted({name for name, _ in self._hists})
            for name in hist_names:
                if name in self._help:
                    lines.append(
                        f"# HELP {name} {escape_help(self._help[name])}")
                lines.append(f"# TYPE {name} histogram")
                for (hname, labels), hist in sorted(self._hists.items()):
                    if hname != name:
                        continue
                    cum = hist.cumulative()
                    for bound, c in zip(hist.bounds, cum):
                        bl = labels + (("le", f"{bound:g}"),)
                        lines.append(_fmt(f"{name}_bucket", bl, c))
                    lines.append(_fmt(f"{name}_bucket",
                                      labels + (("le", "+Inf"),),
                                      hist.count))
                    lines.append(_fmt(f"{name}_sum", labels,
                                      round(hist.sum, 9)))
                    lines.append(_fmt(f"{name}_count", labels, hist.count))
        return "\n".join(lines) + "\n"

    def reset(self) -> None:
        """Drop all series (tests; a process never needs this)."""
        with self._lock:
            self._counters.clear()
            self._gauges.clear()
            self._hists.clear()


# The process-wide registry: the server, the engine and the trainer record
# here, so one /metrics scrape sees every layer living in the process.
REGISTRY = Registry()


def serve_metrics(port: int,
                  registry: Optional[Registry] = None) -> HTTPServer:
    """Serve GET /metrics on a background thread (the trainer's
    RBT_METRICS_PORT). port=0 binds an ephemeral port (tests); read it
    back from ``httpd.server_address``."""
    reg = registry if registry is not None else REGISTRY

    class Handler(BaseHTTPRequestHandler):
        def do_GET(self):  # noqa: N802
            if self.path.split("?", 1)[0] == "/metrics":
                body = reg.render().encode("utf-8")
                self.send_response(200)
                self.send_header("Content-Type", CONTENT_TYPE)
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)
            else:
                self.send_response(404)
                self.end_headers()

        def log_message(self, *args):
            return

    httpd = HTTPServer(("0.0.0.0", port), Handler)
    threading.Thread(target=httpd.serve_forever, daemon=True).start()
    return httpd


# ---------------------------------------------------------------------------
# Exposition parsing (the scrape side of the text format this module
# renders): what a scraper reads back from any /metrics body. Stdlib-only
# for the same reason the renderer is.
# ---------------------------------------------------------------------------

import re as _re

_SAMPLE_RE = _re.compile(
    r"^([a-zA-Z_:][a-zA-Z0-9_:]*)(?:\{(.*)\})?\s+(\S+)$")
_LABEL_RE = _re.compile(
    r'([a-zA-Z_][a-zA-Z0-9_]*)="((?:[^"\\]|\\.)*)"')


def _unescape_label(value: str) -> str:
    return (value.replace("\\n", "\n").replace('\\"', '"')
            .replace("\\\\", "\\"))


class ParsedHistogram:
    """One histogram labelset as scraped: finite-bound cumulative counts
    + count (+Inf) + sum, with the same quantile estimate the live
    _Histogram computes."""

    __slots__ = ("bounds", "cumulative", "count", "sum")

    def __init__(self):
        self.bounds: List[float] = []
        self.cumulative: List[int] = []
        self.count = 0
        self.sum = 0.0

    def quantile(self, q: float) -> float:
        hist = _Histogram(self.bounds)
        acc = 0
        for i, c in enumerate(self.cumulative):
            hist.counts[i] = int(c) - acc
            acc = int(c)
        hist.sum = self.sum
        hist.count = self.count
        return hist.quantile(q)

    def merged(self, other: "ParsedHistogram") -> "ParsedHistogram":
        """Sum with another labelset over the SAME bounds (cross-replica
        aggregation); mismatched bounds keep self (can't merge buckets)."""
        if other.bounds != self.bounds:
            return self
        out = ParsedHistogram()
        out.bounds = list(self.bounds)
        out.cumulative = [a + b for a, b in
                          zip(self.cumulative, other.cumulative)]
        out.count = self.count + other.count
        out.sum = self.sum + other.sum
        return out


class ParsedFamily:
    """One metric family from a scraped exposition."""

    __slots__ = ("name", "type", "samples", "histograms")

    def __init__(self, name: str, type_: str = "untyped"):
        self.name = name
        self.type = type_
        # counter/gauge: labelset -> value
        self.samples: Dict[LabelKey, float] = {}
        # histogram: labelset (without `le`) -> ParsedHistogram
        self.histograms: Dict[LabelKey, ParsedHistogram] = {}

    def value(self, default: float = 0.0, **labels: str) -> float:
        return self.samples.get(
            tuple(sorted((k, str(v)) for k, v in labels.items())), default)

    def total(self) -> float:
        """Sum across labelsets (cross-replica aggregation of a counter
        or additive gauge)."""
        return sum(self.samples.values())

    def merged_histogram(self) -> Optional[ParsedHistogram]:
        """All labelsets merged into one distribution (same-bounds only)."""
        out = None
        for hist in self.histograms.values():
            out = hist if out is None else out.merged(hist)
        return out


def parse_exposition(text: str) -> Dict[str, ParsedFamily]:
    """Parse a Prometheus text exposition (the format ``render`` emits,
    including histograms) into families. Unknown/malformed lines are
    skipped — a scrape must degrade, not crash the scraper."""
    families: Dict[str, ParsedFamily] = {}
    types: Dict[str, str] = {}
    for line in text.splitlines():
        line = line.strip()
        if not line:
            continue
        if line.startswith("#"):
            parts = line.split(None, 3)
            if len(parts) >= 4 and parts[1] == "TYPE":
                types[parts[2]] = parts[3]
                families.setdefault(parts[2], ParsedFamily(
                    parts[2], parts[3])).type = parts[3]
            continue
        m = _SAMPLE_RE.match(line)
        if not m:
            continue
        name, label_blob, raw = m.group(1), m.group(2), m.group(3)
        try:
            value = float(raw)
        except ValueError:
            continue
        labels = {k: _unescape_label(v)
                  for k, v in _LABEL_RE.findall(label_blob or "")}
        # Histogram series fold into their base family.
        base = None
        for suffix in ("_bucket", "_sum", "_count"):
            cand = name[: -len(suffix)] if name.endswith(suffix) else None
            if cand and types.get(cand) == "histogram":
                base = cand
                break
        if base is not None:
            fam = families.setdefault(base, ParsedFamily(base, "histogram"))
            le = labels.pop("le", None)
            lkey = tuple(sorted(labels.items()))
            hist = fam.histograms.setdefault(lkey, ParsedHistogram())
            if name.endswith("_bucket"):
                if le == "+Inf":
                    hist.count = int(value)
                elif le is not None:
                    hist.bounds.append(float(le))
                    hist.cumulative.append(int(value))
            elif name.endswith("_sum"):
                hist.sum = value
            elif name.endswith("_count"):
                hist.count = int(value)
            continue
        fam = families.setdefault(
            name, ParsedFamily(name, types.get(name, "untyped")))
        fam.samples[tuple(sorted(labels.items()))] = value
    return families
