"""Fleet time-series history: bounded in-memory rings over scraped
metrics (the port's copy of ``runbooks_tpu.obs.history``; the same
arithmetic and the same snapshot JSON, so a snapshot written by one loads
in the other).

A scraper that keeps only the latest sample per replica cannot answer a
windowed question ("what did TTFT p99 do over the last 15 minutes", "is
queue-wait p90 high *sustained* or just this instant"). This module is
that memory:

- **Rings.** Every series a scraper appends (``serve_*``/``train_*``/
  ``xla_*``/``device_*``/``gateway_*``/``flight_*``/``fleet_*``) gets a
  bounded ring of ``(t, value)`` points; histograms keep their full
  cumulative bucket snapshot per point, so windowed quantiles are EXACT
  bucket deltas (the PromQL ``histogram_quantile(rate(..._bucket[W]))``
  equivalent), not decaying estimates. Appends are O(1)
  (``collections.deque``).
- **Two resolutions.** A raw ring at scrape cadence (default 10 s, 15 min
  retention) and a rollup ring (default 60 s, 6 h retention) for slow
  windows. The rollup point is the first raw sample at/after each 60 s
  grid boundary: exact for cumulative series (counters, histogram
  snapshots), a 1-in-N sample for gauges.
- **Staleness.** A replica that vanishes has its series *marked stale*,
  not deleted: window queries exclude stale series (a dead pod's last
  distribution must not bias a cross-replica p90 mid-scale-in), and
  ``prune`` drops them once their newest point ages out of raw
  retention.
- **Snapshots.** ``save``/``load`` persist the rings as one JSON file
  (atomic tmp+rename); a corrupt or partial snapshot logs loudly and
  cold-starts, never raises.

Read through ``window_*`` (burn rates, windowed p90s), ``query``/``index``
and ``http_query``, the JSON behind ``GET /metrics/history``
(``obs.metrics.serve_metrics(port, history=...)``). Standard library
only: a gateway or scraper process that holds a history needs no torch.
"""

from __future__ import annotations

import json
import math
import os
import threading
import time
from collections import deque
from typing import Dict, List, Optional, Sequence, Tuple

LabelKey = Tuple[Tuple[str, str], ...]
SeriesKey = Tuple[str, LabelKey]

# Scalar point: (t, value). Histogram point: (t, count, sum, cumulative)
# where `cumulative` are the finite-bound bucket counts exactly as the
# exposition carries them (bounds live on the series, not the point).

DEFAULT_RAW_STEP_S = 10.0
DEFAULT_RAW_RETENTION_S = 900.0
DEFAULT_ROLLUP_STEP_S = 60.0
DEFAULT_ROLLUP_RETENTION_S = 21600.0
DEFAULT_MAX_SERIES = 4096

# /metrics/history response bounds: points per series per response and
# series names per request — the endpoint must stay scrape-sized, never
# a bulk-export API.
MAX_QUERY_POINTS = 720
MAX_QUERY_SERIES = 16
MAX_INDEX_SERIES = 2000


def _labelkey(labels) -> LabelKey:
    if isinstance(labels, tuple):
        return labels
    return tuple(sorted((k, str(v)) for k, v in labels.items()))


def default_snapshot_path() -> str:
    """Where a history persists between restarts: RBT_HISTORY_SNAPSHOT,
    or ``{artifacts}/fleet_history.json`` (the shared artifacts mount, so
    a restarted process reads its predecessor's snapshot)."""
    explicit = os.environ.get("RBT_HISTORY_SNAPSHOT")
    if explicit:
        return explicit
    from runbooks_tpu_torch.utils.contract import artifacts_dir

    return os.path.join(artifacts_dir(), "fleet_history.json")


def fraction_at_or_below(bounds: Sequence[float], deltas: Sequence[float],
                         count: float, threshold: float) -> float:
    """Estimated number of observations <= ``threshold`` in a windowed
    (delta) histogram, linear-interpolating inside the containing bucket
    like PromQL's histogram_quantile. Observations in +Inf (above the
    top finite bound) count as ABOVE any finite threshold."""
    acc = 0.0
    lo = 0.0
    for bound, c in zip(bounds, deltas):
        if threshold >= bound:
            acc += c
            lo = bound
            continue
        if bound > lo and threshold > lo:
            acc += c * (threshold - lo) / (bound - lo)
        break
    return min(acc, count)


class _WindowHist:
    """A merged windowed histogram delta: what happened inside [now-W, now]."""

    __slots__ = ("bounds", "deltas", "count", "sum", "span_s")

    def __init__(self, bounds, deltas, count, sum_, span_s):
        self.bounds = bounds
        self.deltas = deltas
        self.count = count
        self.sum = sum_
        self.span_s = span_s

    def quantile(self, q: float) -> float:
        from runbooks_tpu_torch.obs.metrics import _Histogram

        hist = _Histogram(self.bounds)
        hist.counts = [max(0.0, d) for d in self.deltas]
        hist.count = self.count
        hist.sum = self.sum
        return hist.quantile(q)

    def fraction_above(self, threshold: float) -> float:
        """Fraction of the window's observations above ``threshold``
        (0.0 when the window saw no traffic)."""
        if self.count <= 0:
            return 0.0
        below = fraction_at_or_below(self.bounds, self.deltas, self.count,
                                     threshold)
        return max(0.0, (self.count - below) / self.count)


class _Series:
    """One (name, labels) ring pair. Not thread-safe on its own — every
    access goes through FleetHistory's lock."""

    __slots__ = ("name", "type", "labels", "bounds", "raw", "rollup",
                 "stale_since", "next_rollup_t")

    def __init__(self, name: str, type_: str, labels: LabelKey,
                 raw_maxlen: int, rollup_maxlen: int):
        self.name = name
        self.type = type_
        self.labels = labels
        self.bounds: Optional[Tuple[float, ...]] = None
        self.raw = deque(maxlen=raw_maxlen)
        self.rollup = deque(maxlen=rollup_maxlen)
        self.stale_since: Optional[float] = None
        self.next_rollup_t: Optional[float] = None


class FleetHistory:
    """Thread-safe store of bounded per-series time rings.

    Written by a scraper on every scrape tick (``ingest``); read by
    windowed evaluations (``window_*``) and the /metrics/history
    endpoint (``http_query``)."""

    def __init__(self, raw_step_s: float = DEFAULT_RAW_STEP_S,
                 raw_retention_s: float = DEFAULT_RAW_RETENTION_S,
                 rollup_step_s: float = DEFAULT_ROLLUP_STEP_S,
                 rollup_retention_s: float = DEFAULT_ROLLUP_RETENTION_S,
                 max_series: int = DEFAULT_MAX_SERIES):
        self.raw_step_s = float(raw_step_s)
        self.raw_retention_s = float(raw_retention_s)
        self.rollup_step_s = float(rollup_step_s)
        self.rollup_retention_s = float(rollup_retention_s)
        self.max_series = int(max_series)
        self._raw_maxlen = max(2, int(raw_retention_s / max(raw_step_s,
                                                            1e-9)) + 3)
        self._rollup_maxlen = max(2, int(
            rollup_retention_s / max(rollup_step_s, 1e-9)) + 3)
        self._lock = threading.RLock()
        self._series: Dict[SeriesKey, _Series] = {}   # guarded-by: _lock
        self._dropped_series = 0                      # guarded-by: _lock
        self._warned_cap = False                      # guarded-by: _lock
        # Scrape-path memo: (name, parsed-labelkey, extra-labelkey) ->
        # merged LabelKey, so per-tick ingestion never re-sorts label
        # dicts that were sorted last tick.
        self._lkey_cache: Dict[tuple, LabelKey] = {}  # guarded-by: _lock

    # -- write side ----------------------------------------------------

    def _series_for(self, name: str, labels: LabelKey,  # guarded-by: _lock
                    type_: str) -> Optional[_Series]:
        key = (name, labels)
        s = self._series.get(key)
        if s is None:
            if len(self._series) >= self.max_series:
                self._dropped_series += 1
                if not self._warned_cap:
                    self._warned_cap = True
                    print(f"fleet-history: series cap ({self.max_series}) "
                          "reached; new series are dropped (raise "
                          "FleetHistory(max_series=) or reduce the fleet's "
                          "label cardinality)", flush=True)
                return None
            s = self._series[key] = _Series(name, type_, labels,
                                            self._raw_maxlen,
                                            self._rollup_maxlen)
        s.type = type_
        # A fresh point un-stales the series (a replica that came back).
        s.stale_since = None
        return s

    def _append(self, s: _Series, t: float, point: tuple) -> None:  # guarded-by: _lock
        s.raw.append(point)
        if s.next_rollup_t is None or t >= s.next_rollup_t:
            s.rollup.append(point)
            # Next rollup lands on the grid boundary after t, so uneven
            # scrape cadences still produce ~one rollup point per bucket.
            s.next_rollup_t = (math.floor(t / self.rollup_step_s) + 1) \
                * self.rollup_step_s

    def append_scalar(self, name: str, labels, t: float, value: float,
                      type_: str = "gauge") -> None:
        lkey = _labelkey(labels)
        with self._lock:
            s = self._series_for(name, lkey, type_)
            if s is not None:
                self._append(s, t, (t, float(value)))

    def _append_hist_locked(self, name, lkey, t,  # guarded-by: _lock
                            bounds, cumulative, count, sum_) -> None:
        s = self._series_for(name, lkey, "histogram")
        if s is None:
            return
        # No per-element float() pass: the scrape path appends one
        # snapshot per series per tick and the delta math is int/float
        # agnostic.
        bounds = tuple(bounds)
        if s.bounds is not None and s.bounds != bounds:
            # Bucket layout changed (redeploy with different buckets):
            # old points can't delta against new ones.
            s.raw.clear()
            s.rollup.clear()
            s.next_rollup_t = None
        s.bounds = bounds
        self._append(s, t, (t, count, float(sum_), tuple(cumulative)))

    def append_histogram(self, name: str, labels, t: float,
                         bounds: Sequence[float],
                         cumulative: Sequence[float], count: float,
                         sum_: float) -> None:
        lkey = _labelkey(labels)
        with self._lock:
            self._append_hist_locked(name, lkey, t, bounds, cumulative,
                                     count, sum_)

    def ingest(self, families, extra: Dict[str, str], t: float,
               prefixes) -> None:
        """Bulk scrape-path ingestion: one replica's parsed exposition
        (obs/metrics.ParsedFamily dict) appended under a single lock
        acquisition, with merged label keys memoized across ticks —
        this is the whole per-tick history tax on the scraper."""
        extra_key = tuple(sorted(extra.items()))
        with self._lock:
            cache = self._lkey_cache
            if len(cache) > 4 * self.max_series:
                cache.clear()
            for fam in families.values():
                if not fam.name.startswith(prefixes):
                    continue
                if fam.type == "histogram":
                    for lkey, hist in fam.histograms.items():
                        ck = (fam.name, lkey, extra_key)
                        mk = cache.get(ck)
                        if mk is None:
                            mk = cache[ck] = tuple(sorted(
                                {**dict(lkey), **extra}.items()))
                        self._append_hist_locked(
                            fam.name, mk, t, hist.bounds,
                            hist.cumulative, hist.count, hist.sum)
                else:
                    for lkey, value in fam.samples.items():
                        ck = (fam.name, lkey, extra_key)
                        mk = cache.get(ck)
                        if mk is None:
                            mk = cache[ck] = tuple(sorted(
                                {**dict(lkey), **extra}.items()))
                        s = self._series_for(fam.name, mk, fam.type)
                        if s is not None:
                            self._append(s, t, (t, float(value)))

    def mark_stale(self, t: Optional[float] = None, **labels) -> int:
        """Mark every series whose labelset includes all given pairs as
        stale (e.g. ``mark_stale(replica=pod)`` when a replica vanishes).
        Stale series are excluded from window queries and pruned once
        their newest point ages out of raw retention. Returns the number
        of series marked."""
        t = time.time() if t is None else t
        match = {(k, str(v)) for k, v in labels.items()}
        n = 0
        with self._lock:
            for s in self._series.values():
                if s.stale_since is None and match <= set(s.labels):
                    s.stale_since = t
                    n += 1
        return n

    def prune(self, now: Optional[float] = None) -> int:
        """Drop stale series whose newest point is older than raw
        retention (the scraper's retain pass). Live series age out via
        their ring maxlen; only stale ones need explicit deletion."""
        now = time.time() if now is None else now
        doomed: List[SeriesKey] = []
        with self._lock:
            for key, s in self._series.items():
                if s.stale_since is None:
                    continue
                newest = s.raw[-1][0] if s.raw else (
                    s.rollup[-1][0] if s.rollup else None)
                if newest is None or now - newest > self.raw_retention_s:
                    doomed.append(key)
            for key in doomed:
                del self._series[key]
        return len(doomed)

    def reset(self) -> None:
        with self._lock:
            self._series.clear()
            self._lkey_cache.clear()
            self._dropped_series = 0
            self._warned_cap = False

    def stats(self) -> Dict[str, int]:
        with self._lock:
            points = sum(len(s.raw) + len(s.rollup)
                         for s in self._series.values())
            stale = sum(1 for s in self._series.values()
                        if s.stale_since is not None)
            return {"series": len(self._series), "points": points,
                    "stale": stale, "dropped": self._dropped_series}

    # -- window queries (burn rates, autoscaler) -----------------------

    def _matching(self, name: str, sel: Dict[str, str],  # guarded-by: _lock
                  include_stale: bool = False) -> List[_Series]:
        match = {(k, str(v)) for k, v in sel.items()}
        return [s for (n, _), s in self._series.items()
                if n == name and match <= set(s.labels)
                and (include_stale or s.stale_since is None)]

    @staticmethod
    def _latest(s: _Series) -> Optional[tuple]:
        if s.raw:
            return s.raw[-1]
        if s.rollup:
            return s.rollup[-1]
        return None

    def _baseline(self, s: _Series, cut: float, window_s: float,
                  partial: bool) -> Optional[tuple]:
        """The newest point at or before ``cut`` — the raw ring first,
        then the rollup. A ring whose span *almost* reaches the cut (its
        oldest point within one step of it, capped at half the window so
        a sliver of history can never claim to answer a much longer
        window) yields its oldest point, so a window exactly as long as
        the retention is still computable. ``partial=True`` falls all
        the way back to the oldest point held (the budget accountant's
        'over available history' mode)."""
        for ring, step in ((s.raw, self.raw_step_s),
                           (s.rollup, self.rollup_step_s)):
            for point in reversed(ring):
                if point[0] <= cut:
                    return point
            if ring and ring[0][0] <= cut + min(step, window_s / 2.0):
                return ring[0]
        if partial:
            if s.rollup and (not s.raw or s.rollup[0][0] <= s.raw[0][0]):
                return s.rollup[0]
            if s.raw:
                return s.raw[0]
        return None

    def window_histogram(self, name: str, window_s: float,
                         now: Optional[float] = None,
                         partial: bool = False,
                         sel: Optional[Dict[str, str]] = None,
                         ) -> Optional[_WindowHist]:
        """The merged cross-replica histogram DELTA over the trailing
        window — what the fleet actually observed inside [now-W, now] —
        or None when no matching non-stale series can provide a baseline
        that old. A counter reset (replica restart) makes the latest
        snapshot the whole delta for that series."""
        now = time.time() if now is None else now
        cut = now - window_s
        sel = sel or {}
        merged_bounds = None
        deltas: List[float] = []
        count = 0.0
        sum_ = 0.0
        span = 0.0
        found = False
        with self._lock:
            for s in self._matching(name, sel):
                if s.type != "histogram" or s.bounds is None:
                    continue
                latest = self._latest(s)
                base = self._baseline(s, cut, window_s, partial)
                if latest is None or base is None:
                    continue
                if merged_bounds is None:
                    merged_bounds = s.bounds
                    deltas = [0.0] * len(s.bounds)
                elif s.bounds != merged_bounds:
                    continue  # mismatched layouts can't merge
                lt, lcount, lsum, lcum = latest
                bt, bcount, bsum, bcum = base
                if lcount < bcount:
                    # Counter reset (replica restart): the latest
                    # snapshot IS the observable delta.
                    bcount, bsum, bcum = 0.0, 0.0, (0.0,) * len(lcum)
                elif lt <= bt:
                    # One point, older than the cut (a silent replica):
                    # nothing new was observed inside the window.
                    bcount, bsum, bcum = lcount, lsum, lcum
                prev = 0.0
                bprev = 0.0
                for i in range(len(merged_bounds)):
                    dc = max(0.0, (lcum[i] - prev) - (bcum[i] - bprev))
                    deltas[i] += dc
                    prev, bprev = lcum[i], bcum[i]
                count += max(0.0, lcount - bcount)
                sum_ += max(0.0, lsum - bsum)
                span = max(span, lt - bt)
                found = True
        if not found:
            return None
        return _WindowHist(merged_bounds, deltas, count, sum_, span)

    def window_quantile(self, name: str, q: float, window_s: float,
                        now: Optional[float] = None,
                        sel: Optional[Dict[str, str]] = None,
                        ) -> Optional[float]:
        """Cross-replica q-quantile of observations inside the trailing
        window (None when the window isn't computable or saw nothing)."""
        wh = self.window_histogram(name, window_s, now=now, sel=sel)
        if wh is None or wh.count <= 0:
            return None
        return wh.quantile(q)

    def window_increase(self, name: str, window_s: float,
                        now: Optional[float] = None,
                        partial: bool = False,
                        sel: Optional[Dict[str, str]] = None,
                        ) -> Optional[float]:
        """Summed counter increase over the trailing window across
        matching non-stale series (PromQL ``increase()``), reset-aware.
        None when no series can provide a baseline."""
        now = time.time() if now is None else now
        cut = now - window_s
        sel = sel or {}
        total = None
        with self._lock:
            for s in self._matching(name, sel):
                if s.type == "histogram":
                    continue
                latest = self._latest(s)
                base = self._baseline(s, cut, window_s, partial)
                if latest is None or base is None:
                    continue
                lv = latest[1]
                bv = base[1] if latest[0] > base[0] else lv
                inc = lv if lv < bv else lv - bv   # reset -> whole value
                total = inc if total is None else total + inc
        return total

    # -- grid queries (the /metrics/history read path) ---------------

    def _grid_series(self, s: _Series, step: float, n: int, now: float,
                     q: float) -> Tuple[List[Optional[tuple]],
                                        Optional[tuple]]:
        """One series resampled onto the right-aligned grid of ``n``
        cells ending at ``now``: cell i covers
        (now-(n-i)*step, now-(n-1-i)*step]. Value per cell is the last
        point that landed in it (None for empty cells). Also returns the
        newest point BEFORE the grid, so the first populated cell's
        delta (histograms, counter rates) baselines against real
        history instead of rendering the cumulative-since-start value."""
        ring = s.rollup if step >= self.rollup_step_s else s.raw
        cells: List[Optional[tuple]] = [None] * n
        start = now - n * step
        pre: Optional[tuple] = None
        for point in ring:
            idx = int((point[0] - start) / step) if step > 0 else -1
            if 0 <= idx < n:
                cells[idx] = point
            elif idx < 0:
                pre = point  # ring is time-ordered: keeps the newest
        return cells, pre

    def query(self, name: str, since_s: float, step_s: float,
              now: Optional[float] = None, q: float = 0.5,
              agg: str = "sum", sel: Optional[Dict[str, str]] = None,
              max_points: int = MAX_QUERY_POINTS) -> dict:
        """One merged series resampled onto a fixed grid, JSON-shaped:

        ``{"name", "type", "step", "points": [[t, v|null], ...],
           "series": <labelsets merged>, "stale_excluded": k}``

        Values per grid cell: gauges aggregate across series (``agg`` =
        sum|avg|max), counters become per-second rates (reset-clamped),
        histograms become the q-quantile of the cell-over-cell bucket
        delta. ``null`` marks cells with no data (staleness gaps render
        as gaps, not zeros). A ``since``/``step`` pair asking for more
        than ``max_points`` cells WIDENS the step to cover the full
        window (the caller reads the effective step back from the
        response) — never a silent truncation of the window."""
        now = time.time() if now is None else now
        step = max(float(step_s), 1e-3, float(since_s) / int(max_points))
        n = max(1, int(float(since_s) / step))
        sel = sel or {}
        with self._lock:
            series = self._matching(name, sel)
            stale_excluded = len(self._matching(name, sel,
                                                include_stale=True)) \
                - len(series)
            type_ = series[0].type if series else "untyped"
            grids = [(s,) + self._grid_series(s, step, n, now, q)
                     for s in series]
            points: List[list] = []
            for i in range(n):
                t_cell = now - (n - 1 - i) * step
                vals: List[float] = []
                for s, cells, pre in grids:
                    point = cells[i]
                    if point is None:
                        continue
                    if s.type == "histogram":
                        prev = next((cells[j] for j in range(i - 1, -1, -1)
                                     if cells[j] is not None), pre)
                        v = self._hist_cell_value(s, point, prev, q)
                    elif s.type == "counter":
                        prev = next((cells[j] for j in range(i - 1, -1, -1)
                                     if cells[j] is not None), pre)
                        v = self._rate_cell_value(point, prev)
                    else:
                        v = point[1]
                    if v is not None:
                        vals.append(v)
                if not vals:
                    points.append([round(t_cell, 3), None])
                elif agg == "avg":
                    points.append([round(t_cell, 3),
                                   sum(vals) / len(vals)])
                elif agg == "max":
                    points.append([round(t_cell, 3), max(vals)])
                else:
                    points.append([round(t_cell, 3), sum(vals)])
        return {"name": name, "type": type_, "step": step,
                "points": points, "series": len(grids),
                "stale_excluded": stale_excluded}

    @staticmethod
    def _hist_cell_value(s: _Series, point: tuple, prev: Optional[tuple],
                         q: float) -> Optional[float]:
        t, count, sum_, cum = point
        if prev is not None and prev[1] <= count:
            bcount, bcum = prev[1], prev[3]
        else:
            bcount, bcum = 0.0, (0.0,) * len(cum)
        dcount = count - bcount
        if dcount <= 0 or s.bounds is None:
            return None
        deltas = []
        p = bp = 0.0
        for i in range(len(s.bounds)):
            deltas.append(max(0.0, (cum[i] - p) - (bcum[i] - bp)))
            p, bp = cum[i], bcum[i]
        return _WindowHist(s.bounds, deltas, dcount, 0.0, 0.0).quantile(q)

    @staticmethod
    def _rate_cell_value(point: tuple, prev: Optional[tuple],
                         ) -> Optional[float]:
        if prev is None:
            return None
        t, v = point
        pt, pv = prev[0], prev[1]
        if t <= pt:
            return None
        return max(0.0, v - (pv if v >= pv else 0.0)) / (t - pt)

    def index(self) -> dict:
        """Bounded series listing + ring config (the no-params
        /metrics/history response; a dashboard reads the config to pick
        its default step/window)."""
        with self._lock:
            entries = []
            for (name, _), s in sorted(self._series.items())[
                    :MAX_INDEX_SERIES]:
                newest = self._latest(s)
                entries.append({
                    "name": name, "type": s.type,
                    "labels": dict(s.labels),
                    "stale": s.stale_since is not None,
                    "points": len(s.raw) + len(s.rollup),
                    "newest": round(newest[0], 3) if newest else None,
                })
            stats = {"series": len(self._series),
                     "dropped": self._dropped_series}
        return {
            "config": {"raw_step_s": self.raw_step_s,
                       "raw_retention_s": self.raw_retention_s,
                       "rollup_step_s": self.rollup_step_s,
                       "rollup_retention_s": self.rollup_retention_s,
                       "max_series": self.max_series},
            "stats": stats,
            "series": entries,
        }

    _QUERY_PARAMS = ("series", "since", "step", "q", "agg")

    def http_query(self, params: Dict[str, List[str]],
                   now: Optional[float] = None) -> dict:
        """The GET /metrics/history contract: ``params`` is a parsed
        query string (parse_qs shape). Without ``series`` returns the
        bounded index; with it, merged grid series per requested name.
        Unknown params are label selectors (``name=srv&namespace=default``).
        Raises ValueError on malformed numbers (the handler's 400)."""

        def first(key, default=None):
            vals = params.get(key)
            return vals[0] if vals else default

        names = [n for n in (first("series") or "").split(",") if n]
        if not names:
            return self.index()
        if len(names) > MAX_QUERY_SERIES:
            raise ValueError(
                f"series: at most {MAX_QUERY_SERIES} names per request")
        since = float(first("since", self.raw_retention_s))
        since = min(max(since, 0.0), self.rollup_retention_s)
        step = float(first("step", self.raw_step_s))
        q = float(first("q", 0.5))
        if not 0.0 < q < 1.0:
            raise ValueError("q: must be in (0, 1)")
        agg = first("agg", "sum")
        if agg not in ("sum", "avg", "max"):
            raise ValueError("agg: expected sum|avg|max")
        sel = {k: v[0] for k, v in params.items()
               if k not in self._QUERY_PARAMS and v}
        now = time.time() if now is None else now
        return {
            "now": round(now, 3), "since": since, "step": step,
            "series": [self.query(name, since, step, now=now, q=q,
                                  agg=agg, sel=sel) for name in names],
        }

    # -- snapshot persistence ------------------------------------------

    def to_snapshot(self) -> dict:
        with self._lock:
            series = []
            for (name, _), s in self._series.items():
                series.append({
                    "name": name, "type": s.type,
                    "labels": list(s.labels),
                    "bounds": list(s.bounds) if s.bounds else None,
                    "stale_since": s.stale_since,
                    "next_rollup_t": s.next_rollup_t,
                    "raw": [list(p) for p in s.raw],
                    "rollup": [list(p) for p in s.rollup],
                })
        return {"version": 1, "saved_at": time.time(),
                "config": {"raw_step_s": self.raw_step_s,
                           "rollup_step_s": self.rollup_step_s},
                "series": series}

    def load_snapshot(self, snap: dict) -> int:
        """Restore rings from a snapshot dict. Raises on malformed input
        (callers treat any exception as 'corrupt'); returns the number
        of series restored. Points older than the rollup retention are
        dropped; everything else survives verbatim, stale markers
        included."""
        if snap.get("version") != 1:
            raise ValueError(f"unknown snapshot version "
                             f"{snap.get('version')!r}")
        cutoff = time.time() - self.rollup_retention_s
        restored = 0
        with self._lock:
            self._series.clear()
            for entry in snap["series"]:
                name = entry["name"]
                lkey = tuple((str(k), str(v)) for k, v in entry["labels"])
                s = _Series(name, entry["type"], lkey, self._raw_maxlen,
                            self._rollup_maxlen)
                if entry.get("bounds"):
                    s.bounds = tuple(float(b) for b in entry["bounds"])
                s.stale_since = entry.get("stale_since")
                s.next_rollup_t = entry.get("next_rollup_t")
                for ring_name in ("raw", "rollup"):
                    ring = getattr(s, ring_name)
                    for p in entry[ring_name]:
                        t = float(p[0])
                        if t < cutoff:
                            continue
                        if len(p) == 2:
                            ring.append((t, float(p[1])))
                        else:
                            ring.append((t, float(p[1]), float(p[2]),
                                         tuple(float(c) for c in p[3])))
                self._series[(name, lkey)] = s
                restored += 1
        return restored

    def save(self, path: str) -> bool:
        """Atomic snapshot write (tmp + os.replace): a crash mid-write
        leaves the previous snapshot intact, never a truncated JSON the
        next start would choke on. Never raises — persistence is a
        nicety; the scrape loop must outlive a full disk."""
        tmp = f"{path}.tmp"
        try:
            os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
            with open(tmp, "w") as f:
                json.dump(self.to_snapshot(), f)
            os.replace(tmp, path)
            return True
        except OSError as e:
            print(f"fleet-history: snapshot save to {path} failed "
                  f"(continuing without persistence): {e}", flush=True)
            try:
                os.unlink(tmp)
            except OSError:
                pass
            return False

    def load(self, path: str) -> str:
        """Restore from ``path``. Returns "restored", "cold" (no file),
        or "corrupt" (unreadable/partial — logged LOUDLY, rings reset,
        never raises: a bad snapshot must not crash its process)."""
        if not os.path.exists(path):
            return "cold"
        try:
            with open(path) as f:
                snap = json.load(f)
            n = self.load_snapshot(snap)
        except Exception as e:  # noqa: BLE001 — any corruption -> cold start
            self.reset()
            print(f"fleet-history: SNAPSHOT CORRUPT at {path} ({e!r}); "
                  "cold-starting with empty history — burn-rate windows "
                  "re-warm from live scrapes", flush=True)
            return "corrupt"
        print(f"fleet-history: restored {n} series from {path}",
              flush=True)
        return "restored"


# The process-wide history: a process's scraper writes, its windowed
# evaluations and the /metrics/history endpoint read (the same pattern as
# the process-wide REGISTRY).
HISTORY = FleetHistory()
