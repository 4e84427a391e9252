"""Flight recorder: an always-on bounded ring of recent trace events (the
port's copy of ``runbooks_tpu.obs.flight``).

``RBT_TRACE=1`` file tracing (obs/trace.py) is opt-in because an
unbounded JSONL stream is the wrong default for a long-lived server —
but when a request times out at 3 a.m. the spans that would explain it
were exactly the ones nobody was writing. This module keeps the last N
span/instant events **in memory, always**, independent of the file
switch: obs/trace.py tees every event it builds into :data:`RING`, so
the recent timeline (queue-wait → prefill → decode chunks → finish) is
reconstructible after the fact at near-zero steady-state cost (one
lock-guarded deque append per event).

Surfaces:

- ``GET /debug/flight[?request_id=]`` on the serve API returns the ring
  (filtered to one request id when given) plus the process identity
  (host/pid/component) so ``rbt trace`` can merge rings from multiple
  pods into one clock-ordered timeline.
- **Tail sampling** (:func:`tail_sample`): requests that finish slow
  (``RBT_TRACE_TAIL_MS``), by deadline, or by error get their ring
  timeline promoted to ``trace.jsonl`` even with ``RBT_TRACE=0`` — the
  interesting traces survive without paying file I/O for the boring
  ones.
- Incident snapshots (obs/incident.py) embed the ring wholesale.

``RBT_FLIGHT=0`` disables the ring entirely (the disabled path is the
pre-flight-recorder no-op); ``RBT_FLIGHT_RING`` sizes it (default 4096
events).
"""

from __future__ import annotations

import os
import socket
import threading
import time
from collections import deque
from typing import List, Optional

DEFAULT_CAPACITY = 4096


def recording() -> bool:
    """Read the switch per call, like trace_enabled(): tests and
    operators flip RBT_FLIGHT around individual runs. Default ON."""
    return os.environ.get("RBT_FLIGHT", "1") != "0"


def ring_capacity() -> int:
    """Ring size from RBT_FLIGHT_RING (events, default 4096)."""
    try:
        return max(16, int(os.environ.get("RBT_FLIGHT_RING",
                                          str(DEFAULT_CAPACITY))))
    except ValueError:
        return DEFAULT_CAPACITY


# Process identity stamped on /debug/flight responses and trace metadata
# events: which pod/tier a merged timeline's events came from.
_COMPONENT = [os.environ.get("RBT_COMPONENT", "proc")]


def set_component(name: str) -> None:
    """Name this process's tier ("serve", "gateway", "train",
    "controller") for flight/trace identity. Last caller wins — a
    process hosting both a trainer and an engine is still one pod."""
    _COMPONENT[0] = str(name)


def component() -> str:
    return _COMPONENT[0]


def identity() -> dict:
    """Who recorded these events: merged-timeline disambiguation for
    `rbt trace` and the Perfetto process_name metadata."""
    return {"host": socket.gethostname(), "pid": os.getpid(),
            "component": _COMPONENT[0]}


def _matches(event: dict, rid: str) -> bool:
    """Does this event belong to request `rid`? Spans carry either a
    single ``request_id`` or a ``request_ids`` list (batched decode
    chunks); multi-prompt bodies suffix per choice (`<rid>/0`), which a
    query for the base id should still find."""
    args = event.get("args")
    if not isinstance(args, dict):
        return False
    one = args.get("request_id")
    if isinstance(one, str) and (one == rid or one.startswith(rid + "/")):
        return True
    many = args.get("request_ids")
    if isinstance(many, (list, tuple)):
        for x in many:
            if isinstance(x, str) and (x == rid
                                       or x.startswith(rid + "/")):
                return True
    return False


class FlightRecorder:
    """Bounded, lock-guarded ring of recent trace events (dicts in the
    Chrome trace_event shape obs/trace.py builds). Thread-safe: the
    engine worker, HTTP handlers, and checkpoint threads all record
    concurrently; snapshot() is what /debug/flight serializes."""

    def __init__(self, capacity: Optional[int] = None):
        self._lock = threading.Lock()
        cap = capacity if capacity is not None else ring_capacity()
        self._ring: deque = deque(maxlen=cap)  # guarded-by: _lock
        self.recorded = 0                      # guarded-by: _lock
        self.dropped = 0                       # guarded-by: _lock

    def record(self, event: dict) -> None:
        with self._lock:
            if len(self._ring) == self._ring.maxlen:
                self.dropped += 1
            self._ring.append(event)
            self.recorded += 1

    def snapshot(self, request_id: Optional[str] = None,
                 limit: Optional[int] = None) -> List[dict]:
        """Copy of the ring (oldest first), optionally filtered to one
        request id. The copy happens under the lock; filtering does not
        (events are append-only dicts once recorded)."""
        with self._lock:
            events = list(self._ring)
        if request_id:
            events = [e for e in events if _matches(e, request_id)]
        if limit is not None and limit >= 0:
            events = events[-limit:]
        return events

    def stats(self) -> dict:
        with self._lock:
            return {"events": len(self._ring),
                    "capacity": self._ring.maxlen,
                    "recorded": self.recorded,
                    "dropped": self.dropped}

    def resize(self, capacity: int) -> None:
        """Rebuild the ring at a new capacity, keeping the newest
        events (tests; RBT_FLIGHT_RING covers deployments)."""
        with self._lock:
            self._ring = deque(self._ring, maxlen=max(16, int(capacity)))

    def clear(self) -> None:
        with self._lock:
            self._ring.clear()
            self.recorded = 0
            self.dropped = 0


# The process-wide ring obs/trace.py tees into.
RING = FlightRecorder()


# ---------------------------------------------------------------------------
# Tail sampling
# ---------------------------------------------------------------------------

def tail_threshold_ms() -> Optional[float]:
    """RBT_TRACE_TAIL_MS: latency past which a finished request's ring
    timeline is promoted to trace.jsonl even with RBT_TRACE=0. Unset or
    malformed = no latency-based promotion (error/deadline promotion
    stays on whenever the ring records)."""
    raw = os.environ.get("RBT_TRACE_TAIL_MS", "")
    if not raw:
        return None
    try:
        return float(raw)
    except ValueError:
        return None


def _tail_event_cap() -> int:
    """Max events one promotion writes (newest kept). Bounds the file
    I/O a single interesting request can charge the engine thread."""
    try:
        return max(16, int(os.environ.get("RBT_TRACE_TAIL_EVENTS",
                                          "512")))
    except ValueError:
        return 512


class _PromotionBudget:
    """Promotions-per-second limiter for tail sampling. Promotion runs
    ON the engine worker thread between decode chunks; a deadline storm
    (every slot expiring in one pass) or the crash handler dooming a
    whole batch would otherwise write O(slots x ring) JSON lines while
    healthy requests wait. Classification (the counter) is never
    limited — only the file writes are."""

    def __init__(self):
        self._lock = threading.Lock()
        self._window_start = 0.0  # guarded-by: _lock
        self._spent = 0           # guarded-by: _lock

    @staticmethod
    def _per_second() -> int:
        try:
            return max(1, int(os.environ.get("RBT_TRACE_TAIL_PER_S",
                                             "10")))
        except ValueError:
            return 10

    def admit(self) -> bool:
        now = time.monotonic()
        with self._lock:
            if now - self._window_start >= 1.0:
                self._window_start = now
                self._spent = 0
            if self._spent >= self._per_second():
                return False
            self._spent += 1
            return True


_PROMOTIONS = _PromotionBudget()


def tail_sample(request_id: str, duration_s: float, finish_reason: str,
                error: bool = False) -> bool:
    """Terminal hook per request (the engine calls it from
    ``_observe_request_done``; the serve worker's crash handler calls it
    with ``error=True``): promote the request's ring timeline to the
    trace file when the request was *interesting* — errored, finished by
    deadline, or slower than ``RBT_TRACE_TAIL_MS``. With ``RBT_TRACE=1``
    the events are already in the file, so promotion is skipped (only
    the counter records the classification). Returns True when events
    were promoted."""
    if not request_id or not recording():
        return False
    reason = None
    if error:
        reason = "error"
    elif finish_reason == "deadline":
        reason = "deadline"
    else:
        threshold = tail_threshold_ms()
        if threshold is not None and duration_s * 1000.0 >= threshold:
            reason = "slow"
    if reason is None:
        return False
    from runbooks_tpu_torch.obs import metrics as obs_metrics
    from runbooks_tpu_torch.obs import trace as obs_trace

    obs_metrics.REGISTRY.inc(
        "serve_tail_samples_total", reason=reason,
        help_text="Requests whose flight-ring timeline was promoted to "
                  "trace.jsonl (slow/deadline/error tail sampling).")
    if obs_trace.trace_enabled():
        return False  # already on disk via the live tracer
    # Promotion budget BEFORE the ring scan: a storm finishing a whole
    # batch "interesting" at once must not charge the engine thread an
    # O(ring) snapshot+filter per doomed request, let alone the file
    # I/O (each request's filter re-selects the batch's shared decode
    # spans — O(slots x ring) worst case). The classification counter
    # above still recorded; a budget token is occasionally spent on a
    # request whose events already wrapped out (empty snapshot), which
    # is the cheap side of that trade.
    if not _PROMOTIONS.admit():
        return False
    events = RING.snapshot(request_id=request_id)
    if not events:
        return False
    for event in events[-_tail_event_cap():]:
        obs_trace.write_event(event)
    obs_trace.write_event(obs_trace.make_instant(
        "tail_sample", reason=reason, request_id=request_id,
        duration_ms=round(duration_s * 1000.0, 1),
        finish_reason=finish_reason))
    return True
