"""Lightweight JSONL trace spans (Chrome ``trace_event`` compatible; the
port's copy of ``runbooks_tpu.obs.trace``: the same events, names and
file format).

``RBT_TRACE=1`` turns FILE emission on; independent of that switch,
every event built here also tees into the in-memory flight-recorder
ring (obs/flight.py, always on unless ``RBT_FLIGHT=0``) so the recent
timeline survives for ``/debug/flight``, tail sampling, and incident
bundles. With both switches off a span is a near-zero-cost no-op (one
env lookup + one shared null context manager per span, so the
instrumented hot loops — trainer steps, engine ticks — pay
nothing when recording is off).

File format: the Chrome/Perfetto "JSON Array Format" with one event per
line — an opening ``[`` line, then ``{...},`` per event. The spec allows
the closing ``]`` to be omitted, so the file is loadable in Perfetto /
chrome://tracing at any moment (including mid-run or after a crash), and
each line (minus the trailing comma) is a complete JSON object — greppable
and streamable like any JSONL log.

Multi-pod merges: events carry a *trace pid* derived from host+pid (not
the bare OS pid), so concatenating trace files from a gateway and N
replica pods cannot collide two processes onto one Perfetto track; each
file generation opens with ``process_name``/``thread_name`` metadata
events (``ph: "M"``) naming the component, host, and real pid.

Default output: ``{artifacts}/trace.jsonl`` (the container contract's
durable mount); ``configure(path)`` repoints it (the trainer does, per
run). Writes are lock-serialized line appends, so concurrent spans from
the engine worker, HTTP handlers and the trainer interleave without
tearing.

Rotation: a long-running traced server would otherwise grow the file
without bound. When the file exceeds ``RBT_TRACE_MAX_MB`` (default 256)
it rolls to ``<path>.1`` (one generation kept, the previous ``.1``
replaced) and a fresh file starts with its own ``[`` header — both
generations stay independently Perfetto-loadable and line-parseable.
"""

from __future__ import annotations

import hashlib
import json
import os
import re
import socket
import threading
import time
import uuid
from typing import Optional, Tuple

from runbooks_tpu_torch.obs import flight


def trace_enabled() -> bool:
    """Read the switch per call (not cached at import): tests and operators
    flip RBT_TRACE around individual runs."""
    return os.environ.get("RBT_TRACE", "") == "1"


def record_enabled() -> bool:
    """True when span events go ANYWHERE (trace file or flight ring) —
    the gate hot paths use before materializing span attributes
    (request-id lists etc.)."""
    return trace_enabled() or flight.recording()


class _NullSpan:
    """Shared no-op context manager for the disabled path."""

    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


_NULL = _NullSpan()


# -- trace pid (multi-pod merge safety) -------------------------------------

_TRACE_PID: Optional[Tuple[int, int]] = None  # (os pid, derived trace pid)


def trace_pid() -> int:
    """A stable 31-bit pid derived from host+pid: unique enough that
    merged traces from many pods don't collapse processes onto one
    Perfetto track (two hosts routinely share os pids like 1). Fork-safe
    (re-derived when os.getpid() changes)."""
    global _TRACE_PID
    pid = os.getpid()
    if _TRACE_PID is None or _TRACE_PID[0] != pid:
        digest = hashlib.sha1(
            f"{socket.gethostname()}:{pid}".encode()).digest()
        _TRACE_PID = (pid,
                      (int.from_bytes(digest[:4], "big") & 0x7FFFFFFF) or 1)
    return _TRACE_PID[1]


def _tid() -> int:
    return threading.get_ident() & 0x7FFFFFFF


def _max_trace_bytes() -> int:
    """Rotation threshold from RBT_TRACE_MAX_MB (default 256; fractional
    values allowed — tests rotate at a few hundred bytes). Read per open,
    not per write."""
    try:
        return int(float(os.environ.get("RBT_TRACE_MAX_MB", "256")) * 2**20)
    except ValueError:
        return 256 * 2**20


class _Writer:
    def __init__(self):
        self._lock = threading.Lock()
        self._path: Optional[str] = None   # guarded-by: _lock
        self._file = None                  # guarded-by: _lock
        self._bytes = 0                    # guarded-by: _lock
        self._max_bytes = 0                # guarded-by: _lock
        self._meta_tids: set = set()       # guarded-by: _lock

    def configure(self, path: Optional[str]) -> None:
        with self._lock:
            if self._file is not None and path != self._path:
                try:
                    self._file.close()
                except OSError:
                    pass
                self._file = None
            self._path = path

    def path(self) -> Optional[str]:
        with self._lock:
            if self._path is not None:
                return self._path
        from runbooks_tpu_torch.utils import contract

        return os.path.join(contract.artifacts_dir(), "trace.jsonl")

    def _write_line_locked(self, obj: dict) -> None:  # guarded-by: _lock
        line = json.dumps(obj, separators=(",", ":"))
        self._file.write(line + ",\n")
        self._bytes += len(line) + 2

    def _write_meta_locked(self, tid: Optional[int]) -> None:  # guarded-by: _lock
        """Perfetto metadata for this file generation: one process_name
        naming component@host + the real pid, then one thread_name per
        tid seen — merged multi-pod traces stay attributable even though
        events carry the derived trace pid."""
        ident = flight.identity()
        ts = round(time.time() * 1e6, 1)  # tolerated on M events; keeps
        # every line uniform for line-oriented consumers
        if not self._meta_tids:
            self._write_line_locked({
                "name": "process_name", "ph": "M", "ts": ts,
                "pid": trace_pid(), "tid": 0,
                "args": {"name": f"{ident['component']}@{ident['host']} "
                                 f"pid={ident['pid']}"}})
            self._meta_tids.add(0)
        if tid is not None and tid not in self._meta_tids:
            self._write_line_locked({
                "name": "thread_name", "ph": "M", "ts": ts,
                "pid": trace_pid(), "tid": tid,
                "args": {"name": f"{ident['component']}-{tid}"}})
            self._meta_tids.add(tid)

    def write(self, event: dict) -> None:
        with self._lock:
            if self._file is None:
                path = self._path
                if path is None:
                    from runbooks_tpu_torch.utils import contract

                    path = os.path.join(contract.artifacts_dir(),
                                        "trace.jsonl")
                    self._path = path
                try:
                    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
                    size = (os.path.getsize(path)
                            if os.path.exists(path) else 0)
                    self._file = open(path, "a", buffering=1)
                    if size == 0:
                        self._file.write("[\n")
                        size = 2
                    self._bytes = size
                    self._max_bytes = _max_trace_bytes()
                    self._meta_tids = set()
                except OSError:
                    # Tracing must never take down the workload: an
                    # unwritable path drops this event. The CONFIGURED
                    # path is kept (resetting it would silently reroute
                    # the rest of the run's spans to the contract-default
                    # location); the next write retries the open — e.g. a
                    # not-yet-mounted artifacts volume heals in place.
                    return
            try:
                self._write_meta_locked(event.get("tid"))
                self._write_line_locked(event)
                if self._bytes >= self._max_bytes:
                    self._rotate_locked()
            except OSError:
                pass

    def _rotate_locked(self) -> None:  # guarded-by: _lock
        """Size cap hit: roll the live file to <path>.1 (replacing the
        previous generation) and start fresh. Caller holds the lock; the
        open failure mode matches write() — drop and retry later."""
        path = self._path
        try:
            self._file.close()
        except OSError:
            pass
        self._file = None
        if path is None:
            return
        try:
            os.replace(path, path + ".1")
            self._file = open(path, "a", buffering=1)
            self._file.write("[\n")
            self._bytes = 2
            self._meta_tids = set()
        except OSError:
            self._file = None

    def close(self) -> None:
        with self._lock:
            if self._file is not None:
                try:
                    self._file.close()
                except OSError:
                    pass
                self._file = None


_WRITER = _Writer()


def configure(path: Optional[str]) -> None:
    """Repoint trace output (e.g. the trainer sets
    ``{artifacts}/trace.jsonl`` for its run). None reverts to the
    contract default."""
    _WRITER.configure(path)


def close() -> None:
    """Flush and close the trace file (end of a run; the next span
    reopens in append mode)."""
    _WRITER.close()


def write_event(event: dict) -> None:
    """Write one already-built event to the trace file REGARDLESS of
    RBT_TRACE — the tail-sampling promotion path (obs/flight.py) uses it
    to land an interesting request's ring timeline on disk."""
    _WRITER.write(event)


def _emit(event: dict) -> None:
    """Route one event: the trace file when file tracing is on, the
    flight ring whenever the recorder is."""
    if trace_enabled():
        _WRITER.write(event)
    if flight.recording():
        flight.RING.record(event)


class _Span:
    """One complete event (``ph: "X"``): records wall-clock start and
    monotonic duration, emitted at exit."""

    __slots__ = ("name", "args", "_ts", "_t0")

    def __init__(self, name: str, args: dict):
        self.name = name
        self.args = args

    def __enter__(self):
        self._ts = time.time() * 1e6          # trace_event ts is in µs
        self._t0 = time.perf_counter()
        return self

    def __exit__(self, exc_type, exc, tb):
        dur = (time.perf_counter() - self._t0) * 1e6
        event = {
            "name": self.name,
            "ph": "X",
            "ts": round(self._ts, 1),
            "dur": round(dur, 1),
            "pid": trace_pid(),
            "tid": _tid(),
        }
        if self.args:
            event["args"] = self.args
        if exc_type is not None:
            event.setdefault("args", {})["error"] = exc_type.__name__
        _emit(event)
        return False


def span(name: str, /, **args):
    """Context manager tracing one phase: ``with span("prefill",
    bucket=128): ...``. Emits a Chrome complete event to the trace file
    (RBT_TRACE=1) and/or the flight ring (RBT_FLIGHT, default on);
    otherwise returns a shared no-op (no allocation beyond the env
    reads). ``name`` is positional-only so span attributes may freely use
    "name" as a key (e.g. reconcile spans labeling the object name)."""
    if not record_enabled():
        return _NULL
    return _Span(name, args)


def complete(name: str, duration_s: float, /, **args) -> None:
    """Emit a completed span for an interval measured elsewhere, ending
    now (``ph: "X"`` with ts backdated by the duration). Used for
    request-scoped phases whose start predates the code that knows their
    name — e.g. a request's queue wait, measured by the engine at
    admission time."""
    if not record_enabled():
        return
    dur = max(float(duration_s), 0.0) * 1e6
    event = {
        "name": name,
        "ph": "X",
        "ts": round(time.time() * 1e6 - dur, 1),
        "dur": round(dur, 1),
        "pid": trace_pid(),
        "tid": _tid(),
    }
    if args:
        event["args"] = args
    _emit(event)


def make_instant(name: str, /, **args) -> dict:
    """Build (without emitting) an instant event — the tail-sampling
    promoter appends one as the promotion marker."""
    event = {
        "name": name,
        "ph": "i",
        "s": "p",
        "ts": round(time.time() * 1e6, 1),
        "pid": trace_pid(),
        "tid": _tid(),
    }
    if args:
        event["args"] = args
    return event


def instant(name: str, /, **args) -> None:
    """Point-in-time marker (``ph: "i"``): checkpoint landed, preemption
    signal caught, profile started."""
    if not record_enabled():
        return
    _emit(make_instant(name, **args))


# ---------------------------------------------------------------------------
# Request scope (the serve API's; it lives here beside the spans that
# carry the request id).
# ---------------------------------------------------------------------------

# W3C trace context (https://www.w3.org/TR/trace-context/):
# version-traceid-parentid-flags, all lowercase hex.
_TRACEPARENT_RE = re.compile(
    r"^([0-9a-f]{2})-([0-9a-f]{32})-([0-9a-f]{16})-([0-9a-f]{2})$")
# Client-supplied ids flow into response headers, logs, and trace JSON:
# strip anything that could split a header or forge a log line.
_RID_UNSAFE_RE = re.compile(r"[^A-Za-z0-9._:/-]")


def request_scope(headers) -> Tuple[str, Optional[str]]:
    """(request_id, traceparent_out) for one HTTP request.

    X-Request-Id is accepted verbatim (sanitized); a W3C ``traceparent``
    is also honored — its trace-id becomes the request id when no
    explicit one came, and the response carries a child ``traceparent``
    (same trace-id, fresh parent-id) so an upstream tracer can stitch
    the hop. With neither header, an id is generated. The id rides the
    queue/prefill/decode trace spans (obs/trace.py) and the access log,
    so one Perfetto trace follows one request across the engine — and,
    through the gateway's forwarded headers, across pods."""
    rid = headers.get("X-Request-Id") if headers else None
    tp_out = None
    tp = (headers.get("traceparent", "") if headers else "").strip().lower()
    m = _TRACEPARENT_RE.match(tp)
    if m:
        tp_out = (f"{m.group(1)}-{m.group(2)}-"
                  f"{uuid.uuid4().hex[:16]}-{m.group(4)}")
        if not rid:
            rid = m.group(2)
    if rid:
        rid = _RID_UNSAFE_RE.sub("", str(rid))[:128]
    if not rid:
        rid = f"req-{uuid.uuid4().hex[:16]}"
    return rid, tp_out


def mint_traceparent() -> str:
    """A fresh root W3C traceparent (sampled flag set) — the gateway
    mints one when the client supplied none, so every upstream hop
    carries a stitchable trace context."""
    return f"00-{uuid.uuid4().hex}-{uuid.uuid4().hex[:16]}-01"
