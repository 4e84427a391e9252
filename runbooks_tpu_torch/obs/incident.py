"""Incident snapshots: the system captures its own evidence (the port's
copy of ``runbooks_tpu.obs.incident``; the memory and program census come
from the port's obs/device.py).

When ``SLOViolated`` fires, the engine crash handler dooms in-flight
requests, or the trainer aborts on ``max_bad_steps``, the state an
operator needs (``/debug/memory``, ``/debug/programs``, the recent span
timeline, queue depths, the metrics exposition) is gone before anyone
can curl it. :func:`capture` bundles all of it — the flight ring
(obs/flight.py), the full Prometheus exposition, the device memory /
live-array census, the compiled-program census, and the
unexpected-compile ring — into one timestamped JSON file under
``{artifacts}/incidents/``, written atomically (temp + ``os.replace``)
so a reader can never observe a torn bundle.

Captures are **debounced** (per-reason, ``RBT_INCIDENT_DEBOUNCE_S``,
default 60 s) and **rate-limited** (a global floor between any two
bundles) because the failure modes that fire them come in storms — a
crash-looping engine must leave one bundle per storm, not a bundle per
loop. Old bundles are pruned past ``RBT_INCIDENT_KEEP`` (default 20).

Fired automatically by the serve worker's crash handler, the trainer's
``max_bad_steps`` abort, and — via ``POST /debug/incident`` against
each replica — by the controller on an ``SLOViolated`` onset
(controller/server.py). ``rbt incidents`` lists and fetches bundles;
the Server's ``.status.lastIncident`` points at the latest one.

capture() must never raise: it runs inside crash handlers, so every
sub-collection degrades to an error note instead of propagating.
"""

from __future__ import annotations

import json
import os
import threading
import time
from typing import Any, Dict, List, Optional

from runbooks_tpu_torch.obs import flight
from runbooks_tpu_torch.obs import metrics as obs_metrics

DEFAULT_DEBOUNCE_S = 60.0
# Global floor between any two bundles, whatever their reasons: a storm
# that rotates reasons must still not write faster than this.
MIN_INTERVAL_S = 5.0
DEFAULT_KEEP = 20

# Filename-safe reason slug (reasons flow in from HTTP bodies).
_SLUG_UNSAFE = str.maketrans(
    {c: "-" for c in "/\\ \t\n\r:\"'<>|?*"})


def _debounce_s() -> float:
    try:
        return float(os.environ.get("RBT_INCIDENT_DEBOUNCE_S",
                                    str(DEFAULT_DEBOUNCE_S)))
    except ValueError:
        return DEFAULT_DEBOUNCE_S


def _keep() -> int:
    try:
        return max(1, int(os.environ.get("RBT_INCIDENT_KEEP",
                                         str(DEFAULT_KEEP))))
    except ValueError:
        return DEFAULT_KEEP


def incidents_dir(artifacts: Optional[str] = None) -> str:
    from runbooks_tpu_torch.utils import contract

    base = artifacts if artifacts is not None else contract.artifacts_dir()
    return os.path.join(base, "incidents")


class IncidentManager:
    """Debounce/rate-limit book + the capture implementation. One
    process-wide instance (:data:`MANAGER`); tests reset() it."""

    def __init__(self):
        self._lock = threading.Lock()
        self._last_by_reason: Dict[str, float] = {}  # guarded-by: _lock
        self._last_any: float = 0.0                  # guarded-by: _lock
        self._last_path: Optional[str] = None        # guarded-by: _lock
        self._last_wall: Optional[float] = None      # guarded-by: _lock

    def reset(self) -> None:
        with self._lock:
            self._last_by_reason.clear()
            self._last_any = 0.0
            self._last_path = None
            self._last_wall = None

    def last_age(self) -> Optional[float]:
        """Seconds since this process's last captured bundle, or None —
        the serve_incident_age_seconds gauge (and `rbt top`'s lastinc
        cell) read it at scrape time."""
        with self._lock:
            if self._last_wall is None:
                return None
            return max(0.0, time.time() - self._last_wall)

    def last_path(self) -> Optional[str]:
        with self._lock:
            return self._last_path

    def _admit(self, reason: str) -> bool:
        """One debounce/rate-limit decision, atomically: a storm of
        concurrent captures (crash handler + HTTP + controller POST)
        must elect exactly one writer."""
        now = time.monotonic()
        debounce = _debounce_s()
        with self._lock:
            last = self._last_by_reason.get(reason)
            if last is not None and now - last < debounce:
                return False
            if self._last_any and now - self._last_any < MIN_INTERVAL_S:
                # Cross-reason storm floor, applied to EVERY reason: a
                # storm that rotates reasons (flapping SLO objectives)
                # must not write faster than this even once each
                # per-reason debounce window expires.
                return False
            self._last_by_reason[reason] = now
            self._last_any = now
            return True

    def capture(self, reason: str, *,
                artifacts: Optional[str] = None,
                component: Optional[str] = None,
                memory_groups: Optional[dict] = None,
                extra: Optional[Dict[str, Any]] = None,
                registry: Optional[obs_metrics.Registry] = None,
                ) -> Optional[str]:
        """Write one incident bundle; returns its path, or None when the
        capture was debounced/rate-limited. Never raises."""
        reason = (str(reason) or "unknown").translate(_SLUG_UNSAFE)[:64]
        if not self._admit(reason):
            return None
        try:
            return self._capture_admitted(reason, artifacts, component,
                                          memory_groups, extra, registry)
        except Exception as exc:  # noqa: BLE001 — runs in crash handlers
            print(f"incident: capture({reason}) failed: {exc!r}",
                  flush=True)
            return None

    def _capture_admitted(self, reason, artifacts, component,
                          memory_groups, extra, registry) -> Optional[str]:
        from runbooks_tpu_torch.obs import device as obs_device

        reg = registry if registry is not None else obs_metrics.REGISTRY
        # Count BEFORE rendering the exposition below, so the bundle's
        # own metrics snapshot already carries this capture (and counts
        # admitted attempts even if a later section fails).
        reg.inc("serve_incidents_total", reason=reason,
                help_text="Incident bundles captured, by trigger reason.")
        wall = time.time()
        bundle: Dict[str, Any] = {
            "reason": reason,
            "time": time.strftime("%Y-%m-%dT%H:%M:%SZ",
                                  time.gmtime(wall)),
            "unix_time": round(wall, 3),
            **flight.identity(),
        }
        if component:
            bundle["component"] = component
        if extra:
            bundle["extra"] = extra
        # Every section degrades independently: a half-broken process is
        # exactly when a bundle is most needed.
        try:
            bundle["flight"] = {"stats": flight.RING.stats(),
                                "events": flight.RING.snapshot()}
        except Exception as exc:  # noqa: BLE001
            bundle["flight"] = {"error": repr(exc)}
        try:
            bundle["metrics"] = reg.render()
        except Exception as exc:  # noqa: BLE001
            bundle["metrics"] = f"render failed: {exc!r}"
        try:
            bundle["memory"] = obs_device.memory_snapshot(memory_groups)
        except Exception as exc:  # noqa: BLE001
            bundle["memory"] = {"error": repr(exc)}
        try:
            bundle["programs"] = obs_device.PROGRAMS.census()
        except Exception as exc:  # noqa: BLE001
            bundle["programs"] = [{"error": repr(exc)}]
        sentinel = obs_device.SENTINEL
        try:
            bundle["compiles"] = {
                "total": sentinel.total,
                "unexpected": sentinel.unexpected,
                "compile_seconds": round(sentinel.compile_seconds, 3),
                "steady": sentinel.steady_components(),
                "last_unexpected": sentinel.recent_unexpected(),
            }
        except Exception as exc:  # noqa: BLE001
            bundle["compiles"] = {"error": repr(exc)}

        out_dir = incidents_dir(artifacts)
        stamp = time.strftime("%Y%m%dT%H%M%SZ", time.gmtime(wall))
        name = f"{stamp}-{reason}.json"
        path = os.path.join(out_dir, name)
        os.makedirs(out_dir, exist_ok=True)
        tmp = path + ".tmp"
        with open(tmp, "w") as f:
            json.dump(bundle, f, indent=1, default=str)
        os.replace(tmp, path)
        with self._lock:
            self._last_path = path
            self._last_wall = wall
        print(f"incident: captured {reason} -> {path}", flush=True)
        self._prune(out_dir)
        return path

    @staticmethod
    def _prune(out_dir: str) -> None:
        try:
            names = sorted(n for n in os.listdir(out_dir)
                           if n.endswith(".json"))
            for doomed in names[:-_keep()] if len(names) > _keep() else []:
                os.remove(os.path.join(out_dir, doomed))
        except OSError:
            pass  # pruning is hygiene, never worth failing a capture


MANAGER = IncidentManager()


def capture(reason: str, **kwargs) -> Optional[str]:
    """Module-level convenience over :data:`MANAGER`."""
    return MANAGER.capture(reason, **kwargs)


def list_incidents(artifacts: Optional[str] = None) -> List[dict]:
    """Bundle metadata (name/reason/time/size), newest first — what
    ``GET /debug/incidents`` and ``rbt incidents`` render."""
    out_dir = incidents_dir(artifacts)
    out: List[dict] = []
    try:
        names = sorted(os.listdir(out_dir), reverse=True)
    except OSError:
        return out
    for name in names:
        if not name.endswith(".json"):
            continue
        path = os.path.join(out_dir, name)
        entry = {"name": name, "path": path}
        try:
            entry["size_bytes"] = os.path.getsize(path)
        except OSError:
            continue
        stem = name[:-len(".json")]
        stamp, _, reason = stem.partition("-")
        entry["reason"] = reason or "unknown"
        entry["time"] = stamp
        out.append(entry)
    return out


def read_incident(name: str,
                  artifacts: Optional[str] = None) -> Optional[dict]:
    """Load one bundle by its listing name. The name is validated
    against the directory listing (no path traversal from HTTP input)."""
    for entry in list_incidents(artifacts):
        if entry["name"] == name:
            try:
                with open(entry["path"]) as f:
                    return json.load(f)
            except (OSError, json.JSONDecodeError):
                return None
    return None
