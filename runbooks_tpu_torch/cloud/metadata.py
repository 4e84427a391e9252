"""The GCE metadata server's client, for the trainer's maintenance poller
(the port's copy of the workload half of ``runbooks_tpu.cloud.metadata``;
the rest of ``cloud/`` is the operator's).

``on_gce`` probes whether the process runs on Google Cloud;
``maintenance_event`` reads ``instance/maintenance-event``, which GCE flips
from NONE to TERMINATE_ON_HOST_MAINTENANCE or MIGRATE_ON_HOST_MAINTENANCE
ahead of host maintenance (and which surfaces upcoming preemptions). The
host is overridable through GCE_METADATA_HOST, the Google client
libraries' escape hatch, which is also how tests point it at a local fake.
Every call is bounded on a worker thread: urlopen's timeout does not bound
the DNS lookup, and an off-GCP box with a slow resolver must not stall.
"""

from __future__ import annotations

import os
import threading
import time
import urllib.error
import urllib.request
from typing import Optional

_FLAVOR = ("Metadata-Flavor", "Google")

# The server answered 404: the attribute does not exist. Distinct from
# None, no host reachable.
_ABSENT = object()


def _hosts() -> list:
    override = os.environ.get("GCE_METADATA_HOST")
    if override:
        return [override]
    # The DNS name and the literal address, like the Go metadata client.
    return ["metadata.google.internal", "169.254.169.254"]


def _base_url(host: str) -> str:
    return f"http://{host}/computeMetadata/v1"


def _bounded(fn, timeout: float):
    """fn's result from a worker thread with a hard deadline (None on
    timeout or a connection error)."""
    result = {}

    def runner():
        try:
            result["v"] = fn()
        except (urllib.error.URLError, OSError, ValueError):
            pass

    t = threading.Thread(target=runner, daemon=True)
    t.start()
    t.join(timeout=timeout)
    return result.get("v")


def _fetch_raw(path: str, timeout: float = 1.0):
    """The value at ``path`` from the first host that answers, each host
    in its own bounded window; _ABSENT on 404, None when no host
    answered."""
    for host in _hosts():
        def one(h=host):
            req = urllib.request.Request(
                f"{_base_url(h)}/{path.lstrip('/')}")
            req.add_header(*_FLAVOR)
            try:
                with urllib.request.urlopen(req, timeout=timeout) as resp:
                    return resp.read().decode().strip()
            except urllib.error.HTTPError as e:
                if e.code == 404:
                    return _ABSENT
                raise

        value = _bounded(one, timeout + 0.5)
        if value is not None:
            return value
    return None


def fetch(path: str, timeout: float = 1.0) -> str:
    """GET a metadata path (e.g. 'project/project-id'); raises OSError
    when no host answers and LookupError when the path is absent."""
    value = _fetch_raw(path, timeout)
    if value is None:
        raise OSError(f"GCE metadata server unreachable fetching {path}")
    if value is _ABSENT:
        raise LookupError(f"GCE metadata attribute absent: {path}")
    return value


def on_gce(timeout: float = 1.0, attempts: int = 3) -> bool:
    """True when a metadata host answers with the Google flavor header,
    trying both hosts ``attempts`` times."""

    def probe_host(host):
        def probe():
            req = urllib.request.Request(_base_url(host) + "/")
            req.add_header(*_FLAVOR)
            with urllib.request.urlopen(req, timeout=timeout) as resp:
                return resp.headers.get("Metadata-Flavor") == "Google"

        return _bounded(probe, timeout + 0.5)

    for attempt in range(attempts):
        for host in _hosts():
            if probe_host(host):
                return True
        if attempt < attempts - 1:
            time.sleep(0.2 * (attempt + 1))
    return False


def maintenance_event(timeout: float = 1.0) -> Optional[str]:
    """The instance's pending maintenance event, or None when nothing is
    pending (or the server is unreachable). The trainer polls it
    (``maintenance_poll_s``) and treats an event like SIGTERM."""
    value = _fetch_raw("instance/maintenance-event", timeout)
    if value is None or value is _ABSENT or value in ("", "NONE"):
        return None
    return str(value)
