"""On-demand profiler capture with ``torch.profiler`` (the port of
``runbooks_tpu.obs.profile``, which drives ``jax.profiler``).

Two triggers, both writing Chrome traces (Perfetto / chrome://tracing)
under ``{artifacts}/profiles/``:

- Serve API: ``POST /debug/profile?seconds=N`` captures N seconds of live
  traffic (serve/api.py; returns the capture directory).
- Trainer: ``RBT_PROFILE_AT_STEP=n[:k]`` captures k steps (default 1)
  starting at step n, and the job's ``profile_start``/``profile_stop``
  window captures [start, stop).

A capture records the CPU and, when CUDA is initialized, the device
(CUPTI). On a machine where CUPTI yields no device events, a CUDA capture
fails loudly at stop instead of quietly keeping the host's alone.
"""

from __future__ import annotations

import json
import os
import threading
import time
from typing import Optional, Tuple

import torch

TRACE_FILE = "trace.json"


class ProfilerBusy(RuntimeError):
    """A capture is already in flight (one trace at a time per process);
    serve/api.py maps this to HTTP 409."""


class Profiler:
    """Thread-safe single-capture guard over torch.profiler start/stop."""

    def __init__(self):
        self._lock = threading.Lock()
        self._active_dir: Optional[str] = None  # guarded-by: _lock
        self._prof = None                       # guarded-by: _lock
        self._cuda = False                      # guarded-by: _lock

    @property
    def active_dir(self) -> Optional[str]:
        with self._lock:
            return self._active_dir

    def start(self, log_dir: str) -> str:
        from torch.profiler import ProfilerActivity, profile

        with self._lock:
            if self._active_dir is not None:
                raise ProfilerBusy(
                    f"a profile capture is already writing to "
                    f"{self._active_dir}")
            os.makedirs(log_dir, exist_ok=True)
            cuda = torch.cuda.is_available() and torch.cuda.is_initialized()
            activities = [ProfilerActivity.CPU]
            if cuda:
                activities.append(ProfilerActivity.CUDA)
            prof = profile(activities=activities)
            prof.start()
            self._prof, self._cuda = prof, cuda
            self._active_dir = log_dir
        from runbooks_tpu_torch.obs import trace as obs_trace

        obs_trace.instant("profile.start", dir=log_dir)
        return log_dir

    def stop(self) -> Optional[str]:
        """Stop the capture and write ``{dir}/trace.json`` (and the memory
        snapshot beside it). Raises, after releasing the profiler, when a
        CUDA capture recorded no device event."""
        with self._lock:
            if self._active_dir is None:
                return None
            prof, cuda = self._prof, self._cuda
            log_dir, self._active_dir, self._prof = self._active_dir, None, None
            if cuda:
                torch.cuda.synchronize()
            prof.stop()
        from runbooks_tpu_torch.obs import trace as obs_trace

        obs_trace.instant("profile.stop", dir=log_dir)
        path = os.path.join(log_dir, TRACE_FILE)
        prof.export_chrome_trace(path)
        # What was resident while the trace ran travels with the capture.
        try:
            from runbooks_tpu_torch.obs import device as obs_device

            with open(os.path.join(log_dir, "memory.json"), "w") as f:
                json.dump(obs_device.memory_snapshot(), f, indent=2)
        except Exception as exc:  # noqa: BLE001 - the trace still stands
            print(f"profile: memory snapshot failed: {exc!r}", flush=True)
        if cuda and not device_kernels(path):
            raise RuntimeError(
                f"profile capture {log_dir}: CUDA was traced but the trace "
                "holds no device event (CUPTI unavailable?); the host-only "
                "trace is at " + path)
        return log_dir

    def capture(self, log_dir: str, seconds: float) -> str:
        """Blocking timed capture: start, sleep, stop."""
        self.start(log_dir)
        try:
            time.sleep(max(seconds, 0.0))
        finally:
            self.stop()
        return log_dir


PROFILER = Profiler()


def device_kernels(trace_path: str) -> list:
    """Names of the device kernels in an exported Chrome trace (events of
    category ``kernel``), in trace order."""
    with open(trace_path) as f:
        events = json.load(f).get("traceEvents", [])
    return [e.get("name", "") for e in events
            if isinstance(e, dict) and e.get("cat") == "kernel"]


def profiles_dir(artifacts: Optional[str] = None) -> str:
    from runbooks_tpu_torch.utils import contract

    return os.path.join(artifacts or contract.artifacts_dir(), "profiles")


def capture_dir(artifacts: Optional[str] = None,
                tag: Optional[str] = None) -> str:
    """A fresh capture directory: profiles/<utc-stamp>[-tag]."""
    stamp = time.strftime("%Y%m%dT%H%M%SZ", time.gmtime())
    name = f"{stamp}-{tag}" if tag else stamp
    return os.path.join(profiles_dir(artifacts), name)


def parse_profile_at_step(
        spec: Optional[str] = None) -> Optional[Tuple[int, int]]:
    """``RBT_PROFILE_AT_STEP=n[:k]`` -> (start_step, num_steps). k defaults
    to 1. Malformed values raise at parse time (before training state
    exists), like RBT_FAULT_INJECT."""
    if spec is None:
        spec = os.environ.get("RBT_PROFILE_AT_STEP", "")
    if not spec:
        return None
    step, _, count = spec.partition(":")
    try:
        n = int(step)
        k = int(count) if count else 1
    except ValueError:
        raise ValueError(
            f"RBT_PROFILE_AT_STEP={spec!r}: expected n or n:k "
            "(capture k steps starting at step n)") from None
    if n < 0 or k < 1:
        raise ValueError(
            f"RBT_PROFILE_AT_STEP={spec!r}: step must be >= 0, count >= 1")
    return n, k
