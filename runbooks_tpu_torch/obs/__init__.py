"""Observability planes of the port (the counterpart of
``runbooks_tpu.obs``).

- ``obs.metrics``  — process-wide Prometheus registry with the reference's
  exposition byte for byte.
- ``obs.trace``    — RBT_TRACE=1 Chrome-trace spans in ``trace.jsonl``,
  and the request scope (X-Request-Id, W3C traceparent).
- ``obs.flight``   — the always-on ring of recent events, tail sampling.
- ``obs.goodput``  — productive step time over wall clock, restart-aware.
- ``obs.incident`` — debounced incident bundles under
  ``{artifacts}/incidents/``.
- ``obs.device``   — the kernel-build sentinel, the program census with
  first-dispatch FLOPs and bytes, device memory accounting.
- ``obs.profile``  — on-demand ``torch.profiler`` captures.
- ``obs.history``  — bounded fleet time-series rings, windowed quantiles
  and increases, JSON snapshots; ``serve_metrics(..., history=)`` serves
  them at ``GET /metrics/history``.
"""

from runbooks_tpu_torch.obs.metrics import (  # noqa: F401
    CONTENT_TYPE,
    REGISTRY,
    Registry,
    serve_metrics,
)
from runbooks_tpu_torch.obs.trace import span, trace_enabled  # noqa: F401
from runbooks_tpu_torch.obs.goodput import GoodputTracker  # noqa: F401
