"""Container contract: the filesystem and environment interface between
the operator and a workload (the port's copy of
``runbooks_tpu.utils.contract``).

  /content/params.json   run parameters
  /content/data          dataset mount (read-only)
  /content/model         base or saved model mount (read-only)
  /content/artifacts     output mount (read-write, durable)
  ports: 8080 (serve), 8888 (notebook)

plus the PARAM_{NAME} environment convention. ``RBT_CONTENT_DIR`` moves
/content, as in the reference.
"""

from __future__ import annotations

import json
import os
from typing import Any, Dict, Optional

SERVE_PORT = 8080
NOTEBOOK_PORT = 8888

# The trainer's exit code after a SIGTERM/SIGINT stop with an emergency
# checkpoint: the controller's Job policy restarts on it and fails the Job
# on any other non-zero exit.
EXIT_PREEMPTED = 42


def content_dir() -> str:
    return os.environ.get("RBT_CONTENT_DIR", "/content")


def content_path(*parts: str) -> str:
    return os.path.join(content_dir(), *parts)


def data_dir() -> str:
    return content_path("data")


def model_dir() -> str:
    return content_path("model")


def artifacts_dir() -> str:
    return content_path("artifacts")


def load_params(path: Optional[str] = None) -> Dict[str, Any]:
    """params.json (if present) merged with PARAM_* environment variables
    (the environment wins). PARAM_FOO_BAR=x is key "foo_bar"; values parse
    as JSON when they can, else stay strings."""
    params: Dict[str, Any] = {}
    path = path or content_path("params.json")
    if os.path.exists(path):
        with open(path) as f:
            params.update(json.load(f))
    for key, val in os.environ.items():
        if not key.startswith("PARAM_"):
            continue
        name = key[len("PARAM_"):].lower()
        try:
            params[name] = json.loads(val)
        except (json.JSONDecodeError, ValueError):
            params[name] = val
    return params
