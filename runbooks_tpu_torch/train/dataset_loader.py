"""The Dataset loader workload: fetch raw data into the artifact store
(the port of ``runbooks_tpu.train.dataset_loader``).

It runs under the container contract as the Dataset reconciler's
``{name}-data-loader`` Job: ``python -m
runbooks_tpu_torch.train.dataset_loader`` reads

  params.json: {"urls": "https://... , file:///...",   # comma or list
                "paths": ["/some/local.jsonl"],        # mounted files
                "text_key": "text"}                    # jsonl field

and copies each source into ``{artifacts}`` (the Dataset's bucket prefix,
mounted read-write). A training job mounts that prefix read-only at
/content/data and feeds it to ``train.data``'s tokenize -> pack
pipeline, which passes over the ``dataset.json`` manifest written beside
the data: each file's source, name, bytes and rows (jsonl lines that hold
``text_key``; lines of .txt/.json files). The run prints the manifest as
its last line.
"""

from __future__ import annotations

import json
import os
import shutil
import urllib.parse
import urllib.request

from runbooks_tpu_torch.train.data import MANIFEST
from runbooks_tpu_torch.utils import contract


def _sources(params_cfg: dict) -> list:
    urls = params_cfg.get("urls", [])
    if isinstance(urls, str):
        urls = [u.strip() for u in urls.split(",") if u.strip()]
    return list(urls) + list(params_cfg.get("paths", []))


def _fetch(src: str, dest_dir: str) -> str:
    """Download or copy one source into dest_dir; returns the local
    path."""
    name = os.path.basename(urllib.parse.urlparse(src).path) or "data"
    dest = os.path.join(dest_dir, name)
    if src.startswith(("http://", "https://", "file://")):
        with urllib.request.urlopen(src, timeout=120) as resp, \
                open(dest, "wb") as out:
            shutil.copyfileobj(resp, out)
    else:
        shutil.copy(src, dest)
    return dest


def _count_rows(path: str, text_key: str) -> int:
    if not path.endswith((".jsonl", ".json", ".txt")):
        return 0
    rows = 0
    with open(path, "rb") as f:
        for line in f:
            if not path.endswith(".jsonl"):
                rows += 1
                continue
            try:
                doc = json.loads(line)
            except json.JSONDecodeError:
                continue
            if isinstance(doc, dict) and text_key in doc:
                rows += 1
    return rows


def main() -> int:
    params_cfg = contract.load_params()
    artifacts = params_cfg.get("artifacts_dir") or contract.artifacts_dir()
    os.makedirs(artifacts, exist_ok=True)
    text_key = params_cfg.get("text_key", "text")

    sources = _sources(params_cfg)
    if not sources:
        raise SystemExit("dataset_loader: no 'urls' or 'paths' in params")

    files = []
    for src in sources:
        dest = _fetch(src, artifacts)
        files.append({
            "source": src,
            "file": os.path.basename(dest),
            "bytes": os.path.getsize(dest),
            "rows": _count_rows(dest, text_key),
        })

    manifest = {"files": files, "text_key": text_key,
                "total_bytes": sum(f["bytes"] for f in files),
                "total_rows": sum(f["rows"] for f in files)}
    with open(os.path.join(artifacts, MANIFEST), "w") as f:
        json.dump(manifest, f, indent=2)
    print(json.dumps({"done": True, **manifest}), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
