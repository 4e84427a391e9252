"""Checkpoint and resume on the container contract's artifact layout (the
port of ``runbooks_tpu.train.checkpoint.CheckpointManager``).

Same layout: ``{artifacts}/checkpoints/{step}/``, an integrity marker
``rbt-intact.json`` written once the step's save has landed and carrying
the data cursor, the newest ``max_to_keep`` steps kept, and restore of the
newest *intact* step (a step directory without its marker is a save that
was cut off, and is skipped). The state is one ``torch.save`` file per
step, written to a temp file and moved into place, so a reader never sees
a torn file. It does not read the reference's orbax checkpoints:
``tools/orbax_to_torch.py``, run where orbax is installed, turns an orbax
step into this layout (``ORBAX_CONVERTER``), and a restore that meets an
orbax step raises naming it.
"""

from __future__ import annotations

import json
import os
import shutil
from typing import Any, Callable, Optional, Tuple

import torch

from runbooks_tpu_torch.ops.quantization import unpack_from_checkpoint
from runbooks_tpu_torch.utils.tree import tree_map

STATE_FILE = "state.pt"
# The converter of the reference's orbax steps (outside this package).
ORBAX_CONVERTER = "tools/orbax_to_torch.py"


def _orbax_step(step_dir: str) -> bool:
    """Does ``step_dir`` hold an orbax save (its metadata file or item
    directory) and no state of this port?"""
    return (not os.path.exists(os.path.join(step_dir, STATE_FILE))
            and (os.path.exists(os.path.join(step_dir,
                                             "_CHECKPOINT_METADATA"))
                 or os.path.isdir(os.path.join(step_dir, "default"))))


class CheckpointManager:
    MARKER = "rbt-intact.json"

    def __init__(self, artifacts_dir: str, max_to_keep: int = 3):
        self.directory = os.path.join(os.path.abspath(artifacts_dir),
                                      "checkpoints")
        os.makedirs(self.directory, exist_ok=True)
        self.max_to_keep = max_to_keep

    def _step_dir(self, step: int) -> str:
        return os.path.join(self.directory, str(int(step)))

    def _marker_path(self, step: int) -> str:
        return os.path.join(self._step_dir(step), self.MARKER)

    def all_steps(self) -> list:
        try:
            names = os.listdir(self.directory)
        except OSError:
            return []
        return sorted(int(n) for n in names if n.isdigit())

    def intact_steps(self) -> list:
        """Ascending steps whose save completed (marker present)."""
        return [s for s in self.all_steps()
                if os.path.exists(self._marker_path(s))]

    def latest_intact_step(self) -> Optional[int]:
        steps = self.intact_steps()
        return steps[-1] if steps else None

    def read_cursor(self, step: int) -> dict:
        """The data cursor saved with ``step`` ({} when unreadable)."""
        try:
            with open(self._marker_path(step)) as f:
                return dict(json.load(f).get("cursor") or {})
        except (OSError, ValueError):
            return {}

    def save(self, step: int, state: Any, force: bool = False,
             cursor: Optional[dict] = None) -> bool:
        """Save ``state`` (nested dicts, lists, tensors and numbers) at
        ``step`` with its data cursor. An intact step is not overwritten
        unless ``force``. Returns whether it saved."""
        step = int(step)
        if not force and os.path.exists(self._marker_path(step)):
            return False
        step_dir = self._step_dir(step)
        if os.path.exists(self._marker_path(step)):
            os.remove(self._marker_path(step))
        os.makedirs(step_dir, exist_ok=True)
        path = os.path.join(step_dir, STATE_FILE)
        torch.save(state, path + ".tmp")
        os.replace(path + ".tmp", path)
        tmp = self._marker_path(step) + ".tmp"
        with open(tmp, "w") as f:
            json.dump({"step": step, "cursor": dict(cursor or {})}, f)
        os.replace(tmp, self._marker_path(step))
        for old in self.all_steps()[:-self.max_to_keep]:
            shutil.rmtree(self._step_dir(old), ignore_errors=True)
        return True

    def restore_with_cursor(self, step: Optional[int] = None,
                            device: Optional[torch.device] = None,
                            mmap: bool = False) -> Tuple[Any, dict, int]:
        """(state, cursor, step) of ``step``, or of the newest intact step
        that loads, falling back to older intact steps. ``mmap`` maps the
        file on the host instead of reading it (``device`` must then be
        the CPU), so leaves the caller never touches cost no memory."""
        candidates = ([int(step)] if step is not None
                      else sorted(self.intact_steps(), reverse=True))
        if not candidates:
            raise FileNotFoundError(
                f"no intact checkpoint under {self.directory}")
        skipped = [s for s in self.all_steps() if s > candidates[0]]
        if skipped:
            print(f"checkpoint: ignoring partial step dir(s) {skipped} (no "
                  f"integrity marker); restoring step {candidates[0]}",
                  flush=True)
        last_exc: Optional[Exception] = None
        for s in candidates:
            if _orbax_step(self._step_dir(s)):
                raise RuntimeError(
                    f"{self._step_dir(s)} is an orbax step of the reference "
                    f"(runbooks_tpu); convert it with {ORBAX_CONVERTER} "
                    "where orbax is installed")
            path = os.path.join(self._step_dir(s), STATE_FILE)
            try:
                state = torch.load(path, map_location=device,
                                   weights_only=True, mmap=mmap)
            except Exception as exc:  # noqa: BLE001 - corrupt step
                print(f"checkpoint: step {s} failed to restore ({exc!r}); "
                      "trying the previous one", flush=True)
                last_exc = exc
                continue
            return state, self.read_cursor(s), s
        raise RuntimeError(f"no checkpoint under {self.directory} could be "
                           f"restored (tried {candidates})") from last_exc


def restore_params(directory: str, device: torch.device,
                   cut: Optional[Callable[[Any], Any]] = None
                   ) -> Optional[Tuple[Any, int]]:
    """(params, step) of the newest intact step under
    ``{directory}/checkpoints`` with its params on ``device``, or None when
    that directory is missing or empty (nothing to load). Only the params
    are read: the file is mapped, so a full fine-tune's optimizer state
    never reaches host or device memory. A loader-quantized tree (packed
    leaves under ops/quantization's marker) comes back with its
    QuantizedArray leaves. ``cut`` takes the mapped tree first (a check,
    or a tensor-parallel rank's parallel/sharding.shard_params: only the
    shard's columns are then read and copied).

    A ``checkpoints/`` that holds anything else this port cannot read (the
    reference's orbax steps, which ORBAX_CONVERTER converts; saves that
    were cut off; a state without params) raises: serving random weights
    behind a healthy server in its place would be silent garbage."""
    ckpt_dir = os.path.join(directory, "checkpoints")
    if not os.path.isdir(ckpt_dir) or not os.listdir(ckpt_dir):
        return None
    mgr = CheckpointManager(directory)
    if mgr.latest_intact_step() is None:
        raise RuntimeError(
            f"{ckpt_dir} holds {sorted(os.listdir(ckpt_dir))[:8]} but no "
            f"intact step in this port's layout (<step>/{STATE_FILE} with "
            f"{CheckpointManager.MARKER}); the reference's orbax steps "
            f"convert with {ORBAX_CONVERTER} where orbax is installed")
    state, _, step = mgr.restore_with_cursor(device=torch.device("cpu"),
                                             mmap=True)
    params = state.get("params") if isinstance(state, dict) else None
    if not isinstance(params, dict):
        raise RuntimeError(f"checkpoint step {step} under {ckpt_dir} holds "
                           "no params tree")
    params = unpack_from_checkpoint(params)
    if cut is not None:
        params = cut(params)
    return tree_map(lambda t: t.to(device, copy=True), params), step
