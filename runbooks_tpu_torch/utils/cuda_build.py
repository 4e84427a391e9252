"""Build the port's CUDA sources at first use and load them with ctypes.

Each ``csrc/<name>.cu`` has a plain C interface and is compiled by hand
with ``nvcc`` for Hopper (``sm_90a``) into the kernel directory:
``build/kernels/`` at the root of the checkout (listed in ``.gitignore``)
for library callers, and for the trainer's and the server's entry points
``<artifacts>/kernel_cache`` on the durable artifacts mount
(``use_kernel_cache``), so that a restarted container loads its kernels
instead of running ``nvcc`` again (the twin of the reference's JAX
compilation cache in ``<artifacts>/jax_cache``). RBT_KERNEL_CACHE names
another directory, and ``0`` or ``off`` keeps the checkout's. The
library's file name carries
a hash of the source, the shared headers (``csrc/*.cuh``) and the flags,
so an edited source or header is never served from a stale build; the
compiler's report (``-Xptxas -v``: registers, shared memory, spills) is
kept beside it as ``.log``. Both are written under a per-process temp
name and moved into place, so processes sharing a directory never load a
half-written library. Sources build in parallel: one ``nvcc`` per source,
all started together. A failed build raises with the compiler's output.
Each nvcc run is reported, with its seconds, to the build sentinel
(obs/device.SENTINEL): after warmup a build is a stall it flags.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path
from typing import Dict, Iterable, Optional

from runbooks_tpu_torch.obs.device import SENTINEL

CSRC = Path(__file__).resolve().parents[1] / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "kernels"
# Every source of the port's kernels (K1; K2 and K3).
SOURCES = ("flash_fwd", "flash_bwd")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

# Libraries loaded by this process, by source name.
_loaded: Dict[str, ctypes.CDLL] = {}
# The directory builds go to and load from (use_kernel_cache moves it).
_build_dir = BUILD_DIR
# nvcc processes this process started, and the seconds its builds took.
stats = {"nvcc_runs": 0, "nvcc_s": 0.0}


def kernel_cache_dir(artifacts_dir: str) -> Path:
    """The kernel directory of an entry point whose artifacts mount is
    ``artifacts_dir``: RBT_KERNEL_CACHE when it names a directory, the
    checkout's build/kernels/ when it is 0 or off, else
    ``<artifacts>/kernel_cache``."""
    knob = os.environ.get("RBT_KERNEL_CACHE", "").strip()
    if knob.lower() in ("0", "off", "false", "no"):
        return BUILD_DIR
    if knob:
        return Path(knob)
    return Path(artifacts_dir) / "kernel_cache"


def use_kernel_cache(directory: Optional[Path]) -> Path:
    """Build into and load from ``directory`` from now on (None: the
    checkout's build/kernels/); returns it. Libraries this process has
    already loaded stay loaded."""
    global _build_dir
    _build_dir = BUILD_DIR if directory is None else Path(directory)
    return _build_dir


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    default = os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"),
                           "bin", "nvcc")
    if os.path.exists(default):
        return default
    raise RuntimeError("nvcc not found: the port's CUDA kernels are built "
                       "on a machine with the CUDA toolkit")


def _target(name: str) -> Path:
    digest = hashlib.sha256((CSRC / f"{name}.cu").read_bytes())
    for header in sorted(CSRC.glob("*.cuh")):
        digest.update(header.read_bytes())
    digest.update(" ".join(NVCC_FLAGS).encode())
    return _build_dir / f"lib{name}-{digest.hexdigest()[:16]}.so"


def build(names: Iterable[str]) -> Dict[str, Path]:
    """Compile every named source that has no current build, all at once,
    and return each name's library path."""
    names = list(dict.fromkeys(names))
    _build_dir.mkdir(parents=True, exist_ok=True)
    targets = {n: _target(n) for n in names}
    todo = [n for n in names if not targets[n].exists()]
    procs = {}
    t0 = time.perf_counter()
    for n in todo:
        tmp = targets[n].with_suffix(f".{os.getpid()}.tmp")
        cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{n}.cu")]
        procs[n] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                     stderr=subprocess.STDOUT, text=True),
                    tmp)
        stats["nvcc_runs"] += 1
    failures = []
    for n, (proc, tmp) in procs.items():
        out, _ = proc.communicate()
        SENTINEL.record_build(time.perf_counter() - t0, n)
        if proc.returncode != 0:
            failures.append(f"nvcc failed for csrc/{n}.cu "
                            f"(exit {proc.returncode}):\n{out}")
            continue
        # The report first, then the library: a library in place always
        # has its report.
        log = targets[n].with_suffix(f".{os.getpid()}.log.tmp")
        log.write_text(out)
        os.replace(log, targets[n].with_suffix(".log"))
        os.replace(tmp, targets[n])
    if procs:
        stats["nvcc_s"] += time.perf_counter() - t0
    if failures:
        raise RuntimeError("\n".join(failures))
    return targets


def build_report(name: str) -> str:
    """The compiler's report for the current build of csrc/<name>.cu."""
    return _target(name).with_suffix(".log").read_text()


def load(name: str) -> ctypes.CDLL:
    """The loaded library of csrc/<name>.cu, built first if needed."""
    if name not in _loaded:
        path = build([name])[name]
        _loaded[name] = ctypes.CDLL(str(path))
    return _loaded[name]
