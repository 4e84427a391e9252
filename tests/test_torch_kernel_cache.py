"""The kernel build cache (utils/cuda_build.py): where the entry points
build the port's kernels, and that a warm directory loads without nvcc.

The trainer's and the server's entry points build into
``<artifacts>/kernel_cache`` (RBT_KERNEL_CACHE names another directory; 0
or off keeps the checkout's build/kernels/, where library callers build).
This image has no nvcc: a stand-in script plays it, and a warm directory
is checked with process creation forbidden.
"""

import os
import stat
import subprocess
import sys
from pathlib import Path

import pytest

from runbooks_tpu_torch.utils import cuda_build


@pytest.fixture(autouse=True)
def _restore_build_dir(monkeypatch):
    monkeypatch.setattr(cuda_build, "_build_dir", cuda_build.BUILD_DIR)
    monkeypatch.setattr(cuda_build, "stats",
                        {"nvcc_runs": 0, "nvcc_s": 0.0})


@pytest.mark.parametrize("knob,want", [
    (None, "ART/kernel_cache"), ("", "ART/kernel_cache"),
    ("0", "BUILD"), ("off", "BUILD"), ("/elsewhere/k", "/elsewhere/k")])
def test_cache_dir_resolution(monkeypatch, tmp_path, knob, want):
    if knob is None:
        monkeypatch.delenv("RBT_KERNEL_CACHE", raising=False)
    else:
        monkeypatch.setenv("RBT_KERNEL_CACHE", knob)
    want = {"ART/kernel_cache": tmp_path / "kernel_cache",
            "BUILD": cuda_build.BUILD_DIR}.get(want, Path(want))
    assert cuda_build.kernel_cache_dir(str(tmp_path)) == want
    assert cuda_build.BUILD_DIR.parts[-2:] == ("build", "kernels")


def _fake_nvcc(tmp_path, exit_code=0):
    """A stand-in for nvcc that writes its -o file (or fails)."""
    script = tmp_path / "nvcc"
    script.write_text(
        f"#!{sys.executable}\n"
        "import sys\n"
        "out = sys.argv[sys.argv.index('-o') + 1]\n"
        f"if {exit_code}:\n"
        "    print('error: no'); sys.exit(2)\n"
        "open(out, 'w').write('lib')\n"
        "print('ptxas info    : Used 99 registers')\n")
    script.chmod(script.stat().st_mode | stat.S_IEXEC)
    return str(script)


def test_cold_build_then_warm_directory_runs_no_nvcc(monkeypatch, tmp_path):
    cache = cuda_build.use_kernel_cache(tmp_path / "kernel_cache")
    monkeypatch.setattr(cuda_build, "_nvcc", lambda: _fake_nvcc(tmp_path))
    built = cuda_build.build(cuda_build.SOURCES)
    assert cuda_build.stats["nvcc_runs"] == 2
    assert all(p.parent == cache and p.read_text() == "lib"
               for p in built.values())
    assert "99 registers" in cuda_build.build_report("flash_bwd")
    # Nothing half-written is left beside the libraries.
    assert not [p for p in cache.iterdir() if p.name.endswith(".tmp")]
    mtimes = {n: p.stat().st_mtime_ns for n, p in built.items()}

    def no_process(*args, **kwargs):
        raise AssertionError("nvcc started over a warm cache")

    monkeypatch.setattr(subprocess, "Popen", no_process)
    cuda_build.stats["nvcc_runs"] = 0
    again = cuda_build.build(cuda_build.SOURCES)
    assert again == built and cuda_build.stats["nvcc_runs"] == 0
    assert {n: p.stat().st_mtime_ns for n, p in again.items()} == mtimes


def test_a_warm_library_is_named_by_its_source_hash(monkeypatch, tmp_path):
    """A library left by another process under the current hash is used;
    an edited source would name another file and build again."""
    cuda_build.use_kernel_cache(tmp_path)
    target = cuda_build._target("flash_fwd")
    assert target.parent == tmp_path
    assert target.name.startswith("libflash_fwd-") and \
        target.suffix == ".so"
    target.write_text("lib")
    monkeypatch.setattr(subprocess, "Popen", None)
    assert cuda_build.build(["flash_fwd"]) == {"flash_fwd": target}


def test_a_failed_build_raises_and_leaves_no_library(monkeypatch, tmp_path):
    cache = cuda_build.use_kernel_cache(tmp_path / "kc")
    monkeypatch.setattr(cuda_build, "_nvcc",
                        lambda: _fake_nvcc(tmp_path, exit_code=2))
    with pytest.raises(RuntimeError, match="nvcc failed for csrc/flash_fwd"):
        cuda_build.build(["flash_fwd"])
    assert not list(cache.glob("*.so"))
    monkeypatch.setattr(cuda_build, "_nvcc", lambda: _fake_nvcc(tmp_path))
    assert cuda_build.build(["flash_fwd"])["flash_fwd"].exists()


def test_library_callers_keep_the_checkout_directory():
    assert cuda_build._build_dir == cuda_build.BUILD_DIR
    assert cuda_build._target("flash_fwd").parent == cuda_build.BUILD_DIR


def test_serve_main_points_kernels_at_the_artifacts(monkeypatch, tmp_path):
    from runbooks_tpu_torch.serve import api

    class Stop(Exception):
        pass

    def stop(params):
        raise Stop

    monkeypatch.setenv("RBT_CONTENT_DIR", str(tmp_path))
    monkeypatch.delenv("RBT_KERNEL_CACHE", raising=False)
    monkeypatch.setattr(api, "load_model", stop)
    with pytest.raises(Stop):
        api.main()
    assert cuda_build._build_dir == tmp_path / "artifacts" / "kernel_cache"
    monkeypatch.setenv("RBT_KERNEL_CACHE", "off")
    with pytest.raises(Stop):
        api.main()
    assert cuda_build._build_dir == cuda_build.BUILD_DIR
    assert os.environ["RBT_CONTENT_DIR"] == str(tmp_path)
