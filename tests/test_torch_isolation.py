"""The PyTorch port stands alone: no module of runbooks_tpu_torch and
none of its root scripts imports jax or runbooks_tpu, the package imports
with both blocked, and its entry points (serving's load_model,
create_server and main, training's run_training) refuse to fall back to
the CPU when no GPU exists and no device was named."""

import ast
import os
import subprocess
import sys
from pathlib import Path

import pytest
import torch

ROOT = Path(__file__).resolve().parents[1]
PORT = ROOT / "runbooks_tpu_torch"
FORBIDDEN = ("jax", "jaxlib", "runbooks_tpu")


def _port_files():
    return sorted(PORT.rglob("*.py")) + [ROOT / "chip_smoke.py",
                                         ROOT / "profile_torch_serve.py",
                                         ROOT / "profile_torch_train.py"]


def _imported(path: Path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module or ""


def _forbidden(name: str) -> bool:
    return any(name == f or name.startswith(f + ".") for f in FORBIDDEN)


@pytest.mark.parametrize("path", _port_files(),
                         ids=lambda p: str(p.relative_to(ROOT)))
def test_no_jax_or_reference_imports(path):
    bad = [n for n in _imported(path) if _forbidden(n)]
    assert not bad, f"{path.relative_to(ROOT)} imports {bad}"


def test_package_imports_with_jax_blocked():
    modules = sorted(
        ".".join(p.relative_to(ROOT).with_suffix("").parts)
        for p in PORT.rglob("*.py") if p.name != "__init__.py")
    code = ("import sys\n"
            "for m in ('jax', 'jaxlib', 'runbooks_tpu'):\n"
            "    sys.modules[m] = None\n"
            f"import importlib\n"
            f"for m in {modules!r}:\n"
            "    importlib.import_module(m)\n"
            "print('ok')\n")
    env = dict(os.environ, PYTHONPATH=str(ROOT))
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "ok"


def test_entry_points_raise_without_a_gpu(monkeypatch, tmp_path):
    from runbooks_tpu_torch.serve.api import create_server, load_model, main
    from runbooks_tpu_torch.utils.hw import resolve_device

    from runbooks_tpu_torch.train.trainer import TrainJobConfig, run_training

    cfg, params = load_model({"model": "debug"}, device="cpu")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    monkeypatch.setenv("RBT_CONTENT_DIR", str(tmp_path))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        load_model({"model": "debug"})
    with pytest.raises(RuntimeError, match="no CUDA device"):
        create_server(cfg, params, port=0)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        main()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        run_training(TrainJobConfig(model="debug", steps=1))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        resolve_device()
    with pytest.raises(RuntimeError, match="not available"):
        resolve_device("cuda")
    assert resolve_device("cpu").type == "cpu"


def test_paged_entry_point_raises_without_a_gpu(monkeypatch):
    """The paged server runs on CUDA unless a device is named; the paged
    engine runs where its params live."""
    from runbooks_tpu_torch.serve.api import create_server, load_model
    from runbooks_tpu_torch.serve.paging import PagedInferenceEngine

    cfg, params = load_model({"model": "debug"}, device="cpu")
    assert PagedInferenceEngine(cfg, params, max_slots=1,
                                max_seq_len=64).cache.k.device.type == "cpu"
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        create_server(cfg, params, port=0, kv_paging=True,
                      kv_host_pages=4, preemption="swap")


def test_load_model_refuses_what_it_cannot_do():
    from runbooks_tpu_torch.serve.api import load_model

    # A checkpoint path with nothing under it takes the seeded init, as
    # the reference's load_model does.
    nothing = load_model({"model": "debug", "checkpoint": "/nonexistent",
                          "seed": 1}, device="cpu")[1]
    assert torch.equal(nothing["embed"], load_model(
        {"model": "debug", "seed": 1}, device="cpu")[1]["embed"])
    with pytest.raises(NotImplementedError):
        load_model({"model": "debug", "quantize": "int8"}, device="cpu")
    with pytest.raises(NotImplementedError):
        load_model({"model": "gpt2"}, device="cpu")
    cfg, params = load_model(
        {"model": "debug", "model_overrides": {"param_dtype": "bfloat16"},
         "seed": 1}, device="cpu")
    assert params["layers"]["mlp"]["wi_gate"].dtype == torch.bfloat16
    assert params["layers"]["attn"]["wq"].shape == (2, 128, 128)
    overrides = {"param_dtype": "bfloat16"}
    same = load_model({"model": "debug", "model_overrides": overrides,
                       "seed": 1}, device="cpu")[1]
    other = load_model({"model": "debug", "model_overrides": overrides,
                        "seed": 2}, device="cpu")[1]
    assert torch.equal(params["embed"], same["embed"])
    assert not torch.equal(params["embed"], other["embed"])
