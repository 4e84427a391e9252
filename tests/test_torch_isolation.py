"""The PyTorch port stands alone: no module of runbooks_tpu_torch and
none of its root scripts imports jax or runbooks_tpu, nor a package the
card lacks (transformers, tokenizers, sentencepiece, regex,
huggingface_hub, orbax, google.protobuf: the port reads tokenizer files
and sentencepiece's protobuf itself), nor the orbax converter under
tools/ (which runs where orbax is installed), the package
imports with all of them blocked, and its entry points (serving's
load_model, create_server and main, training's run_training) refuse to
fall back to the CPU when no GPU exists and no device was named."""

import ast
import os
import subprocess
import sys
from pathlib import Path

import pytest
import torch

ROOT = Path(__file__).resolve().parents[1]
PORT = ROOT / "runbooks_tpu_torch"
FORBIDDEN = ("jax", "jaxlib", "runbooks_tpu", "transformers", "tokenizers",
             "sentencepiece", "regex", "huggingface_hub", "orbax",
             "google.protobuf", "tools")
# Packages the card lacks that a port module may still try for an
# optional feature, inside ``try: ... except ImportError``: the model
# loader's ``source: huggingface`` download.
OPTIONAL = ("huggingface_hub",)


def _port_files():
    return sorted(PORT.rglob("*.py")) + [ROOT / "chip_smoke.py",
                                         ROOT / "profile_torch_serve.py",
                                         ROOT / "profile_torch_train.py"]


def _imported(path: Path, skip_guarded: bool = False):
    """Every module ``path`` imports; with ``skip_guarded`` not those
    imported inside a try whose handler catches ImportError."""
    tree = ast.parse(path.read_text(), filename=str(path))
    guarded = set()
    if skip_guarded:
        for node in ast.walk(tree):
            if isinstance(node, ast.Try) and any(
                    "ImportError" in ast.dump(h.type or ast.Name("")) or
                    h.type is None for h in node.handlers):
                for stmt in node.body:
                    guarded.update(id(n) for n in ast.walk(stmt))
    for node in ast.walk(tree):
        if id(node) in guarded:
            continue
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module or ""


def _forbidden(name: str) -> bool:
    return any(name == f or name.startswith(f + ".") for f in FORBIDDEN)


@pytest.mark.parametrize("path", _port_files(),
                         ids=lambda p: str(p.relative_to(ROOT)))
def test_no_jax_or_reference_imports(path):
    bad = [n for n in _imported(path) if _forbidden(n)
           and not any(n.startswith(o) for o in OPTIONAL)]
    bad += [n for n in _imported(path, skip_guarded=True)
            if any(n.startswith(o) for o in OPTIONAL)]
    assert not bad, f"{path.relative_to(ROOT)} imports {bad}"


def test_guarded_imports_are_seen():
    """The check above finds an unguarded import of an optional package
    and passes over a guarded one."""
    import tempfile

    with tempfile.TemporaryDirectory() as d:
        plain = Path(d) / "plain.py"
        plain.write_text("import huggingface_hub\nimport regex\n")
        guarded = Path(d) / "guarded.py"
        guarded.write_text("try:\n    from huggingface_hub import x\n"
                           "except ImportError:\n    x = None\n")
        assert list(_imported(plain, skip_guarded=True)) == [
            "huggingface_hub", "regex"]
        assert list(_imported(guarded, skip_guarded=True)) == []
        assert list(_imported(guarded)) == ["huggingface_hub"]


def test_tokenizer_files_read_with_the_card_packages_blocked(tmp_path):
    """In a process where transformers, tokenizers, sentencepiece, regex
    and huggingface_hub cannot be imported, chip_smoke's tokenizer writers
    make both llama-style directories and the port loads, encodes,
    decodes and renders their chat templates."""
    code = ("import sys\n"
            f"for m in {FORBIDDEN!r}:\n"
            "    sys.modules[m] = None\n"
            "import chip_smoke as cs\n"
            "from runbooks_tpu_torch.train.data import load_tokenizer\n"
            "docs = ['Hello world, it is 2024.\\n\u4e2d\u6587'] * 20\n"
            f"cs.write_llama3_tokenizer({str(tmp_path / 'l3')!r}, docs, 0, "
            "regular=600)\n"
            f"cs.write_llama2_tokenizer({str(tmp_path / 'l2')!r}, docs, 0, "
            "size=700)\n"
            "for d in ('l3', 'l2'):\n"
            f"    tok = load_tokenizer({str(tmp_path)!r} + '/' + d)\n"
            "    ids = tok.encode(docs[0])\n"
            "    assert tok.decode(ids, skip_special_tokens=True) == docs[0]\n"
            "    msgs = [{'role': 'user', 'content': 'hi'}]\n"
            "    text = tok.apply_chat_template(msgs, tokenize=False)\n"
            "    assert 'hi' in text\n"
            "print('ok')\n")
    env = dict(os.environ, PYTHONPATH=str(ROOT))
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "ok"


def test_package_imports_with_jax_blocked():
    modules = sorted(
        ".".join(p.relative_to(ROOT).with_suffix("").parts)
        for p in PORT.rglob("*.py") if p.name != "__init__.py")
    code = ("import sys\n"
            f"for m in {FORBIDDEN!r}:\n"
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
    with pytest.raises(NotImplementedError, match="embed_scale"):
        load_model({"model": "gemma-2b"}, device="cpu")
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
