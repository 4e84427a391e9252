"""The port's quantized loading paths against the JAX package's:
``load_model`` quantizes after the seeded init and after an adapter fold
(the quantizer sees the merged weights), a loader-packed checkpoint asked
for at another mode serves its stored mode and prints the reference's
line, and an adapter fold into packed weights is refused with the
reference's message. (The HF import at int8/int4 is in
tests/test_torch_loader.py; the engines in
tests/test_torch_quantized_serving.py.)
"""

import json
import os

import numpy as np
import pytest
import torch

from runbooks_tpu.models import loader as jax_loader
from runbooks_tpu.serve.api import load_model as jax_load_model

from runbooks_tpu_torch.models import loader
from runbooks_tpu_torch.ops import quantization as tq
from runbooks_tpu_torch.ops.lora import target_dims
from runbooks_tpu_torch.serve import lora_pool
from runbooks_tpu_torch.serve.api import load_model
from runbooks_tpu_torch.serve.engine import InferenceEngine, Request
from runbooks_tpu_torch.utils.tree import tree_leaves, tree_map

torch.set_num_threads(2)


def _adapter(cfg, seed, rank=4):
    rng = np.random.default_rng(seed)
    out = {}
    for t in cfg.lora_targets:
        d_in, d_out = target_dims(cfg, t)
        out[t] = {"a": (rng.standard_normal((cfg.num_layers, d_in, rank))
                        * d_in ** -0.5).astype(np.float32),
                  "b": (0.05 * rng.standard_normal(
                      (cfg.num_layers, rank, d_out))).astype(np.float32)}
    return out


@pytest.mark.parametrize("mode", ["int8", "int4"])
def test_load_model_quantizes_the_seeded_init(mode):
    cfg, params = load_model({"model": "debug", "quantize": mode, "seed": 2},
                             device="cpu")
    _, plain = load_model({"model": "debug", "seed": 2}, device="cpu")
    want = tq.quantize_params(plain, mode)
    assert cfg.quantize == mode and cfg.quantize_kv is None
    for a, b in zip(tree_leaves(params), tree_leaves(want)):
        if isinstance(b, tq.QuantizedArray):
            assert (a.bits, a.block_size) == (b.bits, b.block_size)
            assert torch.equal(a.values, b.values)
            assert torch.equal(a.scales, b.scales)
        else:
            assert torch.equal(a, b)
    eng = InferenceEngine(cfg, params, max_slots=2, max_seq_len=32)
    assert eng.quantize_kv and eng.cache.quantized
    req = Request(prompt_tokens=[5, 9, 17], max_tokens=4, temperature=0.0)
    eng.generate([req])
    assert len(req.output_tokens) == 4


def _import(main, root, params, monkeypatch):
    (root / "artifacts").mkdir(parents=True)
    (root / "params.json").write_text(json.dumps(params))
    monkeypatch.setenv("RBT_CONTENT_DIR", str(root))
    assert main() == 0
    return str(root / "artifacts")


def test_stored_mode_wins_and_says_so(tmp_path, monkeypatch, capsys):
    """A loader-packed int4 checkpoint served with quantize=int8: both
    sides serve the stored int4 weights and print the same line."""
    params = {"model": "debug", "source": "random", "seed": 1,
              "quantize": "int4"}
    jart = _import(jax_loader.main, tmp_path / "jax", params, monkeypatch)
    tart = _import(lambda: loader.main(device="cpu"), tmp_path / "torch",
                   params, monkeypatch)
    capsys.readouterr()
    ask = {"model": "debug", "quantize": "int8"}
    jcfg, _ = jax_load_model({**ask, "checkpoint": jart})
    jline = [ln for ln in capsys.readouterr().out.splitlines()
             if "quantized" in ln]
    cfg, params = load_model({**ask, "checkpoint": tart}, device="cpu")
    line = [ln for ln in capsys.readouterr().out.splitlines()
            if "quantized" in ln]
    assert line == jline and len(line) == 1
    assert "quantized int4" in line[0] and "quantize=int8" in line[0]
    assert cfg.quantize == jcfg.quantize == "int4"
    assert params["layers"]["mlp"]["wo"].bits == 4
    # Folding an adapter into packed weights is refused, as the
    # reference refuses it.
    with pytest.raises(RuntimeError, match="pre-quantized") as want:
        jax_load_model({"model": "debug", "checkpoint": jart,
                        "adapter": str(tmp_path)})
    with pytest.raises(RuntimeError, match="pre-quantized") as got:
        load_model({"model": "debug", "checkpoint": tart,
                    "adapter": str(tmp_path)}, device="cpu")
    assert str(got.value) == str(want.value).replace(
        " (docs/multi-tenant-lora.md)", "")


def test_adapter_folds_before_quantizing(tmp_path):
    """adapter: + quantize: the fold goes into the float weights, then the
    merged tree is quantized (the quantizer sees the merged weights)."""
    cfg, base = load_model({"model": "debug", "seed": 5}, device="cpu")
    tree = _adapter(cfg, 30)
    path = str(tmp_path / "tenant")
    lora_pool.save_adapter(path, tree_map(torch.from_numpy, tree), rank=4,
                           alpha=8.0)
    qcfg, got = load_model({"model": "debug", "seed": 5, "adapter": path,
                            "quantize": "int8"}, device="cpu")
    want = tq.quantize_params(lora_pool.load_merge_adapter(path, cfg, base),
                              "int8")
    assert qcfg.quantize == "int8"
    for name in ("wq", "wv"):
        a, b = got["layers"]["attn"][name], want["layers"]["attn"][name]
        assert torch.equal(a.values, b.values)
        assert torch.equal(a.scales, b.scales)
    unfolded = tq.quantize_params(base, "int8")["layers"]["attn"]["wq"]
    assert not torch.equal(got["layers"]["attn"]["wq"].values,
                           unfolded.values)
    assert os.path.isdir(path)
