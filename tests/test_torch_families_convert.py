"""The falcon, opt and gpt2 converters and their import, against the JAX
package's.

State dicts are seeded numpy arrays in HF's names and shapes
(``chip_smoke.hf_names``: Falcon's fused query_key_value at the 7b
multi-query layout and the 40b grouped one with ln_attn / ln_mlp, OPT's
positions with HF's 2 extra rows, GPT-2's Conv1D [in, out] with the fused
c_attn) at debug width. The port's ``convert`` must give the JAX
``convert``'s leaves bit for bit, in f32 and bf16, from f32 and bf16
sources, quantized too; and chip_smoke.py's hand-worked expectation of
each leaf (the one phase 16 checks on the card). The loader's import of
a BF16 two-shard directory must give the JAX loader's model.json and
params, and greedy ids through the engine equal the JAX engine's on the
JAX import.
"""

import dataclasses
import json
import os

import jax  # noqa: F401  (registers numpy's bfloat16 through ml_dtypes)
import ml_dtypes
import numpy as np
import pytest
import torch

from runbooks_tpu.models import loader as jax_loader
from runbooks_tpu.models.config import get_config as jax_get_config
from runbooks_tpu.models.convert import convert as jax_convert
from runbooks_tpu.models.convert import family_of as jax_family_of
from runbooks_tpu.ops.quantization import quantize_params as jax_quantize
from runbooks_tpu.serve.api import load_model as jax_load_model
from runbooks_tpu.serve.engine import InferenceEngine as JaxEngine
from runbooks_tpu.serve.engine import Request as JaxRequest

import chip_smoke
from runbooks_tpu_torch.models import bridge, loader
from runbooks_tpu_torch.models.config import get_config
from runbooks_tpu_torch.models.convert import convert, family_of
from runbooks_tpu_torch.ops.quantization import (
    QuantizedArray,
    quantize_params,
)
from runbooks_tpu_torch.serve.api import load_model
from runbooks_tpu_torch.serve.engine import InferenceEngine, Request

torch.set_num_threads(2)

WIDTH = dict(vocab_size=256, hidden_size=64, intermediate_size=96,
             num_layers=2, num_heads=4, head_dim=16, max_seq_len=48,
             dtype="float32")
FAMILIES = {
    "falcon-7b": dict(num_kv_heads=1),
    "falcon-40b": dict(num_kv_heads=2),
    "opt-125m": dict(num_kv_heads=4),
    "gpt2": dict(num_kv_heads=4),
}
PROMPTS = [[5, 9, 17], list(range(1, 21)), [3] * 30]


def configs(name):
    kw = {**WIDTH, **FAMILIES[name]}
    return jax_get_config(name, **kw), get_config(name, **kw)


def hf_state_dict(cfg, seed):
    """Seeded f32 numpy arrays in HF's names and shapes."""
    rng = np.random.default_rng(seed)
    sd = {}
    for name, shape in chip_smoke.hf_names(cfg).items():
        scale = 1.0 if len(shape) == 1 else shape[-1] ** -0.5
        base = 1.0 if chip_smoke._is_norm_weight(name) else 0.0
        sd[name] = (base + scale * rng.standard_normal(shape)).astype(
            np.float32)
    return sd


def _flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flat(v, f"{prefix}{k}."))
        else:
            out[prefix + k] = v
    return out


def _same(a, b):
    return a.dtype == b.dtype and a.shape == b.shape and torch.equal(a, b)


@pytest.mark.parametrize("src_dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("name", sorted(FAMILIES))
def test_convert_equals_jax_convert(name, src_dtype):
    jcfg, tcfg = configs(name)
    sd = hf_state_dict(tcfg, 6)
    if src_dtype == "bfloat16":
        np_sd = {k: v.astype(ml_dtypes.bfloat16) for k, v in sd.items()}
        t_sd = {k: torch.from_numpy(v).bfloat16() for k, v in sd.items()}
    else:
        np_sd = sd
        t_sd = {k: torch.from_numpy(v) for k, v in sd.items()}
    assert family_of(tcfg) == jax_family_of(jcfg) == name.split("-")[0]
    for dtype in ("float32", "bfloat16"):
        want = _flat(bridge.tree_from_numpy(jax_convert(jcfg, np_sd,
                                                        dtype=dtype)))
        got = _flat(convert(tcfg, t_sd, dtype))
        assert got.keys() == want.keys()
        for k, w in want.items():
            assert _same(got[k], w), (k, dtype)
    # The layout the model takes (models/bridge.py's check).
    bridge.from_jax_numpy(tcfg, bridge.to_numpy(convert(tcfg, t_sd)))


@pytest.mark.parametrize("name", sorted(FAMILIES))
def test_convert_equals_the_hand_worked_leaves(name):
    """Every leaf equals chip_smoke.family_expected's by-hand unfusing,
    splitting and transposing of the HF tensors (phase 16's check)."""
    _, tcfg = configs(name)
    t_sd = {k: torch.from_numpy(v).bfloat16()
            for k, v in hf_state_dict(tcfg, 8).items()}
    got = convert(tcfg, t_sd, "float32")
    expected = chip_smoke.family_expected(torch, t_sd, tcfg)
    seen = set()
    for leaf, layer, want in expected:
        t = got
        for k in leaf.split("."):
            t = t[k]
        t = t if layer is None else t[layer]
        assert _same(t, want.float()), (leaf, layer)
        seen.add(leaf)
    assert seen == set(_flat(got))


@pytest.mark.parametrize("mode", ["int8", "int4"])
@pytest.mark.parametrize("name", ["falcon-40b", "gpt2"])
def test_convert_quantizes_like_jax_convert(name, mode):
    """Packed layer by layer as it converts: codes, scales and every other
    leaf (biases, norms, positions, the tied embedding) equal the
    reference's quantize-after-convert."""
    jcfg, tcfg = configs(name)
    sd = hf_state_dict(tcfg, 7)
    t_sd = {k: torch.from_numpy(v) for k, v in sd.items()}
    want = _flat(jax_convert(jcfg, sd, dtype="bfloat16", quantize=mode))
    got = _flat(convert(tcfg, t_sd, "bfloat16", quantize=mode))
    assert got.keys() == want.keys()
    packed = 0
    for k, w in want.items():
        g = got[k]
        if hasattr(w, "bits"):
            assert isinstance(g, QuantizedArray), k
            assert (g.bits, g.block_size) == (w.bits, w.block_size)
            assert torch.equal(g.values, torch.from_numpy(np.array(
                w.values)))
            assert torch.equal(g.scales, torch.from_numpy(np.array(
                w.scales)))
            packed += 1
        else:
            assert _same(g, bridge.tree_from_numpy({"x": w})["x"]), k
    # wq, wk, wv, wo, wi, wo: the plain MLP's one input matrix.
    assert packed == 6


@pytest.mark.parametrize("name", sorted(FAMILIES))
def test_quantize_params_keeps_biases_positions_and_embedding(name):
    jcfg, tcfg = configs(name)
    sd = hf_state_dict(tcfg, 9)
    want = _flat(jax_quantize(jax_convert(jcfg, sd), "int8"))
    got = _flat(quantize_params(convert(
        tcfg, {k: torch.from_numpy(v) for k, v in sd.items()}), "int8"))
    assert got.keys() == want.keys()
    for k, w in want.items():
        assert isinstance(got[k], QuantizedArray) == hasattr(w, "bits"), k
    plain = [k for k in got if not isinstance(got[k], QuantizedArray)]
    assert "embed" in plain and all(
        k in plain for k in got if k.split(".")[-1].startswith("b"))
    assert ("pos_embed" in plain) == (tcfg.position_type == "learned")


@pytest.mark.parametrize("overrides,family", [
    ({"parallel_block": True}, "falcon"),
    ({"position_type": "learned"}, "opt"),
    ({"moe_num_experts": 8}, "mixtral"),
    ({}, "llama")])
def test_family_of_structural_fallback(overrides, family):
    tcfg = dataclasses.replace(get_config("debug"), name="custom",
                               **overrides)
    jcfg = dataclasses.replace(jax_get_config("debug"), name="custom",
                               **overrides)
    assert family_of(tcfg) == jax_family_of(jcfg) == family


# ---------------------------------------------------------------------------
# The import workload
# ---------------------------------------------------------------------------

def _write_dir(path, tcfg, seed):
    """A BF16 HF directory in two shards (chip_smoke.py's writer)."""
    tensors, _ = chip_smoke.write_hf_checkpoint(
        torch, torch.device("cpu"), chip_smoke.hf_names(tcfg), str(path),
        seed, 2)
    assert len(list(path.glob("*.safetensors"))) == 2
    return tensors


def _run(main, content, params, monkeypatch):
    os.makedirs(content / "artifacts", exist_ok=True)
    (content / "params.json").write_text(json.dumps(params))
    monkeypatch.setenv("RBT_CONTENT_DIR", str(content))
    assert main() == 0
    return json.loads((content / "artifacts" / "model.json").read_text())


def _greedy(engine_cls, req_cls, cfg, params):
    eng = engine_cls(cfg, params, max_slots=2, max_seq_len=48)
    reqs = [req_cls(prompt_tokens=p, max_tokens=6) for p in PROMPTS]
    eng.generate(reqs)
    return [r.output_tokens for r in reqs]


@pytest.mark.parametrize("name", sorted(FAMILIES))
def test_import_of_a_bf16_directory_matches_jax(tmp_path, monkeypatch,
                                                name):
    _, tcfg = configs(name)
    tensors = _write_dir(tmp_path / "hf", tcfg, 3)
    params = {"model": name, "model_overrides": {**WIDTH, **FAMILIES[name]},
              "source": "dir", "dir": str(tmp_path / "hf")}
    jax_meta = _run(jax_loader.main, tmp_path / "jax", params, monkeypatch)
    meta = _run(lambda: loader.main(device="cpu"), tmp_path / "torch",
                params, monkeypatch)
    assert meta == jax_meta
    assert meta["num_params"] == tcfg.num_params
    cfg, restored = load_model(
        {**params, "checkpoint": str(tmp_path / "torch" / "artifacts")},
        device="cpu")
    for leaf, layer, want in chip_smoke.family_expected(torch, tensors,
                                                        cfg):
        t = restored
        for k in leaf.split("."):
            t = t[k]
        t = t if layer is None else t[layer]
        assert _same(t, want.float()), (leaf, layer)
    jcfg, jparams = jax_load_model(
        {**params, "checkpoint": str(tmp_path / "jax" / "artifacts")})
    assert _greedy(InferenceEngine, Request, cfg, restored) == \
        _greedy(JaxEngine, JaxRequest, jcfg, jparams)


def test_opt_vocab_and_merges_directory_is_refused_by_name(tmp_path):
    """OPT's hub directory holds vocab.json and merges.txt with no
    tokenizer.json: the loader reads it (tests/test_torch_tokenizer_files.py
    holds it to transformers), and refuses one whose merges name a token
    the vocab lacks, by name (with no path asked for, serving keeps the
    byte tokenizer, as examples/facebook-opt-125m/base-server.yaml does)."""
    from runbooks_tpu_torch.models import tokenizer_io
    from runbooks_tpu_torch.train.data import ByteTokenizer, load_tokenizer

    (tmp_path / "vocab.json").write_text(json.dumps({"a": 0, "b": 1}))
    (tmp_path / "merges.txt").write_text("#version: 0.2\na b\n")
    with pytest.raises(tokenizer_io.TokenizerFormatError,
                       match="not in the vocab"):
        tokenizer_io.load(str(tmp_path))
    with pytest.raises(RuntimeError):
        load_tokenizer(str(tmp_path))
    (tmp_path / "vocab.json").write_text(json.dumps({"a": 0, "b": 1,
                                                     "ab": 2}))
    assert load_tokenizer(str(tmp_path)).encode("abba") == [2, 1, 0]
    assert isinstance(load_tokenizer(None), ByteTokenizer)
