"""The port's Model import workload (``models/loader.py``) against the JAX
package's: an import into the artifact store, then the serving side's
restore from it (the /content hand-off between a Model and a Server).

The same params.json goes through both loaders: ``model.json`` must be
the JAX loader's, the restored params the JAX import's (bridged), and the
port's engine on the port's import must give the JAX engine's greedy
tokens on the JAX import. HF directories come from a tiny seeded
``transformers`` llama (safetensors, sharded, and torch .bin), gemma,
and chip_smoke.py's writer under Mixtral's names.
"""

import json
import os
import sys
import types

import jax
import numpy as np
import pytest
import torch

from runbooks_tpu.models import loader as jax_loader
from runbooks_tpu.serve.api import load_model as jax_load_model
from runbooks_tpu.serve.engine import InferenceEngine as JaxEngine
from runbooks_tpu.serve.engine import Request as JaxRequest

import chip_smoke
from runbooks_tpu_torch.models import bridge, loader
from runbooks_tpu_torch.models.config import get_config
from runbooks_tpu_torch.ops.quantization import QuantizedArray
from runbooks_tpu_torch.serve.api import load_model
from runbooks_tpu_torch.serve.engine import InferenceEngine, Request
from runbooks_tpu_torch.utils.tree import tree_leaves

torch.set_num_threads(2)

HF_OVERRIDES = {"vocab_size": 128, "hidden_size": 64,
                "intermediate_size": 96, "num_layers": 2, "num_heads": 4,
                "num_kv_heads": 2, "head_dim": 16, "dtype": "float32",
                "tie_embeddings": False}
PROMPTS = [[5, 9, 17], list(range(1, 21)), [3] * 40]


def _run_loader(main, content, params, monkeypatch):
    os.makedirs(content / "artifacts", exist_ok=True)
    (content / "params.json").write_text(json.dumps(params))
    monkeypatch.setenv("RBT_CONTENT_DIR", str(content))
    assert main() == 0
    assert (content / "artifacts" / "checkpoints" / "0").exists()
    return json.loads((content / "artifacts" / "model.json").read_text())


def _both(tmp_path, monkeypatch, params):
    """(JAX model.json, port model.json, JAX content, port content)."""
    jax_meta = _run_loader(jax_loader.main, tmp_path / "jax", params,
                           monkeypatch)
    meta = _run_loader(lambda: loader.main(device="cpu"),
                       tmp_path / "torch", params, monkeypatch)
    return jax_meta, meta, tmp_path / "jax", tmp_path / "torch"


def _greedy(engine_cls, req_cls, cfg, params):
    eng = engine_cls(cfg, params, max_slots=2, max_seq_len=64)
    reqs = [req_cls(prompt_tokens=p, max_tokens=6) for p in PROMPTS]
    eng.generate(reqs)
    return [r.output_tokens for r in reqs]


def test_loader_random_then_serve_restore(tmp_path, monkeypatch):
    params = {"model": "debug", "source": "random", "seed": 3,
              "model_overrides": {"dtype": "float32"}}
    jax_meta, meta, _, content = _both(tmp_path, monkeypatch, params)
    assert meta == jax_meta
    assert set(meta) == {"model", "num_params", "vocab_size", "quantize",
                         "weight_bytes", "source"}
    # The server restores exactly what the loader drew.
    cfg, restored = load_model({**params,
                                "checkpoint": str(content / "artifacts")},
                               device="cpu")
    _, drawn = loader.load_weights(params, device="cpu")
    assert all(torch.equal(a, b) for a, b in zip(tree_leaves(restored),
                                                  tree_leaves(drawn)))
    assert sum(t.numel() for t in tree_leaves(restored)) == cfg.num_params


def _hf_llama_dir(path, kind):
    transformers = pytest.importorskip("transformers")
    hf_cfg = transformers.LlamaConfig(
        vocab_size=128, hidden_size=64, intermediate_size=96,
        num_hidden_layers=2, num_attention_heads=4, num_key_value_heads=2,
        max_position_embeddings=64, rms_norm_eps=1e-5, rope_theta=10000.0,
        tie_word_embeddings=False)
    torch.manual_seed(0)
    hf = transformers.LlamaForCausalLM(hf_cfg)
    if kind == "bf16_sharded":
        hf = hf.to(torch.bfloat16)
        hf.save_pretrained(path, safe_serialization=True,
                           max_shard_size="40KB")
        assert len(list(path.glob("*.safetensors"))) > 1
    elif kind == "f32":
        hf.save_pretrained(path, safe_serialization=True)
    else:
        hf.save_pretrained(path, safe_serialization=False)
        assert list(path.glob("*.bin"))
    return path


@pytest.mark.parametrize("kind", ["f32", "bf16_sharded", "bin"])
def test_loader_from_hf_dir_matches_jax(tmp_path, monkeypatch, kind):
    model_dir = _hf_llama_dir(tmp_path / "model", kind)
    params = {"model": "debug", "model_overrides": HF_OVERRIDES,
              "source": "dir", "dir": str(model_dir)}
    jax_meta, meta, jax_content, content = _both(tmp_path, monkeypatch,
                                                 params)
    assert meta == jax_meta
    assert meta["source"] == "dir" and meta["num_params"] > 0
    jcfg, jparams = jax_load_model({
        **params, "checkpoint": str(jax_content / "artifacts")})
    cfg, tparams = load_model({**params,
                               "checkpoint": str(content / "artifacts")},
                              device="cpu")
    want = bridge.from_jax_numpy(cfg, jax.tree.map(np.asarray, jparams))
    assert all(torch.equal(a, b) for a, b in zip(tree_leaves(tparams),
                                                  tree_leaves(want)))
    assert _greedy(InferenceEngine, Request, cfg, tparams) \
        == _greedy(JaxEngine, JaxRequest, jcfg, jparams)


def test_huggingface_source_through_snapshot_download(tmp_path,
                                                      monkeypatch):
    model_dir = _hf_llama_dir(tmp_path / "model", "f32")
    calls = []

    def snapshot_download(repo_id, allow_patterns=None):
        calls.append((repo_id, allow_patterns))
        return str(model_dir)

    monkeypatch.setitem(sys.modules, "huggingface_hub", types.SimpleNamespace(
        snapshot_download=snapshot_download))
    base = {"model": "debug", "model_overrides": HF_OVERRIDES}
    _, from_hub = loader.load_weights(
        {**base, "source": "huggingface",
         "hf_name": "meta-llama/Meta-Llama-3-8B"}, device="cpu")
    _, from_dir = loader.load_weights(
        {**base, "source": "dir", "dir": str(model_dir)}, device="cpu")
    assert calls == [("meta-llama/Meta-Llama-3-8B",
                      ["*.safetensors", "*.bin", "*.json", "tokenizer*"])]
    assert all(torch.equal(a, b) for a, b in zip(tree_leaves(from_hub),
                                                  tree_leaves(from_dir)))


def test_huggingface_source_without_the_package(monkeypatch):
    monkeypatch.setitem(sys.modules, "huggingface_hub", None)
    with pytest.raises(RuntimeError, match="huggingface_hub"):
        loader.load_weights({"model": "debug", "source": "huggingface",
                             "hf_name": "x/y"}, device="cpu")


def _leaf_equal(a, b):
    if isinstance(a, QuantizedArray):
        return (isinstance(b, QuantizedArray)
                and (a.bits, a.block_size) == (b.bits, b.block_size)
                and torch.equal(a.values, b.values)
                and torch.equal(a.scales, b.scales))
    return torch.equal(a, b)


@pytest.mark.parametrize("mode", ["int8", "int4"])
def test_import_with_quantize_writes_packed_checkpoint(tmp_path, monkeypatch,
                                                       mode):
    """``quantize`` on an HF import: model.json as the JAX loader's
    (logical num_params, packed weight_bytes), a packed checkpoint of plain
    tensors, restored by load_model to the JAX import's leaves bit for bit,
    and the JAX engine's greedy ids."""
    model_dir = _hf_llama_dir(tmp_path / "model", "bf16_sharded")
    params = {"model": "debug", "model_overrides": HF_OVERRIDES,
              "source": "dir", "dir": str(model_dir), "quantize": mode}
    jax_meta, meta, jax_content, content = _both(tmp_path, monkeypatch,
                                                 params)
    assert meta == jax_meta and meta["quantize"] == mode
    plain = loader.load_weights({**params, "quantize": "none"},
                                device="cpu")[1]
    assert meta["num_params"] == sum(t.numel() for t in tree_leaves(plain))
    state = torch.load(content / "artifacts" / "checkpoints" / "0" /
                       "state.pt", weights_only=True)
    packed = state["params"]["layers"]["mlp"]["wi_gate"]
    assert set(packed) == {"__quantized__"}
    assert packed["__quantized__"]["meta"].tolist()[0] == \
        (8 if mode == "int8" else 4)
    jcfg, jparams = jax_load_model({
        **params, "checkpoint": str(jax_content / "artifacts")})
    cfg, tparams = load_model({**params,
                               "checkpoint": str(content / "artifacts")},
                              device="cpu")
    assert cfg.quantize == jcfg.quantize == mode
    want = bridge.from_jax_numpy(cfg, jax.tree.map(np.asarray, jparams))
    assert all(_leaf_equal(a, b) for a, b in zip(tree_leaves(tparams),
                                                  tree_leaves(want)))
    assert isinstance(tparams["layers"]["attn"]["wq"], QuantizedArray)
    assert _greedy(InferenceEngine, Request, cfg, tparams) \
        == _greedy(JaxEngine, JaxRequest, jcfg, jparams)


def test_bad_params_raise_like_jax():
    for params, exc in (({"model": "debug", "quantize": "int3"}, ValueError),
                        ({"model": "debug", "source": "s3"}, ValueError)):
        with pytest.raises(exc) as jexc:
            jax_loader.load_weights(params)
        with pytest.raises(exc) as texc:
            loader.load_weights(params, device="cpu")
        assert str(texc.value) == str(jexc.value)


@pytest.mark.parametrize("kind", ["f32", "bf16_sharded"])
def test_gemma_hf_dir_loads_like_jax(tmp_path, kind):
    """A tiny transformers GemmaForCausalLM directory (llama's names, no
    lm_head, norm weights drawn away from their zero init): load_weights
    gives the JAX loader's params leaf for leaf (the norms' +1 folded in,
    the head tied), in f32 and from BF16 shards into a bf16 model."""
    transformers = pytest.importorskip("transformers")
    hf_cfg = transformers.GemmaConfig(
        vocab_size=128, hidden_size=64, intermediate_size=96,
        num_hidden_layers=2, num_attention_heads=4, num_key_value_heads=1,
        head_dim=16, max_position_embeddings=64,
        hidden_activation="gelu_pytorch_tanh")
    torch.manual_seed(0)
    hf = transformers.GemmaForCausalLM(hf_cfg)
    with torch.no_grad():
        for name, t in hf.named_parameters():
            if name.endswith("norm.weight"):
                t.normal_(0.0, 0.5)
    path = tmp_path / "model"
    dtype = "float32"
    if kind == "bf16_sharded":
        hf = hf.to(torch.bfloat16)
        dtype = "bfloat16"
        hf.save_pretrained(path, safe_serialization=True,
                           max_shard_size="40KB")
        assert len(list(path.glob("*.safetensors"))) > 1
    else:
        hf.save_pretrained(path, safe_serialization=True)
    params = {"model": "gemma-2b", "source": "dir", "dir": str(path),
              "model_overrides": {**HF_OVERRIDES, "num_kv_heads": 1,
                                  "tie_embeddings": True,
                                  "param_dtype": dtype}}
    jcfg, jweights = jax_loader.load_weights(params)
    cfg, weights = loader.load_weights(params, device="cpu")
    assert cfg.embed_scale and "head" not in weights
    want = bridge.from_jax_numpy(cfg, jax.tree.map(np.asarray, jweights))
    assert all(torch.equal(a, b) for a, b in zip(tree_leaves(weights),
                                                  tree_leaves(want)))
    assert weights["final_norm"]["scale"].dtype == getattr(torch, dtype)


def _flat(tree, prefix=""):
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_flat(v, f"{prefix}{k}."))
        return out
    return {prefix[:-1]: tree}


# A tiny Mixtral (4 experts, top 2) at HF_OVERRIDES' width.
MIXTRAL = {**HF_OVERRIDES, "max_seq_len": 64, "moe_num_experts": 4,
           "moe_top_k": 2}


def test_mixtral_hf_dir_loads_like_reference(tmp_path):
    """A BF16 HF directory in two shards (chip_smoke's writer, the names
    of HF MixtralForCausalLM) into a bf16 model: load_weights gives the
    reference loader's params leaf for leaf, and the quantized import
    (int8) leaves the experts in bf16 as the reference's."""
    cfg = get_config("debug", **MIXTRAL)
    chip_smoke.write_hf_checkpoint(torch, torch.device("cpu"),
                                   chip_smoke.hf_names(cfg), str(tmp_path),
                                   3, 2)
    for quantize in ("none", "int8"):
        params = {"model": "mixtral-8x7b", "source": "dir",
                  "dir": str(tmp_path), "quantize": quantize,
                  "model_overrides": {**MIXTRAL, "param_dtype": "bfloat16"}}
        jcfg, jweights = jax_loader.load_weights(params)
        tcfg, weights = loader.load_weights(params, device="cpu")
        want = _flat(bridge.tree_from_numpy(jax.tree.map(np.asarray,
                                                         jweights)))
        got = _flat(weights)
        assert got.keys() == want.keys()
        for k, w in want.items():
            if isinstance(w, QuantizedArray):
                assert torch.equal(got[k].values, w.values), k
                assert torch.equal(got[k].scales, w.scales), k
            else:
                assert got[k].dtype == torch.bfloat16, k
                assert torch.equal(got[k], w), k
        assert tcfg.quantize == jcfg.quantize == quantize


def test_entry_point_runs_on_cuda_unless_told(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        loader.load_weights({"model": "debug"})
