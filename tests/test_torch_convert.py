"""The port's HF checkpoint reader and llama converter against the
safetensors package and the JAX package's ``convert``.

State dicts are seeded numpy arrays in HF's names and ``[out, in]``
shapes at ``debug`` widths (GQA and MHA; a head given, absent or tied).
The port's safetensors reader, written from the format's specification,
must give what the ``safetensors`` package reads (F32, F16, BF16, sharded
directories, chip_smoke.py's writer); its ``.bin`` fallback what the
reference's ``load_torch_state_dict`` reads; its ``convert`` what the JAX
``convert`` gives, bit for bit; and a tiny ``transformers`` llama's and
gemma's logits what the port's forward computes from the converted
weights.
"""

import json
import struct

import jax  # noqa: F401  (registers numpy's bfloat16 through ml_dtypes)
import ml_dtypes
import numpy as np
import pytest
import torch
from safetensors import safe_open
from safetensors.torch import save_file

from runbooks_tpu.models.config import CONFIGS as JAX_CONFIGS
from runbooks_tpu.models.config import get_config as jax_get_config
from runbooks_tpu.models.convert import convert as jax_convert
from runbooks_tpu.models.convert import family_of as jax_family_of
from runbooks_tpu.models.convert import load_torch_state_dict

import chip_smoke
from runbooks_tpu_torch.models import bridge
from runbooks_tpu_torch.models.config import CONFIGS, get_config
from runbooks_tpu_torch.models.convert import convert, family_of
from runbooks_tpu_torch.models.safetensors_io import (
    load_state_dict,
    read_safetensors,
)
from runbooks_tpu_torch.models.transformer import forward
from runbooks_tpu_torch.utils.tree import tree_leaves

torch.set_num_threads(2)

DTYPES = {"F32": torch.float32, "F16": torch.float16,
          "BF16": torch.bfloat16}


def _tensors(seed, dtype):
    """Seeded tensors of several ranks, a scalar and an empty one."""
    rng = np.random.default_rng(seed)
    shapes = {"w": (7, 5), "b": (3,), "conv": (2, 3, 4), "scalar": (),
              "empty": (0, 4), "big": (64, 33)}
    return {k: torch.from_numpy(rng.standard_normal(s).astype(np.float32))
            .to(dtype) for k, s in shapes.items()}


def _package(path):
    with safe_open(str(path), framework="pt") as f:
        return {k: f.get_tensor(k) for k in f.keys()}


def _same(a, b):
    return a.dtype == b.dtype and a.shape == b.shape and torch.equal(a, b)


@pytest.mark.parametrize("name", sorted(DTYPES))
def test_reader_equals_safetensors_package(tmp_path, name):
    tensors = _tensors(1, DTYPES[name])
    path = tmp_path / "model.safetensors"
    save_file(tensors, str(path), metadata={"format": "pt"})
    got, want = read_safetensors(str(path)), _package(path)
    assert set(got) == set(want) == set(tensors)
    assert all(_same(got[k], want[k]) for k in want)


def test_sharded_directory_equals_package_and_reference(tmp_path):
    shards = {"model-00001-of-00002.safetensors": _tensors(2,
                                                           torch.bfloat16),
              "model-00002-of-00002.safetensors": {
                  f"x.{k}": v for k, v in _tensors(3, torch.float16).items()}}
    weight_map = {}
    for fname, part in shards.items():
        save_file(part, str(tmp_path / fname))
        weight_map.update({k: fname for k in part})
    (tmp_path / "model.safetensors.index.json").write_text(json.dumps(
        {"metadata": {}, "weight_map": weight_map}))
    (tmp_path / "config.json").write_text("{}")
    got = load_state_dict(str(tmp_path))
    want = {}
    for fname in shards:
        want.update(_package(tmp_path / fname))
    assert set(got) == set(want) == set(weight_map)
    assert all(_same(got[k], want[k]) for k in want)
    # The reference reads the same directory through numpy (BF16 only
    # because importing JAX registered ml_dtypes).
    ref = load_torch_state_dict(str(tmp_path))
    assert set(ref) == set(got)
    for k, v in ref.items():
        np.testing.assert_array_equal(got[k].float().numpy(),
                                      np.asarray(v, np.float32))


def test_chip_smoke_writer_matches_package(tmp_path):
    # Mixed dtypes in an order that puts an F32 tensor at an offset its
    # itemsize does not divide (the reader copies it out of the map).
    rng = np.random.default_rng(4)
    tensors = {
        "odd_f16": torch.from_numpy(rng.standard_normal(3)).half(),
        "f32_after": torch.from_numpy(rng.standard_normal((4, 6))).float(),
        "one_byte_off": torch.from_numpy(
            rng.standard_normal(5)).half()[:1],
        "bf16": torch.from_numpy(rng.standard_normal((5, 3))).bfloat16(),
        "scalar": torch.tensor(2.5),
    }
    path = tmp_path / "w.safetensors"
    nbytes = chip_smoke.write_safetensors(torch, str(path), tensors)
    assert nbytes == sum(t.numel() * t.element_size()
                         for t in tensors.values())
    want, got = _package(path), read_safetensors(str(path))
    assert set(want) == set(got) == set(tensors)
    for k, t in tensors.items():
        assert _same(want[k], t) and _same(got[k], t), k


def test_hf_llama_directory_of_chip_smoke(tmp_path):
    cfg = get_config("debug")
    tensors, nbytes = chip_smoke.write_hf_llama(
        torch, torch.device("cpu"), cfg, str(tmp_path), 0, 2)
    index = json.loads((tmp_path / "model.safetensors.index.json")
                       .read_text())
    assert index["metadata"]["total_size"] == nbytes
    assert set(index["weight_map"]) == set(tensors)
    assert len(set(index["weight_map"].values())) == 2
    got = load_state_dict(str(tmp_path))
    assert all(_same(got[k], t) for k, t in tensors.items())
    assert all(t.dtype == torch.bfloat16 for t in tensors.values())


def _write_raw(path, header, data=b""):
    blob = json.dumps(header).encode() if isinstance(header, dict) \
        else header
    path.write_bytes(struct.pack("<Q", len(blob)) + blob + data)


@pytest.mark.parametrize("case", ["dtype_i64", "offsets_past_end",
                                  "size_mismatch", "header_not_json",
                                  "truncated"])
def test_reader_refuses_malformed_files(tmp_path, case):
    path = tmp_path / "bad.safetensors"
    if case == "dtype_i64":
        save_file({"ids": torch.arange(4)}, str(path))
        match = "I64"
    elif case == "offsets_past_end":
        _write_raw(path, {"w": {"dtype": "F32", "shape": [2],
                                "data_offsets": [0, 8]}}, b"\0" * 4)
        match = "data_offsets"
    elif case == "size_mismatch":
        _write_raw(path, {"w": {"dtype": "F32", "shape": [3],
                                "data_offsets": [0, 8]}}, b"\0" * 8)
        match = "data_offsets"
    elif case == "header_not_json":
        _write_raw(path, b"{not json", b"")
        match = "JSON"
    else:
        path.write_bytes(b"\x01\x02")
        match = "too short"
    with pytest.raises(ValueError, match=match):
        read_safetensors(str(path))


def test_bin_fallback_equals_reference(tmp_path):
    rng = np.random.default_rng(5)
    part = {"a": torch.from_numpy(rng.standard_normal((4, 3))).bfloat16(),
            "b": torch.from_numpy(rng.standard_normal(6)).half(),
            "c": torch.from_numpy(rng.standard_normal((2, 2))).float()}
    torch.save(dict(list(part.items())[:2]), tmp_path / "pytorch_model-1.bin")
    torch.save({"c": part["c"]}, tmp_path / "pytorch_model-2.bin")
    got, ref = load_state_dict(str(tmp_path)), load_torch_state_dict(
        str(tmp_path))
    assert set(got) == set(ref) == set(part)
    for k, v in ref.items():
        assert got[k].dtype == torch.float32
        np.testing.assert_array_equal(got[k].numpy(), v)


def test_no_weights_raises_like_reference(tmp_path):
    (tmp_path / "config.json").write_text("{}")
    with pytest.raises(FileNotFoundError) as jexc:
        load_torch_state_dict(str(tmp_path))
    with pytest.raises(FileNotFoundError) as texc:
        load_state_dict(str(tmp_path))
    assert str(texc.value) == str(jexc.value)


# ---------------------------------------------------------------------------
# convert against the JAX package's
# ---------------------------------------------------------------------------

VARIANTS = {
    "gqa_head": ({}, True),
    "gqa_no_head_in_checkpoint": ({}, False),
    "mha_head": ({"num_kv_heads": 4}, True),
    "tied": ({"tie_embeddings": True}, False),
}


def _hf_state_dict(cfg, seed, with_head):
    rng = np.random.default_rng(seed)
    sd = {}
    for name, shape in chip_smoke.hf_llama_names(cfg).items():
        scale = 1.0 if name.endswith("norm.weight") else shape[-1] ** -0.5
        sd[name] = (rng.standard_normal(shape) * scale).astype(np.float32)
    if not with_head:
        del sd["lm_head.weight"]
    return sd


@pytest.mark.parametrize("src_dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("variant", sorted(VARIANTS))
def test_convert_equals_jax_convert(variant, src_dtype):
    overrides, with_head = VARIANTS[variant]
    tcfg = get_config("debug", dtype="float32", **overrides)
    jcfg = jax_get_config("debug", dtype="float32", **overrides)
    sd = _hf_state_dict(tcfg, 6, with_head)
    if src_dtype == "bfloat16":
        np_sd = {k: v.astype(ml_dtypes.bfloat16) for k, v in sd.items()}
        t_sd = {k: torch.from_numpy(v).bfloat16() for k, v in sd.items()}
    else:
        np_sd = sd
        t_sd = {k: torch.from_numpy(v) for k, v in sd.items()}
    for dtype in ("float32", "bfloat16"):
        want = bridge.tree_from_numpy(jax_convert(jcfg, np_sd, dtype=dtype))
        got = convert(tcfg, t_sd, dtype)
        assert ("head" in got) == (not tcfg.tie_embeddings)
        assert _flat(got).keys() == _flat(want).keys()
        for k, w in _flat(want).items():
            assert _same(_flat(got)[k], w), (k, dtype)
    if variant != "tied":
        # The layout the model takes (models/bridge.py's check).
        bridge.from_jax_numpy(tcfg, bridge.to_numpy(convert(tcfg, t_sd)))


def _flat(tree, prefix=""):
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_flat(v, f"{prefix}{k}."))
        return out
    return {prefix[:-1]: tree}


def test_convert_holds_no_view_of_the_checkpoint(tmp_path):
    # Same dtype in and out (BF16): every leaf must still be a copy of
    # its own, not a view of the mapped file.
    cfg = get_config("debug", param_dtype="bfloat16")
    tensors, _ = chip_smoke.write_hf_llama(torch, torch.device("cpu"), cfg,
                                           str(tmp_path), 1, 1)
    sd = load_state_dict(str(tmp_path))
    params = convert(cfg, sd, "bfloat16")
    for t in sd.values():
        t.fill_(0)     # the private map takes the write; the file keeps it
    want = bridge.tree_from_numpy(bridge.to_numpy(convert(
        cfg, load_state_dict(str(tmp_path)), "float32")))
    for k, w in _flat(want).items():
        assert torch.equal(_flat(params)[k].float(), w), k
    assert torch.equal(params["layers"]["attn"]["wq"][1],
                       tensors["model.layers.1.self_attn.q_proj.weight"].T)
    assert all(t.dtype == torch.bfloat16 for t in tree_leaves(params))


def test_tiny_hf_llama_logits_match_port_forward():
    transformers = pytest.importorskip("transformers")
    hf_cfg = transformers.LlamaConfig(
        vocab_size=128, hidden_size=64, intermediate_size=96,
        num_hidden_layers=2, num_attention_heads=4, num_key_value_heads=2,
        max_position_embeddings=64, rms_norm_eps=1e-5, rope_theta=10000.0,
        attention_bias=False, tie_word_embeddings=False)
    torch.manual_seed(0)
    hf = transformers.LlamaForCausalLM(hf_cfg).eval()
    cfg = get_config("debug", vocab_size=128, hidden_size=64,
                     intermediate_size=96, num_layers=2, num_heads=4,
                     num_kv_heads=2, head_dim=16, max_seq_len=64,
                     dtype="float32")
    tokens = torch.from_numpy(np.random.default_rng(0).integers(
        0, 128, (2, 12)))
    with torch.no_grad():
        want = hf(tokens).logits
        params = convert(cfg, hf.state_dict())
        got, _ = forward(cfg, params, tokens)
    torch.testing.assert_close(got, want, atol=1e-4, rtol=1e-4)


@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_family_of_matches_jax(name):
    assert family_of(CONFIGS[name]) == jax_family_of(JAX_CONFIGS[name])


@pytest.mark.parametrize("kv_heads,head_dim", [(1, 16), (4, 256)])
def test_tiny_hf_gemma_logits_match_port_forward(kv_heads, head_dim):
    """transformers' GemmaForCausalLM (RMSNorm's 1 + w, the embedding
    scaled by sqrt(hidden), tanh-gelu GeGLU, a tied head) at gemma-2b's
    one kv head and at gemma-7b's MHA with its head_dim of 256, norm
    weights drawn away from their zero init so that the converter's +1
    counts: the port's forward on the converted weights gives its
    logits."""
    transformers = pytest.importorskip("transformers")
    hf_cfg = transformers.GemmaConfig(
        vocab_size=128, hidden_size=64, intermediate_size=96,
        num_hidden_layers=2, num_attention_heads=4,
        num_key_value_heads=kv_heads, head_dim=head_dim,
        max_position_embeddings=64, rms_norm_eps=1e-6, rope_theta=10000.0,
        hidden_activation="gelu_pytorch_tanh")
    torch.manual_seed(0)
    hf = transformers.GemmaForCausalLM(hf_cfg).eval()
    with torch.no_grad():
        for name, t in hf.named_parameters():
            if name.endswith("norm.weight"):
                t.normal_(0.0, 0.5)
    cfg = get_config("gemma-2b", vocab_size=128, hidden_size=64,
                     intermediate_size=96, num_layers=2, num_heads=4,
                     num_kv_heads=kv_heads, head_dim=head_dim,
                     max_seq_len=64, dtype="float32")
    tokens = torch.from_numpy(np.random.default_rng(0).integers(
        0, 128, (2, 12)))
    with torch.no_grad():
        want = hf(tokens).logits
        sd = {k: v for k, v in hf.state_dict().items()
              if k != "lm_head.weight"}
        params = convert(cfg, sd)
        got, _ = forward(cfg, params, tokens)
    assert "head" not in params
    torch.testing.assert_close(got, want, atol=1e-4, rtol=1e-4)


def test_tiny_hf_mixtral_logits_match_port_forward():
    """tests/test_convert.py's Mixtral parity on the port: capacity
    factor 8.0 drops nothing, so the routed top-2 output is HF's (which
    has no capacity)."""
    transformers = pytest.importorskip("transformers")
    hf_cfg = transformers.MixtralConfig(
        vocab_size=128, hidden_size=64, intermediate_size=96,
        num_hidden_layers=2, num_attention_heads=4, num_key_value_heads=2,
        max_position_embeddings=64, rms_norm_eps=1e-5, rope_theta=10000.0,
        num_local_experts=4, num_experts_per_tok=2,
        tie_word_embeddings=False)
    torch.manual_seed(0)
    hf = transformers.MixtralForCausalLM(hf_cfg).eval()
    cfg = get_config("debug", vocab_size=128, hidden_size=64,
                     intermediate_size=96, num_layers=2, num_heads=4,
                     num_kv_heads=2, head_dim=16, max_seq_len=64,
                     dtype="float32", moe_num_experts=4, moe_top_k=2,
                     moe_capacity_factor=8.0)
    tokens = torch.from_numpy(np.random.default_rng(2).integers(
        0, 128, (2, 12)))
    with torch.no_grad():
        want = hf(tokens).logits
        params = convert(cfg, hf.state_dict())
        got, _ = forward(cfg, params, tokens)
    torch.testing.assert_close(got, want, atol=1e-4, rtol=1e-4)


@pytest.mark.parametrize("mode", ["int8", "int4"])
def test_convert_quantizes_like_jax_convert(mode):
    """convert(..., quantize=mode) packs the attention and MLP matrices
    layer by layer as it converts: codes, scales and every other leaf
    equal the reference's quantize-after-convert, in f32 and bf16."""
    from runbooks_tpu_torch.ops.quantization import QuantizedArray

    tcfg = get_config("debug", dtype="float32")
    jcfg = jax_get_config("debug", dtype="float32")
    sd = _hf_state_dict(tcfg, 7, True)
    t_sd = {k: torch.from_numpy(v) for k, v in sd.items()}
    for dtype in ("float32", "bfloat16"):
        want = jax_convert(jcfg, sd, dtype=dtype, quantize=mode)
        got = convert(tcfg, t_sd, dtype, quantize=mode)
        flat_w, flat_g = _flat(want), _flat(got)
        assert flat_g.keys() == flat_w.keys()
        for k, w in flat_w.items():
            g = flat_g[k]
            if k.split(".")[-1] in ("wq", "wk", "wv", "wo", "wi_gate",
                                    "wi_up"):
                assert isinstance(g, QuantizedArray), k
                assert (g.bits, g.block_size) == (w.bits, w.block_size)
                assert torch.equal(g.values,
                                   torch.from_numpy(np.array(w.values)))
                assert torch.equal(g.scales,
                                   torch.from_numpy(np.array(w.scales)))
            else:
                assert _same(g, bridge.tree_from_numpy({"x": w})["x"]), k


def test_unknown_quantize_mode_raises():
    with pytest.raises(ValueError, match="int3"):
        convert(get_config("debug"), {}, quantize="int3")
