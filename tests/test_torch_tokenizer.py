"""The port's tokenizer reader (runbooks_tpu_torch.models.tokenizer_io)
against the reference's ``runbooks_tpu.train.data.load_tokenizer`` (HF
transformers over the ``tokenizers`` crate) on directories written here
with ``tokenizers``: a llama3-style byte-level BPE with llama3's split
pattern, a GPT-2 ``ByteLevel`` one, and llama2-style byte-fallback BPEs
under ``LlamaTokenizerFast``'s config, in the legacy normalizer form and
in the Metaspace form. Ids, decoded text, vocab sizes and special ids
must be equal exactly, on a corpus of edge cases and on bounded
``hypothesis`` fuzz. The directory writers here serve the other
text-path tests too."""

import json
import os

import numpy as np
import pytest
from hypothesis import HealthCheck, given, settings
from hypothesis import strategies as st

from runbooks_tpu_torch.models import tokenizer_io
from runbooks_tpu_torch.train import data as port_data

tokenizers = pytest.importorskip("tokenizers")
pytest.importorskip("transformers")

LLAMA3_CHAT = (
    "{% set loop_messages = messages %}{% for message in loop_messages %}"
    "{% set content = '<|start_header_id|>' + message['role'] + "
    "'<|end_header_id|>\n\n'+ message['content'] | trim + '<|eot_id|>' %}"
    "{% if loop.index0 == 0 %}{% set content = bos_token + content %}"
    "{% endif %}{{ content }}{% endfor %}{% if add_generation_prompt %}"
    "{{ '<|start_header_id|>assistant<|end_header_id|>\n\n' }}{% endif %}")
LLAMA2_CHAT = (
    "{% if messages[0]['role'] == 'system' %}{% set loop_messages = "
    "messages[1:] %}{% set system_message = messages[0]['content'] %}"
    "{% else %}{% set loop_messages = messages %}{% set system_message = "
    "false %}{% endif %}{% for message in loop_messages %}{% if "
    "(message['role'] == 'user') != (loop.index0 % 2 == 0) %}{{ "
    "raise_exception('Conversation roles must alternate user/assistant/"
    "user/assistant/...') }}{% endif %}{% if loop.index0 == 0 and "
    "system_message != false %}{% set content = '<<SYS>>\\n' + "
    "system_message + '\\n<</SYS>>\\n\\n' + message['content'] %}{% else "
    "%}{% set content = message['content'] %}{% endif %}{% if "
    "message['role'] == 'user' %}{{ bos_token + '[INST] ' + "
    "content.strip() + ' [/INST]' }}{% elif message['role'] == "
    "'assistant' %}{{ ' '  + content.strip() + ' ' + eos_token }}"
    "{% endif %}{% endfor %}")
LLAMA3_SPECIALS = (["<|begin_of_text|>", "<|end_of_text|>"]
                   + [f"<|reserved_special_token_{i}|>" for i in range(4)]
                   + ["<|start_header_id|>", "<|end_header_id|>",
                      "<|reserved_special_token_4|>", "<|eot_id|>"])

# Edge cases of the split patterns, the normalizers, byte fallback and
# the added tokens.
CORPUS = [
    "Hello world! It's a test; they'll see. WE'RE HERE, I'M SURE, "
    "you'Ve 'Ll 'D 'T 'S.",
    "don't DON'T 'sx 'ſx a'ſ",
    "digits 1234567890 and 12 and 123456 x1y22z333w4444",
    "runs   of  spaces\tand\t\ttabs  \t mixed  ",
    "trailing space ",
    "  leading spaces",
    "lines\r\nwith\r\n\r\ncrlf\n\n\nand  \n  indents\n",
    "sep\x1cfile\x1dgroup\x1erecord\x1funit \x1c x",
    "中文字符和日本語のテキスト、한국어 텍스트。",
    "emoji 😀🎉👩\u200d💻 and astral 𝔘𝔫𝔦𝔠𝔬𝔡𝔢 𐍈",
    "combining e\u0301 a\u0308 n\u0303 ǅ Ωμέγα",
    "specials <|begin_of_text|> inside <|eot_id|>text<s> and </s> <unk>",
    "rare ˣ ₿ ⅝ ⑦ ꙮ 𓀀 chars",
    "code: def f(x):\n    return x**2  # comment\n",
    "nbsp\xa0here\u2003em\u3000ideo\u2028line\u2029para\x85nel",
    "",
    " ",
    "\n",
    "a",
    "'",
    "'s",
]


def _train_corpus():
    """A few KB of seeded text in several scripts to train merges on."""
    rng = np.random.default_rng(0)
    words = ("the model trains on packed rows of text with lora adapters "
             "and checkpoints every step kernel hopper tile warp token "
             "tokenizer server chat template it's they're don't 2024 "
             "1234 中文 字符 日本語 😀 ñandú café").split()
    lines = list(CORPUS)
    for _ in range(300):
        n = int(rng.integers(3, 20))
        lines.append(" ".join(rng.choice(words, size=n)))
    return lines


def _byte_level_bpe(vocab_size, pre_tokenizer, ignore_merges):
    from tokenizers import Tokenizer, decoders, models, pre_tokenizers
    from tokenizers.trainers import BpeTrainer

    tok = Tokenizer(models.BPE(ignore_merges=ignore_merges))
    tok.pre_tokenizer = pre_tokenizer
    tok.decoder = decoders.ByteLevel()
    trainer = BpeTrainer(
        vocab_size=vocab_size, show_progress=False,
        initial_alphabet=pre_tokenizers.ByteLevel.alphabet())
    tok.train_from_iterator(_train_corpus(), trainer)
    return tok


def _write(path, tok_json, config):
    os.makedirs(path, exist_ok=True)
    with open(os.path.join(path, "tokenizer.json"), "w",
              encoding="utf-8") as f:
        f.write(tok_json)
    with open(os.path.join(path, "tokenizer_config.json"), "w",
              encoding="utf-8") as f:
        json.dump(config, f, ensure_ascii=False)
    return str(path)


def write_llama3_dir(path, vocab_size=1200):
    """A llama3-style directory: byte-level BPE with llama3's split
    pattern and ignore_merges, specials named as llama3 names them,
    <|begin_of_text|> prepended by TemplateProcessing, llama3-instruct's
    chat template, clean_up_tokenization_spaces on."""
    from tokenizers import AddedToken, Regex, pre_tokenizers, processors

    pre = pre_tokenizers.Sequence([
        pre_tokenizers.Split(Regex(tokenizer_io.LLAMA3_PATTERN),
                             behavior="isolated", invert=False),
        pre_tokenizers.ByteLevel(add_prefix_space=False, use_regex=False)])
    tok = _byte_level_bpe(vocab_size, pre, ignore_merges=True)
    tok.add_special_tokens([AddedToken(s, special=True, normalized=False)
                            for s in LLAMA3_SPECIALS])
    # A non-special added token, one that takes the white space beside it,
    # and one matched on the normalized text.
    tok.add_tokens([AddedToken("ñandú café", special=False,
                               normalized=False),
                    AddedToken("<mask>", special=False, normalized=False,
                               lstrip=True, rstrip=True),
                    AddedToken("zq", special=False, normalized=True)])
    bos = tok.token_to_id("<|begin_of_text|>")
    tok.post_processor = processors.Sequence([
        processors.ByteLevel(trim_offsets=False),
        processors.TemplateProcessing(
            single="<|begin_of_text|> $A",
            pair="<|begin_of_text|> $A <|begin_of_text|> $B:1",
            special_tokens=[("<|begin_of_text|>", bos)])])
    return _write(path, tok.to_str(), {
        "tokenizer_class": "PreTrainedTokenizerFast",
        "bos_token": "<|begin_of_text|>", "eos_token": "<|eot_id|>",
        "clean_up_tokenization_spaces": True,
        "model_max_length": 1000000, "chat_template": LLAMA3_CHAT})


def write_gpt2_dir(path, vocab_size=900):
    """A GPT-2-style directory: ByteLevel pre-tokenizer with its own
    regex, no ignore_merges, <|endoftext|> as bos/eos/unk."""
    from tokenizers import AddedToken, pre_tokenizers, processors

    pre = pre_tokenizers.ByteLevel(add_prefix_space=False, use_regex=True)
    tok = _byte_level_bpe(vocab_size, pre, ignore_merges=False)
    tok.add_special_tokens([AddedToken("<|endoftext|>", special=True,
                                       normalized=False)])
    tok.post_processor = processors.ByteLevel(trim_offsets=True)
    return _write(path, tok.to_str(), {
        "tokenizer_class": "GPT2TokenizerFast",
        "bos_token": "<|endoftext|>", "eos_token": "<|endoftext|>",
        "unk_token": "<|endoftext|>", "add_prefix_space": False,
        "clean_up_tokenization_spaces": False,
        "model_max_length": 1024})


def write_llama2_dir(path, vocab_size=1000, form="legacy"):
    """A llama2-style directory: byte-fallback BPE over sentencepiece
    pieces (<unk>, <s>, </s>, <0x00>..<0xFF>, then pieces trained with a
    limited alphabet, so rare characters take the byte fallback), under
    LlamaTokenizerFast's config with llama2-chat's template. ``form``
    "legacy" is llama2's own tokenizer.json (Prepend + Replace
    normalizers, no pre-tokenizer); "metaspace" the Metaspace
    pre-tokenizer with prepend_scheme "first"."""
    from tokenizers import (Tokenizer, decoders, models, normalizers,
                            pre_tokenizers)
    from tokenizers.trainers import BpeTrainer

    trainer_tok = Tokenizer(models.BPE())
    trainer_tok.pre_tokenizer = pre_tokenizers.Metaspace(
        replacement="▁", prepend_scheme="always", split=True)
    trainer = BpeTrainer(vocab_size=vocab_size - 259, show_progress=False,
                         limit_alphabet=120)
    trainer_tok.train_from_iterator(_train_corpus(), trainer)
    trained = json.loads(trainer_tok.to_str())["model"]
    vocab = {"<unk>": 0, "<s>": 1, "</s>": 2}
    vocab.update({f"<0x{b:02X}>": 3 + b for b in range(256)})
    for piece, _ in sorted(trained["vocab"].items(), key=lambda kv: kv[1]):
        vocab.setdefault(piece, len(vocab))
    model = models.BPE(vocab=vocab, merges=[tuple(m) if isinstance(
        m, list) else tuple(m.split(" ")) for m in trained["merges"]],
        unk_token="<unk>", fuse_unk=True, byte_fallback=True)
    tok = Tokenizer(model)
    strip = [decoders.Replace("▁", " "), decoders.ByteFallback(),
             decoders.Fuse(), decoders.Strip(content=" ", left=1, right=0)]
    if form == "legacy":
        tok.normalizer = normalizers.Sequence([
            normalizers.Prepend("▁"), normalizers.Replace(" ", "▁")])
    else:
        tok.pre_tokenizer = pre_tokenizers.Metaspace(
            replacement="▁", prepend_scheme="first", split=False)
    tok.decoder = decoders.Sequence(strip)
    from tokenizers import AddedToken

    tok.add_special_tokens([AddedToken(s, special=True, normalized=False)
                            for s in ("<unk>", "<s>", "</s>")])
    return _write(path, tok.to_str(), {
        "tokenizer_class": "LlamaTokenizerFast",
        "bos_token": "<s>", "eos_token": "</s>", "unk_token": "<unk>",
        "pad_token": None, "add_bos_token": True, "add_eos_token": False,
        "clean_up_tokenization_spaces": False, "legacy": False,
        "model_max_length": 1000000000000000019884624838656,
        "chat_template": LLAMA2_CHAT})


KINDS = {
    "llama3": write_llama3_dir,
    "gpt2": write_gpt2_dir,
    "llama2": write_llama2_dir,
    "llama2_metaspace": lambda p: write_llama2_dir(p, form="metaspace"),
}


@pytest.fixture(scope="module")
def pairs(tmp_path_factory):
    """{kind: (port tokenizer, reference tokenizer)} on one directory."""
    from runbooks_tpu.train.data import load_tokenizer as ref_load

    out = {}
    for kind, write in KINDS.items():
        path = write(tmp_path_factory.mktemp(kind))
        out[kind] = (port_data.load_tokenizer(path), ref_load(path))
    return out


def _same(port, ref, text):
    for special in (True, False):
        for split in (False, True):
            want = ref.encode(text, add_special_tokens=special,
                              split_special_tokens=split)
            got = port.encode(text, add_special_tokens=special,
                              split_special_tokens=split)
            assert got == want, (text, special, split)
    ids = ref.encode(text)
    for skip in (False, True):
        assert port.decode(ids, skip_special_tokens=skip) == ref.decode(
            ids, skip_special_tokens=skip), (text, skip)


@pytest.mark.parametrize("kind", list(KINDS))
def test_corpus_ids_and_text_equal_the_reference(pairs, kind):
    port, ref = pairs[kind]
    for text in CORPUS + ["".join(CORPUS)]:
        _same(port, ref, text)


@pytest.mark.parametrize("kind", list(KINDS))
def test_vocab_sizes_and_special_ids_equal_the_reference(pairs, kind):
    port, ref = pairs[kind]
    assert port.vocab_size == ref.vocab_size
    assert len(port) == len(ref)
    for attr in ("bos_token_id", "eos_token_id", "pad_token_id",
                 "unk_token_id", "bos_token", "eos_token"):
        assert getattr(port, attr) == getattr(ref, attr), attr
    assert port.special_tokens_map == ref.special_tokens_map
    ids = list(range(len(ref))) + [len(ref) + 5]
    assert port.convert_ids_to_tokens(ids[:-1]) == \
        ref.convert_ids_to_tokens(ids[:-1])


@pytest.mark.parametrize("kind", list(KINDS))
def test_every_single_id_decodes_as_the_reference(pairs, kind):
    """Each id alone (cut UTF-8 sequences, lone byte tokens, the
    decoder's strip on a leading space) and consecutive pairs."""
    port, ref = pairs[kind]
    n = len(ref)
    for i in range(n):
        assert port.decode([i]) == ref.decode([i]), i
    rng = np.random.default_rng(1)
    for _ in range(300):
        ids = [int(x) for x in rng.integers(0, n, size=int(
            rng.integers(2, 12)))]
        for skip in (False, True):
            assert port.decode(ids, skip_special_tokens=skip) == ref.decode(
                ids, skip_special_tokens=skip), ids


@pytest.mark.parametrize("kind", list(KINDS))
@settings(max_examples=150, deadline=None,
          suppress_health_check=[HealthCheck.function_scoped_fixture])
@given(text=st.text(max_size=48))
def test_fuzz_ids_and_text_equal_the_reference(pairs, kind, text):
    port, ref = pairs[kind]
    _same(port, ref, text)


# Characters where the split patterns, the normalizers and the added
# tokens turn: contractions in both cases, digits, white space that is and
# is not Unicode's, sentencepiece's space and the added tokens' text.
_EDGES = st.lists(st.sampled_from(
    list(" \t\n\r\x0b\x1c\x1f\x85\xa0\u3000'sStTdDlLmMvVrReE\u017f"
         "0123456789\u0663.,!?\u4e2d\U0001f600e\u0301\u2581<>|_x")
    + ["<|eot_id|>", "<s>", "</s>", "<mask>", "zq",
       "\u00f1and\u00fa caf\u00e9"]),
    max_size=40).map("".join)


@pytest.mark.parametrize("kind", list(KINDS))
@settings(max_examples=150, deadline=None,
          suppress_health_check=[HealthCheck.function_scoped_fixture])
@given(text=_EDGES)
def test_fuzz_edge_characters_equal_the_reference(pairs, kind, text):
    port, ref = pairs[kind]
    _same(port, ref, text)


@pytest.mark.parametrize("kind", list(KINDS))
def test_round_trip_is_exact(pairs, kind):
    """decode(encode(t)) == t wherever the reference round-trips too."""
    port, ref = pairs[kind]
    for text in CORPUS:
        ids = port.encode(text, add_special_tokens=False)
        got = port.decode(ids, clean_up_tokenization_spaces=False)
        want = ref.decode(ids, clean_up_tokenization_spaces=False)
        assert got == want
        if kind.startswith("llama2"):
            continue   # sentencepiece drops a leading space by design
        assert got == text


def test_token_bytes_spell_the_stream(pairs):
    """Concatenated token_bytes are the decoded bytes without the special
    tokens, for every kind: byte-level ids through the byte map,
    byte-fallback pieces with their space (the decoder strips only the
    stream's first)."""
    for kind, (port, _) in pairs.items():
        for text in CORPUS:
            ids = port.encode(text, add_special_tokens=False)
            data = b"".join(port.token_bytes(i) or b"" for i in ids)
            want = port.decode(ids, skip_special_tokens=True,
                               clean_up_tokenization_spaces=False)
            if kind.startswith("llama2") and data.startswith(b" "):
                data = data[1:]
            if kind.startswith("llama2") and text.startswith(" "):
                # The legacy form adds a second space the decoder strips.
                continue
            assert data.decode("utf-8", errors="replace") == want, (kind,
                                                                    text)


def test_unsupported_directories_raise_by_name(tmp_path):
    from runbooks_tpu_torch.models.tokenizer_io import TokenizerFormatError

    only_sp = tmp_path / "sp"
    only_sp.mkdir()
    (only_sp / "tokenizer.model").write_bytes(b"\x0a\x00")
    with pytest.raises(TokenizerFormatError, match="sentencepiece"):
        tokenizer_io.load(str(only_sp))
    base = json.loads(open(os.path.join(
        write_gpt2_dir(tmp_path / "g"), "tokenizer.json")).read())
    cases = [
        ("model", {"type": "WordPiece", "vocab": {}}, "WordPiece"),
        ("pre_tokenizer", {"type": "Whitespace"}, "Whitespace"),
        ("normalizer", {"type": "NFKC"}, "NFKC"),
        ("pre_tokenizer", {"type": "Split", "pattern": {"Regex": r"\w+"},
                           "behavior": "Isolated", "invert": False},
         "split pattern"),
        ("decoder", {"type": "WordPiece"}, "WordPiece"),
        ("post_processor", {"type": "BertProcessing"}, "BertProcessing"),
    ]
    for i, (key, value, match) in enumerate(cases):
        spec = dict(base)
        spec[key] = value
        path = tmp_path / f"bad{i}"
        _write(path, json.dumps(spec), {})
        with pytest.raises(TokenizerFormatError, match=match):
            tokenizer_io.load(str(path))
    path = tmp_path / "cls"
    _write(path, json.dumps(base), {"tokenizer_class": "T5TokenizerFast"})
    with pytest.raises(TokenizerFormatError, match="T5TokenizerFast"):
        tokenizer_io.load(str(path))
