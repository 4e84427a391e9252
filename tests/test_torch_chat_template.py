"""Chat templates rendered by the port's tokenizer
(``HFTokenizer.apply_chat_template``: jinja2 in transformers'
environment) against transformers' ``apply_chat_template`` on the same
directories: llama3-instruct's and llama2-chat's templates with and
without a system message, with ``add_generation_prompt`` both ways, the
``raise_exception`` path, and the environment's own pieces (``tojson``,
loop controls, trimmed blocks). Exact string
equality; with ``tokenize=True`` equal ids."""

import jinja2
import pytest

from runbooks_tpu_torch.train import data as port_data
from tests.test_torch_tokenizer import write_llama2_dir, write_llama3_dir

pytest.importorskip("transformers")

SYSTEM = {"role": "system", "content": "You answer in one line."}
TURNS = [
    {"role": "user", "content": "  What's a TPU?  "},
    {"role": "assistant", "content": "A matrix chip. "},
    {"role": "user", "content": "And an H100?\n中文 😀"},
]
# transformers' environment: trim_blocks, lstrip_blocks, loop controls,
# its tojson (no HTML escaping, indent, sort_keys).
FEATURES = """{% for m in messages %}
  {% if m['role'] == 'system' %}{% continue %}{% endif %}
  [{{ m['role'] }}] {{ m | tojson }}
  {{ m | tojson(indent=2, sort_keys=True) }}
  {% if loop.index > 2 %}{% break %}{% endif %}
{% endfor %}
{% if add_generation_prompt %}<{{ bos_token }}|{{ eos_token }}>{% endif %}
"""


@pytest.fixture(scope="module")
def pairs(tmp_path_factory):
    from runbooks_tpu.train.data import load_tokenizer as ref_load

    out = {}
    for kind, write in (("llama3", write_llama3_dir),
                        ("llama2", write_llama2_dir)):
        path = write(tmp_path_factory.mktemp(kind))
        out[kind] = (port_data.load_tokenizer(path), ref_load(path))
    return out


@pytest.mark.parametrize("kind", ["llama3", "llama2"])
@pytest.mark.parametrize("system", [False, True])
@pytest.mark.parametrize("gen", [False, True])
@pytest.mark.parametrize("n_turns", [1, 3])
def test_template_renders_as_transformers(pairs, kind, system, gen,
                                          n_turns):
    port, ref = pairs[kind]
    messages = ([SYSTEM] if system else []) + TURNS[:n_turns]
    want = ref.apply_chat_template(messages, tokenize=False,
                                   add_generation_prompt=gen)
    got = port.apply_chat_template(messages, tokenize=False,
                                   add_generation_prompt=gen)
    assert got == want
    assert port.apply_chat_template(messages, add_generation_prompt=gen) \
        == ref.apply_chat_template(messages, add_generation_prompt=gen)
    # The server's prompt ids: the rendered text through encode, with the
    # post-processor's BOS on top of the template's own.
    assert port.encode(got) == ref.encode(want)


@pytest.mark.parametrize("kind", ["llama3", "llama2"])
def test_template_environment_matches(pairs, kind):
    port, ref = pairs[kind]
    messages = [SYSTEM, {"role": "user", "content": "<b>&\"ü\"</b>"},
                {"role": "assistant", "content": "ok"},
                {"role": "user", "content": "last"}]
    for gen in (False, True):
        want = ref.apply_chat_template(messages, chat_template=FEATURES,
                                       tokenize=False,
                                       add_generation_prompt=gen)
        assert port.apply_chat_template(
            messages, chat_template=FEATURES, tokenize=False,
            add_generation_prompt=gen) == want


def test_raise_exception_raises_as_transformers(pairs):
    port, ref = pairs["llama2"]
    bad = [{"role": "user", "content": "a"}, {"role": "user", "content": "b"}]
    with pytest.raises(jinja2.exceptions.TemplateError) as ref_exc:
        ref.apply_chat_template(bad, tokenize=False)
    with pytest.raises(jinja2.exceptions.TemplateError) as port_exc:
        port.apply_chat_template(bad, tokenize=False)
    assert str(port_exc.value) == str(ref_exc.value)
    assert "alternate" in str(port_exc.value)


def test_sandbox_refuses_what_transformers_refuses(pairs):
    """The immutable sandbox: a template may not mutate its messages."""
    port, ref = pairs["llama3"]
    evil = "{{ messages.append({'role': 'x'}) }}"
    msgs = [{"role": "user", "content": "hi"}]
    with pytest.raises(jinja2.exceptions.SecurityError):
        ref.apply_chat_template(msgs, chat_template=evil, tokenize=False)
    with pytest.raises(jinja2.exceptions.SecurityError):
        port.apply_chat_template(msgs, chat_template=evil, tokenize=False)
    assert msgs == [{"role": "user", "content": "hi"}]


def test_no_template_raises_and_the_server_falls_back(tmp_path):
    """A tokenizer without a chat template raises; the server's chat route
    then takes the reference's plain role-prefix prompt."""
    import json
    import os

    from runbooks_tpu_torch.serve.api import _chat_prompt

    path = write_llama3_dir(tmp_path / "l3")
    cfg_path = os.path.join(path, "tokenizer_config.json")
    cfg = json.load(open(cfg_path))
    del cfg["chat_template"]
    json.dump(cfg, open(cfg_path, "w"))
    tok = port_data.load_tokenizer(path)
    with pytest.raises(ValueError, match="no chat template"):
        tok.apply_chat_template(TURNS, tokenize=False)
    assert _chat_prompt(tok, TURNS[:2]) == (
        "user:   What's a TPU?  \nassistant: A matrix chip. \nassistant:")
