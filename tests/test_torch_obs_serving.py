"""The port's server telemetry against the JAX server's, on the same
bridged weights and the same requests (as tests/test_torch_serve_api.py
pairs them): the /metrics families (name, type, label keys) are the
reference's but for the ones named below with their reasons, every count
is equal (requests, tokens, decode steps, prefix lookups and hits,
speculation, grammar, each histogram's _count), one request's flight
timeline has the reference's span names in order, and the /debug routes
answer with the reference's shape."""

import json

import jax
import numpy as np
import pytest
import torch

from runbooks_tpu.models.config import get_config as jax_get_config
from runbooks_tpu.models.transformer import init_params as jax_init_params
from runbooks_tpu.obs import flight as ref_flight
from runbooks_tpu.obs import incident as ref_incident
from runbooks_tpu.obs import metrics as ref_metrics
from runbooks_tpu.serve.api import create_server as jax_create_server
from runbooks_tpu.train.data import ByteTokenizer as JaxByteTokenizer
from runbooks_tpu_torch.models import bridge
from runbooks_tpu_torch.models.config import get_config
from runbooks_tpu_torch.obs import flight, incident, metrics
from runbooks_tpu_torch.serve import api
from runbooks_tpu_torch.train.data import ByteTokenizer
from tests.test_obs import lint_exposition
from tests.test_torch_grammar import SCHEMA_RF
from tests.test_torch_serve_api import _call, _JaxServer, _TorchServer

torch.set_num_threads(2)

MAX_SEQ = 64
PREFIX = "You are a terse assistant. Answer briefly, please."
BODIES = [
    ("/v1/completions", {"prompt": "the kernel of a tile", "max_tokens": 8,
                         "temperature": 0}),
    ("/v1/completions", {"prompt": "abcabcabcabc", "max_tokens": 10,
                         "temperature": 0, "stream": True}),
    ("/v1/completions", {"prompt": "json:", "max_tokens": 24,
                         "temperature": 0, "response_format": SCHEMA_RF}),
    ("/v1/prefix", {"prompt": PREFIX}),
    ("/v1/completions", {"prompt": PREFIX + " Why?", "max_tokens": 6,
                         "temperature": 0}),
    ("/v1/completions", {"prompt": ["one two", "three four five"],
                         "max_tokens": 5, "temperature": 0}),
]
TRACED = "trace-me-1"

# The name prefixes of the families a server registers: its own serve_*,
# the compile sentinel's xla_*, the flight ring's and the process's. The
# process-wide reference registry also holds what other reference code
# left running in the same process records (test_fleet.py's scraper
# sweeps: controller_*, fleet_history_*), so both sides are compared on
# these prefixes alone.
SERVER_PREFIXES = ("serve_", "xla_", "flight_", "process_")
# Families one server exports and the other does not, each with its
# reason. Everything else must match in name, type and label keys.
ONLY_REFERENCE = {
    # The reference times each XLA compile; on the CPU the port builds no
    # kernel (no nvcc), so it has no build to time.
    "xla_compile_seconds",
}
ONLY_PORT: set = set()


def _zero_init(reg) -> None:
    """What each package's sentinel install() puts in a fresh registry."""
    reg.inc("xla_compilations_total", 0.0)
    reg.inc("xla_unexpected_compiles_total", 0.0)


@pytest.fixture(scope="module")
def servers():
    jcfg = jax_get_config("debug", dtype="float32")
    jparams = jax_init_params(jcfg, jax.random.key(0))
    tcfg = get_config("debug", dtype="float32")
    tparams = bridge.from_jax_numpy(tcfg, jax.tree.map(np.asarray, jparams))
    for reg in (metrics.REGISTRY, ref_metrics.REGISTRY):
        reg.reset()
        _zero_init(reg)
    for ring, mgr in ((flight.RING, incident.MANAGER),
                      (ref_flight.RING, ref_incident.MANAGER)):
        ring.clear()
        mgr.reset()
    kw = dict(max_slots=2, max_seq_len=MAX_SEQ, grammar="on",
              speculative="ngram")
    jax_srv = torch_srv = None
    try:
        jax_srv = _JaxServer(jax_create_server(
            jcfg, jparams, JaxByteTokenizer(), **kw))
        torch_srv = _TorchServer(api.create_server(
            tcfg, tparams, ByteTokenizer(), host="127.0.0.1", port=0,
            device="cpu", **kw))
        answers = []
        for path, body in BODIES:
            answers.append([_call(s.base, path, body)
                            for s in (jax_srv, torch_srv)])
        answers.append([_call(s.base, "/v1/completions",
                              {"prompt": "hello there", "max_tokens": 5,
                               "temperature": 0},
                              {"X-Request-Id": TRACED})
                        for s in (jax_srv, torch_srv)])
        yield jax_srv, torch_srv, answers
    finally:
        for s in (torch_srv, jax_srv):
            if s is not None:
                s.close()


def _families(text):
    """{name: (type, label keys)} of the server families in an
    exposition (names under SERVER_PREFIXES)."""
    out = {}
    for name, fam in ref_metrics.parse_exposition(text).items():
        if not name.startswith(SERVER_PREFIXES):
            continue
        keys = set()
        for labels in list(fam.samples) + list(fam.histograms):
            keys |= {k for k, _ in labels}
        out[name] = (fam.type, frozenset(keys))
    return out


def _scrape(servers):
    jax_srv, torch_srv, _ = servers
    (js, jh, jt), (ts, th, tt) = [_call(s.base, "/metrics")
                                  for s in (jax_srv, torch_srv)]
    assert js == ts == 200
    assert th["Content-Type"] == jh["Content-Type"] == metrics.CONTENT_TYPE
    return jt, tt


def test_answers_are_the_references(servers):
    for (js, _, jt), (ts, _, tt) in servers[2]:
        assert js == ts == 200, (jt, tt)
        if jt.startswith("data:"):
            continue
        j, t = json.loads(jt), json.loads(tt)
        if "choices" in j:
            assert [c["text"] for c in t["choices"]] == \
                [c["text"] for c in j["choices"]]
            assert t["usage"] == j["usage"]
        else:
            assert t == j


def test_metric_families_equal_the_references(servers):
    jt, tt = _scrape(servers)
    lint_exposition(tt)
    ref, port = _families(jt), _families(tt)
    assert {"serve_requests_total", "serve_ttft_seconds",
            "flight_ring_events", "process_uptime_seconds"} <= set(port)
    assert set(ref) - set(port) == ONLY_REFERENCE
    assert set(port) - set(ref) == ONLY_PORT
    for name in set(ref) & set(port):
        assert port[name] == ref[name], name


def test_metric_families_ignore_other_reference_code(servers):
    """What other reference code left running in this process records
    into the reference's process-wide registry after the fixture's reset
    (test_fleet.py's scraper sweeps) is not the server's: the families
    still equal the references (the order-dependent failure this
    comparison once had)."""
    ref_metrics.REGISTRY.set_gauge("fleet_history_series", 3)
    ref_metrics.REGISTRY.set_gauge("fleet_history_points", 30)
    ref_metrics.REGISTRY.observe("controller_fleet_scrape_seconds", 0.01)
    test_metric_families_equal_the_references(servers)


COUNTERS = ("serve_requests_total", "serve_requests_failed_total",
            "serve_requests_rejected_total", "serve_tokens_generated_total",
            "serve_decode_steps_total", "serve_prefix_lookups_total",
            "serve_prefix_hits_total", "serve_prefix_tokens_reused_total",
            "serve_spec_drafted_total", "serve_spec_accepted_total",
            "serve_grammar_requests_total", "serve_deadline_expired_total",
            "serve_grammar_cache_hits_total",
            "serve_grammar_cache_misses_total")


def test_every_count_equals_the_references(servers):
    jt, tt = _scrape(servers)
    ref = metrics.parse_exposition(jt)
    port = metrics.parse_exposition(tt)
    for name in COUNTERS:
        assert port[name].samples == ref[name].samples, name
    assert port["serve_requests_total"].total() == 7
    usage = sum(json.loads(t)["usage"]["completion_tokens"]
                for _, (_, _, t) in servers[2]
                if t.startswith("{") and "usage" in json.loads(t))
    streamed = sum(1 for _, (_, _, t) in servers[2] if t.startswith("data:"))
    assert streamed == 1
    assert port["serve_tokens_generated_total"].total() == usage + 10
    assert port["serve_spec_drafted_total"].total() > 0
    assert port["serve_prefix_hits_total"].total() == 1
    hist = [n for n, f in ref.items() if f.type == "histogram"
            and n.startswith("serve_")]
    assert len(hist) >= 9
    for name in hist:
        counts = {k: h.count for k, h in port[name].histograms.items()}
        assert counts == {k: h.count
                          for k, h in ref[name].histograms.items()}, name
    assert port["serve_ttft_seconds"].merged_histogram().count == 7


def test_one_requests_timeline_has_the_references_spans(servers):
    jax_srv, torch_srv, _ = servers
    got = {}
    for name, srv in (("ref", jax_srv), ("port", torch_srv)):
        status, _, text = _call(srv.base, f"/debug/flight?request_id="
                                          f"{TRACED}")
        assert status == 200
        body = json.loads(text)
        assert body["component"] == "serve" and body["pid"] > 0
        got[name] = [(e["name"], sorted(e.get("args", {})))
                     for e in body["events"]]
    assert got["port"] == got["ref"]
    assert [n for n, _ in got["port"]][:2] == ["queue_wait", "prefill"]


def test_debug_routes_answer_as_the_references(servers, tmp_path,
                                               monkeypatch):
    jax_srv, torch_srv, _ = servers
    (js, _, jt), (ts, _, tt) = [_call(s.base, "/debug/programs")
                                for s in (jax_srv, torch_srv)]
    assert js == ts == 200
    j, t = json.loads(jt), json.loads(tt)
    assert set(t) == set(j)
    assert t["tokenizer_fingerprint"] == j["tokenizer_fingerprint"]
    # Speculation's economics (wall seconds aside) are the reference's.
    for spec in (t["speculative"], j["speculative"]):
        for bucket in spec["tokens_per_sec_by_accept_rate"].values():
            bucket.pop("seconds")
            bucket.pop("tokens_per_sec")
    assert t["speculative"] == j["speculative"]
    assert set(t["compiles"]) == set(j["compiles"])
    assert {p["name"] for p in t["programs"]} >= {
        "prefill", "prefill_prefix", "prefix_build", "decode_v64",
        "verify_v64"}
    status, _, text = _call(torch_srv.base, "/debug/memory")
    assert status == 200
    mem = json.loads(text)
    assert mem["tensors"]["by_category"]["weights"] > 0
    assert mem["kv_occupancy"]["slots_total"] == 2
    monkeypatch.setenv("RBT_CONTENT_DIR", str(tmp_path))
    first = json.loads(_call(torch_srv.base, "/debug/incident",
                             {"reason": "slo"})[2])
    again = json.loads(_call(torch_srv.base, "/debug/incident",
                             {"reason": "slo"})[2])
    assert first["debounced"] is False and again == {"path": None,
                                                     "debounced": True}
    listed = json.loads(_call(torch_srv.base, "/debug/incidents")[2])
    assert [e["reason"] for e in listed["incidents"]] == ["slo"]
    name = listed["incidents"][0]["name"]
    bundle = json.loads(_call(torch_srv.base,
                              f"/debug/incidents?name={name}")[2])
    assert bundle["reason"] == "slo" and bundle["component"] == "serve"
    assert _call(torch_srv.base, "/debug/incidents?name=nope")[0] == 404
    prof = _call(torch_srv.base, "/debug/profile?seconds=0.2", {})
    assert prof[0] == 200
    assert json.loads(prof[2])["path"].startswith(str(tmp_path))
    assert _call(torch_srv.base, "/debug/profile?seconds=x", {})[0] == 400
    assert _call(torch_srv.base, "/debug/memory", {})[0] == 405

