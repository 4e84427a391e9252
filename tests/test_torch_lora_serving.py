"""The port's multi-tenant LoRA serving (the adapter pool in the dense
engine, the paged engine, the verify forward and the HTTP server) against
the JAX package's pooled engines and the port's own merged-weights
engines.

A tiny llama config at float32 (the reference test's, 4 adapters), the
reference's weights carried over by models/bridge.py, and four adapters
built from seeded numpy A/B and written once per side by each side's own
``save_adapter``. At f32 the pooled delta ``x@W + (x@A)@B`` and the fold
``x@(W + s·A·B)`` agree to rounding, so greedy ids must be identical to
the JAX pooled engines' and to dedicated engines over the folded weights;
base-only rows must equal the port's no-pool engine's bit for bit (the
trash lane's delta is exactly zero). Also the reference test file's cases:
eviction and page-back-in, refcount pins across finish, preemption and
deadlines, 400s, 429 on exhaustion, rank padding, a malformed artifact,
radix namespaces, the HTTP ``adapter`` field and ``load_model``'s fold
when the pool is off.
"""

import dataclasses
import json
import os
import threading
import urllib.error
import urllib.request

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from runbooks_tpu.models.config import get_config as jax_get_config
from runbooks_tpu.models.transformer import init_params as jax_init_params
from runbooks_tpu.serve import lora_pool as jax_lora_pool
from runbooks_tpu.serve.engine import InferenceEngine as JaxEngine
from runbooks_tpu.serve.engine import Request as JaxRequest
from runbooks_tpu.serve.paging import PagedInferenceEngine as JaxPaged

from runbooks_tpu_torch.models import bridge
from runbooks_tpu_torch.models.config import get_config
from runbooks_tpu_torch.ops.lora import target_dims
from runbooks_tpu_torch.serve import api, lora_pool
from runbooks_tpu_torch.serve.engine import (
    EngineOverloaded,
    InferenceEngine,
    Request,
)
from runbooks_tpu_torch.serve.paging import PagedInferenceEngine

torch.set_num_threads(2)

TINY = dict(vocab_size=128, hidden_size=64, intermediate_size=128,
            num_layers=2, num_heads=4, num_kv_heads=2, head_dim=16,
            max_seq_len=64, dtype="float32", param_dtype="float32",
            adapter_pool=4, lora_rank=8)
N = 4
PROMPTS = [[5, 9, 17], [3, 4, 5, 6, 7], [40, 2], [8, 8, 8, 9]]
HTTP_TIMEOUT = 120


def _np_adapter(cfg, rank, seed, targets=None):
    rng = np.random.default_rng(seed)
    out = {}
    for t in targets or cfg.lora_targets:
        d_in, d_out = target_dims(cfg, t)
        out[t] = {
            "a": (rng.standard_normal((cfg.num_layers, d_in, rank))
                  * d_in ** -0.5).astype(np.float32),
            "b": (0.05 * rng.standard_normal(
                (cfg.num_layers, rank, d_out))).astype(np.float32)}
    return out


def _save_both(root, name, tree, rank, alpha):
    jpath = os.path.join(root, "jax", name)
    tpath = os.path.join(root, "torch", name)
    jax_lora_pool.save_adapter(
        jpath, {t: {k: jnp.asarray(v) for k, v in ab.items()}
                for t, ab in tree.items()}, rank=rank, alpha=alpha)
    lora_pool.save_adapter(
        tpath, {t: {k: torch.from_numpy(v) for k, v in ab.items()}
                for t, ab in tree.items()}, rank=rank, alpha=alpha)
    return jpath, tpath


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    """Both sides' configs and weights, four rank-4 adapters saved by each
    side (tenant0..3 under root/jax and root/torch), and the port's
    merged-weights params per adapter."""
    jcfg = dataclasses.replace(jax_get_config("llama2-7b"), **TINY)
    tcfg = dataclasses.replace(get_config("llama2-7b"), **TINY)
    jparams = jax_init_params(jcfg, jax.random.key(0))
    tparams = bridge.from_jax_numpy(tcfg, jax.tree.map(np.asarray, jparams))
    root = str(tmp_path_factory.mktemp("adapters"))
    jpaths, tpaths, merged = [], [], []
    for i in range(N):
        jp, tp = _save_both(root, f"tenant{i}", _np_adapter(tcfg, 4, 10 + i),
                            rank=4, alpha=8.0)
        jpaths.append(jp)
        tpaths.append(tp)
        merged.append(lora_pool.load_merge_adapter(tp, tcfg, tparams))
    return dict(jcfg=jcfg, tcfg=tcfg, jparams=jparams, tparams=tparams,
                root=root, jpaths=jpaths, tpaths=tpaths, merged=merged)


def _drain(eng, reqs):
    for r in reqs:
        eng.submit(r)
    while eng.has_work():
        eng.step()
    return [list(r.output_tokens) for r in reqs]


def _reqs(cls, adapters, prompts=PROMPTS, max_tokens=8, **kw):
    return [cls(prompt_tokens=list(p), max_tokens=max_tokens,
                temperature=0.0, adapter=a, **kw)
            for p, a in zip(prompts, adapters)]


def _merged_ids(world, i, prompt, max_tokens=8):
    eng = InferenceEngine(world["tcfg"], world["merged"][i], max_slots=2)
    return _drain(eng, [Request(prompt_tokens=list(prompt),
                                max_tokens=max_tokens)])[0]


def _port(world, cls="dense", **kw):
    kw.setdefault("max_slots", N)
    if cls == "paged":
        return PagedInferenceEngine(world["tcfg"], world["tparams"],
                                    page_size=8, **kw)
    return InferenceEngine(world["tcfg"], world["tparams"], **kw)


# ---------------------------------------------------------------------------
# Heterogeneous batches: JAX pooled engines and merged weights
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("cls", ["dense", "paged"])
def test_heterogeneous_batch_matches_jax_and_merged(world, cls):
    """Four tenants in one admission tick: one prefill dispatch carries
    every lane; greedy ids equal the JAX pooled engine's and each
    tenant's merged-weights engine's; the pool's counters equal JAX's."""
    eng = _port(world, cls)
    lanes_seen = []
    prefill = eng._paged_prefill if cls == "paged" else eng._prefill

    def recording(*args, **kw):
        lanes_seen.append(kw["adapters"][1].tolist())
        return prefill(*args, **kw)

    if cls == "paged":
        eng._paged_prefill = recording
    else:
        eng._prefill = recording
    reqs = _reqs(Request, world["tpaths"])
    for r in reqs:
        eng.submit(r)
    eng.step()
    assert int(eng.active.sum()) == N
    assert len(lanes_seen) == 1 and sorted(lanes_seen[0]) == [0, 1, 2, 3]
    while eng.has_work():
        eng.step()
    got = [r.output_tokens for r in reqs]
    jcls = JaxPaged if cls == "paged" else JaxEngine
    jeng = jcls(world["jcfg"], world["jparams"], max_slots=N,
                **({"page_size": 8} if cls == "paged" else {}))
    want = _drain(jeng, _reqs(JaxRequest, world["jpaths"]))
    assert got == want
    for i, p in enumerate(PROMPTS):
        assert got[i] == _merged_ids(world, i, p), i
    base = _drain(_port(world, adapter_pool=0),
                  _reqs(Request, [None] * N))
    assert got != base                     # the adapters change the model
    tstats, jstats = eng.adapter_stats(), jeng.adapter_stats()
    for k in ("loads", "evictions", "hits", "pool_size", "rank"):
        assert tstats[k] == jstats[k], k
    assert tstats["loads"] == N and tstats["evictions"] == 0
    assert sorted(tstats["resident"]) == sorted(world["tpaths"])
    assert list(tstats["requests"].values()) == [1] * N


@pytest.mark.parametrize("cls", ["dense", "paged"])
def test_base_rows_are_bitwise_the_no_pool_engines(world, cls):
    """Base-only rows beside tenant rows in one batch (the trash lane)
    give the no-pool engine's ids, and their first-token logits are equal
    bit for bit; the tenant rows give their merged engines' ids."""
    adapters = [world["tpaths"][0], None, world["tpaths"][1], None]
    logits = {}

    def run(pool):
        eng = _port(world, cls, adapter_pool=pool)
        name = "_paged_prefill" if cls == "paged" else "_prefill"
        prefill = getattr(eng, name)

        def recording(*args, **kw):
            first, p, last = prefill(*args, **kw)
            logits[pool] = last.clone()
            return first, p, last

        setattr(eng, name, recording)
        return _drain(eng, _reqs(Request, adapters if pool else [None] * 4))

    pooled, plain = run(4), run(0)
    assert pooled[1] == plain[1] and pooled[3] == plain[3]
    assert torch.equal(logits[4][[1, 3]], logits[0][[1, 3]])
    assert pooled[0] == _merged_ids(world, 0, PROMPTS[0])
    assert pooled[2] == _merged_ids(world, 1, PROMPTS[2])
    assert pooled[0] != plain[0]


@pytest.mark.parametrize("cls", ["dense", "paged"])
def test_verify_with_adapters_keeps_greedy_ids(world, cls):
    """The speculative verify forward carries each slot's lane: with
    n-gram drafts the pooled engine's greedy ids equal its own without
    speculation, and verify steps did run."""
    prompts = [[5, 6, 7, 8] * 4, [9, 3, 9, 3, 9, 3, 1, 2], [7, 7, 7, 7, 7],
               [1, 2, 3, 1, 2, 3, 1, 2]]
    adapters = [world["tpaths"][0], world["tpaths"][1], None,
                world["tpaths"][3]]
    outs = {}
    for spec in ("off", "ngram"):
        eng = _port(world, cls, speculative=spec)
        outs[spec] = _drain(eng, _reqs(Request, adapters, prompts,
                                       max_tokens=12))
        if spec == "ngram":
            assert eng.spec_verify_steps > 0 and eng.spec_accepted > 0
    assert outs["ngram"] == outs["off"]
    assert outs["off"][0] == _merged_ids(world, 0, prompts[0], 12)


# ---------------------------------------------------------------------------
# Residency: eviction, page-back-in, pins
# ---------------------------------------------------------------------------

def test_pool_eviction_and_page_back_in(world):
    """pool=2 serving 3 tenants round-robin twice: the LRU evicts and
    reloads as the JAX engine's does, and every answer equals the
    tenant's merged engine's."""
    expected = [_merged_ids(world, i, PROMPTS[i], 6) for i in range(3)]
    eng = _port(world, adapter_pool=2, max_slots=2)
    jeng = JaxEngine(world["jcfg"], world["jparams"], max_slots=2,
                     adapter_pool=2)
    for _round in range(2):
        for i in range(3):
            got = _drain(eng, _reqs(Request, [world["tpaths"][i]],
                                    [PROMPTS[i]], 6))[0]
            _drain(jeng, _reqs(JaxRequest, [world["jpaths"][i]],
                               [PROMPTS[i]], 6))
            assert got == expected[i], (_round, i)
            t, j = eng.adapter_stats(), jeng.adapter_stats()
            assert (t["loads"], t["evictions"], t["hits"]) == \
                (j["loads"], j["evictions"], j["hits"])
    stats = eng.adapter_stats()
    assert stats["evictions"] >= 3 and stats["loads"] >= 5
    assert len(stats["resident"]) == 2
    assert eng.adapters._lane_ref == [0, 0]


def test_pool_refcount_pins_active_lane(world):
    cfg = dataclasses.replace(world["tcfg"], adapter_pool=2)
    pool = lora_pool.AdapterPool(cfg, device=torch.device("cpu"))
    paths = world["tpaths"]
    lane_a = pool.acquire(paths[0])
    lane_b = pool.acquire(paths[1])
    assert {lane_a, lane_b} == {0, 1}
    assert pool.acquire(paths[2]) is None      # both pinned
    pool.release(lane_a)
    assert pool.acquire(paths[2]) == lane_a    # the freed LRU lane
    assert pool.evictions == 1
    assert paths[0] not in pool.resident()
    assert set(pool.resident()) == {paths[1], paths[2]}


def test_admission_429_on_pool_exhaustion(world):
    """Every lane pinned by in-flight decodes: the next tenant waits at
    the queue head, the queue backs up to a 429, and the waiting tenant
    is served once the lane frees."""
    eng = _port(world, adapter_pool=1, max_slots=2, max_queue=2)
    paths = world["tpaths"]
    long_req = Request(prompt_tokens=[5, 9, 17], max_tokens=30,
                       temperature=0.0, adapter=paths[0])
    eng.submit(long_req)
    eng.step()
    assert eng.active.any()
    waiting = Request(prompt_tokens=[40, 2], max_tokens=4,
                      temperature=0.0, adapter=paths[1])
    eng.submit(waiting)
    eng.step()
    assert not waiting.finished and waiting in eng.queue
    eng.submit(Request(prompt_tokens=[1, 2], max_tokens=4,
                       temperature=0.0, adapter=paths[1]))
    with pytest.raises(EngineOverloaded):
        eng.submit(Request(prompt_tokens=[1, 2], max_tokens=4,
                           temperature=0.0, adapter=paths[1]))
    while eng.has_work():
        eng.step()
    assert long_req.finished and waiting.finished
    assert waiting.output_tokens == _merged_ids(world, 1, [40, 2], 4)
    assert eng.adapters._lane_ref == [0]


def test_deadline_releases_a_queued_pin_and_reset_keeps_residency(world):
    """A queued request that already pinned its lane (blocked on pages)
    releases it when its deadline expires; reset() clears every pin and
    keeps what is resident."""
    eng = _port(world, "paged", max_slots=2, max_seq_len=32, num_pages=4)
    paths = world["tpaths"]
    hog = Request(prompt_tokens=list(range(1, 20)), max_tokens=10,
                  temperature=0.0, adapter=paths[0])
    eng.submit(hog)
    eng.step()
    blocked = Request(prompt_tokens=list(range(30, 50)), max_tokens=10,
                      temperature=0.0, adapter=paths[1], deadline_s=60.0)
    eng.submit(blocked)
    eng.step()
    lane = blocked._adapter_lane
    assert blocked in eng.queue and lane >= 0      # pinned, pages short
    assert eng.adapters._lane_ref[lane] == 1
    blocked.deadline_s = 0.0
    eng.step()
    assert blocked.finish_reason == "deadline"
    assert blocked._adapter_lane == -1 and eng.adapters._lane_ref[lane] == 0
    eng.reset()
    assert eng.adapters._lane_ref == [0] * 4
    assert sorted(eng.adapters.resident()) == sorted(paths[:2])
    assert (eng.adapter_slots == -1).all()


def test_preempted_tenant_keeps_its_lane_and_resumes(world):
    """preemption="swap": an interactive tenant displaces a batch tenant,
    whose lane stays pinned while it waits; it resumes with the same lane
    and the ids of an undisturbed run, and every pin is released at the
    end."""
    paths = world["tpaths"]
    eng = PagedInferenceEngine(
        world["tcfg"], world["tparams"], max_slots=1, page_size=16,
        num_pages=5, kv_host_pages=8, preemption="swap", decode_chunk=2)
    prompt = list(range(1, 33))
    batch = Request(prompt_tokens=prompt, max_tokens=16, temperature=0.0,
                    adapter=paths[2], priority="batch")
    eng.submit(batch)
    for _ in range(3):
        eng.step()
    lane = batch._adapter_lane
    inter = Request(prompt_tokens=list(range(90, 106)), max_tokens=8,
                    temperature=0.0, adapter=paths[3],
                    priority="interactive")
    eng.submit(inter)
    eng.step()
    assert eng.preemptions == 1 and batch in eng.queue
    assert batch._adapter_lane == lane and eng.adapters._lane_ref[lane] == 1
    while eng.has_work():
        eng.step()
    assert eng.preempted_resumed == 1 and batch.finish_reason == "length"
    assert batch.output_tokens == _merged_ids(world, 2, prompt, 16)
    assert inter.output_tokens == _merged_ids(world, 3, range(90, 106), 8)
    assert eng.adapters._lane_ref == [0] * 4


# ---------------------------------------------------------------------------
# Validation and artifacts
# ---------------------------------------------------------------------------

def test_adapter_requests_are_validated(world):
    with pytest.raises(ValueError, match="no adapter pool"):
        _port(world, adapter_pool=0).submit(
            Request(prompt_tokens=[1, 2], adapter=world["tpaths"][0]))
    eng = _port(world, adapter_dir=os.path.join(world["root"], "torch"))
    with pytest.raises(ValueError, match="no such directory"):
        eng.submit(Request(prompt_tokens=[1, 2], adapter="/does/not/exist"))
    with pytest.raises(ValueError, match="no such directory"):
        eng.submit(Request(prompt_tokens=[1, 2], adapter="tenant9"))
    # A relative name resolves under adapter_dir.
    r = Request(prompt_tokens=[5, 9, 17], max_tokens=8, temperature=0.0,
                adapter="tenant0")
    assert _drain(eng, [r])[0] == _merged_ids(world, 0, [5, 9, 17])
    with pytest.raises(ValueError, match="adapter_pool must be"):
        _port(world, adapter_pool=-1)


def test_small_rank_pads_exactly(world, tmp_path):
    """A rank-2 adapter in the rank-8 pool serves its merged oracle."""
    _, tpath = _save_both(str(tmp_path), "r2",
                          _np_adapter(world["tcfg"], 2, 8), rank=2,
                          alpha=4.0)
    eng = _port(world, max_slots=2)
    r = Request(prompt_tokens=[5, 9, 17], max_tokens=6, temperature=0.0,
                adapter=tpath)
    merged = lora_pool.load_merge_adapter(tpath, world["tcfg"],
                                          world["tparams"])
    dedicated = InferenceEngine(world["tcfg"], merged, max_slots=2)
    assert _drain(eng, [r]) == _drain(dedicated, [Request(
        prompt_tokens=[5, 9, 17], max_tokens=6)])


def test_bad_artifacts_finish_with_error_and_the_engine_serves(world,
                                                               tmp_path):
    """Artifacts that pass the submit-time probe but fail to load (a
    malformed tree, a rank above the bucket) finish their request with
    finish_reason "error" at admission, evict nothing, and the engine
    keeps serving."""
    from runbooks_tpu_torch.train.checkpoint import CheckpointManager

    broken = str(tmp_path / "broken")
    os.makedirs(broken)
    CheckpointManager(broken).save(
        0, {"params": {"attn.wq": torch.zeros(2, 64, 4)}}, force=True)
    _, big = _save_both(str(tmp_path), "big",
                        _np_adapter(world["tcfg"], 16, 3), rank=16,
                        alpha=16.0)
    eng = _port(world, adapter_pool=1, max_slots=2)
    ok = Request(prompt_tokens=[1, 2, 3], max_tokens=4, temperature=0.0,
                 adapter=world["tpaths"][0])
    _drain(eng, [ok])
    for path in (broken, big):
        r = Request(prompt_tokens=[1, 2, 3], max_tokens=4, temperature=0.0,
                    adapter=path)
        _drain(eng, [r])
        assert r.finished and r.finish_reason == "error"
        assert eng.adapter_stats()["resident"] == [world["tpaths"][0]]
    base = Request(prompt_tokens=[1, 2, 3], max_tokens=4, temperature=0.0)
    _drain(eng, [base])
    assert base.finish_reason == "length"
    assert eng.adapter_stats()["evictions"] == 0


def test_paged_radix_respects_adapter_namespaces(world):
    """Same prompt prefix under two adapters shares no pages; the same
    tenant's next turn reuses its pages; the page counts equal the JAX
    paged engine's."""
    long_prompt = list(range(1, 25))
    outs = []
    for side in ("torch", "jax"):
        if side == "torch":
            eng, cls, paths = _port(world, "paged", max_slots=2), Request, \
                world["tpaths"]
        else:
            eng, cls, paths = JaxPaged(world["jcfg"], world["jparams"],
                                       max_slots=2, page_size=8), \
                JaxRequest, world["jpaths"]
        reused, ids = [], []
        for prompt, a in ((long_prompt + [30], 0), (long_prompt + [31], 0),
                          (long_prompt + [31], 1)):
            before = eng.pager.pages_reused_total
            ids.append(_drain(eng, _reqs(cls, [paths[a]], [prompt], 3))[0])
            reused.append(eng.pager.pages_reused_total - before)
        outs.append((reused, ids))
    assert outs[0] == outs[1]
    reused, ids = outs[0]
    assert reused[1] > 0 and reused[2] == 0
    assert ids[2] == _merged_ids(world, 1, long_prompt + [31], 3)


# ---------------------------------------------------------------------------
# HTTP and load_model
# ---------------------------------------------------------------------------

def _call(base, path, body):
    req = urllib.request.Request(
        base + path, data=json.dumps(body).encode(),
        headers={"Content-Type": "application/json"})
    try:
        with urllib.request.urlopen(req, timeout=HTTP_TIMEOUT) as r:
            return r.status, json.loads(r.read().decode())
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read().decode())


def test_http_adapter_field(world):
    """create_server(adapter_pool=2, lora_rank=8, adapter_dir=...): a body
    naming a tenant answers 200 with the tenant's greedy text (the JAX
    pooled server's, and the port engine's ids), an unknown adapter 400,
    a non-string one 400, and a pool-less server 400."""
    from tests.test_torch_serve_api import _JaxServer
    from runbooks_tpu.serve.api import create_server as jax_create_server

    body = {"prompt": "hello", "max_tokens": 5, "temperature": 0.0,
            "adapter": "tenant0"}
    texts, statuses = {}, {}
    # The byte tokenizer's ids need a vocabulary of 258 or more; the
    # adapters' shapes do not depend on it.
    tcfg = dataclasses.replace(world["tcfg"], adapter_pool=0,
                               vocab_size=512)
    jcfg = dataclasses.replace(world["jcfg"], adapter_pool=0,
                               vocab_size=512)
    jparams = jax_init_params(jcfg, jax.random.key(1))
    tparams = bridge.from_jax_numpy(tcfg, jax.tree.map(np.asarray, jparams))
    srv = api.create_server(tcfg, tparams, host="127.0.0.1",
                            port=0, device="cpu", max_slots=2,
                            adapter_pool=2, lora_rank=8,
                            adapter_dir=os.path.join(world["root"], "torch"))
    thread = threading.Thread(target=srv.serve_forever, daemon=True)
    thread.start()
    engine = srv.worker.engine
    seen = []
    submit = engine.submit

    def recording(req):
        seen.append(req)
        submit(req)

    engine.submit = recording
    jsrv = _JaxServer(jax_create_server(
        jcfg, jparams, max_slots=2, adapter_pool=2, lora_rank=8,
        adapter_dir=os.path.join(world["root"], "jax")))
    try:
        for side, base in (("torch", f"http://127.0.0.1:{srv.port}"),
                           ("jax", jsrv.base)):
            status, reply = _call(base, "/v1/completions", body)
            assert status == 200, reply
            texts[side] = reply["choices"][0]["text"]
            statuses[side] = [
                _call(base, "/v1/completions", {**body, "adapter": a})[0]
                for a in ("tenant7", "/no/such/adapter", 7)]
        stats = engine.adapter_stats()
    finally:
        srv.shutdown()
        thread.join(timeout=30)
        jsrv.close()
    assert texts["torch"] == texts["jax"]
    assert statuses["torch"] == statuses["jax"] == [400, 400, 400]
    assert stats["loads"] == 1 and stats["pool_size"] == 2
    want = _drain(InferenceEngine(tcfg, tparams, max_slots=2,
                                  adapter_pool=2), [Request(
        prompt_tokens=list(seen[0].prompt_tokens), max_tokens=5,
        temperature=0.0, adapter=world["tpaths"][0],
        eos_id=seen[0].eos_id)])[0]
    assert seen[0].output_tokens == want
    plain = api.create_server(tcfg, tparams, host="127.0.0.1",
                              port=0, device="cpu", max_slots=2)
    thread = threading.Thread(target=plain.serve_forever, daemon=True)
    thread.start()
    try:
        status, reply = _call(f"http://127.0.0.1:{plain.port}",
                              "/v1/completions", body)
    finally:
        plain.shutdown()
        thread.join(timeout=30)
    assert status == 400 and "no adapter pool" in reply["error"]["message"]


def test_load_model_with_a_pool_returns_the_base(tmp_path, monkeypatch):
    """With adapter_pool on, load_model serves the base unfolded (the pool
    applies adapters per request); with it off, `adapter:` folds; both
    together raise."""
    monkeypatch.setenv("RBT_CONTENT_DIR", str(tmp_path / "content"))
    cfg, base = api.load_model({"model": "debug", "seed": 0}, device="cpu")
    _, pooled = api.load_model({"model": "debug", "seed": 0,
                                "adapterPool": 2}, device="cpu")
    for (k, a), b in zip(_leaves(base), (v for _, v in _leaves(pooled))):
        assert torch.equal(a, b), k
    _, path = _save_both(str(tmp_path), "a",
                         _np_adapter(cfg, 4, 1, ("attn.wq",)), rank=4,
                         alpha=8.0)
    _, folded = api.load_model({"model": "debug", "seed": 0,
                                "adapter": path}, device="cpu")
    assert not torch.equal(folded["layers"]["attn"]["wq"],
                           base["layers"]["attn"]["wq"])
    with pytest.raises(RuntimeError, match="mutually exclusive"):
        api.load_model({"model": "debug", "adapter": path,
                        "adapter_pool": 2}, device="cpu")


def _leaves(tree, prefix=""):
    for k, v in sorted(tree.items()):
        if isinstance(v, dict):
            yield from _leaves(v, f"{prefix}{k}.")
        else:
            yield f"{prefix}{k}", v
