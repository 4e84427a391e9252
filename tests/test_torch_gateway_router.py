"""The port's gateway routing core (runbooks_tpu_torch/serve/gateway.py)
against the reference's (runbooks_tpu/serve/gateway.py), same inputs on
both sides: the routing keys, the consistent-hash ring's owners, the
shadow index, a seeded sequence of router operations (ranked candidates
and reasons under "prefix" and "random", the exported gauges), the
metrics poller against stdlib fake replicas, the reference's router
scenarios run on both, and chip_smoke's phase 19 (a) routine, whose
page-reuse counts the card must reproduce."""

import random
import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

import pytest
import torch

from runbooks_tpu.obs import metrics as ref_metrics
from runbooks_tpu.serve import gateway as ref_gw
from runbooks_tpu_torch.obs import metrics as port_metrics
from runbooks_tpu_torch.serve import gateway as port_gw

torch.set_num_threads(2)

SIDES = [(ref_gw, ref_metrics), (port_gw, port_metrics)]


@pytest.mark.parametrize("text,block,cap", [
    ("", 64, 64), ("x" * 63, 64, 64), ("ab" * 500, 64, 64),
    ("ab" * 500, 16, 5), ("héllo wörld " * 40, 7, 64)])
def test_text_blocks_equal(text, block, cap):
    assert port_gw.text_blocks(text, block, cap) == \
        ref_gw.text_blocks(text, block, cap)


@pytest.mark.parametrize("n,block,cap", [(0, 16, 64), (15, 16, 64),
                                         (100, 16, 64), (2000, 16, 64),
                                         (300, 8, 3)])
def test_token_blocks_equal(n, block, cap):
    toks = random.Random(n).choices(range(128256), k=n)
    assert port_gw.token_blocks(toks, block, cap) == \
        ref_gw.token_blocks(toks, block, cap)


@pytest.mark.parametrize("replicas", [3, 4, 5])
def test_hash_ring_owners_equal(replicas):
    """1,000 seeded session keys own the same replica on both rings, and
    again after one replica leaves (only its own sessions move)."""
    rng = random.Random(replicas)
    keys = [f"sess-{rng.getrandbits(48):x}" for _ in range(1000)]
    names = [f"srv-{i}-{rng.getrandbits(16):x}" for i in range(replicas)]
    for current in (names, names[:1] + names[2:]):
        ref, port = ref_gw._HashRing(current), port_gw._HashRing(current)
        owners = [port.owner(k) for k in keys]
        assert owners == [ref.owner(k) for k in keys]
        assert set(owners) == set(current)
    before = port_gw._HashRing(names)
    after = port_gw._HashRing(names[:1] + names[2:])
    moved = [k for k in keys if before.owner(k) != after.owner(k)]
    assert moved and all(before.owner(k) == names[1] for k in moved)


def test_shadow_index_match_record_trim_equal():
    rng = random.Random(7)
    ref, port = ref_gw.ShadowIndex(max_blocks=24), \
        port_gw.ShadowIndex(max_blocks=24)
    for step in range(300):
        tenant = rng.randrange(6)
        toks = [tenant] * 16 * rng.randrange(1, 4) + \
            [rng.randrange(50) for _ in range(16 * rng.randrange(4))]
        blocks = port_gw.token_blocks(toks, 16)
        op = rng.random()
        if op < 0.45:
            assert port.match(blocks) == ref.match(blocks)
        elif op < 0.9:
            port.record(blocks)
            ref.record(blocks)
        else:
            cap = rng.randrange(0, 20)
            assert port.trim(cap) == ref.trim(cap)
        assert port.blocks == ref.blocks, step
    port.clear()
    ref.clear()
    assert port.blocks == ref.blocks == 0


def _families(side, gauges):
    """A replica exposition rendered by this side's Registry and parsed
    by its parse_exposition."""
    _, metrics = side
    reg = metrics.Registry()
    for name, value in gauges.items():
        if name == "serve_queue_wait_seconds":
            for v in value:
                reg.observe(name, v)
        elif name.endswith("_total"):
            reg.set_counter(name, value)
        else:
            reg.set_gauge(name, value)
    return metrics.parse_exposition(reg.render())


def _replica_state(router):
    with router._lock:
        return {n: (r.url, r.healthy, r.active_slots, r.queue_depth,
                    r.queue_wait_p90_ms, r.inflight, r.shadow.blocks,
                    r.requests_total, r.shared_pages)
                for n, r in router._replicas.items()}


@pytest.mark.parametrize("policy", ["prefix", "random"])
def test_router_operation_sequence_equal(policy):
    """~200 seeded operations on both routers give the same ranked
    (name, reason) lists at every pick, the same replica states and the
    same exported gauges."""
    rng = random.Random(11 if policy == "prefix" else 12)
    pool = [f"r{i}" for i in range(6)]
    names = pool[:4]
    routers = [side[0].Router({n: f"http://{n}" for n in names},
                              policy=policy, registry=side[1].Registry(),
                              shadow_blocks=40)
               for side in SIDES]
    prompts = ["tenant %d says " % t * 12 for t in range(5)]
    restarts = {n: 100 for n in pool}
    picks = 0
    for step in range(200):
        op = rng.random()
        if op < 0.05:
            names = sorted(rng.sample(pool, rng.randrange(2, 6)))
            for r in routers:
                r.set_replicas({n: f"http://{n}:8080" for n in names})
        elif op < 0.25:
            name = rng.choice(names)
            if rng.random() < 0.1:
                gauges = None
            else:
                restarts[name] += rng.choice([3, 5, -90])
                restarts[name] = max(restarts[name], 1)
                gauges = {"serve_active_slots": rng.randrange(9),
                          "serve_queue_depth": rng.choice(
                              [0, 0, 1, 3, 5, 9, 14, 20]),
                          "serve_requests_total": restarts[name],
                          "serve_kv_pages_shared": rng.randrange(0, 30),
                          "serve_queue_wait_seconds": [
                              rng.random() * rng.choice([0.01, 1, 10])
                              for _ in range(rng.randrange(0, 6))]}
            for r, side in zip(routers, SIDES):
                r.observe_metrics(name, None if gauges is None
                                  else _families(side, gauges))
        elif op < 0.4:
            name = rng.choice(names)
            blocks = port_gw.text_blocks(
                rng.choice(prompts) + "x" * rng.randrange(200), 16)
            for r in routers:
                r.record_route(name, blocks)
        elif op < 0.5:
            name, delta = rng.choice(names), rng.choice([1, 1, -1])
            for r in routers:
                r.inflight_add(name, delta)
        elif op < 0.55:
            name = rng.choice(names)
            for r in routers:
                r.mark_unreachable(name)
        else:
            blocks = port_gw.text_blocks(
                rng.choice(prompts) + "y" * rng.randrange(100), 16)
            session = (f"sess-{rng.randrange(8)}" if rng.random() < 0.3
                       else None)
            qos = rng.choice(["interactive", "standard", "batch", "urgent"])
            got = [r.pick(blocks, session, priority=qos) for r in routers]
            assert got[1] == got[0], (step, got)
            picks += 1
        assert _replica_state(routers[1]) == _replica_state(routers[0]), step
    assert picks > 50
    for r in routers:
        r.export_gauges()
    rendered = ["\n".join(ln for ln in r.registry.render().splitlines()
                          if not ln.startswith("process_uptime_seconds "))
                for r in routers]
    assert "gateway_shadow_blocks{" in rendered[0]
    assert rendered[1] == rendered[0]
    assert routers[1].healthy_count() == routers[0].healthy_count()
    assert routers[1].replica_names() == routers[0].replica_names()


def test_router_refuses_unknown_policy():
    for gw, _ in SIDES:
        with pytest.raises(ValueError, match="unknown routing policy"):
            gw.Router({}, policy="roundrobin")


# ---------------------------------------------------------------------------
# The reference's router scenarios (tests/test_gateway.py), on both sides
# ---------------------------------------------------------------------------

def fams(metrics, **values):
    out = {}
    for name, v in values.items():
        fam = metrics.ParsedFamily(name, "gauge")
        fam.samples[()] = float(v)
        out[name] = fam
    return out


def prefix_beats_least_loaded(gw, metrics):
    r = gw.Router({"a": "http://a", "b": "http://b"})
    blocks = gw.text_blocks("x" * 640)
    r.record_route("a", blocks)
    r.observe_metrics("a", fams(metrics, serve_active_slots=3,
                                serve_queue_depth=2))
    r.observe_metrics("b", fams(metrics, serve_active_slots=0,
                                serve_queue_depth=0))
    picks = r.pick(blocks)
    assert picks == [("a", "prefix"), ("b", "failover")]
    return picks


def load_breaks_prefix_ties(gw, metrics):
    r = gw.Router({"a": "http://a", "b": "http://b", "c": "http://c"})
    blocks = gw.text_blocks("y" * 640)
    r.observe_metrics("a", fams(metrics, serve_active_slots=4,
                                serve_queue_depth=0))
    r.observe_metrics("b", fams(metrics, serve_active_slots=1,
                                serve_queue_depth=0))
    r.observe_metrics("c", fams(metrics, serve_active_slots=2,
                                serve_queue_depth=3))
    first = r.pick(blocks)
    assert first[0] == ("b", "load")
    r.record_route("a", blocks)
    r.record_route("c", blocks)
    second = r.pick(blocks)
    assert second[0] == ("a", "prefix")
    return first, second


def deep_queue_spills(gw, metrics):
    r = gw.Router({"a": "http://a", "b": "http://b"})
    blocks = gw.text_blocks("z" * 640)
    r.record_route("a", blocks)
    r.observe_metrics("a", fams(metrics, serve_active_slots=8,
                                serve_queue_depth=20))
    r.observe_metrics("b", fams(metrics, serve_active_slots=0,
                                serve_queue_depth=0))
    picks = r.pick(blocks)
    assert picks[0] == ("b", "load")
    return picks


def spill_scales_with_qos(gw, metrics):
    r = gw.Router({"a": "http://a", "b": "http://b"})
    blocks = gw.text_blocks("z" * 640)
    r.record_route("a", blocks)
    r.observe_metrics("b", fams(metrics, serve_active_slots=0,
                                serve_queue_depth=0))
    r.observe_metrics("a", fams(metrics, serve_active_slots=8,
                                serve_queue_depth=5))
    out = [r.pick(blocks, priority="batch")[0],
           r.pick(blocks, priority="standard")[0]]
    r.observe_metrics("a", fams(metrics, serve_active_slots=8,
                                serve_queue_depth=12))
    out += [r.pick(blocks, priority="standard")[0],
            r.pick(blocks, priority="interactive")[0],
            r.pick(blocks, priority="urgent")[0]]
    assert out == [("b", "load"), ("a", "prefix"), ("b", "load"),
                   ("a", "prefix"), ("b", "load")]
    return out


def affinity_survives_replica_changes(gw, metrics):
    r = gw.Router({f"r{i}": f"http://r{i}" for i in range(4)})
    blocks = gw.text_blocks("w" * 640)
    owner = r.pick(blocks, session_key="sess-42")[0]
    assert owner[1] == "affinity"
    survivors = {n: f"http://{n}" for n in r.replica_names()
                 if n != owner[0]}
    victim = next(n for n in r.replica_names() if n != owner[0])
    r.set_replicas({n: f"http://{n}" for n in r.replica_names()
                    if n != victim})
    assert r.pick(blocks, session_key="sess-42")[0][0] == owner[0]
    r.set_replicas(survivors)
    new_owner = r.pick(blocks, session_key="sess-42")[0]
    assert new_owner[0] != owner[0] and new_owner[0] in survivors
    return owner, new_owner


def shadow_tracks_eviction_and_restart(gw, metrics):
    r = gw.Router({"a": "http://a"})
    r.record_route("a", gw.text_blocks("q" * 64 * 10))
    sizes = [r._replicas["a"].shadow.blocks]
    r.observe_metrics("a", fams(metrics, serve_kv_pages_shared=4,
                                serve_requests_total=100))
    sizes.append(r._replicas["a"].shadow.blocks)
    r.observe_metrics("a", fams(metrics, serve_kv_pages_shared=4,
                                serve_requests_total=3))
    sizes.append(r._replicas["a"].shadow.blocks)
    assert sizes == [10, 4, 0]
    return sizes


def unhealthy_never_picked(gw, metrics):
    r = gw.Router({"a": "http://a", "b": "http://b"})
    r.observe_metrics("a", None)
    picks = r.pick(gw.text_blocks("p" * 640))
    assert [n for n, _ in picks] == ["b"]
    r.observe_metrics("b", None)
    assert r.pick(gw.text_blocks("p" * 640)) == []
    assert r.healthy_count() == 0
    return picks


def random_routes_everywhere(gw, metrics):
    r = gw.Router({f"r{i}": f"http://r{i}" for i in range(3)},
                  policy="random")
    blocks = gw.text_blocks("r" * 640)
    r.record_route("r0", blocks)  # a shadow hit must NOT bias random
    seen = [r.pick(blocks)[0][0] for _ in range(64)]
    assert set(seen) == {"r0", "r1", "r2"}
    return seen


@pytest.mark.parametrize("scenario", [
    prefix_beats_least_loaded, load_breaks_prefix_ties, deep_queue_spills,
    spill_scales_with_qos, affinity_survives_replica_changes,
    shadow_tracks_eviction_and_restart, unhealthy_never_picked,
    random_routes_everywhere], ids=lambda f: f.__name__)
def test_reference_router_scenarios(scenario):
    """Each scenario's assertions hold on both sides, with equal picks."""
    assert scenario(port_gw, port_metrics) == scenario(ref_gw, ref_metrics)


# ---------------------------------------------------------------------------
# The metrics poller against stdlib fake replicas
# ---------------------------------------------------------------------------

def _metrics_replica(text):
    class Handler(BaseHTTPRequestHandler):
        def do_GET(self):  # noqa: N802
            body = text.encode()
            self.send_response(200 if self.path == "/metrics" else 404)
            self.send_header("Content-Type", port_metrics.CONTENT_TYPE)
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def log_message(self, *args):
            pass

    httpd = ThreadingHTTPServer(("127.0.0.1", 0), Handler)
    threading.Thread(target=httpd.serve_forever, daemon=True).start()
    return httpd


def test_metrics_poller_folds_the_references_state():
    reg = port_metrics.Registry()
    reg.set_gauge("serve_active_slots", 5)
    reg.set_gauge("serve_queue_depth", 2)
    reg.set_counter("serve_requests_total", 40)
    reg.set_gauge("serve_kv_pages_shared", 3)
    for v in (0.002, 0.04, 0.3, 0.3, 1.7):
        reg.observe("serve_queue_wait_seconds", v)
    good = _metrics_replica(reg.render())
    garbage = _metrics_replica("not an exposition {{{\n")
    targets = {"a": f"http://127.0.0.1:{good.server_address[1]}",
               "junk": f"http://127.0.0.1:{garbage.server_address[1]}",
               "dead": "http://127.0.0.1:1"}
    discovered = [dict(targets), dict(targets, b=targets["a"])]
    try:
        states = []
        for gw, _ in SIDES:
            router = gw.Router(targets)
            router.record_route("a", gw.text_blocks("s" * 64 * 6))
            calls = iter(discovered)
            poller = gw.MetricsPoller(router, timeout_s=1.0,
                                      discover=lambda: next(calls))
            oks = [poller.poll_once(), poller.poll_once()]
            states.append((oks, _replica_state(router)))
        assert states[1] == states[0]
        oks, state = states[1]
        assert oks == [2, 3]
        assert state["a"][1:5] == (True, 5.0, 2.0,
                                   state["a"][4]) and state["a"][4] > 0
        assert state["a"][6] == 3 and not state["dead"][1]
        assert state["junk"][1]          # parseable-but-empty: healthy
    finally:
        good.shutdown()
        garbage.shutdown()


# ---------------------------------------------------------------------------
# chip_smoke's phase 19 (a) on the CPU: the counts the card must match
# ---------------------------------------------------------------------------

def test_phase19_routing_counts_on_the_cpu():
    """route_policies at the debug config on the CPU: pages reused per
    policy are chip_smoke.ROUTE_REUSED (the card's gate), prefix above
    random, every greedy answer equal to the prompt served alone."""
    import chip_smoke as cs
    from runbooks_tpu_torch.serve.api import load_model

    cfg, params = load_model({"model": "debug"}, device="cpu")
    record = cs.route_policies(torch, cfg, params, 0)
    reused = {p: r["pages_reused_total"]
              for p, r in record["policies"].items()}
    assert reused == cs.ROUTE_REUSED
    assert reused["prefix"] == cs.ROUTE_TENANTS * (cs.ROUTE_WAVES - 1) * 2
    for policy, r in record["policies"].items():
        assert sum(r["routed"].values()) == cs.ROUTE_TENANTS * cs.ROUTE_WAVES
        assert all(len(ids) == cs.ROUTE_NEW
                   for ids in record["outputs"][policy])
    assert record["outputs"]["prefix"] == record["outputs"]["random"]
