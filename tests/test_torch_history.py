"""The port's fleet history (runbooks_tpu_torch/obs/history.py) against
the reference's (runbooks_tpu/obs/history.py): the same seeded appends,
scalar and histogram, with counter resets and replica churn, give equal
windows, queries, index, stats and snapshot JSON; each side loads the
other's saved snapshot with equal windows; a corrupt snapshot
cold-starts without raising; ``serve_metrics(0, history=...)`` answers
/metrics/history as the reference's does (400 on a bad query). Also the
gateway's entry point: ``k8s_discover`` over the reference's fake API
server, and ``main`` turning RBT_GATEWAY_* into the reference's
create_gateway arguments."""

import json
import random
import time
import urllib.error
import urllib.request

import pytest

from runbooks_tpu.obs import history as ref_history
from runbooks_tpu.obs import metrics as ref_metrics
from runbooks_tpu.serve import gateway as ref_gw
from runbooks_tpu_torch.obs import history as port_history
from runbooks_tpu_torch.obs import metrics as port_metrics
from runbooks_tpu_torch.serve import gateway as port_gw

NOW = 1_760_000_000.0
BOUNDS = list(port_metrics.DEFAULT_BUCKETS)
SIDES = [(ref_history, ref_metrics), (port_history, port_metrics)]


@pytest.fixture(autouse=True)
def frozen_clock(monkeypatch):
    """Both modules read time.time() for "now", snapshots' saved_at and
    the load cutoff: one frozen clock for both."""
    monkeypatch.setattr(time, "time", lambda: NOW)


def _feed(history, seed, churn=True):
    """Seeded appends over 30 minutes at uneven cadence: per-replica
    counters with restarts, gauges, TTFT histograms whose cumulative
    counts reset when their replica restarts; p2 leaves halfway."""
    rng = random.Random(seed)
    t = NOW - 1800.0
    state = {r: {"req": 0.0, "cum": [0] * len(BOUNDS), "count": 0,
                 "sum": 0.0} for r in ("p0", "p1", "p2")}
    while t < NOW:
        t += rng.choice([4.0, 9.5, 10.0, 10.0, 17.0])
        for rep, st in state.items():
            if churn and rep == "p2" and t > NOW - 900:
                continue
            labels = {"kind": "Server", "name": "srv", "replica": rep}
            if rng.random() < 0.03:   # restart: every cumulative resets
                st.update(req=0.0, cum=[0] * len(BOUNDS), count=0, sum=0.0)
            st["req"] += rng.randrange(0, 12)
            history.append_scalar("serve_requests_total", labels, t,
                                  st["req"], "counter")
            history.append_scalar("serve_queue_depth", labels, t,
                                  rng.randrange(0, 9), "gauge")
            for _ in range(rng.randrange(0, 8)):
                v = rng.choice([0.004, 0.03, 0.07, 0.3, 0.8, 4.0, 60.0])
                st["count"] += 1
                st["sum"] += v
                for i, b in enumerate(BOUNDS):
                    if v <= b:
                        st["cum"][i] += 1
            history.append_histogram("serve_ttft_seconds", labels, t,
                                     BOUNDS, list(st["cum"]), st["count"],
                                     st["sum"])
    return history


def _windows(h):
    out = []
    for w in (30.0, 60.0, 300.0, 900.0, 1800.0, 7200.0):
        for sel in (None, {"replica": "p0"}, {"name": "srv"},
                    {"replica": "p2"}):
            wh = h.window_histogram("serve_ttft_seconds", w, sel=sel)
            out.append(None if wh is None else
                       (wh.bounds, wh.deltas, wh.count, wh.sum, wh.span_s,
                        wh.fraction_above(0.1)))
            out.append(h.window_histogram("serve_ttft_seconds", w, sel=sel,
                                          partial=True) is None)
            for q in (0.5, 0.9, 0.99):
                out.append(h.window_quantile("serve_ttft_seconds", q, w,
                                             sel=sel))
            out.append(h.window_increase("serve_requests_total", w,
                                         sel=sel))
            out.append(h.window_increase("serve_requests_total", w,
                                         sel=sel, partial=True))
    return out


def _queries(h):
    out = []
    for name in ("serve_ttft_seconds", "serve_requests_total",
                 "serve_queue_depth", "missing"):
        for since, step in ((900, 10), (3600, 60), (21600, 1), (60, 30)):
            for agg in ("sum", "avg", "max"):
                out.append(h.query(name, since, step, q=0.9, agg=agg))
    out.append(h.index())
    out.append(h.stats())
    return out


def _pair(**kw):
    return [_feed(mod.FleetHistory(**kw), 3) for mod, _ in SIDES]


def test_windows_queries_index_and_stats_equal():
    ref, port = _pair()
    assert _windows(port) == _windows(ref)
    assert _queries(port) == _queries(ref)
    assert any(w is not None for w in _windows(port))


def test_small_rings_and_series_cap_equal(capsys):
    ref, port = _pair(raw_step_s=5.0, raw_retention_s=120.0,
                      rollup_step_s=30.0, rollup_retention_s=900.0,
                      max_series=5)
    assert port.stats() == ref.stats() and port.stats()["dropped"] > 0
    assert _windows(port) == _windows(ref)
    assert _queries(port) == _queries(ref)
    assert capsys.readouterr().out.count("series cap (5) reached") == 2


def test_snapshot_json_equal_and_loads_across():
    ref, port = _pair()
    ref.mark_stale(replica="p1")
    port.mark_stale(replica="p1")
    assert json.dumps(port.to_snapshot(), sort_keys=True) == \
        json.dumps(ref.to_snapshot(), sort_keys=True)
    for src, dst_mod in ((ref, port_history), (port, ref_history)):
        dst = dst_mod.FleetHistory()
        assert dst.load_snapshot(json.loads(json.dumps(
            src.to_snapshot()))) == src.stats()["series"]
        assert _windows(dst) == _windows(src)
        assert _queries(dst) == _queries(src)


def test_save_by_one_load_by_the_other(tmp_path, capsys):
    ref, port = _pair()
    for src, dst_mod, name in ((ref, port_history, "ref.json"),
                               (port, ref_history, "port.json")):
        path = str(tmp_path / "sub" / name)
        assert src.save(path)
        assert not (tmp_path / "sub" / f"{name}.tmp").exists()
        dst = dst_mod.FleetHistory()
        assert dst.load(path) == "restored"
        assert _windows(dst) == _windows(src)
    assert port_history.FleetHistory().load(
        str(tmp_path / "none.json")) == "cold"
    assert "restored" in capsys.readouterr().out


@pytest.mark.parametrize("content", [
    '{"version": 1, "series": [{"name": "x"', "not json at all",
    '{"version": 2, "series": []}',
    '{"version": 1, "series": [{"name": "x", "type": "gauge", '
    '"labels": [["a", "b"]], "raw": [["t", 1]], "rollup": []}]}'])
def test_corrupt_snapshot_cold_starts_loudly(tmp_path, capsys, content):
    path = tmp_path / "snap.json"
    path.write_text(content)
    for mod, _ in SIDES:
        h = _feed(mod.FleetHistory(), 5)
        assert h.load(str(path)) == "corrupt"
        assert h.stats()["series"] == 0
    out = capsys.readouterr().out
    assert out.count("SNAPSHOT CORRUPT") == 2


def test_save_failure_never_raises(tmp_path, capsys):
    blocker = tmp_path / "file"
    blocker.write_text("x")
    for mod, _ in SIDES:
        assert mod.FleetHistory().save(str(blocker / "snap.json")) is False
    assert capsys.readouterr().out.count("snapshot save to") == 2


def test_mark_stale_and_prune_under_churn():
    """Replicas leave and come back: the same series go stale, drop out
    of windows, are pruned once past raw retention, and un-stale on a
    fresh point, on both sides alike."""
    ref, port = _pair()
    trace = []
    for h in (ref, port):
        steps = [h.mark_stale(replica="p2"), h.stats(),
                 h.window_quantile("serve_ttft_seconds", 0.9, 1800.0),
                 h.prune(now=NOW), h.stats(),
                 h.mark_stale(t=NOW, replica="p1", name="srv"),
                 h.window_increase("serve_requests_total", 600.0),
                 h.query("serve_queue_depth", 900, 10)["stale_excluded"]]
        h.append_scalar("serve_queue_depth",
                        {"kind": "Server", "name": "srv", "replica": "p1"},
                        NOW, 4.0)
        steps += [h.stats(), h.prune(now=NOW + 901.0), h.stats(),
                  h.mark_stale(replica="nobody")]
        trace.append(steps)
    assert trace[1] == trace[0]
    assert trace[1][0] > 0 and trace[1][3] > 0


def test_ingest_over_each_sides_exposition():
    """Scrapes rendered by each side's Registry and parsed by its own
    parse_exposition ingest into equal histories (label merging, the
    prefix filter, histograms and scalars)."""
    hs = []
    for hist_mod, metrics in SIDES:
        h = hist_mod.FleetHistory()
        rng = random.Random(9)
        regs = {r: metrics.Registry() for r in ("a", "b")}
        for k in range(8):
            for rep, reg in regs.items():
                reg.inc("serve_requests_total", rng.randrange(1, 5))
                reg.set_gauge("serve_active_slots", rng.randrange(8))
                reg.set_gauge("other_thing", 1)
                for _ in range(3):
                    reg.observe("serve_ttft_seconds", rng.random())
                fams = metrics.parse_exposition(reg.render())
                h.ingest(fams, {"replica": rep, "name": "srv"},
                         NOW - 80 + 10 * k, ("serve_",))
        hs.append(h)
    ref, port = hs
    assert port.stats() == ref.stats()
    assert json.dumps(port.to_snapshot(), sort_keys=True) == \
        json.dumps(ref.to_snapshot(), sort_keys=True)
    assert port.window_quantile("serve_ttft_seconds", 0.9, 60.0) == \
        ref.window_quantile("serve_ttft_seconds", 0.9, 60.0)


def _get(port, path):
    try:
        with urllib.request.urlopen(f"http://127.0.0.1:{port}{path}",
                                    timeout=10) as r:
            return r.status, r.headers["Content-Type"], r.read()
    except urllib.error.HTTPError as e:
        return e.code, e.headers["Content-Type"], e.read()


QUERIES = [
    "/metrics/history",
    "/metrics/history?series=serve_ttft_seconds",
    "/metrics/history?series=serve_ttft_seconds,serve_requests_total"
    "&since=3600&step=60&q=0.99&agg=max",
    "/metrics/history?series=serve_queue_depth&since=900&step=1"
    "&agg=avg&replica=p0",
    "/metrics/history?series=serve_requests_total&since=99999999",
    "/metrics/history?series=serve_ttft_seconds&q=1.5",
    "/metrics/history?series=serve_ttft_seconds&agg=median",
    "/metrics/history?series=x&since=soon",
    "/metrics/history?series=" + ",".join(f"s{i}" for i in range(17)),
    "/metrics",
    "/nothing",
]


def test_metrics_history_endpoint_answers_as_the_reference():
    answers = []
    for hist_mod, metrics in SIDES:
        h = _feed(hist_mod.FleetHistory(), 3)
        reg = metrics.Registry()
        reg.set_gauge("fleet_history_series", h.stats()["series"])
        reg.set_gauge("fleet_history_points", h.stats()["points"])
        httpd = metrics.serve_metrics(0, registry=reg, history=h)
        plain = metrics.serve_metrics(0, registry=reg)
        try:
            port = httpd.server_address[1]
            answers.append([_get(port, q) for q in QUERIES]
                           + [_get(plain.server_address[1],
                                   "/metrics/history")[0]])
        finally:
            for srv in (httpd, plain):
                srv.shutdown()
                srv.server_close()
    ref, port = answers
    assert port == ref
    statuses = [a[0] for a in port[:-1]]
    assert statuses == [200] * 5 + [400] * 4 + [200, 404]
    assert port[-1] == 404     # without a history the route is not there
    assert json.loads(port[5][2]) == {"error": "q: must be in (0, 1)"}
    assert json.loads(port[2][2])["series"][0]["step"] == 60.0


# ---------------------------------------------------------------------------
# The gateway's entry point: discovery and the environment
# ---------------------------------------------------------------------------

def test_k8s_discover_against_the_fake_api_server():
    from runbooks_tpu.k8s.client import K8sClient, KubeConfig
    from runbooks_tpu.k8s.httpfake import FakeApiServer

    def pod(name, ns="default", labels=None, phase="Running",
            ip="10.0.0.1", deleting=False):
        meta = {"name": name, "namespace": ns,
                "labels": labels or {"server": "srv", "role": "run"}}
        if deleting:
            meta["deletionTimestamp"] = "2026-01-01T00:00:00Z"
        status = {"phase": phase}
        if ip:
            status["podIP"] = ip
        return {"apiVersion": "v1", "kind": "Pod", "metadata": meta,
                "spec": {}, "status": status}

    with FakeApiServer() as api:
        for obj in (pod("srv-0", ip="10.0.0.1"),
                    pod("srv-1", ip="10.0.0.2"),
                    pod("srv-pending", phase="Pending", ip="10.0.0.3"),
                    pod("srv-noip", ip=None),
                    pod("srv-going", ip="10.0.0.4", deleting=True),
                    pod("other-0", labels={"server": "other",
                                           "role": "run"}),
                    pod("srv-gw", labels={"server": "srv",
                                          "role": "gateway"}),
                    pod("srv-9", ns="elsewhere", ip="10.0.0.9")):
            api.cluster.create(obj)
        ref = ref_gw.k8s_discover(
            K8sClient(KubeConfig(api.url, None, {})), "default", "srv")()
        port = port_gw.k8s_discover(
            port_gw.InClusterPods(api.url).list_pods, "default", "srv")()
        port_9000 = port_gw.k8s_discover(
            port_gw.InClusterPods(api.url).list_pods, "default", "srv",
            port=9000)()
    assert port == ref == {"srv-0": "http://10.0.0.1:8080",
                           "srv-1": "http://10.0.0.2:8080"}
    assert port_9000 == {"srv-0": "http://10.0.0.1:9000",
                         "srv-1": "http://10.0.0.2:9000"}


ENVS = [
    {},
    {"RBT_GATEWAY_TARGETS": "r0=http://10.0.0.1:8080,http://10.0.0.2:80",
     "RBT_GATEWAY_POLICY": "random", "RBT_GATEWAY_BLOCK_CHARS": "32",
     "RBT_GATEWAY_AFFINITY": "false", "RBT_GATEWAY_PORT": "9001",
     "RBT_GATEWAY_SERVER": "srv"},
    {"RBT_GATEWAY_TARGETS": "a=http://x:1", "RBT_GATEWAY_AFFINITY": "0"},
]


@pytest.mark.parametrize("env", ENVS)
@pytest.mark.parametrize("timeout_s", [None, 12.5])
def test_main_passes_the_references_arguments(monkeypatch, tmp_path, env,
                                              timeout_s):
    import aiohttp.web
    import signal

    for key in ("RBT_GATEWAY_TARGETS", "RBT_GATEWAY_POLICY",
                "RBT_GATEWAY_BLOCK_CHARS", "RBT_GATEWAY_AFFINITY",
                "RBT_GATEWAY_PORT", "RBT_GATEWAY_SERVER",
                "RBT_GATEWAY_NAMESPACE", "KUBERNETES_SERVICE_HOST"):
        monkeypatch.delenv(key, raising=False)
    for key, value in env.items():
        monkeypatch.setenv(key, value)
    monkeypatch.setenv("RBT_CONTENT_DIR", str(tmp_path))
    if timeout_s is not None:
        (tmp_path / "params.json").write_text(
            json.dumps({"request_timeout_s": timeout_s}))
    seen = {}

    def capture(side):
        def create(targets=None, **kw):
            seen[side] = dict(kw, targets=targets)

            class Dummy:
                router = port_gw.Router(targets)
                port = kw.get("port")

                def serve_forever(self):
                    pass

            return Dummy()
        return create

    monkeypatch.setattr(ref_gw, "create_gateway", capture("ref"))
    monkeypatch.setattr(aiohttp.web, "run_app",
                        lambda app, port, **kw: seen.update(ref_port=port))
    monkeypatch.setattr(port_gw, "create_gateway", capture("port"))
    monkeypatch.setattr(signal, "signal", lambda *a: None)
    assert ref_gw.main() == 0
    assert port_gw.main() == 0
    seen["ref"]["port"] = seen["ref_port"]
    assert seen["port"] == seen["ref"]
    assert seen["port"]["request_timeout_s"] == timeout_s


def test_main_refuses_discovery_outside_a_cluster(monkeypatch, tmp_path):
    monkeypatch.delenv("RBT_GATEWAY_TARGETS", raising=False)
    monkeypatch.delenv("KUBERNETES_SERVICE_HOST", raising=False)
    monkeypatch.setenv("RBT_GATEWAY_SERVER", "srv")
    monkeypatch.setenv("RBT_CONTENT_DIR", str(tmp_path))
    with pytest.raises(RuntimeError, match="kubeconfig discovery needs "
                                           "yaml"):
        port_gw.main()
