"""The port's trace spans, flight recorder, goodput and incident bundles
against the reference's (``runbooks_tpu.obs.{trace,flight,goodput,
incident}``): the same calls give the same events (name, ph, args), the
ring's capacity, request-id filter, tail sampling and RBT_FLIGHT=0 behave
as tests/test_flight.py holds the reference to (here on the port's
engine), goodput gives the reference's ratios for the same timings, and
incident bundles carry the reference's keys with debounce, pruning and
atomic writes, the engine worker's crash handler included."""

import json
import os
import time

import numpy as np
import pytest
import torch

from runbooks_tpu.obs import flight as ref_flight
from runbooks_tpu.obs import goodput as ref_goodput
from runbooks_tpu.obs import incident as ref_incident
from runbooks_tpu.obs import trace as ref_trace
from runbooks_tpu_torch.models.config import get_config
from runbooks_tpu_torch.models.transformer import init_params
from runbooks_tpu_torch.obs import flight, goodput, incident, trace
from runbooks_tpu_torch.obs.metrics import REGISTRY
from runbooks_tpu_torch.serve.engine import InferenceEngine, Request
from tests.test_obs import read_trace_events

torch.set_num_threads(2)


@pytest.fixture(autouse=True)
def clean_obs_state(monkeypatch):
    """Both packages' rings, debounce books and trace writers are process
    state: each test starts from a clean slate and leaves one behind."""
    for ring, mgr in ((flight.RING, incident.MANAGER),
                      (ref_flight.RING, ref_incident.MANAGER)):
        ring.clear()
        mgr.reset()
    for var in ("RBT_TRACE", "RBT_TRACE_TAIL_MS", "RBT_FLIGHT",
                "RBT_INCIDENT_KEEP"):
        monkeypatch.delenv(var, raising=False)
    yield
    for mod in (trace, ref_trace):
        mod.close()
        mod.configure(None)
    for ring, mgr in ((flight.RING, incident.MANAGER),
                      (ref_flight.RING, ref_incident.MANAGER)):
        ring.clear()
        mgr.reset()
    flight.set_component("proc")
    ref_flight.set_component("proc")


def _script(mod, seed: int) -> None:
    """Seeded spans, completes and instants with nested and list args."""
    rng = np.random.default_rng(seed)
    for i in range(12):
        kind = int(rng.integers(0, 3))
        rid = f"req-{int(rng.integers(0, 3))}"
        if kind == 0:
            with mod.span("prefill", bucket=16 * (i + 1), rows=1, prefix=0,
                          request_ids=[rid, rid + "/1"]):
                pass
        elif kind == 1:
            mod.complete("queue_wait", float(rng.random()), request_id=rid,
                         slot=i % 4)
        else:
            mod.instant("checkpoint", step=i, reason={"nested": [i, rid]})
    try:
        with mod.span("step", step=99):
            raise KeyError("x")
    except KeyError:
        pass


def _shape(events):
    return [(e["name"], e["ph"], e.get("args")) for e in events]


@pytest.mark.parametrize("seed", [0, 1])
def test_events_equal_the_references(seed, tmp_path, monkeypatch):
    monkeypatch.setenv("RBT_TRACE", "1")
    for mod, fl, name in ((trace, flight, "port"),
                          (ref_trace, ref_flight, "ref")):
        fl.set_component("serve")
        mod.configure(str(tmp_path / f"{name}.jsonl"))
        _script(mod, seed)
        mod.close()
    port = read_trace_events(tmp_path / "port.jsonl")
    ref = read_trace_events(tmp_path / "ref.jsonl")
    assert _shape(port) == _shape(ref)
    assert _shape(flight.RING.snapshot()) == _shape(ref_flight.RING.snapshot())
    assert {e["pid"] for e in port} == {trace.trace_pid()} \
        == {ref_trace.trace_pid()}
    assert port[-1]["args"]["error"] == "KeyError"


def test_request_scope_and_traceparent_as_the_reference():
    tp = "00-0af7651916cd43dd8448eb211c80319c-b7ad6b7169203331-01"
    cases = [{}, {"X-Request-Id": "abc\r\nX-Evil: 1"}, {"traceparent": tp},
             {"traceparent": tp, "X-Request-Id": "mine"},
             {"traceparent": "garbage"}]
    for headers in cases:
        rid, tp_out = trace.request_scope(headers)
        ref_rid, ref_tp = ref_trace.request_scope(headers)
        if headers.get("X-Request-Id") or headers.get("traceparent") == tp:
            assert rid == ref_rid
        else:
            assert rid.startswith("req-") and ref_rid.startswith("req-")
        assert (tp_out is None) == (ref_tp is None)
        if tp_out:
            assert tp_out.split("-")[1] == ref_tp.split("-")[1]
            assert tp_out.split("-")[2] != tp.split("-")[2]
    assert len(trace.mint_traceparent().split("-")) == 4


def test_ring_bounded_and_indexed_by_request_id():
    for fl in (flight, ref_flight):
        ring = fl.FlightRecorder(capacity=32)
        for i in range(100):
            ring.record({"name": "decode", "ph": "X", "ts": float(i),
                         "args": {"request_ids": [f"r-{i % 4}"]}})
        assert ring.stats() == {"events": 32, "capacity": 32,
                                "recorded": 100, "dropped": 68}
        got = ring.snapshot(request_id="r-1")
        assert len(got) == 8 and all("r-1" in e["args"]["request_ids"]
                                     for e in got)
        ring.record({"name": "prefill", "ph": "X", "ts": 1e9,
                     "args": {"request_id": "r-9/0"}})
        assert len(ring.snapshot(request_id="r-9")) == 1
        assert len(ring.snapshot(limit=5)) == 5
        ring.resize(8)
        assert ring.stats()["capacity"] == 16   # the floor


def test_flight_off_is_the_null_path(tmp_path, monkeypatch):
    trace.configure(str(tmp_path / "trace.jsonl"))
    with trace.span("prefill", bucket=16, request_ids=["rid-a"]):
        pass
    assert {e["name"] for e in flight.RING.snapshot("rid-a")} == {"prefill"}
    assert not os.path.exists(tmp_path / "trace.jsonl")
    monkeypatch.setenv("RBT_FLIGHT", "0")
    assert trace.span("x") is trace.span("y")
    assert not trace.record_enabled()
    trace.instant("nothing")
    assert len(flight.RING.snapshot()) == 1
    monkeypatch.setenv("RBT_FLIGHT_RING", "7")
    assert flight.ring_capacity() == ref_flight.ring_capacity() == 16


def _debug_engine(**kw):
    cfg = get_config("debug", dtype="float32", vocab_size=128,
                     max_seq_len=64)
    gen = torch.Generator().manual_seed(0)
    params = init_params(cfg, gen, torch.device("cpu"))
    return InferenceEngine(cfg, params, max_slots=2, **kw)


def test_engine_timeline_and_tail_sampling(tmp_path, monkeypatch):
    """RBT_TRACE off: the ring alone holds each request's queue_wait ->
    prefill -> decode; a small ring wraps under sustained traffic and
    still holds the last wave; tail sampling promotes only slow and
    expired requests to trace.jsonl."""
    path = tmp_path / "trace.jsonl"
    trace.configure(str(path))
    engine = _debug_engine()
    flight.RING.resize(32)
    try:
        for wave in range(6):
            engine.generate([Request(prompt_tokens=[1, 2, 3], max_tokens=4,
                                     request_id=f"w{wave}-r{i}")
                             for i in range(2)])
        names = [e["name"] for e in flight.RING.snapshot("w5-r0")]
        assert {"queue_wait", "prefill", "decode"} <= set(names)
        assert flight.RING.stats()["dropped"] > 0
        assert not path.exists()
    finally:
        flight.RING.resize(flight.ring_capacity())
    monkeypatch.setenv("RBT_TRACE_TAIL_MS", "3600000")
    engine.generate([Request(prompt_tokens=[1, 2, 3], max_tokens=4,
                             request_id="fast-1")])
    assert not path.exists()
    monkeypatch.setenv("RBT_TRACE_TAIL_MS", "0")
    before = REGISTRY.counter_value("serve_tail_samples_total",
                                    reason="slow")
    engine.generate([Request(prompt_tokens=[1, 2, 3], max_tokens=4,
                             request_id="slow-1")])
    assert REGISTRY.counter_value("serve_tail_samples_total",
                                  reason="slow") == before + 1
    events = read_trace_events(path)
    promoted = {e["name"] for e in events if flight._matches(e, "slow-1")}
    assert {"queue_wait", "prefill", "decode"} <= promoted
    assert events[-1]["name"] == "tail_sample"
    assert events[-1]["args"]["reason"] == "slow"
    assert not any(flight._matches(e, "fast-1") for e in events)
    monkeypatch.delenv("RBT_TRACE_TAIL_MS")
    before = REGISTRY.counter_value("serve_tail_samples_total",
                                    reason="deadline")
    req = Request(prompt_tokens=[1, 2, 3], max_tokens=60, deadline_s=0.001,
                  request_id="late-1")
    engine.generate([req])
    assert req.finish_reason == "deadline"
    assert REGISTRY.counter_value("serve_tail_samples_total",
                                  reason="deadline") == before + 1


class _Clock:
    def __init__(self):
        self.t = 100.0

    def perf_counter(self):
        return self.t


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_goodput_ratios_equal_the_references(seed, monkeypatch):
    rng = np.random.default_rng(seed)
    clocks = {}
    trackers = {}
    for name, mod in (("port", goodput), ("ref", ref_goodput)):
        clocks[name] = _Clock()
        monkeypatch.setattr(mod, "time", clocks[name])
        trackers[name] = mod.GoodputTracker()
    ops = []
    for _ in range(40):
        kind = int(rng.integers(0, 4))
        ops.append((kind, float(rng.exponential(0.5)),
                    float(rng.exponential(0.05)),
                    float(rng.exponential(0.01))))
    for kind, a, b, c in ops:
        for name, g in trackers.items():
            clocks[name].t += a + b + c + 0.001
            if kind == 0:
                g.exclude(a, "restore" if b > 0.05 else "compile")
            else:
                g.step(a, data_wait_s=b, ckpt_s=c if kind == 2 else 0.0)
        assert trackers["port"].ratio() == trackers["ref"].ratio()
    assert trackers["port"].snapshot() == trackers["ref"].snapshot()
    assert 0.0 < trackers["port"].ratio() <= 1.0


def _capture_both(tmp_path, reason, **kw):
    out = {}
    for name, mod in (("port", incident), ("ref", ref_incident)):
        out[name] = mod.capture(reason, artifacts=str(tmp_path / name),
                                component="serve", extra={"k": 1}, **kw)
    return out


def test_incident_bundles_have_the_references_keys(tmp_path, monkeypatch):
    flight.RING.record({"name": "decode", "ph": "X", "ts": 1.0})
    ref_flight.RING.record({"name": "decode", "ph": "X", "ts": 1.0})
    weights = {"w": torch.zeros(4, 4)}
    paths = _capture_both(tmp_path, "slo violated/p99")
    port = json.load(open(paths["port"]))
    ref = json.load(open(paths["ref"]))
    assert set(port) == set(ref)
    assert set(port["compiles"]) == set(ref["compiles"])
    assert set(port["flight"]) == set(ref["flight"])
    assert port["reason"] == ref["reason"] == "slo-violated-p99"
    assert os.path.basename(paths["port"]).split("-", 1)[1] == \
        os.path.basename(paths["ref"]).split("-", 1)[1]
    assert "serve_incidents_total" in port["metrics"]
    assert port["flight"]["events"] == ref["flight"]["events"]
    # The memory section is the port's census over the named groups.
    monkeypatch.setattr(incident, "MIN_INTERVAL_S", 0.0)
    p = incident.capture("groups", artifacts=str(tmp_path / "port"),
                         memory_groups={"weights": weights})
    assert json.load(open(p))["memory"]["tensors"]["by_category"] == \
        {"weights": 64}
    # Debounce per reason; the listing and the reader as the reference's.
    assert _capture_both(tmp_path, "slo violated/p99") == \
        {"port": None, "ref": None}
    listed = incident.list_incidents(str(tmp_path / "port"))
    assert [e["reason"] for e in listed] == ["slo-violated-p99", "groups"] \
        or [e["reason"] for e in listed] == ["groups", "slo-violated-p99"]
    assert set(listed[0]) == set(
        ref_incident.list_incidents(str(tmp_path / "ref"))[0])
    assert incident.read_incident(listed[0]["name"],
                                  str(tmp_path / "port"))["reason"] \
        == listed[0]["reason"]
    assert incident.read_incident("../../etc/passwd",
                                  str(tmp_path / "port")) is None


def test_incident_keep_floor_and_atomic_writes(tmp_path, monkeypatch):
    monkeypatch.setenv("RBT_INCIDENT_KEEP", "2")
    replaced = []
    real_replace = os.replace

    def spy(src, dst):
        replaced.append((str(src), str(dst), os.path.exists(dst)))
        real_replace(src, dst)

    monkeypatch.setattr(incident.os, "replace", spy)
    art = str(tmp_path)
    assert incident.capture("first", artifacts=art) is not None
    # The global floor between any two bundles, whatever the reason.
    assert incident.capture("second", artifacts=art) is None
    monkeypatch.setattr(incident, "MIN_INTERVAL_S", 0.0)
    for reason in ("second", "third", "fourth"):
        time.sleep(1.01)   # distinct second-resolution stamps
        assert incident.capture(reason, artifacts=art) is not None
    names = sorted(os.listdir(os.path.join(art, "incidents")))
    assert len(names) == 2 and names[-1].endswith("-fourth.json")
    assert all(src.endswith(".json.tmp") and dst == src[:-len(".tmp")]
               and not existed for src, dst, existed in replaced)
    assert not any(n.endswith(".tmp") for n in names)
    # capture never raises: an unwritable root degrades to None.
    monkeypatch.setattr(incident.os, "makedirs",
                        lambda *a, **k: (_ for _ in ()).throw(OSError("ro")))
    assert incident.capture("fifth", artifacts=art) is None


def test_engine_crash_captures_one_bundle_and_promotes(tmp_path,
                                                       monkeypatch):
    """A failed engine step: the worker's crash handler fails the waiting
    request, captures one engine_crash bundle before the reset, promotes
    the doomed request's timeline, and the reset engine serves again."""
    from runbooks_tpu_torch.serve.api import EngineWorker

    monkeypatch.setenv("RBT_CONTENT_DIR", str(tmp_path))
    trace.configure(str(tmp_path / "artifacts" / "trace.jsonl"))
    engine = _debug_engine()
    real_step = engine.step
    calls = {"n": 0}

    def step():
        calls["n"] += 1
        if calls["n"] == 2:
            raise RuntimeError("injected device fault")
        return real_step()

    engine.step = step
    worker = EngineWorker(engine)
    try:
        fut = worker.submit(Request(prompt_tokens=[1, 2, 3], max_tokens=32,
                                    request_id="doomed-1"))
        with pytest.raises(RuntimeError, match="injected"):
            fut.result(timeout=60)
        inc_dir = tmp_path / "artifacts" / "incidents"
        deadline = time.monotonic() + 10
        while not list(inc_dir.glob("*.json")) \
                and time.monotonic() < deadline:
            time.sleep(0.02)
        bundles = list(inc_dir.glob("*.json"))
        assert len(bundles) == 1
        bundle = json.load(open(bundles[0]))
        assert bundle["reason"] == "engine_crash"
        assert bundle["extra"]["doomed_requests"] == ["doomed-1"]
        assert bundle["flight"]["events"]
        assert bundle["memory"]["tensors"]["by_category"]["weights"] > 0
        assert incident.capture("engine_crash") is None
        text = (tmp_path / "artifacts" / "trace.jsonl").read_text()
        assert "doomed-1" in text and "tail_sample" in text
        ok = worker.submit(Request(prompt_tokens=[1, 2, 3], max_tokens=4))
        assert len(ok.result(timeout=60).output_tokens) == 4
    finally:
        worker.stop()
