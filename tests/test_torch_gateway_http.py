"""The port's HTTP gateway (create_gateway on the standard library)
against the reference's aiohttp gateway: the same scripted stdlib fake
replicas in front of each, the same requests, and the same statuses,
bodies, Retry-After, X-Gateway-Replica, forwarded timeout (within 50 ms),
hits per replica and gateway_* counters for failover under a deadline,
an exhausted deadline, fleet-wide overload, the per-class shed budget,
X-Priority forwarding, readiness without a backend and unreachable
replicas. Then the port alone: an SSE chunk reaches the client before
the replica's stream ends, the in-flight count returns to 0 after a
client disconnects mid-stream, and two port replicas (debug config on
the CPU, paged) behind the port gateway answer as direct calls do."""

import asyncio
import http.client
import json
import socket
import threading
import time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

import pytest
import torch

from runbooks_tpu.obs import metrics as ref_metrics
from runbooks_tpu.serve import gateway as ref_gw
from runbooks_tpu_torch.obs import metrics as port_metrics
from runbooks_tpu_torch.serve import gateway as port_gw

torch.set_num_threads(2)


# ---------------------------------------------------------------------------
# Fake replicas and the two gateways behind one interface
# ---------------------------------------------------------------------------

class FakeReplica:
    """A stdlib replica: POST /v1/* runs ``behavior(body)`` -> (status,
    payload[, delay_s]) and records (body, headers); 429/503 carry
    Retry-After: 1 as serve/api.py's rejections do."""

    def __init__(self, behavior):
        self.hits = []
        fake = self

        class Handler(BaseHTTPRequestHandler):
            protocol_version = "HTTP/1.0"

            def do_POST(self):  # noqa: N802
                n = int(self.headers.get("Content-Length") or 0)
                body = json.loads(self.rfile.read(n))
                fake.hits.append((body, dict(self.headers)))
                out = behavior(body)
                status, payload = out[0], out[1]
                if len(out) > 2:
                    time.sleep(out[2])
                data = json.dumps(payload).encode()
                self.send_response(status)
                self.send_header("Content-Type", "application/json")
                self.send_header("Content-Length", str(len(data)))
                if status in (429, 503):
                    self.send_header("Retry-After", "1")
                self.end_headers()
                self.wfile.write(data)

            def log_message(self, *args):
                pass

        self.httpd = ThreadingHTTPServer(("127.0.0.1", 0), Handler)
        threading.Thread(target=self.httpd.serve_forever,
                         daemon=True).start()
        self.url = f"http://127.0.0.1:{self.httpd.server_address[1]}"

    def close(self):
        self.httpd.shutdown()
        self.httpd.server_close()


class RefGateway:
    """The reference's aiohttp app served on its own event loop thread."""

    def __init__(self, targets, registry, **kw):
        from aiohttp import web

        self.app = ref_gw.create_gateway(targets, scrape_interval_s=0,
                                         registry=registry, **kw)
        self.router = self.app["router"]
        self.loop = asyncio.new_event_loop()
        threading.Thread(target=self.loop.run_forever, daemon=True).start()

        async def start():
            self.runner = web.AppRunner(self.app)
            await self.runner.setup()
            site = web.TCPSite(self.runner, "127.0.0.1", 0)
            await site.start()
            return site._server.sockets[0].getsockname()[1]

        self.port = asyncio.run_coroutine_threadsafe(
            start(), self.loop).result(30)

    def close(self):
        asyncio.run_coroutine_threadsafe(self.runner.cleanup(),
                                         self.loop).result(30)
        self.loop.call_soon_threadsafe(self.loop.stop)


class PortGateway:
    def __init__(self, targets, registry, **kw):
        self.gw = port_gw.create_gateway(targets, scrape_interval_s=0,
                                         registry=registry,
                                         host="127.0.0.1", port=0, **kw)
        self.router = self.gw.router
        self.port = self.gw.port
        self.thread = threading.Thread(target=self.gw.serve_forever,
                                       daemon=True)
        self.thread.start()

    def close(self):
        self.gw.shutdown()
        self.thread.join(timeout=10)


def call(port, method, path, body=None, headers=None):
    """(status, headers, parsed JSON or text) of one request."""
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=30)
    data = None if body is None else json.dumps(body).encode()
    conn.request(method, path, body=data,
                 headers={"Content-Type": "application/json",
                          **(headers or {})})
    resp = conn.getresponse()
    raw = resp.read().decode()
    conn.close()
    try:
        payload = json.loads(raw)
    except ValueError:
        payload = raw
    return resp.status, {k.lower(): v for k, v in resp.getheaders()}, \
        payload


def counters(registry, metrics):
    """Every counter sample and each histogram's count on a gateway's
    registry."""
    out = {}
    for name, fam in metrics.parse_exposition(registry.render()).items():
        if fam.type == "counter":
            out[name] = dict(fam.samples)
        elif fam.type == "histogram":
            out[name] = {k: h.count for k, h in fam.histograms.items()}
    return out


def overloaded(body):
    return 429, {"error": {"message": "full", "type": "overloaded"}}


def ok(body):
    return 200, {"choices": [{"text": "ok", "finish_reason": "stop"}],
                 "echo_timeout": body.get("timeout")}


def slow_ok(body):
    return ok(body) + (0.1,)


def draining(body):
    return 503, {"error": {"message": "draining", "type": "draining"}}


DEAD = "http://127.0.0.1:1"

# name -> (replicas {name: behavior or DEAD}, prefix owner, requests)
SCENARIOS = {
    "failover_under_deadline": (
        {"a": overloaded, "b": slow_ok}, "a",
        [({"prompt": "s" * 640, "max_tokens": 4, "timeout": 5.0}, {})]),
    "failover_draining": (
        {"a": draining, "b": ok}, "a",
        [({"prompt": "d" * 640, "timeout": 5.0}, {})]),
    "exhausted_deadline": (
        {"a": overloaded, "a2": overloaded}, None,
        [({"prompt": "x", "timeout": 0.02}, {})]),
    "all_overloaded": (
        {"a": overloaded, "b": overloaded}, None,
        [({"prompt": "x"}, {})]),
    "shed_budget": (
        {"a": overloaded, "b": overloaded, "c": overloaded}, None,
        [({"prompt": "x", "priority": "batch"}, {}),
         ({"prompt": "y", "priority": "interactive"}, {}),
         ({"prompt": "z"}, {"X-Priority": "standard"})]),
    "priority_forwarding": (
        {"a": ok}, None,
        [({"prompt": "x", "priority": "batch"}, {}),
         ({"prompt": "x"}, {"X-Priority": "interactive"}),
         ({"prompt": "x"}, {}),
         ({"prompt": "x", "priority": "urgent"}, {}),
         ({"prompt": "x"}, {"X-Request-Id": "given-id-1"})]),
    "session_affinity": (
        {"a": ok, "b": ok, "c": ok}, None,
        [({"prompt": "q" * 300}, {"X-Session-Id": "sess-1"}),
         ({"prompt": "q" * 300, "user": "sess-2"}, {}),
         ({"messages": [{"role": "user", "content": "hi " * 50}]}, {})]),
    "one_unreachable": (
        {"dead": DEAD, "b": ok}, "dead",
        [({"prompt": "u" * 640}, {})]),
    "all_unreachable": (
        {"dead": DEAD, "dead2": "http://127.0.0.1:2"}, None,
        [({"prompt": "u"}, {})]),
    "bad_bodies": (
        {"a": ok}, None,
        [({"prompt": "x", "timeout": "soon"}, {}), ("not json", {})]),
}


def run_scenario(side, name):
    replicas, owner, requests = SCENARIOS[name]
    fakes = {n: FakeReplica(b) for n, b in replicas.items() if b != DEAD
             and not isinstance(b, str)}
    targets = {n: (fakes[n].url if n in fakes else b)
               for n, b in replicas.items()}
    metrics = ref_metrics if side is RefGateway else port_metrics
    reg = metrics.Registry()
    gw = side(targets, reg)
    try:
        if owner is not None:
            gw.router.record_route(owner, port_gw.text_blocks(
                requests[0][0]["prompt"]))
        answers = []
        for body, headers in requests:
            t0 = time.monotonic()
            if isinstance(body, str):
                conn = http.client.HTTPConnection("127.0.0.1", gw.port,
                                                  timeout=30)
                conn.request("POST", "/v1/completions", body=body.encode())
                resp = conn.getresponse()
                status, h, payload = resp.status, {}, json.loads(resp.read())
                conn.close()
            else:
                path = ("/v1/chat/completions" if "messages" in body
                        else "/v1/completions")
                status, h, payload = call(gw.port, "POST", path, body,
                                          headers)
            answers.append({"status": status, "body": payload,
                            "elapsed": time.monotonic() - t0,
                            "retry_after": h.get("retry-after"),
                            "replica": h.get("x-gateway-replica"),
                            "request_id": h.get("x-request-id")})
        hits = {n: [(b, {k.lower(): v for k, v in hd.items()})
                    for b, hd in f.hits] for n, f in fakes.items()}
        return answers, hits, counters(reg, metrics)
    finally:
        gw.close()
        for f in fakes.values():
            f.close()


def _strip_timeouts(answers, hits):
    """Forwarded timeouts apart (time-dependent), with the seconds the
    scenario's requests took, and the exception text of a 502 (aiohttp's
    and http.client's differ)."""
    timeouts = []
    elapsed = sum(a["elapsed"] for a in answers)
    for a in answers:
        if isinstance(a["body"], dict):
            echoed = a["body"].pop("echo_timeout", None)
            if echoed is not None:
                timeouts.append(echoed)
            err = a["body"].get("error")
            if isinstance(err, dict) and err.get("type") == "unreachable":
                err["message"] = err["message"].split(" unreachable:")[0]
        a.pop("elapsed")
        if a["request_id"] and a["request_id"].startswith("req-"):
            a["request_id"] = "minted"
    for n, hs in hits.items():
        for body, headers in hs:
            if "timeout" in body:
                timeouts.append(body.pop("timeout"))
            for k in list(headers):
                if k not in ("x-priority", "x-request-id",
                             "content-type"):
                    del headers[k]
            if headers.get("x-request-id", "").startswith("req-"):
                headers["x-request-id"] = "minted"
    return timeouts, elapsed


@pytest.mark.parametrize("name", sorted(SCENARIOS))
def test_gateway_answers_as_the_reference(name):
    ref = run_scenario(RefGateway, name)
    port = run_scenario(PortGateway, name)
    ref_t, ref_s = _strip_timeouts(ref[0], ref[1])
    port_t, port_s = _strip_timeouts(port[0], port[1])
    assert port[0] == ref[0]
    assert port[1] == ref[1]
    assert port[2] == ref[2]
    # Every hop forwards what is left of the 5 s budget: at most 5 s, and
    # at least 5 s less what the requests took, within 50 ms, on each side.
    assert len(port_t) == len(ref_t)
    for forwarded, took in ((port_t, port_s), (ref_t, ref_s)):
        assert all(5.0 - took - 0.05 <= t <= 5.0 for t in forwarded)


def test_failover_forwards_the_remaining_budget():
    """The reference's own test's bounds, on the port: the hop to b
    carries the remaining budget, not the original 5 s, and the
    overloaded replica saw the request first."""
    answers, hits, count = run_scenario(PortGateway,
                                        "failover_under_deadline")
    (a,) = answers
    echoed = a["body"]["echo_timeout"]
    assert a["status"] == 200 and a["replica"] == "b"
    assert 5.0 - a["elapsed"] - 0.05 <= echoed < 5.0
    assert len(hits["a"]) == 1 and len(hits["b"]) == 1
    assert count["gateway_retries_total"] == {(("reason", "overloaded"),): 1}


def test_shed_budget_and_passthrough_on_the_port():
    answers, hits, count = run_scenario(PortGateway, "shed_budget")
    assert [a["status"] for a in answers] == [429, 429, 429]
    # The replica's Retry-After (1), not the gateway's fallthrough (2).
    assert answers[0]["retry_after"] == "1"
    assert sum(len(h) for h in hits.values()) == 2 + 3 + 3
    assert count["gateway_shed_passthrough_total"] == {
        (("class", "batch"),): 1}


def test_unready_without_backends():
    for side, metrics in ((RefGateway, ref_metrics),
                          (PortGateway, port_metrics)):
        gw = side({}, metrics.Registry())
        try:
            status, _, body = call(gw.port, "GET", "/")
            assert status == 503 and body["replicas_healthy"] == 0
            assert body["status"] == "no healthy replica"
            status, h, text = call(gw.port, "GET", "/metrics")
            assert status == 200 and "gateway_replicas_healthy 0" in text
            assert call(gw.port, "GET", "/healthz")[2] == {"ok": True}
            status, h, body = call(gw.port, "POST", "/v1/completions",
                                   {"prompt": "x"})
            assert status == 503 and h["retry-after"] == "5"
            assert body["error"]["type"] == "unavailable"
        finally:
            gw.close()


# ---------------------------------------------------------------------------
# The port alone: SSE relay and the in-flight count
# ---------------------------------------------------------------------------

class StreamingReplica:
    """An SSE replica: one chunk, then more chunks only as ``chunks``
    allows (a generator of byte strings, consumed per request)."""

    def __init__(self, stream):
        self.done = threading.Event()
        fake = self

        class Handler(BaseHTTPRequestHandler):
            protocol_version = "HTTP/1.0"

            def do_POST(self):  # noqa: N802
                self.rfile.read(int(self.headers["Content-Length"]))
                self.send_response(200)
                self.send_header("Content-Type", "text/event-stream")
                self.end_headers()
                try:
                    for chunk in stream():
                        self.wfile.write(chunk)
                        self.wfile.flush()
                except OSError:
                    pass
                finally:
                    fake.done.set()

            def log_message(self, *args):
                pass

        self.httpd = ThreadingHTTPServer(("127.0.0.1", 0), Handler)
        threading.Thread(target=self.httpd.serve_forever,
                         daemon=True).start()
        self.url = f"http://127.0.0.1:{self.httpd.server_address[1]}"


def test_sse_chunk_reaches_the_client_before_the_stream_ends():
    release = threading.Event()

    def stream():
        yield b'data: {"choices": [{"text": "first"}]}\n\n'
        release.wait(20)
        yield b'data: {"choices": [{"text": " second"}]}\n\ndata: [DONE]\n\n'

    replica = StreamingReplica(stream)
    gw = PortGateway({"a": replica.url}, port_metrics.Registry())
    try:
        conn = http.client.HTTPConnection("127.0.0.1", gw.port, timeout=30)
        conn.request("POST", "/v1/completions",
                     body=json.dumps({"prompt": "x", "stream": True}),
                     headers={"Content-Type": "application/json"})
        resp = conn.getresponse()
        assert resp.status == 200
        assert resp.getheader("Content-Type") == "text/event-stream"
        assert resp.getheader("X-Gateway-Replica") == "a"
        first = resp.read1(65536)
        # The replica still holds its stream open: the gateway relayed
        # the first chunk as it came.
        assert b"first" in first and not replica.done.is_set()
        release.set()
        rest = resp.read()
        conn.close()
        assert (first + rest).endswith(b"data: [DONE]\n\n")
        assert b" second" in rest
    finally:
        release.set()
        gw.close()
        replica.httpd.shutdown()


def test_inflight_returns_to_zero_after_a_client_disconnects():
    stop = threading.Event()

    def stream():
        for i in range(400):
            if stop.is_set():
                return
            yield f'data: {{"choices": [{{"text": "{i}"}}]}}\n\n'.encode()
            time.sleep(0.05)

    replica = StreamingReplica(stream)
    gw = PortGateway({"a": replica.url}, port_metrics.Registry())
    try:
        sock = socket.create_connection(("127.0.0.1", gw.port), timeout=10)
        body = json.dumps({"prompt": "x", "stream": True}).encode()
        sock.sendall(b"POST /v1/completions HTTP/1.1\r\nHost: x\r\n"
                     b"Content-Type: application/json\r\n"
                     + f"Content-Length: {len(body)}\r\n\r\n".encode()
                     + body)
        # The gateway flushes the status line and headers before the
        # replica's first event: under load they arrive in a segment of
        # their own, so read until the first event is in.
        got = b""
        while b"data:" not in got:
            chunk = sock.recv(65536)
            assert chunk, got
            got += chunk
        with gw.router._lock:
            assert gw.router._replicas["a"].inflight == 1
        sock.close()
        t_close = time.monotonic()
        while time.monotonic() - t_close < 10:
            with gw.router._lock:
                if gw.router._replicas["a"].inflight == 0:
                    break
            time.sleep(0.02)
        with gw.router._lock:
            assert gw.router._replicas["a"].inflight == 0
        # The replica's stream runs 20 s: the disconnect, not the end of
        # the stream, released the count.
        assert time.monotonic() - t_close < 5
    finally:
        stop.set()
        gw.close()
        replica.httpd.shutdown()


# ---------------------------------------------------------------------------
# Port replicas behind the port gateway
# ---------------------------------------------------------------------------

def test_port_replicas_behind_the_port_gateway():
    from runbooks_tpu_torch.serve.api import _encode, create_server, load_model
    from runbooks_tpu_torch.train.data import load_tokenizer

    cfg, params = load_model({"model": "debug"}, device="cpu")
    servers, threads = {}, []
    for name in ("r0", "r1"):
        srv = create_server(cfg, params, host="127.0.0.1", port=0,
                            device="cpu", max_slots=4, max_seq_len=128,
                            kv_paging=True)
        servers[name] = srv
        t = threading.Thread(target=srv.serve_forever, daemon=True)
        t.start()
        threads.append(t)
    ports = {n: s.port for n, s in servers.items()}
    gw = PortGateway({n: f"http://127.0.0.1:{p}" for n, p in ports.items()},
                     port_metrics.Registry())
    try:
        greedy = {"max_tokens": 6, "temperature": 0}
        bodies = [("/v1/completions", {"prompt": "the gateway routes",
                                       **greedy}),
                  ("/v1/chat/completions",
                   {"messages": [{"role": "user", "content": "hello"}],
                    **greedy})]
        for path, body in bodies:
            status, h, via = call(gw.port, "POST", path, body)
            assert status == 200, via
            replica = h["x-gateway-replica"]
            status, _, direct = call(ports[replica], "POST", path, body)
            assert via["choices"] == direct["choices"]
            rid = h["x-request-id"]
            events = call(gw.port, "GET",
                          f"/debug/flight?request_id={rid}")[2]
            assert events["component"] == "gateway"
            assert "route_decision" in {e["name"]
                                        for e in events["events"]}
            assert set(events["replicas"]) == {"r0", "r1"}
            rep = call(ports[replica], "GET",
                       f"/debug/flight?request_id={rid}")[2]
            assert "prefill" in {e["name"] for e in rep["events"]}
        text = via_text = call(gw.port, "POST", "/v1/completions",
                               bodies[0][1])[2]["choices"][0]["text"]
        conn = http.client.HTTPConnection("127.0.0.1", gw.port, timeout=60)
        conn.request("POST", "/v1/completions",
                     body=json.dumps({**bodies[0][1], "stream": True}),
                     headers={"Content-Type": "application/json"})
        raw = conn.getresponse().read().decode()
        conn.close()
        events = [ln[6:] for ln in raw.split("\n")
                  if ln.startswith("data: ")]
        assert events[-1] == "[DONE]"
        assert "".join(json.loads(e)["choices"][0]["text"]
                       for e in events[:-1]) == via_text == text
        prefix = "a deployment's shared system prompt, " * 3
        status, _, reply = call(gw.port, "POST", "/v1/prefix",
                                {"prompt": prefix})
        assert status == 200 and reply["replicas"] == 2
        assert reply["cached_prefix_len"] >= 16
        ids = _encode(load_tokenizer(None), prefix)
        assert all(s.worker.engine.has_prefix(ids)
                   for s in servers.values())
        blocks = port_gw.text_blocks(prefix)
        with gw.router._lock:
            assert blocks and all(r.shadow.match(blocks) == len(blocks)
                                  for r in gw.router._replicas.values())
    finally:
        gw.close()
        for srv in servers.values():
            srv.shutdown()
        for t in threads:
            t.join(timeout=30)
