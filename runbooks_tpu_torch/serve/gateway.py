"""Prefix-aware serving gateway: N replicas acting like one big engine
(the port of ``runbooks_tpu.serve.gateway``, on the standard library).

A Server with ``spec.gateway.enabled`` gets this data plane in front of
its replica pods. Without it the k8s Service sprays requests at random,
which throws away the KV-cache locality the paged engine's radix tree
(serve/paging.py) builds. The gateway routes every ``/v1/*`` request by

- **longest expected prefix-cache match**: a per-replica *shadow radix
  index* over the routing keys of recently routed prompts, an estimate of
  what each replica's prefix cache holds. It is refreshed against each
  replica's scraped ``serve_kv_pages_shared`` / ``serve_requests_total``,
  so it tracks real eviction (shadow capped to the replica's live shared
  page count) and restarts (a counter reset clears it). Routing keys are
  fixed-size blocks: token-id pages when the caller supplies token ids
  (the in-process ``Router``), fixed-width character blocks of the
  prompt text on the HTTP path: identical text prefixes tokenize to
  identical token-id prefixes, which is all prefix matching needs.
- **live load**: queue depth, active slots and queue-wait p90 scraped
  from each replica's ``/metrics``, plus the gateway's own in-flight
  count per replica, break prefix ties and route cold prompts to the
  least-loaded replica.
- **session affinity**: a consistent-hash ring (stable SHA-1 points, so
  every gateway replica, the reference's included, agrees) pins
  multi-turn sessions (``X-Session-Id`` header or OpenAI ``user`` field)
  to one replica; removing an unrelated replica does not remap a session.
- **deadline-aware failover**: a pick that answers 429/503 (or is
  unreachable) retries on the next-ranked replica with the request's
  REMAINING deadline budget: the forwarded ``timeout`` field shrinks by
  the time already spent, so the client's end-to-end deadline holds
  across hops.

The HTTP front end is a ``ThreadingHTTPServer`` whose handler threads
proxy with ``http.client`` (the card has no aiohttp); server-sent events
are relayed chunk by chunk as they arrive. The gateway process needs no
GPU and imports no torch. Run: ``python -m runbooks_tpu_torch.serve.gateway``
(``RBT_GATEWAY_TARGETS=name=http://host:port,...``, ``RBT_GATEWAY_POLICY``,
``RBT_GATEWAY_BLOCK_CHARS``, ``RBT_GATEWAY_AFFINITY``,
``RBT_GATEWAY_PORT``; in a cluster ``RBT_GATEWAY_SERVER`` and
``RBT_GATEWAY_NAMESPACE`` discover the replica pods instead).
"""

from __future__ import annotations

import hashlib
import http.client
import json
import os
import random
import signal
import threading
import time
import urllib.parse
import urllib.request
from bisect import bisect_left
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Callable, Dict, Iterable, List, Optional, Sequence, Tuple

from runbooks_tpu_torch.obs import flight as obs_flight
from runbooks_tpu_torch.obs import metrics as obs_metrics
from runbooks_tpu_torch.obs.trace import (
    instant,
    mint_traceparent,
    record_enabled,
    request_scope,
    span,
)

GATEWAY_PORT = 8080

# Character width of one routing-key block on the HTTP path. ~4 chars per
# token means 64 chars ~ one 16-token KV page — the granularity the paged
# engine shares at. Coarser blocks under-count matches; finer ones make
# the shadow index bigger for no routing benefit.
DEFAULT_BLOCK_CHARS = 64

# Longest prompt prefix the gateway keys on, in blocks. Locality lives in
# system prompts / templates at the front; keying deeper just grows the
# shadow.
MAX_KEY_BLOCKS = 64

# Default per-replica shadow cap when the replica exports no page gauges
# (dense engines): bounded memory, LRU keeps the hot prefixes.
DEFAULT_SHADOW_BLOCKS = 4096

DEFAULT_SCRAPE_INTERVAL_S = 2.0

# Queue depth at which a replica forfeits its prefix preference: re-prefilling
# a shared prefix elsewhere is cheaper than queueing behind this much work.
PREFIX_SPILL_QUEUE = 8

# Per-class scaling of the spill threshold: batch work forfeits its prefix preference at half
# the queue depth (it can afford the re-prefill elsewhere), interactive
# work holds its cache locality twice as deep (TTFT is its SLO). The
# keys are the serve tier's QoS classes (serve/engine.py PRIORITY_RANK).
SPILL_SCALE = {"interactive": 2.0, "standard": 1.0, "batch": 0.5}

# Failover budget for QoS-shed 429s, per class. A 429 now carries a
# load-derived Retry-After (serve/api.py): under fleet-wide overload,
# hammering the shed request across every remaining backend just
# multiplies the load that caused the shed. Each class gets a bounded
# number of 429-driven failover hops; past the budget the shed (and its
# Retry-After hint) passes through to the client. Unreachable-replica
# failover stays unbounded — a down backend is not backpressure.
SHED_RETRY_BUDGET = {"interactive": 3, "standard": 2, "batch": 1}


def text_blocks(text: str, block_chars: int = DEFAULT_BLOCK_CHARS,
                max_blocks: int = MAX_KEY_BLOCKS) -> List[str]:
    """Routing-key blocks for a prompt string (see module docstring)."""
    return [text[i * block_chars:(i + 1) * block_chars]
            for i in range(min(len(text) // block_chars, max_blocks))]


def token_blocks(tokens: Sequence[int], block_tokens: int = 16,
                 max_blocks: int = MAX_KEY_BLOCKS) -> List[tuple]:
    """Routing-key blocks over token ids (in-process router callers),
    at KV-page granularity so the shadow mirrors the engine's radix."""
    return [tuple(int(t) for t in
                  tokens[i * block_tokens:(i + 1) * block_tokens])
            for i in range(min(len(tokens) // block_tokens, max_blocks))]


class ShadowIndex:
    """Trie over routing-key blocks: the gateway's estimate of one
    replica's prefix-cache content. Same shape as the engine's RadixTree
    (serve/paging.py) minus the page ownership — nodes are blocks, LRU
    recency on match/record, trim() evicts LRU leaves when the replica's
    scraped shared-page count says the real cache shrank. All access goes
    through the owning Router's lock."""

    class _Node:
        __slots__ = ("children", "parent", "edge", "last_used")

        def __init__(self, parent=None, edge=None):
            self.children: dict = {}
            self.parent = parent
            self.edge = edge
            self.last_used = 0

    def __init__(self, max_blocks: int = DEFAULT_SHADOW_BLOCKS):
        self.max_blocks = max_blocks
        self.root = self._Node()
        self.blocks = 0
        self._clock = 0

    def match(self, blocks: Sequence) -> int:
        """Leading blocks present in the shadow (the expected prefix-cache
        hit length, in blocks). Refreshes recency on the matched path."""
        self._clock += 1
        node, n = self.root, 0
        for b in blocks:
            child = node.children.get(b)
            if child is None:
                break
            child.last_used = self._clock
            node, n = child, n + 1
        return n

    def record(self, blocks: Sequence) -> None:
        """Mark the prefix as (expected) resident on the replica."""
        self._clock += 1
        node = self.root
        for b in blocks:
            child = node.children.get(b)
            if child is None:
                child = self._Node(parent=node, edge=b)
                node.children[b] = child
                self.blocks += 1
            child.last_used = self._clock
            node = child
        if self.blocks > self.max_blocks:
            self.trim(self.max_blocks)

    def trim(self, cap: int) -> int:
        """Evict LRU leaves until at most ``cap`` blocks remain (the
        replica's scraped shared-page count shrank — its radix evicted,
        so the shadow must forget too). Returns blocks dropped."""
        dropped = 0
        while self.blocks > max(cap, 0):
            leaves = []
            stack = [self.root]
            while stack:
                n = stack.pop()
                for c in n.children.values():
                    (stack if c.children else leaves).append(c)
            if not leaves:
                break
            leaves.sort(key=lambda n: n.last_used)
            for leaf in leaves[:self.blocks - max(cap, 0)]:
                del leaf.parent.children[leaf.edge]
                self.blocks -= 1
                dropped += 1
        return dropped

    def clear(self) -> None:
        self.root = self._Node()
        self.blocks = 0


class _HashRing:
    """Consistent-hash ring with stable (SHA-1) points: every gateway
    replica computes the same session->replica mapping, and removing one
    replica only remaps the sessions it owned."""

    def __init__(self, names: Iterable[str], vnodes: int = 64):
        self._points: List[Tuple[int, str]] = []
        for name in names:
            for i in range(vnodes):
                self._points.append((self._hash(f"{name}#{i}"), name))
        self._points.sort()

    @staticmethod
    def _hash(key: str) -> int:
        return int.from_bytes(
            hashlib.sha1(key.encode("utf-8")).digest()[:8], "big")

    def owner(self, key: str) -> Optional[str]:
        if not self._points:
            return None
        h = self._hash(key)
        i = bisect_left(self._points, (h, ""))
        return self._points[i % len(self._points)][1]


class ReplicaState:
    """One backend replica as the gateway sees it."""

    __slots__ = ("name", "url", "healthy", "active_slots", "queue_depth",
                 "queue_wait_p90_ms", "inflight", "shadow",
                 "requests_total", "shared_pages")

    def __init__(self, name: str, url: str):
        self.name = name
        self.url = url.rstrip("/")
        self.healthy = True   # optimistic until a scrape/proxy says otherwise
        self.active_slots = 0.0
        self.queue_depth = 0.0
        self.queue_wait_p90_ms = 0.0
        self.inflight = 0
        self.shadow = ShadowIndex()
        self.requests_total: Optional[float] = None
        self.shared_pages: Optional[int] = None


class Router:
    """Routing brain shared by the HTTP gateway and in-process callers.

    Thread-safety: the metrics poller (a plain thread) and the HTTP
    handler threads both touch the replica table, so every access to
    ``_replicas``/``_ring`` holds ``_lock`` — critical sections are
    short (no I/O under the lock)."""

    def __init__(self, targets: Optional[Dict[str, str]] = None,
                 policy: str = "prefix",
                 registry: Optional[obs_metrics.Registry] = None,
                 shadow_blocks: int = DEFAULT_SHADOW_BLOCKS,
                 session_affinity: bool = True,
                 spill_queue: int = PREFIX_SPILL_QUEUE):
        if policy not in ("prefix", "random"):
            raise ValueError(f"unknown routing policy {policy!r} "
                             "(expected prefix|random)")
        self.policy = policy
        self.registry = registry if registry is not None else \
            obs_metrics.Registry()
        self.session_affinity = session_affinity
        self.spill_queue = spill_queue
        self.shadow_blocks = shadow_blocks
        self._lock = threading.Lock()
        self._replicas: Dict[str, ReplicaState] = {}   # guarded-by: _lock
        self._ring = _HashRing(())                     # guarded-by: _lock
        self._rng = random.Random(0)                   # guarded-by: _lock
        if targets:
            self.set_replicas(targets)

    # -- replica set ---------------------------------------------------

    def set_replicas(self, targets: Dict[str, str]) -> None:
        """Reconcile the backend set: new names join with an empty shadow,
        vanished names drop (their mirrored gauges too). Surviving
        replicas keep their shadow — a scale event must not blind the
        router to every cache it already mapped."""
        with self._lock:
            for name, url in targets.items():
                if name not in self._replicas:
                    self._replicas[name] = ReplicaState(name, url)
                    self._replicas[name].shadow.max_blocks = \
                        self.shadow_blocks
                else:
                    self._replicas[name].url = url.rstrip("/")
            for name in [n for n in self._replicas if n not in targets]:
                del self._replicas[name]
                self.registry.drop_series(backend=name)
            self._ring = _HashRing(sorted(self._replicas))

    def replica_names(self) -> List[str]:
        with self._lock:
            return sorted(self._replicas)

    def healthy_count(self) -> int:
        with self._lock:
            return sum(1 for r in self._replicas.values() if r.healthy)

    # -- telemetry in --------------------------------------------------

    def observe_metrics(self, name: str,
                        families: Optional[dict]) -> None:
        """Fold one scrape of a replica's /metrics into the routing state.
        ``families`` is a parse_exposition() dict, or None when the scrape
        failed (marks the replica unhealthy). The shadow refresh is where
        the gateway's picture tracks REAL cache state: a shrinking
        ``serve_kv_pages_shared`` trims the shadow to match, a
        ``serve_requests_total`` reset (replica restart) clears it."""
        with self._lock:
            rep = self._replicas.get(name)
            if rep is None:
                return
            if families is None:
                rep.healthy = False
                return
            rep.healthy = True

            def val(fam: str, default=None):
                f = families.get(fam)
                return f.total() if f is not None and f.samples else default

            rep.active_slots = float(val("serve_active_slots", 0.0))
            rep.queue_depth = float(val("serve_queue_depth", 0.0))
            qw = families.get("serve_queue_wait_seconds")
            hist = qw.merged_histogram() if qw is not None else None
            if hist is not None and hist.count:
                rep.queue_wait_p90_ms = hist.quantile(0.90) * 1000.0
            total = val("serve_requests_total")
            if total is not None:
                if rep.requests_total is not None \
                        and total < rep.requests_total:
                    # Counter reset = replica restarted = caches gone.
                    rep.shadow.clear()
                rep.requests_total = total
            shared = val("serve_kv_pages_shared")
            if shared is not None:
                rep.shared_pages = int(shared)
                if rep.shadow.blocks > rep.shared_pages:
                    # The replica's radix evicted below what we routed;
                    # forget the same amount (LRU both sides).
                    rep.shadow.trim(rep.shared_pages)

    def mark_unreachable(self, name: str) -> None:
        with self._lock:
            rep = self._replicas.get(name)
            if rep is not None:
                rep.healthy = False

    # -- routing -------------------------------------------------------

    def _load(self, rep: ReplicaState) -> float:
        # Inflight counts twice: it is load the scrape hasn't seen yet.
        return rep.active_slots + rep.queue_depth + 2.0 * rep.inflight

    def pick(self, blocks: Sequence, session_key: Optional[str] = None,
             priority: str = "standard") -> List[Tuple[str, str]]:
        """Ranked (replica_name, reason) candidates for one request.
        Reason of the head pick: ``affinity`` (session ring owner),
        ``prefix`` (longest shadow match won), ``load`` (no prefix signal
        — least loaded), or ``random`` (policy=random). Later entries are
        the failover order (reason ``failover``). ``priority`` scales the
        prefix-spill threshold (SPILL_SCALE): batch traffic spills off a
        queued replica before interactive traffic does."""
        spill = self.spill_queue * SPILL_SCALE.get(priority, 1.0)
        with self._lock:
            healthy = [r for r in self._replicas.values() if r.healthy]
            if not healthy:
                return []
            if self.policy == "random":
                order = list(healthy)
                self._rng.shuffle(order)
                return [(r.name, "random" if i == 0 else "failover")
                        for i, r in enumerate(order)]
            match = {r.name: r.shadow.match(blocks) for r in healthy}
            # Deep queues forfeit prefix preference: past the (class-
            # scaled) spill threshold the queue wait dominates what the
            # prefix hit would save.
            score = {r.name: (match[r.name]
                              if r.queue_depth < spill else 0)
                     for r in healthy}
            ranked = sorted(
                healthy,
                key=lambda r: (-score[r.name], self._load(r),
                               r.queue_wait_p90_ms,
                               _HashRing._hash(r.name)))
            head_reason = ("prefix" if score[ranked[0].name] > 0
                           else "load")
            out = [(r.name, "failover") for r in ranked]
            out[0] = (ranked[0].name, head_reason)
            if self.session_affinity and session_key:
                owner = self._ring.owner(session_key)
                if owner is not None and owner in match \
                        and self._replicas[owner].healthy:
                    rest = [(n, "failover") for n, _ in out if n != owner]
                    return [(owner, "affinity")] + rest
            return out

    def record_route(self, name: str, blocks: Sequence) -> None:
        """Commit a successful route into the replica's shadow (the
        replica now holds — or is about to hold — this prefix)."""
        with self._lock:
            rep = self._replicas.get(name)
            if rep is not None and blocks:
                rep.shadow.record(blocks)

    def inflight_add(self, name: str, delta: int) -> None:
        with self._lock:
            rep = self._replicas.get(name)
            if rep is not None:
                rep.inflight = max(0, rep.inflight + delta)

    # -- telemetry out -------------------------------------------------

    def export_gauges(self) -> None:
        """Scrape-time gauges on the gateway's registry."""
        with self._lock:
            self.registry.set_gauge(
                "gateway_replicas_healthy", self.healthy_count_locked(),
                help_text="Backend replicas the gateway currently "
                          "considers routable.")
            # Per-backend series label on the gateway's own exposition
            # is `backend`, NOT `replica`: the fleet scraper mirrors
            # these families with replica=<gateway pod> (the scraped
            # pod's identity wins on collision), so a replica-named
            # label here would collapse every backend onto one series
            # in the controller mirror.
            for rep in self._replicas.values():
                self.registry.set_gauge(
                    "gateway_shadow_blocks", rep.shadow.blocks,
                    backend=rep.name,
                    help_text="Routing-key blocks in the per-backend "
                              "shadow prefix index.")

    def healthy_count_locked(self) -> int:  # guarded-by: _lock
        return sum(1 for r in self._replicas.values() if r.healthy)


class MetricsPoller:
    """Background thread scraping every replica's /metrics into the
    Router (the same degradation contract as the controller's fleet
    scraper: one unreachable replica marks itself down, never the
    sweep). ``poll_once`` is synchronous for tests and tools."""

    def __init__(self, router: Router, timeout_s: float = 2.0,
                 discover=None):
        self.router = router
        self.timeout_s = timeout_s
        # Optional replica discovery hook: () -> {name: url}; polled
        # every sweep so a scale event updates the backend set without a
        # gateway restart (the k8s main() wires pod listing here).
        self.discover = discover
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None

    def poll_once(self) -> int:
        if self.discover is not None:
            try:
                targets = self.discover()
            except Exception as exc:  # noqa: BLE001 — discovery outage
                print(f"gateway: replica discovery failed: {exc!r}",
                      flush=True)
                targets = None
            if targets is not None:
                self.router.set_replicas(targets)
        ok = 0
        with self.router._lock:
            urls = {r.name: r.url for r in self.router._replicas.values()}
        for name, url in urls.items():
            families = None
            try:
                with urllib.request.urlopen(f"{url}/metrics",
                                            timeout=self.timeout_s) as resp:
                    families = obs_metrics.parse_exposition(
                        resp.read().decode("utf-8", "replace"))
                ok += 1
            except (OSError, ValueError):
                families = None
            self.router.observe_metrics(name, families)
        return ok

    def start(self, interval_s: float = DEFAULT_SCRAPE_INTERVAL_S) -> None:
        def run():
            while not self._stop.is_set():
                try:
                    self.poll_once()
                except Exception:  # noqa: BLE001 — keep the loop alive
                    pass  # per-replica errors are already contained; this
                    # catch only guards discovery/bookkeeping bugs from
                    # killing the data plane's telemetry loop
                self._stop.wait(interval_s)

        self._thread = threading.Thread(target=run, daemon=True)
        self._thread.start()

    def stop(self) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=5)



# ---------------------------------------------------------------------------
# HTTP gateway
# ---------------------------------------------------------------------------

# Largest request body the gateway reads (aiohttp's default client_max_size
# in the reference).
_MAX_BODY_BYTES = 1 << 20
# Total seconds of one hop when the request carries no deadline.
_HOP_TIMEOUT_S = 600.0
# Bytes per read of an upstream body; an SSE chunk is relayed as soon as
# one read returns it.
_READ_BYTES = 65536
_GET_ROUTES = ("/", "/healthz", "/metrics", "/debug/flight")
_POST_ROUTES = ("/v1/completions", "/v1/chat/completions", "/v1/prefix")


def _render_chat_prompt(messages: list) -> str:
    """The same role-prefix rendering serve/api.py falls back to — the
    routing key must track what the replica will actually prefill."""
    parts = [f"{m.get('role', 'user')}: {m.get('content', '')}"
             for m in messages if isinstance(m, dict)]
    return "\n".join(parts) + "\nassistant:"


class _HopTimeout(Exception):
    """The hop's total budget ran out (``http.client`` times out each
    socket operation, not the whole exchange)."""


class _Hop:
    """One POST to a replica under a total time budget: every socket
    operation gets what is left of it, and a read past it raises
    ``_HopTimeout``."""

    def __init__(self, url: str, path: str, body: dict,
                 headers: Dict[str, str], total_s: float):
        parts = urllib.parse.urlsplit(url)
        conn_cls = (http.client.HTTPSConnection if parts.scheme == "https"
                    else http.client.HTTPConnection)
        self.deadline = time.monotonic() + total_s
        self.conn = conn_cls(parts.hostname, parts.port, timeout=total_s)
        try:
            self.conn.request(
                "POST", parts.path.rstrip("/") + path,
                body=json.dumps(body).encode("utf-8"),
                headers={"Content-Type": "application/json", **headers})
            self._settle()
            self.resp = self.conn.getresponse()
        except BaseException:
            self.conn.close()
            raise
        self.status = self.resp.status

    def _settle(self) -> None:
        left = self.deadline - time.monotonic()
        if left <= 0:
            raise _HopTimeout("hop deadline passed")
        if self.conn.sock is not None:
            self.conn.sock.settimeout(left)

    def header(self, name: str, default: Optional[str] = None):
        return self.resp.getheader(name, default)

    def chunks(self):
        """The body as it arrives, one read at a time."""
        while True:
            self._settle()
            try:
                data = self.resp.read1(_READ_BYTES)
            except TimeoutError as exc:
                raise _HopTimeout("hop deadline passed") from exc
            if not data:
                return
            yield data

    def read(self) -> bytes:
        return b"".join(self.chunks())

    def close(self) -> None:
        self.conn.close()


class _GatewayHTTPServer(ThreadingHTTPServer):
    # A handler thread blocked on a replica must not hold up shutdown.
    daemon_threads = True
    block_on_close = False


class Gateway:
    """A running gateway: ``serve_forever`` answers (and starts the
    metrics poller) until ``shutdown`` from another thread. ``router``
    and ``poller`` are the routing state; ``port`` is the bound port
    (create with port=0 in tests)."""

    def __init__(self, httpd: ThreadingHTTPServer, router: Router,
                 poller: MetricsPoller, scrape_interval_s: float):
        self.httpd = httpd
        self.router = router
        self.poller = poller
        self.scrape_interval_s = scrape_interval_s
        self._serving = threading.Event()

    @property
    def port(self) -> int:
        return self.httpd.server_address[1]

    def serve_forever(self) -> None:
        if self.scrape_interval_s > 0:
            self.poller.start(self.scrape_interval_s)
        self._serving.set()
        self.httpd.serve_forever(poll_interval=0.1)

    def shutdown(self) -> None:
        if self._serving.is_set():
            self.httpd.shutdown()
        self.poller.stop()
        self.httpd.server_close()


def create_gateway(targets: Optional[Dict[str, str]] = None, *,
                   policy: str = "prefix",
                   block_chars: int = DEFAULT_BLOCK_CHARS,
                   session_affinity: bool = True,
                   request_timeout_s: Optional[float] = None,
                   scrape_interval_s: float = DEFAULT_SCRAPE_INTERVAL_S,
                   discover=None,
                   registry: Optional[obs_metrics.Registry] = None,
                   host: str = "0.0.0.0",
                   port: int = GATEWAY_PORT) -> Gateway:
    """The gateway, bound to ``host:port`` (not yet serving).

    targets: initial {replica_name: base_url}; discover (optional) is
    polled by the metrics loop to refresh the set (k8s pod listing).
    request_timeout_s: default end-to-end deadline for requests that
    carry none of their own; per-request ``timeout`` overrides, and the
    remaining budget rides every failover hop."""
    router = Router(targets, policy=policy, registry=registry,
                    session_affinity=session_affinity)
    poller = MetricsPoller(router, discover=discover)
    # Flight/trace identity: gateway spans land in THIS process's ring
    # (and trace file), labeled as the routing tier; one request id
    # stitches them with the replicas' rings.
    obs_flight.set_component("gateway")
    reg = router.registry
    started = time.time()

    def _session_key(headers, body: dict) -> Optional[str]:
        sid = headers.get("X-Session-Id") or body.get("user")
        return str(sid) if sid else None

    def _blocks_for(body: dict, chat: bool) -> list:
        if chat:
            prompt = _render_chat_prompt(body.get("messages") or [])
        else:
            prompt = body.get("prompt")
            if isinstance(prompt, list):
                prompt = prompt[0] if prompt and isinstance(prompt[0], str) \
                    else ""
            if not isinstance(prompt, str):
                prompt = ""
        return text_blocks(prompt, block_chars)

    def _trace_event(kind: str) -> bool:
        """Count one gateway trace span/instant (only when it actually
        records somewhere) and say whether to record it."""
        if not record_enabled():
            return False
        reg.inc("gateway_trace_spans_total", kind=kind,
                help_text="Gateway trace events recorded into the "
                          "flight ring / trace file, by kind.")
        return True

    class Handler(BaseHTTPRequestHandler):
        # HTTP/1.0: every response closes its connection, which is what
        # ends a relayed SSE stream.
        protocol_version = "HTTP/1.0"

        def log_message(self, fmt, *args):   # one access line of our own
            pass

        # -- responses ---------------------------------------------------

        def _start(self, status: int, headers: Dict[str, str]) -> None:
            self.send_response(status)
            for k, v in headers.items():
                self.send_header(k, v)
            self.end_headers()

        def _send(self, status: int, body: bytes, content_type: str,
                  headers: Optional[Dict[str, str]] = None) -> None:
            self._start(status, {"Content-Type": content_type,
                                 "Content-Length": str(len(body)),
                                 **(headers or {})})
            self.wfile.write(body)

        def _json(self, status: int, payload: dict,
                  headers: Optional[Dict[str, str]] = None) -> None:
            self._send(status, json.dumps(payload).encode("utf-8"),
                       "application/json", headers)

        def _body(self, headers: Optional[Dict[str, str]] = None
                  ) -> Optional[dict]:
            """The JSON object body, or None after a 400/413 reply (with
            ``headers``)."""
            try:
                n = int(self.headers.get("Content-Length") or 0)
            except ValueError:
                n = -1
            if not 0 <= n <= _MAX_BODY_BYTES:
                self._json(413, {"error": {"message": "request body too "
                                                      "large"}}, headers)
                return None
            try:
                body = json.loads(self.rfile.read(n))
            except (ValueError, UnicodeDecodeError):
                body = None
            if not isinstance(body, dict):
                self._json(400, {"error": {"message": "invalid JSON body"}},
                           headers)
                return None
            return body

        # -- routes ------------------------------------------------------

        def do_GET(self):  # noqa: N802
            parts = urllib.parse.urlsplit(self.path)
            if parts.path == "/":
                self._root()
            elif parts.path == "/healthz":
                self._json(200, {"ok": True})
            elif parts.path == "/metrics":
                self._metrics()
            elif parts.path == "/debug/flight":
                rid = urllib.parse.parse_qs(parts.query).get(
                    "request_id", [""])[-1]
                self._debug_flight(rid)
            elif parts.path in _POST_ROUTES:
                self._json(405, {"error": {"message": "method not "
                                                      "allowed"}})
            else:
                self._json(404, {"error": {"message": "not found"}})

        def do_POST(self):  # noqa: N802
            path = urllib.parse.urlsplit(self.path).path
            if path not in _POST_ROUTES:
                status = 405 if path in _GET_ROUTES else 404
                self._json(status, {"error": {"message": (
                    "method not allowed" if status == 405
                    else "not found")}})
                return
            if path == "/v1/prefix":
                self._register_prefix()
            else:
                self._proxy(path, chat=path == "/v1/chat/completions")

        def _root(self) -> None:
            """Readiness: the gateway is ready only while it can route
            somewhere — a gateway with zero healthy backends must fail its
            probe (the Serving gate counts on it)."""
            healthy = router.healthy_count()
            self._json(200 if healthy else 503, {
                "status": "ok" if healthy else "no healthy replica",
                "gateway": True, "replicas_healthy": healthy,
                "policy": router.policy,
                "uptime_s": round(time.time() - started, 1)})

        def _metrics(self) -> None:
            router.export_gauges()
            reg.set_gauge("flight_ring_events",
                          obs_flight.RING.stats()["events"],
                          help_text="Events currently held in the in-memory "
                                    "flight-recorder ring.")
            self._send(200, reg.render().encode("utf-8"),
                       obs_metrics.CONTENT_TYPE)

        def _debug_flight(self, rid: str) -> None:
            """GET /debug/flight[?request_id=]: the gateway's own flight
            ring (route decisions, proxy spans, failovers) plus the
            current backend map, so a caller can fetch each backend's
            ring and merge one gateway→replica timeline."""
            with router._lock:
                replicas = {r.name: r.url
                            for r in router._replicas.values()}
            self._json(200, {
                **obs_flight.identity(),
                "stats": obs_flight.RING.stats(),
                "replicas": replicas,
                "events": obs_flight.RING.snapshot(request_id=rid or None),
            })

        def _register_prefix(self) -> None:
            """Broadcast /v1/prefix to every healthy replica: a registered
            deployment prefix must be resident everywhere or routing away
            from its seed replica loses it. Shadows record it for all."""
            body = self._body()
            if body is None:
                return
            blocks = (text_blocks(body["prompt"], block_chars)
                      if isinstance(body.get("prompt"), str) else
                      token_blocks(body["tokens"])
                      if isinstance(body.get("tokens"), list) else [])
            with router._lock:
                targets_now = [(r.name, r.url) for r in
                               router._replicas.values() if r.healthy]
            if not targets_now:
                self._json(503, {"error": {"message": "no healthy replica"}})
                return
            plens = [0] * len(targets_now)

            def one(i: int, name: str, url: str) -> None:
                try:
                    hop = _Hop(url, "/v1/prefix", body, {}, _HOP_TIMEOUT_S)
                    try:
                        if hop.status == 200:
                            data = json.loads(hop.read())
                            router.record_route(name, blocks)
                            plens[i] = int(data.get("cached_prefix_len", 0))
                    finally:
                        hop.close()
                except (OSError, http.client.HTTPException, _HopTimeout):
                    router.mark_unreachable(name)

            threads = [threading.Thread(target=one, args=(i, n, u))
                       for i, (n, u) in enumerate(targets_now)]
            for t in threads:
                t.start()
            for t in threads:
                t.join()
            self._json(200, {"cached_prefix_len": max(plens),
                             "replicas": len(plens)})

        def _proxy(self, path: str, chat: bool) -> None:
            """Request-scope wrapper: mint/sanitize the request id (the
            same contract as serve/api.py — a client-omitted X-Request-Id
            is generated here, so ONE id stitches gateway and replica),
            proxy, then emit the gateway access-log line: one line per
            proxied request with the chosen replica, retry count,
            upstream status, and proxy latency."""
            rid, tp_out = request_scope(self.headers)
            if tp_out is None:
                # No client trace context: mint a root traceparent so the
                # upstream hop still carries a stitchable W3C context.
                tp_out = mint_traceparent()
            t0 = time.monotonic()
            hop = {"backend": "-", "retries": 0, "upstream_status": "-"}
            status = self._proxy_scoped(path, chat, rid, tp_out, hop)
            print(f"gateway: access {path} rid={rid} status={status} "
                  f"dur_ms={(time.monotonic() - t0) * 1000:.1f} "
                  f"backend={hop['backend']} retries={hop['retries']} "
                  f"upstream={hop['upstream_status']}", flush=True)

        def _reply(self, status: int, payload: dict, rid: str, tp_out: str,
                   headers: Optional[Dict[str, str]] = None) -> int:
            self._json(status, payload, {**(headers or {}),
                                         "X-Request-Id": rid,
                                         "traceparent": tp_out})
            return status

        def _proxy_scoped(self, path: str, chat: bool, rid: str,
                          tp_out: str, hop: dict) -> int:
            body = self._body({"X-Request-Id": rid, "traceparent": tp_out})
            if body is None:
                return 400
            blocks = _blocks_for(body, chat)
            session_key = _session_key(self.headers, body)
            # QoS class for routing: body field beats the X-Priority
            # header; an unknown value routes as standard but still
            # forwards verbatim, so the replica's validation (400) stays
            # the single source of truth on the public surface.
            raw_priority = body.get("priority")
            if not isinstance(raw_priority, str):
                raw_priority = self.headers.get("X-Priority", "")
            route_class = (raw_priority.lower()
                           if raw_priority.lower() in SHED_RETRY_BUDGET
                           else "standard")
            reg.inc("gateway_requests_total",
                    help_text="Requests accepted by the gateway.")
            if session_key:
                reg.inc("gateway_affinity_requests_total",
                        help_text="Requests carrying a session key "
                                  "(X-Session-Id or user).")
            candidates = router.pick(blocks, session_key,
                                     priority=route_class)
            if _trace_event("route"):
                instant("route_decision", request_id=rid,
                        backend=candidates[0][0] if candidates else "-",
                        reason=candidates[0][1] if candidates else "none",
                        candidates=len(candidates))
            if not candidates:
                return self._reply(503, {"error": {
                    "message": "no healthy replica",
                    "type": "unavailable"}}, rid, tp_out,
                    {"Retry-After": "5"})

            # Deadline budget: explicit body timeout wins, else the
            # gateway-level default. Each hop forwards only what remains.
            try:
                budget = (float(body["timeout"]) if body.get("timeout")
                          is not None else request_timeout_s)
            except (TypeError, ValueError):
                return self._reply(400, {"error": {
                    "message": "malformed timeout"}}, rid, tp_out)
            t0 = time.monotonic()
            deadline = t0 + budget if budget else None

            last_status, last_body = 503, {"error": {
                "message": "every replica rejected the request",
                "type": "overloaded"}}
            last_retry_after = "2"
            shed_retries = 0  # 429-driven failover hops burned so far
            for i, (name, reason) in enumerate(candidates):
                remaining = None
                if deadline is not None:
                    remaining = deadline - time.monotonic()
                    if remaining <= 0.05:
                        return self._reply(504, {"error": {
                            "message": "deadline exhausted before a "
                                       "replica accepted",
                            "type": "deadline"}}, rid, tp_out)
                    body["timeout"] = round(remaining, 3)
                with router._lock:
                    rep = router._replicas.get(name)
                    url = rep.url if rep is not None else None
                if url is None:
                    continue
                reg.inc("gateway_route_decisions_total", reason=reason,
                        backend=name,
                        help_text="Routing decisions, labeled by the "
                                  "reason the replica was picked.")
                if reason == "affinity":
                    reg.inc("gateway_affinity_hits_total",
                            help_text="Requests actually routed to their "
                                      "session ring owner.")
                router.inflight_add(name, 1)
                hop["backend"] = name
                if i:
                    hop["retries"] = i
                t_hop = time.perf_counter()
                # Hop stitching: the SAME request id rides upstream (the
                # replica accepts X-Request-Id verbatim), and the
                # traceparent carries the W3C context.
                fwd_headers = {"X-Request-Id": rid, "traceparent": tp_out}
                if raw_priority:
                    # Forward the class verbatim (header form): the
                    # replica orders its admission queue and picks
                    # preemption victims by it.
                    fwd_headers["X-Priority"] = raw_priority
                proxy_span = (span("proxy", request_id=rid, backend=name,
                                   reason=reason, hop=i)
                              if _trace_event("proxy") else None)
                resp = None
                # One finally owns the hop's cleanup (span exit, upstream
                # close, inflight decrement) so EVERY exit — success,
                # failover continue, and a client that disconnects
                # mid-stream — restores the counter; a leaked increment
                # would permanently bias routing away from a healthy
                # replica.
                try:
                    if proxy_span is not None:
                        proxy_span.__enter__()
                    try:
                        # The WHOLE body forwards verbatim: replica-side
                        # fields like response_format ride through
                        # without the gateway learning their schema; the
                        # replica owns validation (typed 400s proxy back
                        # unchanged).
                        resp = _Hop(url, path, body, fwd_headers,
                                    remaining if remaining
                                    else _HOP_TIMEOUT_S)
                    except (OSError, http.client.HTTPException,
                            _HopTimeout) as exc:
                        if proxy_span is not None:
                            proxy_span.__exit__(type(exc), exc, None)
                            proxy_span = None
                        router.mark_unreachable(name)
                        reg.inc("gateway_retries_total",
                                reason="unreachable",
                                help_text="Failovers to the next-ranked "
                                          "replica, by cause.")
                        if _trace_event("retry"):
                            instant("failover", request_id=rid,
                                    backend=name, reason="unreachable")
                        hop["upstream_status"] = "unreachable"
                        last_status, last_body = 502, {"error": {
                            "message": f"replica {name} unreachable: {exc}",
                            "type": "unreachable"}}
                        continue
                    hop["upstream_status"] = resp.status
                    if resp.status in (429, 503) \
                            and i + 1 < len(candidates):
                        # Typed backpressure (serve/api.py): this replica
                        # is full or draining — the next one may not be.
                        last_status = resp.status
                        try:
                            last_body = json.loads(resp.read())
                        except Exception:  # noqa: BLE001 — non-JSON body
                            last_body = {"error": {"message": "overloaded"}}
                        last_retry_after = resp.header(
                            "Retry-After", last_retry_after)
                        if resp.status == 429:
                            # QoS shed with a load-derived Retry-After:
                            # honor the hint past a bounded per-class
                            # budget instead of hammering every remaining
                            # backend with work the fleet just said it
                            # cannot absorb.
                            if shed_retries >= SHED_RETRY_BUDGET[
                                    route_class]:
                                reg.inc("gateway_shed_passthrough_total",
                                        **{"class": route_class},
                                        help_text="QoS-shed 429s returned "
                                                  "to the client after "
                                                  "the per-class retry "
                                                  "budget, with the "
                                                  "replica's Retry-After "
                                                  "hint intact.")
                                if _trace_event("retry"):
                                    instant("shed_passthrough",
                                            request_id=rid, backend=name,
                                            qos=route_class)
                                break
                            shed_retries += 1
                        retry_reason = ("overloaded" if resp.status == 429
                                        else "draining")
                        reg.inc("gateway_retries_total",
                                reason=retry_reason)
                        if _trace_event("retry"):
                            instant("failover", request_id=rid,
                                    backend=name, reason=retry_reason)
                        continue
                    if resp.status < 400:
                        # Only a served request proves the prefix landed
                        # in the replica's cache; errors must not poison
                        # the shadow.
                        router.record_route(name, blocks)
                    return self._relay(resp, name, rid, tp_out, t_hop)
                finally:
                    if proxy_span is not None:
                        proxy_span.__exit__(None, None, None)
                    if resp is not None:
                        resp.close()
                    router.inflight_add(name, -1)
            return self._reply(
                last_status, last_body, rid, tp_out,
                {"Retry-After": last_retry_after}
                if last_status in (429, 503) else {})

        def _relay(self, resp: _Hop, name: str, rid: str, tp_out: str,
                   t_hop: float) -> int:
            """Send the replica's answer on: an event stream chunk by
            chunk as it arrives, any other body whole."""
            ctype = resp.header("Content-Type", "") or ""
            headers = {"X-Gateway-Replica": name}
            for h in ("X-Request-Id", "traceparent", "Retry-After"):
                v = resp.header(h)
                if v is not None:
                    headers[h] = v
            headers.setdefault("X-Request-Id", rid)
            if ctype.startswith("text/event-stream"):
                self._start(resp.status, {"Content-Type": ctype,
                                          "Cache-Control": "no-cache",
                                          **headers})
                self.wfile.flush()
                try:
                    for chunk in resp.chunks():
                        self.wfile.write(chunk)
                        self.wfile.flush()
                except (OSError, http.client.HTTPException, _HopTimeout):
                    # The client went away or the stream outlived the
                    # deadline: the connection closes mid-stream.
                    return resp.status
                # The stream is close-delimited: the client's end of it
                # comes after this handler returns.
                self._observe_hop(name, t_hop)
            else:
                try:
                    payload = resp.read()
                except _HopTimeout:
                    # The deadline ran out after the replica answered
                    # but before its body arrived.
                    return self._reply(504, {"error": {
                        "message": f"deadline exhausted reading replica "
                                   f"{name}", "type": "deadline"}},
                        rid, tp_out)
                except (OSError, http.client.HTTPException) as exc:
                    return self._reply(502, {"error": {
                        "message": f"replica {name} broke off its answer: "
                                   f"{exc}", "type": "unreachable"}},
                        rid, tp_out)
                headers.setdefault("traceparent", tp_out)
                # Observed before the answer leaves: a client that reads
                # /metrics right after its answer sees this call counted.
                self._observe_hop(name, t_hop)
                self._send(resp.status, payload,
                           ctype.split(";")[0] or "application/json",
                           headers)
            return resp.status

        def _observe_hop(self, name: str, t_hop: float) -> None:
            reg.observe(
                "gateway_proxy_latency_seconds",
                time.perf_counter() - t_hop, backend=name,
                help_text="Wall time of the proxied replica call, "
                          "per backend.")

    httpd = _GatewayHTTPServer((host, port), Handler)
    return Gateway(httpd, router, poller, scrape_interval_s)


# ---------------------------------------------------------------------------
# Container entrypoint (the controller's gateway Deployment runs this)
# ---------------------------------------------------------------------------

_SERVICE_ACCOUNT = "/var/run/secrets/kubernetes.io/serviceaccount"


class InClusterPods:
    """The one API call the gateway makes, as the reference's
    ``K8sClient(KubeConfig.in_cluster()).list("v1", "Pod", ...)`` makes
    it: ``GET /api/v1/namespaces/{ns}/pods?labelSelector=...`` with the
    service account's bearer token, verified against its CA."""

    def __init__(self, server: str, ssl_ctx=None,
                 headers: Optional[Dict[str, str]] = None):
        self.server = server.rstrip("/")
        self.ssl_ctx = ssl_ctx
        self.headers = dict(headers or {})

    @classmethod
    def in_cluster(cls) -> "InClusterPods":
        import ssl

        host = os.environ["KUBERNETES_SERVICE_HOST"]
        port = os.environ.get("KUBERNETES_SERVICE_PORT", "443")
        with open(f"{_SERVICE_ACCOUNT}/token") as f:
            token = f.read().strip()
        ctx = ssl.create_default_context(cafile=f"{_SERVICE_ACCOUNT}/ca.crt")
        return cls(f"https://{host}:{port}", ctx,
                   {"Authorization": f"Bearer {token}"})

    def list_pods(self, namespace: str,
                  label_selector: Dict[str, str]) -> List[dict]:
        sel = ",".join(f"{k}={v}" for k, v in label_selector.items())
        url = (f"{self.server}/api/v1/namespaces/{namespace}/pods"
               f"?labelSelector={urllib.parse.quote(sel)}")
        req = urllib.request.Request(url, headers={
            **self.headers, "Accept": "application/json"})
        with urllib.request.urlopen(req, context=self.ssl_ctx,
                                    timeout=30) as resp:
            payload = resp.read()
        return (json.loads(payload) if payload else {}).get("items", [])


def k8s_discover(list_pods: Callable[[str, Dict[str, str]], List[dict]],
                 namespace: str, server: str, port: int = 8080):
    """() -> {pod_name: url} over the Server's running replica pods —
    the same labels the fleet scraper discovers by (server=<n>, role=run),
    skipping pods already marked for deletion (a scale-in's terminating
    pods must leave the routing set immediately). ``list_pods(namespace,
    label_selector)`` is ``InClusterPods.list_pods`` in a cluster."""

    def discover():
        out = {}
        for pod in list_pods(namespace, {"server": server, "role": "run"}):
            meta = pod.get("metadata") or {}
            status = pod.get("status") or {}
            if meta.get("deletionTimestamp"):
                continue
            ip = status.get("podIP")
            if ip and status.get("phase", "") == "Running":
                out[meta.get("name")] = f"http://{ip}:{port}"
        return out

    return discover


def main() -> int:
    from runbooks_tpu_torch.utils import contract

    params = contract.load_params()
    server = os.environ.get("RBT_GATEWAY_SERVER", "")
    namespace = os.environ.get("RBT_GATEWAY_NAMESPACE", "default")
    targets_env = os.environ.get("RBT_GATEWAY_TARGETS", "")
    targets = {}
    for i, part in enumerate(p for p in targets_env.split(",") if p):
        name, _, url = part.rpartition("=")
        targets[name or f"replica-{i}"] = url
    discover = None
    if server and not targets:
        if not os.environ.get("KUBERNETES_SERVICE_HOST"):
            raise RuntimeError(
                "RBT_GATEWAY_SERVER is set without RBT_GATEWAY_TARGETS "
                "outside a cluster: the reference's kubeconfig discovery "
                "needs yaml, which the port does not use (ROADMAP.md §1); "
                "set RBT_GATEWAY_TARGETS=name=url,...")
        discover = k8s_discover(InClusterPods.in_cluster().list_pods,
                                namespace, server)
    # Gateway knobs arrive as env injected by the Server reconciler
    # (spec.gateway is not part of spec.params, so it is not in
    # params.json); params.json still supplies the server-wide
    # request_timeout_s the gateway inherits as its deadline default.
    gw = create_gateway(
        targets or None,
        policy=os.environ.get("RBT_GATEWAY_POLICY", "prefix"),
        block_chars=int(os.environ.get("RBT_GATEWAY_BLOCK_CHARS",
                                       str(DEFAULT_BLOCK_CHARS))),
        session_affinity=os.environ.get("RBT_GATEWAY_AFFINITY", "1")
        not in ("0", "false"),
        request_timeout_s=(float(params["request_timeout_s"])
                           if isinstance(params, dict)
                           and params.get("request_timeout_s") else None),
        discover=discover,
        port=int(os.environ.get("RBT_GATEWAY_PORT", GATEWAY_PORT)))

    def on_signal(signum, frame):
        threading.Thread(target=gw.shutdown, daemon=True).start()

    signal.signal(signal.SIGTERM, on_signal)
    signal.signal(signal.SIGINT, on_signal)
    print(f"gateway: serving on :{gw.port} policy={gw.router.policy} "
          f"replicas={gw.router.replica_names()}", flush=True)
    gw.serve_forever()
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
