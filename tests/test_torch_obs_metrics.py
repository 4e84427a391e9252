"""The port's metrics registry against the reference's
(``runbooks_tpu.obs.metrics``): byte-equal expositions for the same
scripted calls (escaping, histograms, mirrored counters, dropped series),
``parse_exposition`` round trips of both, the reference's exposition lint
(tests/test_obs.py) on the port's, and ``serve_metrics``."""

import time
import urllib.request

import numpy as np
import pytest

from runbooks_tpu.obs import metrics as ref_metrics
from runbooks_tpu_torch.obs import metrics
from tests.test_obs import lint_exposition


def _script(reg, seed: int) -> None:
    """One seeded sequence of registry calls: counters (inc, set_counter),
    gauges, histograms with default and custom buckets, label values that
    need escaping, help texts with newlines and backslashes, a mirrored
    histogram and a dropped series."""
    rng = np.random.default_rng(seed)
    hostile = ['plain', 'a"b', 'back\\slash', 'two\nlines', 'ünï', '']
    reg.describe("serve_ttft_seconds", "Time to first token\nsecond line")
    for i in range(60):
        kind = int(rng.integers(0, 5))
        label = hostile[int(rng.integers(0, len(hostile)))]
        value = float(rng.exponential(0.05))
        if kind == 0:
            reg.inc("serve_requests_total", float(rng.integers(1, 4)),
                    help_text="Requests \\ accepted.", route=label)
        elif kind == 1:
            reg.set_gauge("serve_queue_depth", int(rng.integers(0, 9)),
                          help_text="Queue depth.", slot=str(i % 3))
        elif kind == 2:
            reg.observe("serve_ttft_seconds", value, reason=label)
        elif kind == 3:
            reg.observe("serve_spec_accept_len", float(rng.integers(0, 9)),
                        buckets=(0.0, 1.0, 2.0, 4.0, 8.0),
                        help_text="Accepted drafts.")
        else:
            reg.set_counter("serve_decode_steps_total", i * 3,
                            help_text="Decode chunks.")
    reg.set_histogram("fleet_mirrored_seconds", (0.1, 1.0), [2, 5], 7,
                      3.25, help_text="Mirrored.", replica="r0")
    reg.set_gauge("doomed_gauge", 1, replica="gone")
    reg.drop_series(replica="gone")


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_exposition_is_byte_equal_to_the_reference(seed, monkeypatch):
    port, ref = metrics.Registry(), ref_metrics.Registry()
    _script(port, seed)
    _script(ref, seed)
    # process_uptime_seconds reads the clock: one frozen instant for both.
    now = time.time()
    port.started = ref.started = now - 12.5
    monkeypatch.setattr(time, "time", lambda: now)
    text = port.render()
    assert text.encode() == ref.render().encode()
    lint_exposition(text)
    assert port.quantile("serve_ttft_seconds", 0.9, reason="plain") == \
        pytest.approx(ref.quantile("serve_ttft_seconds", 0.9,
                                   reason="plain"), nan_ok=True)
    assert port.histogram_stats("serve_spec_accept_len") == \
        ref.histogram_stats("serve_spec_accept_len")


def _families(parsed) -> dict:
    out = {}
    for name, fam in parsed.items():
        hists = {k: (h.bounds, h.cumulative, h.count, h.sum)
                 for k, h in fam.histograms.items()}
        out[name] = (fam.type, dict(fam.samples), hists)
    return out


@pytest.mark.parametrize("seed", [3, 4])
def test_parse_exposition_round_trips_both(seed):
    port, ref = metrics.Registry(), ref_metrics.Registry()
    _script(port, seed)
    _script(ref, seed)
    text = port.render()
    parsed = metrics.parse_exposition(text)
    assert _families(parsed) == _families(ref_metrics.parse_exposition(text))
    # Back into a registry: the rebuilt exposition carries the same
    # families and values (uptime aside).
    rebuilt = metrics.Registry()
    for name, fam in parsed.items():
        for labels, value in fam.samples.items():
            if fam.type == "counter":
                rebuilt.set_counter(name, value, **dict(labels))
            elif name != "process_uptime_seconds":
                rebuilt.set_gauge(name, value, **dict(labels))
        for labels, h in fam.histograms.items():
            rebuilt.set_histogram(name, h.bounds, h.cumulative, h.count,
                                  h.sum, **dict(labels))
    again = _families(metrics.parse_exposition(rebuilt.render()))
    for name, (typ, samples, hists) in _families(parsed).items():
        if name == "process_uptime_seconds":
            continue
        assert again[name][0] == typ
        assert again[name][1] == samples
        assert again[name][2] == hists
    # The reference parses the port's exposition and vice versa.
    assert set(metrics.parse_exposition(ref.render())) == set(parsed)


def test_reference_lint_cases_hold_for_the_port():
    """tests/test_obs.py's registry cases, on the port's registry."""
    r = metrics.Registry()
    values = [0.0005, 0.003, 0.003, 0.04, 0.7, 20.0, 99.0]
    for v in values:
        r.observe("ttft_seconds", v, help_text="test hist")
    text = r.render()
    lint_exposition(text)
    assert 'ttft_seconds_bucket{le="0.001"} 1' in text
    assert 'ttft_seconds_bucket{le="30"} 6' in text
    assert 'ttft_seconds_bucket{le="+Inf"} 7' in text
    assert "ttft_seconds_count 7" in text
    assert f"ttft_seconds_sum {round(sum(values), 9)}" in text
    r = metrics.Registry()
    r.set_gauge("weird_gauge", 1, path='a"b\\c\nd')
    assert 'weird_gauge{path="a\\"b\\\\c\\nd"} 1' in r.render()
    r = metrics.Registry()
    r.inc("x_total", kind="Model")
    r.set_gauge("queue_depth", 3, kind="Model")
    r.observe("reconcile_seconds", 0.01, kind="Model")
    types = lint_exposition(r.render())
    assert types == {"x_total": "counter", "queue_depth": "gauge",
                     "reconcile_seconds": "histogram",
                     "process_uptime_seconds": "gauge"}
    r2 = metrics.Registry()
    r2.observe("big_seconds", 1e6)
    assert r2.quantile("big_seconds", 0.99) == 30.0


def test_catalog_is_the_references_workload_families():
    """Every family of the port's catalog carries the reference's name and
    type (the fleet scraper reads them unchanged)."""
    for name, typ in metrics.CATALOG.items():
        assert ref_metrics.CATALOG.get(name) == typ, name
    assert {n for n in ref_metrics.CATALOG
            if n.startswith(("serve_", "train_", "xla_", "device_"))} \
        <= set(metrics.CATALOG)


def test_serve_metrics_answers_with_the_content_type():
    reg = metrics.Registry()
    reg.inc("train_things_total", 2)
    httpd = metrics.serve_metrics(0, registry=reg)
    try:
        base = f"http://127.0.0.1:{httpd.server_address[1]}"
        with urllib.request.urlopen(base + "/metrics", timeout=10) as r:
            assert r.headers["Content-Type"] == metrics.CONTENT_TYPE
            body = r.read().decode()
        lint_exposition(body)
        assert "train_things_total 2.0" in body
        with pytest.raises(urllib.error.HTTPError) as err:
            urllib.request.urlopen(base + "/other", timeout=10)
        assert err.value.code == 404
    finally:
        httpd.shutdown()
        httpd.server_close()
