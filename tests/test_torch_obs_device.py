"""Device accounting of the port (runbooks_tpu_torch/obs/device.py): the
first-dispatch counting mode (a matmul program's bytes exactly, a decode
program's FLOPs against the hand count, the flash and plain attention
counting the same FLOPs forward and backward), the memory census over
named groups (an aliased tensor once), the kernel-build sentinel (steady
marks, expected builds, nvcc runs reported by utils/cuda_build), the
program tracker's census and gauges, the roofline classification, and
the profiler's guard and parser against the reference's."""

import dataclasses

import numpy as np
import pytest
import torch

from runbooks_tpu.obs import profile as ref_profile
from runbooks_tpu_torch.models.config import get_config
from runbooks_tpu_torch.models.transformer import KVCache, forward, init_params
from runbooks_tpu_torch.obs import device, flight, metrics, profile
from runbooks_tpu_torch.ops.quantization import QuantizedArray
from runbooks_tpu_torch.serve.engine import InferenceEngine
from runbooks_tpu_torch.utils import cuda_build, hw
from tests.test_obs import lint_exposition
from tests.test_torch_kernel_cache import _fake_nvcc

torch.set_num_threads(2)


@pytest.fixture(autouse=True)
def clean_sentinel():
    device.SENTINEL.clear_steady()
    yield
    device.SENTINEL.clear_steady()


@pytest.mark.parametrize("m,k,n,dtype", [(8, 16, 4, torch.float32),
                                         (33, 64, 17, torch.bfloat16)])
def test_matmul_program_bytes_and_flops_exact(m, k, n, dtype):
    rng = np.random.default_rng(0)
    a = torch.tensor(rng.standard_normal((m, k)), dtype=dtype)
    b = torch.tensor(rng.standard_normal((k, n)), dtype=dtype)
    name = f"mm{m}x{k}x{n}"
    device.PROGRAMS.register("test", name, torch.matmul)
    out = device.program_cost("test", name, "s", torch.matmul, a, b)
    torch.testing.assert_close(out, a @ b)
    cost = next(e["costs"]["s"] for e in device.PROGRAMS.census("test")
                if e["name"] == name)
    assert cost["hbm_bytes"] == (m * k + k * n + m * n) * a.element_size()
    assert cost["flops"] == 2 * m * k * n
    assert cost["ops"] == 1
    # A second call at the same signature runs plain and keeps the cost.
    device.program_cost("test", name, "s", torch.matmul, a * 2, b)
    assert device.PROGRAMS.has_cost("test", name, "s")


def _debug(**overrides):
    cfg = get_config("debug", dtype="float32", **overrides)
    return cfg, init_params(cfg, torch.Generator().manual_seed(0),
                            torch.device("cpu"))


def _linear_params(cfg) -> int:
    h, q, kv = cfg.hidden_size, cfg.q_dim, cfg.num_kv_heads * cfg.head_dim
    return h * q + 2 * h * kv + q * h + 3 * h * cfg.intermediate_size


def test_decode_program_flops_equal_the_hand_count(monkeypatch):
    monkeypatch.delenv("RBT_DEVICE_OBS", raising=False)
    cfg, params = _debug(max_seq_len=64)
    engine = InferenceEngine(cfg, params, max_slots=3, decode_chunk=2)
    engine.warmup()
    census = {e["name"]: e for e in device.PROGRAMS.census("serve")}
    assert engine.view_buckets == [64]
    cost = census["decode_v64"]["costs"]["v64"]
    B, view, L = 3, 64, cfg.num_layers
    per_step = (2 * B * (L * _linear_params(cfg)
                         + cfg.hidden_size * cfg.vocab_size)
                + L * 4 * B * cfg.num_heads * view * cfg.head_dim)
    assert cost["flops"] == 2 * per_step
    assert cost["bound"] in ("bandwidth", "compute")
    prefill = census["prefill"]["costs"]
    assert set(prefill) == {f"b{b}r{r}" for b in engine.prefill_buckets
                            for r in (1, 3)}
    # The one-row prefill at bucket 16: the linears and head at 16 rows,
    # K1's plain version over the whole cache (flop formula of SDPA).
    assert engine.warmup_census["prefill_programs"] == 2 * len(
        engine.prefill_buckets)
    assert "serve" in device.SENTINEL.steady_components()
    engine.release_steady()
    engine.release_steady()
    assert "serve" not in device.SENTINEL.steady_components()
    # RBT_DEVICE_OBS=0 skips the counting: a fresh engine records none.
    monkeypatch.setenv("RBT_DEVICE_OBS", "0")
    e2 = InferenceEngine(cfg, params, max_slots=1)
    e2.warmup()
    assert all(not e["costs"] for e in device.PROGRAMS.census("serve")
               if e["name"].startswith("decode"))
    e2.release_steady()


@pytest.mark.parametrize("with_backward", [False, True])
def test_flash_and_plain_attention_count_the_same_flops(with_backward):
    cfg, params = _debug()
    rng = np.random.default_rng(1)
    tokens = torch.tensor(rng.integers(0, cfg.vocab_size, (2, 64)))
    counted = {}
    for impl in ("flash", "xla"):
        c = dataclasses.replace(cfg, attention_impl=impl)
        p = {k: v for k, v in params.items()}
        leaves = [params["embed"]]
        if with_backward:
            leaves = [t.detach().requires_grad_(True)
                      for t in (params["embed"],)]
            p["embed"] = leaves[0]
        mode = device.CostMode()
        with mode:
            logits, _ = forward(c, p, tokens)
            if with_backward:
                torch.autograd.grad(logits.float().square().mean(), leaves)
        counted[impl] = mode.flops
    assert counted["flash"] == counted["xla"]
    b, s = tokens.shape
    attn = cfg.num_layers * 4 * b * cfg.num_heads * s * s * cfg.head_dim
    if with_backward:
        # The backward's attention counts twice the forward's (K2 + K3).
        fwd_only = device.CostMode()
        with fwd_only:
            forward(dataclasses.replace(cfg, attention_impl="flash"),
                    params, tokens)
        assert counted["flash"] >= fwd_only.flops + 2 * attn
    else:
        assert counted["flash"] == 2 * b * s * (
            cfg.num_layers * _linear_params(cfg)
            + cfg.hidden_size * cfg.vocab_size) + attn


def test_memory_groups_count_an_aliased_tensor_once():
    base = torch.zeros(16, 8)
    view = base[2:5]
    qa = QuantizedArray(values=torch.zeros(4, 8, dtype=torch.int8),
                        scales=torch.zeros(1, 8))
    cache = KVCache(k=torch.zeros(2, 3, 5, 1, 4), v=torch.zeros(2, 3, 5, 1, 4))
    groups = {"weights": {"a": base, "b": view, "c": [base, {"d": view}],
                          "q": qa},
              "kv_cache": cache,
              "again": [base, view]}
    census = device.tensor_census(groups)["by_category"]
    assert census["weights"] == 16 * 8 * 4 + 4 * 8 + 8 * 4
    assert census["kv_cache"] == 2 * (2 * 3 * 5 * 4) * 4
    assert census["again"] == 0       # charged to its first group
    assert "other" not in census      # no allocator total on the CPU
    snap = device.memory_snapshot(groups)
    assert snap["devices"] == device.device_memory_stats() == []
    assert device.set_memory_gauges(metrics.Registry()) == []


def test_engine_memory_groups_are_its_weights_and_cache():
    cfg, params = _debug(max_seq_len=32)
    engine = InferenceEngine(cfg, params, max_slots=2)
    census = device.tensor_census(engine.memory_groups())["by_category"]
    assert census["weights"] == sum(t.numel() * t.element_size()
                                    for t in device.tensor_leaves(params))
    assert census["kv_cache"] == engine.kv_occupancy()["kv_pool_bytes"]
    assert census["prefix_cache"] == 0


def test_sentinel_flags_builds_after_steady_outside_expected(tmp_path,
                                                            monkeypatch):
    s = device.CompileSentinel()
    reg = metrics.REGISTRY
    before = reg.counter_value("xla_unexpected_compiles_total")
    s.record_build(1.5, "flash_fwd")         # nothing steady: expected
    assert (s.total, s.unexpected) == (1, 0)
    s.mark_steady("serve")
    with s.expected():
        s.record_build(2.0, "flash_bwd")
    assert (s.total, s.unexpected) == (2, 0)
    flight.RING.clear()
    s.record_build(3.0, "flash_fwd")
    assert (s.total, s.unexpected) == (3, 1)
    assert s.compile_seconds == pytest.approx(6.5)
    assert s.recent_unexpected()[0]["source"] == "flash_fwd"
    assert reg.counter_value("xla_unexpected_compiles_total") == before + 1
    assert [e["name"] for e in flight.RING.snapshot()] == \
        ["unexpected_compile"]
    # Claims are refcounted per component.
    s.mark_steady("serve")
    s.clear_steady("serve")
    assert s.steady_components() == ["serve"]
    s.clear_steady("serve")
    assert s.steady_components() == []
    s.record_build(1.0)
    assert s.unexpected == 1


def test_cuda_build_reports_each_nvcc_run(tmp_path, monkeypatch):
    monkeypatch.setattr(cuda_build, "_build_dir", tmp_path / "k")
    monkeypatch.setattr(cuda_build, "stats", {"nvcc_runs": 0, "nvcc_s": 0.0})
    monkeypatch.setattr(cuda_build, "_nvcc", lambda: _fake_nvcc(tmp_path))
    s = device.SENTINEL
    total, unexpected = s.total, s.unexpected
    s.mark_steady("serve")
    with s.expected():
        cuda_build.build(["flash_fwd"])
    assert (s.total, s.unexpected) == (total + 1, unexpected)
    cuda_build.build(["flash_bwd"])           # a build under traffic
    assert (s.total, s.unexpected) == (total + 2, unexpected + 1)
    cuda_build.build(["flash_fwd", "flash_bwd"])   # warm: no nvcc
    assert s.total == total + 2


def test_program_tracker_census_gauges_and_dead_programs():
    tracker = device.ProgramTracker()
    reg = metrics.Registry()

    def fn():
        return None

    tracker.register("serve", "decode_v64", fn)
    cost = {"flops": 4e6, "hbm_bytes": 2e6}
    cost.update(device.classify_roofline(4e6, 2e6))
    tracker.record_cost("serve", "decode_v64", "v64", cost)
    tracker.set_gauges(reg, component="serve")
    text = reg.render()
    types = lint_exposition(text)
    assert types["xla_program_flops"] == "gauge"
    assert 'xla_program_bandwidth_bound{component="serve",' \
           'program="decode_v64"} 1' in text
    assert 'xla_programs{component="serve",program="decode_v64"} 1' in text
    tracker.register("serve", "decode_v64", fn)     # re-registration
    assert tracker.census()[0]["costs"] == {}
    del fn
    assert tracker.census() == []
    tracker.set_gauges(reg, component="serve")
    assert "decode_v64" not in reg.render()


def test_roofline_against_the_h100_ridge():
    peak, bw = hw.device_peaks("cuda") if torch.cuda.is_available() \
        else (hw.H100_PEAK_BF16_FLOPS, hw.H100_HBM_BW)
    assert (peak, bw) == (989e12, 3.35e12)
    assert hw.device_peaks("cpu") == (hw.NOMINAL_PEAK_FLOPS,
                                      hw.NOMINAL_HBM_BPS) == (1e12, 100e9)
    ridge = peak / bw
    # A bf16 GEMV (decode-like) sits left of the ridge, a square GEMM right.
    gemv = device.classify_roofline(2 * 4096 * 4096, 2 * 4096 * 4096,
                                    peak, bw)
    gemm = device.classify_roofline(2 * 4096 ** 3, 3 * 2 * 4096 ** 2,
                                    peak, bw)
    assert gemv["bound"] == "bandwidth" and gemm["bound"] == "compute"
    assert gemv["ridge"] == round(ridge, 3)
    assert gemm["min_seconds"] == pytest.approx(2 * 4096 ** 3 / peak)


def test_profiler_guard_capture_and_parser(tmp_path):
    prof = profile.Profiler()
    d = str(tmp_path / "cap")
    prof.start(d)
    with pytest.raises(profile.ProfilerBusy):
        prof.start(str(tmp_path / "other"))
    torch.randn(32, 32) @ torch.randn(32, 32)
    assert prof.stop() == d
    assert prof.stop() is None
    assert (tmp_path / "cap" / profile.TRACE_FILE).exists()
    assert (tmp_path / "cap" / "memory.json").exists()
    assert profile.device_kernels(str(tmp_path / "cap" / "trace.json")) \
        == []
    for spec in ("", "3", "2:4", "0:1", "x", "1:0", "-1", "2:y"):
        try:
            want = ref_profile.parse_profile_at_step(spec)
        except ValueError:
            with pytest.raises(ValueError):
                profile.parse_profile_at_step(spec)
            continue
        assert profile.parse_profile_at_step(spec) == want
    assert profile.capture_dir(str(tmp_path), "serve").startswith(
        str(tmp_path / "profiles") + "/")
