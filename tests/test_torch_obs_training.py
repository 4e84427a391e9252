"""The port's trainer telemetry against the JAX trainer's: the same small
job gives a summary with the reference's keys (goodput and its breakdown,
the device section), the same train_* families and step-histogram
counts; the step program's FLOPs count the backward's attention (equal on
the flash and the plain attention); RBT_PROFILE_AT_STEP and the
profile_start/profile_stop window each write one capture on the CPU;
RBT_TRACE=1 writes the step spans; RBT_METRICS_PORT serves the registry
from ``main``."""

import json
import socket
import urllib.request

import pytest
import torch

from runbooks_tpu.obs import metrics as ref_metrics
from runbooks_tpu.parallel.mesh import MeshConfig
from runbooks_tpu.train import trainer as jax_trainer
from runbooks_tpu.train.optimizer import OptimizerConfig as JaxOptimizerConfig
from runbooks_tpu_torch.obs import metrics
from runbooks_tpu_torch.train import trainer
from runbooks_tpu_torch.train.optimizer import OptimizerConfig
from runbooks_tpu_torch.utils import cuda_build
from tests.test_obs import lint_exposition, read_trace_events

torch.set_num_threads(2)

STEPS = 4


def _port_job(artifacts, **kw):
    return trainer.TrainJobConfig(
        model="debug", model_overrides=kw.pop("model_overrides",
                                              {"dtype": "float32"}),
        optimizer=OptimizerConfig(learning_rate=1e-3, warmup_steps=0,
                                  total_steps=100, schedule="constant"),
        batch_size=4, seq_len=32, steps=kw.pop("steps", STEPS),
        checkpoint_every=3, log_every=1, artifacts_dir=str(artifacts), **kw)


def _step_count(reg, name):
    stats = reg.histogram_stats(name)
    return stats[0] if stats else 0


def test_summary_and_families_have_the_references(tmp_path):
    before = {n: (_step_count(metrics.REGISTRY, n),
                  _step_count(ref_metrics.REGISTRY, n))
              for n in ("train_step_seconds", "train_data_wait_seconds",
                        "train_checkpoint_seconds")}
    port = trainer.run_training(_port_job(tmp_path / "port"), device="cpu")
    ref = jax_trainer.run_training(jax_trainer.TrainJobConfig(
        model="debug", model_overrides={"dtype": "float32"},
        mesh=MeshConfig(data=2, fsdp=2, tensor=2),
        optimizer=JaxOptimizerConfig(learning_rate=1e-3, warmup_steps=0,
                                     total_steps=100, schedule="constant"),
        batch_size=4, seq_len=32, steps=STEPS, checkpoint_every=3,
        log_every=1, artifacts_dir=str(tmp_path / "ref")))
    assert set(ref) <= set(port), set(ref) - set(port)
    assert set(port["goodput_detail"]) == set(ref["goodput_detail"])
    assert set(port["device_obs"]) == set(ref["device_obs"])
    assert 0 < port["goodput"] <= 1
    assert port["goodput_detail"]["steps"] == ref["goodput_detail"]["steps"]
    assert port["device_obs"]["unexpected_compiles"] == 0
    cost = port["device_obs"]["cost"]
    assert cost["flops"] > port["device_obs"]["formula_flops_per_step"] / 2
    assert cost["bound"] in ("bandwidth", "compute")
    for entry, ref_entry in zip(port["history"][1:], ref["history"][1:]):
        assert {"goodput", "step_s", "data_wait_s"} <= set(entry)
        assert {"goodput", "step_s", "data_wait_s"} <= set(ref_entry)
    on_disk = json.load(open(tmp_path / "port" / "metrics.json"))
    assert on_disk["goodput_detail"]["steps"] == STEPS - 1
    # The step histograms count the same steps as the reference's (every
    # step after the first, whose one-off costs both leave out).
    for name, (p0, r0) in before.items():
        assert _step_count(metrics.REGISTRY, name) - p0 == \
            _step_count(ref_metrics.REGISTRY, name) - r0, name
    assert _step_count(metrics.REGISTRY, "train_step_seconds") - \
        before["train_step_seconds"][0] == STEPS - 1
    text = metrics.REGISTRY.render()
    types = lint_exposition(text)
    ref_types = lint_exposition(ref_metrics.REGISTRY.render())
    for name in ("train_step", "train_loss", "train_goodput_ratio",
                 "train_step_seconds", "train_data_wait_seconds",
                 "train_checkpoint_seconds"):
        assert types[name] == ref_types[name], name
    parsed = metrics.parse_exposition(text)
    assert parsed["train_step"].value() == STEPS


def test_step_flops_count_the_backward_attention(tmp_path):
    """On the flash attention the backward's attention is only K2 and K3:
    the step program counts the same FLOPs as on the plain attention, so
    the kernels' flop formulas are in the count."""
    flops = {}
    for impl in ("flash", "xla"):
        summary = trainer.run_training(_port_job(
            tmp_path / impl, steps=1,
            model_overrides={"dtype": "float32", "attention_impl": impl}),
            device="cpu")
        flops[impl] = summary["device_obs"]["cost"]["flops"]
    assert flops["flash"] == flops["xla"]


def test_profile_captures_and_trace_spans(tmp_path, monkeypatch):
    monkeypatch.setenv("RBT_TRACE", "1")
    monkeypatch.setenv("RBT_PROFILE_AT_STEP", "2:1")
    trainer.run_training(_port_job(tmp_path / "at"), device="cpu")
    assert sorted(p.name for p in (tmp_path / "at" / "profiles").iterdir()) \
        == ["step2"]
    assert (tmp_path / "at" / "profiles" / "step2" / "trace.json").exists()
    events = read_trace_events(tmp_path / "at" / "trace.jsonl")
    assert {"data_wait", "step", "checkpoint", "profile.start",
            "profile.stop"} <= {e["name"] for e in events}
    assert {e["args"]["step"] for e in events if e["name"] == "step"} \
        == set(range(STEPS))
    monkeypatch.delenv("RBT_PROFILE_AT_STEP")
    trainer.run_training(_port_job(tmp_path / "win", profile_start=1,
                                   profile_stop=3), device="cpu")
    assert (tmp_path / "win" / "profile" / "trace.json").exists()
    assert not (tmp_path / "win" / "profiles").exists()


def test_metrics_port_serves_train_step(tmp_path, monkeypatch):
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    servers = []
    real_serve = metrics.serve_metrics
    monkeypatch.setattr(metrics, "serve_metrics",
                        lambda p: servers.append(real_serve(p)) or
                        servers[-1])
    real_run = trainer.run_training
    monkeypatch.setattr(trainer, "run_training",
                        lambda job: real_run(job, device="cpu"))
    # main() points the kernel directory at the artifacts: restored after.
    monkeypatch.setattr(cuda_build, "_build_dir", cuda_build.BUILD_DIR)
    monkeypatch.setenv("RBT_CONTENT_DIR", str(tmp_path))
    monkeypatch.setenv("RBT_METRICS_PORT", str(port))
    (tmp_path / "params.json").write_text(json.dumps(
        {"model": "debug", "batch_size": 4, "seq_len": 32, "steps": 3,
         "log_every": 1, "checkpoint_every": 10, "maintenance_poll_s": 0,
         "model_overrides": {"dtype": "float32"}}))
    try:
        assert trainer.main() == 0
        assert [h.server_address[1] for h in servers] == [port]
        with urllib.request.urlopen(f"http://127.0.0.1:{port}/metrics",
                                    timeout=10) as r:
            body = r.read().decode()
        lint_exposition(body)
        assert metrics.parse_exposition(body)["train_step"].value() == 3
    finally:
        for h in servers:
            h.shutdown()
            h.server_close()
    monkeypatch.delenv("RBT_METRICS_PORT")
    assert trainer.main() == 0
    assert len(servers) == 1


@pytest.mark.parametrize("spec", ["x", "3:0"])
def test_malformed_profile_at_step_raises_before_the_run(tmp_path,
                                                         monkeypatch, spec):
    monkeypatch.setenv("RBT_PROFILE_AT_STEP", spec)
    with pytest.raises(ValueError, match="RBT_PROFILE_AT_STEP"):
        trainer.run_training(_port_job(tmp_path / "a"), device="cpu")
    assert not (tmp_path / "a").exists()


def test_max_bad_steps_abort_captures_an_incident(tmp_path, monkeypatch):
    """As the reference's trainer: the abort after max_bad_steps
    consecutive non-finite steps writes one train_max_bad_steps bundle
    beside the artifacts, with the run's spans in its flight ring."""
    from runbooks_tpu_torch.obs import incident

    incident.MANAGER.reset()
    monkeypatch.setenv("RBT_FAULT_INJECT", "nonfinite:2+")
    with pytest.raises(RuntimeError, match="consecutive non-finite"):
        trainer.run_training(_port_job(tmp_path, steps=10, max_bad_steps=2),
                             device="cpu")
    bundles = sorted((tmp_path / "incidents").glob("*.json"))
    assert len(bundles) == 1
    bundle = json.load(open(bundles[0]))
    assert bundle["reason"] == "train_max_bad_steps"
    assert bundle["component"] == "train"
    assert bundle["extra"] == {"step": 4, "bad_streak": 2,
                               "nonfinite_steps": 2}
    assert {"data_wait", "step"} <= {e["name"] for e in
                                     bundle["flight"]["events"]}
    incident.MANAGER.reset()
