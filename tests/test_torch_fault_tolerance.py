"""The port's trainer under injected faults, as tests/test_fault_tolerance.py
holds the reference's: RBT_FAULT_INJECT's four modes (kill, sigterm,
nonfinite, nonfinite from a step on), the GCE maintenance poller against a
local metadata fake, and the malformed hook value, whose message is the
reference's.

On the CPU, with the ``debug`` config at float32: a run killed and resumed
ends on parameters bit-equal to an uninterrupted run's, and logs the same
losses on the steps it replays; a poisoned step leaves the parameters
bit-unchanged.
"""

import http.server
import json
import os
import signal
import threading

import numpy as np
import pytest
import torch

from runbooks_tpu.train import trainer as jax_trainer

from runbooks_tpu_torch.train import trainer
from runbooks_tpu_torch.train.checkpoint import CheckpointManager
from runbooks_tpu_torch.train.optimizer import OptimizerConfig
from runbooks_tpu_torch.utils.contract import EXIT_PREEMPTED
from runbooks_tpu_torch.utils.tree import tree_leaves

torch.set_num_threads(2)


def job(artifacts, steps=8, checkpoint_every=3, **kw):
    return trainer.TrainJobConfig(
        model="debug", model_overrides={"dtype": "float32"},
        optimizer=OptimizerConfig(learning_rate=1e-3, warmup_steps=0,
                                  total_steps=100, schedule="constant"),
        batch_size=4, seq_len=32, steps=steps,
        checkpoint_every=checkpoint_every, log_every=1,
        artifacts_dir=str(artifacts), **kw)


def run(j):
    return trainer.run_training(j, device="cpu")


def losses(summary):
    return {e["step"]: e["loss"] for e in summary["history"]}


def params_at(artifacts, step):
    state, _, _ = CheckpointManager(str(artifacts)).restore_with_cursor(
        step)
    return list(tree_leaves(state["params"]))


def assert_bit_equal(a, b):
    assert len(a) == len(b)
    assert all(torch.equal(x, y) for x, y in zip(a, b))


def test_kill_and_resume_is_bit_equal(tmp_path, monkeypatch):
    base = run(job(tmp_path / "base"))
    monkeypatch.setenv("RBT_FAULT_INJECT", "kill:5")
    with pytest.raises(trainer.SimulatedFault):
        run(job(tmp_path / "faulted"))
    monkeypatch.delenv("RBT_FAULT_INJECT")
    resumed = run(job(tmp_path / "faulted"))
    # The last periodic checkpoint before the kill was step 3.
    assert resumed["restored_step"] == 3
    assert sorted(losses(resumed)) == [4, 5, 6, 7, 8]
    assert all(losses(resumed)[s] == losses(base)[s] for s in range(4, 9))
    assert resumed["batches_consumed"] == base["batches_consumed"] == 8
    assert_bit_equal(params_at(tmp_path / "faulted", 8),
                     params_at(tmp_path / "base", 8))


def test_kill_and_resume_with_accum_prefetch_and_jsonl(tmp_path,
                                                       monkeypatch):
    data = tmp_path / "data"
    os.makedirs(data)
    rng = np.random.default_rng(0)
    with open(data / "docs.jsonl", "w") as f:
        for i in range(40):
            words = " ".join(f"w{i}x{j}" for j in range(int(rng.integers(
                4, 40))))
            f.write(json.dumps({"text": words}) + "\n")
    kw = dict(data_path=str(data), accumulate_steps=2, prefetch_depth=2)
    base = run(job(tmp_path / "base", **kw))
    monkeypatch.setenv("RBT_FAULT_INJECT", "kill:4")
    with pytest.raises(trainer.SimulatedFault):
        run(job(tmp_path / "faulted", **kw))
    monkeypatch.delenv("RBT_FAULT_INJECT")
    resumed = run(job(tmp_path / "faulted", **kw))
    assert sorted(losses(resumed)) == [4, 5, 6, 7, 8]
    assert all(losses(resumed)[s] == losses(base)[s] for s in range(4, 9))
    assert_bit_equal(params_at(tmp_path / "faulted", 8),
                     params_at(tmp_path / "base", 8))


def test_sigterm_emergency_checkpoint_and_exit_code(tmp_path, monkeypatch):
    monkeypatch.setenv("RBT_FAULT_INJECT", "sigterm:5")
    summary = run(job(tmp_path, steps=10, checkpoint_every=100))
    assert summary["exit_reason"] == "sigterm"
    assert trainer.exit_code_for(summary) == EXIT_PREEMPTED
    assert signal.getsignal(signal.SIGTERM) in (signal.SIG_DFL,
                                                signal.default_int_handler)
    ckpt = CheckpointManager(str(tmp_path))
    assert ckpt.latest_intact_step() == 5
    assert ckpt.read_cursor(5) == {"batches_consumed": 5}
    monkeypatch.delenv("RBT_FAULT_INJECT")
    base = run(job(tmp_path / "base", steps=10, checkpoint_every=100))
    resumed = run(job(tmp_path, steps=10, checkpoint_every=100))
    assert sorted(losses(resumed)) == [6, 7, 8, 9, 10]
    assert all(losses(resumed)[s] == losses(base)[s] for s in range(6, 11))
    assert trainer.exit_code_for(resumed) == 0


def test_maintenance_event_poller_stops_training(tmp_path, monkeypatch):
    """A pending maintenance event, served by a local metadata fake, stops
    the run as SIGTERM does: an emergency checkpoint and exit code 42."""

    class Fake(http.server.BaseHTTPRequestHandler):
        def do_GET(self):
            body = (b"TERMINATE_ON_HOST_MAINTENANCE"
                    if "maintenance-event" in self.path else b"")
            self.send_response(200)
            self.send_header("Metadata-Flavor", "Google")
            self.end_headers()
            self.wfile.write(body)

        def log_message(self, *a):
            pass

    srv = http.server.HTTPServer(("127.0.0.1", 0), Fake)
    threading.Thread(target=srv.serve_forever, daemon=True).start()
    try:
        monkeypatch.setenv("GCE_METADATA_HOST",
                           f"127.0.0.1:{srv.server_address[1]}")
        summary = run(job(tmp_path, steps=500, checkpoint_every=1000,
                          maintenance_poll_s=0.2))
        assert summary["exit_reason"] == "maintenance"
        assert trainer.exit_code_for(summary) == EXIT_PREEMPTED
        step = CheckpointManager(str(tmp_path)).latest_intact_step()
        assert step is not None and step < 500
        assert summary["batches_consumed"] == step
    finally:
        srv.shutdown()
        srv.server_close()


def test_single_nonfinite_step_leaves_params_and_training_continues(
        tmp_path, monkeypatch):
    # Index 2 is step 3: its checkpoint holds step 2's parameters.
    monkeypatch.setenv("RBT_FAULT_INJECT", "nonfinite:2")
    summary = run(job(tmp_path, steps=4, checkpoint_every=1))
    assert summary["nonfinite_steps"] == 1
    assert summary["exit_reason"] is None
    assert np.isfinite(summary["final_loss"])
    assert_bit_equal(params_at(tmp_path, 3), params_at(tmp_path, 2))
    assert not all(torch.equal(a, b) for a, b in zip(
        params_at(tmp_path, 4), params_at(tmp_path, 3)))


def test_consecutive_nonfinite_steps_abort(tmp_path, monkeypatch):
    monkeypatch.setenv("RBT_FAULT_INJECT", "nonfinite:2+")
    with pytest.raises(RuntimeError, match="consecutive non-finite"):
        run(job(tmp_path, steps=10, max_bad_steps=3))


@pytest.mark.parametrize("spec", ["boom:3", "kill", "kill:", "nonfinite"])
def test_malformed_fault_inject_is_refused_as_the_reference(
        tmp_path, monkeypatch, spec):
    monkeypatch.setenv("RBT_FAULT_INJECT", spec)
    with pytest.raises(ValueError) as ref:
        jax_trainer._parse_fault_inject()
    with pytest.raises(ValueError) as mine:
        run(job(tmp_path / "art"))
    assert str(mine.value) == str(ref.value)
    # Raised before any state needing cleanup: nothing was written.
    assert not (tmp_path / "art").exists()


def test_parse_fault_inject_matches_reference(monkeypatch):
    for spec in ("kill:3", "sigterm:0", "nonfinite:2", "nonfinite:4+"):
        monkeypatch.setenv("RBT_FAULT_INJECT", spec)
        assert trainer._parse_fault_inject() == \
            jax_trainer._parse_fault_inject()
    monkeypatch.delenv("RBT_FAULT_INJECT")
    assert trainer._parse_fault_inject() is None


@pytest.mark.parametrize("params,name", [
    ({"profile_start": 2, "profile_stop": 4}, "profile_stop"),
    ({"collective_matmul": "ring"}, "collective_matmul"),
    ({"collectiveMatmul": "auto"}, "collectiveMatmul"),
])
def test_from_params_refuses_what_it_cannot_honour(params, name):
    """The collective matmul is refused by name. The profiler window, which
    the port refused until it had a profiler capture, is taken as the
    reference takes it."""
    if name == "profile_stop":
        got = trainer.TrainJobConfig.from_params(params)
        ref = jax_trainer.TrainJobConfig.from_params(params)
        assert (got.profile_start, got.profile_stop) == \
            (ref.profile_start, ref.profile_stop) == (2, 4)
        return
    with pytest.raises(NotImplementedError, match=name):
        trainer.TrainJobConfig.from_params(params)


def test_from_params_takes_what_it_can():
    job_cfg = trainer.TrainJobConfig.from_params({
        "profile_start": 3, "profile_stop": 3, "collective_matmul": "off",
        "mesh_fsdp": 8, "maintenance_poll_s": "2.5"})
    assert job_cfg.maintenance_poll_s == 2.5
    assert jax_trainer.TrainJobConfig.from_params(
        {"maintenance_poll_s": "2.5"}).maintenance_poll_s == 2.5


def test_profile_at_step_is_refused(tmp_path, monkeypatch):
    """RBT_PROFILE_AT_STEP, refused until the port had a profiler capture,
    now captures steps 3 and 4 into {artifacts}/profiles/step3; a
    malformed value still raises before the run makes anything."""
    monkeypatch.setenv("RBT_PROFILE_AT_STEP", "3:2")
    run(job(tmp_path / "art", steps=6))
    assert (tmp_path / "art" / "profiles" / "step3" / "trace.json").exists()
    monkeypatch.setenv("RBT_PROFILE_AT_STEP", "3:0")
    with pytest.raises(ValueError, match="RBT_PROFILE_AT_STEP"):
        run(job(tmp_path / "bad"))
    assert not (tmp_path / "bad").exists()


def test_main_polls_on_gce_and_points_kernels_at_the_artifacts(
        tmp_path, monkeypatch):
    """main() turns the poller on (every 5 s) when the 0.5 s probe finds
    GCE, keeps an explicit maintenance_poll_s, and builds kernels into
    <artifacts>/kernel_cache."""
    from runbooks_tpu_torch.cloud import metadata
    from runbooks_tpu_torch.utils import cuda_build

    seen = []
    monkeypatch.setattr(trainer, "run_training",
                        lambda j: seen.append(j) or {"exit_reason": None})
    monkeypatch.setattr(cuda_build, "_build_dir", cuda_build.BUILD_DIR)
    monkeypatch.setenv("RBT_CONTENT_DIR", str(tmp_path))
    monkeypatch.delenv("RBT_KERNEL_CACHE", raising=False)
    probes = []
    monkeypatch.setattr(metadata, "on_gce",
                        lambda timeout, attempts: probes.append(
                            (timeout, attempts)) or True)
    assert trainer.main() == 0
    assert seen[-1].maintenance_poll_s == 5.0 and probes == [(0.5, 1)]
    assert cuda_build._build_dir == tmp_path / "artifacts" / "kernel_cache"
    (tmp_path / "params.json").write_text(json.dumps(
        {"maintenance_poll_s": 0}))
    assert trainer.main() == 0
    assert seen[-1].maintenance_poll_s == 0.0 and len(probes) == 1
