"""The port's trainer over two FSDP ranks (gloo, the CPU) against one
process.

One spawn of two ranks (tests/tp_ranks.train_jobs) runs four LoRA jobs of
the ``debug`` model in turn, and the test process runs the one-process
jobs they are held to:

- A: four steps from the seed, equal to one process's four (the sharded
  init draws the same numbers, the ranks read one global stream);
- B: a one-process checkpoint (step 2) resumed on two ranks, whose steps 3
  and 4 equal the uninterrupted run's;
- C: RBT_FAULT_INJECT=nonfinite:2 on every rank: both skip step 3;
- D: SIGTERM to rank 0 alone (RBT_FAULT_INJECT=sigterm:2 in its env):
  both ranks stop at step 2 with one emergency checkpoint and exit 42,
  and that two-rank checkpoint resumes in one process to the same steps
  3 and 4;
- E: bf16 activations: the frozen base's non-target matrices are
  gathered in bf16, and step 1's loss is one process's;
- M: a debug MoE (4 experts, top 2): each rank routes its rows as one
  process routes the global batch, and two steps' losses (with the aux)
  and gradient norms are one process's.

``train/trainer.main(backend="gloo")`` runs as a subprocess (``python
tests/tp_ranks.py train``, rank 0 spawning rank 1): SIGTERM to it stops
both ranks and every process exits 42; a rank killed mid-run makes the
run exit 1 at once (rank 0's guard or its next collective, whichever
comes first).

Tolerance: losses within 1e-5 relative (the ranks sum in another order);
under bf16 activations step 1 within 1e-6 and step 2 within 1e-3 (each
rank's LoRA gradients are bf16 sums over its own rows).
"""

import json
import os
import signal
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import pytest
import torch

from runbooks_tpu_torch.train import trainer
from runbooks_tpu_torch.train.checkpoint import CheckpointManager
from runbooks_tpu_torch.train.lora import LoraConfig
from runbooks_tpu_torch.train.optimizer import OptimizerConfig
from tests import tp_ranks

torch.set_num_threads(2)

ROOT = Path(__file__).resolve().parents[1]
TOL = 1e-5
JOB = dict(model="debug",
           model_overrides={"dtype": "float32", "num_layers": 2},
           optimizer=dict(learning_rate=1e-3, warmup_steps=0,
                          total_steps=100, schedule="constant", eps=1e-3),
           lora={"rank": 4, "alpha": 8.0}, batch_size=4, seq_len=32,
           steps=4, checkpoint_every=2, log_every=1, prefetch_depth=2)


def one_process(artifacts, **kw):
    spec = dict(JOB, artifacts_dir=str(artifacts), **kw)
    spec["optimizer"] = OptimizerConfig(**spec["optimizer"])
    spec["lora"] = LoraConfig(**spec["lora"])
    return trainer.run_training(trainer.TrainJobConfig(**spec),
                                device="cpu")


# bf16 activations over the f32 base: the frozen matrices that are no
# LoRA target go through the gathers in bf16.
BF16 = {"dtype": "bfloat16", "num_layers": 2}


# The MoE job's model: a debug mixtral (its 4 experts gathered whole).
MOE = {"dtype": "float32", "num_layers": 2, "moe_num_experts": 4,
       "moe_top_k": 2}


def losses(summary):
    return [h["loss"] for h in summary["history"]]


@pytest.fixture(scope="module")
def mains(tmp_path_factory):
    """Two runs of ``main`` under gloo, started at once (the tests below
    drive each): {"sigterm": (process, content), "kill": ...}."""
    runs = {}
    for name in ("sigterm", "kill"):
        content = tmp_path_factory.mktemp(f"main_{name}")
        runs[name] = (start_main(content, steps=1000), content)
    yield runs
    for proc, _ in runs.values():
        proc.kill()
        proc.wait(30)


@pytest.fixture(scope="module")
def two_ranks(tmp_path_factory, mains):
    # (``mains`` first: those runs train while the ranks below do.)
    tmp = tmp_path_factory.mktemp("fsdp_trainer")
    ref = one_process(tmp / "R")
    one_process(tmp / "Y", steps=2)
    jobs = [{"job": dict(JOB, artifacts_dir=str(tmp / "A"))},
            {"job": dict(JOB, artifacts_dir=str(tmp / "Y"))},
            {"job": dict(JOB, artifacts_dir=str(tmp / "C")),
             "env": {"RBT_FAULT_INJECT": "nonfinite:2"}},
            {"job": dict(JOB, artifacts_dir=str(tmp / "D")),
             "rank0_env": {"RBT_FAULT_INJECT": "sigterm:2"}},
            {"job": dict(JOB, artifacts_dir=str(tmp / "E"), steps=2,
                         model_overrides=BF16)},
            {"job": dict(JOB, artifacts_dir=str(tmp / "M"), steps=2,
                         model_overrides=MOE)}]
    ranks = tp_ranks.run_ranks(tp_ranks.train_jobs, 2, tmp, jobs,
                               mesh={"fsdp": 2}, timeout_s=240)
    intact_d = CheckpointManager(str(tmp / "D")).intact_steps()
    resumed = one_process(tmp / "D")
    bf16 = one_process(tmp / "F", steps=2, model_overrides=BF16)
    moe = one_process(tmp / "N", steps=2, model_overrides=MOE)
    return {"tmp": tmp, "ref": ref, "ranks": ranks, "bf16": bf16,
            "moe": moe, "resumed_in_one": resumed, "intact_d": intact_d}


def test_two_ranks_train_as_one_process(two_ranks):
    want = losses(two_ranks["ref"])
    for rank, runs in enumerate(two_ranks["ranks"]):
        a = runs[0]["summary"]
        np.testing.assert_allclose(losses(a), want, rtol=TOL)
        assert a["mesh"]["rank"] == rank and a["mesh"]["fsdp"] == 2
        assert a["batches_consumed"] == 4 and runs[0]["exit"] == 0
    # Rank 0 alone writes the run's files.
    tmp = two_ranks["tmp"]
    assert (tmp / "A" / "metrics.json").exists()
    assert CheckpointManager(str(tmp / "A")).intact_steps() == [2, 4]
    on_disk = json.loads((tmp / "A" / "metrics.json").read_text())
    np.testing.assert_allclose(losses(on_disk), want, rtol=TOL)
    # The first step's FLOPs count the global batch: one process's count,
    # plus the LoRA merge that each rank makes of its gathered factors
    # (one process makes it once): 0.9% at this size.
    one = two_ranks["ref"]["device_obs"]["cost"]["flops"]
    assert one < on_disk["device_obs"]["cost"]["flops"] < 1.02 * one


def test_one_process_checkpoint_resumes_on_two_ranks(two_ranks):
    want = losses(two_ranks["ref"])[2:]
    for runs in two_ranks["ranks"]:
        b = runs[1]["summary"]
        assert b["restored_step"] == 2
        np.testing.assert_allclose(losses(b), want, rtol=TOL)


def test_two_rank_checkpoint_resumes_in_one_process(two_ranks):
    resumed = two_ranks["resumed_in_one"]
    assert two_ranks["intact_d"] == [2]
    assert resumed["restored_step"] == 2
    np.testing.assert_allclose(losses(resumed), losses(two_ranks["ref"])[2:],
                               rtol=TOL)


def test_sigterm_to_rank_zero_stops_every_rank_at_one_step(two_ranks):
    want = losses(two_ranks["ref"])[:2]
    for runs in two_ranks["ranks"]:
        d = runs[3]["summary"]
        assert d["exit_reason"] == "sigterm" and runs[3]["exit"] == 42
        np.testing.assert_allclose(losses(d), want, rtol=TOL)
        # One broadcast of rank 0's decision per step boundary reached.
        assert d["mesh"]["collectives"]["broadcast"] == 3


def test_nonfinite_step_is_skipped_on_every_rank(two_ranks):
    want = losses(two_ranks["ref"])
    for runs in two_ranks["ranks"]:
        c = runs[2]["summary"]
        assert c["nonfinite_steps"] == 1 and runs[2]["exit"] == 0
        got = losses(c)
        assert np.isnan(got[2])
        np.testing.assert_allclose(got[:2], want[:2], rtol=TOL)
    # Both ranks kept the same params through the skipped step.
    assert losses(two_ranks["ranks"][0][2]["summary"])[3] == \
        losses(two_ranks["ranks"][1][2]["summary"])[3]


def test_bf16_gathers_of_the_frozen_base_change_no_value(two_ranks):
    """The first step reads the same weights as one process (the frozen
    non-target matrices cast before their gather, as the forward casts
    them); the second follows bf16 gradients summed over two ranks."""
    want = losses(two_ranks["bf16"])
    for runs in two_ranks["ranks"]:
        got = losses(runs[4]["summary"])
        np.testing.assert_allclose(got[0], want[0], rtol=1e-6)
        np.testing.assert_allclose(got[1], want[1], rtol=1e-3)
        # Gathers: the embedding once and 7 of each layer's matrices twice
        # (the forward and the remat's recompute) per microbatch; the 4
        # attention targets' A factors and wo's B come back reduce-
        # scattered, nothing of the frozen base.
        counts = runs[4]["summary"]["mesh"]["collectives"]
        assert counts["reduce_scatter"] == 4 * 2 * 2


def test_two_ranks_train_an_moe_as_one_process(two_ranks):
    want = two_ranks["moe"]["history"]
    for runs in two_ranks["ranks"]:
        got = runs[5]["summary"]
        for h, w in zip(got["history"], want, strict=True):
            np.testing.assert_allclose(h["loss"], w["loss"], rtol=TOL)
            np.testing.assert_allclose(h["grad_norm"], w["grad_norm"],
                                       rtol=TOL)
        # Each layer's routing gathers the ranks' counts in the forward
        # and in remat's recompute, each step.
        counts = got["mesh"]["collectives"]
        assert counts["routing_all_gather"] == 2 * 2 * 2


def start_main(content: Path, steps: int) -> subprocess.Popen:
    (content / "params.json").write_text(json.dumps(dict(
        JOB, steps=steps, checkpoint_every=1000, prefetch_depth=0,
        mesh_fsdp=2, maintenance_poll_s=0, **JOB["optimizer"])))
    env = dict(os.environ, RBT_CONTENT_DIR=str(content),
               OMP_NUM_THREADS="1")
    env.pop("RBT_FAULT_INJECT", None)
    log = open(content / "main.log", "w")
    return subprocess.Popen([sys.executable, "tests/tp_ranks.py", "train"],
                            cwd=ROOT, env=env, stdout=log,
                            stderr=subprocess.STDOUT)


def wait_for(path: Path, pred, timeout: float = 90.0):
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        for line in path.read_text().splitlines():
            if line.startswith("{"):
                obj = json.loads(line)
                if pred(obj):
                    return obj
        time.sleep(0.2)
    raise TimeoutError(f"{path}:\n{path.read_text()[-3000:]}")


def test_main_over_gloo_stops_both_ranks_on_sigterm(mains):
    proc, content = mains["sigterm"]
    log = content / "main.log"
    ranks = wait_for(log, lambda o: "pids" in o)
    assert ranks["ranks"] == 2 and ranks["backend"] == "gloo"
    wait_for(log, lambda o: o.get("step", 0) >= 2)
    proc.send_signal(signal.SIGTERM)
    assert proc.wait(120) == 42
    done = wait_for(log, lambda o: o.get("done"))
    assert done["exit_reason"] == "sigterm"
    assert done["rank_exit_codes"] == [42, 42]
    step = done["batches_consumed"]
    # One emergency checkpoint, at the step both ranks stopped at.
    assert CheckpointManager(str(content / "artifacts")).intact_steps() \
        == [step]


def test_a_killed_rank_fails_the_run(mains):
    proc, content = mains["kill"]
    log = content / "main.log"
    pids = wait_for(log, lambda o: "pids" in o)["pids"]
    wait_for(log, lambda o: o.get("step", 0) >= 2)
    t0 = time.monotonic()
    os.kill(pids[1], signal.SIGKILL)
    assert proc.wait(60) == 1
    assert time.monotonic() - t0 < 60
    # Rank 0 ends either way: its guard sees the dead rank, or its next
    # collective fails on the closed connection; the run never finishes.
    assert '"done"' not in log.read_text()
