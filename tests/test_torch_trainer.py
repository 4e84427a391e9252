"""The port's data pipeline, job config and trainer.

The host-side data functions and ``TrainJobConfig.from_params`` are held
to the JAX package's: the same files, seeds and params give identical
arrays and fields. ``run_training`` runs on the CPU at the ``debug``
config: a run stopped by SIGTERM and resumed ends bitwise equal to an
uninterrupted one, consecutive non-finite steps abort it, and the
contract's artifacts (metrics.json, lora.json, checkpoints with their
data cursor) are written.
"""

import dataclasses
import json
import os
import signal

import numpy as np
import pytest
import torch

from runbooks_tpu.train import data as jax_data
from runbooks_tpu.train.trainer import TrainJobConfig as JaxJobConfig

from runbooks_tpu_torch.train import data, trainer
from runbooks_tpu_torch.train.checkpoint import CheckpointManager
from runbooks_tpu_torch.train.lora import LoraConfig
from runbooks_tpu_torch.train.optimizer import OptimizerConfig
from runbooks_tpu_torch.utils.contract import EXIT_PREEMPTED
from runbooks_tpu_torch.utils.tree import tree_leaves

torch.set_num_threads(2)


def _write_docs(path, n=60, seed=0):
    rng = np.random.default_rng(seed)
    with open(path, "w") as f:
        for i in range(n):
            text = "".join(rng.choice(list("abcdefgh \n"),
                                      int(rng.integers(5, 200))))
            f.write(json.dumps({"text": text, "prompt": f"q{i}",
                                "completion": text[:9]}) + "\n")


def _same(a, b):
    assert a.keys() == b.keys()
    for k in a:
        assert a[k].dtype == b[k].dtype, k
        np.testing.assert_array_equal(a[k], b[k])


# ---------------------------------------------------------------------------
# Data and config: identical to the reference
# ---------------------------------------------------------------------------

def test_pack_documents_and_batches_match_reference(tmp_path):
    _write_docs(tmp_path / "a.jsonl")
    (tmp_path / "b.txt").write_text("a whole text document")
    path = str(tmp_path)
    for template in (None, "Q: {prompt}\nA: {completion}"):
        mine = data.dataset(path, 48, 3, epochs=2, prompt_template=template)
        ref = jax_data.dataset(path, 48, 3, epochs=2,
                               prompt_template=template)
        n = 0
        for a, b in zip(mine, ref):
            _same(a, b)
            n += 1
        assert n > 4
    rng = np.random.default_rng(1)
    docs = [rng.integers(1, 300, int(rng.integers(1, 90))).tolist()
            for _ in range(30)]
    for a, b in zip(data.pack_documents(docs, 40),
                    jax_data.pack_documents(docs, 40)):
        _same(a, b)
    a = list(data.batch_rows(data.pack_documents(docs, 40), 4,
                             drop_remainder=False))
    b = list(jax_data.batch_rows(jax_data.pack_documents(docs, 40), 4,
                                 drop_remainder=False))
    assert len(a) == len(b)
    for x, y in zip(a, b):
        _same(x, y)


def test_synthetic_batches_and_skip_match_reference():
    mine = data.skip_batches(data.synthetic_batches(512, 16, 4, seed=3), 2)
    ref = jax_data.skip_batches(
        jax_data.synthetic_batches(512, 16, 4, seed=3), 2)
    for _ in range(3):
        _same(next(mine), next(ref))


def test_tokenizer_byte_default_and_path_refused():
    tok = data.load_tokenizer(None)
    assert tok.encode("hé") == jax_data.ByteTokenizer().encode("hé")
    assert tok.decode(tok.encode("hé")) == "hé"
    # A path that does not load raises, as the reference's does.
    with pytest.raises(RuntimeError, match="could not be loaded"):
        data.load_tokenizer("/some/hf/dir")
    with pytest.raises(RuntimeError):
        jax_data.load_tokenizer("/some/hf/dir")


def test_job_config_from_params_matches_reference():
    params = {"model": "debug", "accumulateSteps": "2", "maxBadSteps": 5,
              "batch_size": "8", "seq_len": 64, "steps": "7",
              "learning_rate": 3e-4, "warmup_steps": 4, "weight_decay": 0.1,
              "lora": {"rank": 4, "alpha": 8.0}, "loss_chunk": 16,
              "model_overrides": {"dtype": "float32"}, "mesh_fsdp": 1,
              "log_every": 2, "checkpoint_every": 3, "seed": 9,
              "data_path": "/x", "prefetch_depth": "3", "unknown_key": 1}
    mine = trainer.TrainJobConfig.from_params(params)
    ref = JaxJobConfig.from_params(params)
    for f in dataclasses.fields(mine):
        a, b = getattr(mine, f.name), getattr(ref, f.name)
        if dataclasses.is_dataclass(a):
            assert dataclasses.asdict(a) == dataclasses.asdict(b), f.name
        else:
            assert a == b, f.name
    assert trainer.TrainJobConfig.from_params({"lora": True}).lora == \
        LoraConfig()


# ---------------------------------------------------------------------------
# run_training on the CPU
# ---------------------------------------------------------------------------

def _job(tmp_path, name, **kw):
    docs = tmp_path / "docs.jsonl"
    if not docs.exists():
        _write_docs(docs)
    base = dict(model="debug", seq_len=32, batch_size=4, accumulate_steps=2,
                steps=4, log_every=1, checkpoint_every=50,
                data_path=str(docs), artifacts_dir=str(tmp_path / name),
                lora=LoraConfig(rank=4, alpha=8.0),
                optimizer=OptimizerConfig(learning_rate=1e-2,
                                          warmup_steps=1, total_steps=4))
    base.update(kw)
    return trainer.TrainJobConfig(**base)


def _final_state(job, step):
    saved, cursor, s = CheckpointManager(job.artifacts_dir)\
        .restore_with_cursor(step)
    return saved, cursor


def test_sigterm_stop_and_resume_is_bitwise_equal(tmp_path, monkeypatch):
    whole = _job(tmp_path, "whole")
    s_whole = trainer.run_training(whole, device="cpu")
    assert s_whole["exit_reason"] is None
    assert trainer.exit_code_for(s_whole) == 0

    orig = trainer._batches

    def batches(job, cfg, skip=0):
        for i, b in enumerate(orig(job, cfg, skip)):
            if skip == 0 and i == 1:
                # Arrives while step 2 (index 1) takes its batch: the loop
                # finishes that step and stops at the boundary after it.
                os.kill(os.getpid(), signal.SIGTERM)
            yield b

    monkeypatch.setattr(trainer, "_batches", batches)
    # The signal is sent from the batch iterator: without the prefetcher
    # it runs in the loop, as step 2 takes its batch (a prefetcher's
    # thread would draw batch 2 while step 1 still runs).
    cut = _job(tmp_path, "cut", prefetch_depth=0)
    s_cut = trainer.run_training(cut, device="cpu")
    assert s_cut["exit_reason"] == "sigterm"
    assert trainer.exit_code_for(s_cut) == EXIT_PREEMPTED
    ckpt = CheckpointManager(cut.artifacts_dir)
    assert ckpt.intact_steps() == [2]
    assert ckpt.read_cursor(2) == {"batches_consumed": 2}

    s_res = trainer.run_training(cut, device="cpu")
    assert s_res["restored_step"] == 2 and s_res["batches_consumed"] == 4
    assert [e["step"] for e in s_res["history"]] == [3, 4]
    assert [e["loss"] for e in s_res["history"]] == \
        [e["loss"] for e in s_whole["history"][2:]]
    a, ca = _final_state(whole, 4)
    b, cb = _final_state(cut, 4)
    assert ca == cb == {"batches_consumed": 4}
    assert a["step"] == b["step"] == 4
    la = list(tree_leaves({"p": a["params"], "mu": a["opt_state"]["mu"],
                           "nu": a["opt_state"]["nu"]}))
    lb = list(tree_leaves({"p": b["params"], "mu": b["opt_state"]["mu"],
                           "nu": b["opt_state"]["nu"]}))
    assert len(la) == len(lb) > 0
    assert all(torch.equal(x, y) for x, y in zip(la, lb))
    assert a["opt_state"]["count"] == b["opt_state"]["count"] == 4
    metrics = json.loads((tmp_path / "cut" / "metrics.json").read_text())
    assert metrics["history"][-1]["step"] == 4
    assert json.loads((tmp_path / "cut" / "lora.json").read_text())[
        "rank"] == 4
    # The handlers are restored after the run.
    assert signal.getsignal(signal.SIGTERM) is not None


def test_consecutive_nonfinite_steps_abort(tmp_path, monkeypatch):
    orig = trainer._batches

    def poisoned(job, cfg, skip=0):
        for b in orig(job, cfg, skip):
            yield dict(b, loss_mask=b["loss_mask"] * np.float32("nan"))

    monkeypatch.setattr(trainer, "_batches", poisoned)
    job = _job(tmp_path, "bad", lora=None, max_bad_steps=2, steps=5)
    with pytest.raises(RuntimeError, match="2 consecutive non-finite"):
        trainer.run_training(job, device="cpu")


def test_full_mode_trains_and_main_reads_the_contract(tmp_path,
                                                      monkeypatch):
    content = tmp_path / "content"
    (content / "data").mkdir(parents=True)
    _write_docs(content / "data" / "docs.jsonl", n=80)
    (content / "params.json").write_text(json.dumps({
        "model": "debug", "seq_len": 32, "batch_size": 4, "steps": 6,
        "log_every": 3, "learning_rate": 3e-3, "warmup_steps": 0,
        "loss_chunk": 8}))
    monkeypatch.setenv("RBT_CONTENT_DIR", str(content))
    monkeypatch.setenv("PARAM_CHECKPOINT_EVERY", "3")
    # main() probes the GCE metadata server when params.json does not
    # set maintenance_poll_s: keep the probe on this machine.
    monkeypatch.setenv("GCE_METADATA_HOST", "127.0.0.1:9")
    monkeypatch.setattr(trainer, "resolve_device",
                        lambda device=None: torch.device("cpu"))
    assert trainer.main() == 0
    metrics = json.loads((content / "artifacts" / "metrics.json")
                         .read_text())
    losses = [e["loss"] for e in metrics["history"]]
    assert [e["step"] for e in metrics["history"]] == [3, 6]
    assert losses[-1] < losses[0]
    assert not metrics["lora"]
    assert CheckpointManager(str(content / "artifacts")).intact_steps() \
        == [3, 6]


def test_fine_tune_the_backward_kernels_cannot_take_is_refused_on_cuda(
        tmp_path, monkeypatch):
    """On CUDA the step's flash attention is K1 then K2/K3, which take
    head_dim 64 and 128: a gemma fine-tune (head_dim 256) is refused by
    name before any work, rather than failing in its first backward. The
    CPU (the plain versions), the plain attention and the other families
    pass."""
    from runbooks_tpu_torch.models.config import get_config

    cuda, cpu = torch.device("cuda"), torch.device("cpu")
    gemma = get_config("gemma-2b")
    with pytest.raises(NotImplementedError,
                       match=r"head_dim 256.*ROADMAP.md §1 item 2 \(b\)"):
        trainer.refuse_unported_attention(gemma, cuda)
    trainer.refuse_unported_attention(gemma, cpu)
    trainer.refuse_unported_attention(
        dataclasses.replace(gemma, attention_impl="xla"), cuda)
    trainer.refuse_unported_attention(get_config("llama3-8b"), cuda)
    # run_training on the card: nothing drawn, built or written.
    monkeypatch.setattr(trainer, "resolve_device", lambda device=None: cuda)
    job = trainer.TrainJobConfig(model="gemma-2b", lora=LoraConfig(),
                                 artifacts_dir=str(tmp_path / "a"))
    with pytest.raises(NotImplementedError, match="head_dim 256"):
        trainer.run_training(job)
    assert not (tmp_path / "a").exists()

