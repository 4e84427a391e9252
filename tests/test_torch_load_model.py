"""The port's ``load_model`` against the reference's semantics: restore
``{checkpoint or model mount}/checkpoints``, take the seeded init only
when there is nothing to load, raise on a checkpoint that is present but
unreadable, and fold a LoRA adapter artifact at load (``lora_pool.
load_merge_adapter``, held to the JAX package's fold on the same
numbers)."""

import json
import os

import jax
import numpy as np
import pytest
import torch

from runbooks_tpu.models.config import get_config as jax_get_config
from runbooks_tpu.models.transformer import init_params as jax_init_params
from runbooks_tpu.serve import lora_pool as jax_lora_pool
from runbooks_tpu.train.checkpoint import CheckpointManager as JaxCkpt
from runbooks_tpu.train.lora import LoraConfig as JaxLoraConfig
from runbooks_tpu.train.lora import init_lora as jax_init_lora

from runbooks_tpu_torch.models import bridge
from runbooks_tpu_torch.models.config import get_config
from runbooks_tpu_torch.serve import lora_pool
from runbooks_tpu_torch.serve.api import load_model
from runbooks_tpu_torch.train.checkpoint import (
    STATE_FILE,
    CheckpointManager,
    restore_params,
)
from runbooks_tpu_torch.train.lora import LoraConfig
from runbooks_tpu_torch.train.trainer import TrainJobConfig, run_training
from runbooks_tpu_torch.utils.tree import tree_leaves

torch.set_num_threads(2)


@pytest.fixture
def content(tmp_path, monkeypatch):
    """An empty contract root: RBT_CONTENT_DIR points at it."""
    root = tmp_path / "content"
    root.mkdir()
    monkeypatch.setenv("RBT_CONTENT_DIR", str(root))
    return root


def _write_docs(path, n=40):
    rng = np.random.default_rng(0)
    with open(path, "w") as f:
        for _ in range(n):
            text = "".join(rng.choice(list("abcdefgh \n"),
                                      int(rng.integers(20, 120))))
            f.write(json.dumps({"text": text}) + "\n")


def _train(artifacts, data_dir, lora=None, steps=2):
    """A short run of the port's trainer on the CPU; its checkpoint and,
    for LoRA, lora.json land under ``artifacts``."""
    docs = data_dir / "docs.jsonl"
    if not docs.exists():
        _write_docs(docs)
    run_training(TrainJobConfig(
        model="debug", lora=lora, seq_len=32, batch_size=2, steps=steps,
        data_path=str(docs), artifacts_dir=str(artifacts), log_every=100,
        seed=3), device="cpu")


def _saved_params(directory):
    mgr = CheckpointManager(str(directory))
    step = mgr.latest_intact_step()
    return torch.load(os.path.join(directory, "checkpoints", str(step),
                                   STATE_FILE), weights_only=True)["params"]


def _assert_tree_equal(a, b):
    la, lb = list(tree_leaves(a)), list(tree_leaves(b))
    assert len(la) == len(lb)
    for x, y in zip(la, lb):
        assert x.dtype == y.dtype and torch.equal(x, y)


def _seeded(seed=0):
    return load_model({"model": "debug", "seed": seed}, device="cpu")[1]


def test_model_mount_checkpoint_restores_those_params(content, tmp_path):
    init = _seeded(3)   # the trainer's starting point (seed 3)
    _train(content / "model", tmp_path)
    cfg, params = load_model({"model": "debug", "seed": 3}, device="cpu")
    _assert_tree_equal(params, _saved_params(content / "model"))
    assert not torch.equal(params["embed"], init["embed"])


def test_nothing_to_load_takes_the_seeded_init(content):
    seeded = _seeded(4)
    # No mount at all, then an empty checkpoints/ on it.
    _assert_tree_equal(load_model({"model": "debug", "seed": 4},
                                  device="cpu")[1], seeded)
    (content / "model" / "checkpoints").mkdir(parents=True)
    _assert_tree_equal(load_model({"model": "debug", "seed": 4},
                                  device="cpu")[1], seeded)
    assert restore_params(str(content / "model"), torch.device("cpu")) \
        is None


def test_checkpoint_param_wins_over_the_mount(content, tmp_path):
    _train(content / "model", tmp_path, steps=1)
    other = tmp_path / "other"
    _train(other, tmp_path, steps=2)
    params = load_model({"model": "debug", "checkpoint": str(other)},
                        device="cpu")[1]
    _assert_tree_equal(params, _saved_params(other))
    mount = _saved_params(content / "model")
    assert not torch.equal(params["embed"], mount["embed"])


def _unreadable(kind, ckpt):
    """A checkpoints/ directory that holds something the port cannot
    serve."""
    if kind == "cut_off_save":       # a step dir without its marker
        (ckpt / "5").mkdir(parents=True)
        torch.save({"params": {}}, ckpt / "5" / STATE_FILE)
    elif kind == "corrupt_state":    # marker present, state unreadable
        (ckpt / "5").mkdir(parents=True)
        (ckpt / "5" / STATE_FILE).write_bytes(b"not a torch file")
        (ckpt / "5" / CheckpointManager.MARKER).write_text(
            json.dumps({"step": 5, "cursor": {}}))
    elif kind == "stray_file":
        ckpt.mkdir(parents=True)
        (ckpt / "README").write_text("weights elsewhere")
    elif kind == "orbax":            # the reference's own layout
        cfg = jax_get_config("debug")
        mgr = JaxCkpt(str(ckpt.parent))
        try:
            mgr.save(1, {"params": jax_init_params(cfg, jax.random.key(0))},
                     force=True)
            mgr.wait()
        finally:
            mgr.close()


@pytest.mark.parametrize("kind", ["cut_off_save", "corrupt_state",
                                  "stray_file", "orbax"])
def test_unreadable_checkpoint_raises(content, kind):
    _unreadable(kind, content / "model" / "checkpoints")
    with pytest.raises(RuntimeError):
        load_model({"model": "debug"}, device="cpu")


def test_lora_checkpoint_on_the_mount_raises(content, tmp_path):
    _train(content / "model", tmp_path, lora=LoraConfig(rank=4), steps=1)
    with pytest.raises(RuntimeError, match="adapter"):
        load_model({"model": "debug"}, device="cpu")


def test_adapter_fold_matches_jax_fold(tmp_path):
    """One LoRA tree, made by the JAX package and saved by its
    save_adapter, carried across as numbers: the port's
    load_merge_adapter folds it into the bridged base as the JAX
    load_merge_adapter does, within 1e-6."""
    jcfg = jax_get_config("debug", dtype="float32")
    jparams = jax_init_params(jcfg, jax.random.key(0))
    targets = ("attn.wq", "attn.wv", "mlp.wo")
    lcfg = JaxLoraConfig(rank=4, alpha=8.0, targets=targets)
    lora = jax_init_lora(jparams, lcfg, jax.random.key(1))
    # B starts at zero; make the deltas non-trivial.
    keys = jax.random.split(jax.random.key(2), len(targets))
    lora = {t: {"a": ab["a"],
                "b": 0.05 * jax.random.normal(k, ab["b"].shape,
                                              ab["b"].dtype)}
            for k, (t, ab) in zip(keys, sorted(lora.items()))}
    jax_lora_pool.save_adapter(str(tmp_path / "jax"), lora, rank=4,
                               alpha=8.0, targets=targets)
    want = jax_lora_pool.load_merge_adapter(str(tmp_path / "jax"), jcfg,
                                            jparams)

    tcfg = get_config("debug", dtype="float32")
    tparams = bridge.from_jax_numpy(tcfg, jax.tree.map(np.asarray, jparams))
    tlora = {t: {k: torch.from_numpy(np.asarray(v)) for k, v in ab.items()}
             for t, ab in lora.items()}
    lora_pool.save_adapter(str(tmp_path / "torch"), tlora, rank=4,
                           alpha=8.0, targets=targets)
    got = lora_pool.load_merge_adapter(str(tmp_path / "torch"), tcfg,
                                       tparams)
    want_t = bridge.from_jax_numpy(tcfg, jax.tree.map(np.asarray, want))
    for a, b in zip(tree_leaves(got), tree_leaves(want_t)):
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=0, atol=1e-6)
    for t in targets:
        group, name = t.split(".")
        assert not torch.equal(got["layers"][group][name],
                               tparams["layers"][group][name])
    assert torch.equal(got["layers"]["attn"]["wk"],
                       tparams["layers"]["attn"]["wk"])
    assert lora_pool.read_adapter_meta(str(tmp_path / "torch")) == \
        jax_lora_pool.read_adapter_meta(str(tmp_path / "jax"))


def test_load_model_folds_the_trainers_adapter(content, tmp_path):
    """What the port's LoRA fine-tune writes is what `adapter:` serves:
    merged = base + (alpha / rank) A B over the same seeded base."""
    art = tmp_path / "run"
    _train(art, tmp_path, lora=LoraConfig(rank=4, alpha=8.0), steps=2)
    lora = _saved_params(art)
    base = load_model({"model": "debug", "seed": 3}, device="cpu")[1]
    merged = load_model({"model": "debug", "seed": 3, "adapter": str(art)},
                        device="cpu")[1]
    for target, ab in lora.items():
        group, name = target.split(".")
        w = base["layers"][group][name]
        want = (w.float() + 2.0 * torch.matmul(ab["a"].float(),
                                               ab["b"].float())).to(w.dtype)
        torch.testing.assert_close(merged["layers"][group][name], want,
                                   rtol=0, atol=1e-6)
        assert not torch.equal(merged["layers"][group][name], w)
    _assert_tree_equal(merged["layers"]["mlp"], base["layers"]["mlp"])


def test_adapter_refusals(tmp_path):
    with pytest.raises(RuntimeError, match="mutually exclusive"):
        load_model({"model": "debug", "adapter": str(tmp_path),
                    "adapter_pool": 2}, device="cpu")
    with pytest.raises(NotImplementedError, match="adapter pool"):
        load_model({"model": "debug", "adapterPool": 1}, device="cpu")
    with pytest.raises(lora_pool.AdapterLoadError, match="checkpoints/"):
        load_model({"model": "debug", "adapter": str(tmp_path)},
                   device="cpu")
    cfg, base = load_model({"model": "debug"}, device="cpu")
    bad = {"attn.wq": {"a": torch.zeros(2, 128, 4),
                       "b": torch.zeros(2, 4, 64)}}
    lora_pool.save_adapter(str(tmp_path / "bad"), bad, rank=4, alpha=8.0)
    with pytest.raises(lora_pool.AdapterLoadError, match="do not fit"):
        lora_pool.load_merge_adapter(str(tmp_path / "bad"), cfg, base)
    wrong = {"attn.wz": {"a": torch.zeros(2, 128, 4),
                         "b": torch.zeros(2, 4, 128)}}
    lora_pool.save_adapter(str(tmp_path / "wrong"), wrong, rank=4, alpha=8.0)
    with pytest.raises(lora_pool.AdapterLoadError, match="attn.wz"):
        lora_pool.load_merge_adapter(str(tmp_path / "wrong"), cfg, base)
    assert lora_pool.adapter_artifact_ok(str(tmp_path / "bad")) is None
    assert "no such directory" in lora_pool.adapter_artifact_ok(
        str(tmp_path / "missing"))
    assert lora_pool.read_adapter_meta(str(tmp_path)) == {}


def test_restore_reads_params_only_onto_the_device(tmp_path):
    params = {"embed": torch.arange(6.0).reshape(2, 3)}
    opt = {"mu": torch.ones(2, 3)}
    CheckpointManager(str(tmp_path)).save(7, {"step": 7, "params": params,
                                              "opt_state": opt})
    got, step = restore_params(str(tmp_path), torch.device("cpu"))
    assert step == 7 and set(got) == {"embed"}
    assert torch.equal(got["embed"], params["embed"])
    got["embed"].add_(1)   # a private copy, not the mapped file
    again, _ = restore_params(str(tmp_path), torch.device("cpu"))
    assert torch.equal(again["embed"], params["embed"])
