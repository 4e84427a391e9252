"""tools/orbax_to_torch.py: a step the JAX trainer wrote with orbax becomes
the port's checkpoint, and the port's trainer resumes from it.

The reference's trainer runs two steps of a ``debug`` job (float32, full
fine-tune and LoRA, synthetic batches) and checkpoints step 2; the script
converts that step; the reference then takes step 3 from its own
checkpoint and the port takes step 3 from the converted one. Both resume
on batch 2 by the copied cursor, so the step-3 losses agree within 1e-5
relative and the step-3 parameters within 1e-5 absolute (the LoRA run's
frozen base is the same reference init on both sides, carried by the
bridge). The port never imports the script or orbax
(tests/test_torch_isolation.py).
"""

import importlib.util
import json
from pathlib import Path

import jax
import numpy as np
import orbax.checkpoint as ocp
import pytest
import torch

from runbooks_tpu.models.config import get_config as jax_get_config
from runbooks_tpu.models.transformer import init_params as jax_init_params
from runbooks_tpu.parallel.mesh import MeshConfig
from runbooks_tpu.train import trainer as jax_trainer
from runbooks_tpu.train.lora import LoraConfig as JaxLoraConfig
from runbooks_tpu.train.optimizer import OptimizerConfig as JaxOptConfig

from runbooks_tpu_torch.models import bridge
from runbooks_tpu_torch.models.config import get_config
from runbooks_tpu_torch.train import trainer
from runbooks_tpu_torch.train.checkpoint import CheckpointManager
from runbooks_tpu_torch.train.lora import LoraConfig
from runbooks_tpu_torch.train.optimizer import OptimizerConfig
from runbooks_tpu_torch.utils.tree import tree_leaves

torch.set_num_threads(2)

TOL = 1e-5
ROOT = Path(__file__).resolve().parents[1]
MESH = MeshConfig(data=2, fsdp=2, sequence=1, tensor=2)
OPT = dict(learning_rate=1e-3, warmup_steps=0, total_steps=100,
           schedule="constant", eps=1e-3)
OVERRIDES = {"dtype": "float32"}


def _tool():
    spec = importlib.util.spec_from_file_location(
        "orbax_to_torch", ROOT / "tools" / "orbax_to_torch.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def _jax_job(art, steps, lora):
    return jax_trainer.TrainJobConfig(
        model="debug", model_overrides=OVERRIDES, mesh=MESH,
        optimizer=JaxOptConfig(**OPT),
        lora=JaxLoraConfig(rank=4, alpha=8.0) if lora else None,
        batch_size=4, seq_len=32, steps=steps, checkpoint_every=2,
        log_every=1, prefetch_depth=0, artifacts_dir=str(art))


def _port_job(art, steps, lora):
    return trainer.TrainJobConfig(
        model="debug", model_overrides=OVERRIDES,
        optimizer=OptimizerConfig(**OPT),
        lora=LoraConfig(rank=4, alpha=8.0) if lora else None,
        batch_size=4, seq_len=32, steps=steps, checkpoint_every=2,
        log_every=1, prefetch_depth=0, artifacts_dir=str(art))


def _jax_params(art, step):
    mgr = ocp.CheckpointManager(str(Path(art) / "checkpoints"))
    try:
        state = mgr.restore(step, args=ocp.args.StandardRestore())
    finally:
        mgr.close()
    return jax.tree.leaves(jax.tree.map(np.asarray, state["params"]))


@pytest.mark.parametrize("lora", [False, True], ids=["full", "lora"])
def test_converted_step_resumes_as_the_reference(tmp_path, lora):
    ref_art, port_art = tmp_path / "ref", tmp_path / "port"
    base = base_np = None
    if lora:
        base = jax_init_params(jax_get_config("debug", **OVERRIDES),
                               jax.random.key(7))
        base_np = jax.tree.map(np.asarray, base)
    jax_trainer.run_training(_jax_job(ref_art, 2, lora), base_params=base)

    info = _tool().convert(str(ref_art), str(port_art),
                           model_overrides=OVERRIDES)
    assert info["step"] == 2 and info["lora"] == lora
    assert info["cursor"] == {"batches_consumed": 2}
    ckpt = CheckpointManager(str(port_art))
    assert ckpt.latest_intact_step() == 2
    assert ckpt.read_cursor(2) == {"batches_consumed": 2}
    saved, _, _ = ckpt.restore_with_cursor(2)
    for a, b in zip(_jax_params(ref_art, 2), tree_leaves(saved["params"])):
        assert np.array_equal(b.numpy(), a)
    assert saved["opt_state"]["count"] == 2 and saved["step"] == 2

    ref = jax_trainer.run_training(_jax_job(ref_art, 3, lora),
                                   base_params=base)
    port_base = (bridge.from_jax_numpy(get_config("debug", **OVERRIDES),
                                       base_np) if lora else None)
    mine = trainer.run_training(_port_job(port_art, 3, lora),
                                base_params=port_base, device="cpu")
    assert mine["restored_step"] == 2
    assert [e["step"] for e in mine["history"]] == [3]
    np.testing.assert_allclose(mine["history"][0]["loss"],
                               ref["history"][-1]["loss"], rtol=TOL)
    got, _, _ = CheckpointManager(str(port_art)).restore_with_cursor(3)
    for a, b in zip(_jax_params(ref_art, 3), tree_leaves(got["params"])):
        np.testing.assert_allclose(b.numpy(), a, atol=TOL)
    if lora:
        assert json.loads((port_art / "lora.json").read_text())["rank"] == 4


def test_port_restore_names_the_converter(tmp_path):
    jax_trainer.run_training(_jax_job(tmp_path, 2, False))
    with pytest.raises(RuntimeError, match="tools/orbax_to_torch.py"):
        trainer.run_training(_port_job(tmp_path, 3, False), device="cpu")
