"""The port's FSDP LoRA step on two gloo ranks (fsdp 2) against the
reference's sharded step under the same MeshConfig (tests/fsdp_oracle.py;
tests/test_torch_fsdp_train.py has the full fine-tune cases and the
tolerances). Both cases run in one spawn: every target of a falcon
geometry with accumulate_steps 2, and a batch of 3 rows that 2 does not
divide (every rank takes all rows, rank 1's weigh 0) with uneven loss
masks. The frozen base sends no gradient: only the sharded LoRA factors
are reduce-scattered.
"""

import pytest
import torch

from runbooks_tpu.train import lora as jax_lora
from tests.fsdp_oracle import STEPS, check, run_cases

torch.set_num_threads(2)

# name -> (geometry, lora targets or None, rows, accumulate_steps, uneven)
TWO_RANKS = {
    "lora-falcon-accumulate2": ("falcon", jax_lora.ALL_TARGETS, 4, 2, False),
    "lora-llama-3-rows": ("llama", jax_lora.DEFAULT_TARGETS, 3, 1, True),
}


@pytest.fixture(scope="module")
def two_ranks(tmp_path_factory):
    return run_cases(TWO_RANKS, {"data": 1, "fsdp": 2},
                   tmp_path_factory.mktemp("fsdp2_lora"))


@pytest.mark.parametrize("name", sorted(TWO_RANKS))
def test_two_fsdp_ranks_take_the_reference_lora_step(two_ranks, name):
    ranks = check(two_ranks[name])
    _, _, rows, k, _ = TWO_RANKS[name]
    # Each rank takes its rows of every microbatch, or all of them where
    # 2 does not divide the microbatch (rank 1's then weigh 0).
    (r0, own0), (r1, own1) = (r["rows"] for r in ranks)
    if (rows // k) % 2:
        assert r0 == r1 == list(range(rows)) and own0 and not own1
    else:
        assert sorted(r0 + r1) == list(range(rows)) and own0 and own1
    # Each microbatch reduce-scatters the sharded LoRA factors of each of
    # the 2 layers, nothing of the frozen base.
    counts = ranks[0]["counts"]
    sharded = ranks[0]["plan"]["lora"]["sharded"]
    assert counts["reduce_scatter"] == sharded * 2 * k * STEPS
    assert counts["all_gather"] > counts["reduce_scatter"]
