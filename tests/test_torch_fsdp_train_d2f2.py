"""The port's data-parallel x FSDP train step on four gloo ranks (data 2
x fsdp 2) against the reference's sharded step under the same MeshConfig
(tests/fsdp_oracle.py; tests/test_torch_fsdp_train.py has the two-rank
cases and the tolerances): a full fine-tune with accumulate_steps 2 and
uneven loss masks, and a LoRA job on 6 rows, which data x fsdp = 4 does
not divide, so the rows split over data alone and the fsdp copies weigh
0; and that LoRA job on a mixtral geometry (4 experts, top 2, capacity
factor 1.25), where the copies route as their owners and count no tokens
and no aux share.
"""

import pytest
import torch

from runbooks_tpu.train import lora as jax_lora
from tests.fsdp_oracle import check, run_cases

torch.set_num_threads(2)

FOUR_RANKS = {
    "full-llama-d2f2-accumulate2": ("llama", None, 8, 2, True),
    "lora-gpt2-d2f2-6-rows": ("gpt2", jax_lora.DEFAULT_TARGETS, 6, 1,
                              False),
    "lora-mixtral-d2f2-6-rows": ("mixtral", jax_lora.DEFAULT_TARGETS, 6, 1,
                                 False),
}


@pytest.fixture(scope="module")
def four_ranks(tmp_path_factory):
    return run_cases(FOUR_RANKS, {"data": 2, "fsdp": 2},
                   tmp_path_factory.mktemp("d2f2"))


@pytest.mark.parametrize("name", sorted(FOUR_RANKS))
def test_data2_fsdp2_ranks_take_the_reference_step(four_ranks, name):
    ranks = check(four_ranks[name])
    rows = FOUR_RANKS[name][2]
    # Every row is owned once: by the data ranks alone where 4 does not
    # divide the microbatch.
    owned = sorted(i for r in ranks for i in r["rows"][0] if r["rows"][1])
    assert owned == list(range(rows))
    assert all(r["plan"]["data"] == r["plan"]["fsdp"] == 2 for r in ranks)
