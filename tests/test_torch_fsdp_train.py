"""The port's FSDP full fine-tune step on two gloo ranks (fsdp 2)
against the reference's sharded step under the same MeshConfig
(tests/fsdp_oracle.py: the reference's step on the conftest's virtual CPU
devices, its initial trees carried to the port's layout by
``models/bridge.py``).

Each rank (tests/tp_ranks.fsdp_steps) keeps its pieces and its rows and
runs the port's step with its collectives; the cases run in one spawn:
loss masks that leave one rank with no weighted token, and a tied head
(its gradient and the embedding's meet in one reduce-scatter) with
accumulate_steps 2, and the uneven masks again with the gradient's
reduce-scatter done as gloo does it on CUDA tensors (an all-reduce, the
rank's piece kept), which no CPU tensor takes otherwise, and a mixtral
geometry (4 experts, top 2, capacity factor 1.25) with accumulate_steps
2 and the uneven masks: each rank routes its row of every microbatch as
the reference routes the global microbatch (the loss with the aux).
tests/test_torch_fsdp_train_lora.py runs the LoRA
cases, tests/test_torch_fsdp_train_d2f2.py four ranks at data 2 x fsdp 2.

Tolerances (fsdp_oracle.check): each step's loss and gradient norm
within 1e-5 relative, the trainable params after the steps within 1e-5
absolute (lr 1e-3 and eps 1e-3, as tests/test_torch_train_step.py: an
update moves by at most lr * dg / eps). The f32 sums run in another
order than one device's (the reduce over ranks), so the agreement is
within these, not bitwise.
"""

import pytest
import torch

from tests.fsdp_oracle import STEPS, check, run_cases

torch.set_num_threads(2)

# name -> (geometry, lora targets or None, rows, accumulate_steps, uneven
# [, reduce-scatter by all-reduce])
TWO_RANKS = {
    "full-llama-uneven-masks": ("llama", None, 4, 1, True),
    "full-gpt2-tied-accumulate2": ("gpt2", None, 4, 2, False),
    "full-llama-reduce-scatter-by-all-reduce": ("llama", None, 4, 2, True,
                                                True),
    "full-mixtral-accumulate2-uneven-masks": ("mixtral", None, 4, 2, True),
}


@pytest.fixture(scope="module")
def two_ranks(tmp_path_factory):
    return run_cases(TWO_RANKS, {"data": 1, "fsdp": 2},
                   tmp_path_factory.mktemp("fsdp2"))


@pytest.mark.parametrize("name", sorted(TWO_RANKS))
def test_two_fsdp_ranks_take_the_reference_step(two_ranks, name):
    ranks = check(two_ranks[name])
    # Each rank takes its rows of every microbatch.
    (r0, own0), (r1, own1) = (r["rows"] for r in ranks)
    assert sorted(r0 + r1) == list(range(TWO_RANKS[name][2])) and own0 \
        and own1
    counts = ranks[0]["counts"]
    assert counts["all_gather"] > counts["reduce_scatter"] > 0
    by_all_reduce = len(TWO_RANKS[name]) > 5
    assert all(r["scatters"] is not by_all_reduce for r in ranks)
    # Each of the 2 MoE layers gathers the ranks' routing counts for each
    # microbatch in the forward and again in remat's recompute.
    geometry, _, _, k, *_ = TWO_RANKS[name]
    want = 2 * 2 * k * STEPS if geometry == "mixtral" else 0
    assert counts["routing_all_gather"] == want
