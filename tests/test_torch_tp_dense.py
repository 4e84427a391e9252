"""Two-rank tensor-parallel serving of the port, dense engine, against the
reference's ``tensor=2`` mesh engine (tests/tp_oracle.check_dense), at the
geometries where both the q and the kv heads shard: 4 q heads on 2 kv
heads (with a registered shared prefix), and gpt2's tied head (the
transposed embedding sharded over the vocabulary, learned positions).
tests/test_torch_tp_dense_uneven.py holds the geometries whose kv heads
the tensor axis does not divide."""

import pytest

from tests import tp_oracle


@pytest.mark.parametrize("geometry", ["4on2", "tied"])
def test_dense_two_ranks_match_reference_mesh_engine(tmp_path, geometry):
    plan, fwd, got = tp_oracle.check_dense(tmp_path, geometry)
    assert plan["heads"] and plan["kv_heads"] and plan["vocab"]
    assert [r["kv_map"] for r in fwd] == [None, None]
