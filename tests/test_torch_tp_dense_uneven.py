"""Two-rank tensor-parallel serving of the port, dense engine, against the
reference's ``tensor=2`` mesh engine (tests/tp_oracle.check_dense), where
the tensor axis does not divide the kv heads: 6 q heads on 3 (q heads
shard over replicated kv heads with a non-uniform map; each rank repeats
the kv heads its q heads read, a registered shared prefix included), and
3 on 1 (heads replicate while the MLP and the vocabulary shard: falcon's
parallel block, one all-reduce per block, as falcon-7b's 71 heads at tp
2 or 4)."""

import pytest

from tests import tp_oracle


@pytest.mark.parametrize("geometry", ["6on3", "3on1"])
def test_dense_two_ranks_match_reference_mesh_engine(tmp_path, geometry):
    plan, fwd, got = tp_oracle.check_dense(tmp_path, geometry)
    if geometry == "6on3":
        assert plan["heads"] and not plan["kv_heads"]
        assert [r["kv_map"] for r in fwd] == [(0, 0, 1), (0, 1, 1)]
        assert got["kv_heads"] == 2     # kv heads 0-1 of 3 on rank 0
    else:
        assert not plan["heads"] and plan["mlp"] and plan["vocab"]
        assert got["kv_heads"] == 1
