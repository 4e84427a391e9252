"""Two-rank tensor-parallel speculative decoding of the port against the
reference's ``tensor=2`` mesh engine (tests/tp_oracle.check_speculative)
through the paged engine, whose pool shards over kv heads: 4 on 2 and
gpt2's tied head. tests/test_torch_tp_speculative_uneven.py holds the
geometries whose kv heads do not divide (the dense engine)."""

import pytest

from tests import tp_oracle


@pytest.mark.parametrize("geometry", ["4on2", "tied"])
def test_speculative_two_ranks_match_reference(tmp_path, geometry):
    tp_oracle.check_speculative(tmp_path, geometry)
