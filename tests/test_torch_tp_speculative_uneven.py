"""Two-rank tensor-parallel speculative decoding of the port against the
reference's ``tensor=2`` mesh engine (tests/tp_oracle.check_speculative)
through the dense engine, at the geometries whose kv heads the tensor
axis does not divide (6 on 3, 3 on 1), which the paged engine refuses."""

import pytest

from tests import tp_oracle


@pytest.mark.parametrize("geometry", ["6on3", "3on1"])
def test_speculative_two_ranks_match_reference(tmp_path, geometry):
    tp_oracle.check_speculative(tmp_path, geometry)
