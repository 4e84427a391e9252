"""Two-rank tensor-parallel serving of the port's prefix paths against
the reference's ``tensor=2`` mesh engine (tests/tp_oracle.py): the paged
engine (the pool sharded over kv heads, radix prefix sharing from a
registered prefix, ``kv_occupancy``'s per-device bytes, half the logical
pool) and the dense engine's chat turn whose prompt K/V is lifted from
its slot (``register_prefix_from_slot``) for the next turn."""

import pytest

from tests import tp_oracle, tp_ranks

CASE = {"paged": True, "engine": {"max_slots": 2, "page_size": 16},
        "prefixes": [tp_oracle.SHARED],
        "prompts": [tp_oracle.SHARED + [40 + i] for i in range(3)]
        + [tp_oracle.PROMPTS[1]],
        "max_tokens": 5}


@pytest.mark.parametrize("geometry", ["4on2", "tied"])
def test_paged_prefix_sharing_two_ranks_match_reference(tmp_path, geometry):
    jcfg, jparams, spec = tp_oracle.model(geometry, tmp_path)
    want = tp_oracle.ref_serve(jcfg, jparams, CASE, tp_oracle.ref_mesh())
    got = tp_ranks.run_ranks(tp_ranks.serve, 2, tmp_path, spec,
                             [CASE])[0]["cases"][0]
    assert got["ids"] == want["ids"]
    assert got["prefix_tokens_reused"] == want["prefix_tokens_reused"] > 0
    occ, ref = got["occupancy"], want["occupancy"]
    # The pool shards its kv heads: each device holds half of it.
    assert occ["kv_pool_bytes_per_device"] * 2 == occ["kv_pool_bytes"]
    assert occ["bytes_per_page_per_device"] * 2 == occ["bytes_per_page"]
    for key in ("kv_pool_bytes", "kv_pool_bytes_per_device",
                "bytes_per_page", "bytes_per_page_per_device",
                "pages_reused_total", "pages_shared", "pages_used"):
        assert occ[key] == ref[key], key


def test_dense_prefix_from_slot_two_ranks_match_reference(tmp_path):
    jcfg, jparams, spec = tp_oracle.model("4on2", tmp_path)
    turn = list(range(50, 90))
    case = {"paged": False, "engine": {"max_slots": 2},
            "turns": [turn], "prompts": [turn + [7, 8]], "max_tokens": 5}
    want = tp_oracle.ref_serve(jcfg, jparams, case, tp_oracle.ref_mesh())
    got = tp_ranks.run_ranks(tp_ranks.serve, 2, tmp_path, spec,
                             [case])[0]["cases"][0]
    assert got["ids"] == want["ids"]
    # The second turn prefilled past the 32 tokens lifted from the slot.
    assert got["prefix_tokens_reused"] == want["prefix_tokens_reused"] == 32
