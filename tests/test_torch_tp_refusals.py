"""What a two-rank tensor-parallel engine of the port refuses, by name:
the paged engine's geometry check where the reference's raises it
("kv-heads not divisible by mesh_tensor", at 6 kv heads on 3 and 3 on 1),
a mesh that is not a DeviceMesh, and each feature the slice leaves out
under ``mesh_tensor`` > 1 (quantized weights and the int8 KV cache, the
adapter pool, the host KV tier, preemption, collective_matmul "ring"),
which ROADMAP.md queues."""

import pytest

from runbooks_tpu.serve.paging import PagedInferenceEngine as JaxPaged
from tests import tp_oracle, tp_ranks


@pytest.mark.parametrize("geometry", ["6on3", "3on1"])
def test_paged_geometry_and_out_of_scope_refused_by_name(tmp_path,
                                                         geometry):
    jcfg, jparams, spec = tp_oracle.model(geometry, tmp_path)
    with pytest.raises(ValueError,
                       match="kv-heads not divisible by mesh_tensor"):
        JaxPaged(jcfg, jparams, max_slots=2, mesh=tp_oracle.ref_mesh())
    got = tp_ranks.run_ranks(tp_ranks.refusals, 2, tmp_path, spec)
    for r in got:
        assert r["paged"].startswith(
            "ValueError: kv-heads not divisible by mesh_tensor")
        assert "DeviceMesh" in r["not_a_mesh"]
        for name, words in [
                ("quantized", "quantized weights"),
                ("quantize_kv", "int8 KV cache"),
                ("adapter_pool", "adapter pool"),
                ("host_tier", "host KV tier (kv_host_pages)"),
                ("preemption", "preemption='swap'"),
                ("collective_matmul", "collective_matmul='ring'")]:
            assert r[name].startswith("NotImplementedError"), name
            assert words in r[name] and "mesh_tensor=2" in r[name], r[name]
