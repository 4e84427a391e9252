"""What a two-rank tensor-parallel engine of the port refuses, by name,
and what it now takes: the paged engine's geometry check where the
reference's raises it ("kv-heads not divisible by mesh_tensor", at 6 kv
heads on 3 and 3 on 1), a mesh that is not a DeviceMesh and
collective_matmul "ring" (queued in ROADMAP.md) are refused; so are
quantized weights on these geometries, whose row-parallel wo (and at 3
on 1 the MLP's wo) would be cut off a quantization block on rank 1 (the
off-boundary quantized cut). The int8 KV cache, the adapter pool,
quantized weights whose cuts land on blocks, the host KV tier and
preemption are built under the mesh (served: tests/
test_torch_mesh_features.py)."""

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
    for rank, r in enumerate(got):
        assert r["paged"].startswith(
            "ValueError: kv-heads not divisible by mesh_tensor")
        assert "DeviceMesh" in r["not_a_mesh"]
        refused = r["collective_matmul"]
        assert refused.startswith("NotImplementedError"), refused
        assert "collective_matmul='ring'" in refused, refused
        assert "mesh_tensor=2" in refused, refused
        # Each rank refuses its own off-boundary cut, naming the leaf.
        off = r["quantized"]
        leaf = "attn.wo" if geometry == "6on3" else "mlp.wo"
        assert off.startswith(f"NotImplementedError: {leaf} quantized "
                              "int8"), off
        assert "off-boundary quantized cut" in off, off
        assert f"rank {rank}'s rows" in off, off
        for name in ("quantized_on_blocks", "quantize_kv", "adapter_pool",
                     "host_tier", "preemption"):
            assert r[name] is None, (name, r[name])
