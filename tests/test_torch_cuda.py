"""Card-only tests of the port's CUDA kernels against their plain PyTorch
versions, and of the HTTP server that serves through them. They import
neither jax nor runbooks_tpu, so they run on a machine without JAX,
skipping the JAX-pinning tests/conftest.py:

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py

Without a GPU each test skips (the kernels have no CPU mode).
"""

import json
import threading
import urllib.request

import pytest
import torch

from runbooks_tpu_torch.ops.flash_attention import (
    BWD_BK,
    BWD_BQ,
    NEG_INF,
    TILE_CLOSED,
    TILE_OPEN,
    bwd_tile_counts,
    flash_attention,
    flash_attention_bwd,
    flash_attention_bwd_reference,
    flash_attention_fwd,
    flash_attention_reference,
    fwd_tile_counts,
    fwd_tile_plan,
)

# Backward kernels against the f32 plain version, per gradient tensor:
# |err| <= BWD_ATOL * max|plain| + BWD_RTOL * |plain|. The kernels round p
# and ds to bf16 as operands of their products (2**-9 relative each) and,
# unless asked for f32, the gradients themselves (2**-8); sums over up to
# 2048 rounded terms add a random walk of a few such roundings relative to
# the largest entry (chip_smoke.py's BWD_ATOL, BWD_RTOL).
BWD_ATOL = 1e-2
BWD_RTOL = 1e-2


def _fwd_case(dev, g, case):
    """(q, k, v, q_pos, kv_pos, seg, block_skip) of a K1 case: the serving
    prefill's shapes (GQA 32/8, d=128, ragged kv of 2049), and the tile
    skips: segments that close tiles, cached prefill at an offset, a ragged
    sk with the causal skip, and d=64."""
    rows, sq, sk, start, h, hk, d = {
        "prompt_kv2049": (1, 256, 2049, 0, 32, 8, 128),
        "cached_prefill_at100": (2, 128, 2049, 100, 32, 8, 128),
        "mha_kv300": (1, 64, 300, 7, 32, 32, 128),
        "segment_closed_tiles": (2, 640, 640, 0, 32, 8, 128),
        "position_skip_at1000": (1, 200, 1500, 1000, 32, 8, 128),
        "ragged_skip": (2, 333, 333, 0, 32, 8, 128),
        "d64_skip": (2, 300, 300, 0, 16, 8, 64),
    }[case]
    q = torch.randn((rows, sq, h, d), generator=g, device=dev,
                    dtype=torch.bfloat16)
    k = torch.randn((rows, sk, hk, d), generator=g, device=dev,
                    dtype=torch.bfloat16)
    v = torch.randn_like(k)
    q_pos = (start + torch.arange(sq, device=dev,
                                  dtype=torch.int32)).expand(rows, sq)
    kv_pos = torch.arange(sk, device=dev, dtype=torch.int32).expand(rows, sk)
    seg = None
    if case == "segment_closed_tiles":
        # Documents of 70, 300 and 150 tokens, positions restarting, and a
        # padding tail: boundaries inside tiles, whole tiles closed.
        seg = torch.zeros((rows, sq), device=dev, dtype=torch.int32)
        pos = torch.zeros((rows, sq), device=dev, dtype=torch.int32)
        at = 0
        for i, n in enumerate((70, 300, 150)):
            seg[:, at:at + n] = i + 1
            pos[:, at:at + n] = torch.arange(n, device=dev, dtype=torch.int32)
            at += n
        q_pos = kv_pos = pos
    skip = case in ("segment_closed_tiles", "ragged_skip", "d64_skip")
    return q, k, v, q_pos.contiguous(), kv_pos.contiguous(), seg, skip


@pytest.mark.cuda
@pytest.mark.parametrize("case", ["prompt_kv2049", "cached_prefill_at100",
                                  "mha_kv300", "segment_closed_tiles",
                                  "position_skip_at1000", "ragged_skip",
                                  "d64_skip"])
def test_kernel_matches_plain_version_on_card(case):
    """The CUDA kernel against its plain version. out within
    1e-2 + 1e-2 * |plain| (bf16 output, one ulp is 2**-7 relative, and bf16
    P in the value product), lse within 1e-3 (f32 throughout); rows in
    segment 0 exactly 0 and NEG_INF; the kv tiles the kernel counts as
    computed and open are those fwd_tile_plan gives, for every head."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU; the kernel has no CPU mode")
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(0)
    q, k, v, q_pos, kv_pos, seg, skip = _fwd_case(dev, g, case)
    fwd_tile_counts()
    out, lse = flash_attention_fwd(q, k, v, q_pos, kv_pos, seg, seg,
                                   block_skip=skip)
    plan = fwd_tile_plan(q_pos, kv_pos, seg, seg, causal=True,
                         block_skip=skip)
    h = q.shape[2]
    assert fwd_tile_counts() == (
        h * int((plan != TILE_CLOSED).sum().item()),
        h * int((plan == TILE_OPEN).sum().item()))
    ref, ref_lse = flash_attention_reference(q, k, v, q_pos, kv_pos, seg,
                                             seg, block_skip=skip)
    torch.cuda.synchronize()
    torch.testing.assert_close(out.float(), ref.float(), atol=1e-2,
                               rtol=1e-2)
    assert torch.isfinite(out.float()).all()
    assert (lse - ref_lse).abs().max().item() < 1e-3
    if seg is not None:
        pad = seg[0] == 0
        assert (out[:, pad] == 0).all()
        assert (lse[:, :, pad] == NEG_INF).all()


@pytest.mark.cuda
def test_kernel_refuses_nonpositive_scale():
    """The forward kernel takes the row max on the raw scores, so it needs
    scale > 0; the wrapper says so instead of a bare launch error."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU; the kernel has no CPU mode")
    dev = torch.device("cuda")
    q = torch.zeros((1, 64, 8, 64), device=dev, dtype=torch.bfloat16)
    pos = torch.arange(64, device=dev, dtype=torch.int32)[None]
    with pytest.raises(ValueError, match="scale > 0"):
        flash_attention_fwd(q, q, q, pos, pos, scale=-0.125)


@pytest.mark.cuda
def test_kernel_launch_is_counted_and_checked():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU; the kernel has no CPU mode")
    dev = torch.device("cuda")
    q = torch.zeros((1, 16, 4, 128), device=dev, dtype=torch.bfloat16)
    k = torch.zeros((1, 16, 2, 128), device=dev, dtype=torch.bfloat16)
    pos = torch.arange(16, device=dev, dtype=torch.int32)[None]
    before = flash_attention.launches
    flash_attention(q, k, k, pos, pos)
    assert flash_attention.launches == before + 1
    with pytest.raises(TypeError):
        flash_attention(q.float(), k.float(), k.float(), pos, pos)
    with pytest.raises(ValueError):
        flash_attention(q[..., :96], k[..., :96], k[..., :96], pos, pos)
    assert flash_attention.launches == before + 1


def _bwd_case(dev, g, b, sq, sk, h, kvh, d, start=0, docs=None):
    """Seeded q, k, v, do and positions; with docs, documents of those
    lengths packed from row 0 (segment ids 1, 2, ..., positions restarting)
    and a padding tail in segment 0."""
    def randn(*shape):
        return torch.randn(shape, generator=g, device=dev,
                           dtype=torch.bfloat16)

    q, k, v, do = (randn(b, sq, h, d), randn(b, sk, kvh, d),
                   randn(b, sk, kvh, d), randn(b, sq, h, d))
    q_pos = (start + torch.arange(sq, device=dev,
                                  dtype=torch.int32)).expand(b, sq)
    kv_pos = torch.arange(sk, device=dev, dtype=torch.int32).expand(b, sk)
    seg = None
    if docs:
        seg = torch.zeros(sq, dtype=torch.int32)
        pos = torch.zeros(sq, dtype=torch.int32)
        at = 0
        for i, n in enumerate(docs):
            seg[at:at + n] = i + 1
            pos[at:at + n] = torch.arange(n)
            at += n
        pos[at:] = torch.arange(sq - at)
        seg = seg.to(dev).expand(b, sq).contiguous()
        q_pos = kv_pos = pos.to(dev).expand(b, sq).contiguous()
    return q, k, v, do, q_pos, kv_pos, seg


def _assert_bwd_close(got, ref):
    for name, a, r in zip(("dq", "dk", "dv"), got, ref):
        a, r = a.float(), r.float()
        assert torch.isfinite(a).all(), name
        excess = ((a - r).abs() - BWD_RTOL * r.abs()).max().item()
        assert excess <= BWD_ATOL * r.abs().max().item(), (name, excess)


@pytest.mark.cuda
@pytest.mark.parametrize("case", ["skip_gqa4", "segments", "ragged",
                                  "d64_rep2", "sk_gt_sq", "f32_grads",
                                  "segment_closed_tiles"])
def test_backward_kernels_match_plain_version_on_card(case):
    """K2 (dq) and K3 (dk, dv) against the plain backward: GQA 32/8 at
    d=128 with the causal skip, packed segments with padding rows, a
    ragged length, d=64 with n_rep 2, more keys than queries with offset
    queries (keys no query sees get exactly 0), f32 gradients, and
    documents of 70, 300 and 150 tokens with a padding tail, whose
    boundaries fall inside tiles and close whole ones. The (q tile, kv
    tile) pairs each kernel counts as computed and open on the card are
    those fwd_tile_plan gives at the backward's tiles, for every head."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU; the kernels have no CPU mode")
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(1)
    shape = {"skip_gqa4": (2, 256, 256, 32, 8, 128),
             "segments": (2, 320, 320, 32, 8, 128),
             "ragged": (1, 200, 200, 32, 8, 128),
             "d64_rep2": (2, 192, 192, 16, 8, 64),
             "sk_gt_sq": (1, 100, 260, 32, 8, 128),
             "f32_grads": (1, 128, 128, 32, 8, 128),
             "segment_closed_tiles": (2, 640, 640, 32, 8, 128)}[case]
    start = 100 if case == "sk_gt_sq" else 0
    # Documents packed from row 0; the rest of each row is padding.
    docs = {"segments": (106, 150),
            "segment_closed_tiles": (70, 300, 150)}.get(case)
    q, k, v, do, qp, kp, seg = _bwd_case(dev, g, *shape, start=start,
                                         docs=docs)
    skip = case != "sk_gt_sq"
    gd = torch.float32 if case == "f32_grads" else None
    out, lse = flash_attention_fwd(q, k, v, qp, kp, seg, seg,
                                   block_skip=skip)
    before = (flash_attention_bwd.dq_launches,
              flash_attention_bwd.dkv_launches)
    bwd_tile_counts()
    got = flash_attention_bwd(q, k, v, qp, kp, seg, seg, out, lse, do,
                              block_skip=skip, grad_dtype=gd)
    assert (flash_attention_bwd.dq_launches,
            flash_attention_bwd.dkv_launches) == (before[0] + 1,
                                                  before[1] + 1)
    plan = fwd_tile_plan(qp, kp, seg, seg, causal=True, block_skip=skip,
                         bq=BWD_BQ, bk=BWD_BK)
    h = q.shape[2]
    predicted = (h * int((plan != TILE_CLOSED).sum().item()),
                 h * int((plan == TILE_OPEN).sum().item()))
    assert bwd_tile_counts() == {"flash_bwd_dq": predicted,
                                 "flash_bwd_dkv": predicted}
    ref = flash_attention_bwd_reference(q, k, v, qp, kp, seg, seg, out, lse,
                                        do, block_skip=skip,
                                        grad_dtype=torch.float32)
    torch.cuda.synchronize()
    if gd is not None:
        assert all(t.dtype == torch.float32 for t in got)
    _assert_bwd_close(got, ref)
    if case == "sk_gt_sq":
        # Queries sit at positions 100..199: keys 200.. are seen by none.
        assert (got[1][:, 200:] == 0).all() and (got[2][:, 200:] == 0).all()
    if seg is not None:
        # Padding rows see no key and padding keys are seen by no row: their
        # gradients are exactly 0, and so are the plain version's.
        pad = seg[0] == 0
        assert (got[0][:, pad] == 0).all()
        assert (got[1][:, pad] == 0).all() and (got[2][:, pad] == 0).all()
    if case == "segment_closed_tiles":
        # Whole tiles are closed here: the counts say the kernels skipped
        # some pairs the causal skip alone leaves.
        causal_only = fwd_tile_plan(qp, qp, causal=True, block_skip=True,
                                    bq=BWD_BQ, bk=BWD_BK)
        assert predicted[0] < h * int((causal_only != TILE_CLOSED).sum())


@pytest.mark.cuda
def test_autograd_function_runs_the_kernels():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU; the kernels have no CPU mode")
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(2)
    q, k, v, do, qp, kp, _ = _bwd_case(dev, g, 1, 128, 128, 8, 2, 128)
    q, k, v = (t.requires_grad_() for t in (q, k, v))
    counts = (flash_attention.launches, flash_attention_bwd.dq_launches,
              flash_attention_bwd.dkv_launches)
    out = flash_attention(q, k, v, qp, kp)
    got = torch.autograd.grad(out, (q, k, v), do)
    assert (flash_attention.launches, flash_attention_bwd.dq_launches,
            flash_attention_bwd.dkv_launches) == tuple(c + 1 for c in counts)
    ref_out, ref_lse = flash_attention_reference(q.detach(), k.detach(),
                                                 v.detach(), qp, kp)
    ref = flash_attention_bwd_reference(q.detach(), k.detach(), v.detach(),
                                        qp, kp, None, None, ref_out, ref_lse,
                                        do, grad_dtype=torch.float32)
    assert all(a.dtype == torch.bfloat16 for a in got)
    _assert_bwd_close(got, ref)


def _post(base, body):
    req = urllib.request.Request(
        base + "/v1/completions", data=json.dumps(body).encode(),
        headers={"Content-Type": "application/json"})
    with urllib.request.urlopen(req, timeout=300) as r:
        return r.status, r.read().decode()


@pytest.mark.cuda
def test_http_server_serves_through_the_kernel():
    """The stdlib server on a 2-layer model with head_dim 128: a greedy
    completion and the same request streamed give the same text, and the
    prefill went through K1."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU; the kernels have no CPU mode")
    from runbooks_tpu_torch.serve.api import create_server, load_model

    cfg, params = load_model({"model": "debug", "model_overrides": {
        "head_dim": 128, "num_layers": 2}, "seed": 0})
    srv = create_server(cfg, params, host="127.0.0.1", port=0, max_slots=2,
                        max_seq_len=256, warmup=True)
    thread = threading.Thread(target=srv.serve_forever, daemon=True)
    thread.start()
    base = f"http://127.0.0.1:{srv.port}"
    try:
        launches = flash_attention.launches
        body = {"prompt": "the kernel serves a token", "max_tokens": 12,
                "temperature": 0}
        status, text = _post(base, body)
        assert status == 200
        choice = json.loads(text)["choices"][0]
        assert flash_attention.launches >= launches + cfg.num_layers
        status, text = _post(base, {**body, "stream": True})
        assert status == 200
        events = [ln[6:] for ln in text.split("\n") if ln.startswith("data: ")]
        assert events[-1] == "[DONE]"
        chunks = [json.loads(e)["choices"][0] for e in events[:-1]]
        assert "".join(c["text"] for c in chunks) == choice["text"]
        assert chunks[-1]["finish_reason"] == choice["finish_reason"]
    finally:
        srv.shutdown()
        thread.join(timeout=60)
    assert not thread.is_alive()
