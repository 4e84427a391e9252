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
    sk with the causal skip, d=64, and the non-Llama families' groupings at
    d=64: falcon-7b's 71 query heads on one kv head over a 2049-slot
    cache, falcon-40b's 128 on 8 with the skip; and gemma's head_dim 256
    (one block per SM): gemma-7b's 16/16 over a 2049-slot cache at an
    offset, gemma-2b's 8 on 1 with the skip and a ragged sq, segments
    that close tiles."""
    rows, sq, sk, start, h, hk, d = {
        "prompt_kv2049": (1, 256, 2049, 0, 32, 8, 128),
        "cached_prefill_at100": (2, 128, 2049, 100, 32, 8, 128),
        "mha_kv300": (1, 64, 300, 7, 32, 32, 128),
        "segment_closed_tiles": (2, 640, 640, 0, 32, 8, 128),
        "position_skip_at1000": (1, 200, 1500, 1000, 32, 8, 128),
        "ragged_skip": (2, 333, 333, 0, 32, 8, 128),
        "d64_skip": (2, 300, 300, 0, 16, 8, 64),
        "falcon7b_mqa71_kv2049": (2, 128, 2049, 300, 71, 1, 64),
        "falcon40b_rep16_skip": (1, 300, 300, 0, 128, 8, 64),
        "gemma7b_d256_kv2049": (2, 128, 2049, 300, 16, 16, 256),
        "gemma2b_d256_ragged_skip": (2, 333, 333, 0, 8, 1, 256),
        "d256_segment_closed_tiles": (2, 640, 640, 0, 8, 4, 256),
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
    if case.endswith("segment_closed_tiles"):
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
    skip = case in ("segment_closed_tiles", "ragged_skip", "d64_skip",
                    "falcon40b_rep16_skip", "gemma2b_d256_ragged_skip",
                    "d256_segment_closed_tiles")
    return q, k, v, q_pos.contiguous(), kv_pos.contiguous(), seg, skip


@pytest.mark.cuda
@pytest.mark.parametrize("case", ["prompt_kv2049", "cached_prefill_at100",
                                  "mha_kv300", "segment_closed_tiles",
                                  "position_skip_at1000", "ragged_skip",
                                  "d64_skip", "falcon7b_mqa71_kv2049",
                                  "falcon40b_rep16_skip",
                                  "gemma7b_d256_kv2049",
                                  "gemma2b_d256_ragged_skip",
                                  "d256_segment_closed_tiles"])
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


@pytest.mark.cuda
def test_backward_kernels_refuse_head_dim_96():
    """K2 and K3 are built for head_dim 64, 128 and 256: at any other
    (96 here) a CUDA tensor raises by name, with no launch, instead of
    falling back to the plain version."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU; the kernel has no CPU mode")
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(1)
    q, k, v, do, qp, kp, _ = _bwd_case(dev, g, 1, 64, 64, 4, 2, 96)
    out = torch.zeros_like(q)
    lse = torch.zeros((1, 4, 64), device=dev)
    before = (flash_attention_bwd.dq_launches,
              flash_attention_bwd.dkv_launches)
    with pytest.raises(ValueError, match=r"backward kernels take head_dim "
                                         r"in \(64, 128, 256\), got 96"):
        flash_attention_bwd(q, k, v, qp, kp, None, None, out, lse, do)
    assert (flash_attention_bwd.dq_launches,
            flash_attention_bwd.dkv_launches) == before


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
                                  "segment_closed_tiles", "falcon7b_mqa71",
                                  "falcon40b_rep16", "gemma7b_d256",
                                  "gemma2b_d256_ragged_skip",
                                  "d256_segment_closed_tiles",
                                  "d256_f32_grads"])
def test_backward_kernels_match_plain_version_on_card(case):
    """K2 (dq) and K3 (dk, dv) against the plain backward: GQA 32/8 at
    d=128 with the causal skip, packed segments with padding rows, a
    ragged length, d=64 with n_rep 2, more keys than queries with offset
    queries (keys no query sees get exactly 0), f32 gradients, and
    documents of 70, 300 and 150 tokens with a padding tail, whose
    boundaries fall inside tiles and close whole ones; falcon-7b's 71
    query heads on one kv head (K3 walks all 71 in each block) and
    falcon-40b's 128 on 8, both at d=64; and gemma's head_dim 256 (one
    block per SM; K3 splits the head_dim across two blocks per kv tile):
    gemma-7b's 16/16, gemma-2b's 8 on 1 at a ragged length with the skip,
    the documents that close whole tiles at 8/4, and f32 gradients. The
    (q tile, kv tile) pairs each kernel counts as computed and open on the
    card are those fwd_tile_plan gives at the backward's tiles, for every
    head (at d=256 one block of each kv tile counts)."""
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
             "segment_closed_tiles": (2, 640, 640, 32, 8, 128),
             "falcon7b_mqa71": (2, 256, 256, 71, 1, 64),
             "falcon40b_rep16": (1, 192, 192, 128, 8, 64),
             "gemma7b_d256": (2, 256, 256, 16, 16, 256),
             "gemma2b_d256_ragged_skip": (2, 333, 333, 8, 1, 256),
             "d256_segment_closed_tiles": (2, 640, 640, 8, 4, 256),
             "d256_f32_grads": (1, 128, 128, 8, 2, 256)}[case]
    start = 100 if case == "sk_gt_sq" else 0
    # Documents packed from row 0; the rest of each row is padding.
    docs = {"segments": (106, 150),
            "segment_closed_tiles": (70, 300, 150),
            "d256_segment_closed_tiles": (70, 300, 150)}.get(case)
    q, k, v, do, qp, kp, seg = _bwd_case(dev, g, *shape, start=start,
                                         docs=docs)
    skip = case != "sk_gt_sq"
    gd = torch.float32 if case.endswith("f32_grads") else None
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
    if case.endswith("segment_closed_tiles"):
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


@pytest.mark.cuda
@pytest.mark.parametrize("policy", ["dots_with_no_batch_dims_saveable",
                                    "dots_saveable", "save_attn_out"])
def test_remat_policy_on_the_kernels(policy):
    """A 2-layer falcon-7b-shaped model (71 query heads on 1 kv head, d
    64) at width 4544 through K1-K3 under each remat policy: the logits
    and gradients equal nothing_saveable's bit for bit (a policy changes
    what the backward keeps, not the arithmetic), and save_attn_out
    launches K1 once per layer instead of twice."""
    import dataclasses

    from runbooks_tpu_torch.models.config import get_config
    from runbooks_tpu_torch.models.transformer import forward, init_params

    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU; the kernels have no CPU mode")
    dev = torch.device("cuda")
    base = get_config("falcon-7b", num_layers=2, vocab_size=1024)
    params = init_params(base, torch.Generator(device=dev).manual_seed(3),
                         dev)
    tokens = torch.randint(0, 1024, (2, 256), device=dev,
                           generator=torch.Generator(device=dev)
                           .manual_seed(4))
    runs = {}
    for name in ("nothing_saveable", policy):
        w = params["layers"]["attn"]["wq"].detach().clone().requires_grad_()
        p = dict(params, layers=dict(params["layers"], attn=dict(
            params["layers"]["attn"], wq=w)))
        before = flash_attention.launches
        logits, _ = forward(dataclasses.replace(base, remat_policy=name), p,
                            tokens, remat=True)
        (grad,) = torch.autograd.grad(logits.float().square().mean(), w)
        torch.cuda.synchronize()
        runs[name] = (logits.detach(), grad,
                      flash_attention.launches - before)
    (l0, g0, n0), (l1, g1, n1) = runs["nothing_saveable"], runs[policy]
    assert torch.equal(l0, l1) and torch.equal(g0, g1)
    assert n0 == 2 * base.num_layers
    assert n1 == (base.num_layers if policy == "save_attn_out" else n0)


@pytest.mark.cuda
@pytest.mark.parametrize("policy", ["nothing_saveable",
                                    "dots_with_no_batch_dims_saveable",
                                    "dots_saveable", "save_attn_out"])
def test_gemma_fine_tune_runs_the_kernels_at_head_dim_256(policy):
    """A 2-layer gemma-2b (8 query heads of 256 on 1 kv head, width 2048,
    the scaled embedding and the tied head) through K1-K3 under each remat
    policy: K2 and K3 launch once per layer, K1 twice (once under
    save_attn_out, whose saved out and lse the recompute takes), the
    logits and the embedding's gradient equal nothing_saveable's bit for
    bit, and the embedding's gradient (the scaled lookup's rows and the
    tied head's share) is finite and reaches every looked-up row."""
    import dataclasses

    from runbooks_tpu_torch.models.config import get_config
    from runbooks_tpu_torch.models.transformer import forward, init_params

    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU; the kernels have no CPU mode")
    dev = torch.device("cuda")
    base = get_config("gemma-2b", num_layers=2, vocab_size=1024,
                      attention_impl="flash")
    params = init_params(base, torch.Generator(device=dev).manual_seed(5),
                         dev)
    tokens = torch.randint(0, 1024, (2, 256), device=dev,
                           generator=torch.Generator(device=dev)
                           .manual_seed(6))
    runs = {}
    for name in dict.fromkeys(("nothing_saveable", policy)):
        emb = params["embed"].detach().clone().requires_grad_()
        counts = (flash_attention.launches, flash_attention_bwd.dq_launches,
                  flash_attention_bwd.dkv_launches)
        logits, _ = forward(dataclasses.replace(base, remat_policy=name),
                            dict(params, embed=emb), tokens, remat=True)
        (grad,) = torch.autograd.grad(logits.float().square().mean(), emb)
        torch.cuda.synchronize()
        runs[name] = (logits.detach(), grad, tuple(
            a - b for a, b in zip((flash_attention.launches,
                                   flash_attention_bwd.dq_launches,
                                   flash_attention_bwd.dkv_launches),
                                  counts)))
    (l0, g0, _), (l1, g1, n1) = runs["nothing_saveable"], runs[policy]
    n = base.num_layers
    assert n1 == ((n if policy == "save_attn_out" else 2 * n), n, n)
    assert torch.equal(l0, l1) and torch.equal(g0, g1)
    assert torch.isfinite(g1).all()
    seen = torch.unique(tokens)
    assert (g1[seen].abs().sum(-1) > 0).all()


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


@pytest.mark.cuda
def test_verify_greedy_rows_equal_argmax_on_card():
    """speculative_verify at llama3's vocabulary: with temperature 0 the
    verdicts are the argmax exactly (accept = draft == argmax, resid and
    full = argmax)."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    from runbooks_tpu_torch.ops.sampling import speculative_verify

    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(0)
    vocab = 128256
    logits = torch.randn((8, 5, vocab), generator=g, device=dev)
    argmax = logits.argmax(-1)
    drafts = argmax[:, :4].clone()
    drafts[1::2, 2:] = (drafts[1::2, 2:] + 1) % vocab
    accept, resid, full = speculative_verify(
        logits, drafts, g, torch.zeros(8, device=dev),
        torch.zeros(8, dtype=torch.int32, device=dev),
        torch.ones(8, device=dev))
    assert torch.equal(accept, drafts == argmax[:, :4])
    assert torch.equal(resid, argmax[:, :4])
    assert torch.equal(full, argmax)


def _two_layer_llama3(seed=0):
    """llama3-8b at full width cut to 2 layers, f32 with the plain
    attention: the decode step's [8, 1] and the verify forward's [8, 5]
    products then agree to f32 rounding, far below the gaps between
    greedy candidates, so greedy ids must be identical."""
    from runbooks_tpu_torch.serve.api import load_model

    return load_model({"model": "llama3-8b", "seed": seed,
                       "model_overrides": {"num_layers": 2,
                                           "dtype": "float32",
                                           "attention_impl": "xla"}})


@pytest.mark.cuda
def test_speculation_keeps_greedy_ids_on_card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    from runbooks_tpu_torch.serve.engine import InferenceEngine, Request

    cfg, params = _two_layer_llama3()
    prompts = [[5, 6, 7, 8] * 40, list(range(100, 160)) * 3]
    outs = {}
    for spec in ("off", "ngram"):
        eng = InferenceEngine(cfg, params, max_slots=2, max_seq_len=512,
                              speculative=spec)
        reqs = [Request(prompt_tokens=p, max_tokens=40) for p in prompts]
        with torch.no_grad():
            eng.generate(reqs)
        outs[spec] = [r.output_tokens for r in reqs]
        if spec == "ngram":
            assert eng.spec_verify_steps > 0 and eng.spec_drafted > 0
        del eng
    assert outs["ngram"] == outs["off"]


@pytest.mark.cuda
def test_constrained_request_completes_on_card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    from runbooks_tpu_torch.serve.engine import InferenceEngine, Request
    from runbooks_tpu_torch.train.data import ByteTokenizer

    cfg, params = _two_layer_llama3()
    tok = ByteTokenizer()
    rf = {"type": "json_schema", "json_schema": {"schema": {
        "type": "object",
        "properties": {"ok": {"type": "boolean"},
                       "mode": {"enum": ["a", "b"]}},
        "required": ["ok", "mode"], "additionalProperties": False}}}
    eng = InferenceEngine(cfg, params, max_slots=2, max_seq_len=512,
                          grammar="on", tokenizer=tok, speculative="ngram")
    req = Request(prompt_tokens=tok.encode("emit json: ", add_eos=False),
                  max_tokens=64, eos_id=tok.eos_id, response_format=rf)
    with torch.no_grad():
        eng.generate([req])
    assert req.finish_reason == "grammar_complete"
    out = json.loads(tok.decode(req.output_tokens))
    assert set(out) == {"ok", "mode"} and out["mode"] in ("a", "b")


def _paged_pool_case(dev, seed=0):
    """A bf16 page pool at llama3's head shape (8 kv heads of 128), two
    layers, 8 pages of 16 plus the trash page, with 3 slots' page tables
    (a shared page, trash-padded tails)."""
    from runbooks_tpu_torch.serve.paging import PagePool

    g = torch.Generator().manual_seed(seed)
    shape = (2, 9, 16, 8, 128)
    k = torch.randn(shape, generator=g).to(torch.bfloat16)
    v = torch.randn(shape, generator=g).to(torch.bfloat16)
    tables = torch.tensor([[3, 1, 8, 8], [3, 5, 6, 8], [0, 2, 4, 7]],
                          dtype=torch.int32)
    return PagePool(k=k.to(dev), v=v.to(dev)), tables.to(dev)


@pytest.mark.cuda
def test_paged_gather_and_write_back_match_cpu_on_card():
    """The decode view's gather and the per-step write-back on the card
    equal the CPU's bit for bit (both are copies)."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    from runbooks_tpu_torch.serve.paging import gather_view, write_back

    got = {}
    for name, dev in (("cpu", torch.device("cpu")),
                      ("cuda", torch.device("cuda"))):
        pool, tables = _paged_pool_case(dev)
        view = gather_view(pool, tables, 3)
        assert view.k.shape == (2, 3, 49, 8, 128)
        view.k[:, :, 20] += 1
        view.v[:, :, 21] -= 1
        pos = torch.tensor([20, 21, 48], dtype=torch.int32, device=dev)
        write_back(pool, view, tables, pos,
                   torch.tensor([True, True, False], device=dev))
        pos2 = torch.tensor([[20, 21], [20, 48], [5, 6]], dtype=torch.int32,
                            device=dev)
        live2 = torch.tensor([[True, True], [True, False], [False, True]],
                             device=dev)
        write_back(pool, view, tables, pos2, live2)
        got[name] = [t.cpu() for t in (view.k, view.v, pool.k[:, :8],
                                       pool.v[:, :8])]
    for a, b in zip(got["cpu"], got["cuda"]):
        assert torch.equal(a, b)


@pytest.mark.cuda
def test_pinned_swap_round_trip_is_bit_identical_on_card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    from runbooks_tpu_torch.models.config import get_config
    from runbooks_tpu_torch.serve.paging import (
        HostPagePool,
        make_kv_swap_in_fn,
        make_kv_swap_out_fn,
    )

    dev = torch.device("cuda")
    pool, _ = _paged_pool_case(dev)
    cfg = get_config("llama3-8b", num_layers=2)
    host = HostPagePool(cfg, 4, 16, pin_memory=True)
    assert host.k.is_pinned() and host.k.dtype == torch.bfloat16
    want_k, want_v = pool.k[:, 3].clone(), pool.v[:, 3].clone()
    h = host.alloc()
    host.store(h, *make_kv_swap_out_fn()(pool, 3))
    # The device page may be reused at once: store() waited for the copy.
    pool.k[:, 3].zero_()
    pool.v[:, 3].zero_()
    make_kv_swap_in_fn()(pool, 6, *host.load(h))
    torch.cuda.synchronize()
    assert torch.equal(pool.k[:, 6], want_k)
    assert torch.equal(pool.v[:, 6], want_v)


@pytest.mark.cuda
def test_paged_engine_writes_the_pool_in_place_on_card():
    """A decode chunk leaves the pool's storage where it was (no
    out-of-place copy of the pool), and the paged engine's greedy ids
    equal the dense engine's (f32, plain attention)."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    from runbooks_tpu_torch.serve.engine import InferenceEngine, Request
    from runbooks_tpu_torch.serve.paging import PagedInferenceEngine

    cfg, params = _two_layer_llama3()
    prompts = [list(range(100, 160)), [5, 6, 7] * 30]
    outs = {}
    for cls in (InferenceEngine, PagedInferenceEngine):
        eng = cls(cfg, params, max_slots=2, max_seq_len=512)
        reqs = [Request(prompt_tokens=p, max_tokens=24) for p in prompts]
        with torch.no_grad():
            for r in reqs:
                eng.submit(r)
            eng.step()                  # prefill, then a decode chunk
            ptrs = (eng.cache.k.data_ptr(), eng.cache.v.data_ptr())
            while eng.has_work():
                eng.step()
        assert (eng.cache.k.data_ptr(), eng.cache.v.data_ptr()) == ptrs
        outs[cls.__name__] = [r.output_tokens for r in reqs]
        del eng
    assert outs["PagedInferenceEngine"] == outs["InferenceEngine"]


@pytest.mark.cuda
def test_paged_prefill_runs_the_kernel_on_card():
    """Paged prefill, with and without a shared prefix gathered from
    pages, launches K1 once per layer."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    from runbooks_tpu_torch.serve.api import load_model
    from runbooks_tpu_torch.serve.engine import Request
    from runbooks_tpu_torch.serve.paging import PagedInferenceEngine

    cfg, params = load_model({"model": "debug", "model_overrides": {
        "head_dim": 128, "num_layers": 2}, "seed": 0})
    eng = PagedInferenceEngine(cfg, params, max_slots=2, max_seq_len=256)
    prompt = list(range(1, 60))
    with torch.no_grad():
        for _ in range(2):
            launches = flash_attention.launches
            req = Request(prompt_tokens=prompt, max_tokens=4)
            eng.generate([req])
            assert flash_attention.launches == launches + cfg.num_layers
            assert req.finish_reason == "length"
        assert eng.pager.pages_reused_total == 3


def _adapter_artifacts(cfg, root, ranks=(16, 8), seed=0):
    """Adapter artifacts for cfg's attention targets (rank, alpha 2 *
    rank), written by the port's save_adapter; B non-zero."""
    from runbooks_tpu_torch.ops.lora import target_dims
    from runbooks_tpu_torch.serve.lora_pool import save_adapter

    g = torch.Generator().manual_seed(seed)
    paths = []
    for i, rank in enumerate(ranks):
        tree = {}
        for t in ("attn.wq", "attn.wk", "attn.wv", "attn.wo"):
            d_in, d_out = target_dims(cfg, t)
            tree[t] = {
                "a": torch.randn((cfg.num_layers, d_in, rank),
                                 generator=g) * d_in ** -0.5,
                "b": torch.randn((cfg.num_layers, rank, d_out),
                                 generator=g) * 0.02}
        path = f"{root}/tenant{i}"
        save_adapter(path, tree, rank=rank, alpha=2.0 * rank)
        paths.append(path)
    return paths


@pytest.mark.cuda
def test_adapter_lane_write_is_in_place_on_card(tmp_path):
    """Loading an adapter into a pool lane on the card writes the existing
    bf16 pool tensors in place (the storage pointers do not move) and
    leaves the lane equal to the CPU's cast of the padded, scaled tree."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    from runbooks_tpu_torch.models.config import get_config
    from runbooks_tpu_torch.serve.lora_pool import (
        AdapterPool,
        load_adapter_tree,
    )

    cfg = get_config("llama3-8b", num_layers=2, adapter_pool=2,
                     lora_rank=16)
    paths = _adapter_artifacts(cfg, str(tmp_path))
    pool = AdapterPool(cfg, device=torch.device("cuda"))
    ptrs = {(g, n, k): ab[k].data_ptr() for g, sub in pool.tree.items()
            for n, ab in sub.items() for k in ("a", "b")}
    lanes = [pool.acquire(p) for p in paths]
    torch.cuda.synchronize()
    assert lanes == [0, 1]
    for (g, n, k), ptr in ptrs.items():
        leaf = pool.tree[g][n][k]
        assert leaf.data_ptr() == ptr and leaf.dtype == torch.bfloat16
        for lane, path in zip(lanes, paths):
            want = load_adapter_tree(path, cfg, cfg.lora_targets, 16)
            assert torch.equal(leaf[:, lane].cpu(),
                               want[g][n][k].to(torch.bfloat16))
        assert not leaf[:, 2].any()          # the trash lane


@pytest.mark.cuda
@pytest.mark.parametrize("paged", [False, True])
def test_pooled_ids_equal_folded_ids_on_card(tmp_path, paged):
    """f32, plain attention: two tenants (ranks 16 and 8) and a base-only
    row in one pooled batch give the greedy ids of dedicated engines over
    the folded weights, and the base row the no-pool engine's."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    from runbooks_tpu_torch.serve.engine import InferenceEngine, Request
    from runbooks_tpu_torch.serve.lora_pool import load_merge_adapter
    from runbooks_tpu_torch.serve.paging import PagedInferenceEngine

    cfg, params = _two_layer_llama3()
    paths = _adapter_artifacts(cfg, str(tmp_path))
    prompts = [list(range(100, 160)), [5, 6, 7] * 30, list(range(7, 40))]
    cls = PagedInferenceEngine if paged else InferenceEngine
    eng = cls(cfg, params, max_slots=4, max_seq_len=512, adapter_pool=2,
              lora_rank=16)
    reqs = [Request(prompt_tokens=p, max_tokens=24, adapter=a)
            for p, a in zip(prompts, paths + [None])]
    with torch.no_grad():
        eng.generate(reqs)
    del eng
    for i, a in enumerate(paths + [None]):
        p = load_merge_adapter(a, cfg, params) if a else params
        ref = InferenceEngine(cfg, p, max_slots=4, max_seq_len=512)
        want = Request(prompt_tokens=prompts[i], max_tokens=24)
        with torch.no_grad():
            ref.generate([want])
        assert reqs[i].output_tokens == want.output_tokens, i
        del ref, p


@pytest.mark.cuda
@pytest.mark.parametrize("bits", [8, 4])
def test_quantized_matmul_matches_f32_oracle_on_card(bits):
    """quantized_matmul on the card (TF32 off, as chip_smoke.py sets it)
    against x.float() @ dequantize(w) within 1e-5 of the output's largest
    entry, and against the CPU port on the same inputs; the card's codes
    and scales equal the CPU's."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    from runbooks_tpu_torch.ops.quantization import (
        dequantize,
        quantize,
        quantized_matmul,
    )

    tf32 = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        g = torch.Generator(device="cuda").manual_seed(bits)
        w = (torch.randn((4096, 1024), generator=g, device="cuda")
             * 4096 ** -0.5).to(torch.bfloat16)
        x = torch.randn((300, 4096), generator=g,
                        device="cuda").to(torch.bfloat16)
        qa = quantize(w, bits)
        cpu_qa = quantize(w.cpu(), bits)
        assert torch.equal(qa.values.cpu(), cpu_qa.values)
        assert torch.equal(qa.scales.cpu(), cpu_qa.scales)
        got = quantized_matmul(x, qa, torch.bfloat16)
        want = x.float() @ dequantize(qa)
        scale = want.abs().max().item()
        assert (got - want).abs().max().item() <= 1e-5 * scale
        cpu = quantized_matmul(x.cpu(), cpu_qa, torch.bfloat16)
        assert (got.cpu() - cpu).abs().max().item() <= 1e-5 * scale
    finally:
        torch.backends.cuda.matmul.allow_tf32 = tf32


@pytest.mark.cuda
def test_int8_engine_matches_cpu_port_on_card():
    """f32 (plain attention) on the debug config widened to head_dim 64:
    int8 weights and an int8 KV cache on the card, dense and paged, give
    the CPU port's greedy ids."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    from runbooks_tpu_torch.serve.api import load_model
    from runbooks_tpu_torch.serve.engine import InferenceEngine, Request
    from runbooks_tpu_torch.serve.paging import PagedInferenceEngine
    from runbooks_tpu_torch.utils.tree import tree_map

    cfg, params = load_model({
        "model": "debug", "seed": 3, "quantize": "int8",
        "model_overrides": {"head_dim": 64, "dtype": "float32",
                            "attention_impl": "xla"}}, device="cpu")
    prompts = [list(range(1, 60)), [5, 6, 7] * 20, [9, 4]]
    outs = {}
    for dev in ("cpu", "cuda"):
        p = tree_map(lambda t: t.to(dev), params)
        for cls in (InferenceEngine, PagedInferenceEngine):
            eng = cls(cfg, p, max_slots=4, max_seq_len=256)
            assert eng.cache.quantized
            reqs = [Request(prompt_tokens=x, max_tokens=24)
                    for x in prompts]
            with torch.no_grad():
                eng.generate(reqs)
            outs[dev, cls.__name__] = [r.output_tokens for r in reqs]
    assert len(set(map(str, outs.values()))) == 1, outs


@pytest.mark.cuda
def test_prefetched_pinned_batches_reach_the_card():
    """The trainer's input path on the card: the Prefetcher's thread puts
    each batch in pinned host memory, and the copy to the device made
    without blocking gives the same tensors, in order."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    from runbooks_tpu_torch.train import data

    want = data.synthetic_batches(1000, 2048, 8, seed=4)
    with data.Prefetcher(data.synthetic_batches(1000, 2048, 8, seed=4),
                         depth=2, place=data.pinned_placer(True)) as it:
        for _ in range(5):
            batch = next(it)
            assert all(t.is_pinned() for t in batch.values())
            dev = {k: v.to("cuda", non_blocking=True)
                   for k, v in batch.items()}
            ref = next(want)
            torch.cuda.synchronize()
            for k in ref:
                assert torch.equal(dev[k].cpu(), torch.from_numpy(ref[k]))


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["falcon-7b", "falcon-40b", "opt-125m",
                                  "gpt2", "gemma-2b"])
def test_family_engines_match_cpu_port_on_card(name):
    """The non-Llama families cut to 2 layers of 256 (4 query heads of 64;
    falcon-7b's one kv head, falcon-40b's two with split norms, gemma-2b's
    one with the scaled embedding) in f32 with the plain attention: the
    dense and paged engines on the card give the CPU port's greedy ids,
    learned positions clamped past their 64-row table at the trash
    slot."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    from runbooks_tpu_torch.serve.api import load_model
    from runbooks_tpu_torch.serve.engine import InferenceEngine, Request
    from runbooks_tpu_torch.serve.paging import PagedInferenceEngine
    from runbooks_tpu_torch.utils.tree import tree_map

    kvh = {"falcon-7b": 1, "falcon-40b": 2, "gemma-2b": 1}.get(name, 4)
    cfg, params = load_model({
        "model": name, "seed": 5,
        "model_overrides": {"num_layers": 2, "hidden_size": 256,
                            "intermediate_size": 512, "num_heads": 4,
                            "num_kv_heads": kvh, "head_dim": 64,
                            "vocab_size": 512, "max_seq_len": 64,
                            "dtype": "float32", "attention_impl": "xla"}},
        device="cpu")
    prompts = [list(range(1, 50)), [5, 6, 7] * 5, [9, 4]]
    outs = {}
    for dev in ("cpu", "cuda"):
        p = tree_map(lambda t: t.to(dev), params)
        for cls in (InferenceEngine, PagedInferenceEngine):
            eng = cls(cfg, p, max_slots=4, max_seq_len=64)
            reqs = [Request(prompt_tokens=x, max_tokens=24)
                    for x in prompts]
            with torch.no_grad():
                eng.generate(reqs)
            outs[dev, cls.__name__] = [r.output_tokens for r in reqs]
    assert len(set(map(str, outs.values()))) == 1, outs


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("b,s", [(8, 128), (8, 1)])
def test_moe_block_equals_dense_formulation_on_card(dtype, b, s):
    """models/moe.py on the card (TF32 off, as chip_smoke.py sets it), 8
    experts of top 2 at capacity factor 1.25, a burst bucket and a decode
    step: moe_block's kept set and slots equal the one-hot formulation's,
    its output equals moe_block_dense's bit for bit (both sum the combine
    in f64), and its routing equals the CPU port's on the same inputs."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    from runbooks_tpu_torch.models import moe
    from runbooks_tpu_torch.models.config import get_config

    cfg = get_config("debug", hidden_size=256, intermediate_size=512,
                     moe_num_experts=8, moe_top_k=2, dtype=dtype)
    E, h, m = 8, 256, 512
    tf32 = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        g = torch.Generator().manual_seed(b * s)
        p = {"router": torch.randn((h, E), generator=g) * h ** -0.5,
             "wi_gate": torch.randn((E, h, m), generator=g) * h ** -0.5,
             "wi_up": torch.randn((E, h, m), generator=g) * h ** -0.5,
             "wo": torch.randn((E, m, h), generator=g) * m ** -0.5}
        x = torch.randn((b, s, h), generator=g).to(cfg.activation_dtype)
        cp = {k: v.cuda() for k, v in p.items()}
        cx = x.cuda()
        probs = moe.router_probs(cp, cx.reshape(b * s, h))
        r = moe.route(cfg, probs)
        dispatch, _, _ = moe.dispatch_combine_dense(cfg, probs)
        assert torch.equal(moe.routing_dispatch(r, b * s, E), dispatch)
        cpu = moe.route(cfg, moe.router_probs(p, x.reshape(b * s, h)))
        assert torch.equal(r.keep.cpu(), cpu.keep)
        assert torch.equal(r.slot.cpu(), cpu.slot)
        got, aux = moe.moe_block(cfg, cp, cx)
        want, want_aux = moe.moe_block_dense(cfg, cp, cx)
        assert torch.equal(got, want)
        assert float(aux) == float(want_aux)
    finally:
        torch.backends.cuda.matmul.allow_tf32 = tf32


# moe_block's gradients against moe_block_dense's on the card, each leaf
# within this share of its largest magnitude: f32 sums the same products
# in another order; in bf16 both round the same f32 sums to bf16, except
# where x's two paths (router and experts) meet.
MOE_GRAD_RTOL = {"float32": 1e-5, "bfloat16": 2.0 ** -7}


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_moe_block_backward_equals_dense_formulation_on_card(dtype):
    """The training microbatch's shape at debug width (2 x 512 tokens, 8
    experts of top 2, capacity factor 1.25, so assignments drop): the
    gradients of out . cot + aux for x, the router, wi_gate, wi_up and wo
    from moe_block equal moe_block_dense's within MOE_GRAD_RTOL, reach
    every leaf, and are the same bits when the backward runs twice (no
    atomic adds)."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    from runbooks_tpu_torch.models import moe
    from runbooks_tpu_torch.models.config import get_config

    cfg = get_config("debug", hidden_size=256, intermediate_size=512,
                     moe_num_experts=8, moe_top_k=2, dtype=dtype)
    E, h, m, b, s = 8, 256, 512, 2, 512
    tf32 = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        g = torch.Generator(device="cuda").manual_seed(7)

        def normal(shape, fan_in):
            return torch.randn(shape, generator=g, device="cuda") \
                * fan_in ** -0.5

        p = {"router": normal((h, E), 1), "wi_gate": normal((E, h, m), h),
             "wi_up": normal((E, h, m), h), "wo": normal((E, m, h), m)}
        x = (normal((b, s, h), 1) + normal((h,), 1)).to(
            cfg.activation_dtype)
        cot = normal((b, s, h), 1).to(cfg.activation_dtype)

        def grads(block):
            leaves = {k: v.clone().requires_grad_() for k, v in p.items()}
            xx = x.clone().requires_grad_()
            out, aux = block(cfg, leaves, xx)
            loss = (out.float() * cot.float()).sum() + aux
            return torch.autograd.grad(loss, [xx] + list(leaves.values()))

        r = moe.route(cfg, moe.router_probs(p, x.reshape(b * s, h)))
        assert 0 < int(r.keep.sum()) < r.keep.numel()
        got, again, want = (grads(moe.moe_block), grads(moe.moe_block),
                            grads(moe.moe_block_dense))
        for name, a, a2, w in zip(["x"] + list(p), got, again, want):
            assert torch.equal(a, a2), name
            scale = w.float().abs().max().item()
            assert scale > 0, name
            err = (a.float() - w.float()).abs().max().item()
            assert err <= MOE_GRAD_RTOL[dtype] * scale, (name, err, scale)
    finally:
        torch.backends.cuda.matmul.allow_tf32 = tf32
