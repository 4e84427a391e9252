#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py [--seed N]

Phases, each of which fails the run (nonzero exit) when it fails:

1. Environment: the card's name and power limit, torch version, device
   count; TF32 is switched off for matmuls and convolutions.
2. Build: every kernel of the serving path from csrc/, in parallel.
3. Kernels: each kernel against its plain PyTorch version on the card at
   the shapes the serving path gives it, with its time (CUDA events over
   warm launches), the plain version's time, one PyTorch library call on
   the same problem as a yardstick (timed here, never called by the port)
   and its roofline bound on an H100 (989 TFLOP/s bf16, 3.35 TB/s).
4. End to end: llama3-8b at full width and depth in bfloat16 with seeded
   random weights; prefill logits through the flash kernel against the
   plain attention; then the dense InferenceEngine serves 8 requests whose
   prompts span the prefill buckets, greedy and sampled mixed, with the
   kernel launch counts read around that run.

The last two lines of standard output are the kernels' JSON record and
{"ok": true, "device": {...}}. Without a CUDA device, or without the
runbooks_tpu_torch package beside it, the script exits nonzero and prints
no result.
"""

import argparse
import dataclasses
import json
import subprocess
import sys
import time

KERNELS = ["flash_fwd"]
# Prefill logits through the kernel vs the plain attention, full width,
# 32 bf16 layers: bf16 keeps 8 bits, and ~10 roundings per layer that
# differ between the two attentions random-walk to ~3.5% of a unit-scale
# logit; the max over 128256 logits is ~4.5 sigma of that.
LOGIT_TOL = 0.25
# Kernel out vs its f32 plain version: |err| <= ATOL + RTOL * |plain|. The
# kernel rounds out to bf16 (one ulp is 2**-7 relative) and feeds P to the
# value product in bf16, so a 1-ulp difference must pass at any magnitude.
KERNEL_OUT_ATOL = 1e-2
KERNEL_OUT_RTOL = 1e-2
KERNEL_LSE_TOL = 1e-3    # lse stays f32 end to end
PROMPT_LENS = (20, 90, 120, 300, 700, 1000, 1500, 2000)
MAX_TOKENS = 32


def card_line():
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def cuda_ms(fn, iters):
    import torch

    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def kernel_cases(torch, dev, gen):
    """(name, q, k, v, q_pos, kv_pos, q_seg, kv_seg, block_skip, used) at
    the serving path's shapes: GQA 32/8, d=128, kv length cache_len=2049.
    used [b, sq] marks the query rows whose output the path keeps (None:
    all of them)."""

    def randn(*shape):
        return torch.randn(shape, generator=gen, device=dev,
                           dtype=torch.bfloat16)

    def ar(n, start=0):
        return start + torch.arange(n, device=dev, dtype=torch.int32)

    cases = []
    sk = 2049
    kv_pos = ar(sk)[None]
    # A 2048-token prompt alone: positions from 0.
    cases.append(("rows1_sq2048", randn(1, 2048, 32, 128),
                  randn(1, sk, 8, 128), randn(1, sk, 8, 128),
                  ar(2048)[None].contiguous(), kv_pos.contiguous(),
                  None, None, False, None))
    # An 8-row burst of 128-token buckets: rows 0-1 real (90 and 120
    # tokens), the rest of each row and rows 2-7 padding at position 2048.
    pos = torch.full((8, 128), 2048, device=dev, dtype=torch.int32)
    pos[0, :90] = ar(90)
    pos[1, :120] = ar(120)
    # The engine keeps only the real rows' outputs.
    cases.append(("rows8_sq128", randn(8, 128, 32, 128),
                  randn(8, sk, 8, 128), randn(8, sk, 8, 128), pos,
                  kv_pos.expand(8, sk).contiguous(), None, None, False,
                  pos < 2048))
    # A 16-token bucket whose queries start mid-cache at position 100.
    cases.append(("rows1_sq16_at100", randn(1, 16, 32, 128),
                  randn(1, sk, 8, 128), randn(1, sk, 8, 128),
                  ar(16, 100)[None].contiguous(), kv_pos.contiguous(),
                  None, None, False, None))
    # MHA (n_rep 1) at head_dim 64, causal with block skip (sq == sk).
    s = 512
    p2 = ar(s)[None].expand(2, s).contiguous()
    cases.append(("mha_d64_skip", randn(2, s, 16, 64), randn(2, s, 16, 64),
                  randn(2, s, 16, 64), p2, p2, None, None, True, None))
    # Packed segments with a padding tail: fully masked rows.
    seg = torch.ones((2, s), device=dev, dtype=torch.int32)
    seg[:, 200:400] = 2
    seg[:, 400:] = 0
    pseg = torch.cat([ar(200), ar(200), ar(112)])[None].expand(
        2, s).contiguous()
    cases.append(("segments_masked_rows", randn(2, s, 32, 128),
                  randn(2, s, 8, 128), randn(2, s, 8, 128), pseg, pseg,
                  seg, seg, True, None))
    return cases


def attention_bound(torch, q, k, q_pos, kv_pos, q_seg, kv_seg, used=None):
    """(bound_ms, bound_by, needed_flops, done_flops) on an H100 for the
    query rows in used (all rows when None): the operations they need
    (only the query-key pairs the mask leaves open) against the bytes the
    function must move for them (their queries, outputs and lse, and the
    keys and values some of them attend, each once). done_flops is what
    the launch computes over every row and every key."""
    from runbooks_tpu_torch.ops.attention import make_attention_mask
    from runbooks_tpu_torch.utils.hw import H100_HBM_BW, H100_PEAK_BF16_FLOPS

    b, sq, h, d = q.shape
    kvh = k.shape[2]
    if used is None:
        used = torch.ones((b, sq), dtype=torch.bool, device=q.device)
    mask = make_attention_mask(q_pos, kv_pos, q_seg, kv_seg)[:, 0]
    mask &= (kv_pos < 2 ** 30)[:, None, :]
    mask &= used[:, :, None]
    pairs = int(mask.sum().item())
    rows = int(used.sum().item())
    keys = int(mask.any(dim=1).sum().item())
    needed = 4.0 * d * h * pairs
    done = 4.0 * d * h * b * sq * k.shape[1]
    nbytes = 2 * rows * h * d * 2 + rows * h * 4     # q and out bf16, lse
    nbytes += 2 * keys * kvh * d * 2                  # k and v bf16
    nbytes += 4 * (rows + keys)                       # positions
    if q_seg is not None:
        nbytes += 4 * (rows + keys)
    t_ops = needed / H100_PEAK_BF16_FLOPS
    t_bytes = nbytes / H100_HBM_BW
    bound_by = "operations" if t_ops >= t_bytes else "bytes"
    return max(t_ops, t_bytes) * 1e3, bound_by, needed, done


def library_attention(torch, q, k, v, q_pos, kv_pos, q_seg, kv_seg):
    """One scaled_dot_product_attention call on the same masked problem
    (K/V repeated to the query heads and the mask built beforehand)."""
    import torch.nn.functional as F

    from runbooks_tpu_torch.ops.attention import make_attention_mask

    n_rep = q.shape[2] // k.shape[2]
    qt = q.transpose(1, 2).contiguous()
    kt = k.repeat_interleave(n_rep, dim=2).transpose(1, 2).contiguous()
    vt = v.repeat_interleave(n_rep, dim=2).transpose(1, 2).contiguous()
    mask = make_attention_mask(q_pos, kv_pos, q_seg, kv_seg)
    mask &= (kv_pos < 2 ** 30)[:, None, None, :]
    return lambda: F.scaled_dot_product_attention(qt, kt, vt,
                                                  attn_mask=mask)


def kernel_phase(torch, dev, seed):
    from runbooks_tpu_torch.ops.flash_attention import (
        NEG_INF,
        flash_attention_fwd,
        flash_attention_reference,
    )

    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)
    records = {}
    worst = 0.0
    for (name, q, k, v, qp, kp, qs, ks, skip, used) in kernel_cases(
            torch, dev, gen):
        out, lse = flash_attention_fwd(q, k, v, qp, kp, qs, ks,
                                       block_skip=skip)
        ref, ref_lse = flash_attention_reference(q, k, v, qp, kp, qs, ks,
                                                 block_skip=skip)
        torch.cuda.synchronize()
        diff = (out.float() - ref.float()).abs()
        err = diff.max().item()
        excess = (diff - KERNEL_OUT_RTOL * ref.float().abs()).max().item()
        lse_err = (lse - ref_lse).abs().max().item()
        finite = bool(torch.isfinite(out.float()).all().item())
        if qs is not None:
            masked = (qs == 0)
            exact = (bool((out.float()[masked] == 0).all().item())
                     and bool((lse.transpose(1, 2)[masked]
                               == NEG_INF).all().item()))
        else:
            exact = True
        ms = cuda_ms(lambda: flash_attention_fwd(q, k, v, qp, kp, qs, ks,
                                                 block_skip=skip), 20)
        plain_ms = cuda_ms(lambda: flash_attention_reference(
            q, k, v, qp, kp, qs, ks, block_skip=skip), 3)
        library_ms = cuda_ms(library_attention(torch, q, k, v, qp, kp, qs,
                                               ks), 10)
        bound_ms, bound_by, needed, done = attention_bound(
            torch, q, k, qp, kp, qs, ks, used)
        # The same over every row, padding included: what the launch is
        # asked to compute.
        padded_ms, padded_by, padded_needed, _ = attention_bound(
            torch, q, k, qp, kp, qs, ks)
        ok = (excess <= KERNEL_OUT_ATOL and lse_err <= KERNEL_LSE_TOL
              and finite and exact)
        print(f"kernel flash_fwd {name}: q {tuple(q.shape)} k "
              f"{tuple(k.shape)} out_err {err:.3e} (tol {KERNEL_OUT_ATOL} + "
              f"{KERNEL_OUT_RTOL}*|plain|) "
              f"lse_err {lse_err:.3e} (tol {KERNEL_LSE_TOL}) finite "
              f"{finite} masked_rows_exact {exact} | ms {ms:.4f} plain_ms "
              f"{plain_ms:.4f} library_ms {library_ms:.4f} bound_ms "
              f"{bound_ms:.4f} ({bound_by}) needed_gflop {needed / 1e9:.3f} "
              f"| with padding rows: bound_ms {padded_ms:.4f} ({padded_by}) "
              f"needed_gflop {padded_needed / 1e9:.2f} | done_gflop "
              f"{done / 1e9:.2f} -> {'ok' if ok else 'FAIL'}",
              flush=True)
        if not ok:
            raise SystemExit(f"flash_fwd {name} disagrees with its plain "
                             "version")
        worst = max(worst, err)
        records[name] = dict(ms=ms, plain_ms=plain_ms, library_ms=library_ms,
                             bound_ms=bound_ms, bound_by=bound_by,
                             bound_ms_with_padding=padded_ms,
                             shape=f"q{tuple(q.shape)} k{tuple(k.shape)}")
    return records, worst


def smoke_prompts(seed):
    """The serving mix's prompts: seeded word text through ByteTokenizer,
    cut to PROMPT_LENS tokens (buckets 32 to 2048; the 90- and 120-token
    prompts share the 128 bucket and prefill as one 8-row burst)."""
    import numpy as np

    from runbooks_tpu_torch.train.data import ByteTokenizer

    rng = np.random.default_rng(seed)
    tok = ByteTokenizer()
    words = ["tpu", "kernel", "serve", "token", "cache", "prefill", "decode",
             "hopper", "warp", "tile", "batch", "slot", "queue", "model"]
    prompts = []
    for n in PROMPT_LENS:
        text = " ".join(rng.choice(words, size=n))
        prompts.append(tok.encode(text, add_bos=True, add_eos=False)[:n])
    return prompts


def smoke_requests(prompts, first_token_times):
    """One request per prompt, greedy and sampled (temperature 0.8, top_p
    0.9) alternating, MAX_TOKENS each; each request's first token time
    (perf_counter) lands in first_token_times[i]."""
    from runbooks_tpu_torch.serve.engine import Request

    reqs = []
    for i, p in enumerate(prompts):
        sampled = i % 2 == 1
        reqs.append(Request(
            prompt_tokens=p, max_tokens=MAX_TOKENS,
            temperature=0.8 if sampled else 0.0,
            top_p=0.9 if sampled else 1.0, request_id=f"r{i}",
            on_token=(lambda t, i=i: first_token_times.setdefault(
                i, time.perf_counter()))))
    return reqs


def gap_check(name, got_logits, plain_logits):
    """Max |difference| within LOGIT_TOL, and equal argmax or a plain
    top-two gap below LOGIT_TOL (a near-tie that bf16 may flip)."""
    diff = (got_logits - plain_logits).abs().max().item()
    a, b = int(got_logits.argmax()), int(plain_logits.argmax())
    top2 = plain_logits.topk(2).values
    gap = (top2[0] - top2[1]).item()
    ok = diff <= LOGIT_TOL and (a == b or gap < LOGIT_TOL)
    print(f"{name}: max |logit diff| {diff:.4f} (tol {LOGIT_TOL}) argmax "
          f"{a} vs {b} top-two gap {gap:.4f} -> {'ok' if ok else 'FAIL'}",
          flush=True)
    if not ok:
        raise SystemExit(f"{name}: the flash path disagrees with the plain "
                         "attention")


def prefill_logits(torch, cfg, params, prompt, bucket, max_seq_len):
    """Last-position logits of one prompt prefilled as the engine does:
    a [1, bucket] row, padding at the trash slot, scratch cache of
    max_seq_len + 1 positions."""
    from runbooks_tpu_torch.models.transformer import (
        KVCache,
        forward,
        lm_head,
    )

    dev = params["embed"].device
    m = len(prompt)
    tokens = torch.zeros((1, bucket), dtype=torch.int32, device=dev)
    tokens[0, :m] = torch.tensor(prompt, dtype=torch.int32, device=dev)
    pos = torch.full((1, bucket), max_seq_len, dtype=torch.int32,
                     device=dev)
    pos[0, :m] = torch.arange(m, dtype=torch.int32, device=dev)
    cache = KVCache.create(cfg, 1, max_seq_len, dev, trash_slot=True)
    x, _ = forward(cfg, params, tokens, positions=pos, cache=cache,
                   return_activations=True)
    return lm_head(cfg, params, x[:, m - 1])[0]


def e2e_phase(torch, seed):
    from runbooks_tpu_torch.ops.flash_attention import flash_attention
    from runbooks_tpu_torch.serve.api import load_model
    from runbooks_tpu_torch.serve.engine import InferenceEngine

    t0 = time.perf_counter()
    cfg, params = load_model({"model": "llama3-8b",
                              "model_overrides": {"param_dtype": "bfloat16"},
                              "seed": seed})
    torch.cuda.synchronize()
    n_params = sum(t.numel() for t in _leaves(params))
    print(f"load_model llama3-8b bf16: {n_params / 1e9:.3f} B params, "
          f"layers {cfg.num_layers}, hidden {cfg.hidden_size}, heads "
          f"{cfg.num_heads}/{cfg.num_kv_heads}, in "
          f"{time.perf_counter() - t0:.2f} s", flush=True)
    max_seq_len = 2048
    plain_cfg = dataclasses.replace(cfg, attention_impl="xla")

    prompts = smoke_prompts(seed)

    # Full-width check: one prompt's prefill logits through the kernel
    # against the plain attention.
    with torch.no_grad():
        flash = prefill_logits(torch, cfg, params, prompts[3], 512,
                               max_seq_len)
        plain = prefill_logits(torch, plain_cfg, params, prompts[3], 512,
                               max_seq_len)
    gap_check("prefill logits, 300-token prompt, flash vs plain", flash,
              plain)

    engine = InferenceEngine(cfg, params, max_slots=8,
                             max_seq_len=max_seq_len, seed=seed)
    first_t = {}
    reqs = smoke_requests(prompts, first_t)

    torch.cuda.reset_peak_memory_stats()
    flash_attention.launches = 0
    dispatches0 = engine.prefill_dispatches
    t_start = time.perf_counter()
    with torch.no_grad():
        engine.generate(reqs)
    wall = time.perf_counter() - t_start
    launches = flash_attention.launches
    dispatches = engine.prefill_dispatches - dispatches0

    for r in reqs:
        if not (r.finished and len(r.output_tokens) == MAX_TOKENS
                and all(0 <= t < cfg.vocab_size for t in r.output_tokens)):
            raise SystemExit(f"request {r.request_id} did not finish with "
                             f"{MAX_TOKENS} tokens: {r.finish_reason} "
                             f"{len(r.output_tokens)}")
    if launches < cfg.num_layers * dispatches:
        raise SystemExit(f"flash_fwd launched {launches} times over "
                         f"{dispatches} prefill dispatches; expected >= "
                         f"{cfg.num_layers} per dispatch")
    # The first greedy token of the short greedy prompts against the plain
    # attention's prefill.
    with torch.no_grad():
        for i in (0, 2):
            plain = prefill_logits(torch, plain_cfg, params, prompts[i],
                                   128, max_seq_len)
            tok0 = reqs[i].output_tokens[0]
            top2 = plain.topk(2).values
            agree = tok0 == int(plain.argmax()) or (
                (top2[0] - top2[1]).item() < LOGIT_TOL
                and (top2[0] - plain[tok0]).item() < LOGIT_TOL)
            print(f"request r{i} first greedy token {tok0} vs plain argmax "
                  f"{int(plain.argmax())} -> {'ok' if agree else 'FAIL'}",
                  flush=True)
            if not agree:
                raise SystemExit(f"request r{i}: first token disagrees")

    ttft = sorted(first_t[i] - t_start for i in range(len(reqs)))
    prompt_tokens = sum(len(p) for p in prompts)
    decode_tokens = len(reqs) * (MAX_TOKENS - 1)
    stats = {
        "requests": len(reqs),
        "prompt_tokens": prompt_tokens,
        "generated_tokens": len(reqs) * MAX_TOKENS,
        "prefill_dispatches": dispatches,
        "flash_fwd_launches": launches,
        "wall_s": wall,
        "ttft_s_median": ttft[len(ttft) // 2],
        "ttft_s_max": ttft[-1],
        "prefill_s": engine.dispatch_seconds["prefill"],
        "prefill_tokens_per_s": (prompt_tokens
                                 / engine.dispatch_seconds["prefill"]),
        "decode_s": engine.dispatch_seconds["decode"],
        "decode_tokens_per_s": (decode_tokens
                                / engine.dispatch_seconds["decode"]),
        "decode_steps": engine.steps,
        "max_memory_allocated_gb": torch.cuda.max_memory_allocated() / 1e9,
    }
    print("serve " + json.dumps(stats), flush=True)
    for r in reqs:
        print(f"  {r.request_id}: prompt {len(r.prompt_tokens)} "
              f"temp {r.temperature} -> {r.output_tokens[:8]}...",
              flush=True)
    return launches


def _leaves(tree):
    if isinstance(tree, dict):
        for v in tree.values():
            yield from _leaves(v)
    else:
        yield tree


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args()

    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    from runbooks_tpu_torch.utils import cuda_build

    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    card = card_line()
    print(f"card: {card} | torch {torch.__version__} cuda "
          f"{torch.version.cuda} | devices {torch.cuda.device_count()} | "
          f"allow_tf32 matmul={torch.backends.cuda.matmul.allow_tf32} "
          f"cudnn={torch.backends.cudnn.allow_tf32}", flush=True)

    t0 = time.perf_counter()
    cuda_build.build(KERNELS)
    print(f"built {KERNELS} for sm_90a in {time.perf_counter() - t0:.1f} s",
          flush=True)
    for name in KERNELS:
        for line in cuda_build.build_report(name).splitlines():
            if "registers" in line or "spill" in line:
                print(f"  ptxas {name}: {line.strip()}", flush=True)

    records, worst = kernel_phase(torch, dev, args.seed)
    launches = e2e_phase(torch, args.seed)

    main_case = records["rows8_sq128"]
    kernels = [{
        "name": "flash_fwd",
        "route": "cuda",
        "source": "runbooks_tpu_torch/csrc/flash_fwd.cu",
        "replaces": "runbooks_tpu/ops/flash_attention.py:92",
        "launches": launches,
        "max_abs_err": worst,
        "ms": main_case["ms"],
        "plain_ms": main_case["plain_ms"],
        "bound_ms": main_case["bound_ms"],
        "bound_by": main_case["bound_by"],
        "library_ms": main_case["library_ms"],
        "bound_ms_with_padding": main_case["bound_ms_with_padding"],
        "shape": main_case["shape"],
    }]
    print(card_line(), flush=True)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
