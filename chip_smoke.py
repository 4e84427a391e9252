#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py [--seed N]

Phases, each of which fails the run (nonzero exit) when it fails:

1. Environment: the card's name and power limit, torch version, device
   count; TF32 is switched off for matmuls and convolutions.
2. Build: every kernel of the serving and training paths from csrc/, in
   parallel.
3. Forward kernel: K1 against its plain PyTorch version on the card at
   the shapes the serving path gives it (the suffix prefill after a
   shared prefix among them), at head_dim 64, with packed
   segments (padding rows, boundaries inside tiles) and at the training
   path's shapes (a microbatch of the job's packed rows, and the same
   shape causal without segments), with its time (CUDA events over warm
   launches), the plain version's time, one PyTorch library call on the
   same problem as a yardstick (timed here, never called by the port; at
   the training shape also SDPA's causal forward), its roofline bound on
   an H100 (989 TFLOP/s bf16, 3.35 TB/s) and its rate on the operations
   the masks need. The kv tiles the kernel counts as computed must be the
   ones fwd_tile_plan, its skip rules' plain twin, predicts.
4. End to end: llama3-8b at full width and depth in bfloat16 with seeded
   random weights; prefill logits through the flash kernel against the
   plain attention; then the dense InferenceEngine serves 8 requests whose
   prompts span the prefill buckets, greedy and sampled mixed, with the
   kernel launch counts read around that run.
5. Backward kernels: K2 (dq) and K3 (dk, dv) against their plain version
   at the training shape (2 packed rows of 2048 tokens of the job's data,
   32/8 heads, d=128), without segments, a ragged 2000, d=64 with n_rep 2,
   more keys than queries (unseen keys must get exactly 0) and f32
   gradients; each kernel's time, bound, rate on the operations the masks
   need, the plain version's time and the backward of
   scaled_dot_product_attention as the yardstick. The (q tile, kv tile)
   pairs each kernel counts as computed and open on the card must be the
   ones fwd_tile_plan predicts at the backward's tiles.
6. Full-width gradient check: llama3-8b cut to 4 layers, one LoRA
   loss-and-grad over a packed 2048-token row with the flash kernels and
   with the plain attention.
7. Training: ``run_training`` runs the repo's LoRA example on llama3-8b
   at full width and depth (f32 base, rank 16, seq 2048, batch 8 in 4
   microbatches, packed seeded documents) for 3 steps, with K1/K2/K3
   launch counts read around it, then resumes from the step-3 checkpoint
   for one more step.
8. Serving the fine-tune over HTTP: (a) ``load_model`` with ``adapter:``
   pointing at phase 7's artifacts folds the adapter into the seeded f32
   base at full width and depth; sampled slices must equal base + (alpha /
   rank) A B. (b) ``create_server`` serves the merged model (warmup
   included in its readiness time) and takes phase 4's 8 prompts at once
   from client threads: greedy and sampled, one stream, one chat, one
   multi-prompt body, with K1's launches read around the mix. The greedy
   requests, sent again as one body to the idle server, must give the
   token ids and text of ``InferenceEngine.generate`` on the same params
   (the concurrent mix's greedy answers too, or differ first at a
   near-tie). (c) ``python -m runbooks_tpu_torch.serve.api`` restores a
   bf16 checkpoint of llama3-8b cut to 2 layers from the contract's model
   mount, answers one greedy completion exactly as this process decodes
   the saved params, and exits 0 on SIGTERM within its drain timeout.
9. Import: an HF llama3-8b directory at full width cut to 2 layers, BF16,
   in two safetensors shards with their index (written here from the
   seed), goes through ``python -m runbooks_tpu_torch.models.loader``;
   its model.json, every restored leaf against the source transposed and
   cast (bit for bit), and the greedy ids of the restored params against
   params converted in memory, with the import's time, its end-to-end
   and convert rates, checkpoint size, and the loader's spans (read,
   convert, save) with its resident and peak host memory after each.
10. Shared prefix: phase 4's engine (llama3-8b bf16, full width and
   depth) behind ``create_server(warm_prefix=True)`` takes 8 prompts
   that extend a 1024-token system prompt as one greedy body, with no
   prefix registered and again after ``POST /v1/prefix``: every prompt
   reuses 1024 tokens, K1's kv tiles on the card equal fwd_tile_plan's
   for every dispatch, the first-token logits of the engine's own
   prefill dispatches (recorded at each real row, with and without the
   prefix) are within LOGIT_TOL of a full prefill's, and the greedy ids with
   and without the prefix agree up to near-ties; TTFT, prefill seconds,
   K1's launches and peak memory with and without the prefix.
11. Speculation and grammar: llama3-8b bf16 at full width and depth,
   ``InferenceEngine(max_slots=8, max_seq_len=2048)``, each engine warmed
   up. (a) 8 greedy prompts of 200-1500 tokens that repeat seeded spans,
   128 new tokens each, with speculation off and with ``"ngram"``
   (draft_tokens 4): greedy ids equal up to near-ties; drafted, accepted,
   accept rate, verify steps, decode tokens/s both ways, median host ms
   per verify dispatch and per decode step, K1's launches. (b) The same
   engine with an oracle draft source (run (a)'s ids without speculation,
   one slot wrong from its 10th token): ids equal to (a)'s up to
   near-ties, the accept rate and decode tokens/s of near-perfect drafts.
   (c) ``speculative_verify`` at vocab 128256 on fixed synthetic logits,
   20,000 rows at temperature 0.8 with top_p 0.9 and with top_p 1.0: the
   accept frequency within 4 sigma of pi(draft), the emitted tokens'
   histogram within 4 sigma of ``sample``'s own, greedy rows equal to the
   argmax. (d) ``grammar="on"``: 8 requests with response_formats (4
   bounded objects of enum, const and boolean; 4 unbounded), half greedy,
   half at temperature 0.7, 256 tokens at most, with speculation off and
   on: bounded ones finish grammar_complete with JSON whose keys and types
   are checked, unbounded ones likewise or end with every token legal;
   greedy ids equal up to near-ties among the allowed tokens; DFA compile
   seconds at vocab 128256, host mask build ms per dispatch, constrained
   tokens/s both ways. (e) ``create_server(speculative="ngram",
   grammar="on")``: a chat completion with a response_format answers 200
   and grammar_complete, an unsupported construct 400 naming it.
12. Paged serving: llama3-8b bf16 at full width and depth,
   ``max_slots=8``, ``max_seq_len=2048``, pages of 16, every engine warmed
   up. (a) Phase 4's 8 requests through the dense engine and the
   ``PagedInferenceEngine`` (1024 pages), both resident, run dense,
   paged, paged, dense: greedy ids equal up to near-ties, K1's launches
   equal, decode tokens/s and decode step times both ways, and the
   device ms of the decode view's gather (8 slots x 2049) and of one
   chunk's write-backs against their HBM bounds. (b) Phase 10's prefix
   and 8 prompts with no registration: on an empty tree, and after one
   request of the prefix alone finished and seeded it (8 x 64 pages
   reused); K1's kv tiles on the card equal fwd_tile_plan's for every
   dispatch, the engine's first-token logits within LOGIT_TOL of a full
   prefill, TTFT both ways. (c) 256 device pages and a 256-page pinned
   host tier: a 1024-token session finishes, two 2000-token requests
   evict its pages to the host (>= 64 swapped out), and its next turn
   swaps them back in (>= 64); per-page swap ms each way and GB/s
   against PCIe Gen5 x16, one page's round trip bit-identical, the
   turn's TTFT and greedy ids against the same engine with no host tier
   (which recomputes). (d) ``preemption="swap"``, 512 pages: 8 batch
   requests of 256 new tokens fill the slots and 4 interactive ones
   arrive two steps later; preemptions >= 1, every one resumed, batch
   ids equal to the run with preemption off up to near-ties, finish
   reasons unchanged, interactive TTFT both ways. (e)
   ``create_server(kv_paging=True, kv_host_pages=256,
   preemption="swap")`` answers an ``X-Priority: interactive``
   completion.

The last two lines of standard output are the kernels' JSON record and
{"ok": true, "device": {...}}. Without a CUDA device, or without the
runbooks_tpu_torch package beside it, the script exits nonzero and prints
no result.
"""

import argparse
import dataclasses
import gc
import json
import math
import os
import re
import signal
import socket
import struct
import subprocess
import sys
import tempfile
import threading
import time
import urllib.error
import urllib.request

KERNELS = ["flash_fwd", "flash_bwd"]
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
# Backward kernels vs their f32 plain version, per gradient tensor:
# |err| <= BWD_ATOL * max|plain| + BWD_RTOL * |plain|. The kernels round p
# and ds to bf16 as operands of their products (2**-9 relative each) and
# the gradients to bf16 at the end (2**-8); sums over up to 2048 rounded
# terms random-walk to a few such roundings of the largest entry. On an
# H100 the worst max|err| / max|plain| over cases (a)-(f) was 0.0024.
BWD_ATOL = 1e-2
BWD_RTOL = 1e-2
# Full-width gradient check, flash (K1-K3) vs plain attention under
# autograd, 4 bf16 layers: the two attentions round at other places (the
# plain path rounds its f32 output and probabilities, the kernels P, dS
# and their outputs), each a 2**-8 relative error that the backward
# carries through 4 layers and the rank-16 projections. The loss, a mean
# over ~2000 tokens, averages them away. On an H100: loss 1.1e-5 relative,
# worst leaf 0.0042 in relative L2, cosine 0.99999.
GRAD_LOSS_RTOL = 1e-3
GRAD_REL_L2_TOL = 0.03
GRAD_COS_MIN = 0.99
# The training job: the repo's LoRA example (examples/llama2-7b/
# finetuned-model.yaml: rank 16, alpha 32, batch 8, seq 2048, lr 2e-5)
# applied to llama3-8b, global batch 8 in 4 microbatches of 2.
TRAIN_STEPS = 3
TRAIN_DOCS = 300
TRAIN_SEQ = 2048
# Phase 8: the adapter fold is checked on these (group, name, layer)
# slices of the base, in f32 against base + (alpha / rank) A B. Both sides
# sum the rank-16 product in f32 and round once to f32: at most one ulp of
# a unit-scale weight apart.
FOLD_SLICES = (("attn", "wq", 0), ("attn", "wk", 15), ("attn", "wv", 31),
               ("attn", "wo", 7))
FOLD_TOL = 1e-6
HTTP_TIMEOUT = 600
ENTRY_LAYERS = 2
ENTRY_DRAIN_S = 30.0
# Phase 9: the HF directory of llama3-8b is written at full width, cut to
# IMPORT_LAYERS layers so that it writes in seconds, in BF16 as every
# llama2/llama3 checkpoint ships.
IMPORT_LAYERS = 2
IMPORT_SHARDS = 2
IMPORT_TIMEOUT_S = 600
# Phase 10: one registered prefix of PREFIX_LEN tokens (a chat system
# prompt) and 8 requests that extend it by SUFFIX_LENS tokens.
PREFIX_LEN = 1024
SUFFIX_LENS = (16, 40, 90, 120, 200, 400, 700, 900)
# Phase 11: speculation (prompts of SPEC_LENS tokens, SPEC_NEW new tokens
# each; the oracle's wrong slot and the index its drafts go wrong from),
# the verify check's rows, and grammar's token budget.
SPEC_LENS = (200, 400, 600, 800, 1000, 1200, 1400, 1500)
SPEC_NEW = 128
ORACLE_WRONG_SLOT, ORACLE_WRONG_AT = 3, 10
VERIFY_ROWS = 20000
VERIFY_CHUNK = 1000
VERIFY_SIGMAS = 4
GRAMMAR_MAX = 256
# Phase 12: paged serving.
PAGE_SIZE = 16
HOST_PAGES = 256           # (c) device pool and host tier; (d), (e) host
OTHER_LEN = 2000           # (c) two such requests, the second admitted
OTHER_NEW = 48             # while the first runs, evict the session
PREEMPT_PAGES = 512
PREEMPT_NEW = 256
PREEMPT_BATCH_LEN = 200
PREEMPT_INTERACTIVE_LEN = 100
SWAP_TIMED_PAGES = 64
PCIE_GEN5_X16 = 64e9       # bytes/s in each direction


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


def fwd_case_layouts(torch, dev, batch):
    """(name, (b, sq, sk, h, kvh, d), q_pos, kv_pos, q_seg, kv_seg,
    block_skip, used) of the K1 cases: the serving path's prefill shapes
    (GQA 32/8, d=128, kv length cache_len=2049), head_dim 64, packed
    segments, and the training path's microbatch (batch: the job's first
    global batch). used [b, sq] marks the query rows whose output the path
    keeps (None: all of them)."""

    def ar(n, start=0, rows=1):
        return (start + torch.arange(n, device=dev, dtype=torch.int32)
                )[None].expand(rows, n).contiguous()

    def packed(doc_lens, s):
        """Segment ids 1, 2, ... per document, padding (0) to s, and
        positions restarting per document."""
        seg = torch.zeros(s, dtype=torch.int32, device=dev)
        pos = torch.zeros(s, dtype=torch.int32, device=dev)
        at = 0
        for i, n in enumerate(doc_lens):
            seg[at:at + n] = i + 1
            pos[at:at + n] = ar(n)[0]
            at += n
        pos[at:] = ar(s - at)[0]
        return seg, pos

    sk = 2049
    kv_pos = ar(sk)
    cases = []
    # A 2048-token prompt alone: positions from 0.
    cases.append(("rows1_sq2048", (1, 2048, sk, 32, 8, 128), ar(2048),
                  kv_pos, None, None, False, None))
    # An 8-row burst of 128-token buckets: rows 0-1 real (90 and 120
    # tokens), the rest of each row and rows 2-7 padding at position 2048.
    pos = torch.full((8, 128), 2048, device=dev, dtype=torch.int32)
    pos[0, :90] = ar(90)[0]
    pos[1, :120] = ar(120)[0]
    # The engine keeps only the real rows' outputs.
    cases.append(("rows8_sq128", (8, 128, sk, 32, 8, 128), pos,
                  kv_pos.expand(8, sk).contiguous(), None, None, False,
                  pos < 2048))
    # A 16-token bucket whose queries start mid-cache at position 100.
    cases.append(("rows1_sq16_at100", (1, 16, sk, 32, 8, 128), ar(16, 100),
                  kv_pos, None, None, False, None))
    # The suffix prefill after a 1024-token shared prefix: 8 rows of 128
    # suffix tokens at positions 1024-1151 over cache rows that hold the
    # prefix's K/V (phase 10).
    cases.append(("rows8_sq128_at1024", (8, 128, sk, 32, 8, 128),
                  ar(128, PREFIX_LEN, rows=8),
                  kv_pos.expand(8, sk).contiguous(), None, None, False,
                  None))
    # MHA (n_rep 1) at head_dim 64, causal with block skip (sq == sk).
    s = 512
    p2 = ar(s, rows=2)
    cases.append(("mha_d64_skip", (2, s, s, 16, 16, 64), p2, p2, None, None,
                  True, None))
    # Packed segments with a padding tail: fully masked rows.
    seg, pseg = packed((200, 200), s)
    seg, pseg = seg[None].expand(2, s).contiguous(), pseg[None].expand(
        2, s).contiguous()
    cases.append(("segments_masked_rows", (2, s, s, 32, 8, 128), pseg, pseg,
                  seg, seg, True, None))
    # Documents whose boundaries fall inside kv tiles and q tiles.
    s = 1024
    (s0, p0), (s1, p1) = packed((300, 150, 450), s), packed((77, 700, 200), s)
    seg, pseg = torch.stack([s0, s1]), torch.stack([p0, p1])
    cases.append(("segment_inside_tile", (2, s, s, 32, 8, 128), pseg, pseg,
                  seg, seg, True, None))
    # The training path: (a) one microbatch of the job's packed rows, (b)
    # the same shape causal without segments.
    s = TRAIN_SEQ
    pos = torch.from_numpy(batch["positions"][:2]).to(dev)
    seg = torch.from_numpy(batch["segment_ids"][:2]).to(dev)
    cases.append(("a_packed_2x2048", (2, s, s, 32, 8, 128), pos, pos, seg,
                  seg, True, None))
    cases.append(("b_causal_2x2048", (2, s, s, 32, 8, 128), ar(s, rows=2),
                  ar(s, rows=2), None, None, True, None))
    return cases


def kernel_cases(torch, dev, gen, batch):
    """fwd_case_layouts with seeded bf16 q, k, v, one case at a time:
    (name, q, k, v, q_pos, kv_pos, q_seg, kv_seg, block_skip, used)."""
    for (name, (b, sq, sk, h, kvh, d), qp, kp, qs, ks, skip,
         used) in fwd_case_layouts(torch, dev, batch):
        q, k, v = (torch.randn(shape, generator=gen, device=dev,
                               dtype=torch.bfloat16)
                   for shape in ((b, sq, h, d), (b, sk, kvh, d),
                                 (b, sk, kvh, d)))
        yield name, q, k, v, qp, kp, qs, ks, skip, used


def tile_counts(torch, q_pos, kv_pos, q_seg, kv_seg, block_skip,
                backward=False):
    """(computed, open, total) tiles of one launch over the batch rows for
    one head, as fwd_tile_plan predicts them: K1's kv tiles, or with
    backward the (q tile, kv tile) pairs of K2 and K3."""
    from runbooks_tpu_torch.ops.flash_attention import (
        BWD_BK,
        BWD_BQ,
        FWD_BK,
        FWD_BQ,
        TILE_CLOSED,
        TILE_OPEN,
        fwd_tile_plan,
    )

    bq, bk = (BWD_BQ, BWD_BK) if backward else (FWD_BQ, FWD_BK)
    plan = fwd_tile_plan(q_pos, kv_pos, q_seg, kv_seg, causal=True,
                         block_skip=block_skip, bq=bq, bk=bk)
    return (int((plan != TILE_CLOSED).sum().item()),
            int((plan == TILE_OPEN).sum().item()), plan.numel())


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


def kernel_phase(torch, dev, seed, batch):
    """Phase 3: K1 against its plain version at every case of
    fwd_case_layouts, with its time, the plain version's, SDPA's on the
    same masked problem (and SDPA's causal forward at the training shape),
    the bound and the achieved rate on the operations the masks need. The
    kv tiles the card computed (its own count, fwd_tile_counts) must be
    those fwd_tile_plan predicts, for every head."""
    from runbooks_tpu_torch.ops.flash_attention import (
        NEG_INF,
        flash_attention_fwd,
        flash_attention_reference,
        fwd_tile_counts,
    )

    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)
    records = {}
    worst = 0.0
    for (name, q, k, v, qp, kp, qs, ks, skip, used) in kernel_cases(
            torch, dev, gen, batch):
        fwd_tile_counts()
        out, lse = flash_attention_fwd(q, k, v, qp, kp, qs, ks,
                                       block_skip=skip)
        card_computed, card_opened = fwd_tile_counts()
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
        del out, lse, ref, ref_lse, diff
        large = q.shape[1] * k.shape[1] * q.shape[0] >= 2 ** 22
        ms = cuda_ms(lambda: flash_attention_fwd(q, k, v, qp, kp, qs, ks,
                                                 block_skip=skip), 20)
        plain_ms = cuda_ms(lambda: flash_attention_reference(
            q, k, v, qp, kp, qs, ks, block_skip=skip), 2 if large else 3)
        library_ms = cuda_ms(library_attention(torch, q, k, v, qp, kp, qs,
                                               ks), 10)
        library_causal_ms = None
        if name.startswith(("a_", "b_")):
            library_causal_ms = cuda_ms(library_fwd(torch, q, k, v), 10)
        bound_ms, bound_by, needed, done = attention_bound(
            torch, q, k, qp, kp, qs, ks, used)
        # The same over every row, padding included: what the launch is
        # asked to compute.
        padded_ms, padded_by, padded_needed, _ = attention_bound(
            torch, q, k, qp, kp, qs, ks)
        computed, opened, total = tile_counts(torch, qp, kp, qs, ks, skip)
        h = q.shape[2]
        tiles_agree = (card_computed, card_opened) == (h * computed,
                                                        h * opened)
        tflops = padded_needed / (ms * 1e-3) / 1e12
        ok = (excess <= KERNEL_OUT_ATOL and lse_err <= KERNEL_LSE_TOL
              and finite and exact and tiles_agree)
        print(f"kernel flash_fwd {name}: q {tuple(q.shape)} k "
              f"{tuple(k.shape)} skip {skip} out_err {err:.3e} (tol "
              f"{KERNEL_OUT_ATOL} + {KERNEL_OUT_RTOL}*|plain|) "
              f"lse_err {lse_err:.3e} (tol {KERNEL_LSE_TOL}) finite "
              f"{finite} masked_rows_exact {exact} | kv tiles per head "
              f"computed {computed}/{total} (open {opened}) predicted by "
              f"fwd_tile_plan, card over {h} heads computed "
              f"{card_computed} (open {card_opened}) agree {tiles_agree} | "
              f"ms {ms:.4f} plain_ms {plain_ms:.4f} library_ms "
              f"{library_ms:.4f}"
              + ("" if library_causal_ms is None else
                 f" library_causal_ms {library_causal_ms:.4f}")
              + f" bound_ms {bound_ms:.4f} ({bound_by}) needed_gflop "
              f"{needed / 1e9:.3f} | with padding rows: bound_ms "
              f"{padded_ms:.4f} ({padded_by}) needed_gflop "
              f"{padded_needed / 1e9:.2f} at {tflops:.1f} TFLOP/s | "
              f"dense_gflop {done / 1e9:.2f} -> {'ok' if ok else 'FAIL'}",
              flush=True)
        if not ok:
            raise SystemExit(f"flash_fwd {name} disagrees with its plain "
                             "version or with fwd_tile_plan")
        worst = max(worst, err)
        records[name] = dict(ms=ms, plain_ms=plain_ms, library_ms=library_ms,
                             library_causal_ms=library_causal_ms,
                             bound_ms=bound_ms, bound_by=bound_by,
                             bound_ms_with_padding=padded_ms,
                             shape=f"q{tuple(q.shape)} k{tuple(k.shape)}")
        del q, k, v
    return records, worst


def smoke_prompts(seed):
    """The serving mix's prompts: seeded word text through ByteTokenizer,
    cut to PROMPT_LENS tokens (buckets 32 to 2048; the 90- and 120-token
    prompts share the 128 bucket and prefill as one 8-row burst)."""
    return seeded_prompts(seed, PROMPT_LENS)


def seeded_prompts(seed, lens):
    """Seeded word text through ByteTokenizer (BOS first), one prompt of
    each length in lens."""
    import numpy as np

    from runbooks_tpu_torch.train.data import ByteTokenizer

    rng = np.random.default_rng(seed)
    tok = ByteTokenizer()
    words = ["tpu", "kernel", "serve", "token", "cache", "prefill", "decode",
             "hopper", "warp", "tile", "batch", "slot", "queue", "model"]
    prompts = []
    for n in lens:
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
    from runbooks_tpu_torch.utils.tree import tree_leaves
    from runbooks_tpu_torch.ops.flash_attention import flash_attention
    from runbooks_tpu_torch.serve.api import load_model
    from runbooks_tpu_torch.serve.engine import InferenceEngine

    t0 = time.perf_counter()
    cfg, params = load_model({"model": "llama3-8b",
                              "model_overrides": {"param_dtype": "bfloat16"},
                              "seed": seed})
    torch.cuda.synchronize()
    n_params = sum(t.numel() for t in tree_leaves(params))
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


def write_train_docs(path, seed):
    """TRAIN_DOCS documents of 100 to 6000 bytes of seeded word text, as
    jsonl: the training job's data, packed through the byte tokenizer."""
    import numpy as np

    rng = np.random.default_rng(seed + 1)
    words = ["the", "kernel", "trains", "a", "model", "on", "packed",
             "rows", "of", "text", "with", "lora", "adapters", "and",
             "checkpoints", "every", "step", "hopper", "tile", "warp"]
    with open(path, "w") as f:
        for _ in range(TRAIN_DOCS):
            n = int(rng.integers(100, 6001))
            text = " ".join(rng.choice(words, size=n))[:n]
            f.write(json.dumps({"text": text}) + "\n")


def first_train_batch(path):
    """The first global batch the training job sees (numpy)."""
    from runbooks_tpu_torch.train import data

    return next(data.dataset(path, TRAIN_SEQ, 8, epochs=None))


def bwd_bound(torch, q, k, q_pos, kv_pos, q_seg, kv_seg):
    """{kernel: (bound_ms, bound_by, gflop)} on an H100 for the
    query-key pairs the masks leave open (P): K2 does 6 d h P operations
    (S, dP, dQ), K3 8 d h P (S, dP, dV, dK), against the bytes each must
    move: its inputs (q, k, v, do, lse and delta; positions and segment
    ids) read once, its outputs (dq; dk and dv) written once."""
    from runbooks_tpu_torch.ops.attention import make_attention_mask
    from runbooks_tpu_torch.utils.hw import H100_HBM_BW, H100_PEAK_BF16_FLOPS

    b, sq, h, d = q.shape
    sk, kvh = k.shape[1], k.shape[2]
    pairs = 0
    for bi in range(b):
        m = make_attention_mask(
            q_pos[bi:bi + 1], kv_pos[bi:bi + 1],
            None if q_seg is None else q_seg[bi:bi + 1],
            None if kv_seg is None else kv_seg[bi:bi + 1])
        pairs += int(m.sum().item())
    ints = 4 * b * (sq + sk) * (2 if q_seg is not None else 1)
    inputs = 2 * b * sq * h * d * 2 + 2 * b * sk * kvh * d * 2 \
        + 2 * b * h * sq * 4 + ints
    out = {"flash_bwd_dq": (6.0 * d * h * pairs,
                            inputs + b * sq * h * d * 2),
           "flash_bwd_dkv": (8.0 * d * h * pairs,
                             inputs + 2 * b * sk * kvh * d * 2)}
    res = {}
    for name, (flops, nbytes) in out.items():
        t_ops = flops / H100_PEAK_BF16_FLOPS
        t_bytes = nbytes / H100_HBM_BW
        res[name] = (max(t_ops, t_bytes) * 1e3,
                     "operations" if t_ops >= t_bytes else "bytes",
                     flops / 1e9)
    return res


def bwd_case_layouts(torch, dev, batch):
    """(name, (b, sq, sk, h, kvh, d), q_pos, kv_pos, seg, block_skip,
    grad_dtype) of the backward kernels' cases. (a) is what the training
    path gives them: a microbatch of 2 packed rows of the job's data,
    llama3-8b's 32/8 heads at d=128, causal with the skip."""

    def ar(n, start=0, rows=2):
        return (start + torch.arange(n, device=dev, dtype=torch.int32)
                )[None].expand(rows, n).contiguous()

    s = TRAIN_SEQ
    pos = torch.from_numpy(batch["positions"][:2]).to(dev)
    seg = torch.from_numpy(batch["segment_ids"][:2]).to(dev)
    f32 = torch.float32
    return [
        ("a_packed_2x2048", (2, s, s, 32, 8, 128), pos, pos, seg, True,
         None),
        ("b_causal_2x2048", (2, s, s, 32, 8, 128), ar(s), ar(s), None, True,
         None),
        ("c_ragged_2x2000", (2, 2000, 2000, 32, 8, 128), ar(2000), ar(2000),
         None, True, None),
        ("d_d64_rep2_2x1024", (2, 1024, 1024, 16, 8, 64), ar(1024),
         ar(1024), None, True, None),
        ("e_offset_sk_gt_sq", (1, 512, s, 32, 8, 128), ar(512, 1000, 1),
         ar(s, 0, 1), None, False, None),
        ("f_f32_grads_2x2048", (2, s, s, 32, 8, 128), ar(s), ar(s), None,
         True, f32),
    ]


def bwd_cases(torch, dev, gen, batch):
    """bwd_case_layouts with seeded bf16 q, k, v, do, one case at a time:
    (name, q, k, v, do, q_pos, kv_pos, seg, block_skip, grad_dtype)."""
    for (name, (b, sq, sk, h, kvh, d), qp, kp, seg, skip,
         gd) in bwd_case_layouts(torch, dev, batch):
        q, k, v, do = (torch.randn(shape, generator=gen, device=dev,
                                   dtype=torch.bfloat16)
                       for shape in ((b, sq, h, d), (b, sk, kvh, d),
                                     (b, sk, kvh, d), (b, sq, h, d)))
        yield name, q, k, v, do, qp, kp, seg, skip, gd


def library_fwd(torch, q, k, v):
    """One scaled_dot_product_attention(is_causal=True, enable_gqa=True)
    forward on the same q, k, v."""
    import torch.nn.functional as F

    qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))
    return lambda: F.scaled_dot_product_attention(qt, kt, vt, is_causal=True,
                                                  enable_gqa=True)


def library_bwd(torch, q, k, v, do):
    """The backward of one scaled_dot_product_attention(is_causal=True,
    enable_gqa=True) call on the same q, k, v: dq, dk and dv together."""
    import torch.nn.functional as F

    qt, kt, vt = (t.transpose(1, 2).detach().requires_grad_()
                  for t in (q, k, v))
    out = F.scaled_dot_product_attention(qt, kt, vt, is_causal=True,
                                         enable_gqa=True)
    dot = do.transpose(1, 2)
    return lambda: torch.autograd.grad(out, (qt, kt, vt), dot,
                                       retain_graph=True)


def bwd_kernel_phase(torch, dev, seed, batch):
    """Phase 5: K2 and K3 against the plain backward at cases (a)-(f),
    with each kernel's time, the plain version's, the bound, the rate on
    the operations the masks need, and SDPA's backward at (b) as the
    library yardstick. The (q tile, kv tile) pairs each kernel counts as
    computed and open on the card (bwd_tile_counts) must be those
    fwd_tile_plan predicts at the backward's tiles, for every head."""
    from runbooks_tpu_torch.ops.flash_attention import (
        bwd_tile_counts,
        flash_attention_bwd,
        flash_attention_bwd_reference,
        flash_attention_fwd,
        flash_bwd_kernels,
    )

    torch.cuda.reset_peak_memory_stats()
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed + 2)
    records, worst = {}, {"flash_bwd_dq": 0.0, "flash_bwd_dkv": 0.0}
    for (name, q, k, v, do, qp, kp, seg, skip, gd) in bwd_cases(
            torch, dev, gen, batch):
        out, lse = flash_attention_fwd(q, k, v, qp, kp, seg, seg,
                                       block_skip=skip)
        bwd_tile_counts()
        got = flash_attention_bwd(q, k, v, qp, kp, seg, seg, out, lse, do,
                                  block_skip=skip, grad_dtype=gd)
        card = bwd_tile_counts()
        ref = flash_attention_bwd_reference(
            q, k, v, qp, kp, seg, seg, out, lse, do, block_skip=skip,
            grad_dtype=torch.float32)
        torch.cuda.synchronize()
        errs, ok = {}, True
        for gname, a, r in zip(("dq", "dk", "dv"), got, ref):
            a, r = a.float(), r.float()
            diff = (a - r).abs()
            rmax = r.abs().max().item()
            excess = (diff - BWD_RTOL * r.abs()).max().item()
            errs[gname] = (diff.max().item(), rmax)
            ok &= bool(torch.isfinite(a).all().item())
            ok &= excess <= BWD_ATOL * rmax
        zeros = ""
        if name.startswith("e_"):
            # Queries at positions 1000..1511 see keys 0..1511 only.
            exact = bool((got[1][:, 1512:] == 0).all().item()
                         and (got[2][:, 1512:] == 0).all().item())
            zeros = f" unseen_keys_exact_zero {exact}"
            ok &= exact
        if seg is not None:
            exact = bool((got[0][seg == 0] == 0).all().item())
            zeros = f" padding_rows_dq_exact_zero {exact}"
            ok &= exact
        launch_dq, launch_dkv = flash_bwd_kernels(
            q, k, v, qp, kp, seg, seg, out, lse, do, block_skip=skip,
            grad_dtype=gd)
        ms = {"flash_bwd_dq": cuda_ms(launch_dq, 10),
              "flash_bwd_dkv": cuda_ms(launch_dkv, 10)}
        plain_ms = cuda_ms(lambda: flash_attention_bwd_reference(
            q, k, v, qp, kp, seg, seg, out, lse, do, block_skip=skip,
            grad_dtype=gd), 2)
        library_ms = None
        if name.startswith("b_"):
            library_ms = cuda_ms(library_bwd(torch, q, k, v, do), 10)
        bounds = bwd_bound(torch, q, k, qp, kp, seg, seg)
        computed, opened, total = tile_counts(torch, qp, kp, seg, seg, skip,
                                              backward=True)
        h = q.shape[2]
        tiles_agree = all(card[n] == (h * computed, h * opened)
                          for n in card)
        err_s = " ".join(f"{g} {e:.3e}/max {m:.3e}"
                         for g, (e, m) in errs.items())
        kern_s = " | ".join(
            f"{n[10:]}_ms {ms[n]:.4f} bound {bounds[n][0]:.4f} "
            f"({bounds[n][1]}, {bounds[n][2]:.1f} GFLOP) at "
            f"{bounds[n][2] / ms[n]:.1f} TFLOP/s, card tiles "
            f"{card[n][0]} (open {card[n][1]})" for n in ms)
        print(f"kernel flash_bwd {name}: q {tuple(q.shape)} k "
              f"{tuple(k.shape)} skip {skip} grad_dtype "
              f"{got[0].dtype} | err {err_s} (tol {BWD_ATOL}*max + "
              f"{BWD_RTOL}*|plain|){zeros} | tile pairs per head computed "
              f"{computed}/{total} (open {opened}) predicted by "
              f"fwd_tile_plan, x {h} heads agree with the card "
              f"{tiles_agree} | {kern_s} | plain_ms (both) {plain_ms:.3f}"
              + ("" if library_ms is None else
                 f" | library_ms SDPA backward, dq+dk+dv together "
                 f"{library_ms:.4f}")
              + f" -> {'ok' if ok and tiles_agree else 'FAIL'}", flush=True)
        if not ok:
            raise SystemExit(f"flash_bwd {name} disagrees with its plain "
                             "version")
        if not tiles_agree:
            raise SystemExit(f"flash_bwd {name}: the card's tile counts "
                             f"{card} are not {h} x fwd_tile_plan's "
                             f"({computed}, {opened})")
        worst["flash_bwd_dq"] = max(worst["flash_bwd_dq"], errs["dq"][0])
        worst["flash_bwd_dkv"] = max(worst["flash_bwd_dkv"], errs["dk"][0],
                                     errs["dv"][0])
        records[name] = dict(ms=ms, plain_ms=plain_ms, library_ms=library_ms,
                             bounds=bounds, card_tiles=card,
                             shape=f"q{tuple(q.shape)} k{tuple(k.shape)}")
    b = records["b_causal_2x2048"]
    both = sum(b["ms"].values())
    print(f"backward at (b) {b['shape']}: K2 {b['ms']['flash_bwd_dq']:.4f} "
          f"+ K3 {b['ms']['flash_bwd_dkv']:.4f} = {both:.4f} ms against "
          f"SDPA's backward {b['library_ms']:.4f} ms: "
          f"{both / b['library_ms']:.2f}x", flush=True)
    print(f"backward kernel phase peak memory "
          f"{torch.cuda.max_memory_allocated() / 1e9:.2f} GB", flush=True)
    return records, worst


def lora_grads(torch, cfg, base, lora, lora_cfg, batch):
    """(loss, [grad of each LoRA leaf]) of one loss-and-grad."""
    from runbooks_tpu_torch.train.lora import deltas
    from runbooks_tpu_torch.train.step import make_ce_terms

    leaves = {t: {n: x.detach().clone().requires_grad_() for n, x in
                  ab.items()} for t, ab in lora.items()}
    ce = make_ce_terms(cfg, remat=True, loss_chunk=0)
    loss, _ = ce(base, batch, deltas(leaves, lora_cfg))
    flat = [x for ab in leaves.values() for x in ab.values()]
    return loss.item(), torch.autograd.grad(loss, flat)


def grad_check_phase(torch, dev, seed, batch):
    """Phase 6: llama3-8b at full width, depth cut to 4 layers, one packed
    row of 2048 tokens through one LoRA loss-and-grad with the flash
    kernels (K1-K3) and with the plain attention under autograd."""
    from runbooks_tpu_torch.models.config import get_config
    from runbooks_tpu_torch.models.transformer import init_params
    from runbooks_tpu_torch.train.lora import LoraConfig, init_lora

    torch.cuda.reset_peak_memory_stats()
    cfg = get_config("llama3-8b", num_layers=4)
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed + 3)
    base = init_params(cfg, gen, dev)
    lora_cfg = LoraConfig(rank=16, alpha=32.0)
    lora = init_lora(base, lora_cfg, gen)
    # B starts at 0, which gives A no gradient; a small random B makes
    # every leaf's gradient non-zero.
    for ab in lora.values():
        ab["b"] = torch.randn(ab["b"].shape, generator=gen, device=dev) \
            * 0.02
    row = {k: torch.from_numpy(v[:1]).to(dev) for k, v in batch.items()}
    t0 = time.perf_counter()
    loss_f, g_f = lora_grads(torch, dataclasses.replace(
        cfg, attention_impl="flash"), base, lora, lora_cfg, row)
    loss_x, g_x = lora_grads(torch, dataclasses.replace(
        cfg, attention_impl="xla"), base, lora, lora_cfg, row)
    torch.cuda.synchronize()
    loss_rel = abs(loss_f - loss_x) / abs(loss_x)
    ok = loss_rel <= GRAD_LOSS_RTOL
    worst_l2, worst_cos = 0.0, 1.0
    for a, b in zip(g_f, g_x):
        a, b = a.float().flatten(), b.float().flatten()
        rel = ((a - b).norm() / b.norm()).item()
        cos = torch.nn.functional.cosine_similarity(a, b, dim=0).item()
        worst_l2, worst_cos = max(worst_l2, rel), min(worst_cos, cos)
    ok &= worst_l2 <= GRAD_REL_L2_TOL and worst_cos >= GRAD_COS_MIN
    print(f"full-width LoRA gradient check (llama3-8b, 4 layers, 1 x 2048 "
          f"packed tokens, {time.perf_counter() - t0:.1f} s): loss flash "
          f"{loss_f:.6f} plain {loss_x:.6f} rel {loss_rel:.2e} (tol "
          f"{GRAD_LOSS_RTOL}) | {len(g_f)} LoRA leaves: worst rel L2 "
          f"{worst_l2:.4f} (tol {GRAD_REL_L2_TOL}) worst cosine "
          f"{worst_cos:.6f} (min {GRAD_COS_MIN}) | peak memory "
          f"{torch.cuda.max_memory_allocated() / 1e9:.2f} GB -> "
          f"{'ok' if ok else 'FAIL'}", flush=True)
    if not ok:
        raise SystemExit("full-width gradient check failed")


def train_phase(torch, dev, seed, data_path, workdir):
    """Phase 7: the LoRA fine-tune through run_training, TRAIN_STEPS
    steps, then a resume to one step more. Returns the kernel launch
    counts of the first run."""
    from runbooks_tpu_torch.ops.flash_attention import (
        flash_attention,
        flash_attention_bwd,
    )
    from runbooks_tpu_torch.train.checkpoint import CheckpointManager
    from runbooks_tpu_torch.train.lora import LoraConfig
    from runbooks_tpu_torch.train.optimizer import OptimizerConfig
    from runbooks_tpu_torch.train.trainer import TrainJobConfig, run_training

    art = f"{workdir}/artifacts"
    job = TrainJobConfig(
        model="llama3-8b", lora=LoraConfig(rank=16, alpha=32.0),
        optimizer=OptimizerConfig(learning_rate=2e-5), batch_size=8,
        seq_len=TRAIN_SEQ, accumulate_steps=4, loss_chunk=0,
        steps=TRAIN_STEPS, data_path=data_path, artifacts_dir=art,
        log_every=1, seed=seed)
    torch.cuda.reset_peak_memory_stats()
    flash_attention.launches = 0
    flash_attention_bwd.dq_launches = 0
    flash_attention_bwd.dkv_launches = 0
    t0 = time.perf_counter()
    summary = run_training(job)
    wall = time.perf_counter() - t0
    launches = {"flash_fwd": flash_attention.launches,
                "flash_bwd_dq": flash_attention_bwd.dq_launches,
                "flash_bwd_dkv": flash_attention_bwd.dkv_launches}
    peak = torch.cuda.max_memory_allocated()
    losses = [e["loss"] for e in summary["history"]]
    intact = CheckpointManager(art).intact_steps()
    print(f"train llama3-8b LoRA r16: {TRAIN_STEPS} steps in {wall:.1f} s "
          f"(init included), losses {losses}, peak memory "
          f"{peak / 1e9:.2f} GB, launches {launches}, intact checkpoints "
          f"{intact}", flush=True)
    per_step = {"flash_fwd": 256, "flash_bwd_dq": 128, "flash_bwd_dkv": 128}
    for name, n in per_step.items():
        if launches[name] != n * TRAIN_STEPS:
            raise SystemExit(f"{name} launched {launches[name]} times in "
                             f"{TRAIN_STEPS} steps; expected "
                             f"{n * TRAIN_STEPS}")
    if not all(math.isfinite(x) for x in losses) \
            or len(losses) != TRAIN_STEPS:
        raise SystemExit(f"training losses not finite: {losses}")
    if TRAIN_STEPS not in intact:
        raise SystemExit(f"no intact checkpoint at step {TRAIN_STEPS}")

    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    resumed = run_training(dataclasses.replace(job, steps=TRAIN_STEPS + 1))
    cursor = CheckpointManager(art).read_cursor(TRAIN_STEPS)
    r_losses = [e["loss"] for e in resumed["history"]]
    print(f"resume: restored step {resumed['restored_step']} with cursor "
          f"{cursor}, ran to step {resumed['history'][-1]['step']} "
          f"(batches consumed {resumed['batches_consumed']}), loss "
          f"{r_losses}, peak memory "
          f"{torch.cuda.max_memory_allocated() / 1e9:.2f} GB", flush=True)
    if (resumed["restored_step"] != TRAIN_STEPS
            or cursor.get("batches_consumed") != TRAIN_STEPS
            or resumed["batches_consumed"] != TRAIN_STEPS + 1
            or [e["step"] for e in resumed["history"]] != [TRAIN_STEPS + 1]
            or not all(math.isfinite(x) for x in r_losses)):
        raise SystemExit("resume did not continue at the saved step and "
                         "cursor")
    return launches, summary, peak


def http_call(base, path, body=None, headers=None):
    """(status, headers, text, seconds to the first body bytes) of one
    HTTP call; for an event stream, to its first data chunk."""
    data = None if body is None else json.dumps(body).encode()
    req = urllib.request.Request(
        base + path, data=data,
        headers={"Content-Type": "application/json", **(headers or {})})
    t0 = time.perf_counter()
    try:
        with urllib.request.urlopen(req, timeout=HTTP_TIMEOUT) as r:
            first = r.readline()
            t_first = time.perf_counter() - t0
            return r.status, r.headers, (first + r.read()).decode(), t_first
    except urllib.error.HTTPError as e:
        return e.code, e.headers, e.read().decode(), \
            time.perf_counter() - t0


def fold_check(torch, seed, adapter_dir):
    """Phase 8 (a): the adapter fold at full width and depth, on slices
    of the seeded f32 base. Returns (cfg, merged params)."""
    from runbooks_tpu_torch.serve.api import load_model
    from runbooks_tpu_torch.serve.lora_pool import read_adapter_meta
    from runbooks_tpu_torch.train.checkpoint import CheckpointManager

    t0 = time.perf_counter()
    cfg, base = load_model({"model": "llama3-8b", "seed": seed})
    base_slices = {k: base["layers"][k[0]][k[1]][k[2]].float().cpu()
                   for k in FOLD_SLICES}
    del base
    gc.collect()
    torch.cuda.empty_cache()
    cfg, merged = load_model({"model": "llama3-8b", "seed": seed,
                              "adapter": adapter_dir})
    torch.cuda.synchronize()
    load_s = time.perf_counter() - t0
    lora = CheckpointManager(adapter_dir).restore_with_cursor(
        device=torch.device("cpu"))[0]["params"]
    meta = read_adapter_meta(adapter_dir)
    scale = float(meta["alpha"]) / int(meta["rank"])
    worst, moved = 0.0, []
    for group, name, layer in FOLD_SLICES:
        ab = lora[f"{group}.{name}"]
        want = (base_slices[group, name, layer] + scale * torch.matmul(
            ab["a"][layer].float(), ab["b"][layer].float()))
        got = merged["layers"][group][name][layer].float().cpu()
        worst = max(worst, (got - want).abs().max().item())
        moved.append((got - base_slices[group, name, layer]).abs().max()
                     .item())
    ok = worst <= FOLD_TOL and min(moved) > 0.0
    print(f"fold: llama3-8b f32 base + adapter r{meta['rank']} alpha "
          f"{meta['alpha']} (scale {scale}) from {adapter_dir}; slices "
          f"{FOLD_SLICES}: max |merged - (base + scale A B)| {worst:.3g} "
          f"(tol {FOLD_TOL}), max |merged - base| per slice "
          f"{[f'{m:.3g}' for m in moved]}; both loads {load_s:.1f} s -> "
          f"{'ok' if ok else 'FAIL'}", flush=True)
    if not ok:
        raise SystemExit("the adapter fold does not match base + scale A B")
    return cfg, merged


def http_mix(prompts):
    """Phase 4's 8 prompts as HTTP calls: (name, path, body, ids of the
    prompts it carries). Even prompts greedy, odd sampled; prompt 0
    streamed, prompt 2 as chat, prompts 4 and 6 as one body."""
    from runbooks_tpu_torch.train.data import ByteTokenizer

    tok = ByteTokenizer()
    texts = [tok.decode(p[1:]) for p in prompts]
    for p, t in zip(prompts, texts):
        assert tok.encode(t, add_eos=False) == p, "prompt text round trip"
    greedy = {"max_tokens": MAX_TOKENS, "temperature": 0}
    sampled = {"max_tokens": MAX_TOKENS, "temperature": 0.8, "top_p": 0.9}
    return [
        ("r0", "/v1/completions", {"prompt": texts[0], "stream": True,
                                   **greedy}, [0]),
        ("r1", "/v1/completions", {"prompt": texts[1], **sampled}, [1]),
        ("r2", "/v1/chat/completions",
         {"messages": [{"role": "user", "content": texts[2]}], **greedy},
         [2]),
        ("r3", "/v1/completions", {"prompt": texts[3], **sampled}, [3]),
        ("r4", "/v1/completions", {"prompt": [texts[4], texts[6]],
                                   **greedy}, [4, 6]),
        ("r5", "/v1/completions", {"prompt": texts[5], **sampled}, [5]),
        ("r7", "/v1/completions", {"prompt": texts[7], **sampled}, [7]),
    ]


def serve_http(torch, cfg, params, seed):
    """Phase 8 (b): the merged model behind create_server; phase 4's mix
    over HTTP at once, then the greedy requests again as one body to the
    idle server, both held to InferenceEngine.generate. Returns K1's
    launches in the mix."""
    from runbooks_tpu_torch.ops.flash_attention import flash_attention
    from runbooks_tpu_torch.serve.api import create_server
    from runbooks_tpu_torch.serve.engine import InferenceEngine, Request
    from runbooks_tpu_torch.train.data import ByteTokenizer

    t0 = time.perf_counter()
    srv = create_server(cfg, params, host="127.0.0.1", port=0, max_slots=8,
                        max_seq_len=2048, warmup=True)
    thread = threading.Thread(target=srv.serve_forever, daemon=True)
    thread.start()
    base = f"http://127.0.0.1:{srv.port}"
    status, _, text, _ = http_call(base, "/")
    ready_s = time.perf_counter() - t0
    if status != 200 or json.loads(text)["status"] != "ok":
        raise SystemExit(f"readiness: GET / answered {status} {text}")
    # The engine requests the handlers submit, to read their token ids.
    submitted = []
    submit_many = srv.worker.submit_many

    def recording_submit_many(reqs):
        submitted.extend(reqs)
        return submit_many(reqs)

    srv.worker.submit_many = recording_submit_many
    engine = srv.worker.engine
    try:
        mix = http_mix(smoke_prompts(seed))
        results = {}
        go = threading.Barrier(len(mix))

        def client(name, path, body):
            go.wait()
            results[name] = http_call(base, path, body,
                                      {"X-Request-Id": name})

        engine.ttft_seconds.clear()
        decode0, steps0 = engine.dispatch_seconds["decode"], engine.steps
        prefill0 = engine.dispatch_seconds["prefill"]
        torch.cuda.reset_peak_memory_stats()
        flash_attention.launches = 0
        threads = [threading.Thread(target=client, args=(n, p, b))
                   for n, p, b, _ in mix]
        t_mix = time.perf_counter()
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=HTTP_TIMEOUT)
        wall = time.perf_counter() - t_mix
        launches = flash_attention.launches
        peak = torch.cuda.max_memory_allocated()
        decode_s = engine.dispatch_seconds["decode"] - decode0
        ttft = sorted(engine.ttft_seconds)
        stream_text_chunks = None
        for name, path, body, ids in mix:
            if name not in results:
                raise SystemExit(f"HTTP request {name} did not answer")
            status, headers, text, t_first = results[name]
            if status != 200 or headers["X-Request-Id"] != name:
                raise SystemExit(f"HTTP request {name}: {status} {text}")
            if body.get("stream"):
                events = [ln[6:] for ln in text.split("\n")
                          if ln.startswith("data: ")]
                chunks = [json.loads(e) for e in events[:-1]]
                finish = [c["choices"][0]["finish_reason"] for c in chunks]
                if events[-1] != "[DONE]" or finish[-1] != "length":
                    raise SystemExit(f"stream {name} ended {events[-1:]}")
                stream_text_chunks = len(chunks) - 1
                continue
            payload = json.loads(text)
            choices = payload["choices"]
            if (len(choices) != len(ids) or any(
                    c["finish_reason"] != "length" for c in choices)
                    or payload["usage"]["completion_tokens"]
                    != MAX_TOKENS * len(ids)):
                raise SystemExit(f"HTTP request {name}: {payload}")
        by_rid = {r.request_id: r for r in submitted}
        if len(by_rid) != 8 or not all(
                r.finished and len(r.output_tokens) == MAX_TOKENS
                for r in by_rid.values()):
            got = [(r.request_id, r.finish_reason) for r in submitted]
            raise SystemExit(f"the mix's engine requests: {got}")
        if launches < 1:
            raise SystemExit("K1 was not launched while serving over HTTP")
        stats = {
            "http_requests": len(mix), "prompts": len(by_rid),
            "ready_s": ready_s, "wall_s": wall,
            "ttft_s_median": ttft[len(ttft) // 2], "ttft_s_max": ttft[-1],
            # Only byte ids decode to text, so with random weights the
            # stream's first chunk is often its finish chunk.
            "stream_first_chunk_s": results["r0"][3],
            "stream_text_chunks": stream_text_chunks,
            "prefill_s": engine.dispatch_seconds["prefill"] - prefill0,
            "decode_s": decode_s,
            "decode_tokens_per_s": (len(by_rid) * (MAX_TOKENS - 1)
                                    / decode_s),
            "decode_steps": engine.steps - steps0,
            "flash_fwd_launches": launches,
            "max_memory_allocated_gb": peak / 1e9}
        print("http " + json.dumps(stats), flush=True)

        # The greedy prompts as the engine saw them (the chat one
        # rendered), sent again as one body to the now idle server: its
        # engine then admits them exactly as generate() does.
        tok = ByteTokenizer()
        greedy = [by_rid[k] for k in ("r0", "r2", "r4/0", "r4/1")]
        submitted.clear()
        status, _, text, _ = http_call(base, "/v1/completions", {
            "prompt": [tok.decode(r.prompt_tokens[1:]) for r in greedy],
            "max_tokens": MAX_TOKENS, "temperature": 0},
            {"X-Request-Id": "idle"})
        if status != 200:
            raise SystemExit(f"idle greedy body: {status} {text}")
        idle = submitted[:]
        idle_text = [c["text"] for c in json.loads(text)["choices"]]
    finally:
        srv.shutdown()
        thread.join(timeout=60)
    del srv, engine, submit_many
    gc.collect()
    torch.cuda.empty_cache()

    ref_engine = InferenceEngine(cfg, params, max_slots=8, max_seq_len=2048,
                                 seed=seed)
    ref = [Request(prompt_tokens=list(r.prompt_tokens),
                   max_tokens=MAX_TOKENS, eos_id=r.eos_id) for r in greedy]
    with torch.no_grad():
        ref_engine.generate(ref)
    for r, i, t in zip(ref, idle, idle_text):
        same = (r.output_tokens == i.output_tokens
                and tok.decode(r.output_tokens) == t)
        print(f"greedy {i.request_id}: generate {r.output_tokens[:6]}... vs "
              f"idle server {i.output_tokens[:6]}... -> "
              f"{'identical' if same else 'DIFFERENT'}", flush=True)
        if not same:
            raise SystemExit("the server's greedy tokens differ from "
                             "InferenceEngine.generate's")
    # In the concurrent mix the admission grouping (prefill rows, cache
    # views) follows arrival order, so its greedy answers are held to
    # generate() up to the first divergence, which must be a near-tie.
    for r, g in zip(ref, greedy):
        near_tie_check(torch, cfg, params, f"greedy {g.request_id} in the "
                       "mix vs generate()", r.prompt_tokens, r.output_tokens,
                       g.output_tokens)
    return launches


def near_tie_check(torch, cfg, params, name, prompt, a, b, allowed=None):
    """Greedy ids a and b of one prompt are identical, or differ first at
    a near-tie: both tokens within LOGIT_TOL of the top logit of a full
    prefill of the context before them. ``allowed(ids)`` (grammar) gives
    the allowed-token row after the generated ids, and the top logit is
    then the top allowed one."""
    from runbooks_tpu_torch.serve.engine import _buckets, bucket_for

    j = next((k for k in range(len(a)) if a[k] != b[k]), None)
    if j is None and len(a) == len(b):
        print(f"{name}: identical", flush=True)
        return
    if j is None:
        raise SystemExit(f"{name}: {len(a)} vs {len(b)} tokens")
    ctx = list(prompt) + a[:j]
    with torch.no_grad():
        plain = prefill_logits(torch, cfg, params, ctx,
                               bucket_for(_buckets(2048), len(ctx)), 2048)
    if allowed is not None:
        plain = plain.masked_fill(~torch.as_tensor(
            allowed(a[:j]), device=plain.device), float("-inf"))
    top = plain.max().item()
    gaps = (top - plain[a[j]].item(), top - plain[b[j]].item())
    ok = max(gaps) < LOGIT_TOL
    print(f"{name}: first differs at token {j} ({a[j]} vs {b[j]}), logit "
          f"gaps to the max {gaps} -> {'near-tie' if ok else 'FAIL'}",
          flush=True)
    if not ok:
        raise SystemExit(f"{name}: differs away from a near-tie")


def free_port():
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def entry_point_check(torch, dev, seed, workdir):
    """Phase 8 (c): the container's entry point against the model
    mount, at full width, depth ENTRY_LAYERS, bf16."""
    from runbooks_tpu_torch.models.config import get_config
    from runbooks_tpu_torch.models.transformer import init_params
    from runbooks_tpu_torch.serve.engine import InferenceEngine, Request
    from runbooks_tpu_torch.train.checkpoint import CheckpointManager
    from runbooks_tpu_torch.train.data import ByteTokenizer

    overrides = {"num_layers": ENTRY_LAYERS, "param_dtype": "bfloat16"}
    cfg = get_config("llama3-8b", **overrides)
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed + 8)
    params = init_params(cfg, gen, dev)
    # Only byte ids decode to text: the head's other columns are zeroed so
    # the greedy tokens show in the answer's text.
    params["head"][:, 256:] = 0
    content = f"{workdir}/entry_content"
    t0 = time.perf_counter()
    CheckpointManager(f"{content}/model").save(
        1, {"step": 1, "params": params})
    save_s = time.perf_counter() - t0
    tok = ByteTokenizer()
    prompt = tok.decode(smoke_prompts(seed)[3][1:])
    ref = Request(prompt_tokens=tok.encode(prompt, add_eos=False),
                  max_tokens=MAX_TOKENS, eos_id=tok.eos_id)
    with torch.no_grad():
        InferenceEngine(cfg, params, max_slots=8, max_seq_len=2048,
                        seed=seed).generate([ref])
    out_ids = ref.output_tokens[:-1] if ref.output_tokens[-1] == tok.eos_id \
        else ref.output_tokens
    want_text = tok.decode(out_ids)
    del params
    gc.collect()
    torch.cuda.empty_cache()

    port = free_port()
    with open(f"{content}/params.json", "w") as f:
        json.dump({"model": "llama3-8b", "model_overrides": overrides,
                   "seed": seed, "port": port, "max_slots": 8,
                   "max_seq_len": 2048, "drain_timeout_s": ENTRY_DRAIN_S},
                  f)
    root = os.path.dirname(os.path.abspath(__file__))
    env = dict(os.environ, RBT_CONTENT_DIR=content,
               PYTHONPATH=os.pathsep.join(
                   [root] + [p for p in [os.environ.get("PYTHONPATH")] if p]))
    log_path = f"{workdir}/entry_point.log"
    t0 = time.perf_counter()
    with open(log_path, "w") as log:
        proc = subprocess.Popen(
            [sys.executable, "-m", "runbooks_tpu_torch.serve.api"],
            cwd=root, env=env, stdout=log, stderr=subprocess.STDOUT)
    base = f"http://127.0.0.1:{port}"
    try:
        ready_s = None
        while time.perf_counter() - t0 < 120 and proc.poll() is None:
            try:
                if http_call(base, "/")[0] == 200:
                    ready_s = time.perf_counter() - t0
                    break
            except OSError:
                pass
            time.sleep(0.5)
        if ready_s is None:
            raise SystemExit("the entry point was not ready within 120 s")
        status, _, text, _ = http_call(base, "/v1/completions", {
            "prompt": prompt, "max_tokens": MAX_TOKENS, "temperature": 0})
        if status != 200:
            raise SystemExit(f"entry point completion: {status} {text}")
        choice = json.loads(text)["choices"][0]
        usage = json.loads(text)["usage"]["completion_tokens"]
        same = (choice["text"] == want_text
                and usage == len(ref.output_tokens)
                and choice["finish_reason"] == ref.finish_reason)
        t_term = time.perf_counter()
        proc.send_signal(signal.SIGTERM)
        rc = proc.wait(timeout=ENTRY_DRAIN_S)
        exit_s = time.perf_counter() - t_term
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()
        with open(log_path) as f:
            log_tail = f.read()[-3000:]
    restored = "restored params of step 1" in log_tail
    print(f"entry point: checkpoint of llama3-8b x{ENTRY_LAYERS} layers bf16 "
          f"saved in {save_s:.1f} s; ready in {ready_s:.1f} s (start, "
          f"restore, build, warmup); restored from the mount: {restored}; "
          f"greedy completion ({usage} tokens, {choice['finish_reason']}) "
          f"{'equals' if same else 'DIFFERS FROM'} this process's decode; "
          f"SIGTERM -> exit {rc} in {exit_s:.1f} s", flush=True)
    if not (same and rc == 0 and restored):
        print(log_tail, flush=True)
        raise SystemExit("the entry point check failed")


def http_phase(torch, dev, seed, workdir):
    """Phase 8: serving phase 7's fine-tune over HTTP. Returns K1's
    launches in the HTTP mix."""
    t0 = time.perf_counter()
    cfg, merged = fold_check(torch, seed, f"{workdir}/artifacts")
    launches = serve_http(torch, cfg, merged, seed)
    del merged
    gc.collect()
    torch.cuda.empty_cache()
    entry_point_check(torch, dev, seed, workdir)
    print(f"phase 8 took {time.perf_counter() - t0:.1f} s", flush=True)
    return launches


def write_safetensors(torch, path, tensors):
    """A minimal safetensors writer (the format's specification: u64
    little-endian header length, JSON header, raw little-endian buffers):
    {name: CPU tensor} of F32, F16 or BF16 in the order given, the header
    padded with spaces to 8 bytes. The package has no writer: HF writes
    checkpoints, the port only reads them."""
    names = {torch.float32: "F32", torch.float16: "F16",
             torch.bfloat16: "BF16"}
    header, offset = {}, 0
    for name, t in tensors.items():
        n = t.numel() * t.element_size()
        header[name] = {"dtype": names[t.dtype], "shape": list(t.shape),
                        "data_offsets": [offset, offset + n]}
        offset += n
    blob = json.dumps(header).encode()
    blob += b" " * (-len(blob) % 8)
    with open(path, "wb") as f:
        f.write(struct.pack("<Q", len(blob)))
        f.write(blob)
        for t in tensors.values():
            f.write(memoryview(t.contiguous().reshape(-1).view(torch.uint8)
                               .numpy()))
    return offset


def hf_llama_names(cfg):
    """HF LlamaForCausalLM's tensor names and [out, in] shapes."""
    h, m, L = cfg.hidden_size, cfg.intermediate_size, cfg.num_layers
    shapes = {"model.embed_tokens.weight": (cfg.vocab_size, h)}
    for i in range(L):
        pre = f"model.layers.{i}."
        shapes.update({
            pre + "self_attn.q_proj.weight": (cfg.q_dim, h),
            pre + "self_attn.k_proj.weight": (cfg.kv_dim, h),
            pre + "self_attn.v_proj.weight": (cfg.kv_dim, h),
            pre + "self_attn.o_proj.weight": (h, cfg.q_dim),
            pre + "mlp.gate_proj.weight": (m, h),
            pre + "mlp.up_proj.weight": (m, h),
            pre + "mlp.down_proj.weight": (h, m),
            pre + "input_layernorm.weight": (h,),
            pre + "post_attention_layernorm.weight": (h,)})
    shapes["model.norm.weight"] = (h,)
    shapes["lm_head.weight"] = (cfg.vocab_size, h)
    return shapes


def write_hf_llama(torch, dev, cfg, directory, seed, shards):
    """An HF llama checkpoint directory of ``cfg`` in BF16, drawn on
    ``dev`` from the seed: ``shards`` safetensors files and their index.
    Returns ({name: CPU tensor}, bytes of tensor data)."""
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed + 9)
    tensors = {}
    for name, shape in hf_llama_names(cfg).items():
        if name.endswith("norm.weight"):
            t = 1 + 0.1 * torch.randn(shape, generator=gen, device=dev)
        else:
            t = torch.randn(shape, generator=gen, device=dev) \
                * shape[-1] ** -0.5
        tensors[name] = t.to(torch.bfloat16).cpu()
    os.makedirs(directory, exist_ok=True)
    names = list(tensors)
    per = -(-len(names) // shards)
    weight_map, total = {}, 0
    for k in range(shards):
        fname = f"model-{k + 1:05d}-of-{shards:05d}.safetensors"
        part = {n: tensors[n] for n in names[k * per:(k + 1) * per]}
        total += write_safetensors(torch, os.path.join(directory, fname),
                                   part)
        weight_map.update({n: fname for n in part})
    with open(os.path.join(directory, "model.safetensors.index.json"),
              "w") as f:
        json.dump({"metadata": {"total_size": total},
                   "weight_map": weight_map}, f)
    return tensors, total


def import_expected(torch, tensors, cfg):
    """(dotted leaf, layer or None, what that leaf must hold) for every
    leaf of the port's params: the HF tensor, transposed to [in, out] for
    the linear layers, in the params' dtype."""
    pairs = [("embed", None, "model.embed_tokens.weight", False),
             ("final_norm.scale", None, "model.norm.weight", False),
             ("head", None, "lm_head.weight", True)]
    hf = {"attn.wq": "self_attn.q_proj", "attn.wk": "self_attn.k_proj",
          "attn.wv": "self_attn.v_proj", "attn.wo": "self_attn.o_proj",
          "mlp.wi_gate": "mlp.gate_proj", "mlp.wi_up": "mlp.up_proj",
          "mlp.wo": "mlp.down_proj", "ln1.scale": "input_layernorm",
          "ln2.scale": "post_attention_layernorm"}
    for leaf, name in hf.items():
        for i in range(cfg.num_layers):
            pairs.append((f"layers.{leaf}", i,
                          f"model.layers.{i}.{name}.weight",
                          not leaf.endswith("scale")))
    for leaf, layer, name, transpose in pairs:
        t = tensors[name]
        yield leaf, layer, t.T if transpose else t


def import_phase(torch, dev, seed, workdir):
    """Phase 9: an HF llama3-8b directory (full width, IMPORT_LAYERS
    layers, BF16, sharded) through ``python -m
    runbooks_tpu_torch.models.loader``; the restored leaves against the
    source tensors, and greedy ids of the restored params against params
    converted in memory. Returns K1's launches serving the import."""
    from runbooks_tpu_torch.models.config import get_config
    from runbooks_tpu_torch.models.convert import convert
    from runbooks_tpu_torch.models.safetensors_io import load_state_dict
    from runbooks_tpu_torch.ops.flash_attention import flash_attention
    from runbooks_tpu_torch.serve.api import load_model
    from runbooks_tpu_torch.serve.engine import InferenceEngine, Request
    from runbooks_tpu_torch.utils.tree import tree_map

    t0 = time.perf_counter()
    overrides = {"num_layers": IMPORT_LAYERS}
    cfg = get_config("llama3-8b", **overrides)
    src = f"{workdir}/hf_llama3_8b"
    tensors, src_bytes = write_hf_llama(torch, dev, cfg, src, seed,
                                        IMPORT_SHARDS)
    write_s = time.perf_counter() - t0
    content = f"{workdir}/import_content"
    os.makedirs(content)
    with open(f"{content}/params.json", "w") as f:
        json.dump({"model": "llama3-8b", "model_overrides": overrides,
                   "source": "dir", "dir": src}, f)
    root = os.path.dirname(os.path.abspath(__file__))
    env = dict(os.environ, RBT_CONTENT_DIR=content,
               PYTHONPATH=os.pathsep.join(
                   [root] + [p for p in [os.environ.get("PYTHONPATH")] if p]))
    log_path = f"{workdir}/loader.log"
    t0 = time.perf_counter()
    with open(log_path, "w") as log:
        proc = subprocess.Popen(
            [sys.executable, "-m", "runbooks_tpu_torch.models.loader"],
            cwd=root, env=env, stdout=log, stderr=subprocess.STDOUT)
    killer = threading.Timer(IMPORT_TIMEOUT_S, proc.kill)
    killer.start()
    try:
        # wait4: this child's own peak resident set, not the largest of
        # every child this process has waited for.
        _, status, usage = os.wait4(proc.pid, 0)
    finally:
        killer.cancel()
    proc.returncode = os.waitstatus_to_exitcode(status)
    import_s = time.perf_counter() - t0
    with open(log_path) as f:
        log_text = f.read()
    artifacts = f"{content}/artifacts"
    ckpt_bytes = os.path.getsize(f"{artifacts}/checkpoints/0/state.pt")
    with open(f"{artifacts}/model.json") as f:
        meta = json.load(f)
    lines = log_text.strip().splitlines()
    done = json.loads(lines[-1])
    spans = next((json.loads(ln)["spans"] for ln in reversed(lines)
                  if ln.startswith('{"spans"')), {})
    want_meta = {"model": "llama3-8b", "num_params": cfg.num_params,
                 "vocab_size": cfg.vocab_size, "quantize": "none",
                 "weight_bytes": 4 * cfg.num_params, "source": "dir"}
    meta_ok = (proc.returncode == 0 and meta == want_meta
               and done == {"done": True, **want_meta}
               and set(spans) == {"start", "read", "convert", "save"})
    stats = {"layers": IMPORT_LAYERS, "shards": IMPORT_SHARDS,
             "source_bytes": src_bytes, "write_s": write_s,
             "import_s": import_s,
             # Source bytes over the loader's wall time, interpreter start,
             # imports and the checkpoint write included.
             "import_gb_per_s_end_to_end": src_bytes / import_s / 1e9,
             # Source bytes over the convert span alone: the mapped source
             # paged in, cast and transposed into the stacks.
             "convert_gb_per_s": (src_bytes / spans["convert"]["s"] / 1e9
                                  if "convert" in spans else None),
             "loader_spans": spans,
             "checkpoint_bytes": ckpt_bytes,
             "loader_peak_rss_gb": usage.ru_maxrss * 1024 / 1e9,
             "exit_code": proc.returncode}
    print("import " + json.dumps(stats), flush=True)
    if not meta_ok:
        print(log_text[-3000:], flush=True)
        raise SystemExit(f"the loader's model.json {meta} or its done line "
                         f"{done} is not {want_meta}")

    cfg, restored = load_model({"model": "llama3-8b",
                                "model_overrides": overrides,
                                "checkpoint": artifacts})
    n_leaves = n_equal = 0
    for leaf, layer, want in import_expected(torch, tensors, cfg):
        got = restored
        for k in leaf.split("."):
            got = got[k]
        if layer is not None:
            got = got[layer]
        n_leaves += 1
        n_equal += int(got.dtype == torch.float32 and torch.equal(
            got, want.to(dev, torch.float32)))
    print(f"import: {n_equal} of {n_leaves} restored leaves (per layer) "
          "equal the BF16 source, transposed and cast to float32, bit for "
          "bit", flush=True)
    if n_equal != n_leaves:
        raise SystemExit("the imported checkpoint differs from its source")

    prompts = smoke_prompts(seed)[:4]

    def greedy(params):
        reqs = [Request(prompt_tokens=p, max_tokens=MAX_TOKENS)
                for p in prompts]
        with torch.no_grad():
            InferenceEngine(cfg, params, max_slots=8, max_seq_len=2048,
                            seed=seed).generate(reqs)
        return [r.output_tokens for r in reqs]

    flash_attention.launches = 0
    got = greedy(restored)
    launches = flash_attention.launches
    del restored
    in_memory = tree_map(lambda t: t.to(dev), convert(
        cfg, load_state_dict(src), cfg.param_dtype))
    want = greedy(in_memory)
    del in_memory, tensors
    same = got == want
    print(f"import: greedy ids of {len(prompts)} prompts from the restored "
          f"checkpoint {'equal' if same else 'DIFFER FROM'} those of the "
          f"params converted in memory ({got[0][:6]}...); K1 launches "
          f"{launches}", flush=True)
    if not same or launches < 1:
        raise SystemExit("serving the import failed")
    return launches


def prefix_prompts(seed):
    """(prefix text, prompt texts): a PREFIX_LEN-token system prompt
    (ByteTokenizer: BOS and one token per byte) and 8 prompts that extend
    it by SUFFIX_LENS tokens of seeded word text."""
    import numpy as np

    rng = np.random.default_rng(seed + 10)
    words = ["you", "are", "a", "helpful", "assistant", "answer", "briefly",
             "cite", "the", "kernel", "cache", "prefix", "tokens", "hopper"]

    def text(n):
        return " ".join(rng.choice(words, size=n))[:n]

    prefix = text(PREFIX_LEN - 1)
    return prefix, [prefix + text(n) for n in SUFFIX_LENS]


def prefix_phase(torch, seed):
    """Phase 10: the serving cell's engine (llama3-8b bf16, full width
    and depth) behind create_server(warm_prefix=True); 8 prompts that
    extend a PREFIX_LEN-token system prompt, as one greedy body, first with
    no prefix registered, then after POST /v1/prefix. The engine's own
    prefill dispatches are recorded: each real row's first-token logits
    are held to a full prefill of its prompt. Returns K1's launches:
    (registration, with the prefix, without it)."""
    from runbooks_tpu_torch.ops.flash_attention import (
        flash_attention,
        fwd_tile_counts,
    )
    from runbooks_tpu_torch.serve.api import create_server, load_model
    from runbooks_tpu_torch.serve.engine import bucket_for
    from runbooks_tpu_torch.train.data import ByteTokenizer

    cfg, params = load_model({"model": "llama3-8b",
                              "model_overrides": {"param_dtype": "bfloat16"},
                              "seed": seed})
    tok = ByteTokenizer()
    prefix_text, texts = prefix_prompts(seed)
    prefix_ids = tok.encode(prefix_text, add_eos=False)
    prompts = [tok.encode(t, add_eos=False) for t in texts]
    if len(prefix_ids) != PREFIX_LEN or not all(
            p[:PREFIX_LEN] == prefix_ids for p in prompts):
        raise SystemExit("the prefix prompts do not extend the prefix")
    t0 = time.perf_counter()
    srv = create_server(cfg, params, host="127.0.0.1", port=0, max_slots=8,
                        max_seq_len=2048, warmup=True, warm_prefix=True)
    ready_s = time.perf_counter() - t0
    thread = threading.Thread(target=srv.serve_forever, daemon=True)
    thread.start()
    base = f"http://127.0.0.1:{srv.port}"
    engine = srv.worker.engine
    submitted = []
    submit_many = srv.worker.submit_many

    def recording_submit_many(reqs):
        submitted.extend(reqs)
        return submit_many(reqs)

    srv.worker.submit_many = recording_submit_many
    dispatch_pos = []
    # Per mix: {prompt index: the engine's first-token logits}.
    first_logits = {}
    prefill = engine._prefill

    def recording_prefill(params_, pool, tokens, positions, slots, last_pos,
                          *args, **kw):
        dispatch_pos.append(positions.clone())
        first, pool, logits = prefill(params_, pool, tokens, positions,
                                      slots, last_pos, *args, **kw)
        prefix = kw.get("prefix")
        plen = prefix[0].shape[1] if prefix is not None else 0
        toks, pos0 = tokens.tolist(), positions[:, 0].tolist()
        for r, m in enumerate(x + 1 for x in last_pos.tolist()):
            if pos0[r] == engine._pad_slot:
                continue    # a padding row
            # The row's prompt: the registered prefix (when spliced) and
            # the row's m real tokens.
            row = (prefix_ids[:plen] if plen else []) + toks[r][:m]
            first_logits[prompts.index(row)] = logits[r].float().clone()
        return first, pool, logits

    engine._prefill = recording_prefill
    body = {"prompt": texts, "max_tokens": MAX_TOKENS, "temperature": 0}

    def mix(name):
        submitted.clear()
        dispatch_pos.clear()
        first_logits.clear()
        engine.ttft_seconds.clear()
        prefill0 = engine.dispatch_seconds["prefill"]
        decode0 = engine.dispatch_seconds["decode"]
        reused0 = engine.prefix_tokens_reused
        fwd_tile_counts()
        torch.cuda.reset_peak_memory_stats()
        flash_attention.launches = 0
        t_mix = time.perf_counter()
        status, _, text, _ = http_call(base, "/v1/completions", body,
                                       {"X-Request-Id": name})
        wall = time.perf_counter() - t_mix
        launches = flash_attention.launches
        card_tiles = fwd_tile_counts()[0]
        if status != 200 or not all(
                c["finish_reason"] == "length"
                for c in json.loads(text)["choices"]):
            raise SystemExit(f"prefix mix {name}: {status} {text[:300]}")
        ttft = sorted(engine.ttft_seconds)
        predicted = sum(
            cfg.num_layers * cfg.num_heads * tile_counts(
                torch, pos, torch.arange(
                    2049, dtype=torch.int32, device=pos.device)[None].expand(
                        pos.shape[0], 2049), None, None, False)[0]
            for pos in dispatch_pos)
        return {"wall_s": wall, "ttft_s_median": ttft[len(ttft) // 2],
                "ttft_s_max": ttft[-1],
                "prefill_s": engine.dispatch_seconds["prefill"] - prefill0,
                "decode_s": engine.dispatch_seconds["decode"] - decode0,
                "prefill_dispatches": len(dispatch_pos),
                "prefill_query_rows": [list(p.shape) for p in dispatch_pos],
                "flash_fwd_launches": launches,
                "kv_tiles_card": card_tiles, "kv_tiles_predicted": predicted,
                "prefix_tokens_reused":
                    engine.prefix_tokens_reused - reused0,
                "max_memory_allocated_gb":
                    torch.cuda.max_memory_allocated() / 1e9}, \
            [list(r.output_tokens) for r in submitted], dict(first_logits)

    try:
        off, off_ids, off_logits = mix("no_prefix")
        flash_attention.launches = 0
        t_reg = time.perf_counter()
        status, _, text, _ = http_call(base, "/v1/prefix",
                                       {"prompt": prefix_text})
        register_s = time.perf_counter() - t_reg
        build_launches = flash_attention.launches
        if status != 200 or json.loads(text) != {
                "cached_prefix_len": PREFIX_LEN}:
            raise SystemExit(f"/v1/prefix answered {status} {text}")
        on, on_ids, on_logits = mix("prefix")
        key = tuple(prefix_ids)
        pk, pv = engine._prefix_cache[key]
        hits = (engine.prefix_lookups, engine.prefix_hits)
    finally:
        srv.shutdown()
        thread.join(timeout=60)
    stats = {"ready_s": ready_s, "register_s": register_s,
             "register_flash_fwd_launches": build_launches,
             "prefix_kv_bytes": 2 * pk.numel() * pk.element_size(),
             "lookups_hits": hits, "without_prefix": off,
             "with_prefix": on}
    print("prefix " + json.dumps(stats), flush=True)
    ok = (on["prefix_tokens_reused"] == len(prompts) * PREFIX_LEN
          and off["prefix_tokens_reused"] == 0
          and hits == (2 * len(prompts), len(prompts))
          and on["kv_tiles_card"] == on["kv_tiles_predicted"]
          and off["kv_tiles_card"] == off["kv_tiles_predicted"]
          and min(on["flash_fwd_launches"], off["flash_fwd_launches"],
                  build_launches) >= cfg.num_layers)
    print(f"prefix: reused {on['prefix_tokens_reused']} tokens (want "
          f"{len(prompts)} x {PREFIX_LEN}); K1 kv tiles on the card "
          f"{on['kv_tiles_card']} / {off['kv_tiles_card']} vs fwd_tile_plan "
          f"{on['kv_tiles_predicted']} / {off['kv_tiles_predicted']} (with "
          f"/ without) -> {'ok' if ok else 'FAIL'}", flush=True)
    if not ok:
        raise SystemExit("the shared-prefix path failed its counts")
    # The first token: the engine's own prefill logits, with the prefix
    # spliced and without it, against a one-row full prefill; then the
    # greedy ids with and without the prefix.
    for name, got in (("with", on_logits), ("without", off_logits)):
        if sorted(got) != list(range(len(prompts))):
            raise SystemExit(f"the engine's prefills {name} the prefix "
                             f"covered prompts {sorted(got)}")
    with torch.no_grad():
        for i, p in enumerate(prompts):
            full = prefill_logits(torch, cfg, params, p,
                                  bucket_for(engine.prefill_buckets, len(p)),
                                  2048).float()
            for name, got in (("with", on_logits), ("without", off_logits)):
                gap_check(f"prefix prompt {i} ({len(p)} tokens): the "
                          f"engine's first-token logits {name} the prefix "
                          "vs a full prefill", got[i], full)
    for i, p in enumerate(prompts):
        near_tie_check(torch, cfg, params, f"prefix prompt {i}: greedy ids "
                       "with vs without the prefix", p, off_ids[i],
                       on_ids[i])
    del srv, engine, params, pk, pv
    gc.collect()
    torch.cuda.empty_cache()
    return build_launches, on["flash_fwd_launches"], \
        off["flash_fwd_launches"]


def spec_prompts(seed):
    """SPEC_LENS prompts (ByteTokenizer ids) that repeat seeded spans: four
    spans of seeded code-like words, quoted again and again in a seeded
    order, as code edits and answers that quote their context do."""
    import numpy as np

    from runbooks_tpu_torch.train.data import ByteTokenizer

    rng = np.random.default_rng(seed + 11)
    tok = ByteTokenizer()
    words = ["def", "return", "self", "cache", "token", "slot", "if", "else",
             "for", "in", "range", "draft", "verify", "kernel", "(", ")"]
    prompts = []
    for n in SPEC_LENS:
        spans = [" ".join(rng.choice(words, size=int(rng.integers(8, 30))))
                 for _ in range(4)]
        text = ""
        while len(text) < n:
            text += spans[int(rng.integers(0, 4))] + "\n"
        prompts.append(tok.encode(text, add_eos=False)[:n])
    return prompts


def median(xs):
    return sorted(xs)[len(xs) // 2] if xs else None


def warm_engine(torch, cfg, params, seed, cls=None, **kw):
    """A warmed-up InferenceEngine(max_slots=8, max_seq_len=2048) (or of
    the engine class ``cls``) and the list its dispatches record their
    host seconds in ({kind: [s, ...]}, around the engine's own dispatch
    spans)."""
    import contextlib

    from runbooks_tpu_torch.serve.engine import InferenceEngine

    engine = (cls or InferenceEngine)(cfg, params, max_slots=8,
                                      max_seq_len=2048, seed=seed, **kw)
    t0 = time.perf_counter()
    with torch.no_grad():
        engine.warmup()
    torch.cuda.synchronize()
    warm_s = time.perf_counter() - t0
    samples = {}
    spans = engine._dispatch

    @contextlib.contextmanager
    def recording(kind):
        t = time.perf_counter()
        with spans(kind):
            yield
        samples.setdefault(kind, []).append(time.perf_counter() - t)

    engine._dispatch = recording
    return engine, samples, warm_s


def timed_generate(torch, engine, samples, reqs):
    """engine.generate(reqs) with K1's launches and the engine's counters
    read around it: (stats, output ids)."""
    from runbooks_tpu_torch.ops.flash_attention import flash_attention

    secs0 = dict(engine.dispatch_seconds)
    spec0 = (engine.spec_drafted, engine.spec_accepted,
             engine.spec_verify_steps)
    samples.clear()
    engine.grammar_mask_seconds.clear()
    torch.cuda.synchronize()
    flash_attention.launches = 0
    t0 = time.perf_counter()
    with torch.no_grad():
        engine.generate(reqs)
    wall = time.perf_counter() - t0
    launches = flash_attention.launches
    decode_s = sum(engine.dispatch_seconds[k] - secs0[k]
                   for k in ("decode", "verify"))
    decode_tokens = sum(len(r.output_tokens) - 1 for r in reqs)
    drafted, accepted, verify_steps = (
        now - before for now, before in zip(
            (engine.spec_drafted, engine.spec_accepted,
             engine.spec_verify_steps), spec0))
    med = {k: (median(v) * 1000 if v else None) for k, v in
           (("verify", samples.get("verify", [])),
            ("decode", samples.get("decode", [])))}
    masks = list(engine.grammar_mask_seconds)
    stats = {
        "wall_s": wall,
        "prefill_s": engine.dispatch_seconds["prefill"] - secs0["prefill"],
        "decode_and_verify_s": decode_s,
        "decode_tokens": decode_tokens,
        "decode_tokens_per_s": decode_tokens / decode_s,
        "decode_steps": len(samples.get("decode", [])),
        "verify_steps": verify_steps,
        "drafted": drafted,
        "accepted": accepted,
        "accept_rate": accepted / drafted if drafted else None,
        "median_verify_dispatch_ms": med["verify"],
        "median_decode_step_ms": med["decode"],
        "mask_builds": len(masks),
        "median_mask_build_ms": median(masks) * 1000 if masks else None,
        "flash_fwd_launches": launches,
        "finish_reasons": [r.finish_reason for r in reqs],
    }
    return stats, [list(r.output_tokens) for r in reqs]


def free_engine(torch, *engines):
    for e in engines:
        e.cache = None
    gc.collect()
    torch.cuda.empty_cache()


def filtered_pi(torch, row, temp, top_k, top_p, max_top_k=64):
    """The distribution ``sample`` draws from for one logits row, in
    float64: the sorted lane of max_top_k tokens cut by top-k and top-p,
    or the full vocabulary when neither restricts."""
    scaled = row.double() / temp
    if top_k <= 0 and top_p >= 1.0:
        return torch.softmax(scaled, dim=-1)
    vals, idx = torch.topk(scaled, max_top_k)
    k_eff = max_top_k if top_k <= 0 else min(top_k, max_top_k)
    probs = torch.softmax(vals[:k_eff], dim=-1)
    keep = (torch.cumsum(probs, 0) - probs) < top_p
    keep[0] = True
    pi = torch.zeros_like(scaled)
    pi[idx[:k_eff][keep]] = torch.softmax(vals[:k_eff][keep], dim=-1)
    return pi


def verify_check(torch, dev, seed):
    """Phase 11 (c): speculative_verify on the card at vocab 128256."""
    from runbooks_tpu_torch.ops.sampling import sample, speculative_verify

    vocab = 128256
    g = torch.Generator(device=dev).manual_seed(seed + 12)
    # One fixed row: 8 boosted tokens over a normal background, so the
    # filtered distribution has a few tokens of real mass; the draft is
    # the second most likely.
    row = torch.randn(vocab, generator=g, device=dev)
    top = torch.randperm(vocab, generator=g, device=dev)[:8]
    row[top] = torch.tensor([16.0, 15.5, 15.0, 14.5, 14.0, 13.0, 12.0, 11.0],
                            device=dev)
    draft = int(top[1])
    n = VERIFY_CHUNK
    drafts = torch.full((n, 1), draft, dtype=torch.int64, device=dev)
    temps = torch.full((n,), 0.8, device=dev)
    ks = torch.zeros(n, dtype=torch.int32, device=dev)
    out = {}
    for top_p in (0.9, 1.0):
        pi = filtered_pi(torch, row, 0.8, 0, top_p)
        ps = torch.full((n,), top_p, device=dev)
        logits = row.expand(n, 2, vocab).contiguous()
        accepted = 0
        emitted_hist = torch.zeros(9, dtype=torch.int64, device=dev)
        sample_hist = torch.zeros(9, dtype=torch.int64, device=dev)
        bins = torch.full((vocab,), 8, dtype=torch.int64, device=dev)
        bins[top] = torch.arange(8, device=dev)
        for _ in range(VERIFY_ROWS // n):
            accept, resid, _ = speculative_verify(logits, drafts, g, temps,
                                                  ks, ps)
            emitted = torch.where(accept[:, 0], drafts[:, 0], resid[:, 0])
            accepted += int(accept.sum())
            emitted_hist += torch.bincount(bins[emitted], minlength=9)
            ref = sample(logits[:, 0], g, temps, ks, ps)
            sample_hist += torch.bincount(bins[ref], minlength=9)
        rows = VERIFY_ROWS
        p = float(pi[draft])
        rate = accepted / rows
        accept_sigma = math.sqrt(p * (1 - p) / rows)
        e = emitted_hist.double().cpu() / rows
        r = sample_hist.double().cpu() / rows
        pooled = (e + r) / 2
        sigma = (pooled * (1 - pooled) * 2 / rows).sqrt()
        worst = float(((e - r).abs() / sigma.clamp(min=1e-12)).max())
        ok = (abs(rate - p) <= VERIFY_SIGMAS * accept_sigma
              and bool(((e - r).abs()
                        <= VERIFY_SIGMAS * sigma + 1e-12).all()))
        key = f"top_p_{top_p}"
        out[key] = {"pi_draft": p, "accept_rate": rate,
                    "accept_sigmas": abs(rate - p) / accept_sigma,
                    "histogram_worst_sigmas": worst,
                    "emitted_top8_other": e.tolist(),
                    "sample_top8_other": r.tolist(), "ok": ok}
        print(f"verify at vocab {vocab}, temperature 0.8, {key}: accept "
              f"rate {rate:.4f} vs pi(draft) {p:.4f} "
              f"({out[key]['accept_sigmas']:.2f} sigma); emitted histogram "
              f"vs sample's, worst {worst:.2f} sigma -> "
              f"{'ok' if ok else 'FAIL'}", flush=True)
        if not ok:
            raise SystemExit(f"speculative_verify ({key}) is not "
                             "distributed as sample")
        del logits
    # Greedy rows: the verdicts are the argmax exactly.
    logits = torch.randn((64, 5, vocab), generator=g, device=dev)
    argmax = logits.argmax(-1)
    gd = argmax[:, :4].clone()
    gd[1::2, 1:] = (gd[1::2, 1:] + 1) % vocab
    zeros = torch.zeros(64, device=dev)
    accept, resid, full = speculative_verify(
        logits, gd, g, zeros, torch.zeros(64, dtype=torch.int32,
                                          device=dev),
        torch.ones(64, device=dev))
    greedy_ok = (torch.equal(accept, gd == argmax[:, :4])
                 and torch.equal(resid, argmax[:, :4])
                 and torch.equal(full, argmax))
    # The verify sampling's own time at the engine's shape.
    lg = torch.randn((8, 5, vocab), generator=g, device=dev)
    ld = lg[:, :4].argmax(-1)
    vt, vk = torch.full((8,), 0.8, device=dev), torch.zeros(
        8, dtype=torch.int32, device=dev)
    vp = torch.full((8,), 0.9, device=dev)
    out["greedy_rows_equal_argmax"] = greedy_ok
    out["verify_sampling_ms_8x5"] = cuda_ms(
        lambda: speculative_verify(lg, ld, g, vt, vk, vp), 20)
    print(f"verify greedy rows equal argmax: {greedy_ok}; verify sampling "
          f"[8, 5, {vocab}] {out['verify_sampling_ms_8x5']:.4f} ms",
          flush=True)
    if not greedy_ok:
        raise SystemExit("speculative_verify's greedy rows differ from the "
                         "argmax")
    return out


def _object(props):
    return {"type": "json_schema", "json_schema": {"schema": {
        "type": "object", "properties": props, "required": sorted(props),
        "additionalProperties": False}}}


# Phase 11 (d)'s response formats: (format, bounded, check of the parsed
# value). The bounded ones are objects of enum, const and boolean.
GRAMMAR_FORMATS = [
    (_object({"ok": {"type": "boolean"},
              "mode": {"enum": ["fast", "slow"]}}), True,
     lambda v: set(v) == {"ok", "mode"} and isinstance(v["ok"], bool)
     and v["mode"] in ("fast", "slow")),
    (_object({"kind": {"const": "edit"}, "valid": {"type": "boolean"}}),
     True, lambda v: v["kind"] == "edit" and isinstance(v["valid"], bool)
     and set(v) == {"kind", "valid"}),
    (_object({"lang": {"enum": ["en", "de", "fr"]},
              "done": {"type": "boolean"}, "v": {"const": 1}}), True,
     lambda v: set(v) == {"lang", "done", "v"} and v["lang"] in
     ("en", "de", "fr") and isinstance(v["done"], bool) and v["v"] == 1),
    (_object({"answer": {"enum": ["yes", "no"]},
              "sure": {"type": "boolean"}, "n": {"type": "null"}}), True,
     lambda v: set(v) == {"answer", "sure", "n"} and v["answer"] in
     ("yes", "no") and isinstance(v["sure"], bool) and v["n"] is None),
    (_object({"id": {"type": "integer"},
              "tags": {"type": "array", "items": {"enum": ["a", "b"]}}}),
     False, lambda v: set(v) == {"id", "tags"} and isinstance(v["id"], int)
     and all(t in ("a", "b") for t in v["tags"])),
    ({"type": "json_schema", "json_schema": {"schema": {
        "type": "array", "items": {"type": "boolean"}}}}, False,
     lambda v: all(isinstance(x, bool) for x in v)),
    (_object({"name": {"type": "string"}}), False,
     lambda v: set(v) == {"name"} and isinstance(v["name"], str)),
    ({"type": "ebnf", "grammar": 'root ::= "[" [0-9] ("," [0-9])* "]"'},
     False, lambda v: all(0 <= x <= 9 for x in v)),
]


def grammar_requests(prompts, eos):
    """One request per format over the spec prompts' first 200 tokens,
    greedy and temperature 0.7 alternating."""
    from runbooks_tpu_torch.serve.engine import Request

    return [Request(prompt_tokens=list(prompts[0][:200]) + [ord("\n")],
                    max_tokens=GRAMMAR_MAX,
                    temperature=0.0 if i % 2 == 0 else 0.7, eos_id=eos,
                    response_format=rf, request_id=f"g{i}")
            for i, (rf, _, _) in enumerate(GRAMMAR_FORMATS)]


def grammar_gate(engine, reqs, name):
    """Every token legal under a fresh cursor (EOS only at an accepting
    state); bounded formats finish grammar_complete with JSON that passes
    their check; unbounded ones likewise (or by EOS at an accepting
    state), or run to GRAMMAR_MAX tokens."""
    for r, (rf, bounded, check) in zip(reqs, GRAMMAR_FORMATS):
        cur = engine._grammar_cache.cursor(rf)
        legal = True
        for t in r.output_tokens:
            if t == r.eos_id:
                legal = cur.accepting
                break
            if not cur.advance(t):
                legal = False
                break
        text = bytes(t for t in r.output_tokens if t < 256).decode()
        parsed = None
        if r.finish_reason in ("grammar_complete", "stop"):
            try:
                parsed = check(json.loads(text))
            except (ValueError, KeyError, TypeError):
                parsed = False
        if bounded:
            ok = legal and r.finish_reason == "grammar_complete" and parsed
        else:
            ok = legal and (parsed or (r.finish_reason == "length" and len(
                r.output_tokens) == GRAMMAR_MAX))
        kind = "bounded" if bounded else "unbounded"
        print(f"grammar {name} {r.request_id} ({kind}, temperature "
              f"{r.temperature}): {r.finish_reason}, "
              f"{len(r.output_tokens)} tokens, {text[:60]!r} -> "
              f"{'ok' if ok else 'FAIL'}", flush=True)
        if not ok:
            raise SystemExit(f"grammar {name}: request {r.request_id} "
                             "broke its format")


def spec_grammar_phase(torch, dev, seed):
    """Phase 11: speculation and grammar at full width and depth. Returns
    K1's launches by run."""
    from runbooks_tpu_torch.ops.flash_attention import flash_attention
    from runbooks_tpu_torch.serve.api import create_server, load_model
    from runbooks_tpu_torch.serve.engine import Request
    from runbooks_tpu_torch.train.data import ByteTokenizer

    t_phase = time.perf_counter()
    cfg, params = load_model({"model": "llama3-8b",
                              "model_overrides": {"param_dtype": "bfloat16"},
                              "seed": seed})
    prompts = spec_prompts(seed)
    launches = {}

    def greedy(name):
        return [Request(prompt_tokens=list(p), max_tokens=SPEC_NEW,
                        request_id=f"{name}{i}")
                for i, p in enumerate(prompts)]

    def finished_all(stats, reqs_ids, name):
        if not all(len(ids) == SPEC_NEW for ids in reqs_ids):
            raise SystemExit(f"speculation run {name}: not every request "
                             f"got {SPEC_NEW} tokens: {stats}")

    # (a) n-gram speculation against none, greedy.
    engine, samples, warm_off = warm_engine(torch, cfg, params, seed)
    off, off_ids = timed_generate(torch, engine, samples, greedy("off"))
    finished_all(off, off_ids, "off")
    free_engine(torch, engine)
    del engine
    engine, samples, warm_on = warm_engine(torch, cfg, params, seed,
                                           speculative="ngram",
                                           draft_tokens=4)
    on, on_ids = timed_generate(torch, engine, samples, greedy("ngram"))
    finished_all(on, on_ids, "ngram")
    launches["spec_off"] = off["flash_fwd_launches"]
    launches["spec_ngram"] = on["flash_fwd_launches"]
    print("speculation " + json.dumps({
        "warmup_s": {"off": warm_off, "ngram": warm_on},
        "off": off, "ngram": on}), flush=True)
    for i, p in enumerate(prompts):
        near_tie_check(torch, cfg, params, f"spec prompt {i} ({len(p)} "
                       "tokens): greedy ids off vs ngram", p, off_ids[i],
                       on_ids[i])

    # (b) The oracle: run (a)'s ids without speculation as drafts, one
    # slot's going wrong from its ORACLE_WRONG_AT-th token.
    def oracle(slot, max_tokens):
        req = engine.slot_req[slot]
        done = len(req.output_tokens)
        out = []
        for j, t in enumerate(req.oracle[done:done + max_tokens]):
            wrong = req.wrong_at is not None and done + j >= req.wrong_at
            out.append((t + 1) % cfg.vocab_size if wrong else t)
        return out

    engine._draft_for = oracle
    reqs = greedy("oracle")
    for i, r in enumerate(reqs):
        r.oracle = off_ids[i]
        r.wrong_at = ORACLE_WRONG_AT if i == ORACLE_WRONG_SLOT else None
    orc, orc_ids = timed_generate(torch, engine, samples, reqs)
    finished_all(orc, orc_ids, "oracle")
    launches["spec_oracle"] = orc["flash_fwd_launches"]
    print("speculation oracle " + json.dumps(orc), flush=True)
    for i, p in enumerate(prompts):
        near_tie_check(torch, cfg, params, f"oracle prompt {i}: greedy ids "
                       "off vs oracle drafts", p, off_ids[i], orc_ids[i])
    free_engine(torch, engine)
    del engine

    # (c) The verify sampling on the card.
    verify = verify_check(torch, dev, seed)

    # (d) Grammar, speculation off and on.
    tok = ByteTokenizer()
    grammar = {}
    g_ids = {}
    for spec in ("off", "ngram"):
        engine, samples, warm = warm_engine(
            torch, cfg, params, seed, grammar="on", tokenizer=tok,
            speculative=spec)
        reqs = grammar_requests(prompts, tok.eos_id)
        # Each format compiles in submit's validate (an LRU miss).
        stats, g_ids[spec] = timed_generate(torch, engine, samples, reqs)
        gs = engine.grammar_stats()
        stats.update({"warmup_s": warm,
                      "dfa_compiles": gs["misses"],
                      "dfa_compile_s_total": gs["compile_seconds_total"],
                      "dfa_compile_s_each": (gs["compile_seconds_total"]
                                             / max(gs["misses"], 1)),
                      "dfa_states": [r._grammar.dfa.num_states
                                     for r in reqs],
                      "draft_truncations": gs["draft_truncations_total"]})
        grammar[spec] = stats
        launches[f"grammar_{spec}"] = stats["flash_fwd_launches"]
        grammar_gate(engine, reqs, spec)
        cursors = engine._grammar_cache
        free_engine(torch, engine)
        del engine
    print("grammar " + json.dumps(grammar), flush=True)

    def allowed_after(rf):
        def allowed(ids):
            cur = cursors.cursor(rf)
            for t in ids:
                cur.advance(t)
            return cur.mask_row().copy()
        return allowed

    reqs = grammar_requests(prompts, tok.eos_id)
    for i, r in enumerate(reqs):
        if r.temperature == 0.0:
            near_tie_check(torch, cfg, params, f"grammar request {i}: "
                           "greedy ids speculation off vs on",
                           r.prompt_tokens, g_ids["off"][i],
                           g_ids["ngram"][i],
                           allowed=allowed_after(r.response_format))

    # (e) Over HTTP.
    srv = create_server(cfg, params, host="127.0.0.1", port=0, max_slots=8,
                        max_seq_len=2048, speculative="ngram", grammar="on")
    thread = threading.Thread(target=srv.serve_forever, daemon=True)
    thread.start()
    base = f"http://127.0.0.1:{srv.port}"
    rf, _, check = GRAMMAR_FORMATS[0]
    body = {"messages": [{"role": "user", "content": "Reply in JSON."}],
            "max_tokens": 64, "temperature": 0, "response_format": rf}
    bad = {**body, "response_format": {"type": "json_schema", "json_schema": {
        "schema": {"type": "string", "pattern": "a+"}}}}
    try:
        flash_attention.launches = 0
        status, _, text, _ = http_call(base, "/v1/chat/completions", body)
        launches["grammar_http"] = flash_attention.launches
        bad_status, _, bad_text, _ = http_call(base, "/v1/chat/completions",
                                               bad)
    finally:
        srv.shutdown()
        thread.join(timeout=60)
    ok = status == 200
    if ok:
        choice = json.loads(text)["choices"][0]
        try:
            ok = (choice["finish_reason"] == "grammar_complete"
                  and check(json.loads(choice["message"]["content"])))
        except (ValueError, KeyError, TypeError):
            ok = False
    bad_ok = bad_status == 400 and "pattern" in json.loads(
        bad_text)["error"]["message"]
    print(f"grammar over HTTP: {status} {text[:200]} -> "
          f"{'ok' if ok else 'FAIL'}; unsupported construct: {bad_status} "
          f"{bad_text[:200]} -> {'ok' if bad_ok else 'FAIL'}", flush=True)
    if not (ok and bad_ok):
        raise SystemExit("grammar over HTTP failed")
    if min(launches.values()) < cfg.num_layers:
        raise SystemExit(f"phase 11 ran K1 too rarely: {launches}")
    print("phase 11 " + json.dumps({
        "verify": verify, "flash_fwd_launches": launches,
        "seconds": time.perf_counter() - t_phase}), flush=True)
    del srv, params
    gc.collect()
    torch.cuda.empty_cache()
    return launches


def view_timing(torch, engine):
    """Device ms of the paged decode's per-chunk memory traffic at the
    largest view (8 slots x 128 pages, each slot's own pages): the gather
    into the [8, 2049] view, and one chunk of write-backs (decode_chunk
    steps of 8 tokens), each against its HBM bound (every byte read once
    and written once, over 3.35 TB/s)."""
    from runbooks_tpu_torch.serve import paging
    from runbooks_tpu_torch.utils.hw import H100_HBM_BW

    pool = engine.cache
    L, _, ps, kvh, d = pool.k.shape
    B, vp = engine.max_slots, engine.view_page_buckets[-1]
    dev = pool.k.device
    tables = (torch.arange(B * engine.pages_per_slot, dtype=torch.int32,
                           device=dev).view(B, -1) % engine.num_pages)
    with torch.no_grad():
        gather_ms = cuda_ms(lambda: paging.gather_view(pool, tables, vp), 20)
        view = paging.gather_view(pool, tables, vp)
        pos = torch.full((B,), 100, dtype=torch.int32, device=dev)
        live = torch.ones(B, dtype=torch.bool, device=dev)

        def chunk():
            # The view holds the pages' own values, so this rewrites the
            # pool with what it holds.
            for k in range(engine.decode_chunk):
                paging.write_back(pool, view, tables, pos + k, live)

        write_ms = cuda_ms(chunk, 20)
    esz = pool.k.element_size()
    gather_bytes = 2 * 2 * L * B * (vp * ps + 1) * kvh * d * esz
    write_bytes = 2 * 2 * engine.decode_chunk * L * B * kvh * d * esz
    del view
    return {"view_tokens": vp * ps, "gather_ms": gather_ms,
            "gather_bytes": gather_bytes,
            "gather_bound_ms": gather_bytes / H100_HBM_BW * 1e3,
            "write_back_chunk_ms": write_ms,
            "write_back_chunk_bytes": write_bytes,
            "write_back_bound_ms": write_bytes / H100_HBM_BW * 1e3}


def paged_vs_dense(torch, cfg, params, seed, launches):
    """Phase 12 (a): phase 4's 8 requests through the dense engine and the
    paged one (1024 pages of 16), both warmed up and both resident, run in
    the order dense, paged, paged, dense so that host drift falls on both
    sides. Returns the paged engine and its dispatch samples."""
    from runbooks_tpu_torch.serve.paging import PagedInferenceEngine

    prompts = smoke_prompts(seed)
    engines = {name: warm_engine(torch, cfg, params, seed, cls=cls)
               for name, cls in (("dense", None),
                                 ("paged", PagedInferenceEngine))}
    runs = {"dense": [], "paged": []}
    steps = {"dense": [], "paged": []}
    ids = {}
    for name in ("dense", "paged", "paged", "dense"):
        engine, samples, warm_s = engines[name]
        # An empty radix tree for every run: a repeat would otherwise
        # prefill only the prompts' last pages.
        engine.reset()
        reqs = smoke_requests(prompts, {})
        engine.ttft_seconds.clear()
        torch.cuda.reset_peak_memory_stats()
        st, run_ids = timed_generate(torch, engine, samples, reqs)
        steps[name] += samples.get("decode", [])
        st.update(warmup_s=warm_s,
                  ttft_s_median=median(list(engine.ttft_seconds)),
                  max_memory_allocated_gb=(
                      torch.cuda.max_memory_allocated() / 1e9))
        if not all(len(x) == MAX_TOKENS for x in run_ids):
            raise SystemExit(f"paged (a) {name}: not every request got "
                             f"{MAX_TOKENS} tokens: {st}")
        ids.setdefault(name, run_ids)
        runs[name].append(st)
        launches[f"paged_a_{name}"] = st["flash_fwd_launches"]
    free_engine(torch, engines["dense"][0])
    engine, samples, _ = engines["paged"]
    stats = {name: {"runs": runs[name],
                    "median_decode_step_ms_all_runs":
                        median(steps[name]) * 1000}
             for name in runs}
    stats["paged"]["kv_occupancy"] = engine.kv_occupancy()
    stats["paged"]["view_traffic"] = view_timing(torch, engine)
    print("paged (a) " + json.dumps(stats), flush=True)
    per_run = {st["flash_fwd_launches"] for r in runs.values() for st in r}
    if len(per_run) != 1:
        raise SystemExit(f"paged (a): K1 launched {per_run} times per run; "
                         "the paged prefill must launch it as the dense one")
    for i in range(0, len(prompts), 2):      # the greedy requests
        near_tie_check(torch, cfg, params, f"paged (a) request r{i}: "
                       "greedy ids dense vs paged", prompts[i],
                       ids["dense"][i], ids["paged"][i])
    return engine, samples


def radix_phase(torch, cfg, params, engine, samples, seed, launches):
    """Phase 12 (b): phase 10's 1024-token prefix and its 8 prompts on the
    paged engine, without POST /v1/prefix: once on an empty tree, once
    after one request of the prefix alone has finished and seeded it."""
    from runbooks_tpu_torch.ops.flash_attention import fwd_tile_counts
    from runbooks_tpu_torch.serve.engine import Request, bucket_for
    from runbooks_tpu_torch.train.data import ByteTokenizer

    tok = ByteTokenizer()
    prefix_text, texts = prefix_prompts(seed)
    prefix_ids = tok.encode(prefix_text, add_eos=False)
    prompts = [tok.encode(t, add_eos=False) for t in texts]
    dispatch_pos, first_logits = [], {}
    prefill = engine._paged_prefill

    def recording_prefill(params_, pool, tokens, positions, dest, last_pos,
                          *args, prefix_len=None, **kw):
        dispatch_pos.append(positions.clone())
        first, pool, logits = prefill(params_, pool, tokens, positions, dest,
                                      last_pos, *args, prefix_len=prefix_len,
                                      **kw)
        plens = (prefix_len.tolist() if prefix_len is not None
                 else [0] * tokens.shape[0])
        toks, pos0 = tokens.tolist(), positions[:, 0].tolist()
        for r, m in enumerate(x + 1 for x in last_pos.tolist()):
            row = prefix_ids[:plens[r]] + toks[r][:m]
            if pos0[r] != engine._pad_slot and row in prompts:
                first_logits[prompts.index(row)] = logits[r].float().clone()
        return first, pool, logits

    engine._paged_prefill = recording_prefill
    runs, run_ids, run_logits = {}, {}, {}
    try:
        for name in ("no_seed", "seed"):
            engine.reset()
            if name == "seed":
                with torch.no_grad():
                    engine.generate([Request(prompt_tokens=prefix_ids,
                                             max_tokens=1)])
            dispatch_pos.clear()
            first_logits.clear()
            engine.ttft_seconds.clear()
            reused0 = engine.pager.pages_reused_total
            fwd_tile_counts()
            reqs = [Request(prompt_tokens=p, max_tokens=MAX_TOKENS)
                    for p in prompts]
            st, run_ids[name] = timed_generate(torch, engine, samples, reqs)
            st.update(
                kv_tiles_card=fwd_tile_counts()[0],
                kv_tiles_predicted=sum(
                    cfg.num_layers * cfg.num_heads * tile_counts(
                        torch, pos, torch.arange(
                            2049, dtype=torch.int32,
                            device=pos.device)[None].expand(
                                pos.shape[0], 2049), None, None, False)[0]
                    for pos in dispatch_pos),
                prefill_dispatches=len(dispatch_pos),
                pages_reused=engine.pager.pages_reused_total - reused0,
                ttft_s_median=median(list(engine.ttft_seconds)),
                ttft_s_max=max(engine.ttft_seconds))
            launches[f"paged_b_{name}"] = st["flash_fwd_launches"]
            runs[name] = st
            run_logits[name] = dict(first_logits)
    finally:
        engine._paged_prefill = prefill
    print("paged (b) " + json.dumps(runs), flush=True)
    want = len(prompts) * PREFIX_LEN // PAGE_SIZE
    ok = (runs["seed"]["pages_reused"] == want
          and all(r["kv_tiles_card"] == r["kv_tiles_predicted"]
                  for r in runs.values()))
    print(f"paged (b): pages reused {runs['seed']['pages_reused']} (want "
          f"{want}); K1 kv tiles on the card equal fwd_tile_plan's -> "
          f"{'ok' if ok else 'FAIL'}", flush=True)
    if not ok:
        raise SystemExit("paged (b): radix sharing failed its counts")
    with torch.no_grad():
        for i, p in enumerate(prompts):
            full = prefill_logits(torch, cfg, params, p,
                                  bucket_for(engine.prefill_buckets, len(p)),
                                  2048).float()
            for name, got in run_logits.items():
                if i not in got:
                    raise SystemExit(f"paged (b) {name}: no prefill logits "
                                     f"for prompt {i}")
                gap_check(f"paged (b) prompt {i} ({len(p)} tokens), "
                          f"{name}: first-token logits vs a full prefill",
                          got[i], full)
    for i, p in enumerate(prompts):
        near_tie_check(torch, cfg, params, f"paged (b) prompt {i}: greedy "
                       "ids without vs with the seed", p,
                       run_ids["no_seed"][i], run_ids["seed"][i])


def swap_timing(torch, cfg, engine):
    """Per-page swap ms each way over SWAP_TIMED_PAGES pages of the
    engine's pool (pinned host buffers; a swap-out waits for its copy, the
    swap-ins are timed to one synchronize after the last), and whether
    every page came back bit-identical in another page."""
    from runbooks_tpu_torch.serve import paging

    pool = engine.cache
    n = SWAP_TIMED_PAGES
    host = paging.HostPagePool(cfg, n, PAGE_SIZE, pin_memory=True)
    out_fn, in_fn = paging.make_kv_swap_out_fn(), paging.make_kv_swap_in_fn()
    slots = [host.alloc() for _ in range(n)]
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for h, page in zip(slots, range(n)):
        host.store(h, *out_fn(pool, page))
    out_ms = (time.perf_counter() - t0) * 1e3 / n
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for h, page in zip(slots, range(n, 2 * n)):
        in_fn(pool, page, *host.load(h))
    torch.cuda.synchronize()
    in_ms = (time.perf_counter() - t0) * 1e3 / n
    same = all(torch.equal(pool.k[:, p], pool.k[:, p + n])
               and torch.equal(pool.v[:, p], pool.v[:, p + n])
               for p in range(n))
    return {"pages": n, "bytes_per_page": host.bytes_per_page,
            "swap_out_ms_per_page": out_ms, "swap_in_ms_per_page": in_ms,
            "swap_out_gb_per_s": host.bytes_per_page / out_ms / 1e6,
            "swap_in_gb_per_s": host.bytes_per_page / in_ms / 1e6,
            "pcie_gen5_x16_gb_per_s": PCIE_GEN5_X16 / 1e9,
            "round_trip_bit_identical": same}


def host_tier_phase(torch, cfg, params, seed, launches):
    """Phase 12 (c): a 1024-token session finishes, two 2000-token
    requests evict its pages, and its next turn comes back: with a host
    tier of 256 pages (swapped out, then in) and with none (recomputed),
    each engine of 256 device pages warmed up."""
    from runbooks_tpu_torch.ops.flash_attention import flash_attention
    from runbooks_tpu_torch.serve.engine import Request
    from runbooks_tpu_torch.serve.paging import PagedInferenceEngine
    from runbooks_tpu_torch.train.data import ByteTokenizer

    prefix_text, _ = prefix_prompts(seed)
    session = ByteTokenizer().encode(prefix_text, add_eos=False)
    others = seeded_prompts(seed + 12, (OTHER_LEN, OTHER_LEN))
    follow_up = seeded_prompts(seed + 13, (16,))[0]
    runs, turn2 = {}, {}
    prompt2 = None
    for name, host_pages in (("host", HOST_PAGES), ("recompute", 0)):
        engine, _, warm_s = warm_engine(
            torch, cfg, params, seed, cls=PagedInferenceEngine,
            num_pages=HOST_PAGES, kv_host_pages=host_pages)
        flash_attention.launches = 0
        with torch.no_grad():
            t1 = Request(prompt_tokens=session, max_tokens=16)
            engine.generate([t1])
            engine.generate([Request(prompt_tokens=p, max_tokens=OTHER_NEW)
                             for p in others])
            mid = engine.pager.occupancy()
            # Both engines take the first one's next turn: the session,
            # its reply, and a follow-up.
            if prompt2 is None:
                prompt2 = session + t1.output_tokens + follow_up
            t2 = Request(prompt_tokens=prompt2, max_tokens=MAX_TOKENS)
            engine.ttft_seconds.clear()
            engine.generate([t2])
        torch.cuda.synchronize()
        launches[f"paged_c_{name}"] = flash_attention.launches
        st = {"warmup_s": warm_s, "turn2_ttft_s": engine.ttft_seconds[-1],
              "turn2_prompt_tokens": len(t2.prompt_tokens),
              "occupancy_before_turn2": mid,
              "occupancy_after": engine.pager.occupancy(),
              "swap_out_host_ms_median": (
                  median(list(engine.swap_seconds["out"])) * 1e3
                  if engine.swap_seconds["out"] else None),
              "swap_in_host_ms_median": (
                  median(list(engine.swap_seconds["in"])) * 1e3
                  if engine.swap_seconds["in"] else None),
              "flash_fwd_launches": flash_attention.launches}
        turn2[name] = t2.output_tokens
        if host_pages:
            st["swap_timing"] = swap_timing(torch, cfg, engine)
        runs[name] = st
        free_engine(torch, engine)
    print("paged (c) " + json.dumps(runs), flush=True)
    host = runs["host"]
    pages = PREFIX_LEN // PAGE_SIZE
    ok = (host["occupancy_before_turn2"]["swap_out_pages_total"] >= pages
          and host["occupancy_after"]["swap_in_pages_total"] >= pages
          and host["swap_timing"]["round_trip_bit_identical"]
          and len(turn2["host"]) == MAX_TOKENS)
    print(f"paged (c): swapped out "
          f"{host['occupancy_before_turn2']['swap_out_pages_total']}, in "
          f"{host['occupancy_after']['swap_in_pages_total']} (want >= "
          f"{pages} each); round trip bit-identical "
          f"{host['swap_timing']['round_trip_bit_identical']} -> "
          f"{'ok' if ok else 'FAIL'}", flush=True)
    if not ok:
        raise SystemExit("paged (c): the host tier failed its counts")
    near_tie_check(torch, cfg, params, "paged (c) turn 2: greedy ids "
                   "swapped in vs recomputed", prompt2, turn2["host"],
                   turn2["recompute"])


def preemption_phase(torch, cfg, params, seed, launches):
    """Phase 12 (d): 8 batch requests of PREEMPT_NEW new tokens fill the
    slots, and 4 interactive requests arrive two steps later; preemption
    on ("swap") and off on one warmed-up engine of 512 pages with a host
    tier (the knob is read at each admission)."""
    from runbooks_tpu_torch.ops.flash_attention import flash_attention
    from runbooks_tpu_torch.serve.engine import Request
    from runbooks_tpu_torch.serve.paging import PagedInferenceEngine

    batch_prompts = seeded_prompts(seed + 14, (PREEMPT_BATCH_LEN,) * 8)
    inter_prompts = seeded_prompts(seed + 15,
                                   (PREEMPT_INTERACTIVE_LEN,) * 4)
    engine, _, warm_s = warm_engine(
        torch, cfg, params, seed, cls=PagedInferenceEngine,
        num_pages=PREEMPT_PAGES, kv_host_pages=HOST_PAGES,
        preemption="swap")
    runs, ids, reasons = {}, {}, {}
    for mode in ("swap", "off"):
        engine.reset()
        engine.preemption = mode
        counts0 = (engine.preemptions, engine.preempted_resumed)
        first = {}
        batch = [Request(prompt_tokens=p, max_tokens=PREEMPT_NEW,
                         priority="batch") for p in batch_prompts]
        inter = [Request(prompt_tokens=p, max_tokens=MAX_TOKENS,
                         priority="interactive",
                         on_token=(lambda t, i=i: first.setdefault(
                             i, time.perf_counter())))
                 for i, p in enumerate(inter_prompts)]
        flash_attention.launches = 0
        t0 = time.perf_counter()
        with torch.no_grad():
            for r in batch:
                engine.submit(r)
            engine.step()
            engine.step()
            t_inter = time.perf_counter()
            for r in inter:
                engine.submit(r)
            while engine.has_work():
                engine.step()
        torch.cuda.synchronize()
        launches[f"paged_d_{mode}"] = flash_attention.launches
        ttft = sorted(first[i] - t_inter for i in range(len(inter)))
        runs[mode] = {
            "wall_s": time.perf_counter() - t0,
            "interactive_ttft_s_median": ttft[len(ttft) // 2],
            "interactive_ttft_s_max": ttft[-1],
            "preemptions": engine.preemptions - counts0[0],
            "preempted_resumed": engine.preempted_resumed - counts0[1],
            "batch_tokens": sum(len(r.output_tokens) for r in batch),
            "flash_fwd_launches": flash_attention.launches,
            "occupancy": engine.pager.occupancy()}
        ids[mode] = [r.output_tokens for r in batch]
        reasons[mode] = [r.finish_reason for r in batch + inter]
    free_engine(torch, engine)
    runs["warmup_s"] = warm_s
    print("paged (d) " + json.dumps(runs), flush=True)
    on = runs["swap"]
    ok = (on["preemptions"] >= 1
          and on["preempted_resumed"] == on["preemptions"]
          and runs["off"]["preemptions"] == 0
          and reasons["swap"] == reasons["off"] == ["length"] * 12)
    print(f"paged (d): {on['preemptions']} preemptions, "
          f"{on['preempted_resumed']} resumed; finish reasons unchanged "
          f"-> {'ok' if ok else 'FAIL'}", flush=True)
    if not ok:
        raise SystemExit("paged (d): preemption failed its counts")
    for i, p in enumerate(batch_prompts):
        near_tie_check(torch, cfg, params, f"paged (d) batch request {i}: "
                       "greedy ids with vs without preemption", p,
                       ids["swap"][i], ids["off"][i])


def paged_http(torch, cfg, params, launches):
    """Phase 12 (e): create_server(kv_paging=True, kv_host_pages=256,
    preemption="swap") answers an X-Priority: interactive completion."""
    from runbooks_tpu_torch.ops.flash_attention import flash_attention
    from runbooks_tpu_torch.serve.api import create_server

    t0 = time.perf_counter()
    srv = create_server(cfg, params, host="127.0.0.1", port=0, max_slots=8,
                        max_seq_len=2048, warmup=True, kv_paging=True,
                        kv_host_pages=HOST_PAGES, preemption="swap")
    ready_s = time.perf_counter() - t0
    thread = threading.Thread(target=srv.serve_forever, daemon=True)
    thread.start()
    engine = srv.worker.engine
    seen = []
    submit = engine.submit

    def recording_submit(req):
        seen.append(req.priority)
        submit(req)

    engine.submit = recording_submit
    body = {"prompt": " ".join(["the paged engine serves"] * 20),
            "max_tokens": MAX_TOKENS, "temperature": 0}
    try:
        flash_attention.launches = 0
        status, _, text, first_s = http_call(
            f"http://127.0.0.1:{srv.port}", "/v1/completions", body,
            {"X-Priority": "interactive"})
        launches["paged_http"] = flash_attention.launches
        occ = engine.kv_occupancy()
    finally:
        srv.shutdown()
        thread.join(timeout=60)
    ok = (status == 200 and seen == ["interactive"]
          and type(engine).__name__ == "PagedInferenceEngine"
          and json.loads(text)["choices"][0]["finish_reason"] == "length"
          and launches["paged_http"] >= cfg.num_layers)
    print("paged (e) " + json.dumps({
        "ready_s": ready_s, "status": status, "wall_s": first_s,
        "priorities": seen, "pages_total": occ["pages_total"],
        "host_pages_total": occ["host_pages_total"],
        "kv_pool_bytes": occ["kv_pool_bytes"],
        "flash_fwd_launches": launches["paged_http"]}) + " -> "
        + ("ok" if ok else "FAIL"), flush=True)
    if not ok:
        raise SystemExit(f"paged (e): {status} {text[:300]}")
    del srv, engine
    gc.collect()
    torch.cuda.empty_cache()


def paged_phase(torch, seed):
    """Phase 12: paged serving of llama3-8b bf16 at full width and depth
    (max_slots 8, max_seq_len 2048, pages of 16, every engine warmed up).
    Returns K1's launches by run."""
    from runbooks_tpu_torch.serve.api import load_model

    t_phase = time.perf_counter()
    cfg, params = load_model({"model": "llama3-8b",
                              "model_overrides": {"param_dtype": "bfloat16"},
                              "seed": seed})
    launches = {}
    engine, samples = paged_vs_dense(torch, cfg, params, seed, launches)
    radix_phase(torch, cfg, params, engine, samples, seed, launches)
    free_engine(torch, engine)
    del engine
    host_tier_phase(torch, cfg, params, seed, launches)
    preemption_phase(torch, cfg, params, seed, launches)
    paged_http(torch, cfg, params, launches)
    if min(launches.values()) < cfg.num_layers:
        raise SystemExit(f"phase 12 ran K1 too rarely: {launches}")
    print("phase 12 " + json.dumps({
        "flash_fwd_launches": launches,
        "seconds": time.perf_counter() - t_phase}), flush=True)
    del params
    gc.collect()
    torch.cuda.empty_cache()
    return launches


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
        entry = ""
        for line in cuda_build.build_report(name).splitlines():
            if "Compiling entry function" in line:
                m = re.search(r"([a-z_]+kernel)ILi(\d+)E", line)
                entry = f"{m.group(1)} d={m.group(2)}" if m else ""
            if "registers" in line or "spill" in line:
                print(f"  ptxas {name} {entry}: {line.strip()}", flush=True)

    with tempfile.TemporaryDirectory(prefix="chip_smoke_") as workdir:
        # An empty contract root: load_model finds no model mount.
        os.makedirs(f"{workdir}/content")
        os.environ["RBT_CONTENT_DIR"] = f"{workdir}/content"
        data_path = f"{workdir}/docs.jsonl"
        write_train_docs(data_path, args.seed)
        batch = first_train_batch(data_path)
        records, worst = kernel_phase(torch, dev, args.seed, batch)
        gc.collect()
        torch.cuda.empty_cache()
        serve_launches = e2e_phase(torch, args.seed)
        gc.collect()
        torch.cuda.empty_cache()
        bwd_records, bwd_worst = bwd_kernel_phase(torch, dev, args.seed,
                                                  batch)
        grad_check_phase(torch, dev, args.seed, batch)
        gc.collect()
        torch.cuda.empty_cache()
        train_launches, summary, peak = train_phase(torch, dev, args.seed,
                                                    data_path, workdir)
        gc.collect()
        torch.cuda.empty_cache()
        http_launches = http_phase(torch, dev, args.seed, workdir)
        gc.collect()
        torch.cuda.empty_cache()
        t0 = time.perf_counter()
        import_launches = import_phase(torch, dev, args.seed, workdir)
        gc.collect()
        torch.cuda.empty_cache()
        build_launches, prefix_launches, no_prefix_launches = prefix_phase(
            torch, args.seed)
        print(f"phases 9 and 10 took {time.perf_counter() - t0:.1f} s",
              flush=True)
        spec_launches = spec_grammar_phase(torch, dev, args.seed)
        paged_launches = paged_phase(torch, args.seed)

    main_case = records["rows8_sq128"]
    kernels = [{
        "name": "flash_fwd",
        "route": "cuda",
        "source": "runbooks_tpu_torch/csrc/flash_fwd.cu",
        "replaces": "runbooks_tpu/ops/flash_attention.py:92",
        "launches": (serve_launches + train_launches["flash_fwd"]
                     + http_launches + import_launches + build_launches
                     + prefix_launches + no_prefix_launches
                     + sum(spec_launches.values())
                     + sum(paged_launches.values())),
        "launches_by_path": {"serve": serve_launches,
                             "train": train_launches["flash_fwd"],
                             "http": http_launches,
                             "import": import_launches,
                             "prefix_register": build_launches,
                             "prefix": prefix_launches,
                             "prefix_off": no_prefix_launches,
                             **spec_launches, **paged_launches},
        "max_abs_err": worst,
        "ms": main_case["ms"],
        "plain_ms": main_case["plain_ms"],
        "bound_ms": main_case["bound_ms"],
        "bound_by": main_case["bound_by"],
        "library_ms": main_case["library_ms"],
        "bound_ms_with_padding": main_case["bound_ms_with_padding"],
        "shape": main_case["shape"],
    }]
    suffix = records["rows8_sq128_at1024"]
    kernels[0]["suffix_shape"] = {
        k: suffix[k] for k in ("ms", "plain_ms", "bound_ms", "bound_by",
                               "library_ms", "shape")}
    fwd_train = records["a_packed_2x2048"]
    kernels[0]["train_shape"] = {
        "ms": fwd_train["ms"],
        "plain_ms": fwd_train["plain_ms"],
        "bound_ms": fwd_train["bound_ms"],
        "bound_by": fwd_train["bound_by"],
        "library_ms": fwd_train["library_ms"],
        "library_ms_causal_no_segments":
            records["b_causal_2x2048"]["library_causal_ms"],
        "shape": fwd_train["shape"]}
    train_case = bwd_records["a_packed_2x2048"]
    causal_case = bwd_records["b_causal_2x2048"]
    library = causal_case["library_ms"]
    for name, line in (("flash_bwd_dq", 280), ("flash_bwd_dkv", 337)):
        bound_ms, bound_by, _ = train_case["bounds"][name]
        kernels.append({
            "name": name,
            "route": "cuda",
            "source": "runbooks_tpu_torch/csrc/flash_bwd.cu",
            "replaces": f"runbooks_tpu/ops/flash_attention.py:{line}",
            "launches": train_launches[name],
            "launches_by_path": {"train": train_launches[name]},
            "max_abs_err": bwd_worst[name],
            "ms": train_case["ms"][name],
            "plain_ms": train_case["plain_ms"],
            "plain_ms_covers": "flash_attention_bwd_reference: dq, dk, dv",
            "bound_ms": bound_ms,
            "bound_by": bound_by,
            "library_ms": library,
            "library_ms_covers": ("backward of scaled_dot_product_attention"
                                  "(is_causal, enable_gqa) at "
                                  "b_causal_2x2048: dq, dk, dv together"),
            "shape": train_case["shape"],
            "card_tiles_computed_open": train_case["card_tiles"][name],
            "causal_shape": {
                "ms": causal_case["ms"][name],
                "bound_ms": causal_case["bounds"][name][0],
                "library_ms": library,
                "card_tiles_computed_open": causal_case["card_tiles"][name],
                "shape": causal_case["shape"]},
        })
    print(f"train summary: tokens/s {summary['tokens_per_sec']:.1f} | "
          f"history {json.dumps(summary['history'])} | peak memory "
          f"{peak / 1e9:.2f} GB", flush=True)
    print(card_line(), flush=True)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
