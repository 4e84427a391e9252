#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py [--seed N] [--trace-remat]

Phases, each of which fails the run (nonzero exit) when it fails:

1. Environment: the card's name and power limit, torch and jinja2
   versions (chat templates render with jinja2, which torch requires),
   device count; TF32 is switched off for matmuls and convolutions.
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
   scaled_dot_product_attention as the yardstick (causal at (b), masked
   with enable_gqa at every case). The (q tile, kv tile)
   pairs each kernel counts as computed and open on the card must be the
   ones fwd_tile_plan predicts at the backward's tiles.
6. Full-width gradient check: llama3-8b cut to GRAD_LAYERS, one LoRA
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
   It runs with RBT_TRACE=1, and its telemetry is held to gates: a
   ``POST /debug/profile?seconds=2`` taken while a 1500-token request
   prefills and decodes writes a Chrome trace whose device kernels
   include K1's symbol, and a second POST meanwhile gets 409; that
   request's ``/debug/flight`` timeline reads queue_wait, prefill, decode;
   trace.jsonl parses line by line; ``/metrics`` passes the reference's
   exposition lint, and its request, token and TTFT counts equal what was
   sent and answered, with no kernel build after warmup; ``/debug/memory``
   charges the weights group exactly the saved parameters' bytes and the
   KV group exactly the cache's, and the allocator gauge agrees with
   ``torch.cuda.memory_allocated()`` within 1%; ``/debug/programs`` lists
   every prefill shape warmup dispatched and each decode view's program
   with FLOPs within 2% of the analytic count; ``POST /debug/incident``
   writes one bundle and a second within the debounce none.
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
11. Speculation and grammar: llama3-8b bf16 at full width cut to
   SERVE_LAYERS (4) layers,
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
12. Paged serving: llama3-8b bf16 at full width cut to SERVE_LAYERS,
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
13. Multi-tenant LoRA: llama3-8b bf16 at full width cut to
   SERVE_LAYERS, four
   tenants' adapters written with ``save_adapter`` (attention targets;
   three at rank 16 and alpha 32, one at rank 8 and alpha 16, B seeded
   non-zero). (a) A pooled ``InferenceEngine(adapter_pool=4,
   lora_rank=16, max_slots=8, max_seq_len=2048)`` and a no-pool one, both
   warmed up and resident, run no-pool, pooled, pooled, no-pool twice on 8
   greedy prompts of 150-250 tokens (two rows each for tenants 0 and 1,
   one each for tenants 2 and 3, two base-only rows), 32 new tokens: one
   prefill dispatch carries every tenant's lane, K1's launches equal the
   no-pool run's, base-only rows give the no-pool ids with bit-identical
   first-token logits, some tenant's ids differ from the base's, and each
   tenant's ids equal those of a dedicated engine over its folded weights
   up to near-ties; decode tokens/s both ways, kernel launches and
   device busy ms per decode forward both ways (torch.profiler over one
   decode chunk), the delta's ms per decode forward (CUDA events, and
   the profiler's device busy time) against its HBM bound, pool bytes
   and peak memory. (b) A 2-lane pool, the 4 tenants in a fixed rotation one
   request at a time: loads, evictions and hits as the LRU predicts, the
   pool's storage unmoved; each tenant's artifact read and lane write (ms
   against its PCIe bound). (c) ``PagedInferenceEngine`` with the same
   pool and mix: ids equal (a)'s up to near-ties, the same prompt under
   another adapter reuses no page, the tenant's next turn reuses its own,
   and with ``preemption="swap"`` a preempted tenant row waits with its
   lane pinned and resumes. (d) ``speculative="ngram"`` on the pooled
   engine: ids equal (a)'s up to near-ties, the accept rate. (e)
   ``create_server(adapter_pool=4, adapter_dir=...)``: ``"adapter":
   "tenant0"`` answers 200 with (a)'s ids, an unknown adapter 400.
14. Quantized serving: llama3-8b at full width cut to QUANT_LAYERS (4)
   layers from the seed, bf16 activations. (a) ``quantized_matmul`` at
   int8 and int4 on x [8, 4096] and [2048, 4096] through ``wi_gate``
   (4096 -> 14336) and x [8, 14336] and [2048, 14336] through the MLP
   ``wo``, within QMM_TOL of
   ``x.float() @ dequantize(w)``; its time against its bound (bytes over
   HBM at 8 rows, operations over the bf16 peak at 2048) and against
   ``torch.matmul`` on the bf16 dequantized weight (a yardstick). (b)
   ``quantize_params`` on the card at int8 and int4: seconds, peak
   memory, weight bytes and each tree's decode HBM bound. (c) Phase 4's
   mix through four warmed-up ``InferenceEngine(max_slots=8,
   max_seq_len=2048)``: int8 weights (int8 KV by default), int4 weights
   with int8 KV, bf16 weights with ``quantize_kv=True``, bf16; greedy
   ids of the quantized-weight engines equal those of a bf16-KV engine
   over their own dequantized weights up to near-ties, the int8-KV
   engine's the baseline's; first-token logits of every engine's own
   dispatches within LOGIT_TOL of a full prefill; K1's launches equal;
   cache bytes as reckoned; decode tokens/s, launches and device ms per
   decode forward, peak memory. (d) ``PagedInferenceEngine`` on the int8
   tree with int8 pages: ids equal (c)'s int8 engine's up to near-ties,
   K1's launches equal; int8 pages with their scales through the pinned
   host tier bit-identical, swap ms and GB/s. (e) Phase 13's four tenants
   in a pool over the int8 base: base-only rows give the no-pool int8
   engine's ids and bit-identical first-token logits, every tenant row
   differs. (f) Phase 9's directory imported with ``quantize: int8`` by
   ``python -m runbooks_tpu_torch.models.loader``: ``load_model``
   restores it packed, every leaf bit-equal to the source quantized in
   memory, the same greedy ids; and ``model_overrides: {"quantize":
   "int8"}`` serves int8 weights over an int8 cache.

15. The text path: (a) two tokenizer directories written from the seed
   and the checkout's own *.md/*.py text: a llama3-style byte-level BPE
   (the 256 byte symbols and 127,744 merges, llama3's split pattern and
   TemplateProcessing, 256 specials named as llama3 names them,
   llama3-instruct's chat template) and a llama2-style byte-fallback BPE
   of 32,000 tokens with llama2-chat's template. (b) On >= 4 MB of that
   text plus seeded CJK, Hangul, Greek, Cyrillic, emoji and digits: load
   seconds, encode MB/s and tokens/s, decode MB/s and decode(encode(t))
   == t on every document with both (U+2581 comes back as a space from
   the sentencepiece one); ``TokenVocab.from_tokenizer`` seconds at
   128,256 and one JSON-schema DFA's compile seconds. (c) ``python -m
   runbooks_tpu_torch.train.dataset_loader`` copies a local .jsonl and a
   file:// URL of another; its manifest's rows and bytes match the files.
   (d) ``run_training``: llama3-8b at full width cut to 4 layers, LoRA
   rank 16, seq 2048, batch 8 in 4 microbatches, over the loader's
   directory through the llama3-style tokenizer, 3 steps at prefetch
   depth 0 and 3 at depth 2: the first batch is the documents' encodings
   as pack_documents packs them, losses finite, data-wait seconds per
   step, tokens/s and K1/K2/K3 launches. (e) ``python -m
   runbooks_tpu_torch.serve.api`` with ``tokenizer:`` the llama3-style
   directory over phase 9's import: a greedy /v1/chat/completions on a
   templated prompt of up to 2000 tokens (its prompt ids are
   encode(apply_chat_template(...)), its text the decode of
   ``InferenceEngine.generate``'s ids), the same request streamed (the
   deltas add up to the text; TTFT), a response_format request (every
   token legal under the 128,256-wide TokenVocab, the JSON valid), K1's
   launches from the server's exit line; then llama2-7b at full width cut
   to 2 layers with seeded weights behind ``create_server`` under the
   llama2-style tokenizer: streamed equals unstreamed.
16. The non-Llama dense families: (a) K1 against its plain version at
   falcon-7b's serving burst (71 query heads on 1 kv head, d 64), its
   training microbatch (packed and causal), falcon-40b's 128 on 8 and
   OPT's 12 on 12, and K2/K3 at falcon-7b's microbatch (K3 walks 71 heads
   a block), with times, bounds, rates, the plain versions' times, SDPA
   with enable_gqa as the yardstick and tiles as fwd_tile_plan's; (b)
   falcon-7b bf16 at full width cut to FALCON_SERVE_LAYERS: prefill
   logits through K1 against the plain attention, phase 4's mix through
   the dense and the paged engine (greedy ids equal up to near-ties, K1
   launches equal); (c) examples/falcon-7b-instruct/finetuned-model.yaml's
   LoRA job on the f32 base at full width cut to FALCON_TRAIN_LAYERS, 2
   steps and a resume, then one traced step (idle share); (d) two HF
   falcon directories (7b-style
   fused MQA with one norm, 40b-style with 8 kv heads and split norms;
   BF16, two shards, full width, 7b at 2 layers and 40b at 1 since
   phase 23) through ``python -m runbooks_tpu_torch.models.loader``,
   every leaf bit-equal to the source taken apart by hand, the 7b import
   served; (e) ``python -m
   runbooks_tpu_torch.serve.api`` serving opt-125m and gpt2 at full size
   from bf16 checkpoints on the model mount, greedy answers equal to this
   process's decode (gpt2's longest within 5 positions of its 1024-row
   table), exit 0 on SIGTERM.
17. The rest of the fine-tune entry point: (a) phase 16 (c)'s falcon-7b
   LoRA job at full width cut to REMAT_LAYERS for 2 steps under each
   remat policy (nothing_saveable, dots_with_no_batch_dims_saveable,
   dots_saveable, save_attn_out) over one seeded base: step seconds,
   tokens/s, MFU, peak memory, K1 8 launches a layer a step (4 under
   save_attn_out, whose backward takes K1's saved out and lse), K2 and
   K3 4, finite losses,
   step 1's loss equal under every policy (with --trace-remat, one
   traced step per policy: device busy, idle share, K1-K3 device ms);
   (b) on falcon-7b cut to 2
   layers: RBT_FAULT_INJECT's kill (the rerun's adapter bit-equal to an
   uninterrupted run's), sigterm (exit code 42), nonfinite (the adapter
   bit-unchanged, the run goes on) and nonfinite from a step on (abort),
   and the maintenance poller against a local metadata fake (42); (c)
   ``python -m runbooks_tpu_torch.train.trainer`` twice over one
   artifacts directory: the cold process runs nvcc for every kernel into
   <artifacts>/kernel_cache (seconds recorded), the warm one none, each
   one's time to its first step; (d) an OPT-style vocab.json + merges.txt
   (50,265 ids) with the ids of a tokenizer.json of the same BPE on
   phase 15's corpus and opt-125m served through both alike, and a
   sentencepiece tokenizer.model of phase 15's 32,000 llama2-style
   pieces with the ids of the tokenizer.json built from the same pieces.
   (a') (a)'s nothing_saveable job for 3 steps under
   RBT_PROFILE_AT_STEP=2:1: the capture names K1, K2 and K3 with one
   step's launches (8 / 4 / 4 a layer), metrics.json carries goodput in
   (0, 1], train_step_seconds counts the steps after the first, step 1's
   loss is bit-equal to (a)'s, and the step program's counted FLOPs and
   analytic MFU are recorded.
18. What the telemetry costs (measured, not gated): llama3-8b bf16 at
   full width cut to SERVE_LAYERS; the seconds the first-dispatch
   counting adds to a warmup; decode tokens/s of a ``create_server`` in
   this process under RBT_FLIGHT=0, the default and RBT_TRACE=1,
   interleaved twice; the scrape's milliseconds; and the gate that the
   allocator gauge equals ``torch.cuda.memory_allocated()`` within 1%.
19. The gateway (``runbooks_tpu_torch/serve/gateway.py``) and the fleet
   history (``obs/history.py``) on llama3-8b bf16 at full width cut to
   SERVE_LAYERS: (a) three paged engines behind the in-process Router,
   bench_serve.py's routing traffic (8 tenants with 2-page prefixes, 4
   waves) under "prefix" and under "random": pages reused (equal to the
   CPU's count at the debug config, prefix above random), K1's launches,
   TTFT, tokens/s, greedy ids as each prompt served alone; (b) two
   ``create_server`` replicas behind ``python -m
   runbooks_tpu_torch.serve.gateway``: answers equal to direct calls, a
   session on its ring owner, SSE relayed, /v1/prefix on both, one
   request id in both flight rings, the gateway's exposition lint, no
   kernel build under routed traffic, the proxy's latency, draining and
   unreachable failover; (c) five scrapes into a FleetHistory: the
   windowed TTFT p90 equals the hand-computed bucket-delta quantile, and
   ``/metrics/history`` answers.
20. Tensor-parallel serving (``parallel/``, ``mesh=`` in the engines):
   (a) llama3-8b bf16 at full width cut to TP_LAYERS as two ranks in two
   processes that share this one card over gloo (gloo stages each CUDA
   collective through host memory): each rank loads only its shard
   (``load_model(shard=)``) and holds 16/4 heads, MLP 7168 and
   vocabulary 64128, its parameter bytes equal to the plan's analytic
   ones. The dense engine serves an 8-request mix (20-512
   tokens, TP_NEW new), then the paged engine the same mix behind a
   registered shared prefix; rank 0 drives, rank 1 replays. Greedy ids
   equal a single-process engine's on the same weights (or differ first
   at a near-tie), one prompt's prefill logits within TP_LOGIT_GAP, each
   planted fault (TP_FAULTS on rank 1) outside it, and each rank's K1
   launches equal the single-process run's, at local shapes. Each rank's
   peak memory, the collectives of one forward and tokens/s, labelled
   gloo over host memory on one card (not a TP speed).
   (b) NCCL at world 1 (the card's one GPU; NCCL takes one rank per GPU,
   so a multi-rank NCCL group needs two): TensorParallel's all-reduce,
   vocabulary gather and broadcast, and the engine's program-call
   exchange (``broadcast_object_list`` with ``device=``) on CUDA tensors,
   each returning its input; the mesh_tensor 1 engine equals the
   unsharded one. With two GPUs, ``python -m runbooks_tpu_torch.serve.api``
   under mesh_tensor 2 answers over HTTP and exits 0 on SIGTERM; with
   one, that it was not run, and the same command exits non-zero naming
   the device count.
21. FSDP training (``run_training(mesh=)``, parallel/sharding.Fsdp): (a)
   phase 16 (c)'s falcon-7b LoRA job (rank 16, alpha 32, global batch 8
   in 4 microbatches, seq 2048, lr 2e-5 with no warmup, f32 base) at full
   width cut to FSDP_LAYERS, as two fsdp ranks in two processes that
   share this card over gloo (started before phase 20, which runs while
   they do), against one process on the same seed and global batch.
   Gates: each step's loss and global gradient norm within
   FSDP_LOSS_RTOL of one process's; the
   LoRA tree after FSDP_STEPS steps within 2 * lr * steps of one
   process's (each Adam update moves an element by at most about lr), the
   gap printed; each rank's K1, K2 and K3 launches per step equal one
   process's; each rank's parameter bytes equal the plan's; rank 0 sends
   itself SIGTERM at the top of step FSDP_STEPS + 1 (RBT_FAULT_INJECT in
   its environment alone) and both ranks stop there with one emergency
   checkpoint and exit code 42; that two-rank checkpoint resumes in one
   process to one process's next loss and gradient norm. Each rank's
   peak and step
   seconds, labelled gloo over host memory on one card (not an FSDP
   speed). (b) NCCL at world 1: the FSDP runtime's gather,
   reduce-scatter, all-reduce and stop broadcast on CUDA tensors return
   their inputs; ``python -m runbooks_tpu_torch.train.trainer`` under
   mesh_fsdp 2 trains over NCCL where two GPUs exist, else exits 1
   naming the device count.
22. Gemma (head_dim 256, the scaled embedding, the norms' +1, the tied
   head): (a) K1 at d=256 against its plain version at gemma-7b's serving
   burst (16/16: an 8-row 128 bucket over a 2049-slot cache), gemma-2b's
   (8/1), gemma-7b's suffix prefill after a 1024-token prefix and 2 x 2048
   causal at 16/16, with phase 3's tolerances, tile counts, times, bound,
   rate and SDPA (enable_gqa) as the yardstick; K2 and K3 at d=256
   against their plain version at the training microbatch (2 x 2048,
   packed from the job's data and causal) at gemma-7b's 16/16 and
   gemma-2b's 8/1, with phase 5's tolerances, tile counts, times, bound,
   rate, and SDPA's masked backward (enable_gqa) as the yardstick; (b)
   gemma-7b bf16 at full width cut to GEMMA7B_SERVE_LAYERS from the
   seed (phase 16 (b)'s check): prefill logits through K1 against the plain attention, phase
   4's mix through the dense and the paged engine, greedy ids equal up to
   near-ties, K1's launches equal; (c) ``python -m
   runbooks_tpu_torch.serve.api`` serving gemma-2b at full size from a
   bf16 checkpoint on the model mount: greedy completions equal to this
   process's decode, one of them streamed, exit 0 on SIGTERM; then, alone
   on the card, phase 6's gradient check on gemma-2b (full width, 4
   layers) and phase 16 (c)'s LoRA job on gemma-2b at full size (18
   layers, f32 base): 2 steps with K1 launched 2 x 18 x 4 times a step
   and K2 and K3 18 x 4 each, finite losses, a resume to a third step at
   the saved step and cursor, tokens/s, MFU, peak, and one traced step
   with K2's and K3's share of device time; (d) an HF gemma-7b directory
   (llama's names, no lm_head; BF16, two shards, 2 layers at full width)
   through ``python -m runbooks_tpu_torch.models.loader``, every leaf
   bit-equal to the source taken apart by hand (the norms' +1 included),
   the import served through K1.
23. Mixtral (the MoE FFN; no kernel of its own): (a) one full-width
   layer in bf16 (8 experts of 4096 x 14336) from the seed at the serving
   burst (an 8-row 128 bucket: T 1024, capacity 320) and the decode step
   (8 slots: T 8, capacity 3): moe_block against moe_block_dense (the
   reference's one-hot formulation) with the same kept assignments in
   the same slots and outputs within MOE_LAYER_RTOL, each version's time,
   the layer's bound for that routing (the experts it reads over HBM,
   the kept assignments' operations) and the kept share; (b)
   mixtral-8x7b bf16 at full width cut to MIXTRAL_SERVE_LAYERS (phase 16
   (b)'s check): prefill logits through K1 against the plain attention,
   phase 4's mix through the dense and the paged engine at the config's
   capacity factor (K1's launches, TTFT, decode tokens/s, peak, the kept
   share of each dispatch kind), then both engines again at a capacity
   that drops nothing, greedy ids equal up to near-ties; (d) on those
   weights, one decode forward under torch.profiler: the MoE layers'
   share of its device time; (c) an HF mixtral directory (router and
   per-expert w1 / w3 / w2; BF16, two shards, 1 layer at full width)
   through ``python -m runbooks_tpu_torch.models.loader``, every leaf
   bit-equal to the source taken apart by hand, the import served
   through K1.
24. Mixtral's fine-tune (no kernel of its own; K1-K3 at llama3-8b's
   32/8 heads of 128): (a) mixtral-8x7b at full width (8 experts of
   4096 x 14336, vocab 32000), one packed 2048-token row, the MoE
   objective (CE + moe_aux_coef x the summed aux): the LoRA gradient
   (rank 16 on the attention, remat) over MIXTRAL_GRAD_LAYERS and the
   full-parameter gradient (router and experts too, no remat) at 1
   layer, each with K1-K3 and moe_block against the plain attention
   and moe_block_dense, and against K1-K3 with moe_block_dense, under
   phase 6's gates, with the kept share and the assignments routed
   differently; (b) phase 7's LoRA job on an f32 base cut to
   MIXTRAL_TRAIN_LAYERS through run_training: MIXTRAL_TRAIN_STEPS steps
   with K1-K3's launches (2·L·4, L·4, L·4 a step) and the kept share,
   a resume from the last checkpoint to one step more, tokens/s, MFU,
   peak, and one traced step: idle share, K1-K3 and the MoE's device
   time (each kernel charged to the op that launched it), and the
   logged loss against CE + aux recomputed by hand (within
   MIXTRAL_OBJECTIVE_RTOL).
25. Expert-parallel mixtral serving (``mesh_expert`` x ``mesh_tensor``;
   no kernel of its own, K1 at 16/4 local heads of 128): (a)
   mixtral-8x7b bf16 at full width cut to MIXTRAL_EP_LAYERS as four
   ranks (EP_MESH: expert 2 x tensor 2) sharing the card over gloo, each
   loading only its shard (16/4 heads, experts {0-3} or {4-7} on 7168
   MLP columns, half the vocabulary; bytes equal to the plan's); the
   dense engine serves phase 20's 8-request mix and the paged one the
   same lengths behind a registered shared prefix, rank 0 driving and
   the others replaying; gates: greedy ids equal to one process's on the
   same weights (run after the ranks end) or differing first at a
   near-tie, the longest prompt's prefill logits within EP_LOGIT_GAP and
   the two planted faults (EP_FAULTS) outside it, every rank's routing
   of that prefill identical, each rank's K1 launches equal to one
   process's; reported: peak memory per rank, one forward's collectives
   by group, the kept share, the assignments routed otherwise than in
   one process and tokens/s (gloo over host memory on one card, not an
   EP speed). (b) NCCL at world 1 under mesh_expert 1 x mesh_tensor 1:
   the serving group's f64 combine, the broadcast and the program-call
   exchange on CUDA tensors return their input, the engine under that
   mesh equals the unsharded one (mixtral at ENTRY_LAYERS), and ``python
   -m runbooks_tpu_torch.serve.api`` under mesh_expert 2 x mesh_tensor
   2 exits non-zero naming the device count (over HTTP where four GPUs
   exist).

Each phase's end prints the seconds since the start; a run still going
after WATCHDOG_S dumps every thread's stack to standard error. Checks
that only start processes and wait on them run beside this process's
own work (``Background``): phase 8 (c)'s and phase 15 (e)'s servers warm
up while the phase's in-process steps run, phase 16 (e)'s servers while
(d) imports, phase 17 (c)'s entry points while (b) and (d) run, and
phase 21 (a)'s ranks while phase 20 runs, and phase 22 (c)'s server
while (b) and (d) run (its fine-tune after the server has exited). The
times those report, and those of the steps beside them, share the host
and the card; the kernels' own timings (phases 3, 5, 14 (a), 16 (a) and
22 (a)) run alone.

The last three lines of standard output are the card's name and power
limit, the kernels' JSON record (K1, K2 and K3 at head_dim 256 rows of
their own, ``flash_fwd_d256``, ``flash_bwd_dq_d256`` and
``flash_bwd_dkv_d256``) and {"ok": true, "device": {...}};
quantized_matmul's and the MoE layer's records ({"quantized_ops": [...],
"moe_layer": {...}}: plain PyTorch, no Pallas kernel in the reference)
stand on the line before them. Without a CUDA device, or without the runbooks_tpu_torch
package beside it, the script exits nonzero and prints no result.
"""

import argparse
import atexit
import dataclasses
import faulthandler
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
# Phases 6 and 22 (c) check gradients at full width, cut to this depth.
GRAD_LAYERS = 4
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
# Phase 13 (multi-tenant LoRA): the pool, its rank bucket, the tenants'
# (rank, alpha), each prompt's tenant (None: base only), prompt lengths
# (all in the 256 bucket), new tokens, B's seeded scale, the 2-lane
# rotation's order, and the preemption run's batch rows' new tokens.
LORA_POOL = 4
LORA_RANK = 16
LORA_TENANTS = ((16, 32.0), (16, 32.0), (16, 32.0), (8, 16.0))
LORA_MIX = (0, 0, 1, 1, 2, 3, None, None)
LORA_LENS = (150, 165, 180, 195, 210, 225, 240, 250)
LORA_NEW = 32
LORA_B_STD = 0.03
LORA_ROTATION = (0, 1, 0, 2, 1, 3, 3, 0, 2, 1)
LORA_PREEMPT_NEW = 64
PCIE_GEN5_X16 = 64e9       # bytes/s in each direction
# Phase 14: quantized_matmul at llama3-8b's wi_gate and MLP wo, at decode
# and prefill rows. Its f32 partial sums run in another order than the
# oracle's single product: |err| <= QMM_TOL * max|oracle|.
QMM_MATS = (("wi_gate", 4096, 14336), ("mlp_wo", 14336, 4096))
QMM_ROWS = (8, 2048)
QMM_TOL = 1e-5
# Phases 11-13 and 18 (SERVE_LAYERS) and 14 (QUANT_LAYERS) run llama3-8b
# at full width cut in depth (8 layers until the telemetry's checks came
# in), so that the whole script, phases 17 and 18 included, stays well
# inside its 1200 s limit: phase 4 serves the full depth.
SERVE_LAYERS = 4
QUANT_LAYERS = 4
# Past this many seconds the run dumps its threads' stacks to stderr (and
# goes on), so that a run cut at the limit shows where it was.
WATCHDOG_S = 1100


T_START = time.perf_counter()


def mark(name):
    """A phase's end: the seconds since the script started."""
    print(f"{name} ended at {time.perf_counter() - T_START:.1f} s",
          flush=True)


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


def kernel_cases(torch, dev, gen, layouts):
    """K1's case layouts (fwd_case_layouts) with seeded bf16 q, k, v, one
    case at a time: (name, q, k, v, q_pos, kv_pos, q_seg, kv_seg,
    block_skip, used)."""
    for (name, (b, sq, sk, h, kvh, d), qp, kp, qs, ks, skip,
         used) in layouts:
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


def library_attention(torch, q, k, v, q_pos, kv_pos, q_seg, kv_seg,
                      gqa=False):
    """One scaled_dot_product_attention call on the same masked problem
    (the mask built beforehand; K/V repeated to the query heads, or with
    gqa read through ``enable_gqa``)."""
    import torch.nn.functional as F

    from runbooks_tpu_torch.ops.attention import make_attention_mask

    n_rep = 1 if gqa else q.shape[2] // k.shape[2]
    qt = q.transpose(1, 2).contiguous()
    kt = k.repeat_interleave(n_rep, dim=2).transpose(1, 2).contiguous()
    vt = v.repeat_interleave(n_rep, dim=2).transpose(1, 2).contiguous()
    mask = make_attention_mask(q_pos, kv_pos, q_seg, kv_seg)
    mask &= (kv_pos < 2 ** 30)[:, None, None, :]
    return lambda: F.scaled_dot_product_attention(qt, kt, vt,
                                                  attn_mask=mask,
                                                  enable_gqa=gqa)


def kernel_phase(torch, dev, seed, batch, layouts=None, gqa=False):
    """Phase 3: K1 against its plain version at every case of
    fwd_case_layouts (or ``layouts``), with its time, the plain version's,
    SDPA's on the same masked problem (``gqa``: K/V read through
    enable_gqa, not repeated; and SDPA's causal forward at the training
    shapes, names a_ and b_), the bound and the achieved rate on the
    operations the masks need. The kv tiles the card computed (its own
    count, fwd_tile_counts) must be those fwd_tile_plan predicts, for
    every head."""
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
    if layouts is None:
        layouts = fwd_case_layouts(torch, dev, batch)
    for (name, q, k, v, qp, kp, qs, ks, skip, used) in kernel_cases(
            torch, dev, gen, layouts):
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
                                               ks, gqa), 10)
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
                             tflops=tflops,
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


def prefill_logits(torch, cfg, params, prompt, bucket, max_seq_len,
                   adapters=None, tp=None):
    """Last-position logits of one prompt prefilled as the engine does:
    a [1, bucket] row, padding at the trash slot, scratch cache of
    max_seq_len + 1 positions; ``adapters`` (pool, [lane]) as the pooled
    engine passes them; ``tp``: one tensor-parallel rank's shard in
    ``params`` (the logits come back whole)."""
    from runbooks_tpu_torch.models.transformer import (
        KVCache,
        forward,
        lm_head,
    )
    from runbooks_tpu_torch.serve.engine import local_kv_heads

    dev = params["embed"].device
    m = len(prompt)
    tokens = torch.zeros((1, bucket), dtype=torch.int32, device=dev)
    tokens[0, :m] = torch.tensor(prompt, dtype=torch.int32, device=dev)
    pos = torch.full((1, bucket), max_seq_len, dtype=torch.int32,
                     device=dev)
    pos[0, :m] = torch.arange(m, dtype=torch.int32, device=dev)
    cache = KVCache.create(cfg, 1, max_seq_len, dev, trash_slot=True,
                           kv_heads=local_kv_heads(cfg, tp))
    x, _ = forward(cfg, params, tokens, positions=pos, cache=cache,
                   return_activations=True, adapters=adapters, tp=tp)
    return lm_head(cfg, params, x[:, m - 1], tp)[0]


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


def bwd_cases(torch, dev, gen, layouts):
    """The backward's case layouts (bwd_case_layouts) with seeded bf16 q,
    k, v, do, one case at a time: (name, q, k, v, do, q_pos, kv_pos, seg,
    block_skip, grad_dtype)."""
    for (name, (b, sq, sk, h, kvh, d), qp, kp, seg, skip,
         gd) in layouts:
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


def library_bwd_masked(torch, q, k, v, q_pos, kv_pos, q_seg, kv_seg, do):
    """The backward of one scaled_dot_product_attention call on the same
    masked problem (library_attention's mask; K/V read through
    enable_gqa): dq, dk and dv together."""
    import torch.nn.functional as F

    from runbooks_tpu_torch.ops.attention import make_attention_mask

    qt, kt, vt = (t.transpose(1, 2).detach().requires_grad_()
                  for t in (q, k, v))
    mask = make_attention_mask(q_pos, kv_pos, q_seg, kv_seg)
    mask &= (kv_pos < 2 ** 30)[:, None, None, :]
    out = F.scaled_dot_product_attention(qt, kt, vt, attn_mask=mask,
                                         enable_gqa=True)
    dot = do.transpose(1, 2)
    return lambda: torch.autograd.grad(out, (qt, kt, vt), dot,
                                       retain_graph=True)


def bwd_kernel_phase(torch, dev, seed, batch, layouts=None):
    """Phase 5: K2 and K3 against the plain backward at cases (a)-(f) (or
    ``layouts``; SDPA's causal backward at the case named b_, its masked
    backward at every case), with each kernel's time, the plain
    version's, the bound, the rate on the operations the masks need, and
    SDPA's backward as the library yardstick. The (q tile, kv tile)
    pairs each kernel counts as
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
    if layouts is None:
        layouts = bwd_case_layouts(torch, dev, batch)
    for (name, q, k, v, do, qp, kp, seg, skip, gd) in bwd_cases(
            torch, dev, gen, layouts):
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
        library_masked_ms = cuda_ms(library_bwd_masked(
            torch, q, k, v, qp, kp, seg, seg, do), 10)
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
              + f" | library_masked_ms SDPA masked backward (enable_gqa), "
              f"dq+dk+dv together {library_masked_ms:.4f}"
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
                             library_masked_ms=library_masked_ms,
                             bounds=bounds, card_tiles=card,
                             shape=f"q{tuple(q.shape)} k{tuple(k.shape)}")
    b = next(r for n, r in records.items() if n.startswith("b_"))
    both = sum(b["ms"].values())
    print(f"backward at (b) {b['shape']}: K2 {b['ms']['flash_bwd_dq']:.4f} "
          f"+ K3 {b['ms']['flash_bwd_dkv']:.4f} = {both:.4f} ms against "
          f"SDPA's backward {b['library_ms']:.4f} ms: "
          f"{both / b['library_ms']:.2f}x", flush=True)
    print(f"backward kernel phase peak memory "
          f"{torch.cuda.max_memory_allocated() / 1e9:.2f} GB", flush=True)
    return records, worst


def grad_gaps(torch, got, want):
    """(worst relative L2, worst cosine, worst leaf's name) of gradients
    ``got`` against ``want``, both {name: gradient}."""
    worst_l2, worst_cos, name = 0.0, 1.0, None
    for n, b in want.items():
        a, b = got[n].float().flatten(), b.float().flatten()
        rel = ((a - b).norm() / b.norm()).item()
        cos = torch.nn.functional.cosine_similarity(a, b, dim=0).item()
        if rel > worst_l2:
            name = n
        worst_l2, worst_cos = max(worst_l2, rel), min(worst_cos, cos)
    return worst_l2, worst_cos, name


def lora_grads(torch, cfg, base, lora, lora_cfg, batch):
    """(loss, [grad of each LoRA leaf]) of one loss-and-grad (an MoE
    config's objective with its moe_aux_coef x aux term)."""
    from runbooks_tpu_torch.train.lora import deltas
    from runbooks_tpu_torch.train.step import make_ce_terms, moe_aux_coef

    leaves = {t: {n: x.detach().clone().requires_grad_() for n, x in
                  ab.items()} for t, ab in lora.items()}
    ce = make_ce_terms(cfg, remat=True, loss_chunk=0)
    loss, _, aux = ce(base, batch, deltas(leaves, lora_cfg))
    if cfg.moe_num_experts:
        loss = loss + moe_aux_coef(cfg) * aux
    flat = [x for ab in leaves.values() for x in ab.values()]
    return loss.item(), torch.autograd.grad(loss, flat)


def grad_check_phase(torch, dev, seed, batch, model="llama3-8b"):
    """Phase 6 (and phase 22 (c) for gemma-2b): ``model`` at full width,
    depth cut to GRAD_LAYERS, one packed row of 2048 tokens through one
    LoRA loss-and-grad with the flash kernels (K1-K3) and with the plain
    attention under autograd. Returns the record."""
    from runbooks_tpu_torch.models.config import get_config
    from runbooks_tpu_torch.models.transformer import init_params
    from runbooks_tpu_torch.train.lora import LoraConfig, init_lora

    torch.cuda.reset_peak_memory_stats()
    cfg = get_config(model, num_layers=GRAD_LAYERS)
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
    worst_l2, worst_cos, _ = grad_gaps(torch, dict(enumerate(g_f)),
                                       dict(enumerate(g_x)))
    ok = (loss_rel <= GRAD_LOSS_RTOL and worst_l2 <= GRAD_REL_L2_TOL
          and worst_cos >= GRAD_COS_MIN)
    seconds = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated()
    print(f"full-width LoRA gradient check ({model}, {GRAD_LAYERS} layers, "
          f"1 x 2048 packed tokens, {seconds:.1f} s): loss flash "
          f"{loss_f:.6f} plain {loss_x:.6f} rel {loss_rel:.2e} (tol "
          f"{GRAD_LOSS_RTOL}) | {len(g_f)} LoRA leaves: worst rel L2 "
          f"{worst_l2:.4f} (tol {GRAD_REL_L2_TOL}) worst cosine "
          f"{worst_cos:.6f} (min {GRAD_COS_MIN}) | peak memory "
          f"{peak / 1e9:.2f} GB -> {'ok' if ok else 'FAIL'}", flush=True)
    if not ok:
        raise SystemExit(f"full-width gradient check of {model} failed")
    return {"layers": GRAD_LAYERS, "loss_flash": loss_f, "loss_plain": loss_x,
            "loss_rel": loss_rel, "worst_rel_l2": worst_l2,
            "worst_cosine": worst_cos, "seconds": seconds,
            "peak_gb": peak / 1e9}


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


def near_tie_check(torch, cfg, params, name, prompt, a, b, allowed=None,
                   adapters=None, fail=True):
    """Greedy ids a and b of one prompt are identical, or differ first at
    a near-tie: both tokens within LOGIT_TOL of the top logit of a full
    prefill of the context before them. ``allowed(ids)`` (grammar) gives
    the allowed-token row after the generated ids, and the top logit is
    then the top allowed one. ``adapters`` (pool, [lane]): the prefill
    runs through that pool lane. With ``fail`` False the verdict comes
    back (a dict) instead of ending the run."""
    from runbooks_tpu_torch.serve.engine import _buckets, bucket_for

    j = next((k for k in range(len(a)) if a[k] != b[k]), None)
    if j is None and len(a) == len(b):
        print(f"{name}: identical", flush=True)
        return {"identical": True, "ok": True}
    if j is None:
        if not fail:
            return {"identical": False, "ok": False, "lengths": (len(a),
                                                                 len(b))}
        raise SystemExit(f"{name}: {len(a)} vs {len(b)} tokens")
    ctx = list(prompt) + a[:j]
    with torch.no_grad():
        plain = prefill_logits(torch, cfg, params, ctx,
                               bucket_for(_buckets(2048), len(ctx)), 2048,
                               adapters)
    if allowed is not None:
        plain = plain.masked_fill(~torch.as_tensor(
            allowed(a[:j]), device=plain.device), float("-inf"))
    top = plain.max().item()
    gaps = (top - plain[a[j]].item(), top - plain[b[j]].item())
    ok = max(gaps) < LOGIT_TOL
    print(f"{name}: first differs at token {j} ({a[j]} vs {b[j]}), logit "
          f"gaps to the max {gaps} -> {'near-tie' if ok else 'FAIL'}",
          flush=True)
    if not ok and fail:
        raise SystemExit(f"{name}: differs away from a near-tie")
    return {"identical": False, "ok": ok, "first_differs_at": j,
            "gaps": gaps}


def free_port():
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


# Every process start_entry_point started: killed at exit where a failed
# check left one running.
ENTRY_POINTS = []


@atexit.register
def _kill_entry_points():
    for proc in ENTRY_POINTS:
        if proc.poll() is None:
            proc.kill()


def start_entry_point(content, port, log_path, ready_timeout, env_extra=None,
                      module="runbooks_tpu_torch.serve.api"):
    """``python -m <module>`` (the server by default) on the contract
    root ``content`` (whose params.json, or RBT_GATEWAY_PORT for the
    gateway, names ``port``), its output in log_path: (process, base URL,
    seconds to readiness). A server not ready within ready_timeout is
    killed and fails the run. The servers share one kernel cache beside
    their contract roots (RBT_KERNEL_CACHE), as deployments on one
    artifacts mount do: the first builds K1 into it, the later ones load
    it without nvcc."""
    root = os.path.dirname(os.path.abspath(__file__))
    env = dict(os.environ, RBT_CONTENT_DIR=content,
               RBT_KERNEL_CACHE=os.path.join(os.path.dirname(content),
                                             "server_kernel_cache"),
               PYTHONPATH=os.pathsep.join(
                   [root] + [p for p in [os.environ.get("PYTHONPATH")] if p]),
               **(env_extra or {}))
    t0 = time.perf_counter()
    with open(log_path, "w") as log:
        proc = subprocess.Popen(
            [sys.executable, "-m", module],
            cwd=root, env=env, stdout=log, stderr=subprocess.STDOUT)
    ENTRY_POINTS.append(proc)
    base = f"http://127.0.0.1:{port}"
    while time.perf_counter() - t0 < ready_timeout and proc.poll() is None:
        try:
            if http_call(base, "/")[0] == 200:
                return proc, base, time.perf_counter() - t0
        except OSError:
            pass
        time.sleep(0.5)
    if proc.poll() is None:
        proc.kill()
    proc.wait()
    with open(log_path) as f:
        print(f.read()[-3000:], flush=True)
    raise SystemExit(f"the server on {content} was not ready within "
                     f"{ready_timeout} s")


class Background(threading.Thread):
    """``fn(*args)`` on a thread of its own, started at once: for a check
    that only starts processes and waits on them (a server over HTTP, an
    entry point), so that it runs beside this process's own work and no
    launch count of this process moves. ``result()`` waits for it and
    returns its value, or raises what it raised. Its work shares the card
    and the host with what runs meanwhile: its times are not alone."""

    def __init__(self, fn, *args):
        super().__init__(daemon=True)
        self.fn, self.args = fn, args
        self.value = self.error = None
        self.start()

    def run(self):
        try:
            self.value = self.fn(*self.args)
        except BaseException as exc:  # noqa: BLE001 - raised by result()
            self.error = exc

    def result(self):
        self.join()
        if self.error is not None:
            raise self.error
        return self.value


def stopped_launches(log_text):
    """K1's launches over a server's life, from the line it prints as it
    exits (0 when it printed none)."""
    stopped = [json.loads(ln) for ln in log_text.splitlines()
               if ln.startswith('{"stopped"')]
    return stopped[-1]["flash_fwd_launches"] if stopped else 0


# ---------------------------------------------------------------------------
# Observability (slice 17): the gates on a server's telemetry
# ---------------------------------------------------------------------------

# K1, K2 and K3 as CUPTI names them in a torch.profiler capture.
KERNEL_SYMBOLS = {"flash_fwd": "flash_fwd_kernel",
                  "flash_bwd_dq": "flash_bwd_dq_kernel",
                  "flash_bwd_dkv": "flash_bwd_dkv_kernel"}
OBS_PROFILE_S = 2.0
OBS_LONG_PROMPT = 1500
OBS_LONG_NEW = 64
DECODE_FLOPS_RTOL = 0.02
MEMORY_RTOL = 0.01

_LINT_NAME = r"[a-zA-Z_:][a-zA-Z0-9_:]*"
_LINT_COMMENT = re.compile(
    rf"^# (HELP ({_LINT_NAME}) .+|TYPE ({_LINT_NAME}) "
    r"(counter|gauge|histogram))$")
_LINT_LABEL = re.compile(rf'({_LINT_NAME})="((?:[^"\\\n]|\\\\|\\"|\\n)*)"')
_LINT_SAMPLE = re.compile(rf"^({_LINT_NAME})(\{{(.*)\}})? (\S+)$")


def lint_exposition(text):
    """The reference's exposition lint (its tests/test_obs.py): every line
    parses, each # TYPE precedes its family's samples, counters end in
    _total, histogram buckets carry le, and +Inf equals _count. Returns
    the list of problems (empty when the exposition is clean)."""
    problems, types, seen = [], {}, set()
    if not text.endswith("\n"):
        problems.append("no final newline")
    inf, counts = {}, {}
    for line in text.splitlines():
        if not line:
            continue
        if line.startswith("#"):
            m = _LINT_COMMENT.match(line)
            if not m:
                problems.append(f"malformed comment {line!r}")
            elif m.group(3):
                if m.group(3) in types or m.group(3) in seen:
                    problems.append(f"# TYPE out of place: {line!r}")
                types[m.group(3)] = m.group(4)
            continue
        m = _LINT_SAMPLE.match(line)
        if not m:
            problems.append(f"malformed sample {line!r}")
            continue
        name, blob, value = m.group(1), m.group(3) or "", m.group(4)
        float(value)
        if _LINT_LABEL.sub("", blob).replace(",", ""):
            problems.append(f"unparseable labels {line!r}")
        family = name
        if family not in types:
            for suffix in ("_bucket", "_sum", "_count"):
                if name.endswith(suffix) and \
                        types.get(name[:-len(suffix)]) == "histogram":
                    family = name[:-len(suffix)]
        if family not in types:
            problems.append(f"{name} has no preceding # TYPE")
            continue
        seen.add(family)
        if types[family] == "counter" and not name.endswith("_total"):
            problems.append(f"counter {name} lacks _total")
        key = (family, re.sub(r',?le="[^"]*"', "", blob))
        if name.endswith("_bucket"):
            if 'le="' not in blob:
                problems.append(f"bucket without le {line!r}")
            if 'le="+Inf"' in blob:
                inf[key] = float(value)
        elif name.endswith("_count") and family != name:
            counts[key] = float(value)
    for key, n in counts.items():
        if inf.get(key) != n:
            problems.append(f"{key}: +Inf {inf.get(key)} != _count {n}")
    return problems


def trace_kernel_counts(path):
    """{kernel name: launches} of K1, K2 and K3 in a torch.profiler
    Chrome trace (its device events, category "kernel")."""
    from runbooks_tpu_torch.obs.profile import device_kernels

    names = device_kernels(path)
    return {k: sum(1 for n in names if sym in n)
            for k, sym in KERNEL_SYMBOLS.items()}


def decode_flops(cfg, rows, view, chunk):
    """The analytic FLOPs of one decode chunk: per step, each row's token
    through every projection, the attention over the cache view (q k^T
    and p v over all heads) and the head."""
    h, q = cfg.hidden_size, cfg.num_heads * cfg.head_dim
    kv = cfg.num_kv_heads * cfg.head_dim
    mlp = (3 if cfg.gated_mlp else 2) * h * cfg.intermediate_size
    linear = h * q + 2 * h * kv + q * h + mlp
    per_step = (2 * rows * (cfg.num_layers * linear + h * cfg.vocab_size)
                + cfg.num_layers * 4 * rows * cfg.num_heads * view
                * cfg.head_dim)
    return chunk * per_step


def scrape(base):
    """(parsed families, text, milliseconds) of one GET /metrics."""
    from runbooks_tpu_torch.obs.metrics import parse_exposition

    t0 = time.perf_counter()
    status, headers, text, _ = http_call(base, "/metrics")
    ms = (time.perf_counter() - t0) * 1e3
    if status != 200:
        raise SystemExit(f"/metrics answered {status}")
    return parse_exposition(text), text, ms


def entry_obs_checks(torch, cfg, base, content, seed, first_tokens,
                     weight_bytes):
    """Phase 8 (c)'s telemetry gates on the entry-point server (run with
    RBT_TRACE=1; one completion already answered): a profiler capture
    taken while a long request prefills and decodes names K1, a second
    capture request meanwhile gets 409; the traced request's flight
    timeline; trace.jsonl line by line; /metrics against the requests
    sent; /debug/memory's groups against the saved weights and the cache;
    /debug/programs' census against warmup and the analytic decode
    FLOPs; one incident bundle and a debounced second."""
    from runbooks_tpu_torch.obs.profile import TRACE_FILE

    tokens = [first_tokens]
    gates = {}
    out = {}
    long_prompt = "".join(chr(97 + (i * 7 + seed) % 26)
                          for i in range(OBS_LONG_PROMPT))
    result = {}

    def capture():
        result["profile"] = http_call(
            base, f"/debug/profile?seconds={OBS_PROFILE_S}", {})

    def long_request():
        result["long"] = http_call(base, "/v1/completions", {
            "prompt": long_prompt, "max_tokens": OBS_LONG_NEW,
            "temperature": 0}, {"X-Request-Id": "obs-long-1"})

    t_cap = threading.Thread(target=capture)
    t_cap.start()
    time.sleep(0.3)
    t_long = threading.Thread(target=long_request)
    t_long.start()
    time.sleep(0.2)
    busy = http_call(base, f"/debug/profile?seconds={OBS_PROFILE_S}", {})
    t_long.join()
    t_cap.join()
    status, _, text, _ = result["long"]
    if status != 200:
        raise SystemExit(f"the profiled request answered {status}: {text}")
    tokens.append(json.loads(text)["usage"]["completion_tokens"])
    p_status, _, p_text, _ = result["profile"]
    gates["profile_200"] = p_status == 200
    gates["second_profile_409"] = busy[0] == 409
    if p_status == 200:
        path = os.path.join(json.loads(p_text)["path"], TRACE_FILE)
        counts = trace_kernel_counts(path)
        out["profile_kernels"] = counts
        gates["profile_names_k1"] = counts["flash_fwd"] > 0
    status, _, text, _ = http_call(base,
                                   "/debug/flight?request_id=obs-long-1")
    names = [e["name"] for e in json.loads(text)["events"]]
    out["flight_names"] = sorted(set(names))
    gates["flight_timeline"] = (status == 200 and names[:2] ==
                                ["queue_wait", "prefill"]
                                and "decode" in names)
    lines = bad = 0
    with open(f"{content}/artifacts/trace.jsonl") as f:
        head = f.readline().strip()
        for line in f:
            line = line.strip().rstrip(",")
            if not line:
                continue
            lines += 1
            try:
                json.loads(line)
            except ValueError:
                bad += 1
    out["trace_jsonl_lines"] = lines
    gates["trace_jsonl_parses"] = head == "[" and lines > 0 and bad == 0
    fams, text, ms = scrape(base)
    scrape_ms = [ms] + [scrape(base)[2] for _ in range(9)]
    out["scrape_ms"] = scrape_ms
    problems = lint_exposition(text)
    out["lint_problems"] = problems[:5]
    gates["exposition_lint"] = not problems
    n_req = len(tokens)
    gates["requests_total"] = \
        fams["serve_requests_total"].total() == n_req
    gates["tokens_total"] = \
        fams["serve_tokens_generated_total"].total() == sum(tokens)
    gates["ttft_count"] = \
        fams["serve_ttft_seconds"].merged_histogram().count == n_req
    gates["no_unexpected_builds"] = \
        fams["xla_unexpected_compiles_total"].total() == 0
    in_use = fams["device_memory_bytes_in_use"].total()
    status, _, text, _ = http_call(base, "/debug/memory")
    mem = json.loads(text)
    groups = mem["tensors"]["by_category"]
    allocated = mem["tensors"]["total_bytes"]
    itemsize = torch.tensor([], dtype=cfg.activation_dtype).element_size()
    kv_bytes = (2 * cfg.num_layers * 8 * 2049 * cfg.num_kv_heads
                * cfg.head_dim * itemsize)
    out["memory"] = {"bytes_in_use_gauge": in_use,
                     "memory_allocated_at_debug_memory": allocated,
                     "groups": groups, "want_weights": weight_bytes,
                     "want_kv": kv_bytes}
    gates["memory_in_use_1pct"] = \
        abs(in_use - allocated) <= MEMORY_RTOL * allocated
    gates["memory_weights_exact"] = groups["weights"] == weight_bytes
    gates["memory_kv_exact"] = groups["kv_cache"] == kv_bytes
    status, _, text, _ = http_call(base, "/debug/programs")
    progs = json.loads(text)
    census = {p["name"]: p for p in progs["programs"]}
    warm = progs["warmup_census"]
    want_prefill = {f"b{b}r{r}" for b in warm["prefill_buckets"]
                    for r in warm["rows"]}
    from runbooks_tpu_torch.utils.hw import backend_tuning

    chunk = backend_tuning(torch.device("cuda"))["decode_chunk"]
    decode = {}
    for view in warm["decode_views"]:
        cost = census.get(f"decode_v{view}", {}).get("costs", {}).get(
            f"v{view}")
        want = decode_flops(cfg, 8, view, chunk)
        decode[view] = None if cost is None else {
            "flops": cost["flops"], "analytic": want,
            "rel": cost["flops"] / want - 1, "bound": cost["bound"],
            "hbm_bytes": cost["hbm_bytes"],
            "analytic_mfu": cost.get("analytic_mfu")}
    out["decode_programs"] = decode
    out["warmup_seconds"] = warm["warmup_seconds"]
    gates["programs_prefill"] = \
        set(census.get("prefill", {}).get("costs", {})) == want_prefill
    gates["programs_decode_flops_2pct"] = all(
        d is not None and abs(d["rel"]) <= DECODE_FLOPS_RTOL
        for d in decode.values())
    first = json.loads(http_call(base, "/debug/incident",
                                 {"reason": "chip_smoke"})[2])
    again = json.loads(http_call(base, "/debug/incident",
                                 {"reason": "chip_smoke"})[2])
    listed = json.loads(http_call(base, "/debug/incidents")[2])
    gates["incident_one_bundle"] = (
        first["path"] is not None and os.path.exists(first["path"])
        and again["debounced"] and len(listed["incidents"]) == 1)
    out["gates"] = gates
    return out


def entry_point_start(torch, dev, seed, workdir):
    """Phase 8 (c), set up: seeded llama3-8b params at full width, depth
    ENTRY_LAYERS, bf16, saved on the model mount, this process's greedy
    decode of one prompt, and the container's entry point started over
    the mount (in the background: it warms up while (a) and (b) run).
    Returns what ``entry_point_check`` reads."""
    from runbooks_tpu_torch.models.config import get_config
    from runbooks_tpu_torch.models.transformer import init_params
    from runbooks_tpu_torch.obs.device import tensor_leaves
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
    weight_bytes = sum(t.numel() * t.element_size()
                       for t in tensor_leaves(params))
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
    log_path = f"{workdir}/entry_point.log"
    server = Background(start_entry_point, content, port, log_path, 120,
                        {"RBT_TRACE": "1"})
    return {"cfg": cfg, "content": content, "seed": seed, "prompt": prompt,
            "ref": ref, "want_text": want_text, "save_s": save_s,
            "weight_bytes": weight_bytes, "log_path": log_path,
            "server": server}


def entry_point_check(torch, entry):
    """Phase 8 (c): the container's entry point of ``entry_point_start``
    (``entry``) against this process's decode, its telemetry, and its
    exit on SIGTERM."""
    cfg, content, seed, prompt, ref, want_text, log_path = (
        entry[k] for k in ("cfg", "content", "seed", "prompt", "ref",
                           "want_text", "log_path"))
    save_s, weight_bytes = entry["save_s"], entry["weight_bytes"]
    proc, base, ready_s = entry["server"].result()
    try:
        status, _, text, _ = http_call(base, "/v1/completions", {
            "prompt": prompt, "max_tokens": MAX_TOKENS, "temperature": 0})
        if status != 200:
            raise SystemExit(f"entry point completion: {status} {text}")
        choice = json.loads(text)["choices"][0]
        usage = json.loads(text)["usage"]["completion_tokens"]
        same = (choice["text"] == want_text
                and usage == len(ref.output_tokens)
                and choice["finish_reason"] == ref.finish_reason)
        obs = entry_obs_checks(torch, cfg, base, content, seed, usage,
                               weight_bytes)
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
    print("entry point obs " + json.dumps(obs), flush=True)
    print(f"entry point: checkpoint of llama3-8b x{ENTRY_LAYERS} layers bf16 "
          f"saved in {save_s:.1f} s; ready in {ready_s:.1f} s (start, "
          f"restore, build, warmup); restored from the mount: {restored}; "
          f"greedy completion ({usage} tokens, {choice['finish_reason']}) "
          f"{'equals' if same else 'DIFFERS FROM'} this process's decode; "
          f"SIGTERM -> exit {rc} in {exit_s:.1f} s", flush=True)
    if not (same and rc == 0 and restored):
        print(log_tail, flush=True)
        raise SystemExit("the entry point check failed")
    if not all(obs["gates"].values()):
        print(log_tail, flush=True)
        raise SystemExit(f"the entry point's telemetry gates failed: "
                         f"{obs['gates']}")


def http_phase(torch, dev, seed, workdir):
    """Phase 8: serving phase 7's fine-tune over HTTP. Returns K1's
    launches in the HTTP mix."""
    t0 = time.perf_counter()
    entry = entry_point_start(torch, dev, seed, workdir)
    cfg, merged = fold_check(torch, seed, f"{workdir}/artifacts")
    launches = serve_http(torch, cfg, merged, seed)
    del merged
    gc.collect()
    torch.cuda.empty_cache()
    entry_point_check(torch, entry)
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


def hf_falcon_names(cfg):
    """HF FalconForCausalLM's tensor names and [out, in] shapes: the fused
    query_key_value; one input_layernorm (shared_layer_norm, 7b) or
    ln_attn / ln_mlp (40b); a tied head (not stored)."""
    h, m, L = cfg.hidden_size, cfg.intermediate_size, cfg.num_layers
    qkv = (cfg.num_kv_heads * (cfg.num_heads // cfg.num_kv_heads + 2)
           * cfg.head_dim)
    norms = (("input_layernorm",) if cfg.shared_layer_norm
             else ("ln_attn", "ln_mlp"))
    shapes = {"transformer.word_embeddings.weight": (cfg.vocab_size, h)}
    for i in range(L):
        pre = f"transformer.h.{i}."
        shapes.update({
            pre + "self_attention.query_key_value.weight": (qkv, h),
            pre + "self_attention.dense.weight": (h, cfg.q_dim),
            pre + "mlp.dense_h_to_4h.weight": (m, h),
            pre + "mlp.dense_4h_to_h.weight": (h, m)})
        for n in norms:
            shapes.update({pre + n + ".weight": (h,), pre + n + ".bias": (h,)})
    shapes.update({"transformer.ln_f.weight": (h,),
                   "transformer.ln_f.bias": (h,)})
    return shapes


def hf_opt_names(cfg):
    """HF OPTForCausalLM's tensor names and [out, in] shapes (pre-LN,
    positions with HF's 2 extra rows, a tied head not stored)."""
    h, m, L = cfg.hidden_size, cfg.intermediate_size, cfg.num_layers
    pre = "model.decoder."
    shapes = {pre + "embed_tokens.weight": (cfg.vocab_size, h),
              pre + "embed_positions.weight": (cfg.max_seq_len + 2, h)}
    for i in range(L):
        lp = f"{pre}layers.{i}."
        for n in ("q_proj", "k_proj", "v_proj", "out_proj"):
            shapes[lp + f"self_attn.{n}.weight"] = (h, h)
            shapes[lp + f"self_attn.{n}.bias"] = (h,)
        shapes.update({lp + "fc1.weight": (m, h), lp + "fc1.bias": (m,),
                       lp + "fc2.weight": (h, m), lp + "fc2.bias": (h,)})
        for n in ("self_attn_layer_norm", "final_layer_norm"):
            shapes.update({lp + n + ".weight": (h,), lp + n + ".bias": (h,)})
    shapes.update({pre + "final_layer_norm.weight": (h,),
                   pre + "final_layer_norm.bias": (h,)})
    return shapes


def hf_gpt2_names(cfg):
    """HF GPT2LMHeadModel's tensor names and Conv1D [in, out] shapes (the
    fused c_attn; a tied head not stored)."""
    h, m, L = cfg.hidden_size, cfg.intermediate_size, cfg.num_layers
    shapes = {"transformer.wte.weight": (cfg.vocab_size, h),
              "transformer.wpe.weight": (cfg.max_seq_len, h)}
    for i in range(L):
        pre = f"transformer.h.{i}."
        shapes.update({
            pre + "ln_1.weight": (h,), pre + "ln_1.bias": (h,),
            pre + "attn.c_attn.weight": (h, 3 * h),
            pre + "attn.c_attn.bias": (3 * h,),
            pre + "attn.c_proj.weight": (h, h),
            pre + "attn.c_proj.bias": (h,),
            pre + "ln_2.weight": (h,), pre + "ln_2.bias": (h,),
            pre + "mlp.c_fc.weight": (h, m), pre + "mlp.c_fc.bias": (m,),
            pre + "mlp.c_proj.weight": (m, h),
            pre + "mlp.c_proj.bias": (h,)})
    shapes.update({"transformer.ln_f.weight": (h,),
                   "transformer.ln_f.bias": (h,)})
    return shapes


def hf_gemma_names(cfg):
    """HF GemmaForCausalLM's tensor names and [out, in] shapes: llama's,
    with the head tied to the embedding (no lm_head stored)."""
    shapes = hf_llama_names(cfg)
    del shapes["lm_head.weight"]
    return shapes


def hf_mixtral_names(cfg):
    """HF MixtralForCausalLM's tensor names and [out, in] shapes: llama's
    without the dense MLP, and per layer the router
    (block_sparse_moe.gate [E, h]) and each expert's w1 (gate), w3 (up)
    and w2 (down)."""
    h, m = cfg.hidden_size, cfg.intermediate_size
    shapes = {k: v for k, v in hf_llama_names(cfg).items()
              if ".mlp." not in k}
    for i in range(cfg.num_layers):
        pre = f"model.layers.{i}.block_sparse_moe."
        shapes[pre + "gate.weight"] = (cfg.moe_num_experts, h)
        for e in range(cfg.moe_num_experts):
            shapes.update({pre + f"experts.{e}.w1.weight": (m, h),
                           pre + f"experts.{e}.w3.weight": (m, h),
                           pre + f"experts.{e}.w2.weight": (h, m)})
    return shapes


def hf_names(cfg):
    """The HF tensor names and shapes of cfg's family."""
    from runbooks_tpu_torch.models.convert import family_of

    return {"llama": hf_llama_names, "gemma": hf_gemma_names,
            "mixtral": hf_mixtral_names, "falcon": hf_falcon_names,
            "opt": hf_opt_names, "gpt2": hf_gpt2_names}[family_of(cfg)](cfg)


def _is_norm_weight(name):
    return name.endswith(".weight") and any(
        k in name for k in ("norm", "ln_", "layer_norm"))


def write_hf_checkpoint(torch, dev, shapes, directory, seed, shards):
    """An HF checkpoint directory in BF16 of the tensors ``shapes`` names,
    drawn on ``dev`` from the seed (norm weights around 1, the rest
    scaled by their last dimension): ``shards`` safetensors files and
    their index. Returns ({name: CPU tensor}, bytes of tensor data)."""
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed + 9)
    tensors = {}
    for name, shape in shapes.items():
        if _is_norm_weight(name):
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


def write_hf_llama(torch, dev, cfg, directory, seed, shards):
    """An HF llama checkpoint directory of ``cfg`` (write_hf_checkpoint)."""
    return write_hf_checkpoint(torch, dev, hf_llama_names(cfg), directory,
                               seed, shards)


def family_expected(torch, tensors, cfg):
    """(dotted leaf, layer or None, what that leaf must hold) for every
    leaf of a falcon, opt, gpt2, gemma or mixtral import, worked out here
    from the HF tensors by hand: Falcon's fused rows taken apart per kv
    head (rep query heads, then its key, then its value), OPT's positions
    without their first 2 rows, GPT-2's c_attn columns split in three,
    Gemma's norm weights plus 1 (in f32: the leaf holds that sum cast to
    its dtype), Mixtral's experts by (layer, expert), every [out, in]
    linear transposed."""
    from runbooks_tpu_torch.models.convert import family_of

    fam = family_of(cfg)
    L, h, d = cfg.num_layers, cfg.hidden_size, cfg.head_dim
    out = []

    def add(leaf, name, transpose=False, layered=True, pick=None):
        for i in (range(L) if layered else (None,)):
            t = tensors[name.format(i=i)]
            t = pick(t) if pick is not None else t
            out.append((leaf, i, t.T if transpose else t))

    if fam == "falcon":
        pre = "transformer.h.{i}."
        nkv, rep = cfg.num_kv_heads, cfg.num_heads // cfg.num_kv_heads
        for i in range(L):
            w = tensors[pre.format(i=i)
                        + "self_attention.query_key_value.weight"]
            rows = {"q": [], "k": [], "v": []}
            for g in range(nkv):
                base = g * (rep + 2) * d
                rows["q"].append(w[base:base + rep * d])
                rows["k"].append(w[base + rep * d:base + (rep + 1) * d])
                rows["v"].append(w[base + (rep + 1) * d:
                                   base + (rep + 2) * d])
            for part in "qkv":
                out.append((f"layers.attn.w{part}", i,
                            torch.cat(rows[part]).T))
        add("layers.attn.wo", pre + "self_attention.dense.weight", True)
        add("layers.mlp.wi", pre + "mlp.dense_h_to_4h.weight", True)
        add("layers.mlp.wo", pre + "mlp.dense_4h_to_h.weight", True)
        norms = ({"ln1": "input_layernorm"} if cfg.shared_layer_norm
                 else {"ln1": "ln_attn", "ln2": "ln_mlp"})
        for leaf, n in norms.items():
            add(f"layers.{leaf}.scale", pre + n + ".weight")
            add(f"layers.{leaf}.bias", pre + n + ".bias")
        add("embed", "transformer.word_embeddings.weight", layered=False)
        add("final_norm.scale", "transformer.ln_f.weight", layered=False)
        add("final_norm.bias", "transformer.ln_f.bias", layered=False)
    elif fam == "opt":
        pre = "model.decoder.layers.{i}."
        for leaf, n in (("q", "q_proj"), ("k", "k_proj"), ("v", "v_proj"),
                        ("o", "out_proj")):
            add(f"layers.attn.w{leaf}", pre + f"self_attn.{n}.weight", True)
            add(f"layers.attn.b{leaf}", pre + f"self_attn.{n}.bias")
        add("layers.mlp.wi", pre + "fc1.weight", True)
        add("layers.mlp.bi", pre + "fc1.bias")
        add("layers.mlp.wo", pre + "fc2.weight", True)
        add("layers.mlp.bo", pre + "fc2.bias")
        for leaf, n in (("ln1", "self_attn_layer_norm"),
                        ("ln2", "final_layer_norm")):
            add(f"layers.{leaf}.scale", pre + n + ".weight")
            add(f"layers.{leaf}.bias", pre + n + ".bias")
        add("embed", "model.decoder.embed_tokens.weight", layered=False)
        add("pos_embed", "model.decoder.embed_positions.weight",
            layered=False, pick=lambda t: t[2:])
        add("final_norm.scale", "model.decoder.final_layer_norm.weight",
            layered=False)
        add("final_norm.bias", "model.decoder.final_layer_norm.bias",
            layered=False)
    elif fam == "gpt2":
        pre = "transformer.h.{i}."
        for j, part in enumerate("qkv"):
            cols = (lambda t, j=j: t[..., j * h:(j + 1) * h])
            add(f"layers.attn.w{part}", pre + "attn.c_attn.weight",
                pick=cols)
            add(f"layers.attn.b{part}", pre + "attn.c_attn.bias", pick=cols)
        for leaf, n in (("attn.wo", "attn.c_proj.weight"),
                        ("attn.bo", "attn.c_proj.bias"),
                        ("mlp.wi", "mlp.c_fc.weight"),
                        ("mlp.bi", "mlp.c_fc.bias"),
                        ("mlp.wo", "mlp.c_proj.weight"),
                        ("mlp.bo", "mlp.c_proj.bias"),
                        ("ln1.scale", "ln_1.weight"),
                        ("ln1.bias", "ln_1.bias"),
                        ("ln2.scale", "ln_2.weight"),
                        ("ln2.bias", "ln_2.bias")):
            add(f"layers.{leaf}", pre + n)
        add("embed", "transformer.wte.weight", layered=False)
        add("pos_embed", "transformer.wpe.weight", layered=False)
        add("final_norm.scale", "transformer.ln_f.weight", layered=False)
        add("final_norm.bias", "transformer.ln_f.bias", layered=False)
    elif fam == "gemma":
        pre = "model.layers.{i}."
        for leaf, n in (("attn.wq", "self_attn.q_proj"),
                        ("attn.wk", "self_attn.k_proj"),
                        ("attn.wv", "self_attn.v_proj"),
                        ("attn.wo", "self_attn.o_proj"),
                        ("mlp.wi_gate", "mlp.gate_proj"),
                        ("mlp.wi_up", "mlp.up_proj"),
                        ("mlp.wo", "mlp.down_proj")):
            add(f"layers.{leaf}", pre + n + ".weight", True)

        def plus_one(t):
            return t.float() + 1

        add("layers.ln1.scale", pre + "input_layernorm.weight",
            pick=plus_one)
        add("layers.ln2.scale", pre + "post_attention_layernorm.weight",
            pick=plus_one)
        add("embed", "model.embed_tokens.weight", layered=False)
        add("final_norm.scale", "model.norm.weight", layered=False,
            pick=plus_one)
    elif fam == "mixtral":
        pre = "model.layers.{i}."
        for leaf, n in (("attn.wq", "self_attn.q_proj"),
                        ("attn.wk", "self_attn.k_proj"),
                        ("attn.wv", "self_attn.v_proj"),
                        ("attn.wo", "self_attn.o_proj"),
                        ("moe.router", "block_sparse_moe.gate")):
            add(f"layers.{leaf}", pre + n + ".weight", True)
        for i in range(L):
            for e in range(cfg.moe_num_experts):
                for leaf, w in (("wi_gate", "w1"), ("wi_up", "w3"),
                                ("wo", "w2")):
                    out.append((f"layers.moe.{leaf}", (i, e), tensors[
                        f"model.layers.{i}.block_sparse_moe.experts.{e}."
                        f"{w}.weight"].T))
        add("layers.ln1.scale", pre + "input_layernorm.weight")
        add("layers.ln2.scale", pre + "post_attention_layernorm.weight")
        add("embed", "model.embed_tokens.weight", layered=False)
        add("final_norm.scale", "model.norm.weight", layered=False)
        add("head", "lm_head.weight", True, layered=False)
    else:
        raise ValueError(f"no hand expectation for the {fam} family")
    return out


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


def run_loader(content, params):
    """``python -m runbooks_tpu_torch.models.loader`` on params.json =
    ``params`` under the contract root ``content``, killed after
    IMPORT_TIMEOUT_S: (exit code, seconds, the child's peak resident GB,
    its output)."""
    os.makedirs(content)
    with open(f"{content}/params.json", "w") as f:
        json.dump(params, f)
    root = os.path.dirname(os.path.abspath(__file__))
    env = dict(os.environ, RBT_CONTENT_DIR=content,
               PYTHONPATH=os.pathsep.join(
                   [root] + [p for p in [os.environ.get("PYTHONPATH")] if p]))
    log_path = f"{content}/loader.log"
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
    seconds = time.perf_counter() - t0
    with open(log_path) as f:
        log_text = f.read()
    return (os.waitstatus_to_exitcode(status), seconds,
            usage.ru_maxrss * 1024 / 1e9, log_text)


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
    returncode, import_s, peak_rss_gb, log_text = run_loader(
        content, {"model": "llama3-8b", "model_overrides": overrides,
                  "source": "dir", "dir": src})
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
    meta_ok = (returncode == 0 and meta == want_meta
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
             "loader_peak_rss_gb": peak_rss_gb,
             "exit_code": returncode}
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
    """Phase 11: speculation and grammar at full width, SERVE_LAYERS
    layers. Returns K1's launches by run."""
    from runbooks_tpu_torch.ops.flash_attention import flash_attention
    from runbooks_tpu_torch.serve.api import create_server, load_model
    from runbooks_tpu_torch.serve.engine import Request
    from runbooks_tpu_torch.train.data import ByteTokenizer

    t_phase = time.perf_counter()
    cfg, params = load_model({"model": "llama3-8b",
                              "model_overrides": {
                                  "param_dtype": "bfloat16",
                                  "num_layers": SERVE_LAYERS},
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
    every page (with its scales, for an int8 pool) came back
    bit-identical in another page."""
    from runbooks_tpu_torch.serve import paging

    pool = engine.cache
    n = SWAP_TIMED_PAGES
    host = paging.HostPagePool(cfg, n, PAGE_SIZE, pin_memory=True,
                               quantize_kv=pool.quantized)
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
    same = all(torch.equal(a, b) for p in range(n)
               for a, b in zip(pool.page(p), pool.page(p + n)))
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
    """Phase 12: paged serving of llama3-8b bf16 at full width,
    SERVE_LAYERS layers (max_slots 8, max_seq_len 2048, pages of 16, every engine warmed up).
    Returns K1's launches by run."""
    from runbooks_tpu_torch.serve.api import load_model

    t_phase = time.perf_counter()
    cfg, params = load_model({"model": "llama3-8b",
                              "model_overrides": {
                                  "param_dtype": "bfloat16",
                                  "num_layers": SERVE_LAYERS},
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


# ---------------------------------------------------------------------------
# Phase 13: multi-tenant LoRA
# ---------------------------------------------------------------------------

def lora_prompts(seed):
    """LORA_LENS prompts (ByteTokenizer ids, BOS first) of seeded
    code-like spans quoted again and again, all in the 256-token prefill
    bucket, so one admission tick prefills the whole mix as one
    dispatch."""
    import numpy as np

    from runbooks_tpu_torch.train.data import ByteTokenizer

    rng = np.random.default_rng(seed + 13)
    tok = ByteTokenizer()
    words = ["def", "return", "self", "lane", "adapter", "tenant", "if",
             "else", "for", "in", "pool", "rank", "(", ")", "delta", "base"]
    prompts = []
    for n in LORA_LENS:
        spans = [" ".join(rng.choice(words, size=int(rng.integers(6, 20))))
                 for _ in range(3)]
        text = ""
        while len(text) < n:
            text += spans[int(rng.integers(0, 3))] + "\n"
        prompts.append(tok.encode(text, add_eos=False)[:n])
    return prompts


def write_tenants(torch, cfg, root, seed):
    """LORA_TENANTS' artifacts (rank, alpha) for the attention targets,
    written with the port's save_adapter as a LoRA training run leaves
    them: A ~ N(0, 1/d_in), B seeded non-zero (a trained adapter's B has
    moved off its zero init). Returns their paths."""
    from runbooks_tpu_torch.ops.lora import target_dims
    from runbooks_tpu_torch.serve.lora_pool import save_adapter

    g = torch.Generator().manual_seed(seed + 130)
    paths = []
    for i, (rank, alpha) in enumerate(LORA_TENANTS):
        tree = {}
        for t in cfg.lora_targets:
            d_in, d_out = target_dims(cfg, t)
            tree[t] = {
                "a": torch.randn((cfg.num_layers, d_in, rank),
                                 generator=g) * d_in ** -0.5,
                "b": torch.randn((cfg.num_layers, rank, d_out),
                                 generator=g) * LORA_B_STD}
        path = os.path.join(root, f"tenant{i}")
        save_adapter(path, tree, rank=rank, alpha=alpha)
        paths.append(path)
    return paths


def lora_requests(prompts, paths):
    """Phase 13's mix: LORA_MIX's tenant (or None: base only) per prompt,
    greedy, LORA_NEW tokens each (no EOS)."""
    from runbooks_tpu_torch.serve.engine import Request

    return [Request(prompt_tokens=list(p), max_tokens=LORA_NEW,
                    temperature=0.0, request_id=f"l{i}",
                    adapter=None if t is None else paths[t])
            for i, (p, t) in enumerate(zip(prompts, LORA_MIX))]


def record_prefills(engine, records):
    """Record each prefill dispatch's lanes (None: no pool operand) and
    its rows' first-token logits."""
    name = "_paged_prefill" if hasattr(engine, "_paged_prefill") \
        else "_prefill"
    prefill = getattr(engine, name)

    def recording(*args, **kw):
        first, pool, last = prefill(*args, **kw)
        lanes = kw.get("adapters")
        records.append((None if lanes is None else lanes[1].tolist(),
                        last.clone()))
        return first, pool, last

    setattr(engine, name, recording)


def device_activity(torch, prof):
    """(CUDA activities, their device ms) of a torch.profiler run: kernels,
    copies and memsets, without the dispatch spans' ranges."""
    from torch.autograd import DeviceType

    acts = [e for e in prof.key_averages()
            if e.device_type == DeviceType.CUDA
            and not e.key.endswith("_dispatch")]
    return (sum(e.count for e in acts),
            sum(e.self_device_time_total for e in acts) / 1e3)


def decode_forward_activity(torch, engine, reqs):
    """Kernel launches and device busy ms of one decode chunk of the mix
    (every slot live), per forward: the mix is admitted and prefilled by
    one step, the next step (a decode chunk alone) runs under
    torch.profiler, the rest is drained untraced."""
    from torch.profiler import ProfilerActivity, profile

    with torch.no_grad():
        for r in reqs:
            engine.submit(r)
        engine.step()
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            engine.step()
            torch.cuda.synchronize()
        while engine.has_work():
            engine.step()
    n, ms = device_activity(torch, prof)
    return {"launches_per_decode_forward": n / engine.decode_chunk,
            "device_ms_per_decode_forward": ms / engine.decode_chunk}


def delta_timing(torch, cfg, engine, lanes):
    """One decode forward's adapter work at the mix's lanes (the [L, rows]
    gather and, per layer and target, the two products and the add on
    [rows, 1, d] operands): its time between CUDA events over warm runs
    (the host makes ~400 small launches, so this is the launch rate),
    its device busy time (torch.profiler's kernel time), and its bound:
    the distinct tenant lanes' bytes read once (the trash lane needs no
    read) over HBM against its operations over the bf16 peak."""
    from torch.profiler import ProfilerActivity, profile

    from runbooks_tpu_torch.ops.lora import (
        gather_lanes,
        lane_delta,
        map_lane_indices,
        pool_lanes,
        target_dims,
    )
    from runbooks_tpu_torch.utils.hw import H100_HBM_BW, H100_PEAK_BF16_FLOPS

    pool = engine.adapters.tree
    dev = engine.device
    ad = cfg.activation_dtype
    rows = len(lanes)
    g = torch.Generator(device=dev).manual_seed(0)
    xs, ys = {}, {}
    for t in cfg.lora_targets:
        d_in, d_out = target_dims(cfg, t)
        xs[t] = torch.randn((rows, 1, d_in), generator=g, device=dev).to(ad)
        ys[t] = torch.randn((rows, 1, d_out), generator=g, device=dev).to(ad)
    idx_raw = torch.tensor(lanes, device=dev)

    def delta():
        sel = gather_lanes(pool, map_lane_indices(idx_raw, pool_lanes(pool)))
        for li in range(cfg.num_layers):
            for t in cfg.lora_targets:
                group, name = t.split(".")
                a, b = sel[group][name]
                ys[t] + lane_delta(xs[t], a[li], b[li], ad)

    with torch.no_grad():
        ms = cuda_ms(delta, 20)
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for _ in range(5):
                delta()
            torch.cuda.synchronize()
    n, busy_ms = device_activity(torch, prof)
    r, esz = engine.adapters.rank, torch.finfo(ad).bits // 8
    used = len({x for x in lanes if x >= 0})
    lane_bytes = sum(cfg.num_layers * r * sum(target_dims(cfg, t)) * esz
                     for t in cfg.lora_targets)
    io_bytes = sum(cfg.num_layers * rows * (target_dims(cfg, t)[0]
                                            + 2 * target_dims(cfg, t)[1])
                   * esz for t in cfg.lora_targets)
    flops = sum(2 * cfg.num_layers * rows * r * sum(target_dims(cfg, t))
                for t in cfg.lora_targets)
    by_bytes = (used * lane_bytes + io_bytes) / H100_HBM_BW * 1e3
    by_ops = flops / H100_PEAK_BF16_FLOPS * 1e3
    return {"delta_ms_per_forward": ms,
            "delta_ms_per_decode_step": ms * engine.decode_chunk,
            "delta_device_busy_ms_per_forward": busy_ms / 5,
            "delta_launches_per_forward": n / 5,
            "bound_ms_per_forward": max(by_bytes, by_ops),
            "bound_by": "bytes" if by_bytes >= by_ops else "operations",
            "tenant_lanes_read": used, "lane_bytes": lane_bytes}


def lora_dense(torch, cfg, params, paths, prompts, seed, launches):
    """Phase 13 (a): the mix through a pooled dense engine and a no-pool
    one, both warmed up and resident, run no-pool, pooled, pooled,
    no-pool twice (host drift falls on both sides); then each tenant
    against a dedicated engine over its folded weights. Returns the
    pooled engine and its greedy ids."""
    from runbooks_tpu_torch.serve.engine import InferenceEngine
    from runbooks_tpu_torch.serve.lora_pool import load_merge_adapter

    engines = {"plain": warm_engine(torch, cfg, params, seed),
               "pooled": warm_engine(torch, cfg, params, seed,
                                     adapter_pool=LORA_POOL,
                                     lora_rank=LORA_RANK)}
    records = {name: [] for name in engines}
    for name, (engine, _, _) in engines.items():
        record_prefills(engine, records[name])
    runs = {"plain": [], "pooled": []}
    ids, first_records = {}, {}
    for name in ("plain", "pooled", "pooled", "plain") * 2:
        engine, samples, warm_s = engines[name]
        reqs = lora_requests(prompts, paths if name == "pooled"
                             else [None] * len(LORA_TENANTS))
        records[name].clear()
        d0 = engine.prefill_dispatches
        torch.cuda.reset_peak_memory_stats()
        st, run_ids = timed_generate(torch, engine, samples, reqs)
        st.update(warmup_s=warm_s, prefill_dispatches=(
            engine.prefill_dispatches - d0),
            max_memory_allocated_gb=torch.cuda.max_memory_allocated() / 1e9)
        if not all(len(x) == LORA_NEW for x in run_ids):
            raise SystemExit(f"lora (a) {name}: not every request got "
                             f"{LORA_NEW} tokens: {st}")
        ids.setdefault(name, run_ids)
        first_records.setdefault(name, list(records[name]))
        runs[name].append(st)
        launches[f"lora_a_{name}"] = st["flash_fwd_launches"]
    pooled, _, _ = engines["pooled"]
    lanes = first_records["pooled"][0][0]
    tenant_lanes = sorted({x for x in lanes if x >= 0})
    per_run = {st["flash_fwd_launches"] for r in runs.values() for st in r}
    base_rows = [i for i, t in enumerate(LORA_MIX) if t is None]
    base_logits_equal = all(
        torch.equal(first_records["pooled"][0][1][i],
                    first_records["plain"][0][1][i]) for i in base_rows)
    changed = [i for i, t in enumerate(LORA_MIX)
               if t is not None and ids["pooled"][i] != ids["plain"][i]]
    gates = {
        "one_prefill_dispatch_every_tenant": (
            all(st["prefill_dispatches"] == 1 for st in runs["pooled"])
            and len(tenant_lanes) == len(LORA_TENANTS)),
        "k1_launches_equal": len(per_run) == 1,
        "base_rows_ids_equal": all(ids["pooled"][i] == ids["plain"][i]
                                   for i in base_rows),
        "base_rows_logits_bitwise": base_logits_equal,
        "a_tenant_changes_ids": bool(changed),
    }
    t_engine = decode_forward_activity(
        torch, pooled, lora_requests(prompts, paths))
    plain_engine = engines["plain"][0]
    p_engine = decode_forward_activity(
        torch, plain_engine, lora_requests(prompts, [None] * 4))
    stats = {name: {"runs": runs[name]} for name in runs}
    stats["pooled"].update(
        pool_bytes=pooled.adapters.pool_bytes(),
        adapter_stats=pooled.adapter_stats(),
        decode_forward=t_engine,
        delta=delta_timing(torch, cfg, pooled, lanes))
    stats["plain"]["decode_forward"] = p_engine
    for name in runs:
        tps = [st["decode_tokens_per_s"] for st in runs[name]]
        steps = [st["median_decode_step_ms"] for st in runs[name]]
        stats[name].update(decode_tokens_per_s_median=median(tps),
                           decode_step_ms_median=median(steps))
    stats["prefill_lanes"] = lanes
    stats["tenant_rows_changed_vs_base"] = changed
    stats["gates"] = gates
    print("lora (a) " + json.dumps(stats), flush=True)
    if not all(gates.values()):
        raise SystemExit(f"lora (a): gates failed: {gates}")
    free_engine(torch, plain_engine)
    del engines, plain_engine
    # Each tenant against a dedicated engine over its folded weights, one
    # at a time.
    for t, path in enumerate(paths):
        merged = load_merge_adapter(path, cfg, params)
        dedicated = InferenceEngine(cfg, merged, max_slots=8,
                                    max_seq_len=2048, seed=seed)
        rows = [i for i, x in enumerate(LORA_MIX) if x == t]
        reqs = lora_requests([prompts[i] for i in rows], [None] * 4)
        with torch.no_grad():
            dedicated.generate(reqs)
        for i, r in zip(rows, reqs):
            near_tie_check(torch, cfg, merged, f"lora (a) l{i} tenant{t}: "
                           "greedy ids pooled vs folded", prompts[i],
                           ids["pooled"][i], r.output_tokens)
        free_engine(torch, dedicated)
        del dedicated, merged
        gc.collect()
        torch.cuda.empty_cache()
    return pooled, ids["pooled"]


def lru_prediction(order, pool_size):
    """(loads, evictions, hits) of an LRU pool of pool_size lanes (empty
    lanes first) for adapters requested one at a time in ``order``."""
    lanes, used = [None] * pool_size, [0] * pool_size
    loads = evictions = hits = 0
    for clock, name in enumerate(order, 1):
        if name in lanes:
            hits += 1
            used[lanes.index(name)] = clock
            continue
        lane = (lanes.index(None) if None in lanes
                else min(range(pool_size), key=lambda i: used[i]))
        evictions += lanes[lane] is not None
        lanes[lane], used[lane] = name, clock
        loads += 1
    return loads, evictions, hits


def lora_rotation(torch, cfg, params, paths, prompts):
    """Phase 13 (b): a 2-lane pool, the 4 tenants in LORA_ROTATION order,
    one request at a time: loads, evictions and hits as the LRU predicts,
    the pool's storage where it was. Then, on a pool of its own, each
    tenant's load (artifact read, and the lane write with CUDA events)
    against the write's bound."""
    from runbooks_tpu_torch.ops.lora import write_lane
    from runbooks_tpu_torch.serve.engine import InferenceEngine, Request
    from runbooks_tpu_torch.serve.lora_pool import (
        AdapterPool,
        load_adapter_tree,
    )
    from runbooks_tpu_torch.utils.hw import H100_HBM_BW

    engine = InferenceEngine(cfg, params, max_slots=2, max_seq_len=512,
                             adapter_pool=2, lora_rank=LORA_RANK)

    def ptrs(pool):
        return [ab[k].data_ptr() for sub in pool.tree.values()
                for ab in sub.values() for k in ("a", "b")]

    before = ptrs(engine.adapters)
    with torch.no_grad():
        for t in LORA_ROTATION:
            engine.generate([Request(prompt_tokens=prompts[t][:64],
                                     max_tokens=4, adapter=paths[t])])
    st = engine.adapters.stats()
    got = (st["loads"], st["evictions"], st["hits"])
    want = lru_prediction(LORA_ROTATION, 2)
    in_place = ptrs(engine.adapters) == before
    free_engine(torch, engine)
    del engine
    # Per-tenant load timing on a 1-lane pool of its own.
    pool = AdapterPool(cfg, pool_size=1, rank=LORA_RANK,
                       device=params["embed"].device)
    loads = []
    for t, path in enumerate(paths):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        tree = load_adapter_tree(path, cfg, pool.targets, LORA_RANK)
        t1 = time.perf_counter()
        write_lane(pool.tree, tree, 0)
        torch.cuda.synchronize()
        t2 = time.perf_counter()
        write_ms = cuda_ms(lambda: write_lane(pool.tree, tree, 0), 5)
        host_bytes = sum(v.numel() * v.element_size()
                         for sub in tree.values() for ab in sub.values()
                         for v in ab.values())
        dev_bytes = host_bytes // 2         # the lane, written in bf16
        loads.append({
            "tenant": t, "rank": LORA_TENANTS[t][0],
            "read_s": t1 - t0, "artifact_to_lane_s": t2 - t0,
            "write_ms": write_ms, "host_bytes": host_bytes,
            "write_bound_ms": max(host_bytes / PCIE_GEN5_X16,
                                  dev_bytes / H100_HBM_BW) * 1e3,
            "write_gb_per_s": host_bytes / write_ms / 1e6})
    ok = got == want and in_place
    print("lora (b) " + json.dumps({
        "order": list(LORA_ROTATION), "loads_evictions_hits": got,
        "lru_prediction": want, "storage_in_place": in_place,
        "loads": loads,
        "pcie_gen5_x16_gb_per_s": PCIE_GEN5_X16 / 1e9}) + " -> "
        + ("ok" if ok else "FAIL"), flush=True)
    if not ok:
        raise SystemExit("lora (b): pool counters or storage off")
    del pool
    gc.collect()
    torch.cuda.empty_cache()


def lora_paged(torch, cfg, params, paths, prompts, seed, dense_ids,
               launches):
    """Phase 13 (c): the mix through a pooled PagedInferenceEngine
    (preemption on): greedy ids against (a)'s, radix pages never shared
    across adapters and reused within one, and a preempted tenant row
    resuming with its lane still pinned."""
    from runbooks_tpu_torch.serve.engine import Request
    from runbooks_tpu_torch.serve.paging import PagedInferenceEngine

    engine, samples, warm_s = warm_engine(
        torch, cfg, params, seed, cls=PagedInferenceEngine,
        adapter_pool=LORA_POOL, lora_rank=LORA_RANK, preemption="swap")
    reqs = lora_requests(prompts, paths)
    st, ids = timed_generate(torch, engine, samples, reqs)
    launches["lora_c_paged"] = st["flash_fwd_launches"]
    pool = engine.adapters
    for i, t in enumerate(LORA_MIX):
        lane = None if t is None else pool._by_name[paths[t]]
        near_tie_check(torch, cfg, params, f"lora (c) l{i}: greedy ids "
                       "paged vs dense, pooled", prompts[i], dense_ids[i],
                       ids[i], adapters=None if lane is None else (
                           pool.tree, torch.tensor([lane])))
    pager = engine.pager

    def turn(tokens, adapter):
        before = pager.pages_reused_total
        r = Request(prompt_tokens=list(tokens), max_tokens=8,
                    temperature=0.0, adapter=adapter)
        with torch.no_grad():
            engine.generate([r])
        return pager.pages_reused_total - before, r
    # Tenant 0's first prompt is in the tree under tenant 0 only.
    other, _ = turn(prompts[0], paths[1])
    same, _ = turn(prompts[0] + ids[0] + prompts[2][1:40], paths[0])
    # Preemption: 8 batch-class tenant rows fill the slots, an interactive
    # tenant arrives two steps later.
    held = []
    preempt = engine._preempt_slot

    def recording(slot):
        req = engine.slot_req[slot]
        preempt(slot)
        lane = req._adapter_lane
        held.append((req.request_id, lane, lane >= 0 and req in engine.queue
                     and pool._lane_ref[lane] >= 1))

    engine._preempt_slot = recording
    batch = [Request(prompt_tokens=list(p), max_tokens=LORA_PREEMPT_NEW,
                     temperature=0.0, priority="batch",
                     request_id=f"b{i}", adapter=paths[i % len(paths)])
             for i, p in enumerate(prompts)]
    inter = Request(prompt_tokens=list(prompts[3][:100]), max_tokens=8,
                    temperature=0.0, priority="interactive",
                    request_id="i0", adapter=paths[3])
    n0, r0 = engine.preemptions, engine.preempted_resumed
    with torch.no_grad():
        for r in batch:
            engine.submit(r)
        engine.step()
        engine.step()
        engine.submit(inter)
        while engine.has_work():
            engine.step()
    preemptions = engine.preemptions - n0
    resumed = engine.preempted_resumed - r0
    refs_after = list(pool._lane_ref)
    ok = (other == 0 and same > 0 and preemptions >= 1
          and resumed == preemptions and all(h[2] for h in held)
          and all(r.finish_reason == "length" for r in batch + [inter])
          and refs_after == [0] * LORA_POOL)
    print("lora (c) " + json.dumps({
        "run": st, "warmup_s": warm_s,
        "pages_reused_other_adapter": other,
        "pages_reused_same_tenant_turn2": same,
        "preemptions": preemptions, "resumed": resumed,
        "preempted_lane_pinned": held, "lane_refs_after": refs_after,
        "kv_occupancy": engine.kv_occupancy()}) + " -> "
        + ("ok" if ok else "FAIL"), flush=True)
    if not ok:
        raise SystemExit("lora (c): paged pool gates failed")
    free_engine(torch, engine)


def lora_spec(torch, cfg, params, paths, prompts, seed, dense_ids,
              launches):
    """Phase 13 (d): the mix on a pooled engine with n-gram speculation:
    greedy ids against (a)'s (no speculation), and the accept rate."""
    engine, samples, warm_s = warm_engine(
        torch, cfg, params, seed, adapter_pool=LORA_POOL,
        lora_rank=LORA_RANK, speculative="ngram")
    st, ids = timed_generate(torch, engine, samples,
                             lora_requests(prompts, paths))
    launches["lora_d_spec"] = st["flash_fwd_launches"]
    pool = engine.adapters
    print("lora (d) " + json.dumps({"run": st, "warmup_s": warm_s}),
          flush=True)
    if not st["verify_steps"]:
        raise SystemExit("lora (d): no verify step ran")
    for i, t in enumerate(LORA_MIX):
        lane = None if t is None else pool._by_name[paths[t]]
        near_tie_check(torch, cfg, params, f"lora (d) l{i}: greedy ids "
                       "speculative vs not, pooled", prompts[i],
                       dense_ids[i], ids[i], adapters=None if lane is None
                       else (pool.tree, torch.tensor([lane])))
    free_engine(torch, engine)


def lora_http(torch, cfg, params, root, prompts, dense_ids, pooled,
              launches):
    """Phase 13 (e): create_server(adapter_pool=4, adapter_dir=root):
    `"adapter": "tenant0"` answers 200 with (a)'s ids, an unknown adapter
    400."""
    from runbooks_tpu_torch.ops.flash_attention import flash_attention
    from runbooks_tpu_torch.serve.api import create_server
    from runbooks_tpu_torch.train.data import ByteTokenizer

    t0 = time.perf_counter()
    srv = create_server(cfg, params, host="127.0.0.1", port=0, max_slots=8,
                        max_seq_len=2048, warmup=True,
                        adapter_pool=LORA_POOL, lora_rank=LORA_RANK,
                        adapter_dir=root)
    ready_s = time.perf_counter() - t0
    thread = threading.Thread(target=srv.serve_forever, daemon=True)
    thread.start()
    engine = srv.worker.engine
    seen = []
    submit = engine.submit

    def recording_submit(req):
        seen.append(req)
        submit(req)

    engine.submit = recording_submit
    i = LORA_MIX.index(0)
    body = {"prompt": ByteTokenizer().decode(prompts[i][1:]),
            "max_tokens": LORA_NEW, "temperature": 0, "adapter": "tenant0"}
    base = f"http://127.0.0.1:{srv.port}"
    try:
        flash_attention.launches = 0
        status, _, text, wall = http_call(base, "/v1/completions", body)
        launches["lora_e_http"] = flash_attention.launches
        bad, _, bad_text, _ = http_call(base, "/v1/completions",
                                        {**body, "adapter": "tenant9"})
        stats = engine.adapter_stats()
    finally:
        srv.shutdown()
        thread.join(timeout=60)
    # The server stops at the byte tokenizer's EOS; (a)'s requests had
    # none, so its ids are cut after their first EOS, if any.
    eos = ByteTokenizer().eos_id
    want = dense_ids[i][:dense_ids[i].index(eos) + 1] \
        if eos in dense_ids[i] else dense_ids[i]
    ok = (status == 200 and bad == 400 and len(seen) == 1
          and seen[0].prompt_tokens == prompts[i]
          and json.loads(text)["choices"][0]["finish_reason"] in (
              "length", "stop"))
    print("lora (e) " + json.dumps({
        "ready_s": ready_s, "status": status, "wall_s": wall,
        "unknown_adapter_status": bad, "unknown_adapter_reply":
            bad_text[:200], "adapter_stats": stats,
        "flash_fwd_launches": launches["lora_e_http"]}) + " -> "
        + ("ok" if ok else "FAIL"), flush=True)
    if not ok:
        raise SystemExit(f"lora (e): {status} {text[:300]}")
    lane = pooled.adapters._by_name[os.path.join(root, "tenant0")]
    near_tie_check(torch, cfg, params, f"lora (e) l{i}: greedy ids over "
                   "HTTP vs (a)", prompts[i], want, seen[0].output_tokens,
                   adapters=(pooled.adapters.tree, torch.tensor([lane])))
    del srv, engine
    gc.collect()
    torch.cuda.empty_cache()


def lora_phase(torch, seed, workdir):
    """Phase 13: multi-tenant LoRA on llama3-8b bf16 at full width,
    SERVE_LAYERS layers. Returns K1's launches by run."""
    from runbooks_tpu_torch.serve.api import load_model

    t_phase = time.perf_counter()
    cfg, params = load_model({"model": "llama3-8b",
                              "model_overrides": {
                                  "param_dtype": "bfloat16",
                                  "num_layers": SERVE_LAYERS},
                              "seed": seed})
    root = os.path.join(workdir, "adapters")
    paths = write_tenants(torch, cfg, root, seed)
    prompts = lora_prompts(seed)
    launches = {}
    pooled, ids = lora_dense(torch, cfg, params, paths, prompts, seed,
                             launches)
    # Its pool stays resident for (c)-(e)'s near-tie references.
    free_engine(torch, pooled)
    lora_rotation(torch, cfg, params, paths, prompts)
    lora_paged(torch, cfg, params, paths, prompts, seed, ids, launches)
    lora_spec(torch, cfg, params, paths, prompts, seed, ids, launches)
    lora_http(torch, cfg, params, root, prompts, ids, pooled, launches)
    del pooled
    if min(launches.values()) < cfg.num_layers:
        raise SystemExit(f"phase 13 ran K1 too rarely: {launches}")
    print("phase 13 " + json.dumps({
        "flash_fwd_launches": launches,
        "seconds": time.perf_counter() - t_phase}), flush=True)
    del params
    gc.collect()
    torch.cuda.empty_cache()
    return launches


# ---------------------------------------------------------------------------
# Phase 14: quantized serving
# ---------------------------------------------------------------------------

def qmm_phase(torch, dev, seed):
    """Phase 14 (a): quantized_matmul at int8 and int4 on llama3-8b's
    wi_gate and MLP wo shapes, at decode and prefill rows, against the f32
    oracle ``x.float() @ dequantize(w)``; its time against its bound and
    against torch.matmul on the bf16 dequantized weight (a yardstick timed
    here, never called by the port). Returns the records."""
    from runbooks_tpu_torch.ops.quantization import (
        dequantize,
        quantize,
        quantized_matmul,
    )
    from runbooks_tpu_torch.utils.hw import H100_HBM_BW, H100_PEAK_BF16_FLOPS

    g = torch.Generator(device=dev).manual_seed(seed + 140)
    records = []
    for name, d_in, d_out in QMM_MATS:
        w = (torch.randn((d_in, d_out), generator=g, device=dev)
             * d_in ** -0.5).to(torch.bfloat16)
        for mode, bits in (("int8", 8), ("int4", 4)):
            qa = quantize(w, bits)
            oracle_w = dequantize(qa)
            yard_w = dequantize(qa, torch.bfloat16)
            for rows in QMM_ROWS:
                x = torch.randn((rows, d_in), generator=g,
                                device=dev).to(torch.bfloat16)
                with torch.no_grad():
                    got = quantized_matmul(x, qa, torch.bfloat16)
                    want = x.float() @ oracle_w
                    err = (got - want).abs().max().item()
                    scale = want.abs().max().item()
                    iters = 50 if rows <= 8 else 5
                    ms = cuda_ms(lambda: quantized_matmul(
                        x, qa, torch.bfloat16), iters)
                    lib_ms = cuda_ms(lambda: torch.matmul(x, yard_w), iters)
                nbytes = qa.nbytes + x.numel() * 2 + rows * d_out * 4
                flops = 2 * rows * d_in * d_out
                t_bytes = nbytes / H100_HBM_BW * 1e3
                t_ops = flops / H100_PEAK_BF16_FLOPS * 1e3
                rec = {"name": f"quantized_matmul_{mode}", "matrix": name,
                       "shape": [rows, d_in, d_out], "ms": ms,
                       "bound_ms": max(t_bytes, t_ops),
                       "bound_by": ("bytes" if t_bytes >= t_ops
                                    else "operations"),
                       "bf16_matmul_ms": lib_ms,
                       "max_abs_err": err, "max_abs_oracle": scale,
                       "tol": QMM_TOL * scale,
                       "ok": err <= QMM_TOL * scale}
                records.append(rec)
                print(f"quantized_matmul {mode} {name} x[{rows}, {d_in}]: "
                      f"{ms:.4f} ms (bound {rec['bound_ms']:.4f} by "
                      f"{rec['bound_by']}; bf16 matmul {lib_ms:.4f}) max "
                      f"|err| {err:.3e} (tol {QMM_TOL * scale:.3e}) -> "
                      f"{'ok' if rec['ok'] else 'FAIL'}", flush=True)
            del qa, oracle_w, yard_w
    if not all(r["ok"] for r in records):
        raise SystemExit("quantized_matmul disagrees with its f32 oracle")
    return records


def quantizable_bytes(params):
    """Bytes of the tree's quantizable matrices (QUANTIZABLE_KEYS), packed
    or not: what one decode forward must read of them."""
    from runbooks_tpu_torch.ops.quantization import (
        QUANTIZABLE_KEYS,
        QuantizedArray,
    )

    total = 0
    for group, keys in QUANTIZABLE_KEYS.items():
        for key in keys:
            w = params["layers"].get(group, {}).get(key)
            if isinstance(w, QuantizedArray):
                total += w.nbytes
            elif w is not None:
                total += w.numel() * w.element_size()
    return total


def quantize_load_phase(torch, params):
    """Phase 14 (b): quantize_params on the device at int8 and int4, each
    on a copy of the bf16 tree's dicts (the bf16 leaves stay): seconds,
    peak memory above the resident trees, weight bytes and the HBM bound
    of one decode forward's quantizable weights. Returns {mode: tree}."""
    from runbooks_tpu_torch.ops.quantization import (
        quantize_params,
        tree_weight_bytes,
    )
    from runbooks_tpu_torch.utils.hw import H100_HBM_BW
    from runbooks_tpu_torch.utils.tree import tree_map

    trees = {}
    stats = {"bf16": {"weight_bytes": tree_weight_bytes(params),
                      "quantizable_bytes": quantizable_bytes(params)}}
    for mode in ("int8", "int4"):
        tree = tree_map(lambda t: t, params)
        torch.cuda.synchronize()
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        quantize_params(tree, mode)
        torch.cuda.synchronize()
        stats[mode] = {
            "seconds": time.perf_counter() - t0,
            "peak_gb_above_resident": (torch.cuda.max_memory_allocated()
                                       - base) / 1e9,
            "weight_bytes": tree_weight_bytes(tree),
            "quantizable_bytes": quantizable_bytes(tree)}
        trees[mode] = tree
    for st in stats.values():
        st["decode_weights_hbm_bound_ms"] = (st["quantizable_bytes"]
                                             / H100_HBM_BW * 1e3)
    print("quantize (b) " + json.dumps(stats), flush=True)
    return trees


def record_first_logits(engine, prompts, store):
    """Record the first-token logits of each real row of the engine's
    prefill dispatches, by prompt index, into ``store``."""
    prefill = engine._prefill

    def recording(params_, pool, tokens, positions, slots, last_pos, *args,
                  **kw):
        first, pool, logits = prefill(params_, pool, tokens, positions,
                                      slots, last_pos, *args, **kw)
        toks, pos0 = tokens.tolist(), positions[:, 0].tolist()
        for r, m in enumerate(x + 1 for x in last_pos.tolist()):
            row = toks[r][:m]
            if pos0[r] != engine._pad_slot and row in prompts:
                store.setdefault(prompts.index(row),
                                 logits[r].float().clone())
        return first, pool, logits

    engine._prefill = recording


def cache_bytes_expected(cfg, quantized):
    """The dense slot pool's bytes at max_slots=8, max_seq_len=2048 (+1
    trash slot): K and V, with one f32 scale per (layer, slot, position,
    kv head) beside int8 values."""
    per = cfg.head_dim + 4 if quantized else cfg.head_dim * 2
    return 2 * cfg.num_layers * 8 * 2049 * cfg.num_kv_heads * per


def quant_dense_phase(torch, cfg, params, trees, seed, launches):
    """Phase 14 (c): phase 4's mix through four warmed-up dense engines,
    all resident, run bf16, kv8, w8, w4, kv8, bf16 (the two close ones
    twice, host drift on both sides): int8 weights (int8 KV by default),
    int4 weights (int8 KV), bf16 weights with int8 KV, and the bf16
    baseline. Returns the w8 engine and its ids."""
    from runbooks_tpu_torch.ops.quantization import (
        QuantizedArray,
        dequantize,
    )
    from runbooks_tpu_torch.serve.engine import (
        InferenceEngine,
        _buckets,
        bucket_for,
    )
    from runbooks_tpu_torch.utils.tree import tree_map

    prompts = smoke_prompts(seed)
    setups = {"bf16": (cfg, params, {}),
              "kv8": (cfg, params, {"quantize_kv": True}),
              "w8": (dataclasses.replace(cfg, quantize="int8"),
                     trees["int8"], {}),
              "w4": (dataclasses.replace(cfg, quantize="int4"),
                     trees["int4"], {"quantize_kv": True})}
    engines, first = {}, {}
    for name, (c, p, kw) in setups.items():
        engines[name] = warm_engine(torch, c, p, seed, **kw)
        first[name] = {}
        record_first_logits(engines[name][0], prompts, first[name])
    runs = {name: [] for name in setups}
    ids = {}
    for name in ("bf16", "kv8", "w8", "w4", "kv8", "bf16"):
        engine, samples, warm_s = engines[name]
        reqs = smoke_requests(prompts, {})
        torch.cuda.reset_peak_memory_stats()
        st, run_ids = timed_generate(torch, engine, samples, reqs)
        st.update(warmup_s=warm_s, max_memory_allocated_gb=(
            torch.cuda.max_memory_allocated() / 1e9))
        if not all(len(x) == MAX_TOKENS for x in run_ids):
            raise SystemExit(f"quantized (c) {name}: not every request got "
                             f"{MAX_TOKENS} tokens: {st}")
        ids.setdefault(name, run_ids)
        runs[name].append(st)
        launches[f"quant_c_{name}"] = st["flash_fwd_launches"]
    stats = {}
    for name, (c, p, kw) in setups.items():
        engine = engines[name][0]
        occ = engine.kv_occupancy()
        # One decode chunk of 8 live rows admitted in one step, traced;
        # the requests end after the next chunk.
        mix = lora_requests(lora_prompts(seed), [None] * len(LORA_TENANTS))
        for r in mix:
            r.max_tokens = 2 * engine.decode_chunk + 1
        stats[name] = {
            "runs": runs[name],
            "decode_tokens_per_s": [st["decode_tokens_per_s"]
                                    for st in runs[name]],
            "kv_pool_bytes": occ["kv_pool_bytes"],
            "kv_bytes_per_token": occ["kv_pool_bytes"] // (8 * 2049),
            "decode_forward": decode_forward_activity(torch, engine, mix),
            "greedy_rows_equal_bf16": sum(
                ids[name][i] == ids["bf16"][i]
                for i in range(0, len(prompts), 2))}
    print("quantized (c) " + json.dumps(stats), flush=True)
    per_run = {st["flash_fwd_launches"] for r in runs.values() for st in r}
    gates = {
        "k1_launches_equal": len(per_run) == 1,
        "cache_bytes": all(
            stats[name]["kv_pool_bytes"] == cache_bytes_expected(
                cfg, name != "bf16") for name in setups)}
    # First-token logits of each engine's own dispatches against a full
    # prefill of the prompt on the same params.
    worst = {}
    with torch.no_grad():
        for name, (c, p, kw) in setups.items():
            if sorted(first[name]) != list(range(len(prompts))):
                raise SystemExit(f"quantized (c) {name}: first-token "
                                 f"logits of {sorted(first[name])} only")
            worst[name] = max(
                (first[name][i] - prefill_logits(
                    torch, c, p, prompt, bucket_for(_buckets(2048),
                                                    len(prompt)),
                    2048)).abs().max().item()
                for i, prompt in enumerate(prompts))
    gates["first_logits_within_tol"] = max(worst.values()) <= LOGIT_TOL
    print(f"quantized (c): first-token logits vs a full prefill, max "
          f"|diff| by engine {worst} (tol {LOGIT_TOL}); gates {gates}",
          flush=True)
    if not all(gates.values()):
        raise SystemExit(f"quantized (c): gates failed: {gates}")
    for i in range(0, len(prompts), 2):      # the greedy requests
        near_tie_check(torch, cfg, params, f"quantized (c) r{i}: greedy "
                       "ids int8 KV vs bf16", prompts[i], ids["bf16"][i],
                       ids["kv8"][i])
    w8 = engines["w8"][0]
    for name in ("kv8", "bf16", "w4"):
        free_engine(torch, engines[name][0])
    del engines
    # Each quantized tree against a bf16-KV engine over its own
    # dequantized weights.
    for name, mode in (("w8", "int8"), ("w4", "int4")):
        deq = tree_map(lambda t: dequantize(t, torch.bfloat16)
                       if isinstance(t, QuantizedArray) else t, trees[mode])
        engine = InferenceEngine(cfg, deq, max_slots=8, max_seq_len=2048,
                                 seed=seed, quantize_kv=False)
        reqs = smoke_requests(prompts, {})
        with torch.no_grad():
            engine.generate(reqs)
        for i in range(0, len(prompts), 2):
            near_tie_check(torch, cfg, deq, f"quantized (c) r{i}: greedy "
                           f"ids {mode} vs its dequantized weights",
                           prompts[i], reqs[i].output_tokens, ids[name][i])
        free_engine(torch, engine)
        del engine, deq
    return w8, ids["w8"]


def quant_paged_phase(torch, cfg, params, seed, dense_ids, launches):
    """Phase 14 (d): the int8 tree through the paged engine with int8
    pages; one int8 page's round trip through the pinned host tier."""
    from runbooks_tpu_torch.serve.paging import PagedInferenceEngine

    prompts = smoke_prompts(seed)
    engine = PagedInferenceEngine(cfg, params, max_slots=8,
                                  max_seq_len=2048, seed=seed)
    if not engine.cache.quantized:
        raise SystemExit("quantized (d): the int8 tree's pages are not int8")
    st, ids = timed_generate(torch, engine, {}, smoke_requests(prompts, {}))
    launches["quant_d_paged"] = st["flash_fwd_launches"]
    swap = swap_timing(torch, cfg, engine)
    print("quantized (d) " + json.dumps({
        "run": st, "kv_occupancy": engine.kv_occupancy(),
        "swap_timing": swap}), flush=True)
    if st["flash_fwd_launches"] != launches["quant_c_w8"]:
        raise SystemExit("quantized (d): K1 launched "
                         f"{st['flash_fwd_launches']} times, the dense "
                         f"engine {launches['quant_c_w8']}")
    if not swap["round_trip_bit_identical"]:
        raise SystemExit("quantized (d): an int8 page came back changed")
    for i in range(0, len(prompts), 2):
        near_tie_check(torch, cfg, params, f"quantized (d) r{i}: greedy "
                       "ids paged vs dense (int8)", prompts[i],
                       dense_ids[i], ids[i])
    free_engine(torch, engine)


def quant_lora_phase(torch, cfg, params, plain, seed, workdir, launches):
    """Phase 14 (e): phase 13's four tenants in a pool over the int8 base,
    against the no-pool int8 engine ``plain`` on the same mix."""
    from runbooks_tpu_torch.serve.engine import InferenceEngine

    paths = write_tenants(torch, cfg, os.path.join(workdir, "adapters14"),
                          seed)
    prompts = lora_prompts(seed)
    pooled = InferenceEngine(cfg, params, max_slots=8, max_seq_len=2048,
                             seed=seed, adapter_pool=LORA_POOL,
                             lora_rank=LORA_RANK)
    records = {"pooled": [], "plain": []}
    record_prefills(pooled, records["pooled"])
    record_prefills(plain, records["plain"])
    ids = {}
    for name, engine, tenants in (("plain", plain, [None] * 4),
                                  ("pooled", pooled, paths)):
        st, ids[name] = timed_generate(torch, engine, {},
                                       lora_requests(prompts, tenants))
        launches[f"quant_e_{name}"] = st["flash_fwd_launches"]
    base_rows = [i for i, t in enumerate(LORA_MIX) if t is None]
    tenant_rows = [i for i, t in enumerate(LORA_MIX) if t is not None]
    gates = {
        "one_prefill_dispatch_each": (len(records["pooled"]) == 1
                                      and len(records["plain"]) == 1),
        "base_rows_ids_equal": all(ids["pooled"][i] == ids["plain"][i]
                                   for i in base_rows),
        "base_rows_logits_bitwise": all(
            torch.equal(records["pooled"][0][1][i],
                        records["plain"][0][1][i]) for i in base_rows),
        "every_tenant_row_differs": all(ids["pooled"][i] != ids["plain"][i]
                                        for i in tenant_rows),
        "k1_launches_equal": (launches["quant_e_pooled"]
                              == launches["quant_e_plain"])}
    print(f"quantized (e): pool over the int8 base, prefill lanes "
          f"{records['pooled'][0][0]}; gates {gates}", flush=True)
    if not all(gates.values()):
        raise SystemExit(f"quantized (e): gates failed: {gates}")
    free_engine(torch, pooled)


def quant_entry_phase(torch, dev, seed, workdir, launches):
    """Phase 14 (f): phase 9's HF directory imported with quantize: int8
    through ``python -m runbooks_tpu_torch.models.loader``, restored
    packed by load_model and held to the same source quantized in memory;
    then P3's case, ``model_overrides: {"quantize": "int8"}``."""
    from runbooks_tpu_torch.models.config import get_config
    from runbooks_tpu_torch.models.convert import convert
    from runbooks_tpu_torch.models.safetensors_io import load_state_dict
    from runbooks_tpu_torch.ops.flash_attention import flash_attention
    from runbooks_tpu_torch.ops.quantization import QuantizedArray
    from runbooks_tpu_torch.serve.api import load_model
    from runbooks_tpu_torch.serve.engine import InferenceEngine, Request
    from runbooks_tpu_torch.utils.tree import tree_leaves, tree_map

    overrides = {"num_layers": IMPORT_LAYERS}
    cfg = get_config("llama3-8b", **overrides)
    src = f"{workdir}/hf_llama3_8b"
    if not os.path.isdir(src):
        write_hf_llama(torch, dev, cfg, src, seed, IMPORT_SHARDS)
    content = f"{workdir}/import_int8_content"
    params = {"model": "llama3-8b", "model_overrides": overrides,
              "source": "dir", "dir": src, "quantize": "int8"}
    returncode, import_s, peak_rss_gb, log_text = run_loader(content,
                                                             params)
    artifacts = f"{content}/artifacts"
    if returncode != 0:
        print(log_text[-3000:], flush=True)
        raise SystemExit(f"the int8 import exited {returncode}")
    with open(f"{artifacts}/model.json") as f:
        meta = json.load(f)
    lines = log_text.strip().splitlines()
    spans = next((json.loads(ln)["spans"] for ln in reversed(lines)
                  if ln.startswith('{"spans"')), {})
    qcfg, restored = load_model({**params, "checkpoint": artifacts})
    in_memory = tree_map(lambda t: t.to(dev), convert(
        cfg, load_state_dict(src), cfg.param_dtype, "int8"))
    n_leaves = n_equal = 0
    for a, b in zip(tree_leaves(restored), tree_leaves(in_memory)):
        n_leaves += 1
        if isinstance(b, QuantizedArray):
            n_equal += int(isinstance(a, QuantizedArray)
                           and (a.bits, a.block_size) == (b.bits,
                                                          b.block_size)
                           and torch.equal(a.values, b.values)
                           and torch.equal(a.scales, b.scales))
        else:
            n_equal += int(torch.equal(a, b))
    prompts = smoke_prompts(seed)[:4]

    def greedy(p):
        reqs = [Request(prompt_tokens=x, max_tokens=MAX_TOKENS)
                for x in prompts]
        with torch.no_grad():
            InferenceEngine(qcfg, p, max_slots=8, max_seq_len=2048,
                            seed=seed).generate(reqs)
        return [r.output_tokens for r in reqs]

    flash_attention.launches = 0
    got = greedy(restored)
    launches["quant_f_import"] = flash_attention.launches
    want = greedy(in_memory)
    stats = {"import_s": import_s, "loader_peak_rss_gb": peak_rss_gb,
             "loader_spans": spans, "model_json": meta,
             "checkpoint_bytes": os.path.getsize(
                 f"{artifacts}/checkpoints/0/state.pt"),
             "leaves_equal": f"{n_equal}/{n_leaves}",
             "greedy_ids_equal": got == want}
    print("quantized (f) import " + json.dumps(stats), flush=True)
    if (meta.get("quantize") != "int8" or qcfg.quantize != "int8"
            or n_equal != n_leaves or got != want):
        raise SystemExit("quantized (f): the int8 import does not restore "
                         "as the source quantized in memory")
    del restored, in_memory
    gc.collect()
    torch.cuda.empty_cache()
    # P3: the mode in the config's overrides, not in params.
    cfg, p3 = load_model({"model": "llama3-8b", "seed": seed,
                          "model_overrides": {"quantize": "int8",
                                              "param_dtype": "bfloat16",
                                              "num_layers": QUANT_LAYERS}})
    engine = InferenceEngine(cfg, p3, max_slots=8, max_seq_len=2048,
                             seed=seed)
    wq = p3["layers"]["attn"]["wq"]
    reqs = [Request(prompt_tokens=x, max_tokens=8) for x in prompts[:2]]
    flash_attention.launches = 0
    with torch.no_grad():
        engine.generate(reqs)
    launches["quant_f_p3"] = flash_attention.launches
    ok = (cfg.quantize == "int8" and isinstance(wq, QuantizedArray)
          and wq.bits == 8 and engine.cache.quantized
          and all(len(r.output_tokens) == 8 for r in reqs))
    print(f"quantized (f) P3: model_overrides quantize int8 -> cfg "
          f"{cfg.quantize}, wq {type(wq).__name__} bits "
          f"{getattr(wq, 'bits', None)}, cache int8 "
          f"{engine.cache.quantized} -> {'ok' if ok else 'FAIL'}",
          flush=True)
    if not ok:
        raise SystemExit("quantized (f): P3's case does not serve int8")
    free_engine(torch, engine)


def quant_phase(torch, dev, seed, workdir):
    """Phase 14: quantized serving on llama3-8b bf16 at full width, cut
    to QUANT_LAYERS layers. Returns (K1's launches by run, quantized_matmul records)."""
    from runbooks_tpu_torch.serve.api import load_model

    t_phase = time.perf_counter()
    launches = {}
    records = qmm_phase(torch, dev, seed)
    cfg, params = load_model({"model": "llama3-8b",
                              "model_overrides": {
                                  "param_dtype": "bfloat16",
                                  "num_layers": QUANT_LAYERS},
                              "seed": seed})
    trees = quantize_load_phase(torch, params)
    w8, w8_ids = quant_dense_phase(torch, cfg, params, trees, seed,
                                   launches)
    del params
    gc.collect()
    torch.cuda.empty_cache()
    cfg8 = dataclasses.replace(cfg, quantize="int8")
    quant_paged_phase(torch, cfg8, trees["int8"], seed, w8_ids, launches)
    quant_lora_phase(torch, cfg8, trees["int8"], w8, seed, workdir,
                     launches)
    free_engine(torch, w8)
    del w8, trees
    gc.collect()
    torch.cuda.empty_cache()
    quant_entry_phase(torch, dev, seed, workdir, launches)
    if min(launches.values()) < 1:
        raise SystemExit(f"phase 14 ran K1 too rarely: {launches}")
    print("phase 14 " + json.dumps({
        "flash_fwd_launches": launches,
        "seconds": time.perf_counter() - t_phase}), flush=True)
    gc.collect()
    torch.cuda.empty_cache()
    return launches, records



# ---------------------------------------------------------------------------
# Phase 15: the text path
# ---------------------------------------------------------------------------

# llama3-instruct's and llama2-chat's chat templates, as their
# tokenizer_config.json files hold them.
LLAMA3_CHAT = (
    "{% set loop_messages = messages %}{% for message in loop_messages %}"
    "{% set content = '<|start_header_id|>' + message['role'] + "
    "'<|end_header_id|>\n\n'+ message['content'] | trim + '<|eot_id|>' %}"
    "{% if loop.index0 == 0 %}{% set content = bos_token + content %}"
    "{% endif %}{{ content }}{% endfor %}{% if add_generation_prompt %}"
    "{{ '<|start_header_id|>assistant<|end_header_id|>\n\n' }}{% endif %}")
LLAMA2_CHAT = (
    "{% if messages[0]['role'] == 'system' %}{% set loop_messages = "
    "messages[1:] %}{% set system_message = messages[0]['content'] %}"
    "{% else %}{% set loop_messages = messages %}{% set system_message = "
    "false %}{% endif %}{% for message in loop_messages %}{% if "
    "(message['role'] == 'user') != (loop.index0 % 2 == 0) %}{{ "
    "raise_exception('Conversation roles must alternate user/assistant/"
    "user/assistant/...') }}{% endif %}{% if loop.index0 == 0 and "
    "system_message != false %}{% set content = '<<SYS>>\\n' + "
    "system_message + '\\n<</SYS>>\\n\\n' + message['content'] %}{% else "
    "%}{% set content = message['content'] %}{% endif %}{% if "
    "message['role'] == 'user' %}{{ bos_token + '[INST] ' + "
    "content.strip() + ' [/INST]' }}{% elif message['role'] == "
    "'assistant' %}{{ ' '  + content.strip() + ' ' + eos_token }}"
    "{% endif %}{% endfor %}")
L3_REGULAR = 128000       # byte-level tokens: 256 bytes + 127,744 merges
L3_SPECIALS = 256         # added specials at 128000..128255
L2_VOCAB = 32000          # <unk>, <s>, </s>, 256 <0xXX>, pieces
SEEDED_TEXT_CHARS = 400_000   # CJK, emoji, digits, other scripts
TEXT_MIN_BYTES = 4_000_000
TEXT_DOC_CHARS = 8192
TEXT_LAYERS = 4           # (d) llama3-8b at full width, cut to 4 layers
TEXT_LLAMA2_LAYERS = 2    # (e) llama2-7b at full width, cut to 2 layers
CHAT_PROMPT_TOKENS = 2000  # (e) the templated prompt, at most


def llama3_special_names():
    """The 256 names llama3 gives its specials, in id order."""
    names = ["<|begin_of_text|>", "<|end_of_text|>"]
    names += [f"<|reserved_special_token_{i}|>" for i in range(4)]
    names += ["<|start_header_id|>", "<|end_header_id|>",
              "<|reserved_special_token_4|>", "<|eot_id|>"]
    names += [f"<|reserved_special_token_{i}|>"
              for i in range(5, 5 + L3_SPECIALS - len(names))]
    return names


def repo_documents(root):
    """The checkout's own *.md and *.py files, in path order."""
    docs = []
    for d, dirs, files in os.walk(root):
        dirs[:] = sorted(x for x in dirs if not x.startswith(".")
                         and x not in ("build", "__pycache__"))
        for name in sorted(files):
            if name.endswith((".md", ".py")):
                with open(os.path.join(d, name), encoding="utf-8",
                          errors="replace") as f:
                    docs.append(f.read())
    return docs


def seeded_documents(seed, n_chars):
    """Seeded words in CJK, Hangul, Greek, Cyrillic, emoji (astral) and
    digit runs, with spaces, punctuation and newlines, cut into
    TEXT_DOC_CHARS-character documents."""
    import numpy as np

    rng = np.random.default_rng(seed + 15)
    pools = [(0x4E00, 0x9FFF), (0xAC00, 0xD7A3), (0x3B1, 0x3C9),
             (0x430, 0x44F), (0x1F300, 0x1F64F), (0x30, 0x39)]
    seps = [" ", " ", " ", ", ", ". ", "\n", "  ", "\t"]
    out, n = [], 0
    while n < n_chars:
        lo, hi = pools[int(rng.integers(len(pools)))]
        k = int(rng.integers(1, 9))
        word = "".join(chr(int(c)) for c in rng.integers(lo, hi + 1, k))
        word += seps[int(rng.integers(len(seps)))]
        out.append(word)
        n += len(word)
    text = "".join(out)
    return [text[i:i + TEXT_DOC_CHARS]
            for i in range(0, len(text), TEXT_DOC_CHARS)]


def _chain(vocab, merges, word, limit):
    """Merges that build ``word`` left to right from its characters, each
    a merge of two earlier tokens (its prefix and one character)."""
    for j in range(1, len(word)):
        if len(merges) >= limit:
            return
        if word[j] not in vocab:
            return
        new = word[:j + 1]
        if new not in vocab:
            vocab[new] = len(vocab)
            merges.append([word[:j], word[j]])


def write_llama3_tokenizer(directory, docs, seed, regular=L3_REGULAR):
    """A llama3-style tokenizer directory: byte-level BPE over the 256
    byte symbols and ``regular`` - 256 merges, each of two earlier tokens
    within one pre-token of llama3's split (a counting pass over ``docs``'
    byte pairs, then the pre-tokens of ``docs`` from the most frequent
    down built left to right, then seeded pre-tokens), llama3's
    TemplateProcessing and ByteLevel decoder, 256 specials named as
    llama3 names them and llama3-instruct's chat template."""
    import collections

    import numpy as np

    from runbooks_tpu_torch.models import tokenizer_io as tio

    rx = tio.split_regex(tio.LLAMA3_PATTERN)
    table = {b: c for b, c in enumerate(tio.bytes_to_unicode())}
    counts = collections.Counter()
    for doc in docs:
        counts.update(rx.findall(doc))
    words = [w.encode("utf-8").decode("latin-1").translate(table)
             for w, _ in counts.most_common()]
    vocab = {c: i for i, c in enumerate(tio.bytes_to_unicode())}
    merges = []
    n_merges = regular - len(vocab)
    pairs = collections.Counter()
    for w, (_, n) in zip(words[:20000], counts.most_common(20000)):
        for k in range(len(w) - 1):
            pairs[w[k:k + 2]] += n
    for pair, _ in pairs.most_common(2000):
        if pair not in vocab:
            vocab[pair] = len(vocab)
            merges.append([pair[0], pair[1]])
    for w in words:
        if len(merges) >= n_merges:
            break
        _chain(vocab, merges, w, n_merges)
    rng = np.random.default_rng(seed + 30)
    letters = [chr(c) for c in range(0x61, 0x7B)] + \
        [chr(c) for c in range(0x3B1, 0x3CA)] + \
        [chr(c) for c in range(0x4E00, 0x4E00 + 400)]
    while len(merges) < n_merges:
        k = int(rng.integers(2, 10))
        w = (" " if rng.random() < 0.6 else "") + "".join(
            letters[int(i)] for i in rng.integers(len(letters), size=k))
        _chain(vocab, merges, w.encode("utf-8").decode("latin-1")
               .translate(table), n_merges)
    names = llama3_special_names()
    added = [{"id": regular + i, "content": s, "single_word": False,
              "lstrip": False, "rstrip": False, "normalized": False,
              "special": True} for i, s in enumerate(names)]
    bos = names[0]
    spec = {
        "version": "1.0", "truncation": None, "padding": None,
        "added_tokens": added, "normalizer": None,
        "pre_tokenizer": {"type": "Sequence", "pretokenizers": [
            {"type": "Split", "pattern": {"Regex": tio.LLAMA3_PATTERN},
             "behavior": "Isolated", "invert": False},
            {"type": "ByteLevel", "add_prefix_space": False,
             "trim_offsets": True, "use_regex": False}]},
        "post_processor": {"type": "Sequence", "processors": [
            {"type": "ByteLevel", "add_prefix_space": True,
             "trim_offsets": False, "use_regex": True},
            {"type": "TemplateProcessing",
             "single": [{"SpecialToken": {"id": bos, "type_id": 0}},
                        {"Sequence": {"id": "A", "type_id": 0}}],
             "pair": [{"SpecialToken": {"id": bos, "type_id": 0}},
                      {"Sequence": {"id": "A", "type_id": 0}},
                      {"SpecialToken": {"id": bos, "type_id": 1}},
                      {"Sequence": {"id": "B", "type_id": 1}}],
             "special_tokens": {bos: {"id": bos, "ids": [regular],
                                      "tokens": [bos]}}}]},
        "decoder": {"type": "ByteLevel", "add_prefix_space": True,
                    "trim_offsets": True, "use_regex": True},
        "model": {"type": "BPE", "dropout": None, "unk_token": None,
                  "continuing_subword_prefix": None,
                  "end_of_word_suffix": None, "fuse_unk": False,
                  "byte_fallback": False, "ignore_merges": True,
                  "vocab": vocab, "merges": merges}}
    config = {"tokenizer_class": "PreTrainedTokenizerFast",
              "bos_token": bos, "eos_token": "<|eot_id|>",
              "clean_up_tokenization_spaces": True,
              "model_input_names": ["input_ids", "attention_mask"],
              "model_max_length": 1000000000000000019884624838656,
              "chat_template": LLAMA3_CHAT}
    _write_tokenizer(directory, spec, config)


def write_llama2_tokenizer(directory, docs, seed, size=L2_VOCAB):
    """A llama2-style tokenizer directory: byte-fallback BPE of ``size``
    tokens (<unk>, <s>, </s>, <0x00>..<0xFF>, the most frequent
    characters of ``docs``, then pieces built left to right from their
    most frequent sentencepiece words and seeded ones), llama2's
    Prepend/Replace normalizers and Replace, ByteFallback, Fuse, Strip
    decoder, under LlamaTokenizerFast's config with llama2-chat's
    template."""
    import collections

    import numpy as np

    sp = "▁"
    vocab = {"<unk>": 0, "<s>": 1, "</s>": 2}
    vocab.update({f"<0x{b:02X}>": 3 + b for b in range(256)})
    chars = collections.Counter()
    pieces = collections.Counter()
    for doc in docs:
        norm = sp + doc.replace(" ", sp)
        chars.update(norm)
        pieces.update(sp + w for w in norm.split(sp) if w)
    for c, _ in chars.most_common(600):
        vocab.setdefault(c, len(vocab))
    merges = []
    n_merges = size - len(vocab)
    for w, _ in pieces.most_common():
        if len(merges) >= n_merges:
            break
        _chain(vocab, merges, w, n_merges)
    rng = np.random.default_rng(seed + 31)
    letters = [c for c, _ in chars.most_common(60) if c.isalpha()]
    while len(merges) < n_merges:
        k = int(rng.integers(2, 9))
        _chain(vocab, merges, sp + "".join(
            letters[int(i)] for i in rng.integers(len(letters), size=k)),
            n_merges)
    added = [{"id": i, "content": s, "single_word": False, "lstrip": False,
              "rstrip": False, "normalized": False, "special": True}
             for i, s in enumerate(("<unk>", "<s>", "</s>"))]
    spec = {
        "version": "1.0", "truncation": None, "padding": None,
        "added_tokens": added,
        "normalizer": {"type": "Sequence", "normalizers": [
            {"type": "Prepend", "prepend": sp},
            {"type": "Replace", "pattern": {"String": " "},
             "content": sp}]},
        "pre_tokenizer": None,
        "post_processor": {
            "type": "TemplateProcessing",
            "single": [{"SpecialToken": {"id": "<s>", "type_id": 0}},
                       {"Sequence": {"id": "A", "type_id": 0}}],
            "pair": [{"SpecialToken": {"id": "<s>", "type_id": 0}},
                     {"Sequence": {"id": "A", "type_id": 0}},
                     {"SpecialToken": {"id": "<s>", "type_id": 1}},
                     {"Sequence": {"id": "B", "type_id": 1}}],
            "special_tokens": {"<s>": {"id": "<s>", "ids": [1],
                                       "tokens": ["<s>"]}}},
        "decoder": {"type": "Sequence", "decoders": [
            {"type": "Replace", "pattern": {"String": sp}, "content": " "},
            {"type": "ByteFallback"}, {"type": "Fuse"},
            {"type": "Strip", "content": " ", "start": 1, "stop": 0}]},
        "model": {"type": "BPE", "dropout": None, "unk_token": "<unk>",
                  "continuing_subword_prefix": None,
                  "end_of_word_suffix": None, "fuse_unk": True,
                  "byte_fallback": True, "ignore_merges": False,
                  "vocab": vocab, "merges": merges}}
    config = {"tokenizer_class": "LlamaTokenizerFast",
              "bos_token": "<s>", "eos_token": "</s>", "unk_token": "<unk>",
              "pad_token": None, "add_bos_token": True,
              "add_eos_token": False, "legacy": False,
              "clean_up_tokenization_spaces": False,
              "model_max_length": 1000000000000000019884624838656,
              "chat_template": LLAMA2_CHAT}
    _write_tokenizer(directory, spec, config)


def _write_tokenizer(directory, spec, config):
    os.makedirs(directory, exist_ok=True)
    with open(f"{directory}/tokenizer.json", "w", encoding="utf-8") as f:
        json.dump(spec, f, ensure_ascii=False)
    with open(f"{directory}/tokenizer_config.json", "w",
              encoding="utf-8") as f:
        json.dump(config, f, ensure_ascii=False, indent=2)


def text_corpus(seed):
    """Phase 15's corpus: the checkout's *.md/*.py files and seeded
    documents of other scripts, at least TEXT_MIN_BYTES of UTF-8."""
    root = os.path.dirname(os.path.abspath(__file__))
    docs = repo_documents(root) + seeded_documents(seed, SEEDED_TEXT_CHARS)
    n_bytes = sum(len(d.encode("utf-8")) for d in docs)
    if n_bytes < TEXT_MIN_BYTES:
        docs += seeded_documents(seed + 1, TEXT_MIN_BYTES - n_bytes)
    return docs


def tokenizer_host_numbers(name, path, docs, want_sizes):
    """Phase 15 (b) for one directory: load seconds, encode and decode
    rates over ``docs`` and the exact round trip. Returns (tokenizer,
    record)."""
    from runbooks_tpu_torch.train.data import load_tokenizer

    t0 = time.perf_counter()
    tok = load_tokenizer(path)
    load_s = time.perf_counter() - t0
    if (tok.vocab_size, len(tok)) != want_sizes:
        raise SystemExit(f"{name} tokenizer: vocab_size {tok.vocab_size}, "
                         f"len {len(tok)}; expected {want_sizes}")
    n_bytes = sum(len(d.encode("utf-8")) for d in docs)
    t0 = time.perf_counter()
    # Special tokens' strings in the text stay text: what comes back must
    # be the text itself.
    enc = [tok.encode(d, add_special_tokens=False, split_special_tokens=True)
           for d in docs]
    encode_s = time.perf_counter() - t0
    n_tokens = sum(map(len, enc))
    t0 = time.perf_counter()
    dec = [tok.decode(e, clean_up_tokenization_spaces=False) for e in enc]
    decode_s = time.perf_counter() - t0
    # A sentencepiece vocabulary spells U+2581 as its space: the one
    # character such a tokenizer cannot give back.
    want = docs if name == "llama3" else [d.replace("▁", " ") for d in docs]
    bad = [k for k, (a, b) in enumerate(zip(dec, want)) if a != b]
    rec = {"load_s": load_s, "documents": len(docs), "bytes": n_bytes,
           "tokens": n_tokens, "encode_s": encode_s,
           "encode_mb_per_s": n_bytes / encode_s / 1e6,
           "encode_tokens_per_s": n_tokens / encode_s,
           "decode_s": decode_s, "decode_mb_per_s": n_bytes / decode_s / 1e6,
           "round_trip_exact_documents": len(docs) - len(bad),
           "documents_with_u2581": sum("▁" in d for d in docs)}
    print(f"tokenizer {name}: " + json.dumps(rec), flush=True)
    if bad:
        k = bad[0]
        i = next((j for j, (a, b) in enumerate(zip(dec[k], want[k]))
                  if a != b), min(len(dec[k]), len(want[k])))
        raise SystemExit(f"{name}: decode(encode(t)) != t on {len(bad)} "
                         f"documents; first at char {i}: "
                         f"{want[k][max(0, i - 20):i + 20]!r} -> "
                         f"{dec[k][max(0, i - 20):i + 20]!r}")
    return tok, rec


def dataset_load(workdir, docs):
    """Phase 15 (c): ``python -m runbooks_tpu_torch.train.dataset_loader``
    over a local .jsonl and a file:// URL of another; the manifest's rows
    and bytes against the files. Returns (the filled directory,
    record)."""
    src = f"{workdir}/text_sources"
    os.makedirs(src, exist_ok=True)
    half = len(docs) // 2
    rows = {}
    for name, part in (("a_docs.jsonl", docs[:half]),
                       ("b_docs.jsonl", docs[half:])):
        with open(f"{src}/{name}", "w", encoding="utf-8") as f:
            for d in part:
                f.write(json.dumps({"text": d}) + "\n")
        rows[name] = len(part)
    content = f"{workdir}/dataset_content"
    os.makedirs(content)
    with open(f"{content}/params.json", "w") as f:
        json.dump({"paths": [f"{src}/a_docs.jsonl"],
                   "urls": f"file://{src}/b_docs.jsonl"}, f)
    root = os.path.dirname(os.path.abspath(__file__))
    env = dict(os.environ, RBT_CONTENT_DIR=content,
               PYTHONPATH=os.pathsep.join(
                   [root] + [p for p in [os.environ.get("PYTHONPATH")] if p]))
    t0 = time.perf_counter()
    out = subprocess.run(
        [sys.executable, "-m", "runbooks_tpu_torch.train.dataset_loader"],
        cwd=root, env=env, capture_output=True, text=True, timeout=300)
    load_s = time.perf_counter() - t0
    art = f"{content}/artifacts"
    if out.returncode != 0:
        raise SystemExit(f"dataset loader exited {out.returncode}: "
                         f"{out.stderr[-2000:]}")
    with open(f"{art}/dataset.json") as f:
        manifest = json.load(f)
    last = json.loads(out.stdout.strip().splitlines()[-1])
    files = {e["file"]: e for e in manifest["files"]}
    ok = (last == {"done": True, **manifest}
          and sorted(files) == sorted(rows)
          and all(files[n]["rows"] == rows[n]
                  and files[n]["bytes"] == os.path.getsize(f"{art}/{n}")
                  == os.path.getsize(f"{src}/{n}") for n in rows)
          and manifest["total_bytes"] == sum(
              os.path.getsize(f"{art}/{n}") for n in rows)
          and manifest["total_rows"] == len(docs))
    rec = {"seconds": load_s, "files": len(files),
           "total_rows": manifest["total_rows"],
           "total_bytes": manifest["total_bytes"], "manifest_ok": ok}
    print("dataset loader: " + json.dumps(rec), flush=True)
    if not ok:
        raise SystemExit(f"dataset manifest {manifest} does not match "
                         f"the files {rows}")
    return art, rec


def text_train(torch, seed, data_dir, tok_dir, workdir):
    """Phase 15 (d): the LoRA fine-tune of llama3-8b cut to TEXT_LAYERS
    layers over the loader's directory through the llama3-style
    tokenizer, TRAIN_STEPS steps at prefetch depth 0 and 2. Returns
    ({depth: record}, launches {kernel: n} over both runs)."""
    from runbooks_tpu_torch.models.config import get_config
    from runbooks_tpu_torch.ops.flash_attention import (
        flash_attention,
        flash_attention_bwd,
    )
    from runbooks_tpu_torch.train import data, trainer
    from runbooks_tpu_torch.train.lora import LoraConfig
    from runbooks_tpu_torch.train.optimizer import OptimizerConfig

    overrides = {"num_layers": TEXT_LAYERS}
    base = trainer.TrainJobConfig(
        model="llama3-8b", model_overrides=overrides,
        lora=LoraConfig(rank=16, alpha=32.0),
        optimizer=OptimizerConfig(learning_rate=2e-5), batch_size=8,
        seq_len=TRAIN_SEQ, accumulate_steps=4, steps=TRAIN_STEPS,
        data_path=data_dir, tokenizer=tok_dir, log_every=1, seed=seed)
    # The first batch the job consumes is the documents' encodings,
    # packed and batched as pack_documents and batch_rows do.
    cfg = get_config("llama3-8b", **overrides)
    first = next(trainer._batches(base, cfg))
    tok = data.load_tokenizer(tok_dir)
    rows = data.pack_documents(
        (tok.encode(t) for t in data.read_documents(data_dir)), TRAIN_SEQ)
    want = next(data.batch_rows(rows, 8))
    if not all((first[k] == want[k]).all() for k in want):
        raise SystemExit("the job's first batch is not the documents' "
                         "encodings as pack_documents packs them")
    bos_rows = int((first["tokens"][:, 0] == tok.bos_token_id).sum())
    out = {}
    flash_attention.launches = 0
    flash_attention_bwd.dq_launches = 0
    flash_attention_bwd.dkv_launches = 0
    for depth in (0, 2):
        gc.collect()
        torch.cuda.empty_cache()
        job = dataclasses.replace(base, prefetch_depth=depth,
                                  artifacts_dir=f"{workdir}/text_train_"
                                                f"{depth}")
        t0 = time.perf_counter()
        summary = trainer.run_training(job)
        wall = time.perf_counter() - t0
        hist = summary["history"]
        losses = [e["loss"] for e in hist]
        out[depth] = {"wall_s": wall, "losses": losses,
                      "data_wait_s_per_step": [e["data_wait_s"]
                                               for e in hist],
                      "step_s": [e["step_s"] for e in hist],
                      "first_step_s": summary["first_step_s"],
                      "tokens_per_sec": summary["tokens_per_sec"]}
        if len(losses) != TRAIN_STEPS or not all(math.isfinite(x)
                                                 for x in losses):
            raise SystemExit(f"text fine-tune at prefetch depth {depth}: "
                             f"losses {losses}")
    launches = {"flash_fwd": flash_attention.launches,
                "flash_bwd_dq": flash_attention_bwd.dq_launches,
                "flash_bwd_dkv": flash_attention_bwd.dkv_launches}
    per_step = {"flash_fwd": 8 * TEXT_LAYERS, "flash_bwd_dq": 4 * TEXT_LAYERS,
                "flash_bwd_dkv": 4 * TEXT_LAYERS}
    for name, n in per_step.items():
        if launches[name] != 2 * TRAIN_STEPS * n:
            raise SystemExit(f"text fine-tune: {name} launched "
                             f"{launches[name]} times; expected "
                             f"{2 * TRAIN_STEPS * n}")
    print("text fine-tune: " + json.dumps({
        "layers": TEXT_LAYERS, "rows_starting_with_bos": bos_rows,
        "by_prefetch_depth": out, "launches": launches}), flush=True)
    return out, launches


def stream_check(base, body, want_text, name, chat=True):
    """The body streamed to /v1/chat/completions (``chat``) or
    /v1/completions: its deltas concatenated must equal want_text.
    Returns (seconds to the first data chunk, chunks)."""
    status, _, text, t_first = http_call(
        base, "/v1/chat/completions" if chat else "/v1/completions",
        {**body, "stream": True})
    if status != 200:
        raise SystemExit(f"{name} stream: {status} {text[:500]}")
    events = [ln[len("data: "):] for ln in text.split("\n")
              if ln.startswith("data: ")]
    if events[-1] != "[DONE]":
        raise SystemExit(f"{name} stream did not end with [DONE]")
    chunks = [json.loads(e) for e in events[:-1]]
    got = "".join(c["choices"][0]["delta"].get("content", "") if chat
                  else c["choices"][0]["text"] for c in chunks)
    print(f"{name}: streamed {len(chunks)} chunks, "
          f"{'equal to' if got == want_text else 'DIFFERENT FROM'} the "
          f"unstreamed text ({len(want_text)} characters)", flush=True)
    if got != want_text:
        raise SystemExit(f"{name}: streamed {got[:200]!r} != unstreamed "
                         f"{want_text[:200]!r}")
    return t_first, len(chunks)


def chat_messages(tok, text, budget):
    """A system message of ``text`` cut so that the templated prompt is at
    most ``budget`` tokens, and one user turn."""
    content = text
    while True:
        msgs = [{"role": "system", "content": content},
                {"role": "user", "content": "Summarize the above in one "
                                            "line. It's 2024."}]
        ids = tok.encode(tok.apply_chat_template(
            msgs, tokenize=False, add_generation_prompt=True))
        if len(ids) <= budget:
            return msgs, ids
        content = content[:int(len(content) * budget / len(ids) * 0.98)]


def chat_expected(torch, cfg, params, tok, msgs, response_format=None,
                  max_tokens=MAX_TOKENS):
    """(prompt ids, output ids without a final EOS, text) of one greedy
    request through InferenceEngine.generate, as the server would run
    it."""
    from runbooks_tpu_torch.serve.engine import InferenceEngine, Request

    ids = tok.encode(tok.apply_chat_template(msgs, tokenize=False,
                                             add_generation_prompt=True))
    req = Request(prompt_tokens=ids, max_tokens=max_tokens,
                  eos_id=tok.eos_token_id, response_format=response_format)
    with torch.no_grad():
        InferenceEngine(cfg, params, max_slots=8, max_seq_len=2048,
                        grammar="on", tokenizer=tok).generate([req])
    out = list(req.output_tokens)
    if out and out[-1] == tok.eos_token_id:
        out = out[:-1]
    return ids, out, tok.decode(out), req


def chat_model(workdir):
    """Phase 15 (e)'s model: phase 9's import (llama3-8b at full width,
    IMPORT_LAYERS layers)."""
    return {"model": "llama3-8b",
            "model_overrides": {"num_layers": IMPORT_LAYERS},
            "checkpoint": f"{workdir}/import_content/artifacts"}


def chat_server_start(seed, workdir, l3_dir):
    """Phase 15 (e): ``python -m runbooks_tpu_torch.serve.api`` with
    ``tokenizer:`` the llama3-style directory over ``chat_model``, started
    in the background (it warms up while the host-side steps run): a
    Background of start_entry_point, and the server's log path."""
    content = f"{workdir}/chat_content"
    os.makedirs(content)
    port = free_port()
    with open(f"{content}/params.json", "w") as f:
        json.dump({**chat_model(workdir), "tokenizer": l3_dir, "port": port,
                   "max_slots": 8, "max_seq_len": 2048, "grammar": "on",
                   "drain_timeout_s": ENTRY_DRAIN_S, "seed": seed}, f)
    log_path = f"{workdir}/chat_server.log"
    return Background(start_entry_point, content, port, log_path,
                      180), log_path


def chat_server_check(torch, workdir, l3_tok, docs, server):
    """Phase 15 (e): the server of ``chat_server_start`` (``server``)
    against this process's decode of the same model. Returns the
    record."""
    from runbooks_tpu_torch.serve.api import load_model
    from runbooks_tpu_torch.serve.grammar import GrammarCache, TokenVocab

    cfg, params = load_model(chat_model(workdir))
    msgs, prompt_ids = chat_messages(l3_tok, "\n".join(docs[:40]),
                                     CHAT_PROMPT_TOKENS)
    prompt = l3_tok.apply_chat_template(msgs, tokenize=False,
                                        add_generation_prompt=True)
    t0 = time.perf_counter()
    l3_tok.encode(prompt)
    encode_ms = (time.perf_counter() - t0) * 1e3
    ids, out_ids, want_text, _ = chat_expected(torch, cfg, params, l3_tok,
                                               msgs)
    rf = GRAMMAR_FORMATS[0][0]
    short = [{"role": "user", "content": "Is the kernel fast? Answer in "
                                         "JSON."}]
    _, g_ids, g_text, g_req = chat_expected(
        torch, cfg, params, l3_tok, short, response_format=rf,
        max_tokens=GRAMMAR_MAX)
    vocab = TokenVocab.from_tokenizer(l3_tok)
    cursor = GrammarCache(vocab, cfg.vocab_size).cursor(rf)
    legal = all(cursor.advance(t) for t in g_ids) and cursor.accepting
    parsed_ok = False
    try:
        parsed_ok = GRAMMAR_FORMATS[0][2](json.loads(g_text))
    except ValueError:
        pass
    del params
    gc.collect()
    torch.cuda.empty_cache()

    started, log_path = server
    proc, base, ready_s = started.result()
    try:
        body = {"messages": msgs, "max_tokens": MAX_TOKENS,
                "temperature": 0}
        status, _, text, plain_s = http_call(base, "/v1/chat/completions",
                                             body)
        if status != 200:
            raise SystemExit(f"chat completion: {status} {text[:500]}")
        answer = json.loads(text)
        got_text = answer["choices"][0]["message"]["content"]
        usage = answer["usage"]
        ttft_s, n_chunks = stream_check(base, body, got_text,
                                        "llama3 chat")
        status, _, text, _ = http_call(base, "/v1/chat/completions", {
            "messages": short, "max_tokens": GRAMMAR_MAX, "temperature": 0,
            "response_format": rf})
        if status != 200:
            raise SystemExit(f"constrained chat: {status} {text[:500]}")
        g_answer = json.loads(text)["choices"][0]
        proc.send_signal(signal.SIGTERM)
        rc = proc.wait(timeout=ENTRY_DRAIN_S + 30)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()
        with open(log_path) as f:
            log_text = f.read()
    launches = stopped_launches(log_text)
    rec = {"ready_s": ready_s, "prompt_tokens": len(ids),
           "template_encode_ms": encode_ms, "ttft_s_streamed": ttft_s,
           "unstreamed_s": plain_s, "stream_chunks": n_chunks,
           "prompt_ids_equal": ids == prompt_ids
           and usage["prompt_tokens"] == len(ids),
           "text_equals_generate": got_text == want_text,
           "constrained": {"tokens": len(g_ids), "legal": legal,
                           "schema_ok": bool(parsed_ok),
                           "finish_reason": g_answer["finish_reason"],
                           "http_equals_generate":
                               g_answer["message"]["content"] == g_text,
                           "vocab_ids": vocab.vocab_size,
                           "mask_width": cfg.vocab_size},
           "flash_fwd_launches": launches, "exit_code": rc}
    print("chat server llama3: " + json.dumps(rec), flush=True)
    if not (rec["prompt_ids_equal"] and rec["text_equals_generate"]
            and legal and parsed_ok and rec["constrained"][
                "http_equals_generate"] and launches >= 3 and rc == 0
            and g_req.finish_reason == "grammar_complete"):
        print(log_text[-3000:], flush=True)
        raise SystemExit("the llama3 chat server check failed")
    return rec


def llama2_stream_check(torch, seed, l2_tok, docs):
    """Phase 15 (e), llama2: llama2-7b at full width cut to TEXT_LLAMA2_
    LAYERS layers with seeded bf16 weights behind create_server with the
    llama2-style tokenizer: the streamed chat answer equals the
    unstreamed one. Returns (record, K1 launches)."""
    from runbooks_tpu_torch.ops.flash_attention import flash_attention
    from runbooks_tpu_torch.serve.api import create_server, load_model

    cfg, params = load_model({"model": "llama2-7b", "model_overrides": {
        "num_layers": TEXT_LLAMA2_LAYERS, "param_dtype": "bfloat16"},
        "seed": seed + 15})
    msgs, ids = chat_messages(l2_tok, "\n".join(docs[:40]), 600)
    srv = create_server(cfg, params, l2_tok, host="127.0.0.1", port=0,
                        max_slots=8, max_seq_len=2048)
    thread = threading.Thread(target=srv.serve_forever, daemon=True)
    thread.start()
    base = f"http://127.0.0.1:{srv.port}"
    flash_attention.launches = 0
    try:
        body = {"messages": msgs, "max_tokens": 64, "temperature": 0}
        status, _, text, _ = http_call(base, "/v1/chat/completions", body)
        if status != 200:
            raise SystemExit(f"llama2 chat: {status} {text[:500]}")
        answer = json.loads(text)
        got = answer["choices"][0]["message"]["content"]
        ttft_s, n_chunks = stream_check(base, body, got, "llama2 chat")
    finally:
        launches = flash_attention.launches
        srv.shutdown()
        thread.join(timeout=60)
    rec = {"layers": TEXT_LLAMA2_LAYERS, "prompt_tokens": len(ids),
           "usage": answer["usage"], "stream_chunks": n_chunks,
           "ttft_s_streamed": ttft_s,
           "text_words": len(got.split()), "flash_fwd_launches": launches}
    print("chat server llama2: " + json.dumps(rec), flush=True)
    if launches < 2 or answer["usage"]["prompt_tokens"] != len(ids):
        raise SystemExit("the llama2 chat check failed")
    del params
    return rec, launches


def text_phase(torch, dev, seed, workdir):
    """Phase 15: the text path. Returns K1/K2/K3 launches by path."""
    from runbooks_tpu_torch.serve.grammar import GrammarCache, TokenVocab

    t_phase = time.perf_counter()
    t0 = time.perf_counter()
    docs = text_corpus(seed)
    corpus_s = time.perf_counter() - t0
    l3_dir, l2_dir = f"{workdir}/tok_llama3", f"{workdir}/tok_llama2"
    t0 = time.perf_counter()
    write_llama3_tokenizer(l3_dir, docs, seed)
    l3_write_s = time.perf_counter() - t0
    chat_server = chat_server_start(seed, workdir, l3_dir)
    t0 = time.perf_counter()
    write_llama2_tokenizer(l2_dir, docs, seed)
    l2_write_s = time.perf_counter() - t0
    print(f"tokenizer directories: corpus {len(docs)} documents in "
          f"{corpus_s:.2f} s; llama3-style written in {l3_write_s:.2f} s, "
          f"llama2-style in {l2_write_s:.2f} s", flush=True)
    if l3_write_s > 60:
        raise SystemExit("writing the llama3-style directory took over 60 s")
    l3_tok, l3_rec = tokenizer_host_numbers(
        "llama3", l3_dir, docs, (L3_REGULAR, L3_REGULAR + L3_SPECIALS))
    l2_tok, l2_rec = tokenizer_host_numbers("llama2", l2_dir, docs,
                                            (L2_VOCAB, L2_VOCAB))
    t0 = time.perf_counter()
    vocab = TokenVocab.from_tokenizer(l3_tok)
    vocab_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    dfa = GrammarCache(vocab, L3_REGULAR + L3_SPECIALS).get(
        GRAMMAR_FORMATS[0][0])
    compile_s = time.perf_counter() - t0
    print(f"token vocab at {L3_REGULAR + L3_SPECIALS}: from_tokenizer "
          f"{vocab_s:.3f} s ({sum(b is not None for b in vocab.token_bytes)} "
          f"ids with bytes); JSON-schema DFA compile {compile_s:.3f} s, "
          f"{dfa.num_states} states", flush=True)

    data_dir, loader_rec = dataset_load(workdir, docs)
    gc.collect()
    torch.cuda.empty_cache()
    train, train_launches = text_train(torch, seed, data_dir, l3_dir,
                                       workdir)
    gc.collect()
    torch.cuda.empty_cache()
    chat = chat_server_check(torch, workdir, l3_tok, docs, chat_server)
    gc.collect()
    torch.cuda.empty_cache()
    llama2, llama2_launches = llama2_stream_check(torch, seed, l2_tok, docs)
    gc.collect()
    torch.cuda.empty_cache()
    print("phase 15 " + json.dumps({
        "card": card_line(), "corpus_s": corpus_s,
        "llama3_write_s": l3_write_s, "llama2_write_s": l2_write_s,
        "llama3": l3_rec, "llama2": l2_rec,
        "token_vocab_s": vocab_s, "grammar_compile_s": compile_s,
        "dataset_loader": loader_rec, "fine_tune": train,
        "chat_llama3": chat, "chat_llama2": llama2,
        "seconds": time.perf_counter() - t_phase}), flush=True)
    return {"flash_fwd": {"text_train": train_launches["flash_fwd"],
                          "text_chat_llama3": chat["flash_fwd_launches"],
                          "text_chat_llama2": llama2_launches},
            "flash_bwd_dq": train_launches["flash_bwd_dq"],
            "flash_bwd_dkv": train_launches["flash_bwd_dkv"]}


# ---------------------------------------------------------------------------
# Phase 16: the non-Llama dense families (Falcon, OPT, GPT-2)
# ---------------------------------------------------------------------------

# (c) examples/falcon-7b-instruct/finetuned-model.yaml on the f32 base at
# full width cut to FALCON_TRAIN_LAYERS (phase 22 (c): gemma-2b at full
# depth): 2 steps and a resume to a third.
FAMILY_TRAIN_STEPS = 2
# Phase 16 (c) fine-tunes falcon-7b at full width cut to
# FALCON_TRAIN_LAYERS, so that the whole script stays inside its limit on
# a slow host (phases 7 and 22 (c) fine-tune llama3-8b and gemma-2b at
# full depth). K1-K3's launches are counted per layer, so the check does
# not depend on the depth.
FALCON_TRAIN_LAYERS = 4
# (d) the HF directories are cut to this depth (full width), and the two
# widest (one falcon-40b layer is 0.68 B parameters, one mixtral layer
# 1.45 B) to IMPORT_ONE_LAYER's: the card's machine stops a run that has
# written 45 GiB to its disk, deleted files included, and each import
# writes its source and its checkpoint.
FAMILY_IMPORT_LAYERS = 2
IMPORT_ONE_LAYER = ("falcon-40b", "mixtral-8x7b")


def family_import_overrides(name):
    """The model_overrides of ``name``'s import: bf16, cut in depth."""
    return {"num_layers": 1 if name in IMPORT_ONE_LAYER
            else FAMILY_IMPORT_LAYERS, "param_dtype": "bfloat16"}
# (e) gpt2's long request: a prompt of GPT2_LONG_PROMPT tokens and
# GPT2_LONG_NEW new ones end 5 positions short of its 1024-row position
# table (its prefill bucket of 1024 parks 24 padding rows past it).
GPT2_LONG_PROMPT = 1000
GPT2_LONG_NEW = 20
FAMILY_HTTP_NEW = 32


def family_fwd_layouts(torch, dev, batch):
    """K1's phase-16 cases (fwd_case_layouts' tuple): falcon-7b's serving
    burst (71 query heads on 1 kv head, d 64: an 8-row 128 bucket, rows
    0-1 real, padding at position 2048 over a 2049-slot cache), its
    training microbatch (a: 2 packed rows of the job's data; b: causal
    without segments), falcon-40b's grouping (128 on 8) and OPT's MHA
    (12 on 12), both 2 x 2048 causal."""

    def ar(n, rows):
        return torch.arange(n, device=dev, dtype=torch.int32)[None].expand(
            rows, n).contiguous()

    sk = 2049
    pos = torch.full((8, 128), 2048, device=dev, dtype=torch.int32)
    pos[0, :90] = ar(90, 1)[0]
    pos[1, :120] = ar(120, 1)[0]
    s = TRAIN_SEQ
    tpos = torch.from_numpy(batch["positions"][:2]).to(dev)
    tseg = torch.from_numpy(batch["segment_ids"][:2]).to(dev)
    return [
        ("falcon7b_rows8_sq128", (8, 128, sk, 71, 1, 64), pos, ar(sk, 8),
         None, None, False, pos < 2048),
        ("a_falcon7b_packed_2x2048", (2, s, s, 71, 1, 64), tpos, tpos, tseg,
         tseg, True, None),
        ("b_falcon7b_causal_2x2048", (2, s, s, 71, 1, 64), ar(s, 2),
         ar(s, 2), None, None, True, None),
        ("falcon40b_causal_2x2048", (2, s, s, 128, 8, 64), ar(s, 2),
         ar(s, 2), None, None, True, None),
        ("opt_causal_2x2048", (2, s, s, 12, 12, 64), ar(s, 2), ar(s, 2),
         None, None, True, None),
    ]


def family_bwd_layouts(torch, dev, batch):
    """K2/K3's phase-16 cases (bwd_case_layouts' tuple): falcon-7b's
    training microbatch, packed (a) and causal (b), 71 on 1 at d 64: K3's
    grid is (kv heads, rows, kv tiles) = (1, 2, 32) and each block walks
    71 query heads."""
    s = TRAIN_SEQ
    pos = torch.from_numpy(batch["positions"][:2]).to(dev)
    seg = torch.from_numpy(batch["segment_ids"][:2]).to(dev)
    ar = torch.arange(s, device=dev, dtype=torch.int32)[None].expand(
        2, s).contiguous()
    return [
        ("a_falcon7b_packed_2x2048", (2, s, s, 71, 1, 64), pos, pos, seg,
         True, None),
        ("b_falcon7b_causal_2x2048", (2, s, s, 71, 1, 64), ar, ar, None,
         True, None),
    ]


# Phase 16 (b) serves falcon-7b at full width cut to FALCON_SERVE_LAYERS
# (full depth until phase 21 came in; phase 4 serves llama3-8b at full
# depth), so that the whole script stays inside its limit.
FALCON_SERVE_LAYERS = 8


def family_serve(torch, seed, model, layers=None, after=None):
    """One family's serving check (phase 16 (b): falcon-7b cut to
    FALCON_SERVE_LAYERS; phase 22 (b): gemma-7b cut to
    GEMMA7B_SERVE_LAYERS; phase 23
    (b): mixtral-8x7b cut to MIXTRAL_SERVE_LAYERS): ``model`` bf16 at full
    width (``layers``: cut to that depth), the prefill logits through K1
    against the plain attention, then phase 4's mix through the dense and
    the paged engine, each warmed up: every request its MAX_TOKENS, K1's
    launches equal, the greedy ids equal up to near-ties (for an MoE
    model, of both engines run again at a capacity that drops nothing).
    ``after(cfg, params)``, when given, runs on the served weights at the
    end. Returns (record, K1 launches by engine)."""
    from runbooks_tpu_torch.serve.api import load_model
    from runbooks_tpu_torch.serve.engine import InferenceEngine
    from runbooks_tpu_torch.serve.paging import PagedInferenceEngine
    from runbooks_tpu_torch.utils.tree import tree_leaves

    label = model.split("-")[0]
    overrides = {"param_dtype": "bfloat16"}
    if layers is not None:
        overrides["num_layers"] = layers
    t0 = time.perf_counter()
    cfg, params = load_model({"model": model, "model_overrides": overrides,
                              "seed": seed})
    torch.cuda.synchronize()
    n_params = sum(t.numel() for t in tree_leaves(params))
    weight_gb = sum(t.numel() * t.element_size()
                    for t in tree_leaves(params)) / 1e9
    print(f"load_model {model} bf16: {n_params / 1e9:.3f} B params "
          f"({weight_gb:.2f} GB), layers {cfg.num_layers}, hidden "
          f"{cfg.hidden_size}, heads {cfg.num_heads}/{cfg.num_kv_heads} of "
          f"{cfg.head_dim}, in {time.perf_counter() - t0:.2f} s",
          flush=True)
    prompts = smoke_prompts(seed)
    plain_cfg = dataclasses.replace(cfg, attention_impl="xla")
    with torch.no_grad():
        flash = prefill_logits(torch, cfg, params, prompts[3], 512, 2048)
        plain = prefill_logits(torch, plain_cfg, params, prompts[3], 512,
                               2048)
    gap_check(f"{model} prefill logits, 300-token prompt, flash vs plain",
              flash, plain)
    record, ids, launches = {"weight_gb": weight_gb,
                             "layers": cfg.num_layers}, {}, {}
    for name, cls in (("dense", None), ("paged", PagedInferenceEngine)):
        engine, samples, warm_s = warm_engine(torch, cfg, params, seed,
                                              cls=cls)
        engine.ttft_seconds.clear()
        reqs = smoke_requests(prompts, {})
        torch.cuda.reset_peak_memory_stats()
        st, run_ids = timed_generate(torch, engine, samples, reqs)
        prompt_tokens = sum(len(p) for p in prompts)
        st.update(warmup_s=warm_s,
                  ttft_s_median=median(list(engine.ttft_seconds)),
                  ttft_s_max=max(engine.ttft_seconds),
                  prefill_tokens_per_s=prompt_tokens / st["prefill_s"],
                  max_memory_allocated_gb=(
                      torch.cuda.max_memory_allocated() / 1e9),
                  cache_bytes=engine.cache.nbytes)
        if not all(len(x) == MAX_TOKENS for x in run_ids):
            raise SystemExit(f"{model} {name}: not every request got "
                             f"{MAX_TOKENS} tokens: {st}")
        record[name] = st
        ids[name] = run_ids
        launches[f"{label}_serve_{name}"] = st["flash_fwd_launches"]
        free_engine(torch, engine)
        del engine
    dense, paged = (launches[f"{label}_serve_{k}"] for k in ("dense",
                                                              "paged"))
    if dense != paged or dense < cfg.num_layers:
        raise SystemExit(f"{model}: K1 launches dense vs paged {launches}")
    gate_cfg = cfg
    if cfg.moe_num_experts:
        # Capacity ties a token's experts to every row of its dispatch,
        # and the two engines dispatch other rows (as the reference's
        # do), so their ids may part away from a near-tie. The ids gate
        # runs both engines again at a capacity that drops nothing,
        # where a token's output is its own.
        record["identical_requests_served"] = sum(
            a == b for a, b in zip(ids["dense"], ids["paged"]))
        gate_cfg = dataclasses.replace(cfg, moe_capacity_factor=(
            cfg.moe_num_experts / cfg.moe_top_k))
        for name, cls in (("dense", None), ("paged", PagedInferenceEngine)):
            engine = (cls or InferenceEngine)(gate_cfg, params, max_slots=8,
                                              max_seq_len=2048, seed=seed)
            reqs = smoke_requests(prompts, {})
            with torch.no_grad():
                engine.generate(reqs)
            ids[name] = [r.output_tokens for r in reqs]
            free_engine(torch, engine)
            del engine
        record["dropless_capacity_factor"] = gate_cfg.moe_capacity_factor
    print(f"{model} serve " + json.dumps(record), flush=True)
    for i in range(0, len(prompts), 2):      # the greedy requests
        near_tie_check(torch, gate_cfg, params, f"{model} request r{i}: "
                       "greedy ids dense vs paged", prompts[i],
                       ids["dense"][i], ids["paged"][i])
    if after is not None:
        after(cfg, params)
    del params, flash, plain
    gc.collect()
    torch.cuda.empty_cache()
    return record, launches


def traced_family_step(torch, dev, seed, data_path, model, layers, lora_cfg,
                       opt_cfg):
    """One optimizer step of the fine-tune's step function (after a warm
    one) under torch.profiler, on a seeded ``model`` base (``layers``: cut
    to that depth): its wall time, the device's busy and idle share of it,
    and the device time of K1, K2, K3 and the rest."""
    from runbooks_tpu_torch.models.config import get_config
    from runbooks_tpu_torch.models.transformer import init_params

    cfg = get_config(model, **({} if layers is None
                               else {"num_layers": layers}))
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)
    base = init_params(cfg, gen, dev)
    traced = traced_lora_step(torch, dev, cfg, base, gen, data_path,
                              lora_cfg, opt_cfg)
    del base
    gc.collect()
    torch.cuda.empty_cache()
    return traced


def traced_lora_step(torch, dev, cfg, base, gen, data_path, lora_cfg,
                     opt_cfg):
    """traced_family_step's measurement over a given base and config."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from runbooks_tpu_torch.train import data
    from runbooks_tpu_torch.train.lora import (
        create_lora_train_state,
        make_lora_train_step,
    )
    from runbooks_tpu_torch.train.optimizer import make_optimizer

    optimizer = make_optimizer(opt_cfg)
    state = create_lora_train_state(lora_cfg, base, optimizer, gen)
    step_fn = make_lora_train_step(cfg, lora_cfg, optimizer,
                                   accumulate_steps=4)
    batches = data.dataset(data_path, TRAIN_SEQ, 8, epochs=None)

    def step(state):
        b = {k: torch.from_numpy(v).to(dev) for k, v in next(
            batches).items()}
        state, _ = step_fn(state, base, b)
        torch.cuda.synchronize()
        return state

    state = step(state)
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        state = step(state)
        traced_s = time.perf_counter() - t0
    groups = {"flash_fwd_kernel": 0.0, "flash_bwd_dq_kernel": 0.0,
              "flash_bwd_dkv_kernel": 0.0}
    busy = 0.0
    for e in prof.key_averages():
        if e.device_type != DeviceType.CUDA:
            continue
        busy += e.self_device_time_total
        for g in groups:
            if g in e.key:
                groups[g] += e.self_device_time_total
    del state
    gc.collect()
    torch.cuda.empty_cache()
    return {"traced_step_s": traced_s, "device_busy_ms": busy / 1e3,
            "idle_share": 1 - busy / 1e6 / traced_s,
            "k1_ms": groups["flash_fwd_kernel"] / 1e3,
            "k2_ms": groups["flash_bwd_dq_kernel"] / 1e3,
            "k3_ms": groups["flash_bwd_dkv_kernel"] / 1e3,
            "k2_share": groups["flash_bwd_dq_kernel"] / busy if busy else None,
            "k3_share": (groups["flash_bwd_dkv_kernel"] / busy if busy
                         else None)}


def family_train(torch, dev, seed, data_path, workdir, model, layers=None):
    """A family's LoRA fine-tune through run_training (phase 16 (c):
    falcon-7b cut to FALCON_TRAIN_LAYERS; phase 22 (c): gemma-2b at full
    depth): examples/falcon-7b-instruct/finetuned-model.yaml's job (LoRA
    rank 16, alpha 32, batch 8 in 4 microbatches, seq 2048, lr 2e-5) on
    an f32 ``model`` base at full width (``layers``: cut to that depth),
    FAMILY_TRAIN_STEPS steps, a resume to one more, then one traced step.
    Returns (record, launches of the first run)."""
    from runbooks_tpu_torch.models.config import get_config
    from runbooks_tpu_torch.ops.flash_attention import (
        flash_attention,
        flash_attention_bwd,
    )
    from runbooks_tpu_torch.train.checkpoint import CheckpointManager
    from runbooks_tpu_torch.train.lora import LoraConfig
    from runbooks_tpu_torch.train.optimizer import OptimizerConfig
    from runbooks_tpu_torch.train.trainer import TrainJobConfig, run_training

    steps = FAMILY_TRAIN_STEPS
    overrides = {} if layers is None else {"num_layers": layers}
    cfg = get_config(model, **overrides)
    art = f"{workdir}/{model}_artifacts"
    lora_cfg = LoraConfig(rank=16, alpha=32.0)
    opt_cfg = OptimizerConfig(learning_rate=2e-5)
    job = TrainJobConfig(
        model=model, model_overrides=overrides, lora=lora_cfg,
        optimizer=opt_cfg, batch_size=8,
        seq_len=TRAIN_SEQ, accumulate_steps=4, steps=steps,
        data_path=data_path, artifacts_dir=art, log_every=1, seed=seed)
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
    hist = summary["history"]
    losses = [e["loss"] for e in hist]
    # Each layer of each of the 4 microbatches: K1 twice (the forward
    # and the remat's recompute), K2 and K3 once.
    n = cfg.num_layers * 4
    per_step = {"flash_fwd": 2 * n, "flash_bwd_dq": n, "flash_bwd_dkv": n}
    for name, n in per_step.items():
        if launches[name] != n * steps:
            raise SystemExit(f"{model} fine-tune: {name} launched "
                             f"{launches[name]} times in {steps} steps, "
                             f"not {n * steps}")
    if len(losses) != steps or not all(math.isfinite(x) for x in losses):
        raise SystemExit(f"{model} fine-tune losses: {losses}")
    gc.collect()
    torch.cuda.empty_cache()
    resumed = run_training(dataclasses.replace(job, steps=steps + 1))
    cursor = CheckpointManager(art).read_cursor(steps)
    r_losses = [e["loss"] for e in resumed["history"]]
    if (resumed["restored_step"] != steps
            or cursor.get("batches_consumed") != steps
            or resumed["batches_consumed"] != steps + 1
            or [e["step"] for e in resumed["history"]] != [steps + 1]
            or not all(math.isfinite(x) for x in r_losses)):
        raise SystemExit(f"{model} fine-tune: the resume did not continue "
                         "at the saved step and cursor")
    gc.collect()
    torch.cuda.empty_cache()
    traced = traced_family_step(torch, dev, seed, data_path, model, layers,
                                lora_cfg, opt_cfg)
    last = hist[-1]
    record = {"layers": cfg.num_layers, "steps": steps,
              "wall_s_with_init": wall, "losses": losses,
              "resumed_losses": r_losses,
              "restored_step": resumed["restored_step"],
              "cursor": cursor.get("batches_consumed"),
              "first_step_s": summary["first_step_s"],
              "step_s": last.get("step_s"),
              "tokens_per_s": last["tokens_per_sec"],
              "mfu": last.get("mfu"),
              "flops_per_token_x3": 3.0 * cfg.flops_per_token(TRAIN_SEQ),
              "peak_memory_gb": peak / 1e9, "launches": launches,
              "launches_per_step_expected": per_step, "traced": traced}
    print(f"{model} fine-tune " + json.dumps(record), flush=True)
    return record, launches


def family_import_start(torch, dev, seed, workdir, names):
    """The first half of family_import: each model's HF directory (BF16,
    two shards, full width, cut to family_import_overrides' depth) written
    from the seed, then one Background that imports them in turn through ``python
    -m runbooks_tpu_torch.models.loader``. Returns ({name: the HF
    tensors}, {name: its record so far}, the Background)."""
    from runbooks_tpu_torch.models.config import get_config

    tensors, record = {}, {}
    for name in names:
        cfg = get_config(name, **family_import_overrides(name))
        t0 = time.perf_counter()
        tensors[name], src_bytes = write_hf_checkpoint(
            torch, dev, hf_names(cfg), f"{workdir}/hf_{name}", seed,
            IMPORT_SHARDS)
        record[name] = {"source_bytes": src_bytes,
                        "write_s": time.perf_counter() - t0}

    def load_all():
        return {name: run_loader(f"{workdir}/import_{name}", {
            "model": name, "model_overrides": family_import_overrides(name),
            "source": "dir", "dir": f"{workdir}/hf_{name}"})
            for name in names}

    return tensors, record, Background(load_all)


def family_import(torch, dev, seed, workdir, names, served, started=None):
    """HF directories of the models ``names`` through ``python -m
    runbooks_tpu_torch.models.loader`` (family_import_start, unless
    ``started`` holds what it returned); every leaf against the HF
    tensors taken apart here by hand (family_expected); then load_model
    restores the import of ``served`` and its greedy ids equal those of
    the tree converted in memory. Phase 16 (d): falcon-7b style (fused
    MQA query_key_value, one input_layernorm) and falcon-40b style (8 kv
    heads, ln_attn / ln_mlp); phase 22 (d): gemma-7b (llama's names, no
    lm_head, the norms' +1); phase 23 (c): mixtral-8x7b (the router and
    each expert's w1 / w3 / w2). Returns (record, K1 launches)."""
    from runbooks_tpu_torch.models.config import get_config
    from runbooks_tpu_torch.models.convert import convert
    from runbooks_tpu_torch.models.safetensors_io import load_state_dict
    from runbooks_tpu_torch.ops.flash_attention import flash_attention
    from runbooks_tpu_torch.serve.api import load_model
    from runbooks_tpu_torch.serve.engine import InferenceEngine, Request
    from runbooks_tpu_torch.train.checkpoint import restore_params
    from runbooks_tpu_torch.utils.tree import tree_map

    if started is None:
        started = family_import_start(torch, dev, seed, workdir, names)
    all_tensors, record, loads = started
    loaded = loads.result()
    for name in names:
        cfg = get_config(name, **family_import_overrides(name))
        tensors = all_tensors.pop(name)
        content = f"{workdir}/import_{name}"
        rc, import_s, peak_rss_gb, log_text = loaded[name]
        if rc != 0:
            print(log_text[-3000:], flush=True)
            raise SystemExit(f"the {name} import exited {rc}")
        restored, _ = restore_params(f"{content}/artifacts",
                                     torch.device("cpu"))
        n_leaves = n_equal = 0
        for leaf, layer, want in family_expected(torch, tensors, cfg):
            got = restored
            for k in leaf.split("."):
                got = got[k]
            if layer is not None:
                got = got[layer]
            n_leaves += 1
            n_equal += int(got.dtype == torch.bfloat16
                           and torch.equal(got, want.to(torch.bfloat16)))
        record[name].update(
            import_s=import_s,
            import_gb_per_s=record[name]["source_bytes"] / import_s / 1e9,
            loader_peak_rss_gb=peak_rss_gb, leaves=n_leaves,
            leaves_equal=n_equal)
        print(f"import {name} x{cfg.num_layers} layers: "
              f"{json.dumps(record[name])}", flush=True)
        if n_equal != n_leaves:
            raise SystemExit(f"the {name} import differs from its source "
                             f"({n_equal} of {n_leaves} leaves equal)")
        del restored, tensors
        gc.collect()

    cfg, restored = load_model({
        "model": served, "model_overrides": family_import_overrides(served),
        "checkpoint": f"{workdir}/import_{served}/artifacts"})
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
        cfg, load_state_dict(f"{workdir}/hf_{served}"), cfg.param_dtype))
    want = greedy(in_memory)
    del in_memory
    gc.collect()
    torch.cuda.empty_cache()
    same = got == want
    print(f"import {served}: greedy ids of {len(prompts)} prompts from the "
          f"restored checkpoint {'equal' if same else 'DIFFER FROM'} those "
          f"of the tree converted in memory ({got[0][:6]}...); K1 launches "
          f"{launches}", flush=True)
    if not same or launches < 1:
        raise SystemExit(f"serving the {served} import failed")
    record[served]["greedy_equal"] = same
    return record, launches


def family_server_setup(torch, dev, seed, workdir, name, prompt_lens, new):
    """Phase 16 (e), one family, in this process: seeded bf16 params of
    ``name`` at full width and depth saved on the contract's model mount,
    and this process's greedy decode of each prompt length. Returns
    (name, contract root, config, [(prompt text, request, answer text)])
    for ``family_server``."""
    from runbooks_tpu_torch.models.config import get_config
    from runbooks_tpu_torch.models.transformer import init_params
    from runbooks_tpu_torch.serve.engine import InferenceEngine, Request
    from runbooks_tpu_torch.train.checkpoint import CheckpointManager
    from runbooks_tpu_torch.train.data import ByteTokenizer

    cfg = get_config(name, param_dtype="bfloat16")
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed + 16)
    params = init_params(cfg, gen, dev)
    # Only byte ids decode to text: the tied head's other rows (and so
    # their input embeddings) are zeroed so the greedy tokens show in the
    # answer's text.
    params["embed"][256:] = 0
    content = f"{workdir}/{name}_content"
    CheckpointManager(f"{content}/model").save(
        1, {"step": 1, "params": params})
    tok = ByteTokenizer()
    cases = []
    for n in prompt_lens:
        text = tok.decode(seeded_prompts(seed + n, (n,))[0][1:])
        ref = Request(prompt_tokens=tok.encode(text, add_eos=False),
                      max_tokens=new[n], eos_id=tok.eos_id)
        with torch.no_grad():
            InferenceEngine(cfg, params, max_slots=8, seed=seed).generate(
                [ref])
        out = ref.output_tokens
        if out and out[-1] == tok.eos_id:
            out = out[:-1]
        cases.append((text, ref, tok.decode(out)))
    del params
    gc.collect()
    torch.cuda.empty_cache()
    return name, content, cfg, cases


def family_server(name, content, cfg, cases, stream=False):
    """Phase 16 (e) and 22 (c), one family (a Background check): ``python
    -m runbooks_tpu_torch.serve.api`` with the example's params (the
    model's name; the byte tokenizer, since it names none) on
    family_server_setup's mount, one greedy completion per case against
    this process's decode (with ``stream``, the first case streamed too:
    its deltas add up to that text), then SIGTERM. Returns (record, K1
    launches over the server's life)."""
    port = free_port()
    with open(f"{content}/params.json", "w") as f:
        json.dump({"model": name, "port": port,
                   "drain_timeout_s": ENTRY_DRAIN_S}, f)
    log_path = f"{content}/server.log"
    proc, base, ready_s = start_entry_point(content, port, log_path, 180)
    answers = []
    try:
        for text, ref, want_text in cases:
            t1 = time.perf_counter()
            status, _, body, _ = http_call(base, "/v1/completions", {
                "prompt": text, "max_tokens": ref.max_tokens,
                "temperature": 0})
            if status != 200:
                raise SystemExit(f"{name} completion: {status} {body}")
            reply = json.loads(body)
            choice = reply["choices"][0]
            answers.append({
                "prompt_tokens": len(ref.prompt_tokens),
                "completion_tokens": reply["usage"]["completion_tokens"],
                "last_position": (len(ref.prompt_tokens)
                                  + len(ref.output_tokens) - 1),
                "finish_reason": choice["finish_reason"],
                "request_s": time.perf_counter() - t1,
                "equal": (choice["text"] == want_text
                          and reply["usage"]["completion_tokens"]
                          == len(ref.output_tokens)
                          and choice["finish_reason"] == ref.finish_reason)})
        streamed = None
        if stream:
            text, ref, want_text = cases[0]
            t_first, chunks = stream_check(
                base, {"prompt": text, "max_tokens": ref.max_tokens,
                       "temperature": 0}, want_text, f"{name} stream",
                chat=False)
            streamed = {"first_chunk_s": t_first, "chunks": chunks}
        proc.send_signal(signal.SIGTERM)
        rc = proc.wait(timeout=ENTRY_DRAIN_S)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()
        with open(log_path) as f:
            log_text = f.read()
    launches = stopped_launches(log_text)
    restored = "restored params of step 1" in log_text
    record = {"ready_s": ready_s, "restored_from_mount": restored,
              "answers": answers, "stream": streamed, "exit_code": rc,
              "flash_fwd_launches": launches,
              "position_table": cfg.max_seq_len}
    print(f"{name} over HTTP " + json.dumps(record), flush=True)
    if not (restored and rc == 0 and launches >= cfg.num_layers
            and all(a["equal"] for a in answers)):
        print(log_text[-3000:], flush=True)
        raise SystemExit(f"the {name} server check failed")
    return record, launches


def families_phase(torch, dev, seed, batch, data_path, workdir):
    """Phase 16: the non-Llama dense families. Returns (K1 launches by
    path, K2/K3 launches, the kernel records at the families' shapes)."""
    t_phase = time.perf_counter()
    t0 = time.perf_counter()
    fwd, fwd_worst = kernel_phase(
        torch, dev, seed + 16, batch,
        layouts=family_fwd_layouts(torch, dev, batch), gqa=True)
    bwd, bwd_worst = bwd_kernel_phase(
        torch, dev, seed + 16, batch,
        layouts=family_bwd_layouts(torch, dev, batch))
    kernels_s = time.perf_counter() - t0
    gc.collect()
    torch.cuda.empty_cache()
    serve, serve_launches = family_serve(torch, seed, "falcon-7b",
                                         FALCON_SERVE_LAYERS)
    train, train_launches = family_train(torch, dev, seed, data_path,
                                         workdir, "falcon-7b",
                                         FALCON_TRAIN_LAYERS)
    gc.collect()
    torch.cuda.empty_cache()
    # (e)'s two servers start and answer while (d) imports.
    servers = [Background(family_server, *family_server_setup(
        torch, dev, seed, workdir, name, lens, new))
        for name, lens, new in (
            ("opt-125m", (300,), {300: FAMILY_HTTP_NEW}),
            ("gpt2", (300, GPT2_LONG_PROMPT),
             {300: FAMILY_HTTP_NEW, GPT2_LONG_PROMPT: GPT2_LONG_NEW}))]
    imported, import_launches = family_import(
        torch, dev, seed, workdir, ("falcon-7b", "falcon-40b"), "falcon-7b")
    gc.collect()
    torch.cuda.empty_cache()
    (opt, opt_launches), (gpt2, gpt2_launches) = (
        b.result() for b in servers)
    fwd_launches = {**serve_launches,
                    "falcon_train": train_launches["flash_fwd"],
                    "falcon_import": import_launches,
                    "opt_http": opt_launches, "gpt2_http": gpt2_launches}
    print("phase 16 " + json.dumps({
        "card": card_line(), "kernels_s": kernels_s,
        "flash_fwd_launches": fwd_launches,
        "serve": serve, "fine_tune": train, "import": imported,
        "opt_http": opt, "gpt2_http": gpt2,
        "seconds": time.perf_counter() - t_phase}), flush=True)
    return (fwd_launches,
            {"flash_bwd_dq": train_launches["flash_bwd_dq"],
             "flash_bwd_dkv": train_launches["flash_bwd_dkv"]},
            {"fwd": fwd, "bwd": bwd, "fwd_worst": fwd_worst,
             "bwd_worst": bwd_worst})


# ---------------------------------------------------------------------------
# Phase 17: the rest of the fine-tune entry point
# ---------------------------------------------------------------------------

# (a) the remat policies, each over phase 16 (c)'s job for REMAT_STEPS
# steps on one seeded falcon-7b base. Step 1's loss is computed before
# any update, from the same weights and batch under every policy: the
# policies change what the backward keeps, never the forward, so the
# losses must agree to REMAT_LOSS_RTOL (they are expected bit-equal).
REMAT_STEPS = 2
# Phase 17 (a) and (a') run falcon-7b at full width cut to REMAT_LAYERS,
# so that the whole script stays inside its limit; no path of the script
# trains or serves falcon-7b at its full 32 layers (phases 4 and 7 run
# llama3-8b, phase 22 gemma-7b and gemma-2b, at full depth). The
# policies' checks are per layer.
REMAT_LAYERS = 4
REMAT_POLICIES = ("nothing_saveable", "dots_with_no_batch_dims_saveable",
                  "dots_saveable", "save_attn_out")
REMAT_LOSS_RTOL = 1e-6
# (b) the restart path on falcon-7b at full width cut to RESTART_LAYERS
# layers: batches of RESTART_BATCH rows of TRAIN_SEQ tokens.
RESTART_LAYERS = 2
RESTART_BATCH = 2
RESTART_STEPS = 4
# (d) the OPT-style tokenizer's ids: <s>, <pad>, </s>, <unk>, the 256
# byte symbols and 50,005 merges (facebook/opt-125m's 50,265).
OPT_VOCAB = 50265
OPT_SERVE_PROMPTS = 4
OPT_SERVE_NEW = 24


def remat_policies_phase(torch, dev, seed, data_path, workdir, trace):
    """Phase 17 (a): phase 16 (c)'s falcon-7b LoRA job (rank 16, alpha
    32, batch 8 in 4 microbatches of 2, seq 2048) under each remat policy
    for REMAT_STEPS steps, all over one seeded f32 base. Per policy: the
    steady step's seconds, tokens/s, MFU, peak memory and K1/K2/K3
    launches per optimizer step; with ``trace``, then one traced step
    (traced_lora_step: device busy and idle share, K1/K2/K3 device ms; its
    launches are not the run's). Returns (records, launches by policy)."""
    from runbooks_tpu_torch.models.config import get_config
    from runbooks_tpu_torch.models.transformer import init_params
    from runbooks_tpu_torch.ops.flash_attention import (
        flash_attention,
        flash_attention_bwd,
    )
    from runbooks_tpu_torch.train.lora import LoraConfig
    from runbooks_tpu_torch.train.optimizer import OptimizerConfig
    from runbooks_tpu_torch.train.trainer import TrainJobConfig, run_training

    cfg = get_config("falcon-7b", num_layers=REMAT_LAYERS)
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed + 17)
    base = init_params(cfg, gen, dev)
    micro = cfg.num_layers * 4
    want = {p: {"flash_fwd": micro if p == "save_attn_out" else 2 * micro,
                "flash_bwd_dq": micro, "flash_bwd_dkv": micro}
            for p in REMAT_POLICIES}
    records, launches = {}, {}
    for policy in REMAT_POLICIES:
        job = TrainJobConfig(
            model="falcon-7b", model_overrides={"remat_policy": policy,
                                                "num_layers": REMAT_LAYERS},
            lora=LoraConfig(rank=16, alpha=32.0),
            optimizer=OptimizerConfig(learning_rate=2e-5), batch_size=8,
            seq_len=TRAIN_SEQ, accumulate_steps=4, steps=REMAT_STEPS,
            data_path=data_path, artifacts_dir=f"{workdir}/remat_{policy}",
            log_every=1, checkpoint_every=1000, seed=seed)
        gc.collect()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        flash_attention.launches = 0
        flash_attention_bwd.dq_launches = 0
        flash_attention_bwd.dkv_launches = 0
        summary = run_training(job, base_params=base)
        launches[policy] = {"flash_fwd": flash_attention.launches,
                            "flash_bwd_dq": flash_attention_bwd.dq_launches,
                            "flash_bwd_dkv":
                                flash_attention_bwd.dkv_launches}
        last = summary["history"][-1]
        records[policy] = {
            "losses": [e["loss"] for e in summary["history"]],
            "first_step_s": summary["first_step_s"],
            "step_s": last["step_s"], "tokens_per_s": last["tokens_per_sec"],
            "mfu": last.get("mfu"),
            "peak_memory_gb": torch.cuda.max_memory_allocated() / 1e9,
            "launches_per_step": {k: v / REMAT_STEPS
                                  for k, v in launches[policy].items()}}
        gc.collect()
        torch.cuda.empty_cache()
        if trace:
            records[policy]["traced"] = traced_lora_step(
                torch, dev, dataclasses.replace(cfg, remat_policy=policy),
                base, gen, data_path, job.lora, job.optimizer)
        print(f"remat {policy} " + json.dumps(records[policy]), flush=True)
    profiled, launches["nothing_saveable_profiled"] = profiled_fine_tune(
        torch, seed, data_path, workdir, base,
        records["nothing_saveable"])
    del base
    gc.collect()
    torch.cuda.empty_cache()
    first = {p: r["losses"][0] for p, r in records.items()}
    ref = first["nothing_saveable"]
    gates = {
        "launches": all(records[p]["launches_per_step"] == want[p]
                        for p in REMAT_POLICIES),
        "losses_finite": all(math.isfinite(x) for r in records.values()
                             for x in r["losses"])
                         and all(len(r["losses"]) == REMAT_STEPS
                                 for r in records.values()),
        "step1_loss_equal": all(abs(x - ref) <= REMAT_LOSS_RTOL * abs(ref)
                                for x in first.values())}
    print(f"remat (a): step-1 losses {first} (bit-equal: "
          f"{len(set(first.values())) == 1}); launches per step want "
          f"{want}; gates {gates}", flush=True)
    if not all(gates.values()):
        raise SystemExit(f"remat policies: gates failed: {gates}")
    records["nothing_saveable_profiled"] = profiled
    return records, launches


PROFILE_STEPS = 3
PROFILE_AT = (2, 1)


def profiled_fine_tune(torch, seed, data_path, workdir, base, plain):
    """Phase 17 (a'): (a)'s nothing_saveable job for PROFILE_STEPS steps
    under RBT_PROFILE_AT_STEP=2:1. The capture of step 2 names K1, K2 and
    K3 with one step's launches (at REMAT_LAYERS 4: 32 / 16 / 16);
    metrics.json carries
    goodput in (0, 1]; train_step_seconds counts every step after the
    first (the reference leaves the first, its compile, out too); step
    1's loss is bit-equal to (a)'s run without a capture. Also the step
    program's counted FLOPs, bytes and operators, and the analytic MFU.
    Returns (record, launches)."""
    from runbooks_tpu_torch.obs.metrics import REGISTRY
    from runbooks_tpu_torch.ops.flash_attention import (
        flash_attention,
        flash_attention_bwd,
    )
    from runbooks_tpu_torch.train.lora import LoraConfig
    from runbooks_tpu_torch.train.optimizer import OptimizerConfig
    from runbooks_tpu_torch.train.trainer import TrainJobConfig, run_training

    art = f"{workdir}/remat_profiled"
    job = TrainJobConfig(
        model="falcon-7b",
        model_overrides={"remat_policy": "nothing_saveable",
                         "num_layers": REMAT_LAYERS},
        lora=LoraConfig(rank=16, alpha=32.0),
        optimizer=OptimizerConfig(learning_rate=2e-5), batch_size=8,
        seq_len=TRAIN_SEQ, accumulate_steps=4, steps=PROFILE_STEPS,
        data_path=data_path, artifacts_dir=art, log_every=1,
        checkpoint_every=1000, seed=seed)
    before = REGISTRY.histogram_stats("train_step_seconds") or (0, 0.0)
    gc.collect()
    torch.cuda.empty_cache()
    flash_attention.launches = 0
    flash_attention_bwd.dq_launches = 0
    flash_attention_bwd.dkv_launches = 0
    os.environ["RBT_PROFILE_AT_STEP"] = "%d:%d" % PROFILE_AT
    try:
        summary = run_training(job, base_params=base)
    finally:
        del os.environ["RBT_PROFILE_AT_STEP"]
    launches = {"flash_fwd": flash_attention.launches,
                "flash_bwd_dq": flash_attention_bwd.dq_launches,
                "flash_bwd_dkv": flash_attention_bwd.dkv_launches}
    capture = trace_kernel_counts(
        f"{art}/profiles/step{PROFILE_AT[0]}/trace.json")
    with open(f"{art}/metrics.json") as f:
        written = json.load(f)
    after = REGISTRY.histogram_stats("train_step_seconds")
    want = plain["launches_per_step"]
    cost = summary["device_obs"]["cost"]
    last = summary["history"][-1]
    record = {
        "losses": [e["loss"] for e in summary["history"]],
        "capture_launches": capture,
        "launches": launches,
        "goodput": written["goodput"],
        "goodput_detail": written["goodput_detail"],
        "step_seconds_count": after[0] - before[0],
        "first_step_s": summary["first_step_s"],
        "step_s": last["step_s"],
        "program_flops": cost["flops"],
        "program_hbm_bytes": cost["hbm_bytes"],
        "program_ops": cost["ops"],
        "formula_flops": summary["device_obs"]["formula_flops_per_step"],
        "analytic_mfu": last.get("analytic_mfu"), "mfu": last.get("mfu")}
    gates = {
        "capture_launches": all(capture[k] == want[k] for k in want),
        "goodput": 0 < written["goodput"] <= 1,
        "step_seconds_count": record["step_seconds_count"]
        == PROFILE_STEPS - 1,
        "step1_loss_bit_equal": record["losses"][0] == plain["losses"][0],
        "no_unexpected_builds":
            summary["device_obs"]["unexpected_compiles"] == 0}
    record["gates"] = gates
    print("remat profiled " + json.dumps(record), flush=True)
    if not all(gates.values()):
        raise SystemExit(f"the profiled fine-tune's gates failed: {gates}")
    return record, launches


class _FakeMetadata(object):
    """A local stand-in for the GCE metadata server that reports a pending
    maintenance event (127.0.0.1 only)."""

    def __init__(self):
        import http.server

        class Handler(http.server.BaseHTTPRequestHandler):
            def do_GET(self):
                body = (b"TERMINATE_ON_HOST_MAINTENANCE"
                        if "maintenance-event" in self.path else b"")
                self.send_response(200)
                self.send_header("Metadata-Flavor", "Google")
                self.end_headers()
                self.wfile.write(body)

            def log_message(self, *a):
                pass

        self.server = http.server.HTTPServer(("127.0.0.1", 0), Handler)
        self.host = f"127.0.0.1:{self.server.server_address[1]}"
        threading.Thread(target=self.server.serve_forever,
                         daemon=True).start()

    def close(self):
        self.server.shutdown()
        self.server.server_close()


def restart_phase(torch, dev, seed, data_path, workdir):
    """Phase 17 (b): RBT_FAULT_INJECT and the maintenance poller on
    falcon-7b at full width cut to RESTART_LAYERS layers (LoRA rank 16):
    a kill and a rerun land on the uninterrupted run's adapter bit for
    bit; SIGTERM stops with the emergency checkpoint and exit code 42; a
    poisoned step leaves the adapter bit-unchanged and the run goes on;
    poisoned steps from one on abort after max_bad_steps; a maintenance
    event from a local metadata fake stops with exit code 42."""
    from runbooks_tpu_torch.models.config import get_config
    from runbooks_tpu_torch.models.transformer import init_params
    from runbooks_tpu_torch.train import trainer
    from runbooks_tpu_torch.train.checkpoint import CheckpointManager
    from runbooks_tpu_torch.train.lora import LoraConfig
    from runbooks_tpu_torch.train.optimizer import OptimizerConfig
    from runbooks_tpu_torch.utils.tree import tree_leaves

    over = {"num_layers": RESTART_LAYERS}
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed + 171)
    base = init_params(get_config("falcon-7b", **over), gen, dev)

    def job(name, steps, **kw):
        return trainer.TrainJobConfig(
            model="falcon-7b", model_overrides=over,
            lora=LoraConfig(rank=16, alpha=32.0),
            optimizer=OptimizerConfig(learning_rate=1e-4, warmup_steps=0),
            batch_size=RESTART_BATCH, seq_len=TRAIN_SEQ, steps=steps,
            data_path=data_path, artifacts_dir=f"{workdir}/restart_{name}",
            log_every=1, seed=seed, **kw)

    def run(j, fault=None):
        if fault:
            os.environ["RBT_FAULT_INJECT"] = fault
        try:
            return trainer.run_training(j, base_params=base)
        finally:
            os.environ.pop("RBT_FAULT_INJECT", None)

    def adapter(name, step):
        state, _, _ = CheckpointManager(
            f"{workdir}/restart_{name}").restore_with_cursor(
                step, device=torch.device("cpu"))
        return list(tree_leaves(state["params"]))

    def same(a, b):
        return len(a) == len(b) and all(torch.equal(x, y)
                                        for x, y in zip(a, b))

    t0 = time.perf_counter()
    gates, rec = {}, {}
    whole = run(job("whole", RESTART_STEPS, checkpoint_every=2))
    # kill:3 dies at the top of step index 3, one step past the step-2
    # checkpoint: the rerun replays that step and must land where the
    # uninterrupted run did.
    try:
        run(job("killed", RESTART_STEPS, checkpoint_every=2), "kill:3")
        gates["kill_raised"] = False
    except trainer.SimulatedFault:
        gates["kill_raised"] = True
    resumed = run(job("killed", RESTART_STEPS, checkpoint_every=2))
    gates["kill_resume_bit_equal"] = (
        resumed["restored_step"] == 2
        and [e["step"] for e in resumed["history"]] == [3, 4]
        and same(adapter("killed", RESTART_STEPS),
                 adapter("whole", RESTART_STEPS)))
    rec["kill"] = {"whole_losses": [e["loss"] for e in whole["history"]],
                   "resumed_losses": [e["loss"]
                                      for e in resumed["history"]]}
    stopped = run(job("sigterm", RESTART_STEPS, checkpoint_every=100),
                  "sigterm:2")
    gates["sigterm_42"] = (
        stopped["exit_reason"] == "sigterm"
        and trainer.exit_code_for(stopped) == 42
        and CheckpointManager(f"{workdir}/restart_sigterm")
        .latest_intact_step() == 2)
    poisoned = run(job("nonfinite", 3, checkpoint_every=1), "nonfinite:1")
    gates["nonfinite_leaves_adapter"] = (
        poisoned["nonfinite_steps"] == 1 and poisoned["exit_reason"] is None
        and math.isfinite(poisoned["final_loss"])
        and same(adapter("nonfinite", 2), adapter("nonfinite", 1))
        and not same(adapter("nonfinite", 3), adapter("nonfinite", 2)))
    try:
        run(job("abort", 6, max_bad_steps=3), "nonfinite:1+")
        gates["nonfinite_abort"] = False
    except RuntimeError as exc:
        gates["nonfinite_abort"] = "3 consecutive non-finite" in str(exc)
    fake = _FakeMetadata()
    old_host = os.environ.get("GCE_METADATA_HOST")
    os.environ["GCE_METADATA_HOST"] = fake.host
    try:
        t1 = time.perf_counter()
        maint = run(job("maintenance", 500, checkpoint_every=1000,
                        maintenance_poll_s=0.2))
        rec["maintenance"] = {"steps_run": maint["batches_consumed"],
                              "seconds": time.perf_counter() - t1}
    finally:
        fake.close()
        if old_host is None:
            os.environ.pop("GCE_METADATA_HOST", None)
        else:
            os.environ["GCE_METADATA_HOST"] = old_host
    gates["maintenance_42"] = (
        maint["exit_reason"] == "maintenance"
        and trainer.exit_code_for(maint) == 42
        and CheckpointManager(f"{workdir}/restart_maintenance")
        .latest_intact_step() == maint["batches_consumed"] < 500)
    del base
    gc.collect()
    torch.cuda.empty_cache()
    rec["seconds"] = time.perf_counter() - t0
    print("restart (b) " + json.dumps({**rec, "gates": gates}), flush=True)
    if not all(gates.values()):
        raise SystemExit(f"restart path: gates failed: {gates}")
    return rec


def run_trainer_entry(content, env, timeout):
    """``python -m runbooks_tpu_torch.train.trainer`` over ``content``:
    (its {"done": ...} line, wall seconds)."""
    root = os.path.dirname(os.path.abspath(__file__))
    t0 = time.perf_counter()
    out = subprocess.run(
        [sys.executable, "-m", "runbooks_tpu_torch.train.trainer"],
        cwd=root, env=env, capture_output=True, text=True, timeout=timeout)
    wall = time.perf_counter() - t0
    done = [json.loads(line) for line in out.stdout.splitlines()
            if line.startswith('{"done"')]
    if out.returncode != 0 or not done:
        print(out.stdout[-3000:], out.stderr[-3000:], flush=True)
        raise SystemExit(f"the trainer entry point exited {out.returncode}")
    return done[-1], wall


def kernel_cache_phase(seed, data_path, workdir, environ):
    """Phase 17 (c) (a Background check, over ``environ``, a copy of this
    process's environment): the trainer's entry point builds the kernels
    into <artifacts>/kernel_cache: a cold process over a fresh artifacts
    directory runs nvcc for every source, a second one over the same
    directory runs none and leaves the libraries' mtimes as they were.
    Each process is falcon-7b cut to RESTART_LAYERS layers, one step."""
    root = os.path.dirname(os.path.abspath(__file__))
    content = f"{workdir}/kernel_cache_content"
    os.makedirs(content)
    params = {"model": "falcon-7b",
              "model_overrides": {"num_layers": RESTART_LAYERS},
              "lora": {"rank": 16, "alpha": 32.0},
              "batch_size": RESTART_BATCH, "seq_len": TRAIN_SEQ,
              "log_every": 1, "data_path": data_path, "seed": seed,
              # No GCE probe: this machine has no metadata server.
              "maintenance_poll_s": 0}
    env = dict(environ, RBT_CONTENT_DIR=content,
               GCE_METADATA_HOST="127.0.0.1:9",
               PYTHONPATH=root + os.pathsep + environ.get("PYTHONPATH", ""))
    env.pop("RBT_KERNEL_CACHE", None)
    env.pop("RBT_FAULT_INJECT", None)
    cache = f"{content}/artifacts/kernel_cache"
    runs = {}
    mtimes = {}
    for name, steps in (("cold", 1), ("warm", 2)):
        with open(f"{content}/params.json", "w") as f:
            json.dump(dict(params, steps=steps), f)
        done, wall = run_trainer_entry(content, env, 600)
        runs[name] = {"wall_s": wall, "first_step_s": done["first_step_s"],
                      "restored_step": done["restored_step"],
                      **done["kernel_cache"]}
        mtimes[name] = {n: os.stat(f"{cache}/{n}").st_mtime_ns
                        for n in sorted(os.listdir(cache))
                        if n.endswith(".so")}
    gates = {
        "cache_dir": all(r["dir"] == cache for r in runs.values()),
        "cold_built_every_source": runs["cold"]["nvcc_runs"] == len(KERNELS)
        and len(mtimes["cold"]) == len(KERNELS),
        "warm_no_nvcc": runs["warm"]["nvcc_runs"] == 0
        and mtimes["warm"] == mtimes["cold"],
        "warm_resumed": runs["warm"]["restored_step"] == 1}
    rec = {"runs": runs, "libraries": sorted(mtimes["cold"]),
           "gates": gates}
    print("kernel cache (c) " + json.dumps(rec), flush=True)
    if not all(gates.values()):
        raise SystemExit(f"kernel cache: gates failed: {gates}")
    return rec


def _opt_bpe(docs, seed):
    """An OPT-style byte-level BPE: (vocab, merges) with <s>, <pad>,
    </s>, <unk> at 0-3, the 256 byte symbols, then OPT_VOCAB - 260 merges
    of two earlier tokens within one pre-token of GPT-2's split (the
    docs' most frequent byte pairs, their pre-tokens built left to right,
    then seeded pre-tokens)."""
    import collections

    import numpy as np

    from runbooks_tpu_torch.models import tokenizer_io as tio

    rx = tio.split_regex(tio.GPT2_PATTERN)
    table = {b: c for b, c in enumerate(tio.bytes_to_unicode())}
    counts = collections.Counter()
    for doc in docs:
        counts.update(rx.findall(doc))
    ranked = counts.most_common()
    words = [w.encode("utf-8").decode("latin-1").translate(table)
             for w, _ in ranked]
    vocab = {"<s>": 0, "<pad>": 1, "</s>": 2, "<unk>": 3}
    for c in tio.bytes_to_unicode():
        vocab[c] = len(vocab)
    merges = []
    n_merges = OPT_VOCAB - len(vocab)
    pairs = collections.Counter()
    for w, (_, n) in zip(words[:20000], ranked[:20000]):
        for k in range(len(w) - 1):
            pairs[w[k:k + 2]] += n
    for pair, _ in pairs.most_common(2000):
        if pair not in vocab:
            vocab[pair] = len(vocab)
            merges.append([pair[0], pair[1]])
    for w in words:
        if len(merges) >= n_merges:
            break
        _chain(vocab, merges, w, n_merges)
    rng = np.random.default_rng(seed + 32)
    letters = [chr(c) for c in range(0x61, 0x7B)]
    while len(merges) < n_merges:
        k = int(rng.integers(2, 10))
        w = (" " if rng.random() < 0.6 else "") + "".join(
            letters[int(i)] for i in rng.integers(len(letters), size=k))
        _chain(vocab, merges, w.encode("utf-8").decode("latin-1")
               .translate(table), n_merges)
    return vocab, merges


def write_opt_tokenizers(files_dir, json_dir, docs, seed):
    """One OPT-style BPE in two directories: facebook/opt-125m's files
    (vocab.json, merges.txt with its version line, OPT's
    tokenizer_config.json and special_tokens_map.json: </s> as bos, eos
    and unk, <pad>, add_bos_token) and the tokenizer.json that
    transformers' GPT2Converter makes of them (ByteLevel pre-tokenizer
    and decoder, </s> prepended, <pad> and </s> added as specials)."""
    vocab, merges = _opt_bpe(docs, seed)
    special = {"content": "</s>", "lstrip": False, "normalized": True,
               "rstrip": False, "single_word": False}
    config = {"tokenizer_class": "GPT2Tokenizer", "errors": "replace",
              "bos_token": "</s>", "eos_token": "</s>", "unk_token": "</s>",
              "pad_token": "<pad>", "add_prefix_space": False,
              "add_bos_token": True}
    os.makedirs(files_dir, exist_ok=True)
    with open(f"{files_dir}/vocab.json", "w", encoding="utf-8") as f:
        json.dump(vocab, f, ensure_ascii=False)
    with open(f"{files_dir}/merges.txt", "w", encoding="utf-8") as f:
        f.write("#version: 0.2\n" + "".join(f"{a} {b}\n"
                                             for a, b in merges))
    with open(f"{files_dir}/tokenizer_config.json", "w") as f:
        json.dump(config, f)
    with open(f"{files_dir}/special_tokens_map.json", "w") as f:
        json.dump({"bos_token": special, "eos_token": special,
                   "unk_token": special,
                   "pad_token": dict(special, content="<pad>")}, f)
    added = [{"id": i, "content": c, "single_word": False, "lstrip": False,
              "rstrip": False, "normalized": True, "special": True}
             for c, i in (("<pad>", 1), ("</s>", 2))]
    spec = {
        "version": "1.0", "truncation": None, "padding": None,
        "added_tokens": added, "normalizer": None,
        "pre_tokenizer": {"type": "ByteLevel", "add_prefix_space": False,
                          "trim_offsets": True, "use_regex": True},
        "post_processor": {
            "type": "TemplateProcessing",
            "single": [{"SpecialToken": {"id": "</s>", "type_id": 0}},
                       {"Sequence": {"id": "A", "type_id": 0}}],
            "pair": [{"SpecialToken": {"id": "</s>", "type_id": 0}},
                     {"Sequence": {"id": "A", "type_id": 0}},
                     {"Sequence": {"id": "B", "type_id": 1}}],
            "special_tokens": {"</s>": {"id": "</s>", "ids": [2],
                                        "tokens": ["</s>"]}}},
        "decoder": {"type": "ByteLevel", "add_prefix_space": True,
                    "trim_offsets": True, "use_regex": True},
        "model": {"type": "BPE", "dropout": None, "unk_token": None,
                  "continuing_subword_prefix": "", "end_of_word_suffix": "",
                  "fuse_unk": False, "byte_fallback": False,
                  "ignore_merges": False, "vocab": vocab, "merges": merges}}
    _write_tokenizer(json_dir, spec, config)


def _pb_varint(n):
    n &= (1 << 64) - 1
    out = bytearray()
    while True:
        byte = n & 0x7F
        n >>= 7
        if n:
            out.append(byte | 0x80)
        else:
            out.append(byte)
            return bytes(out)


def _pb_field(number, wire, payload):
    key = _pb_varint(number << 3 | wire)
    if wire == 2:
        return key + _pb_varint(len(payload)) + payload
    return key + payload


def sentencepiece_model_bytes(pieces, byte_fallback=True):
    """A sentencepiece ModelProto in the protobuf wire format: ``pieces``
    as (piece, score, type), a BPE trainer spec (unk/bos/eos ids 0-2, no
    pad), the identity normalizer with the dummy prefix."""
    out = bytearray()
    for piece, score, kind in pieces:
        msg = (_pb_field(1, 2, piece.encode("utf-8"))
               + _pb_field(2, 5, struct.pack("<f", score))
               + _pb_field(3, 0, _pb_varint(kind)))
        out += _pb_field(1, 2, msg)
    trainer = (_pb_field(3, 0, _pb_varint(2))
               + _pb_field(4, 0, _pb_varint(len(pieces)))
               + _pb_field(35, 0, _pb_varint(int(byte_fallback)))
               + _pb_field(40, 0, _pb_varint(0))
               + _pb_field(41, 0, _pb_varint(1))
               + _pb_field(42, 0, _pb_varint(2))
               + _pb_field(43, 0, _pb_varint(-1)))
    out += _pb_field(2, 2, trainer)
    norm = (_pb_field(1, 2, b"identity") + _pb_field(3, 0, _pb_varint(1))
            + _pb_field(4, 0, _pb_varint(0)) + _pb_field(5, 0, _pb_varint(1)))
    out += _pb_field(3, 2, norm)
    return bytes(out)


def score_merges(vocab, scores):
    """llama2's converter's merges from piece scores: each piece's splits
    into two pieces of the vocab (by their ids), ranked by the piece's
    score, then the longer left part, then the longer right part,
    highest first."""
    found = []
    for piece, score in scores:
        splits = sorted(((piece[:i], piece[i:]) for i in range(1, len(piece))
                         if piece[:i] in vocab and piece[i:] in vocab),
                        key=lambda ab: (vocab[ab[0]], vocab[ab[1]]))
        found += [(a, b, score) for a, b in splits]
    found.sort(key=lambda m: (m[2], len(m[0]), len(m[1])), reverse=True)
    return [[a, b] for a, b, _ in found]


def write_sentencepiece_tokenizers(model_dir, json_dir, l2_vocab):
    """Phase 15's llama2-style pieces (``l2_vocab``, 32,000) twice: a
    directory with only a sentencepiece tokenizer.model (types UNKNOWN,
    CONTROL, BYTE and NORMAL, merged pieces scored -id) and llama2's
    tokenizer.json built from the same pieces and scores as transformers'
    LlamaConverter builds it."""
    pieces = []
    for piece, i in sorted(l2_vocab.items(), key=lambda kv: kv[1]):
        kind = (2 if i == 0 else 3 if i < 3
                else 6 if re.fullmatch(r"<0x[0-9A-F]{2}>", piece) else 1)
        pieces.append((piece, 0.0 if kind != 1 else -float(i), kind))
    os.makedirs(model_dir, exist_ok=True)
    with open(f"{model_dir}/tokenizer.model", "wb") as f:
        f.write(sentencepiece_model_bytes(pieces))
    vocab = {p: i for i, (p, _, _) in enumerate(pieces)}
    merges = score_merges(vocab, [(p, 0.0 if i < 3 else s)
                                  for i, (p, s, _) in enumerate(pieces)])
    sp = "▁"
    spec = {
        "version": "1.0", "truncation": None, "padding": None,
        "added_tokens": [{"id": i, "content": s, "single_word": False,
                          "lstrip": False, "rstrip": False,
                          "normalized": False, "special": True}
                         for i, s in enumerate(("<unk>", "<s>", "</s>"))],
        "normalizer": {"type": "Sequence", "normalizers": [
            {"type": "Prepend", "prepend": sp},
            {"type": "Replace", "pattern": {"String": " "}, "content": sp}]},
        "pre_tokenizer": None, "post_processor": None,
        "decoder": {"type": "Sequence", "decoders": [
            {"type": "Replace", "pattern": {"String": sp}, "content": " "},
            {"type": "ByteFallback"}, {"type": "Fuse"},
            {"type": "Strip", "content": " ", "start": 1, "stop": 0}]},
        "model": {"type": "BPE", "dropout": None, "unk_token": "<unk>",
                  "continuing_subword_prefix": None,
                  "end_of_word_suffix": None, "fuse_unk": True,
                  "byte_fallback": True, "ignore_merges": False,
                  "vocab": vocab, "merges": merges}}
    _write_tokenizer(json_dir, spec, {
        "tokenizer_class": "LlamaTokenizerFast", "bos_token": "<s>",
        "eos_token": "</s>", "unk_token": "<unk>", "add_bos_token": True,
        "add_eos_token": False, "clean_up_tokenization_spaces": False})


def serve_with_tokenizer(torch, cfg, params, tok, prompts):
    """``create_server`` over ``params`` with tokenizer ``tok``: each
    prompt's greedy completion text and token count, and K1's launches."""
    from runbooks_tpu_torch.ops.flash_attention import flash_attention
    from runbooks_tpu_torch.serve.api import create_server

    srv = create_server(cfg, params, tok, host="127.0.0.1", port=0,
                        max_slots=8, max_seq_len=2048)
    thread = threading.Thread(target=srv.serve_forever, daemon=True)
    thread.start()
    base = f"http://127.0.0.1:{srv.port}"
    flash_attention.launches = 0
    answers = []
    try:
        for prompt in prompts:
            status, _, body, _ = http_call(base, "/v1/completions", {
                "prompt": prompt, "max_tokens": OPT_SERVE_NEW,
                "temperature": 0})
            if status != 200:
                raise SystemExit(f"opt-125m completion: {status} "
                                 f"{body[:300]}")
            reply = json.loads(body)
            answers.append((reply["choices"][0]["text"],
                            reply["usage"]["prompt_tokens"],
                            reply["usage"]["completion_tokens"]))
    finally:
        launches = flash_attention.launches
        srv.shutdown()
        thread.join(timeout=60)
    return answers, launches


def tokenizer_files_phase(torch, seed, workdir):
    """Phase 17 (d): tokenizer directories without tokenizer.json, written
    from the seed at the published sizes over phase 15's corpus: an
    OPT-style vocab.json + merges.txt (50,265 ids) gives the ids of the
    tokenizer.json of the same BPE, and opt-125m served through each
    answers alike; a sentencepiece tokenizer.model of phase 15's 32,000
    llama2-style pieces gives the ids of the tokenizer.json built from
    the same pieces. Returns (record, K1 launches)."""
    from runbooks_tpu_torch.serve.api import load_model
    from runbooks_tpu_torch.train.data import load_tokenizer

    t_phase = time.perf_counter()
    docs = text_corpus(seed)
    n_bytes = sum(len(d.encode("utf-8")) for d in docs)
    rec = {"corpus_bytes": n_bytes}
    t0 = time.perf_counter()
    write_opt_tokenizers(f"{workdir}/opt_files", f"{workdir}/opt_json",
                         docs, seed)
    rec["opt_write_s"] = time.perf_counter() - t0
    toks, ids = {}, {}
    for name in ("opt_files", "opt_json"):
        t0 = time.perf_counter()
        toks[name] = load_tokenizer(f"{workdir}/{name}")
        rec[f"{name}_load_s"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        ids[name] = [toks[name].encode(d) for d in docs]
        rec[f"{name}_encode_mb_per_s"] = n_bytes / 1e6 / (
            time.perf_counter() - t0)
    opt_gates = {
        "sizes": all(len(t) == OPT_VOCAB for t in toks.values()),
        "ids_equal": ids["opt_files"] == ids["opt_json"],
        "bos_first": all(x[0] == 2 for x in ids["opt_files"])}
    rec["opt_tokens"] = sum(len(x) for x in ids["opt_files"])
    cfg, params = load_model({"model": "opt-125m", "model_overrides": {
        "param_dtype": "bfloat16"}, "seed": seed + 17})
    prompts = [d[:600] for d in docs[:OPT_SERVE_PROMPTS]]
    served, launches = {}, 0
    for name in ("opt_files", "opt_json"):
        served[name], n = serve_with_tokenizer(torch, cfg, params,
                                               toks[name], prompts)
        launches += n
    opt_gates["served_equal"] = served["opt_files"] == served["opt_json"]
    rec["opt_served"] = [{"prompt_tokens": p, "completion_tokens": c,
                          "text_chars": len(t)}
                         for t, p, c in served["opt_files"]]
    del params
    gc.collect()
    torch.cuda.empty_cache()

    t0 = time.perf_counter()
    write_llama2_tokenizer(f"{workdir}/l2_pieces", docs, seed)
    with open(f"{workdir}/l2_pieces/tokenizer.json", encoding="utf-8") as f:
        l2_vocab = json.load(f)["model"]["vocab"]
    write_sentencepiece_tokenizers(f"{workdir}/spm_model",
                                   f"{workdir}/spm_json", l2_vocab)
    rec["spm_write_s"] = time.perf_counter() - t0
    for name in ("spm_model", "spm_json"):
        t0 = time.perf_counter()
        toks[name] = load_tokenizer(f"{workdir}/{name}")
        rec[f"{name}_load_s"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        ids[name] = [toks[name].encode(d) for d in docs]
        rec[f"{name}_encode_mb_per_s"] = n_bytes / 1e6 / (
            time.perf_counter() - t0)
    spm_gates = {
        "sizes": all(toks[n].vocab_size == L2_VOCAB
                     for n in ("spm_model", "spm_json")),
        "ids_equal": ids["spm_model"] == ids["spm_json"],
        "decode_equal": all(
            toks["spm_model"].decode(x) == toks["spm_json"].decode(x)
            for x in ids["spm_model"][:64])}
    rec["spm_tokens"] = sum(len(x) for x in ids["spm_model"])
    rec["seconds"] = time.perf_counter() - t_phase
    rec["gates"] = {"opt": opt_gates, "sentencepiece": spm_gates}
    print("tokenizer files (d) " + json.dumps(rec), flush=True)
    if not (all(opt_gates.values()) and all(spm_gates.values())):
        raise SystemExit(f"tokenizer files: gates failed: {rec['gates']}")
    return rec, launches


def entry_point_phase(torch, dev, seed, data_path, workdir, trace_remat):
    """Phase 17: the rest of the fine-tune entry point. Returns (K1/K2/K3
    launches by path)."""
    t_phase = time.perf_counter()
    remat, remat_launches = remat_policies_phase(torch, dev, seed,
                                                 data_path, workdir,
                                                 trace_remat)
    # (c)'s two entry-point processes run while (b) and (d) do.
    cache = Background(kernel_cache_phase, seed, data_path, workdir,
                       dict(os.environ))
    restart = restart_phase(torch, dev, seed, data_path, workdir)
    tokenizers, opt_launches = tokenizer_files_phase(torch, seed, workdir)
    cache = cache.result()
    print("phase 17 " + json.dumps({
        "card": card_line(), "remat": remat, "restart": restart,
        "kernel_cache": cache, "tokenizer_files": tokenizers,
        "seconds": time.perf_counter() - t_phase}), flush=True)
    launches = {
        name: {f"remat_{p}": v[name] for p, v in remat_launches.items()}
        for name in ("flash_fwd", "flash_bwd_dq", "flash_bwd_dkv")}
    launches["flash_fwd"]["opt_tokenizer_files_http"] = opt_launches
    return launches


OBS_AB_MODES = (("flight_off", {"RBT_FLIGHT": "0"}), ("default", {}),
                ("trace", {"RBT_TRACE": "1"}))
OBS_AB_ROUNDS = 2
OBS_AB_NEW = 64
OBS_AB_LENS = (20, 40, 60, 80, 100, 120, 140, 160)


def obs_overhead_phase(torch, dev, seed, workdir):
    """Phase 18: what the telemetry costs, measured and not gated (host
    noise moves it 20-35% between runs), on llama3-8b bf16 at full width
    cut to SERVE_LAYERS layers, max_slots 8, max_seq_len 2048. (a) The
    seconds the first-dispatch counting adds to a warmup: warmups with
    RBT_DEVICE_OBS=0 against fresh engines' counted ones, interleaved.
    (b) A ``create_server`` in this process takes 8 greedy prompts of
    OBS_AB_NEW new tokens per run under RBT_FLIGHT=0, the default (the
    flight ring) and RBT_TRACE=1, the three interleaved OBS_AB_ROUNDS
    times (the switches are read per span, so one server serves them
    all): decode tokens/s over the engine's decode dispatch seconds, and
    over the wall. (c) The scrape's milliseconds, and the gate that
    device_memory_bytes_in_use is torch.cuda.memory_allocated() read at
    the scrape, within 1%. Returns K1's launches."""
    from runbooks_tpu_torch.models.config import get_config
    from runbooks_tpu_torch.models.transformer import init_params
    from runbooks_tpu_torch.obs import trace as obs_trace
    from runbooks_tpu_torch.ops.flash_attention import flash_attention
    from runbooks_tpu_torch.serve.api import create_server
    from runbooks_tpu_torch.serve.engine import InferenceEngine
    from runbooks_tpu_torch.train.data import ByteTokenizer

    t_phase = time.perf_counter()
    flash_attention.launches = 0
    cfg = get_config("llama3-8b", num_layers=SERVE_LAYERS,
                     param_dtype="bfloat16")
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed + 18)
    with torch.no_grad():
        params = init_params(cfg, gen, dev)
    obs_trace.configure(f"{workdir}/obs_ab/trace.jsonl")

    def warm(engine, counted):
        os.environ["RBT_DEVICE_OBS"] = "1" if counted else "0"
        try:
            t0 = time.perf_counter()
            with torch.no_grad():
                engine.warmup()
            torch.cuda.synchronize()
            return time.perf_counter() - t0
        finally:
            del os.environ["RBT_DEVICE_OBS"]
            engine.release_steady()

    plain = InferenceEngine(cfg, params, max_slots=8, max_seq_len=2048)
    warmups = {"first": warm(plain, False), "plain": [], "counted": []}
    for _ in range(2):
        warmups["plain"].append(warm(plain, False))
        fresh = InferenceEngine(cfg, params, max_slots=8, max_seq_len=2048)
        warmups["counted"].append(warm(fresh, True))
        del fresh
    del plain
    gc.collect()
    torch.cuda.empty_cache()

    srv = create_server(cfg, params, ByteTokenizer(), host="127.0.0.1",
                        port=0, device=dev, max_slots=8, max_seq_len=2048,
                        warmup=True)
    thread = threading.Thread(target=srv.serve_forever, daemon=True)
    thread.start()
    base = f"http://127.0.0.1:{srv.port}"
    engine = srv.worker.engine
    tok = ByteTokenizer()
    texts = [tok.decode(p[1:]) for p in seeded_prompts(seed + 18,
                                                        OBS_AB_LENS)]
    runs = []
    try:
        for rnd in range(OBS_AB_ROUNDS):
            for mode, env in OBS_AB_MODES:
                os.environ.update(env)
                try:
                    tokens = []
                    dec0 = engine.dispatch_seconds["decode"]

                    def one(i):
                        status, _, text, _ = http_call(
                            base, "/v1/completions",
                            {"prompt": texts[i], "max_tokens": OBS_AB_NEW,
                             "temperature": 0})
                        if status != 200:
                            raise SystemExit(f"phase 18 {mode}: {status}")
                        tokens.append(
                            json.loads(text)["usage"]["completion_tokens"])

                    threads = [threading.Thread(target=one, args=(i,))
                               for i in range(len(texts))]
                    t0 = time.perf_counter()
                    for t in threads:
                        t.start()
                    for t in threads:
                        t.join()
                    wall = time.perf_counter() - t0
                    dec = engine.dispatch_seconds["decode"] - dec0
                finally:
                    for k in env:
                        del os.environ[k]
                decoded = sum(tokens) - len(tokens)
                runs.append({"mode": mode, "round": rnd,
                             "tokens": sum(tokens),
                             "decode_tokens_per_s": decoded / dec,
                             "wall_tokens_per_s": sum(tokens) / wall,
                             "decode_dispatch_s": dec, "wall_s": wall})
                print(f"phase 18 {json.dumps(runs[-1])}", flush=True)
        fams, text, ms = scrape(base)
        allocated = torch.cuda.memory_allocated()
        scrape_ms = [ms] + [scrape(base)[2] for _ in range(19)]
        in_use = fams["device_memory_bytes_in_use"].total()
        problems = lint_exposition(text)
    finally:
        srv.shutdown()
        thread.join(timeout=60)
    del engine, srv, params
    gc.collect()
    torch.cuda.empty_cache()
    obs_trace.close()
    obs_trace.configure(None)
    by_mode = {m: [r["decode_tokens_per_s"] for r in runs if r["mode"] == m]
               for m, _ in OBS_AB_MODES}
    record = {
        "card": card_line(), "layers": SERVE_LAYERS,
        "warmup_s": warmups,
        "counting_adds_s": median(warmups["counted"])
        - median(warmups["plain"]),
        "runs": runs, "decode_tokens_per_s_by_mode": by_mode,
        "scrape_ms": scrape_ms, "scrape_ms_median": median(scrape_ms),
        "bytes_in_use_gauge": in_use, "memory_allocated": allocated,
        "launches": flash_attention.launches,
        "seconds": time.perf_counter() - t_phase}
    gates = {"memory_in_use_1pct":
             abs(in_use - allocated) <= MEMORY_RTOL * allocated,
             "exposition_lint": not problems}
    record["gates"] = gates
    print("phase 18 " + json.dumps(record), flush=True)
    if not all(gates.values()):
        raise SystemExit(f"phase 18 gates failed: {gates} {problems[:5]}")
    return record["launches"]



# ---------------------------------------------------------------------------
# Phase 19: the prefix-aware gateway in front of port replicas, and the
# fleet history over their scrapes
# ---------------------------------------------------------------------------

ROUTE_REPLICAS = 3
ROUTE_TENANTS = 8          # shared prefixes, one request each per wave
ROUTE_WAVES = 4
ROUTE_PRIVATE = 8          # private random tokens after the 2-page prefix
ROUTE_NEW = 8
ROUTE_SLOTS = 4
ROUTE_SEQ = 64
ROUTE_PAGES = 64
# Pages reused per policy by route_policies at the debug config on the
# CPU (tests/test_torch_gateway_router.py pins them). Routing is host-side
# and deterministic, and a request's reuse depends only on where its
# tenant's earlier waves went, so the card must count the same. Under
# "prefix" every tenant's waves 2-4 land on its first replica: 8 x 3 x 2.
ROUTE_REUSED = {"prefix": 48, "random": 20}
GATEWAY_SESSION = "phase19-session"
GATEWAY_NEW = 16
GATEWAY_SCRAPES = 5
GATEWAY_READY_S = 60


def route_traffic(vocab, seed):
    """bench_serve.py's routing traffic, rebuilt: ROUTE_TENANTS tenants,
    each with a shared prefix of 2 pages, and ROUTE_WAVES waves of one
    request per tenant (its prefix + ROUTE_PRIVATE private random ids).
    Returns the waves' prompts."""
    import random

    rng = random.Random(seed + 19)
    prefixes = [[rng.randrange(1, vocab) for _ in range(2 * PAGE_SIZE)]
                for _ in range(ROUTE_TENANTS)]
    return [[p + [rng.randrange(1, vocab) for _ in range(ROUTE_PRIVATE)]
             for p in prefixes] for _ in range(ROUTE_WAVES)]


def route_policies(torch, cfg, params, seed):
    """Phase 19 (a): ROUTE_REPLICAS warmed PagedInferenceEngines (pages
    of PAGE_SIZE, ROUTE_PAGES pages, ROUTE_SLOTS slots) behind the port's
    in-process Router with token_blocks keys, once under "prefix" and
    once under "random", each on reset engines (fresh pool, radix tree and
    counters); each wave is submitted, then every replica steps until all
    are idle, as bench_serve.py's router bench does. Per policy: pages
    reused (kv_occupancy, summed over the replicas), K1's launches, TTFT
    median and p90 (the replicas step in turn in this one thread), tokens
    per second of wall and the greedy ids. Then every prompt is served
    alone on a reset engine, and each policy's ids must equal those (or
    differ first at a near-tie). Returns the record."""
    from runbooks_tpu_torch.ops.flash_attention import flash_attention
    from runbooks_tpu_torch.serve.engine import Request
    from runbooks_tpu_torch.serve.gateway import Router, token_blocks
    from runbooks_tpu_torch.serve.paging import PagedInferenceEngine

    waves = route_traffic(cfg.vocab_size, seed)
    t0 = time.perf_counter()
    engines = {}
    for i in range(ROUTE_REPLICAS):
        engine = PagedInferenceEngine(
            cfg, params, max_slots=ROUTE_SLOTS, max_seq_len=ROUTE_SEQ,
            page_size=PAGE_SIZE, num_pages=ROUTE_PAGES, max_queue=64,
            seed=seed)
        with torch.no_grad():
            engine.warmup()
        engines[f"r{i}"] = engine
    record = {"warmup_s": time.perf_counter() - t0, "policies": {}}
    outputs = {}
    for policy in ("prefix", "random"):
        for engine in engines.values():
            engine.reset()
            engine.ttft_seconds.clear()
        router = Router({n: f"mem://{n}" for n in engines}, policy=policy)
        routed = {n: 0 for n in engines}
        ids = []
        flash_attention.launches = 0
        t0 = time.perf_counter()
        with torch.no_grad():
            for wave in waves:
                pending = []
                for toks in wave:
                    blocks = token_blocks(toks, PAGE_SIZE)
                    name = router.pick(blocks)[0][0]
                    req = Request(prompt_tokens=list(toks),
                                  max_tokens=ROUTE_NEW, temperature=0.0)
                    engines[name].submit(req)
                    router.inflight_add(name, 1)
                    router.record_route(name, blocks)
                    pending.append((name, req))
                    routed[name] += 1
                for _ in range(100000):
                    busy = [e for e in engines.values() if e.has_work()]
                    if not busy:
                        break
                    for e in busy:
                        e.step()
                else:
                    raise SystemExit(f"phase 19 (a) {policy}: a wave did "
                                     "not drain")
                for name, _ in pending:
                    router.inflight_add(name, -1)
                ids.extend(list(r.output_tokens) for _, r in pending)
        wall = time.perf_counter() - t0
        ttft = sorted(t for e in engines.values() for t in e.ttft_seconds)
        reused = {n: e.kv_occupancy()["pages_reused_total"]
                  for n, e in engines.items()}
        outputs[policy] = ids
        record["policies"][policy] = {
            "pages_reused_total": sum(reused.values()),
            "pages_reused_by_replica": reused, "routed": routed,
            "flash_fwd_launches": flash_attention.launches,
            "ttft_median_s": median(ttft),
            "ttft_p90_s": ttft[int(0.9 * (len(ttft) - 1))],
            "tokens_per_s": sum(len(x) for x in ids) / wall,
            "wall_s": wall}
        print(f"phase 19 (a) {policy} "
              + json.dumps(record["policies"][policy]), flush=True)
    alone = engines["r0"]
    prompts = [toks for wave in waves for toks in wave]
    with torch.no_grad():
        for i, toks in enumerate(prompts):
            alone.reset()
            req = Request(prompt_tokens=list(toks), max_tokens=ROUTE_NEW,
                          temperature=0.0)
            alone.generate([req])
            for policy, ids in outputs.items():
                if ids[i] != req.output_tokens:
                    near_tie_check(torch, cfg, params,
                                   f"phase 19 (a) {policy} prompt {i}",
                                   toks, ids[i], list(req.output_tokens))
    record["outputs"] = outputs
    free_engine(torch, *engines.values())
    return record


def flight_events(base, rid):
    status, _, text, _ = http_call(base, f"/debug/flight?request_id={rid}")
    if status != 200:
        raise SystemExit(f"{base}/debug/flight answered {status}")
    return json.loads(text)


def sse_text(text):
    """The completion text of an SSE body (its deltas concatenated)."""
    events = [ln[len("data: "):] for ln in text.split("\n")
              if ln.startswith("data: ")]
    if not events or events[-1] != "[DONE]":
        raise SystemExit("phase 19 (b): the stream did not end with [DONE]")
    return "".join(json.loads(e)["choices"][0]["text"] for e in events[:-1])


def hand_quantile(first, last, q):
    """The q-quantile of serve_ttft_seconds observed between two scrapes
    of each replica ({name: parsed families}): bucket deltas summed by
    hand, then the exposition's own quantile estimate."""
    from runbooks_tpu_torch.obs.metrics import ParsedHistogram

    out = None
    for name in last:
        h1 = first[name]["serve_ttft_seconds"].merged_histogram()
        h2 = last[name]["serve_ttft_seconds"].merged_histogram()
        delta = ParsedHistogram()
        delta.bounds = list(h2.bounds)
        delta.cumulative = [b - a for a, b in zip(h1.cumulative,
                                                   h2.cumulative)]
        delta.count = h2.count - h1.count
        delta.sum = h2.sum - h1.sum
        out = delta if out is None else out.merged(delta)
    return out.quantile(q), out.count


def gateway_phase(torch, seed, workdir):
    """Phase 19: the gateway in front of port replicas on llama3-8b bf16
    at full width cut to SERVE_LAYERS layers (the depth of phases 11-13
    and 18; one copy of the weights serves every replica). (a)
    route_policies: prefix-aware against random routing, in process. (b)
    Two ``create_server(kv_paging=True)`` replicas behind ``python -m
    runbooks_tpu_torch.serve.gateway``: a completions and chat mix
    (greedy ids and texts equal to the same bodies sent straight to the
    replica that answered, or differing first at a near-tie), a session
    held on its ring owner, one SSE stream (its deltas add up to the
    unstreamed text), one /v1/prefix broadcast (both replicas hold the
    prefix), the gateway-minted X-Request-Id in the gateway's and the
    replica's /debug/flight, the gateway's /metrics through the
    exposition lint, no kernel build on either replica under routed
    traffic, the proxy's latency over a direct call. (c) GATEWAY_SCRAPES
    scrapes of both replicas into a FleetHistory served by
    ``serve_metrics(0, history=...)``: the windowed TTFT p90 equals the
    quantile of the bucket deltas between the first and last scrape, and
    /metrics/history answers (the replicas share this process's registry,
    so their histograms are one; deployed replicas are processes of their
    own). (b') The session's owner drains (503: the
    next request fails over, gateway_retries_total{reason="draining"} 1),
    then stops (unreachable: the request is still served,
    {reason="unreachable"} 1). Returns K1's launches by part."""
    from runbooks_tpu_torch.obs.history import FleetHistory
    from runbooks_tpu_torch.obs.metrics import (
        parse_exposition,
        serve_metrics,
    )
    from runbooks_tpu_torch.ops.flash_attention import flash_attention
    from runbooks_tpu_torch.serve.api import _encode, create_server, load_model
    from runbooks_tpu_torch.serve.gateway import _HashRing
    from runbooks_tpu_torch.train.data import load_tokenizer

    t_phase = time.perf_counter()
    cfg, params = load_model({"model": "llama3-8b",
                              "model_overrides": {
                                  "param_dtype": "bfloat16",
                                  "num_layers": SERVE_LAYERS},
                              "seed": seed})
    launches = {}
    routing = route_policies(torch, cfg, params, seed)
    for policy, r in routing["policies"].items():
        launches[f"route_{policy}"] = r["flash_fwd_launches"]
    reused = {p: r["pages_reused_total"]
              for p, r in routing["policies"].items()}

    # (b) two replicas in this process behind the gateway process
    servers, threads, bases, submitted = {}, [], {}, {}
    for name in ("r0", "r1"):
        srv = create_server(cfg, params, host="127.0.0.1", port=0,
                            max_slots=8, max_seq_len=2048, warmup=True,
                            kv_paging=True)
        servers[name] = srv
        bases[name] = f"http://127.0.0.1:{srv.port}"
        t = threading.Thread(target=srv.serve_forever, daemon=True)
        t.start()
        threads.append(t)
        submit_many = srv.worker.submit_many

        def recording(reqs, _submit=submit_many):
            for r in reqs:
                submitted[r.request_id] = r
            return _submit(reqs)

        srv.worker.submit_many = recording
    # The owner's /metrics handler marks each scrape, so (b') can stop it
    # right after one, well inside the poller's 2 s interval.
    owner = _HashRing(sorted(servers)).owner(GATEWAY_SESSION)
    scraped = threading.Event()
    handler = servers[owner].httpd.RequestHandlerClass
    do_get = handler.do_GET

    def marking_get(self):
        if self.path.startswith("/metrics"):
            scraped.set()
        do_get(self)

    handler.do_GET = marking_get
    gw_content = f"{workdir}/gateway_content"
    os.makedirs(gw_content, exist_ok=True)
    gw_port = free_port()
    proc, gw, ready_s = start_entry_point(
        gw_content, gw_port, f"{workdir}/gateway.log", GATEWAY_READY_S,
        {"RBT_GATEWAY_TARGETS": ",".join(f"{n}={u}"
                                         for n, u in bases.items()),
         "RBT_GATEWAY_PORT": str(gw_port)},
        module="runbooks_tpu_torch.serve.gateway")
    history = FleetHistory()
    hist_httpd = None
    try:
        def unexpected_builds():
            return {n: parse_exposition(http_call(b, "/metrics")[2])[
                "xla_unexpected_compiles_total"].total()
                for n, b in bases.items()}

        builds0 = unexpected_builds()
        texts = [" ".join(["the gateway routes tenant", str(i)] * (8 + i))
                 for i in range(4)]
        mix = [("/v1/completions", {"prompt": texts[0]}, {}),
               ("/v1/chat/completions",
                {"messages": [{"role": "user", "content": texts[1]}]}, {}),
               ("/v1/completions", {"prompt": texts[2]},
                {"X-Session-Id": GATEWAY_SESSION}),
               ("/v1/completions", {"prompt": texts[3]},
                {"X-Session-Id": GATEWAY_SESSION})]
        flash_attention.launches = 0
        answers = []
        for i, (path, body, headers) in enumerate(mix):
            body = {**body, "max_tokens": GATEWAY_NEW, "temperature": 0}
            status, h, text, _ = http_call(gw, path, body, headers)
            if status != 200:
                raise SystemExit(f"phase 19 (b) {path}: {status} {text}")
            rid = h["X-Request-Id"]
            replica = h["X-Gateway-Replica"]
            direct = http_call(bases[replica], path, body,
                               {"X-Request-Id": f"direct-{i}"})
            answers.append((path, body, rid, replica, json.loads(text),
                            json.loads(direct[2]), f"direct-{i}"))
        for path, body, rid, replica, via, direct, drid in answers:
            a, b = submitted[rid], submitted[drid]
            if a.output_tokens != b.output_tokens:
                near_tie_check(torch, cfg, params,
                               f"phase 19 (b) {path} {rid}",
                               a.prompt_tokens, list(a.output_tokens),
                               list(b.output_tokens))
            elif via["choices"] != direct["choices"]:
                raise SystemExit(f"phase 19 (b): {via} != {direct}")
        session_replicas = [ans[3] for ans in answers[2:]]
        stream_body = {"prompt": texts[0], "max_tokens": GATEWAY_NEW,
                       "temperature": 0, "stream": True}
        status, h, text, t_first = http_call(gw, "/v1/completions",
                                             stream_body)
        streamed = sse_text(text) if status == 200 else None
        prefix_text = " ".join(["a shared deployment prompt"] * 8)
        status_p, _, text_p, _ = http_call(gw, "/v1/prefix",
                                           {"prompt": prefix_text})
        prefix_reply = json.loads(text_p)
        prefix_ids = _encode(load_tokenizer(None), prefix_text)
        held = {n: s.worker.engine.has_prefix(prefix_ids)
                for n, s in servers.items()}
        rid0 = answers[0][2]
        gw_events = flight_events(gw, rid0)
        rep_events = flight_events(bases[answers[0][3]], rid0)
        gw_metrics = http_call(gw, "/metrics")[2]
        lint = lint_exposition(gw_metrics)
        # The proxy's cost: the same 1-token body straight to the replica
        # that owns its session and through the gateway, interleaved.
        small = {"prompt": "ping", "max_tokens": 1, "temperature": 0}
        ping_owner = bases[_HashRing(sorted(servers)).owner("ping")]
        direct_s, via_s = [], []
        for _ in range(5):
            for target, out in ((ping_owner, direct_s), (gw, via_s)):
                t0 = time.perf_counter()
                http_call(target, "/v1/completions", small,
                          {"X-Session-Id": "ping"})
                out.append(time.perf_counter() - t0)

        # (c) history over five scrapes of both replicas, traffic between
        scrapes = []
        for k in range(GATEWAY_SCRAPES):
            if k:
                for i in range(2):
                    http_call(gw, "/v1/completions",
                              {"prompt": texts[i] + f" round {k}",
                               "max_tokens": 4, "temperature": 0})
            t_k = time.time()
            fams = {n: parse_exposition(http_call(b, "/metrics")[2])
                    for n, b in bases.items()}
            for n, f in fams.items():
                history.ingest(f, {"replica": n}, t_k, ("serve_", "xla_"))
            scrapes.append((t_k, fams))
        (t_a, first), (t_b, last) = scrapes[0], scrapes[-1]
        windowed = history.window_quantile("serve_ttft_seconds", 0.9,
                                           t_b - t_a, now=t_b)
        by_hand, window_count = hand_quantile(first, last, 0.9)
        hist_httpd = serve_metrics(0, history=history)
        hist_status, _, hist_text, _ = http_call(
            f"http://127.0.0.1:{hist_httpd.server_address[1]}",
            "/metrics/history?series=serve_requests_total")
        builds1 = unexpected_builds()
        launches["gateway_http"] = flash_attention.launches

        # (b') the owner drains, then stops
        servers[owner].worker.drain(timeout_s=10)
        status_d, h_d, _, _ = http_call(
            gw, "/v1/completions", {**small, "prompt": "drain"},
            {"X-Session-Id": GATEWAY_SESSION})
        drained_to = h_d.get("X-Gateway-Replica")
        scraped.clear()
        if not scraped.wait(10):
            raise SystemExit("phase 19 (b'): the gateway stopped scraping")
        t_stop = time.perf_counter()
        servers[owner].httpd.shutdown()
        servers[owner].httpd.server_close()
        status_u, h_u, _, _ = http_call(
            gw, "/v1/completions", {**small, "prompt": "gone"},
            {"X-Session-Id": GATEWAY_SESSION})
        stop_to_answer_s = time.perf_counter() - t_stop
        retries = parse_exposition(http_call(gw, "/metrics")[2])[
            "gateway_retries_total"]
    finally:
        proc.send_signal(signal.SIGTERM)
        try:
            gw_exit = proc.wait(timeout=30)
        except subprocess.TimeoutExpired:
            proc.kill()
            gw_exit = proc.wait()
        if hist_httpd is not None:
            hist_httpd.shutdown()
            hist_httpd.server_close()
        handler.do_GET = do_get
        for srv in servers.values():
            srv.shutdown()
        for t in threads:
            t.join(timeout=60)
    survivor = next(n for n in servers if n != owner)
    record = {
        "card": card_line(), "layers": SERVE_LAYERS,
        "routing": routing["policies"],
        "routing_warmup_s": routing["warmup_s"],
        "gateway_ready_s": ready_s,
        "session_owner": owner, "session_replicas": session_replicas,
        "stream_first_chunk_s": t_first,
        "prefix_broadcast": prefix_reply, "prefix_held": held,
        "flight_events": {"gateway": len(gw_events["events"]),
                          "replica": len(rep_events["events"])},
        "unexpected_builds": {"before": builds0, "after": builds1},
        "direct_ms_median": median(direct_s) * 1e3,
        "via_gateway_ms_median": median(via_s) * 1e3,
        "proxy_overhead_ms": (median(via_s) - median(direct_s)) * 1e3,
        "history": {"window_p90_s": windowed, "by_hand_p90_s": by_hand,
                    "window_count": window_count,
                    "series": history.stats()["series"],
                    "http_status": hist_status},
        "failover": {"draining_status": status_d, "draining_to": drained_to,
                     "unreachable_status": status_u,
                     "unreachable_to": h_u.get("X-Gateway-Replica"),
                     "stop_to_answer_s": stop_to_answer_s,
                     "retries": {dict(k).get("reason"): v
                                 for k, v in retries.samples.items()}},
        "gateway_exit": gw_exit,
        "flash_fwd_launches": launches,
        "seconds": time.perf_counter() - t_phase}
    gates = {
        "prefix_reuse_as_on_cpu":
            reused["prefix"] == ROUTE_REUSED["prefix"],
        "random_reuse_as_on_cpu":
            reused["random"] == ROUTE_REUSED["random"],
        "prefix_beats_random": reused["prefix"] > reused["random"],
        "session_on_owner": session_replicas == [owner, owner],
        "stream_equals_text": streamed == answers[0][4]["choices"][0][
            "text"],
        "prefix_on_both": (status_p == 200
                           and prefix_reply.get("replicas") == 2
                           and prefix_reply.get("cached_prefix_len", 0) > 0
                           and all(held.values())),
        "request_id_in_both_rings": (bool(gw_events["events"])
                                     and bool(rep_events["events"])
                                     and gw_events["component"] == "gateway"),
        "gateway_metrics_lint": not lint,
        "no_build_under_routed_traffic": builds0 == builds1,
        "history_window_equals_hand": (
            windowed is not None and window_count > 0
            and abs(windowed - by_hand) <= 1e-9 * max(1.0, by_hand)),
        "history_http": hist_status == 200
        and json.loads(hist_text)["series"][0]["name"]
        == "serve_requests_total",
        "draining_fails_over": (status_d == 200 and drained_to == survivor
                                and record["failover"]["retries"].get(
                                    "draining") == 1),
        "unreachable_fails_over": (
            status_u == 200 and h_u.get("X-Gateway-Replica") == survivor
            and record["failover"]["retries"].get("unreachable") == 1),
        "gateway_exit_0": gw_exit == 0,
        "k1_on_every_path": min(launches.values()) >= cfg.num_layers,
    }
    record["gates"] = gates
    print("phase 19 " + json.dumps(record), flush=True)
    if not all(gates.values()):
        with open(f"{workdir}/gateway.log") as f:
            print(f.read()[-3000:], flush=True)
        raise SystemExit(f"phase 19 gates failed: "
                         f"{[k for k, v in gates.items() if not v]} "
                         f"{lint[:5]}")
    del params
    gc.collect()
    torch.cuda.empty_cache()
    return launches


# ---------------------------------------------------------------------------
# Tensor-parallel serving: phase 20
# ---------------------------------------------------------------------------

TP_LAYERS = 8
TP_LENS = (20, 48, 90, 128, 200, 300, 400, 512)
TP_NEW = 16
TP_PREFIX = 256            # the paged run's registered shared prefix
TP_SEQ = 1024
# Last-position prefill logits of the two ranks against one process's,
# bf16 weights and activations: the all-reduce rounds each rank's partial
# sum to bf16 where one device rounds the whole product once. On an H100
# that gap read 0.04699 in every run, and the smallest planted fault
# (TP_FAULTS) 0.0834: the limit lies between them.
TP_LOGIT_GAP = 0.065
TP_RANK_TIMEOUT_S = 300
# Faults planted in rank 1's last layer for one prefill each, to show the
# gap gate catches them ({fault: (sublayer, leaves)}): its first two
# local kv heads swapped (wk, wv); its first q head swapped with the first
# of the next kv group (wq: a wrong q -> kv map); the first two
# head-wide column blocks of the MLP gate swapped, out of line with
# wi_up. (Two q heads of one kv group swapped move these random-weight
# logits by no more than the bf16 rounding: PERF.md.)
TP_FAULTS = {"kv_heads_swapped": ("attn", ("wk", "wv")),
             "q_heads_across_kv_groups": ("attn", ("wq",)),
             "mlp_gate_misaligned": ("mlp", ("wi_gate",))}


def tp_planted_logits(torch, cfg, engine, prompt, seq, rank):
    """{fault: last-position prefill logits} with each TP_FAULTS fault
    planted in rank 1's shard (every rank runs the forward; rank 1's
    weights are put back after each)."""
    d = cfg.head_dim
    layers = engine.params["layers"]
    n_rep = (layers["attn"]["wq"].shape[-1]
             // layers["attn"]["wk"].shape[-1])
    out = {}
    for fault, (group, names) in TP_FAULTS.items():
        j = n_rep if fault == "q_heads_across_kv_groups" else 1
        saved = {n: layers[group][n][-1].clone() for n in names}
        if rank == 1:
            for n in names:
                w = layers[group][n][-1]
                if w.shape[1] < (j + 1) * d:
                    raise SystemExit(f"phase 20: rank 1's {n} is too narrow "
                                     f"for the planted {fault}")
                first = w[:, :d].clone()
                w[:, :d] = w[:, j * d:(j + 1) * d]
                w[:, j * d:(j + 1) * d] = first
        out[fault] = prefill_logits(torch, cfg, engine.params, prompt,
                                    bucket_of(len(prompt)), seq,
                                    tp=engine.tp).float().cpu()
        for n in names:
            layers[group][n][-1].copy_(saved[n])
    return out


def tp_model_params(seed, layers=TP_LAYERS):
    return {"model": "llama3-8b",
            "model_overrides": {"param_dtype": "bfloat16",
                                "num_layers": layers},
            "seed": seed}


def tp_mixes(seed):
    """{"dense": prompts, "paged": prompts}: the 8-request mix, and the
    same lengths behind one shared TP_PREFIX-token prefix (which the
    paged run registers first)."""
    dense = seeded_prompts(seed + 20, TP_LENS)
    prefix = seeded_prompts(seed + 21, (TP_PREFIX,))[0]
    paged = [prefix + p[1:max(2, n - TP_PREFIX)]
             for p, n in zip(dense, TP_LENS)]
    return {"dense": dense, "paged": paged, "prefix": prefix}


def tp_engine(torch, cfg, params, kind, seed, seq, mesh=None):
    from runbooks_tpu_torch.serve.engine import InferenceEngine
    from runbooks_tpu_torch.serve.paging import PagedInferenceEngine

    kw = dict(max_slots=8, max_seq_len=seq, seed=seed, mesh=mesh)
    if kind == "paged":
        return PagedInferenceEngine(cfg, params, page_size=PAGE_SIZE, **kw)
    return InferenceEngine(cfg, params, **kw)


def tp_drive(torch, engine, kind, mixes, new=None):
    """Rank 0's (or one process's) run of one kind: the paged run
    registers the shared prefix first. (ids, K1 launches, wall seconds,
    generated tokens)."""
    from runbooks_tpu_torch.ops.flash_attention import flash_attention
    from runbooks_tpu_torch.serve.engine import Request

    new = new or TP_NEW
    reqs = [Request(prompt_tokens=list(p), max_tokens=new,
                    temperature=0.0) for p in mixes[kind]]
    flash_attention.launches = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with torch.no_grad():
        if kind == "paged":
            engine.register_prefix(mixes["prefix"])
        engine.generate(reqs)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    for r in reqs:
        if not (r.finished and len(r.output_tokens) == new):
            raise SystemExit(f"phase 20 {kind}: a request ended with "
                             f"{len(r.output_tokens)} tokens "
                             f"({r.finish_reason})")
    return ([list(r.output_tokens) for r in reqs], flash_attention.launches,
            wall, sum(len(r.output_tokens) for r in reqs))


def tp_rank(rank, world, store_path, out_path, seed, device_type, setup):
    """Phase 20 (a)'s rank body (a spawned process): join the gloo group,
    build the full llama3-8b params from the seed on this rank's device,
    keep its shard (the engines' ``mesh=``), then per kind (dense, paged)
    drive (rank 0) or replay (the others); its K1 launches, parameter
    bytes against the plan's, one forward's collectives, the prefill
    logits of the longest prompt, peak memory. ``setup``: the parent's
    {"params", "mixes", "seq", "new"}. The result is pickled to out_path (an
    exception's traceback instead, on failure)."""
    import pickle
    import traceback

    import torch

    result = {"ok": False}
    try:
        import torch.distributed as dist

        from runbooks_tpu_torch.models.transformer import init_params
        from runbooks_tpu_torch.ops.flash_attention import flash_attention
        from runbooks_tpu_torch.parallel import distributed
        from runbooks_tpu_torch.parallel.mesh import MeshConfig, make_mesh
        from runbooks_tpu_torch.serve.api import load_model
        from runbooks_tpu_torch.utils.tree import tree_leaves

        dev = torch.device("cuda", 0) if device_type == "cuda" \
            else torch.device("cpu")
        distributed.initialize(TP_RANK_TIMEOUT_S, backend="gloo", rank=rank,
                               world_size=world, device=dev,
                               store=dist.FileStore(store_path, world))
        mesh = make_mesh(MeshConfig(fsdp=1, tensor=world),
                         device_type=device_type)
        if dev.type == "cuda":
            torch.cuda.reset_peak_memory_stats()
        # Only this rank's shard is drawn (one full leaf at a time).
        cfg, params = load_model(setup["params"], device=dev,
                                 shard=(world, rank))
        if dev.type == "cuda":
            result["load_peak_gb"] = torch.cuda.max_memory_allocated() / 1e9
        shapes = init_params(cfg, None, torch.device("meta"))
        mixes, seq = setup["mixes"], setup["seq"]
        for kind in ("dense", "paged"):
            engine = tp_engine(torch, cfg, params, kind, seed, seq, mesh)
            tp = engine.tp
            if kind == "dense":
                result["local_bytes"] = sum(
                    t.numel() * t.element_size()
                    for t in tree_leaves(engine.params))
                result["plan_bytes"] = tp.plan.local_param_bytes(shapes,
                                                                 rank)
                result["plan"] = tp.plan.describe()
                result["local_heads"] = (
                    engine.params["layers"]["attn"]["wq"].shape[-1]
                    // cfg.head_dim,
                    engine.params["layers"]["attn"]["wk"].shape[-1]
                    // cfg.head_dim)
                result["local_mlp"] = \
                    engine.params["layers"]["mlp"]["wo"].shape[1]
                result["local_vocab"] = engine.params["embed"].shape[0]
                counts0 = dict(tp.counts)
                with torch.no_grad():
                    prompt = mixes["dense"][-1]
                    result["logits"] = prefill_logits(
                        torch, cfg, engine.params, prompt,
                        bucket_of(len(prompt)), seq, tp=tp).float().cpu()
                result["collectives_per_forward"] = {
                    k: tp.counts[k] - counts0[k] for k in tp.counts}
                with torch.no_grad():
                    result["planted"] = tp_planted_logits(
                        torch, cfg, engine, prompt, seq, rank)
            if rank == 0:
                try:
                    ids, launches, wall, tokens = tp_drive(
                        torch, engine, kind, mixes, setup["new"])
                finally:
                    engine.stop_followers()
                result[kind] = {"ids": ids, "launches": launches,
                                "wall_s": wall, "tokens": tokens}
            else:
                flash_attention.launches = 0
                engine.serve_follower()
                result[kind] = {"launches": flash_attention.launches}
            result[kind]["collectives"] = dict(tp.counts)
            engine.cache = None
            del engine
            gc.collect()
            if dev.type == "cuda":
                torch.cuda.empty_cache()
        if dev.type == "cuda":
            result["peak_gb"] = torch.cuda.max_memory_allocated() / 1e9
        result["ok"] = True
        distributed.shutdown()
    except BaseException:  # noqa: BLE001 - reported to the parent
        result["error"] = traceback.format_exc()
    with open(out_path, "wb") as f:
        pickle.dump(result, f)


def bucket_of(n):
    from runbooks_tpu_torch.serve.engine import _buckets, bucket_for

    return bucket_for(_buckets(2048), n)


def spawn_ranks(target, world, workdir, name, timeout_s, *args):
    """``target(rank, world, store, out, *args)`` on ``world`` spawned
    processes, each joined with a time limit of its own and killed past
    it; their pickled results."""
    return start_ranks(target, world, workdir, name, timeout_s, *args)()


def start_ranks(target, world, workdir, name, timeout_s, *args):
    """``spawn_ranks``' processes, started: returns the call that joins
    them (their time limit counts from now) and returns their results."""
    import multiprocessing as mp

    ctx = mp.get_context("spawn")
    stem = re.sub(r"\W+", "_", name)
    store = f"{workdir}/{stem}_store"
    outs = [f"{workdir}/{stem}_rank{r}.pkl" for r in range(world)]
    procs = [ctx.Process(target=target,
                         args=(r, world, store, outs[r], *args), daemon=True)
             for r in range(world)]
    for p in procs:
        p.start()
    deadline = time.perf_counter() + timeout_s
    return lambda: join_ranks(procs, outs, deadline, name, timeout_s)


def join_ranks(procs, outs, deadline, name, timeout_s):
    import pickle

    for p in procs:
        p.join(max(0.0, deadline - time.perf_counter()))
    late = [r for r, p in enumerate(procs) if p.is_alive()]
    for p in procs:
        if p.is_alive():
            p.kill()
            p.join(10)
    if late:
        raise SystemExit(f"{name}: ranks {late} still running after "
                         f"{timeout_s} s")
    results = []
    for r, path in enumerate(outs):
        if not os.path.exists(path):
            raise SystemExit(f"{name}: rank {r} exited {procs[r].exitcode} "
                             "with no result")
        with open(path, "rb") as f:
            res = pickle.load(f)
        if not res["ok"]:
            raise SystemExit(f"{name}: rank {r} failed:\n{res['error']}")
        results.append(res)
    return results


def tp_two_ranks(torch, seed, workdir, setup, device_type="cuda"):
    """Phase 20 (a): tp_rank on two spawned processes."""
    return spawn_ranks(tp_rank, 2, workdir, "phase 20 (a)",
                       TP_RANK_TIMEOUT_S, seed, device_type, setup)


def tp_nccl_collectives(torch, cfg, group, dev):
    """The NCCL calls of the sharded serving path at world 1, on CUDA
    tensors of one forward's shapes: TensorParallel's all-reduce,
    vocabulary gather, the MoE combine (f64, over the serving group) and
    broadcast, and the engine's program-call exchange
    (broadcast_object_list with device=). {name: returned its input
    exactly}."""
    import numpy as np

    from runbooks_tpu_torch.parallel.sharding import (
        TensorParallel,
        serve_plan,
    )
    from runbooks_tpu_torch.serve.engine import InferenceEngine

    tp = TensorParallel(serve_plan(cfg, 1, 1), 0, group, group)
    g = torch.Generator(device=dev).manual_seed(7)
    hidden = torch.randn((8, 1, cfg.hidden_size), generator=g, device=dev,
                         dtype=torch.bfloat16)
    partial = torch.randn((8, cfg.hidden_size), generator=g, device=dev,
                          dtype=torch.float64)
    logits = torch.randn((8, 1, cfg.vocab_size), generator=g, device=dev)
    ids = torch.randint(0, cfg.vocab_size, (8,), generator=g, device=dev)
    msg = ("decode", (np.arange(24, dtype=np.int32).reshape(8, 3), 5),
           {"gmask": None})
    # The engine's exchange on a stand-in holding what it reads.
    holder = type("Holder", (), {})()
    holder.device, holder.tp = dev, tp
    got = InferenceEngine._exchange(holder, msg)
    return {
        "all_reduce": torch.equal(tp.all_reduce(hidden.clone()), hidden),
        "combine_f64": torch.equal(tp.combine(partial.clone()), partial),
        "gather_vocab": torch.equal(tp.gather_vocab(logits), logits),
        "broadcast": torch.equal(tp.broadcast(ids.clone()), ids),
        "exchange": (got[0] == msg[0] and got[2] == msg[2]
                     and np.array_equal(got[1][0], msg[1][0])
                     and got[1][1] == msg[1][1]),
        "counts": dict(tp.counts),
        "group_counts": {k: dict(v) for k, v in tp.group_counts.items()}}


def tp_nccl_rank(store_path, out_path, seed):
    """Phase 20 (b)'s one-process NCCL group: the collectives of the
    tensor-parallel path (tp_nccl_collectives), then the engine under
    ``mesh_tensor`` 1 against the unsharded one on the same weights
    (llama3-8b at full width cut to ENTRY_LAYERS), ids exact."""
    import pickle
    import traceback

    import torch

    result = {"ok": False}
    try:
        import torch.distributed as dist

        from runbooks_tpu_torch.parallel import distributed
        from runbooks_tpu_torch.parallel.mesh import MeshConfig, make_mesh
        from runbooks_tpu_torch.serve.api import load_model

        dev = torch.device("cuda", 0)
        distributed.initialize(TP_RANK_TIMEOUT_S, backend="nccl", rank=0,
                               world_size=1, device=dev,
                               store=dist.FileStore(store_path, 1))
        mesh = make_mesh(MeshConfig(fsdp=1, tensor=1))
        cfg, params = load_model(tp_model_params(seed, ENTRY_LAYERS),
                                 device=dev)
        result["collectives"] = tp_nccl_collectives(
            torch, cfg, mesh.get_group("tensor"), dev)
        mixes = tp_mixes(seed)
        meshed = tp_engine(torch, cfg, params, "dense", seed, TP_SEQ, mesh)
        ids_mesh, launches_mesh, _, _ = tp_drive(torch, meshed, "dense",
                                                 mixes)
        del meshed
        plain = tp_engine(torch, cfg, params, "dense", seed, TP_SEQ)
        ids_plain, launches_plain, _, _ = tp_drive(torch, plain, "dense",
                                                   mixes)
        result.update(ok=True, backend=dist.get_backend(),
                      world=dist.get_world_size(),
                      equal=ids_mesh == ids_plain,
                      launches=(launches_mesh, launches_plain))
        distributed.shutdown()
    except BaseException:  # noqa: BLE001 - reported to the parent
        result["error"] = traceback.format_exc()
    with open(out_path, "wb") as f:
        pickle.dump(result, f)


def tp_nccl_phase(torch, seed, workdir):
    """Phase 20 (b): the NCCL group at world 1 (a spawned process), then
    ``main`` under mesh_tensor 2: over HTTP where two GPUs exist, else its
    refusal naming the device count."""
    import multiprocessing as mp
    import pickle

    out = f"{workdir}/tp_nccl.pkl"
    p = mp.get_context("spawn").Process(
        target=tp_nccl_rank, args=(f"{workdir}/tp_nccl_store", out, seed),
        daemon=True)
    p.start()
    p.join(TP_RANK_TIMEOUT_S)
    if p.is_alive():
        p.kill()
        raise SystemExit("phase 20 (b): the NCCL process did not finish")
    with open(out, "rb") as f:
        res = pickle.load(f)
    if not res["ok"]:
        raise SystemExit(f"phase 20 (b): NCCL world 1 failed:\n"
                         f"{res['error']}")
    record = {"nccl_world1": {k: res[k] for k in (
        "backend", "world", "collectives", "equal", "launches")}}
    content = f"{workdir}/tp_content"
    os.makedirs(content, exist_ok=True)
    port = free_port()
    with open(f"{content}/params.json", "w") as f:
        json.dump(dict(tp_model_params(seed, ENTRY_LAYERS), mesh_tensor=2,
                       port=port, max_slots=4, max_seq_len=256), f)
    n = torch.cuda.device_count()
    log = f"{workdir}/tp_main.log"
    if n >= 2:
        proc, base, ready_s = start_entry_point(content, port, log,
                                                HTTP_TIMEOUT)
        status, body = http_call(base, "/v1/completions", {
            "prompt": "tensor parallel", "max_tokens": 8,
            "temperature": 0.0})
        proc.send_signal(signal.SIGTERM)
        code = proc.wait(ENTRY_DRAIN_S + 60)
        record["main_mesh_tensor_2"] = {
            "ran": True, "ready_s": ready_s, "status": status,
            "completion_tokens": body["usage"]["completion_tokens"],
            "exit": code}
        ok = status == 200 and code == 0
    else:
        root = os.path.dirname(os.path.abspath(__file__))
        done = subprocess.run(
            [sys.executable, "-m", "runbooks_tpu_torch.serve.api"],
            cwd=root, capture_output=True, text=True, timeout=300,
            env=dict(os.environ, RBT_CONTENT_DIR=content))
        named = f"torch.cuda.device_count() is {n}" in done.stderr
        print(f"phase 20 (b): main with mesh_tensor 2 over HTTP not run: "
              f"this machine has {n} GPU", flush=True)
        record["main_mesh_tensor_2"] = {
            "ran": False, "devices": n, "exit": done.returncode,
            "names_device_count": named}
        ok = done.returncode != 0 and named
    coll = res["collectives"]
    record["gates"] = {"nccl_world1_collectives": res["backend"] == "nccl"
                       and all(coll[k] for k in ("all_reduce", "gather_vocab",
                                                 "broadcast", "exchange")),
                       "nccl_world1_engine_equal": res["equal"],
                       "main_mesh_tensor_2": ok}
    return record


def tp_phase(torch, seed, workdir):
    """Phase 20 (see the module docstring). Returns K1's launches by path
    (each rank's dense and paged runs)."""
    from runbooks_tpu_torch.serve.api import load_model

    t_phase = time.perf_counter()
    mixes = tp_mixes(seed)
    setup = {"params": tp_model_params(seed), "mixes": mixes,
             "seq": TP_SEQ, "new": TP_NEW}
    ranks = tp_two_ranks(torch, seed, workdir, setup)
    t_ranks = time.perf_counter() - t_phase
    gc.collect()
    torch.cuda.empty_cache()
    # The single-process engine on the same weights, this process.
    cfg, params = load_model(setup["params"])
    single = {}
    prompt = mixes["dense"][-1]
    with torch.no_grad():
        plain_logits = prefill_logits(torch, cfg, params, prompt,
                                      bucket_of(len(prompt)),
                                      TP_SEQ).float().cpu()
    for kind in ("dense", "paged"):
        engine = tp_engine(torch, cfg, params, kind, seed, TP_SEQ)
        ids, launches, wall, tokens = tp_drive(torch, engine, kind, mixes)
        single[kind] = {"ids": ids, "launches": launches, "wall_s": wall,
                        "tokens": tokens}
        free_engine(torch, engine)
    gates = {}
    for kind in ("dense", "paged"):
        got, want = ranks[0][kind]["ids"], single[kind]["ids"]
        for i, (a, b) in enumerate(zip(got, want)):
            near_tie_check(torch, cfg, params, f"phase 20 {kind} request {i}",
                           mixes[kind][i], a, b)
        gates[f"{kind}_ids_equal_or_near_tie"] = True
        gates[f"{kind}_k1_launches_per_rank"] = all(
            r[kind]["launches"] == single[kind]["launches"] > 0
            for r in ranks)
    gaps = [float((r["logits"] - plain_logits).abs().max()) for r in ranks]
    gates["logits_within_gap"] = max(gaps) <= TP_LOGIT_GAP
    planted = {f: min(float((r["planted"][f] - plain_logits).abs().max())
                      for r in ranks) for f in TP_FAULTS}
    gates["planted_faults_outside_gap"] = min(planted.values()) > TP_LOGIT_GAP
    gates["param_bytes_equal_plan"] = all(
        r["local_bytes"] == r["plan_bytes"] for r in ranks)
    gates["local_widths"] = all(
        r["local_heads"] == (cfg.num_heads // 2, cfg.num_kv_heads // 2)
        and r["local_mlp"] == cfg.intermediate_size // 2
        and r["local_vocab"] == cfg.vocab_size // 2 for r in ranks)
    free_engine(torch)
    del params
    gc.collect()
    torch.cuda.empty_cache()
    nccl = tp_nccl_phase(torch, seed, workdir)
    gates.update(nccl.pop("gates"))
    label = "gloo over host memory on one card, not a TP speed"
    record = {
        "card": card_line(), "layers": cfg.num_layers,
        "plan": ranks[0]["plan"],
        "local": {"q_heads": ranks[0]["local_heads"][0],
                  "kv_heads": ranks[0]["local_heads"][1],
                  "mlp": ranks[0]["local_mlp"],
                  "vocab": ranks[0]["local_vocab"]},
        "param_bytes_per_rank": [r["local_bytes"] for r in ranks],
        "peak_gb_per_rank": [r.get("peak_gb") for r in ranks],
        "load_peak_gb_per_rank": [r.get("load_peak_gb") for r in ranks],
        "collectives_per_forward": ranks[0]["collectives_per_forward"],
        "logit_gap_per_rank": gaps, "logit_gap_limit": TP_LOGIT_GAP,
        "planted_fault_gaps": planted,
        "k1_launches": {kind: {"single": single[kind]["launches"],
                               "ranks": [r[kind]["launches"]
                                         for r in ranks]}
                        for kind in ("dense", "paged")},
        "tokens_per_s": {
            kind: {label: ranks[0][kind]["tokens"]
                   / ranks[0][kind]["wall_s"],
                   "one_process_same_card": single[kind]["tokens"]
                   / single[kind]["wall_s"]}
            for kind in ("dense", "paged")},
        "ranks_s": t_ranks, **nccl,
        "seconds": time.perf_counter() - t_phase, "gates": gates}
    print("phase 20 " + json.dumps(record), flush=True)
    failed = [k for k, v in gates.items() if not v]
    if failed:
        raise SystemExit(f"phase 20: gates failed: {failed}")
    return {f"tp_{kind}_rank{r}": ranks[r][kind]["launches"]
            for kind in ("dense", "paged") for r in range(2)}


# ---------------------------------------------------------------------------
# FSDP / data-parallel training: phase 21
# ---------------------------------------------------------------------------

# Two ranks sharing one card over gloo stage every gather through host
# memory: at 8 layers a step took 83 s on an H100's host (PERF.md), so
# phase 21 runs falcon-7b at full width cut to FSDP_LAYERS.
FSDP_LAYERS = 2
# The two ranks take FSDP_STEPS steps and stop there on rank 0's SIGTERM;
# one process takes FSDP_STEPS + 1.
FSDP_STEPS = 2
# From the ranks' start (they run while phase 20 does) to their join.
FSDP_RANK_TIMEOUT_S = 400
# Each step's loss and global gradient norm, each rank against one
# process (f32 base, bf16 activations; the ranks sum their partial
# gradients and losses in another order): relative.
FSDP_LOSS_RTOL = 1e-4
# The example's lr with no warmup (the example's 100 warmup steps give lr
# 0 at step 1), so that every step after the first reads updated LoRA
# factors.
FSDP_LR = 2e-5


def fsdp_job(seed, data_path, artifacts, steps, checkpoint_every):
    """examples/falcon-7b-instruct/finetuned-model.yaml's job (LoRA rank
    16, alpha 32, global batch 8 in 4 microbatches, seq 2048, lr 2e-5, f32
    base) on falcon-7b at full width cut to FSDP_LAYERS, with no
    warmup."""
    from runbooks_tpu_torch.train.lora import LoraConfig
    from runbooks_tpu_torch.train.optimizer import OptimizerConfig
    from runbooks_tpu_torch.train.trainer import TrainJobConfig

    return TrainJobConfig(
        model="falcon-7b", model_overrides={"num_layers": FSDP_LAYERS},
        lora=LoraConfig(rank=16, alpha=32.0),
        optimizer=OptimizerConfig(learning_rate=FSDP_LR, warmup_steps=0),
        batch_size=8,
        seq_len=TRAIN_SEQ, accumulate_steps=4, steps=steps,
        checkpoint_every=checkpoint_every, data_path=data_path,
        artifacts_dir=artifacts, log_every=1, seed=seed)


def reset_flash_counts():
    from runbooks_tpu_torch.ops.flash_attention import (
        flash_attention,
        flash_attention_bwd,
    )

    flash_attention.launches = 0
    flash_attention_bwd.dq_launches = 0
    flash_attention_bwd.dkv_launches = 0


def flash_counts():
    from runbooks_tpu_torch.ops.flash_attention import (
        flash_attention,
        flash_attention_bwd,
    )

    return {"flash_fwd": flash_attention.launches,
            "flash_bwd_dq": flash_attention_bwd.dq_launches,
            "flash_bwd_dkv": flash_attention_bwd.dkv_launches}


def fsdp_rank(rank, world, store_path, out_path, setup):
    """Phase 21 (a)'s rank body (a spawned process): join the gloo group
    on this card, then ``run_training`` on the fsdp mesh; rank 0 sends
    itself SIGTERM at the top of step FSDP_STEPS + 1 (RBT_FAULT_INJECT in
    its environment alone). The summary, K1-K3 launches and the exit code
    are pickled to out_path (a traceback instead, on failure)."""
    import pickle
    import traceback

    import torch

    result = {"ok": False}
    try:
        import torch.distributed as dist

        from runbooks_tpu_torch.parallel import distributed
        from runbooks_tpu_torch.parallel.mesh import MeshConfig, make_mesh
        from runbooks_tpu_torch.train.trainer import (
            exit_code_for,
            run_training,
        )

        dev = torch.device("cuda", 0)
        distributed.initialize(FSDP_RANK_TIMEOUT_S, backend="gloo",
                               rank=rank, world_size=world, device=dev,
                               store=dist.FileStore(store_path, world))
        mesh = make_mesh(MeshConfig(fsdp=world), device_type="cuda")
        if rank == 0:
            os.environ["RBT_FAULT_INJECT"] = f"sigterm:{FSDP_STEPS}"
        torch.cuda.reset_peak_memory_stats()
        reset_flash_counts()
        t0 = time.perf_counter()
        summary = run_training(fsdp_job(**setup), device=dev, mesh=mesh)
        result.update(ok=True, summary=summary, launches=flash_counts(),
                      wall_s=time.perf_counter() - t0,
                      exit=exit_code_for(summary))
        distributed.shutdown()
    except BaseException:  # noqa: BLE001 - reported to the parent
        result["error"] = traceback.format_exc()
    with open(out_path, "wb") as f:
        pickle.dump(result, f)


def fsdp_nccl_check(torch, workdir):
    """Phase 21 (b): the FSDP runtime's collectives (parallel/sharding.
    Fsdp: the gather, the reduce-scatter, the all-reduce and the stop
    broadcast) over NCCL at world 1 in this process, on CUDA tensors,
    each returning its input. ({check: passed}, backend)."""
    import torch.distributed as dist

    from runbooks_tpu_torch.parallel import distributed
    from runbooks_tpu_torch.parallel.mesh import MeshConfig, make_mesh
    from runbooks_tpu_torch.parallel.sharding import Fsdp, FsdpPlan

    dev = torch.device("cuda", 0)
    distributed.initialize(FSDP_RANK_TIMEOUT_S, backend="nccl", rank=0,
                           world_size=1, device=dev,
                           store=dist.FileStore(f"{workdir}/fsdp_nccl", 1))
    try:
        mesh = make_mesh(MeshConfig(fsdp=1))
        plan = FsdpPlan(mesh=dataclasses.asdict(MeshConfig(fsdp=1)),
                        params={"w": 1})
        fsdp = Fsdp(plan, 0, mesh, dev)
        g = torch.Generator(device=dev).manual_seed(5)
        x = torch.randn((64, 4544), generator=g, device=dev)
        checks = {
            "all_gather": torch.equal(fsdp._all_gather(x, 1), x),
            "reduce_scatter": torch.equal(fsdp._reduce_scatter(x, 1), x),
            "all_reduce": torch.equal(fsdp.all_reduce(x.clone()), x),
            "broadcast_stop": fsdp.broadcast_stop("sigterm") == "sigterm"}
        return checks, dist.get_backend()
    finally:
        distributed.shutdown()


def fsdp_main_check(torch, workdir):
    """Phase 21 (b): ``python -m runbooks_tpu_torch.train.trainer`` under
    mesh_fsdp 2 over NCCL, where two GPUs exist (exit 0, both ranks'
    codes 0); with one, it must exit 1 naming the device count."""
    content = f"{workdir}/fsdp_content"
    os.makedirs(content, exist_ok=True)
    with open(f"{content}/params.json", "w") as f:
        json.dump({"model": "falcon-7b",
                   "model_overrides": {"num_layers": ENTRY_LAYERS},
                   "lora": {"rank": 16, "alpha": 32.0}, "batch_size": 2,
                   "seq_len": 512, "steps": 2, "log_every": 1,
                   "mesh_fsdp": 2, "maintenance_poll_s": 0}, f)
    n = torch.cuda.device_count()
    root = os.path.dirname(os.path.abspath(__file__))
    done = subprocess.run(
        [sys.executable, "-m", "runbooks_tpu_torch.train.trainer"],
        cwd=root, capture_output=True, text=True, timeout=600,
        env=dict(os.environ, RBT_CONTENT_DIR=content))
    if n >= 2:
        last = [json.loads(x) for x in done.stdout.splitlines()
                if x.startswith('{"done"')]
        ok = (done.returncode == 0 and bool(last)
              and last[-1]["rank_exit_codes"] == [0, 0])
        return {"ran": True, "devices": n, "exit": done.returncode,
                "rank_exit_codes": last[-1]["rank_exit_codes"] if last
                else None}, ok
    named = f"torch.cuda.device_count() is {n}" in done.stderr
    print(f"phase 21 (b): main with mesh_fsdp 2 over NCCL not run: this "
          f"machine has {n} GPU", flush=True)
    return {"ran": False, "devices": n, "exit": done.returncode,
            "names_device_count": named}, done.returncode == 1 and named


def fsdp_start(seed, data_path, workdir):
    """Phase 21 (a)'s two ranks, started (they run while phase 20 does:
    their step times are no FSDP speed in any case): the call that joins
    them, and when they started."""
    setup = {"seed": seed, "data_path": data_path,
             "artifacts": f"{workdir}/fsdp_ranks", "steps": FSDP_STEPS + 1,
             "checkpoint_every": 1000}
    return start_ranks(fsdp_rank, 2, workdir, "phase 21 (a)",
                       FSDP_RANK_TIMEOUT_S, setup), time.perf_counter()


def fsdp_phase(torch, seed, data_path, workdir, started):
    """Phase 21 (see the module docstring), over the ranks of
    ``fsdp_start`` (``started``). Returns each kernel's launches by path
    (each rank's run, and the one process's)."""
    from runbooks_tpu_torch.train.checkpoint import CheckpointManager
    from runbooks_tpu_torch.train.trainer import run_training
    from runbooks_tpu_torch.utils.tree import tree_leaves

    t_phase = time.perf_counter()
    ranks_art = f"{workdir}/fsdp_ranks"
    join, t_start = started
    ranks = join()
    t_ranks = time.perf_counter() - t_start
    intact = CheckpointManager(ranks_art).intact_steps()
    gc.collect()
    torch.cuda.empty_cache()
    # One process on the same seed and global batch, one step further.
    one_art = f"{workdir}/fsdp_one"
    reset_flash_counts()
    torch.cuda.reset_peak_memory_stats()
    one = run_training(fsdp_job(seed, data_path, one_art, FSDP_STEPS + 1,
                                FSDP_STEPS))
    one_launches = flash_counts()
    one_peak = torch.cuda.max_memory_allocated()
    # The two ranks' (emergency) checkpoint, resumed in one process.
    resumed = run_training(fsdp_job(seed, data_path, ranks_art,
                                    FSDP_STEPS + 1, 1000))

    def lora_at(art, step):
        state, _, _ = CheckpointManager(art).restore_with_cursor(
            step=step, device=torch.device("cpu"))
        return list(tree_leaves(state["params"]))

    lora_gap = max(float((a - b).abs().max()) for a, b in zip(
        lora_at(ranks_art, FSDP_STEPS), lora_at(one_art, FSDP_STEPS),
        strict=True))
    gc.collect()
    torch.cuda.empty_cache()
    nccl, backend = fsdp_nccl_check(torch, workdir)
    main_record, main_ok = fsdp_main_check(torch, workdir)

    want = [e["loss"] for e in one["history"]]
    want_norm = [e["grad_norm"] for e in one["history"]]

    def close(a, b):
        return abs(a - b) <= FSDP_LOSS_RTOL * abs(b)

    gates = {}
    gates["losses_within_rtol"] = all(
        len(r["summary"]["history"]) == FSDP_STEPS and all(
            close(e["loss"], w)
            for e, w in zip(r["summary"]["history"], want))
        for r in ranks)
    # The global gradient norm: each rank's sum of its LoRA factors'
    # reduce-scattered pieces (the backward's gloo all-reduce on CUDA
    # tensors) against one process's whole gradients, step by step.
    gates["grad_norms_within_rtol"] = all(
        len(r["summary"]["history"]) == FSDP_STEPS and all(
            close(e["grad_norm"], w)
            for e, w in zip(r["summary"]["history"], want_norm))
        for r in ranks)
    gates["lora_within_2_lr_steps"] = lora_gap <= 2 * FSDP_LR * FSDP_STEPS
    # Per step, each rank launches what one process launches.
    gates["k1_k2_k3_launches_per_rank"] = all(
        r["launches"][k] * (FSDP_STEPS + 1) == one_launches[k] * FSDP_STEPS
        and one_launches[k] > 0 for r in ranks for k in one_launches)
    gates["param_bytes_equal_plan"] = all(
        r["summary"]["mesh"]["param_bytes"]["held"]
        == r["summary"]["mesh"]["param_bytes"]["plan"] for r in ranks)
    gates["sigterm_stops_both_at_one_step_exit_42"] = all(
        r["exit"] == 42 and r["summary"]["exit_reason"] == "sigterm"
        and r["summary"]["batches_consumed"] == FSDP_STEPS
        for r in ranks) and intact == [FSDP_STEPS]
    gates["two_rank_checkpoint_resumes_in_one_process"] = (
        resumed["restored_step"] == FSDP_STEPS
        and close(resumed["history"][-1]["loss"], want[FSDP_STEPS])
        and close(resumed["history"][-1]["grad_norm"],
                  want_norm[FSDP_STEPS]))
    gates["nccl_world1_collectives"] = (backend == "nccl"
                                        and all(nccl.values()))
    gates["main_mesh_fsdp_2"] = main_ok
    label = "gloo over host memory on one card: not an FSDP speed"
    record = {
        "card": card_line(), "layers": FSDP_LAYERS,
        "plan": ranks[0]["summary"]["mesh"]["plan"],
        "param_bytes_per_rank": [r["summary"]["mesh"]["param_bytes"]
                                 for r in ranks],
        "collectives_per_rank": [r["summary"]["mesh"]["collectives"]
                                 for r in ranks],
        "losses": {"one_process": want,
                   "ranks": [[e["loss"] for e in r["summary"]["history"]]
                             for r in ranks],
                   "resumed_from_ranks": resumed["history"][-1]["loss"]},
        "grad_norms": {
            "one_process": want_norm,
            "ranks": [[e["grad_norm"] for e in r["summary"]["history"]]
                      for r in ranks],
            "resumed_from_ranks": resumed["history"][-1]["grad_norm"]},
        "max_rel_gap": {
            key: max(abs(e[key] - w) / abs(w) for r in ranks
                     for e, w in zip(r["summary"]["history"], ref))
            for key, ref in (("loss", want), ("grad_norm", want_norm))},
        "lora_max_abs_gap": lora_gap,
        "lora_gap_limit": 2 * FSDP_LR * FSDP_STEPS,
        "launches": {"one_process": one_launches,
                     "steps_one_process": FSDP_STEPS + 1,
                     "ranks": [r["launches"] for r in ranks],
                     "steps_ranks": FSDP_STEPS},
        label: {"peak_gb_per_rank": [r["summary"]["peak_memory_bytes"] / 1e9
                                     for r in ranks],
                "step_s_per_rank": [[e["step_s"]
                                     for e in r["summary"]["history"]]
                                    for r in ranks]},
        "one_process_same_card": {
            "peak_gb": one_peak / 1e9,
            "step_s": [e["step_s"] for e in one["history"]]},
        "ranks_s_from_start": t_ranks,
        "ranks_wall_s": [r["wall_s"] for r in ranks], "nccl_world1": nccl,
        "main_mesh_fsdp_2": main_record,
        "seconds": time.perf_counter() - t_phase, "gates": gates}
    print("phase 21 " + json.dumps(record), flush=True)
    failed = [k for k, v in gates.items() if not v]
    if failed:
        raise SystemExit(f"phase 21: gates failed: {failed}")
    return {k: {"fsdp_rank0": ranks[0]["launches"][k],
                "fsdp_rank1": ranks[1]["launches"][k],
                "fsdp_one_process": one_launches[k]}
            for k in one_launches}


# ---------------------------------------------------------------------------
# Gemma serving: phase 22
# ---------------------------------------------------------------------------

# (b) gemma-7b at full width cut to this depth (28 layers until phase 23
# came in; its checks do not depend on the depth, and gemma-2b serves at
# its full 18 layers in (c)).
GEMMA7B_SERVE_LAYERS = 8
# (c) gemma-2b over HTTP: greedy completions of prompts of these lengths,
# GEMMA_HTTP_NEW new tokens each (the first one also streamed).
GEMMA_HTTP_LENS = (300, 1000)
GEMMA_HTTP_NEW = 24


def gemma_fwd_layouts(torch, dev):
    """K1's phase-22 cases at head_dim 256 (fwd_case_layouts' tuple):
    gemma-7b's serving burst (16 query heads on 16 kv heads) and gemma-2b's
    (8 on 1): an 8-row 128 bucket, rows 0-1 real (90 and 120 tokens), the
    rest padding at position 2048 over a 2049-slot cache; gemma-7b's
    suffix prefill, 8 rows of 128 tokens after a PREFIX_LEN-token prefix;
    and 2 x 2048 causal at 16/16 with the block skip."""

    def ar(n, rows, start=0):
        return (start + torch.arange(n, device=dev, dtype=torch.int32)
                )[None].expand(rows, n).contiguous()

    sk, s = 2049, 2048
    pos = torch.full((8, 128), 2048, device=dev, dtype=torch.int32)
    pos[0, :90] = ar(90, 1)[0]
    pos[1, :120] = ar(120, 1)[0]
    return [
        ("gemma7b_rows8_sq128", (8, 128, sk, 16, 16, 256), pos, ar(sk, 8),
         None, None, False, pos < 2048),
        ("gemma2b_rows8_sq128", (8, 128, sk, 8, 1, 256), pos, ar(sk, 8),
         None, None, False, pos < 2048),
        ("gemma7b_rows8_sq128_at1024", (8, 128, sk, 16, 16, 256),
         ar(128, 8, PREFIX_LEN), ar(sk, 8), None, None, False, None),
        ("b_gemma7b_causal_2x2048", (2, s, s, 16, 16, 256), ar(s, 2),
         ar(s, 2), None, None, True, None),
    ]


def gemma_bwd_layouts(torch, dev, batch):
    """K2/K3's phase-22 cases at head_dim 256 (bwd_case_layouts' tuple):
    the training microbatch, 2 x 2048 with the block skip, packed (a:
    positions and segment ids of 2 rows of the job's data) and causal (b),
    at gemma-7b's 16/16 and gemma-2b's 8/1. K3 splits the head_dim across
    two blocks per kv tile: gemma-2b's grid is (1, 2, 32 x 2) = 128
    blocks, each walking 8 query heads."""
    s = TRAIN_SEQ
    pos = torch.from_numpy(batch["positions"][:2]).to(dev)
    seg = torch.from_numpy(batch["segment_ids"][:2]).to(dev)
    ar = torch.arange(s, device=dev, dtype=torch.int32)[None].expand(
        2, s).contiguous()
    return [
        ("a_gemma7b_packed_2x2048", (2, s, s, 16, 16, 256), pos, pos, seg,
         True, None),
        ("b_gemma7b_causal_2x2048", (2, s, s, 16, 16, 256), ar, ar, None,
         True, None),
        ("a_gemma2b_packed_2x2048", (2, s, s, 8, 1, 256), pos, pos, seg,
         True, None),
        ("b_gemma2b_causal_2x2048", (2, s, s, 8, 1, 256), ar, ar, None,
         True, None),
    ]


def gemma_fine_tune(torch, dev, seed, batch, data_path, workdir):
    """Phase 22 (c)'s fine-tune: the LoRA gradient check of gemma-2b at
    full width cut to GRAD_LAYERS (flash K1-K3 against the plain attention
    under autograd, phase 6's gates), then family_train's job on gemma-2b
    at full size (18 layers, f32 base, tied head). Returns (record,
    launches of the job's first run)."""
    t0 = time.perf_counter()
    grads = grad_check_phase(torch, dev, seed + 22, batch, model="gemma-2b")
    gc.collect()
    torch.cuda.empty_cache()
    train, launches = family_train(torch, dev, seed, data_path, workdir,
                                   "gemma-2b")
    gc.collect()
    torch.cuda.empty_cache()
    return {"grad_check": grads, "train": train,
            "seconds": time.perf_counter() - t0}, launches


def gemma_phase(torch, dev, seed, batch, data_path, workdir):
    """Phase 22: gemma serving and fine-tuning. Returns (K1 launches by
    path, K1's records at gemma's shapes, its largest error there, K2/K3's
    records and largest errors at gemma's shapes, the fine-tune's K1-K3
    launches)."""
    t_phase = time.perf_counter()
    t0 = time.perf_counter()
    fwd, worst = kernel_phase(torch, dev, seed + 22, None,
                              layouts=gemma_fwd_layouts(torch, dev),
                              gqa=True)
    bwd, bwd_worst = bwd_kernel_phase(
        torch, dev, seed + 22, batch,
        layouts=gemma_bwd_layouts(torch, dev, batch))
    kernels_s = time.perf_counter() - t0
    gc.collect()
    torch.cuda.empty_cache()
    # (c)'s server starts and answers while (b) and (d) run here.
    server = Background(family_server, *family_server_setup(
        torch, dev, seed, workdir, "gemma-2b", GEMMA_HTTP_LENS,
        {n: GEMMA_HTTP_NEW for n in GEMMA_HTTP_LENS}), True)
    serve, serve_launches = family_serve(torch, seed, "gemma-7b",
                                         GEMMA7B_SERVE_LAYERS)
    imported, import_launches = family_import(
        torch, dev, seed, workdir, ("gemma-7b",), "gemma-7b")
    gc.collect()
    torch.cuda.empty_cache()
    http, http_launches = server.result()
    # The fine-tune runs alone on the card: its step times are its own.
    fine_tune, train_launches = gemma_fine_tune(torch, dev, seed, batch,
                                                data_path, workdir)
    launches = {**serve_launches, "gemma_import": import_launches,
                "gemma_http": http_launches,
                "gemma_train": train_launches["flash_fwd"]}
    print("phase 22 " + json.dumps({
        "card": card_line(), "kernels_s": kernels_s,
        "flash_fwd_launches": launches,
        "flash_bwd_launches": {k: train_launches[k] for k in (
            "flash_bwd_dq", "flash_bwd_dkv")},
        "serve": serve, "fine_tune": fine_tune, "import": imported,
        "http": http,
        "seconds": time.perf_counter() - t_phase}), flush=True)
    return launches, fwd, worst, bwd, bwd_worst, train_launches


def gemma_bwd_rows(records, worst, train_launches):
    """The kernels line's rows of K2 and K3 at head_dim 256 (gemma):
    the gemma-2b fine-tune's launches (phase 22 (c)), the times of its
    packed microbatch (phase 22 (a)), every d=256 case beside them."""
    main = records["a_gemma2b_packed_2x2048"]
    rows = []
    for name, line in (("flash_bwd_dq", 280), ("flash_bwd_dkv", 337)):
        bound_ms, bound_by, _ = main["bounds"][name]
        rows.append({
            "name": f"{name}_d256",
            "route": "cuda",
            "source": "runbooks_tpu_torch/csrc/flash_bwd.cu",
            "replaces": f"runbooks_tpu/ops/flash_attention.py:{line}",
            "launches": train_launches[name],
            "launches_by_path": {"gemma_train": train_launches[name]},
            "max_abs_err": worst[name],
            "ms": main["ms"][name],
            "plain_ms": main["plain_ms"],
            "plain_ms_covers": "flash_attention_bwd_reference: dq, dk, dv",
            "bound_ms": bound_ms,
            "bound_by": bound_by,
            "library_ms": main["library_masked_ms"],
            "library_ms_covers": ("masked backward of "
                                  "scaled_dot_product_attention "
                                  "(enable_gqa): dq, dk, dv together"),
            "shape": main["shape"],
            "card_tiles_computed_open": main["card_tiles"][name],
            "shapes": {
                case: {"ms": r["ms"][name], "plain_ms": r["plain_ms"],
                       "bound_ms": r["bounds"][name][0],
                       "bound_by": r["bounds"][name][1],
                       "tflops": r["bounds"][name][2] / r["ms"][name],
                       "library_ms": r["library_masked_ms"],
                       "library_causal_ms": r["library_ms"],
                       "card_tiles_computed_open": r["card_tiles"][name],
                       "shape": r["shape"]}
                for case, r in records.items()},
        })
    return rows


# ---------------------------------------------------------------------------
# Mixtral serving: phase 23
# ---------------------------------------------------------------------------

# (b) mixtral-8x7b at full width cut to this depth: 11.87 B parameters,
# 23.7 GB in bf16 (one layer is 1.451 B; all 32 do not fit one card).
MIXTRAL_SERVE_LAYERS = 8
# (a) one full-width MoE layer at the serving burst (an 8-row 128 bucket)
# and the decode step (8 slots, one token each).
MOE_LAYER_SHAPES = (("burst", 8, 128), ("decode", 8, 1))
# moe_block against moe_block_dense on the card: |err| <= MOE_LAYER_RTOL x
# max |plain output|, one bf16 ulp (both round the same f32 and f64 sums
# to bf16, so they are expected bit-equal; the record says whether).
MOE_LAYER_RTOL = 2.0 ** -8
# (d) the profiled decode forward: 8 rows after this many cached tokens.
MOE_SHARE_CTX = 1024


def moe_layer_bound(torch, cfg, r, n_tokens):
    """(bound_ms, bound_by, flops) of one MoE layer on an H100 for this
    routing: the bytes it must move (the router, every expert that
    receives a kept assignment, the tokens in and out, bf16) and the
    operations this data needs (the router's product, and the three
    expert products of each kept assignment)."""
    from runbooks_tpu_torch.utils.hw import H100_HBM_BW, H100_PEAK_BF16_FLOPS

    h, m, E = cfg.hidden_size, cfg.intermediate_size, cfg.moe_num_experts
    kept = int(r.keep.sum().item())
    hit = int(torch.unique(r.expert[r.keep]).numel())
    nbytes = 2 * (h * E + hit * 3 * h * m + 2 * n_tokens * h)
    flops = 2 * n_tokens * h * E + kept * 3 * 2 * h * m
    t_ops = flops / H100_PEAK_BF16_FLOPS
    t_bytes = nbytes / H100_HBM_BW
    return (max(t_ops, t_bytes) * 1e3,
            "operations" if t_ops >= t_bytes else "bytes", flops)


def moe_layer_phase(torch, dev, seed):
    """Phase 23 (a): one full-width mixtral layer's MoE FFN in bf16 from
    the seed, moe_block against moe_block_dense (the reference's one-hot
    formulation) at MOE_LAYER_SHAPES: the same kept assignments in the
    same slots, outputs within MOE_LAYER_RTOL, each version's time (CUDA
    events over warm calls), the layer's bound for this routing, and the
    share of assignments kept."""
    from runbooks_tpu_torch.models import moe
    from runbooks_tpu_torch.models.config import get_config

    cfg = get_config("mixtral-8x7b", param_dtype="bfloat16")
    E, h, m = cfg.moe_num_experts, cfg.hidden_size, cfg.intermediate_size
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed + 23)

    def normal(shape, fan_in):
        return (torch.randn(shape, generator=gen, device=dev,
                            dtype=torch.bfloat16) * fan_in ** -0.5)

    p = {"router": normal((h, E), h), "wi_gate": normal((E, h, m), h),
         "wi_up": normal((E, h, m), h), "wo": normal((E, m, h), m)}
    out = {}
    with torch.no_grad():
        for name, b, s in MOE_LAYER_SHAPES:
            x = torch.randn((b, s, h), generator=gen, device=dev,
                            dtype=torch.bfloat16)
            T = b * s
            probs = moe.router_probs(p, x.reshape(T, h))
            r = moe.route(cfg, probs)
            dispatch, _, _ = moe.dispatch_combine_dense(cfg, probs)
            same_routing = torch.equal(moe.routing_dispatch(r, T, E),
                                       dispatch)
            got, aux = moe.moe_block(cfg, p, x)
            want, want_aux = moe.moe_block_dense(cfg, p, x)
            err = (got.float() - want.float()).abs().max().item()
            scale = want.float().abs().max().item()
            iters = 20 if s == 1 else 10
            bound_ms, bound_by, flops = moe_layer_bound(torch, cfg, r, T)
            ms = cuda_ms(lambda: moe.moe_block(cfg, p, x), iters)
            out[name] = {
                "tokens": T, "capacity": r.capacity,
                "kept": int(r.keep.sum().item()),
                "assignments": int(r.keep.numel()),
                "experts_hit": int(torch.unique(r.expert[r.keep]).numel()),
                "same_routing": same_routing,
                "bit_equal": torch.equal(got, want),
                "max_abs_err": err, "max_abs_plain": scale,
                "aux_equal": float(aux) == float(want_aux),
                "ms": ms,
                "plain_ms": cuda_ms(lambda: moe.moe_block_dense(cfg, p, x),
                                    iters),
                "bound_ms": bound_ms, "bound_by": bound_by,
                "tflops": flops / ms / 1e9, "library_ms": None}
            print(f"moe layer {name} (T {T}, C {r.capacity}): "
                  f"{json.dumps(out[name])}", flush=True)
            if not same_routing or err > MOE_LAYER_RTOL * scale:
                raise SystemExit(f"phase 23 (a): moe_block disagrees with "
                                 f"moe_block_dense at {name}: {out[name]}")
    del p
    gc.collect()
    torch.cuda.empty_cache()
    return out


def moe_device_share(torch, cfg, params, seed):
    """Phase 23 (d): one decode forward (8 rows after MOE_SHARE_CTX cached
    tokens, the cache's 2048-slot view) under torch.profiler with each
    moe_block call in a range: the device time of the forward's kernels,
    the MoE layers' part of it, and the forward's time between CUDA
    events over warm calls."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile, record_function

    from runbooks_tpu_torch.models import transformer
    from runbooks_tpu_torch.models.transformer import KVCache, forward

    dev = params["embed"].device
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed + 230)
    rows, ctx = 8, MOE_SHARE_CTX
    tokens = torch.randint(0, cfg.vocab_size, (rows, ctx + 1), generator=gen,
                           device=dev)
    pos = torch.arange(ctx + 1, device=dev, dtype=torch.int32)[None].expand(
        rows, ctx + 1)
    cache = KVCache.create(cfg, rows, 2048, dev, trash_slot=True)
    block = transformer.moe_block

    def ranged(*args):
        with record_function("moe_block"):
            return block(*args)

    def step():
        return forward(cfg, params, tokens[:, ctx:], positions=pos[:, ctx:],
                       cache=cache, cache_view=2048)

    with torch.no_grad():
        forward(cfg, params, tokens[:, :ctx], positions=pos[:, :ctx],
                cache=cache, return_activations=True)
        forward_ms = cuda_ms(step, 10)
        transformer.moe_block = ranged
        try:
            with profile(activities=[ProfilerActivity.CPU,
                                     ProfilerActivity.CUDA]) as prof:
                step()
                torch.cuda.synchronize()
        finally:
            transformer.moe_block = block
    events = prof.key_averages()
    kernels = [e for e in events if e.device_type == DeviceType.CUDA
               and e.key != "moe_block"]
    busy_ms = sum(e.self_device_time_total for e in kernels) / 1e3
    moe_ms = sum(e.device_time_total for e in events
                 if e.key == "moe_block"
                 and e.device_type == DeviceType.CPU) / 1e3
    calls = sum(e.count for e in events if e.key == "moe_block"
                and e.device_type == DeviceType.CPU)
    del cache
    return {"rows": rows, "cached_tokens": ctx, "moe_calls": calls,
            "kernels": sum(e.count for e in kernels),
            "device_busy_ms": busy_ms, "moe_device_ms": moe_ms,
            "moe_share": moe_ms / busy_ms if busy_ms else None,
            "forward_ms": forward_ms}


def count_routing(records):
    """Wrap models.moe.route and moe.dispatch_combine_dense (the one-hot
    formulation's routing, whose dispatch equals route's on the same
    probabilities) to append each dispatch's (capacity factor, tokens,
    expert, keep) to ``records`` (device tensors: no sync); returns the
    restore function."""
    from runbooks_tpu_torch.models import moe

    route, dense = moe.route, moe.dispatch_combine_dense

    def counting(cfg, probs):
        r = route(cfg, probs)
        records.append((cfg.moe_capacity_factor, probs.shape[0], r.expert,
                        r.keep))
        return r

    def counting_dense(cfg, probs):
        counting(cfg, probs.detach())
        return dense(cfg, probs)

    moe.route, moe.dispatch_combine_dense = counting, counting_dense

    def restore():
        moe.route, moe.dispatch_combine_dense = route, dense

    return restore


def routing_summary(records):
    """Kept share of the recorded dispatches' assignments by capacity
    factor and kind (decode: one token per slot; prefill: the rest)."""
    out = {}
    for cf, T, _, keep in records:
        kind = "decode" if T <= 8 else "prefill"
        row = out.setdefault(f"cf{cf}", {}).setdefault(
            kind, {"dispatches": 0, "kept": 0, "assignments": 0})
        row["dispatches"] += 1
        row["kept"] += int(keep.sum().item())
        row["assignments"] += keep.numel()
    for by_kind in out.values():
        for row in by_kind.values():
            row["kept_share"] = row["kept"] / row["assignments"]
    return out


def mixtral_phase(torch, dev, seed, workdir):
    """Phase 23: mixtral serving. (a) the MoE layer alone; (b)
    mixtral-8x7b served at full width over MIXTRAL_SERVE_LAYERS layers
    (family_serve) with (d), the MoE share of a decode forward, on its
    weights; (c) a 1-layer full-width HF directory through the loader
    (family_import), whose loader process runs while (a) and (b) do:
    their times share the host with it. Returns (K1 launches by path,
    (a)'s records)."""
    t_phase = time.perf_counter()
    # (c)'s loader runs beside (a) and (b): it only waits on a process.
    started = family_import_start(torch, dev, seed, workdir,
                                  ("mixtral-8x7b",))
    layer = moe_layer_phase(torch, dev, seed)
    mark("phase 23 (a)")
    records = []
    restore = count_routing(records)
    share = {}
    try:
        serve, serve_launches = family_serve(
            torch, seed, "mixtral-8x7b", MIXTRAL_SERVE_LAYERS,
            after=lambda cfg, params: share.update(moe_device_share(
                torch, cfg, params, seed)))
    finally:
        restore()
    routing = routing_summary(records)
    mark("phase 23 (b)")
    imported, import_launches = family_import(
        torch, dev, seed, workdir, ("mixtral-8x7b",), "mixtral-8x7b",
        started)
    launches = {**serve_launches, "mixtral_import": import_launches}
    print("phase 23 " + json.dumps({
        "card": card_line(), "moe_layer": layer, "serve": serve,
        "routing": routing, "moe_device_share": share, "import": imported,
        "flash_fwd_launches": launches,
        "seconds": time.perf_counter() - t_phase}), flush=True)
    return launches, layer


# ---------------------------------------------------------------------------
# Mixtral's fine-tune: phase 24
# ---------------------------------------------------------------------------

# (a) the LoRA gradient check at full width cut to this depth (remat on);
# the full-parameter gradient (router and experts too) runs at 1 layer
# without remat.
MIXTRAL_GRAD_LAYERS = 2
# (b) run_training at full width cut to this depth: a layer is 1.451 B
# parameters and embedding plus head 0.262 B, so the f32 base is 24.3 GB
# at 4 layers and 47.5 GB at 8 (peak 29.7 GB at 4 layers on an H100; the
# phase took 22 s there, so 8 fit the card and the script's time).
MIXTRAL_TRAIN_LAYERS = 8
MIXTRAL_TRAIN_STEPS = 3
# The objective recomputed by hand (each microbatch's CE and aux, no
# gradient) against the step's logged loss: the same sums in f32.
MIXTRAL_OBJECTIVE_RTOL = 1e-5


def named_leaves(tree, prefix=""):
    """{dotted path: leaf} of a nested dict of tensors."""
    out = {}
    for k, v in tree.items():
        path = f"{prefix}{k}"
        if isinstance(v, dict):
            out.update(named_leaves(v, path + "."))
        else:
            out[path] = v
    return out


def routing_gap(a, b):
    """(assignments, kept in a, kept in b, assignments whose expert or
    keep differ) of two runs' dispatches (count_routing's records)."""
    total = sum(k.numel() for *_, k in a)
    kept_a = sum(int(k.sum().item()) for *_, k in a)
    kept_b = sum(int(k.sum().item()) for *_, k in b)
    differ = sum(int(((ea != eb) | (ka != kb)).sum().item())
                 for (*_, ea, ka), (*_, eb, kb) in zip(a, b))
    return total, kept_a, kept_b, differ


def with_moe_block(block, fn, *args):
    """``fn(*args)`` with the forward's MoE FFN set to ``block``."""
    from runbooks_tpu_torch.models import transformer

    saved = transformer.moe_block
    transformer.moe_block = block
    try:
        return fn(*args)
    finally:
        transformer.moe_block = saved


# Phase 24 (a)'s three ways of computing one gradient: (name, attention,
# MoE FFN). "kernels" against "plain" is the port's path against the plain
# versions of both; "kernels" against "dense_moe" holds moe_block's
# backward alone to the one-hot formulation's under the same attention,
# so the same routing.
MIXTRAL_GRAD_WAYS = (("kernels", "flash", "moe_block"),
                     ("plain", "xla", "moe_block_dense"),
                     ("dense_moe", "flash", "moe_block_dense"))


def grad_ways(torch, fn):
    """{way: (loss, {name: grad}, recorded routing)} of ``fn(cfg
    replacement)`` -> (loss, {name: grad}) under each of
    MIXTRAL_GRAD_WAYS."""
    from runbooks_tpu_torch.models import moe

    out = {}
    for name, impl, block in MIXTRAL_GRAD_WAYS:
        calls = []
        restore = count_routing(calls)
        try:
            loss, grads = with_moe_block(getattr(moe, block), fn, impl)
        finally:
            restore()
        out[name] = (loss, grads, calls)
    torch.cuda.synchronize()
    return out


def grad_way_gaps(torch, ways, other):
    """Phase 6's numbers for "kernels" against ``other``: loss relative
    gap, worst leaf relative L2 and cosine, the routing."""
    (loss_a, g_a, calls_a), (loss_b, g_b, calls_b) = ways["kernels"], \
        ways[other]
    l2, cos, worst = grad_gaps(torch, g_a, g_b)
    total, kept_a, kept_b, differ = routing_gap(calls_a, calls_b)
    return {"loss_kernels": loss_a, f"loss_{other}": loss_b,
            "loss_rel": abs(loss_a - loss_b) / abs(loss_b),
            "worst_rel_l2": l2, "worst_leaf": worst, "worst_cosine": cos,
            "assignments": total, "kept_share_kernels": kept_a / total,
            f"kept_share_{other}": kept_b / total,
            "assignments_routed_differently": differ}


def mixtral_grad_check(torch, dev, seed, batch):
    """Phase 24 (a): mixtral-8x7b at full width, one packed 2048-token
    row, the MoE objective (CE + moe_aux_coef x aux). LoRA (rank 16 on
    the attention, remat) over MIXTRAL_GRAD_LAYERS, then the
    full-parameter gradient (router and experts too) at 1 layer without
    remat, each computed MIXTRAL_GRAD_WAYS' three ways: K1-K3 with
    moe_block against the plain attention with moe_block_dense (the
    reference's one-hot formulation) under autograd, and against K1-K3
    with moe_block_dense; every pair held to phase 6's gates. The kept
    share of assignments and the assignments two ways route differently
    (the attentions' roundings move near-ties) are reported."""
    from runbooks_tpu_torch.models.config import get_config
    from runbooks_tpu_torch.models.transformer import init_params
    from runbooks_tpu_torch.train.lora import LoraConfig, init_lora
    from runbooks_tpu_torch.train.step import (
        make_ce_terms,
        moe_aux_coef,
        trainable_copy,
    )

    t0 = time.perf_counter()
    torch.cuda.reset_peak_memory_stats()
    row = {k: torch.from_numpy(v[:1]).to(dev) for k, v in batch.items()}
    cfg = get_config("mixtral-8x7b", num_layers=MIXTRAL_GRAD_LAYERS)
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed + 24)
    base = init_params(cfg, gen, dev)
    lora_cfg = LoraConfig(rank=16, alpha=32.0)
    lora = init_lora(base, lora_cfg, gen)
    for ab in lora.values():
        ab["b"] = torch.randn(ab["b"].shape, generator=gen, device=dev) \
            * 0.02

    def lora_way(impl):
        loss, grads = lora_grads(
            torch, dataclasses.replace(cfg, attention_impl=impl), base,
            lora, lora_cfg, row)
        return loss, dict(enumerate(grads))

    ways = grad_ways(torch, lora_way)
    record = {"lora": {"layers": MIXTRAL_GRAD_LAYERS,
                       "leaves": len(ways["kernels"][1]),
                       **{other: grad_way_gaps(torch, ways, other)
                          for other in ("plain", "dense_moe")}}}
    del base, lora, ways
    gc.collect()
    torch.cuda.empty_cache()

    cfg1 = get_config("mixtral-8x7b", num_layers=1)
    params = init_params(cfg1, gen, dev)

    def full_way(impl):
        leaves = trainable_copy(params)
        ce = make_ce_terms(dataclasses.replace(cfg1, attention_impl=impl),
                           remat=False, loss_chunk=0)
        loss, _, aux = ce(leaves, row)
        loss = loss + moe_aux_coef(cfg1) * aux
        named = named_leaves(leaves)
        return loss.item(), dict(zip(named, torch.autograd.grad(
            loss, list(named.values()))))

    ways = grad_ways(torch, full_way)
    g_a, g_b = ways["kernels"][1], ways["plain"][1]
    record["full"] = {
        "layers": 1, "leaves": len(g_a),
        **{other: grad_way_gaps(torch, ways, other)
           for other in ("plain", "dense_moe")},
        "moe_rel_l2_plain": {
            n: ((g_a[n].float() - g_b[n].float()).norm()
                / g_b[n].float().norm()).item()
            for n in g_b if n.startswith("layers.moe.")}}
    del params, ways, g_a, g_b
    gc.collect()
    torch.cuda.empty_cache()
    record.update(seconds=time.perf_counter() - t0,
                  peak_gb=torch.cuda.max_memory_allocated() / 1e9)
    print("phase 24 (a) " + json.dumps(record), flush=True)
    pairs = [record[g][o] for g in ("lora", "full")
             for o in ("plain", "dense_moe")]
    if not all(r["loss_rel"] <= GRAD_LOSS_RTOL
               and r["worst_rel_l2"] <= GRAD_REL_L2_TOL
               and r["worst_cosine"] >= GRAD_COS_MIN for r in pairs):
        raise SystemExit("phase 24 (a): mixtral's gradients with K1-K3 and "
                         "moe_block disagree with the plain versions")
    return record


def moe_device_split(torch, prof):
    """(device busy ms, MoE device ms, summed kernel ms) of a profiled
    training step whose moe_block calls ran in "moe_block" ranges. Busy
    is the union of the kernels' intervals (equal to their sum unless
    two overlap). Each kernel belongs to the op
    that launched it; it is the MoE's when the nearest enclosing
    "moe_block" range or autograd backward node on the way up is a
    moe_block range (its forward, or remat's recompute inside a backward
    node) or a backward node created by an op inside such a range
    (matched by autograd sequence number)."""
    from torch.autograd import DeviceType

    events = prof.events()
    ranges = [e for e in events if e.name == "moe_block"
              and e.device_type == DeviceType.CPU]
    seqs = set()
    for r in ranges:
        lo, hi = r.time_range.start, r.time_range.end
        for e in events:
            if (e.thread == r.thread and e.sequence_nr >= 0
                    and e.device_type == DeviceType.CPU
                    and not e.name.startswith("autograd::engine")
                    and lo <= e.time_range.start
                    and e.time_range.end <= hi):
                seqs.add(e.sequence_nr)

    def moe_owned(e):
        while e is not None:
            if e.name == "moe_block":
                return True
            if e.name.startswith("autograd::engine::evaluate_function"):
                return e.sequence_nr in seqs
            e = e.cpu_parent
        return False

    moe_us = sum(k.duration for e in events
                 if e.device_type == DeviceType.CPU and moe_owned(e)
                 for k in e.kernels)
    # The device timeline also holds the "moe_block" ranges themselves
    # (user annotations spanning their kernels): only kernels, copies and
    # sets count.
    spans = sorted((e.time_range.start, e.time_range.end) for e in events
                   if e.device_type == DeviceType.CUDA
                   and e.name != "moe_block")
    busy_us = summed_us = 0.0
    end = None
    for lo, hi in spans:
        summed_us += hi - lo
        if end is None or lo > end:
            busy_us += hi - lo
            end = hi
        elif hi > end:
            busy_us += hi - end
            end = hi
    return busy_us / 1e3, moe_us / 1e3, summed_us / 1e3


def mixtral_traced_step(torch, dev, seed, data_path, cfg, lora_cfg,
                        opt_cfg):
    """One LoRA step of the fine-tune (after a warm one) on a seeded base
    under torch.profiler, each moe_block call in a range: the step's
    wall time, the device's idle share, K1-K3's device time and the MoE's
    share (moe_device_split). Before it, the objective by hand on the
    traced step's batch (each microbatch's CE x its weight / the
    batch's, plus moe_aux_coef x its aux / 4, from make_ce_terms without
    gradient) against the step's logged loss."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile, record_function

    from runbooks_tpu_torch.models import transformer
    from runbooks_tpu_torch.models.transformer import init_params
    from runbooks_tpu_torch.train import data
    from runbooks_tpu_torch.train.lora import (
        create_lora_train_state,
        deltas,
        make_lora_train_step,
    )
    from runbooks_tpu_torch.train.optimizer import make_optimizer
    from runbooks_tpu_torch.train.step import make_ce_terms, moe_aux_coef

    k = 4
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)
    base = init_params(cfg, gen, dev)
    optimizer = make_optimizer(opt_cfg)
    state = create_lora_train_state(lora_cfg, base, optimizer, gen)
    step_fn = make_lora_train_step(cfg, lora_cfg, optimizer,
                                   accumulate_steps=k)
    batches = data.dataset(data_path, TRAIN_SEQ, 8, epochs=None)

    def next_batch():
        return {n: torch.from_numpy(v).to(dev)
                for n, v in next(batches).items()}

    state, _ = step_fn(state, base, next_batch())
    torch.cuda.synchronize()
    b = next_batch()
    ce = make_ce_terms(cfg, remat=False, loss_chunk=0)
    total_w = b["loss_mask"].float().sum().clamp(min=1.0)
    m = b["tokens"].shape[0] // k
    ce_part = aux_part = 0.0
    with torch.no_grad():
        for i in range(k):
            micro = {n: v[i * m:(i + 1) * m] for n, v in b.items()}
            loss, total, aux = ce(base, micro, deltas(state.params,
                                                      lora_cfg))
            ce_part += (loss * total / total_w).item()
            aux_part += moe_aux_coef(cfg) * aux.item() / k
    block = transformer.moe_block

    def ranged(*args):
        with record_function("moe_block"):
            return block(*args)

    def traced_step():
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            out = step_fn(state, base, b)
            torch.cuda.synchronize()
            seconds = time.perf_counter() - t0
        return prof, out, seconds

    prof, (state, metrics), traced_s = with_moe_block(ranged, traced_step)
    busy_ms, moe_ms, summed_ms = moe_device_split(torch, prof)
    groups = {"flash_fwd_kernel": 0.0, "flash_bwd_dq_kernel": 0.0,
              "flash_bwd_dkv_kernel": 0.0}
    for e in prof.key_averages():
        if e.device_type == DeviceType.CUDA:
            for g in groups:
                if g in e.key:
                    groups[g] += e.self_device_time_total / 1e3
    logged = metrics["loss"].item()
    objective = ce_part + aux_part
    del state, base
    gc.collect()
    torch.cuda.empty_cache()
    return {"traced_step_s": traced_s, "device_busy_ms": busy_ms,
            "kernel_ms_summed": summed_ms,
            "idle_share": 1 - busy_ms / 1e3 / traced_s,
            "moe_device_ms": moe_ms,
            "moe_share": moe_ms / busy_ms if busy_ms else None,
            "k1_ms": groups["flash_fwd_kernel"],
            "k2_ms": groups["flash_bwd_dq_kernel"],
            "k3_ms": groups["flash_bwd_dkv_kernel"],
            "logged_loss": logged, "loss_ce": ce_part,
            "aux_term": aux_part, "loss_by_hand": objective,
            "objective_rel": abs(objective - logged) / abs(logged)}


def mixtral_fine_tune(torch, dev, seed, data_path, workdir):
    """Phase 24 (b): phase 7's job (LoRA rank 16, alpha 32 on the
    attention; batch 8 in 4 microbatches of 2 x 2048; lr 2e-5) on an f32
    mixtral-8x7b base at full width cut to MIXTRAL_TRAIN_LAYERS through
    run_training: MIXTRAL_TRAIN_STEPS steps with K1-K3's launches read
    around them and the kept share of the MoE's assignments, a resume from
    the last checkpoint to one step more, then one traced step
    (mixtral_traced_step). Returns (record, launches of the first run)."""
    from runbooks_tpu_torch.models.config import get_config
    from runbooks_tpu_torch.ops.flash_attention import (
        flash_attention,
        flash_attention_bwd,
    )
    from runbooks_tpu_torch.train.checkpoint import CheckpointManager
    from runbooks_tpu_torch.train.lora import LoraConfig
    from runbooks_tpu_torch.train.optimizer import OptimizerConfig
    from runbooks_tpu_torch.train.trainer import TrainJobConfig, run_training

    t0 = time.perf_counter()
    steps, model = MIXTRAL_TRAIN_STEPS, "mixtral-8x7b"
    overrides = {"num_layers": MIXTRAL_TRAIN_LAYERS}
    cfg = get_config(model, **overrides)
    art = f"{workdir}/{model}_artifacts"
    lora_cfg = LoraConfig(rank=16, alpha=32.0)
    opt_cfg = OptimizerConfig(learning_rate=2e-5)
    job = TrainJobConfig(
        model=model, model_overrides=overrides, lora=lora_cfg,
        optimizer=opt_cfg, batch_size=8, seq_len=TRAIN_SEQ,
        accumulate_steps=4, steps=steps, data_path=data_path,
        artifacts_dir=art, log_every=1, seed=seed)
    records = []
    restore = count_routing(records)
    torch.cuda.reset_peak_memory_stats()
    flash_attention.launches = 0
    flash_attention_bwd.dq_launches = 0
    flash_attention_bwd.dkv_launches = 0
    try:
        t_run = time.perf_counter()
        summary = run_training(job)
        wall = time.perf_counter() - t_run
    finally:
        launches = {"flash_fwd": flash_attention.launches,
                    "flash_bwd_dq": flash_attention_bwd.dq_launches,
                    "flash_bwd_dkv": flash_attention_bwd.dkv_launches}
        restore()
    peak = torch.cuda.max_memory_allocated()
    # Each microbatch's dispatch, once in the forward and once in remat's
    # recompute.
    routing = {"dispatches": len(records),
               "kept_share": sum(int(k.sum().item()) for *_, k in records)
               / sum(k.numel() for *_, k in records)}
    hist = summary["history"]
    losses = [e["loss"] for e in hist]
    # Each layer of each of the 4 microbatches: K1 twice (the forward
    # and the remat's recompute), K2 and K3 once.
    n = cfg.num_layers * 4
    per_step = {"flash_fwd": 2 * n, "flash_bwd_dq": n, "flash_bwd_dkv": n}
    for name, want in per_step.items():
        if launches[name] != want * steps:
            raise SystemExit(f"phase 24 (b): {name} launched "
                             f"{launches[name]} times in {steps} steps, "
                             f"not {want * steps}")
    if len(losses) != steps or not all(math.isfinite(x) for x in losses):
        raise SystemExit(f"phase 24 (b): losses {losses}")
    gc.collect()
    torch.cuda.empty_cache()
    resumed = run_training(dataclasses.replace(job, steps=steps + 1))
    cursor = CheckpointManager(art).read_cursor(steps)
    r_losses = [e["loss"] for e in resumed["history"]]
    if (resumed["restored_step"] != steps
            or cursor.get("batches_consumed") != steps
            or resumed["batches_consumed"] != steps + 1
            or [e["step"] for e in resumed["history"]] != [steps + 1]
            or not all(math.isfinite(x) for x in r_losses)):
        raise SystemExit("phase 24 (b): the resume did not continue at the "
                         "saved step and cursor")
    gc.collect()
    torch.cuda.empty_cache()
    traced = mixtral_traced_step(torch, dev, seed, data_path, cfg, lora_cfg,
                                 opt_cfg)
    last = hist[-1]
    record = {"layers": cfg.num_layers, "steps": steps,
              "wall_s_with_init": wall, "losses": losses,
              "resumed_losses": r_losses,
              "restored_step": resumed["restored_step"],
              "cursor": cursor.get("batches_consumed"),
              "first_step_s": summary["first_step_s"],
              "step_s": last.get("step_s"),
              "tokens_per_s": last["tokens_per_sec"],
              "mfu": last.get("mfu"),
              "flops_per_token_x3": 3.0 * cfg.flops_per_token(TRAIN_SEQ),
              "peak_memory_gb": peak / 1e9, "launches": launches,
              "launches_per_step_expected": per_step,
              "routing": routing, "traced": traced,
              "seconds": time.perf_counter() - t0}
    print("phase 24 (b) " + json.dumps(record), flush=True)
    if traced["objective_rel"] > MIXTRAL_OBJECTIVE_RTOL:
        raise SystemExit("phase 24 (b): the logged loss is not CE plus "
                         f"moe_aux_coef x aux: {traced}")
    return record, launches


def mixtral_train_phase(torch, dev, seed, batch, data_path, workdir):
    """Phase 24: mixtral's fine-tune. (a) the gradient check; (b) the
    LoRA fine-tune through run_training. Returns the fine-tune's K1-K3
    launches."""
    t0 = time.perf_counter()
    grads = mixtral_grad_check(torch, dev, seed, batch)
    mark("phase 24 (a)")
    train, launches = mixtral_fine_tune(torch, dev, seed, data_path,
                                        workdir)
    print("phase 24 " + json.dumps({
        "card": card_line(), "grad_check_s": grads["seconds"],
        "fine_tune_s": train["seconds"], "launches": launches,
        "seconds": time.perf_counter() - t0}), flush=True)
    return launches


# ---------------------------------------------------------------------------
# Expert-parallel mixtral serving: phase 25
# ---------------------------------------------------------------------------

# mixtral-8x7b at full width cut to this depth, served as four ranks
# (EP_MESH) sharing one card over gloo: a rank holds 16/4 heads, experts
# {0-3} or {4-7} on 7168 of their 14336 MLP columns and half the
# vocabulary, about 6.2 GB in bf16 at 8 layers.
MIXTRAL_EP_LAYERS = 8
EP_MESH = {"expert": 2, "tensor": 2}
EP_RANK_TIMEOUT_S = 420
# Last-position prefill logits of the four ranks against one process's
# on the same bf16 weights, stated before the first run on the card:
# phase 20's tensor-parallel gap (0.04699) from the attention's partial
# sums, plus the experts' partial products rounded to bf16 before the
# combine, and a token routed to another expert where its router's top
# choices lie within that rounding (PR 24 moved 136 of 16,384 such
# assignments with another attention's roundings).
EP_LOGIT_GAP = 0.25
# Faults planted for one prefill each, every rank running it, to show the
# gap gate catches them: each expert row runs its experts under the
# other row's expert ids (experts swapped between the expert ranks), and
# the router's columns of experts 0 and E/2 swapped in layer 0 (on every
# rank, as a converter's fault would be; layer 0 so that the tokens it
# moves reach the last position through the later attentions).
EP_FAULTS = ("experts_swapped_between_ranks", "router_columns_swapped")
# The engine runs of phase 25 (a): (name, mix, config overrides, whether
# its greedy ids are gated). bf16 at the capacity factor 1.25 is the path
# as served, and its ids are reported, not gated: capacity couples a
# token to every row of its dispatch and a dropped assignment's slot to
# every earlier one, so the ranks' bf16 partial sums, which move router
# near-ties (PR 24: 136 of 16,384 assignments under another attention's
# roundings), move drops and then ids far from any logit near-tie (on an
# H100 the first run parted 6 of 8 dense requests from one process's;
# even f32 activations at 1.25 parted one). The gated run repeats the
# dense mix with the same bf16 weights, f32 activations (the plain
# attention: K1 takes bf16) and the capacity that drops nothing (E / k:
# 4.0 for mixtral), where a token's output is its own and the ranks'
# rounding sits far below a router's near-tie, as phase 23 gates its ids.
EP_RUNS = (("dense", "dense", {}, False), ("paged", "paged", {}, False),
           ("dense_f32_dropless", "dense",
            {"dtype": "float32", "attention_impl": "xla",
             "moe_capacity_factor": 4.0}, True))


def ep_model_params(seed, layers=MIXTRAL_EP_LAYERS):
    return {"model": "mixtral-8x7b",
            "model_overrides": {"param_dtype": "bfloat16",
                                "num_layers": layers},
            "seed": seed}


def capture_routing(records):
    """Wrap models.moe.route to append each call's Routing (expert, slot,
    keep and gate, on the host) to ``records``; returns the restore
    function."""
    from runbooks_tpu_torch.models import moe

    route = moe.route

    def capturing(cfg, probs):
        r = route(cfg, probs)
        records.append({k: getattr(r, k).cpu() for k in ("expert", "slot",
                                                         "keep", "gate")})
        return r

    moe.route = capturing

    def restore():
        moe.route = route

    return restore


def routed_logits(torch, cfg, params, prompt, seq, tp=None):
    """(prefill_logits of ``prompt``, its Routing per layer)."""
    routes = []
    restore = capture_routing(routes)
    try:
        with torch.no_grad():
            logits = prefill_logits(torch, cfg, params, prompt,
                                    bucket_of(len(prompt)), seq,
                                    tp=tp).float().cpu()
    finally:
        restore()
    return logits, routes


def ep_planted_logits(torch, cfg, engine, prompt, seq):
    """{fault: last-position prefill logits} with each EP_FAULTS fault
    planted (every rank runs the forward; each fault is undone after)."""
    tp = engine.tp
    out = {}
    held = tp.experts
    other = (tp.expert_rank + 1) % tp.plan.expert
    tp.experts = tp.plan.expert_range(other * tp.plan.tensor
                                      + tp.tensor_rank)
    try:
        out[EP_FAULTS[0]] = routed_logits(torch, cfg, engine.params, prompt,
                                          seq, tp)[0]
    finally:
        tp.experts = held
    router = engine.params["layers"]["moe"]["router"][0]
    saved = router.clone()
    j = cfg.moe_num_experts // 2
    router[:, 0], router[:, j] = saved[:, j], saved[:, 0]
    try:
        out[EP_FAULTS[1]] = routed_logits(torch, cfg, engine.params, prompt,
                                          seq, tp)[0]
    finally:
        router.copy_(saved)
    return out


def ep_rank(rank, world, store_path, out_path, seed, device_type, setup):
    """Phase 25 (a)'s rank body (a spawned process): join the gloo group
    over EP_MESH, load only this rank's shard (``load_model(shard=)``:
    its heads, experts and MLP columns), then one prefill of the longest
    prompt with its routing per layer and one forward's collectives by
    group, the planted faults, and per kind (dense, paged) drive (rank
    0) or replay (the others); K1 launches, parameter bytes against the
    plan's, local widths, peak memory. ``setup``: the parent's {"params",
    "mixes", "seq", "new"}. The result is pickled to out_path (an
    exception's traceback instead, on failure)."""
    import pickle
    import traceback

    import torch

    result = {"ok": False}
    try:
        import torch.distributed as dist

        from runbooks_tpu_torch.models.transformer import init_params
        from runbooks_tpu_torch.ops.flash_attention import flash_attention
        from runbooks_tpu_torch.parallel import distributed
        from runbooks_tpu_torch.parallel.mesh import MeshConfig, make_mesh
        from runbooks_tpu_torch.serve.api import load_model
        from runbooks_tpu_torch.utils.tree import tree_leaves

        torch.backends.cuda.matmul.allow_tf32 = False
        dev = torch.device("cuda", 0) if device_type == "cuda" \
            else torch.device("cpu")
        distributed.initialize(EP_RANK_TIMEOUT_S, backend="gloo", rank=rank,
                               world_size=world, device=dev,
                               store=dist.FileStore(store_path, world))
        mesh = make_mesh(MeshConfig(fsdp=1, **EP_MESH),
                         device_type=device_type)
        if dev.type == "cuda":
            torch.cuda.reset_peak_memory_stats()
        cfg, params = load_model(setup["params"], device=dev,
                                 shard=(EP_MESH["tensor"], rank,
                                        EP_MESH["expert"]))
        if dev.type == "cuda":
            result["load_peak_gb"] = torch.cuda.max_memory_allocated() / 1e9
        shapes = init_params(cfg, None, torch.device("meta"))
        mixes, seq = setup["mixes"], setup["seq"]
        for kind, mix, over, _ in EP_RUNS:
            engine = tp_engine(torch, dataclasses.replace(cfg, **over),
                               params, mix, seed, seq, mesh)
            tp = engine.tp
            if kind == "dense":
                layers = engine.params["layers"]
                result.update(
                    local_bytes=sum(t.numel() * t.element_size()
                                    for t in tree_leaves(engine.params)),
                    plan_bytes=tp.plan.local_param_bytes(shapes, rank),
                    plan=tp.plan.describe(),
                    coords=(tp.expert_rank, tp.tensor_rank),
                    experts=(tp.experts.start, tp.experts.stop),
                    local={"q_heads": layers["attn"]["wq"].shape[-1]
                           // cfg.head_dim,
                           "kv_heads": layers["attn"]["wk"].shape[-1]
                           // cfg.head_dim,
                           "experts": layers["moe"]["wi_gate"].shape[1],
                           "mlp": layers["moe"]["wi_gate"].shape[-1],
                           "router": list(layers["moe"]["router"].shape),
                           "vocab": engine.params["embed"].shape[0]})
                counts0 = {g: dict(c) for g, c in tp.group_counts.items()}
                prompt = mixes["dense"][-1]
                result["logits"], result["routing"] = routed_logits(
                    torch, cfg, engine.params, prompt, seq, tp)
                result["collectives_per_forward"] = {
                    g: {k: tp.group_counts[g][k] - counts0[g][k]
                        for k in c} for g, c in counts0.items()}
                with torch.no_grad():
                    result["planted"] = ep_planted_logits(
                        torch, cfg, engine, prompt, seq)
            if rank == 0:
                records = []
                restore = count_routing(records)
                try:
                    ids, launches, wall, tokens = tp_drive(
                        torch, engine, mix, mixes, setup["new"])
                finally:
                    restore()
                    engine.stop_followers()
                result[kind] = {"ids": ids, "launches": launches,
                                "wall_s": wall, "tokens": tokens,
                                "routing": routing_summary(records)}
            else:
                flash_attention.launches = 0
                engine.serve_follower()
                result[kind] = {"launches": flash_attention.launches}
            result[kind]["collectives"] = {
                g: dict(c) for g, c in tp.group_counts.items()}
            engine.cache = None
            del engine
            gc.collect()
            if dev.type == "cuda":
                torch.cuda.empty_cache()
        if dev.type == "cuda":
            result["peak_gb"] = torch.cuda.max_memory_allocated() / 1e9
        result["ok"] = True
        distributed.shutdown()
    except BaseException:  # noqa: BLE001 - reported to the parent
        result["error"] = traceback.format_exc()
    with open(out_path, "wb") as f:
        pickle.dump(result, f)


def ep_four_ranks(torch, seed, workdir, setup, device_type="cuda"):
    """Phase 25 (a): ep_rank on the four spawned processes of EP_MESH."""
    return spawn_ranks(ep_rank, EP_MESH["expert"] * EP_MESH["tensor"],
                       workdir, "phase 25 (a)", EP_RANK_TIMEOUT_S, seed,
                       device_type, setup)


def routing_differences(a, b):
    """Assignments (over every layer) that differ between two runs'
    Routing records: in their expert (a router near-tie moved), and in
    their expert, slot or keep (an earlier move shifts every later slot
    of the experts involved)."""
    def count(field_sets):
        return sum(int(sum((x[f] != y[f]) for f in field_sets).bool().sum())
                   for x, y in zip(a, b, strict=True))

    return {"expert": count(("expert",)),
            "expert_slot_or_keep": count(("expert", "slot", "keep"))}


def ep_nccl_rank(store_path, out_path, seed):
    """Phase 25 (b)'s one-process NCCL group under mesh_expert 1 x
    mesh_tensor 1: the serving path's collectives (tp_nccl_collectives:
    the f64 combine over the serving group, the exchange and the
    broadcast among them) on mixtral's shapes, then the engine under that
    mesh against the unsharded one on the same weights (mixtral-8x7b at
    full width cut to ENTRY_LAYERS), ids exact."""
    import pickle
    import traceback

    import torch

    result = {"ok": False}
    try:
        import torch.distributed as dist

        from runbooks_tpu_torch.parallel import distributed
        from runbooks_tpu_torch.parallel.mesh import MeshConfig, make_mesh
        from runbooks_tpu_torch.serve.api import load_model

        torch.backends.cuda.matmul.allow_tf32 = False
        dev = torch.device("cuda", 0)
        distributed.initialize(EP_RANK_TIMEOUT_S, backend="nccl", rank=0,
                               world_size=1, device=dev,
                               store=dist.FileStore(store_path, 1))
        mesh = make_mesh(MeshConfig(expert=1, fsdp=1, tensor=1))
        cfg, params = load_model(ep_model_params(seed, ENTRY_LAYERS),
                                 device=dev)
        result["collectives"] = tp_nccl_collectives(
            torch, cfg, mesh.get_group("tensor"), dev)
        mixes = tp_mixes(seed)
        meshed = tp_engine(torch, cfg, params, "dense", seed, TP_SEQ, mesh)
        ids_mesh, launches_mesh, _, _ = tp_drive(torch, meshed, "dense",
                                                 mixes)
        del meshed
        plain = tp_engine(torch, cfg, params, "dense", seed, TP_SEQ)
        ids_plain, launches_plain, _, _ = tp_drive(torch, plain, "dense",
                                                   mixes)
        result.update(ok=True, backend=dist.get_backend(),
                      world=dist.get_world_size(),
                      equal=ids_mesh == ids_plain,
                      launches=(launches_mesh, launches_plain))
        distributed.shutdown()
    except BaseException:  # noqa: BLE001 - reported to the parent
        result["error"] = traceback.format_exc()
    with open(out_path, "wb") as f:
        pickle.dump(result, f)


def ep_nccl_phase(torch, seed, workdir):
    """Phase 25 (b): the NCCL group at world 1 (a spawned process), then
    ``main`` under mesh_expert 2 x mesh_tensor 2 over HTTP where four
    GPUs exist, else its refusal naming the device count."""
    import multiprocessing as mp
    import pickle

    out = f"{workdir}/ep_nccl.pkl"
    p = mp.get_context("spawn").Process(
        target=ep_nccl_rank, args=(f"{workdir}/ep_nccl_store", out, seed),
        daemon=True)
    p.start()
    p.join(EP_RANK_TIMEOUT_S)
    if p.is_alive():
        p.kill()
        raise SystemExit("phase 25 (b): the NCCL process did not finish")
    with open(out, "rb") as f:
        res = pickle.load(f)
    if not res["ok"]:
        raise SystemExit(f"phase 25 (b): NCCL world 1 failed:\n"
                         f"{res['error']}")
    record = {"nccl_world1": {k: res[k] for k in (
        "backend", "world", "collectives", "equal", "launches")}}
    content = f"{workdir}/ep_content"
    os.makedirs(content, exist_ok=True)
    port = free_port()
    with open(f"{content}/params.json", "w") as f:
        json.dump(dict(ep_model_params(seed, ENTRY_LAYERS),
                       mesh_expert=EP_MESH["expert"],
                       mesh_tensor=EP_MESH["tensor"], port=port,
                       max_slots=4, max_seq_len=256), f)
    n = torch.cuda.device_count()
    world = EP_MESH["expert"] * EP_MESH["tensor"]
    log = f"{workdir}/ep_main.log"
    if n >= world:
        proc, base, ready_s = start_entry_point(content, port, log,
                                                HTTP_TIMEOUT)
        status, body = http_call(base, "/v1/completions", {
            "prompt": "expert parallel", "max_tokens": 8,
            "temperature": 0.0})
        proc.send_signal(signal.SIGTERM)
        code = proc.wait(ENTRY_DRAIN_S + 60)
        record["main_mesh_expert_2_tensor_2"] = {
            "ran": True, "ready_s": ready_s, "status": status,
            "completion_tokens": body["usage"]["completion_tokens"],
            "exit": code}
        ok = status == 200 and code == 0
    else:
        root = os.path.dirname(os.path.abspath(__file__))
        done = subprocess.run(
            [sys.executable, "-m", "runbooks_tpu_torch.serve.api"],
            cwd=root, capture_output=True, text=True, timeout=300,
            env=dict(os.environ, RBT_CONTENT_DIR=content))
        named = (f"needs {world} GPUs" in done.stderr
                 and f"torch.cuda.device_count() is {n}" in done.stderr)
        print(f"phase 25 (b): main with mesh_expert 2 x mesh_tensor 2 over "
              f"HTTP not run: this machine has {n} GPU", flush=True)
        record["main_mesh_expert_2_tensor_2"] = {
            "ran": False, "devices": n, "exit": done.returncode,
            "names_device_count": named}
        ok = done.returncode != 0 and named
    coll = res["collectives"]
    record["gates"] = {
        "nccl_world1_collectives": res["backend"] == "nccl" and all(
            coll[k] for k in ("combine_f64", "broadcast", "exchange")),
        "nccl_world1_engine_equal": res["equal"],
        "main_mesh_expert_2_tensor_2": ok}
    return record


def ep_phase(torch, seed, workdir):
    """Phase 25 (see the module docstring). Returns K1's launches by path
    (each rank's dense and paged runs)."""
    from runbooks_tpu_torch.serve.api import load_model

    t_phase = time.perf_counter()
    mixes = tp_mixes(seed)
    setup = {"params": ep_model_params(seed), "mixes": mixes,
             "seq": TP_SEQ, "new": TP_NEW}
    ranks = ep_four_ranks(torch, seed, workdir, setup)
    t_ranks = time.perf_counter() - t_phase
    gc.collect()
    torch.cuda.empty_cache()
    # The single-process engine on the same weights, this process, once
    # the ranks have ended.
    cfg, params = load_model(setup["params"])
    prompt = mixes["dense"][-1]
    plain_logits, plain_routes = routed_logits(torch, cfg, params, prompt,
                                               TP_SEQ)
    single, run_cfgs = {}, {}
    for kind, mix, over, _ in EP_RUNS:
        run_cfgs[kind] = dataclasses.replace(cfg, **over)
        engine = tp_engine(torch, run_cfgs[kind], params, mix, seed, TP_SEQ)
        ids, launches, wall, tokens = tp_drive(torch, engine, mix, mixes)
        single[kind] = {"ids": ids, "launches": launches, "wall_s": wall,
                        "tokens": tokens}
        free_engine(torch, engine)
    gates, ties = {}, {}
    for kind, mix, _, gated in EP_RUNS:
        got, want = ranks[0][kind]["ids"], single[kind]["ids"]
        ties[kind] = [near_tie_check(
            torch, run_cfgs[kind], params, f"phase 25 {kind} request {i}",
            mixes[mix][i], a, b, fail=False)
            for i, (a, b) in enumerate(zip(got, want))]
        if gated:
            gates[f"{kind}_ids_equal_or_near_tie"] = all(
                t["ok"] for t in ties[kind])
        gates[f"{kind}_k1_launches_per_rank"] = all(
            r[kind]["launches"] == single[kind]["launches"]
            for r in ranks) and (single[kind]["launches"] > 0
                                 or run_cfgs[kind].attention_impl == "xla")
    gaps = [float((r["logits"] - plain_logits).abs().max()) for r in ranks]
    gates["logits_within_gap"] = max(gaps) <= EP_LOGIT_GAP
    planted = {f: min(float((r["planted"][f] - plain_logits).abs().max())
                      for r in ranks) for f in EP_FAULTS}
    gates["planted_faults_outside_gap"] = min(planted.values()) > EP_LOGIT_GAP
    gates["routing_identical_on_every_rank"] = all(
        routing_differences(r["routing"], ranks[0]["routing"])[
            "expert_slot_or_keep"] == 0
        and all(torch.equal(x["gate"], y["gate"])
                for x, y in zip(r["routing"], ranks[0]["routing"]))
        for r in ranks[1:])
    gates["param_bytes_equal_plan"] = all(
        r["local_bytes"] == r["plan_bytes"] for r in ranks)
    E, tensor = cfg.moe_num_experts, EP_MESH["tensor"]
    n_e = E // EP_MESH["expert"]
    gates["local_widths"] = all(
        r["local"] == {"q_heads": cfg.num_heads // tensor,
                       "kv_heads": cfg.num_kv_heads // tensor,
                       "experts": n_e,
                       "mlp": cfg.intermediate_size // tensor,
                       "router": [cfg.num_layers, cfg.hidden_size, E],
                       "vocab": cfg.vocab_size // tensor}
        and r["experts"] == (r["coords"][0] * n_e, (r["coords"][0] + 1) * n_e)
        for r in ranks)
    free_engine(torch)
    del params
    gc.collect()
    torch.cuda.empty_cache()
    nccl = ep_nccl_phase(torch, seed, workdir)
    gates.update(nccl.pop("gates"))
    label = "gloo over host memory on one card, not an EP speed"
    record = {
        "card": card_line(), "layers": cfg.num_layers, "mesh": EP_MESH,
        "plan": ranks[0]["plan"],
        "local": ranks[0]["local"],
        "experts_per_rank": [r["experts"] for r in ranks],
        "param_bytes_per_rank": [r["local_bytes"] for r in ranks],
        "peak_gb_per_rank": [r.get("peak_gb") for r in ranks],
        "load_peak_gb_per_rank": [r.get("load_peak_gb") for r in ranks],
        "collectives_per_forward": ranks[0]["collectives_per_forward"],
        "logit_gap_per_rank": gaps, "logit_gap_limit": EP_LOGIT_GAP,
        "planted_fault_gaps": planted,
        "routed_differently_vs_one_process": routing_differences(
            ranks[0]["routing"], plain_routes),
        "assignments_per_prefill": sum(r["keep"].numel()
                                       for r in plain_routes),
        "near_ties": ties,
        "ids_gated": [kind for kind, _, _, gated in EP_RUNS if gated],
        "identical_requests": {
            kind: sum(t["identical"] for t in ties[kind]) for kind in ties},
        "kept_share": {kind: ranks[0][kind]["routing"] for kind in ties},
        "k1_launches": {kind: {"single": single[kind]["launches"],
                               "ranks": [r[kind]["launches"]
                                         for r in ranks]}
                        for kind in ties},
        "tokens_per_s": {
            kind: {label: ranks[0][kind]["tokens"]
                   / ranks[0][kind]["wall_s"],
                   "one_process_same_card": single[kind]["tokens"]
                   / single[kind]["wall_s"]}
            for kind in ties},
        "ranks_s": t_ranks, **nccl,
        "seconds": time.perf_counter() - t_phase, "gates": gates}
    print("phase 25 " + json.dumps(record), flush=True)
    failed = [k for k, v in gates.items() if not v]
    if failed:
        raise SystemExit(f"phase 25: gates failed: {failed}")
    return {f"ep_{kind}_rank{r}": ranks[r][kind]["launches"]
            for kind in ("dense", "paged") for r in range(len(ranks))}


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--trace-remat", action="store_true",
                    help="phase 17 (a): one traced step per remat policy "
                         "(about 30 s each)")
    args = ap.parse_args()

    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    from runbooks_tpu_torch.utils import cuda_build

    faulthandler.dump_traceback_later(WATCHDOG_S, exit=False)
    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    import jinja2

    card = card_line()
    print(f"card: {card} | torch {torch.__version__} cuda "
          f"{torch.version.cuda} | jinja2 {jinja2.__version__} | "
          f"devices {torch.cuda.device_count()} | "
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
        mark("phase 3")
        gc.collect()
        torch.cuda.empty_cache()
        serve_launches = e2e_phase(torch, args.seed)
        mark("phase 4")
        gc.collect()
        torch.cuda.empty_cache()
        bwd_records, bwd_worst = bwd_kernel_phase(torch, dev, args.seed,
                                                  batch)
        grad_check_phase(torch, dev, args.seed, batch)
        mark("phases 5 and 6")
        gc.collect()
        torch.cuda.empty_cache()
        train_launches, summary, peak = train_phase(torch, dev, args.seed,
                                                    data_path, workdir)
        mark("phase 7")
        gc.collect()
        torch.cuda.empty_cache()
        http_launches = http_phase(torch, dev, args.seed, workdir)
        mark("phase 8")
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
        mark("phase 10")
        spec_launches = spec_grammar_phase(torch, dev, args.seed)
        mark("phase 11")
        paged_launches = paged_phase(torch, args.seed)
        mark("phase 12")
        lora_launches = lora_phase(torch, args.seed, workdir)
        mark("phase 13")
        quant_launches, qmm_records = quant_phase(torch, dev, args.seed,
                                                  workdir)
        mark("phase 14")
        text_launches = text_phase(torch, dev, args.seed, workdir)
        mark("phase 15")
        family_launches, family_bwd_launches, family_records = \
            families_phase(torch, dev, args.seed, batch, data_path, workdir)
        mark("phase 16")
        gc.collect()
        torch.cuda.empty_cache()
        entry_launches = entry_point_phase(torch, dev, args.seed, data_path,
                                           workdir, args.trace_remat)
        mark("phase 17")
        gc.collect()
        torch.cuda.empty_cache()
        obs_launches = obs_overhead_phase(torch, dev, args.seed, workdir)
        mark("phase 18")
        gc.collect()
        torch.cuda.empty_cache()
        gateway_launches = gateway_phase(torch, args.seed, workdir)
        mark("phase 19")
        gc.collect()
        torch.cuda.empty_cache()
        fsdp_ranks = fsdp_start(args.seed, data_path, workdir)
        tp_launches = tp_phase(torch, args.seed, workdir)
        mark("phase 20")
        gc.collect()
        torch.cuda.empty_cache()
        fsdp_launches = fsdp_phase(torch, args.seed, data_path, workdir,
                                   fsdp_ranks)
        mark("phase 21")
        gc.collect()
        torch.cuda.empty_cache()
        (gemma_launches, gemma_records, gemma_worst, gemma_bwd,
         gemma_bwd_worst, gemma_train_launches) = gemma_phase(
            torch, dev, args.seed, batch, data_path, workdir)
        mark("phase 22")
        gc.collect()
        torch.cuda.empty_cache()
        mixtral_launches, moe_records = mixtral_phase(torch, dev, args.seed,
                                                      workdir)
        mark("phase 23")
        gc.collect()
        torch.cuda.empty_cache()
        mixtral_train_launches = mixtral_train_phase(
            torch, dev, args.seed, batch, data_path, workdir)
        mark("phase 24")
        gc.collect()
        torch.cuda.empty_cache()
        ep_launches = ep_phase(torch, args.seed, workdir)
        mark("phase 25")

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
                     + sum(paged_launches.values())
                     + sum(lora_launches.values())
                     + sum(quant_launches.values())
                     + sum(text_launches["flash_fwd"].values())
                     + sum(family_launches.values())
                     + sum(entry_launches["flash_fwd"].values())
                     + obs_launches + sum(gateway_launches.values())
                     + sum(tp_launches.values())
                     + sum(fsdp_launches["flash_fwd"].values())
                     + sum(mixtral_launches.values())
                     + mixtral_train_launches["flash_fwd"]
                     + sum(ep_launches.values())),
        "launches_by_path": {"serve": serve_launches,
                             "train": train_launches["flash_fwd"],
                             "http": http_launches,
                             "import": import_launches,
                             "prefix_register": build_launches,
                             "prefix": prefix_launches,
                             "prefix_off": no_prefix_launches,
                             **spec_launches, **paged_launches,
                             **lora_launches, **quant_launches,
                             **text_launches["flash_fwd"],
                             **family_launches,
                             **entry_launches["flash_fwd"],
                             "obs_overhead": obs_launches,
                             **gateway_launches, **tp_launches,
                             **fsdp_launches["flash_fwd"],
                             **mixtral_launches,
                             "mixtral_train":
                                 mixtral_train_launches["flash_fwd"],
                             **ep_launches},
        "max_abs_err": max(worst, family_records["fwd_worst"]),
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
    kernels[0]["family_shapes"] = {
        name: {k: r[k] for k in ("ms", "plain_ms", "bound_ms", "bound_by",
                                 "library_ms", "library_causal_ms",
                                 "tflops", "shape")}
        for name, r in family_records["fwd"].items()}
    # K1 at head_dim 256 (gemma), its own row: phase 22's launches.
    burst = gemma_records["gemma7b_rows8_sq128"]
    kernels.append({
        "name": "flash_fwd_d256",
        "route": "cuda",
        "source": "runbooks_tpu_torch/csrc/flash_fwd.cu",
        "replaces": "runbooks_tpu/ops/flash_attention.py:92",
        "launches": sum(gemma_launches.values()),
        "launches_by_path": gemma_launches,
        "max_abs_err": gemma_worst,
        **{k: burst[k] for k in ("ms", "plain_ms", "bound_ms", "bound_by",
                                 "library_ms", "bound_ms_with_padding",
                                 "tflops", "shape")},
        "shapes": {name: {k: r[k] for k in (
            "ms", "plain_ms", "bound_ms", "bound_by", "library_ms",
            "library_causal_ms", "tflops", "shape")}
            for name, r in gemma_records.items()},
    })
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
            "launches": (train_launches[name] + text_launches[name]
                         + family_bwd_launches[name]
                         + sum(entry_launches[name].values())
                         + sum(fsdp_launches[name].values())
                         + mixtral_train_launches[name]),
            "launches_by_path": {"train": train_launches[name],
                                 "text_train": text_launches[name],
                                 "falcon_train": family_bwd_launches[name],
                                 **entry_launches[name],
                                 **fsdp_launches[name],
                                 "mixtral_train":
                                     mixtral_train_launches[name]},
            "max_abs_err": max(bwd_worst[name],
                               family_records["bwd_worst"][name]),
            "ms": train_case["ms"][name],
            "plain_ms": train_case["plain_ms"],
            "plain_ms_covers": "flash_attention_bwd_reference: dq, dk, dv",
            "bound_ms": bound_ms,
            "bound_by": bound_by,
            "library_ms": library,
            "library_masked_ms": train_case["library_masked_ms"],
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
            "family_shapes": {
                case: {"ms": r["ms"][name], "plain_ms": r["plain_ms"],
                       "bound_ms": r["bounds"][name][0],
                       "bound_by": r["bounds"][name][1],
                       "library_ms": r["library_ms"],
                       "library_masked_ms": r["library_masked_ms"],
                       "card_tiles_computed_open": r["card_tiles"][name],
                       "shape": r["shape"]}
                for case, r in family_records["bwd"].items()},
        })
    kernels += gemma_bwd_rows(gemma_bwd, gemma_bwd_worst,
                              gemma_train_launches)
    print(f"train summary: tokens/s {summary['tokens_per_sec']:.1f} | "
          f"history {json.dumps(summary['history'])} | peak memory "
          f"{peak / 1e9:.2f} GB", flush=True)
    # quantized_matmul and the MoE layer are plain PyTorch (no Pallas
    # kernel in the reference): their records stand on their own line.
    print(json.dumps({"quantized_ops": qmm_records,
                      "moe_layer": moe_records}), flush=True)
    faulthandler.cancel_dump_traceback_later()
    print(card_line(), flush=True)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
