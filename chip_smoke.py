#!/usr/bin/env python3
"""Chip smoke test for paddle_tpu_torch: drive the port's serving and
training main paths on one CUDA card and hold every kernel on them
against its plain PyTorch version.

    python3 chip_smoke.py            # every phase, one card

Phases, each printing one JSON line (any failure raises and exits
non-zero):

  1. device  — the card's name and power limit (nvidia-smi), refusing
               to run without CUDA;
  2. build   — nvcc builds every kernel source of csrc/, one nvcc per
               source, all started together; each source's line lists
               every kernel with its registers and spill bytes (ptxas;
               a tensor-core instantiation with dropout is labelled
               `dropout`), and `tc_spill_bytes` sums the spills of the
               tensor-core kernels (`*_tc_kernel`); one without dropout
               that spills fails the phase;
  3. kernel  — the ragged paged-attention kernel against its plain
               version on one mixed wave at Llama-3-8B attention widths
               (QH=32, KVH=8, D=128, page 16): a 256-token prefill chunk
               at positions 512-767, 7 decode rows at lengths 100-2000,
               inactive rows up to T=384; fp32, bf16 and int8 pools
               (int8 with bf16 q and with fp32 q). Times are medians
               over CUDA events; `bound_ms` is the larger of the bytes
               the wave must move (unique KV of the touched slots, q of
               the active rows, the whole output) over the card's memory
               rate and the flops over its peak; `library_ms` is
               F.scaled_dot_product_attention over the wave's real
               extents (one call for the prefill slot, one batched call
               for the decode rows), KV gathered dense beforehand (a
               yardstick only). Each row names its `route`: bf16 q over
               bf16 or int8 pages runs the tensor-core kernel
               (`ragged_tc_kernel`, after the plan kernel, which its
               `kernel_ms` holds; `kernel_only_ms` is the attention
               kernel alone and `plan_kernel_ms` the plan kernel alone,
               from torch.profiler, also on the prefill chunk's rows and
               on the decode rows alone; `step_plan_ms` the call given a
               plan, as unified_step makes it), whose k tiles computed
               must equal the plain plan's (`ragged_tile_plan`: 284 a KV
               head); fp32 q the CUDA-core one. Rows carry `design`,
               `library_factor` and `bound_share` as train_kernel's, and
               a tensor-core row over MAX_RAGGED_LIBRARY_FACTOR x its
               SDPA yardstick fails;
  4. parity  — a Llama-3-8B-width model at depth PARITY_LAYERS (fp32,
               TF32 off) served by a card engine and a CPU engine from
               the same weights: 4 greedy requests must give identical
               tokens;
  5. serve   — Llama-3-8B at full width (cut to 8 layers: SERVE_LAYERS;
               bf16 random weights from a seed) serving 8 requests
               through run_pipelined(),
               with a bf16 pool and with an int8 pool;
  6. train_kernel — the three flash-attention kernels (forward, dQ,
               dK/dV) against their plain versions at the attention
               shapes of Llama-3-8B training (B=2, H=32 after the GQA
               repeat, S=2048, D=128, causal), bf16 and fp32. `bound_ms`
               counts the causal half of the S x S pairs and each operand
               byte once; `library_ms` is F.scaled_dot_product_attention
               (is_causal) for the forward and its backward (forward +
               backward, minus forward) for dQ and dK/dV together, a
               yardstick only. Each row gives its `design`,
               `library_factor` (kernel over library time, same run) and
               `bound_share` (bound over kernel time), and the dK/dV row
               `pair_library_factor` (dQ + dK/dV over the SDPA
               backward); a bf16 forward whose factor exceeds 6, or a
               bf16 dQ or dK/dV whose factor exceeds 4, fails the phase
               (the CUDA-core designs ran at 28x, 8.4x and 9.6x);
  7. train_parity — Llama-3-8B widths at depth 1 with the vocabulary cut
               to 4096, fp32, TF32 off, remat on, batch 1 x 512: two
               steps of make_train_step on the card and on the CPU from
               the same weights, holding the losses, the step-1
               gradients and the parameters after the steps;
  8. train   — Llama-3-8B widths at depth 4 (the one cut: 8B parameters
               with fp32 AdamW state do not fit one 80 GB card), bf16
               params, fp32 AdamW state, remat on, batch 2 x 2048, 6 steps
               on one fixed batch: median step time, tokens/s, the
               model-flops share of 989 TFLOP/s, peak memory, and losses
               that are finite and fall;
  9. mask_kernel — the three FlashMask kernels (forward, dQ, dK/dV)
               against their plain versions, bf16 and fp32: (a) at the
               packed-document shape of Llama-3-8B training (B=1, H=32,
               S=8192, D=128, eight documents of 192-3000 tokens, the
               (1, 1, S, 1) mask from doc_end_indices), with times;
               `bound_ms` counts the kept pairs exactly from the mask and
               each operand byte once; `library_ms` is
               F.scaled_dot_product_attention (is_causal) once per
               document, summed (forward; forward + backward minus forward
               for dQ and dK/dV), a yardstick only; `causal_only_ms` is
               the same kernel with no mask, and each kernel must take
               less than half of it (the block skip); each kernel counts
               the (q tile, k tile) pairs it computed, which must equal
               the skip rule's (`_tile_counts`), and its rows carry
               `design`, `library_factor` and `bound_share` as
               train_kernel's (the dK/dV row `pair_library_factor`), with
               the same limits on the bf16 factors (the bf16 dQ and
               dK/dV run the tensor-core loops of attn_bwd_sm90.cuh);
               (b) correctness over every mask flavor at B=2, H=4,
               S=1000, D=64 and 128, each kernel's tiles against
               `tile_plan`'s;
 10. packed_parity — train_parity with packed documents: batch 2 x 512,
               row 0 four documents, row 1 one, card against CPU;
 11. train_packed — the train phase's model on one 1 x 8192 row of the
               eight documents: median step, tokens/s, the model-flops
               share (attention charged at the full 12 L H S, and as
               kept), peak memory, falling losses;
 12. bucket_kernel — the bucketed serving kernels against their plain
               versions: (a) va_fwd at the serve phase's prefill wave
               (its 8 prompts packed into an 8192 bucket; H=32, KVH=8,
               D=128, causal, same offsets), bf16 and fp32, with times
               and the tiles it computed per head, which must equal the
               skip rule's count; `bound_ms` counts the kept pairs and
               the real rows; `library_ms` is
               F.scaled_dot_product_attention (is_causal) once per
               prompt, summed; (b) va_fwd correctness on ragged token
               axes of 700-1000 (causal and not, unequal q/k offsets,
               rows that see nothing), GQA groups 1 and 4, D=64 and 128;
               the va_fwd rows carry `design`, `library_factor` and
               `bound_share` as train_kernel's (bf16 runs the tensor-core
               loop with the varlen policy, and fails over 6x SDPA);
               (c) pa_decode at 8B widths on 8 slots of 100-2000 cached
               tokens and a free slot (exactly zero), fp32, bf16 and
               int8 pools (int8 with bf16 and with fp32 q), with times;
               `library_ms` is F.scaled_dot_product_attention over the
               live slots' KV gathered dense;
 13. bucket_parity — parity with the bucketed engine (`ragged=False`,
               max_seqs 3, run_pipelined; depth PARITY_LAYERS): three
               requests admit in one
               prefill_varlen wave and the fourth alone through prefill;
               fp32 and int8 pools; tokens as in parity, and the exact
               launches of va_fwd, fa_fwd and pa_decode (none ragged;
               the CPU engine launches nothing);
 14. bucket_serve — the serve phase's model and 8 requests on the
               bucketed engine through run_pipelined(), bf16 and int8
               pools, with the same measurements, pad_tokens, and the
               launches of every kernel (the 8B parameters are built
               once for serve, bucket_serve and spec_serve); then,
               untimed, the same requests again on the drained engine,
               keeping the logits each token was drawn from (for
               tp_serve), whose streams must be the timed run's;
 15. spec_kernel — pa_verify against its plain version: (a) at 8B
               widths on bucket_kernel's 8 live slots (cache lengths
               100-2000 before a G = 4 chunk), fp32, bf16 and int8 pools
               (int8 with bf16 and with fp32 q), with times; `bound_ms`
               by bytes (each slot's K/V up to base + G read once per KV
               head, q and the output once); `library_ms` is
               F.scaled_dot_product_attention over the slots' KV
               gathered dense, each row masked to base + g + 1; (b) G = 1
               against pa_decode at base + 1, both on the card; (c)
               correctness at (QH, KVH, G) = (4, 2, 3), (4, 2, 5), (6, 2,
               3), (32, 8, 16), (32, 8, 64), D 64 and 128, page 8 and 16;
 16. spec_parity — parity (depth 2, fp32, TF32 off, 4 greedy requests of
               32 tokens on ngram-repetitive prompts: a 3-token motif
               repeated) with spec_decode=4 on the
               bucketed engine, the bucketed engine with chunked prefill
               and the ragged engine, fp32 and int8 pools: tokens as in
               parity, something drafted, and the exact launches
               (pa_verify per layer and step and no decode kernel on the
               bucketed engines, no prefill kernel with chunked prefill,
               the ragged kernel per layer and step and no pa_verify on
               the ragged engine; the CPU engine launches nothing);
 17. spec_serve — the serve phase's model and 8 requests of the same
               lengths made ngram-repetitive (`echo_prompts`: a repeated
               motif, the model's own continuation of it, and the motif's
               tail again) through run(): bucketed spec_decode=4 with
               bf16 and int8 pools, bucketed spec_decode=16 with chunked
               prefill, and ragged spec_decode=4; output tok/s, the
               median verify step
               (one `_spec_step` that fed no prompt chunk, host clock),
               prefill tok/s, device steps, drafted and accepted tokens,
               the launches of every kernel, beside bucket_serve's plain
               decode numbers;
 18. prefix_kernel — the new shapes of the prefix-cache paths against the
               plain versions, fp32, bf16 and int8 pools (bf16 q): (a)
               pa_verify as the bucketed suffix prefill calls it: 8 slots
               at 8B widths in slots of 3072 columns, slot 0 active over
               a cached 1024-token prefix with a suffix of 300 tokens at
               G = 512 and of 1500 at G = 2048, the other slots inactive
               at live and free lengths (every row compared; rows past a
               slot's cap see the cap), with times, `bound_ms`,
               `library_ms` (SDPA over the KV gathered dense, masked),
               and the k tiles held to the split rule's plan; (b) the
               ragged kernel on a wave whose slot 0 feeds 256 prompt
               tokens at 1024-1279 over its cached prefix beside 3 decode
               rows, its tiles held to the plain plan, with times;
 19. prefix_parity — parity (depth 1, the vocabulary cut to 4096 as in
               train_parity, fp32, TF32 off, max_seqs 2, page 16, 11
               pages) with prefix_cache and a 1 GiB host tier
               (verbatim pages) on the ragged engine, the bucketed engine
               and the bucketed spec_decode=4 chunked engine, fp32 and
               int8 pools: three prompts behind a 48-token header, a
               first turn, a burst of four prompts that evicts it, and
               the returning turn restored from the tier; tokens as in
               spec_parity against the CPU engine (the tier-off card
               engine too), cached and prefill tokens equal to the CPU's,
               tier hits, the returning turn prefilling prompt - cached
               tokens, and the exact launches (one pa_verify a layer and
               suffix prefill, no va_fwd or fa_fwd for a hit); then KV
               handoffs from a ragged prefill engine to a ragged decode
               engine on the card (fp32 and int8 pools, tier_quantize
               both ways; an fp32 pool's int8 transfer is lossy and only
               reported) and from the CPU engine to the card, against the
               single engine's tokens, with equal handoff_bytes and both
               pools drained;
 20. prefix_serve — the serve phase's model: (a) the multi-turn workload
               (8 conversations of 1024-token prompts and 32 greedy
               tokens, a burst of 8 more prompts run one at a time, then
               each conversation's returning turn: history + 64 tokens,
               32 greedy tokens) on the ragged engine (max_seqs 4, 257
               pages: 512 MiB of KV) with the tier off, and on (1 GiB,
               int8 and verbatim): the returning turn's prefill tokens
               (failing unless prompt - cached), wall time, median time
               to first token (host clock, submit to seed), the tier's
               spills, hits, drops, copy errors (failing on any) and host
               bytes, and the share of tokens equal to the tier-off run's;
               (b) a shared 1024-token system prompt before 8 user
               suffixes of 64-500 tokens (numpy seed 3), 64 new tokens, on
               the bucketed engine (max_seqs 8), request 0 first and the
               other 7 once it is indexed; cache off and on, bf16 and int8
               pools: prefill tokens, prefill and output tok/s,
               pad_tokens and the suffix prefills' pa_verify launches (one
               a layer each, else the phase fails).

 21. runtime — the serving runtime (`paddle_tpu_torch.serving`) over the
               serve phase's model: (a) ServingServer on 127.0.0.1:0 over
               a RequestScheduler on the ragged bf16 engine (the serve
               phase's settings), the serve phase's 8 prompts (64 new
               tokens, greedy) over HTTP from 8 threads, the even ones
               streamed, all queued while the scheduler is paused: their
               tokens held to a direct eng.run() of the same settings
               (equal, or parting only where the card's top-2 logit
               margin of the common prefix is under 1e-3, counted as
               `partings_at_ties`), 32 ragged launches a device step,
               every metric family of `serving.server.METRIC_NAMES` on
               /metrics (pt_mfu included: the steps were costed), each
               /debug route 200 and the fleet routes 404; it reports
               output tok/s over HTTP and direct, TTFT and TPOT p50 / p95
               and the host gap from the pt_* histograms, pt_mfu and the
               scrape's seconds; (b) on the same server a FaultPlan
               raising at the first step launch (before any token) and
               at the step finish that would consume request 0's first
               decode row (mid-run: request 0 has its first token): the
               requests finish with (a)'s direct tokens by the same rule
               or part where the two top logits are within two bf16
               steps (after a crash the scheduler admits the requeued
               requests one at a time, so the waves are not the direct
               run's), 2 restarts, the breaker closed; then a crash while
               request 0 streams fails request 0 and no other (the
               others' tokens reported against the direct run's); (c) a
               Router (round robin) over a ragged and a bucketed bf16
               replica sharing the weights, pipelined pump: each routed
               request held to a direct run of its replica's engine
               kind, each replica's launches its engine's counts, and
               the requests per replica. The output tok/s compared with HTTP's is a second
               direct run's (the first warms the card up), and `pt_mfu`
               counts the step functions' computed rows (a ragged wave's
               whole 256-row buffer), as the reference's XLA count does.

 22. fleet   — the fleet plane (`serving/fleet.py`, `wire.py`,
               `distributed/rpc.py`) on the serve phase's model: (a) a
               FleetPlane on 127.0.0.1 over two in-process FleetWorkers
               sharing the weights, a prefill worker on the ragged bf16
               engine and a decode worker on the bucketed bf16 engine
               (the serve phase's pools, pipelined pumps, int8 handoffs),
               a Router over the plane's replicas: the 8 prompts migrate
               over the bulk socket (8 handoffs, 8 handoff serves, 32
               ragged launches a prefill step and 32 pa_decode launches
               a decode step, nothing else), each stream held by
               runtime's tie rule to an in-process Router over local
               Replicas of the same engines; output tok/s of both, TTFT
               p50 / p95 (submit to first chunk), handoff bytes a
               request, pt_handoff_seconds p50 / p95 and the socket hop's
               seconds and GB/s; (b) a prefill and a decode worker
               spawned as `python -m paddle_tpu_torch.serving.fleet` on
               the card at 8B widths, depth cut to 2 layers (each
               child's seeded weights), the router here: 3 prompts held
               to an in-process Router over engines built here from the
               same spec; the children load every kernel library from
               the build cache, import neither jax nor paddle_tpu, and
               exit 0 after drain; (c) the global prefix cache: two
               "both" workers (ragged, prefix cache, int8 tiers; A's 16
               pages) where A's budget drops land at their ring owner B
               and a short match on A fetches them back; its tokens held
               to one engine whose own tier restores the same pages;
               pages and bytes spilled and fetched, fetch seconds,
               prefill tokens saved;
 23. varlen_kernel — the varlen dQ and dK/dV kernels against their plain
               versions: (a) at the packed row of train_packed (eight
               documents of 192-3000 tokens in 8192; QH=32 over KVH=8,
               D=128, causal, same offsets), bf16 and fp32, with times
               and the tiles each computed per head, which must equal the
               skip rule's count; `bound_ms` counts the kept pairs
               exactly (6 flops per pair and head dim for dQ, 8 for
               dK/dV) against each operand byte once; `library_ms` is
               F.scaled_dot_product_attention (is_causal) per document,
               forward + backward minus forward, summed; the ported
               FlashMask dQ and dK/dV on the same row (the same mask from
               doc_end_indices) are timed beside them as a yardstick;
               the forward va_fwd on the same row, against its plain
               version, with its tiles held to the skip rule, timed
               against F.scaled_dot_product_attention's forward per
               document and the ported FlashMask forward (`fm_fwd`) on
               the same row, with `design`, `library_factor` and
               `bound_share` (a bf16 factor over 6 fails); the dQ and
               dK/dV rows carry `design`, `library_factor` and
               `bound_share` too (bf16 runs the tensor-core loops of
               attn_bwd_sm90.cuh with the varlen policy, and a factor
               over 4 fails), and `kernel_only_ms`, the device time of
               the kernel alone from torch.profiler (the wrapper's time
               also holds va_positions, the tile ranges and, for bf16
               with D not a multiple of 8, the pad); the dK/dV row gives
               the pair's factor over the SDPA backward
               (`pair_library_factor`) and over the FlashMask pair
               (`pair_flashmask_factor`); (b)
               correctness on ragged token axes of 700-1000: unequal q/k
               offsets (no diagonal skip), causal and not, trailing pads
               on both sides, a query segment that sees nothing (dQ = 0)
               and a key segment nobody sees (dK = dV = 0), GQA groups 1
               and 4, D=64 and 128, bf16 and fp32; (c) flash_attn_unpadded
               on (a)'s row with autograd, bf16, against the plain
               versions on the card: exactly one va_fwd, one va_bwd_dq
               and one va_bwd_dkv (the launches the kernels line reports
               for the two);
 24. fused_parity — packed_parity's setup with a vocabulary of 12,000
               (two 8192-column chunks, the second short): two steps card
               against CPU with fused_ce=True, and again with
               remat="dots"; the card's fused losses against its losses
               through the full logits;
 25. train_fused — train_packed's model and row with fused_ce=True and
               remat="dots": the same measurements, and the first loss
               against the full-logits loss of the same seed weights and
               batch (train_packed's first loss), within a bf16
               tolerance.

 26. parallel_parity — hybrid-parallel training (`make_train_step` on a
               rank mesh): Llama-3-8B widths at 2 layers (the interleaved
               layout at 4: pp 2 x vpp 2 needs L % 4 == 0; its
               reference is a third run) with the vocabulary cut to 4096, fp32,
               TF32 off, remat, train_parity's batch 2 x 512 (seed 3)
               and packed_parity's rows for doc_ids; two steps of each
               layout on 2 ranks (dp 2, dp 2 + doc_ids, tp 2, pp 2 with
               gpipe, 1f1b and interleave at vpp 2, sp 2 ring and
               Ulysses) and on 4 (dp 2 x tp 2), each rank's shards held
               by `_step_parity`'s rules to the single-rank step on the
               card from the same `init_params(seed=0)` (computed once
               a batch by this process before the ranks start; the
               ranks map it from a file), the step-1 gradients being
               the ones each rank's step hands AdamW, and each rank's
               launches of rows 3-5 (6-8 with doc_ids) equal to what its
               layers, microbatches and steps imply (none for the
               ring);
 27. parallel — the train phase's bf16 model at 8B widths (tp 2 at 4
               layers; pp 2 with 1f1b and sp 2 with Ulysses at 2, dp 2 at
               1: depths cut to pay for the layer phases), batch 2 x 2048
               (seed 4), 4 steps each: finite, falling losses, median
               step (steps 2-4) and global tokens/s, each rank's peak
               memory, collective bytes, calls and host seconds a step
               (`distributed/collective.py`'s counters) and launches of
               rows 3-5 (checked as in parallel_parity).
               The ranks of both phases are spawned once per world size
               (`distributed/launch.spawn`, a deadline each; a failed
               rank fails the phase): one card a rank over NCCL when the
               machine has enough, else all on card 0 over gloo, every
               collective staged through the host; each row gives
               `backend` and `ranks_per_card`.
 28. tp_parity — tensor-parallel serving (`ServingEngine(...,
               mesh=create_mesh({"tp": 2}))`, two ranks): spec_parity's
               model (8B widths, 2 layers, fp32, TF32 off), prompts and
               32 new tokens on the bucketed engine (3 slots: one
               prefill_varlen wave and one lone prefill), with
               speculative decoding (G = 4: verify_step) and without
               (decode_step), fp32 and int8 pools, the tp engine (each
               rank keeping its shard of the same full weights) against
               the single-rank card engine on each rank: tokens
               identical or parting only where the single-rank model's
               top-2 margin is under 1e-3, logprobs within the stated
               tolerance of each pool (TP_PARITY_LP_ATOL), which a
               control (the single-rank engine with bf16 weights and
               pool) must exceed; with int8 pools each rank's K / V
               codes at most one code from the single-rank engine's
               (those that differ counted); the ranks alike, each rank's
               pool cut to its 4 KV heads and its launches of rows 3, 9
               and 12 / 13 or 14 / 14q those its calls and steps imply;
               on rank 0, pa_decode and pa_verify at the local heads (16
               over 4) against their plain versions, bf16 and int8;
 29. tp_serve — the serve phase's model (the same seeded bf16 weights,
               each leaf cut to the rank's shard as it is drawn) and
               bucket_serve's 8 requests on a tp 2 bucketed engine,
               bf16 and int8 pools, run_pipelined: 8 x 64 tokens, the
               ranks alike, launches as bucket_serve's on every rank.
               Then, untimed, the same requests teacher-forced along
               bucket_serve's streams (`serving_capture.StepLogits`), so
               that each of the 512 rows of logits is drawn from the
               context bucket_serve's was: those rows may differ from
               bucket_serve's by at most TP_YARDSTICK times what serve's
               ragged engine's first tokens' differ (one rank, other
               shapes: the rounding noise of a second single-rank
               engine), at most and on average. Where the free-running
               streams part, and the greedy rows where the forced
               engine's own pick is not bucket_serve's token (with each
               engine's lead in bf16 steps), are reported.
               It reports output tok/s, the median decode step, prefill
               tok/s, each rank's peak memory, the collectives' bytes,
               calls and host seconds a decode step and to the first
               finish. Both run in parallel_spawn's world of 2 (their
               ranks share the card over gloo: not a scaling figure),
               after the serve phases (tp_serve runs serve and
               bucket_serve too), whose engines must leave under 1 GB
               allocated in this process (`serve_block`).
30. layer_parity — the Paddle-shaped surface: the Layer-tree
               `LlamaForCausalLM` at 8B widths, depth cut to 1,
               vocabulary cut to 4096, fp32, TF32 off, batch 1 x 256,
               drawn on the card after `paddle.seed(0)` and copied to
               the CPU; 3 steps of `paddle.optimizer.AdamW` with
               `ClipGradByGlobalNorm(1.0)` and a `LinearWarmup` (1e-4 to
               3e-4) on the card and on the CPU, held to train_parity's
               limits (parameters to 2.5 x the summed lr); fa_fwd,
               fa_bwd_dq and fa_bwd_dkv once a layer a step each (no
               remat), nothing on the CPU. Then `F.flash_attn_unpadded`
               and `F.flashmask_attention` through Tensors on the card
               (fp32, 2048 tokens of 3 documents, 32 / 8 heads, D 128),
               forward and backward once each, against their plain
               versions on the same card tensors (1e-4), one launch of
               each kernel;
31. layer_train — the bf16 Layer tree (`model.bfloat16()`,
               `AdamW(multi_precision=True)`, clip 1.0) at 8B widths,
               depth 4, full vocabulary, 6 steps on 2 x 2048 tokens: the
               loss must fall, the flash kernels once a layer a step;
               tokens/s (median of steps 2-6) and the peak beside the
               train phase's (run `train` with it for those);
32. layer_parallel_parity — the parallel layer surface, in
               parallel_spawn's world of 2 (ranks sharing the card over
               gloo): the Layer-tree Llama at 8B widths, depth 2,
               vocabulary 4096, fp32, TF32 off, batch 2 x 256, 2 steps
               of `parallel.Trainer` (AdamW, grad_clip_norm 1.0) in four
               layouts, (a) tp 2 through `fleet.init(mp_degree=2)` and
               `fleet.distributed_model`, (b) dp 2 through
               `DataParallel`, (c) dp 2 with `group_sharded_parallel`
               "os_g", (d) "p_g_os", each held to the single-rank
               Trainer (run once in this process before the spawn) by
               train_parity's limits (losses, the step-1 gradients and
               the parameters, gathered whole); rows 3-5 once a layer a
               step on every rank. (e) `MoELayer` at Mixtral-8x7B's
               block widths (4096, FFN 14336, 8 experts, top 2, capacity
               factor 1.0), fp32, 512 tokens, on ep 2 against one rank:
               the output and every gradient within train_parity's
               gradient limit, the aux loss within 1e-6, the same
               assignments dropped (at least one). (f) `PipelineLayer`
               of eight LayerDesc(nn.Linear, 4096, 4096) staged on pp 2
               against the same layers in sequence (output, input and
               the rank's layers' gradients, the same limit);
33. layer_parallel — layer_train's model (bf16, multi_precision AdamW,
               clip 1.0) at depth 2 and full vocabulary on tp 2 through
               `fleet.init` and the Trainer, 6 steps on 2 x 2048 tokens
               in the world of 2: the loss must fall, rows 3-5 once a
               layer a step on each rank; global tokens/s (median of
               steps 2-6) beside layer_train's and the parallel phase's
               functional tp 2, each rank's peak, the collectives'
               calls, bytes and host seconds a rank and step.
34. family_kernel — rows 3-5 at the wide heads the decoder families
               run, bf16 and fp32: timed (as train_kernel, the causal
               half counted) at D = 192, DeepSeek's MLA training shape
               (B=2, H=32, S=2048), and at D = 256 (B=2, H=16, S=2048),
               each row with `design`, `library_factor`, `bound_share`
               (no library-factor limit at these widths) and its
               instantiation's registers and spill bytes (`ptxas`);
               then correctness against the plain versions at head dims
               136, 192, 200 and 256, causal and not, one query row
               against 64 and 1500 keys without causal (GPT-2's cached
               step) at 64 and 192, and the FlashMask and varlen kernels
               at 192 and 256 on packed documents and a ragged axis;
35. family_parity — the decoder families on the card against the CPU,
               fp32, TF32 off, from the same weights (drawn on the card
               after paddle.seed(0), copied): Qwen2 at qwen2_7b()
               widths, 1 layer, vocabulary 4096; GPT-2 at GPT2Config()
               widths, 2 layers; the MoE LLM at MoEConfig() widths, 1
               layer, vocabulary 4096; DeepSeek at DeepSeekConfig()
               widths, 2 layers (one dense, one MoE), vocabulary 4096;
               batch 1 x 128: the logits, 16 greedy tokens from a
               32-token prompt (GPT-2's KV-cached decode, Qwen2's eager
               loop) identical, then 2 of layer_parity's steps
               under train_parity's limits, rows 3-5 launched as the
               forwards and steps imply; and models.llama_decode at
               llama3_8b widths (1 layer, vocabulary 4096): the prefill's
               and a step's logits and make_generate's 16 greedy tokens;
36. family_run — (a) DeepSeek at DeepSeekConfig() widths, 2 layers
               (1.71 B parameters), bf16 as layer_train trains it, 6
               steps on 2 x 2048 tokens: the loss must fall and rows 3-5
               launch once a layer a step at D = 192; median step,
               tokens/s, peak memory; (b) GPT-2 small (12 layers, bf16)
               generating 64 greedy tokens for 8 prompts of 64 through
               its KV-cached decode: output tokens/s and fa_fwd's
               launches (one query row a layer a step).

After the phases, one line gives each phase's wall seconds
(`phase_seconds`; the serve phases' shared 8B parameters are built
outside them; the spawned ranks of the parallel and tp phases are
`parallel_spawn`). The line before the last lists every kernel with its
launches on the main path, its error against the plain version and its
times, the launches prefix_serve added (`prefix_launches`), the
launches of the runtime phase's runs (`runtime_launches`), those of
the fleet phase's in-process workers (`fleet_launches`), each rank's
launches in each layout of the parallel phases for rows 3-8
(`parallel_launches`), each rank's launches in each run of the tp
phases for rows 3, 9 and 12-14q (`tp_launches`), the Layer-tree
Llama's (`layer_launches`: layer_train's for rows 3-5, layer_parity's
entry points' for rows 6-11), each rank's launches of rows 3-5 under
the Trainer in the layer phases' layouts (`layer_parallel_launches`),
the decoder families' launches of rows 3-5 (`family_launches`; rows 3-5
also appear at D = 192, `*_d192`, with family_run's DeepSeek launches)
and, for the ragged and verify rows,
prefix_kernel's shapes (`prefix_kernel`); the last line is {"ok": true,
"device": {...}}.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import math
import os
import shutil
import statistics
import subprocess
import sys
import tempfile
import time

PHASES = ("device", "build", "kernel", "parity", "serve", "train_kernel",
          "train_parity", "train", "mask_kernel", "packed_parity",
          "train_packed", "bucket_kernel", "bucket_parity", "bucket_serve",
          "spec_kernel", "spec_parity", "spec_serve", "prefix_kernel",
          "prefix_parity", "prefix_serve", "runtime", "fleet",
          "varlen_kernel", "fused_parity", "train_fused", "parallel_parity",
          "parallel", "tp_parity", "tp_serve", "layer_parity", "layer_train",
          "layer_parallel_parity", "layer_parallel", "family_kernel",
          "family_parity", "family_run")
SOURCES = ("ragged_paged_attention", "flash_attention", "flashmask_attention",
           "varlen_attention", "paged_attention")
HBM_BYTES_PER_S = 3.35e12       # H100 SXM data sheet
PEAK_FLOPS = {"float32": 67e12, "bfloat16": 989e12}  # fp32 CUDA cores; bf16 dense
TPU_KERNEL = "paddle_tpu/kernels/ragged_paged_attention.py:185"
FLASH_TPU_KERNELS = {"flash_fwd": "paddle_tpu/ops/flash_attention.py:107",
                     "flash_bwd_dq": "paddle_tpu/ops/flash_attention.py:220",
                     "flash_bwd_dkv": "paddle_tpu/ops/flash_attention.py:277"}
FLASHMASK_TPU_KERNELS = {
    "flashmask_fwd": "paddle_tpu/ops/flashmask_attention.py:248",
    "flashmask_bwd_dq": "paddle_tpu/ops/flashmask_attention.py:305",
    "flashmask_bwd_dkv": "paddle_tpu/ops/flashmask_attention.py:353"}
# the bucketed serving kernels: name -> (source, TPU kernel, the
# bucket_kernel row that times it, the bucket_serve run that counts it)
BUCKET_KERNELS = {
    "varlen_fwd": ("varlen_attention",
                   "paddle_tpu/ops/varlen_attention.py:92",
                   ("varlen_fwd", "bfloat16"), "bf16"),
    "paged_decode": ("paged_attention",
                     "paddle_tpu/ops/paged_attention.py:109",
                     ("paged_decode", "bfloat16"), "bf16"),
    "paged_decode_int8": ("paged_attention",
                          "paddle_tpu/ops/paged_attention.py:159",
                          ("paged_decode_int8", "int8"), "int8")}
# the paged verify kernel: name -> (spec_kernel row, spec_serve run)
SPEC_KERNELS = {
    "paged_verify": ("paddle_tpu/ops/paged_attention.py:284", "bfloat16",
                     "bucketed_g4_bf16"),
    "paged_verify_int8": ("paddle_tpu/ops/paged_attention.py:339", "int8",
                          "bucketed_g4_int8")}
VARLEN_BWD_TPU_KERNELS = {
    "varlen_bwd_dq": "paddle_tpu/ops/varlen_attention.py:213",
    "varlen_bwd_dkv": "paddle_tpu/ops/varlen_attention.py:259"}


def emit(obj):
    print(json.dumps(obj), flush=True)


def fail(msg):
    raise AssertionError(msg)


def cuda_ms(fn, reps, warmup=2):
    """Median milliseconds of fn() over `reps` runs, each bracketed by
    CUDA events."""
    import torch
    for _ in range(warmup):
        fn()
    times = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return statistics.median(times)


# ---------------------------------------------------------------- phases
def phase_device():
    import torch
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]
    name = torch.cuda.get_device_name(0)
    emit({"phase": "device", "nvidia_smi": smi, "torch_device": name,
          "count": torch.cuda.device_count(),
          "torch": torch.__version__, "cuda": torch.version.cuda})
    return smi, name


def _ptxas_kernels(report):
    """Each kernel of an nvcc -Xptxas -v report: its name, shortened from
    the mangled one to the kernel, element type, head dim, mask policy
    and `dropout` for a backward loop instantiated with it
    (`dkv_tc_kernel<128, FmPolicy, dropout>`), its registers and spill
    bytes (stores + loads)."""
    import re
    out, name, spill = [], None, 0
    for ln in report.splitlines():
        m = re.search(r"Function properties for (\S+)", ln)
        if m:
            name, spill = m.group(1), 0
            continue
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads",
                      ln)
        if m and name:
            spill = int(m.group(1)) + int(m.group(2))
            continue
        m = re.search(r"Used (\d+) registers", ln)
        if m and name:
            kern = re.search(r"\d+([A-Za-z_]+_kernel)", name)
            elem = re.search(r"_kernelI(13__nv_bfloat16|f)", name)
            args = [elem and ("bf16" if elem.group(1) != "f" else "f32"),
                    *re.findall(r"Li(\d+)E", name),
                    *re.findall(r"\d+([A-Za-z]+Policy)", name),
                    "Lb1E" in name and "dropout"]
            label = kern.group(1) if kern else name
            if any(args):
                label += "<" + ", ".join(a for a in args if a) + ">"
            out.append({"kernel": label, "registers": int(m.group(1)),
                        "spill_bytes": spill})
            name = None
    return out


def phase_build(card):
    from concurrent.futures import ThreadPoolExecutor
    from paddle_tpu_torch.kernels import _build
    t0 = time.perf_counter()
    with ThreadPoolExecutor(len(SOURCES)) as ex:   # one nvcc per source
        secs = dict(zip(SOURCES, ex.map(_build.build, SOURCES)))
    wall = time.perf_counter() - t0
    for name in SOURCES:
        kernels = _ptxas_kernels(_build.ptxas_report(name))
        emit({"phase": "build", "card": card, "seconds": secs[name],
              "wall_seconds_all_sources": wall,
              "source": str(_build.lib_path(name).name), "ptxas": kernels,
              "tc_spill_bytes": sum(k["spill_bytes"] for k in kernels
                                    if "_tc_kernel" in k["kernel"])})
        spills = [k["kernel"] for k in kernels if k["spill_bytes"]
                  and "_tc_kernel" in k["kernel"]
                  and "dropout" not in k["kernel"]]
        if spills:
            fail(f"{name}: tensor-core kernels without dropout spill: "
                 f"{spills}")


# kernel-phase variants: name -> (pool dtype, q dtype)
VARIANTS = {"float32": ("float32", "float32"),
            "bfloat16": ("bfloat16", "bfloat16"),
            "int8": ("int8", "bfloat16"),
            "int8_fp32q": ("int8", "float32")}
# Kernel vs plain, compared in fp32 over the active rows. fp32 output:
# sums in another order within a page. bf16 output: both sides round
# the same fp32 value to bf16, and a rounding that lands on the other
# side costs one ulp, at most 2^-7 = 7.8e-3 of the value (rtol 8e-3);
# atol 2e-3 covers values near zero. int8 pages dequantize by the same
# fp32 products on both sides, so fp32 q holds them to the fp32 limits.
TOL = {"float32": (1e-5, 1e-4), "bfloat16": (2e-3, 8e-3)}


def _mixed_wave_rows():
    """The mixed wave's rows: (lens, slot, pos) as numpy int32, a
    256-token prefill chunk of slot 0 at positions 512-767, 7 decode rows
    of slots 1-7 at lengths 100-2000, inactive rows up to T = 384."""
    import numpy as np
    T = 384
    lens = [768] + [100, 400, 700, 1000, 1300, 1700, 2000]
    slot = np.zeros(T, np.int32)
    pos = np.full(T, -1, np.int32)
    slot[:256] = 0
    pos[:256] = np.arange(512, 768)
    slot[256:263] = np.arange(1, 8)
    pos[256:263] = np.array(lens[1:]) - 1
    return lens, slot, pos


def _mixed_wave(variant, seed=0, device="cuda", rows=_mixed_wave_rows):
    """The full-width mixed wave, or the wave of `rows()` ((lens, slot,
    pos) as `_mixed_wave_rows` gives them): (q, k, v, ks, vs, ptab, slot,
    pos, info) on `device`."""
    import numpy as np
    import torch
    from paddle_tpu_torch.ops.paged_attention import quantize_kv
    QH, KVH, D, PAGE = 32, 8, 128, 16
    max_len = 2048
    pps = max_len // PAGE
    lens, slot, pos = rows()
    T = len(pos)
    S = len(lens)
    P = S * pps + 1
    rng = np.random.default_rng(seed)
    ptab = rng.permutation(P - 1)[:S * pps].reshape(S, pps).astype(np.int32)
    dev = torch.device(device)
    g = torch.Generator(device=dev)
    g.manual_seed(seed)
    pools, qname = VARIANTS[variant]
    qdt = getattr(torch, qname)
    q = torch.randn((T, QH, D), generator=g, device=dev).to(qdt)
    k = torch.randn((KVH, P, PAGE, D), generator=g, device=dev)
    v = torch.randn((KVH, P, PAGE, D), generator=g, device=dev)
    ks = vs = None
    if pools == "int8":
        k, ks = quantize_kv(k)
        v, vs = quantize_kv(v)
    else:
        k, v = k.to(qdt), v.to(qdt)
    to = {"device": dev}
    info = {"lens": lens, "T": T, "QH": QH, "KVH": KVH, "D": D,
            "PAGE": PAGE, "active": int((pos >= 0).sum())}
    return (q, k.contiguous(), v.contiguous(), ks, vs,
            torch.tensor(ptab, **to), torch.tensor(slot, **to),
            torch.tensor(pos, **to), info)


def _bound(variant, info, pos):
    """Least time for the wave: the bytes it must move over the memory
    rate, or its flops over the peak for q's type. The bytes are the
    unique KV of the touched slots, q of the active rows (an inactive
    row's q is never read: its answer is zeros) and the whole output."""
    import numpy as np
    pools, qname = VARIANTS[variant]
    kv_elem = {"float32": 4, "bfloat16": 2, "int8": 1}[pools]
    q_elem = 4 if qname == "float32" else 2
    toks = sum(info["lens"])
    per_tok = info["KVH"] * info["D"] * kv_elem * 2
    if pools == "int8":
        per_tok += info["KVH"] * 4 * 2                 # fp32 scales
    nbytes = toks * per_tok + ((info["active"] + info["T"]) * info["QH"]
                               * info["D"] * q_elem)
    cols = (np.asarray(pos) + 1).clip(min=0).sum()
    flops = 4 * info["QH"] * info["D"] * int(cols)    # QK^T and PV
    peak = PEAK_FLOPS[qname]
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, flops / peak
    return (max(t_bytes, t_ops) * 1e3,
            "bytes" if t_bytes >= t_ops else "operations", nbytes, flops)


def _dense_kv(pool, scale, ptab, slots, ncols, grp, dtype):
    """(len(slots), QH, ncols, D): the first `ncols` KV columns of each
    slot in `slots`, gathered dense, dequantized and GQA-expanded."""
    kvh, _, page, d = pool.shape
    idx = ptab[slots, :-(-ncols // page)].long()           # (n, pages)
    x = pool[:, idx].reshape(kvh, len(slots), -1, d)
    if scale is not None:
        x = x.float() * scale[:, idx].reshape(kvh, len(slots), -1, 1)
    x = x[:, :, :ncols].to(dtype).permute(1, 0, 2, 3)
    return x.repeat_interleave(grp, dim=1).contiguous()


def _library_call(q, k, v, ks, vs, ptab, slot, pos, info):
    """A closure timing F.scaled_dot_product_attention over the wave's
    real extents: one call per slot with several rows (the prefill
    chunk: its rows over its own columns, causal), one batched call for
    the single-row slots (the decode rows: KV cut to the longest of
    them, each row masked to its length). The dense KV is gathered
    beforehand and not timed."""
    import torch
    import torch.nn.functional as F
    grp = info["QH"] // info["KVH"]
    slot_c, pos_c = slot.cpu(), pos.cpu()
    rows_of = {}
    for i in range(info["T"]):
        if int(pos_c[i]) >= 0:
            rows_of.setdefault(int(slot_c[i]), []).append(i)
    groups = [[s] for s, r in rows_of.items() if len(r) > 1]
    single = [s for s, r in rows_of.items() if len(r) == 1]
    if single:
        groups.append(single)
    calls = []
    for slots in groups:
        if len(slots) == 1:
            rows = torch.tensor(rows_of[slots[0]], device=q.device)
            qd = q[rows].permute(1, 0, 2)[None]            # (1, QH, n, D)
            qpos = pos[rows][None]                          # (1, n)
        else:
            rows = torch.tensor([rows_of[s][0] for s in slots],
                                device=q.device)
            qd = q[rows][:, :, None]                        # (n, QH, 1, D)
            qpos = pos[rows][:, None]                       # (n, 1)
        ncols = int(qpos.max()) + 1
        st = torch.tensor(slots, device=q.device)
        kd = _dense_kv(k, ks, ptab, st, ncols, grp, q.dtype)
        vd = _dense_kv(v, vs, ptab, st, ncols, grp, q.dtype)
        cols = torch.arange(ncols, device=q.device)
        mask = (cols[None, None, :] <= qpos[:, :, None].long())[:, None]
        calls.append((qd.contiguous(), kd, vd, mask))

    def call():
        return [F.scaled_dot_product_attention(qd, kd, vd, attn_mask=mask)
                for qd, kd, vd, mask in calls]
    return call


def phase_kernel(card):
    import torch
    import paddle_tpu_torch.kernels.ragged_paged_attention as rpa
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    out = {}
    for name in VARIANTS:
        q, k, v, ks, vs, ptab, slot, pos, info = _mixed_wave(name)
        kw = {"k_scale": ks, "v_scale": vs}
        ker = rpa.ragged_paged_attention(q, k, v, ptab, slot, pos, **kw)
        torch.cuda.synchronize()
        ref = rpa.ragged_paged_attention_reference(q, k, v, ptab, slot, pos,
                                                   **kw)
        active = pos >= 0
        err = (ker.float() - ref.float()).abs()
        max_err = float(err[active].max())
        atol, rtol = TOL[VARIANTS[name][1]]
        ok = torch.allclose(ker.float()[active], ref.float()[active],
                            atol=atol, rtol=rtol)
        zeros = bool((ker[~active] == 0).all())
        if not ok:
            fail(f"kernel vs plain ({name}): max |err| {max_err}")
        if not zeros:
            fail(f"kernel ({name}): inactive rows are not exactly zero")
        group = info["QH"] // info["KVH"]
        route = rpa.route(q.dtype, k.dtype, info["D"], group)
        tc = route == rpa.TENSOR_CORES
        tiles = plan_tiles = None
        if tc:
            # k tiles computed over the KV heads, against the plain plan's
            _, tiles = rpa._launch(q, k, v, ptab, slot, pos,
                                   info["D"] ** -0.5, ks, vs,
                                   count_tiles=True)
            plan = rpa.ragged_tile_plan(slot.cpu(), pos.cpu(), group,
                                        ptab.shape[1] * info["PAGE"])
            plan_tiles = info["KVH"] * int(plan[:, 2].sum())
            if tiles != plan_tiles:
                fail(f"kernel ({name}): {tiles} k tiles computed, the "
                     f"plan has {plan_tiles}")
        ms = cuda_ms(lambda: rpa.ragged_paged_attention(
            q, k, v, ptab, slot, pos, **kw), reps=20)
        # the wrapper's time holds the plan kernel too (tensor cores);
        # unified_step builds the plan once a step and passes it to every
        # layer's call (`step_plan_ms`)
        kernel_only_ms = _profiled_ms(
            lambda: rpa.ragged_paged_attention(q, k, v, ptab, slot, pos,
                                               **kw),
            ["ragged_tc_kernel" if tc else "ragged_kernel"])
        step_plan_ms = plan_kernel_ms = None
        parts_ms = {"chunk_rows": None, "decode_rows": None}
        if tc:
            splan = rpa.step_plan(q, k, ptab, slot, pos)
            step_plan_ms = cuda_ms(lambda: rpa.ragged_paged_attention(
                q, k, v, ptab, slot, pos, plan=splan, **kw), reps=20)
            plan_kernel_ms = _profiled_ms(
                lambda: rpa.step_plan(q, k, ptab, slot, pos),
                ["ragged_plan_kernel"])
            # the kernel alone on the wave's two parts, the other rows
            # made inactive: which blocks set the wave's time
            chunk = (slot == 0) & (pos >= 0)
            for part, rows in (("chunk_rows", chunk),
                               ("decode_rows", (pos >= 0) & ~chunk)):
                ppos = torch.where(rows, pos, -1).to(torch.int32)
                pplan = rpa.step_plan(q, k, ptab, slot, ppos)
                parts_ms[part] = _profiled_ms(
                    lambda p=ppos, pl=pplan: rpa.ragged_paged_attention(
                        q, k, v, ptab, slot, p, plan=pl, **kw),
                    ["ragged_tc_kernel"])
        plain_ms = cuda_ms(lambda: rpa.ragged_paged_attention_reference(
            q, k, v, ptab, slot, pos, **kw), reps=5, warmup=1)
        lib = _library_call(q, k, v, ks, vs, ptab, slot, pos, info)
        library_ms = cuda_ms(lib, reps=10)
        bound_ms, bound_by, nbytes, flops = _bound(name, info, pos.cpu())
        row = {"phase": "kernel", "card": card, "variant": name,
               "pools": VARIANTS[name][0],
               "q_dtype": str(q.dtype).replace("torch.", ""),
               "T": info["T"], "active_rows": info["active"],
               "atol": atol, "rtol": rtol, "max_abs_err": max_err,
               "inactive_rows_zero": zeros, "route": route,
               "tiles": tiles, "plan_tiles": plan_tiles,
               "kernel_ms": ms, "kernel_only_ms": kernel_only_ms,
               "step_plan_ms": step_plan_ms,
               "plan_kernel_ms": plan_kernel_ms,
               "kernel_only_ms_chunk_rows": parts_ms["chunk_rows"],
               "kernel_only_ms_decode_rows": parts_ms["decode_rows"],
               "plain_ms": plain_ms, "library_ms": library_ms,
               "bound_ms": bound_ms, "bound_by": bound_by,
               "bound_bytes": nbytes, "bound_flops": flops,
               "tf32": False,
               # one launch per layer; the serve phase checks the count
               "launches_per_engine_step": SERVE_LAYERS}
        emit(_design_row(row, "ragged_paged_attention", VARIANTS[name][1]))
        out[name] = row
        del q, k, v, ks, vs, ker, ref, lib
        torch.cuda.empty_cache()
    return out


def _top2_margin(params, cfg, toks, page_size, with_top=False):
    """The top-2 logit margin for the token after `toks`, from one
    forward where `params` live (the CPU engine's, or the card's), the
    pools in the parameters' dtype; with `with_top`, (margin, top
    logit)."""
    import torch
    from paddle_tpu_torch.models.llama_serving import unified_step
    dev, dtype = params["embed"].device, params["embed"].dtype
    n = len(toks)
    pages = -(-n // page_size)
    hd = cfg.hidden_size // cfg.num_attention_heads
    shape = (cfg.num_hidden_layers, cfg.num_key_value_heads, pages + 1,
             page_size, hd)
    kp = torch.zeros(shape, dtype=dtype, device=dev)
    vp = torch.zeros(shape, dtype=dtype, device=dev)
    ptab = torch.arange(pages, dtype=torch.int32, device=dev)[None]
    logits = unified_step(
        params, kp, vp, ptab,
        torch.tensor(toks, dtype=torch.int32, device=dev),
        torch.zeros(n, dtype=torch.int32, device=dev),
        torch.arange(n, dtype=torch.int32, device=dev), cfg, page_size,
        need_rows=torch.tensor([n - 1], dtype=torch.int32, device=dev))
    top = torch.topk(logits[0].float(), 2).values
    margin = float(top[0] - top[1])
    return (margin, float(top[0])) if with_top else margin


# parity's and bucket_parity's depth: their CPU engines' steps are most of
# their time, and the depth-2 engines stay held by spec_parity and
# tp_parity (cut from 2 to pay for the tp phases' repair, PERF.md §4)
PARITY_LAYERS = 1


def phase_parity(card):
    import numpy as np
    import torch
    import paddle_tpu_torch.kernels.ragged_paged_attention as rpa
    from paddle_tpu_torch.models.llama import LlamaConfig
    from paddle_tpu_torch.models.llama_spmd import init_params
    from paddle_tpu_torch.models.llama_serving import Request, ServingEngine
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cfg = dataclasses.replace(LlamaConfig.llama3_8b(),
                              num_hidden_layers=PARITY_LAYERS)
    cpu_params = init_params(cfg, seed=0, dtype=torch.float32, device="cpu")
    gpu_params = {k: ({kk: vv.cuda() for kk, vv in v.items()}
                      if isinstance(v, dict) else v.cuda())
                  for k, v in cpu_params.items()}
    rng = np.random.default_rng(1)
    lens = [17, 90, 180, 300]
    prompts = [rng.integers(0, cfg.vocab_size, n).tolist() for n in lens]
    results, info = {}, {}
    for dev, params in (("cuda", gpu_params), ("cpu", cpu_params)):
        eng = ServingEngine(params, cfg, max_seqs=4, max_seq_len=512,
                            page_size=16, ragged_tokens=64, device=dev)
        for i, p in enumerate(prompts):
            eng.submit(Request(i, p, max_new_tokens=16))
        rpa.launches = 0
        t0 = time.perf_counter()
        done = eng.run()
        if dev == "cuda":
            torch.cuda.synchronize()
        info[dev] = {"seconds": time.perf_counter() - t0,
                     "device_steps": eng.device_steps,
                     "launches": rpa.launches}
        if len(done) != 4 or not eng.pool.conserved(drained=True):
            fail(f"parity ({dev}): {len(done)} of 4 finished or pool leaked")
        results[dev] = {r.rid: list(r.output) for r in done}
    want = cfg.num_hidden_layers * info["cuda"]["device_steps"]
    if info["cuda"]["launches"] != want:
        fail(f"parity: {info['cuda']['launches']} kernel launches, "
             f"want layers x device steps = {want}")
    if info["cpu"]["launches"] != 0:
        fail("parity: the CPU engine launched the CUDA kernel")
    compared = {}
    for rid, p in enumerate(prompts):
        a, b = results["cuda"][rid], results["cpu"][rid]
        j = next((i for i, (x, y) in enumerate(zip(a, b)) if x != y), None)
        if j is None:
            compared[rid] = {"identical": len(a), "stopped_at": None}
            continue
        margin = _top2_margin(cpu_params, cfg, p + b[:j], 16)
        if margin >= 1e-3:
            fail(f"parity: request {rid} diverges at token {j} with CPU "
                 f"top-2 margin {margin}")
        compared[rid] = {"identical": j, "stopped_at": j,
                         "cpu_top2_margin": margin}
    emit({"phase": "parity", "card": card, "config": "llama3_8b widths, "
          f"{PARITY_LAYERS} layer(s), fp32, TF32 off", "prompt_lens": lens,
          "new_tokens": 16, "requests": compared,
          "launches": info["cuda"]["launches"],
          "device_steps": info["cuda"]["device_steps"],
          "cuda_seconds": info["cuda"]["seconds"],
          "cpu_seconds": info["cpu"]["seconds"]})
    del gpu_params
    torch.cuda.empty_cache()


# the serve phases' depth: Llama-3-8B's 32 layers cut to 16 to pay for
# the parallel layer phases, then to 8 for the decoder family phases
# (PERF.md §4); every width is the 8B model's
SERVE_LAYERS = 8
SERVE_CONFIG = (f"llama3_8b widths, {SERVE_LAYERS} layers, bf16 random "
                "weights (seed 0)")


def serve_config():
    """The serve phases' model configuration: Llama-3-8B's widths at
    SERVE_LAYERS layers."""
    from paddle_tpu_torch.models.llama import LlamaConfig
    return dataclasses.replace(LlamaConfig.llama3_8b(),
                               num_hidden_layers=SERVE_LAYERS)


def serve_params():
    """The serve phase's model: Llama-3-8B at full width (SERVE_LAYERS
    deep), bf16 random weights from seed 0, on the card. Returns
    (config, params)."""
    import torch
    from paddle_tpu_torch.models.llama_spmd import init_params
    cfg = serve_config()
    return cfg, init_params(cfg, seed=0, dtype=torch.bfloat16,
                            device="cuda")


def _serve_rng():
    """The serve phases' numpy generator: 8 prompt lengths in 64-1500
    come first, then the prompts' tokens. Returns (rng, lengths)."""
    import numpy as np
    rng = np.random.default_rng(2)
    return rng, rng.integers(64, 1501, 8).tolist()


def _motif_prompts(rng, vocab, lens):
    """ngram-repetitive prompts, as bench_models.py's spec workload makes
    them: a 3-token motif repeated to each length."""
    out = []
    for n in lens:
        motif = rng.integers(1, vocab, 3).tolist()
        out.append((motif * (n // 3 + 1))[:n])
    return out


def echo_prompts(cfg, params):
    """The spec phases' ngram-repetitive traffic on the serve phase's
    model: 8 prompts of the serve phase's lengths, each a repeated 3-token
    motif (the base), then S, the model's own 16-token greedy
    continuation of the base, then the base's last 8 tokens again. The
    prompt's end then repeats text that S followed earlier, the pattern
    prompt lookup drafts from (a request quoting or editing its context).
    A random-weight model does not continue a repeated motif, so motif
    prompts alone give no drafts; S is computed by the plain bucketed
    engine on the card."""
    from paddle_tpu_torch.models.llama_serving import Request, ServingEngine
    rng, lens = _serve_rng()
    bases = _motif_prompts(rng, cfg.vocab_size, [n - 24 for n in lens])
    eng = ServingEngine(params, cfg, max_seqs=8, max_seq_len=2048,
                        page_size=16, ragged=False, device="cuda")
    for i, b in enumerate(bases):
        eng.submit(Request(i, b, max_new_tokens=16))
    cont = {r.rid: list(r.output) for r in eng.run()}
    return [b + cont[i] + b[-8:] for i, b in enumerate(bases)]


def serve_engine(cfg, params, cache_dtype, new_tokens=64, ragged=True,
                 prompts=None, **engine_kw):
    """The serve phase's engine with its 8 requests submitted: prompts
    of 64-1500 tokens (numpy seed 2), or `prompts`, requests 0 and 1
    sampled (temperature 0.8, top_k 50, seed = rid), the rest greedy;
    ragged, or bucketed with `ragged=False`; `engine_kw` overrides the
    engine's other arguments. Returns (engine, requests)."""
    from paddle_tpu_torch.models.llama_serving import ServingEngine
    kw = dict(max_seqs=8, max_seq_len=2048, page_size=16, ragged_tokens=256,
              ragged=ragged, cache_dtype=cache_dtype, device="cuda")
    kw.update(engine_kw)
    eng = ServingEngine(params, cfg, **kw)
    reqs = serve_requests(cfg, new_tokens, prompts)
    for r in reqs:
        eng.submit(r)
    return eng, reqs


def serve_requests(cfg, new_tokens=64, prompts=None):
    """serve_engine's 8 requests, not yet submitted."""
    from paddle_tpu_torch.models.llama_serving import Request
    if prompts is None:
        rng, lens = _serve_rng()
        prompts = [rng.integers(0, cfg.vocab_size, n).tolist() for n in lens]
    return [Request(i, p, max_new_tokens=new_tokens,
                    **({"temperature": 0.8, "top_k": 50, "seed": i}
                       if i < 2 else {}))
            for i, p in enumerate(prompts)]


def phase_serve(card, cfg, params, init_s):
    import torch
    import paddle_tpu_torch.kernels.ragged_paged_attention as rpa
    from paddle_tpu_torch.models.serving_capture import StepLogits
    runs = {}
    for cache in (None, "int8"):
        eng, reqs = serve_engine(cfg, params, cache)
        lens = [len(r.prompt) for r in reqs]
        marks = []
        finish = eng.step_finish

        def timed_finish(ticket, inflight=None, _finish=finish):
            n = _finish(ticket, inflight=inflight)
            marks.append((time.perf_counter(),
                          len(ticket.flat) == len(ticket.slots)))
            return n
        eng.step_finish = timed_finish
        # the seed rows, the ragged engine's logits at each prompt's end
        # (a dict entry a token on the host, nothing read from the card)
        drawn = StepLogits(eng)
        torch.cuda.synchronize()
        rpa.launches = 0
        t0 = time.perf_counter()
        try:
            done = eng.run_pipelined()
        finally:
            # the methods again: no cycle left
            del eng.step_finish
            drawn.close()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = rpa.launches
        name = "bf16" if cache is None else "int8"
        if len(done) != 8:
            fail(f"serve ({name}): {len(done)} of 8 requests finished")
        for r in done:
            if len(r.output) != 64:
                fail(f"serve ({name}): request {r.rid} has "
                     f"{len(r.output)} tokens, want 64")
            if not all(0 <= t < cfg.vocab_size for t in r.output):
                fail(f"serve ({name}): request {r.rid} left the vocabulary")
        if launches != cfg.num_hidden_layers * eng.device_steps:
            fail(f"serve ({name}): {launches} kernel launches, want "
                 f"{cfg.num_hidden_layers} x {eng.device_steps}")
        if not eng.pool.conserved(drained=True):
            fail(f"serve ({name}): page pool not conserved")
        last_prefill = max((t for t, dec in marks if not dec), default=t0)
        gaps = [b[0] - a[0] for a, b in zip(marks, marks[1:])
                if a[1] and b[1]]
        row = {"phase": "serve", "card": card, "pool": name,
               "config": SERVE_CONFIG,
               "prompt_lens": lens, "new_tokens": 64, "sampled": [0, 1],
               "wall_s": wall, "device_steps": eng.device_steps,
               "prefill_tokens": eng.prefill_tokens,
               "prefill_tok_s": eng.prefill_tokens / (last_prefill - t0),
               "decode_step_ms_median": (statistics.median(gaps) * 1e3
                                         if gaps else None),
               "output_tok_s": 8 * 64 / wall, "launches": launches,
               "launches_per_step": launches / eng.device_steps,
               "params_init_s": init_s}
        emit(row)
        runs[name] = dict(row, seeds=drawn.seeds)
        del eng, drawn
        torch.cuda.empty_cache()
    return runs


# ------------------------------------------------------------- training
TRAIN_ATTN = {"B": 2, "H": 32, "S": 2048, "D": 128}
FLASH_KERNELS = ("flash_fwd", "flash_bwd_dq", "flash_bwd_dkv")
# Kernel vs plain, by dtype, as TOL above. fp32: the CUDA-core kernels and
# the plain versions compute in fp32 from the same operands and sum in
# another order. bf16: the flash kernels multiply on the tensor cores, S
# and dP from the bf16 operands exactly, and P (forward, dV) and dS (dQ,
# dK) split into two bf16 terms, 16 bits of each (one term, the TPU
# kernel's cast of P to V's dtype, moved forward rows that see few keys
# by up to two ulps); so they differ from the fp32 plain versions by sums
# in another order and 2^-17 of P and dS before the outputs round to bf16:
# one ulp apart at most; so do the FlashMask and varlen kernels. lse is
# fp32 on both sides.
LSE_TOL = (1e-5, 1e-5)
# The design of each kernel row (`design`), and the most a bf16 kernel on
# the tensor cores may take over its library call (`library_factor`): the
# CUDA-core designs ran the forward at 28x and the flash backward at 8.4x
# (dQ) and 9.6x (dK/dV) the SDPA backward; the tensor-core ones must show
# they ran.
FWD_DESIGN = {"bfloat16": "tensor cores: mma.sync m16n8k16, cp.async K/V "
                          "ring of 2, P as bf16 hi + lo",
              "float32": "cuda-core fp32"}
BWD_DESIGN = ("tensor cores: mma.sync m16n8k16, cp.async ring of 2 (K/V for "
              "dQ; Q, dO, lse, delta for dK/dV), P and dS as bf16 hi + lo")
TC_BWD_KERNELS = ("flash_bwd_dq", "flash_bwd_dkv", "flashmask_bwd_dq",
                  "flashmask_bwd_dkv", "varlen_bwd_dq", "varlen_bwd_dkv")
MAX_FWD_LIBRARY_FACTOR = 6.0
MAX_BWD_LIBRARY_FACTOR = 4.0
# the ragged kernel's tensor-core route (bf16 q over bf16 or int8 pages);
# the CUDA-core design ran at 9.2x (bf16) and 8.0x (int8) its SDPA
# yardstick
RAGGED_DESIGN = ("tensor cores: a device work plan of tiles of one run "
                 "(64 / group tokens x the group's heads), K/V gathered "
                 "through the page table by cp.async (ring of 3; int8 "
                 "widened to bf16 in shared memory, scales folded in "
                 "fp32), mma.sync m16n8k16, P as bf16 hi + lo")
MAX_RAGGED_LIBRARY_FACTOR = 2.0
# the paged decode and verify kernels' tensor-core route (bf16 q over bf16
# or int8 pages); the CUDA-core design ran at 1.4-2.4x its SDPA yardstick
PAGED_KERNELS = ("paged_decode", "paged_decode_int8", "paged_verify",
                 "paged_verify_int8")
PAGED_DESIGN = ("tensor cores: a sequence's columns split over blocks (S = "
                "384 columns while B x KVH x row tiles < 2 x SMs and the "
                "splits' fp32 partials fit 16 MiB) and merged "
                "by a second kernel, each block the ragged kernel's tile "
                "loop (paged_tc_sm90.cuh: K/V gathered through the page "
                "table by cp.async, ring of 3; int8 widened to bf16 in "
                "shared memory, scales folded in fp32; mma.sync m16n8k16, "
                "P as bf16 hi + lo)")
MAX_PAGED_LIBRARY_FACTOR = 1.0


def _design_row(row, kname, dname, enforce=True):
    """Add `design`, `library_factor` and `bound_share` to a kernel row;
    with `enforce`, fail a bf16 tensor-core kernel slower than its limit
    (MAX_FWD_LIBRARY_FACTOR, MAX_BWD_LIBRARY_FACTOR,
    MAX_RAGGED_LIBRARY_FACTOR, MAX_PAGED_LIBRARY_FACTOR) x its library
    call."""
    bf16 = dname == "bfloat16"
    limit = None
    row["design"] = FWD_DESIGN["float32"]
    if kname == "ragged_paged_attention":
        if row["route"] == "tensor_cores":
            row["design"], limit = RAGGED_DESIGN, MAX_RAGGED_LIBRARY_FACTOR
    elif kname in PAGED_KERNELS:
        if row["route"] == "tensor_cores":
            row["design"], limit = PAGED_DESIGN, MAX_PAGED_LIBRARY_FACTOR
    elif bf16 and kname.endswith("_fwd"):
        row["design"], limit = FWD_DESIGN[dname], MAX_FWD_LIBRARY_FACTOR
    elif bf16 and kname in TC_BWD_KERNELS:
        row["design"], limit = BWD_DESIGN, MAX_BWD_LIBRARY_FACTOR
    row["library_factor"] = row["kernel_ms"] / row["library_ms"]
    row["bound_share"] = row["bound_ms"] / row["kernel_ms"]
    if enforce and limit is not None and row["library_factor"] > limit:
        fail(f"{kname} (bf16): {row['kernel_ms']} ms, "
             f"{row['library_factor']:.2f}x its library call: the "
             "tensor-core kernel did not run at its speed")
    return row


def _paged_row(call, kname, variant, q, k, lims, n_tok, bound_ms,
               cap=None):
    """The design fields of a pa_decode / pa_verify row: the route; on
    the tensor-core route the k tiles and working blocks the kernel
    counted, held to `paged_split_plan`'s, the split, the grid's blocks,
    the attention and merge kernels' device time alone (`kernel_only_ms`,
    their sum, and `merge_ms` apart), its share of `bound_ms` and the
    workspace's bytes; on the CUDA-core route the kernel alone and its
    grid (B x KVH blocks: one row tile at these shapes). `call(**kw)`
    runs the wrapper's launch (`pa._launch` or `pa._launch_verify`) on
    slots of `cap` tokens (DECODE_SHAPE's by default)."""
    import paddle_tpu_torch.ops.paged_attention as pa
    qh, kvh, d = q.shape[1], k.shape[0], q.shape[-1]
    route = pa.route(q.dtype, k.dtype, d, qh // kvh)
    if route != pa.TENSOR_CORES:
        name = "verify_kernel" if "verify" in kname else "decode_kernel"
        row = {"kernel_only_ms": _profiled_ms(call, [name]),
               "merge_ms": None, "k_tiles": None, "splits": None,
               "split_cols": None, "blocks": q.shape[0] * kvh}
    else:
        _, counts = call(count_tiles=True)
        pps = -(-(cap or DECODE_SHAPE["MAX_LEN"]) // DECODE_SHAPE["PAGE"])
        plan = pa.paged_split_plan(lims, qh // kvh, n_tok, kvh,
                                   pa.SPLIT_COLS, pa._sm_count(q.device),
                                   pps * DECODE_SHAPE["PAGE"], d)
        want = {"k_tiles": kvh * plan["k_tiles"],
                "splits": kvh * plan["splits"]}
        got = {x: counts[x] for x in want}
        if got != want:
            fail(f"{kname} ({variant}): the kernel counted {got}, the "
                 f"split rule gives {want}")
        names = ["paged_tc_kernel", "paged_merge_kernel"]
        row = {"kernel_only_ms": _profiled_ms(call, names),
               "merge_ms": _profiled_ms(call, names[1:]),
               "k_tiles": got["k_tiles"], "splits": got["splits"],
               "k_tiles_per_kv_head": plan["k_tiles"],
               "splits_per_kv_head": plan["splits"],
               "split_cols": counts["split_cols"],
               "max_splits": counts["max_splits"], "blocks": plan["blocks"],
               "working_blocks": got["splits"],
               "workspace_bytes": counts["workspace_bytes"]}
    alone = row["kernel_only_ms"]
    return {"route": route, **row,
            "kernel_only_bound_share": bound_ms / alone if alone else None}


def _train_counts():
    """Launches of the six training kernels, by kernel name."""
    import paddle_tpu_torch.ops.flash_attention as fa
    import paddle_tpu_torch.ops.flashmask_attention as fm
    return {"flash_fwd": fa.launches_fwd, "flash_bwd_dq": fa.launches_dq,
            "flash_bwd_dkv": fa.launches_dkv,
            "flashmask_fwd": fm.launches_fwd,
            "flashmask_bwd_dq": fm.launches_dq,
            "flashmask_bwd_dkv": fm.launches_dkv}


def _reset_train_counts():
    import paddle_tpu_torch.ops.flash_attention as fa
    import paddle_tpu_torch.ops.flashmask_attention as fm
    fa.launches_fwd = fa.launches_dq = fa.launches_dkv = 0
    fm.launches_fwd = fm.launches_dq = fm.launches_dkv = 0


def _want_counts(family, layers, steps):
    """The launches of `steps` remat steps of `layers` layers on one
    family of kernels ("flash" or "flashmask"), none on the other: the
    forward twice per layer and step (forward and recompute), dQ and
    dK/dV once."""
    want = {k: 0 for k in _train_counts()}
    want.update({f"{family}_fwd": 2 * layers * steps,
                 f"{family}_bwd_dq": layers * steps,
                 f"{family}_bwd_dkv": layers * steps})
    return want


def _attn_bound(kernel, dtype, b, h, s, d, pairs, extra_bytes=0):
    """Least time for one attention call: flops over the `pairs` (summed
    over batch and heads) it computes (4, 6, 8 flops per pair and head
    dim: QK^T and PV; S, dP and dQ; S, dP, dV and dK) over the peak for
    the dtype, or each operand byte once (plus `extra_bytes`, a mask)
    over the memory rate. `kernel` ends in fwd, dq or dkv."""
    kind = kernel.rsplit("_", 1)[1]
    flops = {"fwd": 4, "dq": 6, "dkv": 8}[kind] * d * pairs
    big = b * h * s * d * (4 if dtype == "float32" else 2)
    vec = b * h * s * 4                                   # lse, delta
    nbytes = extra_bytes + {"fwd": 4 * big + vec,  # q k v in, o, lse out
                            "dq": 5 * big + 2 * vec,  # q k v dO lse delta, dQ
                            "dkv": 6 * big + 2 * vec}[kind]  # ..., dK dV
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, flops / PEAK_FLOPS[dtype]
    return (max(t_bytes, t_ops) * 1e3,
            "bytes" if t_bytes >= t_ops else "operations", nbytes, flops)


def phase_train_kernel(card):
    b, h, s, d = (TRAIN_ATTN[x] for x in "BHSD")
    return _flash_timed(card, "train_kernel", b, h, s, d)


def _flash_timed(card, phase, b, h, s, d):
    """Rows 3-5 at (b, h, s, d), causal, bf16 and fp32: each kernel
    against its plain version, then timed beside the plain version, the
    SDPA yardstick and the bound; a row a kernel and dtype, emitted under
    `phase`. Head dims above 128 run the wide designs (FAMILY_DESIGN),
    which carry no library-factor limit, and their rows add the
    instantiation's registers and spill bytes (ptxas)."""
    import math
    import torch
    import torch.nn.functional as F
    import paddle_tpu_torch.ops.flash_attention as fa
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    scale = 1.0 / math.sqrt(d)
    wide = d > 128
    out = {}
    for dname in ("bfloat16", "float32"):
        dt = getattr(torch, dname)
        g = torch.Generator(device="cuda")
        g.manual_seed(0)
        q, k, v, do = (torch.randn((b, h, s, d), generator=g,
                                   device="cuda").to(dt) for _ in range(4))
        o, lse = fa._launch_fwd(q, k, v, True, scale)
        o_ref, lse_ref = fa.flash_fwd_reference(q, k, v, True, scale)
        delta = (do.float() * o_ref.float()).sum(-1)
        args = (q, k, v, do, lse_ref, delta, True, scale)
        dq = fa._launch_dq(*args)
        dk, dv = fa._launch_dkv(*args)
        torch.cuda.synchronize()
        dq_ref = fa.flash_bwd_dq_reference(*args)
        dk_ref, dv_ref = fa.flash_bwd_dkv_reference(*args)
        atol, rtol = TOL[dname]
        errs = _check_kernels(
            phase, dname,
            {"flash_fwd": [o], "flash_bwd_dq": [dq],
             "flash_bwd_dkv": [dk, dv]},
            {"flash_fwd": [o_ref], "flash_bwd_dq": [dq_ref],
             "flash_bwd_dkv": [dk_ref, dv_ref]}, lse, lse_ref)
        lse_err = errs["lse"]
        del o, lse, dq, dk, dv, dq_ref, dk_ref, dv_ref
        reps = 3 if wide and dname == "float32" else 10
        kernel_ms = {
            "flash_fwd": cuda_ms(lambda: fa._launch_fwd(q, k, v, True, scale),
                                 reps=reps),
            "flash_bwd_dq": cuda_ms(lambda: fa._launch_dq(*args), reps=reps),
            "flash_bwd_dkv": cuda_ms(lambda: fa._launch_dkv(*args),
                                     reps=reps)}
        plain_ms = {
            "flash_fwd": cuda_ms(lambda: fa.flash_fwd_reference(
                q, k, v, True, scale), reps=3, warmup=1),
            "flash_bwd_dq": cuda_ms(lambda: fa.flash_bwd_dq_reference(*args),
                                    reps=3, warmup=1),
            "flash_bwd_dkv": cuda_ms(
                lambda: fa.flash_bwd_dkv_reference(*args), reps=3, warmup=1)}
        lib_fwd = cuda_ms(lambda: F.scaled_dot_product_attention(
            q, k, v, is_causal=True), reps=10)
        qg, kg, vg = (t.detach().requires_grad_() for t in (q, k, v))

        def fwd_bwd():
            F.scaled_dot_product_attention(qg, kg, vg,
                                           is_causal=True).backward(do)
        lib_bwd = cuda_ms(fwd_bwd, reps=10) - lib_fwd
        library_ms = {"flash_fwd": lib_fwd, "flash_bwd_dq": lib_bwd,
                      "flash_bwd_dkv": lib_bwd}
        for kname in FLASH_KERNELS:
            bound_ms, bound_by, nbytes, flops = _attn_bound(
                kname, dname, b, h, s, d, b * h * s * (s + 1) // 2)
            row = {"phase": phase, "card": card, "kernel": kname,
                   "dtype": dname, "shape_bhsd": [b, h, s, d],
                   "causal": True, "atol": atol, "rtol": rtol,
                   "max_abs_err": errs[kname], "kernel_ms": kernel_ms[kname],
                   "plain_ms": plain_ms[kname],
                   "library_ms": library_ms[kname],
                   "library_call": ("sdpa forward" if kname == "flash_fwd"
                                    else "sdpa backward (dQ, dK, dV)"),
                   "bound_ms": bound_ms, "bound_by": bound_by,
                   "bound_bytes": nbytes, "bound_flops": flops,
                   "tflops": flops / kernel_ms[kname] / 1e9, "tf32": False}
            if kname == "flash_fwd":
                row["lse_max_abs_err"] = lse_err
            if kname == "flash_bwd_dkv":   # the pair against one SDPA bwd
                row["pair_library_factor"] = (
                    kernel_ms["flash_bwd_dq"] + kernel_ms["flash_bwd_dkv"]) \
                    / lib_bwd
            _design_row(row, kname, dname, enforce=not wide)
            if wide:
                row["design"] = FAMILY_DESIGN[dname]
                row["ptxas"] = _flash_ptxas(kname, dname, d)
            emit(row)
            out[(kname, dname)] = row
        del q, k, v, do, qg, kg, vg, args, o_ref, lse_ref, delta
        torch.cuda.empty_cache()
    return out


def _tree_to(tree, dev):
    return {k: (_tree_to(v, dev) if isinstance(v, dict)
                else v.to(dev, copy=True)) for k, v in tree.items()}


def _train_batch(vocab, b, s, seed):
    """(input_ids, labels): random tokens from a numpy seed, labels the
    next token; the last position and the first 16 labels of row 0 are
    ignored (-1)."""
    import numpy as np
    rng = np.random.default_rng(seed)
    toks = rng.integers(0, vocab, (b, s + 1))
    labels = toks[:, 1:].copy()
    labels[:, -1] = -1
    labels[0, :16] = -1
    return toks[:, :-1], labels


# card vs CPU, fp32, TF32 off, at 8B widths: the losses to 1e-5
# relative plus 1e-5 (the one fixed batch is memorised within a step,
# and near a loss of 0 the per-token NLLs are differences of fp32
# logits some tens in size, whose ulps are a few 1e-6); each gradient
# elementwise to 1e-3 relative plus 1e-4 of its leaf's largest
# magnitude (matmuls over K = 4096 and 14336 sum in another order on
# each side); parameters to 2.5 lr per step (AdamW's first steps move
# an element by about lr whatever its gradient's size, so a near-zero
# gradient whose sign differs moves it by up to 2 lr) and to 1e-5 in
# relative norm
PARITY_GRAD_RTOL, PARITY_GRAD_SCALE = 1e-3, 1e-4


def _step_parity(name, cfg, batch_np, steps, lr, family, remat=True,
                 fused_ce=False):
    """`steps` steps of make_train_step (with `remat` and `fused_ce`)
    from the same fp32 weights on the card and on the CPU, held to the
    limits above; the kernels of `family` must launch on the card (none
    of the other family) and nothing on the CPU. Returns the phase's
    measurements."""
    import torch
    from paddle_tpu_torch.models import llama_spmd as T
    cpu_params = T.init_params(cfg, seed=0, dtype=torch.float32,
                               device="cpu")
    res = {}
    for dev in ("cuda", "cpu"):
        params = _tree_to(cpu_params, dev)
        opt = T.init_opt_state(params)
        batch = tuple(torch.from_numpy(a).to(dev) for a in batch_np)
        _, grads = T.loss_and_grads(params, batch, cfg, remat=remat,
                                    fused_ce=fused_ce)
        grads = [g.cpu() for g in T._leaves(grads)]
        step = T.make_train_step(cfg, remat=remat, fused_ce=fused_ce, lr=lr,
                                 device=dev)
        _reset_train_counts()
        t0 = time.perf_counter()
        losses = [float(step(params, opt, i, batch)[2]) for i in range(steps)]
        res[dev] = {"losses": losses, "grads": grads,
                    "params": [p.cpu() for p in T._leaves(params)],
                    "launches": _train_counts(),
                    "seconds": time.perf_counter() - t0}
        del params, opt, batch
    del cpu_params
    torch.cuda.empty_cache()
    want = _want_counts(family, cfg.num_hidden_layers, steps)
    if res["cuda"]["launches"] != want:
        fail(f"{name}: launches {res['cuda']['launches']}, want {want}")
    if any(res["cpu"]["launches"].values()):
        fail(f"{name}: the CPU step launched a CUDA kernel")
    gpu, cpu = res["cuda"], res["cpu"]
    loss_err = [abs(a - c) for a, c in zip(gpu["losses"], cpu["losses"])]
    if any(e > 1e-5 * abs(c) + 1e-5
           for e, c in zip(loss_err, cpu["losses"])):
        fail(f"{name}: losses {gpu['losses']} vs {cpu['losses']}")
    grad_worst = 0.0        # largest |err| / (allowed |err|)
    for a, c in zip(gpu["grads"], cpu["grads"]):
        allowed = (PARITY_GRAD_RTOL * c.abs()
                   + PARITY_GRAD_SCALE * float(c.abs().max()) + 1e-30)
        grad_worst = max(grad_worst, float(((a - c).abs() / allowed).max()))
    if grad_worst > 1.0:
        fail(f"{name}: step-1 gradients off, worst {grad_worst} of the "
             "tolerance")
    p_err = max(float((a - c).abs().max())
                for a, c in zip(gpu["params"], cpu["params"]))
    p_rel = max(float((a - c).norm() / c.norm())
                for a, c in zip(gpu["params"], cpu["params"]))
    if p_err > 2.5 * lr * steps or p_rel > 1e-5:
        fail(f"{name}: parameters off by {p_err} (relative norm {p_rel})")
    return {"steps": steps, "losses_cuda": gpu["losses"],
            "losses_cpu": cpu["losses"], "loss_abs_err": loss_err,
            "grad_worst_share_of_tol": grad_worst,
            "param_max_abs_err": p_err, "param_max_rel_norm_err": p_rel,
            "launches": gpu["launches"], "cuda_seconds": gpu["seconds"],
            "cpu_seconds": cpu["seconds"]}


def _parity_config():
    """Llama-3-8B widths at depth 1 with the vocabulary cut to 4096, so
    that the CPU side takes seconds; TF32 off."""
    import torch
    from paddle_tpu_torch.models.llama import LlamaConfig
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return dataclasses.replace(LlamaConfig.llama3_8b(), num_hidden_layers=1,
                               vocab_size=4096)


def phase_train_parity(card):
    cfg = _parity_config()
    batch = _train_batch(cfg.vocab_size, 1, 512, seed=3)
    emit({"phase": "train_parity", "card": card,
          "config": "llama3_8b widths, 1 layer, vocab 4096, fp32, TF32 off, "
                    "remat, batch 1 x 512",
          **_step_parity("train_parity", cfg, batch, 2, 3e-4, "flash")})


# the packed rows: documents per row, each row summing to its length
PACKED_PARITY_ROWS = ([200, 150, 100, 62], [512])
PACKED_DOCS = (3000, 1500, 1200, 900, 700, 400, 300, 192)


def _packed_batch(vocab, rows, seed):
    """(input_ids, labels, doc_ids) of packed rows (`rows`: the document
    lengths of each row): random tokens from a numpy seed, labels the
    next token, -1 at each document's last token."""
    import numpy as np
    rng = np.random.default_rng(seed)
    s = sum(rows[0])
    toks = rng.integers(0, vocab, (len(rows), s + 1))
    labels = toks[:, 1:].copy()
    for r, lens in enumerate(rows):
        labels[r, np.cumsum(lens) - 1] = -1
    doc = np.stack([np.repeat(np.arange(len(lens)), lens) for lens in rows])
    return toks[:, :-1], labels, doc


def phase_packed_parity(card):
    cfg = _parity_config()
    batch = _packed_batch(cfg.vocab_size, PACKED_PARITY_ROWS, seed=3)
    emit({"phase": "packed_parity", "card": card,
          "config": "llama3_8b widths, 1 layer, vocab 4096, fp32, TF32 off, "
                    "remat, batch 2 x 512 packed: documents "
                    f"{list(map(list, PACKED_PARITY_ROWS))}",
          **_step_parity("packed_parity", cfg, batch, 2, 3e-4, "flashmask")})


TRAIN_CONFIG = ("llama3_8b widths, 4 layers, bf16 params, fp32 AdamW state, "
                "remat, random weights (seed 0), batch 2 x 2048")
TRAIN_PACKED_CONFIG = ("llama3_8b widths, 4 layers, bf16 params, fp32 AdamW "
                       "state, remat, random weights (seed 0), batch 1 x "
                       f"8192 packed: documents {list(PACKED_DOCS)}")


def _train_model(remat=True, fused_ce=False):
    """Llama-3-8B widths cut to 4 layers, bf16 random weights from seed 0
    on the card, fp32 AdamW state, the step with `remat` and `fused_ce`
    (lr 3e-4, clip 1.0). Returns (config, params, opt_state, step)."""
    import torch
    from paddle_tpu_torch.models import llama_spmd as T
    from paddle_tpu_torch.models.llama import LlamaConfig
    cfg = dataclasses.replace(LlamaConfig.llama3_8b(), num_hidden_layers=4)
    params = T.init_params(cfg, seed=0, dtype=torch.bfloat16, device="cuda")
    return cfg, params, T.init_opt_state(params), T.make_train_step(
        cfg, remat=remat, fused_ce=fused_ce, device="cuda")


def train_setup():
    """The train phase's run: `_train_model` and one fixed batch of 2 x
    2048 tokens (numpy seed 4). Returns (config, params, opt_state,
    batch, step)."""
    import torch
    cfg, params, opt, step = _train_model()
    ids, labels = _train_batch(cfg.vocab_size, 2, 2048, seed=4)
    batch = (torch.from_numpy(ids).cuda(), torch.from_numpy(labels).cuda())
    return cfg, params, opt, batch, step


def train_packed_setup(remat=True, fused_ce=False):
    """The train_packed phase's run: `_train_model` and one fixed row of
    8192 tokens (numpy seed 5) packing the eight documents of
    PACKED_DOCS. Returns (config, params, opt_state, batch, step)."""
    import torch
    cfg, params, opt, step = _train_model(remat, fused_ce)
    batch = _packed_batch(cfg.vocab_size, [PACKED_DOCS], seed=5)
    return cfg, params, opt, tuple(torch.from_numpy(a).cuda()
                                   for a in batch), step


def _attention_pairs(batch):
    """Query-key pairs one head attends to over the batch: causal, and
    within each document when the batch carries doc_ids."""
    import numpy as np
    ids = batch[0]
    b, s = ids.shape
    if len(batch) < 3:
        return b * s * (s + 1) // 2
    doc = batch[2].cpu().numpy()
    lens = [np.unique(row, return_counts=True)[1] for row in doc]
    return int(sum((n * (n + 1) // 2).sum() for n in lens))


def _train_run(card, phase, config, setup, family):
    """Six steps of `setup`'s run on its one fixed batch: launches of
    `family`'s kernels only, finite and falling losses; the phase row."""
    import gc
    import statistics as st
    import torch
    gc.collect()
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    cfg, params, opt, batch, step = setup()
    (b, s), steps = batch[0].shape, 6
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    torch.cuda.reset_peak_memory_stats()
    _reset_train_counts()
    losses, times = [], []
    for i in range(steps):
        t0 = time.perf_counter()
        _, _, loss = step(params, opt, i, batch)
        losses.append(loss.item())          # waits for the step
        times.append((time.perf_counter() - t0) * 1e3)
    launches = _train_counts()
    peak = torch.cuda.max_memory_allocated()
    L = cfg.num_hidden_layers
    want = _want_counts(family, L, steps)
    if launches != want:
        fail(f"{phase}: launches {launches}, want {want}")
    if not all(math.isfinite(x) for x in losses):
        fail(f"{phase}: losses not finite: {losses}")
    if not losses[-1] < losses[0]:
        fail(f"{phase}: loss did not fall: {losses}")
    # model flops per token, the strict convention of bench.py: 6 N over
    # the matmul parameters (lm_head once, no embedding gather) plus
    # attention charged at the full (non-causal) 12 L H S
    H, F_, V = cfg.hidden_size, cfg.intermediate_size, cfg.vocab_size
    kv = cfg.num_key_value_heads * (H // cfg.num_attention_heads)
    n_layers = L * (2 * H * H + 2 * H * kv + 3 * H * F_)
    flops_tok = 6 * (n_layers + V * H) + 12 * L * H * s
    # attention as the step computes it: 12 L H flops per pair kept
    attn_kept = 12 * L * H * _attention_pairs(batch)
    step_ms = st.median(times[1:])          # the first step allocates
    tok_s = b * s / (step_ms / 1e3)
    kept_flops = 6 * (n_layers + V * H) * b * s + attn_kept
    row = {"phase": phase, "card": card, "config": config,
           "steps": steps, "losses": losses, "step_ms": times,
           "median_step_ms": step_ms, "tokens_per_s": tok_s,
           "model_flops_per_token": flops_tok,
           "model_flops_convention": "bench.py strict: 6 N per token "
                                     "plus attention at the full 12 L H S",
           "model_flops_share_of_989T": flops_tok * tok_s / 989e12,
           "attention_flops_strict_per_step": 12 * L * H * s * b * s,
           "attention_flops_kept_per_step": attn_kept,
           "kept_flops_share_of_989T": kept_flops / (step_ms / 1e3) / 989e12,
           "max_memory_allocated_gb": peak / 1e9, "launches": launches,
           "params_and_state_init_s": init_s}
    emit(row)
    del params, opt, batch, step
    gc.collect()
    torch.cuda.empty_cache()
    return row


def phase_train(card):
    return _train_run(card, "train", TRAIN_CONFIG, train_setup, "flash")


def phase_train_packed(card):
    return _train_run(card, "train_packed", TRAIN_PACKED_CONFIG,
                      train_packed_setup, "flashmask")


# ------------------------------------------------------------- FlashMask
MASK_ATTN = {"B": 1, "H": 32, "S": 8192, "D": 128}
FLASHMASK_KERNELS = ("flashmask_fwd", "flashmask_bwd_dq", "flashmask_bwd_dkv")
# The plain versions run over slices of 8 heads at the packed shape: one
# (1, 32, 8192, 8192) fp32 score tensor is 8.6 GB and the backward holds
# several. The kernels run on all 32 heads at once.
PLAIN_HEADS = 8


def _by_heads(fn, *args):
    """fn(*args) over slices of PLAIN_HEADS heads, concatenated: every
    tensor argument with the heads' count on dim 1 is sliced, the shared
    (B, 1, S, n) mask is not. Without dropout only (its hash takes the
    head index)."""
    import torch
    h = args[0].shape[1]
    parts = []
    for a in range(0, h, PLAIN_HEADS):
        parts.append(fn(*(x[:, a:a + PLAIN_HEADS]
                          if torch.is_tensor(x) and x.dim() >= 3
                          and x.shape[1] == h else x for x in args)))
    if isinstance(parts[0], tuple):
        return tuple(torch.cat(p, dim=1) for p in zip(*parts))
    return torch.cat(parts, dim=1)


def _kept_pairs(sri):
    """Pairs an n=1 causal mask (B, 1, S, 1) keeps per head, summed over
    B: column j keeps rows j .. min(start_j, S) - 1."""
    import torch
    s = sri.shape[2]
    j = torch.arange(s, device=sri.device)
    return int((sri[..., 0].long().clamp(max=s) - j).clamp(min=0).sum())


def _tile_counts(sri, tile=64):
    """(causal 64 x 64 tiles, those the n=1 mask wholly masks) of row 0:
    a tile is skipped when its first row is at or past the largest start
    over its columns, the kernels' test."""
    import torch
    start = sri[0, 0, :, 0].long()
    nt = -(-start.numel() // tile)
    pad = torch.full((nt * tile - start.numel(),), -(1 << 31),
                     device=start.device)
    mx = torch.cat([start, pad]).reshape(nt, tile).amax(1)
    qt = torch.arange(nt, device=start.device)[:, None]
    causal = torch.arange(nt, device=start.device)[None, :] <= qt
    return int(causal.sum()), int((causal & (qt * tile >= mx[None])).sum())


def _doc_sdpa(q, k, v, do, lens):
    """Closures timing F.scaled_dot_product_attention (is_causal) once
    per document: the forward, and forward + backward (one autograd pass
    over every document, so that the host adds one engine call, not
    eight). The per-document copies are made beforehand and not
    timed."""
    import torch
    import torch.nn.functional as F
    edges = [0]
    for n in lens:
        edges.append(edges[-1] + n)
    docs = [[t[:, :, a:b].contiguous() for t in (q, k, v, do)]
            for a, b in zip(edges, edges[1:])]
    grads = [[t.detach().requires_grad_() for t in d[:3]] + [d[3]]
             for d in docs]

    def fwd():
        return [F.scaled_dot_product_attention(qd, kd, vd, is_causal=True)
                for qd, kd, vd, _ in docs]

    def fwd_bwd():
        torch.autograd.backward(
            [F.scaled_dot_product_attention(qd, kd, vd, is_causal=True)
             for qd, kd, vd, _ in grads], [dod for *_, dod in grads])
    return fwd, fwd_bwd


def _check_kernels(label, dname, got, want, lse, lse_ref):
    """Hold kernel outputs to plain ones (TOL, LSE_TOL); returns the max
    |error| of each kernel."""
    import torch
    atol, rtol = TOL[dname]
    if not torch.allclose(lse, lse_ref, atol=LSE_TOL[0], rtol=LSE_TOL[1]):
        fail(f"{label} ({dname}): lse off by "
             f"{float((lse - lse_ref).abs().max())}")
    errs = {}
    for kname in got:
        pairs = list(zip(got[kname], want[kname]))
        errs[kname] = max(float((a.float() - r.float()).abs().max())
                          for a, r in pairs)
        if not all(torch.allclose(a.float(), r.float(), atol=atol,
                                  rtol=rtol) for a, r in pairs):
            fail(f"{label} {kname} ({dname}) vs plain: max |err| "
                 f"{errs[kname]}")
    errs["lse"] = float((lse - lse_ref).abs().max())
    return errs


def _mask_case(name, b, h, s, rng):
    """(sri numpy array or None, causal, window, dropout, seed) of one
    correctness case of the mask_kernel phase."""
    import numpy as np

    def band(lo, hi):
        start = rng.integers(lo, hi, (b, h, s, 1))
        return start, np.minimum(start + rng.integers(0, s // 4 + 1,
                                                      (b, h, s, 1)), s)
    if name == "causal_n2_band":
        return np.concatenate(band(0, s), -1), True, None, 0.0, None
    if name == "noncausal_n2":
        return (np.concatenate([rng.integers(s // 2, s + 1, (b, h, s, 1)),
                                rng.integers(0, s // 2, (b, h, s, 1))], -1),
                False, None, 0.0, None)
    if name == "noncausal_n4":
        return (np.concatenate([*band(0, s // 4), *band(s // 2, s)], -1),
                False, None, 0.0, None)
    if name == "causal_n1_window":
        return rng.integers(1, s + 1, (b, h, s, 1)), True, (256, 0), 0.0, None
    if name == "window_no_sri":
        return None, True, (256, 0), 0.0, None
    if name == "causal_n1_dropout":
        return rng.integers(1, s + 1, (b, h, s, 1)), True, None, 0.1, 1234567
    assert name == "masked_rows"   # rows [s/4, s/2) see nothing
    sri = np.full((b, 1, s, 1), s, np.int64)
    sri[:, :, : s // 2] = s // 4
    return sri, True, None, 0.0, None


MASK_CASES = ("causal_n2_band", "noncausal_n2", "noncausal_n4",
              "causal_n1_window", "window_no_sri", "causal_n1_dropout",
              "masked_rows")


def _mask_flavors(card):
    """Correctness only: every mask flavor at B=2, H=4, S=1000 (a ragged
    final tile), D=64 and 128, bf16 and fp32, and each kernel's computed
    tiles against `tile_plan`'s count."""
    import numpy as np
    import torch
    import paddle_tpu_torch.ops.flashmask_attention as fm
    b, h, s = 2, 4, 1000
    errs = {}
    for name in MASK_CASES:
        for d in (64, 128):
            for dname in ("bfloat16", "float32"):
                rng = np.random.default_rng(d)
                sri, causal, window, rate, seed = _mask_case(name, b, h, s,
                                                             rng)
                g = torch.Generator(device="cuda")
                g.manual_seed(d)
                q, k, v, do = (torch.randn((b, h, s, d), generator=g,
                                           device="cuda").to(
                    getattr(torch, dname)) for _ in range(4))
                sri = None if sri is None else torch.from_numpy(
                    sri.astype(np.int32)).cuda()
                m = fm._Mask(causal, window, 1.0 / math.sqrt(d), rate, seed)
                o, lse, computed = fm._launch_fwd(q, k, v, sri, m,
                                                  count_tiles=True)
                plan = fm.tile_plan(sri, s, s, causal, window)
                want = int((plan != fm.SKIP).sum()) * (
                    b * h // (plan.shape[0] * plan.shape[1]))
                o_ref, lse_ref = fm.flashmask_fwd_reference(q, k, v, sri, *m)
                delta = (do.float() * o_ref.float()).sum(-1)
                args = (q, k, v, sri, do, lse_ref, delta)
                dq, computed_dq = fm._launch_dq(*args, m, count_tiles=True)
                dk, dv, computed_dkv = fm._launch_dkv(*args, m,
                                                      count_tiles=True)
                torch.cuda.synchronize()
                if (computed, computed_dq, computed_dkv) != (want,) * 3:
                    fail(f"{name} d{d} ({dname}): the forward, dQ and dK/dV "
                         f"computed {computed}, {computed_dq} and "
                         f"{computed_dkv} tiles, tile_plan keeps {want}")
                dk_ref, dv_ref = fm.flashmask_bwd_dkv_reference(*args, *m)
                got = {"flashmask_fwd": [o], "flashmask_bwd_dq": [dq],
                       "flashmask_bwd_dkv": [dk, dv]}
                want = {"flashmask_fwd": [o_ref], "flashmask_bwd_dq":
                        [fm.flashmask_bwd_dq_reference(*args, *m)],
                        "flashmask_bwd_dkv": [dk_ref, dv_ref]}
                errs[f"{name}/d{d}/{dname}"] = _check_kernels(
                    name, dname, got, want, lse, lse_ref)
    emit({"phase": "mask_kernel", "card": card, "part": "flavors",
          "shape_bhsd": [b, h, s, "64|128"], "cases": list(MASK_CASES),
          "tol": TOL, "lse_tol": LSE_TOL,
          "max_abs_err": {k: max(v.values()) for k, v in errs.items()}})


def phase_mask_kernel(card):
    import numpy as np
    import torch
    import paddle_tpu_torch.ops.flashmask_attention as fm
    from paddle_tpu_torch.models.llama_spmd import doc_end_indices
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    b, h, s, d = (MASK_ATTN[x] for x in "BHSD")
    doc = np.repeat(np.arange(len(PACKED_DOCS)), PACKED_DOCS)[None]
    sri = doc_end_indices(torch.from_numpy(doc).cuda())     # (1, 1, S, 1)
    pairs = _kept_pairs(sri) * h
    tiles, skipped = _tile_counts(sri)
    m = fm._Mask(True, None, 1.0 / math.sqrt(d), 0.0, None)
    out = {}
    for dname in ("bfloat16", "float32"):
        dt = getattr(torch, dname)
        g = torch.Generator(device="cuda")
        g.manual_seed(0)
        q, k, v, do = (torch.randn((b, h, s, d), generator=g,
                                   device="cuda").to(dt) for _ in range(4))
        o, lse, computed_fwd = fm._launch_fwd(q, k, v, sri, m,
                                              count_tiles=True)
        o_ref, lse_ref = _by_heads(fm.flashmask_fwd_reference, q, k, v, sri,
                                   *m)
        delta = (do.float() * o_ref.float()).sum(-1)
        args = (q, k, v, sri, do, lse_ref, delta)
        dq, computed_dq = fm._launch_dq(*args, m, count_tiles=True)
        dk, dv, computed_dkv = fm._launch_dkv(*args, m, count_tiles=True)
        torch.cuda.synchronize()
        computed = {"flashmask_fwd": computed_fwd,
                    "flashmask_bwd_dq": computed_dq,
                    "flashmask_bwd_dkv": computed_dkv}
        for kname, n in computed.items():
            if n != (tiles - skipped) * h:
                fail(f"{kname} ({dname}) computed {n} tiles, the skip rule "
                     f"keeps {(tiles - skipped) * h}")
        dk_ref, dv_ref = _by_heads(fm.flashmask_bwd_dkv_reference, *args, *m)
        errs = _check_kernels(
            "mask_kernel", dname,
            {"flashmask_fwd": [o], "flashmask_bwd_dq": [dq],
             "flashmask_bwd_dkv": [dk, dv]},
            {"flashmask_fwd": [o_ref], "flashmask_bwd_dq":
             [_by_heads(fm.flashmask_bwd_dq_reference, *args, *m)],
             "flashmask_bwd_dkv": [dk_ref, dv_ref]}, lse, lse_ref)
        del o, lse, dq, dk, dv, dk_ref, dv_ref
        launch = {"flashmask_fwd": lambda mk: fm._launch_fwd(q, k, v, mk, m),
                  "flashmask_bwd_dq": lambda mk: fm._launch_dq(
                      q, k, v, mk, do, lse_ref, delta, m),
                  "flashmask_bwd_dkv": lambda mk: fm._launch_dkv(
                      q, k, v, mk, do, lse_ref, delta, m)}
        plain = {"flashmask_fwd": fm.flashmask_fwd_reference,
                 "flashmask_bwd_dq": fm.flashmask_bwd_dq_reference,
                 "flashmask_bwd_dkv": fm.flashmask_bwd_dkv_reference}
        plain_args = {"flashmask_fwd": (q, k, v, sri, *m)}
        lib_fwd, lib_fwd_bwd = _doc_sdpa(q, k, v, do, PACKED_DOCS)
        fwd_ms = cuda_ms(lib_fwd, reps=10)
        bwd_ms = cuda_ms(lib_fwd_bwd, reps=10) - fwd_ms
        kernel_ms = {}
        for kname in FLASHMASK_KERNELS:
            kms = kernel_ms[kname] = cuda_ms(lambda: launch[kname](sri),
                                             reps=10)
            causal_ms = cuda_ms(lambda: launch[kname](None), reps=5)
            pa = plain_args.get(kname, (*args, *m))
            plain_ms = cuda_ms(lambda: _by_heads(plain[kname], *pa), reps=3,
                               warmup=1)
            if not kms < 0.5 * causal_ms:
                fail(f"{kname} ({dname}): {kms} ms with the document "
                     f"mask, {causal_ms} ms causal only: the block skip "
                     "does not pay")
            bound_ms, bound_by, nbytes, flops = _attn_bound(
                kname, dname, b, h, s, d, pairs, sri.numel() * 4)
            row = {"phase": "mask_kernel", "card": card, "kernel": kname,
                   "dtype": dname, "shape_bhsd": [b, h, s, d],
                   "documents": list(PACKED_DOCS), "causal": True,
                   "kept_pairs_per_head": pairs // h,
                   "causal_pairs_per_head": s * (s + 1) // 2,
                   "tiles_causal": tiles, "tiles_skipped": skipped,
                   "atol": TOL[dname][0], "rtol": TOL[dname][1],
                   "max_abs_err": errs[kname],
                   "plain_compared_by_heads": PLAIN_HEADS,
                   "kernel_ms": kms, "causal_only_ms": causal_ms,
                   "plain_ms": plain_ms,
                   "library_ms": fwd_ms if kname == "flashmask_fwd"
                   else bwd_ms,
                   "library_call": ("sdpa forward per document, summed"
                                    if kname == "flashmask_fwd" else
                                    "sdpa backward per document (dQ, dK, "
                                    "dV), summed"),
                   "bound_ms": bound_ms, "bound_by": bound_by,
                   "bound_bytes": nbytes, "bound_flops": flops,
                   "tflops": flops / kms / 1e9, "tf32": False,
                   "tiles_computed": computed[kname]}
            if kname == "flashmask_fwd":
                row["lse_max_abs_err"] = errs["lse"]
            if kname == "flashmask_bwd_dkv":   # the pair against one SDPA bwd
                row["pair_library_factor"] = (
                    kernel_ms["flashmask_bwd_dq"] + kms) / bwd_ms
            emit(_design_row(row, kname, dname))
            out[(kname, dname)] = row
        del q, k, v, do, args, o_ref, lse_ref, delta, lib_fwd, lib_fwd_bwd
        torch.cuda.empty_cache()
    _mask_flavors(card)
    torch.cuda.empty_cache()
    return out


# ------------------------------------------------------- bucketed serving
# The serve prefill wave: the serve phase's 8 prompts packed into one
# power-of-two bucket, at Llama-3-8B attention widths.
BUCKET_ATTN = {"T": 8192, "H": 32, "KVH": 8, "D": 128}
# pa_decode at 8B widths: 8 slots of 100-2000 cached tokens and a free
# (length-0) slot, page 16, room for 2048 tokens a slot
DECODE_LENS = (100, 400, 700, 1000, 1300, 1700, 2000, 1500, 0)
DECODE_SHAPE = {"QH": 32, "KVH": 8, "D": 128, "PAGE": 16, "MAX_LEN": 2048}


def _segments(lens, total):
    """(total,) int32 segment ids of prompts `lens` packed back to back,
    -1 on the padding."""
    import numpy as np
    seg = np.full((total,), -1, np.int32)
    seg[:sum(lens)] = np.repeat(np.arange(len(lens)), lens)
    return seg


def _varlen_tiles(seg_q, seg_k, causal_diag, tile=64):
    """(64 x 64 tiles a head computes under the kernel's rule, causal
    tiles): a tile is skipped when the [min, max] of the non-negative
    segment ids of its rows and of its columns are disjoint or empty,
    or, with `causal_diag`, when it lies above the diagonal."""
    import numpy as np

    def ranges(seg):
        out = []
        for a in range(0, len(seg), tile):
            s = seg[a:a + tile]
            s = s[s >= 0]
            out.append((s.min(), s.max()) if len(s) else None)
        return out
    rq, rk = ranges(np.asarray(seg_q)), ranges(np.asarray(seg_k))
    n = 0
    for qt, a in enumerate(rq):
        for kt, b in enumerate(rk):
            if a is None or b is None or (causal_diag and kt > qt):
                continue
            n += int(b[0] <= a[1] and b[1] >= a[0])
    return n, len(rq) * (len(rq) + 1) // 2


def _varlen_case_segs(name):
    """The segment ids of one correctness case of the varlen kernels on
    a ragged token axis: (seg_q, seg_k, causal, same_offsets), numpy
    int32, seg_k the same array as seg_q with same offsets. Real segment
    ids are non-decreasing and padding trails."""
    import numpy as np
    if name == "causal_same":        # packed prompts, T = 1000
        seg_q = seg_k = _segments([300, 1, 250, 333], 1000)
        causal, same = True, True
    elif name in ("causal_unequal", "noncausal_unequal"):
        # more keys than queries per segment: bottom-right alignment
        seg_q = _segments([200, 150, 300], 700)
        seg_k = _segments([260, 150, 420], 1000)
        causal, same = name == "causal_unequal", False
    elif name == "unseen_keys":      # q segment 1 has no keys, and no
        seg_q = _segments([100, 200, 300], 1000)    # query has segment 3
        seg_k = np.concatenate([np.zeros(150, np.int32),
                                np.full(400, 2, np.int32),
                                np.full(100, 3, np.int32),
                                np.full(350, -1, np.int32)])
        causal, same = True, False
    else:                            # masked_rows: q segment 1 has no keys
        seg_q = _segments([100, 200, 300], 1000)
        seg_k = np.concatenate([np.zeros(150, np.int32),
                                np.full(400, 2, np.int32),
                                np.full(450, -1, np.int32)])
        causal, same = False, False
    return seg_q, seg_k, causal, same


def _varlen_case(name, dname, h, kvh, d, seed):
    """One correctness case of the varlen kernels (`_varlen_case_segs`):
    (q, k, v, seg_q, seg_k, causal, same_offsets), on the card."""
    import numpy as np
    import torch
    seg_q, seg_k, causal, same = _varlen_case_segs(name)
    g = torch.Generator(device="cuda")
    g.manual_seed(seed)
    dt = getattr(torch, dname)
    q = torch.randn((len(seg_q), h, d), generator=g, device="cuda").to(dt)
    k = torch.randn((len(seg_k), kvh, d), generator=g, device="cuda").to(dt)
    v = torch.randn((len(seg_k), kvh, d), generator=g, device="cuda").to(dt)
    sq = torch.from_numpy(np.ascontiguousarray(seg_q)).cuda()
    sk = sq if same else torch.from_numpy(np.ascontiguousarray(seg_k)).cuda()
    return q, k, v, sq, sk, causal, same


VARLEN_CASES = ("causal_same", "causal_unequal", "noncausal_unequal",
                "masked_rows")


def _varlen_flavors():
    """Correctness only: every case of VARLEN_CASES, GQA groups 1 and 4,
    D = 64 and 128, bf16 and fp32. Returns the max |error| of each."""
    import torch
    import paddle_tpu_torch.ops.varlen_attention as va
    errs = {}
    for name in VARLEN_CASES:
        for h, kvh in ((8, 8), (8, 2)):
            for d in (64, 128):
                for dname in ("bfloat16", "float32"):
                    q, k, v, sq, sk, causal, same = _varlen_case(
                        name, dname, h, kvh, d, seed=d + kvh)
                    scale = 1.0 / math.sqrt(d)
                    sqs, sks = va._sentinels(sq, sk)
                    o, lse = va._launch_fwd(q, k, v, sqs, sks, causal, scale,
                                            same)
                    torch.cuda.synchronize()
                    o_ref, lse_ref = va.varlen_fwd_reference(
                        q, k, v, sq, sk, causal, scale)
                    key = f"{name}/g{h // kvh}/d{d}/{dname}"
                    errs[key] = _check_kernels(
                        f"bucket_kernel {key}", dname, {"varlen_fwd": [o]},
                        {"varlen_fwd": [o_ref]}, lse, lse_ref)["varlen_fwd"]
                    dead = sqs < 0
                    if name == "masked_rows":
                        dead = dead | (sqs == 1)
                    if not (bool((o[dead] == 0).all()) and
                            bool((lse[:, dead] == -1e30).all())):
                        fail(f"bucket_kernel {key}: a row that sees nothing "
                             "is not o = 0, lse = -1e30")
    return errs


def _varlen_sdpa(q, k, v, lens):
    """A closure timing F.scaled_dot_product_attention (is_causal) once
    per packed prompt, summed; the per-prompt (1, H, n, D) copies, K/V
    repeated to the query heads, are made beforehand and not timed."""
    import torch.nn.functional as F
    grp = q.shape[1] // k.shape[1]
    docs, a = [], 0
    for n in lens:
        docs.append([t[a:a + n].transpose(0, 1)[None].repeat_interleave(
            r, dim=1).contiguous() for t, r in ((q, 1), (k, grp), (v, grp))])
        a += n

    def call():
        return [F.scaled_dot_product_attention(qd, kd, vd, is_causal=True)
                for qd, kd, vd in docs]
    return call


def _varlen_bound(dname, lens, t, h, kvh, d):
    """Least time for the serve prefill wave's attention: the real rows
    of q, k and v read once, the segment ids and distances (4 x T int32),
    o and lse written for every row, over the memory rate; or 4 flops
    per kept pair and head dim over the peak for the dtype."""
    elem = 4 if dname == "float32" else 2
    real = sum(lens)
    nbytes = (real * (h + 2 * kvh) * d * elem + 4 * t * 4
              + t * h * d * elem + h * t * 4)
    flops = 4 * d * h * sum(n * (n + 1) // 2 for n in lens)
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, flops / PEAK_FLOPS[dname]
    return (max(t_bytes, t_ops) * 1e3,
            "bytes" if t_bytes >= t_ops else "operations", nbytes, flops)


def phase_bucket_kernel(card):
    import torch
    import torch.nn.functional as F
    import paddle_tpu_torch.ops.paged_attention as pa
    import paddle_tpu_torch.ops.varlen_attention as va
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    t, h, kvh, d = (BUCKET_ATTN[x] for x in ("T", "H", "KVH", "D"))
    _, lens = _serve_rng()
    seg_np = _segments(lens, t)
    want_tiles, causal_tiles = _varlen_tiles(seg_np, seg_np, True)
    seg = torch.from_numpy(seg_np).cuda()
    sq, sk = va._sentinels(seg, seg)
    scale = 1.0 / math.sqrt(d)
    out = {}
    for dname in ("bfloat16", "float32"):
        dt = getattr(torch, dname)
        g = torch.Generator(device="cuda")
        g.manual_seed(0)
        q = torch.randn((t, h, d), generator=g, device="cuda").to(dt)
        k = torch.randn((t, kvh, d), generator=g, device="cuda").to(dt)
        v = torch.randn((t, kvh, d), generator=g, device="cuda").to(dt)
        o, lse, tiles = va._launch_fwd(q, k, v, sq, sk, True, scale, True,
                                       count_tiles=True)
        torch.cuda.synchronize()
        o_ref, lse_ref = va.varlen_fwd_reference(q, k, v, seg, seg, True,
                                                 scale)
        err = _check_kernels("bucket_kernel", dname, {"varlen_fwd": [o]},
                             {"varlen_fwd": [o_ref]}, lse, lse_ref)
        if tiles != want_tiles * h:
            fail(f"va_fwd ({dname}): computed {tiles} tiles, the skip rule "
                 f"gives {want_tiles} x {h} heads")
        if not bool((o[sq < 0] == 0).all()):
            fail(f"va_fwd ({dname}): padding rows are not zero")
        del o, lse, o_ref, lse_ref
        ms = cuda_ms(lambda: va._launch_fwd(q, k, v, sq, sk, True, scale,
                                            True), reps=20)
        plain_ms = cuda_ms(lambda: va.varlen_fwd_reference(
            q, k, v, seg, seg, True, scale), reps=3, warmup=1)
        library_ms = cuda_ms(_varlen_sdpa(q, k, v, lens), reps=20)
        bound_ms, bound_by, nbytes, flops = _varlen_bound(dname, lens, t, h,
                                                          kvh, d)
        row = {"phase": "bucket_kernel", "kernel": "varlen_fwd",
               "card": card, "dtype": dname, "T": t, "H": h, "KVH": kvh,
               "D": d, "prompt_lens": lens, "causal": True,
               "same_offsets": True, "tiles_computed_per_head": tiles // h,
               "tiles_causal_per_head": causal_tiles,
               "atol": TOL[dname][0], "rtol": TOL[dname][1],
               "max_abs_err": err["varlen_fwd"],
               "lse_max_abs_err": err["lse"], "kernel_ms": ms,
               "plain_ms": plain_ms, "library_ms": library_ms,
               "library_call": "sdpa (is_causal) per prompt, summed",
               "bound_ms": bound_ms, "bound_by": bound_by,
               "bound_bytes": nbytes, "bound_flops": flops,
               "tflops": flops / ms / 1e9, "tf32": False}
        emit(_design_row(row, "varlen_fwd", dname))
        out[("varlen_fwd", dname)] = row
        del q, k, v
        torch.cuda.empty_cache()
    emit({"phase": "bucket_kernel", "part": "varlen flavors", "card": card,
          "cases": list(VARLEN_CASES), "groups": [1, 4], "head_dims":
          [64, 128], "tol": TOL, "lse_tol": LSE_TOL,
          "max_abs_err": _varlen_flavors()})
    for name in VARIANTS:
        # a (B, QH, 1, D) verify batch is the decode batch, its bases
        # the lengths
        q, k, v, ks, vs, ptab, lengths = _verify_batch(name, DECODE_LENS, 1)
        q = q[:, :, 0].contiguous()
        kw = {"k_scale": ks, "v_scale": vs}
        ker = pa.paged_attention(q, k, v, ptab, lengths, **kw)
        torch.cuda.synchronize()
        ref = pa.paged_decode_reference(q, k, v, ptab, lengths, **kw)
        atol, rtol = TOL[VARIANTS[name][1]]
        max_err = float((ker.float() - ref.float()).abs().max())
        if not torch.allclose(ker.float(), ref.float(), atol=atol, rtol=rtol):
            fail(f"pa_decode vs plain ({name}): max |err| {max_err}")
        if not bool((ker[lengths == 0] == 0).all()):
            fail(f"pa_decode ({name}): the length-0 slot is not zero")
        ms = cuda_ms(lambda: pa.paged_attention(q, k, v, ptab, lengths, **kw),
                     reps=50)
        plain_ms = cuda_ms(lambda: pa.paged_decode_reference(
            q, k, v, ptab, lengths, **kw), reps=5, warmup=1)
        live = torch.nonzero(lengths > 0)[:, 0]
        grp = DECODE_SHAPE["QH"] // DECODE_SHAPE["KVH"]
        ncols = int(lengths.max())
        kd = _dense_kv(k, ks, ptab, live, ncols, grp, q.dtype)
        vd = _dense_kv(v, vs, ptab, live, ncols, grp, q.dtype)
        qd = q[live][:, :, None].contiguous()
        mask = (torch.arange(ncols, device="cuda")[None, :]
                < lengths[live][:, None])[:, None, None]
        library_ms = cuda_ms(lambda: F.scaled_dot_product_attention(
            qd, kd, vd, attn_mask=mask), reps=20)
        # decode at length n is a G = 1 verify chunk at base n - 1
        bound_ms, bound_by, nbytes, flops = _verify_bound(
            name, [n - 1 for n in DECODE_LENS], 1)
        kname = "paged_decode_int8" if VARIANTS[name][0] == "int8" \
            else "paged_decode"
        design = _paged_row(
            lambda **kw2: pa._launch(q, k, v, ptab, lengths,
                                     DECODE_SHAPE["D"] ** -0.5, ks, vs,
                                     **kw2),
            kname, name, q, k, list(DECODE_LENS), 1, bound_ms)
        row = {"phase": "bucket_kernel", "kernel": kname, "card": card,
               "variant": name, "pools": VARIANTS[name][0],
               "q_dtype": VARIANTS[name][1], "lengths": list(DECODE_LENS),
               **DECODE_SHAPE, "atol": atol, "rtol": rtol,
               "max_abs_err": max_err, "length0_zero": True,
               "kernel_ms": ms, **design, "plain_ms": plain_ms,
               "library_ms": library_ms,
               "library_call": "sdpa over the live slots' KV gathered "
                               "dense, masked to each length",
               "bound_ms": bound_ms, "bound_by": bound_by,
               "bound_bytes": nbytes, "bound_flops": flops, "tf32": False}
        emit(_design_row(row, kname, name))
        out[(kname, name)] = row
        del q, k, v, ks, vs, ker, ref, kd, vd
        torch.cuda.empty_cache()
    return out


def _bucket_counts():
    """Launches of every serving kernel, by kernel name."""
    import paddle_tpu_torch.kernels.ragged_paged_attention as rpa
    import paddle_tpu_torch.ops.flash_attention as fa
    import paddle_tpu_torch.ops.paged_attention as pa
    import paddle_tpu_torch.ops.varlen_attention as va
    return {"varlen_fwd": va.launches_fwd, "flash_fwd": fa.launches_fwd,
            "paged_decode": pa.launches_decode,
            "paged_decode_int8": pa.launches_decode_int8,
            "paged_verify": pa.launches_verify,
            "paged_verify_int8": pa.launches_verify_int8,
            "ragged_paged_attention": rpa.launches}


def _merge_launches():
    """Launches of the paged kernels' merge since the counts were reset
    (one per pa_decode / pa_verify launch where the split rule splits)."""
    import paddle_tpu_torch.ops.paged_attention as pa
    return pa.launches_merge


def _reset_bucket_counts():
    import paddle_tpu_torch.kernels.ragged_paged_attention as rpa
    import paddle_tpu_torch.ops.flash_attention as fa
    import paddle_tpu_torch.ops.paged_attention as pa
    import paddle_tpu_torch.ops.varlen_attention as va
    va.launches_fwd = fa.launches_fwd = rpa.launches = 0
    pa.launches_decode = pa.launches_decode_int8 = 0
    pa.launches_verify = pa.launches_verify_int8 = 0
    pa.launches_merge = 0


def _bucket_run(eng, pipelined, marks=None):
    """Run a bucketed engine with its prefill calls counted: (finished
    requests, {"waves": packed prefill_varlen waves, "singles": lone
    prefills}, launches by kernel). Given `marks`, appends the host time
    at which each admission's prefill was done: when the engine's
    prefill method returns, having read the seed logits, which waits
    for the device."""
    from paddle_tpu_torch.models import llama_serving as S
    calls = {"waves": 0, "singles": 0}
    originals = (S.prefill_varlen, S.prefill)

    def counted(fn, key):
        def wrapper(*a, **k):
            calls[key] += 1
            return fn(*a, **k)
        return wrapper
    S.prefill_varlen = counted(originals[0], "waves")
    S.prefill = counted(originals[1], "singles")
    if marks is not None:
        for name in ("_prefill_packed", "_prefill_into"):
            def marked(*a, _fn=getattr(eng, name), **k):
                out = _fn(*a, **k)
                marks.append(time.perf_counter())
                return out
            setattr(eng, name, marked)
    _reset_bucket_counts()
    try:
        done = eng.run_pipelined() if pipelined else eng.run()
    finally:
        S.prefill_varlen, S.prefill = originals
        if marks is not None:
            del eng._prefill_packed, eng._prefill_into
    return done, calls, _bucket_counts()


def _want_bucket_counts(layers, calls, steps, int8):
    """The launches of a bucketed run: va_fwd per layer and packed wave,
    fa_fwd per layer and lone prefill, pa_decode (its int8 variant with
    int8 pools) per layer and decode step, nothing ragged."""
    want = {k: 0 for k in _bucket_counts()}
    want["varlen_fwd"] = layers * calls["waves"]
    want["flash_fwd"] = layers * calls["singles"]
    want["paged_decode_int8" if int8 else "paged_decode"] = layers * steps
    return want


def phase_bucket_parity(card):
    import numpy as np
    import torch
    from paddle_tpu_torch.models.llama import LlamaConfig
    from paddle_tpu_torch.models.llama_spmd import init_params
    from paddle_tpu_torch.models.llama_serving import Request, ServingEngine
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cfg = dataclasses.replace(LlamaConfig.llama3_8b(),
                              num_hidden_layers=PARITY_LAYERS)
    cpu_params = init_params(cfg, seed=0, dtype=torch.float32, device="cpu")
    gpu_params = _tree_to(cpu_params, "cuda")
    rng = np.random.default_rng(1)
    lens = [17, 90, 180, 300]
    prompts = [rng.integers(0, cfg.vocab_size, n).tolist() for n in lens]
    L = cfg.num_hidden_layers
    runs = {}
    for cache in (None, "int8"):
        results, info = {}, {}
        for dev, params in (("cuda", gpu_params), ("cpu", cpu_params)):
            eng = ServingEngine(params, cfg, max_seqs=3, max_seq_len=512,
                                page_size=16, cache_dtype=cache,
                                ragged=False, device=dev)
            for i, p in enumerate(prompts):
                eng.submit(Request(i, p, max_new_tokens=16))
            t0 = time.perf_counter()
            done, calls, launches = _bucket_run(eng, pipelined=True)
            if dev == "cuda":
                torch.cuda.synchronize()
            info[dev] = {"seconds": time.perf_counter() - t0,
                         "device_steps": eng.device_steps, "calls": calls,
                         "launches": launches, "pad_tokens": eng.pad_tokens}
            if len(done) != 4 or not eng.pool.conserved(drained=True):
                fail(f"bucket_parity ({dev}): {len(done)} of 4 finished or "
                     "pool leaked")
            results[dev] = {r.rid: list(r.output) for r in done}
        g = info["cuda"]
        if g["calls"] != {"waves": 1, "singles": 1}:
            fail(f"bucket_parity: prefill calls {g['calls']}, want one "
                 "packed wave of three and one lone prefill")
        want = _want_bucket_counts(L, g["calls"], g["device_steps"],
                                   cache == "int8")
        if g["launches"] != want:
            fail(f"bucket_parity: launches {g['launches']}, want {want}")
        if any(info["cpu"]["launches"].values()):
            fail("bucket_parity: the CPU engine launched a CUDA kernel")
        compared = {}
        for rid, p in enumerate(prompts):
            a, b = results["cuda"][rid], results["cpu"][rid]
            j = next((i for i, (x, y) in enumerate(zip(a, b)) if x != y),
                     None)
            if j is None:
                compared[rid] = {"identical": len(a), "stopped_at": None}
                continue
            margin = _top2_margin(cpu_params, cfg, p + b[:j], 16)
            if margin >= 1e-3:
                fail(f"bucket_parity: request {rid} diverges at token {j} "
                     f"with CPU top-2 margin {margin}")
            compared[rid] = {"identical": j, "stopped_at": j,
                             "cpu_top2_margin": margin}
        name = "fp32" if cache is None else "int8"
        row = {"phase": "bucket_parity", "card": card, "pool": name,
               "config": f"llama3_8b widths, {PARITY_LAYERS} layer(s), "
                         "fp32, TF32 off, ragged=False, max_seqs 3, "
                         "run_pipelined",
               "prompt_lens": lens, "new_tokens": 16, "requests": compared,
               "prefill_calls": g["calls"], "launches": g["launches"],
               "device_steps": g["device_steps"],
               "pad_tokens": g["pad_tokens"],
               "cuda_seconds": g["seconds"],
               "cpu_seconds": info["cpu"]["seconds"]}
        emit(row)
        runs[name] = row
    del gpu_params
    torch.cuda.empty_cache()
    return runs


def phase_bucket_serve(card, cfg, params, init_s):
    import torch
    from paddle_tpu_torch.models.serving_capture import StepLogits
    runs = {}
    for cache in (None, "int8"):
        eng, reqs = serve_engine(cfg, params, cache, ragged=False)
        lens = [len(r.prompt) for r in reqs]
        finishes, prefills = [], []
        finish = eng.step_finish

        def timed_finish(ticket, inflight=None, _finish=finish):
            n = _finish(ticket, inflight=inflight)
            finishes.append(time.perf_counter())
            return n
        eng.step_finish = timed_finish
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        try:
            done, calls, launches = _bucket_run(eng, pipelined=True,
                                                marks=prefills)
        finally:
            del eng.step_finish
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        name = "bf16" if cache is None else "int8"
        if len(done) != 8:
            fail(f"bucket_serve ({name}): {len(done)} of 8 requests finished")
        for r in done:
            if len(r.output) != 64:
                fail(f"bucket_serve ({name}): request {r.rid} has "
                     f"{len(r.output)} tokens, want 64")
            if not all(0 <= t < cfg.vocab_size for t in r.output):
                fail(f"bucket_serve ({name}): request {r.rid} left the "
                     "vocabulary")
        want = _want_bucket_counts(cfg.num_hidden_layers, calls,
                                   eng.device_steps, cache == "int8")
        if launches != want:
            fail(f"bucket_serve ({name}): launches {launches}, want {want}")
        if not eng.pool.conserved(drained=True):
            fail(f"bucket_serve ({name}): page pool not conserved")
        # decode-only intervals: consecutive finishes with no prefill
        # call returning between them
        gaps = [b - a for a, b in zip(finishes, finishes[1:])
                if not any(a < p <= b for p in prefills)]
        last_prefill = max(prefills, default=t0)
        row = {"phase": "bucket_serve", "card": card, "pool": name,
               "config": SERVE_CONFIG + ", ragged=False",
               "prompt_lens": lens, "new_tokens": 64, "sampled": [0, 1],
               "wall_s": wall, "device_steps": eng.device_steps,
               "prefill_calls": calls, "prefill_tokens": eng.prefill_tokens,
               "pad_tokens": eng.pad_tokens,
               "prefill_tok_s": eng.prefill_tokens / (last_prefill - t0),
               "decode_step_ms_median": (statistics.median(gaps) * 1e3
                                         if gaps else None),
               "output_tok_s": 8 * 64 / wall, "launches": launches,
               "merge_launches": _merge_launches(),
               "params_init_s": init_s}
        streams = {r.rid: list(r.output) for r in done}
        # the logits each token was drawn from, for tp_serve: the same
        # requests again on the drained engine, untimed, which must give
        # the same streams
        n0 = len(eng.finished)
        for r in serve_requests(cfg):
            eng.submit(r)
        drawn = StepLogits(eng)
        try:
            again = eng.run_pipelined()[n0:]
        finally:
            drawn.close()
        row["capture_run_identical"] = \
            {r.rid: list(r.output) for r in again} == streams
        emit(row)
        if not row["capture_run_identical"]:
            fail(f"bucket_serve ({name}): the capture run's streams differ "
                 "from the timed run's")
        runs[name] = dict(row, streams=streams, drawn=drawn)
        del eng, done, again, reqs, drawn
        torch.cuda.empty_cache()
    return runs


# ------------------------------------------- speculative decoding
# pa_verify at 8B widths: bucket_kernel's 8 live slots as the cache
# lengths BEFORE a G = 4 chunk (the longest, 2000 + 4, fits 2048)
VERIFY_BASES = DECODE_LENS[:8]
VERIFY_G = 4
# correctness shapes (QH, KVH, G): the JAX tests' awkward rows, and 8B
# widths at chunked-prefill widths 16 (one 64-row tile) and 64 (four)
VERIFY_CASES = ((4, 2, 3), (4, 2, 5), (6, 2, 3), (32, 8, 16), (32, 8, 64))


def _verify_batch(variant, bases, g, qh=32, kvh=8, d=128, page=16, seed=0,
                  cap=DECODE_SHAPE["MAX_LEN"]):
    """pa_verify operands on the card, room for `cap` tokens a slot, pages
    in random order: (q (B, QH, G, D), k, v, ks, vs, ptab, base)."""
    import numpy as np
    import torch
    from paddle_tpu_torch.ops.paged_attention import quantize_kv
    pps = -(-cap // page)
    B = len(bases)
    P = B * pps + 1
    rng = np.random.default_rng(seed)
    ptab = rng.permutation(P - 1)[:B * pps].reshape(B, pps).astype(np.int32)
    gen = torch.Generator(device="cuda")
    gen.manual_seed(seed)
    pools, qname = VARIANTS[variant]
    qdt = getattr(torch, qname)
    q = torch.randn((B, qh, g, d), generator=gen, device="cuda").to(qdt)
    k = torch.randn((kvh, P, page, d), generator=gen, device="cuda")
    v = torch.randn((kvh, P, page, d), generator=gen, device="cuda")
    ks = vs = None
    if pools == "int8":
        k, ks = quantize_kv(k)
        v, vs = quantize_kv(v)
    else:
        k, v = k.to(qdt), v.to(qdt)
    return (q, k.contiguous(), v.contiguous(), ks, vs,
            torch.from_numpy(ptab).cuda(),
            torch.tensor(bases, dtype=torch.int32, device="cuda"))


def _verify_bound(variant, bases, g, cap=DECODE_SHAPE["MAX_LEN"]):
    """Least time for one pa_verify call at 8B widths (a pa_decode call
    at lengths n is one at bases n - 1, G = 1) in slots of `cap` tokens:
    each slot's K/V up to base + G (and their int8 scales) read once for
    all of a KV head's group x G rows, q read and the output written
    once, the page table and base lengths, over the memory rate; or 4
    flops per (query row, column it sees, head dim) over the peak for
    q's type."""
    pools, qname = VARIANTS[variant]
    QH, KVH, D = (DECODE_SHAPE[x] for x in ("QH", "KVH", "D"))
    kv_elem = {"float32": 4, "bfloat16": 2, "int8": 1}[pools]
    q_elem = 4 if qname == "float32" else 2
    # a row sees at most the slot's `cap` columns
    toks = sum(min(b + g, cap) for b in bases)
    per_tok = KVH * D * kv_elem * 2 + (KVH * 4 * 2 if pools == "int8" else 0)
    B = len(bases)
    nbytes = (toks * per_tok + 2 * B * QH * g * D * q_elem
              + B * (cap // DECODE_SHAPE["PAGE"] + 1) * 4)
    flops = 4 * QH * D * sum(min(b + i + 1, cap) for b in bases
                             for i in range(g))
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, flops / PEAK_FLOPS[qname]
    return (max(t_bytes, t_ops) * 1e3,
            "bytes" if t_bytes >= t_ops else "operations", nbytes, flops)


def _verify_flavors():
    """Correctness only: every VERIFY_CASES shape, D = 64 and 128, page 8
    and 16, every pool variant, on slots of base 0, 1, page - 1, 300 and
    2000 - G; each held to TOL. Returns the max |error| of each."""
    import torch
    import paddle_tpu_torch.ops.paged_attention as pa
    errs = {}
    for qh, kvh, g in VERIFY_CASES:
        for d in (64, 128):
            for page in (8, 16):
                for name in VARIANTS:
                    q, k, v, ks, vs, ptab, base = _verify_batch(
                        name, (0, 1, page - 1, 300, 2000 - g), g, qh, kvh,
                        d, page, seed=d + g)
                    kw = {"k_scale": ks, "v_scale": vs}
                    ker = pa.paged_verify_attention(q, k, v, ptab, base, **kw)
                    torch.cuda.synchronize()
                    ref = pa.paged_verify_reference(q, k, v, ptab, base, **kw)
                    atol, rtol = TOL[VARIANTS[name][1]]
                    key = f"{qh}/{kvh}/g{g}/d{d}/p{page}/{name}"
                    errs[key] = float((ker.float() - ref.float()).abs().max())
                    if not torch.allclose(ker.float(), ref.float(), atol=atol,
                                          rtol=rtol):
                        fail(f"pa_verify vs plain ({key}): max |err| "
                             f"{errs[key]}")
    return errs


def phase_spec_kernel(card):
    import torch
    import torch.nn.functional as F
    import paddle_tpu_torch.ops.paged_attention as pa
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    grp = DECODE_SHAPE["QH"] // DECODE_SHAPE["KVH"]
    out = {}
    for name in VARIANTS:
        q, k, v, ks, vs, ptab, base = _verify_batch(name, VERIFY_BASES,
                                                    VERIFY_G)
        kw = {"k_scale": ks, "v_scale": vs}
        ker = pa.paged_verify_attention(q, k, v, ptab, base, **kw)
        torch.cuda.synchronize()
        ref = pa.paged_verify_reference(q, k, v, ptab, base, **kw)
        atol, rtol = TOL[VARIANTS[name][1]]
        max_err = float((ker.float() - ref.float()).abs().max())
        if not torch.allclose(ker.float(), ref.float(), atol=atol, rtol=rtol):
            fail(f"pa_verify vs plain ({name}): max |err| {max_err}")
        # (b) G = 1 at base is pa_decode at base + 1, both kernels
        q1 = q[:, :, :1].contiguous()
        ver1 = pa.paged_verify_attention(q1, k, v, ptab, base, **kw)
        dec = pa.paged_attention(q1[:, :, 0].contiguous(), k, v, ptab,
                                 base + 1, **kw)
        torch.cuda.synchronize()
        g1_err = float((ver1[:, :, 0].float() - dec.float()).abs().max())
        if not torch.allclose(ver1[:, :, 0].float(), dec.float(), atol=atol,
                              rtol=rtol):
            fail(f"pa_verify G=1 vs pa_decode ({name}): max |err| {g1_err}")
        ms = cuda_ms(lambda: pa.paged_verify_attention(q, k, v, ptab, base,
                                                       **kw), reps=50)
        plain_ms = cuda_ms(lambda: pa.paged_verify_reference(
            q, k, v, ptab, base, **kw), reps=5, warmup=1)
        ncols = int(base.max()) + VERIFY_G
        slots = torch.arange(len(VERIFY_BASES), device="cuda")
        kd = _dense_kv(k, ks, ptab, slots, ncols, grp, q.dtype)
        vd = _dense_kv(v, vs, ptab, slots, ncols, grp, q.dtype)
        limit = base[:, None] + torch.arange(VERIFY_G, device="cuda") + 1
        mask = (torch.arange(ncols, device="cuda")[None, None]
                < limit[:, :, None])[:, None]             # (B, 1, G, cols)
        library_ms = cuda_ms(lambda: F.scaled_dot_product_attention(
            q, kd, vd, attn_mask=mask), reps=20)
        bound_ms, bound_by, nbytes, flops = _verify_bound(name, VERIFY_BASES,
                                                          VERIFY_G)
        kname = "paged_verify_int8" if VARIANTS[name][0] == "int8" \
            else "paged_verify"
        scale = DECODE_SHAPE["D"] ** -0.5
        design = _paged_row(
            lambda **kw2: pa._launch_verify(q, k, v, ptab, base, scale, ks,
                                            vs, **kw2),
            kname, name, q, k, [b + 1 for b in VERIFY_BASES], VERIFY_G,
            bound_ms)
        row = {"phase": "spec_kernel", "kernel": kname, "card": card,
               "variant": name, "pools": VARIANTS[name][0],
               "q_dtype": VARIANTS[name][1], "base_lengths":
               list(VERIFY_BASES), "G": VERIFY_G, **DECODE_SHAPE,
               "atol": atol, "rtol": rtol, "max_abs_err": max_err,
               "g1_vs_pa_decode_max_abs_err": g1_err,
               "kernel_ms": ms, **design, "plain_ms": plain_ms,
               "library_ms": library_ms,
               "library_call": "sdpa over the slots' KV gathered dense, "
                               "each row masked to base + g + 1",
               "bound_ms": bound_ms, "bound_by": bound_by,
               "bound_bytes": nbytes, "bound_flops": flops, "tf32": False}
        emit(_design_row(row, kname, name))
        out[name] = row
        del q, k, v, ks, vs, ker, ref, kd, vd, ver1, dec
        torch.cuda.empty_cache()
    emit({"phase": "spec_kernel", "part": "verify shapes", "card": card,
          "cases": [list(c) for c in VERIFY_CASES], "head_dims": [64, 128],
          "pages": [8, 16], "variants": list(VARIANTS), "tol": TOL,
          "max_abs_err": _verify_flavors()})
    return out


# the spec engines: name -> engine arguments
SPEC_ENGINES = {"bucketed": {"ragged": False, "spec_decode": 4},
                "chunked": {"ragged": False, "spec_decode": 4,
                            "chunked_prefill": True},
                "ragged": {"spec_decode": 4}}
SPEC_PARITY_LENS = (17, 45, 90, 150)
# new tokens a spec_parity request: the depth-2 random model falls into
# repeats (which prompt lookup drafts from) only after 16-30 tokens
SPEC_PARITY_NEW = 32


def _want_spec_counts(ragged, layers, calls, steps, int8):
    """The launches of a spec run: the ragged kernel per layer and step
    on the ragged engine; else pa_verify (its int8 variant with int8
    pools) per layer and step, va_fwd per layer and admission wave,
    fa_fwd per layer and lone prefill (none with chunked prefill), no
    decode kernel."""
    want = {k: 0 for k in _bucket_counts()}
    if ragged:
        want["ragged_paged_attention"] = layers * steps
        return want
    want["paged_verify_int8" if int8 else "paged_verify"] = layers * steps
    want["varlen_fwd"] = layers * calls["waves"]
    want["flash_fwd"] = layers * calls["singles"]
    return want


def phase_spec_parity(card):
    import numpy as np
    import torch
    from paddle_tpu_torch.models.llama import LlamaConfig
    from paddle_tpu_torch.models.llama_spmd import init_params
    from paddle_tpu_torch.models.llama_serving import Request, ServingEngine
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cfg = dataclasses.replace(LlamaConfig.llama3_8b(), num_hidden_layers=2)
    cpu_params = init_params(cfg, seed=0, dtype=torch.float32, device="cpu")
    gpu_params = _tree_to(cpu_params, "cuda")
    prompts = _motif_prompts(np.random.default_rng(1), cfg.vocab_size,
                             SPEC_PARITY_LENS)
    L = cfg.num_hidden_layers
    runs = {}
    for engine, ekw in SPEC_ENGINES.items():
        for cache in (None, "int8"):
            results, info = {}, {}
            for dev, params in (("cuda", gpu_params), ("cpu", cpu_params)):
                # all four requests at once: the CPU engine's steps are
                # most of the phase's time
                eng = ServingEngine(params, cfg, max_seqs=4, max_seq_len=512,
                                    page_size=16, ragged_tokens=16,
                                    cache_dtype=cache, device=dev, **ekw)
                for i, p in enumerate(prompts):
                    eng.submit(Request(i, p, max_new_tokens=SPEC_PARITY_NEW))
                t0 = time.perf_counter()
                done, calls, launches = _bucket_run(eng, pipelined=False)
                if dev == "cuda":
                    torch.cuda.synchronize()
                info[dev] = {"seconds": time.perf_counter() - t0,
                             "device_steps": eng.device_steps,
                             "calls": calls, "launches": launches,
                             "spec_drafted": eng.spec_drafted,
                             "spec_accepted": eng.spec_accepted}
                if len(done) != 4 or not eng.pool.conserved(drained=True):
                    fail(f"spec_parity ({engine}, {dev}): {len(done)} of 4 "
                         "finished or pool leaked")
                if eng.spec_drafted == 0:
                    fail(f"spec_parity ({engine}, {dev}): nothing drafted")
                results[dev] = {r.rid: list(r.output) for r in done}
            g = info["cuda"]
            want = _want_spec_counts(engine == "ragged", L, g["calls"],
                                     g["device_steps"], cache == "int8")
            if g["launches"] != want:
                fail(f"spec_parity ({engine}): launches {g['launches']}, "
                     f"want {want}")
            if engine != "bucketed" and g["calls"] != {"waves": 0,
                                                       "singles": 0}:
                fail(f"spec_parity ({engine}): prefill calls {g['calls']}")
            if any(info["cpu"]["launches"].values()):
                fail(f"spec_parity ({engine}): the CPU engine launched a "
                     "CUDA kernel")
            compared = {}
            for rid, p in enumerate(prompts):
                a, b = results["cuda"][rid], results["cpu"][rid]
                j = next((i for i, (x, y) in enumerate(zip(a, b)) if x != y),
                         None)
                if j is None and len(a) == len(b):
                    compared[rid] = {"identical": len(a), "stopped_at": None}
                    continue
                if j is None:
                    fail(f"spec_parity ({engine}): request {rid} lengths "
                         f"{len(a)} / {len(b)}")
                margin = _top2_margin(cpu_params, cfg, p + b[:j], 16)
                if margin >= 1e-3:
                    fail(f"spec_parity ({engine}): request {rid} diverges at "
                         f"token {j} with CPU top-2 margin {margin}")
                compared[rid] = {"identical": j, "stopped_at": j,
                                 "cpu_top2_margin": margin}
            name = f"{engine}_{'fp32' if cache is None else 'int8'}"
            row = {"phase": "spec_parity", "card": card, "run": name,
                   "engine": ekw, "config": f"llama3_8b widths, {L} "
                   "layers, fp32, TF32 off, max_seqs 4, run()",
                   "prompt_lens": list(SPEC_PARITY_LENS),
                   "new_tokens": SPEC_PARITY_NEW,
                   "requests": compared, "prefill_calls": g["calls"],
                   "launches": g["launches"],
                   "device_steps": g["device_steps"],
                   "spec_drafted": g["spec_drafted"],
                   "spec_accepted": g["spec_accepted"],
                   "cuda_seconds": g["seconds"],
                   "cpu_seconds": info["cpu"]["seconds"]}
            emit(row)
            runs[name] = row
    del gpu_params
    torch.cuda.empty_cache()
    return runs


# the spec_serve runs: name -> (engine arguments, pool)
SPEC_SERVE = {
    "bucketed_g4_bf16": ({"ragged": False, "spec_decode": 4}, None),
    "bucketed_g4_int8": ({"ragged": False, "spec_decode": 4}, "int8"),
    "chunked_g16_bf16": ({"ragged": False, "spec_decode": 16,
                          "chunked_prefill": True}, None),
    "ragged_g4_bf16": ({"ragged": True, "spec_decode": 4,
                        "ragged_tokens": None}, None)}


def phase_spec_serve(card, cfg, params, init_s, bserve):
    import torch
    prompts = echo_prompts(cfg, params)
    runs = {}
    for name, (ekw, cache) in SPEC_SERVE.items():
        eng, reqs = serve_engine(cfg, params, cache, prompts=prompts, **ekw)
        lens = [len(r.prompt) for r in reqs]
        steps, prefills = [], []
        spec_step = eng._spec_step

        def timed_step(_step=spec_step, _eng=eng):
            pre = any(_eng._prefilling(_eng._slots[s]) for s in _eng._live)
            a = time.perf_counter()
            n = _step()
            steps.append((a, time.perf_counter(), pre))
            return n
        eng._spec_step = timed_step
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        try:
            done, calls, launches = _bucket_run(eng, pipelined=False,
                                                marks=prefills)
        finally:
            del eng._spec_step
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        if len(done) != 8:
            fail(f"spec_serve ({name}): {len(done)} of 8 requests finished")
        for r in done:
            if len(r.output) != 64:
                fail(f"spec_serve ({name}): request {r.rid} has "
                     f"{len(r.output)} tokens, want 64")
            if not all(0 <= t < cfg.vocab_size for t in r.output):
                fail(f"spec_serve ({name}): request {r.rid} left the "
                     "vocabulary")
        want = _want_spec_counts(ekw["ragged"], cfg.num_hidden_layers, calls,
                                 eng.device_steps, cache == "int8")
        if launches != want:
            fail(f"spec_serve ({name}): launches {launches}, want {want}")
        if not eng.pool.conserved(drained=True):
            fail(f"spec_serve ({name}): page pool not conserved")
        if eng.spec_drafted == 0:
            fail(f"spec_serve ({name}): nothing drafted")
        # a step that fed no prompt chunk is a pure verify step; the
        # prefill ends with the last admission prefill or chunk fed
        verify = [b - a for a, b, pre in steps if not pre]
        last_prefill = max(prefills + [b for _, b, pre in steps if pre],
                           default=t0)
        plain = bserve.get("int8" if cache else "bf16", {})
        row = {"phase": "spec_serve", "card": card, "run": name,
               "engine": {k: v for k, v in ekw.items()}, "pool":
               "int8" if cache else "bf16",
               "config": SERVE_CONFIG + ", echo prompts (`echo_prompts`)",
               "prompt_lens": lens, "new_tokens": 64, "sampled": [0, 1],
               "wall_s": wall, "device_steps": eng.device_steps,
               "verify_steps": len(verify), "prefill_calls": calls,
               "prefill_tokens": eng.prefill_tokens,
               "prefill_tok_s": eng.prefill_tokens / (last_prefill - t0),
               "verify_step_ms_median": (statistics.median(verify) * 1e3
                                         if verify else None),
               "output_tok_s": 8 * 64 / wall,
               "spec_drafted": eng.spec_drafted,
               "spec_accepted": eng.spec_accepted,
               "accept_rate": eng.spec_accepted / eng.spec_drafted,
               "logit_rows": eng.logit_rows, "launches": launches,
               "merge_launches": _merge_launches(),
               "bucket_serve_plain": {
                   k: plain.get(k) for k in (
                       "output_tok_s", "decode_step_ms_median",
                       "prefill_tok_s", "device_steps")},
               "params_init_s": init_s}
        emit(row)
        runs[name] = row
        del eng
        torch.cuda.empty_cache()
    return runs


# ------------------------------------------- prefix cache, tier, handoff
PREFIX_VARIANTS = ("float32", "bfloat16", "int8")
# (a) the bucketed suffix prefill's pa_verify: slot 0 active over a
# cached 1024-token prefix, its suffix of n tokens in a chunk of its
# bucket G; the other slots inactive at the lengths live and free slots
# hold, their rows computed as the engine's call computes them; slots of
# 1024 + 2048 columns (rows past a slot's cap see the cap)
PREFIX_VERIFY_BASES = (1024, 0, 100, 400, 0, 1000, 1500, 0)
PREFIX_SUFFIXES = ((300, 512), (1500, 2048))        # (suffix tokens, G)
PREFIX_VERIFY_CAP = 1024 + 2048


def _prefix_wave_rows():
    """A ragged wave of a prefix hit: slot 0 feeds 256 prompt tokens at
    positions 1024-1279 over its cached 1024-token prefix, slots 1-3
    decode at lengths 100, 1000 and 2000, inactive rows up to T = 272."""
    import numpy as np
    T = 272
    lens = [1280, 100, 1000, 2000]
    slot = np.zeros(T, np.int32)
    pos = np.full(T, -1, np.int32)
    pos[:256] = np.arange(1024, 1280)
    slot[256:259] = np.arange(1, 4)
    pos[256:259] = np.array(lens[1:]) - 1
    return lens, slot, pos


def _prefix_verify_rows(q, k, v, ks, vs, ptab, base):
    """The plain verify one slot at a time (the whole batch's fp32 scores
    at G = 2048 would take 20 GB)."""
    import torch
    import paddle_tpu_torch.ops.paged_attention as pa
    return torch.cat([pa.paged_verify_reference(
        q[i:i + 1], k, v, ptab[i:i + 1], base[i:i + 1], k_scale=ks,
        v_scale=vs) for i in range(q.shape[0])])


def phase_prefix_kernel(card):
    import torch
    import torch.nn.functional as F
    import paddle_tpu_torch.kernels.ragged_paged_attention as rpa
    import paddle_tpu_torch.ops.paged_attention as pa
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    grp = DECODE_SHAPE["QH"] // DECODE_SHAPE["KVH"]
    cap = PREFIX_VERIFY_CAP
    out = {}
    for n, G in PREFIX_SUFFIXES:
        for name in PREFIX_VARIANTS:
            q, k, v, ks, vs, ptab, base = _verify_batch(
                name, PREFIX_VERIFY_BASES, G, seed=G, cap=cap)
            kw = {"k_scale": ks, "v_scale": vs}
            ker = pa.paged_verify_attention(q, k, v, ptab, base, **kw)
            torch.cuda.synchronize()
            ref = _prefix_verify_rows(q, k, v, ks, vs, ptab, base)
            atol, rtol = TOL[VARIANTS[name][1]]
            err = (ker.float() - ref.float()).abs()
            max_err = float(err.max())
            if not torch.allclose(ker.float(), ref.float(), atol=atol,
                                  rtol=rtol):
                fail(f"prefix_kernel pa_verify G={G} ({name}): max |err| "
                     f"{max_err}")
            ms = cuda_ms(lambda: pa.paged_verify_attention(
                q, k, v, ptab, base, **kw), reps=20)
            plain_ms = cuda_ms(lambda: pa.paged_verify_reference(
                q, k, v, ptab, base, **kw), reps=3, warmup=1)
            ncols = min(int(base.max()) + G, cap)
            slots = torch.arange(len(PREFIX_VERIFY_BASES), device="cuda")
            kd = _dense_kv(k, ks, ptab, slots, ncols, grp, q.dtype)
            vd = _dense_kv(v, vs, ptab, slots, ncols, grp, q.dtype)
            limit = (base[:, None] + torch.arange(G, device="cuda")
                     + 1).clamp(max=cap)
            mask = (torch.arange(ncols, device="cuda")[None, None]
                    < limit[:, :, None])[:, None]
            library_ms = cuda_ms(lambda: F.scaled_dot_product_attention(
                q, kd, vd, attn_mask=mask), reps=10)
            bound_ms, bound_by, nbytes, flops = _verify_bound(
                name, PREFIX_VERIFY_BASES, G, cap)
            kname = "paged_verify_int8" if VARIANTS[name][0] == "int8" \
                else "paged_verify"
            design = _paged_row(
                lambda **kw2: pa._launch_verify(
                    q, k, v, ptab, base, DECODE_SHAPE["D"] ** -0.5, ks, vs,
                    **kw2),
                kname, name, q, k, [b + 1 for b in PREFIX_VERIFY_BASES], G,
                bound_ms, cap=cap)
            row = {"phase": "prefix_kernel", "part": "suffix_verify",
                   "kernel": kname, "card": card, "variant": name,
                   "pools": VARIANTS[name][0],
                   "q_dtype": VARIANTS[name][1],
                   "base_lengths": list(PREFIX_VERIFY_BASES),
                   "active_slot": 0, "suffix_tokens": n, "G": G,
                   "cap": cap, **DECODE_SHAPE, "atol": atol, "rtol": rtol,
                   "max_abs_err": max_err,
                   "active_rows_max_abs_err": float(err[0, :, :n].max()),
                   "kernel_ms": ms, **design, "plain_ms": plain_ms,
                   "library_ms": library_ms,
                   "library_call": "sdpa over the slots' KV gathered "
                                   "dense, each row masked to base + g + "
                                   "1 (at most the cap)",
                   "library_factor": ms / library_ms,
                   "bound_ms": bound_ms, "bound_by": bound_by,
                   "bound_share": bound_ms / ms, "bound_bytes": nbytes,
                   "bound_flops": flops, "tf32": False}
            emit(row)
            out[(kname, name, G)] = row
            del q, k, v, ks, vs, ker, ref, err, kd, vd, mask
            torch.cuda.empty_cache()
    for name in PREFIX_VARIANTS:
        q, k, v, ks, vs, ptab, slot, pos, info = _mixed_wave(
            name, rows=_prefix_wave_rows)
        kw = {"k_scale": ks, "v_scale": vs}
        ker = rpa.ragged_paged_attention(q, k, v, ptab, slot, pos, **kw)
        torch.cuda.synchronize()
        ref = rpa.ragged_paged_attention_reference(q, k, v, ptab, slot, pos,
                                                   **kw)
        active = pos >= 0
        max_err = float((ker.float() - ref.float()).abs()[active].max())
        atol, rtol = TOL[VARIANTS[name][1]]
        if not torch.allclose(ker.float()[active], ref.float()[active],
                              atol=atol, rtol=rtol):
            fail(f"prefix_kernel ragged ({name}): max |err| {max_err}")
        if not bool((ker[~active] == 0).all()):
            fail(f"prefix_kernel ragged ({name}): inactive rows not zero")
        route = rpa.route(q.dtype, k.dtype, info["D"], grp)
        tiles = plan_tiles = None
        if route == rpa.TENSOR_CORES:
            _, tiles = rpa._launch(q, k, v, ptab, slot, pos,
                                   info["D"] ** -0.5, ks, vs,
                                   count_tiles=True)
            plan = rpa.ragged_tile_plan(slot.cpu(), pos.cpu(), grp,
                                        ptab.shape[1] * info["PAGE"])
            plan_tiles = info["KVH"] * int(plan[:, 2].sum())
            if tiles != plan_tiles:
                fail(f"prefix_kernel ragged ({name}): {tiles} k tiles, the "
                     f"plan has {plan_tiles}")
        ms = cuda_ms(lambda: rpa.ragged_paged_attention(
            q, k, v, ptab, slot, pos, **kw), reps=20)
        plain_ms = cuda_ms(lambda: rpa.ragged_paged_attention_reference(
            q, k, v, ptab, slot, pos, **kw), reps=5, warmup=1)
        library_ms = cuda_ms(_library_call(q, k, v, ks, vs, ptab, slot, pos,
                                           info), reps=10)
        bound_ms, bound_by, nbytes, flops = _bound(name, info, pos.cpu())
        kname = "ragged_paged_attention" + \
            ("_int8" if VARIANTS[name][0] == "int8" else "")
        row = {"phase": "prefix_kernel", "part": "ragged_prefix_run",
               "kernel": kname, "card": card, "variant": name,
               "pools": VARIANTS[name][0], "q_dtype": VARIANTS[name][1],
               "lens": info["lens"], "T": info["T"],
               "active_rows": info["active"], "atol": atol, "rtol": rtol,
               "max_abs_err": max_err, "route": route, "tiles": tiles,
               "plan_tiles": plan_tiles, "kernel_ms": ms,
               "plain_ms": plain_ms, "library_ms": library_ms,
               "library_factor": ms / library_ms, "bound_ms": bound_ms,
               "bound_by": bound_by, "bound_share": bound_ms / ms,
               "bound_bytes": nbytes, "bound_flops": flops, "tf32": False}
        emit(row)
        out[(kname, name, "ragged")] = row
        del q, k, v, ks, vs, ker, ref
        torch.cuda.empty_cache()
    return out


# the prefix engines: name -> engine arguments
PREFIX_ENGINES = {"ragged": {},
                  "bucketed": {"ragged": False},
                  "chunked": {"ragged": False, "spec_decode": 4,
                              "chunked_prefill": True}}
PREFIX_PARITY_NEW = 8
# depth 1 (2 before the tp phases were added): at the 4096 vocabulary a
# layer is most of a CPU step, and the layer loop at depth 2 stays held
# card against CPU by parity, bucket_parity and spec_parity
PREFIX_PARITY_LAYERS = 1
PREFIX_PARITY_ENGINE = dict(max_seqs=2, max_seq_len=128, page_size=16,
                            ragged_tokens=32, num_pages=12,
                            prefix_cache=True)


def _prefix_parity_traffic(vocab):
    """prefix_parity's traffic (numpy seed 5): three prompts behind one
    48-token header (3 pages), a 41-token first turn, a burst of four
    40-token prompts with distinct leading tokens (which evicts the first
    turn from 11 pages), and the returning turn (history + 8 tokens)."""
    import numpy as np
    rng = np.random.default_rng(5)

    def draw(n):
        return rng.integers(1, vocab, n).tolist()
    header = draw(48)
    shared = [header + draw(n) for n in (5, 20, 33)]
    turn1 = draw(41)     # + 8 tokens: 48 cached positions, 3 pages
    burst = [[vocab - 1 - i] + draw(39) for i in range(4)]
    return shared, turn1, burst, draw(8)


def _trace_calls(eng, names):
    """Wrap the engine's `names` methods; returns the list each call
    appends to: (name, host time at return, pa_verify launches made)."""
    import paddle_tpu_torch.ops.paged_attention as pa
    trace = []
    for n in names:
        def traced(*a, _n=n, _fn=getattr(eng, n), **k):
            before = pa.launches_verify + pa.launches_verify_int8
            out = _fn(*a, **k)
            trace.append((_n, time.perf_counter(), pa.launches_verify
                          + pa.launches_verify_int8 - before))
            return out
        setattr(eng, n, traced)
    return trace


def _call_counts(trace, names):
    return {n: sum(1 for c in trace if c[0] == n) for n in names}


def _prefix_script(eng, traffic, new):
    """Run prefix_parity's traffic through `eng` (run()): the shared
    prompts one then two, the first turn, the burst one at a time, the
    returning turn. Returns ({rid: tokens}, {rid: cached_tokens},
    prefill_tokens after each phase, {rid: prompt})."""
    from paddle_tpu_torch.models.llama_serving import Request
    shared, turn1, burst, more = traffic
    prompts, steps = {}, []

    def phase(reqs):
        for rid, p in reqs:
            prompts[rid] = p
            eng.submit(Request(rid, p, max_new_tokens=new))
        eng.run()
        eng.host_tier.flush(timeout=60)
        steps.append(eng.prefill_tokens)
    phase([("s0", shared[0])])
    phase([("s1", shared[1]), ("s2", shared[2])])
    phase([("t1", turn1)])
    for i, p in enumerate(burst):
        phase([(f"b{i}", p)])
    out1 = next(r for r in eng.finished if r.rid == "t1").output
    phase([("t2", turn1 + list(out1) + more)])
    done = {r.rid: r for r in eng.finished}
    return ({rid: list(r.output) for rid, r in done.items()},
            {rid: r.cached_tokens for rid, r in done.items()}, steps,
            prompts)


def _same_streams(what, card_out, cpu_out, prompts, cpu_params, cfg):
    """Card tokens against the CPU's, as spec_parity holds them: equal,
    or parting only where the CPU's top-2 logit margin is under 1e-3.
    Returns {rid: {"identical": n, ...}}."""
    compared = {}
    for rid, b in cpu_out.items():
        a = card_out[rid]
        j = next((i for i, (x, y) in enumerate(zip(a, b)) if x != y), None)
        if j is None and len(a) == len(b):
            compared[rid] = {"identical": len(a), "stopped_at": None}
            continue
        if j is None:
            fail(f"{what}: request {rid} lengths {len(a)} / {len(b)}")
        margin, top = _top2_margin(cpu_params, cfg, prompts[rid] + b[:j],
                                   16, with_top=True)
        if margin >= 1e-3:
            fail(f"{what}: request {rid} diverges at token {j} with CPU "
                 f"top-2 margin {margin} (top logit {top})")
        compared[rid] = {"identical": j, "stopped_at": j,
                         "cpu_top2_margin": margin, "top_logit": top}
    return compared


def _want_prefix_counts(engine, layers, calls, steps, int8):
    """The launches of a prefix run: the ragged kernel per layer and step
    (ragged); else the decode (plain bucketed) or verify (chunked) kernel
    per layer and step, pa_verify per layer and suffix prefill, va_fwd
    per layer and packed wave of misses, fa_fwd per layer and lone miss."""
    want = {k: 0 for k in _bucket_counts()}
    if engine == "ragged":
        want["ragged_paged_attention"] = layers * steps
        return want
    verify = "paged_verify_int8" if int8 else "paged_verify"
    decode = "paged_decode_int8" if int8 else "paged_decode"
    if engine == "chunked":
        want[verify] = layers * steps
    else:
        want[decode] = layers * steps
        want[verify] = layers * calls["_prefill_suffix_into"]
        want["varlen_fwd"] = layers * calls["_prefill_packed"]
        want["flash_fwd"] = layers * calls["_prefill_into"]
    return want


PREFILL_CALLS = ("_prefill_suffix_into", "_prefill_packed", "_prefill_into")


def phase_prefix_parity(card):
    import torch
    from paddle_tpu_torch.models.llama import LlamaConfig
    from paddle_tpu_torch.models.llama_spmd import init_params
    from paddle_tpu_torch.models.llama_serving import Request, ServingEngine
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    # the vocabulary cut to 4096, as train_parity's, and the depth to
    # PREFIX_PARITY_LAYERS: the CPU engines' steps are most of the phase
    cfg = dataclasses.replace(LlamaConfig.llama3_8b(),
                              num_hidden_layers=PREFIX_PARITY_LAYERS,
                              vocab_size=4096)
    L = cfg.num_hidden_layers
    cpu_params = init_params(cfg, seed=0, dtype=torch.float32, device="cpu")
    gpu_params = _tree_to(cpu_params, "cuda")
    traffic = _prefix_parity_traffic(cfg.vocab_size)
    new = PREFIX_PARITY_NEW
    runs, cpu_ragged = {}, None
    for engine, ekw in PREFIX_ENGINES.items():
        for cache in (None, "int8"):
            name = f"{engine}_{'fp32' if cache is None else 'int8'}"
            res = {}
            for dev, params, tier in (("cuda", gpu_params, 1 << 30),
                                      ("cuda_tier_off", gpu_params, 0),
                                      ("cpu", cpu_params, 1 << 30)):
                eng = ServingEngine(params, cfg, cache_dtype=cache,
                                    host_tier_bytes=tier,
                                    tier_quantize=False,
                                    device=dev.split("_")[0],
                                    **PREFIX_PARITY_ENGINE, **ekw)
                trace = _trace_calls(eng, PREFILL_CALLS)
                _reset_bucket_counts()
                t0 = time.perf_counter()
                out, cached, steps, prompts = _prefix_script(eng, traffic,
                                                             new)
                if dev != "cpu":
                    torch.cuda.synchronize()
                res[dev] = {"out": out, "cached": cached, "steps": steps,
                            "calls": _call_counts(trace, PREFILL_CALLS),
                            "launches": _bucket_counts(),
                            "device_steps": eng.device_steps,
                            "tier": eng.host_tier.stats(),
                            "seconds": time.perf_counter() - t0}
                if not eng.pool.conserved(drained=True):
                    fail(f"prefix_parity ({name}, {dev}): pool leaked")
                if dev == "cpu" and any(res[dev]["launches"].values()):
                    fail(f"prefix_parity ({name}): the CPU engine launched "
                         "a CUDA kernel")
            g, c, off = res["cuda"], res["cpu"], res["cuda_tier_off"]
            if name == "ragged_fp32":
                cpu_ragged = (c["out"], prompts)
            compared = _same_streams(f"prefix_parity ({name})", g["out"],
                                     c["out"], prompts, cpu_params, cfg)
            tier_off = _same_streams(f"prefix_parity ({name}, tier off)",
                                     off["out"], c["out"], prompts,
                                     cpu_params, cfg)
            if g["cached"] != c["cached"] or g["steps"] != c["steps"]:
                fail(f"prefix_parity ({name}): cached {g['cached']} / "
                     f"{c['cached']}, prefill tokens {g['steps']} / "
                     f"{c['steps']}")
            if g["cached"]["s1"] != 48 or g["cached"]["t2"] != 48:
                fail(f"prefix_parity ({name}): cached tokens "
                     f"{g['cached']}")
            if g["tier"]["hits"] < 1 or g["tier"]["copy_errors"]:
                fail(f"prefix_parity ({name}): tier {g['tier']}")
            t2 = len(prompts["t2"])
            if g["steps"][-1] - g["steps"][-2] != t2 - g["cached"]["t2"]:
                fail(f"prefix_parity ({name}): the returning turn "
                     f"prefilled {g['steps'][-1] - g['steps'][-2]} of "
                     f"{t2} tokens with {g['cached']['t2']} cached")
            want = _want_prefix_counts(engine, L, g["calls"],
                                       g["device_steps"], cache == "int8")
            if g["launches"] != want:
                fail(f"prefix_parity ({name}): launches {g['launches']}, "
                     f"want {want}")
            row = {"phase": "prefix_parity", "card": card, "run": name,
                   "engine": ekw, "config": f"llama3_8b widths, {L} "
                   "layers, vocabulary 4096, fp32, TF32 off, "
                   + json.dumps(PREFIX_PARITY_ENGINE),
                   "tier": "1 GiB, tier_quantize False (off: 0)",
                   "requests": compared, "tier_off_vs_cpu": tier_off,
                   "cached_tokens": g["cached"],
                   "prefill_tokens_by_phase": g["steps"],
                   "prefill_tokens_tier_off": off["steps"],
                   "prefill_calls": g["calls"], "launches": g["launches"],
                   "device_steps": g["device_steps"],
                   "tier_stats": g["tier"], "cuda_seconds": g["seconds"],
                   "cpu_seconds": c["seconds"]}
            emit(row)
            runs[name] = row
    runs["handoff"] = _prefix_handoffs(card, cfg, gpu_params, cpu_params,
                                       traffic, cpu_ragged)
    del gpu_params
    torch.cuda.empty_cache()
    return runs


def _handoff_pair(pre, dec, prompts, new):
    """Export every prompt from `pre`, import each payload into `dec` as
    the JAX scheduler re-submits it. Returns {rid: tokens}."""
    from paddle_tpu_torch.models.llama_serving import Request
    for rid, p in prompts.items():
        r = Request(rid, p, max_new_tokens=new)
        r._handoff_export = True
        pre.submit(r)
    pre.run()
    hs = {r.rid: r._handoff_done for r in pre.finished}
    if any(h is None for h in hs.values()):
        fail("prefix_parity handoff: an export failed")
    for rid, h in hs.items():
        r = Request(rid, h.prompt, max_new_tokens=new)
        r.output, r.next_token = list(h.output), h.next_token
        r.cached_tokens = h.cached_tokens
        r._kv_import = h
        dec.submit(r)
    return {r.rid: list(r.output) for r in dec.run()}


def _prefix_handoffs(card, cfg, gpu_params, cpu_params, traffic,
                     cpu_ragged):
    """Ragged prefill engine to ragged decode engine, both on the card,
    with int8 and fp32 pools and tier_quantize both ways, against the
    single card engine; then the CPU engine's export imported on the
    card, against the CPU's tokens. handoff_bytes agree, both pools
    drain conserved."""
    import torch
    from paddle_tpu_torch.models.llama_serving import Request, ServingEngine
    shared = traffic[0]
    prompts = {f"s{i}": p for i, p in enumerate(shared)}
    new = PREFIX_PARITY_NEW
    out = {}

    def make(params, dev, cache, quantize):
        return ServingEngine(params, cfg, cache_dtype=cache,
                             host_tier_bytes=1 << 30,
                             tier_quantize=quantize, device=dev,
                             **PREFIX_PARITY_ENGINE)
    for cache in (None, "int8"):
        single = make(gpu_params, "cuda", cache, False)
        for rid, p in prompts.items():
            single.submit(Request(rid, p, max_new_tokens=new))
        want = {r.rid: list(r.output) for r in single.run()}
        for quantize in (False, True):
            pre = make(gpu_params, "cuda", cache, quantize)
            dec = make(gpu_params, "cuda", cache, quantize)
            got = _handoff_pair(pre, dec, prompts, new)
            torch.cuda.synchronize()
            # an fp32 pool's pages cross int8-quantized with
            # tier_quantize: lossy, so its tokens are reported only
            lossless = cache == "int8" or not quantize
            same = sum(a == b for rid in want
                       for a, b in zip(got[rid], want[rid]))
            if lossless:
                _same_streams(f"prefix_parity handoff ({cache}, "
                              f"tier_quantize {quantize})", got, want,
                              prompts, cpu_params, cfg)
            if pre.handoff_bytes != dec.handoff_bytes or \
                    dec.handoff_imports != len(prompts) or \
                    pre.handoff_failures or dec.handoff_failures:
                fail(f"prefix_parity handoff ({cache}, {quantize}): bytes "
                     f"{pre.handoff_bytes} / {dec.handoff_bytes}, imports "
                     f"{dec.handoff_imports}")
            for e in (pre, dec):
                if not e.pool.conserved(drained=True) or e._live:
                    fail(f"prefix_parity handoff ({cache}, {quantize}): a "
                         "pool leaked")
            key = f"card_to_card_{'fp32' if cache is None else 'int8'}" \
                f"_{'int8' if quantize else 'verbatim'}"
            out[key] = {"identical": got == want, "lossless": lossless,
                        "tokens_equal": same,
                        "tokens": sum(len(t) for t in want.values()),
                        "handoff_bytes": pre.handoff_bytes}
    cpu_out, cpu_prompts = cpu_ragged
    pre = make(cpu_params, "cpu", None, False)
    dec = make(gpu_params, "cuda", None, False)
    got = _handoff_pair(pre, dec, prompts, new)
    want = {rid: cpu_out[rid] for rid in prompts}
    out["cpu_to_card"] = _same_streams("prefix_parity handoff (CPU to card)",
                                       got, want, cpu_prompts, cpu_params,
                                       cfg)
    if pre.handoff_bytes != dec.handoff_bytes or \
            not dec.pool.conserved(drained=True):
        fail("prefix_parity handoff (CPU to card): bytes or pool")
    row = {"phase": "prefix_parity", "card": card, "run": "handoff",
           "engine": "ragged", **out,
           "cpu_to_card_bytes": dec.handoff_bytes}
    emit(row)
    return row


# prefix_serve (a): the multi-turn workload of bench_models.py's
# _bench_serving_multiturn at 8B; (b) a shared system prompt
PREFIX_SERVE_MT = dict(max_seqs=4, max_seq_len=2048, page_size=16,
                       ragged_tokens=256, num_pages=257, prefix_cache=True)
PREFIX_SERVE_MT_RUNS = {"tier_off": (0, True), "tier_int8": (1 << 30, True),
                        "tier_verbatim": (1 << 30, False)}
PREFIX_SERVE_SYS = dict(max_seqs=8, max_seq_len=2048, page_size=16,
                        ragged=False)


def _multiturn_traffic(vocab):
    """8 conversations of 1024-token prompts with distinct leading tokens,
    a burst of 8 more, and each returning turn's 64 new tokens (numpy
    seed 4)."""
    import numpy as np
    rng = np.random.default_rng(4)

    def prompt(lead):
        return [lead] + rng.integers(1, vocab, 1023).tolist()
    convs = [prompt(vocab - 1 - i) for i in range(8)]
    burst = [prompt(vocab - 9 - i) for i in range(8)]
    more = [rng.integers(1, vocab, 64).tolist() for _ in range(8)]
    return convs, burst, more


def _prefix_multiturn(card, cfg, params, name, tier, quantize, traffic):
    import torch
    from paddle_tpu_torch.models.llama_serving import Request, ServingEngine
    convs, burst, more = traffic
    eng = ServingEngine(params, cfg, host_tier_bytes=tier,
                        tier_quantize=quantize, device="cuda",
                        **PREFIX_SERVE_MT)
    for i, p in enumerate(convs):
        eng.submit(Request(f"c{i}", p, max_new_tokens=32))
    eng.run_pipelined()
    for i, p in enumerate(burst):
        eng.submit(Request(f"b{i}", p, max_new_tokens=4))
        eng.run_pipelined()
    eng.host_tier.flush(timeout=120)
    first = {r.rid: list(r.output) for r in eng.finished}
    returning = {f"r{i}": convs[i] + first[f"c{i}"] + more[i]
                 for i in range(8)}
    seeded = {}
    seed = eng._seed_first_token

    def timed_seed(slot, req, row):
        seed(slot, req, row)
        seeded.setdefault(req.rid, time.perf_counter())
    eng._seed_first_token = timed_seed
    # the pump thread's seconds in tier restores and spill snapshots
    # (host clock; their copies run on after the calls return)
    pump = {"restore_s": 0.0, "restore_calls": 0, "spill_s": 0.0,
            "spill_calls": 0}

    def clocked(fn, key):
        def run(*a, **k):
            t = time.perf_counter()
            try:
                return fn(*a, **k)
            finally:
                pump[key + "_s"] += time.perf_counter() - t
                pump[key + "_calls"] += 1
        return run
    eng._tier_restore = clocked(eng._tier_restore, "restore")
    if eng.prefix_cache.on_spill is not None:
        eng.prefix_cache.on_spill = clocked(eng.prefix_cache.on_spill,
                                            "spill")
    _reset_bucket_counts()
    pt0, steps0 = eng.prefill_tokens, eng.device_steps
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for rid, p in returning.items():
        eng.submit(Request(rid, p, max_new_tokens=32))
    eng.run_pipelined()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    eng.host_tier.flush(timeout=120)
    done = {r.rid: r for r in eng.finished if r.rid in returning}
    launches = _bucket_counts()
    prefill = eng.prefill_tokens - pt0
    want = sum(len(p) - done[rid].cached_tokens
               for rid, p in returning.items())
    st = eng.host_tier.stats()
    if len(done) != 8 or any(len(r.output) != 32 for r in done.values()):
        fail(f"prefix_serve ({name}): returning turns unfinished")
    if prefill != want:
        fail(f"prefix_serve ({name}): the returning turn prefilled "
             f"{prefill} tokens, prompt - cached is {want}")
    if st["copy_errors"]:
        fail(f"prefix_serve ({name}): {st['copy_errors']} copy errors")
    if not eng.pool.conserved(drained=True):
        fail(f"prefix_serve ({name}): page pool not conserved")
    want_launches = {k: 0 for k in launches}
    want_launches["ragged_paged_attention"] = \
        cfg.num_hidden_layers * (eng.device_steps - steps0)
    if launches != want_launches:
        fail(f"prefix_serve ({name}): launches {launches}, want "
             f"{want_launches}")
    ttft = sorted(seeded[rid] - t0 for rid in returning)
    row = {"phase": "prefix_serve", "part": "multiturn", "card": card,
           "run": name, "config": SERVE_CONFIG, "engine": PREFIX_SERVE_MT,
           "host_tier_bytes": tier, "tier_quantize": quantize,
           "conversations": 8, "prompt_tokens": 1024, "first_new": 32,
           "burst": 8, "returning_new_prompt_tokens": 64,
           "returning_new": 32,
           "returning_prompt_tokens": sum(map(len, returning.values())),
           "returning_cached_tokens": sum(r.cached_tokens
                                          for r in done.values()),
           "returning_prefill_tokens": prefill,
           "returning_wall_s": wall,
           "returning_device_steps": eng.device_steps - steps0,
           "ttft_s_median": statistics.median(ttft),
           "ttft_s": ttft, "pump": pump, "launches": launches,
           "tier_stats": st, "host_bytes": st["host_bytes"],
           "prefix_cache": eng.prefix_cache.stats(),
           "tokens": {rid: list(r.output) for rid, r in done.items()}}
    return row


def _prefix_sysprompt(card, cfg, params, name, cache, cache_dtype):
    import numpy as np
    import torch
    from paddle_tpu_torch.models.llama_serving import Request, ServingEngine
    rng = np.random.default_rng(3)
    system = rng.integers(1, cfg.vocab_size, 1024).tolist()
    users = [rng.integers(1, cfg.vocab_size, int(n)).tolist()
             for n in rng.integers(64, 501, 8)]
    eng = ServingEngine(params, cfg, prefix_cache=cache,
                        cache_dtype=cache_dtype, device="cuda",
                        **PREFIX_SERVE_SYS)
    trace = _trace_calls(eng, PREFILL_CALLS)
    _reset_bucket_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    eng.submit(Request(0, system + users[0], max_new_tokens=64))
    eng.step()            # its prefill (indexed) and one decode step
    t1 = time.perf_counter()
    for i in range(1, 8):
        eng.submit(Request(i, system + users[i], max_new_tokens=64))
    eng.run_pipelined()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    done = {r.rid: r for r in eng.finished}
    if len(done) != 8 or any(len(r.output) != 64 for r in done.values()):
        fail(f"prefix_serve ({name}): requests unfinished")
    if not eng.pool.conserved(drained=True):
        fail(f"prefix_serve ({name}): page pool not conserved")
    L = cfg.num_hidden_layers
    launches = _bucket_counts()
    calls = _call_counts(trace, PREFILL_CALLS)
    suffix_verify = [c[2] for c in trace if c[0] == "_prefill_suffix_into"]
    if any(n != L for n in suffix_verify):
        fail(f"prefix_serve ({name}): suffix prefills launched "
             f"{suffix_verify} pa_verify, want {L} each")
    want_hits = 7 if cache else 0
    if calls["_prefill_suffix_into"] != want_hits:
        fail(f"prefix_serve ({name}): {calls} prefill calls")
    prompt_tokens = sum(len(system) + len(u) for u in users)
    row = {"phase": "prefix_serve", "part": "system_prompt", "card": card,
           "run": name, "config": SERVE_CONFIG,
           "engine": PREFIX_SERVE_SYS, "prefix_cache": cache,
           "pool": "int8" if cache_dtype else "bf16",
           "system_tokens": 1024, "user_tokens": [len(u) for u in users],
           "new_tokens": 64, "prompt_tokens": prompt_tokens,
           "prefill_tokens": eng.prefill_tokens,
           "cached_tokens": sum(r.cached_tokens for r in done.values()),
           "prefill_tok_s": (eng.prefill_tokens - len(system)
                             - len(users[0])) / (trace[-1][1] - t1),
           "output_tok_s": 8 * 64 / wall, "wall_s": wall,
           "pad_tokens": eng.pad_tokens, "prefill_calls": calls,
           "suffix_verify_launches": sum(suffix_verify),
           "launches": launches, "merge_launches": _merge_launches(),
           "device_steps": eng.device_steps}
    return row


def phase_prefix_serve(card, cfg, params):
    import torch
    runs = {}
    traffic = _multiturn_traffic(cfg.vocab_size)
    for name, (tier, quantize) in PREFIX_SERVE_MT_RUNS.items():
        row = _prefix_multiturn(card, cfg, params, name, tier, quantize,
                                traffic)
        runs[name] = row
        torch.cuda.empty_cache()
    off = runs["tier_off"]["tokens"]
    for name, row in runs.items():
        toks = row.pop("tokens")
        row["tokens_equal_tier_off"] = sum(
            a == b for rid in off for a, b in zip(toks[rid], off[rid]))
        row["tokens_total"] = sum(len(t) for t in off.values())
        emit(row)
    for cache in (False, True):
        for cache_dtype in (None, "int8"):
            name = f"sys_{'cache' if cache else 'nocache'}_" \
                f"{'int8' if cache_dtype else 'bf16'}"
            row = _prefix_sysprompt(card, cfg, params, name, cache,
                                    cache_dtype)
            emit(row)
            runs[name] = row
            torch.cuda.empty_cache()
    return runs


# ------------------------------------------------------ serving runtime
RUNTIME_ROUTES = ("/healthz", "/readyz", "/debug/flightrecorder",
                  "/debug/trace", "/debug/requests", "/debug/pulse",
                  "/debug/pulse?stream=1&count=1", "/debug/stacks")
RUNTIME_FLEET_ROUTES = ("/debug/fleet/trace", "/debug/fleet/flightrecorder")
RUNTIME_ROWS = 256      # the serve phase's ragged buffer


def _runtime_faults(prompts):
    """The fault drill (b): a raise at the first step launch (no token
    yet), and one at the step finish that would consume request 0's
    first decode row: request 0, admitted first and fed RUNTIME_ROWS
    rows a wave, has its first token (seeded at the finish of its last
    prefill wave) and no request has two, so the requeued requests
    prefill their prompts only (a requeued request with more tokens
    would prefill its generated tokens too, and their K/V would be the
    prefill path's bf16 values, not the decode steps')."""
    first_seed = -(-len(prompts[0]) // RUNTIME_ROWS)
    return f"step_launch:raise@1;step_finish:raise@{first_seed + 1}"


def _http_get(port, path, timeout=120):
    """(status, body bytes, seconds) of one GET on the local server; a
    streamed route is read until the server ends it."""
    import http.client
    t0 = time.perf_counter()
    c = http.client.HTTPConnection("127.0.0.1", port, timeout=timeout)
    try:
        c.request("GET", path)
        r = c.getresponse()
        body = r.read()
        return r.status, body, time.perf_counter() - t0
    finally:
        c.close()


def _runtime_prompts(cfg):
    """The serve phase's 8 prompts (64-1500 tokens, numpy seed 2)."""
    rng, lens = _serve_rng()
    return [rng.integers(0, cfg.vocab_size, n).tolist() for n in lens]


def _runtime_engine(cfg, params, ragged=True):
    """The serve phase's engine settings, bf16 pool, nothing submitted."""
    from paddle_tpu_torch.models.llama_serving import ServingEngine
    return ServingEngine(params, cfg, max_seqs=8, max_seq_len=2048,
                         page_size=16, ragged_tokens=RUNTIME_ROWS,
                         ragged=ragged, device="cuda")


def _direct_tokens(cfg, params, prompts, ragged=True, pipelined=False):
    """Tokens of a direct run of `prompts` (greedy, 64 new), with its
    wall seconds: {index: tokens}, seconds."""
    import torch
    from paddle_tpu_torch.models.llama_serving import Request
    eng = _runtime_engine(cfg, params, ragged)
    for i, p in enumerate(prompts):
        eng.submit(Request(i, p, max_new_tokens=64))
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    done = eng.run_pipelined() if pipelined else eng.run()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    if not eng.pool.conserved(drained=True):
        fail("runtime: a direct run's page pool is not conserved")
    out = {r.rid: list(r.output) for r in done}
    del eng
    torch.cuda.empty_cache()
    return out, wall


def _held(what, got, want, prompts, params, cfg):
    """`got` held to `want` by `_same_streams`' rule, the top-2 margin
    taken on the card (one forward of the common prefix): equal, or
    parting only at a bf16 logit tie. Returns the partings, {rid:
    (token index, margin, top logit)}."""
    for rid, toks in got.items():
        if len(toks) != 64 or not all(0 <= t < cfg.vocab_size for t in toks):
            fail(f"{what}: request {rid}: {len(toks)} tokens, want 64 in "
                 "the vocabulary")
    compared = _same_streams(what, got, want, prompts, params, cfg)
    return {rid: (c["stopped_at"], c["cpu_top2_margin"], c["top_logit"])
            for rid, c in compared.items() if c["stopped_at"] is not None}


def _feed_log(eng):
    """Log what a scheduler feeds `eng` (its `submit` and `step`,
    wrapped on the instance): entries (restarts, "submit", the request's
    state) and (restarts, "step", None), `restarts` as the engine
    counted them then. The entries of the last restart are what the
    engine did after its last crash. `del eng.submit, eng.step`
    unwraps."""
    log = []
    submit, step = eng.submit, eng.step

    def logged_submit(req):
        log.append((eng.restarts, "submit", {
            "prompt": list(req.prompt), "max_new_tokens": req.max_new_tokens,
            "eos_id": req.eos_id, "output": list(req.output),
            "next_token": req.next_token, "resume": req._resume}))
        return submit(req)

    def logged_step():
        log.append((eng.restarts, "step", None))
        return step()
    eng.submit, eng.step = logged_submit, logged_step
    return log


def _replay(cfg, params, log, prompts):
    """A run without faults that admits what the logged engine was fed
    after its last crash, at the same steps: on a new engine of the
    serve settings, each logged request (greedy, with the output and
    pending token it was requeued with) is submitted, and the engine
    stepped, in the log's order. Returns ({prompt index: tokens}, the
    steps it took beyond the logged ones)."""
    from paddle_tpu_torch.models.llama_serving import Request
    last = max(r for r, _, _ in log)
    index = {tuple(p): i for i, p in enumerate(prompts)}
    eng = _runtime_engine(cfg, params)
    for restarts, kind, st in log:
        if restarts != last:
            continue
        if kind == "step":
            eng.step()
            continue
        req = Request(index[tuple(st["prompt"])], st["prompt"],
                      max_new_tokens=st["max_new_tokens"],
                      eos_id=st["eos_id"])
        req.output = list(st["output"])
        req.next_token, req._resume = st["next_token"], st["resume"]
        eng.submit(req)
    extra = 0
    while eng._waiting or any(r is not None for r in eng._slots):
        eng.step()
        extra += 1
    if not eng.pool.conserved(drained=True):
        fail("runtime (b): the replay's page pool is not conserved")
    out = {r.rid: list(r.output) for r in eng.finished}
    del eng
    return out, extra


def _partings(got, want, prompts, params, cfg):
    """Where each stream of `got` first parts from `want`, reported, not
    held: {index: (token index, top-2 margin, top logit)} with the
    margin taken on the card by one forward of the common prefix."""
    out = {}
    for i, a in got.items():
        b = want[i]
        j = next((k for k, (x, y) in enumerate(zip(a, b)) if x != y), None)
        if j is not None:
            out[i] = (j, *_top2_margin(params, cfg, prompts[i] + b[:j], 16,
                                       with_top=True))
    return out


def _http_serve(sched, port, prompts, stream, on_chunk=None):
    """`prompts` over HTTP from one thread each, queued in order while
    the scheduler is paused, then served. `stream[i]` picks the SSE
    route; `on_chunk(i)` runs after request i's first streamed chunk.
    Returns ({index: tokens or the error}, wall seconds from resume)."""
    import threading
    from paddle_tpu_torch.serving import ServingClient, ServingHTTPError
    cl = ServingClient(port=port, timeout=600)
    out = {}

    def call(i, prompt):
        try:
            if stream[i]:
                toks = []
                for ev in cl.stream_complete(prompt, max_tokens=64):
                    if "state" in ev:
                        if ev["state"] != "done":
                            out[i] = ev["state"]
                            return
                        continue
                    toks.extend(ev["tokens"])
                    if on_chunk is not None and len(toks) == len(
                            ev["tokens"]):
                        on_chunk(i)
                out[i] = toks
            else:
                out[i] = cl.complete(prompt, max_tokens=64)["tokens"]
        except (ServingHTTPError, ConnectionError) as e:
            out[i] = f"error: {e}"
    sched.pause()
    threads = []
    for i, p in enumerate(prompts):
        threads.append(threading.Thread(target=call, args=(i, p)))
        threads[-1].start()
        t_wait = time.perf_counter()
        while sched.stats()["queued"] < i + 1:
            if time.perf_counter() - t_wait > 60:
                fail("runtime: a request did not reach the queue")
            time.sleep(0.002)
    t0 = time.perf_counter()
    sched.resume()
    for t in threads:
        t.join(600)
        if t.is_alive():
            fail("runtime: an HTTP request did not finish")
    return out, time.perf_counter() - t0


def phase_runtime(card, cfg, params):
    """The port's serving runtime on the card: (a) ServingServer over a
    RequestScheduler on the ragged bf16 engine, the serve phase's 8
    prompts over HTTP against a direct run; (b) a fault drill on the
    same server; (c) a Router over a ragged and a bucketed replica
    sharing the weights, under the pipelined pump."""
    import torch
    import paddle_tpu_torch.kernels.ragged_paged_attention as rpa
    from paddle_tpu_torch.models import llama_serving as S
    from paddle_tpu_torch.observability import device_telemetry as dt
    from paddle_tpu_torch.serving import (FaultPlan, MetricsRegistry, Router,
                                          RequestScheduler, ServingServer,
                                          build_replicas)
    from paddle_tpu_torch.serving.server import METRIC_NAMES
    prompts = _runtime_prompts(cfg)
    L = cfg.num_hidden_layers
    runtime_launches = {}

    def count(name, n):
        runtime_launches[name] = runtime_launches.get(name, 0) + n

    # (a) the direct run, then the same settings behind the server
    direct, direct_wall = _direct_tokens(cfg, params, prompts)
    eng = _runtime_engine(cfg, params)
    sched = RequestScheduler(eng, max_queue=64, metrics=MetricsRegistry())
    srv = ServingServer(sched, host="127.0.0.1", port=0).start()
    try:
        _reset_bucket_counts()
        steps0 = eng.device_steps
        # close the cost window of the steps run outside a scheduler
        # (the direct run, earlier phases): no step is measured by it
        dt.COSTS.note_step(0.0)
        got, http_wall = _http_serve(sched, srv.port, prompts,
                                     [i % 2 == 0 for i in range(8)])
        torch.cuda.synchronize()
        launches = rpa.launches
        steps = eng.device_steps - steps0
        count("ragged_paged_attention", launches)
        if launches != L * steps:
            fail(f"runtime (a): {launches} ragged launches, want {L} x "
                 f"{steps}")
        parted_a = _held("runtime (a)", got, direct, prompts, params, cfg)
        # the first direct run warmed the card up: the tok/s compared
        # with HTTP's is a second one's
        again, direct_wall = _direct_tokens(cfg, params, prompts)
        if again != direct:
            fail("runtime (a): two direct runs gave other tokens")
        t0 = time.perf_counter()
        status, body, _ = _http_get(srv.port, "/metrics")
        scrape_s = time.perf_counter() - t0
        text = body.decode()
        if status != 200:
            fail(f"runtime (a): /metrics answered {status}")
        typed = {ln.split()[2] for ln in text.splitlines()
                 if ln.startswith("# TYPE")}
        missing = [n for n in METRIC_NAMES if n not in typed]
        if missing:
            fail(f"runtime (a): /metrics lacks {missing}")
        routes = {}
        for path in RUNTIME_ROUTES + RUNTIME_FLEET_ROUTES:
            st, _, _ = _http_get(srv.port, path)
            routes[path] = st
            want = 404 if path in RUNTIME_FLEET_ROUTES else 200
            if st != want:
                fail(f"runtime (a): GET {path} answered {st}, want {want}")
        m = sched.metrics
        row_a = {
            "phase": "runtime", "part": "a", "card": card,
            "config": SERVE_CONFIG + ", ragged, bf16 pool, greedy",
            "prompt_lens": [len(p) for p in prompts], "new_tokens": 64,
            "streamed": [0, 2, 4, 6], "http_wall_s": http_wall,
            "direct_wall_s": direct_wall,
            "http_output_tok_s": 8 * 64 / http_wall,
            "direct_output_tok_s": 8 * 64 / direct_wall,
            "partings_at_ties": parted_a, "device_steps": steps,
            "launches": launches, "launches_per_step": launches / steps,
            "ttft_p50_s": m.ttft.percentile(50),
            "ttft_p95_s": m.ttft.percentile(95),
            "tpot_p50_s": m.tpot.percentile(50),
            "tpot_p95_s": m.tpot.percentile(95),
            "host_gap_p50_s": m.host_gap.percentile(50),
            "host_gap_p95_s": m.host_gap.percentile(95),
            "host_gap_mean_s": m.host_gap.sum / max(m.host_gap.count, 1),
            "ttft_count": m.ttft.count, "tpot_count": m.tpot.count,
            "pt_mfu": dt.COSTS.last_mfu, "pt_mfu_peak": dt.COSTS.peak_mfu,
            "pt_mfu_on_metrics": "pt_mfu" in typed,
            "scrape_s": scrape_s, "metric_families": len(typed),
            "routes": routes}
        emit(row_a)
        if not row_a["pt_mfu_on_metrics"] or not dt.COSTS.steps_measured:
            fail("runtime (a): no step was costed on the card (pt_mfu)")

        # (b) a fault drill on the same server: a raise before any first
        # token, one mid-run; then a crash while request 0 streams.
        # After a crash the scheduler admits the requeued requests one
        # at a time until each survives a step (probation), so their
        # waves are not a direct run's: each drill is held, under the
        # tie rule of (a), to a replay without faults that admits what
        # the engine was fed after its last crash, at the same steps;
        # its partings from the direct run are reported
        if sched._pipeline:
            fail("runtime (b): the replay logs the synchronous pump")
        faults = _runtime_faults(prompts)
        plan = eng.faults = FaultPlan(faults)
        eng.host_tier.faults = plan
        restarts0 = eng.restarts
        log = _feed_log(eng)
        _reset_bucket_counts()
        got_b, _ = _http_serve(sched, srv.port, prompts, [False] * 8)
        count("ragged_paged_attention", rpa.launches)
        restarts = eng.restarts - restarts0
        breaker = sched.readiness()
        if restarts != 2 or len(plan.fired) != 2:
            fail(f"runtime (b): {restarts} restarts, {len(plan.fired)} "
                 "faults fired, want 2 and 2")
        if not breaker[0]:
            fail(f"runtime (b): the breaker opened ({breaker})")
        if not all(isinstance(t, list) for t in got_b.values()):
            fail(f"runtime (b): a request failed: {got_b}")
        replay_b, extra_b = _replay(cfg, params, log, prompts)
        if sorted(replay_b) != list(range(8)):
            fail(f"runtime (b): the replay finished {sorted(replay_b)}")
        parted_b = _held("runtime (b)", got_b, replay_b, prompts, params,
                         cfg)
        vs_direct_b = _partings(got_b, direct, prompts, params, cfg)
        replayed_b = sum(1 for r, k, _ in log
                         if k == "step" and r == restarts0 + 2)

        def crash(i):
            plan.add("step_launch", "raise", count=1,
                     exc=RuntimeError("mid-stream crash"))
        log.clear()
        _reset_bucket_counts()
        got_c, _ = _http_serve(sched, srv.port, prompts,
                               [i == 0 for i in range(8)], on_chunk=crash)
        count("ragged_paged_attention", rpa.launches)
        del eng.submit, eng.step
        if isinstance(got_c[0], list):
            fail("runtime (b): the streamed request survived its crash")
        others = {i: t for i, t in got_c.items() if i != 0}
        if not all(isinstance(t, list) for t in others.values()):
            fail(f"runtime (b): a crash failed another request: {got_c}")
        replay_c, extra_c = _replay(cfg, params, log, prompts)
        if sorted(replay_c) != sorted(others):
            fail(f"runtime (b, mid-stream): the replay finished "
                 f"{sorted(replay_c)}, want {sorted(others)}")
        parted_c = _held("runtime (b, mid-stream)", others, replay_c,
                         prompts, params, cfg)
        vs_direct_c = _partings(others, direct, prompts, params, cfg)
        emit({"phase": "runtime", "part": "b", "card": card,
              "faults": faults, "restarts": restarts,
              "breaker_closed": breaker[0],
              "replay_steps": replayed_b, "replay_extra_steps": extra_b,
              "partings_from_replay": parted_b,
              "partings_from_direct": vs_direct_b,
              "mid_stream": {"request_0": got_c[0],
                             "others_done": len(others),
                             "replay_extra_steps": extra_c,
                             "partings_from_replay": parted_c,
                             "partings_from_direct": vs_direct_c},
              "requeued": sched.stats()["requests"]["requeued"]})
    finally:
        srv.stop(drain=False, timeout=120)
    del sched, eng, srv
    torch.cuda.empty_cache()

    # (c) a Router over a ragged and a bucketed replica on the one card
    calls = {"waves": 0, "singles": 0}
    originals = (S.prefill_varlen, S.prefill)

    def counted(fn, key):
        def wrapper(*a, **k):
            calls[key] += 1
            return fn(*a, **k)
        return wrapper
    reps = build_replicas(
        lambda i: _runtime_engine(cfg, params, ragged=(i == 0)), 2,
        max_queue=64, pipeline=True)
    # round robin: the affinity ring places by Python's string hashes,
    # which change between processes, and may give one replica all 8
    router = Router(reps, policy="round_robin")
    S.prefill_varlen = counted(originals[0], "waves")
    S.prefill = counted(originals[1], "singles")
    try:
        router.pause()
        _reset_bucket_counts()
        t0 = time.perf_counter()
        rrs = [router.submit(p, max_new_tokens=64) for p in prompts]
        router.resume()
        routed = [rr.result(timeout=600) for rr in rrs]
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        counts = _bucket_counts()
        merges = _merge_launches()
    finally:
        S.prefill_varlen, S.prefill = originals
        router.shutdown(drain=True, timeout=120)
    placed = [rr.replica_id for rr in rrs]
    r_eng, b_eng = reps[0].engine, reps[1].engine
    if counts["ragged_paged_attention"] != L * r_eng.device_steps:
        fail(f"runtime (c): {counts['ragged_paged_attention']} ragged "
             f"launches, want {L} x {r_eng.device_steps}")
    want = _want_bucket_counts(L, calls, b_eng.device_steps, False)
    want["ragged_paged_attention"] = counts["ragged_paged_attention"]
    if counts != want:
        fail(f"runtime (c): launches {counts}, want {want}")
    for k, n in counts.items():
        if n:
            count(k, n)
    parted = {}
    for rid, ragged in (("r0", True), ("r1", False)):
        idx = [i for i, p in enumerate(placed) if p == rid]
        if not idx:
            continue
        sub = [prompts[i] for i in idx]
        want_toks, _ = _direct_tokens(cfg, params, sub, ragged=ragged,
                                      pipelined=True)
        parted.update({f"{rid}:{idx[j]}": v for j, v in _held(
            f"runtime (c, {rid})", {j: routed[i] for j, i in enumerate(idx)},
            want_toks, sub, params, cfg).items()})
    del reps, router, r_eng, b_eng
    torch.cuda.empty_cache()
    emit({"phase": "runtime", "part": "c", "card": card,
          "replicas": {"r0": "ragged bf16", "r1": "bucketed bf16"},
          "pump": "pipelined", "policy": "round_robin", "placed": placed,
          "requests_per_replica": {r: placed.count(r) for r in ("r0", "r1")},
          "wall_s": wall, "output_tok_s": 8 * 64 / wall,
          "launches": counts, "merge_launches": merges,
          "prefill_calls": calls, "partings_at_ties": parted})
    return {"launches": runtime_launches}


# ------------------------------------------------------------ fleet plane
FLEET_SPAWN_LAYERS = 2      # (b): 8B widths, the depth cut so each child
                            # builds its seeded weights fast
FLEET_SPAWN_PROMPTS = 3
FLEET_PAGE_BUDGET = 16      # (c): worker A's tier holds 16 int8 pages
FLEET_PREFIX_TOKENS = 1024  # (c): the shared prompt, 64 pages
FLEET_FILL_TOKENS = 1984    # (c): a prompt that takes every page of A


def _fleet_free_port():
    import socket
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _fleet_plane(workers, build):
    """A FleetPlane on 127.0.0.1 over in-process FleetWorkers: `build(i,
    endpoint, world_size)` makes worker i (each in its own thread, as
    the plane's rendezvous needs). Returns (plane, workers)."""
    import threading
    from paddle_tpu_torch.serving import connect_fleet
    endpoint = f"127.0.0.1:{_fleet_free_port()}"
    made, errors = [None] * len(workers), []

    def up(i):
        try:
            made[i] = build(i, endpoint, len(workers) + 1)
        except BaseException as e:  # noqa: BLE001 — raised below
            errors.append(e)
    threads = [threading.Thread(target=up, args=(i,), daemon=True)
               for i in range(len(workers))]
    for t in threads:
        t.start()
    plane = connect_fleet(endpoint, list(workers))
    for t in threads:
        t.join(600)
    if errors:
        raise errors[0]
    return plane, made


def _fleet_stream(router, prompts, new):
    """`prompts` through `router` (paused while they queue, then resumed),
    each streamed on its own thread. Returns ({index: tokens}, wall
    seconds from resume, [seconds from resume to each first chunk])."""
    import threading
    router.pause()
    rrs = [router.submit(p, max_new_tokens=new) for p in prompts]
    out, first, errors = {}, {}, []

    def read(i, rr):
        try:
            toks = []
            for chunk in rr.stream(timeout=600):
                if not toks:
                    first[i] = time.perf_counter() - t0
                toks.extend(chunk)
            out[i] = toks
        except Exception as e:  # noqa: BLE001 — raised below
            errors.append((i, e))
    threads = [threading.Thread(target=read, args=(i, rr), daemon=True)
               for i, rr in enumerate(rrs)]
    t0 = time.perf_counter()
    router.resume()
    for t in threads:
        t.start()
    for t in threads:
        t.join(600)
    wall = time.perf_counter() - t0
    if errors or len(out) != len(prompts):
        fail(f"fleet: requests failed: {errors}")
    return out, wall, [first[i] for i in sorted(first)], rrs


def _fleet_disagg(card, cfg, params, prompts, L):
    """(a): a prefill FleetWorker (ragged bf16) and a decode FleetWorker
    (bucketed bf16), the serve phase's pools, both under the pipelined
    pump and sharing the weights, behind a Router over the plane's
    replicas; the same traffic through an in-process Router over local
    Replicas of the same engines and roles. Returns (row, launches)."""
    import torch
    from paddle_tpu_torch.serving import FleetWorker, Replica, Router
    roles = {"p0": ("prefill", True), "d0": ("decode", False)}
    hops = []

    def build(i, endpoint, world):
        name = list(roles)[i]
        role, ragged = roles[name]
        rep = Replica(name, _runtime_engine(cfg, params, ragged=ragged),
                      role=role, max_queue=64, pipeline=True)
        return FleetWorker(name, rep, master_endpoint=endpoint, rank=i + 1,
                           world_size=world, host=f"host-{name}")
    plane, (pw, dw) = _fleet_plane(roles, build)
    serve_handoff = pw._serve_handoff

    def timed_serve(conn, rid):
        # the prefill worker's half of each socket hop: wall seconds and
        # the payload bytes framed
        b0, t0 = pw.handoff_wire_bytes.value, time.perf_counter()
        serve_handoff(conn, rid)
        hops.append((time.perf_counter() - t0,
                     pw.handoff_wire_bytes.value - b0))
    pw._serve_handoff = timed_serve
    router = Router(plane.replicas, fleet=plane)
    try:
        _reset_bucket_counts()
        pre_steps0 = pw.replica.engine.device_steps
        dec_steps0 = dw.replica.engine.device_steps
        got, wall, ttft, rrs = _fleet_stream(router, prompts, 64)
        torch.cuda.synchronize()
        counts = _bucket_counts()
        merges = _merge_launches()
        pre_steps = pw.replica.engine.device_steps - pre_steps0
        dec_steps = dw.replica.engine.device_steps - dec_steps0
        handoffs = router.registry.snapshot()["pt_router_handoffs"]["value"]
        served = [rr.replica_id for rr in rrs]
        serves = pw.handoff_serves.value
        wire_bytes = pw.handoff_wire_bytes.value
        hist = pw.replica.registry.histogram(
            "pt_handoff_seconds", "Handoff export/transfer wall time.")
        hist_p = (hist.percentile(50), hist.percentile(95), hist.count)
    finally:
        router.shutdown(drain=True, timeout=120)
        for w in (pw, dw):
            w.close()
        plane.close()
    if handoffs != 8 or serves != 8 or served != ["d0"] * 8:
        fail(f"fleet (a): {handoffs} handoffs, {serves} handoff serves, "
             f"served by {served}; want 8, 8 and all on d0")
    want = _want_bucket_counts(L, {"waves": 0, "singles": 0}, dec_steps,
                               False)
    want["ragged_paged_attention"] = L * pre_steps
    if counts != want:
        fail(f"fleet (a): launches {counts}, want {want} ({L} a step: "
             f"{pre_steps} prefill steps, {dec_steps} decode steps)")
    del pw, dw, plane, router
    torch.cuda.empty_cache()

    # the same engines, roles and encoding behind an in-process Router
    reps = [Replica(name, _runtime_engine(cfg, params, ragged=ragged),
                    role=role, max_queue=64, pipeline=True)
            for name, (role, ragged) in roles.items()]
    local = Router(reps)
    try:
        want_toks, local_wall, local_ttft, _ = _fleet_stream(
            local, prompts, 64)
        torch.cuda.synchronize()
    finally:
        local.shutdown(drain=True, timeout=120)
    del reps, local
    torch.cuda.empty_cache()
    parted = _held("fleet (a)", got, want_toks, prompts, params, cfg)
    hop_s = sorted(s for s, _ in hops)
    row = {
        "phase": "fleet", "part": "a", "card": card,
        "config": SERVE_CONFIG + ", prefill worker ragged bf16, decode "
        "worker bucketed bf16, pipelined pumps, int8 handoffs",
        "prompt_lens": [len(p) for p in prompts], "new_tokens": 64,
        "fleet_wall_s": wall, "local_wall_s": local_wall,
        "fleet_output_tok_s": 8 * 64 / wall,
        "local_output_tok_s": 8 * 64 / local_wall,
        "fleet_ttft_p50_s": statistics.median(ttft),
        "fleet_ttft_p95_s": _pct(ttft, 95),
        "local_ttft_p50_s": statistics.median(local_ttft),
        "local_ttft_p95_s": _pct(local_ttft, 95),
        "handoffs": handoffs, "handoff_serves": serves,
        "handoff_wire_bytes": wire_bytes,
        "handoff_bytes_per_request": wire_bytes / 8,
        "pt_handoff_seconds_p50": hist_p[0],
        "pt_handoff_seconds_p95": hist_p[1], "pt_handoff_count": hist_p[2],
        "hop_s_p50": statistics.median(hop_s), "hop_s_p95": _pct(hop_s, 95),
        "hop_gb_s": sum(b for _, b in hops) / sum(hop_s) / 1e9,
        "prefill_steps": pre_steps, "decode_steps": dec_steps,
        "launches": counts, "merge_launches": merges,
        "partings_at_ties": parted}
    emit(row)
    return row, counts


def _pct(xs, q):
    """The q-th percentile of `xs` by nearest rank."""
    xs = sorted(xs)
    return xs[min(len(xs) - 1, max(0, math.ceil(q / 100 * len(xs)) - 1))]


_PROBE_MODULES = ("sorted(m for m in __import__('sys').modules if m in "
                  "('jax', 'paddle_tpu') or m.startswith(('jax.', "
                  "'paddle_tpu.')))")
# {nvcc:<source>: (loads, nvcc runs)} of the child's kernel libraries
_PROBE_BUILDS = ("{n: (s['calls'], s['compiles']) for n, s in __import__("
                 "'paddle_tpu_torch.observability.compile_telemetry', "
                 "fromlist=['REGISTRY']).REGISTRY.snapshot().items() "
                 "if n.startswith('nvcc:')}")


def _fleet_spawned(card, cfg, prompts):
    """(b): a prefill and a decode worker spawned as `python -m
    paddle_tpu_torch.serving.fleet` on the card, at 8B widths with the
    depth cut to FLEET_SPAWN_LAYERS, the router in this process; held
    to an in-process Router over engines built here from the same spec.
    Both children exit 0 after drain."""
    import threading
    import torch
    from paddle_tpu_torch.models.llama_serving import ServingEngine
    from paddle_tpu_torch.models.llama_spmd import init_params
    from paddle_tpu_torch.serving import (Replica, Router, connect_fleet,
                                          spawn_worker)
    small = dataclasses.replace(cfg, num_hidden_layers=FLEET_SPAWN_LAYERS)
    endpoint = f"127.0.0.1:{_fleet_free_port()}"
    engine = dict(max_seqs=4, max_seq_len=2048, page_size=16,
                  ragged_tokens=RUNTIME_ROWS)
    spec = {"master": endpoint, "world_size": 3, "seed": 0,
            "model": dataclasses.asdict(small), "dtype": "bfloat16",
            "device": "cuda", "replica": {"pipeline": True}}
    workers = {"p0": ("prefill", dict(engine)),
               "d0": ("decode", dict(engine, ragged=False))}
    root = os.path.dirname(os.path.abspath(__file__))
    env = {"PYTHONPATH": os.pathsep.join(
        p for p in (root, os.environ.get("PYTHONPATH")) if p)}
    t0 = time.perf_counter()
    procs = [spawn_worker(dict(spec, name=n, rank=i + 1, role=role,
                               engine=kw, host=f"proc-{n}"), env=env,
                          stdout=subprocess.DEVNULL)
             for i, (n, (role, kw)) in enumerate(workers.items())]
    box = {}
    router = None
    try:
        # the plane waits for both registrations; a child that dies
        # first fails the phase instead of leaving the wait to its
        # 900 s store timeout
        th = threading.Thread(target=lambda: box.update(
            plane=connect_fleet(endpoint, list(workers))), daemon=True)
        th.start()
        while th.is_alive():
            th.join(0.5)
            dead = [p.returncode for p in procs if p.poll() is not None]
            if dead:
                fail(f"fleet (b): a worker exited {dead} before it "
                     "registered")
            if time.perf_counter() - t0 > 300:
                fail("fleet (b): the workers did not register in 300 s")
        plane = box["plane"]
        up_s = time.perf_counter() - t0
        router = Router(plane.replicas, fleet=plane)
        got, wall, ttft, rrs = _fleet_stream(router, prompts, 64)
        served = [rr.replica_id for rr in rrs]
        probes = {n: (plane._agent.invoke(n, eval, (_PROBE_MODULES,), {},
                                          60).wait(60),
                      plane._agent.invoke(n, eval, (_PROBE_BUILDS,), {},
                                          60).wait(60))
                  for n in workers}
        drained = router.shutdown(drain=True, timeout=120)
        router = None
        codes = [p.wait(timeout=120) for p in procs]
    finally:
        if router is not None:
            router.shutdown(drain=False, timeout=30)
        if "plane" in box:
            box["plane"].close()
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait(timeout=30)
    if served != ["d0"] * len(prompts):
        fail(f"fleet (b): served by {served}, want all on d0")
    for n, (mods, builds) in probes.items():
        if mods:
            fail(f"fleet (b): worker {n} imported {mods}")
        if not builds or any(c for _, c in builds.values()):
            fail(f"fleet (b): worker {n}'s kernel builds missed the "
                 f"cache: {builds}")
    if not drained or codes != [0, 0]:
        fail(f"fleet (b): drain {drained}, exit codes {codes}")
    # the same spec built here: an in-process Router over its engines
    params = init_params(small, seed=0, dtype=torch.bfloat16, device="cuda")
    reps = [Replica(n, ServingEngine(params, small, device="cuda", **kw),
                    role=role, pipeline=True)
            for n, (role, kw) in workers.items()]
    local = Router(reps)
    try:
        want, _, _, _ = _fleet_stream(local, prompts, 64)
    finally:
        local.shutdown(drain=True, timeout=120)
    parted = _held("fleet (b)", got, want, prompts, params, small)
    del reps, local, params
    torch.cuda.empty_cache()
    row = {"phase": "fleet", "part": "b", "card": card,
           "config": f"llama3_8b widths, {FLEET_SPAWN_LAYERS} layers, bf16 "
           "random weights (seed 0) in each child; spawned prefill "
           "(ragged) and decode (bucketed) workers",
           "prompt_lens": [len(p) for p in prompts], "new_tokens": 64,
           "workers_up_s": up_s, "wall_s": wall,
           "output_tok_s": len(prompts) * 64 / wall,
           "ttft_p50_s": statistics.median(ttft),
           "child_modules": {n: m for n, (m, _) in probes.items()},
           "child_builds": {n: b for n, (_, b) in probes.items()},
           "exit_codes": codes, "partings_at_ties": parted}
    emit(row)
    return row


def _owned_prompt(pages, owner, n_blocks, page, vocab, rng):
    """A prompt of `n_blocks` pages whose every chained block hash the
    fleet's ring gives to `owner`."""
    from paddle_tpu_torch.serving.kvcache import _SEED, block_hash
    parent, toks = _SEED, []
    for _ in range(n_blocks):
        while True:
            block = tuple(int(t) for t in rng.integers(1, vocab, page))
            key = block_hash(parent, block)
            if pages.owner_of(key) == owner:
                break
        toks.extend(block)
        parent = key
    return toks


def _fleet_prefix(card, cfg, params, L):
    """(c): two "both" FleetWorkers (ragged bf16, prefix cache, int8 host
    tiers; A's holds FLEET_PAGE_BUDGET pages) form one prefix cache. A
    serves a prompt P whose every page
    the ring gives to B, then a prompt that takes all of A's pages: P's
    pages spill into A's tier, which keeps FLEET_PAGE_BUDGET of them
    and ships the rest to B. P plus a suffix on A then restores the kept
    pages and fetches the rest from B. Held to one engine whose own tier
    keeps them all. Returns (row, launches)."""
    import numpy as np
    import torch
    import paddle_tpu_torch.kernels.ragged_paged_attention as rpa
    from paddle_tpu_torch.models.llama_serving import Request, ServingEngine
    from paddle_tpu_torch.serving import FleetWorker, Replica
    page = 16
    page_bytes = L * cfg.num_key_value_heads * page * \
        (cfg.hidden_size // cfg.num_attention_heads + 4) * 2
    blocks = FLEET_PREFIX_TOKENS // page

    def engine(tier_bytes):
        # 129 pages: one 2048-token sequence and the trash page, so the
        # second prompt evicts every page of the first
        return ServingEngine(params, cfg, max_seqs=2, max_seq_len=2048,
                             page_size=page, ragged_tokens=RUNTIME_ROWS,
                             num_pages=129, prefix_cache=True,
                             host_tier_bytes=tier_bytes, tier_quantize=True,
                             device="cuda")

    def build(i, endpoint, world):
        # A's tier is tight; B, the owner, has room for what lands there
        rep = Replica(f"c{i}", engine(FLEET_PAGE_BUDGET * page_bytes
                                      if i == 0 else 1 << 30), max_queue=8)
        return FleetWorker(f"c{i}", rep, master_endpoint=endpoint,
                           rank=i + 1, world_size=world, host=f"host-c{i}")
    # fetch the whole chain in one match (the default fetches 8 pages)
    old_max = os.environ.get("PT_FLEET_FETCH_MAX")
    os.environ["PT_FLEET_FETCH_MAX"] = str(blocks)
    plane, (wa, wb) = _fleet_plane(("c0", "c1"), build)
    try:
        rng = np.random.default_rng(5)
        prompt = _owned_prompt(wa.pages, "c1", blocks, page, cfg.vocab_size,
                               rng)
        fill = rng.integers(1, cfg.vocab_size, FLEET_FILL_TOKENS).tolist()
        suffix = rng.integers(1, cfg.vocab_size, page).tolist()
        script = [(prompt, 16), (fill, 64), (prompt + suffix, 64)]
        rep_a = plane.replica("c0")
        ea, ta = wa.replica.engine, wa.replica.engine.host_tier
        rpa.launches = 0
        steps0 = ea.device_steps
        out = []
        for i, (p, new) in enumerate(script):
            if i == 2:
                # every spill landed in A's tier, every drop at B
                if not ta.flush(timeout=120):
                    fail("fleet (c): A's tier did not land its spills")
                t_wait = time.perf_counter()
                while wa.pages._q.unfinished_tasks:
                    if time.perf_counter() - t_wait > 120:
                        fail("fleet (c): A's spills to B did not finish")
                    time.sleep(0.01)
                spilled = (wa.pages.spill_pages.value,
                           wa.pages.spill_bytes.value,
                           wb.pages.recv_pages.value)
                prefill0 = ea.prefill_tokens
                tier0 = ta.stats()
                fetch_t = []
                fetch = wa.pages.fetch_missing

                def timed_fetch(*a):
                    t = time.perf_counter()
                    got = fetch(*a)
                    fetch_t.append(time.perf_counter() - t)
                    return got
                ta.fetch_missing = timed_fetch
            out.append(rep_a.submit(p, max_new_tokens=new).result(
                timeout=600))
        torch.cuda.synchronize()
        launches = rpa.launches
        steps = ea.device_steps - steps0
        prefilled = ea.prefill_tokens - prefill0
        tier1 = ta.stats()
        fetched = (wa.pages.fetch_pages.value, wa.pages.fetch_misses.value,
                   wb.pages.page_serves.value)
        wire = wa.replica.registry.snapshot()
    finally:
        if old_max is None:
            os.environ.pop("PT_FLEET_FETCH_MAX", None)
        else:
            os.environ["PT_FLEET_FETCH_MAX"] = old_max
        # A's own hook back in place of the timed one, for close() to
        # take off the tier (whose copy thread outlives the workers)
        wa.replica.engine.host_tier.fetch_missing = wa.pages.fetch_missing
        for w in (wa, wb):
            w.replica.shutdown(drain=True, timeout=120)
            w.close()
        plane.close()
    if launches != L * steps:
        fail(f"fleet (c): {launches} ragged launches, want {L} x {steps}")
    restored = tier1["restores"] - tier0["restores"]
    kept = blocks - spilled[2]
    if spilled[2] == 0 or fetched[0] != spilled[2] or fetched[2] != \
            fetched[0] or restored != blocks:
        fail(f"fleet (c): B received {spilled[2]} pages, A fetched "
             f"{fetched[0]} (B served {fetched[2]}), A restored {restored}; "
             f"want every page of P's {blocks} back")
    del wa, wb, plane
    torch.cuda.empty_cache()
    # one engine whose own tier keeps every page of P
    single = engine(1 << 30)
    want = []
    for i, (p, new) in enumerate(script):
        if i == 2:
            single.host_tier.flush(timeout=120)
            s0 = single.host_tier.stats()["restores"]
        single.submit(Request(i, p, max_new_tokens=new))
        want.append(list(single.run()[-1].output))
    single_restored = single.host_tier.stats()["restores"] - s0
    del single
    torch.cuda.empty_cache()
    if single_restored != blocks:
        fail(f"fleet (c): the single engine restored {single_restored} "
             f"pages, want {blocks}")
    toks = {i: o for i, o in enumerate(out) if i}
    ref = {i: w for i, w in enumerate(want) if i}
    parted = _held("fleet (c)", toks, ref, [p for p, _ in script], params,
                   cfg)
    row = {"phase": "fleet", "part": "c", "card": card,
           "config": SERVE_CONFIG + ", two 'both' workers, ragged bf16, "
           "prefix cache, int8 host tiers; 129-page pools; A's tier "
           f"{FLEET_PAGE_BUDGET} pages, B's 1 GiB",
           "prompt_tokens": len(prompt), "fill_tokens": len(fill),
           "suffix_tokens": len(suffix), "page_bytes": page_bytes,
           "spill_pages": spilled[0], "spill_bytes": spilled[1],
           "recv_pages_at_b": spilled[2], "kept_at_a": kept,
           "fetch_pages": fetched[0], "fetch_misses": fetched[1],
           "page_serves_at_b": fetched[2],
           "fetch_bytes": fetched[0] * page_bytes,
           "fetch_s": sum(fetch_t), "fetch_calls": len(fetch_t),
           "restored_pages": restored, "prefill_tokens": prefilled,
           "prefill_tokens_saved": len(prompt + suffix) - prefilled,
           "wire": {k: v["value"] for k, v in wire.items()
                             if k.startswith("pt_wire")},
           "launches": launches, "device_steps": steps,
           "partings_at_ties": parted}
    emit(row)
    return row, {"ragged_paged_attention": launches}


def phase_fleet(card, cfg, params):
    """The fleet plane on the card: (a) disaggregated prefill and decode
    across the bulk channel against an in-process router; (b) spawned
    worker processes; (c) the global prefix cache."""
    L = cfg.num_hidden_layers
    prompts = _runtime_prompts(cfg)
    fleet_launches = {}
    row_a, counts_a = _fleet_disagg(card, cfg, params, prompts, L)
    row_c, counts_c = _fleet_prefix(card, cfg, params, L)
    for counts in (counts_a, counts_c):
        for k, n in counts.items():
            if n:
                fleet_launches[k] = fleet_launches.get(k, 0) + n
    row_b = _fleet_spawned(card, cfg, prompts[:FLEET_SPAWN_PROMPTS])
    return {"launches": fleet_launches, "a": row_a, "b": row_b,
            "c": row_c}


# ------------------------------------------------------- varlen training
VARLEN_BWD_KERNELS = tuple(VARLEN_BWD_TPU_KERNELS)
# the packed row of train_packed in the varlen layout: q (T, H, D), k and
# v (T, KVH, D), as Llama-3-8B's projections give them
VARLEN_TRAIN_ATTN = {"T": 8192, "H": 32, "KVH": 8, "D": 128}
# the correctness cases of the backward: the forward's, and a key
# segment that no query has
VARLEN_BWD_CASES = VARLEN_CASES + ("unseen_keys",)


def _varlen_counts():
    """Launches of the three varlen kernels, by kernel name."""
    import paddle_tpu_torch.ops.varlen_attention as va
    return {"varlen_fwd": va.launches_fwd, "varlen_bwd_dq": va.launches_dq,
            "varlen_bwd_dkv": va.launches_dkv}


def _reset_varlen_counts():
    import paddle_tpu_torch.ops.varlen_attention as va
    va.launches_fwd = va.launches_dq = va.launches_dkv = 0


def _varlen_bwd_bound(kname, dname, lens, t, h, kvh, d):
    """Least time for one backward kernel on a packed row: 6 (dQ) or 8
    (dK/dV) flops per kept pair and head dim over the peak for the dtype,
    or each operand byte once over the memory rate: q and dO (T, H, D),
    k and v (T, KVH, D), lse and delta (H, T) fp32 and the segment ids
    and distances (4 x T int32) read; dQ (T, H, D), or dK and dV (T, KVH,
    D), written."""
    elem = 4 if dname == "float32" else 2
    big_q, big_k = t * h * d * elem, t * kvh * d * elem
    out = big_q if kname == "varlen_bwd_dq" else 2 * big_k
    nbytes = 2 * big_q + 2 * big_k + 2 * h * t * 4 + 4 * t * 4 + out
    pairs = h * sum(n * (n + 1) // 2 for n in lens)
    flops = (6 if kname == "varlen_bwd_dq" else 8) * d * pairs
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, flops / PEAK_FLOPS[dname]
    return (max(t_bytes, t_ops) * 1e3,
            "bytes" if t_bytes >= t_ops else "operations", nbytes, flops)


def _varlen_operands(dname, t, h, kvh, d, seed, device="cuda"):
    """q, dO (t, h, d) and k, v (t, kvh, d) from a seeded generator."""
    import torch
    g = torch.Generator(device=device)
    g.manual_seed(seed)
    dt = getattr(torch, dname)
    q, do = (torch.randn((t, h, d), generator=g, device=device).to(dt)
             for _ in range(2))
    k, v = (torch.randn((t, kvh, d), generator=g, device=device).to(dt)
            for _ in range(2))
    return q, k, v, do


def _profiled_ms(fn, names, reps=10):
    """Device time of one call of fn spent in the kernels whose names
    hold one of `names`, from torch.profiler over `reps` calls after a
    warm-up; None when the profiler shows no device time."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    us = 0.0
    for e in prof.key_averages():
        if any(n in e.key for n in names):
            dev = getattr(e, "self_device_time_total", None)
            us += dev if dev is not None else e.self_cuda_time_total
    return us / 1e3 / reps if us else None


def _varlen_bwd_plain(q, k, v, do, seg_q, seg_k, causal, scale):
    """(o, lse, delta, dq, dk, dv) of the plain versions."""
    import paddle_tpu_torch.ops.varlen_attention as va
    o, lse = va.varlen_fwd_reference(q, k, v, seg_q, seg_k, causal, scale)
    delta = (do.float() * o.float()).sum(-1).T.contiguous()
    sq, sk = va._sentinels(seg_q, seg_k)
    args = (q, k, v, do, lse, delta, sq, sk, causal, scale)
    return (o, lse, delta, va.varlen_bwd_dq_reference(*args),
            *va.varlen_bwd_dkv_reference(*args))


def _varlen_bwd_flavors():
    """Correctness only: every case of VARLEN_BWD_CASES, GQA groups 1 and
    4, D = 64 and 128, bf16 and fp32; rows that see nothing get dQ = 0,
    keys nobody sees dK = dV = 0. Returns the max |error| of each."""
    import torch
    import paddle_tpu_torch.ops.varlen_attention as va
    errs = {}
    for name in VARLEN_BWD_CASES:
        for h, kvh in ((8, 8), (8, 2)):
            for d in (64, 128):
                for dname in ("bfloat16", "float32"):
                    q, k, v, sq, sk, causal, same = _varlen_case(
                        name, dname, h, kvh, d, seed=d + kvh)
                    do = torch.randn_like(q)
                    scale = 1.0 / math.sqrt(d)
                    _, lse, delta, *want = _varlen_bwd_plain(
                        q, k, v, do, sq, sk, causal, scale)
                    sqs, sks = va._sentinels(sq, sk)
                    args = (q, k, v, do, lse, delta, sqs, sks, causal, scale,
                            same)
                    dq = va._launch_bwd_dq(*args)
                    dk, dv = va._launch_bwd_dkv(*args)
                    torch.cuda.synchronize()
                    key = f"{name}/g{h // kvh}/d{d}/{dname}"
                    errs[key] = _check_kernels(
                        f"varlen_kernel {key}", dname,
                        {"varlen_bwd_dq": [dq], "varlen_bwd_dkv": [dk, dv]},
                        {"varlen_bwd_dq": want[:1],
                         "varlen_bwd_dkv": want[1:]}, lse, lse)
                    dead_q, dead_k = sqs < 0, sks < 0
                    if name in ("masked_rows", "unseen_keys"):
                        dead_q = dead_q | (sqs == 1)
                    if name == "unseen_keys":
                        dead_k = dead_k | (sks == 3)
                    if not (bool((dq[dead_q] == 0).all())
                            and bool((dk[dead_k] == 0).all())
                            and bool((dv[dead_k] == 0).all())):
                        fail(f"varlen_kernel {key}: a row or key that sees "
                             "nothing has a gradient")
                    del errs[key]["lse"]
    return errs


def phase_varlen_kernel(card):
    import numpy as np
    import torch
    import paddle_tpu_torch.ops.flashmask_attention as fm
    import paddle_tpu_torch.ops.varlen_attention as va
    from paddle_tpu_torch.models.llama_spmd import doc_end_indices
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    t, h, kvh, d = (VARLEN_TRAIN_ATTN[x] for x in ("T", "H", "KVH", "D"))
    lens = PACKED_DOCS
    seg_np = _segments(lens, t)
    want_tiles, causal_tiles = _varlen_tiles(seg_np, seg_np, True)
    seg = torch.from_numpy(seg_np).cuda()
    sq, sk = va._sentinels(seg, seg)
    sri = doc_end_indices(torch.from_numpy(seg_np[None]).cuda())
    scale = 1.0 / math.sqrt(d)
    m = fm._Mask(True, None, scale, 0.0, None)
    grp = h // kvh
    out = {}
    for dname in ("bfloat16", "float32"):
        q, k, v, do = _varlen_operands(dname, t, h, kvh, d, seed=0)
        o_ref, lse, delta, *want = _varlen_bwd_plain(q, k, v, do, seg, seg,
                                                     True, scale)
        args = (q, k, v, do, lse, delta, sq, sk, True, scale, True)
        dq, n_dq = va._launch_bwd_dq(*args, count_tiles=True)
        dk, dv, n_dkv = va._launch_bwd_dkv(*args, count_tiles=True)
        torch.cuda.synchronize()
        # no lse here: the kernels read the plain forward's
        errs = _check_kernels(
            "varlen_kernel", dname,
            {"varlen_bwd_dq": [dq], "varlen_bwd_dkv": [dk, dv]},
            {"varlen_bwd_dq": want[:1], "varlen_bwd_dkv": want[1:]},
            lse, lse)
        o, lse_k, n_fwd = va._launch_fwd(q, k, v, sq, sk, True, scale, True,
                                         count_tiles=True)
        torch.cuda.synchronize()
        errs.update(_check_kernels(
            "varlen_kernel", dname, {"varlen_fwd": [o]},
            {"varlen_fwd": [o_ref]}, lse_k, lse))
        for kname, n in (("varlen_fwd", n_fwd), ("varlen_bwd_dq", n_dq),
                         ("varlen_bwd_dkv", n_dkv)):
            if n != want_tiles * h:
                fail(f"{kname} ({dname}): computed {n} tiles, the skip rule "
                     f"gives {want_tiles} x {h} heads")
        del dq, dk, dv, want, o, lse_k
        kernel_ms = {
            "varlen_fwd": cuda_ms(lambda: va._launch_fwd(
                q, k, v, sq, sk, True, scale, True), reps=10),
            "varlen_bwd_dq": cuda_ms(lambda: va._launch_bwd_dq(*args),
                                     reps=10),
            "varlen_bwd_dkv": cuda_ms(lambda: va._launch_bwd_dkv(*args),
                                      reps=10)}
        # the kernels alone: the wrappers' times above also hold
        # va_positions and the tile ranges
        kernel_only_ms = {
            "varlen_bwd_dq": _profiled_ms(lambda: va._launch_bwd_dq(*args),
                                          ("dq_tc_kernel", "va_dq_kernel")),
            "varlen_bwd_dkv": _profiled_ms(
                lambda: va._launch_bwd_dkv(*args),
                ("dkv_tc_kernel", "va_dkv_kernel"))}
        plain_ms = {
            "varlen_fwd": cuda_ms(lambda: va.varlen_fwd_reference(
                q, k, v, seg, seg, True, scale), reps=3, warmup=1),
            "varlen_bwd_dq": cuda_ms(lambda: va.varlen_bwd_dq_reference(
                *args[:-1]), reps=3, warmup=1),
            "varlen_bwd_dkv": cuda_ms(lambda: va.varlen_bwd_dkv_reference(
                *args[:-1]), reps=3, warmup=1)}
        # (1, H, T, D) copies, K/V repeated to the query heads, for SDPA
        # and the FlashMask yardstick; made beforehand and not timed
        qb, dob = (x.transpose(0, 1)[None].contiguous() for x in (q, do))
        kb, vb = (x.repeat_interleave(grp, dim=1).transpose(0, 1)[None]
                  .contiguous() for x in (k, v))
        lib_fwd, lib_fwd_bwd = _doc_sdpa(qb, kb, vb, dob, lens)
        lib_fwd_ms = cuda_ms(lib_fwd, reps=10)
        library_ms = {"varlen_fwd": lib_fwd_ms}
        library_ms["varlen_bwd_dq"] = library_ms["varlen_bwd_dkv"] = \
            cuda_ms(lib_fwd_bwd, reps=10) - lib_fwd_ms
        fm_args = (qb, kb, vb, sri, dob, lse[None], delta[None], m)
        flashmask_ms = {
            "varlen_fwd": cuda_ms(lambda: fm._launch_fwd(qb, kb, vb, sri, m),
                                  reps=10),
            "varlen_bwd_dq": cuda_ms(lambda: fm._launch_dq(*fm_args),
                                     reps=10),
            "varlen_bwd_dkv": cuda_ms(lambda: fm._launch_dkv(*fm_args),
                                      reps=10)}
        for kname in ("varlen_fwd",) + VARLEN_BWD_KERNELS:
            bound_ms, bound_by, nbytes, flops = (
                _varlen_bound(dname, lens, t, h, kvh, d)
                if kname == "varlen_fwd" else
                _varlen_bwd_bound(kname, dname, lens, t, h, kvh, d))
            row = {"phase": "varlen_kernel", "card": card, "kernel": kname,
                   "dtype": dname, "T": t, "H": h, "KVH": kvh, "D": d,
                   "documents": list(lens), "causal": True,
                   "same_offsets": True,
                   "tiles_computed_per_head": want_tiles,
                   "tiles_causal_per_head": causal_tiles,
                   "kept_pairs_per_head": sum(n * (n + 1) // 2 for n in lens),
                   "atol": TOL[dname][0], "rtol": TOL[dname][1],
                   "max_abs_err": errs[kname], "kernel_ms": kernel_ms[kname],
                   "plain_ms": plain_ms[kname],
                   "library_ms": library_ms[kname],
                   "library_call": "sdpa forward per document, summed"
                   if kname == "varlen_fwd" else
                   "sdpa backward per document (dQ, dK, dV), summed",
                   "flashmask_ms": flashmask_ms[kname],
                   "bound_ms": bound_ms, "bound_by": bound_by,
                   "bound_bytes": nbytes, "bound_flops": flops,
                   "tflops": flops / kernel_ms[kname] / 1e9, "tf32": False}
            if kname == "varlen_fwd":
                row["lse_max_abs_err"] = errs["lse"]
            else:
                row["kernel_only_ms"] = kernel_only_ms[kname]
            if kname == "varlen_bwd_dkv":   # the pair against SDPA and FM
                pair = (kernel_ms["varlen_bwd_dq"]
                        + kernel_ms["varlen_bwd_dkv"])
                row["pair_library_factor"] = pair / library_ms[kname]
                row["pair_flashmask_factor"] = pair / (
                    flashmask_ms["varlen_bwd_dq"]
                    + flashmask_ms["varlen_bwd_dkv"])
            emit(_design_row(row, kname, dname))
            out[(kname, dname)] = row
        del q, k, v, do, qb, kb, vb, dob, args, fm_args, lib_fwd, lib_fwd_bwd
        del o_ref, lse, delta
        torch.cuda.empty_cache()
    emit({"phase": "varlen_kernel", "part": "flavors", "card": card,
          "cases": list(VARLEN_BWD_CASES), "groups": [1, 4],
          "head_dims": [64, 128], "tol": TOL,
          "max_abs_err": _varlen_bwd_flavors()})
    # (c) the main path: autograd through flash_attn_unpadded, bf16
    q, k, v, do = _varlen_operands("bfloat16", t, h, kvh, d, seed=1)
    cu = torch.tensor([0, *np.cumsum(lens)], dtype=torch.int32,
                      device="cuda")
    leaves = [x.detach().requires_grad_() for x in (q, k, v)]
    _reset_varlen_counts()
    o, _ = va.flash_attn_unpadded(*leaves, cu, cu, causal=True)
    grads = torch.autograd.grad(o, leaves, do)
    torch.cuda.synchronize()
    launches = _varlen_counts()
    want_launches = dict.fromkeys(launches, 1)
    if launches != want_launches:
        fail(f"varlen_kernel autograd: launches {launches}, want "
             f"{want_launches}")
    o_ref, lse, _, *want = _varlen_bwd_plain(q, k, v, do, seg, seg, True,
                                             scale)
    errs = _check_kernels(
        "varlen_kernel autograd", "bfloat16",
        {"varlen_fwd": [o.detach()], "varlen_bwd_dq": grads[:1],
         "varlen_bwd_dkv": list(grads[1:])},
        {"varlen_fwd": [o_ref], "varlen_bwd_dq": want[:1],
         "varlen_bwd_dkv": want[1:]}, lse, lse)
    del errs["lse"]
    emit({"phase": "varlen_kernel", "part": "autograd", "card": card,
          "call": "flash_attn_unpadded(causal=True), torch.autograd.grad",
          "dtype": "bfloat16", "documents": list(lens), "launches": launches,
          "max_abs_err": errs})
    out["launches"] = launches
    del q, k, v, do, leaves, o, grads, o_ref, want
    torch.cuda.empty_cache()
    return out


# a vocabulary of two 8192-column chunks of the fused head, the second
# short
FUSED_PARITY_VOCAB = 12000


def phase_fused_parity(card):
    cfg = dataclasses.replace(_parity_config(),
                              vocab_size=FUSED_PARITY_VOCAB)
    batch = _packed_batch(cfg.vocab_size, PACKED_PARITY_ROWS, seed=3)
    runs = {}
    for name, kw in (("fused_ce", {"fused_ce": True}),
                     ("dots", {"remat": "dots"})):
        runs[name] = _step_parity(f"fused_parity ({name})", cfg, batch, 2,
                                  3e-4, "flashmask", **kw)
    # the card's losses through the fused head against those through the
    # full logits (the dots run), the same limits as card against CPU
    fused, full = runs["fused_ce"]["losses_cuda"], runs["dots"]["losses_cuda"]
    if any(abs(a - c) > 1e-5 * abs(c) + 1e-5 for a, c in zip(fused, full)):
        fail(f"fused_parity: fused losses {fused} vs full logits {full}")
    emit({"phase": "fused_parity", "card": card,
          "config": f"llama3_8b widths, 1 layer, vocab {cfg.vocab_size}, "
                    "fp32, TF32 off, batch 2 x 512 packed: documents "
                    f"{list(map(list, PACKED_PARITY_ROWS))}",
          "runs": {"fused_ce=True, remat=True": runs["fused_ce"],
                   "fused_ce=False, remat='dots'": runs["dots"]},
          "fused_vs_full_logits_loss_abs_err":
              [abs(a - c) for a, c in zip(fused, full)]})


TRAIN_FUSED_CONFIG = TRAIN_PACKED_CONFIG.replace(
    "remat,", "remat='dots', fused_ce=True,")
# bf16: the fused head's logits are fp32 sums of exact bf16 products,
# the full head's are rounded to bf16 (about 2^-9 of each logit); the
# mean NLL of 8184 tokens near 12.6 moves by far less than 2e-3 of it
FIRST_LOSS_RTOL = 2e-3


def phase_train_fused(card, packed):
    import torch
    from paddle_tpu_torch.models import llama_spmd as T
    # the full-logits first loss of the same seed weights and batch
    # (train_packed's first loss), built again: train_packed updates its
    # weights in place
    cfg, params, _, batch, _ = train_packed_setup()
    with torch.no_grad():
        ref = float(T.loss_fn(params, batch, cfg, remat=False))
    del params, batch
    torch.cuda.empty_cache()
    row = _train_run(card, "train_fused", TRAIN_FUSED_CONFIG,
                     lambda: train_packed_setup("dots", True), "flashmask")
    first = row["losses"][0]
    if not abs(first - ref) <= FIRST_LOSS_RTOL * abs(ref):
        fail(f"train_fused: first loss {first}, full logits {ref}")
    emit({"phase": "train_fused", "card": card, "part": "against train_packed",
          "first_loss": first, "first_loss_full_logits": ref,
          "rtol": FIRST_LOSS_RTOL,
          "train_packed_first_loss": packed["losses"][0] if packed else None,
          "median_step_ms": row["median_step_ms"],
          "train_packed_median_step_ms":
              packed["median_step_ms"] if packed else None,
          "max_memory_allocated_gb": row["max_memory_allocated_gb"],
          "train_packed_max_memory_allocated_gb":
              packed["max_memory_allocated_gb"] if packed else None})
    return row


# ------------------------------------------------------------- parallel
# the layouts of parallel_parity (fp32, 8B widths at 4 layers, vocab
# 4096, batch 2 x 512) and parallel (bf16, 8B widths): name -> (ranks,
# mesh axes, make_train_step options, batch or layers)
PARALLEL_PARITY_LAYOUTS = {
    "dp2": (2, {"dp": 2}, {}, "plain"),
    "dp2_doc_ids": (2, {"dp": 2}, {}, "packed"),
    "tp2": (2, {"tp": 2}, {"batch_spec": ()}, "plain"),
    "pp2_gpipe": (2, {"pp": 2}, {"batch_spec": (), "schedule": "gpipe"},
                  "plain"),
    "pp2_1f1b": (2, {"pp": 2}, {"batch_spec": (), "schedule": "1f1b"},
                 "plain"),
    "pp2_interleave": (2, {"pp": 2}, {"batch_spec": (),
                                      "schedule": "interleave", "vpp": 2,
                                      "n_micro": 2}, "plain_deep"),
    "sp2_ring": (2, {"sp": 2}, {"batch_spec": (None, "sp"),
                                "sp_axis": "sp"}, "plain"),
    "sp2_ulysses": (2, {"sp": 2}, {"batch_spec": (None, "sp"),
                                   "sp_axis": "sp", "sp_impl": "ulysses"},
                    "plain"),
    "dp2_tp2": (4, {"dp": 2, "tp": 2}, {}, "plain"),
}
# a reference kind: the batch it trains on and its depth. Two layers,
# cut from 4 to pay for the layer phases (PERF.md §4); pp 2 x vpp 2 needs
# L % 4 == 0, so the interleaved layout keeps 4 ("plain_deep")
PARALLEL_PARITY_KINDS = {"plain": ("plain", 2), "packed": ("packed", 2),
                         "plain_deep": ("plain", 4)}
PARALLEL_LAYOUTS = {
    # tp 2 at 2 layers (a depth cut, PERF.md §4), beside layer_parallel's tp 2
    "tp2": (2, {"tp": 2}, {"batch_spec": ()}, 2),
    # depths cut to pay for the layer phases (PERF.md §4): pp 2 and
    # Ulysses at 2 layers, dp at 1 (two full replicas of the 4-layer
    # model, 42.8 GB each, do not fit one card anyway)
    "pp2_1f1b": (2, {"pp": 2}, {"batch_spec": (), "schedule": "1f1b"}, 2),
    "sp2_ulysses": (2, {"sp": 2}, {"batch_spec": (None, "sp"),
                                   "sp_axis": "sp", "sp_impl": "ulysses"},
                    2),
    "dp2": (2, {"dp": 2}, {}, 1),
}
PARALLEL_STEPS = 4
PARALLEL_DEADLINE_S = 420


def _parallel_backend(world):
    """NCCL with a card a rank when the machine has them, else gloo with
    every rank on card 0 (collectives staged through the host)."""
    import torch
    n = torch.cuda.device_count()
    return ("nccl", 1) if n >= world else ("gloo", world)


def _want_parallel(family, layers_here, micro, steps):
    """Launches of `steps` remat steps on `layers_here` layers and
    `micro` microbatches a layer: the forward twice, dQ and dK/dV once,
    each a microbatch; none on the other family."""
    want = {k: 0 for k in _train_counts()}
    if family:
        n = layers_here * micro * steps
        want.update({f"{family}_fwd": 2 * n, f"{family}_bwd_dq": n,
                     f"{family}_bwd_dkv": n})
    return want


def _layout_family(axes, kw, batch):
    """(kernel family, microbatches each layer of a rank runs a step)."""
    if kw.get("sp_axis") and kw.get("sp_impl", "ring") == "ring":
        family = None               # the ring is plain torch
    else:
        family = "flashmask" if batch == "packed" else "flash"
    pp = axes.get("pp", 1)
    if pp == 1:
        micro = kw.get("n_micro") or 1
    elif kw.get("schedule") == "interleave":
        micro = kw.get("n_micro") or pp * kw.get("vpp", 2)
    else:
        micro = kw.get("n_micro") or pp
    return family, micro


def _parallel_batches(vocab):
    """parallel_parity's batches: train_parity's plain batch 2 x 512 and
    packed_parity's rows (doc_ids)."""
    return {"plain": _train_batch(vocab, 2, 512, seed=3),
            "packed": _packed_batch(vocab, PACKED_PARITY_ROWS, seed=3)}


def _parallel_parity_config(kind):
    return dataclasses.replace(
        _parity_config(), num_hidden_layers=PARALLEL_PARITY_KINDS[kind][1])


PARALLEL_LR, PARALLEL_PARITY_STEPS = 3e-4, 2


def _parallel_references(kinds, out_dir, dev="cuda"):
    """The single-rank step on the card, once a batch kind, before the
    ranks start: its step-1 gradients and the parameters after
    PARALLEL_PARITY_STEPS steps, saved leaf by leaf in `out_dir` as
    <kind>_{grads,params}_<leaf>.npy (the ranks map them), and its
    losses and each step-1 gradient leaf's largest magnitude,
    returned."""
    import numpy as np
    import torch
    from paddle_tpu_torch.models import llama_spmd as T
    out = {}
    for kind in kinds:
        cfg = _parallel_parity_config(kind)
        batches = _parallel_batches(cfg.vocab_size)
        batch = tuple(torch.from_numpy(a).to(dev) for a in
                      batches[PARALLEL_PARITY_KINDS[kind][0]])
        params = T.init_params(cfg, seed=0, dtype=torch.float32, device=dev)
        opt = T.init_opt_state(params)
        _, grads = T.loss_and_grads(params, batch, cfg, remat=True)
        grads = T._leaves(grads)
        grad_max = [float(g.abs().max()) for g in grads]
        for i, g in enumerate(grads):
            np.save(os.path.join(out_dir, f"{kind}_grads_{i}.npy"),
                    g.cpu().numpy())
        del grads
        step = T.make_train_step(cfg, lr=PARALLEL_LR, device=dev)
        losses = [float(step(params, opt, i, batch)[2])
                  for i in range(PARALLEL_PARITY_STEPS)]
        for i, p in enumerate(T._leaves(params)):
            np.save(os.path.join(out_dir, f"{kind}_params_{i}.npy"),
                    p.cpu().numpy())
        out[kind] = {"losses": losses, "grad_max": grad_max}
        del params, opt
        gc_cuda()
    return out


def _reference_leaves(ref_dir, kind, what, n):
    """A saved reference's leaves, mapped from its files (copy on
    write: nothing is read until a shard is taken)."""
    import numpy as np
    import torch
    return [torch.from_numpy(np.load(
        os.path.join(ref_dir, f"{kind}_{what}_{i}.npy"), mmap_mode="c"))
        for i in range(n)]


def _ref_shards(leaves, cfg, mesh, dev, vpp):
    """This rank's shard of each leaf of a full tree, leaf by leaf on
    the card (`place_params`' split, without a copy of the whole
    tree)."""
    from paddle_tpu_torch.models import llama_spmd as T
    pp, S, v = T._stages(mesh, None, vpp)
    specs = T._leaves(T.param_specs(cfg, mesh, pp=pp))
    for a, spec in zip(leaves, specs):
        if v > 1 and tuple(spec)[:1] == ("pp",):
            a = T._interleave_layers(a, S, v)
        for dim, entry in enumerate(spec):
            idx, n = T._block(mesh, T._spec_axes(entry))
            if n > 1:
                a = a.chunk(n, dim)[idx]
        yield a.to(dev)


def _parity_errors(name, cfg, mesh, vpp, ref, losses, grads, params):
    """`_step_parity`'s rules, shard by shard (on the card): losses to
    1e-5 relative plus 1e-5, each gradient to PARITY_GRAD_RTOL of itself
    plus PARITY_GRAD_SCALE of its full leaf's largest magnitude,
    parameters to 2.5 lr a step and 1e-5 in relative norm."""
    from paddle_tpu_torch.models import llama_spmd as T
    lr, steps = PARALLEL_LR, PARALLEL_PARITY_STEPS
    loss_err = [abs(a - c) for a, c in zip(losses, ref["losses"])]
    if any(e > 1e-5 * abs(c) + 1e-5 for e, c in zip(loss_err, ref["losses"])):
        fail(f"{name}: losses {losses} vs {ref['losses']}")
    dev = T._leaves(params)[0].device
    worst = 0.0
    for a, c, m in zip(T._leaves(grads), _ref_shards(ref["grads"], cfg,
                                                    mesh, dev, vpp),
                       ref["grad_max"]):
        allowed = PARITY_GRAD_RTOL * c.abs() + PARITY_GRAD_SCALE * m + 1e-30
        worst = max(worst, float(((a.float() - c).abs() / allowed).max()))
    if worst > 1.0:
        fail(f"{name}: step-1 gradients off, worst {worst} of the tolerance")
    p_err = p_rel = 0.0
    for a, c in zip(T._leaves(params), _ref_shards(ref["params"], cfg, mesh,
                                                   dev, vpp)):
        p_err = max(p_err, float((a - c).abs().max()))
        p_rel = max(p_rel, float((a - c).norm() / c.norm()))
    if p_err > 2.5 * lr * steps or p_rel > 1e-5:
        fail(f"{name}: parameters off by {p_err} (relative norm {p_rel})")
    return {"loss_abs_err": loss_err, "grad_worst_share_of_tol": worst,
            "param_max_abs_err": p_err, "param_max_rel_norm_err": p_rel}


class _FirstGrads:
    """Keeps the gradients the train step hands AdamW on its first call
    (the step's own, reduced over the data axes, before the clip), by
    wrapping `llama_spmd.adamw_update` while it is entered."""

    def __enter__(self):
        from paddle_tpu_torch.models import llama_spmd as T
        self.grads, self._T, self._update = None, T, T.adamw_update

        def update(params, grads, *args, **kw):
            if self.grads is None:
                self.grads = grads
            return self._update(params, grads, *args, **kw)
        T.adamw_update = update
        return self

    def __exit__(self, *exc):
        self._T.adamw_update = self._update
        return False


def _parity_layouts(rank, world, layouts, dev, refs):
    import torch
    import paddle_tpu_torch.distributed.collective as C
    from paddle_tpu_torch.models import llama_spmd as T
    from paddle_tpu_torch.parallel import P, create_mesh
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    ref = {}
    for kind in sorted({b for _, _, _, b in layouts.values()}):
        # the parent's files, mapped; with two ranks on the card each
        # keeps the plain batch's reference there (7.2 GB)
        n = len(refs[kind]["grad_max"])         # one a leaf
        trees = {what: _reference_leaves(refs["dir"], kind, what, n)
                 for what in ("grads", "params")}
        if world <= 2 and kind == "plain":
            trees = {k: [t.to(dev) for t in ts] for k, ts in trees.items()}
        ref[kind] = dict(refs[kind], **trees)
    out = {}
    for name, (_, axes, kw, kind) in layouts.items():
        kw = dict(kw)
        if "batch_spec" in kw:
            kw["batch_spec"] = P(*kw["batch_spec"])
        vpp = kw.get("vpp", 2) if kw.get("schedule") == "interleave" \
            else None
        mesh = create_mesh(axes)
        cfg = _parallel_parity_config(kind)
        batch = tuple(torch.from_numpy(a).to(dev) for a in _parallel_batches(
            cfg.vocab_size)[PARALLEL_PARITY_KINDS[kind][0]])
        full = T.init_params(cfg, seed=0, dtype=torch.float32, device=dev)
        params = T.place_params(full, cfg, mesh, vpp=vpp)
        del full
        opt = T.init_opt_state(params)
        step = T.make_train_step(cfg, mesh, lr=PARALLEL_LR, device=dev, **kw)
        _reset_train_counts()
        C.reset_counters()
        t0 = time.perf_counter()
        with _FirstGrads() as first:
            losses = [float(step(params, opt, i, batch)[2])
                      for i in range(PARALLEL_PARITY_STEPS)]
        secs = time.perf_counter() - t0
        row = {"losses": losses, "launches": _train_counts(),
               "collectives": C.counters(), "seconds": secs,
               **_parity_errors(f"parallel_parity {name} (rank {rank})", cfg,
                                mesh, vpp, ref[kind], losses, first.grads,
                                params)}
        out[name] = row
        del params, opt, first
        gc_cuda()
    return out


def _engines_alive():
    """For the serve block's memory check: the ServingEngines still
    alive after a collection, each with the types that refer to it, and
    the threads still running."""
    import gc
    import threading
    from paddle_tpu_torch.models.llama_serving import ServingEngine
    gc.collect()
    engines = [o for o in gc.get_objects() if isinstance(o, ServingEngine)]
    return {"engines": [sorted({type(r).__name__ for r in gc.get_referrers(e)
                                if r is not engines}) for e in engines],
            "threads": [t.name for t in threading.enumerate()]}


def gc_cuda():
    import gc
    import torch
    gc.collect()
    torch.cuda.empty_cache()


def _speed_layouts(rank, world, layouts, dev):
    import torch
    import paddle_tpu_torch.distributed.collective as C
    from paddle_tpu_torch.models import llama_spmd as T
    from paddle_tpu_torch.models.llama import LlamaConfig
    from paddle_tpu_torch.parallel import P, create_mesh
    out = {}
    for name, (_, axes, kw, layers) in layouts.items():
        kw = dict(kw)
        if "batch_spec" in kw:
            kw["batch_spec"] = P(*kw["batch_spec"])
        cfg = dataclasses.replace(LlamaConfig.llama3_8b(),
                                  num_hidden_layers=layers)
        mesh = create_mesh(axes)
        torch.cuda.reset_peak_memory_stats(dev)
        full = T.init_params(cfg, seed=0, dtype=torch.bfloat16, device=dev)
        params = T.place_params(full, cfg, mesh)
        del full
        opt = T.init_opt_state(params)
        batch = tuple(torch.from_numpy(a).to(dev) for a in
                      _train_batch(cfg.vocab_size, 2, 2048, seed=4))
        step = T.make_train_step(cfg, mesh, device=dev, **kw)
        _reset_train_counts()
        losses, times, coll = [], [], []
        for i in range(PARALLEL_STEPS):
            C.reset_counters()
            torch.cuda.synchronize(dev)
            t0 = time.perf_counter()
            loss = step(params, opt, i, batch)[2]
            losses.append(loss.item())          # waits for the step
            times.append((time.perf_counter() - t0) * 1e3)
            coll.append(C.counters())
        out[name] = {"losses": losses, "step_ms": times,
                     "launches": _train_counts(), "collectives": coll,
                     "max_memory_allocated_gb":
                         torch.cuda.max_memory_allocated(dev) / 1e9}
        del params, opt, batch, step
        gc_cuda()
    return out


def parallel_rank(rank, world, job):
    """One spawned rank of the parallel phases: on its card (card 0 when
    the ranks share one), the layouts of `job` for this world."""
    import torch
    from paddle_tpu_torch.distributed.launch import rank_device
    dev = torch.device(rank_device("cuda"))
    torch.cuda.set_device(dev)
    out = {}
    if job.get("parity"):
        out["parity"] = _parity_layouts(rank, world, job["parity"], dev,
                                        job["refs"])
    if job.get("speed"):
        out["speed"] = _speed_layouts(rank, world, job["speed"], dev)
    if job.get("tp"):
        out["tp"] = _tp_rank(rank, world, job["tp"], dev)
    if job.get("layer"):
        out["layer"] = _layer_rank(rank, world, job["layer"], dev)
    return out


def _spawn_parallel(phases, bserve=None):
    """Spawn each world size once and run there every layout of the
    selected phases, and the tp phases in the world of 2 (tp_serve
    holds its streams to bucket_serve's, `bserve`); returns {world:
    [rank results]} and the backends."""
    import torch
    from paddle_tpu_torch.distributed.launch import spawn
    import paddle_tpu_torch.kernels.ragged_paged_attention as rpa
    import paddle_tpu_torch.ops.flash_attention as fa
    import paddle_tpu_torch.ops.flashmask_attention as fm
    import paddle_tpu_torch.ops.paged_attention as pa
    import paddle_tpu_torch.ops.varlen_attention as va
    for mod in (fa, fm, pa, va, rpa):
        mod._lib()                  # built here, loaded by the ranks
    gc_cuda()
    parent_gb = torch.cuda.memory_reserved() / 1e9
    # two full replicas share the card: no fragmented reserve in a rank
    env = dict(os.environ, PYTORCH_CUDA_ALLOC_CONF="expandable_segments:True")
    jobs = {}
    if "parallel_parity" in phases:
        for name, lay in PARALLEL_PARITY_LAYOUTS.items():
            jobs.setdefault(lay[0], {}).setdefault("parity", {})[name] = lay
    if "parallel" in phases:
        for name, lay in PARALLEL_LAYOUTS.items():
            jobs.setdefault(lay[0], {}).setdefault("speed", {})[name] = lay
    if {"tp_parity", "tp_serve"} & set(phases):
        jobs.setdefault(2, {})["tp"] = {
            "parity": "tp_parity" in phases,
            "serve": {pool: row["streams"] for pool, row in bserve.items()}
            if "tp_serve" in phases else None}
    layer = {"layer_parallel_parity", "layer_parallel"} & set(phases)
    if layer:
        jobs.setdefault(2, {})["layer"] = {
            "parity": "layer_parallel_parity" in phases,
            "speed": "layer_parallel" in phases}
    results, info = {}, {}
    ref_dir = tempfile.mkdtemp(prefix="pt_parallel_ref_")
    try:
        layer_ref = None
        if "layer_parallel_parity" in phases:
            t0 = time.perf_counter()
            layer_ref = _layer_parallel_references(ref_dir)
            jobs[2]["layer"].update(refs=layer_ref, dir=ref_dir)
            layer_ref_s = time.perf_counter() - t0
        if "parallel_parity" in phases:
            t0 = time.perf_counter()
            kinds = sorted({lay[3] for lay in
                            PARALLEL_PARITY_LAYOUTS.values()})
            refs = dict(_parallel_references(kinds, ref_dir), dir=ref_dir)
            for job in jobs.values():
                if "parity" in job:
                    job["refs"] = refs
            ref_s = time.perf_counter() - t0
        for world, job in sorted(jobs.items()):
            backend, per_card = _parallel_backend(world)
            t0 = time.perf_counter()
            deadline = PARALLEL_DEADLINE_S + (TP_DEADLINE_S if "tp" in job
                                              else 0) + (
                LAYER_DEADLINE_S if "layer" in job else 0)
            results[world] = spawn(parallel_rank, world, backend, "cuda",
                                   deadline, args=(job,), env=env)
            info[world] = {"backend": backend, "ranks_per_card": per_card,
                           "seconds": time.perf_counter() - t0,
                           "parent_cuda_reserved_gb": parent_gb}
            if "refs" in job:
                info[world]["reference_seconds"] = ref_s
            if layer_ref is not None and "layer" in job:
                info[world]["layer_reference_seconds"] = layer_ref_s
                info[world]["layer_reference"] = {
                    "losses": layer_ref["losses"],
                    "launches": layer_ref["launches"],
                    "moe_dropped": layer_ref["moe"]["dropped"]}
    finally:
        shutil.rmtree(ref_dir, ignore_errors=True)
    torch.cuda.synchronize()
    return results, info


def _check_launches(phase, name, axes, kw, batch, layers, ranks, steps):
    """Every rank's launches of rows 3-8 equal what its layers, its
    microbatches and the steps imply."""
    family, micro = _layout_family(axes, kw, batch)
    want = _want_parallel(family, layers // axes.get("pp", 1), micro, steps)
    for r, row in enumerate(ranks):
        if row["launches"] != want:
            fail(f"{phase} {name}: rank {r} launches {row['launches']}, "
                 f"want {want}")
    return want


PARALLEL_PARITY_CONFIG = ("llama3_8b widths, {layers} layers, vocab 4096, "
                          "fp32, TF32 off, remat, batch 2 x 512 (packed: "
                          "documents "
                          f"{list(map(list, PACKED_PARITY_ROWS))})")


def phase_parallel_parity(card, spawned):
    results, info = spawned
    out = {}
    for name, (world, axes, kw, kind) in PARALLEL_PARITY_LAYOUTS.items():
        ranks = [res["parity"][name] for res in results[world]]
        batch, layers = PARALLEL_PARITY_KINDS[kind]
        want = _check_launches("parallel_parity", name, axes, kw, batch,
                               layers, ranks, 2)
        row = {"phase": "parallel_parity", "card": card, "layout": name,
               "config": PARALLEL_PARITY_CONFIG.format(layers=layers),
               "mesh": axes, "options": kw, "batch": batch, **info[world],
               "losses": ranks[0]["losses"],
               "launches_per_rank": [r["launches"] for r in ranks],
               "want_launches": want,
               "grad_worst_share_of_tol": max(
                   r["grad_worst_share_of_tol"] for r in ranks),
               "param_max_abs_err": max(r["param_max_abs_err"] for r in ranks),
               "param_max_rel_norm_err": max(r["param_max_rel_norm_err"]
                                             for r in ranks),
               "loss_abs_err": ranks[0]["loss_abs_err"],
               "collective_bytes_per_rank": [r["collectives"]["bytes_sent"]
                                             for r in ranks],
               "steps_seconds": max(r["seconds"] for r in ranks)}
        emit(row)
        out[name] = row
    return out


PARALLEL_CONFIG = ("llama3_8b widths, {layers} layers, bf16 params, fp32 "
                   "AdamW state, remat, random weights (seed 0), batch 2 x "
                   "2048 (seed 4)")


def phase_parallel(card, spawned):
    import statistics as st
    results, info = spawned
    out = {}
    for name, (world, axes, kw, layers) in PARALLEL_LAYOUTS.items():
        ranks = [res["speed"][name] for res in results[world]]
        want = _check_launches("parallel", name, axes, kw, "plain", layers,
                               ranks, PARALLEL_STEPS)
        losses = ranks[0]["losses"]
        if not all(math.isfinite(x) for x in losses):
            fail(f"parallel {name}: losses not finite: {losses}")
        if not losses[-1] < losses[0]:
            fail(f"parallel {name}: loss did not fall: {losses}")
        med = [st.median(r["step_ms"][1:]) for r in ranks]
        step_ms = max(med)
        per_step = lambda r, k: [c[k] for c in r["collectives"]]  # noqa: E731
        row = {"phase": "parallel", "card": card, "layout": name,
               "config": PARALLEL_CONFIG.format(layers=layers),
               "mesh": axes, "options": kw, **info[world],
               "steps": PARALLEL_STEPS, "losses": losses,
               "step_ms_per_rank": [r["step_ms"] for r in ranks],
               "median_step_ms": step_ms,
               "global_tokens_per_s": 2 * 2048 / (step_ms / 1e3),
               "max_memory_allocated_gb_per_rank":
                   [r["max_memory_allocated_gb"] for r in ranks],
               "collective_bytes_per_step_per_rank":
                   [per_step(r, "bytes_sent") for r in ranks],
               "collective_seconds_per_step_per_rank":
                   [per_step(r, "seconds") for r in ranks],
               "collective_calls_per_step_per_rank":
                   [per_step(r, "calls") for r in ranks],
               "launches_per_rank": [r["launches"] for r in ranks],
               "want_launches": want}
        emit(row)
        out[name] = row
    return out


# ------------------------------------------------- tensor-parallel serving
# tp_parity: spec_parity's model (8B widths, 2 layers, fp32), prompts and
# new tokens on the bucketed engine; three slots, so that three prompts
# admit in one prefill_varlen wave and the fourth alone through prefill
# (rows 9 and 3 both run). Two modes: speculative decoding (G = 4, every
# step a verify_step: rows 14 / 14q) and plain decoding (every step a
# decode_step: rows 12 / 13)
TP_PARITY_ENGINE = dict(max_seqs=3, max_seq_len=512, page_size=16,
                        ragged=False)
TP_PARITY_MODES = {"spec": {"spec_decode": 4}, "decode": {}}
# fp32, TF32 off: the tp engine's logprobs against the single-rank
# engine's over their common tokens. fp32 pools: the tp sums add in
# another order (8.6e-6 measured on an H100, PERF.md). int8 pools: a
# code is a 127th of its row's largest value, and the K / V that a rank
# projects through its columns alone may differ in the last bit from
# the whole product's, which moves a value to the next code now and then
# (1.16e-3 measured there; the codes that differ are counted). The
# control, the single-rank engine with its weights and pool in bf16,
# must lie beyond each limit: else the limit would not tell a lower
# precision from the tp engine's
TP_PARITY_LP_ATOL = {"fp32": 1e-4, "int8": 5e-3}
# tp_serve against bucket_serve (bf16, the serve depth): each rank rounds its
# partial products of wo and w_down to bf16 before the sum over the
# ranks, where one rank rounds the whole product once, and the random 8B
# model carries such roundings far. Two single-rank engines already put
# one context's logits apart: serve's ragged engine (other shapes) puts
# its first tokens' logits 0.27 (bf16 pool) and 0.67 (int8) at most,
# 0.04 / 0.10 on average, from bucket_serve's (on an H100, PERF.md); and
# streams part wherever two top logits lie closer than that. So the tp
# engine runs again, teacher-forced along bucket_serve's streams, and
# its logits for every token (the same contexts) may differ from
# bucket_serve's by at most this many times what the ragged engine's
# first tokens' differ, at most and on average
TP_YARDSTICK = 2.0
# the kernel rows the tp phases launch (rows 3, 9, 12-14q)
TP_KERNELS = ("flash_fwd", "varlen_fwd", "paged_decode", "paged_decode_int8",
              "paged_verify", "paged_verify_int8")
TP_DEADLINE_S = 480


def _tp_local_kernels(world):
    """pa_decode and pa_verify at one tp rank's local heads of Llama-3-8B
    (QH 32 / world over KVH 8 / world), bf16 and int8 pools with bf16 q,
    against their plain versions: a decode step at bucket_kernel's
    lengths and a G = 4 verify chunk at spec_kernel's bases."""
    import torch
    import paddle_tpu_torch.ops.paged_attention as pa
    qh, kvh = DECODE_SHAPE["QH"] // world, DECODE_SHAPE["KVH"] // world
    out = {}
    for name in ("bfloat16", "int8"):
        atol, rtol = TOL[VARIANTS[name][1]]
        int8 = "_int8" if name == "int8" else ""
        for kname, bases, g in ((f"paged_decode{int8}", DECODE_LENS, 1),
                                (f"paged_verify{int8}", VERIFY_BASES,
                                 VERIFY_G)):
            q, k, v, ks, vs, ptab, lens = _verify_batch(name, bases, g, qh,
                                                        kvh)
            kw = {"k_scale": ks, "v_scale": vs}
            if g == 1:
                q = q[:, :, 0].contiguous()
                ker = pa.paged_attention(q, k, v, ptab, lens, **kw)
                ref = pa.paged_decode_reference(q, k, v, ptab, lens, **kw)
            else:
                ker = pa.paged_verify_attention(q, k, v, ptab, lens, **kw)
                ref = pa.paged_verify_reference(q, k, v, ptab, lens, **kw)
            torch.cuda.synchronize()
            err = float((ker.float() - ref.float()).abs().max())
            if not torch.allclose(ker.float(), ref.float(), atol=atol,
                                  rtol=rtol):
                fail(f"tp_parity: {kname} at QH {qh} / KVH {kvh} vs plain: "
                     f"max |err| {err}")
            out[kname] = {"QH": qh, "KVH": kvh, "G": g,
                          "route": pa.route(q.dtype, k.dtype, q.shape[-1],
                                            qh // kvh),
                          "max_abs_err": err, "atol": atol, "rtol": rtol}
    return out


def _common_lp(a, b):
    """Where two runs' streams ({rid: tokens}, {rid: logprobs} each) first
    part ({rid: index}, for those that do), the largest logprob
    difference over the tokens before, and how many tokens that is."""
    parted, err, n_common = {}, 0.0, 0
    for rid, x in a["tokens"].items():
        y = b["tokens"][rid]
        n = next((i for i, (p, q) in enumerate(zip(x, y)) if p != q),
                 min(len(x), len(y)))
        if n < max(len(x), len(y)):
            parted[rid] = n
        n_common += n
        err = max([err] + [abs(p - q) for p, q in zip(
            a["logprobs"][rid][:n], b["logprobs"][rid][:n])])
    return parted, err, n_common


def _pool_gap(one, two, rank, world):
    """How this rank's pool shard in the tp engine (`two`: its K and V
    pools, (L, KVH, P, page, D)) differs from the single-rank engine's
    (`one`, cut to this rank's KV heads) after the same run, but for the
    trash page (the last: every inactive row writes it at once, and
    which write lands there is the card's choice): int8 codes, how many
    differ and the largest step between two; fp32, the largest
    difference."""
    import torch
    out = {}
    for name, a, b in zip(("k", "v"), one, two):
        a, b = a.chunk(world, 1)[rank][:, :, :-1], b[:, :, :-1]
        if a.dtype == torch.int8:
            d = (a.short() - b.short()).abs()
            out[name] = {"codes": a.numel(),
                         "codes_written": int((a != 0).sum()),
                         "codes_differ": int((d > 0).sum()),
                         "max_code_step": int(d.max())}
        else:
            out[name] = {"max_abs": float((a.float() - b.float()).abs().max())}
    return out


def _tp_parity_rank(rank, world, dev):
    """tp_parity on one rank: per pool and mode, the single-rank engine,
    the tp engine (the same full weights, each rank keeping its shard)
    and the control (the single-rank engine with its weights in bf16)
    on spec_parity's prompts; where the tp engine's streams part from
    the single-rank engine's, the single-rank model's top-2 margin
    there; how the pools' K / V differ."""
    import numpy as np
    import torch
    import paddle_tpu_torch.distributed.collective as C
    from paddle_tpu_torch.models.llama import LlamaConfig
    from paddle_tpu_torch.models.llama_serving import Request, ServingEngine
    from paddle_tpu_torch.models.llama_spmd import init_params
    from paddle_tpu_torch.parallel import create_mesh
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cfg = dataclasses.replace(LlamaConfig.llama3_8b(), num_hidden_layers=2)
    mesh = create_mesh({"tp": world})
    full = init_params(cfg, seed=0, dtype=torch.float32, device=dev)
    low = _tree_to(full, torch.bfloat16)
    prompts = _motif_prompts(np.random.default_rng(1), cfg.vocab_size,
                             SPEC_PARITY_LENS)
    out = {}
    for cache in (None, "int8"):
        for mode, mode_kw in TP_PARITY_MODES.items():
            runs, pools = {}, {}
            for name, m, params in (("single", None, full),
                                    ("tp", mesh, full),
                                    ("control", None, low)):
                eng = ServingEngine(params, cfg, mesh=m, cache_dtype=cache,
                                    device=dev, **TP_PARITY_ENGINE,
                                    **mode_kw)
                for i, p in enumerate(prompts):
                    eng.submit(Request(i, p, max_new_tokens=SPEC_PARITY_NEW,
                                       logprobs=True))
                C.reset_counters()
                t0 = time.perf_counter()
                done, calls, launches = _bucket_run(eng, pipelined=False)
                torch.cuda.synchronize(dev)
                runs[name] = {
                    "seconds": time.perf_counter() - t0,
                    "tokens": {r.rid: list(r.output) for r in done},
                    "logprobs": {r.rid: list(r.logprobs) for r in done},
                    "calls": calls, "launches": launches,
                    "device_steps": eng.device_steps,
                    "spec_drafted": eng.spec_drafted,
                    "spec_accepted": eng.spec_accepted,
                    "conserved": eng.pool.conserved(drained=True),
                    "kv_heads": int(eng.k_pool.shape[1]),
                    "collectives": C.counters()}
                pools[name] = (eng.k_pool, eng.v_pool)
                del eng
                gc_cuda()
            parted, lp_err, _ = _common_lp(runs["tp"], runs["single"])
            ctl_parted, ctl_err, ctl_n = _common_lp(runs["control"],
                                                    runs["single"])
            for rid, j in parted.items():
                b = runs["single"]["tokens"][rid]
                parted[rid] = (j, _top2_margin(full, cfg, prompts[rid]
                                               + b[:j], 16))
            out[f"{'fp32' if cache is None else 'int8'} {mode}"] = dict(
                runs, partings=parted, logprob_max_abs_err=lp_err,
                control_logprob_max_abs_err=ctl_err,
                control_common_tokens=ctl_n,
                control_partings=len(ctl_parted),
                pool_gap=_pool_gap(pools["single"], pools["tp"], rank,
                                   world))
            del pools
            gc_cuda()
    del full, low
    gc_cuda()
    if rank == 0:
        out["kernels"] = _tp_local_kernels(world)
    return out


def _tp_serve_rank(rank, world, dev, streams):
    """tp_serve on one rank: the serve phase's 8B weights (seed 0, on the
    card), each leaf cut to this rank's shard as it is drawn, then
    bucket_serve's 8 requests on a tp engine with a bf16 and an int8
    pool, measured as bucket_serve, with the collectives a step; then,
    untimed, the same requests teacher-forced along bucket_serve's
    `streams`, keeping the logits each token was drawn from (rank 0
    returns them, (8, 64, V) bf16; every rank their sums)."""
    import torch
    import paddle_tpu_torch.distributed.collective as C
    from paddle_tpu_torch.models import llama_spmd as T
    from paddle_tpu_torch.models.serving_capture import StepLogits
    from paddle_tpu_torch.parallel import create_mesh
    cfg = serve_config()
    mesh = create_mesh({"tp": world})
    torch.cuda.reset_peak_memory_stats(dev)
    t0 = time.perf_counter()
    params = T.init_params(cfg, seed=0, dtype=torch.bfloat16, device=dev,
                           mesh=mesh)
    torch.cuda.synchronize(dev)
    out = {"params_init_s": time.perf_counter() - t0,
           "params_gb": sum(t.numel() * t.element_size() for t in
                            T._leaves(params)) / 1e9,
           "init_peak_gb": torch.cuda.max_memory_allocated(dev) / 1e9}
    for cache in (None, "int8"):
        pool = "bf16" if cache is None else "int8"
        eng, reqs = serve_engine(cfg, params, cache, ragged=False, mesh=mesh,
                                 device=dev)
        finishes, prefills, coll = [], [], []
        finish = eng.step_finish

        def timed_finish(ticket, inflight=None, _finish=finish):
            n = _finish(ticket, inflight=inflight)
            finishes.append(time.perf_counter())
            coll.append(C.counters())
            return n
        eng.step_finish = timed_finish
        C.reset_counters()
        torch.cuda.synchronize(dev)
        t0 = time.perf_counter()
        try:
            done, calls, launches = _bucket_run(eng, pipelined=True,
                                                marks=prefills)
        finally:
            del eng.step_finish
        torch.cuda.synchronize(dev)
        wall = time.perf_counter() - t0
        # decode-only intervals and their collectives, as bucket_serve's
        gaps, per_step = [], []
        for i in range(1, len(finishes)):
            a, b = finishes[i - 1], finishes[i]
            if not any(a < p <= b for p in prefills):
                gaps.append(b - a)
                per_step.append({k: coll[i][k] - coll[i - 1][k]
                                 for k in coll[i]})
        row = out[pool] = {
            "wall_s": wall, "device_steps": eng.device_steps,
            "prefill_calls": calls, "prefill_tokens": eng.prefill_tokens,
            "pad_tokens": eng.pad_tokens,
            "prefill_tok_s": eng.prefill_tokens
            / (max(prefills, default=t0) - t0),
            "decode_step_ms_median": (statistics.median(gaps) * 1e3
                                      if gaps else None),
            "output_tok_s": 8 * 64 / wall, "launches": launches,
            "merge_launches": _merge_launches(),
            "conserved": eng.pool.conserved(drained=True),
            "kv_heads": int(eng.k_pool.shape[1]),
            "tokens": {r.rid: list(r.output) for r in done},
            "collectives_total": C.counters(),
            "collectives_to_first_finish": coll[0] if coll else None,
            "collectives_per_decode_step_median": {
                k: statistics.median(d[k] for d in per_step)
                for k in ("bytes_sent", "calls", "seconds")}
            if per_step else None}
        # teacher forcing, untimed: the same requests again on the
        # drained engine, each emitting bucket_serve's stream
        n0 = len(eng.finished)
        for r in serve_requests(cfg):
            eng.submit(r)
        forced = StepLogits(eng, force=streams[pool])
        t0 = time.perf_counter()
        try:
            again = eng.run()[n0:]
        finally:
            forced.close()
        rows = torch.stack([torch.stack([forced.row(rid, j).bfloat16()
                                         for j in range(64)])
                            for rid in sorted(streams[pool])])
        row.update(
            forced_s=time.perf_counter() - t0,
            forced_streams_ok={r.rid: list(r.output) for r in again}
            == streams[pool],
            forced_conserved=eng.pool.conserved(drained=True),
            forced_sums=[float(rows.float().sum()),
                         float(rows.float().abs().sum())],
            forced_rows=rows if rank == 0 else None)
        del eng, reqs, done, again, forced, rows
        gc_cuda()
    out["max_memory_allocated_gb"] = torch.cuda.max_memory_allocated(dev) / 1e9
    del params
    gc_cuda()
    return out


def _tp_rank(rank, world, job, dev):
    out = {}
    if job.get("parity"):
        t0 = time.perf_counter()
        out["parity"] = _tp_parity_rank(rank, world, dev)
        out["parity_seconds"] = time.perf_counter() - t0
    if job.get("serve") is not None:
        t0 = time.perf_counter()
        out["serve"] = _tp_serve_rank(rank, world, dev, job["serve"])
        out["serve_seconds"] = time.perf_counter() - t0
    return out


def _tp_equal_ranks(phase, ranks, keys):
    """Every rank's `keys` of each row equal rank 0's: the ranks stayed
    in lockstep."""
    for r, row in enumerate(ranks[1:], 1):
        for k in keys:
            if row[k] != ranks[0][k]:
                fail(f"{phase}: rank {r}'s {k} differ from rank 0's")


TP_PARITY_CONFIG = ("llama3_8b widths, 2 layers, fp32, TF32 off, bucketed "
                    "{mode}, max_seqs 3, run()")


def phase_tp_parity(card, spawned):
    from paddle_tpu_torch.models.llama import LlamaConfig
    results, info = spawned
    ranks = [res["tp"]["parity"] for res in results[2]]
    L, kvh = 2, LlamaConfig.llama3_8b().num_key_value_heads
    out = {}
    for key in (k for k in ranks[0] if k != "kernels"):
        pool, mode = key.split()
        rows = [r[key] for r in ranks]
        for r, row in enumerate(rows):
            for name in ("single", "tp", "control"):
                run = row[name]
                if len(run["tokens"]) != 4 or not run["conserved"]:
                    fail(f"tp_parity ({key}, {name}, rank {r}): "
                         f"{len(run['tokens'])} of 4 finished or the pool "
                         "leaked")
            for name in ("single", "tp"):
                run = row[name]
                if mode == "spec":
                    if run["spec_drafted"] == 0:
                        fail(f"tp_parity ({key}, {name}): nothing drafted")
                    want = _want_spec_counts(False, L, run["calls"],
                                             run["device_steps"],
                                             pool == "int8")
                else:
                    want = _want_bucket_counts(L, run["calls"],
                                               run["device_steps"],
                                               pool == "int8")
                if run["launches"] != want:
                    fail(f"tp_parity ({key}, {name}, rank {r}): launches "
                         f"{run['launches']}, want {want}")
            if row["tp"]["kv_heads"] != kvh // 2:
                fail(f"tp_parity: rank {r}'s pool holds "
                     f"{row['tp']['kv_heads']} KV heads, want {kvh // 2}")
        _tp_equal_ranks(f"tp_parity ({key})", [r["tp"] for r in rows],
                        ("tokens", "logprobs", "launches", "device_steps"))
        tp = [r["tp"] for r in rows]
        row = {"phase": "tp_parity", "card": card, "pool": pool,
               "mode": mode, "config": TP_PARITY_CONFIG.format(
                   mode="spec_decode=4" if mode == "spec" else "decode"),
               "mesh": {"tp": 2}, **info[2],
               "prompt_lens": list(SPEC_PARITY_LENS),
               "new_tokens": SPEC_PARITY_NEW,
               "requests_identical": 4 - len(rows[0]["partings"]),
               "partings": rows[0]["partings"],
               "logprob_max_abs_err": max(r["logprob_max_abs_err"]
                                          for r in rows),
               "logprob_atol": TP_PARITY_LP_ATOL[pool],
               "control_logprob_max_abs_err": min(
                   r["control_logprob_max_abs_err"] for r in rows),
               "control_common_tokens": rows[0]["control_common_tokens"],
               "control_partings": rows[0]["control_partings"],
               "pool_gap_per_rank": [r["pool_gap"] for r in rows],
               "prefill_calls": tp[0]["calls"],
               "device_steps": tp[0]["device_steps"],
               "spec_drafted": tp[0]["spec_drafted"],
               "spec_accepted": tp[0]["spec_accepted"],
               "launches_per_rank": [t["launches"] for t in tp],
               "single_rank_launches": rows[0]["single"]["launches"],
               "collectives_per_rank": [t["collectives"] for t in tp],
               "tp_seconds": max(t["seconds"] for t in tp),
               "single_rank_seconds": max(r["single"]["seconds"]
                                          for r in rows)}
        emit(row)
        out[key] = row
        for rid, (j, margin) in row["partings"].items():
            if margin >= 1e-3:
                fail(f"tp_parity ({key}): request {rid} parts at token {j} "
                     f"with top-2 margin {margin}")
        if row["logprob_max_abs_err"] > row["logprob_atol"]:
            fail(f"tp_parity ({key}): logprobs differ by "
                 f"{row['logprob_max_abs_err']} > {row['logprob_atol']}")
        if row["control_logprob_max_abs_err"] <= row["logprob_atol"]:
            fail(f"tp_parity ({key}): the bf16 control's logprobs lie "
                 f"{row['control_logprob_max_abs_err']} from the "
                 f"single-rank engine's, within the limit "
                 f"{row['logprob_atol']}")
        if pool == "int8" and not row["partings"]:
            for r, gap in enumerate(row["pool_gap_per_rank"]):
                for name, g in gap.items():
                    if g["max_code_step"] > 1:
                        fail(f"tp_parity ({key}): rank {r}'s {name} codes "
                             f"differ from one rank's by up to "
                             f"{g['max_code_step']}")
    emit({"phase": "tp_parity", "part": "local kernels", "card": card,
          "rank": 0, "kernels": ranks[0]["kernels"],
          "seconds": max(res["tp"]["parity_seconds"] for res in results[2])})
    return out


TP_SERVE_CONFIG = SERVE_CONFIG + ", ragged=False, tp 2"
# the forced rows' distances by token index: the first token (prefill),
# then decode steps early, middle and late
TP_DEPTHS = ((0, 1), (1, 16), (16, 32), (32, 64))


def _seed_gaps(rows, want):
    """How far two engines' logits for the first token of each request
    lie apart ({rid: (V,) rows} each, from the same prompts): the largest
    and the mean absolute difference over every request's row."""
    import numpy as np
    d = np.stack([np.abs(np.asarray(rows[r], np.float32)
                         - np.asarray(want[r], np.float32)) for r in want])
    return {"max_abs": float(d.max()), "mean_abs": float(d.mean())}


def _forced_gaps(tp_rows, one, want):
    """The teacher-forced tp engine's logits (`tp_rows`, (R, N, V))
    against bucket_serve's for the same contexts (`one`): the largest
    and the mean absolute difference, overall and by TP_DEPTHS; and
    each greedy row (requests 2-7) where the tp engine's own pick is not
    bucket_serve's token, with each engine's lead of its pick over the
    other's, beside the bf16 step of the top logit."""
    import torch
    from paddle_tpu_torch.models.serving_capture import bf16_step
    d = (tp_rows.float() - one).abs()
    row_max, row_mean = d.amax(-1), d.mean(-1)
    del d
    out = {"max_abs": float(row_max.max()),
           "mean_abs": float(row_mean.mean()),
           "by_depth": {f"{a}-{b - 1}": {
               "max_abs": float(row_max[:, a:b].max()),
               "mean_abs": float(row_mean[:, a:b].mean())}
               for a, b in TP_DEPTHS}}
    picks = tp_rows.float().argmax(-1)
    flips = []
    for rid in range(2, tp_rows.shape[0]):
        for j in range(tp_rows.shape[1]):
            a, b = int(picks[rid, j]), want[rid][j]
            if a != b:
                t, o = tp_rows[rid, j].float(), one[rid, j]
                flips.append({"request": rid, "token": j,
                              "tp_lead": float(t[a] - t[b]),
                              "bucket_lead": float(o[b] - o[a]),
                              "bf16_step": bf16_step(float(o.max()))})
    out["greedy_rows"] = 6 * tp_rows.shape[1]
    out["greedy_flips"] = flips
    return out


def phase_tp_serve(card, spawned, bserve, serve):
    import torch
    results, info = spawned
    ranks = [res["tp"]["serve"] for res in results[2]]
    cfg = serve_config()
    out = {}
    for pool in ("bf16", "int8"):
        rows = [r[pool] for r in ranks]
        for r, row in enumerate(rows):
            toks = row["tokens"]
            if len(toks) != 8 or not row["conserved"]:
                fail(f"tp_serve ({pool}, rank {r}): {len(toks)} of 8 "
                     "finished or the pool leaked")
            for rid, t in toks.items():
                if len(t) != 64 or not all(0 <= x < cfg.vocab_size
                                           for x in t):
                    fail(f"tp_serve ({pool}): request {rid} has {len(t)} "
                         "tokens, want 64 in the vocabulary")
            want = _want_bucket_counts(cfg.num_hidden_layers,
                                       row["prefill_calls"],
                                       row["device_steps"], pool == "int8")
            if row["launches"] != want:
                fail(f"tp_serve ({pool}, rank {r}): launches "
                     f"{row['launches']}, want {want}")
            if not (row["forced_streams_ok"] and row["forced_conserved"]):
                fail(f"tp_serve ({pool}, rank {r}): the forced run did not "
                     "emit bucket_serve's streams or its pool leaked")
        _tp_equal_ranks(f"tp_serve ({pool})", rows,
                        ("tokens", "launches", "device_steps",
                         "forced_sums"))
        plain = bserve[pool]
        streams, drawn = plain["streams"], plain["drawn"]
        one = torch.stack([torch.stack([drawn.row(rid, j) for j in range(64)])
                           for rid in range(8)])
        forced = _forced_gaps(rows[0]["forced_rows"], one, streams)
        del one
        # the yardstick: the first token's logits of another single-rank
        # engine (serve's ragged engine, other shapes) against
        # bucket_serve's
        ragged = _seed_gaps(serve[pool]["seeds"], drawn.seeds)
        # where the free-running streams first part from bucket_serve's
        parted = {rid: next((j for j, (x, y) in enumerate(zip(t, streams[rid]))
                             if x != y), None)
                  for rid, t in rows[0]["tokens"].items()}
        row = {"phase": "tp_serve", "card": card, "pool": pool,
               "config": TP_SERVE_CONFIG, "mesh": {"tp": 2}, **info[2],
               "new_tokens": 64, "sampled": [0, 1],
               "kv_heads_per_rank": rows[0]["kv_heads"],
               **{k: rows[0][k] for k in (
                   "device_steps", "prefill_calls", "prefill_tokens",
                   "pad_tokens")},
               "streams_identical": sum(j is None for j in parted.values()),
               "first_parting": parted,
               "forced_vs_bucket_serve": forced,
               "ragged_first_token_vs_bucket_serve": ragged,
               "yardstick_factor": TP_YARDSTICK,
               "forced_s_per_rank": [r["forced_s"] for r in rows],
               "wall_s_per_rank": [r["wall_s"] for r in rows],
               "output_tok_s": min(r["output_tok_s"] for r in rows),
               "decode_step_ms_median": max(r["decode_step_ms_median"]
                                            for r in rows),
               "prefill_tok_s": min(r["prefill_tok_s"] for r in rows),
               "max_memory_allocated_gb_per_rank":
                   [r["max_memory_allocated_gb"] for r in ranks],
               "params_gb_per_rank": [r["params_gb"] for r in ranks],
               "params_init_s": max(r["params_init_s"] for r in ranks),
               "collectives_per_decode_step_median_per_rank":
                   [r["collectives_per_decode_step_median"] for r in rows],
               "collectives_to_first_finish_per_rank":
                   [r["collectives_to_first_finish"] for r in rows],
               "collectives_total_per_rank":
                   [r["collectives_total"] for r in rows],
               "launches_per_rank": [r["launches"] for r in rows],
               "merge_launches_per_rank": [r["merge_launches"] for r in rows],
               "bucket_serve": {k: plain.get(k) for k in (
                   "output_tok_s", "decode_step_ms_median", "prefill_tok_s",
                   "device_steps")},
               "seconds": max(res["tp"]["serve_seconds"]
                              for res in results[2])}
        emit(row)
        out[pool] = row
    for pool, row in out.items():
        got, ragged = (row[k] for k in ("forced_vs_bucket_serve",
                                        "ragged_first_token_vs_bucket_serve"))
        for k in ("max_abs", "mean_abs"):
            if got[k] > TP_YARDSTICK * ragged[k]:
                fail(f"tp_serve ({pool}): the forced run's logits differ "
                     f"from bucket_serve's by {got[k]} ({k}), over "
                     f"{TP_YARDSTICK} x the ragged engine's first tokens' "
                     f"{ragged[k]}")
    return out


# --------------------------------------------- the Paddle-shaped surface
LAYER_PARITY_LAYERS = 1      # cut from 2 to pay for the layer phases
LAYER_PARITY_VOCAB = 4096
LAYER_PARITY_STEPS = 3
LAYER_PARITY_CONFIG = ("LlamaForCausalLM (Layer tree) at llama3_8b widths, "
                       f"{LAYER_PARITY_LAYERS} layers, vocab "
                       f"{LAYER_PARITY_VOCAB}, fp32, TF32 off, no remat, "
                       "batch 1 x 256, AdamW + ClipGradByGlobalNorm(1.0) + "
                       "LinearWarmup(3e-4, 2 steps from 1e-4)")
LAYER_TRAIN_LAYERS = 4
LAYER_TRAIN_STEPS = 6
LAYER_TRAIN_CONFIG = ("LlamaForCausalLM (Layer tree) at llama3_8b widths, "
                      f"{LAYER_TRAIN_LAYERS} layers, full vocabulary, "
                      "model.bfloat16(), AdamW(multi_precision=True, lr "
                      "3e-4) + ClipGradByGlobalNorm(1.0), no remat, random "
                      "weights (seed 0), batch 2 x 2048")
# the entry points' check: fp32 at Llama-3-8B attention widths, the
# documents of one packed row of 2048 tokens
LAYER_ENTRY_ATTN = {"T": 2048, "H": 32, "KVH": 8, "D": 128}
LAYER_ENTRY_DOCS = (700, 500, 848)
# fp32 kernels against their plain versions (TF32 off): sums over up to
# 2048 keys in another order
LAYER_ENTRY_TOL = (1e-4, 1e-4)


def _paddle(device):
    import paddle_tpu_torch as paddle
    paddle.set_device(device)
    return paddle


def _layer_batch(vocab, b, s, seed):
    """(input_ids, labels) from a numpy seed: labels the next token
    (every one a valid class: the Layer tree's cross_entropy ignores
    only -100)."""
    import numpy as np
    toks = np.random.default_rng(seed).integers(0, vocab, (b, s + 1))
    return toks[:, :-1], toks[:, 1:].copy()


def _layer_steps(paddle, model, batch, steps):
    """`steps` AdamW steps (clip 1.0, LinearWarmup from 1e-4 to 3e-4
    over 2 steps) of the Layer tree on `batch`. Returns (losses, the
    step-1 gradients on the CPU, the lr of each step)."""
    ids, labels = (paddle.to_tensor(a) for a in batch)
    sched = paddle.optimizer.lr.LinearWarmup(3e-4, 2, 1e-4, 3e-4)
    opt = paddle.optimizer.AdamW(
        sched, parameters=model.parameters(),
        grad_clip=paddle.nn.ClipGradByGlobalNorm(1.0))
    losses, first, lrs = [], None, []
    for i in range(steps):
        loss, _ = model(ids, labels=labels)
        loss.backward()
        if i == 0:
            first = [p.grad._value.detach().cpu() for p in
                     model.parameters()]
        lrs.append(opt.get_lr())
        opt.step()
        opt.clear_grad()
        sched.step()
        losses.append(float(loss))
    return losses, first, lrs


def _layer_entry_points(card):
    """F.flash_attn_unpadded and F.flashmask_attention through Tensors on
    the card, forward and backward once each, against their plain
    versions on the same card tensors (autograd through the dense
    references). Returns the row and each kernel's launches."""
    import numpy as np
    import torch
    import paddle_tpu_torch.ops.flashmask_attention as fm
    import paddle_tpu_torch.ops.varlen_attention as va
    paddle = _paddle("gpu:0")
    F = paddle.nn.functional
    t, h, kvh, d = (LAYER_ENTRY_ATTN[k] for k in ("T", "H", "KVH", "D"))
    rep, scale = h // kvh, 1.0 / math.sqrt(d)
    rs = np.random.RandomState(7)
    qn, kn, vn, won = (rs.randn(t, n, d).astype(np.float32) * 0.5
                       for n in (h, kvh, kvh, h))
    cu = np.concatenate([[0], np.cumsum(LAYER_ENTRY_DOCS)]).astype(np.int32)
    doc = np.repeat(np.arange(len(LAYER_ENTRY_DOCS)), LAYER_ENTRY_DOCS)
    rtol, atol = LAYER_ENTRY_TOL
    out = {}

    def check(name, got, want):
        errs = []
        for g, w in zip(got, want):
            g, w = g.float(), w.float()
            errs.append(float((g - w).abs().max().detach()))
            if not torch.allclose(g, w, rtol=rtol, atol=atol):
                fail(f"layer_parity {name}: off its plain version by "
                     f"{errs[-1]}")
        return errs

    # varlen: (T, H, D) packed; plain = varlen_reference over GQA-repeated
    # heads
    va.launches_fwd = va.launches_dq = va.launches_dkv = 0
    ts = [paddle.to_tensor(a, stop_gradient=False) for a in (qn, kn, vn)]
    o = F.flash_attn_unpadded(*ts, cu, cu, t, t, causal=True)[0]
    (o * paddle.to_tensor(won)).sum().backward()
    torch.cuda.synchronize()
    launches = {"varlen_fwd": va.launches_fwd,
                "varlen_bwd_dq": va.launches_dq,
                "varlen_bwd_dkv": va.launches_dkv}
    raw = [torch.from_numpy(a).cuda().requires_grad_(True)
           for a in (qn, kn, vn)]
    seg = torch.from_numpy(doc).cuda()
    po, _ = va.varlen_reference(
        raw[0].transpose(0, 1), raw[1].repeat_interleave(rep, 1).transpose(
            0, 1), raw[2].repeat_interleave(rep, 1).transpose(0, 1), seg,
        seg, True, scale)
    (po.transpose(0, 1) * torch.from_numpy(won).cuda()).sum().backward()
    out["flash_attn_unpadded"] = check(
        "flash_attn_unpadded", [o._value] + [x.grad._value for x in ts],
        [po.transpose(0, 1)] + [r.grad for r in raw])
    # FlashMask: (1, T, H, D) with a document-causal mask (each key's
    # rows end at its document's end)
    fm.launches_fwd = fm.launches_dq = fm.launches_dkv = 0
    ends = cu[1:][doc].astype(np.int32)
    sri = np.broadcast_to(ends[None, None, :, None], (1, kvh, t, 1)).copy()
    ts = [paddle.to_tensor(a[None], stop_gradient=False)
          for a in (qn, kn, vn)]
    o = F.flashmask_attention(*ts, paddle.to_tensor(sri), causal=True)
    (o * paddle.to_tensor(won[None])).sum().backward()
    torch.cuda.synchronize()
    launches.update({"flashmask_fwd": fm.launches_fwd,
                     "flashmask_bwd_dq": fm.launches_dq,
                     "flashmask_bwd_dkv": fm.launches_dkv})
    raw = [torch.from_numpy(a[None]).cuda().requires_grad_(True)
           for a in (qn, kn, vn)]
    qh, kh, vh = (x.transpose(1, 2) for x in raw)
    po, _ = fm.flashmask_reference(
        qh, kh.repeat_interleave(rep, 1), vh.repeat_interleave(rep, 1),
        torch.from_numpy(sri).cuda().repeat_interleave(rep, 1), causal=True)
    (po.transpose(1, 2) * torch.from_numpy(won[None]).cuda()).sum() \
        .backward()
    out["flashmask_attention"] = check(
        "flashmask_attention", [o._value] + [x.grad._value for x in ts],
        [po.transpose(1, 2)] + [r.grad for r in raw])
    if any(n != 1 for n in launches.values()):
        fail(f"layer_parity: the entry points launched {launches}, want "
             "one of each kernel")
    return out, launches


def phase_layer_parity(card):
    """The Layer-tree Llama at 8B widths (depth and vocabulary cut, fp32,
    TF32 off) trained 3 steps on the card and, from the same weights
    (drawn on the card, copied to the CPU), on the CPU: train_parity's
    limits; the flash kernels once a layer a step each. Then the
    entry points' check (`_layer_entry_points`)."""
    import copy
    import torch
    from paddle_tpu_torch.models.llama import LlamaConfig, LlamaForCausalLM
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cfg = dataclasses.replace(LlamaConfig.llama3_8b(),
                              num_hidden_layers=LAYER_PARITY_LAYERS,
                              vocab_size=LAYER_PARITY_VOCAB)
    batch = _layer_batch(cfg.vocab_size, 1, 256, seed=3)
    paddle = _paddle("gpu:0")
    paddle.seed(0)
    t0 = time.perf_counter()
    model = LlamaForCausalLM(cfg)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    cpu_model = copy.deepcopy(model).to("cpu")
    res = {}
    for dev, m in (("gpu:0", model), ("cpu", cpu_model)):
        paddle = _paddle(dev)
        _reset_train_counts()
        t0 = time.perf_counter()
        losses, first, lrs = _layer_steps(paddle, m, batch,
                                          LAYER_PARITY_STEPS)
        res[dev] = {"losses": losses, "grads": first,
                    "params": [p._value.detach().cpu()
                               for p in m.parameters()],
                    "launches": _train_counts(), "lrs": lrs,
                    "seconds": time.perf_counter() - t0}
    del model, cpu_model
    gc_cuda()
    L, steps = LAYER_PARITY_LAYERS, LAYER_PARITY_STEPS
    want = {k: 0 for k in _train_counts()}
    want.update({"flash_fwd": L * steps, "flash_bwd_dq": L * steps,
                 "flash_bwd_dkv": L * steps})
    gpu, cpu = res["gpu:0"], res["cpu"]
    if gpu["launches"] != want:
        fail(f"layer_parity: launches {gpu['launches']}, want {want}")
    if any(cpu["launches"].values()):
        fail("layer_parity: the CPU steps launched a CUDA kernel")
    loss_err = [abs(a - c) for a, c in zip(gpu["losses"], cpu["losses"])]
    if any(e > 1e-5 * abs(c) + 1e-5
           for e, c in zip(loss_err, cpu["losses"])):
        fail(f"layer_parity: losses {gpu['losses']} vs {cpu['losses']}")
    grad_worst = 0.0
    for a, c in zip(gpu["grads"], cpu["grads"]):
        allowed = (PARITY_GRAD_RTOL * c.abs()
                   + PARITY_GRAD_SCALE * float(c.abs().max()) + 1e-30)
        grad_worst = max(grad_worst, float(((a - c).abs() / allowed).max()))
    if grad_worst > 1.0:
        fail(f"layer_parity: step-1 gradients off, worst {grad_worst} of "
             "the tolerance")
    p_err = max(float((a - c).abs().max())
                for a, c in zip(gpu["params"], cpu["params"]))
    p_rel = max(float((a - c).norm() / c.norm())
                for a, c in zip(gpu["params"], cpu["params"]))
    if p_err > 2.5 * sum(gpu["lrs"]) or p_rel > 1e-5:
        fail(f"layer_parity: parameters off by {p_err} (relative norm "
             f"{p_rel})")
    entry, entry_launches = _layer_entry_points(card)
    row = {"phase": "layer_parity", "card": card,
           "config": LAYER_PARITY_CONFIG, "steps": steps,
           "lrs": gpu["lrs"], "losses_cuda": gpu["losses"],
           "losses_cpu": cpu["losses"], "loss_abs_err": loss_err,
           "grad_worst_share_of_tol": grad_worst,
           "param_max_abs_err": p_err, "param_max_rel_norm_err": p_rel,
           "param_abs_limit": 2.5 * sum(gpu["lrs"]),
           "launches": gpu["launches"], "params_init_s": init_s,
           "cuda_seconds": gpu["seconds"], "cpu_seconds": cpu["seconds"],
           "entry_points": {
               "shape": LAYER_ENTRY_ATTN, "docs": list(LAYER_ENTRY_DOCS),
               "dtype": "float32", "rtol_atol": list(LAYER_ENTRY_TOL),
               "max_abs_err_out_dq_dk_dv": entry,
               "launches": entry_launches}}
    emit(row)
    return row


def layer_train_setup():
    """layer_train's run: the bf16 Layer tree at 8B widths cut to
    LAYER_TRAIN_LAYERS (random weights after `paddle.seed(0)`, drawn on
    the card), AdamW with fp32 masters and clip 1.0, one batch of 2 x
    2048 tokens (numpy seed 4). Returns (config, model, step), where
    step() takes one training step and returns the loss Tensor."""
    from paddle_tpu_torch.models.llama import LlamaConfig, LlamaForCausalLM
    cfg = dataclasses.replace(LlamaConfig.llama3_8b(),
                              num_hidden_layers=LAYER_TRAIN_LAYERS)
    paddle = _paddle("gpu:0")
    paddle.seed(0)
    model = LlamaForCausalLM(cfg).bfloat16()
    opt = paddle.optimizer.AdamW(
        3e-4, parameters=model.parameters(), multi_precision=True,
        grad_clip=paddle.nn.ClipGradByGlobalNorm(1.0))
    ids, labels = (paddle.to_tensor(a) for a in
                   _layer_batch(cfg.vocab_size, 2, 2048, seed=4))

    def step():
        loss, _ = model(ids, labels=labels)
        loss.backward()
        opt.step()
        opt.clear_grad()
        return loss
    return cfg, model, step


def phase_layer_train(card, train):
    """The bf16 Layer-tree Llama (model.bfloat16(), fp32 masters in
    AdamW) at 8B widths, depth 4, full vocabulary: 6 steps on one batch
    of 2 x 2048 (`layer_train_setup`); the loss must fall, the flash
    kernels launch once a layer a step each. Reports tokens/s (median of
    steps 2-6) and the peak beside the functional train phase's."""
    import gc
    import statistics as st
    import torch
    gc.collect()
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    cfg, model, step = layer_train_setup()
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    torch.cuda.reset_peak_memory_stats()
    _reset_train_counts()
    losses, times = [], []
    for _ in range(LAYER_TRAIN_STEPS):
        t0 = time.perf_counter()
        losses.append(step().item())        # waits for the step
        times.append((time.perf_counter() - t0) * 1e3)
    launches = _train_counts()
    peak = torch.cuda.max_memory_allocated()
    L, steps = LAYER_TRAIN_LAYERS, LAYER_TRAIN_STEPS
    want = {k: 0 for k in launches}
    want.update({"flash_fwd": L * steps, "flash_bwd_dq": L * steps,
                 "flash_bwd_dkv": L * steps})
    if launches != want:
        fail(f"layer_train: launches {launches}, want {want}")
    if not all(math.isfinite(x) for x in losses):
        fail(f"layer_train: losses not finite: {losses}")
    if not losses[-1] < losses[0]:
        fail(f"layer_train: loss did not fall: {losses}")
    b, s = 2, 2048
    step_ms = st.median(times[1:])          # the first step allocates
    tok_s = b * s / (step_ms / 1e3)
    H, F_, V = cfg.hidden_size, cfg.intermediate_size, cfg.vocab_size
    kv = cfg.num_key_value_heads * (H // cfg.num_attention_heads)
    n_layers = L * (2 * H * H + 2 * H * kv + 3 * H * F_)
    flops_tok = 6 * (n_layers + V * H) + 12 * L * H * s
    row = {"phase": "layer_train", "card": card,
           "config": LAYER_TRAIN_CONFIG, "steps": steps, "losses": losses,
           "step_ms": times, "median_step_ms": step_ms,
           "tokens_per_s": tok_s, "model_flops_per_token": flops_tok,
           "model_flops_share_of_989T": flops_tok * tok_s / 989e12,
           "max_memory_allocated_gb": peak / 1e9, "launches": launches,
           "params_and_state_init_s": init_s,
           "params": sum(p.size for p in model.parameters()),
           "train_phase_tokens_per_s": train.get("tokens_per_s"),
           "train_phase_max_memory_allocated_gb":
               train.get("max_memory_allocated_gb"),
           "tokens_per_s_vs_train_phase":
               tok_s / train["tokens_per_s"] if train else None}
    emit(row)
    del model, step
    gc.collect()
    torch.cuda.empty_cache()
    return row


# ------------------------------------------- the parallel layer surface
# layer_parallel_parity: the Layer-tree Llama at 8B widths (depth and
# vocabulary cut as layer_parity's), fp32, TF32 off, batch 2 x 256, 2
# Trainer steps (AdamW, grad_clip_norm 1.0) in four layouts on the two
# ranks, each held to the single-rank Trainer (the parent's, on the
# card) by `_step_parity`'s limits; then MoELayer at Mixtral-8x7B's
# block widths on ep 2 and PipelineLayer on pp 2, each against one rank
LAYER_PAR_LAYERS = 2
LAYER_PAR_VOCAB = 4096
LAYER_PAR_STEPS = 2
LAYER_PAR_LR = 3e-4
LAYER_PAR_LAYOUTS = {
    "tp2_fleet": "fleet.init(mp_degree=2) + fleet.distributed_model",
    "dp2_data_parallel": "DataParallel on {dp: 2, tp: 1}, batch_spec P(dp)",
    "dp2_zero2": "group_sharded_parallel(level='os_g') on {dp: 2, tp: 1}",
    "dp2_zero3": "group_sharded_parallel(level='p_g_os') on {dp: 2, tp: 1}",
}
LAYER_PAR_CONFIG = ("LlamaForCausalLM (Layer tree) at llama3_8b widths, "
                    f"{LAYER_PAR_LAYERS} layers, vocab {LAYER_PAR_VOCAB}, "
                    "fp32, TF32 off, no remat, batch 2 x 256, Trainer: "
                    f"AdamW({LAYER_PAR_LR}), grad_clip_norm 1.0, "
                    f"{LAYER_PAR_STEPS} steps")
# Mixtral-8x7B's MoE block (hidden 4096, FFN 14336, 8 experts, top 2),
# capacity factor 1.0 over 512 tokens (capacity 128 a expert), fp32
LAYER_MOE = dict(d_model=4096, d_ff=14336, experts=8, top_k=2,
                 capacity_factor=1.0, tokens=512)
LAYER_MOE_AUX = 0.01
# eight LayerDesc(nn.Linear, 4096, 4096) staged over pp 2, x (4, 256,
# 4096) fp32 in 2 microbatches
LAYER_PIPE = dict(layers=8, width=4096, batch=(4, 256), n_micro=2)
LAYER_PARALLEL_LAYERS = 2   # cut from 4 to pay for the family phases
LAYER_PARALLEL_STEPS = 6
LAYER_PARALLEL_CONFIG = (
    "LlamaForCausalLM (Layer tree) at llama3_8b widths, "
    f"{LAYER_PARALLEL_LAYERS} layers, full vocabulary, model.bfloat16(), "
    "AdamW(multi_precision=True, lr 3e-4), Trainer grad_clip_norm 1.0, no "
    "remat, random weights (paddle.seed(0)), batch 2 x 2048 (seed 4), "
    "tp 2 through fleet.init(mp_degree=2)")
LAYER_DEADLINE_S = 420


def _layer_loss(model, batch):
    return model(batch[0], labels=batch[1])[0]


class _TrainerFirstGrads:
    """Keeps the gradients the parallel Trainer's first step reduced
    over the batch's axes (before the clip), and the spec each is held
    by, by wrapping `Trainer._reduce_grads` while it is entered."""

    def __enter__(self):
        from paddle_tpu_torch.parallel.trainer import Trainer
        self.grads, self._cls = None, Trainer
        self._orig = orig = Trainer._reduce_grads

        def reduce(tr, grads, data_axes):
            out = orig(tr, grads, data_axes)
            if self.grads is None:
                self.grads = ({n: g.detach().clone() for n, g in
                               out[0].items()}, dict(out[1]))
            return out
        Trainer._reduce_grads = reduce
        return self

    def __exit__(self, *exc):
        self._cls._reduce_grads = self._orig
        return False


def _layer_par_model(paddle, layers, vocab=None):
    """The Layer-tree Llama at 8B widths drawn on this process's card
    after `paddle.seed(0)` (the same weights in the parent and in every
    rank)."""
    from paddle_tpu_torch.models.llama import LlamaConfig, LlamaForCausalLM
    cfg = dataclasses.replace(LlamaConfig.llama3_8b(),
                              num_hidden_layers=layers,
                              **({"vocab_size": vocab} if vocab else {}))
    paddle.seed(0)
    return cfg, LlamaForCausalLM(cfg)


def _moe_inputs():
    import numpy as np
    rng = np.random.default_rng(6)
    m = LAYER_MOE["d_model"]
    return (rng.standard_normal((1, LAYER_MOE["tokens"], m)).astype(
        np.float32), rng.standard_normal((1, LAYER_MOE["tokens"], m)).astype(
        np.float32))


def _moe_run(paddle, mesh=None):
    """MoELayer at LAYER_MOE drawn after paddle.seed(1) (placed on
    `mesh`'s ep axis when given): out, aux loss, dropped count, and the
    gradients of sum(out * w) + LAYER_MOE_AUX * aux (the experts' this
    rank's block)."""
    import torch
    from paddle_tpu_torch.parallel import MoELayer, place_layer
    paddle.seed(1)
    c = LAYER_MOE
    layer = MoELayer(c["d_model"], c["d_ff"], c["experts"], top_k=c["top_k"],
                     capacity_factor=c["capacity_factor"])
    if mesh is not None:
        place_layer(layer, mesh)
    x, w = _moe_inputs()
    xt = paddle.to_tensor(x, stop_gradient=False)
    out = layer(xt)
    loss = (out._value * torch.from_numpy(w).to(out._value.device)).sum() \
        + LAYER_MOE_AUX * layer.aux_loss._value
    loss.backward()
    grads = {n: p.grad._value for n, p in layer.named_parameters()}
    grads["x"] = xt.grad._value
    return {"out": out._value.detach(),
            "aux": float(layer.aux_loss._value.detach()),
            "dropped": int(layer.dropped._value), "grads": grads}


def _layer_parallel_references(out_dir):
    """Before the ranks start, on the card: the single-rank Trainer's
    losses, step-1 gradients and parameters after LAYER_PAR_STEPS steps
    (leaves saved by name order in `out_dir`), and MoELayer's outputs
    and gradients on one rank."""
    import numpy as np
    import torch
    from paddle_tpu_torch.parallel import Trainer
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    paddle = _paddle("gpu:0")
    cfg, model = _layer_par_model(paddle, LAYER_PAR_LAYERS, LAYER_PAR_VOCAB)
    opt = paddle.optimizer.AdamW(LAYER_PAR_LR, parameters=model.parameters())
    tr = Trainer(model, opt, _layer_loss, grad_clip_norm=1.0)
    batch = _layer_batch(cfg.vocab_size, 2, 256, seed=3)
    _reset_train_counts()
    with _TrainerFirstGrads() as first:
        losses = [float(tr.step(batch)) for _ in range(LAYER_PAR_STEPS)]
    names = list(tr.params)
    grads = first.grads[0]
    for i, n in enumerate(names):
        np.save(os.path.join(out_dir, f"layer_grads_{i}.npy"),
                grads[n].cpu().numpy())
        np.save(os.path.join(out_dir, f"layer_params_{i}.npy"),
                tr.params[n].cpu().numpy())
    ref = {"names": names, "losses": losses,
           "grad_max": [float(grads[n].abs().max()) for n in names],
           "launches": _train_counts()}
    del model, opt, tr, first, grads
    gc_cuda()
    moe = _moe_run(paddle)
    for k, g in moe["grads"].items():
        np.save(os.path.join(out_dir, f"moe_grads_{k}.npy"), g.cpu().numpy())
    np.save(os.path.join(out_dir, "moe_out.npy"), moe["out"].cpu().numpy())
    ref["moe"] = {"aux": moe["aux"], "dropped": moe["dropped"],
                  "names": list(moe["grads"])}
    del moe
    gc_cuda()
    return ref


def _tol_worst(got, want, scale=None):
    """Largest |got - want| over PARITY_GRAD_RTOL |want| + PARITY_GRAD_SCALE
    x the largest |want| (of the whole tensor: `scale`)."""
    want = want.to(got.device).float()
    m = float(want.abs().max()) if scale is None else scale
    allowed = PARITY_GRAD_RTOL * want.abs() + PARITY_GRAD_SCALE * m + 1e-30
    return float(((got.float() - want).abs() / allowed).max())


def _layer_parity_layout(paddle, name, world, ref, ref_leaves):
    """One layout of layer_parallel_parity on this rank: the layout's
    Trainer from the reference's weights, its errors against the
    reference (`ref_leaves`: its step-1 gradients and parameters on
    this rank's card, by name order; each layout's gathered whole),
    launches and collectives."""
    import paddle_tpu_torch.distributed.collective as C
    from paddle_tpu_torch.distributed import (DataParallel, fleet,
                                              group_sharded_parallel)
    from paddle_tpu_torch.parallel import P, Trainer, create_mesh
    from paddle_tpu_torch.parallel.mesh import gather
    cfg, model = _layer_par_model(paddle, LAYER_PAR_LAYERS, LAYER_PAR_VOCAB)
    opt = paddle.optimizer.AdamW(LAYER_PAR_LR, parameters=model.parameters())
    if name == "tp2_fleet":
        strategy = fleet.DistributedStrategy()
        strategy.hybrid_configs["mp_degree"] = world
        fleet.init(is_collective=True, strategy=strategy)
        mesh = fleet.fleet.get_mesh()
        model = fleet.distributed_model(model)
        opt = fleet.distributed_optimizer(opt)
    else:
        mesh = create_mesh({"dp": world, "tp": 1})
        if name == "dp2_data_parallel":
            model = DataParallel(model)
        else:
            model, opt = group_sharded_parallel(
                model, opt, "os_g" if name == "dp2_zero2" else "p_g_os")
    tr = Trainer(model, opt, _layer_loss, mesh=mesh, batch_spec=P("dp"),
                 grad_clip_norm=1.0)
    batch = _layer_batch(cfg.vocab_size, 2, 256, seed=3)
    _reset_train_counts()
    C.reset_counters()
    t0 = time.perf_counter()
    with _TrainerFirstGrads() as first:
        losses = [float(tr.step(batch)) for _ in range(LAYER_PAR_STEPS)]
    secs = time.perf_counter() - t0
    launches, coll = _train_counts(), C.counters()
    label = f"layer_parallel_parity {name} (rank {mesh.rank})"
    loss_err = [abs(a - c) for a, c in zip(losses, ref["losses"])]
    if any(e > 1e-5 * abs(c) + 1e-5 for e, c in zip(loss_err,
                                                    ref["losses"])):
        fail(f"{label}: losses {losses} vs {ref['losses']}")
    grads, held = first.grads
    named = {n.replace("_layers.", ""): n for n in tr.params}
    worst = p_err = p_rel = 0.0
    for i, n in enumerate(ref["names"]):
        mine = named[n]
        g = gather(grads[mine].contiguous(), held[mine], mesh)
        worst = max(worst, _tol_worst(g, ref_leaves["grads"][i],
                                      ref["grad_max"][i]))
        p = gather(tr.params[mine].contiguous(), tr.param_specs[mine], mesh)
        c = ref_leaves["params"][i]
        p_err = max(p_err, float((p - c).abs().max()))
        p_rel = max(p_rel, float((p - c).norm() / c.norm()))
    if worst > 1.0:
        fail(f"{label}: step-1 gradients off, worst {worst} of the "
             "tolerance")
    if p_err > 2.5 * LAYER_PAR_LR * LAYER_PAR_STEPS or p_rel > 1e-5:
        fail(f"{label}: parameters off by {p_err} (relative norm {p_rel})")
    out = {"losses": losses, "loss_abs_err": loss_err,
           "grad_worst_share_of_tol": worst, "param_max_abs_err": p_err,
           "param_max_rel_norm_err": p_rel, "launches": launches,
           "collectives": coll, "seconds": secs, "mesh": dict(mesh.shape),
           "zero_stage": tr.sharding_stage,
           "sliced_leaves": sum("dp" in map(str, s) for s in
                                tr.param_specs.values()) if
           tr.sharding_stage >= 3 else sum(
               "dp" in map(str, lf.update) for lf in tr._leaves.values())}
    del model, opt, tr, first, grads
    gc_cuda()
    return out


def _layer_moe_rank(paddle, world, ref, ref_dir):
    """MoELayer on ep `world` against the parent's one-rank run: the
    whole output, the aux loss, the dropped count, the input's and the
    gate's gradients and this rank's experts' block of theirs."""
    import numpy as np
    import torch
    from paddle_tpu_torch.parallel import create_mesh
    mesh = create_mesh({"ep": world})
    t0 = time.perf_counter()
    got = _moe_run(paddle, mesh)
    secs = time.perf_counter() - t0
    r = mesh.coord("ep")
    label = f"layer_parallel_parity moe (rank {mesh.rank})"
    load = lambda f: torch.from_numpy(np.load(  # noqa: E731
        os.path.join(ref_dir, f), mmap_mode="c"))
    errs = {"out": _tol_worst(got["out"], load("moe_out.npy"))}
    for n in ref["names"]:
        want = load(f"moe_grads_{n}.npy")
        g = got["grads"][n]
        if g.shape != want.shape:          # this rank's experts
            scale = float(want.abs().max())
            want = want.chunk(world, 0)[r]
            errs[n] = _tol_worst(g, want, scale)
        else:
            errs[n] = _tol_worst(g, want)
    aux_err = abs(got["aux"] - ref["aux"])
    if max(errs.values()) > 1.0:
        fail(f"{label}: off, share of the tolerance {errs}")
    if aux_err > 1e-6 * abs(ref["aux"]) + 1e-7:
        fail(f"{label}: aux loss {got['aux']} vs {ref['aux']}")
    if got["dropped"] != ref["dropped"] or ref["dropped"] < 1:
        fail(f"{label}: dropped {got['dropped']}, one rank {ref['dropped']}")
    return {"worst_share_of_tol": errs, "aux": got["aux"],
            "aux_abs_err": aux_err, "dropped": got["dropped"],
            "seconds": secs}


def _layer_pipe_rank(paddle, world):
    """PipelineLayer over LAYER_PIPE's linears staged on pp `world`
    against the same layers run in sequence on this rank: output, the
    input's gradient and this rank's staged layers' gradients."""
    import numpy as np
    import torch
    from paddle_tpu_torch import nn
    from paddle_tpu_torch.parallel import (LayerDesc, PipelineLayer,
                                           create_mesh)
    c = LAYER_PIPE
    mesh = create_mesh({"pp": world})
    paddle.seed(2)
    pl = PipelineLayer([LayerDesc(nn.Linear, c["width"], c["width"])
                        for _ in range(c["layers"])], num_stages=world,
                       mesh=mesh, n_micro=c["n_micro"])
    rng = np.random.default_rng(7)
    x = rng.standard_normal((*c["batch"], c["width"])).astype(np.float32)
    w = torch.from_numpy(rng.standard_normal(
        (*c["batch"], c["width"])).astype(np.float32))
    runs = {}
    for label in ("staged", "sequential"):
        for layer in pl.built:
            layer.clear_gradients()
        xt = paddle.to_tensor(x, stop_gradient=False)
        t0 = time.perf_counter()
        if label == "staged":
            out = pl(xt)
        else:
            out = xt
            for layer in pl.built:
                out = layer(out)
        (out._value * w.to(out._value.device)).sum().backward()
        runs[label] = {"out": out._value.detach(), "x": xt.grad._value,
                       "grads": [[p.grad._value.clone() if p.grad is not None
                                  else None for p in layer.parameters()]
                                 for layer in pl.built],
                       "seconds": time.perf_counter() - t0}
    r, per = mesh.coord("pp"), c["layers"] // world
    a, b = runs["staged"], runs["sequential"]
    errs = {"out": _tol_worst(a["out"], b["out"]),
            "x_grad": _tol_worst(a["x"], b["x"])}
    for i in range(r * per, (r + 1) * per):
        for j, (ga, gb) in enumerate(zip(a["grads"][i], b["grads"][i])):
            errs[f"layer{i}.{j}"] = _tol_worst(ga, gb)
    if max(errs.values()) > 1.0 or not pl._will_stage():
        fail(f"layer_parallel_parity pipeline (rank {mesh.rank}): off, "
             f"share of the tolerance {errs}")
    return {"worst_share_of_tol": max(errs.values()),
            "segments": pl._segments, "staged_seconds": a["seconds"],
            "sequential_seconds": b["seconds"]}


def _layer_speed_rank(paddle, world, dev):
    """layer_parallel on this rank: the bf16 Layer tree at 8B widths on
    tp `world` through fleet.init and the Trainer, LAYER_PARALLEL_STEPS
    steps."""
    import torch
    import paddle_tpu_torch.distributed.collective as C
    from paddle_tpu_torch.distributed import fleet
    from paddle_tpu_torch.parallel import P, Trainer
    torch.cuda.reset_peak_memory_stats(dev)
    t0 = time.perf_counter()
    cfg, model = _layer_par_model(paddle, LAYER_PARALLEL_LAYERS)
    model = model.bfloat16()
    strategy = fleet.DistributedStrategy()
    strategy.hybrid_configs["mp_degree"] = world
    fleet.init(is_collective=True, strategy=strategy)
    model = fleet.distributed_model(model)
    opt = fleet.distributed_optimizer(paddle.optimizer.AdamW(
        3e-4, parameters=model.parameters(), multi_precision=True))
    tr = Trainer(model, opt, _layer_loss, mesh=fleet.fleet.get_mesh(),
                 batch_spec=P("dp"), grad_clip_norm=1.0)
    batch = _layer_batch(cfg.vocab_size, 2, 2048, seed=4)
    torch.cuda.synchronize(dev)
    init_s = time.perf_counter() - t0
    _reset_train_counts()
    losses, times, coll = [], [], []
    for _ in range(LAYER_PARALLEL_STEPS):
        C.reset_counters()
        torch.cuda.synchronize(dev)
        t0 = time.perf_counter()
        losses.append(tr.step(batch).item())      # waits for the step
        times.append((time.perf_counter() - t0) * 1e3)
        coll.append(C.counters())
    out = {"losses": losses, "step_ms": times, "launches": _train_counts(),
           "collectives": coll, "init_s": init_s,
           "max_memory_allocated_gb":
               torch.cuda.max_memory_allocated(dev) / 1e9,
           "params_a_rank": sum(t.numel() for t in tr.params.values())}
    del model, opt, tr
    gc_cuda()
    return out


def _layer_rank(rank, world, job, dev):
    """The layer phases on this rank (the world-2 job of
    `_spawn_parallel`)."""
    import torch
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    paddle = _paddle(f"gpu:{dev.index}")
    out = {}
    if job.get("parity"):
        import numpy as np
        ref, ref_dir = job["refs"], job["dir"]
        # the reference on this rank's card once, for every layout
        ref_leaves = {what: [torch.from_numpy(np.load(os.path.join(
            ref_dir, f"layer_{what}_{i}.npy"))).to(dev)
            for i in range(len(ref["names"]))]
            for what in ("grads", "params")}
        out["parity"] = {name: _layer_parity_layout(paddle, name, world,
                                                    ref, ref_leaves)
                         for name in LAYER_PAR_LAYOUTS}
        del ref_leaves
        gc_cuda()
        out["moe"] = _layer_moe_rank(paddle, world, ref["moe"], ref_dir)
        out["pipe"] = _layer_pipe_rank(paddle, world)
    if job.get("speed"):
        out["speed"] = _layer_speed_rank(paddle, world, dev)
    return out


def phase_layer_parallel_parity(card, spawned):
    results, info = spawned
    ranks = [res["layer"] for res in results[2]]
    L, steps = LAYER_PAR_LAYERS, LAYER_PAR_STEPS
    want = {k: 0 for k in _train_counts()}
    want.update({"flash_fwd": L * steps, "flash_bwd_dq": L * steps,
                 "flash_bwd_dkv": L * steps})
    out = {}
    for name, how in LAYER_PAR_LAYOUTS.items():
        rows = [r["parity"][name] for r in ranks]
        for i, row in enumerate(rows):
            if row["launches"] != want:
                fail(f"layer_parallel_parity {name}: rank {i} launches "
                     f"{row['launches']}, want {want}")
        row = {"phase": "layer_parallel_parity", "card": card,
               "layout": name, "how": how, "config": LAYER_PAR_CONFIG,
               "mesh": rows[0]["mesh"], "zero_stage": rows[0]["zero_stage"],
               "dp_sliced_leaves": rows[0]["sliced_leaves"],
               **info[2], "losses": rows[0]["losses"],
               "reference_losses": info[2]["layer_reference"]["losses"],
               "loss_abs_err": rows[0]["loss_abs_err"],
               "grad_worst_share_of_tol": max(
                   r["grad_worst_share_of_tol"] for r in rows),
               "param_max_abs_err": max(r["param_max_abs_err"] for r in rows),
               "param_max_rel_norm_err": max(r["param_max_rel_norm_err"]
                                             for r in rows),
               "launches_per_rank": [r["launches"] for r in rows],
               "want_launches": want,
               "collective_bytes_per_rank": [r["collectives"]["bytes_sent"]
                                             for r in rows],
               "collective_calls_per_rank": [r["collectives"]["calls"]
                                             for r in rows],
               "steps_seconds": max(r["seconds"] for r in rows)}
        row.pop("layer_reference", None)
        emit(row)
        out[name] = row
    moe = [r["moe"] for r in ranks]
    out["moe"] = {"phase": "layer_parallel_parity", "card": card,
                  "layout": "moe_ep2", "config": (
                      "MoELayer at Mixtral-8x7B block widths "
                      f"{LAYER_MOE}, fp32, TF32 off, loss sum(out * w) + "
                      f"{LAYER_MOE_AUX} aux; ep 2 against one rank"),
                  "dropped": moe[0]["dropped"],
                  "aux": moe[0]["aux"],
                  "aux_abs_err": max(m["aux_abs_err"] for m in moe),
                  "worst_share_of_tol_per_rank": [m["worst_share_of_tol"]
                                                  for m in moe],
                  "seconds": max(m["seconds"] for m in moe)}
    emit(out["moe"])
    pipe = [r["pipe"] for r in ranks]
    out["pipe"] = {"phase": "layer_parallel_parity", "card": card,
                   "layout": "pipeline_pp2", "config": (
                       f"PipelineLayer of {LAYER_PIPE['layers']} LayerDesc("
                       f"nn.Linear, {LAYER_PIPE['width']}, "
                       f"{LAYER_PIPE['width']}), x {LAYER_PIPE['batch']} x "
                       f"{LAYER_PIPE['width']} fp32, {LAYER_PIPE['n_micro']}"
                       " microbatches, staged on pp 2 against sequential"),
                   "segments": pipe[0]["segments"],
                   "worst_share_of_tol": max(p["worst_share_of_tol"]
                                             for p in pipe),
                   "staged_seconds": [p["staged_seconds"] for p in pipe],
                   "sequential_seconds": [p["sequential_seconds"]
                                          for p in pipe]}
    emit(out["pipe"])
    return out


def phase_layer_parallel(card, spawned, ltrain, par):
    import statistics as st
    results, info = spawned
    ranks = [res["layer"]["speed"] for res in results[2]]
    L, steps = LAYER_PARALLEL_LAYERS, LAYER_PARALLEL_STEPS
    want = {k: 0 for k in _train_counts()}
    want.update({"flash_fwd": L * steps, "flash_bwd_dq": L * steps,
                 "flash_bwd_dkv": L * steps})
    for i, r in enumerate(ranks):
        if r["launches"] != want:
            fail(f"layer_parallel: rank {i} launches {r['launches']}, want "
                 f"{want}")
    losses = ranks[0]["losses"]
    if not all(math.isfinite(x) for x in losses):
        fail(f"layer_parallel: losses not finite: {losses}")
    if not losses[-1] < losses[0]:
        fail(f"layer_parallel: loss did not fall: {losses}")
    step_ms = max(st.median(r["step_ms"][1:]) for r in ranks)
    tok_s = 2 * 2048 / (step_ms / 1e3)
    per_step = lambda r, k: [c[k] for c in r["collectives"]]  # noqa: E731
    functional = par.get("tp2", {}).get("global_tokens_per_s")
    row = {"phase": "layer_parallel", "card": card,
           "config": LAYER_PARALLEL_CONFIG, **info[2],
           "steps": steps, "losses": losses,
           "step_ms_per_rank": [r["step_ms"] for r in ranks],
           "median_step_ms": step_ms, "global_tokens_per_s": tok_s,
           "layer_train_tokens_per_s": ltrain.get("tokens_per_s"),
           "functional_tp2_global_tokens_per_s": functional,
           "vs_layer_train": tok_s / ltrain["tokens_per_s"]
           if ltrain else None,
           "vs_functional_tp2": tok_s / functional if functional else None,
           "max_memory_allocated_gb_per_rank":
               [r["max_memory_allocated_gb"] for r in ranks],
           "collective_bytes_per_step_per_rank":
               [per_step(r, "bytes_sent") for r in ranks],
           "collective_seconds_per_step_per_rank":
               [per_step(r, "seconds") for r in ranks],
           "collective_calls_per_step_per_rank":
               [per_step(r, "calls") for r in ranks],
           "launches_per_rank": [r["launches"] for r in ranks],
           "want_launches": want,
           "params_per_rank": [r["params_a_rank"] for r in ranks],
           "init_s": [r["init_s"] for r in ranks]}
    row.pop("layer_reference", None)
    emit(row)
    return row


# ------------------------------------------------- the decoder families
# family_kernel's timed shapes, causal: DeepSeek's MLA training shape at
# D = 192 (qk_nope 128 + qk_rope 64) and a D = 256 one
FAMILY_ATTN = {192: (2, 32, 2048), 256: (2, 16, 2048)}
FAMILY_DESIGN = {
    "bfloat16": "tensor cores: mma.sync m16n8k16, cp.async ring of 2, P and "
                "dS as bf16 hi + lo; a block owns 64 of the output's "
                "columns (a grid axis) and forms the scores over the whole "
                "head dim",
    "float32": "cuda-core fp32; dQ and dK/dV stream the other operands in "
               "64-dim chunks, a block owns 64 of the output's columns"}
FAMILY_PARITY_VOCAB = 4096
FAMILY_PARITY_BATCH = (1, 128)
FAMILY_PARITY_STEPS = 2
# family_parity's limit on the update of a leaf drawn at zero or of a MoE
# router (see _family_parity_one): AdamW's update is a ratio of the
# gradients' moments, so its relative error may reach twice theirs
FAMILY_UPDATE_RTOL = 2 * PARITY_GRAD_RTOL
FAMILY_GEN_NEW = 16          # greedy tokens the parity phase generates
FAMILY_GENERATE = ("qwen2", "gpt2")   # the families with a generate
# family_parity's models: name -> (config constructor, layers, vocab cut)
FAMILY_PARITY = {"qwen2": ("qwen2_7b", 1, True), "gpt2": ("gpt2", 2, False),
                 "moe": ("moe", 1, True), "deepseek": ("deepseek", 2, True)}
FAMILY_RUN_LAYERS = 2
FAMILY_RUN_STEPS = 6
FAMILY_RUN_CONFIG = ("DeepSeekForCausalLM at DeepSeekConfig() widths "
                     "(hidden 4096, 32 heads, MLA: kv_lora 512, qk 128 + 64, "
                     "v 128; FFN 11008, 8 routed experts top 2 + 1 shared), "
                     f"{FAMILY_RUN_LAYERS} layers (one dense, one MoE), "
                     "vocabulary 32000, model.bfloat16(), "
                     "AdamW(multi_precision=True, lr 3e-4) + "
                     "ClipGradByGlobalNorm(1.0), random weights (seed 0), "
                     "batch 2 x 2048")
FAMILY_GPT2_PROMPTS = (8, 64)
FAMILY_GPT2_NEW = 64


def _flash_ptxas(kname, dname, dp):
    """The registers and spill bytes of row kname's instantiation at
    padded head dim dp (from the build's ptxas report), or None."""
    from paddle_tpu_torch.kernels import _build
    kind = {"flash_fwd": "fwd", "flash_bwd_dq": "dq",
            "flash_bwd_dkv": "dkv"}[kname]
    label = (f"{kind}_tc_kernel<{dp}, FlashPolicy>" if dname == "bfloat16"
             else f"{kind}_kernel<{dp}>")
    for k in _ptxas_kernels(_build.ptxas_report("flash_attention")):
        if k["kernel"] == label:
            return k
    return None


def _family_flash_case(dt, b, h, sq, sk, d, causal, seed):
    """Rows 3-5 on one case against their plain versions: the largest
    |error| of o, dq, dk, dv (fails past TOL) and of lse."""
    import math
    import torch
    import paddle_tpu_torch.ops.flash_attention as fa
    g = torch.Generator(device="cuda")
    g.manual_seed(seed)
    q, do = (torch.randn((b, h, sq, d), generator=g, device="cuda").to(dt)
             for _ in range(2))
    k, v = (torch.randn((b, h, sk, d), generator=g, device="cuda").to(dt)
            for _ in range(2))
    scale = 1.0 / math.sqrt(d)
    o, lse = fa._launch_fwd(q, k, v, causal, scale)
    o_ref, lse_ref = fa.flash_fwd_reference(q, k, v, causal, scale)
    delta = (do.float() * o_ref.float()).sum(-1)
    args = (q, k, v, do, lse_ref, delta, causal, scale)
    dq = fa._launch_dq(*args)
    dk, dv = fa._launch_dkv(*args)
    torch.cuda.synchronize()
    dname = str(dt).split(".")[1]
    label = f"family_kernel flash d={d} sq={sq} sk={sk} causal={causal}"
    errs = _check_kernels(
        label, dname, {"o": [o], "dq": [dq], "dkv": [dk, dv]},
        {"o": [o_ref], "dq": [fa.flash_bwd_dq_reference(*args)],
         "dkv": list(fa.flash_bwd_dkv_reference(*args))}, lse, lse_ref)
    return max(errs.values())


def _family_flashmask_case(dt, d, seed):
    """The FlashMask kernels at head dim d on packed documents (causal,
    the (B, 1, S, 1) doc-end mask of three documents in 300 tokens)."""
    import math
    import numpy as np
    import torch
    import paddle_tpu_torch.ops.flashmask_attention as fm
    b, h, s = 2, 4, 300
    ends = np.repeat([120, 190, 300], [120, 70, 110])
    sri = torch.from_numpy(np.ascontiguousarray(np.broadcast_to(
        ends[None, None, :, None], (b, 1, s, 1)), dtype=np.int32)).to("cuda")
    g = torch.Generator(device="cuda")
    g.manual_seed(seed)
    q, k, v, do = (torch.randn((b, h, s, d), generator=g,
                               device="cuda").to(dt) for _ in range(4))
    m = fm._Mask(True, None, 1.0 / math.sqrt(d), 0.0, None)
    o, lse, _ = fm._launch_fwd(q, k, v, sri, m, count_tiles=True)
    o_ref, lse_ref = fm.flashmask_fwd_reference(q, k, v, sri, *m)
    delta = (do.float() * o_ref.float()).sum(-1)
    args = (q, k, v, sri, do, lse_ref, delta)
    dq, _ = fm._launch_dq(*args, m, count_tiles=True)
    dk, dv, _ = fm._launch_dkv(*args, m, count_tiles=True)
    torch.cuda.synchronize()
    errs = _check_kernels(
        f"family_kernel flashmask d={d}", str(dt).split(".")[1],
        {"o": [o], "dq": [dq], "dkv": [dk, dv]},
        {"o": [o_ref], "dq": [fm.flashmask_bwd_dq_reference(*args, *m)],
         "dkv": list(fm.flashmask_bwd_dkv_reference(*args, *m))},
        lse, lse_ref)
    return max(errs.values())


def _family_varlen_case(dt, d, seed):
    """The varlen kernels at head dim d on one ragged axis (segments of
    70, 1, 130 and 64 tokens and 35 pads in 300; 4 query heads over 2
    KV heads, causal)."""
    import numpy as np
    import torch
    import paddle_tpu_torch.ops.varlen_attention as va
    lens = [70, 1, 130, 64]
    seg = np.full((300,), -1, np.int32)
    seg[:sum(lens)] = np.repeat(np.arange(len(lens)), lens)
    seg = torch.from_numpy(seg).to("cuda")
    g = torch.Generator(device="cuda")
    g.manual_seed(seed)
    q, do = (torch.randn((300, 4, d), generator=g, device="cuda").to(dt)
             for _ in range(2))
    k, v = (torch.randn((300, 2, d), generator=g, device="cuda").to(dt)
            for _ in range(2))
    scale = d ** -0.5
    sq, sk = va._sentinels(seg, seg)
    o, lse = va._launch_fwd(q, k, v, sq, sk, True, scale, True)
    o_ref, lse_ref, delta, dq_ref, dk_ref, dv_ref = _varlen_bwd_plain(
        q, k, v, do, seg, seg, True, scale)
    args = (q, k, v, do, lse_ref, delta, sq, sk, True, scale)
    dq = va._launch_bwd_dq(*args, True)
    dk, dv = va._launch_bwd_dkv(*args, True)
    torch.cuda.synchronize()
    errs = _check_kernels(
        f"family_kernel varlen d={d}", str(dt).split(".")[1],
        {"o": [o], "dq": [dq], "dkv": [dk, dv]},
        {"o": [o_ref], "dq": [dq_ref], "dkv": [dk_ref, dv_ref]}, lse,
        lse_ref)
    return max(errs.values())


def phase_family_kernel(card):
    """Rows 3-5 at the wide heads: timed at FAMILY_ATTN (`_flash_timed`),
    then correctness cases, bf16 and fp32: head dims 136, 192, 200 and
    256 (136 and 200 run at 192 and 256), causal and not; one query row
    against 64 and 1500 keys without causal (GPT-2's cached step) at 64
    and 192; FlashMask and varlen at 192 and 256."""
    import torch
    out = {}
    for d, (b, h, s) in FAMILY_ATTN.items():
        for key, row in _flash_timed(card, "family_kernel", b, h, s,
                                     d).items():
            out[(*key, d)] = row
        gc_cuda()
    cases = {}
    for dname in ("bfloat16", "float32"):
        dt = getattr(torch, dname)
        for d in (136, 192, 200, 256):
            for causal in (False, True):
                cases[f"flash d={d} s=200 causal={causal} {dname}"] = \
                    _family_flash_case(dt, 2, 4, 200, 200, d, causal, d)
        for d in (64, 192):
            for sk in (64, 1500):
                cases[f"flash d={d} sq=1 sk={sk} {dname}"] = \
                    _family_flash_case(dt, 8, 12, 1, sk, d, False, sk + d)
        for d in (192, 256):
            cases[f"flashmask d={d} {dname}"] = \
                _family_flashmask_case(dt, d, d)
            cases[f"varlen d={d} {dname}"] = _family_varlen_case(dt, d, d)
    emit({"phase": "family_kernel", "card": card, "cases": len(cases),
          "max_abs_err": cases})
    return out


def _family_config(name):
    """family_parity's config for `name` (FAMILY_PARITY): the family's
    published widths, depth and vocabulary cut, dropout 0."""
    from paddle_tpu_torch.models import (DeepSeekConfig, GPT2Config,
                                         MoEConfig, Qwen2Config)
    ctor, layers, cut = FAMILY_PARITY[name]
    cfg = {"qwen2_7b": Qwen2Config.qwen2_7b, "gpt2": GPT2Config,
           "moe": MoEConfig, "deepseek": DeepSeekConfig}[ctor]()
    kw = {"num_hidden_layers": layers}
    if cut:
        kw["vocab_size"] = FAMILY_PARITY_VOCAB
    if name == "gpt2":
        kw["dropout"] = 0.0
    return dataclasses.replace(cfg, **kw)


def _family_class(name):
    from paddle_tpu_torch import models as M
    return {"qwen2": M.Qwen2ForCausalLM, "gpt2": M.GPT2LMHeadModel,
            "moe": M.MoEForCausalLM, "deepseek": M.DeepSeekForCausalLM}[name]


def _family_close(name, what, a, c):
    """a (card) against c (CPU): |a - c| <= 1e-3 |c| + 1e-4 max |c|, as
    train_parity holds gradients; returns the worst share of it. Compared
    on the card (a leaf of 1.1 B elements takes seconds on the CPU)."""
    import torch
    a, c = (t.to("cuda", torch.float32) for t in (a, c))
    allowed = (PARITY_GRAD_RTOL * c.abs()
               + PARITY_GRAD_SCALE * float(c.abs().max()) + 1e-30)
    worst = float(((a - c).abs() / allowed).max())
    if worst > 1.0:
        fail(f"family_parity {name}: {what} off, worst {worst} of the "
             "tolerance")
    return worst


def _record_routing():
    """Records each parallel.moe.top_k_gating call's choices until the
    returned function is called, which restores it and returns them: a
    (T, E) int16 tensor a call, a token's slot + 1 at an expert that takes
    it and 0 elsewhere."""
    import torch
    from paddle_tpu_torch.parallel import moe
    orig, calls = moe.top_k_gating, []

    def recorded(*args, **kwargs):
        out = orig(*args, **kwargs)
        d = out[0].detach()
        calls.append(((d.argmax(-1) + 1) * (d.sum(-1) > 0)).to(
            "cpu", torch.int16))
        return out

    moe.top_k_gating = recorded

    def done():
        moe.top_k_gating = orig
        return calls
    return done


def _family_parity_one(card, name):
    """One family on the card and on the CPU from the same weights (drawn
    on the card after paddle.seed(0), copied): the logits of one batch,
    greedy generation (GPT-2's KV-cached decode, or the eager loop), then
    layer_parity's steps (`_layer_steps`) under train_parity's limits;
    rows 3-5 launched as the forwards and steps imply."""
    import copy
    import torch
    cfg = _family_config(name)
    paddle = _paddle("gpu:0")
    paddle.seed(0)
    t0 = time.perf_counter()
    model = _family_class(name)(cfg)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    names = [n for n, _ in model.named_parameters()]
    drawn_zero = [not bool(p._value.any()) for p in model.parameters()]
    # leaves held by their update (FAMILY_UPDATE_RTOL), as drawn
    by_update = {n: p._value.detach().cpu().clone()
                 for (n, p), z in zip(model.named_parameters(), drawn_zero)
                 if z or n.endswith("gate_weight")}
    cpu_model = copy.deepcopy(model).to("cpu")
    batch = _layer_batch(cfg.vocab_size, *FAMILY_PARITY_BATCH, seed=11)
    prompt = batch[0][:, :32]
    res = {}
    for dev, m in (("gpu:0", model), ("cpu", cpu_model)):
        paddle = _paddle(dev)
        _reset_train_counts()
        routes = _record_routing()
        t0 = time.perf_counter()
        try:
            with paddle.no_grad():
                logits = m(paddle.to_tensor(batch[0]))._value.float().cpu()
            # GPT-2's own KV-cached decode, Qwen2's the eager loop (MoE
            # and DeepSeek have no generate, as in JAX)
            gen = m.generate(paddle.to_tensor(prompt),
                             max_new_tokens=FAMILY_GEN_NEW,
                             temperature=0.0).numpy() \
                if name in FAMILY_GENERATE else None
            losses, first, lrs = _layer_steps(paddle, m, batch,
                                              FAMILY_PARITY_STEPS)
        finally:
            routes = routes()
        res[dev] = {"logits": logits, "gen": gen, "losses": losses,
                    "grads": first, "lrs": lrs, "routes": routes,
                    "params": [p._value.detach().cpu()
                               for p in m.parameters()],
                    "launches": _train_counts(),
                    "seconds": time.perf_counter() - t0}
    del model, cpu_model
    gc_cuda()
    gpu, cpu = res["gpu:0"], res["cpu"]
    L, steps = cfg.num_hidden_layers, FAMILY_PARITY_STEPS
    # the logits forward, the generation's forwards (GPT-2: the prefill
    # and one a new token; the eager loop: one a new token), then steps
    gen_fwd = (FAMILY_GEN_NEW + (name == "gpt2")) \
        if name in FAMILY_GENERATE else 0
    want = {k: 0 for k in gpu["launches"]}
    want.update({"flash_fwd": L * (1 + gen_fwd + steps),
                 "flash_bwd_dq": L * steps, "flash_bwd_dkv": L * steps})
    if gpu["launches"] != want:
        fail(f"family_parity {name}: launches {gpu['launches']}, want "
             f"{want}")
    if any(cpu["launches"].values()):
        fail(f"family_parity {name}: the CPU launched a CUDA kernel")
    logit_worst = _family_close(name, "logits", gpu["logits"], cpu["logits"])
    if gpu["gen"] is not None and not (gpu["gen"] == cpu["gen"]).all():
        fail(f"family_parity {name}: greedy tokens differ: "
             f"{gpu['gen'].tolist()} vs {cpu['gen'].tolist()}")
    loss_err = [abs(a - c) for a, c in zip(gpu["losses"], cpu["losses"])]
    if any(e > 1e-5 * abs(c) + 1e-5
           for e, c in zip(loss_err, cpu["losses"])):
        fail(f"family_parity {name}: losses {gpu['losses']} vs "
             f"{cpu['losses']}")
    grad_worst = max(_family_close(name, "step-1 gradients", a, c)
                     for a, c in zip(gpu["grads"], cpu["grads"]))
    # MoE routing: the tokens whose (expert, slot) choices differ between
    # card and CPU, for each top_k_gating call in order (the logits
    # forward, then one a MoE layer a step)
    if len(gpu["routes"]) != len(cpu["routes"]):
        fail(f"family_parity {name}: {len(gpu['routes'])} routing calls on "
             f"the card, {len(cpu['routes'])} on the CPU")
    route_diff = [int((a != c).any(-1).sum())
                  for a, c in zip(gpu["routes"], cpu["routes"])]
    # Each leaf after the steps, as _step_parity holds it: its largest
    # element error within 2.5 lr a step, and its error's norm within
    # 1e-5 of its own norm. The leaves in `by_update` are held instead by
    # what the steps moved them, over the elements whose step-1 gradient
    # lies above the gradient limit's floor (PARITY_GRAD_SCALE of the
    # leaf's largest; below it that limit holds no sign, and AdamW moves
    # an element by about lr whatever its gradient's size):
    # |err| <= FAMILY_UPDATE_RTOL |update|. A leaf drawn at zero (Qwen2's
    # q/k/v biases, GPT-2's biases) is its update alone, so 1e-5 of its
    # norm asks the update for more than its gradients hold (2.0e-3 for
    # Qwen2's k bias over all elements, 1.2e-4 of its update above the
    # floor). A router's `gate_weight` moves about 1% of its norm in two
    # steps, and DeepSeek's update lies 1.3e-3 from the CPU's (1.3e-5 of
    # the leaf) with every routing choice equal on both sides
    # (`routing_tokens_differ`). (on the card, a leaf at a time)
    p_err, rel, upd = 0.0, {}, {}
    for n, a, c, g in zip(names, gpu["params"], cpu["params"], cpu["grads"]):
        a, c, g = (t.to("cuda", torch.float32) for t in (a, c, g))
        p_err = max(p_err, float((a - c).abs().max()))
        rel[n] = float((a - c).norm() / c.norm())
        if n in by_update:
            kept = g.abs() >= PARITY_GRAD_SCALE * float(g.abs().max())
            moved = c - by_update[n].to("cuda", torch.float32)
            upd[n] = float((a - c)[kept].norm() / moved[kept].norm())
        del a, c, g
    held = {n: e for n, e in rel.items() if n not in upd}
    worst_leaf = max(held, key=held.get)
    p_rel = held[worst_leaf]
    if p_err > 2.5 * sum(gpu["lrs"]) or p_rel > 1e-5:
        fail(f"family_parity {name}: parameters off by {p_err} (relative "
             f"norm {p_rel}, {worst_leaf})")
    if upd and max(upd.values()) > FAMILY_UPDATE_RTOL:
        fail(f"family_parity {name}: updates off {upd}")
    return {"config": {k: v for k, v in dataclasses.asdict(cfg).items()
                       if not isinstance(v, (dict, list))},
            "batch": list(FAMILY_PARITY_BATCH), "steps": steps,
            "losses_cuda": gpu["losses"], "losses_cpu": cpu["losses"],
            "loss_abs_err": loss_err, "logits_worst_share_of_tol":
            logit_worst, "grad_worst_share_of_tol": grad_worst,
            "param_max_abs_err": p_err, "param_max_rel_norm_err": p_rel,
            "param_worst_leaf": worst_leaf, "update_rel_norm_err": upd,
            "by_update_rel_norm": {n: rel[n] for n in upd},
            "routing_calls": len(route_diff),
            "routing_tokens_differ": route_diff,
            "greedy_tokens": FAMILY_GEN_NEW if gpu["gen"] is not None
            else 0,
            "launches": gpu["launches"], "params_init_s": init_s,
            "cuda_seconds": gpu["seconds"], "cpu_seconds": cpu["seconds"]}


def _family_decode_parity():
    """models.llama_decode at llama3_8b widths (1 layer, vocabulary
    4096, fp32, TF32 off) on llama_spmd.init_params weights, card against
    CPU: the prefill's and one step's logits (train_parity's gradient
    limit) and make_generate's greedy tokens, identical."""
    import numpy as np
    import torch
    from paddle_tpu_torch.models import llama_decode as D
    from paddle_tpu_torch.models import llama_spmd as T
    from paddle_tpu_torch.models.llama import LlamaConfig
    cfg = dataclasses.replace(LlamaConfig.llama3_8b(), num_hidden_layers=1,
                              vocab_size=FAMILY_PARITY_VOCAB)
    cpu_params = T.init_params(cfg, seed=0, dtype=torch.float32,
                               device="cpu")
    ids = torch.from_numpy(np.random.default_rng(12).integers(
        0, cfg.vocab_size, (2, 32)))
    gen = D.make_generate(cfg, 64, FAMILY_GEN_NEW)
    res = {}
    for dev in ("cuda", "cpu"):
        params = _tree_to(cpu_params, dev)
        cache = D.init_cache(cfg, 2, 64, device=dev)
        t0 = time.perf_counter()
        pre, cache = D.forward_with_cache(params, ids.to(dev), cache, 0, cfg)
        step, _ = D.forward_with_cache(params, ids[:, :1].to(dev), cache,
                                       32, cfg)
        toks = gen(params, ids.to(dev)).cpu()
        res[dev] = {"logits": [pre.cpu(), step.cpu()], "tokens": toks,
                    "seconds": time.perf_counter() - t0}
        del params, cache
    gc_cuda()
    worst = max(_family_close("llama_decode", "logits", a, c) for a, c in
                zip(res["cuda"]["logits"], res["cpu"]["logits"]))
    if not torch.equal(res["cuda"]["tokens"], res["cpu"]["tokens"]):
        fail("family_parity llama_decode: greedy tokens differ")
    return {"config": "llama3_8b widths, 1 layer, vocab 4096, fp32, "
                      "prompt 2 x 32, max_len 64",
            "logits_worst_share_of_tol": worst,
            "greedy_tokens": FAMILY_GEN_NEW,
            "cuda_seconds": res["cuda"]["seconds"],
            "cpu_seconds": res["cpu"]["seconds"]}


def phase_family_parity(card):
    """Each decoder family (FAMILY_PARITY) and llama_decode, card against
    CPU, fp32, TF32 off (`_family_parity_one`, `_family_decode_parity`)."""
    import torch
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    out = {}
    for name in FAMILY_PARITY:
        out[name] = _family_parity_one(card, name)
        emit({"phase": "family_parity", "card": card, "family": name,
              **out[name]})
    out["llama_decode"] = _family_decode_parity()
    emit({"phase": "family_parity", "card": card, "family": "llama_decode",
          **out["llama_decode"]})
    return out


def phase_family_run(card):
    """(a) DeepSeek at DeepSeekConfig() widths, FAMILY_RUN_LAYERS layers,
    bf16 (FAMILY_RUN_CONFIG), FAMILY_RUN_STEPS steps as layer_train takes
    them: the loss must fall and rows 3-5 launch once a layer a step at
    D = 192; median step (2-6), tokens/s, peak memory. (b) GPT-2 small
    (GPT2Config(), 12 layers, bf16) generating FAMILY_GPT2_NEW greedy
    tokens for 8 prompts of 64 through its KV-cached decode: output
    tokens/s and fa_fwd's launches (the prefill's and one query row a
    layer a step)."""
    import statistics as st
    import numpy as np
    import torch
    from paddle_tpu_torch.models import (DeepSeekConfig, DeepSeekForCausalLM,
                                         GPT2Config, GPT2LMHeadModel)
    gc_cuda()
    torch.cuda.reset_peak_memory_stats()
    cfg = dataclasses.replace(DeepSeekConfig(),
                              num_hidden_layers=FAMILY_RUN_LAYERS)
    paddle = _paddle("gpu:0")
    paddle.seed(0)
    t0 = time.perf_counter()
    model = DeepSeekForCausalLM(cfg).bfloat16()
    n_params = sum(p._value.numel() for p in model.parameters())
    opt = paddle.optimizer.AdamW(
        3e-4, parameters=model.parameters(), multi_precision=True,
        grad_clip=paddle.nn.ClipGradByGlobalNorm(1.0))
    ids, labels = (paddle.to_tensor(a) for a in
                   _layer_batch(cfg.vocab_size, 2, 2048, seed=13))
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    _reset_train_counts()
    losses, times = [], []
    for _ in range(FAMILY_RUN_STEPS):
        t0 = time.perf_counter()
        loss, _ = model(ids, labels=labels)
        loss.backward()
        opt.step()
        opt.clear_grad()
        losses.append(float(loss))
        times.append(time.perf_counter() - t0)
    launches = _train_counts()
    peak = torch.cuda.max_memory_allocated() / 1e9
    del model, opt, ids, labels, loss
    gc_cuda()
    L, n = FAMILY_RUN_LAYERS, FAMILY_RUN_STEPS
    want = {k: 0 for k in launches}
    want.update({"flash_fwd": L * n, "flash_bwd_dq": L * n,
                 "flash_bwd_dkv": L * n})
    if launches != want:
        fail(f"family_run deepseek: launches {launches}, want {want}")
    if not (all(math.isfinite(x) for x in losses)
            and losses[-1] < losses[0]):
        fail(f"family_run deepseek: losses {losses}")
    step_s = st.median(times[1:])
    ds = {"phase": "family_run", "card": card, "model": "deepseek",
          "config": FAMILY_RUN_CONFIG, "params": n_params,
          "head_dim": cfg.qk_nope_head_dim + cfg.qk_rope_head_dim,
          "losses": losses, "step_seconds": times,
          "median_step_ms": step_s * 1e3,
          "tokens_per_s": 2 * 2048 / step_s, "peak_gb": peak,
          "params_init_s": init_s, "launches": launches}
    emit(ds)

    gcfg = GPT2Config()
    paddle.seed(1)
    model = GPT2LMHeadModel(gcfg).bfloat16()
    model.eval()
    b, plen = FAMILY_GPT2_PROMPTS
    prompt = paddle.to_tensor(np.random.default_rng(14).integers(
        0, gcfg.vocab_size, (b, plen)))
    model.generate(prompt, max_new_tokens=2, temperature=0.0)   # warm-up
    _reset_train_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = model.generate(prompt, max_new_tokens=FAMILY_GPT2_NEW,
                         temperature=0.0)
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    gl = _train_counts()
    del model
    gc_cuda()
    nl = gcfg.num_hidden_layers
    if out.shape != [b, plen + FAMILY_GPT2_NEW] or \
            gl["flash_fwd"] != nl * (1 + FAMILY_GPT2_NEW) or \
            gl["flash_bwd_dq"] or gl["flash_bwd_dkv"]:
        fail(f"family_run gpt2: output {out.shape}, launches {gl}")
    gpt = {"phase": "family_run", "card": card, "model": "gpt2",
           "config": "GPT2Config() (12 layers, 768 wide, 12 heads of 64, "
                     "vocabulary 50257), bf16, random weights (seed 1), "
                     f"{b} prompts of {plen}, {FAMILY_GPT2_NEW} greedy "
                     "tokens, KV-cached generate",
           "seconds": secs, "output_tokens_per_s":
           b * FAMILY_GPT2_NEW / secs, "launches": gl,
           "fa_fwd_sq1_launches": nl * FAMILY_GPT2_NEW,
           "fa_fwd_prefill_launches": nl}
    emit(gpt)
    return {"deepseek": ds, "gpt2": gpt}


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--phases", default=",".join(PHASES),
                    help="comma-separated subset of " + ",".join(PHASES))
    args = ap.parse_args(argv)
    phases = args.phases.split(",")
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs only on the "
              "card", file=sys.stderr)
        return 2
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    import paddle_tpu_torch  # noqa: F401  (fails outside a checkout)

    secs = {}                # wall seconds of each phase run

    def timed(phase, fn, *args):
        t0 = time.perf_counter()
        out = fn(*args)
        secs[phase] = time.perf_counter() - t0
        # as each phase ends, so that a run cut short still tells them
        print(f"chip_smoke: {phase} {secs[phase]:.1f} s", file=sys.stderr,
              flush=True)
        return out

    smi, name = timed("device", phase_device)
    if "build" in phases:
        timed("build", phase_build, smi)
    kern = timed("kernel", phase_kernel, smi) if "kernel" in phases else {}
    if "parity" in phases:
        timed("parity", phase_parity, smi)
    serve, bserve, sserve, pserve, rserve, fserve = {}, {}, {}, {}, {}, {}
    if {"serve", "bucket_serve", "spec_serve", "prefix_serve",
            "runtime", "fleet", "tp_serve"} & set(phases):
        # the 8B parameters, built once for the six serve phases
        t0 = time.perf_counter()
        cfg, params = serve_params()
        torch.cuda.synchronize()
        init_s = time.perf_counter() - t0
        if {"serve", "tp_serve"} & set(phases):
            # tp_serve's yardstick is the ragged engine's logits
            serve = timed("serve", phase_serve, smi, cfg, params, init_s)
        if {"bucket_serve", "tp_serve"} & set(phases):
            # tp_serve holds its streams to bucket_serve's
            bserve = timed("bucket_serve", phase_bucket_serve, smi, cfg,
                           params, init_s)
        if "spec_serve" in phases:
            sserve = timed("spec_serve", phase_spec_serve, smi, cfg, params,
                           init_s, bserve)
        if "prefix_serve" in phases:
            pserve = timed("prefix_serve", phase_prefix_serve, smi, cfg,
                           params)
        if "runtime" in phases:
            rserve = timed("runtime", phase_runtime, smi, cfg, params)
        if "fleet" in phases:
            fserve = timed("fleet", phase_fleet, smi, cfg, params)
        del params
        gc_cuda()
        # nothing of the serve phases may outlive them: the parallel and
        # tp ranks share the card with this process
        held_gb = torch.cuda.memory_allocated() / 1e9
        emit({"phase": "serve_block", "card": smi,
              "memory_allocated_gb_after": held_gb})
        if held_gb > 1.0:
            fail(f"the serve phases left {held_gb:.2f} GB allocated on the "
                 f"card: {_engines_alive()}")
    tk = timed("train_kernel", phase_train_kernel, smi) \
        if "train_kernel" in phases else {}
    if "train_parity" in phases:
        timed("train_parity", phase_train_parity, smi)
    train = timed("train", phase_train, smi) if "train" in phases else {}
    mk = timed("mask_kernel", phase_mask_kernel, smi) \
        if "mask_kernel" in phases else {}
    if "packed_parity" in phases:
        timed("packed_parity", phase_packed_parity, smi)
    packed = timed("train_packed", phase_train_packed, smi) \
        if "train_packed" in phases else {}
    bk = timed("bucket_kernel", phase_bucket_kernel, smi) \
        if "bucket_kernel" in phases else {}
    if "bucket_parity" in phases:
        timed("bucket_parity", phase_bucket_parity, smi)
    sk = timed("spec_kernel", phase_spec_kernel, smi) \
        if "spec_kernel" in phases else {}
    if "spec_parity" in phases:
        timed("spec_parity", phase_spec_parity, smi)
    pk = timed("prefix_kernel", phase_prefix_kernel, smi) \
        if "prefix_kernel" in phases else {}
    if "prefix_parity" in phases:
        timed("prefix_parity", phase_prefix_parity, smi)
    vk = timed("varlen_kernel", phase_varlen_kernel, smi) \
        if "varlen_kernel" in phases else {}
    if "fused_parity" in phases:
        timed("fused_parity", phase_fused_parity, smi)
    if "train_fused" in phases:
        timed("train_fused", phase_train_fused, smi, packed)
    par_parity, par, tpp, tps = {}, {}, {}, {}
    spawned = None
    if {"parallel_parity", "parallel", "tp_parity", "tp_serve",
            "layer_parallel_parity", "layer_parallel"} & set(phases):
        # each world size spawned once for the layouts of the parallel
        # phases; the tp phases run in the world of 2
        spawned = timed("parallel_spawn", _spawn_parallel, phases, bserve)
        if "parallel_parity" in phases:
            par_parity = timed("parallel_parity", phase_parallel_parity,
                               smi, spawned)
        if "parallel" in phases:
            par = timed("parallel", phase_parallel, smi, spawned)
        if "tp_parity" in phases:
            tpp = timed("tp_parity", phase_tp_parity, smi, spawned)
        if "tp_serve" in phases:
            tps = timed("tp_serve", phase_tp_serve, smi, spawned, bserve,
                        serve)
    lpar = timed("layer_parity", phase_layer_parity, smi) \
        if "layer_parity" in phases else {}
    ltrain = timed("layer_train", phase_layer_train, smi, train) \
        if "layer_train" in phases else {}
    # the layer phases ran in the parallel phases' world of 2; their rows
    # come after layer_train's, which layer_parallel reports beside its own
    lpp = timed("layer_parallel_parity", phase_layer_parallel_parity, smi,
                spawned) if "layer_parallel_parity" in phases else {}
    lparallel = timed("layer_parallel", phase_layer_parallel, smi, spawned,
                      ltrain, par) if "layer_parallel" in phases else {}
    fk = timed("family_kernel", phase_family_kernel, smi) \
        if "family_kernel" in phases else {}
    fpar = timed("family_parity", phase_family_parity, smi) \
        if "family_parity" in phases else {}
    frun = timed("family_run", phase_family_run, smi) \
        if "family_run" in phases else {}
    emit({"phase_seconds": secs})
    # launches the prefix_serve runs added, by kernel (the returning turns
    # of the multi-turn runs, the whole system-prompt runs)
    prefix_counts = {}
    for row in pserve.values():
        for k, n in row["launches"].items():
            prefix_counts[k] = prefix_counts.get(k, 0) + n
    kernels = []
    for kname, pools, run in (("ragged_paged_attention", "bfloat16", "bf16"),
                              ("ragged_paged_attention_int8", "int8",
                               "int8")):
        k = kern.get(pools)
        if k is None:
            continue
        kernels.append({
            "name": kname, "route": "cuda",
            "source": "paddle_tpu_torch/csrc/ragged_paged_attention.cu",
            "replaces": TPU_KERNEL,
            "launches": serve[run]["launches"] if run in serve else None,
            "max_abs_err": k["max_abs_err"], "ms": k["kernel_ms"],
            "plain_ms": k["plain_ms"], "bound_ms": k["bound_ms"],
            "bound_by": k["bound_by"], "library_ms": k["library_ms"],
            "design": k["design"], "library_factor": k["library_factor"]})
    for kname in FLASH_KERNELS:
        k = tk.get((kname, "bfloat16"))
        if k is None:
            continue
        kernels.append({
            "name": kname, "route": "cuda",
            "source": "paddle_tpu_torch/csrc/flash_attention.cu",
            "replaces": FLASH_TPU_KERNELS[kname],
            "launches": train["launches"][kname] if train else None,
            "max_abs_err": k["max_abs_err"], "ms": k["kernel_ms"],
            "plain_ms": k["plain_ms"], "bound_ms": k["bound_ms"],
            "bound_by": k["bound_by"], "library_ms": k["library_ms"]})
    for kname in FLASH_KERNELS:
        # rows 3-5 at DeepSeek's head dim: launched by family_run's
        # DeepSeek (D = 192 is all its attention runs)
        k = fk.get((kname, "bfloat16", 192))
        if k is None:
            continue
        kernels.append({
            "name": f"{kname}_d192", "route": "cuda",
            "source": "paddle_tpu_torch/csrc/flash_attention.cu",
            "replaces": FLASH_TPU_KERNELS[kname],
            "launches": frun["deepseek"]["launches"][kname] if frun
            else None,
            "max_abs_err": k["max_abs_err"], "ms": k["kernel_ms"],
            "plain_ms": k["plain_ms"], "bound_ms": k["bound_ms"],
            "bound_by": k["bound_by"], "library_ms": k["library_ms"],
            "design": k["design"], "library_factor": k["library_factor"],
            "ptxas": k["ptxas"]})
    for kname in FLASHMASK_KERNELS:
        k = mk.get((kname, "bfloat16"))
        if k is None:
            continue
        kernels.append({
            "name": kname, "route": "cuda",
            "source": "paddle_tpu_torch/csrc/flashmask_attention.cu",
            "replaces": FLASHMASK_TPU_KERNELS[kname],
            "launches": packed["launches"][kname] if packed else None,
            "max_abs_err": k["max_abs_err"], "ms": k["kernel_ms"],
            "plain_ms": k["plain_ms"], "bound_ms": k["bound_ms"],
            "bound_by": k["bound_by"], "library_ms": k["library_ms"]})
    for kname, (src, tpu, row, run) in BUCKET_KERNELS.items():
        k = bk.get(row)
        if k is None:
            continue
        kernels.append({
            "name": kname, "route": "cuda",
            "source": f"paddle_tpu_torch/csrc/{src}.cu", "replaces": tpu,
            "launches": bserve[run]["launches"][kname] if run in bserve
            else None,
            "max_abs_err": k["max_abs_err"], "ms": k["kernel_ms"],
            "plain_ms": k["plain_ms"], "bound_ms": k["bound_ms"],
            "bound_by": k["bound_by"], "library_ms": k["library_ms"],
            "design": k["design"], "library_factor": k["library_factor"]})
    for kname, (tpu, row, run) in SPEC_KERNELS.items():
        k = sk.get(row)
        if k is None:
            continue
        kernels.append({
            "name": kname, "route": "cuda",
            "source": "paddle_tpu_torch/csrc/paged_attention.cu",
            "replaces": tpu,
            "launches": sserve[run]["launches"][kname] if run in sserve
            else None,
            "max_abs_err": k["max_abs_err"], "ms": k["kernel_ms"],
            "plain_ms": k["plain_ms"], "bound_ms": k["bound_ms"],
            "bound_by": k["bound_by"], "library_ms": k["library_ms"],
            "design": k["design"], "library_factor": k["library_factor"]})
    for kname in VARLEN_BWD_KERNELS:
        k = vk.get((kname, "bfloat16"))
        if k is None:
            continue
        kernels.append({
            "name": kname, "route": "cuda",
            "source": "paddle_tpu_torch/csrc/varlen_attention.cu",
            "replaces": VARLEN_BWD_TPU_KERNELS[kname],
            "launches": vk["launches"][kname],
            "max_abs_err": k["max_abs_err"], "ms": k["kernel_ms"],
            "plain_ms": k["plain_ms"], "bound_ms": k["bound_ms"],
            "bound_by": k["bound_by"], "library_ms": k["library_ms"]})
    runtime_counts = rserve.get("launches", {})
    fleet_counts = fserve.get("launches", {})
    for row in kernels:
        # None for the rows prefix_serve does not run (training, and
        # the ragged kernel over int8 pages: its ragged runs are bf16)
        row["prefix_launches"] = prefix_counts.get(row["name"])
        # the launches of the runtime phase's served runs; None for the
        # kernels it does not run (its pools are bf16)
        row["runtime_launches"] = runtime_counts.get(row["name"])
        # the launches of the fleet phase's in-process workers ((a) and
        # (c)); None for the kernels the fleet does not run
        row["fleet_launches"] = fleet_counts.get(row["name"])
        # each rank's launches in each layout of the parallel phases
        # (rows 3-8; None for the others)
        if row["name"] in _train_counts() and (par_parity or par):
            row["parallel_launches"] = {
                f"{phase} {name}": [r[row["name"]] for r in
                                    prow["launches_per_rank"]]
                for phase, rows in (("parallel_parity", par_parity),
                                    ("parallel", par))
                for name, prow in rows.items()}
        else:
            row["parallel_launches"] = None
        # each rank's launches in each run of the tp phases (rows 3, 9,
        # 12-14q; None for the others)
        if row["name"] in TP_KERNELS and (tpp or tps):
            row["tp_launches"] = {
                f"{phase} {pool}": [r[row["name"]] for r in
                                    prow["launches_per_rank"]]
                for phase, rows in (("tp_parity", tpp), ("tp_serve", tps))
                for pool, prow in rows.items()}
        else:
            row["tp_launches"] = None
        # the Layer-tree Llama's launches: layer_train's run for rows
        # 3-5, the entry points' calls of layer_parity for rows 6-11
        # (None for the others)
        # the decoder families' launches of rows 3-5: each
        # family_parity model (the card side: its logits forward,
        # generation and steps) and family_run's two runs; on the D = 192
        # rows DeepSeek's alone (the others run 64 and 128)
        kn, d192 = row["name"].removesuffix("_d192"), \
            row["name"].endswith("_d192")
        if kn in FLASH_KERNELS and (fpar or frun):
            row["family_launches"] = {
                **{f"family_parity {n}": r["launches"][kn]
                   for n, r in fpar.items() if "launches" in r
                   and (n == "deepseek" or not d192)},
                **{f"family_run {n}": r["launches"][kn]
                   for n, r in frun.items()
                   if n == "deepseek" or not d192}}
        else:
            row["family_launches"] = None
        row["layer_launches"] = ltrain.get("launches", {}).get(
            row["name"]) if row["name"] in FLASH_KERNELS else \
            lpar.get("entry_points", {}).get("launches", {}).get(
                row["name"])
        # each rank's launches of rows 3-5 under the Trainer: every
        # layout of layer_parallel_parity and layer_parallel's tp 2 run
        # (None for the other rows)
        if row["name"] in FLASH_KERNELS and (lpp or lparallel):
            row["layer_parallel_launches"] = {
                f"layer_parallel_parity {name}": [
                    r[row["name"]] for r in prow["launches_per_rank"]]
                for name, prow in lpp.items() if name in LAYER_PAR_LAYOUTS}
            if lparallel:
                row["layer_parallel_launches"]["layer_parallel"] = [
                    r[row["name"]] for r in lparallel["launches_per_rank"]]
        else:
            row["layer_parallel_launches"] = None
        for (kname, variant, shape), k in pk.items():
            if kname == row["name"] and variant in ("bfloat16", "int8"):
                row.setdefault("prefix_kernel", {})[str(shape)] = {
                    "ms": k["kernel_ms"], "max_abs_err": k["max_abs_err"],
                    "bound_ms": k["bound_ms"], "plain_ms": k["plain_ms"],
                    "library_ms": k["library_ms"]}
    emit({"kernels": kernels})
    print(smi, flush=True)
    emit({"ok": True, "device": {"platform": "gpu", "kind": name,
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
