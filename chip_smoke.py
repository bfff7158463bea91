#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (``src/repro_torch``) on one CUDA card.

    python3 chip_smoke.py                 # full qwen3_4b, no arguments

Phases (each raises on failure; the script then exits non-zero and
prints no result line):

  1. build every CUDA kernel of the serving path from ``csrc/`` (nvcc,
     one process per source, started together);
  2. serve requests through ``PagedServingEngine`` — fused K-step decode
     over the two-tier HBM -> host ``TierStore`` with memos on — at the
     full published width of qwen3_4b in bfloat16, with random weights
     drawn on the card from a seed.  The HBM pool is smaller than the
     batch's demand, so preemption, demotion, promotion and slow-tier
     wear all happen; the kernel launch counts are read around this run
     (in this and every serving run ``qkv_rope_append``, the qk-norm,
     RoPE and KV append of a layer, must launch exactly once per layer
     per decode inner step and per prefill dispatch);
  3. the same requests served over ``MemoryHierarchy.two_tier(64, 512,
     pinned_slow=True)``: the NVM tier is pinned host memory the card
     reads and writes in place (dual-pool decode, in-dispatch wear and
     Start-Gap), with the fault injector flipping and sticking bits in
     it at a fixed seed.  Every completed request must emit exactly the
     phase-2 tokens, every failed one an exact prefix of them (0
     corrupted tokens), faults must be injected and quarantined, and the
     dual-pool attention, wear, checksum and pass-sweep kernels must
     launch; the launch counts are read around this run;
  4. fused dispatch vs the K=1 reference path at the same width, memos
     off: the generated tokens, SysMon counters and page versions must
     be identical — once over the host tier, once with tail pages in the
     pinned tier, where the pinned pool's bytes, the wear remap and the
     Start-Gap state must match too;
  5. the pinned parity requests again with the fault injector armed, so
     appends into the pinned tier, their checksum refresh, the
     in-dispatch wear charge and Start-Gap run under page integrity:
     with zero rates nothing is quarantined and every token matches
     phase 4's; under a media storm no token differs and faults are
     injected and caught;
  6. what padding the decode to ``max_batch`` rows costs (one dispatch
     of 2 rows padded to 8 vs unpadded) and which dense op of the step
     gives other bits for another number of rows; then whether a row's
     decode bits depend on the row count (``batch_invariance``): where
     they do, the step's ops are logged to name the first that gives
     other bits on equal inputs, and the phase fails if that is K1 or K1d;
  7. two fused dispatches under ``torch.profiler``, on the phase-2 path
     and, once pages sit in the pinned tier, on the phase-3 path: the
     device's busy share of the wall time and the device operations per
     inner step, also with ``qkv_rope_append`` replaced by the parent
     tree's eager ops (``parent_ops``); no qk-norm or RoPE op may run
     outside the kernel;
  8. a small float32 model stepped on the card and on the CPU (the plain
     kernel versions): logits within 1e-3 and identical integer state;
 10. ``prefill``: the phase-2 requests with ``prefill=True``: every
     prefill dispatch launches K1's prefill body and qkv_rope_append once
     per layer over the bucket's rows (K1's decode body only in the
     decode); the tokens that differ from phase 2 (prompt
     replay) are reported; a probe of 2 prompts, each on fresh engines,
     holds one prefill dispatch against K=1 replay: a first token may
     differ only on a near tie; on float32 weights the KV pages and
     first-token logits agree within 1e-4 and the same prefill with TF32
     matmuls must not; in bf16 their maximum errors stay within 0.2;
 11. ``prefill_pinned``: the same over the pinned-host tier, and again
     with HBM cut to 8 slots, where prompt pages land in the pinned tier
     and K1d's prefill body and qkv_rope_append must run inside the prefill
     dispatches, K1d's decode body in the decode;
 12. ``int8_host``: the same over an int8 numpy host tier: K6 quantizes
     every demotion on the card, ``dequant_gather`` every promotion;
 13. ``int8_pinned``: over an int8 pinned-host tier with page integrity
     armed (no faults): 0 tokens may differ from phase 12, and the NVM
     int8 bytes and scales must match phase 12's at every logical slot;
 14. ``longctx_zamba2``: dense-cache generation (``launch.longctx_decode.
     generate``: ``prefill`` then greedy ``decode_step``) at the full
     width and depth of zamba2_7b in bf16: 4 prompts of 2000 tokens, 32
     new tokens each; the prefill launches K9 ``ssd_scan`` exactly once
     per Mamba layer (81) and K8 ``flash_attention`` once per
     shared-attention site (11), the decode launches no kernel;
 15. ``longctx_mamba2``: the same for mamba2_1_3b (48 K9, no K8);
 16. ``longctx_probe_f32``: on float32 weights (zamba2 cut to 14 layers,
     mamba2 at full depth) every decode step's logits agree with a fresh
     prefill's over the same tokens within 1e-3, the argmax too unless
     near a tie; the same probe on the full-depth bf16 models
     (``longctx_probe_bf16``) within 0.5, flips only under a 0.1 margin;
     both localize the difference per Mamba layer (output and SSM state
     after one decode step vs a fresh prefill);
 17. ``longctx_card_vs_cpu``: smoke-width mamba2 and zamba2 in float32,
     a 37-token prompt and 5 decode steps on the card and on the CPU:
     logits and states within 1e-4, identical tokens;
 18. ``longctx_mamba2_f32`` and ``longctx_zamba2_f32``: phases 15 and 14
     on float32 weights (the JAX package's default type) at full width
     and depth: the prefill launches K9's float32 entry once per Mamba
     layer (48; 81) and K8's float32 entry once per shared site (0; 11),
     the decode none;
 19. ``overlap``: phase 2's requests with ``overlap_plan=True`` (the
     memos plan on the ``memos-plan`` worker thread, overlapped with the
     next dispatch, committed page by page at the following boundary),
     over the pinned-host tier beside one synchronous run of that tier,
     and over the numpy host tier beside phase 2's own run, no faults
     (three runs, about 45 s on the card): every run's tokens
     equal phase 2's, the overlapped runs commit passes asynchronously
     and commit planned pages, ``memos.plan`` spans run on the worker
     thread; reported: the plan's wall ms, the share of it hidden under
     the dispatch, and ``serve.dispatch`` seconds with and without the
     overlap;
 20. ``overlap_plan_faults``: the pinned overlapped run with page
     integrity armed and plan faults injected in turn — worker
     exceptions until one falls back, then plan delays of 3 s against a
     0.25 s watchdog until one times out, then none: both fallbacks
     (``InjectedPlanFault``, ``timeout``) must run synchronous passes,
     the ladder must drop to ``sync`` and climb back to ``overlap``, and
     0 tokens may differ from phase 2's;
 21. ``qos_overload``: the committed ``benchmarks/traces/
     mixed_overload.jsonl`` (69 requests, tenants lc/std/bat) replayed
     on the engine's step clock at full qwen3_4b width in bf16 over
     ``two_tier(12, 96, pinned_slow=True)`` (page 8, batch 4, K = 4,
     memos every 8 steps, 8 pages a sequence, prefill on, synchronous
     memos), once through a QoS-aware engine (tenant classes from
     ``tenant_for_class``) and once through a blind one (``qos=None``):
     every request completes, each request's tokens are the same in both
     runs, lc's step-clock TTFT p99 (first-token step - arrival) aware
     <= blind, and K1, ``qkv_rope_append``, K2, K3 and K7 launch;
     reported per tenant: TTFT p50/p99 on both clocks, mean inter-token
     latency, e2e p99, SLO attainment, and preemptions, admissions and
     tokens/s of each run;
 22. ``qos_power``: ``steady_power.jsonl`` (40 requests) with a bare
     ``QoSConfig()``, then with a budget of half that run's peak
     modelled NVM dynamic power (``MemosReport.power_mw``, the energy
     model's, not the card's): no governor and a peak > 0 in the free
     run; over-budget passes and throttling in the capped one, some
     admission while throttled and none past ``max_batch - throttle``
     rows (the governor's width read at each ``admit`` call, not the
     engine's argument), every request served;
 23. ``serve_cli``: ``repro_torch.launch.serve.main`` in this
     process, with ``["--device", "cuda"]`` (smoke width) and with
     ``--no-smoke`` added (qwen3_4b at published width and depth, in
     float32): in each, the printed served count equals ``--requests``
     (6), the migrations are > 0 and the engine's kernels launch;
 24. ``moe_engine``: olmoe_1b_7b (16 layers, 64 experts, top 8) at
     published width and depth in bf16, phase 2's serve config, 8
     requests of 128 + 32 tokens, through the K=1 reference path and the
     fused dispatch over the host tier, the fused dispatch over the
     pinned tier, and prefill: fused = reference = pinned tokens and
     expert counts, every run's counts summing to Σ(prompt + new - 1) x
     top_k x n_layers, and ``moe_ffn`` launched twice per layer per
     decode inner step and per prefill dispatch; the busy share of two
     profiled fused dispatches; olmoe's case of ``batch_invariance`` (a
     request alone and in a batch of 8: the same bits);
 25. ``prefill_invariance`` gains ``moe_ffn`` alone at olmoe's widths,
     bf16 and float32: a row's bits alone, in 128 rows and in 2048;
 26. ``longctx_mixtral``: ``generate`` with mixtral_8x7b at full width
     cut to 8 of 32 layers in bf16, a 4160-token prompt and 64 greedy
     tokens, so the 4096-slot window ring wraps in both halves: the
     prefill launches K8 once and ``moe_ffn`` twice per layer, the decode
     ``moe_ffn`` twice per layer per token, and the K/V state is the
     ring's; ``longctx_mixtral_probe_bf16`` and ``_f32`` (2 layers, a
     4092-token prompt, 8 steps across position 4096) hold each decode
     step against a fresh prefill at phase 16's gates;
 27. ``longctx_card_vs_cpu`` gains smoke mixtral in float32 with float
     and with int8 caches;
 28. ``dense_archs``: phi3_mini_3_8b, qwen2_5_14b and gemma3_4b at
     published width and depth in bf16, 4 requests of 64 + 16 tokens:
     fused = reference tokens; K1's bodies and ``qkv_rope_append`` vs
     plain at G 1 and D 96 (phi3), G 5 (qwen2.5) and D 256 (gemma3);
 29. ``moe_ffn``'s kernel rows (olmoe's decode and 256-row prefill
     bucket and mixtral's prefill and decode in bf16, olmoe's decode and
     the mixtral probe's prefill in float32) beside ``torch._grouped_mm``,
     each with its launch plan and the tensor-core instructions in its
     SASS (``sass_hgmma`` of the bf16 ``wgmma`` kernels, ``sass_hmma`` of
     the float32 3xTF32 ones; 0 fails);
 30. ``longctx_gemma3``: ``generate`` with gemma3_4b whole (34 layers,
     d 2560, 8/4 heads at D 256) in bf16, 4 prompts of 2000 + 32 tokens:
     the 29 local layers' 1024-slot rings wrap; the prefill launches K8
     (its D-256 kernel) once per layer (34: 29 windowed, 5 causal), the
     decode no kernel;
 31. ``longctx_musicgen``: musicgen_medium whole (48 layers, d 1536,
     24/24 heads at D 64, GELU FFN) on seeded embeddings, 4 x 2000 + 32
     teacher-forced steps (the greedy codes recorded): K8 48 in the
     prefill, none in the decode;
 32. ``longctx_qwen2_vl``: qwen2_vl_72b at full width (d 8192, 64/8 heads,
     d_ff 29568, QKV bias, text-only M-RoPE) cut to 8 of 80 layers (the
     cut in the line), the same embeddings run: K8 8, decode none;
 33. ``longctx_probe_f32_s15``: the three in float32 at full width cut to
     6 / 4 / 2 layers, a 1100-token prompt, 4 steps each against a fresh
     prefill within 1e-3 (flips only under 1e-2); ``longctx_card_vs_cpu``
     gains smoke gemma3 at D 256, musicgen and qwen2_vl (1e-4, identical
     tokens); and K8's rows at D 256 (gemma3's causal and window shapes,
     bf16 and float32, ``sass_hgmma`` of the D-256 kernels; the bf16 rows
     with the persistent kernel's launch ``plan`` and ``stream_device_ms``,
     the time the earlier design's tiles take to stream with no math, one
     CTA reading them and two CTAs of a cluster sharing them, from
     ``tools/flash_d256_probe.py``) and at D 64 (musicgen's,
     bf16);
 34. (phases 34-37 run first, right after the build, while the card is
     empty) ``train_qwen3``: single-device training (``launch.train.
     make_train_step``, driven as ``train_loop`` drives it: seeded float32
     weights drawn on the card, ``SyntheticLM`` at seq 512, global batch
     8 in 2 microbatches, AdamW, a cosine schedule warming up over 10
     steps to 1e-3, TF32 off) of qwen3_4b at published width (d 2560,
     32/8 heads, D 128, ff 9728, vocab 151936) cut to 24 of 36 layers
     (float32 AdamW state for all 36, 70.6 GB, leaves no room for the
     activations), 20 steps: every loss and grad norm finite, the mean of
     the last 5 losses below the first 5's, the params equal after step 1
     (its lr is 0, as in the JAX schedule) and changed after step 2;
     reported: the median step ms, tokens/s, the peak of
     ``torch.cuda.max_memory_allocated`` and the optimizer's share of a
     step (``adamw.update`` alone on the trained state, CUDA events);
 35. ``train_mamba2`` (mamba2_1_3b whole, 48 layers) and ``train_zamba2``
     (zamba2_7b at d 3584 cut to 14 of 81 layers, its two shared sites),
     10 steps each: losses finite, grad norms > 0, params changed;
     ``train_olmoe`` (olmoe_1b_7b at published width, d 2048, 16/16, 64
     experts top 8 of ff 1024, vocab 50304; 8 of 16 layers), 20 steps
     with ``train_qwen3``'s gates, ``moe_aux`` finite and > 0, each
     microbatch's ``expert_counts`` summing to tokens x 8 x layers, and
     exactly 4 x layers x microbatches ``moe_ffn`` launches a step (the
     forward and remat's recompute) and as many ``moe_ffn_bwd``, then one
     step under the profiler for their device ms;
 36. ``train_card_vs_cpu``: smoke qwen3_4b, gemma3_4b, mamba2_1_3b,
     zamba2_7b, olmoe_1b_7b and mixtral_8x7b, five ``make_train_step``
     steps on the card and on the CPU from the same params and batches:
     every loss within 1e-4 relative, m and v after step 5 within 1e-4
     of each leaf's largest, the params within rtol 1e-4 / atol 1e-5 but
     for at most one entry in 10**4 (AdamW's m / (sqrt(v) + 1e-8) turns
     an entry's rounding relative to itself into its update, so entries
     far below their leaf's largest gradient drift), every entry within
     twice the summed lr; for MoE the expert counts equal at every step,
     m and v within 1e-4 of each leaf's largest after every step taken
     by both from the card's state before it (over the five steps apart,
     one olmoe embedding entry whose gradient lies under AdamW's eps
     moves its first update ~3.5e-4 apart, and the moments follow; that
     trajectory's number is reported beside), and two backward passes on
     the card from one state equal bit for bit;
 37. ``train_resume``: smoke phi3 on the card through ``train_loop``:
     20 straight steps against 10 steps, a checkpoint and a resume to
     20: losses, params and moments equal bit for bit; ``crash_at=12``
     with ``ckpt_every=5`` raises and the rerun resumes at step 10;
     ``train_moe_tiered``: ``launch.train_moe_tiered`` at its defaults
     (smoke olmoe, 200 steps, a crash at 100, the restart from its
     checkpoint) ends below loss 5.0.  Each phase's kernel launches are
     checked: none for the dense, Mamba and hybrid archs (the plain
     attention and SSD scan), exactly ``moe_ffn``'s and ``moe_ffn_bwd``'s
     for MoE; then ``moe_ffn_bwd``'s rows in the kernels line (olmoe's
     training shape and a sparse 64 rows over 64 experts, every output
     within 1e-5 of its largest plain magnitude, empty experts' dW
     exactly zero, ``sass_hmma`` > 0);
 38. ``sharded_train`` (after phase 37): one step of the multi-device
     train step (``make_train_step(cfg, mi)``: DTensor parameters by
     ``param_specs``, ZeRO moments, MoE on ``moe_apply``'s expert-
     parallel branch) at full olmoe_1b_7b and qwen3_4b width, 2 layers,
     on a (1, 1) ``("data", "model")`` mesh over NCCL (gloo's functional
     all-gather crashed on CUDA tensors, and NCCL takes one rank a card),
     held against the unsharded step on the same card: loss within 1e-5,
     params within 2e-5 where |g| >= 1e-6, equal expert counts, the MoE
     step's launches exactly ``moe_ffn``'s and ``moe_ffn_bwd``'s; step
     ms, peak GB and ``CommDebugMode``'s collective counts reported;
 39. ``moe_shards``: the expert- and tensor-parallel shard bodies up to
     their ``psum`` (``ep_shard_partial``, ``tp_shard_partial``) for each
     shard in turn: olmoe_1b_7b at full width, 4096 tokens, 64 experts
     over 4 shards at capacity 1.25 (an overflowing shard drops rows)
     and 8.0 (none), mixtral_8x7b's widths with 2 experts and d_ff split
     4 ways on 512 tokens; bf16 and float32, and float32 under autograd
     (``moe_ffn_train``, ``moe_ffn_bwd``).  Each shard's grouped rows
     through the kernels against plain (bf16 3e-3, float32 1e-5 of
     max|plain|, gradients 1e-5), ``idx``, counts, ``order``, ``valid``
     and group offsets equal to the CPU's, the EP sum at 8.0 against the
     unsharded layer; the ``moe_ffn ep_shard`` kernel rows (bf16,
     float32) at the overflowing shard's layout;
 40. ``bf16_train`` (after phase 37): olmoe_1b_7b at full width, 2
     layers, bf16 parameters, 8 steps: finite, falling losses, launches
     exactly ``moe_ffn``'s and the bf16 ``moe_ffn_bwd``'s; the kernel
     rows ``moe_ffn_bf16 train``, ``moe_ffn_bwd bf16`` and ``moe_ffn_bwd
     bf16 mixtral`` (mixtral's expert shape: 8192 rows over 8 experts, d
     4096, ff 14336; each output within 1e-2 of its largest plain
     magnitude, each launch's device ms and the launch plan,
     ``torch._grouped_mm``'s time for the same products beside);
 41. ``sharded_serve`` (after phase 39): ``prefill`` + 32 greedy
     ``decode_step``s with a (1, 1) NCCL mesh at full width (qwen3_4b,
     gemma3_4b, olmoe_1b_7b, zamba2_7b cut to 4-6 layers), tokens and
     every step's logits bit for bit the unsharded path's, K8, K9 and
     ``moe_ffn`` launched as the path predicts;
 42. ``dryrun``: ``repro_torch.launch.dryrun`` in a subprocess on the
     fake backend (one production cell per kind, every one ``ok``), and
     the dry run's predicted peak of phase 38's olmoe step within 15 % of
     the card's;
  9. every kernel against its plain PyTorch version on the card at the
     shapes the engine gave it (bf16 attention within atol = rtol = 3e-3,
     a limit a bf16-accumulating kernel body must fail; the integer
     kernels exactly, ``qkv_rope_append`` within one bf16 ulp (the
     norm's sum of squares in another order); the dual-pool attention, decode
     and prefill, bit-identical to single-pool K1 on the same pages; a
     packed segment's prefill bits the same at every offset of a bucket
     and beside any neighbours, ``prefill_invariance``, in bf16 and in
     float32), with CUDA-event
     timings of the kernel, the plain version and one PyTorch library
     call where one computes the same function, and the least time the
     card could take: bytes over 3.35 TB/s for HBM, bytes over the
     host-link rate measured in this run (a pinned -> device ``copy_``)
     for pinned host memory, operations over the bf16 peak (float32
     rows: over 494.7/3 TFLOP/s, 3xTF32 on the tensor cores, with
     ``bound_fma_ms`` over the 67 TFLOP/s FMA peak beside it; each also
     gives SDPA's own error against the plain version and the kernels
     SDPA runs).  Phases
     10-13 run before it; ``qkv_rope_append``'s row adds the device time
     of the parent's eager ops it replaced and a 256-row prefill bucket;
     its rows add K6 (one device work node a call, its cluster plan),
     ``dequant_gather``, K5 over
     1-byte pages, K1's and K1d's prefill bodies at the prefill shape
     (the bf16 body's HMMA count ``sass_hmma`` must not be 0; K1 and K1d
     also as ``device_ms`` over CUDA graphs, K1 also at shorter segments
     and K1d with every page in HBM, K1d beside SDPA with its host-to-HBM
     copy timed too), K1's float32 prefill body (3xTF32 on the tensor
     cores) at the float32 probe's shape and at the engine's bucket
     within 1e-5 (its launches read around that probe; ``sass_hmma`` must
     not be 0) and K1's float32 decode body at the engine's decode shape
     within 1e-5 (its launches: that probe's replay); every K1
     row carries its launch ``plan`` (grid, shared memory, CTAs and warps
     per SM by the occupancy calculator); phases 14-17 too, and
     its rows add K8 (zamba2's prefill shape, a GQA shape, a 512-token
     window; bf16 within 1e-2, each with ``sass_hgmma``, the count of
     HGMMA instructions in the bf16 kernel, which must not be 0; and the
     float32 entry, 3xTF32 on the tensor cores, at the float32 probe's
     shape and at zamba2's within 1e-5, ``sass_hmma`` not 0) and K9
     (zamba2's and mamba2's shapes in bf16, and in float32 the float32
     probe's shape and zamba2's and mamba2's prefill shapes; outputs
     within 1e-4 of their largest magnitude; each with ``device_ms`` over
     a CUDA graph, the device work nodes of one call, its launch plan and
     ``sass_hmma``, the HMMA count of its entry's three tensor-core
     kernels, none of which may be 0; float32 rows with ``bound_ms`` at
     494.7/3 TFLOP/s beside ``bound_fma_ms``), and the
     ``ssd_scan_passes`` line times K9's four kernels one by one under
     ``torch.profiler`` at every K9 shape.  K2's
     row times the event form and SysMon's form (a ``valid`` mask, an
     ``is_write`` flag), each also as ``device_ms`` over a CUDA graph of
     50 captured calls beside ``index_add_``'s, and must count exactly
     one device work node in a graph of one call; K7's row adds its
     ``device_ms`` the same way beside an empty one-thread kernel's
     (``empty_kernel_device_ms``, the launch floor).

Output: the card's name and power limit, the build time, the engine
lines, the parity lines, the overlap lines, the QoS summary and the
``serve_cli`` line (the full ``qos_overload`` and ``qos_power`` lines go
to standard error), the prefill and int8 lines,
the long-context
lines, the ``{"kernels": [...]}`` line, the K9 pass times, the MoE,
mixtral and dense-arch lines, the slice-15 long-context lines, the
training lines, the ``moe_shards`` and ``sharded_train`` lines, the
card's line again, and last ``{"ok":
true, "device": {...}}``.  Exits 2
without a CUDA device and 1 when the port's sources are not beside this
script.
"""
from __future__ import annotations

import contextlib
import json
import re
import subprocess
import sys
import time
from pathlib import Path

HBM_BYTES_PER_S = 3.35e12     # H100 SXM device memory
BF16_FLOPS_PER_S = 989e12     # H100 SXM dense bf16 tensor-core peak
F32_FLOPS_PER_S = 67e12       # H100 SXM float32 outside the tensor cores
# float32-accurate products on the tensor cores: three TF32 products each
# (3xTF32) at the 494.7 TFLOP/s dense TF32 peak.  Every float32 row's
# bound_ms takes this rate, whichever way its kernel computes;
# bound_fma_ms beside it takes F32_FLOPS_PER_S.
F32_TC_FLOPS_PER_S = 494.7e12 / 3
# bf16 K/V, kernel vs plain, atol = rtol: ~3x the kernel's error on the
# card, below what accumulating softmax.V in bf16 gives (checked per run)
ATTN_TOL = 3e-3
# float32 K/V: K1's float32 bodies vs plain, float32-accurate products
# (FMA in decode, 3xTF32 on the tensor cores in prefill) summed in another
# order
PAGED_F32_TOL = 1e-5

SEED = 0
REQUESTS, PROMPT_LEN, NEW_TOKENS = 12, 128, 32       # the engine runs
PARITY_PROMPT_LEN, PARITY_NEW_TOKENS = 32, 16        # the parity runs
# the pinned run's media storm: per live pinned slot and engine step
FAULT_SEED, FLIP_RATE, STUCK_RATE = 3, 5e-4, 2e-4
# the storm of the pinned-tail run (the parity phase's requests with HBM
# cut to 8 slots, so tail pages are appended in the pinned tier)
TAIL_FAULT_SEED, TAIL_FLIP_RATE, TAIL_STUCK_RATE = 6, 1e-2, 5e-3
# the overlapped memos plan's fault run: a plan delay far above the
# watchdog's timeout (a dispatch between snapshot and commit takes well
# under PLAN_DELAY_S - PLAN_TIMEOUT_S), so a delayed plan always times out
PLAN_FAULT_SEED, PLAN_TIMEOUT_S, PLAN_DELAY_S = 9, 0.25, 3.0
# kernels each engine run must launch (its path); the rest of KERNELS
# belongs to the other run
# (every decode inner step and every prefill dispatch also launches
# qkv_rope_append once per layer: _check_rope_append counts it exactly)
ENGINE_KERNELS = ("paged_attention", "qkv_rope_append", "touch_update",
                  "page_gather", "page_scatter", "wear_update",
                  "sysmon_pass")
PINNED_KERNELS = ("paged_attention_dual", "qkv_rope_append", "touch_update",
                  "wear_update", "page_checksum", "sysmon_pass")
# the pinned-tail run: memos off, so no pass sweep
TAIL_KERNELS = ("paged_attention_dual", "qkv_rope_append", "touch_update",
                "wear_update", "page_checksum")
# the overlapped runs without faults (no page integrity, so no K5): K7
# at each snapshot, K3a/K3b in each commit's moves
OVERLAP_PINNED_KERNELS = ("paged_attention_dual", "qkv_rope_append",
                          "touch_update", "wear_update", "sysmon_pass",
                          "page_gather", "page_scatter")
# the prefill and int8 runs: each prefill dispatch appends its rows
# with qkv_rope_append and attends with K1's prefill body (its dual-pool
# entry when prompt pages sit in the pinned tier), the decode with K1's
# decode body; the int8 runs quantize demotions with K6 and dequantize
# promotions with dequant_gather, and the armed int8-pinned run sums its
# 1-byte pages with K5
PREFILL_KERNELS = ("paged_attention", "paged_attention_prefill",
                   "qkv_rope_append", "touch_update", "page_gather",
                   "page_scatter", "wear_update", "sysmon_pass")
INT8_HOST_KERNELS = ("paged_attention", "paged_attention_prefill",
                     "qkv_rope_append", "page_gather_quant",
                     "dequant_gather",
                     "page_scatter", "touch_update", "wear_update",
                     "sysmon_pass")
INT8_PINNED_KERNELS = INT8_HOST_KERNELS + ("page_checksum",)
# prefill vs replay of the same prompt at full depth, KV pages and
# first-token logits.  On float32 weights the two agree within 1.1e-5
# (KV) and 7.9e-6 (logits) on the card: the limit (atol = rtol) is ~10x
# that, and a prefill whose dense math runs in TF32 must fall outside it
# (checked per run).  In bf16 the two paths round apart with depth, as
# their dense math runs on other numbers of rows (ROADMAP C6; 0.094 KV,
# 0.086 logits at most on the card): the maximum errors are held at ~2x
# those readings.  A first token may differ only where the replay's
# top-2 logit margin is below PROBE_TIE_MARGIN.
PROBE_F32_TOL = 1e-4
PROBE_BF16_MAX_ERR = 0.2
PROBE_TIE_MARGIN = 3e-2
# phases 14-17, dense-cache long-context generation at full width and
# depth in bf16: 4 prompts of 2000 tokens (15 full 128-token SSD chunks
# and a ragged 80), 32 greedy decode steps into 2032 cache slots
LONGCTX_BATCH, LONGCTX_PROMPT, LONGCTX_NEW = 4, 2000, 32
LONGCTX_CACHE = LONGCTX_PROMPT + LONGCTX_NEW
# decode logits vs a fresh prefill over the same tokens on float32
# weights: zamba2 at full width cut to 14 layers (two shared-attention
# sites), mamba2_1_3b at full depth, a 500-token prompt, 4 steps; a flip
# of the argmax is allowed only under a top-2 margin of 1e-2
LONGCTX_PROBE_LAYERS = 14
LONGCTX_PROBE_PROMPT, LONGCTX_PROBE_STEPS = 500, 4
LONGCTX_PROBE_TOL = 1e-3
LONGCTX_TIE_MARGIN = 1e-2
# the same probe on the full-depth bf16 models (ROADMAP C8): decode and
# prefill round apart layer by layer.  Their logits differed by at most
# 0.244 (zamba2_7b) and 0.172 (mamba2_1_3b) on the card, with argmax flips
# at top-2 margins of 0.016 and 0.031; the limits are ~2x and ~3x those
LONGCTX_BF16_MAX_ERR = 0.5
LONGCTX_BF16_TIE_MARGIN = 0.1
# smoke width, float32, the card (kernels) vs the CPU (plain versions)
LONGCTX_CROSS_PROMPT, LONGCTX_CROSS_STEPS, LONGCTX_CROSS_TOL = 37, 5, 1e-4
# K8's GQA row (B, S, Hq, Hkv, D), beside the zamba2 prefill shapes
FLASH_GQA_SHAPE = (1, 2048, 32, 8, 128)
# K8's float32 entry (3xTF32 on the tensor cores) vs plain at the float32
# probe's and zamba2's shapes: float32-accurate products summed in another
# order
FLASH_F32_TOL = 1e-5
# K8 bf16 output vs plain: the same float32 math on the same bf16 inputs,
# summed in another order; the two outputs round to bf16 at most one ulp
# apart (2**-8 to 2**-7 relative)
FLASH_TOL = 1e-2
# K9 float32 outputs vs plain: float32-accurate products (3xTF32 on the
# tensor cores in the kernel, FMA in plain) summed in other orders over
# up to L terms, so the error scales with the output's largest
# magnitude: atol is SSD_TOL times max |plain| (|y| reaches ~300 at
# zamba2's shape with these inputs), rtol SSD_TOL
SSD_TOL = 1e-4
# K9's kernels with tensor-core products (``sass_hmma``): the bf16
# entry's (names with "bf") and the float32 entry's, 3xTF32
SSD_TENSOR_CORE_KERNELS = ("ssd_prologue_kernelI13__nv_bfloat16",
                           "ssd_states_bf16_kernel", "ssd_output_bf16_kernel",
                           "ssd_prologue_kernelIfE", "ssd_states_f32_kernel",
                           "ssd_output_f32_kernel")


def _emit(obj) -> None:
    print(json.dumps(obj) if not isinstance(obj, str) else obj, flush=True)


def _card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


def _time_ms(fn, iters: int = 50, warmup: int = 5) -> float:
    import torch
    for _ in range(warmup):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def _bound_ms(nbytes: float, flops: float = 0.0, host_bytes: float = 0.0,
              link_bytes_per_s: float | None = None,
              flops_per_s: float = BF16_FLOPS_PER_S) -> tuple[float, str]:
    """The least time the card could take: the bytes moved in HBM over its
    rate and the bytes moved across the host link (pinned host memory)
    over the link rate measured in this run — the two channels work in
    parallel, so the larger of the two — or the operations on the inputs
    over the card's peak for their type (bf16 unless given), whichever is
    larger."""
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    if host_bytes:
        t_bytes = max(t_bytes, host_bytes / link_bytes_per_s * 1e3)
    t_ops = flops / flops_per_s * 1e3
    return (max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops else
            "operations")


def _plan(prefill: bool, dual: bool, dtype, rows: int, Hkv: int, G: int,
          D: int) -> dict:
    """The launch plan of K1's body for these shapes (grid CTAs, threads,
    shared memory, CTAs per SM from the occupancy calculator, cluster
    size) and the warps it can keep on a busy SM: the resident CTAs per
    SM, at most the grid spread over the SMs, times the warps per CTA.
    An upper bound from the plan, not an achieved occupancy."""
    import torch
    from repro_torch.kernels import paged_attention as K1
    info = K1.launch_info(prefill, dual, dtype, rows, Hkv, G, D)
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    per_sm = min(info["ctas_per_sm"], -(-info["ctas"] // sms))
    return {**info, "sms": sms,
            "warps_per_busy_sm": per_sm * info["threads"] // 32}


def _captured(fn, calls: int, keep_graph: bool = False):
    """A CUDA graph of ``calls`` calls of ``fn``, warmed up on a side
    stream first."""
    import torch
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(3):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph(keep_graph=keep_graph)
    with torch.cuda.graph(graph):
        for _ in range(calls):
            fn()
    return graph


def _host_us(fn, calls: int = 2000) -> float:
    """Host microseconds per call of ``fn`` (perf_counter over ``calls``
    calls after a warm-up; the card is synchronised before and after)."""
    import torch
    for _ in range(50):
        fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(calls):
        fn()
    us = (time.perf_counter() - t0) / calls * 1e6
    torch.cuda.synchronize()
    return us


def _graph_ms(fn, calls: int = 50, replays: int = 20) -> float:
    """Device time per call: CUDA events around replays of a graph of
    ``calls`` captured calls, so no host work sits between them."""
    import torch
    graph = _captured(fn, calls)
    graph.replay()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(replays):
        graph.replay()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / (replays * calls)


def _kernel_ms(fn, names, calls: int = 10) -> dict:
    """For each of ``names``: the kernels whose names hold it in a
    ``torch.profiler`` trace of ``calls`` calls of ``fn`` (after one
    warm-up call), as the mean device ms of one traced instance and the
    number of instances traced (a trace may drop records, so the mean is
    taken over what it kept)."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    spans = {n: [] for n in names}
    for e in prof.events():
        if e.device_type != torch.autograd.DeviceType.CUDA:
            continue
        for n in names:
            if n in e.name:
                spans[n].append((e.time_range.end - e.time_range.start) / 1e3)
    return {n: {"ms": sum(v) / len(v) if v else None, "instances": len(v)}
            for n, v in spans.items()}


def _graph_launches(fn) -> int:
    """Device work nodes (kernels, memsets, copies) in a graph of one
    call of ``fn``, read with ``cuGraphGetNodes`` from libcuda."""
    import ctypes
    graph = _captured(fn, 1, keep_graph=True)
    cuda = ctypes.CDLL("libcuda.so.1")
    handle = ctypes.c_void_p(graph.raw_cuda_graph())
    n = ctypes.c_size_t(0)
    if cuda.cuGraphGetNodes(handle, None, ctypes.byref(n)) != 0:
        raise RuntimeError("cuGraphGetNodes failed")
    nodes = (ctypes.c_void_p * n.value)()
    if n.value and cuda.cuGraphGetNodes(handle, nodes, ctypes.byref(n)):
        raise RuntimeError("cuGraphGetNodes failed")
    work = 0
    for node in nodes:
        kind = ctypes.c_int(-1)
        cuda.cuGraphNodeGetType(ctypes.c_void_p(node), ctypes.byref(kind))
        work += kind.value in (0, 1, 2)     # KERNEL, MEMCPY, MEMSET
    return work


def _tool(name: str):
    """``tools/<name>.py`` beside this script, imported as a module."""
    import importlib.util
    path = Path(__file__).resolve().parent / "tools" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(name, path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


_SASS: list[str] = []


def _sass_count(function: str, opcode: str) -> int:
    """Instructions whose opcode starts with ``opcode`` (HGMMA, HMMA) in
    the kernel functions whose names hold ``function``, from ``cuobjdump
    -sass`` of the built library (``cuobjdump`` sits beside ``nvcc``;
    disassembled once a run)."""
    from repro_torch.kernels import _build
    if not _SASS:
        tool = Path(_build.nvcc()).with_name("cuobjdump")
        if not tool.is_file():
            raise RuntimeError(f"{tool} missing: cannot count {opcode}")
        _build.library()
        _SASS.append(subprocess.run(
            [str(tool), "-sass", _build.build_info["library"]],
            capture_output=True, text=True, check=True, timeout=300).stdout)
    count, inside = 0, False
    for line in _SASS[0].splitlines():
        fn = re.search(r"Function : (\S+)", line)
        if fn:
            inside = function in fn.group(1)
        elif inside and re.search(rf"\b{opcode}\.", line):
            count += 1
    return count


def _device_kernels(fn, calls: int = 5, tries: int = 3) -> list[str]:
    """The names of the device kernels ``fn`` launches (a
    ``torch.profiler`` trace of ``calls`` calls after a warm-up call;
    traced again, up to ``tries`` times, while a trace keeps no kernel
    record): which kernel a library call runs."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    names: set[str] = set()
    for _ in range(tries):
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for _ in range(calls):
                fn()
            torch.cuda.synchronize()
        for e in prof.key_averages():
            on_device = (getattr(e, "device_type", None)
                         == torch.autograd.DeviceType.CUDA
                         or getattr(e, "self_device_time_total", 0) > 0)
            if on_device and not e.key.startswith(
                    ("aten::", "cuda", "Memcpy", "Memset", "Activity")):
                names.add(e.key)
        if names:
            break
    return sorted(names)


def _launch_floor():
    """A call that launches an empty one-thread kernel on the current
    stream: the launch floor a launch-bound kernel is read against."""
    import ctypes
    from repro_torch.kernels import _build
    fn = _build.function("launch_floor", [ctypes.c_void_p])

    def call():
        _build.check(fn(_build.current_stream(0)), "launch_floor")
    return call


def _f32_bounds(nbytes: float, flops: float) -> dict:
    """A float32 row's bounds: ``bound_ms`` with the products on the
    tensor cores at 3xTF32's rate, ``bound_fma_ms`` on the FMA units."""
    bound, by = _bound_ms(nbytes, flops, flops_per_s=F32_TC_FLOPS_PER_S)
    fma, fma_by = _bound_ms(nbytes, flops, flops_per_s=F32_FLOPS_PER_S)
    return {"bound_ms": bound, "bound_by": by, "bound_fma_ms": fma,
            "bound_fma_by": fma_by,
            "bound_note": "operations over 494.7/3 TFLOP/s (3xTF32 on the "
                          "tensor cores); bound_fma_ms over the 67 TFLOP/s "
                          "float32 FMA peak"}


# =============================================================================
# phases 2-6: the engine at full width
# =============================================================================

def _serve_config(**kw):
    from repro_torch.serving.engine import ServeConfig
    base = dict(page_size=16, max_batch=8, fast_slots=64, slow_slots=512,
                max_pages_per_seq=16, memos_interval=8, decode_block=8)
    base.update(kw)
    return ServeConfig(**base)


def _prompts(n: int, length: int, vocab: int, seed: int) -> list[list[int]]:
    import numpy as np
    rng = np.random.RandomState(seed)
    return [rng.randint(0, vocab, size=length).tolist() for _ in range(n)]


def _span_seconds() -> dict[str, float]:
    """Host wall seconds per span name of the process tracer (nested
    spans such as migrate.move_group are also inside their parents)."""
    from repro_torch import obs
    span_s: dict[str, float] = {}
    for ev in obs.get_tracer().events():
        span_s[ev.name] = span_s.get(ev.name, 0.0) + ev.dur_ns * 1e-9
    return span_s


def _check_launches(launches: dict, path: tuple[str, ...], run: str) -> None:
    missing = [k for k in path if launches[k] == 0]
    if missing:
        raise RuntimeError(f"kernels never launched on the {run} path: "
                           f"{missing}")


def _check_rope_append(launches: dict, cfg, hist: list, run: str,
                       prefill_dispatches: int = 0) -> int:
    """``qkv_rope_append`` launched exactly once per layer for every
    decode inner step and every prefill dispatch of the run (its qk-norm,
    RoPE and append ran nowhere else).  Returns the inner steps."""
    inner = sum(h.get("decode_block", 0) for h in hist)
    want = cfg.n_layers * (inner + prefill_dispatches)
    if launches["qkv_rope_append"] != want:
        raise RuntimeError(f"{run}: {launches['qkv_rope_append']} launches "
                           f"of qkv_rope_append, {want} expected ({inner} "
                           f"inner steps, {prefill_dispatches} prefill "
                           f"dispatches, {cfg.n_layers} layers)")
    return inner


def _ulps_apart(got, want) -> int:
    """The most bf16 ulps (at the larger magnitude) between two tensors
    of equal shape, compared in float32."""
    import torch
    g, w = got.float().cpu(), want.float().cpu()
    big = torch.maximum(g.abs(), w.abs()).clamp_min(
        torch.finfo(torch.float32).tiny)
    ulp = torch.exp2(torch.floor(torch.log2(big)) - 7)
    return int(torch.ceil(((g - w).abs() / ulp).max()).item())


def _parent_rope_append():
    """The ops the parent tree ran around the KV append of the
    single-pool decode, for ``qkv_rope_append``'s arguments with one
    pool: eager qk-norm and RoPE of q and k, ``q * D**-0.5`` grouped, and
    two ``index_put_`` of the K/V rows (slot and offset made long once
    per step, as the parent did).  Stands in for ``qkv_rope_append`` to
    count and time what the fused kernel replaced."""
    from repro_torch.models import layers as L
    memo = {}

    def run(q, k, v, q_norm, k_norm, cos, sin, fast, pin, f_idx, p_idx,
            off):
        if pin is not None:
            raise RuntimeError("the parent composition is for one pool")
        if memo.get("key") is not f_idx:
            memo.update(key=f_idx, rows=f_idx.long(), off=off.long())
        if q_norm is not None:
            q, k = L.rms_norm(q, q_norm), L.rms_norm(k, k_norm)
        q, k = L.apply_rope(q, cos, sin), L.apply_rope(k, cos, sin)
        fast[memo["rows"], 0, memo["off"]] = k
        fast[memo["rows"], 1, memo["off"]] = v
        R, Hq, D = q.shape
        return (q * D ** -0.5).reshape(R, k.shape[1], Hq // k.shape[1], D)
    return run


class _QkOps:
    """Counts the calls of ``rms_norm`` and ``apply_rope`` on head-shaped
    tensors (last dim head_dim, a head axis before it): the qk-norm and
    RoPE the paged serving path runs inside ``qkv_rope_append`` and
    nowhere else.  A context manager over the ``layers`` module."""

    def __init__(self, head_dim: int):
        self.head_dim, self.calls, self.saved = head_dim, 0, []

    def __enter__(self):
        from repro_torch.models import layers
        for name in ("rms_norm", "apply_rope"):
            f = getattr(layers, name)
            self.saved.append((name, f))

            def counted(x, *a, _f=f, **k):
                if x.dim() >= 3 and x.shape[-1] == self.head_dim:
                    self.calls += 1
                return _f(x, *a, **k)
            setattr(layers, name, counted)
        return self

    def __exit__(self, *exc):
        from repro_torch.models import layers
        for name, f in self.saved:
            setattr(layers, name, f)


def _corrupted_tokens(reqs, want: list[list[int]]) -> tuple[int, dict]:
    """Tokens that differ from ``want`` (the fault-free run's tokens per
    request): a completed request must match it whole, a failed one must
    have emitted an exact prefix.  Returns (count, {request: first bad
    position})."""
    corrupted, wrong = 0, {}
    for r, w in zip(reqs, want):
        got = r.generated
        ref = w if r.error is None else w[:len(got)]
        n = sum(a != b for a, b in zip(got, ref)) + abs(len(got) - len(ref))
        if n:
            corrupted += n
            wrong[r.rid] = next((i for i, (a, b) in enumerate(zip(got, ref))
                                 if a != b), min(len(got), len(ref)))
    return corrupted, wrong


def run_engine(cfg, params) -> tuple[dict, dict, object, list]:
    import torch
    from repro_torch import kernels, obs
    from repro_torch.models.transformer import pad_vocab
    from repro_torch.serving.engine import PagedServingEngine
    eng = PagedServingEngine(cfg, params, _serve_config(), device="cuda")
    prompts = _prompts(REQUESTS, PROMPT_LEN, cfg.vocab, SEED)
    reqs = [eng.submit(p, NEW_TOKENS) for p in prompts]
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    obs.reset()
    obs.configure(trace=True)      # the engine's own spans: where time goes
    kernels.reset_launch_counts()
    t0 = time.perf_counter()
    hist = eng.run()
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    launches = kernels.launch_counts()
    obs.configure(trace=False)
    span_s = _span_seconds()
    store = eng.kv.store
    mig = eng.memos.engine.stats
    wear = store.wear
    out = {
        "phase": "engine", "arch": cfg.name, "n_layers": cfg.n_layers,
        "d_model": cfg.d_model, "dtype": "bfloat16",
        "requests": len(reqs), "prompt_len": PROMPT_LEN,
        "new_tokens": NEW_TOKENS,
        "generated": eng.tokens_out,
        "processed_tokens": int(sum(len(r.tokens) for r in reqs)),
        "seconds": dt,
        "generated_tokens_per_s": eng.tokens_out / dt,
        "processed_tokens_per_s": sum(len(r.tokens) for r in reqs) / dt,
        "steps": len(hist), "dispatches": len(hist),
        "memos_passes": len(eng.memos.reports),
        "migrations_to_fast": mig.to_fast, "migrations_to_slow": mig.to_slow,
        "memos_pass_to_fast": sum(r.migrations.to_fast
                                  for r in eng.memos.reports),
        "memos_pass_to_slow": sum(r.migrations.to_slow
                                  for r in eng.memos.reports),
        "preemptions": eng.batcher.n_preempted,
        "traffic_0_1_bytes": store.traffic[(0, 1)],
        "traffic_1_0_bytes": store.traffic[(1, 0)],
        "slow_wear_max": wear.max_wear(),
        "slow_writes": wear.writes_total,
        "peak_device_bytes": torch.cuda.max_memory_allocated(),
        "launches": launches,
        # host wall seconds per span name (nested spans such as
        # migrate.move_group are also inside their parents)
        "span_seconds": span_s,
    }
    bad = [r.rid for r in reqs
           if r.error is not None or len(r.generated) != NEW_TOKENS]
    if bad:
        raise RuntimeError(f"requests {bad} did not complete")
    if not torch.isfinite(eng.last_logits.float()).all():
        raise RuntimeError("non-finite logits")
    if eng.last_logits.shape[-1] != pad_vocab(cfg.vocab):
        raise RuntimeError(f"logits shape {tuple(eng.last_logits.shape)}")
    for key in ("traffic_0_1_bytes", "traffic_1_0_bytes", "slow_wear_max",
                "slow_writes", "migrations_to_fast", "migrations_to_slow"):
        if not out[key]:
            raise RuntimeError(f"engine run has {key} == 0: the memos path "
                               f"did not run")
    _check_launches(launches, ENGINE_KERNELS, "engine")
    out["decode_inner_steps"] = _check_rope_append(launches, cfg, hist,
                                                   "engine")
    return out, launches, eng, [r.generated for r in reqs]


def run_engine_pinned(cfg, params, want: list[list[int]]
                      ) -> tuple[dict, dict, object]:
    """The engine run's requests over the pinned-host NVM tier, served in
    place, with the fault injector flipping and sticking bits in it.
    ``want`` holds the engine run's tokens per request."""
    import torch
    from repro_torch import faults, kernels, obs
    from repro_torch.core.hierarchy import MemoryHierarchy
    from repro_torch.faults import FaultConfig
    from repro_torch.models.transformer import pad_vocab
    from repro_torch.serving.engine import PagedServingEngine
    # armed before the store is built: it latches page integrity
    inj = faults.configure(FaultConfig(seed=FAULT_SEED,
                                       media_flip_rate=FLIP_RATE,
                                       media_stuck_rate=STUCK_RATE))
    try:
        eng = PagedServingEngine(cfg, params, _serve_config(
            hierarchy=MemoryHierarchy.two_tier(64, 512, pinned_slow=True)),
            device="cuda")
        reqs = [eng.submit(p, NEW_TOKENS)
                for p in _prompts(REQUESTS, PROMPT_LEN, cfg.vocab, SEED)]
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        obs.reset()
        obs.configure(trace=True)
        kernels.reset_launch_counts()
        t0 = time.perf_counter()
        hist = eng.run()
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        launches = kernels.launch_counts()
        obs.configure(trace=False)
    finally:
        faults.reset()
    span_s = _span_seconds()
    reg = obs.get_registry()
    store = eng.kv.store
    pt = eng.pinned_tier
    wear, lv = store.wear_by_tier[pt], store.leveler_by_tier[pt]
    done = [r for r in reqs if r.error is None]
    failed = [r for r in reqs if r.error is not None]
    corrupted, wrong = _corrupted_tokens(reqs, want)
    quarantined = sum(len(q) for q in store.quarantined.values())
    out = {
        "phase": "pinned_faults", "arch": cfg.name,
        "n_layers": cfg.n_layers, "d_model": cfg.d_model,
        "dtype": "bfloat16", "hierarchy": store.hierarchy.describe(),
        "requests": len(reqs), "prompt_len": PROMPT_LEN,
        "new_tokens": NEW_TOKENS, "generated": eng.tokens_out,
        "seconds": dt, "generated_tokens_per_s": eng.tokens_out / dt,
        "dispatches": len(hist), "memos_passes": len(eng.memos.reports),
        "fault_seed": FAULT_SEED, "media_flip_rate": FLIP_RATE,
        "media_stuck_rate": STUCK_RATE,
        "faults_injected": inj.total_injected,
        "faults_by_kind": dict(inj.counts),
        "quarantined_slots": quarantined,
        "completed": len(done), "failed": [r.rid for r in failed],
        "failed_errors": sorted({type(r.error).__name__ for r in failed}),
        "corrupted_tokens": corrupted,
        "preemptions": eng.batcher.n_preempted,
        "pinned_reads": store.reads_from[pt],
        "pinned_writes": store.writes_to[pt],
        "traffic_0_1_bytes": store.traffic[(0, 1)],
        "traffic_1_0_bytes": store.traffic[(1, 0)],
        "slow_wear_max": wear.max_wear(), "slow_writes": wear.writes_total,
        "leveling_writes": wear.leveling_writes,
        "startgap_advances": lv.stats.advances,
        "ladder_rung": eng.memos.ladder.rung,
        "recovered": int(reg.counter("faults.recovered").value),
        "peak_device_bytes": torch.cuda.max_memory_allocated(),
        "launches": launches,
        # the optimistic demotions into the pinned tier commit without a
        # migrate.move_group span; a span that never opened reads 0
        "span_seconds": {**dict.fromkeys(
            ("serve.dispatch", "serve.startgap_adopt", "memos.pass_sync",
             "migrate.move_group"), 0.0), **span_s},
    }
    if corrupted:
        raise RuntimeError(f"pinned run emitted {corrupted} corrupted "
                           f"tokens (request: first bad position) {wrong}; "
                           f"failed {out['failed']}")
    if not done or len(done) < len(failed):
        raise RuntimeError(f"pinned run completed only {len(done)} of "
                           f"{len(reqs)} requests")
    bad = [r.rid for r in failed if out["failed_errors"] !=
           ["PageCorruptionError"]]
    if bad:
        raise RuntimeError(f"requests {bad} failed with "
                           f"{out['failed_errors']}")
    for key in ("faults_injected", "quarantined_slots", "slow_wear_max",
                "pinned_reads"):
        if not out[key]:
            raise RuntimeError(f"pinned run has {key} == 0")
    if not torch.isfinite(eng.last_logits.float()).all() \
            or eng.last_logits.shape[-1] != pad_vocab(cfg.vocab):
        raise RuntimeError("pinned run's last logits are non-finite or "
                           "misshapen")
    _check_launches(launches, PINNED_KERNELS, "pinned")
    out["decode_inner_steps"] = _check_rope_append(launches, cfg, hist,
                                                   "pinned_faults")
    return out, launches, eng


def _pinned_tail_config(**kw):
    """HBM cut to 8 slots under the parity requests: tail pages are
    appended in the pinned tier and Start-Gap advances every 4 pinned
    writes."""
    from repro_torch.core.hierarchy import MemoryHierarchy
    return _serve_config(fast_slots=8, slow_slots=64,
                         hierarchy=MemoryHierarchy.two_tier(
                             8, 64, pinned_slow=True, gap_write_interval=4),
                         **kw)


def run_fused_vs_reference(cfg, params, pinned: bool = False
                           ) -> tuple[dict, list]:
    """The fused dispatch against the K=1 reference path, memos off.  With
    ``pinned`` the NVM tier is pinned host memory and HBM holds 8 pages,
    so tail pages land in the pinned pool: KV appends, the in-dispatch
    wear charge and Start-Gap advances (every 4 pinned writes) run at
    full depth, and the pinned pool's bytes, remap and leveler state must
    match too (per-row wear attribution differs with the cadence; its
    total must not).  Returns the line and the fused run's tokens."""
    import numpy as np
    import torch
    from repro_torch import kernels
    from repro_torch.serving.engine import PagedServingEngine
    prompts = _prompts(4, PARITY_PROMPT_LEN, cfg.vocab, SEED + 1)
    runs = {}
    for ref in (False, True):
        # memos off, as the JAX package pins this parity: no pass boundary
        # resets the counters, so they cover the whole access stream
        scfg = (_pinned_tail_config if pinned else _serve_config)(
            reference=ref, memos_enabled=False)
        eng = PagedServingEngine(cfg, params, scfg, device="cuda")
        reqs = [eng.submit(p, PARITY_NEW_TOKENS) for p in prompts]
        kernels.reset_launch_counts()
        hist = eng.run()
        torch.cuda.synchronize()
        _check_rope_append(kernels.launch_counts(), cfg, hist,
                           "fused_vs_reference" + ("_pinned" if pinned
                                                   else "")
                           + ("_reference" if ref else "_fused"))
        state = {f: getattr(eng.sysmon, f).cpu().numpy()
                 for f in eng.sysmon._fields}
        store = eng.kv.store
        state["version"] = store.version.copy()
        if pinned:
            wear, lv = store.wear_by_tier[1], store.leveler_by_tier[1]
            state.update(
                pinned_pool=store.pools[1].raw().copy(),
                remap=wear._remap.copy(),
                leveler=np.array([lv.stats.advances, lv.stats.gap,
                                  lv.stats.rotations, lv._pending]),
                writes=np.array([wear.writes_total, wear.leveling_writes,
                                 wear.wear_counts().sum()]))
        runs[ref] = ([r.generated for r in reqs], state)
    toks_f, sm_f = runs[False]
    toks_r, sm_r = runs[True]
    if toks_f != toks_r:
        raise RuntimeError(f"fused vs reference tokens differ: {toks_f} "
                           f"vs {toks_r}")
    diff = [f for f in sm_f if not np.array_equal(sm_f[f], sm_r[f])]
    if diff:
        raise RuntimeError(f"fused vs reference state differs in {diff}")
    out = {"phase": "fused_vs_reference" + ("_pinned" if pinned else ""),
           "requests": 4, "prompt_len": PARITY_PROMPT_LEN,
           "new_tokens": PARITY_NEW_TOKENS, "tokens_identical": True,
           "sysmon_identical": True}
    if pinned:
        advances, writes = int(sm_f["leveler"][0]), int(sm_f["writes"][0])
        if not (advances and writes):
            raise RuntimeError(f"pinned parity run: {writes} pinned "
                               f"writes, {advances} Start-Gap advances")
        out.update(pinned_writes=writes, startgap_advances=advances,
                   pinned_state_identical=True)
    return out, toks_f


def run_pinned_tail_faults(cfg, params, want: list[list[int]]
                           ) -> tuple[dict, dict]:
    """The pinned parity phase's fused run with the fault injector armed:
    tail pages are appended in the pinned tier, so the checksum refresh
    of appended rows, the in-dispatch wear charge and Start-Gap all run
    with page integrity on.  Twice: with zero fault rates every request
    must complete with ``want``'s tokens and nothing may be quarantined
    (a refresh that read the pool before the appends landed would
    quarantine good pages); under a media storm no token may differ from
    ``want`` and faults must be injected and caught.  Memos stays off,
    as in the parity run: a memos pass would promote the written tails
    to HBM.  The launch counts are read around the storm run."""
    import torch
    from repro_torch import faults, kernels
    from repro_torch.faults import FaultConfig
    from repro_torch.serving.engine import PagedServingEngine
    prompts = _prompts(4, PARITY_PROMPT_LEN, cfg.vocab, SEED + 1)
    out = {"phase": "pinned_tail_faults", "requests": len(prompts),
           "prompt_len": PARITY_PROMPT_LEN, "new_tokens": PARITY_NEW_TOKENS,
           "fault_seed": TAIL_FAULT_SEED, "media_flip_rate": TAIL_FLIP_RATE,
           "media_stuck_rate": TAIL_STUCK_RATE}
    launches = {}
    for storm in (False, True):
        # armed before the store is built: it latches page integrity
        inj = faults.configure(FaultConfig(
            seed=TAIL_FAULT_SEED,
            media_flip_rate=TAIL_FLIP_RATE if storm else 0.0,
            media_stuck_rate=TAIL_STUCK_RATE if storm else 0.0))
        try:
            eng = PagedServingEngine(
                cfg, params, _pinned_tail_config(memos_enabled=False),
                device="cuda")
            reqs = [eng.submit(p, PARITY_NEW_TOKENS) for p in prompts]
            kernels.reset_launch_counts()
            hist = eng.run()
            torch.cuda.synchronize()
            launches = kernels.launch_counts()
            _check_rope_append(launches, cfg, hist, "pinned-tail")
        finally:
            faults.reset()
        store = eng.kv.store
        pt = eng.pinned_tier
        corrupted, wrong = _corrupted_tokens(reqs, want)
        run = {"faults_injected": inj.total_injected,
               "faults_by_kind": dict(inj.counts),
               "quarantined_slots": sum(len(q) for q in
                                        store.quarantined.values()),
               "completed": sum(r.error is None for r in reqs),
               "failed": [r.rid for r in reqs if r.error is not None],
               "failed_errors": sorted({type(r.error).__name__ for r in reqs
                                        if r.error is not None}),
               "corrupted_tokens": corrupted,
               "pinned_writes": store.writes_to[pt],
               "startgap_advances": store.leveler_by_tier[pt].stats.advances,
               "slow_wear_max": store.wear_by_tier[pt].max_wear()}
        out["storm" if storm else "armed_no_faults"] = run
        if corrupted:
            raise RuntimeError(f"pinned-tail run emitted {corrupted} "
                               f"corrupted tokens {wrong}: {run}")
        for key in ("pinned_writes", "startgap_advances", "slow_wear_max"):
            if not run[key]:
                raise RuntimeError(f"pinned-tail run has {key} == 0: {run}")
        if not storm and (run["failed"] or run["quarantined_slots"]):
            raise RuntimeError(f"pinned-tail run without faults failed "
                               f"requests or quarantined slots: {run}")
        if storm and not (run["faults_injected"] and run["completed"]
                          and run["failed_errors"] in (
                              [], ["PageCorruptionError"])):
            raise RuntimeError(f"pinned-tail storm: {run}")
    out["launches"] = launches
    _check_launches(launches, TAIL_KERNELS, "pinned-tail")
    return out, launches


def _plan_threads() -> list[str]:
    """Names of the threads that recorded ``memos.plan`` spans."""
    from repro_torch import obs
    tr = obs.get_tracer()
    names = tr.thread_names
    return sorted({names.get(ev.tid, "?") for ev in tr.events()
                   if ev.name == "memos.plan"})


def _serve_overlap_run(cfg, params, pinned: bool, overlap: bool,
                       want: list[list[int]]) -> dict:
    """Phase 2's requests over the pinned-host or the numpy host tier,
    with or without ``overlap_plan``, no faults; launches read around the
    run.  Every request must emit ``want``'s tokens."""
    import numpy as np
    import torch
    from repro_torch import kernels, obs
    from repro_torch.core.hierarchy import MemoryHierarchy
    from repro_torch.serving.engine import PagedServingEngine
    kw = dict(overlap_plan=overlap)
    if pinned:
        kw["hierarchy"] = MemoryHierarchy.two_tier(64, 512, pinned_slow=True)
    eng = PagedServingEngine(cfg, params, _serve_config(**kw), device="cuda")
    reqs = [eng.submit(p, NEW_TOKENS)
            for p in _prompts(REQUESTS, PROMPT_LEN, cfg.vocab, SEED)]
    torch.cuda.synchronize()
    obs.reset()
    obs.configure(trace=True)
    kernels.reset_launch_counts()
    t0 = time.perf_counter()
    hist = eng.run()
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    launches = kernels.launch_counts()
    obs.configure(trace=False)
    eng.close()
    span_s = _span_seconds()
    name = ("pinned" if pinned else "host") + \
        ("_overlap" if overlap else "_sync")
    mem = eng.memos
    reps = mem.reports
    plan_ms = [r.plan_ms for r in reps if r.committed_async]
    store = eng.kv.store
    corrupted, wrong = _corrupted_tokens(reqs, want)
    out = {
        "run": name, "seconds": dt,
        "generated_tokens_per_s": eng.tokens_out / dt,
        "dispatches": len(hist), "memos_passes": len(reps),
        "committed_async": sum(r.committed_async for r in reps),
        "pages_committed": mem.pages_committed,
        "pages_degraded": mem.pages_degraded,
        "pages_dropped": mem.pages_dropped,
        "migrated": sum(r.migrations.migrated for r in reps),
        "overlap_efficiency": mem.overlap_efficiency,
        "plan_ms_sum": float(np.sum(plan_ms)) if plan_ms else 0.0,
        "plan_ms_mean": float(np.mean(plan_ms)) if plan_ms else None,
        "plan_ms_max": float(np.max(plan_ms)) if plan_ms else None,
        "plan_threads": _plan_threads(),
        "ladder_rung": mem.ladder.rung_name,
        "preemptions": eng.batcher.n_preempted,
        "traffic_0_1_bytes": store.traffic[(0, 1)],
        "traffic_1_0_bytes": store.traffic[(1, 0)],
        "corrupted_tokens": corrupted,
        "launches": launches,
        "span_seconds": {k: span_s.get(k, 0.0) for k in (
            "serve.dispatch", "serve.admit", "serve.provision",
            "memos.pass_sync", "memos.snapshot", "memos.plan",
            "memos.commit", "migrate.move_group")},
    }
    bad = [r.rid for r in reqs
           if r.error is not None or len(r.generated) != NEW_TOKENS]
    if bad or corrupted:
        raise RuntimeError(f"{name}: requests {bad} incomplete, "
                           f"{corrupted} tokens differ from the engine "
                           f"run's (request: first bad position) {wrong}")
    _check_rope_append(launches, cfg, hist, name)
    if pinned:
        _check_launches(launches, OVERLAP_PINNED_KERNELS, name)
    else:
        _check_launches(launches, ENGINE_KERNELS, name)
    if overlap:
        if not (out["committed_async"] and out["pages_committed"]):
            raise RuntimeError(f"{name}: {out['committed_async']} async "
                               f"commits, {out['pages_committed']} pages "
                               f"committed")
        if any(r.fault_fallback for r in reps) or not out["plan_threads"] \
                or not all(t.startswith("memos-plan")
                           for t in out["plan_threads"]):
            raise RuntimeError(f"{name}: fallbacks "
                               f"{[r.fault_fallback for r in reps]}, plan "
                               f"spans on threads {out['plan_threads']}")
    elif out["committed_async"]:
        raise RuntimeError(f"{name}: a synchronous run committed async")
    return out


def run_overlap(cfg, params, want: list[list[int]], engine_line: dict
                ) -> dict:
    """Phase 2's requests served with the memos plan overlapped with the
    next dispatch, over the pinned-host tier beside one synchronous run
    of that tier, and over the numpy host tier beside phase 2's own run
    (``engine_line``: the same configuration, requests and seed without
    overlap, in this call).  ``want``: the engine run's tokens."""
    runs = {r["run"]: r for r in (
        _serve_overlap_run(cfg, params, pinned, overlap, want)
        for pinned, overlap in ((True, False), (True, True),
                                (False, True)))}
    host_sync = {"seconds": engine_line["seconds"],
                 "span_seconds": engine_line["span_seconds"]}
    summary = {}
    for tier, sync in (("pinned", runs["pinned_sync"]),
                       ("host", host_sync)):
        over = runs[f"{tier}_overlap"]
        summary[tier] = {
            "dispatch_s_sync": sync["span_seconds"]["serve.dispatch"],
            "dispatch_s_overlap": over["span_seconds"]["serve.dispatch"],
            "seconds_sync": sync["seconds"],
            "seconds_overlap": over["seconds"],
            "overlap_efficiency": over["overlap_efficiency"],
            "plan_ms_mean": over["plan_ms_mean"],
            "pass_sync_s": sync["span_seconds"]["memos.pass_sync"],
            "snapshot_plus_commit_s": over["span_seconds"]["memos.snapshot"]
            + over["span_seconds"]["memos.commit"]}
    summary["host"]["sync_run"] = "engine"
    return {"phase": "overlap", "requests": REQUESTS,
            "prompt_len": PROMPT_LEN, "new_tokens": NEW_TOKENS,
            "tokens_identical_to_engine": True, "runs": runs,
            "summary": summary}


def run_overlap_plan_faults(cfg, params, want: list[list[int]]) -> dict:
    """The pinned overlapped run with page integrity armed and plan
    faults injected in turn: worker exceptions until a pass falls back,
    then plan delays of PLAN_DELAY_S against a PLAN_TIMEOUT_S watchdog
    until one times out, then none.  Both fallbacks must run, the ladder
    must reach sync and climb back to overlap, and no token may differ
    from ``want``."""
    import torch
    from repro_torch import faults, kernels, obs
    from repro_torch.core.hierarchy import MemoryHierarchy
    from repro_torch.faults import RUNG_OVERLAP, FaultConfig
    from repro_torch.serving.engine import PagedServingEngine
    stages = [("exception", dict(plan_exception_rate=1.0), "InjectedPlanFault"),
              ("delay", dict(plan_delay_rate=1.0, plan_delay_s=PLAN_DELAY_S),
               "timeout"),
              ("none", {}, None)]
    counts = {}
    # armed before the store is built: it latches page integrity
    faults.configure(FaultConfig(seed=PLAN_FAULT_SEED))
    try:
        eng = PagedServingEngine(cfg, params, _serve_config(
            overlap_plan=True, hierarchy=MemoryHierarchy.two_tier(
                64, 512, pinned_slow=True)), device="cuda")
        eng.memos.cfg.plan_timeout_s = PLAN_TIMEOUT_S
        reqs = [eng.submit(p, NEW_TOKENS)
                for p in _prompts(REQUESTS, PROMPT_LEN, cfg.vocab, SEED)]
        torch.cuda.synchronize()
        kernels.reset_launch_counts()
        t0 = time.perf_counter()
        stage, rungs, fallbacks, hist = 0, [], [], []
        inj = faults.configure(FaultConfig(seed=PLAN_FAULT_SEED,
                                           **stages[0][1]))
        while not eng.batcher.all_done() and eng.step_count < 10_000:
            n = len(eng.memos.reports)
            hist.append(eng.step())
            rungs.append(eng.memos.ladder.rung_name)
            for r in eng.memos.reports[n:]:
                if r.fault_fallback is not None:
                    fallbacks.append((len(hist), r.fault_fallback))
                    if r.fault_fallback == stages[stage][2]:
                        for k, v in inj.counts.items():
                            counts[k] = counts.get(k, 0) + v
                        stage += 1
                        inj = faults.configure(FaultConfig(
                            seed=PLAN_FAULT_SEED, **stages[stage][1]))
        eng.run()                   # flush the last overlapped plan
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        launches = kernels.launch_counts()
        eng.close()
    finally:
        faults.reset()
    mem = eng.memos
    corrupted, wrong = _corrupted_tokens(reqs, want)
    last_fault = max((i for i, _ in fallbacks), default=len(rungs))
    climbed = "overlap" in rungs[last_fault:]
    out = {
        "phase": "overlap_plan_faults", "requests": REQUESTS,
        "plan_timeout_s": PLAN_TIMEOUT_S, "plan_delay_s": PLAN_DELAY_S,
        "fault_seed": PLAN_FAULT_SEED, "seconds": dt,
        "stages_reached": [s[0] for s in stages[:stage + 1]],
        "fallbacks": fallbacks, "faults_by_kind": counts,
        "ladder_failures": mem.ladder.failures,
        "ladder_demotions": mem.ladder.demotions,
        "ladder_promotions": mem.ladder.promotions,
        "rungs_by_step": rungs, "climbed_back_to_overlap": climbed,
        "final_rung": mem.ladder.rung_name,
        "committed_async": sum(r.committed_async for r in mem.reports),
        "pages_committed": mem.pages_committed,
        "memos_passes": len(mem.reports),
        "completed": sum(r.error is None for r in reqs),
        "corrupted_tokens": corrupted, "launches": launches,
    }
    reasons = {f for _, f in fallbacks}
    if corrupted or out["completed"] != len(reqs):
        raise RuntimeError(f"plan-fault run: {corrupted} tokens differ "
                           f"{wrong}, {out['completed']} of {len(reqs)} "
                           f"completed")
    if reasons != {"InjectedPlanFault", "timeout"} or "sync" not in rungs \
            or not climbed or mem.ladder.top != RUNG_OVERLAP:
        raise RuntimeError(f"plan-fault run: fallbacks {fallbacks}, rungs "
                           f"{rungs}")
    _check_rope_append(launches, cfg, hist, "overlap_plan_faults")
    _check_launches(launches, PINNED_KERNELS, "overlap_plan_faults")
    return out


def run_batch_padding(cfg, params) -> dict:
    """What padding the decode to ``max_batch`` rows costs, and which op
    needs it.  Two engines serve the same 2 requests, memos off: one with
    ``max_batch`` 8 (each dispatch pads 2 rows to 8), one with 2 (no
    padding); their dispatches alternate and each is timed on the host
    clock around a device sync.  Then each dense op of the decode step
    runs on the first R of 8 random rows, R = 1..8: an op whose row bits
    change with R is batch-variant."""
    import statistics

    import torch
    from repro_torch.models import attention as attn_mod
    from repro_torch.models import layers as L
    from repro_torch.models import transformer as T
    from repro_torch.serving.engine import PagedServingEngine
    prompts = _prompts(2, PARITY_PROMPT_LEN, cfg.vocab, SEED + 4)
    engines = {}
    for rows in (8, 2):
        eng = PagedServingEngine(cfg, params, _serve_config(
            max_batch=rows, memos_enabled=False), device="cuda")
        reqs = [eng.submit(p, PARITY_NEW_TOKENS) for p in prompts]
        eng.step()                              # admission, first dispatch
        engines[rows] = (eng, reqs, [])
    for _ in range(4):
        for eng, _, times in engines.values():
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            eng.step()
            torch.cuda.synchronize()
            times.append(time.perf_counter() - t0)
    for eng, _, _ in engines.values():
        eng.run()
    ms = {rows: statistics.median(t) * 1e3
          for rows, (_, _, t) in engines.items()}

    # which op's row bits depend on the number of rows
    gen = torch.Generator(device="cuda")
    gen.manual_seed(SEED + 6)
    lp = params["layers"][0]
    d = cfg.d_model
    h = torch.randn((8, 1, d), generator=gen, device="cuda").to(
        params["embed"].dtype)
    a = torch.randn((8, cfg.n_heads * cfg.head_dim), generator=gen,
                    device="cuda").to(h.dtype)
    wo = lp["attn"]["wo"]
    z = T.logits_out(params, cfg, h)[:, 0]
    tied = torch.sort(torch.randint(0, cfg.vocab, (8, 2), generator=gen,
                                    device="cuda"), dim=1).values
    z.scatter_(1, tied, z.max().item() + 1)
    ops = {
        "rms_norm": lambda r: L.rms_norm(h[:r], lp["ln1"], eps=cfg.norm_eps,
                                         gemma_style=cfg.gemma_norm),
        "qkv_projection": lambda r: torch.cat([
            t.reshape(r, -1) for t in attn_mod.project_raw(
                lp["attn"], h[:r])], dim=1),
        "wo_matmul": lambda r: a[:r] @ wo.reshape(-1, wo.shape[-1]),
        "ffn_block": lambda r: T.ffn_block(lp, cfg, h[:r])[0],
        "logits": lambda r: T.logits_out(params, cfg, h[:r]),
        # the sampler over logits whose maximum is tied between two
        # columns of every row: the first of the two must win
        "argmax_on_ties": lambda r: torch.argmax(z[:r, :cfg.vocab], dim=-1),
    }
    variant = {}
    for name, op in ops.items():
        full = op(8)
        variant[name] = [r for r in range(1, 8)
                         if not torch.equal(op(r), full[:r])]
    first_wins = torch.equal(ops["argmax_on_ties"](8), tied[:, 0])
    return {"phase": "batch_padding", "requests": len(prompts),
            "prompt_len": PARITY_PROMPT_LEN,
            "new_tokens": PARITY_NEW_TOKENS, "dispatches_timed": 4,
            "dispatch_ms_padded_to_8": ms[8], "dispatch_ms_unpadded": ms[2],
            "padded_over_unpadded": ms[8] / ms[2],
            "tokens_identical": [r.generated for r in engines[8][1]]
            == [r.generated for r in engines[2][1]],
            "batch_variant_ops": {k: v for k, v in variant.items() if v},
            "batch_invariant_ops": [k for k, v in variant.items() if not v],
            "argmax_first_index_on_ties": first_wins}


def _op_log():
    """Wrap the decode step's dense ops and its attention, as the engine
    module calls them, to log every call as (op, input digest per row,
    output).  An attention call's input is its q and the K/V pages its
    table names, digested per row (int16 bit patterns summed), so two
    calls with equal digests read the same bits.  Returns (log, undo)."""
    import torch
    from repro_torch.serving import engine as E
    log, saved = [], []

    def digest(t):
        return t.contiguous().view(torch.int16).reshape(
            t.shape[0], -1).long().sum(dim=1)

    def kv_rows(a):
        if len(a) == 5:                      # q, k_pool, v_pool, bt, lengths
            bt = a[3].long()
            return digest(a[1][bt]) * 3 + digest(a[2][bt])
        q, kf, vf, kp, vp, bt, sel, _ = a   # the dual pool
        s = (sel > 0)[:, :, None, None, None]
        b2 = bt.clamp(0, kp.shape[0] - 1).long().cpu()
        b1 = bt.clamp(0, kf.shape[0] - 1).long()
        k = torch.where(s, kp[b2].to(q.device), kf[b1])
        v = torch.where(s, vp[b2].to(q.device), vf[b1])
        return digest(k) * 3 + digest(v)

    def wrap(mod, name, attention=False):
        f = getattr(mod, name)
        saved.append((mod, name, f))

        def w(*a, **k):
            out = f(*a, **k)
            o = out[0] if isinstance(out, tuple) else out
            x = next(t for t in a if isinstance(t, torch.Tensor))
            x = x.reshape(x.shape[0], -1)
            d = digest(x) * 7 + kv_rows(a) if attention else digest(x)
            log.append((name, d, o.detach().clone()))
            return out
        setattr(mod, name, w)
    for mod, name in ((E.L, "rms_norm"), (E.attn_mod, "project_raw"),
                      (E, "rope_append"), (E.T, "ffn_block"),
                      (E.T, "logits_out")):
        wrap(mod, name)
    wrap(E, "paged_attention_pooled", attention=True)
    wrap(E, "paged_attention_dual_pooled", attention=True)

    def undo():
        for mod, name, f in saved:
            setattr(mod, name, f)
    return log, undo


def _first_variant_op(full: list, part: list, r: int) -> dict | None:
    """The first logged call whose first r rows got equal inputs but
    other output bits than in the full step, and whether any attention
    call did so."""
    import torch
    first, attention = None, 0
    for i, ((op, din, out), (op2, din2, out2)) in enumerate(zip(full, part)):
        if not torch.equal(din[:r], din2):
            continue
        rows = [j for j in range(r) if not torch.equal(out[j], out2[j])]
        if rows:
            attention += op.startswith("paged_attention")
            if first is None:
                first = {"op": op, "call": i, "rows": rows,
                         "values_differ": int((out[:r] != out2).sum())}
    return first and {**first, "attention_calls": attention}


def run_batch_invariance(cfg, params) -> dict:
    """Whether one decode step's bits depend on how many rows share it or
    on a row's place in the batch.  An engine with ``max_batch`` 1 (so
    no zero rows pad the step) decodes 8 rows over random KV in distinct
    pages at the engine runs' contexts, then the first r rows for
    r = 1..7, then all 8 in reverse order: every row's logits and
    sampled token are compared with its own in the 8-row step.  Once
    with every page in HBM (``_decode_core``), once with about half of
    them in the pinned-host pool (``_decode_core_pinned``).  Where a row
    count gives other bits, the step's ops are logged to name the first
    one whose output differs on equal inputs (ROADMAP C5); the phase
    fails if K1 or K1d is ever one that does."""
    import numpy as np
    import torch
    from repro_torch.core.hierarchy import MemoryHierarchy
    from repro_torch.serving.engine import PagedServingEngine
    B, P = 8, 16                 # the engine runs' batch and table width
    gen = torch.Generator(device="cuda")
    gen.manual_seed(SEED + 7)
    rng = np.random.RandomState(SEED + 7)
    lengths = rng.randint(PROMPT_LEN + 1, PROMPT_LEN + NEW_TOKENS + 1,
                          size=B)
    out = {"phase": "batch_invariance", "rows": B, "pages_per_row": P,
           "contexts": lengths.tolist()}
    for path in ("hbm", "dual_pool"):
        eng = PagedServingEngine(cfg, params, _serve_config(
            max_batch=1, fast_slots=B * P, slow_slots=B * P,
            memos_enabled=False, hierarchy=MemoryHierarchy.two_tier(
                B * P, B * P, pinned_slow=path == "dual_pool")),
            device="cuda")
        pools = [eng.kv.store.fast_pool]
        slots = rng.permutation(B * P).reshape(B, P)
        cols = [rng.randint(0, cfg.vocab, B), lengths - 1, slots, lengths]
        if path == "dual_pool":
            pools.append(eng.kv.store.pools[1].data)
            cols.append((rng.rand(B, P) < 0.5).astype(np.int32))
        for pool in pools:
            pool.copy_(torch.randn(pool.shape, generator=gen, device="cuda",
                                   dtype=torch.float32).to(pool.dtype))
        cols = [torch.from_numpy(a.astype(np.int32)).to("cuda")
                for a in cols]
        remap = torch.arange(B * P, dtype=torch.int32, device="cuda")

        def step(rows, eng=eng, cols=cols, path=path, remap=remap):
            rows = torch.tensor(rows, device="cuda")
            tok, pos, bt, lens, *sel = (c[rows].contiguous() for c in cols)
            if path == "hbm":
                return eng._decode_core(tok, pos, bt, lens)[0]
            return eng._decode_core_pinned(tok, pos, bt, sel[0], lens,
                                           remap)[0]

        full = step(list(range(B)))
        sampled = torch.argmax(full[:, :cfg.vocab], dim=-1)
        bits, tokens = [], []
        for r in range(1, B):
            part = step(list(range(r)))
            if not torch.equal(part, full[:r]):
                bits.append(r)
            if not torch.equal(torch.argmax(part[:, :cfg.vocab], dim=-1),
                               sampled[:r]):
                tokens.append(r)
        first = {}
        if bits:
            log, undo = _op_log()
            try:
                step(list(range(B)))
                full_log = list(log)
                for r in bits:
                    log.clear()
                    step(list(range(r)))
                    first[r] = _first_variant_op(full_log, list(log), r)
            finally:
                undo()
            del log, full_log
        out[path] = {
            "row_counts_with_other_bits": bits,
            "row_counts_with_other_tokens": tokens,
            "first_op_with_other_bits_on_equal_inputs": first,
            "reversed_order_identical": torch.equal(
                step(list(range(B))[::-1]), full.flip(0)),
            "finite": bool(torch.isfinite(full.float()).all())}
        if any(f and f["attention_calls"] for f in first.values()):
            raise RuntimeError(f"batch_invariance ({path}): paged attention "
                               f"gave other bits on equal inputs: {first}")
        del eng, pools
    return out


def run_profiled_window(cfg, params, pinned: bool = False,
                        parent: bool = False) -> dict:
    """Two fused dispatches of a fresh engine under ``torch.profiler``
    (device activity only): the device's busy share of the host wall
    time, from the union of the kernel and copy intervals it traced, and
    the device operations per decode inner step.  With ``pinned`` the
    engine serves the engine run's requests over the pinned-host tier
    and the window opens once pages sit there, so both dispatches take
    the dual-pool path.  With ``parent`` (one pool only) the engine's
    ``qkv_rope_append`` is replaced by the parent tree's eager ops
    (``_parent_rope_append``): the op count the fused kernel replaced.
    Head-shaped rms_norm/apply_rope calls outside the kernel are counted
    and must be 0 on the kernel's path."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.core.hierarchy import MemoryHierarchy
    from repro_torch.serving import engine as E
    from repro_torch.serving.engine import PagedServingEngine
    if pinned:
        scfg = _serve_config(hierarchy=MemoryHierarchy.two_tier(
            64, 512, pinned_slow=True))
        prompts = _prompts(REQUESTS, PROMPT_LEN, cfg.vocab, SEED)
        new = NEW_TOKENS
    else:
        scfg = _serve_config()
        prompts = _prompts(scfg.max_batch, PARITY_PROMPT_LEN, cfg.vocab,
                           SEED + 3)
        new = PARITY_NEW_TOKENS
    eng = PagedServingEngine(cfg, params, scfg, device="cuda")
    for p in prompts:
        eng.submit(p, new)
    eng.step()                                  # admission, first dispatch
    while pinned and eng.kv.store.tier_used()[1] == 0 \
            and not eng.batcher.all_done():
        eng.step()
    torch.cuda.synchronize()
    fused = E.rope_append
    if parent:
        E.rope_append = _parent_rope_append()
    try:
        with _QkOps(cfg.head_dim) as qk, \
                profile(activities=[ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            ks = [eng.step().get("decode_block", 0) for _ in range(2)]
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
    finally:
        E.rope_append = fused
    if not parent and qk.calls:
        raise RuntimeError(f"profiled window: {qk.calls} qk-norm/RoPE ops "
                           f"ran outside qkv_rope_append")
    spans = sorted((e.time_range.start, e.time_range.end)
                   for e in prof.events()
                   if e.device_type == torch.autograd.DeviceType.CUDA)
    busy_us, end = 0.0, float("-inf")
    for a, b in spans:                  # union of possibly overlapping spans
        if b > end:
            busy_us += b - max(a, end)
            end = b
    return {"phase": "profiled_window" + ("_pinned" if pinned else "")
            + ("_parent_ops" if parent else ""),
            "dispatches": 2, "inner_steps": ks,
            "batch": scfg.max_batch, "wall_s": wall,
            "device_events": len(spans),
            "device_ops_per_inner_step": len(spans) / max(sum(ks), 1),
            "qk_norm_rope_ops": qk.calls,
            "device_busy_s": busy_us * 1e-6,
            "device_busy_share": busy_us * 1e-6 / wall if spans else None}


def run_card_vs_cpu() -> dict:
    """A small float32 engine stepped on the card and on the CPU from the
    same weights and prompts: the first dispatches' logits agree within
    1e-3 and the integer state matches exactly."""
    import numpy as np
    import torch
    from repro_torch.configs.base import registry, smoke
    from repro_torch.models.transformer import init_params
    from repro_torch.serving.engine import PagedServingEngine
    cfg = smoke(registry()["qwen3_4b"])
    params = init_params(cfg, seed=SEED, dtype=torch.float32,
                         device="cuda")

    cpu_params = _to_device(params, "cpu")
    prompts = _prompts(3, 6, cfg.vocab, SEED + 2)
    engines = []
    for dev, p in (("cuda", params), ("cpu", cpu_params)):
        eng = PagedServingEngine(
            cfg, p, _serve_config(page_size=4, max_batch=3, fast_slots=8,
                                  slow_slots=64, max_pages_per_seq=8,
                                  memos_interval=2, reference=True),
            device=dev)
        for pr in prompts:
            eng.submit(pr, 4)
        engines.append(eng)
    max_err = 0.0
    for _ in range(3):        # prompt replay: identical inputs each step
        logits = []
        for eng in engines:
            eng.step()
            logits.append(eng.last_logits.float().cpu())
        max_err = max(max_err, float((logits[0] - logits[1]).abs().max()))
        if not torch.allclose(logits[0], logits[1], atol=1e-3, rtol=1e-3):
            raise RuntimeError(f"card vs CPU logits differ by {max_err}")
    g, c = engines
    for f in g.sysmon._fields:
        if not np.array_equal(getattr(g.sysmon, f).cpu().numpy(),
                              getattr(c.sysmon, f).numpy()):
            raise RuntimeError(f"card vs CPU SysMon differs in {f}")
    if not (np.array_equal(g.kv.store.tier, c.kv.store.tier)
            and np.array_equal(g.kv.store.slot, c.kv.store.slot)):
        raise RuntimeError("card vs CPU page tables differ")
    return {"phase": "card_vs_cpu", "arch": cfg.name, "steps": 3,
            "logits_max_abs_err": max_err, "tolerance": 1e-3}


# =============================================================================
# phases 10-13: bucketed packed prefill and the int8 tiers
# =============================================================================

def _watch_prefill(eng) -> dict:
    """What happens inside the engine's prefill dispatches: wraps the
    engine's ``_prefill_group`` and adds up the kernel launches and the
    deepest tier's wear writes made inside each call."""
    from repro_torch import kernels
    seen = {"launches": dict.fromkeys(kernels.KERNELS, 0),
            "slow_wear_writes": 0}
    wear = eng.kv.store.wear
    orig = eng._prefill_group

    def watched(group):
        l0, w0 = kernels.launch_counts(), wear.writes_total
        orig(group)
        for k, n in kernels.launch_counts().items():
            seen["launches"][k] += n - l0[k]
        seen["slow_wear_writes"] += wear.writes_total - w0
    eng._prefill_group = watched
    return seen


def _first_difference(wrong: dict) -> dict | None:
    """The earliest generated position (then request) where tokens
    differ, from ``_corrupted_tokens``'s {request: first position}."""
    if not wrong:
        return None
    rid, pos = min(wrong.items(), key=lambda kv: (kv[1], kv[0]))
    return {"request": rid, "position": pos}


def _serve_prefill_run(cfg, params, phase: str, scfg, want, *,
                       fault_cfg=None) -> tuple[dict, dict, object, list]:
    """Serve the engine run's 12 requests with ``scfg`` (prefill on),
    the launch counts read around the run and the prefill dispatches
    watched.  ``want`` holds the tokens the run is compared with; the
    count of tokens that differ is reported, not checked.  With
    ``fault_cfg`` the injector is armed (page integrity on)."""
    import statistics

    import torch
    from repro_torch import faults, kernels, obs
    from repro_torch.models.transformer import pad_vocab
    from repro_torch.serving.engine import PagedServingEngine
    if fault_cfg is not None:
        faults.configure(fault_cfg)
    try:
        eng = PagedServingEngine(cfg, params, scfg, device="cuda")
        watch = _watch_prefill(eng)
        reqs = [eng.submit(p, NEW_TOKENS)
                for p in _prompts(REQUESTS, PROMPT_LEN, cfg.vocab, SEED)]
        torch.cuda.synchronize()
        obs.reset()
        obs.configure(trace=True)
        kernels.reset_launch_counts()
        with _QkOps(cfg.head_dim) as qk:
            t0 = time.perf_counter()
            hist = eng.run()
            torch.cuda.synchronize()
            dt = time.perf_counter() - t0
        launches = kernels.launch_counts()
        obs.configure(trace=False)
    finally:
        faults.reset()
    store = eng.kv.store
    wear = store.wear
    ttft = sorted(r.ttft_s for r in reqs)
    differ, wrong = _corrupted_tokens(reqs, want)
    inner = sum(h.get("decode_block", 0) for h in hist)
    out = {
        "phase": phase, "arch": cfg.name, "n_layers": cfg.n_layers,
        "d_model": cfg.d_model, "dtype": "bfloat16",
        "hierarchy": store.hierarchy.describe(),
        "requests": len(reqs), "prompt_len": PROMPT_LEN,
        "new_tokens": NEW_TOKENS, "generated": eng.tokens_out,
        "seconds": dt, "generated_tokens_per_s": eng.tokens_out / dt,
        "decode_dispatches": sum(1 for h in hist if "decode_block" in h),
        "decode_inner_steps": inner,
        "prefill_dispatches": int(obs.get_registry().counter(
            "serving.prefill_dispatches").value),
        "prefill_launches": {k: v for k, v in watch["launches"].items()
                             if v},
        # wear the prefill dispatches charged to the NVM tier (their
        # appends into a pinned tier, and demotions made to provision)
        "prefill_slow_wear_writes": watch["slow_wear_writes"],
        "ttft_s_p50": statistics.median(ttft),
        "ttft_s_p99": ttft[min(len(ttft) - 1,
                               int(round(0.99 * (len(ttft) - 1))))],
        "memos_passes": len(eng.memos.reports),
        "preemptions": eng.batcher.n_preempted,
        "traffic_0_1_bytes": store.traffic[(0, 1)],
        "traffic_1_0_bytes": store.traffic[(1, 0)],
        "slow_wear_max": wear.max_wear(), "slow_writes": wear.writes_total,
        "tokens_differ": differ, "first_difference": _first_difference(wrong),
        "launches": launches,
        # head-shaped rms_norm/apply_rope calls outside qkv_rope_append
        "qk_norm_rope_ops": qk.calls,
        "span_seconds": {**dict.fromkeys(("serve.prefill", "serve.dispatch",
                                          "migrate.move_group"), 0.0),
                         **_span_seconds()},
    }
    bad = [r.rid for r in reqs
           if r.error is not None or len(r.generated) != NEW_TOKENS]
    if bad:
        raise RuntimeError(f"{phase}: requests {bad} did not complete")
    if not torch.isfinite(eng.last_logits.float()).all() \
            or eng.last_logits.shape[-1] != pad_vocab(cfg.vocab):
        raise RuntimeError(f"{phase}: last logits non-finite or misshapen")
    if not out["prefill_dispatches"]:
        raise RuntimeError(f"{phase}: no prefill dispatch ran")
    if qk.calls:
        raise RuntimeError(f"{phase}: {qk.calls} qk-norm/RoPE ops ran "
                           f"outside qkv_rope_append")
    _check_rope_append(launches, cfg, hist, phase,
                       out["prefill_dispatches"])
    return out, launches, eng, [r.generated for r in reqs]


def run_prefill(cfg, params, replay_tokens) -> tuple[dict, dict, list]:
    """Phase 10: the engine run's requests with ``prefill=True`` over the
    numpy host tier.  Each prefill dispatch must launch K1's prefill body
    and the KV append once per layer over the bucket's rows, and never
    the decode body; the tokens that differ from the replaying engine run
    are reported."""
    out, launches, eng, toks = _serve_prefill_run(
        cfg, params, "prefill", _serve_config(prefill=True), replay_tokens)
    pl = out["prefill_launches"]
    n = cfg.n_layers * out["prefill_dispatches"]
    if pl.get("paged_attention_prefill") != n \
            or pl.get("qkv_rope_append") != n or pl.get("paged_attention"):
        raise RuntimeError(f"prefill: {n} launches of K1's prefill body and "
                           f"of qkv_rope_append (and none of K1's decode "
                           f"body) expected inside the prefill dispatches, "
                           f"got {pl}")
    _check_launches(launches, PREFILL_KERNELS, "prefill")
    for key in ("traffic_0_1_bytes", "traffic_1_0_bytes", "slow_wear_max"):
        if not out[key]:
            raise RuntimeError(f"prefill run has {key} == 0")
    out["probe_bf16"] = run_prefill_probe(cfg, params)
    for row in out["probe_bf16"]:
        if max(row["kv_max_abs_err"], row["logits_max_abs_err"]) \
                > PROBE_BF16_MAX_ERR:
            raise RuntimeError(f"prefill probe (bf16): error past "
                               f"{PROBE_BF16_MAX_ERR}: {row}")
    # the same probe on float32 weights drawn from the same seed: there
    # the prefill and the replay must agree within PROBE_F32_TOL, and a
    # prefill in TF32 must not
    import torch
    from repro_torch import kernels
    from repro_torch.models.transformer import init_params
    f32 = init_params(cfg, seed=SEED, dtype=torch.float32, device="cuda")
    kernels.reset_launch_counts()
    out["probe_f32"] = run_prefill_probe(cfg, f32, tf32_control=True)
    out["probe_f32_launches"] = {k: n for k, n in
                                 kernels.launch_counts().items() if n}
    if not out["probe_f32_launches"].get("paged_attention_prefill"):
        raise RuntimeError(f"prefill probe (float32): no launch of K1's "
                           f"float32 prefill body: "
                           f"{out['probe_f32_launches']}")
    del f32
    torch.cuda.empty_cache()
    for row in out["probe_f32"]:
        if row["kv_values_outside_tol"] or row["logits_outside_tol"]:
            raise RuntimeError(f"prefill probe (float32): KV pages or "
                               f"first-token logits differ: {row}")
        ctl = row["tf32_control"]
        if not (ctl["kv_values_outside_tol"] or ctl["logits_outside_tol"]):
            raise RuntimeError(f"prefill probe (float32): a TF32 prefill "
                               f"passes the {PROBE_F32_TOL} limit: {row}")
    return out, launches, toks


def _probe_prefill(cfg, params, prompt):
    """A fresh engine, memos off, that ingests ``prompt`` in one prefill
    dispatch (the engine's admission, then ``_prefill_admitted``)."""
    import torch
    from repro_torch.serving.engine import PagedServingEngine
    eng = PagedServingEngine(cfg, params, _serve_config(
        prefill=True, memos_enabled=False), device="cuda")
    req = eng.submit(prompt, NEW_TOKENS)
    eng.batcher.admit()
    eng._prefill_admitted()
    torch.cuda.synchronize()
    return eng, req


def _probe_errors(cfg, ref, rr, eng, req, tol) -> dict:
    """The prompt's KV pages and the last logits of ``eng`` against the
    replay ``ref``: maximum errors (KV per layer too) and the values
    outside atol = rtol = ``tol`` (allclose's test)."""
    import torch
    n_pages = PROMPT_LEN // _serve_config().page_size
    kv_r, kv = (e.kv.store.fast_pool[torch.as_tensor(
        e.kv.store.slot[r.pages[:n_pages]])].float()
        for e, r in ((ref, rr), (eng, req)))
    la, lb = (e.last_logits[0, :cfg.vocab].float() for e in (ref, eng))
    err = (kv_r - kv).abs()                     # [pages, L, 2, page, ...]
    return {"kv_max_abs_err": float(err.max()),
            "kv_max_abs_err_by_layer": [
                round(float(e), 6) for e in err.transpose(0, 1)
                .reshape(cfg.n_layers, -1).max(dim=1).values],
            "kv_values_outside_tol": int((err > tol * (1 + kv.abs()))
                                         .sum()),
            "kv_values": err.numel(),
            "logits_max_abs_err": float((la - lb).abs().max()),
            "logits_outside_tol": int(((la - lb).abs()
                                       > tol * (1 + lb.abs())).sum()),
            "tolerance": tol}


def run_prefill_probe(cfg, params, tf32_control: bool = False
                      ) -> list[dict]:
    """Two of the prompts, each on fresh engines, memos off: prompt
    replay through the K=1 reference path against one prefill dispatch.
    A first token that differs fails unless the replay's top-2 logit
    margin is within ``PROBE_TIE_MARGIN`` (a near tie).  Each row holds
    the KV-page and first-token-logit errors (``_probe_errors``, limit
    ``PROBE_F32_TOL``); the caller gates them.  ``tf32_control`` adds the
    same prefill with TF32 matmuls against the same replay."""
    import torch
    from repro_torch.serving.engine import PagedServingEngine
    rows = []
    for i, prompt in enumerate(_prompts(2, PROMPT_LEN, cfg.vocab, SEED)):
        ref = PagedServingEngine(cfg, params, _serve_config(
            reference=True, memos_enabled=False), device="cuda")
        rr = ref.submit(prompt, NEW_TOKENS)
        while not rr.generated:
            ref.step()
        pre, rp = _probe_prefill(cfg, params, prompt)
        top2 = torch.topk(ref.last_logits[0, :cfg.vocab].float(), 2).values
        margin = float(top2[0] - top2[1])
        row = {"prompt": i, "dtype": str(params["embed"].dtype),
               **_probe_errors(cfg, ref, rr, pre, rp, PROBE_F32_TOL),
               "replay_first_token": rr.generated[0],
               "prefill_first_token": rp.generated[0],
               "replay_top2_margin": margin}
        del pre
        if tf32_control:
            torch.backends.cuda.matmul.allow_tf32 = True
            try:
                ctl, rc = _probe_prefill(cfg, params, prompt)
            finally:
                torch.backends.cuda.matmul.allow_tf32 = False
            row["tf32_control"] = {
                k: v for k, v in _probe_errors(
                    cfg, ref, rr, ctl, rc, PROBE_F32_TOL).items()
                if k != "kv_max_abs_err_by_layer"}
            del ctl
        rows.append(row)
        if rr.generated[0] != rp.generated[0] and margin > PROBE_TIE_MARGIN:
            raise RuntimeError(f"prefill probe: first token differs off a "
                               f"near tie: {row}")
        del ref
    return rows


def run_prefill_pinned(cfg, params, prefill_tokens) -> tuple[dict, dict]:
    """Phase 11: the same requests with prefill over the pinned-host
    tier, no faults; the tokens that differ from phase 10 are reported.
    With 64 HBM slots the 8 admitted prompts fill HBM exactly (8 pages
    each), so these prefills never touch the pinned tier; a second run
    with HBM cut to 8 slots puts prompt pages there, and K1d and the KV
    append must launch inside its prefill dispatches and its prefill
    must charge pinned wear; its decode runs K1d's decode body."""
    from repro_torch.core.hierarchy import MemoryHierarchy
    out, launches, _, _ = _serve_prefill_run(
        cfg, params, "prefill_pinned", _serve_config(
            prefill=True, hierarchy=MemoryHierarchy.two_tier(
                64, 512, pinned_slow=True)), prefill_tokens)
    _check_launches(launches, ("paged_attention", "paged_attention_prefill",
                               "qkv_rope_append", "touch_update",
                               "wear_update", "sysmon_pass"),
                    "prefill_pinned")
    dual, dual_launches, _, _ = _serve_prefill_run(
        cfg, params, "prefill_pinned_hbm8", _serve_config(
            prefill=True, fast_slots=8, hierarchy=MemoryHierarchy.two_tier(
                8, 512, pinned_slow=True)), prefill_tokens)
    pl = dual["prefill_launches"]
    n = cfg.n_layers * dual["prefill_dispatches"]
    if pl.get("paged_attention_prefill_dual") != n \
            or pl.get("qkv_rope_append") != n \
            or pl.get("paged_attention_dual") or pl.get("paged_attention"):
        raise RuntimeError(f"prefill_pinned: {n} launches of K1d's prefill "
                           f"body and of qkv_rope_append must run inside the "
                           f"prefill dispatches, the decode bodies never: "
                           f"{pl}")
    if dual_launches["paged_attention_dual"] \
            <= pl.get("paged_attention_dual", 0):
        raise RuntimeError("prefill_pinned: K1d's decode body never ran in "
                           "the decode")
    if not dual["prefill_slow_wear_writes"]:
        raise RuntimeError("prefill_pinned: the prefill dispatches charged "
                           "no pinned wear")
    out["hbm8_run"] = {k: dual[k] for k in (
        "hierarchy", "seconds", "generated_tokens_per_s",
        "prefill_dispatches", "prefill_launches",
        "prefill_slow_wear_writes", "ttft_s_p50",
        "ttft_s_p99", "slow_wear_max", "slow_writes", "tokens_differ",
        "first_difference", "launches")}
    return out, launches

def _nvm_bytes(store):
    """The NVM tier's int8 rows and scales at every logical slot (read
    through the wear remap), as numpy."""
    import numpy as np
    pool = store.pools[store.hierarchy.deepest]
    q = pool.raw() if hasattr(pool, "raw") else pool.data
    sc = pool.scale if isinstance(pool.scale, np.ndarray) \
        else pool.scale.numpy()
    phys = store.wear.phys(np.arange(q.shape[0]))
    return q[phys], sc[phys]


def run_int8(cfg, params, prefill_tokens):
    """Phases 12 and 13: the requests with prefill over the int8 numpy
    host tier, then over the int8 pinned tier (integrity armed, no
    faults, so K5 sums the 1-byte pages).  Both promote before they
    attend and quantize with K6, so the pinned run must emit the host
    run's tokens exactly and leave the same int8 bytes and scales at
    every logical slot; the tokens that differ from phase 10 (lossless)
    are what int8 costs in output quality, reported only.  Returns
    (host line, host launches, pinned line, pinned launches, pinned
    engine)."""
    import numpy as np
    from repro_torch.core.hierarchy import MemoryHierarchy
    from repro_torch.faults import FaultConfig
    host, host_launches, heng, htoks = _serve_prefill_run(
        cfg, params, "int8_host", _serve_config(
            prefill=True, hierarchy=MemoryHierarchy.two_tier(
                64, 512, quantize_slow=True)), prefill_tokens)
    _check_launches(host_launches, INT8_HOST_KERNELS, "int8_host")
    for key in ("traffic_0_1_bytes", "traffic_1_0_bytes", "slow_wear_max"):
        if not host[key]:
            raise RuntimeError(f"int8_host run has {key} == 0")
    pinned, pin_launches, peng, _ = _serve_prefill_run(
        cfg, params, "int8_pinned", _serve_config(
            prefill=True, hierarchy=MemoryHierarchy.two_tier(
                64, 512, pinned_slow=True, quantize_slow=True)), htoks,
        fault_cfg=FaultConfig(seed=FAULT_SEED))
    _check_launches(pin_launches, INT8_PINNED_KERNELS, "int8_pinned")
    if peng.pinned_tier is not None:
        raise RuntimeError("int8_pinned: the int8 tier was served in place")
    if pinned["tokens_differ"]:
        raise RuntimeError(f"int8_pinned: {pinned['tokens_differ']} tokens "
                           f"differ from int8_host, first "
                           f"{pinned['first_difference']}")
    hq, hs = _nvm_bytes(heng.kv.store)
    pq, ps = _nvm_bytes(peng.kv.store)
    rows_differ = int((hq != pq).reshape(len(hq), -1).any(1).sum()
                      + (hs != ps).sum())
    if rows_differ:
        raise RuntimeError(f"int8_pinned: NVM int8 bytes or scales differ "
                           f"from int8_host ({rows_differ} differences)")
    pinned["nvm_bytes_and_scales_identical_to_int8_host"] = True
    pinned["quarantined_slots"] = sum(
        len(q) for q in peng.kv.store.quarantined.values())
    if pinned["quarantined_slots"]:
        raise RuntimeError("int8_pinned: a fault-free run quarantined slots")
    return host, host_launches, pinned, pin_launches, peng


# =============================================================================
# phase 9: every kernel against its plain version
# =============================================================================

def _attn_bf16_accumulating(q, k_pool, v_pool, bt, lengths):
    """The plain attention with softmax.V summed page by page into a bf16
    accumulator: what a kernel body that accumulates in bf16 returns.
    ``ATTN_TOL`` must reject it."""
    import torch
    B, Hkv, G, D = q.shape
    page, P = k_pool.shape[1], bt.shape[1]
    k = k_pool[bt.long()].reshape(B, P * page, Hkv, D).float()
    v = v_pool[bt.long()].reshape(B, P * page, Hkv, D).float()
    s = torch.einsum("bhgd,bkhd->bhgk", q.float(), k)
    pos = torch.arange(P * page, device=q.device)
    s = s.masked_fill(pos >= lengths.long()[:, None, None, None], -1e30)
    pv = torch.einsum("bhgk,bkhd->bhgkd", torch.softmax(s, dim=-1), v)
    pv = pv.reshape(B, Hkv, G, P, page, D).sum(dim=4)
    acc = torch.zeros_like(q)
    for j in range(P):
        acc = (acc.float() + pv[:, :, :, j]).to(q.dtype)
    return acc


def bench_kernels(cfg, eng, launches: dict) -> list[dict]:
    import numpy as np
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels import hotness_update as K2
    from repro_torch.kernels import page_gather as K3
    from repro_torch.kernels import paged_attention as K1
    from repro_torch.kernels import wear_update as K4

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev)
    gen.manual_seed(SEED)
    rng = np.random.RandomState(SEED)
    scfg = eng.scfg
    store = eng.kv.store
    pool = store.fast_pool                       # [slots, L, 2, page, Hkv, D]
    n_slots, page = pool.shape[0], scfg.page_size
    B, P = scfg.max_batch, scfg.max_pages_per_seq
    Hq, Hkv, D = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    G = Hq // Hkv
    # refill the pool with random bf16 KV (the run freed every page)
    pool.copy_(torch.randn(pool.shape, generator=gen, device=dev,
                           dtype=torch.float32).to(pool.dtype))
    rows = []

    def row(name, src, replaces, err, ms, plain_ms, nbytes, flops,
            library_ms, tol):
        bound, by = _bound_ms(nbytes, flops)
        rows.append({"name": name, "route": "cuda", "source": src,
                     "replaces": replaces, "launches": launches[name],
                     "max_abs_err": err, "tolerance": tol, "ms": ms,
                     "plain_ms": plain_ms, "bound_ms": bound,
                     "bound_by": by, "library_ms": library_ms})

    # -- K1: one layer's attention, batch B, contexts the run reached -------
    k_pool, v_pool = pool[:, 0, 0], pool[:, 0, 1]
    ctx_max = PROMPT_LEN + NEW_TOKENS
    lengths_np = rng.randint(PROMPT_LEN + 1, ctx_max + 1, size=B)
    bt_np = np.stack([rng.permutation(n_slots)[:P] for _ in range(B)])
    bt = torch.from_numpy(bt_np.astype(np.int32)).to(dev)
    lengths = torch.from_numpy(lengths_np.astype(np.int32)).to(dev)
    q = (torch.randn((B, Hkv, G, D), generator=gen, device=dev)
         * D ** -0.5).to(pool.dtype)
    out_k = K1.paged_attention_pooled(q, k_pool, v_pool, bt, lengths)
    out_p = K1.paged_attention_plain(q, k_pool, v_pool, bt, lengths)
    torch.cuda.synchronize()
    if not torch.allclose(out_k.float(), out_p.float(), atol=ATTN_TOL,
                          rtol=ATTN_TOL):
        raise RuntimeError("paged_attention kernel disagrees with plain")
    err = float((out_k.float() - out_p.float()).abs().max())
    foil = _attn_bf16_accumulating(q, k_pool, v_pool, bt, lengths).float()
    foil_err = float((foil - out_p.float()).abs().max())
    if torch.allclose(foil, out_p.float(), atol=ATTN_TOL, rtol=ATTN_TOL):
        raise RuntimeError(f"ATTN_TOL {ATTN_TOL} accepts a bf16-accumulating "
                           f"attention (max abs err {foil_err})")
    live = int(lengths_np.sum())
    nbytes = (2 * B * Hq * D * 2 + 2 * live * Hkv * D * 2
              + bt.numel() * 4 + B * 4)
    flops = 4.0 * Hq * D * live
    # yardstick: SDPA over the same KV gathered contiguous (not timed)
    S = P * page
    kc = k_pool[bt.long()].reshape(B, S, Hkv, D).transpose(1, 2).contiguous()
    vc = v_pool[bt.long()].reshape(B, S, Hkv, D).transpose(1, 2).contiguous()
    kc = kc.repeat_interleave(G, dim=1)
    vc = vc.repeat_interleave(G, dim=1)
    q4 = q.reshape(B, Hq, 1, D)
    mask = (torch.arange(S, device=dev)[None, :]
            < lengths[:, None])[:, None, None, :]
    row("paged_attention", "src/repro_torch/kernels/csrc/paged_attention.cu",
        "src/repro/kernels/paged_attention/paged_attention.py:75",
        err, _time_ms(lambda: K1.paged_attention_pooled(q, k_pool, v_pool, bt,
                                                   lengths)),
        _time_ms(lambda: K1.paged_attention_plain(q, k_pool, v_pool, bt,
                                                  lengths)),
        nbytes, flops,
        _time_ms(lambda: F.scaled_dot_product_attention(
            q4, kc, vc, attn_mask=mask, scale=1.0)), ATTN_TOL)
    rows[-1].update(
        bf16_accumulating_max_abs_err=foil_err,
        device_ms=_graph_ms(lambda: K1.paged_attention_pooled(
            q, k_pool, v_pool, bt, lengths)),
        library_device_ms=_graph_ms(lambda: F.scaled_dot_product_attention(
            q4, kc, vc, attn_mask=mask, scale=1.0)),
        library_call="scaled_dot_product_attention, KV gathered contiguous "
                     "and expanded to Hq heads outside the timing",
        note="ms, library_ms: CUDA events around eager calls (host work "
             "included); *device_ms: per call of a CUDA graph of 50 calls",
        plan=_plan(False, False, pool.dtype, B, Hkv, G, D))

    # -- K2: the two samplings of an inner step: reads over B*P block-table
    # entries, then one write per sequence on its tail page -------------
    n_pages = eng.kv.n_pages
    ids = torch.from_numpy(rng.randint(0, n_pages, size=B * P)
                           .astype(np.int32)).to(dev)
    r = torch.from_numpy((rng.rand(B * P) < 0.7).astype(np.int32)).to(dev)
    w = torch.zeros_like(r)
    tail = torch.from_numpy(rng.permutation(n_pages)[:B].astype(np.int32)
                            ).to(dev)
    ones = torch.ones(B, dtype=torch.int32, device=dev)
    for sample in ((ids, r, w), (tail, torch.zeros_like(ones), ones)):
        got = K2.touch_update_events(n_pages, *sample)
        want = K2.touch_update_plain(n_pages, *sample)
        torch.cuda.synchronize()
        if not all(torch.equal(a, b) for a, b in zip(got, want)):
            raise RuntimeError("touch_update kernel disagrees with plain")
    # SysMon's form: raw ids, a valid mask and an is_write flag, the
    # normalisation inside the kernel, against the CPU path's
    valid = torch.from_numpy(np.random.RandomState(SEED + 2).rand(B * P)
                             < 0.7).to(dev)
    got = K2.touch_update(n_pages, ids, False, valid)
    want = K2.touch_update(n_pages, ids.cpu(), False, valid.cpu())
    if not all(torch.equal(a.cpu(), b) for a, b in zip(got, want)):
        raise RuntimeError("touch_update (SysMon's form) disagrees with "
                           "plain")
    z = torch.zeros(n_pages, dtype=torch.int32, device=dev)

    def events():
        return K2.touch_update_events(n_pages, ids, r, w)

    def sysmon():
        return K2.touch_update(n_pages, ids, False, valid)

    def library():
        return z.index_add_(0, ids, r)

    row("touch_update", "src/repro_torch/kernels/csrc/touch_update.cu",
        "src/repro/kernels/hotness_update/hotness_update.py:118", 0,
        _time_ms(events),
        _time_ms(lambda: K2.touch_update_plain(n_pages, ids, r, w)),
        3 * ids.numel() * 4 + 3 * n_pages * 4, 0.0, _time_ms(library), 0)
    k2 = rows[-1]
    k2.update(
        library_factor=k2["ms"] / k2["library_ms"],
        sysmon_ms=_time_ms(sysmon), device_ms=_graph_ms(events),
        sysmon_device_ms=_graph_ms(sysmon),
        library_device_ms=_graph_ms(library),
        launches_per_call=_graph_launches(events),
        sysmon_launches_per_call=_graph_launches(sysmon),
        events=ids.numel(), n_pages=n_pages,
        host_us={
            "events": _host_us(events), "sysmon": _host_us(sysmon),
            "index_add_": _host_us(library)},
        note="ms, sysmon_ms, library_ms: CUDA events around eager calls "
             "(host work included); *device_ms: per call of a CUDA graph "
             "of 50 captured calls; launches_per_call: device work nodes "
             "in a graph of one call; host_us: host microseconds per "
             "call")
    if k2["launches_per_call"] != 1 or k2["sysmon_launches_per_call"] != 1:
        raise RuntimeError(f"touch_update is not one launch per call: {k2}")

    # -- K3: a demotion-sized batch (pow2-padded) of whole KV pages --------
    k_mig = 16
    idx_np = rng.permutation(n_slots)[:k_mig - 2]
    idx_np = np.concatenate([idx_np, idx_np[-1:], idx_np[-1:]])
    idx = torch.from_numpy(idx_np.astype(np.int32)).to(dev)
    page_bytes = pool[0].numel() * pool.element_size()
    n_unique = len(np.unique(idx_np))    # the repeats move no new page
    staged = K3.page_gather(pool, idx)
    plain = K3.page_gather_plain(pool, idx)
    torch.cuda.synchronize()
    if not torch.equal(staged, plain):
        raise RuntimeError("page_gather kernel disagrees with plain")
    row("page_gather", "src/repro_torch/kernels/csrc/page_gather.cu",
        "src/repro/kernels/page_gather/page_gather.py:32", 0,
        _time_ms(lambda: K3.page_gather(pool, idx)),
        _time_ms(lambda: K3.page_gather_plain(pool, idx)),
        (n_unique + k_mig) * page_bytes + k_mig * 4, 0.0,
        _time_ms(lambda: pool.index_select(0, idx)), 0)
    # scatter into a scratch copy so the engine's pool stays intact
    target = pool.clone()
    want_pool = pool.clone()
    pages = torch.randn(staged.shape, generator=gen, device=dev).to(
        pool.dtype)
    pages[-2:] = pages[k_mig - 3]          # the pow2 repeats carry one page
    K3.page_scatter(target, idx, pages)
    K3.page_scatter_plain(want_pool, idx, pages)
    torch.cuda.synchronize()
    if not torch.equal(target, want_pool):
        raise RuntimeError("page_scatter kernel disagrees with plain")
    idx64 = idx.long()
    row("page_scatter", "src/repro_torch/kernels/csrc/page_gather.cu",
        "src/repro/kernels/page_gather/page_gather.py:53", 0,
        _time_ms(lambda: K3.page_scatter(target, idx, pages)),
        _time_ms(lambda: K3.page_scatter_plain(target, idx, pages)),
        2 * n_unique * page_bytes + k_mig * 4, 0.0,
        _time_ms(lambda: target.index_copy_(0, idx64, pages)), 0)
    del target, want_pool

    # -- K4: one flush of 128 bucketed wear events -------------------------
    n_slow = store.wear.n_slots
    wid = torch.from_numpy(rng.randint(0, n_slow, size=128)
                           .astype(np.int32)).to(dev)
    amt = torch.from_numpy(rng.randint(0, 4, size=128)
                           .astype(np.int32)).to(dev)
    base = torch.from_numpy(rng.randint(0, 100, size=n_slow)
                            .astype(np.int32)).to(dev)
    got = K4.wear_update_events(base.clone(), wid, amt)
    want = K4.wear_update_plain(base.clone(), wid, amt)
    torch.cuda.synchronize()
    if not torch.equal(got, want):
        raise RuntimeError("wear_update kernel disagrees with plain")
    wbuf = base.clone()
    row("wear_update", "src/repro_torch/kernels/csrc/wear_update.cu",
        "src/repro/kernels/wear_update/wear_update.py:39", 0,
        _time_ms(lambda: K4.wear_update_events(wbuf, wid, amt)),
        _time_ms(lambda: K4.wear_update_plain(wbuf, wid, amt)),
        2 * n_slow * 4 + 2 * wid.numel() * 4, 0.0,
        _time_ms(lambda: wbuf.index_add_(0, wid, amt)), 0)
    rows[-1].update(
        device_ms=_graph_ms(lambda: K4.wear_update_events(wbuf, wid, amt)),
        library_device_ms=_graph_ms(lambda: wbuf.index_add_(0, wid, amt)))
    return rows


def host_link_rate(pool) -> dict:
    """Bytes per second of a pinned -> device ``copy_`` of 16 pages of the
    pinned pool: the rate at which the card reads pinned host memory,
    which bounds every kernel that reads the pinned tier in place."""
    import torch
    src = pool[:16]
    dst = torch.empty(src.shape, dtype=src.dtype, device="cuda")
    ms = _time_ms(lambda: dst.copy_(src, non_blocking=True), iters=20)
    nbytes = src.numel() * src.element_size()
    return {"bytes": nbytes, "ms": ms, "bytes_per_s": nbytes / ms * 1e3}


def _check_nonzero_pages(pool, rows, what: str) -> None:
    """Raise unless every page ``pool[rows]`` holds a nonzero bit: on an
    all-zero page a kernel that reads the wrong row or stride still
    agrees with its plain version."""
    import torch
    rows = torch.as_tensor(rows, device=pool.device).long()
    bits = pool[rows].reshape(rows.numel(), -1).view(torch.int16)
    if not bool((bits != 0).any(dim=1).all()):
        raise RuntimeError(f"{what}: the check would compare all-zero pages")


_WITH_COPY_CALL = ("index_select of the table's pinned pages on the host, "
                   "their copy to HBM, the HBM pages gathered beside them, "
                   "KV expanded to Hq heads, then the same SDPA, timed "
                   "together")


def _sdpa_with_copy(kf, vf, kp, vp, bt_np, sel_np, G, sdpa):
    """The library route to attention over two pools: the pinned pages a
    table names are gathered on the host (``index_select``) and copied to
    HBM, the HBM pages gathered beside them in table order, K/V laid out
    [rows, Hq, S, D], then ``sdpa(k, v)``.  Returns a callable that does
    all of it, for timing."""
    import numpy as np
    import torch
    dev = kf.device
    rows, P = bt_np.shape
    page, Hkv, D = kf.shape[1:]
    flat_sel = sel_np.reshape(-1) > 0
    pin_ids = torch.from_numpy(bt_np.reshape(-1)[flat_sel]).long()
    hbm_ids = torch.from_numpy(bt_np.reshape(-1)[~flat_sel]).long().to(dev)
    pin_pos = torch.from_numpy(np.flatnonzero(flat_sel)).to(dev)
    hbm_pos = torch.from_numpy(np.flatnonzero(~flat_sel)).to(dev)
    stage = [torch.empty((len(pin_ids),) + tuple(kp.shape[1:]),
                         dtype=kp.dtype, pin_memory=True) for _ in range(2)]
    dest = [torch.empty((rows * P,) + tuple(kf.shape[1:]), dtype=kf.dtype,
                        device=dev) for _ in range(2)]

    def run():
        kv = []
        for hbm, pin, st, d in zip((kf, vf), (kp, vp), stage, dest):
            torch.index_select(pin, 0, pin_ids, out=st)
            d.index_copy_(0, pin_pos, st.to(dev))
            d.index_copy_(0, hbm_pos, hbm.index_select(0, hbm_ids))
            kv.append(d.view(rows, P * page, Hkv, D).transpose(1, 2)
                      .repeat_interleave(G, dim=1))
        return sdpa(*kv)
    return run


def bench_pinned_kernels(cfg, peng, launches: dict, engine_launches: dict,
                         tail_launches: dict, link: dict) -> list[dict]:
    """The slice's kernels against their plain versions on the card, at
    the pinned run's shapes: K5 over pages of the pinned pool, K7 over
    the run's page counters, the dual-pool K1 over a batch whose pages
    split between HBM and the pinned pool, and the KV append.  Both
    pools are first filled with seeded random bf16."""
    import numpy as np
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels import hotness_update as K2
    from repro_torch.kernels import page_checksum as K5
    from repro_torch.kernels import paged_attention as K1

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev)
    gen.manual_seed(SEED + 5)
    rng = np.random.RandomState(SEED + 5)
    rate = link["bytes_per_s"]
    scfg = peng.scfg
    store = peng.kv.store
    fast = store.fast_pool
    pin = store.pools[peng.pinned_tier].data        # pinned host memory
    n_fast, n_pin = fast.shape[0], pin.shape[0]
    page = scfg.page_size
    B, P = scfg.max_batch, scfg.max_pages_per_seq
    Hq, Hkv, D = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    G = Hq // Hkv
    page_bytes = pin[0].numel() * pin.element_size()
    rows = []
    # the runs left most slots of both pools zeroed or freed
    for p in (pin, fast):
        p.copy_(torch.randn(p.shape, generator=gen, device=dev,
                            dtype=torch.float32).to(p.dtype))
    torch.cuda.synchronize()

    def row(name, src, replaces, err, ms, plain_ms, bound, library_ms, tol,
            **extra):
        rows.append({"name": name, "route": "cuda", "source": src,
                     "replaces": replaces, "launches": launches[name],
                     "max_abs_err": err, "tolerance": tol, "ms": ms,
                     "plain_ms": plain_ms, "bound_ms": bound[0],
                     "bound_by": bound[1], "library_ms": library_ms,
                     "launches_pinned_tail_run": tail_launches.get(name, 0),
                     **extra})

    # -- K5: one pre-dispatch verify of 16 pinned pages ---------------------
    idx = torch.from_numpy(rng.permutation(n_pin)[:16].astype(np.int32)
                           ).to(dev)
    _check_nonzero_pages(pin, idx.cpu(), "page_checksum")
    got = K5.page_checksum(pin, idx).view(torch.int32)
    want = K5.page_checksum_plain(pin, idx).view(torch.int32)
    torch.cuda.synchronize()
    if not torch.equal(got, want):
        raise RuntimeError("page_checksum kernel disagrees with plain")
    row("page_checksum", "src/repro_torch/kernels/csrc/page_checksum.cu",
        "src/repro/kernels/page_checksum/page_checksum.py:36", 0,
        _time_ms(lambda: K5.page_checksum(pin, idx), iters=20),
        _time_ms(lambda: K5.page_checksum_plain(pin, idx), iters=3,
                 warmup=1),
        _bound_ms(idx.numel() * 4 * 2, host_bytes=16 * page_bytes,
                  link_bytes_per_s=rate), None, 0, pages=16,
        pool="pinned host")

    # -- K7: the pass sweep over the run's page counters --------------------
    n = peng.kv.n_pages
    args = [torch.from_numpy(a.astype(np.int32)).to(dev) for a in (
        rng.randint(0, 40, n), rng.randint(0, 10, n), rng.randint(0, 256, n))]
    got = K2.sysmon_pass(*args)
    want = K2.sysmon_pass_plain(*args)
    torch.cuda.synchronize()
    if not all(torch.equal(a, b) for a, b in zip(got, want)):
        raise RuntimeError("sysmon_pass kernel disagrees with plain")
    row("sysmon_pass", "src/repro_torch/kernels/csrc/sysmon_pass.cu",
        "src/repro/kernels/hotness_update/hotness_update.py:76", 0,
        _time_ms(lambda: K2.sysmon_pass(*args)),
        _time_ms(lambda: K2.sysmon_pass_plain(*args)),
        _bound_ms(24 * n), None, 0, pages=n,
        launches_engine_run=engine_launches["sysmon_pass"],
        device_ms=_graph_ms(lambda: K2.sysmon_pass(*args)),
        empty_kernel_device_ms=_graph_ms(_launch_floor()),
        launches_per_call=_graph_launches(lambda: K2.sysmon_pass(*args)),
        note="ms: CUDA events around eager calls; device_ms: per call of "
             "a CUDA graph of 50 captured calls, beside an empty "
             "one-thread kernel's (launch_floor in sysmon_pass.cu) "
             "timed the same way")

    # -- K1 dual-pool: batch B, half the pages in the pinned pool ------------
    l = 0
    kf, vf, kp, vp = fast[:, l, 0], fast[:, l, 1], pin[:, l, 0], pin[:, l, 1]
    lengths_np = rng.randint(PROMPT_LEN + 1, PROMPT_LEN + NEW_TOKENS + 1,
                             size=B)
    sel_np = (rng.rand(B, P) < 0.5).astype(np.int32)
    bt_np = np.where(sel_np > 0,
                     np.stack([rng.permutation(n_pin)[:P] for _ in range(B)]),
                     np.stack([rng.permutation(n_fast)[:P]
                               for _ in range(B)])).astype(np.int32)
    _check_nonzero_pages(pin, np.unique(bt_np[sel_np > 0]),
                         "paged_attention_dual (pinned pages)")
    _check_nonzero_pages(fast, np.unique(bt_np[sel_np == 0]),
                         "paged_attention_dual (HBM pages)")
    bt = torch.from_numpy(bt_np).to(dev)
    sel = torch.from_numpy(sel_np).to(dev)
    lengths = torch.from_numpy(lengths_np.astype(np.int32)).to(dev)
    q = (torch.randn((B, Hkv, G, D), generator=gen, device=dev)
         * D ** -0.5).to(fast.dtype)
    dual = (q, kf, vf, kp, vp, bt, sel, lengths)
    out_k = K1.paged_attention_dual_pooled(*dual)
    out_p = K1.paged_attention_dual_plain(*dual)
    # the same pages in one HBM pool: single-pool K1 must give the same bits
    kmerged = torch.cat([kf, kp.to(dev)])
    vmerged = torch.cat([vf, vp.to(dev)])
    btm = torch.where(sel > 0, bt + n_fast, bt).to(torch.int32)
    out_s = K1.paged_attention_pooled(q, kmerged, vmerged, btm, lengths)
    torch.cuda.synchronize()
    if not torch.allclose(out_k.float(), out_p.float(), atol=ATTN_TOL,
                          rtol=ATTN_TOL):
        raise RuntimeError("paged_attention_dual kernel disagrees with "
                           "plain")
    if not torch.equal(out_k, out_s):
        raise RuntimeError("paged_attention_dual is not bit-identical to "
                           "single-pool paged_attention on the same pages")
    err = float((out_k.float() - out_p.float()).abs().max())
    pages_live = (lengths_np + page - 1) // page
    row_b = 2 * Hkv * D * fast.element_size()          # K and V of a row
    pin_rows = hbm_rows = 0
    for b in range(B):
        for j in range(int(pages_live[b])):
            live = min(page, int(lengths_np[b]) - j * page)
            if sel_np[b, j]:
                pin_rows += live
            else:
                hbm_rows += live
    hbm_bytes = (2 * B * Hq * D * 2 + hbm_rows * row_b + bt.numel() * 8
                 + B * 4)
    S = P * page
    kc = kmerged[btm.long()].reshape(B, S, Hkv, D).transpose(
        1, 2).repeat_interleave(G, dim=1).contiguous()
    vc = vmerged[btm.long()].reshape(B, S, Hkv, D).transpose(
        1, 2).repeat_interleave(G, dim=1).contiguous()
    q4 = q.reshape(B, Hq, 1, D)
    mask = (torch.arange(S, device=dev)[None, :]
            < lengths[:, None])[:, None, None, :]
    with_copy = _sdpa_with_copy(kf, vf, kp, vp, bt_np, sel_np, G,
                                lambda k, v: F.scaled_dot_product_attention(
                                    q4, k, v, attn_mask=mask, scale=1.0))
    row("paged_attention_dual",
        "src/repro_torch/kernels/csrc/paged_attention.cu",
        "src/repro/kernels/paged_attention/ops.py:76", err,
        _time_ms(lambda: K1.paged_attention_dual_pooled(*dual)),
        _time_ms(lambda: K1.paged_attention_dual_plain(*dual), iters=10,
                 warmup=2),
        _bound_ms(hbm_bytes, 4.0 * Hq * D * int(lengths_np.sum()),
                  host_bytes=pin_rows * row_b, link_bytes_per_s=rate),
        _time_ms(lambda: F.scaled_dot_product_attention(
            q4, kc, vc, attn_mask=mask, scale=1.0)), ATTN_TOL,
        bit_identical_to_single_pool=True, pinned_rows=pin_rows,
        hbm_rows=hbm_rows,
        device_ms=_graph_ms(lambda: K1.paged_attention_dual_pooled(*dual)),
        plan=_plan(False, True, fast.dtype, B, Hkv, G, D),
        library_call="SDPA, KV copied to HBM, copy not timed",
        library_with_copy_ms=_time_ms(with_copy, iters=10, warmup=2),
        library_with_copy_call=_WITH_COPY_CALL)
    del kmerged, vmerged, kc, vc

    # -- qkv_rope_append: one layer of the decode step, qk-norm on, half
    # -- of the new K/V rows landing in the pinned pool; and a 256-row
    # -- prefill bucket (two 128-token segments, the last page's rows
    # -- padding), over one pool and over two with half the pages pinned
    from repro_torch.models import attention as A
    from repro_torch.models import layers as L
    ap = peng.params["layers"][l]["attn"]

    def pinned_copy(t):
        c = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
        c.copy_(t)
        return c
    sfast, spin = fast[:16].clone(), pinned_copy(pin[:16])

    def rows_of(R, H):
        return torch.randn((R, H, D), generator=gen, device=dev).to(
            fast.dtype)
    q, k, v = rows_of(B, Hq), rows_of(B, Hkv), rows_of(B, Hkv)
    pos = torch.from_numpy(rng.randint(PROMPT_LEN, PROMPT_LEN + NEW_TOKENS,
                                       (B, 1)).astype(np.int32)).to(dev)
    cos, sin = (t[:, 0] for t in L.rope_angles(pos, D, cfg.rope_theta))
    to_pin = torch.from_numpy(rng.rand(B) < 0.5).to(dev)
    slot = torch.from_numpy(rng.permutation(16)[:B].astype(np.int32)).to(dev)
    f_idx = torch.where(to_pin, 16, slot).to(torch.int32)
    p_idx = torch.where(to_pin, slot, 16).to(torch.int32)
    off = torch.from_numpy(rng.randint(0, page, B).astype(np.int32)).to(dev)
    head = (q, k, v, ap.get("q_norm"), ap.get("k_norm"), cos, sin)
    app = head + (sfast[:, l], spin[:, l], f_idx, p_idx, off)
    Lb, nb = 2 * PROMPT_LEN, 2 * PROMPT_LEN // page
    bq, bk, bv = rows_of(Lb, Hq), rows_of(Lb, Hkv), rows_of(Lb, Hkv)
    bpos = (torch.arange(Lb, device=dev, dtype=torch.int32)
            % PROMPT_LEN)[:, None]
    bcos, bsin = (t[:, 0] for t in L.rope_angles(bpos, D, cfg.rope_theta))
    bhead = (bq, bk, bv, ap.get("q_norm"), ap.get("k_norm"), bcos, bsin)
    brow = torch.arange(Lb, device=dev, dtype=torch.int32)
    bpage, boff = brow // page, brow % page
    pad = brow >= Lb - page
    pinned_page = torch.from_numpy(rng.rand(nb) < 0.5).to(dev)[bpage]
    b1_idx = torch.where(pad, nb, bpage).to(torch.int32)
    bf_idx = torch.where(pad | pinned_page, nb, bpage).to(torch.int32)
    bp_idx = torch.where(pinned_page & ~pad, bpage, nb).to(torch.int32)
    bfast, bpin = fast[:nb].clone(), pinned_copy(pin[:nb])
    # timed as the one-pool prefill gives it, with no padding (so that
    # the parent's index_put_ of the yardstick stays in range)
    bucket = bhead + (bfast[:, l], None, bpage, None, boff)

    def vs_plain(hd, fbase, pbase, fi, pi, o):
        """The kernel and plain, each on its own copy of the pools (the
        pinned pool copied into pinned memory): (kernel, plain) pairs of
        q and of every pool."""
        outs = []
        for fn in (A.rope_append, A.rope_append_plain):
            f = fbase.clone()
            p = None if pbase is None else pinned_copy(pbase)
            qo = fn(*hd, f[:, l], None if p is None else p[:, l], fi, pi, o)
            outs.append([qo, f] + ([] if p is None else [p]))
        torch.cuda.synchronize()
        return list(zip(*outs))
    cases = {"decode_two_pools": vs_plain(head, sfast, spin, f_idx, p_idx,
                                          off),
             "bucket_one_pool": vs_plain(bhead, bfast, None, b1_idx, None,
                                         boff),
             "bucket_two_pools": vs_plain(bhead, bfast, bpin, bf_idx,
                                          bp_idx, boff)}
    ulps_by_case = {c: max(_ulps_apart(a, b) for a, b in pairs)
                    for c, pairs in cases.items()}
    ulps = max(ulps_by_case.values())
    if ulps > 1:
        raise RuntimeError(f"qkv_rope_append kernel is {ulps_by_case} bf16 "
                           f"ulps from plain (1 allowed)")
    err = max(float((a.float().cpu() - b.float().cpu()).abs().max())
              for pairs in cases.values() for a, b in pairs)
    n_pin_rows = int(to_pin.sum())
    # the parent's ops on the single-pool decode, all rows into HBM: the
    # eager qk-norm, RoPE and q scale, two index_put_ of the K/V rows
    parent = _parent_rope_append()
    hbm = head + (sfast[:, l], None, slot, None, off)
    # yardstick: one index_put_ of the K and V rows into an HBM pool view
    # (every row lands in HBM: PyTorch has no in-place write of pinned
    # host memory from the card)
    lib_view = sfast.clone()[:, l]
    lib_idx = (slot.long()[:, None], torch.arange(2, device=dev)[None, :],
               off.long()[:, None])
    lib_kv = torch.stack([k, v], dim=1)
    el = fast.element_size()
    nbytes = (B * (Hq + 2 * Hkv) * D * el + 2 * B * (D // 2) * 4
              + 2 * D * el + 3 * B * 4 + B * Hq * D * el
              + (B - n_pin_rows) * row_b)
    bucket_bytes = (Lb * (2 * Hq + 4 * Hkv) * D * el + 2 * Lb * (D // 2) * 4
                    + 2 * D * el + 2 * Lb * 4)
    row("qkv_rope_append", "src/repro_torch/kernels/csrc/kv_append.cu",
        "src/repro/models/attention.py:55 + src/repro/serving/"
        "engine.py:435", err,
        _time_ms(lambda: A.rope_append(*app)),
        _time_ms(lambda: A.rope_append_plain(*app)),
        _bound_ms(nbytes, host_bytes=n_pin_rows * row_b,
                  link_bytes_per_s=rate),
        _time_ms(lambda: lib_view.index_put_(lib_idx, lib_kv)), 1,
        tolerance_unit="bf16 ulps (the norm's sum of squares in another "
                       "order)", ulps_apart=ulps,
        ulps_apart_by_case=ulps_by_case, qk_norm=True,
        pinned_rows=n_pin_rows, launches_engine_run=engine_launches.get(
            "qkv_rope_append", 0),
        library_call="index_put_ of the K/V rows into an HBM pool view",
        device_ms=_graph_ms(lambda: A.rope_append(*app)),
        library_device_ms=_graph_ms(
            lambda: lib_view.index_put_(lib_idx, lib_kv)),
        replaced_ops_device_ms=_graph_ms(lambda: parent(*hbm)),
        replaced_ops_launches=_graph_launches(lambda: parent(*hbm)),
        replaced_ops_note="the parent tree's per-layer ops around the "
                          "append on the single-pool decode (rms_norm and "
                          "apply_rope of q and k, q * D**-0.5, two "
                          "index_put_), every row into HBM, as a CUDA graph",
        launches_per_call=_graph_launches(lambda: A.rope_append(*app)),
        prefill_bucket_rows=Lb,
        device_ms_prefill_bucket=_graph_ms(
            lambda: A.rope_append(*bucket)),
        bound_ms_prefill_bucket=_bound_ms(bucket_bytes)[0],
        replaced_ops_device_ms_prefill_bucket=_graph_ms(
            lambda: parent(*bucket)))
    return rows


def bench_int8_prefill_kernels(cfg, eng, ieng, prefill_line: dict,
                               int8_host_launches: dict,
                               int8_pin_launches: dict,
                               link: dict) -> list[dict]:
    """The int8 and prefill kernels against their plain versions on the
    card: K6 over a demotion batch of 16 pages of the HBM pool,
    ``dequant_gather`` and the 1-byte K5 over 16 pages of the int8 pinned
    pool, and K1 at the prefill shape (a bucket of 256 rows: two
    128-token segments with 16-page tables).  The pools are filled with
    seeded random values first."""
    import numpy as np
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels import page_checksum as K5
    from repro_torch.kernels import page_quant as K6
    from repro_torch.kernels import paged_attention as K1

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev)
    gen.manual_seed(SEED + 8)
    rng = np.random.RandomState(SEED + 8)
    rate = link["bytes_per_s"]
    pool = eng.kv.store.fast_pool                  # bf16 HBM pool
    ipool = ieng.kv.store.pools[ieng.kv.store.hierarchy.deepest]
    pq, ps = ipool.data, ipool.scale               # pinned int8 + scales
    pool.copy_(torch.randn(pool.shape, generator=gen, device=dev,
                           dtype=torch.float32).to(pool.dtype))
    pq.copy_(torch.randint(-127, 128, pq.shape, generator=gen, device=dev,
                           dtype=torch.int32).to(torch.int8))
    ps.copy_((torch.rand(ps.shape, generator=gen, device=dev) * 0.05
              + 1e-3))
    torch.cuda.synchronize()
    n_elem = pool[0].numel()
    k = 16
    rows = []

    def row(name, kernel, src, replaces, ms, plain_ms, bound, library_ms,
            launches, **extra):
        rows.append({"name": name, "kernel": kernel, "route": "cuda",
                     "source": src, "replaces": replaces,
                     "launches": launches, "max_abs_err": 0,
                     "tolerance": 0, "ms": ms, "plain_ms": plain_ms,
                     "bound_ms": bound[0], "bound_by": bound[1],
                     "library_ms": library_ms, **extra})

    # -- K6: quantize a demotion batch out of the HBM pool -------------------
    idx = torch.from_numpy(rng.permutation(pool.shape[0])[:k]
                           .astype(np.int32)).to(dev)
    q, s = K6.page_gather_quant(pool, idx)
    qp, sp = K6.page_gather_quant_plain(pool, idx)
    torch.cuda.synchronize()
    if not (torch.equal(q, qp) and torch.equal(s, sp)):
        raise RuntimeError("page_gather_quant kernel disagrees with plain")
    plan = K6.launch_info(n_elem, pool.element_size(), k)
    per_call = _graph_launches(lambda: K6.page_gather_quant(pool, idx))
    if per_call != 1:
        raise RuntimeError(f"page_gather_quant: {per_call} device work "
                           f"nodes in a graph of one call (one launch, no "
                           f"memset expected)")
    row("page_gather_quant", "page_gather_quant",
        "src/repro_torch/kernels/csrc/page_quant.cu",
        "src/repro/kernels/page_gather/page_gather.py:94",
        _time_ms(lambda: K6.page_gather_quant(pool, idx)),
        _time_ms(lambda: K6.page_gather_quant_plain(pool, idx), iters=10,
                 warmup=2),
        _bound_ms(k * n_elem * (pool.element_size() + 1) + k * 8),
        None, int8_host_launches["page_gather_quant"], pages=k,
        launches_int8_pinned_run=int8_pin_launches["page_gather_quant"],
        device_ms=_graph_ms(lambda: K6.page_gather_quant(pool, idx)),
        launches_per_call=per_call, plan=plan,
        library_note="no single PyTorch call gathers pages and quantizes "
                     "each with its own scale")

    # -- dequant_gather: a promotion batch out of the pinned int8 pool -------
    pidx = torch.from_numpy(rng.permutation(pq.shape[0])[:k]
                            .astype(np.int32)).to(dev)
    got = K6.dequant_gather(pq, ps, pidx, pool.dtype)
    want = K6.dequant_gather_plain(pq, ps, pidx, pool.dtype)
    torch.cuda.synchronize()
    if not torch.equal(got, want):
        raise RuntimeError("dequant_gather kernel disagrees with plain")
    row("dequant_gather", "dequant_gather",
        "src/repro_torch/kernels/csrc/page_quant.cu",
        "src/repro/kernels/page_gather/ops.py:96",
        _time_ms(lambda: K6.dequant_gather(pq, ps, pidx, pool.dtype),
                 iters=20),
        _time_ms(lambda: K6.dequant_gather_plain(pq, ps, pidx, pool.dtype),
                 iters=3, warmup=1),
        _bound_ms(k * n_elem * pool.element_size() + k * 4,
                  host_bytes=k * (n_elem + 4), link_bytes_per_s=rate),
        None, int8_pin_launches["dequant_gather"], pages=k,
        pool="pinned host int8",
        launches_int8_host_run=int8_host_launches["dequant_gather"],
        library_note="no single PyTorch call gathers int8 pages out of "
                     "pinned host memory and scales each by its own "
                     "factor")

    # -- K5 over 1-byte pages of the pinned int8 pool ------------------------
    got = K5.page_checksum(pq, pidx).view(torch.int32)
    want = K5.page_checksum_plain(pq, pidx).view(torch.int32)
    torch.cuda.synchronize()
    if not torch.equal(got, want):
        raise RuntimeError("page_checksum over int8 pages disagrees with "
                           "plain")
    row("page_checksum_int8", "page_checksum",
        "src/repro_torch/kernels/csrc/page_checksum.cu",
        "src/repro/kernels/page_checksum/page_checksum.py:36",
        _time_ms(lambda: K5.page_checksum(pq, pidx), iters=20),
        _time_ms(lambda: K5.page_checksum_plain(pq, pidx), iters=3,
                 warmup=1),
        _bound_ms(k * 8, host_bytes=k * n_elem, link_bytes_per_s=rate),
        None, int8_pin_launches["page_checksum"], pages=k, elem_bytes=1,
        pool="pinned host int8",
        library_note="no PyTorch call sums stored bits with odd weights "
                     "modulo 2**32")

    # -- K1's prefill body: 2 x 128 rows, 16-page tables ---------------------
    page = eng.scfg.page_size
    Hq, Hkv, D = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    G = Hq // Hkv
    seg, n_seg = PROMPT_LEN, 2
    L = seg * n_seg
    P = L // page                         # n_table_pages(256) = 16
    k_pool, v_pool = pool[:, 0, 0], pool[:, 0, 1]
    seg_pages = rng.permutation(pool.shape[0])[:n_seg * (seg // page)] \
        .reshape(n_seg, seg // page)
    bt_np = np.zeros((L, P), np.int32)
    for si in range(n_seg):
        bt_np[si * seg:(si + 1) * seg, :seg // page] = seg_pages[si]
    lengths_np = np.tile(np.arange(1, seg + 1), n_seg).astype(np.int32)
    bt = torch.from_numpy(bt_np).to(dev)
    lengths = torch.from_numpy(lengths_np).to(dev)
    qg = (torch.randn((L, Hkv, G, D), generator=gen, device=dev)
          * D ** -0.5).to(pool.dtype)
    args = (qg, k_pool, v_pool, bt, lengths)
    out_k = K1.paged_attention_prefill_pooled(*args)
    out_p = K1.paged_attention_plain(*args)
    torch.cuda.synchronize()
    if not torch.allclose(out_k.float(), out_p.float(), atol=ATTN_TOL,
                          rtol=ATTN_TOL):
        raise RuntimeError("paged_attention_prefill disagrees with plain")
    err = float((out_k.float() - out_p.float()).abs().max())
    flat = torch.from_numpy(seg_pages.reshape(-1)).to(dev).long()
    kc = k_pool[flat].reshape(n_seg, seg, Hkv, D).transpose(1, 2) \
        .repeat_interleave(G, dim=1).contiguous()
    vc = v_pool[flat].reshape(n_seg, seg, Hkv, D).transpose(1, 2) \
        .repeat_interleave(G, dim=1).contiguous()
    q4 = qg.reshape(n_seg, seg, Hq, D).transpose(1, 2).contiguous()
    kv_bytes = n_seg * seg * 2 * Hkv * D * pool.element_size()

    def sdpa():
        return F.scaled_dot_product_attention(q4, kc, vc, is_causal=True,
                                              scale=1.0)
    hmma = _sass_count("paged_prefill_bf16_kernel", "HMMA")
    if not hmma:
        raise RuntimeError("paged_attention_prefill: no HMMA in the bf16 "
                           "prefill body")
    row("paged_attention_prefill", "paged_attention_prefill",
        "src/repro_torch/kernels/csrc/paged_attention.cu",
        "src/repro/kernels/paged_attention/paged_attention.py:75",
        _time_ms(lambda: K1.paged_attention_prefill_pooled(*args)),
        _time_ms(lambda: K1.paged_attention_plain(*args), iters=10,
                 warmup=2),
        _bound_ms(2 * L * Hq * D * 2 + kv_bytes + bt.numel() * 4 + L * 4,
                  4.0 * Hq * D * float(lengths_np.sum())),
        _time_ms(sdpa), prefill_line["prefill_launches"][
            "paged_attention_prefill"],
        rows=L, table_pages=P, library_call="scaled_dot_product_attention, "
        "causal, KV copied contiguous", sass_hmma=hmma,
        device_ms=_graph_ms(lambda: K1.paged_attention_prefill_pooled(*args)),
        library_device_ms=_graph_ms(sdpa),
        plan=_plan(True, False, pool.dtype, L, Hkv, G, D))
    rows[-1].update(max_abs_err=err, tolerance=ATTN_TOL)
    # the same body on two segments of s tokens in a 2s-row bucket: a CTA
    # walks up to s / 16 key blocks in series, so the device time against
    # s shows the cost of each block beside the fixed cost of a launch
    by_seg = {}
    for s in (16, 32, 64):
        bt_s, len_s = _packed_bucket([(i * s, s, bt_np[i * seg])
                                      for i in range(n_seg)], n_seg * s, P)
        a_s = (qg[:n_seg * s].contiguous(), k_pool, v_pool,
               torch.from_numpy(bt_s).to(dev),
               torch.from_numpy(len_s).to(dev))
        by_seg[s] = _graph_ms(lambda: K1.paged_attention_prefill_pooled(*a_s))
    by_seg[seg] = rows[-1]["device_ms"]
    rows[-1]["device_ms_by_segment_tokens"] = by_seg

    # -- K1's float32 prefill body (3xTF32 on the tensor cores) at the
    # float32 probe's shape: one 128-row segment in its 128-row bucket,
    # 8-page tables, float32 pools; and at the engine's bucket
    hmma_f32 = _sass_count("paged_prefill_f32_kernel", "HMMA")
    if not hmma_f32:
        raise RuntimeError("paged_attention_prefill: no HMMA in the float32 "
                           "prefill body")
    fp = pool[:, 0].float()
    fk, fv = fp[:, 0], fp[:, 1]
    Lf, Pf = seg, seg // page
    bt_f, len_f = _packed_bucket([(0, seg, seg_pages[0])], Lf, Pf)
    qf = torch.randn((Lf, Hkv, G, D), generator=gen, device=dev) * D ** -0.5
    fargs = (qf, fk, fv, torch.from_numpy(bt_f).to(dev),
             torch.from_numpy(len_f).to(dev))
    out_k = K1.paged_attention_prefill_pooled(*fargs)
    out_p = K1.paged_attention_plain(*fargs)
    torch.cuda.synchronize()
    if not torch.allclose(out_k, out_p, atol=PAGED_F32_TOL,
                          rtol=PAGED_F32_TOL):
        raise RuntimeError("paged_attention_prefill (float32) disagrees "
                           "with plain")
    err = float((out_k - out_p).abs().max())

    def segments_f32(q, n):
        """SDPA's operands over the first n segments: q, K, V as [n, Hq,
        seg, D], K and V copied contiguous and expanded to Hq heads."""
        flat = torch.from_numpy(seg_pages[:n].reshape(-1)).to(dev).long()
        kv = (t[flat].reshape(n, seg, Hkv, D).transpose(1, 2)
              .repeat_interleave(G, dim=1).contiguous() for t in (fk, fv))
        return (q.reshape(n, seg, Hq, D).transpose(1, 2).contiguous(), *kv)

    def sdpa_causal(q4, kc, vc):
        return lambda: F.scaled_dot_product_attention(q4, kc, vc,
                                                      is_causal=True,
                                                      scale=1.0)

    def library_err(lib, want, n):
        got = lib().transpose(1, 2).reshape(n * seg, Hkv, G, D)
        return float((got - want).abs().max())
    sdpa_f32 = sdpa_causal(*segments_f32(qf, 1))
    row("paged_attention_prefill_f32", "paged_attention_prefill",
        "src/repro_torch/kernels/csrc/paged_attention.cu",
        "src/repro/kernels/paged_attention/paged_attention.py:75",
        _time_ms(lambda: K1.paged_attention_prefill_pooled(*fargs)),
        _time_ms(lambda: K1.paged_attention_plain(*fargs), iters=10,
                 warmup=2),
        _bound_ms(2 * Lf * Hq * D * 4 + seg * 2 * Hkv * D * 4 + Lf * Pf * 4
                  + Lf * 4, 4.0 * Hq * D * float(len_f.sum()),
                  flops_per_s=F32_TC_FLOPS_PER_S),
        _time_ms(sdpa_f32), prefill_line["probe_f32_launches"][
            "paged_attention_prefill"],
        rows=Lf, table_pages=Pf, dtype="float32",
        design="row-tiled as the bf16 body, every product 3xTF32 on "
               "mma.sync m16n8k8",
        sass_hmma=hmma_f32,
        library_call="scaled_dot_product_attention, causal, float32, KV "
                     "copied contiguous",
        library_kernels=_device_kernels(sdpa_f32),
        library_max_abs_err=library_err(sdpa_f32, out_p, 1),
        launches_run="the float32 prefill probe (prefill and TF32 control "
                     "dispatches)",
        device_ms=_graph_ms(lambda: K1.paged_attention_prefill_pooled(
            *fargs)),
        library_device_ms=_graph_ms(sdpa_f32),
        plan=_plan(True, False, torch.float32, Lf, Hkv, G, D))
    rows[-1].update(max_abs_err=err, tolerance=PAGED_F32_TOL,
                    **_f32_bounds(2 * Lf * Hq * D * 4 + seg * 2 * Hkv * D * 4
                                  + Lf * Pf * 4 + Lf * 4,
                                  4.0 * Hq * D * float(len_f.sum())))
    # the engine's bucket: the bf16 row's two 128-token segments in 256
    # rows with 16-page tables, on the float32 pools
    qb = torch.randn((L, Hkv, G, D), generator=gen, device=dev) * D ** -0.5
    bargs = (qb, fk, fv, bt, lengths)
    out_k = K1.paged_attention_prefill_pooled(*bargs)
    out_p = K1.paged_attention_plain(*bargs)
    torch.cuda.synchronize()
    if not torch.allclose(out_k, out_p, atol=PAGED_F32_TOL,
                          rtol=PAGED_F32_TOL):
        raise RuntimeError("paged_attention_prefill (float32, engine "
                           "bucket) disagrees with plain")
    sdpa_b = sdpa_causal(*segments_f32(qb, n_seg))
    nbytes = 2 * L * Hq * D * 4 + kv_bytes * 2 + bt.numel() * 4 + L * 4
    flops = 4.0 * Hq * D * float(lengths_np.sum())
    rows[-1]["engine_bucket"] = {
        "rows": L, "table_pages": P,
        "max_abs_err": float((out_k - out_p).abs().max()),
        "ms": _time_ms(lambda: K1.paged_attention_prefill_pooled(*bargs)),
        "device_ms": _graph_ms(lambda: K1.paged_attention_prefill_pooled(
            *bargs)),
        "library_ms": _time_ms(sdpa_b),
        "library_device_ms": _graph_ms(sdpa_b),
        "library_max_abs_err": library_err(sdpa_b, out_p, n_seg),
        **_f32_bounds(nbytes, flops),
        "plan": _plan(True, False, torch.float32, L, Hkv, G, D)}

    # -- K1's float32 decode body at the engine's decode shape: batch 8,
    # contexts the run reached, 16-page tables, float32 pools (FMA units;
    # the float32 prefill probe's replay launches it)
    Bd, Pd = eng.scfg.max_batch, eng.scfg.max_pages_per_seq
    len_d = rng.randint(PROMPT_LEN + 1, PROMPT_LEN + NEW_TOKENS + 1, size=Bd)
    bt_d = torch.from_numpy(np.stack([rng.permutation(fp.shape[0])[:Pd]
                                      for _ in range(Bd)]).astype(np.int32)
                            ).to(dev)
    ld = torch.from_numpy(len_d.astype(np.int32)).to(dev)
    qd = torch.randn((Bd, Hkv, G, D), generator=gen, device=dev) * D ** -0.5
    dargs = (qd, fk, fv, bt_d, ld)
    out_k = K1.paged_attention_pooled(*dargs)
    out_p = K1.paged_attention_plain(*dargs)
    torch.cuda.synchronize()
    if not torch.allclose(out_k, out_p, atol=PAGED_F32_TOL,
                          rtol=PAGED_F32_TOL):
        raise RuntimeError("paged_attention (float32 decode) disagrees with "
                           "plain")
    S = Pd * page
    kcd, vcd = (t[bt_d.long()].reshape(Bd, S, Hkv, D).transpose(1, 2)
                .repeat_interleave(G, dim=1).contiguous() for t in (fk, fv))
    q4d = qd.reshape(Bd, Hq, 1, D)
    mask_d = (torch.arange(S, device=dev)[None, :]
              < ld[:, None])[:, None, None, :]

    def sdpa_dec():
        return F.scaled_dot_product_attention(q4d, kcd, vcd, attn_mask=mask_d,
                                              scale=1.0)
    live = int(len_d.sum())
    nbytes = 2 * Bd * Hq * D * 4 + 2 * live * Hkv * D * 4 + Bd * Pd * 4 + Bd * 4
    flops = 4.0 * Hq * D * live
    row("paged_attention_f32", "paged_attention",
        "src/repro_torch/kernels/csrc/paged_attention.cu",
        "src/repro/kernels/paged_attention/paged_attention.py:75",
        _time_ms(lambda: K1.paged_attention_pooled(*dargs)),
        _time_ms(lambda: K1.paged_attention_plain(*dargs), iters=10,
                 warmup=2),
        _bound_ms(nbytes, flops, flops_per_s=F32_TC_FLOPS_PER_S),
        _time_ms(sdpa_dec),
        prefill_line["probe_f32_launches"].get("paged_attention", 0),
        batch=Bd, contexts=[int(x) for x in len_d], table_pages=Pd,
        dtype="float32",
        design="the decode body (split over a cluster of 8 CTAs) on the FMA "
               "units, not redesigned here",
        sass_hmma=_sass_count("paged_decode_kernelIf", "HMMA"),
        library_call="scaled_dot_product_attention, float32, KV gathered "
                     "contiguous and expanded to Hq heads outside the timing",
        library_kernels=_device_kernels(sdpa_dec),
        library_max_abs_err=float((sdpa_dec().reshape(Bd, Hkv, G, D)
                                   - out_p).abs().max()),
        launches_run="the float32 prefill probe's replay (K=1 decode of "
                     "every prompt position)",
        device_ms=_graph_ms(lambda: K1.paged_attention_pooled(*dargs)),
        library_device_ms=_graph_ms(sdpa_dec),
        plan=_plan(False, False, torch.float32, Bd, Hkv, G, D))
    rows[-1].update(max_abs_err=float((out_k - out_p).abs().max()),
                    tolerance=PAGED_F32_TOL, **_f32_bounds(nbytes, flops))
    del fp, fk, fv, kcd, vcd
    return rows


def _packed_bucket(segs: list, L: int, P: int):
    """Per-row tables and lengths of a bucket of ``L`` rows holding each
    segment (offset, length, table) as ``PrefillRunner.build_args`` lays
    it out; padding rows have table 0 and length 0."""
    import numpy as np
    bt = np.zeros((L, P), np.int32)
    lengths = np.zeros(L, np.int32)
    for off, n, table in segs:
        bt[off:off + n] = table
        lengths[off:off + n] = np.arange(1, n + 1)
    return bt, lengths


def bench_prefill_dual(cfg, peng, prefill_launches: dict,
                       link: dict) -> list[dict]:
    """K1d's prefill body at the prefill shape (two 128-row segments in a
    256-row bucket, 16-page tables) with about half of each segment's
    pages in the pinned pool of the pinned engine: within ATTN_TOL of its
    plain version and bit-identical to the single-pool prefill over the
    same pages merged into one HBM pool.  The pools hold the seeded random
    values ``bench_pinned_kernels`` wrote."""
    import numpy as np
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels import paged_attention as K1
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev)
    gen.manual_seed(SEED + 9)
    rng = np.random.RandomState(SEED + 9)
    store = peng.kv.store
    fast = store.fast_pool
    pin = store.pools[peng.pinned_tier].data
    n_fast, n_pin = fast.shape[0], pin.shape[0]
    page = peng.scfg.page_size
    Hq, Hkv, D = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    G = Hq // Hkv
    seg, n_seg = PROMPT_LEN, 2
    L, P, live = seg * n_seg, seg * n_seg // page, seg // page
    sels = (rng.rand(n_seg, P) < 0.5).astype(np.int32)
    tables = np.where(sels > 0,
                      np.stack([rng.permutation(n_pin)[:P]
                                for _ in range(n_seg)]),
                      np.stack([rng.permutation(n_fast)[:P]
                                for _ in range(n_seg)])).astype(np.int32)
    bt_np, lengths_np = _packed_bucket(
        [(i * seg, seg, tables[i]) for i in range(n_seg)], L, P)
    sel_np = np.repeat(sels, seg, axis=0)
    _check_nonzero_pages(pin, np.unique(tables[:, :live][sels[:, :live] > 0]),
                         "paged_attention_prefill_dual (pinned pages)")
    l = 0
    kf, vf, kp, vp = fast[:, l, 0], fast[:, l, 1], pin[:, l, 0], pin[:, l, 1]
    bt = torch.from_numpy(bt_np).to(dev)
    sel = torch.from_numpy(sel_np).to(dev)
    lengths = torch.from_numpy(lengths_np).to(dev)
    qg = (torch.randn((L, Hkv, G, D), generator=gen, device=dev)
          * D ** -0.5).to(fast.dtype)
    dual = (qg, kf, vf, kp, vp, bt, sel, lengths)
    out_k = K1.paged_attention_prefill_dual_pooled(*dual)
    out_p = K1.paged_attention_dual_plain(*dual)
    kmerged = torch.cat([kf, kp.to(dev)])
    vmerged = torch.cat([vf, vp.to(dev)])
    btm = torch.where(sel > 0, bt + n_fast, bt).to(torch.int32)
    out_s = K1.paged_attention_prefill_pooled(qg, kmerged, vmerged, btm,
                                              lengths)
    torch.cuda.synchronize()
    if not torch.allclose(out_k.float(), out_p.float(), atol=ATTN_TOL,
                          rtol=ATTN_TOL):
        raise RuntimeError("paged_attention_prefill_dual disagrees with "
                           "plain")
    if not torch.equal(out_k, out_s):
        raise RuntimeError("paged_attention_prefill_dual is not "
                           "bit-identical to the single-pool prefill on the "
                           "same pages")
    err = float((out_k.float() - out_p.float()).abs().max())
    row_b = 2 * Hkv * D * fast.element_size()
    pin_rows = int(sum(min(page, seg - j * page) for i in range(n_seg)
                       for j in range(live) if sels[i, j]))
    hbm_rows = n_seg * seg - pin_rows
    q4 = qg.reshape(n_seg, seg, Hq, D).transpose(1, 2).contiguous()

    def sdpa(k, v):
        return F.scaled_dot_product_attention(q4, k, v, is_causal=True,
                                              scale=1.0)
    # the yardsticks read each segment's live pages only
    seg_bt, seg_sel = tables[:, :live], sels[:, :live]
    merged_ids = torch.from_numpy(np.where(seg_sel > 0, seg_bt + n_fast,
                                           seg_bt)).to(dev).long()
    kc, vc = (pool[merged_ids].reshape(n_seg, seg, Hkv, D).transpose(1, 2)
              .repeat_interleave(G, dim=1).contiguous()
              for pool in (kmerged, vmerged))
    with_copy = _sdpa_with_copy(kf, vf, kp, vp, seg_bt, seg_sel, G, sdpa)
    no_pin = torch.zeros_like(sel)
    bound = _bound_ms(2 * L * Hq * D * 2 + hbm_rows * row_b + bt.numel() * 8
                      + L * 4, 4.0 * Hq * D * float(lengths_np.sum()),
                      host_bytes=pin_rows * row_b,
                      link_bytes_per_s=link["bytes_per_s"])
    row = {"name": "paged_attention_prefill_dual",
           "kernel": "paged_attention_prefill_dual", "route": "cuda",
           "source": "src/repro_torch/kernels/csrc/paged_attention.cu",
           "replaces": "src/repro/kernels/paged_attention/ops.py:68",
           "launches": prefill_launches.get("paged_attention_prefill_dual",
                                            0),
           "max_abs_err": err, "tolerance": ATTN_TOL,
           "ms": _time_ms(lambda: K1.paged_attention_prefill_dual_pooled(
               *dual)),
           "plain_ms": _time_ms(lambda: K1.paged_attention_dual_plain(*dual),
                                iters=5, warmup=1),
           "bound_ms": bound[0], "bound_by": bound[1],
           "library_ms": _time_ms(lambda: sdpa(kc, vc)),
           "library_call": "SDPA, causal, KV copied to HBM, copy not timed",
           "library_with_copy_ms": _time_ms(with_copy, iters=10, warmup=2),
           "library_with_copy_call": _WITH_COPY_CALL,
           "device_ms": _graph_ms(lambda: K1.paged_attention_prefill_dual_pooled(
               *dual)),
           # the same call with every page in HBM (the merged pool, pool_sel
           # 0): the time the body takes when no byte crosses the host link
           "device_ms_all_hbm": _graph_ms(
               lambda: K1.paged_attention_prefill_dual_pooled(
                   qg, kmerged, vmerged, kp, vp, btm, no_pin, lengths)),
           "plan": _plan(True, True, fast.dtype, L, Hkv, G, D),
           "bit_identical_to_single_pool": True, "rows": L, "table_pages": P,
           "pinned_rows": pin_rows, "hbm_rows": hbm_rows,
           "launches_run": "prefill_pinned.hbm8_run prefill dispatches"}
    del kmerged, vmerged, kc, vc
    return [row]


def run_prefill_invariance(cfg, eng, peng) -> dict:
    """Whether a packed segment's bits in K1's prefill body depend on
    where it sits: a 100-row segment is placed alone at the head of a
    256-row bucket, then at other offsets (across the 64-row tiles) next
    to other segments and padding; every row must give the bits it gave
    alone.  Once over the HBM pool (``paged_attention_prefill``), once
    with about half of the segment's pages pinned
    (``paged_attention_prefill_dual``), at the engine's widths; both again
    in float32 (the float32 body) over float32 copies of layer 0."""
    import numpy as np
    import torch
    from repro_torch.kernels import paged_attention as K1
    dev = torch.device("cuda")
    rng = np.random.RandomState(SEED + 10)
    gen = torch.Generator(device=dev)
    gen.manual_seed(SEED + 10)
    page = eng.scfg.page_size
    Hq, Hkv, D = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    L, seg = 256, 100
    P = L // page
    placements = [(37, [(0, 37), (137, 80)]), (150, []),
                  (64, [(0, 64), (164, 90)]), (3, [(0, 3), (103, 128)])]
    out = {"phase": "prefill_invariance", "bucket_rows": L,
           "segment_rows": seg, "placements": [p for p, _ in placements]}
    fast = eng.kv.store.fast_pool
    pfast = peng.kv.store.fast_pool
    pin = peng.kv.store.pools[peng.pinned_tier].data
    # each path's HBM pool and pinned pool (None: one pool); the float32
    # paths run the float32 body over float32 copies of layer 0
    paths = {"hbm": (fast, None), "dual_pool": (pfast, pin),
             "hbm_f32": (fast[:, :1].float(), None),
             "dual_pool_f32": (pfast[:, :1].float(),
                               pin[:, :1].float().pin_memory())}
    for path, (hbm, pinned) in paths.items():
        n_fast = hbm.shape[0]
        n_pin = pin.shape[0]

        def table():
            if pinned is None:
                return rng.permutation(n_fast)[:P].astype(np.int32), \
                    np.zeros(P, np.int32)
            sel = (rng.rand(P) < 0.5).astype(np.int32)
            return np.where(sel > 0, rng.permutation(n_pin)[:P],
                            rng.permutation(n_fast)[:P]).astype(np.int32), sel
        mine, mine_sel = table()
        q_seg = torch.randn((seg, Hq, D), generator=gen, device=dev).to(
            hbm.dtype)

        def run(off, others):
            segs, sels = [(off, seg, mine)], [(off, seg, mine_sel)]
            for o, n in others:
                t, sl = table()
                segs.append((o, n, t))
                sels.append((o, n, sl))
            bt, lengths = _packed_bucket(segs, L, P)
            sel, _ = _packed_bucket(sels, L, P)
            q = torch.randn((L, Hq, D), generator=gen, device=dev).to(
                hbm.dtype)
            q[off:off + seg] = q_seg
            bt, sel, lengths = (torch.from_numpy(a).to(dev)
                                for a in (bt, sel, lengths))
            if pinned is None:
                o = K1.paged_attention_prefill(q, hbm[:, 0, 0], hbm[:, 0, 1],
                                               bt, lengths)
            else:
                o = K1.paged_attention_prefill_dual(
                    q, hbm[:, 0, 0], hbm[:, 0, 1], pinned[:, 0, 0],
                    pinned[:, 0, 1], bt, sel, lengths)
            return o[off:off + seg]

        alone = run(0, [])
        differ = {}
        for off, others in placements:
            got = run(off, others)
            bad = int((got != alone).reshape(seg, -1).any(1).sum())
            if bad:
                differ[off] = bad
        out[path] = {"rows_with_other_bits": differ,
                     "finite": bool(torch.isfinite(alone.float()).all())}
        if differ or not out[path]["finite"]:
            raise RuntimeError(f"prefill_invariance ({path}): rows with "
                               f"other bits at offsets {differ}")
    return out


# =============================================================================
# phases 14-17: dense-cache long-context generation (K8, K9)
# =============================================================================

def _shared_sites(cfg) -> int:
    k = cfg.shared_attn_every
    return (sum(1 for l in range(cfg.n_layers) if l % k == k - 1)
            if cfg.layout == "hybrid" and k else 0)


def _to_device(tree, dev):
    if isinstance(tree, dict):
        return {k: _to_device(v, dev) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_to_device(v, dev) for v in tree]
    return tree.to(dev)


def run_longctx(name: str, dtype=None) -> tuple[dict, dict, object, object]:
    """``generate`` at the arch's full published width and depth in
    ``dtype`` (bf16 unless given; random weights from SEED; float32 runs
    K9's and K8's float32 entries): LONGCTX_BATCH prompts of LONGCTX_PROMPT
    tokens (15 full 128-token chunks and a ragged 80), then LONGCTX_NEW
    greedy decode steps into a cache of LONGCTX_CACHE slots.  The prefill
    must launch K9 once per Mamba layer and K8 once per shared-attention
    site and nothing else; the decode launches no kernel."""
    import numpy as np
    import torch
    from repro_torch import kernels
    from repro_torch.configs.base import registry
    from repro_torch.launch.longctx_decode import generate
    from repro_torch.models.transformer import init_params
    dtype = dtype or torch.bfloat16
    cfg = registry()[name]
    t0 = time.perf_counter()
    params = init_params(cfg, seed=SEED, dtype=dtype, device="cuda")
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    prompts = _prompts(LONGCTX_BATCH, LONGCTX_PROMPT, cfg.vocab, SEED + 11)
    torch.cuda.reset_peak_memory_stats()
    kernels.reset_launch_counts()
    res = generate(params, cfg, prompts, LONGCTX_NEW, LONGCTX_CACHE)
    launches = kernels.launch_counts()
    want = {k: 0 for k in launches}
    want.update(ssd_scan=cfg.n_layers, flash_attention=_shared_sites(cfg))
    if res["prefill_launches"] != want:
        raise RuntimeError(f"{name} prefill launched {res['prefill_launches']}"
                           f", want {want}")
    if any(res["decode_launches"].values()) or launches != want:
        raise RuntimeError(f"{name} decode launched kernels: "
                           f"{res['decode_launches']}")
    V = cfg.vocab
    for key in ("first_logits", "logits"):
        if not bool(torch.isfinite(res[key][..., :V]).all()):
            raise RuntimeError(f"{name}: non-finite {key}")
    toks = np.asarray(res["tokens"])
    if toks.shape != (LONGCTX_BATCH, LONGCTX_NEW) or toks.min() < 0 \
            or toks.max() >= V:
        raise RuntimeError(f"{name}: bad tokens of shape {toks.shape}")
    f32 = "_f32" if dtype == torch.float32 else ""
    line = {"phase": f"longctx_{name.split('_')[0]}{f32}", "arch": name,
            "dtype": str(dtype).removeprefix("torch."),
            "layers": cfg.n_layers,
            "d_model": cfg.d_model, "batch": LONGCTX_BATCH,
            "prompt_len": LONGCTX_PROMPT, "new_tokens": LONGCTX_NEW,
            "cache_len": LONGCTX_CACHE, "init_params_s": init_s,
            "prefill_s": res["prefill_s"], "decode_s": res["decode_s"],
            "decode_tokens_per_s": res["decode_tokens_per_s"],
            "first_tokens": [t[:8] for t in res["tokens"]],
            "ssm_state_bytes": res["ssm_state_bytes"],
            "conv_state_bytes": res["conv_state_bytes"],
            "kv_cache_bytes": res["kv_cache_bytes"],
            "peak_memory_bytes": torch.cuda.max_memory_allocated(),
            "prefill_launches": {k: v for k, v in
                                 res["prefill_launches"].items() if v},
            "decode_launches": {k: v for k, v in
                                res["decode_launches"].items() if v},
            "launches": launches}
    return line, launches, params, cfg


def _decode_vs_prefill(cfg, params, prompt: list[int], steps: int,
                       tol: float) -> dict:
    """Greedy decode ``steps`` tokens after ``prompt``; at each step hold
    the decode logits (the O(1) recurrence, the dense-cache attention)
    against the last-token logits of a fresh ``prefill`` over the prompt
    and the tokens so far (K9's chunked scan and K8).  Counts the values
    outside atol = rtol = ``tol``, and argmax disagreements with the
    prefill's top-2 margin."""
    import torch
    from repro_torch.models import transformer as T
    V = cfg.vocab
    seq = list(prompt)

    def tokens(ids):
        return torch.tensor([ids], dtype=torch.int32, device="cuda")

    lg, st = T.prefill(params, cfg, tokens(seq), len(prompt) + steps)
    max_err, outside, flips = 0.0, 0, []
    for _ in range(steps):
        seq.append(int(lg[0, 0, :V].argmax()))
        lg, st = T.decode_step(params, cfg, st, tokens(seq[-1:]))
        ref, _ = T.prefill(params, cfg, tokens(seq), len(seq))
        a, r = lg[0, 0, :V].float(), ref[0, 0, :V].float()
        d = (a - r).abs()
        max_err = max(max_err, float(d.max()))
        outside += int((d > tol + tol * r.abs()).sum())
        top2 = r.topk(2).values
        if int(a.argmax()) != int(r.argmax()):
            flips.append(float(top2[0] - top2[1]))
    return {"arch": cfg.name, "layers": cfg.n_layers,
            "prompt_len": len(prompt), "steps": steps,
            "logits_max_abs_err": max_err, "values_outside": outside,
            "values": steps * V, "argmax_flips_margins": flips,
            "tokens": seq[len(prompt):]}


def _layer_errors(cfg, params, prompt: list[int]) -> list[dict]:
    """Where decode and prefill part: after ``prefill(prompt)``, one
    ``decode_step`` of the greedy token against a fresh ``prefill`` over
    prompt + token.  Per Mamba layer, the largest difference of its
    output at the new position (step recurrence vs K9's chunked scan,
    relative to the prefill output's largest magnitude too) and of its
    final SSM state h."""
    import torch
    from repro_torch.models import ssm
    from repro_torch.models import transformer as T
    seen = {"prefill": [], "decode": []}
    fwd, dec = ssm.mamba_forward, ssm.mamba_decode_step

    def fwd_hook(*a, **k):
        out, st = fwd(*a, **k)
        seen["prefill"].append(out[:, -1].float())
        return out, st

    def dec_hook(*a, **k):
        out, h, c = dec(*a, **k)
        seen["decode"].append(out[:, -1].float())
        return out, h, c

    def tokens(ids):
        return torch.tensor([ids], dtype=torch.int32, device="cuda")
    lg, st = T.prefill(params, cfg, tokens(prompt), len(prompt) + 1)
    nxt = int(lg[0, 0, :cfg.vocab].argmax())
    ssm.mamba_forward, ssm.mamba_decode_step = fwd_hook, dec_hook
    try:
        _, st_d = T.decode_step(params, cfg, st, tokens([nxt]))
        _, st_p = T.prefill(params, cfg, tokens(prompt + [nxt]),
                            len(prompt) + 1)
    finally:
        ssm.mamba_forward, ssm.mamba_decode_step = fwd, dec
    out = []
    for l, (a, b) in enumerate(zip(seen["decode"], seen["prefill"])):
        ha, hb = st_d["mamba"][l]["h"], st_p["mamba"][l]["h"]
        out.append({"layer": l,
                    "out_max_abs_err": round(float((a - b).abs().max()), 6),
                    "out_rel_err": round(float((a - b).abs().max()
                                               / b.abs().max()), 6),
                    "h_max_abs_err": round(float((ha - hb).abs().max()), 6),
                    "h_rel_err": round(float((ha - hb).abs().max()
                                             / hb.abs().max()), 6)})
    return out


def run_longctx_probes(bf16_models) -> tuple[dict, dict]:
    """``longctx_probe_f32``: float32 weights at full zamba2 width cut to
    LONGCTX_PROBE_LAYERS layers (two shared-attention sites) and
    mamba2_1_3b at full depth; every decode step's logits within
    atol = rtol = LONGCTX_PROBE_TOL of a fresh prefill's, the same argmax
    unless the top-2 margin is below LONGCTX_TIE_MARGIN.  Then the same
    probe on the full-depth bf16 models, gated at LONGCTX_BF16_MAX_ERR and
    LONGCTX_BF16_TIE_MARGIN (ROADMAP C8).  Each run also localizes the
    difference per Mamba layer (``_layer_errors``)."""
    import torch
    from dataclasses import replace
    from repro_torch import kernels
    from repro_torch.configs.base import registry
    from repro_torch.models.transformer import init_params
    f32 = {"phase": "longctx_probe_f32", "tolerance": LONGCTX_PROBE_TOL,
           "tie_margin": LONGCTX_TIE_MARGIN,
           "depth_cut": {"zamba2_7b": LONGCTX_PROBE_LAYERS}, "runs": []}
    for name, layers in (("zamba2_7b", LONGCTX_PROBE_LAYERS),
                         ("mamba2_1_3b", None)):
        cfg = registry()[name]
        if layers is not None:
            cfg = replace(cfg, n_layers=layers)
        params = init_params(cfg, seed=SEED, dtype=torch.float32,
                             device="cuda")
        prompt = _prompts(1, LONGCTX_PROBE_PROMPT, cfg.vocab, SEED + 13)[0]
        kernels.reset_launch_counts()
        run = _decode_vs_prefill(cfg, params, prompt, LONGCTX_PROBE_STEPS,
                                 LONGCTX_PROBE_TOL)
        run["launches"] = {k: n for k, n in kernels.launch_counts().items()
                           if n}
        run["by_layer"] = _layer_errors(cfg, params, prompt)
        del params
        torch.cuda.empty_cache()
        f32["runs"].append(run)
        if run["values_outside"] or any(m >= LONGCTX_TIE_MARGIN
                                        for m in run["argmax_flips_margins"]):
            raise RuntimeError(f"longctx float32 probe failed: {run}")
    bf16 = {"phase": "longctx_probe_bf16", "gated": True,
            "max_abs_err_limit": LONGCTX_BF16_MAX_ERR,
            "tie_margin": LONGCTX_BF16_TIE_MARGIN,
            "tolerance_reported": LONGCTX_PROBE_TOL, "runs": []}
    for cfg, params in bf16_models:
        prompt = _prompts(1, LONGCTX_PROBE_PROMPT, cfg.vocab, SEED + 13)[0]
        run = _decode_vs_prefill(cfg, params, prompt, LONGCTX_PROBE_STEPS,
                                 LONGCTX_PROBE_TOL)
        run["by_layer"] = _layer_errors(cfg, params, prompt)
        bf16["runs"].append(run)
        if run["logits_max_abs_err"] > LONGCTX_BF16_MAX_ERR or any(
                m >= LONGCTX_BF16_TIE_MARGIN
                for m in run["argmax_flips_margins"]):
            raise RuntimeError(f"longctx bf16 probe failed: "
                               f"{ {k: v for k, v in run.items() if k != 'by_layer'} }")
    return f32, bf16


def run_longctx_card_vs_cpu() -> dict:
    """Smoke-width mamba2 and zamba2 in float32, the same weights on the
    card (kernels) and on the CPU (their plain versions): 2 prompts of
    LONGCTX_CROSS_PROMPT tokens (ragged against the smoke chunk of 8),
    LONGCTX_CROSS_STEPS decode steps.  Logits and every state within
    LONGCTX_CROSS_TOL, positions and tokens identical."""
    import torch
    from repro_torch import kernels
    from repro_torch.configs.base import registry, smoke
    from repro_torch.launch.longctx_decode import generate
    from repro_torch.models.transformer import init_params
    out = {"phase": "longctx_card_vs_cpu", "tolerance": LONGCTX_CROSS_TOL,
           "runs": []}
    for name in ("mamba2_1_3b", "zamba2_7b"):
        cfg = smoke(registry()[name])
        cpu = init_params(cfg, seed=SEED, device="cpu")
        card = _to_device(cpu, "cuda")
        prompts = _prompts(2, LONGCTX_CROSS_PROMPT, cfg.vocab, SEED + 12)
        cache = LONGCTX_CROSS_PROMPT + LONGCTX_CROSS_STEPS
        kernels.reset_launch_counts()
        got = generate(card, cfg, prompts, LONGCTX_CROSS_STEPS, cache)
        launches = kernels.launch_counts()
        want = generate(cpu, cfg, prompts, LONGCTX_CROSS_STEPS, cache)
        if launches["ssd_scan"] != cfg.n_layers or \
                launches["flash_attention"] != _shared_sites(cfg):
            raise RuntimeError(f"{name} smoke on the card launched "
                               f"{launches}")
        pairs = [("first_logits", got["first_logits"],
                  want["first_logits"]),
                 ("logits", got["logits"], want["logits"])]
        gs, ws = got["state"], want["state"]
        for l, (a, b) in enumerate(zip(gs["mamba"], ws["mamba"])):
            pairs += [(f"h{l}", a["h"], b["h"]),
                      (f"conv{l}", a["conv"], b["conv"])]
        for i, (a, b) in enumerate(zip(gs["attn"], ws["attn"])):
            pairs += [(f"k{i}", a["k"], b["k"]), (f"v{i}", a["v"], b["v"])]
            if not torch.equal(a["pos"].cpu(), b["pos"]):
                raise RuntimeError(f"{name}: cache positions differ")
        errs = {}
        for what, a, b in pairs:
            a = a.float().cpu()
            errs[what] = float((a - b.float()).abs().max())
            if not torch.allclose(a, b.float(), atol=LONGCTX_CROSS_TOL,
                                  rtol=LONGCTX_CROSS_TOL):
                raise RuntimeError(f"{name}: card vs CPU {what} differ by "
                                   f"{errs[what]}")
        if got["tokens"] != want["tokens"] or \
                not torch.equal(gs["positions"].cpu(), ws["positions"]):
            raise RuntimeError(f"{name}: card vs CPU tokens differ")
        out["runs"].append({
            "arch": name, "launches": {k: v for k, v in launches.items()
                                       if v},
            "logits_max_abs_err": max(errs["first_logits"], errs["logits"]),
            "state_max_abs_err": max(v for k, v in errs.items()
                                     if "logits" not in k),
            "tokens_identical": True})
    return out


def _flash_f32_extra(K8, q, k, v, out, lib, hmma: int) -> dict:
    """What a float32 K8 row adds: its design, HMMA count, device times
    (CUDA graphs of 10 calls) of the kernel and of SDPA, SDPA's own error
    against the plain version and the kernels SDPA runs, and the plan."""
    B, S, Hq, D = q.shape
    ref = K8.flash_attention_plain(q, k, v)
    lib_err = float((lib().transpose(1, 2) - ref).abs().max())
    del ref
    return {"design": "3xTF32 on mma.sync m16n8k8 from a cp.async ring",
            "sass_hmma": hmma,
            "device_ms": _graph_ms(lambda: K8.flash_attention(q, k, v),
                                   calls=10, replays=10),
            "library_device_ms": _graph_ms(lib, calls=10, replays=10),
            "library_max_abs_err": lib_err,
            "library_kernels": _device_kernels(lib),
            "plan": K8.launch_info(B, S, Hq, D)}


def bench_longctx_kernels(zlaunch: dict, mlaunch: dict, f32_launches: dict,
                          full_f32_launches: dict
                          ) -> tuple[list[dict], dict]:
    """K8 and K9 against their plain versions on the card at the shapes of
    the long-context path, with seeded random bf16 inputs: K8 at zamba2's
    prefill shape, at a GQA shape and with a 512-token window (each with
    the HGMMA count of its bf16 kernel and the factor over SDPA), and
    K8's float32 entry at the float32 probe's shape and at zamba2's (its
    HMMA count, device times, SDPA's error and kernels); K9 at zamba2's and
    mamba2's shapes and its float32 entry at the float32 probe's shape
    and at zamba2's and mamba2's prefill shapes, each with its device
    time over a CUDA graph, the device work nodes of one call, its launch
    plan and the HMMA counts of its three tensor-core kernels.
    ``launches`` is the kernel's count in the zamba2 (K8, K9) or mamba2
    (K9) run, for the float32 probe-shape rows in the float32 zamba2
    probe (``f32_launches``, that run's counts) and for K9's full float32
    rows in the float32 long-context runs (``full_f32_launches``, by
    arch).  Returns the rows and the ``ssd_scan_passes`` line: K9's
    kernels timed one by one at every shape."""
    import numpy as np
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels import flash_attention as K8
    from repro_torch.kernels import ssd_scan as K9
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev)
    gen.manual_seed(SEED + 14)
    bf = torch.bfloat16
    rows = []
    hgmma = _sass_count("flash_wgmma_kernel", "HGMMA")
    hmma_f32 = _sass_count("flash_f32_kernel", "HMMA")
    if not hmma_f32:
        raise RuntimeError("flash_attention_f32: no HMMA in the float32 "
                           "kernel")
    gen_f32 = torch.Generator(device=dev)   # keeps K9's inputs as they were
    gen_f32.manual_seed(SEED + 15)

    def randn(*shape, g=gen):
        return torch.randn(shape, generator=g, device=dev)

    def row(name, kernel, src, replaces, err, tol, ms, plain_ms, bound,
            library_ms, launches, **extra):
        rows.append({"name": name, "kernel": kernel, "route": "cuda",
                     "source": src, "replaces": replaces,
                     "launches": launches, "max_abs_err": err,
                     "tolerance": tol, "ms": ms, "plain_ms": plain_ms,
                     "bound_ms": bound[0], "bound_by": bound[1],
                     "library_ms": library_ms, **extra})

    for name, B, S, Hq, Hkv, D, window, dtype in (
            ("flash_attention", LONGCTX_BATCH, LONGCTX_PROMPT, 32, 32, 112,
             0, bf),
            ("flash_attention_gqa", *FLASH_GQA_SHAPE, 0, bf),
            ("flash_attention_window", LONGCTX_BATCH, LONGCTX_PROMPT, 32, 32,
             112, 512, bf),
            ("flash_attention_f32", 1, LONGCTX_PROBE_PROMPT, 32, 32, 112, 0,
             torch.float32)):
        g = gen if dtype == bf else gen_f32
        q, k, v = (randn(B, S, h, D, g=g).to(dtype) for h in (Hq, Hkv, Hkv))
        out = K8.flash_attention(q, k, v, window=window)
        ref = K8.flash_attention_plain(q, k, v, window=window)
        torch.cuda.synchronize()
        tol = FLASH_TOL if dtype == bf else FLASH_F32_TOL
        if not torch.allclose(out.float(), ref.float(), atol=tol, rtol=tol):
            raise RuntimeError(f"{name} kernel disagrees with plain")
        diff = (out.float() - ref.float()).abs()
        err = float(diff.max())
        err_at = float(ref.float().flatten()[diff.argmax()].abs())
        del ref, diff
        i = np.arange(S)
        pairs = float(np.minimum(i + 1, window if window else S).sum())
        G = Hq // Hkv
        qt = q.transpose(1, 2)
        kt = k.transpose(1, 2).repeat_interleave(G, dim=1)
        vt = v.transpose(1, 2).repeat_interleave(G, dim=1)
        if window:
            ii = torch.arange(S, device=dev)
            mask = (ii[None, :] <= ii[:, None]) & \
                (ii[:, None] - ii[None, :] < window)
            lib = lambda: F.scaled_dot_product_attention(qt, kt, vt,
                                                         attn_mask=mask)
        else:
            lib = lambda: F.scaled_dot_product_attention(qt, kt, vt,
                                                         is_causal=True)
        size = q.element_size()
        row(name, "flash_attention",
            "src/repro_torch/kernels/csrc/flash_attention.cu",
            "src/repro/kernels/flash_attention/flash_attention.py:78",
            err, tol,
            _time_ms(lambda: K8.flash_attention(q, k, v, window=window),
                     iters=10, warmup=2),
            _time_ms(lambda: K8.flash_attention_plain(q, k, v,
                                                      window=window),
                     iters=3, warmup=1),
            _bound_ms(size * (2 * q.numel() + 2 * k.numel()),
                      4.0 * B * Hq * D * pairs,
                      flops_per_s=BF16_FLOPS_PER_S if dtype == bf
                      else F32_TC_FLOPS_PER_S),
            _time_ms(lib, iters=10, warmup=2),
            zlaunch["flash_attention"] if dtype == bf
            else f32_launches.get("flash_attention", 0),
            shape={"B": B, "S": S, "Hq": Hq, "Hkv": Hkv, "D": D,
                   "causal": True, "window": window,
                   "dtype": str(dtype).removeprefix("torch.")},
            library_call="scaled_dot_product_attention (KV expanded to Hq "
                         "heads outside the timing; a boolean window mask)"
            if window else "scaled_dot_product_attention, is_causal "
                           "(KV expanded to Hq heads outside the timing)")
        kr = rows[-1]
        kr["sdpa_factor"] = kr["ms"] / kr["library_ms"]
        kr["abs_ref_at_max_err"] = err_at
        if dtype == bf:
            kr["design"] = "wgmma from TMA-loaded tiles"
            kr["sass_hgmma"] = hgmma
            if not hgmma:
                raise RuntimeError(f"{name}: no HGMMA in the bf16 kernel")
        else:
            kr.update(_f32_bounds(size * (2 * q.numel() + 2 * k.numel()),
                                  4.0 * B * Hq * D * pairs))
            kr.update(_flash_f32_extra(K8, q, k, v, out, lib, hmma_f32))
            # zamba2's prefill shape in float32, new inputs after the
            # probe shape's
            zq, zk, zv = (randn(LONGCTX_BATCH, LONGCTX_PROMPT, 32, 112,
                                g=gen_f32) for _ in range(3))
            zout = K8.flash_attention(zq, zk, zv)
            zref = K8.flash_attention_plain(zq, zk, zv)
            torch.cuda.synchronize()
            if not torch.allclose(zout, zref, atol=tol, rtol=tol):
                raise RuntimeError(f"{name} kernel disagrees with plain at "
                                   f"zamba2's shape")
            zerr = float((zout - zref).abs().max())
            del zref
            zlib = (lambda a, b, c: lambda: F.scaled_dot_product_attention(
                a, b, c, is_causal=True))(*(t.transpose(1, 2)
                                             for t in (zq, zk, zv)))
            zpairs = float(np.arange(1, LONGCTX_PROMPT + 1).sum())
            kr["zamba2_shape"] = {
                "shape": {"B": LONGCTX_BATCH, "S": LONGCTX_PROMPT, "Hq": 32,
                          "Hkv": 32, "D": 112},
                "max_abs_err": zerr,
                "ms": _time_ms(lambda: K8.flash_attention(zq, zk, zv),
                               iters=5, warmup=1),
                "library_ms": _time_ms(zlib, iters=5, warmup=1),
                **_f32_bounds(4 * 4 * zq.numel(),
                              4.0 * LONGCTX_BATCH * 32 * 112 * zpairs),
                **_flash_f32_extra(K8, zq, zk, zv, zout, zlib, hmma_f32)}
            del zq, zk, zv, zout, zlib
        del q, k, v, qt, kt, vt, out, lib
        torch.cuda.empty_cache()

    sass = {k: _sass_count(k, "HMMA") for k in SSD_TENSOR_CORE_KERNELS}
    if not all(sass.values()):
        raise RuntimeError(f"ssd_scan: a tensor-core kernel has no HMMA: "
                           f"{sass}")
    passes = []
    for name, B, L, H, P, N, dtype, launches in (
            ("ssd_scan", LONGCTX_BATCH, LONGCTX_PROMPT, 112, 64, 64, bf,
             zlaunch["ssd_scan"]),
            ("ssd_scan_mamba2", LONGCTX_BATCH, LONGCTX_PROMPT, 64, 64, 128,
             bf, mlaunch["ssd_scan"]),
            ("ssd_scan_f32", 1, LONGCTX_PROBE_PROMPT, 112, 64, 64,
             torch.float32, f32_launches.get("ssd_scan", 0)),
            ("ssd_scan_f32_zamba2", LONGCTX_BATCH, LONGCTX_PROMPT, 112, 64,
             64, torch.float32, full_f32_launches["zamba2_7b"]["ssd_scan"]),
            ("ssd_scan_f32_mamba2", LONGCTX_BATCH, LONGCTX_PROMPT, 64, 64,
             128, torch.float32,
             full_f32_launches["mamba2_1_3b"]["ssd_scan"])):
        Q = 128
        g = gen if dtype == bf else gen_f32
        x = randn(B, L, H, P, g=g).to(dtype)
        dt = F.softplus(randn(B, L, H, g=g))
        A = -torch.exp(0.5 * randn(H, g=g))
        Bm, Cm = (randn(B, L, N, g=g).to(dtype),
                  randn(B, L, N, g=g).to(dtype))
        y, h = K9.ssd_scan(x, dt, A, Bm, Cm, Q)
        yp, hp = K9.ssd_scan_plain(x, dt, A, Bm, Cm, Q)
        torch.cuda.synchronize()
        for what, a, b in (("y", y, yp), ("h_final", h, hp)):
            if not torch.allclose(a, b, rtol=SSD_TOL,
                                  atol=SSD_TOL * float(b.abs().max())):
                raise RuntimeError(f"{name} kernel {what} disagrees with "
                                   f"plain")
        err = max(float((y - yp).abs().max()), float((h - hp).abs().max()))
        scale = max(float(yp.abs().max()), float(hp.abs().max()))
        del yp, hp
        size = x.element_size()
        nbytes = (size * (x.numel() + Bm.numel() + Cm.numel())
                  + 4 * dt.numel() + 4 * H + 4 * y.numel() + 4 * h.numel())
        # the products the function needs: per chunk of q steps the
        # q (q + 1) / 2 pairs j <= i of C.B^T once for all heads (G = 1)
        # and of its decayed product with x per head; per step and head
        # the chunk states and C.h_prev
        steps = [min(Q, L - t0) for t0 in range(0, L, Q)]
        pairs = sum(n * (n + 1) // 2 for n in steps)
        flops = (2.0 * B * pairs * (N + H * P)
                 + 4.0 * B * H * L * N * P)

        def call():
            return K9.ssd_scan(x, dt, A, Bm, Cm, Q)
        row(name, "ssd_scan", "src/repro_torch/kernels/csrc/ssd_scan.cu",
            "src/repro/kernels/ssd_scan/ssd_scan.py:72", err, SSD_TOL,
            _time_ms(call, iters=10, warmup=2),
            _time_ms(lambda: K9.ssd_scan_plain(x, dt, A, Bm, Cm, Q),
                     iters=3, warmup=1),
            _bound_ms(nbytes, flops,
                      flops_per_s=BF16_FLOPS_PER_S if dtype == bf
                      else F32_TC_FLOPS_PER_S),
            None, launches,
            shape={"B": B, "L": L, "H": H, "P": P, "N": N, "chunk": Q,
                   "dtype": str(dtype).removeprefix("torch.")},
            output_max_abs=scale,
            library_note="no single PyTorch call computes the SSD scan",
            device_ms=_graph_ms(call, calls=10, replays=10),
            kernels_per_call=_graph_launches(call),
            plan=K9.launch_info(B, L, H, P, N, Q, dtype))
        kr = rows[-1]
        kr["sass_hmma"] = {k: v for k, v in sass.items()
                           if ("bf" in k) == (dtype == bf)}
        passes.append({"name": name, "calls": 10,
                       "ms": _kernel_ms(call, K9.PASSES, calls=10)})
        if dtype == bf:
            kr["design"] = ("chunk-parallel: prologue (cumsum, C.B^T once "
                            "per chunk), chunk states, state passing, chunk "
                            "output; mma.sync with float32 operands in two "
                            "bf16 terms")
        else:
            kr["design"] = ("the same four passes, every product in 3xTF32 "
                            "on mma.sync m16n8k8")
            kr.update(_f32_bounds(nbytes, flops))
        del x, dt, Bm, Cm, y, h
        torch.cuda.empty_cache()
    pass_line = {"phase": "ssd_scan_passes", "runs": passes,
                 "note": "device ms of one launch of each of K9's kernels "
                         "(one each per call), the mean of the instances "
                         "torch.profiler traced over the calls"}
    return rows, pass_line


# =============================================================================
# phases 21-23: multi-tenant QoS trace replay and the serve entry point
# =============================================================================

TRACE_DIR = Path(__file__).resolve().parent / "benchmarks" / "traces"
# the QoS runs in the shape of the reference's QoS benchmark engine: a
# pinned two-tier store of 12 HBM and 96 NVM slots, 8-token pages, 4
# rows, K = 4, memos every 8 steps, 8 pages a sequence, prefill on,
# synchronous memos (a deterministic step timeline)
QOS_FAST, QOS_SLOW = 12, 96
QOS_POWER_BUDGET_FRAC = 0.5
# kernels every QoS run must launch: K1's prefill body in each prefill
# dispatch, the append, K2's records, K3a/K3b in the memos moves and K7
# at each pass (the decode's K1 runs over one pool or two, as the
# pages lie: the single- and dual-pool counts are checked together)
QOS_KERNELS = ("qkv_rope_append", "touch_update", "page_gather",
               "page_scatter", "sysmon_pass")


def _qos_engine(cfg, params, qos):
    from repro_torch.core.hierarchy import MemoryHierarchy
    from repro_torch.serving.engine import PagedServingEngine, ServeConfig
    return PagedServingEngine(cfg, params, ServeConfig(
        page_size=8, max_batch=4, fast_slots=QOS_FAST, slow_slots=QOS_SLOW,
        hierarchy=MemoryHierarchy.two_tier(QOS_FAST, QOS_SLOW,
                                           pinned_slow=True),
        memos_interval=8, memos_enabled=True, max_pages_per_seq=8,
        decode_block=4, overlap_plan=False, qos=qos, prefill=True),
        device="cuda")


def _replay(engine, meta, events, max_steps: int = 100_000):
    """Open-loop replay on the engine's step clock (each event submitted
    once the clock reaches ``floor(t * steps_per_s)``).  Returns the
    requests in event order, the steps' stats and the wall seconds."""
    from collections import deque
    steps_per_s = meta["steps_per_s"]
    base = engine.step_count
    pending = deque(events)
    reqs, hist = {}, []
    t0 = time.perf_counter()
    while pending or not engine.batcher.all_done():
        while pending and \
                base + pending[0].step(steps_per_s) <= engine.step_count:
            ev = pending.popleft()
            reqs[ev.rid] = engine.submit(ev.prompt, ev.max_new,
                                         tenant=ev.tenant)
        hist.append(engine.step())
        if engine.step_count - base >= max_steps:
            raise RuntimeError("replay did not drain: scheduler wedged")
    dt = time.perf_counter() - t0
    return [reqs[e.rid] for e in events], hist, dt


def _pct(vals, q):
    import numpy as np
    return float(np.percentile(np.asarray(vals, np.float64), q)) \
        if vals else None


def _tenant_stats(meta, events, reqs) -> dict:
    """Per tenant: TTFT on the step clock and the wall clock, mean
    inter-token latency, e2e p99 and step-clock SLO attainment against
    the class's ``ttft_steps``."""
    import numpy as np
    from repro_torch.qos.tenants import CLASS_DEFAULTS
    out = {}
    for tenant, cls in sorted(meta["tenants"].items()):
        rs = [r for e, r in zip(events, reqs) if e.tenant == tenant]
        done = [r for r in rs if r.error is None and r.finish_step is not None]
        steps = [r.first_token_step - r.arrival for r in done]
        ttft = [r.ttft_s for r in done]
        itl = [(r.finish_ts - r.first_token_ts) / (len(r.generated) - 1)
               for r in done if len(r.generated) > 1]
        slo = CLASS_DEFAULTS[cls][2].ttft_steps
        out[tenant] = {
            "class": cls, "requests": len(rs), "completed": len(done),
            "tokens": int(sum(len(r.generated) for r in rs)),
            "ttft_steps_p50": _pct(steps, 50),
            "ttft_steps_p99": _pct(steps, 99),
            "ttft_ms_p50": None if not ttft else _pct(ttft, 50) * 1e3,
            "ttft_ms_p99": None if not ttft else _pct(ttft, 99) * 1e3,
            "itl_ms_mean": None if not itl else float(np.mean(itl)) * 1e3,
            "e2e_ms_p99": _pct([r.e2e_s * 1e3 for r in done], 99),
            "slo_ttft_steps": slo,
            "slo_attainment": (None if slo is None or not steps else
                               float(np.mean([s <= slo for s in steps]))),
        }
    return out


def _watch_admissions(eng) -> list:
    """Records (admission width, running rows after admitting) for every
    ``admit`` call of the engine's batcher that admitted a request.  The
    width is read from the governor at the call (``max_batch -
    throttle``), not taken from the limit the engine passes, so a gate on
    it tests the engine's wiring of the governor into admission."""
    seen = []
    orig = eng.batcher.admit
    gov, max_batch = eng.memos.governor, eng.scfg.max_batch

    def watched(limit=None):
        width = max_batch if gov is None else gov.batch_limit(max_batch)
        admitted = orig(limit)
        if admitted:
            seen.append((width, len(eng.batcher.running)))
        return admitted
    eng.batcher.admit = watched
    return seen


def _qos_run(cfg, params, qos, trace: str, run: str):
    """One replay of ``trace`` through a fresh QoS engine, launch counts
    set to 0 just before and read just after.  Every request must
    complete; the launches must cover ``QOS_KERNELS`` and K1.  Returns
    the run's line, its requests in event order, the closed engine and
    its admissions (``_watch_admissions``)."""
    import torch
    from repro_torch import kernels, obs
    from repro_torch.qos import traces
    meta, events = traces.read_trace(TRACE_DIR / f"{trace}.jsonl")
    eng = _qos_engine(cfg, params, qos)
    admissions = _watch_admissions(eng)
    watch = _watch_prefill(eng)
    torch.cuda.synchronize()
    obs.reset()
    kernels.reset_launch_counts()
    reqs, hist, dt = _replay(eng, meta, events)
    torch.cuda.synchronize()
    launches = kernels.launch_counts()
    flat = obs.get_registry().flat()
    eng.close()
    bad = [r.rid for r in reqs
           if r.error is not None or len(r.generated) != r.max_new]
    if bad:
        raise RuntimeError(f"{run}: requests {bad} did not complete")
    if not torch.isfinite(eng.last_logits.float()).all():
        raise RuntimeError(f"{run}: non-finite logits")
    _check_launches(launches, QOS_KERNELS, run)
    if not watch["launches"]["paged_attention_prefill"] + \
            watch["launches"]["paged_attention_prefill_dual"]:
        raise RuntimeError(f"{run}: no prefill dispatch launched K1")
    if not launches["paged_attention"] + launches["paged_attention_dual"]:
        raise RuntimeError(f"{run}: the decode never launched K1")
    prefills = int(flat.get("serving.prefill_dispatches", 0))
    inner = _check_rope_append(launches, cfg, hist, run, prefills)
    gen = sum(len(r.generated) for r in reqs)
    reps = eng.memos.reports
    out = {
        "run": run, "trace": trace, "requests": len(reqs),
        "seconds": dt, "generated": gen,
        "generated_tokens_per_s": gen / dt,
        "engine_steps": eng.step_count,
        "dispatches": int(flat.get("serving.dispatches", 0)),
        "prefill_dispatches": prefills,
        "decode_inner_steps": inner,
        "admissions": eng.batcher.n_admitted,
        "preemptions": eng.batcher.n_preempted,
        "memos_passes": len(reps),
        "migrated": sum(r.migrations.migrated for r in reps),
        "tenants": _tenant_stats(meta, events, reqs),
        "launches": {k: v for k, v in launches.items() if v},
    }
    return out, reqs, eng, admissions


def _page8_kernels(cfg, eng) -> list[dict]:
    """K1's decode and prefill bodies, over one pool and over two, on the
    QoS engine's 8-token pages (HBM and pinned pools refilled with random
    bf16 KV after its run), against their plain versions within
    ``ATTN_TOL``: no other phase runs page 8 at full width."""
    import numpy as np
    import torch
    from repro_torch.kernels import paged_attention as K1
    store = eng.kv.store
    fast, pin = store.fast_pool, store.pools[eng.pinned_tier].data
    dev = fast.device
    gen = torch.Generator(device=dev)
    gen.manual_seed(SEED + 8)
    rng = np.random.RandomState(SEED + 8)
    page, P = eng.scfg.page_size, eng.scfg.max_pages_per_seq
    Hkv, G, D = cfg.n_kv_heads, cfg.n_heads // cfg.n_kv_heads, cfg.head_dim
    fast[:, 0].copy_(torch.randn(fast[:, 0].shape, generator=gen,
                                 device=dev).to(fast.dtype))
    pin[:, 0].copy_(torch.randn(pin[:, 0].shape, generator=gen,
                                device=dev).to(pin.dtype).cpu())
    kf, vf, kp, vp = fast[:, 0, 0], fast[:, 0, 1], pin[:, 0, 0], pin[:, 0, 1]
    n_fast, n_pin = fast.shape[0], pin.shape[0]

    def tables(rows):
        sel = (rng.rand(rows, P) < 0.5).astype(np.int32)
        bt = np.where(sel > 0,
                      np.stack([rng.permutation(n_pin)[:P]
                                for _ in range(rows)]),
                      np.stack([rng.permutation(n_fast)[:P]
                                for _ in range(rows)]))
        single = np.stack([rng.permutation(n_fast)[:P] for _ in range(rows)])
        return [torch.from_numpy(a.astype(np.int32)).to(dev)
                for a in (single, bt, sel)]

    # decode: batch 4, contexts up to the 64 positions a sequence holds
    B = eng.scfg.max_batch
    dec_len = torch.from_numpy(rng.randint(1, P * page + 1, size=B).astype(
        np.int32)).to(dev)
    # prefill: 4 packed segments of 16 rows, causal prefixes 1-16 after
    # 0-48 earlier positions; one table per segment, repeated per row
    seg_tables = [t.repeat_interleave(16, dim=0) for t in tables(4)]
    pre_len = torch.from_numpy(np.concatenate([
        rng.randint(0, 49) + np.arange(1, 17) for _ in range(4)]).astype(
            np.int32)).to(dev)
    out = []
    for name, rows, (single, bt, sel), lengths, one, two in (
            ("paged_attention", B, tables(B), dec_len,
             K1.paged_attention_pooled, K1.paged_attention_dual_pooled),
            ("paged_attention_prefill", 64, seg_tables, pre_len,
             K1.paged_attention_prefill_pooled,
             K1.paged_attention_prefill_dual_pooled)):
        q = (torch.randn((rows, Hkv, G, D), generator=gen, device=dev)
             * D ** -0.5).to(fast.dtype)
        for entry, got, want in (
                (name, one(q, kf, vf, single, lengths),
                 K1.paged_attention_plain(q, kf, vf, single, lengths)),
                (name + "_dual", two(q, kf, vf, kp, vp, bt, sel, lengths),
                 K1.paged_attention_dual_plain(q, kf, vf, kp, vp, bt, sel,
                                               lengths))):
            torch.cuda.synchronize()
            err = float((got.float() - want.float()).abs().max())
            if not torch.allclose(got.float(), want.float(), atol=ATTN_TOL,
                                  rtol=ATTN_TOL):
                raise RuntimeError(f"{entry} disagrees with plain at page "
                                   f"{page}: max abs err {err}")
            out.append({"name": entry, "page": page, "rows": rows,
                        "max_abs_err": err, "tolerance": ATTN_TOL})
    return out


def run_qos_overload(cfg, params) -> dict:
    """Phase 21: ``mixed_overload`` (69 requests of tenants lc/std/bat,
    about twice the engine's service rate) replayed through a QoS-aware
    engine (tenant classes, priorities, page weights) and a blind one
    (``qos=None``).  Gates: every request completes, each request's
    tokens are the same in both runs (greedy decode is per sequence, and
    a row's bits do not depend on its batch or neighbours), and lc's
    step-clock TTFT p99 in the aware run is at most the blind run's."""
    from repro_torch.qos import (BATCH, LATENCY_CRITICAL, STANDARD,
                                 QoSConfig, tenant_for_class)
    qos = QoSConfig(tenants=(tenant_for_class("lc", LATENCY_CRITICAL),
                             tenant_for_class("std", STANDARD),
                             tenant_for_class("bat", BATCH)))
    aware, areqs, aeng, _ = _qos_run(cfg, params, qos, "mixed_overload",
                                     "aware")
    blind, breqs, _, _ = _qos_run(cfg, params, None, "mixed_overload",
                                  "blind")
    differ, wrong = _corrupted_tokens(areqs, [r.generated for r in breqs])
    lc_a = aware["tenants"]["lc"]["ttft_steps_p99"]
    lc_b = blind["tenants"]["lc"]["ttft_steps_p99"]
    out = {"phase": "qos_overload", "arch": cfg.name,
           "n_layers": cfg.n_layers, "d_model": cfg.d_model,
           "dtype": "bfloat16",
           "hierarchy": f"two_tier({QOS_FAST}, {QOS_SLOW}, pinned_slow)",
           "aware": aware, "blind": blind,
           "tokens_differ": differ,
           "first_difference": _first_difference(wrong),
           "lc_ttft_steps_p99_aware": lc_a, "lc_ttft_steps_p99_blind": lc_b,
           "tokens_per_s_aware_over_blind":
               aware["generated_tokens_per_s"]
               / blind["generated_tokens_per_s"],
           # after the runs' launch counts were read
           "page8_kernels": _page8_kernels(cfg, aeng)}
    if differ:
        raise RuntimeError(f"qos_overload: {differ} tokens differ between "
                           f"the aware and blind runs, first at "
                           f"{out['first_difference']}")
    if lc_a is None or lc_b is None or lc_a > lc_b:
        raise RuntimeError(f"qos_overload: lc step-clock TTFT p99 aware "
                           f"{lc_a} > blind {lc_b}")
    return out


def run_qos_power(cfg, params) -> dict:
    """Phase 22: ``steady_power`` (40 requests) replayed with a bare
    ``QoSConfig()``, then under a budget of half the free run's peak
    modelled NVM dynamic power (``MemosReport.power_mw``, the energy
    model's reading, not the card's).  Gates: the free run has no
    governor and a peak above 0; the capped run goes over budget and
    throttles, admits while throttled, never admits past ``max_batch -
    throttle`` rows (the governor's width read at each ``admit``), and
    completes every request."""
    import numpy as np
    from repro_torch.qos import QoSConfig
    free, _, feng, _ = _qos_run(cfg, params, QoSConfig(), "steady_power",
                                "uncapped")
    free_mw = [r.power_mw for r in feng.memos.reports if r.power_mw]
    peak = max(free_mw, default=0.0)
    if feng.memos.governor is not None or not peak > 0:
        raise RuntimeError(f"qos_power: free run governor "
                           f"{feng.memos.governor}, peak {peak}")
    budget = QOS_POWER_BUDGET_FRAC * peak
    capped, _, ceng, admissions = _qos_run(
        cfg, params, QoSConfig(power_budget_mw=budget), "steady_power",
        "capped")
    gov = ceng.memos.governor
    cap_mw = [r.power_mw for r in ceng.memos.reports]
    throttles = [r.power_throttle for r in ceng.memos.reports]
    first = next((i for i, t in enumerate(throttles) if t > 0),
                 len(throttles))
    tail = [p for p in cap_mw[first:] if p > 0]
    over = [(w, n) for w, n in admissions if n > w]
    out = {"phase": "qos_power", "arch": cfg.name,
           "power_note": "modelled NVM dynamic power (the energy model's "
                         "power_mw over the wear tiers), not a reading "
                         "of the card",
           "modelled_power_mw_uncapped_peak": peak,
           "modelled_power_mw_uncapped_mean":
               float(np.mean(free_mw)) if free_mw else 0.0,
           "modelled_power_budget_mw": budget,
           "budget_frac": QOS_POWER_BUDGET_FRAC,
           "modelled_power_mw_capped_peak": max(cap_mw, default=0.0),
           "modelled_power_mw_capped_tail_mean":
               float(np.mean(tail)) if tail else 0.0,
           "over_budget_passes": gov.over_budget_passes,
           "max_throttle": max(throttles, default=0),
           "throttled_passes": sum(t > 0 for t in throttles),
           "narrowest_admission": min((w for w, _ in admissions),
                                      default=None),
           "admissions_over_width": over,
           "uncapped": free, "capped": capped}
    if not (gov.over_budget_passes > 0 and out["max_throttle"] > 0):
        raise RuntimeError(f"qos_power: the cap never throttled "
                           f"({gov.over_budget_passes} over-budget passes)")
    if over:
        raise RuntimeError(f"qos_power: admitted past the governor's width "
                           f"(width, rows): {over}")
    if not out["narrowest_admission"] or \
            out["narrowest_admission"] >= ceng.scfg.max_batch:
        raise RuntimeError(f"qos_power: no admission ran while the "
                           f"governor throttled (narrowest width "
                           f"{out['narrowest_admission']})")
    return out


def _qos_summary(overload: dict, power: dict) -> dict:
    """The QoS phases' gated and headline numbers on one short line (the
    whole lines, with every tenant's table, go to standard error)."""
    def run(r):
        return {"seconds": r["seconds"],
                "generated_tokens_per_s": r["generated_tokens_per_s"],
                "preemptions": r["preemptions"],
                "admissions": r["admissions"],
                "ttft_steps_p99": {t: v["ttft_steps_p99"]
                                   for t, v in r["tenants"].items()},
                "ttft_ms_p99": {t: v["ttft_ms_p99"]
                                for t, v in r["tenants"].items()},
                "slo_attainment": {t: v["slo_attainment"]
                                   for t, v in r["tenants"].items()}}
    keep = ("power_note", "modelled_power_mw_uncapped_peak",
            "modelled_power_mw_uncapped_mean", "modelled_power_budget_mw",
            "modelled_power_mw_capped_peak",
            "modelled_power_mw_capped_tail_mean", "over_budget_passes",
            "max_throttle", "narrowest_admission")
    return {"phase": "qos",
            "overload": {"aware": run(overload["aware"]),
                         "blind": run(overload["blind"]),
                         "tokens_differ": overload["tokens_differ"],
                         "tokens_per_s_aware_over_blind":
                             overload["tokens_per_s_aware_over_blind"]},
            "power": {**{k: power[k] for k in keep},
                      "uncapped": run(power["uncapped"]),
                      "capped": run(power["capped"])}}


SERVE_CLI_ARGVS = (["--device", "cuda"],
                   ["--device", "cuda", "--no-smoke"])


def run_serve_cli() -> dict:
    """Phase 23: ``repro_torch.launch.serve.main`` in this process, once
    with its defaults (the smoke-size qwen3_4b) and once with
    ``--no-smoke`` (qwen3_4b at published width and depth), both in
    float32 with 6 requests.  Each run's launch counts are set to 0
    just before it and read just after: its printed served count must
    equal ``--requests``, its migrations must be > 0 and the engine's
    kernels must launch."""
    import contextlib
    import io

    import torch
    from repro_torch import kernels
    from repro_torch.launch import serve
    runs = []
    for argv in SERVE_CLI_ARGVS:
        buf = io.StringIO()
        torch.cuda.synchronize()
        kernels.reset_launch_counts()
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(buf):
            rc = serve.main(argv)
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        launches = kernels.launch_counts()
        torch.cuda.empty_cache()
        lines = buf.getvalue().splitlines()
        served = int(re.match(r"served (\d+) requests", lines[0]).group(1))
        migrations = int(lines[2].rsplit(" ", 1)[1])
        runs.append({"argv": argv, "lines": lines, "seconds": dt,
                     "served": served, "requests_flag": 6,
                     "migrations": migrations,
                     "launches": {k: v for k, v in launches.items() if v}})
        if rc != 0 or served != 6 or migrations <= 0:
            raise RuntimeError(f"serve_cli {argv}: rc {rc}, served "
                               f"{served} of 6, {migrations} migrations")
        _check_launches(launches, ENGINE_KERNELS, f"serve_cli {argv}")
    return {"phase": "serve_cli", "runs": runs}


# =============================================================================

# =============================================================================
# phases 24-29: MoE serving (moe_ffn), the attn dense cache, the dense archs
# =============================================================================

MOE_ARCH = "olmoe_1b_7b"
MOE_REQUESTS = 8                       # of PROMPT_LEN + NEW_TOKENS tokens
# moe_ffn vs plain: |kernel - plain| <= tol * max|plain| + tol * |plain|.
# bf16: the kernel rounds h = silu(g) * u to bf16 from float32 sums taken
# in another order than torch.matmul's, so an element of h may land one
# bf16 ulp (2**-8 relative) apart; float32: float32 FMA chains vs
# torch.matmul's float32 sums over d and ff
MOE_TOL, MOE_F32_TOL = 3e-3, 1e-5
# longctx_mixtral: mixtral_8x7b at full width cut to 8 of 32 layers, one
# prompt of 4160 tokens and 64 greedy tokens into a cache of 4224 slots:
# the 4096-slot window ring wraps in the prefill and again in the decode
MIXTRAL_LAYERS, MIXTRAL_PROMPT, MIXTRAL_NEW = 8, 4160, 64
# its probes: 2 layers, a 4092-token prompt, 8 decode steps across
# position 4096, each against a fresh prefill (bf16 at the
# longctx_probe_bf16 gates, float32 within LONGCTX_PROBE_TOL)
MIXTRAL_PROBE_LAYERS, MIXTRAL_PROBE_PROMPT, MIXTRAL_PROBE_STEPS = 2, 4092, 8
# dense_archs: the dense archs the paged engine serves besides qwen3_4b,
# at published width and depth in bf16, 4 requests of 64 + 16 tokens
DENSE_ARCHS = ("phi3_mini_3_8b", "qwen2_5_14b", "gemma3_4b")
DENSE_REQUESTS, DENSE_PROMPT, DENSE_NEW = 4, 64, 16
MOE_KERNELS = ("paged_attention", "qkv_rope_append", "moe_ffn",
               "touch_update", "sysmon_pass")


def _moe_count_identity(cfg, reqs) -> int:
    """Σ(prompt + generated - 1) x top_k x n_layers: the router's choices
    of every processed token, once per layer."""
    return sum(len(r.prompt) + len(r.generated) - 1 for r in reqs) \
        * cfg.top_k * cfg.n_layers


def _moe_serve(cfg, params, run: str, **kw) -> tuple[dict, list, object]:
    """Serve MOE_REQUESTS requests of PROMPT_LEN + NEW_TOKENS with
    ``_serve_config(**kw)``, the launch counts read around the run: every
    decode inner step and every prefill dispatch launches moe_ffn twice
    per layer and qkv_rope_append once.  Returns (line, tokens, counts)."""
    import statistics

    import torch
    from repro_torch import kernels, obs
    from repro_torch.serving.engine import PagedServingEngine
    eng = PagedServingEngine(cfg, params, _serve_config(**kw), device="cuda")
    reqs = [eng.submit(p, NEW_TOKENS) for p in
            _prompts(MOE_REQUESTS, PROMPT_LEN, cfg.vocab, SEED + 21)]
    torch.cuda.synchronize()
    obs.reset()
    obs.configure(trace=True)
    kernels.reset_launch_counts()
    t0 = time.perf_counter()
    hist = eng.run()
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    launches = kernels.launch_counts()
    obs.configure(trace=False)
    eng.close()
    bad = [r.rid for r in reqs
           if r.error is not None or len(r.generated) != NEW_TOKENS]
    if bad:
        raise RuntimeError(f"moe_engine {run}: requests {bad} did not "
                           f"complete")
    if not torch.isfinite(eng.last_logits.float()).all():
        raise RuntimeError(f"moe_engine {run}: non-finite logits")
    n_pre = int(obs.get_registry().counter(
        "serving.prefill_dispatches").value)
    inner = _check_rope_append(launches, cfg, hist, f"moe_engine {run}",
                               n_pre)
    want = 2 * cfg.n_layers * (inner + n_pre)
    if launches["moe_ffn"] != want:
        raise RuntimeError(f"moe_engine {run}: {launches['moe_ffn']} moe_ffn "
                           f"launches, {want} expected (2 x {cfg.n_layers} "
                           f"layers x ({inner} inner steps + {n_pre} prefill "
                           f"dispatches))")
    _check_launches(launches, MOE_KERNELS, f"moe_engine {run}")
    counts = eng.expert_counts.copy()
    identity = _moe_count_identity(cfg, reqs)
    # a preempted sequence keeps its pages and resumes where it stopped,
    # so no token is routed twice: the identity holds under preemption
    if int(counts.sum()) != identity:
        raise RuntimeError(f"moe_engine {run}: expert counts sum to "
                           f"{int(counts.sum())}, {identity} expected")
    ttft = sorted(r.ttft_s for r in reqs)
    store = eng.kv.store
    line = {"run": run, "seconds": dt,
            "generated_tokens_per_s": eng.tokens_out / dt,
            "ttft_s_p50": statistics.median(ttft),
            "ttft_s_p99": ttft[min(len(ttft) - 1,
                                   int(round(0.99 * (len(ttft) - 1))))],
            "dispatches": sum(1 for h in hist if "decode_block" in h),
            "decode_inner_steps": inner, "prefill_dispatches": n_pre,
            "preemptions": eng.batcher.n_preempted,
            "memos_passes": len(eng.memos.reports),
            "migrations": sum(r.migrations.migrated
                              for r in eng.memos.reports),
            "traffic_0_1_bytes": store.traffic[(0, 1)],
            "traffic_1_0_bytes": store.traffic[(1, 0)],
            "moe_ffn_launches_per_inner_step": (
                (launches["moe_ffn"] - 2 * cfg.n_layers * n_pre) / inner
                if inner else None),
            "expert_counts_sum": int(counts.sum()),
            "expert_counts_identity": identity,
            "cold_experts": int((counts == 0).sum()),
            "span_seconds": _span_seconds(),
            "launches": {k: v for k, v in launches.items() if v}}
    return line, [r.generated for r in reqs], counts


def run_moe_engine(cfg, params) -> tuple[dict, dict]:
    """``moe_engine``: olmoe_1b_7b at published width and depth in bf16,
    the ``engine`` phase's serve config, 8 requests of 128 + 32 tokens:
    the K=1 reference path and the fused dispatch over the numpy host
    tier, the fused dispatch over the pinned-host tier, and prefill.
    Gates: fused = reference = pinned tokens; equal expert counts on
    those three; every run's counts sum to the identity (preempted or
    not);
    moe_ffn launched 2 x n_layers times per inner step and per prefill
    dispatch.  Prefill's dense math runs on the bucket's rows (C6), so
    its tokens and counts are reported against the replay, not gated.
    Returns (line, the fused run's launches)."""
    import numpy as np
    from repro_torch.core.hierarchy import MemoryHierarchy
    runs, toks, counts = {}, {}, {}
    for run, kw in (("reference", {"reference": True}), ("fused", {}),
                    ("pinned", {"hierarchy": MemoryHierarchy.two_tier(
                        64, 512, pinned_slow=True)}),
                    ("prefill", {"prefill": True})):
        runs[run], toks[run], counts[run] = _moe_serve(cfg, params, run,
                                                       **kw)
    for run in ("reference", "pinned"):
        if toks[run] != toks["fused"]:
            raise RuntimeError(f"moe_engine: {run} tokens differ from the "
                               f"fused run's")
        if not np.array_equal(counts[run], counts["fused"]):
            raise RuntimeError(f"moe_engine: {run} expert counts differ "
                               f"from the fused run's")
    window = run_profiled_window(cfg, params)
    launches = runs["fused"].pop("launches")
    return {"phase": "moe_engine", "arch": cfg.name,
            "n_layers": cfg.n_layers, "d_model": cfg.d_model,
            "experts": cfg.n_experts, "top_k": cfg.top_k,
            "dtype": "bfloat16", "requests": MOE_REQUESTS,
            "prompt_len": PROMPT_LEN, "new_tokens": NEW_TOKENS,
            "tokens_identical_fused_reference_pinned": True,
            "expert_counts_equal_fused_reference_pinned": True,
            "prefill_tokens_differ": sum(
                a != b for x, y in zip(toks["prefill"], toks["fused"])
                for a, b in zip(x, y)),
            "prefill_expert_counts_l1_vs_replay": int(
                np.abs(counts["prefill"] - counts["fused"]).sum()),
            "expert_counts_top8": np.sort(counts["fused"])[::-1][:8]
            .tolist(),
            "device_busy_share": window["device_busy_share"],
            "device_ops_per_inner_step": window["device_ops_per_inner_step"],
            "runs": runs, "launches": launches}, launches


def run_moe_batch_invariance(cfg, params) -> dict:
    """``batch_invariance`` for olmoe: an engine at ``max_batch`` 8 (each
    step pads to 8 rows and routes the padding) decodes 8 rows over
    random KV, then the first r rows for r = 1..7 (r = 1: a request
    alone), then all 8 reversed: every row's logits must keep the bits
    it had in the 8-row step.  Where they do not, the step's ops are
    logged to name the first that gave other bits on equal inputs."""
    import numpy as np
    import torch
    from repro_torch.serving.engine import PagedServingEngine
    B, P = 8, 16
    gen = torch.Generator(device="cuda")
    gen.manual_seed(SEED + 22)
    rng = np.random.RandomState(SEED + 22)
    lengths = rng.randint(PROMPT_LEN + 1, PROMPT_LEN + NEW_TOKENS + 1,
                          size=B)
    eng = PagedServingEngine(cfg, params, _serve_config(
        fast_slots=B * P, slow_slots=B * P, memos_enabled=False),
        device="cuda")
    pool = eng.kv.store.fast_pool
    pool.copy_(torch.randn(pool.shape, generator=gen, device="cuda",
                           dtype=torch.float32).to(pool.dtype))
    slots = rng.permutation(B * P).reshape(B, P)
    cols = [torch.from_numpy(a.astype(np.int32)).to("cuda") for a in (
        rng.randint(0, cfg.vocab, B), lengths - 1, slots, lengths)]

    def step(rows):
        rows = torch.tensor(rows, device="cuda")
        return eng._decode_core(*(c[rows].contiguous() for c in cols))[0]

    full = step(list(range(B)))
    bits = [r for r in range(1, B) if not torch.equal(step(list(range(r))),
                                                      full[:r])]
    first = {}
    if bits:
        log, undo = _op_log()
        try:
            step(list(range(B)))
            full_log = list(log)
            for r in bits:
                log.clear()
                step(list(range(r)))
                first[r] = _first_variant_op(full_log, list(log), r)
        finally:
            undo()
    out = {"arch": cfg.name, "rows": B, "contexts": lengths.tolist(),
           "row_counts_with_other_bits": bits,
           "first_op_with_other_bits_on_equal_inputs": first,
           "alone_identical": 1 not in bits,
           "reversed_order_identical": torch.equal(
               step(list(range(B))[::-1]), full.flip(0)),
           "finite": bool(torch.isfinite(full.float()).all())}
    if bits or not out["reversed_order_identical"] or not out["finite"]:
        raise RuntimeError(f"batch_invariance (olmoe): {out}")
    del eng, pool
    return out


def _moe_inputs(d, ff, n_exp, tokens, top_k, dtype, seed):
    """Rows sorted by expert as the MoE layer makes them: ``tokens``
    tokens, each routed to ``top_k`` distinct experts of ``n_exp`` at
    random; rows of unit scale, expert weights at d**-0.5, gate weights
    summing to 1 per token.  Returns (xg, offs, [wg, wu, wd], gate,
    group sizes)."""
    import numpy as np
    import torch
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)
    rng = np.random.RandomState(seed)
    idx = np.argsort(rng.rand(tokens, n_exp), axis=1)[:, :top_k]
    sizes = np.bincount(idx.reshape(-1), minlength=n_exp)
    R = tokens * top_k

    def rnd(*shape, s=1.0):
        return (torch.randn(shape, generator=gen, device=dev) * s).to(dtype)
    xg = rnd(R, d)
    w = [rnd(n_exp, d, ff, s=d ** -0.5), rnd(n_exp, d, ff, s=d ** -0.5),
         rnd(n_exp, ff, d, s=d ** -0.5)]
    gate = torch.rand(R, generator=gen, device=dev) / top_k
    offs = torch.tensor(np.concatenate([[0], np.cumsum(sizes)]),
                        dtype=torch.int32, device=dev)
    return xg, offs, w, gate, sizes


def _grouped_mm_library(xg, offs, w, gate):
    """The grouped SwiGLU from PyTorch's own grouped GEMM
    (``torch._grouped_mm``, three calls, with the silu product and the
    gate scaling between them), or the reason it cannot run: the
    library yardstick of ``moe_ffn``, used nowhere in the port.  Returns
    (call, description) or (None, reason)."""
    import torch
    import torch.nn.functional as F
    gm = getattr(torch, "_grouped_mm", None)
    if gm is None:
        return None, "this torch has no torch._grouped_mm"
    if xg.dtype != torch.bfloat16:
        return None, "torch._grouped_mm takes bfloat16 operands only"
    ends = offs[1:].contiguous()
    errors = []
    for layout, ws in (("row-major", w), ("column-major", [
            t.transpose(1, 2).contiguous().transpose(1, 2) for t in w])):
        def call(ws=ws):
            g = gm(xg, ws[0], offs=ends)
            u = gm(xg, ws[1], offs=ends)
            h = (F.silu(g.float()) * u.float()).to(xg.dtype)
            return gm(h, ws[2], offs=ends).float() * gate[:, None]
        try:
            call()
            torch.cuda.synchronize()
            return call, (f"torch._grouped_mm x 3 ({layout} expert "
                          f"weights), silu product and gate scaling")
        except Exception as e:      # noqa: BLE001 - the reason is reported
            errors.append(f"{layout}: {type(e).__name__}: {e}"[:160])
    return None, "; ".join(errors)


def _moe_row(name, shape, dtype, tol, launches, seed, bound_f32=False,
             inputs=None):
    """One ``moe_ffn`` row: kernel vs plain within ``tol`` of max|plain|,
    CUDA-event ms of the eager call, ``device_ms`` over a CUDA graph of
    50 calls, the plain version's ms, the bound (the touched experts'
    weights, the rows and the float32 output once; 6 R d ff operations),
    the library yardstick's ms, the launch plan and the count of
    tensor-core instructions in the entry's SASS (HGMMA for bf16, HMMA
    for float32; none fails).  ``inputs`` (xg, offs, weights, gate,
    group sizes) replaces the random rows of ``shape`` (whose tokens x
    top_k must then be xg's rows)."""
    import torch
    from repro_torch.kernels import moe_ffn as KM
    d, ff, n_exp, tokens, top_k = shape
    xg, offs, w, gate, sizes = inputs or _moe_inputs(
        d, ff, n_exp, tokens, top_k, dtype, seed)
    got = KM.moe_ffn(xg, offs, *w, gate)
    want = KM.moe_ffn_plain(xg, offs, *w, gate)
    torch.cuda.synchronize()
    err = float((got - want).abs().max())
    limit = tol * float(want.abs().max())
    if not bool(((got - want).abs() <= limit + tol * want.abs()).all()):
        raise RuntimeError(f"{name} disagrees with plain: max abs err {err} "
                           f"(limit {limit} + {tol} x |plain|)")
    R = tokens * top_k
    el = xg.element_size()
    touched = int((sizes > 0).sum())
    nbytes = (touched * 3 * d * ff * el + R * d * el + R * d * 4 + R * 4
              + (n_exp + 1) * 4)
    flops = 6.0 * R * d * ff
    lib, lib_note = _grouped_mm_library(xg, offs, w, gate)
    # calls per timing sized to the kernel: ~0.2 s of eager calls and ~1 s
    # of graph replays (a mixtral prefill call takes ~10^2 ms)
    one = _time_ms(lambda: KM.moe_ffn(xg, offs, *w, gate), iters=1,
                   warmup=1)
    n = max(1, min(50, int(200 / max(one, 1e-3))))
    reps = max(1, min(20, int(1000 / max(one * n, 1e-3))))
    row = {"name": name, "route": "cuda",
           "source": "src/repro_torch/kernels/csrc/moe_ffn.cu",
           "replaces": "src/repro/models/moe.py:86",
           "replaces_note": "XLA: three lax.ragged_dot in _grouped_ffn (no "
                            "Pallas kernel)",
           "launches": launches, "max_abs_err": err,
           "tolerance": f"{tol} x max|plain| + {tol} x |plain|",
           "ms": _time_ms(lambda: KM.moe_ffn(xg, offs, *w, gate), iters=n,
                          warmup=1),
           "device_ms": _graph_ms(lambda: KM.moe_ffn(xg, offs, *w, gate),
                                  calls=n, replays=reps),
           "plain_ms": _time_ms(lambda: KM.moe_ffn_plain(xg, offs, *w, gate),
                                iters=3, warmup=1),
           "library_ms": (_time_ms(lib, iters=n, warmup=1)
                          if lib is not None else None),
           "library_call": lib_note,
           "shape": {"d": d, "ff": ff, "experts": n_exp, "tokens": tokens,
                     "top_k": top_k, "rows": R, "touched_experts": touched,
                     "dtype": str(dtype).removeprefix("torch.")},
           "timing_calls": {"eager": n, "graph": n, "replays": reps},
           "note": "ms, library_ms: CUDA events around eager calls; "
                   "device_ms: per call of a CUDA graph of timing_calls "
                   "calls (two launches each)"}
    if lib is not None:
        row["library_device_ms"] = _graph_ms(lib, calls=n, replays=reps)
        row["library_max_abs_err"] = float((lib() - want).abs().max())
    if bound_f32:
        row.update(_f32_bounds(nbytes, flops))
    else:
        row["bound_ms"], row["bound_by"] = _bound_ms(nbytes, flops)
    row["plan"] = KM.launch_info(dtype, R, n_exp)
    sass = (("sass_hgmma", "moe_wgmma_kernel", "HGMMA")
            if dtype == torch.bfloat16 else
            ("sass_hmma", "moe_tf32_kernel", "HMMA"))
    row[sass[0]] = _sass_count(sass[1], sass[2])
    if not row[sass[0]]:
        raise RuntimeError(f"{name}: no {sass[2]} in {sass[1]}'s SASS")
    del xg, w, got, want
    torch.cuda.empty_cache()
    return row


def bench_moe_kernels(launches: dict) -> list[dict]:
    """``moe_ffn``'s rows at the shapes its paths give it: olmoe's decode
    (8 tokens x top 8 = 64 rows over 64 experts), olmoe's 256-row prefill
    bucket (2048 rows), mixtral's long prefill (4160 x 2 rows over 8
    experts) and decode (1 token x top 2, the most weight bytes a launch)
    in bf16; olmoe's decode and the mixtral probe's prefill (4092 x 2
    rows) in float32.  ``launches`` holds each path's count."""
    import torch
    olmoe = (2048, 1024, 64)
    mixtral = (4096, 14336, 8)
    bf16, f32 = torch.bfloat16, torch.float32
    return [
        _moe_row("moe_ffn", (*olmoe, 8, 8), bf16, MOE_TOL,
                 launches["moe_engine"], SEED + 30),
        _moe_row("moe_ffn prefill", (*olmoe, 256, 8), bf16, MOE_TOL,
                 launches["moe_prefill"], SEED + 31),
        _moe_row("moe_ffn mixtral", (*mixtral, MIXTRAL_PROMPT, 2), bf16,
                 MOE_TOL, launches["longctx_mixtral"], SEED + 32),
        _moe_row("moe_ffn mixtral decode", (*mixtral, 1, 2), bf16, MOE_TOL,
                 launches["longctx_mixtral_decode"], SEED + 36),
        _moe_row("moe_ffn_f32", (*olmoe, 8, 8), f32, MOE_F32_TOL,
                 launches["moe_f32"], SEED + 33, bound_f32=True),
        _moe_row("moe_ffn_f32 mixtral", (*mixtral, MIXTRAL_PROBE_PROMPT, 2),
                 f32, MOE_F32_TOL, launches["mixtral_probe_f32"],
                 SEED + 34, bound_f32=True)]


def run_moe_ffn_invariance() -> dict:
    """``prefill_invariance`` for ``moe_ffn`` alone, at olmoe's widths in
    bf16 and float32: a row's output bits in a 1-row group, in a 128-row
    group and in a 2048-row group (at several places) are the same."""
    import torch
    from repro_torch.kernels import moe_ffn as KM
    dev = torch.device("cuda")
    out = {}
    for dtype in (torch.bfloat16, torch.float32):
        xg, _, w, gate, _ = _moe_inputs(2048, 1024, 1, 2048, 1, dtype,
                                        SEED + 35)

        def run(rows):
            rows = torch.as_tensor(rows, device=dev)
            offs = torch.tensor([0, rows.numel()], dtype=torch.int32,
                                device=dev)
            return KM.moe_ffn(xg[rows].contiguous(), offs, *w,
                              gate[rows].contiguous())
        full = run(list(range(2048)))
        differ = []
        for r in (0, 31, 32, 777, 2047):
            alone = run([r])[0]
            group = run([(r + i) % 2048 for i in range(128)])[0]
            if not (torch.equal(alone, full[r])
                    and torch.equal(group, full[r])):
                differ.append(r)
        out[str(dtype).removeprefix("torch.")] = {
            "rows_checked": [0, 31, 32, 777, 2047],
            "rows_with_other_bits": differ}
        if differ:
            raise RuntimeError(f"moe_ffn row bits depend on the group "
                               f"({dtype}): rows {differ}")
    return out


def run_longctx_mixtral() -> tuple[dict, dict]:
    """``longctx_mixtral``: ``generate`` with mixtral_8x7b at full width
    (window 4096) cut to MIXTRAL_LAYERS layers in bf16: one prompt of
    MIXTRAL_PROMPT tokens, MIXTRAL_NEW greedy tokens into a cache of
    prompt + new slots, so each layer's 4096-slot ring wraps in both
    halves.  The prefill launches K8 (windowed) once per layer and
    moe_ffn twice per layer, the decode moe_ffn twice per layer per token
    and nothing else; the K/V state stays the ring's whatever the
    context.  Returns (line, launches per half)."""
    import numpy as np
    import torch
    from dataclasses import replace
    from repro_torch import kernels
    from repro_torch.configs.base import registry
    from repro_torch.launch.longctx_decode import generate
    from repro_torch.models.transformer import init_decode_state, \
        init_params
    cfg = replace(registry()["mixtral_8x7b"], n_layers=MIXTRAL_LAYERS)
    t0 = time.perf_counter()
    params = init_params(cfg, seed=SEED, dtype=torch.bfloat16,
                         device="cuda")
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    cache = MIXTRAL_PROMPT + MIXTRAL_NEW
    prompt = _prompts(1, MIXTRAL_PROMPT, cfg.vocab, SEED + 23)
    torch.cuda.reset_peak_memory_stats()
    kernels.reset_launch_counts()
    res = generate(params, cfg, prompt, MIXTRAL_NEW, cache)
    L = cfg.n_layers
    want_pre = {"flash_attention": L, "moe_ffn": 2 * L}
    want_dec = {"moe_ffn": 2 * L * MIXTRAL_NEW}
    got_pre = {k: v for k, v in res["prefill_launches"].items() if v}
    got_dec = {k: v for k, v in res["decode_launches"].items() if v}
    if got_pre != want_pre or got_dec != want_dec:
        raise RuntimeError(f"longctx_mixtral launched {got_pre} / {got_dec}"
                           f", want {want_pre} / {want_dec}")
    empty = init_decode_state(cfg, 1, cache, dtype=torch.bfloat16,
                              device="cuda")
    ring = sum(t.numel() * t.element_size() for c in empty["attn"]
               for t in c.values())
    if res["kv_cache_bytes"] != ring or \
            empty["attn"][0]["k"].shape[1] != cfg.sliding_window:
        raise RuntimeError(f"longctx_mixtral: state of {res['kv_cache_bytes']}"
                           f" bytes, a {cfg.sliding_window}-slot ring holds "
                           f"{ring}")
    V = cfg.vocab
    for key in ("first_logits", "logits"):
        if not bool(torch.isfinite(res[key][..., :V]).all()):
            raise RuntimeError(f"longctx_mixtral: non-finite {key}")
    toks = np.asarray(res["tokens"])
    if toks.shape != (1, MIXTRAL_NEW) or toks.min() < 0 or toks.max() >= V:
        raise RuntimeError(f"longctx_mixtral: bad tokens {toks.shape}")
    line = {"phase": "longctx_mixtral", "arch": cfg.name, "dtype": "bfloat16",
            "layers": L, "layers_published": 32, "d_model": cfg.d_model,
            "experts": cfg.n_experts, "top_k": cfg.top_k,
            "window": cfg.sliding_window, "prompt_len": MIXTRAL_PROMPT,
            "new_tokens": MIXTRAL_NEW, "cache_len": cache,
            "init_params_s": init_s, "prefill_s": res["prefill_s"],
            "decode_s": res["decode_s"],
            "decode_tokens_per_s": res["decode_tokens_per_s"],
            "first_tokens": res["tokens"][0][:8],
            "kv_cache_bytes": res["kv_cache_bytes"],
            "kv_cache_bytes_constant_in_context": True,
            "peak_memory_bytes": torch.cuda.max_memory_allocated(),
            "prefill_launches": got_pre, "decode_launches": got_dec}
    del params, res
    torch.cuda.empty_cache()
    return line, {"prefill": got_pre, "decode": got_dec}


def run_mixtral_probes() -> tuple[dict, dict, int]:
    """``longctx_mixtral_probe_bf16`` and ``_f32``: ``_decode_vs_prefill``
    at mixtral's full width cut to MIXTRAL_PROBE_LAYERS layers, a
    MIXTRAL_PROBE_PROMPT-token prompt and MIXTRAL_PROBE_STEPS steps, so
    the decode crosses position 4096 and its ring wraps.  bf16 within
    LONGCTX_BF16_MAX_ERR, argmax flips only under LONGCTX_BF16_TIE_MARGIN;
    float32 within LONGCTX_PROBE_TOL, flips only under LONGCTX_TIE_MARGIN.
    Returns the two lines and the float32 probe's moe_ffn launches."""
    import torch
    from dataclasses import replace
    from repro_torch import kernels
    from repro_torch.configs.base import registry
    from repro_torch.models.transformer import init_params
    cfg = replace(registry()["mixtral_8x7b"], n_layers=MIXTRAL_PROBE_LAYERS)
    prompt = _prompts(1, MIXTRAL_PROBE_PROMPT, cfg.vocab, SEED + 24)[0]
    lines, f32_launches = [], 0
    for dtype, tol, max_err, margin in (
            (torch.bfloat16, LONGCTX_PROBE_TOL, LONGCTX_BF16_MAX_ERR,
             LONGCTX_BF16_TIE_MARGIN),
            (torch.float32, LONGCTX_PROBE_TOL, None, LONGCTX_TIE_MARGIN)):
        params = init_params(cfg, seed=SEED, dtype=dtype, device="cuda")
        kernels.reset_launch_counts()
        t0 = time.perf_counter()
        run = _decode_vs_prefill(cfg, params, prompt, MIXTRAL_PROBE_STEPS,
                                 tol)
        run["seconds"] = time.perf_counter() - t0
        run["launches"] = {k: n for k, n in kernels.launch_counts().items()
                           if n}
        name = "bf16" if dtype == torch.bfloat16 else "f32"
        line = {"phase": f"longctx_mixtral_probe_{name}",
                "depth_cut": {"mixtral_8x7b": MIXTRAL_PROBE_LAYERS},
                "tie_margin": margin, **run}
        if max_err is None:
            line["tolerance"] = tol
            failed = run["values_outside"] > 0
            f32_launches = run["launches"].get("moe_ffn", 0)
        else:
            line["max_abs_err_limit"] = max_err
            failed = run["logits_max_abs_err"] > max_err
        if failed or any(m >= margin for m in run["argmax_flips_margins"]):
            raise RuntimeError(f"{line['phase']} failed: {line}")
        lines.append(line)
        del params
        torch.cuda.empty_cache()
    return lines[0], lines[1], f32_launches


@contextlib.contextmanager
def _quantize_hook(hook):
    """Route every int8 K/V write (``attention.quantize_int8``, the prefill's
    placement and the decode's write alike) through ``hook(orig, u)``."""
    from repro_torch.models import attention as A
    orig = A.quantize_int8
    A.quantize_int8 = lambda u: hook(orig, u)
    try:
        yield
    finally:
        A.quantize_int8 = orig


def run_mixtral_card_vs_cpu() -> list[dict]:
    """``longctx_card_vs_cpu``'s mixtral runs: smoke-width mixtral in
    float32 (a 16-slot ring, MoE on moe_ffn), with and without int8
    caches, the same weights on the card and on the CPU:
    2 prompts of LONGCTX_CROSS_PROMPT tokens, LONGCTX_CROSS_STEPS steps.
    Logits and caches within LONGCTX_CROSS_TOL, positions and tokens
    identical.

    With int8 caches the card's K/V and the CPU's differ by ~1e-6, so an
    element u / scale that lands near a .5 rounds to int8 values one step
    apart, and the logits would then differ by the step's effect rather
    than by the kernels'.  So every int8 write of the CPU run is held
    against the card's same write (values within one step, scales within
    LONGCTX_CROSS_TOL) and then takes the card's: both runs read the same
    int8 caches, and their logits are held within LONGCTX_CROSS_TOL."""
    import torch
    from dataclasses import replace
    from repro_torch import kernels
    from repro_torch.configs.base import registry, smoke
    from repro_torch.launch.longctx_decode import generate
    from repro_torch.models.transformer import init_params
    runs = []
    for quant in (False, True):
        cfg = replace(smoke(registry()["mixtral_8x7b"]), kv_cache_quant=quant)
        cpu = init_params(cfg, seed=SEED, device="cpu")
        card = _to_device(cpu, "cuda")
        prompts = _prompts(2, LONGCTX_CROSS_PROMPT, cfg.vocab, SEED + 25)
        cache = LONGCTX_CROSS_PROMPT + LONGCTX_CROSS_STEPS
        writes = []
        apart = {"values": 0, "scale_err": 0.0, "replayed": 0}

        def record(orig, u):
            q, sc = orig(u)
            writes.append((q.cpu(), sc.cpu()))
            return q, sc

        def replay(orig, u):
            q, sc = orig(u)
            cq, cs = writes[apart["replayed"]]
            apart["replayed"] += 1
            if q.shape != cq.shape:
                raise RuntimeError(f"mixtral int8 write {apart['replayed']}"
                                   f": shapes {tuple(q.shape)} (CPU) vs "
                                   f"{tuple(cq.shape)} (card)")
            apart["values"] = max(apart["values"], int(
                (q.int() - cq.int()).abs().max()))
            apart["scale_err"] = max(apart["scale_err"], float(
                (sc - cs).abs().max()))
            if apart["values"] > 1 or not torch.allclose(
                    sc, cs, atol=LONGCTX_CROSS_TOL, rtol=LONGCTX_CROSS_TOL):
                raise RuntimeError(f"mixtral int8 write {apart['replayed']}"
                                   f": card vs CPU {apart}")
            return cq, cs

        kernels.reset_launch_counts()
        with _quantize_hook(record):
            got = generate(card, cfg, prompts, LONGCTX_CROSS_STEPS, cache)
        launches = kernels.launch_counts()
        with _quantize_hook(replay):
            want = generate(cpu, cfg, prompts, LONGCTX_CROSS_STEPS, cache)
        L = cfg.n_layers
        if launches["flash_attention"] != L or \
                launches["moe_ffn"] != 2 * L * (1 + LONGCTX_CROSS_STEPS):
            raise RuntimeError(f"mixtral smoke on the card launched "
                               f"{launches}")
        if apart["replayed"] != len(writes) or bool(writes) != quant:
            raise RuntimeError(f"mixtral (int8 {quant}): {len(writes)} int8 "
                               f"writes on the card, {apart['replayed']} on "
                               f"the CPU")
        pairs = [("first_logits", got["first_logits"],
                  want["first_logits"]),
                 ("logits", got["logits"], want["logits"])]
        for l, (a, b) in enumerate(zip(got["state"]["attn"],
                                       want["state"]["attn"])):
            if not torch.equal(a["pos"].cpu(), b["pos"]):
                raise RuntimeError("mixtral: cache positions differ")
            for n in a:
                if a[n].dtype == torch.int8:
                    if not torch.equal(a[n].cpu(), b[n]):
                        raise RuntimeError(f"mixtral: int8 cache {n}{l} "
                                           f"differs")
                elif n != "pos":
                    pairs.append((f"{n}{l}", a[n], b[n]))
        errs = {}
        for what, a, b in pairs:
            a = a.float().cpu()
            errs[what] = float((a - b.float()).abs().max())
            if not torch.allclose(a, b.float(), atol=LONGCTX_CROSS_TOL,
                                  rtol=LONGCTX_CROSS_TOL):
                raise RuntimeError(f"mixtral (int8 {quant}): card vs CPU "
                                   f"{what} differ by {errs[what]}")
        if got["tokens"] != want["tokens"]:
            raise RuntimeError(f"mixtral (int8 {quant}): tokens differ")
        run = {"arch": "mixtral_8x7b", "kv_cache_quant": quant,
               "launches": {k: v for k, v in launches.items() if v},
               "logits_max_abs_err": max(errs["first_logits"],
                                         errs["logits"]),
               "state_max_abs_err": max(v for k, v in errs.items()
                                        if "logits" not in k),
               "logits_tolerance": LONGCTX_CROSS_TOL,
               "tokens_identical": True}
        if quant:
            run.update(int8_writes=len(writes),
                       int8_values_apart=apart["values"],
                       int8_scale_max_abs_err=apart["scale_err"])
        runs.append(run)
    return runs


def _dense_arch_kernels(cfg, eng) -> list[dict]:
    """K1's decode and prefill bodies and ``qkv_rope_append`` at the
    arch's heads (G, D) on its engine's pool refilled with random bf16
    KV, against their plain versions: K1 within ATTN_TOL, the append
    within one bf16 ulp."""
    import numpy as np
    import torch
    from repro_torch.kernels import paged_attention as K1
    from repro_torch.models import attention as A
    from repro_torch.models import layers as L
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev)
    gen.manual_seed(SEED + 26)
    rng = np.random.RandomState(SEED + 26)
    pool = eng.kv.store.fast_pool
    pool[:, 0].copy_(torch.randn(pool[:, 0].shape, generator=gen,
                                 device=dev).to(pool.dtype))
    kf, vf = pool[:, 0, 0], pool[:, 0, 1]
    n_slots, page = pool.shape[0], eng.scfg.page_size
    P = eng.scfg.max_pages_per_seq
    Hq, Hkv, D = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    G = Hq // Hkv

    def tables(rows):
        return torch.from_numpy(np.stack([
            rng.permutation(n_slots)[:P] for _ in range(rows)]).astype(
                np.int32)).to(dev)
    out = []
    B = eng.scfg.max_batch
    dec_len = torch.from_numpy(rng.randint(1, P * page + 1, size=B).astype(
        np.int32)).to(dev)
    pre_len = torch.from_numpy(np.concatenate([
        rng.randint(0, 49) + np.arange(1, 33) for _ in range(4)]).astype(
            np.int32)).to(dev)
    for name, rows, bt, lengths, fn in (
            ("paged_attention", B, tables(B), dec_len,
             K1.paged_attention_pooled),
            ("paged_attention_prefill", 128,
             tables(4).repeat_interleave(32, dim=0), pre_len,
             K1.paged_attention_prefill_pooled)):
        q = (torch.randn((rows, Hkv, G, D), generator=gen, device=dev)
             * D ** -0.5).to(pool.dtype)
        got = fn(q, kf, vf, bt, lengths)
        want = K1.paged_attention_plain(q, kf, vf, bt, lengths)
        torch.cuda.synchronize()
        err = float((got.float() - want.float()).abs().max())
        if not torch.allclose(got.float(), want.float(), atol=ATTN_TOL,
                              rtol=ATTN_TOL):
            raise RuntimeError(f"{cfg.name}: {name} disagrees with plain "
                               f"(G {G}, D {D}): max abs err {err}")
        out.append({"name": name, "G": G, "D": D, "rows": rows,
                     "max_abs_err": err, "tolerance": ATTN_TOL})
    # the append: 8 decode rows into distinct slots of layer 0
    R = 8
    ap = eng.params["layers"][0]["attn"]
    x = torch.randn((R, 1, cfg.d_model), generator=gen, device=dev).to(
        pool.dtype)
    q, k, v = A.project_raw(ap, x)
    cos, sin = L.rope_angles(torch.arange(R, device=dev)[:, None] + 100,
                             D, cfg.rope_theta)
    f_idx = torch.from_numpy(rng.permutation(n_slots)[:R].astype(
        np.int32)).to(dev)
    off = torch.from_numpy(rng.randint(0, page, R).astype(np.int32)).to(dev)
    args = (q[:, 0], k[:, 0], v[:, 0], ap.get("q_norm"), ap.get("k_norm"),
            cos[:, 0].contiguous(), sin[:, 0].contiguous())
    fast_k, fast_p = pool[:, 0].clone(), pool[:, 0].clone()
    qk = A.rope_append(*args, fast_k, None, f_idx, None, off)
    qp = A.rope_append_plain(*args, fast_p, None, f_idx, None, off)
    torch.cuda.synchronize()
    ulps = max(_ulps_apart(qk, qp), _ulps_apart(fast_k, fast_p))
    if ulps > 1:
        raise RuntimeError(f"{cfg.name}: qkv_rope_append {ulps} ulps from "
                           f"plain (G {G}, D {D})")
    out.append({"name": "qkv_rope_append", "G": G, "D": D, "rows": R,
                "ulps_apart": ulps, "tolerance": "1 bf16 ulp"})
    return out


def run_dense_archs() -> dict:
    """``dense_archs``: phi3_mini_3_8b (G 1, D 96), qwen2_5_14b (QKV bias,
    G 5) and gemma3_4b (D 256, gemma norms, scaled and tied embeddings)
    at published width and depth in bf16, random weights from SEED:
    DENSE_REQUESTS requests of DENSE_PROMPT + DENSE_NEW through the fused
    dispatch and the K=1 reference path, memos off: identical tokens,
    qkv_rope_append once per layer per inner step; then K1's bodies and
    the append against plain at the arch's heads."""
    import torch
    from repro_torch import kernels
    from repro_torch.configs.base import registry
    from repro_torch.models.transformer import init_params
    from repro_torch.serving.engine import PagedServingEngine
    out = {"phase": "dense_archs", "dtype": "bfloat16",
           "requests": DENSE_REQUESTS, "prompt_len": DENSE_PROMPT,
           "new_tokens": DENSE_NEW, "archs": []}
    for name in DENSE_ARCHS:
        cfg = registry()[name]
        t0 = time.perf_counter()
        params = init_params(cfg, seed=SEED, dtype=torch.bfloat16,
                             device="cuda")
        torch.cuda.synchronize()
        line = {"arch": name, "n_layers": cfg.n_layers,
                "d_model": cfg.d_model, "heads": [cfg.n_heads,
                                                  cfg.n_kv_heads],
                "head_dim": cfg.head_dim, "vocab": cfg.vocab,
                "init_params_s": time.perf_counter() - t0}
        prompts = _prompts(DENSE_REQUESTS, DENSE_PROMPT, cfg.vocab, SEED + 27)
        toks = {}
        for run in ("fused", "reference"):
            eng = PagedServingEngine(cfg, params, _serve_config(
                memos_enabled=False, reference=run == "reference"),
                device="cuda")
            reqs = [eng.submit(p, DENSE_NEW) for p in prompts]
            kernels.reset_launch_counts()
            t0 = time.perf_counter()
            hist = eng.run()
            torch.cuda.synchronize()
            dt = time.perf_counter() - t0
            launches = kernels.launch_counts()
            if any(r.error is not None or len(r.generated) != DENSE_NEW
                   for r in reqs) or not bool(
                       torch.isfinite(eng.last_logits.float()).all()):
                raise RuntimeError(f"dense_archs {name} {run}: incomplete "
                                   f"or non-finite")
            _check_launches(launches, ("paged_attention", "qkv_rope_append",
                                       "touch_update"), f"{name} {run}")
            inner = _check_rope_append(launches, cfg, hist, f"{name} {run}")
            toks[run] = [r.generated for r in reqs]
            line[run] = {"seconds": dt, "inner_steps": inner,
                         "generated_tokens_per_s": eng.tokens_out / dt}
            if run == "fused":
                line["kernels"] = _dense_arch_kernels(cfg, eng)
            eng.close()
            del eng
        if toks["fused"] != toks["reference"]:
            raise RuntimeError(f"dense_archs {name}: fused tokens differ "
                               f"from the reference path's")
        line["tokens_identical"] = True
        line["first_tokens"] = toks["fused"][0][:8]
        out["archs"].append(line)
        del params
        torch.cuda.empty_cache()
    return out


def run_slice13() -> dict:
    """Phases 24-29 (olmoe, mixtral and the dense archs, each model made
    and freed in turn).  Returns their lines by name and, under "rows",
    the moe_ffn kernel rows."""
    import torch
    from repro_torch.configs.base import registry
    from repro_torch.models.transformer import init_params
    cfg = registry()[MOE_ARCH]
    t0 = time.perf_counter()
    params = init_params(cfg, seed=SEED, dtype=torch.bfloat16,
                         device="cuda")
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    out = {}
    moe, moe_launches = run_moe_engine(cfg, params)
    moe["init_params_s"] = init_s
    print(json.dumps(moe), file=sys.stderr, flush=True)
    out["moe_engine"] = moe
    out["batch_invariance_olmoe"] = run_moe_batch_invariance(cfg, params)
    del params
    torch.cuda.empty_cache()
    # the float32 olmoe decode (two layers): the float32 row's launches
    f32_launches = _moe_f32_launches(cfg)
    out["prefill_invariance_moe_ffn"] = run_moe_ffn_invariance()
    lmix, lmix_launches = run_longctx_mixtral()
    print(json.dumps(lmix), file=sys.stderr, flush=True)
    out["longctx_mixtral"] = lmix
    pb16, pf32, probe_launches = run_mixtral_probes()
    print(json.dumps(pb16), file=sys.stderr, flush=True)
    print(json.dumps(pf32), file=sys.stderr, flush=True)
    out["probes"] = [pb16, pf32]
    out["card_vs_cpu_mixtral"] = run_mixtral_card_vs_cpu()
    dense = run_dense_archs()
    print(json.dumps(dense), file=sys.stderr, flush=True)
    out["dense_archs"] = dense
    by_path = {
        "moe_engine_fused": moe_launches["moe_ffn"],
        "moe_engine_prefill": moe["runs"]["prefill"]["launches"]["moe_ffn"],
        "longctx_mixtral_prefill": lmix_launches["prefill"]["moe_ffn"],
        "longctx_mixtral_decode": lmix_launches["decode"]["moe_ffn"],
        "mixtral_probe_f32": probe_launches,
        "olmoe_f32_decode_2_layers": f32_launches}
    rows = bench_moe_kernels({
        "moe_engine": by_path["moe_engine_fused"],
        "moe_prefill": by_path["moe_engine_prefill"],
        "longctx_mixtral": by_path["longctx_mixtral_prefill"],
        "longctx_mixtral_decode": by_path["longctx_mixtral_decode"],
        "moe_f32": f32_launches, "mixtral_probe_f32": probe_launches})
    for r in rows:
        r["launches_by_path"] = by_path
    out["rows"] = rows
    return out


# =============================================================================
# phases 30-33: the last inference archs (gemma3 at D 256, musicgen's GELU
# FFN on embeddings, qwen2_vl's M-RoPE on embeddings) on the dense cache
# =============================================================================

# gemma3_4b and musicgen_medium whole, qwen2_vl_72b at full width cut to
# QWEN2_VL_LAYERS of 80 layers (the whole model is ~145 GB in bf16), bf16:
# LONGCTX_BATCH prompts of LONGCTX_PROMPT tokens (the embeds archs: seeded
# embeddings, and one seeded embedding per step) and LONGCTX_NEW steps
S15_ARCHS = (("longctx_gemma3", "gemma3_4b", None),
             ("longctx_musicgen", "musicgen_medium", None),
             ("longctx_qwen2_vl", "qwen2_vl_72b", 8))
# their float32 probes: full width cut to these depths (gemma3: 5 local
# layers and 1 global), a prompt past gemma3's 1024-slot local ring
S15_PROBE_LAYERS = {"gemma3_4b": 6, "musicgen_medium": 4, "qwen2_vl_72b": 2}
S15_PROBE_PROMPT, S15_PROBE_STEPS = 1100, 4


def _gemma3_window() -> int:
    """gemma3's local window (1024), the window of its K8 rows."""
    from repro_torch.configs.base import registry
    return registry()["gemma3_4b"].local_global[1]


def _s15_inputs(cfg, B: int, S: int, new: int, dtype, seed: int):
    """(prompt, step_embeds) of an arch: token ids [B][S] and None, or
    seeded embeddings [B, S, d] and [B, new, d] made on the card."""
    import torch
    if cfg.input_mode != "embeds":
        return _prompts(B, S, cfg.vocab, seed), None
    gen = torch.Generator(device="cuda")
    gen.manual_seed(seed)
    e = torch.randn((B, S + new, cfg.d_model), generator=gen,
                    device="cuda").to(dtype)
    return e[:, :S], e[:, S:]


@contextlib.contextmanager
def _k8_windows():
    """Tally K8 calls by window (0 = full causal) while the block runs;
    the wrapper's own launch count stays the authority, the tally only
    splits it by shape."""
    from collections import Counter
    from repro_torch.models import attention as A
    orig = A.K8.flash_attention
    tally = Counter()

    def spy(q, k, v, **kw):
        tally[int(kw.get("window") or 0)] += 1
        return orig(q, k, v, **kw)
    A.K8.flash_attention = spy
    try:
        yield tally
    finally:
        A.K8.flash_attention = orig


def run_longctx_s15(phase: str, name: str, layers: int | None
                    ) -> tuple[dict, dict]:
    """``phase``: ``generate`` in bf16 at the arch's full width
    (cut to ``layers`` layers where given), LONGCTX_BATCH x
    LONGCTX_PROMPT + LONGCTX_NEW.  The prefill launches K8 once per layer
    and nothing else, the decode nothing; the K/V state is the empty
    state's (gemma3's local layers a 1024-slot ring that wraps).  Returns
    the line and the K8 launches by window."""
    import numpy as np
    import torch
    from dataclasses import replace
    from repro_torch import kernels
    from repro_torch.configs.base import registry
    from repro_torch.launch.longctx_decode import generate
    from repro_torch.models.transformer import init_decode_state, \
        init_params
    full = registry()[name]
    cfg = replace(full, n_layers=layers) if layers else full
    bf = torch.bfloat16
    t0 = time.perf_counter()
    params = init_params(cfg, seed=SEED, dtype=bf, device="cuda")
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    prompt, steps = _s15_inputs(cfg, LONGCTX_BATCH, LONGCTX_PROMPT,
                                LONGCTX_NEW, bf, SEED + 31)
    torch.cuda.reset_peak_memory_stats()
    kernels.reset_launch_counts()
    with _k8_windows() as by_window:
        res = generate(params, cfg, prompt, LONGCTX_NEW, LONGCTX_CACHE,
                       step_embeds=steps)
    L = cfg.n_layers
    got_pre = {k: v for k, v in res["prefill_launches"].items() if v}
    got_dec = {k: v for k, v in res["decode_launches"].items() if v}
    if got_pre != {"flash_attention": L} or got_dec or \
            sum(by_window.values()) != L:
        raise RuntimeError(f"longctx {name} launched {got_pre} / {got_dec}"
                           f" (by window {dict(by_window)}), want "
                           f"flash_attention {L} / none")
    empty = init_decode_state(cfg, LONGCTX_BATCH, LONGCTX_CACHE, dtype=bf,
                              device="cuda")
    slots = [c["k"].shape[1] for c in empty["attn"]]
    want_bytes = sum(t.numel() * t.element_size() for c in empty["attn"]
                     for t in c.values())
    del empty
    if res["kv_cache_bytes"] != want_bytes:
        raise RuntimeError(f"longctx {name}: K/V state of "
                           f"{res['kv_cache_bytes']} bytes, want {want_bytes}")
    if cfg.local_global and min(slots) != cfg.local_global[1]:
        raise RuntimeError(f"longctx {name}: local rings of {min(slots)} "
                           f"slots")
    V = cfg.vocab
    for key in ("first_logits", "logits"):
        if not bool(torch.isfinite(res[key][..., :V]).all()):
            raise RuntimeError(f"longctx {name}: non-finite {key}")
    toks = np.asarray(res["tokens"])
    if toks.shape != (LONGCTX_BATCH, LONGCTX_NEW) or toks.min() < 0 \
            or toks.max() >= V:
        raise RuntimeError(f"longctx {name}: bad tokens {toks.shape}")
    line = {"phase": phase, "arch": name, "dtype": "bfloat16", "layers": L,
            "layers_published": full.n_layers, "d_model": cfg.d_model,
            "heads": [cfg.n_heads, cfg.n_kv_heads],
            "head_dim": cfg.head_dim, "mlp": cfg.mlp_kind,
            "input_mode": cfg.input_mode,
            "mrope_sections": cfg.mrope_sections,
            "batch": LONGCTX_BATCH, "prompt_len": LONGCTX_PROMPT,
            "new_tokens": LONGCTX_NEW, "cache_len": LONGCTX_CACHE,
            "cache_slots_by_layer": sorted(set(slots)),
            "init_params_s": init_s, "prefill_s": res["prefill_s"],
            "decode_s": res["decode_s"],
            "decode_tokens_per_s": res["decode_tokens_per_s"],
            "first_tokens": [t[:8] for t in res["tokens"]],
            "kv_cache_bytes": res["kv_cache_bytes"],
            "peak_memory_bytes": torch.cuda.max_memory_allocated(),
            "prefill_launches": got_pre, "decode_launches": got_dec,
            "flash_attention_by_window": dict(by_window)}
    if layers:
        line["depth_cut"] = (f"{layers} of {full.n_layers} layers: the "
                             f"whole model is ~{full.param_count() * 2 / 1e9:.0f}"
                             f" GB in bf16")
    del params, res
    torch.cuda.empty_cache()
    return line, dict(by_window)


def _decode_vs_prefill_embeds(cfg, params, prompt, steps, tol: float
                              ) -> dict:
    """``_decode_vs_prefill`` for an embeds arch: each decode step takes
    the next given embedding; its logits against a fresh prefill over the
    prompt and the steps so far."""
    import torch
    from repro_torch.models import transformer as T
    V, S, n = cfg.vocab, prompt.shape[1], steps.shape[1]
    lg, st = T.prefill(params, cfg, None, S + n, embeds=prompt)
    max_err, outside, flips, codes = 0.0, 0, [], []
    for i in range(n):
        codes.append(int(lg[0, 0, :V].argmax()))
        lg, st = T.decode_step(params, cfg, st, None,
                               embeds=steps[:, i:i + 1])
        ref, _ = T.prefill(params, cfg, None, S + i + 1,
                           embeds=torch.cat([prompt, steps[:, :i + 1]], 1))
        a, r = lg[0, 0, :V].float(), ref[0, 0, :V].float()
        d = (a - r).abs()
        max_err = max(max_err, float(d.max()))
        outside += int((d > tol + tol * r.abs()).sum())
        top2 = r.topk(2).values
        if int(a.argmax()) != int(r.argmax()):
            flips.append(float(top2[0] - top2[1]))
    return {"arch": cfg.name, "layers": cfg.n_layers, "prompt_len": S,
            "steps": n, "logits_max_abs_err": max_err,
            "values_outside": outside, "values": n * V,
            "argmax_flips_margins": flips, "codes": codes}


def run_s15_probes() -> tuple[dict, dict]:
    """``longctx_probe_f32_s15``: each arch in float32 at full width cut
    to S15_PROBE_LAYERS, one S15_PROBE_PROMPT prompt and S15_PROBE_STEPS
    decode steps, every step's logits within LONGCTX_PROBE_TOL of a fresh
    prefill's, argmax flips only under LONGCTX_TIE_MARGIN (the dense-cache
    gate of PERF.md section 2).  Returns the line and gemma3's K8 float32
    launches by window."""
    import torch
    from dataclasses import replace
    from repro_torch import kernels
    from repro_torch.configs.base import registry
    from repro_torch.models.transformer import init_params
    line = {"phase": "longctx_probe_f32_s15", "tolerance": LONGCTX_PROBE_TOL,
            "tie_margin": LONGCTX_TIE_MARGIN, "depth_cut": S15_PROBE_LAYERS,
            "runs": []}
    gemma_windows = {}
    for name, layers in S15_PROBE_LAYERS.items():
        cfg = replace(registry()[name], n_layers=layers)
        params = init_params(cfg, seed=SEED, dtype=torch.float32,
                             device="cuda")
        kernels.reset_launch_counts()
        with _k8_windows() as by_window:
            if cfg.input_mode == "embeds":
                prompt, steps = _s15_inputs(cfg, 1, S15_PROBE_PROMPT,
                                            S15_PROBE_STEPS, torch.float32,
                                            SEED + 32)
                run = _decode_vs_prefill_embeds(cfg, params, prompt, steps,
                                                LONGCTX_PROBE_TOL)
            else:
                prompt = _prompts(1, S15_PROBE_PROMPT, cfg.vocab,
                                  SEED + 32)[0]
                run = _decode_vs_prefill(cfg, params, prompt,
                                         S15_PROBE_STEPS, LONGCTX_PROBE_TOL)
        run["launches"] = {k: n for k, n in kernels.launch_counts().items()
                           if n}
        # one prefill, then a fresh prefill per step: K8 once per layer each
        want = layers * (1 + S15_PROBE_STEPS)
        if run["launches"] != {"flash_attention": want}:
            raise RuntimeError(f"{name} float32 probe launched "
                               f"{run['launches']}, want flash_attention "
                               f"{want}")
        run["flash_attention_by_window"] = dict(by_window)
        if name == "gemma3_4b":
            gemma_windows = dict(by_window)
        line["runs"].append(run)
        del params
        torch.cuda.empty_cache()
        if run["values_outside"] or any(m >= LONGCTX_TIE_MARGIN
                                        for m in run["argmax_flips_margins"]):
            raise RuntimeError(f"{name} float32 probe failed: {run}")
    return line, gemma_windows


def run_s15_card_vs_cpu() -> list[dict]:
    """``longctx_card_vs_cpu``'s slice-15 runs: smoke-width gemma3 at its
    published head dim of 256 (K8's float32 D-256 kernel on the card),
    musicgen and qwen2_vl (embeddings) in float32, the same weights and
    inputs on the card and on the CPU: 2 prompts of LONGCTX_CROSS_PROMPT,
    LONGCTX_CROSS_STEPS steps.  Logits and caches within
    LONGCTX_CROSS_TOL, positions and tokens identical."""
    import numpy as np
    import torch
    from dataclasses import replace
    from repro_torch import kernels
    from repro_torch.configs.base import registry, smoke
    from repro_torch.launch.longctx_decode import generate
    from repro_torch.models.transformer import init_params
    runs = []
    for name, kw in (("gemma3_4b", {"d_head": 256}), ("musicgen_medium", {}),
                     ("qwen2_vl_72b", {})):
        cfg = replace(smoke(registry()[name]), **kw)
        cpu = init_params(cfg, seed=SEED, device="cpu")
        card = _to_device(cpu, "cuda")
        P, n = LONGCTX_CROSS_PROMPT, LONGCTX_CROSS_STEPS
        if cfg.input_mode == "embeds":
            e = np.random.RandomState(SEED + 33).standard_normal(
                (2, P + n, cfg.d_model)).astype(np.float32)
            prompts, steps = e[:, :P], e[:, P:]
        else:
            prompts, steps = _prompts(2, P, cfg.vocab, SEED + 33), None
        kernels.reset_launch_counts()
        got = generate(card, cfg, prompts, n, P + n, step_embeds=steps)
        launches = kernels.launch_counts()
        want = generate(cpu, cfg, prompts, n, P + n, step_embeds=steps)
        if {k: v for k, v in launches.items() if v} != {
                "flash_attention": cfg.n_layers}:
            raise RuntimeError(f"{name} smoke on the card launched "
                               f"{launches}")
        pairs = [("first_logits", got["first_logits"],
                  want["first_logits"]),
                 ("logits", got["logits"], want["logits"])]
        for l, (a, b) in enumerate(zip(got["state"]["attn"],
                                       want["state"]["attn"])):
            if not torch.equal(a["pos"].cpu(), b["pos"]):
                raise RuntimeError(f"{name}: cache positions differ")
            pairs += [(f"k{l}", a["k"], b["k"]), (f"v{l}", a["v"], b["v"])]
        errs = {}
        for what, a, b in pairs:
            a = a.float().cpu()
            errs[what] = float((a - b.float()).abs().max())
            if not torch.allclose(a, b.float(), atol=LONGCTX_CROSS_TOL,
                                  rtol=LONGCTX_CROSS_TOL):
                raise RuntimeError(f"{name}: card vs CPU {what} differ by "
                                   f"{errs[what]}")
        if got["tokens"] != want["tokens"]:
            raise RuntimeError(f"{name}: card vs CPU tokens differ")
        runs.append({"arch": name, "head_dim": cfg.head_dim,
                     "input_mode": cfg.input_mode,
                     "launches": {k: v for k, v in launches.items() if v},
                     "logits_max_abs_err": max(errs["first_logits"],
                                               errs["logits"]),
                     "state_max_abs_err": max(v for k, v in errs.items()
                                              if "logits" not in k),
                     "logits_tolerance": LONGCTX_CROSS_TOL,
                     "tokens_identical": True})
    return runs


def bench_s15_kernels(launches: dict) -> list[dict]:
    """K8's rows at the new widths, seeded random inputs, against the
    plain version on the card: D 256 at gemma3's shape (B 4, S 2000, 8/4
    heads), causal (its global layers) and with its 1024-token window (its
    local layers), bf16 (``flash_d256_kernel``) and float32
    (``flash_f32_d256_kernel`` on ``wgmma`` TF32 after its K/V pre-pass
    ``flash_f32_split_kernel``), and D 64 at musicgen's (24/24 heads,
    causal, bf16, ``flash_wgmma_d64_kernel``).  Each row: CUDA-event ms,
    the device ms of a CUDA graph of 10 calls, the bound (operations over
    the bf16 or the 3xTF32 peak), SDPA's time on the same call (KV
    expanded to the q heads outside the timing) and the tensor-core
    instruction count of its kernel; the float32 rows also the device ms
    of the pre-pass and of the main kernel from a profiler trace; the
    bf16 D-256 rows the kernel's launch plan (persistent grid, registers
    at launch; no cluster) and the device ms of streaming the earlier
    D-256 design's tiles into shared memory with no math, each CTA reading
    them from L2 and two CTAs of a cluster sharing them by multicast
    (``tools/flash_d256_probe.py``'s ``stream``, built here).
    ``launches`` maps a row to its count on the main path."""
    import numpy as np
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels import flash_attention as K8
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev)
    gen.manual_seed(SEED + 34)
    bf = torch.bfloat16
    sass = {"bf16_d256": _sass_count("flash_d256_kernel", "HGMMA"),
            "f32_d256": _sass_count("flash_f32_d256_kernel", "HGMMA"),
            "bf16_d64": _sass_count("flash_wgmma_d64_kernel", "HGMMA")}
    if not all(sass.values()):
        raise RuntimeError(f"flash_attention: a kernel without tensor-core "
                           f"instructions: {sass}")
    rows = []
    probe = probe_lib = None
    B, S = LONGCTX_BATCH, LONGCTX_PROMPT
    win = _gemma3_window()
    for name, Hq, Hkv, D, window, dtype, key in (
            ("flash_attention_d256", 8, 4, 256, 0, bf, "bf16_d256"),
            ("flash_attention_d256_window", 8, 4, 256, win, bf,
             "bf16_d256"),
            ("flash_attention_f32_d256", 8, 4, 256, 0, torch.float32,
             "f32_d256"),
            ("flash_attention_f32_d256_window", 8, 4, 256, win,
             torch.float32, "f32_d256"),
            ("flash_attention_d64", 24, 24, 64, 0, bf, "bf16_d64")):
        q, k, v = (torch.randn((B, S, h, D), generator=gen,
                               device=dev).to(dtype)
                   for h in (Hq, Hkv, Hkv))

        def call():
            return K8.flash_attention(q, k, v, window=window)
        out = call()
        ref = K8.flash_attention_plain(q, k, v, window=window)
        torch.cuda.synchronize()
        tol = FLASH_TOL if dtype == bf else FLASH_F32_TOL
        if not torch.allclose(out.float(), ref.float(), atol=tol, rtol=tol):
            raise RuntimeError(f"{name} kernel disagrees with plain")
        err = float((out.float() - ref.float()).abs().max())
        del ref
        i = np.arange(S)
        pairs = float(np.minimum(i + 1, window if window else S).sum())
        G = Hq // Hkv
        qt = q.transpose(1, 2)
        kt, vt = (t.transpose(1, 2).repeat_interleave(G, dim=1)
                  for t in (k, v))
        if window:
            ii = torch.arange(S, device=dev)
            mask = (ii[None, :] <= ii[:, None]) & \
                (ii[:, None] - ii[None, :] < window)
            lib = lambda: F.scaled_dot_product_attention(qt, kt, vt,
                                                         attn_mask=mask)
        else:
            lib = lambda: F.scaled_dot_product_attention(qt, kt, vt,
                                                         is_causal=True)
        size = q.element_size()
        nbytes = size * (2 * q.numel() + 2 * k.numel())
        flops = 4.0 * B * Hq * D * pairs
        bound, by = _bound_ms(nbytes, flops,
                              flops_per_s=BF16_FLOPS_PER_S if dtype == bf
                              else F32_TC_FLOPS_PER_S)
        row = {"name": name, "kernel": "flash_attention", "route": "cuda",
               "source": "src/repro_torch/kernels/csrc/flash_attention.cu",
               "replaces": "src/repro/kernels/flash_attention/"
                           "flash_attention.py:78",
               "launches": launches[name], "max_abs_err": err,
               "tolerance": tol,
               "ms": _time_ms(call, iters=10, warmup=2),
               "plain_ms": _time_ms(lambda: K8.flash_attention_plain(
                   q, k, v, window=window), iters=3, warmup=1),
               "bound_ms": bound, "bound_by": by,
               "library_ms": _time_ms(lib, iters=10, warmup=2),
               "device_ms": _graph_ms(call, calls=10, replays=10),
               "library_device_ms": _graph_ms(lib, calls=10, replays=10),
               "shape": {"B": B, "S": S, "Hq": Hq, "Hkv": Hkv, "D": D,
                         "causal": True, "window": window,
                         "dtype": str(dtype).removeprefix("torch.")},
               "library_call": "scaled_dot_product_attention (KV expanded "
                               "to Hq heads outside the timing"
                               + ("; a boolean window mask)" if window
                                  else "; is_causal)")}
        row["sdpa_factor"] = row["ms"] / row["library_ms"]
        row["sass_hgmma"] = sass[key]
        if dtype == bf and D > 128:
            row["design"] = ("wgmma from TMA-loaded tiles, persistent (one "
                             "CTA an SM, work items heaviest causal q "
                             "block first in a snake), 128 q rows and "
                             "128-key tiles, K and V one stage each on "
                             "their own barriers, S on m64n128k16 and P.V "
                             "on m64n256k16, the warpgroups taking turns "
                             "on S, the scale folded into the exponent's "
                             "FFMA")
            row["plan"] = K8.wide_launch_info(B, S, Hq)
            row["cluster_size"] = 1
            if probe is None:
                probe = _tool("flash_d256_probe")
                probe_lib, _ = probe.build(Path(__file__).resolve().parent)
            row["stream_device_ms"] = {
                f"cluster{c}": _graph_ms(lambda: probe.stream(
                    probe_lib, q, k, v, window=window, cluster=c),
                    calls=10, replays=10) for c in (1, 2)}
        elif dtype == bf:
            row["design"] = ("wgmma from TMA-loaded tiles, one 64-column "
                             "box of D, 4 stages, two CTAs an SM, the "
                             "scale folded into the exponent's FFMA")
        else:
            row["design"] = ("3xTF32 on wgmma after a pre-pass that splits "
                             "K and V^T into TF32 terms in scratch; 64 q "
                             "rows a CTA, 32-key tiles, two consumer "
                             "warpgroups each owning half of D, partial S "
                             "exchanged through shared memory, Q's small "
                             "term in registers")
            row.update(_f32_bounds(nbytes, flops))
            row["plan"] = K8.launch_info(B, S, Hq, D)
            split = _kernel_ms(call, ["flash_f32_split_kernel",
                                      "flash_f32_d256_kernel"])
            row["prepass_device_ms"] = split["flash_f32_split_kernel"]["ms"]
            row["main_device_ms"] = split["flash_f32_d256_kernel"]["ms"]
        rows.append(row)
        del q, k, v, qt, kt, vt, out, lib
        torch.cuda.empty_cache()
    return rows


def run_slice15() -> dict:
    """Phases 30-33: ``longctx_gemma3``, ``longctx_musicgen`` and
    ``longctx_qwen2_vl`` (bf16), their float32 probes, their card-vs-CPU
    runs and K8's rows at D 256 and D 64.  Returns the lines by name and,
    under "rows", the kernel rows."""
    out = {"lines": []}
    by_window = {}
    for phase, name, layers in S15_ARCHS:
        line, by_window[name] = run_longctx_s15(phase, name, layers)
        print(json.dumps(line), file=sys.stderr, flush=True)
        out["lines"].append(line)
    probe, f32_windows = run_s15_probes()
    print(json.dumps(probe), file=sys.stderr, flush=True)
    out["lines"].append(probe)
    out["card_vs_cpu"] = run_s15_card_vs_cpu()
    g, m = by_window["gemma3_4b"], by_window["musicgen_medium"]
    win = _gemma3_window()
    out["rows"] = bench_s15_kernels({
        "flash_attention_d256": g.get(0, 0),
        "flash_attention_d256_window": g.get(win, 0),
        "flash_attention_f32_d256": f32_windows.get(0, 0),
        "flash_attention_f32_d256_window": f32_windows.get(win, 0),
        "flash_attention_d64": m.get(0, 0)})
    return out


def _moe_f32_launches(cfg) -> int:
    """The float32 decode path of olmoe (full width, cut to 2 layers): a
    request of 16 + 8 tokens served in float32, its moe_ffn launches
    (the float32 entry's) — 2 per layer per inner step."""
    import torch
    from dataclasses import replace
    from repro_torch import kernels
    from repro_torch.models.transformer import init_params
    from repro_torch.serving.engine import PagedServingEngine
    small = replace(cfg, n_layers=2)
    params = init_params(small, seed=SEED, dtype=torch.float32,
                         device="cuda")
    eng = PagedServingEngine(small, params, _serve_config(
        memos_enabled=False), device="cuda")
    eng.submit(_prompts(1, 16, small.vocab, SEED + 28)[0], 8)
    kernels.reset_launch_counts()
    hist = eng.run()
    torch.cuda.synchronize()
    n = kernels.launch_counts()["moe_ffn"]
    inner = sum(h.get("decode_block", 0) for h in hist)
    if n != 2 * small.n_layers * inner:
        raise RuntimeError(f"float32 olmoe: {n} moe_ffn launches over "
                           f"{inner} inner steps")
    eng.close()
    del params, eng
    torch.cuda.empty_cache()
    return n


# --- training (phases 34-37) -------------------------------------------------

TRAIN_SEQ, TRAIN_BATCH, TRAIN_MICRO, TRAIN_LR = 512, 8, 2, 1e-3
# full width; depth cut only where float32 AdamW state (16 B a parameter:
# params, gradients, m, v) would not fit beside the activations in 80 GB
TRAIN_RUNS = (("train_qwen3", "qwen3_4b", 24, 20),
              ("train_mamba2", "mamba2_1_3b", None, 10),
              ("train_zamba2", "zamba2_7b", 14, 10),
              ("train_olmoe", "olmoe_1b_7b", 8, 20))
# the runs whose loss must fall (mean of the last five below the first's)
TRAIN_FALLING = ("train_qwen3", "train_olmoe")
TRAIN_CROSS_ARCHS = ("qwen3_4b", "gemma3_4b", "mamba2_1_3b", "zamba2_7b",
                     "olmoe_1b_7b", "mixtral_8x7b")
TRAIN_CROSS_STEPS = 5
TRAIN_LOSS_RTOL = 1e-4          # card vs CPU losses
TRAIN_MOMENT_REL = 1e-4         # m, v: of each leaf's largest magnitude
# params after step 5: within rtol 1e-4 / atol 1e-5 except at most one
# entry in 10**4, and every entry within twice the summed lr.  AdamW's
# update m / (sqrt(v) + eps) depends on each entry's gradient relative to
# itself, so an entry far below its leaf's largest takes the leaf's
# absolute rounding as a large relative error (3-7 such entries an arch
# of the smoke models on an H100).
TRAIN_TARGET = (1e-4, 1e-5)
TRAIN_OVER_TARGET_FRAC = 1e-4


def _digest(params) -> list[float]:
    """Per-leaf float64 sums of a parameter tree (equal sums: unchanged)."""
    import torch
    from repro_torch import tree
    return torch.stack([p.double().sum() for p in tree.leaves(params)]
                       ).tolist()


def _launch_delta(before: dict) -> dict:
    from repro_torch import kernels
    return {k: v - before.get(k, 0) for k, v in
            kernels.launch_counts().items() if v != before.get(k, 0)}


def _train_launches(cfg, passes: int) -> dict:
    """The kernel launches of ``passes`` microbatch forward + backward
    passes of ``cfg`` through ``loss_fn``: none without MoE; with MoE,
    per layer and pass, ``moe_ffn`` 2 in the forward and, under remat, 2
    more in the recompute (the training entry, g and u kept), and
    ``moe_ffn_bwd`` its 3 entries."""
    from repro_torch.kernels.moe_ffn import BWD_LAUNCHES
    if not cfg.is_moe:
        return {}
    fwd = 2 * (2 if cfg.remat else 1)
    return {"moe_ffn": fwd * cfg.n_layers * passes,
            "moe_ffn_bwd": BWD_LAUNCHES * cfg.n_layers * passes}


def _add_launches(total: dict, more: dict) -> dict:
    return {k: total.get(k, 0) + more.get(k, 0)
            for k in set(total) | set(more)}


def _profiled_train_step(step_fn, params, opt, batch) -> dict:
    """One training step under ``torch.profiler`` (device activity):
    its wall ms and the device ms of its ``moe_ffn`` kernels
    (``moe_tf32_kernel``) and of each ``moe_ffn_bwd`` entry
    (``moe_bwd_kernel<0..2>``: down dgrad, x dgrad, weight gradients)."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        step_fn(params, opt, batch)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    fwd_us, bwd_us = 0.0, [0.0] * 3
    for e in prof.events():
        if e.device_type != torch.autograd.DeviceType.CUDA:
            continue
        dur = e.time_range.end - e.time_range.start
        if "moe_tf32_kernel" in e.name:
            fwd_us += dur
        m = re.search(r"moe_bwd_kernel<(\d)>", e.name)
        if m:
            bwd_us[int(m.group(1))] += dur
    return {"step_ms": wall * 1e3, "moe_ffn_device_ms": fwd_us / 1e3,
            "moe_ffn_bwd_device_ms": sum(bwd_us) / 1e3,
            "moe_ffn_bwd_device_ms_by_entry": {
                k: v / 1e3 for k, v in zip(
                    ("down_dgrad", "x_dgrad", "weight_grads"), bwd_us)}}


def run_train(phase: str, name: str, layers: int | None, steps: int
              ) -> dict:
    """One full-width training run on the card (phases 34, 35, and 35b
    for MoE): ``steps`` steps, then for MoE one more under the profiler."""
    import gc
    import math
    import statistics
    from dataclasses import replace
    from functools import partial
    import torch
    from repro_torch import kernels, tree
    from repro_torch.configs.base import registry
    from repro_torch.data import SyntheticLM
    from repro_torch.launch.train import make_train_step, micro_batches
    from repro_torch.models.transformer import init_params
    from repro_torch.optim import adamw, cosine_with_warmup
    cfg = registry()[name]
    full_layers = cfg.n_layers
    if layers is not None:
        cfg = replace(cfg, n_layers=layers)
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    resident_gb = torch.cuda.memory_allocated() / 1e9
    params = init_params(cfg, seed=SEED, dtype=torch.float32, device="cuda")
    opt = adamw.init(params)
    n_params = sum(p.numel() for p in tree.leaves(params))
    src = SyntheticLM(cfg.vocab, TRAIN_SEQ, TRAIN_BATCH, seed=SEED,
                      input_mode=cfg.input_mode, d_model=cfg.d_model)
    step_fn = make_train_step(cfg, lr_fn=partial(
        cosine_with_warmup, peak_lr=TRAIN_LR, warmup=10, total=steps))
    digests = [_digest(params)]
    before = dict(kernels.launch_counts())
    losses, gnorms, lrs, step_ms, auxes, counts = [], [], [], [], [], []
    for step in range(steps):
        batch = micro_batches(src.batch(step), TRAIN_MICRO)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        params, opt, m = step_fn(params, opt, batch)
        losses.append(float(m["loss"]))
        gnorms.append(float(m["grad_norm"]))
        step_ms.append((time.perf_counter() - t0) * 1e3)
        lrs.append(float(m["lr"]))
        if cfg.is_moe:
            auxes.append(float(m["moe_aux"]))
            counts.append(m["expert_counts"].sum(dim=1).tolist())
        if step < 2:
            digests.append(_digest(params))
    torch.cuda.synchronize()
    launched = _launch_delta(before)
    expected = _train_launches(cfg, steps * TRAIN_MICRO)
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    profiled = None
    if cfg.is_moe:
        before = dict(kernels.launch_counts())
        profiled = _profiled_train_step(
            step_fn, params, opt, micro_batches(src.batch(steps),
                                                TRAIN_MICRO))
        profiled["kernel_launches"] = _launch_delta(before)
        expected_profiled = _train_launches(cfg, TRAIN_MICRO)
    grads = tree.map_leaves(lambda p: torch.full_like(p, 1e-3), params)
    opt_ms = _time_ms(lambda: adamw.update(grads, opt, params, lr=0.0),
                      iters=3, warmup=1)
    med = statistics.median(step_ms)
    line = {
        "phase": phase, "arch": name, "layers": cfg.n_layers,
        "layers_published": full_layers, "d_model": cfg.d_model,
        "params": n_params, "steps": steps, "seq": TRAIN_SEQ,
        "global_batch": TRAIN_BATCH, "n_micro": TRAIN_MICRO,
        "dtype": "float32", "tf32": torch.backends.cuda.matmul.allow_tf32,
        "losses": losses, "grad_norms": gnorms, "lrs": lrs,
        "step_ms": step_ms, "step_ms_median": med,
        "tokens_per_s": TRAIN_BATCH * TRAIN_SEQ / (med / 1e3),
        "peak_memory_gb": peak_gb, "resident_before_gb": resident_gb,
        "optimizer_ms": opt_ms, "optimizer_share": opt_ms / med,
        "kernel_launches": launched,
        "kernel_launches_expected": expected,
        "params_equal_after_step1": digests[1] == digests[0],
        "params_changed_after_step2": digests[2] != digests[0]}
    if layers is not None:
        line["reduced"] = (f"{layers} of {full_layers} layers: float32 "
                           f"AdamW state at 16 B a parameter")
    if cfg.is_moe:
        tokens = TRAIN_BATCH // TRAIN_MICRO * TRAIN_SEQ
        line.update({
            "moe_aux": auxes, "expert_counts_sums": counts,
            "expert_counts_sum_expected": (tokens * cfg.top_k
                                           * cfg.n_layers),
            "launch_formula": "per step: moe_ffn 2 x layers x n_micro x 2 "
                              "(forward and remat's recompute), "
                              "moe_ffn_bwd 4 x layers x n_micro",
            "profiled_step": profiled})
    del params, opt, grads, step_fn
    gc.collect()
    torch.cuda.empty_cache()
    bad = []
    if not all(math.isfinite(x) for x in losses + gnorms):
        bad.append("a loss or grad norm is not finite")
    if min(gnorms) <= 0:
        bad.append("a grad norm is 0")
    if not line["params_equal_after_step1"]:
        bad.append("params moved at step 1 (lr 0)")
    if not line["params_changed_after_step2"]:
        bad.append("params unchanged after step 2")
    if phase in TRAIN_FALLING and not (
            statistics.mean(losses[-5:]) < statistics.mean(losses[:5])):
        bad.append("the loss did not fall")
    if launched != expected:
        bad.append(f"kernel launches {launched}, expected {expected}")
    if cfg.is_moe:
        if not all(math.isfinite(a) and a > 0 for a in auxes):
            bad.append("moe_aux not finite and positive")
        want = line["expert_counts_sum_expected"]
        if any(c != want for mb in counts for c in mb):
            bad.append(f"expert counts do not sum to {want}")
        if profiled["kernel_launches"] != expected_profiled:
            bad.append(f"profiled step launched "
                       f"{profiled['kernel_launches']}")
    line["ok"] = not bad
    if bad:
        print(json.dumps(line), file=sys.stderr, flush=True)
        raise RuntimeError(f"{phase}: {'; '.join(bad)}")
    return line


def _backward_bits_repeat(cfg, params, batch) -> bool:
    """Two backward passes of ``loss_fn`` from one state on the card give
    identical gradients (and loss)."""
    import torch
    from repro_torch import tree
    from repro_torch.models import transformer as T
    leaves = tree.leaves(params)
    out = []
    for _ in range(2):
        for p in leaves:
            p.requires_grad_(True)
        loss, _ = T.loss_fn(params, cfg, batch)
        out.append((loss.detach(), torch.autograd.grad(loss, leaves)))
        for p in leaves:
            p.requires_grad_(False)
    (la, ga), (lb, gb) = out
    return torch.equal(la, lb) and all(torch.equal(a, b)
                                       for a, b in zip(ga, gb))


def _moment_rel(go, co) -> tuple[float, list]:
    """The largest difference of the card's moments ``go`` from the
    CPU's ``co`` over each leaf's largest CPU magnitude, and the three
    worst leaves."""
    import numpy as np
    from repro_torch import tree
    worst = []
    for which, gt, ct in (("m", go.m, co.m), ("v", go.v, co.v)):
        for leaf, g, c in zip(tree.flatten_with_names(ct)[0],
                              tree.leaves(gt), tree.leaves(ct)):
            c = c.cpu().numpy()
            scale = float(np.abs(c).max()) or 1.0
            worst.append((float(np.abs(g.cpu().numpy() - c).max()) / scale,
                          f"{which} {leaf}"))
    worst.sort(reverse=True)
    return worst[0][0], [[w, r] for r, w in worst[:3]]


def _shared_state_moments(cfg, src, lr_fn) -> tuple[float, list]:
    """Five steps on the card; before each, the CPU takes the card's
    params and moments and takes the same step: the largest
    ``_moment_rel`` over the steps, each from one shared state."""
    from repro_torch import tree
    from repro_torch.launch.train import make_train_step, micro_batches
    from repro_torch.models.transformer import init_params
    from repro_torch.optim import adamw
    params = tree.map_leaves(lambda t: t.to("cuda"),
                             init_params(cfg, seed=SEED, device="cpu"))
    opt = adamw.init(params)
    card, cpu = (make_train_step(cfg, lr_fn=lr_fn) for _ in range(2))
    rel, worst = 0.0, []
    for step in range(TRAIN_CROSS_STEPS):
        cp = tree.map_leaves(lambda t: t.cpu().clone(), params)
        co = adamw.AdamWState(opt.step.cpu().clone(), *(
            tree.map_leaves(lambda t: t.cpu().clone(), x)
            for x in (opt.m, opt.v)))
        mb = micro_batches(src.batch(step), 2)
        params, opt, _ = card(params, opt, mb)
        cp, co, _ = cpu(cp, co, mb)
        r, w = _moment_rel(opt, co)
        if r > rel:
            rel, worst = r, w
    return rel, worst


def run_train_card_vs_cpu() -> dict:
    """Phase 36: five steps of smoke models on the card and the CPU; for
    MoE also the expert counts of every step, the moments of each step
    from a shared state (``_shared_state_moments``: AdamW's eps turns a
    gradient entry near 1e-8 that differs in its last bits into updates
    up to lr apart, and over five steps olmoe's moments drift with one
    such embedding entry), and two backward passes on the card from one
    state."""
    from functools import partial
    import numpy as np
    import torch
    from repro_torch import kernels, tree
    from repro_torch.configs.base import registry, smoke
    from repro_torch.data import SyntheticLM
    from repro_torch.launch.train import make_train_step, micro_batches
    from repro_torch.models.transformer import init_params
    from repro_torch.optim import adamw, cosine_with_warmup
    runs, bad = [], []
    before = dict(kernels.launch_counts())
    expected = {}
    for name in TRAIN_CROSS_ARCHS:
        cfg = smoke(registry()[name])
        src = SyntheticLM(cfg.vocab, 64, 8, seed=SEED + 36,
                          input_mode=cfg.input_mode, d_model=cfg.d_model)
        lr_fn = partial(cosine_with_warmup, peak_lr=TRAIN_LR, warmup=0,
                        total=TRAIN_CROSS_STEPS)
        out = {}
        for dev in ("cpu", "cuda"):
            params = tree.map_leaves(
                lambda t: t.to(dev),
                init_params(cfg, seed=SEED, device="cpu"))
            opt = adamw.init(params)
            step_fn = make_train_step(cfg, lr_fn=lr_fn)
            losses, counts = [], []
            for step in range(TRAIN_CROSS_STEPS):
                params, opt, m = step_fn(
                    params, opt, micro_batches(src.batch(step), 2))
                losses.append(float(m["loss"]))
                if cfg.is_moe:
                    counts.append(m["expert_counts"].cpu().tolist())
            out[dev] = (losses, params, opt, counts)
        expected = _add_launches(expected, _train_launches(
            cfg, TRAIN_CROSS_STEPS * 2))
        (cl, cp, co, cc), (gl, gp, go, gc) = out["cpu"], out["cuda"]
        loss_rel = max(abs(a - b) / abs(b) for a, b in zip(gl, cl))
        lr_sum = sum(float(lr_fn(s)) for s in range(TRAIN_CROSS_STEPS))
        rtol, atol = TRAIN_TARGET
        moment_rel, worst = _moment_rel(go, co)
        param_err, n_over, n = 0.0, 0, 0
        for g, c in zip(tree.leaves(gp), tree.leaves(cp)):
            c = c.numpy()
            d = np.abs(g.cpu().numpy() - c)
            n_over += int((d > atol + rtol * np.abs(c)).sum())
            n += c.size
            param_err = max(param_err, float(d.max()))
        run = {"arch": name, "steps": TRAIN_CROSS_STEPS, "losses_card": gl,
               "losses_cpu": cl, "loss_max_rel": loss_rel,
               "moment_max_rel_of_leaf_max": moment_rel,
               "moment_worst_leaves": worst,
               "param_max_abs": param_err, "params": n,
               "param_entries_over_target": n_over,
               "param_bound_2_lr_sum": 2 * lr_sum}
        ok, gated_moment_rel = True, moment_rel
        if cfg.is_moe:
            batch = {k: torch.from_numpy(v[0]).cuda() for k, v in
                     micro_batches(src.batch(0), 2).items()}
            run["expert_counts_equal_every_step"] = gc == cc
            run["backward_bits_repeat"] = _backward_bits_repeat(cfg, gp,
                                                                batch)
            gated_moment_rel, run["moment_shared_state_worst_leaves"] = \
                _shared_state_moments(cfg, src, lr_fn)
            run["moment_shared_state_max_rel_of_leaf_max"] = \
                gated_moment_rel
            expected = _add_launches(expected, _train_launches(
                cfg, 2 + 2 * TRAIN_CROSS_STEPS))
            ok = run["expert_counts_equal_every_step"] and \
                run["backward_bits_repeat"]
        runs.append(run)
        if not (ok and loss_rel <= TRAIN_LOSS_RTOL
                and gated_moment_rel <= TRAIN_MOMENT_REL
                and n_over <= TRAIN_OVER_TARGET_FRAC * n
                and param_err <= 2 * lr_sum):
            bad.append(name)
    line = {"phase": "train_card_vs_cpu", "loss_rtol": TRAIN_LOSS_RTOL,
            "moment_rel": TRAIN_MOMENT_REL,
            "param_target_rtol_atol": list(TRAIN_TARGET),
            "param_over_target_frac": TRAIN_OVER_TARGET_FRAC, "runs": runs,
            "kernel_launches": _launch_delta(before),
            "kernel_launches_expected": expected}
    if bad or line["kernel_launches"] != expected:
        print(json.dumps(line), file=sys.stderr, flush=True)
        raise RuntimeError(f"train_card_vs_cpu: {bad} outside the "
                           f"tolerance, or kernel launches "
                           f"{line['kernel_launches']} not {expected}")
    return line


def run_train_resume() -> dict:
    """Phase 37: ``train_loop`` on the card, resumed and crashed."""
    import tempfile
    import torch
    from repro_torch import kernels, tree
    from repro_torch.checkpoint import Checkpointer
    from repro_torch.configs.base import registry, smoke
    from repro_torch.launch.train import train_loop
    cfg = smoke(registry()["phi3_mini_3_8b"])
    kw = dict(global_batch=4, seq_len=64, n_micro=1, log_every=0,
              seed=SEED, device="cuda")
    before = dict(kernels.launch_counts())
    with tempfile.TemporaryDirectory() as d:
        la, pa, oa = train_loop(cfg, steps=20, **kw)
        lb1, _, _ = train_loop(cfg, steps=10, ckpt_dir=d, ckpt_every=10,
                               **kw)
        lb2, pb, ob = train_loop(cfg, steps=20, ckpt_dir=d, ckpt_every=10,
                                 **kw)
        same = all(torch.equal(x, y) for x, y in
                   zip(tree.leaves((pa, oa)), tree.leaves((pb, ob))))
    with tempfile.TemporaryDirectory() as d:
        try:
            train_loop(cfg, steps=20, ckpt_dir=d, ckpt_every=5, crash_at=12,
                       **kw)
            crashed = False
        except RuntimeError as e:
            crashed = "simulated crash at step 12" in str(e)
        saved = Checkpointer(d).steps()
        lc, _, oc = train_loop(cfg, steps=20, ckpt_dir=d, ckpt_every=5,
                               **kw)
    line = {"phase": "train_resume", "arch": cfg.name,
            "losses_straight": la, "losses_resumed": lb2,
            "losses_equal": lb1 == la[:10] and lb2 == la[10:],
            "params_and_moments_equal": same, "crashed_at_12": crashed,
            "checkpoints_at_crash": saved,
            "steps_after_crash": len(lc), "final_step": int(oc.step),
            "kernel_launches": _launch_delta(before)}
    if not (line["losses_equal"] and same and crashed and saved == [5, 10]
            and len(lc) == 10 and int(oc.step) == 20
            and not line["kernel_launches"]):
        print(json.dumps(line), file=sys.stderr, flush=True)
        raise RuntimeError("train_resume: a resume differs or the crash "
                           "did not resume at step 10")
    return line


MOE_BWD_TOL = 1e-5       # every output within 1e-5 of its largest |plain|
MOE_BWD_OUTPUTS = ("dxg", "dw_gate", "dw_up", "dw_down", "dgate")


def _moe_bwd_row(name, shape, launches, launches_path, seed) -> dict:
    """One ``moe_ffn_bwd`` row: the three launches of ``moe_ffn_backward``
    from the training forward's g, u and h (``moe_ffn_train``, made once
    before the timing) against ``moe_ffn_backward_plain`` on the same
    inputs (every output within ``MOE_BWD_TOL`` of its largest plain
    magnitude; the empty experts' weight gradients exactly zero),
    CUDA-event ms of the eager call, ``device_ms`` over a CUDA graph of
    calls and each entry's device ms (``torch.profiler``), the plain
    version's ms, the bounds (the rows' x and dy, the forward's g, u and
    h, the touched experts' weights, the gate weights and offsets read
    once, dx, dgate and every expert's three weight gradients written
    once; 12 R d ff operations: t, dx and the three weight gradients,
    with the parent design's 16 R d ff, which recomputed g and u, beside
    them), and the HGMMA count of the entries' SASS.  No PyTorch call
    computes it.  The same rows regrouped over the last half of the
    experts check that the empty half's dW is exactly zero
    (``half_empty_check``)."""
    import numpy as np
    import torch
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.kernels import moe_ffn as KM
    d, ff, n_exp, tokens, top_k = shape
    xg, offs, w, gate, sizes = _moe_inputs(d, ff, n_exp, tokens, top_k,
                                           torch.float32, seed)
    R = tokens * top_k
    gen = torch.Generator(device="cuda")
    gen.manual_seed(seed + 1)
    dy = torch.randn((R, d), generator=gen, device="cuda")
    guh = KM.moe_ffn_train(xg, offs, *w, gate)[1:]

    def call():
        return KM.moe_ffn_backward(dy, xg, offs, *w, gate, *guh)

    def plain():
        return KM.moe_ffn_backward_plain(dy, xg, offs, *w, gate, *guh)
    got, want = call(), plain()
    again = call()
    torch.cuda.synchronize()
    errs, bad = {}, []
    for out, g, p in zip(MOE_BWD_OUTPUTS, got, want):
        err = float((g - p).abs().max())
        scale = float(p.abs().max())
        errs[out] = {"max_abs_err": err, "max_abs_plain": scale}
        if not (torch.isfinite(g).all() and err <= MOE_BWD_TOL * scale):
            bad.append(out)
    repeat = all(torch.equal(a, b) for a, b in zip(got, again))
    empty = np.flatnonzero(sizes == 0)
    empty_zero = all(int(torch.count_nonzero(g[e])) == 0
                     for e in empty for g in got[1:4])
    del again
    # the same rows regrouped over the last half of the experts, the first
    # half empty: their dW exactly zero, every output within tolerance
    half = np.zeros(n_exp, np.int64)
    half[n_exp // 2:] = np.diff(np.linspace(0, R, n_exp - n_exp // 2 + 1)
                                .astype(np.int64))
    offs_h = torch.tensor(np.concatenate([[0], np.cumsum(half)]),
                          dtype=torch.int32, device="cuda")
    guh_h = KM.moe_ffn_train(xg, offs_h, *w, gate)[1:]
    got_h = KM.moe_ffn_backward(dy, xg, offs_h, *w, gate, *guh_h)
    want_h = KM.moe_ffn_backward_plain(dy, xg, offs_h, *w, gate, *guh_h)
    torch.cuda.synchronize()
    half_check = {
        "empty_experts": n_exp // 2,
        "dw_exactly_zero": all(int(torch.count_nonzero(g[e])) == 0
                               for e in range(n_exp // 2)
                               for g in got_h[1:4]),
        "max_rel_err": max(float((g - p).abs().max() / p.abs().max())
                           for g, p in zip(got_h, want_h))}
    del got_h, want_h, guh_h
    if not (half_check["dw_exactly_zero"]
            and half_check["max_rel_err"] <= MOE_BWD_TOL):
        bad.append("half_empty")
    touched = int((sizes > 0).sum())
    wbytes = 3 * d * ff * 4
    nbytes = (2 * R * d * 4 + 3 * R * ff * 4 + touched * wbytes + R * 4
              + (n_exp + 1) * 4 + R * d * 4 + R * 4 + n_exp * wbytes)
    flops = 12.0 * R * d * ff
    # outputs and scratch a call allocates: a graph of calls holds them all
    rp = -(-(R + 3 * n_exp) // 4) * 4
    per_call = (n_exp * wbytes + R * d * 4 + R * 4 + 3 * ff * rp * 4
                + R * -(-ff // KM.BWD_TILE) * 4)
    one = _time_ms(call, iters=1, warmup=1)
    n = max(1, min(50, int(200 / max(one, 1e-3))))
    g_calls = max(1, min(n, int(8e9 // per_call)))
    reps = max(1, min(20, int(1000 / max(one * g_calls, 1e-3))))
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(3):
            call()
        torch.cuda.synchronize()
    # the mean of each entry's traced instances (a trace can drop some)
    us, seen = [0.0] * KM.BWD_LAUNCHES, [0] * KM.BWD_LAUNCHES
    for e in prof.events():
        m = re.search(r"moe_bwd_kernel<(\d)>", e.name)
        if m:
            us[int(m.group(1))] += e.time_range.end - e.time_range.start
            seen[int(m.group(1))] += 1
    by_entry = [u / max(n, 1) / 1e3 for u, n in zip(us, seen)]
    parent = _f32_bounds(nbytes - 3 * R * ff * 4, 16.0 * R * d * ff)
    row = {"name": name, "route": "cuda",
           "source": "src/repro_torch/kernels/csrc/moe_ffn_bwd.cu",
           "replaces": "src/repro/models/moe.py:83",
           "replaces_note": "XLA's gradient of the three lax.ragged_dot in "
                            "_grouped_ffn (no Pallas kernel)",
           "launches": launches, "launches_path": launches_path,
           "launches_per_call": KM.BWD_LAUNCHES,
           "max_abs_err": max(e["max_abs_err"] for e in errs.values()),
           "errors": errs,
           "tolerance": f"{MOE_BWD_TOL} x max|plain| per output",
           "empty_experts": len(empty),
           "empty_experts_dw_exactly_zero": empty_zero,
           "half_empty_check": half_check,
           "bits_repeat": repeat,
           "ms": _time_ms(call, iters=n, warmup=1),
           "device_ms": _graph_ms(call, calls=g_calls, replays=reps),
           "device_ms_by_entry": dict(zip(
               ("down_dgrad", "x_dgrad", "weight_grads"), by_entry)),
           "traced_instances_by_entry": seen,
           "plain_ms": _time_ms(plain, iters=3, warmup=1),
           "library_ms": None,
           "library_call": "none: torch._grouped_mm takes bf16 only",
           "shape": {"d": d, "ff": ff, "experts": n_exp, "tokens": tokens,
                     "top_k": top_k, "rows": R, "touched_experts": touched,
                     "dtype": "float32"},
           "timing_calls": {"eager": n, "graph": g_calls, "replays": reps},
           "note": "ms: CUDA events around eager calls; device_ms: per "
                   "call of a CUDA graph of timing_calls calls (three "
                   "launches each); the forward's g, u, h are inputs",
           **_f32_bounds(nbytes, flops),
           "flops": flops,
           "parent_design_flops": 16.0 * R * d * ff,
           "parent_design_bound_ms": parent["bound_ms"],
           "parent_design_note": "four launches on mma.sync, g and u "
                                 "recomputed: 16 R d ff operations",
           "sass_hgmma": _sass_count("moe_bwd_kernel", "HGMMA")}
    del xg, w, dy, got, want, guh
    torch.cuda.empty_cache()
    if bad or not empty_zero or not repeat or not row["sass_hgmma"]:
        print(json.dumps(row), file=sys.stderr, flush=True)
        raise RuntimeError(f"{name}: outputs {bad} disagree with plain, an "
                           f"empty expert's dW is not zero, the bits do not "
                           f"repeat, or no HGMMA")
    return row


def _moe_train_fwd_row(launches, seed) -> dict:
    """The float32 ``moe_ffn`` at olmoe's training shape (2048 tokens x
    top 8 = 16384 rows over 64 experts, d 2048, ff 1024), the serving
    entry and the training entry (``moe_ffn_train``, g and u stored
    beside h) timed in one place: each one's ``device_ms`` over a CUDA
    graph, the training entry's y equal to the serving entry's bit for
    bit, its g, u and y within ``MOE_F32_TOL`` of the plain version's
    largest magnitude, the bound (the touched experts' weights, the rows,
    y once and, for the training entry, g, u and h; 6 R d ff operations)
    and ``launches`` (``train_olmoe``'s, all through the training
    entry)."""
    import torch
    from repro_torch.kernels import moe_ffn as KM
    d, ff, n_exp, tokens, top_k = 2048, 1024, 64, 2048, 8
    xg, offs, w, gate, sizes = _moe_inputs(d, ff, n_exp, tokens, top_k,
                                           torch.float32, seed)
    R = tokens * top_k

    def serve():
        return KM.moe_ffn(xg, offs, *w, gate)

    def train():
        return KM.moe_ffn_train(xg, offs, *w, gate)
    y, g, u, h = train()
    same = bool(torch.equal(y, serve()))
    yp, gp, up, _ = KM.moe_ffn_train_plain(xg, offs, *w, gate)
    abs_errs = {k: float((a - b).abs().max())
                for k, a, b in (("y", y, yp), ("g", g, gp), ("u", u, up))}
    errs = {k: abs_errs[k] / float(b.abs().max())
            for k, b in (("y", yp), ("g", gp), ("u", up))}
    finite = all(bool(torch.isfinite(t).all()) for t in (y, g, u, h))
    del yp, gp, up, y, g, u, h
    touched = int((sizes > 0).sum())
    nbytes = (touched * 3 * d * ff * 4 + R * d * 4 + R * d * 4 + R * 4
              + (n_exp + 1) * 4)
    flops = 6.0 * R * d * ff
    calls = 10
    row = {"name": "moe_ffn_f32 train", "route": "cuda",
           "source": "src/repro_torch/kernels/csrc/moe_ffn.cu",
           "replaces": "src/repro/models/moe.py:86",
           "replaces_note": "XLA: three lax.ragged_dot in _grouped_ffn (no "
                            "Pallas kernel)",
           "launches": launches, "launches_path": "train_olmoe",
           "launches_per_call": 2,
           "max_abs_err": max(abs_errs.values()),
           "max_abs_err_by_output": abs_errs,
           "rel_errors": errs,
           "tolerance": f"{MOE_F32_TOL} x max|plain|",
           "y_bits_equal_serving": same,
           "ms": _time_ms(train, iters=calls, warmup=1),
           "device_ms": _graph_ms(train, calls=calls, replays=3),
           "serving_ms": _time_ms(serve, iters=calls, warmup=1),
           "serving_device_ms": _graph_ms(serve, calls=calls, replays=3),
           "plain_ms": _time_ms(
               lambda: KM.moe_ffn_train_plain(xg, offs, *w, gate), iters=2,
               warmup=1),
           "library_ms": None,
           "library_call": "none: torch._grouped_mm takes bf16 only",
           "shape": {"d": d, "ff": ff, "experts": n_exp, "tokens": tokens,
                     "top_k": top_k, "rows": R, "touched_experts": touched,
                     "dtype": "float32"},
           "note": "device_ms: the training entry (g, u and h stored), "
                   "serving_device_ms: moe_ffn (h alone), each per call of "
                   "a CUDA graph of 10 calls; the bound is the serving "
                   "entry's bytes, training_bound_ms adds g and u",
           **_f32_bounds(nbytes, flops),
           "training_bound_ms": _f32_bounds(nbytes + 2 * R * ff * 4,
                                            flops)["bound_ms"]}
    del xg, w
    torch.cuda.empty_cache()
    if not (same and finite and max(errs.values()) <= MOE_F32_TOL):
        print(json.dumps(row), file=sys.stderr, flush=True)
        raise RuntimeError("moe_ffn_f32 train: y differs from the serving "
                           "entry's or g, u, y miss plain")
    return row


def bench_moe_bwd_kernels(train_lines: list[dict]) -> list[dict]:
    """``moe_ffn_bwd``'s rows: olmoe's training shape (2048 tokens x top
    8 = 16384 rows over 64 experts, d 2048, ff 1024; ``train_olmoe``'s
    launches) and ``train_moe_tiered``'s microbatch (smoke olmoe: 256
    tokens x top 2 = 512 rows over 8 experts, d 128, ff 64; its
    launches), and the float32 ``moe_ffn`` training row at olmoe's
    training shape (``train_olmoe``'s forward launches)."""
    from repro_torch.launch import train_moe_tiered as tiered
    by = {line["phase"]: line for line in train_lines}
    olmoe = (2048, 1024, 64)
    cfg = tiered.config()
    tiered_shape = (cfg.d_model, cfg.expert_d_ff, cfg.n_experts,
                    tiered.GLOBAL_BATCH * tiered.SEQ_LEN // tiered.N_MICRO,
                    cfg.top_k)
    return [
        _moe_bwd_row("moe_ffn_bwd", (*olmoe, 2048, 8),
                     by["train_olmoe"]["kernel_launches"]["moe_ffn_bwd"],
                     "train_olmoe", SEED + 40),
        _moe_bwd_row("moe_ffn_bwd sparse", tiered_shape,
                     by["train_moe_tiered"]["kernel_launches"]["moe_ffn_bwd"],
                     "train_moe_tiered", SEED + 41),
        _moe_train_fwd_row(by["train_olmoe"]["kernel_launches"]["moe_ffn"],
                           SEED + 43)]


def run_train_moe_tiered() -> dict:
    """Phase 37b: ``launch.train_moe_tiered`` at its defaults on the card
    (smoke olmoe, 200 steps, a crash at 100 and a restart from its
    checkpoint): the last loss below 5.0.  Its printed lines go to
    standard error."""
    import tempfile
    from repro_torch import kernels
    from repro_torch.launch import train_moe_tiered as tiered
    cfg = tiered.config()
    steps = 200
    before = dict(kernels.launch_counts())
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory() as d, \
            contextlib.redirect_stdout(sys.stderr):
        losses, _, opt = tiered.run(cfg, steps=steps, device="cuda",
                                    ckpt_dir=d)
    expected = _train_launches(cfg, steps * 2)
    line = {"phase": "train_moe_tiered", "arch": cfg.name,
            "layers": cfg.n_layers, "steps": steps,
            "crash_at": steps // 2, "steps_after_restart": len(losses),
            "final_step": int(opt.step), "loss_first_after_restart":
            losses[0], "loss_last": losses[-1],
            "target_loss": tiered.TARGET_LOSS,
            "seconds": time.perf_counter() - t0,
            "kernel_launches": _launch_delta(before),
            "kernel_launches_expected": expected}
    if not (losses[-1] < tiered.TARGET_LOSS and len(losses) == steps // 2
            and int(opt.step) == steps
            and line["kernel_launches"] == expected):
        print(json.dumps(line), file=sys.stderr, flush=True)
        raise RuntimeError("train_moe_tiered: the loss did not end below "
                           "5.0, the restart did not resume at 100, or the "
                           "launches differ")
    return line


def run_training() -> list[dict]:
    """Phases 34-37b.  The dense, Mamba and hybrid steps launch no kernel;
    the MoE steps launch exactly ``_train_launches``' counts and nothing
    else; every phase's launches are checked, then their sum."""
    from repro_torch import kernels
    before = dict(kernels.launch_counts())
    lines = []
    for phase, name, layers, steps in TRAIN_RUNS:
        lines.append(run_train(phase, name, layers, steps))
        print(json.dumps(lines[-1]), file=sys.stderr, flush=True)
    for fn in (run_train_card_vs_cpu, run_train_resume,
               run_train_moe_tiered):
        lines.append(fn())
        print(json.dumps(lines[-1]), file=sys.stderr, flush=True)
    expected = {}
    for line in lines:
        expected = _add_launches(expected, line.get(
            "kernel_launches_expected", {}))
        profiled = line.get("profiled_step")
        if profiled:
            expected = _add_launches(expected, profiled["kernel_launches"])
    launched = _launch_delta(before)
    if launched != {k: v for k, v in expected.items() if v}:
        raise RuntimeError(f"kernels launched in training: {launched}, "
                           f"expected {expected}")
    return lines


# =============================================================================
# slice 21: the MoE shard bodies one shard after another, the sharded step
# =============================================================================

# ``moe_shards``: olmoe_1b_7b at full width, 4096 tokens (one data group),
# experts split over 4 expert-parallel shards, at capacity 1.25 (rows are
# dropped) and 8.0 (none are); mixtral_8x7b at full width with 2 experts,
# d_ff split 4 ways (tensor parallel), 512 tokens.  bf16 and float32
# forward, float32 under autograd (``moe_ffn_train``, ``moe_ffn_bwd``).
SHARD_EP, SHARD_EP_TOKENS, SHARD_FACTORS = 4, 4096, (1.25, 8.0)
SHARD_TP, SHARD_TP_TOKENS = 4, 512
# ``sharded_train``: one step of the sharded train step against the
# unsharded one on the same card, at full width and 2 layers.  The mesh
# is (1, 1) over NCCL: gloo carries the c10d collectives for CUDA
# tensors, but its functional all_gather_into_tensor (every DTensor
# gather: Shard -> Replicate, full_tensor) ended the process with
# SIGSEGV on the card's torch, and NCCL refuses two ranks on one card.
SHARDED_BACKEND, SHARDED_MESH = "nccl", (1, 1)
SHARDED_RUNS = (("olmoe_1b_7b", 2), ("qwen3_4b", 2))
SHARDED_BATCH, SHARDED_SEQ, SHARDED_MICRO = 4, 512, 2
SHARDED_LOSS_ATOL, SHARDED_PARAM_ATOL, SHARDED_GRAD_FLOOR = 1e-5, 2e-5, 1e-6


def _shard_weights(p: dict, m: int, n: int, ep: bool) -> dict:
    """Shard ``m`` of ``n`` of MoE weights: its experts (EP) or its d_ff
    slice of every expert (TP), as contiguous tensors."""
    if ep:
        e = p["w_gate"].shape[0] // n
        cut = {k: p[k][m * e:(m + 1) * e] for k in ("w_gate", "w_up",
                                                     "w_down")}
    else:
        f = p["w_gate"].shape[2] // n
        cut = {"w_gate": p["w_gate"][..., m * f:(m + 1) * f],
               "w_up": p["w_up"][..., m * f:(m + 1) * f],
               "w_down": p["w_down"][:, m * f:(m + 1) * f]}
    return dict(p, **{k: v.contiguous() for k, v in cut.items()})


def _shard_grouped(x, p, part, top_k):
    """The grouped rows one shard's partial hands ``moe_ffn``: (xg, gate),
    the rows that are not the shard's zeroed, their gate weight 0."""
    from repro_torch.models import moe
    w = moe.route(x, p["w_router"], top_k)[0]
    keep = part.valid[:, None].to(x.dtype)
    xg = (x[part.order // top_k] * keep).contiguous()
    return xg, (w.reshape(-1)[part.order] * part.valid).contiguous()


def _shard_kernel_check(x, ps, part, top_k, tol, grad: bool) -> dict:
    """One shard's grouped rows through ``moe_ffn`` against
    ``moe_ffn_plain`` on the card (``tol`` of max|plain|), and with
    ``grad`` through ``moe_ffn_backward`` against
    ``moe_ffn_backward_plain`` from the training entry's g, u, h (every
    output within 1e-5 of its largest).  Comparison launches, not the
    path's."""
    import torch
    from repro_torch.kernels import moe_ffn as KM
    xg, gate = _shard_grouped(x, ps, part, top_k)
    ws = (ps["w_gate"], ps["w_up"], ps["w_down"])
    got = KM.moe_ffn(xg, part.offs, *ws, gate)
    want = KM.moe_ffn_plain(xg, part.offs, *ws, gate)
    err = float((got - want).abs().max())
    scale = float(want.abs().max())
    if not (torch.isfinite(got).all() and err <= tol * scale):
        raise RuntimeError(f"moe_shards: moe_ffn at a shard layout: max "
                           f"abs err {err} > {tol} x {scale}")
    out = {"max_abs_err": err, "max_abs_plain": scale}
    if grad:
        gen = torch.Generator(device="cuda")
        gen.manual_seed(SEED + 90)
        dy = torch.randn(got.shape, generator=gen, device="cuda")
        guh = KM.moe_ffn_train(xg, part.offs, *ws, gate)[1:]
        g = KM.moe_ffn_backward(dy, xg, part.offs, *ws, gate, *guh)
        pl = KM.moe_ffn_backward_plain(dy, xg, part.offs, *ws, gate, *guh)
        errs = {}
        for name, a, b in zip(MOE_BWD_OUTPUTS, g, pl):
            e, sc = float((a - b).abs().max()), float(b.abs().max())
            if not (torch.isfinite(a).all() and e <= MOE_BWD_TOL * sc):
                raise RuntimeError(f"moe_shards: moe_ffn_bwd {name} at a "
                                   f"shard layout: {e} > {MOE_BWD_TOL} x "
                                   f"{sc}")
            errs[name] = e
        out["bwd_max_abs_err"] = errs
    return out


def _shard_inputs(d, E, ff, tokens, dtype, seed, favour: int = 0):
    """x [tokens, d] and MoE weights with the init scales, drawn on the
    card from ``seed``; the router's first ``favour`` columns scaled by 4,
    so that the shard holding those experts gets more slots than its
    capacity at 1.25."""
    import torch
    from repro_torch.models import moe
    gen = torch.Generator(device="cuda")
    gen.manual_seed(seed)
    x = torch.randn((tokens, d), generator=gen, device="cuda").to(dtype)
    p = moe.init_moe_params(gen, d, E, ff, dtype=dtype, device="cuda")
    p["w_router"][:, :favour] *= 4
    return x, p


def _ep_case(x, p, top_k, factor, tol, grad: bool) -> tuple[dict, dict]:
    """The EP partials of every shard in turn (the path: their launches
    are counted), summed in shard order; their kernels against plain;
    ``order``, ``valid``, the group offsets, ``idx`` and the counts
    against the CPU's routing and layout.  With ``grad`` the partials
    run under autograd and backward.  Returns (the case's line, the last
    shard's kernel inputs for a timing row)."""
    import torch
    from repro_torch import kernels
    from repro_torch.models import moe
    T, E = x.shape[0], p["w_router"].shape[1]
    e_local = E // SHARD_EP
    cap = moe.ep_capacity(T, top_k, SHARD_EP, factor)
    shards = [_shard_weights(p, m, SHARD_EP, True) for m in range(SHARD_EP)]
    if grad:
        x = x.clone().requires_grad_(True)
        for ps in shards:
            for k in ("w_gate", "w_up", "w_down"):
                ps[k].requires_grad_(True)
    before = dict(kernels.launch_counts())
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with torch.set_grad_enabled(grad):
        parts = [moe.ep_shard_partial(x, ps, top_k, m, SHARD_EP, cap)
                 for m, ps in enumerate(shards)]
        total = parts[0].out
        for part in parts[1:]:
            total = total + part.out
        if grad:
            gen = torch.Generator(device="cuda")
            gen.manual_seed(SEED + 91)
            (total * torch.randn(total.shape, generator=gen,
                                 device="cuda")).sum().backward()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launched = _launch_delta(before)
    want_launch = {"moe_ffn": 2 * SHARD_EP}
    if grad:
        want_launch["moe_ffn_bwd"] = 3 * SHARD_EP
    if launched != want_launch:
        raise RuntimeError(f"moe_shards: launches {launched}, expected "
                           f"{want_launch}")
    # the CPU's routing and layout of the same rows
    xd = x.detach()
    _, idx_c, _, counts_c = moe.route(xd.cpu(), p["w_router"].detach().cpu(),
                                      top_k)
    layout_equal, dropped, checks = True, [], []
    for m, (part, ps) in enumerate(zip(parts, shards)):
        order, valid, offs, _ = moe.ep_layout(idx_c, m, e_local, cap)
        same = (torch.equal(part.idx.cpu(), idx_c)
                and torch.equal(part.counts.cpu(), counts_c)
                and torch.equal(part.order.cpu(), order)
                and torch.equal(part.valid.cpu(), valid)
                and torch.equal(part.offs.cpu(), offs))
        layout_equal &= same
        mine = int(((idx_c // e_local) == m).sum())
        dropped.append(mine - int(valid.sum()))
        with torch.no_grad():
            checks.append(_shard_kernel_check(
                xd, {k: v.detach() for k, v in ps.items()}, part, top_k,
                tol, grad))
    if not layout_equal:
        raise RuntimeError(f"moe_shards: EP layout at capacity {factor} "
                           f"differs from the CPU's")
    line = {"dtype": str(x.dtype).removeprefix("torch."),
            "capacity_factor": factor, "capacity": cap, "grad": grad,
            "rows_dropped_per_shard": dropped,
            "empty_local_groups": [int((part.offs.diff() == 0).sum())
                                   for part in parts],
            "layout_equal_cpu": layout_equal, "launches": launched,
            "wall_s": wall, "kernel_vs_plain": checks}
    if factor >= 8.0 and not grad:
        with torch.no_grad():
            want = moe.moe_sorted_local(xd, p, top_k)[0].float()
        err = float((total.to(xd.dtype).float() - want).abs().max())
        line["sum_vs_unsharded"] = {"max_abs_err": err,
                                    "max_abs_unsharded":
                                        float(want.abs().max())}
        if err > tol * float(want.abs().max()):
            raise RuntimeError(f"moe_shards: EP sum vs unsharded {err}")
    if factor < 8.0 and not any(dropped):
        raise RuntimeError("moe_shards: capacity 1.25 dropped no row")
    if factor >= 8.0 and any(dropped):
        raise RuntimeError("moe_shards: capacity 8.0 dropped rows")
    last = parts[-1]
    xg, gate = _shard_grouped(xd, shards[-1], last, top_k)
    ws = [shards[-1][k].detach() for k in ("w_gate", "w_up", "w_down")]
    sizes = last.offs.diff().cpu().numpy()
    return line, (xg, last.offs, ws, gate, sizes)


def _tp_case(x, p, top_k, tol, grad: bool) -> dict:
    """The TP partials (d_ff slices) in turn, summed; against the
    unsharded layer on the card (float32 within ``tol`` of its largest;
    bf16 within ``SHARD_TP`` ulps, one for each partial rounded to bf16
    before the sum) and each shard's kernels against plain; the routing
    against the CPU's."""
    import torch
    from repro_torch import kernels
    from repro_torch.models import moe
    shards = [_shard_weights(p, m, SHARD_TP, False) for m in range(SHARD_TP)]
    if grad:
        x = x.clone().requires_grad_(True)
        for ps in shards:
            for k in ("w_gate", "w_up", "w_down"):
                ps[k].requires_grad_(True)
    before = dict(kernels.launch_counts())
    with torch.set_grad_enabled(grad):
        parts = [moe.tp_shard_partial(x, ps, top_k) for ps in shards]
        total = parts[0].out
        for part in parts[1:]:
            total = total + part.out
        if grad:
            total.sum().backward()
    torch.cuda.synchronize()
    launched = _launch_delta(before)
    want_launch = {"moe_ffn": 2 * SHARD_TP}
    if grad:
        want_launch["moe_ffn_bwd"] = 3 * SHARD_TP
    if launched != want_launch:
        raise RuntimeError(f"moe_shards TP: launches {launched}, expected "
                           f"{want_launch}")
    xd = x.detach()
    _, idx_c, _, counts_c = moe.route(xd.cpu(), p["w_router"].cpu(), top_k)
    same = all(torch.equal(part.idx.cpu(), idx_c)
               and torch.equal(part.counts.cpu(), counts_c)
               for part in parts)
    if not same:
        raise RuntimeError("moe_shards TP: routing differs from the CPU's")
    with torch.no_grad():
        checks = [_shard_kernel_check(
            xd, {k: v.detach() for k, v in ps.items()}, part, top_k, tol,
            grad) for part, ps in zip(parts, shards)]
        want = moe.moe_sorted_local(xd, p, top_k)[0].float()
    err = float((total.detach().to(xd.dtype).float() - want).abs().max())
    # JAX's TP body rounds each shard's partial to x's type before the
    # psum: in bf16 the sum may stand one ulp of each partial apart
    limit = (tol if xd.dtype == torch.float32 else SHARD_TP * 2 ** -8)
    if err > limit * float(want.abs().max()):
        raise RuntimeError(f"moe_shards TP: sum vs unsharded {err}")
    return {"dtype": str(x.dtype).removeprefix("torch."), "grad": grad,
            "routing_equal_cpu": same, "launches": launched,
            "sum_vs_unsharded": {"max_abs_err": err,
                                 "max_abs_unsharded":
                                     float(want.abs().max()),
                                 "limit_of_max": limit},
            "kernel_vs_plain": checks}


def run_moe_shards() -> tuple[dict, list[dict]]:
    """Phase ``moe_shards``: JAX's expert- and tensor-parallel shard
    bodies up to their ``psum`` (``ep_shard_partial``,
    ``tp_shard_partial``) for every shard in turn on the card, at full
    olmoe and mixtral widths.  Returns its line and the ``moe_ffn`` rows
    at the EP shard shape (bf16 and float32, capacity 1.25)."""
    import torch
    from repro_torch.configs.base import registry
    olmoe, mixtral = registry()["olmoe_1b_7b"], registry()["mixtral_8x7b"]
    t0 = time.perf_counter()
    line = {"phase": "moe_shards", "card": _card_line(),
            "olmoe_ep": [], "mixtral_tp": []}
    rows = []
    for dtype, tol in ((torch.bfloat16, MOE_TOL),
                       (torch.float32, MOE_F32_TOL)):
        x, p = _shard_inputs(olmoe.d_model, olmoe.n_experts,
                             olmoe.expert_d_ff, SHARD_EP_TOKENS, dtype,
                             SEED + 80, favour=4)
        for factor in SHARD_FACTORS:
            for grad in ((False, True) if dtype == torch.float32
                         and factor < 8.0 else (False,)):
                case, inputs = _ep_case(x, p, olmoe.top_k, factor, tol, grad)
                line["olmoe_ep"].append(case)
                if factor < 8.0 and not grad:
                    shard_rows = int(inputs[0].shape[0])
                    rows.append(_moe_row(
                        "moe_ffn ep_shard" + ("_f32" if dtype ==
                                              torch.float32 else ""),
                        (olmoe.d_model, olmoe.expert_d_ff,
                         olmoe.n_experts // SHARD_EP, shard_rows, 1), dtype,
                        tol, case["launches"]["moe_ffn"], SEED + 81,
                        bound_f32=dtype == torch.float32, inputs=inputs))
                    rows[-1]["replaces_note"] = (
                        "XLA: the three lax.ragged_dot of _grouped_ffn "
                        "inside _ep_shard_body (src/repro/models/moe.py:"
                        "117), one shard's capacity of rows over its "
                        "local experts, the rows of other shards zeroed "
                        "in the last group")
                del inputs
        del x, p
        x, p = _shard_inputs(mixtral.d_model, 2, mixtral.d_ff,
                             SHARD_TP_TOKENS, dtype, SEED + 82)
        for grad in ((False, True) if dtype == torch.float32 else (False,)):
            line["mixtral_tp"].append(_tp_case(x, p, mixtral.top_k, tol,
                                               grad))
        del x, p
        torch.cuda.empty_cache()
    line["seconds"] = time.perf_counter() - t0
    return line, rows


def _free_port() -> int:
    import socket
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def _sharded_run(arch: str, layers: int, mi) -> dict:
    """One step of ``make_train_step(cfg, mi)`` on DTensor parameters
    against ``make_train_step(cfg)`` on the same weights and batch, on
    the card."""
    from dataclasses import replace

    import torch
    from torch.distributed.tensor.debug import CommDebugMode
    from repro_torch import kernels, tree
    from repro_torch.configs.base import registry
    from repro_torch.data import SyntheticLM
    from repro_torch.launch.train import make_train_step, micro_batches
    from repro_torch.models.transformer import init_params
    from repro_torch.optim import adamw
    from repro_torch.parallel import sharding as sh
    cfg = replace(registry()[arch], n_layers=layers)
    params = init_params(cfg, seed=SEED, device="cuda")
    batch = micro_batches(SyntheticLM(cfg.vocab, SHARDED_SEQ, SHARDED_BATCH,
                                      seed=SEED).batch(0), SHARDED_MICRO)
    ps = sh.distribute(params, mi, sh.param_specs(cfg, mi))
    opt = adamw.init(ps)
    step = make_train_step(cfg, mi)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    # the step's own arguments on the card (the parameters' shards and the
    # moments); what else is resident (the unsharded copy kept for the
    # reference step) is left out of the step's peak below
    mem_before = torch.cuda.memory_allocated()
    arg_bytes = sum(t.to_local().numel() * t.element_size()
                    for t in tree.leaves([ps, opt.m, opt.v]))
    before = dict(kernels.launch_counts())
    comm = CommDebugMode()
    t0 = time.perf_counter()
    with comm:
        ps, opt, m = step(ps, opt, batch)
    torch.cuda.synchronize()
    step_ms = (time.perf_counter() - t0) * 1e3
    peak_bytes = torch.cuda.max_memory_allocated()
    peak = peak_bytes / 1e9
    step_peak = (arg_bytes + peak_bytes - mem_before) / 1e9
    launched = _launch_delta(before)
    want_launch = {k: v for k, v in _train_launches(
        cfg, SHARDED_MICRO).items() if v}
    if launched != want_launch:
        raise RuntimeError(f"sharded_train {arch}: launches {launched}, "
                           f"expected {want_launch}")
    got = [sh.full(p) for p in tree.leaves(ps)]
    del ps, opt
    ref = make_train_step(cfg)
    rp, ro, rm = ref(params, adamw.init(params), batch)
    dloss = abs(float(m["loss"]) - float(rm["loss"]))
    worst = 0.0
    for a, b, mo in zip(got, tree.leaves(rp), tree.leaves(ro.m)):
        big = (mo.abs() / 0.1) >= SHARDED_GRAD_FLOOR    # m = 0.1 g
        d = (a - b).abs()
        worst = max(worst, float(d[big].max()) if bool(big.any()) else 0.0)
    counts_equal = (torch.equal(m["expert_counts"], rm["expert_counts"])
                    if cfg.is_moe else None)
    ok = (dloss <= SHARDED_LOSS_ATOL and worst <= SHARDED_PARAM_ATOL
          and counts_equal is not False
          and all(bool(torch.isfinite(t).all()) for t in got))
    line = {"arch": arch, "layers": layers, "mode": (
                "ep" if cfg.is_moe else sh.attn_mode(cfg, mi)),
            "loss": float(m["loss"]), "loss_unsharded": float(rm["loss"]),
            "loss_abs_diff": dloss, "param_max_abs_diff_where_g_ge_1e-6":
                worst, "expert_counts_equal": counts_equal,
            "step_ms": step_ms, "peak_gb": peak,
            "argument_gb": arg_bytes / 1e9,
            "step_peak_over_arguments_gb": step_peak,
            "collectives": {str(k): v for k, v in
                            comm.get_comm_counts().items()},
            "kernel_launches": launched}
    del got, rp, ro, params
    torch.cuda.empty_cache()
    if not ok:
        raise RuntimeError(f"sharded_train: {line}")
    return line


def run_sharded_train() -> dict:
    """Phase ``sharded_train``: the sharded train step (DTensor parameters
    by ``param_specs``, ZeRO moments, the MoE expert-parallel branch on
    ``moe_ffn``/``moe_ffn_bwd``) at full olmoe_1b_7b and qwen3_4b width,
    2 layers, on a ``SHARDED_MESH`` mesh over ``SHARDED_BACKEND``, held
    against the unsharded step on the same card with C2's gates."""
    import torch.distributed as dist
    from repro_torch.launch.mesh import make_debug_mesh, make_mesh_info
    t0 = time.perf_counter()
    dist.init_process_group(SHARDED_BACKEND,
                            init_method=f"tcp://localhost:{_free_port()}",
                            rank=0, world_size=1)
    try:
        mi = make_mesh_info(make_debug_mesh(*SHARDED_MESH,
                                            device_type="cuda"))
        runs = [_sharded_run(arch, layers, mi)
                for arch, layers in SHARDED_RUNS]
    finally:
        dist.destroy_process_group()
    return {"phase": "sharded_train", "card": _card_line(),
            "backend": SHARDED_BACKEND, "mesh": list(SHARDED_MESH),
            "backend_note": "gloo's functional all_gather_into_tensor "
                            "crashed on CUDA tensors; NCCL takes one rank "
                            "a card", "batch": SHARDED_BATCH,
            "seq": SHARDED_SEQ, "micro": SHARDED_MICRO, "runs": runs,
            "seconds": time.perf_counter() - t0}


# =============================================================================
# slice 22: bf16-parameter training, sharded serving, the dry run
# =============================================================================

# ``bf16_train``: olmoe_1b_7b at full width cut to 2 layers, bf16
# parameters (the dry run's PARAM_DTYPE), the training phases' batch and
# microbatches, a constant lr
BF16_TRAIN_LAYERS, BF16_TRAIN_STEPS, BF16_TRAIN_LR = 2, 8, 1e-3
# bf16 moe_ffn_bwd vs its plain version (the same bf16 operands and
# float32 sums in another order; bf16 outputs): each output within 1e-2
# of its largest |plain|, about two bf16 ulps (2**-8) of that scale
MOE_BF16_BWD_TOL = 1e-2
# ``sharded_serve``: prefill + greedy decode at full width on a (1, 1)
# NCCL mesh against the unsharded path on the same card, bit for bit;
# depth cut (the decode under DTensor runs a few hundred host ops a
# layer): gemma3 to one 5 local + 1 global group, zamba2 to one shared
# site
SERVE_RUNS = (("qwen3_4b", 4), ("gemma3_4b", 6), ("olmoe_1b_7b", 4),
              ("zamba2_7b", 6))
SERVE_BATCH, SERVE_PROMPT, SERVE_NEW = 2, 512, 32
# ``dryrun``: one production cell per kind (arch, shape, multi-pod,
# analysis), traced in a subprocess on the fake backend; and the
# sharded_train olmoe step on a (1, 1) fake mesh, whose predicted peak is
# held within DRYRUN_PEAK_GATE of the card's
DRYRUN_CELLS = (("olmoe_1b_7b", "train_4k", False, True),
                ("qwen3_4b", "prefill_32k", False, False),
                ("gemma3_4b", "decode_32k", False, False),
                ("zamba2_7b", "long_500k", True, False))
DRYRUN_PEAK_GATE = 0.15


def _grouped_mm_bwd_library(dy, xg, offs, w, gate, g, u, h, sizes):
    """The bf16 backward's five products on PyTorch's grouped GEMM
    (``torch._grouped_mm``: t and the two dx products ragged over rows,
    the three weight gradients ragged over the reduction), with the
    SwiGLU backward between them in float32 as the kernel has it: the
    library yardstick of the bf16 ``moe_ffn_bwd``, used nowhere in the
    port.  A reduction ragged over rows must come in groups of whole
    16-byte rows (a device assert otherwise), so the weight gradients
    read their operands scattered into groups padded to 16 rows with
    zeros: x and h once, before the timing; dg, du and c dy in every
    call.  Returns (call, description) or (None, reason)."""
    import numpy as np
    import torch
    gm = getattr(torch, "_grouped_mm", None)
    if gm is None:
        return None, "this torch has no torch._grouped_mm"
    ends = offs[1:].contiguous()
    bf = torch.bfloat16
    padded = -(-sizes // 16) * 16
    starts = np.concatenate([[0], np.cumsum(padded)])
    dest = torch.from_numpy(np.concatenate(
        [np.arange(starts[e], starts[e] + n) for e, n in enumerate(sizes)]
    ).astype(np.int64)).cuda()
    ends_p = torch.from_numpy(starts[1:].astype(np.int32)).cuda()
    Rp = int(starts[-1])

    def pad(t):
        out = t.new_zeros((Rp, t.shape[1]))
        out[dest] = t
        return out
    xt, ht = pad(xg).t().contiguous(), pad(h).t().contiguous()

    def call():
        t = gm(dy.to(bf), w[2].transpose(1, 2), offs=ends).float()
        dh = (gate[:, None] * t).to(bf).float()
        s = torch.sigmoid(g)
        be = dh * u
        dg = (be * s + (g * be) * (s * (1 - s))).to(bf)
        du = ((g * s) * dh).to(bf)
        dx = (gm(dg, w[0].transpose(1, 2), offs=ends).to(bf).float()
              + gm(du, w[1].transpose(1, 2), offs=ends).to(bf).float())
        cdy = (gate[:, None] * dy).to(bf)
        return (dx.to(bf), gm(xt, pad(dg), offs=ends_p),
                gm(xt, pad(du), offs=ends_p), gm(ht, pad(cdy), offs=ends_p))
    try:
        call()
        torch.cuda.synchronize()
        return call, ("torch._grouped_mm x 6 (t, two dx products, three "
                      "weight gradients over groups padded to 16 rows) "
                      "with the SwiGLU backward between")
    except Exception as e:      # noqa: BLE001 - the reason is reported
        return None, f"{type(e).__name__}: {e}"[:200]


# the bf16 moe_ffn_bwd rows: (name, (d, ff, experts, tokens, top_k), seed
# offset): olmoe's training shape (bf16_train's) and mixtral's (4096 tokens
# x top 2 = 8192 rows over 8 experts, d 4096, ff 14336: the dry run's
# mixtral train_4k expert shape, where the kernel is bound by operations)
MOE_BF16_BWD_ROWS = (("moe_ffn_bwd bf16", (2048, 1024, 64, 2048, 8), 51),
                     ("moe_ffn_bwd bf16 mixtral", (4096, 14336, 8, 4096, 2),
                      52))


def _moe_bf16_bwd_row(name, shape, launches: int | None,
                      seed: int) -> dict:
    """The bf16 ``moe_ffn_bwd`` at ``shape`` (d, ff, experts, tokens,
    top_k; ``launches``: ``bf16_train``'s at olmoe's shape, None at
    mixtral's, which no card phase runs): the three launches of
    ``moe_ffn_backward`` from the bf16 training forward's g, u and h
    against the plain version on the same inputs (each output within
    ``MOE_BF16_BWD_TOL`` of its largest plain magnitude, dtypes equal,
    the empty experts' weight gradients exactly zero, two calls' bits
    equal), CUDA-event ms of eager calls, ``device_ms`` over a CUDA graph
    of calls, each launch's device ms (``torch.profiler``, the mean of its
    traced instances), the launch plan (``moe_ffn.bwd_launch_info``), the
    plain version's ms, the bound (12 R d ff operations over the bf16
    peak; the bytes: x, dy, g, u, h, the touched weights read once, dx,
    dgate and every expert's weight gradients written once) and
    ``torch._grouped_mm``'s time for the same products."""
    import numpy as np
    import torch
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.kernels import moe_ffn as KM
    d, ff, n_exp, tokens, top_k = shape
    xg, offs, w, gate, sizes = _moe_inputs(d, ff, n_exp, tokens, top_k,
                                           torch.bfloat16, seed)
    R = tokens * top_k
    gen = torch.Generator(device="cuda")
    gen.manual_seed(seed + 1)
    dy = torch.randn((R, d), generator=gen, device="cuda")
    g, u, h = KM.moe_ffn_train(xg, offs, *w, gate)[1:]

    def call():
        return KM.moe_ffn_backward(dy, xg, offs, *w, gate, g, u, h)

    def plain():
        return KM.moe_ffn_backward_plain(dy, xg, offs, *w, gate, g, u, h)
    got, want = call(), plain()
    again = call()
    torch.cuda.synchronize()
    errs, bad = {}, []
    for out, a, b in zip(MOE_BWD_OUTPUTS, got, want):
        err = float((a.float() - b.float()).abs().max())
        scale = float(b.float().abs().max())
        errs[out] = {"max_abs_err": err, "max_abs_plain": scale,
                     "dtype": str(a.dtype).removeprefix("torch.")}
        if a.dtype != b.dtype or not (bool(torch.isfinite(a).all())
                                      and err <= MOE_BF16_BWD_TOL * scale):
            bad.append(out)
    empty = np.flatnonzero(sizes == 0)
    empty_zero = all(int(torch.count_nonzero(t[e])) == 0
                     for e in empty for t in got[1:4])
    repeat = all(torch.equal(a, b) for a, b in zip(got, again))
    del again, want
    lib, lib_note = _grouped_mm_bwd_library(dy, xg, offs, w, gate, g, u, h,
                                            sizes)
    touched = int((sizes > 0).sum())
    wbytes = 3 * d * ff * 2
    nbytes = (R * d * 2 + R * d * 4 + 2 * R * ff * 4 + R * ff * 2
              + touched * wbytes + R * 4 + (n_exp + 1) * 4 + R * d * 2
              + R * 4 + n_exp * wbytes)
    flops = 12.0 * R * d * ff
    bound, by = _bound_ms(nbytes, flops)
    # outputs and scratch a call allocates: a graph of calls holds them all
    per_call = (n_exp * wbytes + 2 * R * d * 2 + 2 * R * ff * 2 + R * 4
                + R * -(-ff // KM.BWD_TILE) * 4)
    g_calls = max(1, min(10, int(8e9 // per_call)))
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(3):
            call()
        torch.cuda.synchronize()
    # the mean of each launch's traced instances (a trace can drop some)
    us, seen = [0.0] * KM.BWD_LAUNCHES, [0] * KM.BWD_LAUNCHES
    for e in prof.events():
        m = re.search(r"moe_bwd16_kernel<(\d)>", e.name)
        if m:
            us[int(m.group(1))] += e.time_range.end - e.time_range.start
            seen[int(m.group(1))] += 1
    # null where the trace holds no instance of a launch
    by_launch = [t / n / 1e3 if n else None for t, n in zip(us, seen)]
    row = {"name": name, "route": "cuda",
           "source": "src/repro_torch/kernels/csrc/moe_ffn_bwd.cu",
           "replaces": "src/repro/models/moe.py:83",
           "replaces_note": "XLA's gradient of the three lax.ragged_dot in "
                            "_grouped_ffn on bf16 rows and weights (no "
                            "Pallas kernel)",
           "launches": launches,
           "launches_path": None if launches is None else "bf16_train",
           "launches_note": ("no card phase runs mixtral's shape (the dry "
                             "run plans it); bf16_train's launches, at "
                             "olmoe's shape, are on the olmoe row"
                             if launches is None else "bf16_train, olmoe"),
           "launches_per_call": KM.BWD_LAUNCHES,
           "max_abs_err": max(e["max_abs_err"] for e in errs.values()),
           "errors": errs,
           "tolerance": f"{MOE_BF16_BWD_TOL} x max|plain| per output",
           "empty_experts": len(empty),
           "empty_experts_dw_exactly_zero": empty_zero,
           "bits_repeat": repeat,
           "ms": _time_ms(call, iters=5, warmup=1),
           "device_ms": _graph_ms(call, calls=g_calls, replays=3),
           "device_ms_by_launch": dict(zip(KM.BWD_LAUNCH_NAMES, by_launch)),
           "traced_instances_by_launch": seen,
           "plan": KM.bwd_launch_info(),
           "plain_ms": _time_ms(plain, iters=2, warmup=1),
           "bound_ms": bound, "bound_by": by, "flops": flops,
           "library_ms": (_time_ms(lib, iters=5, warmup=1)
                          if lib is not None else None),
           "library_call": lib_note,
           "shape": {"d": d, "ff": ff, "experts": n_exp, "tokens": tokens,
                     "top_k": top_k, "rows": R, "touched_experts": touched,
                     "dtype": "bfloat16"},
           "timing_calls": {"graph": g_calls, "replays": 3},
           "note": "ms: CUDA events around eager calls (three launches "
                   "each); device_ms: per call of a CUDA graph of "
                   "timing_calls calls; the forward's g, u, h are inputs; "
                   "a persistent grid a launch, a TMA ring of 3-4 "
                   "stages, two "
                   "consumer warpgroups on wgmma and a producer warp; the "
                   "weight gradients' operands read as they lie",
           "sass_hgmma": _sass_count("3b16", "HGMMA")}
    del xg, w, dy, got, g, u, h, lib
    torch.cuda.empty_cache()
    if bad or not empty_zero or not repeat or not row["sass_hgmma"]:
        print(json.dumps(row), file=sys.stderr, flush=True)
        raise RuntimeError(f"{name}: outputs {bad} disagree with plain, an "
                           f"empty expert's dW is not zero, the bits do not "
                           f"repeat, or no HGMMA")
    return row


def _moe_bf16_train_fwd_row(launches: int, seed: int) -> dict:
    """The bf16 training forward (``moe_ffn_train``: the serving entry's
    wgmma kernel with g and u kept) at olmoe's training shape: its y
    equal to ``moe_ffn``'s bit for bit, g and u within ``MOE_F32_TOL`` and
    h within ``MOE_BF16_BWD_TOL`` of the plain version's largest
    magnitude, ms beside the serving entry's and ``torch._grouped_mm``'s,
    the bound (6 R d ff over the bf16 peak; bytes with g and u)."""
    import torch
    from repro_torch.kernels import moe_ffn as KM
    d, ff, n_exp, tokens, top_k = 2048, 1024, 64, 2048, 8
    xg, offs, w, gate, sizes = _moe_inputs(d, ff, n_exp, tokens, top_k,
                                           torch.bfloat16, seed)
    R = tokens * top_k

    def train():
        return KM.moe_ffn_train(xg, offs, *w, gate)

    def serve():
        return KM.moe_ffn(xg, offs, *w, gate)
    y, g, u, h = train()
    same = bool(torch.equal(y, serve()))
    yp, gp, up, hp = KM.moe_ffn_train_plain(xg, offs, *w, gate)
    rel = {k: float((a.float() - b.float()).abs().max()
                    / b.float().abs().max())
           for k, a, b in (("y", y, yp), ("g", g, gp), ("u", u, up),
                           ("h", h, hp))}
    err = float((y - yp).abs().max())
    del yp, gp, up, hp, y, g, u, h
    lib, lib_note = _grouped_mm_library(xg, offs, w, gate)
    touched = int((sizes > 0).sum())
    nbytes = (touched * 3 * d * ff * 2 + R * d * 2 + R * d * 4 + R * ff * 2
              + 2 * R * ff * 4 + R * 4 + (n_exp + 1) * 4)
    bound, by = _bound_ms(nbytes, 6.0 * R * d * ff)
    row = {"name": "moe_ffn_bf16 train", "route": "cuda",
           "source": "src/repro_torch/kernels/csrc/moe_ffn.cu",
           "replaces": "src/repro/models/moe.py:86",
           "replaces_note": "XLA: three lax.ragged_dot in _grouped_ffn (no "
                            "Pallas kernel)",
           "launches": launches, "launches_path": "bf16_train",
           "launches_per_call": 2, "max_abs_err": err, "rel_errors": rel,
           "tolerance": f"g, u {MOE_F32_TOL}, y and h {MOE_BF16_BWD_TOL} "
                        f"x max|plain|",
           "y_bits_equal_serving": same,
           "ms": _time_ms(train, iters=10, warmup=1),
           "serving_ms": _time_ms(serve, iters=10, warmup=1),
           "plain_ms": _time_ms(lambda: KM.moe_ffn_train_plain(
               xg, offs, *w, gate), iters=2, warmup=1),
           "library_ms": (_time_ms(lib, iters=10, warmup=1)
                          if lib is not None else None),
           "library_call": lib_note,
           "bound_ms": bound, "bound_by": by,
           "shape": {"d": d, "ff": ff, "experts": n_exp, "tokens": tokens,
                     "top_k": top_k, "rows": R, "touched_experts": touched,
                     "dtype": "bfloat16"}}
    del xg, w
    torch.cuda.empty_cache()
    if not (same and rel["g"] <= MOE_F32_TOL and rel["u"] <= MOE_F32_TOL
            and rel["y"] <= MOE_BF16_BWD_TOL
            and rel["h"] <= MOE_BF16_BWD_TOL):
        print(json.dumps(row), file=sys.stderr, flush=True)
        raise RuntimeError("moe_ffn_bf16 train: y differs from the serving "
                           "entry's or g, u, h miss plain")
    return row


def run_bf16_train() -> tuple[dict, list[dict]]:
    """Phase ``bf16_train``: olmoe_1b_7b at full width, 2 layers, bf16
    parameters, ``BF16_TRAIN_STEPS`` steps on the card: finite losses
    that fall (the mean of the last 3 below the first 3's), parameters
    still bf16, launches exactly ``moe_ffn``'s and the bf16
    ``moe_ffn_bwd``'s; then the bf16 kernel rows."""
    import gc
    import math
    import statistics
    from dataclasses import replace
    import torch
    from repro_torch import kernels, tree
    from repro_torch.configs.base import registry
    from repro_torch.data import SyntheticLM
    from repro_torch.launch.train import make_train_step, micro_batches
    from repro_torch.models.transformer import init_params
    from repro_torch.optim import adamw
    t0 = time.perf_counter()
    cfg = replace(registry()["olmoe_1b_7b"], n_layers=BF16_TRAIN_LAYERS)
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    params = init_params(cfg, seed=SEED, dtype=torch.bfloat16,
                         device="cuda")
    opt = adamw.init(params)
    src = SyntheticLM(cfg.vocab, TRAIN_SEQ, TRAIN_BATCH, seed=SEED)
    step_fn = make_train_step(cfg, lr_fn=lambda step: BF16_TRAIN_LR)
    before = dict(kernels.launch_counts())
    losses, gnorms, step_ms = [], [], []
    for step in range(BF16_TRAIN_STEPS):
        batch = micro_batches(src.batch(step), TRAIN_MICRO)
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        params, opt, m = step_fn(params, opt, batch)
        losses.append(float(m["loss"]))
        gnorms.append(float(m["grad_norm"]))
        step_ms.append((time.perf_counter() - t1) * 1e3)
    torch.cuda.synchronize()
    launched = _launch_delta(before)
    expected = _train_launches(cfg, BF16_TRAIN_STEPS * TRAIN_MICRO)
    dtypes = sorted({str(p.dtype) for p in tree.leaves(params)})
    line = {"phase": "bf16_train", "arch": cfg.name,
            "layers": cfg.n_layers, "reduced": f"{cfg.n_layers} of 16 "
            "layers", "dtype": "bfloat16", "steps": BF16_TRAIN_STEPS,
            "lr": BF16_TRAIN_LR, "seq": TRAIN_SEQ,
            "global_batch": TRAIN_BATCH, "n_micro": TRAIN_MICRO,
            "losses": losses, "grad_norms": gnorms, "step_ms": step_ms,
            "step_ms_median": statistics.median(step_ms),
            "peak_memory_gb": torch.cuda.max_memory_allocated() / 1e9,
            "param_dtypes": dtypes, "kernel_launches": launched,
            "kernel_launches_expected": expected}
    del params, opt, step_fn
    gc.collect()
    torch.cuda.empty_cache()
    bad = []
    if not all(math.isfinite(x) for x in losses + gnorms):
        bad.append("a loss or grad norm is not finite")
    if not statistics.mean(losses[-3:]) < statistics.mean(losses[:3]):
        bad.append("the loss did not fall")
    if dtypes != ["torch.bfloat16"]:
        bad.append(f"parameters of {dtypes} after the steps")
    if launched != expected:
        bad.append(f"kernel launches {launched}, expected {expected}")
    if bad:
        print(json.dumps(line), file=sys.stderr, flush=True)
        raise RuntimeError(f"bf16_train: {'; '.join(bad)}")
    rows = [_moe_bf16_train_fwd_row(launched["moe_ffn"], SEED + 50)]
    # bf16_train runs olmoe's shape: its count belongs to that row alone
    rows += [_moe_bf16_bwd_row(name, shape,
                               launched["moe_ffn_bwd"] if i == 0 else None,
                               SEED + seed)
             for i, (name, shape, seed) in enumerate(MOE_BF16_BWD_ROWS)]
    line["seconds"] = time.perf_counter() - t0
    return line, rows


def _serve_launches(cfg, new: int) -> tuple[dict, dict]:
    """The kernel launches the dense-cache path predicts: in the prefill
    K8 once per attention layer (a hybrid: per shared site), K9 once per
    Mamba layer, ``moe_ffn`` twice per MoE layer; in each decode step
    ``moe_ffn`` twice per MoE layer and nothing else."""
    sites = sum(1 for l in range(cfg.n_layers)
                if cfg.layout == "hybrid" and cfg.shared_attn_every
                and l % cfg.shared_attn_every == cfg.shared_attn_every - 1)
    pre = {"flash_attention": (cfg.n_layers if cfg.layout == "attn"
                               else sites),
           "ssd_scan": cfg.n_layers if cfg.layout != "attn" else 0,
           "moe_ffn": 2 * cfg.n_layers if cfg.is_moe else 0}
    dec = {"moe_ffn": 2 * cfg.n_layers * new if cfg.is_moe else 0}
    return ({k: v for k, v in pre.items() if v},
            {k: v for k, v in dec.items() if v})


def _serve_run(cfg, params, prompts, mi=None) -> dict:
    """``prefill`` + ``SERVE_NEW`` greedy ``decode_step``s (with a mesh
    when ``mi`` is given): tokens, every step's logits, the launches of
    the prefill and of the decode, wall seconds."""
    import torch
    from repro_torch import kernels
    from repro_torch.models import transformer as T
    from repro_torch.parallel import sharding as sh
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with torch.no_grad():
        before = dict(kernels.launch_counts())
        lg, st = T.prefill(params, cfg, prompts,
                           SERVE_PROMPT + SERVE_NEW, mi=mi)
        torch.cuda.synchronize()
        pre = _launch_delta(before)
        logits, toks = [sh.full(lg).float()], []
        before = dict(kernels.launch_counts())
        for _ in range(SERVE_NEW):
            tok = logits[-1][:, -1, :cfg.vocab].argmax(-1, keepdim=True)
            toks.append(tok)
            lg, st = T.decode_step(params, cfg, st, tok, mi=mi)
            logits.append(sh.full(lg).float())
        torch.cuda.synchronize()
        dec = _launch_delta(before)
    return {"tokens": torch.cat(toks, dim=1), "logits": torch.stack(logits),
            "prefill_launches": pre, "decode_launches": dec,
            "seconds": time.perf_counter() - t0}


def run_sharded_serve() -> dict:
    """Phase ``sharded_serve``: ``prefill`` + ``SERVE_NEW`` greedy decode
    steps with a mesh (``SHARDED_MESH`` over ``SHARDED_BACKEND``:
    DTensor parameters by ``param_specs``, the caches' slots over
    ``model``, K8 and K9 on each rank's heads, MoE on ``moe_apply``'s
    expert-parallel branch) at full width, against the unsharded path on
    the same card and weights: tokens and every step's logits bit for
    bit, and each run's launches those ``_serve_launches`` predicts."""
    from dataclasses import replace
    import numpy as np
    import torch
    import torch.distributed as dist
    from repro_torch.configs.base import registry
    from repro_torch.launch.mesh import make_debug_mesh, make_mesh_info
    from repro_torch.models.transformer import init_params
    from repro_torch.parallel import sharding as sh
    t0 = time.perf_counter()
    dist.init_process_group(SHARDED_BACKEND,
                            init_method=f"tcp://localhost:{_free_port()}",
                            rank=0, world_size=1)
    runs, bad = [], []
    try:
        mi = make_mesh_info(make_debug_mesh(*SHARDED_MESH,
                                            device_type="cuda"))
        for arch, layers in SERVE_RUNS:
            cfg = replace(registry()[arch], n_layers=layers)
            params = init_params(cfg, seed=SEED, dtype=torch.bfloat16,
                                 device="cuda")
            prompts = torch.from_numpy(np.random.RandomState(SEED).randint(
                0, cfg.vocab, (SERVE_BATCH, SERVE_PROMPT)).astype(
                    np.int32)).cuda()
            plain = _serve_run(cfg, params, prompts)
            ps = sh.distribute(params, mi, sh.param_specs(cfg, mi))
            del params
            shard = _serve_run(cfg, ps, prompts, mi)
            del ps
            torch.cuda.empty_cache()
            want = _serve_launches(cfg, SERVE_NEW)
            run = {"arch": arch, "layers": layers,
                   "layers_published": registry()[arch].n_layers,
                   "tokens_identical": bool(torch.equal(plain["tokens"],
                                                        shard["tokens"])),
                   "logits_bits_identical": bool(torch.equal(
                       plain["logits"], shard["logits"])),
                   "logits_max_abs_diff": float(
                       (plain["logits"] - shard["logits"]).abs().max()),
                   "finite": bool(torch.isfinite(shard["logits"]).all()),
                   "prefill_launches": shard["prefill_launches"],
                   "decode_launches": shard["decode_launches"],
                   "launches_expected": {"prefill": want[0],
                                         "decode": want[1]},
                   "unsharded_launches": {
                       "prefill": plain["prefill_launches"],
                       "decode": plain["decode_launches"]},
                   "seconds_sharded": shard["seconds"],
                   "seconds_unsharded": plain["seconds"]}
            runs.append(run)
            ok = (run["tokens_identical"] and run["logits_bits_identical"]
                  and run["finite"]
                  and shard["prefill_launches"] == want[0]
                  and shard["decode_launches"] == want[1]
                  and plain["prefill_launches"] == want[0]
                  and plain["decode_launches"] == want[1])
            if not ok:
                bad.append(arch)
    finally:
        dist.destroy_process_group()
    line = {"phase": "sharded_serve", "card": _card_line(),
            "backend": SHARDED_BACKEND, "mesh": list(SHARDED_MESH),
            "batch": SERVE_BATCH, "prompt": SERVE_PROMPT,
            "new_tokens": SERVE_NEW, "dtype": "bfloat16",
            "reduced": "depth: qwen3 4 of 36, gemma3 6 of 34, olmoe 4 of "
                       "16, zamba2 6 of 81 layers",
            "runs": runs, "seconds": time.perf_counter() - t0}
    if bad:
        print(json.dumps(line), file=sys.stderr, flush=True)
        raise RuntimeError(f"sharded_serve: {bad} differ from the "
                           f"unsharded path or launched other kernels")
    return line


_DRYRUN_CODE = """
import json, sys, tempfile, time
from dataclasses import replace
sys.path.insert(0, "src")
import torch
from repro_torch.configs.base import ShapeConfig, registry
from repro_torch.launch import dryrun as D
from repro_torch.launch.mesh import fake_world, make_debug_mesh, make_mesh_info
cells, sharded = json.loads(sys.argv[1])
out, tmp = [], tempfile.mkdtemp()
for multi_pod in (False, True):
    todo = [c for c in cells if c[2] == multi_pod]
    if not todo:
        continue
    with fake_world(512 if multi_pod else 256):
        for arch, shape, mp, analysis in todo:
            res = D.run_and_save(arch, shape, multi_pod=mp,
                                 analysis=analysis, out_dir=tmp)
            out.append(res)
arch, layers, batch, seq = sharded
cfg = replace(registry()[arch], n_layers=layers)
with fake_world(1):
    mi = make_mesh_info(make_debug_mesh(1, 1, device_type="cpu"))
    res = D.trace_config(cfg, ShapeConfig("sharded_train", seq, batch,
                                          "train"), mi,
                         param_dtype=torch.float32)
print(json.dumps({"cells": out, "sharded_train": res}))
"""


def run_dryrun(sharded: dict) -> dict:
    """Phase ``dryrun``: ``DRYRUN_CELLS`` traced by
    ``repro_torch.launch.dryrun`` on the fake backend in a subprocess (the
    fake group owns its process's default group; nothing touches the
    card), every cell ``ok``, with its per-rank memory, operations and
    collective bytes; and the dry run of ``sharded_train``'s olmoe step
    (float32, 2 layers, its batch) on a (1, 1) fake mesh, whose predicted
    peak (the step's arguments plus the live bytes' peak) must lie within
    ``DRYRUN_PEAK_GATE`` of the card's (``step_peak_over_arguments_gb``
    of that step in phase 38)."""
    t0 = time.perf_counter()
    run = next(r for r in sharded["runs"] if r["arch"] == "olmoe_1b_7b")
    args = json.dumps([DRYRUN_CELLS, ["olmoe_1b_7b", run["layers"],
                                      SHARDED_BATCH, SHARDED_SEQ]])
    proc = subprocess.run([sys.executable, "-c", _DRYRUN_CODE, args],
                          cwd=Path(__file__).resolve().parent,
                          capture_output=True, text=True, timeout=900)
    if proc.returncode != 0:
        raise RuntimeError(f"dryrun: the subprocess failed:\n"
                           f"{proc.stderr[-3000:]}")
    res = json.loads(proc.stdout.strip().splitlines()[-1])
    cells = []
    for c in res["cells"]:
        cell = {k: c.get(k) for k in ("arch", "shape", "mesh", "kind",
                                      "analysis", "analysis_scale",
                                      "status", "trace_s", "error")}
        if c["status"] != "ok":
            cell["traceback"] = c.get("traceback", "")[-1500:]
        else:
            cell.update({"memory": c["memory"],
                         "flops": c["cost"]["flops"],
                         "kernel_flops": c["cost"]["kernel_flops"],
                         "collective_bytes": c["collectives"]["bytes"],
                         "collective_counts": c["collectives"]["counts"]})
        cells.append(cell)
    pred = res["sharded_train"]["memory"]["peak_size_in_bytes"] / 1e9
    meas = run["step_peak_over_arguments_gb"]
    line = {"phase": "dryrun", "cells": cells,
            "memory_cross_check": {
                "case": "sharded_train olmoe_1b_7b, float32, "
                        f"{run['layers']} layers, batch {SHARDED_BATCH} x "
                        f"{SHARDED_SEQ} in {SHARDED_MICRO} microbatches, "
                        "(1, 1) mesh",
                "predicted_peak_gb": pred,
                "predicted_argument_gb": res["sharded_train"]["memory"][
                    "argument_size_in_bytes"] / 1e9,
                "predicted_temp_gb": res["sharded_train"]["memory"][
                    "temp_size_in_bytes"] / 1e9,
                "measured_step_peak_gb": meas,
                "measured_argument_gb": run["argument_gb"],
                "measured_max_memory_allocated_gb": run["peak_gb"],
                "rel_diff": abs(pred - meas) / meas,
                "gate": DRYRUN_PEAK_GATE},
            "seconds": time.perf_counter() - t0}
    errors = [c for c in cells if c["status"] != "ok"]
    if errors or line["memory_cross_check"]["rel_diff"] > DRYRUN_PEAK_GATE:
        print(json.dumps(line), file=sys.stderr, flush=True)
        raise RuntimeError(f"dryrun: {len(errors)} cells failed, or the "
                           f"predicted peak {pred:.3f} GB is more than "
                           f"{DRYRUN_PEAK_GATE:.0%} from the card's "
                           f"{meas:.3f} GB")
    return line


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    src = Path(__file__).resolve().parent / "src"
    if not (src / "repro_torch" / "kernels" / "csrc").is_dir():
        print(f"chip_smoke: the port's sources are not under {src}",
              file=sys.stderr)
        return 1
    sys.path.insert(0, str(src))
    from repro_torch.configs.base import registry
    from repro_torch.kernels import _build
    from repro_torch.models.transformer import init_params

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    lines = [_card_line()]

    t0 = time.perf_counter()
    _build.library()
    lines.append({"phase": "build", "seconds": time.perf_counter() - t0,
                  "nvcc_seconds": _build.build_info.get("seconds")})
    print(_build.build_info.get("ptxas", ""), file=sys.stderr, flush=True)
    # training first, while the card is empty: float32 AdamW state for
    # 24 full-width qwen3_4b layers takes ~65 GB at its peak
    train_lines = run_training()
    train_rows = bench_moe_bwd_kernels(train_lines)
    bf16_line, bf16_rows = run_bf16_train()
    print(json.dumps(bf16_line), file=sys.stderr, flush=True)
    sharded = run_sharded_train()
    print(json.dumps(sharded), file=sys.stderr, flush=True)
    shards, shard_rows = run_moe_shards()
    print(json.dumps(shards), file=sys.stderr, flush=True)
    serve_line = run_sharded_serve()
    print(json.dumps(serve_line), file=sys.stderr, flush=True)
    dry_line = run_dryrun(sharded)
    print(json.dumps(dry_line), file=sys.stderr, flush=True)

    cfg = registry()["qwen3_4b"]
    t0 = time.perf_counter()
    params = init_params(cfg, seed=SEED, dtype=torch.bfloat16,
                         device="cuda")
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    print(f"init_params: {init_s:.1f} s", file=sys.stderr, flush=True)

    engine_line, launches, eng, tokens = run_engine(cfg, params)
    engine_line["init_params_s"] = init_s
    print(json.dumps(engine_line), file=sys.stderr, flush=True)
    pinned_line, pinned_launches, peng = run_engine_pinned(cfg, params,
                                                           tokens)
    print(json.dumps(pinned_line), file=sys.stderr, flush=True)
    parity, _ = run_fused_vs_reference(cfg, params)
    print(json.dumps(parity), file=sys.stderr, flush=True)
    pparity, tail_tokens = run_fused_vs_reference(cfg, params, pinned=True)
    print(json.dumps(pparity), file=sys.stderr, flush=True)
    tail, tail_launches = run_pinned_tail_faults(cfg, params, tail_tokens)
    print(json.dumps(tail), file=sys.stderr, flush=True)
    overlap = run_overlap(cfg, params, tokens, engine_line)
    print(json.dumps(overlap), file=sys.stderr, flush=True)
    overlap_faults = run_overlap_plan_faults(cfg, params, tokens)
    print(json.dumps(overlap_faults), file=sys.stderr, flush=True)
    qos_overload = run_qos_overload(cfg, params)
    print(json.dumps(qos_overload), file=sys.stderr, flush=True)
    qos_power = run_qos_power(cfg, params)
    print(json.dumps(qos_power), file=sys.stderr, flush=True)
    serve_cli = run_serve_cli()
    print(json.dumps(serve_cli), file=sys.stderr, flush=True)
    padding = run_batch_padding(cfg, params)
    print(json.dumps(padding), file=sys.stderr, flush=True)
    invariance = run_batch_invariance(cfg, params)
    print(json.dumps(invariance), file=sys.stderr, flush=True)
    window = run_profiled_window(cfg, params)
    print(json.dumps(window), file=sys.stderr, flush=True)
    pwindow_parent = run_profiled_window(cfg, params, parent=True)
    window["parent_ops"] = {k: pwindow_parent[k] for k in (
        "inner_steps", "device_events", "device_ops_per_inner_step",
        "qk_norm_rope_ops", "device_busy_share", "wall_s")}
    window["parent_ops_note"] = (
        "the same window with qkv_rope_append replaced by the parent "
        "tree's eager qk-norm, RoPE, q scale and index_put_ append")
    print(json.dumps(window), file=sys.stderr, flush=True)
    pwindow = run_profiled_window(cfg, params, pinned=True)
    print(json.dumps(pwindow), file=sys.stderr, flush=True)
    pinned_line["device_busy_share"] = pwindow["device_busy_share"]
    cross = run_card_vs_cpu()
    print(json.dumps(cross), file=sys.stderr, flush=True)
    pre, pre_launches, pre_tokens = run_prefill(cfg, params, tokens)
    print(json.dumps(pre), file=sys.stderr, flush=True)
    ppre, _ = run_prefill_pinned(cfg, params, pre_tokens)
    print(json.dumps(ppre), file=sys.stderr, flush=True)
    i8h, i8h_launches, i8p, i8p_launches, ieng = run_int8(cfg, params,
                                                          pre_tokens)
    print(json.dumps(i8h), file=sys.stderr, flush=True)
    print(json.dumps(i8p), file=sys.stderr, flush=True)
    link = host_link_rate(peng.kv.store.pools[peng.pinned_tier].data)
    kernel_rows = (bench_kernels(cfg, eng, launches)
                   + bench_pinned_kernels(cfg, peng, pinned_launches,
                                          launches, tail_launches, link)
                   + bench_int8_prefill_kernels(cfg, eng, ieng, pre,
                                                i8h_launches, i8p_launches,
                                                link)
                   + bench_prefill_dual(cfg, peng,
                                        ppre["hbm8_run"]["prefill_launches"],
                                        link))
    pinv = run_prefill_invariance(cfg, eng, peng)
    print(json.dumps(pinv), file=sys.stderr, flush=True)


    zline, zlaunch, zparams, zcfg = run_longctx("zamba2_7b")
    print(json.dumps(zline), file=sys.stderr, flush=True)
    mline, mlaunch, mparams, mcfg = run_longctx("mamba2_1_3b")
    print(json.dumps(mline), file=sys.stderr, flush=True)
    probe_f32, probe_bf16 = run_longctx_probes([(zcfg, zparams),
                                                (mcfg, mparams)])
    del zparams, mparams
    torch.cuda.empty_cache()
    print(json.dumps(probe_f32), file=sys.stderr, flush=True)
    print(json.dumps(probe_bf16), file=sys.stderr, flush=True)
    lcross = run_longctx_card_vs_cpu()
    print(json.dumps(lcross), file=sys.stderr, flush=True)
    f32_lines, f32_launches = [], {}
    for name in ("mamba2_1_3b", "zamba2_7b"):
        line, f32_launches[name], f32_params, _ = run_longctx(
            name, torch.float32)
        del f32_params
        torch.cuda.empty_cache()
        print(json.dumps(line), file=sys.stderr, flush=True)
        f32_lines.append(line)
    longctx_rows, ssd_passes = bench_longctx_kernels(
        zlaunch, mlaunch, probe_f32["runs"][0]["launches"], f32_launches)
    kernel_rows += longctx_rows
    s13 = run_slice13()
    kernel_rows += s13["rows"]
    invariance["olmoe"] = s13["batch_invariance_olmoe"]
    pinv["moe_ffn"] = s13["prefill_invariance_moe_ffn"]
    lcross["runs"] += s13["card_vs_cpu_mixtral"]
    s15 = run_slice15()
    kernel_rows += s15["rows"]
    lcross["runs"] += s15["card_vs_cpu"]
    kernel_rows += train_rows + shard_rows + bf16_rows

    lines += [{"kernels": kernel_rows}, {"host_link": link}, engine_line,
              pinned_line, parity, pparity, tail, overlap, overlap_faults,
              _qos_summary(qos_overload, qos_power), serve_cli,
              padding, invariance,
              pinv, window, pwindow, cross, pre, ppre, i8h, i8p, zline, mline,
              probe_f32, probe_bf16, lcross, *f32_lines, ssd_passes,
              s13["moe_engine"], s13["longctx_mixtral"], *s13["probes"],
              s13["dense_archs"], *s15["lines"], *train_lines, shards,
              sharded, bf16_line, serve_line, dry_line, _card_line()]
    for line in lines:
        _emit(line)
    _emit({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
